"""whisper-base [audio] — arXiv:2212.04356.
Enc-dec, 6L each, d_model=512 8H d_ff=2048 vocab=51865. Conv/mel frontend is
a STUB: the encoder takes (B, 1500, 512) precomputed frame embeddings."""
from repro_torch.configs.common import FULL_DTYPE, REDUCED_DTYPE
from repro_torch.models.transformer import ModelConfig


def full(dtype=FULL_DTYPE, **kw):
    return ModelConfig(
        arch_id="whisper-base", family="encdec", n_layers=6, d_model=512,
        n_heads=8, n_kv_heads=8, head_dim=64, d_ff=2048, vocab=51865,
        norm="layernorm", act="gelu", use_rope=False, enc_layers=6,
        enc_frames=1500, tie_embeddings=True, dec_pos_size=32768,
        dtype=dtype, **kw)


def reduced(dtype=REDUCED_DTYPE, **kw):
    return ModelConfig(
        arch_id="whisper-base-reduced", family="encdec", n_layers=2,
        d_model=256, n_heads=4, n_kv_heads=4, head_dim=64, d_ff=512,
        vocab=512, norm="layernorm", act="gelu", use_rope=False,
        enc_layers=2, enc_frames=64, tie_embeddings=True, dec_pos_size=512,
        dtype=dtype, **kw)
