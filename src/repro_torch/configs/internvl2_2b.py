"""internvl2-2b [vlm] — arXiv:2404.16821.
InternLM2 tower: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
InternViT + projector is a STUB: the model takes (B, 256, 2048)
precomputed patch embeddings prepended to the token stream."""
from repro_torch.configs.common import FULL_DTYPE, REDUCED_DTYPE
from repro_torch.models.transformer import ModelConfig


def full(dtype=FULL_DTYPE, **kw):
    return ModelConfig(
        arch_id="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
        n_heads=16, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=92553,
        rope_theta=1e6, n_patches=256, dtype=dtype, **kw)


def reduced(dtype=REDUCED_DTYPE, **kw):
    return ModelConfig(
        arch_id="internvl2-2b-reduced", family="vlm", n_layers=2,
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
        vocab=512, rope_theta=1e6, n_patches=16, dtype=dtype, **kw)
