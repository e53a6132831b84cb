"""qwen2-7b [dense] — arXiv:2407.10671.
28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, QKV bias."""
from repro_torch.configs.common import FULL_DTYPE, REDUCED_DTYPE
from repro_torch.models.transformer import ModelConfig


def full(dtype=FULL_DTYPE, **kw):
    return ModelConfig(
        arch_id="qwen2-7b", family="dense", n_layers=28, d_model=3584,
        n_heads=28, n_kv_heads=4, head_dim=128, d_ff=18944, vocab=152064,
        rope_theta=1e6, qkv_bias=True, dtype=dtype, **kw)


def reduced(dtype=REDUCED_DTYPE, **kw):
    return ModelConfig(
        arch_id="qwen2-7b-reduced", family="dense", n_layers=2, d_model=256,
        n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512, vocab=512,
        rope_theta=1e6, qkv_bias=True, dtype=dtype, **kw)
