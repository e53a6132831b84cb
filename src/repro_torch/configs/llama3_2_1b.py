"""llama3.2-1b [dense] — hf:meta-llama/Llama-3.2-1B.
16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256."""
from repro_torch.configs.common import FULL_DTYPE, REDUCED_DTYPE
from repro_torch.models.transformer import ModelConfig


def full(dtype=FULL_DTYPE, **kw):
    return ModelConfig(
        arch_id="llama3.2-1b", family="dense", n_layers=16, d_model=2048,
        n_heads=32, n_kv_heads=8, head_dim=64, d_ff=8192, vocab=128256,
        rope_theta=500000.0, dtype=dtype, **kw)


def reduced(dtype=REDUCED_DTYPE, **kw):
    return ModelConfig(
        arch_id="llama3.2-1b-reduced", family="dense", n_layers=2,
        d_model=256, n_heads=8, n_kv_heads=2, head_dim=32, d_ff=512,
        vocab=512, rope_theta=500000.0, dtype=dtype, **kw)
