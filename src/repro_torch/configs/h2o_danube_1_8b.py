"""h2o-danube-1.8b [dense] — arXiv:2401.16818.
24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, sliding-window attn."""
from repro_torch.configs.common import FULL_DTYPE, REDUCED_DTYPE
from repro_torch.models.transformer import ModelConfig


def full(dtype=FULL_DTYPE, **kw):
    return ModelConfig(
        arch_id="h2o-danube-1.8b", family="dense", n_layers=24, d_model=2560,
        n_heads=32, n_kv_heads=8, head_dim=80, d_ff=6912, vocab=32000,
        rope_theta=10000.0, window=4096, dtype=dtype, **kw)


def reduced(dtype=REDUCED_DTYPE, **kw):
    return ModelConfig(
        arch_id="h2o-danube-1.8b-reduced", family="dense", n_layers=2,
        d_model=256, n_heads=8, n_kv_heads=2, head_dim=32, d_ff=512,
        vocab=512, window=64, dtype=dtype, **kw)
