"""stablelm-12b [dense] — hf:stabilityai/stablelm-2-12b.
40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352,
partial rotary (25%) + per-head QK norm per the model card."""
from repro_torch.configs.common import FULL_DTYPE, REDUCED_DTYPE
from repro_torch.models.transformer import ModelConfig


def full(dtype=FULL_DTYPE, **kw):
    return ModelConfig(
        arch_id="stablelm-12b", family="dense", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, head_dim=160, d_ff=13824, vocab=100352,
        rope_theta=10000.0, rotary_pct=0.25, qk_norm=True, dtype=dtype, **kw)


def reduced(dtype=REDUCED_DTYPE, **kw):
    return ModelConfig(
        arch_id="stablelm-12b-reduced", family="dense", n_layers=2,
        d_model=256, n_heads=8, n_kv_heads=2, head_dim=32, d_ff=512,
        vocab=512, rotary_pct=0.25, qk_norm=True, dtype=dtype, **kw)
