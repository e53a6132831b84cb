"""mixtral-8x22b [moe] — arXiv:2401.04088.
56L d_model=6144 48H (GQA kv=8) d_ff=16384, MoE 8 experts top-2, SWA,
vocab=32768."""
from repro_torch.configs.common import FULL_DTYPE, REDUCED_DTYPE
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig


def full(dtype=FULL_DTYPE, **kw):
    return ModelConfig(
        arch_id="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
        n_heads=48, n_kv_heads=8, head_dim=128, d_ff=16384, vocab=32768,
        rope_theta=1e6, window=4096,
        moe=MoEConfig(d_model=6144, d_ff_expert=16384, n_experts=8, top_k=2),
        dtype=dtype, **kw)


def reduced(dtype=REDUCED_DTYPE, **kw):
    return ModelConfig(
        arch_id="mixtral-8x22b-reduced", family="moe", n_layers=2,
        d_model=256, n_heads=8, n_kv_heads=2, head_dim=32, d_ff=512,
        vocab=512, window=64,
        moe=MoEConfig(d_model=256, d_ff_expert=512, n_experts=4, top_k=2),
        dtype=dtype, **kw)
