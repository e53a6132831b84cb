"""deepseek-v2-236b [moe] — arXiv:2405.04434.
60L d_model=5120 128H, MLA kv_lora=512, MoE: 2 shared + 160 routed top-6,
expert d_ff=1536, first layer dense FFN, vocab=102400."""
from repro_torch.configs.common import FULL_DTYPE, REDUCED_DTYPE
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig


def full(dtype=FULL_DTYPE, **kw):
    return ModelConfig(
        arch_id="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
        n_heads=128, n_kv_heads=128, head_dim=128, d_ff=1536, vocab=102400,
        rope_theta=10000.0,
        moe=MoEConfig(d_model=5120, d_ff_expert=1536, n_experts=160, top_k=6,
                      n_shared=2, d_ff_shared=3072, router_norm_topk=False),
        moe_first_dense=1, moe_dense_ff=12288, dtype=dtype, **kw)


def reduced(dtype=REDUCED_DTYPE, **kw):
    return ModelConfig(
        arch_id="deepseek-v2-236b-reduced", family="moe", n_layers=2,
        d_model=256, n_heads=4, n_kv_heads=4, head_dim=64, d_ff=256,
        vocab=512,
        moe=MoEConfig(d_model=256, d_ff_expert=256, n_experts=4, top_k=2,
                      n_shared=1, d_ff_shared=256, router_norm_topk=False),
        moe_first_dense=1, moe_dense_ff=512, dtype=dtype, **kw)
