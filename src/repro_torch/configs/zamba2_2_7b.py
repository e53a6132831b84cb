"""zamba2-2.7b [hybrid] — arXiv:2411.15242.
54L Mamba2 (d_model=2560, ssm_state=64) + shared attention block
(32H GQA kv=32, d_ff=10240) applied every 6 layers, vocab=32000."""
from repro_torch.configs.common import FULL_DTYPE, REDUCED_DTYPE
from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import ModelConfig


def full(dtype=FULL_DTYPE, **kw):
    return ModelConfig(
        arch_id="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv_heads=32, head_dim=80, d_ff=10240, vocab=32000,
        ssm=SSMConfig(d_model=2560, d_state=64, headdim=64, expand=2),
        hybrid_attn_every=6, dtype=dtype, **kw)


def reduced(dtype=REDUCED_DTYPE, **kw):
    return ModelConfig(
        arch_id="zamba2-2.7b-reduced", family="hybrid", n_layers=2,
        d_model=256, n_heads=4, n_kv_heads=4, head_dim=64, d_ff=512,
        vocab=512,
        ssm=SSMConfig(d_model=256, d_state=32, headdim=32, expand=2,
                      chunk=64),
        hybrid_attn_every=2, dtype=dtype, **kw)
