"""mamba2-1.3b [ssm] — arXiv:2405.21060 (SSD, state-space duality).
48L d_model=2048 (attn-free), ssm_state=128, vocab=50280."""
from repro_torch.configs.common import FULL_DTYPE, REDUCED_DTYPE
from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import ModelConfig


def full(dtype=FULL_DTYPE, **kw):
    return ModelConfig(
        arch_id="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048,
        vocab=50280, d_ff=0,
        ssm=SSMConfig(d_model=2048, d_state=128, headdim=64, expand=2),
        dtype=dtype, **kw)


def reduced(dtype=REDUCED_DTYPE, **kw):
    return ModelConfig(
        arch_id="mamba2-1.3b-reduced", family="ssm", n_layers=2, d_model=256,
        vocab=512, d_ff=0,
        ssm=SSMConfig(d_model=256, d_state=32, headdim=32, expand=2,
                      chunk=64),
        dtype=dtype, **kw)
