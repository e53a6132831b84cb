"""Model configurations: the paper's CNNs (VGG9, VGG16, MobileNetV1) and
the reference's ten LMs, of six families: dense (Llama-3.2-1B,
Qwen2-7B, H2O-Danube-1.8B, StableLM-2-12B), moe (Mixtral-8x22B,
DeepSeek-V2-236B), ssm (Mamba-2 1.3B), hybrid (Zamba2-2.7B), encdec
(Whisper-base) and vlm (InternVL2-2B)."""
from __future__ import annotations

import importlib

# the reference's registry, in its order
ASSIGNED_ARCHS = (
    "whisper-base", "zamba2-2.7b", "qwen2-7b", "deepseek-v2-236b",
    "mixtral-8x22b", "h2o-danube-1.8b", "llama3.2-1b", "internvl2-2b",
    "stablelm-12b", "mamba2-1.3b",
)
PAPER_ARCHS = ("vgg9", "vgg16", "mobilenet")
ARCHS = ("vgg9", "vgg16", "mobilenet", "llama3.2-1b", "qwen2-7b",
         "h2o-danube-1.8b", "stablelm-12b", "mixtral-8x22b",
         "deepseek-v2-236b", "mamba2-1.3b", "zamba2-2.7b", "whisper-base",
         "internvl2-2b")


def get_config(arch_id: str, *, reduced: bool = False, **overrides):
    """``full(**overrides)`` of the arch's module, or ``reduced(...)``."""
    if arch_id not in ARCHS:
        raise ValueError(f"unknown arch {arch_id!r}; the port has "
                         f"{', '.join(ARCHS)}")
    name = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.reduced(**overrides) if reduced else mod.full(**overrides)
