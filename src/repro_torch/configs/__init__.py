"""Model configurations: the paper's CNNs (VGG9, VGG16, MobileNetV1) and
the LM families the port has (Mamba-2 1.3B)."""
from __future__ import annotations

import importlib

ARCHS = ("vgg9", "vgg16", "mobilenet", "mamba2-1.3b")


def get_config(arch_id: str, *, reduced: bool = False, **overrides):
    """``full(**overrides)`` of the arch's module, or ``reduced(...)``."""
    if arch_id not in ARCHS:
        raise ValueError(f"unknown arch {arch_id!r}; the port has "
                         f"{', '.join(ARCHS)}")
    name = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.reduced(**overrides) if reduced else mod.full(**overrides)
