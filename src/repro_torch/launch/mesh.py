"""Device meshes as plain descriptions, and the card's own rates.

The reference's ``repro.launch.mesh`` builds ``jax`` meshes over TPU
chips. The port has no mesh of devices yet (more than one GPU,
``torch.distributed``, is a later slice); its dry-run needs only what a
mesh says: its axes, their sizes, and so the chips. A ``Mesh`` holds
exactly that, so the sharding rules (``launch/sharding.py``) run on the
reference's production shapes with no device at all.
"""
from __future__ import annotations

import dataclasses
import math

# one NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, as
# ``nvidia-smi --query-gpu=name,power.limit`` prints it: "NVIDIA H100
# 80GB HBM3, 700.00 W". Dense peaks, no sparsity.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, tensor cores
PEAK_FLOPS_FP32 = 67e12         # FLOP/s
HBM_BW = 3.35e12                # B/s, HBM3


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names, in order, and their sizes (``shape[name]``)."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh() -> Mesh:
    """One device: the (1, 1) mesh of a single card."""
    return Mesh(("data", "model"), (1, 1))


def batch_axes(mesh: Mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def mesh_chips(mesh: Mesh) -> int:
    return mesh.size
