"""Parameter conversion between ``repro``'s CNN trees and the port's.

The reference keeps conv weights HWIO ``(k, k, c_in/g, c_out)``; the
port keeps them OIHW ``(c_out, c_in/g, k, k)``. Dense ``(d_in, d_out)``
and grouped dense ``(G, d_in/G, d_out/G)`` weights, biases and norm
affines keep their shapes. Conv weights are the trees' only 4-D leaves.

The reference's trees come in as numpy arrays (callers turn jax arrays
into numpy first), so a run of the port can start from exactly the
reference's initial parameters (``run_federated(init_params=...)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.module import tree_map


def to_port(tree, *, device=None, dtype=torch.float32):
    """Reference (numpy, HWIO convs) -> port (torch, OIHW convs)."""
    def one(a):
        a = np.asarray(a)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device)
    return tree_map(one, tree)


def to_reference(tree):
    """Port (torch, OIHW convs) -> reference layout (numpy, HWIO
    convs)."""
    def one(t):
        a = t.detach().cpu().numpy()
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0)
                                    if a.ndim == 4 else a)
    return tree_map(one, tree)
