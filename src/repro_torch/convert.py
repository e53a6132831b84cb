"""Parameter conversion between ``repro``'s trees and the port's.

CNNs (``to_port``, ``to_reference``):

The reference keeps conv weights HWIO ``(k, k, c_in/g, c_out)``; the
port keeps them OIHW ``(c_out, c_in/g, k, k)``. Dense ``(d_in, d_out)``
and grouped dense ``(G, d_in/G, d_out/G)`` weights, biases and norm
affines keep their shapes. Conv weights are the trees' only 4-D leaves.

The reference's trees come in as numpy arrays (callers turn jax arrays
into numpy first), so a run of the port can start from exactly the
reference's initial parameters (``run_federated(init_params=...)``).

LMs (``lm_to_port``, ``lm_to_reference``): every leaf keeps its layout
and its own dtype. An LM tree mixes dtypes (a full-width Mamba-2 keeps
its weights in bf16 but ``a_log``, ``dt_bias`` and ``d_skip`` in fp32),
and its stacked depthwise conv weight ``(L, k, 1, C)`` is 4-D without
being a 2-D conv, so the CNN converters, which cast every leaf to one
dtype and transpose every 4-D leaf, do not apply. bf16 leaves cross as
numpy's ``bfloat16`` (``ml_dtypes``, as jax hands them over).
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


def _np_to_torch(a, device):
    a = np.array(a)                     # a writable copy, C order
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16, 2 bytes
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def lm_to_port(tree, *, device=None):
    """Reference LM tree (numpy) -> port (torch): same layout, same
    dtype per leaf."""
    return tree_map(lambda a: _np_to_torch(a, device), tree)


def lm_to_reference(tree):
    """Port LM tree (torch) -> numpy, same layout, same dtype per leaf
    (bf16 as ``ml_dtypes.bfloat16``)."""
    def one(t):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return tree_map(one, tree)
