"""Parameter conversion between ``repro``'s trees and the port's.

CNNs (``to_port``, ``to_reference``):

The reference keeps conv weights HWIO ``(k, k, c_in/g, c_out)``; the
port keeps them OIHW ``(c_out, c_in/g, k, k)``. Dense ``(d_in, d_out)``
and grouped dense ``(G, d_in/G, d_out/G)`` weights, biases and norm
affines keep their shapes. Conv weights are the trees' only 4-D leaves.

The reference's trees come in as numpy arrays (callers turn jax arrays
into numpy first), so a run of the port can start from exactly the
reference's initial parameters (``run_federated(init_params=...)``).

Stacked trees (``stacked_to_reference``, ``stacked_to_port``): client
rows stacked on a leading axis, whose conv leaves are 5-D ``(P, k, k,
c_in/g, c_out)`` in the reference and ``(P, c_out, c_in/g, k, k)`` in
the port.

Flat state (``flat_to_reference``, ``flat_from_reference``): the port
keeps the global params, the method's server state and the client rows
as flat vectors of a ``FlatLayout`` (``(M,)``, or ``(P, M)`` rows); the
reference keeps each as a params tree. These two map a port state tree
onto the reference's and back, leaf for leaf, so a checkpoint holds the
reference's arrays under the reference's keys
(``repro_torch.checkpoint.io``).

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


def _conv_perm(lead: int, to_reference: bool) -> tuple:
    """The transpose of a conv leaf behind ``lead`` stacked axes: OIHW ->
    HWIO, or back."""
    o, i, h, w = range(lead, lead + 4)
    tail = (h, w, i, o) if to_reference else (lead + 3, lead + 2, lead,
                                              lead + 1)
    return tuple(range(lead)) + tail


def _host(x) -> np.ndarray:
    """A leaf as a numpy array (torch tensors copied off the device;
    CPU tensors viewed)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def stacked_to_reference(tree):
    """Port client rows (torch or numpy, leaves (P, ...), convs
    (P, O, I, H, W)) -> the reference's stacked layout (numpy, convs
    (P, H, W, I, O)). Leaves come back as views where no copy off the
    device is needed."""
    perm = _conv_perm(1, True)

    def one(t):
        a = _host(t)
        return a.transpose(perm) if a.ndim == 5 else a
    return tree_map(one, tree)


def stacked_to_port(tree, *, device=None, dtype=torch.float32):
    """Reference stacked rows (numpy, convs (P, H, W, I, O)) -> the
    port's (torch, convs (P, O, I, H, W))."""
    perm = _conv_perm(1, False)

    def one(a):
        a = np.asarray(a)
        if a.ndim == 5:
            a = a.transpose(perm)
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device)
    return tree_map(one, tree)


def _is_flat(x, layout) -> bool:
    """A leaf whose last axis is the layout's M: a flat params vector,
    or stacked rows of them."""
    return (layout is not None and np.ndim(x) >= 1
            and np.shape(x)[-1] == layout.size)


def flat_to_reference(tree, layout):
    """A port state tree -> the reference's layout, as numpy. A flat
    leaf (``(M,)`` or ``(P, M)`` over ``layout``) becomes the params tree
    it flattens, in the reference's layout (``to_reference``, or
    ``stacked_to_reference`` for rows); any other leaf (fedadam's step
    count) passes as numpy. ``layout`` None: every leaf as numpy."""
    def one(x):
        if not _is_flat(x, layout):
            return _host(x)
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.asarray(x))
        params = layout.unflatten(t)
        return (to_reference(params) if t.dim() == 1
                else stacked_to_reference(params))
    return tree_map(one, tree)


def flat_from_reference(ref, like, layout):
    """``flat_to_reference`` inverted, into the structure of ``like`` (a
    port state tree): each flat leaf of ``like`` is rebuilt from its
    params subtree in ``ref``; other leaves from their arrays. Leaves
    come back as ``like``'s are: torch tensors on its device and of its
    dtype (flat ones in a buffer of the layout's row stride), or
    numpy."""
    def one(x, r):
        as_torch = isinstance(x, torch.Tensor)
        if not _is_flat(x, layout):
            a = np.asarray(r, dtype=_host(x).dtype)
            return torch.as_tensor(a).to(x.device) if as_torch else a
        lead = tuple(np.shape(x)[:-1])
        dtype = (x.dtype if as_torch
                 else torch.from_numpy(np.zeros(0, np.asarray(x).dtype)).dtype)
        params = (to_port(r, dtype=dtype) if not lead
                  else stacked_to_port(r, dtype=dtype))
        if as_torch:
            return layout.flatten(params, out=layout.alloc(
                lead, device=x.device, dtype=dtype))
        out = torch.empty(lead + (layout.size,), dtype=dtype)
        return layout.flatten(params, out=out).numpy()
    return tree_map(one, like, ref)


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
