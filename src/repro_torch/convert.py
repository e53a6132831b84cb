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
as flat values of a ``FlatLayout`` (``(M,)``, or ``(P, M)`` rows; one
such tensor per dtype, ``Segments``, for a tree that mixes dtypes); the
reference keeps each as a params tree. These two map a port state tree
onto the reference's and back, leaf for leaf, so a checkpoint holds the
reference's arrays under the reference's keys
(``repro_torch.checkpoint.io``). A bf16 leaf is written as its exact
fp32 value (numpy has no bfloat16 of its own) and read back into bf16
exactly.

LMs (``lm_to_port``, ``lm_to_reference``; ``lm_rank_to_port``: a rank's
shares of the sharded programs, in one call): every leaf keeps its layout
and its own dtype. An LM tree mixes dtypes (a full-width Mamba-2 keeps
its weights in bf16 but ``a_log``, ``dt_bias`` and ``d_skip`` in fp32),
and its stacked depthwise conv weight ``(L, k, 1, C)`` is 4-D without
being a 2-D conv, so the CNN converters, which cast every leaf to one
dtype and transpose every 4-D leaf, do not apply. bf16 leaves cross as
numpy's ``bfloat16`` (``ml_dtypes``, as jax hands them over).

Expert shards (``expert_shard``): the experts one rank of an
expert-parallel MoE owns, sliced from the replicated weights as the
reference's ``moe_ep._local_moe`` slices them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.module import Segments, flat_parts, host, tree_map


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


def stacked_to_reference(tree):
    """Port client rows (torch or numpy, leaves (P, ...), convs
    (P, O, I, H, W)) -> the reference's stacked layout (numpy, convs
    (P, H, W, I, O)). Leaves come back as views where no copy off the
    device is needed."""
    perm = _conv_perm(1, True)

    def one(t):
        a = host(t)
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


def _exact_fp32(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.dtype == torch.bfloat16 else t


def _cnn(layout) -> bool:
    """Whether ``layout`` is a CNN's (its convs under ``convs``, OIHW).
    An LM's tree keeps the reference's layout leaf for leaf: its 4-D
    depthwise conv weight ``(L, k, 1, C)`` is no OIHW conv."""
    return any(s.path[:1] == ("convs",) for s in layout.slots)


def _params_to_reference(params, layout, rows: bool):
    if not _cnn(layout):
        return tree_map(host, params)
    return stacked_to_reference(params) if rows else to_reference(params)


def _params_to_port(r, layout, rows: bool, dtype=torch.float32):
    if not _cnn(layout):
        return tree_map(lambda a: torch.tensor(np.asarray(a), dtype=dtype),
                        r)
    return (stacked_to_port if rows else to_port)(r, dtype=dtype)


def flat_to_reference(tree, layout):
    """A port state tree -> the reference's layout, as numpy. A flat
    value (``(M,)`` or ``(P, M)`` over ``layout``, or ``Segments`` of
    them) becomes the params tree it flattens, in the reference's layout
    (a CNN's through ``to_reference``, or ``stacked_to_reference`` for
    rows; an LM's as it is), bf16 leaves as their exact fp32 values; any
    other leaf (fedadam's step count) passes as numpy. ``layout`` None:
    every leaf as numpy."""
    def one(x):
        if not isinstance(x, Segments) and not _is_flat(x, layout):
            return host(x)
        parts = [torch.as_tensor(p) for p in flat_parts(x)]
        params = tree_map(_exact_fp32, layout.unflatten(layout.join(parts)))
        return _params_to_reference(params, layout, parts[0].dim() > 1)
    return tree_map(one, tree, is_leaf=lambda n: isinstance(n, Segments))


def flat_from_reference(ref, like, layout):
    """``flat_to_reference`` inverted, into the structure of ``like`` (a
    port state tree): each flat leaf of ``like`` is rebuilt from its
    params subtree in ``ref``; other leaves from their arrays. Leaves
    come back as ``like``'s are: torch tensors on its device and of its
    dtype (flat ones in a buffer of the layout's row stride), or
    numpy."""
    def one(x, r):
        if isinstance(x, Segments):
            return _segments_from_reference(r, x, layout)
        as_torch = isinstance(x, torch.Tensor)
        if not _is_flat(x, layout):
            a = np.asarray(r, dtype=host(x).dtype)
            return torch.as_tensor(a).to(x.device) if as_torch else a
        lead = tuple(np.shape(x)[:-1])
        dtype = (x.dtype if as_torch
                 else torch.from_numpy(np.zeros(0, np.asarray(x).dtype)).dtype)
        params = _params_to_port(r, layout, bool(lead), dtype)
        if as_torch:
            return layout.flatten(params, out=layout.alloc(
                lead, device=x.device, dtype=dtype))
        out = torch.empty(lead + (layout.size,), dtype=dtype)
        return layout.flatten(params, out=out).numpy()
    return tree_map(one, like, ref,
                    is_leaf=lambda n: isinstance(n, Segments))


def _segments_from_reference(r, like: Segments, layout) -> Segments:
    """A flat value of a tree that mixes dtypes, rebuilt from its params
    subtree ``r`` in each leaf's dtype; each segment comes back as
    ``like``'s does: a tensor on its device, or numpy."""
    lead = tuple(np.shape(like[0])[:-1])
    params = layout.cast(_params_to_port(r, layout, bool(lead)))
    dev = next((p.device for p in like if isinstance(p, torch.Tensor)),
               "cpu")
    out = layout.flatten(params, out=layout.alloc(lead, device=dev))
    return Segments(p if isinstance(lk, torch.Tensor) else p.cpu().numpy()
                    for p, lk in zip(out, like))


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


def lm_rank_to_port(tree, cfg, mesh, *, device=None):
    """A reference LM tree (numpy) -> this rank's shares of it on
    ``mesh`` (a ``launch/mesh.RankMesh``), as the sharded programs take
    them (``launch/sharding.cut`` under ``param_shardings``), on
    ``device``: each share cut on the host, then moved."""
    from repro_torch.launch import sharding as shd
    full = lm_to_port(tree)
    shares = shd.cut(full, shd.param_shardings(full, cfg, mesh), mesh)
    return tree_map(lambda t: t.to(device), shares)


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


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def expert_shard(p, index: int, n_shards: int):
    """The experts rank ``index`` of ``n_shards`` expert shards owns, from
    an MoE FFN's replicated weights (``models/moe.moe_init``'s tree, the
    reference's layout, numpy or torch): the stacked (E, ...) ``w_gate``,
    ``w_up`` and ``w_down`` cut to experts ``[index * E/n, (index + 1) *
    E/n)``, the slice the reference's ``_local_moe`` takes with
    ``dynamic_slice_in_dim(w, index * e_loc, e_loc, 0)``; the router and
    the shared expert are kept as they are (replicated)."""
    e = p["w_gate"].shape[0]
    if e % n_shards or not 0 <= index < n_shards:
        raise ValueError(f"expert shard {index} of {n_shards} over {e} "
                         "experts")
    e_loc = e // n_shards
    return {k: (v[index * e_loc:(index + 1) * e_loc]
                if k in EXPERT_LEAVES else v) for k, v in p.items()}
