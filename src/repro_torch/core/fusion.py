"""Federated model fusion over a flat stacked cohort.

- ``fedavg``: Eq. 1/18 coordinate-based (optionally sample-weighted)
  mean.
- ``paired_average``: Fed2's feature paired averaging (Eq. 19): group g
  of node i fuses with group g' of node j iff their logit signatures
  match. Under the structural pre-alignment the permutation is the
  identity and, with shared sample weights, the whole fusion is ONE
  weighted mean, which is the paper's efficiency claim.
- ``fedprox_penalty``: the FedProx (Li et al., MLSys'20) proximal term.

Every function takes the cohort as a flat value of a
``models/module.FlatLayout``: one (N, M_d) tensor per dtype segment
(``Segments``; ONE (N, M) tensor for a tree of one dtype) whose rows are
the clients' flat parameter vectors, and reduces each segment in its own
dtype; grouped leaves are described by ``GroupAxis`` per layout slot.

``use_kernel=True`` routes the reduction through the fused
``kernels/paired_fusion.py`` kernel (``_kernel_fuse``): ONE launch over
each segment's whole (N, M_d) buffer when every leaf shares the sample
weights (one for a tree of one dtype, two for a bf16 Mamba-2 with its
fp32 leaves), and otherwise one launch per shared leaf and per (pre
index, group) block of each grouped leaf, each with its own presence
column. The kernel accumulates in fp32 and writes each segment in its
dtype. Every parameter is read once either way. ``use_kernel=False`` is
the per-leaf reference reduction, in each leaf's dtype.

``robust=rule`` (a reducing rule of fl/robust.py) replaces the weighted
mean with the rule's sort-based statistic. It has no kernel: the kernel
route is skipped, as the JAX package skips it. Without presence weights
a coordinate rule is one reduction over each segment's whole (N, M_d)
buffer, its result in the segment's dtype; with them, each grouped leaf
reduces per group column with that column's weights.

``shard=RowShard(...)`` fuses a cohort whose rows are split over the
"data" ranks of a mesh (fl/engine.py): each rank holds its rows (the
sync round's contiguous block of the cohort, or, for an async event,
the slots of the K-row buffer whose updates it computed, which need not
be contiguous) and the whole cohort's weights, normalizes them globally
as the one-process route does, sums its rows' weighted parameters (per
group column under Eq. 19's presence weights) in fp32, and ONE
all-reduce per dtype segment adds the ranks' partial sums; each
segment's result is cast to its dtype. This is the reference's mean
over a sharded cohort axis, which lowers to one all-reduce: paired
averaging costs exactly FedAvg's collective. No kernel: the reference
keeps the fusion kernel off on a mesh of more than one device. A
reducing robust rule sorts every row of a coordinate, so under
``shard`` each segment's rows are all-gathered instead
(``RowShard.gather``: one all-gather per dtype segment, in slot order)
and every rank runs the one-process reduction on the whole cohort: the
one-process bits on the same rows.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels.paired_fusion import paired_fusion
from repro_torch.models.module import flat_parts, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class RowShard:
    """The rows this rank holds of a cohort of ``total`` rows: the block
    ``[lo, hi)``, or, where ``index`` is given, the slots it lists in
    ascending order (``lo``, ``hi`` then bound them); ``reduce``, the
    in-place sum of a tensor over the ranks that hold the other rows
    (``launch/collectives.all_reduce`` over "data"), and ``gather``,
    this rank's rows -> the whole cohort's (total, ...) in slot order
    (``launch/collectives.all_gather_rows``; None where only the mean
    runs)."""
    lo: int
    hi: int
    total: int
    reduce: Callable
    gather: Callable | None = None
    index: tuple | None = None

    @property
    def rows(self):
        """This rank's slots: a slice of the block, or the index."""
        if self.index is None:
            return slice(self.lo, self.hi)
        return list(self.index)


@dataclasses.dataclass(frozen=True)
class GroupAxis:
    """Group partitioning of one param leaf: ``axis`` is split into
    ``n_groups`` contiguous blocks; block g belongs to structure group g."""
    axis: int
    n_groups: int


def _norm_weights(weights, n: int, device) -> torch.Tensor:
    if weights is None:
        return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    return w / w.sum()


def _weighted_mean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reference reduction: sum_n w_n x_n over the leading axis."""
    wb = w.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
    return (x * wb).sum(0)


def fedavg(stacked, weights=None, *, use_kernel: bool = False,
           robust=None, shard: RowShard | None = None):
    """Coordinate-based averaging (Eq. 1): (N, M_d) -> (M_d,) per
    segment. ``robust``: a reducing rule replaces the weighted mean
    (use_kernel is ignored). ``shard``: ``stacked`` holds this rank's
    rows of the cohort, ``weights`` the whole cohort's (under a robust
    rule the rows are gathered and the rule reduces them all)."""
    if shard is not None and robust is not None:
        stacked = tree_map(shard.gather, stacked)
        shard = None
    first = tree_leaves(stacked)[0]
    if shard is not None:
        w = _norm_weights(weights, shard.total, first.device)
        return _sharded_mean(stacked, None, None, w, None, shard)
    w = _norm_weights(weights, first.shape[0], first.device)
    if robust is not None:
        return tree_map(lambda x: robust.reduce(x, w), stacked)
    if use_kernel:
        return tree_map(lambda x: paired_fusion(x, w), stacked)
    if weights is None:
        return tree_map(lambda x: x.mean(0), stacked)
    return tree_map(lambda x: _weighted_mean(x, w), stacked)


def _blocks(slot, ga: GroupAxis):
    """(pre, G, blk, post) view dims of a grouped leaf's flat slot."""
    shape = slot.shape
    if shape[ga.axis] % ga.n_groups:
        raise ValueError(f"leaf {slot.path} {shape}: axis {ga.axis} does "
                         f"not split into {ga.n_groups} groups")
    pre = int(np.prod(shape[:ga.axis]))
    post = int(np.prod(shape[ga.axis + 1:]))
    return pre, ga.n_groups, shape[ga.axis] // ga.n_groups, post


def _permute_groups(stacked, layout, group_axes, perms):
    """A copy of ``stacked`` whose grouped leaves have each client's group
    blocks reordered by its row of ``perms`` (N, G)."""
    out = tree_map(torch.clone, stacked)
    src, dst = flat_parts(stacked), flat_parts(out)
    dev = src[0].device
    rows = torch.arange(src[0].shape[0], device=dev)[:, None]
    for slot, ga in zip(layout.slots, layout.leaves(group_axes)):
        if ga is None:
            continue
        pre, g, blk, post = _blocks(slot, ga)
        cols = slice(slot.offset, slot.offset + slot.size)
        x = src[slot.segment][:, cols].reshape(-1, pre, g, blk * post)
        p = torch.as_tensor(perms, device=dev).long()
        x = x.permute(0, 2, 1, 3)[rows, p].permute(0, 2, 1, 3)
        dst[slot.segment][:, cols] = x.reshape(x.shape[0], -1)
    return out


def paired_average(stacked, layout, group_axes, perms=None, weights=None,
                   group_weights=None, *, use_kernel: bool = False,
                   robust=None, shard: RowShard | None = None):
    """Feature paired averaging (Eq. 19): (N, M_d) -> (M_d,) per
    segment.

    layout: the ``FlatLayout`` of one client's parameters.
    group_axes: a tree of the layout's structure with a ``GroupAxis``
    or None (shared layer, plain FedAvg, Eq. 18) per leaf.
    perms: optional (N, G) ints; ``perms[n, g]`` is node n's local group
    holding canonical logit signature g (identity under the structural
    pre-alignment).
    group_weights: optional (N, G) per-node, per-group fusion weights:
    a node that never saw group g's classes is down- or zero-weighted
    for that group. All-zero columns fall back to uniform (no holder:
    plain mean).
    robust: a reducing rule replaces every reduction; grouped leaves
    under presence weights reduce per group column with that column's
    weights, so the trimmed mass renormalizes within each group. No
    kernel route: use_kernel is ignored. Under ``shard`` the rows are
    gathered first and the rule reduces the whole cohort.
    shard: ``stacked`` holds this rank's rows of the cohort (and
    ``perms`` their rows); ``weights`` and ``group_weights`` cover the
    whole cohort."""
    if perms is not None:
        stacked = _permute_groups(stacked, layout, group_axes, perms)
    if shard is not None and robust is not None:
        stacked = tree_map(shard.gather, stacked)
        shard = None
    first = tree_leaves(stacked)[0]
    dev = first.device
    n = first.shape[0] if shard is None else shard.total
    gw = None
    if group_weights is not None:
        gw = torch.as_tensor(group_weights, dtype=torch.float32, device=dev)
        col = gw.sum(0, keepdim=True)
        gw = torch.where(col > 0, gw, torch.ones_like(gw))
        gw = gw / gw.sum(0, keepdim=True)  # (N, G)
    w = _norm_weights(weights, n, dev)
    if shard is not None:
        return _sharded_mean(stacked, layout, group_axes, w, gw, shard)
    if robust is not None and gw is None:
        # coordinate-wise: every leaf of a segment in one reduction
        return tree_map(lambda x: robust.reduce(x, w), stacked)
    if use_kernel and robust is None:
        return _kernel_fuse(stacked, layout, group_axes, w, gw)
    out = _empty_fused(stacked)
    src, dst = flat_parts(stacked), flat_parts(out)
    for slot, ga in zip(layout.slots, layout.leaves(group_axes)):
        x = src[slot.segment][:, slot.offset:slot.offset + slot.size]
        if ga is not None and gw is not None:
            pre, g, blk, post = _blocks(slot, ga)
            xg = x.reshape(n, pre, g, blk * post)
            if robust is not None:
                res = torch.stack([robust.reduce(xg[:, :, gi], gw[:, gi])
                                   for gi in range(g)], dim=1).reshape(-1)
            else:
                wb = gw.reshape(n, 1, g, 1).to(xg.dtype)
                res = (xg * wb).sum(0).reshape(-1)
        elif robust is not None:
            res = robust.reduce(x, w)
        elif weights is None:
            res = x.mean(0)
        else:
            res = _weighted_mean(x, w)
        dst[slot.segment][slot.offset:slot.offset + slot.size] = res
    return out


def _sharded_mean(stacked, layout, group_axes, w, gw, shard: RowShard):
    """The weighted mean of a cohort split over ranks: this rank's rows
    ``stacked`` weighted by their slice of the normalized ``w`` (N,) or,
    on grouped leaves, of ``gw`` (N, G), summed in fp32, then one
    ``shard.reduce`` per dtype segment; each segment cast to its
    dtype."""
    rows = shard.rows
    wl = w[rows]
    acc = tree_map(lambda x: torch.zeros(x.shape[1], dtype=torch.float32,
                                         device=x.device), stacked)
    src, dst = flat_parts(stacked), flat_parts(acc)
    if gw is None:
        for x, a in zip(src, dst):
            a.copy_(wl @ x.to(torch.float32))
    else:
        gwl = gw[rows]
        for slot, ga in zip(layout.slots, layout.leaves(group_axes)):
            lo, hi = slot.offset, slot.offset + slot.size
            x = src[slot.segment][:, lo:hi].to(torch.float32)
            if ga is None:
                dst[slot.segment][lo:hi] = wl @ x
                continue
            pre, g, blk, post = _blocks(slot, ga)
            xg = x.reshape(x.shape[0], pre, g, blk * post)
            dst[slot.segment][lo:hi] = (
                xg * gwl.reshape(-1, 1, g, 1)).sum(0).reshape(-1)
    for a in dst:
        shard.reduce(a)
    return tree_map(lambda a, x: a.to(x.dtype), acc, stacked)


def _empty_fused(stacked):
    """An uninitialized (M_d,) result per segment of ``stacked``."""
    return tree_map(lambda x: torch.empty(x.shape[1], dtype=x.dtype,
                                          device=x.device), stacked)


def _kernel_fuse(stacked, layout, group_axes, w_shared: torch.Tensor,
                 gw_norm: torch.Tensor | None = None):
    """Streaming fusion through ``kernels/paired_fusion.py``.

    Without presence weights every leaf shares ``w_shared``, so each
    segment's whole (N, M_d) buffer is ONE kernel launch. With
    ``gw_norm`` (N, G), column-normalized, each shared leaf is one
    launch with the sample weights, and a grouped leaf of (pre, G, blk,
    post) view dims is ``pre * G`` launches, one per (pre index, group)
    block with column g, on the segment that holds it. Each such block is a contiguous column range of the leaf's slot
    (``cnn_group_axes`` puts every group axis first, so pre = 1 there;
    ``lm``-style stacked (L, G, ...) leaves have pre = L). The kernel
    reads a block in place through the buffer's row stride and writes
    its slice of the result, so no temporary is made."""
    if gw_norm is None:
        return tree_map(lambda x: paired_fusion(x, w_shared), stacked)
    out = _empty_fused(stacked)
    src, dst = flat_parts(stacked), flat_parts(out)
    for slot, ga in zip(layout.slots, layout.leaves(group_axes)):
        x, res = src[slot.segment], dst[slot.segment]
        lo, hi = slot.offset, slot.offset + slot.size
        if ga is None:
            paired_fusion(x[:, lo:hi], w_shared, out=res[lo:hi])
            continue
        pre, g, blk, post = _blocks(slot, ga)
        size = blk * post
        cols = [gw_norm[:, gi].contiguous() for gi in range(g)]
        for pi in range(pre):
            for gi in range(g):
                a = lo + (pi * g + gi) * size
                paired_fusion(x[:, a:a + size], cols[gi],
                              out=res[a:a + size])
    return out


def broadcast_global(global_params, out):
    """Replicate the fused global (M_d,) into every row of ``out``
    (N, M_d), segment by segment, at round start."""
    return tree_map(lambda g, o: o.copy_(g.expand_as(o)), global_params,
                    out)


def presence_group_weights(class_counts, spec) -> np.ndarray:
    """(N, C) per-node class sample counts -> (N, G) group fusion weights:
    node n's weight for group g = its sample count over g's classes."""
    counts = np.asarray(class_counts, np.float64)
    n = counts.shape[0]
    gw = np.zeros((n, spec.n_groups))
    for g in range(spec.n_groups):
        cls = list(spec.classes_per_group[g])
        gw[:, g] = counts[:, cls].sum(axis=1)
    return gw


def fedprox_penalty(params, global_params, mu: float) -> torch.Tensor:
    """(mu/2) * ||w - w_global||^2 over flat values, in fp32."""
    sq = 0
    for p, g in zip(flat_parts(params), flat_parts(global_params)):
        d = p.to(torch.float32) - g.to(torch.float32)
        sq = sq + (d * d).sum()
    return 0.5 * mu * sq


def cnn_group_axes(params, cfg):
    """GroupAxis tree for ``models/cnn.py`` params. In the port's layouts
    every grouped leaf has its group axis first: conv weights are OIHW
    (out channels lead; a depthwise weight (c_in, 1, k, k) leads with its
    channels too), biases and norm affines are per channel, and grouped
    dense weights/biases are (G, ...)."""
    from repro_torch.models.cnn import conv_metas, fc_metas, layer_meta
    metas = layer_meta(cfg)
    g = cfg.fed2_groups
    axes = {"convs": [], "fcs": []}
    for m, layer in zip(conv_metas(metas), params["convs"]):
        grouped = g > 1 and m.groups > 1
        la = {}
        for k, v in layer.items():
            if isinstance(v, dict):
                la[k] = {kk: GroupAxis(0, g) if grouped else None
                         for kk in v}
            else:
                la[k] = GroupAxis(0, g) if grouped else None
        axes["convs"].append(la)
    for m, fc in zip(fc_metas(metas), params["fcs"]):
        axes["fcs"].append({k: GroupAxis(0, g) if m.grouped_fc else None
                            for k in fc})
    return axes


def lm_group_axes(params, cfg):
    """GroupAxis tree for LM params (the reference's ``lm_group_axes``,
    over every family's tree): leaves are shared (None) except the
    block-diagonal unembedding ``(G, d/G, V/G)``, grouped on its leading
    axis, the decoupled blocks' grouped FFN leaves (``gblocks``, stacked
    ``(L, G, i, o)``: axis 1), and for a MoE config (one with
    ``moe.n_experts``) the stacked expert weights ``(L, E, d, f)`` of the
    routed FFNs, whose experts are the structure groups (axis 1)."""
    from repro_torch.models.module import tree_map_with_path
    g = cfg.fed2_groups

    def shared(tree):
        return tree_map(lambda _: None, tree)

    def names(path: str) -> list:
        return path.split("/")

    axes = {k: shared(v) for k, v in params.items()
            if k not in ("gblocks", "unembed")}
    moe = getattr(cfg, "moe", None)
    if cfg.family == "moe" and moe is not None:
        e = moe.n_experts

        def mark_moe(path, leaf):
            ns = names(path)
            if (any("ffn" in n for n in ns)
                    and any(n.endswith(k) for n in ns
                            for k in ("w_gate']", "w_up']", "w_down']"))
                    and "shared" not in "".join(ns) and leaf.ndim == 4):
                return GroupAxis(1, e)
            return None

        axes["blocks"] = tree_map_with_path(mark_moe, params["blocks"])
    if "gblocks" in params:
        def mark(path, leaf):
            if any("ffn" in n for n in names(path)) and leaf.ndim >= 3:
                return GroupAxis(1, g)
            return None
        axes["gblocks"] = tree_map_with_path(mark, params["gblocks"])
    if "unembed" in params:
        if g > 0 and params["unembed"]["w"].ndim == 3:
            axes["unembed"] = {k: GroupAxis(0, g) for k in params["unembed"]}
        else:
            axes["unembed"] = shared(params["unembed"])
    return axes
