"""Placement rules for every model family on a device mesh: the
reference's ``repro.launch.sharding`` rule for rule, returning
placement specs where it returns ``NamedSharding``s.

A spec is a tuple with one entry per dimension of its tensor: None
(replicated along it), an axis name, or a tuple of names (sharded over
their product), as ``jax.sharding.PartitionSpec`` writes it (a tuple of
one name is the name). The specs give each device's share of bytes
(``per_device_bytes``), exactly, on any mesh; ``cut`` gives a rank of a
``launch/mesh.RankMesh`` exactly that share of a tree (XLA's block of
each sharded dimension: the ceiling of an uneven split, the last block
zero-padded to it), and ``join`` puts the ranks' shares back together.
The sharded prefill and decode programs (``models/parallel.py``) run on
such shares.

Scheme (Megatron-style tensor parallel on axis "model", batch on
("pod","data")):
  - column-parallel (shard OUT dim):  wq wk wv wq_a wq_b wkv_a wk_b wv_b
                                      w_z w_xbc w_gate w_up  (+ their biases)
  - row-parallel (shard IN dim):      wo w_down out_proj     (bias replicated)
  - embeddings: vocab-sharded; unembedding: vocab (last dim) sharded
  - MoE experts: expert-parallel on "model" when E % |model| == 0
    (deepseek-v2: 160/16), else per-expert tensor-parallel on d_ff (mixtral)
  - SSM: w_z/w_xbc column-parallel, out_proj row-parallel, depthwise conv +
    states sharded on the channel/head axis
  - norms / scalar per-head params: replicated
  - decode caches: KV head-dim (always a multiple of 16 across the assigned
    archs) on "model"; MLA latent dim on "model"; batch on "data" when
    divisible (long_500k B=1 stays replicated on data).
"""
from __future__ import annotations

import math

import torch

from repro_torch.launch.mesh import Mesh, RankMesh, batch_axes
from repro_torch.models.module import (tree_get, tree_leaves, tree_paths,
                                       tree_unflatten)

COL = {"wq", "wk", "wv", "wq_a", "wq_b", "wkv_a", "wk_b", "wv_b",
       "w_z", "w_xbc", "w_gate", "w_up"}
ROW = {"wo", "w_down", "out_proj"}


def _entry(axes):
    """A spec entry as PartitionSpec normalizes it: a tuple of one name
    is the name."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def _spec(nd: int, at: dict | None = None) -> tuple:
    """A spec of ``nd`` entries: None, but ``at[i]`` at each index i of
    ``at``."""
    spec = [None] * nd
    for i, axes in (at or {}).items():
        spec[i] = _entry(axes)
    return tuple(spec)


def _map_named(rule, tree):
    """A tree of ``tree``'s structure holding ``rule(names, leaf)`` for
    every leaf, ``names`` its path as strings (dict keys, list
    indices)."""
    paths = tree_paths(tree)
    return tree_unflatten(tree, [rule([str(k) for k in p],
                                      tree_get(tree, p)) for p in paths])


def _param_pspec(names, leaf, cfg, msize) -> tuple:
    last = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    nd = len(leaf.shape)

    if last == "table":
        if "embed" in names:
            return _spec(nd, {0: "model"})    # vocab-sharded embedding
        return _spec(nd)                    # positional tables: replicate
    if "unembed" in names:
        return _spec(nd, {-1: "model"})    # (d, V); grouped (G, d/G, V/G)

    # MoE stacked expert tensors: leaves named w_gate/w_up/w_down directly
    if last in ("w_gate", "w_up", "w_down") and nd >= 3 \
            and "shared" not in names:
        e = leaf.shape[-3]
        if e % msize == 0:                  # expert-parallel
            return _spec(nd, {-3: "model"})
        if last == "w_down":                # (L, E, f, d): shard f
            return _spec(nd, {-2: "model"})
        return _spec(nd, {-1: "model"})    # (L, E, d, f): shard f

    if parent in COL or (parent == "shared" and last in ("w_gate", "w_up")):
        if last in ("w", "b"):
            return _spec(nd, {-1: "model"})
    if parent in ROW or (parent == "shared" and last == "w_down"):
        if last == "w":
            return _spec(nd, {-2: "model"})
        return _spec(nd)                    # row-parallel bias: replicate
    # conv depthwise: channel axis last
    if parent == "conv":
        return _spec(nd, {-1: "model"})
    return _spec(nd)                        # norms, a_log, dt_bias, ...


def param_shardings(params, cfg, mesh: Mesh):
    """A spec tree for a params tree (e.g. ``init_params(...,
    device="meta")``)."""
    msize = mesh.shape["model"]
    return _map_named(lambda names, leaf: _param_pspec(names, leaf, cfg,
                                                       msize), params)


def zero1_shardings(params, cfg, mesh: Mesh):
    """ZeRO-1 placement for optimizer state and grad accumulators: the
    param spec PLUS the first still-replicated axis that divides evenly
    sharded over "data" (and "pod" when present)."""
    msize = mesh.shape["model"]
    extra = tuple(a for a in ("data", "pod") if a in mesh.axis_names)
    dsize = math.prod(mesh.shape[a] for a in extra)

    def rule(names, leaf):
        spec = list(_param_pspec(names, leaf, cfg, msize))
        for i, (s, dim) in enumerate(zip(spec, leaf.shape)):
            if s is None and dim % dsize == 0 and dim >= dsize:
                spec[i] = _entry(extra)
                break
        return tuple(spec)

    return _map_named(rule, params)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def _bspec(mesh: Mesh, batch: int):
    ba = batch_axes(mesh)
    nb = math.prod(mesh.shape[a] for a in ba)
    return _entry(ba) if batch % nb == 0 else None


def batch_rows(mesh: Mesh, batch: int) -> tuple:
    """[lo, hi): a rank's rows of a batch of ``batch`` rows under
    ``_bspec`` (every row where the batch does not divide the batch
    axes: it is replicated there)."""
    entry = _bspec(mesh, batch)
    if entry is None or not isinstance(mesh, RankMesh):
        return 0, batch
    n = _blocks(entry, mesh)
    size = batch // n
    lo = _block(entry, mesh) * size
    return lo, lo + size


def batch_specs(cfg, shape, mesh: Mesh):
    """(batch, specs): a train or prefill batch of ``shape`` on ``meta``
    and its spec tree. A vlm's text is shortened so that patches + text
    = seq_len."""
    b, s = shape.global_batch, shape.seq_len
    ba = _bspec(mesh, b)
    text = s - cfg.n_patches if cfg.family == "vlm" else s

    def empty(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    batch = {"tokens": empty((b, text), torch.int32),
             "labels": empty((b, text), torch.int32),
             "mask": empty((b, text), torch.float32)}
    specs = {k: (ba, None) for k in batch}
    frames = {"encdec": cfg.enc_frames, "vlm": cfg.n_patches}.get(
        cfg.family)
    if frames:
        batch["embeds"] = empty((b, frames, cfg.d_model), cfg.dtype)
        specs["embeds"] = (ba, None, None)
    return batch, specs


def _cache_pspec(names, leaf, ba) -> tuple:
    nd = len(leaf.shape)
    last = names[-1]
    if last == "slot_pos":
        return _spec(nd)
    if last in ("k", "v"):          # (L, B, S, kv, hd)
        return _spec(nd, {-4: ba, -1: "model"})  # hd: a multiple of 16
    if last == "c_kv":              # (L, B, S, kv_lora)
        return _spec(nd, {-3: ba, -1: "model"})
    if last == "k_rope":            # (L, B, S, 64)
        return _spec(nd, {-3: ba})
    if last == "conv":              # (L, B, K-1, conv_dim)
        return _spec(nd, {-3: ba, -1: "model"})
    if last == "ssm":               # (L, B, H, P, N)
        return _spec(nd, {-4: ba, -3: "model"})
    return _spec(nd)


def cache_specs(cfg, shape, mesh: Mesh):
    """(cache, specs): the decode cache of (cfg, shape) on ``meta`` and
    its spec tree."""
    from repro_torch.models.forward import init_cache
    b, s = shape.global_batch, shape.seq_len
    cache = init_cache(cfg, b, s, device="meta")
    return cache, cache_shardings(cache, b, mesh)


def cache_shardings(cache, batch: int, mesh: Mesh):
    """The spec tree of a decode cache of ``batch`` rows."""
    ba = _bspec(mesh, batch)
    return _map_named(lambda names, leaf: _cache_pspec(names, leaf, ba),
                      cache)


def decode_token_specs(cfg, shape, mesh: Mesh):
    """((tokens (B, 1) int32, pos () int32) on ``meta``, their
    specs)."""
    b = shape.global_batch
    tok = torch.empty((b, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return (tok, pos), ((_bspec(mesh, b), None), ())


def _shard(dim: int, entry, mesh: Mesh) -> int:
    """One device's extent of a dimension under a spec entry (XLA pads
    an uneven split: the ceiling)."""
    if entry is None:
        return dim
    axes = entry if isinstance(entry, tuple) else (entry,)
    return -(-dim // math.prod(mesh.shape[a] for a in axes))


def per_device_bytes(tree, specs, mesh: Mesh) -> int:
    """Bytes one device holds of ``tree`` (tensors, any device, meta
    too) placed by ``specs`` (a tree of its structure): each leaf's
    shard, the product of its dims each divided by its axes' sizes."""
    total = 0
    for path in tree_paths(tree):
        leaf, spec = tree_get(tree, path), tree_get(specs, path)
        total += math.prod(_shard(d, e, mesh) for d, e
                           in zip(leaf.shape, spec, strict=True)) \
            * leaf.element_size()
    return total


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _blocks(entry, mesh: Mesh) -> int:
    """The number of blocks a spec entry splits a dimension into."""
    return math.prod(mesh.shape[a] for a in _axes(entry))


def _block(entry, mesh: RankMesh) -> int:
    """This rank's block under a spec entry: its coordinates on the
    entry's axes, row-major (the first axis slowest), as XLA numbers a
    dimension's blocks over several mesh axes."""
    i = 0
    for a in _axes(entry):
        i = i * mesh.shape[a] + mesh.coord(a)
    return i


def _block_slices(shape, spec, mesh: RankMesh) -> list:
    """(dim, lo, hi, extent) of each sharded dimension of a leaf of
    ``shape``: this rank's rows [lo, hi) of the dimension, in a block of
    ``extent`` (the ceiling; hi - lo is less only in the last block of
    an uneven split)."""
    out = []
    for d, (n, entry) in enumerate(zip(shape, spec, strict=True)):
        if entry is None:
            continue
        extent = _shard(n, entry, mesh)
        lo = min(_block(entry, mesh) * extent, n)
        out.append((d, lo, min(lo + extent, n), extent))
    return out


def shard_shape(shape, spec, mesh: Mesh) -> tuple:
    """One device's shape of a leaf of ``shape`` under ``spec``."""
    return tuple(_shard(n, e, mesh) for n, e in zip(shape, spec,
                                                    strict=True))


def cut(tree, specs, mesh: RankMesh):
    """This rank's shares of ``tree`` (tensors, meta too) placed by
    ``specs``: each sharded leaf's block, in contiguous memory of its
    own, made once here (the last block of an uneven split zero-padded
    to the ceiling, as XLA holds it); a replicated leaf as it is. A
    rank then holds ``per_device_bytes(tree, specs, mesh)``."""
    def one(path):
        t, spec = tree_get(tree, path), tree_get(specs, path)
        blocks = _block_slices(t.shape, spec, mesh)
        if not blocks:
            return t
        for d, lo, hi, _ in blocks:
            t = t.narrow(d, lo, hi - lo)
        share = t.new_zeros(shard_shape(tree_get(tree, path).shape, spec,
                                        mesh))
        share[tuple(slice(0, n) for n in t.shape)] = t
        return share
    return tree_unflatten(tree, [one(p) for p in tree_paths(tree)])


def join(shares, meshes, specs, like):
    """The whole tree from every rank's shares (``shares[i]`` cut on
    ``meshes[i]``: the ranks' meshes, every block present at least
    once), on the CPU, of ``like``'s shapes and dtypes (a tree of
    tensors, meta too). A replicated leaf is rank 0's; padding past an
    uneven split's end is dropped."""
    def one(path):
        ref, spec = tree_get(like, path), tree_get(specs, path)
        full = torch.empty(ref.shape, dtype=ref.dtype)
        for i, (share, mesh) in enumerate(zip(shares, meshes,
                                              strict=True)):
            blocks = _block_slices(ref.shape, spec, mesh)
            if i and not blocks:
                break
            dst = [slice(None)] * len(ref.shape)
            src = [slice(None)] * len(ref.shape)
            for d, lo, hi, _ in blocks:
                dst[d], src[d] = slice(lo, hi), slice(0, hi - lo)
            full[tuple(dst)] = tree_get(share, path)[tuple(src)].cpu()
        return full
    return tree_unflatten(like, [one(p) for p in tree_paths(like)])


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a tree, on one device."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
