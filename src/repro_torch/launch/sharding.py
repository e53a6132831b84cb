"""Placement rules for every model family on a device mesh: the
reference's ``repro.launch.sharding`` rule for rule, returning
placement specs where it returns ``NamedSharding``s.

A spec is a tuple with one entry per dimension of its tensor: None
(replicated along it), an axis name, or a tuple of names (sharded over
their product), as ``jax.sharding.PartitionSpec`` writes it (a tuple of
one name is the name). Nothing here places a tensor: the port runs on
one card, and its multi-GPU placement waits for ``torch.distributed``
on more than one. What the specs give today is each device's share of
bytes (``per_device_bytes``), exactly, on any mesh.

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

from repro_torch.launch.mesh import Mesh, batch_axes
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
    ba = _bspec(mesh, b)
    cache = init_cache(cfg, b, s, device="meta")
    return cache, _map_named(lambda names, leaf: _cache_pspec(names, leaf,
                                                              ba), cache)


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


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a tree, on one device."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
