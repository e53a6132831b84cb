"""Heterogeneous-capacity federation: feature-aligned sub-model tiers.

The port of the JAX package's ``fl/capacity.py``. Clients of different
hardware capacity train sub-models of different WIDTH of one global
net:

- A ``CapacityTier`` is a width fraction w in (0, 1]. Every logical
  client is assigned a tier (``TierPlan.assignment``, carried by
  ``Population.tiers``) from its own numpy stream (``seed + 7331``), so
  the run's sampler and batch stream stay the homogeneous run's.
- Sub-model extraction slices each full leaf per tier (``LeafSlice``):
  shared leaves by contiguous channel PREFIX, grouped (decoupled)
  leaves by WHOLE feature groups (a tier keeps the first K = w*G
  structure groups, so w*G must be an integer), the first fc's input
  rows of a plain net interleaved at the conv->fc flatten boundary, and
  a grouped dense at K = 1 squeezed to a plain dense.
- One ``RoundEngine`` per tier at the tier's width, with its own
  ``FlatLayout`` and (count, M_t) cohort buffer: each round runs every
  tier's tile (local phase + within-tier fuse, one ``paired_fusion``
  launch on the shared-weights route) and combines them.
- Overlap-aware combine: per-coordinate coverage renormalizes the
  weighted sum, so a parameter is averaged only over the clients whose
  tier holds it, and a coordinate no sampled client holds keeps the
  previous global value. With presence-weighted fed2 a grouped leaf's
  coverage is per group column.

On the flat buffers the slice tree becomes, once per tier, one int64
vector mapping each tier flat index to its full flat index (``index``):
extraction is one ``index_select`` and the combine is ``index_add_``
into fp32 (M,) sums and coverages, then
``where(cov > 0, acc / cov, global)``. Every index vector holds each
full index at most once (checked when it is built), so the adds are
deterministic on the card. The combine is plain torch, as the JAX
package computes it with ``jnp`` ops outside any Pallas kernel.

On a mesh of ranks (``mesh=``) every tier's engine splits its tile's
rows over "data" as a sync cohort splits (fl/engine.py), so each
tier's within-tier mean comes back the same on every rank (one
all-reduce a tier) and the combine and the server step run unchanged
on every rank. A tier whose tile has fewer rows than the "data" axis
runs its tile whole on every rank, replicated, with no collective (the
JAX package keeps such an axis replicated too: its async buffer,
``_shardable``), on the fusion route of the mesh (no kernel).

Only methods whose fuse is affine in the weighted client mean support
tiers (``compat.check_tier_support``): fedavg, fedprox, fed2, fednova,
fedavgm, fedadam; scaffold and fedma refuse. A single width-1.0 tier is
degenerate: the runtime runs the homogeneous engine for it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.fl.compat import check_tier_support
from repro_torch.models.module import FlatLayout, tree_get, tree_leaves, \
    tree_map, tree_paths

# ---------------------------------------------------------------------------
# Tier spec & per-client assignment
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CapacityTier:
    """One capacity class: a width fraction of the global model."""
    width: float

    @property
    def name(self) -> str:
        return f"w{round(self.width * 100):03d}"


def parse_tiers(spec) -> tuple:
    """Normalize a tier-mix spec to ``((width, count), ...)``: the CLI
    string ``"1.0x2,0.5x2,0.25x2"`` (width x client count per tier) or
    a sequence of pairs. The result is sorted by descending width."""
    if isinstance(spec, str):
        mix = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                w, c = part.split("x")
                mix.append((float(w), int(c)))
            except ValueError:
                raise ValueError(
                    f"bad tier spec {part!r}; expected <width>x<count>, "
                    "e.g. 1.0x2,0.5x2,0.25x2") from None
    else:
        mix = [(float(w), int(c)) for w, c in spec]
    mix.sort(key=lambda wc: -wc[0])
    return tuple(mix)


def validate_mix(mix, population: int) -> None:
    """The structural checks FLConfig applies at construction."""
    if not mix:
        raise ValueError("tier mix must name at least one tier")
    widths = [w for w, _ in mix]
    if len(set(widths)) != len(widths):
        raise ValueError(f"duplicate tier widths in {mix}")
    for w, c in mix:
        if not (0.0 < w <= 1.0):
            raise ValueError(f"tier width {w} outside (0, 1]")
        if not isinstance(c, int) or c <= 0:
            raise ValueError(f"tier count {c!r} must be a positive int")
    if max(widths) != 1.0:
        raise ValueError(
            "a tier mix needs a width-1.0 tier: the fused global model is "
            f"full-width, and without full-width clients its deepest "
            f"channels would never train (got widths {widths})")
    total = sum(c for _, c in mix)
    if total != population:
        raise ValueError(
            f"tier counts sum to {total} but population is {population}; "
            "every logical client needs exactly one tier")


@dataclasses.dataclass(frozen=True)
class TierPlan:
    """A validated mix plus the per-client tier assignment.

    mix: ``((width, count), ...)`` descending by width.
    assignment: (population,) int32; client i trains tier
    ``assignment[i]`` (an index into ``mix``), a seed-deterministic
    permutation so tier membership does not follow the partition's
    client ids."""
    mix: tuple
    assignment: np.ndarray

    @classmethod
    def from_mix(cls, mix, population: int, *, seed: int = 0) -> "TierPlan":
        mix = parse_tiers(mix)
        validate_mix(mix, population)
        # its own stream: the run's batch/sampler rng (cfg.seed) stays
        # the homogeneous run's
        rng = np.random.default_rng(seed + 7331)
        perm = rng.permutation(population)
        assignment = np.empty(population, np.int32)
        pos = 0
        for t, (_, count) in enumerate(mix):
            assignment[perm[pos:pos + count]] = t
            pos += count
        return cls(mix=mix, assignment=assignment)

    @property
    def tiers(self) -> tuple:
        return tuple(CapacityTier(w) for w, _ in self.mix)

    @property
    def trivial(self) -> bool:
        """Single tier at full width: the homogeneous engine."""
        return len(self.mix) == 1 and self.mix[0][0] == 1.0

    def ids_of(self, tier_idx: int, ids=None) -> np.ndarray:
        """The client ids assigned to tier ``tier_idx`` (restricted to
        ``ids``, order-preserving, when given)."""
        if ids is None:
            return np.nonzero(self.assignment == tier_idx)[0]
        ids = np.asarray(ids)
        return ids[self.assignment[ids] == tier_idx]


# ---------------------------------------------------------------------------
# Sub-model extraction: per-leaf slice maps
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeafSlice:
    """How one tier leaf embeds into its full-model leaf (axes in the
    port's layout: conv weights OIHW).

    idx: per-FULL-axis int index vectors (``np.ix_`` open mesh): whole
    axes carry an arange, sliced axes the kept indices. Contiguous
    prefixes everywhere except the conv->fc flatten boundary of plain
    nets, where kept rows interleave (row % C < C_tier).
    shape: the tier leaf's shape. It differs from the sliced shape only
    for a grouped dense whose tier keeps K = 1 groups: the tier layer is
    then a plain dense and the group axis squeezes away.
    group_axis/block/kept: full-leaf group geometry of a group-sliced
    leaf (kept WHOLE groups).
    tier_grouped: the tier's engine fuses this leaf per group (the tier
    keeps > 1 group), so presence-weighted coverage is per column."""
    idx: tuple
    shape: tuple
    group_axis: int | None = None
    block: int = 0
    kept: int = 0
    tier_grouped: bool = False

    @property
    def sliced_shape(self) -> tuple:
        return tuple(len(i) for i in self.idx)

    def extract(self, leaf: torch.Tensor) -> torch.Tensor:
        out = leaf
        for axis, ix in enumerate(self.idx):
            if len(ix) != leaf.shape[axis]:
                out = out.index_select(axis, torch.as_tensor(
                    ix, device=leaf.device))
        return out.reshape(self.shape)

    def flat_index(self, full_shape: tuple) -> np.ndarray:
        """The row-major flat index in the full leaf of every tier
        element, in the tier leaf's own row-major order."""
        strides = [math.prod(full_shape[a + 1:])
                   for a in range(len(full_shape))]
        mesh = np.ix_(*self.idx)
        flat = sum(m.astype(np.int64) * s for m, s in zip(mesh, strides))
        return np.broadcast_to(flat, self.sliced_shape).ravel()

    def group_column(self) -> np.ndarray | None:
        """The structure group of every tier element along the group
        axis (row-major), or None when the tier does not fuse this leaf
        per group."""
        if not self.tier_grouped:
            return None
        col = np.ix_(*self.idx)[self.group_axis] // self.block
        return np.broadcast_to(col, self.sliced_shape).ravel()


def extract_params(global_params, slices):
    """Slice a full parameter tree down to one tier's sub-model."""
    return tree_map(lambda s, leaf: s.extract(leaf), slices, global_params)


def _tier_leaf_slice(fshape, tshape, ga, kept: int) -> LeafSlice:
    """The shape-driven rule: equal dims stay whole, narrowed dims keep a
    contiguous prefix. Group geometry comes from the full model's
    GroupAxis (None for a shared leaf)."""
    fshape, tshape = tuple(fshape), tuple(tshape)
    grouped = ga is not None
    if len(tshape) == len(fshape) - 1 and grouped and kept == 1:
        # grouped dense at K=1: the tier layer is a plain dense; keep
        # group 0's block and squeeze the group axis
        idx = (np.arange(1),) + tuple(np.arange(t) for t in tshape)
        for fa, ta in zip(fshape[1:], tshape):
            assert ta <= fa, (fshape, tshape)
        return LeafSlice(idx=idx, shape=tshape, group_axis=0, block=1,
                         kept=1, tier_grouped=False)
    assert len(tshape) == len(fshape), (fshape, tshape)
    idx = tuple(np.arange(t) for t in tshape)
    for fa, ta in zip(fshape, tshape):
        assert ta <= fa, (fshape, tshape)
    if not grouped:
        return LeafSlice(idx=idx, shape=tshape)
    block = fshape[ga.axis] // ga.n_groups
    assert tshape[ga.axis] % block == 0, (fshape, tshape, ga)
    return LeafSlice(idx=idx, shape=tshape, group_axis=ga.axis,
                     block=block, kept=tshape[ga.axis] // block,
                     tier_grouped=kept > 1)


def cnn_tier_config(cfg, width: float):
    """The width-w sub-model's CNNConfig.

    Grouped nets (``fed2_groups = G > 0``): w*G must be an integer K;
    the tier keeps the first K whole structure groups, every channel
    count scales by exactly K/G, and the logit layer keeps the first K
    class clusters (``n_classes`` becomes K*(n_classes/G)). Plain nets:
    channel counts round to ``max(1, round(w*c))`` and the classifier
    head keeps ALL classes."""
    g = cfg.fed2_groups
    if not (0.0 < width <= 1.0):
        raise ValueError(f"tier width {width} outside (0, 1]")
    if g:
        k = width * g
        kept = int(round(k))
        if abs(k - kept) > 1e-9 or kept < 1:
            raise ValueError(
                f"tier width {width} does not keep whole feature groups "
                f"at fed2_groups={g} (width*G = {k:g}); group-whole "
                "slicing needs width in " +
                "{" + ", ".join(f"{i}/{g}" for i in range(1, g + 1)) + "}")
        if cfg.n_classes % g:
            raise ValueError(
                f"capacity tiers need fed2_groups ({g}) to divide "
                f"n_classes ({cfg.n_classes}) so dropped groups drop "
                "whole class clusters")
        scale = lambda c: (cfg.round_ch(c) * kept) // g        # noqa: E731
        n_classes = (cfg.n_classes * kept) // g
        groups = kept
    else:
        scale = lambda c: max(1, int(round(c * width)))        # noqa: E731
        n_classes = cfg.n_classes
        groups = 0
    if width == 1.0:
        return cfg
    plan = tuple(
        s if s[0] == "p" else (s[0], scale(s[1])) + tuple(s[2:])
        for s in cfg.plan)
    return dataclasses.replace(
        cfg, arch_id=f"{cfg.arch_id}-w{round(width * 100):03d}", plan=plan,
        fc_dims=tuple(scale(d) for d in cfg.fc_dims), n_classes=n_classes,
        fed2_groups=groups)


@dataclasses.dataclass
class TierModel:
    """One tier's runnable sub-model: its task (tier-shaped init and
    loss), the slice tree into the full model, and sizing."""
    tier: CapacityTier
    model_cfg: Any
    task: Any                 # FLTask over the tier sub-model
    slices: Any               # LeafSlice tree, full-model structure
    param_bytes: int          # per-client uplink per round
    n_classes_kept: int


def cnn_tier_model(model_cfg, width: float) -> TierModel:
    """The width-w sub-model of a CNN: config, slice tree, and an FLTask
    whose loss masks the examples of dropped class clusters (a grouped
    tier that kept K of G groups emits only the first K clusters'
    logits)."""
    from repro_torch.core import fusion as fusion_lib
    from repro_torch.fl import runtime as runtime_lib
    from repro_torch.models.cnn import apply_cnn, conv_metas, fc_metas, \
        init_cnn, layer_meta

    tier_cfg = cnn_tier_config(model_cfg, width)
    gen = torch.Generator().manual_seed(0)
    full, tier = init_cnn(gen, model_cfg), init_cnn(gen, tier_cfg)
    ga_tree = fusion_lib.cnn_group_axes(full, model_cfg)
    kept = tier_cfg.fed2_groups if model_cfg.fed2_groups else 0
    slices = tree_map(
        lambda f, t, ga: _tier_leaf_slice(f.shape, t.shape, ga, kept),
        full, tier, ga_tree)

    # conv->fc flatten boundary of plain nets: the flatten is (h, w, c)
    # channels-fastest, so the kept input rows of the first fc
    # interleave: row r survives iff (r % C_full) < C_tier. (Grouped
    # nets flatten group-major, which keeps a contiguous prefix;
    # MobileNet mean-pools, so rows are channels.)
    fmetas = layer_meta(model_cfg)
    if (not model_cfg.fed2_groups and not model_cfg.is_mobilenet
            and fc_metas(fmetas)):
        c_full = conv_metas(fmetas)[-1].c_out
        c_tier = conv_metas(layer_meta(tier_cfg))[-1].c_out
        if c_tier < c_full:
            d_in = fc_metas(fmetas)[0].c_in
            rows = np.nonzero((np.arange(d_in) % c_full) < c_tier)[0]
            s0 = slices["fcs"][0]["w"]
            slices["fcs"][0]["w"] = dataclasses.replace(
                s0, idx=(rows,) + s0.idx[1:])

    for path in tree_paths(tier):       # every slice gives the tier shape
        s, t = tree_get(slices, path), tree_get(tier, path)
        assert s.shape == tuple(t.shape), (path, s.shape)
        assert math.prod(s.sliced_shape) == t.numel(), path

    task = runtime_lib.cnn_task(tier_cfg)
    if model_cfg.fed2_groups and tier_cfg.n_classes < model_cfg.n_classes:
        ncls = tier_cfg.n_classes

        def masked_loss(p, b):
            logits = apply_cnn(p, tier_cfg, b["images"])
            logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            labels = b["labels"].long()
            mask = (labels < ncls).to(torch.float32)
            lab = torch.clamp(labels, max=ncls - 1)
            gold = torch.gather(logp, -1, lab[:, None])[:, 0]
            return -(mask * gold).sum() / torch.clamp(mask.sum(), min=1.0)

        task.loss_fn = masked_loss
    task.tier_fn = None           # no tiers of tiers
    pbytes = sum(t.numel() * t.element_size() for t in tree_leaves(tier))
    return TierModel(tier=CapacityTier(width), model_cfg=tier_cfg,
                     task=task, slices=slices, param_bytes=pbytes,
                     n_classes_kept=(tier_cfg.n_classes
                                     if model_cfg.fed2_groups
                                     else model_cfg.n_classes))


# ---------------------------------------------------------------------------
# The tiered engine: one engine per tier + overlap-aware combine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TierTile:
    """One tier's engine and its flat embedding into the full vector.

    index: (M_t,) int64, the full flat index of every tier flat index
    (None for the width-1.0 tier: the identity). column: (M_t,) int64,
    each tier element's presence column (``kept`` for an element whose
    coverage is the tier's weight mass), None without presence
    weighting."""
    tier: CapacityTier
    model: TierModel
    width: int                # fixed slot count of this tier's tile
    engine: Any               # RoundEngine at cohort_size = width
    index: torch.Tensor | None
    column: torch.Tensor | None
    kept: int                 # presence columns the tier keeps

    def extract(self, global_params: torch.Tensor) -> torch.Tensor:
        """The full flat global -> this tier's flat global."""
        if self.index is None:
            return global_params
        return global_params.index_select(0, self.index)


@dataclasses.dataclass
class TieredEngine:
    """Per-tier engines over one full-width server. A tiered round
    (``run_tiered_round``) runs every tier's ``run_tile``, ``combine``
    embeds the tier means into the full vector with per-coordinate
    coverage, and ``full.finish_round`` applies the method's server
    step once."""
    plan: TierPlan
    tiles: list
    full: Any                 # full-width RoundEngine (server, layout)
    method: Any
    use_gw: bool              # presence-weighted grouped coverage

    def combine(self, global_params, means, weight_masses, group_masses):
        """means[t]: tier t's within-tile weighted mean (tier flat) or
        None when no sampled client holds tier t; weight_masses[t]: the
        sum of its participants' weights; group_masses[t]: the sums of
        its (slots, K_t) presence columns (None without presence
        weighting). Returns the fused full (M,) vector: acc / coverage
        where covered, the previous global elsewhere."""
        dev = global_params.device
        acc = torch.zeros(global_params.shape, dtype=torch.float32,
                          device=dev)
        cov = torch.zeros_like(acc)
        for tile, mean, w, gm in zip(self.tiles, means, weight_masses,
                                     group_masses):
            if mean is None:
                continue
            w = torch.tensor(w, dtype=torch.float32, device=dev)
            if tile.column is not None:
                table = torch.cat([torch.as_tensor(
                    np.asarray(gm)[:tile.kept], dtype=torch.float32,
                    device=dev), w.reshape(1)])
                scale = table[tile.column]
            else:
                scale = w.expand(mean.shape)
            x = mean.to(torch.float32) * scale
            if tile.index is None:
                acc += x
                cov += scale
            else:
                acc.index_add_(0, tile.index, x)
                cov.index_add_(0, tile.index, scale)
        safe = torch.where(cov > 0, cov, torch.ones_like(cov))
        return torch.where(cov > 0, acc / safe,
                           global_params.to(torch.float32)).to(
                               global_params.dtype)


def _tile_maps(full_layout: FlatLayout, tier_layout: FlatLayout, slices,
               use_gw: bool, kept: int):
    """(index, column) numpy vectors of one tier over the flat layouts
    (index None when the tier is the identity)."""
    full_slots = {s.path: s for s in full_layout.slots}
    index, column = [], []
    for slot in tier_layout.slots:
        fs = full_slots[slot.path]
        s = tree_get(slices, slot.path)
        index.append(fs.offset + s.flat_index(fs.shape))
        col = s.group_column() if use_gw else None
        column.append(np.full(slot.size, kept, np.int64) if col is None
                      else col.astype(np.int64))
    index = np.concatenate(index)
    if len(np.unique(index)) != len(index):
        raise AssertionError("a tier's index maps two elements to one "
                             "full coordinate")
    if (tier_layout.size == full_layout.size
            and np.array_equal(index, np.arange(full_layout.size))):
        index = None
    return index, (np.concatenate(column) if use_gw else None)


def make_tiered_engine(task, cfg, params_like, plan: TierPlan, *, device,
                       use_kernel=None, use_local_kernel: bool = False,
                       method=None, use_gw: bool = False,
                       grad_chunk: int | None = None,
                       mesh=None) -> TieredEngine:
    """Per-tier engines and the overlap-aware combine. ``task`` must
    carry ``tier_fn`` (``cnn_task`` wires ``cnn_tier_model``). ``mesh``:
    None, a one-device mesh, or this rank's ``RankMesh`` (the module
    docstring says how the tiles split)."""
    from repro_torch.fl import methods as methods_lib
    from repro_torch.fl.engine import make_round_engine, resolve_use_kernel

    meth = method if method is not None else methods_lib.get(cfg.method)
    check_tier_support(meth)
    if params_like is not None:
        FlatLayout(params_like).require_one_dtype("capacity tiers")
    if task.tier_fn is None:
        raise ValueError(
            "this task has no tier_fn: capacity tiers are defined for "
            "model families with a sub-model builder (cnn_task)")
    base_cfg = dataclasses.replace(cfg, tiers=None)
    kw = dict(device=device, use_kernel=resolve_use_kernel(use_kernel, mesh),
              use_local_kernel=use_local_kernel, method=meth,
              grad_chunk=grad_chunk)
    full = make_round_engine(task, base_cfg, params_like, mesh=mesh, **kw)
    data = 1 if mesh is None or mesh.size == 1 else mesh.shape["data"]
    tiles = []
    for width, count in plan.mix:
        model = task.tier_fn(width)
        # one fixed-width tile per tier, sized by the tier's client
        # count: full participation sends exactly count ids per tier,
        # cohort-sized samplers fewer (padded at zero weight)
        tier_cfg = dataclasses.replace(base_cfg, cohort_size=count)
        tparams = model.task.init_fn(torch.Generator().manual_seed(0))
        # a tile narrower than "data" runs whole on every rank
        engine = make_round_engine(model.task, tier_cfg, tparams,
                                   mesh=mesh if count >= data else None,
                                   **kw)
        kept = model.model_cfg.fed2_groups or 1
        index, column = _tile_maps(full.layout, engine.layout, model.slices,
                                   use_gw, kept)
        as_dev = (lambda a: None if a is None
                  else torch.as_tensor(a, device=device))
        tiles.append(TierTile(tier=CapacityTier(width), model=model,
                              width=count, engine=engine,
                              index=as_dev(index), column=as_dev(column),
                              kept=kept))
    return TieredEngine(plan=plan, tiles=tiles, full=full, method=meth,
                        use_gw=use_gw)


def run_tiered_round(tiered: TieredEngine, pop, method, server_state,
                     global_params, ids, get_batch, n_steps, cfg, rng,
                     uniform_weights: bool = False):
    """One heterogeneous round: every tier's tile (local phase +
    within-tier fuse over its sampled clients, zero-weight padded to the
    tile width), the overlap-aware combine, one server step. Returns
    (server_state, new_global), like ``runtime.run_sampled_round``."""
    from repro_torch.fl.runtime import device_batches, pad_tile_inputs

    ids = np.asarray(ids, np.int64)
    # Population.tiers carries the per-client tier ids; direct engine
    # drives that skipped it route by the plan
    assignment = (pop.tiers if pop.tiers is not None
                  else tiered.plan.assignment)
    means, w_masses, g_masses = [], [], []
    for t, tile in enumerate(tiered.tiles):
        tids = ids[assignment[ids] == t]
        if len(tids) == 0:          # contributes nothing to the combine
            means.append(None)
            w_masses.append(0.0)
            g_masses.append(None)
            continue
        _, w, gw, batches = pad_tile_inputs(
            pop, tids, tile.width, get_batch, n_steps, cfg.batch_size,
            rng, uniform_weights=uniform_weights, gw_cols=tile.kept)
        use_gw = tiered.use_gw and gw is not None
        _, fuse_out = tile.engine.run_tile(
            (), server_state, tile.extract(global_params),
            device_batches(batches, tile.engine.device, tile.engine.rows),
            weights=w, group_weights=gw if use_gw else None)
        means.append(fuse_out)
        w_masses.append(float(w.sum()))
        g_masses.append(gw.sum(axis=0) if use_gw else None)
    fused = tiered.combine(global_params, means, w_masses, g_masses)
    return tiered.full.finish_round(server_state, global_params, fused)


# ---------------------------------------------------------------------------
# Dry-run lowering of one tier tile (launch/fl_dryrun.py)
# ---------------------------------------------------------------------------


def lower_tier_tile(task, cfg, mesh, batch_elems: dict, *, width: float,
                    local_steps: int, use_kernel=None):
    """One tier's tile (local phase + within-tier fuse) on ``meta``: the
    JAX package's ``lower_tier_tile``, the per-tier analog of
    ``engine.lower_round``. Its arguments: the (empty) client and
    server states, the tier's flat global params, the batches and the
    weights w (C,), all read. Returns (LoweredStep, TierModel). On a
    mesh of more than one device its ``rank`` is rank 0's tile, split
    over "data" as ``make_tiered_engine`` splits it (a tile narrower than
    "data" whole, replicated)."""
    from repro_torch.fl.engine import (LoweredStep, RankStep,
                                       client_sharded, dry_rank0,
                                       reference_leaves, replicated,
                                       resolve_use_kernel)

    cfg = dataclasses.replace(cfg, tiers=None, local_epochs=1,
                              steps_per_epoch=local_steps)
    model = task.tier_fn(width)
    engine, call, args = _tile_program(model, cfg, batch_elems,
                                       local_steps)
    rank, dry = None, dry_rank0(mesh)
    if dry is not None:
        wide = cfg.cohort_size >= dry.shape["data"]
        rank = RankStep(*_tile_program(model, cfg, batch_elems, local_steps,
                                       dry if wide else None)[1:], dry)
    _, _, gp, batches, w = args
    outs = ((), gp)
    return LoweredStep(
        call=call, args=args,
        specs=((), (), replicated(gp), client_sharded(batches),
               replicated(w)),
        reads=(True,) * 5, outs=outs, out_specs=((), (None,)),
        out_leaves=reference_leaves(outs, engine.layout),
        use_kernel=resolve_use_kernel(use_kernel, mesh), engine=engine,
        cfg=cfg, rank=rank), model


def _tile_program(model, cfg, batch_elems, local_steps, mesh=None):
    """``lower_tier_tile``'s engine on ``meta`` (on ``mesh``: None or a
    dry rank mesh), its tile program and arguments (the batches of the
    engine's rows). (engine, call, args)."""
    from repro_torch.fl.engine import (make_round_engine, meta_batches,
                                       param_shapes)
    n = cfg.cohort_size
    engine = make_round_engine(model.task, cfg, param_shapes(model.task),
                               device="meta", use_kernel=False,
                               use_local_kernel=False, mesh=mesh)
    gp = engine.layout.alloc(device="meta")
    batches = meta_batches(batch_elems, engine.rows.stop - engine.rows.start,
                           local_steps)
    w = torch.empty((n,), dtype=torch.float32, device="meta")

    def call(clients, server, gp, batches, w):
        return engine.run_tile(clients, server, gp, batches, weights=w)

    return engine, call, ((), (), gp, batches, w)
