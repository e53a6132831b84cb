"""Federated round engine on one device, or on a mesh of ranks.

One round over a fixed-width COHORT of client slots (width =
``cfg.cohort_size``; the engine never sees the logical population):

    stacked <- broadcast(global)               # round start
    stacked, cstate <- method.client_update(stacked, batches, cstate)
    fused   <- method.fuse(stacked)            # the only cross-cohort op
    sstate, global <- method.server_update(sstate, fused)
    global  <- method.host_fuse(stacked)       # host_fusion methods only

The cohort lives in one flat (C, M_d) buffer per leaf dtype (rows =
clients, per-leaf views through ``FlatLayout``: ONE (C, M) buffer for a
tree of one dtype), each leaf kept in its own dtype as the JAX package
keeps it, allocated once and reused every round: broadcast is one copy
into each, the local phase takes a vmapped gradient over their rows and
steps each in its dtype, and the fusion reads each in one
``paired_fusion`` launch when all leaves share the sample weights. The
``local_step`` kernel route steps ONE buffer of the whole tree, as the
reference's ``ravel_pytree`` route does: the cohort buffer itself in
place, or, for a tree that mixes dtypes (a bf16 Mamba-2 with its fp32
``a_log``, ``dt_bias`` and ``d_skip``), an fp32 copy of every leaf
allocated once with the engine (``MethodContext.ravel_buffer``) and
copied back at the end of the local phase.

On a tree that mixes dtypes every axis of the round works segment by
segment, each leaf in its own dtype: model poisoning, the robust rules,
the codecs, the bf16 local phase (below), the async engine's events and
the ``mmap`` store of a client-stateless method. Two refuse it, as the
JAX package cannot run them either: the capacity tiers (no task with a
sub-model builder has such a tree) and the ``mmap`` store of a method
with client rows (scaffold: numpy has no bfloat16 to map).

The method comes from the fl/methods.py registry; the engine never
branches on its name. Because cohorts are sampled each round, the
per-slot fusion weights ``w`` (and fed2's presence rows ``gw``) are round
arguments: fusion renormalizes them over the participants it sees.

The feature axes of the sync round slot in at its boundaries, in the
JAX package's order (``local_and_fuse``, its fl/engine.py):

    stacked <- broadcast(global)
    work    <- stacked cast to the compute dtype   # bf16: the shadow
    work    <- method.client_update(work, batches cast down, ...)
    work    <- attack.poison_update(work, global)  # malicious rows, in
    #                                                the compute dtype
    stacked <- work cast back to the storage dtypes
    stacked <- codec.roundtrip(stacked, global)   # decode-then-fuse
    stacked <- robust.pre(stacked, global)        # norm_clip
    fused   <- method.fuse(stacked)               # robust.reduce inside

With ``compute_dtype="bfloat16"`` the local phase runs in ONE bf16 (C,
M) shadow of the whole tree (``layout.raveled``'s slots, in tree
order), allocated once: the JAX package casts every float leaf to bf16
(fp32 ``a_log``, ``dt_bias`` and ``d_skip`` of a bf16 Mamba-2
included), so its local phase sees a tree of one dtype. Broadcast
writes the global into every row (the cast down), the methods see the
one-buffer layout, the ``local_step`` kernel route updates the shadow
in place with a bf16 velocity, the batches' float leaves are cast to
bf16 (integer leaves are not), and the trained rows are copied back
into the cohort's buffers, each leaf rounded into its storage dtype,
which the fusion reads.

For rounds whose participant set exceeds one cohort (cohort tiling),
``run_tile`` executes local phase + fuse for one tile, and
``finish_round`` applies the server step once to the tiles' combined
fusion result (``host_fuse`` once to the tiles' stacked params, for
host-fusion methods). The capacity tiers (fl/capacity.py) run one
engine per tier through ``run_tile``; the buffered-async driver
(fl/async_engine.py) splits the tile at the fusion boundary:
``local_phase`` for a dispatch group, ``method.fuse`` and
``server_update`` under ``round_ctx`` for a fusion event.

Client state comes in as host (numpy) rows or as device tensors and
goes out on the device; the runtime decides where it lives between
rounds (fl/runtime.py).

``make_round_engine(..., mesh=)`` places the round as the JAX package's
``mesh=`` does. ``None`` or a one-device mesh (``make_host_mesh``) is
the one-process engine. On a ``launch/mesh.RankMesh`` of more than one
rank the cohort axis is split over "data": each rank holds its
contiguous block of cohort rows (``launch/mesh.data_block``,
``np.array_split``'s blocks, so any cohort of at least the "data"
size) and runs the uplink half on them: the local phase (one
``local_step`` launch a step under ``use_local_kernel``, the bf16
shadow of its rows), model poisoning of its rows (the malicious row's
slice, each row's noise drawn for its cohort slot), the codec and
``norm_clip``, each per row. The fusion goes through ``core/fusion``'s
``RowShard``: the weighted mean as one all-reduce per dtype segment a
round (Fed2's paired averaging at exactly FedAvg's collective), a
reducing robust rule as one all-gather per segment and the
one-process reduction on every rank. A client-stateful method's state
rows come in and go out as the whole cohort's: the local phase takes
this rank's rows, and the new rows are all-gathered (one all-gather
per segment), so ``server_update`` (scaffold's control variate) runs
the one-process step on the whole cohort. FedMA's fuse gathers the
trained rows and every rank runs the host matching. So every rank ends
the round with the same global. The fusion kernel is off there
(``resolve_use_kernel``). Every method and every axis of the sync
round runs on ranks, and so do the engines built on this one: the
capacity tiers' tiles (fl/capacity.py) and the async engine's dispatch
groups and events (fl/async_engine.py, whose event rows lie where they
were computed: ``slot_shard``).

``lower_round`` builds the round's device program (``device_round``:
``run_round`` up to ``host_fuse``) and its arguments on ``meta``, each
beside the JAX package's placement, for the dry-run
(launch/fl_dryrun.py), and on a mesh of more than one device a second
build of the same case: rank 0's program on a dry mesh
(``launch/mesh.make_dry_rank_mesh``, ``RankStep``), whose run counts the
collectives a rank issues; ``traced_reads`` follows data through one run
of such a program to find the arguments it reads.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import fusion as fusion_lib
from repro_torch.fl import attacks as attacks_lib
from repro_torch.fl import codec as codec_lib
from repro_torch.fl import compat as compat_lib
from repro_torch.fl import methods as methods_lib
from repro_torch.fl import robust as robust_lib
from repro_torch.fl.methods import FedMethod, MethodContext
from repro_torch.models.module import (FlatLayout, drawing_on, host,
                                       tree_leaves, tree_map)


def resolve_compute_dtype(compute_dtype, method: FedMethod):
    """The engine's mixed-precision decision: ``"float32"``/None keeps
    the fp32 local phase (None); ``"bfloat16"`` returns torch.bfloat16
    for the LOCAL phase, with fp32 fusion. Refused for methods without
    ``FedMethod.mixed_precision``."""
    if compute_dtype in (None, "", "float32"):
        return None
    if compute_dtype != "bfloat16":
        raise ValueError(
            f"unknown compute_dtype {compute_dtype!r}; choose 'float32' "
            "or 'bfloat16'")
    compat_lib.check_bf16_support(method)
    return torch.bfloat16


def resolve_use_kernel(use_kernel: bool | None, mesh) -> bool:
    """The fusion route a round takes: the caller's choice (None = the
    port's default, the ``paired_fusion`` kernel), forced off on a mesh
    of more than one device, where the JAX package fuses by the tree
    reduction that lowers to one all-reduce (its rule; its own default
    is off on the CPU). ``mesh`` is a ``launch.mesh.Mesh`` or None (one
    device)."""
    use = True if use_kernel is None else bool(use_kernel)
    return use and (mesh is None or mesh.size == 1)


def _row_shard(cfg, mesh):
    """The fusion's ``RowShard`` of this rank on ``mesh``: its block of
    the cohort's rows (None on one process)."""
    if mesh is None or mesh.size == 1:
        return None
    from repro_torch.launch.collectives import all_gather_rows, all_reduce
    from repro_torch.launch.mesh import data_block
    n = cfg.cohort_size
    lo, hi = data_block(n, mesh)
    return fusion_lib.RowShard(
        lo, hi, n, lambda t: all_reduce(t, mesh, "data"),
        lambda t: all_gather_rows(t, mesh, "data", n))


def slot_shard(owner, mesh):
    """The ``RowShard`` of the slots this rank holds when ``owner`` (n,)
    names each slot's "data" coordinate (an async event's rows, which
    lie on the rank that computed them); None on one process."""
    if mesh is None or mesh.size == 1:
        return None
    from repro_torch.launch.collectives import all_gather_rows, all_reduce
    owner = np.asarray(owner, np.int64)
    n = len(owner)
    mine = tuple(int(i) for i in np.flatnonzero(
        owner == mesh.coord("data")))
    return fusion_lib.RowShard(
        mine[0] if mine else 0, mine[-1] + 1 if mine else 0, n,
        lambda t: all_reduce(t, mesh, "data"),
        lambda t: all_gather_rows(t, mesh, "data", n, owner), index=mine)


def resolve_local_unroll(cfg, local_steps: int) -> int:
    """``cfg.local_unroll`` clamped to the step count, as the JAX
    package resolves it. There it unrolls the local phase's
    ``lax.scan`` (batched dispatch, same step arithmetic); eager torch
    has no scan, so in the port the knob is validated and recorded and
    changes neither the result nor the dispatch."""
    return max(1, min(int(getattr(cfg, "local_unroll", 1)), local_steps))


@dataclasses.dataclass
class RoundEngine:
    """One federated round over cohort slots, on ``device``.

        state, new_global = engine.run_round(state, global_params,
                                             batches, weights=w,
                                             group_weights=gw)

    ``global_params`` is the flat (M,) global vector of ``layout``;
    ``batches`` a dict of (C, steps, B, ...) tensors on the device;
    ``state`` = {"server": tree, "clients": stacked (C, ...) rows}.
    ``weights``/``group_weights`` are per round: the sampled cohort's
    sample weights (and fed2 presence rows) in slot order.
    ``malicious`` is the tile's (host attacker row, round key) pair when
    a model-poisoning attack is configured, else None.

    On a mesh of ranks the engine holds cohort rows ``rows`` only:
    ``batches`` are those rows' (the runtime cuts them), while
    ``weights``/``group_weights``, the malicious row and the client
    state rows (in and out) cover the whole cohort."""
    cohort_size: int
    method: FedMethod
    layout: FlatLayout
    device: torch.device
    ctx: MethodContext
    cohort: Any                   # the reusable (C, M_d) buffer per dtype
    attack: Any = None            # model-poisoning Attack or None
    robust: Any = None            # reducing RobustRule or None
    pre_rule: Any = None          # pre-fuse RobustRule (norm_clip) or None
    codec: Any = None             # UplinkCodec or None
    compute_dtype: Any = None     # torch.bfloat16 or None (fp32)
    shadow: torch.Tensor | None = None  # bf16 (C, M) local-phase buffer
    #                                     of the whole tree
    rows: slice = slice(None)     # this rank's cohort rows (all: one
    #                               process)
    mesh: Any = None              # the placement make_round_engine got

    def _w32(self, w):
        if w is None:
            return None
        if isinstance(w, torch.Tensor):
            return w.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(w), dtype=torch.float32,
                               device=self.device)

    def _to_device(self, tree):
        return tree_map(lambda a: torch.as_tensor(a, device=self.device),
                        tree)

    def init_server_state(self, global_params) -> Any:
        return self.method.init_server_state(global_params, self.ctx)

    def init_client_row(self, global_params) -> Any:
        """ONE client's round-0 state as host (numpy) arrays."""
        return tree_map(host, self.method.init_client_state(global_params,
                                                            self.ctx))

    def round_ctx(self, weights=None, group_weights=None) -> MethodContext:
        """The engine's context with one round's (or fusion event's)
        sample weights and presence rows, as float32 device tensors."""
        return dataclasses.replace(self.ctx, weights=self._w32(weights),
                                   group_weights=self._w32(group_weights))

    def local_phase(self, clients_state, server_state, global_params,
                    batches, ctx, malicious=None) -> tuple:
        """The uplink half of a cohort tile: broadcast -> (cast down) ->
        local phase -> (poison) -> (cast back) -> (codec) -> (robust
        pre). ``clients_state`` must be on the device already. Returns
        (stacked, new client states): ``stacked`` is the engine's (C, M)
        cohort buffer (or a tensor made from it), which the next tile
        overwrites."""
        if self.compute_dtype is None:
            stacked = work = fusion_lib.broadcast_global(global_params,
                                                         self.cohort)
            gp_local = global_params
        else:
            work, gp_local = self._to_shadow(global_params)
            batches = {k: v.to(self.compute_dtype)
                       if v.is_floating_point() else v
                       for k, v in batches.items()}
            ctx = dataclasses.replace(ctx, layout=self.layout.raveled)
        work, new_clients = self.method.client_update(
            work, batches, gp_local, clients_state, server_state, ctx)
        if self.attack is not None and malicious is not None:
            row, key = malicious
            work = self.attack.poison_update(
                work, global_params, row[self.rows], key, self.layout,
                out=work, first=self.rows.start or 0)
        if self.compute_dtype is None:
            stacked = work
        else:                     # each leaf rounded into its own dtype
            stacked = self._from_shadow(work)
        if self.codec is not None:
            stacked = self.codec.roundtrip(stacked, global_params,
                                           self.layout)
        if self.pre_rule is not None:
            stacked = self.pre_rule.pre(stacked, global_params)
        return stacked, new_clients

    def _to_shadow(self, global_params) -> tuple:
        """The global written into every row of the compute-dtype shadow
        (one (C, M) buffer of the whole tree in tree order, the layout
        ``layout.raveled``), and the global itself on that layout in the
        compute dtype: the JAX package's cast of every float leaf."""
        if self.layout.raveled is self.layout:
            return (fusion_lib.broadcast_global(global_params, self.shadow),
                    global_params.to(self.compute_dtype))
        return (self.layout.ravel(global_params, out=self.shadow),
                self.layout.ravel(global_params,
                                  out=self.shadow.new_empty(
                                      self.layout.size)))

    def _from_shadow(self, work):
        """The trained shadow rows copied into the cohort buffers, each
        leaf rounded once into its storage dtype."""
        if self.layout.raveled is self.layout:
            return self.cohort.copy_(work)
        return self.layout.unravel(work, out=self.cohort)

    def _local_and_fuse(self, clients_state, server_state, global_params,
                        batches, weights, group_weights, malicious=None):
        """The shared cohort-tile body: ``local_phase``, then the fuse.
        Returns (clients_state on the device, new client states, fuse
        output, the round's context). On a mesh of ranks the local
        phase takes this rank's client rows, and the new rows are
        gathered into the whole cohort's."""
        ctx = self.round_ctx(weights, group_weights)
        clients_state = self._to_device(clients_state)
        shard = self.ctx.shard
        mine = (clients_state if shard is None else
                tree_map(lambda a: a[self.rows], clients_state))
        stacked, new_clients = self.local_phase(
            mine, server_state, global_params, batches, ctx, malicious)
        if shard is not None:
            new_clients = tree_map(shard.gather, new_clients)
        fused = self.method.fuse(stacked, global_params, ctx)
        return clients_state, new_clients, fused, ctx

    def run_round(self, state, global_params, batches, weights=None,
                  group_weights=None, malicious=None) -> tuple:
        """One whole round. For host-fusion methods the round ends in
        ``host_fuse`` with the participants' raw ``weights``."""
        state, out = self.device_round(state, global_params, batches,
                                       weights, group_weights, malicious)
        if self.method.host_fusion:
            out = self.host_fuse(out, weights)
        return state, out

    def device_round(self, state, global_params, batches, weights=None,
                     group_weights=None, malicious=None) -> tuple:
        """The round's device program: ``run_round`` up to ``host_fuse``
        (a host-fusion method's ends at the stacked (C, M) params, as the
        JAX package's jitted ``round_fn`` does)."""
        old_clients, new_clients, fused, ctx = self._local_and_fuse(
            state["clients"], state["server"], global_params, batches,
            weights, group_weights, malicious)
        new_server, out = self.method.server_update(
            state["server"], old_clients, new_clients, global_params,
            fused, ctx)
        return {"server": new_server, "clients": new_clients}, out

    def run_tile(self, client_states, server_state, global_params,
                 batches, weights=None, group_weights=None,
                 malicious=None) -> tuple:
        """One cohort tile of a tiled round: local phase + fuse only.
        Returns (new_client_states, fuse output)."""
        _, new_clients, fused, _ = self._local_and_fuse(
            client_states, server_state, global_params, batches, weights,
            group_weights, malicious)
        return new_clients, fused

    def finish_round(self, server_state, global_params, fused) -> tuple:
        """The server step of a tiled round, applied once to the combined
        fusion result (``cohort_tiling`` methods only)."""
        return self.method.server_update(server_state, (), (),
                                         global_params, fused, self.ctx)

    def host_fuse(self, stacked, weights=None):
        """Host-side fusion completion (host_fusion methods) of the
        (n, M) stacked params with the participants' raw weights."""
        ctx = (self.ctx if weights is None
               else dataclasses.replace(self.ctx, raw_weights=weights))
        return self.method.host_fuse(stacked, ctx)


def make_round_engine(task, cfg, params_like, *, device,
                      use_kernel: bool | None = None,
                      use_local_kernel: bool = False,
                      method: FedMethod | None = None,
                      grad_chunk: int | None = None,
                      mesh=None) -> RoundEngine:
    """Build the engine for (task, cfg, method) at width cfg.cohort_size.

    params_like: a params tree (its structure and leaf shapes define the
    flat layout and the group-axis tree).
    use_kernel: fuse through the ``paired_fusion`` kernel (None = yes,
    on every device: on CPU tensors its wrapper computes the plain
    version).
    use_local_kernel: run the local optimizer tail through the
    ``local_step`` kernel; a no-op for methods without
    ``fused_local_step``.
    grad_chunk: clients per vmapped gradient call (None: the cohort;
    ``run_federated``'s).
    mesh: None, a one-device mesh, or this rank's ``launch/mesh.RankMesh``
    (the cohort split over its "data" ranks; see the module docstring).

    cfg's feature knobs (each off by default) are resolved here, so
    every construction path hits the same refusals (``compat.validate``):
    ``attack`` (model-poisoning attacks only enter the round; data
    poisoning happens at batch packing), ``robust`` (identity-shortcut
    parameters drop the rule; a reducing rule turns the fusion kernel
    off, as the JAX package does), ``codec``, ``compute_dtype`` and
    ``local_unroll``. Each of them runs on a params tree that mixes
    dtypes, segment by segment and each leaf in its dtype (a bf16
    ``compute_dtype`` through one bf16 shadow of the whole tree)."""
    meth = method if method is not None else methods_lib.get(cfg.method)
    compat_lib.validate(cfg, meth)
    if grad_chunk is not None and (not isinstance(grad_chunk, int)
                                   or isinstance(grad_chunk, bool)
                                   or grad_chunk <= 0):
        raise ValueError(f"grad_chunk must be None or a positive int "
                         f"(clients per vmapped gradient call), got "
                         f"{grad_chunk!r}")
    if meth.host_fusion and (
            type(meth).init_server_state is not FedMethod.init_server_state
            or type(meth).server_update is not FedMethod.server_update):
        raise ValueError(
            f"{meth.name}: host_fusion methods end the device round at the "
            "stacked params — server_update/init_server_state never run; "
            "fold server-side work into host_fuse instead")
    shard = _row_shard(cfg, mesh)
    layout = FlatLayout(params_like)
    ga = None
    if meth.uses_groups and task.group_axes_fn is not None:
        ga = task.group_axes_fn(params_like)
    use_kernel = resolve_use_kernel(use_kernel, mesh)
    attack = None
    if getattr(cfg, "attack", None):
        atk = attacks_lib.parse_attack(cfg.attack).build()
        if atk.model_poisoning:
            attack = atk
    rule = None
    if getattr(cfg, "robust", None):
        rule = robust_lib.parse_robust(cfg.robust)
        if not rule.active:
            rule = None
        if rule is not None and rule.reduces:
            use_kernel = False   # sort-based reductions have no kernel
    cdtype = resolve_compute_dtype(getattr(cfg, "compute_dtype", None),
                                   meth)
    codec = (codec_lib.parse_codec(cfg.codec)
             if getattr(cfg, "codec", None) else None)
    steps = cfg.local_epochs * cfg.steps_per_epoch
    ctx = MethodContext(
        task=task, cfg=cfg, population=cfg.population,
        cohort_size=cfg.cohort_size, local_steps=steps,
        opt=meth.local_opt(cfg), layout=layout, weights=None,
        raw_weights=None, group_axes=ga, group_weights=None,
        use_kernel=use_kernel,
        robust=rule if rule is not None and rule.reduces else None,
        local_unroll=resolve_local_unroll(cfg, steps),
        use_local_kernel=(bool(use_local_kernel)
                          and compat_lib.supports(meth, "kernel")),
        grad_chunk=grad_chunk, shard=shard)
    meth.check(ctx)
    device = torch.device(device)
    lo, hi = (0, cfg.cohort_size) if shard is None else (shard.lo, shard.hi)
    c = hi - lo                   # the rows this process holds
    if ctx.use_local_kernel and cdtype is None and \
            layout.raveled is not layout:
        ctx = dataclasses.replace(ctx, ravel_buffer=layout.raveled.alloc(
            (c,), device=device))
    return RoundEngine(
        cohort_size=cfg.cohort_size, method=meth, layout=layout,
        device=device, ctx=ctx, rows=slice(lo, hi), mesh=mesh,
        cohort=layout.alloc((c,), device=device),
        attack=attack,
        robust=ctx.robust,
        pre_rule=rule if rule is not None and rule.has_pre else None,
        codec=codec, compute_dtype=cdtype,
        shadow=(None if cdtype is None else layout.raveled.alloc(
            (c,), device=device, dtype=cdtype)))


# ---------------------------------------------------------------------------
# Dry-run lowering: a device program and its arguments on meta
# ---------------------------------------------------------------------------


def replicated(tree):
    """Placement specs of ``tree``: every dimension replicated."""
    return tree_map(lambda t: (None,) * t.dim(), tree)


def client_sharded(tree):
    """Placement specs of ``tree``: the leading (client) axis on mesh
    axis "data", everything else replicated (the JAX package's
    ``_client_sharding``)."""
    return tree_map(lambda t: ("data",) + (None,) * (t.dim() - 1), tree)


def param_shapes(task):
    """The task's parameter tree on ``meta``: shapes and dtypes, nothing
    drawn (the JAX package's ``jax.eval_shape(task.init_fn, key)``)."""
    with drawing_on("meta"):
        tree = task.init_fn(torch.Generator())
    return tree_map(lambda t: t.to("meta"), tree)


def stacked_param_bytes(task, n_clients: int) -> int:
    """Bytes of ``n_clients`` stacked copies of the task's parameters:
    what a host-side fusion (fedma) gathers off the device every
    round."""
    return n_clients * sum(t.numel() * t.element_size()
                           for t in tree_leaves(param_shapes(task)))


@dataclasses.dataclass
class LoweredStep:
    """One device program of the engine and its arguments on ``meta``,
    each argument beside its placement: what the JAX package hands
    ``jax.jit(...).lower`` (its ``lower_round``, ``lower_tier_tile`` and
    ``lower_async_event``). Nothing is allocated.

    ``call(*args)`` runs the program (on meta, the plain routes: no
    kernel accepts a meta tensor). ``specs`` place each argument on a
    mesh (a spec per tensor, as ``launch/sharding.py`` writes them; None
    for an argument the program does not take). ``reads[i]`` says
    whether the program reads argument i: jit drops an argument its
    program never reads, and XLA counts none of its bytes. ``outs`` and
    ``out_specs`` are the outputs' shapes and placement, ``out_leaves``
    the number of leaves of the JAX package's output tree (a flat (M,)
    or (C, M) tensor stands for one leaf per layout slot). ``use_kernel``
    is the fusion route the program takes on the card
    (``resolve_use_kernel``, off under a reducing robust rule); ``engine``
    and ``cfg`` are the meta engine and the config it was built from;
    ``rank`` rank 0's program of the same case on a mesh of more than
    one device (None on one device)."""
    call: Any
    args: tuple
    specs: tuple
    reads: tuple
    outs: tuple
    out_specs: tuple
    out_leaves: int
    use_kernel: bool
    engine: Any
    cfg: Any
    rank: "RankStep | None" = None


@dataclasses.dataclass
class RankStep:
    """What rank 0 of a mesh runs of a lowered step, on ``meta``:
    ``call(*args)``, the program of an engine built on ``mesh``, a dry
    mesh (``launch/mesh.make_dry_rank_mesh``), so that it takes its rank
    routes (its block of the cohort's rows, the row shard's all-reduce
    and all-gathers), on rank 0's arguments (its block of the batches;
    the weights, presence rows and client rows of the whole cohort, as a
    rank gets them)."""
    call: Any
    args: tuple
    mesh: Any

    def counts(self):
        """The program once: the collectives it issued
        (``launch/collectives.Counts``)."""
        self.mesh.counts.reset()
        self.call(*self.args)
        return self.mesh.counts


def dry_rank0(mesh):
    """Rank 0 of ``mesh`` (a ``launch.mesh.Mesh``) as a dry mesh on
    ``meta``, or None for None or one device."""
    if mesh is None or mesh.size == 1:
        return None
    from repro_torch.launch.mesh import make_dry_rank_mesh
    return make_dry_rank_mesh(mesh.sizes, 0, device="meta")


def reference_leaves(tree, layout: FlatLayout) -> int:
    """Leaves of the JAX package's tree that ``tree`` stands for: one
    per layout slot for each flat parameter-shaped tensor (last
    dimension M), one for any other tensor."""
    return sum(len(layout.slots) if t.shape[-1:] == (layout.size,) else 1
               for t in tree_leaves(tree))


def meta_batches(batch_elems: dict, n: int, steps: int) -> dict:
    """(n, steps, *shape) meta tensors of ``batch_elems``' {name: (shape,
    dtype)} per-sample specs."""
    return {name: torch.empty((n, steps) + tuple(shape), dtype=dtype,
                              device="meta")
            for name, (shape, dtype) in batch_elems.items()}


def lower_round(task, cfg, mesh, batch_elems: dict, *, local_steps: int,
                use_kernel: bool | None = None) -> LoweredStep:
    """One whole round on ``meta``: the JAX package's ``lower_round``.

    batch_elems: per-sample batch element specs without the leading
    (cohort, steps) axes, e.g. ``{"images": ((B, 32, 32, 3),
    torch.float32), "labels": ((B,), torch.int32)}``. cfg's step counts
    are overridden (``local_epochs=1, steps_per_epoch=local_steps``) so
    that the methods' step-dependent numerics (scaffold's K*lr,
    fednova's tau) see the steps the round runs.

    The arguments, in the reference's order: the state ({"server",
    "clients"}), the flat global params (M,), the batches (C, steps,
    ...), the weights w (C,), the presence rows gw (C, G) for
    ``uses_groups`` methods (else None), and, when ``cfg.attack``
    poisons the model, the malicious row (C,) of the first cohort's
    attackers and the round key (host values the round reads on the
    host; else None). The round reads every argument but w in a
    host-fusion round (its device program ends at the stacked params)
    and the key of an attack that draws no noise. ``mesh`` (a
    ``launch.mesh.Mesh`` or None) sets the recorded route and, on more
    than one device, adds ``rank``: the same round as rank 0 runs it."""
    cfg = dataclasses.replace(cfg, local_epochs=1,
                              steps_per_epoch=local_steps)
    engine, call, args = _round_program(task, cfg, batch_elems, local_steps)
    rank, dry = None, dry_rank0(mesh)
    if dry is not None:
        rank = RankStep(*_round_program(task, cfg, batch_elems,
                                        local_steps, dry)[1:], dry)
    meth, layout = engine.method, engine.layout
    state, gp, batches, w, gw, row, key = args
    state_specs = {"server": replicated(state["server"]),
                   "clients": client_sharded(state["clients"])}
    specs = (state_specs, replicated(gp), client_sharded(batches),
             replicated(w), None if gw is None else replicated(gw),
             None if row is None else replicated(row),
             None if key is None else replicated(key))
    reads = (True, True, True, not meth.host_fusion, True, True,
             engine.attack is not None and engine.attack.needs_rng)
    if meth.host_fusion:
        out, out_spec = engine.cohort, ("data", None)
    else:
        out, out_spec = gp, (None,)
    outs = (state, out)
    return LoweredStep(
        call=call, args=args, specs=specs, reads=reads, outs=outs,
        out_specs=(state_specs, out_spec),
        out_leaves=reference_leaves(outs, layout),
        use_kernel=(resolve_use_kernel(use_kernel, mesh)
                    and engine.robust is None),
        engine=engine, cfg=cfg, rank=rank)


def _round_program(task, cfg, batch_elems: dict, local_steps: int,
                   mesh=None) -> tuple:
    """``lower_round``'s engine on ``meta`` (on ``mesh``: None, or a dry
    rank mesh), its device program and the program's arguments: the
    batches of the engine's rows, everything else the whole cohort's.
    (engine, call, args)."""
    n = cfg.cohort_size
    engine = make_round_engine(task, cfg, param_shapes(task), device="meta",
                               use_kernel=False, use_local_kernel=False,
                               mesh=mesh)
    meth, layout = engine.method, engine.layout
    gp = layout.alloc(device="meta")
    one = meth.init_client_state(gp, engine.ctx)
    state = {"server": meth.init_server_state(gp, engine.ctx),
             "clients": tree_map(lambda t: t.new_empty((n,) + t.shape),
                                 one)}
    batches = meta_batches(batch_elems, engine.rows.stop - engine.rows.start,
                           local_steps)
    w = torch.empty((n,), dtype=torch.float32, device="meta")
    gw = row = key = None
    if meth.uses_groups:
        g = next(ga.n_groups for ga in layout.leaves(engine.ctx.group_axes)
                 if ga is not None)
        gw = torch.empty((n, g), dtype=torch.float32, device="meta")
    if engine.attack is not None:
        row = torch.as_tensor(attacks_lib.assign_attackers(
            cfg.attack_fraction, n, seed=cfg.seed).astype(np.float32))
        key = torch.tensor(attacks_lib.round_key(cfg.seed, 0),
                           dtype=torch.int32)

    def call(state, gp, batches, w, gw, row, key):
        mal = None if row is None else (row, key)
        return engine.device_round(state, gp, batches, w, gw, mal)

    return engine, call, (state, gp, batches, w, gw, row, key)


# ---------------------------------------------------------------------------
# Which arguments a program reads: a data-flow trace
# ---------------------------------------------------------------------------

# ops whose outputs take only their inputs' shape, dtype and device
_SHAPE_ONLY = frozenset({"empty_like", "zeros_like", "ones_like",
                         "full_like", "new_empty", "new_zeros", "new_ones",
                         "new_full", "empty_strided"})


def traced_reads(call, args) -> tuple:
    """``call(*args)`` once under a dispatch mode that follows data
    through every operator (views and in-place writes included, by
    storage): (outputs, reads), ``reads[i]`` True when an output
    depends on a tensor of ``args[i]``. Host reads (``.numpy()``, a
    Python branch on a value) are not operators and are not seen."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    def key(t):
        return t.untyped_storage()._cdata

    class Trace(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.src = {}           # storage -> argument indices

        def __torch_dispatch__(self, func, types, args_=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args_, **kwargs)
            src = set()
            if func.overloadpacket.__name__ not in _SHAPE_ONLY:
                for t in tree_flatten((args_, kwargs))[0]:
                    if isinstance(t, torch.Tensor):
                        src |= self.src.get(key(t), set())
            schema = func._schema
            written = []
            for i, a in enumerate(schema.arguments):
                if a.alias_info is not None and a.alias_info.is_write:
                    v = args_[i] if i < len(args_) else kwargs.get(a.name)
                    written += [t for t in tree_flatten(v)[0]
                                if isinstance(t, torch.Tensor)]
            aliased = any(r.alias_info is not None for r in schema.returns)
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    k = key(t)
                    self.src[k] = (self.src.get(k, set()) | src if aliased
                                   else set(src))
            for t in written:
                self.src[key(t)] = self.src.get(key(t), set()) | src
            return out

    trace = Trace()
    for i, a in enumerate(args):
        for t in tree_leaves(a):
            if isinstance(t, torch.Tensor):
                trace.src.setdefault(key(t), set()).add(i)
    with trace:
        out = call(*args)
    seen = set()
    for t in tree_leaves(out):
        if isinstance(t, torch.Tensor):
            seen |= trace.src.get(key(t), set())
    return out, tuple(i in seen for i in range(len(args)))
