"""Buffered-async federation (FedBuff-style).

The port of the JAX package's ``fl/async_engine.py``. The sync runtime
advances in lockstep rounds, whose clock is the slowest sampled client.
This module makes the FUSION EVENT the unit of progress: each
dispatched client trains from the global version current at its
dispatch, its update arrives after a latency drawn from a
seed-deterministic heavy-tail trace, arrivals land in a bounded buffer,
and the server fuses every ``buffer_k`` arrivals, each update weighted
by its sample weight times a staleness discount (``constant`` or
``polynomial(a)``), which ``FedMethod.fuse`` renormalizes over the
event.

The two device programs are the sync engine's tile (fl/engine.py)
split at the fusion boundary, built from the same ``RoundEngine``:

    local_fn(global_v, batches) -> (C, M) rows     ``local_phase``
    event_fn(server, global, rows_K, w_eff)        ``method.fuse`` +
                -> (server, new global)            ``server_update``

A dispatch group (the clients dispatched from the same global version)
runs as ONE padded cohort tile (``runtime.pad_tile_inputs``). The
tile's rows live in the engine's (C, M_d) cohort buffers (one per leaf
dtype), which the next tile overwrites, so every arrival keeps a copy
of its row; an event copies its ``buffer_k`` rows into a (K, M_d)
buffer per dtype segment, of the cohort's row stride, and fuses each in
one ``paired_fusion`` launch (two for a bf16 Mamba-2 with its fp32
leaves). A global version
that a pending dispatch still needs is kept by reference: globals are
fresh tensors, never written in place.

Correctness anchor: with ``buffer_k == cohort_size``, a zero-latency
trace and the constant staleness weight, every dispatch wave IS one
sync cohort (same sampler stream, batch rng, programs), so the async
run equals ``mode="sync"`` bit for bit for every async-eligible method.

Eligibility (``compat.check_async_support``): affine-fuse,
client-stateless, device-fused methods; scaffold, fedma and
presence-weighted fed2 refuse. The clients are stateless, so the
population's store holds only the side arrays (``store='mmap'`` maps
them from disk).

On a mesh of ranks (``mesh=``, a ``launch.mesh.RankMesh``) every rank
runs the same event loop: the same sampler and batch draws, the same
latency trace, so the same dispatches, arrivals and staleness. A
dispatch group's padded tile is split over "data" as a sync cohort is
(``engine.local_phase`` on this rank's block of rows), and each
dispatch's row stays on the rank that computed it; every rank records
which rank holds each row (``_Dispatch.holder``). An event fuses each
rank's weighted partial sum over the rows it holds (their slots of the
K-row buffer: ``engine.slot_shard``) with ONE all-reduce per dtype
segment, and every rank takes the server step, so every rank ends each
event with the same global. No client state moves: the methods are
client-stateless. With ``buffer_k == cohort_size``, zero latency and
the constant discount an event's rows are a sync cohort's blocks, and
the run equals the sync run on the same ranks to the bit.
"""
from __future__ import annotations

import dataclasses
import functools
import re
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.fl import evaluation as evaluation_lib
from repro_torch.fl import methods as methods_lib
from repro_torch.fl import population as population_lib
from repro_torch.fl.compat import check_async_support
from repro_torch.fl.methods import FedMethod
from repro_torch.fl.population import Population
from repro_torch.models.module import tree_map

# the trace rng stream id: like TierPlan's (seed + 7331), the latency
# draws use their own substream, so the run's sampler/batch rng
# (cfg.seed) stays untouched (the sync bit-identity needs it)
_TRACE_STREAM = 7919


# ---------------------------------------------------------------------------
# Staleness discounts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StalenessPolicy:
    """Weight discount d(s) for an update that trained from a global
    ``s`` fusion events behind the one it fuses into: ``constant``
    d(s) = 1 (pure FedBuff buffering); ``polynomial(a)``
    d(s) = (1 + s)^-a."""
    kind: str                  # "constant" | "polynomial"
    a: float = 0.0

    def discount(self, staleness) -> float:
        if self.kind == "constant":
            return 1.0
        return float((1.0 + float(staleness)) ** (-self.a))

    @property
    def spec(self) -> str:
        return ("constant" if self.kind == "constant"
                else f"polynomial({self.a:g})")


def parse_staleness(spec) -> StalenessPolicy:
    """``"constant"`` | ``"polynomial(a)"`` (a >= 0) -> StalenessPolicy.
    A StalenessPolicy passes through unchanged."""
    if isinstance(spec, StalenessPolicy):
        return spec
    if not isinstance(spec, str):
        raise ValueError(
            f"staleness spec must be a string, got {type(spec).__name__}")
    s = spec.strip()
    if s == "constant":
        return StalenessPolicy("constant")
    m = re.fullmatch(r"polynomial\(([^)]+)\)", s)
    if m:
        try:
            a = float(m.group(1))
        except ValueError:
            a = -1.0
        if a >= 0.0:
            return StalenessPolicy("polynomial", a)
    raise ValueError(
        f"bad staleness spec {spec!r}: expected 'constant' or "
        "'polynomial(a)' with a >= 0 (e.g. 'polynomial(0.5)')")


def effective_weights(weights, staleness, policy: StalenessPolicy, *,
                      normalize: bool = False) -> np.ndarray:
    """One fusion event's weights, float64: sample weight x staleness
    discount, elementwise. The raw products are what ``event_fn``
    takes (``FedMethod.fuse`` renormalizes over the event);
    ``normalize=True`` returns the normalized form."""
    w = np.asarray(weights, np.float64)
    s = np.asarray(staleness)
    if w.shape != s.shape:
        raise ValueError(
            f"weights {w.shape} and staleness {s.shape} must align")
    d = np.array([policy.discount(x) for x in s.ravel()]).reshape(s.shape)
    out = w * d
    if not normalize:
        return out
    tot = out.sum()
    if tot <= 0:
        raise ValueError("effective weights sum to zero: every update in "
                         "the event has zero weight")
    return out / tot


# ---------------------------------------------------------------------------
# Seed-deterministic heavy-tail latency traces
# ---------------------------------------------------------------------------


def parse_latency(spec: str) -> tuple[str, float]:
    """``"zero"`` | ``"pareto(a)"`` | ``"lognormal(sigma)"`` ->
    (kind, parameter)."""
    if not isinstance(spec, str):
        raise ValueError(
            f"latency spec must be a string, got {type(spec).__name__}")
    s = spec.strip()
    if s == "zero":
        return "zero", 0.0
    m = re.fullmatch(r"(pareto|lognormal)\(([^)]+)\)", s)
    if m:
        try:
            a = float(m.group(2))
        except ValueError:
            a = -1.0
        if a > 0.0:
            return m.group(1), a
    raise ValueError(
        f"bad latency spec {spec!r}: expected 'zero', 'pareto(a)' or "
        "'lognormal(sigma)' with a positive parameter "
        "(e.g. 'pareto(1.5)')")


@dataclasses.dataclass(frozen=True)
class LatencyTrace:
    """Per-(client, dispatch) training latencies, fully determined by
    (spec, seed, population): each client's persistent base rate from
    the heavy-tail law, times a lognormal jitter keyed on (client, seq).
    All draws come from numpy ``default_rng`` substreams under
    ``_TRACE_STREAM``, as the reference draws them."""
    spec: str
    seed: int
    population: int
    rates: np.ndarray          # (population,) per-client base latency

    @classmethod
    def make(cls, spec: str, *, population: int,
             seed: int) -> "LatencyTrace":
        kind, a = parse_latency(spec)
        if kind == "zero":
            rates = np.zeros(population)
        else:
            r = np.random.default_rng([seed, _TRACE_STREAM])
            if kind == "pareto":
                rates = 1.0 + r.pareto(a, size=population)
            else:
                rates = r.lognormal(0.0, a, size=population)
        return cls(spec=spec, seed=seed, population=population,
                   rates=rates)

    @property
    def zero(self) -> bool:
        return parse_latency(self.spec)[0] == "zero"

    def latency(self, client: int, seq: int) -> float:
        """Training latency of dispatch ``seq`` (the global dispatch
        counter) to ``client``."""
        if self.zero:
            return 0.0
        jitter = np.random.default_rng(
            [self.seed, _TRACE_STREAM, int(client), int(seq)]
        ).lognormal(0.0, 0.25)
        return float(self.rates[int(client)] * jitter)


# ---------------------------------------------------------------------------
# The two programs: cohort-width local tiles + buffer-width events
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AsyncEngine:
    """The sync ``RoundEngine`` split at the fusion boundary, plus the
    event buffer: a (K, M_d) buffer per dtype segment, of the cohort's
    row stride (which the ``paired_fusion`` kernel's vector loads
    need)."""
    cohort_size: int
    buffer_k: int
    method: FedMethod
    engine: Any               # the RoundEngine at cohort_size
    buffer: Any               # (K, M_d) event rows per dtype segment

    @property
    def mesh(self):
        """This rank's ``RankMesh`` (the engine's), or None."""
        return self.engine.mesh

    @property
    def slot_owner(self) -> np.ndarray:
        """(cohort_size,) the "data" coordinate computing each slot of a
        dispatch group's tile (all 0 in one process)."""
        from repro_torch.launch.mesh import data_owner
        return data_owner(self.cohort_size, self.mesh)

    @property
    def layout(self):
        return self.engine.layout

    @property
    def device(self):
        return self.engine.device

    def init_server_state(self, global_params):
        return self.engine.init_server_state(global_params)

    def local_fn(self, global_params, batches) -> torch.Tensor:
        """One dispatch group's padded cohort tile: broadcast + the local
        phase, over this rank's rows ``engine.rows`` (all of them in one
        process; ``batches`` are those rows'). Returns the engine's
        cohort buffer, which the next tile overwrites."""
        stacked, _ = self.engine.local_phase((), (), global_params,
                                             batches, self.engine.ctx)
        return stacked

    def event_fn(self, server_state, global_params, rows, weights,
                 shard=None):
        """Fuse one event's (K, M) ``rows`` under the raw effective
        ``weights`` (K,) and apply the server step: (server_state, new
        global). ``shard``: on a mesh of ranks, the ``RowShard`` of the
        event's slots this rank holds, ``rows`` those slots' rows."""
        ctx = dataclasses.replace(self.engine.round_ctx(weights),
                                  shard=shard)
        fused = self.method.fuse(rows, global_params, ctx)
        return self.method.server_update(server_state, (), (),
                                         global_params, fused, ctx)


def make_async_engine(task, cfg, params_like, *, device,
                      use_kernel: bool | None = None,
                      use_local_kernel: bool = False,
                      method: FedMethod | None = None,
                      grad_chunk: int | None = None,
                      mesh=None) -> AsyncEngine:
    """The async engine for (task, cfg, method): the sync engine at
    ``cfg.cohort_size`` and a ``buffer_k``-row event buffer. ``mesh``:
    None, a one-device mesh, or this rank's ``RankMesh`` (the tiles'
    rows split over "data", each event fused over the ranks; a rank's
    rows of an event fill the front of its buffer)."""
    from repro_torch.fl.engine import make_round_engine

    meth = method if method is not None else methods_lib.get(cfg.method)
    check_async_support(meth)
    engine = make_round_engine(task, cfg, params_like, device=device,
                               use_kernel=use_kernel,
                               use_local_kernel=use_local_kernel,
                               method=meth, grad_chunk=grad_chunk,
                               mesh=mesh)
    k = cfg.buffer_k if cfg.buffer_k is not None else cfg.cohort_size
    return AsyncEngine(cohort_size=cfg.cohort_size, buffer_k=k,
                       method=meth, engine=engine,
                       buffer=engine.layout.alloc((k,), device=device))


def lower_async_event(task, cfg, mesh, *, use_kernel=None):
    """One fusion event on ``meta``, the async mode's own program (its
    local tiles are the sync engine's): the JAX package's
    ``lower_async_event``. Its arguments: the server state, the flat
    global params, the (K, M) event rows and the weights w (K,). The rows
    lie on mesh axis "data" only when K divides it (the reference's
    ``_shardable``), the rest replicated. Which arguments the event
    reads comes from running it once on meta under
    ``engine.traced_reads`` (it costs a fuse): fed2's and fedavg's
    events never read the global params. Returns a LoweredStep; on a
    mesh of more than one device its ``rank`` is rank 0's event: the
    event's K slots are the first K of a dispatch group's tile, each row
    on the rank that computed it (``slot_shard`` of ``slot_owner``), the
    event fused over the ranks."""
    from repro_torch.fl.engine import (LoweredStep, RankStep,
                                       client_sharded, dry_rank0,
                                       param_shapes, reference_leaves,
                                       replicated, resolve_use_kernel,
                                       slot_shard, traced_reads)

    engine = make_async_engine(task, cfg, param_shapes(task),
                               device="meta", use_kernel=False,
                               use_local_kernel=False)
    k, layout = engine.buffer_k, engine.layout
    gp = layout.alloc(device="meta")
    server = engine.init_server_state(gp)
    w = torch.empty((k,), dtype=torch.float32, device="meta")
    rows = engine.buffer
    shard = mesh is not None and k % mesh.shape["data"] == 0
    args = (server, gp, rows, w)
    _, reads = traced_reads(engine.event_fn, args)
    rank, dry = None, dry_rank0(mesh)
    if dry is not None:
        r_engine = make_async_engine(task, cfg, param_shapes(task),
                                     device="meta", use_kernel=False,
                                     use_local_kernel=False, mesh=dry)
        slots = slot_shard(r_engine.slot_owner[:k], dry)
        mine = tree_map(lambda b: b[:len(slots.index)], r_engine.buffer)
        rank = RankStep(functools.partial(r_engine.event_fn, shard=slots),
                        (server, gp, mine, w), dry)
    outs = (server, gp)
    return LoweredStep(
        call=engine.event_fn, args=args,
        specs=(replicated(server), replicated(gp),
               client_sharded(rows) if shard else replicated(rows),
               replicated(w)),
        reads=reads, outs=outs, out_specs=(replicated(server), (None,)),
        out_leaves=reference_leaves(outs, layout),
        use_kernel=resolve_use_kernel(use_kernel, mesh), engine=engine,
        cfg=cfg, rank=rank)


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Dispatch:
    """One in-flight client update: dispatched at ``version`` (it trains
    from that global), finishing at simulated time ``t_finish``. The
    update row is computed lazily: all same-version dispatches run as
    one padded cohort tile when the first of them must arrive."""
    seq: int
    client: int
    version: int
    t_start: float
    t_finish: float
    update: torch.Tensor | None = None   # on the rank that holds it
    weight: float = 0.0
    holder: int | None = None   # "data" coordinate of the rank holding
    #                             the row; None until computed


class AsyncFederation:
    """The buffered-async event loop.

    Exactly ``cohort_size`` clients are in flight. Clients are drawn
    wave by wave from the sampler (one ``sample()`` a wave, popped one
    id at a time as slots free), each dispatch tagged with the current
    global version and a finish time from the latency trace. Arrivals
    are processed in (finish time, dispatch seq) order; every arrival
    enters the buffer, and the buffer flushes as ONE fusion event the
    moment it holds ``buffer_k`` updates. Slots freed by a time step's
    arrivals re-dispatch after its fusions settle, so new work trains
    from the newest global.

    The run ends after ``cfg.rounds`` fusion events. Bookkeeping:
    ``fused_seqs`` (every accepted update fused exactly once),
    ``max_buffer_seen`` (the bound), ``local_tiles``, and the per-event
    ``events`` records (participants, staleness, sim time)."""

    def __init__(self, engine: AsyncEngine, pop: Population, sampler, cfg,
                 get_batch, n_steps: int, rng: np.random.Generator,
                 trace: LatencyTrace, policy: StalenessPolicy, *,
                 uniform_weights: bool = False):
        self.engine = engine
        self.pop = pop
        self.sampler = sampler
        self.cfg = cfg
        self.get_batch = get_batch
        self.n_steps = n_steps
        self.rng = rng
        self.trace = trace
        self.policy = policy
        self.uniform_weights = uniform_weights
        self.version = 0
        self.seq = 0
        self.wave_idx = 0
        self.wave_queue: list[int] = []
        self.pending: list[_Dispatch] = []
        self.buffer: list[_Dispatch] = []
        self.free_at = [0.0] * engine.cohort_size
        self.old_globals: dict[int, torch.Tensor] = {}
        self.events: list[dict] = []
        self.fused_seqs: list[list[int]] = []
        self.max_buffer_seen = 0
        self.local_tiles = 0

    def _fill_slots(self):
        c = self.engine.cohort_size
        while len(self.pending) < c:
            if not self.wave_queue:
                ids = self.sampler.sample(self.wave_idx,
                                          self.cfg.population, c, self.rng,
                                          weights=self.pop.weights)
                self.wave_queue = [int(i) for i in ids]
                self.wave_idx += 1
            client = self.wave_queue.pop(0)
            t_start = self.free_at.pop(self.free_at.index(
                min(self.free_at)))
            lat = self.trace.latency(client, self.seq)
            self.pending.append(_Dispatch(
                seq=self.seq, client=client, version=self.version,
                t_start=t_start, t_finish=t_start + lat))
            self.seq += 1

    def _compute_updates(self, arrivals, global_params):
        """Run the padded cohort tile of every global version the
        arrivals still need, together with the other pending dispatches
        of that version, so a version's dispatch group costs ONE tile.
        Each dispatch keeps a copy of its row (the next tile overwrites
        the cohort buffer) on the rank that computed it, and every rank
        records that rank."""
        from repro_torch.fl.runtime import device_batches, pad_tile_inputs

        rows = self.engine.engine.rows
        owner = self.engine.slot_owner
        for v in sorted({d.version for d in arrivals if d.holder is None}):
            group = sorted(
                [d for d in list(arrivals) + self.pending
                 if d.version == v and d.holder is None],
                key=lambda d: d.seq)
            _, w, _, batches = pad_tile_inputs(
                self.pop, [d.client for d in group],
                self.engine.cohort_size, self.get_batch, self.n_steps,
                self.cfg.batch_size, self.rng,
                uniform_weights=self.uniform_weights)
            gp_v = (global_params if v == self.version
                    else self.old_globals[v])
            stacked = self.engine.local_fn(
                gp_v, device_batches(batches, self.engine.device, rows))
            self.local_tiles += 1
            for i, d in enumerate(group):
                d.holder = int(owner[i])
                d.weight = float(w[i])
                if rows.start <= i < rows.stop:
                    d.update = tree_map(
                        lambda x, i=i - rows.start: x[i].clone(), stacked)
            self.old_globals.pop(v, None)

    def _fuse(self, server_state, global_params):
        from repro_torch.fl.engine import slot_shard

        staleness = [self.version - d.version for d in self.buffer]
        w_eff = effective_weights([d.weight for d in self.buffer],
                                  staleness, self.policy)
        shard = slot_shard([d.holder for d in self.buffer],
                           self.engine.mesh)
        mine = [d for d in self.buffer if d.update is not None]
        rows = self.engine.buffer
        if shard is not None:         # this rank's rows, in slot order
            rows = tree_map(lambda b: b[:len(mine)], rows)
        for i, d in enumerate(mine):
            tree_map(lambda r, u, i=i: r[i].copy_(u), rows, d.update)
        args = (server_state, global_params, rows, w_eff)
        # one process calls the event program with its four arguments
        server_state, new_global = (
            self.engine.event_fn(*args) if shard is None
            else self.engine.event_fn(*args, shard=shard))
        self.fused_seqs.append([d.seq for d in self.buffer])
        self.events.append({
            "version": self.version,
            "participants": np.asarray([d.client for d in self.buffer],
                                       np.int64),
            "staleness": staleness,
            "sim_time": max(d.t_finish for d in self.buffer),
        })
        # the outgoing global stays live only while a pending dispatch
        # still needs it for its (lazy) local tile
        if any(d.version == self.version and d.holder is None
               for d in self.pending):
            self.old_globals[self.version] = global_params
        self.buffer = []
        self.version += 1
        return server_state, new_global

    def run(self, server_state, global_params, *,
            on_event: Callable | None = None):
        """Run ``cfg.rounds`` fusion events; ``on_event(record, global)``
        fires after each. Returns the final (server_state,
        global_params)."""
        while self.version < self.cfg.rounds:
            self._fill_slots()
            t_next = min(d.t_finish for d in self.pending)
            arrivals = sorted(
                [d for d in self.pending if d.t_finish == t_next],
                key=lambda d: d.seq)
            self.pending = [d for d in self.pending
                            if d.t_finish != t_next]
            self._compute_updates(arrivals, global_params)
            for d in arrivals:
                self.buffer.append(d)
                self.max_buffer_seen = max(self.max_buffer_seen,
                                           len(self.buffer))
                self.free_at.append(d.t_finish)
                if len(self.buffer) == self.engine.buffer_k:
                    server_state, global_params = self._fuse(
                        server_state, global_params)
                    if on_event is not None:
                        on_event(self.events[-1], global_params)
                    if self.version >= self.cfg.rounds:
                        break
        return server_state, global_params


# ---------------------------------------------------------------------------
# The runtime entry point (routed from fl/runtime.run_federated)
# ---------------------------------------------------------------------------


def run_async_federated(task, cfg, parts, get_batch, test_batches, *,
                        latency: str = "zero", log=None, class_counts=None,
                        group_spec=None, use_kernel=None,
                        use_local_kernel: bool = False, device=None,
                        init_params=None,
                        grad_chunk: int | None = None, mesh=None) -> dict:
    """Buffered-async counterpart of ``runtime.run_federated``: the same
    history contract with one row per FUSION EVENT, plus the per-event
    ``staleness`` lists and simulated ``sim_time`` under the latency
    trace. ``cfg.rounds`` counts fusion events, ``cfg.cohort_size`` is
    the in-flight concurrency, ``cfg.buffer_k`` updates fuse per event
    under the ``cfg.staleness`` discount. Presence-weighted group fusion
    refuses (``check_async_support``). ``mesh``: None, a one-device mesh,
    or this rank's ``RankMesh`` (the module docstring says how the
    ranks split the run; every rank returns the same history)."""
    from repro_torch.fl.runtime import initial_params, resolve_device

    device = resolve_device(device if device is not None
                            else getattr(mesh, "device", None))
    if len(parts) != cfg.population:
        raise ValueError(
            f"run_async_federated got {len(parts)} client shards for "
            f"FLConfig.population={cfg.population}; partition with "
            "n_clients=cfg.population or fix the config")
    method = methods_lib.get(cfg.method)
    check_async_support(
        method,
        presence_weighted=(method.uses_groups
                           and class_counts is not None
                           and group_spec is not None))
    sampler = population_lib.get(cfg.sampler)
    trace = LatencyTrace.make(latency, population=cfg.population,
                              seed=cfg.seed)
    policy = parse_staleness(cfg.staleness)
    rng = np.random.default_rng(cfg.seed)
    params = initial_params(task, cfg, init_params, device)
    pop = Population.from_parts(parts)
    # async-eligible methods are stateless-client (check_async_support),
    # so the store only ever holds the aux arrays here: with
    # store="mmap" parts and weights come off read-only memory maps and
    # a dispatch reads just its clients' rows
    from repro_torch.fl import statestore as statestore_lib
    from repro_torch.fl.runtime import store_rank
    pop.use_store(statestore_lib.get(cfg.store, chunk_size=cfg.chunk_size,
                                     rank=store_rank(mesh)))
    try:
        return _async_run(task, cfg, pop, sampler, trace, policy, rng,
                          params, get_batch, test_batches, log=log,
                          use_kernel=use_kernel,
                          use_local_kernel=use_local_kernel, method=method,
                          device=device, grad_chunk=grad_chunk, mesh=mesh)
    finally:
        pop.store.close()


def _async_run(task, cfg, pop, sampler, trace, policy, rng, params,
               get_batch, test_batches, *, log, use_kernel,
               use_local_kernel, method, device, grad_chunk, mesh) -> dict:
    """``run_async_federated`` once its population holds its store: the
    engine, the event loop and the history."""
    from repro_torch.fl.runtime import close_history

    engine = make_async_engine(task, cfg, params, device=device,
                               use_kernel=use_kernel,
                               use_local_kernel=use_local_kernel,
                               method=method, grad_chunk=grad_chunk,
                               mesh=mesh)
    global_params = engine.layout.flatten(params)
    server_state = engine.init_server_state(global_params)
    eval_engine = evaluation_lib.make_eval_engine(task.predict_fn,
                                                  task.n_classes)
    eval_tiles = evaluation_lib.stage(test_batches, tile=cfg.eval_batch,
                                      device=device, mesh=mesh)

    driver = AsyncFederation(engine, pop, sampler, cfg, get_batch,
                             cfg.local_epochs * cfg.steps_per_epoch, rng,
                             trace, policy,
                             uniform_weights=(sampler.fusion_weights
                                              == "uniform"))
    history = {"round": [], "acc": [], "wall": [], "participants": [],
               "staleness": [], "sim_time": []}
    counts = []                    # device tensors; read after the loop
    t0 = time.time()

    def on_event(rec, gp):
        c = eval_engine.run(engine.layout.unflatten(gp), eval_tiles)
        counts.append(c)
        history["round"].append(rec["version"])
        history["participants"].append(rec["participants"])
        history["staleness"].append(list(rec["staleness"]))
        history["sim_time"].append(float(rec["sim_time"]))
        history["wall"].append(time.time() - t0)
        if log:                    # logging opts into a per-event sync
            log(f"event {rec['version']:3d} acc "
                f"{evaluation_lib.accuracy(c.cpu().numpy()):.4f} "
                f"staleness {rec['staleness']} "
                f"t_sim {rec['sim_time']:.2f}")

    server_state, global_params = driver.run(server_state, global_params,
                                             on_event=on_event)
    history["local_tiles"] = driver.local_tiles
    return close_history(history, counts, t0,
                         engine.layout.unflatten(global_params))


def sync_round_times(trace: LatencyTrace, participants_per_round) -> list:
    """Simulated duration of each SYNC round under ``trace``: the round
    barrier waits for its slowest sampled client (dispatch seqs numbered
    as the sync loop would dispatch them)."""
    times, seq = [], 0
    for ids in participants_per_round:
        lat = 0.0
        for c in ids:
            lat = max(lat, trace.latency(int(c), seq))
            seq += 1
        times.append(lat)
    return times
