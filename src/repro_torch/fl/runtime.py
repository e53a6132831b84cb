"""Federated learning runtime: the synchronous round loop.

A run has ``cfg.population`` logical clients (fl/population.py), of
which a cohort of ``cfg.cohort_size`` slots trains at once. Per round:

    ids   <- sampler.sample(round, population, cohort_size)
    state <- population.gather(ids)            # rows -> cohort slots
    state, global <- engine.run_round(state, global, batches, w[ids])
    population.scatter(ids, state)             # slots -> rows

Client state lives in the population's store (fl/statestore.py,
``cfg.store``): stacked host rows (``memory``) or chunked memory-mapped
shards on disk (``mmap``, O(cohort) host memory). When the whole
population is one cohort in natural order and the store is in memory,
client state needs no slot remapping and stays on the device across
rounds; otherwise it is gathered from and scattered to host rows. When
the participants exceed one cohort, the round runs as several engine
tiles whose fusion results accumulate in a running weighted sum,
unbiased because each tile's fuse is a weighted mean renormalized over
its participants (host-fusion methods keep each tile's stacked params
and fuse them once at the end of the round).

Batches are drawn host-side from one numpy ``default_rng(cfg.seed)`` in
the reference's order (sampler, then per tile: padding, then one
``rng.choice`` per client per step), so the same seed trains on the same
examples in both packages. Each tile's batches go to the device in one
copy.

The feature axes of the sync round (fl/engine.py) come in through
``FLConfig``: ``attack``/``attack_fraction`` (attackers are assigned by
client id from their own numpy stream; a data-poisoning attack corrupts
the malicious clients' batches after the rng draw, so the packing
stream stays the honest one; model poisoning gets the tile's attacker
row, pad rows forced honest), ``robust``, ``codec``, ``compute_dtype``,
``local_unroll``, ``alignment`` (recorded: the model must be built
through ``alignment.build_model_config``) and ``mode="one_shot"``
(``one_shot_config``: the whole step budget trained locally, one
fusion).

``tiers`` routes the rounds through the heterogeneous-capacity engine
(fl/capacity.py): one engine per tier, overlap-aware combine. A single
width-1.0 tier is the homogeneous engine and runs it unchanged.
``mode="async"`` routes the whole run through the buffered-async driver
(fl/async_engine.py): one history row per fusion event.

``run_federated(checkpoint_dir=...)`` saves the resumable run state
(global params, server state, client state, the host rng) in the JAX
package's checkpoint format (checkpoint/io.py), converted from the flat
state to the reference's params trees; ``resume=True`` continues a run
from it to the bit, and either package resumes the other's checkpoint.

``run_federated(mesh=...)`` places the rounds as the JAX package's
``mesh=`` does: a one-device mesh (``launch.mesh.make_host_mesh``) is
the one-process run. On this rank's ``launch.mesh.RankMesh`` of more
than one rank the cohort is split over "data" (fl/engine.py) and the
eval tiles too (fl/evaluation.py): every rank replays the same host rng
(sampler, padding, batch packing), so the cohort trains on the batches
the one-process run packs, and moves only its own rows to its device;
every rank ends each round with the same global and the same history,
and rank 0 logs. Ranks run the whole sync round: every method, every
feature axis (data poisoning packs the poisoned batches on every rank),
one-shot fusion and cohort tiling (each tile's rows split over "data"
as one cohort's are); and the rest of the federation: capacity tiers
(each tier's tile split over "data", fl/capacity.py), buffered-async
events (fl/async_engine.py), the ``mmap`` store (every rank keeps a
whole replica of the population's rows, as the memory store does, in
shards of its own: fl/statestore.py) and FL checkpoints: rank 0 writes
each one (an mmap store's shards included) and every rank waits at a
barrier until it is published; on resume every rank reads it whole,
and one process resumes it too.

Everything runs on the CUDA card unless the caller passes
``device="cpu"``; with no card and no device named, ``run_federated``
raises rather than falling back.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import fusion as fusion_lib
from repro_torch.fl import evaluation as evaluation_lib
from repro_torch.fl import methods as methods_lib
from repro_torch.fl import population as population_lib
from repro_torch.fl.engine import make_round_engine
from repro_torch.fl.population import Population
from repro_torch.launch.collectives import barrier
from repro_torch.models.module import tree_map


def resolve_device(device=None) -> torch.device:
    """The device a run uses: the caller's, else the CUDA card. Raises
    when no card is present and none was named: nothing falls back to
    the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or "
            "--device cpu) to run on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class FLConfig:
    population: int = 10        # logical clients (fl/population.py)
    cohort_size: int | None = None  # engine width; None -> population
    sampler: str = "full"       # any name in population.available()
    rounds: int = 20
    local_epochs: int = 1
    steps_per_epoch: int = 10
    batch_size: int = 32
    lr: float = 0.05
    momentum: float = 0.9
    method: str = "fed2"        # any name in methods.available()
    prox_mu: float = 0.01
    server_lr: float = 1.0      # server-step methods (fedavgm, fedadam)
    server_momentum: float = 0.9
    seed: int = 0
    eval_batch: int = 512
    # client-state storage (fl/statestore.py): "memory" keeps stacked
    # (P, ...) host rows (O(P) RAM); "mmap" keeps the population on disk
    # as chunk_size-row mmap shards (O(cohort) RAM, incremental
    # checkpoints)
    store: str = "memory"
    chunk_size: int = 1024
    # heterogeneous capacity (fl/capacity.py): per-tier (width, client
    # count) pairs, "1.0x2,0.5x2,0.25x2" or a tuple of pairs; None/() =
    # homogeneous. Counts must sum to the population.
    tiers: Any = None
    # "sync" runs the round loop; "async" makes the fusion event the
    # unit of progress (fl/async_engine.py): rounds counts events,
    # cohort_size is the in-flight concurrency, buffer_k updates fuse
    # per event (None -> cohort_size) under the staleness discount
    # ("constant" | "polynomial(a)"); "one_shot" trains the whole
    # rounds x local_epochs x steps_per_epoch budget locally and fuses
    # exactly once (one_shot_config)
    mode: str = "sync"
    buffer_k: int | None = None
    staleness: str = "constant"
    # byzantine behavior ("label_flip" | "sign_flip(s)" |
    # "scaled_update(s)" | "gauss_noise(sigma)") on attack_fraction of
    # the population (>= 1 = an explicit count); robust fusion rule
    # ("coordinate_median" | "trimmed_mean(beta)" | "norm_clip(tau)").
    # None/"" = honest run / plain fusion.
    attack: str | None = None
    attack_fraction: float = 0.0
    robust: str | None = None
    # local-phase dtype ("float32" | "bfloat16": cast at the round
    # boundary, fp32 fusion); uplink codec ("identity" | "int8" |
    # "topk(f)"); local_unroll is validated and clamped as the JAX
    # package's (a scan unroll there; no effect on eager torch)
    compute_dtype: str = "float32"
    codec: str | None = None
    local_unroll: int = 1
    # alignment strategy (fl/alignment.py): "grouped" | "pan" | "none"
    alignment: str = "grouped"

    def __post_init__(self):
        if self.method not in methods_lib.available():
            raise ValueError(
                f"unknown federated method {self.method!r}; available: "
                f"{', '.join(methods_lib.available())}")
        if self.sampler not in population_lib.available():
            raise ValueError(
                f"unknown client sampler {self.sampler!r}; available: "
                f"{', '.join(population_lib.available())}")
        from repro_torch.fl import statestore as statestore_lib
        if self.store not in statestore_lib.available():
            raise ValueError(
                f"unknown client-state store {self.store!r}; available: "
                f"{', '.join(statestore_lib.available())}")
        if (not isinstance(self.chunk_size, int)
                or isinstance(self.chunk_size, bool)
                or self.chunk_size <= 0):
            raise ValueError(
                f"FLConfig.chunk_size must be a positive int (rows per "
                f"client-state shard), got {self.chunk_size!r}")
        if self.cohort_size is None:
            object.__setattr__(self, "cohort_size", self.population)
        for field in ("rounds", "population", "cohort_size", "batch_size",
                      "local_epochs", "steps_per_epoch", "eval_batch"):
            v = getattr(self, field)
            if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                raise ValueError(
                    f"FLConfig.{field} must be a positive int, got {v!r}")
        if self.cohort_size > self.population:
            raise ValueError(
                f"FLConfig.cohort_size ({self.cohort_size}) must not "
                f"exceed population ({self.population})")
        if not self.tiers:
            object.__setattr__(self, "tiers", None)
        else:
            from repro_torch.fl import capacity as capacity_lib
            mix = capacity_lib.parse_tiers(self.tiers)
            capacity_lib.validate_mix(mix, self.population)
            object.__setattr__(self, "tiers", mix)
        if self.mode not in ("sync", "async", "one_shot"):
            raise ValueError(
                f"FLConfig.mode must be 'sync', 'async' or 'one_shot', "
                f"got {self.mode!r}")
        if self.mode == "async":
            from repro_torch.fl import async_engine as async_lib
            async_lib.parse_staleness(self.staleness)
            if self.tiers is not None:
                raise ValueError(
                    "FLConfig.tiers and mode='async' are mutually "
                    "exclusive: the buffered-async driver dispatches "
                    "full-width cohort tiles (DESIGN.md §12); drop the "
                    "tiers or run mode='sync'")
            if self.buffer_k is None:
                object.__setattr__(self, "buffer_k", self.cohort_size)
            k = self.buffer_k
            if not isinstance(k, int) or isinstance(k, bool) or k <= 0:
                raise ValueError(
                    f"FLConfig.buffer_k must be a positive int, got "
                    f"{k!r}")
        else:
            if self.buffer_k is not None:
                raise ValueError(
                    "FLConfig.buffer_k is only meaningful with "
                    "mode='async' (the per-fusion-event buffer bound); "
                    "leave it None for sync rounds")
            if self.staleness != "constant":
                raise ValueError(
                    "FLConfig.staleness is only meaningful with "
                    "mode='async'; leave it 'constant' for sync rounds")
        if not self.attack:
            object.__setattr__(self, "attack", None)
            if self.attack_fraction:
                raise ValueError(
                    f"FLConfig.attack_fraction="
                    f"{self.attack_fraction!r} without attack: name the "
                    "byzantine behavior (FLConfig.attack, e.g. "
                    "'sign_flip') or drop the fraction")
        else:
            from repro_torch.fl import attacks as attacks_lib
            attacks_lib.parse_attack(self.attack)
            attacks_lib.attacker_count(self.attack_fraction,
                                       self.population)
        if not self.robust:
            object.__setattr__(self, "robust", None)
        else:
            from repro_torch.fl import robust as robust_lib
            robust_lib.parse_robust(self.robust)
        if self.attack or self.robust:
            what = "attack" if self.attack else "robust"
            if self.tiers is not None:
                raise ValueError(
                    f"FLConfig.{what} and tiers are mutually exclusive "
                    "for now: tiered rounds fuse width-sliced sub-model "
                    "tiles (DESIGN.md §11), where neither the "
                    "malicious-presence row nor a cross-tile robust "
                    "reduction is defined; drop the tiers or the "
                    "adversarial knobs")
            if self.mode == "async":
                raise ValueError(
                    f"FLConfig.{what} and mode='async' are mutually "
                    "exclusive for now: a fusion event mixes updates "
                    "from different global versions, so the "
                    "per-round malicious row / robust reduction "
                    "(DESIGN.md §14) has no buffered form yet; run "
                    "mode='sync'")
        from repro_torch.fl.engine import resolve_compute_dtype
        resolve_compute_dtype(self.compute_dtype,
                              methods_lib.get(self.method))
        if (not isinstance(self.local_unroll, int)
                or isinstance(self.local_unroll, bool)
                or self.local_unroll <= 0):
            raise ValueError(
                f"FLConfig.local_unroll must be a positive int (local "
                f"optimizer steps batched per dispatch), got "
                f"{self.local_unroll!r}")
        if not self.codec:
            object.__setattr__(self, "codec", None)
        else:
            from repro_torch.fl import codec as codec_lib
            codec_lib.parse_codec(self.codec)
        if self.compute_dtype != "float32" or self.codec is not None:
            knob = ("compute_dtype" if self.compute_dtype != "float32"
                    else "codec")
            if self.tiers is not None:
                raise ValueError(
                    f"FLConfig.{knob} and tiers are mutually exclusive "
                    "for now: tiered rounds fuse width-sliced sub-model "
                    "tiles (DESIGN.md §11) whose per-tier byte/precision "
                    "accounting the §15 knobs don't define yet; drop the "
                    "tiers or the knob")
            if self.mode == "async":
                raise ValueError(
                    f"FLConfig.{knob} and mode='async' are mutually "
                    "exclusive for now: the buffered-async tile/event "
                    "split (DESIGN.md §12) implements neither the round-"
                    "boundary dtype cast nor the decode-then-fuse "
                    "round-trip; run mode='sync'")
        # method eligibility for every knob above, in one place
        from repro_torch.fl import compat as compat_lib
        compat_lib.validate(self, methods_lib.get(self.method))


@dataclasses.dataclass
class FLTask:
    """Model-family adapter consumed by ``run_federated``.

    init_fn(generator) -> params tree on the CPU; loss_fn(params,
    batch) -> scalar; predict_fn(params, batch) ->
    (pred, gold, weight) for the tiled eval: ``n_classes`` x
    ``n_classes`` confusion counts, or (correct, total) sums when
    ``n_classes`` is None (LM tasks, where the classes are the vocab);
    group_axes_fn(params) -> GroupAxis tree (fed2);
    matched_average_fn(stacked, weights) -> params tree (fedma): stacked
    is a tree of (n, ...) leaves; tier_fn(width) -> the family's
    width-``width`` sub-model (``capacity.TierModel``), None when the
    family has no tier support.
    """
    init_fn: Callable
    loss_fn: Callable
    predict_fn: Callable
    n_classes: int | None
    group_axes_fn: Callable | None = None
    matched_average_fn: Callable | None = None
    tier_fn: Callable | None = None


def _pack_client_batches(parts, get_batch, n_steps, batch_size, rng,
                         poison_fns=None):
    """Per cohort tile: dict of (C, n_steps, B, ...) numpy arrays for the
    given clients' shards, sampling with replacement where a shard is
    short (empty shards index sample 0). poison_fns: optional
    per-client ``batch -> batch`` hooks (None = honest), applied after
    the rng draw, so the packing stream is the honest run's."""
    per_client = []
    for ci, idx in enumerate(parts):
        hook = poison_fns[ci] if poison_fns is not None else None
        steps = []
        for _ in range(n_steps):
            if len(idx) == 0:
                sel = np.zeros((batch_size,), np.int64)
            else:
                sel = rng.choice(idx, size=batch_size,
                                 replace=len(idx) < batch_size)
            b = get_batch(sel)
            steps.append(b if hook is None else hook(b))
        per_client.append({k: np.stack([np.asarray(s[k]) for s in steps])
                           for k in steps[0]})
    return {k: np.stack([c[k] for c in per_client])
            for k in per_client[0]}


def pad_tile_inputs(pop: Population, tids, width: int, get_batch, n_steps,
                    batch_size, rng, uniform_weights: bool = False,
                    gw_cols: int | None = None):
    """Pad one engine tile to ``width`` slots (repeating the first
    participant at zero weight) and assemble its weights, presence rows
    and packed batches: the padding of cohort tiling, the capacity
    tiers' tiles and the async dispatch groups. uniform_weights: every
    participant weighs 1 (samplers whose draw already encodes shard
    size). gw_cols keeps the first K presence columns (a tier that
    dropped the rest). Returns (padded_ids, weights, group_weights,
    batches)."""
    tids = np.asarray(tids, np.int64)
    n_real = len(tids)
    padded = np.concatenate(
        [tids, np.full(width - n_real, tids[0], np.int64)])
    w = (np.ones(width) if uniform_weights
         else pop.weights[padded].copy())
    w[n_real:] = 0.0
    gw = None
    if pop.group_weights is not None:
        gw = pop.group_weights[padded]
        gw = (gw if gw_cols is None else gw[:, :gw_cols]).copy()
        gw[n_real:] = 0.0
    pois = None
    if pop.poison is not None and pop.malicious is not None:
        pois = [pop.poison if pop.malicious[i] else None for i in padded]
    batches = _pack_client_batches([pop.parts[i] for i in padded],
                                   get_batch, n_steps, batch_size, rng,
                                   poison_fns=pois)
    return padded, w, gw, batches


def device_batches(batches: dict, device, rows: slice = slice(None)) -> dict:
    """A tile's packed numpy batches (their cohort ``rows``: a rank's
    block on a mesh of ranks) as tensors on ``device``, one copy per
    leaf."""
    return {k: torch.as_tensor(v[rows], device=device)
            for k, v in batches.items()}


def _malicious_inputs(engine, pop: Population, padded, n_real, cfg,
                      round_idx):
    """The engine's malicious argument for one tile: the slots' attacker
    flags (pad rows forced honest; they carry zero weight anyway) and
    the round's key. None for engines without a model-poisoning
    attack."""
    if engine.attack is None:
        return None
    if pop.malicious is None:
        raise ValueError(
            "cfg.attack is set but the Population carries no attacker "
            "mask; build the run through run_federated (it assigns "
            "attackers seed-deterministically via "
            "attacks.assign_attackers) or set pop.malicious")
    from repro_torch.fl import attacks as attacks_lib
    row = pop.malicious[np.asarray(padded)].astype(np.float32)
    row[n_real:] = 0.0
    return row, attacks_lib.round_key(cfg.seed, round_idx)


def _fit_hint(n_ids: int, width: int) -> str:
    return ("raise cohort_size to hold all participants or use a "
            "cohort-sized sampler (uniform/weighted/round_robin)"
            if n_ids > width else
            "use a sampler that fills the cohort, or lower "
            "cohort_size to the participant count")


def run_sampled_round(engine, pop: Population, method, server_state,
                      global_params, ids, get_batch, n_steps, cfg, rng,
                      uniform_weights: bool = False, round_idx: int = 0):
    """One round for participant ``ids``: a single engine invocation
    when the cohort holds them all, cohort tiling otherwise. Returns
    (server_state, new_global); client state is gathered/scattered on
    ``pop`` in place. uniform_weights: every participant contributes
    equally to fusion (``ClientSampler.fusion_weights``). round_idx
    keys the round's attack noise."""
    C = engine.cohort_size
    ids = np.asarray(ids, np.int64)

    def tile_inputs(tids):
        padded, w, gw, batches = pad_tile_inputs(
            pop, tids, C, get_batch, n_steps, cfg.batch_size, rng,
            uniform_weights=uniform_weights)
        return padded, w, gw, device_batches(batches, engine.device,
                                             engine.rows)

    if len(ids) == C:
        _, w, gw, batches = tile_inputs(ids)
        mal = _malicious_inputs(engine, pop, ids, C, cfg, round_idx)
        # the whole population in one cohort in natural order: client
        # state needs no slot remapping, so it stays on the device.
        # Out-of-core stores opt out (store.in_memory): their state
        # stays on their shards
        whole = (C == pop.size and pop.store.in_memory
                 and np.array_equal(ids, np.arange(C)))
        state = {"server": server_state,
                 "clients": pop.clients if whole else pop.gather(ids)}
        state, new_global = engine.run_round(state, global_params, batches,
                                             weights=w, group_weights=gw,
                                             malicious=mal)
        if whole:
            pop.clients = state["clients"]
        else:
            pop.scatter(ids, state["clients"])
        return state["server"], new_global

    if not method.cohort_tiling and not method.host_fusion:
        raise ValueError(
            f"{method.name}: server step reads the participating cohort "
            f"slots (cohort_tiling=False), so a round needs exactly "
            f"cohort_size participants — got {len(ids)} for "
            f"cohort_size={C}; " + _fit_hint(len(ids), C))
    if pop.group_weights is not None:
        raise ValueError(
            "presence-weighted group fusion needs exactly one unpadded "
            "cohort of participants: tiling renormalizes each group "
            "column per tile, and padded slots would join a no-holder "
            "column's uniform fallback — either biases Eq. 19. Got "
            f"{len(ids)} participants for cohort_size={C}; "
            + _fit_hint(len(ids), C))
    if engine.robust is not None:
        # a reducing rule is not affine: a median of per-tile medians is
        # not the round's median (norm_clip is a pre-step and tiles
        # exactly; the engine keeps it out of engine.robust)
        raise ValueError(
            f"robust rule {engine.robust.describe()!r} reduces over the "
            "full cohort and has no exact tiled form (the weighted "
            f"quantile is not affine); got {len(ids)} participants for "
            f"cohort_size={C} — " + _fit_hint(len(ids), C))
    acc, w_acc = None, 0.0
    stacked_tiles = []              # host_fusion: stacked params per tile
    for t0 in range(0, len(ids), C):
        tids = ids[t0:t0 + C]
        n_real = len(tids)
        padded, w, gw, batches = tile_inputs(tids)
        mal = _malicious_inputs(engine, pop, padded, n_real, cfg,
                                round_idx)
        new_cstate, fuse_out = engine.run_tile(pop.gather(padded),
                                               server_state, global_params,
                                               batches, weights=w,
                                               group_weights=gw,
                                               malicious=mal)
        pop.scatter(tids, tree_map(lambda a: a[:n_real], new_cstate))
        if method.host_fusion:
            # a copy: the next tile overwrites the engine's cohort buffer
            stacked_tiles.append(fuse_out[:n_real].clone())
            continue
        s_t = float(w.sum())
        part = tree_map(lambda f: f * s_t, fuse_out)
        acc = part if acc is None else tree_map(torch.add, acc, part)
        w_acc += s_t
    if method.host_fusion:
        w_all = (np.ones(len(ids)) if uniform_weights
                 else pop.weights[ids])
        return server_state, engine.host_fuse(torch.cat(stacked_tiles),
                                              w_all)
    return engine.finish_round(server_state, global_params,
                               tree_map(lambda a: a / w_acc, acc))


def one_shot_config(cfg: FLConfig) -> FLConfig:
    """The sync config a ``mode='one_shot'`` run executes: every client
    trains the WHOLE round budget locally (rounds x local_epochs x
    steps_per_epoch optimizer steps) and the server fuses exactly once:
    a 1-round sync run, so the history has one row."""
    if cfg.mode != "one_shot":
        return cfg
    return dataclasses.replace(
        cfg, mode="sync", rounds=1, local_epochs=1,
        steps_per_epoch=(cfg.rounds * cfg.local_epochs
                         * cfg.steps_per_epoch))


def run_federated(task: FLTask, cfg: FLConfig, parts, get_batch,
                  test_batches, *, latency: str = "zero", log=None,
                  class_counts=None, group_spec=None, use_kernel=None,
                  use_local_kernel: bool = False, device=None,
                  init_params=None, checkpoint_dir=None,
                  checkpoint_every: int = 1, resume: bool = False,
                  grad_chunk: int | None = None, mesh=None) -> dict:
    """parts: cfg.population per-client index arrays (or a
    ``statestore.ShardIndices``); get_batch(sel) -> batch dict of numpy
    arrays; test_batches: list of such dicts for the global eval.

    class_counts (population, C) + group_spec enable Eq. 19's non-IID
    refinement for group-structured methods (fed2): group g fuses only
    across participants that hold g's classes.
    use_kernel: fuse through the paired_fusion kernel (None = default,
    the kernel). use_local_kernel: run the local optimizer tail through
    the local_step kernel (the tier tiles' and the async dispatch
    groups' too).
    device: where the run computes; None = the CUDA card (raises when
    there is none), or the rank's device on a mesh of ranks.
    mesh: None (one process), a one-device mesh (the same run), or this
    rank's ``launch.mesh.RankMesh``: the cohort and the eval split over
    its "data" ranks (the module docstring says what ranks run).
    grad_chunk: each local step's vmapped gradients taken this many
    clients at a time (None: the whole cohort in one call; the same
    numbers, less memory: a client's activations live through its
    backward, as nothing is rematerialized under ``torch.func``).
    init_params: a params tree to start from (e.g. a reference init
    converted by ``repro_torch.convert``); None draws one from
    ``torch.Generator().manual_seed(cfg.seed)``.

    ``cfg.tiers`` runs each round through the capacity-tier engine
    (fl/capacity.py); a single width-1.0 tier runs the homogeneous
    engine unchanged. ``cfg.mode == "async"`` routes the whole run
    through the buffered-async driver (fl/async_engine.py): one history
    row per fusion event, ``latency`` names its seed-deterministic
    client-latency trace ("zero" | "pareto(a)" | "lognormal(sigma)"),
    and checkpointing is refused. A non-zero ``latency`` under
    mode='sync' is refused.

    checkpoint_dir: save the resumable run state (global params, server
    state, the population's client state, the host rng) after every
    ``checkpoint_every``-th round and after the last (on ranks: rank 0
    writes, the others wait for it); with
    ``resume=True`` an existing checkpoint restores it and the loop
    continues from the saved round, equal to the uninterrupted run to
    the bit (the history then covers only the resumed rounds; resuming
    a finished run trains nothing and reports one eval of the restored
    model). Without a checkpoint there, the run starts fresh.

    Returns history {round, acc, wall, wall_total, participants,
    confusion, per_class_acc, final_params}: per round, the (C, C)
    confusion counts and per-class accuracy rows (tasks with
    ``n_classes`` only). ``acc`` is the pooled accuracy over the eval set
    (an LM's next-token accuracy over every masked position); ``wall``
    holds host timestamps after each round's eval was queued."""
    device = resolve_device(device if device is not None
                            else getattr(mesh, "device", None))
    if len(parts) != cfg.population:
        raise ValueError(
            f"run_federated got {len(parts)} client shards for "
            f"FLConfig.population={cfg.population}")
    cfg = one_shot_config(cfg)
    if getattr(mesh, "rank", 0) != 0:
        log = None                 # rank 0 logs
    if cfg.mode == "async":
        from repro_torch.fl import async_engine as async_lib
        if checkpoint_dir or resume:
            raise ValueError(
                "checkpointing is not supported with mode='async': the "
                "resumable state would have to capture the in-flight "
                "dispatch buffer (DESIGN.md §12); run mode='sync' or "
                "drop checkpoint_dir/resume")
        return async_lib.run_async_federated(
            task, cfg, parts, get_batch, test_batches, latency=latency,
            log=log, class_counts=class_counts, group_spec=group_spec,
            use_kernel=use_kernel, use_local_kernel=use_local_kernel,
            device=device, init_params=init_params, grad_chunk=grad_chunk,
            mesh=mesh)
    if latency != "zero":
        from repro_torch.fl import async_engine as async_lib
        async_lib.parse_latency(latency)   # helpful error for typos
        raise ValueError(
            "a latency trace is only meaningful with mode='async': the "
            "sync round barrier just waits out the slowest client — "
            "simulate its round times with "
            "async_engine.sync_round_times instead")
    if checkpoint_dir and (not isinstance(checkpoint_every, int)
                           or isinstance(checkpoint_every, bool)
                           or checkpoint_every < 1):
        raise ValueError(
            f"checkpoint_every must be a positive int (rounds between "
            f"saves; the final round always saves), got "
            f"{checkpoint_every!r}")
    from repro_torch.fl import statestore as statestore_lib
    rng = np.random.default_rng(cfg.seed)
    params = initial_params(task, cfg, init_params, device)
    method = methods_lib.get(cfg.method)
    sampler = population_lib.get(cfg.sampler)
    gw = None
    if method.uses_groups and class_counts is not None \
            and group_spec is not None:
        gw = fusion_lib.presence_group_weights(class_counts, group_spec)
    pop = Population.from_parts(parts, group_weights=gw)
    pop.use_store(statestore_lib.get(cfg.store, chunk_size=cfg.chunk_size,
                                     rank=store_rank(mesh)))
    try:
        return _sync_rounds(task, cfg, pop, method, sampler, params,
                            get_batch, test_batches, rng, log=log,
                            use_kernel=use_kernel,
                            use_local_kernel=use_local_kernel,
                            device=device, checkpoint_dir=checkpoint_dir,
                            checkpoint_every=checkpoint_every,
                            resume=resume, grad_chunk=grad_chunk,
                            mesh=mesh)
    finally:
        pop.store.close()      # out-of-core stores drop their shards


def store_rank(mesh):
    """The rank a client-state store is built for: this rank's number on
    a mesh of more than one rank (each keeps its own replica), else
    None."""
    return None if mesh is None or mesh.size == 1 else mesh.rank


def _sync_rounds(task, cfg, pop, method, sampler, params, get_batch,
                 test_batches, rng, *, log, use_kernel, use_local_kernel,
                 device, checkpoint_dir, checkpoint_every, resume,
                 grad_chunk, mesh) -> dict:
    """``run_federated``'s sync run once its population holds its store:
    attackers, engines, state (restored from a checkpoint on resume),
    the round loop with its saves, and the history."""
    if cfg.attack is not None:
        from repro_torch.fl import attacks as attacks_lib
        atk = attacks_lib.parse_attack(cfg.attack).build()
        pop.malicious = attacks_lib.assign_attackers(
            cfg.attack_fraction, cfg.population, seed=cfg.seed)
        if atk.data_poisoning:
            if task.n_classes is None:
                raise ValueError(
                    f"attack {cfg.attack!r} poisons labels and needs "
                    "task.n_classes (defined for classification tasks; "
                    "LM tasks have no flip target) — use a "
                    "model-poisoning attack (sign_flip/scaled_update/"
                    "gauss_noise) instead")
            pop.poison = (lambda b, _a=atk, _n=task.n_classes:
                          _a.poison_batch(b, _n))
    tiered = None
    if cfg.tiers is not None:
        from repro_torch.fl import capacity as capacity_lib
        plan = capacity_lib.TierPlan.from_mix(cfg.tiers, cfg.population,
                                              seed=cfg.seed)
        if not plan.trivial:      # one width-1.0 tier IS the homogeneous
            #                       engine
            pop.tiers = plan.assignment
            tiered = capacity_lib.make_tiered_engine(
                task, cfg, params, plan, device=device,
                use_kernel=use_kernel, use_local_kernel=use_local_kernel,
                method=method, use_gw=pop.group_weights is not None,
                grad_chunk=grad_chunk, mesh=mesh)
    if tiered is not None:
        engine = tiered.full
    else:
        engine = make_round_engine(task, cfg, params, device=device,
                                   use_kernel=use_kernel,
                                   use_local_kernel=use_local_kernel,
                                   method=method, grad_chunk=grad_chunk,
                                   mesh=mesh)
    layout = engine.layout
    global_params = layout.flatten(params)
    server_state = engine.init_server_state(global_params)
    pop.initialize(engine.init_client_row(global_params), layout,
                   method.name)

    eval_engine = evaluation_lib.make_eval_engine(task.predict_fn,
                                                  task.n_classes)
    eval_tiles = evaluation_lib.stage(test_batches, tile=cfg.eval_batch,
                                      device=device, mesh=mesh)

    start_round = 0
    if checkpoint_dir and resume and ckpt_io.checkpoint_exists(
            checkpoint_dir):
        start_round, global_params, server_state = restore_run(
            checkpoint_dir, layout, global_params, server_state, pop, rng)
    if checkpoint_dir:             # every rank has read before rank 0
        barrier(mesh)              # writes
    already_complete = start_round >= cfg.rounds

    history = {"round": [], "acc": [], "wall": [], "participants": []}
    n_steps = cfg.local_epochs * cfg.steps_per_epoch
    counts = []                    # device tensors; read after the loop
    t0 = time.time()
    uniform_w = sampler.fusion_weights == "uniform"

    def eval_and_record(r, participants):
        """Evaluate the current global and append one history row (the
        round loop's and the finished run's resume tail's)."""
        c = eval_engine.run(layout.unflatten(global_params), eval_tiles)
        counts.append(c)
        history["round"].append(r)
        history["participants"].append(participants)
        history["wall"].append(time.time() - t0)
        return c

    for r in range(start_round, cfg.rounds):
        ids = sampler.sample(r, cfg.population, cfg.cohort_size, rng,
                             weights=pop.weights)
        if tiered is not None:
            from repro_torch.fl.capacity import run_tiered_round
            server_state, global_params = run_tiered_round(
                tiered, pop, method, server_state, global_params, ids,
                get_batch, n_steps, cfg, rng, uniform_weights=uniform_w)
        else:
            server_state, global_params = run_sampled_round(
                engine, pop, method, server_state, global_params, ids,
                get_batch, n_steps, cfg, rng, uniform_weights=uniform_w,
                round_idx=r)
        if checkpoint_dir and ((r + 1) % checkpoint_every == 0
                               or r == cfg.rounds - 1):
            if getattr(mesh, "rank", 0) == 0:
                save_run(checkpoint_dir, r + 1, layout, global_params,
                         server_state, pop, rng)
            barrier(mesh)          # published before any rank goes on
        c = eval_and_record(r, np.asarray(ids))
        if log:                    # logging opts into a per-round sync
            log(f"round {r:3d} acc "
                f"{evaluation_lib.accuracy(c.cpu().numpy()):.4f}")
    if already_complete:
        # resuming a finished run: nothing to train, but callers index
        # h["acc"][-1], so report one eval of the restored model
        eval_and_record(cfg.rounds - 1, np.asarray([], np.int64))
    return close_history(history, counts, t0,
                         layout.unflatten(global_params))


def save_run(path, round_idx, layout, global_params, server_state, pop,
             rng) -> None:
    """One FL checkpoint after ``round_idx`` rounds, in the JAX
    package's format: the flat global params and server state as the
    reference's params trees, the client state as the store's shards
    (incremental stores) or as one stacked tree. A device-resident
    client stack (the whole-population fast path) is copied to the host
    for the save and stays where it is. On a mesh of ranks rank 0 alone
    calls it (every rank holds the same state)."""
    ckpt_io.save_fl_checkpoint(
        path, round_idx=round_idx,
        global_params=convert.flat_to_reference(global_params, layout),
        server_state=convert.flat_to_reference(server_state, layout),
        client_state=(pop.store if pop.store.incremental else
                      convert.flat_to_reference(pop.clients, layout)),
        rng=rng)


def restore_run(path, layout, global_params, server_state, pop, rng):
    """Restore a ``save_run`` checkpoint (or the JAX package's) into a
    run built for it: ``pop``'s client state and ``rng``'s state in
    place. Returns (round_idx, global_params, server_state) as the run's
    flat tensors."""
    like_clients = (convert.flat_to_reference(pop.clients, layout)
                    if pop.store.in_memory else None)
    step, glob, server, clients, rng_state = ckpt_io.load_fl_checkpoint(
        path, like_global=convert.flat_to_reference(global_params, layout),
        like_server=convert.flat_to_reference(server_state, layout),
        like_clients=like_clients, store=pop.store)
    if clients is not None:    # incremental stores restore their shards
        pop.clients = convert.flat_from_reference(clients, pop.clients,
                                                  layout)
    rng.bit_generator.state = rng_state
    return (step, convert.flat_from_reference(glob, global_params, layout),
            convert.flat_from_reference(server, server_state, layout))


def initial_params(task: FLTask, cfg: FLConfig, init_params, device):
    """The run's starting params tree on ``device``: ``init_params`` when
    given, else drawn from ``torch.Generator().manual_seed(cfg.seed)``."""
    if init_params is None:
        init_params = task.init_fn(torch.Generator().manual_seed(cfg.seed))
    return tree_map(lambda t: torch.as_tensor(t).to(device), init_params)


def close_history(history: dict, counts: list, t0: float,
                  final_params) -> dict:
    """Read the per-row eval counts off the device and complete a run's
    history: acc, wall_total and final_params, and for confusion counts
    (tasks with ``n_classes``) confusion and per_class_acc."""
    conf = [c.cpu().numpy() for c in counts]
    if conf and conf[0].ndim == 2:
        history["confusion"] = conf
        history["per_class_acc"] = [evaluation_lib.per_class_accuracy(c)
                                    for c in conf]
    history["acc"] = [evaluation_lib.accuracy(c) for c in conf]
    history["wall_total"] = time.time() - t0
    history["final_params"] = final_params
    return history


# ---------------------------------------------------------------------------
# Tasks
# ---------------------------------------------------------------------------


def cnn_task(model_cfg) -> FLTask:
    from repro_torch.core import matching as matching_lib
    from repro_torch.models.cnn import apply_cnn, cnn_loss, init_cnn

    def predict(params, batch):
        logits = apply_cnn(params, model_cfg, batch["images"])
        return (logits.argmax(-1), batch["labels"],
                torch.ones(batch["labels"].shape, dtype=torch.float32,
                           device=logits.device))

    def tier_fn(width):
        from repro_torch.fl import capacity as capacity_lib
        return capacity_lib.cnn_tier_model(model_cfg, width)

    return FLTask(
        init_fn=lambda gen: init_cnn(gen, model_cfg),
        loss_fn=lambda p, b: cnn_loss(p, model_cfg, b),
        group_axes_fn=lambda p: fusion_lib.cnn_group_axes(p, model_cfg),
        matched_average_fn=lambda s, w: matching_lib.matched_average(
            s, model_cfg, w),
        predict_fn=predict,
        n_classes=model_cfg.n_classes,
        tier_fn=tier_fn,
    )


def lm_task(model_cfg) -> FLTask:
    """The LM families' adapter (dense, moe, ssm and hybrid). The loss
    is ``lm_loss`` (the CE and the MoE aux loss) on the reference's
    einsum unembedding; the eval predicts
    the argmax next token at every position under ``torch.no_grad``,
    where a Fed2 unembedding takes the ``grouped_matmul`` kernel route
    on the card. No confusion counts (``n_classes=None``), no tiers
    (``tier_fn=None``), no host matched averaging (fedma refuses).
    The encdec and vlm families are refused (a ValueError): their loss
    and eval need frontend embeds that the token batches do not carry
    (the reference's eval fails on them)."""
    from repro_torch.models.forward import (forward, lm_loss,
                                            refuse_frontend_families)
    from repro_torch.models.transformer import init_params, unembed_apply
    refuse_frontend_families(model_cfg, "lm_task")

    @torch.no_grad()
    def predict(params, batch):
        h, _ = forward(params, model_cfg, batch["tokens"])
        logits = unembed_apply(params["unembed"], h, model_cfg)
        return logits.argmax(-1), batch["labels"], batch["mask"]

    return FLTask(
        init_fn=lambda gen: init_params(gen, model_cfg),
        loss_fn=lambda p, b: lm_loss(p, model_cfg, b),
        group_axes_fn=lambda p: fusion_lib.lm_group_axes(p, model_cfg),
        predict_fn=predict,
        n_classes=None,
    )

