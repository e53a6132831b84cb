"""Scenario matrix: federated runs as data.

``ScenarioSpec`` is a frozen record pinning everything one run needs:
the data protocol, the method, the population/cohort/sampler triple,
the round schedule, the capacity tiers, the federation mode (sync,
buffered async with its buffer, staleness discount and latency trace,
or one-shot) and the sync round's feature axes (attack, robust rule,
alignment strategy). Specs are registered by name like the federated
methods: ``register`` / ``get`` / ``available()``. The registered specs
are the reference's 27 seeded specs, field for field (the paper's
protocols at laptop scale: synthetic class-clustered images, a
width-calibrated reduced VGG9).

``run_scenario`` executes a spec end to end through ``run_federated``
and returns a ``ConvergenceRecord``: per-round global, per-class and
per-group accuracy (group g over the eval samples whose label is in
``GroupSpec.logit_signature(g)``), and wall clock.
"""
from __future__ import annotations

import dataclasses
import json
import os

from repro_torch.core.grouping import GroupSpec
from repro_torch.fl import methods as methods_lib
from repro_torch.fl import population as population_lib

PROTOCOLS = ("iid", "nxc", "dirichlet", "quantity")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One runnable federated scenario, fully pinned by its fields.

    protocol: data heterogeneity: ``iid`` | ``nxc`` (each client sees
    ``classes_per_node`` classes) | ``dirichlet`` (label skew, Dir(alpha)
    per class) | ``quantity`` (size skew, Dir(alpha) shard sizes).
    groups/decouple: Fed2 structure adaptation for group-structured
    methods (coordinate methods train the plain net of the same widths).
    server_lr/server_momentum: the server step of fedavgm and fedadam
    (``FLConfig``'s defaults; the reference's specs leave them there).
    attack/attack_fraction/robust: byzantine clients (fl/attacks.py) on
    a seed-deterministic share of the population, and the robust fusion
    rule (fl/robust.py). Empty = honest run / plain fusion.
    store/chunk_size: the client-state store (fl/statestore.py):
    ``memory`` stacks every client's rows on the host; ``mmap`` keeps
    them in chunk_size-row shards on disk. Either store gives the same
    history to the bit.
    alignment: "grouped" (the method's own structural declaration),
    "pan" or "none" (fl/alignment.py). mode="one_shot" trains the whole
    round budget locally and fuses once (fl/runtime.py
    one_shot_config).
    tiers: capacity mix ``((width, count), ...)`` (fl/capacity.py); ()
    = homogeneous. mode="async" runs the buffered-async driver
    (fl/async_engine.py): rounds counts fusion events, buffer_k updates
    fuse per event under the staleness discount, latency names the
    client-latency trace (async only).
    """
    name: str
    summary: str
    protocol: str
    method: str
    classes_per_node: int = 2          # nxc
    alpha: float = 0.5                 # dirichlet / quantity
    n_classes: int = 10
    groups: int = 5
    decouple: int = 1
    population: int = 6
    cohort_size: int | None = None
    sampler: str = "full"
    tiers: tuple = ()
    rounds: int = 10
    local_epochs: int = 1
    steps_per_epoch: int = 6
    batch_size: int = 16
    lr: float = 0.015
    momentum: float = 0.9
    server_lr: float = 1.0
    server_momentum: float = 0.9
    seed: int = 0
    train_size: int = 1200
    test_size: int = 400
    noise: float = 0.8
    eval_batch: int = 256
    store: str = "memory"
    chunk_size: int = 1024
    mode: str = "sync"
    buffer_k: int | None = None
    staleness: str = "constant"
    latency: str = "zero"
    attack: str = ""
    attack_fraction: float = 0.0
    robust: str = ""
    alignment: str = "grouped"

    def __post_init__(self):
        if self.protocol not in PROTOCOLS:
            raise ValueError(
                f"unknown scenario protocol {self.protocol!r}; "
                f"expected one of {', '.join(PROTOCOLS)}")
        if self.method not in methods_lib.available():
            raise ValueError(
                f"unknown federated method {self.method!r}; available: "
                f"{', '.join(methods_lib.available())}")
        if self.sampler not in population_lib.available():
            raise ValueError(
                f"unknown client sampler {self.sampler!r}; available: "
                f"{', '.join(population_lib.available())}")
        if self.tiers:
            from repro_torch.fl import capacity as capacity_lib
            mix = capacity_lib.parse_tiers(self.tiers)
            capacity_lib.validate_mix(mix, self.population)
            object.__setattr__(self, "tiers", mix)
        from repro_torch.fl import statestore as statestore_lib
        if self.store not in statestore_lib.available():
            raise ValueError(
                f"unknown client-state store {self.store!r}; available: "
                f"{', '.join(statestore_lib.available())}")
        if self.mode not in ("sync", "async", "one_shot"):
            raise ValueError(
                f"ScenarioSpec.mode must be 'sync', 'async' or "
                f"'one_shot', got {self.mode!r}")
        from repro_torch.fl import async_engine as async_lib
        async_lib.parse_latency(self.latency)
        if self.mode == "async":
            async_lib.parse_staleness(self.staleness)
        elif self.latency != "zero":
            raise ValueError(
                "ScenarioSpec.latency is only meaningful with "
                "mode='async' (the sync round barrier just waits out "
                "the slowest client); keep it 'zero' for sync scenarios")
        if self.attack:
            from repro_torch.fl import attacks as attacks_lib
            attacks_lib.parse_attack(self.attack)
            attacks_lib.attacker_count(self.attack_fraction,
                                       self.population)
        elif self.attack_fraction:
            raise ValueError(
                f"ScenarioSpec.attack_fraction={self.attack_fraction!r} "
                "without attack: name the byzantine behavior or drop "
                "the fraction")
        if self.robust:
            from repro_torch.fl import robust as robust_lib
            robust_lib.parse_robust(self.robust)
        from repro_torch.fl import compat as compat_lib
        compat_lib.validate(self, methods_lib.get(self.method))

    def override(self, **kw) -> "ScenarioSpec":
        """A copy with fields replaced (smoke runs: fewer rounds, less
        data); the registered spec stays frozen."""
        return dataclasses.replace(self, **kw)

    def partition(self, labels):
        """The spec's data protocol applied to a label array."""
        from repro_torch.data import synthetic as data
        if self.protocol == "iid":
            return data.iid_partition(labels, self.population,
                                      seed=self.seed)
        if self.protocol == "nxc":
            return data.nxc_partition(labels, self.population,
                                      self.classes_per_node,
                                      self.n_classes, seed=self.seed)
        if self.protocol == "dirichlet":
            return data.dirichlet_partition(labels, self.population,
                                            self.alpha, self.n_classes,
                                            seed=self.seed)
        return data.quantity_partition(labels, self.population,
                                       self.alpha, seed=self.seed)

    def protocol_label(self) -> str:
        """Human-readable protocol cell for tables and records."""
        if self.protocol == "nxc":
            return f"nxc({self.classes_per_node})"
        if self.protocol in ("dirichlet", "quantity"):
            return f"{self.protocol}({self.alpha:g})"
        return self.protocol

    def model_config(self):
        """Width-calibrated reduced VGG9, built through the alignment
        strategy (fl/alignment.py): "grouped" gives Fed2 structure
        adaptation for group-structured methods and the plain net of the
        same widths otherwise; "pan"/"none" always build the plain
        net."""
        from repro_torch.fl import alignment as alignment_lib
        from repro_torch.models.cnn import CNNConfig
        plan = (("c", 24), ("p",), ("c", 48), ("p",), ("c", 48), ("p",))
        return alignment_lib.build_model_config(
            alignment_lib.get(self.alignment),
            methods_lib.get(self.method),
            grouped_fn=lambda: CNNConfig(
                arch_id="vgg9-scenario", plan=plan, fc_dims=(160,),
                n_classes=self.n_classes, fed2_groups=self.groups,
                decouple=self.decouple, norm="gn"),
            plain_fn=lambda: CNNConfig(
                arch_id="vgg9-scenario", plan=plan, fc_dims=(160,),
                n_classes=self.n_classes, fed2_groups=0, norm="none"))

    def fl_config(self):
        from repro_torch.fl.runtime import FLConfig
        return FLConfig(population=self.population,
                        cohort_size=self.cohort_size,
                        sampler=self.sampler, rounds=self.rounds,
                        local_epochs=self.local_epochs,
                        steps_per_epoch=self.steps_per_epoch,
                        batch_size=self.batch_size, lr=self.lr,
                        momentum=self.momentum, method=self.method,
                        server_lr=self.server_lr,
                        server_momentum=self.server_momentum,
                        seed=self.seed, eval_batch=self.eval_batch,
                        store=self.store, chunk_size=self.chunk_size,
                        tiers=self.tiers or None, mode=self.mode,
                        buffer_k=self.buffer_k, staleness=self.staleness,
                        attack=self.attack or None,
                        attack_fraction=self.attack_fraction,
                        robust=self.robust or None,
                        alignment=self.alignment)

    def group_spec(self) -> GroupSpec:
        """The canonical class->group map the per-group rows report
        over."""
        return GroupSpec.contiguous(self.groups, self.n_classes)

    def datasets(self):
        """(train, test) synthetic datasets of this spec, as the
        reference draws them."""
        from repro_torch.data.synthetic import make_image_dataset
        train = make_image_dataset(self.train_size,
                                   n_classes=self.n_classes,
                                   seed=self.seed, noise=self.noise)
        test = make_image_dataset(self.test_size, n_classes=self.n_classes,
                                  seed=self.seed + 99, noise=self.noise)
        return train, test


@dataclasses.dataclass(frozen=True)
class ConvergenceRecord:
    """Structured result of one scenario run."""
    scenario: str
    method: str
    protocol: str
    rounds: list            # round indices
    acc: list               # per-round global accuracy
    per_class_acc: list     # per-round (C,) rows
    per_group_acc: list     # per-round (G,) rows (GroupSpec signatures)
    group_signatures: list  # group g -> sorted class ids
    wall: list              # per-round host timestamps (s)
    wall_total: float
    device: str = ""
    tiers: list = dataclasses.field(default_factory=list)
    #                       # capacity mix [[width, count], ...]; [] =
    #                       # homogeneous
    mode: str = "sync"      # "async": rows are fusion EVENTS and
    sim_time: list = dataclasses.field(default_factory=list)
    #                       # per-event simulated clock under the spec's
    #                       # latency trace ([] for sync runs)
    attack: str = ""        # byzantine behavior ("" = honest run)
    attack_fraction: float = 0.0
    robust: str = ""        # robust fusion rule ("" = plain fusion)
    alignment: str = "grouped"

    @property
    def final_acc(self) -> float:
        return self.acc[-1]

    @property
    def best_acc(self) -> float:
        return max(self.acc)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["final_acc"] = self.final_acc
        d["best_acc"] = self.best_acc
        return d

    def save(self, outdir: str) -> str:
        """Write ``<outdir>/scenario_<name>.json``; returns the path."""
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, f"scenario_{self.scenario}.json")
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        return path


def run_scenario(spec: ScenarioSpec, *, mesh=None, use_kernel=None,
                 use_local_kernel: bool = False, device=None,
                 init_params=None, outdir: str | None = None,
                 log=None) -> ConvergenceRecord:
    """Execute one scenario end to end (partition -> run_federated ->
    per-class/per-group accuracy rows) on ``device`` (None = the CUDA
    card, or the rank's device on a mesh of ranks), and write the record
    to ``<outdir>/scenario_<name>.json`` when ``outdir`` is given.
    ``mesh``: None (one process), a one-device mesh (the same run) or
    this rank's ``launch.mesh.RankMesh`` (``run_federated``'s); every
    rank returns the same record and rank 0 writes it."""
    from repro_torch.fl import evaluation as evaluation_lib
    from repro_torch.fl.runtime import cnn_task, resolve_device, \
        run_federated

    device = resolve_device(device if device is not None
                            else getattr(mesh, "device", None))
    ds, test = spec.datasets()
    parts = spec.partition(ds.labels)

    def get_batch(sel):
        return {"images": ds.images[sel], "labels": ds.labels[sel]}

    test_batches = [{"images": test.images, "labels": test.labels}]
    h = run_federated(cnn_task(spec.model_config()), spec.fl_config(),
                      parts, get_batch, test_batches, latency=spec.latency,
                      log=log, mesh=mesh,
                      use_kernel=use_kernel,
                      use_local_kernel=use_local_kernel, device=device,
                      init_params=init_params)
    gspec = spec.group_spec()
    rec = ConvergenceRecord(
        scenario=spec.name, method=spec.method,
        protocol=spec.protocol_label(),
        rounds=list(h["round"]),
        acc=[float(a) for a in h["acc"]],
        per_class_acc=[[float(x) for x in row]
                       for row in h["per_class_acc"]],
        per_group_acc=[[float(x) for x in
                        evaluation_lib.group_accuracy(c, gspec)]
                       for c in h["confusion"]],
        group_signatures=[sorted(gspec.logit_signature(g))
                          for g in range(gspec.n_groups)],
        wall=[round(float(w), 3) for w in h["wall"]],
        wall_total=round(float(h["wall_total"]), 3),
        device=str(device),
        tiers=[[w, c] for w, c in spec.tiers] if spec.tiers else [],
        mode=spec.mode,
        sim_time=[round(float(t), 4) for t in h.get("sim_time", [])],
        attack=spec.attack,
        attack_fraction=spec.attack_fraction, robust=spec.robust,
        alignment=spec.alignment)
    if outdir is not None and getattr(mesh, "rank", 0) == 0:
        rec.save(outdir)
    return rec


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ScenarioSpec] = {}


def register(spec: ScenarioSpec) -> ScenarioSpec:
    if not spec.name:
        raise ValueError("ScenarioSpec.name must be non-empty")
    _REGISTRY[spec.name] = spec
    return spec


def available() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get(name: str) -> ScenarioSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; available: "
            f"{', '.join(available())}") from None


# The seeded matrix: the paper's protocols at laptop scale, the
# reference's 8 protocol specs. One seed (0) pins every run. nxc(2)
# is the N x C protocol of Tables 1-2 at severe skew (2 of 10 classes
# per client), dirichlet(0.5) is Fig. 6-7's alpha; iid and quantity(0.5)
# are the homogeneous-label controls. The per-protocol lr is the
# reference's calibration (momentum 0.9, 10 rounds).

register(ScenarioSpec(
    name="iid_fedavg", protocol="iid", method="fedavg",
    summary="IID control: coordinate averaging without heterogeneity"))
register(ScenarioSpec(
    name="nxc2_fedavg", protocol="nxc", method="fedavg",
    summary="paper Tables 1-2 protocol, FedAvg baseline"))
register(ScenarioSpec(
    name="nxc2_fed2", protocol="nxc", method="fed2",
    summary="paper Tables 1-2 protocol, feature-paired averaging"))
register(ScenarioSpec(
    name="nxc2_fedma", protocol="nxc", method="fedma",
    summary="paper Tables 1-2 protocol, matched-averaging (WLA) baseline"))
register(ScenarioSpec(
    name="dir05_fedavg", protocol="dirichlet", method="fedavg", lr=0.01,
    summary="paper Fig. 6-7 Dirichlet(0.5) label skew, FedAvg baseline"))
register(ScenarioSpec(
    name="dir05_fed2", protocol="dirichlet", method="fed2", lr=0.01,
    summary="paper Fig. 6-7 Dirichlet(0.5) label skew, Fed2"))
register(ScenarioSpec(
    name="qskew_fedavg", protocol="quantity", method="fedavg",
    summary="quantity-skew control (Dir(0.5) shard sizes), FedAvg"))
register(ScenarioSpec(
    name="qskew_fed2", protocol="quantity", method="fed2",
    summary="quantity-skew control (Dir(0.5) shard sizes), Fed2"))

# Heterogeneous capacity (fl/capacity.py): every client trains a
# sub-model of its tier's width, fusion is overlap-aware. fedavg slices
# hidden channels by prefix and keeps the full head, so any width
# works; fed2 drops WHOLE feature groups (width*G integral at G=5:
# widths from {0.2, 0.4, 0.6, 0.8, 1.0}).
register(ScenarioSpec(
    name="nxc2_fedavg_tiers", protocol="nxc", method="fedavg",
    tiers=((1.0, 2), (0.5, 2), (0.25, 2)),
    summary="N x C skew + 1.0/0.5/0.25-width capacity tiers, FedAvg"))
register(ScenarioSpec(
    name="nxc2_fed2_tiers", protocol="nxc", method="fed2",
    tiers=((1.0, 2), (0.6, 2), (0.2, 2)),
    summary="N x C skew + group-whole 1.0/0.6/0.2 tiers, Fed2"))
register(ScenarioSpec(
    name="nxc2_fed2_tiers_cal", protocol="nxc", method="fed2", lr=0.02,
    tiers=((1.0, 2), (0.6, 2), (0.2, 2)),
    summary="N x C skew + group-whole tiers, Fed2 at calibrated lr"))
register(ScenarioSpec(
    name="dir05_fed2_tiers", protocol="dirichlet", method="fed2", lr=0.01,
    tiers=((1.0, 2), (0.6, 2), (0.2, 2)),
    summary="Dirichlet(0.5) skew + group-whole 1.0/0.6/0.2 tiers, Fed2"))
register(ScenarioSpec(
    name="dir05_fedavg_tiers", protocol="dirichlet", method="fedavg",
    lr=0.01, tiers=((1.0, 2), (0.5, 2), (0.25, 2)),
    summary="Dirichlet(0.5) skew + 1.0/0.5/0.25-width tiers, FedAvg"))

# Buffered-async federation (fl/async_engine.py), the straggler regime
# on the N x C protocol: 4 of 6 clients in flight, a fusion every 2
# arrivals under the polynomial staleness discount, Pareto(1.5)
# heavy-tail client latencies. Fusion events replace rounds in the
# record.
register(ScenarioSpec(
    name="nxc2_fedavg_async", protocol="nxc", method="fedavg",
    mode="async", cohort_size=4, sampler="uniform", buffer_k=2,
    staleness="polynomial(0.5)", latency="pareto(1.5)", rounds=15,
    summary="N x C skew, buffered-async FedAvg under Pareto stragglers"))
register(ScenarioSpec(
    name="nxc2_fed2_async", protocol="nxc", method="fed2",
    mode="async", cohort_size=4, sampler="uniform", buffer_k=2,
    staleness="polynomial(0.5)", latency="pareto(1.5)", rounds=15,
    summary="N x C skew, buffered-async Fed2 under Pareto stragglers"))

# Byzantine clients on the N x C protocol at population 10, so a 20%
# attacker fraction is exactly 2 seed-deterministic clients
# (assign_attackers, the seed + 14407 stream). label_flip poisons the
# data; sign_flip(4) poisons the update hard enough that plain averaging
# diverges, the regime where trimmed_mean must restore learning.
register(ScenarioSpec(
    name="nxc2_fedavg_flip20", protocol="nxc", method="fedavg",
    population=10, attack="label_flip", attack_fraction=0.2,
    summary="N x C skew, 20% label-flip data poisoning, plain FedAvg"))
register(ScenarioSpec(
    name="nxc2_fed2_flip20", protocol="nxc", method="fed2",
    population=10, attack="label_flip", attack_fraction=0.2,
    summary="N x C skew, 20% label-flip data poisoning, plain Fed2"))
register(ScenarioSpec(
    name="nxc2_fedavg_signflip20", protocol="nxc", method="fedavg",
    population=10, attack="sign_flip(4)", attack_fraction=0.2,
    summary="N x C skew, 20% sign-flip model poisoning, plain FedAvg"))
register(ScenarioSpec(
    name="nxc2_fed2_signflip20", protocol="nxc", method="fed2",
    population=10, attack="sign_flip(4)", attack_fraction=0.2,
    summary="N x C skew, 20% sign-flip model poisoning, plain Fed2"))
register(ScenarioSpec(
    name="nxc2_fedavg_signflip20_trim", protocol="nxc", method="fedavg",
    population=10, attack="sign_flip(4)", attack_fraction=0.2,
    robust="trimmed_mean(0.25)",
    summary="20% sign-flip vs FedAvg + 0.25-trimmed-mean robust fusion"))
register(ScenarioSpec(
    name="nxc2_fed2_signflip20_trim", protocol="nxc", method="fed2",
    population=10, attack="sign_flip(4)", attack_fraction=0.2,
    robust="trimmed_mean(0.25)",
    summary="20% sign-flip vs Fed2 + per-group 0.25-trimmed-mean fusion"))

# Alignment strategies and one-shot fusion. nxc2_fedavg_none builds the
# model nxc2_fedavg builds (a coordinate method never had structure), so
# their runs are equal bit for bit; the pan rows add the fixed
# per-channel anchors without touching the fuse. The one-shot rows spend
# the same step budget (10 rounds x 6 steps = 60 local steps) in one
# fusion.
register(ScenarioSpec(
    name="nxc2_fedavg_pan", protocol="nxc", method="fedavg",
    alignment="pan",
    summary="N x C skew, FedAvg on a plain net + PAN position encodings"))
register(ScenarioSpec(
    name="nxc2_fedavg_none", protocol="nxc", method="fedavg",
    alignment="none",
    summary="N x C skew, FedAvg unaligned control (== nxc2_fedavg)"))
register(ScenarioSpec(
    name="dir05_fedavg_pan", protocol="dirichlet", method="fedavg",
    lr=0.01, alignment="pan",
    summary="Dirichlet(0.5) skew, FedAvg + PAN position encodings"))
register(ScenarioSpec(
    name="dir05_fedavg_none", protocol="dirichlet", method="fedavg",
    lr=0.01, alignment="none",
    summary="Dirichlet(0.5) skew, FedAvg unaligned control"))
register(ScenarioSpec(
    name="nxc2_fed2_oneshot", protocol="nxc", method="fed2",
    mode="one_shot",
    summary="N x C skew, Fed2 one-shot: 60 local steps, ONE fusion"))
register(ScenarioSpec(
    name="nxc2_fedavg_oneshot", protocol="nxc", method="fedavg",
    mode="one_shot",
    summary="N x C skew, FedAvg one-shot: 60 local steps, ONE fusion"))
