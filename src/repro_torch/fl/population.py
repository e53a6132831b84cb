"""Logical client population & participation.

- ``Population``: the P logical clients: per-client shard indices,
  sample-count weights, optional (P, G) presence weights, and the
  persistent per-client method state, held by a ``ClientStateStore``
  (fl/statestore.py) outside the round. The default ``InMemoryStore``
  keeps stacked (P, ...) numpy rows; ``MmapShardStore`` keeps the
  population on disk and the host at O(cohort). When the whole
  population is one cohort in natural order and the store is in
  memory, the runtime keeps the state on the device instead
  (``clients`` then holds the engine's device tensors).
- ``ClientSampler``: which client ids train in round r, registered by
  name like the federated methods: ``register`` / ``get`` /
  ``available()``.

The round engine (fl/engine.py) runs a fixed-width cohort; the host loop
(fl/runtime.py) gathers the sampled clients' state into cohort slots,
runs the round and scatters the new state back. When a sampler returns
more participants than one cohort holds (``full`` participation with
population > cohort_size), the round runs as several engine tiles
(cohort tiling).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass
class Population:
    """The P logical clients behind a federated run.

    parts: per-client sample index arrays (the data shards): a list of P
    arrays or a ``statestore.ShardIndices`` (flat + offsets, the form
    out-of-core stores map from disk).
    weights: (P,) float64 sample counts, floored at 1 (the fusion
    weights before per-cohort renormalization). May be a read-only
    memory map after ``use_store`` offloads it.
    group_weights: optional (P, G) presence weights for fed2's non-IID
    refinement (rows gathered per cohort).
    store: the ``ClientStateStore`` holding the per-client method state,
    an ``InMemoryStore`` by default. ``clients`` is its stacked-tree
    view (in-memory stores only).
    malicious: optional (P,) bool attacker mask by client id
    (``attacks.assign_attackers``); sampling, tiling and gather index it
    by id, so the flagged set holds under every participation pattern.
    poison: the data-poisoning hook ``batch -> batch`` applied to the
    malicious clients' batches on the host (None for model-poisoning or
    honest runs).
    tiers: optional (P,) int tier index per client, the capacity class
    each logical client trains (fl/capacity.py ``TierPlan.assignment``);
    None for homogeneous runs.

    ``gather`` and ``scatter`` go to the store directly. The JAX package
    routes them through ``FedMethod.gather_client_state`` /
    ``scatter_client_state`` hooks, which no method overrides there or
    here: every port method's client state is plain flat rows."""
    parts: Any
    weights: np.ndarray
    group_weights: np.ndarray | None = None
    store: Any = None
    malicious: np.ndarray | None = None
    poison: Any = None
    tiers: np.ndarray | None = None

    def __post_init__(self):
        if self.store is None:
            from repro_torch.fl import statestore
            self.store = statestore.InMemoryStore()

    @classmethod
    def from_parts(cls, parts, group_weights=None) -> "Population":
        from repro_torch.fl import statestore
        if isinstance(parts, statestore.ShardIndices):
            weights = np.maximum(parts.lengths(), 1).astype(np.float64)
        else:
            parts = list(parts)
            weights = np.maximum([len(p) for p in parts],
                                 1).astype(np.float64)
        gw = (None if group_weights is None
              else np.asarray(group_weights, np.float64))
        return cls(parts=parts, weights=weights, group_weights=gw)

    @property
    def size(self) -> int:
        return len(self.parts)

    @property
    def clients(self) -> Any:
        """The full stacked (P, ...) state tree, served by the store
        (out-of-core stores refuse: gather rows)."""
        return self.store.tree

    @clients.setter
    def clients(self, stacked) -> None:
        self.store.adopt(stacked)

    def use_store(self, store) -> None:
        """Swap in a ClientStateStore and let it take over the
        population-wide storage it owns (out-of-core stores also offload
        parts/weights/presence rows to disk)."""
        self.store = store
        store.offload_aux(self)

    def initialize(self, row, layout=None, method=None) -> None:
        """Broadcast ONE client's round-0 state row to all P clients
        (``layout``: the engine's FlatLayout of flat rows; ``method``:
        the method's name, for the store's refusals)."""
        self.store.initialize(row, self.size, layout, method)

    def gather(self, ids):
        """Sampled clients' state rows -> cohort-slot stacked arrays."""
        return self.store.gather(np.asarray(ids))

    def scatter(self, ids, new_states) -> None:
        """Write cohort slots (numpy, or the engine's device tensors)
        back to the sampled clients' rows; the others keep their
        state."""
        self.store.scatter(np.asarray(ids), new_states)


class ClientSampler:
    """Participation strategy: which client ids train in round r.

    ``sample`` returns a 1-D int array of client ids. Strategies that
    return exactly ``cohort_size`` ids run as one engine invocation;
    longer id lists (``full`` over a large population) run as cohort
    tiles. Each sampler draws from ``rng`` exactly as the reference's
    does (``full`` and ``round_robin`` never draw), so the batch-packing
    rng stream that follows matches the reference's draw for draw."""

    name: str = ""
    summary: str = ""          # one line for a sampler table
    # how a cohort's fusion weights are built: "sample" = shard-size
    # weights renormalized over the participants (full/uniform/
    # round_robin); "uniform" = every participant contributes equally,
    # because the sampling probability already encodes shard size
    # (weighted). Shard-size weights under shard-size sampling would
    # count large shards twice.
    fusion_weights: str = "sample"

    def sample(self, round_idx: int, population: int, cohort_size: int,
               rng: np.random.Generator, weights=None) -> np.ndarray:
        raise NotImplementedError


_REGISTRY: dict[str, type[ClientSampler]] = {}


def register(cls: type[ClientSampler]) -> type[ClientSampler]:
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    _REGISTRY[cls.name] = cls
    return cls


def available() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get(name: str) -> ClientSampler:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(
            f"unknown client sampler {name!r}; available: "
            f"{', '.join(available())}") from None


@register
class FullParticipation(ClientSampler):
    """Every client, every round. With population > cohort_size the host
    loop tiles the population over cohort-width engine invocations."""
    name = "full"
    summary = "every client every round (cohort tiling past the width)"

    def sample(self, round_idx, population, cohort_size, rng, weights=None):
        return np.arange(population, dtype=np.int64)


@register
class UniformSampler(ClientSampler):
    """cohort_size clients drawn uniformly without replacement."""
    name = "uniform"
    summary = "cohort_size clients uniformly, without replacement"

    def sample(self, round_idx, population, cohort_size, rng, weights=None):
        return np.sort(rng.choice(population, size=cohort_size,
                                  replace=False)).astype(np.int64)


@register
class WeightedSampler(ClientSampler):
    """Sampling probability proportional to shard size (weights), without
    replacement: large-shard clients participate more often, and each
    participant then contributes EQUALLY to fusion
    (``fusion_weights = "uniform"``).

    Draws through a Walker alias table (``fl/statestore.AliasTable``),
    built once per weights array (cached on the sampler instance and
    rebuilt only when another weights array arrives). Zero-weight
    clients are never sampled, and an all-zero weight vector raises.
    Returns sorted unique ids."""
    name = "weighted"
    summary = "probability proportional to shard size, w/o replacement"
    fusion_weights = "uniform"

    def __init__(self):
        self._src = None          # the weights array the table was built on
        self._table = None

    def _alias_table(self, population, weights):
        from repro_torch.fl.statestore import AliasTable
        if weights is None:
            weights = np.ones(population, np.float64)
        if self._table is None or self._src is not weights \
                or self._table.n != population:
            self._table = AliasTable(weights)
            self._src = weights
        return self._table

    def sample(self, round_idx, population, cohort_size, rng, weights=None):
        table = self._alias_table(population, weights)
        return table.sample_without_replacement(rng, cohort_size)


@register
class RoundRobinSampler(ClientSampler):
    """Deterministic cycling window: round r trains clients
    [r*C, r*C + C) mod population. A pure function of (round_idx,
    population, cohort_size): it never draws from ``rng``."""
    name = "round_robin"
    summary = "deterministic cycling window over client ids"

    def sample(self, round_idx, population, cohort_size, rng, weights=None):
        start = (round_idx * cohort_size) % population
        return ((start + np.arange(cohort_size)) % population).astype(
            np.int64)
