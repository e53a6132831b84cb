"""Logical client population & participation.

- ``Population``: the P logical clients: per-client shard indices,
  sample-count weights, optional (P, G) presence weights, and the
  persistent per-client method state, kept host-side as stacked
  (P, ...) numpy rows outside the round.
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

from repro_torch.models.module import tree_map


@dataclasses.dataclass
class Population:
    """The P logical clients behind a federated run.

    parts: per-client sample index arrays (the data shards).
    weights: (P,) float64 sample counts, floored at 1 (the fusion
    weights before per-cohort renormalization).
    group_weights: optional (P, G) presence weights for fed2's non-IID
    refinement (rows gathered per cohort).
    clients: the stacked (P, ...) client-state tree as numpy arrays
    (() for stateless methods)."""
    parts: list
    weights: np.ndarray
    group_weights: np.ndarray | None = None
    clients: Any = ()

    @classmethod
    def from_parts(cls, parts, group_weights=None) -> "Population":
        parts = list(parts)
        weights = np.maximum([len(p) for p in parts], 1).astype(np.float64)
        gw = (None if group_weights is None
              else np.asarray(group_weights, np.float64))
        return cls(parts=parts, weights=weights, group_weights=gw)

    @property
    def size(self) -> int:
        return len(self.parts)

    def initialize(self, row) -> None:
        """Broadcast ONE client's round-0 state row to all P clients."""
        self.clients = tree_map(
            lambda a: np.array(np.broadcast_to(
                np.asarray(a)[None], (self.size,) + np.shape(a))), row)

    def gather(self, ids):
        """Sampled clients' state rows -> cohort-slot stacked arrays."""
        ids = np.asarray(ids)
        return tree_map(lambda a: a[ids], self.clients)

    def scatter(self, ids, new_states) -> None:
        """Write cohort slots back to the sampled clients' rows; the
        others keep their state."""
        ids = np.asarray(ids)

        def put(a, new):
            a[ids] = np.asarray(new)
            return a

        self.clients = tree_map(put, self.clients, new_states)


class ClientSampler:
    """Participation strategy: which client ids train in round r.
    ``full`` MUST NOT draw from ``rng``: the batch-packing rng stream then
    matches the reference's draw for draw."""

    name: str = ""

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

    def sample(self, round_idx, population, cohort_size, rng, weights=None):
        return np.arange(population, dtype=np.int64)
