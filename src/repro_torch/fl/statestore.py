"""Client-state storage helpers: the store names and the Walker/Vose
alias table.

The reference's ``fl/statestore.py`` registers two client-state stores:
``memory`` (stacked host rows, the port's ``Population``) and ``mmap``
(chunked on-disk shards). The port's CLI takes both names as the
reference's does (``--store``) and refuses ``mmap``, which is not
ported yet.

``AliasTable`` is the port's copy of the reference's, which
``fl/population.WeightedSampler`` draws its cohorts through. The table
and its draws use numpy only, in the reference's order, so the same
weights and rng give the same ids in both packages.
"""
from __future__ import annotations

import numpy as np

STORES = ("memory", "mmap")


def available() -> tuple[str, ...]:
    """The reference's client-state store names, sorted."""
    return STORES


class AliasTable:
    """Walker/Vose alias table over nonnegative weights.

    Build is O(P) and deterministic (a pure function of the weights);
    each draw is O(1): pick column j uniformly, accept j with
    probability prob[j], else take alias[j]. Zero-weight entries get
    prob 0 and an alias pointing at a positive-weight entry, so they are
    never sampled."""

    __slots__ = ("prob", "alias", "n", "n_nonzero")

    def __init__(self, weights):
        w = np.asarray(weights, np.float64)
        if w.ndim != 1 or len(w) == 0:
            raise ValueError("AliasTable needs a non-empty 1-D weight "
                             f"array, got shape {w.shape}")
        if not np.isfinite(w).all() or (w < 0).any():
            raise ValueError("AliasTable weights must be finite and "
                             "non-negative")
        total = float(w.sum())
        if total <= 0.0:
            raise ValueError("AliasTable weights sum to zero: no client "
                             "is sampleable")
        n = len(w)
        self.n = n
        self.n_nonzero = int(np.count_nonzero(w))
        p = w * (n / total)
        prob = np.ones(n, np.float64)
        alias = np.arange(n, dtype=np.int64)
        small = list(np.nonzero(p < 1.0)[0][::-1])
        large = list(np.nonzero(p >= 1.0)[0][::-1])
        while small and large:
            s, lg = small.pop(), large.pop()
            prob[s] = p[s]
            alias[s] = lg
            p[lg] -= 1.0 - p[s]
            (large if p[lg] >= 1.0 else small).append(lg)
        # Zero-weight columns the loop paired carry prob 0.0 exactly
        # (p[s] = 0) and their alias redirects the column's full mass to
        # a positive-weight entry: leave those alone. Float drift can
        # strand a true-zero entry in the residual (prob still 1.0,
        # sampleable); re-pin only those: prob 0, alias at the heaviest.
        stranded = (w == 0.0) & (prob != 0.0)
        if stranded.any():
            prob[stranded] = 0.0
            alias[stranded] = int(np.argmax(w))
        self.prob, self.alias = prob, alias

    def draw(self, rng: np.random.Generator, size: int) -> np.ndarray:
        """``size`` independent draws WITH replacement, O(size)."""
        j = rng.integers(0, self.n, size=size)
        return np.where(rng.random(size) < self.prob[j], j,
                        self.alias[j]).astype(np.int64)

    def sample_without_replacement(self, rng: np.random.Generator,
                                   k: int) -> np.ndarray:
        """k DISTINCT indices by rejection over ``draw``: expected
        O(k log P) vectorized draws while k stays well under the nonzero
        support. Returns sorted unique ids."""
        if k > self.n_nonzero:
            raise ValueError(
                f"cannot sample {k} distinct clients: only "
                f"{self.n_nonzero} of {self.n} have nonzero weight")
        chosen: list[int] = []
        seen = set()
        while len(chosen) < k:
            for j in self.draw(rng, max(2 * (k - len(chosen)), 16)):
                if j not in seen:
                    seen.add(j)
                    chosen.append(int(j))
                    if len(chosen) == k:
                        break
        return np.sort(np.asarray(chosen, np.int64))
