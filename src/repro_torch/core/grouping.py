"""Structural feature allocation (paper §4-§5.1).

``GroupSpec`` pins the class->group map: the gradient-redirection
targets (Eq. 16) and each group's logit signature, Fed2's pairing key
(Eq. 19). The split depth can be chosen from measured layer TVs
(Eq. 17, ``choose_decouple_depth``): low-TV shallow layers stay shared,
and the TV surge marks where grouping starts (paper Fig. 10).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    n_groups: int
    n_classes: int
    # classes_per_group[g] = tuple of class ids allocated to group g
    classes_per_group: tuple

    @staticmethod
    def contiguous(n_groups: int, n_classes: int) -> "GroupSpec":
        """Paper §5.1: one- or multi-class to one-group, contiguous
        blocks."""
        if n_classes % n_groups and n_groups % n_classes:
            raise ValueError(f"{n_classes} classes do not tile "
                             f"{n_groups} groups")
        if n_classes >= n_groups:
            per = n_classes // n_groups
            cpg = tuple(tuple(range(g * per, (g + 1) * per))
                        for g in range(n_groups))
        else:  # more groups than classes: several groups share a class
            rep = n_groups // n_classes
            cpg = tuple((g // rep,) for g in range(n_groups))
        return GroupSpec(n_groups, n_classes, cpg)

    def group_of_class(self, c: int) -> int:
        for g, cls in enumerate(self.classes_per_group):
            if c in cls:
                return g
        raise ValueError(f"class {c} is in no group")

    def logit_signature(self, g: int) -> frozenset:
        """The logit set of a group: Fed2's pairing key (Eq. 19)."""
        return frozenset(self.classes_per_group[g])


def choose_decouple_depth(layer_tvs, *, threshold_frac: float = 0.5,
                          min_shared: int = 4) -> int:
    """How many trailing layers to decouple: the first layer whose TV
    reaches ``threshold_frac * max(TV)`` marks the feature-divergence
    surge (paper Fig. 10); at least ``min_shared`` shallow layers stay
    shared. Returns the number of trailing weight layers to group."""
    tvs = np.asarray(layer_tvs, dtype=np.float64)
    n = len(tvs)
    if n == 0:
        return 0
    thresh = threshold_frac * tvs.max()
    surge = n  # default: nothing decoupled
    for i, tv in enumerate(tvs):
        if tv >= thresh:
            surge = i
            break
    surge = max(surge, min_shared)
    return max(n - surge, 0)


def node_group_permutation(spec: GroupSpec, node_class_order) -> np.ndarray:
    """Canonical group g -> this node's group index holding the same
    logit signature. Under the static structural allocation every node
    shares the canonical map, so this is the identity; it is kept
    general to express Eq. 19's pairing under permuted local maps."""
    sig_to_local = {spec.logit_signature(g): g
                    for g in range(spec.n_groups)}
    perm = np.zeros(spec.n_groups, dtype=np.int32)
    for g in range(spec.n_groups):
        perm[g] = sig_to_local[spec.logit_signature(g)]
    del node_class_order  # signature-based; order-independent
    return perm
