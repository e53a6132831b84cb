"""Structural feature allocation (paper §4-§5.1).

``GroupSpec`` pins the class->group map: the gradient-redirection
targets (Eq. 16) and each group's logit signature, Fed2's pairing key
(Eq. 19).
"""
from __future__ import annotations

import dataclasses


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

    def logit_signature(self, g: int) -> frozenset:
        """The logit set of a group: Fed2's pairing key (Eq. 19)."""
        return frozenset(self.classes_per_group[g])
