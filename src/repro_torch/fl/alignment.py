"""Alignment strategies: how clients keep features comparable across
fusion, registered like the federated methods (``register`` / ``get`` /
``available()``).

- ``grouped``: the Fed2 structure adaptation (Eq. 16): class-exclusive
  feature groups for methods that declare ``uses_groups``, the plain
  baseline of the same widths for coordinate methods. The default.
- ``pan``: Position-Aware Neurons (arxiv 2203.14666): a plain net with a
  fixed, client-shared per-channel position encoding added to every
  hidden pre-activation (``models/cnn.py pan_encoding``).
- ``none``: the explicit no-alignment control: plain net, plain
  coordinate averaging. For coordinate methods it builds the same model
  as ``grouped``.

Eligibility lives in fl/compat.py (``check_alignment_support``): pan and
none refuse methods whose fuse is defined over structure groups (fed2).

``build_model_config(strategy, method, grouped_fn, plain_fn)`` is the
single model-construction rule the CLI and the scenarios route through.
"""
from __future__ import annotations

import dataclasses


class AlignmentStrategy:
    """One way of keeping client features comparable across fusion."""

    name: str = ""
    summary: str = ""       # one line for an alignment table
    structural = False      # grouped: follow the METHOD's structure
    #                         declaration; False: always the plain net
    pan_scale = 0.0         # scale of the fixed position encodings added
    #                         to hidden pre-activations (0 = none)


_REGISTRY: dict[str, type[AlignmentStrategy]] = {}


def register(cls: type[AlignmentStrategy]) -> type[AlignmentStrategy]:
    if not cls.name:
        raise ValueError("AlignmentStrategy.name must be non-empty")
    _REGISTRY[cls.name] = cls
    return cls


def available() -> tuple[str, ...]:
    """All registered strategy names, sorted."""
    return tuple(sorted(_REGISTRY))


def get(name: str) -> AlignmentStrategy:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(
            f"unknown alignment strategy {name!r}; available: "
            f"{', '.join(available())}") from None


def build_model_config(strategy: AlignmentStrategy, method, grouped_fn,
                       plain_fn):
    """The model-construction rule: ``grouped_fn()`` builds the family's
    Fed2-adapted config, ``plain_fn()`` the plain baseline of the same
    widths. The structural strategy follows the method's own
    declaration; the others always build plain and stamp their PAN
    scale."""
    from repro_torch.fl import compat as compat_lib
    if strategy.structural:
        cfg = (grouped_fn() if not compat_lib.supports(method, "alignment")
               else plain_fn())
    else:
        cfg = plain_fn()
    if strategy.pan_scale:
        cfg = dataclasses.replace(cfg, pan=strategy.pan_scale)
    return cfg


@register
class GroupedAlignment(AlignmentStrategy):
    """Fed2 structure adaptation (Eq. 16) for group-structured methods;
    the plain same-width baseline for coordinate methods."""
    name = "grouped"
    summary = ("Fed2 structure adaptation (Eq. 16): class-exclusive "
               "feature groups for uses_groups methods")
    structural = True


@register
class PanAlignment(AlignmentStrategy):
    """PAN position encodings (arxiv 2203.14666): plain net + fixed
    client-shared per-channel encodings on hidden pre-activations."""
    name = "pan"
    summary = ("PAN position encodings (arxiv 2203.14666) on a plain "
               "net: fixed per-channel anchors break permutation "
               "symmetry")
    pan_scale = 0.2


@register
class NoAlignment(AlignmentStrategy):
    """Plain net, plain coordinate averaging: the control row."""
    name = "none"
    summary = "plain coordinate averaging, no alignment (control row)"
