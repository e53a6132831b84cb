"""Composable robust fusion rules.

A robust rule wraps a method's fuse without the method knowing:
``core/fusion.py``'s ``fedavg``/``paired_average`` accept ``robust=rule``
and route their cross-client reduction through it. Two hooks, chosen by
the rule's capability flags:

- ``reduces`` (coordinate_median, trimmed_mean(beta>0)): the rule
  REPLACES the weighted mean over the cohort axis with a weighted
  quantile statistic per coordinate. On the port's flat (C, M_d) cohort
  buffer of each dtype segment a coordinate rule needs no per-leaf
  split: one reduction over the segment's buffer, its result in the
  segment's dtype, is the per-leaf reduction of the JAX package. For
  fed2's presence-weighted grouped leaves the reduction runs per group
  column with that column's weights (core/fusion.py). The sort runs in
  column chunks of at most ``SORT_CHUNK`` coordinates: each coordinate
  sorts alone, so the chunks give the bits of one whole sort, and the
  fp32 copy and int64 order of a full-width cohort (4 x 439 M columns:
  7.0 and 14.0 GB) never exist at once.
- ``has_pre`` (norm_clip(tau)): the rule transforms the stacked cohort
  BEFORE the plain fuse: each client's whole-model update delta is
  L2-clipped to ``tau`` (one norm over the whole row: the fp32 sums of
  squares of every segment added, each segment then scaled in its
  dtype), then the method's own fusion runs unchanged, so cohort tiling
  stays exact. Reducing rules are not affine and refuse tiled rounds
  (fl/runtime.py).

Degenerate parameters are identity shortcuts, resolved on the host:
``trimmed_mean(0)`` and ``norm_clip(inf)`` are dropped by the engine,
which then runs the plain round bit for bit.

The sorts are ``torch.sort(..., stable=True)``, the order of the JAX
package's ``jnp.argsort``: clients whose values tie keep their slot
order, so a weighted-median tie (a prefix of the sorted weights summing
to exactly half) resolves as the JAX package resolves it.
``trimmed_mean`` divides by ``hi - lo`` as the JAX package does (not by
the surviving mass), so it computes the same function, round-off
included in form.
"""
from __future__ import annotations

import math
import re

import torch

from repro_torch.models.module import flat_parts, tree_map

# columns a reducing rule sorts at a time: 2^26 coordinates of a
# 4-client cohort are 1 GB of fp32 values and 2 GB of int64 order
SORT_CHUNK = 1 << 26


class RobustRule:
    """Robust fusion rule base class."""

    name: str = ""
    summary: str = ""          # one line for a robust-rule table
    reduces = False            # replaces the weighted-mean reduction
    has_pre = False            # transforms the stacked cohort before fuse

    @property
    def active(self) -> bool:
        """False for identity-shortcut parameters (trimmed_mean(0),
        norm_clip(inf)): the engine drops the rule and runs the plain
        round."""
        return self.reduces or self.has_pre

    def describe(self) -> str:
        return self.name

    def reduce(self, x, w):
        """(N, ...) stacked values + (N,) nonnegative weights -> fused
        (...) (reducing rules only). Weights are renormalized inside."""
        raise NotImplementedError

    def pre(self, stacked, global_params):
        """Transform the stacked cohort (a (N, M_d) tensor per dtype
        segment) before the plain fuse (pre rules only)."""
        return stacked


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type[RobustRule]] = {}


def register(cls: type[RobustRule]) -> type[RobustRule]:
    """Class decorator: register ``cls`` under ``cls.name``."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    _REGISTRY[cls.name] = cls
    return cls


def available() -> tuple[str, ...]:
    """All registered rule names, sorted."""
    return tuple(sorted(_REGISTRY))


def get(name: str, param: float | None = None) -> RobustRule:
    """A fresh rule instance by registry name."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown robust rule {name!r}; available: "
            f"{', '.join(available())}") from None
    return cls() if param is None else cls(param)


_SPEC_RE = re.compile(
    r"^\s*([a-z_]+)\s*(?:\(\s*([-+0-9.eE]+|inf)\s*\))?\s*$")


def parse_robust(spec: str) -> RobustRule:
    """``"coordinate_median"`` / ``"trimmed_mean(0.2)"`` /
    ``"norm_clip(inf)"`` -> a validated rule instance."""
    m = _SPEC_RE.match(spec or "")
    if not m:
        raise ValueError(
            f"bad robust spec {spec!r}; expected NAME or NAME(PARAM), "
            f"e.g. 'coordinate_median' or 'trimmed_mean(0.2)'")
    name, param = m.group(1), m.group(2)
    return get(name, None if param is None else float(param))


# ---------------------------------------------------------------------------
# Weighted robust statistics
# ---------------------------------------------------------------------------


def _sorted_cumweights(x: torch.Tensor, w):
    """Per-coordinate stable sort of the client axis: (N, m) fp32 values
    + (N,) weights normalized to sum 1 -> (sorted values, per-coordinate
    sorted weights, their cumulative sum)."""
    xs, order = torch.sort(x, dim=0, stable=True)
    ws = w[order]
    return xs, ws, torch.cumsum(ws, dim=0)


def _by_columns(stat, x: torch.Tensor, w):
    """``stat(values, weights)`` of each coordinate of ``x`` (N, ...)
    over axis 0, on an fp32 copy of at most ``SORT_CHUNK`` columns at a
    time, the result in ``x``'s dtype. Each coordinate's statistic reads
    only its own column, so the chunks compute the bits of one pass over
    every column."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    w = torch.as_tensor(w, dtype=torch.float32, device=x.device)
    w = w / w.sum()
    m = flat.shape[1]
    out = torch.empty(m, dtype=x.dtype, device=x.device)
    for lo in range(0, m, SORT_CHUNK):
        c = slice(lo, lo + SORT_CHUNK)
        out[c] = stat(flat[:, c].to(torch.float32), w)
    return out.reshape(x.shape[1:])


def _median(flat, w):
    xs, _, cw = _sorted_cumweights(flat, w)
    reached = (cw >= 0.5 * cw[-1:]).to(torch.uint8)
    idx = torch.argmax(reached, dim=0)       # the first coordinate reached
    return torch.gather(xs, 0, idx[None])[0]


def weighted_median(x: torch.Tensor, w) -> torch.Tensor:
    """Lower weighted median over axis 0, per coordinate: the smallest
    value whose cumulative weight reaches half the total. Always an
    input value."""
    return _by_columns(_median, x, w)


def trimmed_mean(x: torch.Tensor, w, beta: float) -> torch.Tensor:
    """Weighted beta-trimmed mean over axis 0, per coordinate: drop the
    lowest and highest ``beta`` weight mass and divide the rest by
    1 - 2*beta. Each client's effective weight is the overlap of its
    cumulative interval with [beta, 1-beta]; beta=0 is the weighted
    mean."""
    lo, hi = float(beta), 1.0 - float(beta)

    def stat(flat, w):
        xs, ws, cw = _sorted_cumweights(flat, w)
        eff = (cw.clamp(max=hi) - (cw - ws).clamp(min=lo)).clamp(min=0.0)
        # the clients' terms added in sorted order, one row at a time: a
        # library sum may order them by the chunk's width
        out = xs[0] * eff[0]
        for i in range(1, xs.shape[0]):
            out = out + xs[i] * eff[i]
        return out / (hi - lo)
    return _by_columns(stat, x, w)


def clip_deltas(stacked, global_params, tau: float):
    """Per-client whole-model L2 clip of the update delta: row i's delta
    y_i - g is scaled by min(1, tau/||y_i - g||_2), the norm taken over
    the whole row (every leaf jointly, as the JAX package's per-leaf sum
    of squares does). ``stacked`` and ``global_params`` are flat values
    (one tensor per dtype segment): the norm adds each segment's fp32
    sum of squares, and each segment's delta is scaled in its dtype."""
    deltas = tree_map(lambda y, g: y - g[None].to(y.dtype), stacked,
                      global_params)
    sq = 0
    for d in flat_parts(deltas):
        sq = sq + torch.square(d.to(torch.float32)).reshape(
            d.shape[0], -1).sum(1)
    norm = torch.sqrt(sq)
    scale = torch.clamp(tau / torch.clamp(norm, min=1e-12), max=1.0)

    def unclip(d, g):
        s = scale.reshape((-1,) + (1,) * (d.dim() - 1)).to(d.dtype)
        return g[None].to(d.dtype) + d * s
    return tree_map(unclip, deltas, global_params)


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


@register
class CoordinateMedian(RobustRule):
    """Coordinate-wise (lower) weighted median, breakdown point 1/2."""
    name = "coordinate_median"
    summary = "per-coordinate weighted median, breakdown point 1/2"
    reduces = True

    def __init__(self, param: float | None = None):
        if param is not None:
            raise ValueError(
                f"coordinate_median takes no parameter; got "
                f"coordinate_median({param:g})")

    def reduce(self, x, w):
        return weighted_median(x, w)


@register
class TrimmedMean(RobustRule):
    """Weighted beta-trimmed mean. ``trimmed_mean(0)`` is the weighted
    mean exactly (identity shortcut: the engine runs the plain round)."""
    name = "trimmed_mean"
    summary = "per-coordinate weighted mean after trimming beta per tail"

    def __init__(self, beta: float = 0.1):
        beta = float(beta)
        if not 0.0 <= beta < 0.5:
            raise ValueError(
                f"trimmed_mean beta must be in [0, 0.5); got {beta:g} "
                "(0.5 would trim all mass; use coordinate_median)")
        self.beta = beta
        self.reduces = beta > 0.0

    def describe(self) -> str:
        return f"trimmed_mean({self.beta:g})"

    def reduce(self, x, w):
        return trimmed_mean(x, w, self.beta)


@register
class NormClip(RobustRule):
    """Whole-model update-norm clipping before the method's own fusion.
    ``norm_clip(inf)`` clips nothing (identity shortcut)."""
    name = "norm_clip"
    summary = "per-client whole-tree delta L2-clipped to tau before fuse"

    def __init__(self, tau: float = 10.0):
        tau = float(tau)
        if not tau > 0.0:
            raise ValueError(f"norm_clip tau must be > 0; got {tau:g}")
        self.tau = tau
        self.has_pre = math.isfinite(tau)

    def describe(self) -> str:
        return f"norm_clip({self.tau:g})"

    def pre(self, stacked, global_params):
        return clip_deltas(stacked, global_params, self.tau)
