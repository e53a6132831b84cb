"""Byzantine client attacks.

An attack is an ``Attack`` subclass registered by name, resolved from a
spec string (``parse_attack("sign_flip(4)")``). Two injection points,
chosen by the attack's capability flags:

- ``data_poisoning`` (label_flip): the attack corrupts a malicious
  client's BATCHES on the host, in ``runtime._pack_client_batches``
  after the rng draw, so the device round is the honest program.
- ``model_poisoning`` (sign_flip / scaled_update / gauss_noise): the
  attack transforms the malicious rows of the cohort's trained params
  after the local phase, in the local phase's dtype and before the cast
  back to the storage dtypes, selected by the cohort's malicious row
  (``mal > 0``): the honest rows are left as they are, so a cohort that
  samples no attacker computes the honest round bit for bit. A row is
  poisoned piece by piece (``FlatLayout.pieces``): each dtype segment of
  the cohort, or each run of one segment's leaves in the bf16 local
  phase's one shadow buffer of a tree that mixes dtypes, against the
  global's elements in their own dtype, as the JAX package poisons
  each leaf.

Attacker ASSIGNMENT is population metadata: ``assign_attackers`` flags a
seed-deterministic subset of logical client ids on
``Population.malicious`` with numpy, drawing the JAX package's ids to
the bit.

Noise (gauss_noise): the JAX package folds a jax key per (round, slot,
leaf), which torch cannot reproduce. The port draws each malicious
slot's noise for leaf ``i`` from a ``torch.Generator`` on the cohort's
device seeded with ``noise_seed(seed, round, slot, i)`` (the rule is
that function's; ``i`` counts the layout's slots in tree order, whatever
segment holds them). Its noise is therefore another draw of the same
distribution; the parity tests inject the JAX package's noise through
``poison_update(..., noise=...)`` or ``GaussNoise.leaf_noise``.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from repro_torch.models.module import flat_parts, tree_map

# dedicated rng stream offsets, as the JAX package's: attacker assignment
# and noise draws never collide with data partitioning (seed) or tier
# assignment (seed + 7331)
ASSIGN_SEED_OFFSET = 14407
NOISE_KEY_OFFSET = 9091


@dataclasses.dataclass(frozen=True)
class AttackSpec:
    """A parsed attack spec: registry name + optional strength parameter
    (``None`` = the attack class's default)."""
    name: str
    param: float | None = None

    def build(self) -> "Attack":
        return get(self.name, self.param)

    def describe(self) -> str:
        if self.param is None:
            return self.name
        return f"{self.name}({self.param:g})"


class Attack:
    """Byzantine behavior base class."""

    name: str = ""
    summary: str = ""          # one line for an attack table
    data_poisoning = False     # corrupts batches on the host
    model_poisoning = False    # transforms the trained cohort rows
    needs_rng = False          # poison_update draws noise
    default_param: float | None = None

    def __init__(self, param: float | None = None):
        if param is not None and self.default_param is None:
            raise ValueError(f"{self.name} takes no parameter; "
                             f"got {self.name}({param:g})")
        self.param = self.default_param if param is None else float(param)

    def poison_batch(self, batch, n_classes: int):
        """Corrupt one host-side step batch (data_poisoning only)."""
        raise NotImplementedError

    def poisoned(self, y, g, row: int, leaves, key, noise):
        """One malicious row's poisoned values over one piece
        (model_poisoning): ``y`` (n,) its trained values in the local
        phase's dtype, ``g`` (n,) the round's global over the same
        elements in their storage dtype, ``leaves`` the (layout slot
        index, offset in the piece, size) of each leaf in it, ``noise``
        an injected (n,) draw or None. The result is rounded to ``y``'s
        dtype when written."""
        raise NotImplementedError

    def poison_update(self, stacked, global_params, mal, key=None,
                      layout=None, noise=None, out=None, first: int = 0):
        """The cohort's trained params -> poisoned where the host row
        ``mal`` (C,) is > 0, the honest rows bit for bit.

        ``stacked``: a flat value of ``layout`` (a (C, M_d) tensor per
        dtype segment) in the local phase's dtype, or, for a tree that
        mixes dtypes, ONE raveled (C, M) buffer (the bf16 local phase's
        shadow); ``global_params`` the round's global, a flat value of
        ``layout`` in its storage dtypes; ``key`` = ``round_key(seed,
        round)``; ``noise`` an optional draw of ``stacked``'s form that
        replaces the port's own (gauss_noise). Only the malicious rows
        are computed, piece by piece (``FlatLayout.pieces``); they are
        written into ``out`` (which may be ``stacked`` itself), else
        into a copy of ``stacked``. ``first``: the cohort slot of
        ``stacked``'s row 0 (a rank's block of rows on a mesh, with
        ``mal`` its slice of the cohort's row): a row's noise is drawn
        for its cohort slot, the one-process draw."""
        rows = np.flatnonzero(np.asarray(mal, np.float32) > 0)
        if not len(rows):
            return stacked
        if out is None:
            out = tree_map(torch.clone, stacked)

        def pieces(x):
            if layout is None:
                return [(p, i, 0) for i, p in enumerate(flat_parts(x))]
            return layout.pieces(x)
        parts = pieces(out)
        drawn = [None] * len(parts) if noise is None else \
            [v for v, _, _ in pieces(noise)]
        gparts = flat_parts(global_params)
        for (view, seg, a), eps in zip(parts, drawn):
            n = view.shape[-1]
            g = gparts[seg][a:a + n]
            leaves = None if layout is None else layout.slots_in(seg, a, n)
            for r in rows:
                view[r] = self.poisoned(
                    view[r], g, first + int(r), leaves, key,
                    None if eps is None else eps[r])
        return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type[Attack]] = {}


def register(cls: type[Attack]) -> type[Attack]:
    """Class decorator: register ``cls`` under ``cls.name``."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    _REGISTRY[cls.name] = cls
    return cls


def available() -> tuple[str, ...]:
    """All registered attack names, sorted."""
    return tuple(sorted(_REGISTRY))


def get(name: str, param: float | None = None) -> Attack:
    """A fresh attack instance by registry name."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown attack {name!r}; available: "
            f"{', '.join(available())}") from None
    return cls(param)


_SPEC_RE = re.compile(
    r"^\s*([a-z_]+)\s*(?:\(\s*([-+0-9.eE]+)\s*\))?\s*$")


def parse_attack(spec: str) -> AttackSpec:
    """``"label_flip"`` / ``"sign_flip(4)"`` -> AttackSpec (validated
    against the registry; building checks the parameter)."""
    m = _SPEC_RE.match(spec or "")
    if not m:
        raise ValueError(
            f"bad attack spec {spec!r}; expected NAME or NAME(PARAM), "
            f"e.g. 'label_flip' or 'sign_flip(4)'")
    name, param = m.group(1), m.group(2)
    out = AttackSpec(name, None if param is None else float(param))
    out.build()                 # validates name + parameter eagerly
    return out


# ---------------------------------------------------------------------------
# Attacker assignment (population metadata)
# ---------------------------------------------------------------------------


def attacker_count(fraction, population: int) -> int:
    """``attack_fraction`` semantics: a value >= 1 is an explicit count,
    a value in (0, 1) a population fraction (rounded). At least one
    honest client must remain."""
    f = float(fraction)
    if f >= 1.0:
        if f != int(f):
            raise ValueError(
                f"attack_fraction >= 1 means an explicit attacker count "
                f"and must be an integer; got {fraction!r}")
        count = int(f)
    elif f > 0.0:
        count = int(round(f * population))
        if count == 0:
            raise ValueError(
                f"attack_fraction={f:g} flags zero clients at "
                f"population={population}; use an explicit count "
                f"(attack_fraction >= 1) to flag at least one")
    else:
        raise ValueError(
            f"attack_fraction must be positive (fraction in (0,1) or an "
            f"explicit count >= 1); got {fraction!r}")
    if count >= population:
        raise ValueError(
            f"attack_fraction={fraction!r} flags {count} of "
            f"{population} clients; at least one honest client must "
            "remain")
    return count


def assign_attackers(fraction, population: int, *, seed: int) -> np.ndarray:
    """Seed-deterministic (population,) bool attacker mask by logical
    client id, from its own numpy stream (seed + ASSIGN_SEED_OFFSET)."""
    count = attacker_count(fraction, population)
    rng = np.random.default_rng(seed + ASSIGN_SEED_OFFSET)
    mask = np.zeros(population, bool)
    mask[rng.permutation(population)[:count]] = True
    return mask


def round_key(seed: int, round_idx: int) -> tuple:
    """The per-round attack key: the noise stream (seed +
    NOISE_KEY_OFFSET) and the round index."""
    return (seed + NOISE_KEY_OFFSET, int(round_idx))


def noise_seed(key: tuple, slot: int, leaf: int) -> int:
    """The ``torch.Generator`` seed of cohort slot ``slot``'s noise for
    layout slot (leaf) ``leaf`` in the round of ``key``: the four
    integers (stream, round, slot, leaf) mixed by a 64-bit polynomial
    hash, distinct for every tuple a run meets."""
    h = 0
    for v in (*key, slot, leaf):
        h = (h * 1_000_003 + int(v) + 1) % (1 << 63)
    return h


# ---------------------------------------------------------------------------
# Attacks
# ---------------------------------------------------------------------------


@register
class LabelFlip(Attack):
    """Deterministic label flipping: a malicious client trains every
    sample against ``n_classes - 1 - label``. Pure data poisoning."""
    name = "label_flip"
    summary = "malicious shards train on n-1-y flipped labels"
    data_poisoning = True

    def poison_batch(self, batch, n_classes: int):
        labels = np.asarray(batch["labels"])
        return {**batch,
                "labels": (n_classes - 1 - labels).astype(labels.dtype)}


@register
class SignFlip(Attack):
    """Sign-flipping model poisoning, ``g - s*(y - g)``; the product is
    taken in the local phase's dtype and subtracted from the fp32
    global, as in the JAX package."""
    name = "sign_flip"
    summary = "malicious update mirrored through the global, g - s*(y-g)"
    model_poisoning = True
    default_param = 1.0

    def poisoned(self, y, g, row, leaves, key, noise):
        s = torch.tensor(self.param, dtype=torch.float32).to(y.dtype)
        return g - s * (y - g.to(y.dtype))


@register
class ScaledUpdate(Attack):
    """Update-scaling model poisoning, ``g + s*(y - g)``, in the local
    phase's dtype."""
    name = "scaled_update"
    summary = "malicious delta amplified s-fold, g + s*(y-g)"
    model_poisoning = True
    default_param = 10.0

    def poisoned(self, y, g, row, leaves, key, noise):
        s = torch.tensor(self.param, dtype=torch.float32).to(y.dtype)
        g = g.to(y.dtype)
        return g + s * (y - g)


@register
class GaussNoise(Attack):
    """Additive Gaussian noise poisoning, ``y + sigma * eps``, with one
    draw per (round, slot, leaf) (``noise_seed``)."""
    name = "gauss_noise"
    summary = "malicious update + sigma-scaled gaussian noise"
    model_poisoning = True
    needs_rng = True
    default_param = 1.0

    def leaf_noise(self, key, slot: int, leaf: int, size: int,
                   device) -> torch.Tensor:
        """The port's fp32 noise for layout slot ``leaf`` of cohort slot
        ``slot`` in the round of ``key``: (size,) standard normals from
        a generator on ``device`` seeded with ``noise_seed``."""
        gen = torch.Generator(device=device)
        gen.manual_seed(noise_seed(key, slot, leaf))
        return torch.randn(size, generator=gen, device=device)

    def poisoned(self, y, g, row, leaves, key, noise):
        dt = y.dtype
        if noise is None:
            noise = torch.empty(y.shape, dtype=torch.float32,
                                device=y.device)
            for i, off, n in leaves:
                noise[off:off + n] = self.leaf_noise(key, row, i, n,
                                                     y.device)
        sigma = torch.tensor(self.param, dtype=torch.float32).to(dt)
        return y + sigma * noise.to(dt)
