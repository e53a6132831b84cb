"""Composable uplink codecs.

A codec compresses the client-to-server uplink: each client's round
delta ``y_i - x`` (its trained params against the round's global) is
encoded, shipped and decoded BEFORE fusion (decode-then-fuse), so the
method's ``fuse`` and any robust rule wrapping it run on dense rows and
never learn a codec was involved. The engine applies
``codec.roundtrip(stacked, global, layout)`` between the local phase and
the fuse (fl/engine.py); ``bytes_per_client`` reports what a real
transport would move.

Registered codecs (spec grammar ``name`` or ``name(param)``):

- ``identity``  the dense uplink, byte-exact: ``roundtrip`` returns the
                stacked buffer untouched (never through the delta
                arithmetic: ``(y - x) + x != y`` in floats), so an
                identity-codec round is bit-identical to no codec.
- ``int8``      symmetric per-leaf-per-client quantization: scale =
                max|d|/127 (1.0 for an all-zero delta), q = round(d/scale)
                in int8 (round half to even, as ``jnp.round``).
- ``topk(f)``   magnitude sketch: per leaf, each client ships only the
                ceil(f * m) largest-|d| coordinates (values + int32
                indices); decode scatters into zeros.

Both lossy codecs work per leaf and per client. The port holds the
cohort as one flat (C, M_d) buffer per dtype segment, so a leaf is a
column range of its segment's buffer (a ``FlatLayout`` slot). A leaf's
max|d| and the set of its k largest |d| do not depend on the order of
its coordinates, so the port's OIHW conv weights give the JAX package's
HWIO result.

Dtypes: a delta is taken in its leaf's dtype and decoded in fp32, as in
the JAX package. Its ``roundtrip`` then returns global + decoded delta
in fp32 for every leaf, so a bf16 leaf comes back fp32 and the next
round's forward refuses the tree. The port computes the same values and
rounds each leaf back into its own dtype (a no-op for fp32 leaves), so
a tree that mixes dtypes keeps its dtypes and runs any number of
rounds.

Ties in ``topk``: the port takes the k largest |d| of a leaf by a
stable descending sort of its coordinates in the port's flat order, so
among equal |d| the lower flat index is kept, which is
``jax.lax.top_k``'s rule (``torch.topk`` on CUDA states no order for
ties, so it is not used). Shared leaves (dense, biases, norms) have the
same flat order in both packages and keep the same coordinates. A conv
weight's flat order differs (OIHW against HWIO): when its k-th and
(k+1)-th largest |d| tie, the two packages may keep different
coordinates of equal |d|. That is the only place they differ.

Eligibility lives in fl/compat.py (``check_codec_support``): decode-
then-fuse needs a device fuse and no client state, and reducing robust
rules refuse lossy codecs.
"""
from __future__ import annotations

import math
import re

import torch

from repro_torch.models.module import flat_parts, tree_leaves, tree_map


class UplinkCodec:
    """One uplink compression scheme over the flat cohort (a (C, M_d)
    buffer per dtype segment). ``roundtrip`` is what the engine runs;
    ``encode``/``decode`` are the transport-shaped halves (one entry per
    layout slot)."""

    name: str = ""
    summary: str = ""          # one line for a codec table
    exact = False              # decode(encode(d)) == d bit for bit

    def describe(self) -> str:
        return self.name

    def encode(self, deltas, layout) -> list:
        """Client deltas (a flat value of ``layout``) -> one encoded
        entry per layout slot."""
        raise NotImplementedError

    def decode(self, encoded: list, layout):
        """Encoded entries -> the delta reconstruction, a flat value of
        ``layout`` in fp32 (one (C, M_d) tensor per segment)."""
        raise NotImplementedError

    def roundtrip(self, stacked, global_params, layout):
        """What the server holds after decode: global + decoded deltas,
        computed in fp32 and rounded into each segment's dtype."""
        deltas = tree_map(lambda y, g: y - g[None].to(y.dtype), stacked,
                          global_params)
        dec = self.decode(self.encode(deltas, layout), layout)
        return tree_map(lambda d, g, y: (g[None].to(d.dtype) + d).to(
            y.dtype), dec, global_params, stacked)

    def bytes_per_client(self, param_tree) -> int:
        """Uplink bytes ONE client ships per round under this codec."""
        raise NotImplementedError


def _leaf_sizes(param_tree):
    for leaf in tree_leaves(param_tree):
        yield int(math.prod(leaf.shape)), leaf.element_size()


def _columns(deltas, layout):
    """Each layout slot's (C, size) columns of a flat value, in slot
    order."""
    parts = flat_parts(deltas)
    return [parts[s.segment][:, s.offset:s.offset + s.size]
            for s in layout.slots]


def _decoded(layout, like: torch.Tensor, fill):
    """A flat fp32 value of ``layout`` with ``like``'s rows and device,
    each segment's tensor made by ``fill`` (``torch.empty`` or
    ``torch.zeros``), and each slot's (C, size) columns of it."""
    out = layout.join(fill((like.shape[0], seg.size), dtype=torch.float32,
                           device=like.device) for seg in layout.segments)
    return out, _columns(out, layout)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type[UplinkCodec]] = {}


def register(cls: type[UplinkCodec]) -> type[UplinkCodec]:
    """Class decorator: register ``cls`` under ``cls.name``."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    _REGISTRY[cls.name] = cls
    return cls


def available() -> tuple[str, ...]:
    """All registered codec names, sorted."""
    return tuple(sorted(_REGISTRY))


def get(name: str, *args) -> UplinkCodec:
    """A fresh codec instance by registry name."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown uplink codec {name!r}; available: "
            f"{', '.join(available())}") from None
    return cls(*args)


_SPEC_RE = re.compile(r"^\s*([a-z0-9_]+)\s*(?:\(\s*([^)]*?)\s*\))?\s*$")


def parse_codec(spec: str) -> UplinkCodec:
    """``"identity"`` | ``"int8"`` | ``"topk(0.05)"`` -> instance."""
    m = _SPEC_RE.match(spec or "")
    if not m:
        raise ValueError(
            f"bad codec spec {spec!r}: expected name or name(param), "
            f"e.g. 'int8' or 'topk(0.05)'")
    name, arg = m.group(1), m.group(2)
    return get(name) if arg in (None, "") else get(name, float(arg))


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------


@register
class IdentityCodec(UplinkCodec):
    """The dense uplink: ``roundtrip`` returns the stacked buffer
    unchanged, so an identity-codec round is bit-identical to none."""
    name = "identity"
    summary = "dense uplink, byte-exact (bit-identical rounds)"
    exact = True

    def encode(self, deltas, layout):
        return _columns(deltas, layout)

    def decode(self, encoded, layout):
        return layout.join(
            torch.cat([e for s, e in zip(layout.slots, encoded)
                       if s.segment == i], dim=1)
            for i in range(len(layout.segments)))

    def roundtrip(self, stacked, global_params, layout):
        return stacked

    def bytes_per_client(self, param_tree) -> int:
        return sum(n * isz for n, isz in _leaf_sizes(param_tree))


@register
class Int8Codec(UplinkCodec):
    """Symmetric per-leaf-per-client int8 quantization of the delta:
    scale = max|d|/127 (1.0 when the delta is all zero), q =
    round(d/scale) in [-127, 127]. The decode error is at most scale/2
    per coordinate."""
    name = "int8"
    summary = "per-leaf symmetric int8 delta quantization (~4x uplink)"

    def encode(self, deltas, layout):
        out = []
        for cols in _columns(deltas, layout):
            d = cols.to(torch.float32)
            amax = d.abs().amax(dim=1, keepdim=True)
            scale = torch.where(amax > 0, amax / 127.0,
                                torch.ones_like(amax))
            q = torch.clamp(torch.round(d / scale), -127, 127).to(
                torch.int8)
            out.append({"q": q, "scale": scale})
        return out

    def decode(self, encoded, layout):
        out, cols = _decoded(layout, encoded[0]["q"], torch.empty)
        for col, e in zip(cols, encoded):
            col[:] = e["q"].to(torch.float32) * e["scale"]
        return out

    def bytes_per_client(self, param_tree) -> int:
        # 1 byte per coordinate + one f32 scale per leaf
        return sum(n * 1 + 4 for n, _ in _leaf_sizes(param_tree))


@register
class TopKCodec(UplinkCodec):
    """Magnitude sketch: per leaf, each client ships the ceil(frac * m)
    largest-|d| coordinates as (value, int32 index) pairs (ties: the
    lower flat index, see the module docstring); decode scatters into
    zeros. Exact on its support, zero off it."""
    name = "topk"
    summary = "per-leaf top-k(|delta|) sketch (values + indices uplink)"

    def __init__(self, frac: float = 0.05):
        if not (0.0 < frac <= 1.0):
            raise ValueError(
                f"topk codec fraction must be in (0, 1], got {frac!r}")
        self.frac = float(frac)

    def describe(self) -> str:
        return f"topk({self.frac:g})"

    def _k(self, m: int) -> int:
        return min(m, max(1, math.ceil(self.frac * m)))

    def encode(self, deltas, layout):
        out = []
        for cols in _columns(deltas, layout):
            d = cols.to(torch.float32)
            k = self._k(d.shape[1])
            idx = torch.sort(d.abs(), dim=1, descending=True,
                             stable=True).indices[:, :k]
            out.append({"vals": torch.gather(d, 1, idx),
                        "idx": idx.to(torch.int32)})
        return out

    def decode(self, encoded, layout):
        out, cols = _decoded(layout, encoded[0]["vals"], torch.zeros)
        for col, e in zip(cols, encoded):
            col.scatter_(1, e["idx"].long(), e["vals"])
        return out

    def bytes_per_client(self, param_tree) -> int:
        # 4 B value + 4 B int32 index per kept coordinate
        return sum(self._k(n) * 8 for n, _ in _leaf_sizes(param_tree))
