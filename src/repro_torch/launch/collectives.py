"""The collectives of a mesh of ranks, over ``torch.distributed``.

The reference leaves its collectives to GSPMD (the fusion's mean over
the sharded cohort axis lowers to one all-reduce) and to ``jax.lax``
inside ``shard_map`` (the expert-parallel MoE's ``all_to_all``). The
port names them: each takes a tensor, the ``launch/mesh.RankMesh`` and
one of its axes, and runs over that axis's line of ranks (the ranks
that differ from this one only on that axis). On an axis of size 1 each
is the identity and runs nothing.

- ``all_reduce``: the sum over the line, in place;
- ``all_to_all``: the reference's ``lax.all_to_all(x, axis, 0, 0,
  tiled=False)``: the leading dimension (the axis's size) split in
  chunks, chunk j sent to the rank at coordinate j; chunk i of the
  result came from the rank at coordinate i;
- ``all_gather``: every rank's tensor, stacked in coordinate order;
- ``all_gather_rows``: the blocks of rows of one tensor split over the
  axis as ``launch/mesh.data_block`` splits them (unequal blocks
  travel padded to the longest), joined in coordinate order.

The backend decides how a tensor travels, never a failure: with
``nccl`` tensors go as they are; with ``gloo`` a CUDA tensor goes
through a host copy and back. Every call is counted on the mesh
(``mesh.counts``) by kind: calls, the bytes of this rank's tensor, and
the bytes staged through the host (copied down plus copied back).
"""
from __future__ import annotations

import dataclasses

import torch

KINDS = ("all_reduce", "all_to_all", "all_gather")


@dataclasses.dataclass
class Counts:
    """Collectives run by one rank, by kind: ``calls``, ``bytes`` (this
    rank's tensor) and ``staged`` (bytes through the host)."""
    calls: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    bytes: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    staged: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))

    def add(self, kind: str, nbytes: int, staged: int) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += nbytes
        self.staged[kind] += staged

    def reset(self) -> None:
        for d in (self.calls, self.bytes, self.staged):
            for k in d:
                d[k] = 0

    def as_dict(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "staged": dict(self.staged)}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _staged(mesh, t: torch.Tensor) -> bool:
    """Whether ``t`` goes through a host copy: a CUDA tensor on gloo."""
    return mesh.backend == "gloo" and t.is_cuda


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes (its last dimension times its element
    size): the exchanges only move data, so every dtype travels as
    uint8, which every backend carries (gloo has no int16, for one)."""
    return t.view(torch.uint8)


def all_reduce(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``t`` summed over ``axis``'s line of ranks, in place."""
    import torch.distributed as dist
    group = mesh.group(axis)
    if group is None:
        return t
    buf = t.cpu() if _staged(mesh, t) else t
    dist.all_reduce(buf, group=group)
    if buf is not t:
        t.copy_(buf)
    mesh.counts.add("all_reduce", _nbytes(t),
                    2 * _nbytes(t) if buf is not t else 0)
    return t


def all_to_all(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The exchange of ``t``'s leading chunks over ``axis`` (its leading
    dimension is the axis's size): a new tensor whose chunk i is chunk
    ``coord`` of the rank at coordinate i."""
    import torch.distributed as dist
    group = mesh.group(axis)
    if group is None:
        return t
    if t.shape[0] != mesh.shape[axis]:
        raise ValueError(f"all_to_all over {axis!r} of size "
                         f"{mesh.shape[axis]}: leading dimension "
                         f"{t.shape[0]}")
    src = t.contiguous()
    staged = _staged(mesh, src)
    if staged:
        src = src.cpu()
    wire = _bytes(src)
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    out = out.view(src.dtype)
    if staged:
        out = out.to(t.device)
    mesh.counts.add("all_to_all", _nbytes(t),
                    2 * _nbytes(t) if staged else 0)
    return out


def all_gather(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, stacked in coordinate order:
    (axis size, *t.shape)."""
    import torch.distributed as dist
    group = mesh.group(axis)
    if group is None:
        return t[None]
    src = t.contiguous()
    staged = _staged(mesh, src)
    if staged:
        src = src.cpu()
    wire = _bytes(src)
    parts = [torch.empty_like(wire) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, wire, group=group)
    out = torch.stack(parts).view(src.dtype)
    if staged:
        out = out.to(t.device)
    mesh.counts.add("all_gather", _nbytes(t),
                    _nbytes(t) + _nbytes(out) if staged else 0)
    return out


def all_gather_rows(t: torch.Tensor, mesh, axis: str, n: int) -> torch.Tensor:
    """The ``n`` rows of a tensor split over ``axis`` in
    ``np.array_split``'s blocks (``launch/mesh.data_block``), this rank
    holding its block ``t``: the whole (n, ...) tensor, the blocks in
    coordinate order. One ``all_gather`` of ``ceil(n / size)`` rows a
    rank, a shorter block padded with zeros that are then dropped."""
    if mesh.group(axis) is None:
        return t
    base, extra = divmod(n, mesh.shape[axis])
    longest = base + (extra > 0)
    if t.shape[0] < longest:
        t = torch.cat([t, t.new_zeros((longest - t.shape[0],)
                                      + t.shape[1:])])
    g = all_gather(t, mesh, axis)
    return torch.cat([g[i, :base + (i < extra)]
                      for i in range(mesh.shape[axis])])
