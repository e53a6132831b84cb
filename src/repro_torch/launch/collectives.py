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
- ``all_gather_rows``: the rows of one tensor split over the axis,
  joined in slot order: as ``launch/mesh.data_block`` splits them
  (contiguous blocks in coordinate order), or as an ``owner`` vector
  says (each slot's coordinate, as an async event's rows lie: a rank
  holds the slots it owns, in ascending order); unequal shares travel
  padded to the longest;
- ``barrier``: every rank of the mesh waits for the others (an FL
  checkpoint is published before any rank goes on).

The backend decides how a tensor travels, never a failure: with
``nccl`` tensors go as they are; with ``gloo`` a CUDA tensor goes
through a host copy and back. A dry mesh (``launch/mesh.
make_dry_rank_mesh``: no process group) takes the no-wire branch: each
call touches nothing of ``torch.distributed`` and returns a tensor of
the result's shape and dtype on the input's device (the input itself
for the all-reduce, ``empty_like`` for the all-to-all, this rank's
tensor repeated for the all-gather). Every call is counted on the mesh
(``mesh.counts``) by kind, on either branch alike: calls, the bytes of
this rank's tensor, the bytes of the result buffer, and the bytes
staged through the host (copied down plus copied back: ``staged_bytes``
when the tensor is staged). The three exchanges are always listed; a
barrier (no bytes) only once one has run since the last reset.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

KINDS = ("all_reduce", "all_to_all", "all_gather")


def _zeros() -> dict:
    return dict.fromkeys(KINDS, 0)


@dataclasses.dataclass
class Counts:
    """Collectives run by one rank, by kind: ``calls``, ``bytes`` (this
    rank's tensor), ``result`` (the result buffer's bytes: the tensor's
    for an all-reduce or an all-to-all, the axis size times it for an
    all-gather; what XLA's dry-run sums) and ``staged`` (bytes through
    the host)."""
    calls: dict = dataclasses.field(default_factory=_zeros)
    bytes: dict = dataclasses.field(default_factory=_zeros)
    staged: dict = dataclasses.field(default_factory=_zeros)
    result: dict = dataclasses.field(default_factory=_zeros)

    def add(self, kind: str, nbytes: int, staged: int,
            result: int) -> None:
        for d, n in ((self.calls, 1), (self.bytes, nbytes),
                     (self.staged, staged), (self.result, result)):
            d[kind] = d.get(kind, 0) + n

    def reset(self) -> None:
        for d in (self.calls, self.bytes, self.staged, self.result):
            d.clear()
            d.update(_zeros())

    def as_dict(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "staged": dict(self.staged), "result": dict(self.result)}


# XLA's collective kinds as the reference's records name them, each
# beside the port's kind (None: the port never issues it)
XLA_KINDS = (("all-reduce", "all_reduce"), ("all-gather", "all_gather"),
             ("reduce-scatter", None), ("all-to-all", "all_to_all"),
             ("collective-permute", None))


def by_xla_kind(counts: Counts) -> tuple:
    """A dry-run record's ``collectives`` and ``collectives_staged`` of
    one rank's ``counts``, by XLA's kinds: {kind: {"bytes": result
    bytes, "count": calls}} and {kind: the bytes gloo stages when the
    tensors are CUDA tensors}. A barrier is no XLA kind and is left
    out."""
    coll, staged = {}, {}
    for xla, kind in XLA_KINDS:
        coll[xla] = {"bytes": counts.result[kind] if kind else 0,
                     "count": counts.calls[kind] if kind else 0}
        staged[xla] = (staged_bytes(counts.bytes[kind], counts.result[kind])
                       if kind else 0)
    return coll, staged


def staged_bytes(nbytes: int, result: int) -> int:
    """What ``gloo`` stages through the host for a CUDA tensor of
    ``nbytes`` whose result buffer holds ``result``: the tensor copied
    down, the result copied back."""
    return nbytes + result


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
    nbytes = result = _nbytes(t)
    if mesh.dry:
        mesh.counts.add("all_reduce", nbytes, 0, result)
        return t
    buf = t.cpu() if _staged(mesh, t) else t
    dist.all_reduce(buf, group=group)
    if buf is not t:
        t.copy_(buf)
    mesh.counts.add("all_reduce", nbytes, staged_bytes(nbytes, result)
                    if buf is not t else 0, result)
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
    nbytes = result = _nbytes(t)
    if mesh.dry:
        mesh.counts.add("all_to_all", nbytes, 0, result)
        return torch.empty_like(t)
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
    mesh.counts.add("all_to_all", nbytes,
                    staged_bytes(nbytes, result) if staged else 0, result)
    return out


def all_gather(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, stacked in coordinate order:
    (axis size, *t.shape)."""
    import torch.distributed as dist
    group = mesh.group(axis)
    if group is None:
        return t[None]
    size = mesh.shape[axis]
    nbytes = _nbytes(t)
    result = size * nbytes
    if mesh.dry:
        mesh.counts.add("all_gather", nbytes, 0, result)
        return t[None].repeat((size,) + (1,) * t.dim())
    src = t.contiguous()
    staged = _staged(mesh, src)
    if staged:
        src = src.cpu()
    wire = _bytes(src)
    parts = [torch.empty_like(wire) for _ in range(size)]
    dist.all_gather(parts, wire, group=group)
    out = torch.stack(parts).view(src.dtype)
    if staged:
        out = out.to(t.device)
    mesh.counts.add("all_gather", nbytes,
                    staged_bytes(nbytes, result) if staged else 0, result)
    return out


def all_gather_rows(t: torch.Tensor, mesh, axis: str, n: int,
                    owner=None) -> torch.Tensor:
    """The ``n`` rows of a tensor split over ``axis``, this rank holding
    its share ``t``: the whole (n, ...) tensor in slot order. The shares
    are ``np.array_split``'s blocks (``launch/mesh.data_block``), or,
    with ``owner`` (n,), the coordinate that holds each slot: a rank's
    share is the slots it owns, in ascending order. One ``all_gather``
    of the longest share's rows a rank, a shorter share padded with
    zeros that are then dropped."""
    if mesh.group(axis) is None:
        return t
    size = mesh.shape[axis]
    if owner is None:             # np.array_split's blocks
        base, extra = divmod(n, size)
        owner = np.repeat(np.arange(size), [base + (i < extra)
                                            for i in range(size)])
    owner = np.asarray(owner)
    if owner.shape != (n,):
        raise ValueError(f"owner {owner.shape} for {n} rows")
    held = np.bincount(owner, minlength=size)
    if t.shape[0] != held[mesh.coord(axis)]:
        raise ValueError(f"this rank holds {held[mesh.coord(axis)]} of the "
                         f"{n} rows, got {t.shape[0]}")
    longest = int(held.max())
    if t.shape[0] < longest:
        t = torch.cat([t, t.new_zeros((longest - t.shape[0],)
                                      + t.shape[1:])])
    g = all_gather(t, mesh, axis)
    # slot s is row (its rank's slots before s) of its rank's share
    pos = np.zeros(n, np.int64)
    for i in range(size):
        pos[owner == i] = np.arange(held[i])
    return g[torch.as_tensor(owner, device=g.device),
             torch.as_tensor(pos, device=g.device)]


def barrier(mesh) -> None:
    """Every rank of ``mesh`` waits until all have arrived (the default
    process group's ``barrier``); nothing on a mesh of one rank, and on
    a dry mesh only the count."""
    import torch.distributed as dist
    if mesh is None or mesh.size == 1:
        return
    if not mesh.dry:
        dist.barrier()
    mesh.counts.add("barrier", 0, 0, 0)
