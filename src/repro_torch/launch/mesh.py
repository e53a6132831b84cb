"""Device meshes: plain descriptions, meshes of ranks, and the card's
own rates.

The reference's ``repro.launch.mesh`` builds ``jax`` meshes over TPU
chips. Its dry-run needs only what a mesh says: its axes, their sizes,
and so the chips. A ``Mesh`` holds exactly that, so the sharding rules
(``launch/sharding.py``) run on the reference's production shapes with
no device at all; ``make_host_mesh`` is the reference's (1, 1) host
mesh, which needs no process group (a run on it is a one-process run).

A ``RankMesh`` is a mesh the port runs on: the ranks of an initialised
``torch.distributed`` process group laid out row-major over the axes
("data", "model") as ``jax.make_mesh`` lays out devices, with this
rank's coordinate on each axis and one process group per axis line (the
ranks that differ only in that axis's coordinate), the backend and this
rank's device. Its collectives are ``launch/collectives.py``'s, counted
on the mesh. ``spawn`` starts one process per rank (the ``spawn`` start
method, a ``file://`` store in a temporary directory) and returns each
rank's result: several ranks may share one card over ``gloo``.

``make_dry_rank_mesh`` gives one rank's view of such a mesh with no
process group at all (``dry``): its collectives take the no-wire
branch, which only counts, so the dry-runs run rank 0's program on
``meta`` and read what it would move, without touching
``torch.distributed``: launch/fl_dryrun.py a round's, launch/dryrun.py
the sharded prefill or decode step's (a (2, 16, 16) production mesh
folds its "pod" and "data" axes into one "data" line of 32 there).
"""
from __future__ import annotations

import dataclasses
import math
import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback

import numpy as np
import torch

from repro_torch.launch.collectives import Counts

# one NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, as
# ``nvidia-smi --query-gpu=name,power.limit`` prints it: "NVIDIA H100
# 80GB HBM3, 700.00 W". Dense peaks, no sparsity.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, tensor cores
PEAK_FLOPS_FP32 = 67e12         # FLOP/s
HBM_BW = 3.35e12                # B/s, HBM3

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names, in order, and their sizes (``shape[name]``)."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


@dataclasses.dataclass(frozen=True, eq=False)
class RankMesh(Mesh):
    """This rank's view of a mesh of ``torch.distributed`` ranks:
    ``coords`` its coordinate on each axis and ``groups`` its line's
    process group along each axis (None for an axis of size 1), in axis
    order; ``counts`` the collectives it ran (``launch/collectives.py``);
    ``dry`` a mesh with no process group (``make_dry_rank_mesh``)."""
    rank: int = 0
    coords: tuple = ()
    groups: tuple = ()
    backend: str = "gloo"
    device: torch.device = torch.device("cpu")
    counts: Counts = dataclasses.field(default_factory=Counts)
    dry: bool = False

    def coord(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups[self.axis_names.index(axis)]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(AXES, (16, 16))


def make_host_mesh() -> Mesh:
    """One device: the (1, 1) mesh of a single card."""
    return Mesh(AXES, (1, 1))


def batch_axes(mesh: Mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def mesh_chips(mesh: Mesh) -> int:
    return mesh.size


def data_block(n: int, mesh) -> tuple:
    """This rank's block [lo, hi) of ``n`` items split over the mesh's
    "data" ranks as ``np.array_split`` splits them (the first ``n mod
    |data|`` blocks one longer): (0, n) without a mesh of more than one
    rank. The cohort rows of a round (fl/engine.py) and the eval tiles
    (fl/evaluation.py) split so."""
    if mesh is None or mesh.size == 1:
        return 0, n
    if not isinstance(mesh, RankMesh):
        raise TypeError(f"a mesh of {mesh.size} devices runs as ranks: "
                        "pass this rank's launch.mesh.RankMesh")
    parts, i = mesh.shape["data"], mesh.coord("data")
    if n < parts:
        raise ValueError(f"{n} rows do not split over {parts} data ranks")
    base, extra = divmod(n, parts)
    lo = i * base + min(i, extra)
    return lo, lo + base + (i < extra)


def data_owner(n: int, mesh) -> np.ndarray:
    """(n,) int64: the "data" coordinate whose ``data_block`` holds each
    of ``n`` items (all 0 without a mesh of more than one rank)."""
    if mesh is None or mesh.size == 1:
        return np.zeros(n, np.int64)
    parts = mesh.shape["data"]
    base, extra = divmod(n, parts)
    return np.repeat(np.arange(parts, dtype=np.int64),
                     [base + (i < extra) for i in range(parts)])


def make_rank_mesh(shape: tuple, *, device) -> RankMesh:
    """The ("data", "model") mesh of ``shape`` over the ranks of the
    initialised default process group (its world size must be the
    mesh's size): rank r sits at r's row-major coordinate, and every
    axis line gets its process group (``dist.new_group``, made in the
    same order on every rank, as it requires). ``device``: this rank's
    device."""
    import torch.distributed as dist
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(AXES):
        raise ValueError(f"mesh shape {shape} for axes {AXES}")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    n_data, n_model = shape
    # the ranks that share a model coordinate, then those that share a
    # data coordinate
    lines = ([[d * n_model + m for d in range(n_data)]
              for m in range(n_model)],
             [[d * n_model + m for m in range(n_model)]
              for d in range(n_data)])
    groups = []
    for size, axis_lines in zip(shape, lines):
        mine = None
        for line in axis_lines if size > 1 else ():
            g = dist.new_group(line)
            if rank in line:
                mine = g
        groups.append(mine)
    return RankMesh(AXES, shape, rank=rank, coords=divmod(rank, n_model),
                    groups=tuple(groups), backend=dist.get_backend(),
                    device=torch.device(device))


class _DryGroup:
    """The group of an axis line on a dry mesh: it names no ranks, and
    nothing of ``torch.distributed`` ever receives it."""

    def __repr__(self) -> str:
        return "DRY_GROUP"


DRY_GROUP = _DryGroup()


def make_dry_rank_mesh(shape: tuple, rank: int, *, device) -> RankMesh:
    """Rank ``rank``'s view of the ("data", "model") mesh of ``shape``
    with no process group: its coordinates, axes and sizes are those
    ``make_rank_mesh`` gives it, every axis of size > 1 holds the
    sentinel ``DRY_GROUP``, and the mesh is ``dry``, so its collectives
    count and move nothing. It needs no ``torch.distributed`` state and
    leaves none behind. ``device``: where its program runs (``meta``
    for the dry-run)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(AXES):
        raise ValueError(f"mesh shape {shape} for axes {AXES}")
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} of a {shape} mesh")
    return RankMesh(AXES, shape, rank=rank, coords=divmod(rank, shape[1]),
                    groups=tuple(DRY_GROUP if s > 1 else None
                                 for s in shape),
                    backend="dry", device=torch.device(device), dry=True)


def rank_device(device, rank: int) -> torch.device:
    """A rank's device: ``"cuda"`` is card ``rank mod cards`` (every rank
    on card 0 of a one-card machine); anything else as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def _rank_main(rank, shape, backend, device, store, call, results):
    """One spawned rank: join the group, build its mesh, run the ``(fn,
    args)`` pickled in the file ``call`` and send back its pickled result
    (or its traceback)."""
    import torch.distributed as dist
    try:
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        # the ranks share the host: each gets its share of the cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // math.prod(shape)))
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=math.prod(shape), rank=rank)
        mesh = make_rank_mesh(shape, device=dev)
        out = pickle.dumps(fn(mesh, *args))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))
    dist.destroy_process_group()


def spawn(fn, shape: tuple, *, backend: str, device, args: tuple = (),
          timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a ``shape`` ("data",
    "model") mesh, one process a rank, and return the ranks' results in
    rank order.

    The processes start with the ``spawn`` method and meet through a
    ``file://`` store in a fresh temporary directory, so concurrent
    groups never share a port; ``fn`` (by import path) and ``args`` (by
    value) are pickled once into a file there, which every rank reads.
    ``backend``: "gloo" (CPU tensors; CUDA tensors through a host
    buffer, ``launch/collectives.py``) or "nccl"; ``device``: "cpu",
    "cuda" (``rank_device``) or one named device for every rank. Each
    rank runs ``cpu_count() // ranks`` intra-op threads. A rank that
    raises or dies fails the call with its traceback, after every other
    rank is stopped; so does ``timeout`` seconds without an answer."""
    ctx = multiprocessing.get_context("spawn")
    world = math.prod(shape)
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_ranks_") as tmp:
        store, call = os.path.join(tmp, "store"), os.path.join(tmp, "call")
        with open(call, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, tuple(shape), backend,
                                   str(device), store, call, results))
                 for r in range(world)]
        try:
            for p in procs:
                p.start()
            got = _collect(procs, results, timeout)
            for p in procs:
                p.join(timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world)]


def _collect(procs, results, timeout: float) -> dict:
    """Every rank's unpickled result, by rank; raises on the first
    failure report, a rank that exits without one, or the timeout."""
    got, dead = {}, {}
    deadline = time.monotonic() + timeout
    while len(got) < len(procs):
        try:
            rank, ok, payload = results.get(timeout=0.5)
        except queue.Empty:
            now = time.monotonic()
            for r, p in enumerate(procs):
                # an exited rank's report may still be in the pipe: it
                # gets a few seconds to arrive
                if r not in got and p.exitcode is not None \
                        and now - dead.setdefault(r, now) > 5:
                    raise RuntimeError(f"rank {r} exited with code "
                                       f"{p.exitcode} and no result")
            if now > deadline:
                missing = sorted(set(range(len(procs))) - set(got))
                raise TimeoutError(f"ranks {missing} gave no result "
                                   f"within {timeout} s")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{payload}")
        got[rank] = pickle.loads(payload)
    return got
