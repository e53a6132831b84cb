"""Client-state storage: the stores behind ``Population``, ragged shard
indices, and the Walker/Vose alias table.

The round math only ever touches the cohort's rows, so the population's
per-client state lives behind a store that moves exactly those rows
(the port of the JAX package's ``fl/statestore.py``):

- ``ClientStateStore``: the protocol. ``initialize`` broadcasts one
  client's round-0 row to population width, ``gather(ids)`` materializes
  the cohort's rows as host numpy, ``scatter(ids, rows)`` writes them
  back (numpy or torch rows). Stores are registered by name like the
  federated methods: ``register`` / ``get`` / ``available()``;
  ``FLConfig.store`` is validated against the registry.
- ``InMemoryStore`` (``"memory"``): one stacked ``(P, ...)`` host tree,
  rows written in place. O(P) RAM, no I/O; the default. bfloat16 rows
  (a bf16 Mamba-2's, whose flat rows are one buffer per dtype) stay CPU
  tensors: numpy has no bfloat16.
- ``MmapShardStore`` (``"mmap"``): the rows live on disk as chunked
  ``.npy`` shards, memory-mapped: ``gather`` copies out the cohort's
  rows, ``scatter`` writes them back through the maps and records the
  dirty shards, which an incremental checkpoint flushes alone
  (checkpoint/io.py). O(cohort) RAM. On a params tree that mixes
  dtypes it serves the client-stateless methods (their rows are empty;
  only the side arrays go to disk) and refuses a method with client
  rows (scaffold's control variates hold bfloat16 leaves, which numpy
  cannot map; the JAX package fails writing them too).
- On a mesh of ranks every rank keeps a whole replica of the
  population's rows (the sync round hands every rank the whole cohort's
  new rows) in a store of its own: an ``mmap`` store built with
  ``rank=r`` maps ``<dir>/rank<r>`` (or a temporary directory of its
  own), so two ranks never write one shard file.
- ``ShardIndices``: the ragged per-client sample indices
  (``Population.parts``) as one flat array and offsets, which
  ``MmapShardStore.offload_aux`` maps from disk with the weights and
  presence rows.

A port row is what ``RoundEngine.init_client_row`` gives: scaffold's
control variate as one flat ``(M,)`` vector of the engine's
``FlatLayout``; the reference keeps a params tree per client. The
working shards hold the port's rows (one file per row leaf and chunk),
so a gather reads one contiguous block per touched shard. The
reference's format appears only where files leave the store: the
checkpoint shard files and ``layout()`` are the reference's, one per
reference leaf in its order with conv leaves HWIO
(``convert.flat_to_reference``), so either package restores the
other's checkpoint.

``AliasTable`` (Walker's method) is the weighted sampler's backend
(fl/population.py): O(P) build once per weights array, O(1) per draw,
rejection for cohorts drawn without replacement. It draws with numpy
only, in the reference's order, so the same weights and rng give the
same ids in both packages.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.models.module import (dtype_names, host, tree_leaves,
                                       tree_leaves_with_path, tree_map,
                                       tree_unflatten)


def _broadcast_rows(a, population: int):
    """One row leaf broadcast to ``population`` C-ordered host rows:
    numpy, or a CPU tensor for a dtype numpy lacks (bfloat16)."""
    if isinstance(a, torch.Tensor):
        return a[None].expand((population,) + tuple(a.shape)).contiguous()
    return np.ascontiguousarray(np.broadcast_to(
        np.asarray(a)[None], (population,) + np.shape(a)))


# ---------------------------------------------------------------------------
# Ragged shard indices: P clients' sample ids as flat + offsets
# ---------------------------------------------------------------------------


class ShardIndices:
    """Per-client sample-index shards as ONE flat int64 array plus an
    (P+1,) offsets array: client i's shard is
    ``flat[offsets[i]:offsets[i+1]]``. Supports the accesses the runtime
    makes of ``Population.parts`` (``len(parts)``, ``parts[i]``) at O(P)
    ints (mmap-able) instead of P python array objects."""

    __slots__ = ("flat", "offsets")

    def __init__(self, flat: np.ndarray, offsets: np.ndarray):
        self.flat = flat
        self.offsets = offsets

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i) -> np.ndarray:
        return self.flat[self.offsets[i]:self.offsets[i + 1]]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    @classmethod
    def from_parts(cls, parts) -> "ShardIndices":
        if isinstance(parts, cls):
            return parts
        offsets = np.zeros(len(parts) + 1, np.int64)
        np.cumsum([len(p) for p in parts], out=offsets[1:])
        flat = (np.concatenate([np.asarray(p, np.int64) for p in parts])
                if offsets[-1] else np.zeros(0, np.int64))
        return cls(flat, offsets)

    @classmethod
    def striped(cls, n_samples: int, population: int) -> "ShardIndices":
        """Round-robin striping of ``n_samples`` over ``population``
        clients (client i holds samples {j : j = i mod P}): the cheap
        synthetic partition of million-client runs, two vectorized ops
        instead of P python loops. Clients past the sample count hold
        empty shards (batch packing indexes sample 0 for them, as for
        any empty shard)."""
        counts = np.full(population, n_samples // population, np.int64)
        counts[:n_samples % population] += 1
        offsets = np.zeros(population + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        flat = np.argsort(np.arange(n_samples, dtype=np.int64) % population,
                          kind="stable").astype(np.int64)
        return cls(flat, offsets)


# ---------------------------------------------------------------------------
# Store protocol + registry (mirrors fl/methods.py)
# ---------------------------------------------------------------------------


class ClientStateStore:
    """Storage protocol behind ``Population``'s per-client method state.

    ``in_memory`` gates the runtime's whole-population fast path (the
    state may live as device tensors between rounds); ``incremental``
    advertises dirty-shard flushing to ``save_fl_checkpoint``
    (checkpoint/io.py duck-types on it)."""

    name: str = ""
    summary: str = ""          # one line for the README store table
    in_memory: bool = True
    incremental: bool = False

    def initialize(self, row_tree, population: int, layout=None,
                   method: str | None = None) -> None:
        """Broadcast ONE client's round-0 row tree (host numpy,
        ``RoundEngine.init_client_row``) to population width. ``layout``
        is the engine's ``FlatLayout``: a row leaf of its M is a flat
        params vector (None: every leaf is its own array). ``method``
        names whose rows these are, for a refusal."""
        raise NotImplementedError

    def gather(self, ids) -> Any:
        """Rows ``ids`` -> a stacked (len(ids), ...) host numpy tree."""
        raise NotImplementedError

    def scatter(self, ids, rows) -> None:
        """Write stacked rows (numpy or torch) back to ``ids``; untouched
        rows keep their values bit for bit."""
        raise NotImplementedError

    @property
    def tree(self) -> Any:
        """The full (P, ...) stacked tree (``Population.clients``). Only
        in-memory stores can afford this."""
        raise NotImplementedError

    def adopt(self, stacked) -> None:
        """Take ownership of a full (P, ...) stack (the whole-population
        fast path and checkpoint restore hand stacks back)."""
        raise NotImplementedError

    def offload_aux(self, pop) -> None:
        """Optionally take over the population's parts/weights/presence
        storage (out-of-core stores push them to disk)."""

    def close(self) -> None:
        """Release resources (out-of-core stores drop their scratch
        dir). The store is dead afterwards."""


_REGISTRY: dict[str, type[ClientStateStore]] = {}


def register(cls: type[ClientStateStore]) -> type[ClientStateStore]:
    """Class decorator: register ``cls`` under ``cls.name``."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    _REGISTRY[cls.name] = cls
    return cls


def available() -> tuple[str, ...]:
    """All registered store names, sorted (the CLI's choices, the README
    store table, FLConfig validation)."""
    return tuple(sorted(_REGISTRY))


def get(name: str, **kwargs) -> ClientStateStore:
    """Construct a fresh store instance by registry name."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown client-state store {name!r}; available: "
            f"{', '.join(available())}") from None
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# InMemoryStore: stacked host rows
# ---------------------------------------------------------------------------


@register
class InMemoryStore(ClientStateStore):
    """Stacked ``(P, ...)`` host arrays, scatter writes rows IN PLACE.
    On the whole-population fast path the runtime hands it the engine's
    device tensors (``adopt``); a later scatter copies such a tree to
    the host once. O(P) RAM; the default store."""

    name = "memory"
    summary = "stacked (P, ...) host arrays, in-place row writes; O(P) RAM"
    in_memory = True
    incremental = False

    def __init__(self, chunk_size: int | None = None, dir: str | None = None,
                 rank: int | None = None):
        # chunk_size/dir/rank accepted for constructor parity with the
        # out-of-core store; none applies here
        self._tree: Any = ()

    def initialize(self, row_tree, population, layout=None, method=None):
        # C order, as a gather's rows are: np.array of the broadcast
        # would keep its population axis innermost, and a reduction over
        # that axis then sums in another order on the whole-population
        # path than on gathered rows
        self._tree = tree_map(lambda a: _broadcast_rows(a, population),
                              row_tree)

    def gather(self, ids):
        ids = np.asarray(ids)
        return tree_map(lambda a: a[ids], self._tree)

    def scatter(self, ids, rows):
        ids = np.asarray(ids)

        def put(a, new):
            if isinstance(a, torch.Tensor):   # a device tree: copy once
                a = (a.detach().cpu() if a.dtype == torch.bfloat16
                     else a.detach().cpu().numpy().copy())
            a[ids] = host(new)
            return a

        self._tree = tree_map(put, self._tree, rows)

    @property
    def tree(self):
        return self._tree

    def adopt(self, stacked):
        self._tree = stacked


# ---------------------------------------------------------------------------
# MmapShardStore: chunked npy shards on disk, O(cohort) resident
# ---------------------------------------------------------------------------


@register
class MmapShardStore(ClientStateStore):
    """Client state as chunked ``.npy`` shards on disk, memory-mapped.

    Working shards: row leaf j, rows [c*chunk_size, (c+1)*chunk_size) ->
    ``leaf{j}-c{c}.npy`` under the store dir, written atomically
    (checkpoint/io.py tmp + ``os.replace``). A port row has one leaf (a
    flat ``(M,)`` vector) where the reference's has one per parameter,
    so a shard's rows are one contiguous ``(n, M)`` block. ``gather``
    opens (and caches) a read-write memory map per touched shard and
    copies out only the cohort's rows; ``scatter`` writes them back
    through the map and records the shard in ``dirty_shards``, the set
    ``save_fl_checkpoint`` flushes (``checkpoint_shards``: clean shards
    keep the file the previous checkpoint published). The checkpoint
    files are the reference's: one per reference leaf and shard, conv
    leaves HWIO, under the reference's names and ``layout()``. Resident
    memory is O(cohort) plus page cache the OS may reclaim; the full
    population never materializes on the host.

    ``rank``: on a mesh of ranks, this rank's number: its shards live in
    ``<dir>/rank<rank>``, or in a temporary directory of its own."""

    name = "mmap"
    summary = ("chunked mmap npy shards on disk, streaming gather/"
               "scatter + dirty tracking; O(cohort) RAM")
    in_memory = False
    incremental = True

    def __init__(self, chunk_size: int = 1024, dir: str | None = None,
                 rank: int | None = None):
        if (not isinstance(chunk_size, int) or isinstance(chunk_size, bool)
                or chunk_size <= 0):
            raise ValueError(
                f"MmapShardStore chunk_size must be a positive int (rows "
                f"per shard), got {chunk_size!r}")
        self.chunk_size = chunk_size
        self._owns_dir = dir is None
        self.rank = rank
        self._dir = (os.path.join(dir, f"rank{rank}")
                     if dir is not None and rank is not None else dir)
        self.population = 0
        self.n_shards = 0
        self._row_like: Any = ()     # one row's tree: the structure
        self._flat = None            # FlatLayout of flat params rows
        self._leaf_meta: list[tuple[tuple, np.dtype]] = []  # working leaves
        self._ref_like: Any = ()     # one row in the reference's layout
        self._ref_meta: list[tuple[tuple, np.dtype]] = []   # its leaves
        self._maps: dict[tuple[int, int], np.memmap] = {}
        self.dirty_shards: set[int] = set()
        # "k:c" -> published checkpoint filename (incremental manifests)
        self._ckpt_files: dict[str, str] = {}

    # -- layout -------------------------------------------------------------

    @property
    def dir(self) -> str:
        if self._dir is None:
            tag = "" if self.rank is None else f"rank{self.rank}-"
            self._dir = tempfile.mkdtemp(
                prefix=f"repro-torch-statestore-{tag}")
        return self._dir

    def _shard_path(self, j: int, c: int) -> str:
        return os.path.join(self.dir, f"leaf{j}-c{c}.npy")

    def _shard_rows(self, c: int) -> int:
        return min(self.chunk_size, self.population - c * self.chunk_size)

    def layout(self) -> dict:
        """The JSON-able shard layout a checkpoint manifest pins (and
        ``restore_shards`` validates against): the reference's leaves,
        shapes HWIO."""
        return {"population": self.population,
                "chunk_size": self.chunk_size,
                "n_shards": self.n_shards,
                "leaves": [{"shape": list(s), "dtype": str(d)}
                           for s, d in self._ref_meta]}

    def initialize(self, row_tree, population, layout=None, method=None):
        if any(getattr(leaf, "dtype", None) == torch.bfloat16
               for leaf in tree_leaves(row_tree)):
            dtypes = dtype_names(layout.dtypes if layout is not None
                                 else {torch.bfloat16})
            raise ValueError(
                f"store='mmap': the client rows of method "
                f"{method or '?'} on a params tree that mixes dtypes "
                f"({dtypes}) hold bfloat16 leaves, and numpy has no "
                "bfloat16 to map (the JAX package fails writing them: no "
                "cast into a bfloat16 memmap); run store='memory' or a "
                "client-stateless method")
        rows = [np.asarray(leaf) for leaf in tree_leaves(row_tree)]
        self._row_like, self._flat = row_tree, layout
        self._leaf_meta = [(tuple(r.shape), r.dtype) for r in rows]
        self._ref_like = convert.flat_to_reference(row_tree, layout)
        self._ref_meta = [(tuple(np.shape(a)), np.asarray(a).dtype)
                          for _, a in tree_leaves_with_path(self._ref_like)]
        self.population = int(population)
        self.n_shards = -(-self.population // self.chunk_size)
        self._maps.clear()
        self.dirty_shards.clear()
        self._ckpt_files.clear()
        os.makedirs(self.dir, exist_ok=True)
        for c in range(self.n_shards):
            n = self._shard_rows(c)
            for j, row in enumerate(rows):
                ckpt_io.write_array_atomic(
                    self._shard_path(j, c),
                    np.broadcast_to(row[None], (n,) + row.shape))

    # -- row movement -------------------------------------------------------

    def _map(self, j: int, c: int) -> np.memmap:
        mm = self._maps.get((j, c))
        if mm is None:
            mm = np.lib.format.open_memmap(self._shard_path(j, c),
                                           mode="r+")
            self._maps[(j, c)] = mm
        return mm

    def _by_shard(self, ids):
        ids = np.asarray(ids, np.int64)
        shards = ids // self.chunk_size
        for c in np.unique(shards):
            mask = shards == c
            yield int(c), mask, ids[mask] - c * self.chunk_size

    def gather(self, ids):
        ids = np.asarray(ids, np.int64)
        out = [np.empty((len(ids),) + shape, dtype)
               for shape, dtype in self._leaf_meta]
        for c, mask, rows in self._by_shard(ids):
            for j in range(len(out)):
                out[j][mask] = self._map(j, c)[rows]
        return tree_unflatten(self._row_like, out)

    def scatter(self, ids, rows_tree):
        ids = np.asarray(ids, np.int64)
        flat = [host(leaf) for leaf in tree_leaves(rows_tree)]
        for c, mask, rows in self._by_shard(ids):
            for j, leaf in enumerate(flat):
                self._map(j, c)[rows] = leaf[mask]
            self.dirty_shards.add(c)

    @property
    def tree(self):
        raise RuntimeError(
            "MmapShardStore holds the population out of core and never "
            "materializes the full (P, ...) stack; gather the cohort's "
            "rows instead (store.gather(ids))")

    def adopt(self, stacked):
        flat = tree_leaves(stacked)
        if flat and len(flat[0]) != self.population:
            raise ValueError(
                f"adopt got a {len(flat[0])}-row stack for a "
                f"population of {self.population}")
        self.scatter(np.arange(self.population, dtype=np.int64), stacked)

    # -- aux offload: parts / weights / presence rows -----------------------

    def offload_aux(self, pop) -> None:
        """Move the population's O(P) side arrays out of RAM: parts as
        flat+offsets, weights, and the (P, G) presence rows each become
        an on-disk ``.npy`` reopened as a read-only memory map (indexing
        a memmap with the cohort's ids materializes only those rows:
        ``pad_tile_inputs``'s access pattern)."""
        def _mm(name, arr):
            path = os.path.join(self.dir, f"aux-{name}.npy")
            ckpt_io.write_array_atomic(path, np.ascontiguousarray(arr))
            return np.load(path, mmap_mode="r")

        os.makedirs(self.dir, exist_ok=True)
        parts = ShardIndices.from_parts(pop.parts)
        pop.parts = ShardIndices(_mm("parts-flat", parts.flat),
                                 _mm("parts-offsets", parts.offsets))
        pop.weights = _mm("weights", pop.weights)
        if pop.group_weights is not None:
            pop.group_weights = _mm("group-weights", pop.group_weights)

    # -- incremental checkpointing (driven by checkpoint/io.py) -------------

    def _shard_tree(self, c: int):
        """Shard c's rows as a stacked tree of the working maps."""
        return tree_unflatten(self._row_like,
                              [self._map(j, c)
                               for j in range(len(self._leaf_meta))])

    def checkpoint_shards(self, clients_dir: str, step: int) -> dict:
        """Flush DIRTY shards into ``clients_dir`` as step-versioned
        copies, one file per reference leaf (``leaf{k}-c{c}-r{step}``),
        and return the full "k:c" -> filename map for the manifest:
        dirty (or never-published) shards get fresh files written
        atomically; clean shards keep the filename the previous manifest
        published. The caller publishes the manifest and THEN prunes
        (``prune_checkpoint_files``): a crash in between leaves the
        previous manifest's files intact."""
        os.makedirs(clients_dir, exist_ok=True)
        files = dict(self._ckpt_files)
        n_ref = len(self._ref_meta)
        for c in range(self.n_shards):
            stale = [k for k in range(n_ref)
                     if c in self.dirty_shards or f"{k}:{c}" not in files]
            if not stale:
                continue
            ref = [a for _, a in tree_leaves_with_path(
                convert.flat_to_reference(self._shard_tree(c), self._flat))]
            for k in stale:
                name = f"leaf{k}-c{c}-r{step}.npy"
                ckpt_io.write_array_atomic(os.path.join(clients_dir, name),
                                           ref[k])
                files[f"{k}:{c}"] = name
        self.dirty_shards.clear()
        self._ckpt_files = files
        return dict(files)

    def prune_checkpoint_files(self, clients_dir: str) -> None:
        """Best-effort removal of superseded shard files (anything not
        named by the just-published manifest)."""
        keep = set(self._ckpt_files.values())
        try:
            names = os.listdir(clients_dir)
        except OSError:
            return
        for name in names:
            if name.endswith(".npy") and name not in keep:
                try:
                    os.remove(os.path.join(clients_dir, name))
                except OSError:
                    pass

    def restore_shards(self, clients_dir: str, manifest: dict) -> None:
        """Load a checkpoint published by ``checkpoint_shards`` (by
        either package) back into the working shards (mid-run resume).
        The manifest's layout must match this store's: the shapes,
        dtypes and chunking are part of the run's identity, like
        ``load_checkpoint``'s shape checks."""
        want, have = manifest.get("layout"), self.layout()
        if want != have:
            raise ValueError(
                f"checkpointed client-store layout {want} does not match "
                f"the configured store {have}; resume with the same "
                "population/chunk_size/method")
        by_shard: dict[int, dict[int, str]] = {}
        for key, name in manifest["files"].items():
            k, c = (int(x) for x in key.split(":"))
            by_shard.setdefault(c, {})[k] = name
        row_bytes = sum(max(1, int(np.prod(shape))) * np.dtype(d).itemsize
                        for shape, d in self._leaf_meta)
        step = max(1, ckpt_io.BLOCK_BYTES // max(1, row_bytes))
        for c, names in sorted(by_shard.items()):
            ref = tree_unflatten(self._ref_like, [
                np.load(os.path.join(clients_dir, names[k]), mmap_mode="r")
                for k in range(len(self._ref_meta))])
            like = self._shard_tree(c)
            for i in range(0, self._shard_rows(c), step):  # blocks of rows
                rows = tree_map(lambda a: a[i:i + step], like)
                new = convert.flat_from_reference(
                    tree_map(lambda a: a[i:i + step], ref), rows,
                    self._flat)
                for mm, v in zip(tree_leaves(rows), tree_leaves(new)):
                    mm[...] = v
        self.dirty_shards.clear()
        self._ckpt_files = dict(manifest["files"])

    def close(self):
        self._maps.clear()
        if self._owns_dir and self._dir and os.path.isdir(self._dir):
            shutil.rmtree(self._dir, ignore_errors=True)
        self._dir = None if self._owns_dir else self._dir


# ---------------------------------------------------------------------------
# Walker alias table: O(1) weighted draws after an O(P) build
# ---------------------------------------------------------------------------


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
