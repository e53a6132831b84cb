"""Tiled evaluation by example-weighted counts.

    tiles  <- stage(batches, tile=B, device=...)  # (T, B, ...) tiles on
                                                  # the device + (T, B)
                                                  # padding mask
    counts <- engine.run(params, tiles)           # device-resident

``stage`` concatenates the eval batches host-side, pads the tail tile
by repeating sample 0 at mask 0 so every tile has the same width, and
moves the tiles to the device once. Under a mesh of ranks
(``launch/mesh.RankMesh``) the tile count is padded to a multiple of
the "data" size, as the JAX package pads it, each rank moves only its
contiguous block of tiles (the reference's placement of the tile axis
on "data"), and the engine adds the ranks' counts with one all-reduce
over "data": every rank ends with the whole set's counts. The engine
computes example-weighted counts, never per-batch means:

- ``n_classes`` given: a (C, C) confusion-count matrix (rows = gold,
  cols = predicted); accuracy = trace / total, and per-class and
  per-group accuracies fall out of the rows (``per_class_accuracy``,
  ``group_accuracy``, group g via ``GroupSpec.logit_signature``);
- ``n_classes=None`` (LM tasks, where the classes are the vocab):
  weighted (correct, total) sums over every position.

Counts stay on the device until the caller reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.launch.mesh import data_block


@dataclasses.dataclass(frozen=True)
class EvalTiles:
    """The staged eval set: every batch leaf as (T, B, ...) on the
    device, the (T, B) padding mask, and the true sample count. On a
    mesh of ranks T is this rank's block of tiles, and ``reduce`` sums
    the counts over the ranks (in place)."""
    batches: dict
    mask: torch.Tensor
    n_real: int
    reduce: Callable | None = None

    @property
    def n_tiles(self) -> int:
        return int(self.mask.shape[0])


def stage(batches: list, *, tile: int, device, mesh=None) -> EvalTiles:
    """Stack a list of batch dicts (numpy arrays, leading axis =
    example) into fixed-width tiles of ``tile`` examples on ``device``.
    ``mesh``: None, a one-device mesh, or this rank's ``RankMesh`` (the
    tile count padded to a multiple of its "data" size; this rank's
    block of tiles staged)."""
    if not batches:
        raise ValueError("stage() needs at least one eval batch")
    cat = {k: np.concatenate([np.asarray(b[k]) for b in batches])
           for k in batches[0]}
    n_real = len(next(iter(cat.values())))
    n_tiles = -(-n_real // tile)
    reduce = None
    if mesh is not None and mesh.size > 1:
        from repro_torch.launch.collectives import all_reduce
        n_tiles = -(-n_tiles // mesh.shape["data"]) * mesh.shape["data"]

        def reduce(t):
            return all_reduce(t, mesh, "data")
    lo, hi = data_block(n_tiles, mesh)
    total = n_tiles * tile
    mask = np.zeros((total,), np.float32)
    mask[:n_real] = 1.0
    pad = total - n_real

    def to_tiles(x):
        if pad:
            x = np.concatenate([x, np.broadcast_to(x[:1],
                                                   (pad,) + x.shape[1:])])
        x = x.reshape((n_tiles, tile) + x.shape[1:])[lo:hi]
        return torch.as_tensor(x, device=device)

    return EvalTiles(batches={k: to_tiles(v) for k, v in cat.items()},
                     mask=torch.as_tensor(
                         mask.reshape(n_tiles, tile)[lo:hi], device=device),
                     n_real=n_real, reduce=reduce)


@dataclasses.dataclass(frozen=True)
class EvalEngine:
    """``run(params, tiles)`` -> device tensor: (C, C) float32 confusion
    counts, or (correct, total) float32 sums when ``n_classes`` is
    None; on a mesh of ranks, the whole set's."""
    run: Callable
    n_classes: int | None


def make_eval_engine(predict_fn: Callable,
                     n_classes: int | None = None) -> EvalEngine:
    """predict_fn(params, batch) -> (pred, gold, weight): per-position
    predictions, gold labels and example weights, (B,) for classifiers,
    (B, L) for LMs (weight = the batch's own mask). The staging mask
    multiplies into ``weight``, broadcast over its trailing axes."""

    def one_tile(params, batch, m):
        pred, gold, w = predict_fn(params, batch)
        w = w.to(torch.float32) * m.reshape(m.shape + (1,) * (w.dim() - 1))
        w = w.reshape(-1)
        pred, gold = pred.reshape(-1).long(), gold.reshape(-1).long()
        if n_classes is None:
            return torch.stack([((pred == gold) * w).sum(), w.sum()])
        idx = gold * n_classes + pred
        flat = torch.zeros(n_classes * n_classes, dtype=torch.float32,
                           device=w.device).index_add_(0, idx, w)
        return flat.reshape(n_classes, n_classes)

    @torch.no_grad()
    def run(params, tiles: EvalTiles):
        acc = None
        for t in range(tiles.n_tiles):
            batch = {k: v[t] for k, v in tiles.batches.items()}
            c = one_tile(params, batch, tiles.mask[t])
            acc = c if acc is None else acc + c
        if tiles.reduce is not None:
            tiles.reduce(acc)
        return acc

    return EvalEngine(run=run, n_classes=n_classes)


# ---------------------------------------------------------------------------
# Reading the counts (host-side, after materialization)
# ---------------------------------------------------------------------------


def accuracy(counts) -> float:
    """Global accuracy from an engine result: a (correct, total) pair or
    a confusion-count matrix."""
    c = np.asarray(counts)
    if c.ndim == 1:
        return float(c[0] / max(c[1], 1.0))
    return float(np.trace(c) / max(c.sum(), 1.0))


def per_class_accuracy(confusion) -> np.ndarray:
    """(C,) per-class accuracy: diag / row sum (classes with no eval
    samples report 0)."""
    c = np.asarray(confusion, np.float64)
    row = c.sum(axis=1)
    return np.where(row > 0, np.diag(c) / np.maximum(row, 1.0), 0.0)


def group_accuracy(confusion, spec) -> np.ndarray:
    """(G,) per-group accuracy under a ``GroupSpec``: group g's accuracy
    over the eval samples whose gold label is in g's logit signature."""
    c = np.asarray(confusion, np.float64)
    out = np.zeros(spec.n_groups)
    for g in range(spec.n_groups):
        cls = sorted(spec.logit_signature(g))
        row = c[cls].sum()
        out[g] = c[cls, cls].sum() / row if row > 0 else 0.0
    return out
