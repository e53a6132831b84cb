"""Tensor parallelism over a mesh's "model" axis: the pieces of the
sharded prefill and decode programs, the port's counterpart of the
program GSPMD partitions for the reference's dry-run under
``launch/sharding.py``'s placement.

A rank holds the shares ``launch/sharding.cut`` gives it: column-
parallel weights (wq wk wv w_z w_xbc w_gate w_up) hold a block of their
output columns, row-parallel ones (wo w_down out_proj) a block of their
input rows, the embedding a block of vocab rows, the unembedding a
block of each group's vocab columns (``(G, d/G, V/(G·|model|))`` for
Fed2's, ``(d, V/|model|)`` without, the G = 1 case), the depthwise conv
a block of channels; norms and per-head scalars are whole. The helpers
here are the collectives such a program needs, each over the "model"
line of ``launch/collectives.py`` and counted there:

- ``reduce_model``: the sum of a row-parallel product's partials. They
  travel in the activations' dtype (bf16 on the card), as GSPMD's
  all-reduce of a bf16 product does; attention's partial scores, which
  the one-process decode takes to fp32, travel in fp32;
- ``vocab_embed``: the masked local lookup of the rank's vocab rows,
  then one all-reduce (exactly one rank holds a token's row);
- ``gather_logits``: every rank's logit columns, put back in vocab
  order (a Fed2 rank's columns come group by group);
- ``vocab_ce``: one loss chunk's cross-entropy from the rank's logit
  columns: each rank's log-sum-exp over its columns (the padded ones
  past ``vocab`` masked by their global index) and its gold logit (0
  where another rank holds the label), both all-gathered in one call
  and combined in fp32.

On a mesh of one model rank, or without a mesh, each is the
one-process computation and issues nothing.
"""
from __future__ import annotations

import torch

from repro_torch.launch.collectives import all_gather, all_reduce

# the families whose sharded prefill and decode programs the port runs
SHARDED_FAMILIES = ("dense", "ssm")


def is_split(mesh) -> bool:
    """Whether ``mesh`` has more than one rank (a program on it is the
    sharded one)."""
    return mesh is not None and mesh.size > 1


def check_sharded(cfg, mesh, where: str) -> None:
    """Raise unless the sharded program covers ``cfg`` on ``mesh``:
    without a mesh of more than one rank anything goes; on one, only
    the dense and ssm families with untied embeddings."""
    if not is_split(mesh):
        return
    if cfg.family not in SHARDED_FAMILIES or cfg.tie_embeddings:
        raise NotImplementedError(
            f"{where} on a mesh of {mesh.size} ranks: the port's sharded "
            f"prefill and decode programs cover the "
            f"{', '.join(map(repr, SHARDED_FAMILIES))} families (untied "
            f"embeddings), not {cfg.family!r} ({cfg.arch_id})")


def model_size(mesh) -> int:
    return 1 if mesh is None else mesh.shape["model"]


def model_coord(mesh) -> int:
    return 0 if model_size(mesh) == 1 else mesh.coord("model")


def split(n: int, mesh, what: str) -> int:
    """``n`` over the model ranks: each rank's extent; raises where the
    program needs an even split and ``n`` does not divide."""
    m = model_size(mesh)
    if n % m:
        raise NotImplementedError(
            f"{what} ({n}) does not split evenly over {m} model ranks")
    return n // m


def reduce_model(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the "model" line (a row-parallel product's
    partials); ``t`` itself on one model rank."""
    if model_size(mesh) == 1:
        return t
    return all_reduce(t.contiguous(), mesh, "model")


def reduce_data(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the "data" line (a loss's sums over the batch's
    row blocks); ``t`` itself on one data rank."""
    if mesh is None or mesh.shape["data"] == 1:
        return t
    return all_reduce(t.contiguous(), mesh, "data")


def gather_model(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every model rank's ``t``, stacked in coordinate order: (|model|,
    *t.shape)."""
    if model_size(mesh) == 1:
        return t[None]
    return all_gather(t.contiguous(), mesh, "model")


def gather_last(t: torch.Tensor, mesh) -> torch.Tensor:
    """The last dimension of ``t`` split in model-rank blocks, joined:
    (..., |model| * n) from every rank's (..., n)."""
    g = gather_model(t, mesh)
    return g.movedim(0, -2).reshape(t.shape[:-1] + (-1,))


def row_dense(p, x, mesh):
    """A row-parallel dense layer: the rank's rows of ``w`` against its
    block of ``x``'s features, the partials summed over "model", then
    the (replicated) bias."""
    y = reduce_model(x @ p["w"], mesh)
    return y + p["b"] if "b" in p else y


def vocab_embed(p, ids, mesh):
    """The vocab-parallel embedding: the rank's rows (a block of the
    table) looked up where it holds the token, zeros elsewhere, summed
    over "model" (one rank adds the row, the others zeros: exact)."""
    table = p["table"]
    if model_size(mesh) == 1:
        return table[ids]
    n = table.shape[0]
    local = ids.long() - model_coord(mesh) * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return reduce_model(torch.where(inside[..., None], rows,
                                    torch.zeros((), dtype=rows.dtype,
                                                device=rows.device)), mesh)


def vocab_layout(cfg, mesh) -> tuple:
    """(G, V_g, n): the unembedding's G groups (1 without Fed2) of V_g
    columns each, ``n`` of each group's columns on a rank: the rank at
    model coordinate r holds columns g * V_g + r * n + j."""
    g = max(cfg.fed2_groups, 1)
    vg = cfg.padded_vocab // g
    return g, vg, split(vg, mesh, "an unembedding group's columns")


def local_columns(cfg, mesh, device) -> torch.Tensor:
    """(G * n,) int64: the vocab index of each of the rank's logit
    columns (``vocab_layout``)."""
    g, vg, n = vocab_layout(cfg, mesh)
    base = torch.arange(g, device=device)[:, None] * vg \
        + model_coord(mesh) * n
    return (base + torch.arange(n, device=device)).reshape(-1)


def gather_logits(logits, cfg, mesh):
    """The whole logits (..., vocab) from every rank's columns (...,
    G * n), in vocab order."""
    if model_size(mesh) == 1:
        return logits[..., :cfg.vocab]
    g, _, n = vocab_layout(cfg, mesh)
    m = model_size(mesh)
    parts = gather_model(logits, mesh)                   # (m, ..., G*n)
    lead = logits.shape[:-1]
    parts = parts.reshape((m,) + lead + (g, n)).movedim(0, -2)
    return parts.reshape(lead + (g * m * n,))[..., :cfg.vocab]


def vocab_ce(logits, labels, cfg, mesh):
    """One loss chunk's cross-entropy (B, c) fp32 from the rank's logit
    columns ``logits`` (B, c, G * n) fp32 and the labels (B, c): the
    log-sum-exp over the whole vocab minus the gold logit."""
    if model_size(mesh) == 1:
        logits = logits[..., :cfg.vocab]
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels[..., None], dim=-1)
        return lse - gold[..., 0]
    g, vg, n = vocab_layout(cfg, mesh)
    cols = local_columns(cfg, mesh, logits.device)
    logits = logits.masked_fill(cols >= cfg.vocab, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    within = labels % vg
    mine = within // n == model_coord(mesh)
    local = (labels // vg) * n + within % n
    gold = torch.take_along_dim(logits, local[..., None], dim=-1)[..., 0]
    gold = torch.where(mine, gold, torch.zeros((), device=gold.device))
    both = gather_model(torch.stack([lse, gold], dim=-1), mesh)
    return torch.logsumexp(both[..., 0], dim=0) - both[..., 1].sum(dim=0)


def rmsnorm_split(scale, x, mesh, width: int, *, eps: float = 1e-6):
    """RMSNorm over a feature axis of ``width`` split over "model": the
    rank's block ``x`` (..., width / |model|) and ``scale``'s matching
    block; the fp32 sum of squares summed over "model", otherwise
    ``layers.rmsnorm_apply``'s order (fp32 statistics, cast back, then
    the scale)."""
    x32 = x.to(torch.float32)
    var = reduce_model(x32.square().sum(dim=-1, keepdim=True), mesh) / width
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale
