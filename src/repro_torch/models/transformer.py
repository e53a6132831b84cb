"""LM assembly: the part of ``repro.models.transformer`` that the ``ssm``
family (Mamba-2) needs to train, prefill and decode.

One ``ModelConfig`` describes an LM; this port builds the ``ssm`` family
only, and every other family (dense, moe, hybrid, encdec, vlm) raises
``NotImplementedError`` naming it. Parameters are stacked over layers (a
leading layer axis on every leaf of ``blocks``), as the reference stacks
them for ``lax.scan``, so its weights map across one to one; the port
loops over the layers in Python. The LM loss is a sequence-chunked,
rematerialized cross-entropy (``chunked_ce_loss``), so (B, S, V) logits
are never alive at once.

Fed2 structure adaptation (the reference's DESIGN.md §3): with
``fed2_groups > 0`` the unembedding is block-diagonal over vocab
clusters. ``with_fed2`` forces ``fed2_decouple = 0`` for ``ssm``; the
decoupled (grouped-FFN) blocks of the other families are not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (dense_apply, dense_init, embed_init,
                                       grouped_dense_apply,
                                       grouped_dense_init, rmsnorm_apply,
                                       rmsnorm_init)
from repro_torch.models.module import rematerialized, stack_init

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's fields that the ``ssm`` family and ``with_fed2``
    read; the other families' fields (attention, MoE, encoder, vision)
    come with them. ``remat_blocks`` recomputes each block's activations
    in the backward pass (plain autograd only: ``models.module.
    rematerialized``); ``tie_embeddings`` stays False for ``ssm``."""
    arch_id: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int
    d_ff: int = 0
    norm: str = "rmsnorm"
    ssm: ssm_lib.SSMConfig | None = None
    # fed2 structure adaptation
    fed2_groups: int = 0
    fed2_decouple: int = 0
    tie_embeddings: bool = False
    # numerics / lowering
    dtype: Any = torch.float32
    loss_chunk: int = 512
    remat_blocks: bool = True

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so (a) Fed2 groups divide it and (b) it
        shards evenly over a mesh model axis (unit 128, MaxText-style)."""
        g = max(self.fed2_groups, 1)
        unit = 128 * g // math.gcd(128, g)
        return -(-self.vocab // unit) * unit


def check_ported(cfg: ModelConfig):
    """Raise unless the port builds, trains and decodes ``cfg``: the
    ``ssm`` family without decoupled blocks or tied embeddings."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown LM family {cfg.family!r}")
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet ({cfg.arch_id}); "
            "the port has the 'ssm' family")
    if cfg.fed2_decouple:
        raise NotImplementedError(
            f"decoupled blocks (fed2_decouple={cfg.fed2_decouple}) are not "
            "ported; with_fed2 sets 0 for the 'ssm' family")
    if cfg.tie_embeddings:
        raise NotImplementedError(
            "tied embeddings are not ported; the 'ssm' family keeps "
            "tie_embeddings=False")


# ---------------------------------------------------------------------------
# Norm helpers
# ---------------------------------------------------------------------------


def _norm_init(cfg, device=None):
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    return rmsnorm_init(cfg.d_model, cfg.dtype, device=device)


def _norm_apply(cfg, p, x):
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    return rmsnorm_apply(p, x)


# ---------------------------------------------------------------------------
# Decoder blocks
# ---------------------------------------------------------------------------


def block_init(gen, cfg: ModelConfig):
    """One SSM block (the reference's kind 'ssm'): pre-norm + mixer."""
    return {"ln1": _norm_init(cfg, device=gen.device),
            "mixer": ssm_lib.mamba2_init(gen, cfg.ssm, cfg.dtype)}


def block_apply(p, x, cfg: ModelConfig):
    """A whole sequence through one SSM block (the reference's kind
    'ssm'): x + mixer(norm(x)). The reference also returns an aux loss,
    always 0 for this kind."""
    y = ssm_lib.mamba2_apply(p["mixer"], _norm_apply(cfg, p["ln1"], x),
                             cfg.ssm)
    return x + y


def block_decode(p, x, cache, cfg: ModelConfig, *, use_kernel: bool = True):
    """One token through one SSM block; ``cache`` is updated in place."""
    y, cache = ssm_lib.mamba2_decode(p["mixer"],
                                     _norm_apply(cfg, p["ln1"], x), cache,
                                     cfg.ssm, use_kernel=use_kernel)
    return x + y, cache


# ---------------------------------------------------------------------------
# Unembedding + chunked CE loss
# ---------------------------------------------------------------------------


def unembed_init(gen, cfg: ModelConfig):
    if cfg.fed2_groups > 0:
        return grouped_dense_init(gen, cfg.fed2_groups, cfg.d_model,
                                  cfg.padded_vocab, dtype=cfg.dtype)
    return dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype=cfg.dtype)


def unembed_apply(p, h, cfg: ModelConfig, *, use_kernel: bool = True):
    """Logits over the first ``vocab`` of ``padded_vocab`` columns. The
    Fed2 (block-diagonal) unembedding goes through the
    ``grouped_matmul`` kernel when ``use_kernel`` and the tensors are on
    the card: a route the reference does not take (it computes the same
    function with an einsum), for no-grad passes only (the kernel raises
    under autograd); ``use_kernel=False`` is that einsum."""
    if cfg.fed2_groups > 0:
        logits = grouped_dense_apply(p, h, use_kernel=use_kernel)
    else:
        logits = dense_apply(p, h)
    return logits[..., :cfg.vocab]


def chunked_ce_loss(params, h, labels, mask, cfg: ModelConfig, *,
                    use_kernel: bool = False):
    """Sequence-chunked softmax CE over the first ``vocab`` logits: h
    (B, S, d); labels, mask (B, S). S is right-padded to a multiple of
    ``min(loss_chunk, S)`` (mask 0 there); each chunk's logits are
    rematerialized on the plain-autograd route, so (B, S, V) logits never
    exist. Returns sum(CE * mask) / max(sum(mask), 1). ``use_kernel``
    takes the unembedding's kernel route (no-grad passes only); the
    default is the reference's einsum, which every training route
    takes."""
    b, s, d = h.shape
    ck = min(cfg.loss_chunk, s)
    nc = -(-s // ck)
    pad = nc * ck - s
    hs = F.pad(h, (0, 0, 0, pad)).reshape(b, nc, ck, d).unbind(1)
    ls = F.pad(labels.long(), (0, pad)).reshape(b, nc, ck).unbind(1)
    ms = F.pad(mask.to(torch.float32), (0, pad)).reshape(b, nc, ck).unbind(1)

    def chunk_loss(hc, lc, mc):
        logits = unembed_apply(params["unembed"], hc, cfg,
                               use_kernel=use_kernel).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, lc[..., None], dim=-1)[..., 0]
        return ((lse - gold) * mc).sum(), mc.sum()

    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for hc, lc, mc in zip(hs, ls, ms):
        l_, n_ = rematerialized(chunk_loss, hc, lc, mc)
        tot, cnt = tot + l_, cnt + n_
    return tot / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# Full model init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Random parameters from ``gen``, drawn on its device in the
    config's dtype (a full-width model is drawn on the card)."""
    check_ported(cfg)
    return {"embed": embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                cfg.dtype),
            "blocks": stack_init(block_init, gen, cfg.n_layers, cfg=cfg),
            "final_norm": _norm_init(cfg, device=gen.device),
            "unembed": unembed_init(gen, cfg)}
