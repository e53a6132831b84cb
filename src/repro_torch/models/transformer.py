"""LM assembly: the parts of ``repro.models.transformer`` that the
``dense`` family (Llama-3.2-1B) and the ``ssm`` family (Mamba-2) need to
train, prefill and decode.

One ``ModelConfig`` describes an LM; this port builds the ``dense`` and
``ssm`` families, and every other family (moe, hybrid, encdec, vlm)
raises ``NotImplementedError`` naming it. Parameters are stacked over
layers (a leading layer axis on every leaf of ``blocks``), as the
reference stacks them for ``lax.scan``, so its weights map across one to
one; the port loops over the layers in Python. The LM loss is a
sequence-chunked, rematerialized cross-entropy (``chunked_ce_loss``), so
(B, S, V) logits are never alive at once.

Fed2 structure adaptation (the reference's DESIGN.md §3): with
``fed2_groups > 0`` the unembedding is block-diagonal over vocab
clusters, and for ``dense`` the last ``fed2_decouple`` blocks
(``gblocks``) take block-diagonal SwiGLU FFNs (``gffn_*``), the
transformer's counterpart of the paper's group convolutions; the lower
``n_dense_blocks`` stay shared. ``with_fed2`` forces ``fed2_decouple =
0`` for ``ssm``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (dense_apply, dense_init, embed_init,
                                       gelu, grouped_dense_apply,
                                       grouped_dense_init, rmsnorm_apply,
                                       rmsnorm_init, silu)
from repro_torch.models.module import rematerialized, stack_init

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
PORTED_FAMILIES = ("dense", "ssm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's fields that the ``dense`` and ``ssm`` families
    and ``with_fed2`` read; the other families' fields (MoE, encoder,
    vision) come with them. ``remat_blocks`` recomputes each block's
    activations in the backward pass (plain autograd only:
    ``models.module.rematerialized``); ``tie_embeddings`` stays False."""
    arch_id: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int
    d_ff: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    norm: str = "rmsnorm"
    act: str = "swiglu"             # swiglu | gelu
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    qkv_bias: bool = False
    qk_norm: bool = False
    window: int | None = None       # sliding-window attention
    use_rope: bool = True
    ssm: ssm_lib.SSMConfig | None = None
    # fed2 structure adaptation
    fed2_groups: int = 0
    fed2_decouple: int = 0
    tie_embeddings: bool = False
    # numerics / lowering
    dtype: Any = torch.float32
    loss_chunk: int = 512
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    remat_blocks: bool = True

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def attn_cfg(self) -> attn.AttnConfig:
        return attn.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            rope_theta=self.rope_theta,
            rotary_pct=self.rotary_pct if self.use_rope else 0.0,
            qkv_bias=self.qkv_bias, qk_norm=self.qk_norm, window=self.window)

    @property
    def n_dense_blocks(self) -> int:
        return self.n_layers - self.fed2_decouple

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so (a) Fed2 groups divide it and (b) it
        shards evenly over a mesh model axis (unit 128, MaxText-style)."""
        g = max(self.fed2_groups, 1)
        unit = 128 * g // math.gcd(128, g)
        return -(-self.vocab // unit) * unit


def check_ported(cfg: ModelConfig):
    """Raise unless the port builds, trains and decodes ``cfg``: the
    ``dense`` family (decoupled blocks allowed) without the attention
    features of the other dense configs, or the ``ssm`` family without
    decoupled blocks; untied embeddings either way."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown LM family {cfg.family!r}")
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet ({cfg.arch_id}); "
            f"the port has the {' and '.join(map(repr, PORTED_FAMILIES))} "
            "families")
    if cfg.fed2_decouple and cfg.family != "dense":
        raise NotImplementedError(
            f"decoupled blocks (fed2_decouple={cfg.fed2_decouple}) are "
            f"ported for the 'dense' family only; with_fed2 sets 0 for "
            f"{cfg.family!r}")
    if cfg.tie_embeddings:
        raise NotImplementedError(
            "tied embeddings are not ported; the ported families keep "
            "tie_embeddings=False")
    if cfg.family == "dense":
        attn.check_gqa_ported(cfg.attn_cfg)


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


def _act(cfg, g, u):
    return (silu(g) if cfg.act == "swiglu" else gelu(g)) * u


# ---------------------------------------------------------------------------
# FFN (dense + grouped)
# ---------------------------------------------------------------------------


def ffn_init(gen, cfg: ModelConfig):
    return {"w_gate": dense_init(gen, cfg.d_model, cfg.d_ff, dtype=cfg.dtype),
            "w_up": dense_init(gen, cfg.d_model, cfg.d_ff, dtype=cfg.dtype),
            "w_down": dense_init(gen, cfg.d_ff, cfg.d_model,
                                 dtype=cfg.dtype)}


def ffn_apply(p, x, cfg: ModelConfig):
    return dense_apply(p["w_down"],
                       _act(cfg, dense_apply(p["w_gate"], x),
                            dense_apply(p["w_up"], x)))


def gffn_init(gen, cfg: ModelConfig):
    """Block-diagonal SwiGLU FFN over ``fed2_groups`` groups: Fed2's
    feature isolation for transformers."""
    g = cfg.fed2_groups
    return {"w_gate": grouped_dense_init(gen, g, cfg.d_model, cfg.d_ff,
                                         dtype=cfg.dtype),
            "w_up": grouped_dense_init(gen, g, cfg.d_model, cfg.d_ff,
                                       dtype=cfg.dtype),
            "w_down": grouped_dense_init(gen, g, cfg.d_ff, cfg.d_model,
                                         dtype=cfg.dtype)}


def gffn_apply(p, x, cfg: ModelConfig, *, use_kernel: bool = False):
    """``use_kernel`` takes its three products through the
    ``grouped_matmul`` kernel (on CUDA tensors; its plain version on the
    CPU): a route the reference does not take (it has the option but no
    caller sets it), for no-grad passes only (decode), since the kernel
    has no backward. False is the reference's einsum."""
    def gd(w, h):
        return grouped_dense_apply(w, h, use_kernel=use_kernel)
    return gd(p["w_down"], _act(cfg, gd(p["w_gate"], x), gd(p["w_up"], x)))


# ---------------------------------------------------------------------------
# Decoder blocks
# ---------------------------------------------------------------------------


def _default_kind(cfg: ModelConfig) -> str:
    """The block kind of a ported family: 'ssm' or 'attn_ffn'."""
    return "ssm" if cfg.family == "ssm" else "attn_ffn"


def block_init(gen, cfg: ModelConfig, *, grouped: bool = False):
    """One block of the config's kind: 'ssm' (pre-norm + Mamba-2 mixer)
    or 'attn_ffn' (pre-norm GQA, pre-norm FFN; ``grouped`` takes the
    block-diagonal FFN of a decoupled block)."""
    p = {"ln1": _norm_init(cfg, device=gen.device)}
    if _default_kind(cfg) == "ssm":
        p["mixer"] = ssm_lib.mamba2_init(gen, cfg.ssm, cfg.dtype)
        return p
    p["attn"] = attn.gqa_init(gen, cfg.attn_cfg, cfg.dtype)
    p["ln2"] = _norm_init(cfg, device=gen.device)
    p["ffn"] = gffn_init(gen, cfg) if grouped else ffn_init(gen, cfg)
    return p


def block_apply(p, x, cfg: ModelConfig, *, grouped: bool = False,
                positions=None):
    """A whole sequence through one block: x + mixer(norm(x)) for 'ssm';
    x + attn(norm(x)), then + ffn(norm(.)) for 'attn_ffn' at
    ``positions`` (S,). The reference also returns an aux loss, always 0
    for these kinds."""
    if _default_kind(cfg) == "ssm":
        return x + ssm_lib.mamba2_apply(p["mixer"],
                                        _norm_apply(cfg, p["ln1"], x),
                                        cfg.ssm)
    x = x + attn.gqa_apply(p["attn"], _norm_apply(cfg, p["ln1"], x),
                           cfg.attn_cfg, positions=positions,
                           q_chunk=cfg.attn_q_chunk,
                           kv_chunk=cfg.attn_kv_chunk)
    h = _norm_apply(cfg, p["ln2"], x)
    return x + (gffn_apply(p["ffn"], h, cfg) if grouped
                else ffn_apply(p["ffn"], h, cfg))


def block_decode(p, x, cache, cfg: ModelConfig, *, pos: int,
                 grouped: bool = False, use_kernel: bool = True):
    """One token through one block at position ``pos``; ``cache`` is
    updated in place. ``use_kernel`` takes the kernels' routes
    (``ssd_update``; ``grouped_matmul`` in a decoupled FFN)."""
    h = _norm_apply(cfg, p["ln1"], x)
    if _default_kind(cfg) == "ssm":
        y, cache = ssm_lib.mamba2_decode(p["mixer"], h, cache, cfg.ssm,
                                         use_kernel=use_kernel)
        return x + y, cache
    a, cache = attn.gqa_decode(p["attn"], h, cache, cfg.attn_cfg, pos=pos)
    x = x + a
    h = _norm_apply(cfg, p["ln2"], x)
    y = (gffn_apply(p["ffn"], h, cfg, use_kernel=use_kernel) if grouped
         else ffn_apply(p["ffn"], h, cfg))
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
    config's dtype (a full-width model is drawn on the card): the
    ``n_dense_blocks`` shared blocks under ``blocks`` and the
    ``fed2_decouple`` decoupled ones under ``gblocks``, as the reference
    splits them."""
    check_ported(cfg)
    params = {"embed": embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                  cfg.dtype),
              "blocks": stack_init(block_init, gen, cfg.n_dense_blocks,
                                   cfg=cfg)}
    if cfg.fed2_decouple:
        params["gblocks"] = stack_init(block_init, gen, cfg.fed2_decouple,
                                       cfg=cfg, grouped=True)
    params["final_norm"] = _norm_init(cfg, device=gen.device)
    params["unembed"] = unembed_init(gen, cfg)
    return params
