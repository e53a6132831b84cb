"""LM assembly: ``repro.models.transformer`` for its six families: the
``dense`` family (Llama-3.2-1B, Qwen2-7B, H2O-Danube-1.8B,
StableLM-2-12B), the ``moe`` family (Mixtral-8x22B, DeepSeek-V2-236B),
the ``ssm`` family (Mamba-2), the ``hybrid`` family (Zamba2-2.7B), the
``encdec`` family (Whisper-base) and the ``vlm`` family (InternVL2-2B).

One ``ModelConfig`` describes an LM. A ``vlm`` is a dense decoder whose
input sequence starts with ``n_patches`` patch embeddings from a vision
frontend the reference stubs (``forward(embeds=)``). An ``encdec``
holds an encoder of ``enc_layers`` non-causal pre-LayerNorm blocks over
``enc_frames`` frame embeddings (from a stubbed audio frontend) plus a
trained sinusoidal position table (``enc_pos``), and a decoder of
pre-LayerNorm blocks (causal self-attention, cross-attention over the
encoder's output, a GELU FFN with biases) over a learned position table
of ``dec_pos_size`` rows (``dec_pos``); Whisper ties its unembedding to
the embedding table (``tie_embeddings``: no ``unembed`` leaf). A MoE
block is a pre-norm GQA (Mixtral, with its sliding window) or MLA (any arch id
starting with ``deepseek``: the reference's rule) and a pre-norm
routed-expert FFN (``models.moe``); DeepSeek's first
``moe_first_dense`` layers (``pre_blocks``) keep MLA with a dense
SwiGLU FFN of width ``moe_dense_ff``. A hybrid holds ``n_layers``
Mamba-2 blocks and ONE shared attention block (``shared_attn``:
pre-norm GQA and a pre-norm SwiGLU FFN at ``d_ff``), applied after
every ``hybrid_attn_every`` of them. Parameters are stacked over layers
(a leading layer axis on every leaf of ``blocks``), as the reference
stacks them for ``lax.scan``, so its weights map across one to one; the
port loops over the layers in Python. The LM loss is a
sequence-chunked, rematerialized cross-entropy (``chunked_ce_loss``), so
(B, S, V) logits are never alive at once.

Fed2 structure adaptation (the reference's DESIGN.md §3): with
``fed2_groups > 0`` the unembedding is block-diagonal over vocab
clusters, and for ``dense`` and ``vlm`` the last ``fed2_decouple``
blocks (``gblocks``) take block-diagonal SwiGLU FFNs (``gffn_*``), the
transformer's counterpart of the paper's group convolutions; the lower
``n_dense_blocks`` stay shared. An ``encdec``'s decoupled decoder blocks
take a block-diagonal GELU FFN with biases; its unembedding stays the
tied table, since the reference tests ``tie_embeddings`` before
``fed2_groups``. ``with_fed2`` forces ``fed2_decouple = 0`` for ``ssm``,
``hybrid`` and ``moe`` (whose experts are the structure groups).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import parallel
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (dense_apply, dense_init, embed_init,
                                       gelu, grouped_dense_apply,
                                       grouped_dense_init, layernorm_apply,
                                       layernorm_init, rmsnorm_apply,
                                       rmsnorm_init, silu)
from repro_torch.models.module import (draw_device, drawing_on,
                                       rematerialized, stack_init)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# the families whose decoupled blocks the port builds (with_fed2 sets
# fed2_decouple = 0 for the others)
DECOUPLED_FAMILIES = ("dense", "vlm", "encdec")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's fields, all six families' and ``with_fed2``'s.
    ``remat_blocks`` recomputes each block's activations in the backward
    pass (plain autograd only: ``models.module.rematerialized``)."""
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
    use_rope: bool = True           # whisper decoder uses learned abs pos
    # moe
    moe: moe_lib.MoEConfig | None = None
    moe_first_dense: int = 0        # deepseek-v2: first layer dense FFN
    moe_dense_ff: int = 0
    ssm: ssm_lib.SSMConfig | None = None
    hybrid_attn_every: int = 0      # zamba2: shared attn block every k layers
    # encdec
    enc_layers: int = 0
    enc_frames: int = 0
    dec_pos_size: int = 32768       # learned decoder pos table (encdec)
    # vlm
    n_patches: int = 0
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
    def mla_cfg(self) -> attn.MLAConfig | None:
        """MLA (its latent and head dims at the MLAConfig defaults) for
        any arch id starting with ``deepseek``, the reference's rule;
        None otherwise."""
        if self.arch_id.startswith("deepseek"):
            return attn.MLAConfig(d_model=self.d_model, n_heads=self.n_heads,
                                  rope_theta=self.rope_theta)
        return None

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

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid") or self.window is not None


def check_ported(cfg: ModelConfig):
    """Raise unless the port builds, trains and decodes ``cfg``: any of
    the six families, decoupled blocks in ``DECOUPLED_FAMILIES`` only (a
    hybrid's layers in whole super-blocks of ``hybrid_attn_every``; an
    encdec with an encoder)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown LM family {cfg.family!r}")
    if cfg.family == "moe" and cfg.moe is None:
        raise ValueError(f"a 'moe' config needs its MoEConfig (cfg.moe); "
                         f"{cfg.arch_id} has none")
    if cfg.fed2_decouple and cfg.family not in DECOUPLED_FAMILIES:
        raise NotImplementedError(
            f"decoupled blocks (fed2_decouple={cfg.fed2_decouple}) are "
            f"ported for the {', '.join(map(repr, DECOUPLED_FAMILIES))} "
            f"families only; with_fed2 sets 0 for {cfg.family!r}")
    if cfg.family == "hybrid" and (cfg.hybrid_attn_every < 1 or
                                   cfg.n_layers % cfg.hybrid_attn_every):
        raise ValueError(
            f"a hybrid's {cfg.n_layers} layers must split into "
            f"super-blocks of hybrid_attn_every={cfg.hybrid_attn_every}")
    if cfg.family == "encdec" and (cfg.enc_layers < 1 or
                                   cfg.enc_frames < 1):
        raise ValueError(
            f"an 'encdec' config needs an encoder (enc_layers >= 1 and "
            f"enc_frames >= 1); {cfg.arch_id} has {cfg.enc_layers} layers "
            f"over {cfg.enc_frames} frames")


# ---------------------------------------------------------------------------
# Norm helpers
# ---------------------------------------------------------------------------


def _norm_init(cfg, device=None):
    init = rmsnorm_init if cfg.norm == "rmsnorm" else layernorm_init
    return init(cfg.d_model, cfg.dtype, device=device)


def _norm_apply(cfg, p, x):
    return (rmsnorm_apply if cfg.norm == "rmsnorm" else layernorm_apply)(p, x)


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


def ffn_apply(p, x, cfg: ModelConfig, *, mesh=None):
    """On a mesh of model ranks ``p`` is the rank's share (gate and up
    columns, down rows): the down product's partials are summed over
    "model"."""
    return parallel.reduce_model(
        dense_apply(p["w_down"], _act(cfg, dense_apply(p["w_gate"], x),
                                      dense_apply(p["w_up"], x))), mesh)


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


def gffn_apply(p, x, cfg: ModelConfig, *, use_kernel: bool = False,
               mesh=None):
    """``use_kernel`` takes its three products through the
    ``grouped_matmul`` kernel (on CUDA tensors; its plain version on the
    CPU): a route the reference does not take (it has the option but no
    caller sets it), for no-grad passes only (decode), since the kernel
    has no backward. False is the reference's einsum. On a mesh of model
    ranks ``p`` is the rank's share: gate and up (G, d/G, f/(G·|model|)),
    down (G, f/(G·|model|), d/G), whose partials are summed over
    "model"."""
    def gd(w, h):
        return grouped_dense_apply(w, h, use_kernel=use_kernel)
    return parallel.reduce_model(
        gd(p["w_down"], _act(cfg, gd(p["w_gate"], x), gd(p["w_up"], x))),
        mesh)


# ---------------------------------------------------------------------------
# Decoder blocks
# ---------------------------------------------------------------------------


def _default_kind(cfg: ModelConfig) -> str:
    """The block kind of a ported family: 'ssm', 'moe' (GQA + experts),
    'mla_moe' (MLA + experts) or 'attn_ffn' (a hybrid's stacked blocks
    are 'ssm', passed as ``kind``; a MoE config's ``pre_blocks`` are
    ``pre_block_kind``'s)."""
    if cfg.family == "ssm":
        return "ssm"
    if cfg.family == "moe":
        return "mla_moe" if cfg.mla_cfg else "moe"
    return "attn_ffn"


def pre_block_kind(cfg: ModelConfig) -> str:
    """The block kind of ``pre_blocks``: 'mla_dense' (MLA + a dense
    FFN) or, without MLA, 'attn_ffn'."""
    return "mla_dense" if cfg.mla_cfg else "attn_ffn"


def pre_block_config(cfg: ModelConfig) -> ModelConfig:
    """The config of ``pre_blocks``: the dense FFN at ``moe_dense_ff``."""
    return dataclasses.replace(cfg, d_ff=cfg.moe_dense_ff)


_MOE_KINDS = ("moe", "mla_moe")


def block_init(gen, cfg: ModelConfig, *, grouped: bool = False,
               kind: str | None = None):
    """One block of ``kind`` (default: the config's): 'ssm' (pre-norm +
    Mamba-2 mixer); 'attn_ffn', 'moe', 'mla_dense' or 'mla_moe'
    (pre-norm GQA, or MLA for the 'mla_' kinds, then a pre-norm FFN:
    routed experts for 'moe' and 'mla_moe', else dense at the config's
    ``d_ff``, ``grouped`` block-diagonal in a decoupled block)."""
    kind = kind or _default_kind(cfg)
    p = {"ln1": _norm_init(cfg, device=draw_device(gen))}
    if kind == "ssm":
        p["mixer"] = ssm_lib.mamba2_init(gen, cfg.ssm, cfg.dtype)
        return p
    p["attn"] = (attn.mla_init(gen, cfg.mla_cfg, cfg.dtype)
                 if kind.startswith("mla_")
                 else attn.gqa_init(gen, cfg.attn_cfg, cfg.dtype))
    p["ln2"] = _norm_init(cfg, device=draw_device(gen))
    if kind in _MOE_KINDS:
        p["ffn"] = moe_lib.moe_init(gen, cfg.moe, cfg.dtype)
    else:
        p["ffn"] = gffn_init(gen, cfg) if grouped else ffn_init(gen, cfg)
    return p


def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def block_apply(p, x, cfg: ModelConfig, *, grouped: bool = False,
                kind: str | None = None, positions=None, mesh=None):
    """A whole sequence through one block: x + mixer(norm(x)) for 'ssm';
    x + attn(norm(x)) (GQA, or MLA for the 'mla_' kinds) at
    ``positions`` (S,), then + ffn(norm(.)) for the others. Returns (x,
    aux): the experts' load-balance loss for 'moe' and 'mla_moe', an
    fp32 0 otherwise. ``mesh``: the rank's program on its shares
    ('ssm' and 'attn_ffn' only)."""
    kind = kind or _default_kind(cfg)
    h = _norm_apply(cfg, p["ln1"], x)
    if kind == "ssm":
        return x + ssm_lib.mamba2_apply(p["mixer"], h, cfg.ssm,
                                        mesh=mesh), _zero_aux(x)
    if kind.startswith("mla_"):
        a = attn.mla_apply(p["attn"], h, cfg.mla_cfg, positions=positions,
                           q_chunk=cfg.attn_q_chunk,
                           kv_chunk=cfg.attn_kv_chunk)
    else:
        a = attn.gqa_apply(p["attn"], h, cfg.attn_cfg, positions=positions,
                           q_chunk=cfg.attn_q_chunk,
                           kv_chunk=cfg.attn_kv_chunk, mesh=mesh)
    x = x + a
    h = _norm_apply(cfg, p["ln2"], x)
    if kind in _MOE_KINDS:
        y, aux = moe_lib.moe_apply(p["ffn"], h, cfg.moe)
        return x + y, aux
    return x + (gffn_apply(p["ffn"], h, cfg, mesh=mesh) if grouped
                else ffn_apply(p["ffn"], h, cfg, mesh=mesh)), _zero_aux(x)


def block_decode(p, x, cache, cfg: ModelConfig, *, pos: int,
                 grouped: bool = False, kind: str | None = None,
                 use_kernel: bool = True, mesh=None):
    """One token through one block at position ``pos``; ``cache`` is
    updated in place. ``use_kernel`` takes the kernels' routes
    (``ssd_update``; ``grouped_matmul`` in a decoupled FFN). The
    experts run drop-free (one token a sequence: capacity n * k) and
    their aux loss is dropped, as the reference's. ``mesh``: the rank's
    program on its shares of the block and the cache."""
    kind = kind or _default_kind(cfg)
    h = _norm_apply(cfg, p["ln1"], x)
    if kind == "ssm":
        y, cache = ssm_lib.mamba2_decode(p["mixer"], h, cache, cfg.ssm,
                                         use_kernel=use_kernel, mesh=mesh)
        return x + y, cache
    if kind.startswith("mla_"):
        a, cache = attn.mla_decode(p["attn"], h, cache, cfg.mla_cfg, pos=pos)
    else:
        a, cache = attn.gqa_decode(p["attn"], h, cache, cfg.attn_cfg,
                                   pos=pos, mesh=mesh)
    x = x + a
    h = _norm_apply(cfg, p["ln2"], x)
    if kind in _MOE_KINDS:
        y, _ = moe_lib.moe_apply(p["ffn"], h, cfg.moe)
    else:
        y = (gffn_apply(p["ffn"], h, cfg, use_kernel=use_kernel, mesh=mesh)
             if grouped else ffn_apply(p["ffn"], h, cfg, mesh=mesh))
    return x + y, cache


# ---------------------------------------------------------------------------
# Unembedding + chunked CE loss
# ---------------------------------------------------------------------------


def unembed_init(gen, cfg: ModelConfig):
    if cfg.fed2_groups > 0:
        return grouped_dense_init(gen, cfg.fed2_groups, cfg.d_model,
                                  cfg.padded_vocab, dtype=cfg.dtype)
    return dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype=cfg.dtype)


def _unembed_product(p, h, cfg: ModelConfig, embed_table, use_kernel):
    if cfg.tie_embeddings:
        return torch.einsum("...d,vd->...v", h, embed_table)
    if cfg.fed2_groups > 0:
        return grouped_dense_apply(p, h, use_kernel=use_kernel)
    return dense_apply(p, h)


def unembed_apply(p, h, cfg: ModelConfig, embed_table=None, *,
                  use_kernel: bool = True):
    """Logits over the first ``vocab`` of ``padded_vocab`` columns. Tied
    embeddings (tested first, as the reference tests them: a Fed2
    Whisper keeps them) take h against ``embed_table`` (padded_vocab,
    d). The Fed2 (block-diagonal) unembedding goes through the
    ``grouped_matmul`` kernel when ``use_kernel`` and the tensors are on
    the card: a route the reference does not take (it computes the same
    function with an einsum), for no-grad passes only (the kernel raises
    under autograd); ``use_kernel=False`` is that einsum."""
    return _unembed_product(p, h, cfg, embed_table,
                            use_kernel)[..., :cfg.vocab]


def unembed(params, h, cfg: ModelConfig, *, use_kernel: bool = True,
            mesh=None):
    """``unembed_apply`` on the whole parameter tree: it takes the tied
    table from ``params["embed"]`` or the ``unembed`` leaf itself. On a
    mesh of model ranks: the rank's logit columns, gathered in vocab
    order (``parallel.gather_logits``)."""
    table = params["embed"]["table"] if cfg.tie_embeddings else None
    return parallel.gather_logits(
        _unembed_product(params.get("unembed"), h, cfg, table, use_kernel),
        cfg, mesh)


def chunked_ce_loss(params, h, labels, mask, cfg: ModelConfig, *,
                    use_kernel: bool = False, mesh=None):
    """Sequence-chunked softmax CE over the first ``vocab`` logits: h
    (B, S, d); labels, mask (B, S). S is right-padded to a multiple of
    ``min(loss_chunk, S)`` (mask 0 there); each chunk's logits are
    rematerialized on the plain-autograd route, so (B, S, V) logits never
    exist. Returns sum(CE * mask) / max(sum(mask), 1). ``use_kernel``
    takes the unembedding's kernel route (no-grad passes only); the
    default is the reference's einsum, which every training route
    takes.

    On a mesh of more than one rank, h and the labels are the rank's
    batch rows and ``params`` its shares: each chunk's CE comes from the
    rank's logit columns (``parallel.vocab_ce``), and the two sums are
    summed over "data" before the division (where the batch is
    replicated over "data" every rank adds the same sums, a common
    factor of the two)."""
    b, s, d = h.shape
    ck = min(cfg.loss_chunk, s)
    nc = -(-s // ck)
    pad = nc * ck - s
    hs = F.pad(h, (0, 0, 0, pad)).reshape(b, nc, ck, d).unbind(1)
    ls = F.pad(labels.long(), (0, pad)).reshape(b, nc, ck).unbind(1)
    ms = F.pad(mask.to(torch.float32), (0, pad)).reshape(b, nc, ck).unbind(1)

    table = params["embed"]["table"] if cfg.tie_embeddings else None

    def chunk_loss(hc, lc, mc):
        ce = parallel.vocab_ce(_unembed_product(
            params.get("unembed"), hc, cfg, table, use_kernel).to(
                torch.float32), lc, cfg, mesh)
        return (ce * mc).sum(), mc.sum()

    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for hc, lc, mc in zip(hs, ls, ms):
        l_, n_ = rematerialized(chunk_loss, hc, lc, mc)
        tot, cnt = tot + l_, cnt + n_
    tot, cnt = parallel.reduce_data(torch.stack([tot, cnt]), mesh)
    return tot / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# Full model init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    """Random parameters from ``gen``, drawn on its device in the
    config's dtype (a full-width model is drawn on the card), or on
    ``device`` when given: ``"meta"`` gives the tree's shapes, dtypes
    and leaf paths and allocates nothing (``launch/analytic.py``,
    ``launch/dryrun.py``). Dense,
    vlm, moe and ssm: the shared blocks under ``blocks`` and the
    ``fed2_decouple`` decoupled ones under ``gblocks``, as the reference
    splits them, a MoE config's first ``moe_first_dense`` layers under
    ``pre_blocks``; hybrid: ``n_layers`` SSM blocks under ``blocks`` and
    the one ``shared_attn`` block; encdec: the encoder (``enc_blocks``,
    ``enc_norm``, ``enc_pos``), the decoder's position table
    (``dec_pos``), its shared and decoupled blocks. Tied embeddings have
    no ``unembed``."""
    check_ported(cfg)
    with drawing_on(device):
        return _draw_params(gen, cfg)


def _draw_params(gen: torch.Generator, cfg: ModelConfig):
    params = {"embed": embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                  cfg.dtype)}
    if cfg.family == "encdec":
        ecfg = encdec_config(cfg)
        params["enc_blocks"] = stack_init(_encdec_enc_block_init, gen,
                                          cfg.enc_layers, cfg=ecfg)
        params["enc_norm"] = _norm_init(ecfg, device=draw_device(gen))
        params["enc_pos"] = _sinusoid_pos(cfg.enc_frames, cfg.d_model,
                                          cfg.dtype, device=draw_device(gen))
        params["dec_pos"] = {"table": 0.02 * torch.randn(
            (cfg.dec_pos_size, cfg.d_model), generator=gen, dtype=cfg.dtype,
            device=draw_device(gen))}
        params["blocks"] = stack_init(_encdec_dec_block_init, gen,
                                      cfg.n_dense_blocks, cfg=ecfg)
        if cfg.fed2_decouple:
            params["gblocks"] = stack_init(_encdec_dec_block_init, gen,
                                           cfg.fed2_decouple, cfg=ecfg,
                                           grouped=True)
    elif cfg.family == "hybrid":
        params["blocks"] = stack_init(block_init, gen, cfg.n_layers,
                                      cfg=cfg, kind="ssm")
        params["shared_attn"] = block_init(gen, cfg, kind="attn_ffn")
    else:
        n_blocks = cfg.n_dense_blocks
        if cfg.family == "moe" and cfg.moe_first_dense:
            params["pre_blocks"] = stack_init(
                block_init, gen, cfg.moe_first_dense,
                cfg=pre_block_config(cfg), kind=pre_block_kind(cfg))
            n_blocks -= cfg.moe_first_dense
        params["blocks"] = stack_init(block_init, gen, n_blocks, cfg=cfg)
        if cfg.fed2_decouple:
            params["gblocks"] = stack_init(block_init, gen,
                                           cfg.fed2_decouple, cfg=cfg,
                                           grouped=True)
    params["final_norm"] = _norm_init(
        encdec_config(cfg) if cfg.family == "encdec" else cfg,
        device=draw_device(gen))
    if not cfg.tie_embeddings:
        params["unembed"] = unembed_init(gen, cfg)
    return params


# ---------------------------------------------------------------------------
# Encoder-decoder (whisper) blocks
# ---------------------------------------------------------------------------


def encdec_config(cfg: ModelConfig) -> ModelConfig:
    """The config an encdec's blocks run under: LayerNorm, GELU, no
    window, no rotary (the reference's ``ecfg``)."""
    return dataclasses.replace(cfg, norm="layernorm", act="gelu",
                               window=None, use_rope=False)


def _sinusoid_pos(length: int, d: int, dtype, device=None):
    """The encoder's sinusoidal position table (length, d): sin at even
    features, cos at odd ones, computed in numpy and fp32 as the
    reference computes it, then cast. A trained leaf."""
    pos = np.arange(length)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / np.power(10000.0, dim / d)
    table = np.zeros((length, d), np.float32)
    table[:, 0::2] = np.sin(ang)
    table[:, 1::2] = np.cos(ang)
    return {"table": torch.from_numpy(table).to(device=device, dtype=dtype)}


def _encdec_enc_block_init(gen, cfg: ModelConfig):
    """An encoder block: ln1, non-causal self-attention, ln2, a dense
    GELU FFN with biases."""
    return {"ln1": _norm_init(cfg, device=draw_device(gen)),
            "attn": attn.gqa_init(gen, cfg.attn_cfg, cfg.dtype),
            "ln2": _norm_init(cfg, device=draw_device(gen)),
            "ffn": _gelu_ffn_init(gen, cfg)}


def _gelu_ffn_init(gen, cfg: ModelConfig, grouped: bool = False):
    """w_up (d, d_ff) and w_down (d_ff, d), with zero biases; under
    ``grouped`` block-diagonal over ``fed2_groups``."""
    if grouped:
        g = cfg.fed2_groups
        return {"w_up": grouped_dense_init(gen, g, cfg.d_model, cfg.d_ff,
                                           bias=True, dtype=cfg.dtype),
                "w_down": grouped_dense_init(gen, g, cfg.d_ff, cfg.d_model,
                                             bias=True, dtype=cfg.dtype)}
    return {"w_up": dense_init(gen, cfg.d_model, cfg.d_ff, bias=True,
                               dtype=cfg.dtype),
            "w_down": dense_init(gen, cfg.d_ff, cfg.d_model, bias=True,
                                 dtype=cfg.dtype)}


def _gelu_ffn_apply(p, x, grouped: bool = False, *, use_kernel: bool = False):
    """down(gelu(up(x))). ``use_kernel`` takes a grouped FFN's two
    products through the ``grouped_matmul`` kernel (on CUDA tensors; its
    plain version on the CPU): a route the reference does not take, for
    no-grad passes only (decode). False is the reference's einsum."""
    if grouped:
        def ap(w, h):
            return grouped_dense_apply(w, h, use_kernel=use_kernel)
    else:
        ap = dense_apply
    return ap(p["w_down"], gelu(ap(p["w_up"], x)))


def _encdec_dec_block_init(gen, cfg: ModelConfig, grouped: bool = False):
    """A decoder block: ln1, causal self-attention, ln_x,
    cross-attention, ln2, a GELU FFN with biases (block-diagonal under
    ``grouped``)."""
    return {"ln1": _norm_init(cfg, device=draw_device(gen)),
            "attn": attn.gqa_init(gen, cfg.attn_cfg, cfg.dtype),
            "ln_x": _norm_init(cfg, device=draw_device(gen)),
            "xattn": attn.gqa_init(gen, cfg.attn_cfg, cfg.dtype),
            "ln2": _norm_init(cfg, device=draw_device(gen)),
            "ffn": _gelu_ffn_init(gen, cfg, grouped=grouped)}
