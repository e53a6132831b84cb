"""Grouped-query attention (GQA) with rotary positions and DeepSeek-V2's
multi-head latent attention (MLA): ``repro.models.attention``, with the
cross-attention of the encoder-decoder family (Whisper).

Train and prefill use a flash-style chunked attention: a Python loop
over query chunks and, inside it, over key/value chunks with an online
softmax, so no (B, H, S, S) score tensor ever exists. Each kv step is
rematerialized on the plain-autograd route
(``models.module.rematerialized``, the reference's
``jax.checkpoint(kv_body)``): otherwise the backward would keep every
kv chunk's (B, H, Tq, Tk) softmax. Under ``torch.func`` (the round
engine's ``vmap(grad(...))``) the steps run without remat. The math is
the reference's einsums as plain torch; the reference has no kernel
here.

The block has the reference's options: QKV biases (qwen2), a per-head
RMSNorm of q and k before the rotation (stablelm's QK-norm), partial
rotary (the first ``rotary_dim`` features of a head rotate, the rest
pass through) and a sliding window (h2o-danube).

Decode keeps the reference's cache: ``k``, ``v`` (B, size, Hkv, D) and
a shared ``slot_pos`` (size,) int32 of the absolute position held in
each slot, -1 while empty. Without a window, position ``pos`` lives in
slot ``pos`` (size = max_len); with one, the cache is a ring buffer of
``min(max_len, window)`` slots and position ``pos`` lives in slot ``pos
% size``. ``gqa_decode`` writes the new row and its position IN PLACE:
at batch 128 and 2048 positions the 16-layer cache of Llama-3.2-1B is
8.6 GB in bf16, and a copy per token would double it.

MLA compresses K and V into a (kv_lora,) latent and one shared rotary
key per position. Train and prefill (``mla_apply``) expand the latent to
per-head K and V and take the chunked attention above (V zero-padded to
the q/k head dim, as the reference pads it); decode (``mla_decode``)
caches only the latent and the rotary key, (B, max_len, kv_lora +
rope_dim), and absorbs the K and V up-projections into the query and
the output.

Cross-attention (the Whisper decoder's) takes K and V that ``cross_kv``
projects once from the encoder's output; ``gqa_apply(..., kv=(k, v),
kv_positions=)`` then projects only q and attends without a causal
mask. Its decode reads the same K and V from the cache that
``forward.encdec_prefill_cache`` fills (``forward._decode_encdec``).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.launch.collectives import all_to_all
from repro_torch.models.layers import (apply_rope, dense_apply, dense_init,
                                       rmsnorm_apply, rmsnorm_init,
                                       rope_freqs)
from repro_torch.models.module import draw_device, rematerialized
from repro_torch.models.parallel import (gather_model, is_split,
                                         model_coord, model_size,
                                         reduce_model, row_dense, split)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Chunked (flash-style) attention core
# ---------------------------------------------------------------------------


def _attend_block(q, k, v, bias):
    """q (B, Hq, Tq, D); k, v (B, Hkv, Tk, D); bias (1, 1, Tq, Tk) fp32
    -> this block's partial softmax: o (B, Hq, Tq, D) in v's dtype, and
    the row max m and row sum l (B, Hq, Tq, 1) fp32. Scores in the
    inputs' dtype, then fp32 and scaled by 1/sqrt(D); m is floored at
    NEG_INF, so a row with every key masked stays finite."""
    b, hq, tq, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, tq, d)
    s = torch.einsum("bgrtd,bgkd->bgrtk", qg, k).to(torch.float32)
    s = s * (1.0 / math.sqrt(d)) + bias[:, :, None]
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bgrtk,bgkd->bgrtd", p.to(v.dtype), v)
    return (o.reshape(b, hq, tq, d), m.reshape(b, hq, tq, 1),
            l.reshape(b, hq, tq, 1))


def _kv_step(o_acc, m_acc, l_acc, qc, qpos_c, kc, vc, kpos_c, kval_c, *,
             causal: bool, window: int | None):
    """One kv chunk folded into the running (o, m, l) of a q chunk."""
    mask = kval_c[None, :]
    if causal:
        mask = mask & (kpos_c[None, :] <= qpos_c[:, None])
    if window is not None:
        mask = mask & (kpos_c[None, :] > qpos_c[:, None] - window)
    bias = torch.where(mask, 0.0, NEG_INF).to(torch.float32)[None, None]
    o, m, l = _attend_block(qc, kc, vc, bias)
    m_new = torch.maximum(m_acc, m)
    c_old = torch.exp(m_acc - m_new)
    c_new = torch.exp(m - m_new)
    o_acc = o_acc * c_old.to(o_acc.dtype) + o * c_new.to(o.dtype)
    l_acc = l_acc * c_old + l * c_new
    return o_acc, m_new, l_acc


def _pad_to(x, n: int, dim: int):
    pad = n - x.shape[dim]
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - dim) + [0, pad]
    return F.pad(x, widths)


def chunked_attention(q, k, v, *, q_positions, kv_positions, causal: bool,
                      window: int | None = None, q_chunk: int = 512,
                      kv_chunk: int = 1024, kv_valid_len=None):
    """Online-softmax attention. q (B, S_q, Hq, D); k, v (B, S_kv, Hkv,
    D); positions (S_q,), (S_kv,) int. Returns (B, S_q, Hq, D) in q's
    dtype.

    q, k, v and the positions are right-padded to chunk multiples (pad
    positions 0); keys at or past ``kv_valid_len`` (default S_kv) are
    masked, as are future keys when ``causal``. The accumulators o, m, l
    are fp32, the PV product takes p in v's dtype, and the output is o
    divided by max(l, 1e-30)."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    nq = -(-sq // q_chunk)
    nk = -(-skv // kv_chunk)
    qp = _pad_to(q, nq * q_chunk, 1).transpose(1, 2)        # (B,Hq,Sq,D)
    kp = _pad_to(k, nk * kv_chunk, 1).transpose(1, 2)
    vp = _pad_to(v, nk * kv_chunk, 1).transpose(1, 2)
    qpos = _pad_to(q_positions, nq * q_chunk, 0).reshape(nq, q_chunk)
    kpos = _pad_to(kv_positions, nk * kv_chunk, 0).reshape(nk, kv_chunk)
    kvalid = (torch.arange(nk * kv_chunk, device=q.device)
              < (skv if kv_valid_len is None else kv_valid_len))
    kvalid = kvalid.reshape(nk, kv_chunk)
    step = functools.partial(_kv_step, causal=causal, window=window)

    outs = []
    for i in range(nq):
        qc = qp[:, :, i * q_chunk:(i + 1) * q_chunk]
        o = torch.zeros(qc.shape, dtype=torch.float32, device=q.device)
        m = torch.full(qc.shape[:-1] + (1,), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros(qc.shape[:-1] + (1,), dtype=torch.float32,
                        device=q.device)
        for j in range(nk):
            sl = slice(j * kv_chunk, (j + 1) * kv_chunk)
            o, m, l = rematerialized(step, o, m, l, qc, qpos[i], kp[:, :, sl],
                                     vp[:, :, sl], kpos[j], kvalid[j])
        outs.append((o / torch.clamp(l, min=1e-30)).to(q.dtype))
    out = torch.cat(outs, dim=2)[:, :, :sq]
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0          # stablelm: 0.25
    qkv_bias: bool = False           # qwen2
    qk_norm: bool = False            # stablelm-2 style per-head norm
    window: int | None = None        # SWA (mixtral / h2o-danube)
    causal: bool = True

    @property
    def rotary_dim(self):
        rd = int(self.head_dim * self.rotary_pct)
        return rd - rd % 2


def gqa_init(gen, cfg: AttnConfig, dtype=torch.float32):
    """wq, wk, wv (with zero biases under ``qkv_bias``) and wo; with
    ``qk_norm`` the per-head ``q_norm`` and ``k_norm`` RMSNorm scales
    over ``head_dim`` (ones)."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bias = cfg.qkv_bias
    p = {"wq": dense_init(gen, d, hq * hd, bias=bias, dtype=dtype),
         "wk": dense_init(gen, d, hkv * hd, bias=bias, dtype=dtype),
         "wv": dense_init(gen, d, hkv * hd, bias=bias, dtype=dtype),
         "wo": dense_init(gen, hq * hd, d, dtype=dtype)}
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, device=draw_device(gen))
        p["k_norm"] = rmsnorm_init(hd, dtype, device=draw_device(gen))
    return p


def _project_qkv(p, x, cfg: AttnConfig, positions):
    """x (B, S, d) -> q (B, S, Hq, D), k, v (B, S, Hkv, D): q and k
    normalized per head under ``qk_norm``, then their first
    ``rotary_dim`` features rotated at ``positions`` (S,)."""
    b, s, _ = x.shape
    q = dense_apply(p["wq"], x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = dense_apply(p["wk"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = dense_apply(p["wv"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q, k = _norm_rope(p, q, k, cfg, positions)
    return q, k, v


def _norm_rope(p, q, k, cfg: AttnConfig, positions):
    """q (B, S, *, D) and k (B, S, *, D) of whole heads: normalized per
    head under ``qk_norm``, then their first ``rotary_dim`` features
    rotated at ``positions`` (S,)."""
    b, s = q.shape[:2]
    if cfg.qk_norm:
        q = rmsnorm_apply(p["q_norm"], q)
        k = rmsnorm_apply(p["k_norm"], k)
    if cfg.rotary_dim > 0:
        inv = rope_freqs(cfg.head_dim, cfg.rope_theta, cfg.rotary_dim,
                         device=q.device)
        pos_b = positions[None, :].expand(b, s)
        q = apply_rope(q, pos_b, inv, rotary_dim=cfg.rotary_dim)
        k = apply_rope(k, pos_b, inv, rotary_dim=cfg.rotary_dim)
    return q, k


def gqa_apply(p, x, cfg: AttnConfig, *, positions=None, kv=None,
              kv_positions=None, q_chunk=512, kv_chunk=1024, mesh=None):
    """Full-sequence attention (train / prefill): x (B, S, d) -> (B, S,
    d); ``positions`` (S,) default arange(S). Self-attention, or with
    ``kv=(k, v)`` (B, S_kv, Hkv, D) precomputed by ``cross_kv``
    cross-attention: only q is projected (and normalized under
    ``qk_norm``; no rotation), the mask is not causal, and the keys sit
    at ``kv_positions`` (S_kv,). ``mesh``: the rank's self-attention
    on its shares (``_gqa_apply_ranks``)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    if is_split(mesh):
        if kv is not None:
            raise NotImplementedError("cross-attention has no sharded "
                                      "program")
        return _gqa_apply_ranks(p, x, cfg, positions, q_chunk, kv_chunk,
                                mesh)
    if kv is None:
        q, k, v = _project_qkv(p, x, cfg, positions)
        kv_positions, causal = positions, cfg.causal
    else:
        q = dense_apply(p["wq"], x).reshape(b, s, cfg.n_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = rmsnorm_apply(p["q_norm"], q)
        (k, v), causal = kv, False
    o = chunked_attention(q, k, v, q_positions=positions,
                          kv_positions=kv_positions, causal=causal,
                          window=cfg.window, q_chunk=q_chunk,
                          kv_chunk=kv_chunk)
    return dense_apply(p["wo"], o.reshape(b, s, cfg.n_heads * cfg.head_dim))


def cross_kv(p, enc_out, cfg: AttnConfig):
    """K and V (B, S_enc, Hkv, D) of cross-attention, projected once from
    the encoder's output (B, S_enc, d); k normalized under ``qk_norm``."""
    b, s, _ = enc_out.shape
    k = dense_apply(p["wk"], enc_out).reshape(b, s, cfg.n_kv_heads,
                                              cfg.head_dim)
    v = dense_apply(p["wv"], enc_out).reshape(b, s, cfg.n_kv_heads,
                                              cfg.head_dim)
    if cfg.qk_norm:
        k = rmsnorm_apply(p["k_norm"], k)
    return k, v


def _kv_heads(cfg: AttnConfig, mesh) -> tuple:
    """(the rank's q heads, the first kv head they read, how many kv
    heads they read), its q heads a block of ``n_heads / |model|``. The
    block must read whole kv groups or lie in one."""
    nq = split(cfg.n_heads, mesh, "query heads")
    rep = cfg.n_heads // cfg.n_kv_heads
    if (nq % rep if nq >= rep else rep % nq):
        raise NotImplementedError(
            f"{nq} query heads a rank against kv groups of {rep}")
    first = model_coord(mesh) * nq // rep
    return nq, first, max(nq // rep, 1)


def _gqa_apply_ranks(p, x, cfg: AttnConfig, positions, q_chunk, kv_chunk,
                     mesh):
    """The rank's prefill attention: its whole q heads (wq's columns),
    the whole kv heads they read (wk and wv's columns, all-gathered over
    "model" in one call where they lie on other ranks too, as with fewer
    kv heads than model ranks), the chunked attention, then wo's rows
    (row-parallel)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    nq, first, need = _kv_heads(cfg, mesh)
    cols = split(cfg.n_kv_heads * hd, mesh, "key/value columns")
    q = dense_apply(p["wq"], x).reshape(b, s, nq, hd)
    k, v = dense_apply(p["wk"], x), dense_apply(p["wv"], x)
    lo = first * hd - model_coord(mesh) * cols
    if lo < 0 or lo + need * hd > cols:     # not all on this rank
        g = gather_model(torch.cat([k, v], dim=-1), mesh)
        k, v = (g[..., i * cols:(i + 1) * cols].movedim(0, -2).reshape(
            b, s, cfg.n_kv_heads * hd) for i in (0, 1))
        lo = first * hd
    k = k[..., lo:lo + need * hd].reshape(b, s, need, hd)
    v = v[..., lo:lo + need * hd].reshape(b, s, need, hd)
    q, k = _norm_rope(p, q, k, cfg, positions)
    o = chunked_attention(q, k, v, q_positions=positions,
                          kv_positions=positions, causal=cfg.causal,
                          window=cfg.window, q_chunk=q_chunk,
                          kv_chunk=kv_chunk)
    return row_dense(p["wo"], o.reshape(b, s, nq * hd), mesh)


# --- decode -----------------------------------------------------------------


def gqa_cache_init(cfg: AttnConfig, batch: int, max_len: int, dtype, *,
                   device=None):
    """One layer's decode cache: zeroed k, v (batch, size, Hkv, D) and
    slot_pos (size,) int32 at -1 (empty); size is ``max_len``, or
    ``min(max_len, window)`` with a sliding window (a ring buffer)."""
    size = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((size,), -1, dtype=torch.int32,
                                   device=device)}


def _decode_slot(pos: int, size: int, cfg: AttnConfig) -> int:
    if cfg.window:
        return pos % size
    if 0 <= pos < size:
        return pos
    raise ValueError(f"decode position {pos} outside the cache's "
                     f"{size} slots (init_cache's max_len)")


def _attend_slots(s, spos, pos: int, cfg: AttnConfig):
    """fp32 scores (B, G, R, S) over the cache's slots -> their softmax
    weights: the slots holding a position in [0, pos] (with a window,
    only those past ``pos - window``)."""
    valid = (spos >= 0) & (spos <= pos)
    if cfg.window:
        valid = valid & (spos > pos - cfg.window)
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    return torch.softmax(s, dim=-1)


def gqa_decode(p, x, cache, cfg: AttnConfig, *, pos: int, mesh=None):
    """One-token decode: x (B, 1, d) at absolute position ``pos``.
    Writes k, v and slot_pos at slot ``pos`` of ``cache`` in place (slot
    ``pos % size`` with a window, overwriting the oldest position) and
    attends over the slots that hold a position in [0, pos], and with a
    window only those past ``pos - window``. Returns (y (B, 1, d),
    cache). ``mesh``: the rank's program on its shares
    (``_gqa_decode_ranks``)."""
    b = x.shape[0]
    pos = int(pos)
    slot = _decode_slot(pos, cache["k"].shape[1], cfg)
    if is_split(mesh):
        return _gqa_decode_ranks(p, x, cache, cfg, pos, slot, mesh)
    q, k, v = _project_qkv(p, x, cfg, torch.full((1,), pos,
                                                 device=x.device))
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["slot_pos"][slot] = pos
    ck, cv, spos = cache["k"], cache["v"], cache["slot_pos"]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qg = q.reshape(b, hkv, hq // hkv, hd)
    s = torch.einsum("bgrd,bsgd->bgrs", qg, ck).to(torch.float32)
    s = s * (1.0 / math.sqrt(hd))
    w = _attend_slots(s, spos, pos, cfg)
    o = torch.einsum("bgrs,bsgd->bgrd", w.to(cv.dtype), cv)
    return dense_apply(p["wo"], o.reshape(b, 1, hq * hd)), cache


def _gqa_decode_ranks(p, x, cache, cfg: AttnConfig, pos: int, slot: int,
                      mesh):
    """The rank's one-token decode over its cache share, which holds
    ``head_dim / |model|`` features of every kv head (the reference's
    cache placement). The token's q, k and v columns are all-gathered
    over "model" in one call and normalized and rotated as whole heads;
    the rank writes its features of k and v, scores every head over
    them (fp32 partials, summed over "model", then rounded to the
    cache's dtype as the one-process product is), weighs its features
    of v, and an all-to-all returns each rank its q heads' whole outputs
    for wo's rows."""
    b = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    m, r = model_size(mesh), model_coord(mesh)
    nq = split(hq, mesh, "query heads")
    cols = split(hkv * hd, mesh, "key/value columns")
    dl = split(hd, mesh, "head_dim")
    qkv = torch.cat([dense_apply(p[w], x[:, 0]) for w in ("wq", "wk", "wv")],
                    dim=-1)
    g = gather_model(qkv, mesh)                   # (m, B, nq·hd + 2 cols)

    def whole(lo, hi, heads):
        return g[..., lo:hi].movedim(0, 1).reshape(b, 1, heads, hd)

    q = whole(0, nq * hd, hq)
    k = whole(nq * hd, nq * hd + cols, hkv)
    v = whole(nq * hd + cols, nq * hd + 2 * cols, hkv)
    q, k = _norm_rope(p, q, k, cfg, torch.full((1,), pos, device=x.device))
    mine = slice(r * dl, (r + 1) * dl)
    cache["k"][:, slot] = k[:, 0, :, mine]
    cache["v"][:, slot] = v[:, 0, :, mine]
    cache["slot_pos"][slot] = pos
    ck, cv = cache["k"], cache["v"]
    qg = q[:, 0, :, mine].reshape(b, hkv, hq // hkv, dl)
    s = torch.einsum("bgrd,bsgd->bgrs", qg.to(torch.float32),
                     ck.to(torch.float32))
    s = reduce_model(s, mesh).to(ck.dtype).to(torch.float32)
    w = _attend_slots(s * (1.0 / math.sqrt(hd)), cache["slot_pos"], pos, cfg)
    o = torch.einsum("bgrs,bsgd->bgrd", w.to(cv.dtype), cv)
    o = all_to_all(o.reshape(b, m, nq, dl).movedim(1, 0).contiguous(),
                   mesh, "model")                 # chunk i: rank i's dims
    o = o.permute(1, 2, 0, 3).reshape(b, 1, nq * hd)
    return row_dense(p["wo"], o, mesh), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora: int = 512
    q_lora: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0

    @property
    def qk_head_dim(self):
        return self.qk_nope_dim + self.qk_rope_dim


def mla_init(gen, cfg: MLAConfig, dtype=torch.float32):
    """The query's low-rank pair wq_a (d, q_lora), q_a_norm, wq_b
    (q_lora, H * (nope + rope)); the latent's wkv_a (d, kv_lora + rope),
    kv_a_norm; its up-projections wk_b (kv_lora, H * nope) and wv_b
    (kv_lora, H * v); and wo (H * v, d)."""
    h = cfg.n_heads
    return {
        "wq_a": dense_init(gen, cfg.d_model, cfg.q_lora, dtype=dtype),
        "q_a_norm": rmsnorm_init(cfg.q_lora, dtype,
                                 device=draw_device(gen)),
        "wq_b": dense_init(gen, cfg.q_lora, h * cfg.qk_head_dim,
                           dtype=dtype),
        "wkv_a": dense_init(gen, cfg.d_model, cfg.kv_lora + cfg.qk_rope_dim,
                            dtype=dtype),
        "kv_a_norm": rmsnorm_init(cfg.kv_lora, dtype,
                                  device=draw_device(gen)),
        "wk_b": dense_init(gen, cfg.kv_lora, h * cfg.qk_nope_dim,
                           dtype=dtype),
        "wv_b": dense_init(gen, cfg.kv_lora, h * cfg.v_head_dim,
                           dtype=dtype),
        "wo": dense_init(gen, h * cfg.v_head_dim, cfg.d_model, dtype=dtype),
    }


def _mla_rope(x, positions, cfg: MLAConfig):
    """x (B, S, H, rope_dim) rotated at ``positions`` (S,)."""
    inv = rope_freqs(cfg.qk_rope_dim, cfg.rope_theta, device=x.device)
    return apply_rope(x, positions[None, :].expand(x.shape[0], -1), inv)


def _mla_q(p, x, cfg: MLAConfig, positions):
    """x (B, S, d) -> q_nope (B, S, H, nope), q_rope (B, S, H, rope)
    rotated at ``positions``."""
    b, s, _ = x.shape
    cq = rmsnorm_apply(p["q_a_norm"], dense_apply(p["wq_a"], x))
    q = dense_apply(p["wq_b"], cq).reshape(b, s, cfg.n_heads,
                                           cfg.qk_head_dim)
    return (q[..., :cfg.qk_nope_dim],
            _mla_rope(q[..., cfg.qk_nope_dim:], positions, cfg))


def _mla_latent(p, x, cfg: MLAConfig, positions):
    """x (B, S, d) -> the normalized latent c_kv (B, S, kv_lora) and the
    shared rotary key k_rope (B, S, rope) rotated at ``positions``."""
    b, s, _ = x.shape
    kv = dense_apply(p["wkv_a"], x)
    c_kv = rmsnorm_apply(p["kv_a_norm"], kv[..., :cfg.kv_lora])
    k_rope = kv[..., cfg.kv_lora:].reshape(b, s, 1, cfg.qk_rope_dim)
    return c_kv, _mla_rope(k_rope, positions, cfg)[:, :, 0]


def mla_apply(p, x, cfg: MLAConfig, *, positions=None, q_chunk=512,
              kv_chunk=1024):
    """Train / prefill: x (B, S, d) -> (B, S, d). The latent expanded to
    per-head K (nope features from wk_b, the shared rotary key on every
    head) and V (zero-padded from v_head_dim to the q/k head dim), then
    the causal chunked attention at scale 1/sqrt(qk_head_dim)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    h = cfg.n_heads
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    k_nope = dense_apply(p["wk_b"], c_kv).reshape(b, s, h, cfg.qk_nope_dim)
    v = dense_apply(p["wv_b"], c_kv).reshape(b, s, h, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(
        b, s, h, cfg.qk_rope_dim)], dim=-1)
    vpad = F.pad(v, (0, cfg.qk_head_dim - cfg.v_head_dim))
    o = chunked_attention(q, k, vpad, q_positions=positions,
                          kv_positions=positions, causal=True,
                          q_chunk=q_chunk, kv_chunk=kv_chunk)
    o = o[..., :cfg.v_head_dim].reshape(b, s, h * cfg.v_head_dim)
    return dense_apply(p["wo"], o)


def mla_cache_init(cfg: MLAConfig, batch: int, max_len: int, dtype, *,
                   device=None):
    """One layer's decode cache: zeroed c_kv (batch, max_len, kv_lora)
    and k_rope (batch, max_len, rope_dim), slot_pos (max_len,) int32 at
    -1 (empty)."""
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                  dtype=dtype, device=device),
            "slot_pos": torch.full((max_len,), -1, dtype=torch.int32,
                                   device=device)}


def mla_decode(p, x, cache, cfg: MLAConfig, *, pos: int):
    """Absorbed one-token decode: x (B, 1, d) at position ``pos``. Writes
    the token's latent, rotary key and position at slot ``pos`` of
    ``cache`` in place (a position past the cache's ``max_len`` slots
    raises, as ``gqa_decode`` without a window does), then scores every
    filled slot as q_nope W_uk . c_kv + q_rope . k_rope at scale
    1/sqrt(qk_head_dim) and absorbs W_uv into the output. Returns (y
    (B, 1, d), cache)."""
    b = x.shape[0]
    pos = int(pos)
    size = cache["c_kv"].shape[1]
    if not 0 <= pos < size:
        raise ValueError(f"decode position {pos} outside the cache's "
                         f"{size} slots (init_cache's max_len)")
    positions = torch.full((1,), pos, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)        # (B, 1, H, *)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)     # (B, 1, *)
    cache["c_kv"][:, pos] = c_kv[:, 0]
    cache["k_rope"][:, pos] = k_rope[:, 0]
    cache["slot_pos"][pos] = pos
    ck, cr, spos = cache["c_kv"], cache["k_rope"], cache["slot_pos"]
    h = cfg.n_heads
    wk_b = p["wk_b"]["w"].reshape(cfg.kv_lora, h, cfg.qk_nope_dim)
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0], wk_b)
    s = (torch.einsum("bhl,bsl->bhs", q_lat, ck)
         + torch.einsum("bhd,bsd->bhs", q_rope[:, 0], cr))
    s = s.to(torch.float32) * (1.0 / math.sqrt(cfg.qk_head_dim))
    valid = (spos >= 0) & (spos <= pos)
    w = torch.softmax(torch.where(valid[None, None, :], s, NEG_INF), dim=-1)
    o_lat = torch.einsum("bhs,bsl->bhl", w.to(ck.dtype), ck)
    wv_b = p["wv_b"]["w"].reshape(cfg.kv_lora, h, cfg.v_head_dim)
    o = torch.einsum("bhl,lhd->bhd", o_lat, wv_b)
    return dense_apply(p["wo"], o.reshape(b, 1, h * cfg.v_head_dim)), cache
