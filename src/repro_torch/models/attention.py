"""Grouped-query attention (GQA) with rotary positions: the GQA half of
``repro.models.attention``.

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

Decode keeps the reference's cache: ``k``, ``v`` (B, size, Hkv, D) and
a shared ``slot_pos`` (size,) int32 of the absolute position held in
each slot, -1 while empty. ``gqa_decode`` writes the new row and its
position IN PLACE: at batch 128 and 2048 positions the 16-layer cache
of Llama-3.2-1B is 8.6 GB in bf16, and a copy per token would double it.

Sliding windows (the ring-buffer cache), QKV biases, QK-norm and
partial rotary are fields of ``AttnConfig`` but not ported yet:
``check_gqa_ported`` refuses a config that sets them, at init, cache
init and every forward (``transformer.check_ported``). MLA and
cross-attention wait for the MoE and encoder-decoder families.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (apply_rope, dense_apply, dense_init,
                                       rope_freqs)
from repro_torch.models.module import rematerialized

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


def check_gqa_ported(cfg: AttnConfig):
    """Raise unless the port has every feature ``cfg`` asks for."""
    unported = [name for name, on in (
        ("window", cfg.window is not None), ("qkv_bias", cfg.qkv_bias),
        ("qk_norm", cfg.qk_norm),
        ("rotary_pct < 1", 0 < cfg.rotary_dim < cfg.head_dim)) if on]
    if unported:
        raise NotImplementedError(
            f"attention with {', '.join(unported)} is not ported yet "
            "(ROADMAP.md, Queue 1 item 2)")


def gqa_init(gen, cfg: AttnConfig, dtype=torch.float32):
    check_gqa_ported(cfg)
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": dense_init(gen, d, hq * hd, dtype=dtype),
            "wk": dense_init(gen, d, hkv * hd, dtype=dtype),
            "wv": dense_init(gen, d, hkv * hd, dtype=dtype),
            "wo": dense_init(gen, hq * hd, d, dtype=dtype)}


def _project_qkv(p, x, cfg: AttnConfig, positions):
    """x (B, S, d) -> q (B, S, Hq, D), k, v (B, S, Hkv, D), q and k
    rotated at ``positions`` (S,)."""
    b, s, _ = x.shape
    q = dense_apply(p["wq"], x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = dense_apply(p["wk"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = dense_apply(p["wv"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.rotary_dim > 0:
        inv = rope_freqs(cfg.head_dim, cfg.rope_theta, cfg.rotary_dim,
                         device=x.device)
        pos_b = positions[None, :].expand(b, s)
        q = apply_rope(q, pos_b, inv, rotary_dim=cfg.rotary_dim)
        k = apply_rope(k, pos_b, inv, rotary_dim=cfg.rotary_dim)
    return q, k, v


def gqa_apply(p, x, cfg: AttnConfig, *, positions=None, q_chunk=512,
              kv_chunk=1024):
    """Full-sequence self-attention (train / prefill): x (B, S, d) ->
    (B, S, d); ``positions`` (S,) default arange(S)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = chunked_attention(q, k, v, q_positions=positions,
                          kv_positions=positions, causal=cfg.causal,
                          window=cfg.window, q_chunk=q_chunk,
                          kv_chunk=kv_chunk)
    return dense_apply(p["wo"], o.reshape(b, s, cfg.n_heads * cfg.head_dim))


# --- decode -----------------------------------------------------------------


def gqa_cache_init(cfg: AttnConfig, batch: int, max_len: int, dtype, *,
                   device=None):
    """One layer's decode cache: zeroed k, v (batch, max_len, Hkv, D) and
    slot_pos (max_len,) int32 at -1 (empty)."""
    check_gqa_ported(cfg)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((max_len,), -1, dtype=torch.int32,
                                   device=device)}


def gqa_decode(p, x, cache, cfg: AttnConfig, *, pos: int):
    """One-token decode: x (B, 1, d) at absolute position ``pos``.
    Writes k, v and slot_pos at slot ``pos`` of ``cache`` in place and
    attends over the slots that hold a position in [0, pos]. Returns
    (y (B, 1, d), cache)."""
    b = x.shape[0]
    pos = int(pos)
    size = cache["k"].shape[1]
    if not 0 <= pos < size:
        raise ValueError(f"decode position {pos} outside the cache's "
                         f"{size} slots (init_cache's max_len)")
    q, k, v = _project_qkv(p, x, cfg, torch.full((1,), pos,
                                                 device=x.device))
    cache["k"][:, pos] = k[:, 0]
    cache["v"][:, pos] = v[:, 0]
    cache["slot_pos"][pos] = pos
    ck, cv, spos = cache["k"], cache["v"], cache["slot_pos"]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qg = q.reshape(b, hkv, hq // hkv, hd)
    s = torch.einsum("bgrd,bsgd->bgrs", qg, ck).to(torch.float32)
    s = s * (1.0 / math.sqrt(hd))
    valid = (spos >= 0) & (spos <= pos)
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrs,bsgd->bgrd", w.to(cv.dtype), cv)
    return dense_apply(p["wo"], o.reshape(b, 1, hq * hd)), cache
