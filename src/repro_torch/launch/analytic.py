"""Analytic FLOP / byte model of one step: the reference's
``repro.launch.analytic``, formula for formula.

These are the numbers a benchmark divides by (a share of the card's
peak). Their conventions are the reference's and stay so:

  dense matmul flops        = 2 * m * n * k
  linear-stack flops        = 2 * N_active * tokens   (N = matmul params)
  causal attention          = 2 * 2 * B * S * S_eff * H * hd, S_eff = S/2
  sliding window            = S_eff = min(S/2, W)
  SSD (chunked)             = intra (q-quadratic) + state update terms
  train flops               = 3 x fwd (bwd ~ 2x fwd)
  parameter bytes           = 2 (bf16)

``param_counts`` counts a tree built on ``meta`` (the reference's
``jax.eval_shape``): exact, and nothing is allocated.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.models.module import tree_leaves
from repro_torch.models.transformer import ModelConfig, init_params


def param_counts(cfg: ModelConfig) -> dict:
    """Exact total param count (a meta tree) + analytic active count."""
    shapes = init_params(torch.Generator().manual_seed(0), cfg,
                         device="meta")
    total = sum(math.prod(leaf.shape) for leaf in tree_leaves(shapes))
    active = total
    if cfg.moe is not None:
        m = cfg.moe
        n_moe_layers = cfg.n_layers - cfg.moe_first_dense
        per_expert = 3 * m.d_model * m.d_ff_expert
        active = total - n_moe_layers * (m.n_experts - m.top_k) * per_expert
    return {"total": total, "active": active}


def _attn_flops_fwd(cfg: ModelConfig, b: int, s: int) -> float:
    if cfg.family == "ssm":
        return _ssd_flops_fwd(cfg, b, s) * cfg.n_layers
    h, hd = cfg.n_heads, cfg.head_dim
    s_eff = min(s / 2, cfg.window) if cfg.window else s / 2
    per_layer = 4.0 * b * s * s_eff * h * hd
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.hybrid_attn_every
        return (per_layer * n_attn +
                _ssd_flops_fwd(cfg, b, s) * cfg.n_layers)
    if cfg.family == "encdec":
        enc = 4.0 * b * cfg.enc_frames * (cfg.enc_frames / 2) * h * hd \
            * cfg.enc_layers * 2  # bidirectional (no causal halving)
        cross = 4.0 * b * s * cfg.enc_frames * h * hd * cfg.n_layers
        return per_layer * cfg.n_layers + enc + cross
    return per_layer * cfg.n_layers


def _ssd_flops_fwd(cfg: ModelConfig, b: int, s: int) -> float:
    ssm = cfg.ssm
    q = min(ssm.chunk, s)
    h, p, n = ssm.n_heads, ssm.headdim, ssm.d_state
    intra = 2.0 * b * s * q * (h * p + n)   # L-matrix + CB einsums
    state = 4.0 * b * s * h * p * n         # state build + readout
    return intra + state


def analytic_cost(cfg: ModelConfig, shape: InputShape) -> dict:
    """Global analytic flops/bytes for one step of (cfg, shape)."""
    counts = param_counts(cfg)
    n_tot, n_act = counts["total"], counts["active"]
    b, s = shape.global_batch, shape.seq_len
    pbytes = 2  # bf16 params
    if shape.mode in ("train", "prefill"):
        tokens = b * (s - cfg.n_patches if cfg.family == "vlm" else s) \
            + (b * cfg.n_patches if cfg.family == "vlm" else 0)
        linear = 2.0 * n_act * tokens
        attn = _attn_flops_fwd(cfg, b, s)
        fwd = linear + attn
        if shape.mode == "train":
            flops = 3.0 * fwd
            # params r/w + grads + fp32 m,v r/w + activations stream
            act_bytes = 2.0 * tokens * cfg.d_model * cfg.n_layers * 2 * 6
            bytes_ = n_tot * (pbytes * 2 + 2 + 8 * 2) + act_bytes
        else:
            flops = fwd
            act_bytes = 2.0 * tokens * cfg.d_model * cfg.n_layers * 2 * 4
            bytes_ = n_tot * pbytes + act_bytes
    else:  # decode: one token, cache attend
        flops = 2.0 * n_act * b + _decode_attn_flops(cfg, b, s)
        bytes_ = n_act * pbytes + _cache_bytes(cfg, b, s) * 1.0
    return {"flops": flops, "bytes": bytes_, "params_total": n_tot,
            "params_active": n_act,
            "model_flops_6nd": 6.0 * n_act * (b * s)
            if shape.mode == "train" else 2.0 * n_act *
            (b * s if shape.mode == "prefill" else b)}


def _decode_attn_flops(cfg: ModelConfig, b: int, s: int) -> float:
    if cfg.family == "ssm":
        ssm = cfg.ssm
        return 6.0 * b * ssm.n_heads * ssm.headdim * ssm.d_state \
            * cfg.n_layers
    h, hd = cfg.n_heads, cfg.head_dim
    s_eff = min(s, cfg.window) if cfg.window else s
    if cfg.mla_cfg:
        m = cfg.mla_cfg
        per = 2.0 * b * h * s_eff * (m.kv_lora + m.qk_rope_dim) * 2
        return per * cfg.n_layers
    per = 4.0 * b * h * hd * s_eff
    if cfg.family == "hybrid":
        ssm = cfg.ssm
        n_attn = cfg.n_layers // cfg.hybrid_attn_every
        return per * n_attn + 6.0 * b * ssm.n_heads * ssm.headdim * \
            ssm.d_state * cfg.n_layers
    if cfg.family == "encdec":
        cross = 4.0 * b * h * hd * cfg.enc_frames * cfg.n_layers
        return per * cfg.n_layers + cross
    return per * cfg.n_layers


def _cache_bytes(cfg: ModelConfig, b: int, s: int) -> float:
    """Bytes read per decode step (the cache stream dominates)."""
    if cfg.family == "ssm":
        ssm = cfg.ssm
        return 4.0 * b * ssm.n_heads * ssm.headdim * ssm.d_state \
            * cfg.n_layers
    if cfg.mla_cfg:
        m = cfg.mla_cfg
        return 2.0 * b * s * (m.kv_lora + m.qk_rope_dim) * cfg.n_layers
    s_eff = min(s, cfg.window) if cfg.window else s
    kv = 2.0 * b * s_eff * cfg.n_kv_heads * cfg.head_dim * 2
    if cfg.family == "hybrid":
        ssm = cfg.ssm
        n_attn = cfg.n_layers // cfg.hybrid_attn_every
        kv_shared = 2.0 * b * min(s, 4096) * cfg.n_kv_heads \
            * cfg.head_dim * 2
        return kv_shared * n_attn + 4.0 * b * ssm.n_heads * ssm.headdim \
            * ssm.d_state * cfg.n_layers
    return kv * cfg.n_layers
