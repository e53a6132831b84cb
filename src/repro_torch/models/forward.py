"""Forward, loss, decode cache and single-token decode: the ``dense``,
``moe``, ``ssm`` and ``hybrid`` parts of ``repro.models.forward``.

Public API:
  forward(params, cfg, tokens)                 -> (hidden, aux_loss)
  lm_loss(params, cfg, batch)                  -> scalar CE + MoE aux
  init_cache(cfg, batch, max_len, device=)     -> decode cache tree
  decode_step(params, cfg, cache, tokens, pos) -> (logits, cache)

``forward`` applies the stacked blocks in a Python loop over the layer
axis (the reference's ``lax.scan``): a MoE config's dense
``pre_blocks``, the shared ``blocks``, then a dense config's decoupled
``gblocks``. With ``cfg.remat_blocks`` each block is rematerialized on
the plain-autograd route (``models.module.rematerialized``). A hybrid
runs ``n_layers / hybrid_attn_every`` super-blocks: each is
``hybrid_attn_every`` SSM blocks, then one application of the one
``shared_attn`` block (each block and each shared application
rematerialized). Under ``torch.func`` (the round engine's
``vmap(grad(...))``) the blocks run without remat: same numbers, more
activation memory. The auxiliary loss is the sum of the MoE blocks'
load-balance losses; ``lm_loss`` adds ``AUX_WEIGHT`` (0.01) of it.
For the other families it is an fp32 0, so their losses are the CE
exactly.

The cache keeps the reference's stacked layout (a leading layer axis on
every leaf of ``pre_blocks``, ``blocks`` and ``gblocks``; an MLA layer
caches its latent and rotary key; a hybrid's ``blocks`` of SSM states
and ``shared``, one KV cache per application of the shared block).
Unlike the reference, ``decode_step`` updates it IN PLACE and returns
it: at ``decode_32k``'s batch of 128 the SSM state of Mamba-2 1.3B is
12.9 GB, and Llama-3.2-1B's KV cache at 2048 positions 8.6 GB; a new
copy every token would double both the memory and the bytes moved.

The hybrid's window is the reference's: its forward attends over the
whole sequence, while its decode caches (and attends over) the last
``min(max_len, 4096)`` positions in each shared application. The two
agree up to 4096 positions and differ past them, by design.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import embed_apply
from repro_torch.models.module import rematerialized, tree_leaves, tree_map
from repro_torch.models.transformer import (ModelConfig, _default_kind,
                                            _norm_apply, block_apply,
                                            block_decode, check_ported,
                                            chunked_ce_loss, pre_block_config,
                                            pre_block_kind, unembed_apply)


# the MoE load-balance loss's weight in lm_loss (the reference's default)
AUX_WEIGHT = 0.01


def _scan_blocks(params_stack, x, apply_one, remat: bool):
    """``apply_one(layer params, x) -> (x, aux)`` over the stacked layer
    axis, in order. Returns (x, the sum of the layers' aux)."""
    n = tree_leaves(params_stack)[0].shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        lp = tree_map(lambda t: t[i], params_stack)
        x, a = (rematerialized(apply_one, lp, x) if remat
                else apply_one(lp, x))
        aux = aux + a
    return x, aux


def _forward_hybrid(params, cfg: ModelConfig, x, positions):
    """The hybrid's super-blocks: layer ``s * k + j`` for j < k, then
    the shared block, for each super-block s (k = hybrid_attn_every)."""
    k = cfg.hybrid_attn_every
    shared = params["shared_attn"]

    def ssm_one(p, h):
        return block_apply(p, h, cfg, kind="ssm")[0]

    def shared_one(p, h):
        return block_apply(p, h, cfg, kind="attn_ffn",
                           positions=positions)[0]

    def run(fn, p, h):
        return rematerialized(fn, p, h) if cfg.remat_blocks else fn(p, h)

    for s in range(cfg.n_layers // k):
        for j in range(s * k, (s + 1) * k):
            x = run(ssm_one, tree_map(lambda t: t[j], params["blocks"]), x)
        x = run(shared_one, shared, x)
    return x


def forward(params, cfg: ModelConfig, tokens):
    """tokens: (B, S) int. Returns (the hidden state (B, S, d) after the
    final norm, aux): aux is the MoE blocks' summed load-balance loss,
    an fp32 0 for the other families; positions are arange(S)."""
    check_ported(cfg)
    x = embed_apply(params["embed"], tokens).to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        x = _forward_hybrid(params, cfg, x, positions)
        return _norm_apply(cfg, params["final_norm"], x), aux
    if "pre_blocks" in params:
        dcfg, kind = pre_block_config(cfg), pre_block_kind(cfg)
        x, a = _scan_blocks(params["pre_blocks"], x,
                            lambda p, h: block_apply(
                                p, h, dcfg, kind=kind, positions=positions),
                            cfg.remat_blocks)
        aux = aux + a
    for key, grouped in (("blocks", False), ("gblocks", True)):
        if key in params:
            x, a = _scan_blocks(params[key], x,
                                lambda p, h, g=grouped: block_apply(
                                    p, h, cfg, grouped=g,
                                    positions=positions),
                                cfg.remat_blocks)
            aux = aux + a
    return _norm_apply(cfg, params["final_norm"], x), aux


def lm_loss(params, cfg: ModelConfig, batch, *, use_kernel: bool = False):
    """batch: {"tokens": (B, S), "labels": (B, S), "mask": (B, S)}. The
    chunked CE plus AUX_WEIGHT times the forward's aux loss.
    ``use_kernel`` takes the Fed2 unembedding's kernel route, for
    no-grad passes only (``chunked_ce_loss``)."""
    h, aux = forward(params, cfg, batch["tokens"])
    return chunked_ce_loss(params, h, batch["labels"], batch["mask"], cfg,
                           use_kernel=use_kernel) + AUX_WEIGHT * aux


def _stacked(n: int, one):
    """``n`` copies of one layer's cache on a leading layer axis, in
    memory of their own (``contiguous`` would return an expansion to one
    layer as the same tensor)."""
    return tree_map(lambda a: a.expand((n,) + tuple(a.shape)).clone(
        memory_format=torch.contiguous_format), one)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None):
    """Decode cache for ``serve_step``: a zeroed SSM state, or a zeroed
    KV cache (MLA: latent cache) of ``max_len`` slots, all empty, per
    layer of ``pre_blocks``, ``blocks`` and ``gblocks``. ``max_len`` is
    the context window to serve; an SSM cache does not grow with it. A hybrid's cache holds an SSM
    state per layer (``blocks``) and a KV ring buffer of
    ``min(max_len, 4096)`` slots per application of its shared block
    (``shared``)."""
    check_ported(cfg)
    if cfg.family == "hybrid":
        one = ssm_lib.mamba2_cache_init(cfg.ssm, batch, cfg.dtype,
                                        device=device)
        acfg = dataclasses.replace(cfg.attn_cfg, window=min(max_len, 4096))
        shared = attn.gqa_cache_init(acfg, batch, max_len, cfg.dtype,
                                     device=device)
        return {"blocks": _stacked(cfg.n_layers, one),
                "shared": _stacked(cfg.n_layers // cfg.hybrid_attn_every,
                                   shared)}
    def layer_cache(kind):
        if kind == "ssm":
            return ssm_lib.mamba2_cache_init(cfg.ssm, batch, cfg.dtype,
                                             device=device)
        if kind.startswith("mla_"):
            return attn.mla_cache_init(cfg.mla_cfg, batch, max_len,
                                       cfg.dtype, device=device)
        return attn.gqa_cache_init(cfg.attn_cfg, batch, max_len, cfg.dtype,
                                   device=device)

    kind = _default_kind(cfg)
    cache = {}
    n_blocks = cfg.n_dense_blocks
    if cfg.family == "moe" and cfg.moe_first_dense:
        cache["pre_blocks"] = _stacked(cfg.moe_first_dense,
                                       layer_cache(pre_block_kind(cfg)))
        n_blocks -= cfg.moe_first_dense
    cache["blocks"] = _stacked(n_blocks, layer_cache(kind))
    if cfg.fed2_decouple:
        cache["gblocks"] = _stacked(cfg.fed2_decouple, layer_cache(kind))
    return cache


def _scan_decode(params_stack, caches, x, step_one):
    """``step_one(layer params, x, layer cache) -> (x, layer cache)`` over
    the stacked layer axis, in order. Each layer's cache is a tree of
    views into ``caches``, which ``step_one`` updates in place."""
    n = tree_leaves(params_stack)[0].shape[0]
    for i in range(n):
        x, _ = step_one(tree_map(lambda t: t[i], params_stack), x,
                        tree_map(lambda t: t[i], caches))
    return x, caches


def _decode_hybrid(params, cfg: ModelConfig, cache, x, pos, use_kernel):
    """One token through the hybrid's super-blocks: the SSM layers'
    states (``cache["blocks"][j]``) and super-block s's own KV cache
    (``cache["shared"][s]``), each updated in place; the shared block
    attends over a window of its cache's size."""
    k = cfg.hybrid_attn_every
    shared = params["shared_attn"]
    shared_cfg = dataclasses.replace(cfg,
                                     window=cache["shared"]["k"].shape[2])
    for s in range(cfg.n_layers // k):
        for j in range(s * k, (s + 1) * k):
            x, _ = block_decode(tree_map(lambda t: t[j], params["blocks"]),
                                x, tree_map(lambda t: t[j], cache["blocks"]),
                                cfg, pos=pos, kind="ssm",
                                use_kernel=use_kernel)
        x, _ = block_decode(shared, x,
                            tree_map(lambda t: t[s], cache["shared"]),
                            shared_cfg, pos=pos, kind="attn_ffn")
    return x


def decode_step(params, cfg: ModelConfig, cache, tokens, pos, *,
                use_kernel: bool = True):
    """One-token decode. tokens: (B, 1) int; pos: absolute position (an
    int; an SSM does not read it). Returns (logits (B, 1, vocab),
    cache), ``cache`` updated in place. ``use_kernel`` takes the
    kernels' routes (``ssd_update`` in every SSM layer,
    ``grouped_matmul`` in a decoupled FFN and a Fed2 unembedding);
    False takes the plain ones."""
    check_ported(cfg)
    x = embed_apply(params["embed"], tokens).to(cfg.dtype)
    if cfg.family == "hybrid":
        x = _decode_hybrid(params, cfg, cache, x, pos, use_kernel)
    else:
        if "pre_blocks" in params:
            dcfg, kind = pre_block_config(cfg), pre_block_kind(cfg)
            x, _ = _scan_decode(params["pre_blocks"], cache["pre_blocks"], x,
                                lambda p, h, c: block_decode(
                                    p, h, c, dcfg, pos=pos, kind=kind,
                                    use_kernel=use_kernel))
        for key, grouped in (("blocks", False), ("gblocks", True)):
            if key in params:
                x, _ = _scan_decode(
                    params[key], cache[key], x,
                    lambda p, h, c, g=grouped: block_decode(
                        p, h, c, cfg, pos=pos, grouped=g,
                        use_kernel=use_kernel))
    x = _norm_apply(cfg, params["final_norm"], x)
    logits = unembed_apply(params["unembed"], x, cfg, use_kernel=use_kernel)
    return logits, cache
