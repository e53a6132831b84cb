"""Forward, loss, decode cache and single-token decode: the ``dense``,
``ssm`` and ``hybrid`` parts of ``repro.models.forward``.

Public API:
  forward(params, cfg, tokens)                 -> hidden
  lm_loss(params, cfg, batch)                  -> scalar CE
  init_cache(cfg, batch, max_len, device=)     -> decode cache tree
  decode_step(params, cfg, cache, tokens, pos) -> (logits, cache)

``forward`` applies the stacked blocks in a Python loop over the layer
axis (the reference's ``lax.scan``): the shared ``blocks``, then a dense
config's decoupled ``gblocks``. With ``cfg.remat_blocks`` each block is
rematerialized on the plain-autograd route
(``models.module.rematerialized``). A hybrid runs ``n_layers /
hybrid_attn_every`` super-blocks: each is ``hybrid_attn_every`` SSM
blocks, then one application of the one ``shared_attn`` block (each
block and each shared application rematerialized). Under
``torch.func`` (the round engine's ``vmap(grad(...))``) the blocks run
without remat: same numbers, more activation memory. The reference's
forward also returns an auxiliary loss (MoE balance), which is 0 for
the ported families: the port returns the hidden state alone until a
family with an auxiliary loss is ported.

The cache keeps the reference's stacked layout (a leading layer axis on
every leaf, ``blocks`` and ``gblocks``; a hybrid's ``blocks`` of SSM
states and ``shared``, one KV cache per application of the shared
block). Unlike the reference,
``decode_step`` updates it IN PLACE and returns it: at ``decode_32k``'s
batch of 128 the SSM state of Mamba-2 1.3B is 12.9 GB, and
Llama-3.2-1B's KV cache at 2048 positions 8.6 GB; a new copy every
token would double both the memory and the bytes moved.

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
                                            chunked_ce_loss, unembed_apply)


def _scan_blocks(params_stack, x, apply_one, remat: bool):
    """``apply_one(layer params, x) -> x`` over the stacked layer axis,
    in order."""
    n = tree_leaves(params_stack)[0].shape[0]
    for i in range(n):
        lp = tree_map(lambda t: t[i], params_stack)
        x = (rematerialized(apply_one, lp, x) if remat
             else apply_one(lp, x))
    return x


def _forward_hybrid(params, cfg: ModelConfig, x, positions):
    """The hybrid's super-blocks: layer ``s * k + j`` for j < k, then
    the shared block, for each super-block s (k = hybrid_attn_every)."""
    k = cfg.hybrid_attn_every
    shared = params["shared_attn"]

    def ssm_one(p, h):
        return block_apply(p, h, cfg, kind="ssm")

    def shared_one(p, h):
        return block_apply(p, h, cfg, kind="attn_ffn", positions=positions)

    def run(fn, p, h):
        return rematerialized(fn, p, h) if cfg.remat_blocks else fn(p, h)

    for s in range(cfg.n_layers // k):
        for j in range(s * k, (s + 1) * k):
            x = run(ssm_one, tree_map(lambda t: t[j], params["blocks"]), x)
        x = run(shared_one, shared, x)
    return x


def forward(params, cfg: ModelConfig, tokens):
    """tokens: (B, S) int. Returns the hidden state (B, S, d) after the
    final norm; positions are arange(S)."""
    check_ported(cfg)
    x = embed_apply(params["embed"], tokens).to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.family == "hybrid":
        x = _forward_hybrid(params, cfg, x, positions)
        return _norm_apply(cfg, params["final_norm"], x)
    x = _scan_blocks(params["blocks"], x,
                     lambda p, h: block_apply(p, h, cfg,
                                              positions=positions),
                     cfg.remat_blocks)
    if "gblocks" in params:
        x = _scan_blocks(params["gblocks"], x,
                         lambda p, h: block_apply(p, h, cfg, grouped=True,
                                                  positions=positions),
                         cfg.remat_blocks)
    return _norm_apply(cfg, params["final_norm"], x)


def lm_loss(params, cfg: ModelConfig, batch, *, use_kernel: bool = False):
    """batch: {"tokens": (B, S), "labels": (B, S), "mask": (B, S)}.
    ``use_kernel`` takes the Fed2 unembedding's kernel route, for
    no-grad passes only (``chunked_ce_loss``)."""
    h = forward(params, cfg, batch["tokens"])
    return chunked_ce_loss(params, h, batch["labels"], batch["mask"], cfg,
                           use_kernel=use_kernel)


def _stacked(n: int, one):
    """``n`` copies of one layer's cache on a leading layer axis, in
    memory of their own (``contiguous`` would return an expansion to one
    layer as the same tensor)."""
    return tree_map(lambda a: a.expand((n,) + tuple(a.shape)).clone(
        memory_format=torch.contiguous_format), one)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None):
    """Decode cache for ``serve_step``: a zeroed SSM state, or a zeroed
    KV cache of ``max_len`` slots, all empty, per layer of ``blocks``
    (and of ``gblocks``). ``max_len`` is the context window to serve; an
    SSM cache does not grow with it. A hybrid's cache holds an SSM
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
    if _default_kind(cfg) == "ssm":
        one = ssm_lib.mamba2_cache_init(cfg.ssm, batch, cfg.dtype,
                                        device=device)
    else:
        one = attn.gqa_cache_init(cfg.attn_cfg, batch, max_len, cfg.dtype,
                                  device=device)
    cache = {"blocks": _stacked(cfg.n_dense_blocks, one)}
    if cfg.fed2_decouple:
        cache["gblocks"] = _stacked(cfg.fed2_decouple, one)
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
