"""Forward, loss, decode cache and single-token decode: the ``dense``
and ``ssm`` parts of ``repro.models.forward``.

Public API:
  forward(params, cfg, tokens)                 -> hidden
  lm_loss(params, cfg, batch)                  -> scalar CE
  init_cache(cfg, batch, max_len, device=)     -> decode cache tree
  decode_step(params, cfg, cache, tokens, pos) -> (logits, cache)

``forward`` applies the stacked blocks in a Python loop over the layer
axis (the reference's ``lax.scan``): the shared ``blocks``, then a dense
config's decoupled ``gblocks``. With ``cfg.remat_blocks`` each block is
rematerialized on the plain-autograd route
(``models.module.rematerialized``). Under ``torch.func`` (the round
engine's ``vmap(grad(...))``) the blocks run without remat: same
numbers, more activation memory. The reference's forward also returns
an auxiliary loss (MoE balance), which is 0 for the ported families:
the port returns the hidden state alone until a family with an
auxiliary loss is ported.

The cache keeps the reference's stacked layout (a leading layer axis on
every leaf, ``blocks`` and ``gblocks``). Unlike the reference,
``decode_step`` updates it IN PLACE and returns it: at ``decode_32k``'s
batch of 128 the SSM state of Mamba-2 1.3B is 12.9 GB, and
Llama-3.2-1B's KV cache at 2048 positions 8.6 GB; a new copy every
token would double both the memory and the bytes moved.
"""
from __future__ import annotations

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


def forward(params, cfg: ModelConfig, tokens):
    """tokens: (B, S) int. Returns the hidden state (B, S, d) after the
    final norm; positions are arange(S)."""
    check_ported(cfg)
    x = embed_apply(params["embed"], tokens).to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
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
    SSM cache does not grow with it."""
    check_ported(cfg)
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
