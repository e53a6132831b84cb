"""Decode cache and single-token decode: the ``ssm`` part of
``repro.models.forward``.

Public API:
  init_cache(cfg, batch, max_len, device=)     -> decode cache tree
  decode_step(params, cfg, cache, tokens, pos) -> (logits, cache)

The cache keeps the reference's stacked layout (a leading layer axis on
every leaf). Unlike the reference, ``decode_step`` updates it IN PLACE
and returns it: at ``decode_32k``'s batch of 128 the SSM state of
Mamba-2 1.3B is 12.9 GB, and a new copy every token would double both
the memory and the bytes moved. The train/prefill forward and the loss
(``forward``, ``lm_loss``) are not ported yet.
"""
from __future__ import annotations

from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import embed_apply
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.models.transformer import (ModelConfig, _norm_apply,
                                            block_decode, check_ported,
                                            unembed_apply)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None):
    """Decode cache for ``serve_step``, zeroed. ``max_len`` is the
    context window to serve; an SSM cache does not grow with it."""
    check_ported(cfg)
    one = ssm_lib.mamba2_cache_init(cfg.ssm, batch, cfg.dtype,
                                    device=device)
    return {"blocks": tree_map(
        lambda a: a.new_zeros((cfg.n_layers,) + tuple(a.shape)), one)}


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
    """One-token decode. tokens: (B, 1) int; pos: absolute position (the
    reference's signature; an SSM does not read it). Returns (logits
    (B, 1, vocab), cache), ``cache`` updated in place. ``use_kernel``
    takes the kernels' routes (``ssd_update`` in every layer,
    ``grouped_matmul`` for a Fed2 unembedding); False takes the plain
    ones."""
    check_ported(cfg)
    x = embed_apply(params["embed"], tokens).to(cfg.dtype)
    x, _ = _scan_decode(
        params["blocks"], cache["blocks"], x,
        lambda p, h, c: block_decode(p, h, c, cfg, use_kernel=use_kernel))
    x = _norm_apply(cfg, params["final_norm"], x)
    logits = unembed_apply(params["unembed"], x, cfg, use_kernel=use_kernel)
    return logits, cache
