"""Forward, loss, decode cache and single-token decode for every
family: the port of ``repro.models.forward``.

Public API:
  forward(params, cfg, tokens, embeds=)         -> (hidden, aux_loss)
  lm_loss(params, cfg, batch)                   -> scalar CE + MoE aux
  init_cache(cfg, batch, max_len, device=)      -> decode cache tree
  encdec_prefill_cache(params, cfg, cache, frames) -> cache (encdec)
  decode_step(params, cfg, cache, tokens, pos)  -> (logits, cache)

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

The modality frontends are stubs, as in the reference: ``embeds`` is
their output. A ``vlm`` prepends ``n_patches`` patch embeddings (B,
n_patches, d) to the token embeddings, and ``lm_loss`` scores only the
text positions after them; its decode is text only (the reference has
no patch-embedding decode entry). An ``encdec`` (Whisper) runs its
encoder over ``enc_frames`` frame embeddings (B, enc_frames, d). Its
decode cache holds, per decoder layer, a self-attention KV cache of
``min(max_len, dec_pos_size)`` slots and the cross-attention K and V
(B, enc_frames, Hkv, D), zeros until ``encdec_prefill_cache`` runs the
encoder and fills them (the reference's serve CLI never does, so its
cross-attention adds zero).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import attention as attn
from repro_torch.models import parallel
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import dense_apply, embed_apply
from repro_torch.models.module import (rematerialized, tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.models.transformer import (ModelConfig, _default_kind,
                                            _gelu_ffn_apply, _norm_apply,
                                            _zero_aux,
                                            block_apply, block_decode,
                                            check_ported, chunked_ce_loss,
                                            encdec_config, pre_block_config,
                                            pre_block_kind, unembed)


# the MoE load-balance loss's weight in lm_loss (the reference's default)
AUX_WEIGHT = 0.01
# the families whose forward needs a modality frontend's embeds
FRONTEND_FAMILIES = ("encdec", "vlm")


def refuse_frontend_families(cfg: ModelConfig, where: str):
    """Raise a ValueError naming the family when ``cfg`` is an encdec or
    a vlm: their forward needs frontend ``embeds`` that ``where``'s
    token batches do not carry (the reference fails there too, deeper:
    its ``lm_loss`` reads the missing embeds)."""
    if cfg.family in FRONTEND_FAMILIES:
        raise ValueError(
            f"{where} cannot run the {cfg.family!r} family ({cfg.arch_id}): "
            f"its forward needs frontend embeds (encoder frames or patch "
            f"embeddings) that {where}'s token batch does not carry")


def _layers(params_stack) -> list:
    """The per-layer trees of a stacked (L, ...) params tree, through one
    ``unbind`` per leaf: a gradient taken through them is stacked once
    at the end, where indexing the stack layer by layer makes autograd
    build a zeroed gradient of the whole stack for every layer (at a
    cohort of full-depth Mamba-2 rows, 48 transients of up to 3.4 GB
    each and a stack-sized accumulator from the first layer on)."""
    leaves = tree_leaves(params_stack)
    per_leaf = [t.unbind(0) for t in leaves]
    return [tree_unflatten(params_stack, [p[i] for p in per_leaf])
            for i in range(leaves[0].shape[0])]


def _scan_blocks(params_stack, x, apply_one, remat: bool):
    """``apply_one(layer params, x) -> (x, aux)`` over the stacked layer
    axis, in order. Returns (x, the sum of the layers' aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _layers(params_stack):
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

    layers = _layers(params["blocks"])
    for s in range(cfg.n_layers // k):
        for j in range(s * k, (s + 1) * k):
            x = run(ssm_one, layers[j], x)
        x = run(shared_one, shared, x)
    return x


def _encode(params, cfg: ModelConfig, frames, remat: bool, q_chunk: int,
            kv_chunk: int):
    """The encdec's encoder: frames (B, enc_frames, d) plus ``enc_pos``
    through the non-causal encoder blocks (attention chunks ``q_chunk``
    x ``kv_chunk``) and ``enc_norm``. Returns (its output, the frames'
    positions)."""
    ecfg = encdec_config(cfg)
    x = frames.to(cfg.dtype) + params["enc_pos"]["table"][None]
    enc_pos = torch.arange(cfg.enc_frames, device=x.device)
    acfg = dataclasses.replace(ecfg.attn_cfg, causal=False)

    def enc_apply(p, h):
        hh = _norm_apply(ecfg, p["ln1"], h)
        h = h + attn.gqa_apply(p["attn"], hh, acfg, positions=enc_pos,
                               q_chunk=q_chunk, kv_chunk=kv_chunk)
        h = h + _gelu_ffn_apply(p["ffn"], _norm_apply(ecfg, p["ln2"], h))
        return h, _zero_aux(h)

    x, _ = _scan_blocks(params["enc_blocks"], x, enc_apply, remat)
    return _norm_apply(ecfg, params["enc_norm"], x), enc_pos


def _forward_encdec(params, cfg: ModelConfig, tokens, frames):
    """Whisper: the encoder over ``frames``, then the decoder over
    ``tokens`` at positions arange(S) (its position table's index
    clamped to ``dec_pos_size - 1``), each block's cross-attention over
    the encoder's output."""
    ecfg = encdec_config(cfg)
    enc_out, enc_pos = _encode(params, cfg, frames, cfg.remat_blocks,
                               ecfg.attn_q_chunk, ecfg.attn_kv_chunk)
    s = tokens.shape[1]
    positions = torch.arange(s, device=enc_out.device)
    y = embed_apply(params["embed"], tokens).to(cfg.dtype)
    y = y + params["dec_pos"]["table"][
        torch.clamp(positions, max=cfg.dec_pos_size - 1)][None]
    xcfg = dataclasses.replace(ecfg.attn_cfg, causal=False)

    def dec_apply(p, h, grouped=False):
        hh = _norm_apply(ecfg, p["ln1"], h)
        h = h + attn.gqa_apply(p["attn"], hh, ecfg.attn_cfg,
                               positions=positions, q_chunk=ecfg.attn_q_chunk,
                               kv_chunk=ecfg.attn_kv_chunk)
        hh = _norm_apply(ecfg, p["ln_x"], h)
        kv = attn.cross_kv(p["xattn"], enc_out, xcfg)
        h = h + attn.gqa_apply(p["xattn"], hh, xcfg, positions=positions,
                               kv=kv, kv_positions=enc_pos,
                               q_chunk=ecfg.attn_q_chunk,
                               kv_chunk=ecfg.attn_kv_chunk)
        h = h + _gelu_ffn_apply(p["ffn"], _norm_apply(ecfg, p["ln2"], h),
                                grouped=grouped)
        return h, _zero_aux(h)

    for key, grouped in (("blocks", False), ("gblocks", True)):
        if key in params:
            y, _ = _scan_blocks(params[key], y,
                                lambda p, h, g=grouped: dec_apply(p, h, g),
                                cfg.remat_blocks)
    return _norm_apply(ecfg, params["final_norm"], y), _zero_aux(y)


def forward(params, cfg: ModelConfig, tokens, *, embeds=None, mesh=None):
    """tokens: (B, S) int; ``embeds``: the modality frontend's output
    (encdec: the encoder's input frames (B, enc_frames, d); vlm: patch
    embeddings (B, n_patches, d), prepended to the tokens' embeddings
    in ``cfg.dtype``). Returns (the hidden state (B, S_total, d) after
    the final norm, aux): aux is the MoE blocks' summed load-balance
    loss, an fp32 0 for the other families; positions are
    arange(S_total). ``mesh``: the rank's program (dense and ssm
    families) on its shares of ``params`` and its batch rows; its hidden
    state is whole (replicated over "model")."""
    check_ported(cfg)
    parallel.check_sharded(cfg, mesh, "forward")
    if cfg.family in FRONTEND_FAMILIES and embeds is None:
        raise ValueError(f"the {cfg.family!r} family ({cfg.arch_id}) "
                         "needs its frontend's embeds")
    if cfg.family == "encdec":
        return _forward_encdec(params, cfg, tokens, embeds)
    x = parallel.vocab_embed(params["embed"], tokens, mesh).to(cfg.dtype)
    if cfg.family == "vlm":
        x = torch.cat([embeds.to(cfg.dtype), x], dim=1)
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
                                    positions=positions, mesh=mesh),
                                cfg.remat_blocks)
            aux = aux + a
    return _norm_apply(cfg, params["final_norm"], x), aux


def lm_loss(params, cfg: ModelConfig, batch, *, use_kernel: bool = False,
            mesh=None):
    """batch: {"tokens": (B, S), "labels": (B, S), "mask": (B, S), and
    for encdec and vlm "embeds" (``forward``'s)}. The chunked CE (a vlm:
    on the text positions only) plus AUX_WEIGHT times the forward's aux
    loss. ``use_kernel`` takes the Fed2 unembedding's kernel route, for
    no-grad passes only (``chunked_ce_loss``). ``mesh``: the rank's
    program on its shares and batch rows; the loss is the whole
    batch's on every rank."""
    h, aux = forward(params, cfg, batch["tokens"], embeds=batch.get("embeds"),
                     mesh=mesh)
    if cfg.family == "vlm":
        h = h[:, cfg.n_patches:]
    return chunked_ce_loss(params, h, batch["labels"], batch["mask"], cfg,
                           use_kernel=use_kernel,
                           mesh=mesh) + AUX_WEIGHT * aux


def _stacked(n: int, one):
    """``n`` copies of one layer's cache on a leading layer axis, in
    memory of their own (``contiguous`` would return an expansion to one
    layer as the same tensor)."""
    return tree_map(lambda a: a.expand((n,) + tuple(a.shape)).clone(
        memory_format=torch.contiguous_format), one)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None,
               mesh=None):
    """Decode cache for ``serve_step``: a zeroed SSM state, or a zeroed
    KV cache (MLA: latent cache) of ``max_len`` slots, all empty, per
    layer of ``pre_blocks``, ``blocks`` and ``gblocks``. ``max_len`` is
    the context window to serve; an SSM cache does not grow with it. A
    hybrid's cache holds an SSM state per layer (``blocks``) and a KV
    ring buffer of ``min(max_len, 4096)`` slots per application of its
    shared block (``shared``). An encdec's holds, per decoder layer of
    ``blocks`` and ``gblocks``, ``self`` (a KV cache of ``min(max_len,
    dec_pos_size)`` slots) and ``cross`` (zeroed k and v (batch,
    enc_frames, Hkv, D), for ``encdec_prefill_cache`` to fill). On a mesh
    of more than one rank: the rank's share of that cache
    (``launch/sharding.cache_shardings``), allocated at its own shape."""
    check_ported(cfg)
    if parallel.is_split(mesh):
        from repro_torch.launch import sharding as shd
        like = init_cache(cfg, batch, max_len, device="meta")
        specs = shd.cache_shardings(like, batch, mesh)
        return tree_map(lambda t, sp: torch.full(
            shd.shard_shape(t.shape, sp, mesh), -1 if t.dtype == torch.int32
            else 0, dtype=t.dtype, device=device), like, specs)
    if cfg.family == "encdec":
        kv = (batch, cfg.enc_frames, cfg.n_kv_heads, cfg.head_dim)
        one = {"self": attn.gqa_cache_init(
                   encdec_config(cfg).attn_cfg, batch,
                   min(max_len, cfg.dec_pos_size), cfg.dtype, device=device),
               "cross": {k: torch.zeros(kv, dtype=cfg.dtype, device=device)
                         for k in ("k", "v")}}
        cache = {"blocks": _stacked(cfg.n_dense_blocks, one)}
        if cfg.fed2_decouple:
            cache["gblocks"] = _stacked(cfg.fed2_decouple, one)
        return cache
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


def encdec_prefill_cache(params, cfg: ModelConfig, cache, frames):
    """Whisper's serving step 0: the encoder runs once over ``frames``
    (B, enc_frames, d) and each decoder layer's cross-attention K and V
    are projected from its output into ``cache`` (in place; returned).
    The encoder takes attention chunks of 512 x 1024 whatever the
    config's, as the reference's does, and no remat."""
    check_ported(cfg)
    enc_out, _ = _encode(params, cfg, frames, False, 512, 1024)
    xcfg = dataclasses.replace(encdec_config(cfg).attn_cfg, causal=False)
    for key in ("blocks", "gblocks"):
        if key in cache:
            n = tree_leaves(params[key])[0].shape[0]
            for i in range(n):
                k, v = attn.cross_kv(
                    tree_map(lambda t: t[i], params[key]["xattn"]), enc_out,
                    xcfg)
                cache[key]["cross"]["k"][i] = k
                cache[key]["cross"]["v"][i] = v
    return cache


def _decode_encdec(params, cfg: ModelConfig, cache, x, pos, use_kernel):
    """One token through the Whisper decoder at ``pos`` (its position
    table's index clamped to ``dec_pos_size - 1``): each layer's
    self-attention cache updated in place, then the cross-attention over
    the cached encoder K and V as the reference writes it (scores in the
    activations' dtype divided by sqrt(D) cast to that dtype, an fp32
    softmax, the weights cast back before the PV product). A decoupled
    block's grouped GELU FFN takes the ``grouped_matmul`` kernel route
    under ``use_kernel``, a route the reference does not take (it has
    the einsum)."""
    ecfg = encdec_config(cfg)
    x = x + params["dec_pos"]["table"][min(int(pos), cfg.dec_pos_size - 1)]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(x.dtype)

    def step(p, h, c, grouped):
        b = h.shape[0]
        a, _ = attn.gqa_decode(p["attn"], _norm_apply(ecfg, p["ln1"], h),
                               c["self"], ecfg.attn_cfg, pos=pos)
        h = h + a
        hh = _norm_apply(ecfg, p["ln_x"], h)
        q = dense_apply(p["xattn"]["wq"], hh).reshape(b, hkv, hq // hkv, hd)
        s = torch.einsum("bgrd,bsgd->bgrs", q, c["cross"]["k"]) / scale
        w = torch.softmax(s.to(torch.float32), dim=-1)
        o = torch.einsum("bgrs,bsgd->bgrd", w.to(h.dtype), c["cross"]["v"])
        h = h + dense_apply(p["xattn"]["wo"], o.reshape(b, 1, hq * hd))
        h = h + _gelu_ffn_apply(p["ffn"], _norm_apply(ecfg, p["ln2"], h),
                                grouped, use_kernel=use_kernel)
        return h, c

    for key, grouped in (("blocks", False), ("gblocks", True)):
        if key in params:
            x, _ = _scan_decode(params[key], cache[key], x,
                                lambda p, h, c, g=grouped: step(p, h, c, g))
    return _norm_apply(ecfg, params["final_norm"], x)


def decode_step(params, cfg: ModelConfig, cache, tokens, pos, *,
                use_kernel: bool = True, mesh=None):
    """One-token decode. tokens: (B, 1) int; pos: absolute position (an
    int; an SSM does not read it). Returns (logits (B, 1, vocab),
    cache), ``cache`` updated in place. ``use_kernel`` takes the
    kernels' routes (``ssd_update`` in every SSM layer,
    ``grouped_matmul`` in a decoupled FFN and a Fed2 unembedding);
    False takes the plain ones. A vlm decodes text only; an encdec
    attends over the cross-attention K and V in ``cache`` (zeros unless
    ``encdec_prefill_cache`` filled them) and unembeds through the tied
    table. ``mesh``: the rank's program (dense and ssm families) on its
    shares of ``params`` and ``cache`` and its batch rows of
    ``tokens``; the logits of its rows are whole (gathered over
    "model")."""
    check_ported(cfg)
    parallel.check_sharded(cfg, mesh, "decode_step")
    x = parallel.vocab_embed(params["embed"], tokens, mesh).to(cfg.dtype)
    if cfg.family == "encdec":
        x = _decode_encdec(params, cfg, cache, x, pos, use_kernel)
        return unembed(params, x, cfg, use_kernel=use_kernel), cache
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
                        use_kernel=use_kernel, mesh=mesh))
    x = _norm_apply(cfg, params["final_norm"], x)
    return unembed(params, x, cfg, use_kernel=use_kernel, mesh=mesh), cache
