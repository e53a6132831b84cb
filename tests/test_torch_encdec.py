"""The port's encoder-decoder family (``whisper-base``: a non-causal
pre-LayerNorm encoder over stubbed frame embeddings, a decoder with
causal self-attention, cross-attention over the encoder's output and a
GELU FFN with biases, a learned decoder position table, and the
unembedding tied to the embedding table) against the JAX package, on
the CPU, from the same numpy inputs and the same weights (the
reference's ``init_params``, converted by ``convert.lm_to_port``). The
model is the reduced config (2 + 2 layers, d 256, 64 frames, fp32),
plain and under ``with_fed2(groups=4, decouple=1)``: a decoupled decoder
block with a block-diagonal GELU FFN, the unembedding still the tied
table (the reference tests ``tie_embeddings`` first).

LayerNorm scales start at 1 and every bias at 0, which would hide a
norm or a bias applied in the wrong place, so every parity test first
sets each norm scale to 1 + 0.3 N(0, 1) and each bias (the norms' and
the FFNs') to N(0, 0.5), the same in both packages.

Tolerances, as max |got - want| <= tol * max |want|:
- ``layernorm_apply`` fp32 and bf16, ``cross_kv``, ``gqa_apply(kv=)``,
  ``forward(embeds=)``, ``lm_loss``, and ``encdec_prefill_cache`` plus
  ``decode_step`` (logits and every cache leaf after every token):
  1e-5 (matmuls summed in other orders; the bf16 LayerNorm rounds the
  same fp32 value in the same order);
- gradients, per leaf (``enc_pos`` included): 1e-4 of the leaf's
  largest gradient;
- the train step: losses rtol 1e-5 over 3 steps, params as
  tests/test_torch_dense.py holds them;
- greedy serve tokens equal wherever the reference's top-2 logit gap
  exceeds 1e-4;
- the kernel routes on the CPU (the wrappers' plain versions) against
  the plain routes, and the chunked forward against the prefilled
  decode: 1e-6 and 1e-5;
- parameter counts, config fields, tree paths, shapes and dtypes:
  equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.common import with_fed2 as jax_with_fed2
from repro.data.synthetic import lm_batch_from_tokens as jax_lm_batch
from repro.fl import runtime as jrt
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import forward as jfwd
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.models.module import param_count as jax_param_count
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import get_config
from repro_torch.configs.common import with_fed2
from repro_torch.convert import lm_to_port, lm_to_reference
from repro_torch.fl import runtime as rt
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention, layers
from repro_torch.models import forward as fwd
from repro_torch.models import transformer as tfm
from repro_torch.models.module import param_count, tree_leaves, tree_paths

ARCH = "whisper-base"
GAP = 1e-4
# the reference's param_count(jax.eval_shape(init_params)) of the full
# config, plain and under with_fed2(groups=8) (chip_smoke.py's
# SERVE_PARAMS)
FULL_PARAMS = {0: 88_256_512, 8: 86_421_504}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(groups=0, reduced=True, **over):
    """(reference config, port config); ``groups`` applies with_fed2
    (decouple 1 on the reduced config, the rule's depth on the full
    one); field overrides on both."""
    jc = jax_get_config(ARCH, reduced=reduced)
    tc = get_config(ARCH, reduced=reduced)
    if groups:
        dec = 1 if reduced else None
        jc = jax_with_fed2(jc, groups=groups, decouple=dec)
        tc = with_fed2(tc, groups=groups, decouple=dec)
    return dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)


def _perturbed(tree, rng, path=()):
    """``tree`` (numpy) with every bias (``b``, a norm's ``bias``) drawn
    N(0, 0.5) and every norm ``scale`` 1 + 0.3 N(0, 1), from ``rng``, in
    flattening order."""
    if isinstance(tree, dict):
        return {k: _perturbed(tree[k], rng, path + (k,))
                for k in sorted(tree)}
    if path[-1] in ("b", "bias"):
        return rng.normal(0.0, 0.5, tree.shape).astype(tree.dtype)
    if path[-1] == "scale":
        return (1.0 + 0.3 * rng.normal(size=tree.shape)).astype(tree.dtype)
    return tree


_INIT = {}


def _params(groups=0, **over):
    """The reference's reduced init (``init_params`` at PRNGKey(0),
    jitted) as numpy with its biases and norm scales perturbed, and the
    port's conversion of it; cached."""
    key = (groups, tuple(sorted(over.items())))
    if key not in _INIT:
        jc, _ = _configs(groups, **over)
        jp = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k: jtfm.init_params(k, jc))(jax.random.PRNGKey(0)))
        jp = _perturbed(jp, np.random.default_rng(1))
        _INIT[key] = (jp, lm_to_port(jp))
    return _INIT[key]


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, tol=1e-5):
    """max |got - want| <= tol * max |want|."""
    got = _np(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    got, want = got.astype(np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (err, scale)


def _frames(cfg, b, seed):
    """Stub frontend output (b, enc_frames, d) ~ N(0, 1)."""
    return np.random.default_rng(seed).normal(
        size=(b, cfg.enc_frames, cfg.d_model)).astype(np.float32)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, s + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "mask": (rng.random((b, s)) > 0.2).astype(np.float32),
            "embeds": _frames(cfg, b, seed + 100)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------


def test_the_arch_is_registered():
    assert ARCH in PORT_ARCHS and ARCH in train.FRONTEND_ARCHS
    assert ARCH not in train.LM_ARCHS


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("groups", [0, 4, 8])
def test_configs_match_reference(reduced, groups):
    """Field for field, with_fed2's decouple depth included."""
    jc, tc = _configs(groups, reduced=reduced)
    for f in ("arch_id", "family", "n_layers", "d_model", "vocab", "d_ff",
              "n_heads", "n_kv_heads", "head_dim", "norm", "act",
              "rope_theta", "rotary_pct", "qkv_bias", "qk_norm", "window",
              "use_rope", "enc_layers", "enc_frames", "dec_pos_size",
              "n_patches", "tie_embeddings",
              "fed2_groups", "fed2_decouple", "n_dense_blocks",
              "padded_vocab", "loss_chunk", "attn_q_chunk", "attn_kv_chunk",
              "remat_blocks"):
        assert getattr(tc, f) == getattr(jc, f), f
    for f in ("d_model", "n_heads", "n_kv_heads", "head_dim", "rotary_pct",
              "rotary_dim", "window", "causal"):
        assert getattr(tc.attn_cfg, f) == getattr(jc.attn_cfg, f), f
    assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
    tfm.check_ported(tc)


@pytest.mark.parametrize("groups", [0, 8])
def test_full_config_sizes(groups):
    """The reference's parameter count of the full config (its
    ``jax.eval_shape``) equals the pinned constant the card's serve
    phase checks, and the port's init of the full config (on
    ``meta``) has it leaf for leaf: no ``unembed`` (tied), and under
    Fed2 8 one decoupled block whose GELU FFN is (8, 64, 256) up and
    (8, 256, 64) down, with biases."""
    jc, tc = _configs(groups, reduced=False)
    want = jax.eval_shape(lambda k: jtfm.init_params(k, jc),
                          jax.random.PRNGKey(0))
    assert jax_param_count(want) == FULL_PARAMS[groups]
    got = tfm.init_params(torch.Generator(), tc, device="meta")
    assert param_count(got) == FULL_PARAMS[groups]
    assert tree_paths(got) == tree_paths(
        jax.tree_util.tree_map(lambda s: 0, want))
    for w, g in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        assert tuple(w.shape) == tuple(g.shape)
        assert g.dtype == torch.bfloat16
    assert "unembed" not in got and tc.fed2_decouple == (1 if groups else 0)
    if groups:
        ff = got["gblocks"]["ffn"]
        assert tuple(ff["w_up"]["w"].shape) == (1, 8, 64, 256)
        assert tuple(ff["w_up"]["b"].shape) == (1, 8, 256)
        assert tuple(ff["w_down"]["w"].shape) == (1, 8, 256, 64)
        assert tc.padded_vocab == 51968


@pytest.mark.parametrize("groups", [0, 4])
def test_init_params_tree_matches_reference(groups):
    """Same leaves (the encoder, ``enc_pos``, ``dec_pos``, the decoder's
    ``xattn`` and ``ln_x``, the FFN biases, no ``unembed``), shapes,
    dtypes and parameter count; the encoder's sinusoid table equals the
    reference's to the bit; ``lm_to_port`` and ``lm_to_reference``
    carry the reference's tree across and back to the bit."""
    jc, tc = _configs(groups)
    want = jax.eval_shape(lambda k: jtfm.init_params(k, jc),
                          jax.random.PRNGKey(0))
    got = tfm.init_params(torch.Generator().manual_seed(0), tc)
    assert tree_paths(got) == tree_paths(
        jax.tree_util.tree_map(lambda s: 0, want))
    for w, g in zip(jax.tree_util.tree_leaves(want),
                    tree_leaves(lm_to_reference(got))):
        assert w.shape == g.shape and jnp.dtype(w.dtype) == g.dtype
    assert param_count(got) == jax_param_count(want)
    assert "unembed" not in got and ("gblocks" in got) == bool(groups)
    jp = jax.jit(lambda k: jtfm.init_params(k, jc))(jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got["enc_pos"]["table"].numpy(),
                                  np.asarray(jp["enc_pos"]["table"]))
    jp, tp = _params(groups)
    back = lm_to_reference(tp)
    assert tree_paths(back) == tree_paths(jp) and "unembed" not in back
    for a, b in zip(tree_leaves(back), tree_leaves(jp)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# layers and attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """fp32 statistics, the normalized value cast to the input dtype,
    then scale and bias in that dtype (the reference's order)."""
    rng = np.random.default_rng(2)
    x = (3.0 + 2.0 * rng.normal(size=(3, 7, 256))).astype(np.float32)
    p = {"scale": (1 + 0.3 * rng.normal(size=256)).astype(np.float32),
         "bias": rng.normal(0.0, 0.5, size=256).astype(np.float32)}
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jlayers.layernorm_apply({k: jnp.asarray(v, jd)
                                    for k, v in p.items()},
                                   jnp.asarray(x, jd))
    got = layers.layernorm_apply({k: torch.as_tensor(v).to(td)
                                  for k, v in p.items()},
                                 torch.as_tensor(x).to(td))
    assert got.dtype == td
    _close(got, want)
    init = layers.layernorm_init(8, td)
    assert (init["scale"] == 1).all() and (init["bias"] == 0).all()


def test_cross_attention_matches_reference():
    """``cross_kv`` of an encoder output (64 frames) and
    ``gqa_apply(kv=, kv_positions=)`` of a 12-token decoder input over
    it, at q chunks of 8 and kv chunks of 24 (64 frames pad to 72: the
    pad keys masked), non-causal."""
    jc, tc = _configs()
    jp, _ = _params()
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["xattn"])
    tl = lm_to_port(jl)
    jx = dataclasses.replace(jc.attn_cfg, causal=False)
    tx = dataclasses.replace(tc.attn_cfg, causal=False)
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(2, 64, 256)).astype(np.float32)
    x = rng.normal(size=(2, 12, 256)).astype(np.float32)
    jk, jv = jattn.cross_kv(jl, jnp.asarray(enc), jx)
    tk, tv = attention.cross_kv(tl, torch.as_tensor(enc), tx)
    _close(tk, jk)
    _close(tv, jv)
    kw = dict(q_chunk=8, kv_chunk=24)
    want = jattn.gqa_apply(jl, jnp.asarray(x), jx, positions=jnp.arange(12),
                           kv=(jk, jv), kv_positions=jnp.arange(64), **kw)
    got = attention.gqa_apply(tl, torch.as_tensor(x), tx,
                              positions=torch.arange(12), kv=(tk, tv),
                              kv_positions=torch.arange(64), **kw)
    _close(got, want)


@pytest.mark.parametrize("grouped", [False, True])
def test_gelu_ffn_matches_reference(grouped):
    """The encoder's dense GELU FFN and the decoupled block's grouped
    one, biases on; the grouped FFN's kernel route (the wrapper's plain
    version on the CPU) equals its einsum."""
    jc, tc = _configs(4)
    jp, _ = _params(4)
    key = "gblocks" if grouped else "enc_blocks"
    jl = jax.tree_util.tree_map(lambda a: a[0], jp[key]["ffn"])
    tl = lm_to_port(jl)
    x = np.random.default_rng(4).normal(size=(2, 5, 256)).astype(np.float32)
    want = jtfm._gelu_ffn_apply(jl, jnp.asarray(x), grouped=grouped)
    got = tfm._gelu_ffn_apply(tl, torch.as_tensor(x), grouped)
    _close(got, want)
    if grouped:
        k = tfm._gelu_ffn_apply(tl, torch.as_tensor(x), True,
                                use_kernel=True)
        np.testing.assert_allclose(k.numpy(), got.numpy(), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# forward, lm_loss and its gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(groups=0, s=20, over=dict(attn_q_chunk=8, attn_kv_chunk=24,
                                   loss_chunk=8)),
    dict(groups=4, s=20, over=dict(attn_q_chunk=16, attn_kv_chunk=16,
                                   loss_chunk=12)),
    # decoder positions past the table: clamped to its last row
    dict(groups=0, s=14, over=dict(dec_pos_size=10)),
], ids=["plain", "fed2", "pos_clamp"])
def test_forward_and_lm_loss_match_reference(case):
    """``forward(embeds=frames)`` and ``lm_loss`` on a batch carrying
    ``"embeds"`` (the tied unembedding in the loss chunks); the eval
    and prefill steps' kernel route (the wrappers' plain versions on the
    CPU) gives the same loss."""
    jc, tc = _configs(case["groups"], **case["over"])
    jp, tp = _params(case["groups"], **case["over"])
    batch = _batch(tc, 3, case["s"], seed=case["s"] + case["groups"])
    jh, _ = jfwd.forward(jp, jc, jnp.asarray(batch["tokens"]),
                         embeds=jnp.asarray(batch["embeds"]))
    th, taux = fwd.forward(tp, tc, torch.as_tensor(batch["tokens"]),
                           embeds=torch.as_tensor(batch["embeds"]))
    assert th.shape == (3, case["s"], tc.d_model) and float(taux) == 0.0
    _close(th, jh)
    jl = jfwd.lm_loss(jp, jc, _jb(batch))
    tl = fwd.lm_loss(tp, tc, _tb(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for make in (steps.make_eval_step, steps.make_prefill_loss_step):
        np.testing.assert_allclose(float(make(tc)(tp, _tb(batch))),
                                   float(tl), rtol=1e-6)


@pytest.mark.parametrize("groups", [0, 4])
def test_lm_loss_grad_matches_jax(groups):
    """Plain autograd (block and kv-step remat on) against ``jax.grad``,
    every leaf: the trained ``enc_pos``, ``dec_pos``, the tied table
    (embedding and unembedding), the encoder and both cross-attention
    projections; without remat the same numbers."""
    over = dict(loss_chunk=8, attn_q_chunk=8, attn_kv_chunk=24)
    jc, tc = _configs(groups, **over)
    jp, tp = _params(groups, **over)
    batch = _batch(tc, 2, 16, seed=10 + groups)
    jg = jax.jit(jax.grad(lambda p: jfwd.lm_loss(p, jc, _jb(batch))))(jp)
    _, tg = steps.value_and_grad(tp, tc, _tb(batch))
    assert tree_paths(tg) == tree_paths(jg)
    for path, g, w in zip(tree_paths(tg), tree_leaves(tg),
                          jax.tree_util.tree_leaves(jg)):
        assert np.abs(np.asarray(w)).max() > 0, path
        _close(g, w, 1e-4)
    _, tg_plain = steps.value_and_grad(
        tp, dataclasses.replace(tc, remat_blocks=False), _tb(batch))
    for a, b in zip(tree_leaves(tg), tree_leaves(tg_plain)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# the serving path: encdec_prefill_cache, then decode
# ---------------------------------------------------------------------------


def test_init_cache_matches_reference():
    """Per decoder layer, ``self`` (min(max_len, dec_pos_size) slots,
    empty) and ``cross`` (zeroed (B, enc_frames, Hkv, D)), in both
    stacks."""
    jc, tc = _configs(4)
    for max_len in (16, 600):
        want = jfwd.init_cache(jc, 3, max_len)
        got = fwd.init_cache(tc, 3, max_len)
        assert tree_paths(got) == tree_paths(want)
        for w, g in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tuple(got["blocks"]["self"]["k"].shape) == (1, 3, 512, 4, 64)


@pytest.mark.parametrize("groups", [0, 4])
def test_prefill_cache_and_decode_match_reference(groups):
    """``encdec_prefill_cache`` (the encoder once, the cross K and V of
    every layer) against the reference's, then 8 decode steps: logits
    and every cache leaf after every token."""
    jc, tc = _configs(groups)
    jp, tp = _params(groups)
    bs, n = 3, 8
    frames = _frames(tc, bs, seed=30)
    jcache = jfwd.encdec_prefill_cache(jp, jc, jfwd.init_cache(jc, bs, 16),
                                       jnp.asarray(frames))
    tcache = fwd.init_cache(tc, bs, 16)
    assert fwd.encdec_prefill_cache(tp, tc, tcache,
                                    torch.as_tensor(frames)) is tcache
    for w, g in zip(jax.tree_util.tree_leaves(jcache), tree_leaves(tcache)):
        _close(g, w)
    step = jax.jit(lambda p, c, t, pos: jfwd.decode_step(p, jc, c, t, pos))
    toks = np.random.default_rng(31).integers(0, jc.vocab, size=(bs, n))
    for t in range(n):
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1],
                                                  jnp.int32), jnp.int32(t))
        tl, tcache = fwd.decode_step(tp, tc, tcache,
                                     torch.as_tensor(toks[:, t:t + 1]), t)
        assert tl.shape == (bs, 1, jc.vocab)
        _close(tl, jl)
        for path, w, g in zip(tree_paths(tcache),
                              jax.tree_util.tree_leaves(jcache),
                              tree_leaves(tcache)):
            if path[-1] == "slot_pos":
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                _close(g, w)


def test_chunked_forward_equals_prefilled_decode():
    """The serving path (the encoder once, then one KV-cache slot per
    token) and the training path (``forward(embeds=)`` over the whole
    sequence) on 14 tokens, with Fed2: the same tied logits at every
    position. The decode's kernel route (the wrapper's plain version on
    the CPU) equals its plain route."""
    _, tc = _configs(4, attn_q_chunk=8, attn_kv_chunk=16)
    _, tp = _params(4, attn_q_chunk=8, attn_kv_chunk=16)
    frames = torch.as_tensor(_frames(tc, 2, seed=40))
    toks = torch.as_tensor(np.random.default_rng(41).integers(
        0, tc.vocab, size=(2, 14)))
    with torch.no_grad():
        h, _ = fwd.forward(tp, tc, toks, embeds=frames)
        want = tfm.unembed_apply(None, h, tc, tp["embed"]["table"])
        got = {}
        for use_kernel in (True, False):
            cache = fwd.encdec_prefill_cache(
                tp, tc, fwd.init_cache(tc, 2, 14), frames)
            got[use_kernel] = torch.cat([fwd.decode_step(
                tp, tc, cache, toks[:, t:t + 1], t,
                use_kernel=use_kernel)[0] for t in range(14)], 1)
    _close(got[True], want)
    np.testing.assert_allclose(got[True].numpy(), got[False].numpy(),
                               rtol=1e-6, atol=1e-6)


def _jax_serve(jc, jp, *, batch, prompt_len, gen, seed):
    """The reference's serve loop (``repro.launch.serve.main``), greedy,
    without its host mesh: decode against the zeroed cross cache (its
    CLI never runs the encoder). The tokens and each decoded step's
    logits."""
    step = jax.jit(lambda p, c, t, pos: jfwd.decode_step(p, jc, c, t, pos))
    prompts = np.random.default_rng(seed).integers(
        0, jc.vocab, size=(batch, prompt_len))
    cache = jfwd.init_cache(jc, batch, 128)
    for t in range(prompt_len):
        logits, cache = step(jp, cache, jnp.asarray(prompts[:, t:t + 1],
                                                    jnp.int32), jnp.int32(t))
    toks, seen = [], []
    for t in range(prompt_len, prompt_len + gen):
        seen.append(np.asarray(logits[:, 0]))
        nxt = jnp.argmax(logits[:, 0], axis=-1)[:, None]
        toks.append(np.asarray(nxt[:, 0]))
        logits, cache = step(jp, cache, nxt.astype(jnp.int32), jnp.int32(t))
    return np.stack(toks, 1), np.stack(seen, 1)


@pytest.mark.parametrize("groups", [0, 4])
def test_run_serve_greedy_tokens_match_reference(groups):
    jc, tc = _configs(groups)
    jp, tp = _params(groups)
    kw = dict(batch=3, prompt_len=6, gen=5, seed=7)
    out = serve.run_serve(tc, max_len=128, temperature=0.0, device="cpu",
                          init_params=tp, **kw)
    want, logits = _jax_serve(jc, jp, **kw)
    assert out["tokens"].shape == want.shape == (3, 5)
    assert out["param_count"] == jax_param_count(jp)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    gaps = top2[..., 1] - top2[..., 0]
    compared = 0
    for row in range(want.shape[0]):
        for t in range(want.shape[1]):
            if gaps[row, t] <= GAP:
                break
            assert out["tokens"][row, t] == want[row, t], (row, t)
            compared += 1
    assert compared >= want.size // 2, gaps


def test_serve_cli_serves_whisper_on_the_cpu(capsys):
    out = serve.main(["--device", "cpu", "--arch", ARCH, "--prompt-len",
                      "3", "--gen", "2", "--fed2-groups", "4"])
    assert out["tokens"].shape == (4, 2)
    assert out["logits"].shape == (4, 1, 512)
    assert bool(torch.isfinite(out["logits"]).all())
    assert "arch=whisper-base-reduced prefill 3 tok" in \
        capsys.readouterr().out
    cfg = serve.config_of(serve.parse_args(["--arch", ARCH, "--full",
                                            "--fed2-groups", "8"]))
    assert (cfg.arch_id, cfg.fed2_groups, cfg.fed2_decouple,
            cfg.tie_embeddings) == (ARCH, 8, 1, True)


# ---------------------------------------------------------------------------
# the train step, and the entry points that refuse the family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_reference(microbatches):
    """3 AdamW steps (lr 3e-4, weight decay 0.1, fp32 state, grads cast
    to bf16) on the reduced Fed2 Whisper, the batch's frames split with
    it into microbatches."""
    lr, n_steps = 3e-4, 3
    over = dict(loss_chunk=8, attn_q_chunk=8, attn_kv_chunk=32)
    jc, tc = _configs(4, **over)
    jp, tp = _params(4, **over)
    jstep, jo = jsteps.make_train_step(jc, lr=lr, microbatches=microbatches)
    tstep, to = steps.make_train_step(tc, lr=lr, microbatches=microbatches)
    jstep = jax.jit(jstep)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(n_steps):
        batch = _batch(tc, 4, 12, seed=20 + i)
        jp, js, jl = jstep(jp, js, jnp.int32(i), _jb(batch))
        tp, ts, tl = tstep(tp, ts, i, _tb(batch))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        d = np.abs(_np(a) - np.asarray(b, np.float32))
        assert d.max() <= 2 * lr * n_steps, d.max()
        assert (d <= 1e-5).mean() >= 0.99, (d <= 1e-5).mean()


def test_token_only_entry_points_refuse_whisper():
    """The reference fails where a token batch (the LM CLI's, lm_task's)
    meets Whisper: its ``lm_loss`` and ``lm_task``'s eval read the
    missing frames. The port refuses up front, naming the family:
    ``--mode lm`` before drawing any weight, and ``lm_task``."""
    jc, tc = _configs()
    jp, _ = _params()
    toks = np.random.default_rng(50).integers(0, jc.vocab, size=(2, 9))
    jbatch = jax_lm_batch(toks)
    assert "embeds" not in jbatch
    with pytest.raises(AttributeError, match="astype"):
        jfwd.lm_loss(jp, jc, jbatch)
    with pytest.raises(AttributeError, match="astype"):
        jrt.lm_task(jc).eval_fn(jp, jbatch)
    with pytest.raises(ValueError, match="'encdec' family"):
        train.main(["--mode", "lm", "--arch", ARCH, "--reduced",
                    "--device", "cpu", "--steps", "1"])
    with pytest.raises(ValueError, match="'encdec' family"):
        rt.lm_task(tc)
    with pytest.raises(ValueError, match="frontend's embeds"):
        fwd.forward(_params()[1], tc, torch.as_tensor(toks))
