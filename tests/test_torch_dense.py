"""The port's dense LM family (``repro_torch.models.{layers,attention,
transformer,forward}`` at ``llama3.2-1b``, ``launch/{steps,train,serve}``)
against the JAX package, on the CPU, from the same numpy inputs and the
same weights (the reference's ``init_params``, converted by
``convert.lm_to_port``). The model is the reduced config (2 layers, d
256, 8 heads, 2 KV heads, fp32), plain and under ``with_fed2(groups=4,
decouple=1)`` as the reference's LM example takes it.

Tolerances (fp32 unless said), as max |got - want| <= tol * max |want|:
- ``apply_rope``: 1e-6 (one fp32 cos/sin and one product per element;
  the two libraries' cos/sin may differ in the last bit); bf16: equal
  after both round to bf16 from fp32 values within 1e-6, so within one
  bf16 ulp (2^-8 relative);
- ``chunked_attention``, ``gqa_apply``, one ``gqa_decode`` step, the
  FFNs, ``decode_step``'s logits and cache: 1e-5 (einsums and matmuls
  summed in other orders);
- ``forward``'s hidden state and ``lm_loss``: 1e-5;
- gradients, per leaf: 1e-4 of the leaf's largest gradient (backward
  sums in other orders, through the online softmax's rescales);
- the train step: losses rtol 1e-5 over 3 steps; params as
  tests/test_torch_lm_train.py holds them (AdamW's first steps move a
  coordinate by about lr * sign(g), so a round-off gradient may flip
  one: every coordinate within 2 * lr * steps, 99 % within 1e-5);
- greedy serve tokens equal wherever the reference's top-2 logit gap
  exceeds 1e-4 (ten times the logits' tolerance);
- the kernel routes on the CPU (their wrappers' plain versions) against
  the plain routes: 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.common import with_fed2 as jax_with_fed2
from repro.core import fusion as jfusion
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import forward as jfwd
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.models.module import param_count as jax_param_count
from repro_torch.configs import get_config
from repro_torch.configs.common import with_fed2
from repro_torch.convert import lm_to_port, lm_to_reference
from repro_torch.core import fusion
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention, layers
from repro_torch.models import forward as fwd
from repro_torch.models import transformer as tfm
from repro_torch.models.module import (FlatLayout, key_path, param_count,
                                       tree_leaves, tree_paths)

ARCH = "llama3.2-1b"
GAP = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(groups=0, reduced=True, dtype=None, **over):
    """(reference config, port config) of llama3.2-1b; ``groups`` applies
    with_fed2 (decouple 1 on the reduced config, the rule's depth on the
    full one); ``dtype`` ("float32" or "bfloat16") and field overrides
    on both."""
    jkw = {} if dtype is None else {"dtype": getattr(jnp, dtype)}
    tkw = {} if dtype is None else {"dtype": getattr(torch, dtype)}
    jc = jax_get_config(ARCH, reduced=reduced, **jkw)
    tc = get_config(ARCH, reduced=reduced, **tkw)
    if groups:
        dec = 1 if reduced else None
        jc = jax_with_fed2(jc, groups=groups, decouple=dec)
        tc = with_fed2(tc, groups=groups, decouple=dec)
    return dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)


_INIT = {}


def _params(groups):
    """The reference's reduced init (``init_params`` at PRNGKey(0),
    jitted) as numpy, and the port's conversion of it; cached."""
    if groups not in _INIT:
        jc, _ = _configs(groups)
        jp = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k: jtfm.init_params(k, jc))(jax.random.PRNGKey(0)))
        _INIT[groups] = (jp, lm_to_port(jp))
    return _INIT[groups]


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, tol=1e-5):
    """max |got - want| <= tol * max |want|."""
    got = _np(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    got, want = got.astype(np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (err, scale)


def _batch(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(b, s + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "mask": (rng.random((b, s)) > 0.2).astype(np.float32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("groups", [0, 4, 8])
def test_configs_match_reference(reduced, groups):
    jc, tc = _configs(groups, reduced=reduced)
    for f in ("arch_id", "family", "n_layers", "d_model", "vocab", "d_ff",
              "n_heads", "n_kv_heads", "head_dim", "norm", "act",
              "rope_theta", "rotary_pct", "qkv_bias", "qk_norm", "window",
              "use_rope", "fed2_groups", "fed2_decouple", "n_dense_blocks",
              "padded_vocab", "loss_chunk", "attn_q_chunk", "attn_kv_chunk",
              "remat_blocks", "tie_embeddings"):
        assert getattr(tc, f) == getattr(jc, f), f
    for f in ("d_model", "n_heads", "n_kv_heads", "head_dim", "rope_theta",
              "rotary_pct", "rotary_dim", "window", "causal"):
        assert getattr(tc.attn_cfg, f) == getattr(jc.attn_cfg, f), f
    assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name


def test_full_config_sizes():
    """The reference's parameter counts of the full config (its
    ``jax.eval_shape``), which the port's init must give on the card."""
    for groups, want in ((0, 1_498_482_688), (8, 1_092_487_168),
                         (4, 1_150_486_528)):
        jc, tc = _configs(groups, reduced=False)
        shapes = jax.eval_shape(lambda k: jtfm.init_params(k, jc),
                                jax.random.PRNGKey(0))
        assert jax_param_count(shapes) == want
        assert tc.fed2_decouple == (4 if groups else 0)
    _, tc = _configs(8, reduced=False)
    assert tc.dtype == torch.bfloat16 and tc.padded_vocab == 128256


@pytest.mark.parametrize("groups", [0, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_reference(groups, dtype):
    """Same leaves (``blocks`` and ``gblocks`` split as the reference
    splits them), shapes, dtypes and parameter count; the fan-in
    scale."""
    jc, tc = _configs(groups, dtype=dtype)
    want = jax.eval_shape(lambda k: jtfm.init_params(k, jc),
                          jax.random.PRNGKey(0))
    got = tfm.init_params(torch.Generator().manual_seed(0), tc)
    assert tree_paths(got) == tree_paths(
        jax.tree_util.tree_map(lambda s: 0, want))
    for w, g in zip(jax.tree_util.tree_leaves(want),
                    tree_leaves(lm_to_reference(got))):
        assert w.shape == g.shape and jnp.dtype(w.dtype) == g.dtype
    assert param_count(got) == jax_param_count(want)
    assert ("gblocks" in got) == bool(groups)
    w = got["blocks"]["attn"]["wq"]["w"].float()
    assert abs(w.std().item() * np.sqrt(tc.d_model) - 1) < 0.05


def test_lm_group_axes_on_the_ports_dense_tree():
    """``lm_group_axes`` on the port's own init of the Fed2 llama: the
    decoupled blocks' grouped FFN leaves (axis 1) and the unembedding
    (axis 0), as the reference marks its tree."""
    jc, tc = _configs(4)
    got = fusion.lm_group_axes(
        tfm.init_params(torch.Generator().manual_seed(0), tc), tc)
    jp, _ = _params(4)
    want = jfusion.lm_group_axes(jp, jc)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: x is None or isinstance(x, jfusion.GroupAxis))
    want = {"/".join(str(k) for k in p):
            None if a is None else (a.axis, a.n_groups) for p, a in flat}
    have = {}
    for p in tree_paths(got):
        a = got
        for k in p:
            a = a[k]
        have[key_path(p)] = None if a is None else (a.axis, a.n_groups)
    assert have == want
    marked = sorted(k for k, v in have.items() if v is not None)
    assert marked == ["['gblocks']/['ffn']/['w_down']/['w']",
                      "['gblocks']/['ffn']/['w_gate']/['w']",
                      "['gblocks']/['ffn']/['w_up']/['w']",
                      "['unembed']/['w']"]


# ---------------------------------------------------------------------------
# the other dense configs and the hybrid build and run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-7b", "h2o-danube-1.8b",
                                  "stablelm-12b", "zamba2-2.7b"])
def test_the_other_dense_configs_and_the_hybrid_build_and_run(arch):
    """The attention features the llama lacks (QKV biases, a sliding
    window, QK-norm, partial rotary) and the hybrid family build, run
    a forward and decode through their caches (their parity with the
    reference: tests/test_torch_dense_configs.py and
    tests/test_torch_hybrid.py); an encdec config without an encoder
    (enc_layers 0) is refused, naming the family."""
    tc = with_fed2(get_config(arch, reduced=True), groups=4)
    params = tfm.init_params(torch.Generator().manual_seed(0), tc)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, tc.vocab, size=(2, 6)))
    with torch.no_grad():
        h, aux = fwd.forward(params, tc, toks)
        cache = fwd.init_cache(tc, 2, 8)
        for t in range(6):
            logits, _ = fwd.decode_step(params, tc, cache, toks[:, t:t + 1],
                                        t)
    assert h.shape == (2, 6, tc.d_model) and bool(torch.isfinite(h).all())
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    assert logits.shape == (2, 1, tc.vocab)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="encdec"):
        tfm.init_params(torch.Generator().manual_seed(0),
                        dataclasses.replace(tc, family="encdec"))


# ---------------------------------------------------------------------------
# rope and attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rotary_dim", [32, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_reference(rotary_dim, dtype):
    """Full and half rotary_dim (the pass-through half untouched), at
    positions up to 2,000 and the llama theta."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 2000, size=(2, 7))
    jinv = jlayers.rope_freqs(32, 500000.0, rotary_dim)
    tinv = layers.rope_freqs(32, 500000.0, rotary_dim)
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    want = jlayers.apply_rope(jnp.asarray(x, getattr(jnp, dtype)),
                              jnp.asarray(pos), jinv, rotary_dim=rotary_dim)
    got = layers.apply_rope(torch.as_tensor(x).to(getattr(torch, dtype)),
                            torch.as_tensor(pos), tinv,
                            rotary_dim=rotary_dim)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, 1e-6 if dtype == "float32" else 2.0 ** -8)
    if rotary_dim < 32:
        np.testing.assert_array_equal(_np(got)[..., rotary_dim:],
                                      _np(torch.as_tensor(x).to(
                                          getattr(torch, dtype)))[
                                          ..., rotary_dim:])


def _qkv(b, sq, skv, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, hq, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("case", [
    # S off the chunks (40 over q 16, kv 24: a padded last chunk of each)
    dict(sq=40, skv=40, qc=16, kvc=24, causal=True),
    # several q and kv chunks, non-causal, S a multiple of both
    dict(sq=48, skv=48, qc=8, kvc=16, causal=False),
    # keys past kv_valid_len masked (a cache of 40 slots, 29 filled)
    dict(sq=40, skv=40, qc=16, kvc=16, causal=False, kv_valid_len=29),
    # rows with every key masked: keys at positions 6.. under a causal
    # mask, so queries 0-5 see none (they stay finite)
    dict(sq=24, skv=24, qc=8, kvc=8, causal=True, kv_shift=6),
    # the window mask line
    dict(sq=40, skv=40, qc=16, kvc=8, causal=True, window=8),
], ids=["ragged", "chunks", "kv_valid_len", "masked_rows", "window"])
def test_chunked_attention_matches_reference(case):
    q, k, v = _qkv(2, case["sq"], case["skv"], 8, 2, 16, seed=1)
    qpos = np.arange(case["sq"])
    kpos = np.arange(case["skv"]) + case.get("kv_shift", 0)
    kw = dict(causal=case["causal"], window=case.get("window"),
              q_chunk=case["qc"], kv_chunk=case["kvc"],
              kv_valid_len=case.get("kv_valid_len"))
    want = jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos), **kw)
    got = attention.chunked_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        q_positions=torch.as_tensor(qpos), kv_positions=torch.as_tensor(kpos),
        **kw)
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    _close(got, want)


def test_chunked_attention_gradient_matches_jax():
    """Through the online softmax's rescales, with each kv step
    rematerialized (plain autograd), against ``jax.grad``."""
    q, k, v = _qkv(1, 40, 40, 4, 2, 8, seed=2)
    pos = np.arange(40)
    w = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)
    kw = dict(causal=True, q_chunk=16, kv_chunk=16)

    def jloss(q, k, v):
        return (jattn.chunked_attention(q, k, v, q_positions=pos,
                                        kv_positions=pos, **kw) * w).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.as_tensor(a).requires_grad_(True) for a in (q, k, v)]
    tpos = torch.as_tensor(pos)
    loss = (attention.chunked_attention(*ts, q_positions=tpos,
                                        kv_positions=tpos, **kw)
            * torch.as_tensor(w)).sum()
    for g, wg in zip(torch.autograd.grad(loss, ts), want):
        _close(g, wg, 1e-4)


def _attn_params(seed=0):
    _, tc = _configs()
    jp, _ = _params(0)
    lp = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["attn"])
    return tc.attn_cfg, lp, lm_to_port(lp)


def test_gqa_apply_matches_reference():
    acfg, jp, tp = _attn_params()
    x = np.random.default_rng(4).normal(size=(2, 40, 256)).astype(np.float32)
    want = jattn.gqa_apply(jp, jnp.asarray(x), acfg, q_chunk=16,
                           kv_chunk=24)
    got = attention.gqa_apply(tp, torch.as_tensor(x), acfg, q_chunk=16,
                              kv_chunk=24)
    _close(got, want)


def test_gqa_decode_matches_reference_and_the_chunked_path():
    """8 decode steps into a 12-slot cache: each step's output and the
    whole cache (k, v, slot_pos) after it equal the reference's; the 8
    outputs equal gqa_apply over the 8 tokens."""
    acfg, jp, tp = _attn_params()
    x = np.random.default_rng(5).normal(size=(3, 8, 256)).astype(np.float32)
    jc = jattn.gqa_cache_init(acfg, 3, 12, jnp.float32)
    tcache = attention.gqa_cache_init(acfg, 3, 12, torch.float32)
    assert (tcache["slot_pos"] == -1).all()
    outs = []
    for t in range(8):
        jy, jc = jattn.gqa_decode(jp, jnp.asarray(x[:, t:t + 1]), jc, acfg,
                                  pos=jnp.int32(t))
        ty, same = attention.gqa_decode(tp, torch.as_tensor(x[:, t:t + 1]),
                                        tcache, acfg, pos=t)
        assert same is tcache                       # updated in place
        _close(ty, jy)
        for key in ("k", "v"):
            _close(tcache[key], jc[key])
        np.testing.assert_array_equal(tcache["slot_pos"].numpy(),
                                      np.asarray(jc["slot_pos"]))
        outs.append(ty)
    full = attention.gqa_apply(tp, torch.as_tensor(x), acfg)
    _close(torch.cat(outs, 1), _np(full))
    with pytest.raises(ValueError, match="outside the cache"):
        attention.gqa_decode(tp, torch.as_tensor(x[:, :1]), tcache, acfg,
                             pos=12)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_ffn_and_gffn_match_reference(act):
    """The dense SwiGLU (or GELU-gated) FFN of a shared block and the
    block-diagonal one of a decoupled block; the grouped FFN's kernel
    route (the wrapper's plain version on the CPU) equals its einsum."""
    jc, tc = _configs(4, act=act)
    jp, tp = _params(4)
    x = np.random.default_rng(6).normal(size=(2, 5, 256)).astype(np.float32)
    for key, jfn, tfn in (("blocks", jtfm.ffn_apply, tfm.ffn_apply),
                          ("gblocks", jtfm.gffn_apply, tfm.gffn_apply)):
        jl = jax.tree_util.tree_map(lambda a: a[0], jp[key]["ffn"])
        tl = lm_to_port(jl)
        want = jfn(jl, jnp.asarray(x), jc)
        _close(tfn(tl, torch.as_tensor(x), tc), want)
    tl = lm_to_port(jax.tree_util.tree_map(lambda a: a[0],
                                           jp["gblocks"]["ffn"]))
    a = tfm.gffn_apply(tl, torch.as_tensor(x), tc, use_kernel=True)
    b = tfm.gffn_apply(tl, torch.as_tensor(x), tc)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# forward, lm_loss and its gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [0, 4])
def test_forward_and_lm_loss_match_reference(groups):
    """S = 40 over attention chunks of 16 x 24 and loss chunks of 24,
    with a mask, with and without Fed2 (the decoupled block and the
    grouped unembedding); the eval and prefill steps' kernel route (the
    wrappers' plain versions on the CPU) gives the same loss."""
    over = dict(loss_chunk=24, attn_q_chunk=16, attn_kv_chunk=24)
    jc, tc = _configs(groups, **over)
    jp, tp = _params(groups)
    batch = _batch(tc.vocab, 3, 40, seed=groups)
    jh, _ = jfwd.forward(jp, jc, jnp.asarray(batch["tokens"]))
    th, taux = fwd.forward(tp, tc, torch.as_tensor(batch["tokens"]))
    assert th.shape == (3, 40, tc.d_model) and float(taux) == 0.0
    _close(th, jh)
    jl = jfwd.lm_loss(jp, jc, _jb(batch))
    tl = fwd.lm_loss(tp, tc, _tb(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for make in (steps.make_eval_step, steps.make_prefill_loss_step):
        np.testing.assert_allclose(float(make(tc)(tp, _tb(batch))),
                                   float(tl), rtol=1e-6)


@pytest.mark.parametrize("groups", [0, 4])
def test_lm_loss_grad_matches_jax(groups):
    """Plain autograd (block and kv-step remat on) against ``jax.grad``;
    without remat, and through the round engine's ``vmap(grad)`` over
    flat rows, the same numbers."""
    over = dict(loss_chunk=24, attn_q_chunk=16, attn_kv_chunk=16)
    jc, tc = _configs(groups, **over)
    jp, tp = _params(groups)
    batch = _batch(tc.vocab, 2, 40, seed=10 + groups)
    jg = jax.jit(jax.grad(lambda p: jfwd.lm_loss(p, jc, _jb(batch))))(jp)
    _, tg = steps.value_and_grad(tp, tc, _tb(batch))
    for g, w in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        _close(g, w, 1e-4)
    _, tg_plain = steps.value_and_grad(
        tp, dataclasses.replace(tc, remat_blocks=False), _tb(batch))
    for a, b in zip(tree_leaves(tg), tree_leaves(tg_plain)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    layout = FlatLayout(tp)
    rows = torch.stack([layout.flatten(tp)] * 2)
    gfn = torch.func.vmap(torch.func.grad(
        lambda row, b: fwd.lm_loss(layout.unflatten(row), tc, b)))
    gv = gfn(rows, {k: torch.stack([v, v]) for k, v in _tb(batch).items()})
    np.testing.assert_allclose(gv[1].numpy(), layout.flatten(tg).numpy(),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# decode and serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [0, 4])
def test_decode_step_matches_reference(groups):
    """8 tokens through the reduced llama, with and without Fed2: logits
    and every cache leaf of both stacks after every token."""
    jc, tc = _configs(groups)
    jp, tp = _params(groups)
    bs, n = 3, 8
    jcache = jfwd.init_cache(jc, bs, 16)
    tcache = fwd.init_cache(tc, bs, 16)
    assert sorted(tcache) == sorted(jcache)
    step = jax.jit(lambda p, c, t, pos: jfwd.decode_step(p, jc, c, t, pos))
    toks = np.random.default_rng(4).integers(0, jc.vocab, size=(bs, n))
    for t in range(n):
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1],
                                                  jnp.int32), jnp.int32(t))
        tl, tcache = fwd.decode_step(tp, tc, tcache,
                                     torch.as_tensor(toks[:, t:t + 1]), t)
        assert tl.shape == (bs, 1, jc.vocab)
        _close(tl, jl)
        for stack in tcache:
            for key in ("k", "v"):
                _close(tcache[stack][key], jcache[stack][key])
            np.testing.assert_array_equal(
                tcache[stack]["slot_pos"].numpy(),
                np.asarray(jcache[stack]["slot_pos"]))


@pytest.mark.parametrize("groups", [0, 4])
def test_decode_step_kernel_routes_equal_plain_routes_on_cpu(groups):
    """On CPU tensors the grouped_matmul wrapper (the decoupled FFN's and
    the unembedding's route) takes its plain version, which computes
    what the model's einsums compute."""
    _, tc = _configs(groups)
    _, tp = _params(groups)
    caches = [fwd.init_cache(tc, 2, 8) for _ in range(2)]
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, tc.vocab, size=(2, 4)))
    for t in range(4):
        a, _ = fwd.decode_step(tp, tc, caches[0], toks[:, t:t + 1], t)
        b, _ = fwd.decode_step(tp, tc, caches[1], toks[:, t:t + 1], t,
                               use_kernel=False)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_chunked_forward_equals_token_by_token_decode():
    """The prefill path (chunked attention over 3 q and 3 kv chunks) and
    the decode path (one KV-cache slot per token) on 20 tokens: the same
    logits at every position."""
    _, tc = _configs(4, attn_q_chunk=8, attn_kv_chunk=8)
    _, tp = _params(4)
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, tc.vocab, size=(2, 20)))
    with torch.no_grad():
        want = tfm.unembed_apply(tp["unembed"], fwd.forward(tp, tc, toks)[0],
                                 tc)
        cache = fwd.init_cache(tc, 2, 20)
        got = torch.cat([fwd.decode_step(tp, tc, cache, toks[:, t:t + 1],
                                         t)[0] for t in range(20)], 1)
    _close(got, want)


def _jax_serve(jc, jp, *, batch, prompt_len, gen, seed):
    """The reference's serve loop (``repro.launch.serve.main``), greedy,
    without its host mesh: the tokens and each decoded step's logits."""
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


# ---------------------------------------------------------------------------
# the train step and the CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_reference(microbatches):
    """3 AdamW steps (lr 3e-4, weight decay 0.1, fp32 state, grads cast
    to bf16) on the reduced Fed2 llama; S = 24 over loss chunks of 16
    and attention chunks of 16."""
    lr, n_steps = 3e-4, 3
    over = dict(loss_chunk=16, attn_q_chunk=16, attn_kv_chunk=16)
    jc, tc = _configs(4, **over)
    jp, tp = _params(4)
    jstep, jo = jsteps.make_train_step(jc, lr=lr, microbatches=microbatches)
    tstep, to = steps.make_train_step(tc, lr=lr, microbatches=microbatches)
    jstep = jax.jit(jstep)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(n_steps):
        batch = _batch(tc.vocab, 4, 24, seed=20 + i)
        jp, js, jl = jstep(jp, js, jnp.int32(i), _jb(batch))
        tp, ts, tl = tstep(tp, ts, i, _tb(batch))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        d = np.abs(_np(a) - np.asarray(b, np.float32))
        assert d.max() <= 2 * lr * n_steps, d.max()
        assert (d <= 1e-5).mean() >= 0.99, (d <= 1e-5).mean()


def test_lm_cli_trains_the_dense_family_on_the_cpu(capsys):
    out = train.main(["--mode", "lm", "--arch", ARCH, "--reduced",
                      "--device", "cpu", "--fed2", "--fed2-groups", "4",
                      "--steps", "3", "--batch", "4", "--seq", "16",
                      "--lr", "1e-3"])
    assert len(out["loss"]) == 3 and np.isfinite(out["loss"]).all()
    assert "gblocks" in out["final_params"]
    assert "step     2 loss" in capsys.readouterr().out


def test_serve_cli_serves_the_dense_family_on_the_cpu(capsys):
    """The serving CLI's default arch is the reference's, llama3.2-1b."""
    out = serve.main(["--device", "cpu", "--prompt-len", "3", "--gen", "2",
                      "--fed2-groups", "4"])
    assert out["tokens"].shape == (4, 2)
    assert out["logits"].shape == (4, 1, 512)
    assert bool(torch.isfinite(out["logits"]).all())
    assert "arch=llama3.2-1b-reduced prefill 3 tok" in \
        capsys.readouterr().out
    cfg = serve.config_of(serve.parse_args(["--full", "--fed2-groups", "8"]))
    assert (cfg.arch_id, cfg.fed2_groups, cfg.fed2_decouple) == \
        ("llama3.2-1b", 8, 4)
