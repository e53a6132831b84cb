"""The port's other dense configs (``qwen2-7b``: QKV biases;
``h2o-danube-1.8b``: a sliding window and its ring-buffer cache;
``stablelm-12b``: QK-norm and partial rotary) against the JAX package,
on the CPU, from the same numpy inputs and the same weights (the
reference's ``init_params``, converted by ``convert.lm_to_port``). The
models are the reduced configs (2 layers, d 256, fp32), plain and under
``with_fed2(groups=4, decouple=1)``.

``dense_init`` zeroes the QKV biases and RMSNorm scales start at 1, so a
fresh init cannot tell whether they are applied: every parity test
below first sets each bias and each norm scale (QK-norm, ln1, ln2, the
final norm) to seeded values (biases N(0, 0.5), scales 1 + 0.3 N(0, 1)),
the same in both packages.

Tolerances (fp32), as max |got - want| <= tol * max |want|:
- ``gqa_apply``, ``gqa_decode`` (outputs and every cache leaf),
  ``apply_rope``, ``forward``, ``lm_loss`` and ``decode_step`` (logits
  and caches): 1e-5, as in tests/test_torch_dense.py (einsums and
  matmuls summed in other orders);
- gradients, per leaf: 1e-4 of the leaf's largest gradient (backward
  sums in other orders, through the online softmax's rescales);
- the chunked forward against token-by-token decode: 1e-5;
- greedy serve tokens equal wherever the reference's top-2 logit gap
  exceeds 1e-4 (ten times the logits' tolerance);
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
from repro.core import fusion as jfusion
from repro.models import attention as jattn
from repro.models import forward as jfwd
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.models.module import param_count as jax_param_count
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import get_config
from repro_torch.configs.common import with_fed2
from repro_torch.convert import lm_to_port, lm_to_reference
from repro_torch.core import fusion
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention, layers
from repro_torch.models import forward as fwd
from repro_torch.models import transformer as tfm
from repro_torch.models.module import (key_path, param_count, tree_leaves,
                                       tree_paths, tree_unflatten)

ARCHS = ("qwen2-7b", "h2o-danube-1.8b", "stablelm-12b")
GAP = 1e-4
# the reference's param_count(jax.eval_shape(init_params)) of each full
# config, plain and under with_fed2(groups=8) (6 decoupled blocks)
FULL_PARAMS = {("qwen2-7b", 0): 7_615_616_512,
               ("qwen2-7b", 8): 6_069_392_896,
               ("h2o-danube-1.8b", 0): 1_831_201_280,
               ("h2o-danube-1.8b", 8): 1_480_829_440,
               ("stablelm-12b", 0): 12_142_937_600,
               ("stablelm-12b", 8): 10_578_593_280}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, groups=0, reduced=True, **over):
    """(reference config, port config) of ``arch``; ``groups`` applies
    with_fed2 (decouple 1 on the reduced config, the rule's depth on the
    full one); field overrides on both."""
    jc = jax_get_config(arch, reduced=reduced)
    tc = get_config(arch, reduced=reduced)
    if groups:
        dec = 1 if reduced else None
        jc = jax_with_fed2(jc, groups=groups, decouple=dec)
        tc = with_fed2(tc, groups=groups, decouple=dec)
    return dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)


def _perturbed(tree, rng, path=()):
    """``tree`` (numpy) with every bias ``b`` drawn N(0, 0.5) and every
    norm ``scale`` drawn 1 + 0.3 N(0, 1), from ``rng``, in flattening
    order."""
    if isinstance(tree, dict):
        return {k: _perturbed(tree[k], rng, path + (k,))
                for k in sorted(tree)}
    if path[-1] == "b":
        return rng.normal(0.0, 0.5, tree.shape).astype(tree.dtype)
    if path[-1] == "scale":
        return (1.0 + 0.3 * rng.normal(size=tree.shape)).astype(tree.dtype)
    return tree


_INIT = {}


def _params(arch, groups=0):
    """The reference's reduced init (``init_params`` at PRNGKey(0),
    jitted) as numpy with its biases and norm scales perturbed, and the
    port's conversion of it; cached."""
    if (arch, groups) not in _INIT:
        jc, _ = _configs(arch, groups)
        jp = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k: jtfm.init_params(k, jc))(jax.random.PRNGKey(0)))
        jp = _perturbed(jp, np.random.default_rng(1))
        _INIT[arch, groups] = (jp, lm_to_port(jp))
    return _INIT[arch, groups]


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


def _layer(tree, i=0):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------


def test_the_archs_are_registered():
    for arch in ARCHS:
        assert arch in PORT_ARCHS and arch in train.LM_ARCHS


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("groups", [0, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch, groups, reduced):
    jc, tc = _configs(arch, groups, reduced=reduced)
    for f in ("arch_id", "family", "n_layers", "d_model", "vocab", "d_ff",
              "n_heads", "n_kv_heads", "head_dim", "norm", "act",
              "rope_theta", "rotary_pct", "qkv_bias", "qk_norm", "window",
              "use_rope", "fed2_groups", "fed2_decouple", "n_dense_blocks",
              "padded_vocab", "loss_chunk", "attn_q_chunk", "attn_kv_chunk",
              "remat_blocks", "tie_embeddings", "hybrid_attn_every"):
        assert getattr(tc, f) == getattr(jc, f), f
    for f in ("d_model", "n_heads", "n_kv_heads", "head_dim", "rope_theta",
              "rotary_pct", "rotary_dim", "qkv_bias", "qk_norm", "window",
              "causal"):
        assert getattr(tc.attn_cfg, f) == getattr(jc.attn_cfg, f), f
    assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name


def _meta_init(tc):
    """The port's init of ``tc`` on ``meta``: shapes and dtypes of a
    full-width tree without its memory."""
    return tfm.init_params(torch.Generator(), tc, device="meta")


@pytest.mark.parametrize("groups", [0, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_sizes(arch, groups):
    """The reference's parameter count of the full config (its
    ``jax.eval_shape``) equals the pinned constant the card's serve
    phase checks, and the port's init of the full config (on
    ``meta``) has it leaf for leaf; under Fed2 8 the 6 decoupled blocks
    and the block-diagonal unembedding (G, d/G, V/G)."""
    jc, tc = _configs(arch, groups, reduced=False)
    want = jax.eval_shape(lambda k: jtfm.init_params(k, jc),
                          jax.random.PRNGKey(0))
    assert jax_param_count(want) == FULL_PARAMS[arch, groups]
    got = _meta_init(tc)
    assert param_count(got) == FULL_PARAMS[arch, groups]
    for w, g in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        assert tuple(w.shape) == tuple(g.shape)
        assert g.dtype == torch.bfloat16
    assert tc.fed2_decouple == (6 if groups else 0)
    if groups:
        g8, d, v = 8, tc.d_model, tc.padded_vocab
        assert tuple(got["unembed"]["w"].shape) == (g8, d // g8, v // g8)
        ff = got["gblocks"]["ffn"]
        assert tuple(ff["w_gate"]["w"].shape) == (6, g8, d // g8,
                                                  tc.d_ff // g8)
        assert tuple(ff["w_down"]["w"].shape) == (6, g8, tc.d_ff // g8,
                                                  d // g8)


@pytest.mark.parametrize("groups", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch, groups):
    """Same leaves (the QKV biases ``b`` of qwen2, the ``q_norm`` and
    ``k_norm`` scales of stablelm), shapes, dtypes and parameter count;
    the biases start at 0 and the norm scales at 1, as the
    reference's."""
    jc, tc = _configs(arch, groups)
    want = jax.eval_shape(lambda k: jtfm.init_params(k, jc),
                          jax.random.PRNGKey(0))
    got = tfm.init_params(torch.Generator().manual_seed(0), tc)
    assert tree_paths(got) == tree_paths(
        jax.tree_util.tree_map(lambda s: 0, want))
    for w, g in zip(jax.tree_util.tree_leaves(want),
                    tree_leaves(lm_to_reference(got))):
        assert w.shape == g.shape and jnp.dtype(w.dtype) == g.dtype
    assert param_count(got) == jax_param_count(want)
    a = got["blocks"]["attn"]
    assert ("b" in a["wq"]) == tc.qkv_bias == ("b" in a["wv"])
    assert "b" not in a["wo"]
    assert ("q_norm" in a) == tc.qk_norm == ("k_norm" in a)
    if tc.qkv_bias:
        assert not a["wk"]["b"].any()
    if tc.qk_norm:
        assert tuple(a["q_norm"]["scale"].shape) == (tc.n_layers
                                                     - tc.fed2_decouple,
                                                     tc.head_dim)
        assert bool((a["k_norm"]["scale"] == 1).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_to_port_round_trip_carries_the_new_leaves(arch):
    """``lm_to_port`` and ``lm_to_reference`` carry the biases and the
    QK-norm scales across, to the bit, in the reference's layout."""
    jp, tp = _params(arch, 4)
    back = lm_to_reference(tp)
    assert tree_paths(back) == tree_paths(jp)
    for a, b in zip(tree_leaves(back), tree_leaves(jp)):
        np.testing.assert_array_equal(a, b)
    attn = tp["blocks"]["attn"]
    if arch == "qwen2-7b":
        assert all("b" in attn[k] for k in ("wq", "wk", "wv"))
        np.testing.assert_array_equal(attn["wq"]["b"].numpy(),
                                      jp["blocks"]["attn"]["wq"]["b"])
    if arch == "stablelm-12b":
        assert "q_norm" in attn and "k_norm" in tp["gblocks"]["attn"]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_group_axes_match_reference(arch):
    """``lm_group_axes`` on the port's own Fed2 tree against the
    reference's on its tree: the decoupled blocks' grouped FFN leaves
    (axis 1) and the unembedding (axis 0); biases and QK-norm scales
    shared."""
    jc, tc = _configs(arch, 4)
    got = fusion.lm_group_axes(
        tfm.init_params(torch.Generator().manual_seed(0), tc), tc)
    jp, _ = _params(arch, 4)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jfusion.lm_group_axes(jp, jc),
        is_leaf=lambda x: x is None or isinstance(x, jfusion.GroupAxis))
    want = {"/".join(str(k) for k in p):
            None if a is None else (a.axis, a.n_groups) for p, a in flat}
    have = {}
    for p in tree_paths(got):
        a = got
        for k in p:
            a = a[k]
        have[key_path(p)] = None if a is None else (a.axis, a.n_groups)
    assert have == want
    assert sorted(k for k, v in have.items() if v is not None) == [
        "['gblocks']/['ffn']/['w_down']/['w']",
        "['gblocks']/['ffn']/['w_gate']/['w']",
        "['gblocks']/['ffn']/['w_up']/['w']", "['unembed']/['w']"]


# ---------------------------------------------------------------------------
# attention: biases, QK-norm, partial rotary, the window
# ---------------------------------------------------------------------------


def _attn(arch, **over):
    """The attention config and the first block's perturbed attention
    params of ``arch``, (reference, port)."""
    _, tc = _configs(arch, **over)
    jp, _ = _params(arch)
    lp = _layer(jp["blocks"]["attn"])
    return tc.attn_cfg, lp, lm_to_port(lp)


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_apply_matches_reference(arch):
    """80 positions over q chunks of 16 and kv chunks of 24 (danube's
    reduced window, 64, masks the oldest keys of the last queries)."""
    acfg, jp, tp = _attn(arch)
    x = np.random.default_rng(4).normal(size=(2, 80, 256)).astype(np.float32)
    want = jax.jit(lambda p, x: jattn.gqa_apply(
        p, x, acfg, q_chunk=16, kv_chunk=24))(jp, jnp.asarray(x))
    got = attention.gqa_apply(tp, torch.as_tensor(x), acfg, q_chunk=16,
                              kv_chunk=24)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_decode_matches_reference(arch):
    """10 decode steps: each step's output and the whole cache (k, v,
    slot_pos) after it equal the reference's, updated in place; the 10
    outputs equal gqa_apply over the 10 tokens. Danube's window is cut
    to 4 here, so its ring buffer of 4 slots wraps twice."""
    over = {"window": 4} if arch == "h2o-danube-1.8b" else {}
    acfg, jp, tp = _attn(arch, **over)
    n = 10
    x = np.random.default_rng(5).normal(size=(3, n, 256)).astype(np.float32)
    jc = jattn.gqa_cache_init(acfg, 3, 12, jnp.float32)
    tcache = attention.gqa_cache_init(acfg, 3, 12, torch.float32)
    assert tcache["k"].shape == jc["k"].shape
    assert tcache["k"].shape[1] == (4 if over else 12)
    outs = []
    for t in range(n):
        jy, jc = jattn.gqa_decode(jp, jnp.asarray(x[:, t:t + 1]), jc, acfg,
                                  pos=jnp.int32(t))
        ty, same = attention.gqa_decode(tp, torch.as_tensor(x[:, t:t + 1]),
                                        tcache, acfg, pos=t)
        assert same is tcache
        _close(ty, jy)
        for key in ("k", "v"):
            _close(tcache[key], jc[key])
        np.testing.assert_array_equal(tcache["slot_pos"].numpy(),
                                      np.asarray(jc["slot_pos"]))
        outs.append(ty)
    full = attention.gqa_apply(tp, torch.as_tensor(x), acfg)
    _close(torch.cat(outs, 1), _np(full))
    if over:
        assert sorted(tcache["slot_pos"].tolist()) == [6, 7, 8, 9]
    else:
        with pytest.raises(ValueError, match="outside the cache"):
            attention.gqa_decode(tp, torch.as_tensor(x[:, :1]), tcache,
                                 acfg, pos=12)


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_gradient_matches_jax(arch):
    """The gradient of a weighted sum of gqa_apply's output with respect
    to every attention leaf (biases and QK-norm scales included) and the
    input, against ``jax.grad``."""
    acfg, jp, tp = _attn(arch)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 40, 256)).astype(np.float32)
    w = rng.normal(size=(2, 40, 256)).astype(np.float32)

    def jloss(p, x):
        return (jattn.gqa_apply(p, x, acfg, q_chunk=16, kv_chunk=16)
                * w).sum()

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    tx = torch.as_tensor(x).requires_grad_(True)
    loss = (attention.gqa_apply(tree_unflatten(tp, leaves), tx, acfg,
                                q_chunk=16, kv_chunk=16)
            * torch.as_tensor(w)).sum()
    grads = torch.autograd.grad(loss, leaves + [tx])
    assert len(leaves) == len(jax.tree_util.tree_leaves(jg))
    for g, want in zip(grads, jax.tree_util.tree_leaves(jg) + [jgx]):
        _close(g, want, 1e-4)


@pytest.mark.parametrize("head_dim,rotary_dim", [(32, 8), (160, 40)])
def test_partial_rotary_at_the_configs_shapes(head_dim, rotary_dim):
    """stablelm's rotary_pct 0.25: 8 of 32 features a head (the reduced
    config) and 40 of 160 (the full one) rotate and the rest pass
    through untouched; apply_rope and a QK-normed GQA at that head_dim
    against the reference, the biases and scales perturbed."""
    _, tc = _configs("stablelm-12b", reduced=head_dim == 32)
    assert (tc.head_dim, tc.attn_cfg.rotary_dim) == (head_dim, rotary_dim)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, 3, head_dim)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(2, 9))
    jinv = jlayers.rope_freqs(head_dim, 10000.0, rotary_dim)
    tinv = layers.rope_freqs(head_dim, 10000.0, rotary_dim)
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), jinv,
                              rotary_dim=rotary_dim)
    got = layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), tinv,
                            rotary_dim=rotary_dim)
    _close(got, want, 1e-6)
    np.testing.assert_array_equal(_np(got)[..., rotary_dim:],
                                  x[..., rotary_dim:])
    acfg = jattn.AttnConfig(d_model=96, n_heads=2, n_kv_heads=1,
                            head_dim=head_dim, rotary_pct=0.25,
                            qk_norm=True, qkv_bias=True)
    assert acfg.rotary_dim == rotary_dim
    tcfg = attention.AttnConfig(**dataclasses.asdict(acfg))
    jp = jax.tree_util.tree_map(np.asarray, jattn.gqa_init(
        jax.random.PRNGKey(3), acfg))
    jp = _perturbed(jp, np.random.default_rng(8))
    xs = rng.normal(size=(2, 24, 96)).astype(np.float32)
    want = jax.jit(lambda p, x: jattn.gqa_apply(
        p, x, acfg, q_chunk=8, kv_chunk=16))(jp, jnp.asarray(xs))
    got = attention.gqa_apply(lm_to_port(jp), torch.as_tensor(xs), tcfg,
                              q_chunk=8, kv_chunk=16)
    _close(got, want)


def test_sliding_window_masks_old_tokens():
    """The reference's test (tests/test_models.py), held against the
    reference too: at window 8, perturbing the first of 32 tokens moves
    none of the last position's hidden state, and the port's hidden
    states equal the reference's."""
    arch = "h2o-danube-1.8b"
    jc, tc = _configs(arch, window=8)
    jp, tp = _params(arch)
    toks = np.random.default_rng(9).integers(0, tc.vocab, size=(1, 32))
    toks2 = toks.copy()
    toks2[0, 0] = (toks[0, 0] + 1) % tc.vocab
    h, _ = fwd.forward(tp, tc, torch.as_tensor(toks))
    h2, _ = fwd.forward(tp, tc, torch.as_tensor(toks2))
    np.testing.assert_allclose(_np(h)[0, -1], _np(h2)[0, -1], atol=1e-5)
    assert np.abs(_np(h)[0, 0] - _np(h2)[0, 0]).max() > 1e-3
    want, _ = jax.jit(lambda p, t: jfwd.forward(p, jc, t))(
        jp, jnp.asarray(toks, jnp.int32))
    _close(h, want)


def test_swa_ring_buffer_wraparound():
    """The reference's test (tests/test_models.py), held against the
    reference: window 8, 20 tokens decoded into a ring buffer of 8
    slots (it wraps twice). Every step's logits and cache equal the
    reference decode's, and the logits equal the port's chunked forward
    (which masks past the window) within 1e-5."""
    arch = "h2o-danube-1.8b"
    jc, tc = _configs(arch, window=8)
    jp, tp = _params(arch)
    bs, s = 2, 20
    toks = np.random.default_rng(10).integers(0, tc.vocab, size=(bs, s))
    jcache = jfwd.init_cache(jc, bs, s)
    tcache = fwd.init_cache(tc, bs, s)
    assert tcache["blocks"]["k"].shape[2] == 8
    assert jcache["blocks"]["k"].shape[2] == 8
    step = jax.jit(lambda p, c, t, pos: jfwd.decode_step(p, jc, c, t, pos))
    outs = []
    for t in range(s):
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1],
                                                  jnp.int32), jnp.int32(t))
        tl, tcache = fwd.decode_step(tp, tc, tcache,
                                     torch.as_tensor(toks[:, t:t + 1]), t)
        _close(tl, jl)
        for key in ("k", "v"):
            _close(tcache["blocks"][key], jcache["blocks"][key])
        np.testing.assert_array_equal(tcache["blocks"]["slot_pos"].numpy(),
                                      np.asarray(jcache["blocks"]["slot_pos"]))
        outs.append(tl)
    assert tcache["blocks"]["slot_pos"][0].tolist() == [16, 17, 18, 19, 12,
                                                        13, 14, 15]
    with torch.no_grad():
        full = tfm.unembed_apply(
            tp["unembed"], fwd.forward(tp, tc, torch.as_tensor(toks))[0], tc)
    _close(torch.cat(outs, 1), _np(full))


# ---------------------------------------------------------------------------
# forward, lm_loss and its gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_lm_loss_match_reference(arch, groups):
    """S = 80 over attention chunks of 16 x 24 and loss chunks of 24,
    with a mask, with and without Fed2; the eval and prefill steps'
    kernel route (plain versions on the CPU) gives the same loss."""
    over = dict(loss_chunk=24, attn_q_chunk=16, attn_kv_chunk=24)
    jc, tc = _configs(arch, groups, **over)
    jp, tp = _params(arch, groups)
    batch = _batch(tc.vocab, 2, 80, seed=groups)
    jh, _ = jax.jit(lambda p, t: jfwd.forward(p, jc, t))(
        jp, jnp.asarray(batch["tokens"]))
    th, taux = fwd.forward(tp, tc, torch.as_tensor(batch["tokens"]))
    assert th.shape == (2, 80, tc.d_model) and float(taux) == 0.0
    _close(th, jh)
    jl = jax.jit(lambda p, b: jfwd.lm_loss(p, jc, b))(jp, _jb(batch))
    tl = fwd.lm_loss(tp, tc, _tb(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(
        float(steps.make_eval_step(tc)(tp, _tb(batch))), float(tl),
        rtol=1e-6)


@pytest.mark.parametrize("groups", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_grad_matches_jax(arch, groups):
    """Plain autograd (block and kv-step remat on) against ``jax.grad``,
    per leaf: the biases' and QK-norm scales' gradients included."""
    over = dict(loss_chunk=24, attn_q_chunk=16, attn_kv_chunk=16)
    jc, tc = _configs(arch, groups, **over)
    jp, tp = _params(arch, groups)
    batch = _batch(tc.vocab, 2, 40, seed=10 + groups)
    jg = jax.jit(jax.grad(lambda p: jfwd.lm_loss(p, jc, _jb(batch))))(jp)
    _, tg = steps.value_and_grad(tp, tc, _tb(batch))
    assert tree_paths(tg) == tree_paths(jg)
    for g, w in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        _close(g, w, 1e-4)


# ---------------------------------------------------------------------------
# decode and serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, groups):
    """12 tokens, with and without Fed2: logits and every cache leaf of
    both stacks after every token. Danube's cache is cut to 8 slots
    (max_len 8 under its window of 64), so its ring buffer wraps, as
    the reference's does."""
    jc, tc = _configs(arch, groups)
    jp, tp = _params(arch, groups)
    bs, n = 3, 12
    max_len = 8 if tc.window else 16
    jcache = jfwd.init_cache(jc, bs, max_len)
    tcache = fwd.init_cache(tc, bs, max_len)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_forward_equals_token_by_token_decode(arch):
    """The prefill path (chunked attention, 3 q and 3 kv chunks) and the
    decode path (one KV slot per token; danube at window 8, its ring
    buffer wrapping) on 20 tokens of the Fed2 config: the same logits
    at every position."""
    over = {"window": 8} if arch == "h2o-danube-1.8b" else {}
    _, tc = _configs(arch, 4, attn_q_chunk=8, attn_kv_chunk=8, **over)
    _, tp = _params(arch, 4)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_run_serve_greedy_tokens_match_reference(arch):
    jc, tc = _configs(arch, 4)
    jp, tp = _params(arch, 4)
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
# the CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_cli_trains_each_config_on_the_cpu(arch, capsys):
    out = train.main(["--mode", "lm", "--arch", arch, "--reduced",
                      "--device", "cpu", "--fed2", "--fed2-groups", "4",
                      "--steps", "2", "--batch", "2", "--seq", "16",
                      "--lr", "1e-3"])
    assert len(out["loss"]) == 2 and np.isfinite(out["loss"]).all()
    assert "gblocks" in out["final_params"]
    assert "step     1 loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_each_config_on_the_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--device", "cpu", "--prompt-len",
                      "3", "--gen", "2", "--fed2-groups", "4"])
    assert out["tokens"].shape == (4, 2)
    assert bool(torch.isfinite(out["logits"]).all())
    assert f"arch={arch}-reduced prefill 3 tok" in capsys.readouterr().out
    cfg = serve.config_of(serve.parse_args(["--arch", arch, "--full",
                                            "--fed2-groups", "8"]))
    assert (cfg.arch_id, cfg.fed2_groups, cfg.fed2_decouple) == (arch, 8, 6)
