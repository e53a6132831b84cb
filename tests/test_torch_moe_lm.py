"""The port's MoE LMs (``mixtral-8x22b``: GQA with a sliding window and
8 routed experts top-2; ``deepseek-v2-236b``: MLA, a dense first layer
and 160 routed experts top-6 beside 2 shared ones) against the JAX
package, on the CPU, from the same numpy inputs and the same weights
(the reference's ``init_params``, converted by ``convert.lm_to_port``).
The models are the reduced configs (2 layers, d 256, 4 experts, fp32),
plain and under ``with_fed2(groups=4)`` (no decoupled blocks: the
experts are the structure groups).

The norm scales start at 1, which would hide a norm applied in the
wrong place, so every parity test first sets each RMSNorm scale to 1 +
0.3 N(0, 1), the same in both packages.

Tolerances (fp32), as max |got - want| <= tol * max |want|:
- ``forward`` (hidden state and aux), ``decode_step`` (logits and every
  cache leaf): 1e-5, as in tests/test_torch_dense.py; ``lm_loss``
  rtol 1e-5;
- gradients, per leaf: 1e-4 of the leaf's largest gradient;
- prefill against token-by-token decode (capacity factor 16, nothing
  dropped): the reference's own atol 5e-2, rtol 1e-2
  (tests/test_models.py's test_prefill_decode_agreement), and the
  port's two routes against each other within 1e-5;
- two rounds of ``run_federated(lm_task)``: final params within rtol =
  atol = 1e-5 and the accuracy within one eval position, as
  tests/test_torch_lm_fl.py holds the other LMs;
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
from repro.data.synthetic import make_token_dataset
from repro.fl import runtime as jrt
from repro.models import forward as jfwd
from repro.models import transformer as jtfm
from repro.models.module import param_count as jax_param_count
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import get_config
from repro_torch.configs.common import with_fed2
from repro_torch.convert import lm_to_port, lm_to_reference
from repro_torch.core import fusion
from repro_torch.fl import runtime as rt
from repro_torch.launch import serve, steps, train
from repro_torch.models import forward as fwd
from repro_torch.models import transformer as tfm
from repro_torch.models.module import (key_path, param_count, tree_leaves,
                                       tree_paths)

ARCHS = ("mixtral-8x22b", "deepseek-v2-236b")
GAP = 1e-4
# the reference's param_count(jax.eval_shape(init_params)) of each full
# config, plain and under with_fed2(groups=8); and of the depth cuts the
# card drives (chip_smoke.py): serving at 8 layers, decode parity at 2,
# --mode lm with Fed2 8 at 1 layer (mixtral) and at 3 layers with 16 of
# the 160 routed experts (deepseek)
FULL_PARAMS = {("mixtral-8x22b", 0): 140_630_071_296,
               ("mixtral-8x22b", 8): 140_453_910_528,
               ("deepseek-v2-236b", 0): 235_741_434_880,
               ("deepseek-v2-236b", 8): 235_282_682_880}
CUT_PARAMS = {("mixtral-8x22b", 0, 8, None): 20_435_146_752,
              ("mixtral-8x22b", 8, 8, None): 20_258_985_984,
              ("deepseek-v2-236b", 0, 8, None): 29_191_377_920,
              ("deepseek-v2-236b", 8, 8, None): 28_732_625_920,
              ("mixtral-8x22b", 8, 2, None): 5_234_620_416,
              ("deepseek-v2-236b", 8, 2, None): 4_899_927_040,
              ("mixtral-8x22b", 8, 1, None): 2_730_559_488,
              ("deepseek-v2-236b", 8, 3, 16): 2_075_796_480}


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
    with_fed2; field overrides on both."""
    jc = jax_get_config(arch, reduced=reduced)
    tc = get_config(arch, reduced=reduced)
    if groups:
        jc = jax_with_fed2(jc, groups=groups)
        tc = with_fed2(tc, groups=groups)
    return dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)


def _no_drops(jc, tc):
    """Both configs at capacity factor 16 (nothing drops)."""
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=16.0)) for c in (jc, tc))


def _perturbed(tree, rng, path=()):
    """``tree`` (numpy) with every norm ``scale`` drawn 1 + 0.3 N(0, 1)
    from ``rng``, in flattening order."""
    if isinstance(tree, dict):
        return {k: _perturbed(tree[k], rng, path + (k,))
                for k in sorted(tree)}
    if path[-1] == "scale":
        return (1.0 + 0.3 * rng.normal(size=tree.shape)).astype(tree.dtype)
    return tree


_INIT = {}


def _params(arch, groups=0):
    """The reference's reduced init (``init_params`` at PRNGKey(0),
    jitted) as numpy with its norm scales perturbed, and the port's
    conversion of it; cached."""
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
    """Every field the port reads, the MoE and MLA configs included;
    check_ported accepts each (with_fed2 decouples no block of a MoE
    LM)."""
    jc, tc = _configs(arch, groups, reduced=reduced)
    for f in ("arch_id", "family", "n_layers", "d_model", "vocab", "d_ff",
              "n_heads", "n_kv_heads", "head_dim", "norm", "act",
              "rope_theta", "rotary_pct", "qkv_bias", "qk_norm", "window",
              "use_rope", "fed2_groups", "fed2_decouple", "n_dense_blocks",
              "padded_vocab", "loss_chunk", "attn_q_chunk", "attn_kv_chunk",
              "remat_blocks", "tie_embeddings", "moe_first_dense",
              "moe_dense_ff"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert dataclasses.asdict(tc.moe) == dataclasses.asdict(jc.moe)
    assert dataclasses.asdict(tc.attn_cfg) == dataclasses.asdict(jc.attn_cfg)
    if jc.mla_cfg is None:
        assert tc.mla_cfg is None
    else:
        assert dataclasses.asdict(tc.mla_cfg) == dataclasses.asdict(
            jc.mla_cfg)
        assert tc.mla_cfg.qk_head_dim == jc.mla_cfg.qk_head_dim == 192
    assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
    assert tc.fed2_decouple == 0
    tfm.check_ported(tc)


def test_check_ported_keeps_refusing_decoupled_moe_blocks():
    """with_fed2 sets decouple 0 for MoE; a MoE config with decoupled
    blocks (which the reference builds with routed experts) is refused;
    the encdec and vlm reduced configs, plain and Fed2, are accepted."""
    _, tc = _configs("mixtral-8x22b", 4)
    with pytest.raises(NotImplementedError,
                       match="'dense', 'vlm', 'encdec' families only"):
        tfm.check_ported(dataclasses.replace(tc, fed2_decouple=1))
    for arch in ("whisper-base", "internvl2-2b"):
        cfg = get_config(arch, reduced=True)
        assert cfg.family == jax_get_config(arch, reduced=True).family
        tfm.check_ported(cfg)
        tfm.check_ported(with_fed2(cfg, groups=4))


def _meta_init(tc):
    """The port's init of ``tc`` on ``meta``: shapes and dtypes of a
    full-width tree without its memory."""
    return tfm.init_params(torch.Generator(), tc, device="meta")


@pytest.mark.parametrize("groups", [0, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_sizes(arch, groups):
    """The reference's parameter count of the full config (its
    ``jax.eval_shape``) equals the pinned constant (chip_smoke.py's
    SERVE_PARAMS), and the port's init of the full config (on
    ``meta``) has it leaf for leaf: the stacked experts (L, E, d, f),
    DeepSeek's dense first layer under ``pre_blocks``."""
    jc, tc = _configs(arch, groups, reduced=False)
    want = jax.eval_shape(lambda k: jtfm.init_params(k, jc),
                          jax.random.PRNGKey(0))
    assert jax_param_count(want) == FULL_PARAMS[arch, groups]
    got = _meta_init(tc)
    assert param_count(got) == FULL_PARAMS[arch, groups]
    assert tree_paths(got) == tree_paths(
        jax.tree_util.tree_map(lambda s: 0, want))
    for w, g in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        assert tuple(w.shape) == tuple(g.shape)
        assert g.dtype == torch.bfloat16
    e, d, f = tc.moe.n_experts, tc.d_model, tc.moe.d_ff_expert
    n_moe = tc.n_layers - tc.moe_first_dense
    assert tuple(got["blocks"]["ffn"]["w_gate"].shape) == (n_moe, e, d, f)
    assert ("pre_blocks" in got) == (arch == "deepseek-v2-236b")


@pytest.mark.parametrize("key", sorted(CUT_PARAMS, key=str))
def test_depth_cut_sizes(key):
    """The depth (and expert) cuts the card drives: the reference's
    parameter count of each equals the pinned constant, and so does the
    port's (meta) init."""
    arch, groups, layers, experts = key
    jc, tc = _configs(arch, groups, reduced=False, n_layers=layers)
    if experts:
        jc, tc = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, n_experts=experts)) for c in (jc, tc))
    want = jax.eval_shape(lambda k: jtfm.init_params(k, jc),
                          jax.random.PRNGKey(0))
    assert jax_param_count(want) == CUT_PARAMS[key]
    assert param_count(_meta_init(tc)) == CUT_PARAMS[key]


@pytest.mark.parametrize("groups", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch, groups):
    """Same leaves (router, stacked experts, the shared expert, MLA's
    wq_a/q_a_norm/wq_b/wkv_a/kv_a_norm/wk_b/wv_b/wo, pre_blocks),
    shapes, dtypes and parameter count; ``lm_to_port`` and
    ``lm_to_reference`` carry the reference's tree across to the
    bit."""
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
    jp, tp = _params(arch, groups)
    back = lm_to_reference(tp)
    assert tree_paths(back) == tree_paths(jp)
    for a, b in zip(tree_leaves(back), tree_leaves(jp)):
        np.testing.assert_array_equal(a, b)


def test_stack_init_draws_each_layer_in_turn():
    """``stack_init`` fills the stack layer by layer (its peak is the
    stack and one layer): the same numbers as drawing the layers one
    after another and stacking them."""
    from repro_torch.models.module import stack_init
    _, tc = _configs("deepseek-v2-236b")
    got = stack_init(tfm.block_init, torch.Generator().manual_seed(3), 3,
                     cfg=tc)
    gen = torch.Generator().manual_seed(3)
    layers = [tfm.block_init(gen, tc) for _ in range(3)]
    for path, leaf in zip(tree_paths(got), tree_leaves(got)):
        want = torch.stack([tree_leaves(layer)[tree_paths(got).index(path)]
                            for layer in layers])
        assert torch.equal(leaf, want), path


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_group_axes_mark_the_experts(arch):
    """``lm_group_axes`` on the port's own Fed2 tree against the
    reference's on its tree: the routed experts' stacked weights carry
    GroupAxis(1, E), the unembedding GroupAxis(0, G); the router, the
    shared expert and pre_blocks are shared."""
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
    e = tc.moe.n_experts
    assert {k: v for k, v in have.items() if v is not None} == {
        "['blocks']/['ffn']/['w_down']": (1, e),
        "['blocks']/['ffn']/['w_gate']": (1, e),
        "['blocks']/['ffn']/['w_up']": (1, e),
        "['unembed']/['w']": (0, 4)}


# ---------------------------------------------------------------------------
# forward, lm_loss and its gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_lm_loss_match_reference(arch, groups):
    """S = 40 over attention chunks of 16 x 24 and loss chunks of 24,
    with a mask, with and without Fed2, at the default capacity factor
    (pairs drop): the hidden state, the aux loss (non-zero) and
    ``lm_loss`` (CE + 0.01 aux); the eval step's kernel route (plain
    versions on the CPU) gives the same loss."""
    over = dict(loss_chunk=24, attn_q_chunk=16, attn_kv_chunk=24)
    jc, tc = _configs(arch, groups, **over)
    jp, tp = _params(arch, groups)
    batch = _batch(tc.vocab, 3, 40, seed=groups)
    jh, jaux = jax.jit(lambda p, t: jfwd.forward(p, jc, t))(
        jp, jnp.asarray(batch["tokens"]))
    th, taux = fwd.forward(tp, tc, torch.as_tensor(batch["tokens"]))
    assert th.shape == (3, 40, tc.d_model) and taux.dtype == torch.float32
    _close(th, jh)
    _close(taux, jaux)
    assert float(taux) > 0.5
    jl = jax.jit(lambda p, b: jfwd.lm_loss(p, jc, b))(jp, _jb(batch))
    tl = fwd.lm_loss(tp, tc, _tb(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    b = _tb(batch)
    ce = tfm.chunked_ce_loss(tp, th, b["labels"], b["mask"], tc)
    assert fwd.AUX_WEIGHT == 0.01
    np.testing.assert_allclose(float(tl) - float(ce), 0.01 * float(taux),
                               rtol=1e-4)
    np.testing.assert_allclose(
        float(steps.make_eval_step(tc)(tp, _tb(batch))), float(tl),
        rtol=1e-6)


@pytest.mark.parametrize("groups", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_grad_matches_jax(arch, groups):
    """Plain autograd (block and kv-step remat on) against ``jax.grad``,
    per leaf: the router's gradient (through the weights and the aux
    loss), the experts', MLA's and the shared expert's."""
    over = dict(loss_chunk=24, attn_q_chunk=16, attn_kv_chunk=16)
    jc, tc = _configs(arch, groups, **over)
    jp, tp = _params(arch, groups)
    batch = _batch(tc.vocab, 2, 24, seed=10 + groups)
    jg = jax.jit(jax.grad(lambda p: jfwd.lm_loss(p, jc, _jb(batch))))(jp)
    _, tg = steps.value_and_grad(tp, tc, _tb(batch))
    assert tree_paths(tg) == tree_paths(jg)
    for g, w in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_under_vmap_grad(arch):
    """The round engine's ``vmap(grad(lm_loss))`` over a flat (C, M)
    buffer of 2 clients' params (no remat under torch.func) equals each
    client's plain-autograd gradient."""
    from repro_torch.models.module import FlatLayout
    _, tc = _configs(arch, 4, loss_chunk=24)
    _, tp = _params(arch, 4)
    layout = FlatLayout(tp)
    rows = torch.stack([layout.flatten(tp),
                        1.01 * layout.flatten(tp)])
    batch = _tb(_batch(tc.vocab, 2, 16, seed=3))
    got = torch.func.vmap(torch.func.grad(
        lambda row: fwd.lm_loss(layout.unflatten(row), tc, batch)))(rows)
    for i in range(2):
        _, g = steps.value_and_grad(layout.unflatten(rows[i]), tc, batch)
        _close(got[i], _np(layout.flatten(g)), 1e-5)


# ---------------------------------------------------------------------------
# decode and serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, groups):
    """12 tokens at batch 3, with and without Fed2: logits and every
    cache leaf (mixtral's ring buffer, deepseek's latent caches in
    ``pre_blocks`` and ``blocks``) after every token."""
    jc, tc = _configs(arch, groups)
    jp, tp = _params(arch, groups)
    bs, n = 3, 12
    jcache = jfwd.init_cache(jc, bs, 16)
    tcache = fwd.init_cache(tc, bs, 16)
    assert tree_paths(tcache) == tree_paths(
        jax.tree_util.tree_map(lambda a: 0, jcache))
    for a, b in zip(tree_leaves(tcache), jax.tree_util.tree_leaves(jcache)):
        assert tuple(a.shape) == b.shape
    step = jax.jit(lambda p, c, t, pos: jfwd.decode_step(p, jc, c, t, pos))
    toks = np.random.default_rng(4).integers(0, jc.vocab, size=(bs, n))
    for t in range(n):
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1],
                                                  jnp.int32), jnp.int32(t))
        tl, tcache = fwd.decode_step(tp, tc, tcache,
                                     torch.as_tensor(toks[:, t:t + 1]), t)
        assert tl.shape == (bs, 1, jc.vocab)
        _close(tl, jl)
        for a, b in zip(tree_leaves(tcache),
                        jax.tree_util.tree_leaves(jcache)):
            if a.is_floating_point():
                _close(a, b)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_agreement(arch):
    """The reference's test on the port, held to the reference too: 12
    tokens at capacity factor 16 (nothing drops), the chunked forward's
    logits against 12 decode steps (GQA ring buffer or MLA's absorbed
    decode) within the reference's atol 5e-2 / rtol 1e-2, and the
    port's two routes within 1e-5; the reference's decode logits within
    1e-5 of the port's."""
    jc, tc = _no_drops(*_configs(arch, 4, attn_q_chunk=8, attn_kv_chunk=8))
    jp, tp = _params(arch, 4)
    toks = np.random.default_rng(8).integers(0, tc.vocab, size=(2, 12))
    with torch.no_grad():
        h, _ = fwd.forward(tp, tc, torch.as_tensor(toks))
        want = tfm.unembed_apply(tp["unembed"], h, tc)
        cache = fwd.init_cache(tc, 2, 32)
        got = torch.cat([fwd.decode_step(tp, tc, cache,
                                         torch.as_tensor(toks[:, t:t + 1]),
                                         t)[0] for t in range(12)], 1)
    np.testing.assert_allclose(_np(got), _np(want), atol=5e-2, rtol=1e-2)
    _close(got, _np(want))
    step = jax.jit(lambda p, c, t, pos: jfwd.decode_step(p, jc, c, t, pos))
    jcache = jfwd.init_cache(jc, 2, 32)
    jl = []
    for t in range(12):
        lg, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1],
                                                  jnp.int32), jnp.int32(t))
        jl.append(np.asarray(lg))
    _close(got, np.concatenate(jl, 1))


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
# LM federation
# ---------------------------------------------------------------------------

SEQ, N_CLIENTS = 16, 4
_DATA, _JAX_RUNS = {}, {}


def _fl_inputs():
    """4 clients, one token domain each, and a 16-sequence eval set (the
    reduced vocab, 512, is both archs')."""
    if not _DATA:
        toks, domains = make_token_dataset(120, SEQ + 1, 512,
                                           n_domains=N_CLIENTS, seed=0)
        test, _ = make_token_dataset(16, SEQ + 1, 512, n_domains=N_CLIENTS,
                                     seed=7)
        _DATA.update(toks=toks, parts=[np.flatnonzero(domains == j)
                                       for j in range(N_CLIENTS)],
                     test=[{"tokens": test[:, :-1], "labels": test[:, 1:],
                            "mask": np.ones((16, SEQ), np.float32)}])
    return _DATA


def _get_batch(sel):
    sl = _fl_inputs()["toks"][sel]
    return {"tokens": sl[:, :-1], "labels": sl[:, 1:],
            "mask": np.ones((len(sel), SEQ), np.float32)}


def _fl(method):
    return dict(population=N_CLIENTS, rounds=2, local_epochs=1,
                steps_per_epoch=2, batch_size=4, lr=0.01, momentum=0.9,
                method=method, seed=0, eval_batch=16)


@pytest.mark.parametrize("method", ["fedavg", "fed2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_run_federated_lm_task_matches_reference(arch, method):
    """Two rounds of run_federated(lm_task) on the reduced Fed2 config
    (4 clients, 2 local momentum-SGD steps of batch 4, the MoE aux loss
    in every client's loss; fed2 fuses the experts as its structure
    groups): final params within rtol = atol = 1e-5, next-token
    accuracy per round within one eval position."""
    jc, tc = _configs(arch, 4)
    jp, tp = _params(arch, 4)
    data = _fl_inputs()
    if (arch, method) not in _JAX_RUNS:
        task = dataclasses.replace(jrt.lm_task(jc), init_fn=lambda k: jp)
        _JAX_RUNS[arch, method] = jrt.run_federated(
            task, jrt.FLConfig(**_fl(method)), data["parts"],
            lambda sel: {k: jnp.asarray(v)
                         for k, v in _get_batch(sel).items()}, data["test"])
    want = _JAX_RUNS[arch, method]
    got = rt.run_federated(rt.lm_task(tc), rt.FLConfig(**_fl(method)),
                           data["parts"], _get_batch, data["test"],
                           device="cpu", init_params=tp)
    assert got["round"] == [0, 1]
    np.testing.assert_allclose(got["acc"], want["acc"], atol=1.0 / (16 * SEQ))
    moved = 0
    for a, b, c in zip(tree_leaves(got["final_params"]),
                       jax.tree_util.tree_leaves(want["final_params"]),
                       tree_leaves(tp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
        moved += int(not torch.equal(a, c))
    assert moved == len(tree_leaves(tp))


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
    assert "gblocks" not in out["final_params"]
    assert ("pre_blocks" in out["final_params"]) == (arch != "mixtral-8x22b")
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
    assert (cfg.arch_id, cfg.fed2_groups, cfg.fed2_decouple) == (arch, 8, 0)
