"""The port's Mamba-2 serving path (``repro_torch.models.{layers,ssm,
transformer,forward}``, ``launch/serve.py``, ``convert.lm_to_port``)
against the JAX package, on the CPU, from the same numpy inputs and the
same weights (the reference's ``init_params``, converted).

Tolerances: fp32 rtol = atol = 1e-5 for layers, one decode layer, and
``decode_step`` over 8 tokens (logits and every cache leaf after each
token); the two frameworks sum matrix products and einsums in other
orders, and the SSM state (|h| up to ~50 over 8 tokens) carries that
round-off forward. bf16 RMSNorm within one bf16 step (1e-2 relative).
Greedy tokens must be equal wherever the reference's top-2 logit gap
exceeds 1e-4 (ten times the logits' tolerance); past the first closer
gap in a row the two may rightly part.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.common import with_fed2 as jax_with_fed2
from repro.models import forward as jfwd
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.models.module import param_count as jax_param_count
from repro_torch.configs import get_config
from repro_torch.configs.common import with_fed2
from repro_torch.convert import lm_to_port, lm_to_reference
from repro_torch.launch import serve
from repro_torch.models import layers, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.forward import decode_step, init_cache
from repro_torch.models.module import param_count, tree_leaves, tree_paths

ARCH = "mamba2-1.3b"
TOL = dict(rtol=1e-5, atol=1e-5)
GAP = 1e-4


def _configs(groups=0, reduced=True, dtype=None):
    """(reference config, port config); ``dtype`` ("float32" or
    "bfloat16") overrides both."""
    jkw = {} if dtype is None else {"dtype": getattr(jnp, dtype)}
    tkw = {} if dtype is None else {"dtype": getattr(torch, dtype)}
    jc = jax_get_config(ARCH, reduced=reduced, **jkw)
    tc = get_config(ARCH, reduced=reduced, **tkw)
    if groups:
        jc, tc = jax_with_fed2(jc, groups=groups), with_fed2(tc,
                                                             groups=groups)
    return jc, tc


_PARAMS = {}


def _params(groups):
    """The reference's reduced init (PRNGKey(0)) as numpy, and the port's
    conversion of it; cached per group count."""
    if groups not in _PARAMS:
        jc, _ = _configs(groups)
        jp = jax.tree_util.tree_map(
            np.asarray, jtfm.init_params(jax.random.PRNGKey(0), jc))
        _PARAMS[groups] = (jp, lm_to_port(jp))
    return _PARAMS[groups]


def _np(t):
    return t.detach().to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("groups", [0, 4, 8])
def test_configs_match_reference(reduced, groups):
    jc, tc = _configs(groups, reduced=reduced)
    for f in ("arch_id", "family", "n_layers", "d_model", "vocab", "d_ff",
              "norm", "fed2_groups", "fed2_decouple", "padded_vocab"):
        assert getattr(tc, f) == getattr(jc, f), f
    for f in ("d_model", "d_state", "headdim", "expand", "conv_kernel",
              "chunk", "d_inner", "n_heads", "conv_dim"):
        assert getattr(tc.ssm, f) == getattr(jc.ssm, f), f
    assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name


def test_full_config_sizes():
    _, tc = _configs(reduced=False)
    assert (tc.n_layers, tc.d_model, tc.ssm.d_inner, tc.ssm.n_heads,
            tc.ssm.headdim, tc.ssm.d_state, tc.ssm.conv_kernel,
            tc.padded_vocab) == (48, 2048, 4096, 64, 64, 128, 4, 50304)
    assert tc.dtype == torch.bfloat16
    assert with_fed2(tc, groups=8).fed2_decouple == 0


def test_with_fed2_decouple_rule_matches_reference():
    """Outside ``ssm`` the decouple depth follows the layer count; the
    port applies the rule to any config with the fields it reads."""
    jc = jax_get_config("llama3.2-1b")
    tc = tfm.ModelConfig(arch_id=jc.arch_id, family=jc.family,
                         n_layers=jc.n_layers, d_model=jc.d_model,
                         vocab=jc.vocab, d_ff=jc.d_ff)
    for g in (4, 8):
        assert with_fed2(tc, groups=g).fed2_decouple == \
            jax_with_fed2(jc, groups=g).fed2_decouple
    with pytest.raises(ValueError):
        with_fed2(tfm.ModelConfig("x", "dense", 8, 100, 512, d_ff=300),
                  groups=8)


def test_get_config_names_the_ports_archs():
    assert get_config("vgg9").arch_id == "vgg9"
    with pytest.raises(ValueError, match="mamba2-1.3b"):
        get_config("qwen2-7b")


@pytest.mark.parametrize("family", ["moe", "hybrid", "encdec", "vlm"])
def test_other_families_raise_naming_the_family(family):
    cfg = tfm.ModelConfig("x", family, 2, 64, 128, d_ff=128)
    with pytest.raises(NotImplementedError, match=family):
        tfm.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(NotImplementedError, match=family):
        init_cache(cfg, 1, 8)


def test_decoupled_ssm_blocks_raise():
    """with_fed2 never decouples an SSM; a config that does anyway is
    refused, not built without its grouped blocks."""
    _, tc = _configs()
    cfg = tc.__class__(**{**tc.__dict__, "fed2_decouple": 1})
    with pytest.raises(NotImplementedError, match="fed2_decouple=1"):
        tfm.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="unknown LM family"):
        init_cache(tfm.ModelConfig("x", "rnn", 2, 64, 128), 1, 8)


# ---------------------------------------------------------------------------
# init and conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [0, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_reference(groups, dtype):
    """Same leaves, shapes and per-leaf dtypes (a_log, dt_bias and d_skip
    fp32 in a bf16 model) and the same parameter count."""
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


def test_init_draws_the_configs_scale():
    """The fan-in initializer: std 1/sqrt(fan_in) per weight."""
    _, tc = _configs()
    p = tfm.init_params(torch.Generator().manual_seed(0), tc)
    w = p["blocks"]["mixer"]["w_xbc"]["w"]
    assert abs(w.std().item() * np.sqrt(tc.d_model) - 1) < 0.05
    assert torch.equal(p["blocks"]["mixer"]["d_skip"],
                       torch.ones(tc.n_layers, tc.ssm.n_heads))


def test_lm_converter_round_trip_keeps_dtypes_and_layouts():
    jc = jax_get_config(ARCH, reduced=True, dtype=jnp.bfloat16)
    ref = jax.tree_util.tree_map(
        np.asarray, jtfm.init_params(jax.random.PRNGKey(1), jc))
    port = lm_to_port(ref)
    conv = port["blocks"]["mixer"]["conv"]["w"]
    assert conv.shape == ref["blocks"]["mixer"]["conv"]["w"].shape
    assert conv.shape == (jc.n_layers, jc.ssm.conv_kernel, 1,
                          jc.ssm.conv_dim)
    assert conv.dtype == torch.bfloat16
    assert port["blocks"]["mixer"]["a_log"].dtype == torch.float32
    back = lm_to_reference(port)
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.astype(np.float32),
                                      b.astype(np.float32))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = (3 * rng.normal(size=(4, 3, 96))).astype(np.float32)
    s = rng.normal(size=96).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = layers.rmsnorm_apply({"scale": torch.tensor(s).to(tdt)},
                               torch.tensor(x).to(tdt))
    want = jlayers.rmsnorm_apply({"scale": jnp.asarray(s).astype(dtype)},
                                 jnp.asarray(x).astype(dtype))
    assert got.dtype == tdt
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def test_embed_and_silu_match_reference():
    rng = np.random.default_rng(1)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, size=(3, 1))
    got = layers.embed_apply({"table": torch.tensor(table)},
                             torch.tensor(ids))
    want = jlayers.embed_apply({"table": jnp.asarray(table)},
                               jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = rng.normal(size=(5, 7)).astype(np.float32) * 4
    np.testing.assert_allclose(layers.silu(torch.tensor(x)).numpy(),
                               np.asarray(jlayers.silu(jnp.asarray(x))),
                               **TOL)


def test_conv_step_is_the_causal_depthwise_conv():
    """The decode's rolling window, stepped over L tokens, equals the
    reference's full causal depthwise conv (then SiLU) at every
    position."""
    rng = np.random.default_rng(2)
    bs, l, c, k = 2, 7, 12, 4
    x = rng.normal(size=(bs, l, c)).astype(np.float32)
    w = rng.normal(size=(k, 1, c)).astype(np.float32)
    b = rng.normal(size=c).astype(np.float32)
    want = jlayers.silu(jlayers.conv1d_depthwise_apply(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x)))
    p = {"w": torch.tensor(w), "b": torch.tensor(b)}
    state = torch.zeros(bs, k - 1, c)
    for t in range(l):
        out, state = ssm.conv_step(p, state, torch.tensor(x[:, t]))
        np.testing.assert_allclose(out.numpy(), np.asarray(want[:, t]),
                                   **TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_mamba2_decode_layer_matches_reference(use_kernel):
    """One layer of the reduced config from a non-zero cache."""
    jc, tc = _configs()
    jp, tp = _params(0)
    jlayer = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["mixer"])
    tlayer = _layer(tp["blocks"]["mixer"], 0)
    rng = np.random.default_rng(3)
    bs = 3
    x = rng.normal(size=(bs, 1, tc.d_model)).astype(np.float32)
    conv = rng.normal(size=(bs, tc.ssm.conv_kernel - 1,
                            tc.ssm.conv_dim)).astype(np.float32)
    state = rng.normal(size=(bs, tc.ssm.n_heads, tc.ssm.headdim,
                             tc.ssm.d_state)).astype(np.float32)
    want, wcache = jssm.mamba2_decode(
        jlayer, jnp.asarray(x), {"conv": jnp.asarray(conv),
                                 "ssm": jnp.asarray(state)}, jc.ssm)
    cache = {"conv": torch.tensor(conv), "ssm": torch.tensor(state)}
    got, gcache = ssm.mamba2_decode(tlayer, torch.tensor(x), cache, tc.ssm,
                                    use_kernel=use_kernel)
    assert gcache is cache                       # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(wcache[k]),
                                   **TOL)


def _layer(tree, i):
    from repro_torch.models.module import tree_map
    return tree_map(lambda t: t[i], tree)


# ---------------------------------------------------------------------------
# decode_step and serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [0, 4])
def test_decode_step_matches_reference(groups):
    """8 tokens through the reduced mamba2-1.3b in fp32, with and without
    Fed2's grouped unembedding: logits and the whole cache after every
    token."""
    jc, tc = _configs(groups)
    jp, tp = _params(groups)
    bs, steps = 3, 8
    jcache = jfwd.init_cache(jc, bs, 16)
    tcache = init_cache(tc, bs, 16)
    step = jax.jit(lambda p, c, t, pos: jfwd.decode_step(p, jc, c, t, pos))
    toks = np.random.default_rng(4).integers(0, jc.vocab, size=(bs, steps))
    for t in range(steps):
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1],
                                                  jnp.int32), jnp.int32(t))
        tl, tcache = decode_step(tp, tc, tcache,
                                 torch.as_tensor(toks[:, t:t + 1]), t)
        assert tl.shape == (bs, 1, jc.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(tcache["blocks"][k].numpy(),
                                       np.asarray(jcache["blocks"][k]),
                                       **TOL)


@pytest.mark.parametrize("groups", [0, 4])
def test_decode_step_kernel_routes_equal_plain_routes_on_cpu(groups):
    """On CPU tensors the kernels' wrappers take their plain versions,
    which compute exactly what the model's plain routes compute."""
    _, tc = _configs(groups)
    _, tp = _params(groups)
    caches = [init_cache(tc, 2, 8) for _ in range(2)]
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, tc.vocab, size=(2, 4)))
    for t in range(4):
        a, _ = decode_step(tp, tc, caches[0], toks[:, t:t + 1], t)
        b, _ = decode_step(tp, tc, caches[1], toks[:, t:t + 1], t,
                           use_kernel=False)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def _jax_serve(jc, jp, *, batch, prompt_len, gen, seed):
    """The reference's serve loop (``repro.launch.serve.main``), greedy,
    without its host mesh: returns the tokens and each decoded step's
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


def test_serve_cli_on_the_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--device", "cpu", "--prompt-len",
                      "3", "--gen", "2", "--fed2-groups", "4"])
    assert out["tokens"].shape == (4, 2)
    assert out["logits"].shape == (4, 1, 512)
    assert bool(torch.isfinite(out["logits"]).all())
    text = capsys.readouterr().out
    assert "arch=mamba2-1.3b-reduced prefill 3 tok" in text
    assert "tok/s" in text
    args = serve.parse_args(["--arch", ARCH, "--full", "--fed2-groups", "8"])
    cfg = serve.config_of(args)
    assert (cfg.arch_id, cfg.fed2_groups, cfg.fed2_decouple) == \
        ("mamba2-1.3b", 8, 0)
    d = serve.parse_args([])
    assert (d.arch, d.batch, d.prompt_len, d.gen, d.max_len, d.temperature,
            d.seed, d.full, d.fed2_groups) == \
        ("llama3.2-1b", 4, 32, 16, 128, 0.0, 0, False, 0)
    # the default arch, the reference's: the reduced llama
    out = serve.main(["--device", "cpu", "--prompt-len", "3", "--gen", "2"])
    assert out["tokens"].shape == (4, 2)
    assert bool(torch.isfinite(out["logits"]).all())
    assert "arch=llama3.2-1b-reduced prefill 3 tok" in \
        capsys.readouterr().out


def test_sampled_serve_is_seeded():
    _, tc = _configs()
    _, tp = _params(0)
    runs = [serve.run_serve(tc, batch=2, prompt_len=2, gen=4,
                            temperature=1.0, seed=s, device="cpu",
                            init_params=tp)["tokens"] for s in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert ((runs[0] >= 0) & (runs[0] < tc.vocab)).all()
