"""The port's vision-language family (``internvl2-2b``: the InternLM2
decoder, GQA with RoPE at theta 1e6 and SwiGLU FFNs, whose input
sequence starts with the stubbed vision frontend's patch embeddings)
against the JAX package, on the CPU, from the same numpy inputs and the
same weights (the reference's ``init_params``, converted by
``convert.lm_to_port``). The model is the reduced config (2 layers, d
256, 16 patches, fp32), plain and under ``with_fed2(groups=4,
decouple=1)``: a decoupled block with a block-diagonal SwiGLU FFN and
the block-diagonal unembedding. Decode is text only, as the
reference's (it has no patch-embedding decode entry).

The RMSNorm scales start at 1, which would hide a norm applied in the
wrong place, so every parity test first sets each norm scale to 1 +
0.3 N(0, 1), the same in both packages.

Tolerances, as max |got - want| <= tol * max |want|:
- ``forward(embeds=)`` (the hidden state over patches and text),
  ``lm_loss`` (rtol; text positions only) and ``decode_step`` (logits
  and every cache leaf after every token): 1e-5;
- gradients, per leaf: 1e-4 of the leaf's largest gradient;
- the train step: losses rtol 1e-5 over 3 steps, params as
  tests/test_torch_dense.py holds them;
- greedy serve tokens equal wherever the reference's top-2 logit gap
  exceeds 1e-4;
- the kernel routes on the CPU (the wrappers' plain versions) against
  the plain routes: 1e-6;
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
from repro.models import forward as jfwd
from repro.models import transformer as jtfm
from repro.models.module import param_count as jax_param_count
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import get_config
from repro_torch.configs.common import with_fed2
from repro_torch.convert import lm_to_port, lm_to_reference
from repro_torch.fl import runtime as rt
from repro_torch.launch import serve, steps, train
from repro_torch.models import forward as fwd
from repro_torch.models import transformer as tfm
from repro_torch.models.module import param_count, tree_leaves, tree_paths

ARCH = "internvl2-2b"
GAP = 1e-4
# the reference's param_count(jax.eval_shape(init_params)) of the full
# config, plain and under with_fed2(groups=8) (chip_smoke.py's
# SERVE_PARAMS)
FULL_PARAMS = {0: 1_889_634_304, 8: 1_459_324_928}


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
    """``tree`` (numpy) with every norm ``scale`` drawn 1 + 0.3 N(0, 1),
    from ``rng``, in flattening order."""
    if isinstance(tree, dict):
        return {k: _perturbed(tree[k], rng, path + (k,))
                for k in sorted(tree)}
    if path[-1] == "scale":
        return (1.0 + 0.3 * rng.normal(size=tree.shape)).astype(tree.dtype)
    return tree


_INIT = {}


def _params(groups=0, **over):
    """The reference's reduced init (``init_params`` at PRNGKey(0),
    jitted) as numpy with its norm scales perturbed, and the
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


def _patches(cfg, b, seed):
    """Stub frontend output (b, n_patches, d) ~ N(0, 1)."""
    return np.random.default_rng(seed).normal(
        size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, s + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "mask": (rng.random((b, s)) > 0.2).astype(np.float32),
            "embeds": _patches(cfg, b, seed + 100)}


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
    for f in ("d_model", "n_heads", "n_kv_heads", "head_dim", "rope_theta",
              "rotary_pct", "rotary_dim", "window", "causal"):
        assert getattr(tc.attn_cfg, f) == getattr(jc.attn_cfg, f), f
    assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
    tfm.check_ported(tc)


@pytest.mark.parametrize("groups", [0, 8])
def test_full_config_sizes(groups):
    """The reference's parameter count of the full config (its
    ``jax.eval_shape``) equals the pinned constant the card's serve
    phase checks, and the port's init of the full config (on
    ``meta``) has it leaf for leaf; under Fed2 8 the 6 decoupled blocks'
    SwiGLU FFNs (8, 256, 1024) and (8, 1024, 256) and the unembedding
    (8, 256, 11584)."""
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
    assert tc.fed2_decouple == (6 if groups else 0)
    if groups:
        ff = got["gblocks"]["ffn"]
        assert tuple(ff["w_gate"]["w"].shape) == (6, 8, 256, 1024)
        assert tuple(ff["w_down"]["w"].shape) == (6, 8, 1024, 256)
        assert tuple(got["unembed"]["w"].shape) == (8, 256, 11584)


@pytest.mark.parametrize("groups", [0, 4])
def test_init_params_tree_matches_reference(groups):
    """Same leaves, shapes, dtypes and parameter count; ``lm_to_port``
    and ``lm_to_reference`` carry the reference's tree across and back
    to the bit."""
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
    assert ("gblocks" in got) == bool(groups) and "unembed" in got
    jp, tp = _params(groups)
    back = lm_to_reference(tp)
    assert tree_paths(back) == tree_paths(jp)
    for a, b in zip(tree_leaves(back), tree_leaves(jp)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# forward, lm_loss and its gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(groups=0, s=20, over=dict(attn_q_chunk=8, attn_kv_chunk=24,
                                   loss_chunk=8)),
    dict(groups=4, s=24, over=dict(attn_q_chunk=16, attn_kv_chunk=16,
                                   loss_chunk=16)),
], ids=["plain", "fed2"])
def test_forward_and_lm_loss_match_reference(case):
    """``forward(embeds=patches)`` over the 16 patches and the text at
    positions arange(16 + S), and ``lm_loss`` on a batch carrying
    ``"embeds"`` (the text positions only); the eval and prefill steps'
    kernel route (the wrappers' plain versions on the CPU) gives the
    same loss."""
    jc, tc = _configs(case["groups"], **case["over"])
    jp, tp = _params(case["groups"], **case["over"])
    s = case["s"]
    batch = _batch(tc, 3, s, seed=s + case["groups"])
    jh, _ = jfwd.forward(jp, jc, jnp.asarray(batch["tokens"]),
                         embeds=jnp.asarray(batch["embeds"]))
    th, taux = fwd.forward(tp, tc, torch.as_tensor(batch["tokens"]),
                           embeds=torch.as_tensor(batch["embeds"]))
    assert th.shape == (3, tc.n_patches + s, tc.d_model)
    assert float(taux) == 0.0
    _close(th, jh)
    jl = jfwd.lm_loss(jp, jc, _jb(batch))
    tl = fwd.lm_loss(tp, tc, _tb(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for make in (steps.make_eval_step, steps.make_prefill_loss_step):
        np.testing.assert_allclose(float(make(tc)(tp, _tb(batch))),
                                   float(tl), rtol=1e-6)
    # the patches reach the loss: other patches, another loss
    other = dict(batch, embeds=_patches(tc, 3, seed=99))
    assert float(fwd.lm_loss(tp, tc, _tb(other))) != float(tl)


@pytest.mark.parametrize("groups", [0, 4])
def test_lm_loss_grad_matches_jax(groups):
    """Plain autograd (block and kv-step remat on) against ``jax.grad``,
    per leaf; without remat the same numbers."""
    over = dict(loss_chunk=8, attn_q_chunk=8, attn_kv_chunk=16)
    jc, tc = _configs(groups, **over)
    jp, tp = _params(groups, **over)
    batch = _batch(tc, 2, 16, seed=10 + groups)
    jg = jax.jit(jax.grad(lambda p: jfwd.lm_loss(p, jc, _jb(batch))))(jp)
    _, tg = steps.value_and_grad(tp, tc, _tb(batch))
    assert tree_paths(tg) == tree_paths(jg)
    for g, w in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        _close(g, w, 1e-4)
    _, tg_plain = steps.value_and_grad(
        tp, dataclasses.replace(tc, remat_blocks=False), _tb(batch))
    for a, b in zip(tree_leaves(tg), tree_leaves(tg_plain)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# decode (text only) and serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [0, 4])
def test_decode_step_matches_reference(groups):
    """8 text tokens, with and without Fed2: logits and every cache leaf
    of both stacks after every token; the kernel routes (the wrappers'
    plain versions on the CPU) equal the plain routes."""
    jc, tc = _configs(groups)
    jp, tp = _params(groups)
    bs, n = 3, 8
    jcache = jfwd.init_cache(jc, bs, 16)
    tcache = fwd.init_cache(tc, bs, 16)
    plain = fwd.init_cache(tc, bs, 16)
    assert tree_paths(tcache) == tree_paths(jcache)
    step = jax.jit(lambda p, c, t, pos: jfwd.decode_step(p, jc, c, t, pos))
    toks = np.random.default_rng(4).integers(0, jc.vocab, size=(bs, n))
    for t in range(n):
        tok = torch.as_tensor(toks[:, t:t + 1])
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1],
                                                  jnp.int32), jnp.int32(t))
        tl, tcache = fwd.decode_step(tp, tc, tcache, tok, t)
        pl, plain = fwd.decode_step(tp, tc, plain, tok, t, use_kernel=False)
        assert tl.shape == (bs, 1, jc.vocab)
        _close(tl, jl)
        np.testing.assert_allclose(tl.numpy(), pl.numpy(), rtol=1e-6,
                                   atol=1e-6)
        for path, w, g in zip(tree_paths(tcache),
                              jax.tree_util.tree_leaves(jcache),
                              tree_leaves(tcache)):
            if path[-1] == "slot_pos":
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                _close(g, w)


def _jax_serve(jc, jp, *, batch, prompt_len, gen, seed):
    """The reference's serve loop (``repro.launch.serve.main``), greedy,
    without its host mesh: text only. The tokens and each decoded step's
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


def test_serve_cli_serves_internvl_on_the_cpu(capsys):
    out = serve.main(["--device", "cpu", "--arch", ARCH, "--prompt-len",
                      "3", "--gen", "2", "--fed2-groups", "4"])
    assert out["tokens"].shape == (4, 2)
    assert out["logits"].shape == (4, 1, 512)
    assert bool(torch.isfinite(out["logits"]).all())
    assert "arch=internvl2-2b-reduced prefill 3 tok" in \
        capsys.readouterr().out
    cfg = serve.config_of(serve.parse_args(["--arch", ARCH, "--full",
                                            "--fed2-groups", "8"]))
    assert (cfg.arch_id, cfg.fed2_groups, cfg.fed2_decouple,
            cfg.tie_embeddings) == (ARCH, 8, 6, False)


# ---------------------------------------------------------------------------
# the train step, and the entry points that refuse the family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_reference(microbatches):
    """3 AdamW steps (lr 3e-4, weight decay 0.1, fp32 state, grads cast
    to bf16) on the reduced Fed2 InternVL, the batch's patch embeddings
    split with it into microbatches."""
    lr, n_steps = 3e-4, 3
    over = dict(loss_chunk=8, attn_q_chunk=8, attn_kv_chunk=16)
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


def test_token_only_entry_points_refuse_internvl():
    """The reference fails where a token batch (the LM CLI's, lm_task's)
    meets InternVL: its ``lm_loss`` and ``lm_task``'s eval assert the
    missing patch embeddings. The port refuses up front, naming the family:
    ``--mode lm`` before drawing any weight, and ``lm_task``."""
    jc, tc = _configs()
    jp, _ = _params()
    toks = np.random.default_rng(50).integers(0, jc.vocab, size=(2, 9))
    jbatch = jax_lm_batch(toks)
    assert "embeds" not in jbatch
    with pytest.raises(AssertionError):
        jfwd.lm_loss(jp, jc, jbatch)
    with pytest.raises(AssertionError):
        jrt.lm_task(jc).eval_fn(jp, jbatch)
    with pytest.raises(ValueError, match="'vlm' family"):
        train.main(["--mode", "lm", "--arch", ARCH, "--reduced",
                    "--device", "cpu", "--steps", "1"])
    with pytest.raises(ValueError, match="'vlm' family"):
        rt.lm_task(tc)
    with pytest.raises(ValueError, match="frontend's embeds"):
        fwd.forward(_params()[1], tc, torch.as_tensor(toks))
