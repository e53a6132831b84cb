"""The port's Mamba-2 LM training path (``repro_torch.models.{layers,ssm,
transformer,forward}``, ``optim/optimizers.py``, ``data/synthetic.py``,
``launch/steps.py`` and ``launch/train.py --mode lm``) against the JAX
package, on the CPU, from the same numpy inputs and the same weights
(the reference's ``init_params``, converted by ``convert.lm_to_port``).

Tolerances (fp32 unless said):
- the depthwise conv: rtol = atol = 1e-5; ``ssd_chunked`` (output and
  final state, L not a multiple of the chunk), the recurrence against
  it, and one ``mamba2_apply`` layer: max |d| <= 1e-5 * max |ref|, sums
  of up to q terms in another order (the chunk's einsums as two-operand
  contractions), whose cancellation leaves small entries with the
  round-off of the large ones; the layer against L decode steps: 1e-4
  * max |ref|, the recurrence's and the decode conv's own sum order
  carried through the gated norm and the out projection;
- ``forward``'s hidden state: rtol = atol = 1e-4, the same round-off
  through two layers, scaled by the final RMSNorm's 1/rms; ``lm_loss``
  rtol 1e-5;
- gradients: per leaf, max |d| <= 1e-4 * max |g_ref| (backward sums run
  in other orders again);
- ``adamw`` on bf16 params with fp32 state: m and v rtol 1e-6 (one fp32
  rounding per operation on equal inputs); the update u = mh /
  (sqrt(vh) + eps) has eps = 1e-8 as the floor of its denominator, so
  its fp32 round-off is a few ulps of |u| <= |mh| / eps wherever vh
  underflows and of |u| <= ~1 elsewhere: lr * 1e-5 in all, below half
  a bf16 ulp of the params here, so the bf16 params agree to one bf16
  ulp (a rounding tie may fall either way);
- the train step: losses rtol 1e-5 over 3 steps. Params: AdamW's first
  steps move a coordinate by about lr * sign(g), so a gradient that is
  round-off (|g| within 1e-5 of its leaf's max, or one bf16 rounding
  of the cast grads) may flip its step: every coordinate within 2 * lr
  * steps, and at least 99 % within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.configs import get_config as jax_get_config
from repro.configs.common import with_fed2 as jax_with_fed2
from repro.data import synthetic as jsynth
from repro.launch import steps as jsteps
from repro.models import forward as jfwd
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config
from repro_torch.configs.common import with_fed2
from repro_torch.convert import lm_to_port, lm_to_reference
from repro_torch.data import synthetic
from repro_torch.launch import steps, train
from repro_torch.models import forward as fwd
from repro_torch.models import layers, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.module import (FlatLayout, tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.optim import optimizers

ARCH = "mamba2-1.3b"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(groups=0, **over):
    """(reference config, port config) of the reduced mamba2-1.3b, with
    Fed2's unembedding over ``groups`` and field overrides on both."""
    jc = jax_get_config(ARCH, reduced=True)
    tc = get_config(ARCH, reduced=True)
    if groups:
        jc, tc = jax_with_fed2(jc, groups=groups), with_fed2(tc,
                                                             groups=groups)
    return dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)


_INIT = {}


def _params(groups):
    """The reference's reduced Fed2 init (``init_params`` at PRNGKey(0),
    jitted) as numpy, and the port's conversion of it. ``groups=0``
    swaps in a dense (d, V) unembedding drawn from numpy (one init
    serves both trees)."""
    if not _INIT:
        jc, _ = _configs(4)
        _INIT[4] = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k: jtfm.init_params(k, jc))(jax.random.PRNGKey(0)))
        w = np.random.default_rng(0).normal(size=(jc.d_model, jc.vocab))
        _INIT[0] = {**_INIT[4], "unembed": {
            "w": (w / np.sqrt(jc.d_model)).astype(np.float32)}}
    return _INIT[groups], lm_to_port(_INIT[groups])


def _batch(vocab, b, s, seed, masked=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(b, s + 1))
    mask = ((rng.random((b, s)) > 0.2) if masked
            else np.ones((b, s))).astype(np.float32)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32), "mask": mask}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, tol=1e-5):
    """max |got - want| <= tol * max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (err, scale)


def _ssd_inputs(bs, l, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bs, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(bs, l, h)) - 1)).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    b = (0.5 * rng.normal(size=(bs, l, n))).astype(np.float32)
    c = (0.5 * rng.normal(size=(bs, l, n))).astype(np.float32)
    d = rng.normal(size=h).astype(np.float32)
    return x, dt, a_log, b, c, d


# ---------------------------------------------------------------------------
# layers and the SSD scan
# ---------------------------------------------------------------------------


def test_conv1d_depthwise_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 1, 12)).astype(np.float32)
    b = rng.normal(size=12).astype(np.float32)
    got = layers.conv1d_depthwise_apply(
        {"w": torch.tensor(w), "b": torch.tensor(b)}, torch.tensor(x))
    want = jlayers.conv1d_depthwise_apply(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("l,chunk", [(80, 64), (50, 256), (128, 32)])
def test_ssd_chunked_matches_reference(l, chunk):
    """Output and final state, L a multiple of the chunk or not (the
    reference right-pads to a multiple of min(chunk, L))."""
    ins = _ssd_inputs(2, l, 4, 8, 16, seed=l)
    jy, js = jssm.ssd_chunked(*map(jnp.asarray, ins), chunk=chunk)
    ty, ts = ssm.ssd_chunked(*map(torch.as_tensor, ins), chunk=chunk)
    assert ty.shape == (2, l, 4, 8) and ts.shape == (2, 4, 8, 16)
    _close(ty.numpy(), jy)
    _close(ts.numpy(), js)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssd_chunked_matches_the_recurrence(use_kernel):
    """L steps of the port's own recurrence (``ssd_step``, or the
    ``ssd_update`` wrapper, whose CPU route is its plain version) reach
    the chunked scan's outputs and state."""
    from repro_torch.kernels.ssd_update import ssd_update
    x, dt, a_log, b, c, d = map(torch.as_tensor,
                                _ssd_inputs(2, 80, 4, 8, 16, seed=1))
    y, state = ssm.ssd_chunked(x, dt, a_log, b, c, d, chunk=32)
    h = torch.zeros(2, 4, 8, 16)
    step = ssd_update if use_kernel else ssm.ssd_step
    ys = []
    for t in range(80):
        h, yt = step(h, *(v[:, t].contiguous() for v in (x, dt)), a_log,
                     b[:, t].contiguous(), c[:, t].contiguous(), d)
        ys.append(yt)
    _close(torch.stack(ys, 1).numpy(), y.numpy())
    _close(h.numpy(), state.numpy())


def test_ssd_chunked_gradient_is_finite_at_a_strong_decay():
    """The pairwise decay is masked in log space before exp: with a
    decay strong enough that exp of the upper triangle overflows, the
    backward pass stays finite (exp(logdec) * triangle would give
    inf * 0 = NaN)."""
    x, dt, a_log, b, c, d = (torch.as_tensor(a) for a in
                             _ssd_inputs(1, 64, 2, 4, 8, seed=2))
    dt = (dt * 50).requires_grad_(True)
    x = x.requires_grad_(True)
    y, _ = ssm.ssd_chunked(x, dt, a_log, b, c, d, chunk=64)
    y.sum().backward()
    assert torch.isfinite(dt.grad).all() and torch.isfinite(x.grad).all()


def _layer(tree, i):
    return tree_map(lambda t: t[i], tree)


def test_mamba2_apply_matches_reference_and_decode():
    """One layer of the reduced config at chunk 16: the full-sequence
    mixer against the reference's, and against L = 40 steps of
    ``mamba2_decode`` from a zeroed cache (every position, and the final
    SSM state)."""
    jc, tc = _configs()
    jc = dataclasses.replace(jc, ssm=dataclasses.replace(jc.ssm, chunk=16))
    tc = dataclasses.replace(tc, ssm=dataclasses.replace(tc.ssm, chunk=16))
    jp, tp = _params(0)
    jlayer = jax.tree_util.tree_map(lambda a: a[1], jp["blocks"]["mixer"])
    tlayer = _layer(tp["blocks"]["mixer"], 1)
    x = np.random.default_rng(3).normal(
        size=(2, 40, tc.d_model)).astype(np.float32)
    want = jssm.mamba2_apply(jlayer, jnp.asarray(x), jc.ssm)
    got, state = ssm.mamba2_apply(tlayer, torch.tensor(x), tc.ssm,
                                  with_state=True)
    _close(got.numpy(), want)
    cache = ssm.mamba2_cache_init(tc.ssm, 2, torch.float32)
    ys = []
    for t in range(x.shape[1]):
        y, cache = ssm.mamba2_decode(tlayer, torch.tensor(x[:, t:t + 1]),
                                     cache, tc.ssm)
        ys.append(y)
    _close(torch.cat(ys, 1).numpy(), got.numpy(), 1e-4)
    _close(cache["ssm"].numpy(), state.numpy())


# ---------------------------------------------------------------------------
# forward, lm_loss and its gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [0, 4])
def test_forward_and_lm_loss_match_reference(groups):
    """S = 40 over loss chunks of 24 (two chunks, the second padded),
    with a mask, with and without Fed2's grouped unembedding."""
    jc, tc = _configs(groups, loss_chunk=24)
    jp, tp = _params(groups)
    batch = _batch(tc.vocab, 3, 40, seed=groups)
    jh, _ = jfwd.forward(jp, jc, jnp.asarray(batch["tokens"]))
    th, taux = fwd.forward(tp, tc, torch.as_tensor(batch["tokens"]))
    assert th.shape == (3, 40, tc.d_model) and float(taux) == 0.0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)
    jl = jfwd.lm_loss(jp, jc, _jb(batch))
    tl = fwd.lm_loss(tp, tc, _tb(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    # the eval and prefill steps: the same loss on the kernel route (on
    # CPU tensors the grouped_matmul wrapper's plain version)
    for make in (steps.make_eval_step, steps.make_prefill_loss_step):
        np.testing.assert_allclose(float(make(tc)(tp, _tb(batch))),
                                   float(tl), rtol=1e-6)


def _grads_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        err = np.abs(_np(g) - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-12), err


@pytest.mark.parametrize("groups", [0, 4])
def test_lm_loss_grad_matches_jax(groups):
    """Plain autograd (remat on) against ``jax.grad``; the round
    engine's route (``torch.func.vmap(grad)`` over flat rows, no remat)
    and autograd without remat give the same numbers."""
    jc, tc = _configs(groups, loss_chunk=24)
    jp, tp = _params(groups)
    batch = _batch(tc.vocab, 2, 40, seed=10 + groups)
    jg = jax.jit(jax.grad(lambda p: jfwd.lm_loss(p, jc, _jb(batch))))(jp)
    _, tg = steps.value_and_grad(tp, tc, _tb(batch))
    _grads_close(tree_leaves(tg), jax.tree_util.tree_leaves(jg))
    # remat moves memory, not numbers
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


def test_remat_runs_on_the_plain_autograd_route_only(monkeypatch):
    """torch.utils.checkpoint wraps every block, every SSD chunk and
    every loss chunk when autograd records; never under no_grad or a
    torch.func transform (which refuses its saved-tensor hooks)."""
    import torch.utils.checkpoint as ckpt
    calls = []
    real = ckpt.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(ckpt, "checkpoint", counting)
    _, tc = _configs(4, loss_chunk=24)
    _, tp = _params(4)
    batch = _tb(_batch(tc.vocab, 2, 40, seed=3))
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
    fwd.lm_loss(tree_unflatten(tp, leaves), tc, batch)
    # the forward pass: 2 blocks + 2 x 1 SSD chunk (S = 40 < 64) + 2 loss
    # chunks (the backward's block recompute runs the chunks again)
    assert len(calls) == 6
    calls.clear()
    with torch.no_grad():
        fwd.lm_loss(tp, tc, batch)
    layout = FlatLayout(tp)
    torch.func.grad(lambda row: fwd.lm_loss(layout.unflatten(row), tc,
                                            batch))(layout.flatten(tp))
    assert calls == []
    fwd.lm_loss(tree_unflatten(tp, leaves),
                dataclasses.replace(tc, remat_blocks=False), batch)
    assert len(calls) == 4                  # the chunks only


def test_training_routes_never_take_the_unembedding_kernel():
    """The loss defaults to the einsum route (the kernel has no
    backward), and the unembedding gets its gradient."""
    from repro_torch.kernels import grouped_matmul as gm
    _, tc = _configs(4)
    _, tp = _params(4)
    before = gm.grouped_matmul.launches
    calls = []
    real = gm.grouped_matmul
    gm.grouped_matmul = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        _, g = steps.value_and_grad(tp, tc, _tb(_batch(tc.vocab, 2, 16, 4)))
        steps.make_eval_step(tc)(tp, _tb(_batch(tc.vocab, 2, 16, 4)))
    finally:
        gm.grouped_matmul = real
    assert len(calls) == 1                  # the eval step's one chunk
    assert gm.grouped_matmul.launches == before
    assert float(g["unembed"]["w"].abs().sum()) > 0


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def _tree_pair(seed, bf16=True):
    """A small params tree (bf16 weights, fp32 scalars per head) and
    gradients with entries from O(1) down to zero and eps scale."""
    rng = np.random.default_rng(seed)
    p = {"w": rng.normal(size=(6, 40)).astype(np.float32),
         "a_log": rng.normal(size=(5,)).astype(np.float32)}
    g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    g["w"][0] = 0.0
    g["w"][1] *= 1e-8
    dt = torch.bfloat16 if bf16 else torch.float32
    tp = {"w": torch.tensor(p["w"]).to(dt), "a_log": torch.tensor(p["a_log"])}
    jp = {"w": jnp.asarray(p["w"]).astype(jnp.bfloat16 if bf16
                                          else jnp.float32),
          "a_log": jnp.asarray(p["a_log"])}
    return jp, tp, g


def test_adamw_matches_reference_on_bf16_params_with_fp32_state():
    lr = optimizers.cosine_schedule(1e-2, total_steps=4, warmup_steps=1)
    jlr = jopt.cosine_schedule(1e-2, total_steps=4, warmup_steps=1)
    topt = optimizers.adamw(lr, weight_decay=0.1, state_dtype=torch.float32)
    jo = jopt.adamw(jlr, weight_decay=0.1, state_dtype=jnp.float32)
    jp, tp, _ = _tree_pair(0)
    js, ts = jo.init(jp), topt.init(tp)
    assert ts["m"]["w"].dtype == torch.float32
    for step in range(3):
        _, _, g = _tree_pair(100 + step)
        tg = {"w": torch.tensor(g["w"]).bfloat16(),
              "a_log": torch.tensor(g["a_log"])}
        jg = {"w": jnp.asarray(g["w"]).astype(jnp.bfloat16),
              "a_log": jnp.asarray(g["a_log"])}
        jp, js = jo.update(jg, js, jp, jnp.int32(step))
        tp, ts = topt.update(tg, ts, tp, step)
        for k in ("m", "v"):
            for leaf in ("w", "a_log"):
                np.testing.assert_allclose(ts[k][leaf].numpy(),
                                           np.asarray(js[k][leaf]),
                                           rtol=1e-6, atol=0)
        assert tp["w"].dtype == torch.bfloat16
        want = np.asarray(jp["w"], np.float32)
        ulp = np.abs(want) * 2.0 ** -8 + 1e-30
        assert (np.abs(_np(tp["w"]) - want) <= ulp).all()
        np.testing.assert_allclose(tp["a_log"].numpy(),
                                   np.asarray(jp["a_log"]), rtol=1e-6,
                                   atol=1e-2 * 1e-5)


def test_cosine_schedule_and_clip_match_reference():
    for kw in (dict(total_steps=10, warmup_steps=3),
               dict(total_steps=5, warmup_steps=0, min_frac=0.0)):
        t, j = (optimizers.cosine_schedule(3e-4, **kw),
                jopt.cosine_schedule(3e-4, **kw))
        for s in range(12):
            np.testing.assert_allclose(float(t(s)), float(j(s)),
                                       rtol=1e-6)
    jp, tp, g = _tree_pair(1, bf16=False)
    for max_norm in (0.5, 1e6):
        tg = {"w": torch.tensor(g["w"]).bfloat16(),
              "a_log": torch.tensor(g["a_log"])}
        jg = {"w": jnp.asarray(g["w"]).astype(jnp.bfloat16),
              "a_log": jnp.asarray(g["a_log"])}
        tc = optimizers.clip_by_global_norm(tg, max_norm)
        jc = jopt.clip_by_global_norm(jg, max_norm)
        assert tc["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(tc["w"]),
                                      np.asarray(jc["w"], np.float32))
        np.testing.assert_allclose(tc["a_log"].numpy(),
                                   np.asarray(jc["a_log"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(n_seqs=12, seq_len=17, vocab=512),
                                dict(n_seqs=9, seq_len=33, vocab=50280,
                                     n_domains=4, seed=7, in_domain_p=0.5)])
def test_make_token_dataset_equals_reference(kw):
    got = synthetic.make_token_dataset(**kw)
    want = jsynth.make_token_dataset(**kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    batch = synthetic.lm_batch_from_tokens(got[0], device="cpu")
    jb = jsynth.lm_batch_from_tokens(want[0])
    for k in ("tokens", "labels", "mask"):
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jb[k]))
    assert batch["tokens"].dtype == torch.long


# ---------------------------------------------------------------------------
# the train step and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_reference(microbatches):
    """3 AdamW steps (lr 3e-4, weight decay 0.1, fp32 state) on the
    reduced Fed2 model, grads cast to bf16 before the update; S = 24
    over loss chunks of 16."""
    lr, n_steps = 3e-4, 3
    jc, tc = _configs(4, loss_chunk=16)
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
    for a, b in zip(tree_leaves(ts["v"]), jax.tree_util.tree_leaves(js["v"])):
        assert a.dtype == torch.float32


def test_lm_cli_on_the_cpu(tmp_path, capsys):
    """``--mode lm --reduced --device cpu`` trains and checkpoints in the
    JAX package's format (the reference's loader reads it back)."""
    ck = tmp_path / "ck"
    out = train.main(["--mode", "lm", "--arch", ARCH, "--reduced",
                      "--device", "cpu", "--fed2", "--fed2-groups", "4",
                      "--steps", "3", "--batch", "4", "--seq", "16",
                      "--microbatches", "2", "--lr", "1e-3",
                      "--ckpt", str(ck)])
    assert len(out["loss"]) == 3 and np.isfinite(out["loss"]).all()
    assert out["tokens_per_step"] == 64
    text = capsys.readouterr().out
    assert "step     2 loss" in text and "checkpoint ->" in text
    jc, _ = _configs(4)
    like = jax.eval_shape(lambda k: jtfm.init_params(k, jc),
                          jax.random.PRNGKey(0))
    restored = jckpt.load_checkpoint(str(ck), like)
    assert jckpt.checkpoint_step(str(ck)) == 3
    for a, b in zip(tree_leaves(lm_to_reference(out["final_params"])),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("flags,message", [
    (["--scenario", "nxc2_fed2"], "--scenario is only supported"),
    (["--tiers", "1.0x2"], "--tiers is only supported"),
    (["--fed-mode", "async"], "--fed-mode/--buffer-k/--staleness/--latency"),
    (["--latency", "pareto(1.5)"], "--fed-mode/--buffer-k"),
    (["--attack", "sign_flip"], "--attack/--attack-fraction/--robust"),
    (["--robust", "coordinate_median"], "--attack/--attack-fraction"),
    (["--codec", "int8"], "--compute-dtype/--codec/--local-unroll/"),
    (["--use-local-kernel"], "--use-local-kernel are only supported"),
    (["--alignment", "pan"], "--alignment is only supported"),
    (["--arch", "vgg9"], "--mode lm takes --arch mamba2-1.3b"),
])
def test_lm_mode_refuses_fl_flags(flags, message, capsys):
    """The reference's refusals (its messages) of fl-only flags under
    --mode lm, before anything is built."""
    base = [] if "--arch" in flags else ["--arch", ARCH]
    with pytest.raises(SystemExit):
        train.parse_args(["--mode", "lm", *base, *flags])
    assert message in capsys.readouterr().err
    with pytest.raises(SystemExit):
        train.parse_args(["--mode", "fl", "--arch", ARCH])


def test_lm_mode_defaults():
    a = train.parse_args(["--mode", "lm", "--arch", ARCH])
    assert (a.steps, a.batch, a.seq, a.lr, a.microbatches, a.fed2,
            a.fed2_groups, a.ckpt, a.device) == \
        (100, 32, 128, 0.01, 1, False, 8, "", None)
    assert tfm.ModelConfig("x", "ssm", 1, 8, 8).loss_chunk == \
        jtfm.ModelConfig("x", "ssm", 1, 8, 8).loss_chunk
    assert tfm.ModelConfig("x", "ssm", 1, 8, 8).remat_blocks
    tied = dataclasses.replace(_configs()[1], tie_embeddings=True)
    tfm.check_ported(tied)
    assert "unembed" not in tfm.init_params(
        torch.Generator().manual_seed(0), tied)
