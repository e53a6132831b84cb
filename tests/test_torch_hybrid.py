"""The port's hybrid family (``zamba2-2.7b``: Mamba-2 blocks and ONE
shared attention block applied after every ``hybrid_attn_every`` of
them) against the JAX package, on the CPU, from the same numpy inputs
and the same weights (the reference's ``init_params``, converted by
``convert.lm_to_port``). The model is the reduced config (d 256, fp32)
at its own 2 layers (1 super-block of 2) and at 4 layers (2
super-blocks: two applications of the shared block, two KV caches),
plain and under ``with_fed2(groups=4)`` (no decoupled blocks for a
hybrid; the block-diagonal unembedding).

Every norm scale (the shared block's ln1 and ln2, the SSM blocks' ln1
and mixer norms, the final norm) is first set to seeded values 1 + 0.3
N(0, 1), the same in both packages, so that a norm applied to the wrong
tensor shows.

Tolerances (fp32), as max |got - want| <= tol * max |want|:
- ``lm_loss`` (rtol), ``decode_step`` (logits and every cache leaf: SSM
  states, conv windows, the shared block's KV caches) and the chunked
  forward against token-by-token decode: 1e-5, as in
  tests/test_torch_dense.py and tests/test_torch_lm_train.py;
- ``forward``'s hidden state over 80 positions: 2e-5. The SSD's chunk
  of 64 sums 64-term products in another order than the reference's
  einsums: one Mamba-2 block's output differs by up to 4e-6 of its
  largest value (measured block by block on these inputs; the shared
  attention block by 4e-7), and four of them in series, then the final
  norm, by up to 1.5e-5;
- gradients, per leaf: 1e-4 of the leaf's largest gradient;
- one ``lm_task`` round: final params within rtol = atol = 1e-5 and the
  accuracy within one position, as tests/test_torch_lm_fl.py holds the
  Mamba-2 round;
- greedy serve tokens equal wherever the reference's top-2 logit gap
  exceeds 1e-4.

The reference's hybrid forward attends over the whole sequence, while
its decode windows each shared application at ``min(max_len, 4096)``:
the two agree within ``max_len`` positions (tested here) and differ by
design past it (ROADMAP, Queue 3).
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
                                       tree_map, tree_paths)

ARCH = "zamba2-2.7b"
GAP = 1e-4
# the reference's param_count(jax.eval_shape(init_params)) of the full
# config, plain and under with_fed2(groups=8)
FULL_PARAMS = {0: 2_422_670_240, 8: 2_350_990_240}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(groups=0, layers=2, reduced=True, **over):
    """(reference config, port config) of zamba2; ``layers`` of the
    reduced config (2: one super-block, 4: two), ``groups`` applies
    with_fed2."""
    jc = jax_get_config(ARCH, reduced=reduced)
    tc = get_config(ARCH, reduced=reduced)
    if reduced:
        over = {"n_layers": layers, **over}
    if groups:
        jc = jax_with_fed2(jc, groups=groups)
        tc = with_fed2(tc, groups=groups)
    return dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)


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


def _params(groups=0, layers=2):
    """The reference's reduced init (``init_params`` at PRNGKey(0),
    jitted) as numpy with its norm scales perturbed, and the port's
    conversion of it; cached."""
    if (groups, layers) not in _INIT:
        jc, _ = _configs(groups, layers)
        jp = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k: jtfm.init_params(k, jc))(jax.random.PRNGKey(0)))
        jp = _perturbed(jp, np.random.default_rng(1))
        _INIT[groups, layers] = (jp, lm_to_port(jp))
    return _INIT[groups, layers]


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
# configs, init and conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("groups", [0, 8])
def test_config_matches_reference(groups, reduced):
    jc, tc = _configs(groups, reduced=reduced)
    assert ARCH in PORT_ARCHS and ARCH in train.LM_ARCHS
    for f in ("arch_id", "family", "n_layers", "d_model", "vocab", "d_ff",
              "n_heads", "n_kv_heads", "head_dim", "norm", "act",
              "rope_theta", "rotary_pct", "qkv_bias", "qk_norm", "window",
              "use_rope", "fed2_groups", "fed2_decouple", "padded_vocab",
              "loss_chunk", "attn_q_chunk", "attn_kv_chunk", "remat_blocks",
              "tie_embeddings", "hybrid_attn_every"):
        assert getattr(tc, f) == getattr(jc, f), f
    for f in ("d_model", "d_state", "headdim", "expand", "conv_kernel",
              "chunk", "d_inner", "n_heads", "conv_dim"):
        assert getattr(tc.ssm, f) == getattr(jc.ssm, f), f
    assert tc.fed2_decouple == 0
    assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name


@pytest.mark.parametrize("groups", [0, 8])
def test_full_config_sizes(groups):
    """The reference's parameter count of the full config (its
    ``jax.eval_shape``) equals the pinned constant the card's serve
    phase checks, and the port's init of the full config (on
    ``meta``) has it leaf for leaf: 54 SSM blocks with 80 heads of 64
    and a state of 64, one shared block, and under Fed2 8 the (8, 320,
    4000) unembedding."""
    jc, tc = _configs(groups, reduced=False)
    want = jax.eval_shape(lambda k: jtfm.init_params(k, jc),
                          jax.random.PRNGKey(0))
    assert jax_param_count(want) == FULL_PARAMS[groups]
    got = tfm.init_params(torch.Generator(), tc, device="meta")
    assert param_count(got) == FULL_PARAMS[groups]
    for w, g in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        assert tuple(w.shape) == tuple(g.shape)
        assert jnp.dtype(w.dtype).name == str(g.dtype).split(".")[-1]
    assert tuple(got["blocks"]["mixer"]["a_log"].shape) == (54, 80)
    assert tc.ssm.n_heads == 80 and tc.n_layers // tc.hybrid_attn_every == 9
    if groups:
        assert tuple(got["unembed"]["w"].shape) == (8, 320, 4000)


@pytest.mark.parametrize("groups", [0, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_reference(groups, dtype):
    """Same leaves (``blocks`` of SSM blocks, one ``shared_attn``),
    shapes, per-leaf dtypes (a_log, dt_bias and d_skip fp32 in a bf16
    model) and parameter count."""
    jc, tc = _configs(groups, 4)
    jc = dataclasses.replace(jc, dtype=getattr(jnp, dtype))
    tc = dataclasses.replace(tc, dtype=getattr(torch, dtype))
    want = jax.eval_shape(lambda k: jtfm.init_params(k, jc),
                          jax.random.PRNGKey(0))
    got = tfm.init_params(torch.Generator().manual_seed(0), tc)
    assert sorted(got) == ["blocks", "embed", "final_norm", "shared_attn",
                           "unembed"]
    assert tree_paths(got) == tree_paths(
        jax.tree_util.tree_map(lambda s: 0, want))
    for w, g in zip(jax.tree_util.tree_leaves(want),
                    tree_leaves(lm_to_reference(got))):
        assert w.shape == g.shape and jnp.dtype(w.dtype) == g.dtype
    assert param_count(got) == jax_param_count(want)
    assert got["blocks"]["mixer"]["w_z"]["w"].shape[0] == 4
    assert got["shared_attn"]["attn"]["wq"]["w"].dim() == 2


def test_lm_to_port_round_trip_carries_shared_attn():
    jp, tp = _params(4, 4)
    back = lm_to_reference(tp)
    assert tree_paths(back) == tree_paths(jp)
    for a, b in zip(tree_leaves(back), tree_leaves(jp)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tp["shared_attn"]["ffn"]["w_down"]["w"].numpy(),
        jp["shared_attn"]["ffn"]["w_down"]["w"])


@pytest.mark.parametrize("groups", [0, 4])
def test_lm_group_axes_match_reference(groups):
    """``lm_group_axes`` on the zamba2 trees: ``shared_attn`` and every
    SSM leaf shared, the unembedding grouped on its leading axis under
    Fed2; the port's marks on its own init equal the reference's on
    its."""
    jc, tc = _configs(groups, 4)
    jp, _ = _params(groups, 4)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jfusion.lm_group_axes(jp, jc),
        is_leaf=lambda x: x is None or isinstance(x, jfusion.GroupAxis))
    want = {"/".join(str(k) for k in p):
            None if a is None else (a.axis, a.n_groups) for p, a in flat}
    got = fusion.lm_group_axes(
        tfm.init_params(torch.Generator().manual_seed(0), tc), tc)
    have = {}
    for p in tree_paths(got):
        a = got
        for k in p:
            a = a[k]
        have[key_path(p)] = None if a is None else (a.axis, a.n_groups)
    assert have == want
    marked = sorted(k for k, v in have.items() if v is not None)
    assert marked == (["['unembed']/['w']"] if groups else [])
    assert any(k.startswith("['shared_attn']") for k in have)


def test_hybrid_layers_must_fill_super_blocks():
    _, tc = _configs(0, 3)
    with pytest.raises(ValueError, match="super-blocks"):
        tfm.init_params(torch.Generator().manual_seed(0), tc)
    with pytest.raises(NotImplementedError, match="decoupled"):
        tfm.init_params(torch.Generator().manual_seed(0),
                        dataclasses.replace(_configs(4, 4)[1],
                                            fed2_decouple=1))


# ---------------------------------------------------------------------------
# forward, lm_loss and its gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layers", [2, 4])
@pytest.mark.parametrize("groups", [0, 4])
def test_forward_and_lm_loss_match_reference(groups, layers):
    """S = 80 (two SSD chunks of 64, the second padded) over attention
    chunks of 16 x 24 and loss chunks of 24, with a mask; the eval
    step's kernel route (plain versions on the CPU) gives the same
    loss."""
    over = dict(loss_chunk=24, attn_q_chunk=16, attn_kv_chunk=24)
    jc, tc = _configs(groups, layers, **over)
    jp, tp = _params(groups, layers)
    batch = _batch(tc.vocab, 2, 80, seed=groups + layers)
    jh, _ = jax.jit(lambda p, t: jfwd.forward(p, jc, t))(
        jp, jnp.asarray(batch["tokens"]))
    th, taux = fwd.forward(tp, tc, torch.as_tensor(batch["tokens"]))
    assert th.shape == (2, 80, tc.d_model) and float(taux) == 0.0
    _close(th, jh, 2e-5)
    jl = jax.jit(lambda p, b: jfwd.lm_loss(p, jc, b))(jp, _jb(batch))
    tl = fwd.lm_loss(tp, tc, _tb(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(
        float(steps.make_eval_step(tc)(tp, _tb(batch))), float(tl),
        rtol=1e-6)


def test_forward_applies_the_shared_block_once_per_super_block():
    """Four layers are two super-blocks: the forward equals SSM blocks
    0-1, the shared block, SSM blocks 2-3, the shared block, built by
    hand from the port's block functions."""
    _, tc = _configs(0, 4)
    _, tp = _params(0, 4)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, tc.vocab, size=(2, 16)))
    pos = torch.arange(16)
    with torch.no_grad():
        x = tp["embed"]["table"][toks]
        for j in range(4):
            lp = tree_map(lambda t: t[j], tp["blocks"])
            x, _ = tfm.block_apply(lp, x, tc, kind="ssm")
            if j % 2:
                x, _ = tfm.block_apply(tp["shared_attn"], x, tc,
                                       kind="attn_ffn", positions=pos)
        want = tfm._norm_apply(tc, tp["final_norm"], x)
        got, _ = fwd.forward(tp, tc, toks)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("groups", [0, 4])
def test_lm_loss_grad_matches_jax(groups):
    """Plain autograd (block, shared-block and SSD-chunk remat on) at 2
    super-blocks against ``jax.grad``, per leaf: the shared block's
    gradient sums its two applications."""
    over = dict(loss_chunk=24, attn_q_chunk=16, attn_kv_chunk=16)
    jc, tc = _configs(groups, 4, **over)
    jp, tp = _params(groups, 4)
    batch = _batch(tc.vocab, 2, 40, seed=10 + groups)
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
# decode and serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layers", [2, 4])
@pytest.mark.parametrize("groups", [0, 4])
def test_decode_step_matches_reference(groups, layers):
    """10 tokens into a cache of max_len 6, so each shared application's
    ring buffer (window min(6, 4096) = 6) wraps, as the reference's
    does: logits and every cache leaf (SSM states, conv windows, every
    super-block's own KV cache) after every token."""
    jc, tc = _configs(groups, layers)
    jp, tp = _params(groups, layers)
    bs, n, max_len = 3, 10, 6
    jcache = jfwd.init_cache(jc, bs, max_len)
    tcache = fwd.init_cache(tc, bs, max_len)
    assert sorted(tcache) == sorted(jcache) == ["blocks", "shared"]
    assert tuple(tcache["shared"]["k"].shape) == \
        tuple(jcache["shared"]["k"].shape) == (layers // 2, bs, max_len, 4,
                                               64)
    step = jax.jit(lambda p, c, t, pos: jfwd.decode_step(p, jc, c, t, pos))
    toks = np.random.default_rng(4).integers(0, jc.vocab, size=(bs, n))
    for t in range(n):
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1],
                                                  jnp.int32), jnp.int32(t))
        tl, same = fwd.decode_step(tp, tc, tcache,
                                   torch.as_tensor(toks[:, t:t + 1]), t)
        assert same is tcache and tl.shape == (bs, 1, jc.vocab)
        _close(tl, jl)
        for key in ("ssm", "conv"):
            _close(tcache["blocks"][key], jcache["blocks"][key])
        for key in ("k", "v"):
            _close(tcache["shared"][key], jcache["shared"][key])
        np.testing.assert_array_equal(tcache["shared"]["slot_pos"].numpy(),
                                      np.asarray(jcache["shared"]["slot_pos"]))
    assert tcache["shared"]["slot_pos"][0].tolist() == [6, 7, 8, 9, 4, 5]
    if layers == 4:
        # one KV cache per application of the one shared block
        k = tcache["shared"]["k"]
        assert (k[0] - k[1]).abs().max() > 1e-3


@pytest.mark.parametrize("groups", [0, 4])
def test_decode_kernel_routes_equal_plain_routes_on_cpu(groups):
    """On CPU tensors the ssd_update and grouped_matmul wrappers take
    their plain versions, which compute what the model's plain routes
    compute."""
    _, tc = _configs(groups, 4)
    _, tp = _params(groups, 4)
    caches = [fwd.init_cache(tc, 2, 8) for _ in range(2)]
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, tc.vocab, size=(2, 4)))
    for t in range(4):
        a, _ = fwd.decode_step(tp, tc, caches[0], toks[:, t:t + 1], t)
        b, _ = fwd.decode_step(tp, tc, caches[1], toks[:, t:t + 1], t,
                               use_kernel=False)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("layers", [2, 4])
def test_chunked_forward_equals_token_by_token_decode(layers):
    """Within max_len (here 40 positions, three SSD chunks of 16 and
    attention chunks of 8), the chunked forward and token-by-token
    decode give the same logits at every position."""
    ssm = dataclasses.replace(get_config(ARCH, reduced=True).ssm, chunk=16)
    _, tc = _configs(4, layers, attn_q_chunk=8, attn_kv_chunk=8, ssm=ssm)
    _, tp = _params(4, layers)
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, tc.vocab, size=(2, 40)))
    with torch.no_grad():
        want = tfm.unembed_apply(tp["unembed"], fwd.forward(tp, tc, toks)[0],
                                 tc)
        cache = fwd.init_cache(tc, 2, 40)
        got = torch.cat([fwd.decode_step(tp, tc, cache, toks[:, t:t + 1],
                                         t)[0] for t in range(40)], 1)
    _close(got, want)


def _jax_serve(jc, jp, *, batch, prompt_len, gen, seed):
    """The reference's serve loop, greedy, without its host mesh: the
    tokens and each decoded step's logits."""
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


def test_run_serve_greedy_tokens_match_reference():
    jc, tc = _configs(4, 4)
    jp, tp = _params(4, 4)
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
# LM federation and the CLIs
# ---------------------------------------------------------------------------


SEQ, N_CLIENTS = 16, 4


def test_lm_task_round_matches_reference():
    """One fed2 round of run_federated(lm_task) on the reduced Fed2
    zamba2 at 2 super-blocks (4 clients, one token domain each, 2 local
    momentum-SGD steps of 4): final params and accuracy as
    tests/test_torch_lm_fl.py holds the Mamba-2 round."""
    jc, tc = _configs(4, 4)
    jp, _ = _params(4, 4)
    toks, domains = make_token_dataset(120, SEQ + 1, tc.vocab,
                                       n_domains=N_CLIENTS, seed=0)
    test, _ = make_token_dataset(16, SEQ + 1, tc.vocab, n_domains=N_CLIENTS,
                                 seed=7)
    parts = [np.flatnonzero(domains == j) for j in range(N_CLIENTS)]

    def get_batch(sel):
        sl = toks[sel]
        return {"tokens": sl[:, :-1], "labels": sl[:, 1:],
                "mask": np.ones((len(sel), SEQ), np.float32)}

    tests = [{"tokens": test[:, :-1], "labels": test[:, 1:],
              "mask": np.ones((len(test), SEQ), np.float32)}]
    fl = dict(population=N_CLIENTS, rounds=1, local_epochs=1,
              steps_per_epoch=2, batch_size=4, lr=0.01, momentum=0.9,
              method="fed2", seed=0, eval_batch=16)
    task = dataclasses.replace(jrt.lm_task(jc), init_fn=lambda k: jp)
    want = jrt.run_federated(
        task, jrt.FLConfig(**fl), parts,
        lambda sel: {k: jnp.asarray(v) for k, v in get_batch(sel).items()},
        tests)
    got = rt.run_federated(rt.lm_task(tc), rt.FLConfig(**fl), parts,
                           get_batch, tests, device="cpu",
                           init_params=lm_to_port(jp))
    np.testing.assert_allclose(got["acc"], want["acc"], atol=1.0 / (16 * SEQ))
    assert "shared_attn" in got["final_params"]
    for a, b in zip(tree_leaves(got["final_params"]),
                    jax.tree_util.tree_leaves(want["final_params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_lm_cli_trains_the_hybrid_on_the_cpu(capsys):
    out = train.main(["--mode", "lm", "--arch", ARCH, "--reduced",
                      "--device", "cpu", "--fed2", "--fed2-groups", "4",
                      "--steps", "2", "--batch", "2", "--seq", "16",
                      "--lr", "1e-3"])
    assert len(out["loss"]) == 2 and np.isfinite(out["loss"]).all()
    assert "shared_attn" in out["final_params"]
    assert "step     1 loss" in capsys.readouterr().out


def test_serve_cli_serves_the_hybrid_on_the_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--device", "cpu", "--prompt-len",
                      "3", "--gen", "2", "--fed2-groups", "4"])
    assert out["tokens"].shape == (4, 2)
    assert bool(torch.isfinite(out["logits"]).all())
    assert f"arch={ARCH}-reduced prefill 3 tok" in capsys.readouterr().out
    cfg = serve.config_of(serve.parse_args(["--arch", ARCH, "--full",
                                            "--fed2-groups", "8"]))
    assert (cfg.arch_id, cfg.fed2_groups, cfg.fed2_decouple,
            cfg.hybrid_attn_every) == (ARCH, 8, 0, 6)
