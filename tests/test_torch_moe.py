"""The port's MoE FFN (``models.moe``), its one-shard expert-parallel
schedule (``models.moe_ep``) and DeepSeek-V2's multi-head latent
attention (``models.attention``'s MLA) against the JAX package, on the
CPU, from the same numpy inputs and the same weights (the reference's
inits, converted by ``convert.lm_to_port``), at the MoE widths of the
reduced configs (``mixtral-8x22b``: 4 experts top-2, renormalized;
``deepseek-v2-236b``: 4 experts top-2 and a shared expert, not
renormalized) in fp32.

Tolerances (fp32), as max |got - want| <= tol * max |want|:
- router weights, aux losses and every module output (``moe_apply``
  with and without drops, chunked and in decode, the dense oracle,
  ``moe_apply_ep``, ``mla_apply``, ``mla_decode`` and its cache): 1e-5
  (matmuls and einsums summed in other orders);
- the routing itself (expert ids, which pairs drop): equal;
- gradients, per leaf: 1e-4 of the leaf's largest gradient (backward
  sums in other orders);
- ``mla_decode`` token by token against ``mla_apply``: 1e-5 (the
  absorbed and the expanded attention are one function).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import moe_ep as jmoe_ep
from repro_torch.convert import lm_to_port
from repro_torch.models import attention, moe, moe_ep
from repro_torch.models.module import tree_leaves, tree_unflatten

# the reduced configs' MoE widths (configs/<arch>.reduced().moe)
MOE = {"mixtral-8x22b": dict(d_model=256, d_ff_expert=512, n_experts=4,
                             top_k=2),
       "deepseek-v2-236b": dict(d_model=256, d_ff_expert=256, n_experts=4,
                                top_k=2, n_shared=1, d_ff_shared=256,
                                router_norm_topk=False)}
ARCHS = tuple(MOE)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, tol=1e-5):
    """max |got - want| <= tol * max |want|."""
    got = _np(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    got, want = got.astype(np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (err, scale)


def _cfgs(arch, **over):
    """(reference, port) MoEConfig of ``arch``'s reduced widths."""
    kw = {**MOE[arch], **over}
    return jmoe.MoEConfig(**kw), moe.MoEConfig(**kw)


_INIT = {}


def _params(arch):
    """The reference's ``moe_init`` at PRNGKey(0) as numpy, and the
    port's conversion of it; cached."""
    if arch not in _INIT:
        jc, _ = _cfgs(arch)
        jp = jax.tree_util.tree_map(np.asarray,
                                    jmoe.moe_init(jax.random.PRNGKey(0), jc))
        _INIT[arch] = (jp, lm_to_port(jp))
    return _INIT[arch]


def _x(b, s, seed, d=256, skew=3.0):
    """(b, s, d) seeded normals plus ``skew`` times one shared normal
    vector: the router logits share an offset, so some experts draw
    more tokens than others (and overflow their capacity)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, d))
            + skew * rng.normal(size=(d,))).astype(np.float32)


def _dropped(jc, jp, x, capacity=None):
    """How many (token, expert) pairs the reference's moe_apply drops on
    x (its own routing and capacity rule, recomputed in numpy)."""
    b, s, d = x.shape
    n = b * s
    logits = x.reshape(n, d) @ jp["router"]["w"]
    _, ids, _ = jmoe.route(jnp.asarray(logits), jc)
    if capacity is None:
        capacity = n * jc.top_k if s == 1 else max(
            1, int(jc.capacity_factor * jc.top_k * n / jc.n_experts))
    counts = np.bincount(np.asarray(ids).ravel(), minlength=jc.n_experts)
    return int(np.maximum(counts - capacity, 0).sum())


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    """fp32 softmax, top-k, (no) renormalization and the Switch aux
    loss on seeded logits."""
    jc, tc = _cfgs(arch)
    logits = np.random.default_rng(1).normal(size=(48, 4)).astype(
        np.float32)
    jw, jids, jaux = jmoe.route(jnp.asarray(logits), jc)
    tw, tids, taux = moe.route(torch.as_tensor(logits), tc)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(tw, jw)
    _close(taux, jaux)
    assert tw.dtype == torch.float32 and taux.shape == ()


def test_route_breaks_bf16_ties_to_the_lower_expert():
    """Planted ties in bf16 router logits over 8 experts (top-3): equal
    probabilities go to the lower expert index first, as
    ``jax.lax.top_k`` orders them, weights and aux equal the
    reference's."""
    jc, tc = (c(d_model=8, d_ff_expert=8, n_experts=8, top_k=3)
              for c in (jmoe.MoEConfig, moe.MoEConfig))
    rows = np.array([[0.5, 2.0, 2.0, 0.0, 2.0, -1.0, 2.0, 0.25],
                     [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
                     [-3.0, 0.5, 0.5, 0.5, 3.0, 3.0, 0.0, 0.0],
                     [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5]], np.float32)
    want = np.array([[1, 2, 4], [0, 1, 2], [4, 5, 1], [7, 0, 1]])
    jl = jnp.asarray(rows, jnp.bfloat16)
    tl = torch.as_tensor(rows).to(torch.bfloat16)
    jw, jids, jaux = jmoe.route(jl, jc)
    tw, tids, taux = moe.route(tl, tc)
    np.testing.assert_array_equal(np.asarray(jids), want)
    np.testing.assert_array_equal(tids.numpy(), want)
    _close(tw, jw)
    _close(taux, jaux)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [1.25, 16.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, cf):
    """B 3 x S 20: at the default capacity factor pairs drop (capacity
    int(1.25 * 2 * 60 / 4) = 37 per expert; the skewed routing
    overfills some expert), at 16 none do. Output and aux equal the
    reference's."""
    jc, tc = _cfgs(arch, capacity_factor=cf)
    jp, tp = _params(arch)
    x = _x(3, 20, seed=2)
    drops = _dropped(jc, jp, x)
    assert (drops > 0) == (cf < 2), drops
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jc)
    ty, taux = moe.moe_apply(tp, torch.as_tensor(x), tc)
    _close(ty, jy)
    _close(taux, jaux)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_decode_is_drop_free(arch):
    """S = 1 (decode): capacity n * k, no drop whatever the routing,
    equal to the reference and to the dense oracle."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch)
    x = _x(16, 1, seed=3)
    assert _dropped(jc, jp, x) == 0
    assert _dropped(jc, jp, x, capacity=max(
        1, int(jc.capacity_factor * jc.top_k * 16 / jc.n_experts))) > 0
    jy, _ = jmoe.moe_apply(jp, jnp.asarray(x), jc)
    ty, _ = moe.moe_apply(tp, torch.as_tensor(x), tc)
    _close(ty, jy)
    dense, _ = moe.moe_apply_dense_reference(tp, torch.as_tensor(x), tc)
    _close(ty, _np(dense))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_chunked_matches_reference(arch):
    """50 tokens in chunks of 16: 4 chunks, the last padded with 14 zero
    tokens, which route and take capacity there; the aux is the mean of
    the chunks'. Drops happen at the default factor."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch)
    x = _x(2, 25, seed=4)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jc, chunk_tokens=16)
    ty, taux = moe.moe_apply(tp, torch.as_tensor(x), tc, chunk_tokens=16)
    _close(ty, jy)
    _close(taux, jaux)
    whole, _ = moe.moe_apply(tp, torch.as_tensor(x), tc)
    assert np.abs(_np(whole) - _np(ty)).max() > 1e-3   # chunks drop apart


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_dense_reference_matches_reference(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch)
    x = _x(2, 12, seed=5)
    jy, jaux = jmoe.moe_apply_dense_reference(jp, jnp.asarray(x), jc)
    ty, taux = moe.moe_apply_dense_reference(tp, torch.as_tensor(x), tc)
    _close(ty, jy)
    _close(taux, jaux)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_equals_dense_oracle_without_drops(arch):
    """The reference's own property: at capacity factor 16 nothing drops
    and the sort-based dispatch equals every-expert-on-every-token."""
    _, tc = _cfgs(arch, capacity_factor=16.0)
    _, tp = _params(arch)
    x = torch.as_tensor(_x(2, 16, seed=6))
    y, aux = moe.moe_apply(tp, x, tc)
    yd, auxd = moe.moe_apply_dense_reference(tp, x, tc)
    _close(y, _np(yd))
    assert float(aux) == float(auxd)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradient_matches_jax(arch):
    """The gradient of a weighted sum of moe_apply's output plus its aux
    with respect to every MoE leaf and the input, drops included,
    against ``jax.grad``."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch)
    rng = np.random.default_rng(7)
    x = _x(2, 16, seed=8)
    w = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, x, jc)
        return (y * w).sum() + aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    tx = torch.as_tensor(x).requires_grad_(True)
    y, aux = moe.moe_apply(tree_unflatten(tp, leaves), tx, tc)
    grads = torch.autograd.grad((y * torch.as_tensor(w)).sum() + aux,
                                leaves + [tx])
    for g, want in zip(grads, jax.tree_util.tree_leaves(jg) + [jgx]):
        _close(g, want, 1e-4)


def test_moe_dispatch_batches_under_vmap_grad():
    """The round engine's ``vmap(grad(...))`` over 3 clients' inputs
    (drops included) equals each client's own gradient."""
    arch = "deepseek-v2-236b"
    _, tc = _cfgs(arch)
    _, tp = _params(arch)
    xs = torch.as_tensor(np.stack([_x(2, 12, seed=10 + i) for i in range(3)]))
    names = ("router", "w_gate", "w_down")

    def loss(p, x):
        y, aux = moe.moe_apply({**tp, **p}, x, tc)
        return y.square().sum() + aux

    sub = {k: tp[k] for k in names}
    batched = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(
        sub, xs)
    for i in range(3):
        one = torch.func.grad(loss)(sub, xs[i])
        for a, b in zip(tree_leaves(batched), tree_leaves(one)):
            _close(a[i], _np(b), 1e-6)


# ---------------------------------------------------------------------------
# moe_apply_ep at one shard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [None, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_ep_matches_reference_at_one_shard(arch, cf):
    """Against the reference's shard_map on ``jax.make_mesh((1, 1))``:
    at the default factor 1.25 its capacity int(1.25 * k * n) holds all
    n * k pairs, so nothing drops and both equal the dense oracle; at
    0.5 only the first half of the pairs in token order survive,
    whatever their expert, unlike ``moe_apply``'s per-expert drops."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch)
    x = _x(2, 10, seed=11)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jy, jaux = jax.jit(lambda p, x: jmoe_ep.moe_apply_ep(
        p, x, jc, mesh, capacity_factor=cf))(jp, jnp.asarray(x))
    ty, taux = moe_ep.moe_apply_ep(tp, torch.as_tensor(x), tc,
                                   capacity_factor=cf)
    _close(ty, jy)
    _close(taux, jaux)
    dense, _ = moe.moe_apply_dense_reference(tp, torch.as_tensor(x), tc)
    off = np.abs(_np(ty) - _np(dense)).max(axis=-1).reshape(-1)
    if cf is None:
        assert off.max() <= 1e-5 * np.abs(_np(dense)).max()
    else:
        # the first 10 tokens keep both pairs, the last 10 lose both
        assert (off[:10] <= 1e-4).all() and (off[10:] > 1e-3).all()
        shared = moe.swiglu(tp["shared"], torch.as_tensor(x[1])) \
            if "shared" in tp else torch.zeros(10, 256)
        _close(ty[1], _np(shared))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _perturbed(tree, rng):
    """Every RMSNorm ``scale`` drawn 1 + 0.3 N(0, 1) (they start at 1,
    which would hide a norm applied in the wrong place)."""
    return {k: ({"scale": (1.0 + 0.3 * rng.normal(size=v["scale"].shape))
                 .astype(np.float32)} if k.endswith("_norm")
                else v) for k, v in tree.items()}


def _mla():
    """The reduced deepseek's MLA (d 256, 4 heads, the MLAConfig
    defaults: kv_lora 512, q_lora 1536, nope 128, rope 64, v 128) and
    its reference init with perturbed norm scales, (reference, port)."""
    jc = jattn.MLAConfig(d_model=256, n_heads=4)
    tc = attention.MLAConfig(**dataclasses.asdict(jc))
    jp = jax.tree_util.tree_map(np.asarray, jattn.mla_init(
        jax.random.PRNGKey(3), jc))
    jp = _perturbed(jp, np.random.default_rng(12))
    return jc, tc, jp, lm_to_port(jp)


def test_mla_apply_matches_reference():
    """40 positions over q chunks of 16 and kv chunks of 24."""
    jc, tc, jp, tp = _mla()
    x = _x(2, 40, seed=13)
    want = jax.jit(lambda p, x: jattn.mla_apply(
        p, x, jc, q_chunk=16, kv_chunk=24))(jp, jnp.asarray(x))
    got = attention.mla_apply(tp, torch.as_tensor(x), tc, q_chunk=16,
                              kv_chunk=24)
    _close(got, want)


def test_mla_gradient_matches_jax():
    jc, tc, jp, tp = _mla()
    x = _x(2, 24, seed=14)
    w = np.random.default_rng(15).normal(size=x.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p: (jattn.mla_apply(
        p, jnp.asarray(x), jc, q_chunk=8, kv_chunk=16) * w).sum()))(jp)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    y = attention.mla_apply(tree_unflatten(tp, leaves), torch.as_tensor(x),
                            tc, q_chunk=8, kv_chunk=16)
    grads = torch.autograd.grad((y * torch.as_tensor(w)).sum(), leaves)
    for g, want in zip(grads, jax.tree_util.tree_leaves(jg)):
        _close(g, want, 1e-4)


def test_mla_decode_matches_reference():
    """10 absorbed decode steps into a 12-slot latent cache: each
    step's output and the whole cache (c_kv, k_rope, slot_pos), updated
    in place, equal the reference's; the 10 outputs equal mla_apply
    over the 10 tokens (the expanded route)."""
    jc, tc, jp, tp = _mla()
    n = 10
    x = _x(3, n, seed=16)
    jcache = jattn.mla_cache_init(jc, 3, 12, jnp.float32)
    tcache = attention.mla_cache_init(tc, 3, 12, torch.float32)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    outs = []
    for t in range(n):
        jy, jcache = jattn.mla_decode(jp, jnp.asarray(x[:, t:t + 1]), jcache,
                                      jc, pos=jnp.int32(t))
        ty, same = attention.mla_decode(tp, torch.as_tensor(x[:, t:t + 1]),
                                        tcache, tc, pos=t)
        assert same is tcache
        _close(ty, jy)
        for key in ("c_kv", "k_rope"):
            _close(tcache[key], jcache[key])
        np.testing.assert_array_equal(tcache["slot_pos"].numpy(),
                                      np.asarray(jcache["slot_pos"]))
        outs.append(ty)
    full = attention.mla_apply(tp, torch.as_tensor(x), tc)
    _close(torch.cat(outs, 1), _np(full))


def test_mla_decode_past_the_cache_raises():
    """At pos = max_len the port raises, as gqa_decode without a window
    does; the reference's dynamic_update_slice clamps the write to the
    last slot instead (overwriting position max_len - 1 there)."""
    jc, tc, jp, tp = _mla()
    x = _x(1, 3, seed=17)
    jcache = jattn.mla_cache_init(jc, 1, 2, jnp.float32)
    tcache = attention.mla_cache_init(tc, 1, 2, torch.float32)
    for t in range(2):
        jy, jcache = jattn.mla_decode(jp, jnp.asarray(x[:, t:t + 1]), jcache,
                                      jc, pos=jnp.int32(t))
        ty, _ = attention.mla_decode(tp, torch.as_tensor(x[:, t:t + 1]),
                                     tcache, tc, pos=t)
        _close(ty, jy)
    _, jcache = jattn.mla_decode(jp, jnp.asarray(x[:, 2:3]), jcache, jc,
                                 pos=jnp.int32(2))
    assert np.asarray(jcache["slot_pos"]).tolist() == [0, 2]
    before = {k: v.clone() for k, v in tcache.items()}
    with pytest.raises(ValueError, match="outside the cache"):
        attention.mla_decode(tp, torch.as_tensor(x[:, 2:3]), tcache, tc,
                             pos=2)
    for k, v in tcache.items():
        assert torch.equal(v, before[k])
