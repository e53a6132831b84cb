"""The round's feature axes on a params tree that mixes dtypes: model
poisoning, robust fusion, the uplink codecs, the bf16 local phase (both
local routes), buffered async and the ``mmap`` client-state store, each
through ``run_federated(lm_task)`` on the reduced Fed2 Mamba-2 at bf16
(fp32 ``a_log``, ``dt_bias``, ``d_skip``) against the JAX package, which
keeps every leaf in its own dtype (limits in tests/mixed_lm_fl.py). The
port works segment by segment, one cohort buffer per dtype.

- ``gauss_noise``: the reference folds jax keys per (round, slot, leaf),
  which torch cannot draw, so its draws are injected through
  ``GaussNoise.leaf_noise`` (tests/test_torch_attacks.py does the same
  on a flat buffer).
- ``int8`` and ``topk``: the reference decodes every delta in fp32 and
  its new global holds every leaf in fp32 (its round 2 then fails in the
  forward's scan). The port computes the same round and rounds each leaf
  back into its dtype, so one round is held against the reference's
  global cast back to the init's dtypes. ``topk`` keeps each client's k
  largest |delta| of a leaf; the two packages' deltas differ by the
  round-off of the bf16 forward, so a coordinate at a client's k-th
  largest |delta| may be kept by one and dropped by the other. Such a
  coordinate moves the fused leaf by at most its |delta| / N, each
  client's at most (1 + 10 %) of its k-th largest, so a leaf's limit
  gains (1 + FP32_UPDATE_RTOL) times the largest k-th |delta| over the
  port's clients (recorded from its encode). On the same deltas the two
  packages' codecs agree to the bit (``test_mixed_roundtrip_matches_
  reference``).
- On a small tree of bf16 and fp32 leaves the port's codec round trip
  and model poisoning of its per-dtype buffers equal the reference's
  per-leaf result to the bit.
- ``identity`` is exact: the run equals the run without a codec to the
  bit. Async at zero latency with ``buffer_k`` = the cohort equals the
  port's own sync run to the bit.

Also: the chunked sort of the reducing rules equals one whole sort to
the bit, at a chunk that does not divide the columns, with ties.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import mixed_lm_fl as mx
from repro.fl import attacks as jattacks
from repro.fl import codec as jcodec
from repro_torch.convert import lm_to_port
from repro_torch.fl import attacks as tattacks
from repro_torch.fl import codec as tcodec
from repro_torch.fl import robust as trobust
from repro_torch.models.module import FlatLayout, key_path, tree_leaves


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# axis -> (method, FLConfig knobs, run_federated keywords, rounds)
AXES = {
    "sign_flip": ("fedavg", dict(attack="sign_flip(2.0)",
                                 attack_fraction=1), {}, 1),
    "gauss_noise": ("fedavg", dict(attack="gauss_noise(0.01)",
                                   attack_fraction=1), {}, 1),
    "coordinate_median": ("fed2", dict(robust="coordinate_median"), {}, 1),
    "trimmed_mean": ("fed2", dict(robust="trimmed_mean(0.25)"), {}, 1),
    "norm_clip": ("fed2", dict(robust="norm_clip(1.0)"), {}, 1),
    "codec_identity": ("fedavg", dict(codec="identity"), {}, 1),
    "codec_int8": ("fedavg", dict(codec="int8"), {}, 1),
    "codec_topk": ("fedavg", dict(codec="topk(0.1)"), {}, 1),
    "bf16_plain": ("fed2", dict(compute_dtype="bfloat16"), {}, 1),
    "bf16_local_kernel": ("fed2", dict(compute_dtype="bfloat16"),
                          dict(use_local_kernel=True), 1),
    "async": ("fedavg", dict(mode="async", buffer_k=2), {}, 2),
    "mmap": ("fedavg", dict(store="mmap", chunk_size=2), {}, 2),
}
PROMOTING = ("codec_int8", "codec_topk")


def _init():
    return lm_to_port(mx.jax_init())


def _cast_back(tree):
    """The reference's tree with every leaf cast to the init's dtype."""
    return jax.tree_util.tree_map(
        lambda p, i: np.asarray(p).astype(i.dtype), tree, mx.jax_init())


def _reference_noise(monkeypatch):
    """The port's gauss_noise draws replaced by the reference's: leaf i
    of cohort slot c in round r from fold_in(fold_in(fold_in(
    PRNGKey(stream), r), c), i), in the leaf's dtype."""
    leaves = jax.tree_util.tree_leaves(mx.jax_init())

    def leaf_noise(self, key, slot, leaf, size, device):
        stream, r = key
        k = jax.random.fold_in(jax.random.PRNGKey(stream), r)
        k = jax.random.fold_in(jax.random.fold_in(k, slot), leaf)
        eps = jax.random.normal(k, leaves[leaf].shape, leaves[leaf].dtype)
        assert eps.size == size
        return torch.tensor(np.asarray(eps, np.float32).reshape(-1),
                            device=device)
    monkeypatch.setattr(tattacks.GaussNoise, "leaf_noise", leaf_noise)


def _runs(axis):
    method, fl, kw, rounds = AXES[axis]
    want = mx.jax_run(method, rounds, **kw, **fl)
    got = mx.port_run(method, rounds, fl_kw=fl, **kw)
    return want, got


def _topk_thresholds(monkeypatch) -> dict:
    """{leaf path: the largest over clients of the k-th largest |delta|
    the port's topk keeps}, filled as the port's run encodes."""
    seen, real = {}, tcodec.TopKCodec.encode

    def encode(self, deltas, layout):
        out = real(self, deltas, layout)
        for s, e in zip(layout.slots, out):
            kth = e["vals"].abs().min(dim=1).values.max().item()
            seen[key_path(s.path)] = max(seen.get(key_path(s.path), 0.0),
                                         kth)
        return out
    monkeypatch.setattr(tcodec.TopKCodec, "encode", encode)
    return seen


@pytest.mark.parametrize("axis", sorted(AXES))
def test_mixed_axis_matches_reference(axis, monkeypatch):
    """Each axis the reference runs on the mixed tree: every port leaf in
    its init's dtype, fp32 leaves within 10 % of their update, bf16
    leaves within 2^-7 of the reference (its global cast back to the
    init's dtypes under int8 and topk; topk's selection allowance
    above)."""
    if axis == "gauss_noise":
        _reference_noise(monkeypatch)
    kth = _topk_thresholds(monkeypatch) if axis == "codec_topk" else {}
    want, got = _runs(axis)
    init = _init()
    final = want["final_params"]
    if axis in PROMOTING:
        final = _cast_back(final)
    mx.assert_parity(got["final_params"], final, like=init,
                     extra={p: (1 + mx.FP32_UPDATE_RTOL) * t
                            for p, t in kth.items()})
    assert len(got["acc"]) == AXES[axis][3]


def _mixed_tree(rng, lead=()):
    """A small tree of bf16 and fp32 leaves (numpy: bf16 as
    ml_dtypes')."""
    bf16 = ml_dtypes.bfloat16
    return {"a": rng.normal(size=lead + (3, 5)).astype(bf16),
            "b": rng.normal(size=lead + (4,)).astype(np.float32),
            "c": rng.normal(size=lead + (6,)).astype(bf16),
            "d": rng.normal(size=lead + (2, 2)).astype(np.float32)}


@pytest.mark.parametrize("spec", ["identity", "int8", "topk(0.25)",
                                  "sign_flip(2)", "scaled_update(3)"])
def test_mixed_roundtrip_matches_reference(spec):
    """On the same client deltas of a tree of bf16 and fp32 leaves, the
    port's codec round trip and model poisoning of its per-dtype
    buffers equal the reference's per-leaf result to the bit, each leaf
    in its dtype (the reference's codec result cast back: it decodes in
    fp32)."""
    rng = np.random.default_rng(3)
    n = 4
    glob = _mixed_tree(rng)
    stacked = jax.tree_util.tree_map(
        lambda g, d: (g.astype(np.float32)[None]
                      + 0.1 * d.astype(np.float32)).astype(g.dtype),
        glob, _mixed_tree(rng, (n,)))
    layout = FlatLayout(lm_to_port(glob))
    flat, gflat = (layout.flatten(lm_to_port(stacked)),
                   layout.flatten(lm_to_port(glob)))
    if spec.startswith(("sign", "scaled")):
        mal = np.array([0, 1, 0, 1], np.float32)
        jatk = jattacks.parse_attack(spec).build()
        want = jax.vmap(jatk.poison_update, in_axes=(0, None, 0, 0))(
            stacked, glob, mal, jnp.zeros((n, 2), jnp.uint32))
        got = tattacks.parse_attack(spec).build().poison_update(
            flat, gflat, mal, None, layout)
    else:
        want = jcodec.parse_codec(spec).roundtrip(stacked, glob)
        got = tcodec.parse_codec(spec).roundtrip(flat, gflat, layout)
    assert [p.dtype for p in got] == [torch.bfloat16, torch.float32]
    want = jax.tree_util.tree_map(lambda w, g: np.asarray(w).astype(g.dtype),
                                  want, glob)
    for a, b in zip(tree_leaves(layout.unflatten(got)),
                    jax.tree_util.tree_leaves(want), strict=True):
        assert torch.equal(a, lm_to_port(b))


@pytest.mark.parametrize("axis", PROMOTING)
def test_reference_lossy_codecs_promote_bf16_leaves(axis):
    """The reference caveat the int8 and topk cases work around: its new
    global holds every leaf in fp32, the port's each in its init's
    dtype."""
    want, got = _runs(axis)
    assert {str(a.dtype) for a in
            jax.tree_util.tree_leaves(want["final_params"])} == {"float32"}
    assert [a.dtype for a in tree_leaves(got["final_params"])] == \
        [a.dtype for a in tree_leaves(_init())]


def _equal(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b),
                               strict=True))


def test_mixed_identity_codec_is_bit_exact():
    """The identity codec ships the dense rows: two rounds equal the run
    without a codec to the bit."""
    a = mx.port_run("fedavg", 2, fl_kw=dict(codec="identity"))
    b = mx.port_run("fedavg", 2)
    assert _equal(a["final_params"], b["final_params"])


def test_mixed_async_degenerates_to_sync_bit_exactly():
    """buffer_k = the cohort, zero latency, constant staleness: every
    dispatch wave is one sync cohort, so two events equal two sync
    rounds to the bit, each event fusing each dtype segment of its
    (K, M_d) buffers."""
    a = mx.port_run("fedavg", 2, fl_kw=dict(mode="async",
                                            buffer_k=mx.N_CLIENTS))
    b = mx.port_run("fedavg", 2)
    assert _equal(a["final_params"], b["final_params"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule", ["coordinate_median", "trimmed_mean(0.25)"])
def test_chunked_robust_sort_is_bit_exact(rule, dtype, monkeypatch):
    """The reducing rules sort ``robust.SORT_CHUNK`` columns at a time:
    at a chunk of 7 columns (which does not divide 103) the result
    equals one sort over all of them to the bit, with ties between
    clients (values drawn from a few levels) and in the input's
    dtype."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.integers(-3, 4, size=(5, 103)) / 4.0
                     + rng.normal(size=(5, 103)) * (rng.random((5, 103))
                                                    < 0.3),
                     dtype=torch.float32).to(dtype)
    w = torch.tensor([0.3, 0.1, 0.2, 0.25, 0.15])
    reduce = trobust.parse_robust(rule).reduce
    whole = reduce(x, w)
    monkeypatch.setattr(trobust, "SORT_CHUNK", 7)
    chunked = reduce(x, w)
    assert chunked.dtype == dtype and chunked.shape == (103,)
    assert torch.equal(chunked, whole)
    assert torch.equal(reduce(x.reshape(5, 103, 1), w),
                       whole.reshape(103, 1))
    # ties really happen: some column holds equal values
    xs = torch.sort(x.float(), dim=0).values
    assert bool((xs[1:] == xs[:-1]).any())
