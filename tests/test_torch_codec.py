"""The port's uplink codecs (``repro_torch.fl.codec``) against the
reference's (``repro.fl.codec``), on the same seeded cohort of the
reduced Fed2 VGG9 (the reference's init, perturbed per client, and its
conversion to the port's flat (C, M) buffer).

- int8: equal q and equal scales per leaf and per client; the decoded
  round trip is equal to the bit (the same fp32 operations, against the
  reference's functions as written: under ``jax.jit`` XLA may compute
  ``amax / 127`` as a product with the reciprocal, one ulp away).
- topk on tie-free data: the same support and values (the decoded
  deltas are equal to the bit). Ties: the port keeps the lower flat
  index, as ``jax.lax.top_k`` does; on a shared leaf (same flat order
  in both packages) the two agree, on a conv weight (OIHW against HWIO)
  a tie at the k-th place is the one place they may keep different
  coordinates.
- ``bytes_per_client`` is equal for every codec.
- A lossy codec under a reducing robust rule is refused, and an
  identity-codec run is bit-identical to a run without a codec.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vgg9 as jvgg9
from repro.fl import codec as jcodec
from repro.fl import runtime as jruntime
from repro_torch import convert
from repro_torch.configs import vgg9 as tvgg9
from repro_torch.fl import codec as tcodec
from repro_torch.fl import runtime as truntime
from repro_torch.fl import scenarios as tscen
from repro_torch.models.module import FlatLayout

N = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cohort():
    """(reference stacked tree, reference global, port layout, port
    (N, M) buffer, port global (M,))."""
    jcfg = jvgg9.reduced()
    glob = jax.tree_util.tree_map(
        np.asarray, jruntime.cnn_task(jcfg).init_fn(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    clients = [jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        glob) for _ in range(N)]
    jstack = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *clients)
    tp = convert.to_port(glob)
    layout = FlatLayout(tp)
    flat = torch.stack([layout.flatten(convert.to_port(c))
                        for c in clients])
    return jstack, glob, layout, flat, layout.flatten(tp)


def _ref_leaves(layout, rows):
    """The port's (N, M) rows as the reference's stacked leaves (HWIO
    conv weights), in the reference's leaf order."""
    trees = [convert.to_reference(layout.unflatten(r)) for r in rows]
    return [np.stack(xs) for xs in zip(*[jax.tree_util.tree_leaves(t)
                                         for t in trees])]


def _deltas(jstack, glob):
    return jax.tree_util.tree_map(lambda y, x: jnp.asarray(y - x[None]),
                                  jstack, glob)


def test_int8_q_and_scales_equal_reference(cohort):
    jstack, glob, layout, flat, gflat = cohort
    enc_t = tcodec.get("int8").encode(flat - gflat[None], layout)
    enc_j = jcodec.get("int8").encode(_deltas(jstack, glob))
    jl = jax.tree_util.tree_leaves(
        enc_j, is_leaf=lambda x: isinstance(x, dict) and "q" in x)
    # q and the scale spread over their leaf, as (N, M) rows
    q = torch.cat([e["q"] for e in enc_t], 1)
    sc = torch.cat([e["scale"].expand(-1, e["q"].shape[1]) for e in enc_t],
                   1)
    for got_q, got_s, want in zip(_ref_leaves(layout, q.float()),
                                  _ref_leaves(layout, sc), jl):
        np.testing.assert_array_equal(got_q, np.asarray(want["q"]))
        np.testing.assert_array_equal(
            got_s.reshape(N, -1)[:, 0],
            np.asarray(want["scale"]).reshape(N))
    assert all(e["q"].dtype == torch.int8 for e in enc_t)


@pytest.mark.parametrize("spec", ["int8", "topk(0.05)", "topk(0.3)",
                                  "identity"])
def test_roundtrip_equals_reference(cohort, spec):
    jstack, glob, layout, flat, gflat = cohort
    got = tcodec.parse_codec(spec).roundtrip(flat, gflat, layout)
    roundtrip = jcodec.parse_codec(spec).roundtrip
    if spec.startswith("topk"):
        # jit only where it changes no bits: XLA may turn int8's division
        # by 127 into a product with its reciprocal (one ulp of a scale)
        roundtrip = jax.jit(roundtrip)
    want = roundtrip(jax.tree_util.tree_map(jnp.asarray, jstack), glob)
    if spec == "identity":
        assert got is flat                   # untouched
    for a, b in zip(_ref_leaves(layout, got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_topk_ties_keep_the_lower_flat_index():
    """A shared leaf (same flat order in both packages): |d| ties at the
    k-th place keep the lower indices in both. A 4-D conv weight: the
    port keeps the lower index of ITS flat (OIHW) order."""
    bias = np.array([[0.5, -2.0, 1.0, 1.0, -1.0, 0.1, 1.0, 0.2]],
                    np.float32)
    tree = {"b": torch.tensor(bias[0])}
    layout = FlatLayout(tree)
    codec = tcodec.get("topk", 0.3)           # k = ceil(0.3 * 8) = 3
    enc = codec.encode(torch.tensor(bias), layout)
    assert enc[0]["idx"].tolist() == [[1, 2, 3]]
    want = jcodec.get("topk", 0.3).encode({"b": jnp.asarray(bias)})
    assert np.asarray(want["b"]["idx"]).tolist() == [[1, 2, 3]]
    w = torch.ones(1, 2, 2, 2)                # OIHW, every |d| tied
    layout = FlatLayout({"w": w})
    enc = tcodec.get("topk", 0.25).encode(w.reshape(1, -1), layout)
    assert enc[0]["idx"].tolist() == [[0, 1]]


def test_bytes_per_client_equals_reference():
    for jcfg, tcfg in ((jvgg9.full(fed2_groups=8), tvgg9.full(fed2_groups=8)),
                       (jvgg9.baseline(), tvgg9.baseline())):
        jp = jax.eval_shape(jruntime.cnn_task(jcfg).init_fn,
                            jax.random.PRNGKey(0))
        tp = truntime.cnn_task(tcfg).init_fn(torch.Generator().manual_seed(0))
        for spec in ("identity", "int8", "topk(0.05)", "topk(1)"):
            assert (tcodec.parse_codec(spec).bytes_per_client(tp)
                    == jcodec.parse_codec(spec).bytes_per_client(jp)), spec


@pytest.mark.parametrize("spec", ["zip", "topk(0)", "topk(1.5)", "int8(",
                                  "topk(x)"])
def test_parse_errors_match_reference(spec):
    def msg(fn):
        try:
            fn(spec)
        except ValueError as e:
            return str(e)
    got = msg(tcodec.parse_codec)
    assert got is not None and got == msg(jcodec.parse_codec)


@pytest.mark.parametrize("codec", ["int8", "topk(0.05)"])
def test_lossy_codec_under_a_reducing_rule_is_refused(codec):
    kw = dict(population=3, rounds=1, method="fedavg",
              robust="coordinate_median", codec=codec)
    with pytest.raises(ValueError, match="refuses lossy codec") as t:
        truntime.FLConfig(**kw)
    with pytest.raises(ValueError) as j:
        jruntime.FLConfig(**kw)
    assert str(t.value) == str(j.value)
    truntime.FLConfig(**{**kw, "codec": "identity"})
    truntime.FLConfig(**{**kw, "robust": "norm_clip(1)"})


def test_identity_codec_run_is_bit_identical():
    spec = tscen.get("nxc2_fed2").override(
        rounds=1, train_size=240, test_size=80, steps_per_epoch=3,
        batch_size=8)
    ds, test = spec.datasets()
    parts = spec.partition(ds.labels)
    task = truntime.cnn_task(spec.model_config())
    init = task.init_fn(torch.Generator().manual_seed(0))
    finals = []
    for codec in (None, "identity"):
        h = truntime.run_federated(
            task, dataclasses.replace(spec.fl_config(), codec=codec), parts,
            lambda s: {"images": ds.images[s], "labels": ds.labels[s]},
            [{"images": test.images, "labels": test.labels}],
            device="cpu", init_params=init)
        finals.append(FlatLayout(init).flatten(h["final_params"]))
    assert torch.equal(finals[0], finals[1])
