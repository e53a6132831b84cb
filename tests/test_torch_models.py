"""The port's CNN against the reference's on converted parameters:
logits, loss and every parameter gradient (``jax.grad(cnn_loss)``) for
the VGG9, VGG16 and MobileNet families, plus the conversion round trip,
the static topology, "SAME" padding at stride 2, the synthetic data,
both partitioners and the group map.

Tolerance: 1e-5 absolute (logits and losses are O(1), gradients
smaller): both sides compute in fp32 and differ only in summation order
inside convolutions and matmuls (measured below 2e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import mobilenet as jmobilenet
from repro.configs import vgg9 as jvgg9
from repro.configs import vgg16 as jvgg16
from repro.core import grouping as jgrouping
from repro.data import synthetic as jdata
from repro.fl import scenarios as jscen
from repro.models import cnn as jcnn
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch.configs import mobilenet as tmobilenet
from repro_torch.configs import vgg9 as tvgg9
from repro_torch.configs import vgg16 as tvgg16
from repro_torch.core import grouping as tgrouping
from repro_torch.data import synthetic as tdata
from repro_torch.fl import scenarios as tscen
from repro_torch.models import cnn as tcnn
from repro_torch.models import layers as tlayers
from repro_torch.models.module import (FlatLayout, param_count, tree_leaves,
                                       tree_map)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5

# benchmarks/flbench.py's MobileNet plan (stride-2 depthwise blocks at
# even inputs, where "SAME" pads only after the input)
BENCH_MBNET = dict(arch_id="mobilenet-bench",
                   plan=(("c", 24), ("dw", 48, 2), ("dw", 48, 1),
                         ("dw", 96, 2)),
                   fc_dims=(), n_classes=10, fed2_groups=5, decouple=2,
                   norm="gn")

CONFIGS = {
    "reduced_grouped": (jvgg9.reduced(), tvgg9.reduced(), 3),
    "reduced_plain": (jvgg9.reduced(fed2_groups=0, norm="none"),
                      tvgg9.reduced(fed2_groups=0, norm="none"), 3),
    "reduced_bn": (jvgg9.reduced(norm="bn"), tvgg9.reduced(norm="bn"), 3),
    "nxc2_fed2": (jscen.get("nxc2_fed2").model_config(),
                  tscen.get("nxc2_fed2").model_config(), 4),
    "nxc2_fedavg": (jscen.get("nxc2_fedavg").model_config(),
                    tscen.get("nxc2_fedavg").model_config(), 4),
    "vgg9_full_g8": (jvgg9.full(fed2_groups=8),
                     tvgg9.full(fed2_groups=8), 2),
    "reduced_pan": (jvgg9.reduced(fed2_groups=0, norm="none", pan=0.5),
                    tvgg9.reduced(fed2_groups=0, norm="none", pan=0.5), 3),
    "vgg16_reduced_grouped": (jvgg16.reduced(), tvgg16.reduced(), 3),
    "vgg16_reduced_plain": (jvgg16.reduced(fed2_groups=0, norm="none"),
                            tvgg16.reduced(fed2_groups=0, norm="none"), 3),
    "mobilenet_reduced_grouped": (jmobilenet.reduced(),
                                  tmobilenet.reduced(), 3),
    "mobilenet_reduced_plain": (
        jmobilenet.reduced(fed2_groups=0, norm="none"),
        tmobilenet.reduced(fed2_groups=0, norm="none"), 3),
    "mobilenet_bench_stride2": (jcnn.CNNConfig(**BENCH_MBNET),
                                tcnn.CNNConfig(**BENCH_MBNET), 3),
}

# full-width configurations, held for topology and init shapes only
TOPOLOGY = {**CONFIGS,
            "vgg16_full": (jvgg16.full(), tvgg16.full(), 0),
            "vgg16_full_g8": (jvgg16.full(fed2_groups=8),
                              tvgg16.full(fed2_groups=8), 0),
            "vgg16_baseline": (jvgg16.baseline(), tvgg16.baseline(), 0),
            "mobilenet_full": (jmobilenet.full(), tmobilenet.full(), 0),
            "mobilenet_baseline": (jmobilenet.baseline(),
                                   tmobilenet.baseline(), 0)}


_J_APPLY = jax.jit(jcnn.apply_cnn, static_argnums=1)
_J_LOSS_GRAD = jax.jit(jax.value_and_grad(jcnn.cnn_loss), static_argnums=1)
_J_ACC = jax.jit(jcnn.cnn_accuracy, static_argnums=1)


def _inputs(batch, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=batch).astype(np.int32)
    return x, y


def _jax_init(cfg, seed=0):
    p = jcnn.init_cnn(jax.random.PRNGKey(seed), cfg)
    return p, jax.tree_util.tree_map(np.asarray, p)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_loss_and_grads_match_reference(name):
    jcfg, tcfg, batch = CONFIGS[name]
    jp, pn = _jax_init(jcfg)
    x, y = _inputs(batch)
    jb = {"images": jnp.asarray(x), "labels": jnp.asarray(y)}
    tp = tree_map(lambda t: t.requires_grad_(True), convert.to_port(pn))
    tb = {"images": torch.tensor(x), "labels": torch.tensor(y)}

    np.testing.assert_allclose(
        tcnn.apply_cnn(tp, tcfg, tb["images"]).detach().numpy(),
        np.asarray(_J_APPLY(jp, jcfg, jb["images"])), atol=TOL)
    loss = tcnn.cnn_loss(tp, tcfg, tb)
    jloss, want = _J_LOSS_GRAD(jp, jcfg, jb)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=TOL)
    loss.backward()
    got = convert.to_reference(tree_map(lambda t: t.grad, tp))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), atol=TOL)
    np.testing.assert_allclose(
        float(tcnn.cnn_accuracy(tp, tcfg, tb)),
        float(_J_ACC(jp, jcfg, jb)), atol=0)


@pytest.mark.parametrize("name", sorted(TOPOLOGY))
def test_topology_and_init_shapes_match_reference(name):
    jcfg, tcfg, _ = TOPOLOGY[name]
    assert tcnn.layer_meta(tcfg) == [
        tcnn.LayerMeta(**dataclasses.asdict(m))
        for m in jcnn.layer_meta(jcfg)]
    assert tcfg.is_mobilenet == jcfg.is_mobilenet
    # the reference's init as shapes only (nothing is drawn)
    pn = jax.eval_shape(lambda: jcnn.init_cnn(jax.random.PRNGKey(0), jcfg))
    tp = tcnn.init_cnn(torch.Generator().manual_seed(0), tcfg)
    back = convert.to_reference(tp)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(pn))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(pn)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert param_count(tp) == sum(a.size for a in
                                  jax.tree_util.tree_leaves(pn))


@pytest.mark.parametrize("cfg,count", [(tvgg16.full(), 8_688_390),
                                       (tmobilenet.full(), 1_117_700)],
                         ids=["vgg16", "mobilenet"])
def test_full_width_parameter_counts(cfg, count):
    """The counts of the JAX package's vgg16.full() and mobilenet.full()
    at G=10."""
    assert param_count(tcnn.init_cnn(torch.Generator().manual_seed(0),
                                     cfg)) == count


def test_init_is_fan_in_normal_and_seeded():
    cfg = tvgg9.full(fed2_groups=8)
    a = tcnn.init_cnn(torch.Generator().manual_seed(3), cfg)
    b = tcnn.init_cnn(torch.Generator().manual_seed(3), cfg)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    w = a["convs"][1]["w"]                   # 32 -> 64, fan-in 288
    assert abs(float(w.std()) - 288 ** -0.5) < 0.05 * 288 ** -0.5
    assert not a["convs"][1]["b"].any()


def test_convert_round_trip_is_exact():
    _, pn = _jax_init(jvgg9.full(fed2_groups=8), seed=5)
    back = convert.to_reference(convert.to_port(pn))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(pn)):
        np.testing.assert_array_equal(a, b)
    tp = convert.to_port(pn)
    assert tp["convs"][3]["w"].shape == (128, 16, 3, 3)   # OIHW, g=8


def test_convert_round_trip_mobilenet():
    """Depthwise (3, 3, 1, c) and grouped pointwise (1, 1, c/G, o) HWIO
    leaves come back bit for bit; in the port they are OIHW."""
    jcfg, tcfg = jmobilenet.reduced(), tmobilenet.reduced()
    _, pn = _jax_init(jcfg, seed=4)
    tp = convert.to_port(pn)
    back = convert.to_reference(tp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(pn)):
        np.testing.assert_array_equal(a, b)
    assert tp["convs"][2]["dw"]["w"].shape == (40, 1, 3, 3)
    assert tp["convs"][2]["w"]["w"].shape == (40, 8, 1, 1)    # G=5
    assert sorted(tp["convs"][2]) == sorted(tcnn.init_cnn(
        torch.Generator().manual_seed(0), tcfg)["convs"][2])


@pytest.mark.parametrize("hw,k,stride,groups", [
    (32, 3, 2, 1), (16, 3, 2, 4), (5, 3, 2, 1), (7, 1, 2, 1),
    (8, 3, 1, 2), (9, 1, 1, 1)])
def test_conv2d_same_padding_matches_reference(hw, k, stride, groups):
    """XLA's "SAME": at stride 2 on an even input the pad is (0, 1), so
    a symmetric ``padding=k//2`` would shift every window. Tolerance
    1e-5 (fp32 sums in another order)."""
    rng = np.random.default_rng(hw * 10 + k)
    x = rng.normal(size=(2, hw, hw, 8)).astype(np.float32)
    w = rng.normal(size=(k, k, 8 // groups, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    want = jlayers.conv2d_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                jnp.asarray(x), stride=stride,
                                groups=groups)
    p = convert.to_port({"w": w, "b": b})
    got = tlayers.conv2d_apply(p, torch.tensor(x).permute(0, 3, 1, 2),
                               stride=stride, groups=groups)
    assert got.shape[-1] == -(-hw // stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=TOL)
    if stride == 1:        # unchanged: the symmetric pad of F.conv2d
        same = F.conv2d(torch.tensor(x).permute(0, 3, 1, 2), p["w"],
                        p["b"], padding=k // 2, groups=groups)
        assert torch.equal(got, same)


def test_same_padding_puts_the_odd_element_after():
    assert tlayers.same_padding(32, 3, 2) == (0, 1)
    assert tlayers.same_padding(5, 3, 2) == (1, 1)
    assert tlayers.same_padding(32, 3, 1) == (1, 1)
    assert tlayers.same_padding(8, 1, 2) == (0, 0)


def test_flat_layout_round_trip_and_views():
    tp = tcnn.init_cnn(torch.Generator().manual_seed(0), tvgg9.reduced())
    layout = FlatLayout(tp)
    assert layout.size == param_count(tp) and layout.stride % 64 == 0
    flat = layout.flatten(tp)
    assert flat.shape == (layout.size,)
    tree = layout.unflatten(flat)
    for a, b in zip(tree_leaves(tree), tree_leaves(tp)):
        assert torch.equal(a, b)
    tree["fcs"][0]["w"].fill_(2.0)               # views write through
    s = [s for s in layout.slots if s.path == ("fcs", 0, "w")][0]
    assert (flat[s.offset:s.offset + s.size] == 2.0).all()
    stacked = layout.alloc((3,))
    assert stacked.shape == (3, layout.size)
    assert stacked.stride(0) == layout.stride


@pytest.mark.parametrize("n,seed,noise", [(300, 0, 0.35), (120, 7, 1.2)])
def test_image_dataset_matches_reference(n, seed, noise):
    a = tdata.make_image_dataset(n, seed=seed, noise=noise)
    b = jdata.make_image_dataset(n, seed=seed, noise=noise)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("clients,cpn", [(6, 2), (10, 5), (4, 3)])
def test_nxc_partition_matches_reference(clients, cpn):
    labels = jdata.make_image_dataset(400, seed=1).labels
    got = tdata.nxc_partition(labels, clients, cpn, 10, seed=2)
    want = jdata.nxc_partition(labels, clients, cpn, 10, seed=2)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("clients,alpha,seed", [(6, 0.5, 2), (10, 0.1, 0),
                                               (4, 5.0, 7)])
def test_dirichlet_partition_matches_reference(clients, alpha, seed):
    labels = jdata.make_image_dataset(400, seed=1).labels
    got = tdata.dirichlet_partition(labels, clients, alpha, 10, seed=seed)
    want = jdata.dirichlet_partition(labels, clients, alpha, 10, seed=seed)
    assert len(got) == len(want) == clients
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert sorted(np.concatenate(got).tolist()) == list(range(400))


@pytest.mark.parametrize("g,c", [(5, 10), (10, 10), (8, 16), (20, 10)])
def test_group_spec_matches_reference(g, c):
    a = tgrouping.GroupSpec.contiguous(g, c)
    b = jgrouping.GroupSpec.contiguous(g, c)
    assert a.classes_per_group == b.classes_per_group
    for k in range(g):
        assert a.logit_signature(k) == b.logit_signature(k)
    for cls in range(c):
        assert a.group_of_class(cls) == b.group_of_class(cls)
    np.testing.assert_array_equal(tgrouping.node_group_permutation(a, None),
                                  jgrouping.node_group_permutation(b, None))
