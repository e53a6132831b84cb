"""The port's fusion (``repro_torch.core.fusion``) against the
reference's (``repro.core.fusion``) on the same stacked clients: the
reference's tree_map path and its ``use_kernel=True`` path (the Pallas
kernel in interpret mode), against the port's plain path and its kernel
route (``_kernel_fuse``, whose wrapper computes the plain version on CPU
tensors). Plain, sample-weighted, presence-weighted (with an all-zero
column) and permuted pairing.

Tolerance: 2e-5 absolute, the reference's own between its two fusion
paths (tests/test_fusion_fastpath.py): fp32 sums of O(1) values taken in
different orders.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vgg9 as jvgg9
from repro.core import fusion as jfusion
from repro.core.grouping import GroupSpec
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch.configs import vgg9 as tvgg9
from repro_torch.core import fusion as tfusion
from repro_torch.kernels import paired_fusion as pf
from repro_torch.models.module import FlatLayout

TOL = 2e-5
N = 4


@functools.lru_cache(maxsize=None)
def _reference_clients(cfg_j, n, seed):
    """n clients' params (numpy) as a list of trees and stacked."""
    rng = np.random.default_rng(seed)
    base = jax.tree_util.tree_map(
        np.asarray, jcnn.init_cnn(jax.random.PRNGKey(seed), cfg_j))
    rows = [jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
        base) for _ in range(n)]
    return rows, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *rows)


def _clients(cfg_j, cfg_t, n=N, seed=0):
    """n clients' params as a stacked reference tree and the port's
    (n, M) flat buffer, same values; the buffer is new on every call."""
    rows, stacked_j = _reference_clients(cfg_j, n, seed)
    tp = convert.to_port(rows[0])
    layout = FlatLayout(tp)
    flat = layout.alloc((n,))
    for i, r in enumerate(rows):
        layout.flatten(convert.to_port(r), out=flat[i])
    return stacked_j, flat, layout, tp


def _assert_same(got_flat, layout, want_tree):
    got = convert.to_reference(layout.unflatten(got_flat))
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert len(fg) == len(fw)
    for (path, a), (_, b) in zip(fg, fw):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL,
                                   err_msg=jax.tree_util.keystr(path))


@functools.lru_cache(maxsize=None)
def _reference_fedavg(weights):
    """The reference's fedavg on its tree_map path and its kernel path;
    the port's two routes share it."""
    _, sj = _reference_clients(jvgg9.reduced(fed2_groups=0, norm="none"),
                               N, 0)
    w = None if weights is None else list(weights)
    return [jfusion.fedavg(sj, w, use_kernel=jk) for jk in (False, True)]


@pytest.mark.parametrize("weights", [None, (1.0, 5.0, 2.0, 0.5)])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_fedavg_matches_reference(weights, use_kernel):
    cfg_j, cfg_t = jvgg9.reduced(fed2_groups=0, norm="none"), \
        tvgg9.reduced(fed2_groups=0, norm="none")
    _, flat, layout, _ = _clients(cfg_j, cfg_t)
    got = tfusion.fedavg(flat, None if weights is None else list(weights),
                         use_kernel=use_kernel)
    for want in _reference_fedavg(weights):
        _assert_same(got, layout, want)


def _grouped():
    cfg_j, cfg_t = jvgg9.reduced(), tvgg9.reduced()
    sj, flat, layout, tp = _clients(cfg_j, cfg_t)
    ga_j = jfusion.cnn_group_axes(jax.tree_util.tree_map(lambda a: a[0], sj),
                                  cfg_j)
    ga_t = tfusion.cnn_group_axes(tp, cfg_t)
    return cfg_t, sj, flat, layout, ga_j, ga_t


# presence rows: client 3 holds no class of group 0 (zero weight there);
# no client holds group 4's classes (the all-zero column falls back to a
# uniform mean)
GW = np.array([[3, 1, 0, 2, 0],
               [1, 0, 4, 2, 0],
               [2, 2, 1, 0, 0],
               [0, 5, 1, 1, 0]], np.float64)
PERMS = np.array([[0, 1, 2, 3, 4],
                  [1, 0, 2, 4, 3],
                  [4, 3, 2, 1, 0],
                  [2, 3, 4, 0, 1]])


def _paired_kwargs(case):
    kw = {}
    if case in ("weighted", "presence", "perms_presence"):
        kw["weights"] = [2.0, 1.0, 3.0, 1.5]
    if case in ("presence", "perms_presence"):
        kw["group_weights"] = GW
    if case.startswith("perms"):
        kw["perms"] = PERMS
    return kw


@functools.lru_cache(maxsize=None)
def _reference_paired(case):
    """The reference's paired_average on its tree_map path and its
    kernel path; the port's two routes share it."""
    _, sj, _, _, ga_j, _ = _grouped()
    return [jfusion.paired_average(sj, ga_j, use_kernel=jk,
                                   **_paired_kwargs(case))
            for jk in (False, True)]


@pytest.mark.parametrize("case", ["plain", "weighted", "presence",
                                  "perms", "perms_presence"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_paired_average_matches_reference(case, use_kernel):
    _, _, flat, layout, _, ga_t = _grouped()
    before = pf.paired_fusion.launches
    got = tfusion.paired_average(flat, layout, ga_t, use_kernel=use_kernel,
                                 **_paired_kwargs(case))
    assert pf.paired_fusion.launches == before      # CPU: plain version
    for want in _reference_paired(case):
        _assert_same(got, layout, want)


def test_all_zero_presence_column_is_a_plain_mean():
    """Group 4 has no holder in GW: its blocks fuse as the unweighted
    mean of the clients, whatever the sample weights."""
    cfg, _, flat, layout, _, ga_t = _grouped()
    got = tfusion.paired_average(flat, layout, ga_t, group_weights=GW,
                                 weights=[9.0, 1.0, 1.0, 1.0],
                                 use_kernel=True)
    slot = [s for s in layout.slots if s.path == ("fcs", 1, "w")][0]
    g = cfg.fed2_groups
    blk = slot.size // g
    lo = slot.offset + 4 * blk
    torch.testing.assert_close(got[lo:lo + blk],
                               flat[:, lo:lo + blk].mean(0),
                               atol=TOL, rtol=0)


def test_presence_group_weights_and_prox_match_reference():
    spec_counts = np.random.default_rng(3).integers(0, 9, size=(4, 10))
    spec = GroupSpec.contiguous(5, 10)
    from repro_torch.core.grouping import GroupSpec as TGroupSpec
    np.testing.assert_array_equal(
        tfusion.presence_group_weights(spec_counts,
                                       TGroupSpec.contiguous(5, 10)),
        jfusion.presence_group_weights(spec_counts, spec))
    sj, flat, layout, _ = _clients(jvgg9.reduced(), tvgg9.reduced(), n=2)
    want = jfusion.fedprox_penalty(
        jax.tree_util.tree_map(lambda a: a[0], sj),
        jax.tree_util.tree_map(lambda a: a[1], sj), 0.01)
    got = tfusion.fedprox_penalty(flat[0], flat[1], 0.01)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_group_axes_follow_the_port_layout():
    """The reference marks a grouped conv's out-channel axis last (HWIO);
    the port marks axis 0 (OIHW). Both mark the same leaves."""
    _, _, _, layout, ga_j, ga_t = _grouped()
    gj = jax.tree_util.tree_leaves(
        ga_j, is_leaf=lambda x: x is None or isinstance(x, jfusion.GroupAxis))
    gt = layout.leaves(ga_t)
    assert [a is None for a in gj] == [a is None for a in gt]
    assert any(a is not None for a in gt)
    assert all(a.axis == 0 and a.n_groups == 5 for a in gt if a is not None)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mobilenet_paired_average_matches_reference(use_kernel):
    """Grouped depthwise-separable blocks: the depthwise (c_in, 1, 3, 3)
    and pointwise weights split on axis 0 in OIHW, as the reference
    splits their last HWIO axis; presence-weighted, so every group block
    fuses with its own column."""
    from repro.configs import mobilenet as jmobilenet
    from repro_torch.configs import mobilenet as tmobilenet
    cfg_j, cfg_t = jmobilenet.reduced(), tmobilenet.reduced()
    sj, flat, layout, tp = _clients(cfg_j, cfg_t)
    ga_j = jfusion.cnn_group_axes(jax.tree_util.tree_map(lambda a: a[0], sj),
                                  cfg_j)
    ga_t = tfusion.cnn_group_axes(tp, cfg_t)
    gj = jax.tree_util.tree_leaves(
        ga_j, is_leaf=lambda x: x is None or isinstance(x, jfusion.GroupAxis))
    assert [a is None for a in gj] == [a is None for a in
                                       layout.leaves(ga_t)]
    assert ga_t["convs"][2]["dw"]["w"] == tfusion.GroupAxis(0, 5)
    kw = _paired_kwargs("presence")
    want = jfusion.paired_average(sj, ga_j, use_kernel=False, **kw)
    got = tfusion.paired_average(flat, layout, ga_t, use_kernel=use_kernel,
                                 **kw)
    _assert_same(got, layout, want)


def test_broadcast_global_fills_every_row():
    _, flat, _, _ = _clients(jvgg9.reduced(), tvgg9.reduced(), n=3)
    g = torch.arange(flat.shape[1], dtype=torch.float32)
    out = tfusion.broadcast_global(g, flat)
    assert out.data_ptr() == flat.data_ptr()
    assert all(torch.equal(flat[i], g) for i in range(3))


@pytest.mark.parametrize("shape,axis,groups", [
    ((2, 4, 5), 1, 2),          # the group axis between two others
    ((3, 2, 6), 2, 3),          # the last axis: blocks of one element
    ((4, 8, 6, 3), 1, 8),       # a stacked (L, G, i, o) leaf, reduced
])
def test_kernel_route_fuses_a_group_axis_that_does_not_lead(shape, axis,
                                                            groups):
    """Presence-weighted fusion of a leaf whose group axis has leading
    dims (pre > 1): the kernel route fuses each (pre index, group) block
    on its own, one launch each, and matches the reference's kernel
    route within 1e-6. A shared leaf beside it takes the sample
    weights."""
    rng = np.random.default_rng(21)
    n = 4
    leaves = {"g": rng.normal(size=(n,) + shape).astype(np.float32),
              "s": rng.normal(size=(n, 7)).astype(np.float32)}
    gw = rng.uniform(0.0, 3.0, (n, groups))
    gw[:, 0] = 0.0                       # a column no client holds
    gw[1, -1] = 0.0
    w = np.array([2.0, 1.0, 4.0, 3.0])
    jaxes = {"g": jfusion.GroupAxis(axis, groups), "s": None}
    want = jfusion.paired_average(
        jax.tree_util.tree_map(jnp.asarray, leaves), jaxes, weights=w,
        group_weights=gw, use_kernel=True)
    tree = {k: torch.tensor(v[0]) for k, v in leaves.items()}
    layout = FlatLayout(tree)
    flat = layout.alloc((n,))
    for i in range(n):
        layout.flatten({k: torch.tensor(v[i]) for k, v in leaves.items()},
                       out=flat[i])
    taxes = {"g": tfusion.GroupAxis(axis, groups), "s": None}
    before = pf.paired_fusion.launches
    got = tfusion.paired_average(flat, layout, taxes, weights=w,
                                 group_weights=gw, use_kernel=True)
    assert pf.paired_fusion.launches == before     # CPU: plain version
    plain = tfusion.paired_average(flat, layout, taxes, weights=w,
                                   group_weights=gw, use_kernel=False)
    out = layout.unflatten(got)
    for k in leaves:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6)
    torch.testing.assert_close(got, plain, atol=1e-6, rtol=0)
