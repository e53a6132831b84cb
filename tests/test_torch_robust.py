"""The port's robust fusion rules (``repro_torch.fl.robust`` and the
``robust=`` argument of ``repro_torch.core.fusion``) against the
reference's, on the same seeded numpy inputs.

Tolerances:
- ``weighted_median`` picks an input value: equal to the bit on
  tie-free weights (a tie, a sorted-weight prefix of exactly half, is
  resolved by the stable sort in slot order in both packages).
- ``trimmed_mean`` 1e-5: both divide by ``hi - lo`` (ROADMAP Queue 3)
  and differ only in the order of the fp32 sums.
- ``clip_deltas`` 1e-6: the port takes one norm over the flat row, the
  reference sums per-leaf squares; the two sums differ in order.
- The identity shortcuts (``trimmed_mean(0)``, ``norm_clip(inf)``) are
  bit-identical to the plain round.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vgg9 as jvgg9
from repro.core import fusion as jfusion
from repro.fl import robust as jrobust
from repro.fl import runtime as jruntime
from repro_torch import convert
from repro_torch.configs import vgg9 as tvgg9
from repro_torch.core import fusion as tfusion
from repro_torch.fl import robust as trobust
from repro_torch.fl import runtime as truntime
from repro_torch.fl import scenarios as tscen
from repro_torch.models.module import FlatLayout

RULES = ("coordinate_median", "trimmed_mean(0.1)", "trimmed_mean(0.25)",
         "trimmed_mean(0.4)")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(n, seed):
    return np.random.default_rng(seed).uniform(0.2, 2.0, n)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("shape", [(7, 300), (10, 4, 33), (1, 17)])
def test_reductions_match_reference(rule, shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    x = rng.normal(size=shape).astype(np.float32)
    w = _weights(shape[0], 5)
    got = trobust.parse_robust(rule).reduce(torch.tensor(x),
                                            torch.tensor(w))
    want = np.asarray(jrobust.parse_robust(rule).reduce(jnp.asarray(x),
                                                        jnp.asarray(w)))
    assert got.shape == want.shape
    if rule == "coordinate_median":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_weighted_median_tie_resolves_in_slot_order():
    """w = [1, 1, 1.5, 1.5, .05, .05]: a prefix can sum to exactly half.
    With equal values in every row the stable sort keeps slot order, so
    both packages pick the same slot's value; here the rows differ only
    in which value the tie picks."""
    w = np.array([1, 1, 1.5, 1.5, 0.05, 0.05])
    x = np.array([[0.0], [1.0], [2.0], [3.0], [4.0], [5.0]], np.float32)
    x = np.repeat(x, 3, axis=1)
    x[:, 1] = x[::-1, 0]
    got = trobust.weighted_median(torch.tensor(x), torch.tensor(w))
    want = jrobust.weighted_median(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_clip_deltas_matches_reference():
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(5, 3, 4)).astype(np.float32),
            "b": rng.normal(size=(5, 6)).astype(np.float32)}
    glob = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(6,)).astype(np.float32)}
    layout = FlatLayout({k: torch.tensor(v[0]) for k, v in tree.items()})
    flat = layout.flatten({k: torch.tensor(v) for k, v in tree.items()})
    gflat = layout.flatten({k: torch.tensor(v) for k, v in glob.items()})
    for tau in (0.5, 3.0, 1e6):
        got = layout.unflatten(trobust.clip_deltas(flat, gflat, tau))
        want = jrobust.clip_deltas(tree, glob, tau)
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=1e-6)


@pytest.mark.parametrize("spec", ["bogus(", "median", "trimmed_mean(0.5)",
                                  "norm_clip(0)", "coordinate_median(1)"])
def test_parse_errors_match_reference(spec):
    with pytest.raises(ValueError) as t:
        trobust.parse_robust(spec)
    with pytest.raises(ValueError) as j:
        jrobust.parse_robust(spec)
    assert str(t.value) == str(j.value)


def test_identity_shortcuts_are_inactive():
    for spec in ("trimmed_mean(0)", "norm_clip(inf)"):
        assert not trobust.parse_robust(spec).active
    for spec in ("trimmed_mean(0.1)", "norm_clip(5)", "coordinate_median"):
        assert trobust.parse_robust(spec).active


def _cohort(n, seed):
    """n perturbed copies of the reduced Fed2 VGG9's reference init:
    the reference's stacked tree and the port's (n, M) buffer."""
    jcfg, tcfg = jvgg9.reduced(), tvgg9.reduced()
    one = jax.tree_util.tree_map(
        np.asarray, jruntime.cnn_task(jcfg).init_fn(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    clients = [jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
        one) for _ in range(n)]
    jstack = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *clients)
    tparams = [convert.to_port(c) for c in clients]
    layout = FlatLayout(tparams[0])
    flat = torch.stack([layout.flatten(p) for p in tparams])
    return jcfg, tcfg, one, jstack, layout, tparams[0], flat


def _same_tree(got_flat, layout, want, atol):
    got = convert.to_reference(layout.unflatten(got_flat))
    fg = jax.tree_util.tree_leaves(got)
    fw = jax.tree_util.tree_leaves(want)
    assert len(fg) == len(fw)
    for a, b in zip(fg, fw):
        if atol == 0:
            np.testing.assert_array_equal(a, np.asarray(b))
        else:
            np.testing.assert_allclose(a, np.asarray(b), atol=atol)


@pytest.mark.parametrize("rule", ["coordinate_median", "trimmed_mean(0.25)"])
@pytest.mark.parametrize("presence", [False, True])
def test_paired_average_robust_matches_reference(rule, presence):
    """Fed2's fusion under a reducing rule: per group column with that
    column's presence weights (a column held by no client falls back to
    uniform), plain coordinate reduction elsewhere."""
    n = 6
    jcfg, tcfg, one, jstack, layout, tp, flat = _cohort(n, 7)
    w = _weights(n, 8)
    gw = None
    if presence:
        gw = np.random.default_rng(9).uniform(0.1, 3.0, (n, 5))
        gw[:2, 1] = 0.0
        gw[:, 3] = 0.0                       # no holder: uniform column
    jr, tr = jrobust.parse_robust(rule), trobust.parse_robust(rule)
    jga = jfusion.cnn_group_axes(one, jcfg)
    want = jax.jit(lambda s: jfusion.paired_average(
        s, jga, weights=w, group_weights=gw, robust=jr))(jstack)
    got = tfusion.paired_average(flat, layout,
                                 tfusion.cnn_group_axes(tp, tcfg),
                                 weights=w, group_weights=gw,
                                 use_kernel=True, robust=tr)
    _same_tree(got, layout, want, 0 if rule == "coordinate_median" else 1e-5)
    want_avg = jax.jit(lambda s: jfusion.fedavg(s, w, robust=jr))(jstack)
    got_avg = tfusion.fedavg(flat, w, use_kernel=True, robust=tr)
    _same_tree(got_avg, layout, want_avg,
               0 if rule == "coordinate_median" else 1e-5)


SMALL = dict(rounds=2, train_size=240, test_size=80, steps_per_epoch=3,
             batch_size=8)


@pytest.mark.parametrize("name", ["nxc2_fedavg"])
def test_identity_shortcuts_run_the_plain_round(name):
    """``trimmed_mean(0)`` and ``norm_clip(inf)`` drop the rule: the run
    equals the plain run to the bit."""
    spec = tscen.get(name).override(**SMALL)
    ds, test = spec.datasets()
    parts = spec.partition(ds.labels)
    task = truntime.cnn_task(spec.model_config())
    init = task.init_fn(torch.Generator().manual_seed(0))
    finals = []
    for robust in (None, "trimmed_mean(0)", "norm_clip(inf)"):
        cfg = dataclasses.replace(spec.fl_config(), robust=robust)
        h = truntime.run_federated(
            task, cfg, parts,
            lambda s: {"images": ds.images[s], "labels": ds.labels[s]},
            [{"images": test.images, "labels": test.labels}],
            device="cpu", init_params=init)
        finals.append(_flat(h["final_params"]))
    assert torch.equal(finals[0], finals[1])
    assert torch.equal(finals[0], finals[2])


def _flat(params):
    return FlatLayout(params).flatten(params)


def test_reducing_rule_refuses_tiled_rounds():
    spec = tscen.get("nxc2_fedavg").override(
        cohort_size=4, robust="coordinate_median", rounds=1,
        train_size=120, test_size=40, steps_per_epoch=1, batch_size=4)
    with pytest.raises(ValueError, match="no exact tiled form"):
        tscen.run_scenario(spec, device="cpu")
