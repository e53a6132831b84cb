"""The sync round's precision and schedule axes in the port against the
reference: the bf16 local phase (``compute_dtype``), ``local_unroll``
and one-shot fusion (``mode="one_shot"``), on the ``nxc2`` scenario
inputs at a small size from the reference's converted init.

bf16 tolerance: 2^-7 absolute on the final parameters after one round
(each |w| here is below about 1). Each client's trained row is a bf16
value: where the two packages round one intermediate differently (XLA
may fuse elementwise chains and skip bf16 roundings that eager torch
performs, and the port's ``local_step`` route computes in fp32 before
storing bf16), a client's coordinate moves by a bf16 ulp, 2^-8 below
1.0, and the fp32 fusion averages such moves. Measured: below 1e-3
after one round, on both local routes. The fusion stays fp32: the fused
parameters are not all bf16 values.

``local_unroll`` changes neither result nor dispatch in the port (eager
torch has no scan): a run at 4 equals the run at 1 to the bit. A
one-shot run has exactly one history row and matches the reference at
fp32 tolerances (1e-4, one eval example).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import engine as jengine
from repro.fl import runtime as jruntime
from repro.fl import scenarios as jscen
from repro_torch import convert
from repro_torch.fl import engine as tengine
from repro_torch.fl import runtime as truntime
from repro_torch.fl import scenarios as tscen
from repro_torch.models.module import FlatLayout

SMALL = dict(train_size=240, test_size=80, steps_per_epoch=3, batch_size=8)
BF16_ATOL = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(name, **over):
    tspec = tscen.get(name).override(**SMALL, **over)
    jspec = jscen.get(name).override(**SMALL, **over)
    ds, test = tspec.datasets()
    return tspec, jspec, ds, tspec.partition(ds.labels), [
        {"images": test.images, "labels": test.labels}]


def _init(jspec):
    """The reference's initial parameters of ``jspec`` (numpy)."""
    return jax.tree_util.tree_map(
        np.asarray, jruntime.cnn_task(jspec.model_config()).init_fn(
            jax.random.PRNGKey(jspec.seed)))


@functools.lru_cache(maxsize=None)
def _reference(name, rounds, compute_dtype="float32"):
    tspec, jspec, ds, parts, tests = _inputs(name, rounds=rounds)
    jtask = jruntime.cnn_task(jspec.model_config())
    init = _init(jspec)
    hj = jruntime.run_federated(
        jtask, dataclasses.replace(jspec.fl_config(),
                                   compute_dtype=compute_dtype), parts,
        lambda s: {"images": jnp.asarray(ds.images[s]),
                   "labels": jnp.asarray(ds.labels[s])}, tests, mesh=None,
        use_kernel=False)
    return hj, init


def _port(name, rounds, init, *, use_local_kernel=False, **cfg_over):
    tspec, _, ds, parts, tests = _inputs(name, rounds=rounds)
    return truntime.run_federated(
        truntime.cnn_task(tspec.model_config()),
        dataclasses.replace(tspec.fl_config(), **cfg_over), parts,
        lambda s: {"images": ds.images[s], "labels": ds.labels[s]}, tests,
        device="cpu", init_params=convert.to_port(init),
        use_local_kernel=use_local_kernel)


def _max_diff(ht, hj):
    got = jax.tree_util.tree_leaves(convert.to_reference(ht["final_params"]))
    want = jax.tree_util.tree_leaves(hj["final_params"])
    assert len(got) == len(want)
    return max(float(np.abs(a - np.asarray(b)).max())
               for a, b in zip(got, want))


@pytest.mark.parametrize("use_local_kernel", [False, True])
def test_bf16_round_matches_reference(use_local_kernel):
    hj, init = _reference("nxc2_fed2", 1, "bfloat16")
    ht = _port("nxc2_fed2", 1, init, use_local_kernel=use_local_kernel,
               compute_dtype="bfloat16")
    assert _max_diff(ht, hj) <= BF16_ATOL
    np.testing.assert_allclose(ht["acc"], hj["acc"],
                               atol=2 / SMALL["test_size"] + 1e-9)
    flat = FlatLayout(ht["final_params"]).flatten(ht["final_params"])
    assert flat.dtype == torch.float32
    assert not torch.equal(flat, flat.to(torch.bfloat16).float())


def test_bf16_local_kernel_route_agrees_with_plain():
    _, init = _reference("nxc2_fed2", 1, "bfloat16")
    a, b = (_port("nxc2_fed2", 1, init, use_local_kernel=k,
                  compute_dtype="bfloat16") for k in (False, True))
    d = max(float((x - y).abs().max()) for x, y in zip(
        jax.tree_util.tree_leaves(a["final_params"]),
        jax.tree_util.tree_leaves(b["final_params"])))
    assert 0 < d <= BF16_ATOL


def test_local_unroll_changes_nothing():
    init = _init(jscen.get("nxc2_fedavg"))
    runs = [_port("nxc2_fedavg", 1, init, local_unroll=u) for u in (1, 4)]
    a, b = (FlatLayout(h["final_params"]).flatten(h["final_params"])
            for h in runs)
    assert torch.equal(a, b)


@pytest.mark.parametrize("unroll,steps", [(1, 8), (4, 8), (20, 8), (3, 1)])
def test_resolve_local_unroll_matches_reference(unroll, steps):
    cfg = truntime.FLConfig(local_unroll=unroll)
    assert (tengine.resolve_local_unroll(cfg, steps)
            == jengine.resolve_local_unroll(cfg, steps))


@pytest.mark.parametrize("kw", [dict(), dict(rounds=3, local_epochs=2,
                                             steps_per_epoch=5)])
def test_one_shot_config_matches_reference(kw):
    t = truntime.one_shot_config(truntime.FLConfig(mode="one_shot", **kw))
    j = jruntime.one_shot_config(jruntime.FLConfig(mode="one_shot", **kw))
    for f in ("mode", "rounds", "local_epochs", "steps_per_epoch"):
        assert getattr(t, f) == getattr(j, f), f
    sync = truntime.FLConfig(**kw)
    assert truntime.one_shot_config(sync) is sync


def test_one_shot_run_has_one_row_and_matches_reference():
    hj, init = _reference("nxc2_fedavg_oneshot", 2)
    ht = _port("nxc2_fedavg_oneshot", 2, init, use_local_kernel=True)
    assert ht["round"] == hj["round"] == [0]
    assert len(ht["acc"]) == len(ht["confusion"]) == 1
    np.testing.assert_allclose(ht["acc"], hj["acc"],
                               atol=1 / SMALL["test_size"] + 1e-9)
    assert _max_diff(ht, hj) <= 1e-4
