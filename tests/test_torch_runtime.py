"""The port's synchronous runtime against the reference's, round for
round: ``repro_torch.fl.runtime.run_federated`` (on the CPU) and
``repro.fl.runtime.run_federated(mesh=None)`` on the ``nxc2`` scenario
inputs at a small size, from the reference's own initial parameters
(converted) and the same seed, so both draw the same batches.

Tolerances: final parameters 1e-4 absolute. Both sides compute in fp32;
they differ in summation order inside convolutions and fusion, and that
round-off grows over 2 rounds of 3 momentum-SGD steps (measured below
1e-5). Accuracies agree to one eval example (1/test_size): a prediction
whose two top logits tie to round-off may take either class.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import runtime as jruntime
from repro.fl import scenarios as jscen
from repro_torch import convert
from repro_torch.fl import runtime as truntime
from repro_torch.fl import scenarios as tscen
from repro_torch.kernels import local_step as ls
from repro_torch.kernels import paired_fusion as pf
from repro_torch.models.module import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# batch 8 (the scenario's is 16) cuts both packages' CPU time
SMALL = dict(rounds=2, train_size=240, test_size=80, steps_per_epoch=3,
             batch_size=8)


def _inputs(name, cohort_size, presence):
    spec = tscen.get(name).override(cohort_size=cohort_size, **SMALL)
    ds, test = spec.datasets()
    parts = spec.partition(ds.labels)
    counts = (np.stack([np.bincount(ds.labels[p], minlength=10)
                        for p in parts]) if presence else None)
    return spec, ds, test, parts, counts


@functools.lru_cache(maxsize=None)
def _reference_run(name, cohort_size, presence):
    """The reference's run and its initial parameters (numpy); the port
    cases that differ only in the port's kernel routes share it."""
    jspec = jscen.get(name).override(cohort_size=cohort_size, **SMALL)
    _, ds, test, parts, counts = _inputs(name, cohort_size, presence)
    jtask = jruntime.cnn_task(jspec.model_config())
    init = jax.tree_util.tree_map(
        np.asarray, jtask.init_fn(jax.random.PRNGKey(jspec.seed)))
    kw = ({"class_counts": counts, "group_spec": jspec.group_spec()}
          if presence else {})
    hj = jruntime.run_federated(
        jtask, jspec.fl_config(), parts,
        lambda s: {"images": jnp.asarray(ds.images[s]),
                   "labels": jnp.asarray(ds.labels[s])},
        [{"images": test.images, "labels": test.labels}], mesh=None,
        use_kernel=False, **kw)
    return hj, init


def _run_both(name, *, cohort_size=None, presence=False,
              use_local_kernel=False, use_kernel=None):
    hj, init = _reference_run(name, cohort_size, presence)
    tspec, ds, test, parts, counts = _inputs(name, cohort_size, presence)
    ttask = truntime.cnn_task(tspec.model_config())
    tests = [{"images": test.images, "labels": test.labels}]
    tkw = ({"class_counts": counts, "group_spec": tspec.group_spec()}
           if presence else {})
    ht = truntime.run_federated(
        ttask, tspec.fl_config(), parts,
        lambda s: {"images": ds.images[s], "labels": ds.labels[s]},
        tests, device="cpu", init_params=convert.to_port(init),
        use_kernel=use_kernel, use_local_kernel=use_local_kernel, **tkw)
    return hj, ht, SMALL["test_size"]


def _assert_runs_agree(hj, ht, n_test):
    assert ht["round"] == hj["round"]
    np.testing.assert_allclose(ht["acc"], np.asarray(hj["acc"], np.float64),
                               atol=1.0 / n_test + 1e-9)
    for a, b in zip(ht["participants"], hj["participants"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    got = convert.to_reference(ht["final_params"])
    want = jax.tree_util.tree_map(np.asarray, hj["final_params"])
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(fg) == len(fw)
    for (path, a), (_, b) in zip(fg, fw):
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(a, b, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name,kw", [
    ("nxc2_fed2", {}),
    ("nxc2_fed2", {"use_local_kernel": True}),
    ("nxc2_fed2", {"presence": True, "use_kernel": True}),
    ("nxc2_fedavg", {}),
    ("nxc2_fedavg", {"cohort_size": 4}),          # tiles of 4 and 2 (+2 pad)
    ("nxc2_fed2", {"cohort_size": 4, "use_local_kernel": True}),
], ids=["fed2", "fed2-local-kernel", "fed2-presence", "fedavg",
        "fedavg-tiled", "fed2-tiled-local-kernel"])
def test_run_federated_matches_reference(name, kw):
    before = (pf.paired_fusion.launches, ls.local_step.launches)
    hj, ht, n_test = _run_both(name, **kw)
    _assert_runs_agree(hj, ht, n_test)
    # on the CPU both wrappers take their plain versions
    assert (pf.paired_fusion.launches, ls.local_step.launches) == before


def test_fedprox_matches_reference():
    """fedprox is not a registered scenario: the nxc2 plain-net inputs
    under method=fedprox."""
    jspec = jscen.get("nxc2_fedavg").override(method="fedprox", **SMALL)
    tspec = tscen.get("nxc2_fedavg").override(method="fedprox", **SMALL)
    ds, test = tspec.datasets()
    parts = tspec.partition(ds.labels)
    jtask = jruntime.cnn_task(jspec.model_config())
    init = jax.tree_util.tree_map(
        np.asarray, jtask.init_fn(jax.random.PRNGKey(0)))
    cfg_j = jspec.fl_config()
    cfg_t = tspec.fl_config()
    assert cfg_t.prox_mu == cfg_j.prox_mu
    tests = [{"images": test.images, "labels": test.labels}]
    hj = jruntime.run_federated(
        jtask, cfg_j, parts,
        lambda s: {"images": jnp.asarray(ds.images[s]),
                   "labels": jnp.asarray(ds.labels[s])}, tests, mesh=None,
        use_kernel=False)
    ht = truntime.run_federated(
        truntime.cnn_task(tspec.model_config()), cfg_t, parts,
        lambda s: {"images": ds.images[s], "labels": ds.labels[s]}, tests,
        device="cpu", init_params=convert.to_port(init))
    _assert_runs_agree(hj, ht, SMALL["test_size"])


def test_run_scenario_on_cpu_records_rows():
    spec = tscen.get("nxc2_fed2").override(rounds=1, train_size=120,
                                           test_size=40, steps_per_epoch=1)
    rec = tscen.run_scenario(spec, device="cpu")
    assert rec.device == "cpu" and len(rec.acc) == 1
    assert len(rec.per_class_acc[0]) == 10
    assert len(rec.per_group_acc[0]) == spec.groups
    assert rec.group_signatures == [[2 * g, 2 * g + 1] for g in range(5)]


def test_cli_mobilenet_dirichlet_round_matches_reference():
    """The CLI's ``--arch mobilenet --dirichlet 0.5`` inputs (reduced,
    small) through one fed2 round of the port, against the reference's
    ``run_federated`` on the same partition, data and converted init."""
    from repro.configs import mobilenet as jmobilenet
    from repro.data import synthetic as jdata
    from repro_torch.launch import train
    args = train.parse_args([
        "--arch", "mobilenet", "--reduced", "--dirichlet", "0.5",
        "--rounds", "1", "--nodes", "4", "--steps-per-epoch", "2",
        "--batch", "8", "--train-size", "160", "--device", "cpu"])
    task, fl, parts, get_batch, tests = train.fl_inputs(args)
    jcfg = jmobilenet.reduced()
    ds = jdata.make_image_dataset(160, n_classes=10, seed=0, noise=1.2)
    jparts = jdata.dirichlet_partition(ds.labels, 4, 0.5, 10, seed=0)
    for a, b in zip(parts, jparts):
        np.testing.assert_array_equal(a, b)
    jtask = jruntime.cnn_task(jcfg)
    init = jax.tree_util.tree_map(
        np.asarray, jtask.init_fn(jax.random.PRNGKey(0)))
    jfl = jruntime.FLConfig(population=4, rounds=1, local_epochs=1,
                            steps_per_epoch=2, batch_size=8, lr=0.01,
                            momentum=0.9, method="fed2", seed=0)
    hj = jruntime.run_federated(
        jtask, jfl, jparts,
        lambda s: {"images": jnp.asarray(ds.images[s]),
                   "labels": jnp.asarray(ds.labels[s])},
        [{"images": tests[0]["images"], "labels": tests[0]["labels"]}],
        mesh=None, use_kernel=False)
    ht = truntime.run_federated(task, fl, parts, get_batch, tests,
                                device="cpu",
                                init_params=convert.to_port(init))
    _assert_runs_agree(hj, ht, len(tests[0]["labels"]))


def test_cli_runs_on_cpu_when_asked():
    from repro_torch.launch import train
    h = train.main(["--reduced", "--rounds", "1", "--nodes", "3",
                    "--steps-per-epoch", "1", "--batch", "4",
                    "--train-size", "80", "--device", "cpu"])
    assert len(h["acc"]) == 1
    assert all(t.device.type == "cpu"
               for t in tree_leaves(h["final_params"]))
