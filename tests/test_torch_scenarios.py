"""The port's scenario matrix (``repro_torch.fl.scenarios``) and its CLI
(``repro_torch.launch.scenarios``) against the reference's.

- The port registers all 27 of the reference's seeded specs (the 8 of
  the paper's protocols, the 12 of the sync round's feature axes:
  attacks, robust fusion, alignment, one-shot; the 5 capacity-tier and
  the 2 buffered-async specs); each spec's partition (to the bit),
  ``fl_config``, ``protocol_label``, model plan (and PAN scale) and
  tier, mode and latency fields equal the reference's.
- Two rounds (or fusion events) of ``dir05_fed2``, ``qskew_fedavg``,
  ``nxc2_fed2_signflip20_trim``, ``nxc2_fedavg_flip20``,
  ``nxc2_fed2_oneshot``, ``nxc2_fedavg_tiers`` and ``nxc2_fed2_async``
  at a small size from the reference's init (converted) and the same
  seed: final parameters within 1e-4, accuracies within one eval
  example, as tests/test_torch_runtime.py holds ``nxc2``; the record's
  tiers and the async run's simulated times equal the reference's.
- ``nxc2_fedavg_none`` builds ``nxc2_fedavg``'s model: their runs are
  equal to the bit.
- The CLI lists the registry and writes one record per scenario.
"""
import dataclasses
import json

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
from repro_torch.launch import scenarios as tlaunch

SYNC = ("dir05_fed2", "dir05_fedavg", "dir05_fedavg_none",
        "dir05_fedavg_pan", "iid_fedavg", "nxc2_fed2", "nxc2_fed2_flip20",
        "nxc2_fed2_oneshot", "nxc2_fed2_signflip20",
        "nxc2_fed2_signflip20_trim", "nxc2_fedavg", "nxc2_fedavg_flip20",
        "nxc2_fedavg_none", "nxc2_fedavg_oneshot", "nxc2_fedavg_pan",
        "nxc2_fedavg_signflip20", "nxc2_fedavg_signflip20_trim",
        "nxc2_fedma", "qskew_fed2", "qskew_fedavg")
TIERS = ("dir05_fed2_tiers", "dir05_fedavg_tiers", "nxc2_fed2_tiers",
         "nxc2_fed2_tiers_cal", "nxc2_fedavg_tiers")
ASYNC = ("nxc2_fed2_async", "nxc2_fedavg_async")
ALL = tuple(sorted(SYNC + TIERS + ASYNC))
SMALL = dict(rounds=2, train_size=240, test_size=80, steps_per_epoch=3,
             batch_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_holds_the_reference_sync_specs():
    assert tscen.available() == ALL == jscen.available()
    assert len(ALL) == 27
    assert tscen.PROTOCOLS == jscen.PROTOCOLS


@pytest.mark.parametrize("name", ALL)
def test_spec_matches_reference(name):
    t, j = tscen.get(name), jscen.get(name)
    assert (t.summary, t.protocol, t.method) == (j.summary, j.protocol,
                                                j.method)
    assert t.protocol_label() == j.protocol_label()
    ct, cj = t.fl_config(), j.fl_config()
    for f in dataclasses.fields(ct):
        assert getattr(ct, f.name) == getattr(cj, f.name), f.name
    labels = t.datasets()[0].labels
    for a, b in zip(t.partition(labels), j.partition(labels)):
        np.testing.assert_array_equal(a, b)
    assert t.model_config().plan == j.model_config().plan
    assert t.model_config().pan == j.model_config().pan
    assert (t.model_config().fed2_groups
            == j.model_config().fed2_groups)
    for f in ("mode", "attack", "attack_fraction", "robust", "alignment",
              "tiers", "buffer_k", "staleness", "latency", "cohort_size",
              "sampler", "rounds", "lr"):
        assert getattr(t, f) == getattr(j, f), f


def test_unknown_protocol_is_refused():
    with pytest.raises(ValueError, match="unknown scenario protocol"):
        tscen.get("iid_fedavg").override(protocol="zipf")


@pytest.mark.parametrize("name", ["dir05_fed2", "qskew_fedavg",
                                  "nxc2_fed2_signflip20_trim",
                                  "nxc2_fedavg_flip20", "nxc2_fed2_oneshot",
                                  "nxc2_fedavg_tiers", "nxc2_fed2_async"])
def test_two_rounds_match_reference(name):
    tspec = tscen.get(name).override(**SMALL)
    jspec = jscen.get(name).override(**SMALL)
    ds, test = tspec.datasets()
    parts = tspec.partition(ds.labels)
    jtask = jruntime.cnn_task(jspec.model_config())
    init = jax.tree_util.tree_map(
        np.asarray, jtask.init_fn(jax.random.PRNGKey(jspec.seed)))
    tests = [{"images": test.images, "labels": test.labels}]
    hj = jruntime.run_federated(
        jtask, jspec.fl_config(), parts,
        lambda s: {"images": jnp.asarray(ds.images[s]),
                   "labels": jnp.asarray(ds.labels[s])}, tests, mesh=None,
        use_kernel=False, latency=jspec.latency)
    rec = tscen.run_scenario(tspec, device="cpu",
                             init_params=convert.to_port(init))
    assert rec.protocol == jspec.protocol_label()
    assert len(rec.acc) == len(hj["acc"])
    assert (rec.mode, rec.attack, rec.robust) == (tspec.mode, tspec.attack,
                                                  tspec.robust)
    assert rec.tiers == ([[w, c] for w, c in jspec.tiers]
                         if jspec.tiers else [])
    assert rec.sim_time == [round(float(t), 4)
                            for t in hj.get("sim_time", [])]
    np.testing.assert_allclose(rec.acc, hj["acc"],
                               atol=1 / SMALL["test_size"] + 1e-9)
    ht = truntime.run_federated(
        truntime.cnn_task(tspec.model_config()), tspec.fl_config(), parts,
        lambda s: {"images": ds.images[s], "labels": ds.labels[s]}, tests,
        latency=tspec.latency, device="cpu",
        init_params=convert.to_port(init))
    for a, b in zip(jax.tree_util.tree_leaves(convert.to_reference(
            ht["final_params"])), jax.tree_util.tree_leaves(
            hj["final_params"])):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)


def test_unaligned_fedavg_equals_nxc2_fedavg_to_the_bit():
    runs = []
    for name in ("nxc2_fedavg", "nxc2_fedavg_none"):
        spec = tscen.get(name).override(**SMALL)
        ds, test = spec.datasets()
        h = truntime.run_federated(
            truntime.cnn_task(spec.model_config()), spec.fl_config(),
            spec.partition(ds.labels),
            lambda s: {"images": ds.images[s], "labels": ds.labels[s]},
            [{"images": test.images, "labels": test.labels}], device="cpu")
        runs.append(h)
    assert runs[0]["acc"] == runs[1]["acc"]
    for a, b in zip(jax.tree_util.tree_leaves(runs[0]["final_params"]),
                    jax.tree_util.tree_leaves(runs[1]["final_params"])):
        assert torch.equal(a, b)


def test_cli_lists_the_registry(capsys):
    assert tlaunch.main(["--list"]) == []
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out] == list(ALL)
    assert "dirichlet(0.5)" in out[0]


def test_cli_runs_a_scenario_on_the_cpu(tmp_path):
    recs = tlaunch.main(["--scenarios", "qskew_fed2", "--rounds", "1",
                         "--train-size", "120", "--device", "cpu",
                         "--out", str(tmp_path)])
    assert len(recs) == 1 and recs[0].device == "cpu"
    saved = json.loads((tmp_path / "scenario_qskew_fed2.json").read_text())
    assert saved["protocol"] == "quantity(0.5)"
    assert saved["final_acc"] == recs[0].final_acc
    assert len(saved["acc"]) == 1


def test_cli_refuses_an_unknown_scenario():
    with pytest.raises(SystemExit, match="unknown scenarios"):
        tlaunch.main(["--scenarios", "nxc2_fedavg_tier", "--device", "cpu"])


def test_default_out_is_not_the_reference_records():
    assert tlaunch.DEFAULT_OUT.endswith("runs_torch")
    assert "artifacts_perf" not in tlaunch.DEFAULT_OUT
