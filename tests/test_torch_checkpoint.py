"""The port's checkpoints (``repro_torch.checkpoint.io`` and
``run_federated(checkpoint_dir=..., resume=...)``), case for case with
tests/test_checkpoint.py, and across the two packages.

- Round trips of mixed-dtype trees (numpy and torch leaves) are exact;
  a bfloat16 leaf is refused; missing keys and shape mismatches raise
  the reference's errors.
- A run resumed from a mid-run checkpoint equals the uninterrupted run
  to the bit (accuracies, rounds, final params): in-memory and mmap
  stores, fedavgm under a sampler, scaffold's client rows on the
  whole-population path, capacity tiers; a finished run's resume
  reports one eval; saves flush only dirty shards; pruning spares
  unrelated files; async runs refuse checkpointing with the reference's
  message.
- The files are the reference's: the port's path keys equal jax's
  ``tree_flatten_with_path`` keys for the VGG9 params, every method's
  server tree and scaffold's client row, and a checkpoint crosses
  between the packages both ways. A JAX checkpoint of scaffold (P = 4,
  chunk 2, the whole-stack format and the mmap store's) at round 2,
  resumed by the port to round 4, agrees with the JAX package's
  uninterrupted rounds 2-3, and the reverse: accuracies within one eval
  example (1/n_test), params within 1e-4 absolute, the tolerance of
  tests/test_torch_runtime.py (fp32 on both sides, another summation
  order in convolutions and fusion).
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import vgg9 as jvgg9
from repro.fl import methods as jmethods
from repro.fl import runtime as jruntime
from repro.fl import statestore as jstore
from repro.fl.engine import make_round_engine as jmake_round_engine
from repro_torch import convert
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import vgg9
from repro_torch.data.synthetic import make_image_dataset, nxc_partition
from repro_torch.fl import methods as tmethods
from repro_torch.fl import statestore
from repro_torch.fl.engine import make_round_engine
from repro_torch.fl.runtime import FLConfig, cnn_task, run_federated
from repro_torch.models.module import (FlatLayout, tree_leaves,
                                       tree_leaves_with_path)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PARAM_TOL = 1e-4
_DS = make_image_dataset(200, n_classes=10, seed=0, noise=0.8)
_TEST = make_image_dataset(64, n_classes=10, seed=9, noise=0.8)
N_TEST = len(_TEST.labels)


def _get_batch(sel):
    return {"images": _DS.images[sel], "labels": _DS.labels[sel]}


def _jget_batch(sel):
    return {"images": jnp.asarray(_DS.images[sel]),
            "labels": jnp.asarray(_DS.labels[sel])}


_TEST_BATCHES = [{"images": _TEST.images, "labels": _TEST.labels}]


def _cfg():
    return vgg9.reduced(n_classes=10, fed2_groups=0, norm="none")


def _parts():
    return nxc_partition(_DS.labels, 4, 5, 10, seed=0)


def _fl(method, rounds, mod=None, **kw):
    return (mod or FLConfig)(population=4, rounds=rounds, local_epochs=1,
                             steps_per_epoch=2, batch_size=8, lr=0.02,
                             momentum=0.9, method=method, seed=0, **kw)


def _run(method, rounds, ck=None, resume=False, **kw):
    return run_federated(cnn_task(_cfg()), _fl(method, rounds, **kw),
                         _parts(), _get_batch, _TEST_BATCHES, device="cpu",
                         checkpoint_dir=ck, resume=resume)


def _assert_equal_params(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# checkpoint/io.py
# ---------------------------------------------------------------------------


def _mixed_tree():
    return {
        "w": torch.tensor(np.random.default_rng(0).normal(size=(3, 5)),
                          dtype=torch.float32),
        "h": np.arange(7, dtype=np.float16),
        "steps": np.int32(17),
        "ids": torch.arange(4, dtype=torch.int8),
        "mask": np.array([True, False, True]),
        "f64": np.linspace(0, 1, 5),
        "nested": [{"b": torch.zeros((2, 2))},
                   (np.ones((3,), np.float16), None)],
    }


def test_roundtrip_bit_identical_mixed_dtypes(tmp_path):
    tree = _mixed_tree()
    ckpt_io.save_checkpoint(str(tmp_path), tree, step=3,
                            extra={"note": "x"})
    back = ckpt_io.load_checkpoint(str(tmp_path), _mixed_tree())
    assert back["nested"][1][1] is None
    for (ka, a), (kb, b) in zip(tree_leaves_with_path(tree),
                                tree_leaves_with_path(back)):
        assert ka == kb
        if isinstance(a, torch.Tensor):     # torch like leaves stay torch
            assert isinstance(b, torch.Tensor) and b.dtype == a.dtype
        else:
            assert isinstance(b, np.ndarray)
            assert b.dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert ckpt_io.checkpoint_step(str(tmp_path)) == 3
    with open(tmp_path / "manifest.json") as f:
        assert json.load(f)["extra"] == {"note": "x"}


def test_bf16_leaf_is_refused(tmp_path):
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt_io.save_checkpoint(str(tmp_path),
                                {"a": torch.ones(2, dtype=torch.bfloat16)})
    assert not ckpt_io.checkpoint_exists(str(tmp_path))


def test_load_checkpoint_rejects_missing_and_mismatched(tmp_path):
    ckpt_io.save_checkpoint(str(tmp_path), {"a": torch.ones((2,))})
    with pytest.raises(KeyError, match="missing"):
        ckpt_io.load_checkpoint(str(tmp_path),
                                {"a": torch.ones((2,)), "b": torch.ones(1)})
    with pytest.raises(ValueError, match="shape"):
        ckpt_io.load_checkpoint(str(tmp_path), {"a": torch.ones((3,))})
    with pytest.raises(ValueError, match="shape") as got:
        ckpt_io.load_checkpoint(str(tmp_path), {"a": np.ones((3,))})
    with pytest.raises(ValueError, match="shape") as want:
        jio.load_checkpoint(str(tmp_path), {"a": jnp.ones((3,))})
    assert str(got.value) == str(want.value)


def test_checkpoint_exists(tmp_path):
    assert not ckpt_io.checkpoint_exists(str(tmp_path))
    ckpt_io.save_checkpoint(str(tmp_path), {"a": torch.ones(1)})
    assert ckpt_io.checkpoint_exists(str(tmp_path))


def test_prune_spares_unrelated_npz(tmp_path):
    """A checkpoint dir may hold unrelated .npz files; saving deletes
    only its own superseded params archives."""
    other = tmp_path / "dataset.npz"
    np.savez(str(other), x=np.arange(3))
    ckpt_io.save_checkpoint(str(tmp_path), {"a": torch.ones(2)}, step=1)
    ckpt_io.save_checkpoint(str(tmp_path), {"a": torch.ones(2)}, step=2)
    assert other.exists()
    assert (tmp_path / "params-2.npz").exists()
    assert not (tmp_path / "params-1.npz").exists()


# ---------------------------------------------------------------------------
# Resume through run_federated (the port alone)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("store", ["memory", "mmap"])
@pytest.mark.parametrize("method,sampler", [
    ("fedavgm", "uniform"),      # server state + rng-driven sampling
    ("scaffold", "full"),        # client rows (the whole-population path)
])
def test_mid_training_resume_is_bit_identical(tmp_path, store, method,
                                              sampler):
    """4 rounds straight vs 2 rounds (checkpointing) + a fresh
    ``run_federated`` resuming for the last 2: final params bit-equal,
    resumed accuracies equal the straight run's tail."""
    kw = dict(store=store, chunk_size=2)
    if sampler == "uniform":
        kw.update(sampler="uniform", cohort_size=2)
    straight = _run(method, 4, **kw)
    ck = str(tmp_path / "ck")
    _run(method, 2, ck, **kw)
    assert ckpt_io.checkpoint_step(ck) == 2
    assert os.path.isdir(os.path.join(ck, "clients")) == (store == "mmap")
    resumed = _run(method, 4, ck, resume=True, **kw)
    assert resumed["round"] == [2, 3]
    assert resumed["acc"] == straight["acc"][2:]
    _assert_equal_params(resumed["final_params"], straight["final_params"])
    assert ckpt_io.checkpoint_step(ck) == 4


def test_resume_of_finished_run_reports_final_eval(tmp_path):
    """Rerunning a completed job with resume=True returns one eval of
    the restored model, trains nothing, and is idempotent."""
    ck = str(tmp_path / "ck")
    first = _run("fedavg", 2, ck)
    again = _run("fedavg", 2, ck, resume=True)
    assert again["round"] == [1]
    assert again["acc"][-1] == first["acc"][-1]
    _assert_equal_params(again["final_params"], first["final_params"])
    assert ckpt_io.checkpoint_step(ck) == 2
    np.testing.assert_array_equal(again["confusion"][-1],
                                  first["confusion"][-1])
    assert len(again["acc"]) == len(again["wall"]) == 1
    assert len(again["participants"][0]) == 0
    third = _run("fedavg", 2, ck, resume=True)
    assert third["round"] == [1] and third["acc"] == again["acc"]


def test_incremental_save_flushes_only_dirty_shards(tmp_path):
    """Round-robin over population 4 at cohort 2 with chunk_size 2:
    round 0 touches only shard 0, round 1 only shard 1, so the step-2
    manifest reuses the step-1 files for shard 0 and publishes fresh
    ``-r2`` files only for shard 1, one per reference leaf. Pruning
    keeps exactly the published set."""
    ck = str(tmp_path / "ck")
    _run("scaffold", 2, ck, store="mmap", chunk_size=2,
         sampler="round_robin", cohort_size=2)
    with open(os.path.join(ck, "manifest.json")) as f:
        manifest = json.load(f)
    cs = manifest["extra"]["client_store"]
    assert cs["layout"]["chunk_size"] == 2
    assert cs["layout"]["n_shards"] == 2
    n_leaves = len(FlatLayout(cnn_task(_cfg()).init_fn(
        torch.Generator().manual_seed(0))).slots)
    assert len(cs["layout"]["leaves"]) == n_leaves
    assert len(cs["files"]) == 2 * n_leaves
    by_shard = {c: {name.rsplit("-r", 1)[1]
                    for key, name in cs["files"].items()
                    if key.endswith(f":{c}")} for c in (0, 1)}
    assert by_shard[0] == {"1.npy"}, cs["files"]
    assert by_shard[1] == {"2.npy"}, cs["files"]
    on_disk = {n for n in os.listdir(os.path.join(ck, "clients"))
               if n.endswith(".npy")}
    assert on_disk == set(cs["files"].values())
    # an in-memory run cannot resume an incremental checkpoint
    with pytest.raises(ValueError, match="store"):
        ckpt_io.load_fl_checkpoint(ck, like_global={}, like_server={})
    # a mismatched layout (other chunking) refuses too
    other = statestore.MmapShardStore(chunk_size=4)
    other.initialize({"a": np.zeros(3, np.float32)}, 4)
    with pytest.raises(ValueError, match="layout"):
        ckpt_io.load_fl_checkpoint(ck, like_global={}, like_server={},
                                   store=other)
    other.close()


def test_checkpoint_every_validated(tmp_path):
    for bad in (0, True, 1.5):
        with pytest.raises(ValueError, match="checkpoint_every"):
            run_federated(cnn_task(_cfg()), _fl("fedavg", 2), _parts(),
                          _get_batch, _TEST_BATCHES, device="cpu",
                          checkpoint_dir=str(tmp_path),
                          checkpoint_every=bad)


def test_checkpoint_every_saves_on_schedule_and_at_the_end(tmp_path,
                                                           monkeypatch):
    steps = []
    orig = ckpt_io.save_fl_checkpoint

    def spy(path, **kw):
        steps.append(kw["round_idx"])
        return orig(path, **kw)

    monkeypatch.setattr(ckpt_io, "save_fl_checkpoint", spy)
    run_federated(cnn_task(_cfg()), _fl("fedavg", 5), _parts(), _get_batch,
                  _TEST_BATCHES, device="cpu", checkpoint_dir=str(tmp_path),
                  checkpoint_every=2)
    assert steps == [2, 4, 5]


def test_resume_without_checkpoint_starts_fresh(tmp_path):
    h = _run("fedavg", 2, str(tmp_path / "nope"), resume=True)
    assert h["round"] == [0, 1]


def test_tiered_resume_is_bit_identical(tmp_path):
    """The tier path saves every round too (tiers hold no client state):
    resumed rounds 2-3 equal the straight run's."""
    kw = dict(tiers="1.0x2,0.5x2")
    straight = _run("fedavg", 4, **kw)
    ck = str(tmp_path / "ck")
    _run("fedavg", 2, ck, **kw)
    resumed = _run("fedavg", 4, ck, resume=True, **kw)
    assert resumed["round"] == [2, 3]
    assert resumed["acc"] == straight["acc"][2:]
    _assert_equal_params(resumed["final_params"], straight["final_params"])


@pytest.mark.parametrize("kw", [dict(checkpoint_dir="x"),
                                dict(resume=True)])
def test_async_refuses_checkpointing(tmp_path, kw):
    kw = {k: (str(tmp_path / v) if k == "checkpoint_dir" else v)
          for k, v in kw.items()}
    with pytest.raises(ValueError, match="async") as got:
        run_federated(cnn_task(_cfg()), _fl("fedavg", 2, mode="async"),
                      _parts(), _get_batch, _TEST_BATCHES, device="cpu",
                      **kw)
    with pytest.raises(ValueError, match="async") as want:
        jruntime.run_federated(
            jruntime.cnn_task(jvgg9.reduced(n_classes=10, fed2_groups=0,
                                            norm="none")),
            _fl("fedavg", 2, jruntime.FLConfig, mode="async"), _parts(),
            _jget_batch, _TEST_BATCHES, mesh=None, **kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The reference's format
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jinit():
    """The reference's init (numpy, HWIO convs)."""
    return jax.tree_util.tree_map(
        np.asarray, jruntime.cnn_task(jvgg9.reduced(
            n_classes=10, fed2_groups=0,
            norm="none")).init_fn(jax.random.PRNGKey(0)))


def _jkeys(tree):
    return [("/".join(str(p) for p in path), np.shape(leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _tkeys(tree):
    return [(k, np.shape(v)) for k, v in tree_leaves_with_path(tree)]


@pytest.mark.parametrize("method", tmethods.available())
def test_path_keys_match_jax(method):
    """The port's state, converted to the reference's layout, carries
    jax's keys and shapes in jax's order: the VGG9 params, the method's
    server tree and its client row."""
    grouped = tmethods.get(method).uses_groups
    tcfg = vgg9.reduced() if grouped else _cfg()
    jcfg = (jvgg9.reduced() if grouped
            else jvgg9.reduced(n_classes=10, fed2_groups=0, norm="none"))
    jtask = jruntime.cnn_task(jcfg)
    jparams = jtask.init_fn(jax.random.PRNGKey(0))
    fl = dict(population=4, rounds=1, method=method)
    jeng = jmake_round_engine(jtask, jruntime.FLConfig(**fl), jparams)
    tparams = convert.to_port(jax.tree_util.tree_map(np.asarray, jparams))
    teng = make_round_engine(cnn_task(tcfg), FLConfig(**fl), tparams,
                             device="cpu")
    flat = teng.layout.flatten(tparams)
    state = {"global": flat, "server": teng.init_server_state(flat),
             "clients": teng.init_client_row(flat)}
    jstate = {"global": jparams, "server": jeng.init_server_state(jparams),
              "clients": jeng.init_client_row(jparams)}
    ref = convert.flat_to_reference(state, teng.layout)
    assert _tkeys(ref) == _jkeys(jstate)
    for (_, a), (_, b) in zip(tree_leaves_with_path(ref),
                              jax.tree_util.tree_flatten_with_path(
                                  jstate)[0]):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert jmethods.available() == tmethods.available()


def test_flat_state_round_trips_through_the_reference_layout():
    """flat -> reference -> flat is the identity for a global vector,
    stacked (P, M) rows (numpy and torch) and a server tree with a
    scalar; stacked rows' convs go 5-D HWIO, each row equal to the
    per-tree conversion of that row."""
    params = convert.to_port(_jinit())
    layout = FlatLayout(params)
    g = torch.Generator().manual_seed(1)
    flat = layout.flatten(params)
    rows = torch.randn((3, layout.size), generator=g)
    state = {"g": flat, "rows": rows, "np_rows": rows.numpy().copy(),
             "server": {"m": torch.randn(layout.size, generator=g),
                        "t": torch.tensor(3.0)}}
    ref = convert.flat_to_reference(state, layout)
    for key, leaf in tree_leaves_with_path(ref["g"]):
        want = dict(tree_leaves_with_path(_jinit()))[key]
        np.testing.assert_array_equal(leaf, want)
    per_row = convert.to_reference(layout.unflatten(rows[1]))
    for (_, a), (_, b) in zip(tree_leaves_with_path(ref["rows"]),
                              tree_leaves_with_path(per_row)):
        np.testing.assert_array_equal(a[1], b)
    back = convert.flat_from_reference(ref, state, layout)
    assert torch.equal(back["g"], flat)
    assert back["g"].stride() == flat.stride()
    assert torch.equal(back["rows"], rows)
    assert isinstance(back["np_rows"], np.ndarray)
    np.testing.assert_array_equal(back["np_rows"], state["np_rows"])
    assert torch.equal(back["server"]["m"], state["server"]["m"])
    assert back["server"]["t"].item() == 3.0
    stacked = convert.stacked_to_reference(layout.unflatten(rows))
    again = convert.stacked_to_port(stacked)
    for a, b in zip(tree_leaves(again), tree_leaves(layout.unflatten(rows))):
        assert torch.equal(a, b)


def _jax_runs(store, sampler, rounds, ck=None, resume=False):
    kw = dict(store=store, chunk_size=2)
    if sampler == "uniform":
        kw.update(sampler="uniform", cohort_size=2)
    return jruntime.run_federated(
        jruntime.cnn_task(jvgg9.reduced(n_classes=10, fed2_groups=0,
                                        norm="none")),
        _fl("scaffold", rounds, jruntime.FLConfig, **kw), _parts(),
        _jget_batch, _TEST_BATCHES, mesh=None, use_kernel=False,
        checkpoint_dir=ck, resume=resume)


def _port_runs(store, sampler, rounds, ck=None, resume=False):
    kw = dict(store=store, chunk_size=2)
    if sampler == "uniform":
        kw.update(sampler="uniform", cohort_size=2)
    return run_federated(cnn_task(_cfg()), _fl("scaffold", rounds, **kw),
                         _parts(), _get_batch, _TEST_BATCHES, device="cpu",
                         init_params=convert.to_port(_jinit()),
                         checkpoint_dir=ck, resume=resume)


def _assert_close(port, ref):
    """A port history against a reference history of the same rounds."""
    assert port["round"] == list(ref["round"])
    np.testing.assert_allclose(port["acc"], np.asarray(ref["acc"]),
                               atol=1.0 / N_TEST + 1e-9)
    got = convert.to_reference(port["final_params"])
    want = jax.tree_util.tree_map(np.asarray, ref["final_params"])
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(fg) == len(fw)
    for (path, a), (_, b) in zip(fg, fw):
        np.testing.assert_allclose(a, b, atol=PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))


STORE_CASES = [("memory", "full"), ("mmap", "full"), ("mmap", "uniform")]


@functools.lru_cache(maxsize=None)
def _jax_straight(store, sampler):
    return _jax_runs(store, sampler, 4)


@pytest.mark.parametrize("store,sampler", STORE_CASES)
def test_jax_checkpoint_resumes_in_the_port(tmp_path, store, sampler):
    ck = str(tmp_path / "ck")
    _jax_runs(store, sampler, 2, ck)
    assert os.path.isdir(os.path.join(ck, "clients")) == (store == "mmap")
    resumed = _port_runs(store, sampler, 4, ck, resume=True)
    straight = _jax_straight(store, sampler)
    tail = {k: straight[k][2:] for k in ("round", "acc")}
    _assert_close(resumed, {**tail,
                            "final_params": straight["final_params"]})
    assert ckpt_io.checkpoint_step(ck) == 4


@pytest.mark.parametrize("store,sampler", STORE_CASES)
def test_port_checkpoint_resumes_in_jax(tmp_path, store, sampler):
    ck = str(tmp_path / "ck")
    _port_runs(store, sampler, 2, ck)
    # the reference's own loader reads the port's files
    if store == "mmap":
        with open(os.path.join(ck, "manifest.json")) as f:
            cs = json.load(f)["extra"]["client_store"]
        jst = jstore.MmapShardStore(chunk_size=2)
        jst.initialize(jax.tree_util.tree_map(np.zeros_like, _jinit()), 4)
        assert jst.layout() == cs["layout"]
        jst.restore_shards(os.path.join(ck, "clients"), cs)
        jst.close()
    resumed = _jax_runs(store, sampler, 4, ck, resume=True)
    straight = _port_runs(store, sampler, 4)
    tail = {k: straight[k][2:] for k in ("round", "acc")}
    _assert_close({**tail, "final_params": straight["final_params"]},
                  {"round": resumed["round"], "acc": resumed["acc"],
                   "final_params": resumed["final_params"]})


def test_checkpoint_manifest_matches_the_reference(tmp_path):
    """The same state saved by each package: the same keys, shapes,
    dtypes and arrays."""
    params = convert.to_port(_jinit())
    layout = FlatLayout(params)
    flat = layout.flatten(params)
    ckpt_io.save_checkpoint(str(tmp_path / "t"), {
        "global": convert.flat_to_reference(flat, layout),
        "server": {"t": torch.zeros(())}}, step=1)
    jio.save_checkpoint(str(tmp_path / "j"), {
        "global": jax.tree_util.tree_map(jnp.asarray, _jinit()),
        "server": {"t": jnp.zeros((), jnp.float32)}}, step=1)
    man = [json.load(open(tmp_path / d / "manifest.json")) for d in "tj"]
    assert man[0] == man[1]
    with np.load(tmp_path / "t" / "params-1.npz") as a, \
            np.load(tmp_path / "j" / "params-1.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
