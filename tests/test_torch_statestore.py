"""The port's client-state stores (``repro_torch.fl.statestore``), case
for case with tests/test_statestore.py: the registry and
``FLConfig``/``ScenarioSpec`` validation (the reference's messages), the
row semantics of both stores, adopt, the mmap store's tree refusal,
per-shard dirty tracking, disk layout and close, ``offload_aux`` and
``ShardIndices``; then ``run_federated`` through ``memory`` and ``mmap``
giving the same history and final params to the bit (scaffold rows,
fedavgm under the weighted sampler, a stateless round-robin run, fed2
with presence rows). The mmap store's ``layout()`` of a flat scaffold
row equals the reference store's of the same row as a params tree.

Everything runs on the CPU at reduced VGG9; bit-identity needs no
tolerance (both stores hand the engine the same float32 rows).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.fl import runtime as jruntime
from repro.fl import scenarios as jscen
from repro.fl import statestore as jstore
from repro_torch import convert
from repro_torch.configs import vgg9
from repro_torch.core.grouping import GroupSpec
from repro_torch.data.synthetic import make_image_dataset, nxc_partition
from repro_torch.fl import scenarios as tscen
from repro_torch.fl import statestore
from repro_torch.fl.population import Population
from repro_torch.fl.runtime import FLConfig, cnn_task, run_federated
from repro_torch.models.module import FlatLayout, tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_DS = make_image_dataset(240, n_classes=4, seed=0, noise=0.8)
_TEST = make_image_dataset(80, n_classes=4, seed=9, noise=0.8)


def _get_batch(sel):
    return {"images": _DS.images[sel], "labels": _DS.labels[sel]}


_TEST_BATCHES = [{"images": _TEST.images, "labels": _TEST.labels}]


def _plain_cfg():
    return vgg9.reduced(n_classes=4, fed2_groups=0, norm="none")


def _fl(method, store, *, population=6, cohort_size=None, sampler="full",
        rounds=3, chunk_size=2, momentum=0.9):
    return FLConfig(population=population, cohort_size=cohort_size,
                    sampler=sampler, rounds=rounds, local_epochs=1,
                    steps_per_epoch=2, batch_size=8, lr=0.02,
                    momentum=momentum, method=method, seed=0,
                    store=store, chunk_size=chunk_size)


def _row_tree():
    return {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.asarray(1.5, np.float64)}


def _message(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# Registry + FLConfig / ScenarioSpec validation
# ---------------------------------------------------------------------------


def test_store_registry_contents():
    avail = statestore.available()
    assert avail == jstore.available() == ("memory", "mmap")
    for name in avail:
        st = statestore.get(name, chunk_size=4)
        assert isinstance(st, statestore.ClientStateStore)
        assert st.summary == jstore.get(name).summary
        assert (st.in_memory, st.incremental) == (name == "memory",
                                                  name == "mmap")
        st.close()


def test_get_unknown_store_lists_available():
    with pytest.raises(ValueError, match="memory"):
        statestore.get("not-a-store")
    assert (_message(statestore.get, "not-a-store")
            == _message(jstore.get, "not-a-store"))


@pytest.mark.parametrize("kw", [dict(store="mmpa"), dict(chunk_size=0),
                                dict(chunk_size=True),
                                dict(chunk_size=2.0)])
def test_flconfig_validates_store_and_chunk_size(kw):
    got = _message(FLConfig, population=4, **kw)
    want = _message(jruntime.FLConfig, population=4, **kw)
    assert got is not None and got == want
    assert ("store" in got) if "store" in kw else ("chunk_size" in got)
    for name in statestore.available():
        assert FLConfig(population=4, store=name, chunk_size=2).store == name


def test_mmap_store_validates_chunk_size():
    with pytest.raises(ValueError, match="chunk_size"):
        statestore.MmapShardStore(chunk_size=0)
    assert (_message(statestore.MmapShardStore, chunk_size=-1)
            == _message(jstore.MmapShardStore, chunk_size=-1))


def test_scenario_spec_validates_store():
    kw = dict(name="x", summary="s", protocol="iid", method="fedavg",
              store="nope")
    got = _message(tscen.ScenarioSpec, **kw)
    assert got is not None and "store" in got
    assert got == _message(jscen.ScenarioSpec, **kw)
    spec = tscen.get("nxc2_fedavg").override(store="mmap", chunk_size=3)
    cfg = spec.fl_config()
    assert (cfg.store, cfg.chunk_size) == ("mmap", 3)


# ---------------------------------------------------------------------------
# Row semantics: gather/scatter/adopt across both stores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["memory", "mmap"])
def test_gather_scatter_row_semantics(name):
    """Untouched rows keep their values bit for bit; scattered rows read
    back exactly; gather stacks in id order; torch rows scatter too."""
    st = statestore.get(name, chunk_size=4)
    row = _row_tree()
    st.initialize(row, 10)
    ids = np.array([0, 3, 9])
    g = st.gather(ids)
    assert g["a"].shape == (3, 2, 3) and g["b"].shape == (3,)
    assert isinstance(g["a"], np.ndarray)
    for i in range(3):
        np.testing.assert_array_equal(g["a"][i], row["a"])
    g["a"] = torch.from_numpy(
        g["a"] + np.arange(3, dtype=np.float32)[:, None, None])
    st.scatter(ids, g)
    back = st.gather(np.arange(10))
    for i, delta in zip(ids, (0.0, 1.0, 2.0)):
        np.testing.assert_array_equal(back["a"][i], row["a"] + delta)
    for i in set(range(10)) - set(ids.tolist()):
        np.testing.assert_array_equal(back["a"][i], row["a"])
    st.close()


@pytest.mark.parametrize("name", ["memory", "mmap"])
def test_adopt_round_trips_full_stack(name):
    st = statestore.get(name, chunk_size=3)
    st.initialize(_row_tree(), 7)
    stack = {"a": np.random.default_rng(0).normal(
        size=(7, 2, 3)).astype(np.float32),
        "b": np.arange(7, dtype=np.float64)}
    st.adopt(stack)
    got = st.gather(np.arange(7))
    np.testing.assert_array_equal(got["a"], stack["a"])
    np.testing.assert_array_equal(got["b"], stack["b"])
    st.close()


def test_memory_store_copies_an_adopted_device_tree_once():
    """The whole-population fast path hands the store the engine's
    tensors; a later scatter brings them to the host and leaves the
    adopted tensors untouched."""
    st = statestore.get("memory")
    st.initialize(np.zeros(4, np.float32), 3)
    dev = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    st.adopt(dev)
    assert st.tree is dev
    st.scatter(np.array([1]), torch.full((1, 4), -1.0))
    assert isinstance(st.tree, np.ndarray)
    np.testing.assert_array_equal(st.tree[1], -1.0)
    np.testing.assert_array_equal(st.tree[2], dev[2].numpy())
    assert dev[1, 0].item() == 4.0


def test_mmap_store_refuses_full_tree():
    st = statestore.get("mmap", chunk_size=4)
    st.initialize(_row_tree(), 10)
    with pytest.raises(RuntimeError, match="gather"):
        st.tree
    st.close()


def test_mmap_adopt_rejects_wrong_population():
    st = statestore.get("mmap", chunk_size=4)
    st.initialize(_row_tree(), 10)
    with pytest.raises(ValueError, match="population"):
        st.adopt({"a": np.zeros((3, 2, 3), np.float32),
                  "b": np.zeros(3)})
    st.close()


def test_mmap_dirty_tracking_is_per_shard():
    """scatter records exactly the touched shards."""
    st = statestore.get("mmap", chunk_size=4)
    st.initialize(_row_tree(), 10)          # shards 0:[0,4) 1:[4,8) 2:[8,10)
    assert st.dirty_shards == set()
    rows = st.gather(np.array([1, 9]))
    st.scatter(np.array([1, 9]), rows)
    assert st.dirty_shards == {0, 2}
    st.close()


def test_mmap_store_disk_layout_and_close(tmp_path):
    """One .npy per (leaf, chunk); close() drops a store-owned scratch
    dir but leaves a caller-provided one alone."""
    st = statestore.MmapShardStore(chunk_size=4, dir=str(tmp_path / "s"))
    st.initialize(_row_tree(), 10)
    names = sorted(os.listdir(tmp_path / "s"))
    assert names == [f"leaf{k}-c{c}.npy" for k in (0, 1) for c in (0, 1, 2)]
    st.close()
    assert (tmp_path / "s").is_dir()        # caller-provided: kept

    owned = statestore.MmapShardStore(chunk_size=4)
    owned.initialize(_row_tree(), 10)
    d = owned.dir
    assert os.path.isdir(d)
    owned.close()
    assert not os.path.isdir(d)             # store-owned scratch: removed


def test_mmap_flat_rows_keep_one_shard_per_chunk_and_the_reference_layout():
    """A scaffold row is one flat (M,) vector: one working shard file
    per chunk, while ``layout()`` lists the reference's leaves (its
    params tree's, convs HWIO) exactly as the JAX store does for the
    same row."""
    task = cnn_task(_plain_cfg())
    params = task.init_fn(torch.Generator().manual_seed(0))
    layout = FlatLayout(params)
    row = np.arange(layout.size, dtype=np.float32)
    st = statestore.MmapShardStore(chunk_size=3)
    st.initialize(row, 7, layout)
    assert sorted(os.listdir(st.dir)) == [f"leaf0-c{c}.npy"
                                          for c in range(3)]
    ref = jstore.MmapShardStore(chunk_size=3)
    ref.initialize(convert.flat_to_reference(row, layout), 7)
    assert st.layout() == ref.layout()
    assert json.loads(json.dumps(st.layout())) == st.layout()
    np.testing.assert_array_equal(st.gather(np.array([5]))[0], row)
    st.close()
    ref.close()


def test_mmap_offload_aux_preserves_population_views():
    """offload_aux leaves parts/weights/presence rows equal (read-only
    memory maps)."""
    parts = nxc_partition(_DS.labels, 6, 2, 4, seed=1)
    gw = np.random.default_rng(0).random((6, 2))
    pop = Population.from_parts(parts, group_weights=gw)
    w_before = np.array(pop.weights)
    st = statestore.get("mmap", chunk_size=4)
    pop.use_store(st)
    assert pop.store is st
    assert isinstance(pop.parts, statestore.ShardIndices)
    assert len(pop.parts) == pop.size == 6
    for i in range(6):
        np.testing.assert_array_equal(np.sort(pop.parts[i]),
                                      np.sort(parts[i]))
    np.testing.assert_array_equal(np.asarray(pop.weights), w_before)
    np.testing.assert_array_equal(np.asarray(pop.group_weights), gw)
    assert not np.asarray(pop.weights).flags.writeable
    st.close()


def test_population_defaults_to_the_memory_store():
    pop = Population.from_parts([np.arange(3), np.arange(2)])
    assert isinstance(pop.store, statestore.InMemoryStore)
    pop.initialize({"c": np.ones(2, np.float32)})
    np.testing.assert_array_equal(pop.clients["c"], np.ones((2, 2)))
    si = statestore.ShardIndices.from_parts([np.arange(3), np.arange(0)])
    np.testing.assert_array_equal(Population.from_parts(si).weights,
                                  [3.0, 1.0])


# ---------------------------------------------------------------------------
# ShardIndices
# ---------------------------------------------------------------------------


def test_shard_indices_from_parts_round_trip():
    parts = [np.array([3, 1]), np.array([], np.int64), np.array([0, 2, 4])]
    si = statestore.ShardIndices.from_parts(parts)
    assert len(si) == 3
    np.testing.assert_array_equal(si.lengths(), [2, 0, 3])
    for i, p in enumerate(parts):
        np.testing.assert_array_equal(si[i], p)
    np.testing.assert_array_equal(
        np.concatenate(list(si)), np.concatenate(parts))
    assert statestore.ShardIndices.from_parts(si) is si


@pytest.mark.parametrize("n,p", [(30, 7), (5, 8), (100, 100), (3, 1)])
def test_shard_indices_striped_partitions_every_sample(n, p):
    si = statestore.ShardIndices.striped(n, p)
    ref = jstore.ShardIndices.striped(n, p)
    np.testing.assert_array_equal(si.flat, ref.flat)
    np.testing.assert_array_equal(si.offsets, ref.offsets)
    assert len(si) == p
    allidx = np.sort(np.concatenate([si[i] for i in range(p)]))
    np.testing.assert_array_equal(allidx, np.arange(n))
    for i in range(p):
        assert (si[i] % p == i).all()


# ---------------------------------------------------------------------------
# Store equivalence through run_federated
# ---------------------------------------------------------------------------


def _history_sig(h):
    return json.dumps({
        "round": h["round"],
        "acc": [float(a) for a in h["acc"]],
        "per_class": [np.asarray(r).tolist() for r in h["per_class_acc"]],
        "confusion": [np.asarray(c).tolist() for c in h["confusion"]],
        "participants": [np.asarray(p).tolist()
                         for p in h["participants"]]})


def _assert_same_run(a, b):
    assert _history_sig(a) == _history_sig(b)
    for x, y in zip(tree_leaves(a["final_params"]),
                    tree_leaves(b["final_params"])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("method,sampler,cohort", [
    ("scaffold", "uniform", 4),      # per-client control variates
    ("scaffold", "full", None),      # the whole-population path (memory)
    ("fedavgm", "weighted", 4),      # server state + alias-table sampling
    ("fedavg", "round_robin", 3),    # stateless control
])
def test_stores_bit_identical_histories(method, sampler, cohort):
    """A run through the mmap store equals the in-memory run to the
    bit: accuracies, per-class rows, confusion, sampled cohorts, final
    params."""
    parts = nxc_partition(_DS.labels, 6, 2, 4, seed=1)
    task = cnn_task(_plain_cfg())
    runs = {store: run_federated(
        task, _fl(method, store, cohort_size=cohort, sampler=sampler),
        parts, _get_batch, _TEST_BATCHES, device="cpu")
        for store in ("memory", "mmap")}
    _assert_same_run(runs["memory"], runs["mmap"])


def test_stores_bit_identical_fed2_presence_rows():
    """fed2 with presence-weighted pairing gathers (cohort, G) presence
    rows each round: through the mmap store they come off a read-only
    memory map and must not change the run."""
    cfg = vgg9.reduced(n_classes=4, fed2_groups=2, decouple=1, norm="gn")
    parts = nxc_partition(_DS.labels, 6, 2, 4, seed=1)
    counts = np.stack([np.bincount(_DS.labels[p], minlength=4)
                       for p in parts])
    spec = GroupSpec.contiguous(2, 4)
    task = cnn_task(cfg)
    runs = {store: run_federated(
        task, _fl("fed2", store, cohort_size=4, sampler="uniform"),
        parts, _get_batch, _TEST_BATCHES, class_counts=counts,
        group_spec=spec, device="cpu")
        for store in ("memory", "mmap")}
    _assert_same_run(runs["memory"], runs["mmap"])


def test_run_closes_its_mmap_store(monkeypatch):
    """run_federated drops the store's scratch shards when it ends."""
    made = []
    orig = statestore.MmapShardStore.initialize

    def spy(self, *a, **k):
        made.append(self)
        return orig(self, *a, **k)

    monkeypatch.setattr(statestore.MmapShardStore, "initialize", spy)
    parts = nxc_partition(_DS.labels, 6, 2, 4, seed=1)
    run_federated(cnn_task(_plain_cfg()),
                  _fl("scaffold", "mmap", rounds=1, cohort_size=3,
                      sampler="uniform"),
                  parts, _get_batch, _TEST_BATCHES, device="cpu")
    assert len(made) == 1 and made[0]._dir is None
