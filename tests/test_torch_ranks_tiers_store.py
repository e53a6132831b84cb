"""Capacity tiers, the ``mmap`` client store and FL checkpoints on a mesh
of ranks (``run_federated(mesh=RankMesh)``), on 2 "data" ranks
(``launch.mesh.spawn``, gloo, ``device="cpu"``, every case in one
spawn) against the port's one-process run and the reference's
``mesh=None`` run, on the CLI's reduced VGG9 (tests/ranks_parity.py: 2
local steps of batch 8, 200 training examples) from the reference's
initial parameters.

- Tiers: fed2 ``1.0x2,0.6x2,0.2x2`` and fedavg ``1.0x2,0.5x2,0.25x2``
  over 6 clients, each tier's 2-row tile split 1 + 1, and fedavg
  ``1.0x2,0.5x2,0.25x1`` over 5, whose 1-client tile runs whole on
  both ranks with no collective; 2 rounds.
- ``--store mmap`` under scaffold (6 clients, 4 a round, uniform
  sampler, 2 rows a shard): equal to the memory store on the same
  ranks to the bit, each rank mapping shards of its own.
- Checkpoints, fed2 on the memory store and scaffold on mmap: 1 round
  saved, then resumed to 2, equal to the uninterrupted 2-rank run to
  the bit; rank 0's checkpoint holds a one-process checkpoint's files
  and keys, and one process, and the reference, resume it.

Tolerances (tests/test_torch_ranks_axes.py's): each leaf within
``RTOL`` = 1e-5 of its largest magnitude in the one-process run; the
tiers each round from the same state (round 2 from a one-process
checkpoint: the test says why), the mmap store after 2 rounds or
within twice what one ulp of the init does to one process
(``ranks_parity.within_spread``); the first round against the
reference the same, the ulp run's first round the spread; one process
resuming the ranks' checkpoint for a round within RTOL of the
uninterrupted ranks, the reference reading it to the bit.
"""
import dataclasses
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ranks_parity as rp
import torch_ranks
from repro.fl import runtime as jrt
from repro_torch.configs import vgg9
from repro_torch.fl import capacity, statestore
from repro_torch.fl.population import Population
from repro_torch.fl.runtime import FLConfig, cnn_task
from repro_torch.launch.mesh import RankMesh

STORE = ("--nodes", "6", "--cohort-size", "4", "--sampler", "uniform")
MMAP = STORE + ("--store", "mmap", "--chunk-size", "2")
# name -> (method, flags, held against the reference)
RUNS = {
    "fed2-tiers": ("fed2", ("--nodes", "6", "--tiers", "1.0x2,0.6x2,0.2x2"),
                   True),
    "fedavg-tiers": ("fedavg", ("--nodes", "6", "--tiers",
                                "1.0x2,0.5x2,0.25x2"), True),
    "fedavg-tier-of-one": ("fedavg", ("--tiers", "1.0x2,0.5x2,0.25x1"),
                           True),
    "scaffold-mmap": ("scaffold", MMAP, True),
    "scaffold-memory": ("scaffold", STORE, False),
}
TIERS = ("fed2-tiers", "fedavg-tiers", "fedavg-tier-of-one")
# all-reduces a round: one a tier whose tile splits, one eval
TIER_REDUCES = {"fed2-tiers": 4, "fedavg-tiers": 4, "fedavg-tier-of-one": 3}
# checkpointed runs: name -> (method, flags)
CKPT = {"fed2-memory": ("fed2", ()), "scaffold-mmap": ("scaffold", MMAP)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(method, flags, rounds=rp.ROUNDS, **extra):
    return {"argv": rp.argv(method, flags, rounds), "eval_batch":
            rp.EVAL_BATCH, "init": rp.init(method, flags), **extra}


def _ckpt_cases(tmp):
    """Per CKPT run: 1 round saved (rank 0 then snapshots it), 2 rounds
    resumed from it, 2 rounds straight with their own checkpoint."""
    out = []
    for name, (method, flags) in CKPT.items():
        ck = os.path.join(tmp, name)
        out += [_case(method, flags, 1, kw={"checkpoint_dir": ck},
                      snapshot=ck + "-round1"),
                _case(method, flags, kw={"checkpoint_dir": ck,
                                         "resume": True}),
                _case(method, flags, kw={"checkpoint_dir": ck + "-full"})]
    return out


def _round2_cases(tmp):
    """Per tier run: round 2 on the ranks from the one-process run's
    round-1 checkpoint (written here, before the spawn)."""
    out = []
    for name in TIERS:
        method, flags, _ = RUNS[name]
        ck = os.path.join(tmp, f"{name}-one-round1")
        torch_ranks.run_fl(rp.argv(method, flags, 1), rp.EVAL_BATCH,
                           rp.init(method, flags), checkpoint_dir=ck)
        out.append(_case(method, flags, kw={"checkpoint_dir": ck,
                                            "resume": True}))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every run and checkpoint on 2 ranks in one spawn, the
    one-process runs and the reference's beside it."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    cases = ([_case(m, f) for m, f, _ in RUNS.values()] + _ckpt_cases(tmp)
             + _round2_cases(tmp))
    got = rp.spawn_beside(torch_ranks.cases_specs_rank,
                          (cases, [], os.path.join(tmp, "records")),
                          RUNS.values(), spread=True)
    runs = [r["runs"] for r in got]
    n, k = len(RUNS), len(RUNS) + 3 * len(CKPT)
    ckpt = {name: {part: [r[n + 3 * i + j] for r in runs]
                   for j, part in enumerate(("first", "resumed",
                                             "straight"))}
            for i, name in enumerate(CKPT)}
    return {"runs": {name: [r[i] for r in runs]
                     for i, name in enumerate(RUNS)},
            "round2": {name: [r[k + i] for r in runs]
                       for i, name in enumerate(TIERS)},
            "ckpt": ckpt, "tmp": tmp}


def _round1_within(got, method, flags):
    """A rank's round-1 global against the reference's round: each leaf
    within RTOL of its largest magnitude, or twice what one ulp of the
    init does to the one-process port's first round."""
    want = rp.reference(method, flags)
    one = rp.ref_tree(rp.one_process(method, flags)["globals"][0])
    ulp = rp.ref_tree(rp.one_ulp(method, flags)["globals"][0])
    fg = jax.tree_util.tree_flatten_with_path(rp.ref_tree(got))[0]
    for (path, a), b, o, u in zip(fg, jax.tree_util.tree_leaves(want),
                                  jax.tree_util.tree_leaves(one),
                                  jax.tree_util.tree_leaves(ulp)):
        err, scale = np.abs(a - b).max(), np.abs(b).max()
        assert err <= max(rp.RTOL * scale, 2 * np.abs(u - o).max()), (
            jax.tree_util.keystr(path), err, scale)


@pytest.mark.parametrize("name", TIERS)
def test_tiers_on_ranks_match_one_process(ranks, name):
    """Each round within RTOL of one process's from the same state:
    round 1 from the init, round 2 from the one-process round-1
    checkpoint. (The ranks' own round 2 starts from their round-1
    round-off: measured, it moves 2 of the 40 coordinates of fed2's
    second conv bias and norm bias by 1.5e-3 of the leaf's largest,
    where an ulp of the init, up, down or scaled, moves every leaf by
    1.1e-6 at most, and the ranks' round 2 from the one-process state
    lies 3.1e-7 from one process: a ReLU or pool decision that this
    round-off crosses and the init's ulp does not.)"""
    method, flags, _ = RUNS[name]
    a, b = ranks["runs"][name]
    assert len(a["globals"]) == rp.ROUNDS
    for x, y in zip(a["globals"], b["globals"]):
        assert rp.same_bits(x, y)
    assert rp.same_bits(a["final"], b["final"]) and a["acc"] == b["acc"]
    one = rp.one_process(method, flags)
    rp.within(rp.ref_tree(a["globals"][0]), rp.ref_tree(one["globals"][0]))
    r2, r2b = ranks["round2"][name]
    assert rp.same_bits(r2["final"], r2b["final"])
    rp.within(rp.ref_tree(r2["final"]), rp.ref_tree(one["final"]))
    np.testing.assert_allclose(a["acc"], one["acc"],
                               atol=1.0 / (rp.TRAIN // 4) + 1e-9)


@pytest.mark.parametrize("name", TIERS)
def test_tiers_on_ranks_match_reference(ranks, name):
    method, flags, _ = RUNS[name]
    _round1_within(ranks["runs"][name][0]["globals"][0], method, flags)


@pytest.mark.parametrize("name", TIERS)
def test_tier_collectives_per_round(ranks, name):
    """Each tier whose tile splits all-reduces its within-tier mean once
    a round; a 1-client tile runs whole on both ranks and runs none; the
    eval all-reduces once."""
    for r in ranks["runs"][name]:
        assert r["collectives"]["calls"] == {
            "all_reduce": TIER_REDUCES[name] * rp.ROUNDS, "all_to_all": 0,
            "all_gather": 0}


def _mesh(coord):
    return RankMesh(("data", "model"), (2, 1), rank=coord,
                    coords=(coord, 0), groups=(None, None))


def test_a_tile_narrower_than_data_runs_whole_on_every_rank():
    """On a rank, each tier's engine holds its block of the tile's rows,
    but a 1-row tile holds the row whole, with no shard; every engine
    fuses on the mesh's route (no kernel)."""
    task = cnn_task(vgg9.reduced(fed2_groups=0, norm="none"))
    fl = FLConfig(population=5, method="fedavg", tiers="1.0x2,0.5x2,0.25x1")
    params = task.init_fn(torch.Generator())
    plan = capacity.TierPlan.from_mix(fl.tiers, fl.population, seed=0)
    for coord in (0, 1):
        tiered = capacity.make_tiered_engine(task, fl, params, plan,
                                             device="cpu",
                                             mesh=_mesh(coord))
        got = [(t.engine.rows, t.engine.ctx.shard is None)
               for t in tiered.tiles]
        assert got == [(slice(coord, coord + 1), False)] * 2 + \
            [(slice(0, 1), True)]
        assert not any(t.engine.ctx.use_kernel for t in tiered.tiles)
        assert tiered.full.rows == slice(3 * coord, 3 + 2 * coord)


def test_mmap_on_ranks_is_memory_on_ranks_to_the_bit(ranks):
    for m, k in zip(ranks["runs"]["scaffold-mmap"],
                    ranks["runs"]["scaffold-memory"]):
        for key in ("final", "server", "clients"):
            assert rp.same_bits(m[key], k[key]), key
        assert m["acc"] == k["acc"]
        assert m["collectives"] == k["collectives"]


def test_mmap_on_ranks_matches_one_process_and_reference(ranks):
    method, flags, _ = RUNS["scaffold-mmap"]
    a, b = ranks["runs"]["scaffold-mmap"]
    assert rp.same_bits(a["final"], b["final"])
    assert rp.same_bits(a["clients"], b["clients"])
    rp.within_spread(a["final"], method, flags)
    _round1_within(a["globals"][0], method, flags)


@pytest.mark.parametrize("with_dir", [True, False], ids=["dir", "temp"])
def test_ranks_keep_a_store_each(tmp_path, with_dir):
    """Two ranks' mmap stores never share a shard file: with a directory
    each maps ``<dir>/rank<r>``, without one a temporary directory of
    its own; initialize, offload_aux and close act on it alone."""
    stores = [statestore.get("mmap", chunk_size=2, rank=r,
                             dir=str(tmp_path) if with_dir else None)
              for r in (0, 1)]
    row = {"c": np.arange(3, dtype=np.float32)}
    for r, st in enumerate(stores):
        pop = Population.from_parts([np.arange(2)] * 5)
        pop.use_store(st)
        pop.initialize(row)
        pop.scatter([r], {"c": np.full((1, 3), r + 1, np.float32)})
        assert os.path.basename(st.dir).startswith(
            "rank" if with_dir else f"repro-torch-statestore-rank{r}-")
    dirs = [st.dir for st in stores]
    assert dirs[0] != dirs[1]
    if with_dir:
        assert dirs == [str(tmp_path / "rank0"), str(tmp_path / "rank1")]
    for r, st in enumerate(stores):
        got = st.gather([0, 1])["c"]
        np.testing.assert_array_equal(got[r], np.full(3, r + 1))
        np.testing.assert_array_equal(got[1 - r], np.arange(3))
        assert sorted(os.listdir(st.dir)) == sorted(
            [f"leaf0-c{c}.npy" for c in range(3)]
            + [f"aux-{n}.npy" for n in ("parts-flat", "parts-offsets",
                                        "weights")])
    for st, d in zip(stores, dirs):
        st.close()
        assert os.path.isdir(d) == with_dir


@pytest.mark.parametrize("name", list(CKPT))
def test_resumed_ranks_run_is_the_uninterrupted_run(ranks, name):
    c = ranks["ckpt"][name]
    for resumed, straight in zip(c["resumed"], c["straight"]):
        assert rp.same_bits(resumed["final"], straight["final"])
        assert rp.same_bits(resumed["server"], straight["server"])
        assert rp.same_bits(resumed["clients"], straight["clients"])
        assert resumed["acc"] == straight["acc"][1:]
    # the run that saved after round 1 is the straight run's first round
    assert rp.same_bits(c["first"][0]["final"],
                        c["straight"][0]["globals"][0])
    # rank 0 publishes each save and every rank waits for it: one
    # barrier once the resume is read, one a save
    for part, saves in (("first", 1), ("resumed", 1), ("straight", 2)):
        for r in c[part]:
            assert r["collectives"]["calls"]["barrier"] == 1 + saves


@functools.lru_cache(maxsize=None)
def _one_process_checkpoint(name, tmp):
    """A one-process run of 1 round of ``name`` with a checkpoint: its
    directory's listing."""
    method, flags = CKPT[name]
    ck = os.path.join(tmp, f"{name}-one")
    torch_ranks.run_fl(rp.argv(method, flags, 1), rp.EVAL_BATCH,
                       rp.init(method, flags), checkpoint_dir=ck)
    return torch_ranks.checkpoint_listing(ck)


@pytest.mark.parametrize("name", list(CKPT))
def test_ranks_checkpoint_is_a_one_process_checkpoint(ranks, name):
    """The files and manifest rank 0 wrote after round 1 (the params
    archive, the mmap store's shard files), seen the same from both
    ranks, and a one-process run's after round 1: the same files, keys,
    shapes, dtypes and rng state."""
    a, b = (r["checkpoint"] for r in ranks["ckpt"][name]["first"])
    assert a == b
    one = _one_process_checkpoint(name, ranks["tmp"])
    assert a["files"] == one["files"]
    assert any(f.startswith("clients/") for f in a["files"]) == \
        (name == "scaffold-mmap")
    ma, mo = a["manifest"], one["manifest"]
    for key in ("step", "params_file", "keys", "shapes", "dtypes"):
        assert ma[key] == mo[key], key
    assert ma["extra"] == mo["extra"]


def _copy(ranks, name, tag):
    src = os.path.join(ranks["tmp"], f"{name}-round1")
    dst = os.path.join(ranks["tmp"], f"{name}-{tag}")
    if not os.path.exists(dst):
        shutil.copytree(src, dst)
    return dst


@pytest.mark.parametrize("name", list(CKPT))
def test_one_process_resumes_a_ranks_checkpoint(ranks, name):
    """One process resumes rank 0's round-1 checkpoint and runs round 2
    within RTOL of the uninterrupted ranks."""
    method, flags = CKPT[name]
    ck = _copy(ranks, name, "one")
    got = torch_ranks.run_fl(rp.argv(method, flags), rp.EVAL_BATCH,
                             rp.init(method, flags), checkpoint_dir=ck,
                             resume=True)
    straight = ranks["ckpt"][name]["straight"][0]
    assert len(got["acc"]) == 1
    rp.within(rp.ref_tree(got["final"]), rp.ref_tree(straight["final"]))


@pytest.mark.parametrize("name", list(CKPT))
def test_reference_resumes_a_ranks_checkpoint(ranks, name):
    """The reference's ``run_federated(resume=True)`` reads rank 0's
    round-1 checkpoint (its mmap shards included, against its own
    store's layout): a finished 1-round run, whose final params are the
    ranks' round-1 global to the bit."""
    method, flags = CKPT[name]
    ck = _copy(ranks, name, "reference")
    _, fl, parts, get_batch, test, _ = torch_ranks.fl_inputs(
        rp.argv(method, flags, 1), rp.EVAL_BATCH)
    names = {f.name for f in dataclasses.fields(jrt.FLConfig)}
    jfl = jrt.FLConfig(**{f.name: getattr(fl, f.name)
                          for f in dataclasses.fields(fl)
                          if f.name in names})
    h = jrt.run_federated(
        jrt.cnn_task(rp.reference_model(method, flags)), jfl, parts,
        lambda s: {k: jnp.asarray(v) for k, v in get_batch(s).items()},
        test, mesh=None, use_kernel=False, checkpoint_dir=ck, resume=True)
    assert list(h["round"]) == [0]
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        np.asarray, h["final_params"]))
    want = jax.tree_util.tree_leaves(rp.ref_tree(
        ranks["ckpt"][name]["first"][0]["final"]))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
