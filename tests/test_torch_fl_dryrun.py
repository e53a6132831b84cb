"""The port's federated dry-run (``repro_torch.launch.fl_dryrun``) at the
production mesh, and its own machinery.

- The 16x16 placement rule (the leading client axis on "data", 16 ways,
  everything else replicated; an async event's (K, M) rows sharded only
  when K divides 16): every record of the pod matrix, built without the
  meta pass, holds the per-device bytes of the reference's committed
  records, quoted below (not read).
- The collectives of the port's rank program (rank 0's program of each
  case on a dry mesh, on meta): the three records predicted in PERF.md
  before the matrix first ran, fedma's all-gather equal to its
  host_gather_bytes, every kind 0 at 1x1; the no-wire branch counts
  and never reaches torch.distributed, a real mesh never takes it, and
  the dry-run leaves no process group behind.
- The meta pass's FLOP count equals FlopCounterMode's count of the same
  round run on real CPU tensors (one cnn and one lm case: both are
  integer sums over the same products).
- The data-flow trace: what an async event reads, and a wrongly
  declared read is caught.
- ``train --mode fl --dry-run`` writes the reduced-VGG9 records and
  needs no card; ``--mode lm --dry-run`` is refused with the
  reference's message; the CLI exits 1 on an ``error`` record; records
  never land under ``benchmarks/``.

Torch runs on one intra-op thread here (``_one_thread``).
"""
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.fl.async_engine import lower_async_event
from repro_torch.fl.engine import (lower_round, make_round_engine,
                                   resolve_use_kernel)
from repro_torch.fl.runtime import FLConfig
from repro_torch.launch import collectives, fl_dryrun, train
from repro_torch.launch.mesh import (AXES, DRY_GROUP, Mesh, RankMesh,
                                     make_dry_rank_mesh, make_host_mesh,
                                     make_production_mesh)

# memory.argument_bytes, memory.output_bytes of the committed record
# benchmarks/artifacts_perf/dryrun_<tag>.json, by tag (quoted, not read);
# dryrun_fl_round_fedma_lm_16x16.json is "skipped"
POD_BYTES = {
    "fl_align_pan_16x16": (15_539_560, 13_966_264),
    "fl_async_fed2_cnn_16x16": (14_792_032, 1_849_240),
    "fl_async_fed2_lm_16x16": (31_498_272, 3_937_448),
    "fl_async_fedavg_cnn_16x16": (111_728_992, 13_966_264),
    "fl_async_fedavg_lm_16x16": (44_081_184, 5_510_240),
    "fl_fast_fed2_topk_16x16": (3_423_080, 1_849_240),
    "fl_fast_fedavg_int8_16x16": (15_539_560, 13_966_264),
    "fl_robust_fed2_trimmed_mean_16x16": (3_423_144, 1_849_240),
    "fl_robust_fedavg_coordinate_median_16x16": (15_539_624, 13_966_264),
    "fl_round_fed2_cnn_16x16": (3_423_080, 1_849_240),
    "fl_round_fed2_lm_16x16": (4_035_904, 3_937_448),
    "fl_round_fedadam_cnn_16x16": (43_471_804, 41_898_804),
    "fl_round_fedadam_lm_16x16": (16_628_804, 16_530_732),
    "fl_round_fedavg_cnn_16x16": (15_539_560, 13_966_264),
    "fl_round_fedavg_lm_16x16": (5_608_512, 5_510_240),
    "fl_round_fedavgm_cnn_16x16": (29_505_680, 27_932_528),
    "fl_round_fedavgm_lm_16x16": (11_118_656, 11_020_480),
    "fl_round_fedma_cnn_16x16": (15_539_496, 13_966_264),
    "fl_round_fednova_cnn_16x16": (15_539_560, 13_966_264),
    "fl_round_fednova_lm_16x16": (5_608_512, 5_510_240),
    "fl_round_fedprox_cnn_16x16": (15_539_560, 13_966_264),
    "fl_round_fedprox_lm_16x16": (5_608_512, 5_510_240),
    "fl_round_scaffold_cnn_16x16": (43_471_800, 41_898_792),
    "fl_round_scaffold_lm_16x16": (16_628_800, 16_530_720),
    "fl_tier_fed2_w020_16x16": (1_874_696, 301_496),
    "fl_tier_fed2_w060_16x16": (2_580_024, 1_006_824),
    "fl_tier_fed2_w100_16x16": (3_422_440, 1_849_240),
    "fl_tier_fedavg_w025_16x16": (2_452_264, 878_968),
    "fl_tier_fedavg_w050_16x16": (5_072_872, 3_499_576),
    "fl_tier_fedavg_w100_16x16": (15_539_560, 13_966_264),
}
# the same records' uplink and host-gather figures (quoted)
POD_EXTRA = {
    "fl_round_fedma_cnn_16x16": {"host_gather_bytes": 223_457_920},
    "fl_tier_fed2_w060_16x16": {"params_bytes": 1_006_584,
                                "full_params_bytes": 1_849_000,
                                "kept_groups": 6},
    "fl_tier_fedavg_w025_16x16": {"params_bytes": 878_824,
                                  "full_params_bytes": 13_966_120,
                                  "kept_groups": 0},
    "fl_fast_fed2_topk_16x16": {"uplink_bytes": 184_944,
                                "full_params_bytes": 1_849_000},
    "fl_fast_fedavg_int8_16x16": {"uplink_bytes": 3_491_602,
                                  "full_params_bytes": 13_966_120},
}
# one rank's collectives in three 16x16 records as PERF.md predicted
# them before the matrix first ran: (count, result bytes) of each kind
# issued (every other kind 0), then the bytes gloo would stage
PREDICTED = {
    "fl_round_fed2_cnn_16x16": ({"all-reduce": (1, 1_849_000)},
                                {"all-reduce": 3_698_000}),
    "fl_round_fedavg_cnn_16x16": ({"all-reduce": (1, 13_966_120)},
                                  {"all-reduce": 27_932_240}),
    "fl_robust_fedavg_coordinate_median_16x16": (
        {"all-gather": (1, 223_457_920)}, {"all-gather": 237_424_040}),
}
XLA_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")
SMOKE = dict(clients=4, local_steps=2, batch=8, seq=32)
N_CLASSES = 10          # the VGG9 cases'
LM_VOCAB = 512          # the reduced llama3.2-1b's


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """The pod matrix at the reference's defaults, built without the
    meta pass, by record file stem."""
    out = tmp_path_factory.mktemp("pod")
    fl_dryrun.run_matrix(mesh_kind="pod", outdir=str(out), verbose=False,
                         meta=False)
    return {f[len("dryrun_"):-len(".json")]: json.loads((out / f).read_text())
            for f in os.listdir(out)}


def test_pod_matrix_statuses(pod):
    statuses = sorted(r["status"] for r in pod.values())
    assert statuses == ["ok"] * 30 + ["skipped"], {
        t: r.get("error") for t, r in pod.items() if r["status"] == "error"}
    assert pod["fl_round_fedma_lm_16x16"]["status"] == "skipped"
    assert all(r["flops"] is None and r["compile_s"] is None
               for r in pod.values() if r["status"] == "ok")


@pytest.mark.parametrize("tag", sorted(POD_BYTES))
def test_pod_bytes_equal_the_committed_records(pod, tag):
    rec = pod[tag]
    assert rec["status"] == "ok", rec.get("error")
    got = (rec["memory"]["argument_bytes"], rec["memory"]["output_bytes"])
    assert got == POD_BYTES[tag]
    for k, v in POD_EXTRA.get(tag, {}).items():
        assert rec[k] == v, (k, rec[k], v)
    assert rec["use_kernel"] is False      # 256 devices: no kernel route
    assert "notes" in rec
    coll, staged = rec["collectives"], rec["collectives_staged"]
    assert list(coll) == list(staged) == list(XLA_KINDS)
    assert all(sorted(v) == ["bytes", "count"] for v in coll.values())
    for kind in ("reduce-scatter", "collective-permute", "all-to-all"):
        assert coll[kind] == {"bytes": 0, "count": 0} and staged[kind] == 0
    # one fusion collective a round: the all-reduce of the mean, or the
    # all-gather of a host-fusion method's or a robust rule's rows
    # (scaffold: both, its new c_i rows gathered)
    issued = sum(v["count"] for v in coll.values())
    assert issued == (2 if "scaffold" in tag else 1)


@pytest.mark.parametrize("tag", sorted(PREDICTED))
def test_pod_collectives_equal_the_predictions(pod, tag):
    calls, staged = PREDICTED[tag]
    rec = pod[tag]
    assert rec["collectives"] == {
        k: dict(zip(("count", "bytes"), calls.get(k, (0, 0))))
        for k in XLA_KINDS}
    assert rec["collectives_staged"] == {k: staged.get(k, 0)
                                         for k in XLA_KINDS}


def test_fedma_gathers_its_host_gather_bytes(pod):
    """fedma's device program ends at the stacked params: one all-gather
    of the trained rows (one a rank), its result the whole cohort the
    host matching reads; the matching itself does not run."""
    rec = pod["fl_round_fedma_cnn_16x16"]
    assert rec["collectives"]["all-gather"] == {
        "bytes": rec["host_gather_bytes"], "count": 1}
    assert rec["host_gather_bytes"] == 223_457_920
    assert rec["collectives"]["all-reduce"]["count"] == 0


def test_dry_run_leaves_no_process_group(pod):
    assert torch.distributed.is_available()
    assert not torch.distributed.is_initialized()


def test_host_records_issue_no_collectives(tmp_path):
    recs = fl_dryrun.run_matrix(mesh_kind="host", outdir=str(tmp_path),
                                verbose=False, meta=False, **SMOKE)
    ok = [r for r in recs if r["status"] == "ok"]
    assert len(ok) == 30 and len(recs) == 31
    for r in ok:
        assert r["collectives"] == {k: {"bytes": 0, "count": 0}
                                    for k in XLA_KINDS}, fl_dryrun._tag(r)
        assert r["collectives_staged"] == dict.fromkeys(XLA_KINDS, 0)
    assert not torch.distributed.is_initialized()


def test_make_dry_rank_mesh():
    for rank in range(8):
        mesh = make_dry_rank_mesh((2, 4), rank, device="meta")
        assert (mesh.axis_names, mesh.sizes) == (AXES, (2, 4))
        assert mesh.coords == divmod(rank, 4) and mesh.rank == rank
        assert mesh.groups == (DRY_GROUP, DRY_GROUP)
        assert mesh.dry and mesh.backend == "dry"
        assert mesh.device == torch.device("meta")
    assert make_dry_rank_mesh((4, 1), 3, device="cpu").groups == (
        DRY_GROUP, None)
    assert not RankMesh(AXES, (2, 1)).dry
    with pytest.raises(ValueError, match="rank 8"):
        make_dry_rank_mesh((2, 4), 8, device="meta")
    with pytest.raises(ValueError, match="for axes"):
        make_dry_rank_mesh((2, 2, 2), 0, device="meta")


@pytest.fixture
def no_wire(monkeypatch):
    """torch.distributed's exchanges, each raising if called."""
    def wire(*a, **k):
        raise RuntimeError("reached torch.distributed")
    for name in ("all_reduce", "all_to_all_single", "all_gather",
                 "barrier"):
        monkeypatch.setattr(torch.distributed, name, wire)


def test_no_wire_branch_counts_and_moves_nothing(no_wire):
    """On a dry mesh each collective reaches nothing of torch.distributed
    and returns a tensor of the result's shape and dtype on the input's
    device; it counts calls, this rank's bytes and the result buffer's
    bytes as the wire branch does (staged 0: not gloo)."""
    mesh = make_dry_rank_mesh((4, 2), 5, device="cpu")     # coords (2, 1)
    x = torch.arange(15, dtype=torch.float32).reshape(3, 5)
    assert collectives.all_reduce(x, mesh, "data") is x
    a2a = collectives.all_to_all(torch.ones(4, 3, dtype=torch.bfloat16),
                                 mesh, "data")
    assert (a2a.shape, a2a.dtype, a2a.device) == ((4, 3), torch.bfloat16,
                                                  x.device)
    y = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    g = collectives.all_gather(y, mesh, "model")
    assert g.shape == (2, 2, 3) and torch.equal(g, torch.stack([y, y]))
    # 10 rows over 4 ranks: blocks 3, 3, 2, 2; coordinate 2 holds 2,
    # sent padded to 3, so the result holds 4 x 3 rows
    rows = collectives.all_gather_rows(torch.ones(2, 7), mesh, "data", 10)
    assert rows.shape == (10, 7) and bool(torch.isfinite(rows).all())
    collectives.barrier(mesh)
    c = mesh.counts.as_dict()
    assert c["calls"] == {"all_reduce": 1, "all_to_all": 1,
                          "all_gather": 2, "barrier": 1}
    assert c["bytes"] == {"all_reduce": 60, "all_to_all": 24,
                          "all_gather": 24 + 3 * 7 * 4, "barrier": 0}
    assert c["result"] == {"all_reduce": 60, "all_to_all": 24,
                           "all_gather": 2 * 24 + 4 * 3 * 7 * 4,
                           "barrier": 0}
    assert c["staged"] == dict.fromkeys(c["calls"], 0)
    # an axis of size 1 runs and counts nothing
    one = make_dry_rank_mesh((4, 1), 0, device="cpu")
    assert collectives.all_reduce(x, one, "model") is x
    assert one.counts.calls["all_reduce"] == 0


def test_a_real_mesh_never_takes_the_no_wire_branch(no_wire):
    mesh = RankMesh(AXES, (2, 1), groups=(object(), None))
    with pytest.raises(RuntimeError, match="reached torch.distributed"):
        collectives.all_reduce(torch.ones(3), mesh, "data")
    with pytest.raises(RuntimeError, match="reached torch.distributed"):
        collectives.barrier(mesh)
    assert mesh.counts.calls["all_reduce"] == 0


@pytest.mark.parametrize("method", ["fed2", "fedma"])
def test_rank0_on_real_memory_counts_as_on_meta(method):
    """Rank 0's program of a round built on a dry (4, 1) mesh with CPU
    tensors (its 2 of 6 cohort rows, the local_step route) issues what
    the dry-run's meta build of the same round counts, and its output
    is finite: the whole cohort's gathered rows for fedma, whose host
    matching the dry-run leaves out."""
    task, _ = fl_dryrun._cnn_case(method, "host")
    fl = FLConfig(population=6, method=method)
    elems = fl_dryrun._batch_elems("cnn", 4, 0)
    step = lower_round(task, fl, Mesh(AXES, (4, 1)), elems, local_steps=2)
    want = fl_dryrun.rank_counts(step).as_dict()
    mesh = make_dry_rank_mesh((4, 1), 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    init = task.init_fn(gen)
    eng = make_round_engine(task, step.cfg, init, device="cpu",
                            use_local_kernel=True, mesh=mesh)
    rows = eng.rows.stop - eng.rows.start
    assert rows == 2 and not eng.ctx.use_kernel
    batches = {"images": torch.randn((rows, 2, 4, 32, 32, 3), generator=gen),
               "labels": torch.randint(0, N_CLASSES, (rows, 2, 4),
                                       generator=gen, dtype=torch.int32)}
    w = torch.rand(6, generator=gen) + 0.5
    gw = (torch.rand(6, 5, generator=gen) + 0.5 if method == "fed2"
          else None)
    _, out = eng.device_round({"server": (), "clients": ()},
                              eng.layout.flatten(init), batches, w, gw)
    assert mesh.counts.as_dict() == want
    assert want["calls"]["all_reduce" if method == "fed2"
                         else "all_gather"] == 1
    assert out.shape[0] == (6 if method == "fedma" else eng.layout.size)
    assert bool(torch.isfinite(out).all())


def test_staged_bytes_are_the_tensor_down_and_the_result_back():
    """What gloo stages for a CUDA tensor (collectives_staged): 2x the
    tensor for an all-reduce or an all-to-all, the tensor and the
    gathered result for an all-gather."""
    assert collectives.staged_bytes(60, 60) == 120
    assert collectives.staged_bytes(24, 2 * 24) == 72
    c = collectives.Counts()
    c.add("all_gather", 24, 0, 48)
    c.add("all_reduce", 60, 0, 60)
    coll, staged = fl_dryrun.collectives(c)
    assert coll["all-gather"] == {"bytes": 48, "count": 1}
    assert staged == {"all-reduce": 120, "all-gather": 72,
                      "reduce-scatter": 0, "all-to-all": 0,
                      "collective-permute": 0}


def _real_args(step, task, gen):
    """The step's arguments as real CPU tensors: the task's own init as
    the global params, batches, weights and presence rows from ``gen``."""
    _state, _gp, batches, w, gw, row, key = step.args
    assert row is None and key is None
    layout = step.engine.layout
    gp = layout.flatten(task.init_fn(gen))
    real = {}
    for name, t in batches.items():
        if name == "images":
            real[name] = torch.randn(t.shape, generator=gen)
        elif name == "mask":
            real[name] = torch.ones(t.shape)
        else:           # cnn labels (C, S, B) or lm tokens and labels
            hi = N_CLASSES if t.dim() == 3 else LM_VOCAB
            real[name] = torch.randint(0, hi, t.shape, generator=gen,
                                       dtype=t.dtype)
    state = {"server": (), "clients": ()}
    w = torch.rand(w.shape, generator=gen) + 0.5
    gw = None if gw is None else torch.rand(gw.shape, generator=gen) + 0.5
    return state, gp, real, w, gw, None, None


@pytest.mark.parametrize("method,family", [("fed2", "cnn"),
                                           ("fedavg", "lm")])
def test_meta_flops_equal_a_real_cpu_round(method, family):
    task, _ = (fl_dryrun._cnn_case(method, "host") if family == "cnn"
               else fl_dryrun._lm_case(method))
    fl = FLConfig(population=SMOKE["clients"], method=method)
    step = lower_round(task, fl, make_host_mesh(),
                       fl_dryrun._batch_elems(family, SMOKE["batch"],
                                              SMOKE["seq"]),
                       local_steps=SMOKE["local_steps"])
    flops, _ = fl_dryrun.meta_pass(step)
    gen = torch.Generator().manual_seed(0)
    args = _real_args(step, task, gen)
    engine = make_round_engine(task, step.cfg, task.init_fn(gen),
                               device="cpu", use_kernel=False)
    with FlopCounterMode(display=False) as counter:
        state, out = engine.device_round(*args[:5])
    assert counter.get_total_flops() == flops > 0
    assert out.shape == args[1].shape and bool(torch.isfinite(out).all())


def test_flop_counter_under_vmap_grad():
    """What FlopCounterMode counts of the round's ``vmap(grad)`` (the
    record's NOTES): a matmul and a convolution's forward as a loop over
    the clients does; a convolution's weight gradient as one ungrouped
    convolution over the whole cohort, C times the loop's count. Nothing
    is hidden from the mode; the convolutions' backward is overstated."""
    import torch.nn.functional as F
    c, b, cin, cout, hw = 4, 2, 8, 16, 8
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(c, b, cin, hw, hw, generator=gen)
    w = torch.randn(c, cout, cin, 3, 3, generator=gen)
    a = torch.randn(c, b, 32, generator=gen)
    m = torch.randn(c, 32, 64, generator=gen)

    def conv(w, x):
        return F.conv2d(x, w, padding=1)

    def loss(w, x):
        return conv(w, x).square().sum()

    def flops(fn):
        with FlopCounterMode(display=False) as counter:
            fn()
        return counter.get_total_flops()

    fwd = 2 * b * hw * hw * cout * cin * 9          # one client's conv
    assert flops(lambda: torch.func.vmap(conv)(w, x)) == c * fwd
    assert flops(lambda: torch.func.vmap(torch.matmul)(a, m)) \
        == c * 2 * b * 32 * 64
    looped = flops(lambda: [torch.func.grad(loss)(w[i], x[i])
                            for i in range(c)])
    assert looped == c * 2 * fwd                   # forward + weight grad
    assert flops(lambda: torch.func.vmap(torch.func.grad(loss))(w, x)) \
        == c * fwd + c * (c * fwd)


def test_async_event_reads_follow_the_method():
    """fed2's and fedavg's events never read the global params; fedavgm's
    server step does (and its momentum); the bytes follow."""
    task, _ = fl_dryrun._cnn_case("fedavg", "host")
    reads = {}
    for method in ("fedavg", "fedavgm"):
        fl = FLConfig(population=4, method=method, mode="async",
                      buffer_k=2)
        step = lower_async_event(task, fl, make_host_mesh())
        reads[method] = step.reads
        m = step.engine.layout.size
        assert fl_dryrun.memory(step, make_host_mesh())["argument_bytes"] \
            == 4 * (2 * m + (2 * m if method == "fedavgm" else 0)) + 8
    assert reads["fedavg"] == (False, False, True, True)   # () server
    assert reads["fedavgm"] == (True, True, True, True)


def test_a_wrongly_declared_read_is_caught():
    task, _ = fl_dryrun._cnn_case("fedma", "host")
    step = lower_round(task, FLConfig(population=2, method="fedma"),
                       make_host_mesh(), fl_dryrun._batch_elems("cnn", 2, 0),
                       local_steps=1)
    assert step.reads[3] is False          # fedma's round ignores w
    fl_dryrun.meta_pass(step)
    step.reads = step.reads[:3] + (True,) + step.reads[4:]
    with pytest.raises(AssertionError, match="argument 3"):
        fl_dryrun.meta_pass(step)


def test_use_kernel_default_and_records(tmp_path):
    assert resolve_use_kernel(None, None) is True
    assert resolve_use_kernel(None, make_host_mesh()) is True
    assert resolve_use_kernel(None, make_production_mesh()) is False
    rec = fl_dryrun.run_robust_one("fedavg", "coordinate_median",
                                   make_host_mesh(), "1x1",
                                   outdir=str(tmp_path), verbose=False,
                                   meta=False, **{k: SMOKE[k] for k in
                                                  ("clients", "local_steps",
                                                   "batch")})
    assert rec["use_kernel"] is False       # a reducing rule: no kernel


def test_train_dry_run_writes_the_reduced_vgg9_records(tmp_path,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    recs = train.main(["--mode", "fl", "--dry-run", "--method", "fedavg",
                       "--nodes", "4", "--steps-per-epoch", "2",
                       "--batch", "8", "--device", "not-a-device"])
    out = tmp_path / fl_dryrun.DEFAULT_OUT
    names = sorted(os.listdir(out))
    assert names == sorted(f"dryrun_{t}.json" for t in (
        "fl_round_fedavg_cnn_1x1", "fl_tier_fedavg_w100_1x1",
        "fl_tier_fedavg_w050_1x1", "fl_tier_fedavg_w025_1x1",
        "fl_async_fedavg_cnn_1x1", "fl_robust_fedavg_coordinate_median_1x1",
        "fl_fast_fedavg_int8_1x1", "fl_align_pan_1x1"))
    assert len(recs) == 8 and all(r["status"] == "ok" for r in recs)
    rnd = json.loads((out / "dryrun_fl_round_fedavg_cnn_1x1.json")
                     .read_text())
    # benchmarks/artifacts_perf/dryrun_fl_round_fedavg_cnn_1x1.json
    assert rnd["arch"] == "vgg9-reduced"
    assert (rnd["memory"]["argument_bytes"],
            rnd["memory"]["output_bytes"]) == (1_084_024, 297_400)
    assert rnd["flops"] > 0 and rnd["local_steps"] == 2


def test_train_dry_run_refuses_lm_mode(capsys):
    with pytest.raises(SystemExit) as e:
        train.main(["--mode", "lm", "--dry-run"])
    assert e.value.code == 2
    assert "--dry-run is only supported with --mode fl" \
        in capsys.readouterr().err


def test_cli_exits_1_on_an_error_record(tmp_path, monkeypatch):
    argv = ["--mesh", "host", "--methods", "fedavg", "--families", "cnn",
            "--no-tiers", "--no-async-events", "--no-robust-events",
            "--no-fast-events", "--no-align-events", "--clients", "2",
            "--local-steps", "1", "--batch", "2", "--out", str(tmp_path)]
    with pytest.raises(SystemExit) as e:
        fl_dryrun.main(argv)
    assert e.value.code == 0

    def broken(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(fl_dryrun, "lower_round", broken)
    with pytest.raises(SystemExit) as e:
        fl_dryrun.main(argv)
    assert e.value.code == 1
    rec = json.loads((tmp_path / "dryrun_fl_round_fedavg_cnn_1x1.json")
                     .read_text())
    assert rec["status"] == "error" and "planted" in rec["error"]


def test_default_out_is_not_under_benchmarks():
    parts = os.path.normpath(fl_dryrun.DEFAULT_OUT).split(os.sep)
    assert "benchmarks" not in parts
    assert parts[0] == "runs_torch"


def test_compare_against_reference_records(tmp_path):
    c = collectives.Counts()
    c.add("all_reduce", 1000, 0, 1000)
    rec = {"kind": "fl_round", "method": "fed2", "family": "cnn",
           "mesh": "1x1", "status": "ok", "flops": 640.0,
           "memory": {"argument_bytes": 8, "output_bytes": 4},
           "collectives": fl_dryrun.collectives(c)[0]}
    xla = {k: {"bytes": 0, "count": 0} for k in XLA_KINDS}
    xla["all-reduce"] = {"bytes": 1040, "count": 31}
    xla["all-gather"] = {"bytes": 2048, "count": 2}
    (tmp_path / "dryrun_fl_round_fed2_cnn_1x1.json").write_text(json.dumps(
        {"flops": 10.0, "memory": {"argument_bytes": 8, "output_bytes": 5},
         "collectives": xla}))
    lost = dict(rec, method="fedavg")
    lines = fl_dryrun.compare([rec, lost, dict(rec, status="error")],
                              str(tmp_path))
    assert lines == [
        "[vs]   fl_round_fed2_cnn_1x1: bytes equal {'argument_bytes': "
        "True, 'output_bytes': False}; flops torch 640.0 / XLA 10.0 = "
        "64.000",
        "[vs]   fl_round_fed2_cnn_1x1: collectives port / XLA (calls x "
        "result bytes): all-reduce 1 x 1,000 B / 31 x 1,040 B; all-gather "
        "0 x 0 B / 2 x 2,048 B; reduce-scatter 0 x 0 B / 0 x 0 B; "
        "all-to-all 0 x 0 B / 0 x 0 B; collective-permute 0 x 0 B / 0 x "
        "0 B",
        "[vs]   fl_round_fedavg_cnn_1x1: no reference record"]
