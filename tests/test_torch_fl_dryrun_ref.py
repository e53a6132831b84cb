"""The port's federated dry-run (``repro_torch.launch.fl_dryrun``) at the
host mesh against the reference's programs lowered live.

Every ``ok`` case of the 1x1 matrix at ``make smoke``'s knobs (4
clients, 2 local steps, batch 8, seq 32): 8 methods x cnn, 7 x lm, 6
tier tiles, 4 async events, 2 robust, 2 fast and 1 align round. The
reference's own ``lower_round`` and its siblings place their arguments
on a mesh, and its host-mesh lowering dies on this tree's jax; so the
reference's jitted programs (``round_fn``, ``tile_fn``, ``event_fn``)
are lowered here at ``mesh=None`` from ``jax.ShapeDtypeStruct``s built
as its lowering helpers build them. On one device that is the 1x1
record's program. Its bytes are read off the lowering (the arguments
jit keeps, the outputs and XLA's output tuple index), which is what
``compile().memory_analysis()`` reports: one round and one event are
compiled to hold that, the rest are not (XLA's compile is 80 % of the
time).

Held equal (integers): each record's ``argument_bytes`` and
``output_bytes`` to XLA's argument and output sizes, and
``params_bytes``, ``full_params_bytes``, ``uplink_bytes``,
``kept_groups`` and ``host_gather_bytes`` to the reference's own
functions; fedma x lm is ``skipped`` with the reference's reason; the
recorded fusion route to the reference's rule whenever the caller
chooses it. The port's records come from one run of its 1x1 matrix,
meta pass included (which checks every meta argument's declared read
against the data-flow trace).

Torch runs on one intra-op thread here (``_one_thread``).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import vgg9 as jvgg9
from repro.core import fusion as jfusion
from repro.fl import alignment as jalignment
from repro.fl import codec as jcodec
from repro.fl import methods as jmethods
from repro.fl.async_engine import make_async_engine as jmake_async_engine
from repro.fl.engine import make_round_engine as jmake_round_engine
from repro.fl.engine import resolve_use_kernel as jresolve_use_kernel
from repro.fl.engine import stacked_param_bytes as jstacked_param_bytes
from repro.fl.runtime import FLConfig as JFLConfig
from repro.fl.runtime import cnn_task as jcnn_task
from repro.launch import fl_dryrun as jfl_dryrun
from repro_torch.fl.engine import resolve_use_kernel
from repro_torch.launch import fl_dryrun
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh)

SMOKE = dict(clients=4, local_steps=2, batch=8, seq=32)
C, STEPS, B, SEQ = (SMOKE[k] for k in ("clients", "local_steps", "batch",
                                       "seq"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The port's 1x1 matrix, by tag."""
    out = tmp_path_factory.mktemp("fl_dryrun")
    recs = fl_dryrun.run_matrix(mesh_kind="host", outdir=str(out),
                                verbose=False, **SMOKE)
    return {fl_dryrun._tag(r): r for r in recs}


# ---------------------------------------------------------------------------
# The reference's programs at mesh=None
# ---------------------------------------------------------------------------


def _sds(tree):
    return jax.tree_util.tree_map(
        lambda l: jax.ShapeDtypeStruct(l.shape, l.dtype), tree)


def _batches(family, n):
    return {name: jax.ShapeDtypeStruct((n, STEPS) + tuple(shape), dtype)
            for name, (shape, dtype)
            in jfl_dryrun._batch_elems(family, B, SEQ).items()}


def _case(method, family):
    return (jfl_dryrun._cnn_case(method, "host") if family == "cnn"
            else jfl_dryrun._lm_case(method))[0]


def _nbytes(aval) -> int:
    return math.prod(aval.shape) * aval.dtype.itemsize


def _memory(lowered) -> tuple:
    """XLA's argument and output sizes of a lowered program, read off
    the lowering: the arguments jit kept (it drops those the program
    never reads) and the outputs, plus the output tuple's index of 8
    bytes a leaf when there is more than one
    (``test_lowered_bytes_are_xla_memory_analysis`` holds this to
    ``compile().memory_analysis()``)."""
    args = lowered._lowering.compile_args
    outs = args["global_out_avals"]
    return (sum(_nbytes(a) for a in args["global_in_avals"]),
            sum(_nbytes(a) for a in outs)
            + (8 * len(outs) if len(outs) > 1 else 0))


def _round(task, cfg, family):
    """``lower_round``'s program at mesh=None."""
    cfg = dataclasses.replace(cfg, local_epochs=1, steps_per_epoch=STEPS)
    n = cfg.cohort_size
    shapes = jax.eval_shape(task.init_fn, jax.random.PRNGKey(0))
    engine = jmake_round_engine(task, cfg, shapes, mesh=None,
                                use_kernel=False)
    state = _sds(jax.eval_shape(engine.init_state, shapes))
    w = jax.ShapeDtypeStruct((n,), jnp.float32)
    gw = mal = None
    if engine.method.uses_groups:
        g = next(a.n_groups for a in jax.tree_util.tree_leaves(
            task.group_axes_fn(shapes),
            is_leaf=lambda x: isinstance(x, jfusion.GroupAxis))
            if isinstance(a, jfusion.GroupAxis))
        gw = jax.ShapeDtypeStruct((n, g), jnp.float32)
    if engine.attack is not None:
        key = jax.eval_shape(lambda: jax.random.PRNGKey(0))
        mal = (jax.ShapeDtypeStruct((n,), jnp.float32),
               jax.ShapeDtypeStruct(key.shape, key.dtype))
    return engine.round_fn.lower(state, _sds(shapes), _batches(family, n),
                                 w, gw, mal)


def _tile(method, width):
    """``lower_tier_tile``'s program at mesh=None."""
    cfg = JFLConfig(population=C, method=method, local_epochs=1,
                    steps_per_epoch=STEPS)
    model = _case(method, "cnn").tier_fn(width)
    shapes = jax.eval_shape(model.task.init_fn, jax.random.PRNGKey(0))
    engine = jmake_round_engine(model.task, cfg, shapes, mesh=None,
                                use_kernel=False)
    return engine.tile_fn.lower(
        (), (), _sds(shapes), _batches("cnn", C),
        jax.ShapeDtypeStruct((C,), jnp.float32), None, None)


def _event(method, family):
    """``lower_async_event``'s program at mesh=None."""
    k = max(1, C // 2)
    cfg = JFLConfig(population=C, method=method, mode="async", buffer_k=k)
    task = _case(method, family)
    shapes = jax.eval_shape(task.init_fn, jax.random.PRNGKey(0))
    engine = jmake_async_engine(task, cfg, shapes, mesh=None,
                                use_kernel=False)
    server = jax.eval_shape(engine.init_server_state, shapes)
    rows = jax.tree_util.tree_map(
        lambda l: jax.ShapeDtypeStruct((k,) + l.shape, l.dtype), shapes)
    return engine.event_fn.lower(
        _sds(server), _sds(shapes), rows,
        jax.ShapeDtypeStruct((k,), jnp.float32))


def _align_task(method, strategy):
    return jcnn_task(jalignment.build_model_config(
        jalignment.get(strategy), jmethods.get(method),
        grouped_fn=lambda: jvgg9.reduced(fed2_groups=5, decouple=3,
                                         norm="gn"),
        plain_fn=lambda: jvgg9.reduced(fed2_groups=0, norm="none")))


ROUND_CASES = [(m, f) for f in ("cnn", "lm") for m in jmethods.available()
               if not (m == "fedma" and f == "lm")]
TIER_CASES = [(m, w) for m in ("fedavg", "fed2")
              for w in (jfl_dryrun.TIER_WIDTHS_GROUPED
                        if jmethods.get(m).uses_groups
                        else jfl_dryrun.TIER_WIDTHS_PLAIN)]
ASYNC_CASES = [(m, f) for f in ("cnn", "lm") for m in ("fedavg", "fed2")]


def test_matrix_statuses(records):
    assert len(records) == 31
    statuses = [r["status"] for r in records.values()]
    assert statuses.count("ok") == 30, {
        t: r.get("error") for t, r in records.items()
        if r["status"] != "ok"}
    assert records["fl_round_fedma_lm_1x1"]["status"] == "skipped"
    assert len(ROUND_CASES) + len(TIER_CASES) + len(ASYNC_CASES) \
        + len(jfl_dryrun.ROBUST_MATRIX) + len(jfl_dryrun.FAST_MATRIX) \
        + len(jfl_dryrun.ALIGN_MATRIX) == 30


def test_fedma_lm_skipped_with_the_reference_reason(records, tmp_path):
    ref = jfl_dryrun.run_one("fedma", "lm", None, "1x1",
                             outdir=str(tmp_path), verbose=False, **SMOKE)
    port = records["fl_round_fedma_lm_1x1"]
    assert (port["status"], port["reason"]) == (ref["status"],
                                                ref["reason"])


def _held(rec, want):
    got = (rec["memory"]["argument_bytes"], rec["memory"]["output_bytes"])
    assert got == want, (got, want)


@pytest.mark.parametrize("method,family", ROUND_CASES)
def test_round_bytes(records, method, family):
    rec = records[f"fl_round_{method}_{family}_1x1"]
    task = _case(method, family)
    _held(rec, _memory(_round(
        task, JFLConfig(population=C, method=method), family)))
    meth = jmethods.get(method)
    assert rec["host_matching"] == meth.host_fusion
    assert rec["host_gather_bytes"] == (jstacked_param_bytes(task, C)
                                        if meth.host_fusion else 0)


@pytest.mark.parametrize("method,width", TIER_CASES)
def test_tier_bytes(records, method, width):
    rec = records[f"fl_tier_{method}_w{round(width * 100):03d}_1x1"]
    _held(rec, _memory(_tile(method, width)))
    task = _case(method, "cnn")
    model = task.tier_fn(width)
    assert rec["params_bytes"] == model.param_bytes
    assert rec["full_params_bytes"] == jstacked_param_bytes(task, 1)
    assert rec["kept_groups"] == model.model_cfg.fed2_groups
    assert rec["tier_arch"] == model.model_cfg.arch_id


@pytest.mark.parametrize("method,family", ASYNC_CASES)
def test_async_event_bytes(records, method, family):
    rec = records[f"fl_async_{method}_{family}_1x1"]
    assert rec["buffer_k"] == max(1, C // 2)
    _held(rec, _memory(_event(method, family)))


@pytest.mark.parametrize("method,rule", jfl_dryrun.ROBUST_MATRIX)
def test_robust_round_bytes(records, method, rule):
    rec = records[f"fl_robust_{method}_{rule.split('(')[0]}_1x1"]
    cfg = JFLConfig(population=C, method=method, attack="sign_flip(4)",
                    attack_fraction=0.2, robust=rule)
    _held(rec, _memory(_round(_case(method, "cnn"), cfg, "cnn")))
    assert rec["use_kernel"] is False


@pytest.mark.parametrize("method,spec", jfl_dryrun.FAST_MATRIX)
def test_fast_round_bytes(records, method, spec):
    rec = records[f"fl_fast_{method}_{spec.split('(')[0]}_1x1"]
    task = _case(method, "cnn")
    cfg = JFLConfig(population=C, method=method, compute_dtype="bfloat16",
                    codec=spec)
    _held(rec, _memory(_round(task, cfg, "cnn")))
    shapes = jax.eval_shape(task.init_fn, jax.random.PRNGKey(0))
    up = jcodec.parse_codec(spec).bytes_per_client(shapes)
    assert rec["uplink_bytes"] == rec["params_bytes"] == up
    assert rec["full_params_bytes"] == jstacked_param_bytes(task, 1)


@pytest.mark.parametrize("method,strategy", jfl_dryrun.ALIGN_MATRIX)
def test_align_round_bytes(records, method, strategy):
    rec = records[f"fl_align_{strategy}_1x1"]
    task = _align_task(method, strategy)
    cfg = JFLConfig(population=C, method=method, alignment=strategy)
    _held(rec, _memory(_round(task, cfg, "cnn")))
    assert rec["pan_scale"] == 0.2


class _SizedMesh:
    """What the reference's rule reads of a mesh: its size."""
    def __init__(self, size):
        self.size = size


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("size", [None, 1, 256])
def test_use_kernel_rule_when_chosen(use_kernel, size):
    port_mesh = (None if size is None else make_host_mesh() if size == 1
                 else make_production_mesh())
    ref_mesh = None if size is None else _SizedMesh(size)
    assert resolve_use_kernel(use_kernel, port_mesh) \
        == jresolve_use_kernel(use_kernel, ref_mesh)
    assert Mesh(("data", "model"), (16, 16)).size == 256


@pytest.mark.parametrize("program", ["round fed2 cnn", "event fed2 cnn"])
def test_lowered_bytes_are_xla_memory_analysis(program):
    lowered = (_round(_case("fed2", "cnn"),
                      JFLConfig(population=C, method="fed2"), "cnn")
               if program.startswith("round") else _event("fed2", "cnn"))
    mem = lowered.compile().memory_analysis()
    assert _memory(lowered) == (mem.argument_size_in_bytes,
                                mem.output_size_in_bytes)
