"""The port's dry-run surfaces against the reference's: input shapes and
applicability, parameter counts, the analytic cost model, the sharding
rules and each device's argument bytes; then the meta pass itself.

The reference's rules run on ``jax.sharding.AbstractMesh`` at the
production shapes (16, 16) and (2, 16, 16): they read only the mesh's
axis names and sizes, so no device is needed. Its trees come from
``jax.eval_shape``; the port's are built on ``meta``.

Tolerances: parameter counts, specs and bytes are integers or names and
must be equal; ``analytic_cost`` agrees to a relative 1e-12 (the same
float formulas over the same integers); the meta pass's FLOP count
equals the count of the same step run for real on the CPU (both are
FlopCounterMode's integer sums over the same products).

Torch runs on one intra-op thread here (``_one_thread``).
"""
import dataclasses
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
from repro.configs import PAPER_ARCHS as J_PAPER
from repro.configs import get_config as jget_config
from repro.configs.common import with_fed2 as jwith_fed2
from repro.configs.shapes import INPUT_SHAPES as J_SHAPES
from repro.launch import analytic as janalytic
from repro.launch import sharding as jshd
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models.transformer import init_params as jinit_params
from repro_torch.configs import ASSIGNED_ARCHS, PAPER_ARCHS, get_config
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape
from repro_torch.launch import analytic, dryrun
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.forward import init_cache
from repro_torch.models.module import tree_get, tree_map, tree_paths
from repro_torch.models.transformer import init_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECORD = ROOT / "benchmarks/artifacts/dryrun_llama3.2-1b_train_4k_16x16.json"
ANALYTIC_RTOL = 1e-12
MESHES = {"16x16": False, "2x16x16": True}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _abstract_mesh(multi_pod: bool):
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _jcfg(arch, fed2=False):
    cfg = jget_config(arch, dtype=jnp.bfloat16)
    return jwith_fed2(cfg) if fed2 else cfg


def _tcfg(arch, fed2=False):
    return dryrun.config_of(arch, fed2=fed2)


def _jnames(path):
    return tuple(str(p.key) if hasattr(p, "key") else str(p.idx)
                 for p in path)


def _jleaves(tree):
    """{names: leaf} of a jax tree (ShapeDtypeStructs or shardings)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_jnames(p): leaf for p, leaf in flat}


def _tleaves(tree):
    """{names: leaf} of a port tree (a spec tuple is a leaf when the
    paths come from the tensor tree it describes)."""
    return {tuple(str(k) for k in p): tree_get(tree, p)
            for p in tree_paths(tree)}


def _tspecs(specs, like):
    return {tuple(str(k) for k in p): tree_get(specs, p)
            for p in tree_paths(like)}


def _padded(spec, nd):
    """A reference PartitionSpec as the port writes it: one entry per
    dimension."""
    return tuple(spec) + (None,) * (nd - len(spec))


def _jbytes(tree) -> int:
    """Per-device bytes of ShapeDtypeStructs with NamedShardings, by
    each sharding's own shard shape."""
    return sum(math.prod(s.sharding.shard_shape(s.shape))
               * np.dtype(s.dtype).itemsize
               for s in jax.tree_util.tree_leaves(tree))


def _placed(shapes, shardings):
    return jax.tree_util.tree_map(
        lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
        shapes, shardings)


# ---------------------------------------------------------------------------
# shapes, applicability
# ---------------------------------------------------------------------------


def test_input_shapes_and_registry_match():
    assert ASSIGNED_ARCHS == J_ASSIGNED
    assert PAPER_ARCHS == J_PAPER
    assert {k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in J_SHAPES.items()}
    assert list(INPUT_SHAPES) == list(J_SHAPES)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_applicable_matches_reference(arch):
    """The reference's ``applicable`` (repro/launch/dryrun.py), restated:
    importing that module would force 512 host devices."""
    jcfg = jget_config(arch)
    assert get_config(arch).is_subquadratic == jcfg.is_subquadratic
    for name in INPUT_SHAPES:
        for swa in (False, True):
            ok, why = dryrun.applicable(arch, name, swa_override=swa)
            want = not (name == "long_500k" and not jcfg.is_subquadratic
                        and not swa)
            assert ok == want, (arch, name, swa)
            assert (why == "") == ok
            if not ok:
                assert why.startswith("pure full-attention decoder: 524k")
                assert why.endswith("for the beyond-paper SWA variant")


# ---------------------------------------------------------------------------
# parameter counts and the analytic model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_counts_equal_eval_shape(arch):
    for fed2 in (False, True):
        got = analytic.param_counts(_tcfg(arch, fed2))
        want = janalytic.param_counts(_jcfg(arch, fed2))
        assert got == want, (arch, fed2)
        assert all(isinstance(v, int) for v in got.values())


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_analytic_cost_matches(arch):
    for fed2 in (False, True):
        for name in INPUT_SHAPES:
            got = analytic.analytic_cost(_tcfg(arch, fed2),
                                         INPUT_SHAPES[name])
            want = janalytic.analytic_cost(_jcfg(arch, fed2),
                                           J_SHAPES[name])
            assert got.keys() == want.keys()
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=ANALYTIC_RTOL,
                                               abs=0), (arch, fed2, name, k)


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------


def _assert_specs(port_specs, like, ref_shardings, ref_shapes, what):
    got = _tspecs(port_specs, like)
    shapes = _tleaves(like)
    want = _jleaves(ref_shardings)
    ref_shape = _jleaves(ref_shapes)
    assert got.keys() == want.keys(), what
    for names, spec in got.items():
        assert tuple(shapes[names].shape) == tuple(ref_shape[names].shape), \
            (what, names)
        nd = len(ref_shape[names].shape)
        assert spec == _padded(want[names].spec, nd), (what, names, spec,
                                                        want[names].spec)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_sharding_specs_identical(arch, mesh_name):
    mp = MESHES[mesh_name]
    jmesh, mesh = _abstract_mesh(mp), make_production_mesh(multi_pod=mp)
    for fed2 in (False, True):
        jcfg, tcfg = _jcfg(arch, fed2), _tcfg(arch, fed2)
        jshapes = jax.eval_shape(lambda k: jinit_params(k, jcfg),
                                 jax.random.PRNGKey(0))
        tparams = init_params(torch.Generator(), tcfg, device="meta")
        _assert_specs(shd.param_shardings(tparams, tcfg, mesh), tparams,
                      jshd.param_shardings(jshapes, jcfg, jmesh), jshapes,
                      (arch, fed2, "params"))
        _assert_specs(shd.zero1_shardings(tparams, tcfg, mesh), tparams,
                      jshd.zero1_shardings(jshapes, jcfg, jmesh), jshapes,
                      (arch, fed2, "zero1"))
    for name, shape in INPUT_SHAPES.items():
        if not dryrun.applicable(arch, name)[0]:
            continue
        tcfg, jcfg = _tcfg(arch), _jcfg(arch)
        if shape.mode == "decode":
            cache, cspecs = shd.cache_specs(tcfg, shape, mesh)
            jc = jshd.cache_specs(jcfg, J_SHAPES[name], jmesh)
            _assert_specs(cspecs, cache,
                          jax.tree_util.tree_map(lambda s: s.sharding, jc),
                          jc, (arch, name, "cache"))
            _check_dtypes(cache, jc, (arch, name, "cache"))
            (tok, pos), (tspec, pspec) = shd.decode_token_specs(
                tcfg, shape, mesh)
            jtok, jpos = jshd.decode_token_specs(jcfg, J_SHAPES[name], jmesh)
            assert tspec == _padded(jtok.sharding.spec, 2)
            assert pspec == tuple(jpos.sharding.spec) == ()
            assert tuple(tok.shape) == jtok.shape and pos.dim() == 0
        else:
            batch, bspecs = shd.batch_specs(tcfg, shape, mesh)
            jb = jshd.batch_specs(jcfg, J_SHAPES[name], jmesh)
            _assert_specs(bspecs, batch,
                          jax.tree_util.tree_map(lambda s: s.sharding, jb),
                          jb, (arch, name, "batch"))
            _check_dtypes(batch, jb, (arch, name, "batch"))


def _check_dtypes(ttree, jtree, what):
    got, want = _tleaves(ttree), _jleaves(jtree)
    for names, t in got.items():
        assert t.element_size() == np.dtype(want[names].dtype).itemsize, \
            (what, names)


# ---------------------------------------------------------------------------
# per-device argument bytes
# ---------------------------------------------------------------------------


def _reference_argument_bytes(arch, name, multi_pod, fed2=False):
    """The reference's build_lowered placement (repro/launch/dryrun.py),
    composed from its rules: the bytes one device holds of the step's
    arguments."""
    jmesh, jcfg, shape = _abstract_mesh(multi_pod), _jcfg(arch, fed2), \
        J_SHAPES[name]
    pshapes = jax.eval_shape(lambda k: jinit_params(k, jcfg),
                             jax.random.PRNGKey(0))
    pshard = jshd.param_shardings(pshapes, jcfg, jmesh)
    if shape.mode == "train":
        _, opt = jmake_train_step(jcfg)
        oshapes = jax.eval_shape(opt.init, pshapes)
        z = jshd.zero1_shardings(pshapes, jcfg, jmesh)
        return (_jbytes(_placed(pshapes, pshard))
                + _jbytes(_placed(oshapes, {"m": z, "v": z})) + 4
                + _jbytes(jshd.batch_specs(jcfg, shape, jmesh)))
    per_group_gb = janalytic.param_counts(jcfg)["total"] * 2 / \
        jmesh.shape["model"] / 2**30
    if per_group_gb > 12.0:
        pshard = jshd.zero1_shardings(pshapes, jcfg, jmesh)
    params = _jbytes(_placed(pshapes, pshard))
    if shape.mode == "prefill":
        return params + _jbytes(jshd.batch_specs(jcfg, shape, jmesh))
    return (params + _jbytes(jshd.cache_specs(jcfg, shape, jmesh))
            + _jbytes(jshd.decode_token_specs(jcfg, shape, jmesh)))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_argument_bytes_equal_reference(arch, monkeypatch):
    monkeypatch.delenv("REPRO_SERVE_FSDP", raising=False)
    for name in INPUT_SHAPES:
        if not dryrun.applicable(arch, name)[0]:
            continue
        for mesh_name, mp in MESHES.items():
            mesh = make_production_mesh(multi_pod=mp)
            step, _ = dryrun.build_lowered(arch, name, mesh=mesh)
            assert dryrun.argument_bytes(step, mesh) == \
                _reference_argument_bytes(arch, name, mp), \
                (arch, name, mesh_name)


def test_argument_bytes_of_the_committed_record():
    """The committed XLA record of llama3.2-1b train_4k on 16x16: 187.4
    MB of bf16 params, 46.9 MB of fp32 m and v, 0.79 MB of batch, 4 B of
    step counter."""
    mesh = make_production_mesh()
    step, _ = dryrun.build_lowered("llama3.2-1b", "train_4k", mesh=mesh)
    got = dryrun.argument_bytes(step, mesh)
    assert got == 235_082_756
    assert got == json.loads(RECORD.read_text())["memory"]["argument_bytes"]
    assert got == _reference_argument_bytes("llama3.2-1b", "train_4k", False)


def test_host_mesh_bytes_are_the_whole_tensors():
    """On the one-device mesh every spec is whole: a device holds every
    byte of the arguments."""
    mesh = make_host_mesh()
    step, _ = dryrun.build_lowered("mamba2-1.3b", "decode_32k", mesh=mesh)
    assert dryrun.argument_bytes(step, mesh) == sum(
        shd.tree_bytes(a) for a in step.args)


# ---------------------------------------------------------------------------
# the meta pass
# ---------------------------------------------------------------------------

# one reduced config per family, at a small shape (a batch of 16: the
# SSD families' 8 microbatches divide it)
FAMILY_ARCHS = ("llama3.2-1b", "mixtral-8x22b", "deepseek-v2-236b",
                "mamba2-1.3b", "zamba2-2.7b", "whisper-base",
                "internvl2-2b")
SMALL = {"train": InputShape("small_train", 64, 16, "train"),
         "prefill": InputShape("small_prefill", 64, 4, "prefill"),
         "decode": InputShape("small_decode", 64, 4, "decode")}


def _real(cfg, shape, step, gen):
    """The meta arguments made real on the CPU: the params and cache as
    the port initializes them, tokens drawn below the vocab, a mask of
    ones, seeded embeds, a zero optimizer state."""
    params = init_params(gen, cfg)
    b, s = shape.global_batch, shape.seq_len
    step_counter = torch.zeros((), dtype=torch.int32)
    if shape.mode == "decode":
        tokens = torch.randint(0, cfg.vocab, (b, 1), generator=gen,
                               dtype=torch.int32)
        return params, init_cache(cfg, b, s), tokens, step_counter

    def real(k, t):
        if k == "mask":
            return torch.ones(t.shape)
        if k == "embeds":
            return torch.randn(t.shape, generator=gen, dtype=t.dtype)
        return torch.randint(0, cfg.vocab, t.shape, generator=gen,
                             dtype=t.dtype)

    batch = {k: real(k, t) for k, t in step.args[-1].items()}
    if shape.mode == "prefill":
        return params, batch
    ostate = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                      step.args[1])
    return params, ostate, step_counter, batch


@pytest.mark.parametrize("mode", SMALL)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_meta_pass_counts_the_real_step(arch, mode):
    from torch.utils.flop_counter import FlopCounterMode
    cfg, shape, mesh = get_config(arch, reduced=True), SMALL[mode], \
        make_production_mesh()
    step = dryrun.build_step(cfg, shape, mesh)
    meta = dryrun.meta_pass(step)
    rec = dryrun.record(step, cfg, shape, mesh, 0.0, meta)
    assert rec["status"] == "ok" and rec["flops"] > 0
    assert rec["memory"]["temp_bytes"] is None and rec["collectives"] is None
    with FlopCounterMode(display=False) as counter:
        step.call(*_real(cfg, shape, step, torch.Generator().manual_seed(0)))
    assert counter.get_total_flops() == meta[0]
