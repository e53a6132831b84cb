"""The sharded prefill loss and decode on model ranks
(``launch/steps.make_prefill_loss_step(mesh=)``, ``make_serve_step
(mesh=)``, ``launch/serve.run_serve(mesh=)`` over ``models/parallel.py``)
against one process and against the reference, on the CPU.

Two spawns of 4 gloo ranks (``launch.mesh.spawn``, ``device="cpu"``): a
(1, 4) mesh (4 model ranks) and a (2, 2) mesh (2 data x 2 model ranks).
Each runs every case: the reduced llama3.2-1b and mamba2-1.3b, fp32,
without Fed2 and under ``with_fed2(groups=4)``, with small chunks (loss
16, attention 8 x 8, SSD 8) so that every chunked loop takes several
steps: one prefill loss of a (4, 24) batch and ``run_serve`` of 4
prompts of 5 tokens plus 3 decoded ones. At 4 model ranks the reduced
llama (8 heads, 2 kv heads of 32) has the full model's awkward case:
each rank holds half a kv head's columns and 8 of a head's 32 cache
features; the reduced Mamba-2's conv channels (576: 144 a rank) do not
line up with its heads (16 of 32: 4 a rank).

Tolerances (fp32): the loss within 1e-5 of one process's (relative; the
ranks sum the CE's parts over the vocab's blocks and the row-parallel
partials in other orders); the gathered logits within 1e-5 of the
one-process logits' largest magnitude (the last step's, after every decoded
token: a token that flipped would move them far more), and the greedy
tokens equal; each cache leaf
joined from the ranks' shares within 1e-5 of the one-process leaf's
largest magnitude. Measured: about 1e-6 of the scale. The reference
case (Fed2 llama at (1, 4), from the reference's own initial
parameters) is held to the same 1e-5. The ranks' losses equal each
other to the bit; each rank holds exactly ``per_device_bytes`` of the
parameters; each rank's collectives (calls, bytes, result bytes, by
kind) of a prefill step and of a decode step equal those of its
program on a dry mesh on meta (``make_dry_rank_mesh``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.configs import get_config as jax_get_config
from repro.configs.common import with_fed2 as jax_with_fed2
from repro.launch import steps as jsteps
from repro.models import forward as jfwd
from repro.models import transformer as jtfm
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.common import with_fed2
from repro_torch.launch import serve, sharding, steps
from repro_torch.launch.mesh import make_dry_rank_mesh, spawn
from repro_torch.models.forward import init_cache
from repro_torch.models.module import tree_leaves, tree_paths
from repro_torch.models.transformer import init_params

TOL = 1e-5
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
CASES = (("llama3.2-1b", 0), ("llama3.2-1b", 4), ("mamba2-1.3b", 0),
         ("mamba2-1.3b", 4))
IDS = [f"{a}-fed2" if g else a for a, g in CASES]
SERVE = {"batch": 4, "prompt_len": 5, "gen": 3, "max_len": 16}
BATCH, SEQ = 4, 24
# the case held against the reference's own steps
JAX_CASE, JAX_MESH = ("llama3.2-1b", 4), "1x4"
SMALL = {"loss_chunk": 16, "attn_q_chunk": 8, "attn_kv_chunk": 8}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, groups):
    """(the reference's config, the port's) of a case: reduced, fp32,
    small chunks."""
    jc, tc = (jax_get_config(arch, reduced=True),
              get_config(arch, reduced=True))
    if groups:
        jc, tc = (jax_with_fed2(jc, groups=groups),
                  with_fed2(tc, groups=groups))
    jc, tc = (dataclasses.replace(jc, **SMALL),
              dataclasses.replace(tc, **SMALL))
    if tc.ssm is not None:
        jc = dataclasses.replace(jc, ssm=dataclasses.replace(jc.ssm,
                                                             chunk=8))
        tc = dataclasses.replace(tc, ssm=dataclasses.replace(tc.ssm,
                                                             chunk=8))
    return jc, tc


@functools.lru_cache(maxsize=None)
def _case(arch, groups):
    """(port config, parameters as numpy in the reference's layout,
    batch): the reference's init for the reference case, the port's
    (seed 0) for the others."""
    jc, tc = _configs(arch, groups)
    if (arch, groups) == JAX_CASE:
        params = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k: jtfm.init_params(k, jc))(jax.random.PRNGKey(0)))
    else:
        params = convert.lm_to_reference(
            init_params(torch.Generator().manual_seed(0), tc))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tc.vocab, size=(BATCH, SEQ + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32),
             "mask": (rng.random((BATCH, SEQ)) > 0.2).astype(np.float32)}
    return tc, params, batch


@pytest.fixture(scope="module")
def ranks():
    """Each mesh's ranks' results (``torch_ranks.serve_ranks``), every
    case in one spawn a mesh."""
    cases = [_case(a, g) + (SERVE,) for a, g in CASES]
    return {name: spawn(torch_ranks.serve_ranks, shape, backend="gloo",
                        device="cpu", args=(cases,), timeout=300)
            for name, shape in MESHES.items()}


@functools.lru_cache(maxsize=None)
def _one(arch, groups):
    """One process on the CPU: the prefill loss and run_serve."""
    tc, params, batch = _case(arch, groups)
    full = convert.lm_to_port(params)
    loss = float(steps.make_prefill_loss_step(tc)(
        full, {k: torch.as_tensor(v) for k, v in batch.items()}))
    return loss, serve.run_serve(tc, device="cpu", init_params=full,
                                 **SERVE)


def _close(got, want, tol=TOL):
    got, want = got.detach().double(), want.detach().double()
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    assert err <= tol * scale, (err, scale)


def _dry_counts(arch, groups, shape, rank) -> tuple:
    """The collectives of rank ``rank``'s prefill step and of one decode
    step of a case on a dry ``shape`` mesh, on meta (the plain routes:
    no kernel takes a meta tensor; they issue the same collectives)."""
    tc, params, batch = _case(arch, groups)
    mesh = make_dry_rank_mesh(shape, rank, device="meta")
    meta = init_params(torch.Generator(), tc, device="meta")
    shares = sharding.cut(meta, sharding.param_shardings(meta, tc, mesh),
                          mesh)
    lo, hi = sharding.batch_rows(mesh, BATCH)
    steps.make_prefill_loss_step(tc, use_kernel=False, mesh=mesh)(shares, {
        k: torch.as_tensor(v[lo:hi]).to("meta") for k, v in batch.items()})
    prefill = mesh.counts.as_dict()
    mesh.counts.reset()
    cache = init_cache(tc, SERVE["batch"], SERVE["max_len"], device="meta",
                       mesh=mesh)
    lo, hi = sharding.batch_rows(mesh, SERVE["batch"])
    steps.make_serve_step(tc, use_kernel=False, mesh=mesh)(
        shares, cache, torch.empty((hi - lo, 1), dtype=torch.int32,
                                   device="meta"), SERVE["prompt_len"])
    return prefill, mesh.counts.as_dict()


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("mesh", MESHES)
def test_prefill_loss_matches_one_process(ranks, mesh, case):
    i = CASES.index(case)
    want, _ = _one(*case)
    got = [r[i]["loss"] for r in ranks[mesh]]
    assert len(set(got)) == 1, got
    assert abs(got[0] - want) <= TOL * abs(want), (got[0], want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("mesh", MESHES)
def test_decode_logits_and_tokens_match_one_process(ranks, mesh, case):
    i = CASES.index(case)
    _, one = _one(*case)
    for r in ranks[mesh]:
        lo, hi = r[i]["rows"]
        _close(r[i]["logits"], one["logits"][lo:hi])
        assert (r[i]["tokens"] == one["tokens"][lo:hi]).all()


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("mesh", MESHES)
def test_caches_match_one_process(ranks, mesh, case):
    i = CASES.index(case)
    tc, _, _ = _case(*case)
    _, one = _one(*case)
    shape = MESHES[mesh]
    meshes = [make_dry_rank_mesh(shape, r, device="cpu")
              for r in range(len(ranks[mesh]))]
    like = init_cache(tc, SERVE["batch"], SERVE["max_len"], device="meta")
    joined = sharding.join([r[i]["cache"] for r in ranks[mesh]], meshes,
                           sharding.cache_shardings(like, SERVE["batch"],
                                                    meshes[0]), like)
    for path, got, want in zip(tree_paths(joined), tree_leaves(joined),
                               tree_leaves(one["cache"]), strict=True):
        if want.dtype == torch.int32:
            assert torch.equal(got, want), path
        else:
            _close(got, want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_holds_its_per_device_bytes(ranks, mesh, case):
    i = CASES.index(case)
    held = {r[i]["held"] for r in ranks[mesh]}
    want = {r[i]["per_device"] for r in ranks[mesh]}
    assert held == want and len(held) == 1, (held, want)
    whole = sum(t.nbytes for t in tree_leaves(_case(*case)[1]))
    assert held.pop() < whole


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("mesh", MESHES)
def test_each_ranks_collectives_equal_the_dry_mesh(ranks, mesh, case):
    i = CASES.index(case)
    for rank, r in enumerate(ranks[mesh]):
        prefill, decode = _dry_counts(*case, MESHES[mesh], rank)
        assert r[i]["prefill_counts"] == prefill, rank
        n = r[i]["decode_steps"]
        per_step = {k: {kind: v // n for kind, v in d.items()}
                    for k, d in r[i]["decode_counts"].items()}
        assert all(v % n == 0 for d in r[i]["decode_counts"].values()
                   for v in d.values())
        assert per_step == decode, rank
        assert sum(decode["calls"].values()) > 0


def _jax_serve(jc, jp, prompts, generated):
    """The reference's decode steps over the prompts, then over the
    tokens the ranks decoded: the logits of the last step."""
    step = jax.jit(lambda p, c, t, pos: jsteps.make_serve_step(jc)(
        p, c, t, pos))
    cache = jfwd.init_cache(jc, prompts.shape[0], SERVE["max_len"])
    seq = np.concatenate([prompts, generated], axis=1)
    for t in range(seq.shape[1]):
        logits, cache = step(jp, cache, jnp.asarray(seq[:, t:t + 1],
                                                    jnp.int32), jnp.int32(t))
    return np.asarray(logits)


def test_ranks_match_the_reference_steps(ranks):
    """The reference case at (1, 4): every rank's prefill loss against
    the reference's ``make_prefill_loss_step``, and its last decode
    logits against the reference's ``make_serve_step`` fed the same
    tokens, from the reference's initial parameters."""
    i = CASES.index(JAX_CASE)
    jc, _ = _configs(*JAX_CASE)
    _, params, batch = _case(*JAX_CASE)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want = float(jax.jit(jsteps.make_prefill_loss_step(jc))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    prompts = np.random.default_rng(0).integers(
        0, jc.vocab, size=(SERVE["batch"], SERVE["prompt_len"]))
    res = ranks[JAX_MESH]
    generated = res[0][i]["tokens"]
    assert all((r[i]["tokens"] == generated).all() for r in res)
    logits = _jax_serve(jc, jp, prompts, generated)
    for r in res:
        assert abs(r[i]["loss"] - want) <= TOL * abs(want)
        _close(r[i]["logits"], torch.tensor(logits))


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "zamba2-2.7b",
                                  "whisper-base", "internvl2-2b"])
def test_other_families_refuse_a_mesh_of_ranks(arch):
    cfg = get_config(arch, reduced=True)
    mesh = make_dry_rank_mesh((1, 2), 0, device="cpu")
    for make in (steps.make_serve_step, steps.make_prefill_loss_step):
        with pytest.raises(NotImplementedError, match="sharded"):
            make(cfg, mesh=mesh)
    with pytest.raises(NotImplementedError, match="sharded"):
        serve.run_serve(cfg, device="cpu", mesh=mesh)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b"])
def test_the_train_step_refuses_a_mesh_of_ranks(arch):
    cfg = get_config(arch, reduced=True)
    with pytest.raises(NotImplementedError, match="sharded"):
        steps.make_train_step(cfg, mesh=make_dry_rank_mesh((2, 1), 0,
                                                           device="cpu"))
    steps.make_train_step(cfg, mesh=make_dry_rank_mesh((1, 1), 0,
                                                       device="cpu"))


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1), (1, 16)])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cut_then_join_is_the_tree(case, shape):
    """Every rank's shares of the parameters and of a decode cache put
    back together give the trees; each share is contiguous and its own
    memory."""
    tc, params, _ = _case(*case)
    full = convert.lm_to_port(params)
    meshes = [make_dry_rank_mesh(shape, r, device="cpu")
              for r in range(shape[0] * shape[1])]
    cache = init_cache(tc, SERVE["batch"], SERVE["max_len"])
    for leaf in tree_leaves(cache):
        leaf.copy_(torch.randn(leaf.shape).to(leaf.dtype)
                   if leaf.is_floating_point() else leaf)
    for tree, specs in ((full, sharding.param_shardings(full, tc,
                                                        meshes[0])),
                        (cache, sharding.cache_shardings(
                            cache, SERVE["batch"], meshes[0]))):
        shares = [sharding.cut(tree, specs, m) for m in meshes]
        for s in shares:
            assert sharding.tree_bytes(s) == sharding.per_device_bytes(
                tree, specs, meshes[0])
            assert all(t.is_contiguous() for t in tree_leaves(s))
        joined = sharding.join(shares, meshes, specs, tree)
        for a, b in zip(tree_leaves(joined), tree_leaves(tree), strict=True):
            assert torch.equal(a, b)


def test_an_uneven_split_holds_the_ceiling():
    """A dimension of 5 over 2 model ranks: blocks of 3, the last one
    zero-padded, as XLA holds it; joined back without the padding."""
    tree = {"w": torch.arange(15.0).reshape(5, 3)}
    specs = {"w": ("model", None)}
    meshes = [make_dry_rank_mesh((1, 2), r, device="cpu") for r in (0, 1)]
    a, b = (sharding.cut(tree, specs, m)["w"] for m in meshes)
    assert torch.equal(a, tree["w"][:3])
    assert torch.equal(b, torch.cat([tree["w"][3:], torch.zeros(1, 3)]))
    assert sharding.per_device_bytes(tree, specs, meshes[0]) == a.nbytes
    assert torch.equal(sharding.join([{"w": a}, {"w": b}], meshes, specs,
                                     tree)["w"], tree["w"])
