"""Expert-parallel MoE at more than one shard
(``repro_torch.models.moe_ep``), on the CPU, at the MoE widths of the
reduced configs (``mixtral-8x22b``: 4 experts top-2; ``deepseek-v2-236b``:
4 experts top-2 and a shared expert, not renormalized) in fp32:

- ``moe_apply_ep_plain`` (every shard in one process, each all-to-all
  an index transpose) against the reference's ``shard_map`` on a (2, 4)
  mesh of 8 host devices, run in a subprocess under
  ``--xla_force_host_platform_device_count=8`` as ``tests/test_moe_ep.py``
  runs it, at capacity factor 16 (nothing drops) and 0.5 (pairs drop),
  from the reference's weights (``moe_init`` at ``PRNGKey(0)``) and the
  same tokens: outputs and aux within atol 1e-5 (the products summed in
  other orders);
- 4 ranks (``launch.mesh.spawn``, gloo, ``device="cpu"``, a ``file://``
  store) at (2, 2) and (1, 4) against the plain version: equal to the
  bit, as the ranks run its per-shard ops on one intra-op thread.
"""
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_ranks
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.models import moe, moe_ep
from repro_torch.launch.mesh import spawn

ATOL = 1e-5
MOE = {"mixtral-8x22b": dict(d_model=256, d_ff_expert=512, n_experts=4,
                             top_k=2),
       "deepseek-v2-236b": dict(d_model=256, d_ff_expert=256, n_experts=4,
                                top_k=2, n_shared=1, d_ff_shared=256,
                                router_norm_topk=False)}
# 16 drops nothing: 64 pairs a data shard, capacity 256 a destination;
# at 0.5 a destination takes 8 of about 16
FACTORS = (16.0, 0.5)
CASES = [(arch, cf) for arch in MOE for cf in FACTORS]
IDS = [f"{a.split('-')[0]}-cf{cf:g}" for a, cf in CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    """Per case: (config kwargs, the reference's params (numpy), tokens
    (4, 16, 256), capacity factor)."""
    out = []
    for arch, cf in CASES:
        p = jmoe.moe_init(jax.random.PRNGKey(0), jmoe.MoEConfig(**MOE[arch]))
        x = np.random.default_rng(1).standard_normal((4, 16, 256))
        out.append((MOE[arch], jax.tree_util.tree_map(np.asarray, p),
                    x.astype(np.float32), cf))
    return out


_REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.models import moe as M
from repro.models.moe_ep import moe_apply_ep
cases = pickle.load(open(sys.argv[1], "rb"))
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = []
for kw, p, x, cf in cases:
    cfg = M.MoEConfig(**kw)
    with mesh:
        y, aux = jax.jit(lambda p, x: moe_apply_ep(
            p, x, cfg, mesh, capacity_factor=cf))(p, jnp.asarray(x))
    out.append((np.asarray(y), float(aux)))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def cases():
    return _inputs()


@pytest.fixture(scope="module")
def reference(cases, tmp_path_factory):
    """The reference's 8-device outputs of every case, one subprocess."""
    d = tmp_path_factory.mktemp("moe_ep")
    src, dst = d / "cases.pkl", d / "out.pkl"
    src.write_bytes(pickle.dumps(cases))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        ["src"] + [p for p in [env.get("PYTHONPATH")] if p])
    run = subprocess.run([sys.executable, "-c", _REFERENCE, str(src),
                          str(dst)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    return pickle.loads(dst.read_bytes())


def _plain(case, data, model):
    kw, p, x, cf = case
    return moe_ep.moe_apply_ep_plain(
        convert.lm_to_port(p), torch.as_tensor(x), moe.MoEConfig(**kw),
        data=data, model=model, capacity_factor=cf)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_plain_matches_the_reference_on_8_devices(cases, reference, i):
    y, aux = _plain(cases[i], 2, 4)
    want_y, want_aux = reference[i]
    np.testing.assert_allclose(y.numpy(), want_y, rtol=0, atol=ATOL)
    assert abs(float(aux) - want_aux) <= ATOL
    # the dropping factor drops: its output is not the drop-free one's
    kw, p, x, cf = cases[i]
    free, _ = moe.moe_apply_dense_reference(
        convert.lm_to_port(p), torch.as_tensor(x), moe.MoEConfig(**kw))
    off = np.abs(y.numpy() - free.numpy()).max()
    assert (off > 1e-3) if cf < 1 else (off <= ATOL), off


@pytest.fixture(scope="module")
def ranks(cases):
    """Every case on 4 ranks at (2, 2) and then (1, 4), one spawn."""
    return spawn(torch_ranks.moe_rank, (2, 2), backend="gloo",
                 device="cpu", args=(cases, (1, 4)))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_ranks_equal_the_plain_version_to_the_bit(cases, ranks, shape, i):
    data, model = shape
    y, aux = _plain(cases[i], data, model)
    bl = y.shape[0] // data
    for r, res in enumerate(ranks):
        got_y, got_aux = res["out"][shape][i]
        di = r // model            # row-major: rank = data * |model| + m
        np.testing.assert_array_equal(got_y,
                                      y[di * bl:(di + 1) * bl].numpy())
        if di == 0:
            assert got_aux == float(aux)


def test_ranks_sit_row_major_and_gather_over_model(ranks):
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0),
                                            (1, 1)]
    assert [r["gathered"] for r in ranks] == [[0, 1], [0, 1], [2, 3],
                                              [2, 3]]


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_expert_shard_is_the_reference_slice(cases, n_shards):
    """``convert.expert_shard`` against ``dynamic_slice_in_dim``, the
    reference's cut of the replicated weights."""
    _, p, _, _ = cases[2]          # deepseek: a shared expert too
    for idx in range(n_shards):
        got = convert.expert_shard(p, idx, n_shards)
        e_loc = p["w_gate"].shape[0] // n_shards
        for k in convert.EXPERT_LEAVES:
            want = jax.lax.dynamic_slice_in_dim(p[k], idx * e_loc, e_loc, 0)
            np.testing.assert_array_equal(got[k], np.asarray(want))
        assert got["router"] is p["router"] and got["shared"] is p["shared"]
    with pytest.raises(ValueError, match="expert shard"):
        convert.expert_shard(p, 0, 3)


def test_moe_apply_ep_refuses_an_uneven_expert_split(cases):
    kw, p, x, _ = cases[0]
    with pytest.raises(ValueError, match="do not split"):
        moe_ep.moe_apply_ep_plain(convert.lm_to_port(p), torch.as_tensor(x),
                                  moe.MoEConfig(**kw), model=3)


def test_a_failing_rank_fails_the_spawn():
    """Rank 1 raises: ``spawn`` raises with its traceback and stops rank
    0, which waits in an all-reduce that never completes."""
    with pytest.raises(RuntimeError, match="planted fault on rank 1"):
        spawn(torch_ranks.failing_rank, (2, 1), backend="gloo",
              device="cpu", timeout=120)
