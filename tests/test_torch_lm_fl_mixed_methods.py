"""The other device methods on a params tree that mixes dtypes: fedprox,
scaffold, fednova, fedavgm and fedadam, one round each of
``run_federated(lm_task)`` on the reduced Fed2 Mamba-2 at bf16, against
the JAX package (limits in tests/mixed_lm_fl.py). Their state rows are
per leaf dtype, as the reference's ``zeros_like(params)``: scaffold's
control variates, fedavgm's velocity, fedadam's moments.

fedadam runs at ``server_lr`` 1e-3 (the reference's 1.0 overflows; see
ROADMAP.md's reference caveats). Its reference step promotes each bf16
leaf to fp32: the bias correction divides by ``1 - b1 ** t`` with ``t`` a
strong fp32 scalar, so the new global's bf16 leaves come back fp32 (and
the reference's eval then refuses the tree: ``mixed_lm_fl.jax_run``
casts the global back for its eval only). The port computes the same
step and keeps each leaf in its dtype, so its bf16 leaves hold the
reference's fp32 values rounded once, within the bf16 limit.
"""
import jax
import pytest
import torch

import mixed_lm_fl as mx
from repro_torch.convert import lm_to_port
from repro_torch.models.module import tree_leaves_with_path


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


METHODS = {"fedprox": {}, "scaffold": {}, "fednova": {}, "fedavgm": {},
           "fedadam": {"server_lr": 1e-3}}


@pytest.mark.parametrize("method", sorted(METHODS))
def test_mixed_method_matches_reference(method):
    """One round: every leaf in the reference's dtype (fedadam: in the
    init's, see above), fp32 leaves within 10 % of their update, bf16
    leaves within 2^-7; every fp32 leaf moved."""
    kw = METHODS[method]
    want = mx.jax_run(method, 1, **kw)
    got = mx.port_run(method, 1, fl_kw=kw)
    init = lm_to_port(mx.jax_init())
    like = init if method == "fedadam" else None
    mx.assert_parity(got["final_params"], want["final_params"], like)
    assert mx.fp32_moved(got, init) > 0


def test_reference_fedadam_promotes_bf16_leaves():
    """The reference caveat the fedadam case works around: its new
    global holds every leaf in fp32, the port's each in its init's
    dtype."""
    want = mx.jax_run("fedadam", 1, **METHODS["fedadam"])
    assert {str(a.dtype) for a in
            jax.tree_util.tree_leaves(want["final_params"])} == {"float32"}
    got = mx.port_run("fedadam", 1, fl_kw=METHODS["fedadam"])
    init = lm_to_port(mx.jax_init())
    assert [a.dtype for _, a in tree_leaves_with_path(got["final_params"])] \
        == [a.dtype for _, a in tree_leaves_with_path(init)]
