"""The ``local_step`` route on a params tree that mixes dtypes: one fed2
round of ``run_federated(lm_task, use_local_kernel=True)`` on the
reduced Fed2 Mamba-2 at bf16 against the JAX package's kernel route
(its Pallas ``local_step`` in interpret mode, ~30-50 s here: one round,
fed2 only).

The reference's route calls ``ravel_pytree`` on the params: on a tree of
bf16 and fp32 leaves that is ONE fp32 vector (bf16 leaves cast up), its
``unravel`` casts each leaf back inside the loss, so the whole local
phase runs in fp32 (params, velocity, gradients) and each bf16 leaf is
rounded once, at the end. Its final params differ from the plain route's
by about one bf16 ulp, as much as the two packages' round-off, so the
structure is checked on its own: the port's ``local_step`` sees one fp32
(C, M) buffer of every element of the tree, once a local step, and the
bf16 leaves' trained rows just before the final cast are not all bf16
values. Limits as in tests/mixed_lm_fl.py.
"""
import pytest
import torch

import mixed_lm_fl as mx
from repro_torch.convert import lm_to_port
from repro_torch.core import fusion
from repro_torch.fl import methods as methods_mod
from repro_torch.models.module import FlatLayout


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mixed_kernel_route_matches_reference():
    """fed2, one round, both packages on their local_step route: every
    leaf in the reference's dtype, fp32 leaves within 10 % of their
    update, bf16 leaves within 2^-7."""
    want = mx.jax_run("fed2", 1, use_local_kernel=True)
    got = mx.port_run("fed2", 1, use_local_kernel=True)
    mx.assert_parity(got["final_params"], want["final_params"])


def test_mixed_kernel_route_steps_one_fp32_buffer(monkeypatch):
    """local_step runs once a local step on ONE fp32 (C, M) buffer that
    holds all M elements of the tree, with an fp32 velocity and fp32
    gradients; after the last step the bf16 leaves' rows hold values off
    the bf16 grid (they are rounded only when copied back), and the
    fusion makes one paired_fusion call per dtype segment."""
    layout = FlatLayout(lm_to_port(mx.jax_init()))
    calls, last = [], {}
    real_ls, real_pf = methods_mod.local_step, fusion.paired_fusion

    def ls(p, v, g, *, lr, mu):
        calls.append(("local_step", tuple(p.shape),
                      (p.dtype, v.dtype, g.dtype)))
        out = real_ls(p, v, g, lr=lr, mu=mu)
        last["p"] = p.clone()
        return out

    def pf(x, w, out=None):
        calls.append(("paired_fusion", tuple(x.shape), x.dtype))
        return real_pf(x, w, out=out)

    monkeypatch.setattr(methods_mod, "local_step", ls)
    monkeypatch.setattr(fusion, "paired_fusion", pf)
    mx.port_run("fed2", 1, use_local_kernel=True)
    f32 = (torch.float32,) * 3
    assert calls == (
        [("local_step", (mx.N_CLIENTS, layout.size), f32)] * mx.STEPS
        + [("paired_fusion", (mx.N_CLIENTS, seg.size), seg.dtype)
           for seg in layout.segments])
    assert layout.size == sum(s.size for s in layout.slots)
    p = last["p"]
    bf16 = [(r.offset, r.size) for s, r in
            zip(layout.slots, layout.raveled.slots)
            if s.dtype == torch.bfloat16]
    rows = torch.cat([p[:, a:a + n] for a, n in bf16], dim=1)
    off_grid = (rows != rows.bfloat16().float()).float().mean().item()
    assert off_grid > 0.5, off_grid
