"""LM federation on a params tree that mixes dtypes, plain local route:
``run_federated(lm_task)`` on the reduced Fed2 Mamba-2 at bf16 (its
``a_log``, ``dt_bias`` and ``d_skip`` in fp32) against the JAX package,
which keeps every leaf in its own dtype. The port keeps one cohort
buffer per dtype (``FlatLayout``'s segments): fedavg and fed2 over two
rounds, through either fusion route, every final leaf in the
reference's dtype and within its dtype's limit (tests/mixed_lm_fl.py).
Also: the layout's segments and its raveled buffer, one
``paired_fusion`` launch per segment a round, the per-leaf launches
under presence rows, and that a tree of one dtype keeps its one buffer.
"""
import math

import ml_dtypes
import numpy as np
import pytest
import torch

import mixed_lm_fl as mx
from repro_torch.convert import lm_to_port
from repro_torch.core import fusion
from repro_torch.fl import runtime as rt
from repro_torch.models.module import (FlatLayout, Segments, tree_leaves,
                                       tree_map)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite's xdist workers share the cores
    (see tests/test_torch_eq9_kernel_route.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_init():
    return lm_to_port(mx.jax_init())


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


def test_mixed_layout_keeps_one_segment_per_dtype():
    """Segments in the order of each dtype's first leaf (bf16: the first
    leaf is the bf16 ln1 scale), slots in tree order within each, each
    row stride rounded up to 64; flatten/unflatten and ravel/unravel
    round-trip exactly, the raveled buffer fp32 in tree order (the
    layout of one buffer of the whole tree)."""
    params = _port_init()
    layout = FlatLayout(params)
    assert layout.dtypes == (torch.bfloat16, torch.float32)
    for seg in layout.segments:
        sizes = [s.size for s in seg.slots]
        assert [s.offset for s in seg.slots] == \
            list(np.cumsum([0] + sizes[:-1]))
        assert seg.size == sum(sizes)
        assert seg.stride == math.ceil(seg.size / 64) * 64
        assert all(s.dtype == seg.dtype for s in seg.slots)
    assert {s.path for s in layout.slots if s.dtype == torch.float32} == \
        {("blocks", "mixer", k) for k in mx.FP32_LEAVES}
    flat = layout.flatten(params)
    assert isinstance(flat, Segments)
    assert [p.dtype for p in flat] == [torch.bfloat16, torch.float32]
    for a, b in zip(tree_leaves(layout.unflatten(flat)),
                    tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    wide = layout.ravel(flat)
    one = FlatLayout(params, by_dtype=False)
    assert wide.dtype == torch.float32 and wide.shape == (layout.size,)
    assert [s.offset for s in layout.raveled.slots] == \
        [s.offset for s in one.slots]
    for a, b in zip(tree_leaves(one.unflatten(wide)), tree_leaves(params)):
        assert torch.equal(a, b.float())
    back = layout.unravel(wide)
    assert all(torch.equal(a, b) for a, b in zip(back, flat))
    out = layout.unravel(wide, out=layout.alloc())
    assert all(torch.equal(a, b) for a, b in zip(out, flat))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_dtype_tree_keeps_its_one_buffer(dtype):
    """A tree of one dtype keeps one segment with the offsets and the
    row stride of one flat buffer, ravels to itself (no copy) and
    flattens into one tensor of its dtype."""
    params = tree_map(lambda t: t.to(dtype), _port_init())
    layout = FlatLayout(params)
    sizes = [math.prod(t.shape) for t in tree_leaves(params)]
    assert len(layout.segments) == 1 and layout.dtypes == (dtype,)
    assert [s.offset for s in layout.slots] == \
        list(np.cumsum([0] + sizes[:-1]))
    assert layout.size == sum(sizes)
    assert layout.stride == math.ceil(sum(sizes) / 64) * 64
    assert layout.raveled is layout
    flat = layout.flatten(params)
    assert isinstance(flat, torch.Tensor) and flat.dtype == dtype
    assert layout.ravel(flat) is flat and layout.unravel(flat) is flat
    buf = layout.alloc((3,))
    assert isinstance(buf, torch.Tensor) and buf.dtype == dtype
    assert buf.stride() == (layout.stride, 1)


def test_flatten_refuses_a_leaf_of_another_dtype():
    params = _port_init()
    layout = FlatLayout(params)
    wrong = tree_map(lambda t: t.float(), params)
    with pytest.raises(ValueError, match="bfloat16|float32"):
        layout.flatten(wrong, out=layout.alloc())


# ---------------------------------------------------------------------------
# run_federated(lm_task) against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fusion_route", ["kernel", "plain"])
@pytest.mark.parametrize("method", ["fedavg", "fed2"])
def test_mixed_lm_task_matches_reference(method, fusion_route):
    """Two rounds from the reference's bf16 init, on the plain local
    route (each segment steps in its dtype), fused through the
    paired_fusion route (its plain version on the CPU: fp32
    accumulation, each segment written in its dtype) or the reference's
    leaf-dtype products: every leaf in the reference's dtype, fp32 leaves
    within 10 % of their update, bf16 leaves within 2^-7, and the fp32
    a_log off the bf16 grid as the reference's is (a bf16 buffer would
    put it there)."""
    want = mx.jax_run(method, 2)
    got = mx.port_run(method, 2, use_kernel=fusion_route == "kernel")
    assert got["round"] == [0, 1]
    mx.assert_parity(got["final_params"], want["final_params"])
    np.testing.assert_allclose(got["acc"], want["acc"],
                               atol=1.0 / (16 * mx.SEQ))
    a_log = got["final_params"]["blocks"]["mixer"]["a_log"].numpy()
    off_grid = np.abs(a_log - a_log.astype(ml_dtypes.bfloat16).astype(
        np.float32)).max()
    assert off_grid > 1e-3, off_grid


def test_mixed_fusion_launches_once_per_segment(monkeypatch):
    """With shared sample weights fed2 fuses each dtype's (4, M_d)
    buffer in one paired_fusion call: two a round, the bf16 one and the
    fp32 one. No local_step call on the plain route."""
    from repro_torch.fl import methods as methods_mod
    calls = []
    real = fusion.paired_fusion

    def counting(x, w, out=None):
        calls.append((tuple(x.shape), x.dtype))
        return real(x, w, out=out)

    monkeypatch.setattr(fusion, "paired_fusion", counting)
    monkeypatch.setattr(methods_mod, "local_step", None)
    mx.port_run("fed2", 2)
    layout = FlatLayout(_port_init())
    per_round = [((mx.N_CLIENTS, seg.size), seg.dtype)
                 for seg in layout.segments]
    assert calls == per_round * 2


def test_mixed_presence_fusion_launches_per_leaf_and_block(monkeypatch):
    """Under presence rows the kernel route makes one launch per shared
    leaf and one per (pre, group) block of each grouped leaf, on the
    segment that holds it, and writes each segment in its dtype: the
    fp32 fusion rounded once to that dtype (within one ulp of the result:
    2^-7 relative for bf16, 1e-6 for fp32)."""
    params = _port_init()
    layout = FlatLayout(params)
    _, tc = mx.configs()
    ga = fusion.lm_group_axes(params, tc)
    gen = torch.Generator().manual_seed(0)
    stacked = layout.join(
        torch.randn((mx.N_CLIENTS, seg.size), generator=gen).to(seg.dtype)
        for seg in layout.segments)
    gw = torch.rand((mx.N_CLIENTS, 4), generator=gen)
    gw[0, 1] = 0.0
    w = torch.rand(mx.N_CLIENTS, generator=gen) + 0.1
    n = [0]
    real = fusion.paired_fusion

    def counting(x, wt, out=None):
        n[0] += 1
        return real(x, wt, out=out)

    monkeypatch.setattr(fusion, "paired_fusion", counting)
    got = fusion.paired_average(stacked, layout, ga, weights=w,
                                group_weights=gw, use_kernel=True)
    blocks = sum(1 if a is None else
                 math.prod(s.shape[:a.axis]) * a.n_groups
                 for s, a in zip(layout.slots, layout.leaves(ga)))
    assert n[0] == blocks > len(layout.slots)
    want = fusion.paired_average(tree_map(lambda x: x.float(), stacked),
                                 layout, ga, weights=w, group_weights=gw,
                                 use_kernel=False)
    for g, p, dt in zip(got, want, layout.dtypes):
        assert g.dtype == dt
        tol = 1e-6 if dt == torch.float32 else 2.0 ** -7
        torch.testing.assert_close(g.float(), p.to(dt).float(), rtol=tol,
                                   atol=1e-6)


@pytest.mark.parametrize("method,kernel", [("fed2", False), ("fed2", True),
                                           ("scaffold", False)])
def test_grad_chunk_keeps_the_round(method, kernel):
    """run_federated(grad_chunk=...) takes each local step's vmapped
    gradients a few clients at a time (the memory that lets a cohort of
    full-depth rows fit one card): on the CPU the round is the same to
    the bit."""
    whole = mx.port_run(method, 1, use_local_kernel=kernel)
    chunked = mx.port_run(method, 1, grad_chunk=1, use_local_kernel=kernel)
    for a, b in zip(tree_leaves(whole["final_params"]),
                    tree_leaves(chunked["final_params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("bad", [0, -1, 1.5, True])
def test_grad_chunk_must_be_a_positive_int(bad):
    with pytest.raises(ValueError, match="grad_chunk"):
        mx.port_run("fedavg", 1, grad_chunk=bad)
