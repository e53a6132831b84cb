"""Fused Mamba-2 SSD single-token decode: state update and readout.

Replaces the TPU kernel ``ssd_update_kernel`` of
``src/repro/kernels/ssd_update.py`` together with its wrapper
(``repro/kernels/ops.py:ssd_update``) and oracle
(``repro/kernels/ref.py:ssd_update_ref``)::

    h' = exp(dt * -exp(a_log)) * h + dt * (x outer b)
    y  = h' @ c + d_skip * x

for the state h (B, H, P, N) fp32, x (B, H, P), dt (B, H) fp32, b and c
(B, N) in x's dtype, a_log and d_skip (H,) fp32; h' comes back fp32 and
y in x's dtype. The kernel is CUDA C++ for Hopper in
``csrc/ssd_update.cu``, built by ``kernels/build.py`` and bound with
ctypes.

Bound on the H100: bytes. The state is read once and written once; at
3.35 TB/s that is 5.03 us for Mamba-2 1.3B's (4, 64, 64, 128) and
160.92 us at batch 128, 3.16 and 100.97 us for Zamba2's (4, 80, 64,
64). The TPU kernel pads H to its head block; the CUDA kernel takes any
H, P and N and pads nothing. ``route`` picks the kernel's design from
the shapes and the addresses, before the launch, and sizes its work
unit:

- ``"tma"`` (N % 4 == 0, 4 <= N <= 256, h and h' 16-byte aligned, x, b
  and c in whole 4-byte copies: every shape the models decode): work
  units of ``unit_rows`` rows of one (b, h) state tile, each brought to
  a block's shared memory by a TMA bulk copy, with its side data (dt,
  a_log, d_skip, x, b, c) by the threads' cp.async copies, all landing
  on one mbarrier. A row's N / 4 16-byte chunks spread over a power of
  two of a warp's lanes, so every lane works at N = 64 as at N = 128.
  Each unit (16 KB of state, 8 KB where twice the units still fit one
  wave of the card) has a block of its own, and the card's block
  scheduler hands the next unit to whichever SM frees a block first
  (persistent blocks streaming units through a ring of stages measured
  slower, PERF.md);
- ``"scalar"`` (the rest: N % 4 != 0, N > 256, an unaligned state, x,
  b or c off 4 bytes): one block per (b, h) pair, each lane on 4
  columns (16-byte loads, when N % 4 == 0 and the state is aligned) or
  on one.

Both reduce y in a fixed order: a run gives the same bits every time.
Nothing switches route or falls back after the choice; the kernel
checks the route's preconditions and refuses (the wrapper raises).

``ssd_update`` is the wrapper: on CPU tensors it computes
``ssd_update_ref``; on CUDA tensors it launches the kernel or raises.
``ssd_update.launches`` counts kernel launches (one per call),
``ssd_update.route_launches`` those of each route and
``ssd_update.shape_launches`` those of each (B, H, P, N, x's dtype).
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("tma", "scalar")             # csrc/ssd_update.cu's codes
_INT_MAX = 2 ** 31 - 1
# csrc/ssd_update.cu's limits, which it checks on every launch (a test
# compares these with its source): threads a block; blocks an SM holds
# (__launch_bounds__); passes of the block over a unit's rows, and a
# unit's rows; N of the TMA route (2 chunks a lane) and of the scalar one
# (b, c in 48 KB of shared memory)
THREADS = 256
MIN_BLOCKS = 5
MAX_PASSES = 4
MAX_UNIT_ROWS = 128
TMA_MAX_N = 256
SCALAR_MAX_N = 6144
# the TMA route's unit: its bytes of state at most
UNIT_BYTES = 16384


class Plan(NamedTuple):
    """How the kernel runs one call: the route, and the rows of a work
    unit (P on the scalar route, whose block takes a whole (b, h) tile).
    A block takes one unit."""
    route: str
    unit_rows: int


def lanes_per_row(n: int) -> int:
    """Lanes of a warp that share one row on the TMA route: the power of
    two >= N / 4 (its 16-byte chunks), at most 32."""
    return min(32, 1 << max(0, (n // 4 - 1).bit_length()))


def route(batch: int, heads: int, p: int, n: int, ptrs: tuple,
          strides: tuple = (0, 0, 0), esize: int = 4,
          sms: int = 132) -> Plan:
    """The kernel's plan for a (batch, heads, p, n) state on a card of
    ``sms`` SMs. ``ptrs`` are the addresses of h, h', x, b and c,
    ``strides`` the batch strides of x, b and c (elements), ``esize`` the
    bytes of an element of x. The TMA route needs N a multiple of 4
    (16-byte chunks), N <= TMA_MAX_N, h and h' 16-byte aligned (bulk
    copies), and x, b and c in 4-byte copies: their addresses 4-byte
    aligned, their batch strides and P whole 4 bytes.

    Its unit is whole passes of the block's rows (MAX_PASSES at most,
    and at most UNIT_BYTES of state and MAX_UNIT_ROWS rows), or all P
    rows where P is less: so its rows are whole 4 bytes of x as P's are.
    The passes are halved (down to one) while the units of half as many
    still fit one wave of the card (the SMs times MIN_BLOCKS), so a small
    batch spreads over more SMs."""
    h_ptr, out_ptr, *side = ptrs
    if not (n % 4 == 0 and 4 <= n <= TMA_MAX_N and h_ptr % 16 == 0
            and out_ptr % 16 == 0 and all(q % 4 == 0 for q in side)
            and all(t * esize % 4 == 0 for t in (*strides, p))):
        return Plan("scalar", p)
    pass_rows = THREADS // lanes_per_row(n)

    def rows(passes):
        return min(p, passes * pass_rows, MAX_UNIT_ROWS)

    passes = MAX_PASSES
    while passes > 1 and rows(passes) * n * 4 > UNIT_BYTES:
        passes //= 2
    while passes > 1 and batch * heads * -(-p // rows(passes // 2)) \
            <= sms * MIN_BLOCKS:
        passes //= 2
    return Plan("tma", rows(passes))


def ssd_update_ref(h, x, dt, a_log, b, c, d_skip):
    """The plain version (mirrors ``models.ssm.ssd_step``); returns
    (h' in h's dtype, y in x's dtype)."""
    a = -torch.exp(a_log.to(torch.float32))
    decay = torch.exp(dt.to(torch.float32) * a)              # (B, H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt.to(torch.float32),
                       b.to(torch.float32), x.to(torch.float32))
    hnew = decay[..., None, None] * h.to(torch.float32) + upd
    y = torch.einsum("bn,bhpn->bhp", c.to(torch.float32), hnew)
    y = y + d_skip[None, :, None] * x.to(torch.float32)
    return hnew.to(h.dtype), y.to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("ssd_update")
    fn = lib.ssd_update_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(h, x, dt, a_log, b, c, d_skip, out):
    if h.dim() != 4:
        raise ValueError(f"ssd_update takes a (B, H, P, N) state, got "
                         f"{tuple(h.shape)}")
    bs, hh, p, n = h.shape
    shapes = {"x": (x, (bs, hh, p)), "dt": (dt, (bs, hh)),
              "a_log": (a_log, (hh,)), "b": (b, (bs, n)), "c": (c, (bs, n)),
              "d_skip": (d_skip, (hh,))}
    if out is not None:
        shapes["out"] = (out, (bs, hh, p, n))
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"ssd_update: {name} must be {want} for the "
                             f"state {tuple(h.shape)}, got {tuple(t.shape)}")
        if t.device != h.device:
            raise ValueError("ssd_update: every input must lie on the "
                             "state's device")
    if h.numel() == 0:
        raise ValueError("ssd_update takes a non-empty state")
    for name, t in (("h", h), ("dt", dt), ("a_log", a_log),
                    ("d_skip", d_skip), ("out", out)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"ssd_update: {name} must be float32, got "
                            f"{t.dtype}")
    if x.dtype not in _DTYPE_CODES or b.dtype != x.dtype or \
            c.dtype != x.dtype:
        raise TypeError(f"ssd_update: x, b and c must be float32 or "
                        f"bfloat16 of one dtype, got {x.dtype}, {b.dtype}, "
                        f"{c.dtype}")
    if not all(t.is_contiguous() for t in (h, dt, a_log, d_skip)) or \
            (out is not None and not out.is_contiguous()):
        raise ValueError("ssd_update needs contiguous h, dt, a_log, d_skip "
                         "and out")
    # x, b and c may be views into a wider row (the decode's xbc): only
    # their batch stride is free
    if (hh > 1 and x.stride(1) != p) or (p > 1 and x.stride(2) != 1) or \
            (n > 1 and (b.stride(1) != 1 or c.stride(1) != 1)):
        raise ValueError("ssd_update: x needs contiguous (H, P) rows and "
                         "b, c contiguous N; only the batch stride is free")


def ssd_update(h, x, dt, a_log, b, c, d_skip, *, out=None):
    """One SSD decode step: returns (h', y). With ``out`` (fp32, the
    state's shape, and possibly ``h`` itself) h' is written into it and
    ``out`` is returned: ``models.ssm.mamba2_decode`` passes the cache's
    own state buffer, which is then updated in place. CPU tensors take
    ``ssd_update_ref``; CUDA tensors launch the kernel on ``route``'s
    plan."""
    _check(h, x, dt, a_log, b, c, d_skip, out)
    if h.device.type == "cpu":
        hnew, y = ssd_update_ref(h, x, dt, a_log, b, c, d_skip)
        if out is None:
            return hnew, y
        out.copy_(hnew)
        return out, y
    if h.device.type != "cuda":
        raise ValueError(f"ssd_update: unsupported device {h.device}")
    _library()                  # built before any memory is touched
    bs, hh, p, n = h.shape
    if n > SCALAR_MAX_N or bs * hh > _INT_MAX or p * n > _INT_MAX:
        raise ValueError(f"ssd_update: state {tuple(h.shape)} exceeds the "
                         f"kernel's limits (N <= {SCALAR_MAX_N})")
    hout = torch.empty_like(h) if out is None else out
    plan = route(bs, hh, p, n, pointers(h, hout, x, b, c),
                 (x.stride(0), b.stride(0), c.stride(0)), x.element_size(),
                 sm_count(h.device.index))
    y = torch.empty((bs, hh, p), dtype=x.dtype, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().ssd_update_launch(
            h.data_ptr(), hout.data_ptr(), x.data_ptr(), dt.data_ptr(),
            a_log.data_ptr(), b.data_ptr(), c.data_ptr(), d_skip.data_ptr(),
            y.data_ptr(), bs, hh, p, n, x.stride(0), b.stride(0),
            c.stride(0), _DTYPE_CODES[x.dtype], ROUTES.index(plan.route),
            plan.unit_rows, stream)
    if err != 0:
        raise RuntimeError(f"ssd_update kernel launch failed ({plan.route} "
                           f"route): CUDA error {err}")
    ssd_update.launches += 1
    ssd_update.route_launches[plan.route] += 1
    ssd_update.shape_launches[bs, hh, p, n, str(x.dtype)] += 1
    return hout, y


def pointers(h, hout, x, b, c) -> tuple:
    """The addresses ``route`` reads: h, h', x, b and c."""
    return tuple(t.data_ptr() for t in (h, hout, x, b, c))


ssd_update.launches = 0
ssd_update.route_launches = dict.fromkeys(ROUTES, 0)
ssd_update.shape_launches = collections.Counter()
