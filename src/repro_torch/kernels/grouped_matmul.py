"""Block-diagonal (grouped) matrix product: Fed2's decoupled layers.

Replaces the TPU kernel ``grouped_matmul_kernel`` of
``src/repro/kernels/grouped_matmul.py`` together with its wrapper
(``repro/kernels/ops.py:grouped_matmul``) and oracle
(``repro/kernels/ref.py:grouped_matmul_ref``): ``y[..., g*N:(g+1)*N] =
x[..., g*K:(g+1)*K] @ w[g]`` for x (..., G*K) and w (G, K, N), fp32
accumulation, the result in x's dtype, plus an optional (G, N) bias.
The kernel is CUDA C++ for Hopper in ``csrc/grouped_matmul.cu``, built
by ``kernels/build.py`` and bound with ctypes.

Bound on the H100: bytes at the serving shapes (the Fed2 unembedding
of Mamba-2 1.3B: M = batch, G = 8, K = 256, N = 6288, bf16; 25.8 MB of
weights, 7.8 us at 3.35 TB/s at M = 4; with x and y 11.7 us at M =
128). The TPU kernel needs M, K and N padded to 128 (its wrapper pads);
the CUDA kernel pads nothing. ``route`` picks one of its four designs
from the shapes, the dtype and the pointers' alignment:

- ``"stream"`` (M <= 8): the decode GEMV; w streams through a ring of
  shared-memory stages fed by TMA; bf16 runs the tensor cores with the
  operands swapped (wgmma m64n8k16 on w^T x^T), fp32 runs FMAs; every
  sum in a fixed order;
- ``"wgmma"`` (M > 8, bf16): a GEMM per group on the tensor cores, TMA
  tiles of 128 rows in a ring, persistent blocks; past one row tile the
  blocks run in clusters of 2 on neighbouring row tiles that share w's
  boxes (TMA multicast), tiles go row tiles fastest so that the blocks
  in flight share w's tiles in L2, and each consumer warp stores its
  rows through its own shared-memory chunks. At the M = 4096 eval
  chunks it is bound by the operand bytes that fill shared memory with
  the stores of y, and by the products with their epilogues, each near
  the whole time (PERF.md §6, tools/gmm_plans.py breakdown); 256-column
  tiles and the pairs cut the bytes from L2 by 40 % at Mamba-2's chunk;

  on both bf16 routes ``plan`` sizes the work: the stream route keeps
  (1, 192) where 192-column units fill the card, else the narrowest
  width whose units fit one wave; the wgmma route takes the width (64,
  128, 192 or 256) of the least waves times a tile's modelled time plus
  the last wave's stores (256 at every eval chunk), and past 16 stages
  of K a split, it splits K over a thread-block cluster of S blocks,
  whose partials meet in distributed shared memory, summed in rank
  order;
- ``"sgemm"`` (M > 8, fp32): a SIMT GEMM per group, 128 x 256 tiles,
  8 x 16 outputs a thread fed by 16-byte shared-memory reads, w by TMA
  and x by cp.async copies in a ring of stages, M fastest so w comes
  from HBM about once; the same bits as ``"simt"``;
- ``"simt"`` (strides and pointers TMA does not take: K or N not a
  multiple of 16 bytes, an x or w off 16 bytes): shared-memory tiles
  and fp32 FMAs.

The kernel checks the route's and the plan's preconditions and refuses
(the wrapper raises) when they fail; nothing switches route or plan or
falls back.

``grouped_matmul`` is the wrapper: on CPU tensors it computes
``grouped_matmul_ref``; on CUDA tensors it launches the kernel or
raises. The bias is added outside the kernel, as the reference's
wrapper adds it. ``launch`` runs one named route, under ``plan``'s
plan or a given one, on checked inputs (``chip_smoke.py`` holds the
sgemm route to the simt route's bits, and every unsplit plan to
``DEFAULT_PLAN``'s, through it). ``grouped_matmul.launches`` counts
kernel launches (one per call), ``grouped_matmul.route_launches``
the launches of each route and ``grouped_matmul.shape_launches`` those
of each (M, G, K, N, dtype). The kernel has no backward: it serves
no-grad passes only (``models.layers.grouped_dense_apply(use_kernel=
True)``: decode, the LM eval and prefill losses, the federated LM
eval). Its output, written
through a raw pointer, carries no ``grad_fn``, so on CUDA tensors the
wrapper raises when autograd is recording and an input requires grad
(``check_no_autograd``), rather than return a result that would cut
the gradient silently.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/grouped_matmul.cu's codes (its enum Route)
ROUTES = ("stream", "wgmma", "simt", "sgemm")
# csrc/grouped_matmul.cu's limits: rows of the stream route; groups (a
# grid dimension of the stream and simt routes) and simt row tiles (of
# _SIMT_TILE_M); the sgemm route's tiles, whose count is its grid; TMA
# coordinates
_STREAM_MAX_M = 8
_MAX_GRID_YZ = 65535
_SIMT_TILE_M = 64
_SGEMM_TILE = (128, 256)
_MAX_COORD = 2 ** 31 - 1
# the plans of the bf16 stream and wgmma routes: units of one of
# _PLAN_COLS columns (stream) or tiles of one of _WGMMA_COLS (wgmma); on
# the wgmma route K split over a cluster of at most _MAX_SPLITS blocks (a
# power of two) in tiles of _SPLIT_COLS columns. K goes in stages of
# _STAGE_K[route] rows; the wgmma route's tiles have _WGMMA_TILE_M rows,
# and past one row tile its unsplit kernel runs in clusters of
# _WGMMA_PAIR blocks along M that share w's boxes; ``plan`` keeps at
# least _SPLIT_MIN_STAGES stages a split and splits into
# _WGMMA_MAX_SPLITS at most (measured, see ``plan``). Every other route
# takes DEFAULT_PLAN.
_MAX_SPLITS = 8
_PLAN_COLS = (64, 128, 192)
_WGMMA_COLS = (64, 128, 192, 256)
_SPLIT_COLS = (64, 128)
_STAGE_K = {"stream": 128, "wgmma": 64}
_WGMMA_TILE_M = 128
_WGMMA_PAIR = 2
# ``plan``'s model of the unsplit wgmma kernel: an SM's share of the
# H100's rates, the bf16 peak, the 8.5 TB/s at which it filled shared
# memory from L2 (1.38 GB in 162.5 us with the products and stores taken
# out, tools/gmm_plans.py breakdown, H100 80GB HBM3 at 700 W) and device
# memory's 3.35 TB/s; and a tile's fixed cost (its first stage's wait
# and its epilogue), 1 us, with which the model takes the fastest width
# that tools/gmm_plans.py widths measured, or one within 1.5 % of it, at
# every unsplit wgmma row of the check phase
_WGMMA_TILE_S = 1e-6
_SM_FLOPS = 989e12 / 132
_SM_FILL_BYTES = 8.5e12 / 132
_SM_HBM_BYTES = 3.35e12 / 132
_SPLIT_MIN_STAGES = 16
_WGMMA_MAX_SPLITS = 2
DEFAULT_PLAN = (1, 192)


def route(m: int, g: int, k: int, n: int, dtype: torch.dtype,
          x_ptr: int, w_ptr: int) -> str:
    """Which design of the kernel takes x (m, g*k) and w (g, k, n) of
    ``dtype`` at these addresses: ``"stream"``, ``"wgmma"``,
    ``"sgemm"`` or ``"simt"``. The TMA routes read w as (g, k, n) (and
    stream and wgmma x as (m, g, k)) through tensor maps, which need
    16-byte aligned bases, k and n multiples of 16 bytes (a box starts
    on a 16-byte boundary) and int32 coordinates; sgemm, which copies x
    4 bytes at a time, is held to the same conditions, and simt takes
    the rest."""
    esize = dtype.itemsize
    tma = (n * esize % 16 == 0 and k * esize % 16 == 0
           and x_ptr % 16 == 0 and w_ptr % 16 == 0
           and g * k <= _MAX_COORD and n <= _MAX_COORD)
    if tma and m <= _STREAM_MAX_M:
        return "stream"
    if tma:
        return "wgmma" if dtype == torch.bfloat16 else "sgemm"
    return "simt"


def _planned(r: str, dtype: torch.dtype) -> bool:
    """Whether route ``r`` in ``dtype`` takes plans other than
    ``DEFAULT_PLAN``: the bf16 stream and wgmma routes."""
    return dtype == torch.bfloat16 and r in _STAGE_K


def wgmma_tile_s(m: int, k: int, cols: int) -> float:
    """The modelled time (s) of one unsplit wgmma tile of ``cols``
    columns over K = ``k`` on one SM: a fixed _WGMMA_TILE_S, then the
    longest of its products at the SM's share of the bf16 peak, its
    operand bytes (x's 128 x K box, and its share of w's K x cols boxes:
    half where a cluster pair shares them, past one row tile) at the SM's
    share of the measured fill rate from L2, and its w bytes from device
    memory (shared by the tile's ceil(m / 128) row tiles) at the SM's
    share of 3.35 TB/s."""
    tm = _WGMMA_TILE_M
    pair = _WGMMA_PAIR if m > tm else 1
    flops = 2 * tm * cols * k
    nbytes = 2 * k * (tm + cols / pair)
    w_bytes = 2 * k * cols / -(-m // tm)
    return _WGMMA_TILE_S + max(flops / _SM_FLOPS, nbytes / _SM_FILL_BYTES,
                               w_bytes / _SM_HBM_BYTES)


def wgmma_plan_s(m: int, g: int, k: int, n: int, cols: int,
                 sms: int) -> float:
    """The modelled time (s) of the unsplit wgmma kernel at ``cols``
    columns on ``sms`` SMs: ceil(tiles / sms) waves of ``wgmma_tile_s``,
    and the last wave's stores, which no load overlaps (its 128 x cols
    bf16 tile at the SM's share of device memory)."""
    tiles = g * -(-m // _WGMMA_TILE_M) * -(-n // cols)
    tail = _WGMMA_TILE_M * cols * 2 / _SM_HBM_BYTES
    return -(-tiles // sms) * wgmma_tile_s(m, k, cols) + tail


def plan(r: str, m: int, g: int, k: int, n: int, sms: int,
         dtype: torch.dtype = torch.bfloat16) -> tuple[int, int]:
    """(splits, columns) for route ``r`` on x (m, g*k), w (g, k, n) on a
    card of ``sms`` SMs.

    Stream: where 192-column units number at least ``sms``,
    ``DEFAULT_PLAN`` (1, 192); else the narrowest of 64, 128 and 192
    columns whose units still fit one wave of ``sms`` blocks (more
    blocks, each with fewer bytes). The stream route does not split: two
    splits of 16 of its 128-row stages need 4,096 rows of K a group,
    which no product on a path has (at most 2,368).

    wgmma: by waves. For each of _WGMMA_COLS it reckons ceil(tiles / sms)
    times a tile's modelled time (``wgmma_tile_s``) plus the last wave's
    stores (``wgmma_plan_s``) and takes the least, the widest on a tie:
    the M = 4096 eval chunks, bound by the operand bytes that fill shared
    memory, take 256 columns; an unembedding at M = 64-128, bound by w's
    bytes from device memory, the width whose waves and last stores cost
    least (danube's and mixtral's two waves of 128 columns, whose first
    stores run under the second wave's loads, rather than one of 256);
    the decoupled FFN products, under one wave, the narrowest. Then K is
    split over a cluster of S = 2 where that leaves every split at least
    _SPLIT_MIN_STAGES stages of K and tiles x S within the wave: on the
    H100 the split's reduction costs about what 16 stages take, so
    shorter K stays whole, and clusters of 4 or 8 one-SM blocks do not
    all fit the card's GPCs at once. fp32 and the sgemm and simt routes
    take ``DEFAULT_PLAN``."""
    if not _planned(r, dtype):
        return DEFAULT_PLAN
    rows = 1 if r == "stream" else -(-m // _WGMMA_TILE_M)

    def units(cols):
        return g * rows * -(-n // cols)

    if r == "stream":
        if units(DEFAULT_PLAN[1]) >= sms:
            return DEFAULT_PLAN
        return 1, next(c for c in _PLAN_COLS if units(c) <= sms or c == 192)
    cols = min(_WGMMA_COLS,
               key=lambda c: (wgmma_plan_s(m, g, k, n, c, sms), -c))
    stages = -(-k // _STAGE_K[r])
    splits = 1
    while (cols in _SPLIT_COLS and 2 * splits <= _WGMMA_MAX_SPLITS and
           stages >= 2 * splits * _SPLIT_MIN_STAGES and
           2 * splits * units(cols) <= sms):
        splits *= 2
    return splits, cols


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: x (..., G*K), w (G, K, N), b (G, N) ->
    (..., G*N)."""
    g, k, n = w.shape
    xg = x.reshape(x.shape[:-1] + (g, k))
    y = torch.einsum("...gk,gkn->...gn", xg, w)
    if b is not None:
        y = y + b
    return y.reshape(x.shape[:-1] + (g * n,))


def _library() -> ctypes.CDLL:
    lib = build.load("grouped_matmul")
    fn = lib.grouped_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.grouped_matmul_dynamic_smem.argtypes = [ctypes.c_int] * 4
    lib.grouped_matmul_dynamic_smem.restype = ctypes.c_int
    lib.grouped_matmul_wgmma_pairs.argtypes = [ctypes.c_int]
    lib.grouped_matmul_wgmma_pairs.restype = ctypes.c_int
    return lib


def dynamic_smem(route_name: str, dtype: torch.dtype,
                 p: tuple[int, int] = DEFAULT_PLAN) -> int:
    """Bytes of dynamic shared memory a block of ``route_name`` takes
    under plan ``p`` (builds the kernel)."""
    return _library().grouped_matmul_dynamic_smem(
        ROUTES.index(route_name), _DTYPE_CODES[dtype], *p)


def wgmma_pairs(cols: int) -> int:
    """Clusters of the unsplit wgmma kernel's row-tile pairs at ``cols``
    columns that the current card holds at once (builds the kernel)."""
    return _library().grouped_matmul_wgmma_pairs(cols)


_SMS: dict[int, int] = {}


def _sms(device: torch.device) -> int:
    """The card's streaming multiprocessors, read once per device."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _check(x, w, b):
    if w.dim() != 3 or x.dim() < 1 or x.shape[-1] != w.shape[0] * w.shape[1]:
        raise ValueError(
            f"grouped_matmul takes x (..., G*K) and w (G, K, N), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.numel() == 0 or w.numel() == 0:
        raise ValueError("grouped_matmul takes non-empty x and w")
    if b is not None and tuple(b.shape) != (w.shape[0], w.shape[2]):
        raise ValueError(f"grouped_matmul: bias must be (G, N) = "
                         f"{(w.shape[0], w.shape[2])}, got {tuple(b.shape)}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(
            f"grouped_matmul takes float32 or bfloat16 x and w of one "
            f"dtype, got {x.dtype} and {w.dtype}")
    if w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError("grouped_matmul: x, w and b must share a device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped_matmul needs contiguous (row-major) x "
                         "and w")


def check_no_autograd(x, w, b) -> None:
    """Raise when autograd records the call (grad mode on and an input
    requires grad): the kernel's output would carry no ``grad_fn``, and
    a gradient through it would be lost."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        raise RuntimeError(
            "grouped_matmul has no backward: called with grad enabled on "
            "inputs that require grad, its result would be detached and "
            "cut the gradient. Train through the einsum route "
            "(grouped_dense_apply(use_kernel=False)) and take the kernel "
            "under torch.no_grad() only")


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None = None) -> torch.Tensor:
    """Block-diagonal product ``x @ blockdiag(w) (+ b)``: x (..., G*K),
    w (G, K, N), b (G, N) or None -> (..., G*N) in x's dtype. CPU
    tensors take ``grouped_matmul_ref``; CUDA tensors launch the kernel,
    under no autograd only (``check_no_autograd``)."""
    _check(x, w, b)
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul: unsupported device {x.device}")
    check_no_autograd(x, w, b)
    g, k, n = w.shape
    y = launch(x, w, route(x.numel() // (g * k), g, k, n, x.dtype,
                           x.data_ptr(), w.data_ptr()))
    if b is not None:
        y = (y.view(-1, g, n) + b).view(-1, g * n)
    return y.reshape(x.shape[:-1] + (g * n,))


def _grid_fits(r: str, m: int, g: int, n: int,
               p: tuple[int, int] = DEFAULT_PLAN) -> bool:
    """Whether route ``r``'s grid holds the call under plan ``p``:
    stream and simt put G on a 65,535-wide grid dimension (simt its row
    tiles too), and stream its units on one of 2^31 - 1; sgemm launches
    one block a tile, at most 2^31 - 1, and a split wgmma plan S blocks
    a tile, at most 2^31 - 1 (unsplit, its blocks are persistent)."""
    splits, cols = p
    if r == "sgemm":
        bm, bn = _SGEMM_TILE
        return g * -(-m // bm) * -(-n // bn) <= _MAX_COORD
    if r == "stream":
        return g <= _MAX_GRID_YZ and -(-n // cols) <= _MAX_COORD
    if r == "wgmma":
        return g * -(-m // _WGMMA_TILE_M) * -(-n // cols) * splits \
            <= _MAX_COORD
    return g <= _MAX_GRID_YZ and -(-m // _SIMT_TILE_M) <= _MAX_GRID_YZ


def launch(x: torch.Tensor, w: torch.Tensor, r: str,
           p: tuple[int, int] | None = None) -> torch.Tensor:
    """Route ``r``'s kernel on checked CUDA inputs, x (..., G*K) and w
    (G, K, N), under plan ``p`` (splits, columns; ``plan``'s when None):
    y (M, G*N) for the M rows of x, counted in
    ``grouped_matmul.launches`` and ``route_launches[r]``. Builds the
    kernel first; raises where the kernel refuses the route or the plan
    (their preconditions, checked on the C side), the card cannot hold
    the plan's cluster, or the grid cannot hold the call; nothing
    switches route or plan."""
    lib = _library()
    g, k, n = w.shape
    m = x.numel() // (g * k)
    if p is None:
        p = plan(r, m, g, k, n, _sms(x.device), x.dtype) \
            if _planned(r, x.dtype) else DEFAULT_PLAN
    if not _grid_fits(r, m, g, n, p):
        raise ValueError(f"grouped_matmul: M = {m} or G = {g} exceeds the "
                         f"kernel's grid ({r} route, plan {p})")
    xm = x.reshape(m, g * k)
    y = torch.empty((m, g * n), dtype=xm.dtype, device=xm.device)
    with torch.cuda.device(xm.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.grouped_matmul_launch(
            xm.data_ptr(), w.data_ptr(), y.data_ptr(), m, g, k, n,
            _DTYPE_CODES[xm.dtype], ROUTES.index(r), p[0], p[1], stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed ({r} "
                           f"route, plan {p}): CUDA error {err}")
    grouped_matmul.launches += 1
    grouped_matmul.route_launches[r] += 1
    grouped_matmul.shape_launches[m, g, k, n, str(xm.dtype)] += 1
    return y


grouped_matmul.launches = 0
grouped_matmul.route_launches = dict.fromkeys(ROUTES, 0)
grouped_matmul.shape_launches = collections.Counter()
