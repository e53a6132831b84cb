// Fused Mamba-2 SSD single-token state update + readout for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `ssd_update_kernel` of
// src/repro/kernels/ssd_update.py (its pl.pallas_call), the recurrence
// of every SSM layer of every decode step of Mamba-2 and Zamba2. For the
// state h (B, H, P, N) fp32 and x (B, H, P), dt (B, H), a_log (H,), b
// and c (B, N), d_skip (H,):
//     decay  = exp(dt[b,h] * -exp(a_log[h]))
//     h'     = decay * h + dt[b,h] * x[b,h,p] * b[b,n]
//     y[p]   = sum_n h'[p,n] * c[b,n] + d_skip[h] * x[b,h,p]
// in fp32; h' is stored fp32 and y in x's dtype (fp32 or bf16, which b
// and c share). h' may be written over h itself (in place).
//
// Bound on the H100: bytes. The state is read once and written once,
// 2 * B*H*P*N*4 bytes, against 6 flops per element; the vectors are
// small. At 3.35 TB/s: Mamba-2 (H = P = 64, N = 128) 5.03 us at batch 4
// and 160.92 us at batch 128; Zamba2 (H = 80, P = N = 64) 3.16 us and
// 100.97 us. So the design keeps bytes in flight on every SM with every
// thread at work, and no thread waiting on a load it issued itself. Two
// routes, chosen before the launch by the wrapper's `route`
// (kernels/ssd_update.py), which also sizes the TMA route's work unit;
// this file checks the route's preconditions and refuses a launch that
// breaks them.
//
// Route 0, TMA (N % 4 == 0, 4 <= N <= 256; h and h' 16-byte aligned; x,
// b and c in whole 4-byte copies):
// - Work units of `unit_rows` rows of one (b, h) tile, one unit a block:
//   the card's block scheduler hands the next unit to whichever SM frees
//   a block first. (Persistent blocks walking static shares of units
//   through a ring of stages measured slower at batch 128 and no faster
//   at batch 4, PERF.md §6.)
// - A unit's state comes to shared memory by one TMA bulk copy
//   (cp.async.bulk, global to shared) issued by thread 0; its side data
//   (dt, a_log, d_skip, x of its rows, b and c of its batch row, in x's
//   dtype) by every thread's share of 4-byte cp.async copies, each thread
//   arriving on the block's mbarrier once its copies land. So the barrier
//   completes when the whole unit is there, and the threads never wait
//   on a load where it is issued (a bf16 value converted right after its
//   load would stall the thread for the full memory latency).
// - A thread mapping that does not depend on N: a row is N / 4 chunks of
//   16 bytes, spread over `lanes` = the power of two >= N / 4 (at most
//   32) of a warp, each lane taking chunks lane, lane + lanes (K of them,
//   K = 1 or 2). So a warp covers 32 / lanes rows: 2 at N = 64 (Zamba2),
//   1 at N = 128 (Mamba-2), and every lane loads and stores. A block's
//   passes over the unit's rows go side by side (all the loads, then the
//   products and stores, then the sums). y of a row is a butterfly (xor
//   shuffles) over its lanes in a fixed order, so the bits are the same
//   on every run.
// - h' goes back from registers, 16 bytes a thread (bulk stores from
//   shared memory measured slower). In place (h' over h) stays safe: each
//   unit is read and written by one block, and read before it is written.
//
// Route 1, scalar (the rest: N % 4 != 0, N > 256, an unaligned state, x,
// b or c off 4 bytes): one block per (b, h) pair stages b and c in shared
// memory as fp32, and its 8 warps walk the P rows, kRows rows per warp at
// a time, each lane on 4 contiguous columns (16-byte loads and stores,
// when N % 4 == 0 and h, h' are 16-byte aligned) or on one, the loads of
// all kRows rows issued before the compute; y is a fixed-order
// warp-shuffle sum.
//
// C interface (bound with ctypes):
//   int ssd_update_launch(const float* h, float* h_out, const void* x,
//                         const float* dt, const float* a_log,
//                         const void* b, const void* c,
//                         const float* d_skip, void* y, int batch,
//                         int heads, int p, int n, long long x_stride,
//                         long long b_stride, long long c_stride,
//                         int dtype, int route, int unit_rows,
//                         void* stream);
// x is (B, H, P) with batch stride x_stride (elements) and (H, P)
// contiguous; b and c are (B, N) with batch strides b_stride and
// c_stride and N contiguous; h, h_out, dt and y are contiguous. dtype
// 0 = fp32, 1 = bf16 (of x, b, c and y). route 0 = TMA, 1 = scalar;
// unit_rows is the TMA route's rows a unit (the scalar route ignores
// it). Returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for arguments the route does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// The limits the wrapper's `route` reads (kernels/ssd_update.py holds the
// same numbers; tests/test_torch_kernels.py compares them with these).
constexpr int kThreads = 256;
constexpr int kMinBlocks = 5;      // blocks an SM holds (<= 48 registers)
constexpr int kMaxPasses = 4;      // passes of the block over a unit's rows
constexpr int kMaxUnitRows = 128;
constexpr int kTmaMaxN = 256;      // K <= 2 chunks a lane
constexpr int kMaxN = 6144;        // scalar: b, c in 48 KB of shared memory

constexpr int kWarps = kThreads / 32;
constexpr int kSideSlots = 3;      // a thread's 4-byte side-data copies
constexpr int kMaxSmem = 49152;    // dynamic shared memory, no opt-in
constexpr int kRows = 8;           // scalar: rows a warp has in flight
// a unit's side data (3 words, then x's rows, b and c, fp32 at most)
static_assert(3 + kMaxUnitRows + 2 * kTmaMaxN <= kSideSlots * kThreads,
              "a unit's side data takes more copies than the threads have");

enum Route { kTma = 0, kScalar = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

int lanes_log2_of(int n) {
  const int chunks = n / 4;
  int lg = 0;
  while ((1 << lg) < chunks && lg < 5) ++lg;
  return lg;
}

// 4-byte words of a unit's side data: dt, a_log, d_skip and a pad (fp32),
// then x of the unit's rows, b and c in x's dtype (`esize` bytes an
// element), each part padded to 16 bytes.
__host__ __device__ __forceinline__ int side_words(int n, int unit_rows,
                                                   int esize) {
  return 4 + (unit_rows * esize + 15) / 16 * 4 +
         2 * ((n * esize + 15) / 16 * 4);
}

// Dynamic shared memory of a TMA-route block: the unit's state (fp32),
// then its side data.
int tma_smem(int n, int unit_rows, int esize) {
  return (unit_rows * n + side_words(n, unit_rows, esize)) * 4;
}

// --- TMA route ----------------------------------------------------------

// K chunks of 16 bytes a lane per row. Block u takes unit u, numbered
// ((b * heads + hh) * slabs + slab). h and h_out may alias, so neither is
// __restrict__.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ssd_update_tma(const float* h, float* h_out, const T* __restrict__ x,
                   const float* __restrict__ dt,
                   const float* __restrict__ a_log,
                   const T* __restrict__ bm, const T* __restrict__ cm,
                   const float* __restrict__ d_skip, T* __restrict__ y,
                   int heads, int p_dim, int n_dim, int64_t x_stride,
                   int64_t b_stride, int64_t c_stride, int lanes_log2,
                   int unit_rows, int slabs) {
  constexpr int kE = static_cast<int>(sizeof(T));
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t full;
  float* tile = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  const int lanes = 1 << lanes_log2;
  const int seg = tid & (lanes - 1);          // lane within the row's lanes
  const int row_in_pass = tid >> lanes_log2;
  const int pass_rows = kThreads >> lanes_log2;
  const int chunks = n_dim >> 2;
  const int x_words = (unit_rows * kE + 15) / 16 * 4;
  const int bc_words = (n_dim * kE + 15) / 16 * 4;
  const int passes = (unit_rows + pass_rows - 1) / pass_rows;
  const int64_t bh = blockIdx.x / slabs;      // b * heads + hh
  const int slab = static_cast<int>(blockIdx.x - bh * slabs);
  const int64_t b = bh / heads;
  const int hh = static_cast<int>(bh - b * heads);
  const int row0 = slab * unit_rows;
  const int rows = min(unit_rows, p_dim - row0);
  const int64_t first = (bh * p_dim + row0) * n_dim;   // the unit's state

  if (tid == 0) {
    hopper::mbar_init(&full, 1 + kThreads);
    hopper::mbar_fence_init();
  }
  __syncthreads();                // the barrier, before any arrival
  // thread 0 bulk-copies the state; every thread copies its share of the
  // side data (4 bytes at a time) and arrives when its copies land
  if (tid == 0) {
    const uint32_t bytes = static_cast<uint32_t>(rows * n_dim * 4);
    hopper::mbar_arrive_expect_tx(&full, bytes);
    hopper::bulk_load(tile, h + first, bytes, &full);
  }
  float* side = tile + unit_rows * n_dim;
  {
    uint8_t* dst = reinterpret_cast<uint8_t*>(side);
    const uint8_t* xs = reinterpret_cast<const uint8_t*>(
        x + b * x_stride + static_cast<int64_t>(hh) * p_dim + row0);
    const uint8_t* bs = reinterpret_cast<const uint8_t*>(bm + b * b_stride);
    const uint8_t* cs = reinterpret_cast<const uint8_t*>(cm + b * c_stride);
    const int xg = rows * kE / 4, bg = n_dim * kE / 4;
#pragma unroll
    for (int m = 0; m < kSideSlots; ++m) {
      int g = tid + m * kThreads;
      if (g < 3) {
        hopper::cp_async_4(dst + 4 * g, g == 0   ? dt + bh
                                        : g == 1 ? a_log + hh
                                                 : d_skip + hh);
        continue;
      }
      g -= 3;
      if (g < xg) {
        hopper::cp_async_4(dst + 16 + 4 * g, xs + 4 * g);
        continue;
      }
      g -= xg;
      if (g < bg) {
        hopper::cp_async_4(dst + 16 + 4 * x_words + 4 * g, bs + 4 * g);
        continue;
      }
      g -= bg;
      if (g < bg) {
        hopper::cp_async_4(dst + 16 + 4 * (x_words + bc_words) + 4 * g,
                           cs + 4 * g);
      }
    }
  }
  hopper::cp_async_arrive(&full);
  hopper::mbar_wait(&full, 0);

  const float dtv = side[0];
  const float decay = expf(dtv * -expf(side[1]));
  const float dsk = side[2];
  const T* xs = reinterpret_cast<const T*>(side + 4);
  const T* bs = reinterpret_cast<const T*>(side + 4 + x_words);
  const T* cs = reinterpret_cast<const T*>(side + 4 + x_words + bc_words);
  float* dst = h_out + first;
  // the passes side by side: every load, then every product and store,
  // then the sums' butterflies interleaved
  float4 v[kMaxPasses][K];
#pragma unroll
  for (int q = 0; q < kMaxPasses; ++q) {
    const int r = q * pass_rows + row_in_pass;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const int ch = seg + kk * lanes;
      if (r < rows && ch < chunks) {
        v[q][kk] = reinterpret_cast<const float4*>(tile + r * n_dim)[ch];
      }
    }
  }
  float acc[kMaxPasses], xv[kMaxPasses];
#pragma unroll
  for (int q = 0; q < kMaxPasses; ++q) {
    const int r = q * pass_rows + row_in_pass;
    xv[q] = r < rows ? to_f32(xs[r]) : 0.f;
    const float u = dtv * xv[q];
    acc[q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const int ch = seg + kk * lanes;
      if (r < rows && ch < chunks) {
        const int c0 = 4 * ch;
        float4 o;
        o.x = fmaf(decay, v[q][kk].x, u * to_f32(bs[c0 + 0]));
        o.y = fmaf(decay, v[q][kk].y, u * to_f32(bs[c0 + 1]));
        o.z = fmaf(decay, v[q][kk].z, u * to_f32(bs[c0 + 2]));
        o.w = fmaf(decay, v[q][kk].w, u * to_f32(bs[c0 + 3]));
        acc[q] = fmaf(o.x, to_f32(cs[c0 + 0]), acc[q]);
        acc[q] = fmaf(o.y, to_f32(cs[c0 + 1]), acc[q]);
        acc[q] = fmaf(o.z, to_f32(cs[c0 + 2]), acc[q]);
        acc[q] = fmaf(o.w, to_f32(cs[c0 + 3]), acc[q]);
        reinterpret_cast<float4*>(dst + r * n_dim)[ch] = o;
      }
    }
  }
  // fixed-order butterflies over each row's lanes (aligned groups of
  // `lanes` in the warp): each of them ends with the same sum
  for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < kMaxPasses; ++q) {
      if (q < passes) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
    }
  }
  T* yp = y + bh * p_dim + row0;
#pragma unroll
  for (int q = 0; q < kMaxPasses; ++q) {
    const int r = q * pass_rows + row_in_pass;
    if (r < rows && seg == 0) yp[r] = from_f32<T>(fmaf(dsk, xv[q], acc[q]));
  }
}

template <typename T, int K>
int launch_tma(const float* h, float* h_out, const T* x, const float* dt,
               const float* a_log, const T* b, const T* c,
               const float* d_skip, T* y, int64_t units, int heads, int p,
               int n, int64_t x_stride, int64_t b_stride, int64_t c_stride,
               int unit_rows, cudaStream_t stream) {
  // the SM's carveout all shared memory, so kMinBlocks blocks fit; the
  // result of the first call is kept
  static const cudaError_t carved = cudaFuncSetAttribute(
      ssd_update_tma<T, K>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carved != cudaSuccess) return static_cast<int>(carved);
  ssd_update_tma<T, K>
      <<<static_cast<unsigned>(units), kThreads,
         tma_smem(n, unit_rows, sizeof(T)), stream>>>(
      h, h_out, x, dt, a_log, b, c, d_skip, y, heads, p, n, x_stride,
      b_stride, c_stride, lanes_log2_of(n), unit_rows,
      (p + unit_rows - 1) / unit_rows);
  return static_cast<int>(cudaGetLastError());
}

// The TMA route's preconditions: N, the state's and h''s 16-byte
// alignment (bulk copies), x's, b's and c's 4-byte copies (their bases,
// batch strides, x's head stride P and a unit's first row), the unit's
// rows (at most kMaxPasses passes of the block), the grid and the shared
// memory.
bool tma_takes(int64_t batch, int heads, int p, int n, int unit_rows,
               const void* h, const void* h_out, const void* x,
               const void* b, const void* c, int64_t x_stride,
               int64_t b_stride, int64_t c_stride, int esize) {
  const auto off4 = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 4 != 0;
  };
  if (n % 4 != 0 || n < 4 || n > kTmaMaxN ||
      reinterpret_cast<uintptr_t>(h) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(h_out) % 16 != 0 || off4(x) || off4(b) ||
      off4(c) || x_stride * esize % 4 != 0 || b_stride * esize % 4 != 0 ||
      c_stride * esize % 4 != 0 || p * esize % 4 != 0 ||
      unit_rows * esize % 4 != 0) {
    return false;
  }
  const int pass_rows = kThreads >> lanes_log2_of(n);
  if (unit_rows < 1 || unit_rows > p || unit_rows > kMaxPasses * pass_rows ||
      unit_rows > kMaxUnitRows) {
    return false;
  }
  const int64_t units = batch * heads * ((p + unit_rows - 1) / unit_rows);
  return units <= 0x7fffffffLL && tma_smem(n, unit_rows, esize) <= kMaxSmem;
}

// --- scalar route -------------------------------------------------------

// W columns per lane per chunk: 4 (16-byte loads) or 1 (scalar).
// h and h_out may alias, so neither is __restrict__.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    ssd_update_scalar(const float* h, float* h_out, const T* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ a_log,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      const float* __restrict__ d_skip, T* __restrict__ y,
                      int heads, int p_dim, int n_dim, int64_t x_stride,
                      int64_t b_stride, int64_t c_stride) {
  extern __shared__ float s_bc[];
  float* s_b = s_bc;
  float* s_c = s_bc + n_dim;
  const int64_t bh = blockIdx.x;               // b * heads + h
  const int64_t b = bh / heads;
  const int hh = static_cast<int>(bh % heads);
  for (int i = threadIdx.x; i < n_dim; i += kThreads) {
    s_b[i] = to_f32(bm[b * b_stride + i]);
    s_c[i] = to_f32(cm[b * c_stride + i]);
  }
  const float dtv = dt[bh];
  const float decay = expf(dtv * -expf(a_log[hh]));
  const float dsk = d_skip[hh];
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t tile = bh * p_dim * n_dim;
  const float* hp = h + tile;
  float* hop = h_out + tile;
  const T* xp = x + b * x_stride + static_cast<int64_t>(hh) * p_dim;
  T* yp = y + bh * p_dim;

  for (int p0 = warp * kRows; p0 < p_dim; p0 += kWarps * kRows) {
    float xv[kRows], u[kRows], acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      xv[r] = p0 + r < p_dim ? to_f32(xp[p0 + r]) : 0.f;
      u[r] = dtv * xv[r];
      acc[r] = 0.f;
    }
    for (int c0 = lane * W; c0 < n_dim; c0 += 32 * W) {
      float hv[kRows][W];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (p0 + r >= p_dim) continue;
        const float* src = hp + static_cast<int64_t>(p0 + r) * n_dim + c0;
        if constexpr (W == 4) {
          const float4 v = *reinterpret_cast<const float4*>(src);
          hv[r][0] = v.x;
          hv[r][1] = v.y;
          hv[r][2] = v.z;
          hv[r][3] = v.w;
        } else {
          hv[r][0] = *src;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (p0 + r >= p_dim) continue;
        float o[W];
#pragma unroll
        for (int j = 0; j < W; ++j) {
          o[j] = fmaf(decay, hv[r][j], u[r] * s_b[c0 + j]);
          acc[r] = fmaf(o[j], s_c[c0 + j], acc[r]);
        }
        float* dst = hop + static_cast<int64_t>(p0 + r) * n_dim + c0;
        if constexpr (W == 4) {
          *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2],
                                                        o[3]);
        } else {
          *dst = o[0];
        }
      }
    }
    // fixed-order butterfly: every lane ends with the same sum
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (p0 + r < p_dim) yp[p0 + r] = from_f32<T>(fmaf(dsk, xv[r], acc[r]));
      }
    }
  }
}

template <typename T>
int launch(const float* h, float* h_out, const void* x, const float* dt,
           const float* a_log, const void* b, const void* c,
           const float* d_skip, void* y, int batch, int heads, int p, int n,
           int64_t x_stride, int64_t b_stride, int64_t c_stride, int route,
           int unit_rows, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(b);
  const T* cp = static_cast<const T*>(c);
  T* yp = static_cast<T*>(y);
  if (route == kTma) {
    if (!tma_takes(batch, heads, p, n, unit_rows, h, h_out, x, b, c,
                   x_stride, b_stride, c_stride, sizeof(T))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t units = static_cast<int64_t>(batch) * heads *
                          ((p + unit_rows - 1) / unit_rows);
    return (n <= 128 ? launch_tma<T, 1> : launch_tma<T, 2>)(
        h, h_out, xp, dt, a_log, bp, cp, d_skip, yp, units, heads, p, n,
        x_stride, b_stride, c_stride, unit_rows, stream);
  }
  if (route != kScalar || n > kMaxN ||
      static_cast<int64_t>(batch) * heads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>(
      static_cast<int64_t>(batch) * heads);
  const size_t shared = 2 * static_cast<size_t>(n) * sizeof(float);
  const bool vec = n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(h_out) % 16 == 0;
  if (vec) {
    ssd_update_scalar<T, 4><<<blocks, kThreads, shared, stream>>>(
        h, h_out, xp, dt, a_log, bp, cp, d_skip, yp, heads, p, n, x_stride,
        b_stride, c_stride);
  } else {
    ssd_update_scalar<T, 1><<<blocks, kThreads, shared, stream>>>(
        h, h_out, xp, dt, a_log, bp, cp, d_skip, yp, heads, p, n, x_stride,
        b_stride, c_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_update_launch(const float* h, float* h_out, const void* x,
                                 const float* dt, const float* a_log,
                                 const void* b, const void* c,
                                 const float* d_skip, void* y, int batch,
                                 int heads, int p, int n, long long x_stride,
                                 long long b_stride, long long c_stride,
                                 int dtype, int route, int unit_rows,
                                 void* stream) {
  if (batch <= 0 || heads <= 0 || p <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(h, h_out, x, dt, a_log, b, c, d_skip, y, batch,
                         heads, p, n, x_stride, b_stride, c_stride, route,
                         unit_rows, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(h, h_out, x, dt, a_log, b, c, d_skip, y,
                                 batch, heads, p, n, x_stride, b_stride,
                                 c_stride, route, unit_rows, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
