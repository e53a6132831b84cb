// Block-diagonal (grouped) matrix product for Hopper (sm_90a).
//
// Replaces the TPU kernel `grouped_matmul_kernel` of
// src/repro/kernels/grouped_matmul.py:48 (its pl.pallas_call), the product
// behind Fed2's block-diagonal layers; on the port's serving path it is
// the Fed2 unembedding of a Mamba-2 LM. For x (M, G*K) and w (G, K, N),
// both row-major fp32 or bf16,
//     y[m, g*N + n] = sum_k x[m, g*K + k] * w[g, k, n]
// accumulated in fp32 and stored in x's dtype, (M, G*N) row-major. The
// bias stays outside, in the wrapper (as in the reference's ops.py).
//
// Bound on the H100 at the serving shapes (G = 8, K = 256, N = 6288,
// bf16): bytes. At the decode batch M = 4 the 25.8 MB of w, read once,
// take 7.8 us at 3.35 TB/s against 0.1 GFLOP; at decode_32k's batch
// M = 128 w, x and the 12.9 MB of y take 11.7 us against 3.3 GFLOP,
// 3.3 us on the bf16 tensor cores (49 us in fp32 FMAs). The fp32 LM
// round's eval (M = 4096 rows: 64 sequences of 64 tokens) is bound by
// operations: at Llama's (G, K, N) = (4, 512, 32064) its 538 GFLOP take
// 8.03 ms at 67 TFLOP/s against 0.72 ms for its 2.4 GB (y is 2.1 GB of
// it), at Mamba-2's (4, 512, 12576) 3.15 ms.
//
// The TPU kernel walks a (G, M/bm, N/bn, K/bk) grid on 128-padded tiles
// with a VMEM accumulator, K the last, sequential axis. Here the wrapper
// picks one of four routes (its `route` function, from M, the dtype, the
// strides and the alignment) and, on the bf16 stream and wgmma routes, a
// plan (its `plan` function): the columns of a unit (64, 128 or 192: one
// to three 64-column TMA boxes) or a tile (those or 256: four boxes) and,
// on the wgmma route, a split S of K over a thread-block cluster (1, 2, 4
// or 8; 64 or 128 columns when split).
// This file checks the route's and the plan's preconditions and returns
// cudaErrorInvalidValue when they fail. It never changes route or plan.
//
// Why the plan: on one TPU core a sequential K axis costs nothing; on 132
// SMs a block that walks all of K alone leaves the card idle when the
// output is small. Fed2's decoupled FFN products (8 groups of K x N from
// 64 x 256 to 2368 x 448) fill 8-104 SMs in 192-column units or 128 x 192
// tiles: Llama's down product (8, 1024, 256) ran 16 blocks, each
// streaming 262 KB, a third of their columns zero-filled. Measured on the
// H100 (tools/gmm_plans.py), narrower units fix most of it: at M = 4,
// 64-column units put every down product at or below torch.bmm. A split
// adds ~1-2 us (the partials through shared memory, one bulk copy per
// owner into its cluster peer, the cluster barriers, a second pass and
// store), so it pays only past ~16 stages a split: a split in two needs
// 2,048 rows of K on wgmma (qwen2's down product at M = 128, K = 2368)
// and 4,096 on the stream route, which no product on a path has (at most
// 2,368), so the stream route does not split. Where 192-column units fill
// the card the stream plan is (1, 192). The wgmma plan takes the width of
// the least waves of tiles times a tile's modelled time (its products or
// its operand bytes into shared memory, the longer) plus the last wave's
// stores: 256 columns at every eval chunk (M = 4096), 64-256 at the
// unembeddings (M = 64-128). Every unsplit plan gives the same bits: each
// output is one fp32 sum over K in 64-deep stages, in order.
//
// The TMA routes read w through a 3-D tensor map over (G, K, N) and (but
// sgemm) x through one over (M, G, K), which zero-fill every box past the
// tensor's M, K or N, so nothing is padded in memory. A box starts on a
// 16-byte boundary (a map over (M, G*K) whose boxes started at g*K faulted
// when K*2 was not a multiple of 16), so all three need K and N to be
// multiples of 16 bytes and 16-byte aligned bases.
//
// - "stream" (M <= 8): the decode GEMV, bound by the bytes of w. Registers
//   cannot hold the ~20 KB per SM that Little's law asks of 3.35 TB/s (the
//   previous design, w straight into registers, sat at that floor: 37 % of
//   the bound); a ring of shared-memory stages filled by TMA can. One
//   producer thread keeps the ring full; each stage's x box rides on the
//   same mbarrier as its w boxes. Measured on the H100, the wait for w ends
//   late in the kernel whatever the ring's depth, so what the consumers do
//   after the last stage lands is the cost: fp32 FMAs there (1.75 us of
//   FMA throughput at M = 4, counted from the shapes) kept the kernel
//   1.8 us behind torch.bmm, and larger
//   boxes, which move the bytes sooner, made it worse. So in bf16 the
//   consumers run the tensor cores with the operands swapped, y^T =
//   w^T x^T: w^T as an MN-major A operand (64 columns a wgmma, the
//   transpose bit; no copy of w) and x^T as a K-major n8 B operand (M
//   padded to 8 by the map), wgmma m64n8k16 into fp32, in two independent
//   sums over the k16 steps. A unit is one group's 192 columns over all of
//   K (33 x 8 = 264 units at full width: 2 resident blocks on each of the
//   132 SMs, one whole wave), through 2 stages of 128 rows (51 KB each), so
//   at K = 256 a block has its whole unit in flight: 200 KB per SM; units
//   of 128 or 64 columns take 3 or 6 stages, ~100-110 KB in flight. At
//   the FFN shapes it is bound by latency more than bytes: a one-stage
//   product takes ~2.5 us, and a block streams ~80-100 GB/s. fp32
//   (the full-width fp32 decode) keeps FMAs: 96-column units, 4 stages of
//   32 rows, a 16-byte chunk and a slice of the rows per thread, x
//   broadcast from shared memory, the row slices' partial sums added in
//   shared memory. Every sum runs in a fixed order, with no atomics: a run
//   repeats to the bit.
// - "wgmma" (M > 8, bf16): a GEMM per group on the tensor cores. Tiles of
//   128 rows and 64, 128, 192 or 256 columns, K in 64-deep stages through
//   a ring of 8, 6, 4 or 4 stages (24-48 KB each), walked by persistent
//   blocks, so the loads of a block's next tile run under the current
//   tile's products and stores. One producer warp loads each stage's x box
//   and the tile's 64-column boxes of w with 128-byte swizzle; two
//   consumer warpgroups each run wgmma m64nBNk16 on 64 rows (w an MN-major
//   B operand; at 256 columns 128 fp32 sums a thread, 168 registers of
//   the 224 that one 288-thread block an SM allows), one group of
//   products in flight across stages (the slot before is freed then).
//   Each consumer warp rounds its 16 rows to bf16 into 16 x 64 swizzled
//   shared-memory chunks, two buffers a warp, and stores each by TMA while
//   it writes the next, with no barrier but its own: TMA writes whole
//   lines and clips at the M and N edges (bf16 pairs stored straight from
//   the registers write 16 bytes of each 32-byte sector at a time: 24 us
//   instead of 15 on the H100).
//   What bounds it, measured on the H100 at the M = 4096 eval chunks
//   (tools/gmm_plans.py breakdown: parts of the kernel taken out): the
//   operand bytes that fill shared memory from L2 together with the
//   stores of y, and the products with their per-tile epilogue, each
//   near the kernel's time alone. The design before (128 x 192 tiles,
//   one block a tile, N fastest) read x's box again for every column tile
//   and w's for every row tile: 1.38 GB at Mamba-2's chunk (8, 256, 6288),
//   162.5 us of loads alone and 251 us with the stores, its products
//   hidden under them. So past one row tile blocks run in clusters of 2
//   on neighbouring row tiles, each loading half of a stage's w boxes
//   multicast to both (w read from L2 once for two row tiles); tiles are
//   256 columns wide (x read once for 256 columns): 0.82 GB; and tiles
//   run row tiles fastest, then columns, then groups, so the clusters in
//   flight share a few w tiles and one group's x, which stay in L2
//   (Llama's w is 66 MB, more than L2, and N fastest re-read it from
//   device memory). At M = 64-128 one row tile is all of M: no pairs; the
//   kernel is bound by w's bytes from device memory, and the last wave's
//   stores overlap no load (so danube's unembedding runs two waves of 128
//   columns rather than one of 256). At the FFN shapes a one-stage tile
//   takes ~3.5 us (torch.bmm ~2.7-3.0) and x is read again for every
//   column tile; the split kernel takes one 128 x 64 or 128 x 128 tile a
//   cluster of 2, as the plan never asks for more tiles than SMs.
// - "sgemm" (M > 8, fp32): a SIMT GEMM per group. The H100 issues one
//   warp instruction a clock on each of an SM's four schedulers and runs
//   an fp32 FMA warp-wide in one, so every instruction that is not an FMA
//   takes an FMA's place, and a shared-memory read feeds as many FMAs as
//   a thread holds outputs. One block of 256 threads an SM computes a
//   128 x 256 tile, 8 x 16 outputs a thread in 4 x 4 quads: a k step
//   reads x^T and w from shared memory with six 16-byte loads (a warp
//   reads one contiguous run with each) for 128 FMAs (simt: 12 scalar
//   loads for 32). K goes in 16-deep stages through a ring of 4 (97 KB):
//   w's stage by TMA (box 16 x 256), x's by 4-byte cp.async copies
//   straight into x^T[k][m] (rows padded to 132 floats), both on the
//   stage's mbarrier; the next stages' copies run under the current
//   stage's FMAs. Timed beside it on the H100 while it was designed, these
//   were slower: x through registers, 8 x 8 outputs at 2 blocks an SM,
//   128-thread blocks, 8- or 32-deep stages, 3, 5 or 6 stages, persistent
//   blocks, a partly unrolled k loop, and mbarriers in place of the block
//   barrier. Tiles run M fastest in bands of row tiles whose x fits
//   a third of L2 (at the eval shapes all of M), so the blocks in flight
//   share a few w tiles and each w tile comes from HBM about once. Each
//   output is one fmaf chain over k = 0 ... K-1 in order, padded past K
//   with 0 * 0 to a multiple of 16 as simt pads it: the same bits as the
//   simt route, every run.
// - "simt" (strides and pointers TMA does not take: K or N not a multiple
//   of 16 bytes, an x or w base off 16 bytes): tiles. A block computes one
//   64 x 128 tile of one group's output, reading the group's x panel and
//   w[g] in 16-deep slices through shared memory, every load
//   bounds-checked, 16-byte loads of w where N and w allow, fp32 FMAs:
//   exact in fp32.
//
// C interface (bound with ctypes):
//   int grouped_matmul_launch(const void* x, const void* w, void* y,
//                             long long m, long long g, long long k,
//                             long long n, int dtype, int route,
//                             int splits, int cols, void* stream);
//   int grouped_matmul_dynamic_smem(int route, int dtype, int splits,
//                                   int cols);
//   int grouped_matmul_wgmma_pairs(int cols);
// dtype 0 = fp32, 1 = bf16; route 0 = stream, 1 = wgmma, 2 = simt,
// 3 = sgemm; (splits, cols) the plan: (1, 64), (1, 128) or (1, 192) on
// the bf16 stream route, any plan plan_fits takes on wgmma, (1, 192) on
// the others. The launch returns cudaGetLastError() after the
// launch, or the error of a refused tensor map or shared-memory
// attribute, cudaErrorInvalidClusterSize where the card cannot hold one
// cluster (of the split, or of a pair of row tiles), or
// cudaErrorInvalidValue for arguments the route or the plan does not
// take. grouped_matmul_wgmma_pairs reports the clusters of row-tile pairs
// the card holds at once (66 on the H100: every SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

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

// Two floats rounded to a bf16 pair, as the 32 bits that hold it.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Lets `kernel` take `bytes` of dynamic shared memory, with the SM's
// carveout all shared memory; the result of the first call is kept.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

constexpr int64_t kMaxCoord = 0x7fffffff;   // TMA coordinates are int32
constexpr int64_t kMaxGridX = 0x7fffffff;   // blocks along a grid's x
constexpr int kStreamMaxM = 8;              // rows of the stream route
// The plan of the bf16 stream and wgmma routes: units or tiles of one of
// these column widths (one to three 64-column TMA boxes), and on the wgmma
// route K split over a cluster of 1 ... kMaxSplits blocks (8, the portable
// cluster size). Every other route takes the default plan
// (1, kDefaultCols) only.
constexpr int kMaxSplits = 8;
constexpr int kMaxSmem = 232448;            // dynamic shared memory a block
constexpr int kDefaultCols = 192;
constexpr bool plan_cols(int c) { return c == 64 || c == 128 || c == 192; }
// the unsplit wgmma kernel's widths: those and four boxes (m64n256k16)
constexpr bool wgmma_cols(int c) { return plan_cols(c) || c == 256; }
// the widths a split plan takes: a 128 x 192 fp32 partial would not fit
// the split wgmma kernel's drained ring
constexpr bool split_cols(int c) { return c == 64 || c == 128; }

// Strides and pointers TMA takes for maps over (M, G, K) and (G, K, N):
// 16-byte aligned bases, K and N multiples of 16 bytes (a box starts on a
// 16-byte boundary), and coordinates within int32.
template <typename T>
bool tma_fits(const void* x, const void* w, int64_t g, int64_t k,
              int64_t n) {
  const int64_t esize = sizeof(T);
  return (n * esize) % 16 == 0 && (k * esize) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0 && g * k <= kMaxCoord &&
         n <= kMaxCoord;
}

// ---------------------------------------------------------------------------
// route "simt": tiles through shared memory, fp32 FMAs
// ---------------------------------------------------------------------------

// A block computes a BM x BN output tile with NT = RT * CT threads; the
// thread (ty, tx) owns rows ty + i*RT (i < TM) and columns tx + j*CT
// (j < TN).
template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int RT = BM / TM;
  static constexpr int CT = BN / TN;
  static constexpr int NT = RT * CT;
};
using LargeM = Tile<64, 128, 16, 4, 8>;  // 256 threads

// V contiguous columns of w per load: 16 / sizeof(T) for 16-byte loads
// (N % V == 0 and w aligned), else 1.
template <typename T, typename C, int V>
__global__ void __launch_bounds__(C::NT)
    grouped_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          T* __restrict__ y, int64_t m, int64_t groups,
                          int64_t k, int64_t n) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, TM = C::TM, TN = C::TN;
  constexpr int RT = C::RT, CT = C::CT, NT = C::NT;
  constexpr int XL = BM * BK / NT;        // x elements a thread loads
  constexpr int WL = BK * BN / V / NT;    // w loads (of V elements)
  static_assert(BM * BK % NT == 0 && BK * BN / V % NT == 0, "tile");
  static_assert(V * sizeof(T) == 16 || V == 1, "vector width");
  static_assert(V == 1 || V % 4 == 0, "float4 stores of converted w");
  // xs is padded by one column: the transposing stores hit distinct banks
  __shared__ float xs[BK][BM + 1];
  __shared__ __align__(16) float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % CT;
  const int ty = tid / CT;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t g = blockIdx.z;
  const int64_t x_row = groups * k;
  const T* xg = x + g * k;        // the group's column panel of x
  const T* wg = w + g * k * n;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  for (int64_t k0 = 0; k0 < k; k0 += BK) {
    // issue every global load of the slice, then store to shared memory
    float xv[XL];
#pragma unroll
    for (int l = 0; l < XL; ++l) {
      const int e = tid + l * NT;
      const int64_t gm = m0 + e / BK;
      const int64_t gk = k0 + e % BK;
      xv[l] = (gm < m && gk < k) ? to_f32(xg[gm * x_row + gk]) : 0.f;
    }
    if constexpr (V > 1) {
      uint4 wv[WL];
#pragma unroll
      for (int l = 0; l < WL; ++l) {
        const int e = tid + l * NT;
        const int64_t gk = k0 + e / (BN / V);
        const int64_t gn = n0 + (e % (BN / V)) * V;
        // n % V == 0: a chunk's V columns are all inside or all outside
        wv[l] = (gk < k && gn < n)
                    ? *reinterpret_cast<const uint4*>(wg + gk * n + gn)
                    : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int l = 0; l < WL; ++l) {
        const int e = tid + l * NT;
        const int r = e / (BN / V);
        const int c = (e % (BN / V)) * V;
        const T* v = reinterpret_cast<const T*>(&wv[l]);
#pragma unroll
        for (int q = 0; q < V; q += 4) {
          *reinterpret_cast<float4*>(&ws[r][c + q]) =
              make_float4(to_f32(v[q]), to_f32(v[q + 1]), to_f32(v[q + 2]),
                          to_f32(v[q + 3]));
        }
      }
    } else {
      float wv[WL];
#pragma unroll
      for (int l = 0; l < WL; ++l) {
        const int e = tid + l * NT;
        const int64_t gk = k0 + e / BN;
        const int64_t gn = n0 + e % BN;
        wv[l] = (gk < k && gn < n) ? to_f32(wg[gk * n + gn]) : 0.f;
      }
#pragma unroll
      for (int l = 0; l < WL; ++l) {
        const int e = tid + l * NT;
        ws[e / BN][e % BN] = wv[l];
      }
    }
#pragma unroll
    for (int l = 0; l < XL; ++l) {
      const int e = tid + l * NT;
      xs[e % BK][e / BK] = xv[l];
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * RT];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * CT];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const int64_t y_row = groups * n;
  T* yg = y + g * n;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + ty + i * RT;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gn = n0 + tx + j * CT;
      if (gn < n) yg[gm * y_row + gn] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch_simt(const T* x, const T* w, T* y, int64_t m, int64_t g,
                int64_t k, int64_t n, cudaStream_t stream) {
  using C = LargeM;
  constexpr int V = static_cast<int>(16 / sizeof(T));
  const int64_t n_tiles = (n + C::BN - 1) / C::BN;
  const int64_t m_tiles = (m + C::BM - 1) / C::BM;
  if (n_tiles > 0x7fffffff || m_tiles > 65535 || g > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>(m_tiles), static_cast<unsigned>(g));
  const bool vec =
      n % V == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec) {
    grouped_matmul_kernel<T, C, V><<<grid, C::NT, 0, stream>>>(x, w, y, m, g,
                                                               k, n);
  } else {
    grouped_matmul_kernel<T, C, 1><<<grid, C::NT, 0, stream>>>(x, w, y, m, g,
                                                               k, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// route "sgemm": M > 8, fp32, a SIMT GEMM for Hopper
// ---------------------------------------------------------------------------

namespace sg {
constexpr int BM = 128;                    // rows of a tile
constexpr int BN = 256;                    // columns of a tile
constexpr int BK = 16;                     // K of a stage
constexpr int kStages = 4;
constexpr int kThreads = 256;              // 16 x 16 threads
constexpr int TM = 8, TN = 16;             // outputs of a thread
constexpr int kXPitch = BM + 4;            // floats a row of x^T in shared memory
constexpr int kWBytes = BK * BN * 4;       // 16 KB: w's box of a stage
constexpr int kXBytes = BK * kXPitch * 4;  // 8,448 B: x^T of a stage
constexpr int kSmem = 1024 + kStages * (kWBytes + kXBytes) + kStages * 8;
// x rows a band of row tiles may hold in L2 (a third of its 50 MB)
constexpr int64_t kBandBytes = 16 << 20;
}  // namespace sg

// wmap: (G, K, N) with box (1, 16, 256), no swizzle; full[s] counts the
// 256 threads' copies and thread 0's TMA bytes. Tiles run in bands of
// `band` row tiles (M fastest inside a band, then N, then the group), so
// the blocks in flight share a few w tiles and one panel of x in L2.
// Thread (ty, tx) owns rows 4ty + i and 64 + 4ty + i (i < 4) and columns
// 4tx + 64h + j (h, j < 4) of the tile: six 16-byte shared-memory reads a
// k step (two of x^T, four of w) feed 128 FMAs, and a warp's 4 ty and 8 tx
// make each read one contiguous 64- or 128-byte run.
__global__ void __launch_bounds__(sg::kThreads, 1)
    grouped_matmul_sgemm_kernel(const __grid_constant__ CUtensorMap wmap,
                                const float* __restrict__ x,
                                float* __restrict__ y, int m, int groups,
                                int k, int n, int m_tiles, int n_tiles,
                                int band) {
  using namespace sg;
  extern __shared__ uint8_t smem_raw[];
  // aligned by an offset from the array, so that the compiler keeps these
  // pointers in the shared window: LDS/STS with 32-bit addresses (through
  // align1024's integer cast they became generic loads and stores on
  // 64-bit addresses, which cost registers and time)
  uint8_t* base =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  float* ws = reinterpret_cast<float*>(base);                  // [S][BK][BN]
  float* xs = reinterpret_cast<float*>(base + kStages * kWBytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + kStages * (kWBytes + kXBytes));

  const int per_group = m_tiles * n_tiles;
  const int g = blockIdx.x / per_group;
  int t = blockIdx.x % per_group;
  const int first = t / (band * n_tiles) * band;
  const int rows = min(m_tiles - first, band);
  t %= band * n_tiles;
  const int m0 = (first + t % rows) * BM;
  const int n0 = t / rows * BN;
  const int nk = (k + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // x's stage by 4-byte cp.async copies straight into x^T[k][row] (no
  // registers between): element e of this thread is column lane % 16 of
  // row 16*warp + 2e + lane/16, so a warp reads two rows of 64 contiguous
  // bytes a copy. Rows past M copy the last row (their outputs are not
  // stored); columns past K are zeros. Each thread's copies arrive on the
  // stage's barrier, beside w's TMA bytes.
  constexpr int XE = BM * BK / kThreads;    // x elements a thread copies
  const int xk = lane % BK;
  const float* xrow[XE];
  int xdst[XE];
#pragma unroll
  for (int e = 0; e < XE; ++e) {
    const int row = 16 * warp + 2 * e + lane / BK;
    xrow[e] = x + static_cast<int64_t>(min(m0 + row, m - 1)) * groups * k +
              static_cast<int64_t>(g) * k + xk;
    xdst[e] = xk * kXPitch + row;
  }
  // stage it into its slot: w by TMA (zero-filled past K and N), x by the
  // copies above
  auto load = [&](int it) {
    const int s = it % kStages;
    if (tid == 0) {
      hopper::mbar_arrive_expect_tx(&full[s], kWBytes);
      hopper::tma_load_3d(ws + s * (BK * BN), &wmap, &full[s], n0, it * BK,
                          g);
    }
    float* d = xs + s * (BK * kXPitch);
    const bool ok = it * BK + xk < k;
#pragma unroll
    for (int e = 0; e < XE; ++e) {
      hopper::cp_async_4_or_zero(d + xdst[e], xrow[e] + (ok ? it * BK : 0),
                                 ok);
    }
    hopper::cp_async_arrive(&full[s]);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&full[s], kThreads + 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  for (int it = 0; it < kStages - 1 && it < nk; ++it) load(it);

  const int ty = 4 * (warp / 2) + lane / 8;
  const int tx = 8 * (warp % 2) + lane % 8;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  for (int it = 0; it < nk; ++it) {
    const int s = it % kStages;
    // every thread is done with stage it - 1: its slot takes stage
    // it + kStages - 1, whose copies run under this stage's FMAs
    __syncthreads();
    if (it + kStages - 1 < nk) load(it + kStages - 1);
    hopper::mbar_wait(&full[s], (it / kStages) & 1);
    const float* xa = xs + s * (BK * kXPitch) + 4 * ty;
    const float* wb = ws + s * (BK * BN) + 4 * tx;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(xa + kk * kXPitch + 64 * q);
        a[4 * q] = v.x;
        a[4 * q + 1] = v.y;
        a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(wb + kk * BN + 64 * q);
        b[4 * q] = v.x;
        b[4 * q + 1] = v.y;
        b[4 * q + 2] = v.z;
        b[4 * q + 3] = v.w;
      }
      // column by column (b[j] over the 8 rows): ptxas schedules this
      // order faster on the H100 than row by row; either gives each output
      // the same fmaf chain
#pragma unroll
      for (int j = 0; j < TN; ++j) {
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  // 16-byte stores straight from the registers (N % 4 == 0: a chunk is
  // all inside N or all outside)
  const int64_t y_row = static_cast<int64_t>(groups) * n;
  float* yg = y + static_cast<int64_t>(g) * n + n0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + 4 * ty + i % 4 + 64 * (i / 4);
    if (r >= m) break;
    float* yr = yg + r * y_row;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int c = 64 * h + 4 * tx;
      if (n0 + c < n) {
        *reinterpret_cast<float4*>(yr + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      }
    }
  }
}

bool sgemm_fits(const void* x, const void* w, const void* y, int64_t m,
                int64_t g, int64_t k, int64_t n) {
  using namespace sg;
  const int64_t tiles = g * ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  return m > kStreamMaxM && tma_fits<float>(x, w, g, k, n) &&
         reinterpret_cast<uintptr_t>(y) % 16 == 0 && m <= kMaxCoord &&
         tiles <= kMaxCoord;
}

int launch_sgemm(const float* x, const float* w, float* y, int64_t m,
                 int64_t g, int64_t k, int64_t n, cudaStream_t st) {
  using namespace sg;
  if (!sgemm_fits(x, w, y, m, g, k, n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t attr =
      allow_smem(grouped_matmul_sgemm_kernel, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap wmap;
  const uint64_t wdims[3] = {static_cast<uint64_t>(n),
                             static_cast<uint64_t>(k),
                             static_cast<uint64_t>(g)};
  const uint64_t wstrides[2] = {n * 4ull, k * n * 4ull};
  const uint32_t wbox[3] = {BN, BK, 1};
  if (!hopper::encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, w,
                          wdims, wstrides, wbox,
                          CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t m_tiles = (m + BM - 1) / BM;
  const int64_t n_tiles = (n + BN - 1) / BN;
  int64_t band = kBandBytes / (BM * k * 4);
  band = band < 1 ? 1 : (band > m_tiles ? m_tiles : band);
  grouped_matmul_sgemm_kernel<<<static_cast<unsigned>(g * m_tiles * n_tiles),
                                kThreads, kSmem, st>>>(
      wmap, x, y, static_cast<int>(m), static_cast<int>(g),
      static_cast<int>(k), static_cast<int>(n), static_cast<int>(m_tiles),
      static_cast<int>(n_tiles), static_cast<int>(band));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// route "stream", bf16: M <= 8 on the tensor cores, the operands swapped
// ---------------------------------------------------------------------------

// y^T = w^T x^T: the unit's columns of w^T (64 at a time) as an MN-major A
// operand, x^T (K x M, M padded to 8 by the x map) as a K-major B, wgmma
// m64n8k16 into fp32.
//
// A unit is C = 64, 128 or 192 columns of one group (the plan's width)
// over all of K; a stage stays 128 rows, so narrower units get more
// stages (6, 3, 2: about 100 KB of the ring in flight, 2 blocks an SM).
// The route does not split K: every product on a path has at most 19
// stages of K (qwen2's down product), and measured on the H100 a split in
// two pays only from 32 stages (the plan above).
namespace gemv {
constexpr int KR = 128;               // rows of K a stage holds
constexpr int kChains = 2;            // independent sums over k16 steps
constexpr int kThreads = 128 + 32;    // one warpgroup + the producer warp
constexpr int kWBox = KR * 128;       // 16 KB: 64 columns of w
constexpr int kXBox = 8 * 128;        // 1 KB: 8 rows x 64 of K
}  // namespace gemv

template <int C>
struct Unit {
  static constexpr int kStages = 2 * 192 / C;
  static constexpr int kStageBytes = (C / 64) * gemv::kWBox +
                                     (gemv::KR / 64) * gemv::kXBox;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
  static_assert(C % 64 == 0 && C <= 192, "one to three w boxes");
};

// d (64 x 8) += A (64 x 16, MN-major) * B (16 x 8, K-major)
__device__ __forceinline__ void wgmma_m64n8k16_ta(float (&d)[4],
                                                  uint64_t desc_a,
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// wmap: (G, K, N) with box (1, 128, 64); xmap: (M, G, K) with box
// (8, 1, 64); both with 128-byte swizzle. A block is one unit (blockIdx.x)
// of group blockIdx.y over all of K.
template <int C>
__global__ void __launch_bounds__(gemv::kThreads, 2)
    grouped_matmul_gemv_kernel(const __grid_constant__ CUtensorMap wmap,
                               const __grid_constant__ CUtensorMap xmap,
                               __nv_bfloat16* __restrict__ y, int m,
                               int groups, int k, int n) {
  using namespace gemv;
  using U = Unit<C>;
  constexpr int kStages = U::kStages;
  constexpr int kStageBytes = U::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);  // [S][w C/64 x 16 KB | x 2 x 1 KB]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int g = blockIdx.y;
  const int n0 = blockIdx.x * C;
  const int nk = (k + KR - 1) / KR;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {                          // the producer
    if (lane == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        if (it >= kStages) {
          hopper::mbar_wait(&empty[s], (it / kStages - 1) & 1);
        }
        uint8_t* st = base + s * kStageBytes;
        hopper::mbar_arrive_expect_tx(&full[s], kStageBytes);
#pragma unroll
        for (int j = 0; j < C / 64; ++j) {
          hopper::tma_load_3d(st + j * kWBox, &wmap, &full[s], n0 + 64 * j,
                              it * KR, g);
        }
#pragma unroll
        for (int q = 0; q < KR / 64; ++q) {
          hopper::tma_load_3d(st + (C / 64) * kWBox + q * kXBox, &xmap,
                              &full[s], it * KR + 64 * q, g, 0);
        }
      }
    }
    return;
  }

  float acc[kChains][C / 64][4];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
#pragma unroll
    for (int j = 0; j < C / 64; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;
    }
  }
  for (int it = 0; it < nk; ++it) {
    const int s = it % kStages;
    hopper::mbar_wait(&full[s], (it / kStages) & 1);
    const uint8_t* st = base + s * kStageBytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KR / 16; ++kk) {
      // x^T: 8 rows of 128 bytes, k16 = 32 bytes along the row; w^T: one
      // 64-column block, 8-row groups of K 1 KB apart, k16 = 2 KB
      const uint64_t db = hopper::desc_sw128(
          st + (C / 64) * kWBox + (kk / 4) * kXBox + (kk % 4) * 32, 16,
          1024);
#pragma unroll
      for (int j = 0; j < C / 64; ++j) {
        wgmma_m64n8k16_ta(acc[kk % kChains][j],
                          hopper::desc_sw128(st + j * kWBox + kk * 2048,
                                             kWBox, 1024),
                          db);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }
  // the chains' sums in a fixed order; value e of block j sits at column
  // 64j + 16*warp + lane/4 + 8*(e/2) and row (batch) 2*(lane % 4) + e%2
  const int64_t y_row = static_cast<int64_t>(groups) * n;
  __nv_bfloat16* yg = y + static_cast<int64_t>(g) * n + n0;
#pragma unroll
  for (int j = 0; j < C / 64; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sum = acc[0][j][e];
#pragma unroll
      for (int c = 1; c < kChains; ++c) sum += acc[c][j][e];
      const int col = 64 * j + 16 * warp + lane / 4 + 8 * (e / 2);
      const int row = 2 * (lane % 4) + e % 2;
      if (row < m && n0 + col < n) {
        yg[row * y_row + col] = __float2bfloat16(sum);
      }
    }
  }
}

template <int C>
int launch_gemv(const __nv_bfloat16* x, const __nv_bfloat16* w,
                __nv_bfloat16* y, int64_t m, int64_t g, int64_t k, int64_t n,
                cudaStream_t st) {
  using namespace gemv;
  using U = Unit<C>;
  const int64_t units = (n + C - 1) / C;
  if (units > kMaxGridX) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = grouped_matmul_gemv_kernel<C>;
  static const cudaError_t attr = allow_smem(kernel, U::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap wmap, xmap;
  const uint64_t wdims[3] = {static_cast<uint64_t>(n),
                             static_cast<uint64_t>(k),
                             static_cast<uint64_t>(g)};
  const uint64_t wstrides[2] = {n * 2ull, k * n * 2ull};
  const uint32_t wbox[3] = {64, KR, 1};
  const uint64_t xdims[3] = {static_cast<uint64_t>(k),
                             static_cast<uint64_t>(g),
                             static_cast<uint64_t>(m)};
  const uint64_t xstrides[2] = {k * 2ull, g * k * 2ull};
  const uint32_t xbox[3] = {64, 1, 8};
  if (!hopper::encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w,
                          wdims, wstrides, wbox,
                          CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x,
                          xdims, xstrides, xbox,
                          CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(units), static_cast<unsigned>(g));
  kernel<<<grid, kThreads, U::kSmem, st>>>(
      wmap, xmap, y, static_cast<int>(m), static_cast<int>(g),
      static_cast<int>(k), static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// route "stream", fp32: M <= 8, fp32 FMAs from shared memory
// ---------------------------------------------------------------------------

namespace fgemv {
constexpr int kCols = 96;                     // columns of a work unit
constexpr int KR = 32;                        // rows of K a stage holds
constexpr int kStages = 4;
constexpr int kConsumerWarps = 6;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;     // + the producer warp
constexpr int kWBytes = KR * kCols * 4;       // 12 KB: w's box of a stage
constexpr int kXBytes = KR * kStreamMaxM * 4; // 1 KB: x's box, at most
constexpr int kSmem =
    1024 + kStages * (kWBytes + kXBytes) + 2 * kStages * 8;
}  // namespace fgemv

// MR rows of x (4 or 8; rows >= M are zeros from the x map), MINB blocks
// per SM. wmap: (G, K, N) with box (1, 32, 96); xmap: (M, G, K) with box
// (MR, 1, 32). Thread (r0, c) owns 4 columns (one 16-byte chunk of a row)
// and rows r0, r0 + R, ... of every stage; the row slices' partial sums
// meet in shared memory.
template <int MR, int MINB>
__global__ void __launch_bounds__(fgemv::kThreads, MINB)
    grouped_matmul_fgemv_kernel(const __grid_constant__ CUtensorMap wmap,
                                const __grid_constant__ CUtensorMap xmap,
                                float* __restrict__ y, int m, int groups,
                                int k, int n) {
  using namespace fgemv;
  constexpr int CH = kCols / 4;                // 16-byte chunks a row
  constexpr int R = kConsumers / CH;           // row slices
  constexpr uint32_t kTx = kWBytes + MR * KR * 4;
  static_assert(kConsumers % CH == 0 && KR % R == 0, "thread layout");
  static_assert(R * MR * kCols * 4 <= kStages * kWBytes, "partials");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  float* ws = reinterpret_cast<float*>(base);            // [S][KR][96]
  uint8_t* xbase = base + kStages * kWBytes;             // [S][MR][KR]
  uint64_t* full = reinterpret_cast<uint64_t*>(xbase + kStages * kXBytes);
  uint64_t* empty = full + kStages;

  const int g = blockIdx.y;
  const int n0 = blockIdx.x * kCols;
  const int nk = (k + KR - 1) / KR;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {            // the producer
    if (lane == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        if (it >= kStages) {
          hopper::mbar_wait(&empty[s], (it / kStages - 1) & 1);
        }
        hopper::mbar_arrive_expect_tx(&full[s], kTx);
        hopper::tma_load_3d(ws + s * KR * kCols, &wmap, &full[s], n0,
                            it * KR, g);
        hopper::tma_load_3d(xbase + s * kXBytes, &xmap, &full[s], it * KR,
                            g, 0);
      }
    }
    return;
  }

  const int c = threadIdx.x % CH;
  const int r0 = threadIdx.x / CH;
  float acc[MR][4];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int it = 0; it < nk; ++it) {
    const int s = it % kStages;
    hopper::mbar_wait(&full[s], (it / kStages) & 1);
    const float* wt = ws + s * KR * kCols + c * 4;
    const float* xt = reinterpret_cast<const float*>(xbase + s * kXBytes);
    // rows past K are zeros in both boxes
#pragma unroll
    for (int q = 0; q < KR / R; ++q) {
      const int r = r0 + q * R;
      const float4 wv = *reinterpret_cast<const float4*>(wt + r * kCols);
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const float xv = xt[i * KR + r];
        acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
        acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
        acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
        acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // the row slices' partial sums, over the drained ring, in a fixed order
  hopper::named_sync(1, kConsumers);
  float* part = reinterpret_cast<float*>(base);          // [R][MR][96]
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    *reinterpret_cast<float4*>(&part[(r0 * MR + i) * kCols + c * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  hopper::named_sync(1, kConsumers);
  const int64_t y_row = static_cast<int64_t>(groups) * n;
  float* yg = y + static_cast<int64_t>(g) * n + n0;
  for (int o = threadIdx.x; o < MR * kCols; o += kConsumers) {
    const int i = o / kCols;
    const int col = o % kCols;
    if (i >= m || n0 + col >= n) continue;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < R; ++q) sum += part[(q * MR + i) * kCols + col];
    yg[i * y_row + col] = sum;
  }
}

template <int MR, int MINB>
int launch_fgemv(const float* x, const float* w, float* y, int64_t m,
                 int64_t g, int64_t k, int64_t n, cudaStream_t st) {
  using namespace fgemv;
  const auto kernel = grouped_matmul_fgemv_kernel<MR, MINB>;
  static const cudaError_t attr = allow_smem(kernel, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap wmap, xmap;
  const uint64_t wdims[3] = {static_cast<uint64_t>(n),
                             static_cast<uint64_t>(k),
                             static_cast<uint64_t>(g)};
  const uint64_t wstrides[2] = {n * 4ull, k * n * 4ull};
  const uint32_t wbox[3] = {kCols, KR, 1};
  const uint64_t xdims[3] = {static_cast<uint64_t>(k),
                             static_cast<uint64_t>(g),
                             static_cast<uint64_t>(m)};
  const uint64_t xstrides[2] = {k * 4ull, g * k * 4ull};
  const uint32_t xbox[3] = {KR, 1, MR};
  if (!hopper::encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, w,
                          wdims, wstrides, wbox,
                          CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !hopper::encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, x,
                          xdims, xstrides, xbox,
                          CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((n + kCols - 1) / kCols),
                  static_cast<unsigned>(g));
  kernel<<<grid, kThreads, kSmem, st>>>(wmap, xmap, y, static_cast<int>(m),
                                        static_cast<int>(g),
                                        static_cast<int>(k),
                                        static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
bool stream_fits(const void* x, const void* w, int64_t m, int64_t g,
                 int64_t k, int64_t n) {
  return m <= kStreamMaxM && tma_fits<T>(x, w, g, k, n) && g <= 65535;
}

template <typename T>
int launch_stream(const T* x, const T* w, T* y, int64_t m, int64_t g,
                  int64_t k, int64_t n, int splits, int cols,
                  cudaStream_t st) {
  if (!stream_fits<T>(x, w, m, g, k, n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (sizeof(T) == 2) {
    if (splits != 1 || !plan_cols(cols)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (cols == 64) return launch_gemv<64>(x, w, y, m, g, k, n, st);
    if (cols == 128) return launch_gemv<128>(x, w, y, m, g, k, n, st);
    return launch_gemv<192>(x, w, y, m, g, k, n, st);
  } else {
    if (splits != 1 || cols != kDefaultCols) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (m <= 4) return launch_fgemv<4, 4>(x, w, y, m, g, k, n, st);
    return launch_fgemv<8, 2>(x, w, y, m, g, k, n, st);
  }
}

// ---------------------------------------------------------------------------
// route "wgmma": M > 8, bf16, tensor cores
// ---------------------------------------------------------------------------

namespace mma {
constexpr int BM = 128;        // rows of a tile: two warpgroups of 64
constexpr int BK = 64;         // K of a stage: one 128-byte swizzle row
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 32;   // + the producer warp
constexpr int kABytes = BM * BK * 2;                 // 16 KB
constexpr int kBBox = BK * 64 * 2;                   // 8 KB: 64 columns
constexpr int kYBox = BM * 64 * 2;                   // 16 KB: 64 columns
constexpr int kOutChunk = 16 * 64 * 2;     // 2 KB: a warp's 16 x 64 of y
constexpr int kMaxRing = 8;       // stages of the unsplit kernel's ring
constexpr int kConsumers = 32 * kConsumerWarps;
}  // namespace mma

// d (64 x 192 fp32, in the wgmma register layout) += A (64 x 16, K-major)
// * B (16 x 192, MN-major), both read from shared memory by descriptor.
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The same for a 64 x 128 and a 64 x 64 B (register layouts as above,
// 64 and 32 values a thread).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The same for B of 256 columns (d: 64 x 256 fp32).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a,
                                           uint64_t b) {
  if constexpr (N == 256) {
    wgmma_m64n256k16(d, a, b);
  } else if constexpr (N == 192) {
    wgmma_m64n192k16(d, a, b);
  } else if constexpr (N == 128) {
    wgmma_m64n128k16(d, a, b);
  } else {
    static_assert(N == 64, "tile widths 64, 128, 192, 256");
    wgmma_m64n64k16(d, a, b);
  }
}

// A tile of BN_ columns in the split kernel (64 and 128 columns): it
// keeps, past its ring and a 128-row y tile, the partials its block
// receives: S slots of 128/S rows x BN fp32, one tile's worth, so its
// ring is shallower (4 stages at 128 columns); its own partial goes into
// the drained ring.
template <int BN_>
struct MmaTile {
  static constexpr int BN = BN_;
  static constexpr int kStageBytes = mma::kABytes + (BN / 64) * mma::kBBox;
  static constexpr int kSplitStages = BN == 128 ? 4 : 7;
  static constexpr int kYBytes = (BN / 64) * mma::kYBox;
  static constexpr int kRecvBytes = mma::BM * BN * 4;
  static constexpr int kSplitSmem = 1024 + kSplitStages * kStageBytes +
                                    kYBytes + kRecvBytes +
                                    2 * kSplitStages * 8 + 8;
  static_assert(!split_cols(BN) || (kSplitSmem <= kMaxSmem &&
                                    kRecvBytes <= kSplitStages * kStageBytes),
                "a split block's shared memory; its partial in the ring");
};

// The unsplit kernel's shared memory at BN columns, 1024-aligned: a ring
// of kStages stages, each x's box and the tile's BN/64 w boxes; the y
// chunks its consumer warps store (two 16 x 64 bf16 buffers each, 32
// KB); a full and an empty mbarrier a stage. The ring takes as many
// stages as fit, at most kMaxRing: 8, 6, 4 and 4 at 64, 128, 192 and 256
// columns (192-197 KB).
template <int BN>
struct UnsplitLayout {
  static constexpr int kStageBytes = mma::kABytes + (BN / 64) * mma::kBBox;
  static constexpr int kOutBytes = 2 * mma::kConsumerWarps * mma::kOutChunk;
  static constexpr int kFit =
      (kMaxSmem - 1024 - kOutBytes) / (kStageBytes + 16);
  static constexpr int kStages = kFit < mma::kMaxRing ? kFit : mma::kMaxRing;
  static constexpr int kSmem = 1024 + kStages * (kStageBytes + 16) + kOutBytes;
  static_assert(kStages >= 4 && kSmem <= kMaxSmem, "an unsplit block");
};

// The contiguous range [begin, end) of `nk` stages that split `rank` of
// `splits` takes: the first nk % splits splits take one stage more.
struct StageRange {
  int begin, end;
};
__device__ __forceinline__ StageRange stage_range(int nk, int rank,
                                                  int splits) {
  const int base = nk / splits;
  const int extra = nk % splits;
  const int begin = rank * base + min(rank, extra);
  return {begin, begin + base + (rank < extra ? 1 : 0)};
}

// The producer thread: stages [ks.begin, ks.end) of tile (g, mt, nt)
// into the ring of kStages slots, from slot count `it` on.
template <int BN, int kStages>
__device__ __forceinline__ void wgmma_produce(const CUtensorMap& xmap,
                                              const CUtensorMap& wmap,
                                              uint8_t* base, uint64_t* full,
                                              uint64_t* empty, int g, int mt,
                                              int nt, StageRange ks,
                                              int& it) {
  using namespace mma;
  constexpr int kStageBytes = MmaTile<BN>::kStageBytes;
  for (int kb = ks.begin; kb < ks.end; ++kb, ++it) {
    const int s = it % kStages;
    if (it >= kStages) {
      hopper::mbar_wait(&empty[s], (it / kStages - 1) & 1);
    }
    uint8_t* st = base + s * kStageBytes;
    hopper::mbar_arrive_expect_tx(&full[s], kStageBytes);
    hopper::tma_load_3d(st, &xmap, &full[s], kb * BK, g, mt * BM);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j) {
      hopper::tma_load_3d(st + kABytes + j * kBBox, &wmap, &full[s],
                          nt * BN + j * 64, kb * BK, g);
    }
  }
}

// Consumer warpgroup wg: its 64 rows of the tile over `nk` stages, from
// slot count `it` on. The accumulator layout: value 4c + 2h + e of a
// thread sits at row 16*(warp % 4) + lane/4 + 8h and column 8c +
// 2*(lane % 4) + e of the warpgroup's 64 x BN.
template <int BN, int kStages>
__device__ __forceinline__ void wgmma_consume(float (&acc)[BN / 2],
                                              const uint8_t* base,
                                              uint64_t* full, uint64_t* empty,
                                              int wg, int lane, int nk,
                                              int& it) {
  using namespace mma;
  constexpr int kStageBytes = MmaTile<BN>::kStageBytes;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int ks = 0; ks < nk; ++ks, ++it) {
    const int s = it % kStages;
    hopper::mbar_wait(&full[s], (it / kStages) & 1);
    const uint8_t* a = base + s * kStageBytes + wg * (kABytes / 2);
    const uint8_t* b = base + s * kStageBytes + kABytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: rows of 128 bytes, 8-row groups 1 KB apart, k16 = 32 bytes
      // along the row; B: 64-column blocks 8 KB apart, 8-row groups of
      // K 1 KB apart, k16 = 16 rows = 2 KB
      wgmma_bf16<BN>(acc, hopper::desc_sw128(a + kk * 32, 16, 1024),
                     hopper::desc_sw128(b + kk * 2048, kBBox, 1024));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }
}

// Releases ring slot s once this warp's products on it are done: lane 0
// arrives on the slot's empty barrier in each of the CM blocks of the
// cluster, whose producers may all write into it (w's boxes multicast).
template <int CM>
__device__ __forceinline__ void release_slot(uint64_t* empty, int s,
                                             int lane) {
  __syncwarp();
  if (lane != 0) return;
  if constexpr (CM == 1) {
    hopper::mbar_arrive(&empty[s]);
  } else {
#pragma unroll
    for (int r = 0; r < CM; ++r) {
      hopper::mbar_arrive_cluster(hopper::cluster_map(&empty[s], r));
    }
  }
}

// Tile t of the unsplit kernel's order: groups slowest, then column
// tiles, then row tiles (of CM) fastest, so that the clusters in flight
// share a few of w's tiles and one group's x, which stay in L2.
struct TilePos {
  int g, mt, nt;
};
__device__ __forceinline__ TilePos tile_at(int t, int tiles_m,
                                           int tiles_n) {
  return {t / (tiles_m * tiles_n), t % tiles_m, t / tiles_m % tiles_n};
}

// Unsplit kernel. xmap: (M, G, K) with box (128, 1, 64); wmap: (G, K, N)
// with box (1, 64, 64); ymap: (M, G, N) with box (16, 1, 64); all with
// 128-byte swizzle. A cluster of CM blocks (1, or 2 along M) takes CM
// row tiles of one group's BN columns at once: block rank r the row tile
// CM * mt + r; each block loads its own x box and the w boxes j with
// j % CM == r, multicast to every block of the cluster, so w is read from
// L2 once for CM row tiles. Cluster c walks the cluster tiles c, c +
// clusters, ... (``tile_at``'s order) over all of K.
//
// Consumer warpgroup wg owns rows wg*64 ... wg*64 + 63 of a tile. It keeps
// one group of products in flight across stages (wgmma_wait<1>, the slot
// before freed). Then each of its warps rounds its 16 rows to bf16 into
// 16 x 64 chunks, two buffers a warp, each stored by TMA while the next
// is written: no barrier but the warp's own.
template <int BN, int CM>
__global__ void __launch_bounds__(mma::kThreads, 1)
    grouped_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                                const __grid_constant__ CUtensorMap wmap,
                                const __grid_constant__ CUtensorMap ymap,
                                int m, int groups, int k, int n) {
  using namespace mma;
  using L = UnsplitLayout<BN>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);     // [S][A 16 KB | B BN/64 x 8 KB]
  uint8_t* out = ring + kStages * L::kStageBytes;  // [2 wg][2][64][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(out + L::kOutBytes);
  uint64_t* empty = full + kStages;

  const int tiles_n = (n + BN - 1) / BN;
  const int tiles_m = (m + CM * BM - 1) / (CM * BM);   // of CM row tiles
  const int tiles = groups * tiles_m * tiles_n;
  const int nk = (k + BK - 1) / BK;
  const int rank = CM == 1 ? 0 : static_cast<int>(hopper::cluster_rank());
  const int cluster = static_cast<int>(blockIdx.x) / CM;
  const int clusters = static_cast<int>(gridDim.x) / CM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps * CM);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if constexpr (CM > 1) {                  // every block's barriers are set
    hopper::cluster_arrive_relaxed();
    hopper::cluster_wait();
  }

  if (warp == kConsumerWarps) {            // the producer
    if (lane == 0) {
      int it = 0;
      for (int t = cluster; t < tiles; t += clusters) {
        const TilePos tl = tile_at(t, tiles_m, tiles_n);
        const int mt = tl.mt * CM + rank;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % kStages;
          if (it >= kStages) {
            hopper::mbar_wait(&empty[s], (it / kStages - 1) & 1);
          }
          uint8_t* st = ring + s * L::kStageBytes;
          hopper::mbar_arrive_expect_tx(&full[s], L::kStageBytes);
          hopper::tma_load_3d(st, &xmap, &full[s], kb * BK, tl.g, mt * BM);
#pragma unroll
          for (int j = rank; j < BN / 64; j += CM) {
            if constexpr (CM == 1) {
              hopper::tma_load_3d(st + kABytes + j * kBBox, &wmap, &full[s],
                                  tl.nt * BN + j * 64, kb * BK, tl.g);
            } else {
              hopper::tma_load_3d_multicast(
                  st + kABytes + j * kBBox, &wmap, &full[s],
                  tl.nt * BN + j * 64, kb * BK, tl.g, (1u << CM) - 1);
            }
          }
        }
      }
    }
  } else {
    const int wg = warp / 4;
    uint8_t* bufs = out + warp * 2 * kOutChunk;
    int it = 0, chunks = 0;
    for (int t = cluster; t < tiles; t += clusters) {
      const TilePos tl = tile_at(t, tiles_m, tiles_n);
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int s = it % kStages;
        hopper::mbar_wait(&full[s], (it / kStages) & 1);
        const uint8_t* a = ring + s * L::kStageBytes + wg * (kABytes / 2);
        const uint8_t* b = ring + s * L::kStageBytes + kABytes;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // A: rows of 128 bytes, 8-row groups 1 KB apart, k16 = 32 bytes
          // along the row; B: 64-column blocks 8 KB apart, 8-row groups of
          // K 1 KB apart, k16 = 16 rows = 2 KB
          wgmma_bf16<BN>(acc, hopper::desc_sw128(a + kk * 32, 16, 1024),
                         hopper::desc_sw128(b + kk * 2048, kBBox, 1024));
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        if (ks > 0) release_slot<CM>(empty, (it - 1) % kStages, lane);
      }
      hopper::wgmma_wait<0>();
      release_slot<CM>(empty, (it - 1) % kStages, lane);

      const int y_row = (tl.mt * CM + rank) * BM + warp * 16;
      // each 64-column chunk of the warp's rows goes to a buffer in the
      // 128-byte swizzle of the y map (16-byte chunk q of row r at q ^ r%8:
      // the warp's 8 rows x 16 bytes hit 32 distinct banks), then out by
      // TMA, which writes whole lines and clips at the M and N edges (a
      // chunk wholly past them is not stored); a buffer is written again
      // once the store two chunks back has read it
#pragma unroll
      for (int j = 0; j < BN / 64; ++j, ++chunks) {
        uint8_t* buf = bufs + (chunks & 1) * kOutChunk;
        if (lane == 0) hopper::tma_store_wait_read<1>();
        __syncwarp();
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = lane / 4 + 8 * h;
            const int v = 4 * (8 * j + c) + 2 * h;
            *reinterpret_cast<uint32_t*>(buf + r * 128 + ((c ^ (r % 8)) * 16) +
                                         4 * (lane % 4)) =
                bf16x2(acc[v], acc[v + 1]);
          }
        }
        hopper::fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          const int col = tl.nt * BN + j * 64;
          if (y_row < m && col < n) {
            hopper::tma_store_3d(&ymap, buf, col, tl.g, y_row);
          }
          hopper::tma_store_commit();
        }
      }
    }
    if (lane == 0) hopper::tma_store_wait_read();
  }
  if constexpr (CM > 1) {   // no block leaves while the other may write to it
    hopper::cluster_arrive();
    hopper::cluster_wait();
  }
}

// How many clusters of `splits` blocks of `kernel` (threads, smem each)
// the card holds at once (cudaOccupancyMaxActiveClusters, kept in
// `cache`, one slot a cluster size, -1 until asked); 0 where it holds
// none or the query fails (its error in *err).
template <typename Kernel>
int active_clusters(Kernel kernel, int threads, int smem, int splits,
                    int* cache, cudaError_t* err) {
  *err = cudaSuccess;
  if (cache[splits] >= 0) return cache[splits];
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(splits));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  *err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (*err != cudaSuccess) {
    cudaGetLastError();   // cleared: the next launch must not read it
    return 0;
  }
  cache[splits] = clusters;
  return clusters;
}

// Launches `kernel` on `grid` in clusters of (splits, 1, 1), after
// checking that the card holds one such cluster (`cache` as in
// active_clusters); returns the launch's error, else cudaGetLastError().
template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, dim3 grid, int threads, int smem,
                    int splits, int* cache, cudaStream_t st, Args... args) {
  cudaError_t e;
  if (active_clusters(kernel, threads, smem, splits, cache, &e) == 0) {
    return static_cast<int>(e != cudaSuccess ? e
                                             : cudaErrorInvalidClusterSize);
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// Split: one tile a cluster of S (splits, a power of two) blocks along x,
// blockIdx.x = S * tile + rank; rank r streams its range of K and owns
// rows [r 128/S, (r + 1) 128/S) of the tile. Each block writes its fp32
// partial into its drained ring ([128][BN]) and copies each owner's rows
// into slot `rank` of that owner's receive buffer (one bulk copy an
// owner); the owner adds the S slots in rank order once its mbarrier has
// counted all their bytes, rounds to bf16 and stores its rows by TMA
// (ymap box (128/S, 1, BN), no swizzle). A last cluster barrier keeps
// every block, and the partial its copies read, until all have landed.
template <int BN>
__global__ void __launch_bounds__(mma::kThreads, 1)
    grouped_matmul_wgmma_split_kernel(
        const __grid_constant__ CUtensorMap xmap,
        const __grid_constant__ CUtensorMap wmap,
        const __grid_constant__ CUtensorMap ymap, int m, int groups, int k,
        int n, int splits) {
  using namespace mma;
  using T = MmaTile<BN>;
  constexpr int kStages = T::kSplitStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* ys = base + kStages * T::kStageBytes;   // [128/S][BN] bf16
  float* recv = reinterpret_cast<float*>(ys + T::kYBytes);  // [S][128/S][BN]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ys + T::kYBytes + T::kRecvBytes);
  uint64_t* empty = full + kStages;
  uint64_t* recv_bar = empty + kStages;

  const int tiles_n = (n + BN - 1) / BN;
  const int tiles_m = (m + BM - 1) / BM;
  const int t = blockIdx.x / splits;
  const int g = t / (tiles_m * tiles_n);
  const int mt = t / tiles_n % tiles_m;
  const int nt = t % tiles_n;
  const int rank = static_cast<int>(hopper::cluster_rank());
  const int rows = BM / splits;            // rows a rank owns
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_init(recv_bar, 1);
    hopper::mbar_fence_init();
    hopper::mbar_arrive_expect_tx(recv_bar, T::kRecvBytes);
  }
  __syncthreads();
  hopper::cluster_arrive_relaxed();     // every block's barriers are set
  const StageRange kr = stage_range((k + BK - 1) / BK, rank, splits);
  int it = 0;

  if (warp == kConsumerWarps) {            // the producer
    if (lane == 0) {
      wgmma_produce<BN, kStages>(xmap, wmap, base, full, empty, g, mt, nt,
                                 kr, it);
    }
    hopper::cluster_wait();
    hopper::cluster_arrive_relaxed();
    hopper::cluster_wait();
    return;
  }
  const int wg = warp / 4;
  float acc[BN / 2];
  wgmma_consume<BN, kStages>(acc, base, full, empty, wg, lane,
                             kr.end - kr.begin, it);
  hopper::named_sync(1, kConsumers);       // the ring is drained
  float* part = reinterpret_cast<float*>(base);             // [128][BN]
  const int row0 = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(
          &part[(row0 + 8 * h) * BN + 8 * c + 2 * (lane % 4)]) =
          make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
    }
  }
  hopper::fence_proxy_async();              // the bulk copies read it
  hopper::named_sync(1, kConsumers);
  hopper::cluster_wait();
  if (threadIdx.x == 0) {
    for (int o = 0; o < splits; ++o) {
      hopper::bulk_copy_cluster(
          hopper::cluster_map(recv + rank * rows * BN, o),
          part + o * rows * BN, rows * BN * 4,
          hopper::cluster_map(recv_bar, o));
    }
  }
  hopper::mbar_wait(recv_bar, 0);
  // this rank's rows, 8 columns (16 bytes of bf16) a thread at a time
  for (int q = threadIdx.x; q < rows * BN / 8; q += kConsumers) {
    const float* p = recv + q * 8;
    float4 lo = *reinterpret_cast<const float4*>(p);
    float4 hi = *reinterpret_cast<const float4*>(p + 4);
    for (int s = 1; s < splits; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(p + s * rows * BN);
      const float4 b =
          *reinterpret_cast<const float4*>(p + s * rows * BN + 4);
      lo.x += a.x;
      lo.y += a.y;
      lo.z += a.z;
      lo.w += a.w;
      hi.x += b.x;
      hi.y += b.y;
      hi.z += b.z;
      hi.w += b.w;
    }
    *reinterpret_cast<uint4*>(ys + q * 16) =
        make_uint4(bf16x2(lo.x, lo.y), bf16x2(lo.z, lo.w),
                   bf16x2(hi.x, hi.y), bf16x2(hi.z, hi.w));
  }
  hopper::fence_proxy_async();
  hopper::named_sync(1, kConsumers);
  if (threadIdx.x == 0 && mt * BM + rank * rows < m) {
    hopper::tma_store_3d(&ymap, ys, nt * BN, g, mt * BM + rank * rows);
    hopper::tma_store_commit();
    hopper::tma_store_wait_read();
  }
  hopper::cluster_arrive_relaxed();     // this block's slots have landed
  hopper::cluster_wait();
}

// Whether (splits, cols) is a plan the wgmma kernels were built for:
// splits a power of two up to kMaxSplits (it divides the 128 rows of a
// tile), wgmma_cols unsplit and split_cols split, every split at least
// one stage of K.
bool plan_fits(int64_t k, int splits, int cols) {
  return splits >= 1 && splits <= kMaxSplits &&
         (splits & (splits - 1)) == 0 &&
         (splits == 1 ? wgmma_cols(cols) : split_cols(cols)) &&
         splits <= (k + mma::BK - 1) / mma::BK;
}

bool wgmma_fits(const void* x, const void* w, const void* y, int64_t m,
                int64_t g, int64_t k, int64_t n, int cols) {
  using namespace mma;
  const int64_t tiles = g * ((m + BM - 1) / BM) * ((n + cols - 1) / cols);
  return m > kStreamMaxM && tma_fits<__nv_bfloat16>(x, w, g, k, n) &&
         reinterpret_cast<uintptr_t>(y) % 16 == 0 && m <= kMaxCoord &&
         tiles <= kMaxCoord;
}

// The unsplit kernel in clusters of CM blocks along M, persistent: one
// block an SM (CM = 1), or as many clusters as the card holds at once.
template <int BN, int CM>
int launch_unsplit(const CUtensorMap& xmap, const CUtensorMap& wmap,
                   const CUtensorMap& ymap, int64_t m, int64_t g, int64_t k,
                   int64_t n, int sms, cudaStream_t st) {
  using namespace mma;
  using L = UnsplitLayout<BN>;
  const auto kernel = grouped_matmul_wgmma_kernel<BN, CM>;
  static const cudaError_t attr = allow_smem(kernel, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int64_t tiles =
      g * ((m + CM * BM - 1) / (CM * BM)) * ((n + BN - 1) / BN);
  const int mi = static_cast<int>(m), gi = static_cast<int>(g);
  const int ki = static_cast<int>(k), ni = static_cast<int>(n);
  if constexpr (CM == 1) {
    const unsigned blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
    kernel<<<blocks, kThreads, L::kSmem, st>>>(xmap, wmap, ymap, mi, gi, ki,
                                                ni);
    return static_cast<int>(cudaGetLastError());
  } else {
    static int cache[kMaxSplits + 1] = {-1, -1, -1, -1, -1,
                                        -1, -1, -1, -1};
    cudaError_t e;
    const int64_t active =
        active_clusters(kernel, kThreads, L::kSmem, CM, cache, &e);
    if (active == 0) {
      return static_cast<int>(e != cudaSuccess ? e
                                               : cudaErrorInvalidClusterSize);
    }
    const int64_t clusters = tiles < active ? tiles : active;
    return launch_clusters(kernel, dim3(static_cast<unsigned>(clusters * CM)),
                           kThreads, L::kSmem, CM, cache, st, xmap, wmap,
                           ymap, mi, gi, ki, ni);
  }
}

// Clusters of the unsplit kernel's pairs (BN columns) the card holds.
template <int BN>
int pairs_held(int* cache, cudaError_t* err) {
  using L = UnsplitLayout<BN>;
  const auto kernel = grouped_matmul_wgmma_kernel<BN, 2>;
  *err = allow_smem(kernel, L::kSmem);
  if (*err != cudaSuccess) return -1;
  return active_clusters(kernel, mma::kThreads, L::kSmem, 2, cache, err);
}

template <int BN>
int launch_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* w,
                 __nv_bfloat16* y, int64_t m, int64_t g, int64_t k,
                 int64_t n, int splits, cudaStream_t st) {
  using namespace mma;
  using T = MmaTile<BN>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t tiles = g * ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  if (tiles * splits > kMaxGridX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap xmap, wmap, ymap;
  const uint64_t xdims[3] = {static_cast<uint64_t>(k),
                             static_cast<uint64_t>(g),
                             static_cast<uint64_t>(m)};
  const uint64_t xstrides[2] = {k * 2ull, g * k * 2ull};
  const uint32_t xbox[3] = {BK, 1, BM};
  const uint64_t wdims[3] = {static_cast<uint64_t>(n),
                             static_cast<uint64_t>(k),
                             static_cast<uint64_t>(g)};
  const uint64_t wstrides[2] = {n * 2ull, k * n * 2ull};
  const uint32_t wbox[3] = {64, BK, 1};
  const uint64_t ydims[3] = {static_cast<uint64_t>(n),
                             static_cast<uint64_t>(g),
                             static_cast<uint64_t>(m)};
  const uint64_t ystrides[2] = {n * 2ull, g * n * 2ull};
  const uint32_t ybox[3] = {splits == 1 ? 64u : static_cast<uint32_t>(BN), 1,
                            splits == 1 ? 16u
                                        : static_cast<uint32_t>(BM / splits)};
  if (!hopper::encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x,
                          xdims, xstrides, xbox,
                          CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w,
                          wdims, wstrides, wbox,
                          CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::encode_map(&ymap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, y,
                          ydims, ystrides, ybox,
                          splits == 1 ? CU_TENSOR_MAP_SWIZZLE_128B
                                      : CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1) {
    if constexpr (split_cols(BN)) {
      const auto split_kernel = grouped_matmul_wgmma_split_kernel<BN>;
      static const cudaError_t attr =
          allow_smem(split_kernel, T::kSplitSmem);
      if (attr != cudaSuccess) return static_cast<int>(attr);
      static int cache[kMaxSplits + 1] = {-1, -1, -1, -1, -1,
                                          -1, -1, -1, -1};
      return launch_clusters(split_kernel,
                             dim3(static_cast<unsigned>(tiles * splits)),
                             kThreads, T::kSplitSmem, splits, cache, st,
                             xmap, wmap, ymap, static_cast<int>(m),
                             static_cast<int>(g), static_cast<int>(k),
                             static_cast<int>(n), splits);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // past one row tile, pairs of row tiles share w's boxes (a cluster of 2)
  const bool pairs = m > BM;
  return pairs ? launch_unsplit<BN, 2>(xmap, wmap, ymap, m, g, k, n, sms, st)
               : launch_unsplit<BN, 1>(xmap, wmap, ymap, m, g, k, n, sms, st);
}

int launch_wgmma_plan(const __nv_bfloat16* x, const __nv_bfloat16* w,
                      __nv_bfloat16* y, int64_t m, int64_t g, int64_t k,
                      int64_t n, int splits, int cols, cudaStream_t st) {
  if (!plan_fits(k, splits, cols) ||
      !wgmma_fits(x, w, y, m, g, k, n, cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cols == 64) return launch_wgmma<64>(x, w, y, m, g, k, n, splits, st);
  if (cols == 128) return launch_wgmma<128>(x, w, y, m, g, k, n, splits, st);
  if (cols == 192) return launch_wgmma<192>(x, w, y, m, g, k, n, splits, st);
  return launch_wgmma<256>(x, w, y, m, g, k, n, splits, st);
}

enum Route { kStream = 0, kWgmma = 1, kSimt = 2, kSgemm = 3 };

template <typename T>
int launch(const void* x, const void* w, void* y, int64_t m, int64_t g,
           int64_t k, int64_t n, int route, int splits, int cols,
           cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  if (route == kStream) {
    return launch_stream<T>(xp, wp, yp, m, g, k, n, splits, cols, stream);
  }
  if constexpr (sizeof(T) == 2) {
    if (route == kWgmma) {
      return launch_wgmma_plan(xp, wp, yp, m, g, k, n, splits, cols, stream);
    }
  }
  if (splits != 1 || cols != kDefaultCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == kSimt) return launch_simt<T>(xp, wp, yp, m, g, k, n, stream);
  if constexpr (sizeof(T) == 4) {
    if (route == kSgemm) return launch_sgemm(xp, wp, yp, m, g, k, n, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int grouped_matmul_launch(const void* x, const void* w, void* y,
                                     long long m, long long g, long long k,
                                     long long n, int dtype, int route,
                                     int splits, int cols, void* stream) {
  if (m <= 0 || g <= 0 || k <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, w, y, m, g, k, n, route, splits, cols, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, w, y, m, g, k, n, route, splits, cols,
                                 s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory (bytes) of a block of `route` under plan
// (splits, cols) (for reports), -1 for a route, dtype or plan the kernels
// do not take.
extern "C" int grouped_matmul_dynamic_smem(int route, int dtype, int splits,
                                           int cols) {
  if (dtype == 1 && route == kWgmma && splits > 1) {
    if (splits > kMaxSplits || (splits & (splits - 1)) != 0) return -1;
    if (cols == 64) return MmaTile<64>::kSplitSmem;
    if (cols == 128) return MmaTile<128>::kSplitSmem;
    return -1;
  }
  if (splits != 1) return -1;
  if (dtype == 1 && (route == kStream || route == kWgmma)) {
    const bool stream = route == kStream;
    if (stream) {
      if (cols == 64) return Unit<64>::kSmem;
      if (cols == 128) return Unit<128>::kSmem;
      if (cols == 192) return Unit<192>::kSmem;
      return -1;
    }
    if (cols == 64) return UnsplitLayout<64>::kSmem;
    if (cols == 128) return UnsplitLayout<128>::kSmem;
    if (cols == 192) return UnsplitLayout<192>::kSmem;
    if (cols == 256) return UnsplitLayout<256>::kSmem;
    return -1;
  }
  if (cols != kDefaultCols) return -1;
  if (route == kStream && dtype == 0) return fgemv::kSmem;
  if (route == kSimt && (dtype == 0 || dtype == 1)) return 0;
  if (route == kSgemm && dtype == 0) return sg::kSmem;
  return -1;
}

// Clusters of the unsplit wgmma kernel's row-tile pairs at `cols` columns
// that the card holds at once (for reports), -1 for a width it was not
// built for or when the query fails.
extern "C" int grouped_matmul_wgmma_pairs(int cols) {
  int cache[kMaxSplits + 1] = {-1, -1, -1, -1, -1, -1, -1, -1, -1};
  cudaError_t e = cudaSuccess;
  int n = -1;
  if (cols == 64) {
    n = pairs_held<64>(cache, &e);
  } else if (cols == 128) {
    n = pairs_held<128>(cache, &e);
  } else if (cols == 192) {
    n = pairs_held<192>(cache, &e);
  } else if (cols == 256) {
    n = pairs_held<256>(cache, &e);
  }
  return e == cudaSuccess ? n : -1;
}
