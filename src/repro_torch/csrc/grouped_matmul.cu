// Block-diagonal (grouped) matrix product for Hopper (sm_90a).
//
// Replaces the TPU kernel `grouped_matmul_kernel` of
// src/repro/kernels/grouped_matmul.py (its pl.pallas_call), the product
// behind Fed2's block-diagonal layers; on the port's serving path it is
// the Fed2 unembedding of a Mamba-2 LM. For x (M, G*K) and w (G, K, N),
// both row-major fp32 or bf16,
//     y[m, g*N + n] = sum_k x[m, g*K + k] * w[g, k, n]
// accumulated in fp32 and stored in x's dtype, (M, G*N) row-major. The
// bias stays outside, in the wrapper (as in the reference's ops.py).
//
// Bound on the H100: at the serving shapes (M = batch of 4 to 128,
// G = 8, K = 256, N = 6288, bf16) the weights are 25.8 MB read once,
// 7.7 us at 3.35 TB/s, against 0.1-3.3 GFLOP that the bf16 tensor cores
// would do in at most 3.3 us: bytes bound. With fp32 FMAs, as here, the
// arithmetic of M = 128 alone takes 49 us at 67 TFLOP/s: tensor cores
// are the next step.
// The TPU kernel walks K as a sequential grid axis into a VMEM
// accumulator on 128-padded tiles (its wrapper pads M, K and N). Here
// nothing is padded, and any M, K and N work. Two paths, both fp32 FMAs
// (no tensor cores yet):
// - M <= 8 (decode batches), N % 4 == 0 and w aligned: streaming. A
//   block owns 128 columns of one group; each lane reads 4 contiguous
//   columns of w (one 16-byte fp32 or 8-byte bf16 load a row) straight
//   into registers, 4 rows in flight, the block's 8 warps split K, the
//   group's x panel is staged in shared memory as fp32 and read as
//   broadcasts, and the 8 partial rows are summed in shared memory in a
//   fixed order. w is read once, with no staging.
// - otherwise: tiles. A block computes one 64 x 128 tile of one group's
//   output, reading the group's x panel (row stride G*K, column offset
//   g*K) and w[g] in 16-deep slices through shared memory, every load
//   bounds-checked. w is read with 16-byte loads when N is a multiple of
//   16 bytes' worth of elements and w is 16-byte aligned (else one
//   element a load), and all of a thread's loads of a slice are issued
//   before any is stored. Each thread owns 4 x 8 outputs, rows ty + i*RT
//   and columns tx + j*CT, so a warp reads shared memory without bank
//   conflicts and writes y coalesced.
//
// C interface (bound with ctypes):
//   int grouped_matmul_launch(const void* x, const void* w, void* y,
//                             long long m, long long g, long long k,
//                             long long n, int dtype, void* stream);
// dtype 0 = fp32, 1 = bf16. Returns cudaGetLastError() after the launch
// (or cudaErrorInvalidValue for arguments the kernel does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// The streaming path for M <= kSkinnyM: each lane owns 4 contiguous
// columns of one group, the block's kSkinnyWarps warps split K, and
// their partial sums meet in shared memory in a fixed order.
constexpr int kSkinnyM = 8;
constexpr int kSkinnyWarps = 8;
constexpr int kSkinnyCols = 32 * 4;      // columns a block owns
constexpr int kSkinnyRows = 4;           // rows of w a lane has in flight
constexpr int kSkinnyK = 256;            // rows of x staged at a time

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
struct Vec4;   // 4 contiguous elements: 16 bytes of fp32, 8 of bf16
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
};

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
  const typename Vec4<T>::type raw =
      *reinterpret_cast<const typename Vec4<T>::type*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = to_f32(e[j]);
}

// y[m, g*N + n] for M <= MR (4 or 8), N % 4 == 0 and w aligned for
// Vec4 loads: every byte of w is read once, by one lane, straight into
// registers, kSkinnyRows rows at a time; the group's x panel is staged
// in shared memory as fp32, kSkinnyK rows of K at a time, and read as
// float4 broadcasts.
template <typename T, int MR>
__global__ void __launch_bounds__(32 * kSkinnyWarps, 3)
    grouped_matmul_skinny_kernel(const T* __restrict__ x,
                                 const T* __restrict__ w,
                                 T* __restrict__ y, int64_t m,
                                 int64_t groups, int64_t k, int64_t n) {
  static_assert(MR % 4 == 0 && MR <= kSkinnyM, "rows");
  __shared__ __align__(16) float xs[kSkinnyK][MR];
  __shared__ __align__(16) float part[kSkinnyWarps][MR][kSkinnyCols];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int64_t g = blockIdx.y;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kSkinnyCols;
  const int64_t c0 = n0 + lane * 4;
  const int64_t x_row = groups * k;
  const T* xg = x + g * k;
  const T* wg = w + g * k * n;

  float acc[MR][4];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int64_t kc = 0; kc < k; kc += kSkinnyK) {
    const int kn = static_cast<int>(k - kc < kSkinnyK ? k - kc : kSkinnyK);
    __syncthreads();                       // the last chunk's readers
    for (int e = threadIdx.x; e < kn * MR; e += 32 * kSkinnyWarps) {
      const int kk = e / MR;
      const int i = e % MR;
      xs[kk][i] = i < m ? to_f32(xg[i * x_row + kc + kk]) : 0.f;
    }
    __syncthreads();
    if (c0 >= n) continue;  // n % 4 == 0: 4 columns all inside or out
    const T* wc = wg + kc * n + c0;
    // the warp's rows r = warp + q*kSkinnyWarps of the chunk,
    // kSkinnyRows at a time, all loads issued before the first is used
    for (int r0 = warp; r0 < kn; r0 += kSkinnyWarps * kSkinnyRows) {
      float wv[kSkinnyRows][4];
#pragma unroll
      for (int u = 0; u < kSkinnyRows; ++u) {
        const int r = r0 + u * kSkinnyWarps;
        if (r < kn) {
          load4(wc + static_cast<int64_t>(r) * n, wv[u]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kSkinnyRows; ++u) {
        const int r = r0 + u * kSkinnyWarps;
        if (r >= kn) break;
#pragma unroll
        for (int i4 = 0; i4 < MR; i4 += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(&xs[r][i4]);
          const float xi[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i4 + i][j] = fmaf(xi[i], wv[u][j], acc[i4 + i][j]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    *reinterpret_cast<float4*>(&part[warp][i][lane * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  __syncthreads();
  const int64_t y_row = groups * n;
  for (int o = threadIdx.x; o < MR * kSkinnyCols; o += 32 * kSkinnyWarps) {
    const int i = o / kSkinnyCols;
    const int c = o % kSkinnyCols;
    if (i >= m || n0 + c >= n) continue;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kSkinnyWarps; ++q) s += part[q][i][c];
    y[i * y_row + g * n + n0 + c] = from_f32<T>(s);
  }
}

template <typename T>
bool skinny_fits(const T* w, int64_t m, int64_t n) {
  return m <= kSkinnyM && n % 4 == 0 &&
         reinterpret_cast<uintptr_t>(w) % sizeof(typename Vec4<T>::type) ==
             0;
}

template <typename T, typename C>
int launch_tile(const T* x, const T* w, T* y, int64_t m, int64_t g,
                int64_t k, int64_t n, cudaStream_t stream) {
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

template <typename T>
int launch(const void* x, const void* w, void* y, int64_t m, int64_t g,
           int64_t k, int64_t n, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  if (skinny_fits(wp, m, n)) {
    const int64_t n_tiles = (n + kSkinnyCols - 1) / kSkinnyCols;
    if (n_tiles > 0x7fffffff || g > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(g));
    if (m <= 4) {
      grouped_matmul_skinny_kernel<T, 4>
          <<<grid, 32 * kSkinnyWarps, 0, stream>>>(xp, wp, yp, m, g, k, n);
    } else {
      grouped_matmul_skinny_kernel<T, kSkinnyM>
          <<<grid, 32 * kSkinnyWarps, 0, stream>>>(xp, wp, yp, m, g, k, n);
    }
    return static_cast<int>(cudaGetLastError());
  }
  return launch_tile<T, LargeM>(xp, wp, yp, m, g, k, n, stream);
}

}  // namespace

extern "C" int grouped_matmul_launch(const void* x, const void* w, void* y,
                                     long long m, long long g, long long k,
                                     long long n, int dtype, void* stream) {
  if (m <= 0 || g <= 0 || k <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, y, m, g, k, n, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, y, m, g, k, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
