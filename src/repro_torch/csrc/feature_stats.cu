// Per-neuron activation x gradient reduction for Hopper (sm_90a).
//
// Replaces the TPU kernel `feature_stats_kernel` of
// src/repro/kernels/feature_stats.py (its pl.pallas_call), the hot loop
// of the class preference vectors (Eq. 9): for a and g, two (B, I)
// row-major matrices of fp32 or bf16,
//     out[i] = sum_b a[b, i] * g[b, i]      (fp32 accumulation, fp32 out)
//
// Bound on the H100: bytes. The kernel reads 2*B*I values once and
// writes I floats, against 2*B*I flops, so the 3.35 TB/s of device memory
// is the limit by two orders of magnitude. The TPU kernel walks B as a
// sequential grid axis into a VMEM accumulator row, on tiles padded to
// 256 x 512. Here nothing is padded: a block is one warp wide across the
// columns and kRowThreads deep across the rows. Each thread owns V
// contiguous columns (4 fp32 or 8 bf16, one 16-byte load per row and
// input, when I is a multiple of V and the pointers are 16-byte aligned;
// else one column and scalar loads) and walks its share of the rows in
// registers with fp32 FMAs, so the 32 threads of a warp read 512
// contiguous bytes of each row. The block's kRowThreads partial rows are
// summed in shared memory in a fixed order. When the column blocks alone
// cannot fill the card (few, long columns), the rows are also split over
// `splits` blocks; each writes its partial row into a (splits, I) fp32
// workspace and a second pass sums them in order, so the result does not
// depend on scheduling. At the Eq. 9 path's shapes (B = 64, I <= 512) one
// block row suffices and the call is one launch, bound by launch latency.
//
// C interface (bound with ctypes):
//   int feature_stats_splits(long long b, long long i, int dtype);
//   int feature_stats_launch(const void* a, const void* g, float* out,
//                            float* ws, long long b, long long i,
//                            int splits, int dtype, void* stream);
// dtype 0 = fp32, 1 = bf16. `ws` holds splits * i floats when splits > 1
// (else it is not read). Returns cudaGetLastError() after the launches
// (or cudaErrorInvalidValue for arguments the kernel does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kColThreads = 32;      // one warp across the columns
constexpr int kRowThreads = 8;       // row slices per block
constexpr int kTargetBlocks = 264;   // two per SM of an H100 SXM (132)
constexpr int64_t kMinRowsPerSplit = 64;
constexpr int kSumThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V columns per thread; V * sizeof(T) == 16 takes 16-byte vector loads,
// V == 1 scalar loads with the column tail masked.
template <typename T, int V>
__global__ void __launch_bounds__(kColThreads * kRowThreads)
    feature_stats_kernel(const T* __restrict__ a, const T* __restrict__ g,
                         float* __restrict__ out, int64_t b, int64_t i,
                         int64_t rows_per_split) {
  __shared__ float part[kRowThreads][kColThreads * V];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kColThreads * V;
  const int64_t c0 = col0 + static_cast<int64_t>(tx) * V;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.y) * rows_per_split;
  const int64_t r_end =
      r_begin + rows_per_split < b ? r_begin + rows_per_split : b;

  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  if (c0 < i) {
    if constexpr (V * sizeof(T) == 16) {
#pragma unroll 4
      for (int64_t r = r_begin + ty; r < r_end; r += kRowThreads) {
        const uint4 ra = *reinterpret_cast<const uint4*>(a + r * i + c0);
        const uint4 rg = *reinterpret_cast<const uint4*>(g + r * i + c0);
        const T* ea = reinterpret_cast<const T*>(&ra);
        const T* eg = reinterpret_cast<const T*>(&rg);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          acc[j] = fmaf(to_f32(ea[j]), to_f32(eg[j]), acc[j]);
        }
      }
    } else {
#pragma unroll 4
      for (int64_t r = r_begin + ty; r < r_end; r += kRowThreads) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (c0 + j < i) {
            acc[j] = fmaf(to_f32(a[r * i + c0 + j]),
                          to_f32(g[r * i + c0 + j]), acc[j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) part[ty][tx * V + j] = acc[j];
  __syncthreads();

  // sum the row slices in a fixed order; the block's kColThreads * V
  // columns are spread over all of its threads
  float* dst = out + static_cast<int64_t>(blockIdx.y) * i;
  for (int col = ty * kColThreads + tx; col < kColThreads * V;
       col += kColThreads * kRowThreads) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kRowThreads; ++k) s += part[k][col];
    if (col0 + col < i) dst[col0 + col] = s;
  }
}

__global__ void sum_splits_kernel(const float* __restrict__ ws,
                                  float* __restrict__ out, int64_t i,
                                  int splits) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (c >= i) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += ws[k * i + c];
  out[c] = s;
}

template <typename T>
constexpr int vec_width() {
  return static_cast<int>(16 / sizeof(T));
}

int64_t col_blocks(int64_t i, int v) {
  return (i + static_cast<int64_t>(kColThreads) * v - 1) /
         (static_cast<int64_t>(kColThreads) * v);
}

// Row splits: enough blocks to fill the card, each split at least
// kMinRowsPerSplit rows long.
int splits_for(int64_t b, int64_t i, int v) {
  const int64_t cb = col_blocks(i, v);
  int64_t want = (kTargetBlocks + cb - 1) / cb;
  const int64_t most = (b + kMinRowsPerSplit - 1) / kMinRowsPerSplit;
  if (want > most) want = most;
  if (want < 1) want = 1;
  return static_cast<int>(want);
}

template <typename T>
int launch(const void* a, const void* g, float* out, float* ws, int64_t b,
           int64_t i, int splits, cudaStream_t stream) {
  constexpr int V = vec_width<T>();
  const uintptr_t aa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t ga = reinterpret_cast<uintptr_t>(g);
  const bool vec = (i % V == 0) && (aa % 16 == 0) && (ga % 16 == 0);
  const int64_t rows_per_split = (b + splits - 1) / splits;
  float* dst = splits > 1 ? ws : out;
  const dim3 block(kColThreads, kRowThreads);
  if (vec) {
    const dim3 grid(static_cast<unsigned>(col_blocks(i, V)),
                    static_cast<unsigned>(splits));
    feature_stats_kernel<T, V><<<grid, block, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(g), dst, b, i,
        rows_per_split);
  } else {
    const dim3 grid(static_cast<unsigned>(col_blocks(i, 1)),
                    static_cast<unsigned>(splits));
    feature_stats_kernel<T, 1><<<grid, block, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(g), dst, b, i,
        rows_per_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const unsigned sblocks =
      static_cast<unsigned>((i + kSumThreads - 1) / kSumThreads);
  sum_splits_kernel<<<sblocks, kSumThreads, 0, stream>>>(ws, out, i,
                                                         splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int feature_stats_splits(long long b, long long i, int dtype) {
  if (b <= 0 || i <= 0) return 1;
  if (dtype == 0) return splits_for(b, i, vec_width<float>());
  if (dtype == 1) return splits_for(b, i, vec_width<__nv_bfloat16>());
  return 1;
}

extern "C" int feature_stats_launch(const void* a, const void* g,
                                    float* out, float* ws, long long b,
                                    long long i, int splits, int dtype,
                                    void* stream) {
  if (b <= 0 || i <= 0 || splits < 1 || splits > 65535 ||
      (splits > 1 && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, g, out, ws, b, i, splits, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(a, g, out, ws, b, i, splits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
