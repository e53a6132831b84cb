// Fused N-way weighted mean of stacked client rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel `paired_fusion_kernel` of
// src/repro/kernels/paired_fusion.py (its pl.pallas_call). Contract:
// x is an (N, M) matrix of fp32 or bf16 rows with row stride `ld`
// elements and unit column stride; w holds N fp32 weights that already
// sum to one; out[c] = sum_i w[i] * x[i, c], accumulated in fp32 and
// stored in x's dtype.
//
// Bound on the H100: bytes. The kernel reads N*M values once and writes
// M, against 2*N*M flops, so the 3.35 TB/s of device memory is the
// limit by two orders of magnitude. The TPU kernel walks N as a
// sequential grid axis into a VMEM accumulator row; here each thread
// owns a few contiguous columns and loops over the N rows in registers,
// with no cross-block reduction. Loads are 16-byte vectors where the
// row stride and the pointers allow it, with a scalar head up to the
// first aligned column and a scalar tail for any M, so the caller never
// pads. The N weights are staged in shared memory once per block.
//
// C interface (bound with ctypes):
//   int paired_fusion_launch(const void* x, long long ld, const float* w,
//                            void* out, int n, long long m, int dtype,
//                            void* stream);
// dtype 0 = fp32, 1 = bf16. Returns cudaGetLastError() after the launch
// (or cudaErrorInvalidValue for arguments the kernel does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 12288;  // N fp32 weights in 48 KB of shared memory

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T>
__device__ __forceinline__ void fuse_column(const T* __restrict__ x,
                                            int64_t ld,
                                            const float* __restrict__ sw,
                                            T* __restrict__ out, int n,
                                            int64_t c) {
  float acc = 0.f;
  for (int i = 0; i < n; ++i) {
    acc = fmaf(sw[i], load_f32(x + i * ld + c), acc);
  }
  store(out + c, acc);
}

// vec != 0: columns [0, head) are scalar, then thread t owns the V
// columns starting at head + t*V (16-byte loads; the last chunk may be
// partial and falls back to scalar). vec == 0: one column per thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paired_fusion_kernel(const T* __restrict__ x, int64_t ld,
                         const float* __restrict__ w, T* __restrict__ out,
                         int n, int64_t m, int64_t head, int vec) {
  extern __shared__ float sw[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) sw[i] = w[i];
  __syncthreads();

  constexpr int V = 16 / sizeof(T);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (!vec) {
    if (t < m) fuse_column(x, ld, sw, out, n, t);
    return;
  }
  if (t < head) fuse_column(x, ld, sw, out, n, t);
  const int64_t c0 = head + t * V;
  if (c0 + V <= m) {
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + i * ld + c0);
      const T* e = reinterpret_cast<const T*>(&raw);
      const float wi = sw[i];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(wi, to_f32(e[j]), acc[j]);
    }
    uint4 packed;
    T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int j = 0; j < V; ++j) store(o + j, acc[j]);
    *reinterpret_cast<uint4*>(out + c0) = packed;
  } else {
    for (int64_t c = c0; c < m; ++c) fuse_column(x, ld, sw, out, n, c);
  }
}

template <typename T>
int launch(const void* x, long long ld, const float* w, void* out, int n,
           long long m, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  // every row shares row 0's alignment phase iff ld is a multiple of V;
  // out shares it iff the two pointers agree modulo 16 bytes
  const int vec = (ld % V == 0) && (xa % 16 == oa % 16) &&
                  (xa % sizeof(T) == 0);
  int64_t head = 0;
  int64_t threads = m;
  if (vec) {
    head = static_cast<int64_t>((16 - xa % 16) % 16) / sizeof(T);
    if (head > m) head = m;
    const int64_t chunks = (m - head + V - 1) / V;
    threads = chunks > head ? chunks : head;
  }
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  paired_fusion_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                            stream>>>(
      static_cast<const T*>(x), ld, w, static_cast<T*>(out), n, m, head,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paired_fusion_launch(const void* x, long long ld,
                                    const float* w, void* out, int n,
                                    long long m, int dtype, void* stream) {
  if (n == 1) ld = 0;  // a single row: its stride is never read
  if (n <= 0 || n > kMaxRows || m <= 0 || (n > 1 && ld < m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, ld, w, out, n, m, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, ld, w, out, n, m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
