// Fused Mamba-2 SSD single-token state update + readout for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `ssd_update_kernel` of
// src/repro/kernels/ssd_update.py (its pl.pallas_call), the recurrence
// of every layer of every decode step of a Mamba-2 LM. For the state h
// (B, H, P, N) fp32 and x (B, H, P), dt (B, H), a_log (H,), b and c
// (B, N), d_skip (H,):
//     decay  = exp(dt[b,h] * -exp(a_log[h]))
//     h'     = decay * h + dt[b,h] * x[b,h,p] * b[b,n]
//     y[p]   = sum_n h'[p,n] * c[b,n] + d_skip[h] * x[b,h,p]
// in fp32; h' is stored fp32 and y in x's dtype (fp32 or bf16, which b
// and c share). h' may be written over h itself (in place).
//
// Bound on the H100: bytes. The state is read once and written once,
// 2 * B*H*P*N*4 bytes (16.8 MB per layer at B = 4, H = P = 64,
// N = 128: 5.0 us at 3.35 TB/s), against 5 flops per element. The TPU
// kernel takes bh heads per grid step and pads H to a multiple of bh
// (its wrapper, ops.py); here H, P and N are any size and nothing is
// padded. A block owns one (b, h) pair: b[b] and c[b] go to shared
// memory as fp32, decay is computed once, and the block's 8 warps walk
// the P rows, kRows rows per warp at a time. Each lane owns 4
// contiguous columns (one 16-byte load and store per row, when N % 4 == 0
// and h, h' are 16-byte aligned; else one column, scalar), and a warp
// issues the loads of all its kRows rows before it computes, so each
// block keeps its whole tile in flight. y[p] is a warp-shuffle sum over
// the lanes in a fixed order (the same bits on every run), plus
// d_skip * x.
//
// C interface (bound with ctypes):
//   int ssd_update_launch(const float* h, float* h_out, const void* x,
//                         const float* dt, const float* a_log,
//                         const void* b, const void* c,
//                         const float* d_skip, void* y, int batch,
//                         int heads, int p, int n, long long x_stride,
//                         long long b_stride, long long c_stride,
//                         int dtype, void* stream);
// x is (B, H, P) with batch stride x_stride (elements) and (H, P)
// contiguous; b and c are (B, N) with batch strides b_stride and
// c_stride and N contiguous; h, h_out, dt and y are contiguous. dtype
// 0 = fp32, 1 = bf16 (of x, b, c and y). Returns cudaGetLastError()
// after the launch (or cudaErrorInvalidValue for arguments the kernel
// does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;            // rows a warp has in flight
constexpr int kMaxN = 6144;         // b, c in 48 KB of shared memory

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

// W columns per lane per chunk: 4 (16-byte loads) or 1 (scalar).
// h and h_out may alias, so neither is __restrict__.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    ssd_update_kernel(const float* h, float* h_out, const T* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ a_log,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      const float* __restrict__ d_skip, T* __restrict__ y,
                      int heads, int p_dim, int n_dim, int64_t x_stride,
                      int64_t b_stride, int64_t c_stride) {
  extern __shared__ float smem[];
  float* s_b = smem;
  float* s_c = smem + n_dim;
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
           int64_t x_stride, int64_t b_stride, int64_t c_stride,
           cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(
      static_cast<int64_t>(batch) * heads);
  const size_t shared = 2 * static_cast<size_t>(n) * sizeof(float);
  const bool vec = n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(h_out) % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(b);
  const T* cp = static_cast<const T*>(c);
  T* yp = static_cast<T*>(y);
  if (vec) {
    ssd_update_kernel<T, 4><<<blocks, kThreads, shared, stream>>>(
        h, h_out, xp, dt, a_log, bp, cp, d_skip, yp, heads, p, n, x_stride,
        b_stride, c_stride);
  } else {
    ssd_update_kernel<T, 1><<<blocks, kThreads, shared, stream>>>(
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
                                 int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || p <= 0 || n <= 0 || n > kMaxN ||
      static_cast<int64_t>(batch) * heads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(h, h_out, x, dt, a_log, b, c, d_skip, y, batch,
                         heads, p, n, x_stride, b_stride, c_stride, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(h, h_out, x, dt, a_log, b, c, d_skip, y,
                                 batch, heads, p, n, x_stride, b_stride,
                                 c_stride, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
