// Per-neuron activation x gradient reduction for Hopper (sm_90a), many
// instances in one launch.
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
// 256 x 512, one call per (B, I) pair.
//
// One pair per launch was launch-bound on this card: Eq. 9 reduces one
// (64, I_l) pair per class per tapped layer (80 on the auto-depth path,
// I_l <= 512), and each launch made 1 to 4 blocks for 132 SMs, so a call
// cost the launch latency plus one trip to memory (3.5 us against a
// 0.08 us bound at (64, 512)). Here one launch takes a table of up to
// kMaxSegments segments. A segment is S instances of one (B, I) shape,
// stored as a contiguous (S, B, I) tensor each for a and g, with an
// (I, S) fp32 output of any strides (Eq. 9 writes straight into its
// (I_l, C) preference tensor). The host lays the table out with each
// segment's first block, a prefix sum over the segments' S * tiles
// blocks, and passes it by value as a __grid_constant__ parameter: a
// block finds its segment by a binary search over the table, with no
// device-side table and no copy to the card. The auto-depth table (8
// segments of 10 instances, 1,888 columns each) is one launch of 300
// blocks.
//
// A block takes one (segment, instance, column tile). The tile is 256
// bytes of a row (64 fp32 or 128 bf16 columns), so the auto-depth table
// gives more than two blocks per SM: kColThreads threads across the tile,
// each owning V contiguous columns (16-byte loads when I * esize and the
// pointers allow; else the same columns with scalar loads and the tail
// masked), and kRowThreads row slices that each walk their rows in
// registers with fp32 FMAs. The row slices' partial rows are summed in
// shared memory in a fixed order: no atomics, so a result is the same
// bit for bit from run to run.
//
// Long columns (a single pair whose column tiles cannot fill the card)
// are also split over rows, into about four blocks per SM (at (8192,
// 4096) fp32, 9 splits of 64 tiles: fewer or more splits were slower):
// feature_stats_launch views the (B, I) matrix as `full` instances of rps
// rows plus one of the remaining rows, both segments of one table launch
// writing partial rows into a (splits, I) fp32 workspace, and a second
// pass sums them in order.
//
// C interface (bound with ctypes):
//   int feature_stats_table_capacity(void);
//   int feature_stats_many_launch(const long long* seg, int n, int dtype,
//                                 void* stream);
//     seg holds n rows of kSegFields values: a, g, out (pointers), S, B,
//     I, and out's strides (in floats) along I and along S
//   int feature_stats_splits(long long b, long long i, int dtype);
//   int feature_stats_launch(const void* a, const void* g, float* out,
//                            float* ws, long long b, long long i,
//                            int splits, int dtype, void* stream);
// dtype 0 = fp32, 1 = bf16. `ws` holds splits * i floats when splits > 1
// (else it is not read). The launches return cudaGetLastError() after
// the launch (or cudaErrorInvalidValue for arguments the kernel does not
// take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxSegments = 32;
constexpr int kSegFields = 8;
constexpr int kColThreads = 16;      // 16 threads x 16 bytes: one tile row
constexpr int kRowThreads = 16;      // row slices per block
constexpr int kThreads = kColThreads * kRowThreads;
constexpr int kTargetBlocks = 528;   // four per SM of an H100 SXM (132)
constexpr int64_t kMinRowsPerSplit = 64;
constexpr int kSumThreads = 256;

struct Segment {
  const void* a;
  const void* g;
  float* out;
  int64_t out_stride_i;   // in floats
  int64_t out_stride_s;
  int64_t s, b, i;
  int tiles;              // column tiles per instance
  int vec;                // 16-byte loads
};

// The segments' first blocks (prefix sums of s * tiles) sit together at
// the head of the table: a block's search reads a few adjacent words of
// the constant bank, then one segment.
struct Table {
  int first_block[kMaxSegments];
  int n;
  Segment seg[kMaxSegments];
};

// 32 segments stay inside the classic 4 KB kernel parameter space
static_assert(sizeof(Table) <= 4096, "segment table too large");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__host__ __device__ constexpr int vec_width() {
  return static_cast<int>(16 / sizeof(T));
}

template <typename T>
__host__ __device__ constexpr int tile_cols() {
  return kColThreads * vec_width<T>();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    feature_stats_kernel(const __grid_constant__ Table tab) {
  constexpr int V = vec_width<T>();
  constexpr int kTile = tile_cols<T>();
  __shared__ float part[kRowThreads][kTile];

  // the last segment whose first block is at or below this block
  const int bid = static_cast<int>(blockIdx.x);
  int lo = 0;
  int hi = tab.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tab.first_block[mid] <= bid) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Segment& sg = tab.seg[lo];
  const int local = bid - tab.first_block[lo];
  const int64_t inst = local / sg.tiles;
  const int64_t col0 = static_cast<int64_t>(local % sg.tiles) * kTile;
  const int64_t b = sg.b;
  const int64_t i = sg.i;
  const T* __restrict__ a = static_cast<const T*>(sg.a) + inst * b * i;
  const T* __restrict__ g = static_cast<const T*>(sg.g) + inst * b * i;
  const int tx = threadIdx.x % kColThreads;
  const int ty = threadIdx.x / kColThreads;

  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  if (sg.vec) {
    // thread tx owns columns col0 + tx*V .. + V-1 (I is a multiple of V)
    const int64_t c0 = col0 + static_cast<int64_t>(tx) * V;
    if (c0 < i) {
#pragma unroll 4
      for (int64_t r = ty; r < b; r += kRowThreads) {
        const uint4 ra = *reinterpret_cast<const uint4*>(a + r * i + c0);
        const uint4 rg = *reinterpret_cast<const uint4*>(g + r * i + c0);
        const T* ea = reinterpret_cast<const T*>(&ra);
        const T* eg = reinterpret_cast<const T*>(&rg);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          acc[j] = fmaf(to_f32(ea[j]), to_f32(eg[j]), acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) part[ty][tx * V + j] = acc[j];
  } else {
    // thread tx owns columns col0 + tx + j*kColThreads: each scalar load
    // of the 16 threads reads 16 adjacent values
#pragma unroll 2
    for (int64_t r = ty; r < b; r += kRowThreads) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int64_t c = col0 + tx + j * kColThreads;
        if (c < i) {
          acc[j] = fmaf(to_f32(a[r * i + c]), to_f32(g[r * i + c]), acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) part[ty][tx + j * kColThreads] = acc[j];
  }
  __syncthreads();

  // sum the row slices in a fixed order, one column per thread
  for (int col = threadIdx.x; col < kTile; col += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kRowThreads; ++k) s += part[k][col];
    if (col0 + col < i) {
      sg.out[(col0 + col) * sg.out_stride_i + inst * sg.out_stride_s] = s;
    }
  }
}

__global__ void sum_splits_kernel(const float* __restrict__ ws,
                                  float* __restrict__ out, int64_t i,
                                  int rows) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (c >= i) return;
  float s = 0.f;
  for (int k = 0; k < rows; ++k) s += ws[k * i + c];
  out[c] = s;
}

// Fills tab.first_block and the segments' tiles and vec, and launches.
template <typename T>
int launch_table(Table& tab, cudaStream_t stream) {
  constexpr int V = vec_width<T>();
  int64_t blocks = 0;
  for (int k = 0; k < tab.n; ++k) {
    Segment& sg = tab.seg[k];
    const uintptr_t aa = reinterpret_cast<uintptr_t>(sg.a);
    const uintptr_t ga = reinterpret_cast<uintptr_t>(sg.g);
    sg.tiles = static_cast<int>((sg.i + tile_cols<T>() - 1) / tile_cols<T>());
    sg.vec = (sg.i % V == 0) && (aa % 16 == 0) && (ga % 16 == 0);
    tab.first_block[k] = static_cast<int>(blocks);
    blocks += sg.s * sg.tiles;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  feature_stats_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(tab);
  return static_cast<int>(cudaGetLastError());
}

int launch_table(Table& tab, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch_table<float>(tab, stream);
  if (dtype == 1) return launch_table<__nv_bfloat16>(tab, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int esize(int dtype) { return dtype == 1 ? 2 : 4; }

// Row splits of a single pair: enough blocks to fill the card, each split
// at least kMinRowsPerSplit rows long.
int splits_for(int64_t b, int64_t i, int tile) {
  const int64_t tiles = (i + tile - 1) / tile;
  int64_t want = (kTargetBlocks + tiles - 1) / tiles;
  const int64_t most = (b + kMinRowsPerSplit - 1) / kMinRowsPerSplit;
  if (want > most) want = most;
  if (want < 1) want = 1;
  return static_cast<int>(want);
}

}  // namespace

extern "C" int feature_stats_table_capacity(void) { return kMaxSegments; }

extern "C" int feature_stats_many_launch(const long long* seg, int n,
                                         int dtype, void* stream) {
  if (seg == nullptr || n < 1 || n > kMaxSegments ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table tab = {};
  tab.n = n;
  for (int k = 0; k < n; ++k) {
    const long long* f = seg + static_cast<int64_t>(k) * kSegFields;
    Segment& sg = tab.seg[k];
    sg.a = reinterpret_cast<const void*>(static_cast<uintptr_t>(f[0]));
    sg.g = reinterpret_cast<const void*>(static_cast<uintptr_t>(f[1]));
    sg.out = reinterpret_cast<float*>(static_cast<uintptr_t>(f[2]));
    sg.s = f[3];
    sg.b = f[4];
    sg.i = f[5];
    sg.out_stride_i = f[6];
    sg.out_stride_s = f[7];
    if (sg.a == nullptr || sg.g == nullptr || sg.out == nullptr ||
        sg.s < 1 || sg.b < 1 || sg.i < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return launch_table(tab, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int feature_stats_splits(long long b, long long i, int dtype) {
  if (b <= 0 || i <= 0) return 1;
  if (dtype == 0) return splits_for(b, i, tile_cols<float>());
  if (dtype == 1) return splits_for(b, i, tile_cols<__nv_bfloat16>());
  return 1;
}

extern "C" int feature_stats_launch(const void* a, const void* g,
                                    float* out, float* ws, long long b,
                                    long long i, int splits, int dtype,
                                    void* stream) {
  if (b <= 0 || i <= 0 || splits < 1 || splits > 65535 ||
      (splits > 1 && ws == nullptr) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Table tab = {};
  if (splits == 1) {
    tab.n = 1;
    tab.seg[0] = Segment{a, g, out, 1, 0, 1, b, i};
    return launch_table(tab, dtype, s);
  }
  // `full` instances of rps rows, then one of the rest, into ws rows
  const int64_t rps = (b + splits - 1) / splits;
  const int64_t full = b / rps;
  const int64_t rest = b - full * rps;
  const int64_t skip = full * rps * i * esize(dtype);
  tab.n = rest > 0 ? 2 : 1;
  tab.seg[0] = Segment{a, g, ws, 1, i, full, rps, i};
  if (rest > 0) {
    tab.seg[1] = Segment{static_cast<const char*>(a) + skip,
                         static_cast<const char*>(g) + skip, ws + full * i,
                         1, i, 1, rest, i};
  }
  int err = launch_table(tab, dtype, s);
  if (err != 0) return err;
  const int rows = static_cast<int>(full + (rest > 0 ? 1 : 0));
  const unsigned sblocks =
      static_cast<unsigned>((i + kSumThreads - 1) / kSumThreads);
  sum_splits_kernel<<<sblocks, kSumThreads, 0, s>>>(ws, out, i, rows);
  return static_cast<int>(cudaGetLastError());
}
