// fedagg: weighted fold of S stacked model replicas, for sm_90a.
//
//   out[p] = sum_s w[s] * x[s, p]     x: (S, P) f32 or bf16, row-major
//                                     w: (S,) f32; out: (P,) x's dtype
//
// for every leaf of a parameter tree at once: one launch folds up to
// kMaxLeaves leaves, each its own (S, P_i) buffer (no concatenation).
//
// Replaces the Pallas TPU kernel `fedagg` (src/repro/kernels/fedagg.py:30,
// pallas_call at :43, body `_fedagg_kernel` at :23), whose oracle is
// `fedagg_ref` (src/repro/kernels/ref.py:12). The TPU version folds the
// whole tree in one call over a concatenated buffer
// (src/repro/kernels/ops.py:33-40); here the leaf table takes the place of
// the concatenation, so the stack is read once and never copied.
//
// Bound: memory. Each x element is read once and used for one multiply-add
// (2 FLOP per 4 bytes in f32, about 0.5 FLOP/byte against the card's ~20
// FLOP/byte f32 balance point), so the least time is the bytes moved over
// the HBM rate: at the simulator's shapes (S=40, the paper CNN's 1,663,370
// params in 8 leaves) one fold moves ~272.8 MB, ~81 us at 3.35 TB/s. With
// one launch per leaf the seven small leaves were launch-bound; one launch
// per fold leaves the one large leaf (fc1_w) to set the time.
//
// Design against that bound:
// - Leaf table. A table of up to kMaxLeaves entries (x, out, P, whether
//   the leaf takes the 16-byte vector path, its first block) is a kernel
//   parameter passed by value (__grid_constant__, 1.3 KB of the 4 KB
//   parameter space). The caller (fedagg.py's `plan_launches`) gives
//   each leaf's pointers, P and vector flag; the launcher here checks the
//   flag and lays out the blocks. Each block finds its leaf by a scan of
//   the first blocks (uniform across the block).
// - Within a leaf: a 1-D grid over P. Each thread owns one output
//   element, or a 16-byte vector of them (4 f32 / 8 bf16) when P allows
//   it and x and out are 16-byte aligned, and walks the S rows itself, so
//   neighbouring threads read neighbouring addresses of every row
//   (coalesced, one pass over x) and the output is written once. The
//   weights are staged once per block in shared memory. The sum is kept
//   in f32, s = 0 .. S-1 in order, and rounded to x's dtype at the single
//   store: the same arithmetic, element for element, as the per-leaf
//   kernels it replaces. Ragged tails and unaligned views take the scalar
//   path.
//
// Rows with zero weight are NOT skipped: 0 * x is added like any other
// term, as the reference does; padding rows (zero weight, zero data)
// therefore contribute exactly zero.
//
// Plain C interface for ctypes (no PyTorch headers): the entry points
// launch on the caller's stream, never synchronise, allocate nothing, and
// return the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for S outside [1, 12288], a leaf count outside
// [1, kMaxLeaves], P < 1, or a vector flag the leaf's shape or alignment
// does not allow).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = int64_t(1) << 20;  // per leaf; grid-stride
constexpr int kMaxRows = 12288;                   // S floats in 48 KB smem
constexpr int kMaxLeaves = 32;                    // leaves per launch

// One leaf of a launch (the layout of `_Leaf` in fedagg.py).
struct Leaf {
  const void* x;
  void* out;
  int64_t P;
  int32_t vec;  // 1: 16 bytes per thread (P and alignment allow it)
  int32_t pad;
};
static_assert(sizeof(Leaf) == 32, "Leaf must match fedagg.py's _Leaf");

// The kernel's parameter: the leaves and the first block of each.
struct Table {
  Leaf leaf[kMaxLeaves];
  int64_t first_block[kMaxLeaves];
  int n;
};
static_assert(sizeof(Table) < 4096, "the table must fit the param space");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One output element per thread: any P, any alignment.
template <typename T>
__device__ __forceinline__ void fold_scalar(const T* __restrict__ x, const float* sw,
                            T* __restrict__ out, int S, int64_t P,
                            int64_t block, int64_t stride) {
  for (int64_t p = block * blockDim.x + threadIdx.x; p < P; p += stride) {
    const T* col = x + p;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc = fmaf(sw[s], to_f32(col[s * P]), acc);
    store(out + p, acc);
  }
}

// Four f32 outputs per thread with 16-byte loads and stores.
__device__ __forceinline__ void fold_vec(const float4* __restrict__ x, const float* sw,
                         float4* __restrict__ out, int S, int64_t P4,
                         int64_t block, int64_t stride) {
  for (int64_t v = block * blockDim.x + threadIdx.x; v < P4; v += stride) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < S; ++s) {
      const float4 xv = x[s * P4 + v];
      const float ws = sw[s];
      acc.x = fmaf(ws, xv.x, acc.x);
      acc.y = fmaf(ws, xv.y, acc.y);
      acc.z = fmaf(ws, xv.z, acc.z);
      acc.w = fmaf(ws, xv.w, acc.w);
    }
    out[v] = acc;
  }
}

// Eight bf16 outputs per thread with 16-byte loads and stores.
__device__ __forceinline__ void fold_vec(const uint4* __restrict__ x, const float* sw,
                         uint4* __restrict__ out, int S, int64_t P8,
                         int64_t block, int64_t stride) {
  for (int64_t v = block * blockDim.x + threadIdx.x; v < P8; v += stride) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < S; ++s) {
      const uint4 raw = x[s * P8 + v];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float ws = sw[s];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        acc[2 * i] = fmaf(ws, f.x, acc[2 * i]);
        acc[2 * i + 1] = fmaf(ws, f.y, acc[2 * i + 1]);
      }
    }
    uint4 packed;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    out[v] = packed;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fedagg_multi(const __grid_constant__ Table tab, const float* __restrict__ w,
             int S) {
  extern __shared__ float sw[];
  int i = 0;
  while (i + 1 < tab.n && int64_t(blockIdx.x) >= tab.first_block[i + 1])
    ++i;
  const int64_t first = tab.first_block[i];
  const int64_t end = i + 1 < tab.n ? tab.first_block[i + 1]
                                    : int64_t(gridDim.x);
  const int64_t P = tab.leaf[i].P;
  const bool vec = tab.leaf[i].vec != 0;
  const T* x = static_cast<const T*>(tab.leaf[i].x);
  T* out = static_cast<T*>(tab.leaf[i].out);
  const int64_t block = int64_t(blockIdx.x) - first;
  const int64_t stride = (end - first) * blockDim.x;

  for (int s = threadIdx.x; s < S; s += blockDim.x) sw[s] = w[s];
  __syncthreads();

  if (vec) {
    using V = typename std::conditional<std::is_same<T, float>::value,
                                        float4, uint4>::type;
    constexpr int kPer = 16 / sizeof(T);
    fold_vec(reinterpret_cast<const V*>(x), sw, reinterpret_cast<V*>(out), S,
             P / kPer, block, stride);
  } else {
    fold_scalar(x, sw, out, S, P, block, stride);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The blocks a leaf takes: one thread per output element (per 16-byte
// vector on the vector path), at most kMaxBlocks (grid-stride beyond).
int64_t leaf_blocks(int64_t P, bool vec, int per) {
  const int64_t units = vec ? P / per : P;
  const int64_t b = (units + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

template <typename T>
int launch(const Leaf* leaves, int n, const float* w, int S,
           cudaStream_t stream) {
  if (S < 1 || S > kMaxRows || n < 1 || n > kMaxLeaves)
    return int(cudaErrorInvalidValue);
  constexpr int kPer = 16 / sizeof(T);
  Table tab;
  tab.n = n;
  int64_t blocks = 0;
  for (int i = 0; i < n; ++i) {
    const Leaf& l = leaves[i];
    const bool vec_ok = l.P % kPer == 0 && aligned16(l.x) && aligned16(l.out);
    if (l.P < 1 || (l.vec && !vec_ok)) return int(cudaErrorInvalidValue);
    tab.leaf[i] = l;
    tab.first_block[i] = blocks;
    blocks += leaf_blocks(l.P, l.vec != 0, kPer);
  }
  const size_t smem = size_t(S) * sizeof(float);
  fedagg_multi<T><<<unsigned(blocks), kThreads, smem, stream>>>(tab, w, S);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// leaves: n entries laid out as `Leaf` above; w: (S,) f32, contiguous.
int fedagg_multi_f32(const void* leaves, int n, const void* w, int S,
                     void* stream) {
  return launch<float>(static_cast<const Leaf*>(leaves), n,
                       static_cast<const float*>(w), S,
                       static_cast<cudaStream_t>(stream));
}

int fedagg_multi_bf16(const void* leaves, int n, const void* w, int S,
                      void* stream) {
  return launch<__nv_bfloat16>(static_cast<const Leaf*>(leaves), n,
                               static_cast<const float*>(w), S,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
