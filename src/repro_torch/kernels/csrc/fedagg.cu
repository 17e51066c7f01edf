// fedagg: weighted fold of S stacked model replicas, for sm_90a.
//
//   out[p] = sum_s w[s] * x[s, p]     x: (S, P) f32 or bf16, row-major
//                                     w: (S,) f32; out: (P,) x's dtype
//
// Replaces the Pallas TPU kernel `fedagg` (src/repro/kernels/fedagg.py:30,
// pallas_call at :43, body `_fedagg_kernel` at :23), whose oracle is
// `fedagg_ref` (src/repro/kernels/ref.py:12).
//
// Bound: memory. Each x element is read once and used for one multiply-add
// (2 FLOP per 4 bytes in f32, about 0.5 FLOP/byte against the card's ~20
// FLOP/byte f32 balance point), so the least time is the bytes moved over
// the HBM rate: at the simulator's shapes (S=40, the paper CNN's 1,663,370
// params) one fold moves ~272.8 MB, ~81 us at 3.35 TB/s.
//
// Design against that bound: a 1-D grid over P. Each thread owns one
// output element, or a 16-byte vector of them (4 f32 / 8 bf16) when the
// rows are 16-byte aligned, and walks the S rows itself, so neighbouring
// threads read neighbouring addresses of every row (coalesced, one pass
// over x) and the output is written once. The weights are staged once per
// block in shared memory. The sum is kept in f32 and rounded to x's dtype
// at the single store. The TPU kernel's P-padding to whole tiles becomes a
// bounds check (ragged tail / unaligned views take the scalar path).
//
// Rows with zero weight are NOT skipped: 0 * x is added like any other
// term, as the reference does; padding rows (zero weight, zero data)
// therefore contribute exactly zero.
//
// Plain C interface for ctypes (no PyTorch headers): every entry point
// launches on the caller's stream, never synchronises, allocates nothing,
// and returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for S outside [1, 12288] or P < 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = int64_t(1) << 20;  // grid-stride beyond this
constexpr int kMaxRows = 12288;                   // S floats in 48 KB smem

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void stage_weights(const float* __restrict__ w,
                                              float* sw, int S) {
  for (int s = threadIdx.x; s < S; s += blockDim.x) sw[s] = w[s];
  __syncthreads();
}

// One output element per thread: any P, any alignment.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fedagg_scalar(const T* __restrict__ x, const float* __restrict__ w,
              T* __restrict__ out, int S, int64_t P) {
  extern __shared__ float sw[];
  stage_weights(w, sw, S);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t p = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; p < P;
       p += stride) {
    const T* col = x + p;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc = fmaf(sw[s], to_f32(col[s * P]), acc);
    store(out + p, acc);
  }
}

// Four f32 outputs per thread with 16-byte loads and stores.
// Needs P % 4 == 0 and 16-byte aligned x and out.
__global__ void __launch_bounds__(kThreads)
fedagg_vec_f32(const float4* __restrict__ x, const float* __restrict__ w,
               float4* __restrict__ out, int S, int64_t P4) {
  extern __shared__ float sw[];
  stage_weights(w, sw, S);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t v = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; v < P4;
       v += stride) {
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
// Needs P % 8 == 0 and 16-byte aligned x and out.
__global__ void __launch_bounds__(kThreads)
fedagg_vec_bf16(const uint4* __restrict__ x, const float* __restrict__ w,
                uint4* __restrict__ out, int S, int64_t P8) {
  extern __shared__ float sw[];
  stage_weights(w, sw, S);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t v = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; v < P8;
       v += stride) {
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

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return int(b < kMaxBlocks ? b : kMaxBlocks);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(const T* x, const float* w, T* out, int S, int64_t P,
           cudaStream_t stream, int vec, void (*vec_kernel_launch)(
               const T*, const float*, T*, int, int64_t, cudaStream_t,
               size_t)) {
  if (S < 1 || S > kMaxRows || P < 1) return int(cudaErrorInvalidValue);
  const size_t smem = size_t(S) * sizeof(float);
  if (P % vec == 0 && aligned16(x) && aligned16(out)) {
    vec_kernel_launch(x, w, out, S, P / vec, stream, smem);
  } else {
    fedagg_scalar<T><<<blocks_for(P), kThreads, smem, stream>>>(x, w, out,
                                                                 S, P);
  }
  return int(cudaGetLastError());
}

void launch_vec_f32(const float* x, const float* w, float* out, int S,
                    int64_t P4, cudaStream_t stream, size_t smem) {
  fedagg_vec_f32<<<blocks_for(P4), kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(x), w, reinterpret_cast<float4*>(out),
      S, P4);
}

void launch_vec_bf16(const __nv_bfloat16* x, const float* w,
                     __nv_bfloat16* out, int S, int64_t P8,
                     cudaStream_t stream, size_t smem) {
  fedagg_vec_bf16<<<blocks_for(P8), kThreads, smem, stream>>>(
      reinterpret_cast<const uint4*>(x), w, reinterpret_cast<uint4*>(out), S,
      P8);
}

}  // namespace

extern "C" {

int fedagg_f32(const void* x, const void* w, void* out, int S, int64_t P,
               void* stream) {
  return launch<float>(static_cast<const float*>(x),
                       static_cast<const float*>(w),
                       static_cast<float*>(out), S, P,
                       static_cast<cudaStream_t>(stream), 4, launch_vec_f32);
}

int fedagg_bf16(const void* x, const void* w, void* out, int S, int64_t P,
                void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                               static_cast<const float*>(w),
                               static_cast<__nv_bfloat16*>(out), S, P,
                               static_cast<cudaStream_t>(stream), 8,
                               launch_vec_bf16);
}

}  // extern "C"
