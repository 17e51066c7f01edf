// selective_scan: the Mamba selective-SSM recurrence (prefill), sm_90a.
//
//   per (b, d), state h[0..N) in f32 from zero, for t = 0 .. S-1:
//     h[n]      <- abar[b,t,d,n] * h[n] + bx[b,t,d,n]
//     y[b,t,d]   = sum_n h[n] * c[b,t,n]
//
//   abar, bx: (B, S, D, N) contiguous; c: (B, S, N) with any (b, s)
//   strides and unit stride on N; y: (B, S, D) contiguous, in bx's dtype.
//   Three dtype combinations: all f32; all bf16; abar f32 with bx, c and y
//   bf16 (the model's path: its abar = exp(dt A) is f32, bx = dt x B is
//   bf16). All arithmetic in f32.
//
// Replaces the Pallas TPU kernel `selective_scan`
// (src/repro/kernels/selective_scan.py:42, pallas_call at :60, body
// `_scan_kernel` at :22), whose oracle is `selective_scan_ref`
// (src/repro/kernels/ref.py:40). The TPU kernel returns abar's dtype, the
// JAX model's scan (`_ssm_scan_chunked`, src/repro/models/ssm.py:48)
// bx's; the two agree whenever the dtypes are uniform. This kernel returns
// bx's dtype, which is the model's in the mixed case.
//
// Bound: bytes. Each abar and bx element is read once and used for one
// FMA, plus one FMA of the output sum: 4 FLOP per state element. At the
// jamba prefill shape (B=4, S=4096, D=8192, N=16; abar f32, bx, c, y
// bf16) the function moves abar 8,589,934,592 B + bx 4,294,967,296 B +
// c 524,288 B + y 268,435,456 B = 13.15 GB, 3.926 ms at 3.35 TB/s,
// against 8.59e9 FLOP, 0.128 ms at the card's 67 TFLOP/s f32 rate.
//
// Design against that bound:
// - The recurrence is sequential in t and independent across (b, d, n),
//   so each state element lives in a register for the whole sequence and
//   nothing but the inputs and y touches device memory: one pass over
//   abar and bx. There is no chunk or channel-block precondition (the TPU
//   kernel's S % chunk and D % block_d): any S and D.
// - A channel's N states are split over N/4 neighbouring lanes, four
//   states (16 contiguous bytes of f32 abar, 8 of bf16) per lane. So one
//   warp-wide load of a step reads 512 (or 256) contiguous bytes, fully
//   coalesced, and the (b, d) channels of a block are neighbours in
//   memory. y is the sum of the lanes' partial dot products, combined by
//   an xor shuffle over the N/4 lanes; the first lane stores it. At the
//   prefill shape that is 131,072 threads, ~31 warps per SM.
// - Loads run kDepth steps ahead of the arithmetic: each thread keeps the
//   raw bytes of its next kDepth steps in registers (a ring indexed by the
//   unrolled step) and refills a slot right after using it. With ~31 warps
//   per SM that keeps ~12 MB in flight over the card, several times what
//   the HBM rate times its latency needs.
// - c[b, t, :] is the same for every channel of the block (one b per
//   block): kTile steps of it are staged in shared memory in f32 and read
//   as broadcasts.
// - The ragged edges are clamped, not padded: a lane past D or a prefetch
//   past S reads the last valid element and stores nothing.
// - Under grad (the backward's checkpoints): the same kernel with kCkpt
//   also stores the state before every kChunk = 8 steps, each thread its
//   four f32 states as one float4 (streaming), into ckpt (B, ceil(S/8),
//   D, N) f32: the thread layout is the buffer's layout, so a warp's
//   stores are 512 contiguous bytes. A chunk's first step stores h after
//   issuing its prefetch loads. The stores cost ~11% of the forward's
//   time at the training and serve shapes (PERF.md section 6), and about
//   as much wherever they sit (after the group of kDepth steps, before
//   the step's loads). Staged in shared memory and written by TMA bulk
//   copies they cost a little less at the training shape, but the
//   kernel then needs more than 64 registers a thread, and the serve
//   shape's 1,024 blocks no longer fit one wave of 8 blocks an SM.
//   `selective_scan_bwd.cu` rebuilds the states between
//   checkpoints with the same FMAs, so they are this kernel's bit for
//   bit. y is computed as without the stores; serving launches the
//   instantiation without them.
//
// Plain C interface for ctypes (no PyTorch headers): every entry point
// launches on the caller's stream, never synchronises, allocates nothing
// and returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for an N outside {4, 8, 16} or a size out of
// range). abar and bx must be 16-byte aligned (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kTile = 64;      // steps of c staged in shared memory
constexpr int kDepth = 4;      // steps of abar and bx loaded ahead
constexpr int kChunk = 8;      // steps per checkpoint (selective_scan_bwd.cu)
static_assert(kChunk % kDepth == 0 && kTile % kChunk == 0,
              "a checkpoint falls on a group's first step");

// The raw bytes of four consecutive elements: one 16-byte load of f32,
// one 8-byte load of bf16; converted to f32 only when they are used, so
// that issuing a load never waits for its data.
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  using type = float4;
};
template <>
struct Raw<__nv_bfloat16> {
  using type = uint2;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint2 load4(const __nv_bfloat16* p) {
  return __ldcs(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ void unpack(const float4& q, float (&o)[4]) {
  o[0] = q.x;
  o[1] = q.y;
  o[2] = q.z;
  o[3] = q.w;
}
// A bf16 is the high half of the f32 with the same bits; element 0 is the
// low half of the first word (little-endian).
__device__ __forceinline__ void unpack(const uint2& q, float (&o)[4]) {
  o[0] = __uint_as_float(q.x << 16);
  o[1] = __uint_as_float(q.x & 0xffff0000u);
  o[2] = __uint_as_float(q.y << 16);
  o[3] = __uint_as_float(q.y & 0xffff0000u);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Args {
  const void* abar;
  const void* bx;
  const void* c;
  void* y;
  float* ckpt;         // under grad: (B, ceil(S/kChunk), D, N), else null
  int64_t c_sb, c_ss;  // element strides of c over b and s
  int S, D;
};

// TA: dtype of abar; TX: dtype of bx, c and y; kCkpt: also store the
// state before every kChunk steps (the backward's checkpoints).
template <typename TA, typename TX, int N, bool kCkpt>
__global__ void __launch_bounds__(kThreads) scan_fwd(Args a) {
  constexpr int L = N / 4;             // lanes per channel
  constexpr int kChannels = kThreads / L;
  __shared__ __align__(16) float cs[kTile][N];

  const int sub = threadIdx.x % L;
  const int d_raw = blockIdx.x * kChannels + threadIdx.x / L;
  const bool active = d_raw < a.D;
  const int d = active ? d_raw : a.D - 1;
  const int64_t b = blockIdx.y;
  const int64_t sd = int64_t(a.S) * a.D;
  const int64_t step = int64_t(a.D) * N;  // elements from one t to the next
  const int64_t row = (b * sd + d) * N + sub * 4;
  const TA* A = static_cast<const TA*>(a.abar) + row;
  const TX* X = static_cast<const TX*>(a.bx) + row;
  const TX* C = static_cast<const TX*>(a.c) + b * a.c_sb;
  TX* Y = static_cast<TX*>(a.y) + b * sd + d;

  typename Raw<TA>::type ra[kDepth];
  typename Raw<TX>::type rx[kDepth];
#pragma unroll
  for (int j = 0; j < kDepth; ++j) {
    const int64_t t = min(j, a.S - 1);
    ra[j] = load4(A + t * step);
    rx[j] = load4(X + t * step);
  }
  float h[4] = {0.f, 0.f, 0.f, 0.f};
  [[maybe_unused]] float* CK = nullptr;
  if constexpr (kCkpt)
    CK = a.ckpt + (b * ((a.S + kChunk - 1) / kChunk) * a.D + d) * N + sub * 4;

  for (int t0 = 0; t0 < a.S; t0 += kTile) {
    __syncthreads();  // the last tile's reads of cs are done
    for (int i = threadIdx.x; i < kTile * N; i += kThreads) {
      const int t = t0 + i / N;
      cs[i / N][i % N] =
          t < a.S ? to_f32(C[int64_t(t) * a.c_ss + i % N]) : 0.f;
    }
    __syncthreads();

    for (int jj = 0; jj < kTile; jj += kDepth) {
#pragma unroll
      for (int j = 0; j < kDepth; ++j) {
        const int t = t0 + jj + j;
        if (t < a.S) {  // the same t for the whole block: no divergence
          float av[4], xv[4];
          unpack(ra[j], av);
          unpack(rx[j], xv);
          const int64_t tn = min(t + kDepth, a.S - 1);
          ra[j] = load4(A + tn * step);
          rx[j] = load4(X + tn * step);
          if constexpr (kCkpt) {  // h is the state before step t
            if (j == 0 && t % kChunk == 0 && active)
              __stcs(reinterpret_cast<float4*>(CK + int64_t(t / kChunk) * step),
                     make_float4(h[0], h[1], h[2], h[3]));
          }
          const float4 cq =
              *reinterpret_cast<const float4*>(&cs[jj + j][sub * 4]);
          h[0] = fmaf(av[0], h[0], xv[0]);
          h[1] = fmaf(av[1], h[1], xv[1]);
          h[2] = fmaf(av[2], h[2], xv[2]);
          h[3] = fmaf(av[3], h[3], xv[3]);
          float y = h[0] * cq.x;
          y = fmaf(h[1], cq.y, y);
          y = fmaf(h[2], cq.z, y);
          y = fmaf(h[3], cq.w, y);
#pragma unroll
          for (int o = 1; o < L; o <<= 1) y += __shfl_xor_sync(~0u, y, o);
          if (active && sub == 0) store(Y + int64_t(t) * a.D, y);
        }
      }
    }
  }
}

template <typename TA, typename TX, int N, bool kCkpt>
int launch_n(const Args& a, int B, cudaStream_t stream) {
  constexpr int kChannels = kThreads / (N / 4);
  scan_fwd<TA, TX, N, kCkpt>
      <<<dim3((a.D + kChannels - 1) / kChannels, B), kThreads, 0, stream>>>(
          a);
  return int(cudaGetLastError());
}

template <typename TA, typename TX, bool kCkpt>
int launch_ck(const Args& a, int B, int N, cudaStream_t stream) {
  switch (N) {
    case 4: return launch_n<TA, TX, 4, kCkpt>(a, B, stream);
    case 8: return launch_n<TA, TX, 8, kCkpt>(a, B, stream);
    case 16: return launch_n<TA, TX, 16, kCkpt>(a, B, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename TA, typename TX>
int launch(const void* abar, const void* bx, const void* c, void* y,
           void* ckpt, int64_t c_sb, int64_t c_ss, int B, int S, int D,
           int N, cudaStream_t stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1) return int(cudaErrorInvalidValue);
  const Args a{abar, bx, c, y, static_cast<float*>(ckpt), c_sb, c_ss, S, D};
  return ckpt ? launch_ck<TA, TX, true>(a, B, N, stream)
              : launch_ck<TA, TX, false>(a, B, N, stream);
}

}  // namespace

extern "C" {

// c_sb, c_ss: element strides of c over b and s (its N axis has unit
// stride). abar, bx: (B, S, D, N) contiguous; y: (B, S, D) contiguous.
// ckpt: null (serving), or the backward's checkpoints, (B, ceil(S/8), D,
// N) f32 contiguous, 16-byte aligned.

// abar, bx, c, y f32.
int selective_scan_f32(const void* abar, const void* bx, const void* c,
                       void* y, void* ckpt, int64_t c_sb, int64_t c_ss,
                       int B, int S, int D, int N, void* stream) {
  return launch<float, float>(abar, bx, c, y, ckpt, c_sb, c_ss, B, S, D, N,
                              static_cast<cudaStream_t>(stream));
}

// abar, bx, c, y bf16.
int selective_scan_bf16(const void* abar, const void* bx, const void* c,
                        void* y, void* ckpt, int64_t c_sb, int64_t c_ss,
                        int B, int S, int D, int N, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(
      abar, bx, c, y, ckpt, c_sb, c_ss, B, S, D, N,
      static_cast<cudaStream_t>(stream));
}

// abar f32; bx, c, y bf16 (the model's path).
int selective_scan_mixed(const void* abar, const void* bx, const void* c,
                         void* y, void* ckpt, int64_t c_sb, int64_t c_ss,
                         int B, int S, int D, int N, void* stream) {
  return launch<float, __nv_bfloat16>(abar, bx, c, y, ckpt, c_sb, c_ss, B,
                                      S, D, N,
                                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
