// selective_scan_bwd: the backward of the Mamba selective-SSM recurrence,
// sm_90a.
//
//   forward, per (b, d), state h[0..N) in f32 from zero:
//     h_t = abar_t (.) h_{t-1} + bx_t,   y_t[d] = sum_n h_t[n] c_t[n]
//   backward, with G_t = dL/dh_t (the output's own step included):
//     G_t        = c_t dy_t[d] + abar_{t+1} (.) G_{t+1}   (G_S = 0)
//     d abar_t   = G_t (.) h_{t-1}
//     d bx_t     = G_t
//     dc_t[n]    = sum_d h_t[d][n] dy_t[d]
//
//   abar, bx: (B, S, D, N) contiguous; c: (B, S, N) with any (b, s)
//   strides and unit stride on N; dy: (B, S, D) with any (b, s) strides and
//   unit stride on D. d abar comes back in abar's dtype, d bx in bx's, dc
//   (B, S, N) contiguous in c's dtype. The dtype cases of the forward
//   (`selective_scan.cu`): all f32, all bf16, abar f32 with bx, c, dy bf16
//   (the model's path). All arithmetic in f32.
//
// The backward of the Pallas TPU kernel `selective_scan`
// (src/repro/kernels/selective_scan.py:42, pallas_call at :60) and of this
// port's forward. The JAX package has no backward kernel: it
// differentiates jnp (`_ssm_scan_chunked`, src/repro/models/ssm.py:48).
// The oracle is jax.vjp of `selective_scan_ref` (src/repro/kernels/
// ref.py:40).
//
// Bound: bytes. The function reads abar and bx and writes d abar and d bx
// once each (c, dy and dc are a D-th or an N-th of that): at jamba's
// training shape (B=2, S=1024, D=8192, N=16; abar f32, bx, dy bf16) 12
// bytes per state element plus dy, 3.25 GB, 0.97 ms at 3.35 TB/s, against
// 8 FLOP per state element (h rebuilt, the G update, d abar, dc's term):
// 2.1e9 FLOP, 0.03 ms at 67 TFLOP/s.
//
// Design (a first, simple kernel; the exact recurrences, no division by
// abar: exp(dt A) underflows to 0 and abar = 0 must forget in both
// directions):
// - Three launches on the caller's stream.
//   1. scan_bwd_ckpt: the forward recurrence, writing h before every
//      kChunk = 8 steps to a checkpoint buffer, and dc's partial sums over
//      the block's channels (h_t is at hand there).
//   2. scan_bwd_rev: the reverse sweep, chunk by chunk from the end. A
//      thread loads the chunk's 8 steps of abar and bx at once, rebuilds
//      h_{t-1} from the chunk's checkpoint into registers, and walks the
//      steps backwards with G in registers, storing d bx and d abar. So
//      abar and bx are read twice in all (launches 1 and 2): 18 bytes per
//      state element at the model's dtypes, 1.45 ms at the training shape.
//   3. scan_bwd_dc: dc, the blocks' partials summed in a fixed order.
//   No float atomics anywhere: the gradients are bit-reproducible.
// - The forward's thread layout: a channel's N states over N/4
//   neighbouring lanes, four states (16 bytes of f32, 8 of bf16) per lane,
//   so each step's loads and stores are coalesced; 128 threads per block.
//   dc's sum over the channels: a reduce-scatter over the warp's channels
//   by xor shuffles, then a fixed-order sum over the 4 warps in shared
//   memory per tile of steps, written as one partial per block.
// - Launch 1 keeps its loads kDepth = 4 steps ahead of the arithmetic in a
//   ring of registers (as the forward); launch 2 issues a whole chunk's
//   loads before it uses any.
// - Ragged edges: a lane past D reads the last channel and stores nothing
//   (its dy staged as 0, so it adds nothing to dc); steps past S are
//   skipped.
//
// Scratch (f32, one buffer from the wrapper): checkpoints
// B*ceil(S/8)*D*N, dc partials B*ceil(D/(128/(N/4)))*S*N. At the training
// shape: 33,554,432 + 8,388,608 floats = 167.8 MB; at the serve shape
// (B=4, S=4096): 268,435,456 + 67,108,864 floats = 1.34 GB.
//
// Plain C interface for ctypes (no PyTorch headers): every entry point
// launches on the caller's stream, never synchronises, allocates nothing
// and returns the cudaError_t of the launches (0 on success;
// cudaErrorInvalidValue for an N outside {4, 8, 16}, a size out of range
// or a scratch buffer smaller than the layout needs). abar, bx, d abar and
// d bx must be 16-byte aligned (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;      // steps per checkpoint
constexpr int kTile = 64;      // steps of dy staged per pass of launch 1
constexpr int kDepth = 4;      // steps of abar and bx loaded ahead (launch 1)
constexpr int kDcThreads = 256;

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
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&lo);
  q.y = *reinterpret_cast<const uint32_t*>(&hi);
  __stcs(reinterpret_cast<uint2*>(p), q);
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
  const void* dy;
  void* dabar;
  void* dbx;
  void* dc;
  float* ckpt;  // (B, nch, D, N)
  float* part;  // (B, nblk, S, N): dc over each block's channels
  int64_t c_sb, c_ss;    // element strides of c over b and s
  int64_t dy_sb, dy_ss;  // element strides of dy over b and s
  int S, D, nblk;
};

// Sum 4 per-state values over the CW channels of a warp (lanes STRIDE
// apart per channel bit), highest channel bit first: a reduce-scatter
// while a lane holds more than one state (`own` gains the offset of the
// half it keeps), then the remaining channel bits summed in full.
template <int CW, int CNT, int STRIDE>
__device__ __forceinline__ void reduce_channels(float* acc, int cw, int& own) {
  if constexpr (CW > 1) {
    constexpr int lvl = CW / 2;
    if constexpr (CNT > 1) {
      constexpr int half = CNT / 2;
      const bool up = (cw & lvl) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = up ? acc[i] : acc[half + i];
        const float keep = up ? acc[half + i] : acc[i];
        acc[i] = keep + __shfl_xor_sync(~0u, send, lvl * STRIDE);
      }
      if (up) own += half;
      reduce_channels<lvl, half, STRIDE>(acc, cw, own);
    } else {
      acc[0] += __shfl_xor_sync(~0u, acc[0], lvl * STRIDE);
      reduce_channels<lvl, 1, STRIDE>(acc, cw, own);
    }
  }
}

// 1. The forward recurrence: h before every chunk to the checkpoints, and
// dc_t's partial sum over the block's channels.
template <typename TA, typename TX, int N>
__global__ void __launch_bounds__(kThreads) scan_bwd_ckpt(const Args a) {
  constexpr int L = N / 4;             // lanes per channel
  constexpr int kChannels = kThreads / L;
  constexpr int CW = 32 / L;           // channels per warp
  static_assert(CW >= 4, "the dc reduce-scatter ends at one state");
  __shared__ __align__(16) float dys[kTile][kChannels];
  __shared__ float dcp[kTile][kWarps][N];

  const int tid = threadIdx.x;
  const int sub = tid % L, ch = tid / L, warp = tid / 32;
  const int cw = (tid % 32) / L;
  const int d0 = blockIdx.x * kChannels;
  const int d_raw = d0 + ch;
  const bool active = d_raw < a.D;
  const int d = active ? d_raw : a.D - 1;
  const int64_t b = blockIdx.y;
  const int64_t sd = int64_t(a.S) * a.D;
  const int64_t step = int64_t(a.D) * N;
  const int64_t row = (b * sd + d) * N + sub * 4;
  const TA* A = static_cast<const TA*>(a.abar) + row;
  const TX* X = static_cast<const TX*>(a.bx) + row;
  const TX* DY = static_cast<const TX*>(a.dy) + b * a.dy_sb;
  const int nch = (a.S + kChunk - 1) / kChunk;
  float* CK = a.ckpt + (b * nch * a.D + d) * N + sub * 4;
  float* P = a.part + (b * a.nblk + blockIdx.x) * int64_t(a.S) * N;

  typename Raw<TA>::type ra[kDepth];
  typename Raw<TX>::type rx[kDepth];
#pragma unroll
  for (int j = 0; j < kDepth; ++j) {
    const int64_t t = min(j, a.S - 1);
    ra[j] = load4(A + t * step);
    rx[j] = load4(X + t * step);
  }
  float h[4] = {0.f, 0.f, 0.f, 0.f};

  for (int t0 = 0; t0 < a.S; t0 += kTile) {
    __syncthreads();  // the last tile's reads of dys and dcp are done
    for (int i = tid; i < kTile * kChannels; i += kThreads) {
      const int t = t0 + i / kChannels, dd = d0 + i % kChannels;
      dys[i / kChannels][i % kChannels] =
          t < a.S && dd < a.D ? to_f32(DY[int64_t(t) * a.dy_ss + dd]) : 0.f;
    }
    __syncthreads();

    for (int jj = 0; jj < kTile; jj += kDepth) {
#pragma unroll
      for (int j = 0; j < kDepth; ++j) {
        const int t = t0 + jj + j;
        if (t < a.S) {  // the same t for the whole block: no divergence
          if (t % kChunk == 0 && active) {
            const float hv[4] = {h[0], h[1], h[2], h[3]};
            store4(CK + int64_t(t / kChunk) * a.D * N, hv);
          }
          float av[4], xv[4];
          unpack(ra[j], av);
          unpack(rx[j], xv);
          const int64_t tn = min(t + kDepth, a.S - 1);
          ra[j] = load4(A + tn * step);
          rx[j] = load4(X + tn * step);
          const float g = dys[jj + j][ch];
          float p[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            h[i] = fmaf(av[i], h[i], xv[i]);
            p[i] = h[i] * g;
          }
          int own = 0;
          reduce_channels<CW, 4, L>(p, cw, own);
          if ((cw & (CW / 4 - 1)) == 0)
            dcp[jj + j][warp][sub * 4 + own] = p[0];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int j = i / N, n = i % N, t = t0 + j;
      if (t >= a.S) continue;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += dcp[j][q][n];
      P[int64_t(t) * N + n] = s;
    }
  }
}

// 2. The reverse sweep: d bx = G and d abar = G (.) h_{t-1}.
template <typename TA, typename TX, int N>
__global__ void __launch_bounds__(kThreads) scan_bwd_rev(const Args a) {
  constexpr int L = N / 4;
  constexpr int kChannels = kThreads / L;
  __shared__ __align__(16) float cs[kChunk][N];
  __shared__ float dys[kChunk][kChannels];

  const int tid = threadIdx.x;
  const int sub = tid % L, ch = tid / L;
  const int d0 = blockIdx.x * kChannels;
  const int d_raw = d0 + ch;
  const bool active = d_raw < a.D;
  const int d = active ? d_raw : a.D - 1;
  const int64_t b = blockIdx.y;
  const int64_t sd = int64_t(a.S) * a.D;
  const int64_t step = int64_t(a.D) * N;
  const int64_t row = (b * sd + d) * N + sub * 4;
  const TA* A = static_cast<const TA*>(a.abar) + row;
  const TX* X = static_cast<const TX*>(a.bx) + row;
  TA* DA = static_cast<TA*>(a.dabar) + row;
  TX* DX = static_cast<TX*>(a.dbx) + row;
  const TX* C = static_cast<const TX*>(a.c) + b * a.c_sb;
  const TX* DY = static_cast<const TX*>(a.dy) + b * a.dy_sb;
  const int nch = (a.S + kChunk - 1) / kChunk;
  const float* CK = a.ckpt + (b * nch * a.D + d) * N + sub * 4;

  float g[4] = {0.f, 0.f, 0.f, 0.f};
  float an[4] = {0.f, 0.f, 0.f, 0.f};  // abar_{t+1}
  for (int ci = nch - 1; ci >= 0; --ci) {
    const int c0 = ci * kChunk;
    typename Raw<TA>::type ra[kChunk];
    typename Raw<TX>::type rx[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int64_t t = min(c0 + j, a.S - 1);
      ra[j] = load4(A + t * step);
      rx[j] = load4(X + t * step);
    }
    const float4 h0 =
        *reinterpret_cast<const float4*>(CK + int64_t(ci) * a.D * N);
    __syncthreads();  // the last chunk's reads of cs and dys are done
    for (int i = tid; i < kChunk * N; i += kThreads) {
      const int t = c0 + i / N;
      cs[i / N][i % N] =
          t < a.S ? to_f32(C[int64_t(t) * a.c_ss + i % N]) : 0.f;
    }
    for (int i = tid; i < kChunk * kChannels; i += kThreads) {
      const int t = c0 + i / kChannels, dd = d0 + i % kChannels;
      dys[i / kChannels][i % kChannels] =
          t < a.S && dd < a.D ? to_f32(DY[int64_t(t) * a.dy_ss + dd]) : 0.f;
    }
    __syncthreads();

    // h_{t-1} of the chunk's steps, rebuilt from the checkpoint.
    float av[kChunk][4], hp[kChunk][4];
    float h[4] = {h0.x, h0.y, h0.z, h0.w};
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      float xv[4];
      unpack(ra[j], av[j]);
      unpack(rx[j], xv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hp[j][i] = h[i];
        h[i] = fmaf(av[j][i], h[i], xv[i]);
      }
    }
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      const int t = c0 + j;
      if (t < a.S) {
        const float dyv = dys[j][ch];
        const float4 cq = *reinterpret_cast<const float4*>(&cs[j][sub * 4]);
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
        float da[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          g[i] = fmaf(an[i], g[i], cv[i] * dyv);
          da[i] = g[i] * hp[j][i];
          an[i] = av[j][i];
        }
        if (active) {
          store4(DX + int64_t(t) * step, g);
          store4(DA + int64_t(t) * step, da);
        }
      }
    }
  }
}

// 3. dc: the blocks' partials summed in a fixed order, cast to c's dtype.
template <typename TX>
__global__ void __launch_bounds__(kDcThreads) scan_bwd_dc(const Args a,
                                                          int N) {
  const int64_t b = blockIdx.y;
  const int64_t sn = int64_t(a.S) * N;
  const int64_t i = int64_t(blockIdx.x) * kDcThreads + threadIdx.x;
  if (i >= sn) return;
  const float* P = a.part + b * a.nblk * sn + i;
  float s = 0.f;
  for (int q = 0; q < a.nblk; ++q) s += P[int64_t(q) * sn];
  store(static_cast<TX*>(a.dc) + b * sn + i, s);
}

template <typename TA, typename TX, int N>
int launch_n(Args a, int B, int64_t n_scratch, cudaStream_t stream) {
  constexpr int kChannels = kThreads / (N / 4);
  a.nblk = (a.D + kChannels - 1) / kChannels;
  const int64_t nch = (a.S + kChunk - 1) / kChunk;
  const int64_t n_ckpt = int64_t(B) * nch * a.D * N;
  const int64_t n_part = int64_t(B) * a.nblk * a.S * N;
  if (n_scratch < n_ckpt + n_part) return int(cudaErrorInvalidValue);
  a.part = a.ckpt + n_ckpt;
  const dim3 grid(a.nblk, B);
  scan_bwd_ckpt<TA, TX, N><<<grid, kThreads, 0, stream>>>(a);
  scan_bwd_rev<TA, TX, N><<<grid, kThreads, 0, stream>>>(a);
  scan_bwd_dc<TX><<<dim3((a.S * int64_t(N) + kDcThreads - 1) / kDcThreads,
                         B),
                    kDcThreads, 0, stream>>>(a, N);
  return int(cudaGetLastError());
}

template <typename TA, typename TX>
int launch(const void* abar, const void* bx, const void* c, const void* dy,
           void* dabar, void* dbx, void* dc, void* scratch,
           int64_t n_scratch, int64_t c_sb, int64_t c_ss, int64_t dy_sb,
           int64_t dy_ss, int B, int S, int D, int N, cudaStream_t stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1) return int(cudaErrorInvalidValue);
  Args a{};
  a.abar = abar;
  a.bx = bx;
  a.c = c;
  a.dy = dy;
  a.dabar = dabar;
  a.dbx = dbx;
  a.dc = dc;
  a.ckpt = static_cast<float*>(scratch);
  a.c_sb = c_sb;
  a.c_ss = c_ss;
  a.dy_sb = dy_sb;
  a.dy_ss = dy_ss;
  a.S = S;
  a.D = D;
  switch (N) {
    case 4:
      return launch_n<TA, TX, 4>(a, B, n_scratch, stream);
    case 8:
      return launch_n<TA, TX, 8>(a, B, n_scratch, stream);
    case 16:
      return launch_n<TA, TX, 16>(a, B, n_scratch, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// c_sb, c_ss, dy_sb, dy_ss: element strides of c and dy over b and s.
// scratch: n_scratch f32 (see the header). dc: (B, S, N) contiguous.

// abar, bx, c, dy and the gradients f32.
int selective_scan_bwd_f32(const void* abar, const void* bx, const void* c,
                           const void* dy, void* dabar, void* dbx, void* dc,
                           void* scratch, int64_t n_scratch, int64_t c_sb,
                           int64_t c_ss, int64_t dy_sb, int64_t dy_ss, int B,
                           int S, int D, int N, void* stream) {
  return launch<float, float>(abar, bx, c, dy, dabar, dbx, dc, scratch,
                              n_scratch, c_sb, c_ss, dy_sb, dy_ss, B, S, D, N,
                              static_cast<cudaStream_t>(stream));
}

// everything bf16.
int selective_scan_bwd_bf16(const void* abar, const void* bx, const void* c,
                            const void* dy, void* dabar, void* dbx, void* dc,
                            void* scratch, int64_t n_scratch, int64_t c_sb,
                            int64_t c_ss, int64_t dy_sb, int64_t dy_ss, int B,
                            int S, int D, int N, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(
      abar, bx, c, dy, dabar, dbx, dc, scratch, n_scratch, c_sb, c_ss, dy_sb,
      dy_ss, B, S, D, N, static_cast<cudaStream_t>(stream));
}

// abar, d abar f32; bx, c, dy, d bx, dc bf16 (the model's path).
int selective_scan_bwd_mixed(const void* abar, const void* bx, const void* c,
                             const void* dy, void* dabar, void* dbx,
                             void* dc, void* scratch, int64_t n_scratch,
                             int64_t c_sb, int64_t c_ss, int64_t dy_sb,
                             int64_t dy_ss, int B, int S, int D, int N,
                             void* stream) {
  return launch<float, __nv_bfloat16>(abar, bx, c, dy, dabar, dbx, dc,
                                      scratch, n_scratch, c_sb, c_ss, dy_sb,
                                      dy_ss, B, S, D, N,
                                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
