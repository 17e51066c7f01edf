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
//   unit stride on D; ckpt: (B, ceil(S/8), D, N) f32 contiguous, the state
//   before every 8 steps as the forward kernel stores it under grad
//   (`selective_scan.cu`, kCkpt). d abar comes back in abar's dtype, d bx
//   in bx's, dc (B, S, N) contiguous in c's dtype. The dtype cases of the
//   forward: all f32, all bf16, abar f32 with bx, c, dy bf16 (the model's
//   path). All arithmetic in f32.
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
// 2.1e9 FLOP, 0.03 ms at 67 TFLOP/s. The checkpoints (134 MB read) and
// dc's block partials (33.5 MB written and read) are the design's cost,
// not the bound's.
//
// Design (the exact recurrences, no division by abar: exp(dt A)
// underflows to 0, and abar = 0 must forget in both directions; no float
// atomics, every sum in a fixed order, so two calls are bit-equal):
// - The forward kernel writes the checkpoints, so abar and bx are read
//   once: this file has no checkpoint sweep. The rebuild of h_{t-1} from
//   a checkpoint repeats the forward's FMAs in its order, so the states
//   are the forward's bit for bit.
// - scan_bwd_rev: one reverse sweep, chunk by chunk from the end, in the
//   forward's thread layout: a channel's N states over N/4 neighbouring
//   lanes, four states (16 bytes of f32, 8 of bf16) per lane, 128 threads
//   a block (512 blocks at the training shape, four per SM: one wave on
//   132 SMs). Per chunk of kChunk = 8 steps a thread rebuilds the states
//   h_{c0-1} .. h_{c0+7} from the checkpoint into registers, then walks
//   the steps backwards with G in registers, storing d bx and d abar
//   (streaming) and dc's terms h_t dy_t.
// - Prefetched chunks. Each thread copies its own 4 states of the next
//   chunk's 8 steps of abar and bx by cp.async (16 and 8 bytes, zeros
//   past S) into a ring of two stages, and loads the next chunk's
//   checkpoint and the block's share of its c and dy into registers,
//   all one chunk ahead of use; a thread reads only what it copied, so
//   cp.async.wait_group, and no barrier, says the stage has landed. c
//   and dy are staged in f32 into alternating shared buffers at the top
//   of each chunk (c is a strided view, 2-byte aligned: too narrow for a
//   copy), behind the chunk's one block barrier.
// - dc: per step, the lanes' h_t dy_t are summed over the warp's
//   channels by a reduce-scatter of xor shuffles and stored per warp; after
//   the next chunk's barrier the warps' sums are added in order and
//   written as the block's partial (the partial buffers alternate, so
//   that one barrier a chunk suffices). scan_bwd_dc then sums the blocks'
//   partials in a fixed order.
// - Ragged edges: a lane past D reads the last channel and stores nothing
//   (its dy staged as 0, so it adds nothing to dc); steps past S are
//   copied as zeros and skipped.
//
// Scratch (f32, the wrapper's buffer): dc partials
// B*ceil(D/(128/(N/4)))*S*N: at the training shape 8,388,608 floats
// (33.5 MB), at the serve shape (B=4, S=4096) 67,108,864. The forward's
// checkpoints (the autograd node keeps them): 33,554,432 floats (134 MB)
// at the training shape, 268,435,456 at the serve shape. Shared memory:
// 56,320 bytes a block at N = 16 with f32 abar and bf16 bx (the stages
// 49,152). Registers and spills: `chip_smoke.py` phase 2 prints ptxas's
// report.
//
// Plain C interface for ctypes (no PyTorch headers): every entry point
// launches on the caller's stream, never synchronises, allocates nothing
// and returns the cudaError_t of the launches (0 on success;
// cudaErrorInvalidValue for an N outside {4, 8, 16}, a size out of range
// or a scratch buffer smaller than the layout needs). abar, bx, d abar,
// d bx and ckpt must be 16-byte aligned (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;      // steps per checkpoint (selective_scan.cu)
constexpr int kStages = 2;     // chunks in the ring: one read, one landing
constexpr int kDcThreads = 256;

// A thread's four elements of one step as stored: 16 bytes of f32, 8 of
// bf16.
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

// One element's bits, loaded into a register one chunk ahead and widened
// to f32 only when it is staged, so that the load is not waited for.
template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using type = float;
};
template <>
struct Bits<__nv_bfloat16> {
  using type = uint16_t;
};
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(uint32_t(v) << 16);
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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One cp.async of BYTES (8 or 16) into shared memory; src_bytes = 0
// writes zeros and reads nothing.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const uint32_t d = tc::smem_u32(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most PENDING of this thread's copy groups are in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

struct Args {
  const void* abar;
  const void* bx;
  const void* c;
  const void* dy;
  const float* ckpt;  // (B, nch, D, N): the state before each chunk
  void* dabar;
  void* dbx;
  void* dc;
  float* part;  // (B, nblk, S, N): dc over each block's channels
  int64_t c_sb, c_ss;    // element strides of c over b and s
  int64_t dy_sb, dy_ss;  // element strides of dy over b and s
  int S, D, nblk;
};

template <typename TA, typename TX, int N>
struct Smem {
  static constexpr int kChannels = kThreads / (N / 4);
  // each thread's own four states of every step of a chunk
  typename Raw<TA>::type a[kStages][kChunk][kThreads];
  typename Raw<TX>::type x[kStages][kChunk][kThreads];
  float c[kStages][kChunk][N];
  float dy[kStages][kChunk][kChannels];
  float dcp[kStages][kChunk][kWarps][N];  // dc per warp
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

// The reverse sweep: d bx = G, d abar = G (.) h_{t-1}, and dc's partial
// sums over the block's channels.
template <typename TA, typename TX, int N>
__global__ void __launch_bounds__(kThreads, 4) scan_bwd_rev(const Args a) {
  using Sm = Smem<TA, TX, N>;
  using RA = typename Raw<TA>::type;
  using RX = typename Raw<TX>::type;
  using BX = typename Bits<TX>::type;
  constexpr int L = N / 4;             // lanes per channel
  constexpr int kChannels = Sm::kChannels;
  constexpr int CW = 32 / L;           // channels per warp
  static_assert(CW >= 4, "the dc reduce-scatter ends at one state");
  // c and dy values of a chunk each thread loads ahead
  constexpr int kCV = (kChunk * N + kThreads - 1) / kThreads;
  constexpr int kDV = kChunk * kChannels / kThreads;
  static_assert(kDV * kThreads == kChunk * kChannels, "dy tiles evenly");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

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
  TA* DA = static_cast<TA*>(a.dabar) + row;
  TX* DX = static_cast<TX*>(a.dbx) + row;
  const BX* C = static_cast<const BX*>(a.c) + b * a.c_sb;
  const BX* DY = static_cast<const BX*>(a.dy) + b * a.dy_sb;
  const int nch = (a.S + kChunk - 1) / kChunk;
  const float* CK = a.ckpt + (b * nch * a.D + d) * N + sub * 4;
  float* P = a.part + (b * a.nblk + blockIdx.x) * int64_t(a.S) * N;

  // Chunk ci, one chunk ahead: the thread's abar and bx rows into stage
  // ci % kStages (one copy group), its checkpoint, and its share of c
  // and dy (zeros past S and D) into registers.
  BX cr[kCV], dr[kDV];
  float4 ck;
  auto fetch = [&](int ci) {
    const int c0 = ci * kChunk, st = ci % kStages;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int t = c0 + j;
      const bool in = t < a.S;
      const int64_t off = int64_t(in ? t : a.S - 1) * step;
      cp_async<int(sizeof(RA))>(&sm.a[st][j][tid], A + off,
                           in ? int(sizeof(RA)) : 0);
      cp_async<int(sizeof(RX))>(&sm.x[st][j][tid], X + off,
                           in ? int(sizeof(RX)) : 0);
    }
    cp_async_commit();
    ck = __ldcs(reinterpret_cast<const float4*>(CK + int64_t(ci) * step));
#pragma unroll
    for (int q = 0; q < kCV; ++q) {
      const int i = tid + q * kThreads, t = c0 + i / N;
      cr[q] = i < kChunk * N && t < a.S ? C[int64_t(t) * a.c_ss + i % N]
                                        : BX(0);
    }
#pragma unroll
    for (int q = 0; q < kDV; ++q) {
      const int i = tid + q * kThreads;
      const int t = c0 + i / kChannels, dd = d0 + i % kChannels;
      dr[q] = t < a.S && dd < a.D ? DY[int64_t(t) * a.dy_ss + dd] : BX(0);
    }
  };
  // dc of chunk ci: the warps' sums added in order, one partial per step
  // and state.
  auto finish = [&](int ci) {
    const int c0 = ci * kChunk, st = ci % kStages;
    for (int i = tid; i < kChunk * N; i += kThreads) {
      const int j = i / N, n = i % N, t = c0 + j;
      if (t >= a.S) continue;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += sm.dcp[st][j][q][n];
      __stcs(P + int64_t(t) * N + n, s);
    }
  };

  float g[4] = {0.f, 0.f, 0.f, 0.f};
  float an[4] = {0.f, 0.f, 0.f, 0.f};  // abar_{t+1}
  fetch(nch - 1);
  for (int ci = nch - 1; ci >= 0; --ci) {
    const int c0 = ci * kChunk, st = ci % kStages;
    // This chunk's c and dy into shared memory (the buffer's last
    // readers, two chunks back, are past the last barrier), its
    // checkpoint into the state, then the next chunk on its way.
#pragma unroll
    for (int q = 0; q < kCV; ++q) {
      const int i = tid + q * kThreads;
      if (i < kChunk * N) sm.c[st][i / N][i % N] = widen(cr[q]);
    }
#pragma unroll
    for (int q = 0; q < kDV; ++q) {
      const int i = tid + q * kThreads;
      sm.dy[st][i / kChannels][i % kChannels] = widen(dr[q]);
    }
    // h[j] is the state before step c0 + j, h[kChunk] the one after the
    // chunk.
    float h[kChunk + 1][4];
    h[0][0] = ck.x;
    h[0][1] = ck.y;
    h[0][2] = ck.z;
    h[0][3] = ck.w;
    if (ci > 0) {
      fetch(ci - 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (ci + 1 < nch) finish(ci + 1);

#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      float av[4], xv[4];
      unpack(sm.a[st][j][tid], av);
      unpack(sm.x[st][j][tid], xv);
#pragma unroll
      for (int i = 0; i < 4; ++i) h[j + 1][i] = fmaf(av[i], h[j][i], xv[i]);
    }
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      const int t = c0 + j;
      if (t < a.S) {  // the same t for the whole block: no divergence
        const float dyv = sm.dy[st][j][ch];
        float cv[4], av[4], da[4], p[4];
        unpack(*reinterpret_cast<const float4*>(&sm.c[st][j][sub * 4]), cv);
        unpack(sm.a[st][j][tid], av);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          g[i] = fmaf(an[i], g[i], cv[i] * dyv);
          da[i] = g[i] * h[j][i];
          an[i] = av[i];
          p[i] = h[j + 1][i] * dyv;
        }
        if (active) {
          store4(DX + int64_t(t) * step, g);
          store4(DA + int64_t(t) * step, da);
        }
        int own = 0;
        reduce_channels<CW, 4, L>(p, cw, own);
        if ((cw & (CW / 4 - 1)) == 0)
          sm.dcp[st][j][warp][sub * 4 + own] = p[0];
      }
    }
  }
  __syncthreads();
  finish(0);
}

// dc: the blocks' partials summed in a fixed order, cast to c's dtype.
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
  constexpr int kChannels = Smem<TA, TX, N>::kChannels;
  a.nblk = (a.D + kChannels - 1) / kChannels;
  if (n_scratch < int64_t(B) * a.nblk * a.S * N)
    return int(cudaErrorInvalidValue);
  const int smem = int(sizeof(Smem<TA, TX, N>));
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_rev<TA, TX, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(scan_bwd_rev<TA, TX, N>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return int(err);
  scan_bwd_rev<TA, TX, N><<<dim3(a.nblk, B), kThreads, smem, stream>>>(a);
  scan_bwd_dc<TX><<<dim3((a.S * int64_t(N) + kDcThreads - 1) / kDcThreads,
                         B),
                    kDcThreads, 0, stream>>>(a, N);
  return int(cudaGetLastError());
}

template <typename TA, typename TX>
int launch(const void* abar, const void* bx, const void* c, const void* dy,
           const void* ckpt, void* dabar, void* dbx, void* dc, void* scratch,
           int64_t n_scratch, int64_t c_sb, int64_t c_ss, int64_t dy_sb,
           int64_t dy_ss, int B, int S, int D, int N, cudaStream_t stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1) return int(cudaErrorInvalidValue);
  Args a{};
  a.abar = abar;
  a.bx = bx;
  a.c = c;
  a.dy = dy;
  a.ckpt = static_cast<const float*>(ckpt);
  a.dabar = dabar;
  a.dbx = dbx;
  a.dc = dc;
  a.part = static_cast<float*>(scratch);
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
// ckpt: the forward's checkpoints (see the header). scratch: n_scratch f32
// (dc's block partials). dc: (B, S, N) contiguous.

// abar, bx, c, dy and the gradients f32.
int selective_scan_bwd_f32(const void* abar, const void* bx, const void* c,
                           const void* dy, const void* ckpt, void* dabar,
                           void* dbx, void* dc, void* scratch,
                           int64_t n_scratch, int64_t c_sb, int64_t c_ss,
                           int64_t dy_sb, int64_t dy_ss, int B, int S, int D,
                           int N, void* stream) {
  return launch<float, float>(abar, bx, c, dy, ckpt, dabar, dbx, dc, scratch,
                              n_scratch, c_sb, c_ss, dy_sb, dy_ss, B, S, D, N,
                              static_cast<cudaStream_t>(stream));
}

// everything bf16.
int selective_scan_bwd_bf16(const void* abar, const void* bx, const void* c,
                            const void* dy, const void* ckpt, void* dabar,
                            void* dbx, void* dc, void* scratch,
                            int64_t n_scratch, int64_t c_sb, int64_t c_ss,
                            int64_t dy_sb, int64_t dy_ss, int B, int S, int D,
                            int N, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(
      abar, bx, c, dy, ckpt, dabar, dbx, dc, scratch, n_scratch, c_sb, c_ss,
      dy_sb, dy_ss, B, S, D, N, static_cast<cudaStream_t>(stream));
}

// abar, d abar f32; bx, c, dy, d bx, dc bf16 (the model's path).
int selective_scan_bwd_mixed(const void* abar, const void* bx, const void* c,
                             const void* dy, const void* ckpt, void* dabar,
                             void* dbx, void* dc, void* scratch,
                             int64_t n_scratch, int64_t c_sb, int64_t c_ss,
                             int64_t dy_sb, int64_t dy_ss, int B, int S,
                             int D, int N, void* stream) {
  return launch<float, __nv_bfloat16>(abar, bx, c, dy, ckpt, dabar, dbx, dc,
                                      scratch, n_scratch, c_sb, c_ss, dy_sb,
                                      dy_ss, B, S, D, N,
                                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
