// rwkv6_wkv: the RWKV-6 WKV recurrence (prefill), sm_90a.
//
//   per (b, h), state S (N x N, f32, from zero), for t = 0 .. S_len-1:
//     y_t[m]  = sum_n r_t[n] (S[n][m] + u[n] k_t[n] v_t[m])
//             = sum_n r_t[n] S[n][m] + c_t v_t[m],  c_t = sum_n r_t[n] u[n] k_t[n]
//     S[n][m] <- w_t[n] S[n][m] + k_t[n] v_t[m]
//
//   r, k, v, w: (B, H, S, N); u: (H, N) f32; y: (B, H, S, N) in r's dtype.
//   r, k, v share one dtype, f32 or bf16; w is f32 or r's dtype (the model
//   passes its decay in f32: near 1 a bf16 ulp is 2^-8, so a bf16 w would
//   shorten the state's memory). All arithmetic in f32.
//
// Replaces the Pallas TPU kernel `rwkv6_wkv`
// (src/repro/kernels/rwkv6_wkv.py:47, pallas_call at :64, body
// `_wkv_kernel` at :22), whose oracle is `rwkv6_wkv_ref`
// (src/repro/kernels/ref.py:59).
//
// Bound: operations. Per (b, h, step) the function needs
//   y = r^T S + c v, c = sum_n r[n] u[n] k[n]   2 N^2 + 5 N FLOP
//   S <- diag(w) S + k v^T                      3 N^2 FLOP
// so 5 N^2 + 5 N. At the serving path's prefill shape (B=4, H=40,
// S=4096, N=64; bf16 r, k, v, y and f32 w) that is
// 4*40*4096*(5*64^2 + 5*64) = 1.36e10 FLOP, 0.20 ms at the card's
// 67 TFLOP/s f32 rate, against 503 MB moved (r, k, v, y 4 x 83.9 MB,
// w 167.8 MB), 0.15 ms at 3.35 TB/s. The recurrence is sequential in t:
// the parallelism is the B*H*N*N state entries, and the time is set by
// the instructions (and shared-memory loads) each entry costs per step.
//
// Design (the exact recurrence: one left-to-right pass per state entry,
// no cumulative decay products, no divisions; w = 0 forgets and w = 1
// sums exactly):
// - Only the function's work. The bonus term is one scalar per (b, h,
//   step), c_t, summed once per staged tile (below); each state entry
//   then costs 3 instructions per step: y += r[n] S[n][m] (FMA),
//   kv = k[n] v[m] (MUL), S = w[n] S + kv (FMA).
// - A thread tile of KPT keys x CPT = 4 value columns. Every value a
//   thread loads from shared memory per step (r, k, w of its keys, v of
//   its columns; float4 each) is used by 4 or more entries: with one
//   column per thread the loads, not the FMAs, set the pace (the
//   shared-memory pipe delivers 128 bytes per cycle per SM).
// - Enough warps. At N = 64: KPT = 4, so a column group's 64 keys are
//   split over G = 16 lanes of one warp; a block holds CB = 32 value
//   columns (8 column groups x 16 lanes = 128 threads) and SPLIT = 2
//   blocks cover a (b, h): 320 blocks, 40,960 threads, ~9.7 warps per SM
//   at the prefill shape. (8 x 4 and 16 x 4 tiles, and 16 columns per
//   block, ran slower on the card.)
//   Smaller N: KPT = 8 (N = 4: 4), CB = min(N, 32). A thread's keys are
//   n = 4 (g + G jj) + e (jj < KPT/4, e < 4), so the lanes of a group
//   read neighbouring 16-byte words (no bank conflict).
// - The G lanes' partial y are summed by xor shuffles, highest lane bit
//   first, as a reduce-scatter: a lane that holds more than one column
//   sends half of them at each level (reduce_cols); lane(s) with the
//   low bits clear store y = fma(c_t, v[m], sum). The step loop over a
//   tile is unrolled, the shuffles of step j placed after the FMAs of
//   step j+1, so no step waits on them.
// - Loads overlapped. kTile = 16 steps of r, k, w (all N keys) and of v
//   (the block's CB columns) are copied into one of kStages = 3 stages,
//   in their own dtypes, two tiles ahead of the one computed: one thread
//   issues one TMA box per array per tile through 4-D tensor maps
//   (N, H, S, B) and an mbarrier counts the bytes. (Row by row, one copy
//   per step and array, the copies of a tile took longer than its
//   compute.) The wrapper copies a view TMA cannot address (base or a
//   stride not a multiple of 16 bytes) into a dense tensor first; a map
//   the driver refuses is a launch error. The one exception is fixed at
//   compile time: N = 4 in bf16, whose 8-byte rows are under TMA's
//   16-byte minimum, copies by cp.async of 8 bytes per thread.
// - Per tile, once the stage has landed: lane (j, p) (P lanes per step,
//   KP = N / P keys each) converts its keys' r and k of step j to f32
//   (bf16 input) and sums r u k over them in pairs, in the rotated order
//   x = (i + j + p/2) mod KP/2 that keeps the lanes' shared-memory banks
//   apart; the P partials are added by xor shuffles, lowest lane bit
//   first, into c_j. v (and a bf16 w) are converted one element per
//   thread. y of the tile stays in shared memory and is written out,
//   coalesced, while the next tile is converted.
// - Strides (b, h, s) in elements for each of r, k, v, w and y, unit
//   stride on N: the model's (B, S, H, N) projections go in as views, no
//   copies. Any S (the last tile is ragged).
// - Under grad (the backward's checkpoints): the same kernel with kCkpt
//   also stores, at the start of every tile, the state before it (each
//   thread its KPT keys x CPT columns as float4s) into ckpt (B, H,
//   ceil(S/16), N, N) f32, and the c_t it computes into cs (B, H, S) f32
//   (column block 0 only). `rwkv6_wkv_bwd.cu` rebuilds the states between
//   checkpoints from these; serving launches the instantiation without
//   the stores.
// Registers and spills: `chip_smoke.py` phase 2 prints ptxas's report for
// every instantiation (PERF.md section 6 records the N = 64 ones).
//
// Plain C interface for ctypes (no PyTorch headers): every entry point
// launches on the caller's stream, never synchronises, allocates nothing
// and returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for an N outside {4, 8, 16, 32, 64}, a size out
// of range, or a view the copies cannot address: not a multiple of 16
// bytes, 8 for N = 4 in bf16, in its base or a stride).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 16;   // steps staged per pass
constexpr int kStages = 3;  // tiles in flight: compute t while t+1, t+2 load

// Thread layout for head size N (see the header).
template <int N>
struct Layout {
  static constexpr int KPT = N == 64 ? 4 : (N >= 8 ? 8 : N);  // keys
  static constexpr int CPT = 4;               // value columns per thread
  static constexpr int G = N / KPT;           // lanes sharing a column group
  static constexpr int CB = N >= 32 ? 32 : N;  // value columns per block
  static constexpr int SPLIT = N / CB;        // blocks per (b, h)
  static constexpr int THREADS = CB / CPT * G;
  static constexpr unsigned MASK =
      THREADS >= 32 ? 0xffffffffu : (1u << THREADS) - 1u;
  static constexpr int P = THREADS > kTile ? THREADS / kTile : 1;  // c lanes
  static constexpr int KP = N / P;            // keys per c_t lane
  static_assert(KPT % 4 == 0 && KP % 4 == 0, "keys come in float4s / pairs");
  static_assert(P == 1 || THREADS == kTile * P, "one c_t lane per thread");
  static_assert(THREADS <= 32 || THREADS % 32 == 0, "whole warps");
};

template <typename T, typename TW, int N>
struct Smem {
  using L = Layout<N>;
  static constexpr bool kConvRKV = !std::is_same<T, float>::value;
  static constexpr bool kConvW = !std::is_same<TW, float>::value;
  struct __align__(128) Stage {  // one tile as copied, in the inputs' dtypes
    T r[kTile * N];
    T k[kTile * N];
    TW w[kTile * N];
    T v[kTile * L::CB];
  };
  Stage stage[kStages];
  // f32 copies of a bf16 tile (4-float placeholders where not needed)
  __align__(16) float rf[kConvRKV ? kTile * N : 4];
  __align__(16) float kf[kConvRKV ? kTile * N : 4];
  __align__(16) float vf[kConvRKV ? kTile * L::CB : 4];
  __align__(16) float wf[kConvW ? kTile * N : 4];
  __align__(16) float u[N];
  float c[kTile];
  float y[kTile * L::CB];
  unsigned long long bar[kStages];  // per stage: its TMA copies landed
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The f32 view of a staged array: the stage itself for f32 input, the
// converted copy for bf16.
template <typename X>
__device__ __forceinline__ const float* as_f32(const X* staged,
                                               const float* converted) {
  if constexpr (std::is_same<X, float>::value) {
    return staged;
  } else {
    return converted;
  }
}

// Tiles come by TMA unless a row of r and k (N keys; w is f32 or r's
// dtype, v's block columns are N or 32) is under the 16 bytes a box
// needs: N = 4 in bf16, whose rows are copied 8 bytes per thread.
template <typename T, int N>
constexpr bool kByTma = N * sizeof(T) >= 16;
constexpr int kGran = 8;  // the cp.async path's bytes per copy

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of a 4-D tensor map (N, H, S, B) into shared memory: `cols`
// columns from n0 of kTile steps from s0 of head h, batch b (steps past S
// read as zeros); the barrier's transaction count falls by the box's bytes
// when it lands.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint32_t bar, int n0, int h,
                                         int s0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(bar), "r"(n0), "r"(h), "r"(s0), "r"(b)
      : "memory");
}

// `rows` rows of `row_bytes` from global (rows `stride` bytes apart) into
// consecutive rows of shared memory, all threads of the block.
__device__ __forceinline__ void copy_rows(void* dst, const char* src,
                                          int64_t stride, int rows,
                                          int row_bytes) {
  const int per_row = row_bytes / kGran;
  char* d = static_cast<char*>(dst);
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int row = i / per_row, piece = i - row * per_row;
    cp_async8(d + row * row_bytes + piece * kGran,
              src + row * stride + piece * kGran);
  }
}

// Sum the G lanes' partial y of the thread's CNT columns (acc[0..CNT-1]),
// highest lane bit first. While a lane holds more than one column it
// keeps half of them and sends the other half (a reduce-scatter); `own`
// gains the offset of the half it keeps. At the end a lane holds
// max(1, CNT / G) columns from `own` on.
template <int G, int CNT>
__device__ __forceinline__ void reduce_cols(float* acc, int g, int& own,
                                            unsigned mask) {
  if constexpr (G > 1) {
    constexpr int lvl = G / 2;
    if constexpr (CNT > 1) {
      constexpr int half = CNT / 2;
      const bool up = (g & lvl) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = up ? acc[i] : acc[half + i];
        const float keep = up ? acc[half + i] : acc[i];
        acc[i] = keep + __shfl_xor_sync(mask, send, lvl);
      }
      if (up) own += half;
      reduce_cols<lvl, half>(acc, g, own, mask);
    } else {
      acc[0] += __shfl_xor_sync(mask, acc[0], lvl);
      reduce_cols<lvl, 1>(acc, g, own, mask);
    }
  }
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;
  void* y;
  float* ckpt;  // under grad: (B, H, ceil(S/kTile), N, N), else null
  float* cs;    // under grad: (B, H, S), else null
  int64_t r_sb, r_sh, r_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t w_sb, w_sh, w_ss;
  int64_t y_sb, y_sh, y_ss;
  int S;
};

// The tensor maps of r, k, w and v (4-D, (N, H, S, B), boxes of kTile
// steps), used when kByTma<T, N>.
struct Maps {
  CUtensorMap r, k, w, v;
};

// T: dtype of r, k, v and y; TW: dtype of w; kCkpt: also store the
// state before every tile and c_t (the backward's checkpoints).
template <typename T, typename TW, int N, bool kCkpt>
__global__ void __launch_bounds__(Layout<N>::THREADS)
    wkv_fwd(const __grid_constant__ Maps maps, Args a) {
  using L = Layout<N>;
  using Sm = Smem<T, TW, N>;
  constexpr int CB = L::CB, G = L::G, KPT = L::KPT, CPT = L::CPT;
  constexpr int P = L::P, KP = L::KP, TH = L::THREADS, KQ = KPT / 4;
  static_assert(CPT == 4, "a thread's columns are one float4 of v");
  __shared__ Sm sm;

  const int tid = threadIdx.x;
  const int h = blockIdx.x / L::SPLIT, b = blockIdx.y;
  const int col0 = (blockIdx.x % L::SPLIT) * CB;
  const char* R = static_cast<const char*>(a.r)
      + (b * a.r_sb + h * a.r_sh) * int64_t(sizeof(T));
  const char* K = static_cast<const char*>(a.k)
      + (b * a.k_sb + h * a.k_sh) * int64_t(sizeof(T));
  const char* V = static_cast<const char*>(a.v)
      + (b * a.v_sb + h * a.v_sh + col0) * int64_t(sizeof(T));
  const char* W = static_cast<const char*>(a.w)
      + (b * a.w_sb + h * a.w_sh) * int64_t(sizeof(TW));
  T* Y = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh + col0;

  for (int n = tid; n < N; n += TH) sm.u[n] = a.u[int64_t(h) * N + n];
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(smem_u32(&sm.bar[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The copy of one tile into stage `st`: by TMA, one box per array from
  // one thread (the barrier of the stage counts the bytes); for N = 4 in
  // bf16 by cp.async per thread (a group).
  auto issue = [&](int st, int t0) {
    const int len = max(0, min(kTile, a.S - t0));
    typename Sm::Stage& stg = sm.stage[st];
    constexpr int rb = N * sizeof(T), wb = N * sizeof(TW);
    constexpr int vb = CB * sizeof(T);
    const int64_t rs = a.r_ss * int64_t(sizeof(T));
    const int64_t ks = a.k_ss * int64_t(sizeof(T));
    const int64_t ws = a.w_ss * int64_t(sizeof(TW));
    const int64_t vs = a.v_ss * int64_t(sizeof(T));
    if constexpr (kByTma<T, N>) {
      if (tid == 0 && len > 0) {
        const uint32_t bar = smem_u32(&sm.bar[st]);
        // Order the block's reads of this stage (before the barrier that
        // precedes this call) before the async proxy's writes.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(bar, kTile * (2 * rb + wb + vb));
        tma_load(stg.r, &maps.r, bar, 0, h, t0, b);
        tma_load(stg.k, &maps.k, bar, 0, h, t0, b);
        tma_load(stg.w, &maps.w, bar, 0, h, t0, b);
        tma_load(stg.v, &maps.v, bar, col0, h, t0, b);
      }
    } else {
      copy_rows(stg.r, R + t0 * rs, rs, len, rb);
      copy_rows(stg.k, K + t0 * ks, ks, len, rb);
      copy_rows(stg.w, W + t0 * ws, ws, len, wb);
      copy_rows(stg.v, V + t0 * vs, vs, len, vb);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  };
  auto flush_y = [&](int t0, int len) {
    for (int i = tid; i < len * CB; i += TH)
      store(Y + int64_t(t0 + i / CB) * a.y_ss + i % CB, sm.y[i]);
  };

  // This thread: value columns cq*CPT .. +CPT-1 of the block, keys
  // n = 4 (g + G jj) + e; s[4 jj + e][c] is S[n][col0 + cq*CPT + c].
  const int cq = tid / G, g = tid % G;
  float s[KPT][CPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) s[i][c] = 0.f;

  // Tiles 0 and 1 in flight; each iteration then starts tile it+2 (a
  // cp.async group is committed for every tile, empty past the end, so
  // that "all but the newest group" is always the tile being waited for).
  issue(0, 0);
  issue(1, kTile);
  int prev_t0 = 0, prev_len = 0;
  [[maybe_unused]] const int64_t bh =
      int64_t(b) * (gridDim.x / L::SPLIT) + h;
  // Under grad: the state before tile i (checkpoint i), row n, this
  // thread's CPT columns.
  [[maybe_unused]] auto store_ckpt = [&](int i) {
    const int nt = (a.S + kTile - 1) / kTile;
    float* ck = a.ckpt + (bh * nt + i) * (N * N) + col0 + cq * CPT;
#pragma unroll
    for (int q = 0; q < KPT; ++q) {
      const int n = 4 * (g + G * (q / 4)) + q % 4;
      *reinterpret_cast<float4*>(ck + n * N) =
          make_float4(s[q][0], s[q][1], s[q][2], s[q][3]);
    }
  };
  if constexpr (kCkpt) store_ckpt(0);
  for (int t0 = 0, it = 0; t0 < a.S; t0 += kTile, ++it) {
    const int st = it % kStages;
    const int len = min(kTile, a.S - t0);
    if constexpr (kByTma<T, N>) {
      mbar_wait(smem_u32(&sm.bar[st]), (it / kStages) & 1);
    } else {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    }
    // Tile `it` has landed (every thread's copies), and tile it-1's
    // compute (which read the stage that tile it+2 now fills) is done
    // everywhere.
    __syncthreads();
    issue((it + 2) % kStages, t0 + 2 * kTile);
    flush_y(prev_t0, prev_len);
    const typename Sm::Stage& stg = sm.stage[st];

    // c_j for each step of the tile, and r, k in f32 (bf16 input). The
    // rotated pair order keeps the lanes' shared-memory banks apart.
    for (int q = tid; q < kTile * P; q += TH) {
      const int j = q / P, p = q % P;
      float cp = 0.f;
      if (j < len) {
        constexpr int H2 = KP / 2;
#pragma unroll 4
        for (int i = 0; i < H2; ++i) {
          const int x = (i + j + (p >> 1)) & (H2 - 1);
          const int n = p * KP + 2 * x;
          const float2 rv = load2(stg.r + j * N + n);
          const float2 kv = load2(stg.k + j * N + n);
          if constexpr (Sm::kConvRKV) {
            *reinterpret_cast<float2*>(sm.rf + j * N + n) = rv;
            *reinterpret_cast<float2*>(sm.kf + j * N + n) = kv;
          }
          const float2 uv = *reinterpret_cast<const float2*>(sm.u + n);
          cp = fmaf(rv.x * uv.x, kv.x, cp);
          cp = fmaf(rv.y * uv.y, kv.y, cp);
        }
      }
#pragma unroll
      for (int off = 1; off < P; off <<= 1)
        cp += __shfl_xor_sync(L::MASK, cp, off);
      if (p == 0 && j < len) {
        sm.c[j] = cp;
        if constexpr (kCkpt) {
          if (col0 == 0) a.cs[bh * a.S + t0 + j] = cp;
        }
      }
    }
    if constexpr (Sm::kConvRKV) {
      for (int i = tid; i < len * CB; i += TH) sm.vf[i] = to_f32(stg.v[i]);
    }
    if constexpr (Sm::kConvW) {
      for (int i = tid; i < len * N; i += TH) sm.wf[i] = to_f32(stg.w[i]);
    }
    __syncthreads();

    const float* rf = as_f32(stg.r, sm.rf);
    const float* kf = as_f32(stg.k, sm.kf);
    const float* wf = as_f32(stg.w, sm.wf);
    const float* vf = as_f32(stg.v, sm.vf);
    // Step j: the state update and this thread's partial y of its CPT
    // columns (acc); finish(j) sums the lanes' partials (shuffles) and
    // stores y, interleaved with the next step's FMAs.
    auto accumulate = [&](int j, float* acc) {
      const float4 v4 =
          *reinterpret_cast<const float4*>(vf + j * CB + cq * CPT);
      const float vv[CPT] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
#pragma unroll
      for (int jj = 0; jj < KQ; ++jj) {
        const int n0 = j * N + 4 * (g + G * jj);
        const float4 r4 = *reinterpret_cast<const float4*>(rf + n0);
        const float4 k4 = *reinterpret_cast<const float4*>(kf + n0);
        const float4 w4 = *reinterpret_cast<const float4*>(wf + n0);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            float& se = s[4 * jj + e][c];
            acc[c] = fmaf(rr[e], se, acc[c]);
            se = fmaf(ww[e], se, kk[e] * vv[c]);
          }
        }
      }
    };
    auto finish = [&](int j, float* acc) {
      int own = 0;
      reduce_cols<G, CPT>(acc, g, own, L::MASK);
      constexpr int kHeld = CPT > G ? CPT / G : 1;
      if (G <= CPT || (g & (G / CPT - 1)) == 0) {
        const float cj = sm.c[j];
#pragma unroll
        for (int t = 0; t < kHeld; ++t) {
          const int m = j * CB + cq * CPT + own + t;
          sm.y[m] = fmaf(cj, vf[m], acc[t]);
        }
      }
    };
    // All kTile steps, unrolled, so that the scheduler sees every step's
    // FMAs and shuffles at once. In a ragged last tile the steps past the
    // sequence's end run on what the stage holds: they change only the
    // state after the last step and rows of y that are never written out.
    float acc[2][CPT];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      accumulate(j, acc[j & 1]);
      if (j > 0) finish(j - 1, acc[(j - 1) & 1]);
    }
    finish(kTile - 1, acc[(kTile - 1) & 1]);
    if constexpr (kCkpt) {
      // Stored here, after the tile's steps: at the top of the tile,
      // before them, the stores cost three times as much.
      if (t0 + kTile < a.S) store_ckpt(it + 1);
    }
    prev_t0 = t0;
    prev_len = len;
  }
  __syncthreads();
  flush_y(prev_t0, prev_len);
}

// cuTensorMapEncodeTiled lives in the driver library; it is reached through
// the runtime's driver entry point, so the build links nothing but cudart.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map (N, H, S, B) with element strides (b, h, s) and unit stride on
// N, boxes of `cols` x 1 x kTile x 1, no swizzle (the box lands as kTile
// dense rows). TMA wants the base, every stride and the box's row at
// multiples of 16 bytes (the wrapper copies a view that is not); the
// stride of an axis of extent 1 is never followed and is replaced by a
// dense one. False if the view or the driver does not allow it.
template <typename X>
bool make_map(CUtensorMap* map, const void* ptr, int64_t sb, int64_t sh,
              int64_t ss, int N, int H, int S, int B, int cols) {
  const EncodeTiled encode = encode_tiled();
  const int64_t e = sizeof(X);
  if (encode == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0 ||
      cols * e % 16 != 0)
    return false;
  const int64_t ext[3] = {H, S, B};
  const int64_t given[3] = {sh, ss, sb};
  const int64_t dense[3] = {int64_t(N), int64_t(N) * H, int64_t(N) * H * S};
  cuuint64_t dims[4] = {cuuint64_t(N), cuuint64_t(H), cuuint64_t(S),
                        cuuint64_t(B)};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    const int64_t bytes = e * (ext[i] == 1 ? dense[i] : given[i]);
    if (bytes <= 0 || bytes % 16 != 0 || bytes >= (int64_t(1) << 40))
      return false;
    strides[i] = cuuint64_t(bytes);
  }
  cuuint32_t box[4] = {cuuint32_t(cols), 1, cuuint32_t(kTile), 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapDataType dt = std::is_same<X, float>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, dt, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// True if the base and the (b, h, s) strides of axes longer than 1 are
// multiples of `g` bytes (e bytes per element).
bool aligned(const void* p, int64_t sb, int64_t sh, int64_t ss, int B,
             int H, int S, int64_t e, int g) {
  return reinterpret_cast<uintptr_t>(p) % g == 0 &&
         (B == 1 || sb * e % g == 0) && (H == 1 || sh * e % g == 0) &&
         (S == 1 || ss * e % g == 0);
}

template <typename T, typename TW, int N, bool kCkpt>
int launch_n(Args a, int B, int H, cudaStream_t stream) {
  using L = Layout<N>;
  Maps maps{};
  if constexpr (kByTma<T, N>) {
    if (!(make_map<T>(&maps.r, a.r, a.r_sb, a.r_sh, a.r_ss, N, H, a.S, B, N)
          && make_map<T>(&maps.k, a.k, a.k_sb, a.k_sh, a.k_ss, N, H, a.S, B,
                         N)
          && make_map<TW>(&maps.w, a.w, a.w_sb, a.w_sh, a.w_ss, N, H, a.S,
                          B, N)
          && make_map<T>(&maps.v, a.v, a.v_sb, a.v_sh, a.v_ss, N, H, a.S, B,
                         L::CB)))
      return int(cudaErrorInvalidValue);
  } else {
    const int64_t e = sizeof(T), ew = sizeof(TW);
    if (!(aligned(a.r, a.r_sb, a.r_sh, a.r_ss, B, H, a.S, e, kGran)
          && aligned(a.k, a.k_sb, a.k_sh, a.k_ss, B, H, a.S, e, kGran)
          && aligned(a.v, a.v_sb, a.v_sh, a.v_ss, B, H, a.S, e, kGran)
          && aligned(a.w, a.w_sb, a.w_sh, a.w_ss, B, H, a.S, ew, kGran)))
      return int(cudaErrorInvalidValue);
  }
  const dim3 grid(H * L::SPLIT, B);
  wkv_fwd<T, TW, N, kCkpt><<<grid, L::THREADS, 0, stream>>>(maps, a);
  return int(cudaGetLastError());
}

template <typename T, typename TW, bool kCkpt>
int launch_ck(const Args& a, int B, int H, int N, cudaStream_t stream) {
  switch (N) {
    case 4: return launch_n<T, TW, 4, kCkpt>(a, B, H, stream);
    case 8: return launch_n<T, TW, 8, kCkpt>(a, B, H, stream);
    case 16: return launch_n<T, TW, 16, kCkpt>(a, B, H, stream);
    case 32: return launch_n<T, TW, 32, kCkpt>(a, B, H, stream);
    case 64: return launch_n<T, TW, 64, kCkpt>(a, B, H, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename T, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* y, void* ckpt, void* cs, const int64_t* st,
           int B, int H, int S, int N, cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || H > (1 << 24) || S < 1 ||
      (ckpt == nullptr) != (cs == nullptr))
    return int(cudaErrorInvalidValue);
  Args a{r, k, v, w, static_cast<const float*>(u), y,
         static_cast<float*>(ckpt), static_cast<float*>(cs),
         st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
         st[8], st[9], st[10], st[11], st[12], st[13], st[14], S};
  return ckpt ? launch_ck<T, TW, true>(a, B, H, N, stream)
              : launch_ck<T, TW, false>(a, B, H, N, stream);
}

}  // namespace

extern "C" {

// strides: 15 element strides, (b, h, s) of r, k, v, w, y in that order;
// the N axis of each must have unit stride. u: (H, N) f32, contiguous.
// ckpt and cs: both null (serving), or the backward's checkpoints,
// (B, H, ceil(S/16), N, N) and (B, H, S) f32, contiguous.

// r, k, v, w, y f32.
int rwkv6_wkv_f32(const void* r, const void* k, const void* v, const void* w,
                  const void* u, void* y, void* ckpt, void* cs,
                  const int64_t* strides, int B, int H, int S, int N,
                  void* stream) {
  return launch<float, float>(r, k, v, w, u, y, ckpt, cs, strides, B, H, S, N,
                              static_cast<cudaStream_t>(stream));
}

// r, k, v, y bf16; w f32 (the model's path).
int rwkv6_wkv_bf16(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* y, void* ckpt, void* cs,
                   const int64_t* strides, int B, int H, int S, int N,
                   void* stream) {
  return launch<__nv_bfloat16, float>(r, k, v, w, u, y, ckpt, cs, strides, B,
                                      H, S, N,
                                      static_cast<cudaStream_t>(stream));
}

// r, k, v, w, y bf16.
int rwkv6_wkv_bf16_wbf16(const void* r, const void* k, const void* v,
                         const void* w, const void* u, void* y, void* ckpt,
                         void* cs, const int64_t* strides, int B, int H,
                         int S, int N, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(
      r, k, v, w, u, y, ckpt, cs, strides, B, H, S, N,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
