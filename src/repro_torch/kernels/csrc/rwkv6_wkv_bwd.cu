// rwkv6_wkv_bwd: the backward of the RWKV-6 WKV recurrence, sm_90a.
//
//   forward, per (b, h), state S (N x N, f32, from zero):
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
//   backward, with G_t = dL/dS_t the adjoint of the state after step t
//   (G_{S-1} = 0) and G_{t-1} = diag(w_t) G_t + r_t dy_t^T:
//     dr_t[n] = sum_m S_{t-1}[n][m] dy_t[m] + u[n] k_t[n] (v_t . dy_t)
//     dk_t[n] = sum_m G_t[n][m] v_t[m]      + u[n] r_t[n] (v_t . dy_t)
//     dv_t[m] = sum_n G_t[n][m] k_t[n]
//               + (sum_n r_t[n] u[n] k_t[n]) dy_t[m]
//     dw_t[n] = sum_m G_t[n][m] S_{t-1}[n][m]
//     du[n]   = sum_{b,t} r_t[n] k_t[n] (v_t . dy_t)
//
//   r, k, v, w, dy: (B, H, S, N) with any (b, h, s) strides and unit stride
//   on N, each row's base and stride a multiple of min(16, N * element
//   size) bytes (the wrapper copies any other view); u: (H, N) f32. dr, dk,
//   dv come back in r's dtype, dw in w's, du (H, N) f32. r, k, v, dy share
//   one dtype, f32 or bf16; w is f32 or r's dtype (the model passes f32).
//   All arithmetic in f32.
//
// The backward of the Pallas TPU kernel `rwkv6_wkv`
// (src/repro/kernels/rwkv6_wkv.py:47, pallas_call at :64) and of this
// port's forward (`rwkv6_wkv.cu`). The JAX package has no backward kernel:
// it differentiates jnp. The oracle is jax.vjp of `rwkv6_wkv_ref`
// (src/repro/kernels/ref.py:59).
//
// Bound: operations. Per (b, h, step) the function needs the state S_{t-1}
// (3 N^2: w S, k v^T, the sum), S dy (2 N^2), the G update (3 N^2), G v
// (2 N^2), G^T k (2 N^2) and sum G (.) S (2 N^2): 14 N^2 FLOP, plus O(N).
// At the training shape (B=2, H=40, S=1024, N=64) that is 4.78e9 FLOP,
// 0.071 ms at the card's 67 TFLOP/s f32 rate, against 115 MB moved (bf16
// r, k, v, dy read and dr, dk, dv written, f32 w read and dw written: 22
// bytes per (b, h, t, n)), 0.034 ms at 3.35 TB/s. At the serve shape (B=4,
// S=4096) 3.83e10 FLOP, 0.57 ms.
//
// Design (the exact recurrences, no division by w and no cumulative decay
// products, so w = 0 forgets and w = 1 sums exactly in both directions;
// no float atomics, every sum in a fixed order, so two calls are
// bit-equal):
// - The forward kernel writes the checkpoints. Under grad, `wkv_fwd`
//   (rwkv6_wkv.cu) stores the state before each of its kChunk = 16-step
//   tiles, ckpt (B, H, ceil(S/16), N, N) f32, and c_t = sum_n r u k,
//   cs (B, H, S) f32, which it computes anyway. This file has no
//   checkpoint sweep: its rebuild of S_{t-1} from a checkpoint repeats the
//   forward's FMAs in the forward's order, so the states are the forward's
//   bit for bit.
// - wkv_bwd_rev: one cluster of SPLIT = N / CB blocks per (b, h), CB =
//   min(N, 16) value columns each (4 blocks of 16 at N = 64: 320 blocks of
//   128 threads at the training shape, three per SM by registers and
//   shared memory, so one wave on 132 SMs). A thread holds one key n and
//   CPT = min(CB, 8) columns of G and, for kHalf = 8 steps at a time, of
//   the rebuilt states S_{t-1} (64 registers); it rebuilds a chunk's
//   second half from the checkpoint through the first (24 rebuilt steps
//   per 16) rather than hold 16 states (4 steps at a time, 40 rebuilt
//   steps per 16, ran 12% slower).
// - Prefetched chunks. A chunk's rows (r, k, v, dy, w: all N keys and
//   columns, in their own dtypes), the block's columns of its checkpoint
//   and its c_t are copied by cp.async into a stage, and an mbarrier
//   (every thread arrives through cp.async.mbarrier.arrive.noinc) says
//   when they have landed. The block converts the stage once into f32
//   work rows (r, k, w of all keys, v and dy of its columns) and sums
//   v_t . dy_t over all N columns (8 lanes a step at N = 64); after that
//   pass's block barrier the stage is free, and the next chunk's copy
//   lands while this one is swept. (Converting bf16 in the step loop
//   instead ran 8% slower.) Rows past S are zero-filled: G stays 0 there
//   and nothing past S is stored.
// - Per step, a thread's dr, dk, dw partials over its columns are summed
//   over the TPK = CB / CPT lanes of its key (2 shuffles) and stored in
//   shared memory, dv's over the warp's keys by a reduce-scatter of xor
//   shuffles (8 at N = 64) and stored per warp. The bonus terms (u k vdy,
//   u r vdy, c_t dy) are added there by column block 0.
// - One cluster barrier and one block barrier per chunk. After a chunk's
//   first half, each block finishes the previous chunk: JS = 16 / SPLIT
//   of its steps for all N keys, dr, dk, dw summed over the cluster's
//   blocks in rank order through distributed shared memory and written
//   once in their dtypes; its own dv columns for all 16 steps, the warps'
//   partials summed in order. So those remote reads wait while other
//   warps sweep. The partial buffers alternate between chunks; the
//   cluster barrier at each chunk's end keeps a buffer from being
//   rewritten before every block has read it, and a last one keeps every
//   block alive until the others are done with it.
// - wkv_bwd_du (one tiny launch): du's per-(b, h) partials summed over b
//   in order.
//
// Scratch: du's partials, B*H*N f32 (the wrapper's buffer). The forward's
// checkpoints and c_t (under grad the autograd node keeps them): at the
// training shape (B=2, H=40, S=1024, N=64) 20,971,520 + 81,920 floats =
// 84.2 MB, du partials 5,120 floats; at the serve shape (B=4, S=4096)
// 167,772,160 + 655,360 + 10,240 floats. Shared memory: 73,936 bytes a
// block at N = 64 in bf16 with f32 w (the stage 16,448, the work rows
// 18,560, the partials 38,912).
// Registers and spills: `chip_smoke.py` phase 2 prints ptxas's report.
//
// Plain C interface for ctypes (no PyTorch headers): every entry point
// launches on the caller's stream, never synchronises, allocates nothing
// and returns the cudaError_t of the launches (0 on success;
// cudaErrorInvalidValue for an N outside {4, 8, 16, 32, 64}, a size out
// of range, or a scratch buffer smaller than B*H*N floats).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace cgp = cooperative_groups;

namespace {

constexpr int kChunk = 16;  // steps per checkpoint: the forward's tile
constexpr int kHalf = 8;    // states rebuilt into registers at a time
constexpr int kParts = kChunk / kHalf;
constexpr int kDuThreads = 64;

template <int N>
struct Layout {
  static constexpr int CB = N >= 16 ? 16 : N;    // value columns per block
  static constexpr int SPLIT = N / CB;           // blocks per (b, h)
  static constexpr int CPT = CB >= 8 ? 8 : CB;   // columns per thread
  static constexpr int TPK = CB / CPT;           // threads per key
  static constexpr int THREADS = N * TPK;
  static constexpr int WARP = THREADS < 32 ? THREADS : 32;  // lanes in use
  static constexpr int NW = (THREADS + 31) / 32;            // warps
  static constexpr int KW = WARP / TPK;                     // keys per warp
  static constexpr int JS = kChunk / SPLIT;  // steps each block finishes
  static constexpr int QS = N + 16;  // row stride of red (two lanes of a
                                     // key store to other banks)
  static constexpr unsigned MASK =
      THREADS >= 32 ? 0xffffffffu : (1u << THREADS) - 1u;
  static_assert(CPT % 4 == 0, "a thread's columns are float4s");
  static_assert(TPK == 1 || TPK == 2, "one or two lanes per key");
  static_assert(KW >= CPT, "the dv reduce-scatter ends at one column");
  static_assert(THREADS <= 32 || THREADS % 32 == 0, "whole warps");
  static_assert(kChunk % SPLIT == 0, "the blocks share a chunk's steps");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// CNT consecutive f32 values from shared memory into registers (CNT a
// multiple of 4).
template <int CNT>
__device__ __forceinline__ void load_cols(const float* p, float* out) {
#pragma unroll
  for (int q = 0; q < CNT / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(p)[q];
    out[4 * q] = x.x;
    out[4 * q + 1] = x.y;
    out[4 * q + 2] = x.z;
    out[4 * q + 3] = x.w;
  }
}

// One cp.async of BYTES (4, 8 or 16) into shared memory; src_bytes = 0
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

// Sum CNT values over the KW lanes (STRIDE apart per lane bit) that
// differ in `kw`, highest bit first: while a lane holds more than one
// value it keeps half and sends half (a reduce-scatter), and `own` gains
// the offset of the half it keeps; then the remaining bits are summed in
// full. At the end acc[0 .. max(1, CNT / KW) - 1] are the sums of values
// own, own + 1, ..., held by every lane whose bits below those used for
// the scatter differ.
template <int KW, int CNT, int STRIDE>
__device__ __forceinline__ void reduce_keys(float* acc, int kw, int& own,
                                            unsigned mask) {
  if constexpr (KW > 1) {
    constexpr int lvl = KW / 2;
    if constexpr (CNT > 1) {
      constexpr int half = CNT / 2;
      const bool up = (kw & lvl) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = up ? acc[i] : acc[half + i];
        const float keep = up ? acc[half + i] : acc[i];
        acc[i] = keep + __shfl_xor_sync(mask, send, lvl * STRIDE);
      }
      if (up) own += half;
      reduce_keys<lvl, half, STRIDE>(acc, kw, own, mask);
    } else {
      acc[0] += __shfl_xor_sync(mask, acc[0], lvl * STRIDE);
      reduce_keys<lvl, 1, STRIDE>(acc, kw, own, mask);
    }
  }
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;
  const void* dy;
  const float* ckpt;  // (B, H, nch, N, N): the state before each chunk
  const float* cs;    // (B, H, S): c_t = sum_n r u k
  void* dr;
  void* dk;
  void* dv;
  void* dw;
  float* du;
  float* dupart;  // (B, H, N)
  // (b, h, s) element strides of r, k, v, w, dy, dr, dk, dv, dw
  int64_t st[9][3];
  int B, H, S;
};

enum { kR, kK, kV, kW, kDY, kDR, kDK, kDV, kDW };

// One chunk as copied: the steps' rows in their dtypes, the block's
// columns of the checkpoint, c_t.
template <typename T, typename TW, int N>
struct __align__(16) Stage {
  T r[kChunk * N];
  T k[kChunk * N];
  T v[kChunk * N];
  T dy[kChunk * N];
  TW w[kChunk * N];
  float ck[N * Layout<N>::CB];
  float c[kChunk];
};

// The chunk the steps read, in f32: r, k, w of all N keys, v and dy of
// the block's CB columns, the checkpoint, c_t and v_t . dy_t.
template <int N>
struct __align__(16) Work {
  float r[kChunk * N];
  float k[kChunk * N];
  float w[kChunk * N];
  float v[kChunk * Layout<N>::CB];
  float dy[kChunk * Layout<N>::CB];
  float ck[N * Layout<N>::CB];
  float c[kChunk];
  float vdy[kChunk];
};

template <typename T, typename TW, int N>
struct Smem {
  using L = Layout<N>;
  Stage<T, TW, N> stage;
  Work<N> work;
  // per chunk parity and step: dr, dk, dw summed over the block's columns
  float red[2][kChunk][3][L::QS];
  // per chunk parity and step: dv summed over each warp's keys
  float dvp[2][kChunk][L::NW][L::CB];
  unsigned long long bar;
};

// 4 values from shared memory into a float4 (8 bytes of bf16 or 16 of
// f32).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Rows c0 .. c0 + kChunk - 1 of one (b, h) of a (B, H, S, N) array into
// dst (kChunk dense rows), zeros past S; every thread of the block.
template <typename X, int N, int THREADS>
__device__ __forceinline__ void copy_rows(X* dst, const void* base,
                                          int64_t sb, int64_t sh, int64_t ss,
                                          int b, int h, int c0, int S) {
  constexpr int RB = N * int(sizeof(X));
  constexpr int G = RB < 16 ? RB : 16;
  constexpr int P = RB / G;
  const X* src0 = static_cast<const X*>(base) + b * sb + h * sh;
  for (int i = threadIdx.x; i < kChunk * P; i += THREADS) {
    const int j = i / P, p = i % P, t = c0 + j;
    const bool in = t < S;
    const char* src = reinterpret_cast<const char*>(
        src0 + (in ? int64_t(t) * ss : 0)) + p * G;
    cp_async<G>(reinterpret_cast<char*>(dst) + j * RB + p * G, src,
                in ? G : 0);
  }
}

// The reverse sweep: all five gradients' per-(b, h) parts.
template <typename T, typename TW, int N>
__global__ void __launch_bounds__(Layout<N>::THREADS, 3)
    wkv_bwd_rev(const Args a) {
  using L = Layout<N>;
  using Sm = Smem<T, TW, N>;
  constexpr int CPT = L::CPT, TPK = L::TPK, KW = L::KW, CB = L::CB;
  constexpr int TH = L::THREADS, QS = L::QS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);
  Work<N>& wk = sm.work;
  cgp::cluster_group cluster = cgp::this_cluster();

  const int tid = threadIdx.x;
  const int split = int(cluster.block_rank()), h = blockIdx.y, b = blockIdx.z;
  const int n = tid / TPK, cg = tid % TPK;
  const int warp = tid / 32, lane = tid % L::WARP, kw = lane / TPK;
  const int lc = cg * CPT;  // the thread's first column within the block
  const int nch = (a.S + kChunk - 1) / kChunk;
  const int64_t bh = int64_t(b) * a.H + h;
  const float un = a.u[int64_t(h) * N + n];
  const uint32_t bar = tc::smem_u32(&sm.bar);

  if (tid == 0) {
    tc::mbar_init(bar, TH);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The barrier is initialised, and every block of the cluster runs
  // before any reads another's shared memory.
  cluster.sync();

  // Chunk nch - 1 - it into the stage; every thread copies its pieces
  // and arrives on the barrier when they have landed.
  auto issue = [&](int it) {
    const int ci = nch - 1 - it, c0 = ci * kChunk;
    auto& stg = sm.stage;
    copy_rows<T, N, TH>(stg.r, a.r, a.st[kR][0], a.st[kR][1],
                        a.st[kR][2], b, h, c0, a.S);
    copy_rows<T, N, TH>(stg.k, a.k, a.st[kK][0], a.st[kK][1],
                        a.st[kK][2], b, h, c0, a.S);
    copy_rows<T, N, TH>(stg.v, a.v, a.st[kV][0], a.st[kV][1],
                        a.st[kV][2], b, h, c0, a.S);
    copy_rows<T, N, TH>(stg.dy, a.dy, a.st[kDY][0], a.st[kDY][1],
                        a.st[kDY][2], b, h, c0, a.S);
    copy_rows<TW, N, TH>(stg.w, a.w, a.st[kW][0], a.st[kW][1],
                         a.st[kW][2], b, h, c0, a.S);
    constexpr int CKP = CB / 4;  // 16-byte pieces per checkpoint row
    const float* ck = a.ckpt + (bh * nch + ci) * (N * N) + split * CB;
    for (int i = tid; i < N * CKP; i += TH) {
      const int row = i / CKP, p = i % CKP;
      cp_async<16>(&stg.ck[row * CB + 4 * p], ck + row * N + 4 * p, 16);
    }
    for (int i = tid; i < kChunk; i += TH) {
      const int t = c0 + i;
      cp_async<4>(&stg.c[i], a.cs + bh * a.S + (t < a.S ? t : 0),
                  t < a.S ? 4 : 0);
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(bar) : "memory");
  };

  // The landed chunk into f32 work rows, and v_t . dy_t over all N
  // columns (P lanes per step, summed by xor shuffles).
  auto convert = [&]() {
    const auto& stg = sm.stage;
    for (int i = tid; i < kChunk * N / 4; i += TH) {
      reinterpret_cast<float4*>(wk.r)[i] = load4(stg.r + 4 * i);
      reinterpret_cast<float4*>(wk.k)[i] = load4(stg.k + 4 * i);
      reinterpret_cast<float4*>(wk.w)[i] = load4(stg.w + 4 * i);
    }
    for (int i = tid; i < kChunk * CB / 4; i += TH) {
      const int j = i / (CB / 4), q = i % (CB / 4);
      const int src = j * N + split * CB + 4 * q;
      reinterpret_cast<float4*>(wk.v)[i] = load4(stg.v + src);
      reinterpret_cast<float4*>(wk.dy)[i] = load4(stg.dy + src);
    }
    for (int i = tid; i < N * CB / 4; i += TH)
      reinterpret_cast<float4*>(wk.ck)[i] = load4(stg.ck + 4 * i);
    for (int i = tid; i < kChunk; i += TH) wk.c[i] = stg.c[i];
    constexpr int P = TH >= kChunk ? TH / kChunk : 1;
    for (int q = tid; q < kChunk * P; q += TH) {
      const int j = q / P, p = q % P;
      float acc = 0.f;
      for (int m = p; m < N; m += P)
        acc = fmaf(to_f32(stg.v[j * N + m]), to_f32(stg.dy[j * N + m]), acc);
#pragma unroll
      for (int o = 1; o < P; o <<= 1)
        acc += __shfl_xor_sync(L::MASK, acc, o);
      if (p == 0) wk.vdy[j] = acc;
    }
  };

  // The state after step j - 1 of the chunk: s advanced by step j.
  auto advance = [&](float* s, int j) {
    const float kn = wk.k[j * N + n], wn = wk.w[j * N + n];
    float vv[CPT];
    load_cols<CPT>(wk.v + j * CB + lc, vv);
#pragma unroll
    for (int c = 0; c < CPT; ++c) s[c] = fmaf(wn, s[c], kn * vv[c]);
  };

  float g[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) g[c] = 0.f;
  float du_acc = 0.f;

  // Steps part*kHalf .. +kHalf - 1 of the chunk, backwards: the states
  // rebuilt from the checkpoint into registers, then the adjoint walked
  // back; the partials of dr, dk, dw and dv into red[buf] and dvp[buf].
  auto sweep = [&](int part, int buf) {
    float s[CPT];
    load_cols<CPT>(wk.ck + n * CB + lc, s);
#pragma unroll 1
    for (int j = 0; j < part * kHalf; ++j) advance(s, j);
    float sp[kHalf][CPT];
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) sp[jj][c] = s[c];
      advance(s, part * kHalf + jj);
    }
#pragma unroll
    for (int jj = kHalf - 1; jj >= 0; --jj) {
      const int j = part * kHalf + jj;
      const float rn = wk.r[j * N + n], kn = wk.k[j * N + n];
      const float wn = wk.w[j * N + n];
      float vv[CPT], dd[CPT];
      load_cols<CPT>(wk.v + j * CB + lc, vv);
      load_cols<CPT>(wk.dy + j * CB + lc, dd);
      float pr = 0.f, pk = 0.f, pw = 0.f, gv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        pr = fmaf(sp[jj][c], dd[c], pr);
        pk = fmaf(g[c], vv[c], pk);
        pw = fmaf(g[c], sp[jj][c], pw);
        gv[c] = g[c] * kn;
        g[c] = fmaf(wn, g[c], rn * dd[c]);
      }
      const float vdy = wk.vdy[j];
      float* red = &sm.red[buf][j][0][0];
      if constexpr (TPK == 2) {
        // lane cg 0 ends with dr's sum, lane 1 with dk's; both with dw's
        const bool hi = cg != 0;
        float x = (hi ? pk : pr) + __shfl_xor_sync(L::MASK, hi ? pr : pk, 1);
        pw += __shfl_xor_sync(L::MASK, pw, 1);
        if (split == 0) x = fmaf(un * (hi ? rn : kn), vdy, x);
        red[(hi ? QS : 0) + n] = x;
        if (!hi) red[2 * QS + n] = pw;
      } else {
        if (split == 0) {
          pr = fmaf(un * kn, vdy, pr);
          pk = fmaf(un * rn, vdy, pk);
        }
        red[n] = pr;
        red[QS + n] = pk;
        red[2 * QS + n] = pw;
      }
      if (split == 0 && cg == 0) du_acc = fmaf(rn * kn, vdy, du_acc);
      int own = 0;
      reduce_keys<KW, CPT, TPK>(gv, kw, own, L::MASK);
      if ((kw & (KW / CPT - 1)) == 0) {
        const int m = lc + own;  // column within the block
        float x = gv[0];
        if (warp == 0) x = fmaf(wk.c[j], wk.dy[j * CB + m], x);
        sm.dvp[buf][j][warp][m] = x;
      }
    }
  };

  // Chunk `it`'s outputs: dr, dk, dw of steps split*JS .. +JS - 1, all N
  // keys, the cluster's partials summed in rank order; dv of the block's
  // columns, all the chunk's steps, the warps' partials summed in order.
  auto finish = [&](int it) {
    const int c0 = (nch - 1 - it) * kChunk, buf = it & 1;
    for (int i = tid; i < L::JS * N; i += TH) {
      const int j = split * L::JS + i / N, nn = i % N, t = c0 + j;
      if (t >= a.S) continue;
      float sr = 0.f, sk = 0.f, sw = 0.f;
#pragma unroll
      for (int p = 0; p < L::SPLIT; ++p) {
        const float* rp = cluster.map_shared_rank(&sm.red[buf][j][0][0], p);
        sr += rp[nn];
        sk += rp[QS + nn];
        sw += rp[2 * QS + nn];
      }
      store(static_cast<T*>(a.dr) + b * a.st[kDR][0] + h * a.st[kDR][1]
                + t * a.st[kDR][2] + nn, sr);
      store(static_cast<T*>(a.dk) + b * a.st[kDK][0] + h * a.st[kDK][1]
                + t * a.st[kDK][2] + nn, sk);
      store(static_cast<TW*>(a.dw) + b * a.st[kDW][0] + h * a.st[kDW][1]
                + t * a.st[kDW][2] + nn, sw);
    }
    for (int i = tid; i < kChunk * CB; i += TH) {
      const int j = i / CB, m = i % CB, t = c0 + j;
      if (t >= a.S) continue;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < L::NW; ++q) acc += sm.dvp[buf][j][q][m];
      store(static_cast<T*>(a.dv) + b * a.st[kDV][0] + h * a.st[kDV][1]
                + t * a.st[kDV][2] + split * CB + m, acc);
    }
  };

  issue(0);
  for (int it = 0; it < nch; ++it) {
    tc::mbar_wait(bar, it & 1);
    convert();
    // The work rows are everyone's, and the stage is free: the next
    // chunk's copy lands while this one is swept.
    __syncthreads();
    if (it + 1 < nch) issue(it + 1);
    sweep(kParts - 1, it & 1);
    // The last chunk's outputs, after this chunk's first part: their
    // reads of the other blocks' partials wait while other warps sweep.
    if (it > 0) finish(it - 1);
#pragma unroll 1
    for (int part = kParts - 2; part >= 0; --part) sweep(part, it & 1);
    // Every block's partials of this chunk are stored, every block has
    // finished the chunk before (whose buffers the next chunk reuses),
    // and this block is done with the work rows.
    cluster.sync();
  }
  finish(nch - 1);
  // No block leaves while another may still read its partials.
  cluster.sync();
  if (split == 0 && cg == 0) a.dupart[bh * N + n] = du_acc;
}

// du: the per-(b, h) partials summed over b in order.
__global__ void __launch_bounds__(kDuThreads)
    wkv_bwd_du(const float* dupart, float* du, int B, int H, int N) {
  const int h = blockIdx.x;
  for (int n = threadIdx.x; n < N; n += kDuThreads) {
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += dupart[(int64_t(b) * H + h) * N + n];
    du[int64_t(h) * N + n] = s;
  }
}

template <typename T, typename TW, int N>
int launch_n(const Args& a, int64_t n_scratch, cudaStream_t stream) {
  using L = Layout<N>;
  if (n_scratch < int64_t(a.B) * a.H * N) return int(cudaErrorInvalidValue);
  constexpr int smem = int(sizeof(Smem<T, TW, N>));
  auto kernel = wkv_bwd_rev<T, TW, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L::SPLIT, a.H, a.B);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L::SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return int(err);
  wkv_bwd_du<<<a.H, kDuThreads, 0, stream>>>(a.dupart, a.du, a.B, a.H, N);
  return int(cudaGetLastError());
}

template <typename T, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* dy, const void* ckpt, const void* cs,
           void* dr, void* dk, void* dv, void* dw, void* du, void* scratch,
           int64_t n_scratch, const int64_t* strides, int B, int H, int S,
           int N, cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || S < 1)
    return int(cudaErrorInvalidValue);
  Args a{};
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = w;
  a.u = static_cast<const float*>(u);
  a.dy = dy;
  a.ckpt = static_cast<const float*>(ckpt);
  a.cs = static_cast<const float*>(cs);
  a.dr = dr;
  a.dk = dk;
  a.dv = dv;
  a.dw = dw;
  a.du = static_cast<float*>(du);
  a.dupart = static_cast<float*>(scratch);
  for (int i = 0; i < 9; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  a.B = B;
  a.H = H;
  a.S = S;
  switch (N) {
    case 4:
      return launch_n<T, TW, 4>(a, n_scratch, stream);
    case 8:
      return launch_n<T, TW, 8>(a, n_scratch, stream);
    case 16:
      return launch_n<T, TW, 16>(a, n_scratch, stream);
    case 32:
      return launch_n<T, TW, 32>(a, n_scratch, stream);
    case 64:
      return launch_n<T, TW, 64>(a, n_scratch, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// ckpt: (B, H, ceil(S/16), N, N) f32 and cs: (B, H, S) f32, contiguous,
// as the forward kernel writes them under grad. strides: 27 int64, the
// (b, h, s) element strides of r, k, v, w, dy, dr, dk, dv, dw in that
// order. scratch: n_scratch >= B*H*N f32 (du's partials).

// r, k, v, w, dy, dr, dk, dv, dw f32.
int rwkv6_wkv_bwd_f32(const void* r, const void* k, const void* v,
                      const void* w, const void* u, const void* dy,
                      const void* ckpt, const void* cs, void* dr, void* dk,
                      void* dv, void* dw, void* du, void* scratch,
                      int64_t n_scratch, const int64_t* strides, int B,
                      int H, int S, int N, void* stream) {
  return launch<float, float>(r, k, v, w, u, dy, ckpt, cs, dr, dk, dv, dw,
                              du, scratch, n_scratch, strides, B, H, S, N,
                              static_cast<cudaStream_t>(stream));
}

// r, k, v, dy, dr, dk, dv bf16; w, dw f32 (the model's path).
int rwkv6_wkv_bwd_bf16(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* dy,
                       const void* ckpt, const void* cs, void* dr, void* dk,
                       void* dv, void* dw, void* du, void* scratch,
                       int64_t n_scratch, const int64_t* strides, int B,
                       int H, int S, int N, void* stream) {
  return launch<__nv_bfloat16, float>(
      r, k, v, w, u, dy, ckpt, cs, dr, dk, dv, dw, du, scratch, n_scratch,
      strides, B, H, S, N, static_cast<cudaStream_t>(stream));
}

// everything bf16 but u, du, the checkpoints and c_t.
int rwkv6_wkv_bwd_bf16_wbf16(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* dy,
                             const void* ckpt, const void* cs, void* dr,
                             void* dk, void* dv, void* dw, void* du,
                             void* scratch, int64_t n_scratch,
                             const int64_t* strides, int B, int H, int S,
                             int N, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(
      r, k, v, w, u, dy, ckpt, cs, dr, dk, dv, dw, du, scratch, n_scratch,
      strides, B, H, S, N, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
