// flash_attention_bwd: the backward of causal / sliding-window GQA
// attention, sm_90a.
//
//   q, dq: (B, H, Sq, D); k, dk: (B, Hkv, Sk, D); v, dv: (B, Hkv, Sk, Dv);
//   o, do: (B, H, Sq, Dv); lse: (B, H, Sq) f32 from the forward
//   (flash_attention.cu); G = H / Hkv. (D, Dv) is a pair of the forward's
//   table: (D, D) for D in {8, 16, 32, 64, 128}, MLA's (96, 64) and the
//   reduced MLA's (24, 16). The scale is 1/sqrt(D), q·k's width.
//   f32 or bf16 in and out; scores, probabilities and sums in f32.
//   mask: k_pos < Sk; causal q_pos >= k_pos; window q_pos - k_pos < W.
//
// Per (b, h), with S = Q·Kᵀ and the masked entries' P set to 0:
//   P   = exp(S·scale − lse)            Δ_i = Σ_d dO_id·O_id
//   dV  = Pᵀ·dO                         dP  = dO·Vᵀ
//   dS  = P ⊙ (dP − Δ)                  dQ  = scale·dS·K
//   dK  = scale·dSᵀ·Q
// and dK, dV of KV head g are summed over the query heads h with
// h / G == g.
//
// The gradient of the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:87, pallas_call at :119). The JAX
// package has no backward kernel: it trains through jax.grad of the
// blockwise jnp analogue (src/repro/models/attention.py:83-136), whose
// dense oracle is `flash_attention_ref` (src/repro/kernels/ref.py:18).
// Rows that see no key at all (only possible without the causal mask,
// under a window, with Sq > Sk + W) get zero gradients; the model never
// makes them (every causal row sees its own position).
//
// Bound: operations. Per visible (q, k) pair the function does 6D + 4Dv
// FLOP (QKᵀ again, dP, dV, dK, dQ against the forward's 2(D + Dv)): at
// D = Dv 2.5x the forward's, 2.1496e10 FLOP at the training shape (B=2,
// H=16, Hkv=8, S=1024, D=128, causal), 0.0217 ms at the card's 989
// TFLOP/s bf16 rate, and 6.874e11 FLOP at the serving prefill shape
// (B=4, S=4096), 0.695 ms; the bytes (q, k, v, o, dO in, dq, dk, dv out)
// take a tenth of that. MLA's (96, 64), 832 FLOP a pair: 3.4931e10 FLOP
// at its training shape (B=2, H=Hkv=40, S=1024), 0.0353 ms, and
// 1.1170e12 at its prefill shape (B=4, S=4096), 1.1294 ms. Measured (chip_smoke.py phase 23
// and launch/flash_bwd_time.py, NVIDIA H100 80GB HBM3, power limit
// 700 W, device time): the tc variant 0.106 ms at the training shape and
// 2.12-2.14 ms at serve, SDPA's backward 0.12 and 1.51 ms; the SIMT
// kernels took 1.98-1.99 and 41.1-41.4 ms there.
//
// Two variants, chosen in one place (variant_for, by dtype and D, the
// forward's rule; kernel_variant() in flash_attention.py mirrors it), each
// one C call that enqueues three kernels on the caller's stream:
//
// tc: bf16 with D in {16, 32, 64, 96, 128} (D a multiple of wgmma's k16),
// on the tensor cores (wgmma, TMA). The training path (bf16, D = 128;
// MLA's (96, 64)) runs it. Each kernel is templated on (D, Dv): Q and K
// tiles are D wide and V, O and dO tiles Dv wide, each rounded up to
// whole 64-column TMA chunks whose columns past the width arrive as
// zeros. At (96, 64) Q and K take two chunks (the second half zero, never
// read by Sᵀ = K·Qᵀ's 6 k16 steps), V and dO one (dPᵀ = V·dOᵀ, 4 steps);
// dV += Pᵀ·dO is n64. dK += dSᵀ·Q and dQ += dS·K run n128 over Q's and
// K's zero half: wgmma's MN-major B in the 128-byte swizzle comes in
// whole 64-column atoms, so n96 does not lay out. That multiplies 32
// zero columns (12D + 8Dv + 256 = 1920 FLOP a pair issued against the
// design's 1664), and the epilogues store columns below D only.
// - flash_bwd_prep: one warp per row writes lse·log2(e) and
//   Δ = rowsum(dO ⊙ O) over Dv into an f32 scratch of (B, H, Sq) rows
//   padded to 128 (zeros past Sq), so that a tile's 64 rows are one
//   256-byte bulk copy from an aligned address.
// - flash_bwd_dkdv_tc: one block of 384 threads per (64-key tile, KV
//   head g, batch): a producer warpgroup (24 registers, setmaxnreg) whose
//   one thread issues the TMA loads, and two consumer warpgroups (240).
//   K and V arrive once; then the block walks the G query heads of g and,
//   for each, the 64-row query tiles that can see a key of the block (the
//   causal and window bounds); Q and dO tiles with their lse and Δ stream
//   through a ring of four stages, and the two groups take every other
//   tile, each summing its own dK and dV of the block's 64 keys. At the
//   end group 1's sums pass through shared memory into group 0's (a fixed
//   order: reproducible), which stores them. Computed transposed, so that
//   every product after the first two takes its A operand from registers:
//     Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ     wgmma m64n64k16, both operands K-major
//                                in shared memory (SS), D/16 steps;
//     Pᵀ = exp2(Sᵀ·scale·log2e − lse·log2e), 0 where masked;
//     dSᵀ = Pᵀ ⊙ (dPᵀ − Δ);
//     dV += Pᵀ·dO, dK += dSᵀ·Q    wgmma m64n{64,128}k16, A from registers
//                                (the accumulator's layout is the A
//                                fragment's), B = dO or Q MN-major
//                                (transpose bit), 4 steps.
//   dK and dV stay in registers (each element has one writer: no
//   atomics); dK is scaled at the store, bf16 pairs into the strided
//   outputs. Shared memory: 163 KB at D = 128 (D <= 64 pads to 64: 83
//   KB; (96, 64): 123 KB), one block per SM. Key tiles vary slowest in the launch order, so
//   the longest causal blocks (the first keys) start first: at the
//   training shape (B=2, Hkv=8, S=1024) the 256 blocks are two waves, and
//   with 128-key blocks (both groups on one tile) the first key tile's
//   block alone set the kernel's time (its 32 tiles against a mean of
//   18).
// - flash_bwd_dq_tc: one block per (128-row query tile, query head,
//   batch), query tiles slowest in the launch order and last first, so
//   the long causal rows start early: the same three warpgroups, Q and dO
//   resident, 128-key K and V
//   tiles through a ring of two stages, lse and Δ of the thread's two
//   rows in registers (193 KB of shared memory at D = 128, 145 KB at
//   (96, 64)). Per key tile:
//   S = Q·Kᵀ and dP = dO·Vᵀ (SS, n128), P and dS in registers,
//   dQ += dS·K (RS, K MN-major). It recomputes S and dP rather than
//   accumulate dQ by atomics in the dK/dV kernel: 3.5x the forward's FLOP
//   instead of 2.5x, but each dQ element has one writer and the result is
//   bit-reproducible (chip_smoke.py phase 23 requires autograd through
//   FlashAttentionFn to be bit-equal to the kernel called directly).
// Numerics: S, dP, the exponentials, dS and every sum are f32, as in the
// plain version; the products' A operands must be bf16. P and dS rounded
// once to bf16 move each term by up to 2^-9 of itself, and near the start
// of a causal sequence (rows of few keys, large P) that reaches gradients
// near 0 past the bf16 tolerance that phase 23 holds the kernel to, on
// every tile and not only on those that cross a mask edge (the CPU test
// tests/test_torch_flash_backward_tc.py emulates each rounding). So P and
// dS go in as two bf16 fragments, hi = bf16(x) and lo = bf16(x − hi), two
// products each, exact to ~2^-17 of the term: dV, dK and dQ take two RS
// products each, 5x the forward's FLOP in all.
// Pipelining: the two consumer groups overlap each other's exponentials
// with their products. Within a group, on a tile that crosses no mask
// edge, P is computed while dP is still on the tensor cores; a tile that
// crosses a mask edge (the causal diagonal, a window's edge, ragged Sq or
// Sk) waits for both products before the masked exponentials. Then P and
// dS are split and the RS products go out as one group. No wgmma is in
// flight across a branch, and each D has its own instantiation (ptxas
// would serialise the wgmmas otherwise).
// Registers: a dK/dV consumer thread holds dK and dV (128 f32 at
// D = 128, 96 at (96, 64)) and Pᵀ and dSᵀ (64), at the 240 that
// setmaxnreg gives it, so
// its loop carries one counter, and dK's products are issued with dV's
// (issued while dV's ran, ptxas serialised them). ptxas reports 0 spills
// for every tc kernel.
// TMA wants 16-byte aligned bases and strides (and the pre-pass reads o
// and dO rows 8 bytes at a time): the wrapper copies a q, k, v, o or dO
// view that misses that to a contiguous tensor first.
//
// simt: f32 (whose tensor-core path would be TF32, which the port does not
// use) at every pair, and bf16 at D in {8, 24} (not a multiple of wgmma's
// k16 depth: (8, 8) and the reduced MLA's (24, 16)), f32 FMAs on the CUDA
// cores, the backward's first design, templated on (D, Dv): the Q and K
// tiles, dQ and dK are D wide, the V and dO tiles, dV and Δ Dv wide.
// - flash_bwd_delta: Δ = rowsum(dO ⊙ O) over Dv into the f32 scratch as
//   (B, H, Sq); one warp per row.
// - flash_bwd_dkdv: one block of 256 threads per (64-key tile, KV head g,
//   batch). K and V tiles stay in shared memory; the block loops over the
//   group's G query heads and, for each, over the 64-row query tiles that
//   can see the key tile (causal and window bounds), accumulating dK and
//   dV in registers: no atomics, one writer per dK/dV element.
// - flash_bwd_dq: one block per (64-row query tile, query head, batch),
//   tiles launched last-first so the long causal rows start early; Q, dO,
//   lse and Δ stay in shared memory, the block loops over the reachable
//   key tiles and accumulates dQ in registers.
// Tiles sit row-major in shared memory as f32 (converted once at load)
// with a pitch of width + 4 floats, so float4 reads of 8 neighbouring rows
// hit distinct banks. Each thread computes the 16 scores S[ty + 16i][tx +
// 16j] (i, j < 4) and the same 16 of dP from float4 reads; P and dS go
// through shared memory to the products that contract over rows (dV, dK)
// or keys (dQ), where a thread owns 4 rows and a column group of each
// output (Cols<W>: float4 groups for W a multiple of 64, else columns
// tx + 16j, the last group partial for W = 24: tx < 8). Shared memory at
// D = 128: 4 tiles of 64 x 132 floats + two 64 x 68 tiles = 166.5 KB, one
// block per SM (121 KB at (96, 64)). Its ceiling is the 67 TFLOP/s f32
// rate.
//
// Plain C interface for ctypes (no PyTorch headers): the entry points
// launch on the caller's stream, never synchronise, allocate nothing (the
// wrapper passes the f32 scratch, bwd_scratch_floats() floats in
// flash_attention.py) and return the first cudaError_t of the three
// launches (0 on success; cudaErrorInvalidValue for a (D, Dv) pair
// outside the table, H % Hkv != 0, a size out of range, a scratch too
// small, or a tensor the tensor maps cannot address). No pair falls back
// to another variant.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace {

constexpr int kBlock = 64;               // query rows and keys per tile
constexpr int kThreads = 256;            // 16 x 16
constexpr int kPPitch = kBlock + 4;      // pitch of the P and dS tiles

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Element strides (b, h, s) of each tensor; D has unit stride.
enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kTensors };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int64_t st[kTensors][3];
  int B, H, Hkv, Sq, Sk;
  int causal;
  int window;                            // <= 0: no window
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* slice(const Args& a, int t, const void* p,
                                          int b, int h) {
  return static_cast<const T*>(p) + b * a.st[t][0] + h * a.st[t][1];
}

// Columns of a 64 x D accumulator a thread owns (rows are ty + 16 i):
// D a multiple of 64 as float4 groups at 4*tx + 64*g; else single
// columns tx + 16*j, below D (the last group partial for D in {8, 24}).
template <int D>
struct Cols {
  static constexpr bool kVec = D % 64 == 0;
  static constexpr int kN = kVec ? D / 16 : (D + 15) / 16;
  __device__ static __forceinline__ int col(int tx, int j) {
    return kVec ? 4 * tx + 64 * (j / 4) + (j % 4) : tx + 16 * j;
  }
};

// Rows [s0, s0 + 64) of a (S, D) slice into shared memory as f32,
// row-major with pitch D + 4, zero past S.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          int64_t s_stride, int s0, int S) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = s0 + r;
    dst[r * (D + 4) + d] =
        s < S ? to_f32(src[int64_t(s) * s_stride + d]) : 0.f;
  }
}

// acc[i][j] = Σ_d A[ty + 16i][d] · B[tx + 16j][d] over two row-major
// tiles in shared memory (pitch D + 4).
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A,
                                         const float* B, int tx, int ty) {
  constexpr int P = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * P + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * P + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// acc[i][c] += Σ_r W[r][ty + 16i] · X[r][col(tx, c)] over the 64 rows r of
// a 64 x 64 weight tile W (pitch kPPitch) and a row-major 64 x D tile X
// (pitch D + 4); with `transposed`, W[ty + 16i][r] instead.
template <int D, bool kTransposed>
__device__ __forceinline__ void tile_accumulate(float (&acc)[4][Cols<D>::kN],
                                                const float* W,
                                                const float* X, int tx,
                                                int ty) {
  using C = Cols<D>;
  constexpr int P = D + 4;
#pragma unroll 4
  for (int r = 0; r < kBlock; ++r) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = kTransposed ? W[(ty + 16 * i) * kPPitch + r]
                         : W[r * kPPitch + ty + 16 * i];
    const float* xrow = X + r * P;
    if constexpr (C::kVec) {
#pragma unroll
      for (int g = 0; g < C::kN / 4; ++g) {
        const float4 xv = *reinterpret_cast<const float4*>(xrow + 4 * tx +
                                                           64 * g);
        const float xe[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][4 * g + e] = fmaf(w[i], xe[e], acc[i][4 * g + e]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < C::kN; ++j) {
        const int c = C::col(tx, j);
        const float xv = c < D ? xrow[c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(w[i], xv, acc[i][j]);
      }
    }
  }
}

// P and dS of one (query tile q0, key tile k0) pair from the scores s and
// dP of this thread's 16 entries, written to shared memory ([row][key],
// pitch kPPitch). Masked entries, rows past Sq and keys past Sk get 0.
__device__ __forceinline__ void p_and_ds(const float (&s)[4][4],
                                         const float (&dp)[4][4],
                                         const float* lse_s,
                                         const float* delta_s, float* Ps,
                                         float* dSs, int q0, int k0, int tx,
                                         int ty, const Args& a) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qp = q0 + r;
    const float L = lse_s[r], dl = delta_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, kp = k0 + c;
      bool ok = qp < a.Sq && kp < a.Sk;
      if (a.causal) ok = ok && qp >= kp;
      if (a.window > 0) ok = ok && qp - kp < a.window;
      const float p = ok ? expf(s[i][j] * a.scale - L) : 0.f;
      if (Ps != nullptr) Ps[r * kPPitch + c] = p;
      dSs[r * kPPitch + c] = p * (dp[i][j] - dl);
    }
  }
}

// lse and Δ of rows [q0, q0 + 64) of head (b, h) into shared memory.
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const Args& a, int b, int h,
                                               int q0) {
  if (threadIdx.x < kBlock) {
    const int s = q0 + threadIdx.x;
    const int64_t row = (int64_t(b) * a.H + h) * a.Sq + s;
    lse_s[threadIdx.x] = s < a.Sq ? a.lse[row] : 0.f;
    delta_s[threadIdx.x] = s < a.Sq ? a.delta[row] : 0.f;
  }
}

template <typename T, int DV>
__global__ void flash_bwd_delta(Args a) {
  const int64_t row =
      int64_t(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= int64_t(a.B) * a.H * a.Sq) return;
  const int s = int(row % a.Sq);
  const int h = int((row / a.Sq) % a.H);
  const int b = int(row / (int64_t(a.Sq) * a.H));
  const T* O = slice<T>(a, kO, a.o, b, h) + int64_t(s) * a.st[kO][2];
  const T* dO = slice<T>(a, kDO, a.dout, b, h) + int64_t(s) * a.st[kDO][2];
  float acc = 0.f;
  for (int d = lane; d < DV; d += 32)      // o and dO are Dv wide
    acc = fmaf(to_f32(dO[d]), to_f32(O[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[row] = acc;
}

// Q and K tiles have pitch D + 4, dO and V tiles Dv + 4.
template <int D, int DV>
constexpr size_t smem_bytes() {
  return (size_t(2) * kBlock * (D + 4) + size_t(2) * kBlock * (DV + 4) +
          2 * kBlock * kPPitch + 2 * kBlock) *
         sizeof(float);
}

// Stores the 64 x W accumulator `acc` (scaled by `scale`) into rows
// [r0, r0 + 64) of a strided (S, W) slice: this thread's rows ty + 16 i,
// its columns Cols<W>::col(tx, j) below W, rows below S.
template <typename T, int W>
__device__ __forceinline__ void store_tile(T* dst, int64_t s_stride,
                                           const float (&acc)[4][Cols<W>::kN],
                                           float scale, int r0, int S,
                                           int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= S) continue;
    T* row = dst + int64_t(r) * s_stride;
#pragma unroll
    for (int j = 0; j < Cols<W>::kN; ++j) {
      const int c = Cols<W>::col(tx, j);
      if (c < W) store(row + c, scale * acc[i][j]);
    }
  }
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv(Args a) {
  constexpr int P = D + 4, PV = DV + 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [64][P]
  float* Vs = Ks + kBlock * P;                   // [64][PV]
  float* Qs = Vs + kBlock * PV;                  // [64][P]
  float* dOs = Qs + kBlock * P;                  // [64][PV]
  float* Ps = dOs + kBlock * PV;                 // [64 rows][kPPitch]
  float* dSs = Ps + kBlock * kPPitch;
  float* lse_s = dSs + kBlock * kPPitch;
  float* delta_s = lse_s + kBlock;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * kBlock;
  const int g = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  load_rows<T, D>(Ks, slice<T>(a, kK, a.k, b, g), a.st[kK][2], k0, a.Sk);
  load_rows<T, DV>(Vs, slice<T>(a, kV, a.v, b, g), a.st[kV][2], k0, a.Sk);

  // Query tiles that can see a key of this tile.
  const int nq = (a.Sq + kBlock - 1) / kBlock;
  const int qt_begin = a.causal ? k0 / kBlock : 0;
  int qt_end = nq;
  if (a.window > 0)
    qt_end = min(nq, (k0 + kBlock - 2 + a.window) / kBlock + 1);

  // dK is D wide, dV Dv wide: each has its own columns.
  float dk[4][Cols<D>::kN], dv[4][Cols<DV>::kN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < Cols<D>::kN; ++j) dk[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < Cols<DV>::kN; ++j) dv[i][j] = 0.f;
  }

  for (int r = 0; r < G; ++r) {
    const int h = g * G + r;
    const T* Q = slice<T>(a, kQ, a.q, b, h);
    const T* dO = slice<T>(a, kDO, a.dout, b, h);
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kBlock;
      __syncthreads();  // the last tile's reads of Qs, dOs, Ps, dSs done
      load_rows<T, D>(Qs, Q, a.st[kQ][2], q0, a.Sq);
      load_rows<T, DV>(dOs, dO, a.st[kDO][2], q0, a.Sq);
      load_row_stats(lse_s, delta_s, a, b, h, q0);
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dot<D>(s, Qs, Ks, tx, ty);
      tile_dot<DV>(dp, dOs, Vs, tx, ty);
      p_and_ds(s, dp, lse_s, delta_s, Ps, dSs, q0, k0, tx, ty, a);
      __syncthreads();
      // dV[key] += Σ_row P[row][key]·dO[row];
      // dK[key] += Σ_row dS[row][key]·Q[row] (scaled at the store).
      tile_accumulate<DV, false>(dv, Ps, dOs, tx, ty);
      tile_accumulate<D, false>(dk, dSs, Qs, tx, ty);
    }
  }

  store_tile<T, D>(static_cast<T*>(a.dk) + b * a.st[kDK][0] +
                       g * a.st[kDK][1],
                   a.st[kDK][2], dk, a.scale, k0, a.Sk, tx, ty);
  store_tile<T, DV>(static_cast<T*>(a.dv) + b * a.st[kDV][0] +
                        g * a.st[kDV][1],
                    a.st[kDV][2], dv, 1.f, k0, a.Sk, tx, ty);
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq(Args a) {
  constexpr int P = D + 4, PV = DV + 4;
  constexpr int NC = Cols<D>::kN;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [64][P]
  float* dOs = Qs + kBlock * P;                  // [64][PV]
  float* Ks = dOs + kBlock * PV;                 // [64][P]
  float* Vs = Ks + kBlock * P;                   // [64][PV]
  float* dSs = Vs + kBlock * PV;                 // [64 rows][kPPitch]
  float* lse_s = dSs + kBlock * kPPitch;
  float* delta_s = lse_s + kBlock;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nq = (a.Sq + kBlock - 1) / kBlock;
  const int q0 = (nq - 1 - int(blockIdx.x)) * kBlock;   // last tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.Hkv);
  load_rows<T, D>(Qs, slice<T>(a, kQ, a.q, b, h), a.st[kQ][2], q0, a.Sq);
  load_rows<T, DV>(dOs, slice<T>(a, kDO, a.dout, b, h), a.st[kDO][2], q0,
                   a.Sq);
  load_row_stats(lse_s, delta_s, a, b, h, q0);
  const T* K = slice<T>(a, kK, a.k, b, g);
  const T* V = slice<T>(a, kV, a.v, b, g);

  // Reachable key tiles, as the forward bounds them.
  const int nk = (a.Sk + kBlock - 1) / kBlock;
  int kt_end = nk;
  if (a.causal) kt_end = min(nk, (q0 + kBlock - 1) / kBlock + 1);
  int kt_begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0)
    kt_begin = (q0 - a.window + 1) / kBlock;

  float dq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dq[i][j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the last tile's reads of Ks, Vs, dSs done
    load_rows<T, D>(Ks, K, a.st[kK][2], k0, a.Sk);
    load_rows<T, DV>(Vs, V, a.st[kV][2], k0, a.Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(s, Qs, Ks, tx, ty);
    tile_dot<DV>(dp, dOs, Vs, tx, ty);
    p_and_ds(s, dp, lse_s, delta_s, nullptr, dSs, q0, k0, tx, ty, a);
    __syncthreads();
    // dQ[row] += Σ_key dS[row][key] K[key]
    tile_accumulate<D, true>(dq, dSs, Ks, tx, ty);
  }

  store_tile<T, D>(static_cast<T*>(a.dq) + b * a.st[kDQ][0] +
                       h * a.st[kDQ][1],
                   a.st[kDQ][2], dq, a.scale, q0, a.Sq, tx, ty);
}

template <typename T, int D, int DV>
int launch_d(const Args& a, cudaStream_t stream) {
  const int64_t rows = int64_t(a.B) * a.H * a.Sq;
  const int64_t delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
  flash_bwd_delta<T, DV><<<unsigned(delta_blocks), kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const int smem = int(smem_bytes<D, DV>());
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, D, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid_kv((a.Sk + kBlock - 1) / kBlock, a.Hkv, a.B);
  flash_bwd_dkdv<T, D, DV><<<grid_kv, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  err = cudaFuncSetAttribute(flash_bwd_dq<T, D, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid_q((a.Sq + kBlock - 1) / kBlock, a.H, a.B);
  flash_bwd_dq<T, D, DV><<<grid_q, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, const int64_t* strides, int B, int H, int Hkv,
           int Sq, int Sk, int D, int Dv, int causal, int window,
           void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || Hkv < 1 || H % Hkv != 0 ||
      Sq < 1 || Sk < 1)
    return int(cudaErrorInvalidValue);
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  for (int t = 0; t < kTensors; ++t)
    for (int i = 0; i < 3; ++i) a.st[t][i] = strides[3 * t + i];
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.window = window;
  a.scale = 1.0f / sqrtf(float(D));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // bf16 reaches the SIMT kernels at (8, 8) and (24, 16) alone
  // (variant_for: D not a multiple of wgmma's k16), f32 at every pair.
  if (D == 8 && Dv == 8) return launch_d<T, 8, 8>(a, st);
  if (D == 24 && Dv == 16) return launch_d<T, 24, 16>(a, st);
  if constexpr (std::is_same_v<T, float>) {
    if (D == 96 && Dv == 64) return launch_d<T, 96, 64>(a, st);
    if (D == Dv) {
      switch (D) {
        case 16: return launch_d<T, 16, 16>(a, st);
        case 32: return launch_d<T, 32, 32>(a, st);
        case 64: return launch_d<T, 64, 64>(a, st);
        case 128: return launch_d<T, 128, 128>(a, st);
        default: break;
      }
    }
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core variant: bf16, (D, Dv) in {(16, 16), (32, 32), (64, 64),
// (96, 64), (128, 128)}.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kThreads = 384;            // producer + 2 consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kGroup = 128;              // threads of a warpgroup
constexpr int kKeys = 64;                // dK/dV block: keys
constexpr int kRows = 64;                // dK/dV block: query rows a tile
constexpr int kRowStages = 4;            // dK/dV block: Q/dO ring, 2 a group
constexpr int kQRows = 128;              // dQ block: query rows, 2 x 64
constexpr int kQKeys = 128;              // dQ block: keys a tile
constexpr int kKeyStages = 2;            // dQ block: K/V ring depth
constexpr int kRowPad = 128;             // scratch rows: Sq rounded up
constexpr float kLog2e = 1.4426950408889634f;

// A head dim padded to whole 64-column chunks (at least one).
__host__ __device__ constexpr int padded(int d) {
  return d < 64 ? 64 : (d + 63) / 64 * 64;
}

// Shared memory of the dK/dV block, in bytes from a 1024-aligned base. A
// tile of R rows is DP/64 chunks of [R rows][64 bf16] at 128 bytes a row,
// each chunk in TMA's 128-byte swizzle (the layout the wgmma descriptors
// read). K and Q have DPQK columns, V and dO DPV (MLA: 128 and 64).
template <int DPQK, int DPV>
struct SmemKV {
  static constexpr int kQKChunks = DPQK / 64;
  static constexpr int kVChunks = DPV / 64;
  static constexpr int kKVChunk = kKeys * 128;
  static constexpr int kRowChunk = kRows * 128;
  static constexpr int kKT = kQKChunks * kKVChunk;      // the K tile
  static constexpr int kVT = kVChunks * kKVChunk;       // the V tile
  static constexpr int kQT = kQKChunks * kRowChunk;     // one Q tile
  static constexpr int kDOT = kVChunks * kRowChunk;     // one dO tile
  static constexpr int kStat = 2 * kRows * 4;           // lse·log2e, Δ
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKT;
  static constexpr int kQ = kV + kVT;                   // kRowStages each
  static constexpr int kDO = kQ + kRowStages * kQT;
  static constexpr int kStats = kDO + kRowStages * kDOT;
  static constexpr int kBar = kStats + kRowStages * kStat;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kRowStages) + 1024;
  // Group 1's dK and dV pass to group 0 through the Q stages.
  static_assert((DPQK + DPV) / 2 * 4 * kGroup <= kRowStages * kQT,
                "the dK/dV reduction does not fit the Q stages");
};

// Shared memory of the dQ block.
template <int DPQK, int DPV>
struct SmemQ {
  static constexpr int kQKChunks = DPQK / 64;
  static constexpr int kVChunks = DPV / 64;
  static constexpr int kRowChunk = kQRows * 128;
  static constexpr int kKeyChunk = kQKeys * 128;
  static constexpr int kQT = kQKChunks * kRowChunk;     // the Q tile
  static constexpr int kDOT = kVChunks * kRowChunk;     // the dO tile
  static constexpr int kKT = kQKChunks * kKeyChunk;     // one K tile
  static constexpr int kVT = kVChunks * kKeyChunk;      // one V tile
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQT;
  static constexpr int kK = kDO + kDOT;                 // kKeyStages each
  static constexpr int kV = kK + kKeyStages * kKT;
  static constexpr int kBar = kV + kKeyStages * kVT;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kKeyStages) + 1024;
};

struct Args {
  void* dq;
  void* dk;
  void* dv;
  const float* lse2;                     // (B, H, SqPad): lse·log2(e)
  const float* delta;                    // (B, H, SqPad): Δ
  int64_t dq_sb, dq_sh, dq_ss;
  int64_t dk_sb, dk_sh, dk_ss;
  int64_t dv_sb, dv_sh, dv_ss;
  int H, Hkv, Sq, Sk, SqPad;
  int causal;
  int window;                            // <= 0: no window
  float scale;
};

struct PrepArgs {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;                      // (B, H, Sq)
  float* lse2;
  float* delta;
  int64_t o_sb, o_sh, o_ss;
  int64_t do_sb, do_sh, do_ss;
  int H, Sq, SqPad;
  int64_t rows;                          // B * H * SqPad
};

// One 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr));
  return x;
}

__device__ __forceinline__ void st_shared(uint32_t addr, float x) {
  asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(addr), "f"(x)
               : "memory");
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B K-major in shared
// memory (descriptors), accumulate iff `accumulate`.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// acc = A·Bᵀ over D (D/16 k16 steps): A this group's 64 rows, B a tile of
// N = 2·|acc| rows, both K-major in shared memory in 64-column chunks
// `a_chunk` / `b_chunk` bytes apart. Fenced, issued and committed; not
// waited for.
template <int D, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a,
                                         int a_chunk, uint32_t b,
                                         int b_chunk) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;         // k16 step in a chunk
    const uint64_t da = desc(a + (kk / 4) * a_chunk + off, 16, 1024);
    const uint64_t db = desc(b + (kk / 4) * b_chunk + off, 16, 1024);
    if constexpr (N == 128)
      wgmma_ss_n128(acc, da, db, kk > 0);
    else
      wgmma_ss_n64(acc, da, db, kk > 0);
  }
  wgmma_commit();
}

// acc += (hi + lo)·B over 16·KS rows of B: A as the bf16 fragments hi,
// then lo (4 registers per k16 step), B MN-major in shared memory (KS
// blocks of 16 rows of 128 bytes in each 64-column chunk, chunks `b_chunk`
// bytes apart; transpose bit). Fenced, issued and committed as one group;
// not waited for.
template <int DP, int KS>
__device__ __forceinline__ void issue_rs(float (&acc)[DP / 2],
                                         uint32_t (&hi)[4 * KS],
                                         uint32_t (&lo)[4 * KS],
                                         uint32_t b, int b_chunk) {
  fence_regs(acc);
  fence_regs(hi);
  fence_regs(lo);
  wgmma_fence();
  auto part = [&](uint32_t (&f)[4 * KS]) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t db = desc(b + kk * 16 * 128, b_chunk, 1024);
      if constexpr (DP == 128)
        wgmma_rs_n128(acc, f[4 * kk], f[4 * kk + 1], f[4 * kk + 2],
                      f[4 * kk + 3], db);
      else
        wgmma_rs_n64(acc, f[4 * kk], f[4 * kk + 1], f[4 * kk + 2],
                     f[4 * kk + 3], db);
    }
  };
  part(hi);
  part(lo);
  wgmma_commit();
}

// x as A fragments of two bf16 parts, hi = bf16(x) and lo = bf16(x − hi)
// (x − hi is exact in f32): hi + lo carries x to ~2^-17 of itself. The
// accumulator's pairs (x[2r], x[2r + 1]) are the fragments' registers.
template <int N>
__device__ __forceinline__ void split_bf16(uint32_t (&hi)[N / 2],
                                           uint32_t (&lo)[N / 2],
                                           const float (&x)[N]) {
#pragma unroll
  for (int r = 0; r < N / 2; ++r) {
    hi[r] = pack_bf16(x[2 * r], x[2 * r + 1]);
    const float2 h = unpack_bf16(hi[r]);
    lo[r] = pack_bf16(x[2 * r] - h.x, x[2 * r + 1] - h.y);
  }
}

// lse·log2(e) and Δ = rowsum(dO ⊙ O) over o's DV columns of every padded
// row; zeros past Sq. One warp per row, 8-byte loads (4 columns a lane):
// the rows of o and dO are 16-byte aligned (the wrapper copies a view
// whose are not).
template <int DV>
__global__ void flash_bwd_prep(PrepArgs p) {
  const int64_t row = int64_t(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.rows) return;
  const int s = int(row % p.SqPad);
  const int64_t bh = row / p.SqPad;
  const int h = int(bh % p.H), b = int(bh / p.H);
  float acc = 0.f, l2 = 0.f;
  if (s < p.Sq) {
    const uint2* O = reinterpret_cast<const uint2*>(
        p.o + b * p.o_sb + h * p.o_sh + s * p.o_ss);
    const uint2* dO = reinterpret_cast<const uint2*>(
        p.dout + b * p.do_sb + h * p.do_sh + s * p.do_ss);
    for (int c = lane; c < DV / 4; c += 32) {
      const uint2 x = O[c], y = dO[c];
      const float2 x0 = unpack_bf16(x.x), x1 = unpack_bf16(x.y);
      const float2 y0 = unpack_bf16(y.x), y1 = unpack_bf16(y.y);
      acc = fmaf(y0.x, x0.x, acc);
      acc = fmaf(y0.y, x0.y, acc);
      acc = fmaf(y1.x, x1.x, acc);
      acc = fmaf(y1.y, x1.y, acc);
    }
    l2 = p.lse[bh * p.Sq + s] * kLog2e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    p.delta[row] = acc;
    p.lse2[row] = l2;
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, Args a) {
  // Widths zero-padded to 64-column chunks: dK's (the n of dSᵀ·Q) is
  // DPQK, 128 for D = 96 (n96 has no 128-byte-swizzled MN-major layout:
  // the zero half is multiplied, never stored), dV's DPV.
  constexpr int DPQK = padded(D), DPV = padded(DV);
  using L = SmemKV<DPQK, DPV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // mbarriers: K and V loaded; per stage Q, dO, lse, Δ loaded and free.
  const uint32_t bar_kv = base + L::kBar;
  const uint32_t full = bar_kv + 8, empty = full + 8 * kRowStages;

  // Key blocks vary slowest in the launch order, so the blocks whose keys
  // most query rows see (causal: the first) start first.
  const int k0 = blockIdx.z * kKeys;
  const int g = blockIdx.x, b = blockIdx.y;
  const int G = a.H / a.Hkv;
  // Query tiles that can see a key of this block: causal, rows >= k0;
  // window, rows <= k0 + kKeys - 2 + W.
  const int nq = (a.Sq + kRows - 1) / kRows;
  const int qt_begin = a.causal ? min(k0 / kRows, nq) : 0;
  int qt_end = nq;
  if (a.window > 0)
    qt_end = min(nq, (k0 + kKeys - 2 + a.window) / kRows + 1);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kRowStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kGroup);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the TMA loads in flight; a
    // stage is refilled once the group that took its tile is done.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_kv, L::kKT + L::kVT);
      for (int c = 0; c < L::kQKChunks; ++c)
        tma_load(base + L::kK + c * L::kKVChunk, &tk, bar_kv, 64 * c, g, k0,
                 b);
      for (int c = 0; c < L::kVChunks; ++c)
        tma_load(base + L::kV + c * L::kKVChunk, &tv, bar_kv, 64 * c, g, k0,
                 b);
      // Tile i = (head g·G + r, query tile qt) goes to stage s; its
      // refill waits for the phase `parity` of the stage's free barrier.
      int s = 0;
      uint32_t parity = 1;
      for (int r = 0, i = 0; r < G; ++r) {
        const int h = g * G + r;
        const float* lse2 = a.lse2 + (int64_t(b) * a.H + h) * a.SqPad;
        const float* dlt = a.delta + (int64_t(b) * a.H + h) * a.SqPad;
        for (int qt = qt_begin; qt < qt_end; ++qt, ++i) {
          const int q0 = qt * kRows;
          if (i >= kRowStages) mbar_wait(empty + 8 * s, parity);
          const uint32_t bar = full + 8 * s;
          mbar_expect_tx(bar, L::kQT + L::kDOT + L::kStat);
          for (int c = 0; c < L::kQKChunks; ++c)
            tma_load(base + L::kQ + s * L::kQT + c * L::kRowChunk, &tq,
                     bar, 64 * c, h, q0, b);
          for (int c = 0; c < L::kVChunks; ++c)
            tma_load(base + L::kDO + s * L::kDOT + c * L::kRowChunk, &tdo,
                     bar, 64 * c, h, q0, b);
          const uint32_t stats = base + L::kStats + s * L::kStat;
          bulk_load(stats, lse2 + q0, kRows * 4, bar);
          bulk_load(stats + kRows * 4, dlt + q0, kRows * 4, bar);
          if (++s == kRowStages) {
            s = 0;
            parity ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroups: both take the block's 64 keys, group w the
  // tiles i = w, w + 2, ... (stages w and w + 2 of the ring).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int key0 = k0 + 16 * warp + lane / 4;        // and key0 + 8
  const int col0 = 2 * (lane % 4);                   // rows q0 + 8j + col0
  const uint32_t k_smem = base + L::kK;
  const uint32_t v_smem = base + L::kV;
  const float sl2 = a.scale * kLog2e;

  float dk[DPQK / 2], dv[DPV / 2];
#pragma unroll
  for (int i = 0; i < DPQK / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DPV / 2; ++i) dv[i] = 0.f;
  float st[kRows / 2], dpt[kRows / 2];   // Sᵀ, dPᵀ: 64 keys x 64 rows
  uint32_t ph[kRows / 4], pl[kRows / 4], sh[kRows / 4], sl[kRows / 4];

  // One query tile; `masked` (a std::bool_constant) says whether some
  // (row, key) pair of it is masked for this group.
  auto tile = [&](auto masked, int q0, uint32_t q_s, uint32_t do_s,
                  uint32_t lse2, uint32_t dlt) {
    constexpr bool kMasked = decltype(masked)::value;
    issue_ss<D, kRows>(st, k_smem, L::kKVChunk, q_s, L::kRowChunk);
    issue_ss<DV, kRows>(dpt, v_smem, L::kKVChunk, do_s, L::kRowChunk);
    if constexpr (kMasked)
      wgmma_wait<0>();
    else
      wgmma_wait<1>();                   // Sᵀ done, dPᵀ may run on
    fence_regs(st);
    // Pᵀ: st[4j + e] is key key0 + 8 (e / 2), row q0 + 8j + col0 + e % 2.
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + col0 + (e & 1);
        float p = exp2_approx(fmaf(st[4 * j + e], sl2,
                                   -ld_shared(lse2 + 4 * c)));
        if constexpr (kMasked) {
          const int qp = q0 + c, kp = key0 + 8 * (e >> 1);
          bool ok = kp < a.Sk && qp < a.Sq;
          if (a.causal) ok = ok && qp >= kp;
          if (a.window > 0) ok = ok && qp - kp < a.window;
          p = ok ? p : 0.f;
        }
        st[4 * j + e] = p;
      }
    }
    if constexpr (!kMasked) wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * j + e] =
            st[4 * j + e] *
            (dpt[4 * j + e] - ld_shared(dlt + 4 * (8 * j + col0 + (e & 1))));
    split_bf16(ph, pl, st);
    split_bf16(sh, sl, dpt);
    issue_rs<DPV, kRows / 16>(dv, ph, pl, do_s, L::kRowChunk);
    issue_rs<DPQK, kRows / 16>(dk, sh, sl, q_s, L::kRowChunk);
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
  };

  mbar_wait(bar_kv, 0);
  // The producer's order of tiles: G heads x [qt_begin, qt_end), of which
  // this group takes every other one. One counter carries the loop (the
  // group's registers are at their limit).
  const int per_head = max(qt_end - qt_begin, 0);
  const int n_tiles = G * per_head;
  for (int i = wg; i < n_tiles; i += 2) {
    const int s = i % kRowStages;
    const int q0 = (qt_begin + i % per_head) * kRows;
    const uint32_t q_s = base + L::kQ + s * L::kQT;
    const uint32_t do_s = base + L::kDO + s * L::kDOT;
    const uint32_t lse2 = base + L::kStats + s * L::kStat;
    const bool edge = k0 + kKeys > a.Sk || q0 + kRows > a.Sq ||
                      (a.causal && q0 < k0 + kKeys - 1) ||
                      (a.window > 0 && q0 + kRows - 1 - k0 >= a.window);
    mbar_wait(full + 8 * s, (i / kRowStages) & 1);
    if (edge)
      tile(std::true_type{}, q0, q_s, do_s, lse2, lse2 + 4 * kRows);
    else
      tile(std::false_type{}, q0, q_s, do_s, lse2, lse2 + 4 * kRows);
    mbar_arrive(empty + 8 * s);
  }

  // Group 1's partial dK and dV into group 0's, through shared memory
  // (the Q stages, free once both groups are done), element r of thread t
  // at [r][t]; a fixed order, so the sum is reproducible.
  const uint32_t red = base + L::kQ + 4 * tid;
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
  if (wg == 1) {
#pragma unroll
    for (int r = 0; r < DPQK / 2; ++r)
      st_shared(red + r * 4 * kGroup, dk[r]);
#pragma unroll
    for (int r = 0; r < DPV / 2; ++r)
      st_shared(red + (DPQK / 2 + r) * 4 * kGroup, dv[r]);
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
  if (wg == 1) return;
#pragma unroll
  for (int r = 0; r < DPQK / 2; ++r) dk[r] += ld_shared(red + r * 4 * kGroup);
#pragma unroll
  for (int r = 0; r < DPV / 2; ++r)
    dv[r] += ld_shared(red + (DPQK / 2 + r) * 4 * kGroup);

  // This thread's two keys, bf16 pairs: dK's columns < D, dV's < DV.
  __nv_bfloat16* dK =
      static_cast<__nv_bfloat16*>(a.dk) + b * a.dk_sb + g * a.dk_sh;
  __nv_bfloat16* dV =
      static_cast<__nv_bfloat16*>(a.dv) + b * a.dv_sb + g * a.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= a.Sk) continue;
#pragma unroll
    for (int j = 0; j < DPQK / 8; ++j) {
      if (8 * j >= D) continue;
      *reinterpret_cast<__nv_bfloat162*>(dK + key * a.dk_ss + 8 * j + col0) =
          __floats2bfloat162_rn(a.scale * dk[4 * j + 2 * r],
                                a.scale * dk[4 * j + 2 * r + 1]);
    }
#pragma unroll
    for (int j = 0; j < DPV / 8; ++j) {
      if (8 * j >= DV) continue;
      *reinterpret_cast<__nv_bfloat162*>(dV + key * a.dv_ss + 8 * j + col0) =
          __floats2bfloat162_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, Args a) {
  // dQ's n (of dS·K) is DPQK: 128 for D = 96, as dK's.
  constexpr int DPQK = padded(D), DPV = padded(DV);
  using L = SmemQ<DPQK, DPV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // mbarriers: Q and dO loaded; per stage K and V loaded and free.
  const uint32_t bar_q = base + L::kBar;
  const uint32_t full = bar_q + 8, empty = full + 8 * kKeyStages;

  // Query tiles vary slowest in the launch order, last first, so the long
  // causal rows start first.
  const int nq = (a.Sq + kQRows - 1) / kQRows;
  const int q0 = (nq - 1 - int(blockIdx.z)) * kQRows;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (a.H / a.Hkv);
  // Reachable key tiles, as the forward bounds them.
  const int nk = (a.Sk + kQKeys - 1) / kQKeys;
  int kt_end = nk;
  if (a.causal) kt_end = min(nk, (q0 + kQRows - 1) / kQKeys + 1);
  int kt_begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0)
    kt_begin = (q0 - a.window + 1) / kQKeys;
  const int n_tiles = max(kt_end - kt_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kKeyStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kQT + L::kDOT);
      for (int c = 0; c < L::kQKChunks; ++c)
        tma_load(base + L::kQ + c * L::kRowChunk, &tq, bar_q, 64 * c, h, q0,
                 b);
      for (int c = 0; c < L::kVChunks; ++c)
        tma_load(base + L::kDO + c * L::kRowChunk, &tdo, bar_q, 64 * c, h,
                 q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kKeyStages;
        const int k0 = (kt_begin + i) * kQKeys;
        if (i >= kKeyStages)
          mbar_wait(empty + 8 * s, ((i / kKeyStages) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, L::kKT + L::kVT);
        for (int c = 0; c < L::kQKChunks; ++c)
          tma_load(base + L::kK + s * L::kKT + c * L::kKeyChunk, &tk, bar,
                   64 * c, hk, k0, b);
        for (int c = 0; c < L::kVChunks; ++c)
          tma_load(base + L::kV + s * L::kVT + c * L::kKeyChunk, &tv, bar,
                   64 * c, hk, k0, b);
      }
    }
    return;
  }

  // Consumer warpgroups: 64 query rows each; both take every key tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int rq0 = q0 + 64 * wg;                      // this group's rows
  const int row0 = rq0 + 16 * warp + lane / 4;       // and row0 + 8
  const int col0 = 2 * (lane % 4);                   // keys k0 + 8j + col0
  const uint32_t q_smem = base + L::kQ + wg * 64 * 128;
  const uint32_t do_smem = base + L::kDO + wg * 64 * 128;
  const float sl2 = a.scale * kLog2e;
  // lse·log2e and Δ of the thread's two rows (the scratch is padded to a
  // whole number of blocks).
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = (int64_t(b) * a.H + h) * a.SqPad + row0 + 8 * r;
    lse2[r] = a.lse2[row];
    dlt[r] = a.delta[row];
  }

  float dq[DPQK / 2];
#pragma unroll
  for (int i = 0; i < DPQK / 2; ++i) dq[i] = 0.f;
  float sc[kQKeys / 2], dp[kQKeys / 2];  // S, dP: 64 rows x 128 keys
  uint32_t hi[kQKeys / 4], lo[kQKeys / 4];

  // Whether some (row, key) pair of this group and key tile t is masked.
  auto masked = [&](int t) {
    const int k0 = t * kQKeys;
    return k0 + kQKeys > a.Sk || (a.causal && k0 + kQKeys - 1 > rq0) ||
           (a.window > 0 && rq0 + 63 - k0 >= a.window);
  };
  auto tile = [&](auto masked_c, int t) {
    constexpr bool kMasked = decltype(masked_c)::value;
    const int i = t - kt_begin, s = i % kKeyStages, k0 = t * kQKeys;
    const uint32_t k_s = base + L::kK + s * L::kKT;
    const uint32_t v_s = base + L::kV + s * L::kVT;
    mbar_wait(full + 8 * s, (i / kKeyStages) & 1);
    issue_ss<D, kQKeys>(sc, q_smem, L::kRowChunk, k_s, L::kKeyChunk);
    issue_ss<DV, kQKeys>(dp, do_smem, L::kRowChunk, v_s, L::kKeyChunk);
    if constexpr (kMasked)
      wgmma_wait<0>();
    else
      wgmma_wait<1>();                   // S done, dP may run on
    fence_regs(sc);
    // P: sc[4j + e] is row row0 + 8 (e / 2), key k0 + 8j + col0 + e % 2.
#pragma unroll
    for (int j = 0; j < kQKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(fmaf(sc[4 * j + e], sl2, -lse2[e >> 1]));
        if constexpr (kMasked) {
          const int qp = row0 + 8 * (e >> 1), kp = k0 + 8 * j + col0 + (e & 1);
          bool ok = kp < a.Sk;
          if (a.causal) ok = ok && qp >= kp;
          if (a.window > 0) ok = ok && qp - kp < a.window;
          p = ok ? p : 0.f;
        }
        sc[4 * j + e] = p;
      }
    }
    if constexpr (!kMasked) wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < kQKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dlt[e >> 1]);
    split_bf16(hi, lo, dp);
    issue_rs<DPQK, kQKeys / 16>(dq, hi, lo, k_s, L::kKeyChunk);
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(empty + 8 * s);
  };

  mbar_wait(bar_q, 0);
  for (int t = kt_begin; t < kt_end; ++t) {
    if (masked(t))
      tile(std::true_type{}, t);
    else
      tile(std::false_type{}, t);
  }

  // This thread's two rows (columns < D), bf16 pairs.
  __nv_bfloat16* dQ =
      static_cast<__nv_bfloat16*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int j = 0; j < DPQK / 8; ++j) {
    if (8 * j >= D) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(dQ + row * a.dq_ss + 8 * j +
                                           col0) =
            __floats2bfloat162_rn(a.scale * dq[4 * j + 2 * r],
                                  a.scale * dq[4 * j + 2 * r + 1]);
    }
  }
}

template <int D, int DV>
int launch_d(const CUtensorMap (&m)[8], const PrepArgs& p, const Args& a,
             int B, cudaStream_t stream) {
  const int64_t prep_blocks = (p.rows + 7) / 8;
  if (prep_blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
  flash_bwd_prep<DV><<<unsigned(prep_blocks), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  int smem = SmemKV<padded(D), padded(DV)>::kBytes;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_tc<D, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid_kv(a.Hkv, B, (a.Sk + kKeys - 1) / kKeys);
  flash_bwd_dkdv_tc<D, DV><<<grid_kv, kThreads, smem, stream>>>(
      m[0], m[1], m[6], m[7], a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  smem = SmemQ<padded(D), padded(DV)>::kBytes;
  err = cudaFuncSetAttribute(flash_bwd_dq_tc<D, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid_q(a.H, B, (a.Sq + kQRows - 1) / kQRows);
  flash_bwd_dq_tc<D, DV><<<grid_q, kThreads, smem, stream>>>(
      m[2], m[3], m[4], m[5], a);
  return int(cudaGetLastError());
}

// Floats of scratch the tc variant needs: lse·log2e and Δ of every row,
// rows padded to kRowPad.
int64_t scratch_floats(int B, int H, int Sq) {
  return 2 * int64_t(B) * H * ((Sq + kRowPad - 1) / kRowPad * kRowPad);
}

int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* scratch,
           int64_t scratch_len, void* dq, void* dk, void* dv,
           const int64_t* st, int B, int H, int Hkv, int Sq, int Sk, int D,
           int Dv, int causal, int window, cudaStream_t stream) {
  const int SqPad = (Sq + kRowPad - 1) / kRowPad * kRowPad;
  const int64_t rows = int64_t(B) * H * SqPad;
  if ((Sk + kKeys - 1) / kKeys > 65535 || (Sq + kQRows - 1) / kQRows > 65535)
    return int(cudaErrorInvalidValue);   // the grids' z extent
  if (scratch_len < scratch_floats(B, H, Sq) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return int(cudaErrorInvalidValue);
  // Q and dO in 64-row tiles (dK/dV) and 128-row tiles (dQ); K and V in
  // 128-key tiles (dQ) and 64-key tiles (dK/dV). q and k are D wide; v, o
  // and dO Dv wide.
  CUtensorMap m[8];
  CUtensorMap mo;                        // checks o as TMA would (prep)
  if (!make_map(&mo, o, st[9], st[10], st[11], Dv, H, Sq, B, kRows) ||
      !make_map(&m[0], q, st[0], st[1], st[2], D, H, Sq, B, kRows) ||
      !make_map(&m[1], dout, st[12], st[13], st[14], Dv, H, Sq, B, kRows) ||
      !make_map(&m[2], q, st[0], st[1], st[2], D, H, Sq, B, kQRows) ||
      !make_map(&m[3], dout, st[12], st[13], st[14], Dv, H, Sq, B, kQRows) ||
      !make_map(&m[4], k, st[3], st[4], st[5], D, Hkv, Sk, B, kQKeys) ||
      !make_map(&m[5], v, st[6], st[7], st[8], Dv, Hkv, Sk, B, kQKeys) ||
      !make_map(&m[6], k, st[3], st[4], st[5], D, Hkv, Sk, B, kKeys) ||
      !make_map(&m[7], v, st[6], st[7], st[8], Dv, Hkv, Sk, B, kKeys))
    return int(cudaErrorInvalidValue);
  // The epilogues store bf16 pairs: dq, dk, dv and their strides even.
  for (int t = 0; t < 3; ++t) {
    const void* out = t == 0 ? dq : t == 1 ? dk : dv;
    if (reinterpret_cast<uintptr_t>(out) % 4 != 0 ||
        st[15 + 3 * t] % 2 != 0 || st[16 + 3 * t] % 2 != 0 ||
        st[17 + 3 * t] % 2 != 0)
      return int(cudaErrorInvalidValue);
  }
  const PrepArgs p{static_cast<const __nv_bfloat16*>(o),
                   static_cast<const __nv_bfloat16*>(dout), lse, scratch,
                   scratch + rows, st[9], st[10], st[11], st[12], st[13],
                   st[14], H, Sq, SqPad, rows};
  const Args a{dq, dk, dv, scratch, scratch + rows,
               st[15], st[16], st[17], st[18], st[19], st[20],
               st[21], st[22], st[23], H, Hkv, Sq, Sk, SqPad, causal, window,
               1.0f / sqrtf(float(D))};
  if (D == 96 && Dv == 64) return launch_d<96, 64>(m, p, a, B, stream);
  if (D != Dv) return int(cudaErrorInvalidValue);
  switch (D) {
    case 16: return launch_d<16, 16>(m, p, a, B, stream);
    case 32: return launch_d<32, 32>(m, p, a, B, stream);
    case 64: return launch_d<64, 64>(m, p, a, B, stream);
    case 128: return launch_d<128, 128>(m, p, a, B, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace tc

namespace {

constexpr int kVariantSimt = 0;
constexpr int kVariantTc = 1;

// The one place the variant is chosen, by the forward's rule: bf16 with D
// a multiple of wgmma's k16 depth goes to the tensor cores; f32 (whose
// tensor-core path would be TF32) and D in {8, 24} go to the SIMT kernels.
// Mirrored by kernel_variant() in flash_attention.py.
int variant_for(int bf16, int D) {
  return bf16 && D % 16 == 0 ? kVariantTc : kVariantSimt;
}

int dispatch(int bf16, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* lse,
             float* scratch, int64_t scratch_len, void* dq, void* dk,
             void* dv, const int64_t* strides, int B, int H, int Hkv, int Sq,
             int Sk, int D, int Dv, int causal, int window, int* variant,
             void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || Hkv < 1 || H % Hkv != 0 ||
      Sq < 1 || Sk < 1)
    return int(cudaErrorInvalidValue);
  const int var = variant_for(bf16, D);
  *variant = var;
  if (var == kVariantTc)
    return tc::launch(q, k, v, o, dout, lse, scratch, scratch_len, dq, dk,
                      dv, strides, B, H, Hkv, Sq, Sk, D, Dv, causal, window,
                      static_cast<cudaStream_t>(stream));
  if (scratch_len < int64_t(B) * H * Sq) return int(cudaErrorInvalidValue);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, dout, lse, scratch, dq, dk, dv,
                                 strides, B, H, Hkv, Sq, Sk, D, Dv, causal,
                                 window, stream);
  return launch<float>(q, k, v, o, dout, lse, scratch, dq, dk, dv, strides,
                       B, H, Hkv, Sq, Sk, D, Dv, causal, window, stream);
}

}  // namespace

extern "C" {

// strides: 24 element strides, (b, h, s) of q, k, v, o, do, dq, dk, dv in
// that order; the head axis of each must have unit stride. D is the head
// dim of q, k, dq and dk, Dv that of v, o, do and dv. lse: the forward's
// contiguous f32 (B, H, Sq) log-sum-exp; scratch: `scratch_len` floats of
// f32 scratch, at least tc::scratch_floats(B, H, Sq) (bwd_scratch_floats
// in flash_attention.py), 16-byte aligned, which the call fills (Δ, and
// for the tensor cores the scaled lse). *variant is set to the variant
// launched: 1 tensor cores, 0 SIMT.

int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const float* lse, float* scratch,
                            int64_t scratch_len, void* dq, void* dk,
                            void* dv, const int64_t* strides, int B, int H,
                            int Hkv, int Sq, int Sk, int D, int Dv,
                            int causal, int window, int* variant,
                            void* stream) {
  return dispatch(0, q, k, v, o, dout, lse, scratch, scratch_len, dq, dk, dv,
                  strides, B, H, Hkv, Sq, Sk, D, Dv, causal, window, variant,
                  stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, float* scratch,
                             int64_t scratch_len, void* dq, void* dk,
                             void* dv, const int64_t* strides, int B, int H,
                             int Hkv, int Sq, int Sk, int D, int Dv,
                             int causal, int window, int* variant,
                             void* stream) {
  return dispatch(1, q, k, v, o, dout, lse, scratch, scratch_len, dq, dk, dv,
                  strides, B, H, Hkv, Sq, Sk, D, Dv, causal, window, variant,
                  stream);
}

}  // extern "C"
