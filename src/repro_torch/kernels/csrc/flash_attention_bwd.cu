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
// 2.12-2.14 ms at serve, SDPA's backward 0.12 and 1.51 ms; the first
// port's SIMT kernels took 1.98-1.99 and 41.1-41.4 ms there. (96, 64):
// 0.218-0.221 ms at MLA's training shape and 3.89-3.90 ms at its prefill
// shape, SDPA's backward 0.193-0.194 and 3.30-3.33.
//
// Two variants, both on the tensor cores, chosen in one place
// (variant_for, by dtype and D, the forward's rule; kernel_variant() in
// flash_attention.py mirrors it), each one C call that enqueues its
// kernels on the caller's stream (tc three, mma two):
//
// tc: bf16 with D in {16, 32, 64, 96, 128} (D a multiple of wgmma's k16),
// on the tensor cores (wgmma, TMA). The training path (bf16, D = 128;
// MLA's (96, 64)) runs it. Each kernel is templated on (D, Dv): Q and K
// tiles are D wide and V, O and dO tiles Dv wide, in column chunks
// (tc_common.cuh, Tile): 64 columns in the 128-byte swizzle, D < 64
// zero-padded to one chunk; at MLA's D = 96 three 32-column chunks in the
// 64-byte swizzle, so that no product runs over a column of zeros: Sᵀ =
// K·Qᵀ walks the three chunks in 6 k16 steps, dPᵀ = V·dOᵀ takes 4, dV +=
// Pᵀ·dO is n64, and dK += dSᵀ·Q and dQ += dS·K are n96 (MN-major B in
// the 64-byte swizzle, chunk after chunk along n). Issued: 12D + 8Dv =
// 1664 FLOP a pair, the design's.
// - flash_bwd_prep: one warp per row writes lse·log2(e) and
//   Δ = rowsum(dO ⊙ O) over Dv into an f32 scratch of (B, H, Sq) rows
//   padded to 128 (zeros past Sq), so that a tile's 64 rows are one
//   256-byte bulk copy from an aligned address. At (96, 64)
//   flash_bwd_prep_rows writes the same with a row in Dv/8 lanes, 16-byte
//   loads (one warp a row, half its lanes idle, took three times its
//   bytes' time at MLA's training shape).
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
//     dV += Pᵀ·dO, dK += dSᵀ·Q    wgmma m64n{64,96,128}k16, A from
//                                registers (the accumulator's layout is
//                                the A fragment's), B = dO or Q MN-major
//                                (transpose bit), 4 steps.
//   dK and dV stay in registers (each element has one writer: no
//   atomics); dK is scaled at the store, bf16 pairs into the strided
//   outputs. Shared memory: 163 KB at D = 128 (D <= 64 pads to 64: 83
//   KB), one block per SM. Key tiles vary slowest in the launch order, so
//   the longest causal blocks (the first keys) start first: at the
//   training shape (B=2, Hkv=8, S=1024) the 256 blocks are two waves, and
//   with 128-key blocks (both groups on one tile) the first key tile's
//   block alone set the kernel's time (its 32 tiles against a mean of
//   18).
//   At (96, 64) the block is 128 keys and group w takes keys 64w.. of
//   them on every query tile (K 24 KB + V 16 KB + 4 stages of 20.5 KB:
//   123 KB): half the blocks, each Q and dO tile read once for 128 keys,
//   no reduction at the end (each group stores its own keys). Key blocks
//   vary fastest in the launch order, first keys first, so that the
//   blocks of one (b, g) run together and read its Q and dO from L2:
//   with them slowest the blocks in flight belonged to as many heads as
//   SMs, and each re-read its head's Q and dO from device memory (6.7 GB
//   a call at MLA's prefill shape, where that bound the kernel). A
//   group's dV and dK products of tile i and its Sᵀ and dPᵀ of tile i + 1
//   go to the tensor cores as one run, the k16 steps of each pair
//   alternating between their two accumulators, and the two groups take
//   turns to issue (ping-pong, named barriers): without turns they fall
//   into step, both on the tensor cores and then both on their
//   exponentials.
// - flash_bwd_dq_tc: one block per (128-row query tile, query head,
//   batch), query tiles slowest in the launch order and last first, so
//   the long causal rows start early: the same three warpgroups, Q and dO
//   resident, 128-key K and V
//   tiles through a ring of two stages, lse and Δ of the thread's two
//   rows in registers (193 KB of shared memory at D = 128; 121 KB at
//   (96, 64)). Per key tile:
//   S = Q·Kᵀ and dP = dO·Vᵀ (SS, n128), P and dS in registers,
//   dQ += dS·K (RS, K MN-major, n = D). At (96, 64) query tiles vary
//   fastest (last first: the blocks of one (b, h) share its K and V in
//   L2), and the groups take turns to issue S and dP, then dQ. It
//   recomputes S and dP rather than
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
// D = 128, 80 at (96, 64)) and Pᵀ and dSᵀ (64), at the 240 that
// setmaxnreg gives it, so
// its loop carries one counter, and dK's products are issued with dV's
// (issued while dV's ran, ptxas serialised them). ptxas reports 0 spills
// for every tc kernel.
// TMA wants 16-byte aligned bases and strides (and the pre-pass reads o
// and dO rows 8 bytes at a time): the wrapper copies a q, k, v, o or dO
// view that misses that to a contiguous tensor first.
//
// mma: f32 at every pair (3xTF32) and bf16 at D in {8, 24} (no multiple
// of wgmma's k16 depth: (8, 8) and the reduced MLA's (24, 16)), on
// warp-level mma.sync in the arithmetic of mma_common.cuh (f32 operands
// as TF32 hi + lo, three products with f32 sums; bf16 with the depth
// zero-padded to k16 in shared memory, P and dS as hi + lo bf16 parts),
// templated on (D, Dv) and on a split of 1 or 4. It replaced the first
// port's SIMT kernels (f32 FMAs on the CUDA cores, 4x4 register tiles,
// three launches, 0.147 ms at the example LM's shape where SDPA's
// backward takes 0.057, on an H100 SXM at 700 W), whose blocks were too
// few to fill the card at the small shapes, loaded each tile
// synchronously, and ran at the 67 TFLOP/s f32 rate at best.
// - flash_bwd_dq_mma: one block of 4 warps per (64 / split query rows,
//   query head, batch), tiles launched last first. Its prologue computes
//   Δ = rowsum(dO ⊙ O) over Dv for its rows (one warp a row) into shared
//   memory and into the f32 scratch (B, H, Sq) for the next kernel: no
//   pre-pass launch. Q and dO stay in shared memory; K and V tiles of 64
//   keys (32 where D + Dv >= 160) stream through two cp.async stages. Per
//   tile a warp's 16 rows take S = Q·Kᵀ and dP = dO·Vᵀ (A and B from
//   shared memory; 3xTF32's correction products in their own
//   accumulators, so a chain of dependent mma's is one a k step), P =
//   exp(S·scale − lse) (0 where masked), dS = P ⊙ (dP − Δ) and dQ += dS·K
//   (A = dS from the accumulators, in the permuted k order for TF32).
// - flash_bwd_dkdv_mma: one block of 4 warps per (16·4 / split keys, KV
//   head g, batch). K and V arrive once; the block walks the G query heads
//   of g and, for each, the query tiles that can see a key of the block
//   (the causal and window bounds), Q, dO, lse and Δ through two cp.async
//   stages. Computed transposed, so that dV and dK take their A operand
//   from registers: Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ; Pᵀ, dSᵀ; dV += Pᵀ·dO, dK +=
//   dSᵀ·Q.
// Where blocks of 64 would not fill the SMs (B·H·ceil(Sq/64), or
// B·Hkv·ceil(Sk/64), under 132) the split is 4: the four warps of a block
// share their 16 rows (dQ) or keys (dK/dV) and take every fourth slice of
// each streamed tile's keys or rows, and at the end the three partial sums
// pass through shared memory into the first warp's in a fixed order. At
// the example LM's shape (B=2, H=4, Hkv=2, S=256) dQ runs 128 blocks
// instead of 32, dK/dV 64 instead of 16. Every gradient element has one
// writer and every sum a fixed order: two calls are bit-equal, and no
// float atomics are used. cp.async copies 16-byte chunks: the rows of q,
// k, v and dO must be 16-byte aligned (the wrapper copies a view whose
// are not; o is read a scalar at a time). Bound: at the example LM's
// shape 1.7e8 FLOP, 0.0010 ms as 3xTF32 (165 TFLOP/s): the time is
// latency, the walk of a block's tiles in series.
//
// Plain C interface for ctypes (no PyTorch headers): the entry points
// launch on the caller's stream, never synchronise, allocate nothing (the
// wrapper passes the f32 scratch, bwd_scratch_floats() floats in
// flash_attention.py) and return the first cudaError_t of their
// launches (0 on success; cudaErrorInvalidValue for a (D, Dv) pair
// outside the table, H % Hkv != 0, a size out of range, a scratch too
// small, a tensor the tensor maps cannot address, or rows cp.async cannot
// copy). No pair falls back to another variant.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"
#include "tc_common.cuh"

namespace {

constexpr int kThreads = 128;            // four warps

// Element strides (b, h, s) of each tensor; D has unit stride.
enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kTensors };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;                          // (B, H, Sq): Δ, written by dQ's
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

// Stages of the cp.async ring: 2 for blocks of 64 rows or keys (the
// large shapes, where a third would cost a block an SM), 4 where the walk
// is split four ways (the small shapes: one block an SM walks its tiles in
// series, and each tile's load would wait out its latency).
__host__ __device__ constexpr int ring_stages(int split) {
  return split == 1 ? 2 : 4;
}

// Rows a streamed tile holds (keys for dQ, query rows for dK/dV): 64, or
// 32 where the head dims are wide (D + Dv >= 160: (96, 64) and f32 D =
// 128), so that two stages leave room for two blocks an SM.
__host__ __device__ constexpr int tile_rows(int d, int dv) {
  return d + dv >= 160 ? 32 : 64;
}

// Whether (q_pos, k_pos) is visible: both in range, causal, window.
__device__ __forceinline__ bool visible(const Args& a, int qp, int kp) {
  bool ok = qp < a.Sq && kp < a.Sk;
  if (a.causal) ok = ok && qp >= kp;
  if (a.window > 0) ok = ok && qp - kp < a.window;
  return ok;
}

// Partial sums of the warps that share outputs pass through shared memory
// (`red`, SPLIT - 1 slots of 32 x N floats for each owner warp) and are
// added to the owner's (split 0) in a fixed order: bit-reproducible, no
// atomics. Ends with the owner holding the sum.
template <int N, int SPLIT>
__device__ __forceinline__ void reduce_split(float (&x)[N][4], float* red,
                                             int owner, int split, int lane) {
  if constexpr (SPLIT > 1) {
    __syncthreads();                     // the stages are free
    float* mine = red + (owner * (SPLIT - 1)) * 32 * N * 4;
    if (split > 0) {
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[((split - 1) * N * 4 + 4 * n + e) * 32 + lane] = x[n][e];
    }
    __syncthreads();
    if (split == 0) {
#pragma unroll
      for (int s = 0; s < SPLIT - 1; ++s)
#pragma unroll
        for (int n = 0; n < N; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[n][e] += mine[(s * N * 4 + 4 * n + e) * 32 + lane];
    }
  }
}

// Stores the accumulators x (16 rows x W columns of a warp, scaled) into
// rows [r0, r0 + 16) of a strided (S, W) slice, rows below S.
template <typename T, int W>
__device__ __forceinline__ void store_rows(T* dst, int64_t ss,
                                           const float (&x)[W / 8][4],
                                           float scale, int r0, int S, int g,
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= S) continue;
    T* p = dst + int64_t(row) * ss + 2 * t;
#pragma unroll
    for (int n = 0; n < W / 8; ++n) {
      mma::store(p + 8 * n, scale * x[n][2 * r]);
      mma::store(p + 8 * n + 1, scale * x[n][2 * r + 1]);
    }
  }
}

// x = A·Bᵀ over W (zero-padded to the k depth) for the 16 rows of A from
// m0 and N·8 rows of B, both row-major tiles of pitch P in shared memory:
// S, dP (dQ's kernel) and Sᵀ, dPᵀ (dK/dV's). 3xTF32's correction products
// sum apart (mma::mma_ss2) and join x at the end.
template <typename T, int W, int P, int N>
__device__ __forceinline__ void score(float (&x)[N][4], const T* A, int m0,
                                      const T* B, int g, int t) {
  constexpr int KK = mma::Traits<T>::kK;
  float corr[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = corr[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < mma::kwidth<T>(W) / KK; ++kk) {
    mma::FragA fa;
    mma::load_a<P>(fa, A, m0, kk * KK, g, t);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      mma::FragB fb;
      mma::load_b_nk<P>(fb, B, 8 * j, kk * KK, g, t);
      mma::mma_ss2(x[j], corr[j], fa, fb, T{});
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] += corr[j][e];
}

// Shared memory of the dQ block, in bytes: Q and dO tiles of BQ rows, the
// stages of K and V tiles of BK keys, then lse and Δ of the BQ rows.
template <typename T, int D, int DV, int KS>
struct DqSmem {
  static constexpr int kBK = tile_rows(D, DV);
  static constexpr int kBQ = 16 * (4 / KS);
  static constexpr int kStages = ring_stages(KS);
  static constexpr int kPQ = mma::pitch<T>(D), kPV = mma::pitch<T>(DV);
  static constexpr int kQ = 0;                       // offsets in elements
  static constexpr int kDO = kQ + kBQ * kPQ;
  static constexpr int kK = kDO + kBQ * kPV;
  static constexpr int kV = kK + kStages * kBK * kPQ;
  static constexpr int kElems = kV + kStages * kBK * kPV;
  static constexpr size_t kStats = size_t(kElems) * sizeof(T);   // bytes
  static constexpr size_t kBytes = kStats + 2 * kBQ * sizeof(float);
  // The split warps' partial dQ (4 - 4/KS warps of 32 x D/2 floats) reuses
  // the K and V stages.
  static_assert((4 - 4 / KS) * 32 * (D / 2) * sizeof(float) <=
                    size_t(kStages * kBK * (kPQ + kPV)) * sizeof(T),
                "dQ's reduction does not fit the K/V stages");
};

// dQ and Δ: one block of 4 warps per (16·4/KS query rows, query head,
// batch), tiles launched last first (the long causal rows start early).
// Its prologue computes Δ = rowsum(dO ⊙ O) of its rows into shared memory
// and the f32 scratch (the dK/dV kernel, launched after it, reads it
// there). K and V tiles stream through a cp.async ring. Each warp owns 16
// rows; the KS warps of a row group take every
// KS-th slice of BK/KS keys of each streamed K/V tile, and their dQ sums
// meet at the end in a fixed order.
template <typename T, int D, int DV, int KS>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_mma(Args a) {
  using L = DqSmem<T, D, DV, KS>;
  constexpr int BK = L::kBK, BQ = L::kBQ, KC = BK / KS, NS = L::kStages;
  constexpr int PQ = L::kPQ, PV = L::kPV;
  constexpr int KK = mma::Traits<T>::kK;
  static_assert(KC % KK == 0, "a warp's key slice is whole k steps");
  extern __shared__ float4 smem4[];
  T* sm = reinterpret_cast<T*>(smem4);
  float* lse_s = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(smem4) + L::kStats);
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp / KS, ks = warp % KS;    // row group, key slice
  const int nq = (a.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - int(blockIdx.x)) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const T* Q = slice<T>(a, kQ, a.q, b, h);
  const T* dO = slice<T>(a, kDO, a.dout, b, h);
  const T* K = slice<T>(a, kK, a.k, b, hk);
  const T* V = slice<T>(a, kV, a.v, b, hk);

  // Reachable key tiles, as the forward bounds them.
  const int nk = (a.Sk + BK - 1) / BK;
  int kt_end = nk;
  if (a.causal) kt_end = min(nk, (q0 + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0)
    kt_begin = (q0 - a.window + 1) / BK;
  const int n_tiles = max(kt_end - kt_begin, 0);

  mma::zero_pad<T, D, PQ, kThreads>(sm + L::kQ, BQ, tid);
  mma::zero_pad<T, DV, PV, kThreads>(sm + L::kDO, BQ, tid);
  mma::zero_pad<T, D, PQ, kThreads>(sm + L::kK, NS * BK, tid);
  mma::zero_pad<T, DV, PV, kThreads>(sm + L::kV, NS * BK, tid);
  auto load_kv = [&](int kt, int st) {
    mma::copy_rows<T, BK, D, PQ, kThreads>(sm + L::kK + st * BK * PQ, K,
                                           a.st[kK][2], kt * BK, a.Sk, tid);
    mma::copy_rows<T, BK, DV, PV, kThreads>(sm + L::kV + st * BK * PV, V,
                                            a.st[kV][2], kt * BK, a.Sk, tid);
  };
  mma::copy_rows<T, BQ, D, PQ, kThreads>(sm + L::kQ, Q, a.st[kQ][2], q0,
                                         a.Sq, tid);
  mma::copy_rows<T, BQ, DV, PV, kThreads>(sm + L::kDO, dO, a.st[kDO][2], q0,
                                          a.Sq, tid);
  // Q, dO and the first NS - 1 tiles in flight, one commit group each
  // (empty past the last tile, so that group i is tile i's).
#pragma unroll
  for (int p = 0; p < NS - 1; ++p) {
    if (p < n_tiles) load_kv(kt_begin + p, p);
    mma::commit();
  }

  // Δ and lse of the block's rows, one warp a row at a time.
  {
    const T* O = slice<T>(a, kO, a.o, b, h);
    for (int r = warp; r < BQ; r += kThreads / 32) {
      const int s = q0 + r;
      float acc = 0.f;
      if (s < a.Sq)
        for (int c = lane; c < DV; c += 32)
          acc = fmaf(mma::to_f32(dO[int64_t(s) * a.st[kDO][2] + c]),
                     mma::to_f32(O[int64_t(s) * a.st[kO][2] + c]), acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        const int64_t idx = (int64_t(b) * a.H + h) * a.Sq + s;
        dl_s[r] = acc;
        lse_s[r] = s < a.Sq ? a.lse[idx] : 0.f;
        if (s < a.Sq) a.delta[idx] = acc;
      }
    }
  }
  __syncthreads();
  const int r0 = 16 * rg;                      // the warp's rows in the tile
  const int row = q0 + r0 + g;                 // and row + 8
  const float lse_r[2] = {lse_s[r0 + g], lse_s[r0 + g + 8]};
  const float dl_r[2] = {dl_s[r0 + g], dl_s[r0 + g + 8]};
  const T* Qs = sm + L::kQ;
  const T* dOs = sm + L::kDO;

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % NS;
    if (i + NS - 1 < n_tiles)
      load_kv(kt_begin + i + NS - 1, (i + NS - 1) % NS);
    mma::commit();
    mma::wait<NS - 1>();                       // tile i has landed
    __syncthreads();
    const int c0 = ks * KC;                    // the warp's keys in the tile
    const int kw0 = (kt_begin + i) * BK + c0;
    const T* Ks = sm + L::kK + st * BK * PQ + c0 * PQ;
    const T* Vs = sm + L::kV + st * BK * PV + c0 * PV;

    // S = Q·Kᵀ and dP = dO·Vᵀ: 16 rows x KC keys.
    float s[KC / 8][4], dp[KC / 8][4];
    score<T, D, PQ, KC / 8>(s, Qs, r0, Ks, g, t);
    score<T, DV, PV, KC / 8>(dp, dOs, r0, Vs, g, t);

    // P = exp(S·scale − lse), 0 where masked; dS = P ⊙ (dP − Δ), in s.
    // s[j][e] is row row + 8 (e / 2), key kw0 + 8j + 2t + e % 2.
    const bool edge = kw0 + KC > a.Sk ||
                      (a.causal && kw0 + KC - 1 > q0 + r0) ||
                      (a.window > 0 && q0 + r0 + 15 - kw0 >= a.window);
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[j][e] * a.scale - lse_r[e / 2]);
        if (edge && !visible(a, row + 8 * (e / 2), kw0 + 8 * j + 2 * t + e % 2))
          p = 0.f;
        s[j][e] = p * (dp[j][e] - dl_r[e / 2]);
      }
    }

    // dQ += dS·K over the warp's keys: A = dS from registers (split).
    mma::accumulate<T, PQ>(dq, s, Ks, g, t);
    __syncthreads();    // every warp is done with stage st before its refill
  }
  mma::wait<0>();

  reduce_split<D / 8, KS>(dq, reinterpret_cast<float*>(sm + L::kK), rg, ks,
                          lane);
  if (ks == 0)
    store_rows<T, D>(static_cast<T*>(a.dq) + b * a.st[kDQ][0] +
                         h * a.st[kDQ][1],
                     a.st[kDQ][2], dq, a.scale, q0 + r0, a.Sq, g, t);
}

// Shared memory of the dK/dV block, in bytes: the block's K and V tiles,
// the stages of Q and dO tiles of BR rows, then the stages of their lse
// and Δ.
template <typename T, int D, int DV, int QS>
struct DkdvSmem {
  static constexpr int kKeys = 16 * (4 / QS);
  static constexpr int kBR = tile_rows(D, DV);
  static constexpr int kStages = ring_stages(QS);
  static constexpr int kPQ = mma::pitch<T>(D), kPV = mma::pitch<T>(DV);
  static constexpr int kK = 0;                       // offsets in elements
  static constexpr int kV = kK + kKeys * kPQ;
  static constexpr int kQ = kV + kKeys * kPV;
  static constexpr int kDO = kQ + kStages * kBR * kPQ;
  static constexpr int kElems = kDO + kStages * kBR * kPV;
  static constexpr size_t kStats = size_t(kElems) * sizeof(T);   // bytes
  static constexpr size_t kBytes =
      kStats + kStages * 2 * kBR * sizeof(float);
  // The split warps' partial dK, then dV (4 - 4/QS warps of 32 x D/2 and
  // of 32 x Dv/2 floats) reuse the Q and dO stages.
  static_assert((4 - 4 / QS) * 32 * ((D > DV ? D : DV) / 2) * sizeof(float) <=
                    size_t(kStages * kBR * (kPQ + kPV)) * sizeof(T),
                "dK/dV's reduction does not fit the Q/dO stages");
};

// dK and dV: one block of 4 warps per (16·4/QS keys, KV head g, batch). K
// and V arrive once; the block walks the G query heads of g and, for
// each, the BR-row query tiles that can see a key of the block (the causal
// and window bounds), Q, dO, lse and Δ through a cp.async ring. Each
// warp owns 16 keys; the QS warps of a key group take every QS-th slice of
// BR/QS rows of each tile, and their dK and dV sums meet at the end in a
// fixed order. Computed transposed, so that the products after the first
// two take their A operand from registers:
//   Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ; Pᵀ = exp(Sᵀ·scale − lse), 0 where masked;
//   dSᵀ = Pᵀ ⊙ (dPᵀ − Δ); dV += Pᵀ·dO, dK += dSᵀ·Q.
template <typename T, int D, int DV, int QS>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_mma(Args a) {
  using L = DkdvSmem<T, D, DV, QS>;
  constexpr int KEYS = L::kKeys, BR = L::kBR, RW = BR / QS;
  constexpr int NS = L::kStages;
  constexpr int PQ = L::kPQ, PV = L::kPV;
  constexpr int KK = mma::Traits<T>::kK;
  static_assert(RW % KK == 0, "a warp's row slice is whole k steps");
  extern __shared__ float4 smem4[];
  T* sm = reinterpret_cast<T*>(smem4);
  float* stats = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(smem4) + L::kStats);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kg = warp / QS, qs = warp % QS;    // key group, row slice
  const int k0 = blockIdx.x * KEYS;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  // Query tiles that can see a key of this block: causal, rows >= k0;
  // window, rows <= k0 + KEYS - 2 + W.
  const int nq = (a.Sq + BR - 1) / BR;
  const int qt_begin = a.causal ? min(k0 / BR, nq) : 0;
  int qt_end = nq;
  if (a.window > 0) qt_end = min(nq, (k0 + KEYS - 2 + a.window) / BR + 1);
  const int per_head = max(qt_end - qt_begin, 0);
  const int n_items = G * per_head;

  mma::zero_pad<T, D, PQ, kThreads>(sm + L::kK, KEYS, tid);
  mma::zero_pad<T, DV, PV, kThreads>(sm + L::kV, KEYS, tid);
  mma::zero_pad<T, D, PQ, kThreads>(sm + L::kQ, NS * BR, tid);
  mma::zero_pad<T, DV, PV, kThreads>(sm + L::kDO, NS * BR, tid);
  mma::copy_rows<T, KEYS, D, PQ, kThreads>(
      sm + L::kK, slice<T>(a, kK, a.k, b, hk), a.st[kK][2], k0, a.Sk, tid);
  mma::copy_rows<T, KEYS, DV, PV, kThreads>(
      sm + L::kV, slice<T>(a, kV, a.v, b, hk), a.st[kV][2], k0, a.Sk, tid);
  // Item i: query head hk·G + i / per_head, query tile qt_begin + i %
  // per_head, into stage st.
  auto load_item = [&](int i, int st) {
    const int h = hk * G + i / per_head;
    const int q0 = (qt_begin + i % per_head) * BR;
    mma::copy_rows<T, BR, D, PQ, kThreads>(sm + L::kQ + st * BR * PQ,
                                           slice<T>(a, kQ, a.q, b, h),
                                           a.st[kQ][2], q0, a.Sq, tid);
    mma::copy_rows<T, BR, DV, PV, kThreads>(sm + L::kDO + st * BR * PV,
                                            slice<T>(a, kDO, a.dout, b, h),
                                            a.st[kDO][2], q0, a.Sq, tid);
    const int64_t row0 = (int64_t(b) * a.H + h) * a.Sq;
    mma::copy_stats<kThreads>(stats + st * 2 * BR, a.lse + row0, BR, q0,
                              a.Sq, tid);
    mma::copy_stats<kThreads>(stats + st * 2 * BR + BR, a.delta + row0, BR,
                              q0, a.Sq, tid);
  };
  // K, V and the first NS - 1 items in flight, one commit group each
  // (empty past the last item, so that group i is item i's).
#pragma unroll
  for (int p = 0; p < NS - 1; ++p) {
    if (p < n_items) load_item(p, p);
    mma::commit();
  }

  const int kr0 = 16 * kg;                     // the warp's keys in the block
  const int key = k0 + kr0 + g;                // and key + 8
  const int rr0 = qs * RW;                     // the warp's rows in a tile
  const T* Ks = sm + L::kK;
  const T* Vs = sm + L::kV;
  float dk[D / 8][4], dv[DV / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = 0.f;

  for (int i = 0; i < n_items; ++i) {
    const int st = i % NS;
    if (i + NS - 1 < n_items) load_item(i + NS - 1, (i + NS - 1) % NS);
    mma::commit();
    mma::wait<NS - 1>();                       // item i has landed
    __syncthreads();
    const int q0 = (qt_begin + i % per_head) * BR + rr0;   // the warp's rows
    const T* Qs = sm + L::kQ + st * BR * PQ + rr0 * PQ;
    const T* dOs = sm + L::kDO + st * BR * PV + rr0 * PV;
    const float* lse_s = stats + st * 2 * BR + rr0;
    const float* dl_s = lse_s + BR;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 16 keys x RW rows.
    float sT[RW / 8][4], dpT[RW / 8][4];
    score<T, D, PQ, RW / 8>(sT, Ks, kr0, Qs, g, t);
    score<T, DV, PV, RW / 8>(dpT, Vs, kr0, dOs, g, t);

    // Pᵀ and dSᵀ: sT[j][e] is key key + 8 (e / 2), row q0 + 8j + 2t + e % 2.
    const bool edge = k0 + kr0 + 16 > a.Sk || q0 + RW > a.Sq ||
                      (a.causal && q0 < k0 + kr0 + 15) ||
                      (a.window > 0 && q0 + RW - 1 - (k0 + kr0) >= a.window);
#pragma unroll
    for (int j = 0; j < RW / 8; ++j) {
      const float2 lj = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
      const float2 dj = *reinterpret_cast<const float2*>(dl_s + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(sT[j][e] * a.scale - (e % 2 ? lj.y : lj.x));
        if (edge && !visible(a, q0 + 8 * j + 2 * t + e % 2, key + 8 * (e / 2)))
          p = 0.f;
        dpT[j][e] = p * (dpT[j][e] - (e % 2 ? dj.y : dj.x));
        sT[j][e] = p;
      }
    }

    // dV += Pᵀ·dO and dK += dSᵀ·Q over the warp's rows: A from registers.
    mma::accumulate<T, PV>(dv, sT, dOs, g, t);
    mma::accumulate<T, PQ>(dk, dpT, Qs, g, t);
    __syncthreads();    // every warp is done with stage st before its refill
  }
  mma::wait<0>();

  float* red = reinterpret_cast<float*>(sm + L::kQ);
  reduce_split<D / 8, QS>(dk, red, kg, qs, lane);
  reduce_split<DV / 8, QS>(dv, red, kg, qs, lane);
  if (qs == 0) {
    store_rows<T, D>(static_cast<T*>(a.dk) + b * a.st[kDK][0] +
                         hk * a.st[kDK][1],
                     a.st[kDK][2], dk, a.scale, k0 + kr0, a.Sk, g, t);
    store_rows<T, DV>(static_cast<T*>(a.dv) + b * a.st[kDV][0] +
                          hk * a.st[kDV][1],
                      a.st[kDV][2], dv, 1.f, k0 + kr0, a.Sk, g, t);
  }
}

template <typename T, int D, int DV, int KS>
int launch_dq(const Args& a, cudaStream_t stream) {
  using L = DqSmem<T, D, DV, KS>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma<T, D, DV, KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::kBytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.Sq + L::kBQ - 1) / L::kBQ, a.H, a.B);
  flash_bwd_dq_mma<T, D, DV, KS><<<grid, kThreads, L::kBytes, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T, int D, int DV, int QS>
int launch_dkdv(const Args& a, cudaStream_t stream) {
  using L = DkdvSmem<T, D, DV, QS>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_mma<T, D, DV, QS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::kBytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.Sk + L::kKeys - 1) / L::kKeys, a.Hkv, a.B);
  flash_bwd_dkdv_mma<T, D, DV, QS><<<grid, kThreads, L::kBytes, stream>>>(a);
  return int(cudaGetLastError());
}

// dQ (with Δ) first, then dK/dV, which reads Δ. Each splits its walk four
// ways (blocks of 16 rows or 16 keys, four times as many) where its blocks
// of 64 would not fill the SMs: at the example LM's shape (B=2, H=4,
// Hkv=2, S=256) dQ has 128 blocks instead of 32, dK/dV 64 instead of 16.
template <typename T, int D, int DV>
int launch_d(const Args& a, cudaStream_t stream) {
  const int sms = mma::sm_count();
  const int64_t dq_blocks = int64_t((a.Sq + 63) / 64) * a.H * a.B;
  int err = dq_blocks >= sms ? launch_dq<T, D, DV, 1>(a, stream)
                             : launch_dq<T, D, DV, 4>(a, stream);
  if (err != 0) return err;
  const int64_t kv_blocks = int64_t((a.Sk + 63) / 64) * a.Hkv * a.B;
  return kv_blocks >= sms ? launch_dkdv<T, D, DV, 1>(a, stream)
                          : launch_dkdv<T, D, DV, 4>(a, stream);
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
  constexpr int kElem = sizeof(T);
  // cp.async reads q, k, v and dO in 16-byte chunks.
  if (!mma::rows_aligned(q, strides[0], strides[1], strides[2], B, H, Sq,
                         kElem) ||
      !mma::rows_aligned(k, strides[3], strides[4], strides[5], B, Hkv, Sk,
                         kElem) ||
      !mma::rows_aligned(v, strides[6], strides[7], strides[8], B, Hkv, Sk,
                         kElem) ||
      !mma::rows_aligned(dout, strides[12], strides[13], strides[14], B, H,
                         Sq, kElem))
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
  // bf16 reaches this variant at (8, 8) and (24, 16) alone (variant_for:
  // D not a multiple of wgmma's k16), f32 at every pair.
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
constexpr int kRowPad = 128;             // scratch rows: Sq rounded up
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the dK/dV block, in bytes from a 1024-aligned base. A
// tile of R rows is Tile<D>::kChunks chunks of [R rows][kCols bf16], each
// in TMA's swizzle of its row width (the layout the wgmma descriptors
// read). K and Q are D wide (MLA's 96: three 32-column chunks, no column
// of zeros), V and dO DV (zero-padded to 64 below it).
template <int D, int DV>
struct SmemKV {
  using TQK = Tile<D>;
  using TV = Tile<DV>;
  // Keys a block: 64 (both groups on them, every other query tile each),
  // 128 at (96, 64) (64 a group, every query tile: half the blocks, and
  // each Q and dO tile read once for 128 keys).
  static constexpr int kBlockKeys = TQK::kCols == 32 ? 2 * kKeys : kKeys;
  static constexpr int kKChunk = kBlockKeys * TQK::kRowBytes;
  static constexpr int kVChunk = kBlockKeys * TV::kRowBytes;
  static constexpr int kQChunk = kRows * TQK::kRowBytes;
  static constexpr int kDOChunk = kRows * TV::kRowBytes;
  static constexpr int kKT = TQK::kChunks * kKChunk;    // the K tile
  static constexpr int kVT = TV::kChunks * kVChunk;     // the V tile
  static constexpr int kQT = TQK::kChunks * kQChunk;    // one Q tile
  static constexpr int kDOT = TV::kChunks * kDOChunk;   // one dO tile
  static constexpr int kStat = 2 * kRows * 4;           // lse·log2e, Δ
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKT;
  static constexpr int kQ = kV + kVT;                   // kRowStages each
  static constexpr int kDO = kQ + kRowStages * kQT;
  static constexpr int kStats = kDO + kRowStages * kDOT;
  static constexpr int kBar = kStats + kRowStages * kStat;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kRowStages) + 1024;
  // Group 1's dK and dV pass to group 0 through the Q stages.
  static_assert((TQK::kWidth + TV::kWidth) / 2 * 4 * kGroup <=
                    kRowStages * kQT,
                "the dK/dV reduction does not fit the Q stages");
};

// Shared memory of the dQ block: Q and dO resident, a ring of two K/V
// tiles (193 KB at D = 128).
template <int D, int DV>
struct SmemQ {
  using TQK = Tile<D>;
  using TV = Tile<DV>;
  static constexpr int kStages = 2;
  static constexpr int kQChunk = kQRows * TQK::kRowBytes;
  static constexpr int kDOChunk = kQRows * TV::kRowBytes;
  static constexpr int kKChunk = kQKeys * TQK::kRowBytes;
  static constexpr int kVChunk = kQKeys * TV::kRowBytes;
  static constexpr int kQT = TQK::kChunks * kQChunk;    // the Q tile
  static constexpr int kDOT = TV::kChunks * kDOChunk;   // the dO tile
  static constexpr int kKT = TQK::kChunks * kKChunk;    // one K tile
  static constexpr int kVT = TV::kChunks * kVChunk;     // one V tile
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQT;
  static constexpr int kK = kDO + kDOT;                 // kStages each
  static constexpr int kV = kK + kStages * kKT;
  static constexpr int kBar = kV + kStages * kVT;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
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

// Ping-pong of the two consumer groups (group w = 0, 1): named barrier 2
// + w is group w's turn to issue its products. A group takes its turn
// before it issues and passes it to the other right after, so that one
// group's exponentials run while the other's products hold the tensor
// cores (without turns the groups fall into step: both issue, both wait,
// both compute). The groups' turns must pair up: group 1 passes once up
// front so that group 0 goes first, and a last pass may go untaken.
// (Barrier 1 is the dK/dV reduction's.)
__device__ __forceinline__ void take_turn(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(2 + wg) : "memory");
}
__device__ __forceinline__ void pass_turn(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(3 - wg) : "memory");
}
__device__ __forceinline__ void first_turn(int wg) {
  if (wg == 1) asm volatile("bar.arrive 2, 256;\n" ::: "memory");
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

// One k16 step kk of acc (+)= A·Bᵀ over D: A this group's 64 rows, B a
// tile of N = 2·|acc| rows, both K-major in shared memory in Tile<D>'s
// chunks, `a_chunk` / `b_chunk` bytes apart; accumulate from kk = 1 on.
template <int D, int N>
__device__ __forceinline__ void ss_step(float (&acc)[N / 2], uint32_t a,
                                        int a_chunk, uint32_t b, int b_chunk,
                                        int kk) {
  using T = Tile<D>;
  const uint64_t da = T::k_major(a, a_chunk, kk);
  const uint64_t db = T::k_major(b, b_chunk, kk);
  if constexpr (N == 128)
    wgmma_ss_n128(acc, da, db, kk > 0);
  else
    wgmma_ss_n64(acc, da, db, kk > 0);
}

// acc = A·Bᵀ over D (D/16 k16 steps, ss_step). Fenced, issued and
// committed; not waited for.
template <int D, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a,
                                         int a_chunk, uint32_t b,
                                         int b_chunk) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ss_step<D, N>(acc, a, a_chunk, b, b_chunk, kk);
  wgmma_commit();
}

// Two such products as one group, their k16 steps alternating (two
// accumulators, so that neither's chain of dependent wgmmas waits on
// itself alone); each sum in issue_ss's order.
template <int D0, int D1, int N>
__device__ __forceinline__ void issue_ss2(float (&acc0)[N / 2], uint32_t a0,
                                          int a0_chunk, uint32_t b0,
                                          int b0_chunk, float (&acc1)[N / 2],
                                          uint32_t a1, int a1_chunk,
                                          uint32_t b1, int b1_chunk) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < (D0 > D1 ? D0 : D1) / 16; ++kk) {
    if (kk < D0 / 16) ss_step<D0, N>(acc0, a0, a0_chunk, b0, b0_chunk, kk);
    if (kk < D1 / 16) ss_step<D1, N>(acc1, a1, a1_chunk, b1, b1_chunk, kk);
  }
  wgmma_commit();
}

// One k16 step kk of acc += A·B: A the bf16 fragments f[4kk .. 4kk + 3],
// B rows 16kk.. of a tile MN-major in shared memory over Tile<W>'s kWidth
// columns (its chunks `b_chunk` bytes apart; transpose bit): n64, n96
// (MLA's q and k, three 32-column chunks) or n128.
template <int W, int R>
__device__ __forceinline__ void rs_step(float (&acc)[Tile<W>::kWidth / 2],
                                        const uint32_t (&f)[R], uint32_t b,
                                        int b_chunk, int kk) {
  using T = Tile<W>;
  const uint64_t db = T::mn_major(b, b_chunk, kk);
  if constexpr (T::kWidth == 128)
    wgmma_rs_n128(acc, f[4 * kk], f[4 * kk + 1], f[4 * kk + 2],
                  f[4 * kk + 3], db);
  else if constexpr (T::kWidth == 96)
    wgmma_rs_n96(acc, f[4 * kk], f[4 * kk + 1], f[4 * kk + 2],
                 f[4 * kk + 3], db);
  else
    wgmma_rs_n64(acc, f[4 * kk], f[4 * kk + 1], f[4 * kk + 2],
                 f[4 * kk + 3], db);
}

// acc += (hi + lo)·B over 16·KS rows of B (rs_step): hi's steps, then
// lo's. Fenced, issued and committed as one group; not waited for.
template <int W, int KS>
__device__ __forceinline__ void issue_rs(float (&acc)[Tile<W>::kWidth / 2],
                                         uint32_t (&hi)[4 * KS],
                                         uint32_t (&lo)[4 * KS],
                                         uint32_t b, int b_chunk) {
  fence_regs(acc);
  fence_regs(hi);
  fence_regs(lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) rs_step<W>(acc, hi, b, b_chunk, kk);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) rs_step<W>(acc, lo, b, b_chunk, kk);
  wgmma_commit();
}

// Two such products as one group, their k16 steps alternating (as
// issue_ss2); each sum in issue_rs's order.
template <int W0, int W1, int KS>
__device__ __forceinline__ void issue_rs2(
    float (&acc0)[Tile<W0>::kWidth / 2], uint32_t (&hi0)[4 * KS],
    uint32_t (&lo0)[4 * KS], uint32_t b0, int b0_chunk,
    float (&acc1)[Tile<W1>::kWidth / 2], uint32_t (&hi1)[4 * KS],
    uint32_t (&lo1)[4 * KS], uint32_t b1, int b1_chunk) {
  fence_regs(acc0);
  fence_regs(hi0);
  fence_regs(lo0);
  fence_regs(acc1);
  fence_regs(hi1);
  fence_regs(lo1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    rs_step<W0>(acc0, hi0, b0, b0_chunk, kk);
    rs_step<W1>(acc1, hi1, b1, b1_chunk, kk);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    rs_step<W0>(acc0, lo0, b0, b0_chunk, kk);
    rs_step<W1>(acc1, lo1, b1, b1_chunk, kk);
  }
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

// flash_bwd_prep's outputs for MLA's (96, 64): a row in DV/8 lanes, each
// one 16-byte load of o and of dO, the row's sum over its lanes by xor
// shuffles (a fixed order). One warp a row, 16 of its lanes loading 8
// bytes at DV = 64, took three times its bytes' time at MLA's training
// shape; flash_bwd_prep stays as it is for the (D, D) pairs.
template <int DV>
__global__ void flash_bwd_prep_rows(PrepArgs p) {
  constexpr int kLanes = DV / 8;                 // lanes a row
  static_assert(DV % 8 == 0 && 32 % kLanes == 0, "a row in whole lanes");
  const int64_t row =
      (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kLanes;
  const int c = threadIdx.x % kLanes;            // the lane's 8 columns
  float acc = 0.f, l2 = 0.f;
  if (row < p.rows) {
    const int s = int(row % p.SqPad);
    const int64_t bh = row / p.SqPad;
    const int h = int(bh % p.H), b = int(bh / p.H);
    if (s < p.Sq) {
      const uint4 x = reinterpret_cast<const uint4*>(
          p.o + b * p.o_sb + h * p.o_sh + s * p.o_ss)[c];
      const uint4 y = reinterpret_cast<const uint4*>(
          p.dout + b * p.do_sb + h * p.do_sh + s * p.do_ss)[c];
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
      const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 xo = unpack_bf16(xs[i]), yo = unpack_bf16(ys[i]);
        acc = fmaf(yo.x, xo.x, acc);
        acc = fmaf(yo.y, xo.y, acc);
      }
      l2 = p.lse[bh * p.Sq + s] * kLog2e;
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < p.rows && c == 0) {
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
  // dK's columns (the n of dSᵀ·Q) DPQK: D, 96 at MLA's pair (three
  // 32-column chunks, an n96 product: no column of zeros); below 64 the
  // zero-padded chunk's 64, never stored. dV's DPV likewise.
  using L = SmemKV<D, DV>;
  using TQK = typename L::TQK;
  using TV = typename L::TV;
  constexpr int DPQK = TQK::kWidth, DPV = TV::kWidth;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // mbarriers: K and V loaded; per stage Q, dO, lse, Δ loaded and free.
  const uint32_t bar_kv = base + L::kBar;
  const uint32_t full = bar_kv + 8, empty = full + 8 * kRowStages;

  // Key blocks vary slowest in the launch order, so the blocks whose keys
  // most query rows see (causal: the first) start first. At (96, 64)
  // (kOwn) they vary fastest, first keys first: the blocks of one (b, g)
  // run together and read its Q and dO tiles from L2. With them slowest
  // the blocks in flight belong to ~132 heads, and each 64-key block
  // read its head's Q and dO from device memory (6.7 GB a call at MLA's
  // prefill shape: the kernel was bound by those bytes).
  constexpr bool kOwn = TQK::kCols == 32;
  constexpr int KB = L::kBlockKeys;
  const int k0 = (kOwn ? blockIdx.x : blockIdx.z) * KB;
  const int g = kOwn ? blockIdx.y : blockIdx.x;
  const int b = kOwn ? blockIdx.z : blockIdx.y;
  const int G = a.H / a.Hkv;
  // Query tiles that can see a key of this block: causal, rows >= k0;
  // window, rows <= k0 + KB - 2 + W.
  const int nq = (a.Sq + kRows - 1) / kRows;
  const int qt_begin = a.causal ? min(k0 / kRows, nq) : 0;
  int qt_end = nq;
  if (a.window > 0)
    qt_end = min(nq, (k0 + KB - 2 + a.window) / kRows + 1);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kRowStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kOwn ? kConsumers : kGroup);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the TMA loads in flight; a
    // stage is refilled once the group that took its tile is done (at
    // (96, 64) both groups take every tile).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_kv, L::kKT + L::kVT);
      for (int c = 0; c < TQK::kChunks; ++c)
        tma_load(base + L::kK + c * L::kKChunk, &tk, bar_kv, TQK::kCols * c,
                 g, k0, b);
      for (int c = 0; c < TV::kChunks; ++c)
        tma_load(base + L::kV + c * L::kVChunk, &tv, bar_kv, TV::kCols * c,
                 g, k0, b);
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
          for (int c = 0; c < TQK::kChunks; ++c)
            tma_load(base + L::kQ + s * L::kQT + c * L::kQChunk, &tq, bar,
                     TQK::kCols * c, h, q0, b);
          for (int c = 0; c < TV::kChunks; ++c)
            tma_load(base + L::kDO + s * L::kDOT + c * L::kDOChunk, &tdo,
                     bar, TV::kCols * c, h, q0, b);
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
  // tiles i = w, w + 2, ... (stages w and w + 2 of the ring); at (96, 64)
  // group w takes keys kg0 = k0 + 64w of the block's 128, every tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int kg0 = kOwn ? k0 + kKeys * wg : k0;        // this group's keys
  const int key0 = kg0 + 16 * warp + lane / 4;       // and key0 + 8
  const int col0 = 2 * (lane % 4);                   // rows q0 + 8j + col0
  const uint32_t k_smem =
      base + L::kK + (kOwn ? wg * kKeys * TQK::kRowBytes : 0);
  const uint32_t v_smem =
      base + L::kV + (kOwn ? wg * kKeys * TV::kRowBytes : 0);
  const float sl2 = a.scale * kLog2e;

  float dk[DPQK / 2], dv[DPV / 2];
#pragma unroll
  for (int i = 0; i < DPQK / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DPV / 2; ++i) dv[i] = 0.f;
  float st[kRows / 2], dpt[kRows / 2];   // Sᵀ, dPᵀ: 64 keys x 64 rows
  uint32_t ph[kRows / 4], pl[kRows / 4], sh[kRows / 4], sl[kRows / 4];

  // Pᵀ from Sᵀ in place: st[4j + e] is key key0 + 8 (e / 2), row q0 + 8j
  // + col0 + e % 2; `masked` (a std::bool_constant) says whether some
  // (row, key) pair of the tile is masked for this group.
  auto probs = [&](auto masked, int q0, uint32_t lse2) {
    constexpr bool kMasked = decltype(masked)::value;
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
  };
  // dSᵀ = Pᵀ ⊙ (dPᵀ − Δ) in place, then both as hi + lo fragments.
  auto grads = [&](uint32_t dlt) {
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * j + e] =
            st[4 * j + e] *
            (dpt[4 * j + e] - ld_shared(dlt + 4 * (8 * j + col0 + (e & 1))));
    split_bf16(ph, pl, st);
    split_bf16(sh, sl, dpt);
  };
  // One query tile, whole.
  auto tile = [&](auto masked, int q0, uint32_t q_s, uint32_t do_s,
                  uint32_t lse2, uint32_t dlt) {
    constexpr bool kMasked = decltype(masked)::value;
    issue_ss<D, kRows>(st, k_smem, L::kKChunk, q_s, L::kQChunk);
    issue_ss<DV, kRows>(dpt, v_smem, L::kVChunk, do_s, L::kDOChunk);
    if constexpr (kMasked)
      wgmma_wait<0>();
    else
      wgmma_wait<1>();                   // Sᵀ done, dPᵀ may run on
    fence_regs(st);
    probs(masked, q0, lse2);
    if constexpr (!kMasked) wgmma_wait<0>();
    fence_regs(dpt);
    grads(dlt);
    issue_rs<DV, kRows / 16>(dv, ph, pl, do_s, L::kDOChunk);
    issue_rs<D, kRows / 16>(dk, sh, sl, q_s, L::kQChunk);
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
  auto edge_tile = [&](int q0) {
    return kg0 + kKeys > a.Sk || q0 + kRows > a.Sq ||
           (a.causal && q0 < kg0 + kKeys - 1) ||
           (a.window > 0 && q0 + kRows - 1 - kg0 >= a.window);
  };
  if constexpr (kOwn) {
    // (96, 64), whose dK and dV leave registers to spare: both groups walk
    // every tile, each on its 64 keys. Tile i's dV and dK products and
    // tile i + 1's Sᵀ and dPᵀ go to the tensor cores as one run, their
    // k16 steps alternating between the two accumulators of each pair
    // (past the last tile, Sᵀ and dPᵀ of its own stage again, never
    // read), in the group's turn (ping-pong: the other group's
    // exponentials meanwhile). A group whose keys a tile cannot see (the
    // causal diagonal's first tile for group 1) computes P = 0 there. No
    // wgmma is in flight across a branch.
    auto issue_s = [&](int s) {
      issue_ss2<D, DV, kRows>(st, k_smem, L::kKChunk,
                              base + L::kQ + s * L::kQT, L::kQChunk, dpt,
                              v_smem, L::kVChunk,
                              base + L::kDO + s * L::kDOT, L::kDOChunk);
    };
    first_turn(wg);
    if (n_tiles > 0) {
      mbar_wait(full, 0);
      issue_s(0);
      wgmma_wait<0>();
    }
    for (int i = 0; i < n_tiles; ++i) {
      fence_regs(st);
      fence_regs(dpt);
      const int s = i % kRowStages;
      const int q0 = (qt_begin + i % per_head) * kRows;
      const uint32_t lse2 = base + L::kStats + s * L::kStat;
      if (edge_tile(q0))
        probs(std::true_type{}, q0, lse2);
      else
        probs(std::false_type{}, q0, lse2);
      grads(lse2 + 4 * kRows);
      const bool more = i + 1 < n_tiles;
      const int s2 = more ? (i + 1) % kRowStages : s;
      if (more) mbar_wait(full + 8 * s2, ((i + 1) / kRowStages) & 1);
      take_turn(wg);
      issue_rs2<DV, D, kRows / 16>(dv, ph, pl, base + L::kDO + s * L::kDOT,
                                   L::kDOChunk, dk, sh, sl,
                                   base + L::kQ + s * L::kQT, L::kQChunk);
      issue_s(s2);
      pass_turn(wg);
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(empty + 8 * s);
    }
  } else {
  for (int i = wg; i < n_tiles; i += 2) {
    const int s = i % kRowStages;
    const int q0 = (qt_begin + i % per_head) * kRows;
    const uint32_t q_s = base + L::kQ + s * L::kQT;
    const uint32_t do_s = base + L::kDO + s * L::kDOT;
    const uint32_t lse2 = base + L::kStats + s * L::kStat;
    mbar_wait(full + 8 * s, (i / kRowStages) & 1);
    if (edge_tile(q0))
      tile(std::true_type{}, q0, q_s, do_s, lse2, lse2 + 4 * kRows);
    else
      tile(std::false_type{}, q0, q_s, do_s, lse2, lse2 + 4 * kRows);
    mbar_arrive(empty + 8 * s);
  }
  }

  // Group 1's partial dK and dV into group 0's, through shared memory
  // (the Q stages, free once both groups are done), element r of thread t
  // at [r][t]; a fixed order, so the sum is reproducible. At (96, 64)
  // each group stores its own keys.
  if constexpr (!kOwn) {
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
  }

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
  // dQ's n (of dS·K) is DPQK: 96 for D = 96, as dK's.
  using L = SmemQ<D, DV>;
  using TQK = typename L::TQK;
  using TV = typename L::TV;
  constexpr int DPQK = TQK::kWidth, NS = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // mbarriers: Q and dO loaded; per stage K and V loaded and free.
  const uint32_t bar_q = base + L::kBar;
  const uint32_t full = bar_q + 8, empty = full + 8 * NS;

  // Query tiles vary slowest in the launch order, last first, so the long
  // causal rows start first; at (96, 64) fastest, last first, so that the
  // blocks of one (b, h) run together and read its K and V from L2 (as
  // the dK/dV kernel's key blocks, above).
  constexpr bool kOwn = TQK::kCols == 32;
  const int nq = (a.Sq + kQRows - 1) / kQRows;
  const int q0 = (nq - 1 - int(kOwn ? blockIdx.x : blockIdx.z)) * kQRows;
  const int h = kOwn ? blockIdx.y : blockIdx.x;
  const int b = kOwn ? blockIdx.z : blockIdx.y;
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
    for (int s = 0; s < NS; ++s) {
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
      for (int c = 0; c < TQK::kChunks; ++c)
        tma_load(base + L::kQ + c * L::kQChunk, &tq, bar_q, TQK::kCols * c,
                 h, q0, b);
      for (int c = 0; c < TV::kChunks; ++c)
        tma_load(base + L::kDO + c * L::kDOChunk, &tdo, bar_q,
                 TV::kCols * c, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS;
        const int k0 = (kt_begin + i) * kQKeys;
        if (i >= NS) mbar_wait(empty + 8 * s, ((i / NS) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, L::kKT + L::kVT);
        for (int c = 0; c < TQK::kChunks; ++c)
          tma_load(base + L::kK + s * L::kKT + c * L::kKChunk, &tk, bar,
                   TQK::kCols * c, hk, k0, b);
        for (int c = 0; c < TV::kChunks; ++c)
          tma_load(base + L::kV + s * L::kVT + c * L::kVChunk, &tv, bar,
                   TV::kCols * c, hk, k0, b);
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
  const uint32_t q_smem = base + L::kQ + wg * 64 * TQK::kRowBytes;
  const uint32_t do_smem = base + L::kDO + wg * 64 * TV::kRowBytes;
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
    const int i = t - kt_begin, s = i % NS, k0 = t * kQKeys;
    const uint32_t k_s = base + L::kK + s * L::kKT;
    const uint32_t v_s = base + L::kV + s * L::kVT;
    mbar_wait(full + 8 * s, (i / NS) & 1);
    if constexpr (kOwn) take_turn(wg);
    issue_ss<D, kQKeys>(sc, q_smem, L::kQChunk, k_s, L::kKChunk);
    issue_ss<DV, kQKeys>(dp, do_smem, L::kDOChunk, v_s, L::kVChunk);
    if constexpr (kOwn) pass_turn(wg);
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
    if constexpr (kOwn) take_turn(wg);
    issue_rs<D, kQKeys / 16>(dq, hi, lo, k_s, L::kKChunk);
    if constexpr (kOwn) pass_turn(wg);
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(empty + 8 * s);
  };

  mbar_wait(bar_q, 0);
  if constexpr (kOwn) first_turn(wg);
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
  constexpr bool kOwn = Tile<D>::kCols == 32;  // (96, 64): its own pre-pass
  const int64_t prep_blocks =
      kOwn ? (p.rows * (DV / 8) + 255) / 256 : (p.rows + 7) / 8;
  if (prep_blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
  if constexpr (kOwn)
    flash_bwd_prep_rows<DV><<<unsigned(prep_blocks), 256, 0, stream>>>(p);
  else
    flash_bwd_prep<DV><<<unsigned(prep_blocks), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  int smem = SmemKV<D, DV>::kBytes;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_tc<D, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return int(err);
  // The kernels' launch order, and the dK/dV block's keys (its K and V
  // maps' box rows): 128 at (96, 64), else 64.
  constexpr int KB = SmemKV<D, DV>::kBlockKeys;
  static_assert(KB == kKeys || KB == kQKeys, "no K/V map of KB rows");
  const int nkb = (a.Sk + KB - 1) / KB;
  const dim3 grid_kv = kOwn ? dim3(nkb, a.Hkv, B) : dim3(a.Hkv, B, nkb);
  flash_bwd_dkdv_tc<D, DV><<<grid_kv, kThreads, smem, stream>>>(
      m[0], m[1], kOwn ? m[4] : m[6], kOwn ? m[5] : m[7], a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  smem = SmemQ<D, DV>::kBytes;
  err = cudaFuncSetAttribute(flash_bwd_dq_tc<D, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return int(err);
  const int nqb = (a.Sq + kQRows - 1) / kQRows;
  const dim3 grid_q = kOwn ? dim3(nqb, a.H, B) : dim3(a.H, B, nqb);
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
  // 128-key tiles (dQ; dK/dV at (96, 64)) and 64-key tiles (dK/dV). q and k are D wide; v, o
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

constexpr int kVariantMma = 0;
constexpr int kVariantTc = 1;

// The one place the variant is chosen, by the forward's rule: bf16 with D
// a multiple of wgmma's k16 depth goes to the wgmma kernels; f32 (3xTF32)
// and D in {8, 24} go to the mma.sync kernels. Mirrored by
// kernel_variant() in flash_attention.py.
int variant_for(int bf16, int D) {
  return bf16 && D % 16 == 0 ? kVariantTc : kVariantMma;
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
// for the tc variant the scaled lse). *variant is set to the variant
// launched: 1 tc (wgmma), 0 mma (mma.sync).

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


// Bytes of dynamic shared memory a block of the tc backward's kernel
// `kernel` (0: flash_bwd_dkdv_tc, 1: flash_bwd_dq_tc) of the pair (D, Dv)
// takes (the launch's request, 1024 of it for alignment); -1 for a pair
// outside the tc table. No launch: it reads the layout.
int flash_attention_bwd_tc_smem(int D, int Dv, int kernel) {
  auto pick = [&](auto kv, auto q) { return kernel == 0 ? kv : q; };
  if (D == 96 && Dv == 64)
    return pick(tc::SmemKV<96, 64>::kBytes, tc::SmemQ<96, 64>::kBytes);
  if (D != Dv) return -1;
  switch (D) {
    case 16: return pick(tc::SmemKV<16, 16>::kBytes, tc::SmemQ<16, 16>::kBytes);
    case 32: return pick(tc::SmemKV<32, 32>::kBytes, tc::SmemQ<32, 32>::kBytes);
    case 64: return pick(tc::SmemKV<64, 64>::kBytes, tc::SmemQ<64, 64>::kBytes);
    case 128:
      return pick(tc::SmemKV<128, 128>::kBytes, tc::SmemQ<128, 128>::kBytes);
    default: return -1;
  }
}

}  // extern "C"
