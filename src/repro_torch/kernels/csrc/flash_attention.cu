// flash_attention: causal / sliding-window GQA attention forward, sm_90a.
//
//   O[b,h] = softmax(Q[b,h] K[b,h/G]^T / sqrt(Dqk) + mask) V[b,h/G]
//
//   q: (B, H, Sq, Dqk), k: (B, Hkv, Sk, Dqk), v: (B, Hkv, Sk, Dv),
//   o: (B, H, Sq, Dv); G = H / Hkv. The head dims (Dqk, Dv) are a pair of
//   the kernels' table: (D, D) for D in {8, 16, 32, 64, 128}, (96, 64),
//   MLA's (minicpm3-4b: 64 nope + 32 rope dims of q and k, 64 of v), and
//   (24, 16), the reduced MLA's (16 + 8 and 16).
//   f32 or bf16 in and out; scores, running max and sums in f32.
//   mask: k_pos < Sk; causal q_pos >= k_pos; window q_pos - k_pos < W.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:87, pallas_call at :119, body
// `_flash_kernel` at :27), whose oracle is `flash_attention_ref`
// (src/repro/kernels/ref.py:18).
//
// Two hand-written kernels, both on the tensor cores, chosen in one place
// (variant_for, by dtype and Dqk):
// - flash_fwd_tc ("tc"): bf16 with Dqk in {16, 32, 64, 96, 128}, wgmma and
//   TMA. The serving path (bf16, D = 128; minicpm3-4b's (96, 64)) runs it.
// - flash_fwd_mma ("mma"): f32 at every pair (3xTF32) and bf16 at Dqk in
//   {8, 24} (no multiple of wgmma's k16 depth), warp-level mma.sync.
// Both are templated on the pair (Dqk, Dv); the wrapper counts the
// launches with Dqk != Dv apart.
//
// Bound: operations. At the serving path's prefill shape (B=4, H=16,
// Hkv=8, S=4096, D=128, bf16, causal) one call does 2*B*H*S*(S+1)*D =
// 2.75e11 FLOP (the causal half of QK^T and PV) on 201.3 MB of q, k, v
// and o: ~0.28 ms at the card's 989 TFLOP/s dense bf16 rate, against
// ~0.06 ms for the bytes at 3.35 TB/s.
//
// flash_fwd_tc, designed against that bound:
// - One block of 384 threads per (128-row query tile, query head, batch):
//   a producer warpgroup, whose one thread issues the TMA loads, and two
//   consumer warpgroups of 64 query rows each, which share every K/V tile.
//   setmaxnreg moves registers from the producer (24) to the consumers
//   (240). Query head h reads KV head h / G. Tiles are launched last-first
//   so the long causal rows start early.
// - TMA loads the Q tile once and 128-key K and V tiles into a ring,
//   through 4-D tensor maps over (D, heads, S, B) with the views' strides,
//   in the swizzle the wgmma descriptors read (tc_common.cuh, Tile). A
//   tile is column chunks: 64 columns in the 128-byte swizzle (D = 16 and
//   32 zero-padded to one chunk; rows past S arrive as zeros), but Q and K
//   at Dqk = 96 are three 32-column chunks in the 64-byte swizzle, so no
//   column of zeros is loaded or multiplied.
//   mbarriers per stage: K loaded, V loaded, K free (after both groups'
//   Q·Kᵀ), V free (after their P·V), so the next K tile streams in while
//   the last P·V still reads V. Shared memory at D = 128: Q 32 KB + 2 x
//   (K 32 KB + V 32 KB) = 160 KB; at (96, 64) Q 24 KB + 2 x (K 24 KB +
//   V 16 KB) = 104 KB. A third stage would fit and ran no faster on the
//   card (MLA's prefill shape, device time): the ring stays at two. One
//   block per SM.
// - S = Q·Kᵀ: wgmma m64n128k16, A = Q and B = K from shared memory (K-major),
//   Dqk/16 steps across the chunks, f32 sums of exact bf16 products.
// - Online softmax on the accumulator fragment: a row lives in the 4 lanes
//   of a quad (two xor shuffles for its max); masks at -1e30 and m from
//   -1e30, as in the TPU kernel, applied only on tiles that cross the
//   causal or window edge or Sk. Loop bounds skip unreachable K tiles.
//   l sums the f32 probabilities (each lane its share, one quad sum at the
//   end) and is clamped at 1e-30.
// - O += P·V: wgmma m64n{64,128}k16 (n = Dv padded) with P in registers as
//   bf16 A fragments (the S accumulator's layout is the A fragment's) and
//   B = V from shared memory, MN-major (transpose bit). P's bf16 rounding
//   is the one rounding the f32 plain version does not make. On a long row
//   it averages out; a row that holds few keys would carry it whole into
//   its output, and such rows only arise on tiles that cross a mask edge:
//   there the remainder P - bf16(P) goes through a second bf16 product, so
//   those rows see P to ~2^-17.
// - Pipelining in a consumer group: its tiles are a masked prefix (a
//   window's first tiles), an unmasked run, and a masked suffix (the
//   causal diagonal, the ragged Sk edge). In the run, tile t's Q·Kᵀ is
//   issued before tile t-1's P·V, and tile t's softmax runs while that
//   P·V is on the tensor cores (wgmma.wait_group 1). A masked tile is
//   done whole. No wgmma is in flight across a branch, and the Q·Kᵀ loop
//   is unrolled for each D (one instantiation per head dim): either would
//   make ptxas serialise the wgmmas.
// - (96, 64) only: (a) the two consumer groups ping-pong: each takes a
//   turn (named barriers) to issue a tile's products and passes it on, so
//   that one group's softmax runs while the other's products hold the
//   tensor cores (without turns the two fall into step, both on the
//   tensor cores, then both on their softmax); (b) on unmasked tiles the
//   scale and log2(e) fold into one FFMA a score, exp2(S·scale·log2e −
//   m·log2e). The (D, D) instantiations keep the schedule above. Measured
//   at minicpm3-4b's prefill shape (B=4, H=40, S=4096, causal; NVIDIA H100
//   80GB HBM3 at 700 W, device time): 1.03-1.04 ms (without turns 1.15,
//   without the fold 1.09), SDPA 0.96, 0.42 of the 0.4344 ms bound
//   (4.2960e11 FLOP); ex2 replaced by a multiply ran no faster, so the
//   exponentials do not bound it.
// - Epilogue: divide by max(l, 1e-30), round to bf16 once, store bf16
//   pairs into the strided output, Dv columns.
// TMA wants 16-byte aligned bases and strides: the wrapper copies a view
// that misses that to a contiguous tensor before the launch. The helpers
// this kernel shares with the backward's tensor-core kernels (mbarriers,
// TMA loads, wgmma, the tensor maps) are in tc_common.cuh.
//
// Both kernels take an optional f32 (B, H, Sq) `lse` buffer: where it is
// not null, the epilogue also stores each row's log-sum-exp of its scaled,
// masked scores, m + log(max(l, 1e-30)), which the backward
// (flash_attention_bwd.cu) reads to rebuild P. Training passes it; the
// serving path passes null and stores nothing more.
//
// flash_fwd_mma (it replaced the first port's SIMT kernel: f32 FMAs on the
// CUDA cores, 13.16 ms for f32 D = 128 at the prefill shape on an H100 SXM
// at 700 W):
// - The arithmetic of mma_common.cuh: f32 as 3xTF32 on m16n8k8 (each
//   operand hi + lo, three products, f32 sums: the f32 plain version to
//   ~2^-21 of each term; S's two correction products in an accumulator of
//   their own, so that a chain of dependent mma's is one a k step), bf16
//   on m16n8k16 with Dqk zero-padded to 16 or 32 columns in shared memory
//   and P as hi + lo bf16 parts (~2^-17).
//   S = Q·Kᵀ with A = Q and B = K from shared memory; O += P·V with A = P
//   from the score accumulators (the accumulator's layout is the A
//   fragment's, in a permuted key order for tf32) and B = V.
// - One block of 4 warps per (64 / split query rows, query head, batch),
//   tiles launched last first; each warp owns 16 rows. Split 1 where
//   B·H·ceil(Sq/64) fills the SMs; else 4: the block's four warps share 16
//   rows, each takes every fourth slice of a K/V tile's keys with its own
//   online softmax, and their (m, l, O) merge at the end in a fixed order
//   (m the largest, O and l rescaled by exp(m_w - m)). The example LM's
//   shape (B=2, H=4, S=256) has 32 blocks of 64 rows for 132 SMs, 128 of
//   16.
// - K and V tiles of 64 keys (32 where Dqk + Dv >= 160) through two
//   shared-memory stages filled by cp.async, the next tile's copy in flight
//   during this one's products; Q loaded once. Rows padded to 4 floats / 8
//   bf16 past the zero-padded width: every fragment load is free of bank
//   conflicts.
// - Online softmax on the accumulator fragment, a row in the 4 lanes of a
//   quad: m starts at -1e30 (not -inf), masked scores are -1e30 (masks only
//   on tiles that cross an edge for the warp's rows), l is clamped at
//   1e-30 at the end. A row whose first visited tile is wholly masked
//   (under a window) gathers exp(0) rubbish there; alpha = exp(-1e30 - m)
//   = 0 wipes it when the row's diagonal tile arrives. With -inf that row
//   would be NaN. The tensor-core kernel relies on the same.
// - Strides (b, h, s) in elements for each of q, k, v, o, unit stride on
//   D: the model's (B, S, H, D) projections go in as views. cp.async reads
//   16-byte chunks: the rows of q, k and v must be 16-byte aligned (the
//   wrapper copies a view whose are not, as for TMA); o is stored a scalar
//   at a time.
// Bound at the example LM's shape (f32, B=2, H=4, Hkv=2, S=256, D=64,
// causal): 6.7e7 FLOP, 0.00041 ms as 3xTF32 (three TF32 products a term:
// 495 / 3 = 165 TFLOP/s, launch/roofline.py); at that size the time is
// latency: a block's key tiles in series.
//
// Plain C interface for ctypes (no PyTorch headers): every entry point
// launches on the caller's stream, never synchronises, allocates nothing
// and returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for a (Dqk, Dv) pair outside the table,
// H % Hkv != 0, a size out of range, or a tensor the tensor maps cannot
// address).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"
#include "tc_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;        // as the TPU kernel's NEG_INF
constexpr float kMinDenom = 1e-30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                            // (B, H, Sq) or null
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int H, Hkv, Sq, Sk;
  int causal;
  int window;                            // <= 0: no window
  float scale;
};

// Keys per K/V tile: 64, or 32 where the head dims are wide (Dqk + Dv >=
// 160: (96, 64) and f32 D = 128), so that two stages leave room for two
// blocks an SM.
__host__ __device__ constexpr int tile_keys(int dqk, int dv) {
  return dqk + dv >= 160 ? 32 : 64;
}

// Stages of the cp.async ring: 2 for blocks of 64 rows or keys (the
// large shapes, where a third would cost a block an SM), 4 where the walk
// is split four ways (the small shapes: one block an SM walks its tiles in
// series, and each tile's load would wait out its latency).
__host__ __device__ constexpr int ring_stages(int split) {
  return split == 1 ? 2 : 4;
}

// Shared memory of the forward block, in elements of T: the Q tile of
// 16·4/KS rows, then the stages of K and of V tiles; each tile row-major,
// mma::pitch wide. After the loop the split warps' partial results (m, l
// and O of their rows) pass through the K stages.
template <typename T, int DQK, int DV, int KS>
struct FwdSmem {
  static constexpr int kBK = tile_keys(DQK, DV);
  static constexpr int kBQ = 16 * (4 / KS);
  static constexpr int kStages = ring_stages(KS);
  static constexpr int kPQ = mma::pitch<T>(DQK);
  static constexpr int kPV = mma::pitch<T>(DV);
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kPQ;
  static constexpr int kV = kK + kStages * kBK * kPQ;
  static constexpr size_t kBytes =
      size_t(kV + kStages * kBK * kPV) * sizeof(T);
  static constexpr int kMerge = DV / 2 + 4;     // floats a lane passes on
  static_assert((4 - 4 / KS) * 32 * kMerge * sizeof(float) <=
                    size_t(kStages * kBK * kPQ) * sizeof(T),
                "the forward's merge does not fit the K stages");
};

// One block of 4 warps per (16·4/KS query rows, query head, batch), tiles
// launched last first; K and V tiles stream through shared memory
// (a cp.async ring). Each warp owns 16 rows; the KS warps of a row
// group take every KS-th slice of BK/KS keys of each tile, each with its
// own online softmax, and their (m, l, O) merge at the end in a fixed
// order.
template <typename T, int DQK, int DV, int KS>
__global__ void __launch_bounds__(128) flash_fwd_mma(Args a) {
  using L = FwdSmem<T, DQK, DV, KS>;
  constexpr int BK = L::kBK, BQ = L::kBQ, NT = 128, KC = BK / KS;
  constexpr int NS = L::kStages;
  constexpr int PQ = L::kPQ, PV = L::kPV;
  constexpr int KK = mma::Traits<T>::kK;
  constexpr int KQ = mma::kwidth<T>(DQK);     // Q·Kᵀ's zero-padded depth
  static_assert(KC % KK == 0, "a warp's key slice is whole k steps");
  extern __shared__ float4 smem4[];
  T* sm = reinterpret_cast<T*>(smem4);
  T* Qs = sm + L::kQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp / KS, ks = warp % KS;    // row group, key slice
  const int nq = (a.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - int(blockIdx.x)) * BQ;     // last tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* O = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  // Reachable K tiles (loop bounds in place of the TPU kernel's
  // block-level @pl.when).
  const int nk = (a.Sk + BK - 1) / BK;
  int kt_end = nk;
  if (a.causal) kt_end = min(nk, (q0 + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0)
    kt_begin = (q0 - a.window + 1) / BK;
  const int n_tiles = max(kt_end - kt_begin, 0);

  mma::zero_pad<T, DQK, PQ, NT>(Qs, BQ + NS * BK, tid);  // Q and K stages
  auto load_kv = [&](int kt, int st) {
    mma::copy_rows<T, BK, DQK, PQ, NT>(sm + L::kK + st * BK * PQ, K, a.k_ss,
                                       kt * BK, a.Sk, tid);
    mma::copy_rows<T, BK, DV, PV, NT>(sm + L::kV + st * BK * PV, V, a.v_ss,
                                      kt * BK, a.Sk, tid);
  };
  // Q and the first NS - 1 tiles in flight, one commit group each (empty
  // past the last tile, so that group i is tile i's).
  mma::copy_rows<T, BQ, DQK, PQ, NT>(Qs, Q, a.q_ss, q0, a.Sq, tid);
#pragma unroll
  for (int p = 0; p < NS - 1; ++p) {
    if (p < n_tiles) load_kv(kt_begin + p, p);
    mma::commit();
  }

  const int r0 = 16 * rg;                       // the warp's rows in the tile
  const int row = q0 + r0 + g;                  // and row + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % NS;
    const int k0 = (kt_begin + i) * BK + ks * KC;  // the warp's keys
    if (i + NS - 1 < n_tiles)
      load_kv(kt_begin + i + NS - 1, (i + NS - 1) % NS);
    mma::commit();
    mma::wait<NS - 1>();                           // tile i has landed
    __syncthreads();
    const T* Ks = sm + L::kK + st * BK * PQ + ks * KC * PQ;
    const T* Vs = sm + L::kV + st * BK * PV + ks * KC * PV;

    // S = Q·Kᵀ on the warp's 16 rows and KC keys.
    float s[KC / 8][4], corr[KC / 8][4];
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = corr[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ / KK; ++kk) {
      mma::FragA fa;
      mma::load_a<PQ>(fa, Qs, r0, kk * KK, g, t);
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) {
        mma::FragB fb;
        mma::load_b_nk<PQ>(fb, Ks, 8 * j, kk * KK, g, t);
        mma::mma_ss2(s[j], corr[j], fa, fb, T{});
      }
    }

    // Online softmax: s[j][e] is row row + 8 (e / 2), key k0 + 8j + 2t +
    // e % 2; a row lives in the 4 lanes of a quad. Masks only on slices
    // that cross the causal or window edge or Sk for this warp's rows.
    const bool masked = k0 + KC > a.Sk ||
                        (a.causal && k0 + KC - 1 > q0 + r0) ||
                        (a.window > 0 && q0 + r0 + 15 - k0 >= a.window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (s[j][e] + corr[j][e]) * a.scale;
        if (masked) {
          const int qp = row + 8 * (e / 2), kp = k0 + 8 * j + 2 * t + e % 2;
          bool ok = kp < a.Sk;
          if (a.causal) ok = ok && qp >= kp;
          if (a.window > 0) ok = ok && qp - kp < a.window;
          if (!ok) x = kNegInf;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e / 2]);
        s[j][e] = p;
        l[e / 2] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P·V: P from the score registers (split), V k-major.
    mma::accumulate<T, PV>(o, s, Vs, g, t);
    __syncthreads();    // every warp is done with stage st before its refill
  }
  mma::wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (KS > 1) {
    // The row group's KS partial softmaxes into the first's, in a fixed
    // order: m = the largest m; O and l rescaled by exp(m_w - m) and
    // summed. A slice whose keys were all masked for a row holds m =
    // -1e30 there and is wiped by its factor exp(-1e30 - m) = 0.
    constexpr int N = L::kMerge;
    float* red = reinterpret_cast<float*>(sm + L::kK) +
                 rg * (KS - 1) * 32 * N;
    __syncthreads();
    if (ks > 0) {
      float* mine = red + (ks - 1) * 32 * N + lane;
      mine[0] = m[0];
      mine[32] = m[1];
      mine[64] = l[0];
      mine[96] = l[1];
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 + 4 * n + e) * 32] = o[n][e];
    }
    __syncthreads();
    if (ks > 0) return;
    float mw[KS][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mw[0][r] = m[r];
#pragma unroll
      for (int w = 1; w < KS; ++w) {
        mw[w][r] = red[((w - 1) * N + r) * 32 + lane];
        m[r] = fmaxf(m[r], mw[w][r]);
      }
    }
    float f[2] = {expf(mw[0][0] - m[0]), expf(mw[0][1] - m[1])};
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] *= f[r];
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= f[e / 2];
#pragma unroll
    for (int w = 1; w < KS; ++w) {
      const float* theirs = red + (w - 1) * 32 * N + lane;
      f[0] = expf(mw[w][0] - m[0]);
      f[1] = expf(mw[w][1] - m[1]);
      l[0] += f[0] * theirs[64];
      l[1] += f[1] * theirs[96];
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n][e] += f[e / 2] * theirs[(4 + 4 * n + e) * 32];
    }
  }

  // Normalise once and write the warp's rows (each quad's two).
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) denom[r] = fmaxf(l[r], kMinDenom);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = row + 8 * r;
    if (qr >= a.Sq) continue;
    if (a.lse != nullptr && t == 0)
      a.lse[(int64_t(b) * a.H + h) * a.Sq + qr] = m[r] + logf(denom[r]);
    T* orow = O + int64_t(qr) * a.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      mma::store(orow + 8 * n, o[n][2 * r] / denom[r]);
      mma::store(orow + 8 * n + 1, o[n][2 * r + 1] / denom[r]);
    }
  }
}

template <typename T, int DQK, int DV, int KS>
int launch_split(const Args& a, int B, cudaStream_t stream) {
  using L = FwdSmem<T, DQK, DV, KS>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<T, DQK, DV, KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::kBytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.Sq + L::kBQ - 1) / L::kBQ, a.H, B);
  flash_fwd_mma<T, DQK, DV, KS><<<grid, 128, L::kBytes, stream>>>(a);
  return int(cudaGetLastError());
}

// Blocks of 64 rows where they fill the card; else of 16 rows whose 4
// warps split each K/V tile's keys, four times as many blocks (the
// example LM's shape, B=2, H=4, S=256: 32 blocks of 64 rows for 132 SMs,
// 128 of 16).
template <typename T, int DQK, int DV>
int launch_d(const Args& a, int B, cudaStream_t stream) {
  const int64_t blocks = int64_t((a.Sq + 63) / 64) * a.H * B;
  if (blocks >= mma::sm_count())
    return launch_split<T, DQK, DV, 1>(a, B, stream);
  return launch_split<T, DQK, DV, 4>(a, B, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int64_t* strides, int B, int H, int Hkv, int Sq, int Sk,
           int D, int Dv, int causal, int window, cudaStream_t stream) {
  constexpr int kElem = sizeof(T);
  if (!mma::rows_aligned(q, strides[0], strides[1], strides[2], B, H, Sq,
                         kElem) ||
      !mma::rows_aligned(k, strides[3], strides[4], strides[5], B, Hkv, Sk,
                         kElem) ||
      !mma::rows_aligned(v, strides[6], strides[7], strides[8], B, Hkv, Sk,
                         kElem))
    return int(cudaErrorInvalidValue);
  Args a{q, k, v, o, lse,
         strides[0], strides[1], strides[2],
         strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8],
         strides[9], strides[10], strides[11],
         H, Hkv, Sq, Sk, causal, window, 1.0f / sqrtf(float(D))};
  // bf16 reaches this variant at (8, 8) and (24, 16) alone (variant_for:
  // D not a multiple of k16), f32 at every pair.
  if (D == 8 && Dv == 8) return launch_d<T, 8, 8>(a, B, stream);
  if (D == 24 && Dv == 16) return launch_d<T, 24, 16>(a, B, stream);
  if constexpr (std::is_same_v<T, float>) {
    if (D == 96 && Dv == 64) return launch_d<T, 96, 64>(a, B, stream);
    if (D == Dv) {
      switch (D) {
        case 16: return launch_d<T, 16, 16>(a, B, stream);
        case 32: return launch_d<T, 32, 32>(a, B, stream);
        case 64: return launch_d<T, 64, 64>(a, B, stream);
        case 128: return launch_d<T, 128, 128>(a, B, stream);
        default: break;
      }
    }
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core variant: bf16, (Dqk, Dv) in {(16, 16), (32, 32), (64, 64),
// (96, 64), (128, 128)}.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBM = 128;                 // Q rows per block: 2 x 64
constexpr int kBN = 128;                 // keys per K/V tile
constexpr int kThreads = 384;            // producer + 2 consumer warpgroups
constexpr int kConsumers = 256;
constexpr float kLog2e = 1.4426950408889634f;

// MLA's (96, 64), whose Q and K are three 32-column chunks (chunk_cols):
// the two consumer groups in ping-pong and the exp2 fold. The (D, D)
// pairs keep one schedule of their own: each group's run pipelined within
// itself, no turns.
__host__ __device__ constexpr bool own_widths(int dqk) {
  return chunk_cols(dqk) == 32;
}

// Shared memory of one block, in bytes from a 1024-aligned base. A tile
// of R rows is Tile<D>::kChunks chunks of [R rows][kCols bf16], each in
// TMA's swizzle of its row width (the layout the wgmma descriptors read);
// Q and K are DQK wide (96 at MLA's pair: no column of zeros), V DV
// (zero-padded to 64 below it).
template <int DQK, int DV>
struct Smem {
  using TQK = Tile<DQK>;
  using TV = Tile<DV>;
  static constexpr int kStages = 2;                       // K/V ring
  static constexpr int kQChunk = kBM * TQK::kRowBytes;
  static constexpr int kKChunk = kBN * TQK::kRowBytes;
  static constexpr int kVChunk = kBN * TV::kRowBytes;
  static constexpr int kQTile = TQK::kChunks * kQChunk;
  static constexpr int kKTile = TQK::kChunks * kKChunk;   // one K tile
  static constexpr int kVTile = TV::kChunks * kVChunk;    // one V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQTile;                  // kStages K tiles
  static constexpr int kV = kK + kStages * kKTile;        // kStages V tiles
  static constexpr int kBar = kV + kStages * kVTile;      // mbarriers
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;
};

struct Args {
  void* o;
  float* lse;                            // (B, H, Sq) or null
  int64_t o_sb, o_sh, o_ss;
  int H, Hkv, Sq, Sk;
  int causal;
  int window;                            // <= 0: no window
  float scale;
};

// O += P·V over one 128-key tile, issued (not waited for): P as bf16 A
// fragments (4 registers per 16 keys), V MN-major at `v` (chunks of 128
// keys).
template <int DV>
__device__ __forceinline__ void issue_pv(float (&o)[Tile<DV>::kWidth / 2],
                                         const uint32_t (&pa)[32],
                                         uint32_t v) {
  using TV = Tile<DV>;
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t db = TV::mn_major(v, kBN * TV::kRowBytes, kk);
    if constexpr (TV::kWidth == 128)
      wgmma_rs_n128(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                    pa[4 * kk + 3], db);
    else
      wgmma_rs_n64(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                   pa[4 * kk + 3], db);
  }
}

template <int DV>
__device__ __forceinline__ void pv_sync(float (&o)[Tile<DV>::kWidth / 2],
                                        const uint32_t (&pa)[32],
                                        uint32_t v) {
  issue_pv<DV>(o, pa, v);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// S = Q·Kᵀ over one 128-key tile, issued and committed (not waited for):
// f32 sums of exact bf16 products, DQK/16 steps of k16 across Q's and K's
// chunks, A = this group's 64 Q rows and B = the K tile, both K-major in
// shared memory.
template <int DQK>
__device__ __forceinline__ void issue_qk(float (&sc)[kBN / 2], uint32_t q,
                                         uint32_t k) {
  using T = Tile<DQK>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk)
    wgmma_ss_n128(sc, T::k_major(q, kBM * T::kRowBytes, kk),
                  T::k_major(k, kBN * T::kRowBytes, kk), kk > 0);
  wgmma_commit();
}

// Online softmax on the score fragment: sc[4j + e] is row row0 + 8 * (e /
// 2), key k0 + 8j + col0 + e % 2; a row lives in the 4 lanes of a quad.
// Scales, masks (where `masked`), updates m and this lane's share of l,
// leaves the f32 probabilities in sc and the rescale factors in alpha.
// kFold, on a tile that crosses no mask edge: the scale and log2(e) fold
// into one FFMA a score, exp2(S·(scale·log2e) − m·log2e), m from the
// largest raw score (scale > 0: max and rounding commute, so m is the
// same); m is then a real score's, never -1e30, and the fold cannot
// cancel two huge terms.
template <bool kFold>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool masked,
                                             int k0, int row0, int col0,
                                             const Args& a) {
  float mx[2] = {kNegInf, kNegInf};
  if (kFold && !masked) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
    float neg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * a.scale);
      alpha[r] = exp2_approx((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      l[r] *= alpha[r];
      neg[r] = -m_new * kLog2e;
    }
    const float sl2 = a.scale * kLog2e;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(fmaf(sc[4 * j + e], sl2, neg[e / 2]));
        sc[4 * j + e] = p;
        l[e / 2] += p;
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * a.scale;
      if (masked) {
        const int qp = row0 + 8 * (e / 2), kp = k0 + 8 * j + col0 + e % 2;
        bool ok = kp < a.Sk;
        if (a.causal) ok = ok && qp >= kp;
        if (a.window > 0) ok = ok && qp - kp < a.window;
        if (!ok) x = kNegInf;
      }
      sc[4 * j + e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2_approx((m[r] - m_new) * kLog2e);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx((sc[4 * j + e] - m[e / 2]) * kLog2e);
      sc[4 * j + e] = p;
      l[e / 2] += p;
    }
  }
}

// P as bf16 A fragments: keys 16kk.. of the tile are sc[8kk .. 8kk+7].
__device__ __forceinline__ void pack_p(uint32_t (&pa)[32],
                                       const float (&sc)[kBN / 2]) {
#pragma unroll
  for (int r = 0; r < 32; ++r) pa[r] = pack_bf16(sc[2 * r], sc[2 * r + 1]);
}

// The remainder of P's bf16 rounding, P - bf16(P), in place of bf16(P).
__device__ __forceinline__ void pack_remainder(uint32_t (&pa)[32],
                                               const float (&sc)[kBN / 2]) {
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const float2 hi = unpack_bf16(pa[r]);
    pa[r] = pack_bf16(sc[2 * r] - hi.x, sc[2 * r + 1] - hi.y);
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, Args a) {
  using L = Smem<DQK, DV>;
  using TQK = typename L::TQK;
  using TV = typename L::TV;
  constexpr int NS = L::kStages;
  constexpr int DP = TV::kWidth;        // O's columns: DV zero-padded
  constexpr bool kOwn = own_widths(DQK);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // mbarriers: Q loaded; per stage K loaded, V loaded, K free, V free.
  const uint32_t bar_q = base + L::kBar;
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * NS;
  const uint32_t free_k = full_v + 8 * NS, free_v = free_k + 8 * NS;

  const int nq = (a.Sq + kBM - 1) / kBM;
  const int q0 = (nq - 1 - int(blockIdx.x)) * kBM;    // last tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);

  // Reachable K tiles (loop bounds in place of the TPU kernel's
  // block-level @pl.when).
  const int nk = (a.Sk + kBN - 1) / kBN;
  int kt_end = nk;
  if (a.causal) kt_end = min(nk, (q0 + kBM - 1) / kBN + 1);
  int kt_begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0)
    kt_begin = (q0 - a.window + 1) / kBN;
  const int n_tiles = max(kt_end - kt_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(free_k + 8 * s, kConsumers);
      mbar_init(free_v + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the TMA loads in flight. A K
    // slot is refilled once both groups' Q·Kᵀ has read it, a V slot once
    // their P·V has.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kQTile);
      for (int c = 0; c < TQK::kChunks; ++c)
        tma_load(base + L::kQ + c * L::kQChunk, &tq, bar_q, TQK::kCols * c,
                 h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS;
        const uint32_t reuse = ((i / NS) & 1) ^ 1;
        const int k0 = (kt_begin + i) * kBN;
        if (i >= NS) mbar_wait(free_k + 8 * s, reuse);
        mbar_expect_tx(full_k + 8 * s, L::kKTile);
        for (int c = 0; c < TQK::kChunks; ++c)
          tma_load(base + L::kK + s * L::kKTile + c * L::kKChunk, &tk,
                   full_k + 8 * s, TQK::kCols * c, hk, k0, b);
        if (i >= NS) mbar_wait(free_v + 8 * s, reuse);
        mbar_expect_tx(full_v + 8 * s, L::kVTile);
        for (int c = 0; c < TV::kChunks; ++c)
          tma_load(base + L::kV + s * L::kVTile + c * L::kVChunk, &tv,
                   full_v + 8 * s, TV::kCols * c, hk, k0, b);
      }
    }
    return;
  }

  // Consumer warpgroups: 64 Q rows each. A group's tiles split into those
  // that cross a mask edge (a window's first tiles; the causal diagonal
  // and the ragged Sk edge last) and the unmasked run between them. The
  // run is pipelined: tile t's Q·Kᵀ is issued before tile t-1's P·V, and
  // the softmax of tile t runs while that P·V is on the tensor cores. A
  // masked tile is done whole, with the remainder of its P (below). No
  // wgmma is in flight across a branch, which would make the compiler
  // serialise them.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int rq0 = q0 + 64 * wg;                      // this group's rows
  const int row0 = rq0 + 16 * warp + lane / 4;       // and row0 + 8
  const int col0 = 2 * (lane % 4);                   // + 8j (+ 1)
  const uint32_t q_smem = base + L::kQ + wg * 64 * TQK::kRowBytes;

  // Ping-pong (kOwn): named barrier 1 + w is group w's turn to issue. A
  // group takes its turn before it issues a tile's first products and
  // passes it right after, so that one group's exponentials run while the
  // other's products hold the tensor cores. Both groups walk the same K
  // tiles and take one turn each, so the turns pair up; group 0 goes
  // first (group 1 passes once up front), and group 1's last pass is
  // never taken.
  auto take_turn = [&]() {
    if constexpr (kOwn)
      asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(kConsumers)
                   : "memory");
  };
  auto pass_turn = [&]() {
    if constexpr (kOwn)
      asm volatile("bar.arrive %0, %1;\n" :: "r"(2 - wg), "n"(kConsumers)
                   : "memory");
  };
  if constexpr (kOwn)
    if (wg == 1)
      asm volatile("bar.arrive 1, %0;\n" :: "n"(kConsumers) : "memory");

  // Whether some (row, key) pair of this group and K tile t is masked:
  // false on a run of tiles between a masked prefix (window) and a masked
  // suffix (causal, Sk).
  auto masked = [&](int t) {
    const int k0 = t * kBN;
    return k0 + kBN > a.Sk || (a.causal && k0 + kBN - 1 > rq0) ||
           (a.window > 0 && rq0 + 63 - k0 >= a.window);
  };
  int run_begin = kt_begin;
  while (run_begin < kt_end && masked(run_begin)) ++run_begin;
  int run_end = run_begin;
  while (run_end < kt_end && !masked(run_end)) ++run_end;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float sc[kBN / 2];
  uint32_t pa[32];

  auto rescale = [&]() {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
  };
  // K tile t's slot, and the parity of the phase that fills it.
  auto slot = [&](int t) { return (t - kt_begin) % NS; };
  auto parity = [&](int t) {
    return uint32_t(((t - kt_begin) / NS) & 1);
  };
  // A masked tile, whole: S, softmax, P·V, then the remainder of P's
  // bf16 rounding, P - bf16(P), as a second bf16 product. On such a tile a
  // row may hold few keys in all, and P's rounding would reach its output
  // whole.
  auto masked_tile = [&](int t) {
    const int s = slot(t);
    mbar_wait(full_k + 8 * s, parity(t));
    take_turn();
    issue_qk<DQK>(sc, q_smem, base + L::kK + s * L::kKTile);
    pass_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(free_k + 8 * s);
    softmax_tile<kOwn>(sc, m, l, alpha, true, t * kBN, row0, col0, a);
    rescale();
    pack_p(pa, sc);
    const uint32_t v = base + L::kV + s * L::kVTile;
    mbar_wait(full_v + 8 * s, parity(t));
    pv_sync<DV>(o, pa, v);
    pack_remainder(pa, sc);
    pv_sync<DV>(o, pa, v);
    mbar_arrive(free_v + 8 * s);
  };

  mbar_wait(bar_q, 0);
  for (int t = kt_begin; t < run_begin; ++t) masked_tile(t);
  if (run_begin < run_end) {
    int t = run_begin;
    mbar_wait(full_k + 8 * slot(t), parity(t));
    take_turn();
    issue_qk<DQK>(sc, q_smem, base + L::kK + slot(t) * L::kKTile);
    pass_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(free_k + 8 * slot(t));
    softmax_tile<kOwn>(sc, m, l, alpha, false, t * kBN, row0, col0, a);
    rescale();
    pack_p(pa, sc);
    for (++t; t < run_end; ++t) {
      const int s = slot(t), sp = slot(t - 1);
      mbar_wait(full_v + 8 * sp, parity(t - 1));    // (loaded before K_t)
      mbar_wait(full_k + 8 * s, parity(t));
      take_turn();
      issue_qk<DQK>(sc, q_smem, base + L::kK + s * L::kKTile);
      issue_pv<DV>(o, pa, base + L::kV + sp * L::kVTile);
      wgmma_commit();
      pass_turn();
      wgmma_wait<1>();                  // Q·Kᵀ done, P·V may run on
      fence_regs(sc);
      mbar_arrive(free_k + 8 * s);
      softmax_tile<kOwn>(sc, m, l, alpha, false, t * kBN, row0, col0, a);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(free_v + 8 * sp);
      rescale();
      pack_p(pa, sc);
    }
    const int sp = slot(run_end - 1);
    mbar_wait(full_v + 8 * sp, parity(run_end - 1));
    pv_sync<DV>(o, pa, base + L::kV + sp * L::kVTile);
    mbar_arrive(free_v + 8 * sp);
  }
  for (int t = run_end; t < kt_end; ++t) masked_tile(t);

  // Normalise once and write this thread's two rows (columns < DV).
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb +
                     h * a.o_sh;
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    denom[r] = fmaxf(l[r], kMinDenom);
  }
  // The row's log-sum-exp of the scaled scores, for the backward; the
  // quad's four lanes hold the same m and l.
  if (a.lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < a.Sq)
        a.lse[(int64_t(b) * a.H + h) * a.Sq + row] = m[r] + logf(denom[r]);
    }
  }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    if (8 * j >= DV) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(O + int64_t(row) * a.o_ss + 8 * j +
                                           col0) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / denom[r],
                                  o[4 * j + 2 * r + 1] / denom[r]);
    }
  }
}

}  // namespace tc
// ---------------------------------------------------------------------------
// Host side of the tensor-core variant.
// ---------------------------------------------------------------------------
namespace tc {

template <int DQK, int DV>
int launch_d(const CUtensorMap& mq, const CUtensorMap& mk,
             const CUtensorMap& mv, const Args& a, int B,
             cudaStream_t stream) {
  const int smem = Smem<DQK, DV>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.Sq + kBM - 1) / kBM, a.H, B);
  flash_fwd_tc<DQK, DV><<<grid, kThreads, smem, stream>>>(mq, mk, mv, a);
  return int(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int64_t* st, int B, int H, int Hkv, int Sq, int Sk, int D,
           int Dv, int causal, int window, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, st[0], st[1], st[2], D, H, Sq, B, kBM) ||
      !make_map(&mk, k, st[3], st[4], st[5], D, Hkv, Sk, B, kBN) ||
      !make_map(&mv, v, st[6], st[7], st[8], Dv, Hkv, Sk, B, kBN))
    return int(cudaErrorInvalidValue);
  // The epilogue stores bf16 pairs: o and its strides must be even.
  if (reinterpret_cast<uintptr_t>(o) % 4 != 0 || st[9] % 2 != 0 ||
      st[10] % 2 != 0 || st[11] % 2 != 0)
    return int(cudaErrorInvalidValue);
  const Args a{o, lse, st[9], st[10], st[11], H, Hkv, Sq, Sk, causal, window,
               1.0f / sqrtf(float(D))};
  if (D == 96 && Dv == 64) return launch_d<96, 64>(mq, mk, mv, a, B, stream);
  if (D != Dv) return int(cudaErrorInvalidValue);
  switch (D) {
    case 16: return launch_d<16, 16>(mq, mk, mv, a, B, stream);
    case 32: return launch_d<32, 32>(mq, mk, mv, a, B, stream);
    case 64: return launch_d<64, 64>(mq, mk, mv, a, B, stream);
    case 128: return launch_d<128, 128>(mq, mk, mv, a, B, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace tc

namespace {

constexpr int kVariantMma = 0;
constexpr int kVariantTc = 1;

// The one place the variant is chosen: bf16 with Dqk a multiple of
// wgmma's k16 depth goes to the wgmma kernel; f32 (3xTF32) and Dqk in {8,
// 24} go to the mma.sync kernel. Mirrored by kernel_variant() in
// flash_attention.py.
int variant_for(int bf16, int D) {
  return bf16 && D % 16 == 0 ? kVariantTc : kVariantMma;
}

int dispatch(int bf16, const void* q, const void* k, const void* v, void* o,
             float* lse, const int64_t* strides, int B, int H, int Hkv,
             int Sq, int Sk, int D, int Dv, int causal, int window,
             int* variant, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || Hkv < 1 || H % Hkv != 0 ||
      Sq < 1 || Sk < 1)
    return int(cudaErrorInvalidValue);
  const int var = variant_for(bf16, D);
  *variant = var;
  if (var == kVariantTc)
    return tc::launch(q, k, v, o, lse, strides, B, H, Hkv, Sq, Sk, D, Dv,
                      causal, window, st);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, lse, strides, B, H, Hkv, Sq, Sk, D,
                                 Dv, causal, window, st);
  return launch<float>(q, k, v, o, lse, strides, B, H, Hkv, Sq, Sk, D, Dv,
                       causal, window, st);
}

}  // namespace

extern "C" {

// strides: 12 element strides, (b, h, s) of q, k, v, o in that order;
// the D axis of each must have unit stride. D is the head dim of q and k,
// Dv that of v and o. lse: null (the serving path), or a contiguous f32
// (B, H, Sq) buffer that receives each row's log-sum-exp of its scaled,
// masked scores, m + log(max(l, 1e-30)), for the backward
// (flash_attention_bwd.cu). *variant is set to the variant launched: 1
// tc (wgmma), 0 mma (mma.sync).
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        float* lse, const int64_t* strides, int B, int H,
                        int Hkv, int Sq, int Sk, int D, int Dv, int causal,
                        int window, int* variant, void* stream) {
  return dispatch(0, q, k, v, o, lse, strides, B, H, Hkv, Sq, Sk, D, Dv,
                  causal, window, variant, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, float* lse, const int64_t* strides, int B,
                         int H, int Hkv, int Sq, int Sk, int D, int Dv,
                         int causal, int window, int* variant, void* stream) {
  return dispatch(1, q, k, v, o, lse, strides, B, H, Hkv, Sq, Sk, D, Dv,
                  causal, window, variant, stream);
}

// Bytes of dynamic shared memory a flash_fwd_tc block of the pair (D, Dv)
// takes (the launch's request, 1024 of it for alignment); -1 for a pair
// outside the tc table. No launch: it reads the layout.
int flash_attention_tc_smem(int D, int Dv) {
  if (D == 96 && Dv == 64) return tc::Smem<96, 64>::kBytes;
  if (D != Dv) return -1;
  switch (D) {
    case 16: return tc::Smem<16, 16>::kBytes;
    case 32: return tc::Smem<32, 32>::kBytes;
    case 64: return tc::Smem<64, 64>::kBytes;
    case 128: return tc::Smem<128, 128>::kBytes;
    default: return -1;
  }
}

}  // extern "C"
