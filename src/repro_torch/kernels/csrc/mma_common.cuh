// mma_common.cuh: the warp-level tensor-core pieces (mma.sync) and cp.async
// tile copies that flash attention's "mma" kernels share: the forward
// (flash_attention.cu, flash_fwd_mma) and the backward
// (flash_attention_bwd.cu, flash_bwd_dq_mma and flash_bwd_dkdv_mma). Each
// source that includes it is built into its own library (kernels/build.py
// hashes this header with the source).
//
// The arithmetic of an input type T, on the tensor cores either way:
// - float: 3xTF32. Each f32 operand x is split as hi = x with its low 13
//   mantissa bits cleared (TF32 by truncation: one LOP3; with cvt.rna's
//   conversions, four a B fragment, the f32 prefill forward took 1.6x as
//   long on an H100) and
//   lo = x - hi (exact in f32, under 2^-10 of x), which the tensor core
//   reads to TF32's 10 mantissa bits: hi + lo carries x to 2^-20 of
//   itself. A product A·B is lo·hi + hi·lo + hi·hi on mma.m16n8k8.tf32
//   with f32 sums: lo·lo, under 2^-20 of each term, is the one term
//   dropped. Each term's error has the term's sign, so over a sum of
//   random-signed terms it does not drift (the long sums' drift is the
//   tensor core's adds': see accumulate below).
// - bf16: mma.m16n8k16.bf16, exact products of the bf16 inputs with f32
//   sums. An f32 A operand computed in registers (P and dS) goes in as two
//   bf16 parts, hi = bf16(x) and lo = bf16(x - hi), two products, exact to
//   about 2^-17 of each term, as the wgmma kernels do. Head dims that are no
//   multiple of k16 (8, 24) are zero-padded to 16 and 32 columns in shared
//   memory.
//
// Fragments (PTX ISA, mma.m16n8k8 / m16n8k16, row.col): lane = 4g + t.
// The accumulator of a 16 x 8 tile holds rows g and g + 8, columns 2t and
// 2t + 1: c[0], c[1] row g, c[2], c[3] row g + 8. An A operand computed in
// registers reuses that layout: for bf16 the accumulators of n-tiles 2kk and
// 2kk + 1 are the A fragment of k16 step kk as they stand; for tf32 the A
// fragment of k8 step kk wants columns t and t + 4 of a thread, so the k
// index of that step is permuted, column t <-> key 2t and t + 4 <-> 2t + 1,
// in A (the accumulator's c[0], c[2], c[1], c[3]) and in B (rows 2t, 2t + 1
// of the k-major tile) alike: a sum over k does not see the order.
//
// Tiles sit in shared memory row-major in T, one row per sequence position,
// with a pitch of the width rounded up to the k depth plus 4 floats (f32)
// or 8 bf16: every fragment load below (a row g and column t, or rows 2t,
// 2t + 1 and column g, of a 32-thread warp) then falls on 32 distinct banks
// for f32 and on distinct 32-bit words for bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

template <typename T>
struct Traits;
template <>
struct Traits<float> {
  static constexpr int kK = 8;           // k depth of one mma
  static constexpr int kPad = 4;         // pitch = width + 4
};
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kK = 16;
  static constexpr int kPad = 8;
};

// A width rounded up to the k depth (the zero-padded columns), and the row
// pitch of a tile of that width, in elements (a multiple of 16 bytes).
template <typename T>
__host__ __device__ constexpr int kwidth(int w) {
  return (w + Traits<T>::kK - 1) / Traits<T>::kK * Traits<T>::kK;
}
template <typename T>
__host__ __device__ constexpr int pitch(int w) {
  return kwidth<T>(w) + Traits<T>::kPad;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- cp.async
// 16 bytes from device memory into shared memory, zeros where !valid (the
// source is then not read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes, zeros where !valid.
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [s0, s0 + R) of a (S, W) slice with row stride `ss` elements into
// the tile `dst` (pitch P), W columns, zeros past S; NT threads, this one
// `tid`. The slice's rows must be 16-byte aligned (the wrapper copies a
// view whose are not).
template <typename T, int R, int W, int P, int NT>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int64_t ss,
                                          int s0, int S, int tid) {
  constexpr int kChunk = 16 / sizeof(T);
  constexpr int kPerRow = W / kChunk;
  static_assert(W % kChunk == 0, "a row is whole 16-byte chunks");
  static_assert((P * sizeof(T)) % 16 == 0, "pitch of whole 16-byte chunks");
#pragma unroll 4
  for (int i = tid; i < R * kPerRow; i += NT) {
    const int r = i / kPerRow, c = (i % kPerRow) * kChunk;
    const int s = s0 + r;
    const bool ok = s < S;
    cp16(dst + r * P + c, src + (ok ? int64_t(s) * ss + c : 0), ok);
  }
}

// n floats of a row-statistic vector from `src` (index s0 + i) into `dst`,
// zeros at and past S.
template <int NT>
__device__ __forceinline__ void copy_stats(float* dst, const float* src,
                                           int n, int s0, int S, int tid) {
  for (int i = tid; i < n; i += NT) {
    const bool ok = s0 + i < S;
    cp4(dst + i, src + (ok ? s0 + i : 0), ok);
  }
}

// Zeros in the padded columns [W, kwidth(W)) of `rows` rows of a tile (the
// copies never write them); nothing where W is a multiple of the k depth.
template <typename T, int W, int P, int NT>
__device__ __forceinline__ void zero_pad(T* tile, int rows, int tid) {
  constexpr int kPadCols = kwidth<T>(W) - W;
  if constexpr (kPadCols > 0) {
    for (int i = tid; i < rows * kPadCols; i += NT)
      store(tile + (i / kPadCols) * P + W + i % kPadCols, 0.f);
  }
}

// ------------------------------------------------------------- fragments
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
// (a, b) as the bf16 pair hi and the pair of remainders lo.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(a, b);
  const float2 h =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&hi));
  lo = pack_bf16(a - h.x, b - h.y);
}
__device__ __forceinline__ uint32_t word(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pair(__nv_bfloat16 a, __nv_bfloat16 b) {
  return uint32_t(__bfloat16_as_ushort(a)) |
         (uint32_t(__bfloat16_as_ushort(b)) << 16);
}

// A (16 rows x one k step) from a row-major tile X[m][k] (pitch P): rows
// m0 + g, m0 + g + 8, columns k0 + ...
template <int P>
__device__ __forceinline__ void load_a(FragA& f, const float* X, int m0,
                                       int k0, int g, int t) {
  const float* r0 = X + (m0 + g) * P + k0 + t;
  const float* r1 = r0 + 8 * P;
  split_tf32(r0[0], f.hi[0], f.lo[0]);
  split_tf32(r1[0], f.hi[1], f.lo[1]);
  split_tf32(r0[4], f.hi[2], f.lo[2]);
  split_tf32(r1[4], f.hi[3], f.lo[3]);
}
template <int P>
__device__ __forceinline__ void load_a(FragA& f, const __nv_bfloat16* X,
                                       int m0, int k0, int g, int t) {
  const __nv_bfloat16* r0 = X + (m0 + g) * P + k0 + 2 * t;
  const __nv_bfloat16* r1 = r0 + 8 * P;
  f.hi[0] = word(r0);
  f.hi[1] = word(r1);
  f.hi[2] = word(r0 + 8);
  f.hi[3] = word(r1 + 8);
}

// B (one k step x 8 columns n0..) from a tile whose rows are B's columns,
// Y[n][k] (K for S = Q·Kᵀ, Q for Sᵀ = K·Qᵀ).
template <int P>
__device__ __forceinline__ void load_b_nk(FragB& f, const float* Y, int n0,
                                          int k0, int g, int t) {
  const float* r = Y + (n0 + g) * P + k0 + t;
  split_tf32(r[0], f.hi[0], f.lo[0]);
  split_tf32(r[4], f.hi[1], f.lo[1]);
}
template <int P>
__device__ __forceinline__ void load_b_nk(FragB& f, const __nv_bfloat16* Y,
                                          int n0, int k0, int g, int t) {
  const __nv_bfloat16* r = Y + (n0 + g) * P + k0 + 2 * t;
  f.hi[0] = word(r);
  f.hi[1] = word(r + 8);
}

// B (one k step x 8 columns n0..) from a tile whose rows are B's k index,
// Y[k][n] (V for O = P·V, K for dQ = dS·K, dO and Q for dV and dK); for
// tf32 in the permuted k order (rows 2t and 2t + 1 of the step).
template <int P>
__device__ __forceinline__ void load_b_kn(FragB& f, const float* Y, int k0,
                                          int n0, int g, int t) {
  const float* r = Y + (k0 + 2 * t) * P + n0 + g;
  split_tf32(r[0], f.hi[0], f.lo[0]);
  split_tf32(r[P], f.hi[1], f.lo[1]);
}
template <int P>
__device__ __forceinline__ void load_b_kn(FragB& f, const __nv_bfloat16* Y,
                                          int k0, int n0, int g, int t) {
  const __nv_bfloat16* r = Y + (k0 + 2 * t) * P + n0 + g;
  f.hi[0] = pair(r[0], r[P]);
  f.hi[1] = pair(r[8 * P], r[9 * P]);
}

// A of k step kk from accumulators c[n-tile][4] over the same k (P, dS):
// split into hi and lo parts.
template <int N>
__device__ __forceinline__ void acc_a(FragA& f, const float (&c)[N][4],
                                      int kk, float) {
  split_tf32(c[kk][0], f.hi[0], f.lo[0]);
  split_tf32(c[kk][2], f.hi[1], f.lo[1]);
  split_tf32(c[kk][1], f.hi[2], f.lo[2]);
  split_tf32(c[kk][3], f.hi[3], f.lo[3]);
}
template <int N>
__device__ __forceinline__ void acc_a(FragA& f, const float (&c)[N][4],
                                      int kk, __nv_bfloat16) {
  split_bf16(c[2 * kk][0], c[2 * kk][1], f.hi[0], f.lo[0]);
  split_bf16(c[2 * kk][2], c[2 * kk][3], f.hi[1], f.lo[1]);
  split_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1], f.hi[2], f.lo[2]);
  split_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3], f.hi[3], f.lo[3]);
}

// ------------------------------------------------------------------- mma
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += A·B for A loaded from shared memory (bf16: exact, one product).
__device__ __forceinline__ void mma_ss(float (&c)[4], const FragA& a,
                                       const FragB& b, float) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}
__device__ __forceinline__ void mma_ss(float (&c)[4], const FragA& a,
                                       const FragB& b, __nv_bfloat16) {
  mma_bf16(c, a.hi, b.hi);
}
// c += A·B for A and B loaded from shared memory, with 3xTF32's two
// correction products summed apart in `corr` (added to c once the k loop
// is done): c's chain of dependent mma's is then one a k step, not three,
// and a warp has twice the independent chains in flight (bf16: one exact
// product into c; corr untouched).
__device__ __forceinline__ void mma_ss2(float (&c)[4], float (&corr)[4],
                                        const FragA& a, const FragB& b,
                                        float) {
  mma_tf32(corr, a.lo, b.hi);
  mma_tf32(corr, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}
__device__ __forceinline__ void mma_ss2(float (&c)[4], float (&)[4],
                                        const FragA& a, const FragB& b,
                                        __nv_bfloat16) {
  mma_bf16(c, a.hi, b.hi);
}
// c += A·B for A split from registers (bf16: hi and lo, two products).
__device__ __forceinline__ void mma_rs(float (&c)[4], const FragA& a,
                                       const FragB& b, float) {
  mma_ss(c, a, b, 0.f);
}
__device__ __forceinline__ void mma_rs(float (&c)[4], const FragA& a,
                                       const FragB& b, __nv_bfloat16) {
  mma_bf16(c, a.lo, b.hi);
  mma_bf16(c, a.hi, b.hi);
}

// acc[n] += Σ_kk A_kk·B_kk,n over the k steps of one streamed tile: A from
// the accumulator registers x (P or dS, split by acc_a), B from the
// k-major tile Y (pitch P). Each chunk of 4 n-tiles sums the tile's
// product in zeroed registers, which then join acc by f32 adds, rounded to
// nearest. Accumulated in acc by the mma's themselves, the walk's long
// sums (dK and dV over every query row of a KV head: 768 mma adds at
// qwen's training shape, S = 1024) drifted 1.4e-4 from the plain f32
// version on an H100, past the f32 tolerance, as if the tensor core's
// adds were biased (1.5e-5 in chunks); a chunk is at most 8 k steps.
template <typename T, int P, int NX, int N>
__device__ __forceinline__ void accumulate(float (&acc)[N][4],
                                           const float (&x)[NX][4],
                                           const T* Y, int g, int t) {
  constexpr int KK = Traits<T>::kK, C = 4;
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += C) {
    float tmp[C][4];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) tmp[c][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NX * 8 / KK; ++kk) {
      FragA fa;
      acc_a(fa, x, kk, T{});
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (n0 + c < N) {
          FragB fb;
          load_b_kn<P>(fb, Y, kk * KK, 8 * (n0 + c), g, t);
          mma_rs(tmp[c], fa, fb, T{});
        }
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (n0 + c < N)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + c][e] += tmp[c][e];
  }
}

// Whether a 16-byte aligned copy can read the rows of a (B, heads, S, W)
// view: a 16-byte aligned base and (b, h, s) strides of whole 16-byte
// chunks on every axis longer than 1.
inline bool rows_aligned(const void* p, int64_t sb, int64_t sh, int64_t ss,
                         int B, int heads, int S, int elem) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  const int64_t ext[3] = {B, heads, S};
  const int64_t st[3] = {sb, sh, ss};
  for (int i = 0; i < 3; ++i)
    if (ext[i] > 1 && (st[i] * elem) % 16 != 0) return false;
  return true;
}

// The card's SM count (the launchers choose finer blocks below it).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        n < 1)
      n = 132;
  }
  return n;
}

}  // namespace mma
