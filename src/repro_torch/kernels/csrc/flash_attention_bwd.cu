// flash_attention_bwd: the backward of causal / sliding-window GQA
// attention, sm_90a.
//
//   q, dq: (B, H, Sq, D); k, v, dk, dv: (B, Hkv, Sk, D); o, do: (B, H, Sq, D);
//   lse: (B, H, Sq) f32 from the forward (flash_attention.cu); G = H / Hkv.
//   f32 or bf16 in and out; every product and sum in f32.
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
// Bound: operations. The backward does 2.5x the forward's FLOP (QKᵀ
// again, dP, dV, dK, dQ against QKᵀ and PV): 6.874e11 FLOP at the serving
// prefill shape (B=4, H=16, Hkv=8, S=4096, D=128, causal), 0.695 ms at
// 989 TFLOP/s bf16. This first design is SIMT, f32 FMAs on the CUDA
// cores (ceiling 67 TFLOP/s), and recomputes QKᵀ and dP once more for dQ
// (3.5x the forward's FLOP); the tensor-core redesign is queued.
//
// Three kernels, launched in order on the caller's stream by one C call:
// - flash_bwd_delta: Δ = rowsum(dO ⊙ O) into an f32 (B, H, Sq) scratch
//   buffer; one warp per row.
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
// with a pitch of D + 4 floats, so float4 reads of 8 neighbouring rows hit
// distinct banks. Each thread computes the 16 scores S[ty + 16i][tx + 16j]
// (i, j < 4) and the same 16 of dP from float4 reads; P and dS go through
// shared memory to the products that contract over rows (dV, dK) or keys
// (dQ), where a thread owns 4 rows and D/16 columns. Shared memory at
// D = 128: 4 tiles of 64 x 132 floats + two 64 x 68 tiles = 166.5 KB, one
// block per SM.
//
// Plain C interface for ctypes (no PyTorch headers): the entry points
// launch on the caller's stream, never synchronise, allocate nothing (the
// wrapper passes the Δ scratch) and return the first cudaError_t of the
// three launches (0 on success; cudaErrorInvalidValue for a D outside
// {8, 16, 32, 64, 128}, H % Hkv != 0 or a size out of range).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// D >= 64 as float4 groups at 4*tx + 64*g; D < 64 as single columns
// tx + 16*j (tx < D for D = 8).
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

template <typename T, int D>
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
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f32(dO[d]), to_f32(O[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[row] = acc;
}

template <int D>
constexpr size_t smem_bytes() {
  return (size_t(4) * kBlock * (D + 4) + 2 * kBlock * kPPitch + 2 * kBlock) *
         sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv(Args a) {
  constexpr int P = D + 4;
  using C = Cols<D>;
  constexpr int NC = C::kN;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [64][P]
  float* Vs = Ks + kBlock * P;
  float* Qs = Vs + kBlock * P;
  float* dOs = Qs + kBlock * P;
  float* Ps = dOs + kBlock * P;                  // [64 rows][kPPitch]
  float* dSs = Ps + kBlock * kPPitch;
  float* lse_s = dSs + kBlock * kPPitch;
  float* delta_s = lse_s + kBlock;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * kBlock;
  const int g = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  load_rows<T, D>(Ks, slice<T>(a, kK, a.k, b, g), a.st[kK][2], k0, a.Sk);
  load_rows<T, D>(Vs, slice<T>(a, kV, a.v, b, g), a.st[kV][2], k0, a.Sk);

  // Query tiles that can see a key of this tile.
  const int nq = (a.Sq + kBlock - 1) / kBlock;
  const int qt_begin = a.causal ? k0 / kBlock : 0;
  int qt_end = nq;
  if (a.window > 0)
    qt_end = min(nq, (k0 + kBlock - 2 + a.window) / kBlock + 1);

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int r = 0; r < G; ++r) {
    const int h = g * G + r;
    const T* Q = slice<T>(a, kQ, a.q, b, h);
    const T* dO = slice<T>(a, kDO, a.dout, b, h);
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kBlock;
      __syncthreads();  // the last tile's reads of Qs, dOs, Ps, dSs done
      load_rows<T, D>(Qs, Q, a.st[kQ][2], q0, a.Sq);
      load_rows<T, D>(dOs, dO, a.st[kDO][2], q0, a.Sq);
      load_row_stats(lse_s, delta_s, a, b, h, q0);
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dot<D>(s, Qs, Ks, tx, ty);
      tile_dot<D>(dp, dOs, Vs, tx, ty);
      p_and_ds(s, dp, lse_s, delta_s, Ps, dSs, q0, k0, tx, ty, a);
      __syncthreads();
      // dV[key] += Σ_row P[row][key]·dO[row];
      // dK[key] += Σ_row dS[row][key]·Q[row] (scaled at the store).
      tile_accumulate<D, false>(dv, Ps, dOs, tx, ty);
      tile_accumulate<D, false>(dk, dSs, Qs, tx, ty);
    }
  }

  T* dK = static_cast<T*>(a.dk) + b * a.st[kDK][0] + g * a.st[kDK][1];
  T* dV = static_cast<T*>(a.dv) + b * a.st[kDV][0] + g * a.st[kDV][1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= a.Sk) continue;
    T* dkrow = dK + int64_t(kp) * a.st[kDK][2];
    T* dvrow = dV + int64_t(kp) * a.st[kDV][2];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = C::col(tx, j);
      if (c < D) {
        store(dkrow + c, a.scale * dk[i][j]);
        store(dvrow + c, dv[i][j]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq(Args a) {
  constexpr int P = D + 4;
  using C = Cols<D>;
  constexpr int NC = C::kN;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [64][P]
  float* dOs = Qs + kBlock * P;
  float* Ks = dOs + kBlock * P;
  float* Vs = Ks + kBlock * P;
  float* dSs = Vs + kBlock * P;                  // [64 rows][kPPitch]
  float* lse_s = dSs + kBlock * kPPitch;
  float* delta_s = lse_s + kBlock;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nq = (a.Sq + kBlock - 1) / kBlock;
  const int q0 = (nq - 1 - int(blockIdx.x)) * kBlock;   // last tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.Hkv);
  load_rows<T, D>(Qs, slice<T>(a, kQ, a.q, b, h), a.st[kQ][2], q0, a.Sq);
  load_rows<T, D>(dOs, slice<T>(a, kDO, a.dout, b, h), a.st[kDO][2], q0,
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
    load_rows<T, D>(Vs, V, a.st[kV][2], k0, a.Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(s, Qs, Ks, tx, ty);
    tile_dot<D>(dp, dOs, Vs, tx, ty);
    p_and_ds(s, dp, lse_s, delta_s, nullptr, dSs, q0, k0, tx, ty, a);
    __syncthreads();
    // dQ[row] += Σ_key dS[row][key] K[key]
    tile_accumulate<D, true>(dq, dSs, Ks, tx, ty);
  }

  T* dQ = static_cast<T*>(a.dq) + b * a.st[kDQ][0] + h * a.st[kDQ][1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= a.Sq) continue;
    T* row = dQ + int64_t(qp) * a.st[kDQ][2];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = C::col(tx, j);
      if (c < D) store(row + c, a.scale * dq[i][j]);
    }
  }
}

template <typename T, int D>
int launch_d(const Args& a, cudaStream_t stream) {
  const int64_t rows = int64_t(a.B) * a.H * a.Sq;
  const int64_t delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
  flash_bwd_delta<T, D><<<unsigned(delta_blocks), kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const int smem = int(smem_bytes<D>());
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid_kv((a.Sk + kBlock - 1) / kBlock, a.Hkv, a.B);
  flash_bwd_dkdv<T, D><<<grid_kv, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  err = cudaFuncSetAttribute(flash_bwd_dq<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid_q((a.Sq + kBlock - 1) / kBlock, a.H, a.B);
  flash_bwd_dq<T, D><<<grid_q, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, const int64_t* strides, int B, int H, int Hkv,
           int Sq, int Sk, int D, int causal, int window, void* stream) {
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
  switch (D) {
    case 8: return launch_d<T, 8>(a, st);
    case 16: return launch_d<T, 16>(a, st);
    case 32: return launch_d<T, 32>(a, st);
    case 64: return launch_d<T, 64>(a, st);
    case 128: return launch_d<T, 128>(a, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// strides: 24 element strides, (b, h, s) of q, k, v, o, do, dq, dk, dv in
// that order; the D axis of each must have unit stride. lse: the forward's
// contiguous f32 (B, H, Sq) log-sum-exp; delta: a contiguous f32
// (B, H, Sq) scratch buffer the call fills with Δ.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const float* lse, float* delta, void* dq,
                            void* dk, void* dv, const int64_t* strides,
                            int B, int H, int Hkv, int Sq, int Sk, int D,
                            int causal, int window, void* stream) {
  return launch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, strides, B,
                       H, Hkv, Sq, Sk, D, causal, window, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, float* delta, void* dq,
                             void* dk, void* dv, const int64_t* strides,
                             int B, int H, int Hkv, int Sq, int Sk, int D,
                             int causal, int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                               strides, B, H, Hkv, Sq, Sk, D, causal, window,
                               stream);
}

}  // extern "C"
