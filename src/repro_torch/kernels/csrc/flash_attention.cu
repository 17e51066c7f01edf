// flash_attention: causal / sliding-window GQA attention forward, sm_90a.
//
//   O[b,h] = softmax(Q[b,h] K[b,h/G]^T / sqrt(D) + mask) V[b,h/G]
//
//   q: (B, H, Sq, D), k/v: (B, Hkv, Sk, D), o: (B, H, Sq, D); G = H / Hkv.
//   f32 or bf16 in and out; scores, probabilities and sums in f32.
//   mask: k_pos < Sk; causal q_pos >= k_pos; window q_pos - k_pos < W.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:87, pallas_call at :119, body
// `_flash_kernel` at :27), whose oracle is `flash_attention_ref`
// (src/repro/kernels/ref.py:18).
//
// Bound: operations. At the serving path's prefill shape (B=4, H=16,
// Hkv=8, S=4096, D=128, bf16, causal) one call does 2*B*H*S^2*D =
// 2.75e11 FLOP (the causal half of QK^T and PV) on 201.3 MB of q, k, v
// and o (100.7 M bf16 elements): ~0.28 ms at the card's 989 TFLOP/s
// dense bf16 rate, against ~0.06 ms for the bytes at 3.35 TB/s. This
// kernel does its products with f32 FMAs (no tensor cores), so its own
// ceiling is the 67 TFLOP/s f32 rate, ~4.1 ms per call; wgmma, TMA and
// warp specialisation are later work.
//
// Design against that bound:
// - One block of 256 threads per (64-row query tile, query head, batch).
//   Query head h reads KV head h / G (the TPU kernel's index map). Tiles
//   are launched last-first so the long causal rows start early.
// - Loop bounds skip unreachable K tiles (the TPU kernel's @pl.when):
//   under causal no tile starts past the query tile's last row; under a
//   window no tile lies wholly older than W.
// - The Q tile and each K tile sit transposed in shared memory, in f32
//   (converted once at load); each thread computes a 4x4 block of the
//   64x64 score tile from float4 reads of both (16 FMAs per two shared
//   loads). Rows of a score tile live in one half-warp, so the row max
//   and row sum are shuffles.
// - Online softmax as in the TPU kernel: m starts at -1e30 (not -inf),
//   masked scores are -1e30, l is clamped at 1e-30 at the end. A row
//   whose first visited tile is wholly masked (under a window) gathers
//   exp(0) rubbish there; alpha = exp(-1e30 - m) = 0 wipes it when the
//   row's diagonal tile arrives. With -inf that row would be NaN.
// - P goes through shared memory (transposed) into P·V; V reuses the K
//   buffer, so shared memory is (2*D + 64) * 68 floats: 87,040 bytes at
//   D=128, dynamic, above the 48 KB static limit
//   (cudaFuncSetAttribute), two blocks per SM.
// - Strides (b, h, s) in elements for each of q, k, v, o, unit stride on
//   D: the model's (B, S, H, D) projections go in as views, no copies.
//
// Plain C interface for ctypes (no PyTorch headers): every entry point
// launches on the caller's stream, never synchronises, allocates nothing
// and returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for a D outside {8,16,32,64,128}, H % Hkv != 0,
// or a size out of range).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;            // 16 x 16 threads, 4x4 each
constexpr int kPitch = kBlockQ + 4;      // row pitch of transposed tiles
constexpr float kNegInf = -1e30f;        // as the TPU kernel's NEG_INF
constexpr float kMinDenom = 1e-30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int H, Hkv, Sq, Sk;
  int causal;
  int window;                            // <= 0: no window
  float scale;
};

// Columns of the output (and of V) a thread owns: D >= 64 as float4
// groups at 4*tx + 64*g (16 lanes read 256 contiguous bytes);
// D < 64 as single columns tx + 16*j (tx < D for D = 8).
template <int D>
struct Cols {
  static constexpr bool kVec = D % 64 == 0;
  static constexpr int kN = kVec ? D / 16 : (D + 15) / 16;
  __device__ static __forceinline__ int col(int tx, int j) {
    return kVec ? 4 * tx + 64 * (j / 4) + (j % 4) : tx + 16 * j;
  }
};

// Load rows [s0, s0 + 64) of a (S, D) slice into shared memory as f32,
// zero past S. Transposed: dst[d * kPitch + r]; else dst[r * D + d].
template <typename T, int D, bool kTransposed>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t s_stride, int s0, int S) {
  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = s0 + r;
    const float x = s < S ? to_f32(src[int64_t(s) * s_stride + d]) : 0.f;
    if (kTransposed)
      dst[d * kPitch + r] = x;
    else
      dst[r * D + d] = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd(Args a) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);   // [D][kPitch]
  float* kv = qT + D * kPitch;                   // K^T [D][kPitch] | V [64][D]
  float* pT = kv + D * kPitch;                   // P^T [64][kPitch]
  using C = Cols<D>;
  constexpr int NC = C::kN;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nq = (a.Sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (nq - 1 - int(blockIdx.x)) * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* O = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  load_tile<T, D, true>(qT, Q, a.q_ss, q0, a.Sq);

  // Reachable K tiles (loop bounds in place of the TPU kernel's
  // block-level @pl.when).
  const int nk = (a.Sk + kBlockK - 1) / kBlockK;
  int kt_end = nk;
  if (a.causal) kt_end = min(nk, (q0 + kBlockQ - 1) / kBlockK + 1);
  int kt_begin = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0)
    kt_begin = (q0 - a.window + 1) / kBlockK;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the last tile's reads of V and P^T are done
    load_tile<T, D, true>(kv, K, a.k_ss, k0, a.Sk);
    __syncthreads();

    // S = Q K^T on this thread's rows 4*ty + i, columns 4*tx + j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qT + d * kPitch + 4 * ty);
      const float4 kb = *reinterpret_cast<const float4*>(kv + d * kPitch + 4 * tx);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kw[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kw[j], s[i][j]);
    }

    const bool masked =
        k0 + kBlockK > a.Sk || (a.causal && k0 + kBlockK - 1 > q0) ||
        (a.window > 0 && q0 + kBlockQ - 1 - k0 >= a.window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * a.scale;
        if (masked) {
          const int kp = k0 + 4 * tx + j;
          bool ok = kp < a.Sk;
          if (a.causal) ok = ok && qp >= kp;
          if (a.window > 0) ok = ok && qp - kp < a.window;
          if (!ok) x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // The 16 lanes of a half-warp hold one row.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pT + (4 * tx + j) * kPitch + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();  // K^T reads done, P^T written
    load_tile<T, D, false>(kv, V, a.v_ss, k0, a.Sk);
    __syncthreads();

    // acc += P V on this thread's rows and columns.
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(pT + c * kPitch + 4 * ty);
      const float p[4] = {pa.x, pa.y, pa.z, pa.w};
      const float* vrow = kv + c * D;
      if constexpr (C::kVec) {
#pragma unroll
        for (int g = 0; g < NC / 4; ++g) {
          const float4 vb = *reinterpret_cast<const float4*>(vrow + 4 * tx + 64 * g);
          const float vv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][4 * g + e] = fmaf(p[i], vv[e], acc[i][4 * g + e]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int col = C::col(tx, j);
          const float vv = col < D ? vrow[col] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }

  // Normalize once and write this thread's rows.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= a.Sq) continue;
    const float denom = fmaxf(l[i], kMinDenom);
    T* orow = O + int64_t(r) * a.o_ss;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = C::col(tx, j);
      if (col < D) store(orow + col, acc[i][j] / denom);
    }
  }
}

template <typename T, int D>
int launch_d(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = size_t(2 * D + kBlockK) * kPitch * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.Sq + kBlockQ - 1) / kBlockQ, a.H, B);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const int64_t* strides, int B, int H, int Hkv, int Sq, int Sk,
           int D, int causal, int window, cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || Hkv < 1 || H % Hkv != 0 ||
      Sq < 1 || Sk < 1)
    return int(cudaErrorInvalidValue);
  Args a{q, k, v, o,
         strides[0], strides[1], strides[2],
         strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8],
         strides[9], strides[10], strides[11],
         H, Hkv, Sq, Sk, causal, window, 1.0f / sqrtf(float(D))};
  switch (D) {
    case 8: return launch_d<T, 8>(a, B, stream);
    case 16: return launch_d<T, 16>(a, B, stream);
    case 32: return launch_d<T, 32>(a, B, stream);
    case 64: return launch_d<T, 64>(a, B, stream);
    case 128: return launch_d<T, 128>(a, B, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// strides: 12 element strides, (b, h, s) of q, k, v, o in that order;
// the D axis of each must have unit stride.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        const int64_t* strides, int B, int H, int Hkv,
                        int Sq, int Sk, int D, int causal, int window,
                        void* stream) {
  return launch<float>(q, k, v, o, strides, B, H, Hkv, Sq, Sk, D, causal,
                       window, static_cast<cudaStream_t>(stream));
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, const int64_t* strides, int B, int H,
                         int Hkv, int Sq, int Sk, int D, int causal,
                         int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, strides, B, H, Hkv, Sq, Sk, D,
                               causal, window,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
