// rwkv6_wkv: the RWKV-6 WKV recurrence (prefill), sm_90a.
//
//   per (b, h), state S (N x N, f32, from zero), for t = 0 .. S_len-1:
//     y_t[m]  = sum_n r_t[n] (S[n][m] + u[n] k_t[n] v_t[m])
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
//   y = r^T S + (sum_n r[n] u[n] k[n]) v   2 N^2 + 5 N FLOP (the bonus
//                                           term is a dot product, O(N))
//   S <- diag(w) S + k v^T                 3 N^2 FLOP
// so 5 N^2 + 5 N. At the serving path's prefill shape (B=4, H=40,
// S=4096, N=64; bf16 r, k, v, y and f32 w) that is
// 4*40*4096*(5*64^2 + 5*64) = 1.36e10 FLOP, 0.20 ms at the card's
// 67 TFLOP/s f32 rate, against 503 MB moved (r, k, v, y 4 x 83.9 MB,
// w 167.8 MB), 0.15 ms at 3.35 TB/s. This kernel does more than that:
// it expands the bonus term for every state entry, one multiply
// (kv = k[n] v[m]) and three FMAs (u kv + S, r (.) + y, w S + kv), 7 N^2
// FLOP per step. The recurrence is sequential in t, so it has only
// B*H*N threads (10,240 at that shape, ~2.4 warps per SM): it is
// latency-bound, far from either bound. Splitting value columns over
// more blocks, or a chunked tensor-core form, is later work.
//
// Design:
// - The value columns of the state are independent: thread m of the
//   block of (b, h) owns column m, S[:, m], in N f32 registers, for the
//   whole sequence. The state never leaves registers, so there is no
//   chunk precondition on S (the TPU kernel's S % chunk == 0).
// - The block stages kTile steps of r, k, w and v into shared memory in
//   f32 (thread m loads element m of each step: coalesced), then runs the
//   steps. Every thread reads the same r[n], k[n], w[n], u[n] at once (a
//   broadcast, no bank conflict) and its own v[m]. The tile is bounds-
//   checked at the sequence's end.
// - y_t[m] goes straight to device memory (the block's N threads write N
//   neighbouring elements).
// - Strides (b, h, s) in elements for each of r, k, v, w and y, unit
//   stride on N: the model's (B, S, H, N) projections go in as views, no
//   copies.
//
// Plain C interface for ctypes (no PyTorch headers): every entry point
// launches on the caller's stream, never synchronises, allocates nothing
// and returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for an N outside {4, 8, 16, 32, 64} or a size out
// of range).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;  // steps staged in shared memory per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;
  void* y;
  int64_t r_sb, r_sh, r_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t w_sb, w_sh, w_ss;
  int64_t y_sb, y_sh, y_ss;
  int S;
};

// T: dtype of r, k, v and y; TW: dtype of w.
template <typename T, typename TW, int N>
__global__ void __launch_bounds__(N) wkv_fwd(Args a) {
  __shared__ __align__(16) float rs[kTile][N];
  __shared__ __align__(16) float ks[kTile][N];
  __shared__ __align__(16) float vs[kTile][N];
  __shared__ __align__(16) float ws[kTile][N];
  __shared__ __align__(16) float us[N];

  const int m = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const T* R = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh;
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const TW* W = static_cast<const TW*>(a.w) + b * a.w_sb + h * a.w_sh;
  T* Y = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh;

  us[m] = a.u[int64_t(h) * N + m];
  float s[N];
#pragma unroll
  for (int n = 0; n < N; ++n) s[n] = 0.f;

  for (int t0 = 0; t0 < a.S; t0 += kTile) {
    const int len = min(kTile, a.S - t0);
    __syncthreads();  // the last tile's reads are done (and us is written)
    for (int j = 0; j < len; ++j) {
      const int64_t t = t0 + j;
      rs[j][m] = to_f32(R[t * a.r_ss + m]);
      ks[j][m] = to_f32(K[t * a.k_ss + m]);
      vs[j][m] = to_f32(V[t * a.v_ss + m]);
      ws[j][m] = to_f32(W[t * a.w_ss + m]);
    }
    __syncthreads();

    for (int j = 0; j < len; ++j) {
      const float vm = vs[j][m];
      float y = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float kv = ks[j][n] * vm;
        y = fmaf(rs[j][n], fmaf(us[n], kv, s[n]), y);
        s[n] = fmaf(ws[j][n], s[n], kv);
      }
      store(Y + int64_t(t0 + j) * a.y_ss + m, y);
    }
  }
}

template <typename T, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* y, const int64_t* st, int B, int H, int S,
           int N, cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || S < 1) return int(cudaErrorInvalidValue);
  Args a{r, k, v, w, static_cast<const float*>(u), y,
         st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
         st[8], st[9], st[10], st[11], st[12], st[13], st[14], S};
  const dim3 grid(H, B);
  switch (N) {
    case 4: wkv_fwd<T, TW, 4><<<grid, 4, 0, stream>>>(a); break;
    case 8: wkv_fwd<T, TW, 8><<<grid, 8, 0, stream>>>(a); break;
    case 16: wkv_fwd<T, TW, 16><<<grid, 16, 0, stream>>>(a); break;
    case 32: wkv_fwd<T, TW, 32><<<grid, 32, 0, stream>>>(a); break;
    case 64: wkv_fwd<T, TW, 64><<<grid, 64, 0, stream>>>(a); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// strides: 15 element strides, (b, h, s) of r, k, v, w, y in that order;
// the N axis of each must have unit stride. u: (H, N) f32, contiguous.

// r, k, v, w, y f32.
int rwkv6_wkv_f32(const void* r, const void* k, const void* v, const void* w,
                  const void* u, void* y, const int64_t* strides, int B,
                  int H, int S, int N, void* stream) {
  return launch<float, float>(r, k, v, w, u, y, strides, B, H, S, N,
                              static_cast<cudaStream_t>(stream));
}

// r, k, v, y bf16; w f32 (the model's path).
int rwkv6_wkv_bf16(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* y, const int64_t* strides, int B,
                   int H, int S, int N, void* stream) {
  return launch<__nv_bfloat16, float>(r, k, v, w, u, y, strides, B, H, S, N,
                                      static_cast<cudaStream_t>(stream));
}

// r, k, v, w, y bf16.
int rwkv6_wkv_bf16_wbf16(const void* r, const void* k, const void* v,
                         const void* w, const void* u, void* y,
                         const int64_t* strides, int B, int H, int S, int N,
                         void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(
      r, k, v, w, u, y, strides, B, H, S, N,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
