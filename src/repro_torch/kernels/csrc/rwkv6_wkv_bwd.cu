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
//   on N; u: (H, N) f32. dr, dk, dv come back in r's dtype, dw in w's, du
//   (H, N) f32. r, k, v, dy share one dtype, f32 or bf16; w is f32 or r's
//   dtype (the model passes f32). All arithmetic in f32.
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
// At the training shape (B=2, H=40, S=1024, N=64) that is 4.70e9 FLOP,
// 0.070 ms at the card's 67 TFLOP/s f32 rate, against 115 MB moved (bf16
// r, k, v, dy read and dr, dk, dv written, f32 w read and dw written: 22
// bytes per (b, h, t, n)), 0.034 ms at 3.35 TB/s. At the serve shape (B=4,
// S=4096) 3.76e10 FLOP, 0.56 ms.
//
// Design (a first, simple kernel: one pass per state entry, the exact
// recurrences, no division by w and no cumulative decay products, so
// w = 0 forgets and w = 1 sums exactly in both directions):
// - Three launches on the caller's stream.
//   1. wkv_bwd_ckpt: the forward recurrence of S, writing the state before
//      every kChunk = 8 steps to a checkpoint buffer.
//   2. wkv_bwd_rev: the reverse sweep, chunk by chunk from the end. Each
//      thread rebuilds its entries' states S_{t-1} for the chunk's 8 steps
//      from the chunk's checkpoint into registers, then walks the steps
//      backwards with G in registers.
//   3. wkv_bwd_fin: sums the column blocks' partial dr, dk, dw in a fixed
//      order and casts them; sums du's per-(b, h) partials over b in order.
//   No float atomics anywhere: the gradients are bit-reproducible.
// - A block holds all N keys and CB = min(N, 32) value columns of one
//   (b, h); SPLIT = N / CB blocks cover a (b, h) (2 at N = 64). A thread
//   holds one key n and CPT = min(CB, 8) columns of S and of G, so the
//   sums over m (dr, dk, dw) are in-thread sums added over TPK = CB / CPT
//   neighbouring lanes by xor shuffles, and the sum over n (dv) a
//   reduce-scatter over the warp's keys by xor shuffles plus a fixed-order
//   sum over the block's warps in shared memory. dv is complete in one
//   block (all keys); dr, dk, dw are partial over the SPLIT column blocks
//   and go through the scratch partials and launch 3.
// - Per chunk, the steps' r, k, w, v and dy rows (all N) are staged in
//   shared memory in f32, with the scalars c_t = sum_n r u k and
//   v_t . dy_t. The bonus terms are added once, by column block 0.
// - Ragged S: the staged rows past S are zeros, so G stays 0 there and
//   nothing past S is stored.
//
// Scratch (f32, one buffer from the wrapper): checkpoints B*H*ceil(S/8)*N^2,
// partials 3*SPLIT*B*H*S*N, du partials B*H*N. At the training shape (B=2,
// H=40, S=1024, N=64): 41,943,040 + 31,457,280 + 5,120 floats = 293.6 MB.
// At the serve shape (B=4, S=4096): 335,544,320 + 251,658,240 + 10,240
// floats = 2.35 GB.
//
// Plain C interface for ctypes (no PyTorch headers): every entry point
// launches on the caller's stream, never synchronises, allocates nothing
// and returns the cudaError_t of the launches (0 on success;
// cudaErrorInvalidValue for an N outside {4, 8, 16, 32, 64}, a size out
// of range, or a scratch buffer smaller than the layout needs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;     // steps per checkpoint (registers per entry)
constexpr int kFinSteps = 16;  // steps per block of the finishing launch
constexpr int kFinThreads = 256;

template <int N>
struct Layout {
  static constexpr int CB = N >= 32 ? 32 : N;    // value columns per block
  static constexpr int SPLIT = N / CB;           // blocks per (b, h)
  static constexpr int CPT = CB >= 8 ? 8 : CB;   // columns per thread
  static constexpr int TPK = CB / CPT;           // threads per key
  static constexpr int THREADS = N * TPK;
  static constexpr int WARP = THREADS < 32 ? THREADS : 32;  // lanes in use
  static constexpr int NW = (THREADS + 31) / 32;            // warps
  static constexpr int KW = WARP / TPK;                     // keys per warp
  static constexpr unsigned MASK =
      THREADS >= 32 ? 0xffffffffu : (1u << THREADS) - 1u;
  static_assert(CPT % 4 == 0, "a thread's columns are float4s");
  static_assert(KW >= CPT, "the dv reduce-scatter ends at one column");
  static_assert(THREADS <= 32 || THREADS % 32 == 0, "whole warps");
};

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
  const void* dy;
  void* dr;
  void* dk;
  void* dv;
  void* dw;
  float* du;
  float* ckpt;   // (B, H, nch, N, N)
  float* part;   // (3, SPLIT, B, H, S, N): dr, dk, dw partials
  float* dupart;  // (B, H, N)
  // (b, h, s) element strides of r, k, v, w, dy, dr, dk, dv, dw
  int64_t st[9][3];
  int B, H, S;
};

enum { kR, kK, kV, kW, kDY, kDR, kDK, kDV, kDW };

__device__ __forceinline__ int64_t off(const Args& a, int which, int b,
                                       int h, int t) {
  return b * a.st[which][0] + h * a.st[which][1] + t * a.st[which][2];
}

// Shared memory of one block: a chunk's rows in f32 and the reductions.
template <int N>
struct Smem {
  using L = Layout<N>;
  __align__(16) float r[kChunk][N];
  __align__(16) float k[kChunk][N];
  __align__(16) float w[kChunk][N];
  __align__(16) float v[kChunk][N];
  __align__(16) float dy[kChunk][N];
  float u[N];
  float cb[kChunk];    // sum_n r u k
  float vdy[kChunk];   // v . dy
  float red[3][kChunk][N];          // dr, dk, dw over the block's columns
  float dvp[kChunk][L::NW][L::CB];  // dv summed over each warp's keys
};

// Stage the rows of steps c0 .. c0 + kChunk - 1 (zeros past S). `all`
// false stages only k, w and v (the checkpoint sweep).
template <typename T, typename TW, int N, bool all>
__device__ __forceinline__ void stage(Smem<N>& sm, const Args& a, int b,
                                      int h, int c0) {
  const T* R = static_cast<const T*>(a.r);
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  const TW* W = static_cast<const TW*>(a.w);
  const T* DY = static_cast<const T*>(a.dy);
  for (int i = threadIdx.x; i < kChunk * N; i += Layout<N>::THREADS) {
    const int j = i / N, n = i % N, t = c0 + j;
    const bool in = t < a.S;
    sm.k[j][n] = in ? to_f32(K[off(a, kK, b, h, t) + n]) : 0.f;
    sm.w[j][n] = in ? to_f32(W[off(a, kW, b, h, t) + n]) : 0.f;
    sm.v[j][n] = in ? to_f32(V[off(a, kV, b, h, t) + n]) : 0.f;
    if constexpr (all) {
      sm.r[j][n] = in ? to_f32(R[off(a, kR, b, h, t) + n]) : 0.f;
      sm.dy[j][n] = in ? to_f32(DY[off(a, kDY, b, h, t) + n]) : 0.f;
    }
  }
}

// Sum CNT per-column values over the KW keys of a warp (lanes STRIDE
// apart per key bit), highest key bit first: while a lane holds more than
// one column it keeps half and sends half (a reduce-scatter), and `own`
// gains the offset of the half it keeps; then the remaining key bits are
// summed in full. At the end acc[0] is the sum of column `own`, held by
// every lane whose key bits below those used for the scatter differ.
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

// 1. The forward recurrence of S; the state before chunk ci goes to
// checkpoint ci.
template <typename T, typename TW, int N>
__global__ void __launch_bounds__(Layout<N>::THREADS)
    wkv_bwd_ckpt(const Args a) {
  using L = Layout<N>;
  constexpr int CPT = L::CPT;
  __shared__ Smem<N> sm;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n = threadIdx.x / L::TPK, cg = threadIdx.x % L::TPK;
  const int col = split * L::CB + cg * CPT;
  const int nch = (a.S + kChunk - 1) / kChunk;
  float* ck = a.ckpt + ((int64_t(b) * a.H + h) * nch) * (N * N) + n * N + col;

  float s[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) s[c] = 0.f;
  for (int ci = 0; ci < nch; ++ci) {
    float4* dst = reinterpret_cast<float4*>(ck + int64_t(ci) * (N * N));
#pragma unroll
    for (int q = 0; q < CPT / 4; ++q)
      dst[q] = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2],
                           s[4 * q + 3]);
    if (ci == nch - 1) break;
    __syncthreads();  // the last chunk's reads of the stage are done
    stage<T, TW, N, false>(sm, a, b, h, ci * kChunk);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float kn = sm.k[j][n], wn = sm.w[j][n];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        s[c] = fmaf(wn, s[c], kn * sm.v[j][col + c]);
    }
  }
}

// 2. The reverse sweep: dv complete, dr / dk / dw partial over the
// block's columns, du's partial over t.
template <typename T, typename TW, int N>
__global__ void __launch_bounds__(Layout<N>::THREADS, 2)
    wkv_bwd_rev(const Args a) {
  using L = Layout<N>;
  constexpr int CPT = L::CPT, TPK = L::TPK, KW = L::KW, CB = L::CB;
  __shared__ Smem<N> sm;
  const int tid = threadIdx.x;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n = tid / TPK, cg = tid % TPK;
  const int warp = tid / 32, kw = (tid % L::WARP) / TPK;
  const int col = split * CB + cg * CPT;  // first column of the thread
  const int nch = (a.S + kChunk - 1) / kChunk;
  const float* ck = a.ckpt + ((int64_t(b) * a.H + h) * nch) * (N * N)
      + n * N + col;
  const int64_t bh = int64_t(b) * a.H + h;
  const int64_t plane = int64_t(a.B) * a.H * a.S * N;  // one partial array
  float* P = a.part + int64_t(split) * plane + bh * a.S * N;
  T* DV = static_cast<T*>(a.dv) + b * a.st[kDV][0] + h * a.st[kDV][1];
  for (int i = tid; i < N; i += L::THREADS) sm.u[i] = a.u[int64_t(h) * N + i];

  float g[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) g[c] = 0.f;
  float du_acc = 0.f;

  for (int ci = nch - 1; ci >= 0; --ci) {
    const int c0 = ci * kChunk;
    __syncthreads();  // the last chunk's write-out is done with sm
    stage<T, TW, N, true>(sm, a, b, h, c0);
    float s[CPT];
    {
      const float4* src =
          reinterpret_cast<const float4*>(ck + int64_t(ci) * (N * N));
#pragma unroll
      for (int q = 0; q < CPT / 4; ++q) {
        const float4 x = src[q];
        s[4 * q] = x.x;
        s[4 * q + 1] = x.y;
        s[4 * q + 2] = x.z;
        s[4 * q + 3] = x.w;
      }
    }
    __syncthreads();
    for (int j = tid; j < kChunk; j += L::THREADS) {
      float cb = 0.f, vd = 0.f;
      for (int m = 0; m < N; ++m) {
        cb = fmaf(sm.r[j][m] * sm.u[m], sm.k[j][m], cb);
        vd = fmaf(sm.v[j][m], sm.dy[j][m], vd);
      }
      sm.cb[j] = cb;
      sm.vdy[j] = vd;
    }
    // S_{t-1} of the chunk's steps, rebuilt from the checkpoint.
    float sp[kChunk][CPT];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float kn = sm.k[j][n], wn = sm.w[j][n];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        sp[j][c] = s[c];
        s[c] = fmaf(wn, s[c], kn * sm.v[j][col + c]);
      }
    }
    __syncthreads();  // cb, vdy

#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      const float rn = sm.r[j][n], kn = sm.k[j][n], wn = sm.w[j][n];
      float pr = 0.f, pk = 0.f, pw = 0.f, gv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = sm.v[j][col + c], dd = sm.dy[j][col + c];
        pr = fmaf(sp[j][c], dd, pr);
        pk = fmaf(g[c], vv, pk);
        pw = fmaf(g[c], sp[j][c], pw);
        gv[c] = g[c] * kn;
        g[c] = fmaf(wn, g[c], rn * dd);
      }
#pragma unroll
      for (int o = 1; o < TPK; o <<= 1) {
        pr += __shfl_xor_sync(L::MASK, pr, o);
        pk += __shfl_xor_sync(L::MASK, pk, o);
        pw += __shfl_xor_sync(L::MASK, pw, o);
      }
      if (cg == 0) {
        sm.red[0][j][n] = pr;
        sm.red[1][j][n] = pk;
        sm.red[2][j][n] = pw;
      }
      if (split == 0 && cg == 0) du_acc = fmaf(rn * kn, sm.vdy[j], du_acc);
      int own = 0;
      reduce_keys<KW, CPT, TPK>(gv, kw, own, L::MASK);
      if ((kw & (KW / CPT - 1)) == 0) sm.dvp[j][warp][cg * CPT + own] = gv[0];
    }
    __syncthreads();

    // Write the chunk out: the partials of dr, dk (with the bonus terms
    // from column block 0) and dw; dv in full.
    for (int i = tid; i < kChunk * N; i += L::THREADS) {
      const int j = i / N, m = i % N, t = c0 + j;
      if (t >= a.S) continue;
      float br = 0.f, bk = 0.f;
      if (split == 0) {
        const float uv = sm.u[m] * sm.vdy[j];
        br = uv * sm.k[j][m];
        bk = uv * sm.r[j][m];
      }
      const int64_t o = int64_t(t) * N + m;
      P[o] = sm.red[0][j][m] + br;
      P[int64_t(L::SPLIT) * plane + o] = sm.red[1][j][m] + bk;
      P[2 * int64_t(L::SPLIT) * plane + o] = sm.red[2][j][m];
    }
    for (int i = tid; i < kChunk * CB; i += L::THREADS) {
      const int j = i / CB, m = i % CB, t = c0 + j;
      if (t >= a.S) continue;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < L::NW; ++q) acc += sm.dvp[j][q][m];
      acc = fmaf(sm.cb[j], sm.dy[j][split * CB + m], acc);
      store(DV + t * a.st[kDV][2] + split * CB + m, acc);
    }
  }
  if (split == 0 && cg == 0) a.dupart[bh * N + n] = du_acc;
}

// 3. dr, dk, dw: the SPLIT partials summed in order and cast; du: the
// per-(b, h) partials summed over b in order.
template <typename T, typename TW>
__global__ void __launch_bounds__(kFinThreads)
    wkv_bwd_fin(const Args a, int N, int split_n) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * kFinSteps;
  const int64_t plane = int64_t(a.B) * a.H * a.S * N;
  const float* P = a.part + (int64_t(b) * a.H + h) * a.S * N;
  T* DR = static_cast<T*>(a.dr);
  T* DK = static_cast<T*>(a.dk);
  TW* DW = static_cast<TW*>(a.dw);
  for (int i = threadIdx.x; i < kFinSteps * N; i += kFinThreads) {
    const int t = t0 + i / N, n = i % N;
    if (t >= a.S) continue;
    const int64_t o = int64_t(t) * N + n;
    float sr = 0.f, sk = 0.f, sw = 0.f;
    for (int sp = 0; sp < split_n; ++sp) {
      sr += P[int64_t(sp) * plane + o];
      sk += P[int64_t(split_n + sp) * plane + o];
      sw += P[int64_t(2 * split_n + sp) * plane + o];
    }
    store(DR + off(a, kDR, b, h, t) + n, sr);
    store(DK + off(a, kDK, b, h, t) + n, sk);
    store(DW + off(a, kDW, b, h, t) + n, sw);
  }
  if (blockIdx.x == 0 && b == 0) {
    for (int n = threadIdx.x; n < N; n += kFinThreads) {
      float s = 0.f;
      for (int bb = 0; bb < a.B; ++bb)
        s += a.dupart[(int64_t(bb) * a.H + h) * N + n];
      a.du[int64_t(h) * N + n] = s;
    }
  }
}

template <int N>
int64_t scratch_floats(int B, int H, int S) {
  const int64_t nch = (S + kChunk - 1) / kChunk;
  return int64_t(B) * H * nch * N * N
      + 3 * int64_t(Layout<N>::SPLIT) * B * H * int64_t(S) * N
      + int64_t(B) * H * N;
}

template <typename T, typename TW, int N>
int launch_n(Args a, int64_t n_scratch, cudaStream_t stream) {
  using L = Layout<N>;
  if (n_scratch < scratch_floats<N>(a.B, a.H, a.S))
    return int(cudaErrorInvalidValue);
  const int64_t nch = (a.S + kChunk - 1) / kChunk;
  a.part = a.ckpt + int64_t(a.B) * a.H * nch * N * N;
  a.dupart = a.part + 3 * int64_t(L::SPLIT) * a.B * a.H * int64_t(a.S) * N;
  const dim3 grid(L::SPLIT, a.H, a.B);
  wkv_bwd_ckpt<T, TW, N><<<grid, L::THREADS, 0, stream>>>(a);
  wkv_bwd_rev<T, TW, N><<<grid, L::THREADS, 0, stream>>>(a);
  wkv_bwd_fin<T, TW><<<dim3((a.S + kFinSteps - 1) / kFinSteps, a.H, a.B),
                       kFinThreads, 0, stream>>>(a, N, L::SPLIT);
  return int(cudaGetLastError());
}

template <typename T, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* dy, void* dr, void* dk, void* dv,
           void* dw, void* du, void* scratch, int64_t n_scratch,
           const int64_t* strides, int B, int H, int S, int N,
           cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || S < 1)
    return int(cudaErrorInvalidValue);
  Args a{};
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = w;
  a.u = static_cast<const float*>(u);
  a.dy = dy;
  a.dr = dr;
  a.dk = dk;
  a.dv = dv;
  a.dw = dw;
  a.du = static_cast<float*>(du);
  a.ckpt = static_cast<float*>(scratch);
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

// strides: 27 int64, the (b, h, s) element strides of r, k, v, w, dy, dr,
// dk, dv, dw in that order. scratch: n_scratch f32 (see the header).

// r, k, v, w, dy, dr, dk, dv, dw f32.
int rwkv6_wkv_bwd_f32(const void* r, const void* k, const void* v,
                      const void* w, const void* u, const void* dy, void* dr,
                      void* dk, void* dv, void* dw, void* du, void* scratch,
                      int64_t n_scratch, const int64_t* strides, int B, int H,
                      int S, int N, void* stream) {
  return launch<float, float>(r, k, v, w, u, dy, dr, dk, dv, dw, du, scratch,
                              n_scratch, strides, B, H, S, N,
                              static_cast<cudaStream_t>(stream));
}

// r, k, v, dy, dr, dk, dv bf16; w, dw f32 (the model's path).
int rwkv6_wkv_bwd_bf16(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* dy,
                       void* dr, void* dk, void* dv, void* dw, void* du,
                       void* scratch, int64_t n_scratch,
                       const int64_t* strides, int B, int H, int S, int N,
                       void* stream) {
  return launch<__nv_bfloat16, float>(r, k, v, w, u, dy, dr, dk, dv, dw, du,
                                      scratch, n_scratch, strides, B, H, S, N,
                                      static_cast<cudaStream_t>(stream));
}

// everything bf16 but u and du.
int rwkv6_wkv_bwd_bf16_wbf16(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* dy,
                             void* dr, void* dk, void* dv, void* dw,
                             void* du, void* scratch, int64_t n_scratch,
                             const int64_t* strides, int B, int H, int S,
                             int N, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(
      r, k, v, w, u, dy, dr, dk, dv, dw, du, scratch, n_scratch, strides, B,
      H, S, N, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
