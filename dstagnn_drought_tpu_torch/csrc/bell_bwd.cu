// Backward kernels of the fused BELL conv for sm_90a: K1 (dA and dTheta)
// and K2 (dx).
//
// With gm (B, Np, Co*T) the output cotangent times the ReLU mask and
// g_agg_h[n, c, t] = sum_o Theta[h, c, o] gm[n, o, t]:
//   K1  dA[b, a, h]  = x[src(a)] . round(g_agg_h[tgt(a)])^T       (BS x BS, float)
//       dTheta[h]    = sum_{b, a} (w[b, a, h]^T x[src(a)])^T . gm[tgt(a)]
//   K2  dx[i]        = sum_{a: src(a) = i} sum_h w[b, a, h] . g_agg_h[tgt(a)]
// round() is the cast to the compute dtype that the TPU kernel applies
// before its dA product; K2 keeps g_agg in float. Layouts as in
// bell_common.cuh; dA is (B, A, H, BS, BS) float, dx (B, NI*BS, C*T) in the
// compute dtype.
//
// Replaces the Pallas kernels of dstagnn_drought_tpu/ops/pallas/bell_bwd.py:
// K1 = `bell_bwd_dA_dtheta` (`_make_k1`) and `_bell_bwd_dA_dtheta_c`
// (`_make_k1_c`); K2 = `bell_bwd_dx` (`_make_k2`) and `_bell_bwd_dx_c`
// (`_make_k2_c`), in the port's one c-major layout.
//
// Bound on an H100 at GAMBIA block 2 (B=4, H=2, A=49, BS=128, M=C*T=4608,
// Co=32): K1 4*B*H*A*BS^2*M + 4*B*Np*H*M*Co ~ 129 GFLOP, K2
// 2*B*H*A*BS^2*M + 2*B*H*A*BS*M*Co ~ 74 GFLOP, against ~0.1-0.2 GB of x,
// gm, w, dA and dx: bound by operations. As in the forward, every product
// is a float32 FMA on the CUDA cores (tensor cores are a later change), with
// 128 x 64 sum tiles (8 x 4 per thread) fed from shared memory:
//   K1a (k1_dA_kernel): one block per (active entry, 64 target columns,
//     head, batch) sums over all C*T features in chunks of TT time steps;
//     each chunk recomputes g_agg for its 64 target rows from the staged gm
//     rows and Theta_h (so (B, H, Np, C*T) never reaches device memory).
//   K1b (k1_dtheta_kernel): one block per (group of time chunks, target
//     tile, batch and head) forms agg = sum_u w_u^T x_u for a chunk (the
//     forward product) and contracts it with the staged gm rows into a
//     (C, Co) partial in shared memory.
//   K1c (k1_reduce_kernel): sums the partials of each dTheta entry in a
//     fixed order. The TPU kernel summed dTheta in one resident block over a
//     sequential grid; CUDA blocks run concurrently, and float atomics would
//     make the result depend on their order, so two runs here give the same
//     bits.
//   K2 (k2_kernel): one block per (time chunk, source tile, batch) walks the
//     source-sorted list (src_order, src_start, src_count) over the tile's
//     outgoing entries and heads, recomputing g_agg for 32 target rows at a
//     time; every block owns its dx tile, so there is no scatter.

#include "bell_common.cuh"

namespace {

using namespace bell;

template <typename T>
__global__ void __launch_bounds__(kThreads)
k1_dA_kernel(const int* __restrict__ active_src, const int* __restrict__ active_tgt,
             const float* __restrict__ thetas, const T* __restrict__ gm,
             const T* __restrict__ x, float* __restrict__ dA, int A, int H, int NJ,
             int BS, int C, int T_len, int Co, int TT) {
  const int n_sub = (BS + kCols - 1) / kCols;
  const int a = blockIdx.x / n_sub;
  const int tc = (blockIdx.x % n_sub) * kCols;  // first target column
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t Np = (size_t)NJ * BS;
  const size_t M = (size_t)C * T_len, MO = (size_t)Co * T_len;
  const int W = C * TT, WO = Co * TT;
  const int ldg = WO | 1;
  extern __shared__ __align__(16) float smem[];
  float* xT_s = smem;                     // [kCols][kLdRows]: feature x source row
  float* gT_s = xT_s + kCols * kLdRows;   // [kCols][kCols]: feature x target
  float* gm_s = gT_s + kCols * kCols;     // [kCols][ldg]: target x (o, step)
  float* th_s = gm_s + kCols * ldg;       // [C][Co] of head h
  for (int e = threadIdx.x; e < C * Co; e += kThreads) th_s[e] = thetas[h * C * Co + e];
  const size_t src_row0 = b * Np + (size_t)active_src[a] * BS;
  const size_t tgt_row0 = b * Np + (size_t)active_tgt[a] * BS + tc;
  float acc[8][4];
  zero(acc);
  for (int t0 = 0; t0 < T_len; t0 += TT) {
    __syncthreads();
    for (int e = threadIdx.x; e < kRows * W; e += kThreads) {
      const int r = e / W, mc = e % W;
      const int c = mc / TT, tt = mc % TT;
      float v = 0.f;
      if (r < BS && t0 + tt < T_len)
        v = to_f(x[(src_row0 + r) * M + (size_t)c * T_len + t0 + tt]);
      xT_s[mc * kLdRows + r] = v;
    }
    for (int e = threadIdx.x; e < kCols * WO; e += kThreads) {
      const int t = e / WO, rem = e % WO;
      const int o = rem / TT, tt = rem % TT;
      float v = 0.f;
      if (tc + t < BS && t0 + tt < T_len)
        v = to_f(gm[(tgt_row0 + t) * MO + (size_t)o * T_len + t0 + tt]);
      gm_s[t * ldg + rem] = v;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < W * kCols; e += kThreads) {
      const int mc = e / kCols, t = e % kCols;
      const int c = mc / TT, tt = mc % TT;
      float s = 0.f;
      for (int o = 0; o < Co; ++o) s = fmaf(th_s[c * Co + o], gm_s[t * ldg + o * TT + tt], s);
      gT_s[mc * kCols + t] = round_to<T>(s);
    }
    __syncthreads();
    tile_fma(acc, xT_s, kLdRows, gT_s, kCols, W);
  }
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float* dA_t = dA + (((size_t)b * A + a) * H + h) * BS * BS;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = ty * 8 + r;
    if (row >= BS) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = tc + tx * 4 + c;
      if (col < BS) dA_t[(size_t)row * BS + col] = acc[r][c];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
k1_dtheta_kernel(const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                 const int* __restrict__ active_src, const T* __restrict__ gm,
                 const T* __restrict__ x, const T* __restrict__ w,
                 float* __restrict__ partial, int A, int H, int NJ, int BS, int C,
                 int T_len, int Co, int TT, int G) {
  const int g = blockIdx.x, j = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const size_t Np = (size_t)NJ * BS;
  const size_t M = (size_t)C * T_len, MO = (size_t)Co * T_len;
  const int W = C * TT, WO = Co * TT;
  const int ldg = WO | 1;
  constexpr int kLdAgg = kCols + 1;
  const int n_chunks = (T_len + TT - 1) / TT;
  const int per = (n_chunks + G - 1) / G;
  const int chunk_end = min(n_chunks, (g + 1) * per);
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                      // [kK][kRows]: source row x target
  float* x_s = w_s + kK * kRows;          // [kK][kCols]: source row x feature
  float* agg_s = x_s + kK * kCols;        // [kRows][kLdAgg]: target x feature
  float* gm_s = agg_s + kRows * kLdAgg;   // [kK][ldg]: target x (o, step)
  float* dth_s = gm_s + kK * ldg;         // [C][Co] partial
  for (int e = threadIdx.x; e < C * Co; e += kThreads) dth_s[e] = 0.f;
  const int start = tile_start[j], count = tile_count[j];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][4];
  for (int chunk = g * per; chunk < chunk_end; ++chunk) {
    const int t0 = chunk * TT;
    zero(acc);
    for (int u = 0; u < count; ++u) {
      const int a = start + u;
      const size_t src_row0 = b * Np + (size_t)active_src[a] * BS;
      const T* w_t = w + (((size_t)b * A + a) * H + h) * BS * BS;
      for (int r0 = 0; r0 < BS; r0 += kK) {
        __syncthreads();
        for (int e = threadIdx.x; e < kK * kRows; e += kThreads) {
          const int kk = e / kRows, t = e % kRows;
          w_s[e] = (r0 + kk < BS && t < BS) ? to_f(w_t[(size_t)(r0 + kk) * BS + t]) : 0.f;
        }
        for (int e = threadIdx.x; e < kK * kCols; e += kThreads) {
          const int kk = e / kCols, mc = e % kCols;
          const int c = mc / TT, tt = mc % TT;
          float v = 0.f;
          if (mc < W && t0 + tt < T_len && r0 + kk < BS)
            v = to_f(x[(src_row0 + r0 + kk) * M + (size_t)c * T_len + t0 + tt]);
          x_s[e] = v;
        }
        __syncthreads();
        tile_fma(acc, w_s, kRows, x_s, kCols, min(kK, BS - r0));
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) agg_s[(ty * 8 + r) * kLdAgg + tx * 4 + c] = acc[r][c];
    // dTheta[c, o] += sum over target rows and steps of agg * gm, 32 rows at a time
    for (int t1 = 0; t1 < BS; t1 += kK) {
      __syncthreads();
      for (int e = threadIdx.x; e < kK * WO; e += kThreads) {
        const int tr = e / WO, rem = e % WO;
        const int o = rem / TT, tt = rem % TT;
        float v = 0.f;
        if (t1 + tr < BS && t0 + tt < T_len)
          v = to_f(gm[(b * Np + (size_t)j * BS + t1 + tr) * MO + (size_t)o * T_len + t0 + tt]);
        gm_s[tr * ldg + rem] = v;
      }
      __syncthreads();
      const int nr = min(kK, BS - t1);
      for (int e = threadIdx.x; e < C * Co; e += kThreads) {
        const int c = e / Co, o = e % Co;
        float s = 0.f;
        for (int tr = 0; tr < nr; ++tr)
          for (int tt = 0; tt < TT; ++tt)
            s = fmaf(agg_s[(t1 + tr) * kLdAgg + c * TT + tt], gm_s[tr * ldg + o * TT + tt], s);
        dth_s[e] += s;
      }
    }
    __syncthreads();
  }
  float* out = partial + ((size_t)bh * NJ + j) * G * C * Co + (size_t)g * C * Co;
  for (int e = threadIdx.x; e < C * Co; e += kThreads) out[e] = dth_s[e];
}

// dTheta[h, c, o] = sum over (b, j, g) of the partials, in that fixed order.
__global__ void k1_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dth,
                                 int B, int H, int NJ, int G, int CCo) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= H * CCo) return;
  const int h = e / CCo, r = e % CCo;
  float s = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* p = partial + (size_t)(b * H + h) * NJ * G * CCo + r;
    for (int jg = 0; jg < NJ * G; ++jg) s += p[(size_t)jg * CCo];
  }
  dth[e] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
k2_kernel(const int* __restrict__ src_start, const int* __restrict__ src_count,
          const int* __restrict__ src_order, const int* __restrict__ active_tgt,
          const float* __restrict__ thetas, const T* __restrict__ gm,
          const T* __restrict__ w, T* __restrict__ dx, int A, int H, int NI, int NJ,
          int BS, int C, int T_len, int Co, int TT) {
  const int t0 = blockIdx.x * TT;
  const int i = blockIdx.y, b = blockIdx.z;
  const size_t M = (size_t)C * T_len, MO = (size_t)Co * T_len;
  const int W = C * TT, WO = Co * TT;
  const int ldg = WO | 1;
  extern __shared__ __align__(16) float smem[];
  float* wT_s = smem;                     // [kK][kLdRows]: target x source row
  float* g_s = wT_s + kK * kLdRows;       // [kK][kCols]: target x feature
  float* gm_s = g_s + kK * kCols;         // [kK][ldg]: target x (o, step)
  float* thT_s = gm_s + kK * ldg;         // [H][Co][C]
  for (int e = threadIdx.x; e < H * C * Co; e += kThreads) {
    const int h = e / (C * Co), c = (e / Co) % C, o = e % Co;
    thT_s[(h * Co + o) * C + c] = thetas[e];
  }
  float acc[8][4];
  zero(acc);
  const int p0 = src_start[i], n_out = src_count[i];
  for (int p = p0; p < p0 + n_out; ++p) {
    const int a = src_order[p];
    const size_t tgt_row0 = (size_t)b * NJ * BS + (size_t)active_tgt[a] * BS;
    for (int h = 0; h < H; ++h) {
      const T* w_t = w + (((size_t)b * A + a) * H + h) * BS * BS;
      for (int t1 = 0; t1 < BS; t1 += kK) {
        __syncthreads();
        for (int e = threadIdx.x; e < kRows * kK; e += kThreads) {
          const int r = e / kK, kk = e % kK;
          wT_s[kk * kLdRows + r] =
              (r < BS && t1 + kk < BS) ? to_f(w_t[(size_t)r * BS + t1 + kk]) : 0.f;
        }
        for (int e = threadIdx.x; e < kK * WO; e += kThreads) {
          const int tr = e / WO, rem = e % WO;
          const int o = rem / TT, tt = rem % TT;
          float v = 0.f;
          if (t1 + tr < BS && t0 + tt < T_len)
            v = to_f(gm[(tgt_row0 + t1 + tr) * MO + (size_t)o * T_len + t0 + tt]);
          gm_s[tr * ldg + rem] = v;
        }
        __syncthreads();
        for (int e = threadIdx.x; e < kK * kCols; e += kThreads) {
          const int kk = e / kCols, mc = e % kCols;
          float v = 0.f;
          if (mc < W) {
            const int c = mc / TT, tt = mc % TT;
            const float* th = thT_s + h * Co * C + c;
            for (int o = 0; o < Co; ++o) v = fmaf(th[o * C], gm_s[kk * ldg + o * TT + tt], v);
          }
          g_s[e] = v;
        }
        __syncthreads();
        tile_fma(acc, wT_s, kLdRows, g_s, kCols, min(kK, BS - t1));
      }
    }
  }
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t row0 = (size_t)b * NI * BS + (size_t)i * BS;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = ty * 8 + r;
    if (row >= BS) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int mc = tx * 4 + c;
      const int t = t0 + mc % TT;
      if (mc < W && t < T_len)
        dx[(row0 + row) * M + (size_t)(mc / TT) * T_len + t] = from_f<T>(acc[r][c]);
    }
  }
}

template <typename T>
int launch_k1(const int* active_src, const int* active_tgt, const int* tile_start,
              const int* tile_count, const float* thetas, const void* gm, const void* x,
              const void* w, float* dA, float* partial, float* dth, int B, int A, int H,
              int NJ, int BS, int C, int T_len, int Co, int TTa, int TTc, int G,
              cudaStream_t st) {
  const size_t smem_a = sizeof(float) * (kCols * kLdRows + kCols * kCols +
                                         kCols * ((Co * TTa) | 1) + C * Co);
  cudaError_t err = allow_smem(k1_dA_kernel<T>, smem_a);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_sub = (BS + kCols - 1) / kCols;
  k1_dA_kernel<T><<<dim3(A * n_sub, H, B), kThreads, smem_a, st>>>(
      active_src, active_tgt, thetas, static_cast<const T*>(gm), static_cast<const T*>(x),
      dA, A, H, NJ, BS, C, T_len, Co, TTa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem_b = sizeof(float) * (kK * kRows + kK * kCols + kRows * (kCols + 1) +
                                         kK * ((Co * TTc) | 1) + C * Co);
  err = allow_smem(k1_dtheta_kernel<T>, smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  k1_dtheta_kernel<T><<<dim3(G, NJ, B * H), kThreads, smem_b, st>>>(
      tile_start, tile_count, active_src, static_cast<const T*>(gm),
      static_cast<const T*>(x), static_cast<const T*>(w), partial, A, H, NJ, BS, C, T_len,
      Co, TTc, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = H * C * Co;
  k1_reduce_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(partial, dth, B, H,
                                                                      NJ, G, C * Co);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k2(const int* src_start, const int* src_count, const int* src_order,
              const int* active_tgt, const float* thetas, const void* gm, const void* w,
              void* dx, int B, int A, int H, int NI, int NJ, int BS, int C, int T_len,
              int Co, int TT, cudaStream_t st) {
  const int ldg = (Co * TT) | 1;
  const size_t smem = sizeof(float) * (kK * kLdRows + kK * kCols + kK * ldg + H * C * Co);
  cudaError_t err = allow_smem(k2_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k2_kernel<T><<<dim3((T_len + TT - 1) / TT, NI, B), kThreads, smem, st>>>(
      src_start, src_count, src_order, active_tgt, thetas, static_cast<const T*>(gm),
      static_cast<const T*>(w), static_cast<T*>(dx), A, H, NI, NJ, BS, C, T_len, Co, TT);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1 on `stream`: dA (B, A, H, BS, BS), dTheta (H, C, Co); partial is
// (B*H*NJ*G, C*Co) float scratch. The dA pass covers TTa time steps a chunk
// (its staged gm rows hold Co*TTa columns), the dTheta pass TTc (C*TTc <=
// 64 columns of sums). Returns cudaGetLastError() (0 = success).
int bell_bwd_k1(const int* active_src, const int* active_tgt, const int* tile_start,
                const int* tile_count, const float* thetas, const void* gm, const void* x,
                const void* w, float* dA, float* partial, float* dth, int B, int A, int H,
                int NJ, int BS, int C, int T_len, int Co, int TTa, int TTc, int G,
                int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_k1<__nv_bfloat16>(active_src, active_tgt, tile_start, tile_count, thetas,
                                    gm, x, w, dA, partial, dth, B, A, H, NJ, BS, C, T_len,
                                    Co, TTa, TTc, G, st);
  return launch_k1<float>(active_src, active_tgt, tile_start, tile_count, thetas, gm, x, w,
                          dA, partial, dth, B, A, H, NJ, BS, C, T_len, Co, TTa, TTc, G,
                          st);
}

// K2 on `stream`: dx (B, NI*BS, C*T) in the compute dtype.
int bell_bwd_k2(const int* src_start, const int* src_count, const int* src_order,
                const int* active_tgt, const float* thetas, const void* gm, const void* w,
                void* dx, int B, int A, int H, int NI, int NJ, int BS, int C, int T_len,
                int Co, int TT, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_k2<__nv_bfloat16>(src_start, src_count, src_order, active_tgt, thetas, gm,
                                    w, dx, B, A, H, NI, NJ, BS, C, T_len, Co, TT, st);
  return launch_k2<float>(src_start, src_count, src_order, active_tgt, thetas, gm, w, dx,
                          B, A, H, NI, NJ, BS, C, T_len, Co, TT, st);
}

const char* bell_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
