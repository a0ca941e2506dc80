// Fused block-sparse (BELL) attention-modulated Chebyshev conv, forward,
// for sm_90a.
//
// For every batch b, target tile j and head h, over the active slots u of
// tile j (source tile s_u):
//   scores_u = Q[s_u] K[j]^T * scale + bias_u      (bias = -1e30 off-pattern)
//   w_u      = T_k,u (.) softmax over (u, source row) per target column,
//              rounded to the compute dtype
//   out[j]   = relu(sum_h (sum_u w_u^T X[s_u]) Theta_h)
// q, k (B, Np, H, dk), bias and cheb tiles (A, H, BS, BS), Theta (H, C, Co)
// are float; x (B, Np, C*T), out (B, Np, Co*T) and the scratch w
// (B, A, H, BS, BS) are in the compute dtype (float or bf16). BS <= 128.
//
// Replaces the Pallas kernels of dstagnn_drought_tpu/ops/pallas/
// bell_fused.py: `bell_fused_forward` (`_make_kernel_single`,
// `_make_kernel_chunked`, t-major) and `_bell_fused_forward_c`
// (`_make_kernel_single_c`, `_make_kernel_chunked_c`, c-major), in the one
// c-major layout of the port. Any number of slots per tile runs through one
// loop (the TPU split into single and chunked kernels for VMEM).
//
// Bound on an H100: 2*B*H*A*BS^2*(dk + C*T) + 2*B*Np*H*C*T*Co flops against
// the bytes of x, the output and the tiles. At the main path's GAMBIA shape
// (block 2: B=4, H=2, A=49, BS=128, dk=32, M=C*T=4608, Co=32) that is ~65 GFLOP
// over ~0.1 GB: bound by operations (about 0.07 ms at the bf16 tensor-core
// peak, 1 ms at the float32 CUDA-core peak). This first design runs every
// product as float32 FMAs on the CUDA cores; tensor cores (wgmma) and a TMA
// pipeline are left for a later change. Two passes:
//   pass 1 (weights_kernel): one block per (j, h, b) computes each target
//     column's max and sum of exp over every slot (online), then recomputes
//     the scores and writes w = T_k (.) exp(s - max) / sum in the compute
//     dtype into the scratch (the softmax needs the whole neighbourhood
//     before any weight is final);
//   pass 2 (spmm_kernel): one block per (time chunk, j, b) covers TT time
//     steps with every channel (C*TT <= 64), so the Theta mix closes in the
//     block: per head, 128 targets x C*TT features are summed over all
//     slots' source rows (32-row chunks of w and x staged in shared memory,
//     8 x 4 float sums per thread) and kept in shared memory; the epilogue
//     mixes the heads by Theta into Co*TT outputs per target and writes the
//     ReLU'd result once. The (B, H, Np, C*T) aggregation never reaches
//     device memory.
// Ragged edges (BS < 128, T not a multiple of TT) are masked in the kernel.

#include "bell_common.cuh"

namespace {

using namespace bell;

constexpr int kQRows = 32;                // source rows of q staged per chunk
constexpr int kGroups = kThreads / kRows;  // row groups of the weights pass

template <typename T>
__global__ void __launch_bounds__(kThreads)
weights_kernel(const int* __restrict__ tile_start, const int* __restrict__ tile_count,
               const int* __restrict__ active_src, const float* __restrict__ q,
               const float* __restrict__ k, const float* __restrict__ bias,
               const float* __restrict__ cheb, T* __restrict__ w, int A, int H,
               int NJ, int BS, int dk, float scale) {
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t Np = (size_t)NJ * BS;
  const int col = threadIdx.x % kRows;  // target column owned by this thread
  const int grp = threadIdx.x / kRows;  // which source rows it scores
  const int ldk = dk | 1;               // odd stride: column reads hit distinct banks
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                    // [kRows][ldk]
  float* q_s = k_s + kRows * ldk;       // [kQRows][dk]
  float* red_m = q_s + kQRows * dk;     // [kGroups][kRows]
  float* red_l = red_m + kGroups * kRows;

  for (int e = threadIdx.x; e < BS * dk; e += kThreads) {
    const int t = e / dk, d = e % dk;
    k_s[t * ldk + d] = k[((b * Np + (size_t)j * BS + t) * H + h) * dk + d];
  }
  const int start = tile_start[j], count = tile_count[j];
  const bool live = col < BS;
  float m = -INFINITY, l = 0.f;  // online max and sum of exp (pass 0)
  float mx = 0.f, inv = 0.f;     // final max and 1/sum (pass 1)
  for (int pass = 0; pass < 2; ++pass) {
    for (int u = 0; u < count; ++u) {
      const int a = start + u;
      const size_t src_row0 = b * Np + (size_t)active_src[a] * BS;
      const size_t tile = ((size_t)a * H + h) * BS * BS;
      T* w_t = w + (((size_t)b * A + a) * H + h) * BS * BS;
      for (int r0 = 0; r0 < BS; r0 += kQRows) {
        const int nr = min(kQRows, BS - r0);
        __syncthreads();
        for (int e = threadIdx.x; e < nr * dk; e += kThreads) {
          const int r = e / dk, d = e % dk;
          q_s[e] = q[((src_row0 + r0 + r) * H + h) * dk + d];
        }
        __syncthreads();
        if (!live) continue;
        for (int r = grp; r < nr; r += kGroups) {
          float s = 0.f;
          for (int d = 0; d < dk; ++d) s = fmaf(q_s[r * dk + d], k_s[col * ldk + d], s);
          const size_t o = (size_t)(r0 + r) * BS + col;
          s = s * scale + bias[tile + o];
          if (pass == 0) {
            if (s > m) {
              l = l * expf(m - s) + 1.f;
              m = s;
            } else {
              l += expf(s - m);
            }
          } else {
            w_t[o] = from_f<T>(cheb[tile + o] * (expf(s - mx) * inv));
          }
        }
      }
    }
    if (pass == 0) {
      red_m[grp * kRows + col] = m;
      red_l[grp * kRows + col] = l;
      __syncthreads();
      if (live) {
        mx = red_m[col];
        for (int g = 1; g < kGroups; ++g) mx = fmaxf(mx, red_m[g * kRows + col]);
        float sum = 0.f;
        for (int g = 0; g < kGroups; ++g) {
          const float lg = red_l[g * kRows + col];
          if (lg > 0.f) sum += lg * expf(red_m[g * kRows + col] - mx);
        }
        inv = 1.f / fmaxf(sum, 1e-30f);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spmm_kernel(const int* __restrict__ tile_start, const int* __restrict__ tile_count,
            const int* __restrict__ active_src, const T* __restrict__ w,
            const T* __restrict__ x, const float* __restrict__ thetas,
            T* __restrict__ out, int A, int H, int NJ, int BS, int C, int T_len,
            int Co, int TT) {
  const int t0 = blockIdx.x * TT;
  const int j = blockIdx.y, b = blockIdx.z;
  const size_t Np = (size_t)NJ * BS;
  const size_t M = (size_t)C * T_len, MO = (size_t)Co * T_len;
  const int W = C * TT, WO = Co * TT;
  constexpr int kLdAgg = kCols + 1;
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                      // [kK][kRows]: source row x target
  float* x_s = w_s + kK * kRows;          // [kK][kCols]: source row x feature
  float* th_s = x_s + kK * kCols;         // [H][C][Co]
  float* agg_s = th_s + H * C * Co;       // [H][kRows][kLdAgg]: target x feature
  for (int e = threadIdx.x; e < H * C * Co; e += kThreads) th_s[e] = thetas[e];
  const int start = tile_start[j], count = tile_count[j];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][4];
  for (int h = 0; h < H; ++h) {
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
    // head h's aggregation stays in shared memory for the epilogue
    float* agg_h = agg_s + h * kRows * kLdAgg;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) agg_h[(ty * 8 + r) * kLdAgg + tx * 4 + c] = acc[r][c];
  }
  __syncthreads();
  // epilogue: out = relu(sum_h agg_h Theta_h), each element written once
  for (int e = threadIdx.x; e < kRows * WO; e += kThreads) {
    const int t = e / WO, rem = e % WO;
    const int o = rem / TT, tt = rem % TT;
    if (t >= BS || t0 + tt >= T_len) continue;
    float s = 0.f;
    for (int h = 0; h < H; ++h) {
      const float* agg_t = agg_s + (h * kRows + t) * kLdAgg + tt;
      const float* th = th_s + h * C * Co + o;
      float mix = 0.f;
      for (int c = 0; c < C; ++c) mix = fmaf(agg_t[c * TT], th[c * Co], mix);
      s += mix;
    }
    out[(b * Np + (size_t)j * BS + t) * MO + (size_t)o * T_len + t0 + tt] =
        from_f<T>(fmaxf(s, 0.f));
  }
}

template <typename T>
int launch(const int* tile_start, const int* tile_count, const int* active_src,
           const float* q, const float* k, const float* bias, const float* cheb, void* w,
           const void* x, const float* thetas, void* out, int B, int A, int H, int NJ,
           int BS, int dk, int C, int T_len, int Co, int TT, float scale,
           cudaStream_t st) {
  const size_t smem1 = sizeof(float) * (kRows * (dk | 1) + kQRows * dk + 2 * kGroups * kRows);
  cudaError_t err = allow_smem(weights_kernel<T>, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  weights_kernel<T><<<dim3(NJ, H, B), kThreads, smem1, st>>>(
      tile_start, tile_count, active_src, q, k, bias, cheb, static_cast<T*>(w), A, H, NJ,
      BS, dk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem2 =
      sizeof(float) * (kK * kRows + kK * kCols + H * C * Co + H * kRows * (kCols + 1));
  err = allow_smem(spmm_kernel<T>, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  spmm_kernel<T><<<dim3((T_len + TT - 1) / TT, NJ, B), kThreads, smem2, st>>>(
      tile_start, tile_count, active_src, static_cast<const T*>(w),
      static_cast<const T*>(x), thetas, static_cast<T*>(out), A, H, NJ, BS, C, T_len, Co,
      TT);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches both passes on `stream`; w is (B, A, H, BS, BS) scratch in the
// compute dtype. Returns cudaGetLastError() after the launches (0 = success).
int bell_fused_forward(const int* tile_start, const int* tile_count, const int* active_src,
                       const float* q, const float* k, const float* bias, const float* cheb,
                       void* w, const void* x, const float* thetas, void* out, int B, int A,
                       int H, int NJ, int BS, int dk, int C, int T_len, int Co, int TT,
                       float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(tile_start, tile_count, active_src, q, k, bias, cheb, w, x,
                                 thetas, out, B, A, H, NJ, BS, dk, C, T_len, Co, TT, scale,
                                 st);
  return launch<float>(tile_start, tile_count, active_src, q, k, bias, cheb, w, x, thetas,
                       out, B, A, H, NJ, BS, dk, C, T_len, Co, TT, scale, st);
}

const char* bell_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
