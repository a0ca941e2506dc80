// Fused attention-modulated Chebyshev aggregation for sm_90a.
//
//   agg[b,k,j,m] = sum_i (T_k (.) softmax_i(S[b,k] + bias_k))[i,j] * x[b,i,m]
//
// S (B,K,N,N), bias = adj_pa (.) mask_k and T_k (K,N,N), x (B,N,M) with
// M = C*T; out (B,K,N,M); all float32, row-major, contiguous. The softmax
// runs down each column j, over the source axis i, which is taken whole, so
// any N works.
//
// Replaces the Pallas kernel `fused_sat_aggregate` / `_make_kernel` in
// dstagnn_drought_tpu/ops/pallas/cheb_sat.py. Its backward stays in tensor
// ops (ops/cuda/cheb_sat.py), as the JAX package keeps it in XLA einsums.
//
// Bound on an H100: 2*B*K*N^2*M flops against about
// 4*(B*K*N^2 + 2*K*N^2 + B*N*M + B*K*N*M) bytes, so at the main path's shapes
// (PEMS08 blocks 2-4: ~48 flop/byte; GAMBIA block 2: ~490 flop/byte) the op
// is bound by float32 FMA throughput on the CUDA cores, not by memory; only
// PEMS08 block 1 (M=12) is bound by bytes. The design therefore keeps the
// (B,K,N,N) operator out of device memory and spends its effort on the FMA
// loop:
//   pass 1 (colstats_kernel): one read of S and bias gives each column's max
//     and 1/sum(exp) over i — (B,K,N) floats each, in scratch;
//   pass 2 (aggregate_kernel): one block per (b*k, 64 targets j, 64 features
//     m). It streams 32-row source chunks: the modulated softmax tile
//     T_k * exp(S + bias - max) / sum is formed on the fly into shared
//     memory beside the matching x tile, and each thread accumulates a 4x4
//     output tile in float32 registers with FMAs (two 16-byte shared loads
//     per 16 FMAs). Ragged i, j and m edges are masked in the kernel; the
//     host pads nothing. M tiles are the fastest grid axis, so blocks that
//     re-read one S stripe run together and find it in L2.
// Precision: float32 throughout, expf (not __expf). Tensor cores (wgmma,
// TF32 or bf16 inputs) and a TMA pipeline are left for a later change.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTJ = 64;                    // target columns per block
constexpr int kTM = 64;                    // feature columns per block
constexpr int kTI = 32;                    // source rows per shared chunk
constexpr int kStatRows = kThreads / kTJ;  // row groups in the stats pass

__global__ void __launch_bounds__(kThreads)
colstats_kernel(const float* __restrict__ s, const float* __restrict__ bias,
                float* __restrict__ colmax, float* __restrict__ colinv,
                int K, int N) {
  const int bk = blockIdx.y;
  const int k = bk % K;
  const int jj = threadIdx.x % kTJ;
  const int ig = threadIdx.x / kTJ;
  const int j = blockIdx.x * kTJ + jj;
  const float* s_bk = s + (size_t)bk * N * N;
  const float* b_k = bias + (size_t)k * N * N;

  // online max / sum of exp over this thread's rows i = ig, ig + 4, ...
  float m = -INFINITY, l = 0.f;
  if (j < N) {
    for (int i = ig; i < N; i += kStatRows) {
      const size_t o = (size_t)i * N + j;
      const float v = s_bk[o] + b_k[o];
      if (v > m) {
        l = l * expf(m - v) + 1.f;
        m = v;
      } else {
        l += expf(v - m);
      }
    }
  }
  __shared__ float sm[kStatRows][kTJ];
  __shared__ float sl[kStatRows][kTJ];
  sm[ig][jj] = m;
  sl[ig][jj] = l;
  __syncthreads();
  if (ig == 0 && j < N) {
    float mx = sm[0][jj];
    for (int g = 1; g < kStatRows; ++g) mx = fmaxf(mx, sm[g][jj]);
    float sum = 0.f;
    for (int g = 0; g < kStatRows; ++g) {
      if (sl[g][jj] > 0.f) sum += sl[g][jj] * expf(sm[g][jj] - mx);
    }
    colmax[(size_t)bk * N + j] = mx;
    colinv[(size_t)bk * N + j] = 1.f / sum;
  }
}

__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const float* __restrict__ s, const float* __restrict__ bias,
                 const float* __restrict__ cheb, const float* __restrict__ x,
                 const float* __restrict__ colmax,
                 const float* __restrict__ colinv, float* __restrict__ out,
                 int K, int N, int M) {
  const int bk = blockIdx.z;
  const int b = bk / K;
  const int k = bk % K;
  const int j0 = blockIdx.y * kTJ;
  const int m0 = blockIdx.x * kTM;
  const int tx = threadIdx.x % 16;  // owns features m0 + 4*tx .. +3
  const int ty = threadIdx.x / 16;  // owns targets  j0 + 4*ty .. +3

  __shared__ __align__(16) float a_s[kTI][kTJ];
  __shared__ __align__(16) float x_s[kTI][kTM];
  __shared__ float cmax[kTJ];
  __shared__ float cinv[kTJ];
  if (threadIdx.x < kTJ) {
    const int j = j0 + threadIdx.x;
    cmax[threadIdx.x] = j < N ? colmax[(size_t)bk * N + j] : 0.f;
    cinv[threadIdx.x] = j < N ? colinv[(size_t)bk * N + j] : 0.f;
  }
  __syncthreads();

  const float* s_bk = s + (size_t)bk * N * N;
  const float* b_k = bias + (size_t)k * N * N;
  const float* t_k = cheb + (size_t)k * N * N;
  const float* x_b = x + (size_t)b * N * M;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int i0 = 0; i0 < N; i0 += kTI) {
    // modulated softmax tile A[i, j] for rows i0..i0+31, zero off the edge
    for (int e = threadIdx.x; e < kTI * kTJ; e += kThreads) {
      const int ii = e / kTJ, jj = e % kTJ;
      const int i = i0 + ii, j = j0 + jj;
      float a = 0.f;
      if (i < N && j < N) {
        const size_t o = (size_t)i * N + j;
        a = t_k[o] * (expf(s_bk[o] + b_k[o] - cmax[jj]) * cinv[jj]);
      }
      a_s[ii][jj] = a;
    }
    for (int e = threadIdx.x; e < kTI * kTM; e += kThreads) {
      const int ii = e / kTM, mm = e % kTM;
      const int i = i0 + ii, m = m0 + mm;
      x_s[ii][mm] = (i < N && m < M) ? x_b[(size_t)i * M + m] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int ii = 0; ii < kTI; ++ii) {
      const float4 a4 = *reinterpret_cast<const float4*>(&a_s[ii][4 * ty]);
      const float4 x4 = *reinterpret_cast<const float4*>(&x_s[ii][4 * tx]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], xv[c], acc[r][c]);
    }
    __syncthreads();
  }

  float* o_bk = out + (size_t)bk * N * M;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + 4 * ty + r;
    if (j >= N) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = m0 + 4 * tx + c;
      if (m < M) o_bk[(size_t)j * M + m] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" {

// Launches both passes on `stream`. colmax/colinv are (B,K,N) scratch.
// Returns cudaGetLastError() after the launches (0 on success).
int cheb_sat_forward(const float* s, const float* bias, const float* cheb,
                     const float* x, float* out, float* colmax, float* colinv,
                     int B, int K, int N, int M, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 stats_grid((N + kTJ - 1) / kTJ, B * K);
  colstats_kernel<<<stats_grid, kThreads, 0, st>>>(s, bias, colmax, colinv,
                                                   K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 agg_grid((M + kTM - 1) / kTM, (N + kTJ - 1) / kTJ, B * K);
  aggregate_kernel<<<agg_grid, kThreads, 0, st>>>(s, bias, cheb, x, colmax,
                                                  colinv, out, K, N, M);
  return static_cast<int>(cudaGetLastError());
}

const char* cheb_sat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
