// Fused spatial middle of a dense DSTAGNN block (forward and backward) for
// sm_90a.
//
// Replaces the Pallas kernels of
// dstagnn_drought_tpu/ops/pallas/block_spatial_fused.py: `_fwd_impl`
// (`_fwd_kernel`) and `_vjp_bwd` (`_bwd_kernel`). Per batch row b, with
// tat (B, N, FT), xm (B, N, C*T), pw (FT, d), wqk (d, 2*K*dk), bias and
// cheb (K, N, N), theta (K, C, Co), all float32, row-major, contiguous:
//
//   x_tat = tat . pw + pb                       (N, d)
//   semx  = md((LN(x_tat + pos)*gs + bs) * dmask / keep)
//   qk    = semx . wqk                          (N, 2*K*dk)
//   for k: s_k   = md(q_k) md(k_k)^T / sqrt(dk) + bias_k      (N_i, N_j)
//          att_k = softmax over the SOURCE axis i, per target column j
//          A_k   = md(cheb_k * att_k)
//          agg_k = A_k^T . xm                   (N_j, C*T)
//          out  += md(agg_k) . theta_k          (per time step)
//   y = relu(out)
//
// md() is the TPU kernel's cast to the matmul dtype (the dtype of tat):
// with bf16 set every such operand is rounded to bfloat16, and the sums
// stay float32, as on the TPU. The TPU applies theta as kron(theta_k, I_T)
// to keep the mix a 2-D MXU product (12x the mix's flops at T=12); this
// kernel mixes per time step and returns dtheta (K, C, Co) directly.
//
// Bound on an H100: at PEMS08 blocks 2-4 (N=170, d=512, FT=CT=CoT=384,
// K=3, dk=32) a row needs ~185 MFLOP against ~1.3 MB, so operations bound
// it. The TPU kernel held a row's whole pipeline in VMEM; here one row's
// three (N, N) planes (347 KB) or its N x d embedding (348 KB) alone exceed
// the 227 KB a block may have, so the work is split across passes:
//   forward  SA (b, 16 source rows): pre_conv, LN, dropout, QK -> qk (B,N,2Kdk)
//            SB (b, 16 target columns): for each k, the column's scores over
//               all N sources, the source-axis softmax, A_k, agg_k (16 x C*T
//               sums in registers) and the theta mix into a shared 16 x Co*T
//               tile; ReLU on the way out. (B, K, N, N) never reaches memory.
//   backward SA again (saving semx, x_hat, 1/std); SB recomputes the
//               pre-ReLU tile for the mask, then per k: dtheta partial, dagg,
//               dA (a warp per source row), the softmax backward -> ds, dk;
//            SC (b, 16 source rows): dxm += A_k . dagg_k and dq_k from ds;
//            SD (b, 16 rows): dsemx, dropout and LN backward, dtat;
//            then the weight gradients, summed over b in a fixed order:
//               dpw = tat^T dse, dwqk = semx^T dqk (split-row products),
//               dbias, dtheta, dpos, dpb, dgs, dbs (row sums). No float
//               atomics: two launches give the same bits.
// Tensor cores (wgmma on the bf16 operands) and TMA are left for a later
// change.

#include "dense_common.cuh"

namespace {

using dense::kThreads;
using dense::kWarps;
using dense::rnd;

constexpr int kRows = 16;  // source rows a block (SA, SC, SD)
constexpr int kCols = 16;  // target columns a block (SB)

// n rounded up to a multiple of 4 floats (16-byte aligned shared buffers)
__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

struct Dims {
  int B, N, FT, CT, T, C, Co, CoT, d, K, dk, hk, HK2, bf16;
  float keep_inv, inv_sqrt;
};

// ---------------------------------------------------------------------------
// SA: pre_conv -> +pos, LN -> dropout -> QK for 16 source rows of batch b
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sp_embed_kernel(const float* __restrict__ tat, const float* __restrict__ pw,
                const float* __restrict__ pb, const float* __restrict__ pos,
                const float* __restrict__ gs, const float* __restrict__ bs,
                const float* __restrict__ wqk, const float* __restrict__ dmask,
                float* __restrict__ qk, float* __restrict__ semx_out,
                float* __restrict__ xhat_out, float* __restrict__ inv_out, Dims D) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.y, i0 = blockIdx.x * kRows;
  const int R = min(kRows, D.N - i0);
  float* tt = sm;                  // (R, FT)
  float* xs = tt + kRows * D.FT;   // (R, d)
  const size_t row0 = (size_t)b * D.N + i0;
  for (int e = threadIdx.x; e < R * D.FT; e += kThreads)
    tt[e] = rnd(tat[row0 * D.FT + e], D.bf16);
  __syncthreads();
  dense::rows_x_mat<16>(tt, D.FT, R, D.FT, pw, D.d, D.d, xs, D.d);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int ii = warp; ii < R; ii += kWarps) {
    const size_t row = row0 + ii;
    float* z = xs + ii * D.d;
    const float* p = pos + (size_t)(i0 + ii) * D.d;
    for (int e = lane; e < D.d; e += 32) z[e] = z[e] + pb[e] + p[e];
    __syncwarp();
    float mu, inv;
    dense::ln_stats(z, D.d, mu, inv);
    for (int e = lane; e < D.d; e += 32) {
      const float h = (z[e] - mu) * inv;
      const float m = dmask ? dmask[row * D.d + e] : 1.f;
      const float s = rnd((h * gs[e] + bs[e]) * m * D.keep_inv, D.bf16);
      z[e] = s;
      if (xhat_out) {
        xhat_out[row * D.d + e] = h;
        semx_out[row * D.d + e] = s;
      }
    }
    if (inv_out && lane == 0) inv_out[row] = inv;
  }
  __syncthreads();
  dense::rows_x_mat<16>(xs, D.d, R, D.d, wqk, D.HK2, D.HK2, qk + row0 * D.HK2, D.HK2);
}

// ---------------------------------------------------------------------------
// SB helpers: one block owns target columns j0 .. j0+nj-1 of batch b
// ---------------------------------------------------------------------------

// s = md(q_i) . md(k_j) / sqrt(dk) + bias, the same FMA order in SB and SC
__device__ __forceinline__ float score(const float* __restrict__ qrow, const float* krow,
                                       float bias, const Dims& D) {
  float dot = 0.f;
  for (int c = 0; c < D.dk; ++c) dot = fmaf(rnd(qrow[c], D.bf16), krow[c], dot);
  return dot * D.inv_sqrt + bias;
}

// att (N, 16) = source-axis softmax of the tile's scores for order k, and
// A = md(cheb * att); zero past the ragged edge. stats (B,K,N,2) gets each
// column's max and sum of exp when given.
__device__ void col_softmax(int b, int k, int j0, int nj, const float* __restrict__ qk,
                            const float* __restrict__ bias, const float* __restrict__ cheb,
                            float* kt, float* att, float* A, float* __restrict__ stats,
                            const Dims& D) {
  const int N = D.N;
  for (int e = threadIdx.x; e < kCols * D.dk; e += kThreads) {
    const int jj = e / D.dk, c = e % D.dk;
    kt[e] = jj < nj ? rnd(qk[((size_t)b * N + j0 + jj) * D.HK2 + D.hk + k * D.dk + c], D.bf16)
                    : 0.f;
  }
  __syncthreads();
  const float* bias_k = bias + (size_t)k * N * N;
  for (int e = threadIdx.x; e < N * kCols; e += kThreads) {
    const int i = e / kCols, jj = e % kCols;
    float s = 0.f;
    if (jj < nj)
      s = score(qk + ((size_t)b * N + i) * D.HK2 + k * D.dk, kt + jj * D.dk,
                bias_k[(size_t)i * N + j0 + jj], D);
    att[e] = s;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* cheb_k = cheb + (size_t)k * N * N;
  for (int jj = warp; jj < kCols; jj += kWarps) {
    if (jj >= nj) {
      for (int i = lane; i < N; i += 32) att[i * kCols + jj] = A[i * kCols + jj] = 0.f;
      continue;
    }
    float m = -INFINITY;
    for (int i = lane; i < N; i += 32) m = fmaxf(m, att[i * kCols + jj]);
    m = dense::warp_max(m);
    float sum = 0.f;
    for (int i = lane; i < N; i += 32) sum += expf(att[i * kCols + jj] - m);
    sum = dense::warp_sum(sum);
    for (int i = lane; i < N; i += 32) {
      const float a = expf(att[i * kCols + jj] - m) / sum;
      att[i * kCols + jj] = a;
      A[i * kCols + jj] = rnd(cheb_k[(size_t)i * N + j0 + jj] * a, D.bf16);
    }
    if (stats && lane == 0) {
      float* st = stats + (((size_t)b * D.K + k) * N + j0 + jj) * 2;
      st[0] = m;
      st[1] = sum;
    }
  }
  __syncthreads();
}

// agg (16, CT) = A^T . md(xm[b]) over all N sources
__device__ void aggregate(int b, const float* A, const float* __restrict__ xm, float* agg,
                          const Dims& D) {
  const float* xb = xm + (size_t)b * D.N * D.CT;
  for (int m = threadIdx.x; m < D.CT; m += kThreads) {
    float acc[kCols];
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) acc[jj] = 0.f;
#pragma unroll 4
    for (int i = 0; i < D.N; ++i) {
      const float xv = rnd(__ldg(xb + (size_t)i * D.CT + m), D.bf16);
      const float4* a4 = reinterpret_cast<const float4*>(A + i * kCols);
#pragma unroll
      for (int q = 0; q < kCols / 4; ++q) {
        const float4 v = a4[q];
        acc[4 * q] = fmaf(v.x, xv, acc[4 * q]);
        acc[4 * q + 1] = fmaf(v.y, xv, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v.z, xv, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v.w, xv, acc[4 * q + 3]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) agg[jj * D.CT + m] = acc[jj];
  }
  __syncthreads();
}

// out (16, Co*T) += md(agg) . theta_k, per time step
__device__ void theta_mix(int k, int nj, const float* agg, const float* __restrict__ theta,
                          float* out, const Dims& D) {
  const float* th = theta + (size_t)k * D.C * D.Co;
  for (int e = threadIdx.x; e < nj * D.CoT; e += kThreads) {
    const int jj = e / D.CoT, om = e % D.CoT, o = om / D.T, t = om % D.T;
    const float* ar = agg + jj * D.CT + t;
    float v = 0.f;
    for (int c = 0; c < D.C; ++c) v = fmaf(rnd(ar[c * D.T], D.bf16), th[c * D.Co + o], v);
    out[e] += v;
  }
  __syncthreads();
}

__device__ __forceinline__ void zero(float* p, int n) {
  for (int e = threadIdx.x; e < n; e += kThreads) p[e] = 0.f;
  __syncthreads();
}

// ---------------------------------------------------------------------------
// SB forward: y (B, N, Co*T) = relu(sum_k md(agg_k) . theta_k)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sp_cols_fwd_kernel(const float* __restrict__ qk, const float* __restrict__ bias,
                   const float* __restrict__ cheb, const float* __restrict__ xm,
                   const float* __restrict__ theta, float* __restrict__ y, Dims D) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.y, j0 = blockIdx.x * kCols;
  const int nj = min(kCols, D.N - j0);
  float* kt = sm;
  float* att = kt + kCols * D.dk;
  float* A = att + D.N * kCols;
  float* agg = A + D.N * kCols;
  float* out = agg + kCols * D.CT;
  zero(out, kCols * D.CoT);
  for (int k = 0; k < D.K; ++k) {
    col_softmax(b, k, j0, nj, qk, bias, cheb, kt, att, A, nullptr, D);
    aggregate(b, A, xm, agg, D);
    theta_mix(k, nj, agg, theta, out, D);
  }
  float* yb = y + ((size_t)b * D.N + j0) * D.CoT;
  for (int e = threadIdx.x; e < nj * D.CoT; e += kThreads) yb[e] = fmaxf(out[e], 0.f);
}

// ---------------------------------------------------------------------------
// SB backward, per (b, 16 target columns)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sp_cols_bwd_kernel(const float* __restrict__ qk, const float* __restrict__ bias,
                   const float* __restrict__ cheb, const float* __restrict__ xm,
                   const float* __restrict__ theta, const float* __restrict__ g_out,
                   float* __restrict__ aggbuf, float* __restrict__ daggbuf,
                   float* __restrict__ dS, float* __restrict__ dqk,
                   float* __restrict__ dth_part, float* __restrict__ stats, Dims D) {
  extern __shared__ __align__(16) float sm[];
  const int N = D.N, b = blockIdx.y, jt = blockIdx.x, j0 = jt * kCols;
  const int nj = min(kCols, N - j0);
  float* kt = sm;
  float* att = kt + kCols * D.dk;
  float* A = att + N * kCols;
  float* ds = A + N * kCols;
  float* agg = ds + N * kCols;
  float* dagg = agg + kCols * D.CT;
  float* gm = dagg + kCols * D.CT;

  // recompute the pre-ReLU output for the mask, keeping agg_k
  zero(gm, kCols * D.CoT);
  for (int k = 0; k < D.K; ++k) {
    col_softmax(b, k, j0, nj, qk, bias, cheb, kt, att, A, nullptr, D);
    aggregate(b, A, xm, agg, D);
    float* ab = aggbuf + (((size_t)b * D.K + k) * N + j0) * D.CT;
    for (int e = threadIdx.x; e < nj * D.CT; e += kThreads) ab[e] = agg[e];
    theta_mix(k, nj, agg, theta, gm, D);
  }
  const float* gb = g_out + ((size_t)b * N + j0) * D.CoT;
  for (int e = threadIdx.x; e < nj * D.CoT; e += kThreads)
    gm[e] = rnd(gb[e] * (gm[e] > 0.f ? 1.f : 0.f), D.bf16);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int NJt = gridDim.x;
  for (int k = 0; k < D.K; ++k) {
    col_softmax(b, k, j0, nj, qk, bias, cheb, kt, att, A, stats, D);
    const float* ab = aggbuf + (((size_t)b * D.K + k) * N + j0) * D.CT;
    for (int e = threadIdx.x; e < kCols * D.CT; e += kThreads)
      agg[e] = e < nj * D.CT ? ab[e] : 0.f;
    __syncthreads();
    // dtheta_k partial of this tile: sum_{j,t} md(agg)[j][c,t] * gm[j][o,t]
    const float* th = theta + (size_t)k * D.C * D.Co;
    float* part = dth_part + (((size_t)b * NJt + jt) * D.K + k) * D.C * D.Co;
    for (int e = threadIdx.x; e < D.C * D.Co; e += kThreads) {
      const int c = e / D.Co, o = e % D.Co;
      float acc = 0.f;
      for (int jj = 0; jj < nj; ++jj)
        for (int t = 0; t < D.T; ++t)
          acc = fmaf(rnd(agg[jj * D.CT + c * D.T + t], D.bf16), gm[jj * D.CoT + o * D.T + t],
                     acc);
      part[e] = acc;
    }
    // dagg = md(gm . theta_k^T), per time step
    float* db = daggbuf + (((size_t)b * D.K + k) * N + j0) * D.CT;
    for (int e = threadIdx.x; e < kCols * D.CT; e += kThreads) {
      const int jj = e / D.CT, cm = e % D.CT, c = cm / D.T, t = cm % D.T;
      float v = 0.f;
      if (jj < nj) {
        for (int o = 0; o < D.Co; ++o)
          v = fmaf(gm[jj * D.CoT + o * D.T + t], th[c * D.Co + o], v);
        v = rnd(v, D.bf16);
        db[e] = v;
      }
      dagg[e] = v;
    }
    __syncthreads();
    // datt = cheb * (md(xm) . dagg^T): a warp per source row
    const float* xb = xm + (size_t)b * N * D.CT;
    const float* cheb_k = cheb + (size_t)k * N * N;
    for (int i = warp; i < N; i += kWarps) {
      float acc[kCols];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) acc[jj] = 0.f;
#pragma unroll 4
      for (int m = lane; m < D.CT; m += 32) {
        const float xv = rnd(__ldg(xb + (size_t)i * D.CT + m), D.bf16);
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) acc[jj] = fmaf(xv, dagg[jj * D.CT + m], acc[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) acc[jj] = dense::warp_sum(acc[jj]);
      if (lane < nj) {
        float mine = 0.f;
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj)
          if (jj == lane) mine = acc[jj];
        ds[i * kCols + lane] = cheb_k[(size_t)i * N + j0 + lane] * mine;
      }
    }
    __syncthreads();
    // source-axis softmax backward, per column: ds = att * (datt - sum_i att*datt)
    float* dSk = dS + ((size_t)b * D.K + k) * N * N;
    for (int jj = warp; jj < nj; jj += kWarps) {
      float dot = 0.f;
      for (int i = lane; i < N; i += 32) dot = fmaf(att[i * kCols + jj], ds[i * kCols + jj], dot);
      dot = dense::warp_sum(dot);
      for (int i = lane; i < N; i += 32) {
        const float v = att[i * kCols + jj] * (ds[i * kCols + jj] - dot);
        ds[i * kCols + jj] = v;
        dSk[(size_t)i * N + j0 + jj] = v;
      }
    }
    __syncthreads();
    // dk_k[j] = sum_i md(ds)[i][j] md(q_k)[i] / sqrt(dk)
    for (int e = threadIdx.x; e < nj * D.dk; e += kThreads) {
      const int jj = e / D.dk, c = e % D.dk;
      float acc = 0.f;
#pragma unroll 4
      for (int i = 0; i < N; ++i)
        acc = fmaf(rnd(ds[i * kCols + jj], D.bf16),
                   rnd(__ldg(qk + ((size_t)b * N + i) * D.HK2 + k * D.dk + c), D.bf16), acc);
      dqk[((size_t)b * N + j0 + jj) * D.HK2 + D.hk + k * D.dk + c] = acc * D.inv_sqrt;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// SC: dxm and dq for 16 source rows of batch b
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sp_rows_bwd_kernel(const float* __restrict__ qk, const float* __restrict__ bias,
                   const float* __restrict__ cheb, const float* __restrict__ stats,
                   const float* __restrict__ daggbuf, const float* __restrict__ dS,
                   float* __restrict__ dxm, float* __restrict__ dqk, Dims D) {
  extern __shared__ __align__(16) float sm[];
  const int N = D.N, b = blockIdx.y, i0 = blockIdx.x * kRows;
  const int ni = min(kRows, N - i0);
  float* kr = sm;                    // (N, dk) md(k_k) of every target
  float* At = kr + pad4(N * D.dk);   // (N, 16): At[j][ii] = A_k[i0+ii][j]
  float* acc_s = At + N * kRows;     // (16, CT)
  zero(acc_s, kRows * D.CT);
  for (int k = 0; k < D.K; ++k) {
    for (int e = threadIdx.x; e < N * D.dk; e += kThreads) {
      const int j = e / D.dk, c = e % D.dk;
      kr[e] = rnd(qk[((size_t)b * N + j) * D.HK2 + D.hk + k * D.dk + c], D.bf16);
    }
    __syncthreads();
    const float* bias_k = bias + (size_t)k * N * N;
    const float* cheb_k = cheb + (size_t)k * N * N;
    const float* st = stats + ((size_t)b * D.K + k) * N * 2;
    for (int e = threadIdx.x; e < N * kRows; e += kThreads) {
      const int j = e / kRows, ii = e % kRows, i = i0 + ii;
      float a = 0.f;
      if (ii < ni) {
        const float s = score(qk + ((size_t)b * N + i) * D.HK2 + k * D.dk, kr + j * D.dk,
                              bias_k[(size_t)i * N + j], D);
        a = rnd(cheb_k[(size_t)i * N + j] * (expf(s - st[2 * j]) / st[2 * j + 1]), D.bf16);
      }
      At[e] = a;
    }
    __syncthreads();
    // dxm += A_k . dagg_k
    const float* dg = daggbuf + ((size_t)b * D.K + k) * N * D.CT;
    for (int m = threadIdx.x; m < D.CT; m += kThreads) {
      float acc[kRows];
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) acc[ii] = 0.f;
#pragma unroll 4
      for (int j = 0; j < N; ++j) {
        const float yv = __ldg(dg + (size_t)j * D.CT + m);
        const float4* a4 = reinterpret_cast<const float4*>(At + j * kRows);
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const float4 v = a4[q];
          acc[4 * q] = fmaf(v.x, yv, acc[4 * q]);
          acc[4 * q + 1] = fmaf(v.y, yv, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v.z, yv, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v.w, yv, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) acc_s[ii * D.CT + m] += acc[ii];
    }
    // dq_k[i] = sum_j md(ds)[i][j] md(k_k)[j] / sqrt(dk)
    const float* dSk = dS + ((size_t)b * D.K + k) * N * N;
    for (int e = threadIdx.x; e < ni * D.dk; e += kThreads) {
      const int ii = e / D.dk, c = e % D.dk;
      const float* dsr = dSk + (size_t)(i0 + ii) * N;
      float acc = 0.f;
#pragma unroll 4
      for (int j = 0; j < N; ++j) acc = fmaf(rnd(__ldg(dsr + j), D.bf16), kr[j * D.dk + c], acc);
      dqk[((size_t)b * N + i0 + ii) * D.HK2 + k * D.dk + c] = acc * D.inv_sqrt;
    }
    __syncthreads();
  }
  float* out = dxm + ((size_t)b * N + i0) * D.CT;
  for (int e = threadIdx.x; e < ni * D.CT; e += kThreads) out[e] = acc_s[e];
}

// ---------------------------------------------------------------------------
// SD: dsemx -> dropout, LN backward -> dtat for 16 rows of batch b
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sp_embed_bwd_kernel(const float* __restrict__ dqk, const float* __restrict__ wqk_t,
                    const float* __restrict__ pw_t, const float* __restrict__ gs,
                    const float* __restrict__ dmask, const float* __restrict__ xhat,
                    const float* __restrict__ inv_s, float* __restrict__ dse,
                    float* __restrict__ vec, float* __restrict__ dtat, Dims D) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.y, i0 = blockIdx.x * kRows;
  const int R = min(kRows, D.N - i0);
  const size_t row0 = (size_t)b * D.N + i0;
  float* dq = sm;                   // (R, 2Kdk)
  float* g = dq + kRows * D.HK2;    // (R, d)
  for (int e = threadIdx.x; e < R * D.HK2; e += kThreads)
    dq[e] = rnd(dqk[row0 * D.HK2 + e], D.bf16);
  __syncthreads();
  dense::rows_x_mat<16>(dq, D.HK2, R, D.HK2, wqk_t, D.d, D.d, g, D.d);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int ii = warp; ii < R; ii += kWarps) {
    const size_t row = row0 + ii;
    float* gr = g + ii * D.d;
    const float* xh = xhat + row * D.d;
    float* v = vec + row * 2 * D.d;
    for (int e = lane; e < D.d; e += 32) {
      const float m = dmask ? dmask[row * D.d + e] : 1.f;
      const float pre = gr[e] * m * D.keep_inv;
      gr[e] = pre;
      v[e] = pre * xh[e];
      v[D.d + e] = pre;
    }
    __syncwarp();
    dense::ln_bwd_row(gr, xh, inv_s[row], gs, D.d);
    for (int e = lane; e < D.d; e += 32) {
      dse[row * D.d + e] = gr[e];
      gr[e] = rnd(gr[e], D.bf16);
    }
  }
  __syncthreads();
  dense::rows_x_mat<16>(g, D.d, R, D.d, pw_t, D.FT, D.FT, dtat + row0 * D.FT, D.FT);
}

// ---------------------------------------------------------------------------

Dims make_dims(int B, int N, int FT, int C, int T, int Co, int d, int K, int dk, float keep,
               int bf16) {
  Dims D;
  D.B = B;
  D.N = N;
  D.FT = FT;
  D.C = C;
  D.T = T;
  D.CT = C * T;
  D.Co = Co;
  D.CoT = Co * T;
  D.d = d;
  D.K = K;
  D.dk = dk;
  D.hk = K * dk;
  D.HK2 = 2 * K * dk;
  D.bf16 = bf16;
  D.keep_inv = static_cast<float>(1.0 / static_cast<double>(keep));
  D.inv_sqrt = static_cast<float>(1.0 / sqrt(static_cast<double>(dk)));
  return D;
}

size_t sa_smem(const Dims& D) { return sizeof(float) * kRows * (D.FT + D.d); }
size_t sb_fwd_smem(const Dims& D) {
  return sizeof(float) * ((size_t)kCols * D.dk + 2 * (size_t)D.N * kCols + kCols * D.CT +
                          kCols * D.CoT);
}
size_t sb_bwd_smem(const Dims& D) {
  return sizeof(float) * ((size_t)kCols * D.dk + 3 * (size_t)D.N * kCols + 2 * kCols * D.CT +
                          kCols * D.CoT);
}
size_t sc_smem(const Dims& D) {
  return sizeof(float) * ((size_t)pad4(D.N * D.dk) + (size_t)D.N * kRows + kRows * D.CT);
}
size_t sd_smem(const Dims& D) { return sizeof(float) * kRows * (D.HK2 + D.d); }

// the backward's workspace layout (floats)
struct BwdSpace {
  size_t qk, semx, xhat, inv, agg, dagg, dS, dqk, dse, vec, part, stats, scratch, total;
};

BwdSpace bwd_space(const Dims& D) {
  const size_t BN = (size_t)D.B * D.N;
  const int NJt = (D.N + kCols - 1) / kCols;
  BwdSpace s;
  s.qk = 0;
  s.semx = s.qk + BN * D.HK2;
  s.xhat = s.semx + BN * D.d;
  s.inv = s.xhat + BN * D.d;
  s.agg = s.inv + BN;
  s.dagg = s.agg + BN * D.K * D.CT;
  s.dS = s.dagg + BN * D.K * D.CT;
  s.dqk = s.dS + BN * D.K * D.N;
  s.dse = s.dqk + BN * D.HK2;
  s.vec = s.dse + BN * D.d;
  s.part = s.vec + BN * 2 * D.d;
  s.stats = s.part + (size_t)D.B * NJt * D.K * D.C * D.Co;
  s.scratch = s.stats + BN * D.K * 2;
  size_t sc = dense::atb_scratch((int)BN, D.FT, D.d);
  const size_t more[] = {
      dense::atb_scratch((int)BN, D.d, D.HK2),
      dense::sum_rows_scratch(D.B, D.K * D.N * D.N),
      dense::sum_rows_scratch(D.B * NJt, D.K * D.C * D.Co),
      dense::sum_rows_scratch(D.B, D.N * D.d),
      dense::sum_rows_scratch((int)BN, D.d),
      dense::sum_rows_scratch((int)BN, 2 * D.d),
  };
  for (size_t m : more)
    if (m > sc) sc = m;
  s.total = s.scratch + sc;
  return s;
}

cudaError_t launch_sa(const float* tat, const float* pw, const float* pb, const float* pos,
                      const float* gs, const float* bs, const float* wqk, const float* dmask,
                      float* qk, float* semx, float* xhat, float* inv, const Dims& D,
                      cudaStream_t st) {
  const size_t smem = sa_smem(D);
  cudaError_t err = dense::allow_smem(sp_embed_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((D.N + kRows - 1) / kRows, D.B);
  sp_embed_kernel<<<grid, kThreads, smem, st>>>(tat, pw, pb, pos, gs, bs, wqk, dmask, qk, semx,
                                                xhat, inv, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the forward's (qk) and the backward's workspace.
size_t spatial_fused_workspace_floats(int B, int N, int FT, int C, int T, int Co, int d,
                                      int K, int dk, int backward) {
  const Dims D = make_dims(B, N, FT, C, T, Co, d, K, dk, 1.f, 0);
  return backward ? bwd_space(D).total : (size_t)B * N * D.HK2;
}

// Forward: y (B, N, Co*T) float32. dmask (B, N, d) of 0/1 or null (no
// dropout). Returns cudaGetLastError().
int spatial_fused_forward(const float* tat, const float* xm, const float* dmask,
                          const float* pw, const float* pb, const float* pos, const float* gs,
                          const float* bs, const float* wqk, const float* bias,
                          const float* cheb, const float* theta, float* y, float* ws, int B,
                          int N, int FT, int C, int T, int Co, int d, int K, int dk,
                          float keep, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims D = make_dims(B, N, FT, C, T, Co, d, K, dk, keep, bf16);
  cudaError_t err = launch_sa(tat, pw, pb, pos, gs, bs, wqk, dmask, ws, nullptr, nullptr,
                              nullptr, D, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sb_fwd_smem(D);
  err = dense::allow_smem(sp_cols_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kCols - 1) / kCols, B);
  sp_cols_fwd_kernel<<<grid, kThreads, smem, st>>>(ws, bias, cheb, xm, theta, y, D);
  return static_cast<int>(cudaGetLastError());
}

// Backward: dtat (B,N,FT), dxm (B,N,C*T); dpw (FT,d), dvec (3,d) = [dpb,
// dgs, dbs], dpos (N,d), dwqk (d,2Kdk), dbias (K,N,N), dtheta (K,C,Co), all
// summed over b in a fixed order. pw_t (d,FT) and wqk_t (2Kdk,d) are the
// transposed weights. `ws` holds spatial_fused_workspace_floats(..., 1).
int spatial_fused_backward(const float* tat, const float* xm, const float* dmask,
                           const float* pw, const float* pw_t, const float* pb,
                           const float* pos, const float* gs, const float* bs,
                           const float* wqk, const float* wqk_t, const float* bias,
                           const float* cheb, const float* theta, const float* g_out,
                           float* dtat, float* dxm, float* dpw, float* dvec, float* dpos,
                           float* dwqk, float* dbias, float* dtheta, float* ws, int B, int N,
                           int FT, int C, int T, int Co, int d, int K, int dk, float keep,
                           int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims D = make_dims(B, N, FT, C, T, Co, d, K, dk, keep, bf16);
  const BwdSpace s = bwd_space(D);
  const int BN = B * N, NJt = (N + kCols - 1) / kCols, NIt = (N + kRows - 1) / kRows;
  cudaError_t err = launch_sa(tat, pw, pb, pos, gs, bs, wqk, dmask, ws + s.qk, ws + s.semx,
                              ws + s.xhat, ws + s.inv, D, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  size_t smem = sb_bwd_smem(D);
  err = dense::allow_smem(sp_cols_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sp_cols_bwd_kernel<<<dim3(NJt, B), kThreads, smem, st>>>(
      ws + s.qk, bias, cheb, xm, theta, g_out, ws + s.agg, ws + s.dagg, ws + s.dS,
      ws + s.dqk, ws + s.part, ws + s.stats, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  smem = sc_smem(D);
  err = dense::allow_smem(sp_rows_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sp_rows_bwd_kernel<<<dim3(NIt, B), kThreads, smem, st>>>(
      ws + s.qk, bias, cheb, ws + s.stats, ws + s.dagg, ws + s.dS, dxm, ws + s.dqk, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  smem = sd_smem(D);
  err = dense::allow_smem(sp_embed_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sp_embed_bwd_kernel<<<dim3(NIt, B), kThreads, smem, st>>>(
      ws + s.dqk, wqk_t, pw_t, gs, dmask, ws + s.xhat, ws + s.inv, ws + s.dse, ws + s.vec,
      dtat, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  float* scratch = ws + s.scratch;
  if ((err = dense::atb(tat, ws + s.dse, dpw, scratch, BN, FT, d, bf16, bf16, st)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if ((err = dense::atb(ws + s.semx, ws + s.dqk, dwqk, scratch, BN, d, D.HK2, 0, bf16, st)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if ((err = dense::sum_rows(ws + s.dS, dbias, scratch, B, K * N * N, st)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = dense::sum_rows(ws + s.part, dtheta, scratch, B * NJt, K * C * Co, st)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if ((err = dense::sum_rows(ws + s.dse, dpos, scratch, B, N * d, st)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = dense::sum_rows(ws + s.dse, dvec, scratch, BN, d, st)) != cudaSuccess)
    return static_cast<int>(err);
  err = dense::sum_rows(ws + s.vec, dvec + d, scratch, BN, 2 * d, st);
  return static_cast<int>(err);
}

const char* spatial_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
