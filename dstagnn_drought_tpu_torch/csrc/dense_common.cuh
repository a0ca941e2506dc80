// Shared pieces of the dense fused kernels (tat_fused.cu,
// block_spatial_fused.cu): row products against a weight matrix in device
// memory, warp LayerNorm statistics (whole rows, or chunks merged by Chan's
// formula), and the two deterministic reductions
// that replace the TPU kernels' weight-gradient accumulation across a
// sequential grid.
//
// All arithmetic is float32 (FMAs on the CUDA cores). Where the TPU kernel
// casts an operand to the matmul dtype, the callers round it with rnd().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace dense {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-5f;

// v rounded to bfloat16 (round to nearest even) when bf16 is set, as a float
__device__ __forceinline__ float rnd(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// out[r*ldo + c] = sum_k a[r*lda + k] * w[k*ldw + c], r < R, c < C (with
// kAdd, out[r*ldo + c] += that sum: a product over chunks of k).
// `a` is in shared memory; `w` is row-major in device memory; `out` may be
// either. Work item = (chunk of RC rows, column), columns fastest: a warp
// reads a row of w coalesced and each `a` value is a shared broadcast; w is
// read once per RC rows. Where a's rows are 16-byte aligned (lda and Kd
// multiples of 4), four k steps share one 16-byte load of each a row and
// four loads of w are in flight; the sums run over k in the same order on
// both paths.
template <int RC, bool kAdd = false>
__device__ __forceinline__ void rows_x_mat(const float* a, int lda, int R, int Kd,
                                           const float* __restrict__ w, int ldw, int C,
                                           float* out, int ldo) {
  const int chunks = (R + RC - 1) / RC;
  const bool vec = (lda % 4 == 0) && (Kd % 4 == 0) &&
                   (reinterpret_cast<size_t>(a) % 16 == 0);
  for (int item = threadIdx.x; item < chunks * C; item += blockDim.x) {
    const int c = item % C;
    const int r0 = (item / C) * RC;
    const int nr = min(RC, R - r0);
    float acc[RC];
#pragma unroll
    for (int r = 0; r < RC; ++r) acc[r] = 0.f;
    if (vec) {
      for (int k = 0; k < Kd; k += 4) {
        const float w0 = __ldg(w + (size_t)k * ldw + c);
        const float w1 = __ldg(w + (size_t)(k + 1) * ldw + c);
        const float w2 = __ldg(w + (size_t)(k + 2) * ldw + c);
        const float w3 = __ldg(w + (size_t)(k + 3) * ldw + c);
#pragma unroll
        for (int r = 0; r < RC; ++r) {
          if (r < nr) {
            const float4 a4 = *reinterpret_cast<const float4*>(a + (r0 + r) * lda + k);
            acc[r] = fmaf(a4.x, w0, acc[r]);
            acc[r] = fmaf(a4.y, w1, acc[r]);
            acc[r] = fmaf(a4.z, w2, acc[r]);
            acc[r] = fmaf(a4.w, w3, acc[r]);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < Kd; ++k) {
        const float wv = __ldg(w + (size_t)k * ldw + c);
#pragma unroll
        for (int r = 0; r < RC; ++r)
          if (r < nr) acc[r] = fmaf(a[(r0 + r) * lda + k], wv, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RC; ++r)
      if (r < nr) {
        float* o = out + (size_t)(r0 + r) * ldo + c;
        *o = kAdd ? *o + acc[r] : acc[r];
      }
  }
}

// mean and 1/sqrt(var + eps) of z[0..L) by one warp (all lanes get them)
__device__ __forceinline__ void ln_stats(const float* z, int L, float& mu, float& inv) {
  const int lane = threadIdx.x % 32;
  float s = 0.f;
  for (int e = lane; e < L; e += 32) s += z[e];
  mu = warp_sum(s) / L;
  float v = 0.f;
  for (int e = lane; e < L; e += 32) {
    const float d = z[e] - mu;
    v = fmaf(d, d, v);
  }
  inv = rsqrtf(warp_sum(v) / L + kEps);
}

// Chan's merge of a row chunk's columns zr[0, cv) into the row's running
// mean and sum of squared deviations m2 over its first n columns, by one
// warp; st = {mean, m2} in shared memory (kept out of registers: the wide
// products beside them need those). One chunk (n = 0) gives the two-pass
// statistics of ln_stats, bit for bit.
__device__ __forceinline__ void merge_row(const float* zr, int cv, int n, float* st) {
  const int lane = threadIdx.x % 32;
  float s = 0.f;
  for (int e = lane; e < cv; e += 32) s += zr[e];
  const float mc = warp_sum(s) / cv;
  float v = 0.f;
  for (int e = lane; e < cv; e += 32) {
    const float t = zr[e] - mc;
    v = fmaf(t, t, v);
  }
  v = warp_sum(v);
  float mean = mc, m2 = v;
  if (n > 0) {
    const float delta = mc - st[0], nn = static_cast<float>(n + cv);
    mean = st[0] + delta * (cv / nn);
    m2 = st[1] + v + delta * delta * (static_cast<float>(n) * cv / nn);
  }
  __syncwarp();
  if (lane == 0) {
    st[0] = mean;
    st[1] = m2;
  }
  __syncwarp();
}

// LayerNorm backward by one warp, in place on g[0..L):
//   gy = g*gamma; g <- inv * (gy - mean(gy) - x_hat * mean(gy*x_hat))
__device__ __forceinline__ void ln_bwd_row(float* g, const float* x_hat, float inv,
                                           const float* __restrict__ gamma, int L) {
  const int lane = threadIdx.x % 32;
  float m1 = 0.f, m2 = 0.f;
  for (int e = lane; e < L; e += 32) {
    const float gy = g[e] * gamma[e];
    m1 += gy;
    m2 = fmaf(gy, x_hat[e], m2);
  }
  m1 = warp_sum(m1) / L;
  m2 = warp_sum(m2) / L;
  __syncwarp();
  for (int e = lane; e < L; e += 32) {
    const float gy = g[e] * gamma[e];
    g[e] = inv * (gy - m1 - x_hat[e] * m2);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// deterministic reductions (no atomics: every sum runs in a fixed order)
// ---------------------------------------------------------------------------

// part[s][p][q] = sum_{m in chunk s} ra(a[m][p]) * rb(b[m][q]); chunk s is
// rows [s*chunk, min(M, (s+1)*chunk)). a (M, P), b (M, Q) row-major; ra/rb
// round to bf16 when round_a/round_b are set. 64 x 64 output tile a block,
// 4 x 4 sums a thread, 32 contraction rows staged per step.
__global__ void __launch_bounds__(kThreads)
atb_partial_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ part, int M, int P, int Q, int chunk,
                   int round_a, int round_b) {
  __shared__ __align__(16) float a_s[32][64];
  __shared__ __align__(16) float b_s[32][64];
  const int q0 = blockIdx.x * 64, p0 = blockIdx.y * 64, s = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m_begin = s * chunk, m_end = min(M, m_begin + chunk);
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int m0 = m_begin; m0 < m_end; m0 += 32) {
    for (int e = threadIdx.x; e < 32 * 64; e += kThreads) {
      const int mm = e / 64, pp = e % 64;
      const int m = m0 + mm;
      const bool in_m = m < m_end;
      a_s[mm][pp] = (in_m && p0 + pp < P) ? rnd(a[(size_t)m * P + p0 + pp], round_a) : 0.f;
      b_s[mm][pp] = (in_m && q0 + pp < Q) ? rnd(b[(size_t)m * Q + q0 + pp], round_b) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int mm = 0; mm < 32; ++mm) {
      const float4 a4 = *reinterpret_cast<const float4*>(&a_s[mm][4 * ty]);
      const float4 b4 = *reinterpret_cast<const float4*>(&b_s[mm][4 * tx]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)s * P * Q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + 4 * ty + r;
    if (p >= P) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int q = q0 + 4 * tx + c;
      if (q < Q) out[(size_t)p * Q + q] = acc[r][c];
    }
  }
}

// out[g][l] = sum over rows r of group g (rows [g*chunk, min(S, (g+1)*chunk)))
// of in[r][l], in row order
__global__ void __launch_bounds__(kThreads)
colsum_kernel(const float* __restrict__ in, float* __restrict__ out, int S, int L, int chunk) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  const int g = blockIdx.y;
  if (l >= L) return;
  const int r_end = min(S, (g + 1) * chunk);
  float acc = 0.f;
  for (int r = g * chunk; r < r_end; ++r) acc += in[(size_t)r * L + l];
  out[(size_t)g * L + l] = acc;
}

// Floats of scratch that sum_rows needs for (S, L).
inline size_t sum_rows_scratch(int S, int L) {
  return S > 64 ? (size_t)((S + 63) / 64) * L : 0;
}

// out[l] = sum_r in[r][l] for in (S, L): in groups of 64 rows into
// `scratch`, then over the groups; the same order every run.
inline cudaError_t sum_rows(const float* in, float* out, float* scratch, int S, int L,
                            cudaStream_t st) {
  const int lb = (L + kThreads - 1) / kThreads;
  if (S <= 64) {
    colsum_kernel<<<dim3(lb, 1), kThreads, 0, st>>>(in, out, S, L, S > 0 ? S : 1);
    return cudaGetLastError();
  }
  const int G = (S + 63) / 64;
  colsum_kernel<<<dim3(lb, G), kThreads, 0, st>>>(in, scratch, S, L, 64);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_kernel<<<dim3(lb, 1), kThreads, 0, st>>>(scratch, out, G, L, G);
  return cudaGetLastError();
}

// Split count of the (M -> P x Q) product: enough blocks to fill the card
// twice over, chunks of whole 32-row steps.
inline int atb_splits(int M, int P, int Q) {
  const int tiles = ((P + 63) / 64) * ((Q + 63) / 64);
  int S = (264 + tiles - 1) / tiles;
  const int steps = (M + 31) / 32;
  if (S > steps) S = steps;
  return S < 1 ? 1 : S;
}

// Floats of scratch that atb needs: the partials and sum_rows' scratch.
inline size_t atb_scratch(int M, int P, int Q) {
  const int S = atb_splits(M, P, Q);
  return (size_t)S * P * Q + sum_rows_scratch(S, P * Q);
}

// out (P, Q) = ra(a)^T rb(b) over the M rows of a (M, P) and b (M, Q):
// split-M partials, then sum_rows in a fixed order.
inline cudaError_t atb(const float* a, const float* b, float* out, float* scratch, int M,
                       int P, int Q, int round_a, int round_b, cudaStream_t st) {
  const int S = atb_splits(M, P, Q);
  int chunk = (M + S - 1) / S;
  chunk = ((chunk + 31) / 32) * 32;
  float* part = scratch;
  const dim3 grid((Q + 63) / 64, (P + 63) / 64, S);
  atb_partial_kernel<<<grid, kThreads, 0, st>>>(a, b, part, M, P, Q, chunk, round_a, round_b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_rows(part, out, part + (size_t)S * P * Q, S, P * Q, st);
}

// Raise a kernel's dynamic shared memory cap when it needs more than 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace dense
