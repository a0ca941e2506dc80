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
//   forward  SA (rows of (b, i)): pre_conv, LN, dropout, QK -> qk (B,N,2Kdk)
//            SB (b, 16 target columns): for each k, the column's scores over
//               all N sources, the source-axis softmax, A_k, agg_k and the
//               theta mix; ReLU on the way out. (B, K, N, N) never reaches
//               memory.
//   backward SA again (saving semx, x_hat, 1/std); SB, one loop over k:
//               the column's softmax and A_k, agg_k, the dtheta partial,
//               dagg, dA, the softmax backward -> ds, dk;
//            SC (b, 16 source rows): dxm += A_k . dagg_k and dq_k from ds;
//            SD (b, 16 rows): dsemx, dropout and LN backward, dtat;
//            then the weight gradients, summed over b in a fixed order:
//               dpw = tat^T dse, dwqk = semx^T dqk (split-row products),
//               dbias, dtheta, dpos, dpb, dgs, dbs (row sums). No float
//               atomics: two launches give the same bits.
// The ReLU mask comes from the forward: the wrapper keeps where the forward
// kernel's float32 output was > 0 (one byte an element) and SB reads it, so
// the backward never recomputes the pre-ReLU output. JAX recomputes it
// inside its backward kernel with the forward's own arithmetic; here the
// bf16 backward sums its products in another order than the forward, and a
// recomputed value within rounding of 0 could flip the mask (one flipped
// element changes a whole batch row's gradients). The forward's record
// keeps the backward consistent with the output autograd saw, as
// torch.relu's backward reads its output.
//
// Float32 runs every pass on the CUDA cores (exact FMAs, no TF32): SA and
// SD a block of 16 rows of one b on dense::rows_x_mat, SB with agg_k's 16 x
// C*T sums in registers and the theta mix into a shared 16 x Co*T tile. In
// bfloat16 SA and the two N-sized passes of each direction run their
// products on the tensor cores (nvcuda::wmma bf16 16x16x16 fragments,
// float32 sums; the operands are bf16-exact already, so only the order of
// the sums differs):
//   SA (sp_embed_wmma_kernel, forward and backward): x_tat = md(tat) . pw
//      and qk = semx . wqk for 32 rows flat over (b, i) (16 where 32 do not
//      fit), so a block reads each weight once: a warp owns a pair of column
//      tiles and both row tiles and reads the weights (the wrapper's bf16
//      copies) as fragments straight from L2. Staging them with cp.async
//      would save no traffic (each fragment is read once a block) and cost
//      the shared memory that lets two blocks share an SM: 78,848 bytes at
//      PEMS08 widths (x_tat float32 for the LayerNorm, a 64-column chunk of
//      md(tat), each row's bf16 semx written over the front of its own x_tat
//      row once read). LN, dropout and the md() of semx stay float32 a warp
//      a row. Both directions launch the same kernel, so they get the same
//      qk bits, and the backward's att is the forward's;
//   SB forward (sp_cols_fwd_wmma_kernel): agg_k = A_k^T . xm and the theta
//      mix out^T (r, o) += md(agg)^T (r, c) . theta_k over the rows r =
//      (j, t), sums float32 in shared memory across k (89,088 bytes at
//      PEMS08's N = 170: two blocks an SM);
//   SB backward (sp_cols_bwd_wmma_kernel): agg_k, dA = xm . dagg_k^T, and
//      the theta products dtheta_k = md(agg)^T . gm, dagg = gm . theta^T;
//   SC (sp_rows_bwd_wmma_kernel): dxm += A_k . dagg_k.
// Both SB kernels stage the theta operands alike (stage_theta: md(agg) and
// gm transposed to bf16 (r, c) and (r, o) tiles, theta mixing per time step
// so in agg's (j, c*T + t) layout it contracts with a stride). A_k (N, 16)
// and dagg (16, C*T) are bf16 tiles in shared memory; xm (the wrapper's
// bf16 copy padded to (Np, C*Tp), multiples of 16, zero outside) and dagg_k
// (bf16, (Np, C*Tp)) are read as fragments straight from device memory
// (L2): no block holds xm, so shared memory holds the (N, 16) planes and
// 16-row tiles, and the backward's SB sets the bf16 cap on N, 944 at PEMS08
// widths (float32: 816). A's rows past N are zero, so the padded sources
// add nothing. The scores, the softmax and its backward, dk and dq stay
// float32 FMAs on the CUDA cores in one FMA order: both SB kernels read the
// tile's keys transposed (conflict-free), SC rebuilds A_k a warp per source
// row with its lanes across the targets (coalesced bias and Chebyshev
// reads). They, and the unstaged L2 fragment reads, are what bound the bf16
// passes now; SD stays on the CUDA cores.

#include "dense_common.cuh"
#include "wmma_common.cuh"

namespace {

using namespace wm;
using dense::kThreads;
using dense::kWarps;
using dense::rnd;

constexpr int kRows = 16;  // source rows a block (SA in float32, SC, SD)
constexpr int kCols = 16;  // target columns a block (SB)
constexpr int kAcc = 3;    // 16-column accumulator tiles a warp holds (WMMA)
constexpr size_t kSmemMax = 232448;  // shared memory a block may have (227 KB)

// n rounded up to a multiple of 4 floats (16-byte aligned shared buffers)
__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) & ~15; }

// The bf16 tiles: Np, CTp, Cp, Cop, FTp, dp, HKp are N, C*T, C, Co, F*T, d,
// 2*K*dk rounded up to 16; R = 16*T rows (j, t) of the theta products; LD,
// LC, LO the rows of the dagg, (r, c) and (r, o) tiles (multiples of 8 for
// load_matrix_sync), LF, LX those of the float32 (r, o) sums and x_tat
// (multiples of 4); RW the rows of a bf16 SA block
struct Dims {
  int B, N, FT, CT, T, C, Co, CoT, d, K, dk, hk, HK2, bf16;
  int Np, CTp, Cp, Cop, R, LD, LC, LO, LF;
  int FTp, dp, HKp, LX, RW;
  float keep_inv, inv_sqrt;
};

// ---------------------------------------------------------------------------
// SA: pre_conv -> +pos, LN -> dropout -> QK for 16 source rows of batch b
// (float32 on the CUDA cores)
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
// SA in bfloat16 on the tensor cores, RW rows a block flat over (b, i)
// ---------------------------------------------------------------------------

// acc[r][q] += a (16*RT rows, kn columns) . w (kn rows, column tiles ct0 +
// q): a bf16 in shared memory (row length la), w bf16 row-major in device
// memory (row length ldw), read as fragments from L2. A warp owns a pair of
// column tiles and every row tile, so a block reads each w fragment once
// and each a fragment serves two column tiles; the sums stay in the
// fragments.
__device__ __forceinline__ void mma_pair(FragC (&acc)[2][2], const bf16* a, int la, int RT,
                                         int kn, const bf16* __restrict__ w, int ldw, int ct0,
                                         int NT) {
#pragma unroll 2
  for (int k0 = 0; k0 < kn; k0 += 16) {
    FragB wf[2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (ct0 + q < NT) wmma::load_matrix_sync(wf[q], w + (size_t)k0 * ldw + (ct0 + q) * 16, ldw);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r >= RT) continue;
      FragA af;
      wmma::load_matrix_sync(af, a + r * 16 * la + k0, la);
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (ct0 + q < NT) wmma::mma_sync(acc[r][q], af, wf[q], acc[r][q]);
    }
  }
}

__device__ __forceinline__ void zero_pair(FragC (&acc)[2][2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int q = 0; q < 2; ++q) wmma::fill_fragment(acc[r][q], 0.f);
}

// The embedding pass of both directions in bf16 for RW rows flat over (b,
// i): x_tat = md(tat) . pw and qk = semx . wqk on WMMA (pw (FTp, dp) and
// wqk (dp, HKp) the wrapper's bf16 copies, fragments read from L2), pb,
// pos, LN, dropout and the md() of semx in float32 a warp a row as
// sp_embed_kernel does; semx, x_hat and 1/std for the backward when given.
// md(tat) comes through shared memory kKC columns at a time, each round of
// column pairs walking all of them; each row's bf16 semx overwrites the
// front of its own float32 x_tat row once read (rows of 2*LX bf16).
constexpr int kKC = 64;  // md(tat) columns a chunk

__global__ void __launch_bounds__(kThreads)
sp_embed_wmma_kernel(const float* __restrict__ tat, const bf16* __restrict__ pw,
                     const float* __restrict__ pb, const float* __restrict__ pos,
                     const float* __restrict__ gs, const float* __restrict__ bs,
                     const bf16* __restrict__ wqk, const float* __restrict__ dmask,
                     float* __restrict__ qk, float* __restrict__ semx_out,
                     float* __restrict__ xhat_out, float* __restrict__ inv_out, Dims D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int RW = D.RW, RT = RW / 16, LK = kKC + 8;
  const int row0 = blockIdx.x * RW, nr = min(RW, D.B * D.N - row0);
  // every region a multiple of 32 bytes, so each WMMA tile starts aligned
  float* xs = reinterpret_cast<float*>(smem);                   // (RW, LX): x_tat, semx
  float* stage = xs + RW * D.LX;                                 // 8 x (16, 16)
  bf16* chunk = reinterpret_cast<bf16*>(stage + kWarps * 256);  // (RW, LK) md(tat)
  const bf16 zero16 = __float2bfloat16_rn(0.f);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, NT = D.dp / 16;
  FragC acc[2][2];
  for (int g0 = 0; g0 < NT; g0 += 2 * kWarps) {
    const int ct0 = g0 + 2 * warp;
    zero_pair(acc);
    for (int c0 = 0; c0 < D.FTp; c0 += kKC) {
      const int kn = min(kKC, D.FTp - c0);
      __syncthreads();  // the last chunk is consumed
      for (int e = threadIdx.x; e < RW * kn; e += kThreads) {
        const int r = e / kn, c = c0 + e % kn;
        chunk[r * LK + c - c0] = r < nr && c < D.FT
                                     ? __float2bfloat16_rn(tat[(size_t)(row0 + r) * D.FT + c])
                                     : zero16;
      }
      __syncthreads();
      if (ct0 < NT) mma_pair(acc, chunk, LK, RT, kn, pw + (size_t)c0 * D.dp, D.dp, ct0, NT);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (r < RT && ct0 + q < NT)
          wmma::store_matrix_sync(xs + r * 16 * D.LX + (ct0 + q) * 16, acc[r][q], D.LX,
                                  wmma::mem_row_major);
  }
  __syncthreads();
  const int LS = 2 * D.LX;
  bf16* semx = reinterpret_cast<bf16*>(xs);  // (RW, LS)
  for (int rr = warp; rr < RW; rr += kWarps) {
    bf16* s16 = semx + rr * LS;
    float* z = xs + rr * D.LX;
    const size_t row = (size_t)row0 + rr;
    float mu = 0.f, inv = 0.f;
    if (rr < nr) {
      const float* p = pos + (row % D.N) * D.d;
      for (int e = lane; e < D.d; e += 32) z[e] = z[e] + pb[e] + p[e];
      __syncwarp();
      dense::ln_stats(z, D.d, mu, inv);
      if (inv_out && lane == 0) inv_out[row] = inv;
    }
    // 32 elements at a time, read before written: element e's bf16 lands on
    // float e/2 of the row, read already
    for (int e0 = 0; e0 < D.dp; e0 += 32) {
      const int e = e0 + lane;
      float s = 0.f;
      if (rr < nr && e < D.d) {
        const float h = (z[e] - mu) * inv;
        const float m = dmask ? dmask[row * D.d + e] : 1.f;
        s = rnd((h * gs[e] + bs[e]) * m * D.keep_inv, 1);
        if (xhat_out) {
          xhat_out[row * D.d + e] = h;
          semx_out[row * D.d + e] = s;
        }
      }
      __syncwarp();
      if (e < D.dp) s16[e] = __float2bfloat16_rn(s);
      __syncwarp();
    }
  }
  __syncthreads();
  float* sw = stage + warp * 256;
  const int NQ = D.HKp / 16;
  for (int ct0 = 2 * warp; ct0 < NQ; ct0 += 2 * kWarps) {
    zero_pair(acc);
    mma_pair(acc, semx, LS, RT, D.dp, wqk, D.HKp, ct0, NQ);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (r >= RT || ct0 + q >= NQ) continue;
        wmma::store_matrix_sync(sw, acc[r][q], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int rw = r * 16 + e / 16, c = (ct0 + q) * 16 + e % 16;
          if (rw < nr && c < D.HK2) qk[(size_t)(row0 + rw) * D.HK2 + c] = sw[e];
        }
        __syncwarp();
      }
  }
}

// ---------------------------------------------------------------------------
// SB helpers: one block owns target columns j0 .. j0+nj-1 of batch b
// ---------------------------------------------------------------------------

// s = md(q_i) . md(k_j) / sqrt(dk) + bias for target jj of the tile, whose
// md(k) rows kt holds transposed, (dk, 16): the 16 columns a half-warp
// scores read without bank conflicts. SC's rows_of_A runs the same FMA chain.
__device__ __forceinline__ float score(const float* __restrict__ qrow, const float* kcol,
                                       float bias, const Dims& D) {
  float dot = 0.f;
  for (int c = 0; c < D.dk; ++c) dot = fmaf(rnd(qrow[c], D.bf16), kcol[c * kCols], dot);
  return dot * D.inv_sqrt + bias;
}

__device__ __forceinline__ void put(float* p, int e, float v) { p[e] = v; }
__device__ __forceinline__ void put(bf16* p, int e, float v) { p[e] = __float2bfloat16_rn(v); }

// att (N, 16) = source-axis softmax of the tile's scores for order k, and
// A = md(cheb * att) (float32, or bf16 for the tensor cores); zero past the
// ragged edge. stats (B,K,N,2) gets each column's max and sum of exp when
// given. kt (dk, 16) gets the tile's md(k) rows transposed.
template <typename TA>
__device__ void col_softmax(int b, int k, int j0, int nj, const float* __restrict__ qk,
                            const float* __restrict__ bias, const float* __restrict__ cheb,
                            float* kt, float* att, TA* A, float* __restrict__ stats,
                            const Dims& D) {
  const int N = D.N;
  for (int e = threadIdx.x; e < kCols * D.dk; e += kThreads) {
    const int jj = e / D.dk, c = e % D.dk;
    kt[c * kCols + jj] =
        jj < nj ? rnd(qk[((size_t)b * N + j0 + jj) * D.HK2 + D.hk + k * D.dk + c], D.bf16)
                : 0.f;
  }
  __syncthreads();
  const float* bias_k = bias + (size_t)k * N * N;
  for (int e = threadIdx.x; e < N * kCols; e += kThreads) {
    const int i = e / kCols, jj = e % kCols;
    float s = 0.f;
    if (jj < nj) {
      const float* qrow = qk + ((size_t)b * N + i) * D.HK2 + k * D.dk;
      s = score(qrow, kt + jj, bias_k[(size_t)i * N + j0 + jj], D);
    }
    att[e] = s;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* cheb_k = cheb + (size_t)k * N * N;
  for (int jj = warp; jj < kCols; jj += kWarps) {
    if (jj >= nj) {
      for (int i = lane; i < N; i += 32) {
        att[i * kCols + jj] = 0.f;
        put(A, i * kCols + jj, 0.f);
      }
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
      put(A, i * kCols + jj, rnd(cheb_k[(size_t)i * N + j0 + jj] * a, D.bf16));
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
// SB backward pieces both dtypes share, per (b, 16 target columns)
// ---------------------------------------------------------------------------

// source-axis softmax backward, a warp a column jj < nj: datt (N, 16) in ds
// becomes ds = att * (datt - sum_i att*datt); dS_col (dS_k from column j0)
// gets it
__device__ __forceinline__ void softmax_bwd(int nj, const float* att, float* ds,
                                            float* __restrict__ dS_col, const Dims& D) {
  const int N = D.N, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int jj = warp; jj < nj; jj += kWarps) {
    float dot = 0.f;
    for (int i = lane; i < N; i += 32) dot = fmaf(att[i * kCols + jj], ds[i * kCols + jj], dot);
    dot = dense::warp_sum(dot);
    for (int i = lane; i < N; i += 32) {
      const float v = att[i * kCols + jj] * (ds[i * kCols + jj] - dot);
      ds[i * kCols + jj] = v;
      dS_col[(size_t)i * N + jj] = v;
    }
  }
  __syncthreads();
}

// dk_k[j] = sum_i md(ds)[i][j] md(q_k)[i] / sqrt(dk)
__device__ __forceinline__ void dk_cols(int b, int k, int j0, int nj, const float* ds,
                                        const float* __restrict__ qk, float* __restrict__ dqk,
                                        const Dims& D) {
  const int N = D.N;
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

// ---------------------------------------------------------------------------
// SB backward in float32 on the CUDA cores, per (b, 16 target columns)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sp_cols_bwd_kernel(const float* __restrict__ qk, const float* __restrict__ bias,
                   const float* __restrict__ cheb, const float* __restrict__ xm,
                   const float* __restrict__ theta, const float* __restrict__ g_out,
                   const unsigned char* __restrict__ relu_pos, float* __restrict__ daggbuf,
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

  // gm = md(g * [y > 0]) with the forward's own mask
  zero(gm, kCols * D.CoT);
  const float* gb = g_out + ((size_t)b * N + j0) * D.CoT;
  const unsigned char* pb = relu_pos + ((size_t)b * N + j0) * D.CoT;
  for (int e = threadIdx.x; e < nj * D.CoT; e += kThreads)
    gm[e] = rnd(gb[e] * (pb[e] ? 1.f : 0.f), D.bf16);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int NJt = gridDim.x;
  for (int k = 0; k < D.K; ++k) {
    col_softmax(b, k, j0, nj, qk, bias, cheb, kt, att, A, stats, D);
    aggregate(b, A, xm, agg, D);
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
    softmax_bwd(nj, att, ds, dS + ((size_t)b * D.K + k) * N * N + j0, D);
    dk_cols(b, k, j0, nj, ds, qk, dqk, D);
  }
}

// ---------------------------------------------------------------------------
// The bf16 products on the tensor cores. xb is batch row b of the padded
// bf16 xm, (Np, CTp), zero past N and past C*T.
// ---------------------------------------------------------------------------

// agg (16, CTp) = A^T . xm over the Np sources. A (Np, 16) bf16 is read
// col-major as A^T; a warp owns the 16-column tiles w, w + 8, w + 16 of
// each group of 8 * kAcc and keeps their sums in fragments over all sources.
__device__ void aggregate_wmma(const bf16* A, const bf16* __restrict__ xb, float* agg,
                               const Dims& D) {
  const int warp = threadIdx.x / 32, MT = D.CTp / 16;
  for (int g0 = warp; g0 < MT; g0 += kWarps * kAcc) {
    FragC acc[kAcc];
#pragma unroll
    for (int q = 0; q < kAcc; ++q) wmma::fill_fragment(acc[q], 0.f);
#pragma unroll 2
    for (int i0 = 0; i0 < D.Np; i0 += 16) {
      FragAt a;
      wmma::load_matrix_sync(a, A + i0 * kCols, kCols);
#pragma unroll
      for (int q = 0; q < kAcc; ++q) {
        const int mt = g0 + q * kWarps;
        if (mt < MT) {
          FragB x;
          wmma::load_matrix_sync(x, xb + (size_t)i0 * D.CTp + mt * 16, D.CTp);
          wmma::mma_sync(acc[q], a, x, acc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kAcc; ++q) {
      const int mt = g0 + q * kWarps;
      if (mt < MT) wmma::store_matrix_sync(agg + mt * 16, acc[q], D.CTp, wmma::mem_row_major);
    }
  }
  __syncthreads();
}

// dA (Np, 16) = xm . dagg^T, dagg (16, LD) bf16 read col-major as dagg^T; a
// warp owns the 16-source tiles w, w + 8, ...
__device__ void dA_wmma(const bf16* __restrict__ xb, const bf16* dagg, float* dA, const Dims& D) {
  const int warp = threadIdx.x / 32, MT = D.CTp / 16;
  for (int i0 = warp * 16; i0 < D.Np; i0 += kWarps * 16) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
    for (int mt = 0; mt < MT; ++mt) {
      FragA x;
      FragBt g;
      wmma::load_matrix_sync(x, xb + (size_t)i0 * D.CTp + mt * 16, D.CTp);
      wmma::load_matrix_sync(g, dagg + mt * 16, D.LD);
      wmma::mma_sync(acc, x, g, acc);
    }
    wmma::store_matrix_sync(dA + i0 * kCols, acc, kCols, wmma::mem_row_major);
  }
  __syncthreads();
}

// The theta products run as bf16 GEMMs over the R = 16*T rows r = (j, t)
// of the tile (theta mixes per time step, so in agg's (j, c*T + t) layout
// they contract with a stride). stage_theta writes their operands aT (R,
// Cp) = md(agg) with aT[r][c] = md(agg)[j][c, t] and thS (Cp, Cop) =
// theta_k, bf16 and zero past C and Co.
__device__ void stage_theta(int k, const float* agg, const float* __restrict__ theta, bf16* aT,
                            bf16* thS, const Dims& D) {
  for (int e = threadIdx.x; e < D.R * D.Cp; e += kThreads) {
    const int r = e / D.Cp, c = e % D.Cp;
    aT[r * D.LC + c] =
        __float2bfloat16_rn(c < D.C ? agg[(r / D.T) * D.CTp + c * D.T + r % D.T] : 0.f);
  }
  const float* th = theta + (size_t)k * D.C * D.Co;
  for (int e = threadIdx.x; e < D.Cp * D.Cop; e += kThreads) {
    const int c = e / D.Cop, o = e % D.Cop;
    thS[c * D.LO + o] = __float2bfloat16_rn(c < D.C && o < D.Co ? th[c * D.Co + o] : 0.f);
  }
  __syncthreads();
}

// The forward's mix: out (R, LF) += aT . thS, the tile's output transposed
// to rows r = (j, t), float32 in shared memory across k (a warp a 16x16
// tile, its sums loaded and stored again each k: any T fits, where sums held
// in registers across k would cap the tiles at kWarps * kAcc).
__device__ void theta_mix_wmma(const bf16* aT, const bf16* thS, float* out, const Dims& D) {
  const int warp = threadIdx.x / 32, CTt = D.Cp / 16, OTt = D.Cop / 16;
  for (int w = warp; w < (D.R / 16) * OTt; w += kWarps) {
    const int rt = w / OTt, ot = w % OTt;
    float* o = out + rt * 16 * D.LF + ot * 16;
    FragC acc;
    wmma::load_matrix_sync(acc, o, D.LF, wmma::mem_row_major);
    for (int ct = 0; ct < CTt; ++ct) {
      FragA a;
      FragB th;
      wmma::load_matrix_sync(a, aT + rt * 16 * D.LC + ct * 16, D.LC);
      wmma::load_matrix_sync(th, thS + ct * 16 * D.LO + ot * 16, D.LO);
      wmma::mma_sync(acc, a, th, acc);
    }
    wmma::store_matrix_sync(o, acc, D.LF, wmma::mem_row_major);
  }
  __syncthreads();
}

// The backward's two theta products, on gT (R, Cop) = gm with gT[r][o] =
// gm[j][o, t] besides the staged aT and thS. Per warp, a 16x16 tile of
//   dtheta_k = aT^T . gT   (Cp, Cop; aT read col-major)
//   dagg^T   = gT . thS^T  (R, Cp; thS read col-major)
// goes through the warp's 16x16 float32 staging to its place: dtheta to the
// block's partial row, md(dagg) to the (16, LD) tile in dagg's (j, c*T + t)
// layout.
__device__ void theta_wmma(const bf16* gT, const bf16* aT, const bf16* thS, float* stage,
                           bf16* dagg, float* __restrict__ part, const Dims& D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int CTt = D.Cp / 16, OTt = D.Cop / 16, RT = D.R / 16;
  const int n_dth = CTt * OTt;
  float* sw = stage + warp * 256;
  for (int w = warp; w < n_dth + RT * CTt; w += kWarps) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    if (w < n_dth) {
      const int ct = w / OTt, ot = w % OTt;
      for (int rt = 0; rt < RT; ++rt) {
        FragAt x;
        FragB g;
        wmma::load_matrix_sync(x, aT + rt * 16 * D.LC + ct * 16, D.LC);
        wmma::load_matrix_sync(g, gT + rt * 16 * D.LO + ot * 16, D.LO);
        wmma::mma_sync(acc, x, g, acc);
      }
      wmma::store_matrix_sync(sw, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int c = ct * 16 + e / 16, o = ot * 16 + e % 16;
        if (c < D.C && o < D.Co) part[c * D.Co + o] = sw[e];
      }
    } else {
      const int rt = (w - n_dth) / CTt, ct = (w - n_dth) % CTt;
      for (int ot = 0; ot < OTt; ++ot) {
        FragA g;
        FragBt th;
        wmma::load_matrix_sync(g, gT + rt * 16 * D.LO + ot * 16, D.LO);
        wmma::load_matrix_sync(th, thS + ct * 16 * D.LO + ot * 16, D.LO);
        wmma::mma_sync(acc, g, th, acc);
      }
      wmma::store_matrix_sync(sw, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = rt * 16 + e / 16, c = ct * 16 + e % 16;
        if (c < D.C) dagg[(r / D.T) * D.LD + c * D.T + r % D.T] = __float2bfloat16_rn(sw[e]);
      }
    }
    __syncwarp();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// SB forward in bfloat16, per (b, 16 target columns): agg_k and the theta mix
// on the tensor cores, the scores and softmax on the CUDA cores
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sp_cols_fwd_wmma_kernel(const float* __restrict__ qk, const float* __restrict__ bias,
                        const float* __restrict__ cheb, const bf16* __restrict__ xp,
                        const float* __restrict__ theta, float* __restrict__ y, Dims D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = D.N, Np = D.Np, b = blockIdx.y, j0 = blockIdx.x * kCols;
  const int nj = min(kCols, N - j0);
  // every region a multiple of 32 bytes, so each WMMA tile starts aligned
  float* kt = reinterpret_cast<float*>(smem);              // (dk, 16)
  float* att = kt + kCols * D.dk;                           // (Np, 16)
  float* agg = att + Np * kCols;                            // (16, CTp)
  float* out = agg + kCols * D.CTp;                         // (R, LF)
  bf16* A = reinterpret_cast<bf16*>(out + D.R * D.LF);      // (Np, 16)
  bf16* aT = A + Np * kCols;                                // (R, LC)
  bf16* thS = aT + D.R * D.LC;                              // (Cp, LO)
  for (int e = N * kCols + threadIdx.x; e < Np * kCols; e += kThreads)
    A[e] = __float2bfloat16_rn(0.f);  // the padded sources add nothing
  zero(out, D.R * D.LF);
  const bf16* xb = xp + (size_t)b * Np * D.CTp;
  for (int k = 0; k < D.K; ++k) {
    col_softmax(b, k, j0, nj, qk, bias, cheb, kt, att, A, nullptr, D);
    aggregate_wmma(A, xb, agg, D);
    stage_theta(k, agg, theta, aT, thS, D);
    theta_mix_wmma(aT, thS, out, D);
  }
  float* yb = y + ((size_t)b * N + j0) * D.CoT;
  for (int e = threadIdx.x; e < nj * D.CoT; e += kThreads) {
    const int jj = e / D.CoT, om = e % D.CoT, o = om / D.T, t = om % D.T;
    yb[e] = fmaxf(out[(jj * D.T + t) * D.LF + o], 0.f);
  }
}

// ---------------------------------------------------------------------------
// SB backward in bfloat16, per (b, 16 target columns): agg_k, dA and the
// theta products on the tensor cores; dagg_k (bf16, (Np, CTp) a k, zero past
// N and C*T) for SC
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sp_cols_bwd_wmma_kernel(const float* __restrict__ qk, const float* __restrict__ bias,
                        const float* __restrict__ cheb, const bf16* __restrict__ xp,
                        const float* __restrict__ theta, const float* __restrict__ g_out,
                        const unsigned char* __restrict__ relu_pos, bf16* __restrict__ daggbuf,
                        float* __restrict__ dS, float* __restrict__ dqk,
                        float* __restrict__ dth_part, float* __restrict__ stats, Dims D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = D.N, Np = D.Np, b = blockIdx.y, jt = blockIdx.x, j0 = jt * kCols;
  const int nj = min(kCols, N - j0);
  // every region a multiple of 32 bytes, so each WMMA tile starts aligned
  float* kt = reinterpret_cast<float*>(smem);             // (dk, 16)
  float* att = kt + kCols * D.dk;                          // (Np, 16)
  float* ds = att + Np * kCols;                            // (Np, 16): dA, datt, ds
  float* agg = ds + Np * kCols;                            // (16, CTp)
  float* stage = agg + kCols * D.CTp;                      // 8 x (16, 16)
  bf16* A = reinterpret_cast<bf16*>(stage + kWarps * 256);  // (Np, 16)
  bf16* dagg = A + Np * kCols;                             // (16, LD)
  bf16* gT = dagg + kCols * D.LD;                          // (R, LO)
  bf16* aT = gT + D.R * D.LO;                              // (R, LC)
  bf16* thS = aT + D.R * D.LC;                             // (Cp, LO)
  const bf16 zero16 = __float2bfloat16_rn(0.f);
  // zero what no k writes: A past N (the padded sources add nothing), dagg
  // past C*T
  for (int e = N * kCols + threadIdx.x; e < Np * kCols; e += kThreads) A[e] = zero16;
  for (int e = threadIdx.x; e < kCols * (D.CTp - D.CT); e += kThreads)
    dagg[(e / (D.CTp - D.CT)) * D.LD + D.CT + e % (D.CTp - D.CT)] = zero16;
  // gT = md(g * [y > 0]) with the forward's own mask, zero past nj and Co
  const size_t o0 = ((size_t)b * N + j0) * D.CoT;
  for (int e = threadIdx.x; e < D.R * D.Cop; e += kThreads) {
    const int r = e / D.Cop, o = e % D.Cop, jj = r / D.T, t = r % D.T;
    float v = 0.f;
    if (jj < nj && o < D.Co) {
      const size_t g = o0 + (size_t)jj * D.CoT + o * D.T + t;
      v = g_out[g] * (relu_pos[g] ? 1.f : 0.f);
    }
    gT[r * D.LO + o] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  const bf16* xb = xp + (size_t)b * Np * D.CTp;
  for (int k = 0; k < D.K; ++k) {
    col_softmax(b, k, j0, nj, qk, bias, cheb, kt, att, A, stats, D);
    aggregate_wmma(A, xb, agg, D);
    stage_theta(k, agg, theta, aT, thS, D);
    theta_wmma(gT, aT, thS, stage, dagg,
               dth_part + (((size_t)b * gridDim.x + jt) * D.K + k) * D.C * D.Co, D);
    bf16* db = daggbuf + (((size_t)b * D.K + k) * Np + j0) * D.CTp;
    for (int e = threadIdx.x; e < kCols * D.CTp; e += kThreads)
      db[e] = dagg[(e / D.CTp) * D.LD + e % D.CTp];
    dA_wmma(xb, dagg, ds, D);
    const float* cheb_k = cheb + (size_t)k * N * N;
    for (int e = threadIdx.x; e < N * kCols; e += kThreads) {
      const int jj = e % kCols;
      if (jj < nj) ds[e] *= cheb_k[(size_t)(e / kCols) * N + j0 + jj];
    }
    __syncthreads();
    softmax_bwd(nj, att, ds, dS + ((size_t)b * D.K + k) * N * N + j0, D);
    dk_cols(b, k, j0, nj, ds, qk, dqk, D);
  }
}

// ---------------------------------------------------------------------------
// SC: dxm and dq for 16 source rows of batch b
// ---------------------------------------------------------------------------

// krT (dk, N) = md(k_k) of every target, transposed, then At (N, 16) with
// At[j][ii] = md(A_k)[i0+ii][j], rebuilt from the column stats SB saved
// (the scores in SB's FMA order); zero past ni. A warp takes a source row
// and its lanes the targets: the bias, Chebyshev and krT reads coalesce.
template <typename TA>
__device__ void rows_of_A(int b, int k, int i0, int ni, const float* __restrict__ qk,
                          const float* __restrict__ bias, const float* __restrict__ cheb,
                          const float* __restrict__ stats, float* krT, TA* At, const Dims& D) {
  const int N = D.N;
  for (int e = threadIdx.x; e < N * D.dk; e += kThreads) {
    const int j = e / D.dk, c = e % D.dk;
    krT[c * N + j] = rnd(qk[((size_t)b * N + j) * D.HK2 + D.hk + k * D.dk + c], D.bf16);
  }
  __syncthreads();
  const float* st = stats + ((size_t)b * D.K + k) * N * 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int ii = warp; ii < kRows; ii += kWarps) {
    const int i = i0 + ii;
    if (ii >= ni) {
      for (int j = lane; j < N; j += 32) put(At, j * kRows + ii, 0.f);
      continue;
    }
    const float* qrow = qk + ((size_t)b * N + i) * D.HK2 + k * D.dk;
    const float* bias_i = bias + ((size_t)k * N + i) * N;
    const float* cheb_i = cheb + ((size_t)k * N + i) * N;
    for (int j = lane; j < N; j += 32) {
      float dot = 0.f;  // score's FMA chain, on krT's column j
      for (int c = 0; c < D.dk; ++c) dot = fmaf(rnd(qrow[c], D.bf16), krT[c * N + j], dot);
      const float s = dot * D.inv_sqrt + bias_i[j];
      put(At, j * kRows + ii, rnd(cheb_i[j] * (expf(s - st[2 * j]) / st[2 * j + 1]), D.bf16));
    }
  }
  __syncthreads();
}

// dq_k[i] = sum_j md(ds)[i][j] md(k_k)[j] / sqrt(dk) for the block's rows
__device__ __forceinline__ void dq_rows(int b, int k, int i0, int ni, const float* __restrict__ dS,
                                        const float* krT, float* __restrict__ dqk,
                                        const Dims& D) {
  const int N = D.N;
  const float* dSk = dS + ((size_t)b * D.K + k) * N * N;
  for (int e = threadIdx.x; e < ni * D.dk; e += kThreads) {
    const int ii = e / D.dk, c = e % D.dk;
    const float* dsr = dSk + (size_t)(i0 + ii) * N;
    const float* kc = krT + c * N;
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < N; ++j) acc = fmaf(rnd(__ldg(dsr + j), D.bf16), kc[j], acc);
    dqk[((size_t)b * N + i0 + ii) * D.HK2 + k * D.dk + c] = acc * D.inv_sqrt;
  }
}

__global__ void __launch_bounds__(kThreads)
sp_rows_bwd_kernel(const float* __restrict__ qk, const float* __restrict__ bias,
                   const float* __restrict__ cheb, const float* __restrict__ stats,
                   const float* __restrict__ daggbuf, const float* __restrict__ dS,
                   float* __restrict__ dxm, float* __restrict__ dqk, Dims D) {
  extern __shared__ __align__(16) float sm[];
  const int N = D.N, b = blockIdx.y, i0 = blockIdx.x * kRows;
  const int ni = min(kRows, N - i0);
  float* krT = sm;                   // (dk, N) md(k_k) of every target
  float* At = krT + pad4(N * D.dk);  // (N, 16): At[j][ii] = A_k[i0+ii][j]
  float* acc_s = At + N * kRows;     // (16, CT)
  zero(acc_s, kRows * D.CT);
  for (int k = 0; k < D.K; ++k) {
    rows_of_A(b, k, i0, ni, qk, bias, cheb, stats, krT, At, D);
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
    dq_rows(b, k, i0, ni, dS, krT, dqk, D);
    __syncthreads();
  }
  float* out = dxm + ((size_t)b * N + i0) * D.CT;
  for (int e = threadIdx.x; e < ni * D.CT; e += kThreads) out[e] = acc_s[e];
}

// SC in bfloat16: dxm += md(A_k) . dagg_k on the tensor cores, the block's
// (16, CTp) sums kept in shared memory across k; A_k's rows read col-major
// from At, dagg_k as fragments from device memory. dq on the CUDA cores.
__global__ void __launch_bounds__(kThreads)
sp_rows_bwd_wmma_kernel(const float* __restrict__ qk, const float* __restrict__ bias,
                        const float* __restrict__ cheb, const float* __restrict__ stats,
                        const bf16* __restrict__ daggbuf, const float* __restrict__ dS,
                        float* __restrict__ dxm, float* __restrict__ dqk, Dims D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = D.N, Np = D.Np, CTp = D.CTp, b = blockIdx.y, i0 = blockIdx.x * kRows;
  const int ni = min(kRows, N - i0);
  float* acc_s = reinterpret_cast<float*>(smem);             // (16, CTp)
  bf16* At = reinterpret_cast<bf16*>(acc_s + kRows * CTp);    // (Np, 16)
  float* krT = reinterpret_cast<float*>(At + Np * kRows);     // (dk, N)
  for (int e = N * kRows + threadIdx.x; e < Np * kRows; e += kThreads)
    At[e] = __float2bfloat16_rn(0.f);  // the padded targets add nothing
  zero(acc_s, kRows * CTp);
  const int warp = threadIdx.x / 32, MT = CTp / 16;
  for (int k = 0; k < D.K; ++k) {
    rows_of_A(b, k, i0, ni, qk, bias, cheb, stats, krT, At, D);
    const bf16* dg = daggbuf + ((size_t)b * D.K + k) * Np * CTp;
    for (int g0 = warp; g0 < MT; g0 += kWarps * kAcc) {
      FragC acc[kAcc];
#pragma unroll
      for (int q = 0; q < kAcc; ++q) {
        const int mt = g0 + q * kWarps;
        if (mt < MT) wmma::load_matrix_sync(acc[q], acc_s + mt * 16, CTp, wmma::mem_row_major);
      }
#pragma unroll 2
      for (int j0 = 0; j0 < Np; j0 += 16) {
        FragAt a;
        wmma::load_matrix_sync(a, At + j0 * kRows, kRows);
#pragma unroll
        for (int q = 0; q < kAcc; ++q) {
          const int mt = g0 + q * kWarps;
          if (mt < MT) {
            FragB y;
            wmma::load_matrix_sync(y, dg + (size_t)j0 * CTp + mt * 16, CTp);
            wmma::mma_sync(acc[q], a, y, acc[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kAcc; ++q) {
        const int mt = g0 + q * kWarps;
        if (mt < MT) wmma::store_matrix_sync(acc_s + mt * 16, acc[q], CTp, wmma::mem_row_major);
      }
    }
    dq_rows(b, k, i0, ni, dS, krT, dqk, D);
    __syncthreads();
  }
  float* out = dxm + ((size_t)b * N + i0) * D.CT;
  for (int e = threadIdx.x; e < ni * D.CT; e += kThreads)
    out[e] = acc_s[(e / D.CT) * CTp + e % D.CT];
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

size_t sa_wmma_smem(const Dims& D, int rows) {
  return sizeof(float) * ((size_t)rows * D.LX + kWarps * 256) +
         sizeof(bf16) * (size_t)rows * (kKC + 8);
}

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
  D.Np = pad16(N);
  D.CTp = pad16(D.CT);
  D.Cp = pad16(C);
  D.Cop = pad16(Co);
  D.R = kCols * T;
  D.LD = D.CTp + 8;
  D.LC = D.Cp + 8;
  D.LO = D.Cop + 8;
  D.LF = D.Cop + 4;
  D.FTp = pad16(FT);
  D.dp = pad16(d);
  D.HKp = pad16(D.HK2);
  D.LX = D.dp + 4;
  D.RW = sa_wmma_smem(D, 32) <= kSmemMax ? 32 : 16;
  D.keep_inv = static_cast<float>(1.0 / static_cast<double>(keep));
  D.inv_sqrt = static_cast<float>(1.0 / sqrt(static_cast<double>(dk)));
  return D;
}

// float32: the (16, FT) tat rows and (16, d) x_tat; bf16: x_tat (RW, LX)
// and the warps' staging in float32, the md(tat) chunk (RW, kKC + 8) in bf16
size_t sa_smem(const Dims& D) {
  return D.bf16 ? sa_wmma_smem(D, D.RW) : sizeof(float) * kRows * (D.FT + D.d);
}
// float32: kt, att, A (N, 16), agg (16, CT), out (16, CoT); bf16: kt, att
// (Np, 16), agg (16, CTp) and out (R, LF) in float32, A (Np, 16), aT (R,
// LC) and thS (Cp, LO) in bf16
size_t sb_fwd_smem(const Dims& D) {
  if (D.bf16)
    return sizeof(float) * ((size_t)kCols * D.dk + (size_t)D.Np * kCols + kCols * D.CTp +
                            (size_t)D.R * D.LF) +
           sizeof(bf16) * ((size_t)D.Np * kCols + (size_t)D.R * D.LC + D.Cp * D.LO);
  return sizeof(float) * ((size_t)kCols * D.dk + 2 * (size_t)D.N * kCols + kCols * D.CT +
                          kCols * D.CoT);
}
// float32: kt, att, A, ds (N, 16), agg, dagg (16, CT), gm (16, CoT); bf16:
// kt, att, ds (Np, 16), agg (16, CTp) and the warps' staging in float32,
// A (Np, 16), dagg (16, LD), gT (R, LO), aT (R, LC) and thS (Cp, LO) in bf16
size_t sb_bwd_smem(const Dims& D) {
  if (D.bf16)
    return sizeof(float) * ((size_t)kCols * D.dk + 2 * (size_t)D.Np * kCols + kCols * D.CTp +
                            kWarps * 256) +
           sizeof(bf16) * ((size_t)D.Np * kCols + kCols * D.LD + (size_t)D.R * (D.LO + D.LC) +
                           D.Cp * D.LO);
  return sizeof(float) * ((size_t)kCols * D.dk + 3 * (size_t)D.N * kCols + 2 * kCols * D.CT +
                          kCols * D.CoT);
}
// float32: krT (dk, N), At (N, 16), the (16, CT) sums; bf16: the (16, CTp)
// sums and krT in float32, At (Np, 16) in bf16
size_t sc_smem(const Dims& D) {
  if (D.bf16)
    return sizeof(float) * ((size_t)kRows * D.CTp + (size_t)D.N * D.dk) +
           sizeof(bf16) * (size_t)D.Np * kRows;
  return sizeof(float) * ((size_t)pad4(D.N * D.dk) + (size_t)D.N * kRows + kRows * D.CT);
}
size_t sd_smem(const Dims& D) { return sizeof(float) * kRows * (D.HK2 + D.d); }

// the backward's workspace layout (floats), every region on 256 bytes (the
// bf16 dagg_k planes are read as WMMA fragments). dagg_k is (B, K, N, CT)
// float32, or (B, K, Np, CTp) bf16.
struct BwdSpace {
  size_t qk, semx, xhat, inv, dagg, dS, dqk, dse, vec, part, stats, scratch, total;
};

BwdSpace bwd_space(const Dims& D) {
  const size_t BN = (size_t)D.B * D.N;
  const int NJt = (D.N + kCols - 1) / kCols;
  const auto up = [](size_t n) { return (n + 63) & ~(size_t)63; };
  const size_t dagg = D.bf16 ? (size_t)D.B * D.K * D.Np * D.CTp / 2 : BN * D.K * D.CT;
  BwdSpace s;
  s.qk = 0;
  s.semx = up(s.qk + BN * D.HK2);
  s.xhat = up(s.semx + BN * D.d);
  s.inv = up(s.xhat + BN * D.d);
  s.dagg = up(s.inv + BN);
  s.dS = up(s.dagg + dagg);
  s.dqk = up(s.dS + BN * D.K * D.N);
  s.dse = up(s.dqk + BN * D.HK2);
  s.vec = up(s.dse + BN * D.d);
  s.part = up(s.vec + BN * 2 * D.d);
  s.stats = up(s.part + (size_t)D.B * NJt * D.K * D.C * D.Co);
  s.scratch = up(s.stats + BN * D.K * 2);
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

// SA for the forward (qk) and the backward (qk, semx, x_hat, 1/std): in
// bf16 on the tensor cores from pw16, wqk16, else on the CUDA cores
cudaError_t launch_sa(const float* tat, const float* pw, const bf16* pw16, const float* pb,
                      const float* pos, const float* gs, const float* bs, const float* wqk,
                      const bf16* wqk16, const float* dmask, float* qk, float* semx,
                      float* xhat, float* inv, const Dims& D, cudaStream_t st) {
  const size_t smem = sa_smem(D);
  cudaError_t err;
  if (D.bf16) {
    if ((err = dense::allow_smem(sp_embed_wmma_kernel, smem)) != cudaSuccess) return err;
    const int blocks = (D.B * D.N + D.RW - 1) / D.RW;
    sp_embed_wmma_kernel<<<blocks, kThreads, smem, st>>>(tat, pw16, pb, pos, gs, bs, wqk16,
                                                         dmask, qk, semx, xhat, inv, D);
  } else {
    if ((err = dense::allow_smem(sp_embed_kernel, smem)) != cudaSuccess) return err;
    const dim3 grid((D.N + kRows - 1) / kRows, D.B);
    sp_embed_kernel<<<grid, kThreads, smem, st>>>(tat, pw, pb, pos, gs, bs, wqk, dmask, qk,
                                                  semx, xhat, inv, D);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the forward's (qk) and the backward's workspace.
size_t spatial_fused_workspace_floats(int B, int N, int FT, int C, int T, int Co, int d,
                                      int K, int dk, int backward, int bf16) {
  const Dims D = make_dims(B, N, FT, C, T, Co, d, K, dk, 1.f, bf16);
  return backward ? bwd_space(D).total : (size_t)B * N * D.HK2;
}

// Bytes of shared memory a block of each kernel requests: 0 SA, 1 SB
// forward, 2 SB backward, 3 SC, 4 SD; SA and both SB and SC in the bf16
// (tensor-core) layout when bf16 is set.
size_t spatial_fused_smem_bytes(int N, int FT, int C, int T, int Co, int d, int K, int dk,
                                int kernel, int bf16) {
  const Dims D = make_dims(1, N, FT, C, T, Co, d, K, dk, 1.f, bf16);
  switch (kernel) {
    case 0: return sa_smem(D);
    case 1: return sb_fwd_smem(D);
    case 2: return sb_bwd_smem(D);
    case 3: return sc_smem(D);
    default: return sd_smem(D);
  }
}

// Forward: y (B, N, Co*T) float32. dmask (B, N, d) of 0/1 or null (no
// dropout). With bf16 set both passes run on the tensor cores and read the
// wrapper's bf16 copies, zero-padded to multiples of 16: xm_pad (B, Np,
// CTp), pw_pad (FTp, dp), wqk_pad (dp, HKp); otherwise those are unused.
// Returns cudaGetLastError().
int spatial_fused_forward(const float* tat, const float* xm, const float* dmask,
                          const float* pw, const float* pb, const float* pos, const float* gs,
                          const float* bs, const float* wqk, const float* bias,
                          const float* cheb, const float* theta, const void* xm_pad,
                          const void* pw_pad, const void* wqk_pad, float* y, float* ws, int B,
                          int N, int FT, int C, int T, int Co, int d, int K, int dk,
                          float keep, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims D = make_dims(B, N, FT, C, T, Co, d, K, dk, keep, bf16);
  const auto* pw16 = static_cast<const wm::bf16*>(pw_pad);
  const auto* wqk16 = static_cast<const wm::bf16*>(wqk_pad);
  cudaError_t err = launch_sa(tat, pw, pw16, pb, pos, gs, bs, wqk, wqk16, dmask, ws, nullptr,
                              nullptr, nullptr, D, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sb_fwd_smem(D);
  const dim3 grid((N + kCols - 1) / kCols, B);
  if (bf16) {
    if ((err = dense::allow_smem(sp_cols_fwd_wmma_kernel, smem)) != cudaSuccess)
      return static_cast<int>(err);
    sp_cols_fwd_wmma_kernel<<<grid, kThreads, smem, st>>>(
        ws, bias, cheb, static_cast<const wm::bf16*>(xm_pad), theta, y, D);
  } else {
    if ((err = dense::allow_smem(sp_cols_fwd_kernel, smem)) != cudaSuccess)
      return static_cast<int>(err);
    sp_cols_fwd_kernel<<<grid, kThreads, smem, st>>>(ws, bias, cheb, xm, theta, y, D);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward: dtat (B,N,FT), dxm (B,N,C*T); dpw (FT,d), dvec (3,d) = [dpb,
// dgs, dbs], dpos (N,d), dwqk (d,2Kdk), dbias (K,N,N), dtheta (K,C,Co), all
// summed over b in a fixed order. pw_t (d,FT) and wqk_t (2Kdk,d) are the
// transposed weights. relu_pos (B,N,Co*T) holds 1 where the forward's
// float32 output was > 0, else 0. With bf16 set the SA, SB and SC passes
// run on the tensor cores and read the forward's bf16 copies xm_pad,
// pw_pad and wqk_pad; otherwise those are unused. `ws` holds
// spatial_fused_workspace_floats(..., 1, bf16).
int spatial_fused_backward(const float* tat, const float* xm, const float* dmask,
                           const float* pw, const float* pw_t, const float* pb,
                           const float* pos, const float* gs, const float* bs,
                           const float* wqk, const float* wqk_t, const float* bias,
                           const float* cheb, const float* theta, const float* g_out,
                           const unsigned char* relu_pos, const void* xm_pad,
                           const void* pw_pad, const void* wqk_pad, float* dtat,
                           float* dxm, float* dpw, float* dvec, float* dpos, float* dwqk,
                           float* dbias, float* dtheta, float* ws, int B, int N,
                           int FT, int C, int T, int Co, int d, int K, int dk, float keep,
                           int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims D = make_dims(B, N, FT, C, T, Co, d, K, dk, keep, bf16);
  const BwdSpace s = bwd_space(D);
  const int BN = B * N, NJt = (N + kCols - 1) / kCols, NIt = (N + kRows - 1) / kRows;
  const auto* pw16 = static_cast<const wm::bf16*>(pw_pad);
  const auto* wqk16 = static_cast<const wm::bf16*>(wqk_pad);
  cudaError_t err = launch_sa(tat, pw, pw16, pb, pos, gs, bs, wqk, wqk16, dmask, ws + s.qk,
                              ws + s.semx, ws + s.xhat, ws + s.inv, D, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  // SB and SC: bf16 on the tensor cores, float32 on the CUDA cores
  size_t smem = sb_bwd_smem(D);
  wm::bf16* dagg16 = reinterpret_cast<wm::bf16*>(ws + s.dagg);
  if (bf16) {
    err = dense::allow_smem(sp_cols_bwd_wmma_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sp_cols_bwd_wmma_kernel<<<dim3(NJt, B), kThreads, smem, st>>>(
        ws + s.qk, bias, cheb, static_cast<const wm::bf16*>(xm_pad), theta, g_out, relu_pos,
        dagg16, ws + s.dS, ws + s.dqk, ws + s.part, ws + s.stats, D);
  } else {
    err = dense::allow_smem(sp_cols_bwd_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sp_cols_bwd_kernel<<<dim3(NJt, B), kThreads, smem, st>>>(
        ws + s.qk, bias, cheb, xm, theta, g_out, relu_pos, ws + s.dagg, ws + s.dS, ws + s.dqk,
        ws + s.part, ws + s.stats, D);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  smem = sc_smem(D);
  if (bf16) {
    err = dense::allow_smem(sp_rows_bwd_wmma_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sp_rows_bwd_wmma_kernel<<<dim3(NIt, B), kThreads, smem, st>>>(
        ws + s.qk, bias, cheb, ws + s.stats, dagg16, ws + s.dS, dxm, ws + s.dqk, D);
  } else {
    err = dense::allow_smem(sp_rows_bwd_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sp_rows_bwd_kernel<<<dim3(NIt, B), kThreads, smem, st>>>(
        ws + s.qk, bias, cheb, ws + s.stats, ws + s.dagg, ws + s.dS, dxm, ws + s.dqk, D);
  }
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
