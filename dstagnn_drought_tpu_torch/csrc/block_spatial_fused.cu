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
// it; at PEMS07 (N=883) the N^2*C*T products are ~27x that. The TPU kernel
// held a row's whole pipeline in VMEM; a block here has 227 KB, and a
// row's (N, N) planes outgrow it past a few hundred nodes. So the work is
// split as flash attention splits it, for a softmax over the source axis:
// every pass streams the axis it reduces in tiles, and no block holds
// anything whose size is set by N, F*T or C*T. Its shared memory is set by
// the tiles, the staged d_k columns, d and the chunk: Cc channels (C in the
// fewest chunks of at most kChunkCols = 384) and Tc time steps whose Cc*Tc
// and Coc*Tc columns fit 384 (the theta mix works per time step, so
// chunking T is exact; Co in chunks of Coc likewise). Where a width does
// not fit whole, it is taken in chunks: C (the theta mix summed over the
// chunks in order) and Co (the forward's chunks across blocks, the
// backward's dagg sums over them in shared memory), d_k in the score
// passes (128 columns at a time, each score's chain run on through the
// chunks), d in SA and SD (1024 columns at a time, on the CUDA cores in
// both dtypes; the LayerNorm statistics merged by Chan's formula, SD's row
// sums over the chunks). A shape that fits whole runs the whole layout.
//   forward  SA (rows of (b, i)): pre_conv (F*T in chunks), LN, dropout, QK
//               -> qk (B, N, 2Kdk)
//            stats (b, k, 16 target columns): streams the sources 64 at a
//               time, recomputes s and keeps each column's running max and
//               sum of exp -> (B, K, N, 2)
//            cols (b, 16 target columns, time chunk): for each k streams the
//               sources 64 at a time, forms A_k from the stats, accumulates
//               agg_k = A_k^T . xm over the chunk's columns, then the theta
//               mix of the chunk's time steps; ReLU on the way out.
//               (B, K, N, N) never reaches memory.
//   backward SA again (saving semx, x_hat, 1/std); stats again;
//            cols_bwd (b, target tile, chunk): agg_k again, the dtheta
//               partial, dagg = (ReLU-masked g) . theta^T (written for the
//               later passes) and delta_j = dagg_j . agg_j over the chunk's
//               columns: delta_j = sum_i att_ij cheb_ij dA_ij (flash
//               attention's D = rowsum(dO o O)), so no pass over the sources
//               is needed for it; agg is recomputed, not saved, and delta
//               costs (B, K, chunks, N) floats. The softmax backward sums
//               with float32 att, so in bf16 delta takes the aggregation
//               of the unrounded A: md(A)'s and A's lo terms' products,
//               kept apart (the Theta gradient takes md(A)'s alone);
//            ds (target tile, k, source range; b inside, in order):
//               dA = xm . dagg^T over all of C*T, ds = att (cheb dA -
//               delta_j), dbias += ds (its (K, N, N) planes summed over b in
//               the block, in order of b), ds to memory for the row pass,
//               and the dk partial of the source range;
//            dq (b, k, 16 source rows): dq = md(ds) . md(k) streamed over
//               the targets; dk: the source ranges' partials summed in order;
//            rows (b, 16 source rows, chunk): dxm = sum_k A_k . dagg_k,
//               streaming the targets 64 at a time with A_k rebuilt from the
//               stats;
//            SD (b, 16 rows): dsemx, dropout and LN backward, dtat;
//            then the weight gradients, summed over b in a fixed order:
//               dpw = tat^T dse, dwqk = semx^T dqk (split-row products),
//               dtheta, dpos, dpb, dgs, dbs (row sums). No float atomics:
//               two launches give the same bits.
// The ReLU mask comes from the forward: the wrapper keeps where the forward
// kernel's float32 output was > 0 (one byte an element) and cols_bwd reads
// it, so the backward never recomputes the pre-ReLU output. JAX recomputes
// it inside its backward kernel with the forward's own arithmetic; here a
// recomputed value within rounding of 0 could flip the mask (one flipped
// element changes a whole batch row's gradients). The forward's record
// keeps the backward consistent with the output autograd saw, as
// torch.relu's backward reads its output.
//
// The three N^2*C*T products (agg, dA, dxm) run on the tensor cores in both
// dtypes (nvcuda::wmma bf16 16x16x16 fragments, float32 sums): A_k (a tile
// at a time, in shared memory) and the wrapper's copies of xm, laid out by
// time chunk as (B, chunks, Np, C*Tc padded to 16) bf16, zero outside, and
// dagg (the same layout, a k each, written by cols_bwd) read as fragments
// straight from device memory (L2). In bfloat16 each operand is md()-exact
// already, so one product; in float32 each operand is split into bf16 hi +
// lo (wm::split) and each product is three (hi.hi + hi.lo + lo.hi), float32
// in value to about 2^-17. The scores, the softmax and its backward, the
// theta mix and its backward, dk and dq stay float32 FMAs on the CUDA cores;
// every pass computes a score with the same FMA chain on the same md()
// values, so the stats, att and A agree bit for bit across passes. SA runs
// on the tensor cores in bf16 (sp_embed_wmma_kernel) and on the CUDA cores
// in float32, as does SD.

#include "dense_common.cuh"
#include "wmma_common.cuh"

namespace {

using namespace wm;
using dense::kThreads;
using dense::kWarps;
using dense::rnd;

constexpr int kRows = 16;  // source rows a block (SA in float32, dq, rows, SD)
constexpr int kCols = 16;  // target columns a block (stats, cols, cols_bwd, ds)
constexpr int kSrc = 64;   // sources a column pass streams a step
constexpr int kTgt = 64;   // targets the row passes stream a step
constexpr int kAcc = 3;    // 16-column accumulator tiles a warp holds (WMMA)
constexpr int kChunkCols = kWarps * kAcc * 16;  // 384: the most columns of a time chunk
constexpr int kFC = 128;   // tat columns a float32 SA block takes a step
constexpr int kDkC = 128;  // d_k columns the score passes stage a time where d_k is chunked
constexpr int kDC = 1024;  // d columns a chunked SA or SD block holds at a time
constexpr int kHC = 512;   // 2*K*dk columns a chunked SD block stages at a time
constexpr int kSms = 132;  // an H100's SMs
constexpr size_t kSmemMax = 232448;  // shared memory a block may have (227 KB)

__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) & ~15; }

// Cc channels a chunk, nCc chunks: C itself up to kChunkCols, else split
// evenly into the fewest chunks of at most kChunkCols (Co likewise)
__host__ __device__ inline void channel_chunks(int C, int& Cc, int& nCc) {
  nCc = (C + kChunkCols - 1) / kChunkCols;
  if (nCc < 1) nCc = 1;
  Cc = (C + nCc - 1) / nCc;
}

// Tc time steps a chunk, nTc chunks: the most steps whose Cc*Tc and Co_c*Tc
// columns fit kChunkCols (Cc, Co_c the channel chunks), then balanced over
// the chunks
__host__ __device__ inline void time_chunks(int T, int C, int Co, int& Tc, int& nTc) {
  int Cc, Coc, n;
  channel_chunks(C, Cc, n);
  channel_chunks(Co, Coc, n);
  const int w = Cc > Coc ? Cc : Coc;
  int most = kChunkCols / (w > 0 ? w : 1);
  if (most < 1) most = 1;
  if (most > T) most = T;
  nTc = (T + most - 1) / most;
  Tc = (T + nTc - 1) / nTc;
}

// dkc the d_k columns the score passes stage at a time (d_k itself, or
// kDkC where the whole of d_k does not fit their blocks); LQ and LK the rows
// of the staged query and key tiles (dkc rounded up to 4; the keys' 4
// floats more). The bf16 SA tiles: FTp, dp, HKp are F*T, d, 2*K*dk rounded
// up to 16, LX the row of its float32 x_tat (a multiple of 4), RW its rows
// a block; sa_split, sd_split where SA and SD take d in chunks of DC (and
// SD 2*K*dk in chunks of HC). The chunk layout: Cc channels (nCc chunks of
// C), Coc output channels (nCoc chunks of Co), Tc steps a time chunk (nTc),
// nCh = nTc*nCc chunks (chunk ch = time chunk ch / nCc, channel chunk ch %
// nCc), CTc = Cc*Tc columns (CTcp rounded up to 16), CoTc = Coc*Tc; Npad =
// N rounded up to kSrc (the rows of the chunked copies); NJt, NIt target
// and source tiles of 16, nST source steps of kSrc, S the source ranges of
// the ds pass.
struct Dims {
  int B, N, FT, CT, T, C, Co, CoT, d, K, dk, hk, HK2, bf16, LQ, LK, dkc;
  int Tc, nTc, Cc, nCc, Coc, nCoc, nCh, CTc, CTcp, CoTc, Npad, NJt, NIt, nST, S;
  int FTp, dp, HKp, LX, RW, sa_split, sd_split, DC, HC;
  float keep_inv, inv_sqrt;
};

// ---------------------------------------------------------------------------
// SA: pre_conv -> +pos, LN -> dropout -> QK for 16 source rows of batch b
// (float32 on the CUDA cores; tat's F*T columns kFC at a time)
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
  float* tt = sm;                 // (R, kFC)
  float* xs = tt + kRows * kFC;   // (R, d)
  const size_t row0 = (size_t)b * D.N + i0;
  for (int c0 = 0; c0 < D.FT; c0 += kFC) {
    const int kn = min(kFC, D.FT - c0);
    __syncthreads();  // the last chunk is consumed
    for (int e = threadIdx.x; e < R * kn; e += kThreads)
      tt[(e / kn) * kFC + e % kn] = rnd(tat[(row0 + e / kn) * D.FT + c0 + e % kn], D.bf16);
    __syncthreads();
    if (c0 == 0)
      dense::rows_x_mat<16>(tt, kFC, R, kn, pw, D.d, D.d, xs, D.d);
    else
      dense::rows_x_mat<16, true>(tt, kFC, R, kn, pw + (size_t)c0 * D.d, D.d, D.d, xs, D.d);
  }
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
// SA with d in chunks (sa_split: x_tat's row too wide for a block), both
// dtypes on the CUDA cores, 16 source rows of batch b: x_tat's columns a
// chunk of DC at a time (tat's F*T columns kFC at a time), each chunk's
// LayerNorm statistics merged into the rows' (Chan), then each chunk formed
// again, normalised, and its share of qk = semx . wqk added in place
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sp_embed_chunk_kernel(const float* __restrict__ tat, const float* __restrict__ pw,
                      const float* __restrict__ pb, const float* __restrict__ pos,
                      const float* __restrict__ gs, const float* __restrict__ bs,
                      const float* __restrict__ wqk, const float* __restrict__ dmask,
                      float* __restrict__ qk, float* __restrict__ semx_out,
                      float* __restrict__ xhat_out, float* __restrict__ inv_out, Dims D) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.y, i0 = blockIdx.x * kRows, DC = D.DC;
  const int R = min(kRows, D.N - i0), warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* tt = sm;                 // (R, kFC)
  float* xs = tt + kRows * kFC;   // (R, DC)
  float* rs = xs + kRows * DC;    // (R, 2): mean, m2
  const size_t row0 = (size_t)b * D.N + i0;
  // x_tat's columns [c0, c0 + cn) + pb + pos into xs, the same sequence every call
  auto embed_chunk = [&](int c0, int cn) {
    for (int f0 = 0; f0 < D.FT; f0 += kFC) {
      const int kn = min(kFC, D.FT - f0);
      __syncthreads();  // the last chunk is consumed
      for (int e = threadIdx.x; e < R * kn; e += kThreads)
        tt[(e / kn) * kFC + e % kn] = rnd(tat[(row0 + e / kn) * D.FT + f0 + e % kn], D.bf16);
      __syncthreads();
      if (f0 == 0)
        dense::rows_x_mat<16>(tt, kFC, R, kn, pw + c0, D.d, cn, xs, DC);
      else
        dense::rows_x_mat<16, true>(tt, kFC, R, kn, pw + (size_t)f0 * D.d + c0, D.d, cn, xs, DC);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < R * cn; e += kThreads) {
      const int ii = e / cn, c = e % cn;
      xs[ii * DC + c] = xs[ii * DC + c] + pb[c0 + c] + pos[(size_t)(i0 + ii) * D.d + c0 + c];
    }
    __syncthreads();
  };
  // 1. the rows' LayerNorm statistics over d
  for (int c0 = 0; c0 < D.d; c0 += DC) {
    const int cn = min(DC, D.d - c0);
    embed_chunk(c0, cn);
    for (int ii = warp; ii < R; ii += kWarps) dense::merge_row(xs + ii * DC, cn, c0, rs + 2 * ii);
  }
  // 2. semx a chunk at a time, and its share of qk
  for (int c0 = 0; c0 < D.d; c0 += DC) {
    const int cn = min(DC, D.d - c0);
    embed_chunk(c0, cn);
    for (int ii = warp; ii < R; ii += kWarps) {
      const size_t row = row0 + ii;
      const float mu = rs[2 * ii], inv = rsqrtf(rs[2 * ii + 1] / D.d + dense::kEps);
      float* z = xs + ii * DC;
      for (int e = lane; e < cn; e += 32) {
        const float h = (z[e] - mu) * inv;
        const float m = dmask ? dmask[row * D.d + c0 + e] : 1.f;
        const float sv = rnd((h * gs[c0 + e] + bs[c0 + e]) * m * D.keep_inv, D.bf16);
        z[e] = sv;
        if (xhat_out) {
          xhat_out[row * D.d + c0 + e] = h;
          semx_out[row * D.d + c0 + e] = sv;
        }
      }
      if (c0 == 0 && inv_out && lane == 0) inv_out[row] = inv;
    }
    __syncthreads();
    if (c0 == 0)
      dense::rows_x_mat<16>(xs, DC, R, cn, wqk, D.HK2, D.HK2, qk + row0 * D.HK2, D.HK2);
    else
      dense::rows_x_mat<16, true>(xs, DC, R, cn, wqk + (size_t)c0 * D.HK2, D.HK2, D.HK2,
                                  qk + row0 * D.HK2, D.HK2);
  }
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
// Shared pieces of the streaming passes
// ---------------------------------------------------------------------------

// s = md(q) . md(k) / sqrt(dk) + bias for a query row q and a key row k of
// the staged tiles (both md() already): every pass scores with this one FMA
// chain, over c in order, so the stats, att and A agree bit for bit across
// passes. Rows are padded to a multiple of 4 floats (16-byte aligned), so
// where 4 | dk both are read 16 bytes at a time; the key tiles' rows carry 4
// floats more (LK), so a warp's 16 different key rows fall on all 32 banks.
// Where d_k is staged in chunks (dkc < dk) each chunk's columns continue the
// chain from the last chunk's dot (dot_chain), so a score has the same bits
// either way.
__device__ __forceinline__ float dot_chain(const float* q, const float* k, int n, float dot) {
  if ((n & 3) == 0) {
    for (int c = 0; c < n; c += 4) {
      const float4 u = *reinterpret_cast<const float4*>(q + c);
      const float4 v = *reinterpret_cast<const float4*>(k + c);
      dot = fmaf(u.x, v.x, dot);
      dot = fmaf(u.y, v.y, dot);
      dot = fmaf(u.z, v.z, dot);
      dot = fmaf(u.w, v.w, dot);
    }
  } else {
    for (int c = 0; c < n; ++c) dot = fmaf(q[c], k[c], dot);
  }
  return dot;
}
__device__ __forceinline__ float score(const float* q, const float* k, float bias,
                                       const Dims& D) {
  return dot_chain(q, k, D.dk, 0.f) * D.inv_sqrt + bias;
}

// n rows from r0 of md(q_k) (part 0) or md(k_k) (part 1) of batch b, their
// columns [c0, c0 + cw) (all of d_k by default), into dst (n, ld); zero
// past N. Where 4 | dk and 4 | cw, 16 bytes a thread, its row and column
// taken once (a division per element costs as much as the scores)
__device__ __forceinline__ void stage_rows(const float* __restrict__ qk, int b, int k, int r0,
                                           int n, int part, float* dst, int ld, const Dims& D,
                                           int c0 = 0, int cw = -1) {
  if (cw < 0) cw = D.dk;
  const int off = part * D.hk + k * D.dk + c0, w = cw >> 2;
  const float* src = qk + (size_t)b * D.N * D.HK2 + off;
  if ((D.dk & 3) == 0 && (cw & 3) == 0 && w <= kThreads) {
    const int rp = kThreads / w;  // rows a round
    if (threadIdx.x >= rp * w) return;
    const int c = (threadIdx.x % w) * 4;
    for (int r = threadIdx.x / w; r < n; r += rp) {
      const int i = r0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < D.N) {
        v = *reinterpret_cast<const float4*>(src + (size_t)i * D.HK2 + c);
        v = make_float4(rnd(v.x, D.bf16), rnd(v.y, D.bf16), rnd(v.z, D.bf16), rnd(v.w, D.bf16));
      }
      *reinterpret_cast<float4*>(dst + r * ld + c) = v;
    }
    return;
  }
  for (int e = threadIdx.x; e < n * cw; e += kThreads) {
    const int r = e / cw, c = e % cw, i = r0 + r;
    dst[r * ld + c] = i < D.N ? rnd(src[(size_t)i * D.HK2 + c], D.bf16) : 0.f;
  }
}

// Chunked d_k: the dots of NR (query row, key row) pairs of a thread,
// dot[r] for query row qi[r] of the n_q rows from q0 and key row kj of the
// n_k rows from k0 (a pair < 0 is skipped), d_k staged dkc columns at a time
// into qs (n_q, LQ) and kt (n_k, LK)
template <int NR>
__device__ __forceinline__ void chunk_dots(float (&dot)[NR], const int (&qi)[NR], int kj,
                                           const float* __restrict__ qk, int b, int k, int q0,
                                           int n_q, int k0, int n_k, float* qs, float* kt,
                                           const Dims& D) {
#pragma unroll
  for (int r = 0; r < NR; ++r) dot[r] = 0.f;
  for (int c0 = 0; c0 < D.dk; c0 += D.dkc) {
    const int cw = min(D.dkc, D.dk - c0);
    __syncthreads();  // the tiles' last users are done
    stage_rows(qk, b, k, q0, n_q, 0, qs, D.LQ, D, c0, cw);
    stage_rows(qk, b, k, k0, n_k, 1, kt, D.LK, D, c0, cw);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < NR; ++r)
      if (qi[r] >= 0 && kj >= 0) dot[r] = dot_chain(qs + qi[r] * D.LQ, kt + kj * D.LK, cw, dot[r]);
  }
}


// the column statistics (max, sum of exp) of n targets from j0 into st (n,
// 2); (0, 1) past N
__device__ __forceinline__ void stage_stats(const float* __restrict__ stats, int b, int k,
                                            int j0, int n, float* st, const Dims& D) {
  const float* sbk = stats + ((size_t)b * D.K + k) * D.N * 2;
  for (int e = threadIdx.x; e < 2 * n; e += kThreads) {
    const int j = j0 + e / 2;
    st[e] = j < D.N ? sbk[(size_t)j * 2 + e % 2] : (float)(e % 2);
  }
}

// A's element split into hi = bf16(v) (md(v), the bf16 product's operand)
// and lo = bf16(v - hi) (float32's third product; bf16's delta)
__device__ __forceinline__ void put_A(bf16* hi, bf16* lo, int e, float v) { split(v, hi[e], lo[e]); }

// the chunked copies: xm (B, nCh, Npad, CTcp), dagg (B, K, nCh, Npad, CTcp)
__device__ __forceinline__ size_t x_chunk(int b, int ch, const Dims& D) {
  return ((size_t)b * D.nCh + ch) * D.Npad * D.CTcp;
}
__device__ __forceinline__ size_t d_chunk(int b, int k, int ch, const Dims& D) {
  return (((size_t)b * D.K + k) * D.nCh + ch) * D.Npad * D.CTcp;
}

// ---------------------------------------------------------------------------
// stats: each target column's max and sum of exp over all sources, per
// (b, k, 16 targets), the sources streamed kSrc at a time
// ---------------------------------------------------------------------------
template <bool CK>
__global__ void __launch_bounds__(kThreads)
sp_colstats_kernel(const float* __restrict__ qk, const float* __restrict__ bias,
                   float* __restrict__ stats, Dims D) {
  extern __shared__ __align__(16) float sm[];
  const int N = D.N, j0 = blockIdx.x * kCols, k = blockIdx.y, b = blockIdx.z;
  float* kt = sm;                  // (16, LK) keys
  float* qs = kt + kCols * D.LK;   // (kSrc, LQ) queries
  float* red = qs + kSrc * D.LQ;   // (kWarps, 16, 2)
  const int jj = threadIdx.x % kCols, ig = threadIdx.x / kCols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool live = j0 + jj < N;
  constexpr bool chunked = CK;  // d_k staged in chunks (dkc < dk)
  if (!chunked) stage_rows(qk, b, k, j0, kCols, 1, kt, D.LK, D);
  const float* bias_k = bias + (size_t)k * N * N;
  float m = -INFINITY, l = 0.f;
  for (int i0 = 0; i0 < N; i0 += kSrc) {
    float dot[kSrc / 16];
    if (chunked) {
      int qi[kSrc / 16];
#pragma unroll
      for (int r = 0; r < kSrc / 16; ++r) qi[r] = i0 + ig + 16 * r < N && live ? ig + 16 * r : -1;
      chunk_dots(dot, qi, jj, qk, b, k, i0, kSrc, j0, kCols, qs, kt, D);
    } else {
      __syncthreads();  // kt is in, or the last step's q is consumed
      stage_rows(qk, b, k, i0, kSrc, 0, qs, D.LQ, D);
      __syncthreads();
    }
    for (int r = 0; r < kSrc / 16; ++r) {
      const int ii = ig + 16 * r, i = i0 + ii;
      if (i >= N || !live) continue;
      const float bij = bias_k[(size_t)i * N + j0 + jj];
      const float s = chunked ? dot[r] * D.inv_sqrt + bij
                              : score(qs + ii * D.LQ, kt + jj * D.LK, bij, D);
      if (s > m) {
        l = l * expf(m - s) + 1.f;
        m = s;
      } else {
        l += expf(s - m);
      }
    }
  }
  // merge the 16 source groups of each column: lane ^ 16 in the warp, then
  // the warps in order
  const float m2 = __shfl_xor_sync(0xffffffffu, m, 16), l2 = __shfl_xor_sync(0xffffffffu, l, 16);
  const float mm = fmaxf(m, m2);
  const float ll = (l > 0.f ? l * expf(m - mm) : 0.f) + (l2 > 0.f ? l2 * expf(m2 - mm) : 0.f);
  if (lane < 16) {
    red[(warp * kCols + jj) * 2] = mm;
    red[(warp * kCols + jj) * 2 + 1] = ll;
  }
  __syncthreads();
  if (threadIdx.x < kCols && live) {
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red[(w * kCols + jj) * 2]);
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float lw = red[(w * kCols + jj) * 2 + 1];
      if (lw > 0.f) sum += lw * expf(red[(w * kCols + jj) * 2] - mx);
    }
    float* out = stats + (((size_t)b * D.K + k) * N + j0 + jj) * 2;
    out[0] = mx;
    out[1] = sum;
  }
}

// ---------------------------------------------------------------------------
// The column passes' aggregation: agg (16, CTcp) = md(A_k)^T . md(xm) of
// chunk ch for the target tile j0 (nj valid), the sources streamed kSrc at
// a time, A_k rebuilt from the column stats
// ---------------------------------------------------------------------------
struct ColTiles {
  float *kt, *qs, *st;  // (16, LK) keys, (kSrc, LQ) queries, (16, 2) stats
  bf16 *ahi, *alo;      // (kSrc, 16) A, hi and lo
  float* agg;           // (16, CTcp)
  float* rest;          // the kernel's own (16, CoTc)
};

// every region a multiple of 32 bytes, so each WMMA tile starts aligned
__device__ __forceinline__ ColTiles col_tiles(unsigned char* smem, const Dims& D) {
  ColTiles t;
  t.kt = reinterpret_cast<float*>(smem);
  t.qs = t.kt + kCols * D.LK;
  t.st = t.qs + kSrc * D.LQ;
  t.ahi = reinterpret_cast<bf16*>(t.st + 32);
  t.alo = t.ahi + kSrc * kCols;
  t.agg = reinterpret_cast<float*>(t.alo + kSrc * kCols);
  t.rest = t.agg + kCols * D.CTcp;
  return t;
}

// kLo (the bf16 backward): agg_lo gets (A - md(A))^T . md(xm) beside it, so
// agg + agg_lo is the aggregation of the unrounded A, delta's operand
template <bool kLo, bool CK>
__device__ void col_aggregate(int b, int k, int ch, int j0, int nj, const float* __restrict__ qk,
                              const float* __restrict__ stats, const float* __restrict__ bias,
                              const float* __restrict__ cheb, const bf16* __restrict__ xhi,
                              const bf16* __restrict__ xlo, const ColTiles& t, float* agg_lo,
                              const Dims& D) {
  const int N = D.N, warp = threadIdx.x / 32, MT = D.CTcp / 16;
  const int jj = threadIdx.x % kCols, ig = threadIdx.x / kCols;
  constexpr bool chunked = CK;
  __syncthreads();  // the last user of the tiles is done
  if (!chunked) stage_rows(qk, b, k, j0, kCols, 1, t.kt, D.LK, D);
  stage_stats(stats, b, k, j0, kCols, t.st, D);
  FragC acc[kAcc], accl[kLo ? kAcc : 1];
#pragma unroll
  for (int q = 0; q < kAcc; ++q) wmma::fill_fragment(acc[q], 0.f);
  if (kLo)
#pragma unroll
    for (int q = 0; q < kAcc; ++q) wmma::fill_fragment(accl[kLo ? q : 0], 0.f);
  const size_t xo = x_chunk(b, ch, D);
  const float* bias_k = bias + (size_t)k * N * N;
  const float* cheb_k = cheb + (size_t)k * N * N;
  for (int i0 = 0; i0 < N; i0 += kSrc) {
    float dot[kSrc / 16];
    if (chunked) {  // its first barrier: kt and st are in, or the last step's A is consumed
      int qi[kSrc / 16];
#pragma unroll
      for (int r = 0; r < kSrc / 16; ++r)
        qi[r] = i0 + ig + 16 * r < N && jj < nj ? ig + 16 * r : -1;
      chunk_dots(dot, qi, jj, qk, b, k, i0, kSrc, j0, kCols, t.qs, t.kt, D);
    } else {
      __syncthreads();  // kt and st are in, or the last step's A is consumed
      stage_rows(qk, b, k, i0, kSrc, 0, t.qs, D.LQ, D);
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kSrc / 16; ++r) {
      const int ii = ig + 16 * r, i = i0 + ii;
      float v = 0.f;
      if (i < N && jj < nj) {
        const size_t o = (size_t)i * N + j0 + jj;
        const float s = chunked ? dot[r] * D.inv_sqrt + bias_k[o]
                                : score(t.qs + ii * D.LQ, t.kt + jj * D.LK, bias_k[o], D);
        v = cheb_k[o] * (expf(s - t.st[2 * jj]) / t.st[2 * jj + 1]);
      }
      put_A(t.ahi, t.alo, ii * kCols + jj, v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSrc / 16; ++kk) {
      FragAt ah, al;  // A^T: the (source, target) tile read column-major
      wmma::load_matrix_sync(ah, t.ahi + kk * 16 * kCols, kCols);
      if (xlo || kLo) wmma::load_matrix_sync(al, t.alo + kk * 16 * kCols, kCols);
      const size_t ro = xo + (size_t)(i0 + kk * 16) * D.CTcp;
#pragma unroll
      for (int q = 0; q < kAcc; ++q) {
        const int mt = warp + kWarps * q;
        if (mt >= MT) continue;
        FragB xf;
        wmma::load_matrix_sync(xf, xhi + ro + mt * 16, D.CTcp);
        wmma::mma_sync(acc[q], ah, xf, acc[q]);
        if (xlo) {
          wmma::mma_sync(acc[q], al, xf, acc[q]);
          wmma::load_matrix_sync(xf, xlo + ro + mt * 16, D.CTcp);
          wmma::mma_sync(acc[q], ah, xf, acc[q]);
        } else if (kLo) {
          wmma::mma_sync(accl[kLo ? q : 0], al, xf, accl[kLo ? q : 0]);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kAcc; ++q) {
    const int mt = warp + kWarps * q;
    if (mt >= MT) continue;
    wmma::store_matrix_sync(t.agg + mt * 16, acc[q], D.CTcp, wmma::mem_row_major);
    if (kLo)
      wmma::store_matrix_sync(agg_lo + mt * 16, accl[kLo ? q : 0], D.CTcp, wmma::mem_row_major);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// cols (forward): y (B, N, Co*T) = relu(sum_k md(agg_k) . theta_k) for the
// tile's 16 targets, the time chunk's steps and a chunk of Coc output
// channels (grid y = time chunk * nCoc + output chunk); the theta mix sums
// the channel chunks in order, each chunk's agg_k formed in turn
// ---------------------------------------------------------------------------
template <bool CK, bool CH>
__global__ void __launch_bounds__(kThreads)
sp_cols_fwd_kernel(const float* __restrict__ qk, const float* __restrict__ stats,
                   const float* __restrict__ bias, const float* __restrict__ cheb,
                   const bf16* __restrict__ xhi, const bf16* __restrict__ xlo,
                   const float* __restrict__ theta, float* __restrict__ y, Dims D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ColTiles t = col_tiles(smem, D);
  // CH: C or Co in chunks; else one chunk of each, the whole-width arithmetic
  const int j0 = blockIdx.x * kCols, tch = CH ? blockIdx.y / D.nCoc : blockIdx.y,
            b = blockIdx.z, nCc = CH ? D.nCc : 1;
  const int nj = min(kCols, D.N - j0), t0 = tch * D.Tc, nt = min(D.Tc, D.T - t0);
  const int o0 = CH ? (blockIdx.y % D.nCoc) * D.Coc : 0,
            on = CH ? min(D.Coc, D.Co - o0) : D.Co;
  float* out = t.rest;  // (16, CoTc): (target, o, t)
  for (int e = threadIdx.x; e < kCols * D.CoTc; e += kThreads) out[e] = 0.f;
  for (int k = 0; k < D.K; ++k)
    for (int cch = 0; cch < nCc; ++cch) {
      const int c0 = cch * D.Cc, cn = CH ? min(D.Cc, D.C - c0) : D.C;
      col_aggregate<false, CK>(b, k, tch * nCc + cch, j0, nj, qk, stats, bias, cheb, xhi, xlo,
                               t, nullptr, D);
      // the mix, four output channels a thread: each md(agg) value serves four
      const float* th = theta + ((size_t)k * D.C + c0) * D.Co + o0;
      const int Co4 = (on + 3) / 4, per = D.Tc * Co4;
      for (int e = threadIdx.x; e < kCols * per; e += kThreads) {
        const int jj = e / per, r = e % per, ol = 4 * (r / D.Tc), tt = r % D.Tc;
        const float* ar = t.agg + jj * D.CTcp + tt;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c = 0; c < cn; ++c) {
          const float a = rnd(ar[c * D.Tc], D.bf16);
          const float* tr = th + (size_t)c * D.Co + ol;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (ol + q < on) v[q] = fmaf(a, __ldg(tr + q), v[q]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (ol + q < on) out[jj * D.CoTc + (ol + q) * D.Tc + tt] += v[q];
      }
    }
  __syncthreads();
  for (int e = threadIdx.x; e < nj * D.CoTc; e += kThreads) {
    const int jj = e / D.CoTc, r = e % D.CoTc, o = r / D.Tc, tt = r % D.Tc;
    if (tt < nt && o < on)
      y[((size_t)b * D.N + j0 + jj) * D.CoT + (size_t)(o0 + o) * D.T + t0 + tt] =
          fmaxf(out[e], 0.f);
  }
}

// ---------------------------------------------------------------------------
// cols_bwd: per (b, 16 targets, chunk) and k, agg_k again, the dtheta
// partial, md(dagg_k) = md(gm . theta_k^T) into the chunked dagg copy (hi,
// and lo in float32) and delta_kj = dagg_kj . agg_kj over the chunk. With
// Co in chunks (nCoc > 1) gm is staged a chunk at a time and dagg's sums
// over o kept in dacc (16, CTcp) in shared memory
// ---------------------------------------------------------------------------
template <bool CK, bool CH>
__global__ void __launch_bounds__(kThreads)
sp_cols_bwd_kernel(const float* __restrict__ qk, const float* __restrict__ stats,
                   const float* __restrict__ bias, const float* __restrict__ cheb,
                   const bf16* __restrict__ xhi, const bf16* __restrict__ xlo,
                   const float* __restrict__ theta, const float* __restrict__ g_out,
                   const unsigned char* __restrict__ relu_pos, bf16* __restrict__ dhi,
                   bf16* __restrict__ dlo, float* __restrict__ delta,
                   float* __restrict__ dth_part, Dims D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ColTiles t = col_tiles(smem, D);
  const int N = D.N, jt = blockIdx.x, j0 = jt * kCols, ch = blockIdx.y, b = blockIdx.z;
  const int tch = CH ? ch / D.nCc : ch, c0 = CH ? (ch % D.nCc) * D.Cc : 0,
            cn = CH ? min(D.Cc, D.C - c0) : D.C;
  const int nj = min(kCols, N - j0), t0 = tch * D.Tc, nt = min(D.Tc, D.T - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // gm = md(g * [y > 0]) with the forward's own mask, (target, o, t) for the
  // output channels [o0, o0 + Coc), zero past nj, the chunk's last step and
  // Co; in bf16 agg_lo (16, CTcp) after it, then (Co in chunks) dacc
  float* gm = t.rest;
  float* agg_lo = D.bf16 ? gm + kCols * D.CoTc : nullptr;
  float* dacc =
      CH && D.nCoc > 1 ? gm + kCols * D.CoTc + (D.bf16 ? kCols * D.CTcp : 0) : nullptr;
  auto stage_gm = [&](int o0) {
    for (int e = threadIdx.x; e < kCols * D.CoTc; e += kThreads) {
      const int jj = e / D.CoTc, r = e % D.CoTc, o = o0 + r / D.Tc, tt = r % D.Tc;
      float v = 0.f;
      if (jj < nj && tt < nt && o < D.Co) {
        const size_t g = ((size_t)b * N + j0 + jj) * D.CoT + (size_t)o * D.T + t0 + tt;
        v = rnd(g_out[g] * (relu_pos[g] ? 1.f : 0.f), D.bf16);
      }
      gm[e] = v;
    }
  };
  // dtheta_k partial of channels [c0, c0 + cn) and output channels [o0, o0 + on):
  // sum_{j, t} md(agg)[j][c, t] * gm[j][o, t]
  auto dtheta = [&](float* part, int o0, int on) {
    for (int e = threadIdx.x; e < cn * on; e += kThreads) {
      const int c = e / on, o = e % on;
      float acc = 0.f;
      for (int jj = 0; jj < kCols; ++jj)
        for (int tt = 0; tt < D.Tc; ++tt)
          acc = fmaf(rnd(t.agg[jj * D.CTcp + c * D.Tc + tt], D.bf16),
                     gm[jj * D.CoTc + o * D.Tc + tt], acc);
      part[(size_t)(c0 + c) * D.Co + o0 + o] = acc;
    }
  };
  if (!dacc) stage_gm(0);
  for (int k = 0; k < D.K; ++k) {
    if (agg_lo)
      col_aggregate<true, CK>(b, k, ch, j0, nj, qk, stats, bias, cheb, xhi, xlo, t, agg_lo, D);
    else
      col_aggregate<false, CK>(b, k, ch, j0, nj, qk, stats, bias, cheb, xhi, xlo, t, nullptr,
                               D);
    const float* th = theta + (size_t)k * D.C * D.Co;
    float* part = dth_part + ((((size_t)b * D.NJt + jt) * D.nTc + tch) * D.K + k) * D.C * D.Co;
    if (!dacc) {
      dtheta(part, 0, D.Co);
    } else {
      for (int e = threadIdx.x; e < kCols * D.CTcp; e += kThreads) dacc[e] = 0.f;
      for (int o0 = 0; o0 < D.Co; o0 += D.Coc) {
        const int on = min(D.Coc, D.Co - o0);
        __syncthreads();  // the last chunk of gm is consumed
        stage_gm(o0);
        __syncthreads();
        dtheta(part, o0, on);
        for (int e = threadIdx.x; e < kCols * D.CTcp; e += kThreads) {
          const int jj = e / D.CTcp, col = e % D.CTcp, c = col / D.Tc, tt = col % D.Tc;
          if (c >= cn) continue;
          float v = dacc[e];
          for (int o = 0; o < on; ++o)
            v = fmaf(gm[jj * D.CoTc + o * D.Tc + tt], th[(size_t)(c0 + c) * D.Co + o0 + o], v);
          dacc[e] = v;
        }
      }
      __syncthreads();  // dacc is complete
    }
    // md(dagg) a warp a target row, and its delta against the unrounded A's
    // aggregation (bf16: agg + agg_lo), as the softmax backward sums
    // att * cheb * dA with float32 att
    const size_t dk0 = d_chunk(b, k, ch, D);
    for (int jj = warp; jj < kCols; jj += kWarps) {
      const size_t row = dk0 + (size_t)(j0 + jj) * D.CTcp;
      float dot = 0.f;
      for (int col = lane; col < D.CTcp; col += 32) {
        const int c = col / D.Tc, tt = col % D.Tc;
        float v = 0.f;
        if (c < cn) {
          if (dacc) {
            v = dacc[jj * D.CTcp + col];
          } else {
            for (int o = 0; o < D.Co; ++o)
              v = fmaf(gm[jj * D.CoTc + o * D.Tc + tt], th[(size_t)(c0 + c) * D.Co + o], v);
          }
          v = rnd(v, D.bf16);
        }
        const float a = t.agg[jj * D.CTcp + col] + (agg_lo ? agg_lo[jj * D.CTcp + col] : 0.f);
        dot = fmaf(v, a, dot);
        if (D.bf16)
          dhi[row + col] = __float2bfloat16_rn(v);
        else
          split(v, dhi[row + col], dlo[row + col]);
      }
      dot = dense::warp_sum(dot);
      if (lane == 0 && jj < nj) delta[(((size_t)b * D.K + k) * D.nCh + ch) * N + j0 + jj] = dot;
    }
  }
}

// ---------------------------------------------------------------------------
// ds: per (16 targets, k, a range of source steps), b in order inside:
// dA = xm . dagg^T over every chunk, ds = att (cheb dA - delta), dbias
// (summed over b here), ds to memory (md(ds) as bf16 in bf16), and the dk
// partial of the range
// ---------------------------------------------------------------------------
template <bool CK>
__global__ void __launch_bounds__(kThreads)
sp_ds_kernel(const float* __restrict__ qk, const float* __restrict__ stats,
             const float* __restrict__ bias, const float* __restrict__ cheb,
             const bf16* __restrict__ xhi, const bf16* __restrict__ xlo,
             const bf16* __restrict__ dhi, const bf16* __restrict__ dlo,
             const float* __restrict__ delta, float* __restrict__ dbias, void* dS,
             float* __restrict__ dkpart, Dims D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = D.N, j0 = blockIdx.x * kCols, k = blockIdx.y, sr = blockIdx.z;
  const int nj = min(kCols, N - j0);
  const int per = (D.nST + D.S - 1) / D.S, s0 = sr * per, s1 = min(D.nST, s0 + per);
  // every region a multiple of 32 bytes, so each WMMA tile starts aligned
  float* kt = reinterpret_cast<float*>(smem);  // (16, LK)
  float* qs = kt + kCols * D.LK;                // (kSrc, LQ)
  float* st = qs + kSrc * D.LQ;                 // (16, 2)
  float* dl = st + 2 * kCols;                   // (16) delta
  float* stage = dl + kCols;                    // kWarps x (kSrc, 16): dA partials
  float* dst = stage + kWarps * kSrc * kCols;   // (kSrc, 16) md(ds)
  float* dka = dst + kSrc * kCols;              // (16, dk) dk sums
  const int warp = threadIdx.x / 32, MT = D.CTcp / 16;
  const int jj = threadIdx.x % kCols, ig = threadIdx.x / kCols;
  const size_t NN = (size_t)N * N;
  const float* bias_k = bias + (size_t)k * NN;
  const float* cheb_k = cheb + (size_t)k * NN;
  float* dbias_k = dbias + (size_t)k * NN;
  // chunked d_k: the scores a chunk at a time, and the dk partial summed in
  // place in dkpart (the block's own entries) instead of dka
  constexpr bool chunked = CK;
  for (int b = 0; b < D.B; ++b) {
    __syncthreads();  // the last b's tiles are consumed
    if (!chunked) stage_rows(qk, b, k, j0, kCols, 1, kt, D.LK, D);
    stage_stats(stats, b, k, j0, kCols, st, D);
    for (int e = threadIdx.x; e < kCols; e += kThreads) {
      float v = 0.f;
      if (e < nj)
        for (int ch = 0; ch < D.nCh; ++ch)
          v += delta[(((size_t)b * D.K + k) * D.nCh + ch) * N + j0 + e];
      dl[e] = v;
    }
    if (!chunked)
      for (int e = threadIdx.x; e < kCols * D.dk; e += kThreads) dka[e] = 0.f;
    for (int sidx = s0; sidx < s1; ++sidx) {
      const int i0 = sidx * kSrc;
      __syncthreads();  // the last step's tiles are consumed
      if (!chunked) stage_rows(qk, b, k, i0, kSrc, 0, qs, D.LQ, D);
      // dA (kSrc, 16) on the tensor cores: warp w takes the column tiles
      // w, w + 8, ... of every chunk for all four 16-source row tiles (four
      // independent sums a warp), its partial to stage
      FragC acc[kSrc / 16];
#pragma unroll
      for (int r = 0; r < kSrc / 16; ++r) wmma::fill_fragment(acc[r], 0.f);
      for (int ch = 0; ch < D.nCh; ++ch) {
        const size_t xr = x_chunk(b, ch, D) + (size_t)i0 * D.CTcp;
        const size_t gr = d_chunk(b, k, ch, D) + (size_t)j0 * D.CTcp;
        for (int mt = warp; mt < MT; mt += kWarps) {
          FragBt gf, gl;  // dagg^T: the (target, column) rows read column-major
          wmma::load_matrix_sync(gf, dhi + gr + mt * 16, D.CTcp);
          if (xlo) wmma::load_matrix_sync(gl, dlo + gr + mt * 16, D.CTcp);
#pragma unroll
          for (int r = 0; r < kSrc / 16; ++r) {
            FragA xf;
            const size_t xo = xr + (size_t)r * 16 * D.CTcp + mt * 16;
            wmma::load_matrix_sync(xf, xhi + xo, D.CTcp);
            wmma::mma_sync(acc[r], xf, gf, acc[r]);
            if (xlo) {
              wmma::mma_sync(acc[r], xf, gl, acc[r]);
              wmma::load_matrix_sync(xf, xlo + xo, D.CTcp);
              wmma::mma_sync(acc[r], xf, gf, acc[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kSrc / 16; ++r)
        wmma::store_matrix_sync(stage + (warp * kSrc + r * 16) * kCols, acc[r], kCols,
                                wmma::mem_row_major);
      float dot[kSrc / 16];
      if (chunked) {  // its barriers also publish the dA partials
        int qi[kSrc / 16];
#pragma unroll
        for (int r = 0; r < kSrc / 16; ++r)
        qi[r] = i0 + ig + 16 * r < N && jj < nj ? ig + 16 * r : -1;
        chunk_dots(dot, qi, jj, qk, b, k, i0, kSrc, j0, kCols, qs, kt, D);
      } else {
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < kSrc / 16; ++r) {
        const int ii = ig + 16 * r, i = i0 + ii;
        float ds = 0.f;
        if (i < N && jj < nj) {
          float dA = 0.f;  // the warps' partials in order
#pragma unroll
          for (int w = 0; w < kWarps; ++w) dA += stage[(w * kSrc + ii) * kCols + jj];
          const size_t o = (size_t)i * N + j0 + jj;
          const float s = chunked ? dot[r] * D.inv_sqrt + bias_k[o]
                                  : score(qs + ii * D.LQ, kt + jj * D.LK, bias_k[o], D);
          const float att = expf(s - st[2 * jj]) / st[2 * jj + 1];
          ds = att * (cheb_k[o] * dA - dl[jj]);
          dbias_k[o] = b == 0 ? ds : dbias_k[o] + ds;
          const size_t g = ((size_t)b * D.K + k) * NN + o;
          if (D.bf16)
            static_cast<bf16*>(dS)[g] = __float2bfloat16_rn(ds);
          else
            static_cast<float*>(dS)[g] = ds;
        }
        dst[ii * kCols + jj] = rnd(ds, D.bf16);
      }
      __syncthreads();
      // dk_k[j] += sum_i md(ds)[i][j] md(q_k)[i]
      if (chunked) {
        for (int c0 = 0; c0 < D.dk; c0 += D.dkc) {
          const int cw = min(D.dkc, D.dk - c0);
          if (c0 > 0) __syncthreads();  // the last chunk is consumed
          stage_rows(qk, b, k, i0, kSrc, 0, qs, D.LQ, D, c0, cw);
          __syncthreads();
          for (int e = threadIdx.x; e < nj * cw; e += kThreads) {
            const int jx = e / cw, c = e % cw;
            float* o = dkpart + (((size_t)sr * D.B + b) * N + j0 + jx) * D.hk + k * D.dk + c0 + c;
            float a = sidx == s0 ? 0.f : *o;
            for (int ii = 0; ii < kSrc; ++ii) a = fmaf(dst[ii * kCols + jx], qs[ii * D.LQ + c], a);
            *o = a;
          }
        }
        continue;
      }
      for (int e = threadIdx.x; e < kCols * D.dk; e += kThreads) {
        const int jx = e / D.dk, c = e % D.dk;
        float a = dka[e];
        for (int ii = 0; ii < kSrc; ++ii) a = fmaf(dst[ii * kCols + jx], qs[ii * D.LQ + c], a);
        dka[e] = a;
      }
    }
    if (chunked) continue;
    __syncthreads();
    for (int e = threadIdx.x; e < nj * D.dk; e += kThreads) {
      const int jx = e / D.dk, c = e % D.dk;
      dkpart[(((size_t)sr * D.B + b) * N + j0 + jx) * D.hk + k * D.dk + c] = dka[e];
    }
  }
}

// dk (the k half of dqk) = the source ranges' partials, summed in order, / sqrt(dk)
__global__ void __launch_bounds__(kThreads)
sp_dk_sum_kernel(const float* __restrict__ dkpart, float* __restrict__ dqk, Dims D) {
  const size_t n = (size_t)D.B * D.N * D.hk;
  for (size_t e = blockIdx.x * (size_t)kThreads + threadIdx.x; e < n;
       e += (size_t)gridDim.x * kThreads) {
    float a = 0.f;
    for (int s = 0; s < D.S; ++s) a += dkpart[(size_t)s * n + e];
    dqk[(e / D.hk) * D.HK2 + D.hk + e % D.hk] = a * D.inv_sqrt;
  }
}

// ---------------------------------------------------------------------------
// dq: per (16 sources, k, b), dq_k[i] = sum_j md(ds)[i][j] md(k_k)[j] /
// sqrt(dk), the targets streamed kTgt at a time
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sp_dq_kernel(const float* __restrict__ qk, const void* dS, float* __restrict__ dqk, Dims D) {
  extern __shared__ __align__(16) float sm[];
  const int N = D.N, i0 = blockIdx.x * kRows, k = blockIdx.y, b = blockIdx.z;
  const int ni = min(kRows, N - i0), L = D.dkc;
  float* ks = sm;                   // (kTgt, dkc) md(k) rows, a chunk of d_k
  float* dsl = ks + kTgt * L;       // (16, kTgt) md(ds)
  float* dqa = dsl + kRows * kTgt;  // (16, dkc) sums
  const size_t base = ((size_t)b * D.K + k) * N * N;
  for (int c0 = 0; c0 < D.dk; c0 += L) {
    const int cw = min(L, D.dk - c0);
    for (int e = threadIdx.x; e < kRows * cw; e += kThreads) dqa[e] = 0.f;
    for (int j0 = 0; j0 < N; j0 += kTgt) {
      __syncthreads();  // the last step's tiles are consumed
      stage_rows(qk, b, k, j0, kTgt, 1, ks, L, D, c0, cw);
      for (int e = threadIdx.x; e < kRows * kTgt; e += kThreads) {
        const int ii = e / kTgt, j = j0 + e % kTgt;
        float v = 0.f;
        if (ii < ni && j < N) {
          const size_t g = base + (size_t)(i0 + ii) * N + j;
          v = D.bf16 ? __bfloat162float(static_cast<const bf16*>(dS)[g])
                     : static_cast<const float*>(dS)[g];
        }
        dsl[e] = v;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < kRows * cw; e += kThreads) {
        const int ii = e / cw, c = e % cw;
        float a = dqa[e];
        for (int jx = 0; jx < kTgt; ++jx) a = fmaf(dsl[ii * kTgt + jx], ks[jx * L + c], a);
        dqa[e] = a;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < ni * cw; e += kThreads) {
      const int ii = e / cw, c = e % cw;
      dqk[((size_t)b * N + i0 + ii) * D.HK2 + k * D.dk + c0 + c] = dqa[e] * D.inv_sqrt;
    }
  }
}

// ---------------------------------------------------------------------------
// rows: dxm (16 sources, the chunk's columns) = sum_k md(A_k) . dagg_k, the
// targets streamed kTgt at a time with A_k rebuilt from the stats; the sums
// stay in the warps' fragments over every k and target
// ---------------------------------------------------------------------------
template <bool CK>
__global__ void __launch_bounds__(kThreads)
sp_rows_bwd_kernel(const float* __restrict__ qk, const float* __restrict__ stats,
                   const float* __restrict__ bias, const float* __restrict__ cheb,
                   const bf16* __restrict__ dhi, const bf16* __restrict__ dlo,
                   float* __restrict__ dxm, Dims D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = D.N, i0 = blockIdx.x * kRows, ch = blockIdx.y, b = blockIdx.z;
  const int c0 = (ch % D.nCc) * D.Cc, cn = min(D.Cc, D.C - c0);
  const int ni = min(kRows, N - i0), t0 = (ch / D.nCc) * D.Tc, nt = min(D.Tc, D.T - t0);
  constexpr bool chunked = CK;
  // every region a multiple of 32 bytes, so each WMMA tile starts aligned
  float* qs = reinterpret_cast<float*>(smem);            // (16, LQ)
  float* kt = qs + kRows * D.LQ;                          // (kTgt, LK)
  float* st = kt + kTgt * D.LK;                           // (kTgt, 2)
  bf16* ahi = reinterpret_cast<bf16*>(st + 2 * kTgt);     // (16, kTgt)
  bf16* alo = ahi + kRows * kTgt;
  float* out = reinterpret_cast<float*>(alo + kRows * kTgt);  // (16, CTcp)
  const int warp = threadIdx.x / 32, MT = D.CTcp / 16;
  const int jx = threadIdx.x % kTgt, ig = threadIdx.x / kTgt;
  FragC acc[kAcc];
#pragma unroll
  for (int q = 0; q < kAcc; ++q) wmma::fill_fragment(acc[q], 0.f);
  for (int k = 0; k < D.K; ++k) {
    const float* bias_k = bias + (size_t)k * N * N;
    const float* cheb_k = cheb + (size_t)k * N * N;
    const size_t dk0 = d_chunk(b, k, ch, D);
    __syncthreads();  // the last k's q is consumed
    if (!chunked) stage_rows(qk, b, k, i0, kRows, 0, qs, D.LQ, D);
    for (int j0 = 0; j0 < N; j0 += kTgt) {
      constexpr int NR = kRows / (kThreads / kTgt);
      __syncthreads();  // the last step's A is consumed
      if (!chunked) stage_rows(qk, b, k, j0, kTgt, 1, kt, D.LK, D);
      stage_stats(stats, b, k, j0, kTgt, st, D);
      float dot[NR];
      if (chunked) {  // its barriers also publish st
        int qi[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const int ii = ig + (kThreads / kTgt) * r;
          qi[r] = ii < ni && j0 + jx < N ? ii : -1;
        }
        chunk_dots(dot, qi, jx, qk, b, k, i0, kRows, j0, kTgt, qs, kt, D);
      } else {
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int ii = ig + (kThreads / kTgt) * r, i = i0 + ii, j = j0 + jx;
        float v = 0.f;
        if (ii < ni && j < N) {
          const size_t o = (size_t)i * N + j;
          const float s = chunked ? dot[r] * D.inv_sqrt + bias_k[o]
                                  : score(qs + ii * D.LQ, kt + jx * D.LK, bias_k[o], D);
          v = cheb_k[o] * (expf(s - st[2 * jx]) / st[2 * jx + 1]);
        }
        put_A(ahi, alo, ii * kTgt + jx, v);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTgt / 16; ++kk) {
        FragA ah, al;
        wmma::load_matrix_sync(ah, ahi + kk * 16, kTgt);
        if (dlo) wmma::load_matrix_sync(al, alo + kk * 16, kTgt);
        const size_t ro = dk0 + (size_t)(j0 + kk * 16) * D.CTcp;
#pragma unroll
        for (int q = 0; q < kAcc; ++q) {
          const int mt = warp + kWarps * q;
          if (mt >= MT) continue;
          FragB yf;
          wmma::load_matrix_sync(yf, dhi + ro + mt * 16, D.CTcp);
          wmma::mma_sync(acc[q], ah, yf, acc[q]);
          if (dlo) {
            wmma::mma_sync(acc[q], al, yf, acc[q]);
            wmma::load_matrix_sync(yf, dlo + ro + mt * 16, D.CTcp);
            wmma::mma_sync(acc[q], ah, yf, acc[q]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kAcc; ++q) {
    const int mt = warp + kWarps * q;
    if (mt < MT) wmma::store_matrix_sync(out + mt * 16, acc[q], D.CTcp, wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ni * D.CTc; e += kThreads) {
    const int ii = e / D.CTc, col = e % D.CTc, c = col / D.Tc, tt = col % D.Tc;
    if (tt < nt && c < cn)
      dxm[((size_t)b * N + i0 + ii) * D.CT + (size_t)(c0 + c) * D.T + t0 + tt] =
          out[ii * D.CTcp + col];
  }
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
// SD with d in chunks (sd_split: a row of dsemx and dq too wide for a
// block), 16 rows of batch b: each chunk of DC columns of dsemx = md(dq) .
// wqk^T (dq staged HC columns at a time) and its dropout, the LayerNorm
// backward's row sums over the chunks, then each chunk again: dse, and its
// share of dtat = md(dse) . pw^T added in place
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sp_embed_bwd_chunk_kernel(const float* __restrict__ dqk, const float* __restrict__ wqk_t,
                          const float* __restrict__ pw_t, const float* __restrict__ gs,
                          const float* __restrict__ dmask, const float* __restrict__ xhat,
                          const float* __restrict__ inv_s, float* __restrict__ dse,
                          float* __restrict__ vec, float* __restrict__ dtat, Dims D) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.y, i0 = blockIdx.x * kRows, DC = D.DC, HC = D.HC;
  const int R = min(kRows, D.N - i0), warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row0 = (size_t)b * D.N + i0;
  float* dq = sm;               // (R, HC) md(dq), a chunk of its columns
  float* g = dq + kRows * HC;   // (R, DC) a chunk of dsemx after the dropout
  float* rs = g + kRows * DC;   // (R, 2): the sums of g*gs and g*gs*x_hat
  // the columns [c0, c0 + cn) of dsemx * dropout / keep into g, the same
  // sequence every call
  auto g_chunk = [&](int c0, int cn) {
    for (int h0 = 0; h0 < D.HK2; h0 += HC) {
      const int hn = min(HC, D.HK2 - h0);
      __syncthreads();  // the last chunk is consumed
      for (int e = threadIdx.x; e < R * hn; e += kThreads)
        dq[(e / hn) * HC + e % hn] = rnd(dqk[(row0 + e / hn) * D.HK2 + h0 + e % hn], D.bf16);
      __syncthreads();
      if (h0 == 0)
        dense::rows_x_mat<16>(dq, HC, R, hn, wqk_t + c0, D.d, cn, g, DC);
      else
        dense::rows_x_mat<16, true>(dq, HC, R, hn, wqk_t + (size_t)h0 * D.d + c0, D.d, cn, g,
                                    DC);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < R * cn; e += kThreads) {
      const size_t row = row0 + e / cn;
      const int c = c0 + e % cn;
      const float m = dmask ? dmask[row * D.d + c] : 1.f;
      g[(e / cn) * DC + e % cn] = g[(e / cn) * DC + e % cn] * m * D.keep_inv;
    }
    __syncthreads();
  };
  for (int ii = warp; ii < R; ii += kWarps)
    if (lane == 0) rs[2 * ii] = rs[2 * ii + 1] = 0.f;
  // 1. vec (pre * x_hat, pre) and the row sums
  for (int c0 = 0; c0 < D.d; c0 += DC) {
    const int cn = min(DC, D.d - c0);
    g_chunk(c0, cn);
    for (int ii = warp; ii < R; ii += kWarps) {
      const size_t row = row0 + ii;
      const float* xh = xhat + row * D.d + c0;
      float* v = vec + row * 2 * D.d + c0;
      float m1 = 0.f, m2 = 0.f;
      for (int e = lane; e < cn; e += 32) {
        const float pre = g[ii * DC + e];
        v[e] = pre * xh[e];
        v[D.d + e] = pre;
        const float gy = pre * gs[c0 + e];
        m1 += gy;
        m2 = fmaf(gy, xh[e], m2);
      }
      m1 = dense::warp_sum(m1);
      m2 = dense::warp_sum(m2);
      if (lane == 0) {
        rs[2 * ii] += m1;
        rs[2 * ii + 1] += m2;
      }
    }
  }
  // 2. dse = LN backward, and its share of dtat
  for (int c0 = 0; c0 < D.d; c0 += DC) {
    const int cn = min(DC, D.d - c0);
    g_chunk(c0, cn);
    for (int ii = warp; ii < R; ii += kWarps) {
      const size_t row = row0 + ii;
      const float* xh = xhat + row * D.d + c0;
      const float inv = inv_s[row], m1 = rs[2 * ii] / D.d, m2 = rs[2 * ii + 1] / D.d;
      for (int e = lane; e < cn; e += 32) {
        const float gy = g[ii * DC + e] * gs[c0 + e];
        const float val = inv * (gy - m1 - xh[e] * m2);
        dse[row * D.d + c0 + e] = val;
        g[ii * DC + e] = rnd(val, D.bf16);
      }
    }
    __syncthreads();
    if (c0 == 0)
      dense::rows_x_mat<16>(g, DC, R, cn, pw_t, D.FT, D.FT, dtat + row0 * D.FT, D.FT);
    else
      dense::rows_x_mat<16, true>(g, DC, R, cn, pw_t + (size_t)c0 * D.FT, D.FT, D.FT,
                                  dtat + row0 * D.FT, D.FT);
  }
}

// ---------------------------------------------------------------------------

size_t sa_wmma_smem(const Dims& D, int rows) {
  return sizeof(float) * ((size_t)rows * D.LX + kWarps * 256) +
         sizeof(bf16) * (size_t)rows * (kKC + 8);
}

// Shared memory of each pass's block. None grows with N, F*T or C*T: the
// tiles, the staged d_k columns (dkc), d (or DC and HC where SA or SD is
// split) and a chunk's Cc*Tc and Coc*Tc columns (at most kChunkCols) set it.
// SA float32: a (16, kFC) tat chunk and (16, d) x_tat; bf16: x_tat (RW,
// LX) and the warps' staging in float32, the md(tat) chunk (RW, kKC + 8);
// split, either dtype: the tat chunk, (16, DC) of x_tat and the rows'
// statistics
size_t sa_smem(const Dims& D) {
  if (D.sa_split) return sizeof(float) * ((size_t)kRows * (kFC + D.DC) + 2 * kRows);
  return D.bf16 ? sa_wmma_smem(D, D.RW) : sizeof(float) * kRows * (kFC + D.d);
}
// stats: keys (16, LK), queries (kSrc, LQ), the warps' (16, 2) partials
size_t stats_smem(const Dims& D) {
  return sizeof(float) * ((size_t)kCols * D.LK + (size_t)kSrc * D.LQ + kWarps * kCols * 2);
}
// cols and cols_bwd: keys, queries, stats (32 floats), A hi and lo (kSrc,
// 16) bf16, agg (16, CTcp) and out or gm (16, CoTc); cols_bwd in bf16 also
// agg_lo (16, CTcp), and with Co in chunks dagg's sums (16, CTcp)
size_t cols_smem(const Dims& D) {
  return sizeof(float) * ((size_t)kCols * D.LK + (size_t)kSrc * D.LQ + 32 + kCols * D.CTcp +
                          kCols * D.CoTc) +
         sizeof(bf16) * 2 * kSrc * kCols;
}
size_t cols_bwd_smem(const Dims& D) {
  return cols_smem(D) + sizeof(float) * kCols * D.CTcp * ((D.bf16 ? 1 : 0) + (D.nCoc > 1));
}
// ds: keys, queries, stats, delta (16), the warps' dA partials (kSrc, 16)
// each, md(ds) (kSrc, 16), the dk sums (16, dk; none where d_k is chunked)
size_t ds_smem(const Dims& D) {
  return sizeof(float) * ((size_t)kCols * D.LK + (size_t)kSrc * D.LQ +
                          (D.dkc < D.dk ? 0 : (size_t)kCols * D.dk) + 3 * kCols +
                          (kWarps + 1) * kSrc * kCols);
}
// dq: keys (kTgt, dkc), md(ds) (16, kTgt), the dq sums (16, dkc)
size_t dq_smem(const Dims& D) {
  return sizeof(float) * ((size_t)(kTgt + kRows) * D.dkc + kRows * kTgt);
}
// rows: queries (16, LQ), keys (kTgt, LK), stats (kTgt, 2), A hi and lo
// (16, kTgt) bf16, the (16, CTcp) result
size_t rows_smem(const Dims& D) {
  return sizeof(float) * ((size_t)kRows * D.LQ + (size_t)kTgt * D.LK + 2 * kTgt +
                          kRows * D.CTcp) +
         sizeof(bf16) * 2 * kRows * kTgt;
}
// SD: md(dq) (16, 2Kdk) and dsemx (16, d); split: (16, HC), (16, DC) and
// the rows' sums
size_t sd_smem(const Dims& D) {
  if (D.sd_split) return sizeof(float) * ((size_t)kRows * (D.HC + D.DC) + 2 * kRows);
  return sizeof(float) * kRows * (D.HK2 + D.d);
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
  channel_chunks(C, D.Cc, D.nCc);
  channel_chunks(Co, D.Coc, D.nCoc);
  time_chunks(T, C, Co, D.Tc, D.nTc);
  D.nCh = D.nTc * D.nCc;
  D.CTc = D.Cc * D.Tc;
  D.CTcp = pad16(D.CTc);
  D.CoTc = D.Coc * D.Tc;
  D.Npad = (N + kSrc - 1) / kSrc * kSrc;
  D.NJt = (N + kCols - 1) / kCols;
  D.NIt = (N + kRows - 1) / kRows;
  D.nST = D.Npad / kSrc;
  // source ranges of the ds pass: blocks enough for two waves, no range empty
  int S = (2 * kSms + D.NJt * K - 1) / (D.NJt * K);
  if (S > D.nST) S = D.nST;
  if (S < 1) S = 1;
  const int per = (D.nST + S - 1) / S;
  D.S = (D.nST + per - 1) / per;
  D.FTp = pad16(FT);
  D.dp = pad16(d);
  D.HKp = pad16(D.HK2);
  D.LX = D.dp + 4;
  D.RW = sa_wmma_smem(D, 32) <= kSmemMax ? 32 : 16;
  D.keep_inv = static_cast<float>(1.0 / static_cast<double>(keep));
  D.inv_sqrt = static_cast<float>(1.0 / sqrt(static_cast<double>(dk)));
  // the score passes stage the whole of d_k where every one of them fits
  // with it, else kDkC columns at a time
  for (const int dkc : {dk, dk < kDkC ? dk : kDkC}) {
    D.dkc = dkc;
    D.LQ = (dkc + 3) & ~3;
    D.LK = D.LQ + 4;
    const size_t need[] = {stats_smem(D), cols_smem(D), cols_bwd_smem(D), ds_smem(D),
                           dq_smem(D), rows_smem(D)};
    bool fits = true;
    for (size_t n : need) fits = fits && n <= kSmemMax;
    if (fits) break;
  }
  // SA and SD take d (and SD 2*K*dk) in chunks where their whole rows do not fit
  D.sa_split = D.sd_split = 0;
  D.DC = d;
  D.HC = D.HK2;
  const bool sa_fits = sa_smem(D) <= kSmemMax, sd_fits = sd_smem(D) <= kSmemMax;
  D.DC = d < kDC ? d : kDC;
  D.HC = D.HK2 < kHC ? D.HK2 : kHC;
  D.sa_split = !sa_fits;
  D.sd_split = !sd_fits;
  return D;
}

// a shape the passes cannot take: a grid dimension past 65535 (the batch,
// K, the chunks of the column and row passes)
bool refused(const Dims& D) {
  return D.B > 65535 || D.K > 65535 || D.nCh > 65535 || D.nTc * D.nCoc > 65535;
}

// the chunked bf16 copies' elements: xm (B, nCh, Npad, CTcp), dagg a k each
size_t chunked_elems(const Dims& D, int per_k) {
  return (size_t)D.B * (per_k ? D.K : 1) * D.nCh * D.Npad * D.CTcp;
}

// the forward's workspace (floats): qk (B, N, HK2), the stats (B, K, N, 2)
size_t fwd_stats_at(const Dims& D) { return ((size_t)D.B * D.N * D.HK2 + 63) & ~(size_t)63; }

// the backward's workspace layout (floats), every region on 256 bytes
// (the bf16 dagg copies are read as WMMA fragments): dagg hi (and lo in
// float32) bf16, delta (B, K, nTc, N), ds (B, K, N, N) float32 (bf16 in
// bf16), the dk partials (S, B, N, K*dk), the dtheta partials (B, NJt,
// nTc, K, C, Co); delta (B, K, nCh, N)
struct BwdSpace {
  size_t qk, semx, xhat, inv, stats, dagg, delta, dS, dkpart, dqk, dse, vec, part, scratch,
      total;
};

BwdSpace bwd_space(const Dims& D) {
  const size_t BN = (size_t)D.B * D.N, NN = (size_t)D.N * D.N;
  const auto up = [](size_t n) { return (n + 63) & ~(size_t)63; };
  const size_t dagg = chunked_elems(D, 1) / 2 * (D.bf16 ? 1 : 2);
  const size_t ds = D.bf16 ? ((size_t)D.B * D.K * NN + 1) / 2 : (size_t)D.B * D.K * NN;
  BwdSpace s;
  s.qk = 0;
  s.semx = up(s.qk + BN * D.HK2);
  s.xhat = up(s.semx + BN * D.d);
  s.inv = up(s.xhat + BN * D.d);
  s.stats = up(s.inv + BN);
  s.dagg = up(s.stats + BN * D.K * 2);
  s.delta = up(s.dagg + dagg);
  s.dS = up(s.delta + (size_t)D.B * D.K * D.nCh * D.N);
  s.dkpart = up(s.dS + ds);
  s.dqk = up(s.dkpart + (size_t)D.S * BN * D.hk);
  s.dse = up(s.dqk + BN * D.HK2);
  s.vec = up(s.dse + BN * D.d);
  s.part = up(s.vec + BN * 2 * D.d);
  s.scratch = up(s.part + (size_t)D.B * D.NJt * D.nTc * D.K * D.C * D.Co);
  size_t sc = dense::atb_scratch((int)BN, D.FT, D.d);
  const size_t more[] = {
      dense::atb_scratch((int)BN, D.d, D.HK2),
      dense::sum_rows_scratch(D.B * D.NJt * D.nTc, D.K * D.C * D.Co),
      dense::sum_rows_scratch(D.B, D.N * D.d),
      dense::sum_rows_scratch((int)BN, D.d),
      dense::sum_rows_scratch((int)BN, 2 * D.d),
  };
  for (size_t m : more)
    if (m > sc) sc = m;
  s.total = s.scratch + sc;
  return s;
}

// a column pass's instantiation for a plan: d_k chunked (CK), C or Co in
// chunks (CH); a shape that fits whole takes <false, false>, the whole-width
// code
#define SP_ROUTE(kernel, D)                                                          \
  ((D).dkc < (D).dk                                                                  \
       ? ((D).nCc > 1 || (D).nCoc > 1 ? kernel<true, true> : kernel<true, false>)    \
       : ((D).nCc > 1 || (D).nCoc > 1 ? kernel<false, true> : kernel<false, false>))

template <typename Kern, typename... Args>
cudaError_t launch(Kern kernel, dim3 grid, size_t smem, cudaStream_t st, Args... args) {
  cudaError_t err = dense::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

// SA for the forward (qk) and the backward (qk, semx, x_hat, 1/std): in
// bf16 on the tensor cores from pw16, wqk16, else on the CUDA cores; split
// (d too wide for a block's whole rows) on the CUDA cores in d's chunks
cudaError_t launch_sa(const float* tat, const float* pw, const bf16* pw16, const float* pb,
                      const float* pos, const float* gs, const float* bs, const float* wqk,
                      const bf16* wqk16, const float* dmask, float* qk, float* semx,
                      float* xhat, float* inv, const Dims& D, cudaStream_t st) {
  if (D.sa_split)
    return launch(sp_embed_chunk_kernel, dim3(D.NIt, D.B), sa_smem(D), st, tat, pw, pb, pos, gs,
                  bs, wqk, dmask, qk, semx, xhat, inv, D);
  if (D.bf16)
    return launch(sp_embed_wmma_kernel, dim3((D.B * D.N + D.RW - 1) / D.RW), sa_smem(D), st,
                  tat, pw16, pb, pos, gs, bs, wqk16, dmask, qk, semx, xhat, inv, D);
  return launch(sp_embed_kernel, dim3(D.NIt, D.B), sa_smem(D), st, tat, pw, pb, pos, gs, bs,
                wqk, dmask, qk, semx, xhat, inv, D);
}

// the column statistics of every (b, k) into stats
cudaError_t launch_stats(const float* qk, const float* bias, float* stats, const Dims& D,
                         cudaStream_t st) {
  return launch(D.dkc < D.dk ? sp_colstats_kernel<true> : sp_colstats_kernel<false>,
                dim3(D.NJt, D.K, D.B), stats_smem(D), st, qk, bias, stats, D);
}

}  // namespace

extern "C" {

// Floats of the forward's (qk, stats) and the backward's workspace.
size_t spatial_fused_workspace_floats(int B, int N, int FT, int C, int T, int Co, int d,
                                      int K, int dk, int backward, int bf16) {
  const Dims D = make_dims(B, N, FT, C, T, Co, d, K, dk, 1.f, bf16);
  return backward ? bwd_space(D).total : fwd_stats_at(D) + (size_t)B * N * K * 2;
}

// Bytes of shared memory a block of each kernel requests: 0 SA, 1 stats, 2
// cols, 3 cols_bwd, 4 ds, 5 dq, 6 rows, 7 SD; SA in the bf16 (tensor-core)
// layout when bf16 is set.
size_t spatial_fused_smem_bytes(int N, int FT, int C, int T, int Co, int d, int K, int dk,
                                int kernel, int bf16) {
  const Dims D = make_dims(1, N, FT, C, T, Co, d, K, dk, 1.f, bf16);
  switch (kernel) {
    case 0: return sa_smem(D);
    case 1: return stats_smem(D);
    case 2: return cols_smem(D);
    case 3: return cols_bwd_smem(D);
    case 4: return ds_smem(D);
    case 5: return dq_smem(D);
    case 6: return rows_smem(D);
    default: return sd_smem(D);
  }
}

// Chunks of the chunked xm copy: writes Tc (steps a time chunk), nCh
// (chunks: time chunks x channel chunks), CTcp (columns a chunk row, Cc*Tc
// padded to 16), Npad (rows), Cc (channels a chunk) and Coc (output
// channels a chunk of the forward's column pass).
void spatial_fused_chunks(int N, int C, int T, int Co, int* out) {
  const Dims D = make_dims(1, N, 1, C, T, Co, 1, 1, 1, 1.f, 1);
  out[0] = D.Tc;
  out[1] = D.nCh;
  out[2] = D.CTcp;
  out[3] = D.Npad;
  out[4] = D.Cc;
  out[5] = D.Coc;
}

// Forward: y (B, N, Co*T) float32. dmask (B, N, d) of 0/1 or null (no
// dropout). xm_hi (B, nTc, Npad, CTcp) bf16 is the wrapper's chunked copy
// of xm (spatial_fused_chunks), zero outside; in float32 xm_lo holds the
// lo terms of the same split, in bf16 it is null. With bf16 set SA runs
// on the tensor cores and reads the wrapper's zero-padded bf16 copies
// pw_pad (FTp, dp) and wqk_pad (dp, HKp). Returns cudaGetLastError().
int spatial_fused_forward(const float* tat, const float* dmask, const float* pw,
                          const float* pb, const float* pos, const float* gs, const float* bs,
                          const float* wqk, const float* bias, const float* cheb,
                          const float* theta, const void* xm_hi, const void* xm_lo,
                          const void* pw_pad, const void* wqk_pad, float* y, float* ws, int B,
                          int N, int FT, int C, int T, int Co, int d, int K, int dk,
                          float keep, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims D = make_dims(B, N, FT, C, T, Co, d, K, dk, keep, bf16);
  if (refused(D)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xhi = static_cast<const wm::bf16*>(xm_hi);
  const auto* xlo = static_cast<const wm::bf16*>(xm_lo);
  float* stats = ws + fwd_stats_at(D);
  cudaError_t err = launch_sa(tat, pw, static_cast<const wm::bf16*>(pw_pad), pb, pos, gs, bs,
                              wqk, static_cast<const wm::bf16*>(wqk_pad), dmask, ws, nullptr,
                              nullptr, nullptr, D, st);
  if (err == cudaSuccess) err = launch_stats(ws, bias, stats, D, st);
  if (err == cudaSuccess)
    err = launch(SP_ROUTE(sp_cols_fwd_kernel, D), dim3(D.NJt, D.nTc * D.nCoc, B), cols_smem(D),
                 st,
                 (const float*)ws, (const float*)stats, bias, cheb, xhi, xlo, theta, y, D);
  return static_cast<int>(err);
}

// Backward: dtat (B,N,FT), dxm (B,N,C*T); dpw (FT,d), dvec (3,d) = [dpb,
// dgs, dbs], dpos (N,d), dwqk (d,2Kdk), dbias (K,N,N), dtheta (K,C,Co), all
// summed over b in a fixed order. pw_t (d,FT) and wqk_t (2Kdk,d) are the
// transposed weights. relu_pos (B,N,Co*T) holds 1 where the forward's
// float32 output was > 0, else 0. xm_hi, xm_lo, pw_pad and wqk_pad as the
// forward's. `ws` holds spatial_fused_workspace_floats(..., 1, bf16).
int spatial_fused_backward(const float* tat, const float* dmask, const float* pw,
                           const float* pw_t, const float* pb, const float* pos,
                           const float* gs, const float* bs, const float* wqk,
                           const float* wqk_t, const float* bias, const float* cheb,
                           const float* theta, const float* g_out,
                           const unsigned char* relu_pos, const void* xm_hi,
                           const void* xm_lo, const void* pw_pad, const void* wqk_pad,
                           float* dtat, float* dxm, float* dpw, float* dvec, float* dpos,
                           float* dwqk, float* dbias, float* dtheta, float* ws, int B, int N,
                           int FT, int C, int T, int Co, int d, int K, int dk, float keep,
                           int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims D = make_dims(B, N, FT, C, T, Co, d, K, dk, keep, bf16);
  if (refused(D)) return static_cast<int>(cudaErrorInvalidValue);
  const BwdSpace s = bwd_space(D);
  const int BN = B * N;
  const auto* xhi = static_cast<const wm::bf16*>(xm_hi);
  const auto* xlo = static_cast<const wm::bf16*>(xm_lo);
  wm::bf16* dhi = reinterpret_cast<wm::bf16*>(ws + s.dagg);
  wm::bf16* dlo = bf16 ? nullptr : dhi + chunked_elems(D, 1);
  const float* qk = ws + s.qk;
  const float* stats = ws + s.stats;
  cudaError_t err = launch_sa(tat, pw, static_cast<const wm::bf16*>(pw_pad), pb, pos, gs, bs,
                              wqk, static_cast<const wm::bf16*>(wqk_pad), dmask, ws + s.qk,
                              ws + s.semx, ws + s.xhat, ws + s.inv, D, st);
  if (err == cudaSuccess) err = launch_stats(qk, bias, ws + s.stats, D, st);
  // the dagg copies' padding (rows past the last tile) stays zero
  if (err == cudaSuccess)
    err = cudaMemsetAsync(dhi, 0, sizeof(wm::bf16) * chunked_elems(D, 1) * (bf16 ? 1 : 2), st);
  if (err == cudaSuccess)
    err = launch(SP_ROUTE(sp_cols_bwd_kernel, D), dim3(D.NJt, D.nCh, B), cols_bwd_smem(D), st,
                 qk, stats, bias,
                 cheb, xhi, xlo, theta, g_out, relu_pos, dhi, dlo, ws + s.delta, ws + s.part, D);
  if (err == cudaSuccess)
    err = launch(D.dkc < D.dk ? sp_ds_kernel<true> : sp_ds_kernel<false>, dim3(D.NJt, K, D.S),
                 ds_smem(D), st, qk, stats, bias, cheb, xhi,
                 xlo, (const wm::bf16*)dhi, (const wm::bf16*)dlo, (const float*)(ws + s.delta),
                 dbias, (void*)(ws + s.dS), ws + s.dkpart, D);
  if (err == cudaSuccess) {
    const size_t n = (size_t)BN * D.hk;
    const size_t blocks = (n + kThreads - 1) / kThreads;
    sp_dk_sum_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), kThreads, 0, st>>>(
        ws + s.dkpart, ws + s.dqk, D);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = launch(sp_dq_kernel, dim3(D.NIt, K, B), dq_smem(D), st, qk,
                 (const void*)(ws + s.dS), ws + s.dqk, D);
  if (err == cudaSuccess)
    err = launch(D.dkc < D.dk ? sp_rows_bwd_kernel<true> : sp_rows_bwd_kernel<false>,
                 dim3(D.NIt, D.nCh, B), rows_smem(D), st, qk, stats, bias,
                 cheb, (const wm::bf16*)dhi, (const wm::bf16*)dlo, dxm, D);
  if (err == cudaSuccess)
    err = launch(D.sd_split ? sp_embed_bwd_chunk_kernel : sp_embed_bwd_kernel, dim3(D.NIt, B),
                 sd_smem(D), st, (const float*)(ws + s.dqk), wqk_t, pw_t, gs, dmask,
                 (const float*)(ws + s.xhat), (const float*)(ws + s.inv), ws + s.dse,
                 ws + s.vec, dtat, D);
  if (err != cudaSuccess) return static_cast<int>(err);

  float* scratch = ws + s.scratch;
  if ((err = dense::atb(tat, ws + s.dse, dpw, scratch, BN, FT, d, bf16, bf16, st)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if ((err = dense::atb(ws + s.semx, ws + s.dqk, dwqk, scratch, BN, d, D.HK2, 0, bf16, st)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if ((err = dense::sum_rows(ws + s.part, dtheta, scratch, B * D.NJt * D.nTc, K * C * Co,
                             st)) != cudaSuccess)
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
