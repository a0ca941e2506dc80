// Fused temporal attention (forward and backward) for sm_90a.
//
// Replaces the Pallas kernels of dstagnn_drought_tpu/ops/pallas/tat_fused.py:
// `_tat_fwd_impl` (`_fwd_kernel`) and `_tat_vjp_bwd` (`_bwd_kernel`). Per row
// r of B*F, with x (BF, T, N), res and scores (BF, H, T, T), wqkv (N, W),
// W = 2*H*dk + H*dv, wo (H*dv, N), all float32, row-major, contiguous:
//
//   te   = embed ? LN(x + pos)*g0 + b0 : x
//   qkv  = te . wqkv
//   s_h  = q_h k_h^T / sqrt(dk) + res_h            -> scores (raw)
//   a_h  = softmax over the QUERY axis of s_h       (the reference's quirk)
//   ctx  = concat_h a_h . v_h
//   out  = LN(ctx . wo + te)*g1 + b1                (LN over N)
//
// The TPU kernel widens every operand to float32 and so does this one; the
// wrapper rounds out/scores (and dx/dres) to the caller's dtype.
//
// Bound on an H100: about 2*T*N*W + 4*H*T^2*dk + 2*T*H*dv*N flops a row
// (1.6 MFLOP at PEMS08, N=170, T=12, H=3, dk=dv=32) against ~0.03 MB a row
// of activations: float32 operations, not bytes, bound it. The design:
//   forward: one block a row; the row's te, qkv, scores, context and
//     out-projection live in shared memory (~35 KB at PEMS08); the weights
//     stay in device memory (L2-resident, 0.26 MB) and are streamed once a
//     row per product, coalesced along their columns, with the row's sums
//     in registers (dense_common.cuh rows_x_mat).
//   backward: one block a row recomputes the forward, then runs LN1
//     backward, the out-projection backward, the query-axis softmax
//     backward, the QKV backward, the residual and (embed) LN0 backward. The
//     TPU kernel sums the weight gradients in a resident output block across
//     its sequential grid; CUDA blocks run concurrently, so each row writes
//     its factors instead (te, g_qkv, ctx, g_ypre and per-row LN vectors),
//     and dwqkv = te^T g_qkv, dwo = ctx^T g_ypre are contracted over all
//     B*F*T rows by a split-row product whose partials are summed in a fixed
//     order (dense_common.cuh). No float atomics: two launches give the same
//     bits.
// Tensor cores, TMA and several rows a block are left for a later change.

#include "dense_common.cuh"

namespace {

using dense::kThreads;
using dense::kWarps;

struct Dims {
  int T, N, H, dk, dv, W, hk, hv, embed;
  float inv_sqrt;
};

// te (and x0_hat/inv0 when embedding) from row x, in shared memory
__device__ void embed_rows(const float* __restrict__ xr, const float* __restrict__ pos,
                           const float* __restrict__ g0, const float* __restrict__ b0,
                           float* te, float* x0_hat, float* inv0, const Dims& d) {
  const int TN = d.T * d.N;
  for (int e = threadIdx.x; e < TN; e += kThreads)
    te[e] = d.embed ? xr[e] + pos[e] : xr[e];
  __syncthreads();
  if (!d.embed) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < d.T; t += kWarps) {
    float* z = te + t * d.N;
    float mu, inv;
    dense::ln_stats(z, d.N, mu, inv);
    for (int n = lane; n < d.N; n += 32) {
      const float h = (z[n] - mu) * inv;
      if (x0_hat) x0_hat[t * d.N + n] = h;
      z[n] = h * g0[n] + b0[n];
    }
    if (inv0 && lane == 0) inv0[t] = inv;
  }
  __syncthreads();
}

// qkv, softmax-over-queries attention a (raw scores to `scores` when given),
// context, and z = ctx . wo + te; x1_hat/inv1 of LN1 in place of z
__device__ void attention_rows(const float* te, const float* __restrict__ wqkv,
                               const float* __restrict__ wo, const float* __restrict__ res,
                               float* qkv, float* a, float* ctx, float* z, float* inv1,
                               float* __restrict__ scores, const Dims& d) {
  const int T = d.T, TT = T * T;
  dense::rows_x_mat<16>(te, d.N, T, d.N, wqkv, d.W, d.W, qkv, d.W);
  __syncthreads();
  for (int e = threadIdx.x; e < d.H * TT; e += kThreads) {
    const int h = e / TT, q = (e / T) % T, k = e % T;
    const float* qr = qkv + q * d.W + h * d.dk;
    const float* kr = qkv + k * d.W + d.hk + h * d.dk;
    float dot = 0.f;
    for (int c = 0; c < d.dk; ++c) dot = fmaf(qr[c], kr[c], dot);
    const float s = dot * d.inv_sqrt + res[e];
    a[e] = s;
    if (scores) scores[e] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < d.H * T; e += kThreads) {  // column (h, k)
    float* col = a + (e / T) * TT + e % T;
    float m = -INFINITY;
    for (int q = 0; q < T; ++q) m = fmaxf(m, col[q * T]);
    float sum = 0.f;
    for (int q = 0; q < T; ++q) {
      const float v = expf(col[q * T] - m);
      col[q * T] = v;
      sum += v;
    }
    for (int q = 0; q < T; ++q) col[q * T] = col[q * T] / sum;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < T * d.hv; e += kThreads) {
    const int q = e / d.hv, hd = e % d.hv, h = hd / d.dv;
    const float* ar = a + h * TT + q * T;
    float acc = 0.f;
    for (int k = 0; k < T; ++k) acc = fmaf(ar[k], qkv[k * d.W + 2 * d.hk + hd], acc);
    ctx[e] = acc;
  }
  __syncthreads();
  dense::rows_x_mat<16>(ctx, d.hv, T, d.hv, wo, d.N, d.N, z, d.N);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < T; t += kWarps) {
    float* zr = z + t * d.N;
    for (int n = lane; n < d.N; n += 32) zr[n] += te[t * d.N + n];
    __syncwarp();
    float mu, inv;
    dense::ln_stats(zr, d.N, mu, inv);
    for (int n = lane; n < d.N; n += 32) zr[n] = (zr[n] - mu) * inv;
    if (lane == 0) inv1[t] = inv;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
tat_fwd_kernel(const float* __restrict__ x, const float* __restrict__ pos,
               const float* __restrict__ g0, const float* __restrict__ b0,
               const float* __restrict__ wqkv, const float* __restrict__ wo,
               const float* __restrict__ g1, const float* __restrict__ b1,
               const float* __restrict__ res, float* __restrict__ out,
               float* __restrict__ scores, Dims d) {
  extern __shared__ __align__(16) float sm[];
  const size_t r = blockIdx.x;
  const int TN = d.T * d.N, HTT = d.H * d.T * d.T;
  float* te = sm;
  float* z = te + TN;
  float* qkv = z + TN;
  float* a = qkv + d.T * d.W;
  float* ctx = a + HTT;
  float* inv1 = ctx + d.T * d.hv;
  embed_rows(x + r * TN, pos, g0, b0, te, nullptr, nullptr, d);
  attention_rows(te, wqkv, wo, res + r * HTT, qkv, a, ctx, z, inv1, scores + r * HTT, d);
  float* o = out + r * TN;
  for (int e = threadIdx.x; e < TN; e += kThreads) {
    const int n = e % d.N;
    o[e] = z[e] * g1[n] + b1[n];
  }
}

// Per-row backward. Writes dx (row of (BF,T,N)), dres, and the factors
// te, g_qkv, ctx, g_ypre and vec = [dg1_r, db1_r, dg0_r, db0_r] (4, N).
__global__ void __launch_bounds__(kThreads)
tat_bwd_kernel(const float* __restrict__ x, const float* __restrict__ pos,
               const float* __restrict__ g0, const float* __restrict__ b0,
               const float* __restrict__ wqkv, const float* __restrict__ wqkv_t,
               const float* __restrict__ wo, const float* __restrict__ wo_t,
               const float* __restrict__ g1, const float* __restrict__ res,
               const float* __restrict__ g_out, const float* __restrict__ g_sc,
               float* __restrict__ dx, float* __restrict__ dres,
               float* __restrict__ f_te, float* __restrict__ f_gqkv,
               float* __restrict__ f_ctx, float* __restrict__ f_gy,
               float* __restrict__ vec, Dims d) {
  extern __shared__ __align__(16) float sm[];
  const size_t r = blockIdx.x;
  const int T = d.T, N = d.N, TN = T * N, TT = T * T, HTT = d.H * TT;
  float* te = sm;
  float* x0_hat = te + TN;
  float* x1_hat = x0_hat + TN;
  float* gy = x1_hat + TN;
  float* gte = gy + TN;
  float* qkv = gte + TN;
  float* gqkv = qkv + T * d.W;
  float* a = gqkv + T * d.W;
  float* ds = a + HTT;
  float* ctx = ds + HTT;
  float* gctx = ctx + T * d.hv;
  float* inv0 = gctx + T * d.hv;
  float* inv1 = inv0 + T;

  embed_rows(x + r * TN, pos, g0, b0, te, x0_hat, inv0, d);
  attention_rows(te, wqkv, wo, res + r * HTT, qkv, a, ctx, x1_hat, inv1, nullptr, d);

  // LN1 backward; dg1/db1 of this row summed over t
  const float* go = g_out + r * TN;
  for (int e = threadIdx.x; e < TN; e += kThreads) gy[e] = go[e];
  __syncthreads();
  float* v = vec + r * 4 * N;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float sg = 0.f, sb = 0.f;
    for (int t = 0; t < T; ++t) {
      sg = fmaf(gy[t * N + n], x1_hat[t * N + n], sg);
      sb += gy[t * N + n];
    }
    v[n] = sg;
    v[N + n] = sb;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < T; t += kWarps)
    dense::ln_bwd_row(gy + t * N, x1_hat + t * N, inv1[t], g1, N);
  __syncthreads();

  // out-projection backward: g_ctx = g_ypre . wo^T
  dense::rows_x_mat<16>(gy, N, T, N, wo_t, d.hv, d.hv, gctx, d.hv);
  __syncthreads();
  // g_attn[h][q][k] = g_ctx_h[q] . v_h[k], then the query-axis softmax backward
  for (int e = threadIdx.x; e < HTT; e += kThreads) {
    const int h = e / TT, q = (e / T) % T, k = e % T;
    const float* gr = gctx + q * d.hv + h * d.dv;
    const float* vr = qkv + k * d.W + 2 * d.hk + h * d.dv;
    float acc = 0.f;
    for (int c = 0; c < d.dv; ++c) acc = fmaf(gr[c], vr[c], acc);
    ds[e] = acc;
  }
  __syncthreads();
  const float* gs = g_sc + r * HTT;
  float* dr = dres + r * HTT;
  for (int e = threadIdx.x; e < d.H * T; e += kThreads) {  // column (h, k)
    const int off = (e / T) * TT + e % T;
    float dot = 0.f;
    for (int q = 0; q < T; ++q) dot = fmaf(a[off + q * T], ds[off + q * T], dot);
    for (int q = 0; q < T; ++q) {
      const int o = off + q * T;
      const float val = a[o] * (ds[o] - dot) + gs[o];
      ds[o] = val;
      dr[o] = val;
    }
  }
  __syncthreads();
  // g_q, g_k, g_v in the column order of qkv
  for (int e = threadIdx.x; e < T * d.W; e += kThreads) {
    const int t = e / d.W, col = e % d.W;
    float acc = 0.f;
    if (col < d.hk) {  // g_q[t] = sum_k ds[h][t][k] k_h[k]
      const int h = col / d.dk;
      const float* dsr = ds + h * TT + t * T;
      for (int k = 0; k < T; ++k) acc = fmaf(dsr[k], qkv[k * d.W + d.hk + col], acc);
      acc *= d.inv_sqrt;
    } else if (col < 2 * d.hk) {  // g_k[t] = sum_q ds[h][q][t] q_h[q]
      const int h = (col - d.hk) / d.dk;
      const float* dsc = ds + h * TT + t;
      for (int q = 0; q < T; ++q) acc = fmaf(dsc[q * T], qkv[q * d.W + col - d.hk], acc);
      acc *= d.inv_sqrt;
    } else {  // g_v[t] = sum_q a[h][q][t] g_ctx_h[q]
      const int hd = col - 2 * d.hk, h = hd / d.dv;
      const float* ac = a + h * TT + t;
      for (int q = 0; q < T; ++q) acc = fmaf(ac[q * T], gctx[q * d.hv + hd], acc);
    }
    gqkv[e] = acc;
  }
  __syncthreads();
  // QKV backward and the residual branch
  dense::rows_x_mat<16>(gqkv, d.W, T, d.W, wqkv_t, N, N, gte, N);
  __syncthreads();
  for (int e = threadIdx.x; e < TN; e += kThreads) gte[e] += gy[e];
  __syncthreads();
  if (d.embed) {
    for (int n = threadIdx.x; n < N; n += kThreads) {
      float sg = 0.f, sb = 0.f;
      for (int t = 0; t < T; ++t) {
        sg = fmaf(gte[t * N + n], x0_hat[t * N + n], sg);
        sb += gte[t * N + n];
      }
      v[2 * N + n] = sg;
      v[3 * N + n] = sb;
    }
    __syncthreads();
    for (int t = warp; t < T; t += kWarps)
      dense::ln_bwd_row(gte + t * N, x0_hat + t * N, inv0[t], g0, N);
    __syncthreads();
  } else {
    for (int n = threadIdx.x; n < N; n += kThreads) v[2 * N + n] = v[3 * N + n] = 0.f;
  }
  for (int e = threadIdx.x; e < TN; e += kThreads) {
    dx[r * TN + e] = gte[e];
    f_te[r * TN + e] = te[e];
    f_gy[r * TN + e] = gy[e];
  }
  for (int e = threadIdx.x; e < T * d.W; e += kThreads) f_gqkv[r * T * d.W + e] = gqkv[e];
  for (int e = threadIdx.x; e < T * d.hv; e += kThreads) f_ctx[r * T * d.hv + e] = ctx[e];
}

Dims make_dims(int T, int N, int H, int dk, int dv, int embed) {
  Dims d;
  d.T = T;
  d.N = N;
  d.H = H;
  d.dk = dk;
  d.dv = dv;
  d.hk = H * dk;
  d.hv = H * dv;
  d.W = 2 * d.hk + d.hv;
  d.embed = embed;
  d.inv_sqrt = static_cast<float>(1.0 / sqrt(static_cast<double>(dk)));
  return d;
}

size_t fwd_smem_bytes(const Dims& d) {
  return sizeof(float) * ((size_t)2 * d.T * d.N + (size_t)d.T * d.W +
                          (size_t)d.H * d.T * d.T + (size_t)d.T * d.hv + d.T);
}

size_t bwd_smem_bytes(const Dims& d) {
  return sizeof(float) * ((size_t)5 * d.T * d.N + (size_t)2 * d.T * d.W +
                          (size_t)2 * d.H * d.T * d.T + (size_t)2 * d.T * d.hv + 2 * d.T);
}

// workspace layout of the backward (floats)
struct BwdSpace {
  size_t te, gqkv, ctx, gy, vec, scratch, total;
};

BwdSpace bwd_space(int BF, const Dims& d) {
  const size_t M = (size_t)BF * d.T;
  BwdSpace s;
  s.te = 0;
  s.gqkv = s.te + M * d.N;
  s.ctx = s.gqkv + M * d.W;
  s.gy = s.ctx + M * d.hv;
  s.vec = s.gy + M * d.N;
  s.scratch = s.vec + (size_t)BF * 4 * d.N;
  size_t scratch = dense::atb_scratch((int)M, d.N, d.W);
  const size_t s2 = dense::atb_scratch((int)M, d.hv, d.N);
  const size_t s3 = dense::sum_rows_scratch(BF, 4 * d.N);
  const size_t s4 = dense::sum_rows_scratch(BF, d.T * d.N);
  if (s2 > scratch) scratch = s2;
  if (s3 > scratch) scratch = s3;
  if (s4 > scratch) scratch = s4;
  s.total = s.scratch + scratch;
  return s;
}

}  // namespace

extern "C" {

// Floats of the backward's workspace.
size_t tat_fused_workspace_floats(int BF, int T, int N, int H, int dk, int dv) {
  return bwd_space(BF, make_dims(T, N, H, dk, dv, 1)).total;
}

// Forward: out (BF,T,N), scores (BF,H,T,T). Returns cudaGetLastError().
int tat_fused_forward(const float* x, const float* pos, const float* g0, const float* b0,
                      const float* wqkv, const float* wo, const float* g1, const float* b1,
                      const float* res, float* out, float* scores, int BF, int T, int N,
                      int H, int dk, int dv, int embed, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d = make_dims(T, N, H, dk, dv, embed);
  const size_t smem = fwd_smem_bytes(d);
  cudaError_t err = dense::allow_smem(tat_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tat_fwd_kernel<<<BF, kThreads, smem, st>>>(x, pos, g0, b0, wqkv, wo, g1, b1, res, out,
                                             scores, d);
  return static_cast<int>(cudaGetLastError());
}

// Backward: dx (BF,T,N), dres (BF,H,T,T), dpos (T,N) (embed only), vec4
// (4,N) = [dg1, db1, dg0, db0], dwqkv (N,W), dwo (H*dv,N); every weight
// gradient summed over all rows in a fixed order. `ws` holds
// tat_fused_workspace_floats floats.
int tat_fused_backward(const float* x, const float* pos, const float* g0, const float* b0,
                       const float* wqkv, const float* wqkv_t, const float* wo,
                       const float* wo_t, const float* g1, const float* res,
                       const float* g_out, const float* g_sc, float* dx, float* dres,
                       float* dpos, float* vec4, float* dwqkv, float* dwo, float* ws,
                       int BF, int T, int N, int H, int dk, int dv, int embed,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d = make_dims(T, N, H, dk, dv, embed);
  const BwdSpace s = bwd_space(BF, d);
  const size_t smem = bwd_smem_bytes(d);
  cudaError_t err = dense::allow_smem(tat_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tat_bwd_kernel<<<BF, kThreads, smem, st>>>(
      x, pos, g0, b0, wqkv, wqkv_t, wo, wo_t, g1, res, g_out, g_sc, dx, dres, ws + s.te,
      ws + s.gqkv, ws + s.ctx, ws + s.gy, ws + s.vec, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = BF * T;
  float* scratch = ws + s.scratch;
  err = dense::atb(ws + s.te, ws + s.gqkv, dwqkv, scratch, M, N, d.W, 0, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = dense::atb(ws + s.ctx, ws + s.gy, dwo, scratch, M, d.hv, N, 0, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = dense::sum_rows(ws + s.vec, vec4, scratch, BF, 4 * N, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (embed) err = dense::sum_rows(dx, dpos, scratch, BF, T * N, st);
  return static_cast<int>(err);
}

const char* tat_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
