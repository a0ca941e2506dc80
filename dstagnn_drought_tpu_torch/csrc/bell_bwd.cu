// Backward kernels of the fused BELL conv for sm_90a: K1 (dA and dTheta)
// and K2 (dx).
//
// With gm (B, Np, Co*T) the output cotangent times the ReLU mask and
// g_agg_h[n, c, t] = sum_o Theta[h, c, o] gm[n, o, t]:
//   K1  dA[b, a, h]  = x[src(a)] . round(g_agg_h[tgt(a)])^T       (BS x BS, float)
//       dTheta[h]    = sum_{b, a} (w[b, a, h]^T x[src(a)])^T . gm[tgt(a)]
//   K2  dx[i]        = sum_{a: src(a) = i} sum_h w[b, a, h] . g_agg_h[tgt(a)]
// round() is the cast to the compute dtype that the TPU kernel applies
// before its dA product; K2 keeps g_agg in float (the bf16 K2 as its bf16
// hi + lo: float32 in value). Layouts as in
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
// 2*B*H*A*BS^2*M + 2*B*H*A*BS*M*Co ~ 74 GFLOP (148 as the bf16 design's two
// bf16 terms a product), against ~0.1-0.2 GB of x, gm, w, dA and dx: bound
// by operations (in bf16 ~0.13 ms for K1, ~0.15 ms for K2, at 989 TFLOP/s
// against ~0.05 ms of bytes at 3.35 TB/s).
//
// bf16 K1 (the GAMBIA BELL-tiles main path) runs on the tensor cores
// (WMMA, bf16 products summed in float32), with chunks of 8 time steps (one
// 16-byte row segment, cp.async where T % 8 == 0) and tiles padded to 16:
//   k1_dA_wmma_kernel: one block per (active entry, TN target columns, head,
//     batch) holds its dA tile in float32 fragments across 8 warps; each
//     chunk forms g_agg = gm . Θ_h^T on the tensor cores (Θ split into bf16
//     hi + lo, two products: float32 in value), rounds it to bf16 once, as
//     the TPU kernel does, and adds x_src . g_agg^T.
//   k1_dtheta_wmma_kernel: one block per (CC channels x 8 steps, target
//     tile, batch and head) sums agg = sum_u w_u^T x_u over the tile's slots
//     (bf16 products, float32 sums), splits agg into bf16 hi + lo and
//     contracts it with gm over (target row, step): dTheta float32 in value.
//     Each block writes its rows of a (C, Co) partial; dense::sum_rows sums
//     them in a fixed order (no atomics: two runs give the same bits).
//   Neither pass writes g_agg or agg to device memory. What bounds them is
//   staging and latency, not the tensor cores: the dA pass fits one block an
//   SM (~215 KB at GAMBIA block 2), overlaps only the next chunk's gm rows
//   with its products, and recomputes g_agg for every slot (through a warp's
//   float32 staging, to round it); the dΘ pass restages w and x for every
//   (slot, m-tile), two blocks an SM.
//
// bf16 K2 (k2_wmma_kernel) runs on the tensor cores too: one block per
// (group of up to 16 channels x NT chunks of 8 steps, source tile, batch)
// holds its dx tile (128 source rows x 128 columns at the GAMBIA blocks) in
// float32 fragments across the walk over the tile's outgoing slots, so w
// is staged as it lies (row-major A, no transpose, no widening) once per
// column group, not per time chunk. Per slot and TR target rows it stages
// the gm rows once for every head; per head it forms g = gm . Θ_h^T (Θ
// split hi + lo by k2_theta_split_kernel, two products), splits g into bf16
// hi + lo planes and adds w_h . g_hi + w_h . g_lo: four bf16 products where
// the float32 kernel has two, float32 in value. Staging, barriers and
// latency bound it (two blocks an SM at the GAMBIA blocks, one stage each),
// not the tensor cores.
//
// float32 K1 and K2 run float32 FMAs on the CUDA cores, with
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

// ---------------------------------------------------------------------------
// bf16 K1 on the tensor cores (WMMA, 16x16x16 bf16 products, float32 sums)
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ size_t max_sz(size_t a, size_t b) { return a > b ? a : b; }

// Shared memory of the dA pass at TN target columns a block, and of the dΘ
// pass at TC target rows a contraction chunk (bytes; the layouts below).
__host__ __device__ inline size_t k1_wmma_dA_bytes(int BS, int C, int Co, int TN) {
  const int ldx = pad16(C * kTT) + 8, ldg = TN * kTT + 8, ldt = pad16(Co) + 8;
  return 4 * (size_t)kWarps * kStage +
         2 * ((size_t)(pad16(BS) + TN) * ldx + (size_t)pad16(Co) * ldg +
              2 * (size_t)pad16(C) * ldt);
}

__host__ __device__ __forceinline__ int k1_wmma_cc(int C) {  // channels a dΘ m-tile
  int cc = 16;
  while (cc > C) cc /= 2;
  return cc;
}

// the dΘ block's first region: w and x stages (slot loop), then the warps'
// staging (agg conversion), then their partials (the end)
__host__ __device__ inline size_t k1_wmma_dtheta_region(int BS, int C, int Co) {
  const int BSp = pad16(BS), ldw = BSp + 8, ldm = pad16(k1_wmma_cc(C) * kTT) + 8;
  return max_sz(max_sz(2 * (size_t)BSp * (ldw + ldm), 4 * (size_t)kWarps * 16 * pad16(Co)),
                4 * (size_t)kWarps * kStage);
}

__host__ __device__ inline size_t k1_wmma_dtheta_bytes(int BS, int C, int Co, int TC) {
  const int ld = TC * kTT + 8;
  return k1_wmma_dtheta_region(BS, C, Co) + 2 * (2 * (size_t)16 * ld + (size_t)pad16(Co) * ld);
}

// dA[b, a, h][:, tc:tc+TN]: one block per (active entry, TN target columns,
// head, batch), 8 warps. For each chunk of kTT steps (every channel):
//   gm_s[o][t*8 + tt]  the target rows' cotangent (Cop x TN*8; column-major
//                      A of the g_agg product, rows (t, tt), depth o)
//   g_agg = gm_s . Θ_h^T on the tensor cores, Θ_h split into bf16 hi + lo
//     (two products summed in float32), rounded to bf16 once into
//   g_s[t][c*8 + tt]   (the B operand of the dA product, depth (c, tt))
//   x_s[s][c*8 + tt]   the source rows (the A operand)
//   dA += x_s . g_s^T  in float32 accumulators held across the chunks.
// The next chunk's gm rows load (cp.async) while the dA products run.
// Warp w holds the dA fragments w + 8i (column w % (TN/16) for every i).
__global__ void __launch_bounds__(kThreads, 1)
k1_dA_wmma_kernel(const int* __restrict__ active_src, const int* __restrict__ active_tgt,
                  const float* __restrict__ thetas, const wm::bf16* __restrict__ gm,
                  const wm::bf16* __restrict__ x, float* __restrict__ dA, int A, int H,
                  int NJ, int BS, int C, int T_len, int Co, int TN, int vec) {
  namespace wmma = nvcuda::wmma;
  using wm::bf16;
  const int BSp = pad16(BS), Cp = pad16(C), Cop = pad16(Co);
  const int Kp = pad16(C * kTT), ldx = Kp + 8, ldg = TN * kTT + 8, ldt = Cop + 8;
  const int n_sub = (BS + TN - 1) / TN;
  const int a = blockIdx.x / n_sub, tc = (blockIdx.x % n_sub) * TN;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t Np = (size_t)NJ * BS, M = (size_t)C * T_len, MO = (size_t)Co * T_len;
  const size_t src_row0 = b * Np + (size_t)active_src[a] * BS;
  const size_t tgt_row0 = b * Np + (size_t)active_tgt[a] * BS + tc;
  const int n_tgt = min(TN, BS - tc);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* scratch = reinterpret_cast<float*>(smem_raw);            // [warp][16][kLdS]
  bf16* x_s = reinterpret_cast<bf16*>(scratch + kWarps * kStage);  // [BSp][ldx]
  bf16* g_s = x_s + (size_t)BSp * ldx;                            // [TN][ldx]
  bf16* gm_s = g_s + (size_t)TN * ldx;                            // [Cop][ldg]
  bf16* th_h = gm_s + (size_t)Cop * ldg;                          // [Cp][ldt]
  bf16* th_l = th_h + (size_t)Cp * ldt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sw = scratch + warp * kStage;
  // zero padding (rows and columns never staged stay zero), Θ_h split
  const int n_zero = ((BSp + TN) * ldx + Cop * ldg) / 8;
  for (int e = threadIdx.x; e < n_zero; e += kThreads) zero16(x_s + 8 * (size_t)e);
  for (int e = threadIdx.x; e < Cp * ldt; e += kThreads) {
    const int c = e / ldt, o = e % ldt;
    wm::split(c < C && o < Co ? thetas[((size_t)h * C + c) * Co + o] : 0.f, th_h[e], th_l[e]);
  }
  auto stage_gm = [&](int t0) {  // gm_s[o][t*8 + tt] for o < Co, t < n_tgt
    for (int e = threadIdx.x; e < Co * n_tgt; e += kThreads) {
      const int o = e / n_tgt, t = e % n_tgt;
      stage_segment(gm_s + (size_t)o * ldg + t * kTT,
                    gm + (tgt_row0 + t) * MO + (size_t)o * T_len + t0, t0, T_len, vec);
    }
    if (vec) commit_async();
  };
  const int RF = BSp / 16, CF = TN / 16, n_frag = RF * CF;
  const int GR = TN * kTT / 16, GC = Cp / 16, n_gfrag = GR * GC;
  const int c_out = Kp / kTT;  // g_s channels written (C, even)
  const int cf = warp % CF;    // CF is a power of two <= 8
  int rows[8];                 // first x_s row of each fragment slot
#pragma unroll
  for (int i = 0; i < 8; ++i) rows[i] = min(warp + kWarps * i, n_frag - 1) / CF * 16;
  wm::FragC acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) wmma::fill_fragment(acc[i], 0.f);
  __syncthreads();  // zeroed before the first stage
  stage_gm(0);
  for (int t0 = 0; t0 < T_len; t0 += kTT) {
    // x_s[s][c*8 + tt] (rows past BS are written as zeros)
    for (int e = threadIdx.x; e < BSp * C; e += kThreads) {
      const int r = e / C, c = e % C;
      bf16* d = x_s + (size_t)r * ldx + c * kTT;
      if (r < BS)
        stage_segment(d, x + (src_row0 + r) * M + (size_t)c * T_len + t0, t0, T_len, vec);
      else
        zero16(d);
    }
    if (vec) {
      commit_async();
      wm::wait_async();
    }
    __syncthreads();
    // g_agg (rows (t, tt), columns c) = gm_s . Θ_h^T, rounded into g_s; a
    // warp's fragments f = warp + 8i, four at a time (past the last, the
    // last again, not stored) so that their loads and products interleave
    for (int f0 = warp; f0 < n_gfrag; f0 += 4 * kWarps) {
      wm::FragC g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) wmma::fill_fragment(g[q], 0.f);
      for (int k = 0; k < Cop; k += 16) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int f = min(f0 + kWarps * q, n_gfrag - 1), gr = f / GC, gc = f % GC;
          wm::FragAt fa;
          wm::FragBt fh, fl;
          wmma::load_matrix_sync(fa, gm_s + (size_t)k * ldg + gr * 16, ldg);
          wmma::load_matrix_sync(fh, th_h + gc * 16 * ldt + k, ldt);
          wmma::load_matrix_sync(fl, th_l + gc * 16 * ldt + k, ldt);
          wmma::mma_sync(g[q], fa, fh, g[q]);
          wmma::mma_sync(g[q], fa, fl, g[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int f = f0 + kWarps * q, gr = f / GC, gc = f % GC;
        if (f >= n_gfrag) break;
        wmma::store_matrix_sync(sw, g[q], kLdS, wmma::mem_col_major);  // sw[c][t'*8 + tt]
        __syncwarp();
        const int cl = lane % 16, tp = lane / 16, c = gc * 16 + cl;
        if (c < c_out)
          *reinterpret_cast<uint4*>(g_s + (size_t)(gr * 2 + tp) * ldx + c * kTT) =
              pack8_at(sw + cl * kLdS + tp * kTT);
        __syncwarp();
      }
    }
    __syncthreads();  // g_s written, gm_s consumed
    if (t0 + kTT < T_len) stage_gm(t0 + kTT);
    // dA += x_s . g_s^T over this chunk's Kp columns; every fragment slot
    // is loaded and multiplied (past the last, the last row again, not
    // stored), so the loads of a step go out together ahead of its products
#pragma unroll 2
    for (int k = 0; k < Kp; k += 16) {
      wm::FragBt fb;
      wm::FragA fa[8];
      wmma::load_matrix_sync(fb, g_s + (size_t)cf * 16 * ldx + k, ldx);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        wmma::load_matrix_sync(fa[i], x_s + (size_t)rows[i] * ldx + k, ldx);
#pragma unroll
      for (int i = 0; i < 8; ++i) wmma::mma_sync(acc[i], fa[i], fb, acc[i]);
    }
    __syncthreads();  // x_s and g_s consumed
  }
  float* dA_t = dA + (((size_t)b * A + a) * H + h) * BS * BS;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = warp + kWarps * i;
    if (f >= n_frag) continue;
    wmma::store_matrix_sync(sw, acc[i], kLdS, wmma::mem_row_major);
    __syncwarp();
    const int r0 = (f / CF) * 16, c0 = cf * 16;
    for (int e = lane; e < 256; e += 32) {
      const int r = r0 + e / 16, c = c0 + e % 16;
      if (r < BS && c < n_tgt) dA_t[(size_t)r * BS + tc + c] = sw[(e / 16) * kLdS + e % 16];
    }
    __syncwarp();
  }
}

// dΘ partials: one block per (m-tile, target tile j, batch and head); an
// m-tile is CC channels (a power of two <= 16) of a chunk of kTT steps.
//   agg (BSp targets x CC*8) = sum over j's slots of w^T . x_src on the
//     tensor cores (bf16 products, float32 sums), 8 warps, warp w holding
//     fragments w + 8i; w staged [s][t] (column-major A), x [s][c*8 + tt]
//   then TC target rows at a time: agg split into bf16 hi + lo,
//     [cc][t*8 + tt] (row-major A, depth (t, tt)), gm staged [o][t*8 + tt]
//     (column-major B), partial[cc][o] += agg . gm, warp w taking the depth
//     steps w + 8i; the warps' sums are added in a fixed order.
// Each block writes its CC rows of partial[b, j, g][h] (C, Co); the
// fixed-order dense::sum_rows sums the rows (b, j, g). About 100 KB of
// shared memory at the GAMBIA blocks, so two blocks share an SM where the
// warps' partial fragments (kOF: Co <= 16 * kOF) leave the registers for it.
template <int kOF>
__global__ void __launch_bounds__(kThreads, kOF <= 2 ? 2 : 1)
k1_dtheta_wmma_kernel(const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                      const int* __restrict__ active_src, const wm::bf16* __restrict__ gm,
                      const wm::bf16* __restrict__ x, const wm::bf16* __restrict__ w,
                      float* __restrict__ partial, int A, int H, int NJ, int BS, int C,
                      int T_len, int Co, int TC, int G, int vec, int vec_w) {
  namespace wmma = nvcuda::wmma;
  using wm::bf16;
  const int CC = k1_wmma_cc(C);
  const int g_idx = blockIdx.x % G, cg = blockIdx.x / G, j = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int t0 = g_idx * kTT, c0 = cg * CC, cn = min(CC, C - c0);
  const int BSp = pad16(BS), Cop = pad16(Co), MTp = pad16(CC * kTT);
  const int ldw = BSp + 8, ldm = MTp + 8, ld = TC * kTT + 8;
  const size_t Np = (size_t)NJ * BS, M = (size_t)C * T_len, MO = (size_t)Co * T_len;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const size_t region = k1_wmma_dtheta_region(BS, C, Co);
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);         // [BSp][ldw]  (slot loop)
  bf16* x_s = w_s + (size_t)BSp * ldw;                  // [BSp][ldm]
  float* scratch = reinterpret_cast<float*>(smem_raw);   // [warp][16][kLdS] (agg chunks)
  float* part_s = reinterpret_cast<float*>(smem_raw);    // [warp][16][Cop] (the end)
  bf16* agg_h = reinterpret_cast<bf16*>(smem_raw + region);  // [16][ld]
  bf16* agg_l = agg_h + 16 * ld;
  bf16* gm_s = agg_l + 16 * ld;                          // [Cop][ld]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sw = scratch + warp * kStage;
  // zero everything staged (padding stays zero)
  const size_t n_zero = (region + 2 * (2 * (size_t)16 * ld + (size_t)Cop * ld)) / 16;
  for (size_t e = threadIdx.x; e < n_zero; e += kThreads) zero16(w_s + 8 * e);
  const int start = tile_start[j], count = tile_count[j];
  const int AR = BSp / 16, AC = MTp / 16, n_frag = AR * AC;
  const int ac = warp % AC;  // AC is a power of two <= 8
  int cols[8];               // first w_s column (target) of each fragment slot
#pragma unroll
  for (int i = 0; i < 8; ++i) cols[i] = min(warp + kWarps * i, n_frag - 1) / AC * 16;
  wm::FragC acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) wmma::fill_fragment(acc[i], 0.f);
  for (int u = 0; u < count; ++u) {
    const int a = start + u;
    const size_t src_row0 = b * Np + (size_t)active_src[a] * BS;
    const bf16* w_t = w + (((size_t)b * A + a) * H + h) * BS * BS;
    __syncthreads();  // zeroed, or the last slot's w_s and x_s consumed
    if (vec_w) {
      const int per = BS / 8;
      for (int e = threadIdx.x; e < BS * per; e += kThreads)
        cp_async16(w_s + (size_t)(e / per) * ldw + (e % per) * 8,
                   w_t + (size_t)(e / per) * BS + (e % per) * 8);
    } else {
      for (int e = threadIdx.x; e < BS * BS; e += kThreads)
        w_s[(size_t)(e / BS) * ldw + e % BS] = w_t[e];
    }
    for (int e = threadIdx.x; e < BS * cn; e += kThreads) {
      const int r = e / cn, c = e % cn;
      stage_segment(x_s + (size_t)r * ldm + c * kTT,
                    x + (src_row0 + r) * M + (size_t)(c0 + c) * T_len + t0, t0, T_len, vec);
    }
    if (vec || vec_w) {
      commit_async();
      wm::wait_async();
    }
    __syncthreads();
    // every fragment slot, four at a time (past the last, the last again)
    for (int k = 0; k < BSp; k += 16) {
      wm::FragB fb;
      wmma::load_matrix_sync(fb, x_s + (size_t)k * ldm + ac * 16, ldm);
#pragma unroll
      for (int i0 = 0; i0 < 8; i0 += 4) {
        wm::FragAt fa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wmma::load_matrix_sync(fa[i], w_s + (size_t)k * ldw + cols[i0 + i], ldw);
#pragma unroll
        for (int i = 0; i < 4; ++i) wmma::mma_sync(acc[i0 + i], fa[i], fb, acc[i0 + i]);
      }
    }
  }
  // partial[cc][o] = sum over (t, tt) of agg[cc][t*8 + tt] gm[t][o*T + t0 + tt]
  const int OF = Cop / 16;
  wm::FragC pacc[kOF];
#pragma unroll
  for (int q = 0; q < kOF; ++q) wmma::fill_fragment(pacc[q], 0.f);
  const size_t tgt_row0 = b * Np + (size_t)j * BS;
  for (int t1 = 0; t1 < BSp; t1 += TC) {
    __syncthreads();  // the slot loop's stages, or the last chunk's agg and gm_s, consumed
    const int n_t = max(0, min(TC, BS - t1));
    for (int e = threadIdx.x; e < Co * TC; e += kThreads) {
      const int o = e / TC, t = e % TC;
      bf16* d = gm_s + (size_t)o * ld + t * kTT;
      if (t < n_t)
        stage_segment(d, gm + (tgt_row0 + t1 + t) * MO + (size_t)o * T_len + t0, t0, T_len,
                      vec);
      else
        zero16(d);
    }
    if (vec) commit_async();
    // this chunk's agg rows -> bf16 hi + lo, [cc][(t - t1)*8 + tt]
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int f = warp + kWarps * i;
      const int r0 = (f / AC) * 16;
      if (f >= n_frag || r0 < t1 || r0 >= t1 + TC) continue;
      wmma::store_matrix_sync(sw, acc[i], kLdS, wmma::mem_row_major);  // sw[t][cc'*8 + tt]
      __syncwarp();
      const int tl = lane % 16, ccl = lane / 16, cc = ac * 2 + ccl;
      if (cc < cn) {
        float v[kTT], lo[kTT];
        *reinterpret_cast<float4*>(v) =
            *reinterpret_cast<const float4*>(sw + tl * kLdS + ccl * kTT);
        *reinterpret_cast<float4*>(v + 4) =
            *reinterpret_cast<const float4*>(sw + tl * kLdS + ccl * kTT + 4);
#pragma unroll
        for (int tt = 0; tt < kTT; ++tt)
          lo[tt] = v[tt] - __bfloat162float(__float2bfloat16_rn(v[tt]));
        const size_t o = (size_t)cc * ld + (r0 - t1 + tl) * kTT;
        *reinterpret_cast<uint4*>(agg_h + o) = wm::pack8(v);
        *reinterpret_cast<uint4*>(agg_l + o) = wm::pack8(lo);
      }
      __syncwarp();
    }
    if (vec) wm::wait_async();
    __syncthreads();
    for (int ks = warp; ks < TC * kTT / 16; ks += kWarps) {
      wm::FragA fh, fl;
      wmma::load_matrix_sync(fh, agg_h + ks * 16, ld);
      wmma::load_matrix_sync(fl, agg_l + ks * 16, ld);
#pragma unroll
      for (int q = 0; q < kOF; ++q) {
        if (q < OF) {
          wm::FragBt fb;
          wmma::load_matrix_sync(fb, gm_s + (size_t)q * 16 * ld + ks * 16, ld);
          wmma::mma_sync(pacc[q], fh, fb, pacc[q]);
          wmma::mma_sync(pacc[q], fl, fb, pacc[q]);
        }
      }
    }
  }
  __syncthreads();  // part_s overlays the stages and the warps' staging
#pragma unroll
  for (int q = 0; q < kOF; ++q)
    if (q < OF)
      wmma::store_matrix_sync(part_s + (size_t)warp * 16 * Cop + q * 16, pacc[q], Cop,
                              wmma::mem_row_major);
  __syncthreads();
  float* out = partial + (((size_t)b * NJ + j) * G + g_idx) * H * C * Co + (size_t)h * C * Co;
  for (int e = threadIdx.x; e < cn * Co; e += kThreads) {
    const int cc = e / Co, o = e % Co;
    float s = 0.f;
    for (int v = 0; v < kWarps; ++v) s += part_s[((size_t)v * 16 + cc) * Cop + o];
    out[(size_t)(c0 + cc) * Co + o] = s;
  }
}

// ---------------------------------------------------------------------------
// bf16 K2 on the tensor cores (WMMA, 16x16x16 bf16 products, float32 sums)
// ---------------------------------------------------------------------------

constexpr int kK2Ldt = 24;  // row stride of a staged Θ_h^T plane: 16 channels + 8

__host__ __device__ __forceinline__ int k2_cg(int C) { return C < 16 ? C : 16; }

// dx columns a block: NT chunks of 8 steps of k2_cg(C) channels, padded to 16
__host__ __device__ __forceinline__ int k2_width(int C, int NT) {
  return pad16(NT * k2_cg(C) * kTT);
}

// Shared memory of a bf16 K2 block at NT chunks of 8 steps and TR target
// rows a step (bytes; the layout of k2_wmma_kernel): the warps' staging, the
// step's stage (gm rows, w columns, Θ's two planes), g's two planes.
__host__ __device__ inline size_t k2_wmma_bytes(int BS, int C, int Co, int NT, int TR) {
  const int Cop = pad16(Co);
  return 4 * (size_t)kWarps * kStage +
         2 * ((size_t)Cop * (NT * TR * kTT + 8) + (size_t)pad16(BS) * (TR + 8) +
              2 * (size_t)Cop * kK2Ldt + 2 * (size_t)TR * (k2_width(C, NT) + 8));
}

// Θ split into bf16 hi + lo, transposed and cut into the K2 blocks' groups of
// CG channels: split[(h*n_cg + g)*2 + plane][o][c], o < pad16(Co), c < 16,
// channel g*CG + c (zero past CG, C or Co), one 32-byte row an o
__global__ void k2_theta_split_kernel(const float* __restrict__ thetas,
                                      wm::bf16* __restrict__ split, int H, int C, int Co,
                                      int CG, int n_cg) {
  const int Cop = pad16(Co), n = H * n_cg * Cop * 16;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
    const int c = e % 16, o = e / 16 % Cop, hg = e / (16 * Cop);
    const int ch = hg % n_cg * CG + c;
    const float v =
        c < CG && ch < C && o < Co ? thetas[((size_t)(hg / n_cg) * C + ch) * Co + o] : 0.f;
    wm::bf16* d = split + (size_t)hg * 2 * Cop * 16 + o * 16 + c;
    wm::split(v, d[0], d[(size_t)Cop * 16]);
  }
}

// dx[b, i][:, group]: one block per (group of CG channels x NT chunks of 8
// steps, source tile i, batch), 8 warps holding the (BSp x W) dx tile in
// float32 fragments across the whole walk over i's outgoing slots. A step
// is (slot, TR target rows, head), the head fastest:
//   gm_s[o][(n*TR + t)*8 + tt]  the target rows' cotangent for the group's
//                      chunks (column-major A of the g product), staged at
//                      head 0 and used by every head (gm does not depend on h)
//   w_s[s][t]          w_h's TR target columns as w lies (row-major A)
//   th_s[plane][o][c]  Θ_h^T's hi and lo for the group's channels
//   g = gm_s . Θ_h^T on the tensor cores (two products: float32 in value),
//     split into bf16 hi + lo planes g_h, g_l [t][(n*CG + c)*8 + tt]
//   dx += w_s . g_h + w_s . g_l   (w is bf16: float32 in value)
// NT and TR are powers of two, so the staging indexes by shifts. One stage:
// at the GAMBIA blocks two blocks share an SM, each loading while the other
// multiplies (a second stage would halve the blocks an SM). Warp
// w holds the 4 x 2 fragments of row tiles 4*(w/4) + r and column tiles
// 2*(w%4) + c. The sums run in the same order every launch; each block
// owns its dx columns.
__global__ void __launch_bounds__(kThreads, 2)
k2_wmma_kernel(const int* __restrict__ src_start, const int* __restrict__ src_count,
               const int* __restrict__ src_order, const int* __restrict__ active_tgt,
               const wm::bf16* __restrict__ th_split, const wm::bf16* __restrict__ gm,
               const wm::bf16* __restrict__ w, wm::bf16* __restrict__ dx, int A, int H,
               int NI, int NJ, int BS, int C, int T_len, int Co, int NT, int TR, int vec,
               int vec_w) {
  namespace wmma = nvcuda::wmma;
  using wm::bf16;
  const int CG = k2_cg(C), n_cg = (C + CG - 1) / CG;
  const int cg = blockIdx.x % n_cg, ch0 = blockIdx.x / n_cg * NT;  // first chunk of 8 steps
  const int i = blockIdx.y, b = blockIdx.z;
  const int c0 = cg * CG, cn = min(CG, C - c0);
  const int BSp = pad16(BS), Cop = pad16(Co), W = k2_width(C, NT);
  const int lnt = __ffs(NT) - 1, ltr = __ffs(TR) - 1, lper = lnt + ltr;
  const int ldg = (NT * TR + 1) * kTT, ldw = TR + 8, ldp = W + 8, NR = BSp / TR;
  const size_t M = (size_t)C * T_len, MO = (size_t)Co * T_len;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* scratch = reinterpret_cast<float*>(smem_raw);              // [warp][16][kLdS]
  bf16* gm_s = reinterpret_cast<bf16*>(scratch + kWarps * kStage);  // [Cop][ldg]
  bf16* w_s = gm_s + (size_t)Cop * ldg;                             // [BSp][ldw]
  bf16* th_s = w_s + (size_t)BSp * ldw;                             // [2][Cop][kK2Ldt]
  bf16* g_h = th_s + 2 * (size_t)Cop * kK2Ldt;                      // [TR][ldp]
  bf16* g_l = g_h + (size_t)TR * ldp;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sw = scratch + warp * kStage;
  // zero everything staged: padding rows and columns never written stay zero
  const int n_zero = (Cop * ldg + BSp * ldw + 2 * Cop * kK2Ldt + 2 * TR * ldp) / 8;
  for (int e = threadIdx.x; e < n_zero; e += kThreads) zero16(gm_s + 8 * (size_t)e);
  const int p0 = src_start[i], n_steps = src_count[i] * NR * H;
  // stage step s (its gm rows at head 0), committed as one cp.async group
  auto stage_step = [&](int s) {
    const int h = s % H, r0 = s / H % NR * TR, a = src_order[p0 + s / (H * NR)];
    if (h == 0) {  // segment e: chunk n = e % NT, row t = e / NT % TR, o = e / (NT*TR)
      const bf16* g0 = gm + ((size_t)b * NJ + active_tgt[a]) * BS * MO + (size_t)ch0 * kTT;
      for (int e = threadIdx.x; e < Co << lper; e += kThreads) {
        const int n = e & (NT - 1), t = e >> lnt & (TR - 1), o = e >> lper;
        const int t0 = (ch0 + n) * kTT;
        bf16* d = gm_s + o * ldg + ((n << ltr) + t) * kTT;
        if (r0 + t < BS && t0 < T_len)
          stage_segment(d, g0 + (size_t)(r0 + t) * MO + (size_t)o * T_len + n * kTT, t0, T_len,
                        vec);
        else
          zero16(d);
      }
    }
    const bf16* w_t = w + (((size_t)b * A + a) * H + h) * BS * BS + r0;
    if (vec_w) {  // segment e: row e / (TR/8), columns 8 * (e % (TR/8))
      for (int e = threadIdx.x; e < BS << (ltr - 3); e += kThreads) {
        const int row = e >> (ltr - 3), k = (e & (TR / 8 - 1)) * 8;
        bf16* d = w_s + row * ldw + k;
        if (r0 + k < BS)
          cp_async16(d, w_t + (size_t)row * BS + k);
        else
          zero16(d);
      }
    } else {
      for (int e = threadIdx.x; e < BS << ltr; e += kThreads) {
        const int row = e >> ltr, k = e & (TR - 1);
        w_s[row * ldw + k] = r0 + k < BS ? w_t[(size_t)row * BS + k] : __float2bfloat16_rn(0.f);
      }
    }
    const bf16* ts = th_split + ((size_t)h * n_cg + cg) * 2 * Cop * 16;
    for (int e = threadIdx.x; e < 4 * Cop; e += kThreads)  // 2 planes x Cop rows x 2 segments
      cp_async16(th_s + (e >> 1) * kK2Ldt + (e & 1) * 8, ts + e * 8);
    commit_async();
  };
  const int RF = BSp / 16, CF = W / 16, n_gt = NT * TR / 2;
  const int wr = warp / 4 * 4, wc = warp % 4 * 2;
  wm::FragC acc[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) wmma::fill_fragment(acc[r][c], 0.f);
  __syncthreads();  // zeroed before the first stage lands
  if (n_steps > 0) stage_step(0);
  for (int s = 0; s < n_steps; ++s) {
    wait_async_group<0>();
    __syncthreads();  // step s staged
    // g (rows (n*TR + t)*8 + tt, columns c) = gm_s . Θ_h^T, split into g_h
    // and g_l; a warp's fragments f = warp + 8q, two at a time (past the
    // last, the last again, not stored)
    for (int f0 = warp; f0 < n_gt; f0 += 2 * kWarps) {
      wm::FragC g[2];
      wmma::fill_fragment(g[0], 0.f);
      wmma::fill_fragment(g[1], 0.f);
      for (int k = 0; k < Cop; k += 16) {
        wm::FragB fh, fl;
        wm::load_b_row_shared(fh, th_s + k * kK2Ldt, kK2Ldt);
        wm::load_b_row_shared(fl, th_s + (Cop + k) * kK2Ldt, kK2Ldt);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          wm::FragAt fa;
          wm::load_a_col_shared(fa, gm_s + k * ldg + min(f0 + kWarps * q, n_gt - 1) * 16, ldg);
          wmma::mma_sync(g[q], fa, fh, g[q]);
          wmma::mma_sync(g[q], fa, fl, g[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int f = f0 + kWarps * q;
        if (f >= n_gt) break;
        wm::store_c_shared(sw, g[q], kLdS, true);  // sw[c][t'*8 + tt]
        __syncwarp();
        const int cl = lane % 16, tp = lane / 16, row = f * 2 + tp;  // row = n*TR + t
        if (cl < cn) {
          float v[kTT], lo[kTT];
          *reinterpret_cast<float4*>(v) =
              *reinterpret_cast<const float4*>(sw + cl * kLdS + tp * kTT);
          *reinterpret_cast<float4*>(v + 4) =
              *reinterpret_cast<const float4*>(sw + cl * kLdS + tp * kTT + 4);
#pragma unroll
          for (int tt = 0; tt < kTT; ++tt)
            lo[tt] = v[tt] - __bfloat162float(__float2bfloat16_rn(v[tt]));
          const int o = (row & (TR - 1)) * ldp + ((row >> ltr) * CG + cl) * kTT;
          *reinterpret_cast<uint4*>(g_h + o) = wm::pack8(v);
          *reinterpret_cast<uint4*>(g_l + o) = wm::pack8(lo);
        }
        __syncwarp();
      }
    }
    __syncthreads();  // g_h and g_l written
    for (int k = 0; k < TR; k += 16) {
      wm::FragA fa[4];
      wm::FragB fh[2], fl[2];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (wr + r < RF) wm::load_a_row_shared(fa[r], w_s + (wr + r) * 16 * ldw + k, ldw);
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (wc + c < CF) {
          wm::load_b_row_shared(fh[c], g_h + k * ldp + (wc + c) * 16, ldp);
          wm::load_b_row_shared(fl[c], g_l + k * ldp + (wc + c) * 16, ldp);
        }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (wr + r < RF && wc + c < CF) wmma::mma_sync(acc[r][c], fa[r], fh[c], acc[r][c]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (wr + r < RF && wc + c < CF) wmma::mma_sync(acc[r][c], fa[r], fl[c], acc[r][c]);
    }
    if (s + 1 < n_steps) {
      __syncthreads();  // this step's stage consumed
      stage_step(s + 1);
    }
  }
  // dx rounded to bf16 once: 8 steps of a (source row, channel) a 16-byte store
  const size_t row0 = ((size_t)b * NI + i) * BS;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (wr + r >= RF || wc + c >= CF) continue;
      wm::store_c_shared(sw, acc[r][c], kLdS, false);  // sw[row'][col']
      __syncwarp();
      const int rl = lane % 16, sg = lane / 16, seg = (wc + c) * 2 + sg;
      const int row = (wr + r) * 16 + rl, n = seg / CG, cl = seg % CG, t0 = (ch0 + n) * kTT;
      if (row < BS && n < NT && cl < cn && t0 < T_len) {
        const float* v = sw + rl * kLdS + sg * kTT;
        bf16* d = dx + (row0 + row) * M + (size_t)(c0 + cl) * T_len + t0;
        if (vec)
          *reinterpret_cast<uint4*>(d) = pack8_at(v);
        else
          for (int tt = 0; tt < kTT && t0 + tt < T_len; ++tt) d[tt] = __float2bfloat16_rn(v[tt]);
      }
      __syncwarp();
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

int launch_k1_wmma(const int* active_src, const int* active_tgt, const int* tile_start,
                   const int* tile_count, const float* thetas, const wm::bf16* gm,
                   const wm::bf16* x, const wm::bf16* w, float* dA, float* partial,
                   float* dth, int B, int A, int H, int NJ, int BS, int C, int T_len, int Co,
                   int TN, int TC, int vec, int vec_w, cudaStream_t st) {
  const size_t smem_a = k1_wmma_dA_bytes(BS, C, Co, TN);
  cudaError_t err = allow_smem(k1_dA_wmma_kernel, smem_a);
  if (err != cudaSuccess) return static_cast<int>(err);
  k1_dA_wmma_kernel<<<dim3(A * ((BS + TN - 1) / TN), H, B), kThreads, smem_a, st>>>(
      active_src, active_tgt, thetas, gm, x, dA, A, H, NJ, BS, C, T_len, Co, TN, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = (T_len + kTT - 1) / kTT, CC = k1_wmma_cc(C);
  const size_t smem_b = k1_wmma_dtheta_bytes(BS, C, Co, TC);
  const dim3 grid(((C + CC - 1) / CC) * G, NJ, B * H);
  auto dtheta = [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem_b);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem_b, st>>>(tile_start, tile_count, active_src, gm, x, w,
                                           partial, A, H, NJ, BS, C, T_len, Co, TC, G, vec,
                                           vec_w);
    return cudaGetLastError();
  };
  const int OF = pad16(Co) / 16;
  err = OF <= 2 ? dtheta(k1_dtheta_wmma_kernel<2>)
                : OF <= 4 ? dtheta(k1_dtheta_wmma_kernel<4>) : dtheta(k1_dtheta_wmma_kernel<8>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int S = B * NJ * G;
  return static_cast<int>(
      dense::sum_rows(partial, dth, partial + (size_t)S * H * C * Co, S, H * C * Co, st));
}

int launch_k2(const int* src_start, const int* src_count, const int* src_order,
              const int* active_tgt, const float* thetas, const float* gm, const float* w,
              float* dx, int B, int A, int H, int NI, int NJ, int BS, int C, int T_len, int Co,
              int TT, cudaStream_t st) {
  const int ldg = (Co * TT) | 1;
  const size_t smem = sizeof(float) * (kK * kLdRows + kK * kCols + kK * ldg + H * C * Co);
  cudaError_t err = allow_smem(k2_kernel<float>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k2_kernel<float><<<dim3((T_len + TT - 1) / TT, NI, B), kThreads, smem, st>>>(
      src_start, src_count, src_order, active_tgt, thetas, gm, w, dx, A, H, NI, NJ, BS, C,
      T_len, Co, TT);
  return static_cast<int>(cudaGetLastError());
}

int launch_k2_wmma(const int* src_start, const int* src_count, const int* src_order,
                   const int* active_tgt, const float* thetas, wm::bf16* th_split,
                   const wm::bf16* gm, const wm::bf16* w, wm::bf16* dx, int B, int A, int H,
                   int NI, int NJ, int BS, int C, int T_len, int Co, int NT, int TR, int vec,
                   int vec_w, cudaStream_t st) {
  const int CG = k2_cg(C), n_cg = (C + CG - 1) / CG, n = H * n_cg * pad16(Co) * 16;
  k2_theta_split_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      thetas, th_split, H, C, Co, CG, n_cg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = k2_wmma_bytes(BS, C, Co, NT, TR);
  err = allow_smem(k2_wmma_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tg = ((T_len + kTT - 1) / kTT + NT - 1) / NT;
  k2_wmma_kernel<<<dim3(n_cg * n_tg, NI, B), kThreads, smem, st>>>(
      src_start, src_count, src_order, active_tgt, th_split, gm, w, dx, A, H, NI, NJ, BS, C,
      T_len, Co, NT, TR, vec, vec_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// float32 K1 on `stream`: dA (B, A, H, BS, BS), dTheta (H, C, Co); partial
// is (B*H*NJ*G, C*Co) float scratch. The dA pass covers TTa time steps a
// chunk (its staged gm rows hold Co*TTa columns), the dTheta pass TTc
// (C*TTc <= 64 columns of sums). Returns cudaGetLastError() (0 = success).
int bell_bwd_k1(const int* active_src, const int* active_tgt, const int* tile_start,
                const int* tile_count, const float* thetas, const void* gm, const void* x,
                const void* w, float* dA, float* partial, float* dth, int B, int A, int H,
                int NJ, int BS, int C, int T_len, int Co, int TTa, int TTc, int G,
                void* stream) {
  return launch_k1<float>(active_src, active_tgt, tile_start, tile_count, thetas, gm, x, w,
                          dA, partial, dth, B, A, H, NJ, BS, C, T_len, Co, TTa, TTc, G,
                          static_cast<cudaStream_t>(stream));
}

// bf16 K1 on `stream`, on the tensor cores: dA (B, A, H, BS, BS), dTheta
// (H, C, Co); partial is float scratch of (S + ceil(S/64)) * H*C*Co floats,
// S = B*NJ*ceil(T/8) (the partials, then sum_rows' groups). The dA
// pass takes TN target columns a block (a power of two, 16..128), the dTheta
// pass contracts TC target rows at a time (a multiple of 16 dividing
// pad16(BS)); vec: T % 8 == 0 and gm, x 16-byte aligned (cp.async row
// segments), vec_w: BS % 8 == 0 and w 16-byte aligned.
int bell_bwd_k1_wmma(const int* active_src, const int* active_tgt, const int* tile_start,
                     const int* tile_count, const float* thetas, const void* gm,
                     const void* x, const void* w, float* dA, float* partial, float* dth,
                     int B, int A, int H, int NJ, int BS, int C, int T_len, int Co, int TN,
                     int TC, int vec, int vec_w, void* stream) {
  return launch_k1_wmma(active_src, active_tgt, tile_start, tile_count, thetas,
                        static_cast<const wm::bf16*>(gm), static_cast<const wm::bf16*>(x),
                        static_cast<const wm::bf16*>(w), dA, partial, dth, B, A, H, NJ, BS,
                        C, T_len, Co, TN, TC, vec, vec_w, static_cast<cudaStream_t>(stream));
}

// Shared memory a block of the bf16 K1's dA pass (pass 0, at `tile` = TN)
// or dTheta pass (pass 1, at `tile` = TC) requests, in bytes.
size_t bell_bwd_k1_wmma_smem_bytes(int BS, int C, int Co, int tile, int pass) {
  return pass == 0 ? k1_wmma_dA_bytes(BS, C, Co, tile) : k1_wmma_dtheta_bytes(BS, C, Co, tile);
}

// float32 K2 on `stream`: dx (B, NI*BS, C*T), TT time steps a block.
int bell_bwd_k2(const int* src_start, const int* src_count, const int* src_order,
                const int* active_tgt, const float* thetas, const void* gm, const void* w,
                void* dx, int B, int A, int H, int NI, int NJ, int BS, int C, int T_len,
                int Co, int TT, void* stream) {
  return launch_k2(src_start, src_count, src_order, active_tgt, thetas,
                   static_cast<const float*>(gm), static_cast<const float*>(w),
                   static_cast<float*>(dx), B, A, H, NI, NJ, BS, C, T_len, Co, TT,
                   static_cast<cudaStream_t>(stream));
}

// bf16 K2 on `stream`, on the tensor cores: dx (B, NI*BS, C*T) bf16;
// th_split is bf16 scratch of H * ceil(C/CG) * 2 * pad16(Co) * 16 values
// (CG = min(C, 16)). NT chunks of 8 steps a block and TR target rows a step,
// both powers of two (TR >= 16, dividing pad16(BS)); vec: T % 8 == 0 and
// gm, dx 16-byte aligned (cp.async row segments, 16-byte stores), vec_w:
// BS % 8 == 0 and w 16-byte aligned.
int bell_bwd_k2_wmma(const int* src_start, const int* src_count, const int* src_order,
                     const int* active_tgt, const float* thetas, void* th_split, const void* gm,
                     const void* w, void* dx, int B, int A, int H, int NI, int NJ, int BS,
                     int C, int T_len, int Co, int NT, int TR, int vec, int vec_w,
                     void* stream) {
  return launch_k2_wmma(src_start, src_count, src_order, active_tgt, thetas,
                        static_cast<wm::bf16*>(th_split), static_cast<const wm::bf16*>(gm),
                        static_cast<const wm::bf16*>(w), static_cast<wm::bf16*>(dx), B, A, H,
                        NI, NJ, BS, C, T_len, Co, NT, TR, vec, vec_w,
                        static_cast<cudaStream_t>(stream));
}

// Shared memory a block of the bf16 K2 requests, in bytes.
size_t bell_bwd_k2_wmma_smem_bytes(int BS, int C, int Co, int NT, int TR) {
  return k2_wmma_bytes(BS, C, Co, NT, TR);
}

const char* bell_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
