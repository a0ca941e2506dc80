// Backward kernels of the fused BELL conv for sm_90a: K1 (dA and dTheta)
// and K2 (dx).
//
// With gm (B, Np, Co*T) the output cotangent times the ReLU mask and
// g_agg_h[n, c, t] = sum_o Theta[h, c, o] gm[n, o, t]:
//   K1  dA[b, a, h]  = x[src(a)] . round(g_agg_h[tgt(a)])^T       (BS x BS, float)
//       dTheta[h]    = sum_{b, a} (w[b, a, h]^T x[src(a)])^T . gm[tgt(a)]
//   K2  dx[i]        = sum_{a: src(a) = i} sum_h w[b, a, h] . g_agg_h[tgt(a)]
// round() is the cast to the compute dtype that the TPU kernel applies
// before its dA product, once, after the whole sum over Co; K2 keeps g_agg in
// float32 (as its bf16 hi + lo: float32 in value). Layouts as in
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
// One design for both dtypes, every product on the tensor cores (WMMA, bf16
// products summed in float32), in chunks of 8 time steps (one 16-byte row
// segment, cp.async for bf16 where T % 8 == 0), tiles padded to 16; float32
// operands split into bf16 hi + lo where staged (bell_common.cuh), three
// products where two float32 values meet. Channels, output channels and
// rows come in chunks, so no block's shared memory grows with C, Co or BS:
//   k1_dA_wmma_kernel: one block per (active entry, TN target columns, RS <=
//     128 source rows, head, batch) holds its dA tile in float32 fragments
//     across 8 warps. For each chunk of 8 steps and CC channels it forms
//     g_agg = gm . Θ_h^T on the tensor cores over Co in chunks of OCC (gm
//     and Θ's hi + lo staged a chunk at a time, the float32 sums waiting in
//     shared memory between chunks), rounds it to the compute dtype once,
//     after the whole Co sum, as the TPU kernel does, and adds x_src .
//     g_agg^T (the channel chunks add into the same dA fragments).
//   k1_dtheta_wmma_kernel: one block per (CC channels, target tile, <= 128
//     target rows, OCB output columns, time group, batch and head) sums, for
//     each chunk of 8 steps of its group, agg = sum_u w_u^T x_u over the
//     tile's slots (source rows KS a stage), splits agg into bf16 hi + lo
//     and contracts it with gm over (target row, step) into float32
//     fragments held across the group: dTheta float32 in value. Each block
//     writes its rows of a (C, Co) partial; dense::sum_rows sums them in a
//     fixed order (no atomics: two runs give the same bits). Time groups
//     fold as many chunks into a block as keep the partials within a budget
//     (ops/cuda/bell_bwd.py k1_time_groups).
//   k2_wmma_kernel: one block per (group of up to 16 channels x NT chunks of
//     8 steps, <= 128 source rows, source tile, batch) holds its dx tile in
//     float32 fragments across the walk over the tile's outgoing slots, so
//     w is staged as it lies (row-major A, no transpose) once per column
//     group, not per time chunk. Per slot, TR target rows and head it forms
//     g = gm . Θ_h^T over Co in chunks of OCC (Θ split hi + lo by
//     k2_theta_split_kernel; where one chunk holds Co, the gm rows are staged
//     once for every head), splits g into bf16 hi + lo planes and adds
//     w_h . g_hi + w_h . g_lo: float32 in value.
// Neither K1 pass nor K2 writes g_agg or agg to device memory. What bounds
// them is staging and latency, not the tensor cores (PERF.md).

#include "bell_common.cuh"

namespace {

using namespace bell;

__host__ __device__ __forceinline__ size_t max_sz(size_t a, size_t b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int min_i(int a, int b) { return a < b ? a : b; }

// ---------------------------------------------------------------------------
// K1, the dA pass
// ---------------------------------------------------------------------------

// Shared memory of the dA pass (bytes) at TN target columns, RS source rows,
// CC channels and OCC output channels a chunk, P planes a staged operand: the
// warps' staging; the x region (x_s [P][RS][ldx], or, where Co takes more
// than one chunk, g's float32 sums [TN*8][pad16(CC)] while they wait,
// whichever is larger); g_s [P][TN][ldx]; gm_s [P][pad16(OCC)][TN*8 + 8];
// Θ_h's hi and lo [2][pad16(CC)][pad16(OCC) + 8] (bf16).
__host__ __device__ inline size_t k1_dA_bytes(int P, int Co, int TN, int RS, int CC, int OCC) {
  const int ldx = pad16(CC * kTT) + 8, ldg = TN * kTT + 8, OCCp = pad16(OCC), ldt = OCCp + 8;
  const size_t xr = max_sz((size_t)P * RS * ldx,
                           cdiv(Co, OCC) > 1 ? 2 * (size_t)TN * kTT * pad16(CC) : 0);
  return 4 * (size_t)kWarps * kStage +
         2 * (xr + (size_t)P * TN * ldx + (size_t)P * OCCp * ldg + 2 * (size_t)pad16(CC) * ldt);
}

// dA[b, a, h][rs0 : rs0 + RS, tc : tc + TN]: one block per (active entry, TN
// target columns, RS source rows, head, batch), 8 warps. For each chunk of
// kTT steps and CC channels c0 ..:
//   gm_s[o][t*8 + tt]  the target rows' cotangent for OCC output channels
//                      (column-major A of the g_agg product, rows (t, tt),
//                      depth o); where one chunk holds Co it stays for every
//                      channel chunk of the time chunk
//   g_agg = gm_s . Θ_h[chunk]^T on the tensor cores, Θ_h split into bf16 hi
//     + lo (two products, three for float32 gm), summed over the Co chunks
//     (g_f between them), rounded to the compute dtype once into
//   g_s[t][c*8 + tt]   (the B operand of the dA product, depth (c, tt);
//                      float32: its hi and lo)
//   x_s[s][c*8 + tt]   the source rows (the A operand)
//   dA += x_s . g_s^T  in float32 accumulators held across every chunk.
// The next time chunk's gm rows load (cp.async) while the dA products run.
// Warp w holds the dA fragments w + 8i (column w % (TN/16) for every i).
template <typename TIn, bool kOC>
__global__ void __launch_bounds__(kThreads, 1)
k1_dA_wmma_kernel(const int* __restrict__ active_src, const int* __restrict__ active_tgt,
                  const float* __restrict__ thetas, const TIn* __restrict__ gm,
                  const TIn* __restrict__ x, float* __restrict__ dA, int A, int H, int NJ,
                  int BS, int C, int T_len, int Co, int TN, int RS, int CC, int OCC, int vec) {
  namespace wmma = nvcuda::wmma;
  using wm::bf16;
  constexpr bool F32 = sizeof(TIn) == 4;
  constexpr int P = Planes<TIn>::n;
  const int CCp = pad16(CC), OCCp = pad16(OCC);
  const int Kp = pad16(CC * kTT), ldx = Kp + 8, ldg = TN * kTT + 8, ldt = OCCp + 8;
  const int n_sub = cdiv(BS, TN), n_rs = cdiv(BS, RS), n_cc = cdiv(C, CC);
  const int n_oc = kOC ? cdiv(Co, OCC) : 1;
  const int a = blockIdx.x / (n_sub * n_rs), rem = blockIdx.x % (n_sub * n_rs);
  const int tc = rem / n_rs * TN, rs0 = rem % n_rs * RS;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t Np = (size_t)NJ * BS, M = (size_t)C * T_len, MO = (size_t)Co * T_len;
  const size_t src_row0 = b * Np + (size_t)active_src[a] * BS + rs0;
  const size_t tgt_row0 = b * Np + (size_t)active_tgt[a] * BS + tc;
  const int n_tgt = min(TN, BS - tc), n_src = min(RS, BS - rs0);
  const size_t xr = max_sz((size_t)P * RS * ldx, kOC ? 2 * (size_t)TN * kTT * CCp : 0);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* scratch = reinterpret_cast<float*>(smem_raw);            // [warp][16][kLdS]
  bf16* x_s = reinterpret_cast<bf16*>(scratch + kWarps * kStage);  // [P][RS][ldx]
  float* g_f = reinterpret_cast<float*>(x_s);                     // [frag][256] (n_oc > 1)
  bf16* g_s = x_s + xr;                                           // [P][TN][ldx]
  bf16* gm_s = g_s + (size_t)P * TN * ldx;                        // [P][OCCp][ldg]
  bf16* th_h = gm_s + (size_t)P * OCCp * ldg;                     // [CCp][ldt]
  bf16* th_l = th_h + (size_t)CCp * ldt;
  const size_t px = (size_t)RS * ldx, pg = (size_t)TN * ldx, pgm = (size_t)OCCp * ldg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sw = scratch + warp * kStage;
  // zero what is staged (gm_s rows and columns never staged stay zero)
  const size_t n_zero = (xr + P * pg + P * pgm) / 8;
  for (size_t e = threadIdx.x; e < n_zero; e += kThreads) zero16(x_s + 8 * e);
  auto stage_th = [&](int c0, int o0) {  // Θ_h[c0 .., o0 ..] split, zeros past C and Co
    const int cn = min(CC, C - c0), on = min(OCC, Co - o0);
    for (int e = threadIdx.x; e < CCp * ldt; e += kThreads) {
      const int c = e / ldt, o = e % ldt;
      wm::split(c < cn && o < on ? thetas[((size_t)h * C + c0 + c) * Co + o0 + o] : 0.f,
                th_h[e], th_l[e]);
    }
  };
  auto stage_gm = [&](int t0, int o0) {  // gm_s[o][t*8 + tt] for o < on, t < n_tgt
    const int on = min(OCC, Co - o0);
    for (int e = threadIdx.x; e < on * n_tgt; e += kThreads) {
      const int o = e / n_tgt, t = e % n_tgt;
      seg8(gm_s + (size_t)o * ldg + t * kTT, pgm,
           gm + (tgt_row0 + t) * MO + (size_t)(o0 + o) * T_len + t0, T_len - t0, vec);
    }
    commit_async();
  };
  const int x_segs = Kp / kTT;
  auto stage_x = [&](int t0, int c0) {  // x_s[s][c*8 + tt] (zeros past the rows and C)
    const int cn = min(CC, C - c0);
    for (int e = threadIdx.x; e < RS * x_segs; e += kThreads) {
      const int r = e / x_segs, c = e % x_segs;
      bf16* d = x_s + (size_t)r * ldx + c * kTT;
      if (r < n_src && c < cn)
        seg8(d, px, x + (src_row0 + r) * M + (size_t)(c0 + c) * T_len + t0, T_len - t0, vec);
      else
        zero8(d, px, F32);
    }
    commit_async();
  };
  const int RF = RS / 16, CF = TN / 16, n_frag = RF * CF;
  const int GR = TN * kTT / 16, GC = CCp / 16, n_gfrag = GR * GC;
  const int c_out = Kp / kTT;  // g_s channels written (CC, even)
  const int cf = warp % CF;    // CF is a power of two <= 8
  // g_agg (rows (t, tt), columns c) = gm_s . Θ^T over this Co chunk, added
  // to the sums of the earlier chunks (g_f) unless first, rounded into g_s
  // if last; a warp's fragments f = warp + 8i, four at a time (past the
  // last, the last again, not stored) so that their loads and products
  // interleave
  auto g_phase = [&](bool first, bool last) {
    for (int f0 = warp; f0 < n_gfrag; f0 += 4 * kWarps) {
      wm::FragC g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (first)
          wmma::fill_fragment(g[q], 0.f);
        else
          wmma::load_matrix_sync(g[q], g_f + (size_t)min(f0 + kWarps * q, n_gfrag - 1) * 256, 16,
                                 wmma::mem_row_major);
      }
      for (int k = 0; k < OCCp; k += 16) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int f = min(f0 + kWarps * q, n_gfrag - 1), gr = f / GC, gc = f % GC;
          wm::FragAt fa, fal;
          wm::FragBt fh, fl;
          wmma::load_matrix_sync(fa, gm_s + (size_t)k * ldg + gr * 16, ldg);
          if constexpr (F32) wmma::load_matrix_sync(fal, gm_s + pgm + (size_t)k * ldg + gr * 16, ldg);
          wmma::load_matrix_sync(fh, th_h + gc * 16 * ldt + k, ldt);
          wmma::load_matrix_sync(fl, th_l + gc * 16 * ldt + k, ldt);
          mma_split_b<F32>(g[q], fa, fal, fh, fl);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int f = f0 + kWarps * q, gr = f / GC, gc = f % GC;
        if (f >= n_gfrag) break;
        if (!last) {
          wmma::store_matrix_sync(g_f + (size_t)f * 256, g[q], 16, wmma::mem_row_major);
          continue;
        }
        wmma::store_matrix_sync(sw, g[q], kLdS, wmma::mem_col_major);  // sw[c][t'*8 + tt]
        __syncwarp();
        const int cl = lane % 16, tp = lane / 16, c = gc * 16 + cl;
        if (c < c_out) {
          bf16* d = g_s + (size_t)(gr * 2 + tp) * ldx + c * kTT;
          if constexpr (F32)
            split8(sw + cl * kLdS + tp * kTT, d, d + pg);
          else
            *reinterpret_cast<uint4*>(d) = pack8_at(sw + cl * kLdS + tp * kTT);
        }
        __syncwarp();
      }
    }
  };
  int rows[8];  // first x_s row of each fragment slot
#pragma unroll
  for (int i = 0; i < 8; ++i) rows[i] = min(warp + kWarps * i, n_frag - 1) / CF * 16;
  wm::FragC acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) wmma::fill_fragment(acc[i], 0.f);
  const bool th_once = n_cc == 1 && !kOC;
  if (th_once) stage_th(0, 0);
  __syncthreads();  // zeroed before the first stage
  if (!kOC) stage_gm(0, 0);
  constexpr int kG = F32 ? 4 : 8;  // dA fragments loaded and multiplied together
  for (int t0 = 0; t0 < T_len; t0 += kTT) {
    for (int ci = 0; ci < n_cc; ++ci) {
      const int c0 = ci * CC;
      if constexpr (!kOC) {
        if (!th_once) stage_th(c0, 0);
        stage_x(t0, c0);
        wm::wait_async();
        __syncthreads();
        g_phase(true, true);
        __syncthreads();  // g_s written, gm_s consumed
        if (ci == n_cc - 1 && t0 + kTT < T_len) stage_gm(t0 + kTT, 0);
      } else {
        for (int oi = 0; oi < n_oc; ++oi) {
          stage_th(c0, oi * OCC);
          stage_gm(t0, oi * OCC);
          wm::wait_async();
          __syncthreads();
          g_phase(oi == 0, oi == n_oc - 1);
          __syncthreads();  // gm_s and Θ consumed; g_f or g_s written
        }
        stage_x(t0, c0);  // over g_f, read for the last time above
        wm::wait_async();
        __syncthreads();
      }
      // dA += x_s . g_s^T over this chunk's Kp columns; every fragment slot
      // is loaded and multiplied (past the last, the last row again, not
      // stored), so the loads of a step go out together ahead of its products
#pragma unroll 2
      for (int k = 0; k < Kp; k += 16) {
        wm::FragBt fb, fbl;
        wmma::load_matrix_sync(fb, g_s + (size_t)cf * 16 * ldx + k, ldx);
        if constexpr (F32) wmma::load_matrix_sync(fbl, g_s + pg + (size_t)cf * 16 * ldx + k, ldx);
#pragma unroll
        for (int i0 = 0; i0 < 8; i0 += kG) {
          wm::FragA fa[kG], fal[kG];
#pragma unroll
          for (int i = 0; i < kG; ++i) {
            wmma::load_matrix_sync(fa[i], x_s + (size_t)rows[i0 + i] * ldx + k, ldx);
            if constexpr (F32)
              wmma::load_matrix_sync(fal[i], x_s + px + (size_t)rows[i0 + i] * ldx + k, ldx);
          }
#pragma unroll
          for (int i = 0; i < kG; ++i) mma3<F32>(acc[i0 + i], fa[i], fal[i], fb, fbl);
        }
      }
      __syncthreads();  // x_s and g_s consumed
    }
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
      if (r < n_src && c < n_tgt)
        dA_t[(size_t)(rs0 + r) * BS + tc + c] = sw[(e / 16) * kLdS + e % 16];
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// K1, the dΘ pass
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int k1_dtheta_cc(int C) {  // channels an m-tile
  int cc = 16;
  while (cc > C) cc /= 2;
  return cc;
}

// the dΘ block's first region: P planes of the w and x stages (slot loop),
// then the warps' staging (agg conversion), then the depth groups' partials
// (the end), at KS source rows a stage, OCB output columns and WO o-lanes
__host__ __device__ inline size_t k1_dtheta_region(int P, int BS, int C, int KS, int OCB,
                                                   int WO) {
  const int ldw = min_i(pad16(BS), 128) + 8, ldm = pad16(k1_dtheta_cc(C) * kTT) + 8;
  return max_sz(max_sz(2 * (size_t)P * KS * (ldw + ldm), 4 * (size_t)(kWarps / WO) * 16 * OCB),
                4 * (size_t)kWarps * kStage);
}

// Shared memory of the dΘ pass (bytes) at TC target rows a contraction chunk:
// the region, agg's hi and lo [2][16][TC*8 + 8] and gm_s [P][OCB][TC*8 + 8].
__host__ __device__ inline size_t k1_dtheta_bytes(int P, int BS, int C, int TC, int KS, int OCB,
                                                  int WO) {
  const int ld = TC * kTT + 8;
  return k1_dtheta_region(P, BS, C, KS, OCB, WO) +
         2 * (2 * (size_t)16 * ld + (size_t)P * OCB * ld);
}

// dΘ partials: one block per (m-tile, target tile j, target-row tile, output
// block, time group, batch and head); an m-tile is CC channels (a power of
// two <= 16) of a chunk of kTT steps; the target-row tile TRr = min(pad16(BS),
// 128) rows from tr0.
//   agg (TRr targets x CC*8) = sum over j's slots of w^T . x_src on the
//     tensor cores (float32 sums), KS source rows a stage, 8 warps, warp w
//     holding fragments w + 8i; w staged [s][t] (column-major A), x [s][c*8
//     + tt]; every staged element is written each stage (the region is the
//     warps' staging in between)
//   then TC target rows at a time: agg split into bf16 hi + lo,
//     [cc][t*8 + tt] (row-major A, depth (t, tt)), gm staged [o][t*8 + tt]
//     (column-major B), partial[cc][o] += agg . gm: warp w takes o-tiles
//     w % WO + WO*q (q < kOF) and the depth steps w / WO + (8/WO)*i, its
//     fragments held across the group's time chunks; the depth groups' sums
//     are added in a fixed order at the end.
// Each block writes its CC rows (its output columns) of partial[b, j, tr,
// g][h] (C, Co); the fixed-order dense::sum_rows sums the rows. Two bf16
// blocks an SM where a warp holds at most two partial fragments for one time
// chunk; a block that folds several (kFold) keeps them live across the slot
// loop and takes the registers of one block an SM.
template <int kOF, bool kFold, typename TIn>
__global__ void __launch_bounds__(kThreads, kOF <= 2 && !kFold && sizeof(TIn) == 2 ? 2 : 1)
k1_dtheta_wmma_kernel(const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                      const int* __restrict__ active_src, const TIn* __restrict__ gm,
                      const TIn* __restrict__ x, const TIn* __restrict__ w,
                      float* __restrict__ partial, int A, int H, int NJ, int BS, int C,
                      int T_len, int Co, int TC, int KS, int OCB, int WO, int G, int TG, int vec,
                      int vec_w) {
  namespace wmma = nvcuda::wmma;
  using wm::bf16;
  constexpr bool F32 = sizeof(TIn) == 4;
  constexpr int P = Planes<TIn>::n;
  const int CC = k1_dtheta_cc(C), n_cg = cdiv(C, CC);
  const int BSp = pad16(BS), TRr = min(BSp, 128), n_tr = cdiv(BSp, TRr);
  const int Cop = pad16(Co), n_ob = cdiv(Cop, OCB);
  int r = blockIdx.x;  // (((j*n_cg + cg)*n_ob + ob)*n_tr + tr)*G + g
  const int g_idx = r % G;
  r /= G;
  const int tr = r % n_tr;
  r /= n_tr;
  const int ob = r % n_ob;
  r /= n_ob;
  const int cg = r % n_cg, j = r / n_cg;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int c0 = cg * CC, cn = min(CC, C - c0);
  const int tr0 = tr * TRr, TRp = min(TRr, BSp - tr0);
  const int o_lo = ob * OCB, o_n = min(OCB, Cop - o_lo), OF = o_n / 16;
  const int MTp = pad16(CC * kTT), ldw = TRr + 8, ldm = MTp + 8, ld = TC * kTT + 8;
  const size_t Np = (size_t)NJ * BS, M = (size_t)C * T_len, MO = (size_t)Co * T_len;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const size_t region = k1_dtheta_region(P, BS, C, KS, OCB, WO);
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);         // [P][KS][ldw]  (slot loop)
  bf16* x_s = w_s + (size_t)P * KS * ldw;               // [P][KS][ldm]
  float* scratch = reinterpret_cast<float*>(smem_raw);   // [warp][16][kLdS] (agg chunks)
  float* part_s = reinterpret_cast<float*>(smem_raw);    // [8/WO][16][o_n] (the end)
  bf16* agg_h = reinterpret_cast<bf16*>(smem_raw + region);  // [16][ld]
  bf16* agg_l = agg_h + 16 * ld;
  bf16* gm_s = agg_l + 16 * ld;                          // [P][OCB][ld]
  const size_t pw = (size_t)KS * ldw, pxm = (size_t)KS * ldm, pgm = (size_t)OCB * ld;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // o-lanes: one where a warp holds at most 2 partial fragments (the plan
  // gives WO = 1 there), a constant of the kernel
  const int wo = kOF <= 2 ? 1 : WO;
  const int n_dg = kWarps / wo, ol = warp % wo, dg = warp / wo;
  float* sw = scratch + warp * kStage;
  // zero agg (its rows past the channels stay zero) and gm_s
  const size_t n_zero = (2 * (size_t)16 * ld + P * pgm) / 8;
  for (size_t e = threadIdx.x; e < n_zero; e += kThreads) zero16(agg_h + 8 * e);
  const int start = tile_start[j], count = tile_count[j];
  const int AR = TRp / 16, AC = MTp / 16, n_frag = AR * AC;
  const int ac = warp % AC;  // AC is a power of two <= 8
  int cols[8];               // first w_s column (target) of each fragment slot
#pragma unroll
  for (int i = 0; i < 8; ++i) cols[i] = min(warp + kWarps * i, n_frag - 1) / AC * 16;
  const int w_segs = TRp / 8, x_segs = MTp / kTT;
  const size_t tgt_row0 = b * Np + (size_t)j * BS + tr0;
  // the partial's fragments: zero before the group's first chunk where the
  // block folds several (kFold), else after the one chunk's slot loop, so
  // that they are not live across it
  wm::FragC pacc[kOF];
  auto zero_pacc = [&] {
#pragma unroll
    for (int q = 0; q < kOF; ++q) wmma::fill_fragment(pacc[q], 0.f);
  };
  if (kFold) zero_pacc();
  // one chunk of 8 steps: agg over the slots, then its contraction with gm
  auto time_chunk = [&](int ch) {
    const int t0 = ch * kTT;
    wm::FragC acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) wmma::fill_fragment(acc[i], 0.f);
    for (int u = 0; u < count; ++u) {
      const int a = start + u;
      const size_t src_row0 = b * Np + (size_t)active_src[a] * BS;
      const TIn* w_t = w + (((size_t)b * A + a) * H + h) * BS * BS;
      for (int k0 = 0; k0 < BS; k0 += KS) {
        const int nk = min(KS, BS - k0);
        __syncthreads();  // the region's last readers (stages, staging) done
        if (vec_w) {
          for (int e = threadIdx.x; e < KS * w_segs; e += kThreads) {
            const int k = e / w_segs, s = e % w_segs, col = tr0 + 8 * s;
            bf16* d = w_s + (size_t)k * ldw + 8 * s;
            if (k < nk && col < BS)
              seg8(d, pw, w_t + (size_t)(k0 + k) * BS + col, kTT, true);
            else
              zero8(d, pw, F32);
          }
        } else {
          for (int e = threadIdx.x; e < KS * TRp; e += kThreads) {
            const int k = e / TRp, t = e % TRp;
            put(w_s + (size_t)k * ldw + t, pw,
                k < nk && tr0 + t < BS ? w_t[(size_t)(k0 + k) * BS + tr0 + t] : zero_of<TIn>());
          }
        }
        for (int e = threadIdx.x; e < KS * x_segs; e += kThreads) {
          const int k = e / x_segs, c = e % x_segs;
          bf16* d = x_s + (size_t)k * ldm + c * kTT;
          if (k < nk && c < cn)
            seg8(d, pxm, x + (src_row0 + k0 + k) * M + (size_t)(c0 + c) * T_len + t0, T_len - t0,
                 vec);
          else
            zero8(d, pxm, F32);
        }
        commit_async();
        wm::wait_async();
        __syncthreads();
        // every fragment slot, four at a time (past the last, the last again)
        const int kend = pad16(nk);
        for (int k = 0; k < kend; k += 16) {
          wm::FragB fb, fbl;
          wmma::load_matrix_sync(fb, x_s + (size_t)k * ldm + ac * 16, ldm);
          if constexpr (F32) wmma::load_matrix_sync(fbl, x_s + pxm + (size_t)k * ldm + ac * 16, ldm);
#pragma unroll
          for (int i0 = 0; i0 < 8; i0 += 4) {
            wm::FragAt fa[4], fal[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              wmma::load_matrix_sync(fa[i], w_s + (size_t)k * ldw + cols[i0 + i], ldw);
              if constexpr (F32)
                wmma::load_matrix_sync(fal[i], w_s + pw + (size_t)k * ldw + cols[i0 + i], ldw);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) mma3<F32>(acc[i0 + i], fa[i], fal[i], fb, fbl);
          }
        }
      }
    }
    // partial[cc][o] += sum over (t, tt) of agg[cc][t*8 + tt] gm[t][o*T + t0 + tt]
    if (!kFold) zero_pacc();
    for (int t1 = 0; t1 < TRp; t1 += TC) {
      __syncthreads();  // the slot loop's stages, or the last chunk's agg and gm_s, consumed
      const int n_t = max(0, min(TC, BS - tr0 - t1));
      for (int e = threadIdx.x; e < o_n * TC; e += kThreads) {
        const int o = e / TC, t = e % TC;
        bf16* d = gm_s + (size_t)o * ld + t * kTT;
        if (t < n_t && o_lo + o < Co)
          seg8(d, pgm, gm + (tgt_row0 + t1 + t) * MO + (size_t)(o_lo + o) * T_len + t0,
               T_len - t0, vec);
        else
          zero8(d, pgm, F32);
      }
      commit_async();
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
          const size_t o = (size_t)cc * ld + (r0 - t1 + tl) * kTT;
          split8(sw + tl * kLdS + ccl * kTT, agg_h + o, agg_l + o);
        }
        __syncwarp();
      }
      wm::wait_async();
      __syncthreads();
      for (int ks = dg; ks < TC * kTT / 16; ks += n_dg) {
        wm::FragA fh, fl;
        wmma::load_matrix_sync(fh, agg_h + ks * 16, ld);
        wmma::load_matrix_sync(fl, agg_l + ks * 16, ld);
#pragma unroll
        for (int q = 0; q < kOF; ++q) {
          const int oq = ol + wo * q;
          if (oq < OF) {
            wm::FragBt fb, fbl;
            wmma::load_matrix_sync(fb, gm_s + (size_t)oq * 16 * ld + ks * 16, ld);
            wmma::mma_sync(pacc[q], fh, fb, pacc[q]);
            wmma::mma_sync(pacc[q], fl, fb, pacc[q]);
            if constexpr (F32) {
              wmma::load_matrix_sync(fbl, gm_s + pgm + (size_t)oq * 16 * ld + ks * 16, ld);
              wmma::mma_sync(pacc[q], fh, fbl, pacc[q]);
            }
          }
        }
      }
    }
  };
  if constexpr (kFold) {
    const int ch_end = min(cdiv(T_len, kTT), (g_idx + 1) * TG);
    for (int ch = g_idx * TG; ch < ch_end; ++ch) time_chunk(ch);
  } else {
    time_chunk(g_idx);
  }
  __syncthreads();  // part_s overlays the stages and the warps' staging
#pragma unroll
  for (int q = 0; q < kOF; ++q) {
    const int oq = ol + wo * q;
    if (oq < OF)
      wmma::store_matrix_sync(part_s + (size_t)dg * 16 * o_n + oq * 16, pacc[q], o_n,
                              wmma::mem_row_major);
  }
  __syncthreads();
  float* out = partial + ((((size_t)b * NJ + j) * n_tr + tr) * G + g_idx) * H * C * Co +
               (size_t)h * C * Co;
  const int ov = min(o_n, Co - o_lo);
  for (int e = threadIdx.x; e < cn * ov; e += kThreads) {
    const int cc = e / ov, o = e % ov;
    float s = 0.f;
    for (int v = 0; v < n_dg; ++v) s += part_s[((size_t)v * 16 + cc) * o_n + o];
    out[(size_t)(c0 + cc) * Co + o_lo + o] = s;
  }
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

constexpr int kK2Ldt = 24;  // row stride of a staged Θ_h^T plane: 16 channels + 8

__host__ __device__ __forceinline__ int k2_cg(int C) { return C < 16 ? C : 16; }

// dx columns a block: NT chunks of 8 steps of k2_cg(C) channels, padded to 16
__host__ __device__ __forceinline__ int k2_width(int C, int NT) {
  return pad16(NT * k2_cg(C) * kTT);
}

// Shared memory of a K2 block at NT chunks of 8 steps, TR target rows a step
// and OCC output channels a chunk, P planes a staged operand (bytes; the
// layout of k2_wmma_kernel): the warps' staging, the step's stage (gm rows,
// w columns of min(pad16(BS), 128) source rows, Θ's two planes), g's two
// planes, and, where Co takes more than one chunk, g's float32 sums.
__host__ __device__ inline size_t k2_wmma_bytes(int P, int BS, int C, int Co, int NT, int TR,
                                                int OCC) {
  const int OCCp = pad16(OCC), RS = min_i(pad16(BS), 128);
  const bool multi = cdiv(pad16(Co), OCCp) > 1;
  return 4 * (size_t)kWarps * kStage +
         2 * ((size_t)P * OCCp * (NT * TR * kTT + 8) + (size_t)P * RS * (TR + 8) +
              2 * (size_t)OCCp * kK2Ldt + 2 * (size_t)TR * (k2_width(C, NT) + 8)) +
         (multi ? 4 * (size_t)NT * TR * kTT * 16 : 0);
}

// Θ split into bf16 hi + lo, transposed and cut into the K2 blocks' groups of
// CG channels: split[(h*n_cg + g)*2 + plane][o][c], o < pad16(Co), c < 16,
// channel g*CG + c (zero past CG, C or Co), one 32-byte row an o
__global__ void k2_theta_split_kernel(const float* __restrict__ thetas,
                                      wm::bf16* __restrict__ split, int H, int C, int Co,
                                      int CG, int n_cg) {
  const int Cop = pad16(Co);
  const size_t n = (size_t)H * n_cg * Cop * 16;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int c = e % 16, o = e / 16 % Cop, hg = e / (16 * (size_t)Cop);
    const int ch = hg % n_cg * CG + c;
    const float v =
        c < CG && ch < C && o < Co ? thetas[((size_t)(hg / n_cg) * C + ch) * Co + o] : 0.f;
    wm::bf16* d = split + (size_t)hg * 2 * Cop * 16 + o * 16 + c;
    wm::split(v, d[0], d[(size_t)Cop * 16]);
  }
}

// dx[b, i][rs0 : rs0 + RS, group]: one block per (group of CG channels x NT
// chunks of 8 steps, RS = min(pad16(BS), 128) source rows, source tile i,
// batch), 8 warps holding the (RS x W) dx tile in float32 fragments across
// the whole walk over i's outgoing slots. A step is (slot, TR target rows,
// head, Co chunk), the chunk fastest:
//   gm_s[o][(n*TR + t)*8 + tt]  the target rows' cotangent for the group's
//                      chunks and OCC output channels (column-major A of the
//                      g product); where one chunk holds Co, staged at head 0
//                      and used by every head (gm does not depend on h)
//   w_s[s][t]          w_h's TR target columns as w lies (row-major A), at
//                      the chunk 0 of its (slot, rows, head)
//   th_s[plane][o][c]  Θ_h^T's hi and lo for the group's channels and chunk
//   g = gm_s . Θ_h^T on the tensor cores (two products, three for float32
//     gm: float32 in value), summed over the Co chunks (g_f between them),
//     split after the last into bf16 hi + lo planes g_h, g_l
//     [t][(n*CG + c)*8 + tt]
//   dx += w_s . g_h + w_s . g_l (+ w_lo . g_h for float32 w)
// NT and TR are powers of two, so the staging indexes by shifts. One stage:
// at the GAMBIA blocks two bf16 blocks share an SM, each loading while the
// other multiplies. Warp w holds the 4 x 2 fragments of row tiles
// 4*(w/4) + r and column tiles 2*(w%4) + c. The sums run in the same order
// every launch; each block owns its dx columns.
template <typename TIn, bool kOC>
__global__ void __launch_bounds__(kThreads, sizeof(TIn) == 2 ? 2 : 1)
k2_wmma_kernel(const int* __restrict__ src_start, const int* __restrict__ src_count,
               const int* __restrict__ src_order, const int* __restrict__ active_tgt,
               const wm::bf16* __restrict__ th_split, const TIn* __restrict__ gm,
               const TIn* __restrict__ w, TIn* __restrict__ dx, int A, int H, int NI, int NJ,
               int BS, int C, int T_len, int Co, int NT, int TR, int OCC, int vec, int vec_w) {
  namespace wmma = nvcuda::wmma;
  using wm::bf16;
  constexpr bool F32 = sizeof(TIn) == 4;
  constexpr int P = Planes<TIn>::n;
  const int CG = k2_cg(C), n_cg = cdiv(C, CG);
  const int BSp = pad16(BS), RS = min(BSp, 128), n_rs = cdiv(BSp, RS);
  const int Cop = pad16(Co), OCCp = pad16(OCC), n_oc = kOC ? cdiv(Cop, OCCp) : 1;
  const int n_tg = cdiv(cdiv(T_len, kTT), NT);
  int r = blockIdx.x;  // ((i*n_tg + tg)*n_rs + rs)*n_cg + cg
  const int cg = r % n_cg;
  r /= n_cg;
  const int rs = r % n_rs;
  r /= n_rs;
  const int ch0 = r % n_tg * NT, i = r / n_tg, b = blockIdx.z;  // ch0: first chunk of 8 steps
  const int c0 = cg * CG, cn = min(CG, C - c0), rs0 = rs * RS, RSp = min(RS, BSp - rs0);
  const int W = k2_width(C, NT);
  const int lnt = __ffs(NT) - 1, ltr = __ffs(TR) - 1, lper = lnt + ltr;
  const int ldg = (NT * TR + 1) * kTT, ldw = TR + 8, ldp = W + 8, NR = BSp / TR;
  const size_t M = (size_t)C * T_len, MO = (size_t)Co * T_len;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* scratch = reinterpret_cast<float*>(smem_raw);              // [warp][16][kLdS]
  bf16* gm_s = reinterpret_cast<bf16*>(scratch + kWarps * kStage);  // [P][OCCp][ldg]
  bf16* w_s = gm_s + (size_t)P * OCCp * ldg;                        // [P][RS][ldw]
  bf16* th_s = w_s + (size_t)P * RS * ldw;                          // [2][OCCp][kK2Ldt]
  bf16* g_h = th_s + 2 * (size_t)OCCp * kK2Ldt;                     // [TR][ldp]
  bf16* g_l = g_h + (size_t)TR * ldp;
  float* g_f = reinterpret_cast<float*>(g_l + (size_t)TR * ldp);     // [frag][256] (n_oc > 1)
  const size_t pgm = (size_t)OCCp * ldg, pw = (size_t)RS * ldw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sw = scratch + warp * kStage;
  // zero everything staged: padding rows and columns never written stay zero
  const size_t n_zero = (P * pgm + P * pw + 2 * (size_t)OCCp * kK2Ldt + 2 * (size_t)TR * ldp) / 8;
  for (size_t e = threadIdx.x; e < n_zero; e += kThreads) zero16(gm_s + 8 * e);
  const int p0 = src_start[i], n_steps = src_count[i] * NR * H * n_oc;
  // stage step s, committed as one cp.async group
  auto stage_step = [&](int s) {
    const int oi = s % n_oc, h = s / n_oc % H, r0 = s / (n_oc * H) % NR * TR;
    const int a = src_order[p0 + s / (n_oc * H * NR)];
    const int o0 = oi * OCCp, ocn = min(OCCp, Cop - o0);
    if (kOC || h == 0) {  // segment e: chunk n = e % NT, row t = e / NT % TR, o = e / (NT*TR)
      const TIn* g0 = gm + ((size_t)b * NJ + active_tgt[a]) * BS * MO + (size_t)ch0 * kTT;
      for (int e = threadIdx.x; e < ocn << lper; e += kThreads) {
        const int n = e & (NT - 1), t = e >> lnt & (TR - 1), o = e >> lper;
        const int t0 = (ch0 + n) * kTT;
        bf16* d = gm_s + o * ldg + ((n << ltr) + t) * kTT;
        if (r0 + t < BS && t0 < T_len && o0 + o < Co)
          seg8(d, pgm, g0 + (size_t)(r0 + t) * MO + (size_t)(o0 + o) * T_len + n * kTT,
               T_len - t0, vec);
        else
          zero8(d, pgm, F32);
      }
    }
    if (!kOC || oi == 0) {
      const TIn* w_t = w + (((size_t)b * A + a) * H + h) * BS * BS + (size_t)rs0 * BS + r0;
      const int nrow = min(RS, BS - rs0);
      if (vec_w) {  // segment e: row e / (TR/8), columns 8 * (e % (TR/8))
        for (int e = threadIdx.x; e < nrow << (ltr - 3); e += kThreads) {
          const int row = e >> (ltr - 3), k = (e & (TR / 8 - 1)) * 8;
          bf16* d = w_s + row * ldw + k;
          if (r0 + k < BS)
            seg8(d, pw, w_t + (size_t)row * BS + k, kTT, true);
          else
            zero8(d, pw, F32);
        }
      } else {
        for (int e = threadIdx.x; e < nrow << ltr; e += kThreads) {
          const int row = e >> ltr, k = e & (TR - 1);
          put(w_s + row * ldw + k, pw, r0 + k < BS ? w_t[(size_t)row * BS + k] : zero_of<TIn>());
        }
      }
    }
    const bf16* ts = th_split + ((size_t)h * n_cg + cg) * 2 * Cop * 16 + (size_t)o0 * 16;
    for (int e = threadIdx.x; e < 4 * OCCp; e += kThreads) {  // 2 planes x OCCp rows x 2 segments
      if constexpr (!kOC) {  // the chunk is both planes whole: contiguous
        cp_async16(th_s + (e >> 1) * kK2Ldt + (e & 1) * 8, ts + e * 8);
      } else {
        const int pl = e / (2 * OCCp), row = (e >> 1) % OCCp, sg = e & 1;
        bf16* d = th_s + (pl * OCCp + row) * kK2Ldt + sg * 8;
        if (row < ocn)
          cp_async16(d, ts + (size_t)pl * Cop * 16 + row * 16 + sg * 8);
        else
          zero16(d);
      }
    }
    commit_async();
  };
  const int RF = RSp / 16, CF = W / 16, n_gt = NT * TR / 2;
  const int wr = warp / 4 * 4, wc = warp % 4 * 2;
  wm::FragC acc[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) wmma::fill_fragment(acc[r][c], 0.f);
  __syncthreads();  // zeroed before the first stage lands
  if (n_steps > 0) stage_step(0);
  for (int s = 0; s < n_steps; ++s) {
    const int oi = kOC ? s % n_oc : 0;
    const bool first = !kOC || oi == 0, last = !kOC || oi == n_oc - 1;
    wait_async_group<0>();
    __syncthreads();  // step s staged
    // g (rows (n*TR + t)*8 + tt, columns c) = gm_s . Θ_h^T over this chunk,
    // added to the earlier chunks' sums (g_f) unless first, split into g_h
    // and g_l if last; a warp's fragments f = warp + 8q, two at a time (past
    // the last, the last again, not stored)
    for (int f0 = warp; f0 < n_gt; f0 += 2 * kWarps) {
      wm::FragC g[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (first)
          wmma::fill_fragment(g[q], 0.f);
        else
          wmma::load_matrix_sync(g[q], g_f + (size_t)min(f0 + kWarps * q, n_gt - 1) * 256, 16,
                                 wmma::mem_row_major);
      }
      for (int k = 0; k < OCCp; k += 16) {
        wm::FragB fh, fl;
        wm::load_b_row_shared(fh, th_s + k * kK2Ldt, kK2Ldt);
        wm::load_b_row_shared(fl, th_s + (OCCp + k) * kK2Ldt, kK2Ldt);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          wm::FragAt fa, fal;
          const int col = min(f0 + kWarps * q, n_gt - 1) * 16;
          wm::load_a_col_shared(fa, gm_s + k * ldg + col, ldg);
          if constexpr (F32) wm::load_a_col_shared(fal, gm_s + pgm + k * ldg + col, ldg);
          mma_split_b<F32>(g[q], fa, fal, fh, fl);
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int f = f0 + kWarps * q;
        if (f >= n_gt) break;
        if (!last) {
          wmma::store_matrix_sync(g_f + (size_t)f * 256, g[q], 16, wmma::mem_row_major);
          continue;
        }
        wm::store_c_shared(sw, g[q], kLdS, true);  // sw[c][t'*8 + tt]
        __syncwarp();
        const int cl = lane % 16, tp = lane / 16, row = f * 2 + tp;  // row = n*TR + t
        if (cl < cn) {
          const int o = (row & (TR - 1)) * ldp + ((row >> ltr) * CG + cl) * kTT;
          split8(sw + cl * kLdS + tp * kTT, g_h + o, g_l + o);
        }
        __syncwarp();
      }
    }
    if (last) {
      __syncthreads();  // g_h and g_l written
      for (int k = 0; k < TR; k += 16) {
        wm::FragA fa[4], fal[4];
        wm::FragB fh[2], fl[2];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (wr + r < RF) {
            wm::load_a_row_shared(fa[r], w_s + (wr + r) * 16 * ldw + k, ldw);
            if constexpr (F32) wm::load_a_row_shared(fal[r], w_s + pw + (wr + r) * 16 * ldw + k, ldw);
          }
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
        if constexpr (F32) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (wr + r < RF && wc + c < CF) wmma::mma_sync(acc[r][c], fal[r], fh[c], acc[r][c]);
        }
      }
    }
    if (s + 1 < n_steps) {
      __syncthreads();  // this step's stage consumed
      stage_step(s + 1);
    }
  }
  // dx rounded to the compute dtype once: 8 steps of a (source row, channel)
  const size_t row0 = ((size_t)b * NI + i) * BS + rs0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (wr + r >= RF || wc + c >= CF) continue;
      wm::store_c_shared(sw, acc[r][c], kLdS, false);  // sw[row'][col']
      __syncwarp();
      const int rl = lane % 16, sg = lane / 16, seg = (wc + c) * 2 + sg;
      const int row = (wr + r) * 16 + rl, n = seg / CG, cl = seg % CG, t0 = (ch0 + n) * kTT;
      if (rs0 + row < BS && n < NT && cl < cn && t0 < T_len) {
        float v[kTT];
        *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(sw + rl * kLdS + sg * kTT);
        *reinterpret_cast<float4*>(v + 4) =
            *reinterpret_cast<const float4*>(sw + rl * kLdS + sg * kTT + 4);
        store8(dx + (row0 + row) * M + (size_t)(c0 + cl) * T_len + t0, v, T_len - t0, vec);
      }
      __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename TIn>
int launch_k1(const int* active_src, const int* active_tgt, const int* tile_start,
              const int* tile_count, const float* thetas, const void* gm, const void* x,
              const void* w, float* dA, float* partial, float* dth, int B, int A, int H, int NJ,
              int BS, int C, int T_len, int Co, int TN, int RS, int CC, int OCC, int TC, int KS,
              int OCB, int WO, int G, int TG, int vec, int vec_w, cudaStream_t st) {
  constexpr int P = Planes<TIn>::n;
  const size_t smem_a = k1_dA_bytes(P, Co, TN, RS, CC, OCC);
  auto dA_pass = [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem_a);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(A * cdiv(BS, TN) * cdiv(BS, RS), H, B), kThreads, smem_a, st>>>(
        active_src, active_tgt, thetas, static_cast<const TIn*>(gm), static_cast<const TIn*>(x),
        dA, A, H, NJ, BS, C, T_len, Co, TN, RS, CC, OCC, vec);
    return cudaGetLastError();
  };
  cudaError_t err = cdiv(Co, OCC) > 1 ? dA_pass(k1_dA_wmma_kernel<TIn, true>)
                                      : dA_pass(k1_dA_wmma_kernel<TIn, false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int CC1 = k1_dtheta_cc(C), n_tr = cdiv(pad16(BS), 128);
  const size_t smem_b = k1_dtheta_bytes(P, BS, C, TC, KS, OCB, WO);
  const dim3 grid(NJ * cdiv(C, CC1) * cdiv(pad16(Co), OCB) * n_tr * G, 1, B * H);
  auto dtheta = [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem_b);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem_b, st>>>(tile_start, tile_count, active_src,
                                           static_cast<const TIn*>(gm), static_cast<const TIn*>(x),
                                           static_cast<const TIn*>(w), partial, A, H, NJ, BS, C,
                                           T_len, Co, TC, KS, OCB, WO, G, TG, vec, vec_w);
    return cudaGetLastError();
  };
  const int kof = cdiv(cdiv(min_i(OCB, pad16(Co)), 16), WO);
  if (kof > 4 || (kof <= 2 && WO != 1))  // tiles the plan never gives
    return static_cast<int>(cudaErrorInvalidValue);
  err = TG > 1 ? (kof <= 2 ? dtheta(k1_dtheta_wmma_kernel<2, true, TIn>)
                           : dtheta(k1_dtheta_wmma_kernel<4, true, TIn>))
               : (kof <= 2 ? dtheta(k1_dtheta_wmma_kernel<2, false, TIn>)
                           : dtheta(k1_dtheta_wmma_kernel<4, false, TIn>));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int S = B * NJ * n_tr * G;
  return static_cast<int>(
      dense::sum_rows(partial, dth, partial + (size_t)S * H * C * Co, S, H * C * Co, st));
}

template <typename TIn>
int launch_k2(const int* src_start, const int* src_count, const int* src_order,
              const int* active_tgt, const float* thetas, wm::bf16* th_split, const void* gm,
              const void* w, void* dx, int B, int A, int H, int NI, int NJ, int BS, int C,
              int T_len, int Co, int NT, int TR, int OCC, int vec, int vec_w, cudaStream_t st) {
  const int CG = k2_cg(C), n_cg = cdiv(C, CG);
  const size_t n = (size_t)H * n_cg * pad16(Co) * 16;
  const size_t blocks = (n + kThreads - 1) / kThreads;
  k2_theta_split_kernel<<<(int)(blocks < 65535 ? blocks : 65535), kThreads, 0, st>>>(
      thetas, th_split, H, C, Co, CG, n_cg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = k2_wmma_bytes(Planes<TIn>::n, BS, C, Co, NT, TR, OCC);
  const int n_tg = cdiv(cdiv(T_len, kTT), NT), n_rs = cdiv(pad16(BS), 128);
  auto dx_pass = [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(NI * n_tg * n_rs * n_cg, 1, B), kThreads, smem, st>>>(
        src_start, src_count, src_order, active_tgt, th_split, static_cast<const TIn*>(gm),
        static_cast<const TIn*>(w), static_cast<TIn*>(dx), A, H, NI, NJ, BS, C, T_len, Co, NT,
        TR, OCC, vec, vec_w);
    return cudaGetLastError();
  };
  return static_cast<int>(cdiv(pad16(Co), pad16(OCC)) > 1 ? dx_pass(k2_wmma_kernel<TIn, true>)
                                                          : dx_pass(k2_wmma_kernel<TIn, false>));
}

}  // namespace

extern "C" {

// K1 on `stream` (f32: float32 gm, x, w; else bf16): dA (B, A, H, BS, BS),
// dTheta (H, C, Co); partial is float scratch of (S + ceil(S/64)) * H*C*Co
// floats, S = B*NJ*ceil(pad16(BS)/128)*G (the partials, then sum_rows'
// groups). The dA pass takes TN target columns and RS source rows a block
// (powers of two, 16..128), CC channels and OCC output channels a chunk; the
// dTheta pass contracts TC target rows at a time (a multiple of 16 dividing
// min(pad16(BS), 128)), stages KS source rows, takes OCB output columns a
// block over WO o-lanes and TG chunks of 8 steps a time group (G groups);
// tiles that bell_bwd.k1_plan gives. vec: T % 8 == 0 and gm, x 16-byte
// aligned, vec_w: BS % 8 == 0 and w 16-byte aligned. Returns
// cudaGetLastError() after the launches (0 = success).
int bell_bwd_k1(const int* active_src, const int* active_tgt, const int* tile_start,
                const int* tile_count, const float* thetas, const void* gm, const void* x,
                const void* w, float* dA, float* partial, float* dth, int B, int A, int H,
                int NJ, int BS, int C, int T_len, int Co, int f32, int TN, int RS, int CC,
                int OCC, int TC, int KS, int OCB, int WO, int G, int TG, int vec, int vec_w,
                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return f32 ? launch_k1<float>(active_src, active_tgt, tile_start, tile_count, thetas, gm, x,
                                w, dA, partial, dth, B, A, H, NJ, BS, C, T_len, Co, TN, RS, CC,
                                OCC, TC, KS, OCB, WO, G, TG, vec, vec_w, st)
             : launch_k1<wm::bf16>(active_src, active_tgt, tile_start, tile_count, thetas, gm,
                                   x, w, dA, partial, dth, B, A, H, NJ, BS, C, T_len, Co, TN,
                                   RS, CC, OCC, TC, KS, OCB, WO, G, TG, vec, vec_w, st);
}

// Shared memory a block of K1's dA pass (pass 0, at tiles (TN, RS, CC, OCC))
// or dTheta pass (pass 1, at tiles (TC, KS, OCB, WO)) requests, in bytes.
size_t bell_bwd_k1_wmma_smem_bytes(int f32, int BS, int C, int Co, int t0, int t1, int t2,
                                   int t3, int pass) {
  const int P = f32 ? 2 : 1;
  return pass == 0 ? k1_dA_bytes(P, Co, t0, t1, t2, t3)
                   : k1_dtheta_bytes(P, BS, C, t0, t1, t2, t3);
}

// K2 on `stream` (f32: float32 gm, w, dx; else bf16): dx (B, NI*BS, C*T);
// th_split is bf16 scratch of H * ceil(C/CG) * 2 * pad16(Co) * 16 values
// (CG = min(C, 16)). NT chunks of 8 steps a block and TR target rows a step,
// both powers of two (TR >= 16, dividing pad16(BS)), OCC output channels a
// chunk (a multiple of 16, or pad16(Co)); vec: T % 8 == 0 and gm, dx 16-byte
// aligned, vec_w: BS % 8 == 0 and w 16-byte aligned.
int bell_bwd_k2(const int* src_start, const int* src_count, const int* src_order,
                const int* active_tgt, const float* thetas, void* th_split, const void* gm,
                const void* w, void* dx, int B, int A, int H, int NI, int NJ, int BS, int C,
                int T_len, int Co, int f32, int NT, int TR, int OCC, int vec, int vec_w,
                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* split = static_cast<wm::bf16*>(th_split);
  return f32 ? launch_k2<float>(src_start, src_count, src_order, active_tgt, thetas, split, gm,
                                w, dx, B, A, H, NI, NJ, BS, C, T_len, Co, NT, TR, OCC, vec,
                                vec_w, st)
             : launch_k2<wm::bf16>(src_start, src_count, src_order, active_tgt, thetas, split,
                                   gm, w, dx, B, A, H, NI, NJ, BS, C, T_len, Co, NT, TR, OCC,
                                   vec, vec_w, st);
}

// Shared memory a K2 block requests, in bytes.
size_t bell_bwd_k2_wmma_smem_bytes(int f32, int BS, int C, int Co, int NT, int TR, int OCC) {
  return k2_wmma_bytes(f32 ? 2 : 1, BS, C, Co, NT, TR, OCC);
}

const char* bell_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
