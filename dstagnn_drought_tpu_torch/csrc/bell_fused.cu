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
// (B, A, H, BS, BS) are in the compute dtype (float or bf16). Any C, Co,
// block size and d_k.
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
// peak). Two passes:
//   pass 1 (weights_kernel, both dtypes): one block per (32 target columns,
//     j, h, b) computes each target column's max and sum of exp over every
//     slot (online, even and odd source rows apart, merged at the end),
//     then recomputes the scores and writes w = T_k (.) exp(s - max) / sum
//     in the compute dtype into the scratch (the softmax needs the whole
//     neighbourhood before any weight is final); scores in float32 on the
//     CUDA cores, as the TPU kernel takes q and k in float32, over d_k in
//     chunks of kDC staged columns (one chain of FMAs a score, in order, so
//     the chunks do not change its bits);
//   pass 2 (f_spmm_wmma_kernel, both dtypes, on the tensor cores): one block
//     per (NT chunks of 8 steps S, TN target columns, OCB output columns, j,
//     b). It takes the channels in chunks of CC and the heads in groups of
//     HG (JAX's c-major M-tiles, the Theta mix summed across them): for each
//     (channel chunk, head group), agg = w^T . x over every slot's source
//     rows, KC rows a stage in two stages (cp.async for bf16; w read as a
//     column-major A, no transpose; x by 16-byte row segments of 8 steps),
//     the HG heads sharing each stage's x rows; agg leaves the accumulators
//     split into bf16 hi + lo ([hh*CC + c][t*S + step] in shared memory), and
//     out += agg . Theta[group, chunk, :] contracts over (hh, c) in three
//     bf16 products (hi.hi + hi.lo + lo.hi) against Theta, split in the same
//     way into the freed stages: float32 in value, as the TPU kernel mixes a
//     float32 agg by a float32 Theta. Where the block takes more than one
//     (chunk, group), out's float32 sums wait in shared memory between them;
//     the last applies the ReLU, rounds once and stores 8 steps a (target,
//     output channel). Float32 x and w are split into hi + lo where staged,
//     and the SpMM is three products too. Where the output columns do not
//     fit one block's sums, they are tiled across blocks (OCB), each output
//     tile written once, by the block that owns it.
// The (B, H, Np, C*T) aggregation never reaches device memory. Ragged edges
// are masked in the kernels; no block sums across another, so two launches
// give the same bits.

#include "bell_common.cuh"

namespace {

using namespace bell;

constexpr int kQRows = 32;  // source rows of q staged per chunk
constexpr int kWCols = 32;  // target columns a weights block (a lane a column)
constexpr int kDC = 128;    // d_k columns of q and k staged at a time

// One online (max, sum of exp) pair over a target column's scores in order.
__device__ __forceinline__ void online_update(float s, float& m, float& l) {
  if (s > m) {
    l = l * expf(m - s) + 1.f;
    m = s;
  } else {
    l += expf(s - m);
  }
}

__host__ __device__ inline size_t weights_smem_bytes(int dk) {
  const int dc = dk < kDC ? dk : kDC;
  return sizeof(float) * (kQRows * dc + kQRows * (kWCols + 1) + 4 * kWCols +
                          (dk == 32 ? 0 : kWCols * (dc | 1)));
}

// The weights pass: one block per (kWCols target columns, j, h, b), 8
// warps, lane = column. For each chunk of kQRows source rows of each slot,
// warp w scores rows w + 8i of the lane's column (its k row in registers
// where DK > 0, q rows read as float4; else both from shared memory, over d_k
// in chunks of kDC columns, k's chunk restaged with q's where there is more
// than one). Pass 0 puts the scores in shared memory and warp 0 (even rows)
// and warp 1 (odd rows) fold them in row order into online (max, sum) pairs,
// merged into the column's max and 1/sum at the end (even rows first); pass
// 1 recomputes the scores and writes w. The order of each column's sums is
// fixed: the float32 forward's bits depend on it.
template <typename T, int DK>
__global__ void __launch_bounds__(kThreads)
weights_kernel(const int* __restrict__ tile_start, const int* __restrict__ tile_count,
               const int* __restrict__ active_src, const float* __restrict__ q,
               const float* __restrict__ k, const float* __restrict__ bias,
               const float* __restrict__ cheb, T* __restrict__ w, int A, int H,
               int NJ, int BS, int dk, float scale) {
  constexpr int kLdS32 = kWCols + 1;
  const int n_ct = (BS + kWCols - 1) / kWCols;
  const int j = blockIdx.x / n_ct, c0 = (blockIdx.x % n_ct) * kWCols;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t Np = (size_t)NJ * BS;
  const int col = c0 + lane;  // target column of this lane
  const bool live = col < BS;
  const int dc = DK > 0 ? DK : min(dk, kDC), n_dc = (dk + dc - 1) / dc;
  const int ldk = dc | 1;     // odd stride: column reads hit distinct banks
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                      // [kQRows][dc]
  float* s_s = q_s + kQRows * dc;         // [kQRows][kLdS32] scores (pass 0)
  float* stat = s_s + kQRows * kLdS32;    // [4][kWCols]: m, l of both parities
  float* k_s = stat + 4 * kWCols;         // [kWCols][ldk] (DK == 0)
  float kr[DK > 0 ? DK : 1];
  auto stage_k = [&](int d0, int dn) {
    for (int e = threadIdx.x; e < kWCols * dn; e += kThreads) {
      const int t = e / dn, d = e % dn;
      if (c0 + t < BS)
        k_s[t * ldk + d] = k[((b * Np + (size_t)j * BS + c0 + t) * H + h) * dk + d0 + d];
    }
  };
  if (DK > 0) {
    if (live)
      for (int d = 0; d < DK; ++d) kr[d] = k[((b * Np + (size_t)j * BS + col) * H + h) * DK + d];
  } else if (n_dc == 1) {
    stage_k(0, dk);
  }
  // s += q row r . k column over the staged chunk of dn columns
  auto score = [&](int r, int dn, float s) {
    if (DK > 0) {
      const float4* q4 = reinterpret_cast<const float4*>(q_s + r * DK);
#pragma unroll
      for (int d4 = 0; d4 < DK / 4; ++d4) {
        const float4 v = q4[d4];
        s = fmaf(v.x, kr[4 * d4], s);
        s = fmaf(v.y, kr[4 * d4 + 1], s);
        s = fmaf(v.z, kr[4 * d4 + 2], s);
        s = fmaf(v.w, kr[4 * d4 + 3], s);
      }
    } else {
      for (int d = 0; d < dn; ++d) s = fmaf(q_s[r * dn + d], k_s[lane * ldk + d], s);
    }
    return s;
  };
  const int start = tile_start[j], count = tile_count[j];
  float m = -INFINITY, l = 0.f;  // warps 0 and 1: the online pair of one parity
  float mx = 0.f, inv = 0.f;     // the column's max and 1/sum (pass 1)
  for (int pass = 0; pass < 2; ++pass) {
    for (int u = 0; u < count; ++u) {
      const int a = start + u;
      const size_t src_row0 = b * Np + (size_t)active_src[a] * BS;
      const size_t tile = ((size_t)a * H + h) * BS * BS;
      T* w_t = w + (((size_t)b * A + a) * H + h) * BS * BS;
      for (int r0 = 0; r0 < BS; r0 += kQRows) {
        const int nr = min(kQRows, BS - r0);
        // the scores s[i] of rows warp + 8i: out to the scores (pass 0) or w
        auto emit = [&](const float (&s)[kQRows / kWarps]) {
#pragma unroll
          for (int i = 0; i < kQRows / kWarps; ++i) {
            const int r = warp + kWarps * i;
            if (r >= nr) break;
            const size_t o = (size_t)(r0 + r) * BS + col;
            const float v = s[i] * scale + bias[tile + o];
            if (pass == 0)
              s_s[r * kLdS32 + lane] = v;
            else
              w_t[o] = from_f<T>(cheb[tile + o] * (expf(v - mx) * inv));
          }
        };
        auto stage_q = [&](int d0, int dn) {
          for (int e = threadIdx.x; e < nr * dn; e += kThreads) {
            const int r = e / dn, d = e % dn;
            q_s[e] = q[((src_row0 + r0 + r) * H + h) * dk + d0 + d];
          }
        };
        if constexpr (DK > 0) {
          __syncthreads();  // the last chunk's q rows and scores consumed
          stage_q(0, DK);
          __syncthreads();
          if (live) {
            float s[kQRows / kWarps];
#pragma unroll
            for (int i = 0; i < kQRows / kWarps; ++i) {
              const int r = warp + kWarps * i;
              s[i] = r < nr ? score(r, DK, 0.f) : 0.f;
            }
            emit(s);
          }
        } else {
          float s[kQRows / kWarps];
#pragma unroll
          for (int i = 0; i < kQRows / kWarps; ++i) s[i] = 0.f;
          for (int d0 = 0; d0 < dk; d0 += dc) {
            const int dn = min(dc, dk - d0);
            __syncthreads();  // the last chunk's q rows (k columns) and scores consumed
            stage_q(d0, dn);
            if (n_dc > 1) stage_k(d0, dn);
            __syncthreads();
            if (live) {
#pragma unroll
              for (int i = 0; i < kQRows / kWarps; ++i) {
                const int r = warp + kWarps * i;
                if (r < nr) s[i] = score(r, dn, s[i]);
              }
            }
          }
          if (live) emit(s);
        }
        if (pass == 0) {
          __syncthreads();
          if (warp < 2 && live)
            for (int r = warp; r < nr; r += 2) online_update(s_s[r * kLdS32 + lane], m, l);
        }
      }
    }
    if (pass == 0) {
      if (warp < 2) {
        stat[(2 * warp) * kWCols + lane] = m;
        stat[(2 * warp + 1) * kWCols + lane] = l;
      }
      __syncthreads();
      if (live) {
        const float m0 = stat[lane], l0 = stat[kWCols + lane];
        const float m1 = stat[2 * kWCols + lane], l1 = stat[3 * kWCols + lane];
        mx = fmaxf(m0, m1);
        float sum = 0.f;
        if (l0 > 0.f) sum += l0 * expf(m0 - mx);
        if (l1 > 0.f) sum += l1 * expf(m1 - mx);
        inv = 1.f / fmaxf(sum, 1e-30f);
      }
    }
  }
}

template <typename T>
cudaError_t launch_weights(const int* tile_start, const int* tile_count, const int* active_src,
                           const float* q, const float* k, const float* bias,
                           const float* cheb, void* w, int B, int A, int H, int NJ, int BS,
                           int dk, float scale, cudaStream_t st) {
  const size_t smem1 = weights_smem_bytes(dk);
  auto kernel = dk == 32 ? weights_kernel<T, 32> : weights_kernel<T, 0>;
  cudaError_t err = allow_smem(kernel, smem1);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(NJ * ((BS + kWCols - 1) / kWCols), H, B), kThreads, smem1, st>>>(
      tile_start, tile_count, active_src, q, k, bias, cheb, static_cast<T*>(w), A, H, NJ,
      BS, dk, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// pass 2 on the tensor cores (WMMA, 16x16x16 bf16 products, float32 sums)
// ---------------------------------------------------------------------------

constexpr int kFStages = 2;  // SpMM stages: one loads while the other is multiplied

// Shared memory of f_spmm_wmma_kernel (bytes) at TN target columns, NT chunks
// of kTT steps, KC source rows and HG heads a stage, CC channels a chunk and
// OCB output columns, P planes a staged operand (2: float32, split): the
// warps' staging; the stage region (two stages of P planes of HG w tiles
// [KC][TN + 8] and x [KC][pad16(CC*S) + 8]; in the mix, Θ's hi and lo in
// output-column chunks); agg's hi and lo for the HG heads of a chunk
// [pad16(HG*CC)][TN*S + 8] (bf16); and, where the block takes more than one
// (channel chunk, head group), the float32 sums of its output tile.
__host__ __device__ inline size_t f_wmma_stage_bytes(int P, int CC, int TN, int NT, int KC,
                                                     int HG) {
  return 2 * (size_t)kFStages * P * KC * (HG * (TN + 8) + pad16(CC * NT * kTT) + 8);
}

__host__ __device__ inline size_t f_wmma_smem_bytes(int P, int C, int H, int TN, int NT, int KC,
                                                    int HG, int CC, int OCB) {
  const bool multi = cdiv(C, CC) * cdiv(H, HG) > 1;
  return 4 * (size_t)kWarps * kStage + f_wmma_stage_bytes(P, CC, TN, NT, KC, HG) +
         4 * (size_t)pad16(HG * CC) * (TN * NT * kTT + 8) +
         (multi ? 4 * (size_t)TN * NT * kTT * OCB : 0);
}

// out[b, j*BS + tc + t][o*T + t0 + step] for TN = 16*RF target columns, S =
// NT*kTT steps from t0 and the OCB output columns from o_lo: one block per
// (j, output block, column tile, chunk group), 8 warps.
//   For each channel chunk c0 .. c0 + CC and head group h0 .. h0 + HG:
//   agg (TN targets x W = CC*S columns (c, step)) of each head = sum over
//     j's slots and their source rows of w_s^T . x_s: w_s [k][t] (column-
//     major A), x_s [k][c*S + step] (row-major B), both read as fragments
//     by ldmatrix (wm::load_*_shared). A stage holds KC source rows of x and
//     of the w tiles of HG heads, which share it; the next stage loads
//     (cp.async for bf16) while the tensor cores run on this one.
//     Warp w holds, for each of the HG heads, every row tile and the column
//     tiles w*CW .. w*CW + CW - 1 (past the last, the last again, not kept).
//   agg -> bf16 hi + lo into agg_h/agg_l [hh*CC + c][t*S + step] (heads past
//     H and channels past C are zeros: their accumulators and x columns are).
//   Θ[group, chunk, block's columns] (float) is split into bf16 hi + lo in
//     the stage region, OC output columns at a time, and the out tile (TN*S
//     rows (t, step) x OC) += agg . Θ over (hh, c) in three products a depth
//     step, warp w taking row tiles w + 8i: the sums start at zero at the
//     first (chunk, group), wait in out_s between, and at the last the
//     epilogue applies the ReLU and writes 8 steps a (target, output
//     channel) as one 16-byte store (two for float32).
// The stage region's padding (target columns past BS, x columns past W) is
// zero at the first (chunk, group) and may hold the mix's Θ afterwards: it
// reaches only agg rows and columns that no output reads.
template <int RF, int CW, int HG, typename TIn>
__global__ void __launch_bounds__(kThreads, 1)
f_spmm_wmma_kernel(const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                   const int* __restrict__ active_src, const TIn* __restrict__ w,
                   const TIn* __restrict__ x, const float* __restrict__ thetas,
                   TIn* __restrict__ out, int A, int H, int NJ, int BS, int C, int T_len,
                   int Co, int NT, int KC, int CC, int OCB, int vec, int vec_w) {
  namespace wmma = nvcuda::wmma;
  using wm::bf16;
  constexpr bool F32 = sizeof(TIn) == 4;
  constexpr int P = Planes<TIn>::n;
  constexpr int TN = RF * 16;
  const int S = NT * kTT, W = CC * S, Wp = pad16(W), CF = Wp / 16;
  const int HC = HG * CC, HCp = pad16(HC), Cop = pad16(Co);
  const int ldw = TN + 8, ldx = Wp + 8, ldT = TN * S + 8;
  const int plane = KC * (HG * ldw + ldx), stage_len = P * plane;
  const int G = cdiv(T_len, S), n_ct = cdiv(BS, TN), n_ob = cdiv(Cop, OCB);
  const int per_j = n_ob * n_ct * G;
  const int j = blockIdx.x / per_j, rem = blockIdx.x % per_j, b = blockIdx.z;
  const int ob = rem / (n_ct * G), t0 = (rem % G) * S, tc = (rem / G % n_ct) * TN;
  const int o_lo = ob * OCB, o_n = min(OCB, Cop - o_lo), OFB = o_n / 16;
  const int n_tgt = min(TN, BS - tc);
  const int n_cc = cdiv(C, CC), n_hg = cdiv(H, HG), n_mix = n_cc * n_hg;
  const size_t Np = (size_t)NJ * BS, M = (size_t)C * T_len, MO = (size_t)Co * T_len;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* scratch = reinterpret_cast<float*>(smem_raw);               // [warp][16][kLdS]
  bf16* stage = reinterpret_cast<bf16*>(scratch + kWarps * kStage);  // [2][stage_len]
  bf16* agg_h = stage + (size_t)kFStages * stage_len;                // [HCp][ldT]
  bf16* agg_l = agg_h + (size_t)HCp * ldT;
  float* out_s = reinterpret_cast<float*>(agg_l + (size_t)HCp * ldT);  // [frag][256]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sw = scratch + warp * kStage;
  // zero the stages (columns past n_tgt and W stay zero) and agg's padding rows
  for (int e = threadIdx.x; e < kFStages * stage_len / 8; e += kThreads) zero16(stage + 8 * e);
  const int n_pad = (HCp - HC) * ldT / 8;
  for (int e = threadIdx.x; e < n_pad; e += kThreads) {
    zero16(agg_h + (size_t)HC * ldT + 8 * e);
    zero16(agg_l + (size_t)HC * ldT + 8 * e);
  }
  const int start = tile_start[j], count = tile_count[j];
  const int KS = (BS + KC - 1) / KC, n_steps = count * KS;
  // each thread's copies: w segment e (row e / per, 8 columns e % per) and x
  // segment e (row k, channel c, chunk n: e = (k * CC + c) * NT + n), e =
  // threadIdx.x + kThreads * i, walked without division
  const int per = max(n_tgt / 8, 1), segs = CC * NT;
  const int wk0 = threadIdx.x / per, wc0 = threadIdx.x % per;
  const int wdk = kThreads / per, wdc = kThreads % per;
  const int xk0 = threadIdx.x / segs, xc0 = threadIdx.x % segs / NT, xn0 = threadIdx.x % NT;
  const int xdk = kThreads / segs, xdc = kThreads % segs / NT, xdn = kThreads % segs % NT;
  // stage i of the heads h0 .. h0 + HG - 1 and channels c0 .. c0 + cn - 1:
  // slot i / KS, source rows (i % KS) * KC .. + KC (past BS written as zeros)
  // into buffer i % 2, committed as one group (empty past the last stage)
  auto stage_step = [&](int i, int h0, int c0, int cn) {
    if (i < n_steps) {
      const int u = i / KS, r0 = (i % KS) * KC, nk = min(KC, BS - r0), a = start + u;
      bf16* w_s = stage + (size_t)(i % kFStages) * stage_len;
      bf16* x_s = w_s + HG * KC * ldw;
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        if (h0 + hh >= H) break;
        bf16* w_d = w_s + hh * KC * ldw;
        const TIn* w_t = w + ((((size_t)b * A + a) * H + h0 + hh) * BS + r0) * BS + tc;
        if (vec_w) {
          for (int k = wk0, c8 = wc0; k < KC; k += wdk, c8 += wdc) {
            if (c8 >= per) {
              c8 -= per;
              ++k;
              if (k >= KC) break;
            }
            if (k < nk)
              seg8(w_d + k * ldw + 8 * c8, plane, w_t + (size_t)k * BS + 8 * c8, kTT, true);
            else
              zero8(w_d + k * ldw + 8 * c8, plane, F32);
          }
        } else {
          for (int e = threadIdx.x; e < KC * n_tgt; e += kThreads) {
            const int k = e / n_tgt, t = e % n_tgt;
            put(w_d + k * ldw + t, plane, k < nk ? w_t[(size_t)k * BS + t] : zero_of<TIn>());
          }
        }
      }
      const TIn* x_r = x + (b * Np + (size_t)active_src[a] * BS + r0) * M +
                       (size_t)c0 * T_len + t0;
      for (int k = xk0, c = xc0, n = xn0; k < KC; k += xdk, c += xdc, n += xdn) {
        if (n >= NT) {
          n -= NT;
          ++c;
        }
        if (c >= CC) {
          c -= CC;
          ++k;
          if (k >= KC) break;
        }
        const int ts = t0 + n * kTT;
        bf16* d = x_s + k * ldx + c * S + n * kTT;
        if (k < nk && c < cn && ts < T_len)
          seg8(d, plane, x_r + (size_t)k * M + (size_t)c * T_len + n * kTT, T_len - ts, vec);
        else
          zero8(d, plane, F32);
      }
    }
    commit_async();
  };
  int cols[CW];  // first x_s column of each column tile (clamped past the last)
#pragma unroll
  for (int c = 0; c < CW; ++c) cols[c] = min(warp * CW + c, CF - 1) * 16;
  // the mix's sub-chunks of output columns: Θ split into the stage region
  // [2][HCp][OC + 8], OC output columns at a time (a multiple of 16)
  const int OC = min(o_n, ((int)(kFStages * stage_len / (2 * HCp)) - 8) / 16 * 16);
  const int ldo = OC + 8, RFo = TN * S / 16, KD = HCp / 16;
  __syncthreads();  // zeroed before the first stage
  for (int mi = 0; mi < n_mix; ++mi) {
    const int c0 = mi / n_hg * CC, h0 = mi % n_hg * HG, cn = min(CC, C - c0);
    const bool first = mi == 0, last = mi == n_mix - 1;
    wm::FragC acc[HG][RF][CW];
#pragma unroll
    for (int hh = 0; hh < HG; ++hh)
#pragma unroll
      for (int r = 0; r < RF; ++r)
#pragma unroll
        for (int c = 0; c < CW; ++c) wmma::fill_fragment(acc[hh][r][c], 0.f);
    stage_step(0, h0, c0, cn);
    for (int i = 0; i < n_steps; ++i) {
      stage_step(i + 1, h0, c0, cn);
      wait_async_group<1>();
      __syncthreads();  // stage i in place
      const bf16* w_s = stage + (size_t)(i % kFStages) * stage_len;
      const bf16* x_s = w_s + HG * KC * ldw;
      for (int k = 0; k < KC; k += 16) {
        wm::FragB fb[CW], fbl[CW];
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          wm::load_b_row_shared(fb[c], x_s + k * ldx + cols[c], ldx);
          if constexpr (F32) wm::load_b_row_shared(fbl[c], x_s + plane + k * ldx + cols[c], ldx);
        }
#pragma unroll
        for (int hh = 0; hh < HG; ++hh) {
          if (h0 + hh >= H) break;
          wm::FragAt fa[RF], fal[RF];
#pragma unroll
          for (int r = 0; r < RF; ++r) {
            wm::load_a_col_shared(fa[r], w_s + (hh * KC + k) * ldw + r * 16, ldw);
            if constexpr (F32)
              wm::load_a_col_shared(fal[r], w_s + plane + (hh * KC + k) * ldw + r * 16, ldw);
          }
#pragma unroll
          for (int r = 0; r < RF; ++r)
#pragma unroll
            for (int c = 0; c < CW; ++c) mma3<F32>(acc[hh][r][c], fa[r], fal[r], fb[c], fbl[c]);
        }
      }
      __syncthreads();  // stage i consumed
    }
    wait_async_group<0>();  // the empty group past the last stage
    // each head's agg -> bf16 hi + lo, [hh*CC + c][t*S + step]; lane: target
    // row lane % 16, one channel's 8 steps (columns (lane / 16) * 8 ..)
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int cf = warp * CW + c;
        if (cf >= CF) continue;
#pragma unroll
        for (int r = 0; r < RF; ++r) {
          wm::store_c_shared(sw, acc[hh][r][c], kLdS, false);  // sw[t'][col']
          __syncwarp();
          const int tl = lane % 16, col = cf * 16 + (lane / 16) * kTT;
          if (col < W) {
            const size_t o = (size_t)(hh * CC + col / S) * ldT + (r * 16 + tl) * S + col % S;
            split8(sw + tl * kLdS + (lane / 16) * kTT, agg_h + o, agg_l + o);
          }
          __syncwarp();
        }
      }
    }
    // out (+)= agg . Θ over depth (hh, c), two output-column tiles of a row
    // tile a warp at a time
    bf16* th_h = stage;
    bf16* th_l = stage + (size_t)HCp * ldo;
    for (int o0 = 0; o0 < o_n; o0 += OC) {
      const int on = min(OC, o_n - o0), OF = on / 16;
      __syncthreads();  // agg in place; the stages or the last chunk's Θ consumed
      for (int e0 = threadIdx.x; e0 < HCp * on; e0 += 8 * kThreads) {
        float v[8];  // eight loads in flight at a time
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = e0 + i * kThreads, r = e / on, o = o_lo + o0 + e % on;
          const int hh = r / CC, c = r % CC;
          v[i] = e < HCp * on && r < HC && h0 + hh < H && c < cn && o < Co
                     ? thetas[((size_t)(h0 + hh) * C + c0 + c) * Co + o]
                     : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = e0 + i * kThreads, r = e / on, o = e % on;
          if (e < HCp * on) wm::split(v[i], th_h[r * ldo + o], th_l[r * ldo + o]);
        }
      }
      __syncthreads();
      for (int rf = warp; rf < RFo; rf += kWarps) {
        for (int of0 = 0; of0 < OF; of0 += 2) {
          const int ocol[2] = {of0 * 16, min(of0 + 1, OF - 1) * 16};
          wm::FragC o[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (first)
              wmma::fill_fragment(o[q], 0.f);
            else
              wmma::load_matrix_sync(o[q], out_s + ((size_t)rf * OFB + (o0 + ocol[q]) / 16) * 256,
                                     16, wmma::mem_row_major);
          }
          for (int kd = 0; kd < KD; ++kd) {
            wm::FragAt ah, al;
            wm::load_a_col_shared(ah, agg_h + (size_t)kd * 16 * ldT + rf * 16, ldT);
            wm::load_a_col_shared(al, agg_l + (size_t)kd * 16 * ldT + rf * 16, ldT);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              wm::FragB bh, bl;
              wm::load_b_row_shared(bh, th_h + kd * 16 * ldo + ocol[q], ldo);
              wm::load_b_row_shared(bl, th_l + kd * 16 * ldo + ocol[q], ldo);
              mma3<true>(o[q], ah, al, bh, bl);
            }
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (of0 + q >= OF) break;
            if (!last) {
              wmma::store_matrix_sync(out_s + ((size_t)rf * OFB + (o0 + ocol[q]) / 16) * 256,
                                      o[q], 16, wmma::mem_row_major);
              continue;
            }
            // epilogue: lane: output channel lane % 16, 8 steps of one target
            wm::store_c_shared(sw, o[q], kLdS, true);  // sw[o'][row']
            __syncwarp();
            const int oc = o_lo + o0 + ocol[q] + lane % 16, row = rf * 16 + (lane / 16) * kTT;
            const int t = row / S, ts = t0 + row % S;
            if (oc < Co && t < n_tgt && ts < T_len) {
              float v[kTT];
              *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(
                  sw + (lane % 16) * kLdS + (lane / 16) * kTT);
              *reinterpret_cast<float4*>(v + 4) = *reinterpret_cast<const float4*>(
                  sw + (lane % 16) * kLdS + (lane / 16) * kTT + 4);
#pragma unroll
              for (int tt = 0; tt < kTT; ++tt) v[tt] = fmaxf(v[tt], 0.f);
              store8(out + (b * Np + (size_t)j * BS + tc + t) * MO + (size_t)oc * T_len + ts, v,
                     T_len - ts, vec);
            }
            __syncwarp();
          }
        }
      }
    }
    __syncthreads();  // Θ and agg consumed before the next (chunk, group) stages
  }
}

template <int RF, int CW, int HG, typename TIn>
cudaError_t launch_f_spmm(dim3 grid, size_t smem, cudaStream_t st, const int* tile_start,
                          const int* tile_count, const int* active_src, const void* w,
                          const void* x, const float* thetas, void* out, int A, int H, int NJ,
                          int BS, int C, int T_len, int Co, int NT, int KC, int CC, int OCB,
                          int vec, int vec_w) {
  cudaError_t err = allow_smem(f_spmm_wmma_kernel<RF, CW, HG, TIn>, smem);
  if (err != cudaSuccess) return err;
  f_spmm_wmma_kernel<RF, CW, HG, TIn><<<grid, kThreads, smem, st>>>(
      tile_start, tile_count, active_src, static_cast<const TIn*>(w),
      static_cast<const TIn*>(x), thetas, static_cast<TIn*>(out), A, H, NJ, BS, C, T_len, Co,
      NT, KC, CC, OCB, vec, vec_w);
  return cudaGetLastError();
}

int launch(int f32, const int* tile_start, const int* tile_count, const int* active_src,
           const float* q, const float* k, const float* bias, const float* cheb, void* w,
           const void* x, const float* thetas, void* out, int B, int A, int H, int NJ, int BS,
           int dk, int C, int T_len, int Co, int TN, int NT, int KC, int HG, int CC, int OCB,
           int vec, int vec_w, float scale, cudaStream_t st) {
  cudaError_t err =
      f32 ? launch_weights<float>(tile_start, tile_count, active_src, q, k, bias, cheb, w, B,
                                  A, H, NJ, BS, dk, scale, st)
          : launch_weights<wm::bf16>(tile_start, tile_count, active_src, q, k, bias, cheb, w, B,
                                     A, H, NJ, BS, dk, scale, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = f32 ? 2 : 1, RF = TN / 16, CF = pad16(CC * NT * kTT) / 16;
  const int CW = CF <= 8 ? 1 : CF <= 16 ? 2 : 4;
  const dim3 grid(NJ * cdiv(pad16(Co), OCB) * cdiv(BS, TN) * cdiv(T_len, NT * kTT), 1, B);
  const size_t smem = f_wmma_smem_bytes(P, C, H, TN, NT, KC, HG, CC, OCB);
  if (f_wmma_stage_bytes(P, CC, TN, NT, KC, HG) < 4 * (size_t)pad16(HG * CC) * (16 + 8))
    return static_cast<int>(cudaErrorInvalidValue);
#define F_SPMM(T_, R, W_, G_)                                                              \
  if (RF == R && CW == W_ && HG == G_)                                                     \
    return static_cast<int>(launch_f_spmm<R, W_, G_, T_>(                                  \
        grid, smem, st, tile_start, tile_count, active_src, w, x, thetas, out, A, H, NJ, BS, \
        C, T_len, Co, NT, KC, CC, OCB, vec, vec_w));
  if (f32) {  // two heads a stage only where RF * CW * 2 <= 8 (the split's fragments)
    F_SPMM(float, 1, 1, 1) F_SPMM(float, 1, 2, 1) F_SPMM(float, 1, 4, 1)
    F_SPMM(float, 2, 1, 1) F_SPMM(float, 2, 2, 1) F_SPMM(float, 2, 4, 1)
    F_SPMM(float, 4, 1, 1) F_SPMM(float, 4, 2, 1) F_SPMM(float, 8, 1, 1)
    F_SPMM(float, 1, 1, 2) F_SPMM(float, 1, 2, 2) F_SPMM(float, 1, 4, 2)
    F_SPMM(float, 2, 1, 2) F_SPMM(float, 2, 2, 2) F_SPMM(float, 4, 1, 2)
  } else {
    F_SPMM(wm::bf16, 1, 1, 1) F_SPMM(wm::bf16, 1, 2, 1) F_SPMM(wm::bf16, 1, 4, 1)
    F_SPMM(wm::bf16, 2, 1, 1) F_SPMM(wm::bf16, 2, 2, 1) F_SPMM(wm::bf16, 2, 4, 1)
    F_SPMM(wm::bf16, 4, 1, 1) F_SPMM(wm::bf16, 4, 2, 1) F_SPMM(wm::bf16, 8, 1, 1)
    F_SPMM(wm::bf16, 1, 1, 2) F_SPMM(wm::bf16, 1, 2, 2) F_SPMM(wm::bf16, 1, 4, 2)
    F_SPMM(wm::bf16, 2, 1, 2) F_SPMM(wm::bf16, 2, 2, 2) F_SPMM(wm::bf16, 2, 4, 2)
    F_SPMM(wm::bf16, 4, 1, 2) F_SPMM(wm::bf16, 4, 2, 2) F_SPMM(wm::bf16, 8, 1, 2)
  }
#undef F_SPMM
  return static_cast<int>(cudaErrorInvalidValue);  // a tile the plan never gives
}

}  // namespace

extern "C" {

// The forward on `stream` (f32: float32 x, w, out; else bf16): the weights
// pass, then the tensor-core SpMM/mix pass at TN target columns (16, 32, 64
// or 128), NT chunks of 8 steps, KC (16 or 32) source rows and HG (1 or 2)
// heads a stage, CC channels a chunk and OCB output columns a
// block (a multiple of 16), tiles that bell_fused.f_plan gives; w (B, A, H,
// BS, BS) is scratch in x's dtype; vec: T % 8 == 0 and x, out 16-byte
// aligned (row segments, 16-byte output stores), vec_w: BS % 8 == 0 and w
// 16-byte aligned. Returns cudaGetLastError() after the launches (0 =
// success).
int bell_fused_forward(const int* tile_start, const int* tile_count, const int* active_src,
                       const float* q, const float* k, const float* bias, const float* cheb,
                       void* w, const void* x, const float* thetas, void* out, int B, int A,
                       int H, int NJ, int BS, int dk, int C, int T_len, int Co, int f32, int TN,
                       int NT, int KC, int HG, int CC, int OCB, int vec, int vec_w, float scale,
                       void* stream) {
  return launch(f32, tile_start, tile_count, active_src, q, k, bias, cheb, w, x, thetas, out, B,
                A, H, NJ, BS, dk, C, T_len, Co, TN, NT, KC, HG, CC, OCB, vec, vec_w, scale,
                static_cast<cudaStream_t>(stream));
}

// Shared memory a block of the SpMM/mix pass requests, in bytes (what = 0),
// the bytes of its stage region (what = 1), and of a weights-pass block at
// d_k = C (what = 2).
size_t bell_fused_wmma_smem_bytes(int f32, int C, int H, int TN, int NT, int KC, int HG, int CC,
                                  int OCB, int what) {
  const int P = f32 ? 2 : 1;
  return what == 0   ? f_wmma_smem_bytes(P, C, H, TN, NT, KC, HG, CC, OCB)
         : what == 1 ? f_wmma_stage_bytes(P, CC, TN, NT, KC, HG)
                     : weights_smem_bytes(C);
}

const char* bell_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
