// Fused GTU tail (forward and backward) for sm_90a: the three gated (1, k)
// time convolutions, k in {3, 5, 7}, and their concatenation along time.
//
// Replaces the Pallas kernels of dstagnn_drought_tpu/ops/pallas/gtu_fused.py:
// `_fwd_call` (`_make_fwd`) and `_bwd_call` (`_make_bwd`). Per (b, n) group,
// with x (BN, C, T) in the compute dtype (float32 or bfloat16), conv k's
// taps W_k (k, 2C, C) and bias b_k (2C) in float32 (the weights already
// rounded to the compute dtype by the wrapper):
//
//   y_k[t][o] = b_k[o] + sum_{kk<k} sum_c x[c][t+kk] * W_k[kk][o][c],  t < T-k+1
//   out[off_k + t][c] = tanh(y_k[t][c]) * sigmoid(y_k[t][C+c])
//
// with off_k the earlier convs' output lengths; out (BN, 3T-12, C) in the
// compute dtype, rounded once. Products accumulate in float32 and the gate
// runs in float32, as on the TPU.
//
// The backward recomputes y (the TPU kernel saves only x and the weights),
// then, with g the cotangent:
//   dP = g*sg*(1-th*th), dQ = g*th*sg*(1-sg)   (th, sg and every product
//        rounded to the compute dtype, where the TPU kernel forms them)
//   dx[c][t]      = sum_k sum_kk sum_o dY_k[t-kk][o] * W_k[kk][o][c]
//   dW_k[kk][o][c] = sum_{groups, t} dY_k[t][o] * x[c][t+kk],  db_k = sum dY_k
//
// Bound on an H100 at GAMBIA (BN = 8556, C = 32, T = 144, bf16): the forward
// does 73 GFLOP against 309 MB of x and output, so bytes bound it (0.09 ms);
// the backward does three times the operations (recompute, dx, dW) and is
// bound by them (0.22 ms at 989 TFLOP/s).
//
// The design, one for every C (16 | C) and T (16 | T, T >= 48) and both
// dtypes: every product on the tensor cores (nvcuda::wmma bf16 16x16x16
// fragments, float32 sums); in float32 x, the taps and dY are split into
// hi = bf16(v) and lo = bf16(v - hi) and every product is three (hi.hi +
// lo.hi + hi.lo), so float32 stays float32 in value (residual <= 2^-16 of
// a term). A block owns a group of G output channel pairs (G = 32 where
// 32 | C, else 16): p row c and q row C + c together, so the gate closes in
// the block. It contracts over C in chunks of CK channels (64, 32 or 16,
// the widest dividing C); CK, G, the float32 split and the residency are
// template parameters, so every tile loop and fragment index is fixed at
// compile time. Where the taps of every chunk fit (RES 1: one chunk holds C,
// C = 16, 32, 64; RES 2: several chunks, bf16 only) they are staged once a
// block and each item's x is copied whole by cp.async while the item before
// it computes; otherwise (RES 0) each item stages a chunk at a time, its
// taps again for every pass of tiles (at C = 128 in bf16 RES 2 takes 0.23x
// the forward's time and 0.36x the backward's of RES 0 on an H100,
// chip_smoke.py --rows). Time
// is tiled: a block's item is ((b, n) group, time tile of TT steps, T split
// evenly into tiles of at most 256, the longest whose block fits, two an
// SM where a tile of 64 or more allows it), and x is staged over the tile
// plus 8 steps (the taps' reach, k - 1 <= 6). No block's shared memory
// grows with C or T past the chunk and the tile (`make_plan`).
//   forward: one launch, blockIdx.y = (conv, channel group); per item, y's
//     p and q halves per 16x16 (t, c) tile of the warp (two tiles a pass
//     sharing one c tile, so one tap fragment serves both), gated through
//     the warp's float32 staging (bias added there) and stored 8 channels of
//     one time step a lane. No im2col window tensor is ever written.
//   backward: one launch per (conv, channel group), in order on the stream;
//     blockIdx.y = a chunk of CK input channels (cc) of dx and dW. Per item:
//     y recomputed for the group's pairs over the tile and 16 steps before
//     it (the halo dx needs: dY[t - kk]), gated with g into dY (bf16 tile
//     Yb, rows from 8 before the tile); dx (TT, CK) of the cc channels =
//     sum_kk dY[t - kk] . W_kk added to a float32 accumulator (the launches
//     own each (b, n) slice in turn, the last rounds); dW_kk of (the group's
//     rows, the cc channels) += dY^T . x[kk : kk + TT] in the warps'
//     registers across the block's items, a warp's tiles sharing one o tile
//     so one dY^T fragment a step serves them; db summed per thread from
//     Yb. Each block writes its partial row once and sum_rows
//     (dense_common.cuh) adds the partials in a fixed order: no atomics, two
//     launches give the same bits. cc > 0 blocks recompute y (the price of
//     dW in registers at any C); up to C = 64 there is one cc.
// Traps:
//   - load/store_matrix_sync need a 256-bit aligned pointer and an ld that
//     is a multiple of 8 (16-bit types) or 4 (float). The shifted loads at
//     row offset kk are aligned only because every row of Xs and Yb is a
//     multiple of 32 bytes: 16 | CK, and their padding is 16 elements. Ws
//     is read only at 16-row offsets, so its pad of 8 keeps alignment.
//   - T_out is never a multiple of 16, and tiles run past T_out and T. The
//     gate writes zero dY rows outside [0, T_out) and x is staged zero
//     outside [0, T); no load reads past a tile.

#include "dense_common.cuh"
#include "wmma_common.cuh"

namespace {

using namespace wm;

using dense::kThreads;
using dense::kWarps;
using dense::rnd;

constexpr int kTaps = 15;         // 3 + 5 + 7
constexpr int kMaxGrid = 264;     // blocks (two per SM of an H100)
constexpr int kZ = 8;             // Yb rows before a tile's first step (>= k - 1)
constexpr int kXTail = 8;         // x rows staged past a tile's last y row (>= k - 1)
constexpr int kPad = 16;          // row padding of Xs and Yb (elements)
constexpr int kPadW = 8;          // row padding of Ws: read only at 16-row offsets
constexpr int kMaxTile = 256;     // time steps of a tile at most
constexpr int kHalo = 16;         // y rows recomputed before a backward tile
constexpr size_t kSmemMax = 232448;   // a block's shared memory (227 KB)
constexpr size_t kSmemTwo = 115712;   // the most two blocks an SM may each have

__host__ __device__ constexpr int conv_k(int ki) { return 3 + 2 * ki; }
__host__ __device__ constexpr int tap_base(int ki) { return ki == 0 ? 0 : (ki == 1 ? 3 : 8); }

// the tiling of a shape and dtype
struct Plan {
  int BN, C, T, M3, L;  // groups, channels, steps, output rows (3T - 12), a partial row
  int G, CK, nck, res;  // channel group; contraction chunk, count, all chunks resident
  int TT, ntt, halo;    // time tile and count; y rows recomputed before a backward tile
  int f32;
};

// byte offsets of a block's tiles in shared memory, each 128-aligned
struct Layout {
  size_t ws, xs, xr, yb, gs, st, bs, total;
};

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Ws (7, 2G, CK + 8) bf16 taps a chunk, Xs (rows, CK + 16) x time-major a
// chunk (every chunk of C where resident, else one), hi then (float32) lo;
// Xr x as copied (the channels staged, rows); backward: Yb (TT + 8, 2G + 16)
// dY, hi then lo, and Gs the group's g rows (TT + halo, G); the warps'
// float32 staging (2 KB each) and the bias (2G)
__host__ __device__ inline Layout layout(const Plan& p, bool backward) {
  const size_t h = 1 + p.f32, e = p.f32 ? 4 : 2, rows = p.TT + (backward ? p.halo : 0) + kXTail,
               slots = p.res ? p.nck : 1;
  Layout l;
  size_t o = 0;
  l.ws = o;
  o += align128(slots * 7 * 2 * (size_t)p.G * (p.CK + kPadW) * 2 * h);
  l.xs = o;
  o += align128(slots * rows * (p.CK + kPad) * 2 * h);
  l.xr = o;
  o += align128(slots * p.CK * rows * e);
  l.yb = o;
  if (backward) o += align128((size_t)(p.TT + kZ) * (2 * p.G + kPad) * 2 * h);
  l.gs = o;
  if (backward) o += align128((size_t)(p.TT + p.halo) * p.G * e);
  l.st = o;
  o += (size_t)kWarps * 512 * 4;
  l.bs = o;
  o += align128(2 * (size_t)p.G * 4);
  l.total = o;
  return l;
}

Plan make_plan(int BN, int C, int T, int f32) {
  Plan p;
  p.BN = BN;
  p.C = C;
  p.T = T;
  p.M3 = 3 * T - 12;
  p.L = kTaps * 2 * C * C + 3 * 2 * C;
  p.f32 = f32;
  // the contraction chunk: 64, 32 or 16 channels, the widest dividing C
  // (also the channels of dx and dW a backward block owns); the group of
  // output pairs: 32 where 32 | C, else 16
  p.CK = C % 64 == 0 ? 64 : C % 32 == 0 ? 32 : 16;
  p.G = p.CK < 32 ? p.CK : 32;
  p.nck = C / p.CK;
  // every chunk resident where the taps of C fit, else a chunk at a time;
  // then the longest tile (of at most 256 steps, T split evenly) whose
  // backward block fits two an SM, if one of 64 or more does and the
  // kernels run two (bf16, CK <= 32), else one an SM
  const bool two = !f32 && p.CK <= 32;
  // several resident chunks in bf16 only (float32's taps double)
  for (int res = f32 && p.nck > 1 ? 0 : 1; res >= 0; --res) {
    p.res = res;
    for (int pass = two ? 0 : 1; pass < 2; ++pass) {
      for (int tmax = kMaxTile; tmax >= 16; tmax /= 2) {
        if (pass == 0 && tmax < 64) break;
        const int parts = (T + tmax - 1) / tmax;
        p.TT = ((T + parts - 1) / parts + 15) / 16 * 16;
        p.ntt = (T + p.TT - 1) / p.TT;
        p.halo = p.ntt > 1 ? kHalo : 0;
        if (layout(p, true).total <= (pass == 0 ? kSmemTwo : kSmemMax)) return p;
      }
    }
  }
  return p;  // a chunk at a time, 16 steps: fits at any C
}

// items (group, time tile) and the backward's partial rows: blocks of a
// launch, shared by every launch (each writes its own columns of a row)
int grid_blocks(const Plan& p, int per_item_blocks) {
  const int items = p.BN * p.ntt, cap = (kMaxGrid + per_item_blocks - 1) / per_item_blocks;
  return items < cap ? items : cap;
}

__device__ __forceinline__ float sigmoid(float q) { return 1.f / (1.f + expf(-q)); }

// the first output position of conv ki in the concatenated time axis
__device__ __forceinline__ int out_offset(int ki, int T) {
  int off = 0;
  for (int j = 0; j < ki; ++j) off += T - conv_k(j) + 1;
  return off;
}

__device__ __forceinline__ void unpack8(const float* s, float* v) {
  const float4 a = reinterpret_cast<const float4*>(s)[0], b = reinterpret_cast<const float4*>(s)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* s, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(s);
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}

__device__ __forceinline__ void load8(const float* s, float* v) { unpack8(s, v); }

__device__ __forceinline__ void store8(bf16* d, const float* v) {
  *reinterpret_cast<uint4*>(d) = pack8(v);
}

__device__ __forceinline__ void store8(float* d, const float* v) {
  reinterpret_cast<float4*>(d)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(d)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// 8 values into a bf16 tile row: hi, and (lo set) the lo terms
__device__ __forceinline__ void store_split8(bf16* hi, bf16* lo, const float* v) {
  if (!lo) {
    store8(hi, v);
    return;
  }
  float h[8], l[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    h[j] = __bfloat162float(__float2bfloat16_rn(v[j]));
    l[j] = v[j] - h[j];
  }
  store8(hi, h);
  store8(lo, l);
}

// compile-time widths of a chunk of CK input channels: the group of G
// output pairs (p rows and q rows), the c tiles of a y tile's group (CT),
// the o tiles of its pairs (OT), the c tiles of a backward block's dx and dW
// channels (CW, the chunk's), row lengths of the tiles; F32: x, the taps
// and dY split into hi and lo (three bf16 products each)
template <int CK, typename TIn>
struct Cfg {
  static constexpr int G = CK < 32 ? CK : 32;
  static constexpr int CT = G / 16, OT = 2 * G / 16, CW = CK / 16;
  static constexpr int LW = CK + kPadW, LX = CK + kPad, LY = 2 * G + kPad;
  static constexpr bool F32 = sizeof(TIn) == 4;
};

// the block's tiles in shared memory: chunk slot j of the taps at ws + j*nw
// (lo at wsl + j*nw) and of x at xs + j*nx (lo at xsl + j*nx)
template <typename TIn>
struct Tiles {
  bf16 *ws, *wsl, *xs, *xsl, *yb, *ybl;
  TIn *xr, *gs;
  float *st, *bs;
  int rows, nw, nx;  // x rows staged; a slot's elements
};

template <int CK, typename TIn>
__device__ __forceinline__ Tiles<TIn> tiles(unsigned char* smem, const Plan& p, bool backward) {
  using F = Cfg<CK, TIn>;
  const Layout l = layout(p, backward);
  const int slots = p.res ? p.nck : 1;
  Tiles<TIn> s;
  s.rows = p.TT + (backward ? p.halo : 0) + kXTail;
  s.nw = 7 * 2 * F::G * F::LW;
  s.nx = s.rows * F::LX;
  s.ws = reinterpret_cast<bf16*>(smem + l.ws);
  s.wsl = s.ws + slots * s.nw;
  s.xs = reinterpret_cast<bf16*>(smem + l.xs);
  s.xsl = s.xs + slots * s.nx;
  s.yb = reinterpret_cast<bf16*>(smem + l.yb);
  s.ybl = s.yb + (p.TT + kZ) * F::LY;
  s.xr = reinterpret_cast<TIn*>(smem + l.xr);
  s.gs = reinterpret_cast<TIn*>(smem + l.gs);
  s.st = reinterpret_cast<float*>(smem + l.st);
  s.bs = reinterpret_cast<float*>(smem + l.bs);
  return s;
}

// conv ki's taps of channel group og over the input channels [c0, c0 + CK)
// to slot j: Ws[kk][o][c], o < G the p rows og*G + o, else the q rows
// C + og*G + o - G
template <int K, int CK, typename TIn>
__device__ __forceinline__ void stage_taps(const float* __restrict__ wp, const Tiles<TIn>& s,
                                           int ki, int og, int j, int c0, const Plan& p) {
  using F = Cfg<CK, TIn>;
  constexpr int G = F::G, G2 = 2 * G;
  bf16* ws = s.ws + j * s.nw;
  for (int e = threadIdx.x; e < K * G2 * CK; e += blockDim.x) {
    const int c = e % CK, row = e / CK, kk = row / G2, o = row % G2;
    const int orow = o < G ? og * G + o : p.C + og * G + o - G;
    const float v = wp[((size_t)(tap_base(ki) + kk) * 2 * p.C + orow) * p.C + c0 + c];
    const bf16 hi = __float2bfloat16_rn(v);
    ws[row * F::LW + c] = hi;
    if constexpr (F::F32)
      s.wsl[j * s.nw + row * F::LW + c] = __float2bfloat16_rn(v - __bfloat162float(hi));
  }
}

// x[c0 .. c0 + n) of one group over the steps [ty0, ty0 + rows) ∩ [0, T)
// to Xr (n, rows) by cp.async (16 bytes a copy), committed as one group
template <typename TIn>
__device__ __forceinline__ void copy_x(const Tiles<TIn>& s, const TIn* __restrict__ xg, int c0,
                                       int n, int ty0, const Plan& p) {
  constexpr int per = 16 / sizeof(TIn);
  const int a = max(ty0, 0), b = min(p.T, ty0 + s.rows), units = (b - a) / per;
  for (int e = threadIdx.x; e < n * units; e += blockDim.x) {
    const int c = e / units, u = e % units;
    const unsigned sa = static_cast<unsigned>(
        __cvta_generic_to_shared(s.xr + c * s.rows + (a - ty0) + u * per));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                 "l"(xg + (size_t)(c0 + c) * p.T + a + u * per));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Xr's channels [cx, cx + CK) as copied to slot j of Xs, time-major (hi,
// and lo in float32): a thread takes 8 steps of one channel; steps outside
// [0, T) are zero
template <int CK, typename TIn>
__device__ __forceinline__ void transpose_x(const Tiles<TIn>& s, int j, int cx, int ty0,
                                            const Plan& p) {
  using F = Cfg<CK, TIn>;
  bf16* xs = s.xs + j * s.nx;
  for (int e = threadIdx.x; e < CK * (s.rows / 8); e += blockDim.x) {
    const int c = e % CK, r0 = (e / CK) * 8, t = ty0 + r0;
    float v[8];
    if (t >= 0 && t < p.T) {
      load8(s.xr + (cx + c) * s.rows + r0, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bf16 hi = __float2bfloat16_rn(v[i]);
      xs[(r0 + i) * F::LX + c] = hi;
      if constexpr (F::F32)
        s.xsl[j * s.nx + (r0 + i) * F::LX + c] = __float2bfloat16_rn(v[i] - __bfloat162float(hi));
    }
  }
}

// one chunk [c0, c0 + CK) of x and of the taps, staged to slot 0 (the
// chunks streamed, not resident)
template <int K, int CK, typename TIn>
__device__ __forceinline__ void stage_chunk(const Tiles<TIn>& s, const TIn* __restrict__ xg,
                                            const float* __restrict__ wp, int ki, int og, int c0,
                                            int ty0, const Plan& p) {
  __syncthreads();  // the last chunk is consumed
  copy_x(s, xg, c0, CK, ty0, p);
  stage_taps<K, CK>(wp, s, ki, og, 0, c0, p);
  wait_async();
  __syncthreads();
  transpose_x<CK>(s, 0, 0, ty0, p);
  __syncthreads();
}

// y's gate halves p and q, bias left out, of the warp's two (t, c) tiles
// tile0 and tile0 + kWarps of the (rows/16, G/16) grid (they share a c
// tile, kWarps being a multiple of G/16, so one tap fragment serves both):
// += sum_kk Xs[16 tt + kk : +16] . W_kk^T over slot j's CK channels
template <int K, int CK, typename TIn>
__device__ __forceinline__ void y_mma(const Tiles<TIn>& s, int j, int tile0, int ntiles,
                                      FragC* pf, FragC* qf) {
  using F = Cfg<CK, TIn>;
  constexpr int G2 = 2 * F::G;
  const int ct = tile0 % F::CT;
  const bool on1 = tile0 + kWarps < ntiles;
  const bf16* xs = s.xs + j * s.nx;
  const bf16* ws = s.ws + j * s.nw;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
#pragma unroll
    for (int cs = 0; cs < CK / 16; ++cs) {
      FragA a[2], al[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i == 1 && !on1) continue;
        const int o = (16 * ((tile0 + i * kWarps) / F::CT) + kk) * F::LX + 16 * cs;
        wmma::load_matrix_sync(a[i], xs + o, F::LX);
        if constexpr (F::F32) wmma::load_matrix_sync(al[i], s.xsl + j * s.nx + o, F::LX);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        FragC* acc = half ? qf : pf;
        const int o = (kk * G2 + half * F::G + 16 * ct) * F::LW + 16 * cs;
        FragBt w, wl;
        wmma::load_matrix_sync(w, ws + o, F::LW);
        if constexpr (F::F32) wmma::load_matrix_sync(wl, s.wsl + j * s.nw + o, F::LW);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i == 1 && !on1) continue;
          wmma::mma_sync(acc[i], a[i], w, acc[i]);
          if constexpr (F::F32) {
            wmma::mma_sync(acc[i], al[i], w, acc[i]);
            wmma::mma_sync(acc[i], a[i], wl, acc[i]);
          }
        }
      }
    }
  }
}

// y over the rows [ty0, ty0 + 16 * rt) for channel group og: passes of two
// tiles a warp, over every chunk of C (RES: 0 staged here a chunk at a
// time, 1 one resident chunk holds C, 2 several resident chunks), then
// `gate(tt, ct, p, q)` per tile with the warp's fragments
template <int K, int CK, int RES, typename TIn, typename Gate>
__device__ __forceinline__ void y_tiles(const Tiles<TIn>& s, const TIn* __restrict__ xg,
                                        const float* __restrict__ wp, int ki, int og, int ty0,
                                        int rt, const Plan& p, Gate gate) {
  using F = Cfg<CK, TIn>;
  const int warp = threadIdx.x / 32, ntiles = rt * F::CT;
  const int passes = (ntiles + 2 * kWarps - 1) / (2 * kWarps);
  for (int pass = 0; pass < passes; ++pass) {
    const int tile0 = warp + pass * 2 * kWarps;
    FragC pf[2], qf[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      wmma::fill_fragment(pf[i], 0.f);
      wmma::fill_fragment(qf[i], 0.f);
    }
    if constexpr (RES == 1) {
      if (tile0 < ntiles) y_mma<K, CK>(s, 0, tile0, ntiles, pf, qf);
    } else {
      for (int j = 0; j < p.nck; ++j) {
        if constexpr (RES == 0) stage_chunk<K, CK>(s, xg, wp, ki, og, j * CK, ty0, p);
        if (tile0 < ntiles) y_mma<K, CK>(s, RES ? j : 0, tile0, ntiles, pf, qf);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tile = tile0 + i * kWarps;
      if (tile < ntiles) gate(tile / F::CT, tile % F::CT, pf[i], qf[i]);
    }
  }
}

// with RES: every chunk's taps to its slot (once a block), and an item's x
// (copied whole to Xr) to the slots
template <int K, int CK, int RES, typename TIn>
__device__ __forceinline__ void stage_all_taps(const float* __restrict__ wp, const Tiles<TIn>& s,
                                               int ki, int og, const Plan& p) {
  const int n = RES == 1 ? 1 : p.nck;
  for (int j = 0; j < n; ++j) stage_taps<K, CK>(wp, s, ki, og, j, j * CK, p);
}

template <int CK, int RES, typename TIn>
__device__ __forceinline__ void transpose_all(const Tiles<TIn>& s, int ty0, const Plan& p) {
  if constexpr (RES == 1) {
    transpose_x<CK>(s, 0, 0, ty0, p);
  } else {
    for (int j = 0; j < p.nck; ++j) transpose_x<CK>(s, j, j * CK, ty0, p);
  }
}

// ---------------------------------------------------------------------------
// forward: blockIdx.y = (conv, channel group), the longest conv first
// ---------------------------------------------------------------------------

template <int K, int CK, int RES, typename TIn>
__device__ __forceinline__ void fwd_conv(const TIn* __restrict__ x, const float* __restrict__ wp,
                                         const float* __restrict__ bias, TIn* __restrict__ out,
                                         int ki, int og, unsigned char* smem, const Plan& p) {
  using F = Cfg<CK, TIn>;
  constexpr int G = F::G;
  const Tiles<TIn> s = tiles<CK, TIn>(smem, p, false);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, Tout = p.T - K + 1,
            off = out_offset(ki, p.T), items = p.BN * p.ntt;
  // a lane's 8 elements of a 16x16 tile: row lane / 2, columns 8 * (lane % 2) ..
  const int lr = lane / 2, lc = 8 * (lane % 2);
  float* st = s.st + warp * 512;
  for (int o = threadIdx.x; o < 2 * G; o += blockDim.x)
    s.bs[o] = bias[ki * 2 * p.C + (o < G ? og * G + o : p.C + og * G + o - G)];
  if (RES) stage_all_taps<K, CK, RES>(wp, s, ki, og, p);
  // each later item's x is copied while the item before it computes
  if (RES && (int)blockIdx.x < items) {
    const int g = blockIdx.x / p.ntt, t0 = (blockIdx.x % p.ntt) * p.TT;
    copy_x(s, x + (size_t)g * p.C * p.T, 0, p.C, t0, p);
  }
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int g = item / p.ntt, t0 = (item % p.ntt) * p.TT;
    const TIn* xg = x + (size_t)g * p.C * p.T;
    if (RES) {
      wait_async();
      __syncthreads();  // x copied / the last item's tiles consumed
      transpose_all<CK, RES>(s, t0, p);
      __syncthreads();
      const int nx = item + gridDim.x;
      if (nx < items)
        copy_x(s, x + (size_t)(nx / p.ntt) * p.C * p.T, 0, p.C, (nx % p.ntt) * p.TT, p);
    }
    TIn* og_out = out + ((size_t)g * p.M3 + off) * p.C + og * G;
    y_tiles<K, CK, RES>(s, xg, wp, ki, og, t0, p.TT / 16, p,
                        [&](int tt, int ct, FragC& pf, FragC& qf) {
      wmma::store_matrix_sync(st, pf, 16, wmma::mem_row_major);
      wmma::store_matrix_sync(st + 256, qf, 16, wmma::mem_row_major);
      __syncwarp();
      const int t = t0 + 16 * tt + lr, c0 = 16 * ct + lc;
      if (t < Tout) {
        float pv[8], qv[8], v[8];
        unpack8(st + lr * 16 + lc, pv);
        unpack8(st + 256 + lr * 16 + lc, qv);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = tanhf(pv[i] + s.bs[c0 + i]) * sigmoid(qv[i] + s.bs[G + c0 + i]);
        store8(og_out + (size_t)t * p.C + c0, v);
      }
      __syncwarp();  // the staging is read before it is overwritten
    });
  }
}

// three blocks an SM in bf16 at C <= 32 (their shared memory allows it, at
// 80 registers), one otherwise
template <int CK, int RES, typename TIn>
__global__ void __launch_bounds__(kThreads, sizeof(TIn) == 2 && CK <= 32 ? 3 : 1)
gtu_fwd_kernel(const TIn* __restrict__ x, const float* __restrict__ wp,
               const float* __restrict__ bias, TIn* __restrict__ out, Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nog = p.C / Cfg<CK, TIn>::G, ky = blockIdx.y / nog, og = blockIdx.y % nog;
  if (ky == 0) fwd_conv<7, CK, RES>(x, wp, bias, out, 2, og, smem, p);
  else if (ky == 1) fwd_conv<5, CK, RES>(x, wp, bias, out, 1, og, smem, p);
  else fwd_conv<3, CK, RES>(x, wp, bias, out, 0, og, smem, p);
}

// ---------------------------------------------------------------------------
// backward: one launch per (conv, channel group), blockIdx.y = cc, a chunk
// of CK input channels of dx and dW
// ---------------------------------------------------------------------------

// a block's dW tiles: taps x o tiles x c tiles of its chunk; warp w owns o
// tile w % OT and every kWarps/OT-th of the (kk, c tile) pairs, so one dY^T
// fragment a step serves all its tiles. Two blocks an SM in bf16 at 8
// fragments a warp or fewer (64 registers), else one.
template <int K, int CK, typename TIn>
struct Bwd {
  using F = Cfg<CK, TIn>;
  static_assert(kWarps % F::OT == 0, "warps share the o tiles evenly");
  static constexpr int kSub = kWarps / F::OT;  // warps a o tile
  static constexpr int kPairs = K * F::CW;     // (kk, c tile) pairs of a o tile
  static constexpr int NF = (kPairs + kSub - 1) / kSub;
  static constexpr int kMinBlocks = NF <= 8 && !F::F32 ? 2 : 1;
};

// mode: 0 = first launch (dx starts at 0), 1 = middle, 2 = last (round dx)
template <int K, int CK, int RES, typename TIn>
__global__ void __launch_bounds__(kThreads, Bwd<K, CK, TIn>::kMinBlocks)
gtu_bwd_kernel(const TIn* __restrict__ x, const TIn* __restrict__ gout,
               const float* __restrict__ wp, const float* __restrict__ bias,
               float* __restrict__ dx_acc, TIn* __restrict__ dx, float* __restrict__ part,
               int ki, int og, int mode, Plan p) {
  using S = Bwd<K, CK, TIn>;
  using F = Cfg<CK, TIn>;
  constexpr int G = F::G, LX = F::LX, LY = F::LY, LW = F::LW;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<TIn> s = tiles<CK, TIn>(smem, p, true);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, C = p.C, Tt = p.T,
            Tout = Tt - K + 1, off = out_offset(ki, Tt), items = p.BN * p.ntt,
            cc = blockIdx.y, c1 = cc * CK, slot = RES ? cc : 0;
  const int lr = lane / 2, lc = 8 * (lane % 2);
  float* st = s.st + warp * 512;
  for (int o = threadIdx.x; o < 2 * G; o += blockDim.x)
    s.bs[o] = bias[ki * 2 * C + (o < G ? og * G + o : C + og * G + o - G)];
  for (int e = threadIdx.x; e < (p.TT + kZ) * LY; e += blockDim.x) {
    s.yb[e] = __float2bfloat16_rn(0.f);
    if constexpr (F::F32) s.ybl[e] = __float2bfloat16_rn(0.f);
  }
  if (RES) stage_all_taps<K, CK, RES>(wp, s, ki, og, p);
  FragC dw[S::NF];
#pragma unroll
  for (int f = 0; f < S::NF; ++f) wmma::fill_fragment(dw[f], 0.f);
  // db: thread (part, o) sums its chunk of a tile's rows of column o over
  // every item (cc = 0 blocks)
  constexpr int kDbParts = kThreads / (2 * G);
  const int db_o = threadIdx.x % (2 * G), db_part = threadIdx.x / (2 * G);
  const int db_chunk = (p.TT + kDbParts - 1) / kDbParts;
  const int db_t0 = db_part * db_chunk, db_t1 = min(p.TT, db_t0 + db_chunk);
  float db = 0.f;

  // the group's g rows [ty0, ty0 + TT + halo) ∩ [0, T_out) to Gs by cp.async
  auto copy_g = [&](int g, int ty0) {
    constexpr int per = 16 / sizeof(TIn);
    const int a = max(ty0, 0), b = min(Tout, ty0 + p.TT + p.halo);
    for (int e = threadIdx.x; e < (b - a) * (G / per); e += blockDim.x) {
      const int t = a + e / (G / per), u = e % (G / per);
      const unsigned sa = static_cast<unsigned>(
          __cvta_generic_to_shared(s.gs + (t - ty0) * G + u * per));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                   "l"(gout + ((size_t)g * p.M3 + off + t) * C + og * G + u * per));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if ((int)blockIdx.x < items) {
    const int g = blockIdx.x / p.ntt, ty0 = (blockIdx.x % p.ntt) * p.TT - p.halo;
    if (RES) copy_x(s, x + (size_t)g * C * Tt, 0, C, ty0, p);
    copy_g(g, ty0);
  }
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int g = item / p.ntt, t0 = (item % p.ntt) * p.TT, ty0 = t0 - p.halo;
    const TIn* xg = x + (size_t)g * C * Tt;
    const int nx = item + gridDim.x;
    wait_async();
    __syncthreads();  // x and g copied / the last item's tiles consumed
    if (RES) {
      transpose_all<CK, RES>(s, ty0, p);
      __syncthreads();
      if (nx < items)
        copy_x(s, x + (size_t)(nx / p.ntt) * C * Tt, 0, C, (nx % p.ntt) * p.TT - p.halo, p);
    }
    // 1-2. y over the tile and the halo before it, gated with g into dY
    // (rows kZ + t - t0 of Yb; zero outside [0, T_out))
    y_tiles<K, CK, RES>(s, xg, wp, ki, og, ty0, (p.TT + p.halo) / 16, p,
                        [&](int tt, int ct, FragC& pf, FragC& qf) {
      const int t = ty0 + 16 * tt + lr, c0 = 16 * ct + lc, row = kZ + t - t0;
      wmma::store_matrix_sync(st, pf, 16, wmma::mem_row_major);
      wmma::store_matrix_sync(st + 256, qf, 16, wmma::mem_row_major);
      __syncwarp();
      if (row >= 0) {
        float dp[8], dq[8];
        if (t >= 0 && t < Tout) {
          float pv[8], qv[8], gv[8];
          unpack8(st + lr * 16 + lc, pv);
          unpack8(st + 256 + lr * 16 + lc, qv);
          load8(s.gs + (t - ty0) * G + c0, gv);
          constexpr int bf = !F::F32;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float th = rnd(tanhf(pv[i] + s.bs[c0 + i]), bf);
            const float sg = rnd(sigmoid(qv[i] + s.bs[G + c0 + i]), bf);
            dp[i] = rnd(rnd(gv[i] * sg, bf) * rnd(1.f - rnd(th * th, bf), bf), bf);
            dq[i] = rnd(rnd(rnd(gv[i] * th, bf) * sg, bf) * rnd(1.f - sg, bf), bf);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) dp[i] = dq[i] = 0.f;
        }
        bf16* lo = nullptr;
        if constexpr (F::F32) lo = s.ybl + row * LY + c0;
        store_split8(s.yb + row * LY + c0, lo, dp);
        if constexpr (F::F32) lo = s.ybl + row * LY + G + c0;
        store_split8(s.yb + row * LY + G + c0, lo, dq);
      }
      __syncwarp();  // the staging is read before it is overwritten
    });
    __syncthreads();  // dY complete, g consumed
    if (nx < items) copy_g(nx / p.ntt, (nx % p.ntt) * p.TT - p.halo);
    if (cc == 0) {  // db over the tile's steps (zero rows past T_out)
      for (int t = db_t0; t < db_t1; ++t) {
        float v = __bfloat162float(s.yb[(kZ + t) * LY + db_o]);
        if constexpr (F::F32) v += __bfloat162float(s.ybl[(kZ + t) * LY + db_o]);
        db += v;
      }
    }
    if constexpr (!RES) stage_chunk<K, CK>(s, xg, wp, ki, og, c1, ty0, p);  // the cc channels
    const bf16* ws = s.ws + slot * s.nw;
    const bf16* xs = s.xs + slot * s.nx;
    // 3. dx (TT, CK) of the cc channels = sum_kk dY[t - kk] . W_kk per (t,
    // c) tile, two tiles a warp sharing a c tile, added to the earlier
    // launches' share through the warp's staging (the last launch rounds)
    const int ntiles = (p.TT / 16) * F::CW;
    for (int tile0 = warp; tile0 < ntiles; tile0 += 2 * kWarps) {
      const int ct = tile0 % F::CW, c = 16 * ct + lr;
      const bool on1 = tile0 + kWarps < ntiles;
      FragC acc[2];
      wmma::fill_fragment(acc[0], 0.f);
      wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
#pragma unroll
        for (int os = 0; os < F::OT; ++os) {
          const int ow = (kk * 2 * G + 16 * os) * LW + 16 * ct;
          FragB w, wl;
          wmma::load_matrix_sync(w, ws + ow, LW);
          if constexpr (F::F32) wmma::load_matrix_sync(wl, s.wsl + slot * s.nw + ow, LW);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (i == 1 && !on1) continue;
            const int oa = (16 * ((tile0 + i * kWarps) / F::CW) + kZ - kk) * LY + 16 * os;
            FragA a;
            wmma::load_matrix_sync(a, s.yb + oa, LY);
            wmma::mma_sync(acc[i], a, w, acc[i]);
            if constexpr (F::F32) {
              wmma::mma_sync(acc[i], a, wl, acc[i]);
              wmma::load_matrix_sync(a, s.ybl + oa, LY);
              wmma::mma_sync(acc[i], a, w, acc[i]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i == 1 && !on1) continue;
        wmma::store_matrix_sync(st, acc[i], 16, wmma::mem_col_major);  // st[c][t]
        __syncwarp();
        const int t = t0 + 16 * ((tile0 + i * kWarps) / F::CW) + lc;
        if (t < Tt) {
          float v[8];
          unpack8(st + lr * 16 + lc, v);
          const size_t at = (size_t)g * C * Tt + (size_t)(c1 + c) * Tt + t;
          if (mode) {
            float prev[8];
            unpack8(dx_acc + at, prev);
#pragma unroll
            for (int q = 0; q < 8; ++q) v[q] += prev[q];
          }
          if (mode == 2)
            store8(dx + at, v);
          else
            store8(dx_acc + at, v);
        }
        __syncwarp();
      }
    }
    // 4. dW_kk += dY^T . x[kk : kk + TT] over the tile's steps, the warp's
    // tiles in its registers, one dY^T fragment a step for all of them
    const int ot = warp % F::OT, sub = warp / F::OT;
    for (int sidx = 0; sidx < p.TT / 16; ++sidx) {
      const int oa = (kZ + 16 * sidx) * LY + 16 * ot;
      FragAt a, al;
      wmma::load_matrix_sync(a, s.yb + oa, LY);
      if constexpr (F::F32) wmma::load_matrix_sync(al, s.ybl + oa, LY);
#pragma unroll
      for (int f = 0; f < S::NF; ++f) {
        const int pair = sub + S::kSub * f;
        if (pair >= S::kPairs) continue;
        const int kk = pair / F::CW, ct = pair % F::CW;
        const int ox = (p.halo + 16 * sidx + kk) * LX + 16 * ct;
        FragB xb;
        wmma::load_matrix_sync(xb, xs + ox, LX);
        wmma::mma_sync(dw[f], a, xb, dw[f]);
        if constexpr (F::F32) {
          FragB xl;
          wmma::load_matrix_sync(xl, s.xsl + slot * s.nx + ox, LX);
          wmma::mma_sync(dw[f], a, xl, dw[f]);
          wmma::mma_sync(dw[f], al, xb, dw[f]);
        }
      }
    }
  }
  // this block's partial: row blockIdx.x of part, [dW (15, 2C, C) | db (3, 2C)],
  // the columns of (conv ki, group og, channels cc)
  float* prow = part + (size_t)blockIdx.x * p.L;
  {
    const int ot = warp % F::OT, sub = warp / F::OT;
    const int orow = 16 * ot < G ? og * G + 16 * ot : C + og * G + 16 * ot - G;
#pragma unroll
    for (int f = 0; f < S::NF; ++f) {
      const int pair = sub + S::kSub * f;
      if (pair >= S::kPairs) continue;
      const int kk = pair / F::CW, ct = pair % F::CW;
      wmma::store_matrix_sync(
          prow + ((size_t)(tap_base(ki) + kk) * 2 * C + orow) * C + c1 + 16 * ct, dw[f], C,
          wmma::mem_row_major);
    }
  }
  if (cc != 0) return;
  // db: the threads' sums through the staging, per column in a fixed order
  __syncthreads();  // every warp is done with its staging
  s.st[threadIdx.x] = db;
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * G; o += blockDim.x) {
    float sum = 0.f;
    for (int part_ = 0; part_ < kDbParts; ++part_) sum += s.st[part_ * 2 * G + o];
    prow[kTaps * 2 * C * C + ki * 2 * C + (o < G ? og * G + o : C + og * G + o - G)] = sum;
  }
}

// ---------------------------------------------------------------------------

// workspace of the backward (floats): the partials, sum_rows' scratch, dx_acc
struct BwdSpace {
  size_t part, scratch, dx_acc, total;
  int S;
};

BwdSpace bwd_space(const Plan& p) {
  BwdSpace s;
  s.S = grid_blocks(p, p.C / p.CK);
  s.part = 0;
  s.scratch = (size_t)s.S * p.L;
  s.dx_acc = s.scratch + dense::sum_rows_scratch(s.S, p.L);
  s.total = s.dx_acc + (size_t)p.BN * p.C * p.T;
  return s;
}

template <int CK, int RES, typename TIn>
int forward_impl(const void* x, const float* wp, const float* bp, void* out, const Plan& p,
                 cudaStream_t st) {
  const size_t smem = layout(p, false).total;
  cudaError_t err = dense::allow_smem(gtu_fwd_kernel<CK, RES, TIn>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nog = p.C / p.G;
  gtu_fwd_kernel<CK, RES, TIn><<<dim3(grid_blocks(p, 1), 3 * nog), kThreads, smem, st>>>(
      static_cast<const TIn*>(x), wp, bp, static_cast<TIn*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int CK, int RES, typename TIn>
cudaError_t launch_bwd(const void* x, const void* g, const float* wp, const float* bp, void* dx,
                       float* ws, const BwdSpace& s, int ki, int og, int mode, const Plan& p,
                       cudaStream_t st) {
  const size_t smem = layout(p, true).total;
  cudaError_t err = dense::allow_smem(gtu_bwd_kernel<K, CK, RES, TIn>, smem);
  if (err != cudaSuccess) return err;
  gtu_bwd_kernel<K, CK, RES, TIn><<<dim3(s.S, p.C / p.CK), kThreads, smem, st>>>(
      static_cast<const TIn*>(x), static_cast<const TIn*>(g), wp, bp, ws + s.dx_acc,
      static_cast<TIn*>(dx), ws + s.part, ki, og, mode, p);
  return cudaGetLastError();
}

// the (conv, channel group) launches in order, the first starting dx and
// the last rounding it, then the partials' fixed-order sum
template <int CK, int RES, typename TIn>
int backward_impl(const void* x, const void* g, const float* wp, const float* bp, void* dx,
                  float* dwb, float* ws, const Plan& p, cudaStream_t st) {
  const BwdSpace s = bwd_space(p);
  const int nog = p.C / p.G, last = 3 * nog - 1;
  cudaError_t err = cudaSuccess;
  for (int ki = 0; ki < 3 && err == cudaSuccess; ++ki) {
    for (int og = 0; og < nog && err == cudaSuccess; ++og) {
      const int li = ki * nog + og, mode = li == 0 ? 0 : li == last ? 2 : 1;
      if (ki == 0) err = launch_bwd<3, CK, RES, TIn>(x, g, wp, bp, dx, ws, s, ki, og, mode, p, st);
      else if (ki == 1)
        err = launch_bwd<5, CK, RES, TIn>(x, g, wp, bp, dx, ws, s, ki, og, mode, p, st);
      else err = launch_bwd<7, CK, RES, TIn>(x, g, wp, bp, dx, ws, s, ki, og, mode, p, st);
    }
  }
  if (err == cudaSuccess) err = dense::sum_rows(ws + s.part, dwb, ws + s.scratch, s.S, p.L, st);
  return static_cast<int>(err);
}

// the instantiation of the plan's chunk width and residency: 0 a chunk at a
// time, 1 one resident chunk (C = CK), 2 several resident chunks (bf16)
template <int CK, typename TIn>
int forward_ck(const void* x, const float* wp, const float* bp, void* out, const Plan& p,
               cudaStream_t st) {
  if (!p.res) return forward_impl<CK, 0, TIn>(x, wp, bp, out, p, st);
  if (p.nck == 1) return forward_impl<CK, 1, TIn>(x, wp, bp, out, p, st);
  if constexpr (sizeof(TIn) == 2) return forward_impl<CK, 2, TIn>(x, wp, bp, out, p, st);
  return static_cast<int>(cudaErrorInvalidValue);  // make_plan keeps float32 from it
}

template <typename TIn>
int forward_any(const void* x, const float* wp, const float* bp, void* out, const Plan& p,
                cudaStream_t st) {
  return p.CK == 64 ? forward_ck<64, TIn>(x, wp, bp, out, p, st)
         : p.CK == 32 ? forward_ck<32, TIn>(x, wp, bp, out, p, st)
                      : forward_ck<16, TIn>(x, wp, bp, out, p, st);
}

template <int CK, typename TIn>
int backward_ck(const void* x, const void* g, const float* wp, const float* bp, void* dx,
                float* dwb, float* ws, const Plan& p, cudaStream_t st) {
  if (!p.res) return backward_impl<CK, 0, TIn>(x, g, wp, bp, dx, dwb, ws, p, st);
  if (p.nck == 1) return backward_impl<CK, 1, TIn>(x, g, wp, bp, dx, dwb, ws, p, st);
  if constexpr (sizeof(TIn) == 2) return backward_impl<CK, 2, TIn>(x, g, wp, bp, dx, dwb, ws, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TIn>
int backward_any(const void* x, const void* g, const float* wp, const float* bp, void* dx,
                 float* dwb, float* ws, const Plan& p, cudaStream_t st) {
  return p.CK == 64 ? backward_ck<64, TIn>(x, g, wp, bp, dx, dwb, ws, p, st)
         : p.CK == 32 ? backward_ck<32, TIn>(x, g, wp, bp, dx, dwb, ws, p, st)
                      : backward_ck<16, TIn>(x, g, wp, bp, dx, dwb, ws, p, st);
}

}  // namespace

extern "C" {

// Floats of the backward's workspace for bfloat16 (is_bf16 = 1) or float32.
size_t gtu_fused_workspace_floats(int BN, int C, int T, int is_bf16) {
  return bwd_space(make_plan(BN, C, T, !is_bf16)).total;
}

// Forward: x (BN, C, T) and out (BN, 3T-12, C) in float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1), x 16-byte aligned; wp (15, 2C, C), bp (3, 2C)
// float32; 16 | C, 16 | T, T >= 48. Returns cudaGetLastError().
int gtu_fused_forward(const void* x, const float* wp, const float* bp, void* out, int BN,
                      int C, int T, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(BN, C, T, !is_bf16);
  return is_bf16 ? forward_any<bf16>(x, wp, bp, out, p, st)
                 : forward_any<float>(x, wp, bp, out, p, st);
}

// Backward: g (BN, 3T-12, C) → dx (BN, C, T) in the dtype of x, and dwb =
// [dW (15, 2C, C) | db (3, 2C)] float32, summed over every group in a fixed
// order. `ws` holds gtu_fused_workspace_floats floats; x and g 16-byte
// aligned.
int gtu_fused_backward(const void* x, const void* g, const float* wp, const float* bp,
                       void* dx, float* dwb, float* ws, int BN, int C, int T, int is_bf16,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(BN, C, T, !is_bf16);
  return is_bf16 ? backward_any<bf16>(x, g, wp, bp, dx, dwb, ws, p, st)
                 : backward_any<float>(x, g, wp, bp, dx, dwb, ws, p, st);
}

// Dynamic shared memory (bytes) of a block of each kernel: 0 the float32
// forward, 1 the float32 backward, 2 the bfloat16 backward, 3 the bfloat16
// forward.
size_t gtu_fused_smem_bytes(int C, int T, int kernel) {
  const int f32 = kernel < 2, backward = kernel == 1 || kernel == 2;
  return layout(make_plan(1, C, T, f32), backward).total;
}

// The tiling of (C, T) for bfloat16 (is_bf16 = 1) or float32: out[0..6] =
// channel group G, contraction chunk CK, every chunk resident (1) or not,
// time tile TT, time tiles, halo rows, and the backward's partial rows at
// BN groups.
void gtu_fused_plan(int BN, int C, int T, int is_bf16, int* out) {
  const Plan p = make_plan(BN, C, T, !is_bf16);
  out[0] = p.G;
  out[1] = p.CK;
  out[2] = p.res;
  out[3] = p.TT;
  out[4] = p.ntt;
  out[5] = p.halo;
  out[6] = bwd_space(p).S;
}

const char* gtu_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
