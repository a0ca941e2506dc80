// Fused temporal attention (forward and backward) for sm_90a.
//
// Replaces the Pallas kernels of dstagnn_drought_tpu/ops/pallas/tat_fused.py:
// `_tat_fwd_impl` (`_fwd_kernel`) and `_tat_vjp_bwd` (`_bwd_kernel`). Per row
// r of B*F, with x (BF, T, N), res and scores (BF, H, T, T), wqkv (N, W),
// W = 2*H*dk + H*dv, wo (H*dv, N), row-major, contiguous:
//
//   te   = embed ? LN(x + pos)*g0 + b0 : x
//   qkv  = te . wqkv
//   s_h  = q_h k_h^T / sqrt(dk) + res_h            -> scores (raw)
//   a_h  = softmax over the QUERY axis of s_h       (the reference's quirk)
//   ctx  = concat_h a_h . v_h
//   out  = LN(ctx . wo + te)*g1 + b1                (LN over N)
//
// The TPU kernel widens every operand to float32 and so does this one; the
// caller's dtype (bfloat16 or float32) is that of its inputs, and out and
// scores (dx and dres) are written in it, or in float32 on request.
//
// Bound on an H100: about 2*T*N*W + 4*H*T^2*dk + 2*T*H*dv*N flops a row
// (1.6 MFLOP at PEMS08, N=170, T=12, H=3, dk=dv=32) against ~0.03 MB a row
// of activations: operations, not bytes, bound it. The TPU kernel holds a
// row in VMEM; a row of a CUDA block would cap N and T by its 227 KB, so
// the row is taken apart into passes over the flat M = B*F*T rows, one
// design for both dtypes, and no block's shared memory grows with N, T or
// the head widths (the heads in chunks where they do not fit whole; a
// shape that fits the whole layout runs it unchanged).
// Every product runs on the tensor cores (WMMA 16x16x16 bf16 fragments,
// float32 sums) with each float32 operand a split into hi = bf16(a) and
// lo = bf16(a - hi) (residual <= 2^-18 |a|), so the function stays float32
// in value: in bfloat16 the inputs are bf16-exact and qkv = x . wqkv is one
// bf16 product, the others two (hi and lo of the float32 intermediate
// against the bf16 weight: ctx . wo, g_ypre . wo^T, g_qkv . wqkv^T,
// te^T . g_qkv) or three (ctx^T . g_ypre); in float32 x and the weights are
// split too (the prep kernel writes the weights' hi and lo copies), and
// every product is three (hi.hi + hi.lo + lo.hi). The passes, tiles of 64,
// 32 or 16 rows (the most whose shared memory lets two blocks share an SM,
// else the most that fit; fewer while M would give fewer tiles than the
// card has SMs):
//   1 tat_qkv_kernel: qkv = te . wqkv over 64-column chunks of te and wqkv
//     (wqkv's chunk, hi and in float32 lo, staged by cp.async while te's is
//     converted); embed adds the LN0 prologue (row statistics read from x,
//     not held) and writes te and its row statistics;
//   2 tat_attn_fwd_kernel, a block a (row of B*F, head), float32 on the
//     CUDA cores, key columns in chunks of 32 and the query rows in one
//     tile up to T = 160 where it fits, else in tiles of 32 (shared memory
//     bounded whatever T; a route by shape, make_d16; past what the whole
//     head fits, tat_attn_fwd_chunk_kernel stages d_k and d_v 64 columns at
//     a time, each score's chain run on through its chunks and ctx's sums
//     kept in device memory): the softmax runs over the query axis, so a key column
//     is complete only after every query. With one tile (a route by T,
//     ONE: the two sweeps below alone read 11% / 8% slower in the forward
//     / backward at PEMS08 blocks 2-4 on an H100, chip_smoke.py --rows)
//     each chunk's column softmax completes in the chunk and its share of
//     ctx is added at once (the column statistics still go to the
//     workspace for the backward); otherwise first each chunk's column
//     statistics (max, then the sum of exp, rescaled as the max moves)
//     over the query tiles, with the raw scores (an output), then ctx a
//     query tile at a time, the attention rebuilt from the statistics;
//   3 tat_out_kernel: z = ctx . wo + te (split where ctx's rows do not fit
//     whole: ctx split 256 columns at a time, each product continuing the
//     last one's sums stored in the z chunk, the bits of one product) and
//     LN1 over N in column chunks of
//     at most 1024 (the row's width split evenly, 16-aligned): the chunks'
//     statistics merged (Chan's formula; one chunk is the two-pass mean and
//     variance), then out a chunk at a time, the last chunk still in shared
//     memory and the others read back from a float32 scratch in the
//     workspace (the block's own rows, written as each chunk is formed).
//     Kept, not recomputed: at T = 144, N = 8600 (nine chunks) the pass
//     takes 20% (bf16) and 25% (float32) less time on an H100 than with the
//     recompute (chip_smoke.py --rows); up to N = 1024 the row is one
//     chunk and neither runs;
//   4 tat_ln1_bwd_kernel: z chunk by chunk and LN1's statistics, then LN1
//     backward with g_out: the row sums sum(g*g1) and sum(g*g1*x_hat) and
//     per-tile dg1/db1 partials a chunk at a time, then g_ypre (Mp, Np)
//     float32 and g_ctx = g_ypre . wo^T (split: z as pass 3 and g_ctx in
//     column groups of at most 512 whose tiles fit 9 a warp). With more
//     than one chunk the
//     block's rows of g_ypre's workspace hold z, then x_hat, between the
//     sweeps (its own rows, read back at once, mostly from L2); with one
//     they stay in shared memory;
//   5 tat_attn_bwd_kernel (tat_attn_bwd_chunk_kernel past the whole head:
//     q, k, v and g_ctx staged 64 columns at a time, g_k and g_v summed in
//     place in g_qkv), a block a (row, head) on the CUDA cores, a key
//     chunk at a time: a and g_a = g_ctx . v^T rebuilt for every query tile
//     from the forward's column statistics, the column term delta_k =
//     sum_q a g_a and g_v over all queries; then ds = a (g_a - delta) + g_sc
//     -> dres, g_k of the chunk and each tile's g_q, summed over the chunks
//     in place in g_qkv (Mp, Wp) float32 (the block owns those entries: no
//     atomics, a fixed order);
//   6 tat_gte_kernel: g_te = g_qkv . wqkv^T + g_ypre -> dx (split where
//     g_qkv's rows do not fit whole: chunk by chunk of N, g_qkv 256 columns
//     at a time as pass 3 takes ctx); with the
//     embedding, LN0 backward: g_te chunk by chunk into the float32 copy of
//     dx (dxf), the row sums and per-tile dg0/db0 partials, then dx;
//   7 dwqkv = te^T g_qkv and dwo = ctx^T g_ypre by wm::atb_wmma (split-M
//     partials, summed by dense::sum_rows in a fixed order: no atomics, the
//     same bits every launch), and the LN vectors' partials likewise.
// The forward is passes 1-3; the backward recomputes qkv and ctx (1-2), as
// the TPU kernel's custom_vjp saves only the inputs. Between passes qkv,
// ctx, the attention's column statistics, g_ypre, g_ctx and g_qkv live in
// device memory as float32 (rows padded to 64, widths to 16). Products whose
// K is long (1 and 4) stage their weight chunks in shared memory; products
// whose output is N wide (3 and 6) hold their split operand whole in shared
// memory and read each weight fragment once a block from L2.

#include <type_traits>

#include "dense_common.cuh"
#include "wmma_common.cuh"

namespace {

using dense::kThreads;
using dense::kWarps;

// ---------------------------------------------------------------------------
// The passes over the flat M = B*F*T rows on the tensor cores. TIn, the
// inputs' dtype: bf16 or float (f32 set in D16)
// ---------------------------------------------------------------------------

using namespace wm;

constexpr int kKC = 64;                // contraction columns a staged chunk
constexpr int kLC = kKC + 8;           // row stride of a chunk (bf16)
constexpr int kItems = 9;              // accumulator tiles a warp holds (chunked products)
constexpr int kAttnThreads = 128;      // threads of an attention block
constexpr int kKeyChunk = 32;          // key columns an attention block takes at a time
constexpr int kQueryTile = 32;         // query rows of a tile where T is streamed
constexpr int kOneTile = 160;          // T up to which one query tile holds every query
constexpr int kMaxChunk = 1024;        // most columns of N a row-tiled pass holds at a time
constexpr int kHeadChunk = 64;         // d_k or d_v columns the chunked attention stages a time
constexpr int kHvChunk = 256;          // ctx columns a split z product stages at a time
constexpr int kWChunk = 256;           // g_qkv columns a split g_te product stages at a time
constexpr int kGroupMax = 512;         // most g_ctx columns a split LN1 backward holds in its sums
constexpr size_t kSmemMax = 232448;    // shared memory a block may have (227 KB)

enum Pass16 { kQkv = 0, kAttnFwd, kOut, kLn1Bwd, kAttnBwd, kGte, kPasses };

// Blocks an SM the register budget is set for: the attention blocks are
// small and latency-bound, 16 of 128 threads (32 registers) where one tile
// holds T (ONE: T <= 160), 8 (64 registers) where they stream T's tiles and
// carry the tile loops' state; pass 3's 64-row tiles fit three an SM (80
// registers; at PEMS08 blocks 2-4 the 384 tiles then take one wave), pass
// 4 keeps two (128)
constexpr int kOutMinBlocks = 3, kLn1MinBlocks = 2;
constexpr int attn_min_blocks(bool one) { return one ? 16 : 8; }

// Attention routes: every query in one tile (T <= kOneTile), the queries in
// tiles of kQueryTile with the whole head staged, or those tiles with d_k
// and d_v staged kHeadChunk columns at a time; each pass takes the first
// that fits a block. The N-wide passes 3, 4 and 6 hold their K operand
// (ctx, g_qkv) whole, or (split) in chunks of kHvChunk / kWChunk columns
// where the whole one does not fit at 16 rows; split, pass 4 also takes
// g_ctx in column groups.
enum AttnRoute { kRouteOne = 0, kRouteStream, kRouteChunk };

struct D16 {
  int BF, M, T, N, H, dk, dv, W, hk, hv, Np, Wp, hvp, KC, QT, NC, nch, embed, f32;
  int route_fwd, route_bwd, split_out, split_ln1, split_gte;
  float inv_sqrt;
};

size_t smem16(int pass, int rows, const D16& d);
int rows16(int pass, const D16& d);
size_t attn_smem(int pass, int route, const D16& d);

D16 make_d16(int BF, int T, int N, int H, int dk, int dv, int embed, int f32) {
  D16 d;
  d.BF = BF;
  d.M = BF * T;
  d.T = T;
  d.N = N;
  d.H = H;
  d.dk = dk;
  d.dv = dv;
  d.hk = H * dk;
  d.hv = H * dv;
  d.W = 2 * d.hk + d.hv;
  d.Np = (N + 15) / 16 * 16;
  d.Wp = (d.W + 15) / 16 * 16;
  d.hvp = (d.hv + 15) / 16 * 16;
  d.KC = T < kKeyChunk ? T : kKeyChunk;
  d.QT = 0;  // set per attention pass (attn_d16)
  // the N-wide passes' column chunks: Np split evenly into the fewest of at
  // most kMaxChunk columns, each 16-aligned (only the last holds padding)
  const int parts = (d.Np + kMaxChunk - 1) / kMaxChunk;
  d.NC = ((d.Np + parts - 1) / parts + 15) / 16 * 16;
  d.nch = (d.Np + d.NC - 1) / d.NC;
  d.embed = embed;
  d.f32 = f32;
  d.inv_sqrt = static_cast<float>(1.0 / sqrt(static_cast<double>(dk)));
  // each attention pass's route: the first that fits a block
  for (const int pass : {(int)kAttnFwd, (int)kAttnBwd}) {
    int route = kRouteChunk;
    if (T <= kOneTile && attn_smem(pass, kRouteOne, d) <= kSmemMax)
      route = kRouteOne;
    else if (attn_smem(pass, kRouteStream, d) <= kSmemMax)
      route = kRouteStream;
    (pass == kAttnFwd ? d.route_fwd : d.route_bwd) = route;
  }
  // the N-wide passes split their K operand where it does not fit whole
  d.split_out = d.split_ln1 = d.split_gte = 0;
  d.split_out = rows16(kOut, d) == 0;
  d.split_ln1 = rows16(kLn1Bwd, d) == 0;
  d.split_gte = rows16(kGte, d) == 0;
  return d;
}

// a copy of d for an attention pass: its route's query tile
D16 attn_d16(int pass, const D16& d) {
  D16 a = d;
  const int route = pass == kAttnFwd ? d.route_fwd : d.route_bwd;
  a.QT = route == kRouteOne ? d.T : (d.T < kQueryTile ? d.T : kQueryTile);
  return a;
}

// output columns of a qkv group: kItems tiles a warp over the row tiles,
// half as many in float32 (two staged wqkv chunks, hi and lo)
__host__ __device__ __forceinline__ int qkv_group(const D16& d, int rows) {
  const int gw = 16 * (kWarps * kItems / (rows / 16)) / (1 + d.f32);
  return d.Wp < gw ? d.Wp : gw;
}

// the columns a split pass stages of its K operand: ctx's in passes 3-4,
// g_qkv's in pass 6 (the whole width where the pass is not split)
__host__ __device__ __forceinline__ int hv_chunk(const D16& d, int split) {
  return split && d.hvp > kHvChunk ? kHvChunk : d.hvp;
}
__host__ __device__ __forceinline__ int w_chunk(const D16& d) {
  return d.split_gte && d.Wp > kWChunk ? kWChunk : d.Wp;
}
// g_ctx columns pass 4 sums at a time: all of them, or (split) a group whose
// tiles fit kItems a warp and whose wo chunks fit beside the z chunk
__host__ __device__ __forceinline__ int ln1_group(const D16& d, int rows) {
  if (!d.split_ln1) return d.hvp;
  int g = 16 * (kWarps * kItems / (rows / 16));
  if (g > kGroupMax) g = kGroupMax;
  return d.hvp < g ? d.hvp : g;
}

// Shared memory of an attention pass on a route: the query tile (every
// query on the one-tile route), key and value chunks, score tiles, and the
// head's columns (kHeadChunk of d_k and d_v at a time on the chunked route,
// whose ctx, g_k and g_v sums stay in device memory)
size_t attn_smem(int pass, int route, const D16& d) {
  const size_t QT = route == kRouteOne ? d.T : (d.T < kQueryTile ? d.T : kQueryTile),
               KC = d.KC, ls = KC + 1;
  const bool chunk = route == kRouteChunk;
  const size_t ck = chunk && d.dk > kHeadChunk ? kHeadChunk : d.dk,
               cv = chunk && d.dv > kHeadChunk ? kHeadChunk : d.dv, lq = ck + 1, lv = cv + 1;
  if (pass == kAttnFwd)  // query tile, key and value chunks, score tile, context sums, the
                         // chunk's column statistics
    return 4 * (QT * lq + KC * lq + KC * lv + QT * ls + (chunk ? 0 : QT * d.dv) + 2 * KC);
  // query and g_ctx tiles, key and value chunks, a and g_a tiles, the chunk's g_k and g_v
  // sums, delta and column statistics
  return 4 * (QT * lq + QT * lv + KC * lq + KC * lv + 2 * QT * ls +
              (chunk ? 0 : KC * d.dk + KC * d.dv) + 3 * KC);
}

// Shared memory of a pass's block with `rows` rows (an attention pass: its
// route's bytes). Every region of a row-tiled pass is a multiple of 32
// bytes, so each WMMA tile starts aligned. None grows with N or T, nor
// (split or chunked) with the head widths.
size_t smem16(int pass, int rows, const D16& d) {
  const size_t R = rows, LZ = d.NC + 4;
  switch (pass) {
    case kQkv:  // B chunk (hi, and lo in float32), A chunk hi (and lo), LN0 statistics
      return 2 * (size_t)kKC * (qkv_group(d, rows) + 8) * (1 + d.f32) +
             2 * R * kLC * (1 + (d.embed | d.f32)) + 8 * R;
    case kAttnFwd:
      return attn_smem(pass, d.route_fwd, d);
    case kOut:  // a z chunk (float32), ctx hi and lo (a chunk where split), the rows' statistics
      return 4 * R * LZ + 4 * R * (hv_chunk(d, d.split_out) + 8) + 8 * R;
    case kLn1Bwd: {  // a z chunk, then ctx hi/lo or a g_ypre chunk (hi, lo) and a wo
                     // chunk of a g_ctx group (hi, and lo in float32); the rows'
                     // statistics and sums
      const size_t a = 4 * R * (hv_chunk(d, d.split_ln1) + 8),
                   c = 4 * R * kLC + 2 * (size_t)ln1_group(d, rows) * kLC * (1 + d.f32);
      return 4 * R * LZ + (a > c ? a : c) + 16 * R;
    }
    case kAttnBwd:
      return attn_smem(pass, d.route_bwd, d);
    case kGte:  // g_qkv hi and lo (a chunk where split), then per-warp staging or (embed
                // or split) a g_te chunk and the rows' sums
      return 4 * R * (w_chunk(d) + 8) +
             (d.embed || d.split_gte ? 4 * R * LZ + 8 * R : 4 * (size_t)kWarps * 256);
  }
  return 0;
}

// Rows a block of a row-tiled pass takes: 64, 32 or 16, the most whose
// shared memory lets two blocks share an SM, else the most that fit (the
// unsplit g_ctx product also needs its tiles to fit kItems a warp); 0 where
// none does, which a split pass never reaches. The attention passes return
// 1 (the chunked route fits at every head width).
constexpr size_t kSmemTwo = 115712;  // the most two blocks an SM may each have
int rows16(int pass, const D16& d) {
  if (pass == kAttnFwd || pass == kAttnBwd) return smem16(pass, 1, d) <= kSmemMax ? 1 : 0;
  for (const size_t cap : {kSmemTwo, kSmemMax})
    for (int rows = 64; rows >= 16; rows /= 2) {
      if (pass == kLn1Bwd && !d.split_ln1 && (rows / 16) * (d.hvp / 16) > kWarps * kItems)
        continue;
      if (smem16(pass, rows, d) <= cap) return rows;
    }
  return 0;
}

// Rows a block of a row-tiled pass is launched with: its most (rows16),
// halved down to 16 while the M rows would give fewer blocks than an
// H100's SMs, so a small B*F*T still spreads over the card. 16 rows fit
// wherever more do: every pass's bytes shrink with the rows but qkv's,
// whose wider column group stays below 2*kKC*(1152 + 8) + 4*16*kLC + 128
// (float32: 4*kKC*(576 + 8) + 4*16*kLC + 128).
constexpr int kSms = 132;
int launch_rows16(int pass, const D16& d) {
  int rows = rows16(pass, d);
  if (pass == kAttnFwd || pass == kAttnBwd) return rows;
  while (rows > 16 && (d.M + rows - 1) / rows < kSms) rows /= 2;
  return rows;
}

// the bytes a pass requests at its most rows, or at 16 rows where none fit
size_t smem16_request(int pass, const D16& d) {
  const int rows = rows16(pass, d);
  if (pass == kAttnFwd || pass == kAttnBwd) return smem16(pass, 1, d);
  return smem16(pass, rows ? rows : 16, d);
}

__device__ __forceinline__ void store_out(void* p, size_t i, float v, int f32) {
  if (f32)
    static_cast<float*>(p)[i] = v;
  else
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
}

// te[row][n]: the input itself, or (embed) the float32 LN0 output pass 1
// wrote; 0 outside the M rows
template <typename TIn>
__device__ __forceinline__ float te_at(const TIn* x, const float* te32, int row, int n,
                                       const D16& d) {
  if (row >= d.M) return 0.f;
  return d.embed ? te32[(size_t)row * d.Np + n] : to_float(x[(size_t)row * d.N + n]);
}

// Chunked product into acc: item i of warp w is tile (r, c) = divmod(w +
// kWarps*i, nct) of a (rows x 16*nct) output; a hi (lo) chunks are (rows,
// kLC) bf16, b (blo, its lo terms, or null) is a staged (kn x 16*nct)
// chunk, row-major with stride ldb, or (BT) its transpose (16*nct x kn,
// stride ldb): ahi.b + alo.b + ahi.blo.
template <bool BT>
__device__ __forceinline__ void chunk_mma(FragC (&acc)[kItems], int items, int nct,
                                          const bf16* ahi, const bf16* alo, const bf16* b,
                                          const bf16* blo, int ldb, int kn) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int item = warp + kWarps * i;
    if (item >= items) break;
    const int r = item / nct, c = item % nct;
    for (int k0 = 0; k0 < kn; k0 += 16) {
      FragA fa;
      if constexpr (BT) {
        FragBt fb;
        wmma::load_matrix_sync(fb, b + c * 16 * ldb + k0, ldb);
        wmma::load_matrix_sync(fa, ahi + r * 16 * kLC + k0, kLC);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
        if (blo) {
          wmma::load_matrix_sync(fb, blo + c * 16 * ldb + k0, ldb);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
          wmma::load_matrix_sync(fb, b + c * 16 * ldb + k0, ldb);
        }
        if (alo) {
          wmma::load_matrix_sync(fa, alo + r * 16 * kLC + k0, kLC);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      } else {
        FragB fb;
        wmma::load_matrix_sync(fb, b + k0 * ldb + c * 16, ldb);
        wmma::load_matrix_sync(fa, ahi + r * 16 * kLC + k0, kLC);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
        if (blo) {
          wmma::load_matrix_sync(fb, blo + k0 * ldb + c * 16, ldb);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
          wmma::load_matrix_sync(fb, b + k0 * ldb + c * 16, ldb);
        }
        if (alo) {
          wmma::load_matrix_sync(fa, alo + r * 16 * kLC + k0, kLC);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
    }
  }
}

// Wide product for one warp: the column tiles ct0 and ct0 + 1 (< nct) of
// every row tile, acc[r][q] = init + (ahi + alo)[rows r] . (w + wlo) over K
// (a multiple of 16) less the lo.lo term, with a hi/lo (rows, lda) bf16 in
// shared memory and the fragments of w (and wlo, its lo terms, or null)
// read from device memory (L2): row-major (K x cols, stride ldw) or (BT)
// its transpose (cols x K, stride ldw). Each fragment is read once a block.
// init (float32, row stride ldi, the tiles' own places) is null for 0: a
// product split over K chunks, each continuing the last one's sums stored
// there, has the bits of one product over all of K.
template <int RT, bool BT>
__device__ __forceinline__ void wide_mma(FragC (&acc)[RT][2], const bf16* ahi, const bf16* alo,
                                         int lda, int K, const bf16* __restrict__ w,
                                         const bf16* __restrict__ wlo, int ldw, int ct0,
                                         int nct, const float* init = nullptr, int ldi = 0) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (init && ct0 + q < nct)
        wmma::load_matrix_sync(acc[r][q], init + r * 16 * ldi + (ct0 + q) * 16, ldi,
                               wmma::mem_row_major);
      else
        wmma::fill_fragment(acc[r][q], 0.f);
    }
  for (int k0 = 0; k0 < K; k0 += 16) {
    using FB = typename std::conditional<BT, FragBt, FragB>::type;
    FB fb[2], fbl[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (ct0 + q >= nct) continue;
      const size_t o = BT ? (size_t)(ct0 + q) * 16 * ldw + k0 : (size_t)k0 * ldw + (ct0 + q) * 16;
      wmma::load_matrix_sync(fb[q], w + o, ldw);
      if (wlo) wmma::load_matrix_sync(fbl[q], wlo + o, ldw);
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      FragA fh, fl;
      wmma::load_matrix_sync(fh, ahi + r * 16 * lda + k0, lda);
      wmma::load_matrix_sync(fl, alo + r * 16 * lda + k0, lda);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (ct0 + q >= nct) continue;
        wmma::mma_sync(acc[r][q], fh, fb[q], acc[r][q]);
        wmma::mma_sync(acc[r][q], fl, fb[q], acc[r][q]);
        if (wlo) wmma::mma_sync(acc[r][q], fh, fbl[q], acc[r][q]);
      }
    }
  }
}

// rows x K of a float32 matrix (row stride ld, `cols` valid columns, M
// valid rows from row0) split into hi and lo (rows, lda) bf16 tiles
__device__ __forceinline__ void split_rows(const float* __restrict__ src, size_t ld, int row0,
                                           int M, int rows, int K, int cols, bf16* hi, bf16* lo,
                                           int lda) {
  for (int e = threadIdx.x; e < rows * K; e += kThreads) {
    const int r = e / K, c = e % K;
    const float v = row0 + r < M && c < cols ? src[(size_t)(row0 + r) * ld + c] : 0.f;
    split(v, hi[r * lda + c], lo[r * lda + c]);
  }
}

// Pass 1: qkv (Mp, Wp) = te . wqkv, float32. te is x (bf16: one bf16
// product; float32: split, against wqkv's hi and lo, three), or (embed)
// LN0(x + pos)*g0 + b0 in float32, split, which this pass also writes to
// te32 with its row statistics. wqkv_lo is null in bf16.
template <int RT, typename TIn>
__global__ void __launch_bounds__(kThreads)
tat_qkv_kernel(const TIn* __restrict__ x, const float* __restrict__ pos,
               const float* __restrict__ g0, const float* __restrict__ b0,
               const bf16* __restrict__ wqkv, const bf16* __restrict__ wqkv_lo,
               float* __restrict__ qkv, float* __restrict__ te32, float* __restrict__ stats0,
               D16 d) {
  constexpr int R = RT * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int GW = qkv_group(d, R), LB = GW + 8, split_a = d.embed | d.f32;
  bf16* sb = reinterpret_cast<bf16*>(smem);     // (kKC, LB)
  bf16* sbl = wqkv_lo ? sb + kKC * LB : nullptr;  // (kKC, LB) lo terms
  bf16* ahi = sb + kKC * LB * (1 + d.f32);      // (R, kLC)
  bf16* alo = split_a ? ahi + R * kLC : nullptr;
  float* st = reinterpret_cast<float*>(ahi + R * kLC * (1 + split_a));  // (R, 2)
  const int row0 = blockIdx.x * R, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (d.embed) {
    for (int r = warp; r < R; r += kWarps) {
      const int row = row0 + r;
      float mu = 0.f, inv = 0.f;
      if (row < d.M) {
        const TIn* xr = x + (size_t)row * d.N;
        const float* pr = pos + (size_t)(row % d.T) * d.N;
        float s1 = 0.f;
        for (int n = lane; n < d.N; n += 32) s1 += to_float(xr[n]) + pr[n];
        mu = dense::warp_sum(s1) / d.N;
        float v = 0.f;
        for (int n = lane; n < d.N; n += 32) {
          const float z = to_float(xr[n]) + pr[n] - mu;
          v = fmaf(z, z, v);
        }
        inv = rsqrtf(dense::warp_sum(v) / d.N + dense::kEps);
        if (lane == 0) {
          stats0[2 * row] = mu;
          stats0[2 * row + 1] = inv;
        }
      }
      if (lane == 0) {
        st[2 * r] = mu;
        st[2 * r + 1] = inv;
      }
    }
  }
  for (int g0c = 0; g0c < d.Wp; g0c += GW) {
    const int gw = min(GW, d.Wp - g0c), nct = gw / 16;
    FragC acc[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) wmma::fill_fragment(acc[i], 0.f);
    for (int k0 = 0; k0 < d.Np; k0 += kKC) {
      const int kn = min(kKC, d.Np - k0);
      __syncthreads();  // the last chunk is consumed (and the statistics are in)
      copy_rows_async(sb, LB, wqkv + (size_t)k0 * d.Wp + g0c, d.Wp, kn, gw);
      if (sbl) copy_rows_async(sbl, LB, wqkv_lo + (size_t)k0 * d.Wp + g0c, d.Wp, kn, gw);
      for (int e = threadIdx.x; e < R * kn; e += kThreads) {
        const int r = e / kn, c = e % kn, n = k0 + c, row = row0 + r;
        const bool in = row < d.M && n < d.N;
        float te = in ? to_float(x[(size_t)row * d.N + n]) : 0.f;
        if (!split_a) {  // bf16 x, used as it is
          ahi[r * kLC + c] = __float2bfloat16_rn(te);
          continue;
        }
        if (in && d.embed) {
          const float h = (te + pos[(size_t)(row % d.T) * d.N + n] - st[2 * r]) * st[2 * r + 1];
          te = h * g0[n] + b0[n];
          if (g0c == 0) te32[(size_t)row * d.Np + n] = te;
        }
        split(te, ahi[r * kLC + c], alo[r * kLC + c]);
      }
      wait_async();
      __syncthreads();
      chunk_mma<false>(acc, RT * nct, nct, ahi, alo, sb, sbl, LB, kn);
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int item = warp + kWarps * i;
      if (item >= RT * nct) break;
      const int r = item / nct, c = item % nct;
      wmma::store_matrix_sync(qkv + (size_t)(row0 + r * 16) * d.Wp + g0c + c * 16, acc[i],
                              d.Wp, wmma::mem_row_major);
    }
  }
}

// attention blocks: one (row r of B*F, head h), query rows in tiles of QT,
// key columns in chunks of KC
struct AttnTiles {
  float *q, *kc, *vc, *s;
  int lq, lv, ls;
};

__device__ __forceinline__ void load_head(float* dst, int ld, const float* __restrict__ src,
                                          size_t lds, int n, int w) {
  for (int e = threadIdx.x; e < n * w; e += kAttnThreads)
    dst[(e / w) * ld + e % w] = src[(size_t)(e / w) * lds + e % w];
}

// s = q . k / sqrt(dk) + res for row q of the staged query tile [q0, ...)
// and key kk of the staged chunk [k0, ...): every pass forms a score by
// this same sequence, so a recomputed score has the bits of the first
template <typename TIn>
__device__ __forceinline__ float score(const AttnTiles& a, const TIn* __restrict__ res_rh, int q0,
                                       int q, int k0, int kk, const D16& d) {
  const float* qr = a.q + q * a.lq;
  const float* kr = a.kc + kk * a.lq;
  float dot = 0.f;
  for (int c = 0; c < d.dk; ++c) dot = fmaf(qr[c], kr[c], dot);
  return dot * d.inv_sqrt + to_float(res_rh[(size_t)(q0 + q) * d.T + k0 + kk]);
}

// the raw scores of the staged (qn, kn) tile to a.s, also to `scores`
// (at sc_off) when given
template <typename TIn>
__device__ __forceinline__ void score_tile(const AttnTiles& a, const TIn* __restrict__ res_rh,
                                           void* scores, int out_f32, size_t sc_off, int q0,
                                           int qn, int k0, int kn, const D16& d) {
  for (int e = threadIdx.x; e < qn * kn; e += kAttnThreads) {
    const int q = e / kn, kk = e % kn;
    const float s = score(a, res_rh, q0, q, k0, kk, d);
    a.s[q * a.ls + kk] = s;
    if (scores) store_out(scores, sc_off + (size_t)(q0 + q) * d.T + k0 + kk, s, out_f32);
  }
}

// a = exp(s - m_k) / l_k of the staged (qn, kn) tile to a.s, the scores
// formed afresh, with the key columns' statistics cm (max over every query)
// and cl (sum of exp); with gc (the tile's g_ctx rows), g_a = g_ctx . v^T
// to ga
template <typename TIn>
__device__ __forceinline__ void attn_tile(const AttnTiles& a, const TIn* __restrict__ res_rh,
                                          const float* cm, const float* cl, const float* gc,
                                          float* ga, int q0, int qn, int k0, int kn,
                                          const D16& d) {
  for (int e = threadIdx.x; e < qn * kn; e += kAttnThreads) {
    const int q = e / kn, kk = e % kn;
    a.s[q * a.ls + kk] = expf(score(a, res_rh, q0, q, k0, kk, d) - cm[kk]) / cl[kk];
    if (gc) {
      const float* gr = gc + q * a.lv;
      const float* vr = a.vc + kk * a.lv;
      float acc = 0.f;
      for (int c = 0; c < d.dv; ++c) acc = fmaf(gr[c], vr[c], acc);
      ga[q * a.ls + kk] = acc;
    }
  }
}

// Pass 2: the raw scores (when `scores` is given), the query-axis softmax
// and ctx (Mp, hvp) float32, on the CUDA cores; each key column's max and
// sum of exp over the queries to stat (BF, H, T, 2)
template <typename TIn, bool ONE>
__global__ void __launch_bounds__(kAttnThreads, attn_min_blocks(ONE))
tat_attn_fwd_kernel(const float* __restrict__ qkv, const TIn* __restrict__ res, void* scores,
                    int out_f32, float* __restrict__ ctx, float* __restrict__ stat, D16 d) {
  extern __shared__ __align__(16) float sm[];
  const int r = blockIdx.x, h = blockIdx.y, T = d.T, nw = kAttnThreads / 32,
            warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  AttnTiles a;
  a.lq = d.dk + 1;
  a.lv = d.dv + 1;
  a.ls = d.KC + 1;
  a.q = sm;
  a.kc = a.q + d.QT * a.lq;
  a.vc = a.kc + d.KC * a.lq;
  a.s = a.vc + d.KC * a.lv;
  float* cs = a.s + d.QT * a.ls;  // (QT, dv) context sums
  float* cm = cs + d.QT * d.dv;   // the chunk's column max
  float* cl = cm + d.KC;          // and sum of exp
  const float* qkv_r = qkv + (size_t)r * T * d.Wp;
  const size_t off = ((size_t)r * d.H + h) * T * T;
  const TIn* res_rh = res + off;
  float* st = stat + ((size_t)r * d.H + h) * T * 2;
  float* ctx_r = ctx + (size_t)r * T * d.hvp + h * d.dv;
  // one query tile holds every query (T <= 160): each key chunk's column
  // softmax completes in the chunk, and its share of ctx is added at once
  constexpr bool one = ONE;
  if (one)
    for (int e = threadIdx.x; e < T * d.dv; e += kAttnThreads) cs[e] = 0.f;
  // 1. each key column's max and sum of exp over the query tiles (the sum
  // rescaled as the max moves), and the raw scores
  for (int k0 = 0; k0 < T; k0 += d.KC) {
    const int kn = min(d.KC, T - k0);
    __syncthreads();  // the last chunk's statistics are out (and its ctx share in)
    load_head(a.kc, a.lq, qkv_r + (size_t)k0 * d.Wp + d.hk + h * d.dk, d.Wp, kn, d.dk);
    if (one)
      load_head(a.vc, a.lv, qkv_r + (size_t)k0 * d.Wp + 2 * d.hk + h * d.dv, d.Wp, kn, d.dv);
    for (int kk = threadIdx.x; kk < kn; kk += kAttnThreads) {
      cm[kk] = -INFINITY;
      cl[kk] = 0.f;
    }
    for (int q0 = 0; q0 < T; q0 += d.QT) {
      const int qn = min(d.QT, T - q0);
      // the last tile's scores were formed before the last barrier
      if (!one || k0 == 0)
        load_head(a.q, a.lq, qkv_r + (size_t)q0 * d.Wp + h * d.dk, d.Wp, qn, d.dk);
      __syncthreads();
      score_tile(a, res_rh, scores, out_f32, off, q0, qn, k0, kn, d);
      __syncthreads();
      for (int kk = warp; kk < kn; kk += nw) {
        float m = -INFINITY;
        for (int q = lane; q < qn; q += 32) m = fmaxf(m, a.s[q * a.ls + kk]);
        m = fmaxf(dense::warp_max(m), cm[kk]);
        float sum = 0.f;
        for (int q = lane; q < qn; q += 32) {
          const float v = expf(a.s[q * a.ls + kk] - m);
          a.s[q * a.ls + kk] = v;
          sum += v;
        }
        sum = dense::warp_sum(sum);
        if (one)  // the column is complete in its one tile: a = exp / sum in place
          for (int q = lane; q < qn; q += 32) a.s[q * a.ls + kk] = a.s[q * a.ls + kk] / sum;
        if (lane == 0) {
          cl[kk] = cl[kk] * expf(cm[kk] - m) + sum;
          cm[kk] = m;
        }
      }
    }
    __syncthreads();
    for (int kk = threadIdx.x; kk < kn; kk += kAttnThreads) {
      st[2 * (k0 + kk)] = cm[kk];
      st[2 * (k0 + kk) + 1] = cl[kk];
    }
    if (one)  // the chunk's share of ctx from the attention in place
      for (int e = threadIdx.x; e < T * d.dv; e += kAttnThreads) {
        const int q = e / d.dv, c = e % d.dv;
        float acc = cs[e];
        for (int kk = 0; kk < kn; ++kk) acc = fmaf(a.s[q * a.ls + kk], a.vc[kk * a.lv + c], acc);
        cs[e] = acc;
      }
  }
  if (one) {
    __syncthreads();
    for (int e = threadIdx.x; e < T * d.dv; e += kAttnThreads)
      ctx_r[(size_t)(e / d.dv) * d.hvp + e % d.dv] = cs[e];
    return;
  }
  // 2. ctx a query tile at a time, the attention rebuilt from the statistics
  for (int q0 = 0; q0 < T; q0 += d.QT) {
    const int qn = min(d.QT, T - q0);
    __syncthreads();
    load_head(a.q, a.lq, qkv_r + (size_t)q0 * d.Wp + h * d.dk, d.Wp, qn, d.dk);
    for (int e = threadIdx.x; e < qn * d.dv; e += kAttnThreads) cs[e] = 0.f;
    for (int k0 = 0; k0 < T; k0 += d.KC) {
      const int kn = min(d.KC, T - k0);
      __syncthreads();  // the last chunk is consumed
      load_head(a.kc, a.lq, qkv_r + (size_t)k0 * d.Wp + d.hk + h * d.dk, d.Wp, kn, d.dk);
      load_head(a.vc, a.lv, qkv_r + (size_t)k0 * d.Wp + 2 * d.hk + h * d.dv, d.Wp, kn, d.dv);
      for (int kk = threadIdx.x; kk < kn; kk += kAttnThreads) {
        cm[kk] = st[2 * (k0 + kk)];
        cl[kk] = st[2 * (k0 + kk) + 1];
      }
      __syncthreads();
      attn_tile(a, res_rh, cm, cl, nullptr, nullptr, q0, qn, k0, kn, d);
      __syncthreads();
      for (int e = threadIdx.x; e < qn * d.dv; e += kAttnThreads) {
        const int q = e / d.dv, c = e % d.dv;
        float acc = cs[e];
        for (int kk = 0; kk < kn; ++kk) acc = fmaf(a.s[q * a.ls + kk], a.vc[kk * a.lv + c], acc);
        cs[e] = acc;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < qn * d.dv; e += kAttnThreads)
      ctx_r[(size_t)(q0 + e / d.dv) * d.hvp + e % d.dv] = cs[e];
  }
}

// The chunked route, for heads too wide for the others: d_k and d_v staged
// kHeadChunk columns at a time. The raw scores of the (qn, kn) tile to a.s:
// each score's FMA chain over d_k runs on chunk by chunk through a.s (the
// same thread owns an element in every chunk), then / sqrt(dk) + res.
template <typename TIn>
__device__ __forceinline__ void chunk_score_tile(const AttnTiles& a,
                                                 const float* __restrict__ qkv_r, int h,
                                                 const TIn* __restrict__ res_rh, int q0, int qn,
                                                 int k0, int kn, const D16& d) {
  for (int c0 = 0; c0 < d.dk; c0 += kHeadChunk) {
    const int cw = min(kHeadChunk, d.dk - c0);
    __syncthreads();  // the tiles' last users are done
    load_head(a.q, a.lq, qkv_r + (size_t)q0 * d.Wp + h * d.dk + c0, d.Wp, qn, cw);
    load_head(a.kc, a.lq, qkv_r + (size_t)k0 * d.Wp + d.hk + h * d.dk + c0, d.Wp, kn, cw);
    __syncthreads();
    for (int e = threadIdx.x; e < qn * kn; e += kAttnThreads) {
      const int q = e / kn, kk = e % kn;
      const float* qr = a.q + q * a.lq;
      const float* kr = a.kc + kk * a.lq;
      float dot = c0 == 0 ? 0.f : a.s[q * a.ls + kk];
      for (int c = 0; c < cw; ++c) dot = fmaf(qr[c], kr[c], dot);
      a.s[q * a.ls + kk] = dot;
    }
  }
  for (int e = threadIdx.x; e < qn * kn; e += kAttnThreads) {
    const int q = e / kn, kk = e % kn;
    a.s[q * a.ls + kk] =
        a.s[q * a.ls + kk] * d.inv_sqrt + to_float(res_rh[(size_t)(q0 + q) * d.T + k0 + kk]);
  }
}

// Pass 2 on the chunked route: the raw scores and each key column's
// statistics over the query tiles, then ctx a query tile at a time, the
// attention rebuilt from the statistics and ctx's sums kept in device
// memory (the block's own entries), v a d_v chunk at a time
template <typename TIn>
__global__ void __launch_bounds__(kAttnThreads, attn_min_blocks(false))
tat_attn_fwd_chunk_kernel(const float* __restrict__ qkv, const TIn* __restrict__ res,
                          void* scores, int out_f32, float* __restrict__ ctx,
                          float* __restrict__ stat, D16 d) {
  extern __shared__ __align__(16) float sm[];
  const int r = blockIdx.x, h = blockIdx.y, T = d.T, nw = kAttnThreads / 32,
            warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int CV = min(d.dv, kHeadChunk);
  AttnTiles a;
  a.lq = min(d.dk, kHeadChunk) + 1;
  a.lv = CV + 1;
  a.ls = d.KC + 1;
  a.q = sm;
  a.kc = a.q + d.QT * a.lq;
  a.vc = a.kc + d.KC * a.lq;
  a.s = a.vc + d.KC * a.lv;
  float* cm = a.s + d.QT * a.ls;  // the chunk's column max
  float* cl = cm + d.KC;          // and sum of exp
  const float* qkv_r = qkv + (size_t)r * T * d.Wp;
  const size_t off = ((size_t)r * d.H + h) * T * T;
  const TIn* res_rh = res + off;
  float* st = stat + ((size_t)r * d.H + h) * T * 2;
  float* ctx_r = ctx + (size_t)r * T * d.hvp + h * d.dv;
  // 1. each key column's max and sum of exp over the query tiles, and the raw scores
  for (int k0 = 0; k0 < T; k0 += d.KC) {
    const int kn = min(d.KC, T - k0);
    __syncthreads();  // the last chunk's statistics are out
    for (int kk = threadIdx.x; kk < kn; kk += kAttnThreads) {
      cm[kk] = -INFINITY;
      cl[kk] = 0.f;
    }
    for (int q0 = 0; q0 < T; q0 += d.QT) {
      const int qn = min(d.QT, T - q0);
      chunk_score_tile(a, qkv_r, h, res_rh, q0, qn, k0, kn, d);
      if (scores)
        for (int e = threadIdx.x; e < qn * kn; e += kAttnThreads) {
          const int q = e / kn, kk = e % kn;
          store_out(scores, off + (size_t)(q0 + q) * T + k0 + kk, a.s[q * a.ls + kk], out_f32);
        }
      __syncthreads();
      for (int kk = warp; kk < kn; kk += nw) {
        float m = -INFINITY;
        for (int q = lane; q < qn; q += 32) m = fmaxf(m, a.s[q * a.ls + kk]);
        m = fmaxf(dense::warp_max(m), cm[kk]);
        float sum = 0.f;
        for (int q = lane; q < qn; q += 32) sum += expf(a.s[q * a.ls + kk] - m);
        sum = dense::warp_sum(sum);
        if (lane == 0) {
          cl[kk] = cl[kk] * expf(cm[kk] - m) + sum;
          cm[kk] = m;
        }
      }
    }
    __syncthreads();
    for (int kk = threadIdx.x; kk < kn; kk += kAttnThreads) {
      st[2 * (k0 + kk)] = cm[kk];
      st[2 * (k0 + kk) + 1] = cl[kk];
    }
  }
  // 2. ctx a query tile at a time
  for (int q0 = 0; q0 < T; q0 += d.QT) {
    const int qn = min(d.QT, T - q0);
    for (int k0 = 0; k0 < T; k0 += d.KC) {
      const int kn = min(d.KC, T - k0);
      __syncthreads();  // the last chunk is consumed (and the statistics are out)
      for (int kk = threadIdx.x; kk < kn; kk += kAttnThreads) {
        cm[kk] = st[2 * (k0 + kk)];
        cl[kk] = st[2 * (k0 + kk) + 1];
      }
      chunk_score_tile(a, qkv_r, h, res_rh, q0, qn, k0, kn, d);
      for (int e = threadIdx.x; e < qn * kn; e += kAttnThreads) {
        const int q = e / kn, kk = e % kn;
        a.s[q * a.ls + kk] = expf(a.s[q * a.ls + kk] - cm[kk]) / cl[kk];
      }
      for (int c0 = 0; c0 < d.dv; c0 += CV) {
        const int cw = min(CV, d.dv - c0);
        __syncthreads();  // the attention is complete, or the last v chunk is consumed
        load_head(a.vc, a.lv, qkv_r + (size_t)k0 * d.Wp + 2 * d.hk + h * d.dv + c0, d.Wp, kn,
                  cw);
        __syncthreads();
        for (int e = threadIdx.x; e < qn * cw; e += kAttnThreads) {
          const int q = e / cw, c = e % cw;
          float* o = ctx_r + (size_t)(q0 + q) * d.hvp + c0 + c;
          float acc = k0 == 0 ? 0.f : *o;
          for (int kk = 0; kk < kn; ++kk) acc = fmaf(a.s[q * a.ls + kk], a.vc[kk * a.lv + c], acc);
          *o = acc;
        }
      }
    }
  }
}

// z (rows, NC + 4) = ctx . wo + te over the columns [c0, c0 + cn) of the
// block's rows, float32, from ctx split into the hi/lo tiles ahi, alo (rows
// x (HC + 8) bf16): all of ctx, split once by the caller (HC = hvp), or
// (SPLIT) HC columns of ctx at a time split here from ctx, each chunk's
// product continuing the sums in zs; wo_lo (wo's lo terms) null in bf16.
// Columns past N and rows past M come out 0. The same sequence every call:
// a recomputed chunk has the bits of the first.
template <int RT, bool SPLIT, typename TIn>
__device__ __forceinline__ void z_chunk(bf16* ahi, bf16* alo, const float* __restrict__ ctx,
                                        int HC, const bf16* __restrict__ wo,
                                        const bf16* __restrict__ wo_lo,
                                        const TIn* __restrict__ x,
                                        const float* __restrict__ te32, float* zs, int row0,
                                        int c0, int cn, const D16& d) {
  constexpr int R = RT * 16;
  const int LA = HC + 8, LZ = d.NC + 4, NT = cn / 16, warp = threadIdx.x / 32;
  const int nh = SPLIT ? (d.hvp + HC - 1) / HC : 1;  // ctx's chunks (one: the caller's split)
  for (int hi = 0; hi < nh; ++hi) {
    const int h0 = hi * HC, hn = SPLIT ? min(HC, d.hvp - h0) : d.hvp;
    __syncthreads();  // the last chunk is consumed (and ctx is split)
    if (SPLIT) {
      split_rows(ctx + h0, d.hvp, row0, d.M, R, hn, min(hn, d.hv - h0), ahi, alo, LA);
      __syncthreads();
    }
    const size_t wo0 = (size_t)h0 * d.Np + c0;
    for (int ct0 = 2 * warp; ct0 < NT; ct0 += 2 * kWarps) {
      FragC acc[RT][2];
      wide_mma<RT, false>(acc, ahi, alo, LA, hn, wo + wo0, wo_lo ? wo_lo + wo0 : nullptr, d.Np,
                          ct0, NT, SPLIT && h0 > 0 ? zs : nullptr, LZ);
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (ct0 + q < NT)
            wmma::store_matrix_sync(zs + r * 16 * LZ + (ct0 + q) * 16, acc[r][q], LZ,
                                    wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * cn; e += kThreads) {
    const int r = e / cn, j = e % cn;
    if (c0 + j < d.N) zs[r * LZ + j] += te_at(x, te32, row0 + r, c0 + j, d);
  }
  __syncthreads();
}

// Pass 3: out = LN(ctx . wo + te)*g1 + b1, rounded once to bf16 (or
// float32), over column chunks of N; with more than one chunk, the block's
// rows of zbuf (Mp, Np) hold the chunks between the sweeps. Warp w owns rows
// w + kWarps*i and their statistics (rs, in shared memory).
template <int RT, typename TIn, bool SPLIT>
__global__ void __launch_bounds__(kThreads, kOutMinBlocks)
tat_out_kernel(const float* __restrict__ ctx, const bf16* __restrict__ wo,
               const bf16* __restrict__ wo_lo, const TIn* __restrict__ x,
               const float* __restrict__ te32,
               const float* __restrict__ g1, const float* __restrict__ b1, void* out,
               int out_f32, float* __restrict__ zbuf, D16 d) {
  constexpr int R = RT * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int HC = hv_chunk(d, SPLIT), LZ = d.NC + 4, LA = HC + 8, row0 = blockIdx.x * R,
            warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* zs = reinterpret_cast<float*>(smem);
  bf16* ahi = reinterpret_cast<bf16*>(zs + R * LZ);
  bf16* alo = ahi + R * LA;
  float* rs = reinterpret_cast<float*>(alo + R * LA);  // (R, 2): mean, m2
  // ctx split once where it is held whole, else a chunk at a time in z_chunk
  if (!SPLIT) split_rows(ctx, d.hvp, row0, d.M, R, d.hvp, d.hv, ahi, alo, LA);
  // the chunk [c0, c0 + cn) of the block's rows between zs and zbuf
  auto move = [&](int c0, int cn, bool to_buf) {
    for (int e = threadIdx.x; e < R * cn; e += kThreads) {
      const int r = e / cn, j = e % cn;
      float* z = zbuf + (size_t)(row0 + r) * d.Np + c0 + j;
      if (to_buf)
        *z = zs[r * LZ + j];
      else
        zs[r * LZ + j] = *z;
    }
  };
  // steps 0 .. nch-1 form the chunks and merge their statistics (each but
  // the last kept in zbuf); from the last chunk on each writes out a chunk:
  // the last as it is formed, the others read back last to first
  for (int step = 0; step < 2 * d.nch - 1; ++step) {
    const int c0 = (step < d.nch ? step : 2 * d.nch - 2 - step) * d.NC;
    const int cn = min(d.NC, d.Np - c0), cv = min(cn, d.N - c0);
    if (step < d.nch) {
      z_chunk<RT, SPLIT>(ahi, alo, ctx, HC, wo, wo_lo, x, te32, zs, row0, c0, cn, d);
      for (int r = warp; r < R; r += kWarps) dense::merge_row(zs + r * LZ, cv, c0, rs + 2 * r);
    } else {
      __syncthreads();  // the last chunk is written out
      move(c0, cn, false);
      __syncthreads();
    }
    if (step < d.nch - 1) {
      move(c0, cn, true);
      continue;
    }
    for (int r = warp; r < R; r += kWarps) {
      const int row = row0 + r;
      if (row >= d.M) break;
      const float* zr = zs + r * LZ;
      const float mean = rs[2 * r], inv = rsqrtf(rs[2 * r + 1] / d.N + dense::kEps);
      for (int j = lane; j < cv; j += 32)
        store_out(out, (size_t)row * d.N + c0 + j,
                  (zr[j] - mean) * inv * g1[c0 + j] + b1[c0 + j], out_f32);
    }
  }
}

// Pass 4: z again, LN1 backward with g_out -> g_ypre (Mp, Np) float32 and
// per-block partials of dg1, db1 (2N a block); then g_ctx (Mp, hvp) = g_ypre
// . wo^T, g_ypre split chunk by chunk, wo's chunks (hi, and lo in float32)
// staged by cp.async. Column chunks of N as in pass 3; with more than one,
// the block's own rows of gy hold z, then x_hat, between the sweeps.
template <int RT, typename TIn, bool SPLIT>
__global__ void __launch_bounds__(kThreads, kLn1MinBlocks)
tat_ln1_bwd_kernel(const float* __restrict__ ctx, const bf16* __restrict__ wo,
                   const bf16* __restrict__ wo_lo, const TIn* __restrict__ x,
                   const float* __restrict__ te32, const float* __restrict__ g1,
                   const TIn* __restrict__ g_out,
                   float* __restrict__ part, float* __restrict__ gy, float* __restrict__ gctx,
                   D16 d) {
  constexpr int R = RT * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int HC = hv_chunk(d, SPLIT), GC = SPLIT ? ln1_group(d, R) : d.hvp, LZ = d.NC + 4,
            LA = HC + 8, N = d.N, row0 = blockIdx.x * R, warp = threadIdx.x / 32,
            lane = threadIdx.x % 32;
  const bool one = d.nch == 1;  // the row is one chunk: it stays in shared memory
  float* zs = reinterpret_cast<float*>(smem);
  bf16* u = reinterpret_cast<bf16*>(zs + R * LZ);
  const size_t ua = 4 * (size_t)R * LA,
               uc = 4 * (size_t)R * kLC + 2 * (size_t)GC * kLC * (1 + d.f32);
  // (R, 4): mean, m2, and the sums of g*g1 and g*g1*x_hat
  float* rs = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(u) + (ua > uc ? ua : uc));
  if (!SPLIT) split_rows(ctx, d.hvp, row0, d.M, R, d.hvp, d.hv, u, u + R * LA, LA);
  // the chunk [c0, c0 + cn) of the block's rows between zs and gy (rows < Mp)
  auto move = [&](int c0, int cn, bool to_gy) {
    for (int e = threadIdx.x; e < R * cn; e += kThreads) {
      const int r = e / cn, j = e % cn;
      float* g = gy + (size_t)(row0 + r) * d.Np + c0 + j;
      if (to_gy)
        *g = zs[r * LZ + j];
      else
        zs[r * LZ + j] = *g;
    }
  };
  // 1. z chunk by chunk and the rows' statistics
  for (int c0 = 0; c0 < d.Np; c0 += d.NC) {
    const int cn = min(d.NC, d.Np - c0), cv = min(cn, N - c0);
    z_chunk<RT, SPLIT>(u, u + R * LA, ctx, HC, wo, wo_lo, x, te32, zs, row0, c0, cn, d);
    for (int r = warp; r < R; r += kWarps) dense::merge_row(zs + r * LZ, cv, c0, rs + 4 * r);
    if (!one) move(c0, cn, true);
  }
  // 2. x_hat in place, the row sums of g*g1 and g*g1*x_hat, the column partials
  for (int r = warp; r < R; r += kWarps)
    if (lane == 0) rs[4 * r + 2] = rs[4 * r + 3] = 0.f;
  for (int c0 = 0; c0 < d.Np; c0 += d.NC) {
    const int cn = min(d.NC, d.Np - c0), cv = min(cn, N - c0);
    if (!one) {
      __syncthreads();  // the last chunk is consumed
      move(c0, cn, false);
    }
    __syncthreads();
    for (int r = warp; r < R; r += kWarps) {
      const int row = row0 + r;
      if (row >= d.M) break;
      float* zr = zs + r * LZ;
      const float mean = rs[4 * r], inv = rsqrtf(rs[4 * r + 1] / N + dense::kEps);
      const TIn* go = g_out + (size_t)row * N + c0;
      float a = 0.f, b = 0.f;
      for (int j = lane; j < cv; j += 32) {
        const float xh = (zr[j] - mean) * inv, gg = to_float(go[j]) * g1[c0 + j];
        zr[j] = xh;
        a += gg;
        b = fmaf(gg, xh, b);
      }
      a = dense::warp_sum(a);
      b = dense::warp_sum(b);
      if (lane == 0) {
        rs[4 * r + 2] += a;
        rs[4 * r + 3] += b;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < cv; j += kThreads) {
      float sg = 0.f, sb = 0.f;
      for (int r = 0; r < R && row0 + r < d.M; ++r) {
        const float g = to_float(g_out[(size_t)(row0 + r) * N + c0 + j]);
        sg = fmaf(g, zs[r * LZ + j], sg);
        sb += g;
      }
      part[(size_t)blockIdx.x * 2 * N + c0 + j] = sg;
      part[(size_t)blockIdx.x * 2 * N + N + c0 + j] = sb;
    }
    if (!one) move(c0, cn, true);
  }
  // 3. g_ypre in place of x_hat, to gy
  for (int c0 = 0; c0 < d.Np; c0 += d.NC) {
    const int cn = min(d.NC, d.Np - c0), cv = min(cn, N - c0);
    if (!one) {
      __syncthreads();
      move(c0, cn, false);
    }
    __syncthreads();
    for (int r = warp; r < R; r += kWarps) {
      const int row = row0 + r;
      float* zr = zs + r * LZ;
      if (row >= d.M) {
        for (int j = lane; j < cn; j += 32) zr[j] = 0.f;
        continue;
      }
      const float inv = rsqrtf(rs[4 * r + 1] / N + dense::kEps), m1v = rs[4 * r + 2] / N,
                  m2v = rs[4 * r + 3] / N;
      const TIn* go = g_out + (size_t)row * N + c0;
      for (int j = lane; j < cv; j += 32) {
        const float gg = to_float(go[j]) * g1[c0 + j];
        const float v = inv * (gg - m1v - zr[j] * m2v);
        zr[j] = v;
        gy[(size_t)row * d.Np + c0 + j] = v;
      }
    }
    if (!one) {
      __syncthreads();
      move(c0, cn, true);
    }
  }
  // 4. g_ctx = g_ypre . wo^T over 64-column chunks of N, a group of GC of
  // its columns at a time (all of them where the pass is not split)
  bf16* chi = u;
  bf16* clo = chi + R * kLC;
  bf16* sb = clo + R * kLC;                      // (GC, kLC): wo[g0:g0 + gn, k0:k0 + kn]
  bf16* sbl = wo_lo ? sb + GC * kLC : nullptr;  // its lo terms
  const int ng = SPLIT ? (d.hvp + GC - 1) / GC : 1;
  for (int gi = 0; gi < ng; ++gi) {
    const int g0 = gi * GC, gn = SPLIT ? min(GC, d.hvp - g0) : d.hvp, nct = gn / 16,
              items = RT * nct;
    FragC acc[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) wmma::fill_fragment(acc[i], 0.f);
    for (int k0 = 0; k0 < d.Np; k0 += kKC) {
      const int kn = min(kKC, d.Np - k0);
      __syncthreads();  // g_ypre is complete, or the last chunk is consumed
      copy_rows_async(sb, kLC, wo + (size_t)g0 * d.Np + k0, d.Np, gn, kn);
      if (sbl) copy_rows_async(sbl, kLC, wo_lo + (size_t)g0 * d.Np + k0, d.Np, gn, kn);
      for (int e = threadIdx.x; e < R * kn; e += kThreads) {
        const int r = e / kn, c = e % kn;
        const float v = one ? zs[r * LZ + k0 + c] : gy[(size_t)(row0 + r) * d.Np + k0 + c];
        split(v, chi[r * kLC + c], clo[r * kLC + c]);
      }
      wait_async();
      __syncthreads();
      chunk_mma<true>(acc, items, nct, chi, clo, sb, sbl, kLC, kn);
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int item = warp + kWarps * i;
      if (item >= items) break;
      const int r = item / nct, c = item % nct;
      wmma::store_matrix_sync(gctx + (size_t)(row0 + r * 16) * d.hvp + g0 + c * 16, acc[i],
                              d.hvp, wmma::mem_row_major);
    }
  }
}

// Pass 5: the attention backward of one (r, h) on the CUDA cores, a key
// chunk at a time: for every query tile s and a rebuilt from the forward's
// column statistics and g_a = g_ctx . v^T, the column term delta_k =
// sum_q a g_a and g_v; then ds = a (g_a - delta) + g_sc -> dres, g_k of the
// chunk, and each query tile's g_q added in place in g_qkv (Mp, Wp) float32
template <typename TIn, bool ONE>
__global__ void __launch_bounds__(kAttnThreads, attn_min_blocks(ONE))
tat_attn_bwd_kernel(const float* __restrict__ qkv, const TIn* __restrict__ res,
                    const float* __restrict__ gctx, const float* __restrict__ stat,
                    const TIn* __restrict__ g_sc, void* dres, int out_f32,
                    float* __restrict__ gqkv, D16 d) {
  extern __shared__ __align__(16) float sm[];
  const int r = blockIdx.x, h = blockIdx.y, T = d.T, nw = kAttnThreads / 32,
            warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  AttnTiles a;
  a.lq = d.dk + 1;
  a.lv = d.dv + 1;
  a.ls = d.KC + 1;
  a.q = sm;
  float* gc = a.q + d.QT * a.lq;  // (QT, lv) g_ctx rows
  a.kc = gc + d.QT * a.lv;
  a.vc = a.kc + d.KC * a.lq;
  a.s = a.vc + d.KC * a.lv;       // (QT, ls): s, then a
  float* ga = a.s + d.QT * a.ls;  // (QT, ls): g_a, then ds
  float* gk = ga + d.QT * a.ls;   // (KC, dk) the chunk's g_k sums
  float* gv = gk + d.KC * d.dk;   // (KC, dv) and g_v sums
  float* dl = gv + d.KC * d.dv;   // delta of the chunk's columns
  float* cm = dl + d.KC;
  float* cl = cm + d.KC;
  const float* qkv_r = qkv + (size_t)r * T * d.Wp;
  float* gqkv_r = gqkv + (size_t)r * T * d.Wp;
  const size_t off = ((size_t)r * d.H + h) * T * T;
  const TIn* res_rh = res + off;
  const float* st = stat + ((size_t)r * d.H + h) * T * 2;
  constexpr bool one = ONE;  // one query tile: sweep b finds a and g_a in place
  auto stage = [&](int q0, int qn) {  // the tile's q and g_ctx rows
    load_head(a.q, a.lq, qkv_r + (size_t)q0 * d.Wp + h * d.dk, d.Wp, qn, d.dk);
    load_head(gc, a.lv, gctx + ((size_t)r * T + q0) * d.hvp + h * d.dv, d.hvp, qn, d.dv);
  };
  for (int k0 = 0; k0 < T; k0 += d.KC) {
    const int kn = min(d.KC, T - k0);
    __syncthreads();  // the last chunk is consumed
    load_head(a.kc, a.lq, qkv_r + (size_t)k0 * d.Wp + d.hk + h * d.dk, d.Wp, kn, d.dk);
    load_head(a.vc, a.lv, qkv_r + (size_t)k0 * d.Wp + 2 * d.hk + h * d.dv, d.Wp, kn, d.dv);
    for (int kk = threadIdx.x; kk < kn; kk += kAttnThreads) {
      cm[kk] = st[2 * (k0 + kk)];
      cl[kk] = st[2 * (k0 + kk) + 1];
      dl[kk] = 0.f;
    }
    for (int e = threadIdx.x; e < kn * d.dk; e += kAttnThreads) gk[e] = 0.f;
    for (int e = threadIdx.x; e < kn * d.dv; e += kAttnThreads) gv[e] = 0.f;
    // a. delta and g_v over every query tile
    for (int q0 = 0; q0 < T; q0 += d.QT) {
      const int qn = min(d.QT, T - q0);
      if (q0 > 0) __syncthreads();  // the last tile is consumed
      if (!one || k0 == 0) stage(q0, qn);  // one tile: staged once
      __syncthreads();
      attn_tile(a, res_rh, cm, cl, gc, ga, q0, qn, k0, kn, d);
      __syncthreads();
      for (int kk = warp; kk < kn; kk += nw) {
        float dot = 0.f;
        for (int q = lane; q < qn; q += 32)
          dot = fmaf(a.s[q * a.ls + kk], ga[q * a.ls + kk], dot);
        dot = dense::warp_sum(dot);
        if (lane == 0) dl[kk] += dot;
      }
      for (int e = threadIdx.x; e < kn * d.dv; e += kAttnThreads) {
        const int kk = e / d.dv, c = e % d.dv;
        float acc = gv[e];
        for (int q = 0; q < qn; ++q) acc = fmaf(a.s[q * a.ls + kk], gc[q * a.lv + c], acc);
        gv[e] = acc;
      }
    }
    // b. ds -> dres, g_k of the chunk, g_q of each query tile
    for (int q0 = 0; q0 < T; q0 += d.QT) {
      const int qn = min(d.QT, T - q0);
      __syncthreads();  // delta is complete / the last tile is consumed
      if (!one) {
        stage(q0, qn);
        __syncthreads();
        attn_tile(a, res_rh, cm, cl, gc, ga, q0, qn, k0, kn, d);
        __syncthreads();
      }
      for (int e = threadIdx.x; e < qn * kn; e += kAttnThreads) {
        const int q = e / kn, kk = e % kn;
        const size_t o = off + (size_t)(q0 + q) * T + k0 + kk;
        const float v = a.s[q * a.ls + kk] * (ga[q * a.ls + kk] - dl[kk]) + to_float(g_sc[o]);
        ga[q * a.ls + kk] = v;
        store_out(dres, o, v, out_f32);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < kn * d.dk; e += kAttnThreads) {
        const int kk = e / d.dk, c = e % d.dk;
        float acc = gk[e];
        for (int q = 0; q < qn; ++q) acc = fmaf(ga[q * a.ls + kk], a.q[q * a.lq + c], acc);
        gk[e] = acc;
      }
      for (int e = threadIdx.x; e < qn * d.dk; e += kAttnThreads) {
        const int q = e / d.dk, c = e % d.dk;
        float acc = 0.f;
        for (int kk = 0; kk < kn; ++kk) acc = fmaf(ga[q * a.ls + kk], a.kc[kk * a.lq + c], acc);
        float* gq = gqkv_r + (size_t)(q0 + q) * d.Wp + h * d.dk + c;
        *gq = k0 == 0 ? acc * d.inv_sqrt : *gq + acc * d.inv_sqrt;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kn * d.dk; e += kAttnThreads)
      gqkv_r[(size_t)(k0 + e / d.dk) * d.Wp + d.hk + h * d.dk + e % d.dk] = gk[e] * d.inv_sqrt;
    for (int e = threadIdx.x; e < kn * d.dv; e += kAttnThreads)
      gqkv_r[(size_t)(k0 + e / d.dv) * d.Wp + 2 * d.hk + h * d.dv + e % d.dv] = gv[e];
  }
}

// g_a of the (qn, kn) tile = g_ctx . v^T into ga, g_ctx and v staged a d_v
// chunk at a time (each element's chain run on through ga); with gv, also
// g_v += a^T g_ctx for the chunk's keys in place in g_qkv (the block's own
// entries, from 0 at the first query tile)
__device__ __forceinline__ void chunk_g_a(const AttnTiles& a, float* gc, float* ga,
                                          const float* __restrict__ qkv_r,
                                          const float* __restrict__ gctx_r, float* gqkv_r, int h,
                                          int q0, int qn, int k0, int kn, bool gv, const D16& d) {
  const int CV = min(d.dv, kHeadChunk);
  for (int c0 = 0; c0 < d.dv; c0 += CV) {
    const int cw = min(CV, d.dv - c0);
    __syncthreads();  // a is complete, or the last chunk is consumed
    load_head(gc, a.lv, gctx_r + (size_t)q0 * d.hvp + h * d.dv + c0, d.hvp, qn, cw);
    load_head(a.vc, a.lv, qkv_r + (size_t)k0 * d.Wp + 2 * d.hk + h * d.dv + c0, d.Wp, kn, cw);
    __syncthreads();
    for (int e = threadIdx.x; e < qn * kn; e += kAttnThreads) {
      const int q = e / kn, kk = e % kn;
      float acc = c0 == 0 ? 0.f : ga[q * a.ls + kk];
      for (int c = 0; c < cw; ++c) acc = fmaf(gc[q * a.lv + c], a.vc[kk * a.lv + c], acc);
      ga[q * a.ls + kk] = acc;
    }
    if (!gv) continue;
    for (int e = threadIdx.x; e < kn * cw; e += kAttnThreads) {
      const int kk = e / cw, c = e % cw;
      float* o = gqkv_r + (size_t)(k0 + kk) * d.Wp + 2 * d.hk + h * d.dv + c0 + c;
      float acc = q0 == 0 ? 0.f : *o;
      for (int q = 0; q < qn; ++q) acc = fmaf(a.s[q * a.ls + kk], gc[q * a.lv + c], acc);
      *o = acc;
    }
  }
}

// Pass 5 on the chunked route: as tat_attn_bwd_kernel, a key chunk at a
// time, with q, k, v and g_ctx staged a head chunk at a time and the
// chunk's g_k and g_v sums kept in place in g_qkv (the block's own entries)
template <typename TIn>
__global__ void __launch_bounds__(kAttnThreads, attn_min_blocks(false))
tat_attn_bwd_chunk_kernel(const float* __restrict__ qkv, const TIn* __restrict__ res,
                          const float* __restrict__ gctx, const float* __restrict__ stat,
                          const TIn* __restrict__ g_sc, void* dres, int out_f32,
                          float* __restrict__ gqkv, D16 d) {
  extern __shared__ __align__(16) float sm[];
  const int r = blockIdx.x, h = blockIdx.y, T = d.T, nw = kAttnThreads / 32,
            warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int CK = min(d.dk, kHeadChunk);
  AttnTiles a;
  a.lq = CK + 1;
  a.lv = min(d.dv, kHeadChunk) + 1;
  a.ls = d.KC + 1;
  a.q = sm;
  float* gc = a.q + d.QT * a.lq;  // (QT, lv) a chunk of the g_ctx rows
  a.kc = gc + d.QT * a.lv;
  a.vc = a.kc + d.KC * a.lq;
  a.s = a.vc + d.KC * a.lv;       // (QT, ls): s, then a
  float* ga = a.s + d.QT * a.ls;  // (QT, ls): g_a, then ds
  float* dl = ga + d.QT * a.ls;   // delta of the chunk's columns
  float* cm = dl + d.KC;
  float* cl = cm + d.KC;
  const float* qkv_r = qkv + (size_t)r * T * d.Wp;
  const float* gctx_r = gctx + (size_t)r * T * d.hvp;
  float* gqkv_r = gqkv + (size_t)r * T * d.Wp;
  const size_t off = ((size_t)r * d.H + h) * T * T;
  const TIn* res_rh = res + off;
  const float* st = stat + ((size_t)r * d.H + h) * T * 2;
  // a of the tile from the forward's column statistics
  auto attention = [&](int q0, int qn, int k0, int kn) {
    chunk_score_tile(a, qkv_r, h, res_rh, q0, qn, k0, kn, d);
    for (int e = threadIdx.x; e < qn * kn; e += kAttnThreads) {
      const int q = e / kn, kk = e % kn;
      a.s[q * a.ls + kk] = expf(a.s[q * a.ls + kk] - cm[kk]) / cl[kk];
    }
  };
  for (int k0 = 0; k0 < T; k0 += d.KC) {
    const int kn = min(d.KC, T - k0);
    __syncthreads();  // the last chunk is consumed
    for (int kk = threadIdx.x; kk < kn; kk += kAttnThreads) {
      cm[kk] = st[2 * (k0 + kk)];
      cl[kk] = st[2 * (k0 + kk) + 1];
      dl[kk] = 0.f;
    }
    // a. delta and g_v over every query tile
    for (int q0 = 0; q0 < T; q0 += d.QT) {
      const int qn = min(d.QT, T - q0);
      attention(q0, qn, k0, kn);
      chunk_g_a(a, gc, ga, qkv_r, gctx_r, gqkv_r, h, q0, qn, k0, kn, true, d);
      __syncthreads();
      for (int kk = warp; kk < kn; kk += nw) {
        float dot = 0.f;
        for (int q = lane; q < qn; q += 32)
          dot = fmaf(a.s[q * a.ls + kk], ga[q * a.ls + kk], dot);
        dot = dense::warp_sum(dot);
        if (lane == 0) dl[kk] += dot;
      }
    }
    // b. ds -> dres, g_k of the chunk, g_q of each query tile
    for (int q0 = 0; q0 < T; q0 += d.QT) {
      const int qn = min(d.QT, T - q0);
      attention(q0, qn, k0, kn);
      chunk_g_a(a, gc, ga, qkv_r, gctx_r, gqkv_r, h, q0, qn, k0, kn, false, d);
      for (int e = threadIdx.x; e < qn * kn; e += kAttnThreads) {
        const int q = e / kn, kk = e % kn;
        const size_t o = off + (size_t)(q0 + q) * T + k0 + kk;
        const float v = a.s[q * a.ls + kk] * (ga[q * a.ls + kk] - dl[kk]) + to_float(g_sc[o]);
        ga[q * a.ls + kk] = v;
        store_out(dres, o, v, out_f32);
      }
      for (int c0 = 0; c0 < d.dk; c0 += CK) {
        const int cw = min(CK, d.dk - c0);
        __syncthreads();  // ds is complete, or the last chunk is consumed
        load_head(a.q, a.lq, qkv_r + (size_t)q0 * d.Wp + h * d.dk + c0, d.Wp, qn, cw);
        load_head(a.kc, a.lq, qkv_r + (size_t)k0 * d.Wp + d.hk + h * d.dk + c0, d.Wp, kn, cw);
        __syncthreads();
        for (int e = threadIdx.x; e < kn * cw; e += kAttnThreads) {
          const int kk = e / cw, c = e % cw;
          float* o = gqkv_r + (size_t)(k0 + kk) * d.Wp + d.hk + h * d.dk + c0 + c;
          float acc = q0 == 0 ? 0.f : *o;
          for (int q = 0; q < qn; ++q) acc = fmaf(ga[q * a.ls + kk], a.q[q * a.lq + c], acc);
          *o = acc;
        }
        for (int e = threadIdx.x; e < qn * cw; e += kAttnThreads) {
          const int q = e / cw, c = e % cw;
          float acc = 0.f;
          for (int kk = 0; kk < kn; ++kk) acc = fmaf(ga[q * a.ls + kk], a.kc[kk * a.lq + c], acc);
          float* gq = gqkv_r + (size_t)(q0 + q) * d.Wp + h * d.dk + c0 + c;
          *gq = k0 == 0 ? acc * d.inv_sqrt : *gq + acc * d.inv_sqrt;
        }
      }
    }
    __syncthreads();  // the chunk's g_k sums are complete
    for (int e = threadIdx.x; e < kn * d.dk; e += kAttnThreads)
      gqkv_r[(size_t)(k0 + e / d.dk) * d.Wp + d.hk + h * d.dk + e % d.dk] *= d.inv_sqrt;
  }
}

// Pass 6: g_te = g_qkv . wqkv^T + g_ypre -> dx (rounded once); with the
// embedding, LN0 backward: g_te chunk by chunk of N into dxf (the float32
// copy of dx that dpos sums), the row sums and per-block partials of dg0,
// db0 (2N a block), then dx. Split (g_qkv too wide to hold whole), g_te
// runs chunk by chunk of N in both cases, g_qkv's columns a chunk at a time.
template <int RT, typename TIn, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
tat_gte_kernel(const float* __restrict__ gqkv, const bf16* __restrict__ wqkv,
               const bf16* __restrict__ wqkv_lo, const float* __restrict__ gy,
               const TIn* __restrict__ x,
               const float* __restrict__ pos, const float* __restrict__ stats0,
               const float* __restrict__ g0, void* dx, int out_f32, float* __restrict__ dxf,
               float* __restrict__ part, D16 d) {
  constexpr int R = RT * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int WC = SPLIT ? w_chunk(d) : d.Wp, LA = WC + 8, LZ = d.NC + 4, NT = d.Np / 16,
            N = d.N, row0 = blockIdx.x * R, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* ahi = reinterpret_cast<bf16*>(smem);
  bf16* alo = ahi + R * LA;
  float* rest = reinterpret_cast<float*>(alo + R * LA);  // staging, or a g_te chunk
  if (!SPLIT) {
    split_rows(gqkv, d.Wp, row0, d.M, R, d.Wp, d.W, ahi, alo, LA);
    __syncthreads();
  }
  if (!d.embed && !SPLIT) {
    float* sw = rest + warp * 256;
    for (int ct0 = 2 * warp; ct0 < NT; ct0 += 2 * kWarps) {
      FragC acc[RT][2];
      wide_mma<RT, true>(acc, ahi, alo, LA, d.Wp, wqkv, wqkv_lo, d.Wp, ct0, NT);
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (ct0 + q >= NT) continue;
          wmma::store_matrix_sync(sw, acc[r][q], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int row = row0 + r * 16 + e / 16, n = (ct0 + q) * 16 + e % 16;
            if (row < d.M && n < N)
              store_out(dx, (size_t)row * N + n, sw[e] + gy[(size_t)row * d.Np + n], out_f32);
          }
          __syncwarp();
        }
    }
    return;
  }
  // g_te a column chunk of N at a time into zs: (split) WC columns of g_qkv
  // at a time split here, each product continuing the sums in zs
  float* zs = rest;
  float* rs = zs + R * LZ;  // (R, 2): the sums of g*g0 and g*g0*x0_hat
  // x0_hat from the row statistics of pass 1
  auto x0_hat = [&](int row, int n) {
    const float z = to_float(x[(size_t)row * N + n]) + pos[(size_t)(row % d.T) * N + n];
    return (z - stats0[2 * row]) * stats0[2 * row + 1];
  };
  for (int r = warp; r < R; r += kWarps)
    if (lane == 0) rs[2 * r] = rs[2 * r + 1] = 0.f;
  for (int c0 = 0; c0 < d.Np; c0 += d.NC) {
    const int cn = min(d.NC, d.Np - c0), cv = min(cn, N - c0), NTc = cn / 16;
    const int nw = SPLIT ? (d.Wp + WC - 1) / WC : 1;
    for (int wi = 0; wi < nw; ++wi) {
      const int w0 = wi * WC, wn = SPLIT ? min(WC, d.Wp - w0) : d.Wp;
      __syncthreads();  // the last chunk is consumed
      if (SPLIT) {
        split_rows(gqkv + w0, d.Wp, row0, d.M, R, wn, min(wn, d.W - w0), ahi, alo, LA);
        __syncthreads();
      }
      const size_t wo0 = (size_t)c0 * d.Wp + w0;
      for (int ct0 = 2 * warp; ct0 < NTc; ct0 += 2 * kWarps) {
        FragC acc[RT][2];
        wide_mma<RT, true>(acc, ahi, alo, LA, wn, wqkv + wo0, wqkv_lo ? wqkv_lo + wo0 : nullptr,
                           d.Wp, ct0, NTc, SPLIT && w0 > 0 ? zs : nullptr, LZ);
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (ct0 + q < NTc)
              wmma::store_matrix_sync(zs + r * 16 * LZ + (ct0 + q) * 16, acc[r][q], LZ,
                                      wmma::mem_row_major);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < R * cv; e += kThreads) {
      const int r = e / cv, j = e % cv, row = row0 + r;
      zs[r * LZ + j] = row < d.M ? zs[r * LZ + j] + gy[(size_t)row * d.Np + c0 + j] : 0.f;
    }
    if (!d.embed) {  // split g_te without the embedding: dx from the chunk
      __syncthreads();
      for (int e = threadIdx.x; e < R * cv; e += kThreads) {
        const int r = e / cv, j = e % cv, row = row0 + r;
        if (row < d.M) store_out(dx, (size_t)row * N + c0 + j, zs[r * LZ + j], out_f32);
      }
      continue;
    }
    __syncthreads();
    for (int r = warp; r < R; r += kWarps) {
      const int row = row0 + r;
      if (row >= d.M) break;
      const float* zr = zs + r * LZ;
      float a = 0.f, b = 0.f;
      for (int j = lane; j < cv; j += 32) {
        const float gg = zr[j] * g0[c0 + j];
        a += gg;
        b = fmaf(gg, x0_hat(row, c0 + j), b);
      }
      a = dense::warp_sum(a);
      b = dense::warp_sum(b);
      if (lane == 0) {
        rs[2 * r] += a;
        rs[2 * r + 1] += b;
      }
    }
    for (int j = threadIdx.x; j < cv; j += kThreads) {
      float sg = 0.f, sb = 0.f;
      for (int r = 0; r < R && row0 + r < d.M; ++r) {
        const float g = zs[r * LZ + j];
        sg = fmaf(g, x0_hat(row0 + r, c0 + j), sg);
        sb += g;
      }
      part[(size_t)blockIdx.x * 2 * N + c0 + j] = sg;
      part[(size_t)blockIdx.x * 2 * N + N + c0 + j] = sb;
    }
    for (int e = threadIdx.x; e < R * cv; e += kThreads) {
      const int r = e / cv, j = e % cv, row = row0 + r;
      if (row < d.M) dxf[(size_t)row * N + c0 + j] = zs[r * LZ + j];
    }
  }
  if (!d.embed) return;
  __syncthreads();  // g_te is in dxf
  for (int r = warp; r < R; r += kWarps) {
    const int row = row0 + r;
    if (row >= d.M) break;
    const float inv = stats0[2 * row + 1], m1 = rs[2 * r] / N, m2 = rs[2 * r + 1] / N;
    for (int n = lane; n < N; n += 32) {
      float* f = dxf + (size_t)row * N + n;
      const float v = inv * (*f * g0[n] - m1 - x0_hat(row, n) * m2);
      store_out(dx, (size_t)row * N + n, v, out_f32);
      *f = v;
    }
  }
}

// The passes' operands from the caller's tensors: wqkv (N, W) and wo (hv,
// N) zero-padded to (Np, Wp) and (hvp, Np) bf16 (the WMMA tiles and the
// 16-byte cp.async copies need it), with their lo terms in float32 (w16lo,
// wo16lo; bf16 inputs are exact, nothing is lost), and pos (T, N), g0, b0,
// g1, b1 as float32 into vec = [pos | g0 | b0 | g1 | b1]
template <typename TIn>
__global__ void __launch_bounds__(kThreads)
tat_prep_kernel(const TIn* __restrict__ wqkv, const TIn* __restrict__ wo,
                const TIn* __restrict__ pos, const TIn* __restrict__ g0,
                const TIn* __restrict__ b0, const TIn* __restrict__ g1,
                const TIn* __restrict__ b1, bf16* __restrict__ w16, bf16* __restrict__ w16lo,
                bf16* __restrict__ wo16, bf16* __restrict__ wo16lo, float* __restrict__ vec,
                D16 d) {
  const size_t nw = (size_t)d.Np * d.Wp, no = (size_t)d.hvp * d.Np,
               TN = (size_t)d.T * d.N, nv = TN + 4 * (size_t)d.N;
  for (size_t e = blockIdx.x * (size_t)kThreads + threadIdx.x; e < nw + no + nv;
       e += (size_t)gridDim.x * kThreads) {
    if (e < nw + no) {
      const bool is_w = e < nw;
      const size_t i = is_w ? e : e - nw;
      const int ld = is_w ? d.Wp : d.Np, r = i / ld, c = i % ld;
      float v = 0.f;
      if (is_w && r < d.N && c < d.W) v = to_float(wqkv[(size_t)r * d.W + c]);
      if (!is_w && r < d.hv && c < d.N) v = to_float(wo[(size_t)r * d.N + c]);
      bf16 hi, lo;
      split(v, hi, lo);
      (is_w ? w16 : wo16)[i] = hi;
      if (d.f32) (is_w ? w16lo : wo16lo)[i] = lo;
    } else {
      const size_t i = e - nw - no;
      const TIn* src = i < TN ? pos + i : i < TN + d.N ? g0 + (i - TN)
                     : i < TN + 2 * d.N ? b0 + (i - TN - d.N)
                     : i < TN + 3 * d.N ? g1 + (i - TN - 2 * d.N) : b1 + (i - TN - 3 * d.N);
      vec[i] = to_float(*src);
    }
  }
}

// workspace layout (floats; every region 32-byte aligned): the bf16 weight
// copies, hi then (float32) lo
struct Space16 {
  size_t w16, wo16, vec, qkv, ctx, stat, gy, gctx, gqkv, te, stats, part1, part0, dxf, scratch,
      total;
};

Space16 space16(const D16& d, int backward) {
  const size_t Mp = (size_t)(d.M + 63) / 64 * 64;
  const int r4 = launch_rows16(kLn1Bwd, d), r6 = launch_rows16(kGte, d);
  const size_t t4 = Mp / (r4 ? r4 : 16), t6 = Mp / (r6 ? r6 : 16);
  auto a8 = [](size_t n) { return (n + 7) / 8 * 8; };
  Space16 s;
  size_t o = 0;
  auto take = [&](size_t n) {
    const size_t at = o;
    o += a8(n);
    return at;
  };
  s.w16 = take(((size_t)d.Np * d.Wp + 1) / 2 * (1 + d.f32));  // bf16
  s.wo16 = take(((size_t)d.hvp * d.Np + 1) / 2 * (1 + d.f32));  // bf16
  s.vec = take((size_t)d.T * d.N + 4 * (size_t)d.N);
  s.qkv = take(Mp * d.Wp);
  s.ctx = take(Mp * d.hvp);
  s.stat = take((size_t)d.BF * d.H * d.T * 2);  // the attention's column statistics
  s.te = take(d.embed ? Mp * d.Np : 0);
  s.stats = take(d.embed ? 2 * Mp : 0);
  s.gy = take(backward || d.nch > 1 ? Mp * d.Np : 0);  // forward: pass 3's z chunks
  s.gctx = take(backward ? Mp * d.hvp : 0);
  s.gqkv = take(backward ? Mp * d.Wp : 0);
  s.part1 = take(backward ? t4 * 2 * d.N : 0);
  s.part0 = take(backward && d.embed ? t6 * 2 * d.N : 0);
  s.dxf = take(backward && d.embed ? (size_t)d.M * d.N : 0);
  size_t scratch = 0;
  if (backward) {
    const size_t c[] = {atb_wmma_scratch(d.M, d.N, d.W), atb_wmma_scratch(d.M, d.hv, d.N),
                        dense::sum_rows_scratch((int)t4, 2 * d.N),
                        dense::sum_rows_scratch((int)t6, 2 * d.N),
                        dense::sum_rows_scratch(d.BF, d.T * d.N)};
    for (size_t v : c) scratch = v > scratch ? v : scratch;
  }
  s.scratch = take(scratch);
  s.total = o;
  return s;
}

// launch a row-tiled pass at its launch rows: k4, k2, k1 are its
// instantiations for 64, 32 and 16 rows
template <typename Kern, typename... Args>
cudaError_t launch_rows(Kern k4, Kern k2, Kern k1, int pass, const D16& d, cudaStream_t st,
                        Args... args) {
  const int rows = launch_rows16(pass, d);
  if (rows == 0) return cudaErrorInvalidValue;
  const Kern kernel = rows == 64 ? k4 : rows == 32 ? k2 : k1;
  const size_t smem = smem16(pass, rows, d);
  cudaError_t err = dense::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(d.M + 63) / 64 * 64 / rows, kThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

// a split-capable pass: its whole-width (SPLIT false) and split
// instantiations, each for 64, 32 and 16 rows
template <typename Kern, typename... Args>
cudaError_t launch_rows(int split, Kern w4, Kern w2, Kern w1, Kern s4, Kern s2, Kern s1, int pass,
                        const D16& d, cudaStream_t st, Args... args) {
  return split ? launch_rows(s4, s2, s1, pass, d, st, args...)
               : launch_rows(w4, w2, w1, pass, d, st, args...);
}

#define TAT_SPLIT_ROWS(kernel, TIn) TAT_ROWS(kernel, TIn, false), TAT_ROWS(kernel, TIn, true)
#define TAT_ROWS(kernel, ...) \
  kernel<4, __VA_ARGS__>, kernel<2, __VA_ARGS__>, kernel<1, __VA_ARGS__>

// an attention pass on its route (make_d16): `one`, `stream` and `chunk`
// its instantiations for the one-tile, streamed and chunked routes, each
// launched with the pass's copy of d (attn_d16) after args
template <typename Kern, typename... Args>
cudaError_t launch_attn(Kern one, Kern stream, Kern chunk, int pass, const D16& d,
                        cudaStream_t st, Args... args) {
  if (rows16(pass, d) == 0) return cudaErrorInvalidValue;
  const int route = pass == kAttnFwd ? d.route_fwd : d.route_bwd;
  const Kern kernel = route == kRouteOne ? one : route == kRouteStream ? stream : chunk;
  const size_t smem = smem16(pass, 1, d);
  cudaError_t err = dense::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(d.BF, d.H), kAttnThreads, smem, st>>>(args..., attn_d16(pass, d));
  return cudaGetLastError();
}

// the weights' bf16 copies in the workspace: hi, and lo in float32 (null in bf16)
struct Weights16 {
  const bf16 *w, *wlo, *wo, *wolo;
};

Weights16 weights16(float* ws, const Space16& s, const D16& d) {
  const bf16* w = reinterpret_cast<const bf16*>(ws + s.w16);
  const bf16* wo = reinterpret_cast<const bf16*>(ws + s.wo16);
  const size_t nw = (size_t)d.Np * d.Wp, no = (size_t)d.hvp * d.Np;
  return {w, d.f32 ? w + nw : nullptr, wo, d.f32 ? wo + no : nullptr};
}

// the prep kernel, then passes 1 and 2 (scores when given): qkv and ctx
// into the workspace
template <typename TIn>
cudaError_t prep_qkv_attn16(const TIn* x, const TIn* pos, const TIn* g0, const TIn* b0,
                            const TIn* wqkv, const TIn* wo, const TIn* g1, const TIn* b1,
                            const TIn* res, void* scores, int out_f32, float* ws,
                            const Space16& s, const D16& d, cudaStream_t st) {
  const Weights16 w = weights16(ws, s, d);
  const size_t n = (size_t)d.Np * d.Wp + (size_t)d.hvp * d.Np + (size_t)d.T * d.N + 4 * d.N;
  const size_t need = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(need < 1024 ? need : 1024);
  tat_prep_kernel<TIn><<<blocks, kThreads, 0, st>>>(
      wqkv, wo, pos, g0, b0, g1, b1, const_cast<bf16*>(w.w), const_cast<bf16*>(w.wlo),
      const_cast<bf16*>(w.wo), const_cast<bf16*>(w.wolo), ws + s.vec, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* v = ws + s.vec;
  const size_t TN = (size_t)d.T * d.N;
  err = launch_rows(TAT_ROWS(tat_qkv_kernel, TIn), kQkv, d, st, x, v, v + TN, v + TN + d.N,
                    w.w, w.wlo, ws + s.qkv, ws + s.te, ws + s.stats, d);
  if (err != cudaSuccess) return err;
  return launch_attn(tat_attn_fwd_kernel<TIn, true>, tat_attn_fwd_kernel<TIn, false>,
                     tat_attn_fwd_chunk_kernel<TIn>, kAttnFwd, d, st, (const float*)(ws + s.qkv),
                     res, scores, out_f32, ws + s.ctx, ws + s.stat);
}

// forward (passes 1-3)
template <typename TIn>
cudaError_t forward16(const TIn* x, const TIn* pos, const TIn* g0, const TIn* b0,
                      const TIn* wqkv, const TIn* wo, const TIn* g1, const TIn* b1,
                      const TIn* res, void* out, void* scores, float* ws, const D16& d,
                      int out_f32, cudaStream_t st) {
  const Space16 s = space16(d, 0);
  cudaError_t err =
      prep_qkv_attn16(x, pos, g0, b0, wqkv, wo, g1, b1, res, scores, out_f32, ws, s, d, st);
  if (err != cudaSuccess) return err;
  const Weights16 w = weights16(ws, s, d);
  const float* v = ws + s.vec;
  const size_t TN = (size_t)d.T * d.N;
  return launch_rows(d.split_out, TAT_SPLIT_ROWS(tat_out_kernel, TIn), kOut, d, st,
                     (const float*)(ws + s.ctx),
                     w.wo, w.wolo, x, (const float*)(ws + s.te), v + TN + 2 * d.N,
                     v + TN + 3 * d.N, out, out_f32, ws + s.gy, d);
}

// backward (passes 1, 2, 4-7)
template <typename TIn>
cudaError_t backward16(const TIn* x, const TIn* pos, const TIn* g0, const TIn* b0,
                       const TIn* wqkv, const TIn* wo, const TIn* g1, const TIn* b1,
                       const TIn* res, const TIn* g_out, const TIn* g_sc, void* dx, void* dres,
                       float* dpos, float* vec4, float* dwqkv, float* dwo, float* ws,
                       const D16& d, int out_f32, cudaStream_t st) {
  const Space16 s = space16(d, 1);
  const int N = d.N;
  float* scratch = ws + s.scratch;
  const float* v = ws + s.vec;
  const size_t TN = (size_t)d.T * N;
  cudaError_t err =
      prep_qkv_attn16(x, pos, g0, b0, wqkv, wo, g1, b1, res, nullptr, out_f32, ws, s, d, st);
  if (err != cudaSuccess) return err;
  const Weights16 w = weights16(ws, s, d);
  err = launch_rows(d.split_ln1, TAT_SPLIT_ROWS(tat_ln1_bwd_kernel, TIn), kLn1Bwd, d, st,
                    (const float*)(ws + s.ctx), w.wo, w.wolo, x, (const float*)(ws + s.te),
                    v + TN + 2 * N, g_out, ws + s.part1, ws + s.gy, ws + s.gctx, d);
  if (err != cudaSuccess) return err;
  err = launch_attn(tat_attn_bwd_kernel<TIn, true>, tat_attn_bwd_kernel<TIn, false>,
                    tat_attn_bwd_chunk_kernel<TIn>, kAttnBwd, d, st, (const float*)(ws + s.qkv),
                    res, (const float*)(ws + s.gctx), (const float*)(ws + s.stat), g_sc, dres,
                    out_f32, ws + s.gqkv);
  if (err != cudaSuccess) return err;
  err = launch_rows(d.split_gte, TAT_SPLIT_ROWS(tat_gte_kernel, TIn), kGte, d, st,
                    (const float*)(ws + s.gqkv),
                    w.w, w.wlo, (const float*)(ws + s.gy), x, v, (const float*)(ws + s.stats),
                    v + TN, dx, out_f32, ws + s.dxf, ws + s.part0, d);
  if (err != cudaSuccess) return err;
  const float* gqkv = ws + s.gqkv;
  err = d.embed ? atb_wmma(ws + s.te, d.Np, gqkv, d.Wp, dwqkv, scratch, d.M, N, d.W, st)
                : atb_wmma(x, N, gqkv, d.Wp, dwqkv, scratch, d.M, N, d.W, st);
  if (err != cudaSuccess) return err;
  err = atb_wmma(ws + s.ctx, d.hvp, ws + s.gy, d.Np, dwo, scratch, d.M, d.hv, N, st);
  if (err != cudaSuccess) return err;
  const int Mp = (d.M + 63) / 64 * 64;
  err = dense::sum_rows(ws + s.part1, vec4, scratch, Mp / launch_rows16(kLn1Bwd, d), 2 * N, st);
  if (err != cudaSuccess) return err;
  if (!d.embed) {
    err = cudaMemsetAsync(vec4 + 2 * N, 0, sizeof(float) * 2 * N, st);
    if (err != cudaSuccess) return err;
    return cudaMemsetAsync(dpos, 0, sizeof(float) * TN, st);
  }
  err = dense::sum_rows(ws + s.part0, vec4 + 2 * N, scratch, Mp / launch_rows16(kGte, d), 2 * N,
                        st);
  if (err != cudaSuccess) return err;
  return dense::sum_rows(ws + s.dxf, dpos, scratch, d.BF, d.T * N, st);
}

}  // namespace

extern "C" {

// Floats of the workspace (backward or forward only); f32 set for float32
// inputs, else bf16.
size_t tat_fused_workspace_floats(int BF, int T, int N, int H, int dk, int dv, int embed,
                                  int backward, int f32) {
  return space16(make_d16(BF, T, N, H, dk, dv, embed, f32), backward).total;
}

// Shared memory a pass's block requests (0 qkv, 1 attention forward, 2
// out-projection + LN1, 3 LN1 backward + g_ctx, 4 attention backward, 5
// g_te), at its most rows (16 where none fit), for float32 (f32 set) or
// bf16 inputs.
size_t tat_fused_smem_bytes(int T, int N, int H, int dk, int dv, int embed, int pass,
                            int f32) {
  if (pass < 0 || pass >= kPasses) return 0;
  return smem16_request(pass, make_d16(1, T, N, H, dk, dv, embed, f32));
}

// Forward (passes 1-3): every input of one dtype, float32 (f32 set) or
// bf16: x (BF,T,N), pos (T,N), the LN vectors (N), wqkv (N,W), wo (H*dv,N),
// res (BF,H,T,T). out and scores are float32 with out_f32, else in the
// inputs' dtype (rounded once). `ws` holds tat_fused_workspace_floats(...,
// 0, f32). Returns cudaGetLastError().
int tat_fused_forward(const void* x, const void* pos, const void* g0, const void* b0,
                      const void* wqkv, const void* wo, const void* g1, const void* b1,
                      const void* res, void* out, void* scores, float* ws, int BF, int T, int N,
                      int H, int dk, int dv, int embed, int f32, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const D16 d = make_d16(BF, T, N, H, dk, dv, embed, f32);
  cudaError_t err;
  if (f32) {
    auto c = [](const void* p) { return static_cast<const float*>(p); };
    err = forward16(c(x), c(pos), c(g0), c(b0), c(wqkv), c(wo), c(g1), c(b1), c(res), out,
                    scores, ws, d, 1, st);
  } else {
    auto c = [](const void* p) { return static_cast<const bf16*>(p); };
    err = forward16(c(x), c(pos), c(g0), c(b0), c(wqkv), c(wo), c(g1), c(b1), c(res), out,
                    scores, ws, d, out_f32, st);
  }
  return static_cast<int>(err);
}

// Backward (passes 1, 2, 4-7): the forward's inputs, g_out and g_sc, all of
// one dtype (float32 with f32 set, else bf16); dx, dres float32 with
// out_f32 (always in float32), else bf16; dpos (T,N) (zero without the
// embedding), vec4 (4,N) = [dg1, db1, dg0, db0], dwqkv (N,W), dwo (H*dv,N)
// float32, every weight gradient summed over all rows in a fixed order.
// `ws` holds tat_fused_workspace_floats(..., 1, f32).
int tat_fused_backward(const void* x, const void* pos, const void* g0, const void* b0,
                       const void* wqkv, const void* wo, const void* g1, const void* b1,
                       const void* res, const void* g_out, const void* g_sc, void* dx,
                       void* dres, float* dpos, float* vec4, float* dwqkv, float* dwo, float* ws,
                       int BF, int T, int N, int H, int dk, int dv, int embed, int f32,
                       int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const D16 d = make_d16(BF, T, N, H, dk, dv, embed, f32);
  cudaError_t err;
  if (f32) {
    auto c = [](const void* p) { return static_cast<const float*>(p); };
    err = backward16(c(x), c(pos), c(g0), c(b0), c(wqkv), c(wo), c(g1), c(b1), c(res), c(g_out),
                     c(g_sc), dx, dres, dpos, vec4, dwqkv, dwo, ws, d, 1, st);
  } else {
    auto c = [](const void* p) { return static_cast<const bf16*>(p); };
    err = backward16(c(x), c(pos), c(g0), c(b0), c(wqkv), c(wo), c(g1), c(b1), c(res), c(g_out),
                     c(g_sc), dx, dres, dpos, vec4, dwqkv, dwo, ws, d, out_f32, st);
  }
  return static_cast<int>(err);
}

const char* tat_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
