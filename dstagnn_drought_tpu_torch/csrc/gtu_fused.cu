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
// bound by them (0.22 ms at 989 TFLOP/s). The design, simple first:
//   forward: one launch, blockIdx.y = the conv; a block stages its conv's
//     taps in shared memory and loops over (b, n) groups, each group's
//     (C, T) slice staged once, and closes the gate before anything leaves
//     the block. No im2col window tensor is ever written.
//   backward: one launch per conv (the three are ordered on the stream). A
//     block loops over its groups: recompute y and form dY in shared memory,
//     add its dx share into a float32 accumulator (the three passes own each
//     (b, n) slice in turn; the last rounds), and add dY x^T into the
//     block's dW/db accumulator. The TPU kernel sums dW and db in a resident
//     output block across its sequential grid; here each block writes its
//     partial and sum_rows (dense_common.cuh) adds the partials in a fixed
//     order: no atomics, two launches give the same bits.
// Float32 runs on the CUDA cores (gtu_fwd_kernel, gtu_bwd_kernel: float32
// FMAs, no TF32, so float32 stays exact). There the forward's thread owns
// one channel c and 8 time steps and keeps p and q in registers; the taps
// are transposed with padded rows (conflict-free reads both ways).
// Bfloat16 runs on the tensor cores (gtu_fwd_wmma_kernel,
// gtu_bwd_wmma_kernel): nvcuda::wmma bf16 16x16x16 fragments with float32
// accumulators, every operand staged in shared memory. The operands are
// already bf16-exact (x, the taps rounded by the wrapper, dY rounded where
// the TPU kernel rounds it), so they form the same products as the CUDA
// cores would; only the order of the sums differs. Per group, with
// T_out = T-K+1:
//   Ws  [kk][o][c] bf16, the conv's taps, rows of C+8
//   Xs  (T+8, C+16) bf16, x time-major, rows >= T zero
//   Yb  (8 + T, 2C+16) bf16, dY at row 8 + t, every other row zero (backward)
//   y  = sum_kk Xs[kk : kk+T] . W_kk^T       (W_kk read as a col-major B)
//   dx = sum_kk Yb[8-kk : 8-kk+T] . W_kk
//   dW_kk += Yb[8 : 8+T]^T . Xs[kk : kk+T]   (dY^T read as a col-major A)
// Both kernels form y the same way (gate_halves): a warp owns (t, c) 16x16
// tiles, two at a time where they share a c tile (C = 16, 32), so one tap
// fragment serves both, and forms p and q from one x fragment. cp.async
// copies the next group's x (and, backward, g rows) into shared memory
// behind the current group's products; x is transposed from that copy.
// The forward gates p and q through the warp's own 2 KB of float32 staging
// (bias added there) and stores 8 channels of one time step a lane, 16
// bytes, straight to out; rows t >= T_out are never stored. The backward
// gates them into dY, later forms the dx tile and adds it to dx_acc through
// the same staging; no block-wide y or dx tile exists. dW stays in
// registers across the block's whole group loop (a warp owns a fixed set of
// (kk, o, c) tiles; at C = 16 and 32 they share one dY^T fragment a time
// step) and is stored once into the block's partial row. db sums dY over t
// on the CUDA cores, each thread a chunk of t of one column, the chunks
// added in order at the end. Fragment traffic through shared memory (2-way
// bank conflicts on the 32-byte-aligned Xs and Yb rows) and latency bound
// them, not the tensor cores: the backward runs two blocks an SM (its dW
// fragments take half the registers), the forward three (no dW: 80
// registers), where its float32 gate (tanhf, expf) also counts. The
// forward's own bound is bytes (x read once per conv, out written once).
// Traps:
//   - load/store_matrix_sync need a 256-bit aligned pointer and an ld that
//     is a multiple of 8 (16-bit types) or 4 (float). The shifted loads at
//     row offset kk are aligned only because every row of Xs and Yb is a
//     multiple of 32 bytes: 16 | C, and their padding is 16 elements. A pad
//     of 8 (80-byte rows) would break every odd kk. Ws is read only at
//     16-row offsets, so its pad of 8 keeps alignment and makes its loads
//     conflict-free; Xs and Yb keep 2-way conflicts.
//   - T_out is never a multiple of 16. The zero rows around dY and below x
//     mask the ragged edge (as the zero tail does in the JAX kernel); no
//     load reads past a tile.
//   - C is a template parameter (16, 32, 48) of both bf16 kernels: the dW
//     fragments are indexed at compile time so they stay in registers. C =
//     48 needs 16 fragments a thread at K = 7 and runs one block an SM.

#include "dense_common.cuh"
#include "wmma_common.cuh"

namespace {

using namespace wm;

using dense::kThreads;
using dense::rnd;

constexpr int kRT = 8;            // time steps a thread
constexpr int kTaps = 15;         // 3 + 5 + 7
constexpr int kMaxGrid = 264;     // blocks (two per SM of an H100)

__host__ __device__ constexpr int conv_k(int ki) { return 3 + 2 * ki; }
__host__ __device__ constexpr int tap_base(int ki) { return ki == 0 ? 0 : (ki == 1 ? 3 : 8); }

struct Dims {
  int BN, C, T, C2, ldw, ldy, M3, L;
};

__device__ __forceinline__ float sigmoid(float q) { return 1.f / (1.f + expf(-q)); }

// the first output position of conv ki in the concatenated time axis
__device__ __forceinline__ int out_offset(int ki, int T) {
  int off = 0;
  for (int j = 0; j < ki; ++j) off += T - conv_k(j) + 1;
  return off;
}

// Ws[(kk*2C + o)*(C+1) + c] = wp[tap_base(ki) + kk][o][c]
template <int K>
__device__ void stage_weights(const float* __restrict__ wp, float* Ws, int ki, const Dims& d) {
  const float* src = wp + (size_t)tap_base(ki) * d.C2 * d.C;
  for (int e = threadIdx.x; e < K * d.C2 * d.C; e += blockDim.x) {
    const int c = e % d.C, row = e / d.C;  // row = kk*2C + o
    Ws[row * d.ldw + c] = src[e];
  }
}

// p and q of the gate halves for channel c at t0..t0+kRT-1 of conv K,
// bias included (xs is the group's (C, T) slice in shared memory)
template <int K>
__device__ __forceinline__ void conv_rows(const float* xs, const float* Ws,
                                          const float* __restrict__ bias, int c, int t0,
                                          float* ap, float* aq, const Dims& d) {
  const float bp = bias[c], bq = bias[d.C + c];
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    ap[r] = bp;
    aq[r] = bq;
  }
  for (int cc = 0; cc < d.C; ++cc) {
    const float* xr = xs + cc * d.T;
    float xw[kRT + K - 1];
#pragma unroll
    for (int j = 0; j < kRT + K - 1; ++j) xw[j] = (t0 + j < d.T) ? xr[t0 + j] : 0.f;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const float wpv = Ws[(kk * d.C2 + c) * d.ldw + cc];
      const float wqv = Ws[(kk * d.C2 + d.C + c) * d.ldw + cc];
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        ap[r] = fmaf(xw[r + kk], wpv, ap[r]);
        aq[r] = fmaf(xw[r + kk], wqv, aq[r]);
      }
    }
  }
}

__device__ __forceinline__ void stage_x(const float* __restrict__ xg, float* xs, const Dims& d) {
  for (int e = threadIdx.x; e < d.C * d.T; e += blockDim.x) xs[e] = xg[e];
}

// ---------------------------------------------------------------------------
// forward, float32, CUDA cores
// ---------------------------------------------------------------------------

template <int K>
__device__ void fwd_conv(const float* __restrict__ x, const float* __restrict__ wp,
                         const float* __restrict__ bias, float* __restrict__ out, int ki,
                         float* sm, const Dims& d) {
  float* Ws = sm;
  float* xs = Ws + K * d.C2 * d.ldw;
  stage_weights<K>(wp, Ws, ki, d);
  const int Tout = d.T - K + 1, off = out_offset(ki, d.T);
  const int items = d.C * ((Tout + kRT - 1) / kRT);
  const float* b = bias + ki * d.C2;
  for (int g = blockIdx.x; g < d.BN; g += gridDim.x) {
    __syncthreads();  // weights staged / the previous group's slice consumed
    stage_x(x + (size_t)g * d.C * d.T, xs, d);
    __syncthreads();
    for (int item = threadIdx.x; item < items; item += blockDim.x) {
      const int c = item % d.C, t0 = (item / d.C) * kRT;
      float ap[kRT], aq[kRT];
      conv_rows<K>(xs, Ws, b, c, t0, ap, aq, d);
      float* og = out + ((size_t)g * d.M3 + off) * d.C + c;
#pragma unroll
      for (int r = 0; r < kRT; ++r)
        if (t0 + r < Tout) og[(size_t)(t0 + r) * d.C] = tanhf(ap[r]) * sigmoid(aq[r]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gtu_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wp,
               const float* __restrict__ bias, float* __restrict__ out, Dims d) {
  extern __shared__ __align__(16) float sm[];
  if (blockIdx.y == 0) fwd_conv<3>(x, wp, bias, out, 0, sm, d);
  else if (blockIdx.y == 1) fwd_conv<5>(x, wp, bias, out, 1, sm, d);
  else fwd_conv<7>(x, wp, bias, out, 2, sm, d);
}

// ---------------------------------------------------------------------------
// backward, float32, CUDA cores, one conv a launch
// ---------------------------------------------------------------------------

// mode: 0 = first conv (dx starts at 0), 1 = middle, 2 = last (write dx)
template <int K>
__global__ void __launch_bounds__(kThreads)
gtu_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gout,
               const float* __restrict__ wp, const float* __restrict__ bias,
               float* __restrict__ dx_acc, float* __restrict__ dx, float* __restrict__ part,
               int ki, int mode, Dims d) {
  extern __shared__ __align__(16) float sm[];
  const int C = d.C, C2 = d.C2, Tt = d.T;
  float* Ws = sm;                       // K*2C*(C+1)
  float* Dw = Ws + K * C2 * d.ldw;      // (kk*C + c)*2C + o
  float* Db = Dw + K * C * C2;          // 2C
  float* xs = Db + C2;                  // (C, T)
  float* Ys = xs + C * Tt;              // dY: (T, 2C+1)
  float* Dx = Ys + Tt * d.ldy;          // (C, T)
  stage_weights<K>(wp, Ws, ki, d);
  for (int e = threadIdx.x; e < K * C * C2 + C2; e += blockDim.x) Dw[e] = 0.f;
  const int Tout = Tt - K + 1, off = out_offset(ki, Tt);
  const float* b = bias + ki * C2;
  const int rec_items = C * ((Tout + kRT - 1) / kRT);
  const int dx_items = C * ((Tt + kRT - 1) / kRT);
  for (int g = blockIdx.x; g < d.BN; g += gridDim.x) {
    __syncthreads();
    const size_t xo = (size_t)g * C * Tt;
    stage_x(x + xo, xs, d);
    for (int e = threadIdx.x; e < C * Tt; e += blockDim.x) Dx[e] = mode ? dx_acc[xo + e] : 0.f;
    __syncthreads();
    // recompute y, then dY
    for (int item = threadIdx.x; item < rec_items; item += blockDim.x) {
      const int c = item % C, t0 = (item / C) * kRT;
      float ap[kRT], aq[kRT];
      conv_rows<K>(xs, Ws, b, c, t0, ap, aq, d);
      const float* gg = gout + ((size_t)g * d.M3 + off) * C + c;
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const int t = t0 + r;
        if (t >= Tout) continue;
        const float gv = gg[(size_t)t * C];
        const float th = tanhf(ap[r]), sg = sigmoid(aq[r]);
        const float dp = gv * sg * (1.f - th * th);
        const float dq = gv * th * sg * (1.f - sg);
        Ys[t * d.ldy + c] = dp;
        Ys[t * d.ldy + C + c] = dq;
      }
    }
    __syncthreads();
    // dx[c][t] += sum_kk sum_o dY[t-kk][o] W[kk][o][c]
    for (int item = threadIdx.x; item < dx_items; item += blockDim.x) {
      const int c = item % C, t0 = (item / C) * kRT;
      float acc[kRT];
#pragma unroll
      for (int r = 0; r < kRT; ++r) acc[r] = 0.f;
      for (int o = 0; o < C2; ++o) {
        float yw[kRT + K - 1];
#pragma unroll
        for (int j = 0; j < kRT + K - 1; ++j) {
          const int s = t0 - (K - 1) + j;
          yw[j] = (s >= 0 && s < Tout) ? Ys[s * d.ldy + o] : 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
          const float w = Ws[(kk * C2 + o) * d.ldw + c];
#pragma unroll
          for (int r = 0; r < kRT; ++r) acc[r] = fmaf(yw[r - kk + K - 1], w, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRT; ++r)
        if (t0 + r < Tt) Dx[c * Tt + t0 + r] += acc[r];
    }
    // dW[kk][o][c] += sum_t dY[t][o] x[c][t+kk]; db[o] += sum_t dY[t][o]
    for (int item = threadIdx.x; item < C2 * C; item += blockDim.x) {
      const int o = item % C2, c = item / C2;
      const float* xr = xs + c * Tt;
      float acc[K], xw[K];
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        acc[kk] = 0.f;
        xw[kk] = xr[kk];
      }
      for (int t = 0; t < Tout; ++t) {
        const float y = Ys[t * d.ldy + o];
#pragma unroll
        for (int kk = 0; kk < K; ++kk) acc[kk] = fmaf(y, xw[kk], acc[kk]);
#pragma unroll
        for (int kk = 0; kk < K - 1; ++kk) xw[kk] = xw[kk + 1];
        xw[K - 1] = (t + K < Tt) ? xr[t + K] : 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < K; ++kk) Dw[(kk * C + c) * C2 + o] += acc[kk];
    }
    for (int o = threadIdx.x; o < C2; o += blockDim.x) {
      float s = 0.f;
      for (int t = 0; t < Tout; ++t) s += Ys[t * d.ldy + o];
      Db[o] += s;
    }
    __syncthreads();
    if (mode == 2) {
      for (int e = threadIdx.x; e < C * Tt; e += blockDim.x) dx[xo + e] = Dx[e];
    } else {
      for (int e = threadIdx.x; e < C * Tt; e += blockDim.x) dx_acc[xo + e] = Dx[e];
    }
  }
  __syncthreads();
  // this block's partial: row blockIdx.x of part, [dW (15, 2C, C) | db (3, 2C)]
  float* row = part + (size_t)blockIdx.x * d.L;
  float* dw_out = row + (size_t)tap_base(ki) * C2 * C;
  for (int e = threadIdx.x; e < K * C2 * C; e += blockDim.x) {
    const int c = e % C, o = (e / C) % C2, kk = e / (C * C2);
    dw_out[e] = Dw[(kk * C + c) * C2 + o];
  }
  for (int o = threadIdx.x; o < C2; o += blockDim.x) row[kTaps * C2 * C + ki * C2 + o] = Db[o];
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores (WMMA): tiles and pieces both kernels share
// ---------------------------------------------------------------------------

constexpr int kZ = 8;     // zero rows above dY in Yb (>= K - 1); also rows past T
constexpr int kPad = 16;  // row padding of Xs and Yb (elements)
constexpr int kPadW = 8;  // row padding of Ws: read only at 16-row offsets

template <int K, int C>
struct Wm {
  static constexpr int C2 = 2 * C;
  static constexpr int LW = C + kPadW, LX = C + kPad, LY = C2 + kPad;  // row lengths
  static constexpr int CT = C / 16, OT = C2 / 16;  // 16-wide tiles of c and of o
  static constexpr int P = OT * CT;                // (o, c) tile pairs of one tap
  static constexpr int kTiles = K * P;             // dW tiles of the conv
  static constexpr int NF = (kTiles + dense::kWarps - 1) / dense::kWarps;  // dW tiles a warp
  static constexpr bool kFixedPair = dense::kWarps % P == 0;  // a warp's share one pair
  static constexpr int NT = dense::kWarps % CT == 0 ? 2 : 1;  // (t, c) tiles a pass
  static constexpr int kMinBlocks = NF <= 8 ? 2 : 1;  // 8 fragments: 64 registers
  // db runs on the threads from kDbFirst on: warps 0 and 1 hold the extra (t, c) tiles
  static constexpr int kDbFirst = 64;
  static constexpr int kDbParts = (kThreads - kDbFirst) / C2;  // threads summing a column
};

__device__ __forceinline__ void unpack8(const float* s, float* v) {
  const float4 a = reinterpret_cast<const float4*>(s)[0], b = reinterpret_cast<const float4*>(s)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// the conv's taps to shared memory in bf16: Ws[kk][o][c], rows of C + 8
template <int K, int C>
__device__ __forceinline__ void stage_taps(const float* __restrict__ wp, bf16* Ws, int ki) {
  const float* src = wp + (size_t)tap_base(ki) * 2 * C * C;
  for (int e = threadIdx.x; e < K * 2 * C * C; e += blockDim.x)
    Ws[(e / C) * Wm<K, C>::LW + e % C] = __float2bfloat16_rn(src[e]);
}

// a group's x as copied, (C, T), to Xs time-major: a thread takes 8 time
// steps of one channel (16 bytes); neighbouring threads take neighbouring
// channels (conflict-free stores)
template <int C>
__device__ __forceinline__ void transpose_x(const bf16* Xr, bf16* Xs, int Tt) {
  constexpr int LX = C + kPad;
  for (int e = threadIdx.x; e < C * Tt / 8; e += blockDim.x) {
    const int c = e % C, t0 = (e / C) * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(Xr + c * Tt + t0);
    const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) Xs[(t0 + j) * LX + c] = h[j];
  }
}

// y's gate halves p and q, bias left out, of the NT (t, c) tiles tile0 +
// i * kWarps: sum_kk Xs[16 tt + kk : +16] . W_kk^T (W_kk read as a
// col-major B). The tiles share one c tile, so one tap fragment serves them
// all, and one x fragment serves p and q. on[i]: tile i exists; tt[i]: its
// 16-row time tile.
template <int K, int C>
__device__ __forceinline__ void gate_halves(const bf16* Xs, const bf16* Ws, int tile0, int TT,
                                            int* tt, bool* on, FragC* p, FragC* q) {
  using S = Wm<K, C>;
  constexpr int C2 = S::C2, LW = S::LW, LX = S::LX, CT = S::CT;
  const int ct = tile0 % CT;
#pragma unroll
  for (int i = 0; i < S::NT; ++i) {
    const int tile = tile0 + i * dense::kWarps;
    on[i] = tile < TT * CT;
    tt[i] = tile / CT;
    wmma::fill_fragment(p[i], 0.f);
    wmma::fill_fragment(q[i], 0.f);
  }
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
#pragma unroll
    for (int cs = 0; cs < CT; ++cs) {
      FragA a[S::NT];
      FragBt w;
#pragma unroll
      for (int i = 0; i < S::NT; ++i)
        if (on[i]) wmma::load_matrix_sync(a[i], Xs + (16 * tt[i] + kk) * LX + 16 * cs, LX);
      wmma::load_matrix_sync(w, Ws + (kk * C2 + 16 * ct) * LW + 16 * cs, LW);
#pragma unroll
      for (int i = 0; i < S::NT; ++i)
        if (on[i]) wmma::mma_sync(p[i], a[i], w, p[i]);
      wmma::load_matrix_sync(w, Ws + (kk * C2 + C + 16 * ct) * LW + 16 * cs, LW);
#pragma unroll
      for (int i = 0; i < S::NT; ++i)
        if (on[i]) wmma::mma_sync(q[i], a[i], w, q[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// forward, bfloat16, tensor cores (WMMA), blockIdx.y = the conv
// ---------------------------------------------------------------------------

// one group's output of conv K: per (t, c) tile, p and q, then the gate
// through the warp's staging st (bias Bs added there), 8 channels of one
// time step a lane, stored 16 bytes at a time to og[t][c]; rows t >= T_out
// are never stored
template <int K, int C>
__device__ __forceinline__ void fwd_tiles(const bf16* Xs, const bf16* Ws, const float* Bs,
                                          bf16* __restrict__ og, int Tout, int TT, float* st) {
  using S = Wm<K, C>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // a lane's 8 elements of a 16x16 tile: row lane / 2, columns 8 * (lane % 2) ..
  const int lr = lane / 2, lc = 8 * (lane % 2);
  for (int tile0 = warp; tile0 < TT * S::CT; tile0 += S::NT * dense::kWarps) {
    const int c0 = 16 * (tile0 % S::CT) + lc;
    int tt[S::NT];
    bool on[S::NT];
    FragC p[S::NT], q[S::NT];
    gate_halves<K, C>(Xs, Ws, tile0, TT, tt, on, p, q);
#pragma unroll
    for (int i = 0; i < S::NT; ++i) {
      if (!on[i]) continue;
      wmma::store_matrix_sync(st, p[i], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(st + 256, q[i], 16, wmma::mem_row_major);
      __syncwarp();
      const int t = 16 * tt[i] + lr;
      if (t < Tout) {
        float pv[8], qv[8], v[8];
        unpack8(st + lr * 16 + lc, pv);
        unpack8(st + 256 + lr * 16 + lc, qv);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = tanhf(pv[j] + Bs[c0 + j]) * sigmoid(qv[j] + Bs[C + c0 + j]);
        *reinterpret_cast<uint4*>(og + (size_t)t * C + c0) = pack8(v);
      }
      __syncwarp();  // the staging is read before it is overwritten
    }
  }
}

template <int K, int C>
__device__ __forceinline__ void fwd_wmma_conv(const bf16* __restrict__ x,
                                              const float* __restrict__ wp,
                                              const float* __restrict__ bias,
                                              bf16* __restrict__ out, int ki,
                                              unsigned char* smem, const Dims& d) {
  using S = Wm<K, C>;
  constexpr int C2 = S::C2, LW = S::LW, LX = S::LX;
  const int Tt = d.T, R = Tt + kZ, TT = Tt / 16;
  bf16* Ws = reinterpret_cast<bf16*>(smem);  // taps [kk][o][c]
  bf16* Xs = Ws + K * C2 * LW;               // x (T + 8, C), time-major
  bf16* Xr = Xs + (size_t)R * LX;            // a group's x (C, T), as copied
  float* St = reinterpret_cast<float*>(Xr + (size_t)C * Tt);  // two 16x16 tiles a warp
  float* Bs = St + dense::kWarps * 512;      // the conv's bias
  float* st = St + (threadIdx.x / 32) * 512;
  const bf16 zero = __float2bfloat16_rn(0.f);

  stage_taps<K, C>(wp, Ws, ki);
  for (int e = threadIdx.x; e < R * LX; e += blockDim.x) Xs[e] = zero;
  for (int o = threadIdx.x; o < C2; o += blockDim.x) Bs[o] = bias[ki * C2 + o];
  const int off = out_offset(ki, Tt);

  // each later group's x is copied while the group before it computes
  copy_async(Xr, x + (size_t)blockIdx.x * C * Tt, C * Tt);
  for (int g = blockIdx.x; g < d.BN; g += gridDim.x) {
    wait_async();
    __syncthreads();  // x copied / the previous group's tiles consumed
    transpose_x<C>(Xr, Xs, Tt);
    __syncthreads();
    const int gn = g + gridDim.x;
    if (gn < d.BN) copy_async(Xr, x + (size_t)gn * C * Tt, C * Tt);
    fwd_tiles<K, C>(Xs, Ws, Bs, out + ((size_t)g * d.M3 + off) * C, Tt - K + 1, TT, st);
  }
}

// the longest conv on blockIdx.y = 0: its blocks are dispatched first.
// Three blocks an SM at C <= 32 (76,288 bytes of shared memory at C = 32,
// T = 144, and at most 80 registers a thread); C = 48 runs one, for its
// shared memory
template <int C>
__global__ void __launch_bounds__(kThreads, 3)
gtu_fwd_wmma_kernel(const bf16* __restrict__ x, const float* __restrict__ wp,
                    const float* __restrict__ bias, bf16* __restrict__ out, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (blockIdx.y == 0) fwd_wmma_conv<7, C>(x, wp, bias, out, 2, smem, d);
  else if (blockIdx.y == 1) fwd_wmma_conv<5, C>(x, wp, bias, out, 1, smem, d);
  else fwd_wmma_conv<3, C>(x, wp, bias, out, 0, smem, d);
}

// ---------------------------------------------------------------------------
// backward, bfloat16, tensor cores (WMMA), one conv a launch
// ---------------------------------------------------------------------------

// mode: 0 = first conv (dx starts at 0), 1 = middle, 2 = last (round dx)
template <int K, int C>
__global__ void __launch_bounds__(kThreads, Wm<K, C>::kMinBlocks)
gtu_bwd_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gout,
                    const float* __restrict__ wp, const float* __restrict__ bias,
                    float* __restrict__ dx_acc, bf16* __restrict__ dx,
                    float* __restrict__ part, int ki, int mode, Dims d) {
  using S = Wm<K, C>;
  constexpr int C2 = S::C2, LW = S::LW, LX = S::LX, LY = S::LY, CT = S::CT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Tt = d.T, R = Tt + kZ, TT = Tt / 16;
  bf16* Ws = reinterpret_cast<bf16*>(smem);  // taps [kk][o][c]
  bf16* Xs = Ws + K * C2 * LW;               // x (T + 8, C), time-major
  bf16* Yb = Xs + (size_t)R * LX;            // dY[t] at row kZ + t
  bf16* Xr = Yb + (size_t)R * LY;            // a group's x (C, T), as copied
  bf16* Gs = Xr + (size_t)C * Tt;            // a group's g rows of this conv (T_out, C)
  float* St = reinterpret_cast<float*>(Gs + (size_t)C * Tt);  // two 16x16 tiles a warp
  float* Bs = St + dense::kWarps * 512;      // the conv's bias
  float* Dp = Bs + C2;                       // db partial sums, one a thread
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = St + warp * 512;
  const bf16 zero = __float2bfloat16_rn(0.f);

  stage_taps<K, C>(wp, Ws, ki);
  for (int e = threadIdx.x; e < R * LX; e += blockDim.x) Xs[e] = zero;
  for (int e = threadIdx.x; e < R * LY; e += blockDim.x) Yb[e] = zero;
  for (int o = threadIdx.x; o < C2; o += blockDim.x) Bs[o] = bias[ki * C2 + o];
  FragC dw[S::NF];
#pragma unroll
  for (int f = 0; f < S::NF; ++f) wmma::fill_fragment(dw[f], 0.f);

  const int Tout = Tt - K + 1, off = out_offset(ki, Tt);
  // db: thread (part, o) sums its chunk of t of column o over every group
  const int db_o = (threadIdx.x - S::kDbFirst) % C2;
  const int db_part = threadIdx.x < S::kDbFirst ? S::kDbParts : (threadIdx.x - S::kDbFirst) / C2;
  const int db_chunk = (Tout + S::kDbParts - 1) / S::kDbParts;
  const int db_t0 = db_part * db_chunk, db_t1 = min(Tout, db_t0 + db_chunk);
  float db = 0.f;
  // a lane's 8 elements of a 16x16 tile: row lane / 2, columns 8 * (lane % 2) ..
  const int lr = lane / 2, lc = 8 * (lane % 2);

  // the first group's x and g; each later group's are copied while the
  // group before it computes
  copy_async(Xr, x + (size_t)blockIdx.x * C * Tt, C * Tt);
  copy_async(Gs, gout + ((size_t)blockIdx.x * d.M3 + off) * C, Tout * C);
  for (int g = blockIdx.x; g < d.BN; g += gridDim.x) {
    wait_async();
    __syncthreads();  // x and g copied / the previous group's tiles consumed
    const size_t xo = (size_t)g * C * Tt;
    const int gn = g + gridDim.x;
    transpose_x<C>(Xr, Xs, Tt);
    __syncthreads();
    if (gn < d.BN) copy_async(Xr, x + (size_t)gn * C * Tt, C * Tt);
    // 1-2. per (t, c) tile: y's p and q halves, then dY through the warp's
    // staging, rounded where the TPU kernel rounds; NT tiles a time
    for (int tile0 = warp; tile0 < TT * CT; tile0 += S::NT * dense::kWarps) {
      const int c0 = 16 * (tile0 % CT) + lc;
      int tt[S::NT];
      bool on[S::NT];
      FragC p[S::NT], q[S::NT];
      gate_halves<K, C>(Xs, Ws, tile0, TT, tt, on, p, q);
#pragma unroll
      for (int i = 0; i < S::NT; ++i) {
        if (!on[i]) continue;
        wmma::store_matrix_sync(st, p[i], 16, wmma::mem_row_major);
        wmma::store_matrix_sync(st + 256, q[i], 16, wmma::mem_row_major);
        __syncwarp();
        const int t = 16 * tt[i] + lr;
        if (t < Tout) {
          const uint4 gv = *reinterpret_cast<const uint4*>(Gs + t * C + c0);
          float pv[8], qv[8], dp[8], dq[8];
          unpack8(st + lr * 16 + lc, pv);
          unpack8(st + 256 + lr * 16 + lc, qv);
          const bf16* gh = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float gf = __bfloat162float(gh[j]);
            const float th = rnd(tanhf(pv[j] + Bs[c0 + j]), 1);
            const float sg = rnd(sigmoid(qv[j] + Bs[C + c0 + j]), 1);
            dp[j] = rnd(rnd(gf * sg, 1) * rnd(1.f - rnd(th * th, 1), 1), 1);
            dq[j] = rnd(rnd(rnd(gf * th, 1) * sg, 1) * rnd(1.f - sg, 1), 1);
          }
          *reinterpret_cast<uint4*>(Yb + (kZ + t) * LY + c0) = pack8(dp);
          *reinterpret_cast<uint4*>(Yb + (kZ + t) * LY + C + c0) = pack8(dq);
        }
        __syncwarp();  // the staging is read before it is overwritten
      }
    }
    __syncthreads();  // dY complete, g consumed
    if (gn < d.BN) copy_async(Gs, gout + ((size_t)gn * d.M3 + off) * C, Tout * C);
    if (db_part < S::kDbParts)
      for (int t = db_t0; t < db_t1; ++t) db += __bfloat162float(Yb[(kZ + t) * LY + db_o]);
    // 3. dx (T, C) = sum_kk dY[t - kk] . W_kk per (t, c) tile, NT tiles a
    // time as above, added to the earlier convs' share through the warp's
    // staging (the last conv rounds)
    for (int tile0 = warp; tile0 < TT * CT; tile0 += S::NT * dense::kWarps) {
      const int ct = tile0 % CT, c = 16 * ct + lr;
      int tt[S::NT];
      bool on[S::NT];
      FragC acc[S::NT];
#pragma unroll
      for (int i = 0; i < S::NT; ++i) {
        const int tile = tile0 + i * dense::kWarps;
        on[i] = tile < TT * CT;
        tt[i] = tile / CT;
        wmma::fill_fragment(acc[i], 0.f);
      }
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
#pragma unroll
        for (int os = 0; os < S::OT; ++os) {
          FragB w;
          wmma::load_matrix_sync(w, Ws + (kk * C2 + 16 * os) * LW + 16 * ct, LW);
#pragma unroll
          for (int i = 0; i < S::NT; ++i) {
            if (!on[i]) continue;
            FragA a;
            wmma::load_matrix_sync(a, Yb + (16 * tt[i] + kZ - kk) * LY + 16 * os, LY);
            wmma::mma_sync(acc[i], a, w, acc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < S::NT; ++i) {
        if (!on[i]) continue;
        wmma::store_matrix_sync(st, acc[i], 16, wmma::mem_col_major);  // st[c][t]
        __syncwarp();
        float v[8];
        unpack8(st + lr * 16 + lc, v);
        const size_t at = xo + (size_t)c * Tt + 16 * tt[i] + lc;
        if (mode) {
          float prev[8];
          unpack8(dx_acc + at, prev);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] += prev[j];
        }
        if (mode == 2) {
          *reinterpret_cast<uint4*>(dx + at) = pack8(v);
        } else {
          reinterpret_cast<float4*>(dx_acc + at)[0] = make_float4(v[0], v[1], v[2], v[3]);
          reinterpret_cast<float4*>(dx_acc + at)[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
        __syncwarp();
      }
    }
    // 4. dW_kk += dY^T . Xs[kk : kk+T], a warp's tiles in its registers
    for (int s = 0; s < TT; ++s) {
      FragAt a;
      if constexpr (S::kFixedPair)  // every tile of this warp has o-tile (warp % P) / CT
        wmma::load_matrix_sync(a, Yb + (kZ + 16 * s) * LY + 16 * ((warp % S::P) / CT), LY);
#pragma unroll
      for (int f = 0; f < S::NF; ++f) {
        const int tile = warp + dense::kWarps * f;
        if (tile >= S::kTiles) continue;
        const int kk = tile / S::P, ot = (tile % S::P) / CT, ct = tile % CT;
        if constexpr (!S::kFixedPair)
          wmma::load_matrix_sync(a, Yb + (kZ + 16 * s) * LY + 16 * ot, LY);
        FragB xb;
        wmma::load_matrix_sync(xb, Xs + (16 * s + kk) * LX + 16 * ct, LX);
        wmma::mma_sync(dw[f], a, xb, dw[f]);
      }
    }
  }
  if (db_part < S::kDbParts) Dp[db_part * C2 + db_o] = db;
  __syncthreads();
  // this block's partial: row blockIdx.x of part, [dW (15, 2C, C) | db (3, 2C)]
  float* row = part + (size_t)blockIdx.x * d.L;
#pragma unroll
  for (int f = 0; f < S::NF; ++f) {
    const int tile = warp + dense::kWarps * f;
    if (tile >= S::kTiles) continue;
    const int kk = tile / S::P, ot = (tile % S::P) / CT, ct = tile % CT;
    wmma::store_matrix_sync(row + ((size_t)(tap_base(ki) + kk) * C2 + 16 * ot) * C + 16 * ct,
                            dw[f], C, wmma::mem_row_major);
  }
  for (int o = threadIdx.x; o < C2; o += blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < S::kDbParts; ++p) s += Dp[p * C2 + o];
    row[kTaps * C2 * C + ki * C2 + o] = s;
  }
}

// ---------------------------------------------------------------------------

Dims make_dims(int BN, int C, int T) {
  Dims d;
  d.BN = BN;
  d.C = C;
  d.T = T;
  d.C2 = 2 * C;
  d.ldw = C + 1;
  d.ldy = 2 * C + 1;
  d.M3 = 3 * T - 12;
  d.L = kTaps * 2 * C * C + 3 * 2 * C;
  return d;
}

int grid_blocks(int BN) { return BN < kMaxGrid ? BN : kMaxGrid; }

size_t fwd_smem(int K, const Dims& d) {
  return sizeof(float) * ((size_t)K * d.C2 * d.ldw + (size_t)d.C * d.T);
}

size_t bwd_smem(int K, const Dims& d) {
  return sizeof(float) * ((size_t)K * d.C2 * d.ldw + (size_t)K * d.C * d.C2 + d.C2 +
                          2 * (size_t)d.C * d.T + (size_t)d.T * d.ldy);
}

// the bf16 backward: in bf16 the taps, Xs and Yb (T + 8 rows), rows padded,
// and the copied x and g; in f32 the warps' staging, the bias and the db
// partials
size_t bwd_wmma_smem(int K, const Dims& d) {
  const size_t R = d.T + kZ;
  return sizeof(bf16) * ((size_t)K * d.C2 * (d.C + kPadW) + R * (d.C + kPad) +
                         R * (d.C2 + kPad) + 2 * (size_t)d.C * d.T) +
         sizeof(float) * ((size_t)dense::kWarps * 512 + d.C2 + kThreads);
}

// the bf16 forward, sized for its k = 7 blocks: in bf16 the taps, Xs (T + 8
// rows), rows padded, and the copied x; in f32 the warps' staging and the
// bias
size_t fwd_wmma_smem(const Dims& d) {
  const size_t R = d.T + kZ;
  return sizeof(bf16) * ((size_t)7 * d.C2 * (d.C + kPadW) + R * (d.C + kPad) +
                         (size_t)d.C * d.T) +
         sizeof(float) * ((size_t)dense::kWarps * 512 + d.C2);
}

// workspace of the backward (floats): the partials, sum_rows' scratch, dx_acc
struct BwdSpace {
  size_t part, scratch, dx_acc, total;
};

BwdSpace bwd_space(const Dims& d) {
  const int S = grid_blocks(d.BN);
  BwdSpace s;
  s.part = 0;
  s.scratch = (size_t)S * d.L;
  s.dx_acc = s.scratch + dense::sum_rows_scratch(S, d.L);
  s.total = s.dx_acc + (size_t)d.BN * d.C * d.T;
  return s;
}

int forward_f32(const void* x, const float* wp, const float* bp, void* out, const Dims& d,
                cudaStream_t st) {
  const size_t smem = fwd_smem(7, d);
  cudaError_t err = dense::allow_smem(gtu_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gtu_fwd_kernel<<<dim3(grid_blocks(d.BN), 3), kThreads, smem, st>>>(
      static_cast<const float*>(x), wp, bp, static_cast<float*>(out), d);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int forward_wmma(const void* x, const float* wp, const float* bp, void* out, const Dims& d,
                 cudaStream_t st) {
  const size_t smem = fwd_wmma_smem(d);
  cudaError_t err = dense::allow_smem(gtu_fwd_wmma_kernel<C>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gtu_fwd_wmma_kernel<C><<<dim3(grid_blocks(d.BN), 3), kThreads, smem, st>>>(
      static_cast<const bf16*>(x), wp, bp, static_cast<bf16*>(out), d);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
cudaError_t launch_bwd(const void* x, const void* g, const float* wp, const float* bp,
                       void* dx, float* ws, const BwdSpace& s, int ki, const Dims& d,
                       cudaStream_t st) {
  const size_t smem = bwd_smem(K, d);
  cudaError_t err = dense::allow_smem(gtu_bwd_kernel<K>, smem);
  if (err != cudaSuccess) return err;
  // the convs run in order 0, 1, 2, so conv ki's dx mode is ki
  gtu_bwd_kernel<K><<<grid_blocks(d.BN), kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), wp, bp, ws + s.dx_acc,
      static_cast<float*>(dx), ws + s.part, ki, ki, d);
  return cudaGetLastError();
}

template <int K, int C>
cudaError_t launch_bwd_wmma(const void* x, const void* g, const float* wp, const float* bp,
                            void* dx, float* ws, const BwdSpace& s, int ki, const Dims& d,
                            cudaStream_t st) {
  const size_t smem = bwd_wmma_smem(K, d);
  cudaError_t err = dense::allow_smem(gtu_bwd_wmma_kernel<K, C>, smem);
  if (err != cudaSuccess) return err;
  gtu_bwd_wmma_kernel<K, C><<<grid_blocks(d.BN), kThreads, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), wp, bp, ws + s.dx_acc,
      static_cast<bf16*>(dx), ws + s.part, ki, ki, d);
  return cudaGetLastError();
}

// conv ki of the backward: float32 on the CUDA cores, bfloat16 (C > 0, the
// instantiated channel count) on the tensor cores
template <int K, int C>
cudaError_t launch_conv(const void* x, const void* g, const float* wp, const float* bp,
                        void* dx, float* ws, const BwdSpace& s, int ki, const Dims& d,
                        cudaStream_t st) {
  if constexpr (C > 0) return launch_bwd_wmma<K, C>(x, g, wp, bp, dx, ws, s, ki, d, st);
  else return launch_bwd<K>(x, g, wp, bp, dx, ws, s, ki, d, st);
}

// the three convs in order (conv ki's dx mode is ki), then the partials'
// fixed-order sum
template <int C>
int backward_impl(const void* x, const void* g, const float* wp, const float* bp, void* dx,
                  float* dwb, float* ws, const Dims& d, cudaStream_t st) {
  const BwdSpace s = bwd_space(d);
  cudaError_t err = launch_conv<3, C>(x, g, wp, bp, dx, ws, s, 0, d, st);
  if (err == cudaSuccess) err = launch_conv<5, C>(x, g, wp, bp, dx, ws, s, 1, d, st);
  if (err == cudaSuccess) err = launch_conv<7, C>(x, g, wp, bp, dx, ws, s, 2, d, st);
  if (err == cudaSuccess)
    err = dense::sum_rows(ws + s.part, dwb, ws + s.scratch, grid_blocks(d.BN), d.L, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Floats of the backward's workspace.
size_t gtu_fused_workspace_floats(int BN, int C, int T) {
  return bwd_space(make_dims(BN, C, T)).total;
}

// Forward: x (BN, C, T) and out (BN, 3T-12, C) in float32 (bf16 = 0, the
// CUDA cores) or bfloat16 (bf16 = 1, the tensor cores); wp (15, 2C, C), bp
// (3, 2C) float32. bfloat16 takes C in {16, 32, 48} and 16-byte aligned x;
// another C returns cudaErrorInvalidValue. Returns cudaGetLastError().
int gtu_fused_forward(const void* x, const float* wp, const float* bp, void* out, int BN,
                      int C, int T, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d = make_dims(BN, C, T);
  if (!bf16) return forward_f32(x, wp, bp, out, d, st);
  switch (C) {
    case 16: return forward_wmma<16>(x, wp, bp, out, d, st);
    case 32: return forward_wmma<32>(x, wp, bp, out, d, st);
    case 48: return forward_wmma<48>(x, wp, bp, out, d, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Backward: g (BN, 3T-12, C) → dx (BN, C, T) in the dtype of x, and dwb =
// [dW (15, 2C, C) | db (3, 2C)] float32, summed over every group in a fixed
// order. `ws` holds gtu_fused_workspace_floats floats. bfloat16 takes C in
// {16, 32, 48} and 16-byte aligned x; another C returns
// cudaErrorInvalidValue.
int gtu_fused_backward(const void* x, const void* g, const float* wp, const float* bp,
                       void* dx, float* dwb, float* ws, int BN, int C, int T, int bf16,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d = make_dims(BN, C, T);
  if (!bf16) return backward_impl<0>(x, g, wp, bp, dx, dwb, ws, d, st);
  switch (C) {
    case 16: return backward_impl<16>(x, g, wp, bp, dx, dwb, ws, d, st);
    case 32: return backward_impl<32>(x, g, wp, bp, dx, dwb, ws, d, st);
    case 48: return backward_impl<48>(x, g, wp, bp, dx, dwb, ws, d, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory (bytes) of the conv-7 block of each kernel: 0 the
// float32 forward, 1 the float32 backward, 2 the bfloat16 backward, 3 the
// bfloat16 forward.
size_t gtu_fused_smem_bytes(int C, int T, int kernel) {
  const Dims d = make_dims(1, C, T);
  switch (kernel) {
    case 0: return fwd_smem(7, d);
    case 1: return bwd_smem(7, d);
    case 2: return bwd_wmma_smem(7, d);
    default: return fwd_wmma_smem(d);
  }
}

const char* gtu_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
