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
//     taps in shared memory (transposed, padded rows: conflict-free reads
//     both ways) and loops over (b, n) groups, each group's (C, T) slice
//     staged once; a thread owns one channel c and 8 time steps, keeps p and
//     q of both gate halves in registers, so the gate closes in registers.
//     No im2col window tensor is ever written.
//   backward: one launch per conv (the three are ordered on the stream). A
//     block loops over its groups: recompute y and form dY in shared memory,
//     add its dx share into a float32 accumulator (the three passes own each
//     (b, n) slice in turn; the last rounds), and add dY x^T into the
//     block's dW/db accumulator in shared memory. The TPU kernel sums dW and
//     db in a resident output block across its sequential grid; here each
//     block writes its partial and sum_rows (dense_common.cuh) adds the
//     partials in a fixed order: no atomics, two launches give the same bits.
// All products are float32 FMAs on the CUDA cores; tensor cores (mma.sync
// or wgmma on the bf16 operands) and TMA are left for a later change.

#include "dense_common.cuh"

namespace {

using dense::kThreads;
using dense::rnd;

constexpr int kRT = 8;            // time steps a thread
constexpr int kTaps = 15;         // 3 + 5 + 7
constexpr int kMaxGrid = 264;     // blocks (two per SM of an H100)

__host__ __device__ constexpr int conv_k(int ki) { return 3 + 2 * ki; }
__host__ __device__ constexpr int tap_base(int ki) { return ki == 0 ? 0 : (ki == 1 ? 3 : 8); }

struct Dims {
  int BN, C, T, C2, ldw, ldy, M3, L, bf16;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
template <typename T> __device__ __forceinline__ T cast_to(float v);
template <> __device__ __forceinline__ float cast_to<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 cast_to<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

template <typename T>
__device__ __forceinline__ void stage_x(const T* __restrict__ xg, float* xs, const Dims& d) {
  for (int e = threadIdx.x; e < d.C * d.T; e += blockDim.x) xs[e] = ld(xg + e);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int K, typename T>
__device__ void fwd_conv(const T* __restrict__ x, const float* __restrict__ wp,
                         const float* __restrict__ bias, T* __restrict__ out, int ki,
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
      T* og = out + ((size_t)g * d.M3 + off) * d.C + c;
#pragma unroll
      for (int r = 0; r < kRT; ++r)
        if (t0 + r < Tout) og[(size_t)(t0 + r) * d.C] = cast_to<T>(tanhf(ap[r]) * sigmoid(aq[r]));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gtu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ wp,
               const float* __restrict__ bias, T* __restrict__ out, Dims d) {
  extern __shared__ __align__(16) float sm[];
  if (blockIdx.y == 0) fwd_conv<3, T>(x, wp, bias, out, 0, sm, d);
  else if (blockIdx.y == 1) fwd_conv<5, T>(x, wp, bias, out, 1, sm, d);
  else fwd_conv<7, T>(x, wp, bias, out, 2, sm, d);
}

// ---------------------------------------------------------------------------
// backward, one conv a launch
// ---------------------------------------------------------------------------

// mode: 0 = first conv (dx starts at 0), 1 = middle, 2 = last (round dx)
template <int K, typename T>
__global__ void __launch_bounds__(kThreads)
gtu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gout, const float* __restrict__ wp,
               const float* __restrict__ bias, float* __restrict__ dx_acc, T* __restrict__ dx,
               float* __restrict__ part, int ki, int mode, Dims d) {
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
  const int bf = d.bf16;
  for (int g = blockIdx.x; g < d.BN; g += gridDim.x) {
    __syncthreads();
    const size_t xo = (size_t)g * C * Tt;
    stage_x(x + xo, xs, d);
    for (int e = threadIdx.x; e < C * Tt; e += blockDim.x) Dx[e] = mode ? dx_acc[xo + e] : 0.f;
    __syncthreads();
    // recompute y, then dY (rounded where the TPU kernel rounds)
    for (int item = threadIdx.x; item < rec_items; item += blockDim.x) {
      const int c = item % C, t0 = (item / C) * kRT;
      float ap[kRT], aq[kRT];
      conv_rows<K>(xs, Ws, b, c, t0, ap, aq, d);
      const T* gg = gout + ((size_t)g * d.M3 + off) * C + c;
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const int t = t0 + r;
        if (t >= Tout) continue;
        const float gv = ld(gg + (size_t)t * C);
        const float th = rnd(tanhf(ap[r]), bf), sg = rnd(sigmoid(aq[r]), bf);
        const float dp = rnd(rnd(gv * sg, bf) * rnd(1.f - rnd(th * th, bf), bf), bf);
        const float dq = rnd(rnd(rnd(gv * th, bf) * sg, bf) * rnd(1.f - sg, bf), bf);
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
      for (int e = threadIdx.x; e < C * Tt; e += blockDim.x) dx[xo + e] = cast_to<T>(Dx[e]);
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

Dims make_dims(int BN, int C, int T, int bf16) {
  Dims d;
  d.BN = BN;
  d.C = C;
  d.T = T;
  d.C2 = 2 * C;
  d.ldw = C + 1;
  d.ldy = 2 * C + 1;
  d.M3 = 3 * T - 12;
  d.L = kTaps * 2 * C * C + 3 * 2 * C;
  d.bf16 = bf16;
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

template <typename T>
int forward_impl(const void* x, const float* wp, const float* bp, void* out, const Dims& d,
                 cudaStream_t st) {
  const size_t smem = fwd_smem(7, d);
  cudaError_t err = dense::allow_smem(gtu_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gtu_fwd_kernel<T><<<dim3(grid_blocks(d.BN), 3), kThreads, smem, st>>>(
      static_cast<const T*>(x), wp, bp, static_cast<T*>(out), d);
  return static_cast<int>(cudaGetLastError());
}

template <int K, typename T>
cudaError_t launch_bwd(const void* x, const void* g, const float* wp, const float* bp,
                       void* dx, float* ws, const BwdSpace& s, int ki, const Dims& d,
                       cudaStream_t st) {
  const size_t smem = bwd_smem(K, d);
  cudaError_t err = dense::allow_smem(gtu_bwd_kernel<K, T>, smem);
  if (err != cudaSuccess) return err;
  // the convs run in order 0, 1, 2, so conv ki's dx mode is ki
  gtu_bwd_kernel<K, T><<<grid_blocks(d.BN), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), wp, bp, ws + s.dx_acc,
      static_cast<T*>(dx), ws + s.part, ki, ki, d);
  return cudaGetLastError();
}

template <typename T>
int backward_impl(const void* x, const void* g, const float* wp, const float* bp, void* dx,
                  float* dwb, float* ws, const Dims& d, cudaStream_t st) {
  const BwdSpace s = bwd_space(d);
  cudaError_t err = launch_bwd<3, T>(x, g, wp, bp, dx, ws, s, 0, d, st);
  if (err == cudaSuccess) err = launch_bwd<5, T>(x, g, wp, bp, dx, ws, s, 1, d, st);
  if (err == cudaSuccess) err = launch_bwd<7, T>(x, g, wp, bp, dx, ws, s, 2, d, st);
  if (err == cudaSuccess)
    err = dense::sum_rows(ws + s.part, dwb, ws + s.scratch, grid_blocks(d.BN), d.L, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Floats of the backward's workspace.
size_t gtu_fused_workspace_floats(int BN, int C, int T) {
  return bwd_space(make_dims(BN, C, T, 0)).total;
}

// Forward: x (BN, C, T) and out (BN, 3T-12, C) in float32 (bf16 = 0) or
// bfloat16 (bf16 = 1); wp (15, 2C, C), bp (3, 2C) float32. Returns
// cudaGetLastError().
int gtu_fused_forward(const void* x, const float* wp, const float* bp, void* out, int BN,
                      int C, int T, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d = make_dims(BN, C, T, bf16);
  return bf16 ? forward_impl<__nv_bfloat16>(x, wp, bp, out, d, st)
              : forward_impl<float>(x, wp, bp, out, d, st);
}

// Backward: g (BN, 3T-12, C) → dx (BN, C, T) in the dtype of x, and dwb =
// [dW (15, 2C, C) | db (3, 2C)] float32, summed over every group in a fixed
// order. `ws` holds gtu_fused_workspace_floats floats.
int gtu_fused_backward(const void* x, const void* g, const float* wp, const float* bp,
                       void* dx, float* dwb, float* ws, int BN, int C, int T, int bf16,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d = make_dims(BN, C, T, bf16);
  return bf16 ? backward_impl<__nv_bfloat16>(x, g, wp, bp, dx, dwb, ws, d, st)
              : backward_impl<float>(x, g, wp, bp, dx, dwb, ws, d, st);
}

const char* gtu_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
