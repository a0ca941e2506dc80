// Fused attention-modulated Chebyshev aggregation for sm_90a.
//
//   agg[b,k,j,m] = sum_i (T_k (.) softmax_i(S[b,k] + bias_k))[i,j] * x[b,i,m]
//
// S (B,K,N,N), bias = adj_pa (.) mask_k and T_k (K,N,N) float32, x (B,N,M)
// float32 or bf16 with M = C*T; out (B,K,N,M) float32; all row-major,
// contiguous. The softmax runs down each column j, over the source axis i,
// which is taken whole, so any N works.
//
// Replaces the Pallas kernel `fused_sat_aggregate` / `_make_kernel` in
// dstagnn_drought_tpu/ops/pallas/cheb_sat.py. Its backward stays in tensor
// ops (ops/cuda/cheb_sat.py), as the JAX package keeps it in XLA einsums.
//
// Bound on an H100: 2*B*K*N^2*M flops a product against about
// 4*(B*K*N^2 + 2*K*N^2 + B*K*N*M) + |x| bytes. The TPU kernel contracts in
// full float32, so the products here are float32 in value: an operand v is
// split into bf16 hi = bf16(v) and lo = bf16(v - hi) (wm::split), and
// A^T x = A_hi^T x_hi + A_hi^T x_lo + A_lo^T x_hi on the tensor cores with
// float32 sums (three bf16 products; two where x is bf16, whose lo is
// zero). At GAMBIA block 2 (B=4, K=2, N=2139, M=4608) that is bound by the
// tensor cores (~490 flop/byte a product); at PEMS08 (N=170) by bytes.
//
// Passes, chosen by the plan (ops/cuda/cheb_sat.py sat_plan):
//   colstats_kernel: one read of S and bias gives each column's max and
//     1/sum(exp) over i, (B,K,N) floats each, in scratch;
//   form_kernel: the operator A = T_k * exp(S + bias - max) * inv, formed
//     once per (b, k) and written as bf16 hi and lo planes (B*K, N, Np)
//     (Np = N rounded up to 8, zero past N), the (i, j) layout that the
//     product reads as its col-major A fragment. Forming it inside the
//     product would repeat every expf and every S/bias/T load once per M
//     tile (18 at GAMBIA block 2); at one M tile (PEMS08 block 1) it saved
//     nothing measurable, so A always goes through the planes;
//   x_planes_kernel (where x is float32, or bf16 with M % 8 != 0): x as
//     bf16 hi (and lo) planes (B, N, Mp), Mp = M rounded up to 8, zero past
//     M, so that every operand of the product is staged by 16-byte cp.async;
//     bf16 x with M % 8 == 0 (the model's bf16 path) is read as it lies;
//   sat_wmma_kernel<TJ, TM, XS>: one block per (M tile, TJ targets, b*k),
//     M tiles fastest so the blocks that share an A stripe run together;
//     8 warps (16 at TM = 256) hold the TJ x TM tile of sums in WMMA
//     float32 fragments, 2 x 4 fragments a warp at the GAMBIA tiles. It
//     walks the source axis in chunks of 32 rows through a ring of NS
//     shared stages filled by cp.async (NS - 1 chunks ahead). Ragged i, j
//     and m edges are zero-filled in the stages and masked at the store;
//     the host pads nothing it is given.
// Precision: float32 in value (the products' lost lo*lo term and the lo
// rounding are O(2^-16) of each term); expf (not __expf).

#include <cuda_runtime.h>
#include <math.h>

#include "wmma_common.cuh"

namespace {

using wm::bf16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;
constexpr int kTJ = 32;                    // columns a colstats block: one warp a row
constexpr int kStatRows = kThreads / kTJ;  // row groups in the stats pass
constexpr int kKC = 32;                    // source rows a stage
constexpr int kLdS = 20;                   // float stride of a warp's 16x16 staging

__host__ __device__ __forceinline__ int pad8(int n) { return (n + 7) / 8 * 8; }

__global__ void __launch_bounds__(kThreads)
colstats_kernel(const float* __restrict__ s, const float* __restrict__ bias,
                float* __restrict__ colmax, float* __restrict__ colinv,
                int K, int N) {
  const int bk = blockIdx.y;
  const int k = bk % K;
  const int jj = threadIdx.x % kTJ;
  const int ig = threadIdx.x / kTJ;
  const int j = blockIdx.x * kTJ + jj;
  const float* s_bk = s + (size_t)bk * N * N;
  const float* b_k = bias + (size_t)k * N * N;

  // online max / sum of exp over this thread's rows i = ig, ig + kStatRows, ...
  float m = -INFINITY, l = 0.f;
  if (j < N) {
    for (int i = ig; i < N; i += kStatRows) {
      const size_t o = (size_t)i * N + j;
      const float v = s_bk[o] + b_k[o];
      if (v > m) {
        l = l * expf(m - v) + 1.f;
        m = v;
      } else {
        l += expf(v - m);
      }
    }
  }
  __shared__ float sm[kStatRows][kTJ];
  __shared__ float sl[kStatRows][kTJ];
  sm[ig][jj] = m;
  sl[ig][jj] = l;
  __syncthreads();
  if (ig == 0 && j < N) {
    float mx = sm[0][jj];
    for (int g = 1; g < kStatRows; ++g) mx = fmaxf(mx, sm[g][jj]);
    float sum = 0.f;
    for (int g = 0; g < kStatRows; ++g) {
      if (sl[g][jj] > 0.f) sum += sl[g][jj] * expf(sm[g][jj] - mx);
    }
    colmax[(size_t)bk * N + j] = mx;
    colinv[(size_t)bk * N + j] = 1.f / sum;
  }
}

// A's bf16 hi and lo planes, (B*K, N, Np) each, lo at B*K*N*Np past hi: one
// thread a 16-byte segment of 8 columns, k slowest (the B (b, k) that read
// one bias and one T plane run together, so those planes stay in L2)
__global__ void __launch_bounds__(kThreads)
form_kernel(const float* __restrict__ s, const float* __restrict__ bias,
            const float* __restrict__ cheb, const float* __restrict__ colmax,
            const float* __restrict__ colinv, bf16* __restrict__ planes, int B, int K,
            int N) {
  const int Np = pad8(N), segs = Np / 8;
  const size_t n = (size_t)B * K * N * segs, lo_off = (size_t)B * K * N * Np;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int j0 = (int)(e % segs) * 8;
    const size_t kbi = e / segs;  // (k*B + b)*N + i
    const int i = (int)(kbi % N), kb = (int)(kbi / N), k = kb / B, bk = kb % B * K + k;
    const size_t row = (size_t)bk * N + i;
    const float* s_bk = s + (size_t)bk * N * N;
    const float* b_k = bias + (size_t)k * N * N;
    const float* t_k = cheb + (size_t)k * N * N;
    float hi[8], lo[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + q;
      const size_t o = (size_t)i * N + j, c = (size_t)bk * N + j;
      const float a = j < N ? t_k[o] * (expf(s_bk[o] + b_k[o] - colmax[c]) * colinv[c]) : 0.f;
      bf16 h, l;
      wm::split(a, h, l);
      hi[q] = __bfloat162float(h);
      lo[q] = __bfloat162float(l);
    }
    *reinterpret_cast<uint4*>(planes + row * Np + j0) = wm::pack8(hi);
    *reinterpret_cast<uint4*>(planes + lo_off + row * Np + j0) = wm::pack8(lo);
  }
}

// x (B*N, M) as bf16 planes (B*N, Mp): hi, and lo at B*N*Mp past it where
// x is float32 (a bf16 x is copied, padded, into hi)
template <typename TX>
__global__ void __launch_bounds__(kThreads)
x_planes_kernel(const TX* __restrict__ x, bf16* __restrict__ planes, int rows, int M) {
  constexpr bool kSplit = sizeof(TX) == 4;
  const int Mp = pad8(M), segs = Mp / 8;
  const size_t n = (size_t)rows * segs, lo_off = (size_t)rows * Mp;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int m0 = (int)(e % segs) * 8;
    const size_t row = e / segs;
    float hi[8], lo[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float v = m0 + q < M ? wm::to_float(x[row * M + m0 + q]) : 0.f;
      bf16 h, l;
      wm::split(v, h, l);
      hi[q] = __bfloat162float(h);
      lo[q] = __bfloat162float(l);
    }
    *reinterpret_cast<uint4*>(planes + row * Mp + m0) = wm::pack8(hi);
    if (kSplit) *reinterpret_cast<uint4*>(planes + lo_off + row * Mp + m0) = wm::pack8(lo);
  }
}

// 16 bytes by cp.async, or 16 zero bytes where !valid (src-size 0: nothing
// is read)
__device__ __forceinline__ void cp_async16_zfill(bf16* sdst, const bf16* gsrc, bool valid) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(sdst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa), "l"(gsrc),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void commit_async() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most NS - 2 of the thread's committed groups are in flight
__device__ __forceinline__ void wait_stages(int NS) {
  if (NS >= 4)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (NS == 3)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// warps of a product block: 16 (one block an SM) at 256 features, which
// halves the operand bytes a sum takes from L2 against 128 x 128; else 8
// (two blocks an SM)
__host__ __device__ constexpr int sat_warps(int TM) { return TM > 128 ? 16 : 8; }

// the product's tile geometry: W warps as WJ x WM, each holding FR x FC
// fragments of 16 x 16 sums (warps past WJ*WM only stage)
template <int TJ, int TM>
struct Tile {
  static constexpr int W = sat_warps(TM), T = 32 * W;
  static constexpr int WM = TM / 16 < W / 4 ? TM / 16 : W / 4;
  static constexpr int WJ = TJ / 16 < W / WM ? TJ / 16 : W / WM;
  static constexpr int FR = TJ / 16 / WJ, FC = TM / 16 / WM;
  static constexpr int LDA = TJ + 8, LDX = TM + 8;  // bf16 strides: 16-byte skew a row
};

// shared memory of a product block: NS stages of A_hi, A_lo (kKC x LDA) and
// x_hi (and x_lo where XS) (kKC x LDX); the epilogue's staging reuses them
__host__ __device__ inline size_t sat_smem(int TJ, int TM, int XS, int NS) {
  const size_t stage = 2 * (size_t)kKC * (2 * (TJ + 8) + (1 + XS) * (TM + 8));
  const size_t epilogue = 4 * (size_t)sat_warps(TM) * 16 * kLdS;
  return NS * stage > epilogue ? NS * stage : epilogue;
}

// out[bk][j][m] for j in [j0, j0+TJ), m in [m0, m0+TM): sum over source
// chunks of A_hi^T x_hi + A_lo^T x_hi (+ A_hi^T x_lo where XS). A from its
// planes (a_planes, stride Np, lo at B*K*N*Np past hi), x from xp (stride
// ldx, zero from M up to ldx), x_lo at x_lo_off past it.
template <int TJ, int TM, int XS>
__global__ void __launch_bounds__(Tile<TJ, TM>::T, 16 / sat_warps(TM))
sat_wmma_kernel(const bf16* __restrict__ a_planes, const bf16* __restrict__ xp,
                size_t x_lo_off, float* __restrict__ out, int K, int N, int M, int ldx,
                int NS) {
  using G = Tile<TJ, TM>;
  constexpr int LDA = G::LDA, LDX = G::LDX, FR = G::FR, FC = G::FC, kT = G::T;
  const int m0 = blockIdx.x * TM, j0 = blockIdx.y * TJ, bk = blockIdx.z;
  const int b = bk / K;
  const int Np = pad8(N);
  const size_t a_lo_off = (size_t)gridDim.z * N * Np;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  constexpr int kStage = kKC * (2 * LDA + (1 + XS) * LDX);  // bf16 a stage
  const bf16* a_bk = a_planes + (size_t)bk * N * Np;
  const bf16* x_b = xp + (size_t)b * N * ldx;

  // stage source chunk c into slot c % NS (one cp.async group, committed
  // by the caller)
  auto fill = [&](int c) {
    bf16* st = ring + (size_t)(c % NS) * kStage;
    bf16 *ah = st, *al = st + kKC * LDA, *xh = st + 2 * kKC * LDA;
    const int i0 = c * kKC;
    for (int e = threadIdx.x; e < 2 * kKC * (TJ / 8); e += kT) {
      const int plane = e / (kKC * (TJ / 8)), r = e % (kKC * (TJ / 8));
      const int ii = r / (TJ / 8), jj = r % (TJ / 8) * 8, i = i0 + ii;
      const bool ok = i < N && j0 + jj < Np;
      cp_async16_zfill((plane ? al : ah) + ii * LDA + jj,
                       ok ? a_bk + plane * a_lo_off + (size_t)i * Np + j0 + jj : a_bk, ok);
    }
    for (int e = threadIdx.x; e < (1 + XS) * kKC * (TM / 8); e += kT) {
      const int plane = e / (kKC * (TM / 8)), r = e % (kKC * (TM / 8));
      const int ii = r / (TM / 8), mm = r % (TM / 8) * 8, i = i0 + ii;
      const bool ok = i < N && m0 + mm < ldx;
      cp_async16_zfill(xh + plane * kKC * LDX + ii * LDX + mm,
                       ok ? x_b + plane * x_lo_off + (size_t)i * ldx + m0 + mm : x_b, ok);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wj = warp / G::WM, wm_ = warp % G::WM;
  const bool mma_warp = warp < G::WJ * G::WM;
  wm::FragC acc[FR][FC];
#pragma unroll
  for (int r = 0; r < FR; ++r)
#pragma unroll
    for (int q = 0; q < FC; ++q) wmma::fill_fragment(acc[r][q], 0.f);

  const int n_chunks = (N + kKC - 1) / kKC;
  for (int c = 0; c < NS - 1; ++c) {
    if (c < n_chunks) fill(c);
    commit_async();
  }
  for (int c = 0; c < n_chunks; ++c) {
    wait_stages(NS);
    __syncthreads();  // chunk c staged; slot (c - 1) % NS consumed by every warp
    if (c + NS - 1 < n_chunks) fill(c + NS - 1);
    commit_async();
    if (!mma_warp) continue;
    const bf16* st = ring + (size_t)(c % NS) * kStage;
    const bf16 *ah = st, *al = st + kKC * LDA, *xh = st + 2 * kKC * LDA, *xl = xh + kKC * LDX;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      wm::FragAt fh[FR], fl[FR];
#pragma unroll
      for (int r = 0; r < FR; ++r) {
        const int col = (wj * FR + r) * 16;
        wm::load_a_col_shared(fh[r], ah + kk * LDA + col, LDA);
        wm::load_a_col_shared(fl[r], al + kk * LDA + col, LDA);
      }
#pragma unroll
      for (int q = 0; q < FC; ++q) {
        const int col = (wm_ * FC + q) * 16;
        wm::FragB xb;
        wm::load_b_row_shared(xb, xh + kk * LDX + col, LDX);
#pragma unroll
        for (int r = 0; r < FR; ++r) {
          wmma::mma_sync(acc[r][q], fh[r], xb, acc[r][q]);
          wmma::mma_sync(acc[r][q], fl[r], xb, acc[r][q]);
        }
        if (XS) {
          wm::load_b_row_shared(xb, xl + kk * LDX + col, LDX);
#pragma unroll
          for (int r = 0; r < FR; ++r) wmma::mma_sync(acc[r][q], fh[r], xb, acc[r][q]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // the ring is free for the epilogue's staging
  if (!mma_warp) return;
  float* sw = reinterpret_cast<float*>(smem_raw) + warp * 16 * kLdS;
  float* o_bk = out + (size_t)bk * N * M;
#pragma unroll
  for (int r = 0; r < FR; ++r)
#pragma unroll
    for (int q = 0; q < FC; ++q) {
      wm::store_c_shared(sw, acc[r][q], kLdS, false);  // sw[row][col]
      __syncwarp();
      const int jb = j0 + (wj * FR + r) * 16, mb = m0 + (wm_ * FC + q) * 16;
      for (int e = lane; e < 256; e += 32) {
        const int j = jb + e / 16, m = mb + e % 16;
        if (j < N && m < M) o_bk[(size_t)j * M + m] = sw[(e / 16) * kLdS + e % 16];
      }
      __syncwarp();
    }
}

template <int TJ, int TM, int XS>
cudaError_t launch_product(const bf16* a_planes, const bf16* xp, size_t x_lo_off, float* out,
                           int B, int K, int N, int M, int ldx, int NS, cudaStream_t st) {
  const size_t smem = sat_smem(TJ, TM, XS, NS);
  auto kernel = sat_wmma_kernel<TJ, TM, XS>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((M + TM - 1) / TM, (N + TJ - 1) / TJ, B * K);
  kernel<<<grid, Tile<TJ, TM>::T, smem, st>>>(a_planes, xp, x_lo_off, out, K, N, M, ldx, NS);
  return cudaGetLastError();
}

template <int TJ, int XS>
cudaError_t launch_tm(int TM, const bf16* a_planes, const bf16* xp, size_t x_lo_off,
                      float* out, int B, int K, int N, int M, int ldx, int NS,
                      cudaStream_t st) {
  switch (TM) {
#define SAT_TM(tm)                                                                        \
  case tm:                                                                                \
    return launch_product<TJ, tm, XS>(a_planes, xp, x_lo_off, out, B, K, N, M, ldx, NS, st);
    SAT_TM(16) SAT_TM(32) SAT_TM(64) SAT_TM(128) SAT_TM(256)
#undef SAT_TM
  }
  return cudaErrorInvalidValue;
}

// the scratch layout (bytes, each part 256-byte aligned): colmax, colinv
// (B*K*N floats each), A's planes, x's planes where x is float32 or bf16
// with M % 8 != 0
struct Scratch {
  size_t colmax, colinv, a_planes, x_planes, total;
};

inline size_t align256(size_t n) { return (n + 255) / 256 * 256; }

inline Scratch scratch_layout(int B, int K, int N, int M, int x_bf16) {
  Scratch sc;
  const size_t stats = align256(4 * (size_t)B * K * N);
  sc.colmax = 0;
  sc.colinv = stats;
  sc.a_planes = 2 * stats;
  const size_t a_bytes = align256(2 * 2 * (size_t)B * K * N * pad8(N));
  sc.x_planes = sc.a_planes + a_bytes;
  const bool planes = !x_bf16 || M % 8 != 0;
  const size_t x_bytes = planes ? align256(2 * (x_bf16 ? 1 : 2) * (size_t)B * N * pad8(M)) : 0;
  sc.total = sc.x_planes + x_bytes;
  return sc;
}

inline int blocks_for(size_t n) {
  const size_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 132 * 16 ? (b < 1 ? 1 : b) : 132 * 16);
}

}  // namespace

extern "C" {

// Launches the plan's passes on `stream`: x is float32 (x_bf16 = 0) or bf16
// (1); tiles TJ in {64, 128} targets x TM in {16, ..., 256} features, NS
// in {2, 3, 4} stages. `scratch` holds cheb_sat_scratch_bytes(...) bytes
// (256-byte aligned). Returns cudaGetLastError() after the launches (0 on
// success).
int cheb_sat_forward(const float* s, const float* bias, const float* cheb, const void* x,
                     int x_bf16, float* out, void* scratch, int B, int K, int N, int M, int TJ,
                     int TM, int NS, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((TJ != 64 && TJ != 128) || NS < 2 || NS > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch sc = scratch_layout(B, K, N, M, x_bf16);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  float* colmax = reinterpret_cast<float*>(base + sc.colmax);
  float* colinv = reinterpret_cast<float*>(base + sc.colinv);
  bf16* a_planes = reinterpret_cast<bf16*>(base + sc.a_planes);
  const dim3 stats_grid((N + kTJ - 1) / kTJ, B * K);
  colstats_kernel<<<stats_grid, kThreads, 0, st>>>(s, bias, colmax, colinv, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_seg = (size_t)B * K * N * (pad8(N) / 8);
  form_kernel<<<blocks_for(n_seg), kThreads, 0, st>>>(s, bias, cheb, colmax, colinv, a_planes,
                                                       B, K, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* xp = static_cast<const bf16*>(x);
  int ldx = M;
  size_t x_lo_off = 0;
  if (sc.total > sc.x_planes) {
    bf16* planes = reinterpret_cast<bf16*>(base + sc.x_planes);
    const size_t n = (size_t)B * N * (pad8(M) / 8);
    if (x_bf16)
      x_planes_kernel<bf16><<<blocks_for(n), kThreads, 0, st>>>(static_cast<const bf16*>(x),
                                                                planes, B * N, M);
    else
      x_planes_kernel<float><<<blocks_for(n), kThreads, 0, st>>>(static_cast<const float*>(x),
                                                                 planes, B * N, M);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    xp = planes;
    ldx = pad8(M);
    x_lo_off = (size_t)B * N * ldx;
  }
  const int XS = x_bf16 ? 0 : 1;
#define SAT_LAUNCH(tj, xs) \
  launch_tm<tj, xs>(TM, a_planes, xp, x_lo_off, out, B, K, N, M, ldx, NS, st)
  if (TJ == 128)
    err = XS ? SAT_LAUNCH(128, 1) : SAT_LAUNCH(128, 0);
  else
    err = XS ? SAT_LAUNCH(64, 1) : SAT_LAUNCH(64, 0);
#undef SAT_LAUNCH
  return static_cast<int>(err);
}

// bytes of shared memory a product block requests (dynamic, the ring and
// the epilogue's staging), for the Python plan's check
size_t cheb_sat_smem_bytes(int TJ, int TM, int XS, int NS) { return sat_smem(TJ, TM, XS, NS); }

// bytes of scratch the passes use
size_t cheb_sat_scratch_bytes(int B, int K, int N, int M, int x_bf16) {
  return scratch_layout(B, K, N, M, x_bf16).total;
}

const char* cheb_sat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
