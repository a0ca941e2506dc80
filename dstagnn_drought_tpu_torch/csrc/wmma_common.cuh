// Shared pieces of the bfloat16 tensor-core (WMMA) kernels (gtu_fused.cu,
// block_spatial_fused.cu, tat_fused.cu, bell_fused.cu, bell_bwd.cu): the
// 16x16x16 bf16 fragment types with float32 accumulators, their loads and
// stores of shared memory, a bf16 pack of 8 floats, cp.async copies into
// shared memory, the hi/lo split of a float32 into two bf16 terms, and a
// weight-gradient product a^T b over many rows on the tensor cores.
//
// load/store_matrix_sync need a 256-bit aligned pointer and a leading
// dimension that is a multiple of 8 (16-bit types) or 4 (float); each
// kernel's note says how its tiles keep to that.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>

#include "dense_common.cuh"

namespace wm {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Fragment loads and stores of shared memory through WMMA's PTX with the
// .shared state space: the C++ load_matrix_sync/store_matrix_sync take a
// generic pointer, which can compile to generic loads; these compile to
// ldmatrix. Same registers, same fragments.
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void load_a_col_shared(FragAt& f, const bf16* p, unsigned ld) {
  unsigned* r = reinterpret_cast<unsigned*>(&f.x[0]);
  asm volatile("wmma.load.a.sync.aligned.col.m16n16k16.shared.bf16 {%0,%1,%2,%3}, [%4], %5;\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_addr(p)), "r"(ld));
}

__device__ __forceinline__ void load_a_row_shared(FragA& f, const bf16* p, unsigned ld) {
  unsigned* r = reinterpret_cast<unsigned*>(&f.x[0]);
  asm volatile("wmma.load.a.sync.aligned.row.m16n16k16.shared.bf16 {%0,%1,%2,%3}, [%4], %5;\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_addr(p)), "r"(ld));
}

__device__ __forceinline__ void load_b_row_shared(FragB& f, const bf16* p, unsigned ld) {
  unsigned* r = reinterpret_cast<unsigned*>(&f.x[0]);
  asm volatile("wmma.load.b.sync.aligned.row.m16n16k16.shared.bf16 {%0,%1,%2,%3}, [%4], %5;\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_addr(p)), "r"(ld));
}

// an accumulator to shared memory, row-major (col_major = false) or
// column-major, leading dimension ld (floats)
__device__ __forceinline__ void store_c_shared(float* p, const FragC& f, unsigned ld,
                                               bool col_major) {
  const float* v = &f.x[0];
  if (col_major)
    asm volatile("wmma.store.d.sync.aligned.col.m16n16k16.shared.f32 [%0], "
                 "{%1,%2,%3,%4,%5,%6,%7,%8}, %9;\n"
                 ::"r"(shared_addr(p)), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]),
                   "f"(v[4]), "f"(v[5]), "f"(v[6]), "f"(v[7]), "r"(ld) : "memory");
  else
    asm volatile("wmma.store.d.sync.aligned.row.m16n16k16.shared.f32 [%0], "
                 "{%1,%2,%3,%4,%5,%6,%7,%8}, %9;\n"
                 ::"r"(shared_addr(p)), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]),
                   "f"(v[4]), "f"(v[5]), "f"(v[6]), "f"(v[7]), "r"(ld) : "memory");
}

// 8 floats rounded to bf16, packed into 16 bytes
__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 u;
  unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<const unsigned*>(&h);
  }
  return u;
}

// n bf16 (a multiple of 8) from device to shared memory in 16-byte cp.async
// copies by the block's threads, committed as one group; wait_async waits
// for every group the thread committed
__device__ __forceinline__ void copy_async(bf16* sdst, const bf16* gsrc, int n) {
  for (int e = threadIdx.x * 8; e < n; e += blockDim.x * 8) {
    const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(sdst + e));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(gsrc + e));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_async() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// `rows` rows of `cols` bf16 (a multiple of 8; every row start 16-byte
// aligned on both sides) from device memory (row stride ldg) to shared
// memory (row stride lds), in 16-byte cp.async copies, committed as one group
__device__ __forceinline__ void copy_rows_async(bf16* sdst, int lds, const bf16* gsrc,
                                                size_t ldg, int rows, int cols) {
  const int per_row = cols / 8;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int r = e / per_row, c = (e % per_row) * 8;
    const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(sdst + r * lds + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                 "l"(gsrc + r * ldg + c));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// v = hi + lo + O(2^-18 |v|) with hi = bf16(v), lo = bf16(v - hi): a product
// with one float32 operand is two bf16 products (hi and lo) against the
// bf16-exact other, and a product of two float32 operands three (hi.hi +
// hi.lo + lo.hi), each summed in float32 on the tensor cores
__device__ __forceinline__ void split(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// part[s] (P, Q) = sum over rows m of chunk s (rows [s*chunk, min(M,
// (s+1)*chunk))) of a[m][p] b[m][q]; a (M, P) with row stride lda, b (M, Q)
// with row stride ldb. A float32 operand is split into hi and lo (three
// products for two float32 operands, two where one is bf16, one for two
// bf16). 64 x 64 output tile a block, 32 contraction rows staged per step,
// the next step's values loaded into registers while the tensor cores run
// on this one; warp w holds rows 16*(w/2) and two 16-column tiles. The
// sums run in the same order every launch.
template <typename TA, typename TB>
__global__ void __launch_bounds__(256)
atb_wmma_partial_kernel(const TA* __restrict__ a, int lda, const TB* __restrict__ b, int ldb,
                        float* __restrict__ part, int M, int P, int Q, int chunk) {
  constexpr bool kSplitA = sizeof(TA) == 4, kSplitB = sizeof(TB) == 4;
  constexpr int kLd = 64 + 8, kPer = 32 * 64 / 256;
  __shared__ __align__(32) bf16 ah[32 * kLd], al[32 * kLd], bh[32 * kLd], bl[32 * kLd];
  __shared__ __align__(32) float stage[8 * 256];
  const int q0 = blockIdx.x * 64, p0 = blockIdx.y * 64, s = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pt = warp / 2, qt = 2 * (warp % 2);
  const int m_begin = s * chunk, m_end = min(M, m_begin + chunk);
  float va[kPer], vb[kPer];
  // thread t stages elements t + 256*j of the (32, 64) step: row e / 64, column e % 64
  auto fetch = [&](int m0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = threadIdx.x + 256 * j, m = m0 + e / 64, c = e % 64;
      const bool in_m = m < m_end;
      va[j] = in_m && p0 + c < P ? to_float(a[(size_t)m * lda + p0 + c]) : 0.f;
      vb[j] = in_m && q0 + c < Q ? to_float(b[(size_t)m * ldb + q0 + c]) : 0.f;
    }
  };
  FragC acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  if (m_begin < m_end) fetch(m_begin);
  for (int m0 = m_begin; m0 < m_end; m0 += 32) {
    __syncthreads();  // the last step is consumed
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = threadIdx.x + 256 * j, o = (e / 64) * kLd + e % 64;
      split(va[j], ah[o], al[o]);
      split(vb[j], bh[o], bl[o]);
    }
    __syncthreads();
    if (m0 + 32 < m_end) fetch(m0 + 32);
#pragma unroll
    for (int k0 = 0; k0 < 32; k0 += 16) {
      FragAt fa, fal;
      wmma::load_matrix_sync(fa, ah + k0 * kLd + pt * 16, kLd);
      if (kSplitA) wmma::load_matrix_sync(fal, al + k0 * kLd + pt * 16, kLd);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        FragB fb;
        wmma::load_matrix_sync(fb, bh + k0 * kLd + (qt + q) * 16, kLd);
        wmma::mma_sync(acc[q], fa, fb, acc[q]);
        if (kSplitA) wmma::mma_sync(acc[q], fal, fb, acc[q]);
        if (kSplitB) {
          wmma::load_matrix_sync(fb, bl + k0 * kLd + (qt + q) * 16, kLd);
          wmma::mma_sync(acc[q], fa, fb, acc[q]);
        }
      }
    }
  }
  float* out = part + (size_t)s * P * Q;
  float* sw = stage + warp * 256;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    wmma::store_matrix_sync(sw, acc[q], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int p = p0 + pt * 16 + e / 16, c = q0 + (qt + q) * 16 + e % 16;
      if (p < P && c < Q) out[(size_t)p * Q + c] = sw[e];
    }
    __syncwarp();
  }
}

// Split count of the (M -> P x Q) product: about three blocks an SM of an
// H100 (132 SMs; the registers allow three), chunks of whole 32-row steps.
inline int atb_wmma_splits(int M, int P, int Q) {
  const int tiles = ((P + 63) / 64) * ((Q + 63) / 64);
  int S = (396 + tiles - 1) / tiles;
  const int steps = (M + 31) / 32;
  if (S > steps) S = steps;
  return S < 1 ? 1 : S;
}

// Floats of scratch that atb_wmma needs: the partials and sum_rows' scratch.
inline size_t atb_wmma_scratch(int M, int P, int Q) {
  const int S = atb_wmma_splits(M, P, Q);
  return (size_t)S * P * Q + dense::sum_rows_scratch(S, P * Q);
}

// out (P, Q) = a^T b over the M rows (atb_wmma_partial_kernel's split-M
// partials, then dense::sum_rows in a fixed order: two launches give the
// same bits). `scratch` holds atb_wmma_scratch(M, P, Q) floats.
template <typename TA, typename TB>
inline cudaError_t atb_wmma(const TA* a, int lda, const TB* b, int ldb, float* out,
                            float* scratch, int M, int P, int Q, cudaStream_t st) {
  const int S = atb_wmma_splits(M, P, Q);
  int chunk = (M + S - 1) / S;
  chunk = ((chunk + 31) / 32) * 32;
  const dim3 grid((Q + 63) / 64, (P + 63) / 64, S);
  atb_wmma_partial_kernel<TA, TB><<<grid, 256, 0, st>>>(a, lda, b, ldb, scratch, M, P, Q, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dense::sum_rows(scratch, out, scratch + (size_t)S * P * Q, S, P * Q, st);
}

}  // namespace wm
