// Shared pieces of the bfloat16 tensor-core (WMMA) kernels (gtu_fused.cu,
// block_spatial_fused.cu): the 16x16x16 bf16 fragment types with float32
// accumulators, a bf16 pack of 8 floats, and cp.async copies into shared
// memory.
//
// load/store_matrix_sync need a 256-bit aligned pointer and a leading
// dimension that is a multiple of 8 (16-bit types) or 4 (float); each
// kernel's note says how its tiles keep to that.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>

namespace wm {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

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

}  // namespace wm
