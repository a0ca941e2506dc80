// Shared pieces of the BELL kernels (bell_fused.cu, bell_bwd.cu).
//
// Layouts (c-major, contiguous, row-major):
//   x   (B, Np, C*T)        compute dtype (float or bf16), feature c*T + t
//   out (B, Np, Co*T)       compute dtype
//   gm  (B, Np, Co*T)       compute dtype (output cotangent * relu mask)
//   w   (B, A, H, BS, BS)   compute dtype, [source row][target column]
//   Θ   (H, C, Co)          float
// Active entry a of the target-sorted list joins source tile active_src[a]
// to target tile active_tgt[a]; tile j owns entries tile_start[j] ..
// tile_start[j] + tile_count[j] - 1.
//
// Every kernel block covers TT time steps with all channels of each step
// (W = C*TT <= 64 input columns, WO = Co*TT <= 512 output columns, TT <= T),
// so the Θ mix (or its transpose) closes inside the block. The products of
// the float32 kernels run on CUDA cores as float32 FMAs: operands are
// widened on load into shared memory, 256 threads hold a 128 x 64 tile of
// sums, 8 x 4 per thread. The bf16 F and K1 (bell_fused.cu
// f_spmm_wmma_kernel, bell_bwd.cu k1_*_wmma_kernel) run on the tensor cores
// instead (wmma_common.cuh), with their own chunks of 8 steps: the helpers
// at the end of this file.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "wmma_common.cuh"

namespace bell {

constexpr int kThreads = 256;
constexpr int kRows = 128;  // rows of the block's sum tile (16 thread rows x 8)
constexpr int kCols = 64;   // columns of the sum tile (16 thread columns x 4)
constexpr int kK = 32;      // contraction rows staged per shared chunk
constexpr int kLdRows = kRows + 4;  // padded row stride of transposed stages

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T's precision (round to nearest even), as a float
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// acc[r][c] += sum_{k < kc} a_s[k*lda + ty*8 + r] * b_s[k*ldb + tx*4 + c]
// with ty = threadIdx.x / 16, tx = threadIdx.x % 16. Both operands are
// k-major in shared memory; lda and ldb are multiples of 4 (16-byte rows).
__device__ __forceinline__ void tile_fma(float (&acc)[8][4], const float* a_s, int lda,
                                         const float* b_s, int ldb, int kc) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int k = 0; k < kc; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a_s + k * lda + ty * 8);
    const float4 a1 = *reinterpret_cast<const float4*>(a_s + k * lda + ty * 8 + 4);
    const float4 b4 = *reinterpret_cast<const float4*>(b_s + k * ldb + tx * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// Raise a kernel's dynamic shared memory cap when it needs more than 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// the bf16 tensor-core kernels' pieces: chunks of kTT steps, each one 16-byte
// row segment of bf16, staged by cp.async where whole and aligned
// ---------------------------------------------------------------------------

constexpr int kTT = 8;       // time steps a chunk: one 16-byte row segment of bf16
constexpr int kWarps = kThreads / 32;
constexpr int kLdS = 20;     // float stride of a warp's 16x16 staging: conflict-free
constexpr int kStage = 16 * kLdS;

__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ void cp_async16(wm::bf16* sdst, const wm::bf16* gsrc) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(sdst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(gsrc));
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of the thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void wait_async_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one 16-byte segment of kTT steps from t0 (zero past T_len): cp.async with
// vec (16-byte aligned and whole: T_len % 8 == 0 and an aligned base), else
// plain loads
__device__ __forceinline__ void stage_segment(wm::bf16* d, const wm::bf16* g, int t0,
                                              int T_len, bool vec) {
  if (vec) {
    cp_async16(d, g);
  } else {
#pragma unroll
    for (int tt = 0; tt < kTT; ++tt) d[tt] = t0 + tt < T_len ? g[tt] : __float2bfloat16_rn(0.f);
  }
}

__device__ __forceinline__ void zero16(wm::bf16* d) {
  *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
}

// 8 consecutive floats of a warp's staging (16-byte aligned) as 8 bf16
__device__ __forceinline__ uint4 pack8_at(const float* s) {
  float v[8];
  *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(s);
  *reinterpret_cast<float4*>(v + 4) = *reinterpret_cast<const float4*>(s + 4);
  return wm::pack8(v);
}

}  // namespace bell
