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
// Every product of the BELL kernels runs on the tensor cores (WMMA,
// wmma_common.cuh), one design for both dtypes: bf16 operands are staged in
// shared memory as they are, float32 ones split into a bf16 hi and lo plane
// (the lo plane `lo` elements after the hi one), and a product of two float32
// operands is three bf16 products (hi.hi + hi.lo + lo.hi) summed in float32,
// float32 in value. Time runs in chunks of kTT steps (one 16-byte row segment
// of bf16). No block's shared memory grows with C, Co or the block size: the
// kernels take channels, output channels and rows in chunks (their plans in
// ops/cuda/bell_fused.py and ops/cuda/bell_bwd.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "wmma_common.cuh"

namespace bell {

constexpr int kThreads = 256;
constexpr int kTT = 8;  // time steps a chunk: one 16-byte row segment of bf16
constexpr int kWarps = kThreads / 32;
constexpr int kLdS = 20;  // float stride of a warp's 16x16 staging: conflict-free
constexpr int kStage = 16 * kLdS;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Raise a kernel's dynamic shared memory cap when it needs more than 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// planes a staged operand of type T takes: bf16 one, float32 two (hi, lo)
template <typename T> struct Planes {
  static constexpr int n = sizeof(T) == 4 ? 2 : 1;
};

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

__device__ __forceinline__ void zero16(wm::bf16* d) {
  *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
}

// a zero segment in both planes of a float32 operand (`two`), else in one
__device__ __forceinline__ void zero8(wm::bf16* d, size_t lo, bool two) {
  zero16(d);
  if (two) zero16(d + lo);
}

// 8 consecutive values g[0 .. 8) (those at index >= n as zeros) into one
// 16-byte segment: bf16 as they are, by cp.async where vec (whole and
// 16-byte aligned); float32 split into hi at d and lo at d + lo, read as two
// float4 where vec
__device__ __forceinline__ void seg8(wm::bf16* d, size_t, const wm::bf16* g, int n, bool vec) {
  if (vec) {
    cp_async16(d, g);
  } else {
#pragma unroll
    for (int tt = 0; tt < kTT; ++tt) d[tt] = tt < n ? g[tt] : __float2bfloat16_rn(0.f);
  }
}

__device__ __forceinline__ void seg8(wm::bf16* d, size_t lo, const float* g, int n, bool vec) {
  float v[kTT], l[kTT];
  if (vec) {
    *reinterpret_cast<float4*>(v) = __ldg(reinterpret_cast<const float4*>(g));
    *reinterpret_cast<float4*>(v + 4) = __ldg(reinterpret_cast<const float4*>(g) + 1);
  } else {
#pragma unroll
    for (int tt = 0; tt < kTT; ++tt) v[tt] = tt < n ? g[tt] : 0.f;
  }
#pragma unroll
  for (int tt = 0; tt < kTT; ++tt) l[tt] = v[tt] - __bfloat162float(__float2bfloat16_rn(v[tt]));
  *reinterpret_cast<uint4*>(d) = wm::pack8(v);
  *reinterpret_cast<uint4*>(d + lo) = wm::pack8(l);
}

// one value into a staged operand: bf16 as it is, float32 split
__device__ __forceinline__ void put(wm::bf16* d, size_t, wm::bf16 v) { d[0] = v; }
__device__ __forceinline__ void put(wm::bf16* d, size_t lo, float v) { wm::split(v, d[0], d[lo]); }

template <typename T> __device__ __forceinline__ T zero_of() { return from_f<T>(0.f); }

// 8 consecutive floats of a warp's staging (16-byte aligned) as 8 bf16
__device__ __forceinline__ uint4 pack8_at(const float* s) {
  float v[8];
  *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(s);
  *reinterpret_cast<float4*>(v + 4) = *reinterpret_cast<const float4*>(s + 4);
  return wm::pack8(v);
}

// 8 floats as a float32 value's bf16 hi and lo segments
__device__ __forceinline__ void split8(const float* v, wm::bf16* hi, wm::bf16* lo) {
  float l[kTT];
#pragma unroll
  for (int tt = 0; tt < kTT; ++tt) l[tt] = v[tt] - __bfloat162float(__float2bfloat16_rn(v[tt]));
  *reinterpret_cast<uint4*>(hi) = wm::pack8(v);
  *reinterpret_cast<uint4*>(lo) = wm::pack8(l);
}

// 8 output values from d[0] (the first n of them where not vec): bf16
// rounded once, one 16-byte store where vec; float32 as two float4
__device__ __forceinline__ void store8(wm::bf16* d, const float* v, int n, bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(d) = wm::pack8(v);
  } else {
    for (int tt = 0; tt < kTT && tt < n; ++tt) d[tt] = __float2bfloat16_rn(v[tt]);
  }
}

__device__ __forceinline__ void store8(float* d, const float* v, int n, bool vec) {
  if (vec) {
    reinterpret_cast<float4*>(d)[0] = *reinterpret_cast<const float4*>(v);
    reinterpret_cast<float4*>(d)[1] = *reinterpret_cast<const float4*>(v + 4);
  } else {
    for (int tt = 0; tt < kTT && tt < n; ++tt) d[tt] = v[tt];
  }
}

// acc += a . b for staged operands: one bf16 product, or, where both are
// split float32 values (F32), three (hi.hi + hi.lo + lo.hi)
template <bool F32, typename FA, typename FB>
__device__ __forceinline__ void mma3(wm::FragC& acc, const FA& ah, const FA& al, const FB& bh,
                                     const FB& bl) {
  nvcuda::wmma::mma_sync(acc, ah, bh, acc);
  if constexpr (F32) {
    nvcuda::wmma::mma_sync(acc, ah, bl, acc);
    nvcuda::wmma::mma_sync(acc, al, bh, acc);
  }
}

// acc += a . b where a is a staged operand (split where F32) and b a split
// float32 value: two products (a.hi + a.lo against b's hi, a's hi against
// b's lo where F32), three where F32
template <bool F32, typename FA, typename FB>
__device__ __forceinline__ void mma_split_b(wm::FragC& acc, const FA& ah, const FA& al,
                                            const FB& bh, const FB& bl) {
  nvcuda::wmma::mma_sync(acc, ah, bh, acc);
  nvcuda::wmma::mma_sync(acc, ah, bl, acc);
  if constexpr (F32) nvcuda::wmma::mma_sync(acc, al, bh, acc);
}

}  // namespace bell
