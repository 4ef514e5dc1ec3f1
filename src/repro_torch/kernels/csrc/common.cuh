// Helpers shared by the attention kernels of this directory.
//
// The f32 paths (and K2 at head sizes its tensor-core kernel is not built
// for) do all of their arithmetic in f32 FMA (never TF32): f32 inputs must
// agree with the plain PyTorch version to 2e-5. The bf16 tensor-core paths
// of K1, K2 and K3 use mma.cuh and hopper.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float NEG_INF = -1e30f;   // the reference kernels' mask value
constexpr int THREADS = 128;        // four warps per block
constexpr int WARPS = THREADS / 32;

enum Dtype : int { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// Round to nearest even, as torch's and JAX's casts do.
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage `rows` rows of D elements into f32 shared memory, row r from
// src + r * src_stride into dst + r * dst_stride. Rows at or past
// n_valid are not read and are written as zeros. Each thread moves 16
// bytes at a time and has BATCH loads in flight before it converts and
// stores any: the copy is bound by load latency, not by its few
// instructions. D must be a multiple of 16 / sizeof(T) and every row
// start 16-byte aligned (the wrappers check both).
template <typename T, int BATCH = 8>
__device__ __forceinline__ void load_rows_f32(float* dst, int dst_stride, const T* src,
                                              long long src_stride, int rows, int n_valid,
                                              int D) {
  constexpr int VEC = 16 / sizeof(T);
  const int vec_per_row = D / VEC;
  const int total = rows * vec_per_row;
  for (int i0 = threadIdx.x; i0 < total; i0 += BATCH * blockDim.x) {
    uint4 raw[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + k * blockDim.x;
      const int r = i / vec_per_row;
      raw[k] = make_uint4(0u, 0u, 0u, 0u);   // the bits of +0.0 in f32 and bf16
      if (i < total && r < n_valid)
        raw[k] = *reinterpret_cast<const uint4*>(src + r * src_stride +
                                                 (i - r * vec_per_row) * VEC);
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + k * blockDim.x;
      if (i < total) {
        const int r = i / vec_per_row;
        float* d = dst + r * dst_stride + (i - r * vec_per_row) * VEC;
        const T* e = reinterpret_cast<const T*>(&raw[k]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) d[j] = to_f32(e[j]);
      }
    }
  }
}

// Launch configuration shared by the host entry points: opt in to more
// than 48 KB of dynamic shared memory where a kernel needs it.
template <typename K>
inline cudaError_t prepare_smem(K kernel, size_t smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes));
}

}  // namespace repro
