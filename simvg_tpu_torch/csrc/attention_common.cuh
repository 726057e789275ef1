// Shared by the attention kernels (attention_fwd.cu, attention_bwd.cu): the
// tile shape of their CUDA-core (fp32) route, the element conversions and the
// row reductions.  On that route both kernels compute the logits of a
// (64-query, 64-key) tile with the same thread layout and the same summation
// order, so the backward recomputes bit for bit the logits whose row
// statistics the forward stored.  On the tensor-core (bf16) route
// (attention_mma.cuh) the dK/dV kernel computes the transposed product
// K Q^T, so its logits equal the forward's up to fp32 rounding only; the
// error bounds are the same.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace simvg {

constexpr int kBlockQ = 64;   // query rows per tile
constexpr int kBlockK = 64;   // keys per tile
constexpr int kThreadsX = 16; // threads across keys / head-dim columns
constexpr int kThreadsY = 16; // threads across query rows
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kRowsPerThread = kBlockQ / kThreadsY;  // 4
constexpr int kKeysPerThread = kBlockK / kThreadsX;  // 4
constexpr int kLdP = kBlockK + 1;  // padded row stride of a P / dS tile
constexpr float kPadLogit = -1e30f;  // the TPU kernel's bias on padded keys

// The CUDA-core kernels are templates on the element type T and are
// instantiated for float only: bf16 takes the tensor-core route.
template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }

// x rounded to the input type T and widened back: the cast the TPU kernel
// makes before a product with T operands.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Sum or max across the 16 lanes that share one query row (tx = lane % 16).
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = kThreadsX / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = kThreadsX / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// logit[i][j] = q_s[row ty + 16 i] . k_s[key tx + 16 j] over HD, summed in
// order d = 0 .. HD-1 with fmaf; both tiles in shared memory with stride ld.
template <int HD>
__device__ __forceinline__ void tile_logits(const float* q_s, const float* k_s, int ld,
                                            int tx, int ty,
                                            float (&logit)[kRowsPerThread][kKeysPerThread]) {
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) logit[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float qv[kRowsPerThread], kv[kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) qv[i] = q_s[(ty + kThreadsY * i) * ld + d];
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) kv[j] = k_s[(tx + kThreadsX * j) * ld + d];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        logit[i][j] = fmaf(qv[i], kv[j], logit[i][j]);
  }
}

}  // namespace simvg
