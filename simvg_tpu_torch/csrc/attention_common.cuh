// Shared by the attention kernels (attention_fwd.cu, attention_bwd.cu): the
// tile shape of their CUDA-core (fp32) route, the element conversions and the
// row reductions, and the exp, shared-address and bf16-packing helpers of both
// tensor-core routes.  On the fp32 route both kernels compute the logits of a
// (64-query, 64-key) tile with the same thread layout and the same summation
// order, so the backward recomputes bit for bit the logits whose row statistics
// the forward stored.  On the tensor-core (bf16) route (attention_sm90.cuh)
// the forward and the backward use other products, and the dK/dV kernel the
// transposed K Q^T, so the backward's logits equal the forward's up to fp32
// rounding only; the error bounds are the same.

#pragma once

#include <cuda_bf16.h>
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

constexpr float kLog2e = 1.4426950408889634f;

// exp(x - y) = exp_sub(x, exp_arg(y)): one FMA and the hardware's exp2
// (~2 ulp), where expf would spend several more instructions on every
// element of a score tile.  The forward's softmax and the backward's
// recomputed P both take it, so P stays consistent with the stored lse.
__device__ __forceinline__ float exp_arg(float y) { return y * kLog2e; }
__device__ __forceinline__ float exp_sub(float x, float y2) {
  return exp2f(fmaf(x, kLog2e, -y2));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two fp32 values rounded to nearest even bf16 (as astype does), lo in the
// low half: the lower column first, as the fragments want it.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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

// logit[i][j] += q_s[row ty + 16 i] . k_s[key tx + 16 j] over HD, summed in
// order d = 0 .. HD-1 with fmaf; both tiles in shared memory with stride ld.
// The split route sums a wide head dim chunk by chunk through it, in the same
// order as one call over the whole: the same bits.
template <int HD>
__device__ __forceinline__ void tile_logits_acc(const float* q_s, const float* k_s, int ld,
                                                int tx, int ty,
                                                float (&logit)[kRowsPerThread][kKeysPerThread]) {
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

// logit[i][j] = q_s[row ty + 16 i] . k_s[key tx + 16 j] over HD.
template <int HD>
__device__ __forceinline__ void tile_logits(const float* q_s, const float* k_s, int ld,
                                            int tx, int ty,
                                            float (&logit)[kRowsPerThread][kKeysPerThread]) {
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) logit[i][j] = 0.f;
  tile_logits_acc<HD>(q_s, k_s, ld, tx, ty, logit);
}

// Rows [r0, r0 + 64) of columns [c0, c0 + 64) of one head of a [B, S, H, hd]
// tensor (`src` at the head's first element of batch b, `row` elements from
// one token to the next) into a [64][ld] fp32 tile; rows past s are zero.
// The fp32 split route's loads.
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, int ld, const T* src, long long row,
                                           int r0, int c0, int s, int tid) {
  for (int i = tid; i < 64 * 64; i += kThreads) {
    const int r = i / 64, d = i % 64, t = r0 + r;
    dst[r * ld + d] = t < s ? to_float(src[t * row + c0 + d]) : 0.f;
  }
}

}  // namespace simvg
