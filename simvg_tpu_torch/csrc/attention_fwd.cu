// Fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_kernel` of simvg_tpu/ops/pallas_attention.py
// (entry `fused_attention`): per (batch, head) it computes
//     out = softmax(q k^T + pad_bias) v
// with q already scaled by head_dim^-0.5, logits and softmax in fp32, each
// probability tile rounded to the input type before its P.V product, and the
// P.V sum accumulated in fp32 and stored in the input type.  Padded keys
// (key_padding_mask == 1) get the logit -1e30, as the TPU kernel's additive
// bias gives them.
//
// Layout: q [B, Sq, H, HD], k/v [B, Sk, H, HD], out like q, all contiguous;
// the kernel reads the heads in place, with no transpose to [B*H, S, HD].
// The ragged ends of Sq and Sk are masked here, so nothing is padded outside.
//
// Design.  The TPU kernel keeps one head's whole K/V in VMEM and takes a
// one-shot softmax.  At S = 1621 in bf16 that is ~415 KB, above the 227 KB of
// shared memory an H100 block may use, so this kernel streams K/V instead:
// one block per (64-query tile, head, batch) holds its Q tile in shared
// memory and walks the keys in 64-key tiles with an online softmax
// (FlashAttention-2 style: running row max m and row sum l in fp32, the
// accumulator rescaled by exp(m_old - m_new) when the max grows).
//
// What bounds it.  At the flagship's S = 421, HD = 64 one layer's attention
// is 4*B*H*S^2*HD = 4.4 GFLOP at B = 8 over ~13 MB of q/k/v in bf16: too small
// to be bound by memory, and this first version runs its products on the CUDA
// cores in fp32 FMAs (16x16 threads, a 4x4 register tile each), so FMA issue
// and shared-memory reads bound it.  mma.sync / wgmma on the tensor cores and
// TMA-fed K/V tiles are the next steps.  The encoder's parameter matmuls, not
// this core, take ~92% of a layer's FLOPs at S = 421.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (simvg_tpu_torch/ops/_build.py); called through ctypes with a plain C ABI.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockK = 64;   // keys per streamed tile
constexpr int kThreadsX = 16; // threads across keys / head-dim columns
constexpr int kThreadsY = 16; // threads across query rows
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kRowsPerThread = kBlockQ / kThreadsY;  // 4
constexpr int kKeysPerThread = kBlockK / kThreadsX;  // 4
constexpr int kLdP = kBlockK + 1;  // padded row stride of the P tile
constexpr float kPadLogit = -1e30f;

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
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

template <int HD>
constexpr size_t smem_bytes() {
  // Q and K tiles with a padded stride (HD + 1) so the 16 threads of a row
  // group read 16 different banks; V unpadded (read along HD); the P tile.
  return sizeof(float) *
         (kBlockQ * (HD + 1) + kBlockK * (HD + 1) + kBlockK * HD + kBlockQ * kLdP);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const uint8_t* __restrict__ pad,
                     T* __restrict__ out, int sq, int sk, int heads) {
  static_assert(HD % kThreadsX == 0, "head_dim must be a multiple of 16");
  constexpr int kLd = HD + 1;
  constexpr int kColsPerThread = HD / kThreadsX;

  extern __shared__ float smem[];
  float* q_s = smem;                  // [kBlockQ][kLd]
  float* k_s = q_s + kBlockQ * kLd;   // [kBlockK][kLd]
  float* v_s = k_s + kBlockK * kLd;   // [kBlockK][HD]
  float* p_s = v_s + kBlockK * HD;    // [kBlockQ][kLdP]

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsX;
  const int ty = tid / kThreadsX;
  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;

  const long long row = (long long)heads * HD;  // elements between tokens
  const T* q_b = q + (long long)b * sq * row + (long long)head * HD;
  const T* k_b = k + (long long)b * sk * row + (long long)head * HD;
  const T* v_b = v + (long long)b * sk * row + (long long)head * HD;
  T* o_b = out + (long long)b * sq * row + (long long)head * HD;
  const uint8_t* pad_b = pad ? pad + (long long)b * sk : nullptr;

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    q_s[r * kLd + d] = s < sq ? to_float(q_b[s * row + d]) : 0.f;
  }

  float m[kRowsPerThread], l[kRowsPerThread];
  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < sk; k0 += kBlockK) {
    __syncthreads();  // Q is stored; the last tile's K/V/P reads are done
    for (int i = tid; i < kBlockK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, s = k0 + r;
      const bool in = s < sk;
      k_s[r * kLd + d] = in ? to_float(k_b[s * row + d]) : 0.f;
      v_s[r * HD + d] = in ? to_float(v_b[s * row + d]) : 0.f;
    }
    __syncthreads();

    // logits for rows ty + 16*i and keys tx + 16*j of this tile
    float logit[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) logit[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRowsPerThread], kv[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = q_s[(ty + kThreadsY * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) kv[j] = k_s[(tx + kThreadsX * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j)
          logit[i][j] = fmaf(qv[i], kv[j], logit[i][j]);
    }

    // Keys past Sk are left out (-inf); padded keys get the TPU kernel's
    // -1e30.  Every tile starts with an in-range key, so each row's tile
    // max is finite and exp() below never sees inf - inf.
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const int key = k0 + tx + kThreadsX * j;
      const bool outside = key >= sk;
      const bool padded = !outside && pad_b != nullptr && pad_b[key] != 0;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        if (outside) logit[i][j] = -INFINITY;
        else if (padded) logit[i][j] = kPadLogit;
      }
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float tile_max = logit[i][0];
#pragma unroll
      for (int j = 1; j < kKeysPerThread; ++j) tile_max = fmaxf(tile_max, logit[i][j]);
      const float m_new = fmaxf(m[i], row_max16(tile_max));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float tile_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float p = expf(logit[i][j] - m_new);
        tile_sum += p;
        // P is rounded to the input type before P.V, as in the TPU kernel
        p_s[(ty + kThreadsY * i) * kLdP + tx + kThreadsX * j] =
            to_float(from_float<T>(p));
      }
      l[i] = l[i] * alpha + row_sum16(tile_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc[rows ty + 16*i][cols tx + 16*c] += P . V
#pragma unroll 4
    for (int key = 0; key < kBlockK; ++key) {
      float pv[kRowsPerThread], vv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) pv[i] = p_s[(ty + kThreadsY * i) * kLdP + key];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) vv[c] = v_s[key * HD + tx + kThreadsX * c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int s = q0 + ty + kThreadsY * i;
    if (s >= sq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c)
      o_b[s * row + tx + kThreadsX * c] = from_float<T>(acc[i][c] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* pad, void* out,
           int batch, int sq, int sk, int heads, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, heads, batch);
  attention_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(pad), static_cast<T*>(out), sq, sk, heads);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  pad may be null (no padded keys).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int simvg_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* pad, void* out, int batch, int sq,
                                   int sk, int heads, int head_dim, int dtype,
                                   void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || heads <= 0 || heads > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // head_dim is a template parameter; 64 is every shipped config's
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, pad, out, batch, sq, sk, heads, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, pad, out, batch, sq, sk, heads, s);
  return (int)cudaErrorInvalidValue;
}
