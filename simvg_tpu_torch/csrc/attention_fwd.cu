// Fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_kernel` of simvg_tpu/ops/pallas_attention.py
// (entry `fused_attention`): per (batch, head) it computes
//     out = softmax(q k^T + pad_bias) v
// with q already scaled by head_dim^-0.5, logits and softmax in fp32, each
// probability tile rounded to the input type before its P.V product, and the
// P.V sum accumulated in fp32 and stored in the input type.  Padded keys
// (key_padding_mask == 1) get the logit -1e30, as the TPU kernel's additive
// bias gives them.  When a gradient will be needed the kernel also writes
// the per-row log-sum-exp lse = m + log(l) of those fp32 logits, [B, H, Sq],
// for the backward kernel (attention_bwd.cu) to recompute P from, and, in
// bf16, the residual r of the output: with P split into a bf16 high part
// round(P) and low part round(P - round(P)), o = sum_j (high + low)_j v_j / l
// carries P unrounded, and r = round(o - out).  The backward takes its row
// term D = rowsum(dO * (out + r)) from it (attention_bwd.cu's header says
// why).  out itself is the same with or without r.
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
// Two routes, chosen by dtype in the C entry point:
//   bf16  attention_fwd_mma_kernel: the tensor cores.  4 warps of 16 query
//         rows; S = Q K^T and O += round(P) V are mma.sync m16n8k16 products
//         on bf16 fragments with fp32 sums, K/V tiles arrive through a
//         2-stage cp.async ring, and P goes from the S accumulators to the A
//         operand of P V in registers (attention_mma.cuh).
//   fp32  attention_fwd_kernel: the CUDA cores in fp32 FMAs (16x16 threads, a
//         4x4 register tile each), the parity route: tensor cores would take
//         fp32 operands only as TF32, which keeps ~3 decimal digits.
//
// What bounds it.  At the flagship's S = 421, HD = 64 one layer's attention
// is 4*B*H*S^2*HD = 17.4 GFLOP at B = 32 over ~83 MB of q/k/v/out in bf16:
// 0.018 ms of tensor-core work at 989 TFLOP/s against 0.025 ms of memory
// traffic at 3.35 TB/s, so the card's bound is the bytes.  What bounds this
// mma.sync design is instruction throughput: each warp reloads the K/V
// fragments of every tile from shared memory (ldmatrix), and the softmax's
// exp and max run on the CUDA cores between the two products.  Warpgroup
// wgmma with TMA-fed tiles is the next step (the backward, attention_bwd.cu,
// has taken it).  With the residual the kernel does a third product a key
// tile, O_lo += round(P - round(P)) V, and writes a fifth [B, S, H, HD]
// tensor; without a gradient it does neither.  The encoder's parameter
// matmuls, not this core, take ~92% of a layer's FLOPs at S = 421.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (simvg_tpu_torch/ops/_build.py); called through ctypes with a plain C ABI.

#include <math.h>

#include "attention_common.cuh"
#include "attention_mma.cuh"

namespace {

using namespace simvg;

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
                     T* __restrict__ out, float* __restrict__ lse, int sq, int sk,
                     int heads) {
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
    tile_logits<HD>(q_s, k_s, kLd, tx, ty, logit);

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
    // every lane of the row holds the same m and l after the row reductions
    if (lse != nullptr && tx == 0)
      lse[((long long)b * heads + head) * sq + s] = m[i] + logf(l[i]);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* pad, void* out,
           void* lse, int batch, int sq, int sk, int heads, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, heads, batch);
  attention_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(pad), static_cast<T*>(out), static_cast<float*>(lse),
      sq, sk, heads);
  return (int)cudaGetLastError();
}

// The bf16 forward on the tensor cores (FlashAttention-2 on mma.sync).  One
// block of 4 warps per (64-query tile, head, batch); warp w owns query rows
// [16 w, 16 w + 16).  The Q tile stays in shared memory; K and V tiles of 64
// keys stream through a 2-stage cp.async ring, the next tile in flight while
// the current one is used.  Per key tile a warp computes S = Q K^T (32 mma),
// takes the online softmax in registers (row max and sum across the 4 lanes
// of a quad; every lane keeps a partial row sum), rounds P to bf16 in
// registers as the A operand of O += P V (32 mma, V through ldmatrix.trans),
// and never writes P to shared memory.  Logits, softmax and sums are fp32
// (exp through the hardware's exp2, attention_common.cuh); the roundings are
// the CUDA-core kernel's: P before P V, O at the store.  kResid adds the
// low part's product into o_lo and writes the residual r of the output.
template <bool kResid>
__global__ void __launch_bounds__(kMmaThreads)
attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ pad,
                         __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                         __nv_bfloat16* __restrict__ resid, int sq, int sk, int heads) {
  __shared__ __align__(16) __nv_bfloat16 q_s[kTileElems];
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kTileElems];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kTileElems];

  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kMmaRows;
  const int head = blockIdx.y;
  const int b = blockIdx.z;

  const long long row = (long long)heads * kMmaHd;  // elements between tokens
  const __nv_bfloat16* q_b = q + (long long)b * sq * row + (long long)head * kMmaHd;
  const __nv_bfloat16* k_b = k + (long long)b * sk * row + (long long)head * kMmaHd;
  const __nv_bfloat16* v_b = v + (long long)b * sk * row + (long long)head * kMmaHd;
  const uint8_t* pad_b = pad ? pad + (long long)b * sk : nullptr;

  load_tile_async(q_s, q_b, row, q0, sq, tid);
  load_tile_async(k_s[0], k_b, row, 0, sk, tid);
  load_tile_async(v_s[0], v_b, row, 0, sk, tid);
  cp_async_commit();

  // rows r0 + g (index 0) and r0 + g + 8 (index 1) of the tile, g = lane / 4
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[8][4], o_lo[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = o_lo[n][e] = 0.f;

  const int n_tiles = (sk + kMmaRows - 1) / kMmaRows;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {  // the stage read in iteration j - 1; all reads are done
      load_tile_async(k_s[st ^ 1], k_b, row, (j + 1) * kMmaRows, sk, tid);
      load_tile_async(v_s[st ^ 1], v_b, row, (j + 1) * kMmaRows, sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and Q) have landed
    __syncthreads();

    float s[8][4];
    tile_product_nk(s, q_s, r0, k_s[st], lane);

    // Keys past Sk are left out (-inf); padded keys get the TPU kernel's
    // -1e30.  Every tile starts with an in-range key, so each row's tile
    // max is finite and exp() below never sees inf - inf.
    const int k0 = j * kMmaRows;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + n * 8 + 2 * t + c;
        if (key >= sk) {
          s[n][c] = s[n][c + 2] = -INFINITY;
        } else if (pad_b != nullptr && pad_b[key] != 0) {
          s[n][c] = s[n][c + 2] = kPadLogit;
        }
      }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        tile_max = fmaxf(tile_max, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
      const float m_new = fmaxf(m[h], tile_max);
      const float m2 = exp_arg(m_new);
      const float alpha = exp_sub(m[h], m2);  // 0 on the first tile
      float tile_sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp_sub(s[n][2 * h + c], m2);
          s[n][2 * h + c] = p;
          tile_sum += p;
          o[n][2 * h + c] *= alpha;
          if (kResid) o_lo[n][2 * h + c] *= alpha;
        }
      l[h] = l[h] * alpha + tile_sum;  // this lane's part of the row sum
      m[h] = m_new;
    }

    tile_product_kn(o, s, v_s[st], lane);  // O += round(P) V
    if (kResid) {
      // the low part P - round(P), exact in fp32; the product rounds it
      float lo[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          lo[n][e] = s[n][e] - __bfloat162float(__float2bfloat16_rn(s[n][e]));
      tile_product_kn(o_lo, lo, v_s[st], lane);  // O_lo += round(P - round(P)) V
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  // q_s rows [r0, r0 + 16) were read by this warp alone
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const long long at = (long long)b * sq * row + (long long)head * kMmaHd;
  store_rows(o, inv[0], inv[1], q_s, r0, out + at, row, q0, sq, lane);
  if (kResid) {
    // r = (O_hi + O_lo) / l - round(O_hi / l), the same out as stored above
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = o[n][e] * inv[e >> 1];
        o_lo[n][e] = (o[n][e] + o_lo[n][e]) * inv[e >> 1] -
                     __bfloat162float(__float2bfloat16_rn(x));
      }
    __syncwarp();  // every lane has copied its out rows out of the staging tile
    store_rows(o_lo, 1.f, 1.f, q_s, r0, resid + at, row, q0, sq, lane);
  }
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = q0 + r0 + (lane >> 2) + 8 * h;
      if (s < sq) lse[((long long)b * heads + head) * sq + s] = m[h] + logf(l[h]);
    }
  }
}

int launch_mma(const void* q, const void* k, const void* v, const void* pad, void* out,
               void* lse, void* resid, int batch, int sq, int sk, int heads,
               cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const dim3 grid((sq + kMmaRows - 1) / kMmaRows, heads, batch);
  auto kernel = resid != nullptr ? attention_fwd_mma_kernel<true>
                                 : attention_fwd_mma_kernel<false>;
  kernel<<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(pad), static_cast<bf16*>(out), static_cast<float*>(lse),
      static_cast<bf16*>(resid), sq, sk, heads);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  pad may be null (no padded keys); lse
// (float32 [B, H, Sq]) may be null (not written); resid ([B, Sq, H, HD] in
// bf16, the output's residual for the backward) may be null (not written), and
// must be null in float32.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int simvg_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* pad, void* out, void* lse, void* resid,
                                   int batch, int sq, int sk, int heads, int head_dim,
                                   int dtype, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || heads <= 0 || heads > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // head_dim is a template parameter; 64 is every shipped config's
  if (dtype == 0 && head_dim == 64 && resid == nullptr)
    return launch<float, 64>(q, k, v, pad, out, lse, batch, sq, sk, heads, s);
  if (dtype == 1 && head_dim == 64) {
    // 16-byte cp.async loads and stores
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out | (uintptr_t)resid) & 15)
      return (int)cudaErrorMisalignedAddress;
    return launch_mma(q, k, v, pad, out, lse, resid, batch, sq, sk, heads, s);
  }
  return (int)cudaErrorInvalidValue;
}
