// Fused multi-head attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_bwd_kernel` of simvg_tpu/ops/pallas_attention.py
// (called by `_attention_flat_bwd`, the custom VJP of `fused_attention`).  Given
// q (already scaled by head_dim^-0.5), k, v, the forward's out, its cotangent dO,
// the forward's per-row log-sum-exp lse (attention_fwd.cu) and the key padding
// mask, it computes per (batch, head)
//     P  = exp(q k^T + pad_bias - lse)              fp32, recomputed
//     dV = round(P)^T dO
//     dP = dO V^T
//     dS = P * (dP - D),  D = rowsum(dO * out)       fp32
//     dQ = round(dS) K,   dK = round(dS)^T q
// with every sum in fp32, round() the cast to the input type at the places the
// TPU kernel casts (its p_c and dl_c), and dq/dk/dv stored in the input type.
// D equals the TPU kernel's rowsum(dP * P) in exact arithmetic (sum_j P_j dO.v_j
// = dO.out); in fp32 the two differ by summation order, in bf16 by the rounding
// of out.  Padded keys get the logit -1e30 as in the forward, so their P is 0
// and their dK/dV rows are exactly 0.  A batch row whose keys are all padded is
// outside the contract (its lse cannot tell -1e30 + log(Sk) from -1e30); the
// encoder never pads the CLS and image keys.
//
// Layout: as the forward, [B, S, H, HD] read in place; lse and D are
// [B, H, Sq] fp32.  The ragged ends of Sq and Sk are masked here.
//
// Design.  The TPU kernel runs the query blocks of a head in order on one core
// and carries dK/dV across them in its output block.  Hopper blocks run in
// parallel in no order, so this is a deterministic two-pass shape, no atomics:
//   (a) dsum_kernel: D for every query row (one warp a row);
//   (b) dkdv_kernel: one block per (64-key tile, head, batch) holds K_j, V_j in
//       shared memory, walks the 64-query tiles, recomputes P and dS and
//       accumulates dV_j and dK_j in fp32 registers;
//   (c) dq_kernel: one block per (64-query tile, head, batch) holds Q_i, dO_i,
//       walks the key tiles, recomputes P and dS and accumulates dQ_i.
// (b) and (c) both recompute S and dP: seven 64x64x64 products per tile pair
// where five would do, the price of having no cross-block reduction.
//
// What bounds it.  At the flagship's S = 421, HD = 64, the backward is
// ~10*B*H*S^2*HD FLOP (the TPU kernel's cost estimate) over ~6 [B,S,H,HD]
// tensors: compute-bound.  This first version runs its products on the CUDA
// cores in fp32 FMAs with the forward's 16x16-thread, 4x4-register tiling, so
// FMA issue and shared-memory reads bound it; mma.sync / wgmma are the next step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (simvg_tpu_torch/ops/_build.py); called through ctypes with a plain C ABI.

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace simvg;

constexpr int kRowsPerWarpBlock = 8;  // dsum_kernel: 8 warps, one row each

// (a) D[b, h, i] = sum_d dO[b, i, h, d] * out[b, i, h, d] in fp32.
template <typename T, int HD>
__global__ void __launch_bounds__(32 * kRowsPerWarpBlock)
dsum_kernel(const T* __restrict__ out, const T* __restrict__ dout,
            float* __restrict__ dsum, long long rows, int sq, int heads) {
  const long long r = (long long)blockIdx.x * kRowsPerWarpBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const T* o = out + r * HD;
  const T* g = dout + r * HD;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) acc = fmaf(to_float(g[d]), to_float(o[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    // r = (b * sq + i) * heads + h  ->  D[(b * heads + h) * sq + i]
    const long long h = r % heads, bi = r / heads;
    const long long b = bi / sq, i = bi % sq;
    dsum[(b * heads + h) * sq + i] = acc;
  }
}

// Loads rows [r0, r0 + 64) of one head of a [B, S, H, HD] tensor into a
// [64][ld] fp32 tile; rows past s are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, long long row,
                                          int r0, int s, int tid) {
  for (int i = tid; i < 64 * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, t = r0 + r;
    dst[r * ld + d] = t < s ? to_float(src[t * row + d]) : 0.f;
  }
}

// S and dP for one (query tile, key tile) pair, then P and dS in fp32:
// p[i][j] / ds[i][j] for query row ty + 16 i and key tx + 16 j of the tile.
// Rows past sq and keys past sk get P = dS = 0; padded keys the logit -1e30.
template <int HD>
__device__ __forceinline__ void tile_p_ds(const float* q_s, const float* k_s,
                                          const float* do_s, const float* v_s, int ld,
                                          const float* lse_s, const float* d_s,
                                          const uint8_t* pad_b, int q0, int k0, int sq,
                                          int sk, int tx, int ty,
                                          float (&p)[kRowsPerThread][kKeysPerThread],
                                          float (&ds)[kRowsPerThread][kKeysPerThread]) {
  tile_logits<HD>(q_s, k_s, ld, tx, ty, p);    // S, same order as the forward
  tile_logits<HD>(do_s, v_s, ld, tx, ty, ds);  // dP = dO V^T
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int key = k0 + tx + kThreadsX * j;
    const bool outside = key >= sk;
    const bool padded = !outside && pad_b != nullptr && pad_b[key] != 0;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty + kThreadsY * i;
      if (outside || q0 + r >= sq) {
        p[i][j] = 0.f;
        ds[i][j] = 0.f;
        continue;
      }
      const float logit = padded ? kPadLogit : p[i][j];
      const float pij = expf(logit - lse_s[r]);
      p[i][j] = pij;
      ds[i][j] = pij * (ds[i][j] - d_s[r]);
    }
  }
}

template <int HD>
constexpr size_t dkdv_smem_bytes() {
  // K, V, Q, dO tiles with stride HD + 1, the P and dS tiles, lse and D
  return sizeof(float) * (4 * 64 * (HD + 1) + 2 * kBlockQ * kLdP + 2 * kBlockQ);
}

// (b) dK_j, dV_j for one 64-key tile of one head.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ dsum, const uint8_t* __restrict__ pad,
            T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int heads) {
  static_assert(HD % kThreadsX == 0, "head_dim must be a multiple of 16");
  constexpr int kLd = HD + 1;
  constexpr int kCols = HD / kThreadsX;

  extern __shared__ float smem[];
  float* k_s = smem;                  // [kBlockK][kLd]
  float* v_s = k_s + kBlockK * kLd;   // [kBlockK][kLd]
  float* q_s = v_s + kBlockK * kLd;   // [kBlockQ][kLd]
  float* do_s = q_s + kBlockQ * kLd;  // [kBlockQ][kLd]
  float* p_s = do_s + kBlockQ * kLd;  // [kBlockQ][kLdP], round(P)
  float* ds_s = p_s + kBlockQ * kLdP; // [kBlockQ][kLdP], round(dS)
  float* lse_s = ds_s + kBlockQ * kLdP;
  float* d_s = lse_s + kBlockQ;

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsX;
  const int ty = tid / kThreadsX;
  const int k0 = blockIdx.x * kBlockK;
  const int head = blockIdx.y;
  const int b = blockIdx.z;

  const long long row = (long long)heads * HD;
  const long long q_off = (long long)b * sq * row + (long long)head * HD;
  const long long k_off = (long long)b * sk * row + (long long)head * HD;
  const float* lse_b = lse + ((long long)b * heads + head) * sq;
  const float* d_b = dsum + ((long long)b * heads + head) * sq;
  const uint8_t* pad_b = pad ? pad + (long long)b * sk : nullptr;

  load_tile<T, HD>(k_s, kLd, k + k_off, row, k0, sk, tid);
  load_tile<T, HD>(v_s, kLd, v + k_off, row, k0, sk, tid);

  // dV, dK for keys ty + 16 a and columns tx + 16 c
  float dv_acc[kKeysPerThread][kCols], dk_acc[kKeysPerThread][kCols];
#pragma unroll
  for (int a = 0; a < kKeysPerThread; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dv_acc[a][c] = dk_acc[a][c] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += kBlockQ) {
    __syncthreads();  // the last tile's reads of Q, dO, P, dS are done
    load_tile<T, HD>(q_s, kLd, q + q_off, row, q0, sq, tid);
    load_tile<T, HD>(do_s, kLd, dout + q_off, row, q0, sq, tid);
    if (tid < kBlockQ) {
      const bool in = q0 + tid < sq;
      lse_s[tid] = in ? lse_b[q0 + tid] : 0.f;
      d_s[tid] = in ? d_b[q0 + tid] : 0.f;
    }
    __syncthreads();

    float p[kRowsPerThread][kKeysPerThread], ds[kRowsPerThread][kKeysPerThread];
    tile_p_ds<HD>(q_s, k_s, do_s, v_s, kLd, lse_s, d_s, pad_b, q0, k0, sq, sk, tx, ty,
                  p, ds);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int at = (ty + kThreadsY * i) * kLdP + tx + kThreadsX * j;
        p_s[at] = round_to<T>(p[i][j]);
        ds_s[at] = round_to<T>(ds[i][j]);
      }
    __syncthreads();

    // dV_j += round(P)^T dO_i ; dK_j += round(dS)^T Q_i
#pragma unroll 4
    for (int r = 0; r < kBlockQ; ++r) {
      float pv[kKeysPerThread], dsv[kKeysPerThread], dov[kCols], qv[kCols];
#pragma unroll
      for (int a = 0; a < kKeysPerThread; ++a) {
        pv[a] = p_s[r * kLdP + ty + kThreadsY * a];
        dsv[a] = ds_s[r * kLdP + ty + kThreadsY * a];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dov[c] = do_s[r * kLd + tx + kThreadsX * c];
        qv[c] = q_s[r * kLd + tx + kThreadsX * c];
      }
#pragma unroll
      for (int a = 0; a < kKeysPerThread; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dv_acc[a][c] = fmaf(pv[a], dov[c], dv_acc[a][c]);
          dk_acc[a][c] = fmaf(dsv[a], qv[c], dk_acc[a][c]);
        }
    }
  }

#pragma unroll
  for (int a = 0; a < kKeysPerThread; ++a) {
    const int s = k0 + ty + kThreadsY * a;
    if (s >= sk) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const long long at = k_off + s * row + tx + kThreadsX * c;
      dv[at] = from_float<T>(dv_acc[a][c]);
      dk[at] = from_float<T>(dk_acc[a][c]);
    }
  }
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles with stride HD + 1, the dS tile, lse and D
  return sizeof(float) * (4 * 64 * (HD + 1) + kBlockQ * kLdP + 2 * kBlockQ);
}

// (c) dQ_i for one 64-query tile of one head.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dsum, const uint8_t* __restrict__ pad,
          T* __restrict__ dq, int sq, int sk, int heads) {
  static_assert(HD % kThreadsX == 0, "head_dim must be a multiple of 16");
  constexpr int kLd = HD + 1;
  constexpr int kCols = HD / kThreadsX;

  extern __shared__ float smem[];
  float* q_s = smem;                  // [kBlockQ][kLd]
  float* do_s = q_s + kBlockQ * kLd;  // [kBlockQ][kLd]
  float* k_s = do_s + kBlockQ * kLd;  // [kBlockK][kLd]
  float* v_s = k_s + kBlockK * kLd;   // [kBlockK][kLd]
  float* ds_s = v_s + kBlockK * kLd;  // [kBlockQ][kLdP], round(dS)
  float* lse_s = ds_s + kBlockQ * kLdP;
  float* d_s = lse_s + kBlockQ;

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsX;
  const int ty = tid / kThreadsX;
  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;

  const long long row = (long long)heads * HD;
  const long long q_off = (long long)b * sq * row + (long long)head * HD;
  const long long k_off = (long long)b * sk * row + (long long)head * HD;
  const float* lse_b = lse + ((long long)b * heads + head) * sq;
  const float* d_b = dsum + ((long long)b * heads + head) * sq;
  const uint8_t* pad_b = pad ? pad + (long long)b * sk : nullptr;

  load_tile<T, HD>(q_s, kLd, q + q_off, row, q0, sq, tid);
  load_tile<T, HD>(do_s, kLd, dout + q_off, row, q0, sq, tid);
  if (tid < kBlockQ) {
    const bool in = q0 + tid < sq;
    lse_s[tid] = in ? lse_b[q0 + tid] : 0.f;
    d_s[tid] = in ? d_b[q0 + tid] : 0.f;
  }

  // dQ for rows ty + 16 i and columns tx + 16 c
  float acc[kRowsPerThread][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += kBlockK) {
    __syncthreads();  // Q/dO are stored; the last tile's K and dS reads are done
    load_tile<T, HD>(k_s, kLd, k + k_off, row, k0, sk, tid);
    load_tile<T, HD>(v_s, kLd, v + k_off, row, k0, sk, tid);
    __syncthreads();

    float p[kRowsPerThread][kKeysPerThread], ds[kRowsPerThread][kKeysPerThread];
    tile_p_ds<HD>(q_s, k_s, do_s, v_s, kLd, lse_s, d_s, pad_b, q0, k0, sq, sk, tx, ty,
                  p, ds);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        ds_s[(ty + kThreadsY * i) * kLdP + tx + kThreadsX * j] = round_to<T>(ds[i][j]);
    __syncthreads();

    // dQ_i += round(dS) K_j
#pragma unroll 4
    for (int key = 0; key < kBlockK; ++key) {
      float dsv[kRowsPerThread], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) dsv[i] = ds_s[(ty + kThreadsY * i) * kLdP + key];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = k_s[key * kLd + tx + kThreadsX * c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int s = q0 + ty + kThreadsY * i;
    if (s >= sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      dq[q_off + s * row + tx + kThreadsX * c] = from_float<T>(acc[i][c]);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const void* lse, const void* pad, void* dsum, void* dq,
           void* dk, void* dv, int batch, int sq, int sk, int heads,
           cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const uint8_t* pad_ = static_cast<const uint8_t*>(pad);
  float* dsum_ = static_cast<float*>(dsum);

  const long long rows = (long long)batch * sq * heads;
  const long long blocks = (rows + kRowsPerWarpBlock - 1) / kRowsPerWarpBlock;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dsum_kernel<T, HD><<<(unsigned)blocks, 32 * kRowsPerWarpBlock, 0, stream>>>(
      static_cast<const T*>(out), do_, dsum_, rows, sq, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t smem_kv = dkdv_smem_bytes<HD>();
  err = cudaFuncSetAttribute(dkdv_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((sk + kBlockK - 1) / kBlockK, heads, batch);
  dkdv_kernel<T, HD><<<grid_kv, kThreads, smem_kv, stream>>>(
      q_, k_, v_, do_, lse_, dsum_, pad_, static_cast<T*>(dk), static_cast<T*>(dv), sq,
      sk, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t smem_q = dq_smem_bytes<HD>();
  err = cudaFuncSetAttribute(dq_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((sq + kBlockQ - 1) / kBlockQ, heads, batch);
  dq_kernel<T, HD><<<grid_q, kThreads, smem_q, stream>>>(
      q_, k_, v_, do_, lse_, dsum_, pad_, static_cast<T*>(dq), sq, sk, heads);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/dq and out/dout [B, Sq, H, HD], k/v/dk/dv
// [B, Sk, H, HD] in that dtype; lse (from simvg_attention_fwd) and the scratch
// dsum float32 [B, H, Sq]; pad uint8 [B, Sk] (1 = padded) or null.
// Launches three kernels on `stream` and returns the first CUDA error (0 if none).
extern "C" int simvg_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const void* lse,
                                   const void* pad, void* dsum, void* dq, void* dk,
                                   void* dv, int batch, int sq, int sk, int heads,
                                   int head_dim, int dtype, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || heads <= 0 || heads > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, out, dout, lse, pad, dsum, dq, dk, dv, batch, sq,
                             sk, heads, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, dout, lse, pad, dsum, dq, dk, dv,
                                     batch, sq, sk, heads, s);
  return (int)cudaErrorInvalidValue;
}
