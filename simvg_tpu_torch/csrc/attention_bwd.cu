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
//     dS = P * (dP - D),  D = rowsum(dP * P)         fp32
//     dQ = round(dS) K,   dK = round(dS)^T q
// with every sum in fp32, round() the cast to the input type at the places the
// TPU kernel casts (its p_c and dl_c), and dq/dk/dv stored in the input type.
// Padded keys get the logit -1e30 as in the forward, so their P is 0 and their
// dK/dV rows are exactly 0.  A batch row whose keys are all padded is outside
// the contract (its lse cannot tell -1e30 + log(Sk) from -1e30); the encoder
// never pads the CLS and image keys.
//
// The row term D.  rowsum(dP * P) = sum_j P_j (dO . v_j) = dO . (sum_j P_j v_j),
// the product of dO with the forward's output before its rounding.  The fp32
// route takes D = rowsum(dO * out): out is that sum to fp32 order.  In bf16 the
// stored out is rounded, and rowsum(dO * round(out)) put dQ up to 8.8x further
// from float32 than the TPU kernel's formula on the flagship's trained weights
// (dS = P (dP - D) does not cancel an error in D).  So when a gradient is
// wanted the forward also writes the residual r = round(o - round(o)) of its
// fp32 output o = sum_j (round(P_j) + round(P_j - round(P_j))) v_j / l: P split
// into a bf16 high and low part, so that o carries P unrounded to ~2^-17.
// Then D = rowsum(dO * (out + r)) in fp32 matches rowsum(dP * P) within 1% of
// its error from float64 even on peaked attention (one bf16 part, round(P)
// alone, was 2.3-2.5x further off there).
//
// Layout: as the forward, [B, S, H, HD] read in place; lse and D are
// [B, H, Sq] fp32.  The ragged ends of Sq and Sk are masked here.
//
// The TPU kernel runs the query blocks of a head in order on one core and
// carries dK/dV across them in its output block.  Hopper blocks run in
// parallel in no order, so this is a deterministic two-kernel shape with no
// atomics: every output element is written by one block, from sums taken in a
// fixed order.
//
// Two routes, chosen by dtype in the C entry point.
//
// fp32, the parity route, on the CUDA cores in fp32 FMAs with the forward's
// 16x16-thread, 4x4-register tiling (TF32 would break the fp32 bounds):
//   (a) dsum_kernel: D = rowsum(dO * out), one warp a row;
//   (b) dkdv_kernel: one block per (64-key tile, head, batch) holds K_j, V_j,
//       walks the 64-query tiles and accumulates dV_j, dK_j;
//   (c) dq_kernel: one block per (64-query tile, head, batch) holds Q_i, dO_i,
//       walks the key tiles and accumulates dQ_i.
//   HD 32 to 128; at 256 and above dkdv_split_kernel and dq_split_kernel, in
//   64-column chunks (the whole tiles would exceed 227 KB).
//
// bf16, on Hopper's warpgroup tensor-core product (attention_sm90.cuh):
//   (a) dsum_kernel: D = rowsum(dO * (out + r)), HD / 8 lanes a row,
//       16-byte loads; it reads three [B, S, H, HD] bf16 tensors and writes
//       D.
//   (b) dq_wgmma_kernel: one block per (64-query tile, head, batch): S = Q K^T,
//       dP = dO V^T and dQ += round(dS) K, 3 products a key tile.
//   (c) dkdv_wgmma_kernel: one block per (64-key tile, head, batch): S^T =
//       K Q^T, dP^T = V dO^T, dV += round(P^T) dO and dK += round(dS^T) Q, 4
//       products a query tile.
// A block of (b) or (c) is one consumer warpgroup and one producer warp.  The
// producer issues TMA loads of 64-row boxes straight from [B, S, H, HD] into
// a 2-stage ring in wgmma's swizzle, each stage guarded by a full and an
// empty mbarrier; TMA zero-fills the rows past S.  The consumers run every
// product as wgmma.mma_async on shared-memory descriptors (attention_sm90.cuh,
// Geom<HD>; instantiated at HD 32, 64, 128 and 256, where dQ and dK/dV are
// produced in two 128-column chunks a tile, kOC; above 256 the column-split
// route of dq_split_kernel and dkdv_split_kernel); P and dS
// go from the fp32 accumulators of the first products to the A operands of the
// next in registers, rounded to bf16 on the way.  The results leave through
// shared memory and a TMA store, which drops the rows past S.
//
// What bounds it.  At the flagship's S = 421, HD = 64 the backward is
// ~10*B*H*S^2*HD FLOP (the TPU kernel's cost estimate; 43.6 GFLOP at B = 32)
// over 8 [B,S,H,HD] tensors read or written once (~166 MB in bf16): 0.044 ms
// of tensor-core work against 0.050 ms of memory traffic, so the card's bound
// is the bytes; the residual r is a ninth tensor that this design reads (and
// the forward writes) in exchange for the first pass over the key tiles that
// the previous mma.sync design spent on D.  Each block recomputes S and dP
// (7 tile products a (query, key) tile pair where 5 would do, the price of
// having no cross-block reduction); each 64-row tile is read once per block
// from L2 by TMA, with no per-warp fragment reloads from shared memory; and
// the exp of every score runs on the multi-function unit between the products.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (simvg_tpu_torch/ops/_build.py); called through ctypes with a plain C ABI.

#include <math.h>

#include "attention_common.cuh"
#include "attention_sm90.cuh"

namespace {

using namespace simvg;

constexpr int kRowsPerWarpBlock = 8;  // dsum_kernel: 8 warps, one row each

// (a) D[b, h, i] = sum_d dO[b, i, h, d] * out[b, i, h, d] in fp32.
template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerWarpBlock)
dsum_kernel(const T* __restrict__ out, const T* __restrict__ dout,
            float* __restrict__ dsum, long long rows, int sq, int heads, int hd) {
  const long long r = (long long)blockIdx.x * kRowsPerWarpBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const T* o = out + r * hd;
  const T* g = dout + r * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_float(g[d]), to_float(o[d]), acc);
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
// finish_p_ds takes p = S and ds = dP as computed; tile_p_ds computes them.
__device__ __forceinline__ void finish_p_ds(const float* lse_s, const float* d_s,
                                            const uint8_t* pad_b, int q0, int k0, int sq,
                                            int sk, int tx, int ty,
                                            float (&p)[kRowsPerThread][kKeysPerThread],
                                            float (&ds)[kRowsPerThread][kKeysPerThread]) {
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
__device__ __forceinline__ void tile_p_ds(const float* q_s, const float* k_s,
                                          const float* do_s, const float* v_s, int ld,
                                          const float* lse_s, const float* d_s,
                                          const uint8_t* pad_b, int q0, int k0, int sq,
                                          int sk, int tx, int ty,
                                          float (&p)[kRowsPerThread][kKeysPerThread],
                                          float (&ds)[kRowsPerThread][kKeysPerThread]) {
  tile_logits<HD>(q_s, k_s, ld, tx, ty, p);    // S, same order as the forward
  tile_logits<HD>(do_s, v_s, ld, tx, ty, ds);  // dP = dO V^T
  finish_p_ds(lse_s, d_s, pad_b, q0, k0, sq, sk, tx, ty, p, ds);
}

// S and dP of a (query tile, key tile) pair over a head dim of any multiple of
// 64, 64 columns at a time through a_s and b_s (the fp32 split route), in
// tile_logits' order over the whole; then P and dS.  At the first chunk of
// dP, `at_first` loads the block's output-side chunks (it runs between the
// barriers, so the caller's earlier reads of them are done).
template <typename T, typename F>
__device__ __forceinline__ void split_p_ds(float* a_s, float* b_s, const T* q_b, const T* k_b,
                                           const T* v_b, const T* do_b, long long row, int hd,
                                           const float* lse_s, const float* d_s,
                                           const uint8_t* pad_b, int q0, int k0, int sq,
                                           int sk, int tid, int tx, int ty, F at_first,
                                           float (&p)[kRowsPerThread][kKeysPerThread],
                                           float (&ds)[kRowsPerThread][kKeysPerThread]) {
  constexpr int kLd = 65;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) p[i][j] = ds[i][j] = 0.f;
  for (int x0 = 0; x0 < hd; x0 += 64) {
    __syncthreads();
    load_chunk(a_s, kLd, q_b, row, q0, x0, sq, tid);
    load_chunk(b_s, kLd, k_b, row, k0, x0, sk, tid);
    __syncthreads();
    tile_logits_acc<64>(a_s, b_s, kLd, tx, ty, p);
  }
  for (int x0 = 0; x0 < hd; x0 += 64) {
    __syncthreads();
    load_chunk(a_s, kLd, do_b, row, q0, x0, sq, tid);
    load_chunk(b_s, kLd, v_b, row, k0, x0, sk, tid);
    if (x0 == 0) at_first();
    __syncthreads();
    tile_logits_acc<64>(a_s, b_s, kLd, tx, ty, ds);
  }
  finish_p_ds(lse_s, d_s, pad_b, q0, k0, sq, sk, tx, ty, p, ds);
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
  dsum_kernel<T><<<(unsigned)blocks, 32 * kRowsPerWarpBlock, 0, stream>>>(
      static_cast<const T*>(out), do_, dsum_, rows, sq, heads, HD);
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


// ---- fp32 at head dim 256 and above: the column-split route ---------------
//
// The whole-tile kernels above would hold four 64 x (HD + 1) fp32 tiles, 263
// KB at HD 256.  Here a block produces a 64-column chunk of dQ (or of dK and
// dV) and takes S and dP over the head dim 64 columns at a time
// (split_p_ds), in the forward's summation order: the same logits, bit for
// bit.  Shared memory: 66 KB (dQ) and 100 KB (dK/dV) at any head dim.
constexpr int kSplitCols = 64;
constexpr int kSplitLd = kSplitCols + 1;

constexpr size_t dq_split_smem_bytes() {
  return sizeof(float) * (3 * 64 * kSplitLd + kBlockQ * kLdP + 2 * kBlockQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dq_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ dsum, const uint8_t* __restrict__ pad,
                T* __restrict__ dq, int sq, int sk, int heads, int hd) {
  constexpr int kCols = kSplitCols / kThreadsX;
  extern __shared__ float smem[];
  float* a_s = smem;                    // [64][kSplitLd]
  float* b_s = a_s + 64 * kSplitLd;     // [64][kSplitLd]
  float* kc_s = b_s + 64 * kSplitLd;    // [64][kSplitLd], K_j's chunk c
  float* ds_s = kc_s + 64 * kSplitLd;   // [kBlockQ][kLdP], round(dS)
  float* lse_s = ds_s + kBlockQ * kLdP;
  float* d_s = lse_s + kBlockQ;

  const int tid = threadIdx.x, tx = tid % kThreadsX, ty = tid / kThreadsX;
  const int n_chunks = hd / kSplitCols;
  const int q0 = blockIdx.x * kBlockQ, b = blockIdx.z;
  const int head = blockIdx.y / n_chunks, col0 = (blockIdx.y % n_chunks) * kSplitCols;
  const long long row = (long long)heads * hd;
  const long long q_off = (long long)b * sq * row + (long long)head * hd;
  const long long k_off = (long long)b * sk * row + (long long)head * hd;
  const float* lse_b = lse + ((long long)b * heads + head) * sq;
  const float* d_b = dsum + ((long long)b * heads + head) * sq;
  const uint8_t* pad_b = pad ? pad + (long long)b * sk : nullptr;

  if (tid < kBlockQ) {
    const bool in = q0 + tid < sq;
    lse_s[tid] = in ? lse_b[q0 + tid] : 0.f;
    d_s[tid] = in ? d_b[q0 + tid] : 0.f;
  }
  float acc[kRowsPerThread][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += kBlockK) {
    float p[kRowsPerThread][kKeysPerThread], ds[kRowsPerThread][kKeysPerThread];
    split_p_ds(a_s, b_s, q + q_off, k + k_off, v + k_off, dout + q_off, row, hd, lse_s, d_s,
               pad_b, q0, k0, sq, sk, tid, tx, ty,
               [&] { load_chunk(kc_s, kSplitLd, k + k_off, row, k0, col0, sk, tid); }, p, ds);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        ds_s[(ty + kThreadsY * i) * kLdP + tx + kThreadsX * j] = round_to<T>(ds[i][j]);
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < kBlockK; ++key) {
      float dsv[kRowsPerThread], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) dsv[i] = ds_s[(ty + kThreadsY * i) * kLdP + key];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = kc_s[key * kSplitLd + tx + kThreadsX * c];
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
      dq[q_off + s * row + col0 + tx + kThreadsX * c] = from_float<T>(acc[i][c]);
  }
}

constexpr size_t dkdv_split_smem_bytes() {
  return sizeof(float) * (4 * 64 * kSplitLd + 2 * kBlockQ * kLdP + 2 * kBlockQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dkdv_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ dsum, const uint8_t* __restrict__ pad,
                  T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int heads, int hd) {
  constexpr int kCols = kSplitCols / kThreadsX;
  extern __shared__ float smem[];
  float* a_s = smem;                    // [64][kSplitLd]
  float* b_s = a_s + 64 * kSplitLd;     // [64][kSplitLd]
  float* doc_s = b_s + 64 * kSplitLd;   // [64][kSplitLd], dO_i's chunk c
  float* qc_s = doc_s + 64 * kSplitLd;  // [64][kSplitLd], Q_i's chunk c
  float* p_s = qc_s + 64 * kSplitLd;    // [kBlockQ][kLdP], round(P)
  float* ds_s = p_s + kBlockQ * kLdP;   // [kBlockQ][kLdP], round(dS)
  float* lse_s = ds_s + kBlockQ * kLdP;
  float* d_s = lse_s + kBlockQ;

  const int tid = threadIdx.x, tx = tid % kThreadsX, ty = tid / kThreadsX;
  const int n_chunks = hd / kSplitCols;
  const int k0 = blockIdx.x * kBlockK, b = blockIdx.z;
  const int head = blockIdx.y / n_chunks, col0 = (blockIdx.y % n_chunks) * kSplitCols;
  const long long row = (long long)heads * hd;
  const long long q_off = (long long)b * sq * row + (long long)head * hd;
  const long long k_off = (long long)b * sk * row + (long long)head * hd;
  const float* lse_b = lse + ((long long)b * heads + head) * sq;
  const float* d_b = dsum + ((long long)b * heads + head) * sq;
  const uint8_t* pad_b = pad ? pad + (long long)b * sk : nullptr;

  float dv_acc[kKeysPerThread][kCols], dk_acc[kKeysPerThread][kCols];
#pragma unroll
  for (int a = 0; a < kKeysPerThread; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dv_acc[a][c] = dk_acc[a][c] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += kBlockQ) {
    __syncthreads();  // the last tile's reads of lse, D, P, dS are done
    if (tid < kBlockQ) {
      const bool in = q0 + tid < sq;
      lse_s[tid] = in ? lse_b[q0 + tid] : 0.f;
      d_s[tid] = in ? d_b[q0 + tid] : 0.f;
    }
    float p[kRowsPerThread][kKeysPerThread], ds[kRowsPerThread][kKeysPerThread];
    split_p_ds(a_s, b_s, q + q_off, k + k_off, v + k_off, dout + q_off, row, hd, lse_s, d_s,
               pad_b, q0, k0, sq, sk, tid, tx, ty,
               [&] {
                 load_chunk(doc_s, kSplitLd, dout + q_off, row, q0, col0, sq, tid);
                 load_chunk(qc_s, kSplitLd, q + q_off, row, q0, col0, sq, tid);
               },
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
        dov[c] = doc_s[r * kSplitLd + tx + kThreadsX * c];
        qv[c] = qc_s[r * kSplitLd + tx + kThreadsX * c];
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
      const long long at = k_off + s * row + col0 + tx + kThreadsX * c;
      dv[at] = from_float<T>(dv_acc[a][c]);
      dk[at] = from_float<T>(dk_acc[a][c]);
    }
  }
}

template <typename T>
int launch_split(const void* q, const void* k, const void* v, const void* out,
                 const void* dout, const void* lse, const void* pad, void* dsum, void* dq,
                 void* dk, void* dv, int batch, int sq, int sk, int heads, int hd,
                 cudaStream_t stream) {
  const int n_chunks = hd / kSplitCols;
  if (hd % kSplitCols != 0 || (long long)heads * n_chunks > 65535)
    return (int)cudaErrorInvalidValue;
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
  dsum_kernel<T><<<(unsigned)blocks, 32 * kRowsPerWarpBlock, 0, stream>>>(
      static_cast<const T*>(out), do_, dsum_, rows, sq, heads, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(dkdv_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkdv_split_smem_bytes());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((sk + kBlockK - 1) / kBlockK, heads * n_chunks, batch);
  dkdv_split_kernel<T><<<grid_kv, kThreads, dkdv_split_smem_bytes(), stream>>>(
      q_, k_, v_, do_, lse_, dsum_, pad_, static_cast<T*>(dk), static_cast<T*>(dv), sq, sk,
      heads, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(dq_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_split_smem_bytes());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((sq + kBlockQ - 1) / kBlockQ, heads * n_chunks, batch);
  dq_split_kernel<T><<<grid_q, kThreads, dq_split_smem_bytes(), stream>>>(
      q_, k_, v_, do_, lse_, dsum_, pad_, static_cast<T*>(dq), sq, sk, heads, hd);
  return (int)cudaGetLastError();
}

// ---- bf16 on Hopper: TMA and wgmma ----------------------------------------

namespace hopper {

using namespace simvg::sm90;
using bf16 = __nv_bfloat16;

constexpr int kStages = 2;                         // the ring of streamed tiles
constexpr int kThreads = kWarpgroup + 32;          // consumers + the producer warp
constexpr int kProducerWarp = kWarpgroup / 32;     // warp 4
constexpr int kDsumThreads = 256;

// (a) D[b, h, i] = sum_d dO[b, i, h, d] * (out + r)[b, i, h, d] in fp32, out + r
// formed in fp32.  HD / 8 lanes a row, 8 elements (16 bytes) each.
template <int HD>
__global__ void __launch_bounds__(kDsumThreads)
dsum_kernel(const bf16* __restrict__ out, const bf16* __restrict__ resid,
            const bf16* __restrict__ dout, float* __restrict__ dsum, long long rows, int sq,
            int heads) {
  constexpr int kLanes = HD / 8;
  constexpr int kRowsPerBlock = kDsumThreads / kLanes;
  const long long r = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  const int part = threadIdx.x % kLanes;
  float acc = 0.f;
  if (r < rows) {
    const long long at = r * HD + part * 8;
    const uint4 o4 = *reinterpret_cast<const uint4*>(out + at);
    const uint4 r4 = *reinterpret_cast<const uint4*>(resid + at);
    const uint4 g4 = *reinterpret_cast<const uint4*>(dout + at);
    const bf16* o = reinterpret_cast<const bf16*>(&o4);
    const bf16* rr = reinterpret_cast<const bf16*>(&r4);
    const bf16* g = reinterpret_cast<const bf16*>(&g4);
#pragma unroll
    for (int d = 0; d < 8; ++d)
      acc = fmaf(__bfloat162float(g[d]), __bfloat162float(o[d]) + __bfloat162float(rr[d]), acc);
  }
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && part == 0) {
    // r = (b * sq + i) * heads + h  ->  D[(b * heads + h) * sq + i]
    const long long h = r % heads, bi = r / heads;
    const long long b = bi / sq, i = bi % sq;
    dsum[(b * heads + h) * sq + i] = acc;
  }
}

// The output columns a block of (b) or (c) produces: all of them up to HD
// 128; at HD 256 a chunk of 128, so that dQ (64 registers) and dK with dV
// (128) are held as at HD 128 while S and dP are taken over the whole head
// dim (2 blocks a tile, each computing them).
template <int HD>
constexpr int kOC = HD == 256 ? 128 : HD;

// (b) dQ_i (a chunk of its columns) for one 64-query tile of one head.
// Shared memory: Q_i, dO_i, and kStages stages of K_j, V_j; the barriers
// after them (HD 256: 4 + 4 x 32 KB = 193 KB).
template <int HD>
struct DqLayout {
  static constexpr int kBytes = (2 + 2 * kStages) * Geom<HD>::kTileBytes;
  static constexpr size_t kSmem = kBytes + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kSmem <= 232448, "above the 227 KB of shared memory a block may use");
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ lse,
                const float* __restrict__ dsum, const uint8_t* __restrict__ pad, int sq,
                int sk, int heads) {
  constexpr int OC = kOC<HD>, kChunks = HD / OC;
  using G = Geom<OC>;  // dQ's chunk
  constexpr int kTileBytes = Geom<HD>::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  char* smem = aligned_smem(smem_raw);
  char* q_s = smem;
  char* do_s = q_s + kTileBytes;
  char* k_s = do_s + kTileBytes;                // [kStages][kTileBytes]
  char* v_s = k_s + kStages * kTileBytes;       // [kStages][kTileBytes]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + DqLayout<HD>::kBytes);
  uint64_t* q_bar = bars;                       // Q_i and dO_i have landed
  uint64_t* full = bars + 1;                    // stage s has landed
  uint64_t* empty = bars + 1 + kStages;         // stage s is free

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kRows, b = blockIdx.z;
  const int head = blockIdx.y / kChunks, chunk = blockIdx.y % kChunks;
  const int n_tiles = (sk + kRows - 1) / kRows;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarpgroup);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      mbar_arrive_expect_tx(q_bar, 2 * kTileBytes);
      tma_load_tile<HD>(q_s, &tm_q, q_bar, head, q0, b);
      tma_load_tile<HD>(do_s, &tm_do, q_bar, head, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(&empty[st], ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * kTileBytes);
        tma_load_tile<HD>(k_s + st * kTileBytes, &tm_k, &full[st], head, j * kRows, b);
        tma_load_tile<HD>(v_s + st * kTileBytes, &tm_v, &full[st], head, j * kRows, b);
      }
    }
    return;
  }

  // rows q0 + 16 warp + g (index 0) and + 8 (index 1); lse and D 0 past Sq
  const int g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * heads + head;
  float lse2[2], d_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = q0 + 16 * warp + g + 8 * h;
    lse2[h] = exp_arg(s < sq ? lse[bh * sq + s] : 0.f);
    d_r[h] = s < sq ? dsum[bh * sq + s] : 0.f;
  }
  const uint8_t* pad_b = pad ? pad + (long long)b * sk : nullptr;

  typename G::Acc acc;
#pragma unroll
  for (int x = 0; x < G::kBoxes; ++x)
#pragma unroll
    for (int i = 0; i < G::kAccFloats; ++i) acc[x][i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const char* kt = k_s + st * kTileBytes;
    mbar_wait(&full[st], (j / kStages) & 1);

    float s[32], dp[32];
    wgmma_fence();
    product_nt<HD>(s, q_s, kt);                       // S = Q K^T
    product_nt<HD>(dp, do_s, v_s + st * kTileBytes);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);

    // P from lse; dS = P (dP - D) in place of dP.  Keys past Sk get P = 0,
    // padded keys the logit -1e30.
    const int k0 = j * kRows;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * n + 2 * t + c;
        const bool outside = key >= sk;
        const bool padded = !outside && pad_b != nullptr && pad_b[key] != 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * n + 2 * h + c;
          const float pe = outside ? 0.f : exp_sub(padded ? kPadLogit : s[e], lse2[h]);
          dp[e] = pe * (dp[e] - d_r[h]);
        }
      }

    fence_acc(acc);
    product_pn<OC>(acc, dp, kt + chunk * G::kTileBytes);  // dQ_c += round(dS) K_c
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive(&empty[st]);
  }

  // Q_i's tile is free once every consumer is past its last product
  named_barrier(1, kWarpgroup);
  acc_to_tile<OC>(q_s, acc, warp, lane);
  fence_proxy_async();
  named_barrier(1, kWarpgroup);
  if (tid == 0) {
    tma_store_tile<OC>(&tm_dq, q_s, head, q0, b, chunk * OC);
    tma_store_commit_and_wait();
  }
}

// (c) dK_j, dV_j for one 64-key tile of one head.  The consumers compute the
// transposed products S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T sit
// in registers as the A operands of dV += round(P^T) dO and dK += round(dS^T) Q.
// lse and D are per column there: the producer warp copies them beside each
// query tile (zeros past Sq, where the zero-filled Q and dO rows make every
// term vanish).  Shared memory: K_j, V_j, kStages stages of Q_i, dO_i, and of
// lse_i, D_i; the barriers after them.  At HD 128 the two dK/dV accumulators
// take 128 registers a thread: one warpgroup holds both (no register cap: at
// most 255 a thread, one block an SM), where splitting the head dim over two
// warpgroups would compute S^T and dP^T twice.  At HD 256 both accumulators
// would take 256: the blocks split dK's and dV's columns in two chunks
// (kOC), each taking S^T and dP^T over the whole head dim (193 KB of shared
// memory: K, V and 2 stages of Q, dO at 32 KB a tile).
template <int HD>
struct DkdvLayout {
  static constexpr int kTiles = (2 + 2 * kStages) * Geom<HD>::kTileBytes;
  static constexpr int kBytes = kTiles + 2 * kStages * kRows * 4;
  static constexpr size_t kSmem = kBytes + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kSmem <= 232448, "above the 227 KB of shared memory a block may use");
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_dk,
                  const __grid_constant__ CUtensorMap tm_dv, const float* __restrict__ lse,
                  const float* __restrict__ dsum, const uint8_t* __restrict__ pad, int sq,
                  int sk, int heads) {
  constexpr int OC = kOC<HD>, kChunks = HD / OC;
  using G = Geom<OC>;  // dK's and dV's chunk
  using L = DkdvLayout<HD>;
  constexpr int kTileBytes = Geom<HD>::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  char* smem = aligned_smem(smem_raw);
  char* k_s = smem;
  char* v_s = k_s + kTileBytes;
  char* q_s = v_s + kTileBytes;                 // [kStages][kTileBytes]
  char* do_s = q_s + kStages * kTileBytes;      // [kStages][kTileBytes]
  float* lse_s = reinterpret_cast<float*>(smem + L::kTiles);  // [kStages][kRows]
  float* d_s = lse_s + kStages * kRows;                       // [kStages][kRows]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBytes);
  uint64_t* kv_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * kRows, b = blockIdx.z;
  const int head = blockIdx.y / kChunks, chunk = blockIdx.y % kChunks;
  const int n_tiles = (sq + kRows - 1) / kRows;
  const long long bh = (long long)b * heads + head;

  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer's 32 lanes; lane 0's brings the bytes
      mbar_init(&empty[s], kWarpgroup);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_bar, 2 * kTileBytes);
      tma_load_tile<HD>(k_s, &tm_k, kv_bar, head, k0, b);
      tma_load_tile<HD>(v_s, &tm_v, kv_bar, head, k0, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
      for (int c = lane; c < kRows; c += 32) {
        const int s = i * kRows + c;
        lse_s[st * kRows + c] = s < sq ? lse[bh * sq + s] : 0.f;
        d_s[st * kRows + c] = s < sq ? dsum[bh * sq + s] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], 2 * kTileBytes);
        tma_load_tile<HD>(q_s + st * kTileBytes, &tm_q, &full[st], head, i * kRows, b);
        tma_load_tile<HD>(do_s + st * kTileBytes, &tm_do, &full[st], head, i * kRows, b);
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // keys k0 + 16 warp + g (index 0) and + 8 (index 1)
  const int g = lane >> 2, t = lane & 3;
  bool padded[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 16 * warp + g + 8 * h;
    padded[h] = pad != nullptr && key < sk && pad[(long long)b * sk + key] != 0;
  }

  typename G::Acc acc_dv, acc_dk;
#pragma unroll
  for (int x = 0; x < G::kBoxes; ++x)
#pragma unroll
    for (int i = 0; i < G::kAccFloats; ++i) acc_dv[x][i] = acc_dk[x][i] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const char* qt = q_s + st * kTileBytes;
    const char* dot = do_s + st * kTileBytes;
    mbar_wait(&full[st], (i / kStages) & 1);

    float s[32], dp[32];
    wgmma_fence();
    product_nt<HD>(s, k_s, qt);    // S^T = K Q^T
    product_nt<HD>(dp, v_s, dot);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);

    const float* lse_t = lse_s + st * kRows;
    const float* d_t = d_s + st * kRows;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 lse_c = *reinterpret_cast<const float2*>(lse_t + 8 * n + 2 * t);
      const float2 d_c = *reinterpret_cast<const float2*>(d_t + 8 * n + 2 * t);
      const float lse2[2] = {exp_arg(lse_c.x), exp_arg(lse_c.y)};
      const float dd[2] = {d_c.x, d_c.y};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * n + 2 * h + c;
          const float pe = exp_sub(padded[h] ? kPadLogit : s[e], lse2[c]);
          s[e] = pe;
          dp[e] = pe * (dp[e] - dd[c]);
        }
    }

    fence_acc(acc_dv);
    fence_acc(acc_dk);
    product_pn<OC>(acc_dv, s, dot + chunk * G::kTileBytes);  // dV_c += round(P^T) dO_c
    product_pn<OC>(acc_dk, dp, qt + chunk * G::kTileBytes);  // dK_c += round(dS^T) Q_c
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc_dv);
    fence_acc(acc_dk);
    mbar_arrive(&empty[st]);
  }

  named_barrier(1, kWarpgroup);
  acc_to_tile<OC>(k_s, acc_dk, warp, lane);
  acc_to_tile<OC>(v_s, acc_dv, warp, lane);
  fence_proxy_async();
  named_barrier(1, kWarpgroup);
  if (tid == 0) {
    tma_store_tile<OC>(&tm_dk, k_s, head, k0, b, chunk * OC);
    tma_store_tile<OC>(&tm_dv, v_s, head, k0, b, chunk * OC);
    tma_store_commit_and_wait();
  }
}

// ---- head dims above 256: the streamed, column-split route ----------------
//
// As the forward's (attention_fwd.cu): for any head dim hd that is a
// multiple of 128, a block produces one 128-column chunk of dQ (or of dK and
// dV) and takes S and dP box by box through a ring of 16 KB slots
// (attention_sm90.cuh's SlotRing): the producer streams (Q_x, K_jx) for x =
// 0 .. hd/64 - 1, then (dO_x, V_jx), then the chunk of the output product's
// operand (K_j for dQ; dO_i and Q_i for dV and dK); shared memory is 4 slots
// (64 KB) at any hd.  lse and D come from global memory in the consumers.
constexpr int kSplitSlots = 4;
constexpr int kSplitChunk = 128;

// (a) D over any head dim that is a multiple of 8: one warp a row, 16-byte
// loads.
__global__ void __launch_bounds__(kDsumThreads)
dsum_kernel_rows(const bf16* __restrict__ out, const bf16* __restrict__ resid,
                 const bf16* __restrict__ dout, float* __restrict__ dsum, long long rows,
                 int sq, int heads, int hd) {
  const long long r = (long long)blockIdx.x * (kDsumThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  float acc = 0.f;
  for (int c = 8 * lane; c < hd; c += 256) {
    const long long at = r * hd + c;
    const uint4 o4 = *reinterpret_cast<const uint4*>(out + at);
    const uint4 r4 = *reinterpret_cast<const uint4*>(resid + at);
    const uint4 g4 = *reinterpret_cast<const uint4*>(dout + at);
    const bf16* o = reinterpret_cast<const bf16*>(&o4);
    const bf16* rr = reinterpret_cast<const bf16*>(&r4);
    const bf16* g = reinterpret_cast<const bf16*>(&g4);
#pragma unroll
    for (int d = 0; d < 8; ++d)
      acc = fmaf(__bfloat162float(g[d]), __bfloat162float(o[d]) + __bfloat162float(rr[d]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long h = r % heads, bi = r / heads;
    const long long b = bi / sq, i = bi % sq;
    dsum[(b * heads + h) * sq + i] = acc;
  }
}

// (b) dQ_i's chunk c: per key tile S and dP over the head dim, then dQ_c +=
// round(dS) K_jc.  Registers as (b) at HD 128.
__global__ void __launch_bounds__(kThreads, 1)
dq_split_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ lse,
                const float* __restrict__ dsum, const uint8_t* __restrict__ pad, int sq,
                int sk, int heads, int hd) {
  using G = Geom<kSplitChunk>;
  using Ring = SlotRing<kSplitSlots>;
  extern __shared__ unsigned char smem_raw[];
  Ring ring(aligned_smem(smem_raw));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_chunks = hd / kSplitChunk, n_box = hd / 64;
  const int q0 = blockIdx.x * kRows, b = blockIdx.z;
  const int head = blockIdx.y / n_chunks, col0 = (blockIdx.y % n_chunks) * kSplitChunk;
  const int n_tiles = (sk + kRows - 1) / kRows;

  if (tid == 0) {
    ring.init();
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      int u = 0;
      for (int j = 0; j < n_tiles; ++j) {
        stream_box_pairs(ring, u, n_box, &tm_q, q0, &tm_k, j * kRows, head, b);
        stream_box_pairs(ring, u, n_box, &tm_do, q0, &tm_v, j * kRows, head, b);
        stream_chunk(ring, u, &tm_k, j * kRows, col0, head, b);
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * heads + head;
  float lse2[2], d_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = q0 + 16 * warp + g + 8 * h;
    lse2[h] = exp_arg(s < sq ? lse[bh * sq + s] : 0.f);
    d_r[h] = s < sq ? dsum[bh * sq + s] : 0.f;
  }
  const uint8_t* pad_b = pad ? pad + (long long)b * sk : nullptr;

  typename G::Acc acc;
#pragma unroll
  for (int x = 0; x < G::kBoxes; ++x)
#pragma unroll
    for (int i = 0; i < G::kAccFloats; ++i) acc[x][i] = 0.f;

  int u = 0;
  for (int j = 0; j < n_tiles; ++j) {
    float s[32], dp[32];
    stream_box_product(s, ring, u, n_box);   // S = Q K^T
    stream_box_product(dp, ring, u, n_box);  // dP = dO V^T
    const int k0 = j * kRows;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * n + 2 * t + c;
        const bool outside = key >= sk;
        const bool padded = !outside && pad_b != nullptr && pad_b[key] != 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * n + 2 * h + c;
          const float pe = outside ? 0.f : exp_sub(padded ? kPadLogit : s[e], lse2[h]);
          dp[e] = pe * (dp[e] - d_r[h]);
        }
      }
    const char* kc = ring.consume(u);
    fence_acc(acc);
    product_pn<kSplitChunk>(acc, dp, kc);  // dQ_c += round(dS) K_jc
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    ring.release(u++);
  }

  named_barrier(1, kWarpgroup);
  acc_to_tile<kSplitChunk>(ring.slots, acc, warp, lane);
  fence_proxy_async();
  named_barrier(1, kWarpgroup);
  if (tid == 0) {
    tma_store_tile<kSplitChunk>(&tm_dq, ring.slots, head, q0, b, col0);
    tma_store_commit_and_wait();
  }
}

// (c) dK_j's and dV_j's chunk c: per query tile S^T = K Q^T and dP^T = V dO^T
// over the head dim, then dV_c += round(P^T) dO_ic and dK_c += round(dS^T)
// Q_ic.  Registers as (c) at HD 128.
__global__ void __launch_bounds__(kThreads, 1)
dkdv_split_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_dk,
                  const __grid_constant__ CUtensorMap tm_dv, const float* __restrict__ lse,
                  const float* __restrict__ dsum, const uint8_t* __restrict__ pad, int sq,
                  int sk, int heads, int hd) {
  using G = Geom<kSplitChunk>;
  using Ring = SlotRing<kSplitSlots>;
  extern __shared__ unsigned char smem_raw[];
  Ring ring(aligned_smem(smem_raw));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_chunks = hd / kSplitChunk, n_box = hd / 64;
  const int k0 = blockIdx.x * kRows, b = blockIdx.z;
  const int head = blockIdx.y / n_chunks, col0 = (blockIdx.y % n_chunks) * kSplitChunk;
  const int n_tiles = (sq + kRows - 1) / kRows;
  const long long bh = (long long)b * heads + head;

  if (tid == 0) {
    ring.init();
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      int u = 0;
      for (int i = 0; i < n_tiles; ++i) {
        stream_box_pairs(ring, u, n_box, &tm_k, k0, &tm_q, i * kRows, head, b);
        stream_box_pairs(ring, u, n_box, &tm_v, k0, &tm_do, i * kRows, head, b);
        stream_chunk(ring, u, &tm_do, i * kRows, col0, head, b);
        stream_chunk(ring, u, &tm_q, i * kRows, col0, head, b);
      }
    }
    return;
  }

  // keys k0 + 16 warp + g (index 0) and + 8 (index 1)
  const int g = lane >> 2, t = lane & 3;
  bool padded[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 16 * warp + g + 8 * h;
    padded[h] = pad != nullptr && key < sk && pad[(long long)b * sk + key] != 0;
  }

  typename G::Acc acc_dv, acc_dk;
#pragma unroll
  for (int x = 0; x < G::kBoxes; ++x)
#pragma unroll
    for (int i = 0; i < G::kAccFloats; ++i) acc_dv[x][i] = acc_dk[x][i] = 0.f;

  int u = 0;
  for (int i = 0; i < n_tiles; ++i) {
    float s[32], dp[32];
    stream_box_product(s, ring, u, n_box);   // S^T = K Q^T
    stream_box_product(dp, ring, u, n_box);  // dP^T = V dO^T
    // lse and D of query columns 8 n + 2 t + c; 0 past Sq, where the
    // zero-filled Q and dO rows make every term vanish
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int row = i * kRows + 8 * n + 2 * t + c;
        const float lse2 = exp_arg(row < sq ? lse[bh * sq + row] : 0.f);
        const float dd = row < sq ? dsum[bh * sq + row] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * n + 2 * h + c;
          const float pe = exp_sub(padded[h] ? kPadLogit : s[e], lse2);
          s[e] = pe;
          dp[e] = pe * (dp[e] - dd);
        }
      }
    const char* doc = ring.consume(u);
    fence_acc(acc_dv);
    product_pn<kSplitChunk>(acc_dv, s, doc);  // dV_c += round(P^T) dO_ic
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc_dv);
    ring.release(u++);
    const char* qc = ring.consume(u);
    fence_acc(acc_dk);
    product_pn<kSplitChunk>(acc_dk, dp, qc);  // dK_c += round(dS^T) Q_ic
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc_dk);
    ring.release(u++);
  }

  named_barrier(1, kWarpgroup);
  acc_to_tile<kSplitChunk>(ring.slots, acc_dk, warp, lane);
  acc_to_tile<kSplitChunk>(ring.slots + kSlotBytes, acc_dv, warp, lane);
  fence_proxy_async();
  named_barrier(1, kWarpgroup);
  if (tid == 0) {
    tma_store_tile<kSplitChunk>(&tm_dk, ring.slots, head, k0, b, col0);
    tma_store_tile<kSplitChunk>(&tm_dv, ring.slots + kSlotBytes, head, k0, b, col0);
    tma_store_commit_and_wait();
  }
}

int launch_split(const void* q, const void* k, const void* v, const void* out,
                 const void* resid, const void* dout, const void* lse, const void* pad,
                 void* dsum, void* dq, void* dk, void* dv, int batch, int sq, int sk,
                 int heads, int hd, cudaStream_t stream) {
  constexpr size_t smem = SlotRing<kSplitSlots>::kSmem;
  const int n_chunks = hd / kSplitChunk;
  if (hd % kSplitChunk != 0 || (long long)heads * n_chunks > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq, tm_dk, tm_dv;
  if (const cudaError_t err = bind_context(); err != cudaSuccess) return (int)err;
  if (!(make_box_map(&tm_q, q, batch, sq, heads, hd, 64) &&
        make_box_map(&tm_k, k, batch, sk, heads, hd, 64) &&
        make_box_map(&tm_v, v, batch, sk, heads, hd, 64) &&
        make_box_map(&tm_do, dout, batch, sq, heads, hd, 64) &&
        make_box_map(&tm_dq, dq, batch, sq, heads, hd, 64) &&
        make_box_map(&tm_dk, dk, batch, sk, heads, hd, 64) &&
        make_box_map(&tm_dv, dv, batch, sk, heads, hd, 64)))
    return (int)cudaErrorNotSupported;
  const float* lse_ = static_cast<const float*>(lse);
  const uint8_t* pad_ = static_cast<const uint8_t*>(pad);
  float* dsum_ = static_cast<float*>(dsum);

  const long long rows = (long long)batch * sq * heads;
  const long long blocks = (rows + kDsumThreads / 32 - 1) / (kDsumThreads / 32);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dsum_kernel_rows<<<(unsigned)blocks, kDsumThreads, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(resid),
      static_cast<const bf16*>(dout), dsum_, rows, sq, heads, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(dq_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((sq + kRows - 1) / kRows, heads * n_chunks, batch);
  dq_split_kernel<<<grid_q, kThreads, smem, stream>>>(tm_q, tm_k, tm_v, tm_do, tm_dq, lse_,
                                                      dsum_, pad_, sq, sk, heads, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(dkdv_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((sk + kRows - 1) / kRows, heads * n_chunks, batch);
  dkdv_split_kernel<<<grid_kv, kThreads, smem, stream>>>(tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv,
                                                         lse_, dsum_, pad_, sq, sk, heads, hd);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* out, const void* resid,
           const void* dout, const void* lse, const void* pad, void* dsum, void* dq, void* dk,
           void* dv, int batch, int sq, int sk, int heads, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq, tm_dk, tm_dv;
  if (const cudaError_t err = bind_context(); err != cudaSuccess) return (int)err;
  if (!(make_tile_map<HD>(&tm_q, q, batch, sq, heads) &&
        make_tile_map<HD>(&tm_k, k, batch, sk, heads) &&
        make_tile_map<HD>(&tm_v, v, batch, sk, heads) &&
        make_tile_map<HD>(&tm_do, dout, batch, sq, heads) &&
        make_tile_map<HD>(&tm_dq, dq, batch, sq, heads) &&
        make_tile_map<HD>(&tm_dk, dk, batch, sk, heads) &&
        make_tile_map<HD>(&tm_dv, dv, batch, sk, heads)))
    return (int)cudaErrorNotSupported;
  const float* lse_ = static_cast<const float*>(lse);
  const uint8_t* pad_ = static_cast<const uint8_t*>(pad);
  float* dsum_ = static_cast<float*>(dsum);

  constexpr int kDsumRows = kDsumThreads / (HD / 8);
  const long long rows = (long long)batch * sq * heads;
  const long long blocks = (rows + kDsumRows - 1) / kDsumRows;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dsum_kernel<HD><<<(unsigned)blocks, kDsumThreads, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(resid),
      static_cast<const bf16*>(dout), dsum_, rows, sq, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(dq_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DqLayout<HD>::kSmem);
  if (err != cudaSuccess) return (int)err;
  if ((long long)heads * (HD / kOC<HD>) > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid_q((sq + kRows - 1) / kRows, heads * (HD / kOC<HD>), batch);
  dq_wgmma_kernel<HD><<<grid_q, kThreads, DqLayout<HD>::kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dq, lse_, dsum_, pad_, sq, sk, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(dkdv_wgmma_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DkdvLayout<HD>::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((sk + kRows - 1) / kRows, heads * (HD / kOC<HD>), batch);
  dkdv_wgmma_kernel<HD><<<grid_kv, kThreads, DkdvLayout<HD>::kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, lse_, dsum_, pad_, sq, sk, heads);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, const void* out,
                const void* resid, const void* dout, const void* lse, const void* pad,
                void* dsum, void* dq, void* dk, void* dv, int batch, int sq, int sk, int heads,
                int hd, cudaStream_t stream) {
  // TMA boxes and 16-byte loads start on 16-byte boundaries
  if (resid == nullptr) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out | (uintptr_t)resid |
       (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) & 15)
    return (int)cudaErrorMisalignedAddress;
#define SIMVG_BWD_ARGS \
  q, k, v, out, resid, dout, lse, pad, dsum, dq, dk, dv, batch, sq, sk, heads
  switch (hd) {
    case 32: return launch<32>(SIMVG_BWD_ARGS, stream);
    case 64: return launch<64>(SIMVG_BWD_ARGS, stream);
    case 128: return launch<128>(SIMVG_BWD_ARGS, stream);
    case 256: return launch<256>(SIMVG_BWD_ARGS, stream);
  }
  if (hd > 256) return launch_split(SIMVG_BWD_ARGS, hd, stream);
#undef SIMVG_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace hopper

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 32, 64, 128, 256 (the kernels'
// instantiations; fp32 at 256 takes the split route), or above 256 a multiple
// of 128 (the split route; the wrapper pads any other head_dim with zero
// columns to the next of these).  q/dq, out/dout and resid
// [B, Sq, H, HD], k/v/dk/dv [B, Sk, H, HD] in that dtype; lse (from
// simvg_attention_fwd) and the scratch dsum float32 [B, H, Sq]; pad uint8
// [B, Sk] (1 = padded) or null.  resid is the forward's residual
// (simvg_attention_fwd with a gradient), required in bf16 and not read in
// float32.  Launches three kernels on `stream` and returns the first CUDA
// error (0 if none).
extern "C" int simvg_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* resid, const void* dout,
                                   const void* lse, const void* pad, void* dsum, void* dq,
                                   void* dk, void* dv, int batch, int sq, int sk, int heads,
                                   int head_dim, int dtype, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || heads <= 0 || heads > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIMVG_BWD_ARGS \
  q, k, v, out, dout, lse, pad, dsum, dq, dk, dv, batch, sq, sk, heads
  if (dtype == 0) {
    switch (head_dim) {
      case 32: return launch<float, 32>(SIMVG_BWD_ARGS, s);
      case 64: return launch<float, 64>(SIMVG_BWD_ARGS, s);
      case 128: return launch<float, 128>(SIMVG_BWD_ARGS, s);
    }
    if (head_dim == 256 || (head_dim > 256 && head_dim % 128 == 0))
      return launch_split<float>(SIMVG_BWD_ARGS, head_dim, s);
  }
#undef SIMVG_BWD_ARGS
  if (dtype == 1 && (head_dim <= 256 || head_dim % 128 == 0))
    return hopper::launch_bf16(q, k, v, out, resid, dout, lse, pad, dsum, dq, dk, dv, batch, sq,
                               sk, heads, head_dim, s);
  return (int)cudaErrorInvalidValue;
}
