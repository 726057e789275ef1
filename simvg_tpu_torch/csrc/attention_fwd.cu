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
// the kernels read the heads in place, with no transpose to [B*H, S, HD].
// Nothing is padded outside: the ragged ends of Sq and Sk are masked here.
//
// Design.  The TPU kernel keeps one head's whole K/V in VMEM and takes a
// one-shot softmax.  At S = 1621 in bf16 that is ~415 KB, above the 227 KB of
// shared memory an H100 block may use, so these kernels stream K/V instead:
// a block holds its query tiles in shared memory and walks the keys in
// 64-key tiles with an online softmax (FlashAttention style: running row max
// m and row sum l in fp32, the sums rescaled by exp(m_old - m_new) when the
// max grows).
//
// Two routes, chosen by dtype in the C entry point:
//   bf16  hopper::attention_fwd_wgmma_kernel, warp-specialised on Hopper's
//         TMA and wgmma (attention_sm90.cuh).  One block per (64-query tile,
//         head, batch): a producer warp loads the Q tile once and streams K_j,
//         V_j and the tile's key caps (+inf, -1e30 for a padded key, -inf past
//         Sk: the mask is read once per block, off the consumers' path)
//         through a ring of K/V stages (kRing) under full/empty mbarriers.
//         TMA reads 64-row boxes of [B, S, H, HD] in place, zero-fills rows
//         past S and clips them on the store, so nothing is masked on a load
//         or a store.  One consumer warpgroup runs S = Q K^T and O +=
//         round(P) V as wgmma (m64n64k16; O += P V at N = HD, per
//         attention_sm90.cuh's Geom<HD>), P going from the S accumulator to
//         the A operand in registers (instantiated at HD 32, 64, 128 and
//         256; at 256 the residual variant's blocks each produce a 128-column
//         chunk of O, kOC).  Above 256, attention_fwd_split_kernel: the
//         column-split route (its section below).
//         Serving issues S_j with the product of tile j - 1, so that the
//         softmax of S_j overlaps O += P_{j-1} V_{j-1} on the tensor cores.
//         The residual variant (a third product O_lo += round(P - round(P))
//         V) takes the tiles in turn instead: without S_j beside O,
//         O_lo and both A operands it fits three blocks an SM.  out (and r)
//         leave through the freed Q tile and a TMA store.
//   fp32  attention_fwd_kernel: the CUDA cores in fp32 FMAs (16x16 threads, a
//         4x4 register tile each), the parity route: tensor cores would take
//         fp32 operands only as TF32, which keeps ~3 decimal digits.  HD 32 to
//         256; above 256 attention_fwd_split_kernel<float>, 64-column chunks.
//
// What bounds it.  At the flagship's S = 421, HD = 64 one layer's attention
// is 4*B*H*S^2*HD = 17.4 GFLOP at B = 32 over ~83 MB of q/k/v/out in bf16:
// 0.018 ms of tensor-core work at 989 TFLOP/s against 0.025 ms of memory
// traffic at 3.35 TB/s, so the card's bound is the bytes.  A 64 x 64 tile
// pair is ~256 cycles of tensor-core work on an SM and about as many issue
// slots of softmax (mask, max, exp2, sum, the bf16 packing, the rescale), and
// a short row of key tiles (7 at S = 421) leaves each block little to hide
// its first loads behind.  So the design keeps three blocks on an SM (114
// registers a thread serving, 128 with the residual; 74 and 58 KB of shared
// memory a block), whose products, softmaxes and loads interleave; the previous design (mma.sync with a cp.async ring, every
// warp reloading K/V fragments through ldmatrix) was bound by those
// instructions.  Two consumer warpgroups a block sharing one K/V ring, with
// or without taking turns on the tensor cores, and register reallocation
// (setmaxnreg) were measured and dropped (PERF.md §6).  The encoder's
// parameter matmuls, not this core, take ~92% of a layer's FLOPs at S = 421.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (simvg_tpu_torch/ops/_build.py); called through ctypes with a plain C ABI.

#include <math.h>

#include "attention_common.cuh"
#include "attention_sm90.cuh"

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

// The fp32 route above head dim 256 (and the backward's at 256, whose whole
// tiles exceed 227 KB): one block per (64-query tile, head and 64-column chunk
// of out, batch).  For each key tile the logits are summed over the head dim
// 64 columns at a time (Q's and K's chunks through two 64 x 65 tiles, in the
// order of tile_logits over the whole: the same bits as the backward's),
// then P V_c for the block's chunk c.  Shared memory: 66 KB at any head dim.
constexpr int kSplitCols = 64;

constexpr size_t split_smem_bytes() {
  return sizeof(float) * (2 * kBlockQ * (kSplitCols + 1) + kBlockK * kSplitCols +
                          kBlockQ * kLdP);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const uint8_t* __restrict__ pad,
                           T* __restrict__ out, float* __restrict__ lse, int sq, int sk,
                           int heads, int hd) {
  constexpr int kLd = kSplitCols + 1;
  constexpr int kCols = kSplitCols / kThreadsX;

  extern __shared__ float smem[];
  float* q_s = smem;                  // [kBlockQ][kLd], a chunk of Q
  float* k_s = q_s + kBlockQ * kLd;   // [kBlockK][kLd], a chunk of K
  float* v_s = k_s + kBlockK * kLd;   // [kBlockK][kSplitCols], V's chunk c
  float* p_s = v_s + kBlockK * kSplitCols;  // [kBlockQ][kLdP]

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsX;
  const int ty = tid / kThreadsX;
  const int n_chunks = hd / kSplitCols;
  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y / n_chunks, col0 = (blockIdx.y % n_chunks) * kSplitCols;
  const int b = blockIdx.z;

  const long long row = (long long)heads * hd;
  const T* q_b = q + (long long)b * sq * row + (long long)head * hd;
  const T* k_b = k + (long long)b * sk * row + (long long)head * hd;
  const T* v_b = v + (long long)b * sk * row + (long long)head * hd;
  T* o_b = out + (long long)b * sq * row + (long long)head * hd;
  const uint8_t* pad_b = pad ? pad + (long long)b * sk : nullptr;

  float m[kRowsPerThread], l[kRowsPerThread];
  float acc[kRowsPerThread][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < sk; k0 += kBlockK) {
    float logit[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) logit[i][j] = 0.f;
    for (int x0 = 0; x0 < hd; x0 += kSplitCols) {
      __syncthreads();  // the last chunk's (and tile's) reads are done
      load_chunk(q_s, kLd, q_b, row, q0, x0, sq, tid);
      load_chunk(k_s, kLd, k_b, row, k0, x0, sk, tid);
      if (x0 == 0) load_chunk(v_s, kSplitCols, v_b, row, k0, col0, sk, tid);
      __syncthreads();
      tile_logits_acc<kSplitCols>(q_s, k_s, kLd, tx, ty, logit);
    }

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
      const float alpha = expf(m[i] - m_new);
      float tile_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float p = expf(logit[i][j] - m_new);
        tile_sum += p;
        p_s[(ty + kThreadsY * i) * kLdP + tx + kThreadsX * j] = to_float(from_float<T>(p));
      }
      l[i] = l[i] * alpha + row_sum16(tile_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < kBlockK; ++key) {
      float pv[kRowsPerThread], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) pv[i] = p_s[(ty + kThreadsY * i) * kLdP + key];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = v_s[key * kSplitCols + tx + kThreadsX * c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int s = q0 + ty + kThreadsY * i;
    if (s >= sq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      o_b[s * row + col0 + tx + kThreadsX * c] = from_float<T>(acc[i][c] * inv);
    if (lse != nullptr && tx == 0 && col0 == 0)
      lse[((long long)b * heads + head) * sq + s] = m[i] + logf(l[i]);
  }
}

template <typename T>
int launch_split(const void* q, const void* k, const void* v, const void* pad, void* out,
                 void* lse, int batch, int sq, int sk, int heads, int hd,
                 cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes();
  const int n_chunks = hd / kSplitCols;
  if (hd % kSplitCols != 0 || (long long)heads * n_chunks > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_split_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, heads * n_chunks, batch);
  attention_fwd_split_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(pad), static_cast<T*>(out), static_cast<float*>(lse),
      sq, sk, heads, hd);
  return (int)cudaGetLastError();
}

// ---- bf16 on Hopper: TMA and wgmma ----------------------------------------

namespace hopper {

using namespace simvg::sm90;

constexpr int kThreads = kWarpgroup + 32;  // one consumer warpgroup + the producer warp
// Blocks an SM that __launch_bounds__ sets the registers for, and K/V tiles in
// the ring.  HD 32 and 64: three blocks (at most 128 registers a thread; at
// HD 64 2 blocks measured slower, 4 blocks spill), a ring of 4 serving (2 and
// 3 measured slower), 3 with the residual, whose 128 registers spill with 4.
// HD 128: the O accumulator doubles to 64 registers and a tile to 16 KB;
// serving keeps two blocks (80 KB of shared memory each, so a ring of 2), and
// the residual variant, whose O and O_lo alone take 128 registers, one block
// with a ring of 4.  HD 256: serving holds O's 256 columns, 128 registers, in
// one block an SM (Q 32 KB + 2 stages of K and V, 64 KB each: 161 KB); the
// residual variant would hold 256 (O and O_lo), so its blocks split O's
// columns in two chunks of kOC = 128 (every block computes the whole S_j over
// the four boxes; a stage holds K's whole tile and V's chunk, 48 KB: Q + 3
// stages = 177 KB) and hold 128 registers of O and O_lo, as at HD 128.
template <int HD, bool kResid>
constexpr int kMinBlocks = HD < 128 ? 3 : HD == 128 && !kResid ? 2 : 1;
template <int HD, bool kResid>
constexpr int kRing = HD < 128 ? (kResid ? 3 : 4) : HD == 128 ? (kResid ? 4 : 2)
                                                              : (kResid ? 3 : 2);
// the output columns a block produces
template <int HD, bool kResid>
constexpr int kOC = HD == 256 && kResid ? 128 : HD;

// Shared memory: the Q tile, the K and V (chunk) stages, their key caps, the
// barriers.
template <int HD, int OC, int kStages>
struct Layout {
  static constexpr int kTile = Geom<HD>::kTileBytes;
  static constexpr int kVTile = Geom<OC>::kTileBytes;
  static constexpr int kTiles = (1 + kStages) * kTile + kStages * kVTile;
  static constexpr int kBytes = kTiles + kStages * kRows * 4;
  static constexpr size_t kSmem = kBytes + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kSmem <= 232448, "above the 227 KB of shared memory a block may use");
};

// The online softmax of one 64 x 64 score tile, in place: caps the scores
// with the tile's key caps (+inf keeps a score, -1e30 is a padded key, -inf a
// key past Sk), raises the running row max m, turns s into P = exp(s - m_new),
// folds the tile's sum into this lane's part of l, and gives the factor
// alpha = exp(m_old - m_new) (0 on the first tile) by which the output sums
// are rescaled.  Every tile starts with an in-range key, so each row's max is
// finite and no exp sees inf - inf.
__device__ __forceinline__ void online_softmax(float (&s)[32], const float* cap, int t,
                                               float (&m)[2], float (&l)[2], float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 c = *reinterpret_cast<const float2*>(cap + 8 * n + 2 * t);
    s[4 * n] = fminf(s[4 * n], c.x);
    s[4 * n + 1] = fminf(s[4 * n + 1], c.y);
    s[4 * n + 2] = fminf(s[4 * n + 2], c.x);
    s[4 * n + 3] = fminf(s[4 * n + 3], c.y);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float tile_max = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      tile_max = fmaxf(tile_max, fmaxf(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m[h], tile_max);
    const float m2 = exp_arg(m_new);
    alpha[h] = exp_sub(m[h], m2);
    float tile_sum = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = exp_sub(s[4 * n + 2 * h + c], m2);
        s[4 * n + 2 * h + c] = p;
        tile_sum += p;
      }
    l[h] = l[h] * alpha[h] + tile_sum;
    m[h] = m_new;
  }
}

// round(P) as the A operand of O += P V.
__device__ __forceinline__ void probs_hi(uint32_t (&a)[4][4], const float (&p)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], p, kk);
}

// round(P - round(P)) as the A operand of O_lo += P_lo V (the difference is
// exact in fp32); P is overwritten by it.
__device__ __forceinline__ void probs_lo(uint32_t (&a)[4][4], float (&p)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] -= __bfloat162float(__float2bfloat16_rn(p[i]));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a(a[kk], p, kk);
}

// sums *= alpha, row by row (index 0: row g, 1: row g + 8).
template <int X, int F>
__device__ __forceinline__ void rescale(float (&d)[X][F], const float (&alpha)[2]) {
#pragma unroll
  for (int x = 0; x < X; ++x)
#pragma unroll
    for (int i = 0; i < F; ++i) d[x][i] *= alpha[(i >> 1) & 1];
}

// One block per (64-query tile, head and chunk of O's columns, batch): warps
// 0-3 are the consumer warpgroup, warp 4 the producer.
template <int HD, bool kResid>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<HD, kResid>))
attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_out,
                           const __grid_constant__ CUtensorMap tm_r,
                           const uint8_t* __restrict__ pad, float* __restrict__ lse, int sq,
                           int sk, int heads) {
  constexpr int OC = kOC<HD, kResid>;
  using G = Geom<OC>;  // the output's chunk
  constexpr int kStages = kRing<HD, kResid>;
  constexpr int kTileBytes = Geom<HD>::kTileBytes;
  constexpr int kVBytes = G::kTileBytes;
  using L = Layout<HD, OC, kStages>;
  extern __shared__ unsigned char smem_raw[];
  char* smem = aligned_smem(smem_raw);
  char* q_s = smem;
  char* k_s = q_s + kTileBytes;            // [kStages][kTileBytes]
  char* v_s = k_s + kStages * kTileBytes;  // [kStages][kVBytes]
  float* cap_s = reinterpret_cast<float*>(smem + L::kTiles);  // [kStages][kRows]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBytes);
  uint64_t* q_bar = bars;                  // the Q tile has landed
  uint64_t* full = bars + 1;               // stage s has landed
  uint64_t* empty = bars + 1 + kStages;    // stage s is free

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kChunks = HD / OC;
  const int q0 = blockIdx.x * kRows, b = blockIdx.z;
  const int head = blockIdx.y / kChunks, col0 = (blockIdx.y % kChunks) * OC;
  const int n_tiles = (sk + kRows - 1) / kRows;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer's 32 lanes; lane 0's brings the bytes
      mbar_init(&empty[s], kWarpgroup);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer warp: Q once, then K_j, V_j and the caps of tile j ----
    if (lane == 0) {
      mbar_arrive_expect_tx(q_bar, kTileBytes);
      tma_load_tile<HD>(q_s, &tm_q, q_bar, head, q0, b);
    }
    const uint8_t* pad_b = pad ? pad + (long long)b * sk : nullptr;
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      mbar_wait(&empty[st], ((j / kStages) & 1) ^ 1);
      for (int c = lane; c < kRows; c += 32) {
        const int key = j * kRows + c;
        cap_s[st * kRows + c] = key >= sk                          ? -INFINITY
                                : pad_b != nullptr && pad_b[key] ? kPadLogit
                                                                 : INFINITY;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], kTileBytes + kVBytes);
        tma_load_tile<HD>(k_s + st * kTileBytes, &tm_k, &full[st], head, j * kRows, b);
        tma_load_tile<OC>(v_s + st * kVBytes, &tm_v, &full[st], head, j * kRows, b, col0);
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // ---- consumer warpgroup: rows 16 warp + g (index 0) and + 8 (index 1) ----
  const int g = lane >> 2, t = lane & 3;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  float s[32];
  typename G::Acc o, o_lo;
  uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
  for (int x = 0; x < G::kBoxes; ++x)
#pragma unroll
    for (int i = 0; i < G::kAccFloats; ++i) o[x][i] = o_lo[x][i] = 0.f;

  mbar_wait(q_bar, 0);
  if constexpr (!kResid) {
    // Serving: S_0 alone, then S_j with O += P_{j-1} V_{j-1}, so that the
    // softmax of S_j runs while the second product is on the tensor cores;
    // last, O += P V alone
    mbar_wait(&full[0], 0);
    wgmma_fence();
    product_nt<HD>(s, q_s, k_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    online_softmax(s, cap_s, t, m, l, alpha);
    probs_hi(a_hi, s);
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % kStages, prev = (j - 1) % kStages;
      mbar_wait(&full[st], (j / kStages) & 1);
      wgmma_fence();
      product_nt<HD>(s, q_s, k_s + st * kTileBytes);    // S_j = Q K_j^T
      wgmma_commit();
      product_an<OC>(o, a_hi, v_s + prev * kVBytes);  // O += round(P_{j-1}) V_{j-1}
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(s);
      online_softmax(s, cap_s + st * kRows, t, m, l, alpha);
      wgmma_wait<0>();
      fence_acc(o);
      fence_a(a_hi);
      mbar_arrive(&empty[prev]);
      rescale(o, alpha);
      probs_hi(a_hi, s);
    }
    wgmma_fence();
    product_an<OC>(o, a_hi, v_s + ((n_tiles - 1) % kStages) * kVBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
  } else {
    // With the residual, each tile in turn (S_j beside O, O_lo and both A
    // operands would not fit 128 registers): S_j, its softmax, O = O alpha +
    // round(P_j) V_j (the operations on O of the serving order, in the same
    // order, so out has the same bits), and O_lo = O_lo alpha + P_lo V_j,
    // whose A operand is formed while the first product runs
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      const char* v_t = v_s + st * kVBytes;
      mbar_wait(&full[st], (j / kStages) & 1);
      wgmma_fence();
      product_nt<HD>(s, q_s, k_s + st * kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      online_softmax(s, cap_s + st * kRows, t, m, l, alpha);
      rescale(o, alpha);
      probs_hi(a_hi, s);
      wgmma_fence();
      product_an<OC>(o, a_hi, v_t);
      rescale(o_lo, alpha);
      probs_lo(a_lo, s);
      wgmma_fence();
      product_an<OC>(o_lo, a_lo, v_t);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      fence_acc(o_lo);
      fence_a(a_hi);
      fence_a(a_lo);
      mbar_arrive(&empty[st]);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int x = 0; x < G::kBoxes; ++x)
#pragma unroll
    for (int i = 0; i < G::kAccFloats; ++i) {
      const float y = o[x][i] * inv[(i >> 1) & 1];
      // r = (O + O_lo) / l - round(O / l), the out stored below
      if (kResid)
        o_lo[x][i] = (o[x][i] + o_lo[x][i]) * inv[(i >> 1) & 1] -
                     __bfloat162float(__float2bfloat16_rn(y));
      o[x][i] = y;
    }

  // The Q tile is free once every consumer is past its last product; out
  // (then r) goes through it to a TMA store, which drops rows past Sq.
  named_barrier(1, kWarpgroup);
  acc_to_tile<OC>(q_s, o, warp, lane);
  fence_proxy_async();
  named_barrier(1, kWarpgroup);
  if (tid == 0) {
    tma_store_tile<OC>(&tm_out, q_s, head, q0, b, col0);
    tma_store_commit_and_wait();
  }
  if (kResid) {
    named_barrier(1, kWarpgroup);  // the store has read the tile
    acc_to_tile<OC>(q_s, o_lo, warp, lane);
    fence_proxy_async();
    named_barrier(1, kWarpgroup);
    if (tid == 0) {
      tma_store_tile<OC>(&tm_r, q_s, head, q0, b, col0);
      tma_store_commit_and_wait();
    }
  }
  if (lse != nullptr && t == 0 && col0 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 16 * warp + g + 8 * h;
      if (row < sq) lse[((long long)b * heads + head) * sq + row] = m[h] + logf(l[h]);
    }
  }
}

template <int HD, bool kResid>
int launch(const void* q, const void* k, const void* v, const void* pad, void* out, void* lse,
           void* resid, int batch, int sq, int sk, int heads, cudaStream_t stream) {
  constexpr size_t smem = Layout<HD, kOC<HD, kResid>, kRing<HD, kResid>>::kSmem;
  CUtensorMap tm_q, tm_k, tm_v, tm_out, tm_r;
  if (const cudaError_t err = bind_context(); err != cudaSuccess) return (int)err;
  if (!(make_tile_map<HD>(&tm_q, q, batch, sq, heads) &&
        make_tile_map<HD>(&tm_k, k, batch, sk, heads) &&
        make_tile_map<HD>(&tm_v, v, batch, sk, heads) &&
        make_tile_map<HD>(&tm_out, out, batch, sq, heads) &&
        (!kResid || make_tile_map<HD>(&tm_r, resid, batch, sq, heads))))
    return (int)cudaErrorNotSupported;
  if (!kResid) tm_r = tm_out;  // not read
  const cudaError_t err =
      cudaFuncSetAttribute(attention_fwd_wgmma_kernel<HD, kResid>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if ((long long)heads * (HD / kOC<HD, kResid>) > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((sq + kRows - 1) / kRows, heads * (HD / kOC<HD, kResid>), batch);
  attention_fwd_wgmma_kernel<HD, kResid><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_out, tm_r, static_cast<const uint8_t*>(pad),
      static_cast<float*>(lse), sq, sk, heads);
  return (int)cudaGetLastError();
}

// ---- head dims above 256: the streamed, column-split route ----------------
//
// One block per (64-query tile, head and 128-column chunk of O, batch), for
// any head dim hd that is a multiple of 128 (the wrapper zero-pads to one).
// Nothing is held whole: for each key tile the producer streams Q's and K_j's
// box x (64 columns) into one 16 KB slot of a ring (attention_sm90.cuh's
// SlotRing), x = 0 .. hd/64 - 1, and then V_j's chunk; the consumers
// accumulate S_j = sum_x Q_x K_jx^T box by box, take the online softmax and
// run O_c += round(P) V_jc (and O_lo with the residual), so shared memory is
// the same 4 slots (64 KB) at any hd.  Each of the hd/128 blocks of a query
// tile recomputes S: hd/128 times the Q K^T work and Q read once a key tile
// (from L2), the price of holding only a 128-column O (64 registers, 128 with
// O_lo, as at HD 128).  The key caps come from the mask in the consumers,
// double-buffered by key tile.
constexpr int kSplitSlots = 4;
constexpr int kSplitChunk = 128;

template <bool kResid>
__global__ void __launch_bounds__(kThreads, kResid ? 1 : 2)
attention_fwd_split_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_out,
                           const __grid_constant__ CUtensorMap tm_r,
                           const uint8_t* __restrict__ pad, float* __restrict__ lse, int sq,
                           int sk, int heads, int hd) {
  using G = Geom<kSplitChunk>;
  using Ring = SlotRing<kSplitSlots>;
  extern __shared__ unsigned char smem_raw[];
  char* smem = aligned_smem(smem_raw);
  Ring ring(smem);
  float* cap_s = reinterpret_cast<float*>(ring.empty + kSplitSlots);  // [2][kRows]

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

  if (warp == 4) {
    // ---- producer: per key tile, the box pairs (Q_x, K_jx), then V_j's chunk
    if (lane == 0) {
      int u = 0;
      for (int j = 0; j < n_tiles; ++j) {
        stream_box_pairs(ring, u, n_box, &tm_q, q0, &tm_k, j * kRows, head, b);
        stream_chunk(ring, u, &tm_v, j * kRows, col0, head, b);
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const uint8_t* pad_b = pad ? pad + (long long)b * sk : nullptr;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  float s[32];
  typename G::Acc o, o_lo;
  uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
  for (int x = 0; x < G::kBoxes; ++x)
#pragma unroll
    for (int i = 0; i < G::kAccFloats; ++i) o[x][i] = o_lo[x][i] = 0.f;

  int u = 0;
  for (int j = 0; j < n_tiles; ++j) {
    // this tile's key caps; the buffer was last read two tiles ago, before
    // the barrier of the tile between
    float* cap = cap_s + (j & 1) * kRows;
    if (tid < kRows) {
      const int key = j * kRows + tid;
      cap[tid] = key >= sk ? -INFINITY : pad_b != nullptr && pad_b[key] ? kPadLogit : INFINITY;
    }
    named_barrier(1, kWarpgroup);
    stream_box_product(s, ring, u, n_box);  // S_j = Q K_j^T over the head dim
    online_softmax(s, cap, t, m, l, alpha);
    rescale(o, alpha);
    probs_hi(a_hi, s);
    const char* v_t = ring.consume(u);
    wgmma_fence();
    product_an<kSplitChunk>(o, a_hi, v_t);  // O_c += round(P_j) V_jc
    if (kResid) {
      rescale(o_lo, alpha);
      probs_lo(a_lo, s);
      wgmma_fence();
      product_an<kSplitChunk>(o_lo, a_lo, v_t);  // O_lo,c += P_lo V_jc
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    fence_acc(o_lo);
    fence_a(a_hi);
    fence_a(a_lo);
    ring.release(u++);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int x = 0; x < G::kBoxes; ++x)
#pragma unroll
    for (int i = 0; i < G::kAccFloats; ++i) {
      const float y = o[x][i] * inv[(i >> 1) & 1];
      if (kResid)
        o_lo[x][i] = (o[x][i] + o_lo[x][i]) * inv[(i >> 1) & 1] -
                     __bfloat162float(__float2bfloat16_rn(y));
      o[x][i] = y;
    }

  // every slot is free once every consumer is past its last product (the
  // producer issued exactly the loads they consumed): out, then r, leave
  // through slots 0 and 1
  named_barrier(1, kWarpgroup);
  acc_to_tile<kSplitChunk>(ring.slots, o, warp, lane);
  if (kResid) acc_to_tile<kSplitChunk>(ring.slots + kSlotBytes, o_lo, warp, lane);
  fence_proxy_async();
  named_barrier(1, kWarpgroup);
  if (tid == 0) {
    tma_store_tile<kSplitChunk>(&tm_out, ring.slots, head, q0, b, col0);
    if (kResid) tma_store_tile<kSplitChunk>(&tm_r, ring.slots + kSlotBytes, head, q0, b, col0);
    tma_store_commit_and_wait();
  }
  if (lse != nullptr && t == 0 && col0 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 16 * warp + g + 8 * h;
      if (row < sq) lse[((long long)b * heads + head) * sq + row] = m[h] + logf(l[h]);
    }
  }
}

template <bool kResid>
int launch_split(const void* q, const void* k, const void* v, const void* pad, void* out,
                 void* lse, void* resid, int batch, int sq, int sk, int heads, int hd,
                 cudaStream_t stream) {
  constexpr size_t smem = SlotRing<kSplitSlots>::kSmem + 2 * kRows * sizeof(float);
  const int n_chunks = hd / kSplitChunk;
  if (hd % kSplitChunk != 0 || (long long)heads * n_chunks > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v, tm_out, tm_r;
  if (const cudaError_t err = bind_context(); err != cudaSuccess) return (int)err;
  if (!(make_box_map(&tm_q, q, batch, sq, heads, hd, 64) &&
        make_box_map(&tm_k, k, batch, sk, heads, hd, 64) &&
        make_box_map(&tm_v, v, batch, sk, heads, hd, 64) &&
        make_box_map(&tm_out, out, batch, sq, heads, hd, 64) &&
        (!kResid || make_box_map(&tm_r, resid, batch, sq, heads, hd, 64))))
    return (int)cudaErrorNotSupported;
  if (!kResid) tm_r = tm_out;  // not read
  const cudaError_t err =
      cudaFuncSetAttribute(attention_fwd_split_kernel<kResid>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kRows - 1) / kRows, heads * n_chunks, batch);
  attention_fwd_split_kernel<kResid><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_out, tm_r, static_cast<const uint8_t*>(pad),
      static_cast<float*>(lse), sq, sk, heads, hd);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, const void* pad, void* out,
                void* lse, void* resid, int batch, int sq, int sk, int heads, int hd,
                cudaStream_t stream) {
  // TMA boxes start on 16-byte boundaries
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out | (uintptr_t)resid) & 15)
    return (int)cudaErrorMisalignedAddress;
  const bool r = resid != nullptr;
#define SIMVG_FWD_ARGS q, k, v, pad, out, lse, resid, batch, sq, sk, heads
  switch (hd) {
    case 32: return r ? launch<32, true>(SIMVG_FWD_ARGS, stream)
                      : launch<32, false>(SIMVG_FWD_ARGS, stream);
    case 64: return r ? launch<64, true>(SIMVG_FWD_ARGS, stream)
                      : launch<64, false>(SIMVG_FWD_ARGS, stream);
    case 128: return r ? launch<128, true>(SIMVG_FWD_ARGS, stream)
                       : launch<128, false>(SIMVG_FWD_ARGS, stream);
    case 256: return r ? launch<256, true>(SIMVG_FWD_ARGS, stream)
                       : launch<256, false>(SIMVG_FWD_ARGS, stream);
  }
  if (hd > 256)
    return r ? launch_split<true>(SIMVG_FWD_ARGS, hd, stream)
             : launch_split<false>(SIMVG_FWD_ARGS, hd, stream);
#undef SIMVG_FWD_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace hopper

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 32, 64, 128, 256 (the kernels'
// instantiations), or above 256 a multiple of 128 (the split route; the
// wrapper pads any other head_dim with zero columns to the next of these).
// pad may be null (no padded keys); lse (float32 [B, H, Sq]) may be null (not
// written); resid ([B, Sq, H, HD] in bf16, the output's residual for the
// backward) may be null (not written), and must be null in float32.
// Returns the CUDA error code of the launch (0 on success); in bf16,
// cudaErrorNotSupported when cuTensorMapEncodeTiled cannot be reached.
extern "C" int simvg_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* pad, void* out, void* lse, void* resid,
                                   int batch, int sq, int sk, int heads, int head_dim,
                                   int dtype, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || heads <= 0 || heads > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && resid == nullptr) {
    switch (head_dim) {
      case 32: return launch<float, 32>(q, k, v, pad, out, lse, batch, sq, sk, heads, s);
      case 64: return launch<float, 64>(q, k, v, pad, out, lse, batch, sq, sk, heads, s);
      case 128: return launch<float, 128>(q, k, v, pad, out, lse, batch, sq, sk, heads, s);
      case 256: return launch<float, 256>(q, k, v, pad, out, lse, batch, sq, sk, heads, s);
    }
    if (head_dim > 256 && head_dim % 128 == 0)
      return launch_split<float>(q, k, v, pad, out, lse, batch, sq, sk, heads, head_dim, s);
  }
  if (dtype == 1 && (head_dim <= 256 || head_dim % 128 == 0))
    return hopper::launch_bf16(q, k, v, pad, out, lse, resid, batch, sq, sk, heads, head_dim, s);
  return (int)cudaErrorInvalidValue;
}
