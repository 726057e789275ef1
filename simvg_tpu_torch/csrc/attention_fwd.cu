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
//         the A operand in registers (instantiated at HD 32, 64 and 128).
//         Serving issues S_j with the product of tile j - 1, so that the
//         softmax of S_j overlaps O += P_{j-1} V_{j-1} on the tensor cores.
//         The residual variant (a third product O_lo += round(P - round(P))
//         V) takes the tiles in turn instead: without S_j beside O,
//         O_lo and both A operands it fits three blocks an SM.  out (and r)
//         leave through the freed Q tile and a TMA store.
//   fp32  attention_fwd_kernel: the CUDA cores in fp32 FMAs (16x16 threads, a
//         4x4 register tile each), the parity route: tensor cores would take
//         fp32 operands only as TF32, which keeps ~3 decimal digits.
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
// with a ring of 4.
template <int HD, bool kResid>
constexpr int kMinBlocks = HD < 128 ? 3 : kResid ? 1 : 2;
template <int HD, bool kResid>
constexpr int kRing = HD < 128 ? (kResid ? 3 : 4) : (kResid ? 4 : 2);

// Shared memory: the Q tile, the K and V stages, their key caps, the barriers.
template <int HD, int kStages>
struct Layout {
  static constexpr int kTile = Geom<HD>::kTileBytes;
  static constexpr int kTiles = (1 + 2 * kStages) * kTile;
  static constexpr int kBytes = kTiles + kStages * kRows * 4;
  static constexpr size_t kSmem = kBytes + 8 * (1 + 2 * kStages) + 1024;
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

// One block per (64-query tile, head, batch): warps 0-3 are the consumer
// warpgroup, warp 4 the producer.
template <int HD, bool kResid>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<HD, kResid>))
attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_out,
                           const __grid_constant__ CUtensorMap tm_r,
                           const uint8_t* __restrict__ pad, float* __restrict__ lse, int sq,
                           int sk, int heads) {
  using G = Geom<HD>;
  constexpr int kStages = kRing<HD, kResid>;
  constexpr int kTileBytes = G::kTileBytes;
  using L = Layout<HD, kStages>;
  extern __shared__ unsigned char smem_raw[];
  char* smem = aligned_smem(smem_raw);
  char* q_s = smem;
  char* k_s = q_s + kTileBytes;            // [kStages][kTileBytes]
  char* v_s = k_s + kStages * kTileBytes;  // [kStages][kTileBytes]
  float* cap_s = reinterpret_cast<float*>(smem + L::kTiles);  // [kStages][kRows]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBytes);
  uint64_t* q_bar = bars;                  // the Q tile has landed
  uint64_t* full = bars + 1;               // stage s has landed
  uint64_t* empty = bars + 1 + kStages;    // stage s is free

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
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
        mbar_arrive_expect_tx(&full[st], 2 * kTileBytes);
        tma_load_tile<HD>(k_s + st * kTileBytes, &tm_k, &full[st], head, j * kRows, b);
        tma_load_tile<HD>(v_s + st * kTileBytes, &tm_v, &full[st], head, j * kRows, b);
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
      product_an<HD>(o, a_hi, v_s + prev * kTileBytes);  // O += round(P_{j-1}) V_{j-1}
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
    product_an<HD>(o, a_hi, v_s + ((n_tiles - 1) % kStages) * kTileBytes);
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
      const char* v_t = v_s + st * kTileBytes;
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
      product_an<HD>(o, a_hi, v_t);
      rescale(o_lo, alpha);
      probs_lo(a_lo, s);
      wgmma_fence();
      product_an<HD>(o_lo, a_lo, v_t);
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
  acc_to_tile<HD>(q_s, o, warp, lane);
  fence_proxy_async();
  named_barrier(1, kWarpgroup);
  if (tid == 0) {
    tma_store_tile<HD>(&tm_out, q_s, head, q0, b);
    tma_store_commit_and_wait();
  }
  if (kResid) {
    named_barrier(1, kWarpgroup);  // the store has read the tile
    acc_to_tile<HD>(q_s, o_lo, warp, lane);
    fence_proxy_async();
    named_barrier(1, kWarpgroup);
    if (tid == 0) {
      tma_store_tile<HD>(&tm_r, q_s, head, q0, b);
      tma_store_commit_and_wait();
    }
  }
  if (lse != nullptr && t == 0) {
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
  constexpr size_t smem = Layout<HD, kRing<HD, kResid>>::kSmem;
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
  const dim3 grid((sq + kRows - 1) / kRows, heads, batch);
  attention_fwd_wgmma_kernel<HD, kResid><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_out, tm_r, static_cast<const uint8_t*>(pad),
      static_cast<float*>(lse), sq, sk, heads);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const void* pad, void* out,
                void* lse, void* resid, int batch, int sq, int sk, int heads,
                cudaStream_t stream) {
  // TMA boxes start on 16-byte boundaries
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out | (uintptr_t)resid) & 15)
    return (int)cudaErrorMisalignedAddress;
  return resid != nullptr
             ? launch<HD, true>(q, k, v, pad, out, lse, resid, batch, sq, sk, heads, stream)
             : launch<HD, false>(q, k, v, pad, out, lse, nullptr, batch, sq, sk, heads, stream);
}

}  // namespace hopper

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 32, 64 or 128 (the wrapper pads
// any other head_dim up to 128 with zero columns).  pad may be null (no
// padded keys); lse (float32 [B, H, Sq]) may be null (not written); resid
// ([B, Sq, H, HD] in bf16, the output's residual for the backward) may be
// null (not written), and must be null in float32.
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
    }
  }
  if (dtype == 1) {
    switch (head_dim) {
      case 32:
        return hopper::launch_bf16<32>(q, k, v, pad, out, lse, resid, batch, sq, sk, heads, s);
      case 64:
        return hopper::launch_bf16<64>(q, k, v, pad, out, lse, resid, batch, sq, sk, heads, s);
      case 128:
        return hopper::launch_bf16<128>(q, k, v, pad, out, lse, resid, batch, sq, sk, heads, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
