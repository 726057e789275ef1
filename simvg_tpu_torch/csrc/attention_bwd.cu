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
// The fp32 route takes D as rowsum(dO * out), equal in exact arithmetic
// (sum_j P_j dO.v_j = dO.out) and within fp32 summation order of it.  The
// bf16 route takes the TPU kernel's rowsum(dP * P): rowsum(dO * out) from the
// bf16-rounded out is off by that rounding, which dS = P (dP - D) does not
// cancel (its rows sum to 0), and put dQ up to 8.8x further from float32 than
// this formula on the flagship's trained weights.  Padded keys get the logit -1e30 as in the forward, so their P is 0
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
//   (a) dsum_kernel: D for every query row (one warp a row; fp32 route);
//   (b) dkdv_kernel: one block per (64-key tile, head, batch) holds K_j, V_j in
//       shared memory, walks the 64-query tiles, recomputes P and dS and
//       accumulates dV_j and dK_j in fp32 registers;
//   (c) dq_kernel: one block per (64-query tile, head, batch) holds Q_i, dO_i,
//       walks the key tiles, recomputes P and dS and accumulates dQ_i.
// (b) and (c) both recompute S and dP: seven 64x64x64 products per tile pair
// where five would do, the price of having no cross-block reduction.  The
// result is deterministic: every output element is written by one block,
// from sums taken in a fixed order.
//
// Two routes, chosen by dtype in the C entry point.  fp32 runs (a), (b), (c)
// on the CUDA cores in fp32 FMAs with the forward's 16x16-thread,
// 4x4-register tiling: the parity route (TF32 would break the fp32 bounds).
// bf16 runs on the tensor cores (dq_mma_kernel, dkdv_mma_kernel): every
// product an mma.sync on bf16 fragments fed by cp.async, P and dS kept in
// registers (see below).  There (a) folds into (c), which runs first, takes
// D = rowsum(dP * P) in a first pass over the key tiles and writes it for (b).
//
// What bounds it.  At the flagship's S = 421, HD = 64, the backward is
// ~10*B*H*S^2*HD FLOP (the TPU kernel's cost estimate; 43.6 GFLOP at B = 32)
// over ~8 [B,S,H,HD] tensors read or written once (~166 MB in bf16): 0.044 ms
// of tensor-core work against 0.050 ms of memory traffic, so the card's
// bound is the bytes.  The mma.sync route does nine tile products where five
// would do (D's pass recomputes S and dP), reloads every B fragment from shared memory for each warp (16
// rows of A to 64 columns of B: shared-memory reads, not the tensor cores,
// set its pace), and spends a multi-function-unit exp2 on every score.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (simvg_tpu_torch/ops/_build.py); called through ctypes with a plain C ABI.

#include <math.h>

#include "attention_common.cuh"
#include "attention_mma.cuh"

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

// ---- bf16 on the tensor cores -------------------------------------------
//
// The same two-pass shape, with every product an mma.sync on bf16
// fragments: 4 warps a block, 16 rows of the block's 64-row tile each, the
// other operand streaming through a 2-stage cp.async ring of 64-row tiles.
// P and dS stay in registers: the fp32 C fragments of S and dP become, after
// the elementwise step and the rounding to bf16, the A fragments of the next
// products (attention_mma.cuh).  Rows past Sq and Sk are zero-filled by the
// loads; rows past Sk are masked, rows past Sq contribute exact zeros
// (their dO and D are 0, so P^T dO and dS = P (dP - D) vanish).

// dQ: shared memory for Q, dO and two stages of K and V.
constexpr size_t kDqSmem = 6 * (size_t)kTileBytes;
// dK/dV: K, V and two stages of Q, dO, lse and D.
constexpr size_t kDkdvSmem = 6 * (size_t)kTileBytes + 2 * 2 * kMmaRows * sizeof(float);

// (a) and (c) on the tensor cores: D_i and dQ_i for one 64-query tile of
// one head, in two passes over the key tiles.  Per key tile a warp computes
// S = Q K^T and dP = dO V^T (32 mma each) and P = exp(S - lse) in registers.
// The first pass sums D = rowsum(P * dP) in fp32, the TPU kernel's row term,
// and writes it for the dK/dV kernel, which runs next; the second takes
// dS = P (dP - D) and dQ += round(dS) K (32 mma, K through ldmatrix.trans).
// The K/V pipeline runs on across the two passes: step it loads tile
// (it + 1) mod n_tiles into stage (it + 1) & 1.
__global__ void __launch_bounds__(kMmaThreads)
dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ dsum,
              const uint8_t* __restrict__ pad, __nv_bfloat16* __restrict__ dq, int sq,
              int sk, int heads) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* do_s = q_s + kTileElems;
  __nv_bfloat16* k_s = do_s + kTileElems;  // [2][kTileElems]
  __nv_bfloat16* v_s = k_s + 2 * kTileElems;  // [2][kTileElems]

  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kMmaRows;
  const int head = blockIdx.y;
  const int b = blockIdx.z;

  const long long row = (long long)heads * kMmaHd;
  const long long q_off = (long long)b * sq * row + (long long)head * kMmaHd;
  const long long k_off = (long long)b * sk * row + (long long)head * kMmaHd;
  const float* lse_b = lse + ((long long)b * heads + head) * sq;
  float* d_b = dsum + ((long long)b * heads + head) * sq;
  const uint8_t* pad_b = pad ? pad + (long long)b * sk : nullptr;

  load_tile_async(q_s, q + q_off, row, q0, sq, tid);
  load_tile_async(do_s, dout + q_off, row, q0, sq, tid);
  load_tile_async(k_s, k + k_off, row, 0, sk, tid);
  load_tile_async(v_s, v + k_off, row, 0, sk, tid);
  cp_async_commit();

  // exp_arg(lse) and D of rows r0 + g (index 0) and r0 + g + 8 (index 1);
  // 0 past Sq
  float lse_r[2], d_r[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = q0 + r0 + (lane >> 2) + 8 * h;
    lse_r[h] = exp_arg(s < sq ? lse_b[s] : 0.f);
  }

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_tiles = (sk + kMmaRows - 1) / kMmaRows;
  for (int it = 0; it < 2 * n_tiles; ++it) {
    const int st = it & 1;
    const bool first_pass = it < n_tiles;
    if (it + 1 < 2 * n_tiles) {
      const int next = (it + 1 < n_tiles ? it + 1 : it + 1 - n_tiles) * kMmaRows;
      load_tile_async(k_s + (st ^ 1) * kTileElems, k + k_off, row, next, sk, tid);
      load_tile_async(v_s + (st ^ 1) * kTileElems, v + k_off, row, next, sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* kt = k_s + st * kTileElems;

    float p[8][4], ds[8][4];
    tile_product_nk(p, q_s, r0, kt, lane);                   // S
    tile_product_nk(ds, do_s, r0, v_s + st * kTileElems, lane);  // dP
    const int k0 = (first_pass ? it : it - n_tiles) * kMmaRows;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + n * 8 + 2 * t + c;
        const bool outside = key >= sk;
        const bool padded = !outside && pad_b != nullptr && pad_b[key] != 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + c;
          const float pe = outside ? 0.f : exp_sub(padded ? kPadLogit : p[n][e], lse_r[h]);
          if (first_pass)
            d_r[h] = fmaf(pe, ds[n][e], d_r[h]);
          else
            ds[n][e] = pe * (ds[n][e] - d_r[h]);
        }
      }
    if (first_pass) {
      if (it == n_tiles - 1) {
        // a row's columns are spread over the 4 lanes of its quad
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          d_r[h] += __shfl_xor_sync(0xffffffffu, d_r[h], 1);
          d_r[h] += __shfl_xor_sync(0xffffffffu, d_r[h], 2);
          const int s = q0 + r0 + (lane >> 2) + 8 * h;
          if (t == 0 && s < sq) d_b[s] = d_r[h];
        }
      }
    } else {
      tile_product_kn(acc, ds, kt, lane);  // dQ += round(dS) K
    }
    __syncthreads();
  }
  store_rows(acc, 1.f, 1.f, q_s, r0, dq + q_off, row, q0, sq, lane);
}

// (b) on the tensor cores: dK_j, dV_j for one 64-key tile of one head.  A
// warp owns 16 keys and computes the transposed products S^T = K Q^T and
// dP^T = V dO^T (32 mma each), so that P^T and dS^T land in registers as the
// A operands of dV += round(P^T) dO and dK += round(dS^T) Q (32 mma each, dO
// and Q through ldmatrix.trans).  lse and D are per column there, read from
// shared memory beside each query tile.  Three blocks an SM: registers are
// capped at 168 a thread (ptxas fits it in ~160 with no spills).
__global__ void __launch_bounds__(kMmaThreads, 3)
dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                const uint8_t* __restrict__ pad, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int sq, int sk, int heads) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* v_s = k_s + kTileElems;
  __nv_bfloat16* q_s = v_s + kTileElems;   // [2][kTileElems]
  __nv_bfloat16* do_s = q_s + 2 * kTileElems;  // [2][kTileElems]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTileElems);  // [2][64]
  float* d_s = lse_s + 2 * kMmaRows;                                // [2][64]

  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16;
  const int t = lane & 3;
  const int k0 = blockIdx.x * kMmaRows;
  const int head = blockIdx.y;
  const int b = blockIdx.z;

  const long long row = (long long)heads * kMmaHd;
  const long long q_off = (long long)b * sq * row + (long long)head * kMmaHd;
  const long long k_off = (long long)b * sk * row + (long long)head * kMmaHd;
  const float* lse_b = lse + ((long long)b * heads + head) * sq;
  const float* d_b = dsum + ((long long)b * heads + head) * sq;

  // Q, dO, lse and D of query tile i into stage st; rows past Sq are zeros
  auto load_query_tile = [&](int i, int st) {
    const int s0 = i * kMmaRows;
    load_tile_async(q_s + st * kTileElems, q + q_off, row, s0, sq, tid);
    load_tile_async(do_s + st * kTileElems, dout + q_off, row, s0, sq, tid);
    const int r = tid & (kMmaRows - 1);
    const bool in = s0 + r < sq;
    const float* from = (tid < kMmaRows ? lse_b : d_b) + (in ? s0 + r : 0);
    cp_async4((tid < kMmaRows ? lse_s : d_s) + st * kMmaRows + r, from, in ? 4 : 0);
  };

  load_tile_async(k_s, k + k_off, row, k0, sk, tid);
  load_tile_async(v_s, v + k_off, row, k0, sk, tid);
  load_query_tile(0, 0);
  cp_async_commit();

  // keys r0 + g (index 0) and r0 + g + 8 (index 1) of the tile
  bool padded[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + r0 + (lane >> 2) + 8 * h;
    padded[h] = pad != nullptr && key < sk && pad[(long long)b * sk + key] != 0;
  }

  float acc_dv[8][4], acc_dk[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dv[n][e] = acc_dk[n][e] = 0.f;

  const int n_tiles = (sq + kMmaRows - 1) / kMmaRows;
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1;
    if (i + 1 < n_tiles) load_query_tile(i + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // two halves of 32 queries, one after the other: P^T and dS^T of a half
    // are 16 registers each, which leaves room for three blocks on an SM
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;
      const __nv_bfloat16* qt = q_s + st * kTileElems + c0 * kPitch;
      const __nv_bfloat16* dot = do_s + st * kTileElems + c0 * kPitch;
      const float* lse_t = lse_s + st * kMmaRows + c0;
      const float* d_t = d_s + st * kMmaRows + c0;

      float p[4][4], ds[4][4];
      tile_product_nk(p, k_s, r0, qt, lane);    // S^T
      tile_product_nk(ds, v_s, r0, dot, lane);  // dP^T
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float2 lse_c = *reinterpret_cast<const float2*>(lse_t + n * 8 + 2 * t);
        const float2 d_c = *reinterpret_cast<const float2*>(d_t + n * 8 + 2 * t);
        const float lse2[2] = {exp_arg(lse_c.x), exp_arg(lse_c.y)};
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * h + c;
            const float pe = exp_sub(padded[h] ? kPadLogit : p[n][e], lse2[c]);
            p[n][e] = pe;
            ds[n][e] = pe * (ds[n][e] - (c ? d_c.y : d_c.x));
          }
      }
      tile_product_kn(acc_dv, p, dot, lane);  // dV += round(P^T) dO
      tile_product_kn(acc_dk, ds, qt, lane);  // dK += round(dS^T) Q
    }
    __syncthreads();
  }
  // k_s and v_s rows [r0, r0 + 16) were read by this warp alone
  store_rows(acc_dk, 1.f, 1.f, k_s, r0, dk + k_off, row, k0, sk, lane);
  store_rows(acc_dv, 1.f, 1.f, v_s, r0, dv + k_off, row, k0, sk, lane);
}

int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* pad, void* dsum, void* dq, void* dk, void* dv,
               int batch, int sq, int sk, int heads, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const uint8_t* pad_ = static_cast<const uint8_t*>(pad);
  float* dsum_ = static_cast<float*>(dsum);

  // D and dQ first: the dK/dV kernel reads the D that this one writes
  cudaError_t err = cudaFuncSetAttribute(
      dq_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDqSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((sq + kMmaRows - 1) / kMmaRows, heads, batch);
  dq_mma_kernel<<<grid_q, kMmaThreads, kDqSmem, stream>>>(
      q_, k_, v_, do_, lse_, dsum_, pad_, static_cast<bf16*>(dq), sq, sk, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(dkdv_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDkdvSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((sk + kMmaRows - 1) / kMmaRows, heads, batch);
  dkdv_mma_kernel<<<grid_kv, kMmaThreads, kDkdvSmem, stream>>>(
      q_, k_, v_, do_, lse_, dsum_, pad_, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq,
      sk, heads);
  return (int)cudaGetLastError();
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
  if (dtype == 1 && head_dim == 64) {
    // 16-byte cp.async loads and stores
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out | (uintptr_t)dout |
         (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) & 15)
      return (int)cudaErrorMisalignedAddress;
    return launch_mma(q, k, v, dout, lse, pad, dsum, dq, dk, dv, batch, sq, sk, heads, s);
  }
  return (int)cudaErrorInvalidValue;
}
