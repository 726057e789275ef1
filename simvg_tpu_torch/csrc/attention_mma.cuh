// Tensor-core building blocks of the bf16 attention forward
// (attention_fwd.cu; the backward's are in attention_sm90.cuh): 16-byte
// cp.async tile loads, padded bf16 shared tiles, ldmatrix fragment loads, the
// bf16 mma.sync.m16n8k16 product with fp32 sums, and the repack of an fp32
// accumulator fragment into a bf16 A fragment.
//
// A block of these kernels is 4 warps; each warp owns 16 rows of a 64-row
// tile.  A tile of one head of a [B, S, H, 64] tensor sits in shared memory
// as [64][kPitch] bf16: a 144-byte row pitch, so the 8 rows that one
// ldmatrix phase reads start 4 banks apart and hit 32 different banks.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA), lane = 4 g + t:
//   A (16x16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                         a3 = (g+8, 2t+8..)
//   B (16x8, k x n):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16x8, fp32):       c0 = (g, 2t), c1 = (g, 2t+1), c2 = (g+8, 2t), c3 = (g+8, 2t+1)
// so the C fragments of two neighbouring 8-column tiles are, element for
// element, the A fragment over those 16 columns (c_to_a): P and dS go from
// one product to the next in registers, rounded to bf16 on the way, which is
// the cast to the input type that the TPU kernel makes before those products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace simvg {

constexpr int kMmaHd = 64;                    // head_dim of the bf16 kernels
constexpr int kMmaRows = 64;                  // rows of a tile (queries or keys)
constexpr int kMmaWarps = 4;                  // 16 rows of the tile each
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kPitch = kMmaHd + 8;            // bf16 elements between shared rows
constexpr int kTileElems = kMmaRows * kPitch;
constexpr int kTileBytes = kTileElems * 2;    // 9216

// 16 bytes global -> shared, asynchronously; src_bytes = 0 reads nothing and
// writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes global -> shared, asynchronously; src_bytes = 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most n of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [r0, r0 + 64) of one head of a [B, S, H, 64] bf16 tensor (src points
// at token 0 of that head, `stride` elements between tokens) into a
// [64][kPitch] shared tile; rows at or past `rows` are zero-filled.  Each
// thread copies 4 of the tile's 512 16-byte chunks; 8 neighbouring threads
// read one 128-byte row.
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long stride, int r0, int rows, int tid) {
#pragma unroll
  for (int i = 0; i < kMmaRows * 8 / kMmaThreads; ++i) {
    const int c = tid + kMmaThreads * i;
    const int r = c >> 3, ch = c & 7;
    const bool in = r0 + r < rows;
    // a row past the end reads nothing; its address stays a valid one
    const __nv_bfloat16* from = src + (in ? (long long)(r0 + r) * stride : 0) + ch * 8;
    cp_async16(dst + r * kPitch + ch * 8, from, in ? 16 : 0);
  }
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a
// row-major [.][kPitch] tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int r0,
                                       int c0, int lane) {
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * kPitch + c0 + (lane >> 4) * 8);
}

// B fragments of two 8-wide n-tiles, n0 and n0 + 8, over k in [k0, k0 + 16),
// from a tile stored n-major ([n][k], e.g. K for S = Q K^T):
// {b[0], b[1]} for n0, {b[2], b[3]} for n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const __nv_bfloat16* tile, int n0,
                                          int k0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * kPitch + k0 +
                     ((lane >> 3) & 1) * 8);
}

// The same from a tile stored k-major ([k][n], e.g. V for O = P V), through
// the transposing ldmatrix.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* tile, int k0,
                                          int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 15)) * kPitch + n0 + (lane >> 4) * 8);
}

// d += a b on the tensor cores: bf16 operands, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The C fragments of n-tiles 2j and 2j + 1 (16 rows x 16 columns), rounded to
// bf16, as the A fragment over those 16 columns.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// One warp's product over the 64-wide head dim: acc[n] (16 rows x 8 columns
// each, N n-tiles) = rows [r0, r0 + 16) of `a_tile` times the first 8 N rows
// of the n-major `b_tile`, both [.][kPitch].  Used for S = Q K^T,
// dP = dO V^T and their transposes.
template <int N>
__device__ __forceinline__ void tile_product_nk(float (&acc)[N][4], const __nv_bfloat16* a_tile,
                                                int r0, const __nv_bfloat16* b_tile, int lane) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kMmaHd / 16; ++kk) {
    uint32_t a[4];
    load_a(a, a_tile, r0, kk * 16, lane);
#pragma unroll
    for (int np = 0; np < N / 2; ++np) {
      uint32_t b[4];
      load_b_nk(b, b_tile, np * 16, kk * 16, lane);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[n] (16 rows x 64 head-dim columns) += round(p) times the first 8 N
// rows (keys or queries) of the k-major `b_tile` [.][kPitch]: P V, dS K,
// P^T dO and dS^T Q, with p the fp32 C fragments of the first product (16
// rows x 8 N columns).
template <int N>
__device__ __forceinline__ void tile_product_kn(float (&acc)[8][4], const float (&p)[N][4],
                                                const __nv_bfloat16* b_tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < N / 2; ++kk) {
    uint32_t a[4];
    c_to_a(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      load_b_kn(b, b_tile, kk * 16, np * 16, lane);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Writes a warp's 16 x 64 fp32 fragments as bf16 into rows [r0, r0 + 16) of
// the shared tile `stage` (rows this warp alone reads), then copies the rows
// below `rows` to global memory in 16-byte stores.  dst points at token 0 of
// the head, `stride` elements between tokens; `t0` is the tile's first row.
__device__ __forceinline__ void store_rows(const float (&acc)[8][4], float scale_lo,
                                           float scale_hi, __nv_bfloat16* stage, int r0,
                                           __nv_bfloat16* dst, long long stride, int t0,
                                           int rows, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + (r0 + g) * kPitch + n * 8 + 2 * t) =
        pack_bf16(acc[n][0] * scale_lo, acc[n][1] * scale_lo);
    *reinterpret_cast<uint32_t*>(stage + (r0 + g + 8) * kPitch + n * 8 + 2 * t) =
        pack_bf16(acc[n][2] * scale_hi, acc[n][3] * scale_hi);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i;
    const int r = c >> 3, ch = c & 7;
    const int s = t0 + r0 + r;
    if (s < rows)
      *reinterpret_cast<uint4*>(dst + (long long)s * stride + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + (r0 + r) * kPitch + ch * 8);
  }
}

}  // namespace simvg
