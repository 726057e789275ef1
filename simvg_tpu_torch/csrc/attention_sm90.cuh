// Hopper building blocks of the bf16 attention kernels (attention_fwd.cu,
// attention_bwd.cu): TMA tile loads and stores through tensor maps,
// mbarriers, and the warpgroup product wgmma.mma_async m64n64k16 (bf16
// operands, fp32 sums), its shared-memory descriptors and the register layout
// of its fragments.
//
// Tiles.  A tile is 64 rows of one head of a [B, S, H, 64] bf16 tensor, read
// in place by a 4-D tensor map (dims hd, H, S, B innermost first; a box of
// 64 x 1 x 64 x 1).  Each row is 128 bytes, so a tile is 8 KB and sits in
// shared memory in the 128-byte swizzle (16-byte chunk c of row r at chunk
// c ^ (r % 8)), which is the layout wgmma reads.  TMA zero-fills the rows
// past S and clips them on a store, so the ragged end needs no mask.
//
// Descriptors (PTX ISA, "Matrix Descriptor Format"): a tile read with the
// head dim as the reduction dim (Q, K, V, dO in S = Q K^T, dP = dO V^T) is
// K-major: 8-row groups 1024 bytes apart (SBO), the k16 slice kk starting
// 32 kk bytes into the row.  A tile read with the rows as the reduction dim
// (V in O = P V; K in dQ = dS K; Q and dO in dK, dV) is MN-major: its 64
// columns are one 128-byte swizzle atom, 8-row groups 1024 bytes apart (SBO),
// the k16 slice kk starting 2048 kk bytes in; the instruction's transpose
// bit set.
//
// Fragments of a warpgroup (4 warps, warp w on rows [16 w, 16 w + 16)),
// lane = 4 g + t: the accumulator of m64n64 holds 32 floats a thread,
// d[4 n + e] at row g (e < 2) or g + 8 (e >= 2) and column 8 n + 2 t + (e & 1);
// an A operand from registers (m64k16) holds 4 words, the same layout as an
// mma.m16n8k16 A fragment.  So accumulator columns [16 kk, 16 kk + 16), rounded
// to bf16, are the A operand of k16 slice kk of the next product (acc_to_a),
// with no trip through shared memory.
//
// The tensor maps are built on the host by cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPointByVersion, so the library links nothing but
// the CUDA runtime.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace simvg {
namespace sm90 {

constexpr int kRows = 64;                 // rows of a tile
constexpr int kHd = 64;                   // head_dim
constexpr int kTileBytes = kRows * kHd * 2;  // 8192
constexpr int kWarpgroup = 128;

// ---- host: tensor maps ---------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of one [batch, seq, heads, 64] bf16 tensor, boxes of 64 rows of one
// head, 128-byte swizzle, zero fill past the ends.  Returns false on failure.
inline bool make_tile_map(CUtensorMap* map, const void* base, int batch, int seq,
                          int heads) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)kHd, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)kHd * 2, (cuuint64_t)heads * kHd * 2,
                                 (cuuint64_t)seq * heads * kHd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kHd, 1, (cuuint32_t)kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- device: barriers and TMA ------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrives and announces `bytes` of TMA transfer still to land on the barrier.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.  A fresh
// barrier counts the phase before its first (parity 1) as completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One 64-row tile (head `head`, rows [row0, row0 + 64), batch `b`) into
// shared memory, completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int head, int row0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(head), "r"(row0),
      "r"(b)
      : "memory");
}

// A shared tile back to global memory; rows past the tensor's end are not
// written.  The caller fences the generic-proxy writes first.
__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map, const void* src, int head,
                                               int row0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(0), "r"(head), "r"(row0), "r"(b)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Shared-memory writes of this thread become visible to TMA and wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15) over the `count` threads of the consumer warpgroups;
// the producer warp is not part of it.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The dynamic shared memory rounded up to the 1024 bytes that the 128-byte
// swizzle wants; a launch asks for 1024 more than its layout needs.
__device__ __forceinline__ char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return reinterpret_cast<char*>(raw) + (((a + 1023) & ~1023u) - a);
}

// ---- device: wgmma -------------------------------------------------------

// A descriptor of a 128-byte-swizzled tile starting at `p` (1024-byte
// aligned, plus the k-slice's offset): SBO 1024 bytes, LBO unused (1).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The accumulator registers may be read or written only after wgmma_wait;
// this keeps the compiler from moving their uses across it.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SIMVG_D32                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define SIMVG_D32_OUT                                                                      \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),      \
      "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]),           \
      "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]),        \
      "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),        \
      "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),        \
      "=f"(d[31])
#define SIMVG_D32_LIST                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d += A B, m64n64k16, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SIMVG_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SIMVG_D32
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d = A B, the same product overwriting d: d's earlier values are dead here,
// so the compiler may reuse its registers between products.
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t desc_a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SIMVG_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SIMVG_D32_OUT
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// d += A B, m64n64k16, A from registers (acc_to_a), B from shared memory
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SIMVG_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SIMVG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef SIMVG_D32
#undef SIMVG_D32_OUT
#undef SIMVG_D32_LIST

// C = A B^T over the 64-wide head dim: both tiles K-major in shared memory
// (S = Q K^T, dP = dO V^T and their transposes), four k16 slices.
__device__ __forceinline__ void product_nt(float (&d)[32], const void* a_tile,
                                           const void* b_tile) {
  const char* a = static_cast<const char*>(a_tile);
  const char* b = static_cast<const char*>(b_tile);
  wgmma_ss_first(d, desc_sw128(a), desc_sw128(b));
#pragma unroll
  for (int kk = 1; kk < kHd / 16; ++kk)
    wgmma_ss(d, desc_sw128(a + 32 * kk), desc_sw128(b + 32 * kk));
}

// Columns [16 kk, 16 kk + 16) of an accumulator, rounded to bf16, as the A
// operand of k16 slice kk.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[32], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// acc += A B over the 64 rows of B: A the four k16 slices of a 64 x 64
// operand in registers (acc_to_a), B a tile whose rows are the reduction dim
// (MN-major).  The caller fences after writing A or acc (wgmma_fence).
__device__ __forceinline__ void product_an(float (&acc)[32], const uint32_t (&a)[kRows / 16][4],
                                           const void* b_tile) {
  const char* b = static_cast<const char*>(b_tile);
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) wgmma_rs_t(acc, a[kk], desc_sw128(b + 2048 * kk));
}

// acc += round(p) B: p an accumulator (rows x 64 columns) rounded to bf16 as
// the A operand of product_an.  The A operands are written before the fence
// that orders them for wgmma.
__device__ __forceinline__ void product_pn(float (&acc)[32], const float (&p)[32],
                                           const void* b_tile) {
  uint32_t a[kRows / 16][4];
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) acc_to_a(a[kk], p, kk);
  wgmma_fence();
  product_an(acc, a, b_tile);
}

// Register A operands may be rewritten only after the wgmma_wait of the
// products that read them; this keeps the compiler from moving the writes
// across it.
__device__ __forceinline__ void fence_a(uint32_t (&a)[kRows / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
}

// Writes an accumulator, rounded to bf16, into a 128-byte-swizzled
// shared tile (the layout a TMA store reads); warp w writes rows
// [16 w, 16 w + 16).
__device__ __forceinline__ void acc_to_tile(void* tile, const float (&d)[32], int warp,
                                            int lane) {
  char* base = static_cast<char*>(tile);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      // column 8 n + 2 t: chunk n, byte 4 t within it
      const int off = r * 128 + ((n ^ (r & 7)) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(base + off) =
          pack_bf16(d[4 * n + 2 * h], d[4 * n + 2 * h + 1]);
    }
  }
}

}  // namespace sm90
}  // namespace simvg
