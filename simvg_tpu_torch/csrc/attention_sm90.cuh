// Hopper building blocks of the bf16 attention kernels (attention_fwd.cu,
// attention_bwd.cu): TMA tile loads and stores through tensor maps,
// mbarriers, and the warpgroup product wgmma.mma_async (bf16 operands, fp32
// sums), its shared-memory descriptors and the register layout of its
// fragments, for head dims 32, 64, 128 and 256 (Geom<HD>), and the 16 KB
// slots of the streamed route above 256.
//
// Tiles.  A tile is 64 rows of one head of a [B, S, H, HD] bf16 tensor, read
// in place by a 4-D tensor map (dims HD, H, S, B innermost first).  It sits in
// shared memory as one or two boxes of 64 rows, each in the swizzle that
// wgmma reads (16-byte chunk c of row r at chunk c ^ f(r)):
//   HD 32:  one box of 64-byte rows, the 64-byte swizzle (f(r) = (r / 2) % 4);
//   HD 64:  one box of 128-byte rows, the 128-byte swizzle (f(r) = r % 8);
//   HD 128: two boxes of 128-byte rows (columns 0-63, then 64-127), each
//           8 KB and in the 128-byte swizzle: a 256-byte row is wider than
//           any swizzle atom, so TMA brings it as two boxes;
//   HD 256: four such boxes (columns 0-63, ..., 192-255), 32 KB a tile.
// A block that produces only a chunk of an output's columns (OC of them, a
// multiple of 64) reads the chunk's boxes of a tile as a Geom<OC> tile: box x
// of chunk c is box c OC / 64 + x of the whole.
//
// The streamed route (head dims above 256, any multiple of 128) holds no
// whole tile: a ring of 16 KB slots, each two 8 KB boxes of 64 rows x 64
// columns (two operands' box x of the head dim, or one Geom<128> chunk), so
// shared memory does not grow with the head dim (stream_box_product).
// TMA zero-fills the rows past S and clips them on a store, so the ragged
// end needs no mask.
//
// Descriptors (PTX ISA, "Matrix Descriptor Format"): a tile read with the
// head dim as the reduction dim (Q, K, V, dO in S = Q K^T, dP = dO V^T) is
// K-major: 8-row groups 8 rows apart (SBO: 512 or 1024 bytes), the k16 slice
// kk starting 32 kk bytes into its box's row (kk = 0 .. HD/16 - 1; at HD 128
// slices 4-7 in the second box, and so on).  A tile read with the rows as the reduction
// dim (V in O = P V; K in dQ = dS K; Q and dO in dK, dV) is MN-major: each
// box's columns are one swizzle atom, 8-row groups SBO apart, the k16 slice
// kk starting 16 kk rows in; the instruction's transpose bit set.  Such a
// product has N = HD (or OC): m64n32k16 at HD 32, m64n64k16 at HD 64, and
// one m64n64k16 a box above.
//
// Fragments of a warpgroup (4 warps, warp w on rows [16 w, 16 w + 16)),
// lane = 4 g + t: the accumulator of m64nN holds N/2 floats a thread,
// d[4 n + e] at row g (e < 2) or g + 8 (e >= 2) and column 8 n + 2 t + (e & 1);
// an A operand from registers (m64k16) holds 4 words, the same layout as an
// mma.m16n8k16 A fragment.  So accumulator columns [16 kk, 16 kk + 16), rounded
// to bf16, are the A operand of k16 slice kk of the next product (acc_to_a),
// with no trip through shared memory.  An output accumulator (O, dQ, dK,
// dV) is Geom<HD>::Acc: one m64n32 or m64n64 accumulator a box.
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
constexpr int kWarpgroup = 128;

// The shared-memory geometry of a [64, HD] bf16 tile.
template <int HD>
struct Geom {
  static_assert(HD == 32 || HD == 64 || HD == 128 || HD == 256,
                "head_dim 32, 64, 128 or 256");
  static constexpr int kBoxCols = HD < 64 ? HD : 64;   // columns of a box
  static constexpr int kBoxes = HD / kBoxCols;          // boxes a tile
  static constexpr int kRowBytes = 2 * kBoxCols;        // a box's row: the swizzle
  static constexpr int kBoxBytes = kRows * kRowBytes;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kSlices = kBoxCols / 16;         // k16 slices a box row
  static constexpr int kAccFloats = kBoxCols / 2;       // a box's accumulator
  // an output accumulator of 64 rows x HD columns
  typedef float Acc[kBoxes][kAccFloats];
};

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

// Makes the current device's primary context current on the calling thread
// (cudaSetDevice does since CUDA 12).  cuTensorMapEncodeTiled is a driver
// call and fails with CUDA_ERROR_INVALID_CONTEXT on a thread that has no
// current context, as autograd's backward thread has none when the first
// node it runs is K2.  Returns the runtime's error.
inline cudaError_t bind_context() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : cudaSetDevice(dev);
}

// The map of one [batch, seq, heads, hd] bf16 tensor, boxes of 64 rows of
// one head and `box_cols` (32 or 64) columns in their swizzle, zero fill
// past the ends.  Returns false on failure.
inline bool make_box_map(CUtensorMap* map, const void* base, int batch, int seq, int heads,
                         int hd, int box_cols) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)seq * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a [batch, seq, heads, HD] tensor in Geom<HD>'s boxes.
template <int HD>
inline bool make_tile_map(CUtensorMap* map, const void* base, int batch, int seq,
                          int heads) {
  return make_box_map(map, base, batch, seq, heads, HD, Geom<HD>::kBoxCols);
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

// One box (columns [col, col + kBoxCols) of head `head`, rows [row0, row0 +
// 64), batch `b`) into shared memory, completing its bytes on `bar`.
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                             int col, int head, int row0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(head), "r"(row0),
      "r"(b)
      : "memory");
}

// One 64-row tile, box by box, of HD columns from column `col0`
// (a chunk of a wider tensor, or 0); Geom<HD>::kTileBytes complete on `bar`.
template <int HD>
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int head, int row0, int b, int col0 = 0) {
  using G = Geom<HD>;
#pragma unroll
  for (int x = 0; x < G::kBoxes; ++x)
    tma_load_box(static_cast<char*>(dst) + x * G::kBoxBytes, map, bar, col0 + x * G::kBoxCols,
                 head, row0, b);
}

// A shared tile back to global memory, box by box, to columns [col0, col0 +
// HD); rows past the tensor's end are not written.  The caller fences the
// generic-proxy writes first.
template <int HD>
__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map, const void* src, int head,
                                               int row0, int b, int col0 = 0) {
  using G = Geom<HD>;
#pragma unroll
  for (int x = 0; x < G::kBoxes; ++x)
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group"
        " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(static_cast<const char*>(src) + x * G::kBoxBytes)),
        "r"(col0 + x * G::kBoxCols), "r"(head), "r"(row0), "r"(b)
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
// swizzle wants (512 would do for the 64-byte one); a launch asks for 1024
// more than its layout needs.
__device__ __forceinline__ char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return reinterpret_cast<char*>(raw) + (((a + 1023) & ~1023u) - a);
}

// ---- device: wgmma -------------------------------------------------------

// A descriptor of a swizzled box of HD's rows starting at `p` (aligned to its
// swizzle pattern, plus the k-slice's offset): SBO 8 rows, LBO unused (1),
// the layout type 1 (128-byte swizzle) or 2 (64-byte).
template <int HD>
__device__ __forceinline__ uint64_t desc(const void* p) {
  using G = Geom<HD>;
  const uint64_t addr = smem_u32(p);
  constexpr uint64_t layout = G::kRowBytes == 128 ? 1 : 2;
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(8 * G::kRowBytes >> 4) << 32) |
         (layout << 62);
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
template <int F>
__device__ __forceinline__ void fence_acc(float (&d)[F]) {
#pragma unroll
  for (int i = 0; i < F; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int X, int F>
__device__ __forceinline__ void fence_acc(float (&d)[X][F]) {
#pragma unroll
  for (int x = 0; x < X; ++x) fence_acc(d[x]);
}

#define SIMVG_D16                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define SIMVG_D32                                                                          \
  SIMVG_D16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),        \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SIMVG_D32_OUT                                                                      \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),      \
      "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]),           \
      "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]),        \
      "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),        \
      "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),        \
      "=f"(d[31])
#define SIMVG_D16_LIST \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
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

// The same at N = 32 (m64n32k16): the output products at HD 32.
__device__ __forceinline__ void wgmma_rs_t(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SIMVG_D16_LIST
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : SIMVG_D16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef SIMVG_D16
#undef SIMVG_D32
#undef SIMVG_D32_OUT
#undef SIMVG_D16_LIST
#undef SIMVG_D32_LIST

// C = A B^T over the head dim: both tiles K-major in shared memory (S = Q
// K^T, dP = dO V^T and their transposes), HD / 16 k16 slices, box by box.
template <int HD>
__device__ __forceinline__ void product_nt(float (&d)[32], const void* a_tile,
                                           const void* b_tile) {
  using G = Geom<HD>;
  const char* a = static_cast<const char*>(a_tile);
  const char* b = static_cast<const char*>(b_tile);
  wgmma_ss_first(d, desc<HD>(a), desc<HD>(b));
#pragma unroll
  for (int kk = 1; kk < HD / 16; ++kk) {
    const int off = (kk / G::kSlices) * G::kBoxBytes + 32 * (kk % G::kSlices);
    wgmma_ss(d, desc<HD>(a + off), desc<HD>(b + off));
  }
}

// The same over one 64-column box pair of the streamed route: C += A B^T
// (C = A B^T when `first`), four k16 slices of two boxes in the 128-byte
// swizzle.
__device__ __forceinline__ void product_nt_box(float (&d)[32], const void* a_box,
                                               const void* b_box, bool first) {
  const char* a = static_cast<const char*>(a_box);
  const char* b = static_cast<const char*>(b_box);
  if (first)
    wgmma_ss_first(d, desc<64>(a), desc<64>(b));
  else
    wgmma_ss(d, desc<64>(a), desc<64>(b));
#pragma unroll
  for (int kk = 1; kk < 4; ++kk) wgmma_ss(d, desc<64>(a + 32 * kk), desc<64>(b + 32 * kk));
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
// (MN-major), one product a box.  The caller fences after writing A or acc
// (wgmma_fence).
template <int HD>
__device__ __forceinline__ void product_an(typename Geom<HD>::Acc& acc,
                                           const uint32_t (&a)[kRows / 16][4],
                                           const void* b_tile) {
  using G = Geom<HD>;
  const char* b = static_cast<const char*>(b_tile);
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
    for (int x = 0; x < G::kBoxes; ++x)
      wgmma_rs_t(acc[x], a[kk], desc<HD>(b + x * G::kBoxBytes + 16 * G::kRowBytes * kk));
}

// acc += round(p) B: p an accumulator (rows x 64 columns) rounded to bf16 as
// the A operand of product_an.  The A operands are written before the fence
// that orders them for wgmma.
template <int HD>
__device__ __forceinline__ void product_pn(typename Geom<HD>::Acc& acc, const float (&p)[32],
                                           const void* b_tile) {
  uint32_t a[kRows / 16][4];
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) acc_to_a(a[kk], p, kk);
  wgmma_fence();
  product_an<HD>(acc, a, b_tile);
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

// ---- the streamed route: a ring of 16 KB slots --------------------------

constexpr int kSlotBytes = 16384;  // two 8 KB boxes of 64 rows x 64 columns
constexpr int kBoxBytes64 = 8192;

// A ring of kSlots slots with a full and an empty barrier each.  Producer and
// consumers walk the same sequence of slot uses u = 0, 1, ...; use u takes
// slot u % kSlots in phase u / kSlots.
template <int kSlots>
struct SlotRing {
  char* slots;
  uint64_t* full;   // [kSlots], one arrival (the producer's lane 0) + the bytes
  uint64_t* empty;  // [kSlots], the consumer warpgroup's 128 arrivals
  static constexpr size_t kSmem = (size_t)kSlots * kSlotBytes + 16 * kSlots + 1024;

  __device__ __forceinline__ SlotRing(char* smem)
      : slots(smem),
        full(reinterpret_cast<uint64_t*>(smem + kSlots * kSlotBytes)),
        empty(full + kSlots) {}
  __device__ __forceinline__ void init() {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarpgroup);
    }
  }
  __device__ __forceinline__ char* slot(int u) const { return slots + (u % kSlots) * kSlotBytes; }
  // producer: waits until use u's slot is free and announces its 16 KB
  __device__ __forceinline__ char* produce(int u) {
    uint64_t* e = &empty[u % kSlots];
    mbar_wait(e, ((u / kSlots) & 1) ^ 1);
    mbar_arrive_expect_tx(&full[u % kSlots], kSlotBytes);
    return slot(u);
  }
  __device__ __forceinline__ uint64_t* bar(int u) { return &full[u % kSlots]; }
  // consumers: wait until use u's boxes have landed
  __device__ __forceinline__ const char* consume(int u) {
    mbar_wait(&full[u % kSlots], (u / kSlots) & 1);
    return slot(u);
  }
  __device__ __forceinline__ void release(int u) { mbar_arrive(&empty[u % kSlots]); }
};

// The producer's part of a product over the whole head dim: box x of A
// (rows a_row0) and of B (rows b_row0) into one slot each, x = 0 .. n_box - 1.
template <int kSlots>
__device__ __forceinline__ void stream_box_pairs(SlotRing<kSlots>& ring, int& u, int n_box,
                                                 const CUtensorMap* tm_a, int a_row0,
                                                 const CUtensorMap* tm_b, int b_row0, int head,
                                                 int b) {
  for (int x = 0; x < n_box; ++x, ++u) {
    char* dst = ring.produce(u);
    tma_load_box(dst, tm_a, ring.bar(u), 64 * x, head, a_row0, b);
    tma_load_box(dst + kBoxBytes64, tm_b, ring.bar(u), 64 * x, head, b_row0, b);
  }
}

// The producer's part of an output product: one 128-column chunk (from
// column col0) of a tile into one slot, as a Geom<128> tile.
template <int kSlots>
__device__ __forceinline__ void stream_chunk(SlotRing<kSlots>& ring, int& u,
                                             const CUtensorMap* tm, int row0, int col0,
                                             int head, int b) {
  char* dst = ring.produce(u);
  tma_load_tile<128>(dst, tm, ring.bar(u), head, row0, b, col0);
  ++u;
}

// The consumers' part: d = A B^T over the head dim, one box pair a slot,
// each slot released once its product has run.
template <int kSlots>
__device__ __forceinline__ void stream_box_product(float (&d)[32], SlotRing<kSlots>& ring,
                                                   int& u, int n_box) {
  for (int x = 0; x < n_box; ++x, ++u) {
    const char* p = ring.consume(u);
    wgmma_fence();
    product_nt_box(d, p, p + kBoxBytes64, x == 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(d);
    ring.release(u);
  }
}

// Writes an output accumulator, rounded to bf16, into a swizzled shared tile
// (the layout a TMA store reads), box by box; warp w writes rows
// [16 w, 16 w + 16).
template <int HD>
__device__ __forceinline__ void acc_to_tile(void* tile, const typename Geom<HD>::Acc& d,
                                            int warp, int lane) {
  using G = Geom<HD>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int x = 0; x < G::kBoxes; ++x) {
    char* base = static_cast<char*>(tile) + x * G::kBoxBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;
      // the swizzle's row term: r % 8 (128-byte rows), (r / 2) % 4 (64-byte)
      const int f = G::kRowBytes == 128 ? (r & 7) : ((r >> 1) & 3);
#pragma unroll
      for (int n = 0; n < G::kBoxCols / 8; ++n) {
        // column 8 n + 2 t: chunk n, byte 4 t within it
        const int off = r * G::kRowBytes + ((n ^ f) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(base + off) =
            pack_bf16(d[x][4 * n + 2 * h], d[x][4 * n + 2 * h + 1]);
      }
    }
  }
}

}  // namespace sm90
}  // namespace simvg
