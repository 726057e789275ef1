// PNG unfiltering and colour conversion for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package decodes PNG on the host with cv2
// (libpng).  The port decodes on the card, as it decodes JPEG with nvJPEG:
// simvg_tpu_torch/data/png.py walks the chunks and inflates the image data
// on the host (zlib), and these two kernels turn the inflated bytes into the
// BGR uint8 [h, w, 3] image that cv2.imdecode(..., IMREAD_COLOR) gives:
//
//   unfilter_kernel  undoes each row's filter (0 None, 1 Sub, 2 Up, 3 Average,
//                    4 Paeth) in place, a cluster of kCluster blocks per pass
//                    (Adam7's seven, or the whole image), one instantiation
//                    per bytes-per-pixel;
//   convert_kernel   one thread per output pixel: finds its pass and position,
//                    reads its samples (1, 2, 4, 8 or 16 bits; a 16-bit sample
//                    gives its high byte, v >> 8) and writes B, G, R: gray
//                    replicated (1, 2, 4 bits scaled by 255, 85, 17), the
//                    palette expanded (BGR, zeros past PLTE), alpha dropped.
//
// Where the trouble is.  Average and Paeth make each byte depend on its left
// neighbour (bpp bytes back) and on the row above, so no two bytes of a row
// and no two rows are independent: the dependency chain is units + rows - 1
// steps long (1,119 for 640 x 480 RGB), whatever the card does.  What the
// design chooses is what a step costs, and it keeps the chain in registers:
//
//   a warp owns 32 consecutive rows, a lane a row; lane l undoes unit u at
//   warp step u + l.  The row above's unit u is what lane l - 1 made the
//   step before (__shfl_up_sync); Paeth's up-left is the value the lane took
//   that way a step earlier.  The predictor has no branch: a warp's rows
//   carry every filter type;
//   a lane streams its row: 4-byte words copied 16 ahead into its window of
//   shared memory (cp.async; lane l's words all in bank l), taken a unit at
//   a time from a 64-bit buffer, and the unfiltered bytes gathered into
//   whole 4-byte words (those a row shares with a neighbour a byte at a
//   time): each byte read once and written once;
//   the row groups form a pipeline over the cluster's SMs, two warps an SM
//   (one a scheduler; sixteen warps on one SM left it issue-bound, each step
//   of all of them queued behind the others): lane 31 hands its unit to the
//   warp of the next 32 rows, on the next SM, through a ring in that SM's
//   shared memory (distributed shared memory: an 8-byte store of the unit
//   and its sequence number, which the reader polls); past kSlots groups
//   the warps go round again.
//
// What bounds it: the chain's steps, each the instruction stream of one warp
// (some two hundred instructions for RGB: the three bytes' predictors, the
// stream's buffers, the hand-over), issued in order on a scheduler of its
// own, half of them on the SM's half-rate integer pipe.  A step is one block
// of predicated code: a branch taken by some lanes would run the warp's
// paths one after the other.  The bytes (0.9 MB in and out at 640 x 480
// RGB) are three orders of magnitude below the card's rate.  The host's inflate of the same image takes longer
// than both kernels (PERF.md gives the times).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (simvg_tpu_torch/ops/_build.py); called through ctypes with a plain C ABI.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;      // SMs a pass runs on: a block each, one cluster
constexpr int kBlockWarps = 2;   // warps a block, each on its own scheduler
constexpr int kSlots = kCluster * kBlockWarps;  // row groups of 32 in flight
constexpr int kRing = 128;       // units a hand-over ring holds (a power of two)
constexpr int kPublish = 16;     // units between two reports of a ring's reader
constexpr int kAhead = 16;       // words of its row a lane has in flight
constexpr int kUnfilterThreads = kBlockWarps * 32;
constexpr int kConvertThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// The passes of an image: Adam7's seven (an empty one, with no pixels, has
// no bytes either), or one that is the whole image.
struct Passes {
  int n;
  int x0[7], y0[7], dx[7], dy[7], w[7], h[7], rowbytes[7];
  long long offset[7];  // of the pass's first filter byte in the data
};

// A block's shared memory.  For each of its warps: the ring that the warp
// of the 32 rows above fills from another SM (a unit a slot, its bytes in
// the low word beside a tag, the unit's sequence number + 1, in the high
// word, so that one 8-byte store hands over both; a second ring for the
// bytes past 4), and how many units the warp of the rows below has taken
// from the ring this warp fills.
struct UnfilterShared {
  unsigned long long ring[kBlockWarps][2][kRing];
  // each lane's next kAhead words of its row, word k at [k % kAhead][lane]
  // (lane l's words all in bank l)
  uint32_t window[kBlockWarps][kAhead][32];
  int consumed[kBlockWarps];
};

__device__ __forceinline__ void copy_async4_if(bool p, uint32_t* dst, const uint32_t* src) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], 4;\n}\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(dst)),
      "l"(src), "r"((int)p)
      : "memory");
}
__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void copy_async_wait() {  // all but the last kAhead - 1 groups
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
}

// The row's bytes, a unit at a time, from aligned 4-byte words of device
// memory copied kAhead words ahead into the lane's window (cp.async, a
// group a word, so that no register waits on device memory); `bits` holds
// the next bytes, lowest first.
struct RowReader {
  const uint32_t* words;
  int n, q, k;    // the row's words; the next to request; the next to read
  uint32_t* win;  // the lane's word 0 of its window; word slot j 32 words on
  unsigned long long bits;
  int nbits;
  __device__ __forceinline__ void request() {
    copy_async4_if(q < n, win + 32 * (q % kAhead), words + q);
    copy_async_commit();
    ++q;
  }
  __device__ __forceinline__ void refill() {
    copy_async_wait();
    bits |= (unsigned long long)win[32 * (k % kAhead)] << nbits;
    nbits += 32;
    ++k;
    request();  // into the slot just read
  }
  // the next `nbytes` (at most 4) bytes, lowest first, if `p` (else the
  // reader stays); no branch, so that a step is one block of code
  __device__ __forceinline__ uint32_t take(bool p, int nbytes) {
    const bool need = p && nbits < 8 * nbytes;
    copy_async_wait();  // a group a call: word k's is older than kAhead - 1
    const uint32_t w = win[32 * (k % kAhead)];
    bits |= need ? (unsigned long long)w << nbits : 0ull;
    nbits += need ? 32 : 0;
    k += need;
    copy_async4_if(need && q < n, win + 32 * (q % kAhead), words + q);  // the slot just read
    copy_async_commit();
    q += need;
    const uint32_t v = (uint32_t)bits;
    bits = p ? bits >> (8 * nbytes) : bits;
    nbits -= p ? 8 * nbytes : 0;
    return v;
  }
};

// The unfiltered bytes, gathered into aligned 4-byte words written whole
// (those the row shares with a neighbour a byte at a time).
struct RowWriter {
  uint32_t* words;
  int lead, q;  // the row's first byte in words[0]; the next word
  unsigned long long bits;
  int nbits;
  __device__ __forceinline__ void put(bool p, uint32_t v, int nbytes) {  // if `p`
    bits |= p ? (unsigned long long)v << nbits : 0ull;
    nbits += p ? 8 * nbytes : 0;
    const bool emit = nbits >= 32;
    if (emit && q == 0 && lead > 0) {
      for (int k = lead; k < 4; ++k) reinterpret_cast<uint8_t*>(words)[k] = (uint8_t)(bits >> (8 * k));
    } else if (emit) {
      words[q] = (uint32_t)bits;
    }
    bits = emit ? bits >> 32 : bits;
    nbits -= emit ? 32 : 0;
    q += emit;
  }
  __device__ __forceinline__ void finish() {
    uint8_t* at = reinterpret_cast<uint8_t*>(words + q);
    for (int k = q == 0 ? lead : 0; k < nbits / 8; ++k) at[k] = (uint8_t)(bits >> (8 * k));
  }
};

__device__ __forceinline__ int unit_byte(uint2 v, int i) {
  return (int)(((i < 4 ? v.x : v.y) >> (8 * (i & 3))) & 255u);
}

// Undoes the filters of one pass in place.  Row group g (rows 32 g ..
// 32 g + 31) runs on warp slot g % kSlots of the pass's cluster, a lane a
// row: lane l undoes unit u of its row at step u + l, taking the row
// above's unit u from lane l - 1 (__shfl_up_sync of the step before; lane
// 0 from the ring the slot of the rows above fills) and its up-left from
// the step before.  The predictor is branch-free, since the lanes of a warp
// hold rows of every filter type.
template <int BPP>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kUnfilterThreads)
unfilter_kernel(uint8_t* __restrict__ data, Passes ps) {
  extern __shared__ __align__(16) uint8_t smem[];
  UnfilterShared& sh = *reinterpret_cast<UnfilterShared*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int p = blockIdx.y, rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = ps.h[p], rb = ps.rowbytes[p];
  const bool empty = ps.w[p] == 0 || h == 0;
  const int units = rb / BPP;  // BPP divides rowbytes: it is 1 below 8 bits
  for (int i = threadIdx.x; i < kBlockWarps * 2 * kRing; i += blockDim.x) (&sh.ring[0][0][0])[i] = 0;
  if (threadIdx.x < kBlockWarps) {
    // a ring's counts run on over its reader's row groups, `units` a group;
    // slot 0's first group has no rows above, so its ring starts one ahead
    const int reader = (threadIdx.x * kCluster + rank + 1) % kSlots;
    sh.consumed[threadIdx.x] = reader == 0 ? units : 0;
  }
  cluster.sync();
  const int slot = warp * kCluster + rank, groups = (h + 31) >> 5;
  const int next = (slot + 1) % kSlots, prev = (slot + kSlots - 1) % kSlots;
  UnfilterShared* below = cluster.map_shared_rank(&sh, (unsigned)(next % kCluster));
  UnfilterShared* above = cluster.map_shared_rank(&sh, (unsigned)(prev % kCluster));
  for (int g = slot; !empty && g < groups; g += kSlots) {
    const int r = 32 * g + lane;
    const bool active = r < h;
    uint8_t* const row = data + ps.offset[p] + (long long)(active ? r : 0) * (rb + 1) + 1;
    const int f = active ? row[-1] : 0;
    const bool sub = f == 1, up = f == 2, avg = f == 3, paeth = f == 4;
    const int lead = (int)(reinterpret_cast<uintptr_t>(row) & 3);
    uint32_t* const words = reinterpret_cast<uint32_t*>(row - lead);
    const int nwords = active ? (lead + rb + 3) >> 2 : 0;
    RowReader in{words, nwords, 0, 0, &sh.window[warp][0][lane], 0, 0};
    for (int j = 0; j < kAhead; ++j) in.request();
    in.refill();
    in.bits >>= 8 * lead;
    in.nbits -= 8 * lead;
    RowWriter out{words, lead, 0, 0, 8 * lead};
    const bool feeds = g + 1 < groups;  // lane 31 hands its row on
    const int seq = (g / kSlots) * units, seq_next = ((g + 1) / kSlots) * units;
    unsigned long long* const ring_in = &sh.ring[warp][0][0];
    unsigned long long* const ring_out = &below->ring[next / kCluster][0][0];
    int* const reported = &above->consumed[prev / kCluster];
    int a[BPP] = {}, c[BPP] = {};
    uint2 b = make_uint2(0, 0);
    for (int s = 0; s < units + 31; ++s) {
      const int u = s - lane;
      const bool mine = active && u >= 0 && u < units;
      if (g > 0 && s < units) {  // lane 0: the row above's unit s, from the ring
        const int at = (seq + s) & (kRing - 1);
        const unsigned tag = (unsigned)(seq + s + 1);
        volatile unsigned long long* e = ring_in + at;
        unsigned long long v = e[0], w = BPP > 4 ? e[kRing] : 0ull;
        const bool late = (unsigned)(v >> 32) != tag || (BPP > 4 && (unsigned)(w >> 32) != tag);
        if (__any_sync(kFull, lane == 0 && late)) {
          // a poll that never pauses holds off the other SM's stores to the
          // ring, and the whole chain with them
          if (lane == 0) {
            while ((unsigned)((v = e[0]) >> 32) != tag) __nanosleep(20);
            while (BPP > 4 && (unsigned)((w = e[kRing]) >> 32) != tag) __nanosleep(20);
          }
          __syncwarp();
        }
        if (lane == 0) b = make_uint2((uint32_t)v, (uint32_t)w);
        if (lane == 0 && (s & (kPublish - 1)) == 0) *reinterpret_cast<volatile int*>(reported) = seq + s;
      }
      const uint32_t x0 = in.take(mine, BPP < 4 ? BPP : 4);
      const uint32_t x1 = BPP > 4 ? in.take(mine, BPP - 4) : 0u;
      const bool first = u == 0;
      uint2 o = make_uint2(0, 0);
#pragma unroll
      for (int i = 0; i < BPP; ++i) {
        const int ai = first ? 0 : a[i], bi = unit_byte(b, i), ci = first ? 0 : c[i];
        const int d1 = bi - ci, d2 = ai - ci;
        const int pa = abs(d1), pb = abs(d2), pc = abs(d1 + d2);
        const int near = pa <= min(pb, pc) ? ai : pb <= pc ? bi : ci;
        const int left_or_up = sub ? ai : bi;
        const int smooth = avg ? (ai + bi) >> 1 : near;
        const int pred = sub || up ? left_or_up : avg || paeth ? smooth : 0;
        const int v = ((int)((i < 4 ? x0 : x1) >> (8 * (i & 3))) + pred) & 255;
        a[i] = v;
        c[i] = bi;
        if (i < 4)
          o.x |= (uint32_t)v << (8 * i);
        else
          o.y |= (uint32_t)v << (8 * (i - 4));
      }
      out.put(mine, o.x, BPP < 4 ? BPP : 4);
      if (BPP > 4) out.put(mine, o.y, BPP - 4);
      if (mine && u == units - 1) out.finish();
      const int u31 = s - 31;  // lane 31's unit, to the warp of the next rows
      if (feeds && u31 >= 0 && u31 < units) {
        if ((u31 & (kPublish - 1)) == 0)
          while (*reinterpret_cast<volatile int*>(&sh.consumed[warp]) < seq_next + u31 + kPublish - kRing)
            __nanosleep(20);
        if (lane == 31) {
          const int at = (seq_next + u31) & (kRing - 1);
          const unsigned long long tag = (unsigned long long)(seq_next + u31 + 1) << 32;
          *reinterpret_cast<volatile unsigned long long*>(ring_out + at) = tag | o.x;
          if (BPP > 4) *reinterpret_cast<volatile unsigned long long*>(ring_out + kRing + at) = tag | o.y;
        }
      }
      const uint32_t ux = __shfl_up_sync(kFull, o.x, 1);
      const uint32_t uy = BPP > 4 ? __shfl_up_sync(kFull, o.y, 1) : 0u;
      if (lane > 0) b = make_uint2(ux, uy);
    }
    if (lane == 0 && g > 0 && active) *reinterpret_cast<volatile int*>(reported) = seq + units;
  }
  cluster.sync();  // no block leaves while another may still write its rings
}

// Adam7's pass (0-6) of a pixel at (y % 8, x % 8).
__constant__ uint8_t kAdam7[8][8] = {
    {0, 5, 3, 5, 1, 5, 3, 5}, {6, 6, 6, 6, 6, 6, 6, 6}, {4, 5, 4, 5, 4, 5, 4, 5},
    {6, 6, 6, 6, 6, 6, 6, 6}, {2, 5, 3, 5, 2, 5, 3, 5}, {6, 6, 6, 6, 6, 6, 6, 6},
    {4, 5, 4, 5, 4, 5, 4, 5}, {6, 6, 6, 6, 6, 6, 6, 6}};

__global__ void __launch_bounds__(kConvertThreads)
convert_kernel(const uint8_t* __restrict__ data, Passes ps, int width, int height,
               int depth, int color_type, int channels, const uint8_t* __restrict__ palette,
               uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)width * height) return;
  const int y = (int)(i / width), x = (int)(i % width);
  const int p = ps.n > 1 ? kAdam7[y & 7][x & 7] : 0;
  const int r = (y - ps.y0[p]) / ps.dy[p], c = (x - ps.x0[p]) / ps.dx[p];
  const uint8_t* row = data + ps.offset[p] + (long long)r * (ps.rowbytes[p] + 1) + 1;
  int s[3];
  if (depth >= 8) {
    const int step = depth / 8;  // a 16-bit sample's first byte is its high one
    const int n = channels >= 3 ? 3 : 1;
    for (int k = 0; k < n; ++k) s[k] = row[((long long)c * channels + k) * step];
  } else {
    const int bit = c * depth;
    s[0] = (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
  }
  uint8_t* o = out + i * 3;
  if (color_type == 3) {
    o[0] = palette[s[0] * 3];
    o[1] = palette[s[0] * 3 + 1];
    o[2] = palette[s[0] * 3 + 2];
  } else if (channels <= 2) {  // gray, gray + alpha
    const int g = depth < 8 ? s[0] * (255 / ((1 << depth) - 1)) : s[0];
    o[0] = o[1] = o[2] = (uint8_t)g;
  } else {  // RGB, RGBA
    o[0] = (uint8_t)s[2];
    o[1] = (uint8_t)s[1];
    o[2] = (uint8_t)s[0];
  }
}

const int kAdam7Pass[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                              {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

}  // namespace

// data: the inflated image data on the card ([filter byte, row] for each row
// of each pass, `nbytes` in all), unfiltered in place; palette: BGR uint8
// [256, 3] on the card for colour type 3, else null; out: BGR uint8
// [height, width, 3].  Launches two kernels on `stream`; returns the CUDA
// error of the launches (0 if none), cudaErrorInvalidValue for a header the
// kernels do not take, data shorter than the header needs or data not
// aligned to 4 bytes.
extern "C" int simvg_png_decode(void* data, int width, int height, int bit_depth,
                                int color_type, int interlace, int nbytes,
                                const void* palette, void* out, void* stream) {
  int channels;
  switch (color_type) {
    case 0: case 3: channels = 1; break;
    case 2: channels = 3; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (width <= 0 || height <= 0 || interlace < 0 || interlace > 1 ||
      !(bit_depth == 1 || bit_depth == 2 || bit_depth == 4 || bit_depth == 8 ||
        bit_depth == 16) ||
      (bit_depth < 8 && channels != 1) || (color_type == 3 && (palette == nullptr ||
                                                                bit_depth == 16)))
    return (int)cudaErrorInvalidValue;
  const int bits = channels * bit_depth;
  const int bpp = bits >= 8 ? bits / 8 : 1;
  Passes ps = {};
  long long offset = 0;
  for (int q = 0; q < (interlace ? 7 : 1); ++q) {
    const int x0 = interlace ? kAdam7Pass[q][0] : 0, y0 = interlace ? kAdam7Pass[q][1] : 0;
    const int dx = interlace ? kAdam7Pass[q][2] : 1, dy = interlace ? kAdam7Pass[q][3] : 1;
    const int w = std::max(0, (width - x0 + dx - 1) / dx);
    const int h = std::max(0, (height - y0 + dy - 1) / dy);
    ps.n = q + 1;
    ps.x0[q] = x0;
    ps.y0[q] = y0;
    ps.dx[q] = dx;
    ps.dy[q] = dy;
    ps.w[q] = w;
    ps.h[q] = h;
    ps.rowbytes[q] = (int)(((long long)w * bits + 7) / 8);
    ps.offset[q] = offset;
    if (w > 0 && h > 0) offset += (long long)h * (ps.rowbytes[q] + 1);
  }
  // the rows are read and written in aligned 4-byte words, which may reach
  // up to 3 bytes before the first row and after the last one: inside the
  // allocation only if it starts on a 4-byte boundary (the wrapper's
  // allocations start on 256 bytes)
  if (offset > nbytes || (reinterpret_cast<uintptr_t>(data) & 3) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* d = static_cast<uint8_t*>(data);
  const dim3 grid(kCluster, ps.n);
  switch (bpp) {
    case 1: unfilter_kernel<1><<<grid, kUnfilterThreads, sizeof(UnfilterShared), s>>>(d, ps); break;
    case 2: unfilter_kernel<2><<<grid, kUnfilterThreads, sizeof(UnfilterShared), s>>>(d, ps); break;
    case 3: unfilter_kernel<3><<<grid, kUnfilterThreads, sizeof(UnfilterShared), s>>>(d, ps); break;
    case 4: unfilter_kernel<4><<<grid, kUnfilterThreads, sizeof(UnfilterShared), s>>>(d, ps); break;
    case 6: unfilter_kernel<6><<<grid, kUnfilterThreads, sizeof(UnfilterShared), s>>>(d, ps); break;
    default: unfilter_kernel<8><<<grid, kUnfilterThreads, sizeof(UnfilterShared), s>>>(d, ps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long pixels = (long long)width * height;
  const long long blocks = (pixels + kConvertThreads - 1) / kConvertThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  convert_kernel<<<(unsigned)blocks, kConvertThreads, 0, s>>>(
      d, ps, width, height, bit_depth, color_type, channels,
      static_cast<const uint8_t*>(palette), static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
