// WebP lossless (VP8L) for Hopper (sm_90a): the prefix-coded stream in host
// C++, the inverse transforms on the card.
//
// Replaces no TPU kernel: the JAX package decodes WebP on the host with cv2
// (libwebp).  simvg_tpu_torch/data/vp8l.py holds the plain version of both
// stages; chip_smoke.py holds this file's route, host stage included, to it.
//
//   simvg_vp8l_parse   host code, as sequential as the format: the header,
//                      the transforms with their sub-resolution images, the
//                      colour cache, the meta prefix codes and the main
//                      image's ARGB pixels (literals, cache hits, LZ77
//                      backward references through the 120-entry distance
//                      map), each prefix code decoded canonically a bit at a
//                      time (the zlib "puff" way: VP8L packs its codes as
//                      Deflate does);
//   predictor_pipeline_kernel
//                      the predictor transform: each pixel adds the
//                      prediction of its tile's mode (14 modes) from its
//                      left, top, top-left and top-right neighbours, which
//                      are final pixels: a chain of W + 2 (H - 1) steps
//                      (1,598 at 480 x 640), pixel (x, y) at step x + 2 y.
//                      A warp owns 32 rows, a lane a row (lane l at pixel
//                      x on step x + 2 l), the row above by __shfl_up_sync
//                      (top-right from the step before, top and top-left
//                      kept in registers); the row groups form a pipeline
//                      over a cluster of 4 SMs, four warps an SM, lane 31
//                      handing its pixels to the next group's warp through
//                      a ring in that SM's shared memory (an 8-byte store
//                      of a pixel and its sequence number, polled with a
//                      pause), as png.cu's unfilter does at lag 1.  A ring
//                      holds a whole row, a slot a pixel, and needs no
//                      flow control: the next round's writer of slot u
//                      (15 groups on) makes its pixel u from pixels its
//                      reader made after it took slot u.  Up to kWideRing
//                      pixels wide the rings lie in the cluster's shared
//                      memory; wider (the second route, the same code),
//                      in a buffer in device memory.  A step waits on no
//                      memory: the residuals
//                      stream into shared memory kAhead pixels ahead
//                      (cp.async), and the next residual, ring entry, mode
//                      word and the warp's modes are loaded a step before
//                      their use; the prediction is SIMD-in-a-word code
//                      selected by the mode's bits, skipping the averages
//                      or the select and clamps where no lane of the warp
//                      needs them;
//   pixel_kernel       one thread a pixel: cross-colour (the tile's three
//                      signed multipliers), subtract-green, colour-indexing
//                      (bundled indices unpacked, an index past the palette
//                      transparent black), and ARGB -> BGR with alpha
//                      dropped as IMREAD_COLOR drops it.
//
// What bounds it: the predictor's chain, whose length is fixed by the
// format; a step is the instruction stream of one warp (some 140
// instructions: the prediction, the streams, the hand-over), issued in
// order on a scheduler of its own, most on the half-rate integer pipe,
// about 500 cycles a step (PERF.md).  The bytes (1.2 MB in, 1.2 MB out at
// 480 x 640) are three orders of magnitude below the card's rate.  Before
// the kernels, the host's prefix decoding takes longer than every kernel
// together.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (simvg_tpu_torch/ops/_build.py); called through ctypes with a plain C ABI.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <string>
#include <vector>

namespace cg = cooperative_groups;

namespace {

enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3, TO_BGR = 4 };

const uint8_t kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
// libwebp's kCodeToPlane, as in data/vp8l.py
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

struct Error {
  std::string what;
};

struct Bits {
  const uint8_t* data;
  long long n;    // bits in the stream
  long long pos;  // bits read
  uint32_t read(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i, ++pos) {
      const long long byte = pos >> 3;
      const uint32_t b = byte < (n >> 3) ? (data[byte] >> (pos & 7)) & 1 : 0;
      v |= b << i;
    }
    return v;
  }
  bool eos() const { return pos > n; }
};

// A canonical prefix code: count of codes of each length and the symbols in
// canonical order; one symbol costs no bits.
struct Code {
  int count[16] = {};
  std::vector<int> symbols;
  int single = -1;

  explicit Code(const std::vector<int>& lengths) {
    int used = 0, only = -1, maxlen = 0;
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) {
        ++used;
        only = (int)s;
        maxlen = lengths[s] > maxlen ? lengths[s] : maxlen;
      }
    if (used == 0) throw Error{"VP8L prefix code with no symbol"};
    if (used == 1) {
      single = only;
      return;
    }
    long long room = 0;
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) {
        ++count[lengths[s]];
        room += 1ll << (maxlen - lengths[s]);
      }
    if (room != 1ll << maxlen) throw Error{"VP8L prefix code is not complete"};
    for (int l = 1; l < 16; ++l)
      for (size_t s = 0; s < lengths.size(); ++s)
        if (lengths[s] == l) symbols.push_back((int)s);
  }

  int read(Bits& br) const {
    if (single >= 0) return single;
    int code = 0, first = 0, index = 0;
    for (int l = 1; l < 16; ++l) {
      code |= (int)br.read(1);
      const int c = count[l];
      if (code - c < first) return symbols[index + (code - first)];
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    throw Error{"VP8L prefix code read failed"};
  }
};

Code read_code(Bits& br, int alphabet) {
  std::vector<int> lengths(alphabet, 0);
  if (br.read(1)) {  // simple code
    const int n = (int)br.read(1) + 1;
    const int first = (int)br.read(br.read(1) ? 8 : 1);
    int symbols[2] = {first, n == 2 ? (int)br.read(8) : -1};
    for (int k = 0; k < n; ++k) {
      if (symbols[k] >= alphabet) throw Error{"VP8L simple code symbol past its alphabet"};
      lengths[symbols[k]] = 1;
    }
    return Code(lengths);
  }
  std::vector<int> cl(19, 0);
  const int ncl = (int)br.read(4) + 4;
  for (int i = 0; i < ncl; ++i) cl[kCodeLengthOrder[i]] = (int)br.read(3);
  const Code cl_code(cl);
  int max_symbol = alphabet;
  if (br.read(1)) {
    const int nbits = 2 + 2 * (int)br.read(3);
    max_symbol = 2 + (int)br.read(nbits);
    if (max_symbol > alphabet) throw Error{"VP8L code length count past its alphabet"};
  }
  int s = 0, prev = 8;
  while (s < alphabet) {
    if (max_symbol-- == 0) break;
    const int c = cl_code.read(br);
    if (c < 16) {
      lengths[s++] = c;
      if (c) prev = c;
    } else {
      static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
      const int rep = (int)br.read(extra[c - 16]) + offset[c - 16];
      if (s + rep > alphabet) throw Error{"VP8L code length repeat past its alphabet"};
      for (int k = 0; k < rep; ++k) lengths[s++] = c == 16 ? prev : 0;
    }
  }
  if (br.eos()) throw Error{"truncated VP8L stream"};
  return Code(lengths);
}

int copy_distance(int sym, Bits& br) {
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  return ((2 + (sym & 1)) << extra) + (int)br.read(extra) + 1;
}

int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

std::vector<uint32_t> read_image(Bits& br, int xsize, int ysize, bool level0) {
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = (int)br.read(4);
    if (cache_bits < 1 || cache_bits > 11) throw Error{"VP8L colour cache size"};
  }
  int meta_bits = 0, mw = 0, groups = 1;
  std::vector<int> meta;
  if (level0 && br.read(1)) {
    meta_bits = (int)br.read(3) + 2;
    mw = subsample(xsize, meta_bits);
    const std::vector<uint32_t> sub = read_image(br, mw, subsample(ysize, meta_bits), false);
    meta.resize(sub.size());
    int top = 0;
    for (size_t k = 0; k < sub.size(); ++k) {
      meta[k] = (int)((sub[k] >> 8) & 0xFFFF);
      top = meta[k] > top ? meta[k] : top;
    }
    groups = top + 1;
  }
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  const int alphabets[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
  std::vector<std::vector<Code>> codes(groups);
  for (int g = 0; g < groups; ++g)
    for (int k = 0; k < 5; ++k) codes[g].push_back(read_code(br, alphabets[k]));
  const long long total = (long long)xsize * ysize;
  std::vector<uint32_t> out(total, 0);
  std::vector<uint32_t> cache(cache_size, 0);
  long long cached = 0, pos = 0;
  auto insert = [&](long long upto) {
    for (; cached < upto; ++cached) {
      const uint32_t p = out[cached];
      cache[(uint32_t)(p * 0x1E35A7BDu) >> (32 - cache_bits)] = p;
    }
  };
  while (pos < total) {
    const std::vector<Code>& g =
        meta.empty() ? codes[0]
                     : codes[meta[(pos / xsize >> meta_bits) * mw + ((pos % xsize) >> meta_bits)]];
    const int green = g[0].read(br);
    if (green < 256) {
      const uint32_t r = (uint32_t)g[1].read(br);
      const uint32_t b = (uint32_t)g[2].read(br);
      const uint32_t a = (uint32_t)g[3].read(br);
      out[pos++] = (a << 24) | (r << 16) | ((uint32_t)green << 8) | b;
    } else if (green < 256 + 24) {
      const int length = copy_distance(green - 256, br);
      const int dcode = copy_distance(g[4].read(br), br);
      long long dist;
      if (dcode > 120) {
        dist = dcode - 120;
      } else {
        const int d = kCodeToPlane[dcode - 1];
        dist = (long long)(d >> 4) * xsize + 8 - (d & 15);
        if (dist < 1) dist = 1;
      }
      if (dist > pos || pos + length > total) throw Error{"VP8L backward reference out of the image"};
      for (int k = 0; k < length; ++k, ++pos) out[pos] = out[pos - dist];
      if (br.eos()) throw Error{"truncated VP8L stream"};
    } else {
      insert(pos);
      out[pos] = cache[green - 256 - 24];
      ++pos;
    }
    if (cache_size) insert(pos);
  }
  if (br.eos()) throw Error{"truncated VP8L stream"};
  return out;
}

struct Parsed {
  std::string error;
  int width = 0, height = 0;
  std::vector<int> kinds, xsizes, bits;
  std::vector<std::vector<uint32_t>> arrays;  // each transform's data, then the pixels
};

void parse(const uint8_t* data, long long n, Parsed& p) {
  if (n < 5 || data[0] != 0x2F) throw Error{"not a VP8L stream"};
  const uint32_t v = data[1] | data[2] << 8 | data[3] << 16 | (uint32_t)data[4] << 24;
  if (v >> 29) throw Error{"VP8L version"};
  p.width = (int)(v & 0x3FFF) + 1;
  p.height = (int)((v >> 14) & 0x3FFF) + 1;
  Bits br{data, 8 * n, 40};
  int xsize = p.width, seen = 0;
  while (br.read(1)) {
    const int kind = (int)br.read(2);
    if (seen & (1 << kind)) throw Error{"VP8L transform used twice"};
    seen |= 1 << kind;
    p.kinds.push_back(kind);
    p.xsizes.push_back(xsize);
    if (kind == PREDICTOR || kind == CROSS_COLOR) {
      const int b = (int)br.read(3) + 2;
      p.bits.push_back(b);
      p.arrays.push_back(read_image(br, subsample(xsize, b), subsample(p.height, b), false));
    } else if (kind == COLOR_INDEXING) {
      const int colors = (int)br.read(8) + 1;
      const int b = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
      p.bits.push_back(b);
      std::vector<uint32_t> pal = read_image(br, colors, 1, false);
      std::vector<uint32_t> full(256, 0);
      uint8_t acc[4] = {0, 0, 0, 0};
      for (int k = 0; k < colors; ++k) {  // each entry adds the last, byte by byte
        uint32_t e = 0;
        for (int c = 0; c < 4; ++c) {
          acc[c] = (uint8_t)(acc[c] + ((pal[k] >> (8 * c)) & 0xFF));
          e |= (uint32_t)acc[c] << (8 * c);
        }
        full[k] = e;
      }
      p.arrays.push_back(full);
      xsize = subsample(xsize, b);
    } else {
      p.bits.push_back(0);
      p.arrays.push_back({});
    }
  }
  p.arrays.push_back(read_image(br, xsize, p.height, true));
}

// ---- the kernels ------------------------------------------------------------

__device__ __forceinline__ uint32_t add_px(uint32_t a, uint32_t b) {
  return (((a & 0xFF00FF00u) + (b & 0xFF00FF00u)) & 0xFF00FF00u) |
         (((a & 0x00FF00FFu) + (b & 0x00FF00FFu)) & 0x00FF00FFu);
}
__device__ __forceinline__ uint32_t avg2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xFEFEFEFEu) >> 1) + (a & b);
}
// The prediction of the 14 modes on packed ARGB words, each byte a lane
// of a SIMD word: no branch, so that lanes holding different modes run one
// block of code.  Modes 12 and 13 clamp in 16-bit fields (the even bytes,
// then the odd ones) biased by 256: a field v stands for v - 256.
constexpr uint32_t kEven = 0x00FF00FFu;
constexpr uint32_t kBlack = 0xFF000000u;

// Fields of v in [0, 1023] (v - 256 in [-256, 767]) -> v - 256 clamped to
// [0, 255].
__device__ __forceinline__ uint32_t clamp_fields(uint32_t v) {
  const uint32_t over = (v >> 9) & 0x00010001u;                               // v >= 512
  const uint32_t under = (((v >> 8) | (v >> 9)) & 0x00010001u) ^ 0x00010001u;  // v < 256
  return ((v & kEven) | (over * 0xFFu)) & ~(under * 0xFFu);
}
// Mode 12, clamp(L + T - TL) byte by byte.
__device__ __forceinline__ uint32_t clamp_full(uint32_t l, uint32_t t, uint32_t tl) {
  const uint32_t lo = clamp_fields((l & kEven) + (t & kEven) + 0x01000100u - (tl & kEven));
  const uint32_t hi = clamp_fields(((l >> 8) & kEven) + ((t >> 8) & kEven) + 0x01000100u -
                                   ((tl >> 8) & kEven));
  return lo | (hi << 8);
}
// a + (a - b) / 2 in the fields a, b (bytes in [0, 255]) with C's division
// toward zero, as v + 256: d + 512 plus one where d < 0, halved.
__device__ __forceinline__ uint32_t half_fields(uint32_t a, uint32_t b) {
  const uint32_t d = a + 0x02000200u - b;               // d + 512, in [257, 767]
  const uint32_t neg = (~d >> 9) & 0x00010001u;         // d < 0
  return a + (((d + neg) >> 1) & 0x7FFF7FFFu);          // a + d / 2 + 256
}
// Mode 13, clamp(a + (a - TL) / 2) with a = avg2(L, T).
__device__ __forceinline__ uint32_t clamp_half(uint32_t a, uint32_t tl) {
  const uint32_t lo = clamp_fields(half_fields(a & kEven, tl & kEven));
  const uint32_t hi = clamp_fields(half_fields((a >> 8) & kEven, (tl >> 8) & kEven));
  return lo | (hi << 8);
}
__device__ __forceinline__ int sad4(uint32_t a, uint32_t b) { return (int)__vsadu4(a, b); }

// The prediction of `mode` for each lane; `present` (the same in every
// lane: the modes some lane of the warp needs at this step, a bit each)
// lets the warp skip the averages, or the select and the clamps, where no
// lane needs them.
__device__ __forceinline__ uint32_t predict(int mode, unsigned present, uint32_t l, uint32_t t,
                                            uint32_t tl, uint32_t tr) {
  uint32_t m5 = 0, m6 = 0, m7 = 0, m8 = 0, m9 = 0, m10 = 0, m11 = 0, m12 = 0, m13 = 0;
  if (present & 0x7E0u) {  // 5-10: averages
    m6 = avg2(l, tl);
    m9 = avg2(t, tr);
    m5 = avg2(avg2(l, tr), t);
    m7 = avg2(l, t);
    m8 = avg2(tl, t);
    m10 = avg2(m6, m9);
  }
  if (present & 0x3800u) {  // 11-13: select, and the clamps
    m11 = sad4(l, tl) - sad4(t, tl) <= 0 ? t : l;
    m12 = clamp_full(l, t, tl);
    m13 = clamp_half(avg2(l, t), tl);
  }
  // a tree of selects on the mode's bits: 0 and 14-15 give black, as in libwebp
  const bool b0 = mode & 1, b1 = mode & 2, b2 = mode & 4, b3 = mode & 8;
  const uint32_t p01 = b0 ? l : kBlack, p23 = b0 ? tr : t, p45 = b0 ? m5 : tl, p67 = b0 ? m7 : m6;
  const uint32_t p89 = b0 ? m9 : m8, pab = b0 ? m11 : m10, pcd = b0 ? m13 : m12;
  const uint32_t p03 = b1 ? p23 : p01, p47 = b1 ? p67 : p45, p8b = b1 ? pab : p89;
  const uint32_t pcf = b1 ? kBlack : pcd;
  const uint32_t p07 = b2 ? p47 : p03, p8f = b2 ? pcf : p8b;
  return b3 ? p8f : p07;
}

// The predictor's pipeline: kCluster blocks of kBlockWarps warps, one warp
// a row group of 32 rows (group g on slot g % kSlots).
constexpr int kCluster = 4;      // SMs the predictor runs on: a block each, one cluster
constexpr int kBlockWarps = 4;   // warps a block, each on its own scheduler
constexpr int kSlots = kCluster * kBlockWarps;  // row groups of 32 in flight
constexpr int kWideRing = 4096;  // widths up to which the rings lie in shared memory
constexpr int kAhead = 16;       // residuals of its row a lane has in flight (a power of two)
constexpr int kWaveThreads = kBlockWarps * 32;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// A block's shared memory: each lane's next kAhead residuals (pixel x at
// window[warp][x % kAhead][lane]: lane l's words all in bank l); then, up
// to kWideRing pixels, each warp's ring, which the warp of the 32 rows
// above fills from another SM (w slots, a pixel a slot, in the low word
// beside its sequence number + 1 in the high word, so that one 8-byte
// store hands over both).  Wider, the rings lie in device memory, laid out
// the same way ([kSlots][w], slot k's ring read by the warp on slot k).
struct WaveShared {
  uint32_t window[kBlockWarps][kAhead][32];
  unsigned long long ring[1];  // [kBlockWarps][w], up to kWideRing pixels
};

constexpr size_t wave_shared_bytes(int w) {
  return offsetof(WaveShared, ring) + (w <= kWideRing ? sizeof(unsigned long long) * kBlockWarps * w : 0);
}

// 4 bytes from device memory into shared memory (cp.async), if `p`.
__device__ __forceinline__ void copy_async4_if(bool p, uint32_t* dst, const uint32_t* src) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], 4;\n}\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(dst)),
      "l"(src), "r"((int)p)
      : "memory");
}
// Loads that leave `v` as it was unless `p`, written by the load itself,
// so that no step reads a register still waiting on memory: each is
// issued a step before its value is used.
__device__ __forceinline__ void load_global_if(bool p, uint32_t& v, const uint32_t* a) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n @p ld.global.nc.u32 %0, [%1];\n}\n"
      : "+r"(v)
      : "l"(a), "r"((int)p));
}
__device__ __forceinline__ void load_shared_if(bool p, uint32_t& v, const uint32_t* a) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n @p ld.shared.u32 %0, [%1];\n}\n"
      : "+r"(v)
      : "r"((unsigned)__cvta_generic_to_shared(a)), "r"((int)p)
      : "memory");
}
// a ring entry, in this block's shared memory or in device memory
template <bool kGlobal>
__device__ __forceinline__ unsigned long long load_ring(const unsigned long long* a) {
  unsigned long long v;
  if (kGlobal)
    asm volatile("ld.volatile.global.u64 %0, [%1];\n" : "=l"(v) : "l"(a) : "memory");
  else
    asm volatile("ld.volatile.shared.u64 %0, [%1];\n"
                 : "=l"(v)
                 : "r"((unsigned)__cvta_generic_to_shared(a))
                 : "memory");
  return v;
}
// p, as a value the compiler keeps in a register rather than recomputes
template <class T>
__device__ __forceinline__ T* opaque(T* p) {
  asm("" : "+l"(p));
  return p;
}
__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void copy_async_wait() {  // all but the last kAhead - 1 groups
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
}

// Undoes the predictor transform: out[y, x] = res[y, x] + the prediction of
// the mode of tile (y >> bits, x >> bits) from out's left, top, top-left
// and top-right neighbours.  Row group g (rows 32 g .. 32 g + 31) runs on
// warp slot g % kSlots of the cluster, a lane a row: lane l undoes pixel x
// at step x + 2 l.  Its top-right neighbour is what lane l - 1 made the
// step before (__shfl_up_sync), its top and top-left the two values it
// took that way before that; lane 0 takes the row above from the ring that
// lane 31 of the slot before fills.  Nothing a step needs waits on memory
// within the step: each lane streams its residuals kAhead pixels ahead
// into shared memory (cp.async) and loads the next pixel's, the ring's
// next entry, the next tile's mode word and the warp's next modes (a
// __reduce_or_sync of a bit each, which lets the prediction skip the
// families no lane needs) a step before their use; it stores each pixel
// as it makes it (16-byte chunks gathered across steps cost more
// instructions than the stores they save).  `rings`: with kGlobalRing,
// the zeroed rings in device memory ([kSlots][w]), else unused.
template <bool kGlobalRing>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kWaveThreads)
predictor_pipeline_kernel(const uint32_t* __restrict__ res, uint32_t* __restrict__ out,
                          const uint32_t* __restrict__ modes, unsigned long long* rings, int w, int h,
                          int bits) {
  extern __shared__ __align__(16) uint8_t smem[];
  WaveShared& sh = *reinterpret_cast<WaveShared*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (!kGlobalRing)
    for (int i = threadIdx.x; i < kBlockWarps * w; i += blockDim.x) sh.ring[i] = 0;
  cluster.sync();
  const int slot = warp * kCluster + rank, groups = (h + 31) >> 5;
  const int next = (slot + 1) % kSlots;
  WaveShared* below = cluster.map_shared_rank(&sh, (unsigned)(next % kCluster));
  const int tw = (w + (1 << bits) - 1) >> bits, tmask = (1 << bits) - 1;
  uint32_t* const win = &sh.window[warp][0][lane];
  const unsigned long long* const ring_in = kGlobalRing ? rings + (size_t)slot * w : sh.ring + warp * w;
  unsigned long long* const ring_out =
      kGlobalRing ? rings + (size_t)next * w : below->ring + (next / kCluster) * w;
  for (int g = slot; g < groups; g += kSlots) {
    const int r = 32 * g + lane;
    const bool active = r < h;
    // pixel indices fit an int: the format's images hold at most 2^28
    const int row = (active ? r : h - 1) * w;
    // residual x in window slot x % kAhead, fetched kAhead pixels ahead
    for (int q = 0; q < kAhead; ++q) {  // a group a pixel
      copy_async4_if(active && q < w, win + 32 * q, res + row + q);
      copy_async_commit();
    }
    const uint32_t* fetch = opaque(res + row + kAhead - 2 * lane);  // pixel x + kAhead
    const uint32_t* const mrow = opaque(modes + ((active ? r : h - 1) >> bits) * tw);
    // the mode word of the tile that pixel x + 1 starts, loaded a step
    // before (tile 0's until the first load); this step's mode and the
    // modes the warp's lanes need, found the step before
    uint32_t mword = mrow[0];
    int mode = (int)((mword >> 8) & 15);
    unsigned present = 0;
    // a row group's pixel u goes to ring slot u with tag seq + u + 1
    const int seq = (g / kSlots) * w, seq_next = ((g + 1) / kSlots) * w;
    const bool feeds = g + 1 < groups;  // lane 31 hands its row on
    const bool top_row = r == 0;
    int in_u = 0;  // lane 0: the pixel of the row above it takes next
    // lane 0: that pixel from the ring (`v` read before)
    auto take = [&](bool want, unsigned long long v) -> uint32_t {
      const unsigned tag = (unsigned)(seq + in_u + 1);
      if (__any_sync(kFull, want && lane == 0 && (unsigned)(v >> 32) != tag)) {
        // a poll that never pauses holds off the other SM's stores to the
        // ring, and the whole chain with them
        if (lane == 0)
          while ((unsigned)((v = load_ring<kGlobalRing>(ring_in + in_u)) >> 32) != tag) __nanosleep(20);
        __syncwarp();
      }
      in_u += want;
      return (uint32_t)v;
    };
    // the row above's pixels x + 1 (tr), x (t) and x - 1 (tl) of this step
    uint32_t tr = 0, t = 0, tl = 0, up = 0;
    tr = take(g > 0, load_ring<kGlobalRing>(ring_in));
    // the next entry, read a step before its use (the last one again past it)
    unsigned long long ahead = load_ring<kGlobalRing>(ring_in + min(in_u, w - 1));
    uint32_t left = 0, first = 0, resid = 0;
    // this step's residual: lane 0's pixel 0 at step 0
    copy_async_wait();
    load_shared_if(active && lane == 0, resid, win);
    int x = -2 * lane;  // this step's pixel
    uint32_t* dst = opaque(out + row + x);
    int out_u = 0;  // lane 31's pixel to hand on next
    const int steps = w + 62;
    for (int s = 0; s < steps; ++s, ++x, ++dst) {
      const bool mine = active && x >= 0 && x < w;
      const uint32_t above_next = take(g > 0 && s + 1 < w, ahead);
      ahead = load_ring<kGlobalRing>(ring_in + min(in_u, w - 1));
      tl = t;
      t = tr;
      tr = lane == 0 ? above_next : up;
      const bool edge = top_row || x == 0;
      // the rightmost column's top-right is this row's first pixel
      const uint32_t p = predict(mode, present, left, t, tl, x + 1 < w ? tr : first);
      const uint32_t o = add_px(resid, !edge ? p : top_row ? (x == 0 ? kBlack : left) : t);
      // the slot this pixel's residual left takes pixel x + kAhead's
      copy_async4_if(active && x >= 0 && x + kAhead < w, win + 32 * (x & (kAhead - 1)), fetch);
      copy_async_commit();
      ++fetch;
      // the next step's residual, mode and the warp's modes; the mode word
      // of the tile pixel x + 2 starts
      const bool live = active && x + 1 >= 0 && x + 1 < w;
      copy_async_wait();  // a group a step: pixel x + 1's is older than kAhead - 1
      load_shared_if(live, resid, win + 32 * ((x + 1) & (kAhead - 1)));
      mode = live && ((x + 1) & tmask) == 0 ? (int)((mword >> 8) & 15) : mode;
      present = __reduce_or_sync(kFull, live && !top_row && x + 1 > 0 ? 1u << mode : 0u);
      load_global_if(active && x + 2 > 0 && x + 2 < w && ((x + 2) & tmask) == 0, mword,
                     mrow + ((x + 2) >> bits));
      left = mine ? o : left;
      first = mine && x == 0 ? o : first;
      if (mine) *dst = o;
      // lane 31's pixel (s - 62) to the warp of the next rows
      const bool hand = feeds && s >= 62 && s - 62 < w;
      if (hand && lane == 31)
        *reinterpret_cast<volatile unsigned long long*>(ring_out + out_u) =
            (unsigned long long)(unsigned)(seq_next + out_u + 1) << 32 | o;
      out_u += hand;
      up = __shfl_up_sync(kFull, o, 1);
    }
  }
  cluster.sync();  // no block leaves while another may still write its rings
}

__global__ void __launch_bounds__(kThreads)
pixel_kernel(const uint32_t* __restrict__ in, void* __restrict__ out_ptr,
             const uint32_t* __restrict__ aux, int kind, int w, int h, int bits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)w * h) return;
  if (kind == TO_BGR) {
    const uint32_t p = in[i];
    uint8_t* o = static_cast<uint8_t*>(out_ptr) + i * 3;
    o[0] = (uint8_t)p;
    o[1] = (uint8_t)(p >> 8);
    o[2] = (uint8_t)(p >> 16);
    return;
  }
  uint32_t* out = static_cast<uint32_t*>(out_ptr);
  const int y = (int)(i / w), x = (int)(i % w);
  if (kind == SUBTRACT_GREEN) {
    const uint32_t p = in[i], g = (p >> 8) & 0xFF;
    out[i] = (p & 0xFF00FF00u) | (((p & 0x00FF00FFu) + ((g << 16) | g)) & 0x00FF00FFu);
  } else if (kind == CROSS_COLOR) {
    const int tw = (w + (1 << bits) - 1) >> bits;
    const uint32_t m = aux[(y >> bits) * tw + (x >> bits)];
    const int g2r = (int8_t)(m & 0xFF), g2b = (int8_t)((m >> 8) & 0xFF), r2b = (int8_t)((m >> 16) & 0xFF);
    const uint32_t p = in[i];
    const int green = (int8_t)((p >> 8) & 0xFF);
    const int red = ((int)((p >> 16) & 0xFF) + ((g2r * green) >> 5)) & 0xFF;
    const int blue = ((int)(p & 0xFF) + ((g2b * green) >> 5) + ((r2b * (int)(int8_t)red) >> 5)) & 0xFF;
    out[i] = (p & 0xFF00FF00u) | ((uint32_t)red << 16) | (uint32_t)blue;
  } else {  // COLOR_INDEXING: w is the output width, `in` the packed image
    const int pw = (w + (1 << bits) - 1) >> bits;
    const int bpp = 8 >> bits;
    const uint32_t g = (in[(long long)y * pw + (x >> bits)] >> 8) & 0xFF;
    const uint32_t idx = (g >> ((x & ((1 << bits) - 1)) * bpp)) & ((1u << bpp) - 1);
    out[i] = aux[idx];
  }
}

}  // namespace

// Host code: parses a VP8L stream; never returns null.  simvg_vp8l_info gives
// the number of transforms (or -1 with simvg_vp8l_error) and fills info with
// width, height and each transform's kind, width and bits.
extern "C" void* simvg_vp8l_parse(const uint8_t* data, long long n) {
  Parsed* p = new Parsed();
  try {
    parse(data, n, *p);
  } catch (const Error& e) {
    p->error = e.what;
  }
  return p;
}

extern "C" int simvg_vp8l_info(void* handle, int* info) {
  const Parsed* p = static_cast<Parsed*>(handle);
  if (!p->error.empty()) return -1;
  info[0] = p->width;
  info[1] = p->height;
  for (size_t k = 0; k < p->kinds.size() && k < 20; ++k) {
    info[2 + 3 * k] = p->kinds[k];
    info[3 + 3 * k] = p->xsizes[k];
    info[4 + 3 * k] = p->bits[k];
  }
  return (int)p->kinds.size();
}

// Array k (a transform's data, or the pixels after the last): its length in
// uint32, copied to dst unless dst is null.
extern "C" long long simvg_vp8l_copy(void* handle, int k, void* dst) {
  const Parsed* p = static_cast<Parsed*>(handle);
  const std::vector<uint32_t>& a = p->arrays[k];
  if (dst != nullptr && !a.empty()) memcpy(dst, a.data(), a.size() * 4);
  return (long long)a.size();
}

extern "C" const char* simvg_vp8l_error(void* handle) {
  return static_cast<Parsed*>(handle)->error.c_str();
}

extern "C" void simvg_vp8l_free(void* handle) { delete static_cast<Parsed*>(handle); }

// One inverse transform on the card: `in` (the image the transform was applied
// to) -> `out` (xsize x height ARGB); aux: the sub-image or the palette.
extern "C" int simvg_vp8l_transform(const void* in, void* out, const void* aux, int kind,
                                    int xsize, int height, int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xsize <= 0 || height <= 0 || kind < 0 || kind > COLOR_INDEXING ||
      (kind != SUBTRACT_GREEN && aux == nullptr))
    return (int)cudaErrorInvalidValue;
  if (kind == PREDICTOR) {
    if (bits < 2 || bits > 9) return (int)cudaErrorInvalidValue;
    const size_t bytes = wave_shared_bytes(xsize);
    const uint32_t* res = static_cast<const uint32_t*>(in);
    const uint32_t* modes = static_cast<const uint32_t*>(aux);
    if (xsize <= kWideRing) {
      cudaFuncSetAttribute(predictor_pipeline_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
      predictor_pipeline_kernel<false><<<kCluster, kWaveThreads, bytes, s>>>(
          res, static_cast<uint32_t*>(out), modes, nullptr, xsize, height, bits);
    } else {  // the rings in device memory: kSlots rows of tags 0, freed behind the kernel
      unsigned long long* rings = nullptr;
      const size_t ring_bytes = sizeof(unsigned long long) * kSlots * (size_t)xsize;
      cudaError_t e = cudaMallocAsync(reinterpret_cast<void**>(&rings), ring_bytes, s);
      if (e == cudaSuccess) e = cudaMemsetAsync(rings, 0, ring_bytes, s);
      if (e != cudaSuccess) return (int)e;
      predictor_pipeline_kernel<true><<<kCluster, kWaveThreads, bytes, s>>>(
          res, static_cast<uint32_t*>(out), modes, rings, xsize, height, bits);
      e = cudaGetLastError();
      const cudaError_t freed = cudaFreeAsync(rings, s);
      return (int)(e != cudaSuccess ? e : freed);
    }
  } else {
    const long long blocks = ((long long)xsize * height + kThreads - 1) / kThreads;
    pixel_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(static_cast<const uint32_t*>(in), out,
                                                     static_cast<const uint32_t*>(aux), kind, xsize,
                                                     height, bits);
  }
  return (int)cudaGetLastError();
}

// ARGB [n] -> BGR uint8 [n, 3], alpha dropped.
extern "C" int simvg_vp8l_to_bgr(const void* argb, int n, void* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  pixel_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(argb), out, nullptr, TO_BGR, n, 1, 0);
  return (int)cudaGetLastError();
}
