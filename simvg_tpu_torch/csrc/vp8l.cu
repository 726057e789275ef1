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
//   predictor_kernel   the predictor transform: each pixel adds the
//                      prediction of its tile's mode (14 modes) from its
//                      left, top, top-left and top-right neighbours, which
//                      are final pixels, so it is a wavefront: one block,
//                      thread t owns row r0 + t and undoes column s - 2t at
//                      step s (its top-right neighbour was done at step
//                      s - 1), a __syncthreads() between steps;
//   pixel_kernel       one thread a pixel: cross-colour (the tile's three
//                      signed multipliers), subtract-green, colour-indexing
//                      (bundled indices unpacked, an index past the palette
//                      transparent black), and ARGB -> BGR with alpha
//                      dropped as IMREAD_COLOR drops it.
//
// What bounds it: the predictor's wavefront, W + 2 (H - 1) steps of a few
// dependent loads and a barrier (1,598 at 480 x 640), and before it the
// host's prefix decoding, which takes longer than every kernel together.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (simvg_tpu_torch/ops/_build.py); called through ctypes with a plain C ABI.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <string>
#include <vector>

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
__device__ __forceinline__ int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
__device__ __forceinline__ int ch(uint32_t p, int s) { return (int)((p >> s) & 0xFF); }

__device__ uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TL, uint32_t TR) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return avg2(avg2(L, TR), T);
    case 6: return avg2(L, TL);
    case 7: return avg2(L, T);
    case 8: return avg2(TL, T);
    case 9: return avg2(T, TR);
    case 10: return avg2(avg2(L, TL), avg2(T, TR));
    case 11: {
      int s = 0;
      for (int k = 24; k >= 0; k -= 8) s += abs(ch(L, k) - ch(TL, k)) - abs(ch(T, k) - ch(TL, k));
      return s <= 0 ? T : L;
    }
    case 12: {
      uint32_t v = 0;
      for (int k = 24; k >= 0; k -= 8) v |= (uint32_t)clip255(ch(L, k) + ch(T, k) - ch(TL, k)) << k;
      return v;
    }
    case 13: {
      const uint32_t a = avg2(L, T);
      uint32_t v = 0;
      for (int k = 24; k >= 0; k -= 8) {
        const int x = ch(a, k);
        v |= (uint32_t)clip255(x + (x - ch(TL, k)) / 2) << k;  // C division: toward zero
      }
      return v;
    }
    default: return 0xFF000000u;  // 0, and 14-15 as libwebp treats them
  }
}

constexpr int kWaveThreads = 1024;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kWaveThreads)
predictor_kernel(const uint32_t* __restrict__ res, uint32_t* __restrict__ out,
                 const uint32_t* __restrict__ modes, int w, int h, int bits) {
  const int tw = (w + (1 << bits) - 1) >> bits;
  for (int r0 = 0; r0 < h; r0 += blockDim.x) {
    const int rows = min((int)blockDim.x, h - r0);
    const int y = r0 + (int)threadIdx.x;
    for (int step = 0; step < w + 2 * (rows - 1); ++step) {
      const int x = step - 2 * (int)threadIdx.x;
      if (y < h && x >= 0 && x < w) {
        const long long i = (long long)y * w + x;
        uint32_t p;
        if (y == 0) {
          p = x == 0 ? 0xFF000000u : out[i - 1];
        } else if (x == 0) {
          p = out[i - w];
        } else {
          const int mode = (modes[(y >> bits) * tw + (x >> bits)] >> 8) & 0xF;
          // the rightmost column's top-right is this row's first pixel
          const uint32_t tr = x + 1 < w ? out[i - w + 1] : out[i - x];
          p = predict(mode, out[i - 1], out[i - w], out[i - w - 1], tr);
        }
        out[i] = add_px(res[i], p);
      }
      __syncthreads();
    }
  }
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
    predictor_kernel<<<1, kWaveThreads, 0, s>>>(static_cast<const uint32_t*>(in),
                                               static_cast<uint32_t*>(out),
                                               static_cast<const uint32_t*>(aux), xsize, height, bits);
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
