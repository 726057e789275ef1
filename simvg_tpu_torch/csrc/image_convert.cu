// Stored samples -> BGR uint8 pixels for Hopper (sm_90a), and the LZW
// decoder of the same route's host stage.
//
// Replaces no TPU kernel: the JAX package decodes images on the host with
// cv2.  The port decodes BMP, PNM/PFM, Sun raster, Radiance HDR, GIF and
// TIFF on the card: simvg_tpu_torch/data/{bmp,pnm,sunras,hdr,gif,tiff}.py
// parse the container and undo its run-length, LZW, Deflate or PackBits
// coding on the host, and describe the result as a Raster (image_convert.py:
// where each pixel's samples lie in the buffer and how they become B, G and
// R).  Then:
//
//   convert_kernel    one thread per output pixel: locates its samples (the
//                     GIF frame and its interlaced row order, the bottom-up
//                     flip, TIFF's tiles and planes), reads 1, 2, 4, 8 or 16
//                     bits (either byte order), a float32 or an RGBE pixel,
//                     and converts: gray replicated, colour reordered, both
//                     through an 8-bit lookup table (a maxval's scale, an
//                     inverted gray, 16 -> 8 bits), palette lookup (GIF's
//                     transparent index shows the background), BMP's 5-5-5
//                     and 5-6-5 bitfields, float x scale and RGBE x 255
//                     rounded as cv2's saturate_cast rounds (half to even),
//                     libtiff's premultiplication by an unassociated alpha;
//   predictor_scan_kernel
//                     TIFF's horizontal predictor (2) undone in place: a
//                     prefix sum per channel along each segment (a strip
//                     row, a tile row, one plane's row), 8 or 16-bit
//                     samples, either byte order.  A warp a segment (the
//                     block's warps for a long one) in passes of 32 runs of
//                     whole pixels: 16-byte loads into shared memory, a
//                     lane's run summed, the runs' sums scanned across the
//                     warp and the warps, 16-byte stores; up to 8 samples
//                     a pixel, one instantiation each;
//   predictor_strided_scan_kernel
//                     the same past 8 samples a pixel: a warp a (segment,
//                     sample), its values spp apart, a byte at a time.
//
// simvg_lzw_decode is host code: GIF's (LSB-first, variable width) and
// TIFF's (MSB-first, early change) LZW, the sequential stage of those two
// formats on this route, held to data/lzw.py's decode_reference.
//
// What bounds them: the bytes.  Each output pixel is a few bytes in and
// three out, with a handful of integer operations; a 480 x 640 image is
// 0.9 MB out, and the predictor reads and writes its 0.9 MB once.  At that
// size both kernels take a few microseconds, near a launch's cost: the
// host stage (LZW, inflate) takes a thousand times longer.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (simvg_tpu_torch/ops/_build.py); called through ctypes with a plain C ABI.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <vector>

namespace {

enum Mode { GRAY = 0, COLOR = 1, PALETTE = 2, BITFIELDS = 3, FLOAT = 4, RGBE = 5 };

// image_convert.py's _Desc, field for field.
struct Raster {
  int width, height, bits, spp, mode, flip, planes, big_endian;
  int order[3], mask_shift[3], mask_bits[3];
  int palette_size;
  int frame[4];  // x0, y0, w, h
  int transparent;
  int background[3];
  int tile[2];
  int alpha;
  float scale;
  long long row_bytes, offset, plane_bytes, nbytes;
};

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t read_sample(const uint8_t* __restrict__ d, long long base,
                                                long long index, int bits, int big_endian) {
  if (bits < 8) {
    const long long pos = index * bits;
    const int byte = d[base + (pos >> 3)];
    return (byte >> (8 - bits - (int)(pos & 7))) & ((1 << bits) - 1);
  }
  const int n = bits >> 3;
  const uint8_t* p = d + base + index * n;
  uint32_t v = 0;
  for (int k = 0; k < n; ++k) v = big_endian ? (v << 8) | p[k] : v | ((uint32_t)p[k] << (8 * k));
  return v;
}

// cv2's saturate_cast<uchar>(float): round half to even, clamp; NaN gives 0.
__device__ __forceinline__ uint8_t round_u8(float v) {
  if (isnan(v)) return 0;
  const float r = rintf(v);
  return (uint8_t)(r < 0.f ? 0.f : r > 255.f ? 255.f : r);
}

__global__ void __launch_bounds__(kThreads)
convert_kernel(const uint8_t* __restrict__ data, Raster r, const uint8_t* __restrict__ lut,
               const uint8_t* __restrict__ palette, const int* __restrict__ rows,
               uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)r.width * r.height) return;
  const int y = (int)(i / r.width), x = (int)(i % r.width);
  uint8_t* o = out + i * 3;
  const int fx = x - r.frame[0], fy = y - r.frame[1];
  if (fx < 0 || fy < 0 || fx >= r.frame[2] || fy >= r.frame[3]) {
    o[0] = (uint8_t)r.background[0];
    o[1] = (uint8_t)r.background[1];
    o[2] = (uint8_t)r.background[2];
    return;
  }
  long long sy = rows != nullptr ? rows[fy] : fy;
  if (r.flip) sy = r.frame[3] - 1 - sy;
  long long sx = fx, base;
  if (r.tile[0] > 0) {
    const int tw = r.tile[0], th = r.tile[1];
    const long long across = (r.frame[2] + tw - 1) / tw;
    const long long t = (sy / th) * across + sx / tw;
    base = r.offset + t * th * r.row_bytes + (sy % th) * r.row_bytes;
    sx %= tw;
  } else {
    base = r.offset + sy * r.row_bytes;
  }
  const bool planar = r.planes > 1;
  auto sample = [&](int k) -> uint32_t {
    return planar ? read_sample(data, base + k * r.plane_bytes, sx, r.bits, r.big_endian)
                  : read_sample(data, base, sx * r.spp + k, r.bits, r.big_endian);
  };
  auto map8 = [&](uint32_t v) -> int { return lut != nullptr ? lut[v] : (int)(v & 0xFF); };
  int c[3];
  switch (r.mode) {
    case GRAY:
      c[0] = c[1] = c[2] = map8(sample(0));
      break;
    case COLOR:
      for (int k = 0; k < 3; ++k) c[k] = map8(sample(r.order[k]));
      if (r.alpha >= 0) {  // libtiff's (c * a + 127) / 255
        const int a = map8(sample(r.alpha));
        for (int k = 0; k < 3; ++k) c[k] = (c[k] * a + 127) / 255;
      }
      break;
    case PALETTE: {
      const int v = (int)sample(0);
      if (v == r.transparent) {
        for (int k = 0; k < 3; ++k) c[k] = r.background[k];
      } else if (v < r.palette_size) {
        for (int k = 0; k < 3; ++k) c[k] = palette[v * 3 + k];
      } else {
        c[0] = c[1] = c[2] = 0;
      }
      break;
    }
    case BITFIELDS: {
      const uint32_t p = sample(0);
      for (int k = 0; k < 3; ++k) {
        const int nb = r.mask_bits[k];
        const uint32_t f = (p >> r.mask_shift[k]) & ((1u << nb) - 1);
        c[k] = (int)(nb <= 8 ? f << (8 - nb) : f >> (nb - 8));
      }
      break;
    }
    case FLOAT:
      for (int k = 0; k < 3; ++k) c[k] = round_u8(__uint_as_float(sample(r.order[k])) * r.scale);
      break;
    default: {  // RGBE: c * 2^(e - 136) in float32, then x 255
      const int e = (int)sample(3);
      const float f = e ? ldexpf(1.f, e - 136) : 0.f;
      for (int k = 0; k < 3; ++k) c[k] = round_u8((float)sample(r.order[k]) * f * 255.f);
    }
  }
  o[0] = (uint8_t)c[0];
  o[1] = (uint8_t)c[1];
  o[2] = (uint8_t)c[2];
}

// TIFF's horizontal predictor (2): each segment (a strip row, a tile row
// or one plane's row) is, sample by sample, a running sum mod 2^bits with
// stride spp: a prefix sum per channel, and segments are independent.  A
// warp (or, for a long segment, the block's warps together) takes a
// segment in passes of 32 runs of whole pixels: the pass's bytes come into
// shared memory in aligned 16-byte words, each lane sums its run channel by
// channel, the runs' sums are scanned across the warp (__shfl_up_sync) and
// across the segment's warps (shared memory), each lane adds what precedes
// its run, and the bytes go back in 16-byte words.  The 16-byte words a
// segment shares with its neighbours, or with its padding, are read and
// written a byte at a time, only the segment's pixel bytes: the bytes past
// count * spp * bytes a sample are never written.
constexpr int kScanWarps = 8;              // warps a block: segments, or one long segment
constexpr int kScanThreads = kScanWarps * 32;
constexpr int kLaneBytes = 64;             // a lane's run of whole pixels holds at most this
constexpr int kMaxSpp = 8;                 // samples a pixel the register route holds
constexpr int kStage = 32 * kLaneBytes + 32;  // a pass and its 16-byte alignment
constexpr unsigned kFull = 0xffffffffu;

struct Sample {  // an 8- or 16-bit sample at byte p of shared memory
  int bytes, big_endian;
  __device__ __forceinline__ uint32_t get(const uint8_t* p) const {
    if (bytes == 1) return p[0];
    return big_endian ? (uint32_t)p[0] << 8 | p[1] : p[0] | (uint32_t)p[1] << 8;
  }
  __device__ __forceinline__ void put(uint8_t* p, uint32_t v) const {
    if (bytes == 1) {
      p[0] = (uint8_t)v;
    } else {
      p[big_endian ? 1 : 0] = (uint8_t)v;
      p[big_endian ? 0 : 1] = (uint8_t)(v >> 8);
    }
  }
};

// Bytes [lo, hi) of device memory <-> stage[at - (lo & ~15)] for the
// warp's lanes: the 16-byte words inside [lo, hi) whole, the words at the
// two ends a byte at a time.
__device__ __forceinline__ void stage_in(uint8_t* stage, const uint8_t* lo, const uint8_t* hi, int lane) {
  const uint8_t* a = reinterpret_cast<const uint8_t*>(reinterpret_cast<uintptr_t>(lo) & ~(uintptr_t)15);
  for (const uint8_t* q = a + 16 * lane; q < hi; q += 16 * 32) {
    uint8_t* d = stage + (q - a);
    if (q >= lo && q + 16 <= hi) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(q);
    } else {
      for (int k = 0; k < 16; ++k)
        if (q + k >= lo && q + k < hi) d[k] = q[k];
    }
  }
}
__device__ __forceinline__ void stage_out(const uint8_t* stage, uint8_t* lo, uint8_t* hi, int lane) {
  uint8_t* a = reinterpret_cast<uint8_t*>(reinterpret_cast<uintptr_t>(lo) & ~(uintptr_t)15);
  for (uint8_t* q = a + 16 * lane; q < hi; q += 16 * 32) {
    const uint8_t* d = stage + (q - a);
    if (q >= lo && q + 16 <= hi) {
      *reinterpret_cast<uint4*>(q) = *reinterpret_cast<const uint4*>(d);
    } else {
      for (int k = 0; k < 16; ++k)
        if (q + k >= lo && q + k < hi) q[k] = d[k];
    }
  }
}

// The register route, SPP samples a pixel (1-8): `wps` warps a segment (a
// power of two up to kScanWarps), the block's warps on kScanWarps / wps
// segments.  Warp part k of a segment takes pass k of each round of wps
// passes; a round's sums go to the later warps through shared memory.
template <int SPP>
__global__ void __launch_bounds__(kScanThreads)
predictor_scan_kernel(uint8_t* __restrict__ data, int segments, long long seg_bytes, int count,
                      Sample smp, int wps) {
  __shared__ __align__(16) uint8_t stage[kScanWarps][kStage];
  __shared__ uint32_t sums[kScanWarps][SPP];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long seg = (long long)blockIdx.x * (kScanWarps / wps) + warp / wps;
  const int part = warp % wps;
  const bool live = seg < segments;
  const int pb = SPP * smp.bytes;                    // bytes a pixel
  const int run = kLaneBytes / pb;                   // pixels a lane's run
  const long long pass_px = 32ll * run;
  uint8_t* const base = data + (live ? seg : 0) * seg_bytes;
  const long long rounds = (count + pass_px * wps - 1) / (pass_px * wps);
  uint32_t carry[SPP] = {};
  for (long long round = 0; round < rounds; ++round) {
    const long long px0 = (round * wps + part) * pass_px;  // the pass's first pixel
    const long long lo = live ? min((long long)count, px0) * pb : 0;
    const long long hi = live ? min((long long)count, px0 + pass_px) * pb : 0;
    uint8_t* const st = stage[warp];
    const int skew = (int)(reinterpret_cast<uintptr_t>(base + lo) & 15);
    stage_in(st, base + lo, base + hi, lane);
    __syncwarp();
    // the lane's run: its pixels' samples summed in place, channel by channel
    const long long mine0 = px0 + (long long)lane * run;
    const int n = (int)max(0ll, min((long long)run, (long long)count - mine0));
    uint8_t* const at = st + skew + lane * run * pb;
    uint32_t acc[SPP] = {};
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int c = 0; c < SPP; ++c) {
        uint8_t* q = at + (i * SPP + c) * smp.bytes;
        acc[c] += smp.get(q);
        smp.put(q, acc[c]);
      }
    // what precedes the run: the warp's earlier runs, the round's earlier
    // warps and the earlier rounds
    uint32_t before[SPP], pass_sum[SPP];
#pragma unroll
    for (int c = 0; c < SPP; ++c) {
      uint32_t v = acc[c];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t u = __shfl_up_sync(kFull, v, d);
        v += lane >= d ? u : 0u;
      }
      before[c] = v - acc[c];
      pass_sum[c] = __shfl_sync(kFull, v, 31);
    }
    if (wps > 1) {
      if (lane == 0)
        for (int c = 0; c < SPP; ++c) sums[warp][c] = pass_sum[c];
      __syncthreads();
      const int first = warp - part;
#pragma unroll
      for (int c = 0; c < SPP; ++c) {
        uint32_t earlier = 0, all = 0;
        for (int k = 0; k < wps; ++k) {
          earlier += k < part ? sums[first + k][c] : 0u;
          all += sums[first + k][c];
        }
        before[c] += carry[c] + earlier;
        carry[c] += all;
      }
      __syncthreads();  // the sums are read before the next round writes them
    } else {
#pragma unroll
      for (int c = 0; c < SPP; ++c) {
        before[c] += carry[c];
        carry[c] += pass_sum[c];
      }
    }
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int c = 0; c < SPP; ++c) {
        uint8_t* q = at + (i * SPP + c) * smp.bytes;
        smp.put(q, smp.get(q) + before[c]);
      }
    __syncwarp();
    stage_out(st, base + lo, base + hi, lane);
    __syncwarp();  // the stage is read before the next pass fills it
  }
}

// The second route, any spp: a warp a (segment, sample), the sample's
// values spp apart in device memory, each lane a run of kStrideRun pixels
// of a pass, a byte at a time.
constexpr int kStrideRun = 8;

__global__ void __launch_bounds__(kScanThreads)
predictor_strided_scan_kernel(uint8_t* __restrict__ data, int segments, long long seg_bytes, int count,
                         int spp, Sample smp) {
  const int lane = threadIdx.x & 31;
  const long long task = (long long)blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  if (task >= (long long)segments * spp) return;  // the whole warp
  const int c = (int)(task % spp);
  uint8_t* const base = data + (task / spp) * seg_bytes + (long long)c * smp.bytes;
  const long long stride = (long long)spp * smp.bytes;
  uint32_t carry = 0;
  for (long long px0 = 0; px0 < count; px0 += 32 * kStrideRun) {
    const long long mine0 = px0 + (long long)lane * kStrideRun;
    uint32_t v[kStrideRun], acc = 0;
#pragma unroll
    for (int i = 0; i < kStrideRun; ++i) {
      v[i] = mine0 + i < count ? smp.get(base + (mine0 + i) * stride) : 0u;
      acc += v[i];
      v[i] = acc;
    }
    uint32_t incl = acc;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t u = __shfl_up_sync(kFull, incl, d);
      incl += lane >= d ? u : 0u;
    }
    const uint32_t before = carry + incl - acc;
    carry += __shfl_sync(kFull, incl, 31);
#pragma unroll
    for (int i = 0; i < kStrideRun; ++i)
      if (mine0 + i < count) smp.put(base + (mine0 + i) * stride, v[i] + before);
  }
}

}  // namespace

// desc: the description (image_convert.py's _Desc); data: its bytes on the card
// (r->nbytes of them); lut: uint8 [1 << bits] or null; palette: BGR uint8
// [palette_size, 3] or null; rows: int32 [frame h] or null; out: BGR uint8
// [height, width, 3].  One launch on `stream`; returns its CUDA error (0 if
// none), cudaErrorInvalidValue for a description the kernel does not take.
extern "C" int simvg_image_convert(const void* desc, const void* data, const void* lut,
                                   const void* palette, const void* rows, void* out,
                                   void* stream) {
  Raster d;
  memcpy(&d, desc, sizeof(d));
  const bool bits_ok = d.mode == FLOAT ? d.bits == 32
                                       : (d.bits == 1 || d.bits == 2 || d.bits == 4 ||
                                          d.bits == 8 || d.bits == 16 || d.bits == 32);
  if (d.width <= 0 || d.height <= 0 || d.mode < GRAY || d.mode > RGBE || !bits_ok ||
      (d.mode == PALETTE && palette == nullptr) || (d.mode == RGBE && d.bits != 8))
    return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)d.width * d.height;
  const long long blocks = (pixels + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  convert_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), d, static_cast<const uint8_t*>(lut),
      static_cast<const uint8_t*>(palette), static_cast<const int*>(rows),
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

// TIFF's horizontal predictor undone in place on the card: `segments` rows of
// `count` pixels of `spp` samples of `bits` (8 or 16), `seg_bytes` apart.
// One launch: the register route for spp <= kMaxSpp, else the strided one.
extern "C" int simvg_tiff_predictor(void* data, int segments, long long seg_bytes, int count,
                                    int spp, int bits, int big_endian, void* stream) {
  if (segments <= 0 || count <= 0 || spp <= 0 || (bits != 8 && bits != 16) ||
      (long long)count * spp * (bits / 8) > seg_bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* d = static_cast<uint8_t*>(data);
  const Sample smp{bits / 8, big_endian ? 1 : 0};
  if (spp > kMaxSpp) {
    const long long blocks = ((long long)segments * spp + kScanWarps - 1) / kScanWarps;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    predictor_strided_scan_kernel<<<(unsigned)blocks, kScanThreads, 0, s>>>(d, segments, seg_bytes, count,
                                                                        spp, smp);
    return (int)cudaGetLastError();
  }
  // warps a segment: enough for its passes, up to the block's
  const long long pass_px = 32ll * (kLaneBytes / (spp * smp.bytes));
  const long long passes = (count + pass_px - 1) / pass_px;
  int wps = 1;
  while (wps < kScanWarps && wps < passes) wps <<= 1;
  const long long per_block = kScanWarps / wps;
  const unsigned blocks = (unsigned)((segments + per_block - 1) / per_block);
  switch (spp) {
#define SIMVG_SCAN(n) \
  case n:             \
    predictor_scan_kernel<n><<<blocks, kScanThreads, 0, s>>>(d, segments, seg_bytes, count, smp, wps); \
    break;
    SIMVG_SCAN(1) SIMVG_SCAN(2) SIMVG_SCAN(3) SIMVG_SCAN(4)
    SIMVG_SCAN(5) SIMVG_SCAN(6) SIMVG_SCAN(7) SIMVG_SCAN(8)
#undef SIMVG_SCAN
  }
  return (int)cudaGetLastError();
}

// Host code: an LZW stream (kind 0 GIF with `min_code_size`, 1 TIFF) decoded
// into `out`, at most `limit` bytes.  Returns the bytes written, -1 for a
// stream that starts with an undefined code, -2 for a code past the table,
// -3 for a bad minimum code size.  Stops at the end code, at the end of the
// data or at `limit` bytes, as data/lzw.py's decode_reference does.
extern "C" long long simvg_lzw_decode(const uint8_t* data, long long n, int kind,
                                      int min_code_size, uint8_t* out, long long limit) {
  if (kind == 0 && (min_code_size < 1 || min_code_size > 11)) return -3;
  const int clear = kind == 0 ? 1 << min_code_size : 256, end = clear + 1;
  const int early = kind == 1 ? 1 : 0;
  int width0 = 0;
  while ((1 << width0) <= clear) ++width0;  // m + 1 bits; 9 for TIFF
  std::vector<int> prefix(4096), len(4096);
  std::vector<uint8_t> first(4096), last(4096);
  for (int c = 0; c < clear; ++c) {
    prefix[c] = -1;
    len[c] = 1;
    first[c] = last[c] = (uint8_t)c;
  }
  int size = clear + 2, width = width0, prev = -1;
  unsigned long long acc = 0;
  int nacc = 0;
  long long pos = 0, total = 0;
  while (true) {
    while (nacc < width && pos < n) {
      if (kind == 0)
        acc |= (unsigned long long)data[pos] << nacc;
      else
        acc = (acc << 8) | data[pos];
      nacc += 8;
      ++pos;
    }
    if (nacc < width) break;
    int code;
    if (kind == 0) {
      code = (int)(acc & ((1u << width) - 1));
      acc >>= width;
    } else {
      code = (int)((acc >> (nacc - width)) & ((1u << width) - 1));
      acc &= (1ull << (nacc - width)) - 1;
    }
    nacc -= width;
    if (code == clear) {
      size = clear + 2;
      width = width0;
      prev = -1;
      continue;
    }
    if (code == end) break;
    int entry;
    if (prev < 0) {
      if (code >= clear) return -1;
      entry = code;
    } else {
      int head;
      if (code < size) {
        entry = code;
        head = first[code];
      } else if (code == size) {
        entry = -1;  // the entry being made: prev + prev's first byte
        head = first[prev];
      } else {
        return -2;
      }
      if (size < 4096) {
        prefix[size] = prev;
        len[size] = len[prev] + 1;
        first[size] = first[prev];
        last[size] = (uint8_t)head;
        if (entry < 0) entry = size;
        ++size;
      }
      if (entry < 0) return -2;
    }
    // write the entry back to front, keeping the bytes below `limit`
    const int l = len[entry];
    for (int c = entry, k = l - 1; c >= 0; c = prefix[c], --k)
      if (total + k < limit) out[total + k] = last[c];
    total += l;
    if (total >= limit) {
      total = limit;
      break;
    }
    prev = entry;
    if (size + early >= (1 << width) && width < 12) ++width;
  }
  return total;
}
