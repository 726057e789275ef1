// PNG unfiltering and colour conversion for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package decodes PNG on the host with cv2
// (libpng).  The port decodes on the card, as it decodes JPEG with nvJPEG:
// simvg_tpu_torch/data/png.py walks the chunks and inflates the image data
// on the host (zlib), and these two kernels turn the inflated bytes into the
// BGR uint8 [h, w, 3] image that cv2.imdecode(..., IMREAD_COLOR) gives:
//
//   unfilter_kernel  undoes each row's filter (0 None, 1 Sub, 2 Up, 3 Average,
//                    4 Paeth) in place, one block per pass (Adam7's seven, or
//                    the whole image);
//   convert_kernel   one thread per output pixel: finds its pass and position,
//                    reads its samples (1, 2, 4, 8 or 16 bits; a 16-bit sample
//                    gives its high byte, v >> 8) and writes B, G, R: gray
//                    replicated (1, 2, 4 bits scaled by 255, 85, 17), the
//                    palette expanded (BGR, zeros past PLTE), alpha dropped.
//
// Where the trouble is.  Average and Paeth make each byte depend on its left
// neighbour (bpp bytes back) and on the row above, so no two bytes of a row
// and no two rows are independent.  unfilter_kernel runs a wavefront: thread
// t owns row r0 + t of a group of blockDim rows and at step k undoes unit
// (bpp bytes) k - t of it, so that the row above has undone units k - t and
// k - t - 1 one step earlier; a __syncthreads() separates the steps, and the
// groups follow one another.  A 640 x 480 RGB image is 640 + 479 steps.
//
// What bounds it: neither the card's bytes nor its operations (a 640 x 480
// RGB image is 0.9 MB in and out), but the dependency chain: the steps of the
// wavefront, each a few dependent loads and a barrier.  The host's inflate of
// the same image takes longer than both kernels (PERF.md gives the times).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (simvg_tpu_torch/ops/_build.py); called through ctypes with a plain C ABI.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kUnfilterThreads = 512;
constexpr int kConvertThreads = 256;

// The passes of an image: Adam7's seven (an empty one, with no pixels, has
// no bytes either), or one that is the whole image.
struct Passes {
  int n;
  int x0[7], y0[7], dx[7], dy[7], w[7], h[7], rowbytes[7];
  long long offset[7];  // of the pass's first filter byte in the data
};

__device__ __forceinline__ int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  return pa <= pb && pa <= pc ? a : pb <= pc ? b : c;
}

__global__ void __launch_bounds__(kUnfilterThreads)
unfilter_kernel(uint8_t* __restrict__ data, Passes ps, int bpp) {
  const int p = blockIdx.x;
  if (ps.w[p] == 0 || ps.h[p] == 0) return;
  const int h = ps.h[p], rb = ps.rowbytes[p], stride = rb + 1;
  const int units = rb / bpp;  // bpp divides rowbytes: bpp is 1 below 8 bits
  uint8_t* base = data + ps.offset[p];
  for (int r0 = 0; r0 < h; r0 += blockDim.x) {
    const int rows = min((int)blockDim.x, h - r0);
    const int r = r0 + (int)threadIdx.x;
    const bool active = r < h;
    uint8_t* row = base + (long long)r * stride + 1;
    const uint8_t* up = r > 0 ? row - stride : nullptr;
    const int filter = active ? row[-1] : 0;
    for (int step = 0; step < units + rows - 1; ++step) {
      const int u = step - (int)threadIdx.x;
      if (active && filter != 0 && u >= 0 && u < units) {
        for (int c = 0; c < bpp; ++c) {
          const int x = u * bpp + c;
          const int a = u > 0 ? row[x - bpp] : 0;
          const int b = up != nullptr ? up[x] : 0;
          int add = 0;
          switch (filter) {
            case 1: add = a; break;
            case 2: add = b; break;
            case 3: add = (a + b) >> 1; break;
            case 4: add = paeth(a, b, up != nullptr && u > 0 ? up[x - bpp] : 0); break;
          }
          row[x] = (uint8_t)(row[x] + add);
        }
      }
      __syncthreads();
    }
  }
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
// kernels do not take or data shorter than the header needs.
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
  if (offset > nbytes) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* d = static_cast<uint8_t*>(data);
  unfilter_kernel<<<ps.n, kUnfilterThreads, 0, s>>>(d, ps, bpp);
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
