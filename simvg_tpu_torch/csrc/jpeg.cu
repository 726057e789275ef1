// JPEG decode and encode on the card through the CUDA toolkit's nvJPEG:
// the port's counterpart of the JAX package's cv2.imread (simvg_tpu/data/
// datasets.py:156-161) and of cv2.imwrite in its synthetic-data tool.
//
// No TPU kernel is replaced: the JAX package decodes on the host with cv2.
// nvJPEG's default (hybrid) backend parses the stream and decodes the
// Huffman data on the host, then runs the IDCT, the chroma upsampling and
// the colour conversion on the card; the result lands in device memory,
// where the resize and normalisation of the data pipeline read it.
//
// Plain C interface for ctypes (simvg_tpu_torch/data/jpeg.py).  One handle
// for the process; decoder states live as long as it and are handed to one
// decoding thread at a time (a state must not be used by two at once).
// Every call takes the stream to work on and returns 0, an nvjpegStatus_t,
// or 1000 + a cudaError_t.  The decode does not synchronise; the encode
// does before it copies the bitstream out, as the host needs the bytes.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>
#include <cstring>

#define SIMVG_CHECK_NVJPEG(call)                  \
  do {                                            \
    nvjpegStatus_t s_ = (call);                   \
    if (s_ != NVJPEG_STATUS_SUCCESS) return (int)s_; \
  } while (0)

#define SIMVG_CHECK_CUDA(call)                    \
  do {                                            \
    cudaError_t e_ = (call);                      \
    if (e_ != cudaSuccess) return 1000 + (int)e_; \
  } while (0)

extern "C" {

int simvg_jpeg_create(void** handle) {
  nvjpegHandle_t h = nullptr;
  SIMVG_CHECK_NVJPEG(nvjpegCreateSimple(&h));
  *handle = h;
  return 0;
}

int simvg_jpeg_state_create(void* handle, void** state) {
  nvjpegJpegState_t s = nullptr;
  SIMVG_CHECK_NVJPEG(
      nvjpegJpegStateCreate(static_cast<nvjpegHandle_t>(handle), &s));
  *state = s;
  return 0;
}

// Components and the first component's height and width, from the
// stream's headers.
int simvg_jpeg_info(void* handle, const unsigned char* data, size_t length,
                    int* components, int* height, int* width) {
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegChromaSubsampling_t css;
  SIMVG_CHECK_NVJPEG(nvjpegGetImageInfo(static_cast<nvjpegHandle_t>(handle),
                                        data, length, components, &css,
                                        widths, heights));
  *height = heights[0];
  *width = widths[0];
  return 0;
}

// gray != 0: the luma plane into out[h][pitch] (NVJPEG_OUTPUT_Y, for
// one-component streams); else interleaved BGR into out[h][pitch]
// (NVJPEG_OUTPUT_BGRI, pitch = 3 w).  out is device memory.
int simvg_jpeg_decode(void* handle, void* state, const unsigned char* data,
                      size_t length, int gray, unsigned char* out,
                      size_t pitch, void* stream) {
  nvjpegImage_t dst;
  std::memset(&dst, 0, sizeof(dst));
  dst.channel[0] = out;
  dst.pitch[0] = pitch;
  SIMVG_CHECK_NVJPEG(nvjpegDecode(
      static_cast<nvjpegHandle_t>(handle),
      static_cast<nvjpegJpegState_t>(state), data, length,
      gray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_BGRI, &dst,
      static_cast<cudaStream_t>(stream)));
  SIMVG_CHECK_CUDA(cudaGetLastError());
  return 0;
}

// Encodes a device image: interleaved BGR [h][w][3] with 4:2:0 chroma, or
// with gray != 0 one luma plane [h][w].  On entry *length is the capacity
// of out (host memory); on return the stream's length.  Returns
// NVJPEG_STATUS_INVALID_PARAMETER's code with *length set to the needed
// size when out is too small.
int simvg_jpeg_encode(void* handle, const unsigned char* image, int height,
                      int width, int gray, int quality, unsigned char* out,
                      size_t* length, void* stream) {
  nvjpegHandle_t h = static_cast<nvjpegHandle_t>(handle);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nvjpegEncoderState_t enc = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  int status = 0;
  nvjpegImage_t src;
  std::memset(&src, 0, sizeof(src));
  src.channel[0] = const_cast<unsigned char*>(image);
  src.pitch[0] = static_cast<size_t>(width) * (gray ? 1 : 3);
  const nvjpegChromaSubsampling_t css = gray ? NVJPEG_CSS_GRAY
                                             : NVJPEG_CSS_420;
  size_t needed = 0;
  nvjpegStatus_t s = nvjpegEncoderStateCreate(h, &enc, st);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncoderParamsCreate(h, &params, st);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncoderParamsSetQuality(params, quality, st);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncoderParamsSetSamplingFactors(params, css, st);
  if (s == NVJPEG_STATUS_SUCCESS) {
    s = gray ? nvjpegEncodeYUV(h, enc, params, &src, css, width, height, st)
             : nvjpegEncodeImage(h, enc, params, &src, NVJPEG_INPUT_BGRI,
                                 width, height, st);
  }
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncodeRetrieveBitstream(h, enc, nullptr, &needed, st);
  if (s == NVJPEG_STATUS_SUCCESS) {
    cudaError_t e = cudaStreamSynchronize(st);
    if (e != cudaSuccess) status = 1000 + (int)e;
  }
  if (s == NVJPEG_STATUS_SUCCESS && status == 0) {
    if (needed > *length) {
      status = (int)NVJPEG_STATUS_INVALID_PARAMETER;
    } else {
      s = nvjpegEncodeRetrieveBitstream(h, enc, out, &needed, st);
      if (s == NVJPEG_STATUS_SUCCESS) {
        cudaError_t e = cudaStreamSynchronize(st);
        if (e != cudaSuccess) status = 1000 + (int)e;
      }
    }
  }
  *length = needed;
  if (s != NVJPEG_STATUS_SUCCESS && status == 0) status = (int)s;
  if (params) nvjpegEncoderParamsDestroy(params);
  if (enc) nvjpegEncoderStateDestroy(enc);
  return status;
}

}  // extern "C"
