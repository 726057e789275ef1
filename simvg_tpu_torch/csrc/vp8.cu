// WebP lossy (VP8 key frames) for Hopper (sm_90a): the bitstream in host
// C++, the pixels on the card.
//
// Replaces no TPU kernel: the JAX package decodes WebP on the host with cv2
// (libwebp).  simvg_tpu_torch/data/vp8.py holds the plain version of both
// stages; chip_smoke.py holds this file's route, host stage included, to it.
//
//   simvg_vp8_parse      host code, as sequential as the format: the frame
//                        header, the boolean decoder over the first
//                        partition (segments, filter, quantisers, token
//                        probabilities, each macroblock's modes) and over
//                        the token partitions (each block's levels); it
//                        gives per macroblock the modes, the loop filter's
//                        parameters and 25 blocks of levels;
//   reconstruct_kernel   dequantisation, the inverse WHT and DCTs, intra
//                        prediction.  A macroblock predicts from its left,
//                        top and top-right neighbours' unfiltered pixels, so
//                        the macroblocks go as a wavefront: diagonal
//                        t = x + 2 y at step t (its top-right neighbour is on
//                        diagonal t - 1), a warp a macroblock, one block, a
//                        __syncthreads() between steps;
//   filter_kernel        the simple or normal loop filter, in place over the
//                        whole frame.  libwebp filters a macroblock at a time
//                        in raster order, each reaching 3 pixels into its
//                        left and top neighbours; the same wavefront gives
//                        the same order for every pixel;
//   bgr_kernel           one thread a pixel: libwebp's fancy upsampling of U
//                        and V and its 14-bit YUV -> BGR.
//
// What bounds it: the wavefronts' steps (mb_w + 2 (mb_h - 1), 98 for 480 x
// 640), each a few hundred dependent shared-memory operations of one warp,
// and before them the host's boolean decoding, which takes longer than the
// kernels together.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (simvg_tpu_torch/ops/_build.py); called through ctypes with a plain C ABI.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <string>
#include <vector>

namespace {

// libwebp's tables, as in data/vp8.py (taken from OpenCV cv2 5.0.0's build
// of libwebp).
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42,
    43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
    65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86,
    87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 122,
    124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50,
    51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88,
    90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131,
    134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189,
    193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269,
    274, 279, 284};
const uint8_t kCoeffUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 223, 241, 252, 255, 255, 255, 255, 255, 255, 255,
    255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 244, 252, 255, 255, 255,
    255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255,
    255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 217, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255, 234, 250,
    241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 247, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 253, 255, 255, 255,
    255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234,
    251, 244, 254, 255, 255, 255, 255, 255, 255, 255, 251, 251, 243, 253, 254, 255, 254, 255,
    255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 236, 253, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255,
    255, 255, 255, 255, 248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253,
    255, 255, 255, 255, 255, 255, 255, 255, 246, 253, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 254, 252, 255, 255, 255,
    255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252,
    253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 249, 255, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255};
const uint8_t kCoeffProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254,
    255, 228, 219, 128, 128, 128, 128, 128, 189, 129, 242, 255, 227, 213, 255, 219, 128, 128,
    128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128, 1, 98, 248, 255, 236, 226, 255,
    255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128, 78, 134, 202,
    247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128,
    128, 128, 128, 128, 1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252,
    236, 209, 255, 255, 128, 128, 128, 37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1,
    204, 254, 255, 245, 255, 128, 128, 128, 128, 128, 207, 160, 250, 255, 238, 128, 128, 128,
    128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128, 1, 152, 252, 255, 240,
    255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128, 80,
    129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128,
    128, 128, 246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198,
    221, 172, 176, 220, 157, 252, 221, 1, 68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128, 184, 141, 234, 253, 222, 220, 255, 199,
    128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128, 1, 129, 232, 253, 214,
    197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128, 23, 91,
    163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128,
    128, 109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192,
    255, 255, 128, 128, 128, 1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225,
    251, 218, 190, 255, 255, 128, 128, 128, 22, 100, 174, 245, 186, 161, 255, 199, 128, 128,
    128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128, 124, 143, 241, 255, 227, 234, 128,
    128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128, 1, 157, 247, 255,
    236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128,
    128, 128, 128, 203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224,
    255, 128, 128, 128, 128, 128, 253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13,
    224, 243, 193, 185, 249, 198, 255, 255, 128, 73, 17, 171, 221, 161, 179, 236, 167, 255, 234,
    128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128, 239, 90, 244, 250, 211, 209, 255,
    255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128, 1, 24, 239, 251,
    218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128, 69,
    46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128,
    128, 128, 223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255,
    128, 128, 128, 128, 128, 128, 1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36,
    230, 255, 236, 255, 128, 128, 128, 128, 128, 149, 1, 255, 128, 128, 128, 128, 128, 128, 128,
    128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128, 247, 192, 255, 128, 128, 128, 128,
    128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 134, 252, 255,
    255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128, 55,
    93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128, 61, 46, 138, 219, 151, 178, 240, 170,
    255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128, 166, 109, 228, 252, 211,
    215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128, 1, 52,
    220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255,
    255, 128, 24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240,
    255, 224, 128, 128, 128, 149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108,
    170, 242, 183, 194, 254, 223, 255, 255, 128, 1, 81, 230, 252, 204, 203, 255, 192, 128, 128,
    128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128, 20, 95, 153, 243, 164, 173, 255,
    203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128, 168, 175, 246, 252,
    235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128, 1,
    121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219,
    128, 128, 128, 42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128,
    128, 128, 128, 128, 128, 128, 244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1,
    255, 128, 128, 128, 128, 128, 128, 128, 128};
const uint8_t kBModesProba[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95, 175, 69,
    143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152, 114, 26, 17, 163, 44,
    195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85, 144, 71, 10, 38, 171, 213, 144, 34,
    26, 170, 46, 55, 19, 136, 160, 33, 206, 71, 63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40,
    11, 96, 182, 84, 29, 16, 36, 134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130,
    157, 111, 32, 75, 80, 66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26,
    8, 107, 74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128, 104,
    79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23, 47, 41, 14, 110, 182,
    183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22, 88, 88, 147, 150, 42, 46, 45, 196,
    205, 43, 97, 183, 117, 85, 38, 35, 179, 61, 39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34,
    51, 104, 114, 102, 29, 93, 77, 39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23,
    34, 43, 166, 73, 107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51, 193, 101, 35,
    159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111, 112, 113, 77, 85, 179,
    255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109, 88, 43, 29, 140, 166, 213, 37, 43,
    154, 61, 63, 30, 155, 67, 45, 68, 1, 209, 100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78,
    16, 255, 128, 34, 197, 171, 41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192,
    23, 25, 82, 138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175, 47, 15, 16,
    183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183, 57, 46, 22, 24, 128, 1, 54,
    17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205, 40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37,
    9, 115, 59, 77, 64, 21, 47, 104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41,
    23, 26, 57, 54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73, 75, 32, 12, 51,
    192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85, 56, 21, 23, 111, 59, 205, 45,
    37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98, 125, 98, 42, 88, 104, 85, 117, 175, 82, 95,
    84, 53, 89, 128, 100, 113, 101, 45, 75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71,
    102, 57, 53, 41, 49, 38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47,
    114, 115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26, 57, 18,
    10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26, 102, 61, 71, 37, 34,
    53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37, 68, 45, 128, 34, 1, 47, 11, 245,
    171, 62, 17, 19, 70, 146, 85, 55, 62, 70, 37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92,
    136, 28, 64, 32, 201, 85, 75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25,
    248, 1, 56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40, 164,
    50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158, 86, 40, 64, 135,
    148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209, 45, 16, 21, 91, 64, 222, 7,
    1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213, 83, 12, 13, 54, 192, 255, 68, 47, 28, 85,
    26, 85, 85, 128, 128, 32, 146, 171, 18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146,
    174, 171, 12, 26, 128, 190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41,
    20, 32, 101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62, 71,
    30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142, 146, 36, 19, 30,
    171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64, 32, 41, 20, 117, 151, 142, 20,
    21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
const int8_t kYModesIntra4[18] = {0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9};

enum { DC_PRED = 0, TM_PRED = 1, V_PRED = 2, H_PRED = 3 };
enum { I4X4 = 0, MODES = 1, UVMODE = 17, SEGMENT = 18, LIMIT = 19, ILEVEL = 20, HEV = 21,
       INNER = 22, INFO = 24 };

struct Error {
  std::string what;
};

// RFC 6386's boolean decoder, as libwebp runs it (data/vp8.py's _BoolDecoder).
struct BoolDecoder {
  const uint8_t* buf = nullptr;
  long long n = 0, pos = 2, shifts = 0, limit = 0;
  uint32_t value = 0, range = 255;
  int count = 0;
  bool eof = false;

  BoolDecoder() = default;
  BoolDecoder(const uint8_t* b, long long size) : buf(b), n(size), limit(8 * size - 8) {
    value = (byte(0) << 8) | byte(1);
  }
  uint32_t byte(long long i) const { return i < n ? buf[i] : 0; }
  int bit(int prob) {
    if (shifts > limit) eof = true;
    const uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    const uint32_t big = split << 8;
    int b;
    if (value >= big) {
      range -= split;
      value -= big;
      b = 1;
    } else {
      range = split;
      b = 0;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      ++shifts;
      if (++count == 8) {
        count = 0;
        value |= byte(pos++);
      }
    }
    return b;
  }
  int bits(int k) {
    int v = 0;
    while (k-- > 0) v = (v << 1) | bit(0x80);
    return v;
  }
  int maybe(int k, bool is_signed) {
    if (!bit(0x80)) return 0;
    const int v = bits(k);
    return is_signed && bit(0x80) ? -v : v;
  }
};

__host__ __device__ int16_t i16(int v) { return (int16_t)(uint16_t)(v & 0xFFFF); }

int large_value(BoolDecoder& br, const uint8_t* p) {
  if (!br.bit(p[3])) return br.bit(p[4]) ? 3 + br.bit(p[5]) : 2;
  if (!br.bit(p[6])) {
    if (!br.bit(p[7])) return 5 + br.bit(159);
    int v = 7 + 2 * br.bit(165);
    return v + br.bit(145);
  }
  const int bit1 = br.bit(p[8]);
  const int bit0 = br.bit(p[9 + bit1]);
  const int cat = 2 * bit1 + bit0;
  int v = 0;
  for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
  return v + 3 + (8 << cat);
}

typedef uint8_t Probas[8][3][11];

int coeffs(BoolDecoder& br, const Probas& probs, int ctx, int first, int16_t* out) {
  int n = first;
  const uint8_t* p = probs[kBands[n]][ctx];
  while (n < 16) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      if (++n == 16) return 16;
      p = probs[kBands[n]][0];
    }
    int v, nxt;
    if (!br.bit(p[2])) {
      v = 1;
      nxt = 1;
    } else {
      v = large_value(br, p);
      nxt = 2;
    }
    out[kZigzag[n]] = (int16_t)(br.bit(0x80) ? -v : v);
    ++n;
    p = probs[kBands[n]][nxt];
  }
  return 16;
}

__host__ __device__ void wht(const int* dc, int* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = dc[i] + dc[12 + i], a1 = dc[4 + i] + dc[8 + i];
    const int a2 = dc[4 + i] - dc[8 + i], a3 = dc[i] - dc[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int d = tmp[4 * i] + 3;
    const int a0 = d + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = d - tmp[4 * i + 3];
    out[4 * i + 0] = i16((a0 + a1) >> 3);
    out[4 * i + 1] = i16((a3 + a2) >> 3);
    out[4 * i + 2] = i16((a0 - a1) >> 3);
    out[4 * i + 3] = i16((a3 - a2) >> 3);
  }
}

struct Frame {
  std::string error;
  int width = 0, height = 0, mb_w = 0, mb_h = 0, filter_type = 0;
  std::vector<uint8_t> info;
  std::vector<int16_t> levels;
  std::vector<int32_t> quant;
};

void parse(const uint8_t* data, long long size, Frame& f) {
  if (size < 10) throw Error{"truncated VP8 frame"};
  const uint32_t tag = data[0] | data[1] << 8 | data[2] << 16;
  if (tag & 1) throw Error{"VP8 frame is not a key frame"};
  if (((tag >> 1) & 7) > 3) throw Error{"VP8 frame has an unknown profile"};
  if (!((tag >> 4) & 1)) throw Error{"VP8 frame is not displayable"};
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) throw Error{"VP8 frame has a bad start code"};
  const int w = (data[6] | data[7] << 8) & 0x3FFF, h = (data[8] | data[9] << 8) & 0x3FFF;
  if (!w || !h) throw Error{"VP8 frame of zero size"};
  const long long part0 = tag >> 5;
  if (10 + part0 > size) throw Error{"VP8 first partition past the end of the frame"};
  BoolDecoder br(data + 10, part0);
  br.bit(0x80);
  br.bit(0x80);  // colour space, clamping type
  const int seg_on = br.bit(0x80);
  int update_map = 0, absolute = 0, seg_q[4] = {0, 0, 0, 0}, seg_lf[4] = {0, 0, 0, 0};
  int seg_p[3] = {255, 255, 255};
  if (seg_on) {
    update_map = br.bit(0x80);
    if (br.bit(0x80)) {
      absolute = br.bit(0x80);
      for (int s = 0; s < 4; ++s) seg_q[s] = br.maybe(7, true);
      for (int s = 0; s < 4; ++s) seg_lf[s] = br.maybe(6, true);
    }
    if (update_map)
      for (int s = 0; s < 3; ++s) seg_p[s] = br.bit(0x80) ? br.bits(8) : 255;
  }
  const int simple = br.bit(0x80);
  const int level = br.bits(6), sharpness = br.bits(3);
  int ref_lf[4] = {0, 0, 0, 0}, mode_lf[4] = {0, 0, 0, 0};
  const int use_lf_delta = br.bit(0x80);
  if (use_lf_delta && br.bit(0x80)) {
    for (int k = 0; k < 4; ++k) ref_lf[k] = br.maybe(6, true);
    for (int k = 0; k < 4; ++k) mode_lf[k] = br.maybe(6, true);
  }
  f.filter_type = level == 0 ? 0 : simple ? 1 : 2;
  const int nparts = 1 << br.bits(2);
  const uint8_t* rest = data + 10 + part0;
  const long long rest_n = size - 10 - part0;
  if (rest_n < 3 * (nparts - 1)) throw Error{"VP8 partition sizes past the end of the frame"};
  std::vector<BoolDecoder> parts;
  long long start = 3 * (nparts - 1);
  for (int p = 0; p < nparts - 1; ++p) {
    long long psize = rest[3 * p] | rest[3 * p + 1] << 8 | rest[3 * p + 2] << 16;
    if (psize > rest_n - start) psize = rest_n - start;
    parts.emplace_back(rest + start, psize);
    start += psize;
  }
  if (start >= rest_n) throw Error{"VP8 frame ends before its last partition"};
  parts.emplace_back(rest + start, rest_n - start);
  // quantisers
  const int base = br.bits(7);
  int dq[5];
  for (int k = 0; k < 5; ++k) dq[k] = br.maybe(4, true);
  f.quant.assign(24, 0);
  auto clip = [](int x, int m) { return x < 0 ? 0 : x > m ? m : x; };
  for (int s = 0; s < 4; ++s) {
    const int v = seg_on ? seg_q[s] + (absolute ? 0 : base) : base;
    int32_t* q = &f.quant[6 * s];
    q[0] = kDcTable[clip(v + dq[0], 127)];
    q[1] = kAcTable[clip(v, 127)];
    q[2] = kDcTable[clip(v + dq[1], 127)] * 2;
    q[3] = (kAcTable[clip(v + dq[2], 127)] * 101581) >> 16;
    if (q[3] < 8) q[3] = 8;
    q[4] = kDcTable[clip(v + dq[3], 117)];
    q[5] = kAcTable[clip(v + dq[4], 127)];
  }
  br.bit(0x80);  // refresh entropy probabilities: ignored in a key frame
  Probas probs[4];
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int k = 0; k < 11; ++k) {
          const int i = ((t * 8 + b) * 3 + c) * 11 + k;
          probs[t][b][c][k] = br.bit(kCoeffUpdateProba[i]) ? (uint8_t)br.bits(8) : kCoeffProba0[i];
        }
  const int use_skip = br.bit(0x80);
  const int skip_p = use_skip ? br.bits(8) : 0;
  if (br.eof) throw Error{"VP8 frame header past the end of its partition"};
  uint8_t fparams[4][2][3];  // limit, ilevel, hev
  for (int s = 0; s < 4; ++s) {
    const int base_level = seg_on ? seg_lf[s] + (absolute ? 0 : level) : level;
    for (int i4 = 0; i4 < 2; ++i4) {
      int lv = base_level;
      if (use_lf_delta) lv += ref_lf[0] + (i4 ? mode_lf[0] : 0);
      lv = clip(lv, 63);
      if (lv > 0) {
        int il = lv;
        if (sharpness > 0) {
          il >>= sharpness > 4 ? 2 : 1;
          if (il > 9 - sharpness) il = 9 - sharpness;
        }
        if (il < 1) il = 1;
        fparams[s][i4][0] = (uint8_t)(2 * lv + il);
        fparams[s][i4][1] = (uint8_t)il;
        fparams[s][i4][2] = (uint8_t)(lv >= 40 ? 2 : lv >= 15 ? 1 : 0);
      } else {
        fparams[s][i4][0] = fparams[s][i4][1] = fparams[s][i4][2] = 0;
      }
    }
  }
  f.width = w;
  f.height = h;
  f.mb_w = (w + 15) >> 4;
  f.mb_h = (h + 15) >> 4;
  const int nmb = f.mb_w * f.mb_h;
  f.info.assign((size_t)nmb * INFO, 0);
  f.levels.assign((size_t)nmb * 25 * 16, 0);
  std::vector<uint8_t> intra_t(4 * f.mb_w, 0);
  std::vector<uint8_t> top_nz(9 * f.mb_w, 0);
  for (int my = 0; my < f.mb_h; ++my) {
    uint8_t intra_l[4] = {0, 0, 0, 0}, ln[9] = {0};
    BoolDecoder& tb = parts[my & (nparts - 1)];
    for (int mx = 0; mx < f.mb_w; ++mx) {
      uint8_t* row = &f.info[(size_t)(my * f.mb_w + mx) * INFO];
      const int seg = update_map ? (!br.bit(seg_p[0]) ? br.bit(seg_p[1]) : br.bit(seg_p[2]) + 2) : 0;
      const int skip = use_skip ? br.bit(skip_p) : 0;
      const int i4 = !br.bit(145);
      if (!i4) {
        const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED)
                                      : (br.bit(163) ? V_PRED : DC_PRED);
        row[MODES] = (uint8_t)ymode;
        for (int k = 0; k < 4; ++k) intra_t[4 * mx + k] = intra_l[k] = (uint8_t)ymode;
      } else {
        for (int y = 0; y < 4; ++y) {
          int ym = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = &kBModesProba[(intra_t[4 * mx + x] * 10 + ym) * 9];
            int i = kYModesIntra4[br.bit(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
            ym = -i;
            intra_t[4 * mx + x] = (uint8_t)ym;
            row[MODES + 4 * y + x] = (uint8_t)ym;
          }
          intra_l[y] = (uint8_t)ym;
        }
      }
      row[UVMODE] = (uint8_t)(!br.bit(142) ? DC_PRED : !br.bit(114) ? V_PRED : br.bit(183) ? TM_PRED : H_PRED);
      row[I4X4] = (uint8_t)i4;
      row[SEGMENT] = (uint8_t)seg;
      int16_t* lv = &f.levels[(size_t)(my * f.mb_w + mx) * 400];
      uint8_t* tn = &top_nz[9 * mx];
      bool coded = false;
      if (skip) {
        for (int k = 0; k < 8; ++k) tn[k] = ln[k] = 0;
        if (!i4) tn[8] = ln[8] = 0;
      } else {
        const int32_t* q = &f.quant[6 * seg];
        int first = 0, ptype = 3, dcs[16] = {0};
        if (!i4) {
          int16_t* dc = lv + 24 * 16;
          const int nz = coeffs(tb, probs[1], tn[8] + ln[8], 0, dc);
          tn[8] = ln[8] = nz > 0;
          int deq[16];
          for (int k = 0; k < 16; ++k) deq[k] = i16(dc[k] * (k == 0 ? q[2] : q[3]));
          wht(deq, dcs);
          first = 1;
          ptype = 0;
        }
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) {
            int16_t* blk = lv + (4 * y + x) * 16;
            const int nz = coeffs(tb, probs[ptype], tn[x] + ln[y], first, blk);
            tn[x] = ln[y] = nz > first;
            const int d0 = i4 ? i16(blk[0] * q[0]) : dcs[4 * y + x];
            coded |= nz > 1 || d0 != 0;
          }
        for (int c = 0; c < 2; ++c)
          for (int y = 0; y < 2; ++y)
            for (int x = 0; x < 2; ++x) {
              int16_t* blk = lv + (16 + 4 * c + 2 * y + x) * 16;
              const int nz = coeffs(tb, probs[2], tn[4 + 2 * c + x] + ln[4 + 2 * c + y], 0, blk);
              tn[4 + 2 * c + x] = ln[4 + 2 * c + y] = nz > 0;
              coded |= nz > 1 || i16(blk[0] * q[4]) != 0;
            }
      }
      row[LIMIT] = fparams[seg][i4][0];
      row[ILEVEL] = fparams[seg][i4][1];
      row[HEV] = fparams[seg][i4][2];
      row[INNER] = (uint8_t)(i4 || coded);
      if (tb.eof) throw Error{"VP8 token partition ends early"};
    }
    if (br.eof) throw Error{"VP8 first partition ends early"};
  }
}

// ---- the kernels ------------------------------------------------------------

constexpr int kWarps = 16;
constexpr int kThreads = 256;

struct WarpBuf {
  int16_t coef[24][16];  // dequantised, the i16 luma DCs from the WHT
  uint8_t y[17][21];     // libwebp's work buffer: row 0 above, column 0 left
  uint8_t uv[2][9][9];
  uint8_t pred[16];
  int tmp[16];
  int sum;
};

__device__ __forceinline__ int clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
__device__ __forceinline__ int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
__device__ __forceinline__ int avg2(int a, int b) { return (a + b + 1) >> 1; }
__device__ __forceinline__ int mul1(int a) { return ((a * 20091) >> 16) + a; }
__device__ __forceinline__ int mul2(int a) { return (a * 35468) >> 16; }

// A 4x4 block's prediction (dsp/dec.c), from the work buffer around it.
__device__ void pred4(int mode, const uint8_t* top, const uint8_t* left, int left_stride, int X,
                      uint8_t* p) {
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
            H = top[7];
  const int I = left[0], J = left[left_stride], K = left[2 * left_stride], L = left[3 * left_stride];
#define P(x, y) p[(y) * 4 + (x)]
  switch (mode) {
    case 0: {
      const int v = (A + B + C + D + I + J + K + L + 4) >> 3;
      for (int k = 0; k < 16; ++k) p[k] = (uint8_t)v;
      break;
    }
    case 1: {
      const int l[4] = {I, J, K, L}, t[4] = {A, B, C, D};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) P(x, y) = (uint8_t)clip8(l[y] + t[x] - X);
      break;
    }
    case 2: {
      const int v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) P(x, y) = (uint8_t)v[x];
      break;
    }
    case 3: {
      const int v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) P(x, y) = (uint8_t)v[y];
      break;
    }
    case 4:  // RD
      P(0, 3) = avg3(J, K, L);
      P(1, 3) = P(0, 2) = avg3(I, J, K);
      P(2, 3) = P(1, 2) = P(0, 1) = avg3(X, I, J);
      P(3, 3) = P(2, 2) = P(1, 1) = P(0, 0) = avg3(A, X, I);
      P(3, 2) = P(2, 1) = P(1, 0) = avg3(B, A, X);
      P(3, 1) = P(2, 0) = avg3(C, B, A);
      P(3, 0) = avg3(D, C, B);
      break;
    case 5:  // VR
      P(0, 0) = P(1, 2) = avg2(X, A);
      P(1, 0) = P(2, 2) = avg2(A, B);
      P(2, 0) = P(3, 2) = avg2(B, C);
      P(3, 0) = avg2(C, D);
      P(0, 3) = avg3(K, J, I);
      P(0, 2) = avg3(J, I, X);
      P(0, 1) = P(1, 3) = avg3(I, X, A);
      P(1, 1) = P(2, 3) = avg3(X, A, B);
      P(2, 1) = P(3, 3) = avg3(A, B, C);
      P(3, 1) = avg3(B, C, D);
      break;
    case 6:  // LD
      P(0, 0) = avg3(A, B, C);
      P(1, 0) = P(0, 1) = avg3(B, C, D);
      P(2, 0) = P(1, 1) = P(0, 2) = avg3(C, D, E);
      P(3, 0) = P(2, 1) = P(1, 2) = P(0, 3) = avg3(D, E, F);
      P(3, 1) = P(2, 2) = P(1, 3) = avg3(E, F, G);
      P(3, 2) = P(2, 3) = avg3(F, G, H);
      P(3, 3) = avg3(G, H, H);
      break;
    case 7:  // VL
      P(0, 0) = avg2(A, B);
      P(1, 0) = P(0, 2) = avg2(B, C);
      P(2, 0) = P(1, 2) = avg2(C, D);
      P(3, 0) = P(2, 2) = avg2(D, E);
      P(0, 1) = avg3(A, B, C);
      P(1, 1) = P(0, 3) = avg3(B, C, D);
      P(2, 1) = P(1, 3) = avg3(C, D, E);
      P(3, 1) = P(2, 3) = avg3(D, E, F);
      P(3, 2) = avg3(E, F, G);
      P(3, 3) = avg3(F, G, H);
      break;
    case 8:  // HD
      P(0, 0) = P(2, 1) = avg2(I, X);
      P(0, 1) = P(2, 2) = avg2(J, I);
      P(0, 2) = P(2, 3) = avg2(K, J);
      P(0, 3) = avg2(L, K);
      P(3, 0) = avg3(A, B, C);
      P(2, 0) = avg3(X, A, B);
      P(1, 0) = P(3, 1) = avg3(I, X, A);
      P(1, 1) = P(3, 2) = avg3(J, I, X);
      P(1, 2) = P(3, 3) = avg3(K, J, I);
      P(1, 3) = avg3(L, K, J);
      break;
    default:  // HU
      P(0, 0) = avg2(I, J);
      P(2, 0) = P(0, 1) = avg2(J, K);
      P(2, 1) = P(0, 2) = avg2(K, L);
      P(1, 0) = avg3(I, J, K);
      P(3, 0) = P(1, 1) = avg3(J, K, L);
      P(3, 1) = P(1, 2) = avg3(K, L, L);
      P(3, 2) = P(2, 2) = P(0, 3) = P(1, 3) = P(2, 3) = P(3, 3) = (uint8_t)L;
  }
#undef P
}

// The inverse DCT of one block (lanes 0-3 the vertical pass, then lanes 0-15
// a pixel each), added to the [4 x 4] pixels at `dst` (row stride `stride`),
// whose prediction is there already.  The whole warp calls it.
__device__ void idct_add(const int16_t* in, uint8_t* dst, int stride, int* tmp, int lane) {
  if (lane < 4) {
    const int i = lane;
    const int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  __syncwarp();
  if (lane < 16) {
    const int i = lane >> 2, x = lane & 3;
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i], b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    const int v = x == 0 ? a + d : x == 1 ? b + c : x == 2 ? b - c : a - d;
    uint8_t* px = dst + i * stride + x;
    *px = (uint8_t)clip8(*px + (v >> 3));
  }
  __syncwarp();
}

// A 16x16 luma or 8x8 chroma block's prediction from the work buffer `ws`
// (row stride `ws_stride`; the block at ws + ws_stride + 1).
__device__ void pred_block(int mode, int size, uint8_t* ws, int ws_stride, int mb_x, int mb_y,
                           int* sum, int lane) {
  uint8_t* dst = ws + ws_stride + 1;
  if (mode == DC_PRED) {
    if (lane == 0) {
      int s = 0;
      const int shift = size == 16 ? 4 : 3;
      for (int k = 0; k < size; ++k) s += (mb_y ? ws[1 + k] : 0) + (mb_x ? ws[(k + 1) * ws_stride] : 0);
      if (mb_x && mb_y)
        s = (s + size) >> (shift + 1);
      else if (mb_x || mb_y)
        s = (s + (size >> 1)) >> shift;
      else
        s = 128;
      *sum = s;
    }
    __syncwarp();
  }
  for (int k = lane; k < size * size; k += 32) {
    const int y = k / size, x = k % size;
    const int top = ws[1 + x], left = ws[(y + 1) * ws_stride], tl = ws[0];
    int v;
    switch (mode) {
      case DC_PRED: v = *sum; break;
      case TM_PRED: v = clip8(left + top - tl); break;
      case V_PRED: v = top; break;
      default: v = left;
    }
    dst[y * ws_stride + x] = (uint8_t)v;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kWarps * 32)
reconstruct_kernel(const uint8_t* __restrict__ info, const int16_t* __restrict__ levels,
                   const int32_t* __restrict__ quant, int mb_w, int mb_h, uint8_t* Y, uint8_t* U,
                   uint8_t* V) {
  __shared__ WarpBuf bufs[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  WarpBuf& b = bufs[warp];
  const int ys = 16 * mb_w, uvs = 8 * mb_w;
  const int steps = mb_w + 2 * (mb_h - 1);
  for (int t = 0; t < steps; ++t) {
    int my0 = t - (mb_w - 1) > 0 ? (t - (mb_w - 1) + 1) / 2 : 0;
    const int my1 = min(mb_h - 1, t / 2);
    for (int my = my0 + warp; my <= my1; my += kWarps) {
      const int mx = t - 2 * my;
      const int idx = my * mb_w + mx;
      const uint8_t* row = info + (size_t)idx * INFO;
      const int32_t* q = quant + 6 * row[SEGMENT];
      const int16_t* lv = levels + (size_t)idx * 400;
      // dequantise
      for (int k = lane; k < 384; k += 32) {
        const int blk = k >> 4, pos = k & 15;
        const int step = blk < 16 ? (pos ? q[1] : q[0]) : (pos ? q[5] : q[4]);
        b.coef[blk][pos] = (int16_t)(lv[k] * step);
      }
      __syncwarp();
      if (!row[I4X4] && lane == 0) {
        int dc[16], out[16];
        for (int k = 0; k < 16; ++k) dc[k] = i16(lv[384 + k] * (k ? q[3] : q[2]));
        wht(dc, out);
        for (int k = 0; k < 16; ++k) b.coef[k][0] = (int16_t)out[k];
      }
      // the work buffers' edges: 127 above the frame, 129 left of it
      const int y0 = 16 * my, x0 = 16 * mx;
      for (int k = lane; k < 21; k += 32) {
        const int lx = k - 1;
        int v;
        if (my == 0)
          v = 127;
        else if (lx < 0)
          v = mx == 0 ? 129 : Y[(y0 - 1) * ys + x0 - 1];
        else if (lx < 16)
          v = Y[(y0 - 1) * ys + x0 + lx];
        else
          v = mx == mb_w - 1 ? Y[(y0 - 1) * ys + x0 + 15] : Y[(y0 - 1) * ys + x0 + lx];
        b.y[0][k] = (uint8_t)v;
      }
      for (int k = lane; k < 16; k += 32) b.y[k + 1][0] = mx == 0 ? 129 : Y[(y0 + k) * ys + x0 - 1];
      for (int c = 0; c < 2; ++c) {
        const uint8_t* P = c ? V : U;
        for (int k = lane; k < 9; k += 32) {
          const int lx = k - 1;
          int v;
          if (my == 0)
            v = 127;
          else if (lx < 0)
            v = mx == 0 ? 129 : P[(8 * my - 1) * uvs + 8 * mx - 1];
          else
            v = P[(8 * my - 1) * uvs + 8 * mx + lx];
          b.uv[c][0][k] = (uint8_t)v;
        }
        for (int k = lane; k < 8; k += 32) b.uv[c][k + 1][0] = mx == 0 ? 129 : P[(8 * my + k) * uvs + 8 * mx - 1];
      }
      __syncwarp();
      if (row[I4X4]) {
        if (lane < 12) b.y[4 * (1 + lane / 4)][17 + lane % 4] = b.y[0][17 + lane % 4];
        __syncwarp();
        for (int n = 0; n < 16; ++n) {
          const int by = n >> 2, bx = n & 3;
          uint8_t* corner = &b.y[4 * by][4 * bx];  // the top-left neighbour
          if (lane == 0) pred4(row[MODES + n], corner + 1, corner + 21, 21, corner[0], b.pred);
          __syncwarp();
          if (lane < 16) corner[(1 + (lane >> 2)) * 21 + 1 + (lane & 3)] = b.pred[lane];
          __syncwarp();
          idct_add(b.coef[n], corner + 22, 21, b.tmp, lane);
        }
      } else {
        pred_block(row[MODES], 16, &b.y[0][0], 21, mx, my, &b.sum, lane);
        for (int n = 0; n < 16; ++n)
          idct_add(b.coef[n], &b.y[1 + 4 * (n >> 2)][1 + 4 * (n & 3)], 21, b.tmp, lane);
      }
      for (int c = 0; c < 2; ++c) {
        pred_block(row[UVMODE], 8, &b.uv[c][0][0], 9, mx, my, &b.sum, lane);
        for (int n = 0; n < 4; ++n)
          idct_add(b.coef[16 + 4 * c + n], &b.uv[c][1 + 4 * (n >> 1)][1 + 4 * (n & 1)], 9, b.tmp,
                   lane);
      }
      for (int k = lane; k < 256; k += 32) Y[(y0 + k / 16) * ys + x0 + k % 16] = b.y[1 + k / 16][1 + k % 16];
      for (int k = lane; k < 128; k += 32) {
        const int c = k >> 6, p = k & 63;
        (c ? V : U)[(8 * my + p / 8) * uvs + 8 * mx + p % 8] = b.uv[c][1 + p / 8][1 + p % 8];
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

// ---- the loop filter (dsp/dec.c), on pixels `step` apart across an edge ----

__device__ __forceinline__ int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
__device__ __forceinline__ int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

__device__ void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = (uint8_t)clip8(p0 + a2);
  p[0] = (uint8_t)clip8(q0 - a1);
}

__device__ void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = (uint8_t)clip8(p1 + a3);
  p[-step] = (uint8_t)clip8(p0 + a2);
  p[0] = (uint8_t)clip8(q0 - a1);
  p[step] = (uint8_t)clip8(q1 - a3);
}

__device__ void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = (uint8_t)clip8(p2 + a3);
  p[-2 * step] = (uint8_t)clip8(p1 + a2);
  p[-step] = (uint8_t)clip8(p0 + a1);
  p[0] = (uint8_t)clip8(q0 - a1);
  p[step] = (uint8_t)clip8(q1 - a2);
  p[2 * step] = (uint8_t)clip8(q2 - a3);
}

__device__ bool needs(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * abs(p0 - q0) + abs(p1 - q1) <= t;
}

__device__ bool needs2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return false;
  return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it && abs(q3 - q2) <= it &&
         abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

__device__ bool hev(const uint8_t* p, int step, int thresh) {
  return abs(p[-2 * step] - p[-step]) > thresh || abs(p[step] - p[0]) > thresh;
}

// One position along an edge: `p` at q0, `step` across the edge.
__device__ void filter_at(uint8_t* p, int step, bool simple, int thresh, int ithresh, int hev_t,
                          bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  if (simple) {
    if (needs(p, step, t2)) filter2(p, step);
  } else if (needs2(p, step, t2, ithresh)) {
    if (hev(p, step, hev_t))
      filter2(p, step);
    else if (mb_edge)
      filter6(p, step);
    else
      filter4(p, step);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
filter_kernel(const uint8_t* __restrict__ info, int mb_w, int mb_h, int filter_type, uint8_t* Y,
              uint8_t* U, uint8_t* V) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool simple = filter_type == 1;
  const int ys = 16 * mb_w, uvs = 8 * mb_w;
  const int steps = mb_w + 2 * (mb_h - 1);
  for (int t = 0; t < steps; ++t) {
    int my0 = t - (mb_w - 1) > 0 ? (t - (mb_w - 1) + 1) / 2 : 0;
    const int my1 = min(mb_h - 1, t / 2);
    for (int my = my0 + warp; my <= my1; my += kWarps) {
      const int mx = t - 2 * my;
      const uint8_t* row = info + (size_t)(my * mb_w + mx) * INFO;
      const int limit = row[LIMIT], il = row[ILEVEL], hv = row[HEV], inner = row[INNER];
      if (limit == 0) continue;
      // lanes 0-15: luma, one row (or column) each; lanes 16-23 U, 24-31 V
      // (the simple filter leaves chroma alone)
      const bool luma = lane < 16;
      const int size = luma ? 16 : 8;
      const int k = luma ? lane : (lane - 16) & 7;
      uint8_t* plane = luma ? Y : (lane < 24 ? U : V);
      const int stride = luma ? ys : uvs;
      const int y0 = size * my, x0 = size * mx;
      const bool active = luma || !simple;
      for (int vertical = 1; vertical >= 0; --vertical) {
        // vertical: an edge left of column x, lane k filters row y0 + k
        uint8_t* base = vertical ? plane + (size_t)(y0 + k) * stride + x0
                                 : plane + (size_t)y0 * stride + x0 + k;
        const int step = vertical ? 1 : stride;
        if (active && (vertical ? mx : my) > 0) filter_at(base, step, simple, limit + 4, il, hv, true);
        __syncwarp();
        if (inner)
          for (int e = 4; e < 16; e += 4) {
            if (active && e < size) filter_at(base + e * step, step, simple, limit, il, hv, false);
            __syncwarp();
          }
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ int yuv_clip(int v) {
  return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255;
}

__global__ void __launch_bounds__(kThreads)
bgr_kernel(const uint8_t* __restrict__ Y, const uint8_t* __restrict__ U,
           const uint8_t* __restrict__ V, int mb_w, int w, int h, uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)w * h) return;
  const int y = (int)(i / w), x = (int)(i % w);
  const int uvw = (w + 1) >> 1, uvh = (h + 1) >> 1, ys = 16 * mb_w, uvs = 8 * mb_w;
  // the nearer and farther chroma rows, the nearer and other columns
  const int k = (y + 1) >> 1;
  const int near_r = y == 0 ? 0 : (y & 1) ? k - 1 : k;
  const int far_r = y == 0 ? 0 : (y & 1) ? min(k, uvh - 1) : k - 1;
  const int j = (x + 1) >> 1;
  const int ncol = (x & 1) ? j - 1 : j;
  int ocol = (x & 1) ? j : j - 1;
  const bool four = x > 0 && ocol < uvw;
  ocol = ocol < 0 ? 0 : ocol > uvw - 1 ? uvw - 1 : ocol;
  int c[2];
  for (int p = 0; p < 2; ++p) {
    const uint8_t* P = p ? V : U;
    const int N = P[near_r * uvs + ncol], H = P[near_r * uvs + ocol];
    const int Vv = P[far_r * uvs + ncol], D = P[far_r * uvs + ocol];
    c[p] = four ? ((((N + H + Vv + D + 8) + 2 * (H + Vv)) >> 3) + N) >> 1 : (3 * N + Vv + 2) >> 2;
  }
  const int yy = (Y[(size_t)y * ys + x] * 19077) >> 8;
  const int u = c[0], v = c[1];
  uint8_t* o = out + i * 3;
  o[0] = (uint8_t)yuv_clip(yy + ((u * 33050) >> 8) - 17685);
  o[1] = (uint8_t)yuv_clip(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708);
  o[2] = (uint8_t)yuv_clip(yy + ((v * 26149) >> 8) - 14234);
}

}  // namespace

// Host code: parses a VP8 key frame; never returns null.  simvg_vp8_info
// gives 0 and (width, height, mb_w, mb_h, filter type), or -1 with
// simvg_vp8_error.
extern "C" void* simvg_vp8_parse(const uint8_t* data, long long n) {
  Frame* f = new Frame();
  try {
    parse(data, n, *f);
  } catch (const Error& e) {
    f->error = e.what;
  }
  return f;
}

extern "C" int simvg_vp8_info(void* handle, int* out) {
  const Frame* f = static_cast<Frame*>(handle);
  if (!f->error.empty()) return -1;
  out[0] = f->width;
  out[1] = f->height;
  out[2] = f->mb_w;
  out[3] = f->mb_h;
  out[4] = f->filter_type;
  return 0;
}

// Array k (0 the per-macroblock info, uint8 [n, 24]; 1 the levels, int16
// [n, 25, 16]; 2 the quantiser steps, int32 [4, 6]) copied to dst; returns
// its size in bytes.
extern "C" long long simvg_vp8_copy(void* handle, int k, void* dst) {
  const Frame* f = static_cast<Frame*>(handle);
  const void* src = k == 0 ? (const void*)f->info.data()
                  : k == 1 ? (const void*)f->levels.data() : (const void*)f->quant.data();
  const long long bytes = k == 0 ? (long long)f->info.size()
                        : k == 1 ? (long long)f->levels.size() * 2 : (long long)f->quant.size() * 4;
  if (dst != nullptr) memcpy(dst, src, bytes);
  return bytes;
}

extern "C" const char* simvg_vp8_error(void* handle) { return static_cast<Frame*>(handle)->error.c_str(); }

extern "C" void simvg_vp8_free(void* handle) { delete static_cast<Frame*>(handle); }

// The frame's pixels on the card: info, levels and quant as simvg_vp8_copy
// gives them; y [16 mb_h, 16 mb_w], u and v [8 mb_h, 8 mb_w] work planes;
// out BGR uint8 [height, width, 3].  Three launches on `stream`; returns the
// CUDA error of the launches (0 if none).
extern "C" int simvg_vp8_decode(const void* info, const void* levels, const void* quant, int mb_w,
                                int mb_h, int filter_type, int width, int height, void* y, void* u,
                                void* v, void* out, void* stream) {
  if (mb_w <= 0 || mb_h <= 0 || width <= 0 || height <= 0 || width > 16 * mb_w ||
      height > 16 * mb_h)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(info);
  uint8_t *Y = static_cast<uint8_t*>(y), *U = static_cast<uint8_t*>(u), *V = static_cast<uint8_t*>(v);
  reconstruct_kernel<<<1, kWarps * 32, 0, s>>>(in, static_cast<const int16_t*>(levels),
                                               static_cast<const int32_t*>(quant), mb_w, mb_h, Y, U, V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (filter_type > 0) {
    filter_kernel<<<1, kWarps * 32, 0, s>>>(in, mb_w, mb_h, filter_type, Y, U, V);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long pixels = (long long)width * height;
  bgr_kernel<<<(unsigned)((pixels + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      Y, U, V, mb_w, width, height, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
