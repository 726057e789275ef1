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
//   reconstruct_filter_kernel
//                        dequantisation, the inverse WHT and DCTs, intra
//                        prediction and the simple or normal loop filter,
//                        in one launch.  A macroblock predicts from its
//                        left, top and top-right neighbours' unfiltered
//                        pixels, so the macroblocks go as a wavefront:
//                        diagonal t = x + 2 y at step t (its top-right
//                        neighbour is on diagonal t - 1).  libwebp filters a
//                        macroblock at a time in raster order, each reaching
//                        3 pixels into its left and top neighbours; filtered
//                        a diagonal behind the reconstruction, the same
//                        wavefront keeps that order for every pixel, and
//                        the prediction reads the unfiltered edges that the
//                        kernel saves in shared memory (a column's bottom
//                        row, a row's right column), never the frame;
//   bgr_kernel           one thread a pixel: libwebp's fancy upsampling of U
//                        and V and its 14-bit YUV -> BGR.
//
// The wavefront's design.  A warp takes a macroblock: the inverse WHT on 16
// lanes, the 24 inverse DCTs at once (a block's column, then its row, a
// lane each, three a lane), the 16x16 and chroma predictions a pixel pass,
// B_PRED's 16 sub-blocks as a wavefront over bx + 2 by (10 steps, two
// sub-blocks a step, a pixel a lane), the pixels written to the frame once;
// its levels and modes are copied into shared memory a step ahead
// (cp.async).  A filtering warp runs each line's edges in registers, a lane
// a row and then a column.  The rows are dealt round a cluster of kCluster
// blocks (one an SM; one SM's issue slots were the limit of a one-block
// design): block k takes the rows y = k mod kCluster, stores a macroblock's
// bottom row into the next block's shared memory (distributed shared
// memory), and a cluster barrier separates the steps.
//
// What bounds it: the wavefront's steps (mb_w + 2 (mb_h - 1) + 1, 99 for
// 480 x 640), each as long as its slowest macroblock: a B_PRED
// reconstruction (the 10-step sub-block chain, each step a few dependent
// shared-memory operations) plus the barrier.  Before them the host's
// boolean decoding takes longer than the kernels together.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (simvg_tpu_torch/ops/_build.py); called through ctypes with a plain C ABI.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <string>
#include <vector>

namespace cg = cooperative_groups;

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

constexpr int kCluster = 8;      // SMs the wavefront runs on: a block each, one cluster
constexpr int kBlockWarps = 8;   // macroblocks in flight a block: a warp each
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// A warp's work space in shared memory.
struct alignas(16) WarpBuf {
  // libwebp's work buffer, luma: row 0 the pixels above (column 15 the
  // corner, 32-35 above-right, copied to rows 4, 8 and 12 for B_PRED),
  // column 15 the pixels to the left, the macroblock at rows 1-16, columns
  // 16-31
  uint8_t y[17 * 48];
  uint8_t uv[2][9 * 16];  // chroma: the same at column 7, the block at 8-15
  int16_t resid[24][16];  // the inverse transforms (>> 3): Y 0-15, U, V
  union {
    int tmp[24][16];  // the inverse DCTs' first pass
    struct {          // the loop filter's pixels, from 4 above and 4 left
      uint8_t y[20 * 20];
      uint8_t uv[2][12 * 12];
    } tile;
  };
  // the levels and modes of the warp's macroblock of this step and the
  // next, copied from device memory a step ahead (cp.async)
  int16_t staged_levels[2][400];
  uint8_t staged_info[2][32];
};

// The unfiltered pixels the macroblocks below and to the right predict
// from: a column's bottom row, a row's right column and its corner.
struct TopEdge {
  uint8_t y[16], u[8], v[8];
};
struct LeftEdge {
  uint8_t y[16], u[8], v[8];
  uint8_t cy, cu, cv, pad[13];
};

// B_PRED's modes 2-9 (VE, HE, RD, VR, LD, VL, HD, HU), a pixel (y * 4 + x)
// each: avg3(e[i0], e[i1], e[i2]) if bit 12, else avg2(e[i0], e[i1]), over
// the edge e = L K J I X A B C D E F G H (dsp/dec.c's names; generated from
// data/vp8.py's _pred4).  The kernel turns it into pred4_codes' form.
__constant__ uint16_t kPred4[8][16] = {
    {0x1654, 0x1765, 0x1876, 0x1987, 0x1654, 0x1765, 0x1876, 0x1987, 0x1654, 0x1765, 0x1876,
     0x1987, 0x1654, 0x1765, 0x1876, 0x1987},
    {0x1234, 0x1234, 0x1234, 0x1234, 0x1123, 0x1123, 0x1123, 0x1123, 0x1012, 0x1012, 0x1012,
     0x1012, 0x1001, 0x1001, 0x1001, 0x1001},
    {0x1345, 0x1456, 0x1567, 0x1678, 0x1234, 0x1345, 0x1456, 0x1567, 0x1123, 0x1234, 0x1345,
     0x1456, 0x1012, 0x1123, 0x1234, 0x1345},
    {0x0554, 0x0665, 0x0776, 0x0887, 0x1543, 0x1654, 0x1765, 0x1876, 0x1432, 0x0554, 0x0665,
     0x0776, 0x1321, 0x1543, 0x1654, 0x1765},
    {0x1765, 0x1876, 0x1987, 0x1a98, 0x1876, 0x1987, 0x1a98, 0x1ba9, 0x1987, 0x1a98, 0x1ba9,
     0x1cba, 0x1a98, 0x1ba9, 0x1cba, 0x1ccb},
    {0x0665, 0x0776, 0x0887, 0x0998, 0x1765, 0x1876, 0x1987, 0x1a98, 0x0776, 0x0887, 0x0998,
     0x1ba9, 0x1876, 0x1987, 0x1a98, 0x1cba},
    {0x0443, 0x1543, 0x1654, 0x1765, 0x0332, 0x1432, 0x0443, 0x1543, 0x0221, 0x1321, 0x0332,
     0x1432, 0x0110, 0x1210, 0x0221, 0x1321},
    {0x0223, 0x1123, 0x0112, 0x1012, 0x0112, 0x1012, 0x0001, 0x1001, 0x0001, 0x1001, 0x0000,
     0x0000, 0x0000, 0x0000, 0x0000, 0x0000}};

__device__ __forceinline__ int clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
__device__ __forceinline__ int mul1(int a) { return ((a * 20091) >> 16) + a; }
__device__ __forceinline__ int mul2(int a) { return (a * 35468) >> 16; }

// A block's dynamic shared memory: its warps' buffers, then these.  Block
// k of the cluster takes the macroblock rows y = k mod kCluster.
struct Shared {
  WarpBuf* bufs;
  int* quant;        // [4][6]
  uint32_t* pred4;   // [10][16]: pred4_code of each B_PRED mode and pixel
  TopEdge* top;      // [mb_w]: the bottom rows of the row above this block's
  LeftEdge* left;    // [rows / kCluster]: this block's rows
  TopEdge* below;    // `top` of the block of the next row (another SM's)
};

size_t shared_bytes(int mb_w, int mb_h) {
  return kBlockWarps * sizeof(WarpBuf) + 24 * sizeof(int) + 160 * sizeof(uint32_t) +
         (size_t)mb_w * sizeof(TopEdge) + (size_t)((mb_h + kCluster - 1) / kCluster) * sizeof(LeftEdge);
}

// A B_PRED pixel's prediction as three byte offsets from the sub-block's
// corner in the work buffer (bits 0-23) and its kind (bits 24-25): 0
// avg2(e0, e1), 1 avg3(e0, e1, e2), 2 TM clip(e0 + e1 - e2), 3 DC.
__device__ uint32_t pred4_code(int mode, int pix) {
  const int px = pix & 3, py = pix >> 2;
  if (mode == 0) return 3u << 24;
  if (mode == 1) return (uint32_t)(48 * (1 + py)) | (uint32_t)(1 + px) << 8 | 2u << 24;
  const int c = kPred4[mode - 2][pix];
  uint32_t code = (c & 0x1000) ? 1u << 24 : 0u;
  for (int k = 0; k < 3; ++k) {
    const int i = (c >> (4 * k)) & 15;
    code |= (uint32_t)(i < 4 ? 48 * (4 - i) : i - 4) << (8 * k);
  }
  return code;
}

// Copies a macroblock's levels and modes into a warp's staging buffer
// (cp.async, one group a call and lane, empty where `idx` < 0).
__device__ __forceinline__ void stage(WarpBuf& b, int slot, const uint8_t* info,
                                      const int16_t* levels, long long idx, int lane) {
  if (idx >= 0) {
    const char* lv = reinterpret_cast<const char*>(levels + idx * 400);
    char* dst = reinterpret_cast<char*>(b.staged_levels[slot]);
    for (int k = lane; k < 50; k += 32)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       (unsigned)__cvta_generic_to_shared(dst + 16 * k)),
                   "l"(lv + 16 * k)
                   : "memory");
    if (lane < 3)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                       (unsigned)__cvta_generic_to_shared(b.staged_info[slot] + 8 * lane)),
                   "l"(info + idx * INFO + 8 * lane)
                   : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One macroblock's reconstruction by a warp: dequantisation, the inverse
// WHT (16 lanes) and DCTs (24 blocks at once), intra prediction from the
// saved unfiltered edges (16x16 and chroma a pixel pass; B_PRED's 16
// sub-blocks as a wavefront over bx + 2 by, 10 steps), the pixels written
// once to Y, U and V and its edges saved for its neighbours.
__device__ void reconstruct(WarpBuf& b, const Shared& sh, const uint8_t* row, const int16_t* lv,
                            int mx, int my, int mb_w, uint8_t* Y, uint8_t* U, uint8_t* V,
                            int lane) {
  const int i4 = row[I4X4];
  const int* q = sh.quant + 6 * row[SEGMENT];
  // the i16 luma DCs: the inverse WHT, lane k giving DC k
  int dcv = 0;
  if (!i4) {
    const int k = lane & 15, i = k & 3, r = k >> 2;
    const int dc = i16(lv[384 + k] * (k ? q[3] : q[2]));
    const int d0 = __shfl_sync(kFull, dc, i), d4 = __shfl_sync(kFull, dc, 4 + i);
    const int d8 = __shfl_sync(kFull, dc, 8 + i), d12 = __shfl_sync(kFull, dc, 12 + i);
    const int a0 = d0 + d12, a1 = d4 + d8, a2 = d4 - d8, a3 = d0 - d12;
    const int tv = r == 0 ? a0 + a1 : r == 1 ? a3 + a2 : r == 2 ? a0 - a1 : a3 - a2;
    const int t0 = __shfl_sync(kFull, tv, 4 * r), t1 = __shfl_sync(kFull, tv, 4 * r + 1);
    const int t2 = __shfl_sync(kFull, tv, 4 * r + 2), t3 = __shfl_sync(kFull, tv, 4 * r + 3);
    const int d = t0 + 3, b0 = d + t3, b1 = t1 + t2, b2 = t1 - t2, b3 = d - t3;
    dcv = i16((i == 0 ? b0 + b1 : i == 1 ? b3 + b2 : i == 2 ? b0 - b1 : b3 - b2) >> 3);
  }
  // the inverse DCTs' first pass: (block, column) pairs, 3 a lane
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int n = lane + 32 * m, blk = n >> 2, i = n & 3;
    const int16_t* L = lv + blk * 16;
    const bool luma = blk < 16;
    const int qdc = luma ? q[0] : q[4], qac = luma ? q[1] : q[5];
    const int wdc = __shfl_sync(kFull, dcv, blk & 15);
    const int c0 = !i4 && luma && i == 0 ? wdc : i16(L[i] * (i ? qac : qdc));
    const int c4 = i16(L[4 + i] * qac), c8 = i16(L[8 + i] * qac), c12 = i16(L[12 + i] * qac);
    const int a = c0 + c8, bb = c0 - c8;
    const int c = mul2(c4) - mul1(c12), d = mul1(c4) + mul2(c12);
    *reinterpret_cast<int4*>(&b.tmp[blk][4 * i]) = make_int4(a + d, bb + c, bb - c, a - d);
  }
  // the work buffers' edges from the saved rows and columns
  const TopEdge& tp = sh.top[mx];
  LeftEdge& lf = sh.left[my / kCluster];
  if (lane < 4) {
    *reinterpret_cast<uint32_t*>(&b.y[16 + 4 * lane]) = *reinterpret_cast<const uint32_t*>(&tp.y[4 * lane]);
  } else if (lane < 8) {  // above-right: the next column's bottom row, or this one's last pixel
    const uint32_t ar = mx + 1 < mb_w ? *reinterpret_cast<const uint32_t*>(sh.top[mx + 1].y)
                                      : tp.y[15] * 0x01010101u;
    *reinterpret_cast<uint32_t*>(&b.y[48 * 4 * (lane - 4) + 32]) = ar;
  } else if (lane == 8) {
    b.y[15] = lf.cy;
  } else if (lane < 11) {
    const int c = lane - 9;
    *reinterpret_cast<uint2*>(&b.uv[c][8]) = *reinterpret_cast<const uint2*>(c ? tp.v : tp.u);
    b.uv[c][7] = c ? lf.cv : lf.cu;
  } else if (lane >= 16) {
    const int k = lane - 16, c = k >> 3, kk = k & 7;
    b.y[48 * (1 + k) + 15] = lf.y[k];
    b.uv[c][16 * (1 + kk) + 7] = (c ? lf.v : lf.u)[kk];
  }
  __syncwarp();
  // the inverse DCTs' second pass: (block, row) pairs, 3 a lane
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int n = lane + 32 * m, blk = n >> 2, i = n & 3;
    const int t0 = b.tmp[blk][i], t1 = b.tmp[blk][4 + i], t2 = b.tmp[blk][8 + i], t3 = b.tmp[blk][12 + i];
    const int dc = t0 + 4, a = dc + t2, bb = dc - t2;
    const int c = mul2(t1) - mul1(t3), d = mul1(t1) + mul2(t3);
    *reinterpret_cast<short4*>(&b.resid[blk][4 * i]) =
        make_short4((short)((a + d) >> 3), (short)((bb + c) >> 3), (short)((bb - c) >> 3),
                    (short)((a - d) >> 3));
  }
  __syncwarp();
  // chroma: lanes 0-15 U, 16-31 V; the DC sums in each half
  {
    const int c = lane >> 4, k = lane & 7, uvmode = row[UVMODE];
    uint8_t* ws = b.uv[c];
    int dc = 0;
    if (uvmode == DC_PRED) {
      int s = lane & 8 ? (mx ? ws[16 * (1 + k) + 7] : 0) : (my ? ws[8 + k] : 0);
      s += __shfl_xor_sync(kFull, s, 8);
      s += __shfl_xor_sync(kFull, s, 4);
      s += __shfl_xor_sync(kFull, s, 2);
      s += __shfl_xor_sync(kFull, s, 1);
      dc = mx && my ? (s + 8) >> 4 : mx || my ? (s + 4) >> 3 : 128;
    }
    const int yr = (lane >> 1) & 7, xh = (lane & 1) * 4;
    const int tl = ws[7], lp = ws[16 * (1 + yr) + 7];
    const uint32_t above = *reinterpret_cast<const uint32_t*>(&ws[8 + xh]);
    const short4 r = *reinterpret_cast<const short4*>(&b.resid[16 + 4 * c + 2 * (yr >> 2) + (xh >> 2)][4 * (yr & 3)]);
    const int rs[4] = {r.x, r.y, r.z, r.w};
    uint32_t out = 0;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int tp_x = (above >> (8 * x)) & 255;
      const int pred = uvmode == DC_PRED ? dc : uvmode == TM_PRED ? clip8(lp + tp_x - tl)
                     : uvmode == V_PRED ? tp_x : lp;
      out |= (uint32_t)clip8(pred + rs[x]) << (8 * x);
    }
    *reinterpret_cast<uint32_t*>(&ws[16 * (1 + yr) + 8 + xh]) = out;
  }
  if (!i4) {  // 16x16: the prediction and the residuals, 8 pixels a lane
    const int mode = row[MODES];
    int dc = 0;
    if (mode == DC_PRED) {
      const int s = __reduce_add_sync(kFull, lane < 16 ? (my ? b.y[16 + lane] : 0)
                                                       : (mx ? b.y[48 * (lane - 15) + 15] : 0));
      dc = mx && my ? (s + 16) >> 5 : mx || my ? (s + 8) >> 4 : 128;
    }
    const int yr = lane >> 1, xh = (lane & 1) * 8;
    const int tl = b.y[15], lp = b.y[48 * (1 + yr) + 15];
    const uint2 above = *reinterpret_cast<const uint2*>(&b.y[16 + xh]);
    const int blk = 4 * (yr >> 2) + (xh >> 2);
    const short4 r0 = *reinterpret_cast<const short4*>(&b.resid[blk][4 * (yr & 3)]);
    const short4 r1 = *reinterpret_cast<const short4*>(&b.resid[blk + 1][4 * (yr & 3)]);
    const int rs[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    uint2 out = make_uint2(0, 0);
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int tp_x = ((x < 4 ? above.x : above.y) >> (8 * (x & 3))) & 255;
      const int pred = mode == DC_PRED ? dc : mode == TM_PRED ? clip8(lp + tp_x - tl)
                     : mode == V_PRED ? tp_x : lp;
      const uint32_t v = (uint32_t)clip8(pred + rs[x]) << (8 * (x & 3));
      if (x < 4)
        out.x |= v;
      else
        out.y |= v;
    }
    *reinterpret_cast<uint2*>(&b.y[48 * (1 + yr) + 16 + xh]) = out;
  } else {  // B_PRED: step s takes the sub-blocks with bx + 2 by = s, a half-warp each
    const int bm = lane < 16 ? row[MODES + lane] : 0;
    const int half = lane >> 4, pix = lane & 15, px = pix & 3, py = pix >> 2;
    uint32_t code[10];  // this lane's pixel's prediction at each step
#pragma unroll
    for (int s = 0; s < 10; ++s) {
      const int by = max(0, (s - 2) >> 1) + half, bx = s - 2 * by;
      const bool on = by <= min(3, s >> 1) && bx >= 0 && bx <= 3;
      const int mode = __shfl_sync(kFull, bm, on ? 4 * by + bx : 0);
      code[s] = on ? sh.pred4[mode * 16 + pix] : ~0u;
    }
#pragma unroll
    for (int s = 0; s < 10; ++s) {
      const int by = max(0, (s - 2) >> 1) + half, bx = s - 2 * by;
      if (code[s] != ~0u) {
        const uint8_t* corner = b.y + 48 * 4 * by + 15 + 4 * bx;
        const int e0 = corner[code[s] & 255], e1 = corner[(code[s] >> 8) & 255];
        const int e2 = corner[(code[s] >> 16) & 255], kind = code[s] >> 24;
        int pred = kind == 0 ? (e0 + e1 + 1) >> 1 : kind == 1 ? (e0 + 2 * e1 + e2 + 2) >> 2
                                                              : clip8(e0 + e1 - e2);
        if (kind == 3)
          pred = (corner[1] + corner[2] + corner[3] + corner[4] + corner[48] + corner[96] +
                  corner[144] + corner[192] + 4) >> 3;
        b.y[48 * (4 * by + 1 + py) + 16 + 4 * bx + px] =
            (uint8_t)clip8(pred + b.resid[4 * by + bx][pix]);
      }
      __syncwarp();
    }
  }
  __syncwarp();
  // the pixels to the frame, once; the edges for the neighbours
  const int ys = 16 * mb_w, uvs = 8 * mb_w;
  if (lane < 16) {
    *reinterpret_cast<uint4*>(&Y[(size_t)(16 * my + lane) * ys + 16 * mx]) =
        *reinterpret_cast<const uint4*>(&b.y[48 * (1 + lane) + 16]);
  } else {
    const int c = (lane >> 3) & 1, k = lane & 7;
    *reinterpret_cast<uint2*>(&(c ? V : U)[(size_t)(8 * my + k) * uvs + 8 * mx]) =
        *reinterpret_cast<const uint2*>(&b.uv[c][16 * (1 + k) + 8]);
  }
  TopEdge& tw = sh.below[mx];
  if (lane == 0) {
    *reinterpret_cast<uint4*>(tw.y) = *reinterpret_cast<const uint4*>(&b.y[48 * 16 + 16]);
  } else if (lane < 3) {
    const int c = lane - 1;
    *reinterpret_cast<uint2*>(c ? tw.v : tw.u) = *reinterpret_cast<const uint2*>(&b.uv[c][16 * 8 + 8]);
  } else if (lane == 3) {  // the corner of the next macroblock of the row
    lf.cy = b.y[31];
    lf.cu = b.uv[0][15];
    lf.cv = b.uv[1][15];
  } else if (lane >= 16) {
    const int k = lane - 16, c = k >> 3, kk = k & 7;
    lf.y[k] = b.y[48 * (1 + k) + 31];
    (c ? lf.v : lf.u)[kk] = b.uv[c][16 * (1 + kk) + 15];
  }
}

// ---- the loop filter (dsp/dec.c) on a line of pixels in registers: the
// edge between v[P - 1] and v[P] ----

__device__ __forceinline__ int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
__device__ __forceinline__ int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

template <int P, bool kMbEdge>
__device__ __forceinline__ void filter_at(int (&v)[20], bool simple, int thresh, int ithresh,
                                          int hev_t) {
  const int p3 = v[P - 4], p2 = v[P - 3], p1 = v[P - 2], p0 = v[P - 1];
  const int q0 = v[P], q1 = v[P + 1], q2 = v[P + 2], q3 = v[P + 3];
  if (4 * abs(p0 - q0) + abs(p1 - q1) > 2 * thresh + 1) return;
  const bool weak = simple || abs(p1 - p0) > hev_t || abs(q1 - q0) > hev_t;
  if (!simple && (abs(p3 - p2) > ithresh || abs(p2 - p1) > ithresh || abs(p1 - p0) > ithresh ||
                  abs(q3 - q2) > ithresh || abs(q2 - q1) > ithresh || abs(q1 - q0) > ithresh))
    return;
  if (weak) {  // filter2: the simple filter, or high edge variance
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    v[P - 1] = clip8(p0 + sclip2((a + 3) >> 3));
    v[P] = clip8(q0 - sclip2((a + 4) >> 3));
  } else if (kMbEdge) {  // filter6
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
    v[P - 3] = clip8(p2 + a3);
    v[P - 2] = clip8(p1 + a2);
    v[P - 1] = clip8(p0 + a1);
    v[P] = clip8(q0 - a1);
    v[P + 1] = clip8(q1 - a2);
    v[P + 2] = clip8(q2 - a3);
  } else {  // filter4
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
    v[P - 2] = clip8(p1 + a3);
    v[P - 1] = clip8(p0 + a2);
    v[P] = clip8(q0 - a1);
    v[P + 1] = clip8(q1 - a3);
  }
}

// The edges of one line: the macroblock's (at 4, where there is a
// neighbour) and the inner ones (8, and 12 and 16 in luma).
__device__ __forceinline__ void filter_line(int (&v)[20], bool mb_edge, bool inner, bool luma,
                                            bool simple, int limit, int il, int hv) {
  if (mb_edge) filter_at<4, true>(v, simple, limit + 4, il, hv);
  if (inner) {
    filter_at<8, false>(v, simple, limit, il, hv);
    if (luma) {
      filter_at<12, false>(v, simple, limit, il, hv);
      filter_at<16, false>(v, simple, limit, il, hv);
    }
  }
}

// One macroblock's loop filter by a warp, in libwebp's order: lanes 0-15
// a luma row (then column) each, 16-23 U, 24-31 V (the simple filter
// leaves chroma alone).  Each lane runs its line's edges in registers;
// the vertical edges' rows reach the horizontal edges' columns through the
// tile, and each pixel the filter may change goes back to the frame once.
__device__ void filter_mb(WarpBuf& b, const uint8_t* row, int mx, int my, int mb_w, bool simple,
                          uint8_t* Y, uint8_t* U, uint8_t* V, int lane) {
  const bool luma = lane < 16;
  const int c = (lane >> 3) & 1, k = luma ? lane : lane & 7;
  const bool on = luma || !simple;
  const int size = luma ? 16 : 8, ts = luma ? 20 : 12;
  const int stride = size * mb_w, y0 = size * my, x0 = size * mx;
  uint8_t* plane = luma ? Y : c ? V : U;
  uint8_t* tile = luma ? b.tile.y : b.tile.uv[c];
  // the pixels first (other SMs wrote them: from L2), then the parameters
  const int rr = luma ? lane >> 2 : k >> 1, ww = luma ? lane & 3 : k & 1;
  uint8_t* src = plane + (size_t)(y0 + k) * stride + x0 - 4;  // this lane's row, from 4 left
  uint32_t above = 0, words[5];
  if (on && my > 0)  // the 4 rows above, a word a lane
    above = __ldcg(reinterpret_cast<const unsigned*>(&plane[(size_t)(y0 - 4 + rr) * stride + x0 + 4 * ww]));
#pragma unroll
  for (int w = 0; w < 5; ++w)
    words[w] = on && (w > 0 || mx > 0) && (w < 3 || luma) ? __ldcg(reinterpret_cast<const unsigned*>(src + 4 * w)) : 0u;
  const int limit = row[LIMIT], il = row[ILEVEL], hv = row[HEV], inner = row[INNER];
  if (limit == 0) return;
  int v[20];
  if (on) {
    if (my > 0) *reinterpret_cast<uint32_t*>(&tile[rr * ts + 4 + 4 * ww]) = above;
#pragma unroll
    for (int w = 0; w < 5; ++w)
#pragma unroll
      for (int i = 0; i < 4; ++i) v[4 * w + i] = (words[w] >> (8 * i)) & 255;
    filter_line(v, mx > 0, inner, luma, simple, limit, il, hv);
#pragma unroll
    for (int w = 0; w < 5; ++w) {
      const uint32_t word = (uint32_t)v[4 * w] | (uint32_t)v[4 * w + 1] << 8 |
                            (uint32_t)v[4 * w + 2] << 16 | (uint32_t)v[4 * w + 3] << 24;
      if (w < 3 || luma) *reinterpret_cast<uint32_t*>(&tile[(4 + k) * ts + 4 * w]) = word;
      if (w == 0 && mx > 0) *reinterpret_cast<uint32_t*>(src) = word;  // left of the macroblock: done
    }
  }
  __syncwarp();
  if (on) {  // lane k's column, from 4 above the macroblock
#pragma unroll
    for (int r = 0; r < 20; ++r) v[r] = r < 12 || luma ? tile[r * ts + 4 + k] : 0;
    filter_line(v, my > 0, inner, luma, simple, limit, il, hv);
    uint8_t* dst = plane + (size_t)(y0 - 4) * stride + x0 + k;
#pragma unroll
    for (int r = 1; r < 20; ++r)
      if ((r < 12 || luma) && (r >= 4 || my > 0)) dst[(long long)r * stride] = (uint8_t)v[r];
  }
}

// The frame's pixels before colour conversion, in one launch: the
// macroblocks as a wavefront over the diagonals t = x + 2 y, a warp a
// macroblock, the rows dealt round the cluster's blocks.  Step t
// reconstructs diagonal t (from the saved unfiltered edges in shared
// memory: the frame in device memory is filtered behind it) and filters
// diagonal t - 1, whose pixels and those of its left and upper neighbours
// step t - 1 finished; a cluster barrier separates the steps.  libwebp's
// raster order is kept for every pixel two macroblocks' filters share,
// since their diagonals differ.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kBlockWarps * 32, 1)
reconstruct_filter_kernel(const uint8_t* __restrict__ info, const int16_t* __restrict__ levels,
                          const int32_t* __restrict__ quant, int mb_w, int mb_h, int filter_type,
                          uint8_t* Y, uint8_t* U, uint8_t* V) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  Shared sh;
  sh.bufs = reinterpret_cast<WarpBuf*>(smem);
  sh.quant = reinterpret_cast<int*>(sh.bufs + kBlockWarps);
  sh.pred4 = reinterpret_cast<uint32_t*>(sh.quant + 24);
  sh.top = reinterpret_cast<TopEdge*>(sh.pred4 + 160);
  sh.left = reinterpret_cast<LeftEdge*>(sh.top + mb_w);
  sh.below = cluster.map_shared_rank(sh.top, (unsigned)((rank + 1) % kCluster));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = (mb_h - rank + kCluster - 1) / kCluster;  // this block's
  for (int k = tid; k < 24; k += blockDim.x) sh.quant[k] = quant[k];
  for (int k = tid; k < 160; k += blockDim.x) sh.pred4[k] = pred4_code(k >> 4, k & 15);
  // above the frame 127, left of it 129 (the corner 127 in the first row)
  for (int k = tid; k < mb_w * 8; k += blockDim.x) reinterpret_cast<uint32_t*>(sh.top)[k] = 0x7f7f7f7fu;
  for (int k = tid; k < rows * 12; k += blockDim.x)
    reinterpret_cast<uint32_t*>(sh.left)[k] = k % 12 < 8 ? 0x81818181u
                                            : k % 12 == 8 ? (k < 12 && rank == 0 ? 0x7f7f7fu : 0x818181u)
                                                          : 0u;
  cluster.sync();
  WarpBuf& b = sh.bufs[warp];
  const int diags = mb_w + 2 * (mb_h - 1), steps = diags + (filter_type > 0);
  // this block's rows of diagonal t: first(t) and then every kCluster-th,
  // count(t) of them
  auto first = [&](int t) {
    const int r0 = max(0, (t - mb_w + 2) >> 1);
    return r0 + (rank - r0 % kCluster + kCluster) % kCluster;
  };
  auto count = [&](int t) {
    const int r0 = first(t), r1 = t < diags ? min(mb_h - 1, t >> 1) : -1;
    return r1 >= r0 ? (r1 - r0) / kCluster + 1 : 0;
  };
  // a warp's first macroblock of a step is staged a step ahead
  auto staged = [&](int t) -> long long {
    if (t >= diags || warp >= count(t)) return -1;
    const int my = first(t) + kCluster * warp;
    return (long long)my * mb_w + (t - 2 * my);
  };
  stage(b, 0, info, levels, staged(0), lane);
  for (int t = 0; t < steps; ++t) {
    stage(b, (t + 1) & 1, info, levels, staged(t + 1), lane);
    const int r0 = first(t), nr = count(t);
    const int f0 = first(t - 1), nf = filter_type > 0 && t >= 1 ? count(t - 1) : 0;
    for (int item = warp; item < nr + nf; item += kBlockWarps) {
      if (item < nr) {
        const int my = r0 + kCluster * item, mx = t - 2 * my, idx = my * mb_w + mx;
        const uint8_t* row = info + (size_t)idx * INFO;
        const int16_t* lv = levels + (size_t)idx * 400;
        if (item == warp) {  // staged
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
          __syncwarp();
          row = b.staged_info[t & 1];
          lv = b.staged_levels[t & 1];
        }
        reconstruct(b, sh, row, lv, mx, my, mb_w, Y, U, V, lane);
      } else {
        const int my = f0 + kCluster * (item - nr), mx = t - 1 - 2 * my;
        filter_mb(b, info + (size_t)(my * mb_w + mx) * INFO, mx, my, mb_w, filter_type == 1, Y, U,
                  V, lane);
      }
      __syncwarp();
    }
    cluster.sync();
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
// out BGR uint8 [height, width, 3].  Two launches on `stream`; returns the
// CUDA error of the launches (0 if none).
extern "C" int simvg_vp8_decode(const void* info, const void* levels, const void* quant, int mb_w,
                                int mb_h, int filter_type, int width, int height, void* y, void* u,
                                void* v, void* out, void* stream) {
  if (mb_w <= 0 || mb_h <= 0 || mb_w > 1024 || mb_h > 1024 || width <= 0 || height <= 0 ||
      width > 16 * mb_w || height > 16 * mb_h)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t *Y = static_cast<uint8_t*>(y), *U = static_cast<uint8_t*>(u), *V = static_cast<uint8_t*>(v);
  // the saved edges grow with the frame: 66 KB a block at 16,383 x 16,383
  const size_t smem = shared_bytes(mb_w, mb_h);
  cudaError_t err = cudaFuncSetAttribute(reconstruct_filter_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  reconstruct_filter_kernel<<<kCluster, kBlockWarps * 32, smem, s>>>(
      static_cast<const uint8_t*>(info), static_cast<const int16_t*>(levels),
      static_cast<const int32_t*>(quant), mb_w, mb_h, filter_type, Y, U, V);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long pixels = (long long)width * height;
  bgr_kernel<<<(unsigned)((pixels + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      Y, U, V, mb_w, width, height, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
