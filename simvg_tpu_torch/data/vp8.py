"""WebP lossy (VP8 key frames): the bitstream on the host, the pixels on
the card (``csrc/vp8.cu``), and a plain Python/numpy version of both for
the CPU.

The decoder is libwebp's (``src/dec/vp8_dec.c``, ``tree_dec.c``,
``quant_dec.c``, ``frame_dec.c``, ``dsp/dec.c``, ``dsp/upsampling.c``,
RFC 6386), which ``cv2.imdecode(..., IMREAD_COLOR)`` calls:

- ``parse(data)``, the host stage: the frame header; the boolean decoder
  over the first partition (segment map and its probabilities, filter
  level, sharpness and deltas, the token partitions, the quantisers, the
  coefficient probability updates, the skip probability, and each
  macroblock's segment, skip flag and intra modes: 16x16 or sixteen 4x4
  with their context-coded modes, and the chroma mode) and over the token
  partitions (each block's coefficient levels, context-coded by band and
  by the neighbours' non-zero flags).  It gives each macroblock's modes
  and loop-filter parameters and its 25 blocks of levels.
- ``reconstruct_reference(frame)``, the pixel stage: dequantisation, the
  inverse WHT of the 16x16 DC block and the inverse DCT of each 4x4
  block, intra prediction from the neighbours' unfiltered pixels (127
  above the first row, 129 left of the first column, the top-right four
  pixels of a 4x4-predicted macroblock from its upper right neighbour and
  copied down its right edge), then the simple or normal loop filter a
  macroblock at a time in raster order (left edge, inner vertical edges,
  top edge, inner horizontal edges), then ``to_bgr_reference``: libwebp's
  "fancy" upsampling of U and V (a 9-3-3-1 filter over the two nearest
  rows of chroma samples) and its 14-bit YUV -> BGR.  ``decode_cuda`` does
  this on the card; ``decode_host`` is the card route's host stage
  (``simvg_vp8_parse``, host C++ in the same library).

The constant tables (quantiser steps, default and update probabilities of
the coefficient tokens, the 4x4 intra mode probabilities) are libwebp's,
taken from the libwebp build inside OpenCV's cv2 5.0.0; the bit-exact
tests against cv2 confirm them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19,
    20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31,
    32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46,
    47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63,
    64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79,
    80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100,
    101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 122, 124, 126,
    128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157)
AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38,
    39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55,
    56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86,
    88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155,
    158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201,
    205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259,
    264, 269, 274, 279, 284)
COEFF_UPDATE_PROBA = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffb0f6ffffffffffffffffffdff1fcfffffffffffffffff9fdfdffffffffffff"
    "fffffff4fcffffffffffffffffeafefefffffffffffffffffdffffffffffffff"
    "fffffffff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffff"
    "fffffffffff8fefffffffffffffffffbfffeffffffffffffffffffffffffffff"
    "fffffffffffffdfefffffffffffffffffbfefefffffffffffffffffefffeffff"
    "fffffffffffffffefdfffefffffffffffffafffefffefffffffffffffeffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafa"
    "f1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffee"
    "fdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffffffff"
    "fffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffff"
    "fffffffffffffffffffffffffffdfefffffffffffffffffcffffffffffffffff"
    "fffffffffffffffffffffffffffffefefffffffffffffffffdffffffffffffff"
    "fffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffff"
    "fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffbafbfaffffffffffffffffeafbf4feff"
    "fffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeff"
    "fffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefe"
    "fffffffffffffffffffffffffffffffffffffffffefffffffffffffffffffefe"
    "fffffffffffffffffffefffffffffffffffffffffffffffffffffffffffffffe"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffff8ffffffffffffff"
    "fffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffff"
    "fffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff"
    "fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfeffff"
    "fffffffffffff5fbfefffffffffffffffffdfdfefffffffffffffffffffbfdff"
    "fffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcff"
    "fffffffffffffffff9fffefffffffffffffffffffffeffffffffffffffffffff"
    "fdfffffffffffffffffaffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff")
COEFF_PROBA0 = bytes.fromhex(
    "8080808080808080808080808080808080808080808080808080808080808080"
    "80fd88feffe4db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff80"
    "80800162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb"
    "80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece680"
    "808080800165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ff"
    "ffff80808001ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3"
    "ab80808080800198fcfff0ff8080808080b187f3ffeae180808080805081d3ff"
    "c2e080808080800101ff8080808080808080f601ff8080808080808080ff8080"
    "8080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f"
    "92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc780808051"
    "63b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080"
    "175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080"
    "802c82c9fdcdc0ffff8080800184effbdbd1ffa58080805e88e1fbdabeffff80"
    "80801664aef5baa1ffc780808001b6f9ffe8eb80808080807c8ff1ffe3ea8080"
    "808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ff"
    "ff8080802d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff80"
    "80808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af0de0f3c1"
    "b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fa"
    "d3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933db"
    "ffc4ba8080808080452ebeefc9daffe480808001bffbffff808080808080dfa5"
    "f9ffd5ff80808080808d7cf8ffff8080808080800110f8ffff808080808080be"
    "24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080"
    "f7c0ff8080808080808080f080ff80808080808080800186fcffff8080808080"
    "80d53efaffff808080808080375dff8080808080808080808080808080808080"
    "808080808080808080808080808080808080808080808080ca18d5ebbabfdca0"
    "f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff7"
    "9fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7"
    "f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9db"
    "f0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff800151e6fc"
    "cccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8"
    "ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179"
    "ecfdd4d6ffff8080808d54d5fcc9caffdb8080802a50a0f0a2b9ffcd80808001"
    "01ff8080808080808080f401ff8080808080808080ee01ff8080808080808080")
BMODES_PROBA = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabda"
    "bd110d98721a11a32cc3150aad791850c31a3e2c405590470a26abd590221aaa"
    "2e371388a021ce473f14087272d00c09e251280b60b6541d102486b759896265"
    "6aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b"
    "1a9249a631179d412669a033341f7380684f0c1bd9ff5711075744472c72330f"
    "ba172f290e6eb6b71511c2422d1966c5bd171216585893962a2e2dc4cd2b61b7"
    "75552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab3aa55a62"
    "40221674ce17222ba6496b36201a3301512b1f44196a1640ab24e17222131566"
    "84bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f"
    "70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b43"
    "2d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd33"
    "3211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba6"
    "5d499a282815748fd12227af2f0f10b722df312db72e1121b706620f20b7392e"
    "16188001361125412049731c801780cd2803097333c01206df572509733b4d40"
    "152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a"
    "8598740a2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b"
    "33581f2343665537ba553815176f3bcd2d25c03726467c49660122627d622a58"
    "685575af525f543559806471652d4b4f7b2f338051ab01391105476639352931"
    "26210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a55"
    "8065c41a39120a6666d522142b75140f24a38044011a663d472522351ff3c045"
    "3c472649771cde25442d8022012f0bf5ab3e1113469255373e46252b259a64a3"
    "55a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808"
    "118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f"
    "069e5628408794e02db780161a1183f09a0e01d12d10155b40de0701c5381527"
    "9b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab120b073f90ab0404"
    "f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b"
    "769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e"
    "9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc3"
    "80300418")
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
           (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# the 4x4 intra mode tree: leaves are -mode
YMODES_INTRA4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8,
                 -9)
DC_PRED, TM_PRED, V_PRED, H_PRED = 0, 1, 2, 3
# columns of Vp8Frame.info
I4X4, MODES, UVMODE, SEGMENT, LIMIT, ILEVEL, HEV, INNER = 0, 1, 17, 18, 19, \
    20, 21, 22
INFO_COLUMNS = 24


class Vp8Frame(NamedTuple):
    width: int
    height: int
    mb_w: int
    mb_h: int
    filter_type: int  # 0 none, 1 simple, 2 normal
    info: np.ndarray  # uint8 [mb_h * mb_w, INFO_COLUMNS]
    levels: np.ndarray  # int16 [mb_h * mb_w, 25, 16]: Y 0-15, U, V, Y2
    quant: np.ndarray  # int32 [4, 6]: y1 dc/ac, y2 dc/ac, uv dc/ac


class _BoolDecoder:
    """RFC 6386's boolean decoder, as libwebp runs it: reading past the
    partition gives zeros and sets ``eof`` once more bits are needed than
    it holds."""

    def __init__(self, data: bytes):
        self.buf = bytes(data) + b"\x00" * 8
        self.limit = 8 * len(data) - 8
        self.value = int.from_bytes(self.buf[:2], "big")
        self.pos = 2
        self.range = 255
        self.count = 0  # shifts since the last byte
        self.shifts = 0
        self.eof = False

    def bit(self, prob: int) -> int:
        if self.shifts > self.limit:
            self.eof = True
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            self.range -= split
            self.value -= big
            b = 1
        else:
            self.range = split
            b = 0
        if self.range < 128:
            shift = 8 - self.range.bit_length()
            self.range <<= shift
            self.shifts += shift
            count = self.count + shift
            if count >= 8:
                # the next byte enters at bit 8 - (count - 8) of the window
                count -= 8
                self.value = ((self.value << shift) |
                              (self.buf[self.pos] << count)) & 0xFFFF
                self.pos += 1
            else:
                self.value = (self.value << shift) & 0xFFFF
            self.count = count
        return b

    def value_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(0x80)
        return v

    def signed(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(0x80) else v

    def maybe(self, n: int, signed: bool = False) -> int:
        """A flag, then an n-bit (signed) value if it is set, else 0."""
        if not self.bit(0x80):
            return 0
        return self.signed(n) if signed else self.value_bits(n)


def _large_value(br: _BoolDecoder, p) -> int:
    if not br.bit(p[3]):
        if not br.bit(p[4]):
            return 2
        return 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        return 7 + 2 * br.bit(165) + br.bit(145)
    bit1 = br.bit(p[8])
    bit0 = br.bit(p[9 + bit1])
    cat = 2 * bit1 + bit0
    v = 0
    for prob in CAT3456[cat]:
        v = v + v + br.bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: _BoolDecoder, probs, ctx: int, first: int, out) -> int:
    """One block's levels into ``out`` (natural order); returns the index
    after the last non-zero one (``first`` when there is none)."""
    n = first
    p = probs[BANDS[n]][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = probs[BANDS[n]][0]
        if not br.bit(p[2]):
            v, nxt = 1, 1
        else:
            v, nxt = _large_value(br, p), 2
        out[ZIGZAG[n]] = -v if br.bit(0x80) else v
        n += 1
        p = probs[BANDS[n]][nxt]
    return 16


def _wht(dc):
    """libwebp's TransformWHT: the 16 DC values of the 4x4 blocks, int16."""
    tmp = [0] * 16
    for i in range(4):
        a0 = dc[i] + dc[12 + i]
        a1 = dc[4 + i] + dc[8 + i]
        a2 = dc[4 + i] - dc[8 + i]
        a3 = dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i] = a0 + a1, a0 - a1
        tmp[4 + i], tmp[12 + i] = a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0 = d + tmp[4 * i + 3]
        a1 = tmp[4 * i + 1] + tmp[4 * i + 2]
        a2 = tmp[4 * i + 1] - tmp[4 * i + 2]
        a3 = d - tmp[4 * i + 3]
        out[4 * i + 0] = (a0 + a1) >> 3
        out[4 * i + 1] = (a3 + a2) >> 3
        out[4 * i + 2] = (a0 - a1) >> 3
        out[4 * i + 3] = (a3 - a2) >> 3
    return [_i16(v) for v in out]


def _i16(v: int) -> int:
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _quant(br: _BoolDecoder, seg_on, absolute, seg_q):
    base = br.value_bits(7)
    dy1dc, dy2dc, dy2ac, duvdc, duvac = (br.maybe(4, True) for _ in range(5))
    q = np.zeros((4, 6), np.int32)
    for s in range(4):
        if seg_on:
            v = seg_q[s] + (0 if absolute else base)
        else:
            v = base
        clip = lambda x, m: min(max(x, 0), m)  # noqa: E731
        y2ac = (AC_TABLE[clip(v + dy2ac, 127)] * 101581) >> 16
        q[s] = (DC_TABLE[clip(v + dy1dc, 127)], AC_TABLE[clip(v, 127)],
                DC_TABLE[clip(v + dy2dc, 127)] * 2, max(y2ac, 8),
                DC_TABLE[clip(v + duvdc, 117)], AC_TABLE[clip(v + duvac, 127)])
    return q


def frame_header(data: bytes):
    """(width, height, first partition's length) of a VP8 key frame."""
    if len(data) < 10:
        raise ValueError("truncated VP8 frame")
    bits = data[0] | data[1] << 8 | data[2] << 16
    if bits & 1:
        raise ValueError("VP8 frame is not a key frame")
    if (bits >> 1) & 7 > 3:
        raise ValueError("VP8 frame has an unknown profile")
    if not (bits >> 4) & 1:
        raise ValueError("VP8 frame is not displayable")
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError("VP8 frame has a bad start code")
    w = (data[6] | data[7] << 8) & 0x3FFF
    h = (data[8] | data[9] << 8) & 0x3FFF
    if not w or not h:
        raise ValueError("VP8 frame of zero size")
    return w, h, bits >> 5


def parse(data: bytes) -> Vp8Frame:
    """The host stage: the headers, each macroblock's modes and filter
    parameters, and the coefficient levels."""
    w, h, part0 = frame_header(data)
    if 10 + part0 > len(data):
        raise ValueError("VP8 first partition past the end of the frame")
    br = _BoolDecoder(data[10:10 + part0])
    br.bit(0x80), br.bit(0x80)  # colour space, clamping type
    seg_on = br.bit(0x80)
    update_map, absolute = 0, 0
    seg_q, seg_lf, seg_p = [0] * 4, [0] * 4, [255] * 3
    if seg_on:
        update_map = br.bit(0x80)
        if br.bit(0x80):  # update the segments' data
            absolute = br.bit(0x80)
            seg_q = [br.maybe(7, True) for _ in range(4)]
            seg_lf = [br.maybe(6, True) for _ in range(4)]
        if update_map:
            seg_p = [br.value_bits(8) if br.bit(0x80) else 255
                     for _ in range(3)]
    simple = br.bit(0x80)
    level = br.value_bits(6)
    sharpness = br.value_bits(3)
    ref_lf, mode_lf = [0] * 4, [0] * 4
    use_lf_delta = br.bit(0x80)
    if use_lf_delta and br.bit(0x80):
        ref_lf = [br.maybe(6, True) for _ in range(4)]
        mode_lf = [br.maybe(6, True) for _ in range(4)]
    filter_type = 0 if level == 0 else 1 if simple else 2
    # the token partitions
    nparts = 1 << br.value_bits(2)
    rest = data[10 + part0:]
    if len(rest) < 3 * (nparts - 1):
        raise ValueError("VP8 partition sizes past the end of the frame")
    start, parts = 3 * (nparts - 1), []
    for p in range(nparts - 1):
        size = min(int.from_bytes(rest[3 * p:3 * p + 3], "little"),
                   len(rest) - start)
        parts.append(_BoolDecoder(rest[start:start + size]))
        start += size
    if start >= len(rest):
        raise ValueError("VP8 frame ends before its last partition")
    parts.append(_BoolDecoder(rest[start:]))
    quant = _quant(br, seg_on, absolute, seg_q)
    br.bit(0x80)  # refresh entropy probabilities: ignored in a key frame
    probs = [[[[0] * 11 for _ in range(3)] for _ in range(8)]
             for _ in range(4)]
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for k in range(11):
                    i = ((t * 8 + b) * 3 + c) * 11 + k
                    probs[t][b][c][k] = br.value_bits(8) \
                        if br.bit(COEFF_UPDATE_PROBA[i]) else COEFF_PROBA0[i]
    use_skip = br.bit(0x80)
    skip_p = br.value_bits(8) if use_skip else 0
    if br.eof:
        raise ValueError("VP8 frame header past the end of its partition")
    # the filter parameters of each segment, 16x16 and 4x4
    fparams = np.zeros((4, 2, 4), np.uint8)  # limit, ilevel, hev, inner
    for s in range(4):
        base = (seg_lf[s] + (0 if absolute else level)) if seg_on else level
        for i4 in range(2):
            lv = base
            if use_lf_delta:
                lv += ref_lf[0] + (mode_lf[0] if i4 else 0)
            lv = min(max(lv, 0), 63)
            if lv > 0:
                il = lv
                if sharpness > 0:
                    il >>= 2 if sharpness > 4 else 1
                    il = min(il, 9 - sharpness)
                il = max(il, 1)
                fparams[s, i4] = (2 * lv + il, il,
                                  2 if lv >= 40 else 1 if lv >= 15 else 0, i4)
            else:
                fparams[s, i4] = (0, 0, 0, i4)
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    info = np.zeros((mb_h * mb_w, INFO_COLUMNS), np.uint8)
    levels = np.zeros((mb_h * mb_w, 25, 16), np.int16)
    intra_t = [0] * (4 * mb_w)
    top_nz = [[0] * 9 for _ in range(mb_w)]  # Y 0-3, U 4-5, V 6-7, DC 8
    bmp = BMODES_PROBA
    for my in range(mb_h):
        intra_l = [0] * 4
        left_nz = [0] * 9
        tb = parts[my & (nparts - 1)]
        for mx in range(mb_w):
            row = info[my * mb_w + mx]
            seg = (br.bit(seg_p[1]) if not br.bit(seg_p[0])
                   else br.bit(seg_p[2]) + 2) if update_map else 0
            skip = br.bit(skip_p) if use_skip else 0
            i4 = not br.bit(145)
            if not i4:
                ymode = (TM_PRED if br.bit(128) else H_PRED) if br.bit(156) \
                    else (V_PRED if br.bit(163) else DC_PRED)
                row[MODES] = ymode
                intra_t[4 * mx:4 * mx + 4] = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                for y in range(4):
                    ym = intra_l[y]
                    for x in range(4):
                        prob = bmp[(intra_t[4 * mx + x] * 10 + ym) * 9:]
                        i = YMODES_INTRA4[br.bit(prob[0])]
                        while i > 0:
                            i = YMODES_INTRA4[2 * i + br.bit(prob[i])]
                        ym = -i
                        intra_t[4 * mx + x] = ym
                        row[MODES + 4 * y + x] = ym
                    intra_l[y] = ym
            row[UVMODE] = DC_PRED if not br.bit(142) else V_PRED \
                if not br.bit(114) else TM_PRED if br.bit(183) else H_PRED
            row[I4X4], row[SEGMENT] = i4, seg
            # the tokens
            lv = levels[my * mb_w + mx]
            tn, ln = top_nz[mx], left_nz
            if skip:
                for k in range(8):
                    tn[k] = ln[k] = 0
                if not i4:
                    tn[8] = ln[8] = 0
                coded = False
            else:
                q = quant[seg]
                coded = False
                blk = [0] * 16
                if not i4:
                    dc = [0] * 16
                    nz = _coeffs(tb, probs[1], tn[8] + ln[8], 0, dc)
                    tn[8] = ln[8] = int(nz > 0)
                    lv[24] = dc
                    first, ptype = 1, 0
                    wht = _wht([_i16(v * (q[2] if k == 0 else q[3]))
                                for k, v in enumerate(dc)])
                else:
                    first, ptype = 0, 3
                for y in range(4):
                    for x in range(4):
                        blk = [0] * 16
                        nz = _coeffs(tb, probs[ptype], tn[x] + ln[y], first,
                                     blk)
                        tn[x] = ln[y] = int(nz > first)
                        lv[4 * y + x] = blk
                        d0 = wht[4 * y + x] if not i4 else _i16(blk[0] * q[0])
                        coded |= nz > 1 or d0 != 0
                for ch in (0, 1):
                    for y in range(2):
                        for x in range(2):
                            blk = [0] * 16
                            nz = _coeffs(tb, probs[2],
                                         tn[4 + 2 * ch + x] +
                                         ln[4 + 2 * ch + y], 0, blk)
                            tn[4 + 2 * ch + x] = ln[4 + 2 * ch + y] = \
                                int(nz > 0)
                            lv[16 + 4 * ch + 2 * y + x] = blk
                            coded |= nz > 1 or _i16(blk[0] * q[4]) != 0
            fp = fparams[seg, int(i4)]
            row[LIMIT], row[ILEVEL], row[HEV] = fp[0], fp[1], fp[2]
            row[INNER] = int(i4 or coded)
            if tb.eof:
                raise ValueError("VP8 token partition ends early")
        if br.eof:
            raise ValueError("VP8 first partition ends early")
    return Vp8Frame(w, h, mb_w, mb_h, filter_type, info, levels, quant)


# ---- the plain version of the pixel stage ----------------------------------

def _idct_add(coef, dst):
    """libwebp's TransformOne: the 4x4 inverse DCT of int16 ``coef`` added
    to the uint8-valued [4, 4] ``dst`` (a list of rows), in place."""
    def mul1(a):
        return ((a * 20091) >> 16) + a

    def mul2(a):
        return (a * 35468) >> 16

    tmp = [0] * 16
    for i in range(4):
        a = coef[i] + coef[8 + i]
        b = coef[i] - coef[8 + i]
        c = mul2(coef[4 + i]) - mul1(coef[12 + i])
        d = mul1(coef[4 + i]) + mul2(coef[12 + i])
        tmp[4 * i:4 * i + 4] = (a + d, b + c, b - c, a - d)
    for i in range(4):
        dc = tmp[i] + 4
        a = dc + tmp[8 + i]
        b = dc - tmp[8 + i]
        c = mul2(tmp[4 + i]) - mul1(tmp[12 + i])
        d = mul1(tmp[4 + i]) + mul2(tmp[12 + i])
        row = dst[i]
        for x, v in enumerate((a + d, b + c, b - c, a - d)):
            row[x] = min(max(row[x] + (v >> 3), 0), 255)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode, top, left, tl):
    """A 4x4 block's prediction (rows of 4) from the 8 pixels above it
    (``top``: above and above-right), the 4 to its left and the corner."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left  # noqa: E741
    X = tl
    if mode == 0:  # DC
        v = (sum(top[:4]) + sum(left) + 4) >> 3
        return [[v] * 4 for _ in range(4)]
    if mode == 1:  # TM
        return [[min(max(left[y] + top[x] - X, 0), 255) for x in range(4)]
                for y in range(4)]
    if mode == 2:  # VE
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return [list(row) for _ in range(4)]
    if mode == 3:  # HE
        vals = (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L))
        return [[v] * 4 for v in vals]
    p = [[0] * 4 for _ in range(4)]

    def put(v, *cells):
        for x, y in cells:
            p[y][x] = v

    if mode == 4:  # RD
        put(_avg3(J, K, L), (0, 3))
        put(_avg3(I, J, K), (1, 3), (0, 2))
        put(_avg3(X, I, J), (2, 3), (1, 2), (0, 1))
        put(_avg3(A, X, I), (3, 3), (2, 2), (1, 1), (0, 0))
        put(_avg3(B, A, X), (3, 2), (2, 1), (1, 0))
        put(_avg3(C, B, A), (3, 1), (2, 0))
        put(_avg3(D, C, B), (3, 0))
    elif mode == 5:  # VR
        put(_avg2(X, A), (0, 0), (1, 2))
        put(_avg2(A, B), (1, 0), (2, 2))
        put(_avg2(B, C), (2, 0), (3, 2))
        put(_avg2(C, D), (3, 0))
        put(_avg3(K, J, I), (0, 3))
        put(_avg3(J, I, X), (0, 2))
        put(_avg3(I, X, A), (0, 1), (1, 3))
        put(_avg3(X, A, B), (1, 1), (2, 3))
        put(_avg3(A, B, C), (2, 1), (3, 3))
        put(_avg3(B, C, D), (3, 1))
    elif mode == 6:  # LD
        put(_avg3(A, B, C), (0, 0))
        put(_avg3(B, C, D), (1, 0), (0, 1))
        put(_avg3(C, D, E), (2, 0), (1, 1), (0, 2))
        put(_avg3(D, E, F), (3, 0), (2, 1), (1, 2), (0, 3))
        put(_avg3(E, F, G), (3, 1), (2, 2), (1, 3))
        put(_avg3(F, G, H), (3, 2), (2, 3))
        put(_avg3(G, H, H), (3, 3))
    elif mode == 7:  # VL
        put(_avg2(A, B), (0, 0))
        put(_avg2(B, C), (1, 0), (0, 2))
        put(_avg2(C, D), (2, 0), (1, 2))
        put(_avg2(D, E), (3, 0), (2, 2))
        put(_avg3(A, B, C), (0, 1))
        put(_avg3(B, C, D), (1, 1), (0, 3))
        put(_avg3(C, D, E), (2, 1), (1, 3))
        put(_avg3(D, E, F), (3, 1), (2, 3))
        put(_avg3(E, F, G), (3, 2))
        put(_avg3(F, G, H), (3, 3))
    elif mode == 8:  # HD
        put(_avg2(I, X), (0, 0), (2, 1))
        put(_avg2(J, I), (0, 1), (2, 2))
        put(_avg2(K, J), (0, 2), (2, 3))
        put(_avg2(L, K), (0, 3))
        put(_avg3(A, B, C), (3, 0))
        put(_avg3(X, A, B), (2, 0))
        put(_avg3(I, X, A), (1, 0), (3, 1))
        put(_avg3(J, I, X), (1, 1), (3, 2))
        put(_avg3(K, J, I), (1, 2), (3, 3))
        put(_avg3(L, K, J), (1, 3))
    else:  # HU
        put(_avg2(I, J), (0, 0))
        put(_avg2(J, K), (2, 0), (0, 1))
        put(_avg2(K, L), (2, 1), (0, 2))
        put(_avg3(I, J, K), (1, 0))
        put(_avg3(J, K, L), (3, 0), (1, 1))
        put(_avg3(K, L, L), (3, 1), (1, 2))
        put(L, (3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
    return p


def _pred_block(mode, size, top, left, tl, mb_x, mb_y):
    """A 16x16 luma or 8x8 chroma prediction (DC, TM, V or H; DC without
    the missing edges as libwebp's CheckMode picks it)."""
    if mode == DC_PRED:
        shift = size.bit_length() - 1
        if mb_x and mb_y:
            v = (sum(top) + sum(left) + size) >> (shift + 1)
        elif mb_y:
            v = (sum(top) + (size >> 1)) >> shift
        elif mb_x:
            v = (sum(left) + (size >> 1)) >> shift
        else:
            v = 128
        return np.full((size, size), v, np.int64)
    if mode == TM_PRED:
        return np.clip(np.add.outer(np.asarray(left), np.asarray(top)) - tl,
                       0, 255)
    if mode == V_PRED:
        return np.tile(np.asarray(top, np.int64), (size, 1))
    return np.tile(np.asarray(left, np.int64)[:, None], (1, size))


def _dequant(fr: Vp8Frame, idx: int):
    """The macroblock's 24 blocks of int16 coefficients (Y 0-15, U, V):
    levels times their steps, the i16 luma DCs from the inverse WHT."""
    q = fr.quant[fr.info[idx, SEGMENT]]
    lv = fr.levels[idx].astype(np.int64)
    co = np.zeros((24, 16), np.int64)
    co[:16, 0] = lv[:16, 0] * q[0]
    co[:16, 1:] = lv[:16, 1:] * q[1]
    co[16:, 0] = lv[16:24, 0] * q[4]
    co[16:, 1:] = lv[16:24, 1:] * q[5]
    co = ((co + 0x8000) & 0xFFFF) - 0x8000
    if not fr.info[idx, I4X4]:
        y2 = lv[24] * np.where(np.arange(16) == 0, q[2], q[3])
        co[:16, 0] = _wht([_i16(int(v)) for v in y2])
    return co.tolist()


def _edges(plane, mb_x, mb_y, size, mb_w, right):
    """libwebp's work buffer around a macroblock: row 0 the pixels above
    (from column -1 to ``size + right - 1``), column 0 the pixels to the
    left; 127 above the frame, 129 left of it."""
    ws = np.zeros((size + 1, size + 1 + right), np.int64)
    y0, x0 = size * mb_y, size * mb_x
    if mb_y == 0:
        ws[0, :] = 127
    else:
        ws[0, 0] = 129 if mb_x == 0 else plane[y0 - 1, x0 - 1]
        ws[0, 1:size + 1] = plane[y0 - 1, x0:x0 + size]
        if right:
            ws[0, size + 1:] = plane[y0 - 1, x0 + size - 1] \
                if mb_x == mb_w - 1 else plane[y0 - 1, x0 + size:x0 + size + 4]
    ws[1:, 0] = 129 if mb_x == 0 else plane[y0:y0 + size, x0 - 1]
    return ws


def reconstruct_unfiltered(fr: Vp8Frame):
    """Y [16 mb_h, 16 mb_w] and U, V [8 mb_h, 8 mb_w] uint8, predicted and
    with their residuals, before the loop filter."""
    Y = np.zeros((16 * fr.mb_h, 16 * fr.mb_w), np.uint8)
    U = np.zeros((8 * fr.mb_h, 8 * fr.mb_w), np.uint8)
    V = np.zeros_like(U)
    for my in range(fr.mb_h):
        for mx in range(fr.mb_w):
            idx = my * fr.mb_w + mx
            row = fr.info[idx]
            co = _dequant(fr, idx)
            ws = _edges(Y, mx, my, 16, fr.mb_w, 4)
            if row[I4X4]:
                for r in (4, 8, 12):  # the top-right copied down
                    ws[r, 17:21] = ws[0, 17:21]
                ws = ws.tolist()
                for n in range(16):
                    by, bx = n >> 2, n & 3
                    top = ws[4 * by][4 * bx + 1:4 * bx + 9]
                    left = [ws[4 * by + 1 + k][4 * bx] for k in range(4)]
                    p = _pred4(int(row[MODES + n]), top, left,
                               ws[4 * by][4 * bx])
                    _idct_add(co[n], p)
                    for k in range(4):
                        ws[4 * by + 1 + k][4 * bx + 1:4 * bx + 5] = p[k]
                blk = np.asarray(ws, np.int64)[1:17, 1:17]
            else:
                blk = _pred_block(int(row[MODES]), 16, ws[0, 1:17],
                                  ws[1:17, 0], ws[0, 0], mx, my)
                blk = blk.tolist()
                for n in range(16):
                    by, bx = n >> 2, n & 3
                    sub = [r[4 * bx:4 * bx + 4] for r in
                           blk[4 * by:4 * by + 4]]
                    _idct_add(co[n], sub)
                    for k in range(4):
                        blk[4 * by + k][4 * bx:4 * bx + 4] = sub[k]
            Y[16 * my:16 * my + 16, 16 * mx:16 * mx + 16] = blk
            for ch, plane in ((0, U), (1, V)):
                ws = _edges(plane, mx, my, 8, fr.mb_w, 0)
                blk = _pred_block(int(row[UVMODE]), 8, ws[0, 1:9], ws[1:9, 0],
                                  ws[0, 0], mx, my).tolist()
                for n in range(4):
                    by, bx = n >> 1, n & 1
                    sub = [r[4 * bx:4 * bx + 4] for r in
                           blk[4 * by:4 * by + 4]]
                    _idct_add(co[16 + 4 * ch + n], sub)
                    for k in range(4):
                        blk[4 * by + k][4 * bx:4 * bx + 4] = sub[k]
                plane[8 * my:8 * my + 8, 8 * mx:8 * mx + 8] = blk
    return Y, U, V


# the loop filters, on int64 numpy rows of pixels across an edge: ``p`` is
# [n, 8] (p3 p2 p1 p0 q0 q1 q2 q3), each row one position along the edge

def _sclip1(v):
    return np.clip(v, -128, 127)


def _sclip2(v):
    return np.clip(v, -16, 15)


def _clip255(v):
    return np.clip(v, 0, 255)


def _filter2(p, mask):
    p1, p0, q0, q1 = p[:, 2], p[:, 3], p[:, 4], p[:, 5]
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    p[:, 3] = np.where(mask, _clip255(p0 + a2), p0)
    p[:, 4] = np.where(mask, _clip255(q0 - a1), q0)


def _filter4(p, mask):
    p1, p0, q0, q1 = p[:, 2].copy(), p[:, 3].copy(), p[:, 4].copy(), \
        p[:, 5].copy()
    a = 3 * (q0 - p0)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    a3 = (a1 + 1) >> 1
    for k, v in ((2, p1 + a3), (3, p0 + a2), (4, q0 - a1), (5, q1 - a3)):
        p[:, k] = np.where(mask, _clip255(v), p[:, k])


def _filter6(p, mask):
    p2, p1, p0, q0, q1, q2 = (p[:, k].copy() for k in range(1, 7))
    a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
    a1 = (27 * a + 63) >> 7
    a2 = (18 * a + 63) >> 7
    a3 = (9 * a + 63) >> 7
    for k, v in ((1, p2 + a3), (2, p1 + a2), (3, p0 + a1), (4, q0 - a1),
                 (5, q1 - a2), (6, q2 - a3)):
        p[:, k] = np.where(mask, _clip255(v), p[:, k])


def _needs(p, t):
    return 4 * np.abs(p[:, 3] - p[:, 4]) + np.abs(p[:, 2] - p[:, 5]) <= t


def _needs2(p, t, it):
    d = np.abs(np.diff(p, axis=1))  # |p3-p2| ... |q2-q3|
    inner = (d[:, [0, 1, 2, 4, 5, 6]] <= it).all(1)
    return _needs(p, t) & inner


def _hev(p, thresh):
    return (np.abs(p[:, 2] - p[:, 3]) > thresh) | \
        (np.abs(p[:, 5] - p[:, 4]) > thresh)


def _edge(plane, at, span, vertical, simple, thresh, ithresh, hev_t,
          mb_edge):
    """Filters one edge in place: a vertical edge left of column ``at``
    over the rows ``span``, else a horizontal edge above row ``at`` over
    the columns ``span``."""
    if vertical:
        p = plane[span, at - 4:at + 4].astype(np.int64)
    else:
        p = plane[at - 4:at + 4, span].astype(np.int64).T.copy()
    t2 = 2 * thresh + 1
    if simple:
        _filter2(p, _needs(p, t2))
    else:
        m = _needs2(p, t2, ithresh)
        hev = _hev(p, hev_t)
        q = p.copy()
        _filter2(q, m & hev)
        (_filter6 if mb_edge else _filter4)(p, m & ~hev)
        p = np.where((m & hev)[:, None], q, p)
    if vertical:
        plane[span, at - 4:at + 4] = p
    else:
        plane[at - 4:at + 4, span] = p.T


def loop_filter(fr: Vp8Frame, Y, U, V):
    """The loop filter over the whole frame, a macroblock at a time in
    raster order, in place."""
    if fr.filter_type == 0:
        return
    simple = fr.filter_type == 1
    for my in range(fr.mb_h):
        for mx in range(fr.mb_w):
            row = fr.info[my * fr.mb_w + mx]
            limit, il, hev, inner = (int(row[k]) for k in (LIMIT, ILEVEL, HEV,
                                                           INNER))
            if limit == 0:
                continue
            planes = [(Y, 16)] + ([] if simple else [(U, 8), (V, 8)])
            for vertical in (True, False):
                for plane, size in planes:
                    y0, x0 = size * my, size * mx
                    at = x0 if vertical else y0
                    span = slice(y0, y0 + size) if vertical \
                        else slice(x0, x0 + size)
                    if (mx if vertical else my) > 0:
                        _edge(plane, at, span, vertical, simple, limit + 4,
                              il, hev, True)
                    if inner:
                        for k in range(4, size, 4):
                            _edge(plane, at + k, span, vertical, simple,
                                  limit, il, hev, False)


def to_bgr_reference(Y, U, V, w, h) -> np.ndarray:
    """libwebp's fancy upsampling and YUV -> BGR of the cropped planes."""
    y = Y[:h, :w].astype(np.int64)
    uvw, uvh = (w + 1) >> 1, (h + 1) >> 1
    ys = np.arange(h)
    k = (ys + 1) >> 1
    near = np.where(ys == 0, 0, np.where(ys & 1, k - 1, k))
    far = np.where(ys == 0, 0, np.where(ys & 1, np.minimum(k, uvh - 1),
                                        k - 1))
    xs = np.arange(w)
    j = (xs + 1) >> 1
    ncol = np.where(xs & 1, j - 1, j)
    ocol = np.where(xs & 1, j, j - 1)
    four = (xs > 0) & (ocol < uvw) & (ocol >= 0)
    ocol = np.clip(ocol, 0, uvw - 1)
    chans = []
    for plane in (U, V):
        c = plane[:uvh, :uvw].astype(np.int64)
        N = c[near[:, None], ncol[None, :]]
        H = c[near[:, None], ocol[None, :]]
        Vv = c[far[:, None], ncol[None, :]]
        D = c[far[:, None], ocol[None, :]]
        tap4 = ((((N + H + Vv + D + 8) + 2 * (H + Vv)) >> 3) + N) >> 1
        tap2 = (3 * N + Vv + 2) >> 2
        chans.append(np.where(four[None, :], tap4, tap2))
    u, v = chans

    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6, np.where(x < 0, 0, 255))

    yy = (y * 19077) >> 8
    b = clip8(yy + ((u * 33050) >> 8) - 17685)
    g = clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    r = clip8(yy + ((v * 26149) >> 8) - 14234)
    return np.stack([b, g, r], -1).astype(np.uint8)


def reconstruct_reference(fr: Vp8Frame) -> np.ndarray:
    """What the kernels compute, in numpy: BGR uint8 [h, w, 3]."""
    Y, U, V = reconstruct_unfiltered(fr)
    loop_filter(fr, Y, U, V)
    return to_bgr_reference(Y, U, V, fr.width, fr.height)


# ---- the card ---------------------------------------------------------------

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a library built from ``csrc/vp8.cu``."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.simvg_vp8_parse.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.simvg_vp8_parse.restype = vp
    lib.simvg_vp8_info.argtypes = [vp, ctypes.POINTER(i)]
    lib.simvg_vp8_info.restype = i
    lib.simvg_vp8_copy.argtypes = [vp, i, vp]
    lib.simvg_vp8_copy.restype = ctypes.c_longlong
    lib.simvg_vp8_error.argtypes = [vp]
    lib.simvg_vp8_error.restype = ctypes.c_char_p
    lib.simvg_vp8_free.argtypes = [vp]
    lib.simvg_vp8_decode.argtypes = [vp, vp, vp, i, i, i, i, i, vp, vp,
                                     vp, vp, vp]
    lib.simvg_vp8_decode.restype = i
    return lib


def _library():
    global _lib
    if _lib is None:
        from simvg_tpu_torch.ops import _build

        _lib = bind(_build.load("vp8"))
    return _lib


def decode_host(data: bytes) -> Vp8Frame:
    """``parse``'s result from the card route's host C++
    (``simvg_vp8_parse``)."""
    lib = _library()
    handle = lib.simvg_vp8_parse(data, len(data))
    try:
        meta = (ctypes.c_int * 5)()
        if lib.simvg_vp8_info(handle, meta) != 0:
            raise ValueError(lib.simvg_vp8_error(handle).decode())
        w, h, mb_w, mb_h, ft = list(meta)
        n = mb_w * mb_h
        info = np.empty((n, INFO_COLUMNS), np.uint8)
        levels = np.empty((n, 25, 16), np.int16)
        quant = np.empty((4, 6), np.int32)
        for k, a in enumerate((info, levels, quant)):
            lib.simvg_vp8_copy(handle, k, a.ctypes.data)
        return Vp8Frame(w, h, mb_w, mb_h, ft, info, levels, quant)
    finally:
        lib.simvg_vp8_free(handle)


def decode_cuda(fr: Vp8Frame, device) -> torch.Tensor:
    """The kernels' BGR uint8 [h, w, 3] image of a parsed frame on a CUDA
    device, on the current stream: reconstruction and the loop filter in
    one launch (a wavefront over the macroblocks, the filter a diagonal
    behind), then upsampling and colour conversion (a thread a pixel)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"decode_cuda needs a CUDA device, got {device}")
    lib = _library()
    info = torch.from_numpy(fr.info).to(device)
    levels = torch.from_numpy(fr.levels).to(device)
    quant = torch.from_numpy(fr.quant).to(device)
    y = torch.empty(16 * fr.mb_h, 16 * fr.mb_w, dtype=torch.uint8,
                    device=device)
    u = torch.empty(2, 8 * fr.mb_h, 8 * fr.mb_w, dtype=torch.uint8,
                    device=device)
    out = torch.empty(fr.height, fr.width, 3, dtype=torch.uint8,
                      device=device)
    with torch.cuda.device(device):
        rc = lib.simvg_vp8_decode(
            info.data_ptr(), levels.data_ptr(), quant.data_ptr(), fr.mb_w,
            fr.mb_h, fr.filter_type, fr.width, fr.height, y.data_ptr(),
            u[0].data_ptr(), u[1].data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"VP8 decode kernel launch failed: CUDA error {rc}")
    decode.launches += 1
    return out


def _route(device) -> torch.device:
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no VP8 decoder for device {device}")
    return device


def host_stage(data: bytes, device="cuda") -> Vp8Frame:
    """The parsed frame from ``device``'s route: the host C++ for a CUDA
    device, ``parse`` for the CPU."""
    return decode_host(data) if _route(device).type == "cuda" \
        else parse(data)


def pixel_stage(fr: Vp8Frame, device="cuda") -> torch.Tensor:
    """BGR uint8 [h, w, 3] of a parsed frame on ``device``: the kernels on
    a CUDA device, ``reconstruct_reference`` on the CPU."""
    if _route(device).type == "cuda":
        return decode_cuda(fr, device)
    return torch.from_numpy(reconstruct_reference(fr))


def decode(data: bytes, device="cuda") -> torch.Tensor:
    """BGR uint8 [h, w, 3] of a VP8 key frame (not oriented) on
    ``device``."""
    return pixel_stage(host_stage(data, device), device)


decode.launches = 0  # VP8 decode launches (CUDA route only)
