"""WebP lossless (VP8L): the prefix-coded stream on the host, the inverse
transforms on the card (``csrc/vp8l.cu``), and a plain Python/numpy
version of both for the CPU.

The format is libwebp's (``src/dec/vp8l_dec.c``, the WebP lossless
bitstream specification, RFC 9649), which ``cv2.imdecode`` calls:

- ``parse(data)``, the host stage: the header, then the transforms in
  stream order (predictor and cross-colour with their sub-resolution
  images, subtract-green, colour-indexing with its palette), the colour
  cache, the meta prefix codes (an entropy image of group indices), and
  the main image's ARGB pixels: literals, colour-cache hits and LZ77
  backward references (length and distance prefixes with extra bits, a
  distance code mapped through the 120-entry neighbourhood table).  Each
  sub-image is itself such an entropy-coded image.
- ``reconstruct_reference(stream)``, the pixel stage: the transforms
  undone in reverse order (predictor: 14 modes, left/top/top-right;
  cross-colour: the three signed multipliers of each tile; subtract-green;
  colour-indexing: bundled indices unpacked and looked up, an index past
  the palette transparent black) and ARGB -> BGR with alpha dropped, as
  ``IMREAD_COLOR`` drops it.  ``decode_cuda`` does this on the card;
  ``decode_host`` is the card route's host stage (``simvg_vp8l_parse``,
  host C++ in the same library).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

SIGNATURE = 0x2F
PREDICTOR, CROSS_COLOR, SUBTRACT_GREEN, COLOR_INDEXING = range(4)
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                      13, 14, 15)
_NUM_LITERAL, _NUM_LENGTH, _NUM_DISTANCE = 256, 24, 40
# libwebp's kCodeToPlane (vp8l_dec.c): distance codes 1-120 as
# (dy << 4) | (8 - dx), taken from the libwebp build inside OpenCV's cv2
# 5.0.0; the bit-exact tests against cv2 confirm it
CODE_TO_PLANE = bytes((
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a,
    0x26, 0x2a, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a,
    0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03,
    0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d, 0x44, 0x4c,
    0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b,
    0x32, 0x3e, 0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f,
    0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41,
    0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d, 0x51, 0x5f,
    0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70))


class Transform(NamedTuple):
    kind: int
    xsize: int  # width of the image the inverse transform produces
    bits: int  # tile bits (predictor, cross-colour) or bundling bits
    data: np.ndarray  # uint32: the sub-image, or the 256-entry palette


class Vp8lStream(NamedTuple):
    width: int
    height: int
    transforms: List[Transform]  # in stream order
    pixels: np.ndarray  # uint32 [height * packed width], entropy-decoded


class _Bits:
    """LSB-first bit reader; reading past the end gives zeros and marks
    the stream as exhausted (libwebp's eos)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data + b"\x00" * 8
        self.n = 8 * len(data)
        self.pos = pos

    def read(self, k: int) -> int:
        p = self.pos
        v = int.from_bytes(self.data[p >> 3:(p >> 3) + 4], "little")
        self.pos = p + k
        return (v >> (p & 7)) & ((1 << k) - 1)

    def peek(self, k: int) -> int:
        p = self.pos
        v = int.from_bytes(self.data[p >> 3:(p >> 3) + 4], "little")
        return (v >> (p & 7)) & ((1 << k) - 1)

    @property
    def eos(self):
        return self.pos > self.n


class _Code:
    """A canonical prefix code.  A table indexed by the next ``pbits``
    bits (LSB first) gives (symbol, length) of the codes that short; a
    longer code is looked up by (length, bits); one symbol costs no
    bits."""

    def __init__(self, lengths):
        lengths = np.asarray(lengths, np.int64)
        used = np.nonzero(lengths)[0]
        if len(used) == 0:
            raise ValueError("VP8L prefix code with no symbol")
        self.long = {}
        if len(used) == 1:
            self.bits = self.pbits = 0
            self.sym, self.len = [int(used[0])], [0]
            return
        maxlen = int(lengths.max())
        if sum(1 << (maxlen - int(lengths[s])) for s in used) != 1 << maxlen:
            raise ValueError("VP8L prefix code is not complete")
        self.bits, self.pbits = maxlen, min(maxlen, 10)
        sym = np.zeros(1 << self.pbits, np.int64)
        lens = np.zeros(1 << self.pbits, np.int64)
        code = 0
        for length in range(1, maxlen + 1):
            for s in used[lengths[used] == length]:
                rev = int(format(code, f"0{length}b")[::-1], 2)
                if length <= self.pbits:
                    sym[rev::1 << length] = s
                    lens[rev::1 << length] = length
                else:
                    self.long[length, rev] = int(s)
                code += 1
            code <<= 1
        self.sym, self.len = sym.tolist(), lens.tolist()

    def read(self, br: "_Bits") -> int:
        if not self.bits:
            return self.sym[0]
        i = br.peek(self.bits)
        j = i & ((1 << self.pbits) - 1)
        n = self.len[j]
        if n:
            br.pos += n
            return self.sym[j]
        for n in range(self.pbits + 1, self.bits + 1):
            s = self.long.get((n, i & ((1 << n) - 1)))
            if s is not None:
                br.pos += n
                return s
        raise ValueError("VP8L prefix code read failed")


def _read_code(br: _Bits, alphabet: int) -> _Code:
    lengths = [0] * alphabet
    if br.read(1):  # simple code: one or two symbols
        n = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        symbols = [first] + ([br.read(8)] if n == 2 else [])
        for s in symbols:
            if s >= alphabet:
                raise ValueError("VP8L simple code symbol past its alphabet")
            lengths[s] = 1
        return _Code(lengths)
    cl = [0] * 19
    for i in range(br.read(4) + 4):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    cl_code = _Code(cl)
    if br.read(1):
        nbits = 2 + 2 * br.read(3)
        max_symbol = 2 + br.read(nbits)
        if max_symbol > alphabet:
            raise ValueError("VP8L code length count past its alphabet")
    else:
        max_symbol = alphabet
    s, prev = 0, 8
    while s < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = cl_code.read(br)
        if c < 16:
            lengths[s] = c
            s += 1
            if c:
                prev = c
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
            rep = br.read(extra) + offset
            if s + rep > alphabet:
                raise ValueError("VP8L code length repeat past its alphabet")
            val = prev if c == 16 else 0
            lengths[s:s + rep] = [val] * rep
            s += rep
    if br.eos:
        raise ValueError("truncated VP8L stream")
    return _Code(lengths)


def _copy_distance(sym: int, br: _Bits) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _plane_to_distance(xsize: int, code: int) -> int:
    if code > 120:
        return code - 120
    d = CODE_TO_PLANE[code - 1]
    dist = (d >> 4) * xsize + 8 - (d & 15)
    return max(dist, 1)


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _image(br: _Bits, xsize: int, ysize: int, level0: bool) -> np.ndarray:
    """One entropy-coded image (the main one when ``level0``)."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError(f"VP8L colour cache of {cache_bits} bits")
    meta_bits, meta = 0, None
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        mw = _subsample(xsize, meta_bits)
        sub = _image(br, mw, _subsample(ysize, meta_bits), False)
        meta = ((sub >> 8) & 0xFFFF).astype(np.int64).reshape(-1, mw)
        groups = int(meta.max()) + 1
    else:
        groups = 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    alphabets = (_NUM_LITERAL + _NUM_LENGTH + cache_size, _NUM_LITERAL,
                 _NUM_LITERAL, _NUM_LITERAL, _NUM_DISTANCE)
    codes = [[_read_code(br, a) for a in alphabets] for _ in range(groups)]
    total = xsize * ysize
    out = [0] * total
    cache = [0] * cache_size
    shift = 32 - cache_bits
    cached = 0  # pixels [0, cached) are in the cache
    pos = 0
    group = codes[0]
    while pos < total:
        if meta is not None:  # the group of the current position
            group = codes[meta[(pos // xsize) >> meta_bits,
                               (pos % xsize) >> meta_bits]]
        g = group[0].read(br)
        if g < 256:
            r = group[1].read(br)
            b = group[2].read(br)
            a = group[3].read(br)
            out[pos] = (a << 24) | (r << 16) | (g << 8) | b
            pos += 1
        elif g < 256 + _NUM_LENGTH:
            length = _copy_distance(g - 256, br)
            dcode = _copy_distance(group[4].read(br), br)
            dist = _plane_to_distance(xsize, dcode)
            if dist > pos or pos + length > total:
                raise ValueError("VP8L backward reference out of the image")
            for k in range(length):
                out[pos + k] = out[pos + k - dist]
            pos += length
            if br.eos:
                raise ValueError("truncated VP8L stream")
        else:
            key = g - 256 - _NUM_LENGTH
            while cached < pos:
                p = out[cached]
                cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = p
                cached += 1
            out[pos] = cache[key]
            pos += 1
        if cache_size:
            while cached < pos:
                p = out[cached]
                cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = p
                cached += 1
    if br.eos:
        raise ValueError("truncated VP8L stream")
    return np.asarray(out, np.uint32)


def header(data: bytes) -> Tuple[int, int, bool]:
    """(width, height, alpha used) of a VP8L stream."""
    if len(data) < 5 or data[0] != SIGNATURE:
        raise ValueError("not a VP8L stream")
    v = int.from_bytes(data[1:5], "little")
    if v >> 29:
        raise ValueError(f"VP8L version {v >> 29}")
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, bool((v >> 28) & 1)


def parse(data: bytes) -> Vp8lStream:
    """The host stage: transforms and the entropy-decoded main image."""
    w, h, _ = header(data)
    br = _Bits(data, 40)
    xsize = w
    transforms, seen = [], set()
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise ValueError("VP8L transform used twice")
        seen.add(kind)
        if kind in (PREDICTOR, CROSS_COLOR):
            bits = br.read(3) + 2
            sub = _image(br, _subsample(xsize, bits), _subsample(h, bits),
                         False)
            transforms.append(Transform(kind, xsize, bits, sub))
        elif kind == COLOR_INDEXING:
            n = br.read(8) + 1
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            pal = _image(br, n, 1, False)
            b = pal.view(np.uint8).reshape(-1, 4).astype(np.uint64)
            b = np.cumsum(b, 0).astype(np.uint8)  # each entry adds the last
            full = np.zeros(256, np.uint32)
            full[:n] = np.ascontiguousarray(b).view(np.uint32).reshape(-1)
            transforms.append(Transform(kind, xsize, bits, full))
            xsize = _subsample(xsize, bits)
        else:
            transforms.append(Transform(kind, xsize, 0,
                                        np.zeros(0, np.uint32)))
    pixels = _image(br, xsize, h, True)
    return Vp8lStream(w, h, transforms, pixels)


# ---- the plain version of the pixel stage ----------------------------------

def _add(a: int, b: int) -> int:
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | \
        (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _avg(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _clip(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _select(t: int, l_: int, tl: int) -> int:
    s = 0
    for sh in (24, 16, 8, 0):
        c = (tl >> sh) & 0xFF
        s += abs(((l_ >> sh) & 0xFF) - c) - abs(((t >> sh) & 0xFF) - c)
    return t if s <= 0 else l_


def _clamp_full(a: int, b: int, c: int) -> int:
    v = 0
    for sh in (24, 16, 8, 0):
        v |= _clip(((a >> sh) & 0xFF) + ((b >> sh) & 0xFF)
                   - ((c >> sh) & 0xFF)) << sh
    return v


def _clamp_half(a: int, b: int) -> int:
    v = 0
    for sh in (24, 16, 8, 0):
        x, y = (a >> sh) & 0xFF, (b >> sh) & 0xFF
        d = x - y
        v |= _clip(x + (d // 2 if d >= 0 else -((-d) // 2))) << sh
    return v


def predict(mode: int, left: int, top: int, tl: int, tr: int) -> int:
    """The predictor transform's prediction of one pixel."""
    if mode == 1:
        return left
    if mode == 2:
        return top
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _avg(_avg(left, tr), top)
    if mode == 6:
        return _avg(left, tl)
    if mode == 7:
        return _avg(left, top)
    if mode == 8:
        return _avg(tl, top)
    if mode == 9:
        return _avg(top, tr)
    if mode == 10:
        return _avg(_avg(left, tl), _avg(top, tr))
    if mode == 11:
        return _select(top, left, tl)
    if mode == 12:
        return _clamp_full(left, top, tl)
    if mode == 13:
        return _clamp_half(_avg(left, top), tl)
    return 0xFF000000  # 0, and 14-15 as libwebp treats them


def _inverse(t: Transform, img: np.ndarray, h: int) -> np.ndarray:
    w = t.xsize
    if t.kind == SUBTRACT_GREEN:
        g = (img >> 8) & 0xFF
        rb = ((img & 0x00FF00FF) + (g << 16 | g)) & 0x00FF00FF
        return (img & 0xFF00FF00) | rb
    if t.kind == COLOR_INDEXING:
        pw = _subsample(w, t.bits)
        packed = img.reshape(h, pw)
        x = np.arange(w)
        per = 1 << t.bits
        bpp = 8 >> t.bits
        g = (packed[:, x >> t.bits] >> 8) & 0xFF
        idx = (g >> ((x & (per - 1)) * bpp)) & ((1 << bpp) - 1)
        return t.data[idx].reshape(-1)
    tw = _subsample(w, t.bits)
    tiles = t.data.reshape(-1, tw)
    ty = (np.arange(h) >> t.bits)[:, None]
    tx = (np.arange(w) >> t.bits)[None, :]
    code = tiles[ty, tx].astype(np.int64)
    if t.kind == CROSS_COLOR:
        s8 = lambda v: ((v & 0xFF) ^ 0x80) - 0x80  # noqa: E731
        g2r, g2b, r2b = s8(code), s8(code >> 8), s8(code >> 16)
        px = img.reshape(h, w).astype(np.int64)
        green = s8(px >> 8)
        red = ((px >> 16) + ((g2r * green) >> 5)) & 0xFF
        blue = px + ((g2b * green) >> 5) + ((r2b * s8(red)) >> 5)
        out = (px & 0xFF00FF00) | (red << 16) | (blue & 0xFF)
        return out.astype(np.uint32).reshape(-1)
    # predictor: sequential along each row (left) and down the rows
    modes = ((code >> 8) & 0xF).tolist()
    res = img.reshape(h, w).tolist()
    out = [[0] * w for _ in range(h)]
    for y in range(h):
        row, src, up = out[y], res[y], out[y - 1] if y else None
        for x in range(w):
            if y == 0:
                p = 0xFF000000 if x == 0 else row[x - 1]
            elif x == 0:
                p = up[0]
            else:
                # the rightmost column's top-right is this row's first pixel
                tr = up[x + 1] if x + 1 < w else row[0]
                p = predict(modes[y][x], row[x - 1], up[x], up[x - 1], tr)
            row[x] = _add(src[x], p)
    return np.asarray(out, np.uint32).reshape(-1)


def argb_reference(st: Vp8lStream) -> np.ndarray:
    """The image's ARGB uint32 [h, w] with every transform undone."""
    img = st.pixels
    for t in reversed(st.transforms):
        img = _inverse(t, img, st.height)
    return img.reshape(st.height, st.width)


def reconstruct_reference(st: Vp8lStream) -> np.ndarray:
    """What the kernels compute, in numpy: BGR uint8 [h, w, 3]."""
    return argb_reference(st).view(np.uint8).reshape(
        st.height, st.width, 4)[..., :3].copy()


# ---- the card ---------------------------------------------------------------

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a library built from ``csrc/vp8l.cu``."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.simvg_vp8l_parse.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.simvg_vp8l_parse.restype = vp
    lib.simvg_vp8l_info.argtypes = [vp, ctypes.POINTER(i)]
    lib.simvg_vp8l_info.restype = i
    lib.simvg_vp8l_copy.argtypes = [vp, i, vp]
    lib.simvg_vp8l_copy.restype = ctypes.c_longlong
    lib.simvg_vp8l_free.argtypes = [vp]
    lib.simvg_vp8l_error.argtypes = [vp]
    lib.simvg_vp8l_error.restype = ctypes.c_char_p
    lib.simvg_vp8l_transform.argtypes = [vp, vp, vp, i, i, i, i, vp]
    lib.simvg_vp8l_transform.restype = i
    lib.simvg_vp8l_to_bgr.argtypes = [vp, i, vp, vp]
    lib.simvg_vp8l_to_bgr.restype = i
    return lib


def _library():
    global _lib
    if _lib is None:
        from simvg_tpu_torch.ops import _build

        _lib = bind(_build.load("vp8l"))
    return _lib


def decode_host(data: bytes) -> Vp8lStream:
    """``parse``'s result from the card route's host C++
    (``simvg_vp8l_parse``)."""
    lib = _library()
    handle = lib.simvg_vp8l_parse(data, len(data))
    try:
        info = (ctypes.c_int * 64)()
        n = lib.simvg_vp8l_info(handle, info)
        if n < 0:
            raise ValueError(lib.simvg_vp8l_error(handle).decode())
        w, h = info[0], info[1]
        arrays = []
        for k in range(n + 1):
            size = lib.simvg_vp8l_copy(handle, k, None)
            a = np.empty(size, np.uint32)
            lib.simvg_vp8l_copy(handle, k, a.ctypes.data)
            arrays.append(a)
        transforms = [Transform(info[2 + 3 * k], info[3 + 3 * k],
                                info[4 + 3 * k], arrays[k])
                      for k in range(n)]
        return Vp8lStream(w, h, transforms, arrays[n])
    finally:
        lib.simvg_vp8l_free(handle)


def transform_cuda(t: Transform, img: torch.Tensor, height: int) -> torch.Tensor:
    """``_inverse(t, img, height)`` on the card, on the current stream: the
    ARGB image (contiguous int32 [n] on a CUDA device) with transform
    ``t`` undone, as a new int32 [t.xsize * height] tensor."""
    device = img.device
    if device.type != "cuda":
        raise ValueError(f"transform_cuda needs a CUDA tensor, got {device}")
    if img.dtype != torch.int32 or not img.is_contiguous():
        raise ValueError("transform_cuda takes a contiguous int32 tensor")
    out = torch.empty(t.xsize * height, dtype=torch.int32, device=device)
    aux = torch.from_numpy(t.data.view(np.int32)).to(device) \
        if len(t.data) else None
    with torch.cuda.device(device):
        rc = _library().simvg_vp8l_transform(
            img.data_ptr(), out.data_ptr(),
            None if aux is None else aux.data_ptr(), t.kind, t.xsize,
            height, t.bits, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"VP8L transform kernel launch failed: CUDA "
                           f"error {rc}")
    return out


def decode_cuda(st: Vp8lStream, device) -> torch.Tensor:
    """The kernels' BGR uint8 [h, w, 3] image of a parsed stream on a CUDA
    device, on the current stream: each transform undone
    (``transform_cuda``), then the ARGB pixels converted."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"decode_cuda needs a CUDA device, got {device}")
    lib = _library()
    cur = torch.from_numpy(st.pixels.view(np.int32)).to(device)
    for t in reversed(st.transforms):
        cur = transform_cuda(t, cur, st.height)
    out = torch.empty(st.height, st.width, 3, dtype=torch.uint8,
                      device=device)
    with torch.cuda.device(device):
        rc = lib.simvg_vp8l_to_bgr(
            cur.data_ptr(), st.width * st.height, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"VP8L convert kernel launch failed: CUDA error "
                           f"{rc}")
    decode.launches += 1
    return out


def _route(device) -> torch.device:
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no VP8L decoder for device {device}")
    return device


def host_stage(data: bytes, device="cuda") -> Vp8lStream:
    """The parsed stream from ``device``'s route: the host C++ for a CUDA
    device, ``parse`` for the CPU."""
    return decode_host(data) if _route(device).type == "cuda" \
        else parse(data)


def pixel_stage(st: Vp8lStream, device="cuda") -> torch.Tensor:
    """BGR uint8 [h, w, 3] of a parsed stream on ``device``: the kernels
    on a CUDA device, ``reconstruct_reference`` on the CPU."""
    if _route(device).type == "cuda":
        return decode_cuda(st, device)
    return torch.from_numpy(reconstruct_reference(st))


def decode(data: bytes, device="cuda") -> torch.Tensor:
    """BGR uint8 [h, w, 3] of a VP8L stream (not oriented) on
    ``device``."""
    return pixel_stage(host_stage(data, device), device)


decode.launches = 0  # VP8L kernel launches (CUDA route only)
