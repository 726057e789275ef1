"""BMP files: the headers and the RLE runs on the host, the pixels through
``image_convert`` (the card's kernel, or its numpy plain version).

What ``cv2.imdecode(..., IMREAD_COLOR)`` reads (OpenCV's own BMP decoder,
followed here and checked against cv2 5.0.0):

- the OS/2 core header (12 bytes: 16-bit sizes, a palette of 1 << bpp BGR
  triples) and any header of 36 bytes or more (BITMAPINFOHEADER, V4, V5:
  the palette of ``clrUsed`` or 1 << bpp BGRX quads right after it);
- 1, 4 and 8 bits through the palette (an index past it gives 0), 24 and
  32 bits as B, G, R (a 32-bit pixel's fourth byte dropped, bitfields or
  not), 16 bits as 5-5-5 or, with BI_BITFIELDS masks 0xF800/0x7E0/0x1F
  read right after a header, 5-6-5, each channel shifted up with no
  rounding (any other 16-bit masks are refused);
- BI_RLE8 and BI_RLE4 expanded on the host: an end of line fills the
  rest of the row with palette entry 0, an end of bitmap the rest of the
  image, a delta the pixels it skips; a run past its row is an error;
- rows bottom-up, or top-down for a negative height.
"""

from __future__ import annotations

import struct

import numpy as np

from . import image_convert as ic
from .jpeg import JpegGeometry

_RGB, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3


def _header(data: bytes):
    """(width, height, bpp, compression, palette BGR [n, 3] or None, pixel
    offset, 16-bit masks as (shift, bits) of B, G, R or None)."""
    if len(data) < 26 or data[:2] != b"BM":
        raise ValueError("not a BMP stream (no BM signature, or too short)")
    (offset, size) = struct.unpack_from("<II", data, 10)
    palette, masks = None, None
    if size >= 36:
        if len(data) < 14 + 36:
            raise ValueError("truncated BMP header")
        w, h, bpp, comp = struct.unpack_from("<iixxHI", data, 18)
        (clrused,) = struct.unpack_from("<I", data, 46)
        ok = w > 0 and h != 0 and (
            (bpp in (1, 4, 8, 24, 32) and comp == _RGB)
            or (bpp in (16, 32) and comp in (_RGB, _BITFIELDS))
            or (bpp == 4 and comp == _RLE4) or (bpp == 8 and comp == _RLE8))
        if not ok:
            raise ValueError(f"BMP with {bpp} bits and compression {comp} "
                             "is not read")
        at = 14 + size
        if bpp <= 8:
            if clrused > 256:
                raise ValueError("BMP palette longer than 256 entries")
            n = clrused or 1 << bpp
            quads = np.frombuffer(data[at:at + 4 * n], np.uint8)
            if len(quads) < 4 * n:
                raise ValueError("truncated BMP palette")
            palette = quads.reshape(n, 4)[:, :3].copy()
        elif bpp == 16:
            masks = ((0, 5), (5, 5), (10, 5))
            if comp == _BITFIELDS:
                if len(data) < at + 12:
                    raise ValueError("truncated BMP bitfield masks")
                red, green, blue = struct.unpack_from("<III", data, at)
                if (red, green, blue) == (0xF800, 0x7E0, 0x1F):
                    masks = ((0, 5), (5, 6), (11, 5))
                elif (red, green, blue) != (0x7C00, 0x3E0, 0x1F):
                    raise ValueError("BMP 16-bit bitfields other than 5-5-5 "
                                     "and 5-6-5 are not read")
    elif size == 12:
        w, h, _, bpp = struct.unpack_from("<HHHH", data, 18)
        comp = _RGB
        if not (w > 0 and h > 0 and bpp in (1, 4, 8, 24, 32)):
            raise ValueError(f"BMP core header with {bpp} bits is not read")
        if bpp <= 8:
            n = 1 << bpp
            pal = np.frombuffer(data[26:26 + 3 * n], np.uint8)
            if len(pal) < 3 * n:
                raise ValueError("truncated BMP palette")
            palette = pal.reshape(n, 3).copy()
    else:
        raise ValueError(f"BMP header of {size} bytes is not read")
    return w, h, bpp, comp, palette, offset, masks


def geometry(data: bytes) -> JpegGeometry:
    w, h, bpp, _, palette, _, _ = _header(data)
    gray = palette is not None and bool(
        (palette == palette[:, :1]).all())
    return JpegGeometry(abs(h), w, 1 if gray else 3, 1)


def _rle(data: bytes, at: int, w: int, h: int, four: bool) -> bytes:
    """The RLE4/RLE8 stream from byte ``at`` as one index byte a pixel,
    rows in stream order (bottom-up), skipped pixels as index 0.  The row
    bookkeeping is OpenCV's: a run or a literal must end inside its row,
    and a fill (end of line, end of bitmap, delta) moves on a row each
    time it reaches a row's end."""
    out = bytearray(w * h)
    pos, y, i, n = 0, 0, at, len(data)
    while y < h:
        if i + 2 > n:
            raise ValueError("truncated BMP RLE stream")
        count, code = data[i], data[i + 1]
        i += 2
        line_end = (y + 1) * w
        if count or code > 2:
            literal = not count
            k = code if literal else count
            if pos + k > line_end:
                raise ValueError("BMP RLE run past the end of its row")
            if literal:  # code indices, word-aligned
                size = ((((k + 1) >> 1) + 1) & ~1) if four else (k + 1) & ~1
                if i + size > n:
                    raise ValueError("truncated BMP RLE stream")
                raw = np.frombuffer(data[i:i + size], np.uint8)
                i += size
            else:  # a run of one index (two alternating in RLE4)
                raw = np.full((k + 1) // 2 if four else k, code, np.uint8)
            if four:
                raw = np.stack([raw >> 4, raw & 15], 1).reshape(-1)
            out[pos:pos + k] = raw[:k].tobytes()
            pos += k
            continue
        # 0 end of line, 1 end of bitmap, 2 delta (dx, dy): index 0
        k = line_end - pos
        if code == 1:
            k += (h - y) * w
        elif code == 2:
            if i + 2 > n:
                raise ValueError("truncated BMP RLE stream")
            k = data[i] + data[i + 1] * w
            i += 2
        while True:
            e = min(pos + k, line_end)
            k -= e - pos
            pos = e
            if pos >= line_end:
                y += 1
                line_end += w
                if y >= h:
                    break
            if k <= 0:
                break
    return bytes(out)


def parse(data: bytes) -> ic.Raster:
    """The pixels' Raster; raises ValueError where cv2 reads no image."""
    w, h, bpp, comp, palette, offset, masks = _header(data)
    rows = abs(h)
    flip = h > 0
    if comp in (_RLE4, _RLE8):
        idx = _rle(data, offset, w, rows, comp == _RLE4)
        return ic.Raster(idx, w, rows, 8, 1, ic.PALETTE, w, flip=flip,
                         palette=palette)
    stride = (w * bpp + 31) // 32 * 4
    if len(data) < offset + rows * stride:
        raise ValueError("truncated BMP pixel data")
    common = dict(offset=offset, flip=flip)
    if bpp <= 8:
        return ic.Raster(data, w, rows, bpp, 1, ic.PALETTE, stride,
                         palette=palette, **common)
    if bpp == 16:
        return ic.Raster(data, w, rows, 16, 1, ic.BITFIELDS, stride,
                         masks=masks, **common)
    return ic.Raster(data, w, rows, 8, bpp // 8, ic.COLOR, stride,
                     order=(0, 1, 2), **common)


def decode(data: bytes, device="cuda"):
    """BGR uint8 [h, w, 3] of a BMP stream on ``device``."""
    return ic.convert(parse(data), device)
