"""Sun raster files: the header and the colormap on the host, the pixels
through ``image_convert``.

What ``cv2.imdecode(..., IMREAD_COLOR)`` reads (OpenCV's Sun raster
decoder, followed here and checked against cv2 5.0.0): depths 1, 8, 24
and 32 of RT_OLD and RT_STANDARD (B, G, R order); an RMT_EQUAL_RGB
colormap of at most 1 << depth entries (its R, G and B planes) at 1 and 8
bits, else gray (1 bit: 0 black, 1 white); rows padded to 16 bits; a
32-bit pixel's pad byte first.

cv2 5.0.0 reads no RT_BYTE_ENCODED (run-length) and no RT_FORMAT_RGB
file: its header check tests the image's type where it means the
encoding, so both fail to open.  The JAX package therefore reads neither,
and the port refuses both with a ValueError that names them.
"""

from __future__ import annotations

import struct

import numpy as np

from . import image_convert as ic
from .jpeg import JpegGeometry

MAGIC = b"\x59\xa6\x6a\x95"
_OLD, _STANDARD = 0, 1
_TYPES = {2: "RT_BYTE_ENCODED (run-length)", 3: "RT_FORMAT_RGB"}


def _header(data: bytes):
    if len(data) < 32 or not data.startswith(MAGIC):
        raise ValueError("not a Sun raster stream")
    w, h, depth, _, kind, maptype, maplen = struct.unpack_from(">7I", data, 4)
    if kind in _TYPES:
        raise ValueError(f"Sun raster of type {_TYPES[kind]} is not read "
                         "(cv2 5.0.0 does not read it either)")
    pal_size = (1 << depth) * 3 if 0 < depth <= 8 else 0
    ok = (depth in (1, 8, 24, 32) and w > 0 and h > 0
          and kind in (_OLD, _STANDARD)
          and ((maptype == 0 and maplen == 0)
               or (maptype == 1 and 0 < maplen <= pal_size and depth <= 8)))
    if not ok:
        raise ValueError(f"Sun raster of depth {depth}, type {kind}, map type "
                         f"{maptype} is not read")
    palette = None
    if maplen:
        if len(data) < 32 + maplen:
            raise ValueError("truncated Sun raster colormap")
        n = maplen // 3
        planes = np.frombuffer(data[32:32 + 3 * n], np.uint8).reshape(3, n)
        palette = planes[::-1].T.copy()  # R, G, B planes -> BGR entries
    return w, h, depth, kind, palette, 32 + maplen


def geometry(data: bytes) -> JpegGeometry:
    w, h, depth, _, palette, _ = _header(data)
    gray = depth <= 8 and (palette is None or bool(
        (palette == palette[:, :1]).all()))
    return JpegGeometry(h, w, 1 if gray else 3, 1)


def parse(data: bytes) -> ic.Raster:
    """The pixels' Raster; raises ValueError where cv2 reads no image."""
    w, h, depth, _, palette, at = _header(data)
    stride = ((w * depth + 7) // 8 + 1) & ~1
    if len(data) < at + h * stride:
        raise ValueError("truncated Sun raster data")
    if depth <= 8:
        if palette is None:
            lut = np.zeros(1 << depth, np.uint8)
            lut[:] = np.arange(1 << depth) * (255 // ((1 << depth) - 1))
            return ic.Raster(data, w, h, depth, 1, ic.GRAY, stride,
                             offset=at, lut=lut)
        return ic.Raster(data, w, h, depth, 1, ic.PALETTE, stride, offset=at,
                         palette=palette)
    spp = depth // 8
    order = (1, 2, 3) if spp == 4 else (0, 1, 2)  # after the pad byte
    return ic.Raster(data, w, h, 8, spp, ic.COLOR, stride, offset=at,
                     order=order)


def decode(data: bytes, device="cuda"):
    """BGR uint8 [h, w, 3] of a Sun raster stream on ``device``."""
    return ic.convert(parse(data), device)
