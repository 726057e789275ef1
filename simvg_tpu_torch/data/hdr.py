"""Radiance HDR (RGBE) files: the header and the run-length coding on the
host, RGBE -> BGR uint8 through ``image_convert``.

What ``cv2.imdecode(..., IMREAD_COLOR)`` reads (OpenCV's HDR decoder, on
Bruce Walter's rgbe.c; followed here and checked against cv2 5.0.0): a
``#?RADIANCE`` or ``#?RGBE`` header whose ``FORMAT``, if given, is
``32-bit_rle_rgbe``, ended by an empty line and the resolution
``-Y h +X w``; then scanlines that are each new-style run-length coded
(``2 2 hi lo``, the four components one after the other, a count above
128 a run) until the first that is not, from which the rest is flat RGBE
(and all of it below 8 or above 32767 columns).  A pixel is ``c * 2^(e -
136)`` in float32 (0 where e = 0), then ``saturate_cast<uchar>(v * 255)``.
"""

from __future__ import annotations

import re

import numpy as np

from . import image_convert as ic
from .jpeg import JpegGeometry

_RES = re.compile(rb"-Y (\d+) \+X (\d+)")


def _header(data: bytes):
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR stream")
    i = data.find(b"\n") + 1
    while True:
        j = data.find(b"\n", i)
        if j < 0:
            raise ValueError("truncated Radiance HDR header")
        line = data[i:j]
        i = j + 1
        if not line.strip():
            break
        if line.startswith(b"FORMAT=") and \
                line.strip() != b"FORMAT=32-bit_rle_rgbe":
            raise ValueError(f"Radiance HDR {line.decode('latin-1')} is not "
                             "read")
    j = data.find(b"\n", i)
    m = _RES.match(data[i:j if j >= 0 else len(data)])
    if m is None:
        raise ValueError("Radiance HDR resolution other than -Y h +X w")
    h, w = int(m.group(1)), int(m.group(2))
    if w <= 0 or h <= 0:
        raise ValueError("invalid Radiance HDR size")
    return w, h, j + 1


def geometry(data: bytes) -> JpegGeometry:
    w, h, _ = _header(data)
    return JpegGeometry(h, w, 3, 1)


def _unrle(data: bytes, at: int, w: int, h: int) -> bytes:
    """The scanlines as flat RGBE bytes [h * w * 4]."""
    out = bytearray()
    i, n = at, len(data)
    for _ in range(h if 8 <= w <= 0x7FFF else 0):
        head = data[i:i + 4]
        if len(head) < 4:
            raise ValueError("truncated Radiance HDR data")
        if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
            break  # not run-length coded: the rest is flat
        if (head[2] << 8 | head[3]) != w:
            raise ValueError("Radiance HDR scanline of the wrong width")
        i += 4
        planes = bytearray()
        for _ in range(4):
            end = len(planes) + w
            while len(planes) < end:
                if i + 2 > n:
                    raise ValueError("truncated Radiance HDR data")
                c = data[i]
                if c > 128:
                    c -= 128
                    if c > end - len(planes):
                        raise ValueError("bad Radiance HDR scanline data")
                    planes += bytes((data[i + 1],)) * c
                    i += 2
                else:
                    if c == 0 or c > end - len(planes):
                        raise ValueError("bad Radiance HDR scanline data")
                    if i + 1 + c > n:
                        raise ValueError("truncated Radiance HDR data")
                    planes += data[i + 1:i + 1 + c]
                    i += 1 + c
        out += np.frombuffer(bytes(planes), np.uint8).reshape(4, w).T.tobytes()
    rest = w * h * 4 - len(out)
    if rest:
        if i + rest > n:
            raise ValueError("truncated Radiance HDR data")
        out += data[i:i + rest]
    return bytes(out)


def parse(data: bytes) -> ic.Raster:
    """The pixels' Raster; raises ValueError where cv2 reads no image."""
    w, h, at = _header(data)
    return ic.Raster(_unrle(data, at, w, h), w, h, 8, 4, ic.RGBE, 4 * w)


def decode(data: bytes, device="cuda"):
    """BGR uint8 [h, w, 3] of a Radiance HDR stream on ``device``."""
    return ic.convert(parse(data), device)
