"""GIF files: the blocks and the LZW on the host (``lzw.py``), the palette,
the interlace and the canvas through ``image_convert``.

What ``cv2.imdecode(..., IMREAD_COLOR)`` reads (OpenCV 5's own GIF
decoder, followed here and checked against cv2 5.0.0): the first frame,
drawn on a canvas of the logical screen's size filled with the global
palette's background entry (black without a global palette); the
frame's pixels through its local palette, else the global one; a pixel
of the graphic control extension's transparent index left as the canvas
shows it; interlaced rows (stored as every 8th from 0, every 8th from 4,
every 4th from 2, every 2nd from 1) put back in order.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Tuple

import numpy as np

from . import image_convert as ic
from . import lzw
from .jpeg import JpegGeometry

SIGNATURES = (b"GIF87a", b"GIF89a")


class GifFrame(NamedTuple):
    """The first frame of a parsed GIF: the screen's size, the frame's
    rectangle (x0, y0, w, h), its palette (BGR), the canvas colour, the
    transparent index (-1 without one), the interlace flag and the LZW
    data."""

    width: int
    height: int
    frame: Tuple[int, int, int, int]
    palette: np.ndarray
    background: Tuple[int, int, int]
    transparent: int
    interlace: bool
    min_code_size: int
    lzw_data: bytes


def _palette(data: bytes, at: int, flags: int):
    n = 2 << (flags & 7)
    raw = np.frombuffer(data[at:at + 3 * n], np.uint8)
    if len(raw) < 3 * n:
        raise ValueError("truncated GIF colour table")
    return raw.reshape(n, 3)[:, ::-1].copy(), at + 3 * n


def _sub_blocks(data: bytes, at: int):
    """The concatenated sub-blocks from ``at`` and the position after the
    terminator."""
    parts = []
    while True:
        if at >= len(data):
            raise ValueError("truncated GIF data")
        n = data[at]
        if n == 0:
            return b"".join(parts), at + 1
        parts.append(data[at + 1:at + 1 + n])
        if at + 1 + n > len(data):
            raise ValueError("truncated GIF data")
        at += 1 + n


def _screen(data: bytes):
    if len(data) < 13 or data[:6] not in SIGNATURES:
        raise ValueError("not a GIF stream")
    w, h, flags, bg = struct.unpack_from("<HHBB", data, 6)
    if not w or not h:
        raise ValueError("GIF logical screen of zero size")
    return w, h, flags, bg


def geometry(data: bytes) -> JpegGeometry:
    w, h, _, _ = _screen(data)
    return JpegGeometry(h, w, 3, 1)


def parse(data: bytes) -> GifFrame:
    """The first frame's header, palette and LZW data; raises ValueError
    where cv2 reads no image."""
    w, h, flags, bg = _screen(data)
    at = 13
    gpal, background = None, (0, 0, 0)
    if flags & 0x80:
        gpal, at = _palette(data, at, flags)
        if bg < len(gpal):
            background = tuple(int(c) for c in gpal[bg])
    transparent = -1
    while True:
        if at >= len(data):
            raise ValueError("truncated GIF stream: no image")
        kind = data[at]
        if kind == 0x21:  # extension
            if at + 2 > len(data):
                raise ValueError("truncated GIF extension")
            label = data[at + 1]
            body, nxt = _sub_blocks(data, at + 2)
            if label == 0xF9 and len(body) >= 4:
                transparent = body[3] if body[0] & 1 else -1
            at = nxt
        elif kind == 0x2C:  # image descriptor
            if at + 10 > len(data):
                raise ValueError("truncated GIF image descriptor")
            x0, y0, fw, fh, iflags = struct.unpack_from("<HHHHB", data, at + 1)
            at += 10
            pal = gpal
            if iflags & 0x80:
                pal, at = _palette(data, at, iflags)
            if pal is None:
                raise ValueError("GIF frame without a colour table")
            if at >= len(data):
                raise ValueError("truncated GIF image data")
            mcs = data[at]
            body, _ = _sub_blocks(data, at + 1)
            return GifFrame(w, h, (x0, y0, fw, fh), pal, background,
                            transparent, bool(iflags & 0x40), mcs, body)
        elif kind == 0x3B:
            raise ValueError("GIF stream without an image")
        else:
            raise ValueError(f"GIF stream has an unknown block {kind:#x}")


def _interlaced_rows(h: int) -> np.ndarray:
    """The stored row of each displayed row of an interlaced frame."""
    order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                            np.arange(2, h, 4), np.arange(1, h, 2)])
    rows = np.empty(h, np.int32)
    rows[order] = np.arange(h, dtype=np.int32)
    return rows


def raster(g: GifFrame, device="cpu") -> ic.Raster:
    """The frame's Raster, its LZW decoded by ``device``'s route."""
    _, _, fw, fh = g.frame
    n = fw * fh
    idx = lzw.decode(g.lzw_data, lzw.GIF, device, g.min_code_size, n)
    if len(idx) < n:
        raise ValueError("truncated GIF image data")
    return ic.Raster(idx, g.width, g.height, 8, 1, ic.PALETTE, fw,
                     palette=g.palette, frame=g.frame,
                     rows=_interlaced_rows(fh) if g.interlace else None,
                     transparent=g.transparent, background=g.background)


def decode(data: bytes, device="cuda"):
    """BGR uint8 [h, w, 3] of a GIF's first frame on ``device``."""
    return ic.convert(raster(parse(data), device), device)
