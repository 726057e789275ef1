"""PNM (P1-P6) and PFM files: the header and ASCII samples parsed on the
host, the pixels through ``image_convert``.

What ``cv2.imdecode(..., IMREAD_COLOR)`` reads (OpenCV's PxM and PFM
decoders, followed here and checked against cv2 5.0.0):

- P1/P4 bitmaps (1 is black), P2/P5 gray, P3/P6 RGB, in ASCII (P1-P3:
  whitespace-separated numbers, ``#`` comments; a value above maxval is
  clamped to it; a P1 sample is one digit) or binary (P4-P6: rows of
  bytes, P4's padded to a byte, 16-bit samples big-endian);
- maxval up to 255 scaled as ``v * 255 // maxval`` (a binary sample above
  maxval gives 0), maxval above 255 read as 16 bits and shifted,
  ``v >> 8``, with no scaling to maxval;
- PFM: ``PF`` (RGB) or ``Pf`` (gray) float32 samples, little-endian when
  the scale s is negative, rows bottom-up, each value times the float32
  1 / |s| rounded to 8 bits as ``saturate_cast`` rounds (1.0 is 1, not
  255).  cv2 hands a gray PFM back as [h, w] even at IMREAD_COLOR; here
  it is [h, w, 3], the gray replicated, as for every gray format.
"""

from __future__ import annotations

import re

import numpy as np

from . import image_convert as ic
from .jpeg import JpegGeometry

_WS = b" \t\r\n\v\f"


def _tokens(data: bytes, start: int, n: int):
    """``n`` whitespace-separated tokens from ``start``, skipping ``#``
    comments to the end of their line; returns them and the position just
    after the last."""
    out, i = [], start
    while len(out) < n:
        while i < len(data) and data[i] in _WS:
            i += 1
        if i < len(data) and data[i:i + 1] == b"#":
            while i < len(data) and data[i] not in b"\r\n":
                i += 1
            continue
        j = i
        while j < len(data) and data[j] not in _WS and data[j:j + 1] != b"#":
            j += 1
        if j == i:
            raise ValueError("truncated PNM header")
        out.append(data[i:j])
        i = j
    return out, i


def _header(data: bytes):
    """(kind 1-6 or 'F'/'f', width, height, maxval or PFM scale, offset of
    the first sample)."""
    if len(data) < 3 or data[:1] != b"P" or data[1:2] not in b"123456Ff":
        raise ValueError("not a PNM stream")
    kind = data[1:2].decode()
    bitmap = kind in "14"
    toks, i = _tokens(data, 2, 2 if bitmap else 3)
    try:
        w, h = int(toks[0]), int(toks[1])
        third = float(toks[2]) if kind in "Ff" else \
            (1 if bitmap else int(toks[2]))
    except ValueError as e:
        raise ValueError(f"invalid PNM header: {e}") from e
    if w <= 0 or h <= 0 or (kind not in "Ff" and not 0 < third <= 65535):
        raise ValueError(f"invalid PNM header: {w}x{h}, maxval {third}")
    if kind in "Ff" and third == 0:
        raise ValueError("invalid PFM scale 0")
    return kind, w, h, third, i + 1  # one whitespace byte ends the header


def geometry(data: bytes) -> JpegGeometry:
    kind, w, h, _, _ = _header(data)
    return JpegGeometry(h, w, 3 if kind in "36F" else 1, 1)


def _lut(maxval: int) -> np.ndarray:
    lut = np.zeros(256, np.uint8)
    v = np.arange(maxval + 1)
    lut[:maxval + 1] = v * 255 // maxval
    return lut


def parse(data: bytes) -> ic.Raster:
    """The pixels' Raster; raises ValueError where cv2 reads no image."""
    kind, w, h, third, at = _header(data)
    if kind in "Ff":
        spp = 3 if kind == "F" else 1
        if len(data) < at + 4 * spp * w * h:
            raise ValueError("truncated PFM data")
        return ic.Raster(data, w, h, 32, spp, ic.FLOAT, 4 * spp * w,
                         offset=at, flip=True, big_endian=third > 0,
                         order=(2, 1, 0) if spp == 3 else (0, 0, 0),
                         scale=float(np.float32(1 / abs(third))))
    spp = 3 if kind in "36" else 1
    mode = ic.COLOR if spp == 3 else ic.GRAY
    order = (2, 1, 0) if spp == 3 else (0, 0, 0)
    maxval = int(third)
    if kind in "123":  # ASCII: the numbers, clamped, as 8 or 16-bit samples
        body = re.sub(rb"#[^\r\n]*", b" ", data[at - 1:])
        n = w * h * spp
        # a P1 sample is one digit: "0101" is four of them
        vals = (list(b"".join(body.split())) if kind == "1"
                else body.split())[:n]
        if len(vals) < n:
            raise ValueError("truncated PNM data")
        try:
            v = np.array([t - 48 if kind == "1" else int(t) for t in vals],
                         np.int64)
        except ValueError as e:
            raise ValueError(f"invalid PNM sample: {e}") from e
        v = np.minimum(np.maximum(v, 0), maxval)
        if kind == "1":
            return ic.Raster(v.astype(np.uint8).tobytes(), w, h, 8, 1,
                             ic.GRAY, w, lut=np.array([255] + [0] * 255,
                                                      np.uint8))
        if maxval > 255:
            return ic.Raster((v >> 8).astype(np.uint8).tobytes(), w, h, 8,
                             spp, mode, w * spp, order=order)
        return ic.Raster(v.astype(np.uint8).tobytes(), w, h, 8, spp, mode,
                         w * spp, order=order, lut=_lut(maxval))
    if kind == "4":
        stride = (w + 7) // 8
        if len(data) < at + h * stride:
            raise ValueError("truncated PNM data")
        return ic.Raster(data, w, h, 1, 1, ic.GRAY, stride, offset=at,
                         lut=np.array([255, 0], np.uint8))
    bits = 16 if maxval > 255 else 8
    stride = w * spp * bits // 8
    if len(data) < at + h * stride:
        raise ValueError("truncated PNM data")
    lut = None if bits == 16 or maxval == 255 else _lut(maxval)
    if bits == 16:
        lut = (np.arange(65536) >> 8).astype(np.uint8)
    return ic.Raster(data, w, h, bits, spp, mode, stride, offset=at,
                     big_endian=True, order=order, lut=lut)


def decode(data: bytes, device="cuda"):
    """BGR uint8 [h, w, 3] of a PNM or PFM stream on ``device``."""
    return ic.convert(parse(data), device)
