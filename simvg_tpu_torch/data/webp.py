"""WebP files: the RIFF container on the host, routed to ``vp8.py`` (lossy)
or ``vp8l.py`` (lossless).

What ``cv2.imdecode(..., IMREAD_COLOR)`` reads (OpenCV's WebP decoder on
libwebp, checked against cv2 5.0.0):

- a simple file (``VP8 `` or ``VP8L`` chunk) or an extended one
  (``VP8X``, whose canvas must match the image, then ``ICCP``, ``ALPH``,
  ``EXIF``, ``XMP `` and unknown chunks around one ``VP8 ``/``VP8L``);
- alpha, from an ``ALPH`` chunk or VP8L's own, is dropped with no
  compositing (the ``ALPH`` data is not decoded: IMREAD_COLOR keeps none
  of it);
- an ``EXIF`` chunk's orientation is applied, as for a JPEG;
- an animated file gives its first frame (the first ``ANMF`` chunk's
  image) on a transparent-black canvas of the ``VP8X`` size, as libwebp's
  animation decoder draws a key frame;
- a RIFF size past the data, or a chunk past the RIFF size, is a
  truncated file.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional, Tuple

import torch

from . import vp8, vp8l
from .jpeg import JpegGeometry, _exif_orientation, orient


class WebpFile(NamedTuple):
    lossless: bool
    bitstream: bytes  # the VP8 or VP8L chunk's payload
    width: int
    height: int
    orientation: int
    # an animation's first frame: (x, y, canvas width, canvas height)
    canvas: Optional[Tuple[int, int, int, int]] = None


def parse(data: bytes) -> WebpFile:
    """The image chunk, its size and the EXIF orientation; raises
    ValueError where libwebp reports an error."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP stream")
    (riff,) = struct.unpack_from("<I", data, 4)
    if riff < 12 or riff + 8 > len(data):
        raise ValueError("truncated WebP stream: the RIFF size is past its "
                         "end")
    end = riff + 8
    at, canvas, orientation, image, frame = 12, None, 1, None, None
    animated = False
    while at + 8 <= end:
        kind = data[at:at + 4]
        (size,) = struct.unpack_from("<I", data, at + 4)
        body = data[at + 8:at + 8 + size]
        if at + 8 + size > end:
            raise ValueError(f"truncated WebP stream: the {kind!r} chunk is "
                             "cut")
        if kind == b"VP8X":
            if at != 12 or size < 10:
                raise ValueError("invalid WebP VP8X chunk")
            animated = bool(body[0] & 0x02)
            canvas = (1 + int.from_bytes(body[4:7], "little"),
                      1 + int.from_bytes(body[7:10], "little"))
        elif kind == b"ANMF" and image is None:
            if size < 16:
                raise ValueError("invalid WebP ANMF chunk")
            x = 2 * int.from_bytes(body[0:3], "little")
            y = 2 * int.from_bytes(body[3:6], "little")
            frame = (x, y, 1 + int.from_bytes(body[6:9], "little"),
                     1 + int.from_bytes(body[9:12], "little"))
            sub = 16
            while sub + 8 <= size and image is None:
                k = body[sub:sub + 4]
                (n,) = struct.unpack_from("<I", body, sub + 4)
                if k in (b"VP8 ", b"VP8L"):
                    image = (k == b"VP8L", body[sub + 8:sub + 8 + n])
                sub += 8 + n + (n & 1)
            if image is None:
                raise ValueError("WebP animation frame without an image")
        elif kind == b"EXIF":
            payload = body if body.startswith(b"Exif\x00\x00") \
                else b"Exif\x00\x00" + body
            orientation = _exif_orientation(payload)
        elif kind in (b"VP8 ", b"VP8L") and image is None:
            image = (kind == b"VP8L", body)
            if canvas is None:
                break  # a simple file: nothing after the image is read
        at += 8 + size + (size & 1)
    if image is None:
        raise ValueError("WebP stream without an image chunk")
    lossless, body = image
    if lossless:
        w, h, _ = vp8l.header(body)
    else:
        w, h, _ = vp8.frame_header(body)
    if frame is not None:
        if not animated or frame[2:] != (w, h) or frame[0] + w > canvas[0] \
                or frame[1] + h > canvas[1]:
            raise ValueError("WebP animation frame outside its canvas")
        return WebpFile(lossless, body, w, h, orientation,
                        frame[:2] + canvas)
    if canvas is not None and canvas != (w, h):
        raise ValueError("WebP image size differs from its VP8X canvas")
    return WebpFile(lossless, body, w, h, orientation)


def geometry(data: bytes) -> JpegGeometry:
    f = parse(data)
    h, w = (f.canvas[3], f.canvas[2]) if f.canvas else (f.height, f.width)
    if f.orientation >= 5:
        h, w = w, h
    return JpegGeometry(h, w, 3, f.orientation)


def host_stage(data: bytes, device="cuda"):
    """The container and the bitstream's parse from ``device``'s route
    (the host C++ for a CUDA device, the plain parser for the CPU)."""
    f = parse(data)
    return f, (vp8l if f.lossless else vp8).host_stage(f.bitstream, device)


def pixel_stage(parsed, device="cuda"):
    """BGR uint8 [h, w, 3] of ``host_stage``'s result, oriented by its
    EXIF, on ``device``: the kernels on a CUDA device, the plain decoders
    on the CPU."""
    f, stream = parsed
    image = (vp8l if f.lossless else vp8).pixel_stage(stream, device)
    if f.canvas:  # an animation's first frame on its canvas
        x, y, cw, ch = f.canvas
        canvas = torch.zeros(ch, cw, 3, dtype=torch.uint8,
                             device=image.device)
        canvas[y:y + f.height, x:x + f.width] = image
        image = canvas
    return orient(image, f.orientation)


def decode(data: bytes, device="cuda"):
    """BGR uint8 [h, w, 3] of a WebP stream, oriented by its EXIF, on
    ``device``."""
    return pixel_stage(host_stage(data, device), device)
