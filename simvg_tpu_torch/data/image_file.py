"""Image files by their signature: JPEG (``jpeg.py``: nvJPEG on the card)
and PNG (``png.py``: inflate on the host, the unfiltering kernel on the
card), the formats of the port's data path.

The JAX package reads whatever cv2 reads; the port takes these two and
raises a ValueError that names any other format it can tell from the
stream's first bytes.
"""

from __future__ import annotations

import torch

from . import jpeg, png
from .jpeg import JpegGeometry

# formats cv2 reads that the port does not, by their magic bytes
_OTHER_FORMATS = (
    (b"BM", "BMP"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
    (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
    (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"),
    (b"\xff\x4f\xff\x51", "JPEG 2000"), (b"\x76\x2f\x31\x01", "OpenEXR"),
    (b"#?RADIANCE", "Radiance HDR"), (b"#?RGBE", "Radiance HDR"),
)


def image_format(data: bytes) -> str:
    """"jpeg" or "png" from the stream's signature; raises ValueError that
    names any other format it recognises."""
    if data[:2] == b"\xff\xd8":
        return "jpeg"
    if data.startswith(png.SIGNATURE):
        return "png"
    kind = next((name for magic, name in _OTHER_FORMATS
                 if data.startswith(magic)), None)
    if kind is None and data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        kind = "WebP"
    if kind is None and len(data) > 2 and data[:1] == b"P" \
            and data[1:2] in b"1234567" and data[2:3].isspace():
        kind = "PNM"
    raise ValueError(
        f"{kind + ' is' if kind else 'this stream is'} not an image format "
        "the port decodes (JPEG and PNG)")


def image_geometry(data: bytes) -> JpegGeometry:
    """The decoded image's (height, width), component count and EXIF
    orientation, from a JPEG's or a PNG's headers."""
    if image_format(data) == "png":
        return png.png_geometry(data)
    return jpeg.jpeg_geometry(data)


def decode_image(data: bytes, device="cuda") -> torch.Tensor:
    """BGR uint8 [h, w, 3] of a JPEG or PNG stream, oriented as
    ``cv2.imread`` orients it, on ``device`` (the card's decoders on a
    CUDA device; cv2 for a JPEG and the plain PNG decoder on the CPU)."""
    if image_format(data) == "png":
        return png.decode(data, device)
    return jpeg.decode(data, device)
