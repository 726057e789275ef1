"""Image files by their signature, the formats of the port's data path:

- JPEG (``jpeg.py``: nvJPEG on the card);
- PNG (``png.py``: inflate on the host, the unfiltering kernel);
- WebP, lossy and lossless (``webp.py`` -> ``vp8.py``, ``vp8l.py``: the
  entropy decoding on the host, the reconstruction kernels);
- GIF, TIFF, BMP, PNM/PFM, Sun raster and Radiance HDR (``gif.py``,
  ``tiff.py``, ``bmp.py``, ``pnm.py``, ``sunras.py``, ``hdr.py``: the
  container and its coding on the host, ``image_convert.py``'s kernel).

The JAX package reads whatever cv2 reads.  The formats cv2 also reads
and the port does not (JPEG 2000, AVIF; OpenEXR, which this cv2 does not
read either) raise a ValueError that names them, as does any stream the
port cannot tell.
"""

from __future__ import annotations

import torch

from . import bmp, gif, hdr, jpeg, png, pnm, sunras, tiff, webp
from .jpeg import JpegGeometry

# formats cv2 reads that the port does not, by their magic bytes
_OTHER_FORMATS = (
    (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"),
    (b"\xff\x4f\xff\x51", "JPEG 2000"), (b"\x76\x2f\x31\x01", "OpenEXR"),
    (b"P7", "PAM"),
)
_AVIF_BRANDS = (b"avif", b"avis")

_MODULES = {"png": png, "webp": webp, "gif": gif, "tiff": tiff, "bmp": bmp,
            "pnm": pnm, "sunras": sunras, "hdr": hdr}


def image_format(data: bytes) -> str:
    """The stream's format from its signature: "jpeg", "png", "webp",
    "gif", "tiff", "bmp", "pnm" (P1-P6 and PFM), "sunras" or "hdr";
    raises ValueError that names any other format it recognises."""
    if data[:2] == b"\xff\xd8":
        return "jpeg"
    if data.startswith(png.SIGNATURE):
        return "png"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    if data[:6] in gif.SIGNATURES:
        return "gif"
    if data[:4] in tiff.SIGNATURES:
        return "tiff"
    if data[:2] == b"BM":
        return "bmp"
    if len(data) > 2 and data[:1] == b"P" and data[1:2] in b"123456Ff" \
            and data[2:3].isspace():
        return "pnm"
    if data.startswith(sunras.MAGIC):
        return "sunras"
    if data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE"):
        return "hdr"
    kind = next((name for magic, name in _OTHER_FORMATS
                 if data.startswith(magic)), None)
    if kind is None and data[4:8] == b"ftyp" and data[8:12] in _AVIF_BRANDS:
        kind = "AVIF"
    raise ValueError(
        f"{kind + ' is' if kind else 'this stream is'} not an image format "
        "the port decodes (JPEG, PNG, WebP, GIF, TIFF, BMP, PNM/PFM, Sun "
        "raster, Radiance HDR)")


def image_geometry(data: bytes) -> JpegGeometry:
    """The decoded image's (height, width) after its orientation, the
    component count and the orientation, from the stream's headers."""
    kind = image_format(data)
    if kind == "png":
        return png.png_geometry(data)
    if kind == "jpeg":
        return jpeg.jpeg_geometry(data)
    return _MODULES[kind].geometry(data)


def decode_image(data: bytes, device="cuda") -> torch.Tensor:
    """BGR uint8 [h, w, 3] of an image stream, oriented as ``cv2.imread``
    orients it, on ``device`` (the card's decoders on a CUDA device; cv2
    for a JPEG and the plain decoders for the rest on the CPU)."""
    kind = image_format(data)
    if kind == "jpeg":
        return jpeg.decode(data, device)
    return _MODULES[kind].decode(data, device)
