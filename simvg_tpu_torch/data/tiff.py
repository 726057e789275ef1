"""TIFF files: the first IFD, its strips or tiles and their decompression
on the host, the predictor and the pixels on the card through
``image_convert``.

What ``cv2.imdecode(..., IMREAD_COLOR)`` reads through libtiff 4.7 (cv2
5.0.0's build), followed here and checked against it case by case:

- compressions 1 (none), 5 (LZW, ``lzw.py``), 8 and 32946 (Deflate, the
  standard library's ``zlib``) and 32773 (PackBits); any other (JPEG-in-
  TIFF, CCITT, ...) raises a ValueError that names it;
- predictor 1 and 2 (horizontal differences, 8 and 16 bits, undone on the
  card a row at a time); predictor 3 goes with float samples, which cv2
  does not read at IMREAD_COLOR either (``TIFFRGBAImageOK`` refuses 32-bit
  samples), so it raises too;
- photometric 0 (min-is-white, inverted) and 1 (min-is-black) gray at 1,
  8 and 16 bits; 2 (RGB) at 8 and 16 bits, an unassociated alpha (extra
  sample 2) premultiplying the colour as libtiff's RGBA reading does,
  ``(c * a + 127) // 255``, any other alpha dropped; 3 (palette, the
  colour map's 16-bit entries >> 8) at 1, 4 and 8 bits; cv2 refuses 2-bit
  samples and 4-bit ones without a palette, and so does this reader;
- chunky (planar 1) or planar (2) samples, in strips or tiles;
- a 16-bit gray sample becomes ``v >> 8``, a 16-bit RGB sample
  ``(v + 128) // 257`` (libtiff's RGBA conversion).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import image_convert as ic
from . import lzw
from .jpeg import JpegGeometry

SIGNATURES = (b"II*\x00", b"MM\x00*")
COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3",
                4: "CCITT Group 4", 5: "LZW", 6: "old-style JPEG", 7: "JPEG",
                8: "Deflate", 32946: "Deflate", 32773: "PackBits",
                34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA",
                50000: "Zstandard", 50001: "WebP", 34892: "lossy JPEG"}
_READ = (1, 5, 8, 32946, 32773)
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 16: "Q"}


def _ifd(data: bytes):
    """The first IFD's tags as {tag: tuple of values} and the byte
    order."""
    if len(data) < 8 or data[:4] not in SIGNATURES:
        raise ValueError("not a TIFF stream")
    e = "<" if data[:2] == b"II" else ">"
    (at,) = struct.unpack_from(e + "I", data, 4)
    if at + 2 > len(data):
        raise ValueError("truncated TIFF: no IFD")
    (n,) = struct.unpack_from(e + "H", data, at)
    if at + 2 + 12 * n > len(data):
        raise ValueError("truncated TIFF IFD")
    tags = {}
    for k in range(n):
        tag, typ, count = struct.unpack_from(e + "HHI", data, at + 2 + 12 * k)
        code = _TYPES.get(typ)
        if code is None:
            continue
        size = struct.calcsize(code) * count
        where = at + 2 + 12 * k + 8
        if size > 4:
            (where,) = struct.unpack_from(e + "I", data, where)
        if where + size > len(data):
            raise ValueError(f"truncated TIFF: tag {tag} past the end")
        tags[tag] = struct.unpack_from(f"{e}{count}{code}", data, where)
    return tags, e == ">"


def _one(tags, tag, default=None):
    v = tags.get(tag)
    if v is None:
        if default is None:
            raise ValueError(f"TIFF without tag {tag}")
        return default
    return v[0]


class TiffImage:
    """The first IFD's layout: sizes, samples, compression and where each
    strip or tile lies."""

    def __init__(self, data: bytes):
        tags, self.big_endian = _ifd(data)
        self.width, self.height = _one(tags, 256), _one(tags, 257)
        self.bits = tags.get(258, (1,))
        self.spp = _one(tags, 277, 1)
        self.compression = _one(tags, 259, 1)
        self.photometric = _one(tags, 262)
        self.planar = _one(tags, 284, 1)
        self.predictor = _one(tags, 317, 1)
        self.sample_format = _one(tags, 339, 1)
        self.colormap = tags.get(320)
        self.fill_order = _one(tags, 266, 1)
        self.extra = tags.get(338, ())
        if 322 in tags:
            self.tile = (_one(tags, 322), _one(tags, 323))
            self.offsets, self.counts = tags.get(324), tags.get(325)
        else:
            self.tile = None
            self.rows_per_strip = min(_one(tags, 278, 2 ** 32 - 1),
                                      self.height)
            self.offsets, self.counts = tags.get(273), tags.get(279)
        if self.offsets is None or self.counts is None:
            raise ValueError("TIFF without strip or tile offsets")

    def check(self):
        """Raises ValueError naming what cv2 (or this reader) does not
        read."""
        name = COMPRESSIONS.get(self.compression, str(self.compression))
        if self.compression not in _READ:
            raise ValueError(f"TIFF compression {self.compression} ({name}) "
                             "is not read")
        if len(set(self.bits)) != 1:
            raise ValueError("TIFF samples of different bit depths")
        bits = self.bits[0]
        if self.sample_format != 1 or bits not in (1, 2, 4, 8, 16):
            raise ValueError(f"TIFF with {bits}-bit samples of format "
                             f"{self.sample_format} is not read")
        ph = self.photometric
        if bits == 2 or (bits == 4 and ph != 3):
            raise ValueError(f"TIFF with {bits}-bit samples of photometric "
                             f"{ph} is not read (nor by cv2 5.0.0)")
        if ph not in (0, 1, 2, 3):
            raise ValueError(f"TIFF photometric interpretation {ph} is not "
                             "read")
        if ph == 2 and (self.spp < 3 or bits not in (8, 16)):
            raise ValueError(f"TIFF RGB with {self.spp} samples of {bits} "
                             "bits is not read")
        if ph == 3 and (self.colormap is None or bits > 8):
            raise ValueError("TIFF palette image without a colour map or "
                             "above 8 bits")
        if self.predictor not in (1, 2) or (self.predictor == 2
                                            and bits not in (8, 16)):
            raise ValueError(f"TIFF predictor {self.predictor} at {bits} "
                             "bits is not read")
        if self.fill_order != 1:
            raise ValueError("TIFF fill order 2 is not read")
        if self.planar not in (1, 2):
            raise ValueError(f"TIFF planar configuration {self.planar}")

    @property
    def plane_spp(self):
        """Samples a pixel within a plane."""
        return 1 if self.planar == 2 else self.spp

    @property
    def row_bytes(self):
        w = self.tile[0] if self.tile else self.width
        return (w * self.plane_spp * self.bits[0] + 7) // 8

    def chunks(self):
        """(offset, byte count, decompressed size, rows) of each strip or
        tile, planes one after the other."""
        planes = self.spp if self.planar == 2 else 1
        if self.tile:
            tw, th = self.tile
            per_plane = -(-self.width // tw) * -(-self.height // th)
            sizes = [(th * self.row_bytes, th)] * per_plane
        else:
            rps = self.rows_per_strip
            per_plane = -(-self.height // rps)
            sizes = [(min(rps, self.height - k * rps) * self.row_bytes,
                      min(rps, self.height - k * rps))
                     for k in range(per_plane)]
        n = per_plane * planes
        if len(self.offsets) < n or len(self.counts) < n:
            raise ValueError("TIFF with too few strip or tile offsets")
        return [(self.offsets[k], self.counts[k]) + sizes[k % per_plane]
                for k in range(n)]


def geometry(data: bytes) -> JpegGeometry:
    t = TiffImage(data)
    return JpegGeometry(t.height, t.width,
                        3 if t.photometric in (2, 3) else 1, 1)


def _unpackbits(src: bytes, size: int) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    while len(out) < size and i < n:
        c = src[i]
        if c < 128:
            out += src[i + 1:i + 2 + c]
            i += 2 + c
        elif c > 128:
            if i + 1 < n:
                out += bytes((src[i + 1],)) * (257 - c)
            i += 2
        else:
            i += 1
    return bytes(out)


def _decompress(t: TiffImage, chunk: bytes, size: int, device) -> bytes:
    if t.compression == 1:
        out = chunk
    elif t.compression == 5:
        if chunk[:2] == b"\x00\x01":
            raise ValueError("TIFF old-style LZW is not read")
        out = lzw.decode(chunk, lzw.TIFF, device, limit=size)
    elif t.compression in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(chunk, size)
        except zlib.error as e:
            raise ValueError(f"TIFF Deflate data: {e}") from e
    else:
        out = _unpackbits(chunk, size)
    if len(out) < size:
        raise ValueError("TIFF strip or tile shorter than its rows")
    return out[:size]


def parse(data: bytes, device="cpu"):
    """The image's decompressed bytes, its Raster (without the bytes) and
    the predictor's segments (None without one), the decompression done by
    ``device``'s route."""
    t = TiffImage(data)
    t.check()
    parts = []
    for off, count, size, _ in t.chunks():
        if off + count > len(data):
            raise ValueError("truncated TIFF strip or tile")
        parts.append(_decompress(t, data[off:off + count], size, device))
    raw = b"".join(parts)
    bits, rb = t.bits[0], t.row_bytes
    planes = t.spp if t.planar == 2 else 1
    ph = t.photometric
    common = dict(planes=planes, plane_bytes=len(raw) // planes,
                  big_endian=t.big_endian, tile=t.tile)
    spp = t.plane_spp
    if ph == 3:
        cmap = np.asarray(t.colormap, np.int64).reshape(3, -1) >> 8
        r = ic.Raster(b"", t.width, t.height, bits, spp, ic.PALETTE, rb,
                      palette=cmap[::-1].T.astype(np.uint8), **common)
    elif ph == 2:
        lut = None if bits == 8 else \
            ((np.arange(65536) + 128) // 257).astype(np.uint8)
        # an unassociated alpha (extra sample 2) premultiplies the colour
        alpha = 3 if t.spp > 3 and t.extra[:1] == (2,) else -1
        r = ic.Raster(b"", t.width, t.height, bits, spp, ic.COLOR, rb,
                      order=(2, 1, 0), lut=lut, alpha=alpha, **common)
    else:
        levels = np.arange(1 << bits)
        if bits == 16:
            lut = levels >> 8
        else:
            lut = levels * (255 // ((1 << bits) - 1))
        if ph == 0:
            lut = 255 - lut
        r = ic.Raster(b"", t.width, t.height, bits, spp, ic.GRAY, rb,
                      lut=lut.astype(np.uint8), **common)
    segments = None
    if t.predictor == 2:
        w = t.tile[0] if t.tile else t.width
        segments = (len(raw) // rb, rb, w, spp, bits, t.big_endian)
    return raw, r, segments


def pixel_stage(parsed, device="cuda"):
    """BGR uint8 [h, w, 3] on ``device`` of ``parse``'s result (made by the
    same device's route): the predictor undone and the pixels converted,
    by the kernels on a CUDA device."""
    import torch

    device = torch.device(device)
    raw, r, segments = parsed
    if device.type == "cuda":
        buf = ic.undo_predictor_cuda(raw, device, *segments) \
            if segments else None
        return ic.convert_cuda(r._replace(data=raw), device, buf)
    if segments:
        raw = ic.undo_predictor_reference(raw, *segments)
    return ic.convert(r._replace(data=raw), device)


def decode(data: bytes, device="cuda"):
    """BGR uint8 [h, w, 3] of a TIFF's first image on ``device``."""
    return pixel_stage(parse(data, device), device)
