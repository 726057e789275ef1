"""PNG files for the data pipeline: the chunks and the inflate on the host,
the unfiltering and the colour conversion on the card (``csrc/png.cu``),
and a plain numpy version of both for the CPU.

The JAX package reads any image with ``cv2.imread(path, IMREAD_COLOR)`` or
``cv2.imdecode`` (``simvg_tpu/data/datasets.py:158``, ``tools/serve.py``):
for a PNG that is libpng's reading, which this module follows:

- ``png_geometry(data)`` reads IHDR and the ``eXIf`` orientation (cv2
  applies it to a PNG as to a JPEG) without inflating: the same record as
  ``jpeg.jpeg_geometry``;
- ``parse(data)`` walks the chunks, checks each CRC as libpng does (a bad
  CRC on a critical chunk raises, on an ancillary one drops the chunk),
  raises on an unknown critical chunk, a truncated stream, an unfinished
  zlib stream or too little image data, and inflates the concatenated IDAT
  data with the standard library's ``zlib`` (which releases the GIL, so the
  loader's threads inflate side by side);
- ``decode(data, device)`` gives the BGR uint8 [h, w, 3] tensor, oriented.
  On a CUDA device the inflated bytes go to the card and the kernel
  unfilters and converts them; with ``device="cpu"`` ``decode_reference``
  does the same in numpy (no cv2).

``IMREAD_COLOR``'s conversion, checked against cv2 5.0.0 on libpng 1.6:
colour types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and 6
(RGBA); bit depths 1, 2, 4, 8 and 16.  Gray is replicated to three
channels (1, 2 and 4 bits scaled by 255, 85 and 17), a 16-bit sample
becomes ``v >> 8``, the palette is expanded (indices past PLTE give 0),
alpha and tRNS are dropped with no compositing, gAMA and sBIT are not
applied; Adam7-interlaced streams are deinterlaced.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from .jpeg import JpegGeometry, _exif_orientation, orient

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples a pixel of each colour type, and its allowed bit depths
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7's passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


class PngStream(NamedTuple):
    """A parsed PNG: IHDR's fields, the palette as BGR uint8 [256, 3]
    (zeros past PLTE; None without one), the eXIf orientation and the
    inflated image data (each pass's rows, a filter byte before each)."""

    width: int
    height: int
    bit_depth: int
    color_type: int
    interlace: int
    palette: Optional[np.ndarray]
    orientation: int
    data: bytes

    @property
    def channels(self) -> int:
        return _CHANNELS[self.color_type]

    @property
    def bpp(self) -> int:
        """Bytes a filter unit: a pixel's bytes, at least 1."""
        return max(1, self.channels * self.bit_depth // 8)

    def passes(self):
        """(x0, y0, dx, dy, w, h, rowbytes, offset) of each pass with
        pixels: Adam7's seven, or the whole image."""
        bits = self.channels * self.bit_depth
        out, offset = [], 0
        for x0, y0, dx, dy in (ADAM7 if self.interlace else ((0, 0, 1, 1),)):
            w = (self.width - x0 + dx - 1) // dx
            h = (self.height - y0 + dy - 1) // dy
            if w <= 0 or h <= 0:
                continue
            rowbytes = (w * bits + 7) // 8
            out.append((x0, y0, dx, dy, w, h, rowbytes, offset))
            offset += h * (rowbytes + 1)
        return out


def _chunks(data: bytes):
    """(type, payload) of each chunk with a good CRC; raises on a stream
    that is not a PNG, ends early or has a bad CRC on a critical chunk."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG stream (no PNG signature)")
    i = len(SIGNATURE)
    while True:
        if i + 12 > len(data):
            raise ValueError("truncated PNG stream: it ends before IEND")
        (n,) = struct.unpack_from(">I", data, i)
        kind = data[i + 4:i + 8]
        if i + 12 + n > len(data):
            raise ValueError(f"truncated PNG stream: the {kind!r} chunk is "
                             "cut")
        payload = data[i + 8:i + 8 + n]
        (crc,) = struct.unpack_from(">I", data, i + 8 + n)
        critical = not kind[0] & 0x20
        if zlib.crc32(kind + payload) != crc:
            if critical:
                raise ValueError(f"PNG {kind.decode('latin-1')} chunk: CRC "
                                 "error")
        else:
            yield kind, payload
        if kind == b"IEND":
            return
        i += 12 + n


def _header(payload: bytes):
    if len(payload) != 13:
        raise ValueError("PNG IHDR chunk has the wrong length")
    w, h, bd, ct, comp, filt, inter = struct.unpack(">IIBBBBB", payload)
    if not (w and h) or ct not in _DEPTHS or bd not in _DEPTHS[ct] \
            or comp or filt or inter > 1:
        raise ValueError(f"invalid PNG IHDR: {w}x{h}, bit depth {bd}, "
                         f"colour type {ct}, interlace {inter}")
    return w, h, bd, ct, inter


def png_geometry(data: bytes) -> JpegGeometry:
    """The decoded image's (height, width) after the eXIf orientation, the
    samples a pixel and the orientation, from the chunks before the image
    data (and an eXIf after it); raises ValueError on a stream that is not
    a PNG."""
    header, orientation = None, 1
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = _header(payload)
        elif kind == b"eXIf":
            orientation = _exif_orientation(b"Exif\x00\x00" + payload)
    if header is None:
        raise ValueError("PNG stream has no IHDR chunk")
    w, h, _, ct, _ = header
    oh, ow = (w, h) if orientation >= 5 else (h, w)
    return JpegGeometry(oh, ow, _CHANNELS[ct], orientation)


def parse(data: bytes) -> PngStream:
    """The stream's header, palette, orientation and inflated image data;
    raises ValueError where libpng stops with an error."""
    header, palette, orientation, idat = None, None, 1, []
    for kind, payload in _chunks(data):
        if header is None and kind != b"IHDR":
            raise ValueError("PNG stream does not start with IHDR")
        if kind == b"IHDR":
            header = _header(payload)
        elif kind == b"PLTE":
            if len(payload) % 3 or not 0 < len(payload) <= 768:
                raise ValueError("invalid PNG PLTE chunk")
            pal = np.zeros((256, 3), np.uint8)
            pal[:len(payload) // 3] = np.frombuffer(
                payload, np.uint8).reshape(-1, 3)[:, ::-1]  # RGB -> BGR
            palette = pal
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"eXIf":
            orientation = _exif_orientation(b"Exif\x00\x00" + payload)
        elif not kind[0] & 0x20 and kind != b"IEND":
            raise ValueError(f"PNG stream has an unknown critical chunk "
                             f"{kind!r}")
    w, h, bd, ct, inter = header
    if ct == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    z = zlib.decompressobj()
    try:
        raw = z.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from e
    st = PngStream(w, h, bd, ct, inter, palette, orientation, raw)
    passes = st.passes()
    need = passes[-1][-1] + passes[-1][5] * (passes[-1][6] + 1)
    if not z.eof or len(raw) < need:
        raise ValueError("truncated PNG stream: not enough image data")
    # libpng stops on a row whose filter type is not 0-4
    for _, _, _, _, _, ph, rb, off in passes:
        if max(raw[off:off + ph * (rb + 1):rb + 1]) > 4:
            raise ValueError("PNG image data: bad filter type")
    return st._replace(data=raw[:need])


# ---- the plain version ------------------------------------------------------

def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """One pass's [h, rowbytes] bytes, unfiltered: None, Sub and Up as
    array operations, Average and Paeth byte by byte."""
    rows = raw.reshape(h, rowbytes + 1)
    out = np.zeros((h, rowbytes), np.uint8)
    prior = np.zeros(rowbytes, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 2:
            cur = line + prior
        elif kind == 1 and rowbytes % bpp == 0:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint64).astype(np.uint8).reshape(-1)
        else:
            cur = bytearray(line.tobytes())
            up = prior.tolist()
            for x in range(rowbytes):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 1:
                    add = a
                elif kind == 3:
                    add = (a + b) >> 1
                else:
                    add = _paeth(a, b, up[x - bpp] if x >= bpp else 0)
                cur[x] = (cur[x] + add) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        out[y] = cur
        prior = out[y]
    return out


def _samples(rows: np.ndarray, w: int, channels: int, depth: int):
    """[h, w, channels] samples of unfiltered rows, as 8-bit values: a
    16-bit sample's high byte (v >> 8), sub-byte samples unpacked."""
    h = rows.shape[0]
    if depth == 16:
        return rows[:, :2 * w * channels:2].reshape(h, w, channels)
    if depth == 8:
        return rows[:, :w * channels].reshape(h, w, channels)
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = 1 << np.arange(depth - 1, -1, -1)
    return (bits * weights).sum(-1).astype(np.uint8)[..., None]


def _to_bgr(samples: np.ndarray, st: PngStream) -> np.ndarray:
    ct, depth = st.color_type, st.bit_depth
    if ct == 3:
        return st.palette[samples[..., 0]]
    if ct in (0, 4):
        g = samples[..., 0]
        if depth < 8:
            g = g * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(g[..., None], 3, axis=-1)
    return samples[..., 2::-1]  # RGB(A) -> BGR, alpha dropped


def decode_reference(st: PngStream) -> np.ndarray:
    """What the kernel computes, in numpy: the BGR uint8 [h, w, 3] image of
    a parsed stream (not oriented)."""
    raw = np.frombuffer(st.data, np.uint8)
    out = np.zeros((st.height, st.width, 3), np.uint8)
    for x0, y0, dx, dy, w, h, rb, off in st.passes():
        rows = _unfilter(raw[off:off + h * (rb + 1)], h, rb, st.bpp)
        out[y0::dy, x0::dx] = _to_bgr(
            _samples(rows, w, st.channels, st.bit_depth), st)
    return out


# ---- the card ---------------------------------------------------------------

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a library built from ``csrc/png.cu``."""
    lib.simvg_png_decode.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
    lib.simvg_png_decode.restype = ctypes.c_int
    return lib


def _library():
    global _lib
    if _lib is None:
        from simvg_tpu_torch.ops import _build

        _lib = bind(_build.load("png"))
    return _lib


def decode_cuda(st: PngStream, device) -> torch.Tensor:
    """The kernel's BGR uint8 [h, w, 3] image of a parsed stream on a CUDA
    device, on the current stream (not oriented): the inflated bytes are
    copied to the card (a fresh allocation: the kernel reads and writes
    aligned 4-byte words), unfiltered there in place and converted."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"decode_cuda needs a CUDA device, got {device}")
    lib = _library()
    raw = torch.frombuffer(bytearray(st.data), dtype=torch.uint8).to(device)
    pal = None if st.palette is None \
        else torch.from_numpy(st.palette).to(device)
    out = torch.empty(st.height, st.width, 3, dtype=torch.uint8,
                      device=device)
    with torch.cuda.device(device):
        rc = lib.simvg_png_decode(
            raw.data_ptr(), st.width, st.height, st.bit_depth,
            st.color_type, st.interlace, len(st.data),
            None if pal is None else pal.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"PNG decode kernel launch failed: CUDA error "
                           f"{rc}")
    decode.launches += 1
    return out


def decode(data: bytes, device="cuda") -> torch.Tensor:
    """BGR uint8 [h, w, 3] of a PNG stream, oriented by its eXIf, on
    ``device``: the kernel on a CUDA device, ``decode_reference`` on the
    CPU."""
    device = torch.device(device)
    st = parse(data)
    if device.type == "cuda":
        image = decode_cuda(st, device)
    elif device.type == "cpu":
        image = torch.from_numpy(decode_reference(st))
    else:
        raise ValueError(f"no PNG decoder for device {device}")
    return orient(image, st.orientation)


decode.launches = 0  # PNG kernel launches (CUDA route only)
