"""Stored samples -> BGR uint8 pixels, the per-pixel stage of every image
format the port reads besides JPEG, PNG and WebP (``bmp.py``, ``pnm.py``,
``sunras.py``, ``hdr.py``, ``gif.py``, ``tiff.py``).

Each of those modules parses its container on the host, undoes its
entropy or run-length coding there (RLE, LZW, Deflate, PackBits) and
describes the result as a ``Raster``: where each pixel's samples lie in a
byte buffer and how they become B, G and R.  ``convert`` turns a Raster
into the BGR uint8 [h, w, 3] image that ``cv2.imdecode(..., IMREAD_COLOR)``
gives: on a CUDA device ``csrc/image_convert.cu``'s kernel, a thread a
pixel; on the CPU ``convert_reference``, the same arithmetic in numpy.
TIFF's horizontal predictor (``undo_predictor_cuda``) is a prefix sum per
channel along each segment, a warp scan on the card.

What a Raster can say, and which format needs it:

- samples of 1, 2, 4, 8 or 16 bits (most significant bits first, a row
  padded to ``row_bytes``), float32 samples (PFM) or 4-byte RGBE pixels
  (Radiance HDR); 16-bit and float samples in either byte order;
- chunky (``spp`` samples a pixel) or planar (``planes``, one sample a
  pixel in each, ``plane_bytes`` apart) storage, in rows or in tiles
  (``tile``: TIFF), stored top-down or bottom-up (``flip``: BMP, PFM), in
  a given row order (``rows``: GIF's interlace);
- the samples' meaning: gray (replicated), colour (``order`` picks the
  samples of B, G and R), palette indices (``palette``, BGR; an index past
  its end gives 0), BMP bitfields (``masks``), float scaled by ``scale``
  and rounded as cv2's ``saturate_cast`` rounds, or RGBE; ``lut`` maps a
  gray or colour sample to its 8-bit value (a scaled maxval, an inverted
  gray, a 16-bit sample); colour may be premultiplied by an unassociated
  alpha sample as libtiff's RGBA reading does (``alpha``: TIFF);
- a frame inside a larger canvas with a transparent index, the canvas
  elsewhere in the background colour (GIF).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

GRAY, COLOR, PALETTE, BITFIELDS, FLOAT, RGBE = range(6)


class Raster(NamedTuple):
    data: bytes
    width: int
    height: int
    bits: int
    spp: int
    mode: int
    row_bytes: int
    offset: int = 0
    flip: bool = False
    planes: int = 1
    plane_bytes: int = 0
    big_endian: bool = False
    order: Tuple[int, int, int] = (2, 1, 0)
    lut: Optional[np.ndarray] = None  # uint8 [1 << bits]
    palette: Optional[np.ndarray] = None  # uint8 [n, 3], BGR
    masks: Tuple[Tuple[int, int], ...] = ()  # (shift, bits) of B, G, R
    scale: float = 1.0
    rows: Optional[np.ndarray] = None  # int32 [frame h]
    frame: Optional[Tuple[int, int, int, int]] = None  # x0, y0, w, h
    transparent: int = -1
    background: Tuple[int, int, int] = (0, 0, 0)
    tile: Optional[Tuple[int, int]] = None  # tile width, tile height
    alpha: int = -1  # sample of an unassociated alpha to premultiply by

    @property
    def frame_rect(self):
        return self.frame or (0, 0, self.width, self.height)

    def needed_bytes(self) -> int:
        """The bytes the description reads: a shorter buffer is a
        truncated image."""
        _, _, fw, fh = self.frame_rect
        if self.tile:
            tw, th = self.tile
            n = -(-fw // tw) * -(-fh // th)
            return self.offset + (self.planes - 1) * self.plane_bytes \
                + n * th * self.row_bytes
        return self.offset + (self.planes - 1) * self.plane_bytes \
            + fh * self.row_bytes


# ---- the plain version ------------------------------------------------------

def _sample_bits(buf: np.ndarray, base: np.ndarray, index: np.ndarray,
                 bits: int, big_endian: bool) -> np.ndarray:
    """Sample ``index`` of the rows that start at byte ``base``, as int64
    (float32 bits for 32-bit samples)."""
    if bits < 8:
        pos = index * bits
        byte = buf[base + (pos >> 3)].astype(np.int64)
        return (byte >> (8 - bits - (pos & 7))) & ((1 << bits) - 1)
    n = bits // 8
    at = base + index * n
    b = [buf[at + k].astype(np.int64) for k in range(n)]
    if big_endian:
        b = b[::-1]
    return sum(v << (8 * k) for k, v in enumerate(b))


def _round_u8(v: np.ndarray) -> np.ndarray:
    """cv2's saturate_cast<uchar> of float32: round half to even, clamp,
    NaN to 0."""
    r = np.rint(v.astype(np.float32))
    r = np.where(np.isnan(r), 0, r)
    return np.clip(r, 0, 255).astype(np.uint8)


def convert_reference(r: Raster) -> np.ndarray:
    """What the kernel computes, in numpy: the BGR uint8 [h, w, 3] image of
    a Raster."""
    buf = np.frombuffer(r.data, np.uint8)
    x0, y0, fw, fh = r.frame_rect
    out = np.empty((r.height, r.width, 3), np.uint8)
    out[:] = np.asarray(r.background, np.uint8)
    if fw <= 0 or fh <= 0:
        return out
    # the frame's pixels inside the canvas
    ys = np.arange(max(0, y0), min(r.height, y0 + fh))
    xs = np.arange(max(0, x0), min(r.width, x0 + fw))
    if not len(ys) or not len(xs):
        return out
    sy = (ys - y0).astype(np.int64)
    if r.rows is not None:
        sy = np.asarray(r.rows, np.int64)[sy]
    if r.flip:
        sy = fh - 1 - sy
    sx = (xs - x0).astype(np.int64)
    sy, sx = np.meshgrid(sy, sx, indexing="ij")
    if r.tile:
        tw, th = r.tile
        tile = (sy // th) * -(-fw // tw) + sx // tw
        base = r.offset + tile * (th * r.row_bytes) + (sy % th) * r.row_bytes
        sx = sx % tw
    else:
        base = r.offset + sy * r.row_bytes
    planar = r.planes > 1

    def sample(k):
        if planar:
            return _sample_bits(buf, base + k * r.plane_bytes, sx, r.bits,
                                r.big_endian)
        return _sample_bits(buf, base, sx * r.spp + k, r.bits, r.big_endian)

    if r.mode == GRAY:
        v = sample(0)
        g = r.lut[v] if r.lut is not None else v.astype(np.uint8)
        px = np.repeat(g[..., None], 3, -1)
    elif r.mode == COLOR:
        px = np.stack([sample(k) for k in r.order], -1)
        px = r.lut[px] if r.lut is not None else px.astype(np.uint8)
        if r.alpha >= 0:  # libtiff's (c * a + 127) / 255
            a = sample(r.alpha)
            a = (r.lut[a] if r.lut is not None else a)[..., None]
            px = ((px.astype(np.int64) * a + 127) // 255).astype(np.uint8)
    elif r.mode == PALETTE:
        v = sample(0)
        pal = np.zeros((max(len(r.palette), 1 << r.bits), 3), np.uint8)
        pal[:len(r.palette)] = r.palette
        px = pal[v]
        if r.transparent >= 0:
            px[v == r.transparent] = np.asarray(r.background, np.uint8)
    elif r.mode == BITFIELDS:
        p = sample(0)
        chans = []
        for shift, nb in r.masks:
            c = (p >> shift) & ((1 << nb) - 1)
            chans.append(c << (8 - nb) if nb <= 8 else c >> (nb - 8))
        px = np.stack(chans, -1).astype(np.uint8)
    elif r.mode == FLOAT:
        chans = [sample(k).astype(np.uint32).view(np.float32) for k in r.order]
        px = _round_u8(np.stack(chans, -1) * np.float32(r.scale))
    elif r.mode == RGBE:
        rgbe = np.stack([sample(k) for k in range(4)], -1)
        e = rgbe[..., 3]
        f = np.where(e > 0, np.ldexp(1.0, (e - 136).astype(np.int32)),
                     0.0).astype(np.float32)
        chans = [rgbe[..., k].astype(np.float32) * f for k in r.order]
        px = _round_u8(np.stack(chans, -1) * np.float32(255))
    else:
        raise ValueError(f"unknown raster mode {r.mode}")
    out[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1] = px
    return out


def undo_predictor_reference(data: bytes, segments: int, seg_bytes: int,
                             count: int, spp: int, bits: int,
                             big_endian: bool) -> bytes:
    """TIFF's horizontal predictor (2) undone in numpy: each of
    ``segments`` runs of ``count`` pixels (``spp`` samples of 8 or 16
    bits), ``seg_bytes`` apart, is summed along itself, sample by
    sample."""
    buf = np.frombuffer(data, np.uint8).copy()
    n = bits // 8
    rows = buf[:segments * seg_bytes].reshape(segments, seg_bytes)
    head = rows[:, :count * spp * n]
    if n == 1:
        v = head.reshape(segments, count, spp).astype(np.uint64)
        head[:] = np.cumsum(v, 1).astype(np.uint8).reshape(segments, -1)
    else:
        dt = np.dtype(">u2" if big_endian else "<u2")
        v = np.ascontiguousarray(head).view(dt).reshape(segments, count, spp)
        s = np.cumsum(v.astype(np.uint64), 1).astype(np.uint16).astype(dt)
        head[:] = s.reshape(segments, -1).view(np.uint8)
    return buf.tobytes()


# ---- the card ---------------------------------------------------------------

class _Desc(ctypes.Structure):
    """``struct Raster`` of ``csrc/image_convert.cu``."""

    _fields_ = [(name, kind) for name, kind in (
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("bits", ctypes.c_int), ("spp", ctypes.c_int),
        ("mode", ctypes.c_int), ("flip", ctypes.c_int),
        ("planes", ctypes.c_int), ("big_endian", ctypes.c_int),
        ("order", ctypes.c_int * 3), ("mask_shift", ctypes.c_int * 3),
        ("mask_bits", ctypes.c_int * 3), ("palette_size", ctypes.c_int),
        ("frame", ctypes.c_int * 4), ("transparent", ctypes.c_int),
        ("background", ctypes.c_int * 3), ("tile", ctypes.c_int * 2),
        ("alpha", ctypes.c_int),
        ("scale", ctypes.c_float), ("row_bytes", ctypes.c_longlong),
        ("offset", ctypes.c_longlong), ("plane_bytes", ctypes.c_longlong),
        ("nbytes", ctypes.c_longlong))]


_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a library built from
    ``csrc/image_convert.cu``."""
    vp = ctypes.c_void_p
    lib.simvg_image_convert.argtypes = [ctypes.POINTER(_Desc), vp, vp, vp, vp,
                                        vp, vp]
    lib.simvg_image_convert.restype = ctypes.c_int
    lib.simvg_tiff_predictor.argtypes = [vp, ctypes.c_int,
                                         ctypes.c_longlong] \
        + [ctypes.c_int] * 4 + [vp]
    lib.simvg_tiff_predictor.restype = ctypes.c_int
    lib.simvg_lzw_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_int, vp,
                                     ctypes.c_longlong]
    lib.simvg_lzw_decode.restype = ctypes.c_longlong
    return lib


def library():
    """``csrc/image_convert.cu``, built at first use: the kernels and the
    host LZW decoder (``lzw.py``'s card route)."""
    global _lib
    if _lib is None:
        from simvg_tpu_torch.ops import _build

        _lib = bind(_build.load("image_convert"))
    return _lib


def _device_array(a, device, dtype=torch.uint8):
    if a is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


def _check_cuda(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the image kernels need a CUDA device, got "
                         f"{device}")
    return device


def upload(data, device) -> torch.Tensor:
    """The bytes as a uint8 tensor on ``device``."""
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device) \
        if len(data) else torch.zeros(1, dtype=torch.uint8, device=device)


def convert_cuda(r: Raster, device, data: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The kernel's BGR uint8 [h, w, 3] image of a Raster on a CUDA device,
    on the current stream; ``data`` is the Raster's bytes already on the
    card (``undo_predictor_cuda``'s output), else they are copied there."""
    device = _check_cuda(device)
    lib = library()
    if data is None:
        data = upload(r.data, device)
    if data.numel() < r.needed_bytes():
        raise ValueError("raster description reads past its data")
    d = _Desc()
    d.width, d.height, d.bits, d.spp = r.width, r.height, r.bits, r.spp
    d.mode, d.flip, d.planes, d.big_endian = (r.mode, int(r.flip), r.planes,
                                              int(r.big_endian))
    d.order[:] = list(r.order)
    for k, (shift, nb) in enumerate(r.masks or ((0, 0),) * 3):
        d.mask_shift[k], d.mask_bits[k] = shift, nb
    d.palette_size = 0 if r.palette is None else len(r.palette)
    d.frame[:] = list(r.frame_rect)
    d.transparent = r.transparent
    d.background[:] = list(r.background)
    d.tile[:] = list(r.tile or (0, 0))
    d.alpha = r.alpha
    d.scale = r.scale
    d.row_bytes, d.offset, d.plane_bytes = r.row_bytes, r.offset, \
        r.plane_bytes
    d.nbytes = data.numel()
    lut = _device_array(r.lut, device)
    pal = _device_array(r.palette, device)
    rows = _device_array(r.rows, device, torch.int32)
    out = torch.empty(r.height, r.width, 3, dtype=torch.uint8, device=device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(device):
        rc = lib.simvg_image_convert(
            ctypes.byref(d), data.data_ptr(), ptr(lut), ptr(pal), ptr(rows),
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"image convert kernel launch failed: CUDA error "
                           f"{rc}")
    convert.launches += 1
    return out


def undo_predictor_cuda(data: bytes, device, segments: int, seg_bytes: int,
                        count: int, spp: int, bits: int,
                        big_endian: bool) -> torch.Tensor:
    """``undo_predictor_reference`` on the card: the bytes are copied
    there and each segment is scanned in place by a warp (a block's warps
    for a long segment); returns the card's buffer."""
    device = _check_cuda(device)
    lib = library()
    buf = upload(data, device)
    if segments * seg_bytes > buf.numel():
        raise ValueError("predictor segments past the data")
    with torch.cuda.device(device):
        rc = lib.simvg_tiff_predictor(
            buf.data_ptr(), segments, seg_bytes, count, spp, bits,
            int(big_endian), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"TIFF predictor kernel launch failed: CUDA error "
                           f"{rc}")
    convert.launches += 1
    return buf


def convert(r: Raster, device="cuda") -> torch.Tensor:
    """BGR uint8 [h, w, 3] of a Raster on ``device``: the kernel on a CUDA
    device, ``convert_reference`` on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return convert_cuda(r, device)
    if device.type == "cpu":
        return torch.from_numpy(convert_reference(r))
    raise ValueError(f"no image converter for device {device}")


convert.launches = 0  # image_convert.cu launches (CUDA route only)
