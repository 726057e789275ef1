"""JPEG files for the data pipeline: header geometry on the host, decode and
encode on the card through nvJPEG (``csrc/jpeg.cu``), and a CPU route
through ``cv2`` for the tests.

The JAX package reads an image with ``cv2.imread(path, IMREAD_COLOR)``
(``simvg_tpu/data/datasets.py:156-161``): BGR uint8, grayscale replicated to
three channels, the EXIF orientation applied.  Here:

- ``jpeg_geometry(data)`` reads the height, width, component count and EXIF
  orientation from the headers, without decoding: the dataset's geometry
  (boxes, scale factors, crops) needs nothing else;
- ``decode(data, device)`` gives the BGR uint8 [h, w, 3] tensor, oriented
  as ``cv2.imread`` orients it.  On a CUDA device it runs nvJPEG on the
  current stream; with ``device="cpu"`` it takes ``cv2.imdecode`` (imported
  there, and only there);
- ``encode(image, quality)`` gives the bytes of a JPEG file (4:2:0 chroma
  for colour, as ``cv2.imwrite`` writes them): nvJPEG for a CUDA tensor,
  ``cv2.imencode`` for a CPU one.

nvJPEG's IDCT and chroma upsampling are not libjpeg's, so the card's pixels
differ slightly from cv2's for the same file (PERF.md gives the measured
divergence).  The library is built from ``csrc/jpeg.cu`` at first use.
"""

from __future__ import annotations

import contextlib
import ctypes
import struct
import threading
from typing import NamedTuple

import torch

_SOF_MARKERS = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                0xCD, 0xCE, 0xCF}
_EXIF_ORIENTATION_TAG = 0x0112


class JpegGeometry(NamedTuple):
    """The decoded image's (height, width) after the EXIF orientation, the
    component count and the orientation (1-8; 1 when the file has
    none)."""

    height: int
    width: int
    components: int
    orientation: int


def _exif_orientation(app1: bytes) -> int:
    """The orientation tag of IFD0 in an APP1 ``Exif`` payload, else 1."""
    if not app1.startswith(b"Exif\x00\x00") or len(app1) < 14:
        return 1
    tiff = app1[6:]
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None:
        return 1
    (ifd,) = struct.unpack_from(order + "I", tiff, 4)
    if ifd + 2 > len(tiff):
        return 1
    (count,) = struct.unpack_from(order + "H", tiff, ifd)
    for k in range(count):
        entry = ifd + 2 + 12 * k
        if entry + 12 > len(tiff):
            break
        tag, typ, _ = struct.unpack_from(order + "HHI", tiff, entry)
        if tag == _EXIF_ORIENTATION_TAG and typ == 3:  # SHORT
            (value,) = struct.unpack_from(order + "H", tiff, entry + 8)
            return value if 1 <= value <= 8 else 1
    return 1


def jpeg_geometry(data: bytes) -> JpegGeometry:
    """Reads the frame header (SOFn) and the EXIF orientation of a JPEG
    stream; raises ValueError on a stream that is not a JPEG."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream (no SOI marker)")
    i, orientation, frame = 2, 1, None
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            raise ValueError(f"corrupt JPEG marker at byte {i}")
        marker = data[i + 1]
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:  # no length
            i += 2
            continue
        (seg_len,) = struct.unpack_from(">H", data, i + 2)
        payload = data[i + 4:i + 2 + seg_len]
        if marker == 0xE1 and orientation == 1:
            orientation = _exif_orientation(payload)
        elif marker in _SOF_MARKERS:
            _, h, w, comps = struct.unpack_from(">BHHB", payload, 0)
            frame = (h, w, comps)
        if marker == 0xDA or frame is not None:  # APPn precede the frame
            break
        i += 2 + seg_len
    if frame is None:
        raise ValueError("JPEG stream has no frame header")
    h, w, comps = frame
    oh, ow = (w, h) if orientation >= 5 else (h, w)
    return JpegGeometry(oh, ow, comps, orientation)


def orient(image: torch.Tensor, orientation: int) -> torch.Tensor:
    """Applies an EXIF orientation to an [h, w, C] image as OpenCV's
    ApplyExifOrientation does (flip codes 1: horizontal, 0: vertical, -1:
    both; 5-8 transpose first)."""
    if orientation >= 5:
        image = image.transpose(0, 1)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 5: (), 6: (1,), 7: (0, 1),
             8: (0,)}.get(orientation, ())
    if flips:
        image = image.flip(flips)
    return image.contiguous()


class _NvJpeg:
    """The nvJPEG library: one handle for the process, and decoder states
    handed to one decoding thread at a time."""

    def __init__(self):
        from simvg_tpu_torch.ops import _build

        lib = _build.load("jpeg")
        vp, sz, ip = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
        pp = ctypes.POINTER(ctypes.c_void_p)
        ipp = ctypes.POINTER(ctypes.c_int)
        for name, args in (
                ("simvg_jpeg_create", [pp]),
                ("simvg_jpeg_state_create", [vp, pp]),
                ("simvg_jpeg_info", [vp, ctypes.c_char_p, sz, ipp, ipp,
                                     ipp]),
                ("simvg_jpeg_decode", [vp, vp, ctypes.c_char_p, sz, ip, vp,
                                       sz, vp]),
                ("simvg_jpeg_encode", [vp, vp, ip, ip, ip, ip,
                                       ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_size_t),
                                       vp])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        self.lib = lib
        self.handle = ctypes.c_void_p()
        self._check(lib.simvg_jpeg_create(ctypes.byref(self.handle)),
                    "create")
        self._free_states: list = []
        self._states_lock = threading.Lock()

    @staticmethod
    def _check(status: int, what: str) -> None:
        if status >= 1000:
            raise RuntimeError(f"nvJPEG {what}: CUDA error {status - 1000}")
        if status:
            raise RuntimeError(f"nvJPEG {what}: nvjpegStatus_t {status}")

    @contextlib.contextmanager
    def state(self):
        """A decoder state that no other thread uses meanwhile; states are
        kept for reuse, one for each thread that ever decoded at once."""
        with self._states_lock:
            st = self._free_states.pop() if self._free_states else None
        if st is None:
            st = ctypes.c_void_p()
            self._check(self.lib.simvg_jpeg_state_create(
                self.handle, ctypes.byref(st)), "state")
        try:
            yield st
        finally:
            with self._states_lock:
                self._free_states.append(st)

    def decode(self, data: bytes, device: torch.device) -> torch.Tensor:
        comps, h, w = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        self._check(self.lib.simvg_jpeg_info(
            self.handle, data, len(data), ctypes.byref(comps),
            ctypes.byref(h), ctypes.byref(w)), "info")
        if comps.value not in (1, 3):
            raise ValueError(f"JPEG with {comps.value} components is not "
                             "supported (grayscale or YCbCr only)")
        gray = comps.value == 1
        out = torch.empty((h.value, w.value) + (() if gray else (3,)),
                          dtype=torch.uint8, device=device)
        decode.launches += 1
        with self.state() as st:
            self._check(self.lib.simvg_jpeg_decode(
                self.handle, st, data, len(data), int(gray),
                out.data_ptr(), w.value * (1 if gray else 3),
                torch.cuda.current_stream(device).cuda_stream), "decode")
        return out.unsqueeze(-1).expand(-1, -1, 3) if gray else out

    def encode(self, image: torch.Tensor, quality: int) -> bytes:
        gray = image.dim() == 2
        h, w = image.shape[:2]
        cap = ctypes.c_size_t(h * w * 3 + 65536)
        buf = ctypes.create_string_buffer(cap.value)
        encode.launches += 1
        self._check(self.lib.simvg_jpeg_encode(
            self.handle, image.data_ptr(), h, w, int(gray), quality, buf,
            ctypes.byref(cap),
            torch.cuda.current_stream(image.device).cuda_stream), "encode")
        return buf.raw[:cap.value]


_lock = threading.Lock()
_nvjpeg = None


def _library() -> _NvJpeg:
    global _nvjpeg
    with _lock:
        if _nvjpeg is None:
            _nvjpeg = _NvJpeg()
        return _nvjpeg


def decode(data: bytes, device="cuda") -> torch.Tensor:
    """BGR uint8 [h, w, 3] of a JPEG stream, EXIF-oriented, on ``device``.
    A CUDA device decodes with nvJPEG on the current stream; ``"cpu"``
    decodes with cv2 (the route of the CPU tests)."""
    device = torch.device(device)
    geo = jpeg_geometry(data)
    if device.type == "cuda":
        image = _library().decode(data, device)
    elif device.type == "cpu":
        import cv2
        import numpy as np

        arr = cv2.imdecode(np.frombuffer(data, np.uint8),
                           cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        if arr is None:
            raise ValueError("cv2 could not decode the JPEG stream")
        image = torch.from_numpy(arr)
    else:
        raise ValueError(f"no JPEG decoder for device {device}")
    return orient(image, geo.orientation)


decode.launches = 0  # nvJPEG decodes (CUDA route only)


def encode(image: torch.Tensor, quality: int = 95) -> bytes:
    """A JPEG file of a uint8 image: BGR [h, w, 3] (4:2:0 chroma) or
    grayscale [h, w].  nvJPEG for a CUDA tensor, cv2 for a CPU one."""
    if image.dtype != torch.uint8 or image.dim() not in (2, 3) or (
            image.dim() == 3 and image.shape[2] != 3):
        raise ValueError(f"encode takes uint8 [h, w, 3] or [h, w], got "
                         f"{image.dtype} {tuple(image.shape)}")
    image = image.contiguous()
    if image.is_cuda:
        return _library().encode(image, quality)
    import cv2

    ok, buf = cv2.imencode(".jpg", image.numpy(),
                           [cv2.IMWRITE_JPEG_QUALITY, quality])
    if not ok:
        raise ValueError("cv2 could not encode the image")
    return buf.tobytes()


encode.launches = 0  # nvJPEG encodes (CUDA route only)
