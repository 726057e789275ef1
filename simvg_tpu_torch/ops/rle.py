"""COCO run-length-encoded mask operations (the port's numpy copy of
``simvg_tpu/ops/rle.py``; importing that module runs
``simvg_tpu/ops/__init__.py``, which imports JAX).

- ``encode``/``decode`` of COCO's compressed RLE string (column-major,
  the difference-coded base-6 varint of pycocotools), byte for byte the
  JAX module's;
- ``frPyObjects``/``merge`` for polygon ground truth, rasterised by
  ``raster.fill_poly`` (``cv2.fillPoly``'s pixels; the card's machine has no
  cv2);
- ``iou`` for the aligned mask IoU of evaluation.

JAX's C fast path (``simvg_tpu/native/``) is host C that gives the same
strings; the port keeps numpy only.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from .raster import fill_poly

RLE = Dict[str, Union[bytes, str, Sequence[int]]]


def _encode_counts(counts: np.ndarray) -> bytes:
    """COCO compressed RLE: difference-coded base-6 varint (chars
    0x30 + 6 bits/char, continuation in bit 5)."""
    out = bytearray()
    counts = np.asarray(counts, np.int64)
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            bits = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (bits & 0x10))
                        or (x == -1 and (bits & 0x10)))
            if more:
                bits |= 0x20
            out.append(bits + 48)
    return bytes(out)


def _decode_counts(s: bytes) -> np.ndarray:
    counts: List[int] = []
    i, n = 0, len(s)
    while i < n:
        x, k, more = 0, 0, True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.int64)


def encode(mask: np.ndarray) -> RLE:
    """Binary mask [H, W] (any int/bool dtype) -> compressed RLE dict."""
    h, w = mask.shape
    flat = np.asfortranarray(mask).reshape(-1, order="F").astype(bool)
    # run lengths, starting with a (possibly zero) run of 0s
    changes = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], changes, [flat.size]]))
    if flat.size and flat[0]:
        runs = np.concatenate([[0], runs])
    if flat.size == 0:
        runs = np.asarray([0], np.int64)
    return {"size": [int(h), int(w)], "counts": _encode_counts(runs)}


def decode(rle: RLE) -> np.ndarray:
    """Compressed (bytes/str counts) or uncompressed (list counts) RLE
    -> uint8 mask [H, W]."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = counts.encode()
    if isinstance(counts, (bytes, bytearray)):
        runs = _decode_counts(bytes(counts))
    else:
        runs = np.asarray(counts, np.int64)
    vals = np.zeros(len(runs), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, runs)
    if flat.size != h * w:
        raise ValueError(f"RLE of {flat.size} pixels for a {h}x{w} mask")
    return flat.reshape((h, w), order="F")


def area(rle: RLE) -> int:
    return int(decode(rle).sum())


def merge(rles: List[RLE]) -> RLE:
    """Union of masks (a multi-part polygon's parts)."""
    out = decode(rles[0])
    for r in rles[1:]:
        out = np.logical_or(out, decode(r))
    return encode(out.astype(np.uint8))


def frPyObjects(polys, h: int, w: int) -> List[RLE]:
    """Polygons [[x0, y0, x1, y1, ...], ...] -> one RLE each, rasterised
    at the rounded vertices."""
    out = []
    for p in polys:
        pts = np.asarray(p, np.float64).reshape(-1, 2)
        mask = np.zeros((h, w), np.uint8)
        fill_poly(mask, [np.round(pts).astype(np.int32)], 1)
        out.append(encode(mask))
    return out


def iou(dt: List[RLE], gt: List[RLE], iscrowd=None) -> np.ndarray:
    """Pairwise mask IoU [len(dt), len(gt)] (maskUtils.iou semantics;
    iscrowd ignores the union term for crowd GT)."""
    if iscrowd is None:
        iscrowd = [0] * len(gt)
    out = np.zeros((len(dt), len(gt)))
    dts = [decode(d).astype(bool) for d in dt]
    gts = [decode(g).astype(bool) for g in gt]
    for i, d in enumerate(dts):
        for j, g in enumerate(gts):
            inter = np.logical_and(d, g).sum()
            denom = d.sum() if iscrowd[j] else np.logical_or(d, g).sum()
            out[i, j] = inter / denom if denom else 0.0
    return out
