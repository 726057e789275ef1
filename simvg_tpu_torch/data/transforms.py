"""Sample transforms, split into geometry on the host and pixels on the card
(port of ``simvg_tpu/data/transforms.py``).

The JAX module resizes, crops and pads numpy images with cv2 on the host.
Here each transform computes on the host, with the same arithmetic and the
same random draws, every size, crop, scale factor and box, and appends the
pixel work it implies to ``s["pixel_ops"]``: ``("resize", (h, w))`` or
``("crop", (y0, y1, x0, x1))``.  ``image_ops.render`` replays that list on
the decoded image on the card.  No transform touches a pixel.

A sample is a plain dict, with the JAX module's keys except ``img``:
``img_bytes`` (the JPEG file), ``img_shape``/``ori_shape``/``pad_shape``
((h, w, 3) tuples, as ``img.shape`` gives them there), ``scale_factor``,
``gt_bbox``, ``pixel_ops``, and after ``Normalize`` ``img_norm_cfg``.

A mask (``with_mask``: ``gt_mask``, a small uint8 host array, and its RLE
``gt_mask_rle``) stays on the host: it feeds host RLE and the vertex
sampler.  It follows every geometric op as the JAX module's does, resized
with ``cv2.INTER_NEAREST``'s index rule (``ops/raster.py``), cropped and
padded in numpy, its RLE re-encoded after each op.  ``SampleMaskVertices``
takes the mass centre and the vertices of the mask's largest contour with
``ops/raster.py``'s copy of OpenCV's contour functions.
"""

from __future__ import annotations

import math
import random
from typing import Optional, Sequence, Tuple

import numpy as np

from simvg_tpu_torch.ops import raster
from simvg_tpu_torch.ops import rle as rle_ops


def _rescale_size(w: int, h: int, scale: float) -> Tuple[int, int]:
    """mmcv rescale_size rounding: int(dim * scale + 0.5)."""
    return int(w * scale + 0.5), int(h * scale + 0.5)


def _resize_to(s: dict, new_w: int, new_h: int) -> None:
    """Records a bilinear resize of the current image to (new_h, new_w)."""
    s["pixel_ops"].append(("resize", (new_h, new_w)))
    s["img_shape"] = (new_h, new_w, 3)


def _resize_mask(s: dict, wh) -> None:
    """Resizes the GT bitmap mask (nearest) and refreshes its RLE."""
    s["gt_mask"] = raster.resize_nearest(s["gt_mask"], wh)
    s["gt_mask_rle"] = rle_ops.encode(s["gt_mask"])


def _has_mask(s: dict) -> bool:
    return bool(s.get("with_mask")) and "gt_mask" in s


def _imrescale(s: dict, scale: float) -> None:
    h, w = s["img_shape"][:2]
    nw, nh = _rescale_size(w, h, scale)
    _resize_to(s, nw, nh)


class Resize:
    """Resize image + boxes.  ``img_scale`` is (w, h); keep_ratio rescales
    the long side."""

    def __init__(self, img_scale: Tuple[int, int], keep_ratio: bool = False):
        self.img_scale = img_scale
        self.keep_ratio = keep_ratio

    def __call__(self, s: dict) -> dict:
        if self.keep_ratio:
            # reference quirk kept: the keep_ratio branch computes the
            # box scale against ORI_SHAPE, valid because no shipped
            # pipeline puts an op that changes the image size before a
            # keep_ratio Resize.
            h, w = s["ori_shape"][:2]
            scale = min(self.img_scale[0] / w, self.img_scale[1] / h)
            new_w, new_h = _rescale_size(w, h, scale)
        else:
            # box scale relative to the CURRENT image: boxes are in
            # current-image coordinates when an earlier op (e.g.
            # LargeScaleJitter) already changed the size.
            h, w = s["img_shape"][:2]
            new_w, new_h = self.img_scale
        _resize_to(s, new_w, new_h)
        w_scale, h_scale = new_w / w, new_h / h
        sf = np.asarray([w_scale, h_scale, w_scale, h_scale], np.float32)
        s["pad_shape"] = s["img_shape"]
        s["scale_factor"] = sf
        if s.get("with_bbox"):
            gb = s["gt_bbox"]
            if isinstance(gb, list):
                s["gt_bbox"] = [b * sf for b in gb]
            else:
                s["gt_bbox"] = gb * sf
        if _has_mask(s):
            _resize_mask(s, (new_w, new_h))
        return s


class Normalize:
    """(img - mean) / std with BGR->RGB first; applied on the card by
    ``image_ops.render``."""

    def __init__(self, mean: Sequence[float], std: Sequence[float],
                 to_rgb: bool = True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, s: dict) -> dict:
        s["img_norm_cfg"] = dict(mean=self.mean, std=self.std,
                                 to_rgb=self.to_rgb)
        return s


class Pad:
    """Bottom/right padding to a fixed size, a divisor or a square; the
    pixels are written by ``image_ops`` when the batch canvas is filled."""

    def __init__(self, size: Optional[Tuple[int, int]] = None,
                 size_divisor: Optional[int] = None,
                 pad_to_square: bool = False,
                 pad_to_square_size: Tuple[int, int] = (640, 640),
                 pad_val: float = 0.0):
        self.size = size
        self.size_divisor = size_divisor
        self.pad_to_square = pad_to_square
        self.pad_to_square_size = pad_to_square_size
        self.pad_val = pad_val

    def __call__(self, s: dict) -> dict:
        h, w = s["img_shape"][:2]
        if self.pad_to_square:
            th, tw = self.pad_to_square_size
        elif self.size is not None:
            th, tw = self.size
        else:
            d = self.size_divisor
            th, tw = ((h + d - 1) // d) * d, ((w + d - 1) // d) * d
        s["pad_shape"] = (th, tw, 3)
        s["pad_val"] = self.pad_val
        if _has_mask(s):
            m = np.zeros((th, tw), s["gt_mask"].dtype)
            m[:h, :w] = s["gt_mask"]
            s["gt_mask"] = m
            s["gt_mask_rle"] = rle_ops.encode(m)
        return s


class LargeScaleJitter:
    """Scale jitter in [jitter_min, jitter_max] of the keep-ratio fit to
    out_max_size; when upscaled (>1.0), take an IoU-constrained random
    crop of the fit size.  The draws and the box arithmetic are the JAX
    module's, call for call."""

    def __init__(self, out_max_size: int = 640, jitter_min: float = 0.3,
                 jitter_max: float = 1.4, min_iou_thr: float = 0.3,
                 crop_iou_thr: Sequence[float] = (0.5, 0.6, 0.7, 0.8, 0.9),
                 jitter_times: int = 100,
                 rng: Optional[random.Random] = None):
        self.out_max_size = out_max_size
        self.jitter_min = jitter_min
        self.jitter_max = jitter_max
        self.min_iou_thr = min_iou_thr
        self.crop_iou_thr = tuple(crop_iou_thr)
        self.jitter_times = jitter_times
        self.rng = rng or random

    @staticmethod
    def _crop_cover(crop: np.ndarray, gt: np.ndarray) -> float:
        """Fraction of gt covered by crop, gaps clamped at 0 (the JAX
        module's deviation from the reference: a crop diagonally disjoint
        from the box scores 0, not a positive product of two negative
        gaps)."""
        lt = np.maximum(crop[:2], gt[:2])
        rb = np.minimum(crop[2:], gt[2:])
        wh = np.maximum(rb - lt, 0.0)
        overlap = wh[0] * wh[1]
        area = (gt[2] - gt[0]) * (gt[3] - gt[1])
        return float(overlap / max(area, 1e-12))

    @staticmethod
    def _mask_cover(crop: np.ndarray, gt_mask: np.ndarray) -> float:
        """Fraction of the mask's area inside the crop rectangle: the
        mask-only (with_bbox=False) crop-acceptance criterion."""
        x0, y0, x1, y1 = np.maximum(crop, 0.0).astype(np.int64)
        inside = float(gt_mask[y0:y1, x0:x1].sum())
        return inside / max(float(gt_mask.sum()), 1e-12)

    def __call__(self, s: dict) -> dict:
        h, w = s["ori_shape"][:2]
        # per-sample deterministic stream when the dataset provides one
        # (thread-order independent); else the instance/global RNG
        rng = s.get("aug_rng") or self.rng
        rand_scale = (self.jitter_min + rng.random()
                      * (self.jitter_max - self.jitter_min))
        fit_scale = self.out_max_size / max(h, w)
        _imrescale(s, rand_scale * fit_scale)
        new_h, new_w = s["img_shape"][:2]
        if _has_mask(s):
            s["gt_mask"] = raster.resize_nearest(s["gt_mask"],
                                                 (new_w, new_h))

        gt_bbox = s.get("gt_bbox")
        multi = isinstance(gt_bbox, list)
        factor = np.asarray(
            [new_w / w, new_h / h, new_w / w, new_h / h], np.float64
        )
        if s.get("with_bbox"):
            if multi:
                gt_bbox = [b * factor for b in gt_bbox]
            else:
                gt_bbox = gt_bbox * factor

        if rand_scale > 1.0:
            w_out, h_out = _rescale_size(w, h, fit_scale)
            # the crop-acceptance criterion: bbox coverage when boxes
            # exist, else mask coverage; a GRefCOCO no-target sample (empty
            # bbox list) has nothing to keep: any crop is acceptable
            # (full-image reference box)
            use_mask = not s.get("with_bbox") and _has_mask(s)
            if use_mask:
                ref_box = None
            elif multi and len(gt_bbox) == 0:
                ref_box = np.asarray([0.0, 0.0, new_w, new_h])
            else:
                ref_box = gt_bbox[0] if multi else gt_bbox
            flag, best_idx, best_iou, history = False, -1, 0.0, []
            offset = (0.0, 0.0)
            for i, iou_thr in enumerate(self.crop_iou_thr[::-1]):
                if flag:
                    break
                for it in range(self.jitter_times):
                    offset = (rng.random() * (new_w - w_out),
                              rng.random() * (new_h - h_out))
                    crop = np.asarray(
                        [offset[0], offset[1], offset[0] + w_out,
                         offset[1] + h_out]
                    )
                    iou = (self._mask_cover(crop, s["gt_mask"]) if use_mask
                           else self._crop_cover(crop, ref_box))
                    history.append((crop, offset))
                    if iou > best_iou:
                        best_iou = iou
                        best_idx = len(history) - 1
                    if iou >= iou_thr:
                        flag = True
                        break
            if not flag:
                if best_iou < self.min_iou_thr:
                    # give up: rescale back to the keep-ratio fit, which
                    # the downstream Pad/collate canvas can hold
                    _resize_to(s, w_out, h_out)
                    if _has_mask(s):
                        _resize_mask(s, (w_out, h_out))
                    back = np.asarray(
                        [w_out / new_w, h_out / new_h,
                         w_out / new_w, h_out / new_h], np.float64)
                    if s.get("with_bbox"):
                        if multi:
                            gt_bbox = [b * back for b in gt_bbox]
                        else:
                            gt_bbox = gt_bbox * back
                        s["gt_bbox"] = self._clip(gt_bbox, w_out, h_out,
                                                  multi)
                    s["pad_shape"] = s["img_shape"]
                    s["scale_factor"] = np.asarray(
                        [w_out / w, h_out / h, w_out / w, h_out / h],
                        np.float32)
                    return s
                crop, offset = history[best_idx]
            # the JAX module's uint32 truncation of the crop, then a numpy
            # slice, which stops at the image's edge
            x0, y0, x1, y1 = (int(c) for c in crop.astype(np.uint32))
            y1, x1 = min(y1, new_h), min(x1, new_w)
            s["pixel_ops"].append(("crop", (y0, y1, x0, x1)))
            if _has_mask(s):
                s["gt_mask"] = s["gt_mask"][y0:y1, x0:x1]
            new_h, new_w = max(y1 - y0, 0), max(x1 - x0, 0)
            s["img_shape"] = (new_h, new_w, 3)
            shift = np.asarray(
                [offset[0], offset[1], offset[0], offset[1]]
            )
            if s.get("with_bbox"):
                if multi:
                    gt_bbox = [b - shift for b in gt_bbox]
                else:
                    gt_bbox = gt_bbox - shift

        if s.get("with_bbox"):
            s["gt_bbox"] = self._clip(gt_bbox, new_w, new_h, multi)
        if _has_mask(s):
            s["gt_mask_rle"] = rle_ops.encode(s["gt_mask"])
        s["pad_shape"] = s["img_shape"]
        s["scale_factor"] = np.asarray(
            [new_w / w, new_h / h, new_w / w, new_h / h], np.float32
        )
        return s

    @staticmethod
    def _clip(gt_bbox, w, h, multi):
        def clip_one(b):
            b = b.copy()
            b[0::2] = np.clip(b[0::2], 0, w - 1)
            b[1::2] = np.clip(b[1::2], 0, h - 1)
            return b

        return [clip_one(b) for b in gt_bbox] if multi else clip_one(
            gt_bbox
        )


class SampleMaskVertices:
    """The contour vertex sampler of SeqTR: the mass centre of the mask's
    largest contour and num_ray contour points, [2, num_ray] padded with -1.
    With center_sampling and the centre inside the contour, the points are
    the farthest contour hits at evenly spaced ray angles (+-5 degrees of
    fallback); otherwise an even stride over the contour, whose point order
    and start pixel are OpenCV's."""

    def __init__(self, center_sampling: bool = False, num_ray: int = 18):
        if num_ray <= 0:
            raise ValueError(f"num_ray must be positive, got {num_ray}")
        self.center_sampling = center_sampling
        self.num_ray = num_ray

    def __call__(self, s: dict) -> dict:
        if not s.get("with_mask"):
            raise ValueError("SampleMaskVertices needs with_mask")
        mask = np.ascontiguousarray(s["gt_mask"], np.uint8)
        center, contour, keep = self._mass_center(mask)
        s["gt_mask_vertices"] = self._sample(
            center, contour, keep, s.get("pad_shape", mask.shape)[:2])
        s["mass_center"] = center
        return s

    def _mass_center(self, mask):
        contours = raster.find_contours(mask)
        if not contours:
            return np.asarray([-1.0, -1.0]), np.zeros((0, 2)), False
        contour = max(contours, key=raster.contour_area)
        m00, m10, m01 = raster.contour_moments(contour)
        if m00 > 0.0:
            return np.asarray([m10 / m00, m01 / m00]), contour, True
        return np.asarray([-1.0, -1.0]), contour, False

    def _sample(self, center, contour, keep, max_shape):
        verts = np.full((2, self.num_ray), -1, np.float32)
        if not keep:
            return verts
        n = contour.shape[0]
        if n <= self.num_ray:
            verts[:, :n] = contour.T
            return verts
        inside = raster.point_polygon_test(
            contour, tuple(float(c) for c in center)) > 0
        if self.center_sampling and inside:
            dx = contour[:, 0] - center[0]
            dy = contour[:, 1] - center[1]
            ang = np.arctan2(dy, dx) * 180 / np.pi
            ang[ang < 0] += 360
            ang = ang.astype(np.uint32)
            dist = np.sqrt(dx ** 2 + dy ** 2)
            hit_ang, hit_dist = [], []
            # exactly num_ray evenly spaced rays
            ray_angles = (np.linspace(0, 360, self.num_ray, endpoint=False)
                          .astype(np.int64))
            for a in ray_angles:
                for inc in (0, 1, -1, 2, -2, 3, -3, 4, -4, 5, -5):
                    aa = a + inc
                    if (ang == aa).any():
                        hit_ang.append(aa)
                        hit_dist.append(dist[ang == aa].max())
                        break
            rad = np.asarray(hit_ang) / 180 * np.pi
            vx = center[0] + np.asarray(hit_dist) * np.cos(rad)
            vy = center[1] + np.asarray(hit_dist) * np.sin(rad)
        else:
            stride = math.ceil(n / self.num_ray)
            vx = contour[::stride, 0]
            vy = contour[::stride, 1]
        if max_shape is not None:
            vx = np.clip(vx, 0, max_shape[1] - 1)
            vy = np.clip(vy, 0, max_shape[0] - 1)
        pts = np.vstack((vx, vy)).astype(np.float32)
        verts[:, :pts.shape[1]] = pts
        return verts


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, s: dict) -> dict:
        for t in self.transforms:
            s = t(s)
        return s
