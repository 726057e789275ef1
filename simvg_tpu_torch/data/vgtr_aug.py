"""VGTR legacy augmentation (port of ``simvg_tpu/data/vgtr_aug.py``;
reference simvg/datasets/pipelines/vgtr_aug.py:16-62).

The chain, as the JAX module runs it:

    HSV S/V jitter -> colour jitter -> 50% 3x3 Gaussian blur
    -> letterbox to a square canvas (INTER_AREA, constant border)
    -> random affine (rotate, scale, translate; the box warped through
    the matrix) -> 50% horizontal flip with "left" and "right" swapped in
    the expression.

The host draws from the sample's ``aug_rng`` in JAX's order (nine draws a
sample) and computes, in the same float64 arithmetic, every size, fill,
matrix, box and the flipped phrase; it touches no pixel.  The pixel work
is recorded in ``s["pixel_ops"]`` (``("hsv", ...)``, ``("jitter", ...)``,
``("blur", None)``, ``("resize_area", ...)``, ``("border", ...)``,
``("warp", ...)``, ``("flip", None)``) and replayed on the decoded image by
``image_ops.apply_pixel_ops``, on the card, in OpenCV's 8-bit arithmetic.
The dataset re-tokenises the expression when the flip rewrote it.
"""

from __future__ import annotations

import math
import random as _random

import numpy as np

_FILL = (123.7, 116.3, 103.5)
# OpenCV's uint8 border value of _FILL: saturate_cast, half to even
FILL_U8 = tuple(int(np.rint(v)) for v in _FILL)


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the 2x3 float64 matrix."""
    a = angle * (math.pi / 180)
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    cx, cy = (float(np.float32(c)) for c in center)
    return np.asarray([[alpha, beta, (1 - alpha) * cx - beta * cy],
                       [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(m: np.ndarray) -> np.ndarray:
    """The inverse of a 2x3 affine matrix as ``cv2.warpAffine`` computes it
    (without WARP_INVERSE_MAP), in float64."""
    m = [float(v) for v in np.asarray(m, np.float64).reshape(6)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1] = a11, m[1] * -d
    m[3], m[4] = m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.asarray(m).reshape(2, 3)


def _letterbox(s: dict, bbox: np.ndarray, size: int) -> np.ndarray:
    """Keep-ratio resize and centre pad to a square canvas (reshape,
    vgtr_aug.py:64-81)."""
    h, w = s["img_shape"][:2]
    ratio = float(size) / max(h, w)
    new_w, new_h = round(w * ratio), round(h * ratio)
    dw, dh = (size - new_w) / 2, (size - new_h) / 2
    s["pixel_ops"].append(("resize_area", (new_h, new_w)))
    top, bottom = round(dh - 0.1), round(dh + 0.1)
    left, right = round(dw - 0.1), round(dw + 0.1)
    s["pixel_ops"].append(("border", (top, bottom, left, right, FILL_U8)))
    s["img_shape"] = (new_h + top + bottom, new_w + left + right, 3)
    bbox = bbox.copy()
    bbox[0::2] = bbox[0::2] * ratio + dw
    bbox[1::2] = bbox[1::2] * ratio + dh
    return bbox


def _random_affine(s: dict, bbox: np.ndarray, rng, degrees=(-15, 15),
                   translate=(0.15, 0.15), scale=(0.75, 1.25)) -> np.ndarray:
    """Rotate, scale, translate; the box's corners warped through the
    matrix and re-boxed (random_affine + wrap_points, vgtr_aug.py:96-221,
    276-315)."""
    size = s["img_shape"][0]
    a = rng.random() * (degrees[1] - degrees[0]) + degrees[0]
    sc = rng.random() * (scale[1] - scale[0]) + scale[0]
    rot = np.eye(3)
    rot[:2] = rotation_matrix_2d((size / 2, size / 2), a, sc)
    trans = np.eye(3)
    trans[0, 2] = (rng.random() * 2 - 1) * translate[0] * size
    trans[1, 2] = (rng.random() * 2 - 1) * translate[1] * size
    m = trans @ rot
    s["pixel_ops"].append(("warp", (invert_affine(m[:2]), (size, size),
                                    FILL_U8)))
    x0, y0, x1, y1 = bbox[:4]
    corners = np.asarray([[x0, y0, 1], [x1, y1, 1],
                          [x0, y1, 1], [x1, y0, 1]], np.float64)
    warped = corners @ m.T
    nb = np.asarray([warped[:, 0].min(), warped[:, 1].min(),
                     warped[:, 0].max(), warped[:, 1].max()])
    nb[0::2] = np.clip(nb[0::2], 0, size - 1)
    nb[1::2] = np.clip(nb[1::2], 0, size - 1)
    return nb


def _horizontal_flip(s: dict, phrase: str, bbox: np.ndarray, rng):
    """50% flip; "left" and "right" swapped in the expression
    (vgtr_aug.py:83-94)."""
    if rng.random() <= 0.5:
        return phrase, bbox
    w = s["img_shape"][1]
    s["pixel_ops"].append(("flip", None))
    bbox = bbox.copy()
    bbox[0], bbox[2] = w - bbox[2] - 1, w - bbox[0] - 1
    phrase = (phrase.replace("right", "*&^special^&*")
              .replace("left", "right")
              .replace("*&^special^&*", "left"))
    return phrase, bbox


class VGTRAugment:
    """The composed legacy pipeline op (vgtr_aug.py:16-62)."""

    def __init__(self, img_size: int = 512):
        self.img_size = img_size

    def __call__(self, s: dict) -> dict:
        rng = s.get("aug_rng") or _random
        bbox = np.asarray(s["gt_bbox"], np.float64).reshape(-1)[:4]
        ops = s["pixel_ops"]
        # HSV S/V jitter (vgtr_aug.py:32-45), then brightness and contrast
        # (258-264), then a 50% blur (266-272)
        ops.append(("hsv", tuple((rng.random() * 2 - 1) * 0.5 + 1
                                 for _ in range(2))))
        ops.append(("jitter", tuple(1 + (rng.random() * 2 - 1) * 0.25
                                    for _ in range(2))))
        if rng.random() > 0.5:
            ops.append(("blur", None))
        bbox = _letterbox(s, bbox, self.img_size)
        bbox = _random_affine(s, bbox, rng)
        phrase, bbox = _horizontal_flip(s, s["expression"], bbox, rng)

        s["expression"] = phrase
        s["gt_bbox"] = bbox
        s["pad_shape"] = s["img_shape"]
        # scale_factor stays: after letterbox, affine and flip the map to
        # the original image is no per-axis scale (as JAX's)
        return s
