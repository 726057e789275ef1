"""Evaluation metrics (copy of the numpy ``detection_accuracy`` of
``simvg_tpu/engine/metrics.py``; the JAX package's ``engine`` imports
JAX and optax, which the port does not load)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _iou_aligned(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, :2], b[:, :2])
    rb = np.minimum(a[:, 2:], b[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    union = area(a) + area(b) - inter
    return inter / np.maximum(union, 1e-6)


def detection_accuracy(
    pred_boxes: np.ndarray,  # [N, 4] xyxy
    gt_boxes: np.ndarray,  # [N, 4] xyxy
    valid: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Prec@0.5 and mIoU in percent over the ``valid`` rows."""
    pred_boxes = np.asarray(pred_boxes, np.float64)
    gt_boxes = np.asarray(gt_boxes, np.float64)
    iou = _iou_aligned(pred_boxes, gt_boxes)
    if valid is not None:
        iou = iou[np.asarray(valid, bool)]
    if iou.size == 0:
        return {"det_acc": 0.0, "miou": 0.0, "n": 0}
    return {
        "det_acc": float((iou >= 0.5).mean() * 100.0),
        "miou": float(iou.mean() * 100.0),
        "n": int(iou.size),
    }
