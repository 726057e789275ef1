"""Evaluation metrics (copies of the numpy ``detection_accuracy``,
``mask_accuracy`` and ``grec_f1_nacc`` of ``simvg_tpu/engine/metrics.py``;
the JAX package's ``engine`` imports JAX and optax, which the port does not
load).

``grec_f1_nacc`` is the GRefCOCO protocol: predictions filtered at score
>= 0.7, greedily matched to the targets by highest GIoU (>= 0.5); an image
counts as correct when its F1 is 1; the no-target bookkeeping gives N-acc.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from simvg_tpu_torch.ops import rle as rle_ops


def _iou_aligned(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, :2], b[:, :2])
    rb = np.minimum(a[:, 2:], b[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    union = area(a) + area(b) - inter
    return inter / np.maximum(union, 1e-6)


def _giou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise GIoU [N, M] of xyxy boxes."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    iou = inter / np.maximum(union, 1e-12)
    lt2 = np.minimum(a[:, None, :2], b[None, :, :2])
    rb2 = np.maximum(a[:, None, 2:], b[None, :, 2:])
    wh2 = np.clip(rb2 - lt2, 0, None)
    hull = wh2[..., 0] * wh2[..., 1]
    return iou - (hull - union) / np.maximum(hull, 1e-12)


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


def mask_accuracy(
    pred_rles: Sequence,  # per-image predicted RLE
    gt_rles: Sequence,  # per-image GT RLE
    is_crowd: Optional[Sequence[int]] = None,
    thresholds: Sequence[float] = (0.5, 0.6, 0.7, 0.8, 0.9),
) -> Dict[str, float]:
    """Aligned mask IoU in percent (``miou``) and ``acc@t`` for each
    threshold t."""
    ious = np.diag(rle_ops.iou(list(pred_rles), list(gt_rles),
                               list(is_crowd) if is_crowd else None))
    out = {"miou": float(ious.mean() * 100.0) if len(ious) else 0.0}
    for t in thresholds:
        out[f"acc@{t}"] = (float((ious >= t).mean() * 100.0) if len(ious)
                           else 0.0)
    return out


def grec_f1_nacc(
    pred_boxes: Sequence[np.ndarray],  # per image [Q, 4] xyxy
    pred_scores: Sequence[np.ndarray],  # per image [Q]
    gt_boxes: Sequence[np.ndarray],  # per image [M, 4] xyxy
    targets: Sequence[List[dict]],  # per image target dicts
    thresh_score: float = 0.7,
    thresh_iou: float = 0.5,
    thresh_f1: float = 1.0,
) -> Dict[str, float]:
    """F1_score and N_acc in percent, the image count ``n`` and the
    no-target counters TP, TN, FP, FN."""
    correct = 0
    num_image = 0
    nt = {"TP": 0.0, "TN": 0.0, "FP": 0.0, "FN": 0.0}

    for boxes, scores, gts, target in zip(pred_boxes, pred_scores,
                                          gt_boxes, targets):
        # the reference's tie-break: sorted() over (score, box-as-list)
        # tuples, descending, so equal scores order by the box coordinates
        pairs = sorted(
            zip(np.asarray(scores, np.float64).tolist(),
                np.asarray(boxes, np.float64).tolist()),
            reverse=True,
        )
        scores = np.asarray([p[0] for p in pairs], np.float64)
        boxes = np.asarray([p[1] for p in pairs], np.float64).reshape(-1, 4)
        filtered = boxes[scores >= thresh_score]

        no_target = any(t.get("category_id") == -1 for t in target)
        gts = np.asarray(gts, np.float64).reshape(-1, 4)
        num_pred, num_gt = filtered.shape[0], gts.shape[0]

        if no_target:
            if num_pred >= 1:
                nt["FN"] += 1
                f1 = 0.0
            else:
                nt["TP"] += 1
                f1 = 1.0
        else:
            if num_pred >= 1:
                nt["TN"] += 1
            else:
                nt["FP"] += 1
            tp = 0
            if num_pred and num_gt:
                g = _giou(filtered, gts)
                for _ in range(min(num_pred, num_gt)):
                    flat = np.argmax(g)
                    if g.flat[flat] < thresh_iou:
                        break
                    r, c = np.unravel_index(flat, g.shape)
                    tp += 1
                    g[r, :] = 0.0
                    g[:, c] = 0.0
            fp = num_pred - tp
            fn = num_gt - tp
            f1 = 2 * tp / max(2 * tp + fp + fn, 1e-12)

        if f1 >= thresh_f1:
            correct += 1
        num_image += 1

    f1_score = correct / max(num_image, 1) * 100.0
    n_acc = (nt["TP"] / (nt["TP"] + nt["FN"]) * 100.0
             if nt["TP"] != 0 else 0.0)
    return {"F1_score": f1_score, "N_acc": n_acc, "n": num_image, **nt}
