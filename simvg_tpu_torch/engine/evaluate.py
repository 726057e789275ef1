"""Evaluation loop (port of ``simvg_tpu/engine/evaluate.py::evaluate``).

Per batch: the eval step runs on the model's device; Prec@0.5 and mIoU
(or, for GRefCOCO, the per-image boxes and scores that F1/N-acc need)
accumulate on the host over the ``batch_valid`` rows, so the duplicates
that wrap-pad the last batch are not counted.  Batches may come from the
port's loader, with the image already on the device.  When a branch's
predictions carry ``pred_masks`` (per-image RLE dicts or binary masks; no
SimVG head emits them, as in JAX) and the batch's meta carries
``gt_mask_rle``, the aligned mask IoU and its hits at ``MASK_THRS``
accumulate too.

On data-parallel ranks each rank evaluates its shard of the split and the
counters (Prec@0.5 hits, IoU sums, counts; GRefCOCO's correct images,
counts and no-target TP/FN, the mask IoU sums, hits and counts) are summed
over the ranks before the division,
as JAX's ``_allgather_sum``: every rank returns the whole split's metrics.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from simvg_tpu_torch.ops import rle as rle_ops
from simvg_tpu_torch.parallel.mesh import local
from .eval import BRANCH_KEYS, make_eval_step
from .metrics import detection_accuracy, grec_f1_nacc

# the keys the eval step consumes; gt boxes and batch_valid stay on host
DEVICE_KEYS = ("image", "text_ids", "text_padding_mask", "img_shape")
MASK_THRS = (0.5, 0.6, 0.7, 0.8, 0.9)


def evaluate(
    model: torch.nn.Module,
    loader,
    *,
    is_grec: bool = False,
    eval_step: Optional[Callable] = None,
    log_fn: Optional[Callable[[str], None]] = None,
    log_interval: int = 50,
    max_batches: Optional[int] = None,
    batch_sum: Optional[Callable] = None,
) -> Dict[str, float]:
    """Returns per-branch ``{branch}_det_acc`` / ``{branch}_miou``, their
    mean ``det_acc``, ``n_samples`` and ``miou``: the mean over the branches
    of ``{branch}_mask_miou`` (with ``{branch}_mask_acc@t``) where a branch
    predicted masks, else 0.0, as for the box-only SimVG heads in the JAX
    package.  With ``is_grec``:
    per-branch ``{branch}_F1_score`` / ``{branch}_N_acc`` over the full
    target lists of ``meta["gt_bbox_all"]`` and ``meta["target"]``, their
    means as ``det_acc`` and ``miou``, and ``n_samples``.

    ``loader``: an iterable of batch dicts (numpy arrays or tensors, on the
    host or the model's device) with the eval step's keys plus gt_boxes
    [B, M, 4] xyxy and batch_valid [B].  ``log_fn`` gets a progress line
    every ``log_interval`` batches; ``max_batches`` stops early (the
    metrics then cover a subset).  ``batch_sum`` (``Sharded.batch_sum``)
    sums the counters over the data-parallel ranks."""
    step = eval_step or make_eval_step(model)
    device = local(next(model.parameters())).device
    branches = [name for name, _, _ in BRANCH_KEYS]
    acc = {b: {"iou_hits": 0.0, "iou_sum": 0.0, "n": 0} for b in branches}
    # per branch: mask IoU sum, count, hits at each of MASK_THRS
    masks = {b: np.zeros(2 + len(MASK_THRS)) for b in branches}
    grec = {b: new_grec_lists() for b in branches}
    n_batches = len(loader) if hasattr(loader, "__len__") else None
    if max_batches is not None and n_batches is not None:
        n_batches = min(n_batches, max_batches)

    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        device_batch = {k: torch.as_tensor(batch[k]).to(device)
                        for k in DEVICE_KEYS if k in batch}
        preds = step(device_batch)
        valid = np.asarray(batch["batch_valid"])
        if is_grec:
            for b in branches:
                grec_rows(grec[b], preds[b], batch, valid)
        else:
            gt = np.asarray(batch["gt_boxes"])[:, 0, :]
            for b in branches:
                m = detection_accuracy(preds[b]["best_box"].cpu().numpy(),
                                       gt, valid)
                a = acc[b]
                a["iou_hits"] += m["det_acc"] / 100.0 * m["n"]
                a["iou_sum"] += m["miou"] / 100.0 * m["n"]
                a["n"] += m["n"]
                if preds[b].get("pred_masks") is not None:
                    mask_rows(masks[b], preds[b]["pred_masks"], batch, valid)
        if log_fn is not None and (bi + 1) % max(log_interval, 1) == 0:
            log_fn(f"eval [{bi + 1}/{n_batches}]")

    out: Dict[str, float] = {}
    if is_grec:
        for b in branches:
            m = grec_summary(grec[b], batch_sum)
            out["n_samples"] = float(m["n"])
            out[f"{b}_F1_score"] = m["F1_score"]
            out[f"{b}_N_acc"] = m["N_acc"]
        # the reference reports (mean F1, mean N-acc) as (det_acc, miou)
        out["det_acc"] = float(np.mean([out[f"{b}_F1_score"]
                                        for b in branches]))
        out["miou"] = float(np.mean([out[f"{b}_N_acc"] for b in branches]))
        return out
    for b in branches:
        hits, iou_sum, n = _summed([acc[b]["iou_hits"], acc[b]["iou_sum"],
                                    acc[b]["n"]], batch_sum)
        # both branches see every sample; count before the zero clamp
        out["n_samples"] = float(n)
        out[f"{b}_det_acc"] = hits / max(n, 1) * 100.0
        out[f"{b}_miou"] = iou_sum / max(n, 1) * 100.0
    out["det_acc"] = (out["decoder_det_acc"] + out["token_det_acc"]) / 2.0
    mask_mious = []
    for b in branches:
        iou_sum, n, *hits = _summed(masks[b].tolist(), batch_sum)
        if n > 0:
            out[f"{b}_mask_miou"] = iou_sum / n * 100.0
            for t, h in zip(MASK_THRS, hits):
                out[f"{b}_mask_acc@{t}"] = h / n * 100.0
            mask_mious.append(out[f"{b}_mask_miou"])
    out["miou"] = float(np.mean(mask_mious)) if mask_mious else 0.0
    return out


def mask_rows(acc: np.ndarray, pred_masks, batch: Dict,
              valid: np.ndarray) -> None:
    """Adds the ``valid`` rows' aligned mask IoU against
    ``meta["gt_mask_rle"]`` (crowd GT by ``meta["is_crowd"]``) to ``acc``:
    [IoU sum, count, hits at each of MASK_THRS]."""
    for i, meta in enumerate(batch["meta"]):
        gt, pred = meta.get("gt_mask_rle"), pred_masks[i]
        if not valid[i] or gt is None or pred is None:
            continue
        if not isinstance(pred, dict):
            pred = rle_ops.encode(np.asarray(
                pred.cpu() if isinstance(pred, torch.Tensor) else pred,
                np.uint8))
        iou = float(rle_ops.iou([pred], [gt],
                                [int(meta.get("is_crowd") or 0)])[0, 0])
        acc += [iou, 1.0] + [float(iou >= t) for t in MASK_THRS]


def _summed(values: List[float],
            batch_sum: Optional[Callable]) -> List[float]:
    """``values`` summed over the ranks (in float64), or as they are."""
    if batch_sum is None:
        return values
    return batch_sum(torch.tensor(values, dtype=torch.float64)).tolist()


def grec_summary(acc: Dict, batch_sum: Optional[Callable] = None
                 ) -> Dict[str, float]:
    """``grec_f1_nacc`` of the per-image lists ``acc``; with ``batch_sum``
    over every rank's images, from the summed counters (correct images,
    images, no-target TP and FN)."""
    m = grec_f1_nacc(**acc)
    if batch_sum is None:
        return m
    correct, n, tp, fn = _summed([round(m["F1_score"] / 100.0 * m["n"]),
                                  m["n"], m["TP"], m["FN"]], batch_sum)
    return {"F1_score": correct / max(n, 1) * 100.0,
            "N_acc": tp / (tp + fn) * 100.0 if tp != 0 else 0.0,
            "n": n, "TP": tp, "FN": fn}


def new_grec_lists() -> Dict[str, list]:
    """Empty per-image lists, keyed as ``grec_f1_nacc``'s arguments."""
    return {"pred_boxes": [], "pred_scores": [], "gt_boxes": [],
            "targets": []}


def grec_rows(acc: Dict, preds: Dict, batch: Dict,
              valid: Optional[np.ndarray] = None) -> None:
    """Appends the ``valid`` rows of one branch's decoded predictions to
    ``acc`` (``new_grec_lists``): boxes, scores, the full target boxes
    (``meta["gt_bbox_all"]``, untruncated by ``max_gt``) and the target
    dicts."""
    boxes = preds["boxes"].float().cpu().numpy()
    scores = preds["scores"].float().cpu().numpy()
    for i, m in enumerate(batch["meta"]):
        if valid is not None and not valid[i]:
            continue
        acc["pred_boxes"].append(boxes[i])
        acc["pred_scores"].append(scores[i])
        acc["gt_boxes"].append(np.asarray(m["gt_bbox_all"]))
        acc["targets"].append(m["target"])
