"""Evaluation loop (port of ``simvg_tpu/engine/evaluate.py::evaluate``,
the detection path in one process).

Per batch: the eval step runs on the model's device; Prec@0.5 and mIoU
accumulate on the host over the ``batch_valid`` rows, so the duplicates
that wrap-pad the last batch are not counted.  Batches may come from the
port's loader, with the image already on the device.  GRec F1/N-acc and
mask mIoU wait for M15 and the mask path.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .eval import BRANCH_KEYS, make_eval_step
from .metrics import detection_accuracy

# the keys the eval step consumes; gt boxes and batch_valid stay on host
DEVICE_KEYS = ("image", "text_ids", "text_padding_mask", "img_shape")


def evaluate(
    model: torch.nn.Module,
    loader,
    *,
    eval_step: Optional[Callable] = None,
    log_fn: Optional[Callable[[str], None]] = None,
    log_interval: int = 50,
    max_batches: Optional[int] = None,
) -> Dict[str, float]:
    """Returns per-branch ``{branch}_det_acc`` / ``{branch}_miou``, their
    mean ``det_acc``, ``n_samples`` and ``miou`` (the mask mIoU, 0.0 for
    the box-only SimVG heads, as in the JAX package).

    ``loader``: an iterable of batch dicts (numpy arrays or tensors, on the
    host or the model's device) with the eval step's keys plus gt_boxes
    [B, M, 4] xyxy and batch_valid [B].  ``log_fn`` gets a progress line
    every ``log_interval`` batches; ``max_batches`` stops early (the
    metrics then cover a subset)."""
    step = eval_step or make_eval_step(model)
    device = next(model.parameters()).device
    branches = [name for name, _, _ in BRANCH_KEYS]
    acc = {b: {"iou_hits": 0.0, "iou_sum": 0.0, "n": 0} for b in branches}
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
        gt = np.asarray(batch["gt_boxes"])[:, 0, :]
        for b in branches:
            m = detection_accuracy(preds[b]["best_box"].cpu().numpy(), gt,
                                   valid)
            a = acc[b]
            a["iou_hits"] += m["det_acc"] / 100.0 * m["n"]
            a["iou_sum"] += m["miou"] / 100.0 * m["n"]
            a["n"] += m["n"]
        if log_fn is not None and (bi + 1) % max(log_interval, 1) == 0:
            log_fn(f"eval [{bi + 1}/{n_batches}]")

    out: Dict[str, float] = {}
    for b in branches:
        n = acc[b]["n"]
        # both branches see every sample; count before the zero clamp
        out["n_samples"] = float(n)
        out[f"{b}_det_acc"] = acc[b]["iou_hits"] / max(n, 1) * 100.0
        out[f"{b}_miou"] = acc[b]["iou_sum"] / max(n, 1) * 100.0
    out["det_acc"] = (out["decoder_det_acc"] + out["token_det_acc"]) / 2.0
    out["miou"] = 0.0
    return out
