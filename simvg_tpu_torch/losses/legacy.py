"""Legacy loss components (port of ``simvg_tpu/losses/legacy.py``).

- ``label_smooth_ce``: LabelSmoothCrossEntropyLoss (reference
  simvg/core/losses/label_smooth.py:7-40), the smoothed one-hot cross
  entropy with optional per-element weights, averaged over batch * points.
- ``box_loss``: BoxLoss (reference simvg/models/losses/boxloss.py:9-33),
  5 * L1 + 2 * (1 - GIoU) over cxcywh box pairs, summed / batch.
- ``mdetr_hungarian_match``: the mdetr HungarianMatcher (reference
  simvg/core/matcher.py:12-85), whose class cost is the soft-token
  alignment -(softmax(logits) . positive_map), solved on the host by
  ``ops/hungarian.py`` as the port's other matchers are.

No shipped SimVG config uses them (the SeqTR/VGTR era).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from simvg_tpu_torch.ops.boxes import (box_cxcywh_to_xyxy,
                                       generalized_box_iou_pairwise)
from simvg_tpu_torch.ops.hungarian import hungarian_assign


def label_smooth_ce(logits: torch.Tensor,  # [B, N, C]
                    targets: torch.Tensor,  # [B, N] class ids
                    weight: Optional[torch.Tensor] = None,  # [B, N]
                    neg_factor: float = 0.1) -> torch.Tensor:
    """Label-smoothed CE, the mean over B * N (label_smooth.py:17-40)."""
    b, n, c = logits.shape
    acc = torch.promote_types(logits.dtype, torch.float32)
    logs = torch.log_softmax(logits.reshape(-1, c).to(acc), dim=1)
    one_hot = torch.full((b * n, c), neg_factor / c, dtype=acc,
                         device=logits.device)
    one_hot[torch.arange(b * n, device=logits.device),
            targets.reshape(-1)] = 1.0 - neg_factor
    loss = -(logs * one_hot).sum(dim=1)
    if weight is not None:
        loss = loss * weight.reshape(-1).to(acc)
    return loss.sum() / (b * n)


def box_loss(pred_cxcywh: torch.Tensor,  # [B, 4]
             gt_cxcywh: torch.Tensor,  # [B, 4]
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, 5 * l1, 2 * giou), as BoxLoss.forward (boxloss.py:16-33)."""
    bs = pred_cxcywh.shape[0]
    d = pred_cxcywh - gt_cxcywh
    # |d| with JAX's derivative at 0 (+1; torch's abs gives 0 there), so a
    # perfect pair's gradient is JAX's
    l1 = torch.where(d >= 0, d, -d).sum() / bs
    giou = generalized_box_iou_pairwise(box_cxcywh_to_xyxy(pred_cxcywh),
                                        box_cxcywh_to_xyxy(gt_cxcywh))
    loss_giou = (1.0 - giou.diagonal()).sum() / bs
    return 5.0 * l1 + 2.0 * loss_giou, 5.0 * l1, 2.0 * loss_giou


def mdetr_hungarian_match(pred_logits: torch.Tensor,  # [B, Q, tokens]
                          pred_boxes: torch.Tensor,  # [B, Q, 4] cxcywh
                          tgt_boxes: torch.Tensor,  # [B, T, 4] cxcywh
                          tgt_valid: torch.Tensor,  # [B, T] bool
                          positive_map: torch.Tensor,  # [B, T, tokens]
                          cost_class: float = 1.0, cost_bbox: float = 5.0,
                          cost_giou: float = 2.0):
    """The soft-token matcher: returns (col4row [B, Q], the matched target
    of each query or -1; row4col [B, T], the matched query of each valid
    target or -1), int64 on the inputs' device."""
    prob = torch.softmax(pred_logits.float(), dim=-1)
    cc = -torch.einsum("bqv,btv->bqt", prob, positive_map.float())
    cb = (pred_boxes[:, :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(-1)
    cg = -generalized_box_iou_pairwise(box_cxcywh_to_xyxy(pred_boxes),
                                       box_cxcywh_to_xyxy(tgt_boxes))
    cost = cost_class * cc + cost_bbox * cb + cost_giou * cg
    return hungarian_assign(cost, tgt_valid.to(torch.bool))
