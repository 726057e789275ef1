"""Soft knowledge-distillation criterion, ``distill_type="soft"`` (port of
``simvg_tpu/losses/distill.py``).

The student (the token branch) is matched query to query against the
detached teacher (the decoder branch's last layer) at the cost
BCE(student object logit, teacher soft label) + 5 * L1 + 2 * (-GIoU), and
trained with BCE against the teacher's object probability and L1 + GIoU
against the teacher's boxes.  The soft label is ``sigmoid(teacher_logits
[..., 0])``, not a softmax; boxes stay normalised cxcywh (the JAX module's
reading of the reference, whose own soft path mixes units).

Every student layer has its own Q x Q assignment, all of them solved in one
host round trip (``ops/hungarian.py``).  Each term is divided by the global
``b * q``: on data-parallel ranks ``batch_sum`` sums that count over the
data axis, so each rank returns its share of JAX's term (see
``criterion.py``'s module docstring).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from simvg_tpu_torch.ops.boxes import (box_cxcywh_to_xyxy,
                                       generalized_box_iou_pairwise)
from simvg_tpu_torch.ops.hungarian import hungarian_assign


def _bce_with_logits(logits, targets):
    """Elementwise binary cross entropy with logits (JAX's stable form)."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def _local(t: torch.Tensor) -> torch.Tensor:
    return t


def soft_distill_losses(
    student_logits: torch.Tensor,  # [L, B, Q, C+1]
    student_boxes: torch.Tensor,  # [L, B, Q, 4] cxcywh normalised
    teacher_logits: torch.Tensor,  # [B, Q, C+1] (the teacher's last layer)
    teacher_boxes: torch.Tensor,  # [B, Q, 4] cxcywh normalised
    *,
    cls_weight: float = 1.0,
    bbox_weight: float = 5.0,
    giou_weight: float = 2.0,
    batch_sum: Callable = _local,
) -> Dict[str, torch.Tensor]:
    """Returns ``loss_{cls,bbox,iou}_distill`` for the last student layer,
    ``..._d{layer}`` for the others, and their weighted sum ``total``."""
    teacher_logits = teacher_logits.detach()
    teacher_boxes = teacher_boxes.detach().float()
    t_prob = torch.sigmoid(teacher_logits[..., 0].float())  # [B, Q]
    num_layers, b, q, _ = student_logits.shape
    s_obj = student_logits[..., 0].float()  # [L, B, Q]
    s_box = student_boxes.float()  # [L, B, Q, 4]

    # the assignment costs of every layer: student rows, teacher columns
    pos = _bce_with_logits(s_obj, torch.ones_like(s_obj))
    neg = _bce_with_logits(s_obj, torch.zeros_like(s_obj))
    cls_cost = (pos[..., :, None] * t_prob[:, None, :]
                + neg[..., :, None] * (1.0 - t_prob[:, None, :]))
    bbox_cost = (s_box[..., :, None, :] - teacher_boxes[:, None, :, :]
                 ).abs().sum(-1)
    t_xyxy = box_cxcywh_to_xyxy(teacher_boxes)
    giou_cost = -generalized_box_iou_pairwise(box_cxcywh_to_xyxy(s_box),
                                              t_xyxy)
    cost = (cls_weight * cls_cost + bbox_weight * bbox_cost
            + giou_weight * giou_cost)
    col4row_all, _ = hungarian_assign(cost)  # [L, B, Q]

    denom = batch_sum(torch.tensor(float(b * q), device=s_obj.device))
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    for layer in range(num_layers):
        idx = col4row_all[layer].clamp(min=0)
        t_prob_m = torch.gather(t_prob, 1, idx)
        t_box_m = torch.gather(teacher_boxes, 1,
                               idx[..., None].expand(b, q, 4))
        l_cls = _bce_with_logits(s_obj[layer], t_prob_m).sum() / denom
        l_l1 = (s_box[layer] - t_box_m).abs().sum() / denom
        giou = generalized_box_iou_pairwise(
            box_cxcywh_to_xyxy(s_box[layer].reshape(-1, 1, 4)),
            box_cxcywh_to_xyxy(t_box_m.reshape(-1, 1, 4))).reshape(b, q)
        l_giou = (1.0 - giou).sum() / denom

        suffix = "" if layer == num_layers - 1 else f"_d{layer}"
        losses[f"loss_cls_distill{suffix}"] = cls_weight * l_cls
        losses[f"loss_bbox_distill{suffix}"] = bbox_weight * l_l1
        losses[f"loss_iou_distill{suffix}"] = giou_weight * l_giou
        total = (total + cls_weight * l_cls + bbox_weight * l_l1
                 + giou_weight * l_giou)
    losses["total"] = total
    return losses
