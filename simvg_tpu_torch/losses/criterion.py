"""DETR-style set criterion and SimVG distillation losses (port of
``simvg_tpu/losses/criterion.py``).

Padded, batched targets ([B, T] with a validity mask) as in the JAX
package; the Hungarian matching goes to the host once per
``set_criterion`` call, with every decoder layer's costs stacked, once
per teacher match in ``prepare_soft_targets`` and once per soft
distillation call (``distill.py``) (``ops/hungarian.py``).

Matcher: detrex ``HungarianMatcher`` with ``ce_cost``, cost = 1 * -prob +
5 * L1 + 2 * -GIoU.  ``num_boxes`` = max(global count, dp_size): the
reference's per-rank clamp(all_reduce(count) / world, 1), divided per rank
and DDP-averaged, gives the same gradients.

Global-batch semantics on data-parallel ranks: JAX computes every loss
over the global batch.  Each term is a sum over samples divided by a batch
statistic, so a rank that divides its own samples' sums by the GLOBAL
statistics gets its share of JAX's term, and the shares add up to it.
``batch_sum`` sums a statistic over the data axis before it divides
anything: the box count, the cross-entropy's weight sum and the
distillation weight's numerator and denominator.  The Hungarian matchings
stay per sample on each rank's host.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from simvg_tpu_torch.ops.boxes import (
    box_cxcywh_to_xyxy,
    box_iou_pairwise,
    generalized_box_iou_pairwise,
)
from simvg_tpu_torch.ops.hungarian import hungarian_assign
from .distill import soft_distill_losses


class Targets(NamedTuple):
    """Padded per-batch targets.

    labels: int64 [B, T] (0..num_classes-1 real classes; GRefCOCO no-target
        entries carry label 1, the no-object class)
    boxes:  fp32 [B, T, 4] cxcywh normalised to [0, 1]
    valid:  bool [B, T]
    weight: fp32 [B, T] per-target weight (1.0 when unused)
    """

    labels: torch.Tensor
    boxes: torch.Tensor
    valid: torch.Tensor
    weight: torch.Tensor


def normalize_targets(
    gt_boxes_xyxy: torch.Tensor,  # [B, T, 4] in image scale
    gt_labels: torch.Tensor,  # [B, T]
    gt_valid: torch.Tensor,  # [B, T]
    img_shape: torch.Tensor,  # [B, 2] (h, w)
) -> Targets:
    """Image-scale xyxy GT -> normalised cxcywh Targets."""
    hw = img_shape.float()
    scale = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], dim=-1)
    boxes = gt_boxes_xyxy.float() / scale[:, None, :]
    x1, y1, x2, y2 = boxes.unbind(-1)
    cxcywh = torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1,
                          y2 - y1], dim=-1)
    return Targets(labels=gt_labels.long(), boxes=cxcywh,
                   valid=gt_valid.bool(),
                   weight=torch.ones(gt_valid.shape, dtype=torch.float32,
                                     device=gt_valid.device))


def _local(t: torch.Tensor) -> torch.Tensor:
    """The single-process ``batch_sum``: the batch is the global batch."""
    return t


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, T, ...] at idx [B, Q] along dim 1 -> [B, Q, ...]."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def _match_costs(logits: torch.Tensor,  # [..., B, Q, C+1]
                 boxes: torch.Tensor,  # [..., B, Q, 4] cxcywh
                 targets: Targets) -> torch.Tensor:
    """detrex ce_cost matcher costs -> [..., B, Q, T]."""
    prob = torch.softmax(logits.float(), dim=-1)
    labels = targets.labels[..., None, :].expand(prob.shape[:-1]
                                                 + targets.labels.shape[-1:])
    cost_class = -torch.gather(prob, -1, labels)
    cost_bbox = (boxes[..., :, None, :] - targets.boxes[..., None, :, :]
                 ).abs().sum(-1)
    cost_giou = -generalized_box_iou_pairwise(
        box_cxcywh_to_xyxy(boxes), box_cxcywh_to_xyxy(targets.boxes))
    return 1.0 * cost_class + 5.0 * cost_bbox + 2.0 * cost_giou


@torch.no_grad()
def hungarian_match(logits, boxes, targets: Targets):
    """Returns (col4row [..., B, Q] target-or--1, row4col [..., B, T]
    query-or--1); leading dims (decoder layers) are solved in the same
    host round trip."""
    cost = _match_costs(logits, boxes, targets)
    valid = targets.valid.expand(cost.shape[:-2] + targets.valid.shape[-1:])
    return hungarian_assign(cost, valid)


def _target_classes(col4row, targets: Targets, num_classes: int):
    matched = col4row >= 0
    return torch.where(matched, torch.gather(targets.labels, 1,
                                             col4row.clamp(min=0)),
                       num_classes)


def _per_query_nll(logits, col4row, targets: Targets, num_classes: int,
                   eos_coef: float):
    """Per-query eos-weighted NLL against the matched class (no-object for
    unmatched queries).  Returns (nll * class_w, class_w, tgt_cls)."""
    tgt_cls = _target_classes(col4row, targets, num_classes)
    logp = F.log_softmax(logits.to(torch.promote_types(logits.dtype,
                                                       torch.float32)),
                         dim=-1)
    nll = -torch.gather(logp, -1, tgt_cls[..., None])[..., 0]
    w = torch.where(tgt_cls == num_classes, eos_coef, 1.0).to(nll.dtype)
    return w * nll, w, tgt_cls


def _ce_loss(logits, col4row, targets: Targets, num_classes: int,
             eos_coef: float, batch_sum: Callable = _local) -> torch.Tensor:
    """F.cross_entropy with the eos class weight: weighted mean over all
    B*Q logits (of the global batch)."""
    wnll, w, _ = _per_query_nll(logits, col4row, targets, num_classes,
                                eos_coef)
    return wnll.sum() / batch_sum(w.sum()).clamp(min=1e-12)


def _focal_loss(logits, col4row, targets: Targets, num_classes: int,
                num_boxes: torch.Tensor, alpha: float = 0.25,
                gamma: float = 2.0) -> torch.Tensor:
    """Sigmoid focal loss over ALL logit columns including the no-object
    one: the reference's one-hot drops only a never-set extra column, so
    an unmatched query trains its no-object logit toward 1."""
    tgt_cls = _target_classes(col4row, targets, num_classes)
    onehot = F.one_hot(tgt_cls, num_classes + 2)[..., :-1].float()
    x = logits.float()
    prob = torch.sigmoid(x)
    ce = x.clamp(min=0) - x * onehot + torch.log1p(torch.exp(-x.abs()))
    p_t = prob * onehot + (1 - prob) * (1 - onehot)
    loss = ce * (1 - p_t) ** gamma
    alpha_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    return (alpha_t * loss).sum() / num_boxes


def _weighted_ce_loss(logits, col4row, row4col, targets: Targets,
                      num_classes: int, eos_coef: float,
                      dp_size: int = 1) -> torch.Tensor:
    """"weighted_ce_loss": per-query weights 0.1, raised to 1.0 at the
    *matched target indices* (the reference indexes its query-weight
    vector with target indices J; kept for checkpoint parity), then
    (w * ce).mean(-1).sum() / dp_size."""
    ce, _, _ = _per_query_nll(logits, col4row, targets, num_classes,
                              eos_coef)
    b, q = col4row.shape
    t = targets.valid.shape[1]
    tgt_matched = (row4col >= 0) & targets.valid  # [B, T]
    if q > t:
        tm = torch.cat([tgt_matched, torch.zeros(b, q - t, dtype=torch.bool,
                                                 device=col4row.device)], 1)
    else:
        tm = tgt_matched[:, :q]
    qw = torch.where(tm, 1.0, 0.1)
    return (qw * ce).mean(-1).sum() / dp_size


def _box_losses(boxes, col4row, targets: Targets, num_boxes: torch.Tensor,
                pair_weight: bool):
    """L1 + GIoU over matched pairs, / num_boxes."""
    matched = col4row >= 0
    idx = col4row.clamp(min=0)
    tgt_boxes = _gather(targets.boxes, idx)
    m = matched.float()
    l1 = (boxes - tgt_boxes).abs().sum(-1)
    giou = generalized_box_iou_pairwise(
        box_cxcywh_to_xyxy(boxes.reshape(-1, 1, 4)),
        box_cxcywh_to_xyxy(tgt_boxes.reshape(-1, 1, 4)),
    ).reshape(boxes.shape[:2])
    loss_giou_el = 1.0 - giou
    if pair_weight:
        w = torch.gather(targets.weight, 1, idx)
        l1 = l1 * w
        loss_giou_el = loss_giou_el * w
    return (l1 * m).sum() / num_boxes, (loss_giou_el * m).sum() / num_boxes


def set_criterion(
    all_logits: torch.Tensor,  # [L, B, Q, C+1]
    all_boxes: torch.Tensor,  # [L, B, Q, 4]
    targets: Targets,
    *,
    num_classes: int = 1,
    eos_coef: float = 0.1,
    loss_class_type: str = "ce_loss",
    dp_size: int = 1,
    weight_dict: Optional[Dict[str, float]] = None,
    gt_count: Optional[torch.Tensor] = None,
    batch_sum: Callable = _local,
) -> Dict[str, torch.Tensor]:
    """SetCriterion with aux losses and the head's weight_dict applied.
    Every decoder layer is matched independently, all layers in one host
    round trip.  Returns {"loss_class", "loss_bbox", "loss_giou",
    ..._i}, weight-scaled, plus "total".

    gt_count: optional [B] untruncated per-sample object-GT counts for
    num_boxes (GRefCOCO targets truncated to num_queries)."""
    if weight_dict is None:
        weight_dict = {"loss_class": 1.0, "loss_bbox": 5.0, "loss_giou": 2.0}
    num_layers = all_logits.shape[0]
    if gt_count is not None:
        count = gt_count.float().sum()
    else:
        count = targets.valid.sum().float()
    num_boxes = batch_sum(count).clamp(min=float(dp_size))

    pair_weight = loss_class_type == "weighted_ce_loss"
    col4row_all, row4col_all = hungarian_match(all_logits, all_boxes, targets)
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    for layer in range(num_layers):
        logits, boxes = all_logits[layer], all_boxes[layer]
        col4row, row4col = col4row_all[layer], row4col_all[layer]
        if loss_class_type == "weighted_ce_loss":
            lc = _weighted_ce_loss(logits, col4row, row4col, targets,
                                   num_classes, eos_coef, dp_size=dp_size)
        elif loss_class_type == "focal_loss":
            lc = _focal_loss(logits, col4row, targets, num_classes, num_boxes)
        else:
            lc = _ce_loss(logits, col4row, targets, num_classes, eos_coef,
                          batch_sum)
        lb, lg = _box_losses(boxes, col4row, targets, num_boxes, pair_weight)
        suffix = "" if layer == num_layers - 1 else f"_{layer}"
        lc = lc * weight_dict["loss_class"]
        lb = lb * weight_dict["loss_bbox"]
        lg = lg * weight_dict["loss_giou"]
        losses[f"loss_class{suffix}"] = lc
        losses[f"loss_bbox{suffix}"] = lb
        losses[f"loss_giou{suffix}"] = lg
        total = total + lc + lb + lg
    losses["total"] = total
    return losses


def prepare_soft_targets(
    teacher_logits: torch.Tensor,  # [B, Q, C+1], detached here
    teacher_boxes: torch.Tensor,  # [B, Q, 4]
    targets_gt: Targets,
    prepare_target_mode: str = "score_iou_weighted",
    predict_threshold: float = 0.0,
    batch_sum: Callable = _local,
):
    """Teacher-derived distillation targets.

    score_iou_weighted: match the detached decoder branch to the
    object-only GT; each matched teacher query becomes a target with
    weight P(class 0) * IoU(teacher box, gt box).
    score_weighted: every teacher query above the score threshold becomes
    a target with weight = its score.

    Returns (targets_pred, weights_distill: scalar mean weight over the
    global batch)."""
    teacher_logits = teacher_logits.detach()
    teacher_boxes = teacher_boxes.detach()
    scores = torch.softmax(teacher_logits.float(), dim=-1)[..., 0]

    if prepare_target_mode == "score_weighted":
        b, q = scores.shape
        valid = scores > predict_threshold
        tp = Targets(labels=torch.zeros(b, q, dtype=torch.long,
                                        device=scores.device),
                     boxes=teacher_boxes, valid=valid, weight=scores * valid)
        # the reference's mean over the full-length weight vectors
        num, den = batch_sum(torch.stack([(tp.weight * tp.valid).sum(),
                                          scores.new_tensor(b * q)]))
        return tp, num / den

    if prepare_target_mode != "score_iou_weighted":
        raise ValueError(f"unknown prepare_target_mode "
                         f"{prepare_target_mode!r}")
    obj_valid = targets_gt.valid & (targets_gt.labels == 0)
    gt_obj = targets_gt._replace(valid=obj_valid)
    _, row4col = hungarian_match(teacher_logits, teacher_boxes, gt_obj)
    matched = (row4col >= 0) & obj_valid  # [B, T]
    qidx = row4col.clamp(min=0)
    t_box = _gather(teacher_boxes, qidx)
    t_score = torch.gather(scores, 1, qidx)
    iou = box_iou_pairwise(
        box_cxcywh_to_xyxy(t_box.reshape(-1, 1, 4)),
        box_cxcywh_to_xyxy(targets_gt.boxes.reshape(-1, 1, 4)),
    )[0].reshape(matched.shape)
    weight = t_score * iou
    targets_pred = Targets(labels=torch.zeros_like(targets_gt.labels),
                           boxes=t_box, valid=matched,
                           weight=torch.where(matched, weight, 0.0))
    num, den = batch_sum(torch.stack([targets_pred.weight.sum(),
                                      matched.sum().float()]))
    return targets_pred, num / den.clamp(min=1)


def prepare_merge_targets(teacher_logits, teacher_boxes,
                          targets_gt: Targets,
                          batch_sum: Callable = _local) -> Targets:
    """"merge" branch targets: GT (weight 1) concatenated with the
    teacher's matched boxes (weight = score * IoU)."""
    tp, _ = prepare_soft_targets(teacher_logits, teacher_boxes, targets_gt,
                                 "score_iou_weighted", batch_sum=batch_sum)
    return Targets(
        labels=torch.cat([targets_gt.labels, tp.labels], 1),
        boxes=torch.cat([targets_gt.boxes, tp.boxes], 1),
        valid=torch.cat([targets_gt.valid, tp.valid], 1),
        weight=torch.cat([torch.ones_like(targets_gt.weight), tp.weight], 1),
    )


def simvg_branch_losses(
    head_out: Dict[str, torch.Tensor],
    targets_gt: Targets,
    *,
    branch_loss_weight: Dict,
    num_classes: int = 1,
    eos_coef: float = 0.1,
    prepare_target_mode: str = "score_iou_weighted",
    distill_type: str = "hard_weighted",
    mlp_aux_loss: bool = False,
    as_target_query_thr: float = 0.0,
    dp_size: int = 1,
    gt_count: Optional[torch.Tensor] = None,
    batch_sum: Callable = _local,
) -> Dict[str, torch.Tensor]:
    """Branch loss orchestration (the reference head's forward_train).

    branch_loss_weight keys: "decoder", "balanced_distill" ({"token": w,
    "distill": w}), "token", "distill", "merge".  gt_count feeds num_boxes
    of every GT-target criterion call; distill targets keep their own
    matched counts.

    On data-parallel ranks (``batch_sum`` summing over the data axis) each
    term but ``loss_distill_w`` is this rank's share of the global term
    (see the module docstring); ``loss_distill_w`` is global.

    ``distill_type="soft"`` (the non-balanced "distill" branch only) takes
    ``distill.soft_distill_losses`` against the decoder's last layer."""
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0

    # GRefCOCO no-target rows (label 1) are dropped from every GT loss
    targets_gt = targets_gt._replace(
        valid=targets_gt.valid & (targets_gt.labels == 0))

    cls_dec = head_out["class_decoder"]
    box_dec = head_out["bbox_decoder"]
    cls_tok = head_out["class_token"]
    box_tok = head_out["bbox_token"]

    kw = dict(num_classes=num_classes, eos_coef=eos_coef, dp_size=dp_size,
              batch_sum=batch_sum)
    kw_gt = dict(kw, gt_count=gt_count)

    if "decoder" in branch_loss_weight:
        d = set_criterion(cls_dec, box_dec, targets_gt, **kw_gt)
        losses["loss_dgt"] = branch_loss_weight["decoder"] * d["total"]
        total = total + losses["loss_dgt"]

    # token branch: last MLP layer only unless mlp_aux_loss
    if not mlp_aux_loss:
        cls_tok_, box_tok_ = cls_tok[-1:], box_tok[-1:]
    else:
        cls_tok_, box_tok_ = cls_tok, box_tok

    if "balanced_distill" in branch_loss_weight:
        bw = branch_loss_weight["balanced_distill"]
        targets_pred, wd = prepare_soft_targets(
            cls_dec[-1], box_dec[-1], targets_gt,
            prepare_target_mode=prepare_target_mode,
            predict_threshold=as_target_query_thr, batch_sum=batch_sum)
        t = set_criterion(cls_tok_, box_tok_, targets_gt, **kw_gt)
        losses["loss_tgt"] = bw["token"] * t["total"] * (1.0 - wd)
        k = set_criterion(cls_tok_, box_tok_, targets_pred, **kw)
        losses["loss_kd"] = bw["distill"] * k["total"] * wd
        losses["loss_distill_w"] = wd
        total = total + losses["loss_tgt"] + losses["loss_kd"]
    else:
        if "token" in branch_loss_weight:
            t = set_criterion(cls_tok_, box_tok_, targets_gt, **kw_gt)
            losses["loss_tgt"] = branch_loss_weight["token"] * t["total"]
            total = total + losses["loss_tgt"]
        if "distill" in branch_loss_weight and distill_type == "soft":
            k = soft_distill_losses(cls_tok_, box_tok_, cls_dec[-1],
                                    box_dec[-1], batch_sum=batch_sum)
            losses["loss_kd"] = branch_loss_weight["distill"] * k["total"]
            total = total + losses["loss_kd"]
        elif "distill" in branch_loss_weight:
            targets_pred, _ = prepare_soft_targets(
                cls_dec[-1], box_dec[-1], targets_gt,
                prepare_target_mode=prepare_target_mode,
                predict_threshold=as_target_query_thr, batch_sum=batch_sum)
            if distill_type == "hard_weighted":
                k = set_criterion(cls_tok_, box_tok_, targets_pred,
                                  loss_class_type="weighted_ce_loss", **kw)
            elif distill_type == "hard":
                k = set_criterion(cls_tok_, box_tok_, targets_pred, **kw)
            else:
                raise ValueError(f"unknown distill_type {distill_type!r}")
            losses["loss_kd"] = branch_loss_weight["distill"] * k["total"]
            total = total + losses["loss_kd"]

    if "merge" in branch_loss_weight:
        targets_merge = prepare_merge_targets(cls_dec[-1], box_dec[-1],
                                              targets_gt, batch_sum)
        m = set_criterion(cls_tok, box_tok, targets_merge, **kw)
        losses["loss_merge"] = branch_loss_weight["merge"] * m["total"]
        total = total + losses["loss_merge"]

    losses["loss_total"] = total
    return losses
