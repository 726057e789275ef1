"""The train step (port of ``simvg_tpu/engine/train.py::make_train_step``).

One step: the forward in train mode on the device-normalised batch, the
SimVG branch losses with Hungarian matching, the backward (through the
attention kernels K1/K2 when ``attn_impl="pallas"`` on the card), the
freeze mask, the global-norm clip, the optimizer's update (Adam/amsgrad,
AdamW, SGD or RMSProp) in place on the model's parameters and the optional
EMA.  The loss terms, ``grad_norm`` and the train metrics come back as
device scalars; the only host round trips are the Hungarian matchings
(``ops/hungarian.py``).

Train-mode randomness draws from one ``torch.Generator`` on the model's
device that the step owns; it is seeded from (seed, step) every step, as
the JAX step folds the step into its rng, and from the data-parallel rank,
so that each rank draws its own dropout and drop-path masks (the ranks of
one tensor-parallel group draw the same).

On a mesh (``sharded``, ``parallel/mesh.py``) each rank runs its shard of
the global batch: the criterion sums its batch statistics over the data
axis, each rank back-propagates dp times its share of the global loss (the
wrappers average the gradients over the ranks, which gives the global
loss's gradient, as JAX's ``make_train_step(dp_size=dp)``), and the
scalars returned are the global ones, equal on every rank.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from simvg_tpu_torch.losses.criterion import (normalize_targets,
                                              simvg_branch_losses)
from simvg_tpu_torch.models.layers import set_generator
from simvg_tpu_torch.models.model import decode_predictions
from simvg_tpu_torch.ops.boxes import box_iou_aligned
from simvg_tpu_torch.parallel.mesh import Sharded, local
from .eval import BRANCH_KEYS, normalize_images_on_device
from .train_state import Optimizer, TrainState, ema_update, global_norm


def _train_metrics(out, batch) -> Dict[str, torch.Tensor]:
    """Per-branch Prec@0.5 and mIoU on the device, scored against the FIRST
    target of each sample, as the JAX step does."""
    metrics = {}
    gt = batch["gt_boxes"][:, 0, :]
    for name, cls_key, box_key in BRANCH_KEYS:
        pred = decode_predictions(out[cls_key][-1], out[box_key][-1],
                                  batch["img_shape"])
        iou = box_iou_aligned(pred["best_box"], gt.float())
        metrics[f"{name}_det_acc"] = (iou >= 0.5).float().mean() * 100.0
        metrics[f"{name}_miou"] = iou.mean() * 100.0
    return metrics


def global_scalars(scalars: Dict[str, torch.Tensor], batch_sum: Callable,
                    dp: int) -> Dict[str, torch.Tensor]:
    """The global batch's scalars from the ranks' own, in one all-reduce:
    the loss terms are the ranks' shares and add up; the distillation
    weight is global already and the train metrics are means over equal
    local batches, so both are averaged."""
    keys = list(scalars)
    summed = batch_sum(torch.stack([scalars[k].float() for k in keys]))
    return {k: v if k.startswith("loss") and k != "loss_distill_w"
            else v / dp for k, v in zip(keys, summed)}


def train_losses(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
                 images: torch.Tensor, **loss_kw):
    """The train-mode forward and the SimVG branch losses of one batch:
    returns (losses, head outputs).  ``loss_kw`` goes to
    ``simvg_branch_losses``."""
    model.train()
    out = model(images, batch["text_ids"], batch["text_padding_mask"],
                img_shape=batch["img_shape"])
    targets = normalize_targets(batch["gt_boxes"], batch["gt_labels"],
                                batch["gt_valid"], batch["img_shape"])
    return simvg_branch_losses(out, targets, gt_count=batch.get("gt_count"),
                               **loss_kw), out


def make_train_step(
    model: torch.nn.Module,
    optimizer: Optimizer,
    *,
    branch_loss_weight: Dict,
    prepare_target_mode: str = "score_iou_weighted",
    distill_type: str = "hard_weighted",
    mlp_aux_loss: bool = False,
    ema_alpha: Optional[float] = None,
    with_metrics: bool = True,
    return_predictions: bool = False,
    device_norm: Optional[Dict] = None,
    sharded: Optional[Sharded] = None,
) -> Callable:
    """Returns ``train_step(state, batch, seed) -> (state, scalars)``.

    ``batch`` holds tensors on the model's device: image, text_ids,
    text_padding_mask, img_shape, gt_boxes [B, T, 4] (xyxy, image scale),
    gt_labels [B, T], gt_valid [B, T] and optionally gt_count [B].  With
    ``device_norm`` ({mean, std, to_rgb}) the image is a uint8 BGR canvas
    normalised on the device.  The model's parameters and the state are
    updated in place.  With ``return_predictions`` the scalars also hold,
    under ``"predictions"``, the last layer's (class logits, boxes) of both
    branches as device tensors, undecoded: the caller decodes them with
    ``decode_predictions`` on the steps it reads (GRefCOCO's train
    F1/N-acc at the CLI's log lines).  ``sharded``: the layout of
    ``model`` on a mesh (``shard_model``); the step then calls its
    ``module``, and the state holds this rank's shards."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    generator = torch.Generator(device=local(params[0]).device)
    set_generator(model, generator)
    forward = model if sharded is None else sharded.module
    dp = 1 if sharded is None else sharded.dp
    rank = 0 if sharded is None else sharded.dp_rank
    batch_sum = None if sharded is None else sharded.batch_sum
    norm_groups = None if sharded is None else sharded.norm_groups(params)

    def _images(batch):
        if device_norm is None:
            return batch["image"]
        return normalize_images_on_device(
            batch["image"], device_norm["mean"], device_norm["std"],
            device_norm.get("to_rgb", True), img_shape=batch.get("img_shape"))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   seed: int):
        generator.manual_seed((seed * 1_000_003 + state.step
                               + rank * 0x9E3779B97F4A7C15) % 2 ** 63)
        kw = {} if batch_sum is None else {"batch_sum": batch_sum}
        losses, out = train_losses(
            forward, batch, _images(batch),
            branch_loss_weight=branch_loss_weight,
            prepare_target_mode=prepare_target_mode,
            distill_type=distill_type, mlp_aux_loss=mlp_aux_loss,
            dp_size=dp, **kw)
        for p in params:
            p.grad = None
        (losses["loss_total"] * dp if dp > 1
         else losses["loss_total"]).backward()
        if sharded is not None:
            sharded.sync_grads(params)
        shards = [local(p.detach()) for p in params]
        grads = [torch.zeros_like(w) if p.grad is None else local(p.grad)
                 for p, w in zip(params, shards)]
        for p in params:
            p.grad = None

        scalars = {k: v.detach() for k, v in losses.items()}
        with torch.no_grad():
            if with_metrics:
                scalars.update(_train_metrics(out, batch))
            if dp > 1:
                scalars = global_scalars(scalars, batch_sum, dp)
        scalars["grad_norm"] = global_norm(grads, norm_groups)
        state.opt_state = optimizer.apply(names, shards, grads,
                                          state.opt_state, norm_groups)
        if state.ema_params is not None and ema_alpha is not None:
            state.ema_step = ema_update(state.ema_params, shards,
                                        state.ema_step, ema_alpha)
        state.step += 1
        with torch.no_grad():
            if return_predictions:
                scalars["predictions"] = {
                    name: (out[ck][-1].detach(), out[bk][-1].detach())
                    for name, ck, bk in BRANCH_KEYS}
        return state, scalars

    return train_step
