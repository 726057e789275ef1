"""The eval step (port of ``simvg_tpu/engine/train.py::make_eval_step``)
and on-device uint8 normalization (port of
``simvg_tpu/data/prefetch.py::normalize_images_on_device``)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from simvg_tpu_torch.models.model import decode_predictions

BRANCH_KEYS = (
    ("decoder", "class_decoder", "bbox_decoder"),
    ("token", "class_token", "bbox_token"),
)


def normalize_images_on_device(images_u8: torch.Tensor, mean, std,
                               to_rgb: bool = True,
                               img_shape: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """uint8 BGR canvas [B, H, W, 3] -> normalised float32.

    ``img_shape`` [B, 2] (h, w): valid per-sample extents.  The host
    pipeline normalises before padding, so pad pixels are exactly 0
    there; the pad region is zeroed here too."""
    x = images_u8.float()
    if to_rgb:
        x = x.flip(-1)
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    x = (x - mean) / std
    if img_shape is not None:
        _, hh, ww, _ = x.shape
        rows = torch.arange(hh, device=x.device)[None, :, None]
        cols = torch.arange(ww, device=x.device)[None, None, :]
        valid = ((rows < img_shape[:, 0, None, None])
                 & (cols < img_shape[:, 1, None, None]))
        x = x * valid[..., None].to(x.dtype)
    return x


def make_eval_step(model: torch.nn.Module,
                   device_norm: Optional[Dict] = None) -> Callable:
    """Returns ``eval_step(batch) -> {"decoder": preds, "token": preds}``:
    the forward in eval mode with both branches decoded by
    ``decode_predictions``, in the resized image scale of the GT boxes
    (``rescale=False``, as the reference evaluates).

    ``batch`` holds tensors on the model's device: image, text_ids,
    text_padding_mask, img_shape.  With ``device_norm`` ({mean, std,
    to_rgb}) the image is a uint8 BGR canvas normalised on the device."""
    model.eval()

    def _images(batch):
        if device_norm is None:
            return batch["image"]
        return normalize_images_on_device(
            batch["image"], device_norm["mean"], device_norm["std"],
            device_norm.get("to_rgb", True), img_shape=batch.get("img_shape"))

    @torch.inference_mode()
    def eval_step(batch):
        model.eval()  # a train step in between leaves the model in train
        out = model(_images(batch), batch["text_ids"],
                    batch["text_padding_mask"], img_shape=batch["img_shape"])
        return {name: decode_predictions(out[ck][-1], out[bk][-1],
                                         batch["img_shape"])
                for name, ck, bk in BRANCH_KEYS}

    return eval_step
