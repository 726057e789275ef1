"""SimVG flagship model: BEiT-3 encoder + TGQS-KD-DETR head (port of
``simvg_tpu/models/model.py``).

State-dict names are the reference's: ``vis_enc.beit3.*`` and ``head.*``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from simvg_tpu_torch.ops.boxes import box_cxcywh_to_xyxy, clip_boxes
from .beit3 import BEiT3Config, BEiT3Encoder
from .heads.tgqs_head import TGQSHeadConfig, TGQSKDDETRHead


@dataclasses.dataclass(frozen=True)
class SimVGConfig:
    beit3: BEiT3Config = dataclasses.field(default_factory=BEiT3Config)
    head: TGQSHeadConfig = dataclasses.field(default_factory=TGQSHeadConfig)


class SimVGModel(nn.Module):
    """Joint encoder + dual-branch grounding head.

    forward(image [B, H, W, 3] float (normalised, NHWC), text_ids [B, T],
    text_padding_mask [B, T] (1 = padding), img_shape [B, 2] (h, w) valid
    extent within H, W) -> the head's output dict.
    """

    def __init__(self, cfg: SimVGConfig):
        super().__init__()
        self.cfg = cfg
        self.vis_enc = nn.ModuleDict({"beit3": BEiT3Encoder(cfg.beit3)})
        self.head = TGQSKDDETRHead(cfg.head)

    def forward(self, image, text_ids, text_padding_mask,
                img_shape: Optional[torch.Tensor] = None,
                branches: str = "both") -> Dict[str, torch.Tensor]:
        b, h_img, w_img, _ = image.shape
        ps = self.cfg.beit3.patch_size
        h, w = h_img // ps, w_img // ps
        img_feat, text_feat, cls_feat = self.vis_enc["beit3"](
            image, text_ids, text_padding_mask)
        x_mm = img_feat.reshape(b, h, w, img_feat.shape[-1])
        img_pad_mask = self._img_pad_mask(b, h_img, w_img, h, w, img_shape,
                                          image.device)
        return self.head(x_mm, img_pad_mask, cls_feat, text_feat,
                         text_padding_mask, branches=branches)

    @staticmethod
    def _img_pad_mask(b, h_img, w_img, h, w, img_shape, device):
        """Feature-grid padding mask from per-sample valid extents: the
        pixel mask (1 outside ``img_shape``) sampled with torch's nearest
        rule, pixel ``floor(i * H_in / H_out)``."""
        if img_shape is None:
            return torch.zeros(b, h, w, dtype=torch.bool, device=device)
        ys = torch.arange(h, device=device) * (h_img // h)
        xs = torch.arange(w, device=device) * (w_img // w)
        row_pad = ys[None, :] >= img_shape[:, 0][:, None]  # [B, h]
        col_pad = xs[None, :] >= img_shape[:, 1][:, None]  # [B, w]
        return row_pad[:, :, None] | col_pad[:, None, :]


def decode_predictions(
    class_logits: torch.Tensor,  # [B, Q, C+1] final-layer logits
    boxes: torch.Tensor,  # [B, Q, 4] cxcywh in [0, 1]
    img_shape: torch.Tensor,  # [B, 2] (h, w)
    scale_factor: Optional[torch.Tensor] = None,  # [B, 4] or None
) -> Dict[str, torch.Tensor]:
    """Best-query box selection, the reference's inference path: softmax
    over classes, drop the no-object column, per-query max prob, boxes
    scaled to the image and clipped, the best-scoring query picked.

    Returns boxes [B, Q, 4] xyxy, scores [B, Q], labels [B, Q], best_box
    [B, 4], best_score [B], best_label [B].
    """
    probs = torch.softmax(class_logits.float(), dim=-1)
    scores, labels = probs[..., :-1].max(dim=-1)

    hw = img_shape.float()
    scale = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], dim=-1)
    xyxy = box_cxcywh_to_xyxy(boxes.float()) * scale[:, None, :]
    xyxy = clip_boxes(xyxy, hw[:, 0][:, None], hw[:, 1][:, None])
    if scale_factor is not None:
        xyxy = xyxy / scale_factor[:, None, :]

    best = scores.argmax(dim=-1)
    rows = torch.arange(best.shape[0], device=best.device)
    return {
        "boxes": xyxy,
        "scores": scores,
        "labels": labels,
        "best_box": xyxy[rows, best],
        "best_score": scores[rows, best],
        "best_label": labels[rows, best],
    }
