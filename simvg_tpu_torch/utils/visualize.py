"""Prediction visualisation (port of ``simvg_tpu/utils/visualize.py``):
predicted (red) and ground-truth (blue) box outlines on the image, and the
attention heat-map overlay of the inference CLI.

Everything is drawn with tensor ops on the image's device, and the JPEG is
written with ``data/jpeg.py`` (nvJPEG for a CUDA tensor, cv2 for a CPU
one): the card's machine has no cv2.  An outline of thickness 2 covers the
pixels within distance 1 of the box's edges, as ``cv2.rectangle`` draws it
(round caps: the four outer corner pixels stay unset).  There is no font
either, so the expression, the boxes and the scores go into ``<out>.json``
beside each image instead of ``cv2.putText`` onto it.  ``imshow_expr_mask``
blends each mask's colour into the image (``cv2.addWeighted``'s rounding)
and draws the mask's outer outline with the pixels ``cv2.drawContours``
sets at thickness 2; the outline's pixels come from the host's copy of
OpenCV's contour and line geometry (``ops/raster.py``).
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from simvg_tpu_torch.data.jpeg import encode
from simvg_tpu_torch.ops import raster
from simvg_tpu_torch.ops import rle as rle_ops

PRED_COLOR = (0, 0, 255)  # red in BGR
GT_COLOR = (255, 0, 0)  # blue in BGR

# cv2.COLORMAP_JET as cv2.applyColorMap gives it: 256 BGR rows, row i the
# colour of level i
_JET_BGR_HEX = (
    "8000008400008800008c00009000009400009800009c0000a00000a40000a800"
    "00ac0000b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d4"
    "0000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc0000"
    "ff0000ff0400ff0800ff0c00ff1000ff1400ff1800ff1c00ff2000ff2400ff28"
    "00ff2c00ff3000ff3400ff3800ff3c00ff4000ff4400ff4800ff4c00ff5000ff"
    "5400ff5800ff5c00ff6000ff6400ff6800ff6c00ff7000ff7400ff7800ff7c00"
    "ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00ffa000ffa400ffa8"
    "00ffac00ffb000ffb400ffb800ffbc00ffc000ffc400ffc800ffcc00ffd000ff"
    "d400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00"
    "feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff"
    "2ad2ff2eceff32caff36c6ff3ac2ff3ebeff42baff46b6ff4ab2ff4eaeff52aa"
    "ff56a6ff5aa2ff5e9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e"
    "7eff827aff8676ff8a72ff8e6eff926aff9666ff9a62ff9e5effa25affa656ff"
    "aa52ffae4effb24affb646ffba42ffbe3effc23affc636ffca32ffce2effd22a"
    "ffd626ffda22ffde1effe21affe616ffea12ffee0efff20afff606fffa01fffe"
    "00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff00dcff00d8ff00d4"
    "ff00d0ff00ccff00c8ff00c4ff00c0ff00bcff00b8ff00b4ff00b0ff00acff00"
    "a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff"
    "007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054"
    "ff0050ff004cff0048ff0044ff0040ff003cff0038ff0034ff0030ff002cff00"
    "28ff0024ff0020ff001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff"
    "0000fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000"
    "d40000d00000cc0000c80000c40000c00000bc0000b80000b40000b00000ac00"
    "00a80000a40000a000009c00009800009400009000008c000088000084000080"
)


def jet_table(device="cpu") -> torch.Tensor:
    """cv2's JET colour map, uint8 [256, 3] BGR."""
    return torch.frombuffer(bytearray.fromhex("".join(_JET_BGR_HEX)),
                            dtype=torch.uint8).reshape(256, 3).to(device)


def draw_boxes(img: torch.Tensor, boxes, color, thickness: int = 2
               ) -> torch.Tensor:
    """Draws each box's outline (xyxy, truncated to ints as the JAX
    module's ``int()`` does) into the uint8 [h, w, 3] ``img`` in place."""
    boxes = torch.as_tensor(boxes, dtype=torch.float64).reshape(-1, 4)
    h, w = img.shape[:2]
    r = thickness // 2
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    color = torch.tensor(color, dtype=torch.uint8, device=img.device)
    for x0, y0, x1, y1 in boxes.trunc().long().tolist():
        x0, x1 = min(x0, x1), max(x0, x1)
        y0, y1 = min(y0, y1), max(y0, y1)
        in_x = (xs >= x0) & (xs <= x1)
        in_y = (ys >= y0) & (ys <= y1)
        near = (lambda a, c: (a - c).abs() <= r)
        mask = ((near(ys, y0) | near(ys, y1)) & in_x) \
            | ((near(xs, x0) | near(xs, x1)) & in_y)
        img[mask] = color
    return img


def imshow_expr_bbox(img: torch.Tensor, pred_bbox, out_file: str,
                     gt_bbox=None, thickness: int = 2,
                     expression: Optional[str] = None,
                     scores: Optional[Sequence[float]] = None
                     ) -> torch.Tensor:
    """A copy of the uint8 BGR [h, w, 3] ``img`` with the predicted boxes in
    red and ``gt_bbox`` in blue.  With ``out_file`` it writes the JPEG
    there and ``<out_file>.json`` with the expression, the boxes (original
    image coordinates) and ``scores``."""
    img = img.clone()
    pred = torch.as_tensor(pred_bbox, dtype=torch.float64).reshape(-1, 4)
    draw_boxes(img, pred, PRED_COLOR, thickness)
    gt = None
    if gt_bbox is not None:
        gt = torch.as_tensor(gt_bbox, dtype=torch.float64).reshape(-1, 4)
        draw_boxes(img, gt, GT_COLOR, thickness)
    if out_file:
        write_jpeg(img, out_file)
        record = {"expression": expression, "pred_boxes": pred.tolist(),
                  "scores": None if scores is None else
                  [float(s) for s in scores],
                  "gt_boxes": None if gt is None else gt.tolist(),
                  "image_hw": list(img.shape[:2])}
        with open(out_file + ".json", "w") as f:
            json.dump(record, f)
    return img


def imshow_expr_mask(img: torch.Tensor, pred_mask_rle, out_file: str,
                     gt_mask_rle=None, alpha: float = 0.45) -> torch.Tensor:
    """A copy of the uint8 BGR [h, w, 3] ``img`` with the predicted mask
    (red) and ``gt_mask_rle`` (blue), COCO RLE dicts, each blended in at
    ``alpha`` and outlined; written to ``out_file`` as a JPEG when given."""
    img = img.clone()
    h, w = img.shape[:2]

    def overlay(r, color):
        m = rle_ops.decode(r)
        if m.shape != (h, w):
            m = raster.resize_nearest(m, (w, h))
        inside = torch.from_numpy(m.astype(bool)).to(img.device)
        c = torch.tensor(color, dtype=torch.uint8, device=img.device)
        layer = img.clone()
        layer[inside] = c
        img.copy_((layer.float() * alpha + img.float() * (1.0 - alpha))
                  .round().clamp(0, 255).to(torch.uint8))
        edge = raster.contour_outline((h, w), raster.find_contours(
            m.astype(np.uint8), external=True, simple=True))
        img[torch.from_numpy(edge).to(img.device)] = c

    if pred_mask_rle is not None:
        overlay(pred_mask_rle, PRED_COLOR)
    if gt_mask_rle is not None:
        overlay(gt_mask_rle, GT_COLOR)
    if out_file:
        write_jpeg(img, out_file)
    return img


def attention_overlay(img: torch.Tensor, amap: torch.Tensor,
                      alpha: float = 0.55) -> torch.Tensor:
    """The inference CLI's heat map: ``amap`` [g, g] scaled to its max,
    truncated to uint8, resized bilinearly to the image (rounded, as
    ``cv2.resize`` gives uint8), coloured with JET and blended
    ``alpha * img + (1 - alpha) * heat`` (``cv2.addWeighted``'s rounding)."""
    amap = amap.float()
    amap = amap / amap.max().clamp_min(1e-8)
    levels = (amap * 255).to(torch.uint8)
    h, w = img.shape[:2]
    up = F.interpolate(levels[None, None].float(), size=(h, w),
                       mode="bilinear", align_corners=False)[0, 0]
    up = up.round().clamp(0, 255).long()
    heat = jet_table(img.device)[up]
    out = img.float() * alpha + heat.float() * (1.0 - alpha)
    return out.round().clamp(0, 255).to(torch.uint8)


def write_jpeg(img: torch.Tensor, out_file: str) -> None:
    with open(out_file, "wb") as f:
        f.write(encode(img))

