"""The pixel half of the data pipeline, on the loader's device.

``transforms`` decides on the host what happens to each image and records
it in ``s["pixel_ops"]``; here the decoded image (``jpeg.decode``: nvJPEG
on the card, EXIF-oriented) goes through those operations where it lies,
on the card (or on the CPU for the tests):

1. each recorded op in turn: a bilinear resize, rounded back to uint8, or
   a crop (a slice);
2. BGR->RGB and (x - mean) / std in float32 when the pipeline normalises;
3. into the batch canvas at the top left, over the pad value.

The JAX module resamples twice on the jitter path (the jitter rescale, then
``Resize``), each time in uint8 with rounding, through ``cv2.resize``
(``INTER_LINEAR``); the same sequence is kept, because one fused resample
would move pixels further than the rounding does.  ``F.interpolate``
(bilinear, ``align_corners=False``) samples at the same half-pixel centres
as cv2 but in float where cv2 uses fixed point, so a pixel may land one
level away from cv2's at each resampling.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F


def resize_u8(image: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of a uint8 [h, w, 3] image to ``size`` = (h, w),
    rounded back to uint8, as ``cv2.resize(..., INTER_LINEAR)``."""
    if tuple(image.shape[:2]) == tuple(size):
        return image
    x = image.permute(2, 0, 1)[None].float()
    x = F.interpolate(x, size=tuple(size), mode="bilinear",
                      align_corners=False)
    return x[0].round_().clamp_(0, 255).to(torch.uint8).permute(1, 2, 0)


def apply_pixel_ops(image: torch.Tensor, ops: Sequence) -> torch.Tensor:
    """Replays a sample's recorded resizes and crops on its image."""
    for kind, arg in ops:
        if kind == "resize":
            image = resize_u8(image, arg)
        elif kind == "crop":
            y0, y1, x0, x1 = arg
            image = image[y0:y1, x0:x1]
        else:
            raise ValueError(f"unknown pixel op {kind!r}")
    return image


def normalize(image: torch.Tensor, norm_cfg) -> torch.Tensor:
    """float32 (img - mean) / std, BGR->RGB first when ``to_rgb``: the JAX
    ``Normalize``, element for element."""
    x = image.float()
    if norm_cfg.get("to_rgb", True):
        x = x.flip(-1)
    mean = torch.as_tensor(norm_cfg["mean"], dtype=torch.float32,
                           device=x.device)
    std = torch.as_tensor(norm_cfg["std"], dtype=torch.float32,
                          device=x.device)
    return (x - mean) / std


def render(sample: dict, decoded: torch.Tensor) -> torch.Tensor:
    """A sample's image after its pipeline, unpadded: uint8 [h, w, 3], or
    float32 when the pipeline normalises, from its decoded image (on the
    device where it lies)."""
    image = apply_pixel_ops(decoded, sample["pixel_ops"])
    if tuple(image.shape) != tuple(sample["img_shape"]):
        raise AssertionError(f"pixel ops gave {tuple(image.shape)}, the "
                             f"geometry {sample['img_shape']}")
    if "img_norm_cfg" in sample:
        image = normalize(image, sample["img_norm_cfg"])
    return image


def collate_images(samples: List[dict], canvas: int, device,
                   decoded: Sequence[torch.Tensor]) -> torch.Tensor:
    """The batch's image [B, canvas, canvas, 3] on ``device`` from the
    samples' decoded images: each sample's rendered image at the top left,
    its pad region at the pad value and the rest of the canvas 0 (the JAX
    collate's layout).  float32 when the pipeline normalises, else
    uint8."""
    norm = bool(samples) and "img_norm_cfg" in samples[0]
    out = torch.zeros((len(samples), canvas, canvas, 3),
                      dtype=torch.float32 if norm else torch.uint8,
                      device=device)
    for i, s in enumerate(samples):
        ph, pw = s["pad_shape"][:2]
        if ph > canvas or pw > canvas:
            raise AssertionError((s["pad_shape"], canvas))
        if s.get("pad_val", 0):
            out[i, :ph, :pw] = s["pad_val"]
        image = render(s, decoded[i])
        h, w = image.shape[:2]
        out[i, :h, :w] = image
    return out
