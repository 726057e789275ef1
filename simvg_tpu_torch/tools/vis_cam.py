"""Grad-CAM over the image feature grid (counterpart of
``tools/misc/vis_cam.py``): ReLU(sum_c dS/dA_c * A_c), where S is the sum
over the batch of the best query's object score of one branch and A the
image features the head sees.

    python -m simvg_tpu_torch.tools.vis_cam CONFIG [CHECKPOINT]
        [--which-set val] [--output-dir cam_out] [--num 8]
        [--branch token|decoder] [--device cuda|cpu]
        [--cfg-options key=value ...]

Both model families:

- MIXDETRMB: A is the BEiT-3 encoder's vision-token grid; the encoder runs
  forward only (through K1 with ``attn_impl="pallas"`` on the card) and the
  gradient starts at the head's input, as in JAX, so K2 does not run.  The
  token branch reads the CLS and text features, not the grid, so its CAM
  is 0 everywhere, as JAX's is;
- OneStageModel: A is the visual backbone's feature map, scored by the
  language encoder, the fusion and the DETR head.

Each CAM is drawn over the sample's image resized to the canvas, with the
JET table of ``utils/visualize.py`` (no text is drawn).  Without a
checkpoint the weights are random from seed 0.  It runs on the card unless
``--device cpu`` is given; ``main(argv)`` returns the CAMs.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Dict

import numpy as np
import torch

from simvg_tpu_torch.config import Config, parse_cfg_options
from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                          build_loader_from_cfg)
from simvg_tpu_torch.data.image_ops import resize_u8
from simvg_tpu_torch.data.image_file import decode_image
from simvg_tpu_torch.engine.eval import normalize_images_on_device
from simvg_tpu_torch.engine.evaluate import DEVICE_KEYS
from simvg_tpu_torch.utils.visualize import attention_overlay, write_jpeg

from .test import serving_model
from .train import check_ported, device_norm_of, resolve_device, to_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Grad-CAM over the image grid")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--which-set", default="val")
    p.add_argument("--output-dir", default="cam_out")
    p.add_argument("--num", type=int, default=8)
    p.add_argument("--branch", default="token", choices=["token", "decoder"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--cfg-options", nargs="*", default=[],
                   help="dotted overrides key=value")
    return p.parse_args(argv)


def _object_score(out: Dict[str, torch.Tensor], branch: str) -> torch.Tensor:
    """The sum over the batch of the best query's object probability."""
    ck = "class_token" if branch == "token" else "class_decoder"
    probs = torch.softmax(out[ck][-1].float(), dim=-1)[..., 0]
    return probs.max(dim=-1).values.sum()


def compute_cam(model: torch.nn.Module, inputs: Dict[str, torch.Tensor],
                branch: str) -> torch.Tensor:
    """Grad-CAM grids [B, h, w] (float32) of a batch: ``inputs`` holds
    image, text_ids and text_padding_mask on the model's device."""
    model.eval()
    image, ids = inputs["image"], inputs["text_ids"]
    if hasattr(model, "lan_enc"):  # OneStageModel
        with torch.no_grad():
            feat = model.vis_enc(image)
            text_feat, text_mask = model.text_features(ids)
        feat = feat.detach().requires_grad_(True)

        def score(a):
            b, h, w, _ = a.shape
            fused = model.fusion(a, text_feat, text_mask)
            return _object_score(model.head(
                fused, torch.zeros(b, h, w, dtype=torch.bool,
                                   device=a.device)), branch)
    else:
        if model.cfg.beit3.token_prune_keep is not None:
            raise ValueError("the CAM needs the whole vision-token grid, "
                             "which a token-pruned model does not keep")
        mask = inputs["text_padding_mask"]
        with torch.no_grad():
            img_feat, text_feat, cls_feat = model.vis_enc["beit3"](
                image, ids, mask)
        b = image.shape[0]
        g = image.shape[1] // model.cfg.beit3.patch_size
        feat = img_feat.reshape(b, g, g, -1).detach().requires_grad_(True)

        def score(a):
            pad = torch.zeros(a.shape[:3], dtype=torch.bool, device=a.device)
            return _object_score(model.head(a, pad, cls_feat, text_feat,
                                            mask), branch)

    with torch.enable_grad():
        (grad,) = torch.autograd.grad(score(feat), feat, allow_unused=True)
    if grad is None:  # the SimVG token branch never reads the grid
        return torch.zeros(feat.shape[:3], device=feat.device)
    return torch.relu((grad.float() * feat.float()).sum(-1)).detach()


def cam_inputs(batch, device, device_norm=None):
    """The batch's model inputs on ``device``, the image normalised there
    when the config leaves that to the step."""
    dev = to_device(batch, device, DEVICE_KEYS)
    if device_norm is not None:
        dev["image"] = normalize_images_on_device(
            dev["image"], device_norm["mean"], device_norm["std"],
            device_norm.get("to_rgb", True), img_shape=dev["img_shape"])
    return dev


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(parse_cfg_options(args.cfg_options))
    check_ported(cfg)
    img_size = cfg.get("img_size", 640)
    model = serving_model(cfg, args.checkpoint, device)
    ds = build_dataset_from_cfg(cfg.data[args.which_set],
                                dataset_type=cfg.get("dataset"))
    loader = build_loader_from_cfg(ds, cfg, train=False, canvas=img_size,
                                   device=device)
    batch = next(iter(loader))
    cam = compute_cam(model, cam_inputs(batch, device, device_norm_of(cfg)),
                      args.branch)

    os.makedirs(args.output_dir, exist_ok=True)
    written = 0
    for i in range(min(args.num, cam.shape[0])):
        with open(batch["meta"][i]["filename"], "rb") as f:
            img = resize_u8(decode_image(f.read(), device),
                            (img_size, img_size))
        write_jpeg(attention_overlay(img, cam[i]),
                   osp.join(args.output_dir, f"cam_{i:03d}.jpg"))
        written += 1
    print(f"wrote {written} CAMs to {args.output_dir}")
    return np.asarray(cam.cpu())


if __name__ == "__main__":
    main()
