"""Decoder cross-attention maps over the image (counterpart of
``tools/misc/attn_visual.py``): each decoder layer's attention of the
first query over the image grid, averaged over heads, drawn as a JET heat
map over the sample's image resized to the canvas.

    python -m simvg_tpu_torch.tools.attn_visual CONFIG [CHECKPOINT]
        [--which-set val] [--output-dir attn_out] [--num 8]
        [--device cuda|cpu] [--cfg-options key=value ...]

The maps are the eval forward's own probabilities, recorded by
``recorded_layer_cross_attention`` (JAX's ``intermediates``).  One file a
layer and sample, ``layers_<l>_<i>.jpg``; no text is drawn.  Without a
checkpoint the weights are random from seed 0.  It runs on the card
unless ``--device cpu`` is given; ``main(argv)`` returns the maps.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Dict

import torch

from simvg_tpu_torch.config import Config, parse_cfg_options
from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                          build_loader_from_cfg)
from simvg_tpu_torch.data.image_ops import resize_u8
from simvg_tpu_torch.data.jpeg import decode
from simvg_tpu_torch.engine.eval import eval_forward
from simvg_tpu_torch.engine.evaluate import DEVICE_KEYS
from simvg_tpu_torch.models.heads.detr_transformer import (
    recorded_layer_cross_attention)
from simvg_tpu_torch.utils.visualize import attention_overlay, write_jpeg

from .test import serving_model
from .train import check_ported, device_norm_of, resolve_device, to_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="decoder cross-attention maps")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--which-set", default="val")
    p.add_argument("--output-dir", default="attn_out")
    p.add_argument("--num", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--cfg-options", nargs="*", default=[],
                   help="dotted overrides key=value")
    return p.parse_args(argv)


@torch.no_grad()
def cross_attention_maps(model: torch.nn.Module, inputs: Dict,
                         device_norm=None) -> Dict[str, torch.Tensor]:
    """{"layers_<l>": [B, Q, S_k] head-averaged float32 probabilities} of
    one eval forward of ``inputs`` (image, text_ids, text_padding_mask,
    img_shape on the model's device)."""
    model.eval()
    with recorded_layer_cross_attention(model.head.transformer.decoder) \
            as records:
        eval_forward(model, inputs, device_norm)
    return {f"layers_{i}": rec[-1].float().mean(dim=1)
            for i, rec in enumerate(records)}


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
    maps = cross_attention_maps(model, to_device(batch, device, DEVICE_KEYS),
                                device_norm_of(cfg))
    g = img_size // cfg.model.vis_enc.get("patch_size", 32)

    os.makedirs(args.output_dir, exist_ok=True)
    written = 0
    for lname, attn in sorted(maps.items()):
        for i in range(min(args.num, attn.shape[0])):
            with open(batch["meta"][i]["filename"], "rb") as f:
                img = resize_u8(decode(f.read(), device),
                                (img_size, img_size))
            write_jpeg(attention_overlay(img, attn[i, 0].reshape(g, g)),
                       osp.join(args.output_dir, f"{lname}_{i:03d}.jpg"))
            written += 1
    print(f"wrote {written} attention maps to {args.output_dir}")
    return {k: v.cpu().numpy() for k, v in maps.items()}


if __name__ == "__main__":
    main()
