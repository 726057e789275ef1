"""The pipeline's output drawn (counterpart of
``tools/misc/browse_dataset.py``): each sample of a split through the
config's pipeline, un-normalised for display, with its GT boxes in blue.

    python -m simvg_tpu_torch.tools.browse_dataset CONFIG
        [--which-set train] [--output-dir browse_out] [--num 20]
        [--device cuda|cpu] [--cfg-options key=value ...]

Images are decoded and rendered as the loader renders them
(``data/image_ops.py``; nvJPEG on the card), unpadded; the expression goes
to ``<file>.json`` beside each image, as no text is drawn.  It runs on the
card unless ``--device cpu`` is given; ``main(argv)`` returns the files
written.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import List

import numpy as np
import torch

from simvg_tpu_torch.config import Config, parse_cfg_options
from simvg_tpu_torch.data.builder import build_dataset_from_cfg
from simvg_tpu_torch.data.image_ops import render
from simvg_tpu_torch.data.jpeg import decode
from simvg_tpu_torch.utils.visualize import imshow_expr_bbox

from .train import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="the pipeline's samples drawn")
    p.add_argument("config")
    p.add_argument("--which-set", default="train")
    p.add_argument("--output-dir", default="browse_out")
    p.add_argument("--num", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--cfg-options", nargs="*", default=[],
                   help="dotted overrides key=value")
    return p.parse_args(argv)


def main(argv=None) -> List[str]:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(parse_cfg_options(args.cfg_options))
    ds = build_dataset_from_cfg(cfg.data[args.which_set],
                                dataset_type=cfg.get("dataset"))
    os.makedirs(args.output_dir, exist_ok=True)
    norm = cfg.get("img_norm_cfg", {})
    mean = torch.tensor(norm.get("mean", [0, 0, 0]), dtype=torch.float32,
                        device=device)
    std = torch.tensor(norm.get("std", [1, 1, 1]), dtype=torch.float32,
                       device=device)

    written = []
    for i in range(min(args.num, len(ds))):
        s = ds[i]
        img = render(s, decode(s["img_bytes"], device))
        if img.dtype != torch.uint8:  # un-normalise, RGB -> BGR
            img = (img * std + mean).flip(-1).clamp(0, 255).to(torch.uint8)
        gb = s.get("gt_bbox")
        boxes = np.stack(gb) if isinstance(gb, list) else gb
        out = osp.join(args.output_dir, f"{i:04d}.jpg")
        imshow_expr_bbox(img, np.zeros((0, 4)), out, gt_bbox=boxes,
                         expression=s.get("expression"))
        written.append(out)
    print(f"wrote {len(written)} images to {args.output_dir}")
    return written


if __name__ == "__main__":
    main()
