"""One raw image and an expression: the Grad-CAM heat map with the
predicted box drawn on top (counterpart of ``tools/misc/heatmap.py``).

    python -m simvg_tpu_torch.tools.heatmap CONFIG [CHECKPOINT]
        --image-path X.jpg --text "..." [--branch decoder|token]
        [--save-dir visualize/GradCAM] [--quant-collection q.npz]
        [--device cuda|cpu] [--cfg-options key=value ...]

The JPEG goes through the val pipeline's raw-source path
(``data/raw.py``), the eval step gives the best box and score, and
``vis_cam.compute_cam`` the CAM of the same input.  As in JAX, the CAM is
coloured with JET on its grid, resized to the original image, blended
0.4 image + 0.6 heat (truncated to uint8) and the box drawn in red; no
label text is drawn.  Prints ``box (xyxy, original scale): [...] score:
...`` and writes ``<stem>-<branch>-heatmap.jpg``.  It runs on the card
unless ``--device cpu`` is given; ``main(argv)`` returns the box, the
score, the CAM and the file written.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from simvg_tpu_torch.config import Config, parse_cfg_options
from simvg_tpu_torch.data.image_ops import resize_u8
from simvg_tpu_torch.data.raw import RawPreprocessor
from simvg_tpu_torch.engine import make_eval_step
from simvg_tpu_torch.engine.evaluate import DEVICE_KEYS
from simvg_tpu_torch.utils.visualize import (PRED_COLOR, draw_boxes,
                                             jet_table, write_jpeg)

from .test import serving_model
from .train import check_ported, resolve_device, to_device
from .vis_cam import cam_inputs, compute_cam


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Grad-CAM heat map over one raw "
                                "image and an expression")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--image-path", required=True)
    p.add_argument("--text", required=True, help="referring expression")
    p.add_argument("--branch", default="decoder",
                   choices=["token", "decoder"])
    p.add_argument("--save-dir", default="visualize/GradCAM")
    p.add_argument("--quant-collection", default=None,
                   help="int8_static calibration artifact (.npz) from "
                        "tools/quantize_serving.py")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--cfg-options", nargs="*", default=[],
                   help="dotted overrides key=value")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(parse_cfg_options(args.cfg_options))
    check_ported(cfg)
    model = serving_model(cfg, args.checkpoint, device,
                          quant_collection=args.quant_collection)
    preproc = RawPreprocessor(cfg, device)
    with open(args.image_path, "rb") as f:
        data = f.read()
    sample = preproc(data, args.text, filename=args.image_path)
    img = preproc.decode(sample)
    batch = preproc.collate([sample], [img])

    # the prediction on the same input the CAM sees
    step = make_eval_step(model, device_norm=preproc.device_norm)
    preds = step(to_device(batch, device, DEVICE_KEYS))[args.branch]
    box = preds["best_box"][0].float().cpu().numpy() \
        / batch["scale_factor"][0]  # back to the original image's scale
    score = float(preds["best_score"][0])
    cam = compute_cam(model, cam_inputs(batch, device, preproc.device_norm),
                      args.branch)[0]

    h, w = img.shape[:2]
    levels = (cam / cam.max().clamp_min(1e-8) * 255).to(dtype=img.dtype)
    heat = resize_u8(jet_table(img.device)[levels.long()], (h, w))
    vis = (img.float() * 0.4 + heat.float() * 0.6).to(img.dtype)
    draw_boxes(vis, [[int(round(v)) for v in box.tolist()]], PRED_COLOR,
               thickness=max(1, w // 112))

    os.makedirs(args.save_dir, exist_ok=True)
    stem = osp.splitext(osp.basename(args.image_path))[0]
    out = osp.join(args.save_dir, f"{stem}-{args.branch}-heatmap.jpg")
    write_jpeg(vis, out)
    print(f"expression: {args.text!r}")
    print(f"box (xyxy, original scale): {box.tolist()} score: {score:.3f}")
    print(f"wrote {out}")
    return {"box": box.tolist(), "score": score,
            "cam": np.asarray(cam.cpu()), "out_file": out}


if __name__ == "__main__":
    main()
