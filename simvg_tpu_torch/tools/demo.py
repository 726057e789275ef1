"""Single image + free-text expression demo of the port (counterpart of
``tools/demo.py``): the config's val pipeline on one image through
``RawPreprocessor`` (the server's route), the eval step, and the predicted
box drawn on the image.

    python -m simvg_tpu_torch.tools.demo --config CONFIG [--checkpoint CKPT]
        --img IMAGE.jpg --expression "..." [--output-dir demo_out]
        [--branch token|decoder] [--device cuda|cpu] [--cfg-options ...]

It prints the box at the original image's scale and its score, and writes
``<output-dir>/<name>_pred.jpg`` with ``<name>_pred.jpg.json`` beside it
(the expression, the box and the score: there is no font to draw them
with on the card's machine).  Without ``--checkpoint`` the weights are
random (``init_random_weights`` from seed 0).  It runs on the card unless
``--device cpu`` is given, and raises where there is no card.
An ``int8_static`` model serves with ``--quant-collection``
(``tools/quantize_serving.py``'s .npz).  ``main(argv)`` returns
``{"box", "score", "out_file"}``.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

from simvg_tpu_torch.config import Config, parse_cfg_options
from simvg_tpu_torch.data.raw import RawPreprocessor
from simvg_tpu_torch.engine import make_eval_step
from simvg_tpu_torch.engine.evaluate import DEVICE_KEYS
from simvg_tpu_torch.utils.visualize import imshow_expr_bbox

from .test import serving_model
from .train import check_ported, resolve_device, to_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="simvg_tpu_torch demo")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--img", required=True)
    p.add_argument("--expression", required=True)
    p.add_argument("--output-dir", default="demo_out")
    p.add_argument("--branch", default="token", choices=["token", "decoder"])
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

    with open(args.img, "rb") as f:
        data = f.read()
    sample = preproc(data, args.expression, filename=args.img)
    img = preproc.decode(sample)
    batch = preproc.collate([sample], [img])
    step = make_eval_step(model, device_norm=preproc.device_norm)
    preds = step(to_device(batch, device, DEVICE_KEYS))[args.branch]
    best = preds["best_box"][0].float().cpu().numpy()
    score = float(preds["best_score"][0])

    # back to the original image's scale
    box = best / batch["scale_factor"][0]
    os.makedirs(args.output_dir, exist_ok=True)
    out_file = osp.join(args.output_dir,
                        osp.splitext(osp.basename(args.img))[0] + "_pred.jpg")
    imshow_expr_bbox(img, box, out_file, expression=args.expression,
                     scores=[score])
    print(f"expression: {args.expression!r}")
    print(f"box (xyxy, original scale): {box.tolist()} score: {score:.3f}")
    print(f"wrote {out_file}")
    return {"box": box.tolist(), "score": score, "out_file": out_file}


if __name__ == "__main__":
    main()
