"""Batch inference and visualisation dumps of the port (counterpart of
``tools/inference.py``): a split through the model, each image written
with its predicted (red) and GT (blue) boxes; GRefCOCO keeps the boxes
whose score is at or above ``--score-threshold``.  ``--with-attn`` also
writes each image's overlay of the last decoder layer's cross-attention,
averaged over heads (``<name>_attn.jpg``).

    python -m simvg_tpu_torch.tools.inference CONFIG CHECKPOINT
        [--which-set val] [--output-dir inference_out]
        [--branch token|decoder] [--score-threshold 0.7]
        [--max-images 100] [--with-attn] [--device cuda|cpu]
        [--cfg-options ...]

Each image ``<out>.jpg`` has ``<out>.jpg.json`` beside it with the
expression, the boxes at the original image's scale and their scores.  The
images are decoded, drawn on, coloured (cv2's JET table) and encoded on
the card (``utils/visualize.py``).  It runs on the card unless ``--device
cpu`` is given, and raises where there is no card.  An ``int8_static``
model serves with ``--quant-collection`` (``tools/quantize_serving.py``'s
.npz).  ``--with-attn`` raises on a token-pruned model, whose decoder does
not run.  ``main(argv)`` returns one record per image
written: ``{"file", "boxes", "scores"}``.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

from simvg_tpu_torch.config import Config, parse_cfg_options
from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                          build_loader_from_cfg)
from simvg_tpu_torch.data.image_file import decode_image
from simvg_tpu_torch.engine import make_eval_step
from simvg_tpu_torch.engine.evaluate import DEVICE_KEYS
from simvg_tpu_torch.models.heads.detr_transformer import (
    recorded_cross_attention)
from simvg_tpu_torch.utils.visualize import (attention_overlay,
                                             imshow_expr_bbox, write_jpeg)

from .test import serving_model
from .train import check_ported, gt_settings, resolve_device, to_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="simvg_tpu_torch inference")
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("--which-set", default="val")
    p.add_argument("--output-dir", default="inference_out")
    p.add_argument("--branch", default="token", choices=["token", "decoder"])
    p.add_argument("--score-threshold", type=float, default=0.7)
    p.add_argument("--max-images", type=int, default=100)
    p.add_argument("--with-attn", action="store_true",
                   help="also write decoder cross-attention heatmaps")
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
    img_size = cfg.get("img_size", 640)
    is_grec, max_gt = gt_settings(cfg)
    model = serving_model(cfg, args.checkpoint, device,
                          quant_collection=args.quant_collection)
    if args.with_attn and model.cfg.beit3.token_prune_keep is not None:
        raise ValueError("--with-attn needs the decoder branch, which a "
                         "token-pruned model does not run")

    ds = build_dataset_from_cfg(cfg.data[args.which_set],
                                dataset_type=cfg.get("dataset"))
    loader = build_loader_from_cfg(ds, cfg, train=False, canvas=img_size,
                                   max_gt=max_gt, device=device)
    step = make_eval_step(model)
    grid = img_size // model.cfg.beit3.patch_size

    os.makedirs(args.output_dir, exist_ok=True)
    records = []
    for batch in loader:
        dev = to_device(batch, device, DEVICE_KEYS)
        attn = None
        if args.with_attn:
            # one forward for the predictions and the attention maps
            with recorded_cross_attention(model.head.transformer.decoder) \
                    as weights:
                preds = step(dev)
            attn = weights[-1].float().mean(dim=1)  # [B, Q, HW]
        else:
            preds = step(dev)
        p_b = {k: v.float().cpu().numpy() for k, v in
               preds[args.branch].items()}
        for i, meta in enumerate(batch["meta"]):
            if not batch["batch_valid"][i] or len(records) >= args.max_images:
                continue
            with open(meta["filename"], "rb") as f:
                img = decode_image(f.read(), device)
            sf = batch["scale_factor"][i]
            if is_grec:
                keep = p_b["scores"][i] >= args.score_threshold
                boxes = p_b["boxes"][i][keep] / sf
                scores = p_b["scores"][i][keep]
            else:
                boxes = p_b["best_box"][i][None] / sf
                scores = p_b["best_score"][i][None]
            nt = int(batch["gt_valid"][i].sum())
            gt = batch["gt_boxes"][i, :nt] / sf
            out_file = osp.join(
                args.output_dir, f"{len(records):05d}_"
                + osp.splitext(osp.basename(meta["filename"]))[0] + ".jpg")
            imshow_expr_bbox(img, boxes, out_file, gt_bbox=gt,
                             expression=meta["expression"],
                             scores=scores.tolist())
            if attn is not None:
                write_jpeg(attention_overlay(img, attn[i, 0].reshape(
                    grid, grid)), out_file.replace(".jpg", "_attn.jpg"))
            records.append({"file": out_file, "boxes": boxes.tolist(),
                            "scores": scores.tolist()})
        if len(records) >= args.max_images:
            break
    print(f"wrote {len(records)} visualisations to {args.output_dir}")
    return records


if __name__ == "__main__":
    main()
