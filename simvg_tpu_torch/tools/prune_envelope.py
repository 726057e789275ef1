"""Token-pruning accuracy envelope on real weights (counterpart of
``tools/misc/prune_envelope.py``).

The envelope that ``BEiT3Config`` enforces (prune after layer >=
num_layers/3, keep >= 75% of the patch tokens; ``models/beit3.py::
prune_layer_of``) was measured on synthetic probes.  This tool sweeps
(token_prune_layer, keep) over a split, evaluating the token branch (the
only one pruning serves), and reports each point's Prec@0.5 drop from the
unpruned model: the data to set the envelope from once a converted real
checkpoint exists (none is in the repository).

    python -m simvg_tpu_torch.tools.prune_envelope CONFIG CHECKPOINT
        [--which-set val] [--keep-fracs 0.75 0.625 0.5]
        [--layer-fracs 0.33 0.5] [--max-batches N] [--budget 0.3]
        [--out sweep.json] [--device cuda|cpu] [--cfg-options ...]

It prints the sweep as one JSON line and returns it from ``main(argv)``.
"""

from __future__ import annotations

import argparse
import copy
import json

from simvg_tpu_torch.config import Config, parse_cfg_options
from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                          build_loader_from_cfg)
from simvg_tpu_torch.engine import evaluate
from simvg_tpu_torch.utils.logger import get_root_logger

from .test import serving_model
from .train import check_ported, resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="token-prune envelope sweep")
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("--which-set", default="val")
    p.add_argument("--keep-fracs", type=float, nargs="*",
                   default=[0.75, 0.625, 0.5],
                   help="fractions of patch tokens kept")
    p.add_argument("--layer-fracs", type=float, nargs="*",
                   default=[1 / 3, 0.5],
                   help="prune depth as a fraction of num_layers")
    p.add_argument("--max-batches", type=int, default=0,
                   help="bound the evaluation (0 = the whole split)")
    p.add_argument("--budget", type=float, default=0.3,
                   help="largest acceptable token Prec@0.5 drop (points)")
    p.add_argument("--out", default=None,
                   help="write the sweep table as JSON")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--cfg-options", nargs="*", default=[])
    return p.parse_args(argv)


def recommend(rows):
    """The shallowest layer fraction and the smallest keep fraction for
    which every sweep point at or above both held the budget (the shape of
    the shipped gate), or None."""
    ok = [r for r in rows if r["within_budget"]]
    for lf in sorted({r["layer_frac"] for r in ok}):
        for kf in sorted({r["keep_frac"] for r in ok}):
            covered = [r for r in rows
                       if r["layer_frac"] >= lf and r["keep_frac"] >= kf]
            if covered and all(r["within_budget"] for r in covered):
                return dict(min_layer_frac=lf, min_keep_frac=kf)
    return None


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(parse_cfg_options(args.cfg_options))
    check_ported(cfg)
    logger = get_root_logger()
    img_size = cfg.get("img_size", 640)
    seed = cfg.get("seed", 6666)
    ds = build_dataset_from_cfg(cfg.data[args.which_set],
                                dataset_type=cfg.get("dataset"), seed=seed)
    loader = build_loader_from_cfg(ds, cfg, train=False, canvas=img_size,
                                   max_gt=1, seed=seed, device=device)

    def run_point(vis_overrides):
        point = copy.deepcopy(cfg)
        point.model.vis_enc.update(vis_overrides)
        model = serving_model(point, args.checkpoint, device)
        m = evaluate(model, loader, max_batches=args.max_batches or None)
        return float(m["token_det_acc"])

    ve = cfg.model["vis_enc"]
    ps = ve.get("patch_size", 32)
    n_layers = ve.get("num_layers",
                      24 if ve.get("vit_type") == "large" else 12)
    n_patches = (img_size // ps) ** 2

    base = run_point({"token_prune_keep": None})
    logger.info(f"baseline (unpruned) token det_acc: {base:.2f}")
    rows = []
    for lf in args.layer_fracs:
        # valid prune points are 0..num_layers-2
        layer = min(max(0, round(n_layers * lf)), n_layers - 2)
        for kf in args.keep_fracs:
            keep = max(1, round(n_patches * kf))
            acc = run_point({"token_prune_keep": keep,
                             "token_prune_layer": layer,
                             "token_prune_force": True})
            drop = base - acc
            rows.append(dict(layer=layer, layer_frac=round(lf, 3),
                             keep=keep, keep_frac=round(kf, 3),
                             token_det_acc=round(acc, 2),
                             drop=round(drop, 2),
                             within_budget=drop <= args.budget))
            logger.info(f"layer={layer} ({lf:.2f}L) keep={keep} ({kf:.2f}) "
                        f"-> {acc:.2f} (drop {drop:+.2f})")
    summary = dict(baseline_token_det_acc=round(base, 2), budget=args.budget,
                   sweep=rows, recommended_envelope=recommend(rows))
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
