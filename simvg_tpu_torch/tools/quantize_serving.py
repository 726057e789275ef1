"""Calibrate an int8_static serving artifact for a trained model
(counterpart of ``tools/misc/quantize_serving.py``; ``ops/quant.py``).

N batches of a split run through the model in ``int8_calib`` mode, whose
layers record the running max |activation|; the static collection
(per-output-channel int8 weights and the calibrated activation scales,
times ``--margin``) is saved as JAX's ``.npz`` (flax paths as keys), which
both packages' ``--quant-collection`` read.

    python -m simvg_tpu_torch.tools.quantize_serving CONFIG [CHECKPOINT]
        [--which-set val] [--num-batches 8] [--margin 1.05]
        [--out quant_collection.npz] [--device cuda|cpu]
        [--cfg-options ...]

Serve with ``--cfg-options model.vis_enc.quant=int8_static
--quant-collection quant_collection.npz`` on any serving CLI of the port.
The batches go through the eval step with the config's on-device
normalisation (``normalize_on_device``), so the layers record the
activations that serving feeds them.  Without a checkpoint the weights
are random (``init_random_weights`` from seed 0).  It runs on the card
unless ``--device cpu`` is given (JAX's ``--platform``), and raises where
there is no card.  It prints one JSON line, which ``main(argv)`` returns.
"""

from __future__ import annotations

import argparse
import copy
import json

from simvg_tpu_torch.config import Config, parse_cfg_options
from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                          build_loader_from_cfg)
from simvg_tpu_torch.engine import make_eval_step
from simvg_tpu_torch.engine.evaluate import DEVICE_KEYS
from simvg_tpu_torch.ops.quant import (build_quant_collection,
                                       calibration_amax, reset_calibration,
                                       save_quant_collection)

from .test import serving_model
from .train import check_ported, device_norm_of, resolve_device, to_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="int8_static calibration")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="trained checkpoint (omit for random weights, "
                        "e.g. smoke runs)")
    p.add_argument("--which-set", default="val")
    p.add_argument("--num-batches", type=int, default=8)
    p.add_argument("--margin", type=float, default=1.05,
                   help="headroom multiplier on calibrated act maxima")
    p.add_argument("--out", default="quant_collection.npz")
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
    calib_cfg = copy.deepcopy(cfg)
    calib_cfg.merge_from_dict({"model.vis_enc.quant": "int8_calib"})
    model = serving_model(calib_cfg, args.checkpoint, device)
    reset_calibration(model)

    ds = build_dataset_from_cfg(cfg.data[args.which_set],
                                dataset_type=cfg.get("dataset"),
                                normalize_on_device=cfg.get(
                                    "normalize_on_device", False))
    loader = build_loader_from_cfg(ds, cfg, train=False,
                                   canvas=cfg.get("img_size", 640),
                                   device=device)
    step = make_eval_step(model, device_norm=device_norm_of(cfg))
    seen = 0
    for batch in loader:
        if seen >= args.num_batches:
            break
        step(to_device(batch, device, DEVICE_KEYS))
        seen += 1
    if seen == 0:
        raise SystemExit("no calibration batches produced")

    amax = calibration_amax(model)
    save_quant_collection(args.out, build_quant_collection(
        model, amax, margin=args.margin))
    values = [float(a) for a in amax.values()]
    res = {"out": args.out, "calibration_batches": seen,
           "quantized_layers": len(values), "act_amax_max": max(values),
           "act_amax_min": min(values), "margin": args.margin}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
