"""Export a model's serving forward as one file (counterpart of
``tools/misc/export_serving.py``, on ``torch.export``;
``simvg_tpu_torch/export.py``).

    python -m simvg_tpu_torch.tools.export_serving CONFIG [CHECKPOINT]
        [--out model.pt2] [--polymorphic-batch] [--batch-size N]
        [--device cuda|cpu] [--cfg-options ...]

    # serving site:
    from simvg_tpu_torch.export import load_exported
    preds = load_exported("model.pt2").call(batch)

The example batch is the first batch of the config's val split (tiled to
``--batch-size``); its shapes, dtypes and device are the program's, the
batch axis symbolic with ``--polymorphic-batch``.  Without a checkpoint the
weights are random (``init_random_weights`` from seed 0).  The program runs
on the device it was exported on: export on the card to serve on the card.
``--target-platforms`` (JAX's cross-platform lowering) has no counterpart
and raises.  An ``int8_static`` model exports with the quant tensors of
``--quant-collection`` baked in (``"quantized"`` in the meta).  It writes
``<out>.json`` (the meta, with the counts of K1 and ``_int_mm`` nodes in
the graph) and prints it as its last line; ``main(argv)`` returns it.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from simvg_tpu_torch.config import Config, parse_cfg_options
from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                          build_loader_from_cfg)
from simvg_tpu_torch.export import (SERVING_INPUTS, attention_op_count,
                                    export_serving, int_mm_op_count,
                                    save_exported)

from .test import serving_model
from .train import check_ported, device_norm_of, resolve_device, to_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="serving export")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="trained checkpoint (omit for random weights)")
    p.add_argument("--out", default="model.pt2")
    p.add_argument("--polymorphic-batch", action="store_true",
                   help="symbolic batch axis: one program serves any batch "
                        "size")
    p.add_argument("--batch-size", type=int, default=None,
                   help="static batch size (default: the loader's)")
    p.add_argument("--target-platforms", nargs="+", default=None,
                   help="no counterpart in torch.export (raises)")
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
    model = serving_model(cfg, args.checkpoint, device,
                          quant_collection=args.quant_collection)

    norm_on_device = cfg.get("normalize_on_device", False)
    ds = build_dataset_from_cfg(cfg.data["val"],
                                dataset_type=cfg.get("dataset"),
                                normalize_on_device=norm_on_device)
    loader = build_loader_from_cfg(ds, cfg, train=False, canvas=img_size,
                                   device=device)
    batch = to_device(next(iter(loader)), device, SERVING_INPUTS)
    if args.batch_size:
        n = args.batch_size
        # whole batches tiled, then cut to n rows
        batch = {k: torch.cat([v] * -(-n // v.shape[0]))[:n]
                 for k, v in batch.items()}

    prog = export_serving(model, batch,
                          polymorphic_batch=args.polymorphic_batch,
                          device_norm=device_norm_of(cfg),
                          platforms=args.target_platforms)
    save_exported(args.out, prog)
    meta = dict(prog.meta, out=args.out, bytes=os.path.getsize(args.out),
                attention_op_nodes=attention_op_count(prog),
                int_mm_nodes=int_mm_op_count(prog))
    with open(args.out + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(meta))
    return meta


if __name__ == "__main__":
    main()
