"""Evaluation CLI of the port (counterpart of ``tools/test.py``): every
evaluation split of the config from a checkpoint, optionally with its EMA
weights.

    python -m simvg_tpu_torch.tools.test CONFIG CHECKPOINT [--with-ema]
        [--device cuda|cpu] [--cfg-options key=value ...]

It runs on the card unless ``--device cpu`` is given, and raises where
there is no card.  ``main(argv)`` runs it in-process and returns
``{split: metrics}`` (EMA results under ``"<split>[EMA]"``).
``--distributed`` (M16) and ``--quant-collection`` (M17) are not ported
yet and raise.
"""

from __future__ import annotations

import argparse
from typing import Dict

from simvg_tpu_torch.config import Config, parse_cfg_options
from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                          build_loader_from_cfg)
from simvg_tpu_torch.engine import evaluate, make_eval_step
from simvg_tpu_torch.engine.train_state import swapped_params
from simvg_tpu_torch.models import build_model
from simvg_tpu_torch.utils.checkpoint import load_checkpoint
from simvg_tpu_torch.utils.logger import get_root_logger

from .train import (check_ported, device_norm_of, eval_splits, fmt_metrics,
                    model_dtype, resolve_device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="simvg_tpu_torch test")
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("--with-ema", action="store_true",
                   help="also evaluate the EMA weights")
    p.add_argument("--quant-collection", default=None,
                   help="int8 serving collection (not ported yet: M17)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process evaluation (not ported yet: M16)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--cfg-options", nargs="*", default=[])
    return p.parse_args(argv)


def main(argv=None) -> Dict[str, Dict[str, float]]:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.quant_collection:
        raise NotImplementedError("--quant-collection is not ported yet "
                                  "(ROADMAP: M17)")
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(parse_cfg_options(args.cfg_options))
    check_ported(cfg, args.distributed)
    logger = get_root_logger()

    seed = cfg.get("seed", 6666)
    img_size = cfg.get("img_size", 640)
    nq = cfg.model.get("head", {}).get("num_queries", 1)
    max_gt = min(cfg.get("max_gt", 1), nq)
    model, _ = build_model(cfg.model, img_size=img_size,
                           dtype=model_dtype(cfg), device=device)

    norm_on_device = cfg.get("normalize_on_device", False)
    loaders = {}
    tokenizer = None
    for split in eval_splits(cfg):
        ds = build_dataset_from_cfg(cfg.data[split],
                                    dataset_type=cfg.get("dataset"),
                                    tokenizer=tokenizer, seed=seed,
                                    normalize_on_device=norm_on_device)
        tokenizer = ds.tokenizer
        loaders[split] = build_loader_from_cfg(
            ds, cfg, train=False, canvas=img_size, max_gt=max_gt, seed=seed,
            device=device)

    ck = load_checkpoint(args.checkpoint, with_ema=args.with_ema)
    model.load_state_dict(ck["params"], strict=True)
    logger.info(f"loaded {args.checkpoint} (epoch {ck['epoch']})")
    ema = None
    if args.with_ema and "ema_params" in ck:
        ema = [ck["ema_params"][n].to(device)
               for n, _ in model.named_parameters()]

    eval_step = make_eval_step(model, device_norm=device_norm_of(cfg))
    results: Dict[str, Dict[str, float]] = {}
    for split, loader in loaders.items():
        m = evaluate(model, loader, eval_step=eval_step, log_fn=logger.info,
                     log_interval=cfg.get("log_interval", 50))
        logger.info(f"[{split}] " + fmt_metrics(m))
        results[split] = m
        if ema is not None:
            with swapped_params(model, ema):
                m = evaluate(model, loader, eval_step=eval_step)
            logger.info(f"[{split}][EMA] " + fmt_metrics(m))
            results[f"{split}[EMA]"] = m
    return results


if __name__ == "__main__":
    main()
