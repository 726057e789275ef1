"""Evaluation CLI of the port (counterpart of ``tools/test.py``): every
evaluation split of the config from a checkpoint, optionally with its EMA
weights.

    python -m simvg_tpu_torch.tools.test CONFIG CHECKPOINT [--with-ema]
        [--device cuda|cpu] [--distributed] [--cfg-options key=value ...]

It runs on the card unless ``--device cpu`` is given, and raises where
there is no card.  ``main(argv)`` runs it in-process and returns
``{split: metrics}`` (EMA results under ``"<split>[EMA]"``); a GRefCOCO
config's metrics are the per-branch F1/N-acc.  An ``int8_static`` model
(``--cfg-options model.vis_enc.quant=int8_static``) serves with the
``--quant-collection`` artifact of ``tools/quantize_serving.py``: its
activation scales, with the weights quantized from the ones evaluated
(the EMA weights for the EMA results).  ``--distributed`` (under
torchrun, as the train CLI) evaluates each rank's shard of every split on
the config's layout (FSDP2 with ``fsdp``, leaves of ``fsdp_min_size``
elements and more sharded; tensor parallelism with ``model_parallel``) and
sums the counters over the ranks: every rank returns the whole split's
metrics.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch.distributed as dist

from simvg_tpu_torch.config import Config, parse_cfg_options
from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                          build_loader_from_cfg)
from simvg_tpu_torch.engine import evaluate, make_eval_step
from simvg_tpu_torch.engine.train_state import swapped_params
from simvg_tpu_torch.models import build_model, init_random_weights
from simvg_tpu_torch.ops.quant import attach_static_quant
from simvg_tpu_torch.parallel import shard_of
from simvg_tpu_torch.utils.checkpoint import load_checkpoint
from simvg_tpu_torch.utils.logger import get_root_logger

from .train import (check_ported, device_norm_of, eval_splits, fmt_metrics,
                    gt_settings, layout, layout_line, model_dtype,
                    resolve_device, setup_distributed)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="simvg_tpu_torch test")
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("--with-ema", action="store_true",
                   help="also evaluate the EMA weights")
    p.add_argument("--quant-collection", default=None,
                   help="int8_static calibration artifact (.npz) from "
                        "tools/quantize_serving.py")
    p.add_argument("--distributed", action="store_true",
                   help="one process per card, each on its shard of every "
                        "split (under torchrun)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--cfg-options", nargs="*", default=[])
    return p.parse_args(argv)


def serving_model(cfg, checkpoint, device, seed: int = 0,
                  quant_collection=None):
    """The config's model on ``device`` in eval mode, with the params of
    ``checkpoint`` (a checkpoint directory of the port), or random weights
    from ``seed`` (``init_random_weights``) when it is None; an
    ``int8_static`` model gets its quant tensors from those weights and
    the ``quant_collection`` .npz (``attach_static_quant``)."""
    model, _ = build_model(cfg.model, img_size=cfg.get("img_size", 640),
                           dtype=model_dtype(cfg), device="meta")
    model = model.to_empty(device=device)
    if checkpoint:
        model.load_state_dict(load_checkpoint(checkpoint)["params"],
                              strict=True)
    else:
        init_random_weights(model, seed)
    return attach_static_quant(model, quant_collection).eval()


def main(argv=None) -> Dict[str, Dict[str, float]]:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(parse_cfg_options(args.cfg_options))
    check_ported(cfg, args.distributed)
    device, mesh = setup_distributed(args, cfg, device)
    try:
        return _test(args, cfg, device, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _test(args, cfg, device, mesh) -> Dict[str, Dict[str, float]]:
    logger = get_root_logger()
    logger.info(layout_line(mesh, cfg))
    shards = ({} if mesh is None else
              dict(shard_id=mesh["data"].get_local_rank(),
                   num_shards=mesh["data"].size()))

    seed = cfg.get("seed", 6666)
    img_size = cfg.get("img_size", 640)
    is_grec, max_gt = gt_settings(cfg)
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
            device=device, **shards)

    ck = load_checkpoint(args.checkpoint, with_ema=args.with_ema)
    model.load_state_dict(ck["params"], strict=True)
    attach_static_quant(model, args.quant_collection)
    sharded = layout(model, mesh, cfg)
    batch_sum = None if sharded is None else sharded.batch_sum
    logger.info(f"loaded {args.checkpoint} (epoch {ck['epoch']})")
    ema = None
    if args.with_ema and "ema_params" in ck:
        ema = [shard_of(ck["ema_params"][n], p)
               for n, p in model.named_parameters()]

    eval_step = make_eval_step(model, device_norm=device_norm_of(cfg))
    results: Dict[str, Dict[str, float]] = {}
    for split, loader in loaders.items():
        m = evaluate(model, loader, is_grec=is_grec, eval_step=eval_step,
                     log_fn=logger.info,
                     log_interval=cfg.get("log_interval", 50),
                     batch_sum=batch_sum)
        logger.info(f"[{split}] " + fmt_metrics(m))
        results[split] = m
        if ema is not None:
            with swapped_params(model, ema):
                # the EMA weights' own quantization, the .npz's act_scale
                attach_static_quant(model, args.quant_collection)
                m = evaluate(model, loader, is_grec=is_grec,
                             eval_step=eval_step, batch_sum=batch_sum)
            attach_static_quant(model, args.quant_collection)
            logger.info(f"[{split}][EMA] " + fmt_metrics(m))
            results[f"{split}[EMA]"] = m
    return results


if __name__ == "__main__":
    main()
