"""Training CLI of the port (counterpart of ``tools/train.py``).

    python -m simvg_tpu_torch.tools.train CONFIG [--work-dir W]
        [--resume-from CKPT | --load-from CKPT | --finetune-from CKPT]
        [--auto-resume] [--seed N] [--device cuda|cpu] [--distributed]
        [--cfg-options key=value ...]
    torchrun --nproc_per_node N -m simvg_tpu_torch.tools.train CONFIG
        --distributed ...

The JAX CLI's order: datasets and loaders, the model, the ``pretrain``
load when the file exists, the optimizer and schedule, the three load modes
and auto-resume, then the epoch loop (log lines, ``metrics.jsonl``), an
evaluation of each split after each epoch and the checkpoints ``det_best``
(from the ``val`` split), ``latest`` and ``epoch_N``, with EMA when the
config has it.  It runs on the card unless ``--device cpu`` is given, and
raises where there is no card.  ``main(argv)`` runs it in-process and
returns its results.

GRefCOCO configs (``dataset = "GRefCOCO"``) log the train F1/N-acc of each
branch at the log lines (``{branch}_F1``, ``{branch}_Nacc`` in
``metrics.jsonl``) and evaluate F1/N-acc; ``det_best`` keys on ``det_acc``
(for GRefCOCO the mean F1), as in the JAX CLI.

``--distributed`` runs one process per card (torchrun's environment, or
the JAX launcher's; ``parallel/mesh.py``) on a ("data", "model") mesh of
world / ``model_parallel`` by ``model_parallel``: DDP, or FSDP2 with
``fsdp`` (leaves of ``fsdp_min_size`` elements and more sharded), and
tensor parallelism on the model axis (with ``seq_parallel`` the residual
stream sharded over the sequence).  Each rank loads its shard of every
split (the global batch is ``samples_per_gpu`` x dp), the evaluation's
counters are summed over the ranks, and rank 0 alone writes the log, the
config, ``metrics.jsonl`` and the checkpoints, in the single-device format.
Without ``--distributed`` the run is single-device, where ``fsdp`` and the
model axis shard nothing.

The optimizer is the config's ``optimizer_config.type`` (Adam, AdamW with
``weight_decay``, SGD, RMSProp), as JAX's CLI builds it; a pipeline with
``with_mask`` carries ``gt_mask_rle`` and ``is_crowd`` into evaluation.
The OneStageModel family (``configs/smoke/tiny_synth_onestage.py``) trains
with the loss settings of ``make_train_step``'s defaults where its head
dict gives none, with any pure-vision backbone of the zoo and the GRU or
ALBERTA language encoder, and a pipeline may set the legacy
``VGTRAugment`` (``configs/_base_/datasets/detection/refcoco-unc_vgtr.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from simvg_tpu_torch.config import Config, parse_cfg_options
from simvg_tpu_torch.convert import load_pretrained_into_model
from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                          build_loader_from_cfg)
from simvg_tpu_torch.engine import (create_optimizer, create_train_state,
                                    evaluate, make_eval_step,
                                    make_train_step)
from simvg_tpu_torch.engine.evaluate import (grec_rows, grec_summary,
                                             new_grec_lists)
from simvg_tpu_torch.engine.train_state import (make_lr_schedule,
                                                swapped_params)
from simvg_tpu_torch.models import (build_model, decode_predictions,
                                    init_random_weights)
from simvg_tpu_torch.parallel import (FSDP_MIN_SIZE, create_mesh,
                                      init_distributed, shard_model)
from simvg_tpu_torch.utils.checkpoint import (full_named, latest_checkpoint,
                                              load_checkpoint,
                                              load_model_state, load_named,
                                              load_opt_state, model_state,
                                              opt_state_to_dict,
                                              save_checkpoint,
                                              wait_for_checkpoints)
from simvg_tpu_torch.utils.logger import get_root_logger

# the keys the train step reads; batch_valid and meta stay on the host
STEP_KEYS = ("image", "text_ids", "text_padding_mask", "img_shape",
             "gt_boxes", "gt_labels", "gt_valid", "gt_count")
_LOADER_KEYS = ("train", "samples_per_gpu", "workers_per_gpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="simvg_tpu_torch train")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--load-from", default=None)
    p.add_argument("--finetune-from", default=None)
    p.add_argument("--auto-resume", action="store_true",
                   help="resume from <work_dir>/latest if present")
    p.add_argument("--distributed", action="store_true",
                   help="one process per card, under torchrun (or the JAX "
                        "launcher's COORDINATOR_ADDRESS environment)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--cfg-options", nargs="*", default=[],
                   help="dotted overrides key=value")
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """The CLIs' device: ``cuda`` needs a card (no fallback), ``cpu`` is
    for the tests.  TF32 is turned off for every device (float32 configs
    must run float32 matmuls and convolutions on the card)."""
    disable_tf32()
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the "
                           "CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device


def disable_tf32() -> None:
    """float32 matmuls and cuDNN convolutions in full float32: torch's
    default runs cuDNN's (the patch embedding, the head's 1x1 input_proj)
    on TF32, which breaks float32 parity with the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_ported(cfg, distributed: bool = False) -> None:
    """Raises NotImplementedError for a combination the port does not
    have: int8 layers or token pruning under tensor parallelism (a
    ``--distributed`` run with ``model_parallel`` > 1), and on the
    OneStageModel family the options of the BEiT-3 encoder it does not
    have (token pruning, int8, remat, tensor and sequence parallelism)."""
    ve = cfg.model.get("vis_enc") or {}
    if cfg.model.get("type") == "OneStageModel":
        beit3_only = {
            "token pruning": ve.get("token_prune_keep") is not None,
            "int8": ve.get("quant", "none") != "none",
            "remat": bool(ve.get("remat")),
            "sequence parallelism": bool(ve.get("seq_parallel")),
            "tensor parallelism": distributed
            and cfg.get("model_parallel", 1) > 1}
        used = [k for k, v in beit3_only.items() if v]
        if used:
            raise NotImplementedError(
                f"{', '.join(used)}: options of the BEiT-3 encoder, which "
                "the OneStageModel family does not have")
    if distributed and cfg.get("model_parallel", 1) > 1 and (
            ve.get("quant", "none") != "none"
            or ve.get("token_prune_keep") is not None):
        raise NotImplementedError("int8 layers and token pruning under "
                                  "tensor parallelism are not ported")


def setup_distributed(args, cfg, device: torch.device):
    """(device, mesh) of the run: with ``--distributed`` this process's
    card (or the CPU) and the ("data", "model") mesh over the process
    group it joins; otherwise ``device`` and no mesh."""
    if not args.distributed:
        return device, None
    local_rank = init_distributed(device.type)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank)
    return device, create_mesh(cfg.get("model_parallel", 1), device.type)


def layout(model, mesh, cfg):
    """The model on the mesh (``shard_model``), None without one."""
    if mesh is None:
        return None
    return shard_model(model, mesh, fsdp=bool(cfg.get("fsdp", False)),
                       fsdp_min_size=int(cfg.get("fsdp_min_size",
                                                 FSDP_MIN_SIZE)))


def layout_line(mesh, cfg) -> str:
    if mesh is None:
        return ("single device" + (" (fsdp and model_parallel shard "
                                   "nothing here)"
                                   if cfg.get("fsdp", False)
                                   or cfg.get("model_parallel", 1) > 1
                                   else ""))
    return (f"mesh data {mesh['data'].size()} x model "
            f"{mesh['model'].size()}, "
            + ("fsdp" if cfg.get("fsdp", False) else
               "ddp" if mesh["model"].size() == 1 else "tensor parallel"))


def gt_settings(cfg):
    """(is_grec, max_gt): GRefCOCO keeps up to 12 targets a sample by
    default, every other dataset 1; never more than the head's queries
    (a target beyond them cannot be matched)."""
    is_grec = cfg.get("dataset") == "GRefCOCO"
    nq = cfg.model.get("head", {}).get("num_queries", 1)
    return is_grec, min(cfg.get("max_gt", 12 if is_grec else 1), nq)


def grec_train_metrics(preds: Dict, batch: Dict, img_shape: torch.Tensor,
                       batch_sum=None) -> Dict[str, float]:
    """The train batch's F1 and N-acc of each branch, on the host, from the
    step's last-layer (class logits, boxes), decoded here; with
    ``batch_sum`` over the global batch."""
    out = {}
    for name, (logits, boxes) in preds.items():
        acc = new_grec_lists()
        grec_rows(acc, decode_predictions(logits, boxes, img_shape), batch)
        m = grec_summary(acc, batch_sum)
        out[f"{name}_F1"] = m["F1_score"]
        out[f"{name}_Nacc"] = m["N_acc"]
    return out


def eval_splits(cfg) -> List[str]:
    return [k for k in cfg.data if k not in _LOADER_KEYS]


def model_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.get("use_bf16", True) else torch.float32


def device_norm_of(cfg) -> Optional[Dict]:
    """The step's on-device normalisation when the pipeline leaves it to
    the step (``normalize_on_device``)."""
    if not cfg.get("normalize_on_device", False):
        return None
    return dict(cfg.get("img_norm_cfg", {})) or None


def to_device(batch: Dict, device: torch.device, keys=STEP_KEYS) -> Dict:
    return {k: torch.as_tensor(batch[k]).to(device, non_blocking=True)
            for k in keys if k in batch}


def fmt_metrics(metrics: Dict[str, float]) -> str:
    return ", ".join(f"{k}: {v:.2f}" for k, v in metrics.items())


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(parse_cfg_options(args.cfg_options))
    check_ported(cfg, args.distributed)
    device, mesh = setup_distributed(args, cfg, device)
    try:
        return _train(args, cfg, device, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _train(args, cfg, device: torch.device, mesh) -> Dict:
    seed = args.seed if args.seed is not None else cfg.get("seed", 6666)
    if cfg.get("debug_nans", False):
        torch.autograd.set_detect_anomaly(True)

    work_dir = args.work_dir or cfg.get("work_dir") or osp.join(
        "work_dir", osp.splitext(osp.basename(args.config))[0])
    # rank 0 alone writes: with a shared work_dir other ranks would
    # interleave the log and metrics lines and race the checkpoint swaps
    main_rank = mesh is None or dist.get_rank() == 0
    dp = 1 if mesh is None else mesh["data"].size()
    dp_rank = 0 if mesh is None else mesh["data"].get_local_rank()
    os.makedirs(work_dir, exist_ok=True)
    timestamp = time.strftime("%Y%m%d_%H%M%S")
    logger = get_root_logger(osp.join(work_dir,
                                      f"{timestamp}_train_log.txt")
                             if main_rank else None)
    if main_rank:
        cfg.dump(osp.join(work_dir, "config.py"))
    logger.info(f"work_dir: {work_dir}; device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})"
                   if device.type == "cuda" else "")
                + f"; {layout_line(mesh, cfg)}")

    # ---- data
    img_size = cfg.get("img_size", 640)
    is_grec, max_gt = gt_settings(cfg)
    norm_on_device = cfg.get("normalize_on_device", False)
    train_ds = build_dataset_from_cfg(cfg.data.train,
                                      dataset_type=cfg.get("dataset"),
                                      seed=seed,
                                      normalize_on_device=norm_on_device)
    shards = dict(shard_id=dp_rank, num_shards=dp)
    train_loader = build_loader_from_cfg(train_ds, cfg, train=True,
                                         canvas=img_size, max_gt=max_gt,
                                         seed=seed, device=device, **shards)
    logger.info(f"train: {len(train_ds)} samples, "
                f"{len(train_loader)} steps/epoch")
    val_loaders = {}
    splits = eval_splits(cfg)
    for split in splits:
        ds = build_dataset_from_cfg(cfg.data[split],
                                    dataset_type=cfg.get("dataset"),
                                    tokenizer=train_ds.tokenizer, seed=seed,
                                    normalize_on_device=norm_on_device)
        val_loaders[split] = build_loader_from_cfg(
            ds, cfg, train=False, canvas=img_size, max_gt=max_gt, seed=seed,
            device=device, **shards)
        logger.info(f"{split}: {len(ds)} samples")
    if len(train_loader) == 0:
        raise ValueError(
            f"train loader is empty: batch {cfg.data.get('samples_per_gpu')}"
            f" exceeds the {len(train_ds)}-sample dataset (drop_last). "
            "Reduce data.samples_per_gpu.")

    # ---- model: random weights from the seed, then the pretrain file
    model, loss_cfg = build_model(cfg.model, img_size=img_size,
                                  dtype=model_dtype(cfg), device=device)
    init_random_weights(model, seed)
    names = [n for n, _ in model.named_parameters()]
    logger.info(f"model params: "
                f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    if loss_cfg.get("pretrain"):
        if osp.exists(loss_cfg["pretrain"]):
            load_pretrained_into_model(model, loss_cfg["pretrain"], logger)
        else:
            logger.warning(f"pretrain checkpoint {loss_cfg['pretrain']} not "
                           "found; training from random init")
    sharded = layout(model, mesh, cfg)
    # the layout of the state's shards, for the gathers of a save
    on_mesh = None if mesh is None else [p for p in model.parameters()]

    # ---- optimizer / scheduler (reference keys)
    opt_cfg = cfg.get("optimizer_config", {})
    sch_cfg = cfg.get("scheduler_config", {})
    steps_per_epoch = max(len(train_loader), 1)
    max_epoch = sch_cfg.get("max_epoch", 30)
    lr = opt_cfg.get("lr", 5e-4)
    optimizer = create_optimizer(
        lr, steps_per_epoch,
        lr_vis_enc=opt_cfg.get("lr_vis_enc", lr / 10.0),
        lr_lan_enc=opt_cfg.get("lr_lan_enc", lr),
        betas=tuple(opt_cfg.get("betas", (0.9, 0.98))),
        eps=opt_cfg.get("eps", 1e-9),
        grad_norm_clip=cfg.get("grad_norm_clip", 0.15),
        warmup_epochs=sch_cfg.get("warmup_epochs", 3),
        decay_steps=tuple(sch_cfg.get("decay_steps", (25,))),
        decay_ratio=sch_cfg.get("decay_ratio", 0.1),
        freeze_layer=loss_cfg.get("freeze_layer", -1),
        optimizer_type=opt_cfg.get("type", "Adam"),
        scheduler_type=sch_cfg.get("type", "MultiStepLRWarmUp"),
        scheduler_kw=dict(sch_cfg),
        amsgrad=opt_cfg.get("amsgrad", True),
        weight_decay=opt_cfg.get("weight_decay", 0.0),
        mu_dtype=opt_cfg.get("mu_dtype"),
    )
    use_ema = bool(cfg.get("ema", False))
    state = create_train_state(model, optimizer, ema=use_ema)

    # ---- load modes: CLI flags first, config keys as the fallback
    resume_from = args.resume_from or cfg.get("resume_from")
    load_from = args.load_from or cfg.get("load_from")
    finetune_from = args.finetune_from or cfg.get("finetune_from")
    if load_from and not osp.exists(load_from):
        logger.warning(f"load_from={load_from!r} does not exist; ignoring "
                       "(placeholder path in config?)")
        load_from = None
    if finetune_from and not osp.exists(finetune_from):
        logger.warning(f"finetune_from={finetune_from!r} does not exist; "
                       "ignoring (placeholder path in config?)")
        finetune_from = None
    if args.auto_resume and not resume_from:
        resume_from = latest_checkpoint(work_dir)
        if resume_from:
            logger.info(f"auto-resume: found {resume_from}")

    start_epoch, best_acc = restore(
        model, state, resume_from=resume_from, load_from=load_from,
        finetune_from=finetune_from, steps_per_epoch=steps_per_epoch,
        logger=logger)

    device_norm = device_norm_of(cfg)
    batch_sum = None if sharded is None else sharded.batch_sum
    train_step = make_train_step(
        model, optimizer, sharded=sharded,
        branch_loss_weight=loss_cfg["branch_loss_weight"],
        prepare_target_mode=loss_cfg["prepare_target_mode"],
        distill_type=loss_cfg["distill_type"],
        mlp_aux_loss=loss_cfg.get("mlp_aux_loss", False),
        ema_alpha=cfg.get("ema_factor", 0.999) if use_ema else None,
        with_metrics=not is_grec, return_predictions=is_grec,
        device_norm=device_norm)
    eval_step = make_eval_step(model, device_norm=device_norm)
    log_interval = cfg.get("log_interval", 50)
    evaluate_interval = cfg.get("evaluate_interval", 1)
    start_eval = cfg.get("start_evaluate_epoch", 0)
    step_seed = seed + 1
    lr_sched = make_lr_schedule(
        lr, steps_per_epoch,
        scheduler_type=sch_cfg.get("type", "MultiStepLRWarmUp"),
        warmup_epochs=sch_cfg.get("warmup_epochs", 3),
        decay_steps=tuple(sch_cfg.get("decay_steps", (25,))),
        decay_ratio=sch_cfg.get("decay_ratio", 0.1),
        scheduler_kw={k: v for k, v in sch_cfg.items()
                      if k in ("T_max", "eta_min", "T_0", "T_mult")})
    metrics_path = osp.join(work_dir, "metrics.jsonl")

    def emit_metrics(kind, payload):
        if main_rank:
            with open(metrics_path, "a") as f:
                f.write(json.dumps({"kind": kind, **payload}) + "\n")

    def save(name, opt=False, **kw):
        """Gathers the whole state to rank 0 (every rank takes part),
        which writes it."""
        items = dict(
            params=model_state(model),
            opt_state=(opt_state_to_dict(names, state.opt_state, on_mesh)
                       if opt else None),
            ema_params=(full_named(names, state.ema_params, on_mesh)
                        if state.ema_params is not None else None))
        if main_rank:
            save_checkpoint(work_dir, name, step=state.step,
                            ema_step=state.ema_step, **items, **kw)

    results: Dict = {"work_dir": work_dir, "eval": {}, "epochs": []}
    for epoch in range(start_epoch, max_epoch):
        train_loader.set_epoch(epoch)
        t_ep = t_data = time.time()
        for it, batch in enumerate(train_loader):
            data_time = time.time() - t_data
            dev_batch = to_device(batch, device)
            state, scalars = train_step(state, dev_batch, step_seed)
            if (it + 1) % log_interval == 0 or it + 1 == steps_per_epoch:
                preds = scalars.pop("predictions", None)
                s = {k: float(v) for k, v in scalars.items()}
                if preds is not None:
                    s.update(grec_train_metrics(preds, batch,
                                                dev_batch["img_shape"],
                                                batch_sum))
                msg = ", ".join(f"{k}: {v:.4f}" for k, v in s.items()
                                if k.startswith("loss")
                                or k.endswith(("det_acc", "_F1", "_Nacc")))
                cur_lr = lr_sched(epoch * steps_per_epoch + it)
                logger.info(f"train - epoch [{epoch + 1}]"
                            f"[{it + 1}/{steps_per_epoch}] "
                            f"data_time: {data_time:.3f}, lr: {cur_lr:.6f}, "
                            f"{msg}")
                emit_metrics("train", {"epoch": epoch + 1, "iter": it + 1,
                                       "data_time": data_time, **s})
            t_data = time.time()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ep_time = time.time() - t_ep
        bs = cfg.data.get("samples_per_gpu", 32) * dp
        img_s = steps_per_epoch * bs / max(ep_time, 1e-9)
        logger.info(f"epoch {epoch + 1} done in {ep_time:.1f}s "
                    f"({img_s:.1f} img/s)")
        results["epochs"].append({"epoch": epoch + 1, "seconds": ep_time,
                                  "images_per_s": img_s,
                                  "step": state.step})

        if (epoch + 1) % evaluate_interval == 0 and epoch >= start_eval:
            for split, loader in val_loaders.items():
                metrics = evaluate(model, loader, is_grec=is_grec,
                                   eval_step=eval_step, log_fn=logger.info,
                                   log_interval=log_interval,
                                   batch_sum=batch_sum)
                logger.info(f"eval[{split}] epoch {epoch + 1}: "
                            + fmt_metrics(metrics))
                emit_metrics("eval", {"epoch": epoch + 1, "split": split,
                                      **metrics})
                results["eval"][split] = metrics
                if state.ema_params is not None:
                    with swapped_params(model, state.ema_params):
                        m_ema = evaluate(model, loader, is_grec=is_grec,
                                         eval_step=eval_step,
                                         batch_sum=batch_sum)
                    logger.info(f"eval[{split}][EMA] epoch {epoch + 1}: "
                                + fmt_metrics(m_ema))
                    results["eval"][f"{split}[EMA]"] = m_ema
                best_split = "val" if "val" in val_loaders else (
                    splits[0] if splits else None)
                if split == best_split and metrics["det_acc"] > best_acc:
                    best_acc = metrics["det_acc"]
                    save("det_best", epoch=epoch + 1, metrics=metrics)

        # "latest" (crash recovery) carries the optimizer state; the final
        # epoch always saves it (the two-stage load_from contract)
        latest_interval = cfg.get("latest_interval", 1)
        if ((epoch + 1) % max(latest_interval, 1) == 0
                or epoch + 1 == max_epoch):
            save("latest", opt=True, epoch=epoch + 1,
                 metrics={"best_det_acc": best_acc})
        save_interval = cfg.get("save_interval", -1)
        if save_interval and save_interval > 0 and (
                epoch + 1) % save_interval == 0:
            save(f"epoch_{epoch + 1}", epoch=epoch + 1)

    wait_for_checkpoints()
    logger.info(f"training done; best val det_acc {best_acc:.2f}")
    results.update(best_det_acc=best_acc, step=state.step,
                   start_epoch=start_epoch)
    return results


def restore(model: torch.nn.Module, state, *, resume_from=None,
            load_from=None, finetune_from=None, steps_per_epoch: int = 1,
            logger=None):
    """The three load modes, the first given taking precedence:

    - ``resume_from``: weights, optimizer state, EMA, the step and EMA
      counters and the best det_acc so far; training continues after the
      saved epoch;
    - ``load_from``: the weights (and the EMA shadow, when both the run and
      the checkpoint have one); the optimizer and the counters start anew;
    - ``finetune_from``: the weights, non-strictly (``load_non_strict``).

    Updates ``model`` and ``state`` in place (on a mesh, each rank its
    part: every rank reads the checkpoint); returns (start epoch, best
    det_acc)."""
    names, params = zip(*model.named_parameters())
    use_ema = state.ema_params is not None
    if resume_from:
        ck = load_checkpoint(resume_from, with_opt=True, with_ema=use_ema)
        load_model_state(model, ck["params"])
        if "opt_state" in ck:
            load_opt_state(names, ck["opt_state"], state.opt_state, params)
        if "ema_params" in ck:
            load_named(state.ema_params, names, ck["ema_params"], params)
        start_epoch = ck["epoch"]
        state.step = (ck["step"] if ck["step"] is not None
                      else start_epoch * steps_per_epoch)
        if use_ema:
            state.ema_step = (ck["ema_step"] if ck["ema_step"] is not None
                              else state.step)
        if logger:
            logger.info(f"resumed from {resume_from} @ epoch {start_epoch}, "
                        f"step {state.step}")
        # the best-checkpoint tracker too, or a resumed run could replace
        # det_best with a worse evaluation
        return start_epoch, float(ck["metrics"].get("best_det_acc", -1.0))
    if load_from:
        ck = load_checkpoint(load_from, with_ema=use_ema)
        load_model_state(model, ck["params"])
        if "ema_params" in ck:
            load_named(state.ema_params, names, ck["ema_params"], params)
        if logger:
            logger.info(f"loaded weights from {load_from}")
    elif finetune_from:
        load_non_strict(model, load_checkpoint(finetune_from)["params"],
                        logger)
        if logger:
            logger.info(f"finetuned from {finetune_from}")
    return 0, -1.0


def load_non_strict(model: torch.nn.Module, sd: Dict[str, torch.Tensor],
                    logger) -> None:
    """``--finetune-from``: loads the entries whose name and shape match;
    logs the model keys left as they were, the checkpoint keys not used and
    those whose shape differs."""
    own = model.state_dict()
    mismatched = sorted(k for k in sd if k in own
                        and tuple(sd[k].shape) != tuple(own[k].shape))
    usable = {k: v for k, v in sd.items() if k in own and k not in mismatched}
    res = load_model_state(model, usable, strict=False)
    if logger:
        logger.info(f"finetune load: missing keys "
                    f"{sorted(res.missing_keys)}; unexpected keys "
                    f"{sorted(set(sd) - set(own))}; shape mismatches "
                    f"{mismatched}")
    return res


if __name__ == "__main__":
    main()
