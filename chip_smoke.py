#!/usr/bin/env python3
"""GPU smoke run of simvg_tpu_torch, the PyTorch/CUDA port of simvg_tpu.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit:

    python3 chip_smoke.py

It builds every kernel of the port from ``simvg_tpu_torch/csrc/`` (one
nvcc each, in parallel) and holds each against its plain PyTorch version at
the main paths' shapes: K1, the attention forward, and K2, its backward.
bf16 takes each kernel's tensor-core route, float32 its CUDA-core route.
Each K1/K2 row gives the kernel's time beside its plain version's, the
bound, the achieved TFLOP/s and share of the bound, and PyTorch's SDPA as
the yardstick: its forward for K1, its backward alone for K2 (and its
forward plus backward beside K1 + K2).  Then it drives the two main paths of the flagship configuration
(``configs/single/ViT-base/refcoco/refcoco_onestage.py``: BEiT3-base/32
at 640 px, 12 layers, D=768, TGQS-KD-DETR head) at full width on random
weights from a seed:

- serving: 3 batches of 8 requests through ``make_eval_step`` and
  ``evaluate``, counting K1's launches; the served model held against the
  same weights with plain attention (bf16 outputs, float32 encoder
  features); the eval forward timed with each;
- training: batches of 32 through ``make_train_step`` with the config's
  optimizer (Adam amsgrad, 3 LR groups, clip 0.15), one warm-up step and
  TRAIN_STEPS counted steps, K1 and K2 launches counted; loss terms and
  gradients held against plain attention with dropout off; the step timed
  with each.

Every phase raises on failure; there is no CPU path.

Output: the card's name and power limit (nvidia-smi), one line per phase,
a ``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(REPO, "configs", "single", "ViT-base", "refcoco",
                        "refcoco_onestage.py")
BATCH = 8
N_BATCHES = 3
TIMING_REPEATS = 5  # passes over the requests per turn when timing
SEED = 0
TRAIN_BATCH = 32  # the flagship's samples_per_gpu
TRAIN_STEPS = 4  # counted train steps, after one warm-up step
TRAIN_TIMING_STEPS = 5  # train steps per turn when timing
# the schedule's epoch length only sets where the LR ramps; a run of a few
# steps stays in warm-up epoch 0 for any value this large
STEPS_PER_EPOCH = 1000
KERNELS = ("attention_fwd", "attention_bwd")
# the card's peaks (H100 SXM data sheet):
# dense bf16 on the tensor cores, fp32 outside them, and HBM bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12

# K1 vs its plain version.  float32: the bound of
# tests/test_pallas_attention.py.  bf16: the output is stored in bf16, whose
# step is 2^-6 = 0.0156 for |out| in [2, 4); the kernel rounds P before
# normalising and the plain version after, so one output may land one bf16
# step away; a wrong kernel is off by far more.
K1_CHECKS = [  # (batch, seq, heads, head_dim, dtype name, bound)
    (TRAIN_BATCH, 421, 12, 64, "bfloat16", 2e-2),  # the train step's call
    (8, 421, 12, 64, "bfloat16", 2e-2),  # flagship serving, base/32 @ 640
    (8, 421, 12, 64, "float32", 2e-5),
    (2, 1621, 16, 64, "bfloat16", 2e-2),  # patch-16 sequence, large heads
]
# K2 vs its plain version.  float32: the gradient bounds of
# tests/test_pallas_attention.py.  bf16: 2e-2 of each gradient's max |value|,
# five bf16 steps: K2 takes the row term from the rounded output
# (rowsum(dO * out)) and its own P, so a rounding of P or dS may land one bf16
# step away from the plain version's; a wrong kernel is off by far more.
K2_CHECKS = [  # (batch, seq, heads, head_dim, dtype name)
    (TRAIN_BATCH, 421, 12, 64, "bfloat16"),  # the train step's call
    (8, 421, 12, 64, "bfloat16"),
    (8, 421, 12, 64, "float32"),
    (2, 1621, 16, 64, "bfloat16"),  # patch-16 sequence, large heads
]
K2_FP32_ATOL, K2_FP32_RTOL = 3e-4, 1e-3
K2_BF16_REL = 2e-2
MODEL_BOUND = 1e-2  # bf16 logits/boxes, kernel vs plain attention (bench.py)
LOSS_REL_BOUND = 1e-2  # bf16 train loss terms, kernel vs plain attention
GRAD_REL_BOUND = 5e-2  # max|dg| / max|g| over all grads (bench.py:395-405)
# float32 encoder features (|x| up to ~5) after 12 layers, kernel vs plain
# attention: fp32 summation order only; measured ~1e-5 on the card
FEATURE_BOUND_FP32 = 1e-4
OUT_SHAPES = {"class_decoder": (3, BATCH, 1, 2),
              "bbox_decoder": (3, BATCH, 1, 4),
              "class_token": (1, BATCH, 1, 2),
              "bbox_token": (1, BATCH, 1, 4)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them; every
    timing line carries it (a card below its 700 W maximum runs slower)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(bytes_moved, flops, dname):
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the peak rate for the dtype."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rates(row, flops):
    """Adds the achieved TFLOP/s, the share of the bound that the kernel
    reaches (bound_ms / ms) and the route its dtype takes to a K1/K2 row."""
    row.update(tflops=flops / row["ms"] / 1e9,
               bound_share=row["bound_ms"] / row["ms"],
               route=("tensor-core bf16" if row["dtype"] == "bfloat16"
                      else "CUDA-core fp32"))
    return row


def sdpa_args(q, k, v, pad):
    """q/k/v as [B, H, S, hd] views and the keep-mask for PyTorch's
    scaled_dot_product_attention, timed as the library yardstick only."""
    keep = ~pad[:, None, None, :]
    return [t.transpose(1, 2) for t in (q, k, v)], keep


def text_padded_qkv(b, s, h, hd, dtype, gen):
    """q (pre-scaled), k, v [b, s, h, hd] and a key mask that pads the last
    20 (text) positions to lengths 3..20, as the encoder sees them."""
    import torch

    q, k, v = (torch.randn(b, s, h, hd, device="cuda", generator=gen)
               .to(dtype) for _ in range(3))
    q = (q * hd ** -0.5).to(dtype)
    pad = torch.zeros(b, s, dtype=torch.bool, device="cuda")
    for i in range(b):
        pad[i, s - 20 + 3 + (i * 5) % 18:] = True
    return q, k, v, pad


def check_k1(gen, card):
    """K1 vs fused_attention_reference at each shape; returns the rows."""
    import torch
    import torch.nn.functional as F
    from simvg_tpu_torch.ops.fused_attention import (
        fused_attention, fused_attention_reference)

    rows = []
    for b, s, h, hd, dname, bound in K1_CHECKS:
        dtype = getattr(torch, dname)
        q, k, v, pad = text_padded_qkv(b, s, h, hd, dtype, gen)
        out = fused_attention(q, k, v, pad)
        torch.cuda.synchronize()
        ref = fused_attention_reference(q, k, v, pad)
        err = (out.float() - ref.float()).abs().max().item()
        if not (out.shape == q.shape and torch.isfinite(out).all()
                and err <= bound):
            raise AssertionError(
                f"K1 disagrees with its plain version at {(b, s, h, hd)} "
                f"{dname}: max_abs_err {err} > {bound}")
        kern = lambda: fused_attention(q, k, v, pad)  # noqa: E731
        plain = lambda: fused_attention_reference(q, k, v, pad)  # noqa: E731
        (qt, kt, vt), keep = sdpa_args(q, k, v, pad)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=keep, scale=1.0)
        for fn in (kern, plain, library):
            fn()  # warm-up
        # in turns: plain, kernel, kernel, plain
        p1, k1, k2, p2 = (cuda_ms(fn, 20) for fn in (plain, kern, kern, plain))
        lib_ms = cuda_ms(library, 20)
        nbytes = 4 * q.numel() * q.element_size() + pad.numel()
        flops = 4 * b * h * s * s * hd
        bms, by = bound_ms(nbytes, flops, dname)
        row = rates(dict(shape=[b, s, h, hd], dtype=dname, max_abs_err=err,
                         bound=bound, ms=(k1 + k2) / 2,
                         plain_ms=(p1 + p2) / 2, library_ms=lib_ms,
                         bound_ms=bms, bound_by=by), flops)
        log(f"K1 {row} (library_ms: SDPA forward) [{card}]")
        rows.append(row)
    return rows


def check_k2(gen, card):
    """K2 vs fused_attention_bwd_reference at each shape, on K1's out and
    lse; returns the rows."""
    import torch
    import torch.nn.functional as F
    from simvg_tpu_torch.ops.fused_attention import (
        attention_bwd, attention_fwd, fused_attention_bwd_reference)

    rows = []
    for b, s, h, hd, dname in K2_CHECKS:
        dtype = getattr(torch, dname)
        q, k, v, pad = text_padded_qkv(b, s, h, hd, dtype, gen)
        dout = torch.randn(b, s, h, hd, device="cuda", generator=gen).to(dtype)
        out, lse = attention_fwd(q, k, v, pad, with_lse=True)
        grads = attention_bwd(q, k, v, out, dout, lse, pad)
        torch.cuda.synchronize()
        refs = fused_attention_bwd_reference(q, k, v, dout, pad)
        errs, rels = {}, {}
        for name, g, ref in zip(("dq", "dk", "dv"), grads, refs):
            if not (g.shape == ref.shape and torch.isfinite(g).all()):
                raise AssertionError(f"K2 {name} at {(b, s, h, hd)} {dname}: "
                                     "wrong shape or non-finite values")
            diff = (g.float() - ref.float()).abs()
            scale = ref.float().abs().max().item()
            errs[name] = diff.max().item()
            rels[name] = errs[name] / max(scale, 1e-30)
            if dname == "float32":
                ok = bool((diff <= K2_FP32_ATOL
                           + K2_FP32_RTOL * ref.abs()).all())
            else:
                ok = errs[name] <= K2_BF16_REL * scale
            if not ok:
                raise AssertionError(
                    f"K2 {name} disagrees with its plain version at "
                    f"{(b, s, h, hd)} {dname}: max_abs_err {errs[name]} "
                    f"(max |{name}| {scale})")
        kern = lambda: attention_bwd(q, k, v, out, dout, lse, pad)  # noqa: E731
        plain = lambda: fused_attention_bwd_reference(  # noqa: E731
            q, k, v, dout, pad)
        fwd = lambda: attention_fwd(q, k, v, pad, with_lse=True)  # noqa: E731
        (qt, kt, vt), keep = sdpa_args(q, k, v, pad)
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        dout_t = dout.transpose(1, 2)
        graph_out = F.scaled_dot_product_attention(*leaves, attn_mask=keep,
                                                   scale=1.0)

        def library():  # SDPA backward alone, on one forward graph
            torch.autograd.grad(graph_out, leaves, dout_t, retain_graph=True)

        def library_fwd_bwd():  # SDPA forward + backward
            o = F.scaled_dot_product_attention(*leaves, attn_mask=keep,
                                               scale=1.0)
            torch.autograd.grad(o, leaves, dout_t)

        for fn in (kern, plain, library, library_fwd_bwd, fwd):
            fn()  # warm-up
        p1, k1, k2, p2 = (cuda_ms(fn, 10) for fn in (plain, kern, kern, plain))
        lib_ms = cuda_ms(library, 10)
        lib_fb_ms = cuda_ms(library_fwd_bwd, 10)
        fwd_ms = cuda_ms(fwd, 10)
        # read q, k, v, out, dO, lse and the mask; write dq, dk, dv
        nbytes = 8 * q.numel() * q.element_size() + lse.numel() * 4 \
            + pad.numel()
        flops = 10 * b * h * s * s * hd
        bms, by = bound_ms(nbytes, flops, dname)
        row = rates(dict(shape=[b, s, h, hd], dtype=dname, max_abs_err=errs,
                         err_over_max_grad=rels, ms=(k1 + k2) / 2,
                         plain_ms=(p1 + p2) / 2, library_ms=lib_ms,
                         bound_ms=bms, bound_by=by,
                         library_fwd_bwd_ms=lib_fb_ms,
                         k1_plus_k2_ms=fwd_ms + (k1 + k2) / 2), flops)
        log(f"K2 {row} (library_ms: SDPA backward alone; library_fwd_bwd_ms: "
            f"SDPA forward + backward, beside k1_plus_k2_ms) [{card}]")
        rows.append(row)
    return rows


def make_requests(rng, n_batches, batch, vocab, max_token, img_size):
    """uint8 BGR canvases with valid extents of img_size/2..img_size, text
    of 3..max_token tokens padded to max_token, and one gt box inside the
    valid extent of each sample."""
    import numpy as np

    batches = []
    for _ in range(n_batches):
        shapes = np.stack([rng.integers(img_size // 2, img_size + 1, batch),
                           rng.integers(img_size // 2, img_size + 1, batch)],
                          axis=1).astype(np.int32)
        lengths = rng.integers(3, max_token + 1, batch)
        ids = rng.integers(1, vocab, (batch, max_token)).astype(np.int64)
        pad = (np.arange(max_token)[None] >= lengths[:, None]).astype(
            np.int64)
        ids[pad == 1] = 0
        image = rng.integers(0, 256, (batch, img_size, img_size, 3)).astype(
            np.uint8)
        x1 = rng.uniform(0, 0.5, batch) * shapes[:, 1]
        y1 = rng.uniform(0, 0.5, batch) * shapes[:, 0]
        gt = np.stack([x1, y1, x1 + 0.4 * shapes[:, 1],
                       y1 + 0.4 * shapes[:, 0]], 1).astype(np.float32)
        batches.append(dict(image=image, text_ids=ids, text_padding_mask=pad,
                            img_shape=shapes, gt_boxes=gt[:, None, :],
                            gt_labels=np.zeros((batch, 1), np.int64),
                            gt_valid=np.ones((batch, 1), bool),
                            batch_valid=np.ones(batch, bool)))
    return batches


def build_flagship(cfg, attn_impl, dtype, state_dict=None):
    """The flagship at full width on the card: random weights from SEED,
    or ``state_dict``."""
    import torch
    from simvg_tpu_torch.models import build_model, init_random_weights

    model_cfg = copy.deepcopy(dict(cfg.model))
    model_cfg["vis_enc"] = dict(model_cfg["vis_enc"], attn_impl=attn_impl)
    model, loss_cfg = build_model(model_cfg, img_size=cfg.img_size,
                                  dtype=dtype, device="meta")
    model = model.to_empty(device="cuda")
    if state_dict is None:
        init_random_weights(
            model, torch.Generator(device="cuda").manual_seed(SEED))
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.eval(), loss_cfg


def to_device(batch, keys=None):
    import torch
    from simvg_tpu_torch.engine.evaluate import DEVICE_KEYS

    return {k: torch.as_tensor(batch[k]).cuda() for k in keys or DEVICE_KEYS}


def serve(model, loader, norm):
    """The main path: every batch through make_eval_step and evaluate.
    Returns (K1 launches, per-batch ms, metrics)."""
    import torch
    from simvg_tpu_torch.engine import evaluate, make_eval_step
    from simvg_tpu_torch.ops.fused_attention import fused_attention

    step = make_eval_step(model, device_norm=norm)
    times = []

    def timed_step(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not all(torch.isfinite(t.float()).all()
                   for p in preds.values() for t in p.values()):
            raise AssertionError("non-finite predictions")
        return preds

    evaluate(model, loader[:1], eval_step=timed_step)  # warm-up
    times.clear()
    fused_attention.launches = 0
    metrics = evaluate(model, loader, eval_step=timed_step)
    return fused_attention.launches, times, metrics


def compare_with_plain(cfg, model, batch, norm):
    """The same weights and batch with attn_impl="xla": bf16 class/box
    outputs within MODEL_BOUND, and float32 encoder features within
    FEATURE_BOUND_FP32.  Returns the bf16 plain-attention model."""
    import torch
    from simvg_tpu_torch.engine import normalize_images_on_device

    dev = to_device(batch)
    image = normalize_images_on_device(dev["image"], norm["mean"],
                                       norm["std"], True, dev["img_shape"])
    args = (image, dev["text_ids"], dev["text_padding_mask"])
    state = model.state_dict()
    plain, _ = build_flagship(cfg, "xla", torch.bfloat16, state)
    with torch.inference_mode():
        out_k = model(*args, img_shape=dev["img_shape"])
        out_p = plain(*args, img_shape=dev["img_shape"])
    diffs = {}
    for k, shape in OUT_SHAPES.items():
        if tuple(out_k[k].shape) != shape or not torch.isfinite(out_k[k]).all():
            raise AssertionError(f"{k}: shape {tuple(out_k[k].shape)} or "
                                 "non-finite values")
        diffs[k] = (out_k[k] - out_p[k]).abs().max().item()
    log(f"bf16, K1 vs plain attention, same weights and batch: max abs diff "
        f"{diffs} (bound {MODEL_BOUND})")
    if max(diffs.values()) > MODEL_BOUND:
        raise AssertionError("flagship outputs with K1 differ from plain "
                             "attention beyond the bound")

    feats = []
    for impl in ("pallas", "xla"):
        m, _ = build_flagship(cfg, impl, torch.float32, state)
        with torch.inference_mode():
            feats.append(m.vis_enc["beit3"](*args))
        del m
    err = max((a - b).abs().max().item() for a, b in zip(*feats))
    log(f"float32, K1 vs plain attention: encoder features max abs diff "
        f"{err} (bound {FEATURE_BOUND_FP32})")
    if not err <= FEATURE_BOUND_FP32:
        raise AssertionError("float32 encoder features with K1 differ from "
                             "plain attention beyond the bound")
    return plain


def time_eval(steps, loader):
    """Per-batch ms of each eval step (host clock around a synchronised
    call), run in turns a, b, b, a, TIMING_REPEATS passes over the loader
    each.  Returns {name: sorted list of ms}."""
    import torch

    names = list(steps)
    lat = {n: [] for n in names}
    dev = [to_device(batch) for batch in loader]
    for name in names + names[::-1]:
        for _ in range(TIMING_REPEATS):
            for batch in dev:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps[name](batch)
                torch.cuda.synchronize()
                lat[name].append((time.perf_counter() - t0) * 1e3)
    return {n: sorted(ts) for n, ts in lat.items()}


def serve_flagship(card):
    import numpy as np
    import torch
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.engine import make_eval_step

    cfg = Config.fromfile(FLAGSHIP)
    model, loss_cfg = build_flagship(cfg, "pallas", torch.bfloat16)
    enc = model.cfg.beit3
    log(f"flagship: {enc.num_layers} layers, D={enc.embed_dim}, "
        f"{enc.num_heads} heads, S={enc.seq_vision + cfg.max_token}, "
        f"attn_impl={enc.attn_impl}, "
        f"{sum(p.numel() for p in model.parameters())} params (random, "
        f"seed {SEED}; pretrain {loss_cfg['pretrain']!r} not loaded), bf16")
    norm = dict(mean=cfg.img_norm_cfg["mean"], std=cfg.img_norm_cfg["std"],
                to_rgb=True)
    loader = make_requests(np.random.default_rng(SEED), N_BATCHES, BATCH,
                           enc.vocab_size, cfg.max_token, cfg.img_size)

    launches, times, metrics = serve(model, loader, norm)
    want = enc.num_layers * N_BATCHES
    if launches != want:
        raise AssertionError(f"K1 launched {launches} times on the main "
                             f"path, expected {want}")
    if metrics["n_samples"] != N_BATCHES * BATCH:
        raise AssertionError(f"evaluate counted {metrics['n_samples']}")
    log(f"served {N_BATCHES}x{BATCH} requests: K1 launches {launches}; "
        f"per-batch ms through evaluate {times} [{card}]; decoder Prec@0.5 "
        f"{metrics['decoder_det_acc']:.2f}, token Prec@0.5 "
        f"{metrics['token_det_acc']:.2f} (random weights: shows the "
        f"pipeline only)")

    plain = compare_with_plain(cfg, model, loader[0], norm)
    lat = time_eval({"xla": make_eval_step(plain, device_norm=norm),
                     "pallas": make_eval_step(model, device_norm=norm)},
                    loader)
    for impl, ts in lat.items():
        ms = ts[len(ts) // 2]
        log(f"eval forward, batch {BATCH}, bf16, attn_impl={impl}: median "
            f"{ms:.3f} ms/batch ({BATCH / ms * 1e3:.1f} images/s), min "
            f"{ts[0]:.3f}, max {ts[-1]:.3f}, {len(ts)} batches [{card}]")
    return launches


TRAIN_KEYS = ("image", "text_ids", "text_padding_mask", "img_shape",
              "gt_boxes", "gt_labels", "gt_valid")


def make_train_step_for(cfg, model, loss_cfg, norm):
    """The config's optimizer and a train step over ``model``; returns
    (train_step, state)."""
    from simvg_tpu_torch.engine import (create_optimizer, create_train_state,
                                        make_train_step)

    opt, sch, lr = cfg.optimizer_config, cfg.scheduler_config, cfg.lr
    optimizer = create_optimizer(
        lr, STEPS_PER_EPOCH, lr_vis_enc=opt.get("lr_vis_enc", lr / 10.0),
        lr_lan_enc=opt.get("lr_lan_enc", lr),
        betas=tuple(opt.get("betas", (0.9, 0.98))), eps=opt.get("eps", 1e-9),
        grad_norm_clip=cfg.get("grad_norm_clip", 0.15),
        warmup_epochs=sch.get("warmup_epochs", 3),
        decay_steps=tuple(sch.get("decay_steps", (25,))),
        decay_ratio=sch.get("decay_ratio", 0.1),
        freeze_layer=loss_cfg["freeze_layer"],
        optimizer_type=opt.get("type", "Adam"),
        scheduler_type=sch.get("type", "MultiStepLRWarmUp"),
        scheduler_kw=dict(sch), amsgrad=opt.get("amsgrad", True))
    ema = bool(cfg.get("ema", False))
    step = make_train_step(
        model, optimizer, branch_loss_weight=loss_cfg["branch_loss_weight"],
        prepare_target_mode=loss_cfg["prepare_target_mode"],
        distill_type=loss_cfg["distill_type"],
        mlp_aux_loss=loss_cfg["mlp_aux_loss"],
        ema_alpha=cfg.get("ema_alpha", 0.999) if ema else None,
        device_norm=norm)
    return step, create_train_state(model, optimizer, ema=ema)


def dropout_off(model):
    """Sets every dropout and drop-path rate of ``model`` to 0, so its
    train-mode forward draws nothing at random."""
    from simvg_tpu_torch.models.beit3 import DropPath
    from simvg_tpu_torch.models.heads.detr_transformer import DetrAttention
    from simvg_tpu_torch.models.layers import Dropout

    for m in model.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.rate = 0.0
        elif isinstance(m, DetrAttention):
            m.attn_dropout = 0.0


def losses_and_grads(model, batch, loss_cfg, norm):
    """One train-mode forward and backward, as the train step takes it:
    returns ({loss term: float}, {param name: fp32 grad})."""
    import torch
    from simvg_tpu_torch.engine import normalize_images_on_device
    from simvg_tpu_torch.engine.train import train_losses

    image = normalize_images_on_device(batch["image"], norm["mean"],
                                       norm["std"], True, batch["img_shape"])
    losses, _ = train_losses(
        model, batch, image, branch_loss_weight=loss_cfg["branch_loss_weight"],
        prepare_target_mode=loss_cfg["prepare_target_mode"],
        distill_type=loss_cfg["distill_type"],
        mlp_aux_loss=loss_cfg["mlp_aux_loss"])
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(losses["loss_total"], params,
                                allow_unused=True)
    return ({k: v.item() for k, v in losses.items()},
            {n: (torch.zeros_like(p) if g is None else g).float()
             for n, p, g in zip(names, params, grads)})


def train_flagship(card):
    """The train path at full width: TRAIN_STEPS steps of TRAIN_BATCH after
    a warm-up, K1/K2 launches counted; then kernel vs plain attention on
    loss terms and gradients, and the step timed with each."""
    import numpy as np
    import torch
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.ops.fused_attention import (attention_bwd,
                                                     fused_attention)
    from simvg_tpu_torch.ops.hungarian import hungarian_assign

    cfg = Config.fromfile(FLAGSHIP)
    model, loss_cfg = build_flagship(cfg, "pallas", torch.bfloat16)
    enc = model.cfg.beit3
    norm = dict(mean=cfg.img_norm_cfg["mean"], std=cfg.img_norm_cfg["std"],
                to_rgb=True)
    batches = [to_device(b, TRAIN_KEYS) for b in make_requests(
        np.random.default_rng(SEED + 1), TRAIN_STEPS + 1, TRAIN_BATCH,
        enc.vocab_size, cfg.max_token, cfg.img_size)]
    step, state = make_train_step_for(cfg, model, loss_cfg, norm)
    log(f"train: flagship at full width, batch {TRAIN_BATCH}, bf16 compute, "
        f"fp32 params, drop-path {enc.drop_path_rate}, head dropout "
        f"{model.head.cfg.attn_dropout}; lr {cfg.lr}, "
        f"{cfg.optimizer_config['type']} amsgrad="
        f"{cfg.optimizer_config['amsgrad']}, clip {cfg.grad_norm_clip}")

    state, _ = step(state, batches[0], SEED)  # warm-up
    torch.cuda.synchronize()
    fused_attention.launches = attention_bwd.launches = 0
    hungarian_assign.round_trips = 0
    history = []
    for batch in batches[1:]:
        state, scalars = step(state, batch, SEED)
        history.append(scalars)
    torch.cuda.synchronize()
    k1, k2 = fused_attention.launches, attention_bwd.launches
    trips = hungarian_assign.round_trips / TRAIN_STEPS
    want = enc.num_layers * TRAIN_STEPS
    if (k1, k2) != (want, want):
        raise AssertionError(f"train path launched K1 {k1} and K2 {k2} "
                             f"times, expected {want} each")
    values = {k: torch.stack([h[k] for h in history]).float().cpu()
              for k in history[0]}
    bad = sorted(k for k, v in values.items() if not torch.isfinite(v).all())
    if bad or "grad_norm" not in values:
        raise AssertionError(f"non-finite train scalars: {bad}")
    log(f"trained {TRAIN_STEPS} steps of {TRAIN_BATCH}: K1 launches {k1}, "
        f"K2 launches {k2}, Hungarian host round trips per step {trips}; "
        f"loss_total {values['loss_total'].tolist()}, grad_norm "
        f"{values['grad_norm'].tolist()}")

    plain, _ = build_flagship(cfg, "xla", torch.bfloat16, model.state_dict())
    plain_step, plain_state = make_train_step_for(cfg, plain, loss_cfg, norm)
    timing = time_train({"xla": (plain_step, plain_state),
                         "pallas": (step, state)}, batches)
    step_ms = {}
    for impl, (ts, peak) in timing.items():
        ms = step_ms[impl] = ts[len(ts) // 2]
        log(f"train step, batch {TRAIN_BATCH}, bf16, attn_impl={impl}: "
            f"median {ms:.3f} ms/step ({TRAIN_BATCH / ms * 1e3:.1f} images/s), "
            f"min {ts[0]:.3f}, max {ts[-1]:.3f}, {len(ts)} steps; "
            f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; host round "
            f"trips per step {trips} [{card}]")

    plain.load_state_dict(model.state_dict())
    for m in (model, plain):
        dropout_off(m)
    losses_k, grads_k = losses_and_grads(model, batches[1], loss_cfg, norm)
    losses_p, grads_p = losses_and_grads(plain, batches[1], loss_cfg, norm)
    loss_rel = {k: abs(losses_k[k] - losses_p[k]) / max(abs(losses_p[k]),
                                                        1e-12)
                for k in losses_p}
    gdiff = max((grads_k[n] - grads_p[n]).abs().max().item() for n in grads_p)
    gscale = max(g.abs().max().item() for g in grads_p.values())
    log(f"bf16 train, K1/K2 vs plain attention, same weights and batch, "
        f"dropout off: loss terms {losses_k} vs {losses_p}, relative diff "
        f"{loss_rel} (bound {LOSS_REL_BOUND}); grads max|dg| {gdiff}, max|g| "
        f"{gscale}, ratio {gdiff / gscale} (bound {GRAD_REL_BOUND})")
    if max(loss_rel.values()) > LOSS_REL_BOUND or \
            not gdiff <= GRAD_REL_BOUND * gscale:
        raise AssertionError("the train step with K1/K2 differs from plain "
                             "attention beyond the bounds")
    return k1, k2, step_ms["pallas"]


def time_train(steps, batches):
    """Per-step ms (host clock around a synchronised step) in turns a, b, b,
    a, TRAIN_TIMING_STEPS steps each, and the peak allocated memory of each
    name's turns.  Returns {name: (sorted ms, peak bytes)}."""
    import torch

    names = list(steps)
    lat = {n: [] for n in names}
    peak = {n: 0 for n in names}
    for name in names + names[::-1]:
        step, state = steps[name]
        torch.cuda.reset_peak_memory_stats()
        for i in range(TRAIN_TIMING_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, batches[i % len(batches)], SEED)
            torch.cuda.synchronize()
            lat[name].append((time.perf_counter() - t0) * 1e3)
        steps[name] = (step, state)
        peak[name] = max(peak[name], torch.cuda.max_memory_allocated())
    return {n: (sorted(lat[n]), peak[n]) for n in names}


JPEG_HW = (480, 640)  # COCO-sized images
JPEG_QUALITY = 95
# mean |difference| of an encode -> decode round trip at quality 95 on
# smooth images (tests/test_torch_data.py holds cv2's to the same bound)
JPEG_MEAN_BOUND = 2.0
N_SYNTH_TRAIN, N_SYNTH_VAL = 64, 16
STD = (58.395, 57.12, 57.375)  # the flagship's img_norm_cfg std


def check_jpeg(card):
    """The nvJPEG codec on the card: encode -> decode round trips at
    480x640 (shape exact, mean |difference| <= JPEG_MEAN_BOUND levels), a
    grayscale file (three equal channels), every EXIF orientation; the
    decode's and the header parse's time per image."""
    import torch
    from simvg_tpu_torch.data.jpeg import decode, encode, jpeg_geometry, orient
    from simvg_tpu_torch.tools.make_synth_data import smooth_image, with_exif

    files, errs = [], []
    for i in range(8):
        img = torch.from_numpy(smooth_image(*JPEG_HW, i)).cuda()
        data = encode(img, JPEG_QUALITY)
        got = decode(data, "cuda")
        err = (got.int() - img.int()).abs().float().mean().item()
        if tuple(got.shape) != tuple(img.shape) or not err <= JPEG_MEAN_BOUND:
            raise AssertionError(f"nvJPEG round trip {i}: shape "
                                 f"{tuple(got.shape)}, mean |diff| {err}")
        files.append(data)
        errs.append(err)
    gray = torch.from_numpy(smooth_image(*JPEG_HW, 9)[..., 1].copy()).cuda()
    got = decode(encode(gray, JPEG_QUALITY), "cuda")
    gerr = (got[..., 0].int() - gray.int()).abs().float().mean().item()
    if not (tuple(got.shape) == JPEG_HW + (3,)
            and torch.equal(got[..., 0], got[..., 1])
            and torch.equal(got[..., 0], got[..., 2])
            and gerr <= JPEG_MEAN_BOUND):
        raise AssertionError(f"nvJPEG grayscale: shape {tuple(got.shape)}, "
                             f"mean |diff| {gerr}")
    plain = decode(files[0], "cuda")
    for o in range(1, 9):
        got = decode(with_exif(files[0], o), "cuda")
        if not torch.equal(got, orient(plain, o)):
            raise AssertionError(f"EXIF orientation {o} not applied")
    decode_ms = cuda_ms(lambda: [decode(d, "cuda") for d in files], 8) \
        / len(files)
    t0 = time.perf_counter()
    for _ in range(100):
        for d in files:
            jpeg_geometry(d)
    header_ms = (time.perf_counter() - t0) * 1e3 / (100 * len(files))
    log(f"jpeg: nvJPEG round trips at {JPEG_HW} q{JPEG_QUALITY}: mean |diff| "
        f"{errs} (bound {JPEG_MEAN_BOUND}), grayscale {gerr}, EXIF "
        f"orientations 1-8 applied; decode {decode_ms:.3f} ms/image, header "
        f"parse {header_ms:.4f} ms/image [{card}]")


def synth_options(imgdir, ann):
    """--cfg-options pointing every split of the flagship at the synthetic
    data; testA and testB read its val split."""
    opts = []
    for split in ("train", "val", "testA", "testB"):
        opts += [f"data.{split}.annsfile={ann}",
                 f"data.{split}.imgsfile={imgdir}"]
    return opts + ["data.testA.which_set=val", "data.testB.which_set=val"]


def data_phase(card, root, step_ms):
    """N_SYNTH_TRAIN + N_SYNTH_VAL synthetic 480x640 JPEGs written with
    nvJPEG; the flagship's loaders on the card, their batches held against
    the CPU route on the same decoded pixels (1 level per resampling, over
    std after Normalize); host geometry, decode, device transform and
    loader times.  Returns --cfg-options for the synthetic data."""
    import torch
    from simvg_tpu_torch.config import Config, parse_cfg_options
    from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                              build_loader_from_cfg)
    from simvg_tpu_torch.data.image_ops import collate_images
    from simvg_tpu_torch.data.jpeg import decode
    from simvg_tpu_torch.tools.make_synth_data import make_refcoco_style

    t0 = time.perf_counter()
    imgdir, ann = make_refcoco_style(os.path.join(root, "synth"),
                                     N_SYNTH_TRAIN, N_SYNTH_VAL,
                                     img_hw=JPEG_HW, device="cuda")
    log(f"data: wrote {N_SYNTH_TRAIN}+{N_SYNTH_VAL} synthetic {JPEG_HW} "
        f"JPEGs with nvJPEG in {time.perf_counter() - t0:.2f} s")
    opts = synth_options(imgdir, ann)
    cfg = Config.fromfile(FLAGSHIP)
    cfg.merge_from_dict(parse_cfg_options(opts))
    canvas = cfg.img_size
    for split, train in (("train", True), ("val", False)):
        ds = build_dataset_from_cfg(cfg.data[split], dataset_type=cfg.dataset,
                                    seed=cfg.seed)
        loader = build_loader_from_cfg(ds, cfg, train=train, canvas=canvas,
                                       seed=cfg.seed, device="cuda")
        idx, _ = loader._index_batches()[0]
        idx = (idx * loader.bs)[:loader.bs]  # the loader's wrap-padding
        batch = next(iter(loader))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples = [ds[i] for i in idx]
        geo_ms = (time.perf_counter() - t0) * 1e3 / len(idx)
        decoded = [decode(s["img_bytes"], "cuda") for s in samples]
        cpu = collate_images(samples, canvas, "cpu",
                             [d.cpu() for d in decoded])
        levels = torch.tensor([[sum(op == "resize" for op, _ in s["pixel_ops"])]
                               for s in samples], dtype=torch.float32)
        bound = levels[:, :, None, None] / torch.tensor(STD) + 1e-6
        diff = (batch["image"].cpu() - cpu).abs()
        if batch["image"].shape != cpu.shape or not (diff <= bound).all():
            raise AssertionError(f"{split} loader batch differs from the CPU "
                                 f"route: max {diff.max().item()}")
        decode_ms = cuda_ms(lambda: [decode(s["img_bytes"], "cuda")
                                     for s in samples], 3)
        transform_ms = cuda_ms(lambda: collate_images(samples, canvas, "cuda",
                                                      decoded), 5)
        waits = []
        for epoch in range(2):
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            for b in loader:
                b["image"].sum().item()  # the batch is on the card
                waits.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
        log(f"data[{split}]: batch of {len(idx)} vs the CPU route on the same "
            f"decoded pixels: max |diff| x std {diff.max().item() * max(STD):.3f}"
            f" levels (resamplings {sorted(set(levels.flatten().tolist()))}); "
            f"host geometry {geo_ms:.3f} ms/sample; decode {decode_ms:.2f} "
            f"ms/batch; device transforms {transform_ms:.2f} ms/batch; loader "
            f"{waits} ms/batch with nothing consuming, against the train "
            f"step's median {step_ms:.1f} ms [{card}]")
    return opts


def _dir_gib(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path)) / 2 ** 30


def cli_phase(card, root, opts):
    """The CLIs on the flagship at full width from the synthetic JPEGs:
    train 1 epoch (2 steps of 32, eval of val/testA/testB, det_best and
    latest), test on det_best (the same det_acc), resume from latest to
    epoch 2; K1/K2 launches counted from 0 around each.  Returns the K1 and
    K2 launches of the three runs."""
    import torch
    from simvg_tpu_torch.ops.fused_attention import (attention_bwd,
                                                     fused_attention)
    from simvg_tpu_torch.tools import test as test_cli
    from simvg_tpu_torch.tools import train as train_cli
    from simvg_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  save_checkpoint)

    wd = os.path.join(root, "work")
    steps = N_SYNTH_TRAIN // TRAIN_BATCH
    evals = 3  # val, testA, testB: one batch each
    launches = []

    def run(name, fn, want_k1, want_k2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_attention.launches = attention_bwd.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k1, k2 = fused_attention.launches, attention_bwd.launches
        if (k1, k2) != (want_k1, want_k2):
            raise AssertionError(f"{name}: K1 {k1} and K2 {k2} launches, "
                                 f"expected {want_k1} and {want_k2}")
        launches.append((k1, k2))
        log(f"cli[{name}]: {secs:.1f} s, K1 launches {k1}, K2 launches {k2}, "
            f"max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
        return out

    k1_step = 12  # encoder layers
    res = run("train", lambda: train_cli.main(
        [FLAGSHIP, "--work-dir", wd, "--cfg-options", *opts,
         "scheduler_config.max_epoch=1"]),
        k1_step * (steps + evals), k1_step * steps)
    if not (res["step"] == steps and os.path.isdir(os.path.join(wd, "det_best"))
            and os.path.isdir(os.path.join(wd, "latest"))):
        raise AssertionError(f"train CLI: step {res['step']}, files "
                             f"{sorted(os.listdir(wd))}")
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss_total"] for line in f
                  if '"train"' in line]
    if not all(v == v and abs(v) < float("inf") for v in losses):
        raise AssertionError(f"train CLI losses {losses}")
    ep = res["epochs"][0]
    log(f"cli[train]: {steps} steps of {TRAIN_BATCH}, loss_total {losses}, "
        f"epoch {ep['seconds']:.2f} s ({ep['images_per_s']:.1f} images/s), "
        f"eval {res['eval']['val']}; det_best {_dir_gib(wd + '/det_best'):.3f}"
        f" GiB, latest {_dir_gib(wd + '/latest'):.3f} GiB [{card}]")

    got = run("test", lambda: test_cli.main(
        [FLAGSHIP, os.path.join(wd, "det_best"), "--cfg-options", *opts]),
        k1_step * evals, 0)
    if got["val"]["det_acc"] != res["eval"]["val"]["det_acc"]:
        raise AssertionError(f"test CLI det_acc {got['val']} differs from the "
                             f"train CLI's {res['eval']['val']}")
    log(f"cli[test]: det_best val {got['val']} (train CLI's eval: the same "
        f"det_acc {res['eval']['val']['det_acc']})")

    res2 = run("resume", lambda: train_cli.main(
        [FLAGSHIP, "--work-dir", wd, "--resume-from",
         os.path.join(wd, "latest"), "--cfg-options", *opts,
         "scheduler_config.max_epoch=2", "save_interval=2"]),
        k1_step * (steps + evals), k1_step * steps)
    with open(os.path.join(wd, "latest", "meta.json")) as f:
        meta = json.load(f)
    if not (res2["start_epoch"] == 1 and res2["step"] == 2 * steps
            and meta["epoch"] == 2 and meta["step"] == 2 * steps
            and os.path.isdir(os.path.join(wd, "epoch_2"))):
        raise AssertionError(f"resume: {res2}, latest {meta}")
    log(f"cli[resume]: from epoch 1 / step {steps} to epoch 2 / step "
        f"{res2['step']}; epoch_2 written; eval {res2['eval']['val']}")

    t0 = time.perf_counter()
    ck = load_checkpoint(os.path.join(wd, "latest"), with_opt=True)
    load_s = time.perf_counter() - t0
    params = {k: v.cuda() for k, v in ck["params"].items()}
    opt = {k: ({n: t.cuda() for n, t in v.items()} if isinstance(v, dict)
               else v) for k, v in ck["opt_state"].items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(root, "resave", params=params, opt_state=opt, epoch=2,
                    block=True)
    save_s = time.perf_counter() - t0
    log(f"checkpoint latest ({_dir_gib(os.path.join(root, 'resave')):.3f} "
        f"GiB, params + amsgrad's three moments): load {load_s:.2f} s to the "
        f"host, save {save_s:.2f} s from the card (copy to the host + write)"
        f" [{card}]")
    return (sum(k1 for k1, _ in launches), sum(k2 for _, k2 in launches))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from simvg_tpu_torch.ops import _build

    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build_all(KERNELS + ("jpeg",))
    log(f"built {[os.path.relpath(p, REPO) for p in libs.values()]} in "
        f"{time.perf_counter() - t0:.1f} s (in parallel)")
    for name, lib in libs.items():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: " + line.strip())

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1_rows = check_k1(gen, card)
    k2_rows = check_k2(gen, card)
    serve_k1 = serve_flagship(card)
    train_k1, train_k2, step_ms = train_flagship(card)
    check_jpeg(card)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        synth = data_phase(card, root, step_ms)
        cli_k1, cli_k2 = cli_phase(card, root, synth)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # every number on this line is measured in this run, at the train
    # step's shape (batch 32, S=421, bf16; the first row of each check);
    # the other shapes are on the "K1" / "K2" lines above.  launches: the
    # serve and train paths' counts, each taken from 0 just before its path
    def entry(name, replaces, rows, launches):
        main_row = rows[0]
        errs = [r["max_abs_err"] for r in rows]
        errs = [max(e.values()) if isinstance(e, dict) else e for e in errs]
        return {"name": name, "route": "cuda",
                "source": f"simvg_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(errs), "ms": main_row["ms"],
                "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"],
                "bound_by": main_row["bound_by"],
                "library_ms": main_row["library_ms"]}

    print(json.dumps({"kernels": [
        entry("attention_fwd", "simvg_tpu/ops/pallas_attention.py:55",
              k1_rows, serve_k1 + train_k1 + cli_k1),
        entry("attention_bwd", "simvg_tpu/ops/pallas_attention.py:66",
              k2_rows, train_k2 + cli_k2),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
