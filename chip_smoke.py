#!/usr/bin/env python3
"""GPU smoke run of simvg_tpu_torch, the PyTorch/CUDA port of simvg_tpu.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit:

    python3 chip_smoke.py

It builds every kernel of the port from ``simvg_tpu_torch/csrc/``, holds
each against its plain PyTorch version at the main path's shapes, then
serves the flagship configuration
(``configs/single/ViT-base/refcoco/refcoco_onestage.py``: BEiT3-base/32
at 640 px, 12 layers, D=768, TGQS-KD-DETR head) at full width on random
weights from a seed: 3 batches of 8 requests through ``make_eval_step``
and ``evaluate``, counting K1's launches.  It then holds the served model
against the same weights with plain attention (bf16 outputs, float32
encoder features) and times the eval forward with each.  Every phase
raises on failure; there is no CPU path.

Output: the card's name and power limit (nvidia-smi), one line per phase,
a ``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(REPO, "configs", "single", "ViT-base", "refcoco",
                        "refcoco_onestage.py")
BATCH = 8
N_BATCHES = 3
TIMING_REPEATS = 5  # passes over the requests per turn when timing
SEED = 0

# K1 vs its plain version.  float32: the bound of
# tests/test_pallas_attention.py.  bf16: the output is stored in bf16, whose
# step is 2^-6 = 0.0156 for |out| in [2, 4); the kernel rounds P before
# normalising and the plain version after, so one output may land one bf16
# step away; a wrong kernel is off by far more.
K1_CHECKS = [  # (batch, seq, heads, head_dim, dtype name, bound)
    (8, 421, 12, 64, "bfloat16", 2e-2),  # flagship, base/32 @ 640
    (8, 421, 12, 64, "float32", 2e-5),
    (2, 1621, 16, 64, "bfloat16", 2e-2),  # patch-16 sequence, large heads
]
MODEL_BOUND = 1e-2  # bf16 logits/boxes, kernel vs plain attention (bench.py)
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
        for fn in (kern, plain):
            fn()  # warm-up
        # in turns: plain, kernel, kernel, plain
        p1, k1, k2, p2 = (cuda_ms(fn, 20) for fn in (plain, kern, kern, plain))
        row = dict(shape=[b, s, h, hd], dtype=dname, max_abs_err=err,
                   bound=bound, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
        log(f"K1 {row} [{card}]")
        rows.append(row)
    return rows


def make_requests(rng, n_batches, vocab, max_token, img_size):
    """uint8 BGR canvases with varied valid extents, text of 3..max_token
    tokens padded to max_token, and gt boxes inside the valid extent."""
    import numpy as np

    batches = []
    for _ in range(n_batches):
        shapes = np.stack([rng.integers(img_size // 2, img_size + 1, BATCH),
                           rng.integers(img_size // 2, img_size + 1, BATCH)],
                          axis=1).astype(np.int32)
        lengths = rng.integers(3, max_token + 1, BATCH)
        ids = rng.integers(1, vocab, (BATCH, max_token)).astype(np.int64)
        pad = (np.arange(max_token)[None] >= lengths[:, None]).astype(
            np.int64)
        ids[pad == 1] = 0
        image = rng.integers(0, 256, (BATCH, img_size, img_size, 3)).astype(
            np.uint8)
        x1 = rng.uniform(0, 0.5, BATCH) * shapes[:, 1]
        y1 = rng.uniform(0, 0.5, BATCH) * shapes[:, 0]
        gt = np.stack([x1, y1, x1 + 0.4 * shapes[:, 1],
                       y1 + 0.4 * shapes[:, 0]], 1).astype(np.float32)
        batches.append(dict(image=image, text_ids=ids, text_padding_mask=pad,
                            img_shape=shapes, gt_boxes=gt[:, None, :],
                            batch_valid=np.ones(BATCH, bool)))
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


def to_device(batch):
    import torch
    from simvg_tpu_torch.engine.evaluate import DEVICE_KEYS

    return {k: torch.as_tensor(batch[k]).cuda() for k in DEVICE_KEYS}


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
    loader = make_requests(np.random.default_rng(SEED), N_BATCHES,
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
    lib = _build.build("attention_fwd")
    log(f"built {os.path.relpath(lib, REPO)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = check_k1(gen, card)
    launches = serve_flagship(card)

    # every number on this line is measured here; the per-shape rows with
    # their bounds are on the "K1" lines above
    main_row = rows[0]
    print(json.dumps({"kernels": [{
        "name": "attention_fwd",
        "route": "cuda",
        "source": "simvg_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "simvg_tpu/ops/pallas_attention.py:55",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
