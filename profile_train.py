#!/usr/bin/env python3
"""Where the time of the port's flagship train step goes, on the GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU:

    python3 profile_train.py

For each attention implementation (pallas, then xla) it builds the flagship
(``configs/single/ViT-base/refcoco/refcoco_onestage.py``) at full width on
random weights, as ``chip_smoke.py`` trains it (batch 32, bf16 compute,
fp32 params, the config's optimizer), warms up two steps, then profiles
STEPS steps with ``torch.profiler``.  It prints the card's name and
power limit, and per implementation: the wall time per step, the device's
busy time per step (the union of its kernels' intervals) and idle share,
device time per kernel class, the host time spent in Hungarian matching,
and the kernels with the most device time.
"""

from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
STEPS = 3

# kernel-name substrings -> class, first match wins
CLASSES = (
    ("K1 attention fwd", ("attention_fwd_",)),
    ("K2 attention bwd", ("dkdv_", "dq_", "dsum_kernel")),
    ("GEMM (cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
    ("optimizer (foreach)", ("multi_tensor_apply", "foreach")),
    ("LayerNorm", ("layer_norm",)),
    ("conv (cuDNN)", ("conv", "cudnn", "implicit")),
    ("softmax", ("softmax",)),
    ("casts and copies", ("copy", "cast")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k.lower() in low for k in keys):
            return label
    return "other"


def busy_us(intervals):
    """Length of the union of [start, end) intervals, in microseconds."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile_impl(impl, steps, card):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.losses import criterion

    cfg = Config.fromfile(cs.FLAGSHIP)
    model, loss_cfg = cs.build_flagship(cfg, impl, torch.bfloat16)
    enc = model.cfg.beit3
    norm = dict(mean=cfg.img_norm_cfg["mean"], std=cfg.img_norm_cfg["std"],
                to_rgb=True)
    batches = [cs.to_device(b, cs.TRAIN_KEYS) for b in cs.make_requests(
        np.random.default_rng(cs.SEED + 1), steps + 2, cs.TRAIN_BATCH,
        enc.vocab_size, cfg.max_token, cfg.img_size)]
    step, state = cs.make_train_step_for(cfg, model, loss_cfg, norm)

    match_s = []
    assign = criterion.hungarian_assign

    def timed_assign(*args, **kw):  # host time of each matching call
        t0 = time.perf_counter()
        out = assign(*args, **kw)
        match_s.append(time.perf_counter() - t0)
        return out

    criterion.hungarian_assign = timed_assign
    try:
        for batch in batches[:2]:  # warm-up
            state, _ = step(state, batch, cs.SEED)
        torch.cuda.synchronize()
        match_s.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for batch in batches[2:]:
                state, _ = step(state, batch, cs.SEED)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    finally:
        criterion.hungarian_assign = assign

    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy = busy_us(intervals) / 1e3 / steps
    by_class, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        c = kernel_class(e.name)
        by_class[c] = by_class.get(c, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    print(f"[{impl}] {steps} profiled steps of batch {cs.TRAIN_BATCH}: wall "
          f"{wall_ms:.3f} ms/step under the profiler, device busy "
          f"{busy:.3f} ms/step, idle share {1 - busy / wall_ms:.3f}, "
          f"{len(kernels) / steps:.0f} kernels/step; Hungarian matching "
          f"{len(match_s) / steps:.0f} calls, "
          f"{sum(match_s) * 1e3 / steps:.3f} ms host time/step [{card}]",
          flush=True)
    for c, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"[{impl}]   {c}: {us / 1e3 / steps:.3f} ms/step "
              f"({us / 1e3 / steps / busy:.1%} of busy)", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    for name, us in top:
        print(f"[{impl}]   top: {us / 1e3 / steps:.3f} ms/step  "
              f"{name[:110]}", flush=True)
    del model, state, step
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for impl in ("pallas", "xla"):
        profile_impl(impl, STEPS, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
