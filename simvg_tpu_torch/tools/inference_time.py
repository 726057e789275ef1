"""Latency and throughput of the serving forward (counterpart of
``tools/misc/inference_time.py``): the dual-branch eval step (forward and
both branches decoded) on a random batch, warm-up, then a timed loop with
a device sync each iteration; p50/p90/mean latency, images/s and the
parameter count.

    python -m simvg_tpu_torch.tools.inference_time [CONFIG]
        [--batch-size 1] [--iters 100] [--warmup 10] [--profile]
        [--trace-dir DIR] [--device cuda|cpu]

Without a config it times the flagship (BEiT3-base/32 at 640 px, bf16).
``--profile`` prints a ``torch.profiler`` summary of 3 more iterations
(device time by kernel on the card).  ``--trace-dir DIR`` writes a
``torch.profiler`` Chrome trace of one more step, gzipped, to
``DIR/inference_time.pt.trace.json.gz`` and prints its path (the JAX
tool's flag; open the file in Perfetto or chrome://tracing).  Weights
are random (``init_random_weights``, seed 0).  It runs on the card unless
``--device cpu`` is given, and raises where there is no card; a time
measured on the CPU is the CPU's, not the card's.  ``main(argv)`` returns
the numbers.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from simvg_tpu_torch.config import Config
from simvg_tpu_torch.engine import make_eval_step
from simvg_tpu_torch.models import build_model, init_random_weights

from .train import model_dtype, resolve_device

_FLAGSHIP_MODEL = {"vis_enc": {"vit_type": "base", "patch_size": 32,
                               "img_size": 640, "attn_impl": "pallas"},
                   "head": {"num_queries": 1, "in_channels": 768}}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="serving latency")
    p.add_argument("config", nargs="?", default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--profile", action="store_true",
                   help="print a torch.profiler summary")
    p.add_argument("--trace-dir", default=None,
                   help="write a gzipped torch.profiler Chrome trace of "
                        "one step here")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.config:
        cfg = Config.fromfile(args.config)
        img_size, t = cfg.get("img_size", 640), cfg.get("max_token", 20)
        model_cfg, dtype = cfg.model, model_dtype(cfg)
    else:
        img_size, t = 640, 20
        model_cfg, dtype = _FLAGSHIP_MODEL, torch.bfloat16
    model, _ = build_model(model_cfg, img_size=img_size, dtype=dtype,
                           device=device)
    init_random_weights(model, 0)
    n_params = sum(p.numel() for p in model.parameters())

    b = args.batch_size
    r = np.random.default_rng(0)
    batch = {k: torch.as_tensor(v).to(device) for k, v in dict(
        image=r.normal(size=(b, img_size, img_size, 3)).astype(np.float32),
        text_ids=r.integers(1, 100, (b, t)).astype(np.int32),
        text_padding_mask=np.zeros((b, t), np.int32),
        img_shape=np.full((b, 2), img_size, np.int32)).items()}
    step = make_eval_step(model)

    def infer():
        preds = step(batch)
        _sync(device)
        return preds

    for _ in range(args.warmup):
        infer()
    lat = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        infer()
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat) * 1e3

    from torch.profiler import ProfilerActivity, profile as prof

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    profile = trace = None
    if args.profile:
        with prof(activities=acts) as p:
            for _ in range(3):
                infer()
        key = ("self_device_time_total" if device.type == "cuda"
               else "self_cpu_time_total")
        profile = p.key_averages().table(sort_by=key, row_limit=15)
        print(profile)
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        trace = os.path.join(args.trace_dir,
                             "inference_time.pt.trace.json.gz")
        with prof(activities=acts) as p:
            infer()
        p.export_chrome_trace(trace)  # gzipped by the name's .gz
        print(f"trace written to {trace}")

    out = dict(device=(torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
               params=n_params, batch=b,
               iters=args.iters, p50_ms=float(np.percentile(lat, 50)),
               p90_ms=float(np.percentile(lat, 90)),
               mean_ms=float(lat.mean()),
               images_per_s=float(b / (lat.mean() / 1e3)), trace=trace)
    print(f"device: {out['device']}")
    print(f"params: {n_params / 1e6:.2f}M")
    print(f"batch={b} iters={args.iters}")
    print(f"latency p50: {out['p50_ms']:.2f} ms  p90: {out['p90_ms']:.2f} "
          f"ms  mean: {out['mean_ms']:.2f} ms")
    print(f"throughput: {out['images_per_s']:.1f} images/sec")
    return out


if __name__ == "__main__":
    main()
