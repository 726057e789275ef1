"""Where the encoder's milliseconds go: the flagship BEiT3-base/32 encoder
forward (b=32, S=421, bf16) under one-change ablations (counterpart of
``tools/misc/encoder_ablation.py``).

    python -m simvg_tpu_torch.tools.encoder_ablation [--batch 32]
        [--iters 10] [--only NAME] [--device cuda|cpu]

Rows: ``k1`` (the baseline: ``attn_impl="pallas"``, K1), ``plain_attn``
(the pure-torch attention), ``ln_off`` (every LayerNorm an identity),
``attn_off`` (the attention core replaced by q + k + v), ``gelu_tanh``
(the port computes the exact erf GELU in float32, which is the JAX
package's ``gelu_exact``; this row swaps in torch's tanh form in bf16, as
JAX's bf16 default is a fast GELU), ``b64`` and ``b128`` (the baseline at
those batches).  JAX's ``unrolled`` row (``scan_layers``) changes only how
XLA compiles the stack: it is printed as not applicable.

The rows are timed interleaved: two untimed rounds, then ``--iters``
rounds that each time one forward of every row in turn (CUDA events on
the card), so clock ramp and warm-up fall on every row alike rather than
on the first.  Each row gives the median of its ``--iters`` forwards,
the median host time to enqueue one (where it is near the row's ms, the
forward waits on the host's launches and the row says little of the
card's work), images/s, TFLOP/s, the share of the card's bf16 dense peak
(989 TFLOP/s, H100 SXM) and its time against the ``k1`` row's, with the
card's name and power limit above the table.  Weights are random
(``init_random_weights``, seed 0).  ``--device cpu`` only checks that
every row runs: its times are the CPU's.  ``main(argv)`` returns the
rows.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import subprocess
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

import simvg_tpu_torch.models.beit3 as beit3
from simvg_tpu_torch.models.builder import init_random_weights
from simvg_tpu_torch.models.layers import LayerNorm

from .train import resolve_device

PEAK_BF16 = 989e12  # H100 SXM dense bf16
TEXT_LEN = 20
NOT_APPLICABLE = {"unrolled": "scan_layers only changes how XLA compiles "
                  "the stack; torch runs the layers as written"}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def encoder_flops(cfg: beit3.BEiT3Config, batch: int) -> float:
    """The matmul FLOPs of one forward (JAX's ``flops_encoder``)."""
    s = cfg.seq_vision + TEXT_LEN
    d, f, n = cfg.embed_dim, cfg.ffn_dim, cfg.num_layers
    per_layer = 8 * s * d * d + 4 * s * s * d + 4 * s * d * f
    patchify = 2 * cfg.num_patches * d * (cfg.patch_size ** 2 * 3)
    return batch * (n * per_layer + patchify)


@contextlib.contextmanager
def ablation(model: torch.nn.Module, name: str):
    """The one change of row ``name`` on ``model``, undone after."""
    undo = []
    if name == "ln_off":
        for m in model.modules():
            if isinstance(m, LayerNorm):
                m.forward = lambda x: x
                undo.append(lambda m=m: delattr(m, "forward"))
    elif name == "attn_off":
        orig = beit3.multihead_attention
        beit3.multihead_attention = \
            lambda q, k, v, **kw: (q + k + v).to(kw.get("dtype", q.dtype))
        undo.append(lambda: setattr(beit3, "multihead_attention", orig))
    elif name == "gelu_tanh":
        orig = beit3._gelu
        beit3._gelu = lambda h, dtype: F.gelu(h.to(dtype), approximate="tanh")
        undo.append(lambda: setattr(beit3, "_gelu", orig))
    try:
        yield
    finally:
        for fn in undo:
            fn()


def time_once(fn, device: torch.device) -> Tuple[float, float]:
    """(ms, host ms) of one ``fn()``: CUDA events on the card around it,
    and the host's time until ``fn`` returns, that is, to enqueue its
    work; on the CPU both are the host clock's."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        ms = (time.perf_counter() - t0) * 1e3
        return ms, ms
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    fn()
    host = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    return start.elapsed_time(end), host


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="encoder forward ablations")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--only", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> List[Dict]:
    args = parse_args(argv)
    device = resolve_device(args.device)
    base = beit3.BEiT3Config.base(img_size=640, patch_size=32,
                                  dtype=torch.bfloat16, drop_path_rate=0.0,
                                  attn_impl="pallas")
    rows = {"k1": (base, args.batch),
            "plain_attn": (dataclasses.replace(base, attn_impl="xla"),
                           args.batch),
            "ln_off": (base, args.batch), "attn_off": (base, args.batch),
            "gelu_tanh": (base, args.batch), "b64": (base, 64),
            "b128": (base, 128)}
    if device.type == "cuda":
        print(card_line())
    print(f"BEiT3-base/32 encoder forward, S={base.seq_vision + TEXT_LEN}, "
          f"bf16, {base.num_layers} layers, median of {args.iters} "
          f"interleaved rounds")
    rng = np.random.default_rng(0)
    models = {}  # one model a config: the rows but plain_attn share it
    calls = {}
    for name, (cfg, batch) in rows.items():
        if args.only and args.only not in name:
            continue
        model = models.get(cfg.attn_impl)
        if model is None:
            with torch.device(device):
                model = beit3.BEiT3Encoder(cfg)
            model = models[cfg.attn_impl] = init_random_weights(model,
                                                                0).eval()
        img = torch.from_numpy(rng.normal(0, 1, (
            batch, cfg.img_size, cfg.img_size, 3)).astype(np.float32)).to(
            device, torch.bfloat16)
        ids = torch.from_numpy(rng.integers(0, 1000, (batch, TEXT_LEN))).to(
            device)
        pad = torch.zeros(batch, TEXT_LEN, dtype=torch.int32, device=device)

        def call(name=name, model=model, img=img, ids=ids, pad=pad):
            with ablation(model, name), torch.no_grad():
                model(img, ids, pad)

        calls[name] = call
    times = {name: [] for name in calls}
    for r in range(2 + args.iters):
        for name, call in calls.items():
            ms = time_once(call, device)
            if r >= 2:
                times[name].append(ms)
    out = []
    for name in calls:
        cfg, batch = rows[name]
        ms, host_ms = (float(v) for v in np.median(times[name], axis=0))
        tflops = encoder_flops(cfg, batch) / ms / 1e9
        row = dict(name=name, batch=batch, ms=ms, host_ms=host_ms,
                   images_per_s=batch / ms * 1e3, tflops=tflops,
                   peak_share=tflops * 1e12 / PEAK_BF16)
        if out and out[0]["name"] == "k1":
            row["vs_k1"] = ms / out[0]["ms"] - 1
        print(f"{name:12s} b={batch:<4d} {ms:9.3f} ms (host {host_ms:7.3f}) "
              f"{row['images_per_s']:9.1f} img/s {tflops:7.1f} TFLOP/s "
              f"{row['peak_share'] * 100:5.1f}% of peak"
              + (f" {row['vs_k1'] * 100:+6.1f}% vs k1" if "vs_k1" in row
                 else ""), flush=True)
        out.append(row)
    for name, why in NOT_APPLICABLE.items():
        print(f"{name:12s} not applicable: {why}")
    return out


if __name__ == "__main__":
    main()
