"""The big synthetic tier's distillation chain through the port's train CLI
(counterpart of ``tools/misc/distill_proof_big.sh``): the same configs in the
same order, on data the port writes.

    python -m simvg_tpu_torch.tools.distill_proof_big --out DIR
        [--device cuda|cpu] [--n-train 512] [--n-val 64]
        [--cfg-options key=value ...]

1. two-stage stage 1, ``configs/smoke/converge_synth_big_stage1.py``
   (decoder-only loss, EMA);
2. two-stage stage 2, ``converge_synth_big_stage2.py`` (balanced
   distillation at 0.6x the learning rate), ``--load-from`` stage 1's
   ``latest``;
3. the token-only control, ``converge_synth_big_token_only.py``;
4. the one-stage control, ``converge_synth_big.py``.

The data is ``make_synth_data``'s RefCOCO style (``--n-train`` train and
``--n-val`` val images of 120x160).  Every run writes under ``DIR/<name>``;
``DIR/summary.json`` gets, per run, the per-branch val Prec@0.5 of the last
evaluation and the best, and the run's wall time.  ``--cfg-options`` go to
every run (a test shortens the chain with ``scheduler_config.max_epoch``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

from simvg_tpu_torch.tools import train as train_cli
from simvg_tpu_torch.tools.make_synth_data import make_refcoco_style

SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "smoke")
RUNS = (  # (name, config, load stage 1's latest)
    ("converge_big_s1", "converge_synth_big_stage1.py", False),
    ("converge_big_s2", "converge_synth_big_stage2.py", True),
    ("converge_big_token_only", "converge_synth_big_token_only.py", False),
    ("converge_big_onestage", "converge_synth_big.py", False),
)
BRANCHES = ("decoder", "token")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--n-train", type=int, default=512)
    p.add_argument("--n-val", type=int, default=64)
    p.add_argument("--cfg-options", nargs="*", default=[])
    args = p.parse_args(argv)
    train_cli.resolve_device(args.device)

    imgdir, ann = make_refcoco_style(os.path.join(args.out, "data"),
                                     args.n_train, args.n_val,
                                     device=args.device)
    # the shell chain's latest_interval: the final epoch's latest still
    # saves, which stage 2 loads
    opts = ["latest_interval=25"] + [
        f"data.{s}.{k}={v}" for s in ("train", "val")
        for k, v in (("annsfile", ann), ("imgsfile", imgdir))]
    summary = {}
    for name, config, load in RUNS:
        argv = [os.path.join(SMOKE, config), "--work-dir",
                os.path.join(args.out, name), "--device", args.device]
        if load:
            argv += ["--load-from",
                     os.path.join(args.out, "converge_big_s1", "latest")]
        t0 = time.perf_counter()
        res = train_cli.main(argv + ["--cfg-options", *opts,
                                     *args.cfg_options])
        with open(os.path.join(args.out, name, "metrics.jsonl")) as f:
            evals = [m for m in map(json.loads, f)
                     if m["kind"] == "eval" and m["split"] == "val"]
        summary[name] = {
            "config": config,
            "seconds": time.perf_counter() - t0,
            "epochs": len(res["epochs"]),
            "last_eval_epoch": evals[-1]["epoch"],
            **{f"{b}_prec50_last": evals[-1][f"{b}_det_acc"]
               for b in BRANCHES},
            **{f"{b}_prec50_best": max(m[f"{b}_det_acc"] for m in evals)
               for b in BRANCHES},
        }
        print(json.dumps({name: summary[name]}), flush=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
