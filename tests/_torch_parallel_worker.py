"""One rank of the port's multi-process CPU tests (gloo), started by
``util_torch_port.run_ranks`` with torchrun's environment.

    python tests/_torch_parallel_worker.py train DIR [[SUB/]LAYOUT|sp ...]
    python tests/_torch_parallel_worker.py eval DIR
    python tests/_torch_parallel_worker.py cli DIR train|test ARGV...

reads ``DIR/inputs.npz`` (the weights under ``sd/``, the global batch under
``batch/``) and ``DIR/config.json`` (the tiny encoder's and head's
arguments, the optimizer's, ``fsdp_min_size``), and runs in one process
group, for each layout named (every 2-rank layout of ``LAYOUTS`` and
``sp`` when none is), two train steps of the tiny model on this rank's
shard of the global batch; ``SUB/LAYOUT`` reads its inputs from, and
writes its outputs to, ``DIR/SUB`` instead.  Rank 0 writes, per layout,
``<layout>.npz``: the scalars of both steps and the whole parameters and
EMA after them, and after the FSDP layout ``zero.json`` (its local element
counts of each parameter, gradient, moment and EMA).  ``sp`` writes, each
rank, ``sp_rank<r>.json`` (the sequence-parallel forward against the
unsharded one, and the sequence lengths the encoder layers saw).

``eval`` reads ``DIR/eval_inputs.npz`` (the tiny encoder's weights under
``sd/``, a global batch under ``batch/``) and ``DIR/eval.json`` (each
case's encoder arguments, model-parallel size and quant collection), lays
the encoder out for each case (DDP with data 2, or tensor parallelism over
the model axis, with sequence parallelism where the case sets it), runs
its eval forward on this rank's part of the batch and gathers the outputs
over the data axis; rank 0 writes ``DIR/eval_<case>.npz`` (the image, text
and CLS features, and the kept indices of a pruned encoder).

``cli`` joins the group, then runs the port's train or test CLI with
``ARGV`` (which holds ``--distributed``: the CLI takes the group and
leaves it) and writes what it returns to ``DIR/result_rank<r>.json``.

This file imports no JAX: the tests compute the references.
"""

import datetime
import json
import os.path as osp
import sys

import numpy as np
import torch

from simvg_tpu_torch.engine import (create_optimizer, create_train_state,
                                    make_train_step)
from simvg_tpu_torch.engine.train import train_losses
from simvg_tpu_torch.models.beit3 import (BEiT3Config, BEiT3Encoder,
                                          EncoderLayer)
from simvg_tpu_torch.models.heads.tgqs_head import TGQSHeadConfig
from simvg_tpu_torch.models.model import SimVGConfig, SimVGModel
from simvg_tpu_torch.parallel import (create_mesh, full_tensor,
                                      init_distributed, local, shard_model)

# layout -> (model_parallel, fsdp, seq_parallel, remat); the last is for 4
# ranks (data 2 x model 2)
LAYOUTS = {"ddp": (1, False, False, False),
           "fsdp": (1, True, False, True),
           "tp": (2, False, False, False),
           "tp_sp": (2, False, True, False),
           "fsdp_tp_sp": (2, True, True, False)}
TWO_RANKS = ("ddp", "fsdp", "tp", "tp_sp")


def build(cfg, sd, seq_parallel=False, remat=False):
    model = SimVGModel(SimVGConfig(
        beit3=BEiT3Config(**cfg["beit3"], seq_parallel=seq_parallel,
                          remat=remat),
        head=TGQSHeadConfig(**cfg["head"])))
    model.load_state_dict(sd, strict=True)
    return model


def run_layout(name, cfg, sd, batch, out_dir):
    mp, fsdp, sp, remat = LAYOUTS[name]
    model = build(cfg, sd, sp, remat)
    mesh = create_mesh(mp, "cpu")
    sharded = shard_model(model, mesh, fsdp=fsdp,
                          fsdp_min_size=cfg["fsdp_min_size"])
    dp, r = sharded.dp, sharded.dp_rank
    b = len(batch["image"]) // dp
    mine = {k: v[r * b:(r + 1) * b] for k, v in batch.items()}
    opt = create_optimizer(**cfg["optimizer"])
    state = create_train_state(model, opt, ema=True)
    step = make_train_step(model, opt, branch_loss_weight=cfg["blw"],
                           ema_alpha=0.99, sharded=sharded)
    scalars = []
    for _ in range(2):
        state, s = step(state, mine, 1)
        scalars.append({k: float(v) for k, v in s.items()})
    names, params = zip(*model.named_parameters())
    out = {}
    for n, p, e in zip(names, params, state.ema_params):
        out[f"param/{n}"] = full_tensor(local(p.detach()), p).numpy()
        out[f"ema/{n}"] = full_tensor(e, p).numpy()
    if name == "fsdp":
        # a backward alone, for the gradients' local sizes
        losses, _ = train_losses(sharded.module, mine, mine["image"],
                                 branch_loss_weight=cfg["blw"], dp_size=dp,
                                 batch_sum=sharded.batch_sum)
        losses["loss_total"].backward()
        sharded.sync_grads(params)
        zero = {n: {"shape": list(p.shape), "numel": p.numel(),
                    "param": local(p).numel(),
                    # None: a parameter the forward does not use
                    "grad": (None if p.grad is None
                             else local(p.grad).numel()),
                    "mu": state.opt_state.mu[i].numel(),
                    "nu": state.opt_state.nu[i].numel(),
                    "nu_max": state.opt_state.nu_max[i].numel(),
                    "ema": state.ema_params[i].numel()}
                for i, (n, p) in enumerate(zip(names, params))}
        if torch.distributed.get_rank() == 0:
            with open(osp.join(out_dir, "zero.json"), "w") as f:
                json.dump(zero, f)
    if torch.distributed.get_rank() == 0:
        np.savez(osp.join(out_dir, f"{name}.npz"), **out,
                 scalars=json.dumps(scalars))


def sp_forward(cfg, sd, batch, out_dir):
    """The tensor- and sequence-parallel eval forward against the same
    weights unsharded, on the whole batch, and the residual stream's
    sequence lengths at each layer's input on this rank."""
    plain = build(cfg, sd).eval()
    model = build(cfg, sd, seq_parallel=True).eval()
    shard_model(model, create_mesh(2, "cpu"))
    seen = []
    for m in model.modules():
        if isinstance(m, EncoderLayer):
            m.register_forward_pre_hook(
                lambda mod, args: seen.append([a.shape[1] for a in args[0]]))
    keys = ("image", "text_ids", "text_padding_mask")
    with torch.no_grad():
        want = plain(*(batch[k] for k in keys), img_shape=batch["img_shape"])
        got = model(*(batch[k] for k in keys), img_shape=batch["img_shape"])
    err = max(float((got[k] - want[k]).abs().max()) for k in want)
    rank = torch.distributed.get_rank()
    with open(osp.join(out_dir, f"sp_rank{rank}.json"), "w") as f:
        json.dump({"max_abs_err": err, "layer_input_lengths": seen,
                   "keys": sorted(want)}, f)


def run_eval(out_dir):
    from simvg_tpu_torch.ops.quant import attach_static_quant

    with open(osp.join(out_dir, "eval.json")) as f:
        cases = json.load(f)
    arrays = np.load(osp.join(out_dir, "eval_inputs.npz"))
    sd = {k[3:]: torch.from_numpy(arrays[k]) for k in arrays.files
          if k.startswith("sd/")}
    batch = [torch.from_numpy(arrays[f"batch/{k}"])
             for k in ("image", "text_ids", "text_padding_mask")]
    for name, case in cases.items():
        enc = BEiT3Encoder(BEiT3Config(**case["beit3"]))
        enc.load_state_dict(sd, strict=True)
        attach_static_quant(enc, case.get("quant_npz"))
        mesh = create_mesh(case["mp"], "cpu")
        sharded = shard_model(enc.eval(), mesh)
        dp, r = sharded.dp, sharded.dp_rank
        b = len(batch[0]) // dp
        prune = case["beit3"].get("token_prune_keep") is not None
        with torch.no_grad():
            out = enc(*(t[r * b:(r + 1) * b] for t in batch),
                      return_prune_idx=prune)
        keys = ("img_feat", "text_feat", "cls_feat", "prune_idx")
        got = {}
        for k, t in zip(keys, out):
            parts = [torch.empty_like(t) for _ in range(dp)]
            torch.distributed.all_gather(parts, t.contiguous(),
                                         group=mesh["data"].get_group())
            got[k] = torch.cat(parts).numpy()
        if torch.distributed.get_rank() == 0:
            np.savez(osp.join(out_dir, f"eval_{name}.npz"), **got)


def run_cli(out_dir, which, argv):
    import os

    from simvg_tpu_torch.tools import test as test_cli
    from simvg_tpu_torch.tools import train as train_cli

    cli = {"train": train_cli, "test": test_cli}[which]
    result = cli.main(argv)
    with open(osp.join(out_dir, f"result_rank{os.environ['RANK']}.json"),
              "w") as f:
        json.dump(result, f)


def read_inputs(d):
    """(config, state dict, global batch) of the train inputs in ``d``."""
    with open(osp.join(d, "config.json")) as f:
        cfg = json.load(f)
    arrays = np.load(osp.join(d, "inputs.npz"))
    sd = {k[3:]: torch.from_numpy(arrays[k]) for k in arrays.files
          if k.startswith("sd/")}
    batch = {k[6:]: torch.from_numpy(arrays[k]) for k in arrays.files
             if k.startswith("batch/")}
    return cfg, sd, batch


def main():
    scenario, out_dir = sys.argv[1], sys.argv[2]
    init_distributed("cpu", timeout=datetime.timedelta(seconds=120))
    if scenario == "cli":
        run_cli(out_dir, sys.argv[3], sys.argv[4:])
        return
    if scenario == "eval":
        try:
            run_eval(out_dir)
        finally:
            torch.distributed.destroy_process_group()
        return
    try:
        if scenario != "train":
            raise ValueError(f"unknown scenario {scenario!r}")
        for arg in sys.argv[3:] or TWO_RANKS + ("sp",):
            sub, _, name = arg.rpartition("/")
            d = osp.join(out_dir, sub)
            cfg, sd, batch = read_inputs(d)
            if name == "sp":
                sp_forward(cfg, sd, batch, d)
            else:
                run_layout(name, cfg, sd, batch, d)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
