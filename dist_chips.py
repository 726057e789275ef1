#!/usr/bin/env python3
"""simvg_tpu_torch's multi-card layouts (``simvg_tpu_torch/parallel/mesh.py``)
across every card of one host: held against one card, then timed.

    python3 dist_chips.py                  # 2 or more CUDA cards (NCCL)
    python3 dist_chips.py --device cpu --config configs/smoke/tiny_synth.py \\
        --ranks 4                          # the same program, gloo
    python3 dist_chips.py --num-layers 4 --only tp_int8   # one check, no timing

One process per card, spawned here; the kernels are built first, once.
The config (default ``configs/single/ViT-large/refcoco/
refcoco_onestage_fsdp8.py``, the config that needs M16) runs at full width
on random weights from a seed, ``samples_per_gpu`` samples a rank:

1. **Sharded equals unsharded.**  In float32 (K1/K2's float32 routes, so
   the comparison sees the layout, not bf16 rounding), dropout off, one
   global batch: the loss terms and gradients of DDP, FSDP2 (the config's
   ``fsdp_min_size``) and, with an even number of ranks, tensor plus
   sequence parallelism (model axis 2) against the same model unwrapped
   on rank 0 over the whole global batch (JAX's ``make_train_step(dp_size=
   dp)`` semantics): every loss term within rtol ``LOSS_RTOL``, every
   gradient within ``GRAD_REL`` of its tensor's max |g|; also with
   ``quant="int8_qat"`` under tensor plus sequence parallelism, whose
   scales are the global tensors': every rank's lead activation scales
   (the first layer's q/k/v inputs, ``LEAD``) within ``LEAD_RTOL`` of the
   unwrapped model's (every other scale and the outputs' distance are
   logged beside the ones that float rounding alone makes, the unwrapped
   QAT model with its weights perturbed by ``NOISE``).  Then
   the serving levers under tensor
   parallelism, eval forwards against the unwrapped model on the whole
   batch: dynamic int8 (within ``INT8_SHARE`` of the int8 model's own
   distance from float32) and token pruning with sequence parallelism
   (within ``GRAD_REL`` of each output's max |value|).
2. **Timing.**  In the config's dtype and remat: 1 + ``STEPS`` train steps
   of the unwrapped model on rank 0 alone (the others wait), then of each
   layout on every rank: the step's median (host clock around a
   synchronised step), images/s of the global batch, and the peak
   allocated memory of each rank; K1/K2 launches a step.  Then one more
   step under ``torch.profiler`` on the cards: rank 0's device busy time,
   its NCCL kernels' and the rest's (each the union of its kernels'
   intervals), and the idle share of that step.

Output: the card's name and power limit, one line per check and layout,
and, as the last line, a JSON summary of every reading.
It exits non-zero when fewer than 2 ranks are available or a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import datetime
import json
import os
import re
import socket
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEFAULT_CONFIG = os.path.join(REPO, "configs", "single", "ViT-large",
                              "refcoco", "refcoco_onestage_fsdp8.py")
SEED = 0
STEPS = 3  # timed train steps of each layout, after one warm-up
LOSS_RTOL = 1e-4  # float32, another summation order of the same sums
GRAD_REL = 1e-4  # of each gradient tensor's max |g|
KEYS = ("image", "text_ids", "text_padding_mask", "img_shape", "gt_boxes",
        "gt_labels", "gt_valid")


def log(msg: str) -> None:
    print(msg, flush=True)


def build(cfg, dtype, device, state=None, **vis):
    """The config's model on ``device``: random weights from SEED (drawn
    on the CPU, so every rank holds the same), or ``state``."""
    import torch
    from simvg_tpu_torch.models import build_model, init_random_weights

    model_cfg = copy.deepcopy(dict(cfg.model))
    model_cfg["vis_enc"] = dict(model_cfg["vis_enc"], **vis)
    model, loss_cfg = build_model(model_cfg, img_size=cfg.img_size,
                                  dtype=dtype, device="meta")
    model = model.to_empty(device=device)
    if state is None:
        init_random_weights(model, SEED)
    else:
        model.load_state_dict(state, strict=True)
    return model, loss_cfg


def global_batch(cfg, n, device):
    import numpy as np
    import torch

    from chip_smoke import make_requests

    b = make_requests(np.random.default_rng(SEED + 9), 1, n,
                      cfg.model.vis_enc.vocab_size, cfg.max_token,
                      cfg.img_size)[0]
    return {k: torch.as_tensor(b[k]).to(device) for k in KEYS}


def layouts(world, timed=False):
    """name -> (model_parallel, fsdp, seq_parallel, more vis_enc settings);
    ``timed``: the layouts that part 2 times (the int8_qat one is checked
    only)."""
    out = {"ddp": (1, False, False, {}), "fsdp": (1, True, False, {})}
    if world % 2 == 0:
        out["tp_sp"] = (2, False, True, {})
        if not timed:
            out["tp_sp_int8_qat"] = (2, False, True, {"quant": "int8_qat"})
    return out


def prune_settings(cfg):
    """Token pruning as the flagship serves it (keep 300 of 400 patches
    after layer 4), scaled to the config's patch grid and depth."""
    ve = cfg.model.vis_enc
    n = (cfg.img_size // ve.get("patch_size", 32)) ** 2
    return dict(token_prune_keep=n * 3 // 4, token_prune_force=True,
                token_prune_layer=min(4, ve.get("num_layers", 24) - 2),
                scan_layers=False)


# serving levers under tensor parallelism (model axis 2): name ->
# (seq_parallel, vis_enc settings); "prune" takes prune_settings
SERVING = {"tp_int8": (False, {"quant": "int8"}),
           "tp_sp_prune": (True, "prune")}
# a sharded int8 model's mean |distance| from the unwrapped int8 model, at
# most this share of the int8 model's own mean distance from float32: an
# activation that lands on a k + 0.5 boundary of its grid may round either
# way under another summation order
INT8_SHARE = 0.1
# int8_qat's train check holds the scales, not the outputs: a
# fake-quantized model moves under float rounding alone (an activation
# crosses a rounding boundary of its grid, and every layer after it sees
# a whole grid step), and at full width that motion hides a rank's own
# scale (PERF.md §6).  The lead scales, those of the first encoder layer's
# q/k/v inputs, which no fake quant comes before, within LEAD_RTOL of the
# unwrapped model's: float rounding moves them by ~1e-7, a scale taken
# over a shard of the batch or of the features by up to a fifth.  Every
# other scale moves with the rounding that came before it: at ViT-large's
# widths the unwrapped model's own scales move up to 3.7e-3 at 2 layers
# under weights times (1 + NOISE N(0, 1)) (PERF.md §6), past one
# int8 step (1/127) at 4, so those scales, like the outputs, are logged
# beside that noise (the larger of NOISE_SEEDS), not bounded
LEAD = re.compile(r"encoder\.layers\.0\.self_attn\.[qkv]_proj\.")
LEAD_RTOL = 1e-5
NOISE = 1e-7
NOISE_SEEDS = (1, 2)


@contextlib.contextmanager
def recorded_act_scales(model):
    """The per-tensor scales (``dim`` None: the activations') that
    ``model``'s ``Int8Linear`` layers take while the block runs, as (layer
    name, scale) in call order."""
    from simvg_tpu_torch.ops import quant

    scales, orig, current = [], quant.quantize_symmetric, [None]

    def record(w, dim=None, groups=()):
        q, s = orig(w, dim, groups)
        if dim is None:
            scales.append((current[0], s.item()))
        return q, s

    hooks = [m.register_forward_pre_hook(
        lambda _m, _x, name=name: current.__setitem__(0, name))
        for name, m in quant.quant_layers(model).items()]
    quant.quantize_symmetric = record
    try:
        yield scales
    finally:
        quant.quantize_symmetric = orig
        for h in hooks:
            h.remove()


def scale_distance(got, want, lead=False):
    """The largest relative distance of ``got``'s scales from ``want``'s,
    (name, scale) lists in call order (``lead``: the LEAD layers' only);
    inf when the two took other layers in another order."""
    if [n for n, _ in got] != [n for n, _ in want]:
        return float("inf")
    return max((abs(s - w) / w for (n, s), (_, w) in zip(got, want)
                if not lead or LEAD.search(n)), default=0.0)


def check_layouts(cfg, device, world, rank, results, only=None):
    """Part 1: each layout's loss terms and gradients against the
    unwrapped model's on the whole global batch, in float32; ``only``: the
    names of the checks to run (default all).  Returns (every layout within
    the bounds, on every rank; the weights)."""
    import torch
    import torch.distributed as dist

    from chip_smoke import dropout_off, l2, losses_and_grads
    from simvg_tpu_torch.parallel import FSDP_MIN_SIZE, create_mesh
    from simvg_tpu_torch.parallel import shard_model

    norm = dict(mean=cfg.img_norm_cfg["mean"], std=cfg.img_norm_cfg["std"],
                to_rgb=True)
    spg = cfg.data.samples_per_gpu
    whole = global_batch(cfg, spg * world, device)
    model, loss_cfg = build(cfg, torch.float32, device)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    # (dp, quant, seed) -> the unwrapped model's loss terms, grads and
    # activation scales; a seed perturbs its weights by a relative NOISE
    refs = {}

    def unwrapped(dp, quant, seed=None):
        if (dp, quant, seed) not in refs:
            weights = state
            if seed is not None:
                gen = torch.Generator(device=device).manual_seed(seed)
                weights = {k: v * (1 + NOISE * torch.randn(
                    v.shape, device=device, generator=gen))
                    if v.is_floating_point() else v
                    for k, v in state.items()}
            plain, _ = build(cfg, torch.float32, device, weights,
                             **({"quant": quant} if quant else {}))
            dropout_off(plain)
            batch = {k: v[:spg * dp] for k, v in whole.items()}
            with recorded_act_scales(plain) as scales:
                out = losses_and_grads(plain, batch, loss_cfg, norm,
                                       dp_size=dp)
            refs[(dp, quant, seed)] = (*out, scales)
        return refs[(dp, quant, seed)]

    def distance(a, b):  # loss_total's and the gradients' L2 distance
        return (abs(a[0]["loss_total"] - b[0]["loss_total"]),
                l2(a[1][n] - g for n, g in b[1].items()))

    for name, (mp, fsdp, sp, vis) in layouts(world).items():
        if only and name not in only:
            continue
        dp = world // mp
        quant = vis.get("quant")
        if rank == 0:
            unwrapped(dp, quant)
        dist.barrier()
        model, _ = build(cfg, torch.float32, device, state,
                         seq_parallel=sp, **vis)
        dropout_off(model)
        sharded = shard_model(model, create_mesh(mp, device.type),
                              fsdp=fsdp, fsdp_min_size=int(cfg.get(
                                  "fsdp_min_size", FSDP_MIN_SIZE)))
        r = sharded.dp_rank
        mine = {k: v[r * spg:(r + 1) * spg] for k, v in whole.items()}
        with recorded_act_scales(model) as scales:
            losses, grads = losses_and_grads(model, mine, loss_cfg, norm,
                                             sharded)
        if quant:
            every = [None] * world
            dist.all_gather_object(every, scales)
        if rank == 0 and quant:
            # QAT rounds every activation to its grid, so another order of
            # the float sums moves an element across a rounding boundary
            # now and then, and the model amplifies it: the scales are
            # held, the outputs' distance shown beside that noise
            want = unwrapped(dp, quant)
            n = len(want[2])
            n_lead = sum(bool(LEAD.search(nm)) for nm, _ in want[2])
            lead_err, scale_err = (max(scale_distance(r, want[2], lead)
                                       for r in every)
                                   for lead in (True, False))
            got = distance((losses, grads), want)
            drawn = [unwrapped(dp, quant, seed) for seed in NOISE_SEEDS]
            noise = [max(d) for d in zip(*(distance(u, want)
                                           for u in drawn))]
            noise_scale = [max(scale_distance(u[2], want[2], lead)
                               for u in drawn) for lead in (True, False)]
            ok = n_lead > 0 and lead_err <= LEAD_RTOL
            results[f"check_{name}"] = dict(
                lead_scale_rel_err=lead_err, scale_rel_err=scale_err,
                noise_scale_rel_err=noise_scale, scales=n,
                lead_scales=n_lead, loss_total_dist=got[0],
                grad_l2_dist=got[1], noise_dist=noise, ok=ok, dp=dp,
                model_parallel=mp)
            log(f"check[{name}]: {world} ranks (data {dp} x model {mp}), "
                f"float32, global batch {spg * dp}: each rank's {n_lead} "
                f"lead activation scales (the first layer's q/k/v inputs) "
                f"against the unwrapped {quant} model's, max relative error "
                f"{lead_err:.3e} (bound {LEAD_RTOL}); not bounded: all "
                f"{n} scales {scale_err:.3e}, loss_total and the "
                f"gradients' L2 distance from that model {got}; the "
                f"unwrapped model's own with its weights x (1 + {NOISE} "
                f"N(0, 1)) (the larger of {len(NOISE_SEEDS)} draws): lead "
                f"scales {noise_scale[0]:.3e}, all scales "
                f"{noise_scale[1]:.3e}, outputs {noise}; loss_total "
                f"{losses['loss_total']}")
        elif rank == 0:
            want_l, want_g, _ = unwrapped(dp, None)
            loss_err = max(abs(losses[k] - v) / max(abs(v), 1e-12)
                           for k, v in want_l.items())
            grad_err = max(((grads[n] - g).abs().max()
                            / g.abs().max().clamp(min=1e-30)).item()
                           for n, g in want_g.items())
            ok = loss_err <= LOSS_RTOL and grad_err <= GRAD_REL
            results[f"check_{name}"] = dict(
                loss_rel_err=loss_err, grad_rel_err=grad_err, ok=ok,
                dp=dp, model_parallel=mp)
            log(f"check[{name}]: {world} ranks (data {dp} x model {mp}), "
                f"float32, global batch {spg * dp}: loss terms max "
                f"relative error {loss_err:.3e} (bound {LOSS_RTOL}), "
                f"gradients max |dg| / max |g| {grad_err:.3e} (bound "
                f"{GRAD_REL}) against the unwrapped model; loss_total "
                f"{losses['loss_total']}")
        del model, sharded, grads
        if device.type == "cuda":
            torch.cuda.empty_cache()
    ok = [results.get(f"check_{n}", {}).get("ok", True)
          for n in layouts(world)]
    if world % 2 == 0:
        ok += check_serving(cfg, device, world, rank, results, state, only)
    flag = torch.tensor([float(all(ok))], device=device)
    dist.broadcast(flag, 0)
    return bool(flag.item()), state


def eval_outputs(model, batch, norm):
    """The model's eval outputs on ``batch``, float32."""
    import torch
    from simvg_tpu_torch.engine import normalize_images_on_device

    image = normalize_images_on_device(batch["image"], norm["mean"],
                                       norm["std"], True, batch["img_shape"])
    with torch.no_grad():
        out = model.eval()(image, batch["text_ids"],
                           batch["text_padding_mask"],
                           img_shape=batch["img_shape"])
    return {k: out[k].float() for k in ("class_decoder", "bbox_decoder",
                                        "class_token", "bbox_token")}


def check_serving(cfg, device, world, rank, results, state, only=None):
    """Part 1b: the serving levers under tensor parallelism (model axis 2,
    data world / 2), in float32, one global batch: each eval forward,
    gathered over the data axis, against the same model unwrapped on rank
    0 over the whole batch.  Token pruning (with sequence parallelism)
    within GRAD_REL of each output's max |value|; dynamic int8 (its scales
    over the whole batch) within INT8_SHARE of the unwrapped int8 model's
    mean distance from float32.  Returns each case's verdict (rank 0)."""
    import torch
    import torch.distributed as dist

    from simvg_tpu_torch.parallel import create_mesh, shard_model

    norm = dict(mean=cfg.img_norm_cfg["mean"], std=cfg.img_norm_cfg["std"],
                to_rgb=True)
    spg = cfg.data.samples_per_gpu
    whole = global_batch(cfg, spg * world, device)
    float32 = None
    verdicts = []
    for name, (sp, vis) in SERVING.items():
        if only and name not in only:
            continue
        vis = prune_settings(cfg) if vis == "prune" else vis
        mesh = create_mesh(2, device.type)
        dp = mesh["data"].size()
        batch = {k: v[:spg * dp] for k, v in whole.items()}
        if rank == 0:
            plain, _ = build(cfg, torch.float32, device, state, **vis)
            want = eval_outputs(plain, batch, norm)
            if "quant" in vis and float32 is None:
                base, _ = build(cfg, torch.float32, device, state)
                float32 = eval_outputs(base, batch, norm)
                del base
            del plain
        dist.barrier()
        model, _ = build(cfg, torch.float32, device, state,
                         seq_parallel=sp, **vis)
        sharded = shard_model(model.eval(), mesh)
        r = sharded.dp_rank
        got = eval_outputs(model, {k: v[r * spg:(r + 1) * spg]
                                   for k, v in batch.items()}, norm)
        for k, t in got.items():
            parts = [torch.empty_like(t) for _ in range(dp)]
            dist.all_gather(parts, t.contiguous(),
                            group=mesh["data"].get_group())
            got[k] = torch.cat(parts, dim=1)  # [layers, batch, ...]
        if rank == 0:
            if "quant" in vis:
                err = {k: (got[k] - w).abs().mean().item()
                       for k, w in want.items()}
                drift = {k: (w - float32[k]).abs().mean().item()
                         for k, w in want.items()}
                ok = all(err[k] <= INT8_SHARE * drift[k] for k in err)
                bound = f"{INT8_SHARE} x the int8 model's drift {drift}"
            else:
                err = {k: ((got[k] - w).abs().max()
                           / w.abs().max().clamp(min=1e-30)).item()
                       for k, w in want.items()}
                ok = all(e <= GRAD_REL for e in err.values())
                bound = f"{GRAD_REL} of max |value|"
            results[f"check_{name}"] = dict(err=err, ok=ok, dp=dp,
                                            model_parallel=2, vis=vis)
            log(f"check[{name}]: {world} ranks (data {dp} x model 2), "
                f"float32, eval on a global batch of {spg * dp}, {vis}: "
                f"distance from the unwrapped model {err} (bound {bound})")
            verdicts.append(ok)
        del model, sharded
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return verdicts


def time_steps(step, state, batch, device):
    """(sorted step ms, the state): 1 warm-up and STEPS timed steps."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    state, _ = step(state, batch, SEED)
    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    for _ in range(STEPS):
        sync()
        t0 = time.perf_counter()
        state, scalars = step(state, batch, SEED)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(scalars["loss_total"]):
            raise AssertionError(f"loss {scalars['loss_total']}")
    return sorted(times), state


def profiled_step(step, state, batch, device):
    """(the state, {wall_ms, busy_ms, compute_ms, nccl_ms, idle_share}) of
    one step under the profiler (an empty dict off the card)."""
    import torch

    if device.type != "cuda":
        return step(state, batch, SEED)[0], {}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from profile_train import busy_us

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch, SEED)
        torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events() if e.device_type == DeviceType.CUDA]

    def ms(pick):
        return busy_us([(a, b) for n, a, b in kernels if pick(n)]) / 1e3

    busy = ms(lambda n: True)
    return state, dict(wall_ms=wall, busy_ms=busy,
                       compute_ms=ms(lambda n: "nccl" not in n.lower()),
                       nccl_ms=ms(lambda n: "nccl" in n.lower()),
                       idle_share=1.0 - busy / wall)


def peak_gib(device):
    import torch

    return (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else 0.0)


def time_layouts(cfg, device, world, rank, results, state):
    """Part 2: the unwrapped model on rank 0 alone, then every layout on
    every rank, in the config's dtype and remat, on the weights
    ``state``."""
    import torch
    import torch.distributed as dist

    from chip_smoke import make_train_step_for
    from simvg_tpu_torch.ops.fused_attention import (attention_bwd,
                                                     fused_attention)
    from simvg_tpu_torch.parallel import FSDP_MIN_SIZE, create_mesh
    from simvg_tpu_torch.parallel import shard_model

    dtype = torch.bfloat16 if cfg.get("use_bf16", True) else torch.float32
    norm = dict(mean=cfg.img_norm_cfg["mean"], std=cfg.img_norm_cfg["std"],
                to_rgb=True)
    spg = cfg.data.samples_per_gpu
    whole = global_batch(cfg, spg * world, device)
    runs = [("unwrapped", None)] + list(layouts(world, timed=True).items())
    for name, lay in runs:
        if lay is None and rank != 0:
            dist.barrier()
            continue
        vis = {} if lay is None else dict(seq_parallel=lay[2])
        model, loss_cfg = build(cfg, dtype, device, state, **vis)
        sharded, r, dp = None, 0, 1
        if lay is not None:
            sharded = shard_model(model, create_mesh(lay[0], device.type),
                                  fsdp=lay[1], fsdp_min_size=int(cfg.get(
                                      "fsdp_min_size", FSDP_MIN_SIZE)))
            r, dp = sharded.dp_rank, sharded.dp
        mine = {k: v[r * spg:(r + 1) * spg] for k, v in whole.items()}
        step, tstate = make_train_step_for(cfg, model, loss_cfg, norm,
                                           sharded=sharded)
        fused_attention.launches = attention_bwd.launches = 0
        times, tstate = time_steps(step, tstate, mine, device)
        k1 = fused_attention.launches // (STEPS + 1)
        k2 = attention_bwd.launches // (STEPS + 1)
        peaks = [peak_gib(device)]
        tstate, prof = profiled_step(step, tstate, mine, device)
        if lay is not None:
            peaks = [None] * world
            dist.all_gather_object(peaks, peak_gib(device))
        median = times[len(times) // 2]
        if rank == 0:
            images = spg * dp
            results[f"time_{name}"] = dict(
                median_ms=median, min_ms=times[0], max_ms=times[-1],
                images_per_s=images / median * 1e3, global_batch=images,
                peak_gib=peaks, k1_a_step=k1, k2_a_step=k2, profile=prof)
            ranks = "1 rank" if lay is None else f"{world} ranks"
            log(f"time[{name}]: {ranks}, {dtype}, {spg} a rank: median "
                f"{median:.3f} ms/step (min {times[0]:.3f}, max "
                f"{times[-1]:.3f}), {images / median * 1e3:.2f} images/s of "
                f"{images}; peak GiB a rank {peaks}; K1 {k1}, K2 {k2} a step; "
                f"one profiled step on rank 0: {prof}")
        del model, sharded, step, tstate
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if lay is None:
            dist.barrier()


def cut_depth(cfg, num_layers):
    """The config's encoder cut to ``num_layers`` layers at its widths: the
    builder takes the widths of ``vit_type`` only when none of them is
    set, so all are set."""
    from simvg_tpu_torch.models.beit3 import BEiT3Config

    ve = cfg.model.vis_enc
    preset = getattr(BEiT3Config, ve.get("vit_type", "base"))()
    cfg.merge_from_dict({f"model.vis_enc.{k}": ve.get(k, getattr(preset, k))
                         for k in ("embed_dim", "num_heads", "ffn_dim")})
    cfg.merge_from_dict({"model.vis_enc.num_layers": num_layers})


def worker(rank, world, port, args, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    if args.device == "cpu":
        os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.parallel import init_distributed
    from simvg_tpu_torch.tools.train import disable_tf32

    disable_tf32()
    local_rank = init_distributed(args.device,
                                  timeout=datetime.timedelta(seconds=600))
    device = (torch.device("cuda", local_rank) if args.device == "cuda"
              else torch.device("cpu"))
    cfg = Config.fromfile(args.config)
    if args.num_layers:
        cut_depth(cfg, args.num_layers)
    results = {}
    try:
        ok, state = check_layouts(cfg, device, world, rank, results,
                                  args.only)
        if not ok:
            raise SystemExit("a layout differs from the unwrapped model")
        if not args.only:
            time_layouts(cfg, device, world, rank, results, state)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default=DEFAULT_CONFIG)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--ranks", type=int, default=None,
                   help="processes (default: every card)")
    p.add_argument("--num-layers", type=int, default=None,
                   help="the encoder's depth (default: the config's); "
                        "the widths stay the config's")
    p.add_argument("--only", nargs="+", default=None,
                   choices=("ddp", "fsdp", "tp_sp", "tp_sp_int8_qat",
                            *SERVING),
                   help="run these checks of part 1 alone, no timing")
    args = p.parse_args()
    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("dist_chips: no CUDA device", file=sys.stderr)
            return 1
        from chip_smoke import KERNELS, card_line
        from simvg_tpu_torch.ops import _build

        log(card_line())
        t0 = time.perf_counter()
        _build.build_all(KERNELS)
        log(f"built the kernels in {time.perf_counter() - t0:.1f} s")
    world = args.ranks or (torch.cuda.device_count()
                           if args.device == "cuda" else 2)
    if world < 2:
        print(f"dist_chips: {world} rank(s); it needs 2 or more",
              file=sys.stderr)
        return 1
    log(f"torch {torch.__version__}; {world} ranks on {args.device}; "
        f"{os.path.relpath(args.config, REPO)}"
        + (f", {args.num_layers} encoder layers" if args.num_layers else "")
        + (f"; checks {args.only} only" if args.only else ""))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:  # rank 0's readings
        out = os.path.join(tmp, "results.json")
        mp.spawn(worker, args=(world, port, args, out), nprocs=world,
                 join=True)
        with open(out) as f:
            results = json.load(f)
    log(f"dist_chips wall time {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "ranks": world, "device": args.device,
                      "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
