#!/usr/bin/env python3
"""GPU smoke run of simvg_tpu_torch, the PyTorch/CUDA port of simvg_tpu.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit:

    python3 chip_smoke.py

It builds every kernel of the port from ``simvg_tpu_torch/csrc/`` (one
nvcc each, in parallel) and holds each against its plain PyTorch version at
the main paths' shapes: K1, the attention forward, K2, its backward, and
the image kernels (PNG's unfiltering and conversion; the WebP, GIF, TIFF,
BMP, PNM, Sun raster and HDR decoders' pixel stages).
bf16 takes each kernel's tensor-core route, float32 its CUDA-core route.
Each K1/K2 row gives the kernel's time beside its plain version's, the
bound, the achieved TFLOP/s and share of the bound, and PyTorch's SDPA as
the yardstick: its forward for K1, its backward alone for K2 (and its
forward plus backward beside K1 + K2).  A K1 row's ``ms`` is CUDA events
around calls through the operator, which reads the host's dispatch where
that is longer than the kernel; its ``device_ms`` is the kernel's own time
a call (torch.profiler), ``host_ms`` the host's time a call with no
synchronise, and ``device_bound_share`` the bound over ``device_ms``.
The "K1 train" row is K1 as a train step calls it, writing the residual r of its output beside out and
lse (out + r held to the float32 output); each K2 row runs K2 twice on the
same inputs and requires the same bits, and gives the device time of its
three kernels (the row term D, dQ, dK/dV) from torch.profiler.  Then it
drives the two main paths of the flagship configuration
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

Then "headdim": the flagship's encoder as 24 heads of 32, 6 heads of
128, 3 heads of 256 and 2 heads of 384 (K1/K2's other instantiations and
the column-split route above 256; the K1/K2 rows hold them and the padded
head dims 48 and 160, in bf16 and float32): per head_dim an eval batch of
8 (12 K1 launches)
and a train step at batch 32 (12 K1, 12 K2), both held by the bf16 rules
below and timed beside plain attention.

A bf16 model with the kernels is held to the float32 model with plain
attention on the same weights and inputs, no further from it than
BF16_REF_FACTOR times the bf16 model with plain attention (a train step's
loss terms and gradients on the mean over TRAIN_DRAWS draws of the weights
times (1 + 1e-7 N(0, 1)), since one draw of the plain model can land on
float32 by chance), and every
attention call of those runs to float32 attention on the call's own inputs,
no further from it than CALL_FACTOR times the kernels' plain versions.
Then "options": the flagship with only_decoder=False (a 6-layer DetrEncoder
over the 400 patch tokens) and soft distillation, its eval forward at batch
8 and AdamW, SGD and RMSProp each for 1 + 3 train steps at batch 32, held
by the bf16 rule (outputs, every loss term with the soft distillation's,
the gradients, every K1/K2 call), each optimizer's update on the card, clip
on, against the CPU's (1e-6 of each tensor's max), the steps' medians and
peak memory, the DetrEncoder's forward ms and the soft route's host
Hungarian round trips.  Then the data path and the CLIs run on synthetic
JPEGs: the flagship's train CLI, test CLI and a resume; "masks": the
flagship with the multi-task pipeline (with_mask, SampleMaskVertices) on
annotations with a mask each, through the train and test CLIs, a loader
batch's mask meta against its samples, evaluate with pred_masks (the GT:
mask mIoU 100; shifted: the IoU computed in the phase), host ms per sample
with masks and without; the GRefCOCO config (grefcoco_onestage.py, 10
queries, F1/N-acc) through both CLIs, with a GRefCOCO batch held against
plain attention and the step's host Hungarian time; the Mixed pretraining
config (pretrain-cocoall.py, 512 px, S=277) through the train CLI.  Then
the serving entry points: the flagship pruned to keep 300 patches after layer
4 (K1 at S=321 after the prune point; held to float32 on the float32
model's kept indices; keep=400 against the unpruned model; latency pruned
and unpruned at batch 8 and 32), its serving forward through torch.export
(12 K1 nodes in the graph, outputs bit for bit those of eager, timed
against eager), the HTTP server on the CLI phase's det_best (a burst of
24 JPEG requests from 8 clients, each held to a direct eval step, then 23 s
of load from 8 closed-loop clients for latency and images/s), and the demo
and inference CLIs.  Then "png": the PNG kernel against the plain decoder
on streams of every colour type and bit depth, every filter, Adam7, and
at the unfilter kernel's edges (row groups, the cluster's slots, widths
of 1 and 2 units at every bytes-per-pixel, single filter types), bit for
bit; its time on 480 x 640 RGB images (every filter, all Paeth) beside
the host's inflate; the
flagship's val loader over the synthetic JPEGs rewritten as PNG (each
batch bit for bit the plain decoder's) and the server on det_best
answering PNG requests (each held to a direct eval step on the plain
decoder's pixels), the kernel's launches counted from 0 around both.  Then
"formats": the decoders of WebP (csrc/vp8.cu, vp8l.cu), GIF, TIFF, BMP,
PNM/PFM, Sun raster and HDR (csrc/image_convert.cu), with their host C++,
against the plain decoders and cv2's digests on the committed fixtures
(tests/fixtures/formats/), bit for bit, each lossy WebP also with its loop
filter forced to none and to the simple one; the VP8L and TIFF predictor
kernels on synthetic transforms and segments against their plain versions,
bit for bit, and TIFF's beside torch.cumsum; each kernel's time on a 480 x
640 image beside its host stage and the plain route; the val loader over a
WebP copy of the synthetic images and the server answering a request of
every format (JPEG 2000, AVIF and OpenEXR with 400), the kernels' launches
counted from 0 around both.  Then "int8" (ops/quant.py, w8a8 through
torch._int_mm): the flagship calibrated with tools/quantize_serving.py,
every _int_mm of a forward held to the float64 product of its operands,
the int8_static and dynamic int8 models held to the float32 model beside
the bf16 one, an fp32 int8_static forward on the card against the CPU,
eval medians of bf16, int8 and int8_static at batch 8 and 32, _int_mm
against bf16 F.linear at each shape, the test CLI and the server with
--quant-collection (each response held to a direct int8_static step), the
exported int8_static program bit for bit eager's, and int8_qat train steps.
Then "remat": configs/single/ViT-large/refcoco/refcoco_onestage.py as
written (ViT-large/32, 24 layers, batch 4, remat on) with remat off,
"full" and "dots": gradients with drop-path against remat off bit for bit,
K1/K2 a step, step time and peak memory.  Then "dist" (M16,
``parallel/mesh.py``) in 1-rank NCCL groups (a card holds one NCCL rank):
the flagship through the train CLI with ``--distributed`` (DDP; its first
loss against the non-distributed run's) and the test CLI with it on its
det_best (the metrics of the test CLI without it), and the fsdp8 config
through both (FSDP2; the test CLI's det_acc the train CLI's), while the
synthetic JPEGs are there; then configs/single/ViT-large/refcoco/
refcoco_onestage_fsdp8.py as written under FSDP2 on the remat phase's
weights: one batch's loss terms and gradients bit for bit the unwrapped
model's, held to float32 (the gradients and loss_total by the bf16 rule,
every K1/K2 call too), K1/K2 a step, step time and peak memory
beside the unwrapped model's, one NCCL all-reduce of evaluation
counters, and the flagship with int8_qat whose layers take their
activation max over the 1-rank group, bit for bit the single-process
step.  Before "remat", after the OneStage family ("onestage") and the
config-facing tools ("tools"), "zoo" takes the OneStage model with each
other pure-vision backbone at its JAX defaults (ResNet-50, CSPDarknet,
ViT-B/32, Swin-T, PVTv2, ViTDet-B/16) and with the ALBERTA language
encoder at roberta-base's widths (from an HF-layout state dict), then the
four mixed vision-language encoders alone: each float32 check at batch 2
held to the CPU's float64 (``hold_to_cpu_float64``), bf16 steps at batch 8
timed.
Then "legacy": the five BEiT-3 task heads at BEiT3-base widths (batch 8,
bf16, K1; the public BEiT-3 recipes' resolutions: ImageNet classification
at 224 px, VQAv2 at 480 px with 3129 answers and 32 question tokens,
NLVR2 at 224 px, COCO retrieval at 384 px, captioning at 480 px), each
forward held by the bf16 rule and every K1 call by the per-call rule, the
VQA head's loss gradients through K2 too, K1 counted (12, 12, 24, 24 and 0
for captioning, whose uni-directional mask takes the plain path, and its
8-step ``greedy_generate``), each forward timed; the SeqTR/MDETR
transformers at their JAX defaults over a [8, 20, 20, 1024] map, float32
on the card held to the CPU's float64 (``generate``'s ids too), and the
three legacy losses on the card against the CPU's; the flagship with
refcoco-unc_vgtr.py's VGTRAugment pipeline through the train CLI on the
synthetic JPEGs, the VGTR pixel ops on the card against the CPU's.
K1/K2 launches are counted from 0 around each path.

Every phase raises on failure; there is no CPU path.

Output: the card's name and power limit (nvidia-smi), one line per phase,
a ``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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
KERNELS = ("attention_fwd", "attention_bwd", "png", "image_convert", "vp8",
           "vp8l")
# the card's peaks (H100 SXM data sheet):
# dense bf16 on the tensor cores, fp32 outside them, and HBM bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
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
    (TRAIN_BATCH, 277, 12, 64, "bfloat16", 2e-2),  # Mixed at 512 px
    # token pruning at keep=300 after layer 4: 1 + 300 patches + 20 text
    (8, 321, 12, 64, "bfloat16", 2e-2),
    (TRAIN_BATCH, 321, 12, 64, "bfloat16", 2e-2),
    # the BEiT-3 task heads ("legacy"): vision-only at 224 and 384 px,
    # joint at 480 px with 32 text tokens, text-only (one partial K/V tile)
    (8, 197, 12, 64, "bfloat16", 2e-2),
    (8, 577, 12, 64, "bfloat16", 2e-2),
    (8, 933, 12, 64, "bfloat16", 2e-2),
    (8, 32, 12, 64, "bfloat16", 2e-2),
    # the other instantiations ("headdim"): the flagship's D = 768 as 24
    # heads of 32, 6 heads of 128, 3 heads of 256 and 2 heads of 384 (the
    # split route), and head dims with none (48, zero-padded to 64 by the
    # wrapper; 160, to 256)
    (TRAIN_BATCH, 421, 24, 32, "bfloat16", 2e-2),
    (8, 421, 24, 32, "bfloat16", 2e-2),
    (8, 421, 24, 32, "float32", 2e-5),
    (TRAIN_BATCH, 421, 6, 128, "bfloat16", 2e-2),
    (8, 421, 6, 128, "bfloat16", 2e-2),
    (8, 421, 6, 128, "float32", 2e-5),
    (8, 421, 16, 48, "bfloat16", 2e-2),
    (TRAIN_BATCH, 421, 3, 256, "bfloat16", 2e-2),
    (8, 421, 3, 256, "bfloat16", 2e-2),
    (2, 421, 3, 256, "float32", 2e-5),
    (TRAIN_BATCH, 421, 2, 384, "bfloat16", 2e-2),
    (8, 421, 2, 384, "bfloat16", 2e-2),
    (2, 421, 2, 384, "float32", 2e-5),
    (8, 421, 4, 160, "bfloat16", 2e-2),
]
# K1 as the train step calls it (with the residual r), at each instantiation
# and the padded head dims
K1_TRAIN_CHECKS = [(TRAIN_BATCH, 421, 12, 64), (TRAIN_BATCH, 421, 24, 32),
                   (TRAIN_BATCH, 421, 6, 128), (8, 421, 16, 48),
                   (TRAIN_BATCH, 421, 3, 256), (TRAIN_BATCH, 421, 2, 384),
                   (8, 421, 4, 160)]
# K2 vs its plain version.  float32: the gradient bounds of
# tests/test_pallas_attention.py.  bf16: 2e-2 of each gradient's max |value|,
# five bf16 steps: K2 sums its P and dP in another order, so a rounding of P
# or dS may land one bf16 step away from the plain version's; a wrong kernel
# is off by far more.
K2_CHECKS = [  # (batch, seq, heads, head_dim, dtype name)
    (TRAIN_BATCH, 421, 12, 64, "bfloat16"),  # the train step's call
    (8, 421, 12, 64, "bfloat16"),
    (8, 421, 12, 64, "float32"),
    (2, 1621, 16, 64, "bfloat16"),  # patch-16 sequence, large heads
    (TRAIN_BATCH, 277, 12, 64, "bfloat16"),  # Mixed at 512 px
    (8, 933, 12, 64, "bfloat16"),  # the VQA head's backward ("legacy")
    (TRAIN_BATCH, 421, 24, 32, "bfloat16"),  # "headdim", as K1's rows
    (8, 421, 24, 32, "float32"),
    (TRAIN_BATCH, 421, 6, 128, "bfloat16"),
    (8, 421, 6, 128, "float32"),
    (8, 421, 16, 48, "bfloat16"),
    (TRAIN_BATCH, 421, 3, 256, "bfloat16"),
    (2, 421, 3, 256, "float32"),
    (TRAIN_BATCH, 421, 2, 384, "bfloat16"),
    (2, 421, 2, 384, "float32"),
    (8, 421, 4, 160, "bfloat16"),
]
K2_FP32_ATOL, K2_FP32_RTOL = 3e-4, 1e-3
K2_BF16_REL = 2e-2
# bf16 model-level checks on the served weights, each held to the same
# model in float32 with plain attention on the same inputs: the bf16 model
# with K1/K2 may be at most BF16_REF_FACTOR times as far from it as the bf16
# model with plain attention, plus a floor for a plain model that lands on
# the float32 value by chance.  Two bf16 models differ from each other by
# their two roundings; a bound on that difference alone fails at weights
# whose activations are larger.  Readings on the H100 (PERF.md §6): the
# kernels' distance over plain's 0.81-1.29 on the outputs (3 batches),
# 0.2-1.5 on the loss terms (more only inside the floor), 0.2-1.25 on the
# gradients
BF16_REF_FACTOR = 2.0
OUT_FLOOR = 1e-3  # absolute, on logits and boxes
LOSS_FLOOR = 1e-3  # relative to the float32 loss term
GRAD_FLOOR = 1e-3  # relative to the float32 max|g| (max) or |g| (L2)
# The train step's loss terms and gradients: each distance from float32 is
# one draw of bf16 rounding, and one draw of the plain model can land on
# float32 by chance (the hd-384 flagship's loss_kd: plain 1.9e-4 on the
# weights as given, 1.9e-3 to 2.6e-3 on the same weights times (1 + 1e-7
# N(0, 1)), which float32 does not see, against the kernels' 1.3e-3 to
# 1.8e-3; PERF.md §6).  So the bound above is held on each
# distance's mean over TRAIN_DRAWS draws: the weights as given and
# TRAIN_DRAWS - 1 copies times (1 + WEIGHT_NOISE N(0, 1)), seeds 1, 2, ...
TRAIN_DRAWS = 3
WEIGHT_NOISE = 1e-7
# Every attention call of those bf16 runs, on its own inputs: the kernels'
# output, and the dq, dk, dv that the backward took from them, held to
# plain attention in float32 on the same bf16 inputs, in relative L2: at
# most CALL_FACTOR x the error of the kernels' plain versions (the same
# roundings of P and dS, in plain PyTorch) + CALL_FLOOR.  The model-level
# checks above hide a wrong kernel in bf16 noise (bf16_precision.py); these
# do not
CALL_FACTOR = 2.0
CALL_FLOOR = 1e-4
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


def host_ms(fn, iters: int) -> float:
    """The host's time a call of ``fn`` over ``iters`` calls with no
    synchronise between them: what enqueueing the work costs."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


# torch.profiler drops kernel records: most often a session's first few
# milliseconds of launches, however long the trace idled before them (on an
# H100: 3.5-5.5 ms, 5-10 calls of 20), sometimes others (more often with
# CPU activity on).  kernel_split_ms therefore calls ``fn`` for
# PROFILE_WARM_S before the calls it reads, keeps the trace as long idle
# after them, and reads the last launches of the session
PROFILE_WARM_S = 0.05


def kernel_split_ms(fn, iters, groups, launches):
    """Device ms a call of each group of kernels, from torch.profiler:
    ``groups`` maps a label to a kernel-name substring; ``launches`` is
    the kernels of all the groups together that one call of ``fn``
    launches.  A session calls ``fn`` for PROFILE_WARM_S, then ``iters``
    times, and reads its last ``launches`` x ``iters`` launches of the
    groups, one call's worth each.  A session with fewer launches, or
    whose last ones are not a whole number of calls of each group (a
    lost record among them), is repeated once, the repeat logged; then
    its groups read None, as does a group with no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    want = launches * iters
    for attempt in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            while time.perf_counter() - t0 < PROFILE_WARM_S:
                fn()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_WARM_S)
        found = sorted(
            ((e.time_range.start, e.time_range.end - e.time_range.start,
              label) for e in prof.events()
             if e.device_type == DeviceType.CUDA
             for label in [next((k for k, key in groups.items()
                                 if key in e.name), None)]
             if label is not None))
        us = dict.fromkeys(groups, 0.0)
        seen = dict.fromkeys(groups, 0)
        for _, dur, label in found[-want:]:
            us[label] += dur
            seen[label] += 1
        lost = [k for k, n in seen.items() if n % iters]
        if len(found) < want:
            lost = list(groups)
        if not lost:
            break
        log(f"profiler: {seen} of the last {want} launches of {groups} "
            f"({len(found)} in the session), {launches} a call expected "
            f"(session {attempt + 1} of 2)")
    return {label: (t / 1e3 / iters if t and label not in lost else None)
            for label, t in us.items()}


def sdpa_args(q, k, v, pad):
    """q/k/v as [B, H, S, hd] views and the keep-mask for PyTorch's
    scaled_dot_product_attention, timed as the library yardstick only."""
    keep = ~pad[:, None, None, :]
    return [t.transpose(1, 2) for t in (q, k, v)], keep


def sdpa_backend(q, k, v, mask):
    """The route PyTorch's SDPA dispatcher takes for these arguments (the
    yardstick's: at a head dim above what flash and memory-efficient
    attention take it falls back to the math route), by name."""
    import torch
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, mask, 0.0, False,
                                              scale=1.0)).name


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


def k1_times(kern, bms):
    """K1's device ms a call (its kernel alone, torch.profiler), the host's
    ms a call and the bound over the device ms; call in inference mode.  A
    profiler window that reports no device events is taken again, up to
    three times."""
    dev = None
    for _ in range(3):
        dev = kernel_split_ms(kern, 20, {"k1": "attention_fwd"}, 1)["k1"]
        if dev is not None:
            break
    return dict(device_ms=dev, host_ms=host_ms(kern, 20),
                device_bound_share=bms / dev if dev else None)


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
        # the entry point the model calls, operator dispatch included, in
        # inference mode as the serving paths call it
        kern = lambda: fused_attention(q, k, v, pad)  # noqa: E731
        plain = lambda: fused_attention_reference(q, k, v, pad)  # noqa: E731
        (qt, kt, vt), keep = sdpa_args(q, k, v, pad)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=keep, scale=1.0)
        with torch.inference_mode():
            for fn in (kern, plain, library):
                fn()  # warm-up
            # in turns: plain, kernel, kernel, plain
            p1, k1, k2, p2 = (cuda_ms(fn, 20)
                              for fn in (plain, kern, kern, plain))
            lib_ms = cuda_ms(library, 20)
            # q, k, v read, out and the fp32 row LSE written, the mask read
            nbytes = 4 * q.numel() * q.element_size() + 4 * b * h * s \
                + pad.numel()
            flops = 4 * b * h * s * s * hd
            bms, by = bound_ms(nbytes, flops, dname)
            times = k1_times(kern, bms)
        row = rates(dict(shape=[b, s, h, hd], dtype=dname, max_abs_err=err,
                         bound=bound, ms=(k1 + k2) / 2,
                         plain_ms=(p1 + p2) / 2, library_ms=lib_ms,
                         sdpa_route=sdpa_backend(qt, kt, vt, keep),
                         bound_ms=bms, bound_by=by, **times), flops)
        log(f"K1 {row} (library_ms: SDPA forward; device_ms: the kernel's "
            f"device time a call) [{card}]")
        rows.append(row)
    rows += [check_k1_train(gen, card, *shape) for shape in K1_TRAIN_CHECKS]
    return rows


# K1 with the residual r, at the train step's call: out + r (the fp32 output
# before its rounding, to ~2^-17) at least this many times closer to the
# float32 output than out alone, which is off by its bf16 rounding
K1_RESID_GAIN = 8.0


def check_k1_train(gen, card, b, s, h, hd):
    """K1 as the train step calls it (bf16, a gradient wanted: the operator
    with grad=True writes the residual r beside out and lse), at (b, s, h,
    hd): out against fused_attention_reference, out + r against the
    float32 output, timed beside attention_residual_reference and SDPA's
    forward with a graph; returns the row."""
    import torch
    import torch.nn.functional as F
    from simvg_tpu_torch.ops.fused_attention import (
        attention_residual_reference, fused_attention_reference)

    q, k, v, pad = text_padded_qkv(b, s, h, hd, torch.bfloat16, gen)
    op = torch.ops.simvg.attention_fwd
    out, lse, resid = op(q, k, v, pad, True)
    out_serve = op(q, k, v, pad, False)[0]
    torch.cuda.synchronize()
    ref = fused_attention_reference(q, k, v, pad)
    err = (out.float() - ref.float()).abs().max().item()
    o32 = fused_attention_reference(q.float(), k.float(), v.float(), pad)
    e_out = (out.float() - o32).abs().max().item()
    e_sum = (out.float() + resid.float() - o32).abs().max().item()
    if not (resid.shape == q.shape and torch.isfinite(resid).all()
            and err <= 2e-2 and torch.equal(out, out_serve)
            and e_sum * K1_RESID_GAIN <= e_out):
        raise AssertionError(
            f"K1 with the residual at {(b, s, h, hd)}: max_abs_err {err} "
            f"(bound 2e-2), out equal to the serving route's "
            f"{torch.equal(out, out_serve)}, out + r {e_sum} from float32 "
            f"against out's {e_out} (bound 1/{K1_RESID_GAIN} of it)")
    kern = lambda: op(q, k, v, pad, True)  # noqa: E731
    plain = lambda: attention_residual_reference(q, k, v, pad)  # noqa: E731
    (qt, kt, vt), keep = sdpa_args(q, k, v, pad)
    leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        *leaves, attn_mask=keep, scale=1.0)
    # q, k, v read; out, r, the fp32 row LSE written; the mask read; three
    # products a key tile (S, round(P) V, round(P - round(P)) V)
    nbytes = 5 * q.numel() * q.element_size() + 4 * b * h * s + pad.numel()
    flops = 6 * b * h * s * s * hd
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    # in inference mode, as the serving rows: without it the operator's
    # autograd dispatch takes longer on the host than the kernel on the card
    with torch.inference_mode():
        for fn in (kern, plain):
            fn()  # warm-up
        p1, k1, k2, p2 = (cuda_ms(fn, 20) for fn in (plain, kern, kern, plain))
        times = k1_times(kern, bms)
    library()
    lib_ms = cuda_ms(library, 20)
    row = rates(dict(shape=[b, s, h, hd], dtype="bfloat16", route_use="train",
                     max_abs_err=err, bound=2e-2, out_err_fp32=e_out,
                     out_plus_r_err_fp32=e_sum, ms=(k1 + k2) / 2,
                     plain_ms=(p1 + p2) / 2, library_ms=lib_ms,
                     sdpa_route=sdpa_backend(*leaves, keep), bound_ms=bms,
                     bound_by=by, **times), flops)
    log(f"K1 train {row} (with the residual r; plain: "
        f"attention_residual_reference; library_ms: SDPA forward with a "
        f"graph) [{card}]")
    return row


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
        out, lse, resid = attention_fwd(q, k, v, pad, grad=True)
        grads = attention_bwd(q, k, v, out, dout, lse, resid, pad)
        again = attention_bwd(q, k, v, out, dout, lse, resid, pad)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(grads, again)):
            raise AssertionError(f"K2 at {(b, s, h, hd)} {dname}: two calls "
                                 "on the same inputs differ")
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
        kern = lambda: attention_bwd(  # noqa: E731
            q, k, v, out, dout, lse, resid, pad)
        plain = lambda: fused_attention_bwd_reference(  # noqa: E731
            q, k, v, dout, pad)
        fwd = lambda: attention_fwd(q, k, v, pad, grad=True)  # noqa: E731
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
        split = kernel_split_ms(kern, 10, {"d_ms": "dsum_kernel",
                                           "dq_ms": "dq_", "dkdv_ms": "dkdv_"},
                                3)
        split["device_ms"] = sum(split.values()) \
            if None not in split.values() else None
        # read q, k, v, out, dO, lse and the mask; write dq, dk, dv (the
        # bf16 route also reads the residual r: the design's cost, not
        # counted)
        nbytes = 8 * q.numel() * q.element_size() + lse.numel() * 4 \
            + pad.numel()
        flops = 10 * b * h * s * s * hd
        bms, by = bound_ms(nbytes, flops, dname)
        row = rates(dict(shape=[b, s, h, hd], dtype=dname, max_abs_err=errs,
                         err_over_max_grad=rels, ms=(k1 + k2) / 2,
                         plain_ms=(p1 + p2) / 2, library_ms=lib_ms,
                         sdpa_route=sdpa_backend(*leaves, keep),
                         bound_ms=bms, bound_by=by,
                         library_fwd_bwd_ms=lib_fb_ms,
                         k1_plus_k2_ms=fwd_ms + (k1 + k2) / 2,
                         bit_equal_calls=True, **split), flops)
        log(f"K2 {row} (library_ms: SDPA backward alone; library_fwd_bwd_ms: "
            f"SDPA forward + backward, beside k1_plus_k2_ms (K1 with the "
            f"residual); d_ms, dq_ms, dkdv_ms: the three kernels' device "
            f"time a call, torch.profiler; device_ms their sum) [{card}]")
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


def build_flagship(cfg, attn_impl, dtype, state_dict=None, **vis):
    """The flagship at full width on the card: random weights from SEED,
    or ``state_dict``; ``vis``: more vis_enc settings (token pruning)."""
    import torch
    from simvg_tpu_torch.models import build_model, init_random_weights

    model_cfg = copy.deepcopy(dict(cfg.model))
    model_cfg["vis_enc"] = dict(model_cfg["vis_enc"], attn_impl=attn_impl,
                                **vis)
    model, loss_cfg = build_model(model_cfg, img_size=cfg.img_size,
                                  dtype=dtype, device="meta")
    model = model.to_empty(device="cuda")
    if state_dict is None:
        init_random_weights(model, SEED)
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


def outputs(model, args, img_shape):
    """The model's class/box outputs on one batch, in float32; raises on a
    wrong shape or a non-finite value."""
    import torch

    with torch.inference_mode():
        out = model(*args, img_shape=img_shape)
    for k, shape in OUT_SHAPES.items():
        if tuple(out[k].shape) != shape or not torch.isfinite(out[k]).all():
            raise AssertionError(f"{k}: shape {tuple(out[k].shape)} or "
                                 "non-finite values")
    return {k: out[k].float() for k in OUT_SHAPES}


def max_diffs(a, b):
    return {k: (a[k] - b[k]).abs().max().item() for k in a}


def compare_with_plain(cfg, model, loader, norm):
    """The served weights with attn_impl="xla" in bf16 and in float32, on
    every request batch: each bf16 class/box output of the K1 model within
    BF16_REF_FACTOR x the bf16 plain model's distance from the float32
    plain model (+ OUT_FLOOR), max over the batches, and every K1 call of
    the bf16 model on its own inputs (``hold_calls_against_fp32``); float32
    encoder features with K1 within FEATURE_BOUND_FP32 of plain.  Returns
    the bf16 plain-attention model."""
    import torch
    from simvg_tpu_torch.engine import normalize_images_on_device

    state = model.state_dict()
    plain, _ = build_flagship(cfg, "xla", torch.bfloat16, state)
    ref32, _ = build_flagship(cfg, "xla", torch.float32, state)
    k1_32, _ = build_flagship(cfg, "pallas", torch.float32, state)
    err = {"K1": {}, "plain": {}, "K1 vs plain": {}}
    feat_err, calls = 0.0, []
    for batch in loader:
        dev = to_device(batch)
        image = normalize_images_on_device(dev["image"], norm["mean"],
                                           norm["std"], True,
                                           dev["img_shape"])
        args = (image, dev["text_ids"], dev["text_padding_mask"])
        ref = outputs(ref32, args, dev["img_shape"])
        with recorded_attention() as new_calls:
            out = {"K1": outputs(model, args, dev["img_shape"])}
        calls += new_calls
        out["plain"] = outputs(plain, args, dev["img_shape"])
        for name, diffs in (("K1", max_diffs(out["K1"], ref)),
                            ("plain", max_diffs(out["plain"], ref)),
                            ("K1 vs plain", max_diffs(*out.values()))):
            for k, d in diffs.items():
                err[name][k] = max(err[name].get(k, 0.0), d)
        with torch.inference_mode():
            feats = [m.vis_enc["beit3"](*args) for m in (k1_32, ref32)]
        feat_err = max([feat_err] + [(a - b).abs().max().item()
                                     for a, b in zip(*feats)])
    del ref32, k1_32
    log(f"bf16 serve outputs on the served weights, {len(loader)} batches, "
        f"max abs distance from the float32 plain model: with K1 "
        f"{err['K1']}, with plain attention {err['plain']} (bound "
        f"{BF16_REF_FACTOR} x plain + {OUT_FLOOR}); K1 vs plain "
        f"{err['K1 vs plain']}")
    bad = [k for k in err["K1"]
           if not err["K1"][k] <= BF16_REF_FACTOR * err["plain"][k]
           + OUT_FLOOR]
    if bad:
        raise AssertionError(f"bf16 outputs {bad} with K1 are further from "
                             "float32 than the bound")
    hold_calls_against_fp32("serve", calls)
    log(f"float32, K1 vs plain attention: encoder features max abs diff "
        f"{feat_err} (bound {FEATURE_BOUND_FP32})")
    if not feat_err <= FEATURE_BOUND_FP32:
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


def serve_flagship(card, cfg=None, n_batches=N_BATCHES, name="flagship"):
    """The serve path at full width: ``n_batches`` batches of BATCH
    requests through evaluate after a warm-up, K1 launches counted; then
    the outputs and every K1 call held against plain attention, and the
    eval step timed with each.  ``cfg``: the flagship's by default.
    Returns the K1 launches."""
    import numpy as np
    import torch
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.engine import make_eval_step

    cfg = cfg or Config.fromfile(FLAGSHIP)
    model, loss_cfg = build_flagship(cfg, "pallas", torch.bfloat16)
    enc = model.cfg.beit3
    log(f"{name}: {enc.num_layers} layers, D={enc.embed_dim}, "
        f"{enc.num_heads} heads, S={enc.seq_vision + cfg.max_token}, "
        f"attn_impl={enc.attn_impl}, "
        f"{sum(p.numel() for p in model.parameters())} params (random, "
        f"seed {SEED}; pretrain {loss_cfg['pretrain']!r} not loaded), bf16")
    norm = dict(mean=cfg.img_norm_cfg["mean"], std=cfg.img_norm_cfg["std"],
                to_rgb=True)
    loader = make_requests(np.random.default_rng(SEED), n_batches, BATCH,
                           enc.vocab_size, cfg.max_token, cfg.img_size)

    launches, times, metrics = serve(model, loader, norm)
    want = enc.num_layers * n_batches
    if launches != want:
        raise AssertionError(f"{name}: K1 launched {launches} times on the "
                             f"main path, expected {want}")
    if metrics["n_samples"] != n_batches * BATCH:
        raise AssertionError(f"evaluate counted {metrics['n_samples']}")
    log(f"{name}: served {n_batches}x{BATCH} requests: K1 launches "
        f"{launches}; "
        f"per-batch ms through evaluate {times} [{card}]; decoder Prec@0.5 "
        f"{metrics['decoder_det_acc']:.2f}, token Prec@0.5 "
        f"{metrics['token_det_acc']:.2f} (random weights: shows the "
        f"pipeline only)")

    plain = compare_with_plain(cfg, model, loader, norm)
    lat = time_eval({"xla": make_eval_step(plain, device_norm=norm),
                     "pallas": make_eval_step(model, device_norm=norm)},
                    loader)
    for impl, ts in lat.items():
        ms = ts[len(ts) // 2]
        log(f"{name}: eval forward, batch {BATCH}, bf16, attn_impl={impl}: "
            f"median "
            f"{ms:.3f} ms/batch ({BATCH / ms * 1e3:.1f} images/s), min "
            f"{ts[0]:.3f}, max {ts[-1]:.3f}, {len(ts)} batches [{card}]")
    return launches


TRAIN_KEYS = ("image", "text_ids", "text_padding_mask", "img_shape",
              "gt_boxes", "gt_labels", "gt_valid")


def make_train_step_for(cfg, model, loss_cfg, norm, **step_kw):
    """The config's optimizer and a train step over ``model`` (``step_kw``
    to ``make_train_step``); returns (train_step, state)."""
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
        scheduler_kw=dict(sch), amsgrad=opt.get("amsgrad", True),
        weight_decay=opt.get("weight_decay", 0.0))
    ema = bool(cfg.get("ema", False))
    step = make_train_step(
        model, optimizer, branch_loss_weight=loss_cfg["branch_loss_weight"],
        prepare_target_mode=loss_cfg["prepare_target_mode"],
        distill_type=loss_cfg["distill_type"],
        mlp_aux_loss=loss_cfg["mlp_aux_loss"],
        ema_alpha=cfg.get("ema_alpha", 0.999) if ema else None,
        device_norm=norm, **step_kw)
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


def losses_and_grads(model, batch, loss_cfg, norm, sharded=None,
                     dp_size=1):
    """One train-mode forward and backward, as the train step takes it:
    returns ({loss term: float}, {param name: fp32 grad}).  ``norm``: the
    uint8 image's normalisation, None for an image the loader normalised.
    ``sharded``: ``model``'s layout on a mesh (``shard_model``), whose
    module runs the forward on this rank's shard of the batch; the loss
    terms and the gradients come back whole, the global batch's.
    ``dp_size``: the criterion's, for a model that is not laid out."""
    import torch
    from simvg_tpu_torch.engine import normalize_images_on_device
    from simvg_tpu_torch.engine.train import global_scalars, train_losses
    from simvg_tpu_torch.parallel import full_tensor, local

    image = batch["image"] if norm is None else normalize_images_on_device(
        batch["image"], norm["mean"], norm["std"], True, batch["img_shape"])
    kw = (dict(dp_size=dp_size) if sharded is None else
          dict(dp_size=sharded.dp, batch_sum=sharded.batch_sum))
    losses, _ = train_losses(
        model if sharded is None else sharded.module, batch, image,
        branch_loss_weight=loss_cfg["branch_loss_weight"],
        prepare_target_mode=loss_cfg["prepare_target_mode"],
        distill_type=loss_cfg["distill_type"],
        mlp_aux_loss=loss_cfg["mlp_aux_loss"], **kw)
    names, params = zip(*model.named_parameters())
    if sharded is None:
        grads = torch.autograd.grad(losses["loss_total"], params,
                                    allow_unused=True)
    else:
        (losses["loss_total"] * sharded.dp).backward()
        sharded.sync_grads(params)
        grads = [None if p.grad is None else full_tensor(local(p.grad), p)
                 for p in params]
        losses = global_scalars({k: v.detach() for k, v in losses.items()},
                                sharded.batch_sum, sharded.dp)
    return ({k: v.item() for k, v in losses.items()},
            {n: (torch.zeros_like(p) if g is None else g).float()
             for n, p, g in zip(names, params, grads)})


def train_flagship(card, cfg=None, steps=TRAIN_STEPS, name="flagship"):
    """The train path at full width: ``steps`` steps of TRAIN_BATCH after
    a warm-up, K1/K2 launches counted; then kernel vs plain attention on
    loss terms and gradients, and the step timed with each.  ``cfg``: the
    flagship's by default.  Returns (K1 launches, K2 launches, the K1
    step's median ms)."""
    import numpy as np
    import torch
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.ops.fused_attention import (attention_bwd,
                                                     fused_attention)
    from simvg_tpu_torch.ops.hungarian import hungarian_assign

    cfg = cfg or Config.fromfile(FLAGSHIP)
    model, loss_cfg = build_flagship(cfg, "pallas", torch.bfloat16)
    enc = model.cfg.beit3
    norm = dict(mean=cfg.img_norm_cfg["mean"], std=cfg.img_norm_cfg["std"],
                to_rgb=True)
    batches = [to_device(b, TRAIN_KEYS) for b in make_requests(
        np.random.default_rng(SEED + 1), steps + 1, TRAIN_BATCH,
        enc.vocab_size, cfg.max_token, cfg.img_size)]
    step, state = make_train_step_for(cfg, model, loss_cfg, norm)
    log(f"train: {name} at full width, batch {TRAIN_BATCH}, bf16 compute, "
        f"fp32 params, drop-path {enc.drop_path_rate}, head dropout "
        f"{model.head.cfg.attn_dropout}; lr {cfg.lr}, "
        f"{cfg.optimizer_config['type']} amsgrad="
        f"{cfg.optimizer_config['amsgrad']}, clip {cfg.grad_norm_clip}")

    state, _ = step(state, batches[0], SEED)  # warm-up
    torch.cuda.synchronize()
    fused_attention.launches = attention_bwd.launches = 0
    hungarian_assign.round_trips = 0
    history = []
    with timed_hungarian() as calls:
        for batch in batches[1:]:
            state, scalars = step(state, batch, SEED)
            history.append(scalars)
    torch.cuda.synchronize()
    k1, k2 = fused_attention.launches, attention_bwd.launches
    trips = hungarian_assign.round_trips / steps
    want = enc.num_layers * steps
    if (k1, k2) != (want, want):
        raise AssertionError(f"{name}: train path launched K1 {k1} and K2 "
                             f"{k2} times, expected {want} each")
    values = {k: torch.stack([h[k] for h in history]).float().cpu()
              for k in history[0]}
    bad = sorted(k for k, v in values.items() if not torch.isfinite(v).all())
    if bad or "grad_norm" not in values:
        raise AssertionError(f"non-finite train scalars: {bad}")
    log(f"{name}: trained {steps} steps of {TRAIN_BATCH}: K1 launches "
        f"{k1}, K2 launches {k2}, Hungarian host round trips per step "
        f"{trips}, host ms per step {sum(ms for ms, _ in calls) / steps:.2f} "
        f"[{card}]; "
        f"loss_total {values['loss_total'].tolist()}, grad_norm "
        f"{values['grad_norm'].tolist()}")

    plain, _ = build_flagship(cfg, "xla", torch.bfloat16, model.state_dict())
    plain_step, plain_state = make_train_step_for(cfg, plain, loss_cfg, norm)
    timing = time_train({"xla": (plain_step, plain_state),
                         "pallas": (step, state)}, batches)
    step_ms = {}
    for impl, (ts, peak) in timing.items():
        ms = step_ms[impl] = ts[len(ts) // 2]
        log(f"{name}: train step, batch {TRAIN_BATCH}, bf16, "
            f"attn_impl={impl}: "
            f"median {ms:.3f} ms/step ({TRAIN_BATCH / ms * 1e3:.1f} images/s), "
            f"min {ts[0]:.3f}, max {ts[-1]:.3f}, {len(ts)} steps; "
            f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; host round "
            f"trips per step {trips} [{card}]")

    hold_train_against_plain(name, cfg, model.state_dict(), batches[1],
                             loss_cfg, norm)
    return k1, k2, step_ms["pallas"]


# "headdim": the flagship's encoder at D = 768, FFN 3072, as 24 heads of
# 32, 6 heads of 128, 3 heads of 256 and 2 heads of 384 (BEiT3Config's
# width override, which both builders take), so that K1 and K2 run their
# other instantiations and the split route on a main path: head_dim ->
# heads.  Depth cut to HEADDIM_LAYERS of the flagship's 12 for the
# script's time; the widths are the flagship's.
HEADDIM_HEADS = {32: 24, 128: 6, 256: 3, 384: 2}
HEADDIM_LAYERS = 6


def headdim_config(hd, heads):
    """The flagship's config with its encoder at ``heads`` heads of
    ``hd``; raises when the model it builds has another shape."""
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.models import build_model

    cfg = Config.fromfile(FLAGSHIP)
    cfg.merge_from_dict({f"model.vis_enc.{k}": v for k, v in dict(
        embed_dim=768, num_heads=heads, ffn_dim=3072,
        num_layers=HEADDIM_LAYERS).items()})
    enc = build_model(copy.deepcopy(dict(cfg.model)), img_size=cfg.img_size,
                      device="meta")[0].cfg.beit3
    if (enc.embed_dim // enc.num_heads, enc.num_layers) != (hd,
                                                            HEADDIM_LAYERS):
        raise AssertionError(f"headdim: built {enc.num_heads} heads of "
                             f"{enc.embed_dim // enc.num_heads}")
    return cfg


def headdim_phase(card):
    """For each head_dim of HEADDIM_HEADS, the serve and train paths
    (``serve_flagship``, ``train_flagship``) on the flagship with that
    encoder at HEADDIM_LAYERS layers, bf16, attn_impl="pallas": one batch
    of BATCH requests (a K1 launch a layer) and one train step of
    TRAIN_BATCH (a K1 and a K2 launch a layer), each after a warm-up,
    held by the bf16 rule and the per-call rule and timed beside plain
    attention.  Returns {head_dim:
    (K1 launches, K2 launches)} of the counted runs."""
    out = {}
    for hd, heads in HEADDIM_HEADS.items():
        cfg = headdim_config(hd, heads)
        name = f"headdim {hd} ({heads} heads x {hd})"
        k1_eval = serve_flagship(card, cfg, n_batches=1, name=name)
        k1, k2, _ = train_flagship(card, cfg, steps=1, name=name)
        out[hd] = (k1_eval + k1, k2)
    return out


def train_distances(cfg, state, batch, loss_cfg, norm):
    """One draw of ``hold_train_against_plain``: the K1/K2 and plain bf16
    models' distances from the float32 plain model on the weights
    ``state``; returns ({label: {metric: distance}}, the K1/K2 vs plain
    max|dg| / max|g32|, the targets each bf16 model's own matching moves,
    the K1/K2 run's attention calls)."""
    import torch

    runs, flips, matching, calls = {}, {}, [], []
    for label, impl, dtype in (("fp32 plain", "xla", torch.float32),
                               ("K1/K2", "pallas", torch.bfloat16),
                               ("plain", "xla", torch.bfloat16)):
        model = build_flagship(cfg, impl, dtype, state)[0]
        dropout_off(model)
        with fixed_matching(matching) as moved, \
                recorded_attention() as new_calls, \
                recorded_soft_terms() as soft:
            runs[label] = losses_and_grads(model, batch, loss_cfg, norm)
        runs[label][0].update(soft)
        calls += new_calls
        if dtype == torch.bfloat16:
            flips[label] = moved
        del model
    losses32, grads32 = runs.pop("fp32 plain")
    gmax = max(g.abs().max().item() for g in grads32.values())
    gnorm = l2(grads32.values())
    dist = {}
    for label, (losses, grads) in runs.items():
        dist[label] = dict(
            {k: abs(losses[k] - v) / max(abs(v), 1e-12)
             for k, v in losses32.items()},
            grad_max=max((grads[n] - g).abs().max().item()
                         for n, g in grads32.items()) / gmax,
            grad_l2=l2(grads[n] - g for n, g in grads32.items()) / gnorm)
    (_, grads_k), (_, grads_p) = runs.values()
    direct = max((grads_k[n] - g).abs().max().item()
                 for n, g in grads_p.items()) / gmax
    return dist, direct, flips, calls


def perturbed(state, seed):
    """``state``'s floating tensors times (1 + WEIGHT_NOISE N(0, 1)), the
    noise drawn on the CPU from ``seed``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return {k: v * (1 + WEIGHT_NOISE * torch.randn(
                v.shape, generator=gen).to(v.device))
            if v.is_floating_point() else v for k, v in state.items()}


def hold_train_against_plain(name, cfg, state, batch, loss_cfg, norm):
    """Loss terms and gradients of one batch on the weights ``state``,
    dropout off, with K1/K2 in bf16 and with plain attention in bf16, each
    held to plain attention in float32 (``train_distances``) over
    TRAIN_DRAWS draws of the weights: the kernels' mean distance from it
    at most BF16_REF_FACTOR x plain's mean, plus LOSS_FLOOR or GRAD_FLOOR,
    for each loss term, the gradients' max |difference| and their relative
    L2 distance.  Every model takes the float32 model's Hungarian
    matching, so that a near-tie that flips under bf16 rounding does not
    move a target to another query; how many each bf16 model's own
    matching moves is printed.  Then every attention call of the K1/K2 run
    on the weights as given, on its own inputs
    (``hold_calls_against_fp32``)."""
    draws = [train_distances(cfg, state if seed == 0
                             else perturbed(state, seed), batch, loss_cfg,
                             norm) for seed in range(TRAIN_DRAWS)]
    dist = {label: {k: sum(d[0][label][k] for d in draws) / len(draws)
                    for k in draws[0][0][label]}
            for label in draws[0][0]}
    for seed, (d, direct, flips, _) in enumerate(draws):
        log(f"bf16 train[{name}] draw {seed} (weights x (1 + "
            f"{WEIGHT_NOISE if seed else 0} N(0, 1))), one batch, dropout "
            f"off, the float32 model's matching (targets each bf16 model's "
            f"own matching moves: {flips}): distance from the float32 plain "
            f"model, relative, with K1/K2 {d['K1/K2']}, with plain "
            f"attention {d['plain']}; K1/K2 vs plain max|dg| / max|g32| "
            f"{direct}")
    log(f"bf16 train[{name}] on the served weights, mean over "
        f"{len(draws)} draws: with K1/K2 {dist['K1/K2']}, with plain "
        f"attention {dist['plain']} (bound {BF16_REF_FACTOR} x plain + "
        f"{LOSS_FLOOR} or {GRAD_FLOOR})")
    calls = draws[0][3]
    bad = [k for k, v in dist["K1/K2"].items()
           if not v <= BF16_REF_FACTOR * dist["plain"][k]
           + (GRAD_FLOOR if k.startswith("grad") else LOSS_FLOOR)]
    if bad:
        raise AssertionError(f"the {name} train step with K1/K2 is further "
                             f"from float32 than the bound in {bad}")
    hold_calls_against_fp32(f"train[{name}]", calls)


def hold_sharded_against_unwrapped(name, cfg, state, batch, loss_cfg, norm,
                                   wrap):
    """Loss terms and gradients of one batch on the weights ``state``,
    dropout off, every model on the float32 model's Hungarian matching:
    the model laid out by ``wrap`` (which returns its ``shard_model``
    layout) against the same bf16 K1/K2 model unwrapped, bit for bit (a
    1-rank layout copies, it does not change the arithmetic); every K1/K2
    call of the laid-out run against float32 attention on its own inputs
    (``hold_calls_against_fp32``); and its distance from the float32 plain
    model beside the bf16 plain model's: the gradients' (max |difference|,
    relative L2) and loss_total's within BF16_REF_FACTOR x plain's + the
    floors, the other loss terms printed (a term that is a mean over a
    batch of 4, as the distillation weight, moves between seeds by more
    than that factor in both bf16 models)."""
    import torch

    runs, matching, calls = {}, [], []
    for label, impl, dtype in (("fp32 plain", "xla", torch.float32),
                               ("unwrapped", "pallas", torch.bfloat16),
                               ("wrapped", "pallas", torch.bfloat16),
                               ("plain", "xla", torch.bfloat16)):
        model = build_flagship(cfg, impl, dtype, state)[0]
        dropout_off(model)
        sharded = wrap(model) if label == "wrapped" else None
        with fixed_matching(matching), recorded_attention() as new_calls:
            runs[label] = losses_and_grads(model, batch, loss_cfg, norm,
                                           sharded)
        if label == "wrapped":
            calls = new_calls
        del model, sharded
        torch.cuda.empty_cache()
    (lw, gw), (lu, gu) = runs["wrapped"], runs["unwrapped"]
    if lw != lu or any(not torch.equal(gw[n], g) for n, g in gu.items()):
        raise AssertionError(f"{name}: the laid-out model's loss terms or "
                             "gradients differ from the unwrapped model's")
    losses32, grads32 = runs["fp32 plain"]
    gmax = max(g.abs().max().item() for g in grads32.values())
    gnorm = l2(grads32.values())
    dist = {}
    for label in ("wrapped", "plain"):
        losses, grads = runs[label]
        dist[label] = dict(
            {k: abs(losses[k] - v) / max(abs(v), 1e-12)
             for k, v in losses32.items()},
            grad_max=max((grads[n] - g).abs().max().item()
                         for n, g in grads32.items()) / gmax,
            grad_l2=l2(grads[n] - g for n, g in grads32.items()) / gnorm)
    log(f"bf16 train[{name}], one batch, dropout off: loss terms and "
        f"gradients equal to the unwrapped K1/K2 model's bit for bit; "
        f"distance from the float32 plain model, relative, laid out "
        f"{dist['wrapped']}, plain bf16 {dist['plain']} (bound "
        f"{BF16_REF_FACTOR} x plain + {GRAD_FLOOR} on the gradients and "
        f"loss_total)")
    bad = [k for k in ("grad_max", "grad_l2", "loss_total")
           if not dist["wrapped"][k] <= BF16_REF_FACTOR * dist["plain"][k]
           + (GRAD_FLOOR if k.startswith("grad") else LOSS_FLOOR)]
    if bad:
        raise AssertionError(f"the {name} train step is further from "
                             f"float32 than the bound in {bad}")
    hold_calls_against_fp32(f"train[{name}]", calls)


@contextlib.contextmanager
def recorded_attention():
    """Yields a list that gets, for every call of the kernels' entry point
    in the attention module, its bf16 inputs and output and, after a
    backward, the gradients of the output and of the inputs, as the model
    computed them."""
    from simvg_tpu_torch.ops import attention

    kernel, calls = attention.fused_attention, []

    def record(q, k, v, key_padding_mask=None):
        out = kernel(q, k, v, key_padding_mask=key_padding_mask)
        call = dict(q=q.detach(), k=k.detach(), v=v.detach(),
                    mask=key_padding_mask, out=out.detach())
        if out.requires_grad:
            for key, t in (("dout", out), ("dq", q), ("dk", k), ("dv", v)):
                t.register_hook(
                    lambda g, key=key: call.__setitem__(key, g.detach()))
        calls.append(call)
        return out

    attention.fused_attention = record
    try:
        yield calls
    finally:
        attention.fused_attention = kernel


def hold_calls_against_fp32(name, calls):
    """Each recorded call's output, and its dq, dk, dv where a backward ran,
    against plain attention in float32 on the call's bf16 inputs (and
    output gradient), beside the kernels' plain versions on the same
    inputs: relative L2 error within CALL_FACTOR x theirs + CALL_FLOOR."""
    import torch
    from simvg_tpu_torch.ops.fused_attention import (
        fused_attention_bwd_reference, fused_attention_reference)

    worst, bad = {}, []
    for i, c in enumerate(calls):
        grads = "dout" in c
        with torch.set_grad_enabled(grads):
            ins = [c[n].float().requires_grad_(grads) for n in "qkv"]
            ref = {"out": fused_attention_reference(*ins, c["mask"])}
            if grads:
                ref.update(zip(("dq", "dk", "dv"), torch.autograd.grad(
                    ref["out"], ins, c["dout"].float())))
        qkv = (c["q"], c["k"], c["v"])
        plain = {"out": fused_attention_reference(*qkv, c["mask"])}
        if grads:
            plain.update(zip(("dq", "dk", "dv"), fused_attention_bwd_reference(
                *qkv, c["dout"], c["mask"])))
        for key, r in ref.items():
            r = r.detach()
            e_k = ((c[key].float() - r).norm() / r.norm()).item()
            e_p = ((plain[key].float() - r).norm() / r.norm()).item()
            w = worst.setdefault(key, [0.0, 0.0, 0.0])
            w[:] = max(w[0], e_k), max(w[1], e_p), max(w[2], e_k / e_p)
            if not e_k <= CALL_FACTOR * e_p + CALL_FLOOR:
                bad.append(f"call {i} {key}")
    log(f"bf16 {name}, {len(calls)} attention calls on their own inputs, "
        f"relative L2 error against float32 plain attention, max over the "
        f"calls [kernels, their plain versions, largest ratio]: {worst} "
        f"(bound {CALL_FACTOR} x plain version + {CALL_FLOOR})")
    if bad or not calls:
        raise AssertionError(f"bf16 {name}: the kernels' attention is "
                             f"further from float32 than the bound in "
                             f"{len(bad)} of {4 * len(calls)} checks: "
                             f"{bad[:8]}")


def l2(tensors):
    """The L2 norm of a sequence of tensors taken as one vector."""
    return sum(t.double().pow(2).sum().item() for t in tensors) ** 0.5


@contextlib.contextmanager
def fixed_matching(matching):
    """With an empty list ``matching``, records every Hungarian matching of
    the criterion into it; else replays it, call for call.  Yields
    [targets that the solver's own matching moves, targets] of a replay."""
    from simvg_tpu_torch.losses import criterion, distill

    assign = criterion.hungarian_assign
    record, replay = not matching, iter(list(matching))
    moved = [0, 0]

    def fixed(cost, valid=None):
        out = assign(cost, valid)
        if record:
            matching.append(out)
            return out
        ref = tuple(t.to(cost.device) for t in next(replay))
        moved[0] += int((out[1] != ref[1]).sum())
        moved[1] += int((ref[1] >= 0).sum())
        return ref

    criterion.hungarian_assign = distill.hungarian_assign = fixed
    try:
        yield moved
    finally:
        criterion.hungarian_assign = distill.hungarian_assign = assign


@contextlib.contextmanager
def fixed_kinks(decisions):
    """With an empty list ``decisions``, records which inputs of every ReLU
    and LeakyReLU call are positive and which element of every max-pool
    window wins; else replays them, call for call, so that a float32 run
    takes the float64 run's side of each kink and its gradients differ
    from float64's by rounding alone.  Yields [elements whose own decision
    differed, elements] of a replay."""
    import torch
    import torch.nn.functional as F

    relu, leaky, pool = F.relu, F.leaky_relu, F.max_pool2d
    replay = iter(list(decisions)) if decisions else None
    moved = [0, 0]

    def decide(own):
        if replay is None:
            decisions.append(own.cpu())
            return own
        ref = next(replay).to(own.device)
        moved[0] += int((ref != own).sum())
        moved[1] += own.numel()
        return ref

    def fixed_relu(x, inplace=False):
        return torch.where(decide(x > 0), x, 0.0)

    def fixed_leaky(x, negative_slope=0.01, inplace=False):
        return torch.where(decide(x > 0), x, x * negative_slope)

    def fixed_pool(x, kernel_size, stride=None, padding=0, dilation=1,
                   ceil_mode=False, return_indices=False):
        out, idx = pool(x, kernel_size, stride, padding, dilation,
                        ceil_mode, return_indices=True)
        idx = decide(idx)
        out = x.flatten(2).gather(2, idx.flatten(2)).view_as(out)
        return (out, idx) if return_indices else out

    F.relu, F.leaky_relu, F.max_pool2d = fixed_relu, fixed_leaky, fixed_pool
    try:
        yield moved
    finally:
        F.relu, F.leaky_relu, F.max_pool2d = relu, leaky, pool


@contextlib.contextmanager
def timed_hungarian():
    """Yields a list that gets (host ms, (col4row, row4col)) of every
    Hungarian matching call of the criterion and of the soft distillation
    (``calls.soft`` lists the latter's ms); the ms cover the copy of the
    costs, the solve and the copy back, after a sync, so the wait for the
    device's forward is left out."""
    import torch
    from simvg_tpu_torch.losses import criterion, distill

    assign = criterion.hungarian_assign

    class Calls(list):
        soft: list

    calls = Calls()
    calls.soft = []

    def timed(sink):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = assign(*args, **kw)
            ms = (time.perf_counter() - t0) * 1e3
            calls.append((ms, out))
            sink.append(ms)
            return out
        return call

    criterion.hungarian_assign = timed([])
    distill.hungarian_assign = timed(calls.soft)
    try:
        yield calls
    finally:
        criterion.hungarian_assign = distill.hungarian_assign = assign


@contextlib.contextmanager
def recorded_soft_terms():
    """Yields a dict that gets the soft distillation's loss terms
    (``loss_{cls,bbox,iou}_distill*``) of the criterion's calls inside the
    block, as floats."""
    from simvg_tpu_torch.losses import criterion

    soft, terms = criterion.soft_distill_losses, {}

    def record(*args, **kw):
        out = soft(*args, **kw)
        terms.update({k: v.item() for k, v in out.items() if k != "total"})
        return out

    criterion.soft_distill_losses = record
    try:
        yield terms
    finally:
        criterion.soft_distill_losses = soft


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


K1_STEP = 12  # K1 launches a forward (encoder layers); K2 the same a step


def counted_run(name, fn, want_k1, want_k2, card, launches):
    """Runs ``fn`` with the K1/K2 counts set to 0 just before it; raises
    unless they read (want_k1, want_k2) just after, and appends them to
    ``launches``.  Returns fn's result."""
    import torch
    from simvg_tpu_torch.ops.fused_attention import (attention_bwd,
                                                     fused_attention)

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
    log(f"{name}: {secs:.1f} s, K1 launches {k1}, K2 launches {k2}, "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    return out


def cli_phase(card, root, opts):
    """The CLIs on the flagship at full width from the synthetic JPEGs:
    train 1 epoch (2 steps of 32, eval of val/testA/testB, det_best and
    latest), test on det_best (the same det_acc), resume from latest to
    epoch 2; K1/K2 launches counted from 0 around each.  Returns the K1 and
    K2 launches of the three runs and the first run's train losses."""
    import torch
    from simvg_tpu_torch.tools import test as test_cli
    from simvg_tpu_torch.tools import train as train_cli
    from simvg_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  save_checkpoint)

    wd = os.path.join(root, "work")
    steps = N_SYNTH_TRAIN // TRAIN_BATCH
    evals = 3  # val, testA, testB: one batch each
    launches = []

    def run(name, fn, want_k1, want_k2):
        return counted_run(f"cli[{name}]", fn, want_k1, want_k2, card,
                           launches)

    res = run("train", lambda: train_cli.main(
        [FLAGSHIP, "--work-dir", wd, "--cfg-options", *opts,
         "scheduler_config.max_epoch=1"]),
        K1_STEP * (steps + evals), K1_STEP * steps)
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
        K1_STEP * evals, 0)
    if got["val"]["det_acc"] != res["eval"]["val"]["det_acc"]:
        raise AssertionError(f"test CLI det_acc {got['val']} differs from the "
                             f"train CLI's {res['eval']['val']}")
    log(f"cli[test]: det_best val {got['val']} (train CLI's eval: the same "
        f"det_acc {res['eval']['val']['det_acc']})")

    res2 = run("resume", lambda: train_cli.main(
        [FLAGSHIP, "--work-dir", wd, "--resume-from",
         os.path.join(wd, "latest"), "--cfg-options", *opts,
         "scheduler_config.max_epoch=2", "save_interval=2"]),
        K1_STEP * (steps + evals), K1_STEP * steps)
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
    return (sum(k1 for k1, _ in launches), sum(k2 for _, k2 in launches),
            losses)


GREC = os.path.join(REPO, "configs", "single", "ViT-base", "grefcoco",
                    "grefcoco_onestage.py")
MIXED = os.path.join(REPO, "configs", "mix", "ViT-base", "pretrain-cocoall.py")
GREC_METRICS = ("decoder_F1_score", "decoder_N_acc", "token_F1_score",
                "token_N_acc")


def grec_phase(card, root):
    """GRefCOCO at full width (grefcoco_onestage.py: 640 px, S=421, 10
    queries, max_gt 10, batch 32, bf16) from N_SYNTH_TRAIN + N_SYNTH_VAL
    synthetic 480x640 GRefCOCO JPEGs: the train CLI for 1 epoch (the train
    F1/N-acc at its log line, F1/N-acc of val, testA and testB), the test
    CLI on det_best (the same F1/N-acc), K1/K2 launches counted; one GRec
    batch's loss terms and gradients with K1/K2 against plain attention;
    the train step's median and its host Hungarian ms.  Returns the K1 and
    K2 launches of the CLI runs."""
    import torch
    from simvg_tpu_torch.config import Config, parse_cfg_options
    from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                              build_loader_from_cfg)
    from simvg_tpu_torch.ops.hungarian import hungarian_assign
    from simvg_tpu_torch.tools import test as test_cli
    from simvg_tpu_torch.tools import train as train_cli
    from simvg_tpu_torch.tools.make_synth_data import make_grefcoco_style

    t0 = time.perf_counter()
    imgdir, ann = make_grefcoco_style(os.path.join(root, "grec"),
                                      N_SYNTH_TRAIN, N_SYNTH_VAL,
                                      img_hw=JPEG_HW, device="cuda")
    opts = synth_options(imgdir, ann)
    cfg = Config.fromfile(GREC)
    cfg.merge_from_dict(parse_cfg_options(opts))
    is_grec, max_gt = train_cli.gt_settings(cfg)
    log(f"grec: wrote {N_SYNTH_TRAIN}+{N_SYNTH_VAL} synthetic GRefCOCO "
        f"{JPEG_HW} JPEGs in {time.perf_counter() - t0:.2f} s; "
        f"{cfg.model.head.num_queries} queries, max_gt {max_gt}")
    wd = os.path.join(root, "grec_work")
    steps, evals = N_SYNTH_TRAIN // TRAIN_BATCH, 3
    launches = []
    res = counted_run("grec[train cli]", lambda: train_cli.main(
        [GREC, "--work-dir", wd, "--cfg-options", *opts,
         "scheduler_config.max_epoch=1"]),
        K1_STEP * (steps + evals), K1_STEP * steps, card, launches)
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        train = [json.loads(line) for line in f if '"train"' in line]
    keys = ("decoder_F1", "decoder_Nacc", "token_F1", "token_Nacc")
    if not (res["step"] == steps and train
            and all(0.0 <= train[-1].get(k, -1.0) <= 100.0 for k in keys)
            and all(v == v for v in train[-1].values()
                    if isinstance(v, float))):
        raise AssertionError(f"grec train CLI: step {res['step']}, train "
                             f"lines {train}")
    for split in ("val", "testA", "testB"):
        ev = res["eval"][split]
        if not all(0.0 <= ev[k] <= 100.0 for k in GREC_METRICS):
            raise AssertionError(f"grec eval[{split}]: {ev}")
    ep = res["epochs"][0]
    log(f"grec[train cli]: {steps} steps of {TRAIN_BATCH}, train "
        f"{ {k: train[-1][k] for k in ('loss_total',) + keys} }, epoch "
        f"{ep['seconds']:.2f} s ({ep['images_per_s']:.1f} images/s); eval "
        f"val {res['eval']['val']} [{card}]")
    got = counted_run("grec[test cli]", lambda: test_cli.main(
        [GREC, os.path.join(wd, "det_best"), "--cfg-options", *opts]),
        K1_STEP * evals, 0, card, launches)
    want = res["eval"]["val"]
    if any(got["val"][k] != want[k] for k in GREC_METRICS + ("det_acc",)):
        raise AssertionError(f"grec test CLI {got['val']} differs from the "
                             f"train CLI's evaluation {want}")
    log(f"grec[test cli]: det_best val F1/N-acc equal to the train CLI's: "
        f"{ {k: got['val'][k] for k in GREC_METRICS} }")

    # one GRec batch, kernels against plain attention; the step's time
    ds = build_dataset_from_cfg(cfg.data.train, dataset_type=cfg.dataset,
                                seed=cfg.seed)
    loader = build_loader_from_cfg(ds, cfg, train=True, canvas=cfg.img_size,
                                   max_gt=max_gt, seed=cfg.seed,
                                   device="cuda")
    dev = torch.device("cuda")
    batches = [train_cli.to_device(b, dev) for b in loader]
    n_gt = [int(b["gt_valid"].sum()) for b in batches]
    no_target = [int((b["gt_labels"] == 1).sum()) for b in batches]
    model, loss_cfg = build_flagship(cfg, "pallas", torch.bfloat16)
    step, state = make_train_step_for(cfg, model, loss_cfg, None,
                                      with_metrics=not is_grec,
                                      return_predictions=is_grec)
    state, _ = step(state, batches[0], SEED)  # warm-up
    hungarian_assign.round_trips = 0
    with timed_hungarian() as calls:
        for batch in batches:
            state, _ = step(state, batch, SEED)
    torch.cuda.synchronize()
    trips = hungarian_assign.round_trips / len(batches)
    (ts, peak), = time_train({"pallas": (step, state)}, batches).values()
    ms = ts[len(ts) // 2]
    log(f"grec train step, batch {TRAIN_BATCH}, bf16, 10 queries, targets a "
        f"batch {n_gt} (no-target rows {no_target}): median {ms:.3f} ms/step "
        f"({TRAIN_BATCH / ms * 1e3:.1f} images/s), min {ts[0]:.3f}, max "
        f"{ts[-1]:.3f}, {len(ts)} steps; max_memory_allocated "
        f"{peak / 2 ** 30:.2f} GiB; Hungarian host round trips per step "
        f"{trips}, host ms per step "
        f"{sum(ms for ms, _ in calls) / len(batches):.2f} "
        f"[{card}]")
    hold_train_against_plain("grec", cfg, model.state_dict(), batches[0],
                             loss_cfg, None)
    return (sum(k1 for k1, _ in launches), sum(k2 for _, k2 in launches))


def mixed_phase(card, root):
    """Mixed pretraining at full width (pretrain-cocoall.py: 512 px, S=277,
    decoder-only loss, batch 32, bf16) from synthetic 480x640 Mixed JPEGs
    in a coco and a flickr root plus a visual-genome record whose image is
    absent; the config's img_source keeps the coco records only, before any
    read.  The train CLI for 1 epoch and the evaluation of
    val_refcoco_unc, K1/K2 launches counted.  Returns them."""
    from simvg_tpu_torch.config import Config, parse_cfg_options
    from simvg_tpu_torch.data.builder import build_dataset_from_cfg
    from simvg_tpu_torch.tools import train as train_cli
    from simvg_tpu_torch.tools.make_synth_data import make_mixed_style

    t0 = time.perf_counter()
    roots, ann = make_mixed_style(os.path.join(root, "mixed"), N_SYNTH_TRAIN,
                                  N_SYNTH_VAL, img_hw=JPEG_HW, device="cuda")
    opts = []
    for split in ("train", "val"):
        opts.append(f"data.{split}.annsfile={ann}")
        opts += [f"data.{split}.imgsfile.{src}={d}"
                 for src, d in roots.items()]
    cfg = Config.fromfile(MIXED)
    cfg.merge_from_dict(parse_cfg_options(opts))
    ds = build_dataset_from_cfg(cfg.data.train, dataset_type=cfg.dataset,
                                seed=cfg.seed)
    with open(ann) as f:
        records = json.load(f)["train"]
    sources = cfg.data.train.img_source
    want = [a for a in records if a["data_source"] in sources]
    if ds.anns_all["train"] != want or "visual-genome" in sources:
        raise AssertionError(f"mixed img_source {sources} kept {len(ds)} "
                             f"records of {len(records)}")
    patches = (cfg.img_size // cfg.model.vis_enc.patch_size) ** 2
    seq = 1 + patches + cfg.max_token
    log(f"mixed: wrote {len(records)} train records ({N_SYNTH_TRAIN} coco, "
        f"{N_SYNTH_TRAIN} flickr, 1 visual-genome without an image) and "
        f"{N_SYNTH_VAL} val_refcoco_unc in {time.perf_counter() - t0:.2f} s;"
        f" img_source {sources} kept {len(ds)}; "
        f"{cfg.img_size} px, S={seq}")
    wd = os.path.join(root, "mixed_work")
    steps, evals = len(ds) // TRAIN_BATCH, 1
    launches = []
    res = counted_run("mixed[train cli]", lambda: train_cli.main(
        [MIXED, "--work-dir", wd, "--cfg-options", *opts,
         "scheduler_config.max_epoch=1"]),
        K1_STEP * (steps + evals), K1_STEP * steps, card, launches)
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        train = [json.loads(line) for line in f if '"train"' in line]
    ev = res["eval"]["val"]
    if not (res["step"] == steps and "loss_dgt" in train[-1]
            and "loss_tgt" not in train[-1]
            and all(v == v for v in train[-1].values()
                    if isinstance(v, float))
            and ev["n_samples"] == N_SYNTH_VAL):
        raise AssertionError(f"mixed train CLI: {res}, {train}")
    ep = res["epochs"][0]
    log(f"mixed[train cli]: {steps} steps of {TRAIN_BATCH}, decoder-only "
        f"loss_total {[m['loss_total'] for m in train]}, epoch "
        f"{ep['seconds']:.2f} s ({ep['images_per_s']:.1f} images/s); eval "
        f"val_refcoco_unc {ev} [{card}]")
    return launches[0]


# token pruning's in-envelope point on the flagship: keep 300 of the 400
# patches after layer 4 (the default), so K1 runs at S = 1 + 300 + 20 = 321
# after the prune point
PRUNE_KEEP = 300
SERVE_REQUESTS, SERVE_CLIENTS = 24, 8
# the timed load on the server: SERVE_CLIENTS closed-loop clients, in a
# process of their own, send the SERVE_REQUESTS requests over and over; the
# first SERVE_WARM_S seconds are dropped, and request latency and images/s
# are read over the SERVE_WINDOW_S seconds after them
SERVE_WARM_S, SERVE_WINDOW_S = 3.0, 20.0
# served boxes and scores, every query ("all": true), against a direct eval
# step of the same request at batch 1: the server's batch of 8 runs the
# bf16 GEMMs at another M.  Boxes in canvas pixels over the canvas side: a
# coordinate in [0.5, 1) of the canvas has a bf16 step of 2^-8 = 3.9e-3,
# the reading on the H100 is 4.58e-3 (PERF.md), the bound 2.5 steps.
# Scores, absolute: the softmax of bf16 logits, read 2.35e-5, bound ~40x
SERVE_BOX_TOL = 1e-2
SERVE_SCORE_TOL = 1e-3

@contextlib.contextmanager
def fixed_pruning(kept):
    """With an empty list ``kept``, records the kept patch indices of every
    pruning of the encoder into it; else replays them, call for call.
    Yields [indices that the model's own choice moves, indices] of a
    replay."""
    import torch
    from simvg_tpu_torch.models import beit3

    top_k = beit3.stable_top_k
    record, replay = not kept, iter(list(kept))
    moved = [0, 0]

    def fixed(scores, k):
        idx = top_k(scores, k)
        if record:
            kept.append(idx)
            return idx
        ref = next(replay)
        moved[0] += sum(int((~torch.isin(a, b)).sum())
                        for a, b in zip(idx, ref))
        moved[1] += ref.numel()
        return ref

    beit3.stable_top_k = fixed
    try:
        yield moved
    finally:
        beit3.stable_top_k = top_k


TOKEN_KEYS = ("class_token", "bbox_token")


def prune_phase(card, cfg, loader, norm, launches):
    """The flagship pruned to keep=300 after layer 4, bf16, batch 8: the
    requests through make_eval_step with 12 K1 launches a forward (S=421 up
    to the prune point, S=321 after it); its token outputs held to the
    float32 pruned model with plain attention (every model on the float32
    model's kept indices), at most BF16_REF_FACTOR x the bf16 plain model's
    distance, and every K1 call on its own inputs; keep=400 against the
    unpruned token branch; eval latency pruned and unpruned at batch 8 and
    32.  Returns the medians."""
    import numpy as np
    import torch
    from simvg_tpu_torch.engine import (make_eval_step,
                                        normalize_images_on_device)

    base, _ = build_flagship(cfg, "pallas", torch.bfloat16)
    state = base.state_dict()
    model, _ = build_flagship(cfg, "pallas", torch.bfloat16, state,
                              token_prune_keep=PRUNE_KEEP)
    enc = model.vis_enc["beit3"]
    if enc.prune_layer != 4:
        raise AssertionError(f"prune layer {enc.prune_layer}, expected 4")
    step = make_eval_step(model, device_norm=norm)
    step(to_device(loader[0]))  # warm-up
    preds = counted_run("prune[serve]",
                        lambda: [step(to_device(b)) for b in loader],
                        K1_STEP * len(loader), 0, card, launches)
    if not all(torch.isfinite(p["token"][k]).all() for p in preds
               for k in ("best_box", "best_score")):
        raise AssertionError("non-finite pruned predictions")

    ref32, _ = build_flagship(cfg, "xla", torch.float32, state,
                              token_prune_keep=PRUNE_KEEP)
    plain, _ = build_flagship(cfg, "xla", torch.bfloat16, state,
                              token_prune_keep=PRUNE_KEEP)
    full_keep, _ = build_flagship(cfg, "pallas", torch.bfloat16, state,
                                  token_prune_keep=400)
    err = {"K1": {}, "plain": {}}
    moved = {"K1": [0, 0], "plain": [0, 0]}
    keep_all_err, calls = 0.0, []
    for batch in loader:
        dev = to_device(batch)
        image = normalize_images_on_device(dev["image"], norm["mean"],
                                           norm["std"], True,
                                           dev["img_shape"])
        args = (image, dev["text_ids"], dev["text_padding_mask"])
        kept = []
        with fixed_pruning(kept):
            ref = outputs(ref32, args, dev["img_shape"])
        for name, m in (("K1", model), ("plain", plain)):
            with fixed_pruning(kept) as mv, recorded_attention() as new:
                out = outputs(m, args, dev["img_shape"])
            if name == "K1":
                calls += new
            moved[name] = [a + b for a, b in zip(moved[name], mv)]
            for k in TOKEN_KEYS:
                d = (out[k] - ref[k]).abs().max().item()
                err[name][k] = max(err[name].get(k, 0.0), d)
        a = outputs(full_keep, args, dev["img_shape"])
        b = outputs(base, args, dev["img_shape"])
        keep_all_err = max([keep_all_err] + [(a[k] - b[k]).abs().max().item()
                                             for k in TOKEN_KEYS])
    log(f"prune: bf16 token outputs of the pruned flagship (keep "
        f"{PRUNE_KEEP}, layer 4, S=421 -> {1 + PRUNE_KEEP + cfg.max_token}), "
        f"{len(loader)} batches, max abs distance from the float32 pruned "
        f"plain model on its kept indices: with K1 {err['K1']}, with plain "
        f"attention {err['plain']} (bound {BF16_REF_FACTOR} x plain + "
        f"{OUT_FLOOR}); kept indices each bf16 model's own top-K moves "
        f"[moved, kept]: {moved}")
    bad = [k for k in TOKEN_KEYS
           if not err["K1"][k] <= BF16_REF_FACTOR * err["plain"][k]
           + OUT_FLOOR]
    if bad:
        raise AssertionError(f"pruned bf16 outputs {bad} with K1 are further "
                             "from float32 than the bound")
    hold_calls_against_fp32("prune", calls)
    log(f"prune: keep=400 (every patch) against the unpruned model, token "
        f"outputs max abs diff {keep_all_err} (bound {OUT_FLOOR})")
    if not keep_all_err <= OUT_FLOOR:
        raise AssertionError("keep=400 differs from the unpruned model")
    del ref32, plain, full_keep

    unpruned = make_eval_step(base, device_norm=norm)
    medians = {}
    rng = np.random.default_rng(SEED + 2)
    for b, reqs in ((BATCH, loader), (TRAIN_BATCH, make_requests(
            rng, 1, TRAIN_BATCH, enc.cfg.vocab_size, cfg.max_token,
            cfg.img_size))):
        steps = {"unpruned": unpruned, "pruned": step}
        lat = time_eval(steps, reqs)
        dev = to_device(reqs[0])
        for name, ts in lat.items():
            ms = medians[(name, b)] = ts[len(ts) // 2]
            n_kernels, busy = device_kernels(lambda: steps[name](dev))
            log(f"prune: eval forward, batch {b}, bf16, {name}: median "
                f"{ms:.3f} ms/batch ({b / ms * 1e3:.1f} images/s), min "
                f"{ts[0]:.3f}, max {ts[-1]:.3f}, {len(ts)} batches; one call "
                f"under the profiler: {n_kernels} kernels, device busy "
                f"{busy:.3f} ms [{card}]")
    return base, medians


def device_kernels(fn):
    """(CUDA kernels, device busy ms) of one call of ``fn`` under
    torch.profiler, busy time as the union of the kernels' intervals."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return len(spans), busy / 1e3


def export_phase(card, model, loader, norm, root, launches):
    """torch.export of the flagship's serving forward (K1 model, bf16,
    uint8 images normalised inside) with a polymorphic batch, saved and
    loaded: 12 K1 nodes in the graph, 12 launches a call, the outputs
    those of the eager eval step on the same batch bit for bit, batch 3
    served, and the exported program timed against eager at batch 8."""
    import torch
    from simvg_tpu_torch.engine import make_eval_step
    from simvg_tpu_torch.export import (attention_op_count, export_serving,
                                        load_exported, save_exported)

    batch = to_device(loader[0])
    t0 = time.perf_counter()
    prog = export_serving(model, batch, polymorphic_batch=True,
                          device_norm=norm)
    export_s = time.perf_counter() - t0
    path = os.path.join(root, "flagship.pt2")
    t0 = time.perf_counter()
    save_exported(path, prog)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prog = load_exported(path)
    load_s = time.perf_counter() - t0
    nodes = attention_op_count(prog)
    if nodes != K1_STEP:
        raise AssertionError(f"exported graph holds {nodes} K1 nodes, "
                             f"expected {K1_STEP}")
    eager = make_eval_step(model, device_norm=norm)
    prog.call(batch)  # warm-up
    out = counted_run("export[call]", lambda: prog.call(batch), K1_STEP, 0,
                      card, launches)
    ref = eager(batch)
    diffs = {f"{br}/{k}": (out[br][k].float() - ref[br][k].float()).abs()
             .max().item() for br in ref for k in ref[br]}
    if any(diffs.values()):
        raise AssertionError(f"exported outputs differ from eager: {diffs}")
    small = prog.call({k: v[:3] for k, v in batch.items()})
    if small["token"]["best_box"].shape != (3, 4):
        raise AssertionError("the polymorphic program did not serve batch 3")
    lat = time_eval({"eager": eager, "exported": prog.call}, loader)
    medians = {}
    nodes_all = sum(n.op == "call_function" for n in prog.program.graph.nodes)
    for name, ts in lat.items():
        ms = medians[name] = ts[len(ts) // 2]
        n_kernels, busy = device_kernels(
            lambda: (eager if name == "eager" else prog.call)(batch))
        log(f"export: batch {BATCH}, bf16, {name}: median {ms:.3f} ms/batch "
            f"({BATCH / ms * 1e3:.1f} images/s), min {ts[0]:.3f}, max "
            f"{ts[-1]:.3f}, {len(ts)} batches; one call under the profiler: "
            f"{n_kernels} kernels, device busy {busy:.3f} ms [{card}]")
    log(f"export: the exported graph has {nodes_all} operator nodes")
    log(f"export: {nodes} K1 nodes; export {export_s:.1f} s, save "
        f"{save_s:.1f} s ({os.path.getsize(path) / 2 ** 30:.3f} GiB), load "
        f"{load_s:.1f} s; outputs equal to eager bit for bit; batch 3 served")
    os.remove(path)
    return medians


def _http(port, path, payload=None, timeout=120):
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_load(port, bodies_path, clients, seconds):
    """The timed load on the server, run in a process of its own: `clients`
    closed-loop client threads send the request bodies in `bodies_path`
    over and over for `seconds`; prints one JSON list of each request's
    [start, end] in seconds from the load's start, HTTP status, and the
    batch size and batch ms (forward and copy back) the server reports."""
    import http.client
    import threading

    with open(bodies_path) as f:
        bodies = [json.dumps(b).encode() for b in json.load(f)]
    t0 = time.perf_counter()
    records = []

    def client(c):
        i = c
        while time.perf_counter() - t0 < seconds:
            a = time.perf_counter()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            conn.request("POST", "/predict", body=bodies[i % len(bodies)],
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            data = r.read()
            conn.close()
            out = json.loads(data) if r.status == 200 else {}
            records.append([a - t0, time.perf_counter() - t0, r.status,
                            out.get("batch_size", 0),
                            out.get("latency_ms", 0.0)])
            i += clients

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(json.dumps(records), flush=True)


def jpeg_requests(imgdir):
    """SERVE_REQUESTS request bodies from the synthetic JPEGs, each asking
    for every query's boxes and scores."""
    import base64

    reqs = []
    for i, name in enumerate(sorted(os.listdir(imgdir))[:SERVE_REQUESTS]):
        with open(os.path.join(imgdir, name), "rb") as f:
            reqs.append({"image_b64": base64.b64encode(f.read()).decode(),
                         "expression": f"the green box number {i}",
                         "all": True})
    return reqs


def serve_burst(port, reqs):
    """`reqs` sent to the server at `port` from SERVE_CLIENTS client
    threads; returns [(status, response)] in request order, and raises on
    a failed request or when no device batch held more than one."""
    import threading

    results = [None] * len(reqs)

    def client(c):
        for i in range(c, len(reqs), SERVE_CLIENTS):
            results[i] = _http(port, "/predict", reqs[i])

    clients = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=300)
    if any(t.is_alive() for t in clients) or any(
            r is None or r[0] != 200 for r in results):
        raise AssertionError(f"serve: failed requests {results}")
    if max(out["batch_size"] for _, out in results) <= 1:
        raise AssertionError("serve: no device batch held more than one "
                             "request")
    return results


def held_to_direct(results, reqs, model, cfg, decode=None):
    """Each response's boxes (back at the canvas scale) and scores, every
    query of both branches, against a direct batch-1 eval step of its
    request on ``model`` (its image decoded by ``decode``, bytes -> the
    image on the card, when given): returns (max box |diff| / canvas, max
    score |diff|, and the boxes' min distance from the NEXT request's
    direct step, which a slot mix-up in the batcher would show)."""
    import base64

    import numpy as np
    from simvg_tpu_torch.data.raw import RawPreprocessor
    from simvg_tpu_torch.engine import make_eval_step

    pre = RawPreprocessor(cfg, "cuda")
    step = make_eval_step(model, device_norm=pre.device_norm)
    direct, sfs = [], []  # each request's boxes (canvas scale) and scores
    for req in reqs:
        data = base64.b64decode(req["image_b64"])
        batch = pre.collate([pre(data, req["expression"])],
                            [decode(data)] if decode else ())
        preds = step(to_device(batch))
        direct.append({br: (preds[br]["boxes"][0].float().cpu().numpy(),
                            preds[br]["scores"][0].float().cpu().numpy())
                       for br in ("token", "decoder")})
        sfs.append(batch["scale_factor"][0])

    def distance(out, sf, want):  # max |diff| of boxes (canvas px), scores
        box = score = 0.0
        for br, (boxes, scores) in want.items():
            served = np.asarray(out[br]["boxes"]) * sf
            if not all(np.isfinite(a).all() for a in (
                    served, boxes, scores, out[br]["scores"])):
                raise AssertionError(f"serve: non-finite {br} predictions")
            box = max(box, float(np.abs(served - boxes).max()))
            score = max(score, float(np.abs(np.asarray(out[br]["scores"])
                                            - scores).max()))
        return box, score

    errs = [distance(out, sf, want)
            for (_, out), sf, want in zip(results, sfs, direct)]
    swapped = min(distance(out, sf, want)[0] for (_, out), sf, want in
                  zip(results, sfs, direct[1:] + direct[:1]))
    return (max(e[0] for e in errs) / cfg.img_size, max(e[1] for e in errs),
            swapped / cfg.img_size)


def serve_phase(card, root, imgdir, launches):
    """The port's HTTP server in a thread on det_best (the CLI phase's
    flagship checkpoint), --max-batch 8.  A burst of SERVE_REQUESTS JPEG
    requests from SERVE_CLIENTS client threads is the correctness check:
    at least one batch of more than one request, /healthz, 400 and 404,
    and each response's boxes and scores (every query), back at the canvas
    scale, against a direct eval step of its request (SERVE_BOX_TOL,
    SERVE_SCORE_TOL).  Then the timed load (``serve_load``) gives request
    latency p50/p90 and images/s in steady state.  12 K1 launches a device
    batch over both, no K2."""
    import base64
    import threading

    import numpy as np
    import torch
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.ops.fused_attention import (attention_bwd,
                                                     fused_attention)
    from simvg_tpu_torch.tools import serve as serve_cli
    from simvg_tpu_torch.tools.test import serving_model

    det_best = os.path.join(root, "work", "det_best")
    server = serve_cli.build_server([FLAGSHIP, "--checkpoint", det_best,
                                     "--port", "0", "--max-batch",
                                     str(BATCH), "--batch-timeout-ms", "20"])
    thread = threading.Thread(target=server.serve_forever)
    thread.start()
    port = server.server_port
    reqs = jpeg_requests(imgdir)
    bodies_path = os.path.join(root, "serve_requests.json")
    with open(bodies_path, "w") as f:
        json.dump(reqs, f)
    try:
        status, health = _http(port, "/healthz")
        if status != 200 or health["max_batch"] != BATCH:
            raise AssertionError(f"/healthz: {status} {health}")
        torch.cuda.synchronize()
        fused_attention.launches = attention_bwd.launches = 0
        server.batcher.batches = 0
        results = serve_burst(port, reqs)
        burst_batches = server.batcher.batches
        sizes = [out["batch_size"] for _, out in results]
        errors = [_http(port, "/predict", {"expression": "no image"})[0],
                  _http(port, "/predict", {"image_b64": base64.b64encode(
                      b"\x89PNG\r\n\x1a\n0000").decode(),
                      "expression": "a truncated png"})[0],
                  _http(port, "/predict", {"image_b64": base64.b64encode(
                      b"BM" + bytes(60)).decode(), "expression": "bmp"})[0],
                  _http(port, "/nothing")[0]]
        if errors != [400, 400, 400, 404]:
            raise AssertionError(f"serve: error paths gave {errors}")

        proc = subprocess.run(
            [sys.executable, "-c",
             f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
             f"chip_smoke.serve_load({port}, {bodies_path!r}, "
             f"{SERVE_CLIENTS}, {SERVE_WARM_S + SERVE_WINDOW_S})"],
            capture_output=True, text=True,
            timeout=SERVE_WARM_S + SERVE_WINDOW_S + 300)
        if proc.returncode != 0:
            raise AssertionError(f"serve: the load's clients failed: "
                                 f"{proc.stderr[-2000:]}")
        load = json.loads(proc.stdout.strip().splitlines()[-1])
        torch.cuda.synchronize()
        k1, k2 = fused_attention.launches, attention_bwd.launches
        batches = server.batcher.batches
        if k1 != K1_STEP * batches or k2:
            raise AssertionError(f"serve: K1 {k1}, K2 {k2} launches over "
                                 f"{batches} batches")
        launches.append((k1, k2))
    finally:
        server.close()
        thread.join(timeout=60)

    bad = [r for r in load if r[2] != 200]
    if bad:
        raise AssertionError(f"serve: {len(bad)} of {len(load)} requests of "
                             f"the load failed, first {bad[0]}")
    w0, w1 = SERVE_WARM_S, SERVE_WARM_S + SERVE_WINDOW_S
    window = [r for r in load if w0 <= r[1] < w1]
    lat = np.asarray([(r[1] - r[0]) * 1e3 for r in window])
    p50, p90 = np.percentile(lat, 50), np.percentile(lat, 90)
    mean_size = float(np.mean([r[3] for r in window]))
    batch_ms = float(np.mean([r[4] for r in window]))

    cfg = Config.fromfile(FLAGSHIP)
    model = serving_model(cfg, det_best, torch.device("cuda"))
    box_err, score_err, swapped = held_to_direct(results, reqs, model, cfg)
    log(f"serve: burst of {len(reqs)} JPEG requests from {SERVE_CLIENTS} "
        f"clients in {burst_batches} device batches (sizes {sorted(sizes)})"
        f"; against a direct eval step at batch 1, every query: boxes max "
        f"|diff| / canvas {box_err:.2e} (bound {SERVE_BOX_TOL}), scores "
        f"{score_err:.2e} (bound {SERVE_SCORE_TOL}); each response against "
        f"the next request's direct step: boxes min {swapped:.2e}; 400, "
        f"400, 400, 404 on the error paths")
    log(f"serve: load of {SERVE_CLIENTS} closed-loop clients in a process of"
        f" their own, {len(load)} requests in {w1:.0f} s; over the "
        f"{SERVE_WINDOW_S:.0f} s after a {SERVE_WARM_S:.0f} s warm-up: "
        f"{len(window)} requests, {len(window) / SERVE_WINDOW_S:.1f} "
        f"images/s, request latency p50 {p50:.1f} ms, p90 {p90:.1f} ms, "
        f"mean batch size {mean_size:.2f}, mean batch ms (the batcher's "
        f"forward and copy back) {batch_ms:.1f}; K1 launches {k1} over {batches} "
        f"device batches (burst and load), K2 {k2} [{card}]")
    if not (box_err <= SERVE_BOX_TOL and score_err <= SERVE_SCORE_TOL):
        raise AssertionError("served predictions differ from the direct eval "
                             "step beyond the bound")


# "png": the PNG kernel (csrc/png.cu) against the plain decoder on streams
# of every colour type and bit depth, every filter type row by row, plain
# and Adam7, at a size with an empty Adam7 pass, one taller than a block of
# the wavefront (600 rows) and 480 x 640
PNG_CASES = ((0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
             (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16))
PNG_FILTERS = (0, 1, 2, 3, 4)
PNG_REQUESTS = 16


def png_streams(rng):
    """PNG streams written here with zlib (``tests/util_torch_port.py``'s
    ``write_png``) over PNG_CASES and its PNG_BOUNDARY_CASES, and the timed
    ones: 480 x 640 RGB with every filter type, and with Paeth alone."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from util_torch_port import (PNG_BOUNDARY_CASES, png_boundary_stream,
                                 png_chunk, write_png)

    streams = []
    for ct, bd in PNG_CASES:
        ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ct]
        for h, w in ((3, 5), (37, 29), (600, 9)):
            samples = rng.integers(0, 1 << bd, (h, w, ch))
            before = b""
            if ct == 3:
                n = (1 << bd) - 1 if bd < 8 else 200
                before = png_chunk(b"PLTE", rng.integers(0, 256, 3 * n)
                                   .astype("uint8").tobytes())
            for interlace in (False, True):
                streams.append(write_png(samples, bd, ct, PNG_FILTERS,
                                         interlace, before))
    streams += [png_boundary_stream(c) for c in PNG_BOUNDARY_CASES]
    pixels = rng.integers(0, 256, JPEG_HW + (3,))
    return streams, write_png(pixels, 8, 2, PNG_FILTERS), write_png(
        pixels, 8, 2, (4,))


def png_dataset(root, opts):
    """The synthetic JPEGs (the data phase's) rewritten by this phase as
    PNG files of their decoded pixels, every filter type, every fourth
    Adam7, under ``root``/png_synth with the same names and annotations;
    returns the --cfg-options of that copy."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from util_torch_port import write_png
    from simvg_tpu_torch.data.jpeg import decode

    imgdir = dict(o.split("=", 1) for o in opts)["data.train.imgsfile"]
    ann = dict(o.split("=", 1) for o in opts)["data.train.annsfile"]
    pngdir = os.path.join(root, "png_synth", "images")
    os.makedirs(pngdir)
    for i, name in enumerate(sorted(os.listdir(imgdir))):
        with open(os.path.join(imgdir, name), "rb") as f:
            pixels = decode(f.read(), "cuda").cpu().numpy()
        with open(os.path.join(pngdir, name), "wb") as f:
            f.write(write_png(pixels[..., ::-1], 8, 2, PNG_FILTERS,
                              interlace=i % 4 == 0))
    return synth_options(pngdir, ann)


def png_phase(card, root, opts, launches):
    """The PNG kernel against its plain version on the same streams, bit
    for bit; its device time on 480 x 640 RGB beside the host's inflate
    and the plain decoder.  Then the main paths that take PNG input, each
    with the kernel's launches counted from 0: the flagship's val loader
    over the synthetic images rewritten as PNG (every batch equal, bit
    for bit, to the batch of the same samples from the plain decoder's
    pixels), and the server on det_best answering PNG requests (200, the
    boxes of a direct eval step on the plain-decoded pixels).  Returns
    the kernel's row for the {"kernels": ...} line."""
    import base64
    import threading

    import numpy as np
    import torch
    from simvg_tpu_torch.config import Config, parse_cfg_options
    from simvg_tpu_torch.data import png
    from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                              build_loader_from_cfg)
    from simvg_tpu_torch.data.image_ops import collate_images
    from simvg_tpu_torch.tools import serve as serve_cli
    from simvg_tpu_torch.tools.test import serving_model

    def plain(data):  # the plain decoder's pixels, on the card
        return png.decode(data, "cpu").cuda()

    streams, big, paeth = png_streams(np.random.default_rng(SEED))
    for data in streams + [big, paeth]:
        got = png.decode(data, "cuda")
        if not torch.equal(got.cpu(), png.decode(data, "cpu")):
            st = png.parse(data)
            raise AssertionError(
                f"png: the kernel differs from its plain version at "
                f"{st.height}x{st.width}, colour type {st.color_type}, bit "
                f"depth {st.bit_depth}, interlace {st.interlace}")
    st = png.parse(big)
    t0 = time.perf_counter()
    for _ in range(10):
        png.parse(big)
    inflate_ms = (time.perf_counter() - t0) * 1e2
    t0 = time.perf_counter()
    png.decode_reference(st)
    plain_ms = (time.perf_counter() - t0) * 1e3
    kern = lambda: png.decode_cuda(st, "cuda")  # noqa: E731
    kern()
    ms = cuda_ms(kern, 20)
    split = kernel_split_ms(kern, 20, {"unfilter_ms": "unfilter_kernel",
                                       "convert_ms": "convert_kernel"}, 2)
    device_ms = sum(split.values()) if None not in split.values() else None
    st_paeth = png.parse(paeth)
    paeth_split = kernel_split_ms(lambda: png.decode_cuda(st_paeth, "cuda"),
                                  20, {"unfilter_ms": "unfilter_kernel"}, 1)
    # the inflated bytes read once, the BGR image written once
    nbytes = len(st.data) + st.height * st.width * 3
    bms, by = bound_ms(nbytes, 0, "bfloat16")
    row = dict(shape=[st.height, st.width, 3], streams=len(streams) + 2,
               max_abs_err=0, ms=ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=bms, bound_by=by, device_ms=device_ms,
               inflate_ms=inflate_ms, **split,
               paeth_unfilter_ms=paeth_split["unfilter_ms"])
    log(f"png: the kernel equals its plain version on {len(streams) + 2} "
        f"streams (every colour type and bit depth, filters 0-4, Adam7, the "
        f"unfilter kernel's edges); 480x640 RGB, every filter: {row} (ms: "
        f"copy to the card and both kernels, CUDA events; device_ms: the "
        f"kernels' device time, torch.profiler; paeth_unfilter_ms: the "
        f"unfilter kernel on the all-Paeth image; plain_ms: the numpy "
        f"decoder; inflate_ms: zlib and the chunks on the host) [{card}]")

    # the flagship's val loader over the PNG copy of the synthetic images
    cfg = Config.fromfile(FLAGSHIP)
    cfg.merge_from_dict(parse_cfg_options(png_dataset(root, opts)))
    ds = build_dataset_from_cfg(cfg.data.val, dataset_type=cfg.dataset,
                                seed=cfg.seed)
    loader = build_loader_from_cfg(ds, cfg, train=False, canvas=cfg.img_size,
                                   seed=cfg.seed, device="cuda")
    torch.cuda.synchronize()
    png.decode.launches = 0
    batches = list(loader)
    torch.cuda.synchronize()
    loader_launches = png.decode.launches
    for (idx, _), batch in zip(loader._index_batches(), batches):
        idx = (idx * loader.bs)[:loader.bs]  # the loader's wrap-padding
        samples = [ds[i] for i in idx]
        want = collate_images(samples, cfg.img_size, "cuda",
                              [plain(s["img_bytes"]) for s in samples])
        if not torch.equal(batch["image"], want):
            raise AssertionError("png: a loader batch differs from the "
                                 "plain decoder's")
    if loader_launches != len(batches) * loader.bs:  # wrap-padding too
        raise AssertionError(f"png: {loader_launches} kernel launches for "
                             f"{len(batches)} batches of {loader.bs}")

    # the server on det_best, PNG requests
    pngdir = cfg.data.val.imgsfile
    reqs = []
    for i, name in enumerate(sorted(os.listdir(pngdir))[:PNG_REQUESTS]):
        with open(os.path.join(pngdir, name), "rb") as f:
            reqs.append({"image_b64": base64.b64encode(f.read()).decode(),
                         "expression": f"the green box number {i}",
                         "all": True})
    det_best = os.path.join(root, "work", "det_best")
    server = serve_cli.build_server([FLAGSHIP, "--checkpoint", det_best,
                                     "--port", "0", "--max-batch",
                                     str(BATCH), "--batch-timeout-ms", "20"])
    thread = threading.Thread(target=server.serve_forever)
    thread.start()
    try:
        torch.cuda.synchronize()
        png.decode.launches = 0
        results = serve_burst(server.server_port, reqs)
        torch.cuda.synchronize()
        serve_launches = png.decode.launches
    finally:
        server.close()
        thread.join(timeout=60)
    if serve_launches != len(reqs):
        raise AssertionError(f"png: {serve_launches} kernel launches for "
                             f"{len(reqs)} requests")
    model = serving_model(cfg, det_best, torch.device("cuda"))
    box_err, score_err, swapped = held_to_direct(results, reqs, model, cfg,
                                                 decode=plain)
    log(f"png: val loader over {len(ds)} PNG files in {len(batches)} "
        f"batches, each equal to the plain decoder's batch; the server "
        f"answered {len(reqs)} PNG requests with 200, against a direct eval "
        f"step on the plain decoder's pixels: boxes max |diff| / canvas "
        f"{box_err:.2e} (bound {SERVE_BOX_TOL}), scores {score_err:.2e} "
        f"(bound {SERVE_SCORE_TOL}), the next request's min {swapped:.2e}; "
        f"kernel launches: loader {loader_launches}, server {serve_launches}"
        f" [{card}]")
    if not (box_err <= SERVE_BOX_TOL and score_err <= SERVE_SCORE_TOL):
        raise AssertionError("png: served predictions differ from the "
                             "direct eval step beyond the bound")
    launches.append(loader_launches + serve_launches)
    return row


# "formats": the decoders of every other format cv2 reads (csrc/
# image_convert.cu, vp8.cu, vp8l.cu) against their plain versions on the
# committed fixtures (tests/fixtures/formats/, written by
# tests/fixtures/make_format_fixtures.py: the CPU tests' cases and one
# 480 x 640 image a format), each also against cv2's digest of its pixels
FORMATS_DIR = os.path.join(REPO, "tests", "fixtures", "formats")
# the fixture each new kernel's row is timed on, 480 x 640
# the 480 x 640 fixtures each new kernel is timed on: textured (the row of
# the kernels line), then posterised
FORMAT_TIMED = {"image_convert": ("tiff_big_textured.tif",
                                  "tiff_big_lzw_pred2.tif"),
                "vp8": ("webp_lossy_big_textured.webp",
                        "webp_lossy_big_lossy.webp"),
                "vp8l": ("webp_lossless_big_textured.webp",
                         "webp_lossless_big_lossless.webp")}
# requests the server must refuse: formats cv2 reads that the port does not
FORMAT_REFUSED = {
    "JPEG 2000": b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(40),
    "AVIF": b"\x00\x00\x00\x1cftypavif" + bytes(40),
    "OpenEXR": b"\x76\x2f\x31\x01" + bytes(40)}


def format_fixtures():
    """{file name: (bytes, cv2's digest record)} of the committed
    fixtures."""
    with open(os.path.join(FORMATS_DIR, "digests.json")) as f:
        digests = json.load(f)
    out = {}
    for name, rec in digests.items():
        with open(os.path.join(FORMATS_DIR, name), "rb") as f:
            out[name] = (f.read(), rec)
    return out


def _launch_counts():
    from simvg_tpu_torch.data import image_convert, vp8, vp8l

    return {"image_convert": image_convert.convert.launches,
            "vp8": vp8.decode.launches, "vp8l": vp8l.decode.launches}


def _zero_launches():
    from simvg_tpu_torch.data import image_convert, vp8, vp8l

    image_convert.convert.launches = vp8.decode.launches = 0
    vp8l.decode.launches = 0


def _stages(kernel):
    """(host stage, pixel stage) of the decoder whose card route a timed
    fixture of ``kernel`` takes: the functions ``decode`` chains."""
    from simvg_tpu_torch.data import tiff, webp

    if kernel == "image_convert":
        return tiff.parse, tiff.pixel_stage
    return webp.host_stage, webp.pixel_stage


def _bound_bytes(kernel, parsed):
    """The bytes the pixel stage must move: its inputs (the host stage's
    output) read once and the BGR image written once."""
    if kernel == "image_convert":
        raw, r, _ = parsed
        return len(raw) + sum(a.nbytes for a in (r.lut, r.palette, r.rows)
                              if a is not None) + r.width * r.height * 3
    f, st = parsed
    out = st.width * st.height * 3
    if kernel == "vp8":
        return st.info.nbytes + st.levels.nbytes + st.quant.nbytes + out
    return st.pixels.nbytes + sum(t.data.nbytes for t in st.transforms) + out


_KERNEL_NAMES = {"image_convert": {"predictor_ms": "scan_kernel",
                                   "convert_ms": "convert_kernel"},
                 "vp8": {"reconstruct_filter_ms": "reconstruct_filter_kernel",
                         "bgr_ms": "bgr_kernel"},
                 "vp8l": {"predictor_ms": "predictor_pipeline_kernel",
                          "pixel_ms": "pixel_kernel"}}


def _kernel_launches(kernel, parsed):
    """The kernels of _KERNEL_NAMES[kernel] that one call of the pixel
    stage launches on ``parsed``: TIFF's predictor (if the file has one)
    and conversion; VP8's pixels and BGR; VP8L a kernel a transform and one
    to BGR."""
    if kernel == "image_convert":
        return 1 + (parsed[2] is not None)
    if kernel == "vp8":
        return 2
    return len(parsed[1].transforms) + 1


def predictor_kernels(card):
    """The VP8L and TIFF predictor kernels on the synthetic cases of
    tests/util_image_formats.py (VP8L: random residuals, every mode in every
    tile position, bits 2-9, widths 1, 2, 2^bits +- 1, 640, and 4097, 8192
    and 16384 (rings in device memory, past the widths shared memory holds;
    the two widest tall enough that every ring is refilled), heights 1,
    31-33 and one past the kernel's slots of 32 rows; TIFF: spp 1-5, 8 and
    9, 8 and 16 bits in both byte orders, counts around a warp and past a
    pass, padded segments) against their plain versions, bit for bit.
    Then TIFF's kernel alone on the textured 480 x 640 fixture's 480
    segments beside its yardstick, torch.cumsum over their (segments,
    count, spp) view in uint8, which wraps as the predictor does (held equal
    to the kernel's bytes; int32 and a mask, two calls, if it did not),
    both CUDA events over 50 calls on bytes already on the card.  Returns
    the numbers for the image_convert row."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import util_image_formats as U
    from simvg_tpu_torch.data import image_convert as ic
    from simvg_tpu_torch.data import tiff, vp8l

    vp8l_cases = U.vp8l_predictor_cases()
    for label, w, h, bits, modes in vp8l_cases:
        res, words = U.vp8l_predictor_input(w, h, bits, modes,
                                            seed=w * 31 + h)
        t = vp8l.Transform(vp8l.PREDICTOR, w, bits, words)
        got = vp8l.transform_cuda(
            t, torch.from_numpy(res.view(np.int32)).cuda(), h)
        if not np.array_equal(got.cpu().numpy().view(np.uint32),
                              vp8l._inverse(t, res.copy(), h)):
            raise AssertionError(f"formats: the VP8L predictor kernel "
                                 f"differs from its plain version on {label}")
    for spp, bits, be, count, pad in U.TIFF_PREDICTOR_CASES:
        data, segments, seg_bytes = U.tiff_predictor_input(spp, bits, count,
                                                           pad)
        got = ic.undo_predictor_cuda(data, "cuda", segments, seg_bytes,
                                     count, spp, bits, be)
        if got.cpu().numpy().tobytes() != ic.undo_predictor_reference(
                data, segments, seg_bytes, count, spp, bits, be):
            raise AssertionError(
                f"formats: the TIFF predictor kernel differs from its plain "
                f"version at spp {spp}, {bits} bits, big endian {be}, "
                f"count {count}, padding {pad}")
    raw, _, seg = tiff.parse(format_fixtures()["tiff_big_textured.tif"][0],
                             "cuda")
    n, seg_bytes, count, spp, bits, be = seg
    lib = ic.library()
    stream = torch.cuda.current_stream().cuda_stream
    buf = ic.upload(raw, "cuda")

    def kernel():
        rc = lib.simvg_tiff_predictor(buf.data_ptr(), n, seg_bytes, count,
                                      spp, bits, int(be), stream)
        if rc:
            raise RuntimeError(f"TIFF predictor kernel: CUDA error {rc}")

    kernel()
    kernel_ms = cuda_ms(kernel, 50)  # in place: the time is the data's
    want = ic.undo_predictor_cuda(raw, "cuda", *seg)[:n * seg_bytes].view(
        n, seg_bytes)[:, :count * spp].reshape(n, count, spp)
    view = ic.upload(raw, "cuda")[:n * seg_bytes].view(n, seg_bytes)[
        :, :count * spp].unflatten(1, (count, spp))
    library, calls = (lambda: torch.cumsum(view, 1, dtype=torch.uint8)), 1
    if not torch.equal(library(), want):
        library, calls = (lambda: torch.cumsum(view, 1, dtype=torch.int32)
                          .bitwise_and_(255)), 2
        if not torch.equal(library().to(torch.uint8), want):
            raise AssertionError("formats: torch.cumsum differs from the "
                                 "TIFF predictor kernel")
    library()
    library_ms = cuda_ms(library, 50)
    t0 = time.perf_counter()
    ic.undo_predictor_reference(raw, *seg)
    plain_ms = (time.perf_counter() - t0) * 1e3
    # the segments' bytes read once and written once
    bms, by = bound_ms(2 * n * count * spp * bits // 8, 0, "bfloat16")
    out = dict(predictor_kernel_ms=kernel_ms, predictor_library_ms=library_ms,
               predictor_library_calls=calls, predictor_plain_ms=plain_ms,
               predictor_bound_ms=bms)
    log(f"formats: the VP8L predictor kernel equals its plain version on "
        f"{len(vp8l_cases)} synthetic transforms, TIFF's on "
        f"{len(U.TIFF_PREDICTOR_CASES)} synthetic segment sets; TIFF's "
        f"predictor on the textured 480 x 640 fixture ({n} segments of "
        f"{count} x {spp} bytes): {out} (kernel and torch.cumsum: CUDA "
        f"events a call over 50 calls; plain: the numpy route) [{card}]")
    return out


def formats_kernels(card, plain_cache):
    """Every fixture through the card's route and the plain route: equal
    bit for bit, and to cv2's digest (a broken stream raises on both);
    the host stages' C++ (VP8, VP8L, LZW) against their Python on every
    fixture that has one; each new kernel timed on its textured and its
    posterised 480 x 640 fixtures through the decoder's own host and pixel
    stages (ms: the pixel stage, copies and kernels, CUDA events;
    device_ms: the kernels, torch.profiler; host_ms: the host stage;
    plain_ms: the plain route's whole decode), the timed call's output
    held to the plain pixels.  ``plain_cache`` gets the plain pixels of
    each fixture by its bytes.  Returns {kernel: row of the textured
    fixture, with the posterised one's row under "posterised"}."""
    import hashlib

    import numpy as np
    import torch
    from simvg_tpu_torch.data import gif, lzw, tiff, vp8, vp8l, webp
    from simvg_tpu_torch.data.image_file import decode_image, image_format

    fixtures = format_fixtures()
    plain_s = {}
    for name, (data, rec) in sorted(fixtures.items()):
        if rec.get("error"):
            for device in ("cuda", "cpu"):
                try:
                    decode_image(data, device)
                except ValueError:
                    continue
                raise AssertionError(f"formats: {name} decoded on {device}, "
                                     "where cv2 reads no image")
            continue
        got = decode_image(data, "cuda")
        t0 = time.perf_counter()
        want = decode_image(data, "cpu")
        plain_s[name] = time.perf_counter() - t0
        plain_cache[data] = want
        if not torch.equal(got.cpu(), want):
            bad = (got.cpu() != want).any(-1).nonzero()[:3].tolist()
            raise AssertionError(f"formats: {name}: the card's route differs "
                                 f"from the plain route at {bad}")
        sha = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        if list(got.shape) != rec["shape"] or sha != rec["sha256"]:
            raise AssertionError(f"formats: {name}: the pixels differ from "
                                 "cv2's")
        # the host stages' C++ against their Python
        kind = image_format(data)
        if kind == "webp":
            f = webp.parse(data)
            mod = vp8l if f.lossless else vp8
            a, b = mod.parse(f.bitstream), mod.decode_host(f.bitstream)
            if f.lossless:
                same = (np.array_equal(a.pixels, b.pixels)
                        and len(a.transforms) == len(b.transforms)
                        and all(x.kind == y.kind and x.xsize == y.xsize
                                and x.bits == y.bits
                                and np.array_equal(x.data, y.data)
                                for x, y in zip(a.transforms, b.transforms)))
            else:
                same = all(np.array_equal(x, y) for x, y in zip(a, b))
        elif kind == "gif":
            g = gif.parse(data)
            n = g.frame[2] * g.frame[3]
            same = lzw.decode_reference(g.lzw_data, lzw.GIF, g.min_code_size,
                                        n) == lzw.decode_host(
                g.lzw_data, lzw.GIF, g.min_code_size, n)
        elif kind == "tiff":
            same = tiff.parse(data, "cuda")[0] == tiff.parse(data, "cpu")[0]
        else:
            same = True
        if not same:
            raise AssertionError(f"formats: {name}: the host stage's C++ "
                                 "differs from its Python")
    n_ok = len(plain_s)
    # every lossy WebP codes the normal loop filter: its frame also forced
    # to none and to the simple filter, the card's route against the plain
    forced = []
    for name, (data, _) in sorted(fixtures.items()):
        if not name.startswith("webp_lossy"):
            continue
        fr = vp8.host_stage(webp.parse(data).bitstream, "cuda")
        planes = vp8.reconstruct_unfiltered(fr)
        for filter_type in (0, 1):
            fr_t = fr._replace(filter_type=filter_type)
            y, u, v = (p.copy() for p in planes)
            vp8.loop_filter(fr_t, y, u, v)
            want = torch.from_numpy(
                vp8.to_bgr_reference(y, u, v, fr.width, fr.height))
            if not torch.equal(vp8.pixel_stage(fr_t, "cuda").cpu(), want):
                raise AssertionError(f"formats: {name} with loop filter "
                                     f"{filter_type}: the card's route "
                                     "differs from the plain route")
            forced.append(f"{name}:{filter_type}")
    predictor = predictor_kernels(card)
    rows = {}
    for kernel, names in FORMAT_TIMED.items():
        host, pixels = _stages(kernel)
        timed = []
        for name in names:
            data = fixtures[name][0]
            parsed = host(data, "cuda")
            t0 = time.perf_counter()
            for _ in range(5):
                host(data, "cuda")
            host_ms = (time.perf_counter() - t0) * 200
            run = lambda: pixels(parsed, "cuda")  # noqa: E731
            got, want = run().cpu(), plain_cache[data]
            if not torch.equal(got, want):
                raise AssertionError(f"formats: {kernel}'s timed call on "
                                     f"{name} differs from the plain route")
            err = (got.int() - want.int()).abs().max().item()
            ms = cuda_ms(run, 20)
            split = kernel_split_ms(run, 20, _KERNEL_NAMES[kernel],
                                    _kernel_launches(kernel, parsed))
            device_ms = sum(split.values()) if None not in split.values() \
                else None
            bms, by = bound_ms(_bound_bytes(kernel, parsed), 0, "bfloat16")
            timed.append(dict(fixture=name, coded_bytes=len(data),
                              shape=list(want.shape), max_abs_err=err, ms=ms,
                              device_ms=device_ms, host_ms=host_ms,
                              plain_ms=plain_s[name] * 1e3, library_ms=None,
                              bound_ms=bms, bound_by=by, **split))
            log(f"formats: {kernel} on {name}: {timed[-1]} [{card}]")
        rows[kernel] = dict(timed[0], posterised=timed[1])
    rows["image_convert"].update(
        predictor, notes="library_ms: the row's pixel stage, for which no "
        "PyTorch call exists; predictor_library_ms: the predictor kernel's "
        "yardstick, torch.cumsum on the same segments")
    big = {n: round(plain_s[n] * 1e3, 1) for n in plain_s if "_big" in n}
    log(f"formats: the card's route equals the plain route and cv2's digest "
        f"on {n_ok} fixtures ({len(fixtures) - n_ok} broken ones raise on "
        f"both), and the plain route on {len(forced)} lossy WebP frames with "
        f"the loop filter forced to none or simple; host stages' C++ equal "
        f"their Python; the plain route's ms "
        f"on the 480 x 640 fixtures {big} [{card}]")
    return rows


def formats_dataset(root, opts):
    """The synthetic val images replaced by the 480 x 640 WebP fixtures
    (textured and posterised, lossy and lossless, in turn) under
    ``root``/webp_synth, with the same names and annotations; returns the
    --cfg-options of that copy."""
    fixtures = format_fixtures()
    files = [fixtures[n][0] for k in ("vp8", "vp8l")
             for n in FORMAT_TIMED[k]]
    imgdir = dict(o.split("=", 1) for o in opts)["data.train.imgsfile"]
    ann = dict(o.split("=", 1) for o in opts)["data.train.annsfile"]
    out = os.path.join(root, "webp_synth", "images")
    os.makedirs(out)
    for i, name in enumerate(sorted(os.listdir(imgdir))):
        with open(os.path.join(out, name), "wb") as f:
            f.write(files[i % len(files)])
    return synth_options(out, ann)


def formats_phase(card, root, opts, launches):
    """The kernels against their plain versions (``formats_kernels``), then
    the main paths that take these formats, each with the kernels'
    launches counted from 0: the flagship's val loader over a WebP copy of
    the synthetic images (every batch equal, bit for bit, to the batch of
    the plain route's pixels), and the server on det_best answering one
    request of each format with 200 and exactly the answer it gives a PNG
    of the plain route's pixels (the server pads every device batch to
    BATCH rows, so a row's answer does not depend on its batch mates), and
    JPEG 2000, AVIF and OpenEXR with 400.  A direct batch-1 eval step is
    not the reference here: on an H100, bf16 at batch 1 against the
    served batch of 8 moved a mid-range score by 2.5e-3 (a score of 0.0096
    on the Sun raster fixture), over "serve"'s 1e-3, which holds on the
    synthetic JPEGs because their scores saturate near 1.  Returns {kernel: row}
    with each row's main-path launches."""
    import base64
    import threading

    import torch
    from simvg_tpu_torch.config import Config, parse_cfg_options
    from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                              build_loader_from_cfg)
    from simvg_tpu_torch.data.image_file import decode_image
    from simvg_tpu_torch.data.image_ops import collate_images
    from simvg_tpu_torch.tools import serve as serve_cli

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from util_torch_port import write_png

    plain_cache = {}
    rows = formats_kernels(card, plain_cache)

    def plain(data):  # the plain route's pixels, on the card
        if data not in plain_cache:
            plain_cache[data] = decode_image(data, "cpu")
        return plain_cache[data].cuda()

    cfg = Config.fromfile(FLAGSHIP)
    cfg.merge_from_dict(parse_cfg_options(formats_dataset(root, opts)))
    ds = build_dataset_from_cfg(cfg.data.val, dataset_type=cfg.dataset,
                                seed=cfg.seed)
    loader = build_loader_from_cfg(ds, cfg, train=False, canvas=cfg.img_size,
                                   seed=cfg.seed, device="cuda")
    torch.cuda.synchronize()
    _zero_launches()
    batches = list(loader)
    torch.cuda.synchronize()
    loader_launches = _launch_counts()
    for (idx, _), batch in zip(loader._index_batches(), batches):
        idx = (idx * loader.bs)[:loader.bs]  # the loader's wrap-padding
        samples = [ds[i] for i in idx]
        want = collate_images(samples, cfg.img_size, "cuda",
                              [plain(s["img_bytes"]) for s in samples])
        if not torch.equal(batch["image"], want):
            raise AssertionError("formats: a WebP loader batch differs from "
                                 "the plain route's")
    if loader_launches["vp8"] + loader_launches["vp8l"] != \
            len(batches) * loader.bs or not loader_launches["vp8"] \
            or not loader_launches["vp8l"]:
        raise AssertionError(f"formats: {loader_launches} launches for "
                             f"{len(batches)} batches of {loader.bs}")

    fixtures = format_fixtures()
    served = sorted(n for n in fixtures if "_big" in n) + [
        "pnm_pfm_le.pnm", "tiff_tiles_planar_pred2.tif"]

    def request(data, i):
        return {"image_b64": base64.b64encode(data).decode(),
                "expression": f"the green box number {i}", "all": True}

    reqs = [request(fixtures[n][0], i) for i, n in enumerate(served)]
    # the twins: a PNG of each request's plain-route pixels
    twins = [request(write_png(plain(fixtures[n][0]).cpu().numpy()[..., ::-1]),
                     i) for i, n in enumerate(served)]
    det_best = os.path.join(root, "work", "det_best")
    server = serve_cli.build_server([FLAGSHIP, "--checkpoint", det_best,
                                     "--port", "0", "--max-batch",
                                     str(BATCH), "--batch-timeout-ms", "20"])
    thread = threading.Thread(target=server.serve_forever)
    thread.start()
    try:
        torch.cuda.synchronize()
        _zero_launches()
        results = serve_burst(server.server_port, reqs)
        torch.cuda.synchronize()
        serve_launches = _launch_counts()
        twin_results = serve_burst(server.server_port, twins)
        refused = {k: _http(server.server_port, "/predict", {
            "image_b64": base64.b64encode(v).decode(),
            "expression": k}) for k, v in FORMAT_REFUSED.items()}
    finally:
        server.close()
        thread.join(timeout=60)
    for k, (status, body) in refused.items():
        if status != 400 or k not in body.get("error", ""):
            raise AssertionError(f"formats: a {k} request gave {status} "
                                 f"{body}")
    if not all(serve_launches.values()):
        raise AssertionError(f"formats: server launches {serve_launches}")
    answers = [{br: out[br] for br in ("token", "decoder")}
               for _, out in results]
    twin_answers = [{br: out[br] for br in ("token", "decoder")}
                    for _, out in twin_results]
    differ = [n for n, a, b in zip(served, answers, twin_answers) if a != b]
    log(f"formats: val loader over {len(ds)} WebP files in {len(batches)} "
        f"batches, each equal to the plain route's batch; the server "
        f"answered {len(reqs)} requests ({served}) with 200, each with "
        f"exactly the boxes and scores of a PNG of the plain route's pixels "
        f"(different: {differ}); scores "
        f"{[round(a['token']['score'], 4) for a in answers]}; JPEG 2000, "
        f"AVIF and OpenEXR with 400; launches: loader {loader_launches}, "
        f"server {serve_launches} [{card}]")
    if differ:
        raise AssertionError(f"formats: served answers of {differ} differ "
                             "from their PNG twins'")
    for k in rows:
        rows[k]["launches"] = loader_launches[k] + serve_launches[k]
    launches.append(sum(r["launches"] for r in rows.values()))
    return rows


def demo_inference_phase(card, root, imgdir, opts, launches):
    """The demo and inference CLIs on the flagship's det_best and the
    synthetic JPEGs: 12 K1 launches each (one image; one val batch); every
    written JPEG decodes with nvJPEG at its source's size; --with-attn
    writes the overlays; the inference boxes equal the eval step's on the
    same loader batch divided by scale_factor."""
    import numpy as np
    import torch
    from simvg_tpu_torch.config import Config, parse_cfg_options
    from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                              build_loader_from_cfg)
    from simvg_tpu_torch.data.jpeg import decode
    from simvg_tpu_torch.engine import make_eval_step
    from simvg_tpu_torch.tools import demo as demo_cli
    from simvg_tpu_torch.tools import inference as inference_cli
    from simvg_tpu_torch.tools.test import serving_model

    det_best = os.path.join(root, "work", "det_best")
    img = os.path.join(imgdir, sorted(os.listdir(imgdir))[-1])
    out = os.path.join(root, "demo_out")
    res = counted_run("demo", lambda: demo_cli.main(
        ["--config", FLAGSHIP, "--checkpoint", det_best, "--img", img,
         "--expression", "the green box", "--output-dir", out]),
        K1_STEP, 0, card, launches)

    def source_hw(path):
        with open(path, "rb") as f:
            return tuple(decode(f.read(), "cuda").shape)

    if source_hw(res["out_file"]) != source_hw(img):
        raise AssertionError(f"demo wrote {source_hw(res['out_file'])}")
    vis = os.path.join(root, "inference_out")
    n_val = N_SYNTH_VAL
    records = counted_run("inference", lambda: inference_cli.main(
        [FLAGSHIP, det_best, "--output-dir", vis, "--with-attn",
         "--max-images", str(n_val), "--cfg-options", *opts]),
        K1_STEP, 0, card, launches)
    written = sorted(f for f in os.listdir(vis) if f.endswith(".jpg"))
    attn = [f for f in written if f.endswith("_attn.jpg")]
    if not (len(records) == len(attn) == n_val
            and len(written) == 2 * n_val):
        raise AssertionError(f"inference wrote {written}")
    shapes = {source_hw(os.path.join(vis, f)) for f in written}
    if shapes != {JPEG_HW + (3,)}:
        raise AssertionError(f"inference JPEGs decode to {shapes}")
    cfg = Config.fromfile(FLAGSHIP)
    cfg.merge_from_dict(parse_cfg_options(opts))
    ds = build_dataset_from_cfg(cfg.data.val, dataset_type=cfg.dataset)
    batch = next(iter(build_loader_from_cfg(ds, cfg, train=False,
                                            canvas=cfg.img_size,
                                            device="cuda")))
    model = serving_model(cfg, det_best, torch.device("cuda"))
    preds = make_eval_step(model)(to_device(batch))["token"]
    want = preds["best_box"].float().cpu().numpy() / batch["scale_factor"]
    got = np.asarray([r["boxes"][0] for r in records], np.float32)
    if not np.array_equal(got, want[:n_val]):
        raise AssertionError(f"inference boxes differ from the eval step's: "
                             f"max {np.abs(got - want[:n_val]).max()}")
    log(f"demo: box {res['box']} score {res['score']:.3f}, "
        f"{os.path.basename(res['out_file'])} decodes at {source_hw(img)}; "
        f"inference: {n_val} images and {len(attn)} attention overlays, "
        f"boxes equal to the eval step's / scale_factor [{card}]")


# int8 w8a8 (ops/quant.py) on the flagship
INT8_CALIB_BATCHES = 4  # of 4 synthetic val JPEGs, through quantize_serving
INT8_LINEARS = 12  # int8 products a layer: q/k/v/out and fc1/fc2, A and B
# The int8 models' outputs, held to the float32 model (plain attention) on
# the same weights: int8 rounds every activation and weight of the 144
# products to 8 bits on a per-tensor / per-channel grid, where bf16 keeps 8
# significant bits per value, so their distance may be INT8_REF_FACTOR
# times the bf16 model's, plus INT8_FLOOR (absolute, on logits and boxes)
INT8_REF_FACTOR = 16.0
INT8_FLOOR = 5e-2
# an fp32 int8_static forward on the card against the same forward on the
# CPU.  Each of its 144 int8 layers, given the card's input, gives the
# card's output on the CPU bit for bit (the same int8 operands, exact int32
# sums, the same elementwise float32 rescale).  The whole forward differs
# more: float32 elsewhere sums in another order, which moves activations
# across a k + 0.5 boundary of their grid (one step ~ s_x * s_w * |w_q|),
# and those steps compound over the 144 products (reading on the card:
# 6.1e-2 max, 7.3e-3 mean on logits and boxes, against int8's own
# 0.06-0.22 max from float32)
INT8_CPU_MAX = 0.25
INT8_CPU_MEAN = 2e-2
INT8_TIMING_ITERS = 20
QAT_STEPS = TRAIN_STEPS


def calibrate(card, root, synth, checkpoint, launches):
    """The port's calibration CLI (tools/quantize_serving.py) on the
    flagship: INT8_CALIB_BATCHES batches of 4 synthetic val JPEGs in
    int8_calib mode, through the eval step's on-device normalisation, on
    ``checkpoint`` (None: random weights from SEED).  Returns the .npz."""
    from simvg_tpu_torch.tools import quantize_serving

    out = os.path.join(root, f"quant_{'det' if checkpoint else 'seed'}.npz")
    argv = [FLAGSHIP] + ([checkpoint] if checkpoint else []) + [
        "--out", out, "--num-batches", str(INT8_CALIB_BATCHES),
        "--cfg-options", *synth,
        f"data.samples_per_gpu={N_SYNTH_VAL // INT8_CALIB_BATCHES}"]
    res = counted_run("int8[calibrate]", lambda: quantize_serving.main(argv),
                      K1_STEP * INT8_CALIB_BATCHES, 0, card, launches)
    if res["calibration_batches"] != INT8_CALIB_BATCHES or res[
            "quantized_layers"] != INT8_LINEARS * K1_STEP:
        raise AssertionError(f"int8[calibrate]: {res}")
    log(f"int8[calibrate]: {res}")
    return out


def kernel_names(fn):
    """The CUDA kernels one call of ``fn`` launches, by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def check_int_mm_exact(model, args, img_shape):
    """Every _int_mm of one forward of ``model``, held to the float64
    product of its operands (exact: |sum| < 2^53); returns the shapes
    (M, K, N) it saw."""
    from simvg_tpu_torch.ops import quant

    real, shapes = quant.int_mm, []

    def exact(a, b):  # int_mm counts its launches on the name it is under
        out = real(a, b)
        if not (out.double() == a.double() @ b.double()).all():
            raise AssertionError(f"_int_mm at {tuple(a.shape)} x "
                                 f"{tuple(b.shape)} is not exact")
        shapes.append((a.shape[0], a.shape[1], b.shape[1]))
        return out

    exact.launches = real.launches
    quant.int_mm = exact
    try:
        outputs(model, args, img_shape)
    finally:
        quant.int_mm = real
        real.launches = exact.launches
    return shapes


def int_mm_rows(card, batch):
    """_int_mm against bf16 F.linear at the flagship's products for
    ``batch``, with the static layer's quantize pass and its whole forward
    against the bf16 Linear's; each row's bound counts the int8 product's
    bytes (operands read once, int32 out written once) and operations.
    Raises if the _int_mm of ``w_q.t()`` copies its operands: a copy
    kernel under the profiler, or K x N bytes allocated beside its
    output."""
    import torch
    import torch.nn.functional as F
    from simvg_tpu_torch.models.layers import Linear
    from simvg_tpu_torch.ops.quant import (Int8Linear, build_quant_collection,
                                           int_mm, set_quant_collection)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for m in (batch * 401, batch * 20):
        for k, n in ((768, 768), (768, 3072), (3072, 768)):
            x = torch.randn(m, k, device="cuda", generator=gen).to(
                torch.bfloat16)
            lin = Linear(k, n, torch.bfloat16).cuda()
            q = torch.nn.Sequential(Int8Linear(k, n, torch.bfloat16,
                                               mode="static")).cuda()
            q.load_state_dict({f"0.{a}": b for a, b in
                               lin.state_dict().items()})
            set_quant_collection(q, build_quant_collection(
                q, {"0.act_amax": x.float().abs().amax()}))
            a = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                              device="cuda", generator=gen)
            w_t = q[0].w_q.t()
            w_bf = lin.weight.to(torch.bfloat16)
            s_x = q[0].act_scale / 127.0
            it = INT8_TIMING_ITERS
            fns = {"int_mm": lambda: int_mm(a, w_t),
                   "bf16 F.linear": lambda: F.linear(x, w_bf),
                   "quantize": lambda: torch.clamp(torch.round(
                       x.float() / s_x), -127, 127).to(torch.int8),
                   "Int8Linear static": lambda: q(x),
                   "Linear bf16": lambda: lin(x)}
            for fn in fns.values():
                fn()
            ms = {name: cuda_ms(fn, it) for name, fn in fns.items()}
            ms.update({f"{name} (again)": cuda_ms(fns[name], it)
                       for name in ("int_mm", "bf16 F.linear")})
            launched = kernel_names(fns["int_mm"])
            bound, by = bound_ms(m * k + k * n + 4 * m * n, 2 * m * k * n,
                                 "int8")
            # what one call allocates beside its int32 output: a copy of the
            # transposed weight would take K x N bytes (readings: 0-416 KiB,
            # under the smallest weight's 576 KiB); the profiler's names are
            # the second witness, where it traces the call
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fns["int_mm"]()
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - before - 4 * m * n
            log(f"int8[int_mm] M={m} K={k} N={n}: "
                + ", ".join(f"{a} {b:.4f} ms" for a, b in ms.items())
                + f"; _int_mm bound {bound:.4f} ms ({by}); one _int_mm "
                f"allocates {extra} bytes beyond its output and launches "
                f"{launched} [{card}]")
            copies = [name for name in launched if any(
                w in name.lower() for w in ("copy", "transpose",
                                            "elementwise"))]
            if copies or extra >= k * n:
                raise AssertionError(f"_int_mm of [{m}, {k}] x w_q.t() "
                                     f"copies its operands: {launched}, "
                                     f"{extra} bytes")


def int8_phase(card, root, synth, launches):
    """int8 w8a8 on the flagship at full width, bf16, K1, random weights
    from SEED: calibration through tools/quantize_serving.py and
    attach_static_quant; every _int_mm of a forward held exactly; the
    int8_static and int8 models' outputs and the bf16 model's against the
    float32 model; an fp32 int8_static forward on the card against the
    CPU; eval medians of bf16, int8 and int8_static at batch 8 and 32 with
    kernels, busy ms, and the _int_mm and K1 launches of a forward;
    _int_mm against bf16 F.linear at each shape; the test CLI and the
    server on det_best with --quant-collection, every response held to a
    direct int8_static step; the exported int8_static program bit for bit
    eager's; 1 + QAT_STEPS int8_qat train steps at batch 32."""
    import threading

    import numpy as np
    import torch
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.engine import (make_eval_step,
                                        normalize_images_on_device)
    from simvg_tpu_torch.export import (attention_op_count, export_serving,
                                        int_mm_op_count)
    from simvg_tpu_torch.models import build_model
    from simvg_tpu_torch.ops.fused_attention import (attention_bwd,
                                                     fused_attention)
    from simvg_tpu_torch.ops.quant import (attach_static_quant, int_mm,
                                           quant_layers)
    from simvg_tpu_torch.tools import serve as serve_cli
    from simvg_tpu_torch.tools import test as test_cli
    from simvg_tpu_torch.tools.test import serving_model

    cfg = Config.fromfile(FLAGSHIP)
    norm = dict(mean=cfg.img_norm_cfg["mean"], std=cfg.img_norm_cfg["std"],
                to_rgb=True)
    det_best = os.path.join(root, "work", "det_best")
    npz = calibrate(card, root, synth, None, launches)

    base, loss_cfg = build_flagship(cfg, "pallas", torch.bfloat16)
    state = base.state_dict()
    models = {"bf16": base}
    for quant in ("int8", "int8_static"):
        models[quant], _ = build_flagship(cfg, "pallas", torch.bfloat16,
                                          state, quant=quant)
    attach_static_quant(models["int8_static"], npz)
    static = models["int8_static"]
    loader = make_requests(np.random.default_rng(SEED), N_BATCHES, BATCH,
                           cfg.model.vis_enc.vocab_size, cfg.max_token,
                           cfg.img_size)

    def model_args(batch):
        dev = to_device(batch)
        image = normalize_images_on_device(dev["image"], norm["mean"],
                                           norm["std"], True,
                                           dev["img_shape"])
        return (image, dev["text_ids"], dev["text_padding_mask"]), \
            dev["img_shape"]

    args0, shape0 = model_args(loader[0])
    shapes = check_int_mm_exact(static, args0, shape0)
    want = {(b * s, k, n) for b in (BATCH,) for s in (401, 20)
            for k, n in ((768, 768), (768, 3072), (3072, 768))}
    if len(shapes) != INT8_LINEARS * K1_STEP or set(shapes) != want:
        raise AssertionError(f"int8: _int_mm calls {len(shapes)} at "
                             f"{sorted(set(shapes))}")
    log(f"int8: {len(shapes)} _int_mm calls of one int8_static forward at "
        f"batch {BATCH}, each equal to the float64 product of its operands;"
        f" shapes (M, K, N) {sorted(set(shapes))}")

    ref32, _ = build_flagship(cfg, "xla", torch.float32, state)
    err = {name: {} for name in models}
    for batch in loader:
        args, img_shape = model_args(batch)
        ref = outputs(ref32, args, img_shape)
        for name, m in models.items():
            for k, d in max_diffs(outputs(m, args, img_shape), ref).items():
                err[name][k] = max(err[name].get(k, 0.0), d)
    del ref32
    log(f"int8: outputs on {len(loader)} batches of {BATCH}, max abs "
        f"distance from the float32 plain model: " + "; ".join(
            f"{name} {e}" for name, e in err.items())
        + f" (bound for int8 and int8_static: {INT8_REF_FACTOR} x bf16's + "
        f"{INT8_FLOOR})")
    bad = [(name, k) for name in ("int8", "int8_static") for k in err[name]
           if not err[name][k] <= INT8_REF_FACTOR * err["bf16"][k]
           + INT8_FLOOR]
    if bad:
        raise AssertionError(f"int8 outputs {bad} beyond the bound")

    # fp32 int8_static on the card against the CPU, batch 2
    outs, fp32 = {}, {}
    for device in ("cuda", "cpu"):
        m, _ = build_model(dict(cfg.model, vis_enc=dict(
            cfg.model.vis_enc, quant="int8_static")), img_size=cfg.img_size,
            dtype=torch.float32, device="meta")
        m = m.to_empty(device=device)
        m.load_state_dict(state, strict=True)
        fp32[device] = attach_static_quant(m, npz).eval()
    seen = {}
    hooks = [layer.register_forward_hook(
        lambda mod, inp, out, name=name: seen.__setitem__(
            name, (inp[0].cpu(), out.cpu())))
        for name, layer in quant_layers(fp32["cuda"]).items()]
    for device, m in fp32.items():
        with torch.inference_mode():
            out = m(*(t[:2].to(device) for t in args0),
                    img_shape=shape0[:2].to(device))
        outs[device] = {k: out[k].float().cpu() for k in OUT_SHAPES}
    for h in hooks:
        h.remove()
    cpu_layers = quant_layers(fp32["cpu"])
    with torch.inference_mode():
        unequal = [name for name, (x, y) in seen.items()
                   if not torch.equal(cpu_layers[name](x), y)]
    del fp32
    diff = torch.cat([(outs["cuda"][k] - outs["cpu"][k]).abs().flatten()
                      for k in OUT_SHAPES])
    log(f"int8: fp32 int8_static at batch 2, the card against the CPU: "
        f"{len(seen) - len(unequal)} of {len(seen)} int8 layers give the "
        f"card's output on the card's input bit for bit; the whole forward's "
        f"outputs max |diff| {diff.max().item():.3e} (bound {INT8_CPU_MAX}), "
        f"mean {diff.mean().item():.3e} (bound {INT8_CPU_MEAN})")
    if unequal or len(seen) != INT8_LINEARS * K1_STEP or not (
            diff.max() <= INT8_CPU_MAX and diff.mean() <= INT8_CPU_MEAN):
        raise AssertionError(f"fp32 int8_static differs between the card and "
                             f"the CPU: layers {unequal[:4]}")

    steps = {name: make_eval_step(m, device_norm=norm)
             for name, m in models.items()}
    for name, step in steps.items():
        step(to_device(loader[0]))  # warm-up
        int_mm.launches = 0
        counted_run(f"int8[{name} forward]", lambda: step(to_device(
            loader[0])), K1_STEP, 0, card, launches)
        want_mm = 0 if name == "bf16" else INT8_LINEARS * K1_STEP
        if int_mm.launches != want_mm:
            raise AssertionError(f"int8: {name} launched _int_mm "
                                 f"{int_mm.launches} times a forward")
        log(f"int8: {name} forward: _int_mm launches {int_mm.launches}, K1 "
            f"launches {K1_STEP}")
    rng = np.random.default_rng(SEED + 2)
    for b, reqs in ((BATCH, loader), (TRAIN_BATCH, make_requests(
            rng, 1, TRAIN_BATCH, cfg.model.vis_enc.vocab_size,
            cfg.max_token, cfg.img_size))):
        lat = time_eval(steps, reqs)
        dev = to_device(reqs[0])
        for name, ts in lat.items():
            ms = ts[len(ts) // 2]
            n_kernels, busy = device_kernels(lambda: steps[name](dev))
            log(f"int8: eval forward, batch {b}, {name}: median {ms:.3f} "
                f"ms/batch ({b / ms * 1e3:.1f} images/s), min {ts[0]:.3f}, "
                f"max {ts[-1]:.3f}, {len(ts)} batches; one call under the "
                f"profiler: {n_kernels} kernels, device busy {busy:.3f} ms "
                f"[{card}]")
    int_mm_rows(card, TRAIN_BATCH)

    # the dynamic scale is a max over the whole batch: a request's answer
    # depends on its batch mates, the static one's does not
    one = {k: v[:1] for k, v in to_device(loader[0]).items()}
    dep = {}
    for name in ("int8", "int8_static"):
        full = steps[name](to_device(loader[0]))["token"]["best_box"][0]
        dep[name] = (steps[name](one)["token"]["best_box"][0]
                     - full).abs().max().item()
    log(f"int8: request 0's token box alone against in its batch of "
        f"{BATCH}, max |diff| (px): {dep}")

    export_batch = to_device(loader[0])
    prog = export_serving(static, export_batch, device_norm=norm)
    nodes = (int_mm_op_count(prog), attention_op_count(prog))
    if nodes != (INT8_LINEARS * K1_STEP, K1_STEP):
        raise AssertionError(f"int8: exported graph holds {nodes} _int_mm "
                             "and K1 nodes")
    prog.call(export_batch)  # warm-up
    out = counted_run("int8[export call]", lambda: prog.call(export_batch),
                      K1_STEP, 0, card, launches)
    ref = steps["int8_static"](export_batch)
    diffs = {f"{br}/{k}": (out[br][k].float() - ref[br][k].float()).abs()
             .max().item() for br in ref for k in ref[br]}
    if any(diffs.values()):
        raise AssertionError(f"exported int8_static differs from eager: "
                             f"{diffs}")
    log(f"int8: the exported int8_static program holds {nodes[0]} _int_mm "
        f"and {nodes[1]} K1 nodes; its outputs equal eager's bit for bit")
    del prog

    # served: the test CLI and the server on det_best
    npz_det = calibrate(card, root, synth, det_best, launches)
    opts = synth + ["model.vis_enc.quant=int8_static"]
    got = counted_run("int8[test CLI]", lambda: test_cli.main(
        [FLAGSHIP, det_best, "--quant-collection", npz_det,
         "--cfg-options", *opts]), K1_STEP * 3, 0, card, launches)
    if got["val"]["n_samples"] != N_SYNTH_VAL or not all(
            np.isfinite(v) for v in got["val"].values()):
        raise AssertionError(f"int8[test CLI]: {got}")
    log(f"int8[test CLI]: det_best int8_static val {got['val']}")
    server = serve_cli.build_server([
        FLAGSHIP, "--checkpoint", det_best, "--port", "0", "--max-batch",
        str(BATCH), "--batch-timeout-ms", "20", "--quant-collection",
        npz_det, "--cfg-options", "model.vis_enc.quant=int8_static"])
    thread = threading.Thread(target=server.serve_forever)
    thread.start()
    reqs = jpeg_requests(os.path.join(root, "synth", "images"))
    try:
        torch.cuda.synchronize()
        server.batcher.batches = 0
        fused_attention.launches = attention_bwd.launches = 0
        results = serve_burst(server.server_port, reqs)
        torch.cuda.synchronize()
        batches = server.batcher.batches
        k1, k2 = fused_attention.launches, attention_bwd.launches
    finally:
        server.close()
        thread.join(timeout=60)
    if (k1, k2) != (K1_STEP * batches, 0):
        raise AssertionError(f"int8[serve]: K1 {k1}, K2 {k2} launches over "
                             f"{batches} device batches")
    launches.append((k1, k2))
    scfg = Config.fromfile(FLAGSHIP)
    scfg.merge_from_dict({"model.vis_enc.quant": "int8_static"})
    box_err, score_err, swapped = held_to_direct(
        results, reqs, serving_model(scfg, det_best, torch.device("cuda"),
                                     quant_collection=npz_det), scfg)
    log(f"int8[serve]: {len(reqs)} requests in {batches} device batches "
        f"(sizes {sorted(out['batch_size'] for _, out in results)}), K1 "
        f"launches {k1}; "
        f"against a direct int8_static step at batch 1, every query: boxes "
        f"max |diff| / canvas {box_err:.2e} (bound {SERVE_BOX_TOL}), scores "
        f"{score_err:.2e} (bound {SERVE_SCORE_TOL}); the next request's "
        f"direct step: boxes min {swapped:.2e}")
    if not (box_err <= SERVE_BOX_TOL and score_err <= SERVE_SCORE_TOL):
        raise AssertionError("served int8_static predictions differ from the"
                             " direct step beyond the bound")

    # int8_qat train steps
    qat, _ = build_flagship(cfg, "pallas", torch.bfloat16, state,
                            quant="int8_qat")
    del models, steps, static, base
    batches = [to_device(b, TRAIN_KEYS) for b in make_requests(
        np.random.default_rng(SEED + 1), QAT_STEPS + 1, TRAIN_BATCH,
        cfg.model.vis_enc.vocab_size, cfg.max_token, cfg.img_size)]
    losses, grads = losses_and_grads(qat, batches[1], loss_cfg, norm)
    dead = [n for n in quant_layers(qat)
            if not grads[f"{n}.weight"].abs().max() > 0]
    if dead or not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"int8_qat: zero gradients {dead[:4]}, losses "
                             f"{losses}")
    del grads
    step, tstate = make_train_step_for(cfg, qat, loss_cfg, norm)
    tstate, _ = step(tstate, batches[0], SEED)  # warm-up

    def train():
        return [step(tstate, b, SEED)[1] for b in batches[1:]]

    scalars = counted_run("int8[qat train]", train, K1_STEP * QAT_STEPS,
                          K1_STEP * QAT_STEPS, card, launches)
    loss = [float(s["loss_total"]) for s in scalars]
    if not np.isfinite(loss).all():
        raise AssertionError(f"int8_qat losses {loss}")
    log(f"int8[qat]: {QAT_STEPS} steps of {TRAIN_BATCH}, loss_total {loss};"
        f" every one of the {len(quant_layers(qat))} encoder Linears has a "
        f"non-zero gradient")
    del qat, step, tstate
    torch.cuda.empty_cache()


LARGE = os.path.join(REPO, "configs", "single", "ViT-large", "refcoco",
                     "refcoco_onestage.py")
REMAT_STEPS = 3  # counted train steps of each mode, after one warm-up


def remat_phase(card, launches):
    """configs/single/ViT-large/refcoco/refcoco_onestage.py as written:
    ViT-large/32 at 640 px (24 layers, D=1024, H=16, S=421), its batch of
    4, bf16 compute, fp32 params, Adam amsgrad, random weights from SEED;
    for remat off, "full" and "dots": the gradients of one batch with the
    config's drop-path from one generator seed, against remat off (bit for
    bit), with the memory that the forward keeps for the backward and the
    peak of both, then 1 + REMAT_STEPS train steps: K1/K2 launches a step, the
    step's median and peak allocated memory.  Returns ({mode: (median ms,
    peak GiB)}, the weights)."""
    import numpy as np
    import torch
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.engine import normalize_images_on_device
    from simvg_tpu_torch.engine.train import train_losses
    from simvg_tpu_torch.models.layers import set_generator
    from simvg_tpu_torch.ops.fused_attention import (attention_bwd,
                                                     fused_attention)

    cfg = Config.fromfile(LARGE)
    batch_size = cfg.data.samples_per_gpu
    norm = dict(mean=cfg.img_norm_cfg["mean"], std=cfg.img_norm_cfg["std"],
                to_rgb=True)
    t0 = time.perf_counter()
    ref, loss_cfg = build_flagship(cfg, "pallas", torch.bfloat16)
    init_s = time.perf_counter() - t0
    enc = ref.cfg.beit3
    layers = enc.num_layers
    state = ref.state_dict()
    batches = [to_device(b, TRAIN_KEYS) for b in make_requests(
        np.random.default_rng(SEED + 3), REMAT_STEPS + 1, batch_size,
        enc.vocab_size, cfg.max_token, cfg.img_size)]
    log(f"remat: {os.path.relpath(LARGE, REPO)}: {layers} layers, "
        f"D={enc.embed_dim}, {enc.num_heads} heads, "
        f"S={enc.seq_vision + cfg.max_token}, batch {batch_size}, remat="
        f"{cfg.model.vis_enc.remat} in the config, drop-path "
        f"{enc.drop_path_rate}; {sum(p.numel() for p in ref.parameters())} "
        f"params, random from seed {SEED} in {init_s:.1f} s")
    del ref

    def grads_of(model):
        """(loss, gradients, GiB that the forward leaves allocated for the
        backward, GiB allocated at the peak of forward and backward, both
        above what was allocated before them)."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model.train()
        set_generator(model, torch.Generator(device="cuda").manual_seed(SEED))
        b = batches[0]
        image = normalize_images_on_device(b["image"], norm["mean"],
                                           norm["std"], True, b["img_shape"])
        losses, _ = train_losses(
            model, b, image,
            branch_loss_weight=loss_cfg["branch_loss_weight"],
            prepare_target_mode=loss_cfg["prepare_target_mode"],
            distill_type=loss_cfg["distill_type"],
            mlp_aux_loss=loss_cfg["mlp_aux_loss"])
        torch.cuda.synchronize()
        saved = torch.cuda.memory_allocated() - before
        grads = torch.autograd.grad(losses["loss_total"],
                                    list(model.parameters()),
                                    allow_unused=True)
        torch.cuda.synchronize()
        return losses["loss_total"].item(), grads, saved / 2 ** 30, (
            torch.cuda.max_memory_allocated() - before) / 2 ** 30

    want, summary = None, {}
    for mode, vis in (("off", dict(remat=False)),
                      ("full", dict(remat=True, remat_policy="full")),
                      ("dots", dict(remat=True, remat_policy="dots"))):
        model, _ = build_flagship(cfg, "pallas", torch.bfloat16, state,
                                  **vis)
        loss, grads, saved_gib, fb_gib = grads_of(model)
        if want is None:
            want = (loss, grads)
        if [g is None for g in grads] != [g is None for g in want[1]]:
            raise AssertionError(f"remat {mode}: other parameters without "
                                 "a gradient")
        diff = max((a - b).abs().max().item()
                   for a, b in zip(grads, want[1]) if a is not None)
        del grads
        step, tstate = make_train_step_for(cfg, model, loss_cfg, norm)
        tstate, _ = step(tstate, batches[0], SEED)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_attention.launches = attention_bwd.launches = 0
        times = []
        for b in batches[1:]:
            t1 = time.perf_counter()
            tstate, scalars = step(tstate, b, SEED)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        k1, k2 = fused_attention.launches, attention_bwd.launches
        launches.append((k1, k2))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want_k1 = (1 if mode == "off" else 2) * layers * REMAT_STEPS
        if (k1, k2) != (want_k1, layers * REMAT_STEPS):
            raise AssertionError(f"remat {mode}: K1 {k1}, K2 {k2} launches "
                                 f"in {REMAT_STEPS} steps")
        if not np.isfinite(float(scalars["loss_total"])):
            raise AssertionError(f"remat {mode}: loss {scalars}")
        times.sort()
        log(f"remat[{mode}]: train step, batch {batch_size}, bf16: median "
            f"{times[len(times) // 2]:.3f} ms/step (min {times[0]:.3f}, max "
            f"{times[-1]:.3f}), max_memory_allocated {peak:.2f} GiB, K1 "
            f"launches a step {k1 // REMAT_STEPS}, K2 {k2 // REMAT_STEPS}; "
            f"forward + backward alone: {saved_gib:.2f} GiB kept for the "
            f"backward, {fb_gib:.2f} GiB at the peak (gradients included), "
            f"above the model; loss {loss}, gradients against remat "
            f"off, max |diff| {diff} (bound 0: the recompute replays the "
            f"forward) [{card}]")
        if loss != want[0] or diff != 0.0:
            raise AssertionError(f"remat {mode}: gradients differ from remat "
                                 "off")
        summary[mode] = (times[len(times) // 2], peak)
        del model, step, tstate
        torch.cuda.empty_cache()
    return summary, state


FSDP8 = os.path.join(REPO, "configs", "single", "ViT-large", "refcoco",
                     "refcoco_onestage_fsdp8.py")


@contextlib.contextmanager
def one_rank_group():
    """torchrun's environment for a 1-rank group on this card (a free port
    on localhost), restored after the body."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dist_phase(card, remat, state, launches):
    """configs/single/ViT-large/refcoco/refcoco_onestage_fsdp8.py as written
    (ViT-large/32 at 640 px, batch 4, bf16 compute, fp32 params, remat on,
    Adam amsgrad; fsdp) under FSDP2 in a 1-rank NCCL group, on the "remat"
    phase's weights: the loss terms and gradients of one batch, dropout
    off, against the unwrapped model's and float32
    (``hold_sharded_against_unwrapped``, every K1/K2 call too); then
    1 + REMAT_STEPS train steps, K1/K2 launches a step, the step's median
    and peak beside the remat phase's unwrapped ones; and one NCCL
    all-reduce of evaluation counters, exact.  A card cannot hold two NCCL
    ranks, so the group has one: the code paths of any size, at full
    width."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.models import build_model
    from torch.distributed.tensor import DTensor
    from simvg_tpu_torch.parallel import (FSDP_MIN_SIZE, create_mesh,
                                          init_distributed, local,
                                          shard_model)

    cfg = Config.fromfile(FSDP8)
    loss_cfg = build_model(cfg.model, img_size=cfg.img_size,
                           device="meta")[1]
    batch_size = cfg.data.samples_per_gpu
    norm = dict(mean=cfg.img_norm_cfg["mean"], std=cfg.img_norm_cfg["std"],
                to_rgb=True)
    min_size = cfg.get("fsdp_min_size", FSDP_MIN_SIZE)
    layers = cfg.model.vis_enc.get("num_layers", 24)
    batches = [to_device(b, TRAIN_KEYS) for b in make_requests(
        np.random.default_rng(SEED + 4), REMAT_STEPS + 1, batch_size,
        cfg.model.vis_enc.vocab_size, cfg.max_token, cfg.img_size)]
    with one_rank_group():
        init_distributed("cuda", timeout=datetime.timedelta(seconds=300))
        try:
            mesh = create_mesh(cfg.get("model_parallel", 1), "cuda")
            log(f"dist: {os.path.relpath(FSDP8, REPO)}: fsdp "
                f"{cfg.fsdp}, fsdp_min_size {min_size}, model_parallel "
                f"{cfg.get('model_parallel', 1)}, remat "
                f"{cfg.model.vis_enc.remat}, batch {batch_size}; a 1-rank "
                f"{dist.get_backend()} group, mesh {mesh.shape}")

            def wrap(model):
                return shard_model(model, mesh, fsdp=True,
                                   fsdp_min_size=min_size)

            hold_sharded_against_unwrapped("fsdp8", cfg, state,
                                           batches[0], loss_cfg, norm, wrap)
            model = build_flagship(cfg, "pallas", torch.bfloat16, state)[0]
            sharded = wrap(model)
            params = list(model.parameters())
            n_sharded = sum(isinstance(p, DTensor) for p in params)
            step, tstate = make_train_step_for(cfg, model, loss_cfg, norm,
                                               sharded=sharded)
            tstate, _ = step(tstate, batches[0], SEED)  # warm-up
            times, box = [], {"state": tstate}

            def steps():
                for b in batches[1:]:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    box["state"], out = step(box["state"], b, SEED)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t1) * 1e3)
                return out

            scalars = counted_run(
                "dist[fsdp8 train]", steps, 2 * layers * REMAT_STEPS,
                layers * REMAT_STEPS, card, launches)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if not np.isfinite(float(scalars["loss_total"])):
                raise AssertionError(f"dist fsdp8: loss {scalars}")
            times.sort()
            off, full = remat["off"], remat["full"]
            log(f"dist[fsdp8]: {n_sharded} of {len(params)} parameters "
                f"sharded (FSDP2), {sum(local(p).numel() for p in params)} "
                f"elements held; train step, batch {batch_size}, bf16: median "
                f"{times[len(times) // 2]:.3f} ms/step (min {times[0]:.3f}, "
                f"max {times[-1]:.3f}), max_memory_allocated {peak:.2f} GiB; "
                f"unwrapped (remat phase): full {full[0]:.3f} ms, "
                f"{full[1]:.2f} GiB; off {off[0]:.3f} ms, {off[1]:.2f} GiB; "
                f"loss_total {float(scalars['loss_total'])}, grad_norm "
                f"{float(scalars['grad_norm'])} [{card}]")
            counters = torch.tensor([13.0, 9.123456789, 16.0, 0.5, 7.0],
                                    dtype=torch.float64)
            summed = sharded.batch_sum(counters)
            if summed.device.type != "cuda" or not torch.equal(
                    summed.cpu(), counters):
                raise AssertionError(f"NCCL all-reduce of eval counters: "
                                     f"{summed} for {counters}")
            log(f"dist: NCCL all-reduce of eval counters on "
                f"{summed.device}: {summed.tolist()}, exact")
            del model, sharded, step, tstate, box
            torch.cuda.empty_cache()
            hold_qat_group_max(card, mesh)
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()


def hold_qat_group_max(card, mesh):
    """int8 scales under data parallelism on one card: the flagship with
    quant="int8_qat" (bf16, K1/K2, random weights from SEED), one batch's
    loss terms and gradients, dropout off, with its int8 layers given the
    1-rank NCCL data group of ``mesh`` (ops/quant.py all-reduces each
    activation max over it, as JAX takes the max over the global batch)
    against the same model with no group, the single-process path: bit
    for bit, since a MAX over one rank is the rank's own."""
    import numpy as np
    import torch
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.ops.quant import quant_layers, set_groups

    cfg = Config.fromfile(FLAGSHIP)
    cfg.merge_from_dict({"model.vis_enc.quant": "int8_qat"})
    model, loss_cfg = build_flagship(cfg, "pallas", torch.bfloat16)
    dropout_off(model)
    norm = dict(mean=cfg.img_norm_cfg["mean"], std=cfg.img_norm_cfg["std"],
                to_rgb=True)
    batch = to_device(make_requests(
        np.random.default_rng(SEED + 9), 1, TRAIN_BATCH,
        model.cfg.beit3.vocab_size, cfg.max_token, cfg.img_size)[0],
        TRAIN_KEYS)
    alone = losses_and_grads(model, batch, loss_cfg, norm)
    set_groups(model, mesh["data"].get_group())
    layers = quant_layers(model)
    if not layers or any(len(m.act_groups) != 1 for m in layers.values()):
        raise AssertionError("int8_qat: the layers did not take the group")
    grouped = losses_and_grads(model, batch, loss_cfg, norm)
    set_groups(model)
    if alone[0] != grouped[0] or any(
            not torch.equal(g, grouped[1][n]) for n, g in alone[1].items()):
        raise AssertionError("int8_qat with the 1-rank group's activation "
                             "max differs from the single-process step")
    log(f"dist: int8_qat at batch {TRAIN_BATCH}, {len(layers)} int8 layers "
        f"taking their activation max over the 1-rank NCCL data group: loss "
        f"terms and gradients bit for bit the single-process step's; "
        f"loss_total {alone[0]['loss_total']} [{card}]")
    del model
    torch.cuda.empty_cache()


def dist_cli_phase(card, root, opts, single_losses):
    """The flagship through the train CLI with ``--distributed`` (DDP in a
    1-rank NCCL group, one epoch on the synthetic JPEGs), its first step's
    loss against the non-distributed CLI run's (the same weights and
    batch); then the test CLI with and without ``--distributed`` on its
    det_best, the same metrics.  Then refcoco_onestage_fsdp8.py as written
    through both CLIs with ``--distributed`` (FSDP2, one epoch of batch 4,
    its checkpoints gathered from the shards): the test CLI's det_acc on
    det_best the train CLI's.  Returns the K1/K2 launches."""
    from simvg_tpu_torch.tools import test as test_cli
    from simvg_tpu_torch.tools import train as train_cli

    wd = os.path.join(root, "work_ddp")
    steps = N_SYNTH_TRAIN // TRAIN_BATCH
    evals = 3
    launches = []
    with one_rank_group():
        res = counted_run("dist[cli train]", lambda: train_cli.main(
            [FLAGSHIP, "--work-dir", wd, "--distributed", "--cfg-options",
             *opts, "scheduler_config.max_epoch=1"]),
            K1_STEP * (steps + evals), K1_STEP * steps, card, launches)
        with open(os.path.join(wd, "metrics.jsonl")) as f:
            losses = [json.loads(line)["loss_total"] for line in f
                      if '"train"' in line]
        rel = abs(losses[0] - single_losses[0]) / abs(single_losses[0])
        log(f"dist[cli train]: DDP, 1 rank: loss_total {losses} (the "
            f"non-distributed run: {single_losses}; first step relative "
            f"difference {rel}); eval {res['eval']['val']}")
        if not rel <= 1e-6:
            raise AssertionError("the distributed train CLI's first loss "
                                 "differs from the non-distributed run's")
        best = os.path.join(wd, "det_best")
        got = counted_run("dist[cli test]", lambda: test_cli.main(
            [FLAGSHIP, best, "--distributed", "--cfg-options", *opts]),
            K1_STEP * evals, 0, card, launches)
    want = test_cli.main([FLAGSHIP, best, "--cfg-options", *opts])
    if got != want:
        raise AssertionError(f"test CLI --distributed {got} != {want}")
    log(f"dist[cli test]: det_best with --distributed: {got['val']}, the "
        f"same as without it")

    from simvg_tpu_torch.config import Config

    wd = os.path.join(root, "work_fsdp8")
    batch = Config.fromfile(FSDP8).data.samples_per_gpu
    layers, steps, evals = 24, N_SYNTH_TRAIN // batch, 3 * N_SYNTH_VAL // batch
    with one_rank_group():
        res = counted_run("dist[fsdp8 cli train]", lambda: train_cli.main(
            [FSDP8, "--work-dir", wd, "--distributed", "--cfg-options", *opts,
             "scheduler_config.max_epoch=1"]),
            layers * (2 * steps + evals), layers * steps, card, launches)
        got = counted_run("dist[fsdp8 cli test]", lambda: test_cli.main(
            [FSDP8, os.path.join(wd, "det_best"), "--distributed",
             "--cfg-options", *opts]), layers * evals, 0, card, launches)
    ep = res["epochs"][0]
    log(f"dist[fsdp8 cli]: FSDP2, 1 rank: {steps} steps of {batch}, epoch "
        f"{ep['seconds']:.2f} s ({ep['images_per_s']:.1f} images/s), eval "
        f"{res['eval']['val']}; det_best {_dir_gib(wd + '/det_best'):.3f} "
        f"GiB, latest {_dir_gib(wd + '/latest'):.3f} GiB; test CLI on "
        f"det_best {got['val']} [{card}]")
    if not (res["step"] == steps
            and got["val"]["det_acc"] == res["eval"]["val"]["det_acc"]):
        raise AssertionError(f"fsdp8 CLIs: step {res['step']}, test "
                             f"{got['val']}, train {res['eval']['val']}")
    return (sum(k1 for k1, _ in launches), sum(k2 for _, k2 in launches))


MULTI_TASK = os.path.join(REPO, "configs", "_base_", "datasets", "multi-task",
                          "refcoco-unc.py")
OPTIMIZERS = {"AdamW": {"weight_decay": 0.05}, "SGD": {}, "RMSProp": {}}
OPTION_STEPS = 3  # counted train steps an optimizer, after one warm-up
# the options: the DETR encoder over the image memory and soft distillation
OPTIONS_CONFIG = """_base_ = [{flagship!r}]
model = dict(head=dict(
    only_decoder=False,
    branch_loss_weight=dict(_delete_=True, decoder=1, token=1, distill=1),
    distill_type="soft"))
"""
OPT_UPDATE_REL = 1e-6  # card vs CPU update, of each tensor's max |value|
NORM_REL = 1e-6  # the card's clip norm against float64's, relative


def options_phase(card, root, flagship_ms, launches):
    """The flagship with ``only_decoder=False`` (a 6-layer DetrEncoder over
    the 400 patch tokens, 256 wide) and soft distillation at full width:
    the eval forward at batch 8 held by the bf16 rule; AdamW, SGD and
    RMSProp each for one warm-up and OPTION_STEPS counted train steps at
    batch 32 (bf16 compute, fp32 params), K1/K2 counted from 0 around each,
    with the step median, peak memory and the soft route's host Hungarian
    round trips; the bf16 rule on one batch's loss terms (the soft terms
    among them) and gradients (the encoder's among them) and on every K1/K2
    call; each optimizer's update on the card, clip on, against the same
    update on the CPU clipped by the float64 norm, and the card's global
    norm against float64's (the CPU's printed beside them, F8); the
    DetrEncoder's ms a forward at batch 32."""
    import numpy as np
    import torch
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.engine import create_optimizer
    from simvg_tpu_torch.engine.train_state import global_norm

    path = os.path.join(root, "options.py")
    with open(path, "w") as f:
        f.write(OPTIONS_CONFIG.format(flagship=FLAGSHIP))
    cfg = Config.fromfile(path)
    model, loss_cfg = build_flagship(cfg, "pallas", torch.bfloat16)
    encoder = model.head.transformer.encoder
    if len(encoder.layers) != 6 or loss_cfg["distill_type"] != "soft":
        raise AssertionError("the options config did not take")
    log(f"options: flagship + DetrEncoder ({len(encoder.layers)} layers, "
        f"{sum(p.numel() for p in encoder.parameters())} params) + soft "
        f"distillation, branch_loss_weight {loss_cfg['branch_loss_weight']}")
    norm = dict(mean=cfg.img_norm_cfg["mean"], std=cfg.img_norm_cfg["std"],
                to_rgb=True)
    vocab = model.cfg.beit3.vocab_size
    reqs = make_requests(np.random.default_rng(SEED + 7), 1, BATCH, vocab,
                         cfg.max_token, cfg.img_size)
    _, times, metrics = counted_run(
        "options[eval]", lambda: serve(model, reqs, norm), K1_STEP, 0, card,
        launches)
    if metrics["n_samples"] != BATCH:
        raise AssertionError(f"options eval counted {metrics}")
    log(f"options[eval]: batch {BATCH}, {times[0]:.2f} ms through evaluate")
    compare_with_plain(cfg, model, reqs, norm)

    batches = [to_device(b, TRAIN_KEYS) for b in make_requests(
        np.random.default_rng(SEED + 8), OPTION_STEPS + 1, TRAIN_BATCH, vocab,
        cfg.max_token, cfg.img_size)]
    rng = torch.Generator().manual_seed(SEED)
    clip = cfg.get("grad_norm_clip", 0.15)
    for name, extra in OPTIMIZERS.items():
        ocfg = copy.deepcopy(cfg)
        ocfg.optimizer_config.update(type=name, **extra)
        step, state = make_train_step_for(ocfg, model, loss_cfg, norm)
        state, _ = step(state, batches[0], SEED)  # warm-up
        ms, history = [], []

        def counted():
            with timed_hungarian() as calls:
                for batch in batches[1:]:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    history.append(step(state, batch, SEED)[1])
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
            return calls

        calls = counted_run(f"options[{name}]", counted,
                            K1_STEP * OPTION_STEPS, K1_STEP * OPTION_STEPS,
                            card, launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        bad = [k for h in history for k, v in h.items()
               if k != "predictions" and not torch.isfinite(v).all()]
        if bad or not history[0]["loss_kd"].item() > 0:
            raise AssertionError(f"options[{name}]: non-finite {bad}")
        ms.sort()
        log(f"options[{name}] train step, batch {TRAIN_BATCH}, bf16: median "
            f"{ms[len(ms) // 2]:.3f} ms (min {ms[0]:.3f}, max {ms[-1]:.3f}; "
            f"the flagship's Adam step {flagship_ms:.3f} ms in this run), "
            f"peak {peak:.2f} GiB; Hungarian host round trips a step "
            f"{len(calls) / OPTION_STEPS} ({len(calls.soft) / OPTION_STEPS} "
            f"of the soft route: {sum(calls.soft) / OPTION_STEPS:.3f} host "
            f"ms a step; all {sum(m for m, _ in calls) / OPTION_STEPS:.3f} "
            f"ms) [{card}]; loss_total "
            f"{[h['loss_total'].item() for h in history]}")
        del state, step
        torch.cuda.empty_cache()

        # one update on the card, clip on, against the same update on the
        # CPU; the CPU's float32 sum of squares over the 49M elements of the
        # text embedding is off by ~1e-3 (F8, ROADMAP), so the CPU clips by
        # the float64 norm, as optax's clip_by_global_norm scales, and runs
        # the optimizer with its clip off on the clipped gradients
        names, params = zip(*[(n, p.detach().float().cpu())
                              for n, p in model.named_parameters()])
        grads = [torch.randn(p.shape, generator=rng) * 1e-3 for p in params]
        norms = [global_norm([g.to(dev) for g in grads]).item()
                 for dev in ("cuda", "cpu")]
        exact = sum(g.double().pow(2).sum().item() for g in grads) ** 0.5
        log(f"options[{name}] global norm of the {len(grads)} gradients: "
            f"card {norms[0]!r}, CPU {norms[1]!r}, float64 {exact!r} "
            f"(relative errors {abs(norms[0] - exact) / exact:.2e}, "
            f"{abs(norms[1] - exact) / exact:.2e}; bound on the card's "
            f"{NORM_REL}), clip {clip}")
        if not (abs(norms[0] - exact) / exact <= NORM_REL and exact > clip):
            raise AssertionError(f"{name}: the card's global norm is off, or "
                                 "the clip would not act")
        opt, ref = (create_optimizer(
            ocfg.lr, STEPS_PER_EPOCH, optimizer_type=name, amsgrad=True,
            grad_norm_clip=c, **extra) for c in (clip, 0.0))
        norm64 = torch.tensor(exact, dtype=torch.float32)
        scale = torch.where(norm64 < clip, 1.0, clip / norm64)
        out = {}
        for dev, o in (("cuda", opt), ("cpu", ref)):
            p = [t.to(dev, copy=True) for t in params]
            g = [t.to(dev, copy=True) for t in grads]
            if dev == "cpu":
                torch._foreach_mul_(g, scale)
            o.apply(names, p, g, o.init(p))
            out[dev] = p
        rel = [((a.cpu() - b).abs().max() / b.abs().max().clamp_min(
            1e-30)).item() for a, b in zip(out["cuda"], out["cpu"])]
        worst = max(rel)
        i = rel.index(worst)
        d = (out["cuda"][i].cpu() - out["cpu"][i]).abs().flatten()
        j = int(d.argmax())
        log(f"options[{name}] one update of {len(params)} fp32 tensors, card "
            f"vs CPU: max |difference| / max |tensor| {worst:.3e} (bound "
            f"{OPT_UPDATE_REL}) at {names[i]}: card "
            f"{out['cuda'][i].flatten()[j].item()!r}, CPU "
            f"{out['cpu'][i].flatten()[j].item()!r}, before "
            f"{params[i].flatten()[j].item()!r}, grad "
            f"{grads[i].flatten()[j].item()!r}, max |tensor| "
            f"{out['cpu'][i].abs().max().item()!r}")
        if not worst <= OPT_UPDATE_REL:
            raise AssertionError(f"{name}: the card's update differs from "
                                 "the CPU's")
        del out, params, grads

    hold_train_against_plain("options", cfg, model.state_dict(), batches[1],
                             loss_cfg, norm)
    memory = torch.randn(TRAIN_BATCH, 400, 256, device="cuda",
                         dtype=torch.bfloat16)
    pos = torch.randn_like(memory)
    pad = torch.zeros(TRAIN_BATCH, 400, dtype=torch.bool, device="cuda")
    pad[:, 380:] = True
    with torch.inference_mode():
        enc_ms = cuda_ms(lambda: encoder(memory, query_pos=pos,
                                         key_padding_mask=pad), 10)
    log(f"options: DetrEncoder forward, batch {TRAIN_BATCH}, 400 tokens, "
        f"bf16: {enc_ms:.3f} ms [{card}]")
    del model
    torch.cuda.empty_cache()


MASK_SHIFT = 3  # columns the shifted-mask producer moves each GT mask


def masks_phase(card, root, opts, launches):
    """The mask path at 640 px on the synthetic JPEGs: the data phase's
    annotations with a ``mask`` each (concave polygons, two-part crowd
    polygons, RLE rings), the flagship model with the multi-task pipeline
    (configs/_base_/datasets/multi-task/refcoco-unc.py: with_bbox and
    with_mask, SampleMaskVertices, the word-vocab tokenizer) through the
    train CLI (1 epoch) and the test CLI on its det_best, K1/K2 counted;
    a loader batch's meta and its samples' vertices against the same
    samples through the CPU route; ``evaluate`` with a step that adds
    ``pred_masks``: the GT masks (mask mIoU 100) and masks shifted by
    MASK_SHIFT columns (the IoU computed here); host ms per sample with
    masks and without."""
    import numpy as np
    import torch
    from simvg_tpu_torch.config import Config, parse_cfg_options
    from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                              build_loader_from_cfg)
    from simvg_tpu_torch.engine import evaluate
    from simvg_tpu_torch.ops import rle as rle_ops
    from simvg_tpu_torch.tools import test as test_cli
    from simvg_tpu_torch.tools import train as train_cli
    from simvg_tpu_torch.tools.make_synth_data import add_masks

    ann = next(o.split("=", 1)[1] for o in opts if "annsfile" in o)
    masked = os.path.join(root, "instances_masks.json")
    shutil.copy(ann, masked)
    add_masks(masked)
    mopts = [o.split("=")[0] + "=" + masked if "annsfile" in o else o
             for o in opts]
    base = Config.fromfile(MULTI_TASK)
    path = os.path.join(root, "masks.py")
    with open(path, "w") as f:
        f.write(f"_base_ = [{FLAGSHIP!r}]\n"
                f"train_pipeline = {base.train_pipeline!r}\n"
                f"test_pipeline = {base.test_pipeline!r}\n"
                "data = dict(" + ", ".join(
                    f"{s}=dict(pipeline={p}_pipeline)" for s, p in
                    (("train", "train"), ("val", "test"), ("testA", "test"),
                     ("testB", "test"))) + ")\n")
    cfg = Config.fromfile(path)
    cfg.merge_from_dict(parse_cfg_options(mopts))
    wd = os.path.join(root, "masks_work")
    steps, evals = N_SYNTH_TRAIN // TRAIN_BATCH, 3

    res = counted_run("masks[train CLI]", lambda: train_cli.main(
        [path, "--work-dir", wd, "--cfg-options", *mopts,
         "scheduler_config.max_epoch=1"]),
        K1_STEP * (steps + evals), K1_STEP * steps, card, launches)
    got = counted_run("masks[test CLI]", lambda: test_cli.main(
        [path, os.path.join(wd, "det_best"), "--cfg-options", *mopts]),
        K1_STEP * evals, 0, card, launches)
    if got["val"]["det_acc"] != res["eval"]["val"]["det_acc"]:
        raise AssertionError(f"masks: test CLI {got['val']} against the "
                             f"train CLI's {res['eval']['val']}")
    log(f"masks[CLIs]: {res['step']} steps, eval {res['eval']['val']}; test "
        f"CLI on det_best the same det_acc")

    # a loader batch on the card against the same samples computed here
    ds = build_dataset_from_cfg(cfg.data.train, dataset_type=cfg.dataset,
                                seed=cfg.seed, normalize_on_device=True)
    loader = build_loader_from_cfg(ds, cfg, train=True, canvas=cfg.img_size,
                                   seed=cfg.seed, device="cuda")
    idx, _ = loader._index_batches()[0]
    idx = (idx * loader.bs)[:loader.bs]
    batch = next(iter(loader))
    t0 = time.perf_counter()
    samples = [ds[i] for i in idx]
    mask_ms = (time.perf_counter() - t0) * 1e3 / len(idx)
    again = [ds[i] for i in idx[:4]]
    for m, s, s2 in zip(batch["meta"], samples, samples[:4] + [None] * 64):
        if m["gt_mask_rle"] != s["gt_mask_rle"] or \
                m["is_crowd"] != s["is_crowd"]:
            raise AssertionError("masks: the loader's meta differs from "
                                 "the sample")
        if s2 is not None and not all(np.array_equal(s[k], s2[k]) for k in (
                "gt_mask_vertices", "mass_center", "gt_mask")):
            raise AssertionError("masks: a sample's vertices differ between "
                                 "two reads")
    plain = build_dataset_from_cfg(
        Config.fromfile(FLAGSHIP).data.train | {
            "annsfile": masked, "imgsfile": cfg.data.train.imgsfile},
        dataset_type=cfg.dataset, seed=cfg.seed, normalize_on_device=True)
    t0 = time.perf_counter()
    for i in idx:
        plain[i]
    box_ms = (time.perf_counter() - t0) * 1e3 / len(idx)
    crowd = sorted({s["is_crowd"] for s in samples})
    log(f"masks[host]: {len(idx)} samples, meta and vertices as computed "
        f"directly (is_crowd values {crowd}); host ms per sample with masks "
        f"{mask_ms:.2f}, the flagship's box-only pipeline {box_ms:.2f} "
        f"[{card}]")

    # evaluate with a step that adds pred_masks
    from simvg_tpu_torch.engine import make_eval_step
    from simvg_tpu_torch.models import build_model, init_random_weights

    model, _ = build_model(cfg.model, img_size=cfg.img_size,
                           dtype=torch.bfloat16)
    init_random_weights(model, SEED)
    norm = next(dict(op, to_rgb=True) for op in cfg.data.val.pipeline
                if op["type"] == "Normalize")
    norm.pop("type")
    step = make_eval_step(model, device_norm=norm)
    vds = build_dataset_from_cfg(cfg.data.val, dataset_type=cfg.dataset,
                                 seed=cfg.seed, normalize_on_device=True)
    vloader = build_loader_from_cfg(vds, cfg, train=False,
                                    canvas=cfg.img_size, seed=cfg.seed,
                                    device="cuda")
    for shift in (0, MASK_SHIFT):
        want, current = [], {}

        def batches():
            for b in vloader:
                current.update(meta=b["meta"], valid=b["batch_valid"])
                yield b

        def with_masks(device_batch):
            preds = step(device_batch)
            masks = []
            for m, valid in zip(current["meta"], current["valid"]):
                gt = rle_ops.decode(m["gt_mask_rle"])
                pred = np.roll(gt, shift, axis=1)
                masks.append(rle_ops.encode(pred))
                inter = float((gt & pred).sum())
                den = float(pred.sum() if m["is_crowd"] else (gt | pred).sum())
                if valid:
                    want.append(inter / den if den else 0.0)
            for p in preds.values():
                p["pred_masks"] = masks
            return preds

        out = counted_run(
            f"masks[evaluate, shift {shift}]",
            lambda: evaluate(model, batches(), eval_step=with_masks),
            K1_STEP * len(vloader), 0, card, launches)
        if len(want) != out["n_samples"] or not want:
            raise AssertionError(f"masks: {len(want)} IoUs for "
                                 f"{out['n_samples']} samples")
        expect = float(np.mean(want)) * 100.0
        log(f"masks[evaluate], pred_masks = GT shifted {shift} columns: "
            f"decoder_mask_miou {out['decoder_mask_miou']}, token "
            f"{out['token_mask_miou']}, miou {out['miou']} (computed here: "
            f"{expect}), acc@0.5 {out['decoder_mask_acc@0.5']}")
        if not (abs(out["miou"] - expect) <= 1e-9 * max(expect, 1.0)
                and (shift or out["miou"] == 100.0)):
            raise AssertionError(f"masks: evaluate's mask mIoU {out['miou']}"
                                 f", expected {expect}")
    del model
    torch.cuda.empty_cache()


ONESTAGE = os.path.join(REPO, "configs", "smoke", "tiny_synth_onestage.py")
# the OneStageModel family at the JAX modules' own widths (no shipped config
# sets them): DarkNet53 with the reference darknet.py's blocks (1, 2, 8, 8,
# 4) and widths (64 ... 1024) at 640 px, the bidirectional GRU encoder
# (embedding 300, hidden 512, "original" output) over the tiny config's
# 1000-word table, the fusion 256 wide with 8 heads, and the DETR head at
# its defaults (100 queries, 6 encoder and 6 decoder layers) on the
# fusion's 256 channels
ONESTAGE_FULL = """_base_ = [{tiny!r}]
img_size = 640
max_token = 20
model = dict(
    vis_enc=dict(_delete_=True, type="DarkNet53"),
    lan_enc=dict(_delete_=True, type="LSTM", vocab_size=1000),
    fusion=dict(_delete_=True, type="SimpleFusionv2"),
    head=dict(_delete_=True, type="DETRHead", in_channels=256,
              branch_loss_weight=dict(decoder=1.0)),
)
"""
ONESTAGE_STEPS = 3  # counted bf16 train steps, after one warm-up
# The card's float32 step (TF32 off) on one batch of BATCH against the
# CPU's: the head's outputs, the loss terms and every gradient, each as
# its distance from the same step in float64 on the CPU (max |difference|
# over the float64 tensor's max |value|).  The card may be at most
# ONESTAGE_FACTOR times as far from float64 as the CPU, plus ONESTAGE_FLOOR.
# Against each other the two float32 steps differ by up to 1.7e-4 on the
# outputs and 14% on the backbone's GroupNorm gradients (H100 80GB HBM3):
# each GroupNorm's input gradient sums to 0 over its group, so a
# parameter's gradient upstream of one is a sum of terms that cancel, and
# float32 rounding is what is left of it.  The card's own float64 step
# must equal the CPU's within ONESTAGE_F64 of each tensor's max, so the
# card's code path is held to the CPU's where rounding cannot hide a fault.
# That needs the float64 model to stay float64 end to end
# (tests/test_torch_onestage.py::test_float64_step_stays_float64); the two
# float64 steps are then 2.0e-8 apart on the backbone's conv weight
# gradients (H100 80GB HBM3), four orders under the card's float32 4e-4
ONESTAGE_FACTOR = 2.0
ONESTAGE_FLOOR = 1e-5
ONESTAGE_F64 = 1e-7


def onestage_setup(root, synth):
    """ONESTAGE_FULL's config, its image normalisation and
    ``requests(seed, n, batch)``: ``make_requests`` batches whose text is
    the word-vocab tokenizer's ids of the synthetic annotations'
    expressions."""
    import numpy as np
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.data.tokenization import (build_tokenizer,
                                                   build_word_vocab)

    path = os.path.join(root, "onestage_full.py")
    with open(path, "w") as f:
        f.write(ONESTAGE_FULL.format(tiny=ONESTAGE))
    cfg = Config.fromfile(path)
    ann = next(o.split("=", 1)[1] for o in synth
               if o.startswith("data.train.annsfile="))
    with open(ann) as f:
        anns = json.load(f)
    tok = build_tokenizer("default", token2idx=build_word_vocab(anns))
    exprs = [e for a in anns["train"] for e in a["expressions"]]
    norm = dict(mean=cfg.img_norm_cfg["mean"], std=cfg.img_norm_cfg["std"],
                to_rgb=True)

    def requests(seed, n, batch):
        reqs = make_requests(np.random.default_rng(seed), n, batch, 2,
                             cfg.max_token, cfg.img_size)
        for i, r in enumerate(reqs):
            ids = np.stack([tok.encode(exprs[(i * batch + j) % len(exprs)],
                                       cfg.max_token)[0]
                            for j in range(batch)]).astype(np.int64)
            r.update(text_ids=ids, text_padding_mask=(ids == 0).astype(
                np.int64))
        return reqs

    return cfg, norm, requests


def onestage_phase(card, root, synth, launches):
    """The OneStageModel family at full width (ONESTAGE_FULL) on random
    flax-style weights from SEED and text from the word-vocab tokenizer
    over the synthetic annotations: the fp32 forward, loss terms and
    gradients of one batch of BATCH on the card and the CPU (dropout
    off), each held to the CPU's float64 step by the ONESTAGE_FACTOR rule,
    and the card's float64 step to the CPU's within ONESTAGE_F64; the bf16
    train step at batch TRAIN_BATCH (one warm-up, ONESTAGE_STEPS counted:
    median ms, peak memory) and the eval step at batch BATCH and
    TRAIN_BATCH; then ``tiny_synth_onestage.py`` through the port's train CLI (1 epoch) and
    test CLI on the synthetic JPEGs.  No K1 or K2 is on this path."""
    import torch
    from simvg_tpu_torch.engine import (make_eval_step,
                                        normalize_images_on_device)
    from simvg_tpu_torch.models import build_model, init_random_weights
    from simvg_tpu_torch.tools import test as test_cli
    from simvg_tpu_torch.tools import train as train_cli

    cfg, norm, requests = onestage_setup(root, synth)

    def model_on(device, dtype):
        model, loss_cfg = build_model(cfg.model, img_size=cfg.img_size,
                                      dtype=dtype, device=device)
        return init_random_weights(model, SEED), loss_cfg

    # 1. float32 on the card and on the CPU, each against the CPU's float64
    (batch,) = requests(SEED + 30, 1, BATCH)
    got = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                       ("cpu", torch.float64), ("cuda", torch.float64)):
        t0 = time.perf_counter()
        model, loss_cfg = model_on(dev, dtype)
        dropout_off(model.to(dtype))
        b = {k: torch.as_tensor(batch[k]).to(dev) for k in TRAIN_KEYS}
        image = normalize_images_on_device(b["image"], norm["mean"],
                                           norm["std"], True, b["img_shape"])
        with torch.no_grad():
            out = model.eval()(image, b["text_ids"], b["text_padding_mask"])
        losses, grads = losses_and_grads(model, b, loss_cfg, norm)
        got[dev, dtype] = dict(
            {f"out {k}": out[k].double().cpu() for k in ("class_decoder",
                                                         "bbox_decoder")},
            **{f"loss {k}": torch.tensor(v, dtype=torch.float64)
               for k, v in losses.items()},
            **{f"grad {n}": g.double().cpu() for n, g in grads.items()})
        log(f"onestage[{str(dtype)[6:]} {dev}]: forward, loss and "
            f"gradients of a batch of {BATCH} in "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
        del model, grads
    if loss_cfg["prepare_target_mode"] != "score_iou_weighted":
        raise AssertionError(f"loss settings {loss_cfg}")
    on_card, on_cpu, ref, card64 = (got[k] for k in (
        ("cuda", torch.float32), ("cpu", torch.float32),
        ("cpu", torch.float64), ("cuda", torch.float64)))
    n_params = sum(v.numel() for k, v in ref.items() if k[:4] == "grad")
    top = max(v.abs().max().item() for k, v in ref.items() if k[:4] == "grad")

    def scale(k):  # a gradient that is 0 in exact arithmetic (the frozen
        # word table, the fusion's key bias) is measured against the largest
        s = ref[k].abs().max().item()
        return top if k[:4] == "grad" and s < 1e-6 * top else max(s, 1e-30)

    rows = {k: tuple((a[k] - b[k]).abs().max().item() / scale(k)
                     for a, b in ((on_card, ref), (on_cpu, ref),
                                  (on_card, on_cpu), (card64, ref)))
            for k in ref}
    bad = {k: r for k, r in rows.items()
           if not (r[0] <= ONESTAGE_FACTOR * r[1] + ONESTAGE_FLOOR
                   and r[3] <= ONESTAGE_F64)}
    worst = sorted(rows.items(), key=lambda kv: -kv[1][2])[:5]
    worst64 = sorted(rows.items(), key=lambda kv: -kv[1][3])[:3]
    losses = {k[5:]: v.item() for k, v in on_cpu.items() if k[:4] == "loss"}
    log(f"onestage[fp32 card vs CPU]: {n_params} params, loss terms "
        f"{losses}; "
        f"card float64 vs CPU float64: at most "
        f"{max(r[3] for r in rows.values()):.2e} (bound {ONESTAGE_F64}; "
        + ", ".join(f"{k} {r[3]:.2e}" for k, r in worst64) + "); "
        f"distance from the CPU's float64 (card, CPU; rule card <= "
        f"{ONESTAGE_FACTOR} x CPU + {ONESTAGE_FLOOR}): outputs "
        + ", ".join(f"{k[4:]} {rows[k][0]:.2e}, {rows[k][1]:.2e}"
                    for k in rows if k[:3] == "out")
        + f"; worst card/CPU ratio "
        f"{max(r[0] / max(r[1], 1e-30) for r in rows.values()):.3f}; "
        f"largest card-CPU distances: "
        + ", ".join(f"{k} {r[2]:.2e} (float64: {r[0]:.2e}, {r[1]:.2e})"
                    for k, r in worst))
    if bad:
        raise AssertionError(f"onestage: the card's step against the CPU's "
                             f"float64 (card fp32, CPU fp32, card-CPU fp32, "
                             f"card fp64): {sorted(bad.items())[:6]}")
    del got, on_card, on_cpu, ref, card64

    # 2. bf16 train and eval steps on the card
    model, loss_cfg = model_on("cuda", torch.bfloat16)
    step, state = make_train_step_for(cfg, model, loss_cfg, norm)
    batches = [to_device(b, TRAIN_KEYS) for b in requests(
        SEED + 31, ONESTAGE_STEPS + 1, TRAIN_BATCH)]
    state, _ = step(state, batches[0], SEED)  # warm-up
    ms, history = [], []

    def counted():
        for b in batches[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            history.append(step(state, b, SEED)[1])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)

    counted_run("onestage[train]", counted, 0, 0, card, launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(torch.isfinite(v).all() for h in history for v in h.values()):
        raise AssertionError(f"onestage train step: non-finite {history}")
    ms.sort()
    log(f"onestage[train] bf16 step, batch {TRAIN_BATCH}: median "
        f"{ms[len(ms) // 2]:.3f} ms (min {ms[0]:.3f}, max {ms[-1]:.3f}), "
        f"peak {peak:.2f} GiB [{card}]; loss_total "
        f"{[h['loss_total'].item() for h in history]}, grad_norm "
        f"{[h['grad_norm'].item() for h in history]}")
    del state, step
    torch.cuda.empty_cache()
    eval_step = make_eval_step(model, device_norm=norm)
    eval_ms = {}
    for bs in (BATCH, TRAIN_BATCH):
        b = {k: v[:bs] for k, v in batches[1].items()}
        preds = eval_step(b)
        if not all(torch.isfinite(t.float()).all() for p in preds.values()
                   for t in p.values()):
            raise AssertionError("onestage eval: non-finite predictions")
        eval_ms[bs] = counted_run(f"onestage[eval b={bs}]",
                                  lambda: cuda_ms(lambda: eval_step(b), 10),
                                  0, 0, card, launches)
    log(f"onestage[eval] bf16 forward with both branches decoded: "
        + ", ".join(f"batch {bs} {v:.3f} ms" for bs, v in eval_ms.items())
        + f" [{card}]")
    del model, eval_step, batches
    torch.cuda.empty_cache()

    # 3. the tiny config through the CLIs on the synthetic JPEGs
    opts = [o for o in synth if o.startswith(("data.train.", "data.val."))]
    wd = os.path.join(root, "onestage_work")
    res = counted_run("onestage[train CLI]", lambda: train_cli.main(
        [ONESTAGE, "--work-dir", wd, "--cfg-options", *opts,
         "scheduler_config.max_epoch=1"]), 0, 0, card, launches)
    got = counted_run("onestage[test CLI]", lambda: test_cli.main(
        [ONESTAGE, os.path.join(wd, "det_best"), "--cfg-options", *opts]),
        0, 0, card, launches)
    if got["val"] != res["eval"]["val"]:
        raise AssertionError(f"onestage test CLI {got['val']} against the "
                             f"train CLI's evaluation {res['eval']['val']}")
    log(f"onestage[CLIs]: tiny_synth_onestage.py, {res['step']} steps, "
        f"epoch {res['epochs'][0]['seconds']:.2f} s [{card}]; test CLI on "
        f"det_best: {got['val']} (the train CLI's evaluation)")


def tools_phase(card, root, synth, launches):
    """The config-facing tools on the flagship at full width, on the CLI
    phase's det_best and the synthetic JPEGs: vis_cam (decoder branch) and
    heatmap write their files with finite maps; attn_visual's maps equal
    the eval step's recorded attention bit for bit; parameters prints the
    flagship's 230,155,276; encoder_ablation's table at batch TRAIN_BATCH.
    K1 is counted around each (K1_STEP an encoder forward), K2 must not
    run."""
    import io

    import numpy as np
    import torch
    from simvg_tpu_torch.config import Config, parse_cfg_options
    from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                              build_loader_from_cfg)
    from simvg_tpu_torch.engine import make_eval_step
    from simvg_tpu_torch.engine.evaluate import DEVICE_KEYS
    from simvg_tpu_torch.models.heads.detr_transformer import (
        recorded_cross_attention)
    from simvg_tpu_torch.tools import (attn_visual, encoder_ablation,
                                       heatmap, parameters, vis_cam)
    from simvg_tpu_torch.tools.test import serving_model

    det_best = os.path.join(root, "work", "det_best")
    out = os.path.join(root, "tools")

    def run(name, fn, k1):
        return counted_run(f"tools[{name}]", fn, k1, 0, card, launches)

    cam = run("vis_cam", lambda: vis_cam.main(
        [FLAGSHIP, det_best, "--branch", "decoder", "--num", "4",
         "--output-dir", os.path.join(out, "cam"), "--cfg-options", *synth]),
        K1_STEP)
    files = sorted(os.listdir(os.path.join(out, "cam")))
    if len(files) != 4 or not np.isfinite(cam).all() or not cam.max() > 0:
        raise AssertionError(f"vis_cam: {files}, max {cam.max()}")
    log(f"tools[vis_cam]: {len(files)} CAMs of {cam.shape}, max "
        f"{cam.max():.3e}")

    imgdir = os.path.join(root, "synth", "images")
    jpeg = os.path.join(imgdir, sorted(os.listdir(imgdir))[0])
    hm = run("heatmap", lambda: heatmap.main(
        [FLAGSHIP, det_best, "--image-path", jpeg, "--text",
         "the green box", "--save-dir", os.path.join(out, "heatmap")]),
        2 * K1_STEP)
    if not (os.path.getsize(hm["out_file"]) > 0
            and np.isfinite(hm["box"]).all()
            and np.isfinite(hm["cam"]).all()):
        raise AssertionError(f"heatmap: {hm}")

    maps = run("attn_visual", lambda: attn_visual.main(
        [FLAGSHIP, det_best, "--num", "2", "--output-dir",
         os.path.join(out, "attn"), "--cfg-options", *synth]), K1_STEP)
    cfg = Config.fromfile(FLAGSHIP)
    cfg.merge_from_dict(parse_cfg_options(synth))
    model = serving_model(cfg, det_best, torch.device("cuda"))
    ds = build_dataset_from_cfg(cfg.data.val, dataset_type=cfg.dataset)
    loader = build_loader_from_cfg(ds, cfg, train=False,
                                   canvas=cfg.img_size, device="cuda")
    batch = to_device(next(iter(loader)), DEVICE_KEYS)

    def held():
        got = attn_visual.cross_attention_maps(model, batch)
        with recorded_cross_attention(model.head.transformer.decoder) as w:
            make_eval_step(model)(batch)
        return got, w[-1].float().mean(dim=1)

    got, want = run("attn_visual vs eval step", held, 2 * K1_STEP)
    last = got[f"layers_{len(got) - 1}"]
    if not torch.equal(last, want) or len(maps) != len(got):
        raise AssertionError("attn_visual's maps differ from the eval "
                             "step's recorded attention: "
                             f"{(last - want).abs().max()}")
    log(f"tools[attn_visual]: {len(maps)} layers' maps of "
        f"{tuple(maps['layers_0'].shape)}, the last layer's equal to the eval "
        f"step's recorded attention bit for bit")
    del model
    torch.cuda.empty_cache()

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        totals = parameters.main([FLAGSHIP])
    if sum(totals.values()) != 230_155_276 or "230.155M" not in buf.getvalue():
        raise AssertionError(f"parameters: {sum(totals.values())}")
    log("tools[parameters]: " + buf.getvalue().strip().splitlines()[-1])

    iters = 10
    rows = run("encoder_ablation", lambda: encoder_ablation.main(
        ["--batch", str(TRAIN_BATCH), "--iters", str(iters)]),
        5 * K1_STEP * (iters + 2))  # every row but plain_attn and attn_off
    log("tools[encoder_ablation] [" + card + "]: " + "; ".join(
        f"{r['name']} b={r['batch']} {r['ms']:.3f} ms (host "
        f"{r['host_ms']:.3f}) {r['images_per_s']:.1f} images/s"
        + (f" {r['vs_k1'] * 100:+.1f}% vs k1" if "vs_k1" in r else "")
        for r in rows))


# the zoo phase: the OneStageModel's other backbones and language encoder,
# and the mixed vision-language encoders, each at the JAX module's own
# defaults (full width) at 640 px
ZOO_BACKBONES = ("ResNet", "CSPDarknet", "VIT", "SwinTransformer",
                 "PyramidVisionTransformerV2", "VITDet")
ZOO_MIXED = ("VisionTransformerMix", "ConvolutionalVisionTransformerMix",
             "YOLOS", "ViLTransformerSS")
# roberta-base's published widths (its HF config.json): the ALBERTA
# language encoder of the reference wraps that checkpoint
ROBERTA_BASE = dict(type="ALBERTA", vocab_size=50265, hidden_size=768,
                    num_layers=12, num_heads=12, max_positions=514,
                    position_offset=2)
ZOO_BATCH = 2  # the float32 check's batch (the CPU's float64 step is slow)
ZOO_TIMED_BATCH = 8  # the bf16 steps'
ZOO_TEXT = (20, 768)  # the mixed encoders' text: tokens, feature width
ZOO_TEXT_PAD = 6  # padded text positions at the end of each sample
ZOO_IMG = 640  # the mixed encoders' canvas (the OneStage models: the config's)


def hold_to_cpu_float64(name, run, card, conv_slack=None, label="zoo",
                        batch=ZOO_BATCH):
    """``run(device, dtype)`` -> {name: tensor} on the CPU in float64, then
    on the card and the CPU in float32, each float32 run on the float64
    run's side of every discrete choice: the Hungarian matchings
    (``fixed_matching``) and the ReLU, LeakyReLU and max-pool decisions
    (``fixed_kinks``).  A float32 input within rounding of a kink takes
    either side, and the gradient then moves by that element's whole
    term, which is not a precision fault (a card ReLU flip in a DETR
    decoder FFN put its weight gradient 8.8e-4 from float64, the CPU's at
    5.8e-7, CSPDarknet at batch 2).  Every tensor's distance from the CPU's
    float64 (max |difference| over the float64 tensor's max |value|, or
    over the largest gradient's for a gradient 0 in exact arithmetic) on
    the card is at most ONESTAGE_FACTOR times the CPU float32's plus
    ONESTAGE_FLOOR, plus, for a conv weight's gradient, cuDNN's own float32
    distance for that convolution alone on the float64 run's inputs
    (``conv_slack()`` -> {name: (cuDNN's, torch's own route's)}, absolute;
    ``conv_witness``).  Logs the distances, the witnesses and how many
    targets and kink decisions the float32 runs' own choices moved; raises
    past the rule."""
    import torch

    got, matching, decisions, moved = [], [], [], []
    for dev, dtype in (("cpu", torch.float64), ("cuda", torch.float32),
                       ("cpu", torch.float32)):
        t0 = time.perf_counter()
        with fixed_matching(matching) as moves, \
                fixed_kinks(decisions) as kinks:
            got.append({k: v.detach().double().cpu()
                        for k, v in run(dev, dtype).items()})
        moved.append((moves, kinks))
        log(f"{label}[{name}] {str(dtype)[6:]} {dev}: "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
    ref, on_card, on_cpu = got
    grads = [v.abs().max().item() for k, v in ref.items() if k[:4] == "grad"]
    top = max(grads, default=0.0)

    def scale(k):
        s = ref[k].abs().max().item()
        return top if k[:4] == "grad" and s < 1e-6 * top else max(s, 1e-30)

    rows = {k: tuple((a[k] - ref[k]).abs().max().item() / scale(k)
                     for a in (on_card, on_cpu)) for k in ref}
    slack = {k: tuple(v / scale(k) for v in w)
             for k, w in (conv_slack() if conv_slack else {}).items()}
    bad = {k: r + slack.get(k, (0.0,)) for k, r in rows.items()
           if not r[0] <= ONESTAGE_FACTOR * r[1] + ONESTAGE_FLOOR
           + slack.get(k, (0.0,))[0]}
    # the conv weights whose gradient needed cuDNN's witness to hold
    needed = sorted((k for k in slack if rows[k][0] > ONESTAGE_FACTOR
                     * rows[k][1] + ONESTAGE_FLOOR), key=lambda k: -rows[k][0])
    worst = sorted(rows.items(), key=lambda kv: -kv[1][0])[:3]
    log(f"{label}[{name}] fp32 card vs CPU, batch {batch}: "
        f"{len(rows)} tensors ({len(grads)} gradients); distance from the "
        f"CPU's float64 (card, CPU; rule card <= {ONESTAGE_FACTOR} x CPU + "
        f"{ONESTAGE_FLOOR} + cuDNN's witness for a conv weight): "
        + ", ".join(f"{k} {r[0]:.2e}, {r[1]:.2e}" for k, r in rows.items()
                    if k[:4] != "grad")
        + "; largest on the card: "
        + ", ".join(f"{k} {r[0]:.2e}, {r[1]:.2e}" for k, r in worst)
        + f"; worst card/CPU ratio "
        f"{max(r[0] / max(r[1], 1e-30) for r in rows.values()):.3f}; "
        f"moved by their own choice (card, CPU): targets {moved[1][0]}, "
        f"{moved[2][0]} of the matched, kink decisions {moved[1][1]}, "
        f"{moved[2][1]}"
        + (f"; conv witnesses ({len(slack)} weights; cuDNN, torch's own "
           f"route): largest " + ", ".join(
               f"{k} {slack[k][0]:.2e}, {slack[k][1]:.2e}" for k in sorted(
                   slack, key=lambda k: -slack[k][0])[:2])
           + f"; largest of torch's own {max(w[1] for w in slack.values()):.2e}"
           f"; held by the witness alone: "
           + (", ".join(f"{k} {rows[k][0]:.2e} (CPU {rows[k][1]:.2e}, "
                        f"witness {slack[k][0]:.2e}, {slack[k][1]:.2e})"
                        for k in needed[:6]) or "none")
           if slack else ""))
    if bad:
        raise AssertionError(f"{label}[{name}]: the card's float32 against the "
                             f"CPU's float64 (card, CPU[, cuDNN witness, "
                             f"torch's own]): {sorted(bad.items())[:6]}")


@contextlib.contextmanager
def recorded_convs(model, store):
    """With a dict ``store``, records every conv of ``model`` that a run
    calls: ``store[module name]`` = (the module, [[input, output
    gradient], ...] per call), the gradients as autograd computes them;
    with None, records nothing."""
    import torch

    handles = []
    if store is not None:
        def hook(name):
            def record(module, inputs, out):
                call = [inputs[0].detach(), None]
                store.setdefault(name, (module, []))[1].append(call)
                if out.requires_grad:
                    out.register_hook(
                        lambda g: call.__setitem__(1, g.detach()))
            return record

        handles = [m.register_forward_hook(hook(n))
                   for n, m in model.named_modules()
                   if isinstance(m, torch.nn.Conv2d)]
    try:
        yield store
    finally:
        for h in handles:
            h.remove()


def conv_witness(store):
    """For each conv weight in ``store`` (``recorded_convs`` of the float64
    run): its gradient from those calls alone on the card in float64, and
    in float32 through cuDNN and through torch's own CUDA convolution
    (cuDNN off), on the float64 inputs rounded to float32.  Returns
    {"grad <name>.weight": (max |cuDNN - float64|, max |torch's own -
    float64|)}: the convolution's own float32 rounding on this run's data,
    independent of the model code around it."""
    import torch
    from torch.nn.grad import conv2d_weight

    out = {}
    for name, (m, calls) in store.items():
        if not m.weight.requires_grad:
            continue
        sums = {}
        for x, g in calls:
            if g is None:
                continue
            for key, dtype, cudnn in (("ref", torch.float64, True),
                                      ("cudnn", torch.float32, True),
                                      ("own", torch.float32, False)):
                torch.backends.cudnn.enabled = cudnn
                try:
                    w = conv2d_weight(x.to("cuda", dtype), m.weight.shape,
                                      g.to("cuda", dtype), m.stride,
                                      m.padding, m.dilation, m.groups)
                finally:
                    torch.backends.cudnn.enabled = True
                sums[key] = sums[key] + w.double() if key in sums else \
                    w.double()
        if sums:
            out[f"grad {name}.weight"] = tuple(
                (sums[k] - sums["ref"]).abs().max().item()
                for k in ("cudnn", "own"))
    return out


def roberta_base_state_dict(seed):
    """An HF roberta-base state dict in numpy (``roberta.`` prefix):
    Linear and embedding weights N(0, 0.02), biases 0, LayerNorm 1 and 0,
    as HF initialises the model."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d, v = ROBERTA_BASE["hidden_size"], ROBERTA_BASE["vocab_size"]

    def normal(*shape):
        return rng.standard_normal(shape, np.float32) * np.float32(0.02)

    sd = {"embeddings.word_embeddings.weight": normal(v, d),
          "embeddings.position_embeddings.weight":
              normal(ROBERTA_BASE["max_positions"], d),
          "embeddings.token_type_embeddings.weight": normal(1, d),
          "embeddings.LayerNorm.weight": np.ones(d, np.float32),
          "embeddings.LayerNorm.bias": np.zeros(d, np.float32)}
    for i in range(ROBERTA_BASE["num_layers"]):
        for name, (o, n) in (("attention.self.query", (d, d)),
                             ("attention.self.key", (d, d)),
                             ("attention.self.value", (d, d)),
                             ("attention.output.dense", (d, d)),
                             ("intermediate.dense", (4 * d, d)),
                             ("output.dense", (d, 4 * d))):
            sd[f"encoder.layer.{i}.{name}.weight"] = normal(o, n)
            sd[f"encoder.layer.{i}.{name}.bias"] = np.zeros(o, np.float32)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"encoder.layer.{i}.{name}.weight"] = np.ones(d, np.float32)
            sd[f"encoder.layer.{i}.{name}.bias"] = np.zeros(d, np.float32)
    return {"roberta." + k: a for k, a in sd.items()}


def zoo_composed(name, cfg, model_cfg, requests, norm, card, launches,
                 hf_state_dict=None, whole_canvas=False):
    """One OneStageModel: the float32 check at batch ZOO_BATCH (the
    train-mode forward with dropout off, loss terms, gradients), then the
    bf16 train step at ZOO_TIMED_BATCH (one warm-up, ONESTAGE_STEPS
    counted: median ms, peak memory) and the eval step there, on the
    letterboxed canvases of ``requests``.  Weights: random from SEED, the
    ``lan_enc`` from ``hf_state_dict`` through ``pretrained_state_dict``
    where one is given.  ``whole_canvas``: every image's valid extent the
    whole canvas (Swin: on a zero-padded canvas its padded windows stay
    exactly 0 at flax's zero-bias init, each LayerNorm's backward
    multiplies their gradient by 1/sqrt(1e-6), and float32 overflows, in
    JAX too: ROADMAP.md §3)."""
    import torch
    from simvg_tpu_torch.convert import pretrained_state_dict
    from simvg_tpu_torch.engine import (make_eval_step,
                                        normalize_images_on_device)
    from simvg_tpu_torch.engine.train import train_losses
    from simvg_tpu_torch.models import build_model, init_random_weights

    t0 = time.perf_counter()
    model, loss_cfg = build_model(model_cfg, img_size=cfg.img_size,
                                  device="cpu")
    sd = init_random_weights(model, SEED).state_dict()
    if hf_state_dict is not None:
        mapped, unused = pretrained_state_dict(
            {k: torch.from_numpy(v) for k, v in hf_state_dict.items()}, sd)
        if unused or sorted(mapped) != sorted(
                k for k in sd if k.startswith("lan_enc.")):
            raise AssertionError(f"zoo[{name}]: the HF checkpoint left "
                                 f"{unused} unused")
        sd.update(mapped)
    n_params = sum(v.numel() for v in sd.values())
    log(f"zoo[{name}]: {type(model.vis_enc).__name__} + "
        f"{type(model.lan_enc).__name__}, {n_params} params, random from "
        f"seed {SEED}"
        + (" (lan_enc from an HF roberta-base state dict)"
           if hf_state_dict is not None else "")
        + f" in {time.perf_counter() - t0:.1f} s")
    del model

    def model_on(dev, dtype):
        """float32 parameters computing in ``dtype``; float64 ones for the
        float64 reference."""
        model, loss_cfg = build_model(model_cfg, img_size=cfg.img_size,
                                      dtype=dtype, device=dev)
        model.load_state_dict(sd)
        return model.to(torch.promote_types(dtype, torch.float32)), loss_cfg

    def batches_of(seed, n, batch):
        reqs = requests(seed, n, batch)
        for r in reqs if whole_canvas else ():
            r["img_shape"][:] = cfg.img_size
        return reqs

    (batch,) = batches_of(SEED + 40, 1, ZOO_BATCH)
    convs = {}  # the float64 run's convolutions, for conv_witness

    def run(dev, dtype):
        """The train-mode forward (dropout off), the loss terms and the
        gradients, all in ``dtype``."""
        model, loss_cfg = model_on(dev, dtype)
        dropout_off(model)
        b = {k: torch.as_tensor(batch[k]).to(dev) for k in TRAIN_KEYS}
        image = normalize_images_on_device(b["image"], norm["mean"],
                                           norm["std"], True, b["img_shape"])
        with recorded_convs(model, convs if dtype == torch.float64
                            else None):
            losses, out = train_losses(
                model, b, image,
                branch_loss_weight=loss_cfg["branch_loss_weight"],
                prepare_target_mode=loss_cfg["prepare_target_mode"],
                distill_type=loss_cfg["distill_type"],
                mlp_aux_loss=loss_cfg["mlp_aux_loss"])
            names, params = zip(*model.named_parameters())
            grads = torch.autograd.grad(losses["loss_total"], params,
                                        allow_unused=True)
        return dict(
            {f"out {k}": out[k] for k in ("class_decoder", "bbox_decoder")},
            **{f"loss {k}": v for k, v in losses.items()},
            **{f"grad {n}": torch.zeros_like(p) if g is None else g
               for n, p, g in zip(names, params, grads)})

    hold_to_cpu_float64(name, run, card, lambda: conv_witness(convs))
    convs.clear()

    model, loss_cfg = model_on("cuda", torch.bfloat16)
    step, state = make_train_step_for(cfg, model, loss_cfg, norm)
    batches = [to_device(b, TRAIN_KEYS) for b in batches_of(
        SEED + 41, ONESTAGE_STEPS + 1, ZOO_TIMED_BATCH)]
    state, _ = step(state, batches[0], SEED)  # warm-up
    ms, history = [], []

    def counted():
        for b in batches[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            history.append(step(state, b, SEED)[1])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)

    counted_run(f"zoo[{name} train]", counted, 0, 0, card, launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(torch.isfinite(v).all() for h in history for v in h.values()):
        raise AssertionError(f"zoo[{name}] train step: non-finite {history}")
    del state, step
    torch.cuda.empty_cache()
    eval_step = make_eval_step(model, device_norm=norm)
    preds = eval_step(batches[1])
    if not all(torch.isfinite(t.float()).all() for p in preds.values()
               for t in p.values()):
        raise AssertionError(f"zoo[{name}] eval: non-finite predictions")
    eval_ms = counted_run(f"zoo[{name} eval]",
                          lambda: cuda_ms(lambda: eval_step(batches[1]), 10),
                          0, 0, card, launches)
    ms.sort()
    log(f"zoo[{name}] bf16, batch {ZOO_TIMED_BATCH}: train step median "
        f"{ms[len(ms) // 2]:.3f} ms (min {ms[0]:.3f}, max {ms[-1]:.3f}), "
        f"peak {peak:.2f} GiB; eval step {eval_ms:.3f} ms [{card}]; "
        f"loss_total {[h['loss_total'].item() for h in history]}")
    del model, eval_step, batches
    torch.cuda.empty_cache()


def zoo_mixed(typ, card, launches):
    """One mixed vision-language encoder through ``build_vis_enc`` at its
    defaults: the float32 forward at batch ZOO_BATCH held to the CPU's
    float64 (hold_to_cpu_float64), then a bf16 forward and backward at
    ZOO_TIMED_BATCH (one warm-up, ONESTAGE_STEPS counted: median ms, peak
    memory).  Text: ZOO_TEXT features (ViLT: word ids) with the last
    ZOO_TEXT_PAD positions padded."""
    import numpy as np
    import torch
    from simvg_tpu_torch.models import init_random_weights
    from simvg_tpu_torch.models.vis_enc_zoo import build_vis_enc

    n_txt, width = ZOO_TEXT
    cfg = {"type": typ}

    def encoder(dev, dtype):
        with torch.device(dev):
            return build_vis_enc(cfg, dtype, ZOO_IMG, text_dim=width)

    t0 = time.perf_counter()
    sd = init_random_weights(encoder("cpu", torch.float32), SEED).state_dict()
    log(f"zoo[{typ}]: {sum(v.numel() for v in sd.values())} params, random "
        f"from seed {SEED} in {time.perf_counter() - t0:.1f} s")

    def inputs(batch, seed, dev, dtype=torch.float32):
        """(image, text, text mask); float arrays in ``dtype``."""
        rng = np.random.default_rng(seed)
        image = rng.standard_normal((batch, ZOO_IMG, ZOO_IMG, 3),
                                    np.float32)
        mask = np.zeros((batch, n_txt), bool)
        mask[:, -ZOO_TEXT_PAD:] = True
        if typ == "ViLTransformerSS":
            text = rng.integers(1, 30522, (batch, n_txt))
            text[mask] = 0
        else:
            text = rng.standard_normal((batch, n_txt, width), np.float32)
        return [torch.as_tensor(a).to(dev, dtype) if a.dtype == np.float32
                else torch.as_tensor(a).to(dev) for a in (image, text, mask)]

    def run(dev, dtype):
        enc = encoder(dev, dtype)
        enc.load_state_dict(sd)
        with torch.no_grad():
            out = enc.to(dtype).eval()(*inputs(ZOO_BATCH, SEED + 42, dev,
                                               dtype))
        return {f"out {k}": v for k, v in out.items()}

    hold_to_cpu_float64(typ, run, card)

    enc = encoder("cuda", torch.bfloat16)
    enc.load_state_dict(sd)
    args = [inputs(ZOO_TIMED_BATCH, SEED + 43 + i, "cuda")
            for i in range(ONESTAGE_STEPS + 1)]
    ms = []

    def fwd_bwd(image, text, mask):
        out = enc(image, text, mask)
        sum(v.float().square().mean() for v in out.values()).backward()

    fwd_bwd(*args[0])  # warm-up

    def counted():
        for a in args[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd_bwd(*a)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)

    counted_run(f"zoo[{typ} fwd+bwd]", counted, 0, 0, card, launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(torch.isfinite(p.grad).all() for p in enc.parameters()
               if p.grad is not None):
        raise AssertionError(f"zoo[{typ}]: non-finite gradients")
    ms.sort()
    log(f"zoo[{typ}] bf16 forward + backward, batch {ZOO_TIMED_BATCH}: "
        f"median {ms[len(ms) // 2]:.3f} ms (min {ms[0]:.3f}, max "
        f"{ms[-1]:.3f}), peak {peak:.2f} GiB [{card}]")
    del enc, args
    torch.cuda.empty_cache()


def zoo_phase(card, root, synth, launches):
    """The zoo at full width on random weights from SEED, TF32 off: each
    pure-vision backbone (ZOO_BACKBONES) in ONESTAGE_FULL's OneStageModel
    in place of DarkNet53, then DarkNet53 with the ALBERTA language encoder
    at roberta-base's widths (its weights an HF-layout state dict through
    ``convert_hf_bert``), each by ``zoo_composed``; then the mixed
    vision-language encoders (ZOO_MIXED) by ``zoo_mixed``.  No K1 or K2
    is on these paths."""
    cfg, norm, requests = onestage_setup(root, synth)
    for typ in ZOO_BACKBONES:
        zoo_composed(typ, cfg, dict(cfg.model, vis_enc={"type": typ}),
                     requests, norm, card, launches,
                     whole_canvas=typ == "SwinTransformer")
    zoo_composed("ALBERTA", cfg, dict(cfg.model, lan_enc=ROBERTA_BASE),
                 requests, norm, card, launches,
                 hf_state_dict=roberta_base_state_dict(SEED))
    for typ in ZOO_MIXED:
        zoo_mixed(typ, card, launches)


# -- "legacy": the BEiT-3 task heads, the SeqTR/MDETR layers and
# losses, VGTRAugment ------------------------------------------------------

LEGACY_BATCH = 8
HEAD_ITERS = 5  # timed forwards (or VQA steps) a head, after one warm-up
# the public BEiT-3 fine-tuning recipes (microsoft/unilm beit3/): image
# size at patch 16, and K1 launches of one forward (12 layers an encode)
HEADS = {"classification": (224, 12),  # ImageNet, vision-only S=197
         "vqa": (480, 12),  # VQAv2, joint S=901+32
         "reasoning": (224, 24),  # NLVR2, two joint encodes
         "retrieval": (384, 24),  # COCO, vision-only S=577, text-only S=32
         "captioning": (480, 0)}  # COCO captioning, uni-mask: plain path
VQA_ANSWERS = 3129
HEAD_TEXT, HEAD_TEXT_PAD = 32, 8  # question tokens, the padded ones
CAPTION_STEPS = 8  # greedy_generate steps (max_len 9)
# the legacy transformers at their JAX defaults over a [8, 20, 20, 1024] map
LEGACY_MAP = (20, 20, 1024)
MDETR_TEXT = (20, 768)  # text tokens, feature width
LOSS_REL = 1e-6  # the card's legacy losses against the CPU's, relative
VGTR_BASE = os.path.join(REPO, "configs", "_base_", "datasets", "detection",
                         "refcoco-unc_vgtr.py")


def head_model(name, impl, dtype, state=None):
    """A BEiT3-base task head on the card (bf16 or float32 compute,
    ``attn_impl`` ``impl``): random weights from SEED, or ``state``."""
    import torch
    from simvg_tpu_torch.models import init_random_weights
    from simvg_tpu_torch.models import beit3_heads as bh
    from simvg_tpu_torch.models.beit3 import BEiT3Config

    cfg = BEiT3Config.base(img_size=HEADS[name][0], patch_size=16,
                           drop_path_rate=0.0, attn_impl=impl, dtype=dtype)
    make = {"classification": lambda: bh.BEiT3ForImageClassification(
                cfg, 1000),
            "vqa": lambda: bh.BEiT3ForVisualQuestionAnswering(
                cfg, VQA_ANSWERS),
            "reasoning": lambda: bh.BEiT3ForVisualReasoning(cfg),
            "retrieval": lambda: bh.BEiT3ForRetrieval(cfg),
            "captioning": lambda: bh.BEiT3ForCaptioning(cfg)}[name]
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device="cuda")
    if state is None:
        init_random_weights(model, SEED)
    else:
        model.load_state_dict(state, strict=True)
    return model.eval()


def head_inputs(name, seed):
    """The head's keyword inputs at LEGACY_BATCH: N(0, 1) images, word ids
    of HEAD_TEXT tokens with the last HEAD_TEXT_PAD padded."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    size = HEADS[name][0]

    def image():
        return torch.as_tensor(rng.standard_normal(
            (LEGACY_BATCH, size, size, 3), np.float32)).cuda()

    ids = torch.as_tensor(rng.integers(2, 64010, (LEGACY_BATCH,
                                                  HEAD_TEXT))).cuda()
    pad = torch.zeros_like(ids)
    pad[:, -HEAD_TEXT_PAD:] = 1
    return {"classification": lambda: dict(image=image()),
            "vqa": lambda: dict(image=image(), question_ids=ids,
                                padding_mask=pad),
            "reasoning": lambda: dict(image_a=image(), image_b=image(),
                                      text_ids=ids, padding_mask=pad),
            "retrieval": lambda: dict(image=image(), text_ids=ids,
                                      padding_mask=pad),
            "captioning": lambda: dict(image=image(), text_ids=ids,
                                       padding_mask=pad)}[name]()


def head_outputs(model, kw):
    out = model(**kw)
    out = out if isinstance(out, tuple) else (out,)
    return [o.float() for o in out if o is not None]


def timed_ms(fn, iters):
    """Median ms (host clock around a synchronised call) of ``iters`` calls
    after one warm-up, and the peak allocated GiB."""
    import torch

    fn()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    ms.sort()
    return ms[len(ms) // 2], torch.cuda.max_memory_allocated() / 2 ** 30


def heads_part(card, launches):
    """Each BEiT-3 task head at BEiT3-base widths (HEADS), bf16 with the
    kernels, on random weights from SEED at LEGACY_BATCH: its forward with
    K1 counted; every output held by the bf16 rule to the float32 model
    with plain attention on the same weights (beside the bf16 plain
    model), every K1 call by the per-call rule; the forward timed.  VQA:
    one backward of its loss through K2, the loss and gradients held by
    the bf16 rule and every K1/K2 call by the per-call rule, the step
    timed.  Captioning: an 8-step ``greedy_generate``, 0 K1, its ids the
    plain bf16 model's."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    for name, (size, want_k1) in HEADS.items():
        t0 = time.perf_counter()
        kern = head_model(name, "pallas", torch.bfloat16)
        state = kern.state_dict()
        plain = head_model(name, "xla", torch.bfloat16, state)
        ref32 = head_model(name, "xla", torch.float32, state)
        kw = head_inputs(name, SEED + 50)
        with torch.no_grad():
            with recorded_attention() as calls:
                out = counted_run(f"legacy[{name} forward]",
                                  lambda: head_outputs(kern, kw), want_k1,
                                  0, card, launches)
            ref = head_outputs(ref32, kw)
            out_p = head_outputs(plain, kw)
        d_k = [(o - r).abs().max().item() for o, r in zip(out, ref)]
        d_p = [(o - r).abs().max().item() for o, r in zip(out_p, ref)]
        if not all(torch.isfinite(o).all() for o in out) or not all(
                a <= BF16_REF_FACTOR * b + OUT_FLOOR for a, b in zip(d_k, d_p)):
            raise AssertionError(f"legacy[{name}]: bf16 outputs with the "
                                 f"kernels {d_k}, plain {d_p} from float32")
        if want_k1:
            hold_calls_against_fp32(f"legacy[{name}]", calls)
        with torch.no_grad():
            ms, gib = timed_ms(lambda: head_outputs(kern, kw), HEAD_ITERS)
        log(f"legacy[{name}] BEiT3-base at {size} px, batch {LEGACY_BATCH}, "
            f"bf16: outputs {[tuple(o.shape) for o in out]}, max abs "
            f"distance from the float32 plain model with the kernels {d_k}, "
            f"plain {d_p} (bound {BF16_REF_FACTOR} x plain + {OUT_FLOOR}); "
            f"forward median {ms:.3f} ms, peak {gib:.2f} GiB; "
            f"{time.perf_counter() - t0:.1f} s [{card}]")

        if name == "vqa":
            rng = np.random.default_rng(SEED + 51)
            target = torch.as_tensor(
                (rng.random((LEGACY_BATCH, VQA_ANSWERS)) < 2e-3)
                * rng.random((LEGACY_BATCH, VQA_ANSWERS)),
                dtype=torch.float32).cuda()

            def step(model):
                model.zero_grad(set_to_none=True)
                logits = model(**kw)
                loss = F.binary_cross_entropy_with_logits(
                    logits.float(), target) * VQA_ANSWERS
                loss.backward()
                return loss

            runs = {}
            for label, model in (("fp32 plain", ref32), ("kernels", kern),
                                 ("plain", plain)):
                if label == "kernels":
                    with recorded_attention() as calls:
                        loss = counted_run("legacy[vqa backward]",
                                           lambda: step(kern), 12, 12, card,
                                           launches)
                else:
                    loss = step(model)
                runs[label] = (loss.item(), {
                    n: p.grad.float() for n, p in model.named_parameters()
                    if p.grad is not None})
            loss32, grads32 = runs.pop("fp32 plain")
            gmax = max(g.abs().max().item() for g in grads32.values())
            gnorm = l2(grads32.values())
            dist = {label: dict(
                loss=abs(loss - loss32) / abs(loss32),
                grad_max=max((grads[n] - g).abs().max().item()
                             for n, g in grads32.items()) / gmax,
                grad_l2=l2(grads[n] - g for n, g in grads32.items()) / gnorm)
                for label, (loss, grads) in runs.items()}
            log(f"legacy[vqa] one backward, bf16, distance from the float32 "
                f"plain model, relative: with K1/K2 {dist['kernels']}, plain "
                f"{dist['plain']} (bound {BF16_REF_FACTOR} x plain + "
                f"{LOSS_FLOOR} or {GRAD_FLOOR})")
            bad = [k for k, v in dist["kernels"].items()
                   if not v <= BF16_REF_FACTOR * dist["plain"][k]
                   + (GRAD_FLOOR if k.startswith("grad") else LOSS_FLOOR)]
            if bad:
                raise AssertionError(f"legacy[vqa]: the backward with K1/K2 "
                                     f"is further from float32 than the "
                                     f"bound in {bad}")
            hold_calls_against_fp32("legacy[vqa backward]", calls)
            ms, gib = timed_ms(lambda: step(kern), HEAD_ITERS)
            log(f"legacy[vqa] forward + backward, batch {LEGACY_BATCH}, "
                f"bf16 with K1/K2: median {ms:.3f} ms, peak {gib:.2f} GiB "
                f"[{card}]")
            for model in (kern, plain, ref32):
                model.zero_grad(set_to_none=True)

        if name == "captioning":
            image = kw["image"]
            ids = counted_run("legacy[captioning greedy_generate]",
                              lambda: kern.greedy_generate(
                                  image, bos_id=0, eos_id=2,
                                  max_len=CAPTION_STEPS + 1),
                              0, 0, card, launches)
            ids_p = plain.greedy_generate(image, bos_id=0, eos_id=2,
                                          max_len=CAPTION_STEPS + 1)
            if not torch.equal(ids, ids_p) or not (
                    (ids >= 0) & (ids < 64010)).all():
                raise AssertionError(f"legacy[captioning]: greedy ids {ids} "
                                     f"against the plain model's {ids_p}")
            ms, _ = timed_ms(lambda: kern.greedy_generate(
                image, bos_id=0, eos_id=2, max_len=CAPTION_STEPS + 1), 1)
            log(f"legacy[captioning] greedy_generate, {CAPTION_STEPS} steps "
                f"at batch {LEGACY_BATCH}: ids {tuple(ids.shape)} equal to "
                f"the plain model's, {ms:.3f} ms [{card}]")
        del kern, plain, ref32, state
        torch.cuda.empty_cache()


def legacy_layers_part(card, launches):
    """AutoRegressiveTransformer and MDETRTransformer at their JAX defaults
    over a LEGACY_MAP feature map at LEGACY_BATCH (some samples padded),
    random weights from SEED: each float32 forward on the card held to the
    CPU's float64 by ``hold_to_cpu_float64``, ``generate``'s ids the
    float64 run's; then the three legacy losses on the card against the
    CPU's.  Plain attention: no K1 or K2."""
    import numpy as np
    import torch
    from simvg_tpu_torch.losses import legacy as losses
    from simvg_tpu_torch.models import init_random_weights
    from simvg_tpu_torch.models.legacy_layers import (
        AutoRegressiveTransformer, MDETRTransformer)

    h, w, c = LEGACY_MAP
    rng = np.random.default_rng(SEED + 60)
    x = rng.standard_normal((LEGACY_BATCH, h, w, c), np.float32)
    mask = np.zeros((LEGACY_BATCH, h, w), bool)
    for i in range(LEGACY_BATCH):  # letterboxed maps: padded right, bottom
        mask[i, h - i // 2:] = True
        mask[i, :, w - i:] = True
    n_txt, width = MDETR_TEXT
    text = rng.standard_normal((LEGACY_BATCH, n_txt, width), np.float32)
    tmask = np.zeros((LEGACY_BATCH, n_txt), bool)
    for i in range(LEGACY_BATCH):
        tmask[i, n_txt - 3 - i:] = True
    seq = rng.integers(0, 1003, (LEGACY_BATCH, 5))
    models = {"AutoRegressiveTransformer": lambda dt: AutoRegressiveTransformer(
                  c, dtype=dt),
              "MDETRTransformer": lambda dt: MDETRTransformer(
                  c, text_dim=width, dtype=dt)}
    ids = {}
    for name, make in models.items():
        sd = init_random_weights(make(torch.float32), SEED).state_dict()

        def run(dev, dtype, name=name, make=make):
            with torch.device(dev):
                model = make(dtype)
            model.load_state_dict(sd)
            model.eval()
            args = [torch.as_tensor(a).to(dev) for a in (x, mask, text,
                                                         tmask)]
            args[0], args[2] = args[0].to(dtype), args[2].to(dtype)
            with torch.no_grad():
                if name == "MDETRTransformer":
                    return {"out": model(*args)}
                s = torch.as_tensor(seq).to(dev)
                ids[dev, dtype] = model.generate(args[0], 0, 4).cpu()
                return {"logits": model(args[0], s, args[1])}

        counted_run(f"legacy[{name} fp32 card vs float64 CPU]",
                    lambda: hold_to_cpu_float64(name, run, card,
                                                label="legacy",
                                                batch=LEGACY_BATCH),
                    0, 0, card, launches)
    ref = ids["cpu", torch.float64]
    same = {f"{d} {str(t)[6:]}": bool(torch.equal(v, ref))
            for (d, t), v in ids.items()}
    log(f"legacy[AutoRegressiveTransformer] generate, 4 steps: ids equal to "
        f"the CPU's float64 run's: {same}")
    if not same["cuda float32"]:
        raise AssertionError(f"legacy: generate's ids on the card "
                             f"{ids['cuda', torch.float32]} against float64 "
                             f"{ref}")

    # the losses: the card's float32 against the CPU's
    logits = rng.standard_normal((LEGACY_BATCH, 5, 1003), np.float32) * 3
    tgt = rng.integers(0, 1003, (LEGACY_BATCH, 5))
    wts = rng.random((LEGACY_BATCH, 5)).astype(np.float32)

    def boxes(*shape):
        return np.stack([rng.uniform(0.3, 0.7, shape),
                         rng.uniform(0.3, 0.7, shape),
                         rng.uniform(0.05, 0.3, shape),
                         rng.uniform(0.05, 0.3, shape)], -1).astype(
                             np.float32)

    pred, gt = boxes(LEGACY_BATCH), boxes(LEGACY_BATCH)
    q_logits = rng.standard_normal((LEGACY_BATCH, 100, 256), np.float32)
    q_boxes, t_boxes = boxes(LEGACY_BATCH, 100), boxes(LEGACY_BATCH, 4)
    valid = np.arange(4)[None] < (np.arange(LEGACY_BATCH) % 5)[:, None]
    pmap = (rng.random((LEGACY_BATCH, 4, 256)) < 0.05).astype(np.float32)
    pmap /= np.maximum(pmap.sum(-1, keepdims=True), 1)
    got = {}
    for dev in ("cpu", "cuda"):
        def t(a, dev=dev):
            return torch.as_tensor(a).to(dev)

        lg = t(logits).requires_grad_()
        ce = losses.label_smooth_ce(lg, t(tgt), t(wts))
        ce.backward()
        p = t(pred).requires_grad_()
        total, l1, giou = losses.box_loss(p, t(gt))
        total.backward()
        c4r, r4c = losses.mdetr_hungarian_match(
            t(q_logits), t(q_boxes), t(t_boxes), t(valid), t(pmap))
        got[dev] = dict(ce=ce, ce_grad=lg.grad, box=total, l1=l1, giou=giou,
                        box_grad=p.grad, col4row=c4r, row4col=r4c)
    dist = {}
    for k, a in got["cpu"].items():
        b = got["cuda"][k].cpu()
        if a.dtype == torch.int64:
            if not torch.equal(a, b):
                raise AssertionError(f"legacy[{k}]: card {b} against CPU {a}")
            continue
        dist[k] = (a.detach() - b.detach()).abs().max().item() / max(
            a.detach().abs().max().item(), 1e-30)
    log(f"legacy losses at batch {LEGACY_BATCH} (label_smooth_ce over 1003 "
        f"classes, box_loss, the mdetr matching of 100 queries): card "
        f"float32 against the CPU's, relative {dist} (bound {LOSS_REL}); "
        f"matchings equal")
    if not all(v <= LOSS_REL for v in dist.values()):
        raise AssertionError(f"legacy losses: {dist}")


def vgtr_part(card, root, opts, launches):
    """VGTRAugment on the card: the flagship with refcoco-unc_vgtr.py's
    pipelines (VGTRAugment at 512 px in train, a 512 px resize in
    evaluation) through the train CLI for one epoch on the synthetic JPEGs,
    K1/K2 counted; the VGTR pixel ops of 8 samples on their nvJPEG-decoded
    images on the card against the same ops on the CPU on the same decoded
    images; the dataset's host ms a sample and the card's pixel-op ms."""
    import numpy as np
    import torch
    from simvg_tpu_torch.config import Config, parse_cfg_options
    from simvg_tpu_torch.data.builder import build_dataset_from_cfg
    from simvg_tpu_torch.data.image_ops import apply_pixel_ops
    from simvg_tpu_torch.data.jpeg import decode
    from simvg_tpu_torch.tools import train as train_cli

    base = Config.fromfile(VGTR_BASE)
    path = os.path.join(root, "vgtr.py")
    with open(path, "w") as f:
        f.write(f"_base_ = [{FLAGSHIP!r}]\n"
                f"train_pipeline = {base.train_pipeline!r}\n"
                f"test_pipeline = {base.val_pipeline!r}\n"
                "data = dict(" + ", ".join(
                    f"{s}=dict(pipeline={p}_pipeline)" for s, p in
                    (("train", "train"), ("val", "test"), ("testA", "test"),
                     ("testB", "test"))) + ")\n")
    wd = os.path.join(root, "vgtr_work")
    steps, evals = N_SYNTH_TRAIN // TRAIN_BATCH, 3
    res = counted_run("legacy[VGTR train CLI]", lambda: train_cli.main(
        [path, "--work-dir", wd, "--cfg-options", *opts,
         "scheduler_config.max_epoch=1"]),
        K1_STEP * (steps + evals), K1_STEP * steps, card, launches)
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss_total"] for line in f
                  if '"train"' in line]
    if res["step"] != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"VGTR train CLI: {res['step']} steps, losses "
                             f"{losses}")
    ep = res["epochs"][0]

    cfg = Config.fromfile(path)
    cfg.merge_from_dict(parse_cfg_options(opts))
    ds = build_dataset_from_cfg(cfg.data.train, dataset_type=cfg.dataset,
                                seed=cfg.seed)
    n = min(16, len(ds))
    t0 = time.perf_counter()
    samples = [ds[i] for i in range(n)]
    host = (time.perf_counter() - t0) * 1e3 / n
    worst, differ, dev_ms = 0, 0, []
    for s in samples[:8]:
        img = decode(s["img_bytes"], "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = apply_pixel_ops(img, s["pixel_ops"])
        torch.cuda.synchronize()
        dev_ms.append((time.perf_counter() - t0) * 1e3)
        on_cpu = apply_pixel_ops(img.cpu(), s["pixel_ops"])
        diff = (on_card.cpu().int() - on_cpu.int()).abs()
        worst, differ = max(worst, diff.max().item()), differ + int(
            (diff > 0).sum())
    bound = len(samples[0]["pixel_ops"])
    log(f"legacy[VGTR]: train CLI {steps} steps of {TRAIN_BATCH}, loss_total "
        f"{losses}, epoch {ep['seconds']:.2f} s ({ep['images_per_s']:.1f} "
        f"images/s), eval {res['eval']['val']}; dataset host {host:.3f} ms a "
        f"sample (VGTR draws and geometry, no pixels); pixel ops on the "
        f"card {np.median(dev_ms):.3f} ms a 480x640 sample (median of 8); "
        f"card against CPU on the same decoded images: max {worst} levels, "
        f"{differ} values differ (bound {bound}: a level an op) [{card}]")
    if worst > bound:
        raise AssertionError(f"VGTR pixel ops: the card {worst} levels from "
                             f"the CPU")


def legacy_phase(card, root, synth, launches):
    """The BEiT-3 task heads (``heads_part``), the SeqTR/MDETR layers and
    the legacy losses (``legacy_layers_part``), and VGTRAugment through the
    train CLI (``vgtr_part``)."""
    heads_part(card, launches)
    legacy_layers_part(card, launches)
    vgtr_part(card, root, synth, launches)


def serving_phases(card, root, synth):
    """The serving entry points: "prune", "export", "serve", "demo" and
    "inference", each path's K1 launches counted from 0 around it.
    Returns {path: K1 launches}."""
    import numpy as np
    import torch
    from simvg_tpu_torch.config import Config

    cfg = Config.fromfile(FLAGSHIP)
    norm = dict(mean=cfg.img_norm_cfg["mean"], std=cfg.img_norm_cfg["std"],
                to_rgb=True)
    loader = make_requests(np.random.default_rng(SEED), N_BATCHES, BATCH,
                           cfg.model.vis_enc.vocab_size, cfg.max_token,
                           cfg.img_size)
    imgdir = os.path.join(root, "synth", "images")
    launches = {}
    for name, fn in (
            ("prune", lambda ls: prune_phase(card, cfg, loader, norm, ls)),
            ("export", lambda ls: export_phase(card, model, loader, norm,
                                               root, ls)),
            ("serve", lambda ls: serve_phase(card, root, imgdir, ls)),
            ("demo+inference", lambda ls: demo_inference_phase(
                card, root, imgdir, synth, ls))):
        counts = []
        result = fn(counts)
        if name == "prune":
            model, _ = result
        launches[name] = sum(k1 for k1, _ in counts)
        if any(k2 for _, k2 in counts):
            raise AssertionError(f"{name}: K2 launched on a serving path")
    del model
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from simvg_tpu_torch.ops import _build
    from simvg_tpu_torch.tools.train import disable_tf32

    card = card_line()
    log(card)
    disable_tf32()
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
    t0 = time.perf_counter()
    headdim = headdim_phase(card)
    log(f"headdim phase: {time.perf_counter() - t0:.1f} s")
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # the slice-9 phases run before the earlier slices' checks: no phase
        # leaves state that a later one sees (phase_order.py prints the
        # GRefCOCO check's weights, batch and distances after each)
        t0 = time.perf_counter()
        counts = []
        options_phase(card, root, step_ms, counts)
        options_k1, options_k2 = (sum(c[i] for c in counts) for i in (0, 1))
        log(f"options phase: {time.perf_counter() - t0:.1f} s")
        check_jpeg(card)
        synth = data_phase(card, root, step_ms)
        cli_k1, cli_k2, cli_losses = cli_phase(card, root, synth)
        t0 = time.perf_counter()
        counts = []
        masks_phase(card, root, synth, counts)
        masks_k1, masks_k2 = (sum(c[i] for c in counts) for i in (0, 1))
        log(f"masks phase: {time.perf_counter() - t0:.1f} s")
        grec_k1, grec_k2 = grec_phase(card, root)
        mixed_k1, mixed_k2 = mixed_phase(card, root)
        serving = serving_phases(card, root, synth)
        t0 = time.perf_counter()
        counts = []
        png_row = png_phase(card, root, synth, counts)
        png_launches = sum(counts)
        log(f"png phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        counts = []
        format_rows = formats_phase(card, root, synth, counts)
        log(f"formats phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        counts = []
        int8_phase(card, root, synth, counts)
        int8_k1, int8_k2 = (sum(c[i] for c in counts) for i in (0, 1))
        log(f"int8 phase: {time.perf_counter() - t0:.1f} s")
        t_dist = time.perf_counter()
        dist_k1, dist_k2 = dist_cli_phase(card, root, synth, cli_losses)
        t_dist = time.perf_counter() - t_dist
        # the slice-10 phases run after every check that shares the
        # synthetic JPEGs, so none of those moves; the remat and dist
        # phases after them compare models within the phase
        new = {}
        for name, fn in (("onestage", onestage_phase),
                         ("tools", tools_phase), ("zoo", zoo_phase),
                         ("legacy", legacy_phase)):
            t0 = time.perf_counter()
            counts = []
            fn(card, root, synth, counts)
            new[name] = tuple(sum(c[i] for c in counts) for i in (0, 1))
            log(f"{name} phase: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    counts = []
    remat, large_state = remat_phase(card, counts)
    remat_k1, remat_k2 = (sum(c[i] for c in counts) for i in (0, 1))
    log(f"remat phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = []
    dist_phase(card, remat, large_state, counts)
    del large_state
    dist_k1 += sum(c[0] for c in counts)
    dist_k2 += sum(c[1] for c in counts)
    log(f"dist phase: {time.perf_counter() - t0 + t_dist:.1f} s")
    log(f"launches on the main paths: K1 serve {serve_k1}, train {train_k1}, "
        f"options {options_k1}, cli {cli_k1}, grec {grec_k1}, mixed "
        f"{mixed_k1}, masks {masks_k1}, "
        + ", ".join(f"{k} {v}" for k, v in serving.items())
        + f", int8 {int8_k1}, remat {remat_k1}, dist {dist_k1}, onestage "
        f"{new['onestage'][0]}, tools {new['tools'][0]}, zoo "
        f"{new['zoo'][0]}, legacy {new['legacy'][0]}, headdim "
        f"{ {hd: c[0] for hd, c in headdim.items()} }; K2 train "
        f"{train_k2}, options {options_k2}, cli {cli_k2}, grec {grec_k2}, "
        f"mixed {mixed_k2}, masks {masks_k2}, int8 {int8_k2}, remat "
        f"{remat_k2}, dist {dist_k2}, onestage {new['onestage'][1]}, tools "
        f"{new['tools'][1]}, zoo {new['zoo'][1]}, legacy "
        f"{new['legacy'][1]}, headdim "
        f"{ {hd: c[1] for hd, c in headdim.items()} }; PNG kernel "
        f"{png_launches} (loader and server); "
        + ", ".join(f"{k} {r['launches']}" for k, r in format_rows.items())
        + " (WebP loader and the server's requests of every format)")
    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")

    # every number on this line is measured in this run, at the train
    # step's shape (batch 32, S=421, bf16; the first row of each
    # instantiation's check); the other shapes are on the "K1" / "K2" lines
    # above.  One entry an instantiation: head_dim 64 (every shipped
    # config's), 32, 128 and 256, and 384 for the split route above 256
    # ("headdim"); the PNG kernel's at 480 x 640 RGB ("png").  device_ms:
    # the kernels' own device time a call (torch.profiler), beside ms.
    # launches: the main paths' counts, each taken from 0 just before its
    # path
    def entry(name, replaces, rows, launches, hd=64):
        rows = [r for r in rows if r["shape"][3] == hd]
        main_row = rows[0]
        errs = [r["max_abs_err"] for r in rows]
        errs = [max(e.values()) if isinstance(e, dict) else e for e in errs]
        label = f"head_dim={hd}" + (", split route" if hd > 256 else "")
        return {"name": name if hd == 64 else f"{name}[{label}]",
                "route": "cuda",
                "source": f"simvg_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(errs), "ms": main_row["ms"],
                "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"],
                "bound_by": main_row["bound_by"],
                "library_ms": main_row["library_ms"],
                "device_ms": main_row["device_ms"]}

    print(json.dumps({"kernels": [
        entry("attention_fwd", "simvg_tpu/ops/pallas_attention.py:55",
              k1_rows, serve_k1 + train_k1 + options_k1 + cli_k1 + grec_k1
              + mixed_k1 + masks_k1 + sum(serving.values()) + int8_k1
              + remat_k1 + dist_k1 + sum(k1 for k1, _ in new.values())),
        entry("attention_bwd", "simvg_tpu/ops/pallas_attention.py:66",
              k2_rows, train_k2 + options_k2 + cli_k2 + grec_k2 + mixed_k2
              + masks_k2 + int8_k2 + remat_k2 + dist_k2
              + sum(k2 for _, k2 in new.values())),
    ] + [entry("attention_fwd", "simvg_tpu/ops/pallas_attention.py:55",
               k1_rows, headdim[hd][0], hd) for hd in HEADDIM_HEADS]
        + [entry("attention_bwd", "simvg_tpu/ops/pallas_attention.py:66",
                 k2_rows, headdim[hd][1], hd) for hd in HEADDIM_HEADS]
        + [{"name": "png", "route": "cuda",
            "source": "simvg_tpu_torch/csrc/png.cu",
            "replaces": "none (cv2.imdecode in simvg_tpu/data/datasets.py:158"
                        " and tools/serve.py:265, on the host)",
            "launches": png_launches,
            **{k: png_row[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms")}}]
        + [{"name": k, "route": "cuda",
            "source": f"simvg_tpu_torch/csrc/{k}.cu",
            "replaces": "none (cv2.imdecode in simvg_tpu/data/datasets.py:158"
                        " and tools/serve.py:265, on the host)",
            **{f: r[f] for f in (
                "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "device_ms", "host_ms",
                "fixture")},
            # the predictor kernel's own numbers (TIFF: beside torch.cumsum)
            **{f: v for f, v in r.items()
               if f.startswith("predictor_") or f == "notes"}}
           for k, r in format_rows.items()]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
