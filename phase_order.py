#!/usr/bin/env python3
"""Whether a ``chip_smoke.py`` phase leaves state that a later phase's bf16
check sees: runs the named phases in order in one process, on one card.

    python3 phase_order.py                      # grec grec options grec
    python3 phase_order.py data masks grec      # any order of the four

Phases: ``grec``, ``options``, ``data`` and ``masks`` (``masks`` needs
``data`` before it), each as ``chip_smoke.py`` runs it.  Before each it
prints the global RNG states (CPU, CUDA, numpy, Python; as digests), the
backend flags that set matmul precision, reduction and attention routes, and
the names of the functions that the script's context managers patch.  At
each of ``chip_smoke.hold_train_against_plain``'s calls it prints digests of
the weights and of the batch it gets and whether the bf16 rule held; a
failing rule is printed, and the run goes on.  Equal digests and equal
distances across orders mean the check does not depend on what ran before
it."""

import hashlib
import os
import random
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402


def digest(data: bytes) -> str:
    return hashlib.sha1(data).hexdigest()[:12]


def tensor_bytes(t) -> bytes:
    import torch

    return t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()


def global_state(tag):
    import numpy as np
    import torch
    from simvg_tpu_torch.losses import criterion, distill
    from simvg_tpu_torch.ops import attention

    b = torch.backends
    rng = dict(cpu=digest(tensor_bytes(torch.get_rng_state())),
               cuda=digest(tensor_bytes(torch.cuda.get_rng_state())),
               numpy=digest(repr(np.random.get_state()).encode()),
               python=digest(repr(random.getstate()).encode()))
    flags = dict(
        matmul_tf32=b.cuda.matmul.allow_tf32, cudnn_tf32=b.cudnn.allow_tf32,
        cudnn_benchmark=b.cudnn.benchmark,
        cudnn_deterministic=b.cudnn.deterministic,
        bf16_reduced=b.cuda.matmul.allow_bf16_reduced_precision_reduction,
        fp16_reduced=b.cuda.matmul.allow_fp16_reduced_precision_reduction,
        f32_precision=torch.get_float32_matmul_precision(),
        deterministic=torch.are_deterministic_algorithms_enabled(),
        sdp=(b.cuda.flash_sdp_enabled(), b.cuda.mem_efficient_sdp_enabled(),
             b.cuda.math_sdp_enabled()),
        default_dtype=str(torch.get_default_dtype()),
        grad=torch.is_grad_enabled())
    patched = [f.__qualname__ for f in (
        criterion.hungarian_assign, distill.hungarian_assign,
        attention.fused_attention, criterion.soft_distill_losses)]
    cs.log(f"state {tag}: rng {rng}; flags {flags}; patched {patched}")


def main(argv) -> int:
    import torch
    from simvg_tpu_torch.ops import _build
    from simvg_tpu_torch.tools.train import disable_tf32

    if not torch.cuda.is_available():
        print("phase_order: no CUDA device", file=sys.stderr)
        return 1
    held = cs.hold_train_against_plain

    def digested(name, cfg, state, batch, loss_cfg, norm):
        weights = hashlib.sha1()
        for k in sorted(state):
            weights.update(tensor_bytes(state[k]))
        data = hashlib.sha1()
        for k in sorted(batch):
            if isinstance(batch[k], torch.Tensor):
                data.update(tensor_bytes(batch[k]))
        cs.log(f"check {name}: weights {weights.hexdigest()[:12]} batch "
               f"{data.hexdigest()[:12]}")
        try:
            held(name, cfg, state, batch, loss_cfg, norm)
            cs.log(f"check {name}: the rule held")
        except AssertionError as e:
            cs.log(f"check {name}: the rule FAILED: {e}")

    cs.hold_train_against_plain = digested
    card = cs.card_line()
    cs.log(card)
    disable_tf32()
    _build.build_all(cs.KERNELS + ("jpeg",))
    root = tempfile.mkdtemp(prefix="phase_order_")
    synth = None
    try:
        for i, phase in enumerate(argv or ("grec", "grec", "options",
                                           "grec")):
            global_state(f"{i} before {phase}")
            t0 = time.perf_counter()
            sub = tempfile.mkdtemp(dir=root)
            if phase == "grec":
                cs.grec_phase(card, sub)
            elif phase == "options":
                cs.options_phase(card, sub, 0.0, [])
            elif phase == "data":
                synth = cs.data_phase(card, sub, 0.0)
            elif phase == "masks":
                cs.masks_phase(card, sub, synth, [])
            else:
                raise SystemExit(f"unknown phase {phase!r}")
            cs.log(f"phase {i} {phase}: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
        global_state("end")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
