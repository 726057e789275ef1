#!/usr/bin/env python3
"""bf16 precision of the attention kernels on the flagship's weights.

Run from the repository root on the H100 (about a minute and a half):

    python3 bf16_precision.py

1. Every attention call of one train-mode forward and backward of the
   flagship (``chip_smoke.py``'s random weights from its seed, batch 32,
   bf16, dropout off): the output and the dq, dk, dv that K1/K2 gave the
   model, and those of plain attention in bf16 on the call's own q, k, v
   and output gradient, each against plain attention in float32 on the
   same bf16 inputs.  Printed per call: max abs and relative L2 error.
2. Whether ``chip_smoke.py``'s float32-referenced bf16 gates catch a wrong
   kernel: each case wraps the kernels' entry point in the attention module
   for the run (no file changes) and runs the serving and the train gate.

It prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402


def plain_attention(q, k, v, mask, dtype):
    """The plain path of ``ops/attention.py`` on pre-scaled [B, S, H, hd]
    inputs: float32 logits and softmax, P cast to ``dtype``, P.V summed in
    float32 and returned in ``dtype``."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if mask is not None:
        logits = logits.masked_fill(mask.bool()[:, None, None, :],
                                    float("-inf"))
    p = torch.softmax(logits, -1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(dtype)


def per_call_errors(calls):
    """Per recorded call: the kernels' output and gradients, as the model
    computed them, and plain attention in bf16 on the same inputs, each
    against plain attention in float32."""
    for i, c in enumerate(calls):
        res = {"K1/K2": [c[n].float() for n in ("out", "dq", "dk", "dv")]}
        for name, dtype in (("fp32", torch.float32),
                            ("plain", torch.bfloat16)):
            ins = [c[n].to(dtype).requires_grad_(True) for n in "qkv"]
            out = plain_attention(*ins, c["mask"], dtype)
            grads = torch.autograd.grad(out, ins, c["dout"].to(dtype))
            res[name] = [t.float() for t in (out, *grads)]
        parts = []
        for j, n in enumerate(("out", "dq", "dk", "dv")):
            ref = res["fp32"][j]
            e = {r: ((res[r][j] - ref).abs().max().item(),
                     ((res[r][j] - ref).norm() / ref.norm()).item())
                 for r in ("K1/K2", "plain")}
            parts.append(f"{n} max {e['K1/K2'][0]:.3g}/{e['plain'][0]:.3g} "
                         f"relL2 {e['K1/K2'][1]:.3g}/{e['plain'][1]:.3g}")
        cs.log(f"  layer {i} {tuple(c['q'].shape)}: " + "; ".join(parts))


class ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``s``."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def wrong_kernels(kernel):
    """Wrappers of the kernels' entry point, each with one fault."""
    return {
        "K1 ignores the key padding mask":
            lambda q, k, v, key_padding_mask=None: kernel(q, k, v, None),
        "K1 output x (1 + 2^-6)":
            lambda q, k, v, key_padding_mask=None: kernel(
                q, k, v, key_padding_mask=key_padding_mask) * (1 + 2 ** -6),
        "K1 logits x 1.1":
            lambda q, k, v, key_padding_mask=None: kernel(
                (q * 1.1).contiguous(), k, v,
                key_padding_mask=key_padding_mask),
        "K2 dq x 1.05":
            lambda q, k, v, key_padding_mask=None: kernel(
                ScaleGrad.apply(q, 1.05), k, v,
                key_padding_mask=key_padding_mask),
        "K2 dv x 1.05":
            lambda q, k, v, key_padding_mask=None: kernel(
                q, k, ScaleGrad.apply(v, 1.05),
                key_padding_mask=key_padding_mask),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("bf16_precision: no CUDA device", file=sys.stderr)
        return 1
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.ops import _build
    from simvg_tpu_torch.ops import attention as attn_mod
    from simvg_tpu_torch.tools.train import disable_tf32

    cs.log(cs.card_line())
    disable_tf32()
    _build.build_all(cs.KERNELS)
    cfg = Config.fromfile(cs.FLAGSHIP)
    model, loss_cfg = cs.build_flagship(cfg, "pallas", torch.bfloat16)
    enc = model.cfg.beit3
    norm = dict(mean=cfg.img_norm_cfg["mean"], std=cfg.img_norm_cfg["std"],
                to_rgb=True)
    requests = cs.make_requests(np.random.default_rng(cs.SEED), cs.N_BATCHES,
                                cs.BATCH, enc.vocab_size, cfg.max_token,
                                cfg.img_size)
    batch = cs.to_device(cs.make_requests(
        np.random.default_rng(cs.SEED + 1), 1, cs.TRAIN_BATCH,
        enc.vocab_size, cfg.max_token, cfg.img_size)[0], cs.TRAIN_KEYS)
    state = model.state_dict()

    cs.log("attention calls of one train forward and backward, errors "
           "against float32 plain attention, K1/K2 / bf16 plain:")
    cs.dropout_off(model)
    with cs.recorded_attention() as calls:
        cs.losses_and_grads(model, batch, loss_cfg, norm)
    per_call_errors(calls)
    model.eval()

    kernel = attn_mod.fused_attention
    for name, wrong in wrong_kernels(kernel).items():
        attn_mod.fused_attention = wrong
        gates = [("train", lambda: cs.hold_train_against_plain(
            "flagship", cfg, state, batch, loss_cfg, norm))]
        if name.startswith("K1"):
            gates.insert(0, ("serve", lambda: cs.compare_with_plain(
                cfg, model, requests, norm)))
        try:
            for gate, run in gates:
                try:
                    run()
                    verdict = "passed"
                except AssertionError as e:
                    verdict = f"caught ({e})"
                cs.log(f"== {name}, {gate} gate: {verdict}")
        finally:
            attn_mod.fused_attention = kernel
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
