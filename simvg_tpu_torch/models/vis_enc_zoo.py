"""The legacy vision encoders of the OneStageModel family (port of
``simvg_tpu/models/vis_enc_zoo.py``): DarkNet53 only.

``tiny_synth_onestage.py``, the one shipped config of the family, uses
DarkNet53 (and the reference's ``DarknetMM``, the same network).  The
other backbones of the JAX zoo (CSPDarknet, ResNet, Swin, PVTv2, ViT and
the mixed VL encoders) are not ported: ``build_vis_enc`` raises for them,
naming ROADMAP item M20b.

As in JAX, the conv backbone normalises with GroupNorm (the group count
adapted to the width, ``group_count``) in float32, not BatchNorm.  Images
come in as the data path hands them, NHWC; the convolutions run NCHW and
the feature grid goes out NHWC [B, h, w, C] at stride 32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

# ``vis_enc`` keys the train step reads, not the encoder
TRAINER_KEYS = ("freeze_layer", "pretrain")
DARKNET_TYPES = ("DarkNet53", "DarknetMM")


def group_count(ch: int) -> int:
    """``simvg_tpu/models/vis_encs.py::adaptive_group_norm``'s groups: the
    largest of 32, 16, 8, 4, 2, 1 that divides ``ch``."""
    return next(g for g in (32, 16, 8, 4, 2, 1) if ch % g == 0)


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm(dtype=float32)``: epsilon 1e-6, computed and
    returned in float32 (in float64 for a float64 input, the precision
    reference of ``chip_smoke.py``)."""

    def __init__(self, ch: int):
        super().__init__(group_count(ch), ch, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, torch.float32)
        return F.group_norm(x.to(dt), self.num_groups, self.weight.to(dt),
                            self.bias.to(dt), self.eps)


class DarkNet53(nn.Module):
    """Darknet-53: a stem conv, then per stage a stride-2 conv and ``n``
    residual blocks (1x1 to half width, 3x3 back); every conv without bias
    and with "same" padding, then GroupNorm and LeakyReLU(0.1).  Module
    names are the flax ones (``stem``, ``s0_down``, ``s0b0c1``, ...)."""

    def __init__(self, stage_blocks: Sequence[int] = (1, 2, 8, 8, 4),
                 stage_widths: Sequence[int] = (64, 128, 256, 512, 1024),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stage_blocks = tuple(stage_blocks)
        self.out_channels = stage_widths[-1]
        self._conv("stem", 3, 32, 3, 1)
        c = 32
        for si, (n, w) in enumerate(zip(stage_blocks, stage_widths)):
            self._conv(f"s{si}_down", c, w, 3, 2)
            for bi in range(n):
                self._conv(f"s{si}b{bi}c1", w, w // 2, 1, 1,
                           norm=f"s{si}b{bi}n1")
                self._conv(f"s{si}b{bi}c2", w // 2, w, 3, 1,
                           norm=f"s{si}b{bi}n2")
            c = w

    def _conv(self, name, cin, cout, k, stride, norm=None):
        self.add_module(name, nn.Conv2d(cin, cout, k, stride, (k - 1) // 2,
                                        bias=False))
        self.add_module(norm or f"{name}_n", GroupNorm(cout))

    def _block(self, x, conv, norm):
        conv, dt = getattr(self, conv), self.dtype
        x = F.conv2d(x.to(dt), conv.weight.to(dt), None, conv.stride,
                     conv.padding)
        return F.leaky_relu(getattr(self, norm)(x).to(dt), 0.1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] -> features [B, H/32, W/32, C]."""
        x = self._block(images.permute(0, 3, 1, 2), "stem", "stem_n")
        for si, n in enumerate(self.stage_blocks):
            x = self._block(x, f"s{si}_down", f"s{si}_down_n")
            for bi in range(n):
                h = self._block(x, f"s{si}b{bi}c1", f"s{si}b{bi}n1")
                x = x + self._block(h, f"s{si}b{bi}c2", f"s{si}b{bi}n2")
        return x.permute(0, 2, 3, 1)


def build_vis_enc(cfg: dict, dtype: torch.dtype = torch.float32
                  ) -> DarkNet53:
    """The zoo encoder of a reference-style ``vis_enc`` dict; only the
    DarkNet53 family is ported."""
    cfg = {k: v for k, v in cfg.items() if k not in TRAINER_KEYS}
    typ = cfg.pop("type", None)
    if typ not in DARKNET_TYPES:
        raise NotImplementedError(
            f"vis_enc type {typ!r} under OneStageModel is not ported "
            "(ROADMAP: M20b); the port has DarkNet53")
    return DarkNet53(dtype=dtype, **cfg)
