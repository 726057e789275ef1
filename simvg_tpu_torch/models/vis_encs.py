"""ResNet and ViT backbones of the OneStageModel family (port of
``simvg_tpu/models/vis_encs.py``): ``forward(images NHWC) -> [B, h, w, C]``
at stride 32, with ``out_channels``.  Names are the flax ones; the shared
layers are ``vis_enc_zoo``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from simvg_tpu_torch.ops.attention import multihead_attention
from .layers import Linear
from .vis_enc_zoo import Conv, GroupNorm, conv_nhwc, grid, ln, table


class ResNetEncoder(nn.Module):
    """Bottleneck ResNet (depths (3, 4, 6, 3): ResNet-50): a 7x7/2 stem,
    GroupNorm and ReLU, a 3x3/2 max-pool, then stages of 1x1-3x3-1x1
    blocks (the 3x3 at stride 2 in each stage's first block but the first
    stage's), with a 1x1 conv and GroupNorm on the shortcut where the
    block changes the width or the stride.  No conv has a bias."""

    def __init__(self, depths: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (256, 512, 1024, 2048),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.depths = tuple(depths)
        self.stem = Conv(3, 64, 7, 2, 3, dtype=dtype)
        self.stem_norm = GroupNorm(64)
        cin = 64
        for si, (depth, width) in enumerate(zip(depths, widths)):
            for bi in range(depth):
                p = f"s{si}b{bi}"
                stride = 2 if bi == 0 and si > 0 else 1
                for name, (a, b, k, s) in (
                        ("1", (cin, width // 4, 1, 1)),
                        ("2", (width // 4, width // 4, 3, stride)),
                        ("3", (width // 4, width, 1, 1))):
                    self.add_module(f"{p}c{name}", Conv(a, b, k, s,
                                                        dtype=dtype))
                    self.add_module(f"{p}n{name}", GroupNorm(b))
                # JAX adds it where the shapes differ: the same blocks
                # unless a stride-2 conv meets a grid of 1
                if cin != width or stride != 1:
                    self.add_module(p + "sc", Conv(cin, width, 1, stride,
                                                   dtype=dtype))
                    self.add_module(p + "scn", GroupNorm(width))
                cin = width
        self.out_channels = widths[-1]

    def _norm(self, x, name):
        return getattr(self, name)(x).to(self.dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.stem(images.permute(0, 3, 1, 2))
        x = F.relu(self._norm(x, "stem_norm"))
        x = F.max_pool2d(x, 3, 2, 1)
        for si, depth in enumerate(self.depths):
            for bi in range(depth):
                p = f"s{si}b{bi}"
                h = F.relu(self._norm(getattr(self, p + "c1")(x), p + "n1"))
                h = F.relu(self._norm(getattr(self, p + "c2")(h), p + "n2"))
                h = self._norm(getattr(self, p + "c3")(h), p + "n3")
                if hasattr(self, p + "sc"):
                    x = self._norm(getattr(self, p + "sc")(x), p + "scn")
                x = F.relu(x + h)
        return x.permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 640
    patch_size: int = 32
    embed_dim: int = 768
    num_heads: int = 12
    ffn_dim: int = 3072
    num_layers: int = 12
    drop_path_rate: float = 0.0  # read by neither package


class ViTEncoder(nn.Module):
    """Plain pre-LN ViT over image patches: separate q/k/v Linears, the
    FFN's GELU in float32, a closing LayerNorm.  The position table covers
    the patch grid of ``img_size``."""

    def __init__(self, cfg: ViTConfig = ViTConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d, ps = cfg.embed_dim, cfg.patch_size
        self.patch_embed = Conv(3, d, ps, ps, 0, bias=True, dtype=dtype)
        gh, gw = grid(cfg.img_size, ps)
        self.pos_embed = table(1, gh * gw, d)
        for i in range(cfg.num_layers):
            self.add_module(f"ln1_{i}", ln(d))
            for name in ("q", "k", "v", "proj"):
                self.add_module(f"{name}_{i}", Linear(d, d, dtype))
            self.add_module(f"ln2_{i}", ln(d))
            self.add_module(f"fc1_{i}", Linear(d, cfg.ffn_dim, dtype))
            self.add_module(f"fc2_{i}", Linear(cfg.ffn_dim, d, dtype))
        self.ln_final = ln(d)
        self.out_channels = d

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.dtype
        m = self.get_submodule
        x = conv_nhwc(self.patch_embed, images)
        b, h, w, d = x.shape
        x = x.reshape(b, h * w, d) + self.pos_embed.to(dt)
        for i in range(cfg.num_layers):
            hx = m(f"ln1_{i}")(x).to(dt)
            a = multihead_attention(m(f"q_{i}")(hx), m(f"k_{i}")(hx),
                                    m(f"v_{i}")(hx), num_heads=cfg.num_heads,
                                    dtype=dt)
            x = x + m(f"proj_{i}")(a)
            hx = m(f"fc1_{i}")(m(f"ln2_{i}")(x).to(dt))
            acc = torch.promote_types(dt, torch.float32)
            x = x + m(f"fc2_{i}")(F.gelu(hx.to(acc)).to(dt))
        return self.ln_final(x).reshape(b, h, w, d).to(dt)
