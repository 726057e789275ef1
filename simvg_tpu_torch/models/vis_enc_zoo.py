"""The legacy vision-encoder zoo of the OneStageModel family (port of
``simvg_tpu/models/vis_enc_zoo.py``; ResNet and ViT are in ``vis_encs.py``).

Pure-vision backbones, ``forward(images NHWC) -> [B, h, w, C]`` at stride
32, each with ``out_channels``: DarkNet53, CSPDarknet, SwinTransformer,
PyramidVisionTransformerV2, ViTDet (and ResNet, ViT).  The mixed
vision-language encoders, ``forward(images, text, text_mask) -> dict``:
ViTMix, CvTMix, YOLOSEncoder (text optional), ViLTEncoder (word ids).
``ComposedOneStageModel`` calls its backbone on the image alone, as JAX's
does, so the mixed encoders serve only through ``build_vis_enc``.

Module and parameter names are the flax ones (``s0b0_attn.rel_pos_bias``,
``block3.q``, ``pos_embed``, ...), so ``convert.export_composed`` carries a
JAX tree across.  As in JAX:

- the conv backbones normalise with GroupNorm (the group count adapted to
  the width, ``group_count``), every LayerNorm has flax's epsilon 1e-6, and
  both compute in float32 and return in the module's dtype;
- parameters are float32 and every Linear and conv computes in ``dtype``;
- every attention is ``multihead_attention``'s plain path (JAX's
  ``impl="xla"`` default), never K1;
- flax sizes the position tables (ViT, ViTDet, ViTMix, YOLOS, ViLT) and
  Swin's windows from the first input; the port builds them for the canvas
  ``img_size`` it is given.

Images come in NHWC as the data path hands them; the convolutions run
NCHW.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from simvg_tpu_torch.ops.attention import multihead_attention
from .layers import LayerNorm, Linear

# ``vis_enc`` keys the train step reads, not the encoder
TRAINER_KEYS = ("freeze_layer", "pretrain")

Canvas = Union[int, Tuple[int, int]]


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


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` on float32 parameters, computed in ``dtype``, NCHW:
    ``padding`` on every side, (k - 1) // 2 unless given."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: Optional[int] = None, groups: int = 1,
                 bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, k, stride,
                         (k - 1) // 2 if padding is None else padding,
                         groups=groups, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        stride = self.stride
        if (x.device.type == "cpu" and self.kernel_size == (1, 1)
                and self.padding == (0, 0) and stride != (1, 1)):
            # a strided 1x1 conv reads every stride-th pixel: taken so on
            # the CPU, whose backward of the strided form corrupts the heap
            # on a channels-last input (torch 2.13)
            x, stride = x[:, :, ::stride[0], ::stride[1]], 1
        return F.conv2d(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt),
                        stride, self.padding, 1, self.groups)


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on an NHWC tensor, NHWC out."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def ln(dim: int) -> LayerNorm:
    """flax ``nn.LayerNorm(dtype=float32)``: epsilon 1e-6."""
    return LayerNorm(dim, eps=1e-6)


def table(*shape: int) -> nn.Parameter:
    """A learned table (position, token, bias), N(0, 0.02) until
    ``init_random_weights`` draws flax's initialiser."""
    return nn.Parameter(torch.empty(shape).normal_(0.0, 0.02))


def grid(img_size: Canvas, patch: int) -> Tuple[int, int]:
    """The patch grid a VALID ``patch``-stride conv makes of the canvas."""
    h, w = (img_size, img_size) if isinstance(img_size, int) else img_size
    return h // patch, w // patch


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
        self.add_module(name, Conv(cin, cout, k, stride, dtype=self.dtype))
        self.add_module(norm or f"{name}_n", GroupNorm(cout))

    def _block(self, x, conv, norm):
        x = getattr(self, norm)(getattr(self, conv)(x))
        return F.leaky_relu(x.to(self.dtype), 0.1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] -> features [B, H/32, W/32, C]."""
        x = self._block(images.permute(0, 3, 1, 2), "stem", "stem_n")
        for si, n in enumerate(self.stage_blocks):
            x = self._block(x, f"s{si}_down", f"s{si}_down_n")
            for bi in range(n):
                h = self._block(x, f"s{si}b{bi}c1", f"s{si}b{bi}n1")
                x = x + self._block(h, f"s{si}b{bi}c2", f"s{si}b{bi}n2")
        return x.permute(0, 2, 3, 1)


class CSPDarknet(nn.Module):
    """CSPDarknet: a Focus stem (space-to-depth 2x2, channels in flax's
    (row, column, channel) order, then a conv), then per stage a stride-2
    conv, in the last stage the SPP block (max-pools 5/9/13 at stride 1
    beside their input), and the CSP split: a main path of ``n`` residual
    1x1-3x3 blocks and a shortcut, fused by a 1x1 conv.  Every conv is
    conv, GroupNorm, SiLU."""

    def __init__(self, stage_blocks: Sequence[int] = (1, 3, 3, 1),
                 stage_widths: Sequence[int] = (128, 256, 512, 1024),
                 dtype: torch.dtype = torch.float32,
                 spp_kernels: Sequence[int] = (5, 9, 13)):
        super().__init__()
        self.dtype = dtype
        self.stage_blocks = tuple(stage_blocks)
        self.spp_kernels = tuple(spp_kernels)
        self.out_channels = stage_widths[-1]
        self._cba("focus", 12, 64, 3)
        c = 64
        last = len(stage_blocks) - 1
        for si, (n, w) in enumerate(zip(stage_blocks, stage_widths)):
            self._cba(f"s{si}_down", c, w, 3, 2)
            if si == last:
                self._cba(f"s{si}_spp_in", w, w // 2, 1)
                self._cba(f"s{si}_spp_out",
                          w // 2 * (1 + len(self.spp_kernels)), w, 1)
            self._cba(f"s{si}_main_in", w, w // 2, 1)
            self._cba(f"s{si}_short", w, w // 2, 1)
            for bi in range(n):
                self._cba(f"s{si}b{bi}c1", w // 2, w // 2, 1)
                self._cba(f"s{si}b{bi}c2", w // 2, w // 2, 3)
            self._cba(f"s{si}_fuse", w, w, 1)
            c = w

    def _cba(self, name, cin, cout, k, stride=1):
        self.add_module(name, Conv(cin, cout, k, stride, dtype=self.dtype))
        self.add_module(name + "_n", GroupNorm(cout))

    def _run(self, x, name):
        x = getattr(self, name + "_n")(getattr(self, name)(x))
        return F.silu(x.to(self.dtype))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = images.shape
        x = images.to(self.dtype).reshape(b, hh // 2, 2, ww // 2, 2, c)
        # channel (dy * 2 + dx) * c + ch, as JAX's NHWC reshape orders it
        x = x.permute(0, 2, 4, 5, 1, 3).reshape(b, 4 * c, hh // 2, ww // 2)
        x = self._run(x, "focus")
        last = len(self.stage_blocks) - 1
        for si, n in enumerate(self.stage_blocks):
            x = self._run(x, f"s{si}_down")
            if si == last:
                h = self._run(x, f"s{si}_spp_in")
                pools = [h] + [F.max_pool2d(h, k, 1, k // 2)
                               for k in self.spp_kernels]
                x = self._run(torch.cat(pools, 1), f"s{si}_spp_out")
            main = self._run(x, f"s{si}_main_in")
            short = self._run(x, f"s{si}_short")
            for bi in range(n):
                h = self._run(main, f"s{si}b{bi}c1")
                main = main + self._run(h, f"s{si}b{bi}c2")
            x = self._run(torch.cat([main, short], 1), f"s{si}_fuse")
        return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------- Swin

@dataclasses.dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    embed_dim: int = 96
    depths: Sequence[int] = (2, 2, 6, 2)
    num_heads: Sequence[int] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0


def win_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, w * w, C], batch-major, windows row-major."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // w, w, ww // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def win_reverse(x: torch.Tensor, w: int, h: int, ww: int) -> torch.Tensor:
    """The inverse of ``win_partition`` onto an [B, h, ww, C] grid."""
    b = x.shape[0] // ((h // w) * (ww // w))
    x = x.reshape(b, h // w, ww // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, ww, -1)


@functools.lru_cache(maxsize=64)
def _rel_index(w: int, device: torch.device) -> torch.Tensor:
    """Row of the relative-position table of each (query, key) pair of a
    w x w window, flattened [w^4]."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing="ij")).reshape(2, -1)
    d = coords[:, :, None] - coords[:, None, :]
    idx = (d[0] + w - 1) * (2 * w - 1) + (d[1] + w - 1)
    return torch.as_tensor(idx.reshape(-1), device=device)


@functools.lru_cache(maxsize=64)
def _shift_mask(h: int, w: int, win: int, shift: int, device: torch.device,
                dtype: torch.dtype) -> torch.Tensor:
    """JAX's ``_swin_shift_mask``: [nW, 1, N, N], -1e30 between tokens of
    a shifted window that come from different regions, else 0."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift),
                   slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    x = img.reshape(h // win, win, w // win, win).transpose(0, 2, 1, 3)
    x = x.reshape(-1, win * win)
    diff = x[:, :, None] - x[:, None, :]
    mask = np.where(diff != 0, -1e30, 0.0)[:, None]
    return torch.as_tensor(mask, dtype=dtype, device=device)


class WindowAttention(nn.Module):
    """Attention within w x w windows with a learned relative-position bias
    ((2w - 1)^2 rows, one column a head) and an optional additive mask."""

    def __init__(self, dim: int, heads: int, window: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.window, self.dtype = heads, window, dtype
        self.rel_pos_bias = table((2 * window - 1) ** 2, heads)
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.proj = Linear(dim, dim, dtype)

    def forward(self, x, bias=None):
        """x [nW * B, w * w, C]; bias [nW * B, 1, N, N] or None."""
        n = self.window ** 2
        rpb = self.rel_pos_bias[_rel_index(self.window, x.device)]
        rpb = rpb.reshape(n, n, self.heads).permute(2, 0, 1)[None]
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        out = multihead_attention(
            q, k, v, num_heads=self.heads,
            attn_bias=rpb if bias is None else rpb + bias, dtype=self.dtype)
        return self.proj(out)


class SwinTransformer(nn.Module):
    """Swin: a patch conv and LayerNorm, then stages of window-attention
    blocks (every second one shifted by half a window when the window is
    smaller than the padded grid, with JAX's cyclic-shift mask), each stage
    but the last ending in 2x2 patch merging.  A stage's grid is zero
    padded to a window multiple, the padded tokens unmasked, as in JAX.
    The window of each stage, min(window, h, w), comes from the canvas."""

    def __init__(self, cfg: SwinConfig = SwinConfig(), img_size: Canvas = 640,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        ps = cfg.patch_size
        self.patch_embed = Conv(3, cfg.embed_dim, ps, ps, 0, bias=True,
                                dtype=dtype)
        self.patch_norm = ln(cfg.embed_dim)
        h, w = grid(img_size, ps)
        dim = cfg.embed_dim
        self.windows = []
        for si, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            win = min(cfg.window, h, w)
            self.windows.append(win)
            hidden = int(dim * cfg.mlp_ratio)
            for bi in range(depth):
                p = f"s{si}b{bi}"
                self.add_module(p + "_ln1", ln(dim))
                self.add_module(p + "_attn",
                                WindowAttention(dim, heads, win, dtype))
                self.add_module(p + "_ln2", ln(dim))
                self.add_module(p + "_fc1", Linear(dim, hidden, dtype))
                self.add_module(p + "_fc2", Linear(hidden, dim, dtype))
            if si < len(cfg.depths) - 1:
                self.add_module(f"merge{si}_ln", ln(4 * dim))
                self.add_module(f"merge{si}_proj",
                                Linear(4 * dim, 2 * dim, dtype))
                dim *= 2
                h, w = (h + 1) // 2, (w + 1) // 2
        self.final_ln = ln(dim)
        self.out_channels = dim

    def _block(self, x, si, bi):
        dt, p, win = self.dtype, f"s{si}b{bi}", self.windows[si]
        b, h, w, _ = x.shape
        pad_h, pad_w = (-h) % win, (-w) % win
        hp, wp = h + pad_h, w + pad_w
        shift = win // 2 if bi % 2 == 1 and win < min(hp, wp) else 0
        hx = getattr(self, p + "_ln1")(x).to(dt)
        if pad_h or pad_w:
            hx = F.pad(hx, (0, 0, 0, pad_w, 0, pad_h))
        mask = None
        if shift:
            hx = torch.roll(hx, (-shift, -shift), dims=(1, 2))
            attn = getattr(self, p + "_attn")
            mask = _shift_mask(hp, wp, win, shift, x.device,
                               attn.rel_pos_bias.dtype).repeat(b, 1, 1, 1)
        hx = getattr(self, p + "_attn")(win_partition(hx, win), mask)
        hx = win_reverse(hx, win, hp, wp)
        if shift:
            hx = torch.roll(hx, (shift, shift), dims=(1, 2))
        x = x + hx[:, :h, :w]
        hx = getattr(self, p + "_fc1")(getattr(self, p + "_ln2")(x).to(dt))
        return x + getattr(self, p + "_fc2")(F.gelu(hx))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.dtype
        x = self.patch_norm(conv_nhwc(self.patch_embed, images)).to(dt)
        for si, depth in enumerate(cfg.depths):
            for bi in range(depth):
                x = self._block(x, si, bi)
            if si < len(cfg.depths) - 1:
                b, h, w, c = x.shape
                if h % 2 or w % 2:
                    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
                    b, h, w, c = x.shape
                x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(
                    0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
                x = getattr(self, f"merge{si}_ln")(x).to(dt)
                x = getattr(self, f"merge{si}_proj")(x)
        return self.final_ln(x).to(dt)


# ---------------------------------------------------------------- PVTv2

@dataclasses.dataclass(frozen=True)
class PVTv2Config:
    dims: Sequence[int] = (64, 128, 320, 512)
    depths: Sequence[int] = (2, 2, 2, 2)
    heads: Sequence[int] = (1, 2, 5, 8)
    sr_ratios: Sequence[int] = (8, 4, 2, 1)
    mlp_ratios: Sequence[int] = (8, 8, 4, 4)


class PyramidVisionTransformerV2(nn.Module):
    """PVTv2: per stage an overlapping patch conv (7/4, then 3/2) and
    LayerNorm, blocks of spatial-reduction attention (keys and values from
    a conv of kernel = stride = ``sr`` with JAX's padding (sr - 1) // 2,
    then LayerNorm; none when sr is 1) and MixFFN (fc1, depthwise 3x3,
    GELU, fc2), and a closing LayerNorm."""

    def __init__(self, cfg: PVTv2Config = PVTv2Config(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        cin = 3
        for si, (dim, depth, sr, mr) in enumerate(zip(
                cfg.dims, cfg.depths, cfg.sr_ratios, cfg.mlp_ratios)):
            k, s = (7, 4) if si == 0 else (3, 2)
            self.add_module(f"s{si}_embed",
                            Conv(cin, dim, k, s, bias=True, dtype=dtype))
            self.add_module(f"s{si}_embed_ln", ln(dim))
            for bi in range(depth):
                p = f"s{si}b{bi}"
                self.add_module(p + "_ln1", ln(dim))
                for name in ("_q", "_k", "_v", "_proj"):
                    self.add_module(p + name, Linear(dim, dim, dtype))
                if sr > 1:
                    self.add_module(p + "_sr", Conv(dim, dim, sr, sr,
                                                    bias=True, dtype=dtype))
                    self.add_module(p + "_srln", ln(dim))
                self.add_module(p + "_ln2", ln(dim))
                self.add_module(p + "_fc1", Linear(dim, dim * mr, dtype))
                self.add_module(p + "_dw", Conv(dim * mr, dim * mr, 3,
                                                groups=dim * mr, bias=True,
                                                dtype=dtype))
                self.add_module(p + "_fc2", Linear(dim * mr, dim, dtype))
            self.add_module(f"s{si}_out_ln", ln(dim))
            cin = dim
        self.out_channels = cfg.dims[-1]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.dtype
        m = self.get_submodule
        x = images
        for si, (dim, depth, heads, sr) in enumerate(zip(
                cfg.dims, cfg.depths, cfg.heads, cfg.sr_ratios)):
            x = m(f"s{si}_embed_ln")(conv_nhwc(m(f"s{si}_embed"), x)).to(dt)
            b, h, w, _ = x.shape
            seq = x.reshape(b, h * w, dim)
            for bi in range(depth):
                p = f"s{si}b{bi}"
                hx = m(p + "_ln1")(seq).to(dt)
                kv = hx
                if sr > 1:
                    kv = conv_nhwc(m(p + "_sr"), hx.reshape(b, h, w, dim))
                    kv = m(p + "_srln")(kv).to(dt).reshape(b, -1, dim)
                a = multihead_attention(m(p + "_q")(hx), m(p + "_k")(kv),
                                        m(p + "_v")(kv), num_heads=heads,
                                        dtype=dt)
                seq = seq + m(p + "_proj")(a)
                hx = m(p + "_fc1")(m(p + "_ln2")(seq).to(dt))
                hx = conv_nhwc(m(p + "_dw"), hx.reshape(b, h, w, -1))
                seq = seq + m(p + "_fc2")(F.gelu(hx.reshape(b, h * w, -1)))
            x = m(f"s{si}_out_ln")(seq).to(dt).reshape(b, h, w, dim)
        return x


# ------------------------------------------- mixed vision-language encoders

class JointBlock(nn.Module):
    """Pre-LN transformer block over the joint [image; text] sequence, the
    padded text keys masked."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.ln1, self.ln2 = ln(dim), ln(dim)
        for name in ("q", "k", "v", "proj"):
            self.add_module(name, Linear(dim, dim, dtype))
        self.fc1 = Linear(dim, int(dim * mlp_ratio), dtype)
        self.fc2 = Linear(int(dim * mlp_ratio), dim, dtype)

    def forward(self, x, key_padding_mask=None):
        h = self.ln1(x).to(self.dtype)
        a = multihead_attention(self.q(h), self.k(h), self.v(h),
                                num_heads=self.heads,
                                key_padding_mask=key_padding_mask,
                                dtype=self.dtype)
        x = x + self.proj(a)
        h = self.fc1(self.ln2(x).to(self.dtype))
        return x + self.fc2(F.gelu(h))


class _PatchViT(nn.Module):
    """A patch conv (VALID) and ``num_layers`` joint blocks named
    ``block{i}``, shared by ViTMix, YOLOS and ViLT."""

    def _patches(self, ps, dim, num_layers, heads, mlp_ratio, img_size):
        self.patch_embed = Conv(3, dim, ps, ps, 0, bias=True,
                                dtype=self.dtype)
        for i in range(num_layers):
            self.add_module(f"block{i}",
                            JointBlock(dim, heads, mlp_ratio, self.dtype))
        self.final_ln = ln(dim)
        gh, gw = grid(img_size, ps)
        return gh * gw

    def _embed(self, images):
        x = conv_nhwc(self.patch_embed, images)
        b, h, w, d = x.shape
        return x.reshape(b, h * w, d), (h, w)

    def _blocks(self, seq, pad, num_layers):
        for i in range(num_layers):
            seq = getattr(self, f"block{i}")(seq, pad)
        return self.final_ln(seq).to(self.dtype)


def _text_pad(text_mask, b, n_txt, n_before, device):
    """The key-padding mask of [n_before unpadded tokens; text]."""
    if text_mask is None:
        text_mask = torch.zeros(b, n_txt, dtype=torch.bool, device=device)
    return torch.cat([torch.zeros(b, n_before, dtype=torch.bool,
                                  device=device), text_mask.bool()], 1)


@dataclasses.dataclass(frozen=True)
class ViTMixConfig:
    patch_size: int = 16
    embed_dim: int = 768
    num_heads: int = 12
    num_layers: int = 12
    mlp_ratio: float = 4.0


class ViTMix(_PatchViT):
    """VisionTransformerMix: a ViT whose blocks attend jointly over the
    image patches and the projected text features."""

    def __init__(self, cfg: ViTMixConfig = ViTMixConfig(),
                 img_size: Canvas = 640, text_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d = cfg.embed_dim
        n = self._patches(cfg.patch_size, d, cfg.num_layers, cfg.num_heads,
                          cfg.mlp_ratio, img_size)
        self.pos_embed = table(1, n, d)
        self.text_proj = Linear(text_dim or d, d, dtype)

    def forward(self, images, text_feat, text_mask=None):
        x, (h, w) = self._embed(images)
        b, n_img, d = x.shape
        x = x + self.pos_embed.to(self.dtype)
        t = self.text_proj(text_feat)
        pad = _text_pad(text_mask, b, t.shape[1], n_img, x.device)
        seq = self._blocks(torch.cat([x, t], 1), pad, self.cfg.num_layers)
        return {"img_feat": seq[:, :n_img].reshape(b, h, w, d),
                "text_feat": seq[:, n_img:]}


@dataclasses.dataclass(frozen=True)
class CvTMixConfig:
    dims: Sequence[int] = (64, 192, 384)
    depths: Sequence[int] = (1, 2, 10)
    heads: Sequence[int] = (1, 3, 6)
    mlp_ratio: float = 4.0


class CvTMix(nn.Module):
    """ConvolutionalVisionTransformerMix: per stage a conv token embedding
    (7/4, then 3/2) and LayerNorm, then blocks whose q/k/v come from a
    depthwise 3x3 conv (k and v at stride 2, except in the last stage) and
    a Linear; in the last stage the projected text joins the attention
    with its own ``tq``/``tk``/``tv``/``tproj``."""

    def __init__(self, cfg: CvTMixConfig = CvTMixConfig(),
                 text_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        cin = 3
        last = len(cfg.dims) - 1
        for si, (dim, depth) in enumerate(zip(cfg.dims, cfg.depths)):
            k, s = (7, 4) if si == 0 else (3, 2)
            self.add_module(f"s{si}_embed",
                            Conv(cin, dim, k, s, bias=True, dtype=dtype))
            self.add_module(f"s{si}_embed_ln", ln(dim))
            if si == last:
                self.text_proj = Linear(text_dim or dim, dim, dtype)
            hidden = int(dim * cfg.mlp_ratio)
            for bi in range(depth):
                p = f"s{si}b{bi}"
                self.add_module(p + "_ln1", ln(dim))
                for tag in ("q", "k", "v"):
                    stride = 2 if tag != "q" and si != last else 1
                    self.add_module(f"{p}_{tag}dw", Conv(
                        dim, dim, 3, stride, groups=dim, dtype=dtype))
                    self.add_module(f"{p}_{tag}", Linear(dim, dim, dtype))
                self.add_module(p + "_proj", Linear(dim, dim, dtype))
                if si == last:
                    for tag in ("tq", "tk", "tv", "tproj"):
                        self.add_module(f"{p}_{tag}", Linear(dim, dim, dtype))
                self.add_module(p + "_ln2", ln(dim))
                self.add_module(p + "_fc1", Linear(dim, hidden, dtype))
                self.add_module(p + "_fc2", Linear(hidden, dim, dtype))
            cin = dim
        self.final_ln = ln(cfg.dims[-1])
        self.final_text_ln = ln(cfg.dims[-1])

    def forward(self, images, text_feat, text_mask=None):
        cfg, dt = self.cfg, self.dtype
        m = self.get_submodule
        x = images
        b = x.shape[0]
        last = len(cfg.dims) - 1
        for si, (dim, depth, heads) in enumerate(zip(
                cfg.dims, cfg.depths, cfg.heads)):
            x = m(f"s{si}_embed_ln")(conv_nhwc(m(f"s{si}_embed"), x)).to(dt)
            _, h, w, _ = x.shape
            if si == last:
                t = self.text_proj(text_feat)
                n_txt = t.shape[1]
            for bi in range(depth):
                p = f"s{si}b{bi}"
                hx = m(p + "_ln1")(x).to(dt)

                def proj(tag):
                    hh = conv_nhwc(m(f"{p}_{tag}dw"), hx)
                    return m(f"{p}_{tag}")(hh.reshape(b, -1, dim))

                q, kk, vv = proj("q"), proj("k"), proj("v")
                pad = None
                if si == last:
                    q = torch.cat([q, m(p + "_tq")(t)], 1)
                    kk = torch.cat([kk, m(p + "_tk")(t)], 1)
                    vv = torch.cat([vv, m(p + "_tv")(t)], 1)
                    pad = _text_pad(text_mask, b, n_txt, kk.shape[1] - n_txt,
                                    x.device)
                a = multihead_attention(q, kk, vv, num_heads=heads,
                                        key_padding_mask=pad, dtype=dt)
                seq = x.reshape(b, h * w, dim) + m(p + "_proj")(a[:, :h * w])
                if si == last:
                    t = t + m(p + "_tproj")(a[:, h * w:])
                hx = m(p + "_fc1")(m(p + "_ln2")(seq).to(dt))
                seq = seq + m(p + "_fc2")(F.gelu(hx))
                x = seq.reshape(b, h, w, dim)
        return {"img_feat": self.final_ln(x).to(dt),
                "text_feat": self.final_text_ln(t).to(dt)}


@dataclasses.dataclass(frozen=True)
class ViTDetConfig:
    patch_size: int = 16
    embed_dim: int = 768
    num_heads: int = 12
    num_layers: int = 12
    window: int = 4  # windowed blocks; every `global_every`-th is global
    global_every: int = 3
    mlp_ratio: float = 4.0


class ViTDet(nn.Module):
    """VITDet: a plain ViT whose blocks attend within windows (the grid
    zero padded to a window multiple, unmasked) except every
    ``global_every``-th, which attends over the whole grid.  Without text
    it returns the bare grid, so it serves as a OneStageModel backbone;
    with text it passes the text through beside it."""

    def __init__(self, cfg: ViTDetConfig = ViTDetConfig(),
                 img_size: Canvas = 640, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d, ps = cfg.embed_dim, cfg.patch_size
        self.patch_embed = Conv(3, d, ps, ps, 0, bias=True, dtype=dtype)
        self.pos_embed = table(1, *grid(img_size, ps), d)
        hidden = int(d * cfg.mlp_ratio)
        for i in range(cfg.num_layers):
            self.add_module(f"b{i}_ln1", ln(d))
            for name in ("q", "k", "v", "proj"):
                self.add_module(f"b{i}_{name}", Linear(d, d, dtype))
            self.add_module(f"b{i}_ln2", ln(d))
            self.add_module(f"b{i}_fc1", Linear(d, hidden, dtype))
            self.add_module(f"b{i}_fc2", Linear(hidden, d, dtype))
        self.final_ln = ln(d)
        self.out_channels = d

    def forward(self, images, text_feat=None, text_mask=None):
        cfg, dt = self.cfg, self.dtype
        m = self.get_submodule
        x = conv_nhwc(self.patch_embed, images)
        b, h, w, d = x.shape
        x = x + self.pos_embed.to(dt)
        win = min(cfg.window, h, w)
        pad_h, pad_w = (-h) % win, (-w) % win
        for i in range(cfg.num_layers):
            windowed = (i + 1) % cfg.global_every != 0
            hx = m(f"b{i}_ln1")(x).to(dt)
            if windowed:
                seq = win_partition(F.pad(hx, (0, 0, 0, pad_w, 0, pad_h)),
                                    win)
            else:
                seq = hx.reshape(b, h * w, d)
            a = multihead_attention(m(f"b{i}_q")(seq), m(f"b{i}_k")(seq),
                                    m(f"b{i}_v")(seq),
                                    num_heads=cfg.num_heads, dtype=dt)
            a = m(f"b{i}_proj")(a)
            if windowed:
                a = win_reverse(a, win, h + pad_h, w + pad_w)[:, :h, :w]
            x = x + a.reshape(b, h, w, d)
            hx = m(f"b{i}_fc1")(m(f"b{i}_ln2")(x).to(dt))
            x = x + m(f"b{i}_fc2")(F.gelu(hx))
        x = self.final_ln(x).to(dt)
        if text_feat is None:
            return x
        return {"img_feat": x, "text_feat": text_feat}


@dataclasses.dataclass(frozen=True)
class YOLOSConfig:
    patch_size: int = 16
    embed_dim: int = 384
    num_heads: int = 6
    num_layers: int = 12
    num_det_tokens: int = 100
    mlp_ratio: float = 4.0


class YOLOSEncoder(_PatchViT):
    """YOLOS: a ViT with learned detection tokens after the patches (and
    the projected text after them when ``text_dim`` is given, as flax
    builds ``text_proj`` only when called with text); returns the patch
    grid, the det tokens and the text."""

    def __init__(self, cfg: YOLOSConfig = YOLOSConfig(),
                 img_size: Canvas = 640, text_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d = cfg.embed_dim
        n = self._patches(cfg.patch_size, d, cfg.num_layers, cfg.num_heads,
                          cfg.mlp_ratio, img_size)
        self.pos_embed = table(1, n, d)
        self.det_tokens = table(1, cfg.num_det_tokens, d)
        self.det_pos = table(1, cfg.num_det_tokens, d)
        if text_dim is not None:
            self.text_proj = Linear(text_dim, d, dtype)

    def forward(self, images, text_feat=None, text_mask=None):
        cfg, dt = self.cfg, self.dtype
        x, (h, w) = self._embed(images)
        b, n_img, d = x.shape
        nd = cfg.num_det_tokens
        det = (self.det_tokens + self.det_pos).to(dt).expand(b, nd, d)
        seq = torch.cat([x + self.pos_embed.to(dt), det], 1)
        pad = None
        if text_feat is not None:
            t = self.text_proj(text_feat)
            seq = torch.cat([seq, t], 1)
            pad = _text_pad(text_mask, b, t.shape[1], n_img + nd, x.device)
        seq = self._blocks(seq, pad, cfg.num_layers)
        out = {"img_feat": seq[:, :n_img].reshape(b, h, w, d),
               "det_tokens": seq[:, n_img:n_img + nd]}
        if text_feat is not None:
            out["text_feat"] = seq[:, n_img + nd:]
        return out


@dataclasses.dataclass(frozen=True)
class ViLTConfig:
    patch_size: int = 32
    embed_dim: int = 768
    num_heads: int = 12
    num_layers: int = 12
    vocab_size: int = 30522
    max_text_len: int = 40
    mlp_ratio: float = 4.0


class ViLTEncoder(_PatchViT):
    """ViLTransformerSS: patch and word embeddings with their position
    tables and modality-type rows, CLS before the text, one block stack
    over [image; CLS + text].  Text past ``max_text_len`` is cut."""

    def __init__(self, cfg: ViLTConfig = ViLTConfig(),
                 img_size: Canvas = 640, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d = cfg.embed_dim
        n = self._patches(cfg.patch_size, d, cfg.num_layers, cfg.num_heads,
                          cfg.mlp_ratio, img_size)
        self.img_pos = table(1, n, d)
        self.word_embed = nn.Embedding(cfg.vocab_size, d)
        self.txt_pos = table(1, cfg.max_text_len + 1, d)
        self.cls_token = table(1, 1, d)
        self.type_embed = table(2, d)

    def forward(self, images, text_ids, text_mask=None):
        cfg, dt = self.cfg, self.dtype
        x, (h, w) = self._embed(images)
        b, n_img, d = x.shape
        x = x + self.img_pos.to(dt)
        text_ids = text_ids[:, :cfg.max_text_len]
        if text_mask is not None:
            text_mask = text_mask[:, :cfg.max_text_len]
        t_len = text_ids.shape[1]
        t = F.embedding(text_ids, self.word_embed.weight).to(dt)
        t = torch.cat([self.cls_token.to(dt).expand(b, 1, d), t], 1)
        t = t + self.txt_pos[:, :t_len + 1].to(dt)
        x = x + self.type_embed[0].to(dt)
        t = t + self.type_embed[1].to(dt)
        pad = _text_pad(text_mask, b, t_len, n_img + 1, x.device)
        seq = self._blocks(torch.cat([x, t], 1), pad, cfg.num_layers)
        return {"img_feat": seq[:, :n_img].reshape(b, h, w, d),
                "cls_feat": seq[:, n_img],
                "text_feat": seq[:, n_img + 1:]}


# the reference's registry keys; the MM names alias the same networks
SWIN_TYPES = ("SwinTransformer", "SwinTransformerMM")
PVT_TYPES = ("PyramidVisionTransformerV2", "PyramidVisionTransformerMM",
             "PyramidVisionTransformerV2MM",
             "PyramidVisionTransformerV2MMMix")
# the encoders that need text in their call, which ComposedOneStageModel's
# image-only call cannot give
MIXED_TYPES = ("VisionTransformerMix", "ConvolutionalVisionTransformerMix",
               "YOLOS", "ViLTransformerSS")


def build_vis_enc(cfg: dict, dtype: torch.dtype = torch.float32,
                  img_size: Canvas = 640, text_dim: Optional[int] = None
                  ) -> nn.Module:
    """The zoo encoder of a reference-style ``vis_enc`` dict, under every
    type key and alias JAX's ``build_vis_enc`` accepts (KeyError for
    another).  ``img_size``: the canvas (an int or (H, W)), which sizes the
    position tables and Swin's windows where flax takes them from the
    first input; a ``VIT`` dict's own ``img_size`` gives way to it, as the
    input's size does in JAX.  ``text_dim``: the width of the text
    features a ``text_proj`` takes (flax infers it): ViTMix and CvTMix
    default to their own width, YOLOS is built without text unless it is
    given."""
    from .vis_encs import ResNetEncoder, ViTConfig, ViTEncoder

    cfg = {k: v for k, v in cfg.items() if k not in TRAINER_KEYS}
    typ = cfg.pop("type", None)
    if typ in ("DarkNet53", "DarknetMM"):
        return DarkNet53(dtype=dtype, **cfg)
    if typ == "CSPDarknet":
        return CSPDarknet(dtype=dtype, **cfg)
    if typ in ("ResNet", "ResNetMM"):
        return ResNetEncoder(dtype=dtype, **cfg)
    if typ in SWIN_TYPES:
        return SwinTransformer(SwinConfig(**cfg), img_size, dtype)
    if typ in PVT_TYPES:
        return PyramidVisionTransformerV2(PVTv2Config(**cfg), dtype)
    if typ == "ConvolutionalVisionTransformerMix":
        return CvTMix(CvTMixConfig(**cfg), text_dim, dtype)
    if typ == "VIT":
        return ViTEncoder(ViTConfig(**dict(cfg, img_size=img_size)), dtype)
    if typ == "VisionTransformerMix":
        return ViTMix(ViTMixConfig(**cfg), img_size, text_dim, dtype)
    if typ == "VITDet":
        return ViTDet(ViTDetConfig(**cfg), img_size, dtype)
    if typ == "YOLOS":
        return YOLOSEncoder(YOLOSConfig(**cfg), img_size, text_dim, dtype)
    if typ == "ViLTransformerSS":
        return ViLTEncoder(ViLTConfig(**cfg), img_size, dtype)
    raise KeyError(f"unknown vis_enc type {typ!r}")
