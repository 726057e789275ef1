"""BEiT-3 multiway encoder, joint mode (port of ``simvg_tpu/models/beit3.py``).

The joint sequence is ``[CLS] + image patches + text tokens``; every
multiway module holds two parameter sets, ``A`` for the vision segment
and ``B`` for the text segment.  As in the JAX package the two segments
travel as separate tensors and meet only inside the attention core.

Module and parameter names follow the reference's torchscale state dict
(``text_embed``, ``vision_embed``, ``encoder.embed_positions.A``,
``encoder.layers.N.self_attn.q_proj.A``, ...), so a converted checkpoint
loads with ``strict=True``.

Ported: the main path of the flagship.  Left out: ``scan_layers`` and
``remat`` (JAX compile devices), ``quant``, token pruning,
``seq_parallel``, ``attn_bias`` and the single-modality modes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from simvg_tpu_torch.ops.attention import multihead_attention
from .layers import LayerNorm, Linear


@dataclasses.dataclass(frozen=True)
class BEiT3Config:
    img_size: int = 640
    patch_size: int = 32
    in_chans: int = 3
    vocab_size: int = 64010
    embed_dim: int = 768
    num_heads: int = 12
    ffn_dim: int = 3072
    num_layers: int = 12
    max_source_positions: int = 1024
    drop_path_rate: float = 0.1
    attention_dropout: float = 0.0
    layernorm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32  # compute dtype; params stay fp32
    attn_impl: str = "xla"  # "xla" (plain torch) | "pallas" (Hopper kernel)

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def seq_vision(self) -> int:
        """CLS + patch tokens = the multiway split position."""
        return self.num_patches + 1

    @classmethod
    def base(cls, **kw) -> "BEiT3Config":
        return cls(embed_dim=768, num_heads=12, ffn_dim=3072, num_layers=12,
                   **kw)

    @classmethod
    def large(cls, **kw) -> "BEiT3Config":
        return cls(embed_dim=1024, num_heads=16, ffn_dim=4096, num_layers=24,
                   **kw)


class Multiway(nn.Module):
    """Two parameter sets: ``A`` for the vision segment, ``B`` for the
    text segment; forward maps the (vision, text) pair."""

    def __init__(self, a: nn.Module, b: nn.Module):
        super().__init__()
        self.A = a
        self.B = b

    def forward(self, xs):
        return self.A(xs[0]), self.B(xs[1])


def _multiway(make) -> Multiway:
    return Multiway(make(), make())


def _gelu(h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Exact (erf) GELU in float32, cast back to the compute dtype."""
    return F.gelu(h.float()).to(dtype)


class _FFNWay(nn.Module):
    def __init__(self, cfg: BEiT3Config):
        super().__init__()
        self.fc1 = Linear(cfg.embed_dim, cfg.ffn_dim, cfg.dtype)
        self.fc2 = Linear(cfg.ffn_dim, cfg.embed_dim, cfg.dtype)
        self.ffn_layernorm = LayerNorm(cfg.ffn_dim, eps=cfg.layernorm_eps)
        self.dtype = cfg.dtype

    def forward(self, h):
        return self.fc2(self.ffn_layernorm(_gelu(self.fc1(h), self.dtype)))


class MultiwayFFN(Multiway):
    """fc1 -> exact GELU -> ffn_layernorm -> fc2, one set per modality."""

    def __init__(self, cfg: BEiT3Config):
        super().__init__(_FFNWay(cfg), _FFNWay(cfg))


class MultiwayAttention(nn.Module):
    """torchscale MultiheadAttention with multiway q/k/v/out projections
    and the subln ``inner_attn_ln``.  The joint sequence exists only for
    the attention core: q/k/v are concatenated once, the output split
    once."""

    def __init__(self, cfg: BEiT3Config):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, _multiway(lambda: Linear(d, d, cfg.dtype)))
        self.inner_attn_ln = _multiway(
            lambda: LayerNorm(d, eps=cfg.layernorm_eps))

    def forward(self, xs, key_padding_mask):
        cfg = self.cfg
        split = xs[0].shape[1]

        def proj(m):
            return torch.cat(m(xs), dim=1)

        out = multihead_attention(
            proj(self.q_proj), proj(self.k_proj), proj(self.v_proj),
            num_heads=cfg.num_heads,
            key_padding_mask=key_padding_mask,
            dropout_rate=cfg.attention_dropout,
            deterministic=not self.training,
            dtype=cfg.dtype,
            impl=cfg.attn_impl,
        )
        return self.out_proj(
            self.inner_attn_ln((out[:, :split], out[:, split:])))


class DropPath(nn.Module):
    """Per-sample stochastic depth on a residual branch, with ONE mask per
    sample for both segments, as the reference draws it over the whole
    joint sequence.  Identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, xs):
        if not self.training or self.rate == 0.0:
            return xs
        keep = 1.0 - self.rate
        mask = torch.bernoulli(torch.full(
            (xs[0].shape[0], 1, 1), keep, device=xs[0].device)).to(xs[0].dtype)
        return tuple(x / keep * mask for x in xs)


class EncoderLayer(nn.Module):
    """Pre-LN multiway transformer block on the (vision, text) pair.  The
    float32 LayerNorm outputs feed only Linears, which cast them to the
    compute dtype; the residual stream stays in the compute dtype."""

    def __init__(self, cfg: BEiT3Config, drop_path_rate: float):
        super().__init__()
        d, eps = cfg.embed_dim, cfg.layernorm_eps
        self.self_attn_layer_norm = _multiway(lambda: LayerNorm(d, eps=eps))
        self.self_attn = MultiwayAttention(cfg)
        self.final_layer_norm = _multiway(lambda: LayerNorm(d, eps=eps))
        self.ffn = MultiwayFFN(cfg)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, xs, key_padding_mask):
        hs = self.self_attn(self.self_attn_layer_norm(xs), key_padding_mask)
        hs = self.drop_path(hs)
        xs = (xs[0] + hs[0], xs[1] + hs[1])

        hs = self.drop_path(self.ffn(self.final_layer_norm(xs)))
        return xs[0] + hs[0], xs[1] + hs[1]


class VisionEmbedding(nn.Module):
    """Conv patchify + CLS prepend.  Takes an NHWC batch, viewed once as
    NCHW for ``Conv2d``."""

    def __init__(self, cfg: BEiT3Config):
        super().__init__()
        d = cfg.embed_dim
        self.dtype = cfg.dtype
        self.proj = nn.Conv2d(cfg.in_chans, d, cfg.patch_size,
                              stride=cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        # in BEiT-3 checkpoints (contain_mask_token=True); unused for REC
        self.mask_token = nn.Parameter(torch.zeros(1, 1, d))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = F.conv2d(images.to(dt).permute(0, 3, 1, 2),
                     self.proj.weight.to(dt), self.proj.bias.to(dt),
                     stride=self.proj.stride)
        x = x.flatten(2).transpose(1, 2)  # [B, h*w, D], row-major grid
        cls = self.cls_token.to(dt).expand(x.shape[0], 1, x.shape[2])
        return torch.cat([cls, x], dim=1)


class _EncoderStack(nn.Module):
    """torchscale ``Encoder``: positions, layers, final multiway LN."""

    def __init__(self, cfg: BEiT3Config):
        super().__init__()
        d = cfg.embed_dim
        self.embed_positions = Multiway(
            nn.Embedding(cfg.seq_vision + 2, d),
            nn.Embedding(cfg.max_source_positions, d))
        dpr = np.linspace(0.0, cfg.drop_path_rate, cfg.num_layers)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, float(r)) for r in dpr)
        self.layer_norm = _multiway(
            lambda: LayerNorm(d, eps=cfg.layernorm_eps))


class BEiT3Encoder(nn.Module):
    """The joint vision-language encoder.

    forward(images NHWC, text_ids [B, T], text_padding_mask [B, T] with
    1 = padded) -> (img_feat [B, P, D], text_feat [B, T, D], cls_feat
    [B, D]), all float32 (the final LayerNorms compute in float32).
    """

    def __init__(self, cfg: BEiT3Config):
        super().__init__()
        self.cfg = cfg
        self.text_embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        self.vision_embed = VisionEmbedding(cfg)
        self.encoder = _EncoderStack(cfg)

    def forward(self, images, text_ids, text_padding_mask=None):
        cfg, dt = self.cfg, self.cfg.dtype
        pos = self.encoder.embed_positions
        x_vis = self.vision_embed(images)
        b, split = x_vis.shape[:2]
        if split != cfg.seq_vision:
            raise ValueError(f"image gives {split} vision tokens, the "
                             f"config {cfg.seq_vision}")
        dev = x_vis.device
        # fairseq positions start at 2 (padding_idx + 1)
        x_vis = x_vis + pos.A.weight[2:split + 2].to(dt)

        t = text_ids.shape[1]
        x_txt = self.text_embed.weight.to(dt)[text_ids] \
            + pos.B.weight[2:t + 2].to(dt)
        if text_padding_mask is None:
            pad_txt = torch.zeros(b, t, dtype=torch.bool, device=dev)
        else:
            pad_txt = text_padding_mask.to(torch.bool)
        # padded text positions are zeroed after embedding
        x_txt = x_txt * (1.0 - pad_txt.to(dt))[..., None]

        pad = torch.cat([torch.zeros(b, split, dtype=torch.bool, device=dev),
                         pad_txt], dim=1)
        xs = (x_vis.to(dt), x_txt.to(dt))
        for layer in self.encoder.layers:
            xs = layer(xs, pad)

        x_vis, text_feat = self.encoder.layer_norm(xs)
        return x_vis[:, 1:], text_feat, x_vis[:, 0]
