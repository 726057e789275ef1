"""Vision-language fusion and the OneStageModel composition (port of
``simvg_tpu/models/fusion.py``).

``CrossAttentionFusion``'s attention is the plain path of
``multihead_attention``, as in JAX: the image grid queries the text, a
cross-attention that is not K1's self-attention shape.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from simvg_tpu_torch.ops.attention import multihead_attention
from .layers import LayerNorm, Linear


class CrossAttentionFusion(nn.Module):
    """The image grid attends to the text features; residual, then a
    float32 LayerNorm (flax's epsilon, 1e-6).  flax infers the input widths;
    here they are the encoders' output widths."""

    def __init__(self, img_channels: int, text_channels: int,
                 embed_dim: int = 256, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dtype = dtype
        self.img_proj = Linear(img_channels, embed_dim, dtype)
        self.text_proj = Linear(text_channels, embed_dim, dtype)
        for name in ("q", "k", "v", "out"):
            self.add_module(name, Linear(embed_dim, embed_dim, dtype))
        self.ln = LayerNorm(embed_dim, eps=1e-6)

    def forward(self, img_feat, text_feat, text_mask=None):
        """img_feat [B, h, w, Ci]; text_feat [B, T, Ct] -> [B, h, w, D]."""
        b, h, w, _ = img_feat.shape
        d = self.embed_dim
        x = self.img_proj(img_feat).reshape(b, h * w, d)
        t = self.text_proj(text_feat)
        a = multihead_attention(self.q(x), self.k(t), self.v(t),
                                num_heads=self.num_heads,
                                key_padding_mask=text_mask, dtype=self.dtype)
        x = x + self.out(a)
        return self.ln(x).reshape(b, h, w, d).to(self.dtype)


class ComposedOneStageModel(nn.Module):
    """The reference's OneStageModel: ``vis_enc`` + ``lan_enc`` + ``fusion``
    + DETR ``head``, with the keyword surface of ``SimVGModel``.  As in JAX,
    ``text_padding_mask`` and ``img_shape`` are accepted and not used: the
    language encoder takes its mask from the zero-padded word ids, and the
    head sees no padded cell."""

    def __init__(self, vis_enc: nn.Module, lan_enc: nn.Module,
                 fusion: nn.Module, head: nn.Module):
        super().__init__()
        self.vis_enc, self.lan_enc = vis_enc, lan_enc
        self.fusion, self.head = fusion, head

    def text_features(self, text_ids):
        """The language encoder's (features, padding mask): a pooled mode's
        [B, N, C] vectors have no padding."""
        lang = self.lan_enc(text_ids)
        if isinstance(lang, dict):
            return lang["text_feat"], lang["text_mask"]
        return lang, torch.zeros(lang.shape[:2], dtype=torch.bool,
                                 device=lang.device)

    def forward(self, image, text_ids, text_padding_mask=None,
                img_shape: Optional[torch.Tensor] = None):
        del text_padding_mask, img_shape
        fused = self.fusion(self.vis_enc(image),
                            *self.text_features(text_ids))
        return self.head(fused, torch.zeros(fused.shape[:3], dtype=torch.bool,
                                            device=fused.device))
