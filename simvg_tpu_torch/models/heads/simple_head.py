"""Plain DETR head of the OneStageModel family (port of
``simvg_tpu/models/heads/simple_head.py``): learned object queries, an
optional ``DetrEncoder`` over the image memory, a ``DetrDecoder`` with
every layer's output, and one class/box prediction branch.

There is no token branch: ``class_token``/``bbox_token`` alias the
decoder's last layer, so the losses, the train metrics and the decoding
treat both families alike.  Parameter names follow the TGQS head's
(``input_proj`` a 1x1 conv, ``query_embed``, ``transformer.decoder``,
``transformer.encoder``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from simvg_tpu_torch.ops.sine_embed import sine_position_embedding_2d
from ..layers import Linear
from .detr_transformer import DetrDecoder, DetrEncoder
from .tgqs_head import MLP, _Transformer


@dataclasses.dataclass(frozen=True)
class DETRHeadConfig:
    num_queries: int = 100
    in_channels: int = 768
    embed_dim: int = 256
    num_classes: int = 1
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    only_decoder: bool = False
    attn_dropout: float = 0.1
    ffn_dropout: float = 0.1
    dtype: torch.dtype = torch.float32


class DETRHead(nn.Module):
    def __init__(self, cfg: DETRHeadConfig):
        super().__init__()
        self.cfg = cfg
        e, dt = cfg.embed_dim, cfg.dtype
        self.input_proj = nn.Conv2d(cfg.in_channels, e, kernel_size=1)
        self.query_embed = nn.Embedding(cfg.num_queries, e)
        # 8 heads and a 2048-wide FFN, the JAX modules' defaults
        self.transformer = _Transformer(DetrDecoder(
            e, 8, 2048, cfg.num_decoder_layers, cfg.attn_dropout,
            cfg.ffn_dropout, post_norm=True, return_intermediate=True,
            dtype=dt), None if cfg.only_decoder else DetrEncoder(
            e, 8, 2048, cfg.num_encoder_layers, cfg.attn_dropout,
            cfg.ffn_dropout, dtype=dt))
        self.class_embed = Linear(e, cfg.num_classes + 1, dt)
        self.bbox_embed = MLP(e, e, 4, 3, dtype=dt)

    def forward(self, x_mm: torch.Tensor, img_pad_mask: torch.Tensor):
        """x_mm [B, h, w, in_channels]; img_pad_mask bool [B, h, w] (True =
        padded cell) -> class [L, B, Q, C+1] and boxes [L, B, Q, 4] of each
        decoder layer, and the last layer's under the token keys."""
        cfg = self.cfg
        dt, e = cfg.dtype, cfg.embed_dim
        b, h, w, _ = x_mm.shape
        x = F.linear(x_mm.to(dt), self.input_proj.weight.flatten(1).to(dt),
                     self.input_proj.bias.to(dt))
        out = torch.promote_types(dt, torch.float32)  # float64 stays so
        pos = sine_position_embedding_2d(img_pad_mask, e // 2,
                                         dtype=out).to(dt)
        memory = x.reshape(b, h * w, e)
        mem_pos = pos.reshape(b, h * w, e)
        mem_mask = img_pad_mask.reshape(b, h * w)
        if not cfg.only_decoder:
            memory = self.transformer.encoder(
                memory, query_pos=mem_pos, key_padding_mask=mem_mask)
        qe = self.query_embed.weight.to(dt)[None].expand(
            b, cfg.num_queries, e)
        hs = self.transformer.decoder(
            torch.zeros_like(qe), memory, query_pos=qe, key_pos=mem_pos,
            key_padding_mask=mem_mask)
        cls = self.class_embed(hs).to(out)
        box = torch.sigmoid(self.bbox_embed(hs).to(out))
        return {"class_decoder": cls, "bbox_decoder": box,
                "class_token": cls[-1:], "bbox_token": box[-1:]}
