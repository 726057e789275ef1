"""Text-guided query-selection knowledge-distillation DETR head (port of
``simvg_tpu/models/heads/tgqs_head.py``).

The forward is pure: it produces the decoder-branch and token-branch
class/box predictions; losses are not part of it.  Image features come
in as an NHWC grid.  Parameter names follow the reference's state dict
(``input_proj`` is the reference's 1x1 ``Conv2d``, applied here as a
linear map over the channel axis).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from simvg_tpu_torch.ops.sine_embed import (
    sine_position_embedding_1d_ref,
    sine_position_embedding_2d,
)
from ..layers import Linear
from .detr_transformer import DetrDecoder


@dataclasses.dataclass(frozen=True)
class TGQSHeadConfig:
    """The reference head's constructor arguments that the shipped configs
    exercise."""

    num_queries: int = 1
    in_channels: int = 768
    embed_dim: int = 256
    num_classes: int = 1
    text_max_token: int = 20
    num_encoder_layers: int = 6
    num_decoder_layers: int = 3
    num_tgqg_layers: int = 2
    only_decoder: bool = True
    num_token_mlp_layers: int = 1
    text_guided_query_generation: bool = True
    tgqs_mid_dim: int = 512
    share_predicthead: bool = False
    attn_dropout: float = 0.1
    ffn_dropout: float = 0.1
    dtype: torch.dtype = torch.float32


class MLP(nn.Module):
    """Linear->ReLU stack; with ``return_intermediate`` it returns every
    layer's output stacked [L, ...] (the token branch's use)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, return_intermediate: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if return_intermediate and num_layers > 1 \
                and hidden_dim != output_dim:
            raise ValueError("MLP(return_intermediate=True) stacks its "
                             "layers, so hidden_dim must equal output_dim; "
                             f"got {hidden_dim} vs {output_dim}")
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(n, k, dtype) for n, k in zip(dims[:-1], dims[1:]))
        self.return_intermediate = return_intermediate

    def forward(self, x):
        outs = []
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
            outs.append(x)
        if self.return_intermediate:
            return torch.stack(outs, dim=0)
        return x


class _Transformer(nn.Module):
    """Holds the decoder under the reference's ``transformer.decoder``."""

    def __init__(self, decoder: DetrDecoder):
        super().__init__()
        self.decoder = decoder


class TGQSKDDETRHead(nn.Module):
    def __init__(self, cfg: TGQSHeadConfig):
        super().__init__()
        if not cfg.only_decoder:
            raise NotImplementedError(
                "only_decoder=False needs DetrEncoder, not ported yet")
        self.cfg = cfg
        e, dt = cfg.embed_dim, cfg.dtype
        self.class_embed_decoder = Linear(e, cfg.num_classes + 1, dt)
        self.bbox_embed_decoder = MLP(e, e, 4, 3, dtype=dt)
        if not cfg.share_predicthead:
            self.class_embed_token = Linear(e, cfg.num_classes + 1, dt)
            self.bbox_embed_token = MLP(e, e, 4, 3, dtype=dt)
        self.input_proj = nn.Conv2d(cfg.in_channels, e, kernel_size=1)
        self.input_text_proj = Linear(cfg.in_channels, e, dt)
        self.input_cls_proj = Linear(cfg.in_channels, e, dt)
        self.query_embed = nn.Embedding(cfg.num_queries, e)
        if cfg.text_guided_query_generation:
            self.text_guided_query_generation_transformer = DetrDecoder(
                e, 8, cfg.tgqs_mid_dim, cfg.num_tgqg_layers,
                cfg.attn_dropout, cfg.ffn_dropout, post_norm=True,
                return_intermediate=False, dtype=dt)
        if cfg.num_token_mlp_layers > 0:
            self.mlp = MLP(e, e, e, cfg.num_token_mlp_layers,
                           return_intermediate=True, dtype=dt)
        self.transformer = _Transformer(DetrDecoder(
            e, 8, 2048, cfg.num_decoder_layers, cfg.attn_dropout,
            cfg.ffn_dropout, post_norm=True, return_intermediate=True,
            dtype=dt))

    def _token_heads(self):
        if self.cfg.share_predicthead:
            return self.class_embed_decoder, self.bbox_embed_decoder
        return self.class_embed_token, self.bbox_embed_token

    def forward(
        self,
        x_mm: torch.Tensor,  # [B, h, w, in_channels] image-token grid
        img_pad_mask: torch.Tensor,  # bool [B, h, w]; True = padded cell
        cls_feat: torch.Tensor,  # [B, in_channels]
        text_feat: torch.Tensor,  # [B, T, in_channels]
        text_mask: torch.Tensor,  # [B, T]; nonzero = padded token
        branches: str = "both",  # "both" | "token" | "decoder"
    ):
        cfg = self.cfg
        dt, e, nq = cfg.dtype, cfg.embed_dim, cfg.num_queries
        b, h, w, _ = x_mm.shape
        dev = x_mm.device

        x = F.linear(x_mm.to(dt), self.input_proj.weight.flatten(1).to(dt),
                     self.input_proj.bias.to(dt))
        text = self.input_text_proj(text_feat)
        cls = self.input_cls_proj(cls_feat)[:, None, :]

        pos_embed = sine_position_embedding_2d(img_pad_mask, e // 2).to(dt)
        cls_q = cls.expand(b, nq, e)
        query_embed_input = self.query_embed.weight.to(dt)[None].expand(
            b, nq, e)

        if cfg.text_guided_query_generation:
            # max-pool the text features over non-padded tokens
            text_pad = (text_mask != 0)[..., None]
            text_feat_filter = text.masked_fill(text_pad, -1e30).amax(
                dim=1, keepdim=True).expand(b, nq, e)
            text_pos = sine_position_embedding_1d_ref(
                text.shape[1], e, device=dev).to(dt)[None]
            tgqg_out = self.text_guided_query_generation_transformer(
                torch.zeros_like(query_embed_input), text,
                query_pos=query_embed_input, key_pos=text_pos,
                key_padding_mask=text_mask,
            )[0]
            query_embed = tgqg_out + text_feat_filter + query_embed_input
            cls_q = query_embed + cls_q
        else:
            query_embed = query_embed_input

        # ---- token branch
        if branches != "decoder":
            class_head, bbox_head = self._token_heads()
            token_feats = (self.mlp(cls_q) if cfg.num_token_mlp_layers > 0
                           else cls_q[None])
            class_token = class_head(token_feats)
            bbox_token = torch.sigmoid(bbox_head(token_feats).float())
        else:
            token_feats = cls_q[None]
            class_token = torch.zeros(1, b, nq, cfg.num_classes + 1,
                                      device=dev)
            bbox_token = torch.full((1, b, nq, 4), 0.5, device=dev)

        # ---- decoder branch
        ld = cfg.num_decoder_layers
        if branches != "token":
            hidden_states = self.transformer.decoder(
                torch.zeros_like(query_embed),
                x.reshape(b, h * w, e),
                query_pos=query_embed,
                key_pos=pos_embed.reshape(b, h * w, e),
                key_padding_mask=img_pad_mask.reshape(b, h * w),
            )  # [L_dec, B, Q, E]
            class_decoder = self.class_embed_decoder(hidden_states)
            bbox_decoder = torch.sigmoid(
                self.bbox_embed_decoder(hidden_states).float())
        else:
            hidden_states = torch.zeros(ld, b, nq, e, dtype=dt, device=dev)
            class_decoder = torch.zeros(ld, b, nq, cfg.num_classes + 1,
                                        device=dev)
            bbox_decoder = torch.full((ld, b, nq, 4), 0.5, device=dev)

        return {
            # [L, B, Q, C+1] / [L, B, Q, 4]; the last layer is the answer
            "class_decoder": class_decoder.float(),
            "bbox_decoder": bbox_decoder,
            "class_token": class_token.float(),
            "bbox_token": bbox_token,
            "token_features": token_feats,
            "decoder_features": hidden_states,
        }
