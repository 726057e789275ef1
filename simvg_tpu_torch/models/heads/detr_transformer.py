"""Post-norm DETR encoder and decoder layers (port of
``simvg_tpu/models/heads/detr_transformer.py``).

- attention = ``nn.MultiheadAttention`` semantics: packed q/k/v projection
  (``in_proj_weight``/``in_proj_bias``), output projection, prob dropout;
  positional embeddings are added to q/k only, and the residual is the
  pre-positional query;
- FFN = Linear -> ReLU -> Dropout -> Linear -> Dropout with residual;
- all norms post-residual;
- the decoder optionally returns every layer's output through the shared
  ``post_norm_layer``.

Parameter names follow the reference's detrex state dict
(``layers.N.attentions.{0,1}.attn``, ``ffns.0.layers``, ``norms.N``).
The head's attention returns its weights, so it always takes the plain
path of ``multihead_attention``; ``recorded_cross_attention`` hands the
last decoder layer's cross-attention weights to the caller (the inference
CLI's ``--with-attn``), and ``recorded_layer_cross_attention`` every
layer's (``tools/attn_visual.py``), without changing any output.  ``DetrEncoder``
runs over the image memory when the head has ``only_decoder=False``;
like the decoder's, its attention is the plain path (JAX's is not a
Pallas kernel either).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from simvg_tpu_torch.ops.attention import multihead_attention
from ..layers import Dropout, LayerNorm, Linear, Stochastic


class _PackedProjections(nn.Module):
    """The parameters of ``nn.MultiheadAttention``: packed q/k/v and out."""

    def __init__(self, embed_dim: int, dtype: torch.dtype):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim, dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)


class DetrAttention(Stochastic):
    """nn.MultiheadAttention-style attention with residual from identity;
    its prob dropout draws from ``self.generator``."""

    def __init__(self, embed_dim: int, num_heads: int,
                 attn_dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.attn_dropout = attn_dropout
        self.dtype = dtype
        self.attn = _PackedProjections(embed_dim, dtype)
        self.record: Optional[list] = None  # gets the weights when a list

    def forward(self, query, key, value, query_pos: Optional[torch.Tensor],
                key_pos: Optional[torch.Tensor],
                key_padding_mask: Optional[torch.Tensor]):
        dt, d = self.dtype, self.embed_dim
        q_in = query if query_pos is None else query + query_pos
        k_in = key if key_pos is None else key + key_pos
        w = self.attn.in_proj_weight.to(dt)
        b = self.attn.in_proj_bias.to(dt)
        q = F.linear(q_in.to(dt), w[:d], b[:d])
        k = F.linear(k_in.to(dt), w[d:2 * d], b[d:2 * d])
        v = F.linear(value.to(dt), w[2 * d:], b[2 * d:])
        out, weights = multihead_attention(
            q, k, v,
            num_heads=self.num_heads,
            key_padding_mask=key_padding_mask,
            dropout_rate=self.attn_dropout,
            deterministic=not self.training,
            dtype=dt,
            return_weights=True,
            generator=self.generator,
        )
        if self.record is not None:
            self.record.append(weights)  # [B, H, Q, S_k]
        return query + self.attn.out_proj(out)


class DetrFFN(nn.Module):
    """detrex FFN: Linear -> ReLU -> Drop -> Linear -> Drop, + residual."""

    def __init__(self, embed_dim: int, feedforward_dim: int,
                 ffn_dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.Sequential(Linear(embed_dim, feedforward_dim, dtype),
                          nn.ReLU(), Dropout(ffn_dropout)),
            Linear(feedforward_dim, embed_dim, dtype),
            Dropout(ffn_dropout),
        ])

    def forward(self, x):
        h = x
        for layer in self.layers:
            h = layer(h)
        return x + h


class DetrEncoderLayer(nn.Module):
    """("self_attn","norm","ffn","norm") post-norm layer; ``query_pos`` is
    added to q and k, not to v."""

    def __init__(self, embed_dim: int, num_heads: int, feedforward_dim: int,
                 attn_dropout: float, ffn_dropout: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.attentions = nn.ModuleList(
            [DetrAttention(embed_dim, num_heads, attn_dropout, dtype)])
        self.ffns = nn.ModuleList(
            [DetrFFN(embed_dim, feedforward_dim, ffn_dropout, dtype)])
        self.norms = nn.ModuleList(LayerNorm(embed_dim) for _ in range(2))

    def forward(self, x, query_pos, key_padding_mask):
        dt = self.dtype
        x = self.attentions[0](x, x, x, query_pos, query_pos,
                               key_padding_mask)
        x = self.norms[0](x).to(dt)
        x = self.ffns[0](x)
        return self.norms[1](x).to(dt)


class DetrEncoder(nn.Module):
    """DetrTransformerEncoder with no final norm, as the reference config
    has none."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8,
                 feedforward_dim: int = 2048, num_layers: int = 6,
                 attn_dropout: float = 0.1, ffn_dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.ModuleList(
            DetrEncoderLayer(embed_dim, num_heads, feedforward_dim,
                             attn_dropout, ffn_dropout, dtype)
            for _ in range(num_layers))

    def forward(self, x, query_pos=None, key_padding_mask=None):
        for layer in self.layers:
            x = layer(x, query_pos, key_padding_mask)
        return x


class DetrDecoderLayer(nn.Module):
    """("self_attn","norm","cross_attn","norm","ffn","norm") layer."""

    def __init__(self, embed_dim: int, num_heads: int, feedforward_dim: int,
                 attn_dropout: float, ffn_dropout: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.attentions = nn.ModuleList(
            DetrAttention(embed_dim, num_heads, attn_dropout, dtype)
            for _ in range(2))
        self.ffns = nn.ModuleList(
            [DetrFFN(embed_dim, feedforward_dim, ffn_dropout, dtype)])
        self.norms = nn.ModuleList(LayerNorm(embed_dim) for _ in range(3))

    def forward(self, x, memory, query_pos, key_pos, key_padding_mask):
        dt = self.dtype
        x = self.attentions[0](x, x, x, query_pos, query_pos, None)
        x = self.norms[0](x).to(dt)
        x = self.attentions[1](x, memory, memory, query_pos, key_pos,
                               key_padding_mask)
        x = self.norms[1](x).to(dt)
        x = self.ffns[0](x)
        return self.norms[2](x).to(dt)


class DetrDecoder(nn.Module):
    """DetrTransformerDecoder.  With ``return_intermediate`` the output is
    [L, B, Q, D], every layer's output through the shared post-norm;
    otherwise [1, B, Q, D]."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8,
                 feedforward_dim: int = 2048, num_layers: int = 6,
                 attn_dropout: float = 0.1, ffn_dropout: float = 0.1,
                 post_norm: bool = True, return_intermediate: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.return_intermediate = return_intermediate
        self.layers = nn.ModuleList(
            DetrDecoderLayer(embed_dim, num_heads, feedforward_dim,
                             attn_dropout, ffn_dropout, dtype)
            for _ in range(num_layers))
        self.post_norm_layer = LayerNorm(embed_dim) if post_norm else None

    def _post(self, x):
        if self.post_norm_layer is None:
            return x
        return self.post_norm_layer(x).to(self.dtype)

    def forward(self, query, memory, query_pos=None, key_pos=None,
                key_padding_mask=None):
        intermediate = []
        x = query
        for layer in self.layers:
            x = layer(x, memory, query_pos, key_pos, key_padding_mask)
            if self.return_intermediate:
                intermediate.append(self._post(x))
        if self.return_intermediate:
            return torch.stack(intermediate, dim=0)
        return self._post(x)[None]


@contextlib.contextmanager
def recorded_cross_attention(decoder: DetrDecoder):
    """Yields a list that gets, for each forward of ``decoder`` inside the
    block, its last layer's cross-attention probabilities [B, H, Q, S_k] in
    the compute dtype (the JAX inference CLI's ``attn_weights``
    intermediate)."""
    with recorded_layer_cross_attention(decoder) as records:
        yield records[-1]


@contextlib.contextmanager
def recorded_layer_cross_attention(decoder: DetrDecoder):
    """Yields a list holding, per decoder layer, the list that gets that
    layer's cross-attention probabilities [B, H, Q, S_k] for each forward
    inside the block (JAX's ``intermediates`` of every layer)."""
    attns = [layer.attentions[1] for layer in decoder.layers]
    for attn in attns:
        attn.record = []
    try:
        yield [attn.record for attn in attns]
    finally:
        for attn in attns:
            attn.record = None
