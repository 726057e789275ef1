"""SeqTR/MDETR legacy transformer layers (port of
``simvg_tpu/models/legacy_layers.py``).

Two SeqTR-era modules of the reference's inventory (core/layers/) that no
shipped SimVG config uses:

- ``AutoRegressiveTransformer`` (core/layers/transformer.py:310-448): a
  1x1 conv + GroupNorm-32 input projection, a post-norm encoder over the
  flattened feature map with sine-2D positions on q/k, and a causally
  masked post-norm decoder over coordinate-token embeddings with learned
  1-D positions; ``generate`` decodes greedily by re-running the whole
  forward at a fixed length, as JAX does.
- ``MDETRTransformer`` (core/layers/mdetr_transformer.py:24-159): the same
  encoder/decoder pair over the concatenation of image tokens and resized
  text features, with learned object queries.

Attention is the plain path (``ops/attention.py``, the JAX modules' default
``impl``), so no kernel runs here.  Dropout draws from each ``Stochastic``
module's explicit generator.  Parameter names follow the JAX modules'
(``encoder_layers_0`` is ``encoder_layers.0``), so
``convert.export_legacy`` maps a flax tree onto the port with
``strict=True``.  Unlike flax, the torch modules take their input widths:
``in_channels`` (and MDETR's ``text_dim``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from simvg_tpu_torch.ops.attention import multihead_attention
from simvg_tpu_torch.ops.sine_embed import sine_position_embedding_2d
from .layers import Dropout, LayerNorm, Linear, Stochastic


def causal_mask(length: int, device=None) -> torch.Tensor:
    """tri_mask (transformer.py:357-361): additive float32 [L, L], 0 on and
    below the diagonal, -inf above."""
    allowed = torch.ones(length, length, dtype=torch.bool,
                         device=device).tril()
    return torch.zeros(length, length, device=device).masked_fill(
        ~allowed, float("-inf"))


class _Attn(Stochastic):
    """q/k/v/out projections and attention with an optional additive mask
    (torch ``nn.MultiheadAttention`` semantics)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dropout, self.dtype = num_heads, dropout, dtype
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Linear(embed_dim, embed_dim, dtype))

    def forward(self, query, key, value, *, query_pos=None, key_pos=None,
                key_padding_mask=None, attn_bias=None):
        q_in = query if query_pos is None else query + query_pos
        k_in = key if key_pos is None else key + key_pos
        out = multihead_attention(
            self.q_proj(q_in), self.k_proj(k_in), self.v_proj(value),
            num_heads=self.num_heads,
            key_padding_mask=key_padding_mask,
            attn_bias=attn_bias,
            dropout_rate=self.dropout,
            deterministic=not self.training,
            dtype=self.dtype,
            generator=self.generator,
        )
        return self.out_proj(out)


class _FFN(nn.Module):
    def __init__(self, embed_dim: int, ffn_dim: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(embed_dim, ffn_dim, dtype)
        self.drop = Dropout(dropout)
        self.fc2 = Linear(ffn_dim, embed_dim, dtype)

    def forward(self, x):
        return self.fc2(self.drop(F.relu(self.fc1(x))))


class EncoderLayer1D(nn.Module):
    """Post-norm encoder layer with positions on q/k
    (TransformerEncoderLayerWithPositionEmbedding, transformer.py:
    169-181)."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.self_attn = _Attn(embed_dim, num_heads, dropout, dtype)
        self.norm1 = LayerNorm(embed_dim, eps=1e-5)
        self.ffn = _FFN(embed_dim, ffn_dim, dropout, dtype)
        self.norm2 = LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x, pos, key_padding_mask):
        h = self.self_attn(x, x, x, query_pos=pos, key_pos=pos,
                           key_padding_mask=key_padding_mask)
        x = self.norm1(x + h).to(self.dtype)
        return self.norm2(x + self.ffn(x)).to(self.dtype)


class DecoderLayer1D(nn.Module):
    """Post-norm decoder layer: masked self-attention (query positions),
    cross-attention to the memory (memory positions on k)
    (TransformerDecoderLayerWithPositionEmbedding, transformer.py:
    200-246)."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.self_attn = _Attn(embed_dim, num_heads, dropout, dtype)
        self.norm1 = LayerNorm(embed_dim, eps=1e-5)
        self.cross_attn = _Attn(embed_dim, num_heads, dropout, dtype)
        self.norm2 = LayerNorm(embed_dim, eps=1e-5)
        self.ffn = _FFN(embed_dim, ffn_dim, dropout, dtype)
        self.norm3 = LayerNorm(embed_dim, eps=1e-5)

    def forward(self, tgt, memory, *, query_pos, memory_pos,
                memory_key_padding_mask, tgt_mask):
        h = self.self_attn(tgt, tgt, tgt, query_pos=query_pos,
                           key_pos=query_pos, attn_bias=tgt_mask)
        tgt = self.norm1(tgt + h).to(self.dtype)
        h = self.cross_attn(tgt, memory, memory, query_pos=query_pos,
                            key_pos=memory_pos,
                            key_padding_mask=memory_key_padding_mask)
        tgt = self.norm2(tgt + h).to(self.dtype)
        return self.norm3(tgt + self.ffn(tgt)).to(self.dtype)


class FeatureResizer(nn.Module):
    """Linear -> LN -> dropout (transformer.py:287-307)."""

    def __init__(self, input_dim: int, output_dim: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc = Linear(input_dim, output_dim, dtype)
        self.layer_norm = LayerNorm(output_dim, eps=1e-12)
        self.drop = Dropout(dropout)

    def forward(self, x):
        return self.drop(self.layer_norm(self.fc(x)).to(self.dtype))


def _sine_pos(x_mask: torch.Tensor, d_model: int, dtype) -> torch.Tensor:
    """[B, H, W] padding mask -> [B, H*W, D] sine-2D positions in
    ``dtype`` (computed in float32, or float64 for a float64 model)."""
    acc = torch.promote_types(dtype, torch.float32)
    pos = sine_position_embedding_2d(x_mask.to(torch.bool), d_model // 2,
                                     normalize=True, dtype=acc).to(dtype)
    return pos.flatten(1, 2)


class AutoRegressiveTransformer(nn.Module):
    """SeqTR sequence-generation transformer (core/layers/transformer.py:
    310-448).

    ``forward_encoder``: a [B, H, W, C] feature map -> input_proj (1x1 conv
    + GroupNorm-32) -> the encoder with sine-2D positions -> memory.
    ``forward_decoder``: the causally masked decode of coordinate-token
    embeddings against the memory -> float32 logits.
    """

    def __init__(self, in_channels: int, d_model: int = 256,
                 num_heads: int = 8, ffn_dim: int = 1024,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 3,
                 vocab_size: int = 1001 + 2, max_seq_len: int = 5,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.max_seq_len, self.dtype = d_model, max_seq_len, dtype
        self.input_proj = nn.Conv2d(in_channels, d_model, 1)
        # flax nn.GroupNorm(num_groups=32): epsilon 1e-6, float32
        self.input_norm = nn.GroupNorm(32, d_model, eps=1e-6)
        self.encoder_layers = nn.ModuleList(
            EncoderLayer1D(d_model, num_heads, ffn_dim, dropout, dtype)
            for _ in range(num_encoder_layers))
        self.decoder_layers = nn.ModuleList(
            DecoderLayer1D(d_model, num_heads, ffn_dim, dropout, dtype)
            for _ in range(num_decoder_layers))
        self.decoder_norm = LayerNorm(d_model, eps=1e-5)
        self.query_embedding = nn.Embedding(vocab_size, d_model)
        self.seq_pos = nn.Embedding(max_seq_len, d_model)
        self.predictor = Linear(d_model, vocab_size)

    def forward_encoder(self, x, x_mask=None):
        """x: [B, H, W, C]; x_mask: [B, H, W] (True = padded) -> (memory
        [B, HW, D], pos [B, HW, D], flat mask [B, HW])."""
        b, h, w, _ = x.shape
        dt = self.dtype
        acc = torch.promote_types(dt, torch.float32)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2),
                     self.input_proj.weight.to(dt),
                     self.input_proj.bias.to(dt))
        gn = self.input_norm
        y = F.group_norm(y.to(acc), gn.num_groups, gn.weight.to(acc),
                         gn.bias.to(acc), gn.eps).to(dt)
        if x_mask is None:
            x_mask = torch.zeros(b, h, w, dtype=torch.bool, device=x.device)
        pos = _sine_pos(x_mask, self.d_model, dt)
        y = y.flatten(2).transpose(1, 2)
        mask = x_mask.to(torch.bool).reshape(b, h * w)
        for layer in self.encoder_layers:
            y = layer(y, pos, mask)
        return y, pos, mask

    def forward_decoder(self, seq_ids, memory, memory_pos, memory_mask):
        """seq_ids [B, L] coordinate tokens -> logits [B, L, vocab]."""
        n = seq_ids.shape[1]
        if n > self.max_seq_len:
            raise ValueError(
                f"sequence length {n} exceeds max_seq_len="
                f"{self.max_seq_len}; for generate(), use steps <= "
                "max_seq_len - 1")
        dt = self.dtype
        x = self.query_embedding.weight.to(dt)[seq_ids]
        qpos = self.seq_pos.weight[:n].to(dt)
        mask = causal_mask(n, seq_ids.device)
        for layer in self.decoder_layers:
            x = layer(x, memory, query_pos=qpos, memory_pos=memory_pos,
                      memory_key_padding_mask=memory_mask, tgt_mask=mask)
        return self.predictor(self.decoder_norm(x).to(dt))

    def forward(self, x, seq_ids, x_mask=None):
        memory, pos, mask = self.forward_encoder(x, x_mask)
        return self.forward_decoder(seq_ids, memory, pos, mask)

    @torch.no_grad()
    def generate(self, x, start_id: int, steps: int) -> torch.Tensor:
        """Fixed-length greedy decode, re-running the whole forward at each
        step on a [B, steps + 1] sequence; int64 ids [B, steps]."""
        ids = torch.full((x.shape[0], steps + 1), start_id,
                         dtype=torch.long, device=x.device)
        for t in range(steps):
            ids[:, t + 1] = self(x, ids)[:, t, :].argmax(dim=-1)
        return ids[:, 1:]


class MDETRTransformer(nn.Module):
    """MDETR encoder/decoder (core/layers/mdetr_transformer.py:24-159): the
    encoder's memory is the image tokens followed by the resized text
    features; learned object queries cross-attend it (no causal mask)."""

    def __init__(self, in_channels: int, d_model: int = 256,
                 num_heads: int = 8, ffn_dim: int = 2048,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 num_queries: int = 100, text_dim: int = 768,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.dtype = d_model, dtype
        self.input_proj = Linear(in_channels, d_model, dtype)
        self.resizer = FeatureResizer(text_dim, d_model, dropout, dtype)
        self.enc = nn.ModuleList(
            EncoderLayer1D(d_model, num_heads, ffn_dim, dropout, dtype)
            for _ in range(num_encoder_layers))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, d_model))
        self.dec = nn.ModuleList(
            DecoderLayer1D(d_model, num_heads, ffn_dim, dropout, dtype)
            for _ in range(num_decoder_layers))
        self.dec_norm = LayerNorm(d_model, eps=1e-5)

    def forward(self, x, x_mask, text_feat, text_mask):
        """x [B, H, W, C] image features; text_feat [B, T, text_dim]; masks
        True = padded.  Returns the stacked decoder outputs [L, B,
        num_queries, D]."""
        b, h, w, _ = x.shape
        dt = self.dtype
        src = self.input_proj(x).reshape(b, h * w, self.d_model)
        pos = _sine_pos(x_mask, self.d_model, dt)
        txt = self.resizer(text_feat)
        src = torch.cat([src, txt], dim=1)
        # zero positions for the text tokens (mdetr_transformer.py:141-143)
        pos = torch.cat([pos, torch.zeros_like(txt)], dim=1)
        mask = torch.cat([x_mask.to(torch.bool).reshape(b, h * w),
                          text_mask.to(torch.bool)], dim=1)
        for layer in self.enc:
            src = layer(src, pos, mask)
        tgt = torch.zeros(b, self.query_embed.shape[0], self.d_model,
                          dtype=dt, device=x.device)
        qpos = self.query_embed.to(dt).expand(b, -1, -1)
        out = []
        for layer in self.dec:
            tgt = layer(tgt, src, query_pos=qpos, memory_pos=pos,
                        memory_key_padding_mask=mask, tgt_mask=None)
            out.append(self.dec_norm(tgt).to(dt))
        return torch.stack(out)
