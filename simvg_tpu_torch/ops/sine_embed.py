"""Sinusoidal position embeddings (port of ``simvg_tpu/ops/sine_embed.py``).

- ``sine_position_embedding_2d``: the DETR 2-D sine embedding over the
  image feature grid, built from its padding mask.
- ``sine_position_embedding_1d_ref``: the reference's 1-D text embedding,
  which casts its inverse-frequency vector to int64 and so floors every
  frequency but the first to zero: [sin(p), cos(p), 0, 1, 0, 1, ...].
  Released checkpoints were trained against that, so it is kept.
"""

from __future__ import annotations

import math

import torch


def sine_position_embedding_2d(
    pad_mask: torch.Tensor,
    num_pos_feats: int,
    temperature: float = 10000.0,
    normalize: bool = True,
    scale: float = 2 * math.pi,
    eps: float = 1e-6,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """bool [B, H, W] (True = padded) -> [B, H, W, 2*num_pos_feats] in
    ``dtype`` (float32, or float64 for a float64 model), y-features first,
    then x."""
    not_mask = (~pad_mask.to(torch.bool)).to(dtype)
    y_embed = not_mask.cumsum(dim=1)
    x_embed = not_mask.cumsum(dim=2)
    if normalize:
        y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale

    i = torch.arange(num_pos_feats, dtype=dtype,
                     device=pad_mask.device)
    dim_t = temperature ** (2.0 * torch.floor(i / 2.0) / num_pos_feats)

    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    # sin on even channels, cos on odd, interleaved
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=-1).flatten(-2)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=-1).flatten(-2)
    return torch.cat([pos_y, pos_x], dim=-1)


def sine_position_embedding_1d_ref(seq_len: int, dim: int,
                                   device=None) -> torch.Tensor:
    """[seq_len, dim] float32: out[:, 0] = sin(pos), out[:, 1] = cos(pos),
    out[:, 2::2] = 0, out[:, 3::2] = 1 (the reference's int cast)."""
    if dim % 2:
        raise ValueError(f"dim must be even, got {dim}")
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    half = dim // 2
    inv_freq = 1.0 / (10000.0 ** (
        torch.arange(half, dtype=torch.float32, device=device) / half))
    inv_freq = torch.floor(inv_freq)  # the reference's int64 cast
    out = pos[:, None] * inv_freq[None, :]
    emb = torch.zeros(seq_len, dim, dtype=torch.float32, device=device)
    emb[:, 0::2] = out.sin()
    emb[:, 1::2] = out.cos()
    return emb
