"""Multi-head attention core (port of ``simvg_tpu/ops/attention.py``).

    q <- q * head_dim**-0.5, then cast to the compute dtype
    logits <- q @ k^T in float32 (+ additive bias) (padded keys -> -inf)
    probs  <- softmax(logits) in float32, then cast to the compute dtype
    out    <- probs @ v, summed in float32

``impl="pallas"`` (the config value the JAX package uses) selects the
Hopper kernel (``fused_attention``) for CUDA tensors when there is no
``attn_bias``, no active dropout and no ``return_weights``; every other
call takes the plain path below.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .fused_attention import fused_attention


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    num_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,
    attn_bias: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    dtype: torch.dtype = torch.float32,
    impl: str = "xla",
    return_weights: bool = False,
):
    """Batched multi-head attention.

    Args:
        q/k/v: [B, S_q, D] / [B, S_k, D] / [B, S_k, D], already projected.
        key_padding_mask: optional [B, S_k]; nonzero = PADDED key.
        attn_bias: optional additive bias broadcastable to [B, H, S_q, S_k].
        dropout_rate: attention-prob dropout (post-softmax), active only
            when ``deterministic`` is False.
        dtype: compute dtype of the matmuls (softmax is always fp32).

    Returns:
        [B, S_q, D] in ``dtype``; with ``return_weights`` also the
        probabilities [B, H, S_q, S_k] in ``dtype``.
    """
    b, s_q, d = q.shape
    s_k = k.shape[1]
    if d % num_heads:
        raise ValueError(f"embed dim {d} is not a multiple of {num_heads}")
    head_dim = d // num_heads
    scale = head_dim ** -0.5

    q = (q * scale).reshape(b, s_q, num_heads, head_dim).to(dtype)
    k = k.reshape(b, s_k, num_heads, head_dim).to(dtype)
    v = v.reshape(b, s_k, num_heads, head_dim).to(dtype)

    dropout_active = dropout_rate > 0.0 and not deterministic
    if (impl == "pallas" and not return_weights and q.is_cuda
            and attn_bias is None and not dropout_active):
        out = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              key_padding_mask=key_padding_mask)
        return out.reshape(b, s_q, d)

    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if attn_bias is not None:
        logits = logits + attn_bias.float()
    if key_padding_mask is not None:
        pad = key_padding_mask.to(torch.bool)[:, None, None, :]
        logits = logits.masked_fill(pad, float("-inf"))

    probs = torch.softmax(logits, dim=-1)
    if dropout_active:
        probs = F.dropout(probs, dropout_rate, training=True)

    probs = probs.to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    out = out.reshape(b, s_q, d).to(dtype)
    if return_weights:
        return out, probs
    return out
