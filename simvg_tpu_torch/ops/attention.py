"""Multi-head attention core (port of ``simvg_tpu/ops/attention.py``).

    q <- q * head_dim**-0.5, then cast to the compute dtype
    logits <- q @ k^T in float32 (+ additive bias) (padded keys -> -inf)
    probs  <- softmax(logits) in float32, then cast to the compute dtype
    out    <- probs @ v, summed in float32

(float64 throughout for a float64 compute dtype.)

``impl="pallas"`` (the config value the JAX package uses) selects
``fused_attention`` (K1 forward, K2 backward: the Hopper kernels on CUDA
tensors, their plain versions on CPU tensors) when there is no
``attn_bias``, no active dropout and no ``return_weights``; every other
call takes the plain path below.  The q scale is applied here, outside the
kernels, so autograd carries its gradient as JAX does.

``cls_attention`` gives the CLS query's attention row alone, the score
that token pruning ranks patches by, with a [B, H, 1, S] product beside a
kernel call that never materialises the probabilities.
"""

from __future__ import annotations

from typing import Optional

import torch

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
    generator: Optional[torch.Generator] = None,
):
    """Batched multi-head attention.

    Args:
        q/k/v: [B, S_q, D] / [B, S_k, D] / [B, S_k, D], already projected.
        key_padding_mask: optional [B, S_k]; nonzero = PADDED key.
        attn_bias: optional additive bias broadcastable to [B, H, S_q, S_k].
        dropout_rate: attention-prob dropout (post-softmax), active only
            when ``deterministic`` is False; its mask is drawn from
            ``generator``.
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
    if (impl == "pallas" and not return_weights and attn_bias is None
            and not dropout_active):
        out = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              key_padding_mask=key_padding_mask)
        return out.reshape(b, s_q, d)

    acc = torch.promote_types(dtype, torch.float32)  # float64 stays so
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc))
    if attn_bias is not None:
        logits = logits + attn_bias.to(acc)
    if key_padding_mask is not None:
        pad = key_padding_mask.to(torch.bool)[:, None, None, :]
        logits = logits.masked_fill(pad, float("-inf"))

    probs = torch.softmax(logits, dim=-1)
    if dropout_active:
        keep = 1.0 - dropout_rate
        mask = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < keep
        probs = torch.where(mask, probs / keep, 0.0)

    probs = probs.to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(acc), v.to(acc))
    out = out.reshape(b, s_q, d).to(dtype)
    if return_weights:
        return out, probs
    return out


def cls_attention(q: torch.Tensor, k: torch.Tensor, *, num_heads: int,
                  key_padding_mask: Optional[torch.Tensor] = None,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The first (CLS) query's attention probabilities averaged over heads,
    float32 [B, S_k]: the plain path's row 0 for the same q, k (projected,
    unscaled), probabilities rounded to ``dtype`` as the plain path rounds
    them (``simvg_tpu/models/beit3.py`` takes them from there)."""
    b, _, d = q.shape
    s_k = k.shape[1]
    head_dim = d // num_heads
    q0 = (q[:, :1] * head_dim ** -0.5).reshape(b, 1, num_heads, head_dim)
    k = k.reshape(b, s_k, num_heads, head_dim).to(dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q0.to(dtype).float(), k.float())
    if key_padding_mask is not None:
        pad = key_padding_mask.to(torch.bool)[:, None, None, :]
        logits = logits.masked_fill(pad, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return probs[:, :, 0, :].float().mean(dim=1)
