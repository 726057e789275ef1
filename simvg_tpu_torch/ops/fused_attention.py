"""Fused multi-head attention forward: the Hopper kernel and its plain version.

Port of ``simvg_tpu/ops/pallas_attention.py::fused_attention``, whose TPU
kernel is ``_attn_kernel`` (pallas_attention.py:55, called at :131).  The
CUDA kernel lives in ``csrc/attention_fwd.cu``; its header says how it
streams K/V through shared memory with an online softmax, because one
head's K/V at S = 1621 do not fit a Hopper block's shared memory the way
they fit the TPU's VMEM.

On this card the flagship's call (S = 421, head_dim 64, bf16) is a small,
latency-bound product: the encoder's linear layers take ~92% of a layer's
FLOPs, so this kernel moves little of the end-to-end time.

``fused_attention`` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; only a tensor on the CPU goes to
``fused_attention_reference``, the plain PyTorch version of the same
function.  The backward kernel (``_attn_bwd_kernel``) is not ported yet,
so a call that would need a gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

_NEG = -1e30  # the TPU kernel's additive bias on padded keys
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64,)  # the instantiations in attention_fwd.cu


def fused_attention_reference(
    q: torch.Tensor,  # [B, Sq, H, hd], already scaled by hd**-0.5
    k: torch.Tensor,  # [B, Sk, H, hd]
    v: torch.Tensor,  # [B, Sk, H, hd]
    key_padding_mask: Optional[torch.Tensor] = None,  # [B, Sk], 1 = pad
) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: fp32 logits, -1e30 on
    padded keys, fp32 softmax, probabilities cast to v's dtype, P.V summed
    in fp32 and returned in q's dtype."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if key_padding_mask is not None:
        pad = key_padding_mask.to(torch.bool)[:, None, None, :]
        logits = logits.masked_fill(pad, _NEG)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load("attention_fwd")
    fn = lib.simvg_attention_fwd
    # pointers and the stream as c_void_p, or ctypes would cut them to int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, key_padding_mask):
    """Raises on any input the kernel does not take (device aside)."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError("fused_attention: q, k, v must share one dtype of "
                        f"{list(_DTYPE_CODES)}, got {q.dtype, k.dtype, v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("fused_attention: expected q [B, Sq, H, hd] and "
                         f"k, v [B, Sk, H, hd], got {q.shape, k.shape, v.shape}")
    b, sq, h, hd = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, hd) or 0 in q.shape \
            or k.shape[1] == 0:
        raise ValueError(f"fused_attention: shapes {q.shape} and {k.shape} "
                         "do not match")
    if hd not in HEAD_DIMS:
        raise ValueError(f"fused_attention: head_dim {hd} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("fused_attention: q, k, v must be contiguous")
    if key_padding_mask is not None and \
            tuple(key_padding_mask.shape) != (b, k.shape[1]):
        raise ValueError(f"fused_attention: key_padding_mask "
                         f"{tuple(key_padding_mask.shape)} is not "
                         f"{(b, k.shape[1])}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "fused_attention has no backward kernel yet; run it under "
            "torch.no_grad() or use the plain attention path")


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns [B, Sq, H, hd] in q.dtype; the contract of the JAX entry
    point (pallas_attention.py:207) without ``block_q``/``interpret``."""
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, key_padding_mask)
    tensors = [q, k, v] + ([key_padding_mask]
                           if key_padding_mask is not None else [])
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("fused_attention: no kernel for inputs on "
                         f"{sorted({str(t.device) for t in tensors})}")
    _check(q, k, v, key_padding_mask)
    lib = _library()
    b, sq, h, hd = q.shape
    out = torch.empty_like(q)
    pad = None
    if key_padding_mask is not None:
        pad = key_padding_mask.to(torch.uint8).contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.simvg_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if pad is None else pad.data_ptr(), out.data_ptr(),
            b, sq, k.shape[1], h, hd, _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: CUDA error "
                           f"{rc}")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0  # kernel launches; chip_smoke.py reads it
