"""Fused multi-head attention, forward and backward: the Hopper kernels and
their plain versions.

Port of ``simvg_tpu/ops/pallas_attention.py::fused_attention`` and its
custom VJP.  The TPU kernels are ``_attn_kernel`` (pallas_attention.py:55,
called at :131) and ``_attn_bwd_kernel`` (:66, called at :165 by
``_attention_flat_bwd``).  The CUDA kernels live in ``csrc/attention_fwd.cu``
(K1) and ``csrc/attention_bwd.cu`` (K2); their headers say how they stream
K/V through shared memory with an online softmax, and how K2 replaces the
TPU kernel's sequential dK/dV accumulation with two kernels and no atomics.

Each kernel has two routes, chosen by dtype inside its C entry point:
float32 runs on the CUDA cores in fp32 FMAs, the parity route; bf16 on the
tensor cores, both kernels as Hopper's ``wgmma`` on tiles that TMA brings
in, a producer warp feeding consumer warpgroups (``csrc/attention_sm90.cuh``).

``fused_attention`` is the entry point.  It calls K1 as the operator
``torch.ops.simvg.attention_fwd`` (``torch.library``), which returns the
output, the row LSE and, in bf16 when a gradient is wanted, the output's
residual r (what K2 takes its row term from), has K2 as its backward, and
has a fake kernel that gives the outputs' shapes and dtypes, so that
``torch.export`` keeps K1 in the exported graph as one node a call
(``simvg_tpu_torch/export.py``).
For CUDA tensors the operator launches the kernels or raises on anything
the kernels do not take; only tensors on the CPU go to the plain PyTorch
versions, ``fused_attention_reference`` and
``fused_attention_bwd_reference``.

Head dims: any, as the TPU kernel takes any.  Both kernels are
instantiated at 32, 64, 128 and 256 (HEAD_DIMS; at 256 K1 with the residual
and K2 split their outputs' columns over two blocks, and the fp32 K2 takes
the split route).  Above 256 both take the column-split route, whose blocks
each produce a SPLIT_CHUNK-column chunk of the outputs and stream the head
dim box by box, for any multiple of SPLIT_CHUNK.  Any other head_dim runs on
the next of these with q, k and v zero-padded along it and the results cut
back (``native_head_dim``, ``_pad_head_dim``, a plain torch copy).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_NEG = -1e30  # the TPU kernel's additive bias on padded keys
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the instantiations in attention_fwd.cu / attention_bwd.cu; above the last,
# the split route takes multiples of SPLIT_CHUNK; any other head_dim runs on
# the next of these, zero-padded (``native_head_dim``)
HEAD_DIMS = (32, 64, 128, 256)
SPLIT_CHUNK = 128


def _logits(q, k, key_padding_mask):
    """fp32 logits [B, H, Sq, Sk] with -1e30 on padded keys."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if key_padding_mask is not None:
        pad = key_padding_mask.to(torch.bool)[:, None, None, :]
        logits = logits.masked_fill(pad, _NEG)
    return logits


def fused_attention_reference(
    q: torch.Tensor,  # [B, Sq, H, hd], already scaled by hd**-0.5
    k: torch.Tensor,  # [B, Sk, H, hd]
    v: torch.Tensor,  # [B, Sk, H, hd]
    key_padding_mask: Optional[torch.Tensor] = None,  # [B, Sk], 1 = pad
) -> torch.Tensor:
    """What K1 computes, in plain PyTorch: fp32 logits, -1e30 on padded
    keys, fp32 softmax, probabilities cast to v's dtype, P.V summed in fp32
    and returned in q's dtype."""
    probs = torch.softmax(_logits(q, k, key_padding_mask), dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def fused_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,  # [B, Sq, H, hd], the cotangent of the output
    key_padding_mask: Optional[torch.Tensor] = None,
    row_term: Optional[torch.Tensor] = None,  # [B, H, Sq] fp32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What K2 computes, in plain PyTorch, with the TPU kernel's formula and
    roundings (pallas_attention.py:81-105): P recomputed in fp32; dV =
    round(P)^T dO; dP = dO V^T; dS = P (dP - D), D = rowsum(dP P); dQ =
    round(dS) K; dK = round(dS)^T q; round() is the cast to the input
    dtype, every sum fp32.  ``row_term``, when given, is used for D (the
    card's bf16 route takes it from ``attention_row_term``).  Returns (dq,
    dk, dv) in q's dtype."""
    cd = q.dtype
    p = torch.softmax(_logits(q, k, key_padding_mask), dim=-1)
    do = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(cd).float(), do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    if row_term is None:
        row_term = (dp * p).sum(-1)
    ds = p * (dp - row_term[..., None])
    ds_c = ds.to(cd).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_c, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_c, q.float())
    return dq.to(cd), dk.to(cd), dv.to(cd)


def attention_residual_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What bf16 K1 writes when a gradient is wanted, in plain PyTorch:
    (out, r).  P is split into a high part round(P) and a low part
    round(P - round(P)); out = round(sum_j high_j v_j), as
    ``fused_attention_reference``; o = sum_j (high + low)_j v_j in fp32 and
    r = round(o - out).  out + r is the output before its rounding to
    ~2^-17, which gives K2 its row term (``attention_row_term``).  Used by
    the tests: the card's kernels compute it."""
    cd = q.dtype
    p = torch.softmax(_logits(q, k, key_padding_mask), dim=-1)
    hi = p.to(cd).float()
    lo = (p - hi).to(cd).float()
    vf = v.float()
    o_hi = torch.einsum("bhqk,bkhd->bqhd", hi, vf)
    o = o_hi + torch.einsum("bhqk,bkhd->bqhd", lo, vf)
    out = o_hi.to(cd)
    return out, (o - out.float()).to(cd)


def attention_row_term(out: torch.Tensor, resid: torch.Tensor,
                       dout: torch.Tensor) -> torch.Tensor:
    """K2's bf16 row term D = rowsum(dO (out + r)) in fp32, [B, H, Sq]: in
    exact arithmetic the TPU kernel's rowsum(dP P), since sum_j P_j dO.v_j
    = dO . sum_j P_j v_j."""
    o = out.float() + resid.float()
    return torch.einsum("bqhd,bqhd->bhq", dout.float(), o)


def _library(name: str, n_pointers: int, n_ints: int):
    lib = _build.load(name)
    fn = getattr(lib, f"simvg_{name}")
    # pointers and the stream as c_void_p, or ctypes would cut them to int
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, key_padding_mask):
    """Raises on any input the kernels do not take (device aside)."""
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
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("fused_attention: q, k, v must be contiguous")
    if key_padding_mask is not None and \
            tuple(key_padding_mask.shape) != (b, k.shape[1]):
        raise ValueError(f"fused_attention: key_padding_mask "
                         f"{tuple(key_padding_mask.shape)} is not "
                         f"{(b, k.shape[1])}")


def native_head_dim(hd: int) -> int:
    """The head_dim the kernels run ``hd`` at: the smallest of HEAD_DIMS
    that holds it, and above them the next multiple of SPLIT_CHUNK (the
    split route)."""
    return next((n for n in HEAD_DIMS if n >= hd),
                -(-hd // SPLIT_CHUNK) * SPLIT_CHUNK)


def _pad_head_dim(tensors, hd_n):
    """The route of a head_dim with no instantiation: each tensor copied
    with zero columns up to ``hd_n`` (a plain torch copy, not a kernel).
    Exact: a zero q/k column adds 0 to every logit, a zero v column gives
    an output column that is cut, and the gradients of the zero columns
    are cut."""
    return [t if t.shape[-1] == hd_n
            else torch.nn.functional.pad(t, (0, hd_n - t.shape[-1]))
            for t in tensors]


def _check_aligned(tensors):
    """The bf16 route moves 16-byte chunks: its tensors must start on a
    16-byte boundary (every fresh allocation does)."""
    if any(t.dtype == torch.bfloat16 and t.data_ptr() % 16 for t in tensors):
        raise ValueError("fused_attention: bf16 tensors must be 16-byte "
                         "aligned")


def _check_grad(q, dout):
    """Raises on a cotangent the backward kernel does not take."""
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"fused_attention: gradient {dout.dtype} "
                         f"{tuple(dout.shape)} does not match the output "
                         f"{q.dtype} {tuple(q.shape)}")


def _check_device(tensors):
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError("fused_attention: no kernel for inputs on "
                         f"{sorted(str(d) for d in devices)}")


def _pad_u8(key_padding_mask):
    """The mask as the kernels read it, uint8 [B, Sk]: a bool mask is viewed
    as its bytes (no cast kernel on each call), any other dtype cast."""
    if key_padding_mask is None:
        return None
    if key_padding_mask.dtype == torch.bool:
        return key_padding_mask.contiguous().view(torch.uint8)
    return key_padding_mask.to(torch.uint8).contiguous()


def _wants_residual(q, grad):
    """K1 writes the residual in bf16 when a gradient is wanted; K2's
    float32 route takes its row term from out alone."""
    return grad and q.dtype == torch.bfloat16


def attention_fwd(q, k, v, key_padding_mask=None, grad=False):
    """Launches K1 on CUDA tensors: returns out [B, Sq, H, hd] in q's
    dtype, the fp32 row log-sum-exp [B, H, Sq] and the residual r of out
    (``attention_residual_reference``), [B, Sq, H, hd] in bf16 with
    ``grad``, else an empty tensor."""
    _check_device([q, k, v, key_padding_mask])
    _check(q, k, v, key_padding_mask)
    b, sq, h, hd = q.shape
    hd_n = native_head_dim(hd)
    q, k, v = _pad_head_dim([q, k, v], hd_n)
    _check_aligned([q, k, v])
    fn = _library("attention_fwd", 7, 6)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    resid = torch.empty_like(q) if _wants_residual(q, grad) \
        else q.new_empty((0,))
    pad = _pad_u8(key_padding_mask)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if pad is None else pad.data_ptr(), out.data_ptr(),
                lse.data_ptr(), resid.data_ptr() if resid.numel() else None,
                b, sq, k.shape[1], h, hd_n, _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: CUDA error "
                           f"{rc}")
    fused_attention.launches += 1
    if hd_n != hd:
        out = out[..., :hd].contiguous()
        resid = resid[..., :hd].contiguous() if resid.numel() else resid
    return out, lse, resid


def attention_bwd(q, k, v, out, dout, lse, resid, key_padding_mask=None):
    """Launches K2 on CUDA tensors: (dq, dk, dv) in q's dtype, from the
    forward's out, lse and, in bf16, its residual (``attention_fwd`` with
    ``grad=True``; float32 reads none)."""
    _check_device([q, k, v, out, dout, lse, key_padding_mask])
    _check(q, k, v, key_padding_mask)
    _check_grad(q, dout)
    b, sq, h, hd = q.shape
    if out.shape != q.shape or out.dtype != q.dtype \
            or lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError("attention_bwd: out/lse do not match q")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and (resid is None or resid.shape != q.shape
                 or resid.dtype != q.dtype or resid.device != q.device
                 or not resid.is_contiguous()):
        raise ValueError("attention_bwd: bf16 needs the forward's residual, "
                         f"{q.dtype} {tuple(q.shape)}, contiguous (run "
                         "attention_fwd with grad=True)")
    dout = dout.contiguous()
    hd_n = native_head_dim(hd)
    if hd_n != hd:
        q, k, v, out, dout = _pad_head_dim([q, k, v, out, dout], hd_n)
        if bf16:
            resid, = _pad_head_dim([resid], hd_n)
    _check_aligned([q, k, v, out, dout] + ([resid] if bf16 else []))
    fn = _library("attention_bwd", 12, 6)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dsum = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    pad = _pad_u8(key_padding_mask)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                resid.data_ptr() if bf16 else None, dout.data_ptr(),
                lse.data_ptr(), None if pad is None else pad.data_ptr(),
                dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                b, sq, k.shape[1], h, hd_n, _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"attention_bwd kernel launch failed: CUDA error "
                           f"{rc}")
    attention_bwd.launches += 1
    if hd_n != hd:
        dq, dk, dv = (g[..., :hd].contiguous() for g in (dq, dk, dv))
    return dq, dk, dv


# K1 as the operator simvg::attention_fwd -> (out, lse, r), with K2 as its
# backward: a CPU kernel (the plain versions), a CUDA kernel (the launches)
# and a fake kernel for tracing.  Every forward goes through it, with or
# without a gradient, so eager, export and training share one route;
# ``grad`` says whether the residual r is written (bf16 on CUDA only).
# Registered with torch.library.Library, whose dispatch costs a few
# microseconds on the host where torch.library.custom_op's Python wrapper
# costs tens.
_LIB = torch.library.Library("simvg", "DEF")
_LIB.define("attention_fwd(Tensor q, Tensor k, Tensor v, "
            "Tensor? key_padding_mask, bool grad=False) "
            "-> (Tensor, Tensor, Tensor)")


def _attention_fwd_cpu(q, k, v, key_padding_mask, grad=False):
    lse = torch.logsumexp(_logits(q, k, key_padding_mask), dim=-1)
    return (fused_attention_reference(q, k, v, key_padding_mask), lse,
            q.new_empty((0,)))


def _attention_fwd_cuda(q, k, v, key_padding_mask, grad=False):
    return attention_fwd(q, k, v, key_padding_mask, grad)


def _attention_fwd_fake(q, k, v, key_padding_mask, grad=False):
    b, sq, h, _ = q.shape
    resid = torch.empty_like(q) \
        if q.device.type == "cuda" and _wants_residual(q, grad) \
        else q.new_empty((0,))
    return (torch.empty_like(q),
            q.new_empty((b, h, sq), dtype=torch.float32), resid)


def _attention_fwd_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:3], *output, inputs[3])
    ctx.set_materialize_grads(False)  # no zeros filled for lse's and r's


def _attention_fwd_backward(ctx, dout, _dlse, _dresid):
    q, k, v, out, lse, resid, key_padding_mask = ctx.saved_tensors
    if q.device.type == "cpu":
        _check_grad(q, dout)
        grads = fused_attention_bwd_reference(q, k, v, dout,
                                              key_padding_mask)
    else:
        grads = attention_bwd(q, k, v, out, dout, lse, resid,
                              key_padding_mask)
    return (*grads, None, None)


_LIB.impl("attention_fwd", _attention_fwd_cpu, "CPU")
_LIB.impl("attention_fwd", _attention_fwd_cuda, "CUDA")
torch.library.register_fake("simvg::attention_fwd", _attention_fwd_fake,
                            lib=_LIB)
torch.library.register_autograd(
    "simvg::attention_fwd", _attention_fwd_backward,
    setup_context=_attention_fwd_setup, lib=_LIB)


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns [B, Sq, H, hd] in q.dtype; the contract of the JAX entry
    point (pallas_attention.py:207) without ``block_q``/``interpret``.
    Differentiable in q, k and v; the mask gets no gradient."""
    if q.device.type != "cpu":  # the operator's fake kernel would not raise
        _check_device([q, k, v, key_padding_mask])
    grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    return torch.ops.simvg.attention_fwd(q, k, v, key_padding_mask, grad)[0]


fused_attention.launches = 0  # K1 launches; chip_smoke.py reads it
attention_bwd.launches = 0  # K2 launches; chip_smoke.py reads it
