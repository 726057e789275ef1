"""simvg_tpu_torch's attention held against simvg_tpu's.

- ``multihead_attention`` (plain path) vs the JAX function, with and
  without padding, with ``return_weights``;
- ``fused_attention`` on CPU tensors, which takes its plain version, vs
  the JAX Pallas kernel itself in interpret mode, as
  tests/test_pallas_attention.py runs it;
- its gradients (the autograd Function with the plain forward and
  backward on CPU tensors) vs ``jax.grad`` through the Pallas kernels in
  interpret mode, and ``fused_attention_bwd_reference`` vs the Pallas
  backward's cotangents;
- the wrapper's checks, which raise rather than fall back;
- the bf16 row term of the card's backward (K1's split-P residual r and
  D = rowsum(dO (out + r))) vs JAX's rowsum(dP P) and the Pallas backward,
  and its dq's distance from float64 vs the JAX formula's.

Tolerances: forward 2e-5 (float32); gradients 3e-4 absolute / 1e-3
relative, the bounds of tests/test_pallas_attention.py.  The CUDA kernels
are held against their plain versions on the card by chip_smoke.py and
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simvg_tpu.ops.attention import multihead_attention as jax_mha
from simvg_tpu.ops.pallas_attention import fused_attention as jax_fused
from simvg_tpu_torch.ops.attention import multihead_attention
from simvg_tpu.ops.pallas_attention import _probs as jax_probs
from simvg_tpu_torch.ops.fused_attention import (
    _logits, attention_bwd, attention_residual_reference, attention_row_term,
    fused_attention, fused_attention_bwd_reference, fused_attention_reference)
from util_torch_port import one_torch_thread  # noqa: F401


def _qkv(b, sq, sk, d, seed):
    r = np.random.default_rng(seed)
    return tuple(r.normal(size=(b, s, d)).astype(np.float32)
                 for s in (sq, sk, sk))


def _pad(b, sk, lengths):
    pad = np.zeros((b, sk), np.int32)
    for i, n in enumerate(lengths):
        pad[i, n:] = 1
    return pad


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("return_weights", [False, True])
def test_multihead_attention_matches_jax(padded, return_weights):
    b, s, h, hd = 2, 23, 4, 8
    q, k, v = _qkv(b, s, s, h * hd, seed=0)
    pad = _pad(b, s, [23, 9]) if padded else None
    out_j = jax_mha(*map(jnp.asarray, (q, k, v)), num_heads=h,
                    key_padding_mask=None if pad is None else jnp.asarray(pad),
                    return_weights=return_weights)
    out_t = multihead_attention(
        *map(torch.from_numpy, (q, k, v)), num_heads=h,
        key_padding_mask=None if pad is None else torch.from_numpy(pad),
        return_weights=return_weights)
    if not return_weights:
        out_j, out_t = (out_j,), (out_t,)
    for t, j in zip(out_t, out_j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5,
                                   rtol=0)


def test_multihead_attention_pallas_impl_on_cpu_takes_plain_path():
    b, s, h, hd = 2, 19, 2, 64
    q, k, v = map(torch.from_numpy, _qkv(b, s, s, h * hd, seed=1))
    pad = torch.from_numpy(_pad(b, s, [19, 11]))
    before = fused_attention.launches
    out = multihead_attention(q, k, v, num_heads=h, key_padding_mask=pad,
                              impl="pallas")
    ref = multihead_attention(q, k, v, num_heads=h, key_padding_mask=pad)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    assert fused_attention.launches == before


@pytest.mark.parametrize("b,sq,sk,h,hd,lengths", [
    (2, 37, 37, 4, 64, [30, 10]),
    (1, 421, 421, 2, 64, None),  # the flagship's sequence length
    (2, 13, 70, 3, 64, [70, 1]),  # odd lengths, Sq != Sk, one live key
    # head dims above 128: padded to 256 (160), native 256, the split
    # route (384)
    (1, 48, 48, 2, 160, [40]),
    (1, 48, 48, 2, 256, [40]),
    (1, 40, 33, 2, 384, [20]),
])
def test_fused_attention_cpu_matches_pallas_interpret(b, sq, sk, h, hd,
                                                      lengths):
    q, k, v = _qkv(b, sq, sk, h * hd, seed=2)
    q = q * hd ** -0.5
    shape = lambda x, s: x.reshape(b, s, h, hd)  # noqa: E731
    pad = None if lengths is None else _pad(b, sk, lengths)
    out_j = jax_fused(jnp.asarray(shape(q, sq)), jnp.asarray(shape(k, sk)),
                      jnp.asarray(shape(v, sk)),
                      key_padding_mask=None if pad is None
                      else jnp.asarray(pad),
                      interpret=True)
    before = fused_attention.launches
    out_t = fused_attention(
        torch.from_numpy(shape(q, sq)), torch.from_numpy(shape(k, sk)),
        torch.from_numpy(shape(v, sk)),
        key_padding_mask=None if pad is None else torch.from_numpy(pad))
    assert fused_attention.launches == before  # CPU: no kernel launched
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5,
                               rtol=0)


def test_fused_attention_raises_off_cpu_without_cuda():
    q = torch.empty(2, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_attention(q, q, q)


@pytest.mark.parametrize("case", ["dtype", "head_dim", "shape", "mask",
                                  "layout", "grad"])
def test_fused_attention_checks_reject_what_the_kernel_does_not_take(case):
    from simvg_tpu_torch.ops.fused_attention import _check

    def mk(s=8, hd=64, dtype=torch.float32):
        return torch.zeros(2, s, 2, hd, dtype=dtype)

    q = k = v = mk()
    mask = None
    if case == "dtype":
        q = k = v = mk(dtype=torch.float16)
    elif case == "head_dim":  # every head_dim is taken, as the TPU kernel's
        for hd in (160, 256, 384):
            _check(mk(hd=hd), mk(hd=hd), mk(hd=hd), None)
        return
    elif case == "shape":
        k = v = mk(s=8, hd=64)[:1]
    elif case == "mask":
        mask = torch.zeros(2, 9, dtype=torch.bool)
    elif case == "layout":
        q = mk().transpose(1, 2).contiguous().transpose(1, 2)
    _check(mk(), mk(), mk(), None)  # the good case passes
    if case == "grad":  # a cotangent the backward kernel does not take
        from simvg_tpu_torch.ops.fused_attention import _check_grad

        _check_grad(mk(), mk())
        with pytest.raises(ValueError):
            _check_grad(mk(), mk(dtype=torch.bfloat16))
        return
    with pytest.raises((TypeError, ValueError)):
        _check(q, k, v, mask)


@pytest.mark.parametrize("hd", [16, 48, 80, 100, 160, 320])
def test_padded_head_dims_are_exact(hd):
    """A head_dim with no instantiation runs on the next one (16 -> 32,
    48 -> 64, 80 and 100 -> 128, 160 -> 256), and above 256 on the split
    route's next multiple of 128 (320 -> 384), with q, k, v zero-padded and
    the results cut back: the plain versions on the padded tensors, cut,
    give the unpadded ones (forward, the residual, the gradients) within
    float32 rounding."""
    from simvg_tpu_torch.ops.fused_attention import (
        _pad_head_dim, attention_residual_reference, native_head_dim)

    n = native_head_dim(hd)
    assert n == {16: 32, 48: 64, 80: 128, 100: 128, 160: 256, 320: 384}[hd]
    b, s, h = 2, 37, 3
    r = np.random.default_rng(hd)
    q, k, v, dout = (torch.from_numpy(r.normal(size=(b, s, h, hd))
                                      .astype(np.float32)) for _ in range(4))
    q = q * hd ** -0.5
    pad = torch.from_numpy(_pad(b, s, [s, 20]))
    qp, kp, vp, dp = _pad_head_dim([q, k, v, dout], n)
    assert qp.shape[-1] == n and not qp[..., hd:].any()
    cut = lambda t: t[..., :hd]  # noqa: E731
    torch.testing.assert_close(cut(fused_attention_reference(qp, kp, vp, pad)),
                               fused_attention_reference(q, k, v, pad),
                               atol=1e-6, rtol=0)
    for got, want in zip(attention_residual_reference(
            qp.bfloat16(), kp.bfloat16(), vp.bfloat16(), pad),
            attention_residual_reference(q.bfloat16(), k.bfloat16(),
                                         v.bfloat16(), pad)):
        torch.testing.assert_close(cut(got).float(), want.float(),
                                   atol=1e-6, rtol=0)
    for got, want in zip(fused_attention_bwd_reference(qp, kp, vp, dp, pad),
                         fused_attention_bwd_reference(q, k, v, dout, pad)):
        torch.testing.assert_close(cut(got), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["bool", "bool_strided", "int64"])
def test_kernel_mask_views_a_bool_mask_without_a_cast(case):
    """The mask the kernels read, uint8 [B, Sk]: a contiguous bool mask (the
    model's) is viewed as its bytes and shares its storage, so a call
    launches no cast kernel; any other mask is cast to the same values."""
    from simvg_tpu_torch.ops.fused_attention import _pad_u8

    mask = torch.from_numpy(_pad(3, 10, [10, 4, 1])).to(torch.bool)
    if case == "bool_strided":
        mask = torch.cat([mask, ~mask], dim=1)[:, ::2]
    elif case == "int64":
        mask = mask.long()
    u8 = _pad_u8(mask)
    assert u8.dtype == torch.uint8 and u8.is_contiguous()
    assert torch.equal(u8, mask.to(torch.uint8))
    shares = u8.untyped_storage().data_ptr() == \
        mask.untyped_storage().data_ptr()
    assert shares == (case == "bool")


def test_reference_matches_plain_attention_in_bf16():
    """The plain version rounds P to v's dtype before P.V, as the kernel
    does; in bf16 it stays within bf16 resolution of the float32 result."""
    b, s, h, hd = 2, 31, 2, 64
    q, k, v = (torch.from_numpy(x).reshape(b, s, h, hd)
               for x in _qkv(b, s, s, h * hd, seed=3))
    pad = torch.from_numpy(_pad(b, s, [31, 5]))
    out32 = fused_attention_reference(q * hd ** -0.5, k, v, pad)
    out16 = fused_attention_reference(
        *(x.to(torch.bfloat16) for x in (q * hd ** -0.5, k, v)), pad)
    assert out16.dtype == torch.bfloat16
    torch.testing.assert_close(out16.float(), out32, atol=2e-2, rtol=0)


GRAD_CASES = [  # (b, sq, sk, h, hd, key lengths)
    (2, 37, 37, 4, 64, [30, 10]),  # padded keys
    (2, 13, 70, 3, 64, [70, 1]),  # Sq != Sk, one live key
    (1, 150, 20, 2, 64, None),  # several query blocks, fewer keys
    (1, 48, 48, 2, 160, [40]),  # padded to 256
    (1, 48, 48, 2, 256, [40]),  # native 256
    (1, 40, 33, 2, 384, [20]),  # the split route
]


def _np_qkv_do(b, sq, sk, h, hd, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, sq, h, hd)).astype(np.float32),
            r.normal(size=(b, sk, h, hd)).astype(np.float32),
            r.normal(size=(b, sk, h, hd)).astype(np.float32),
            r.normal(size=(b, sq, h, hd)).astype(np.float32))


@pytest.mark.parametrize("b,sq,sk,h,hd,lengths", GRAD_CASES)
def test_fused_attention_grads_match_pallas_interpret(b, sq, sk, h, hd,
                                                      lengths):
    """Autograd through the port's Function (plain versions on CPU) vs
    jax.grad through the Pallas kernels, with the q scale applied outside
    the kernel in both, so its gradient flows as in JAX."""
    q, k, v, do = _np_qkv_do(b, sq, sk, h, hd, seed=4)
    pad = None if lengths is None else _pad(b, sk, lengths)
    scale = hd ** -0.5

    def loss_j(q, k, v):
        out = jax_fused(q * scale, k, v, interpret=True,
                        key_padding_mask=None if pad is None
                        else jnp.asarray(pad))
        return (out * do).sum()

    grads_j = jax.grad(loss_j, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = (fused_attention.launches, attention_bwd.launches)
    out = fused_attention(ts[0] * scale, ts[1], ts[2],
                          None if pad is None else torch.from_numpy(pad))
    (out * torch.from_numpy(do)).sum().backward()
    assert (fused_attention.launches, attention_bwd.launches) == before
    for name, t, g in zip("qkv", ts, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=3e-4,
                                   rtol=1e-3, err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_reference_matches_pallas_backward(dtype):
    """fused_attention_bwd_reference vs the cotangents of the Pallas
    backward (_attention_flat_bwd) in interpret mode, on the same inputs in
    the same dtype.  bf16: both round P and dS to bf16 at the same places,
    so they differ where fp32 summation order flips a rounding; bound 2e-2
    of each gradient's max |value|, five bf16 steps."""
    b, sq, sk, h, hd = 2, 45, 45, 2, 64
    q, k, v, do = _np_qkv_do(b, sq, sk, h, hd, seed=5)
    q = q * hd ** -0.5
    pad = _pad(b, sk, [45, 17])
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jdt) for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda q, k, v: jax_fused(
        q, k, v, key_padding_mask=jnp.asarray(pad), interpret=True),
        jq, jk, jv)
    grads_j = vjp(jdo)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                       .to(tdt) for x in (jq, jk, jv, jdo))
    grads_t = fused_attention_bwd_reference(tq, tk, tv, tdo,
                                            torch.from_numpy(pad))
    for name, t, g in zip("qkv", grads_t, grads_j):
        assert t.dtype == tdt
        g = np.asarray(g.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(t.numpy(), g, atol=3e-4, rtol=1e-3,
                                       err_msg=f"d{name}")
        else:
            err = np.abs(t.float().numpy() - g).max()
            assert err <= 2e-2 * np.abs(g).max(), (name, err)


def _bf16_case(b, s, h, hd, seed, q_scale=1.0):
    """bf16 q (pre-scaled, times q_scale), k, v, dO from a numpy seed, and a
    mask that pads the last 7 keys of the last batch row."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _np_qkv_do(b, s, s, h, hd, seed))
    q = (q.float() * hd ** -0.5 * q_scale).to(torch.bfloat16)
    pad = torch.zeros(b, s, dtype=torch.bool)
    pad[-1, s - 7:] = True
    return q, k, v, do, pad


def test_row_term_matches_jax_rowsum_and_the_pallas_backward():
    """D = rowsum(dO (out + r)) from K1's split-P residual vs JAX's
    rowsum(dP P) (pallas_attention.py:93, with the kernel's own _probs) on
    the same bf16 inputs: within 1e-5 of max |D| (out + r carries P to
    ~2^-17; the rest is fp32 summation order).  The grads built on it vs
    the Pallas backward's cotangents in interpret mode, at the bf16 bound
    of test_bwd_reference_matches_pallas_backward."""
    b, s, h, hd = 2, 45, 2, 64
    q, k, v, do, pad = _bf16_case(b, s, h, hd, seed=6)
    out, resid = attention_residual_reference(q, k, v, pad)
    assert out.dtype == resid.dtype == torch.bfloat16
    torch.testing.assert_close(out, fused_attention_reference(q, k, v, pad),
                               atol=0, rtol=0)
    d = attention_row_term(out, resid, do)

    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                       for t in (q, k, v, do))
    bias = jnp.where(jnp.asarray(pad.numpy()), -1e30, 0.0)

    def rowsum(q, k, v, do, bias):  # one (batch, head): [s, hd] each
        p = jax_probs(q, k, bias[None])
        dp = jax.lax.dot_general(do, v, (((1,), (1,)), ((), ())),
                                 preferred_element_type=jnp.float32)
        return jnp.sum(dp * p, axis=-1)

    heads = jax.vmap(rowsum, in_axes=(1, 1, 1, 1, None))  # over h
    d_j = np.asarray(jax.vmap(heads)(jq, jk, jv, jdo, bias))  # [b, h, s]
    err = np.abs(d.numpy() - d_j).max()
    assert err <= 1e-5 * np.abs(d_j).max(), err

    _, vjp = jax.vjp(lambda q, k, v: jax_fused(
        q, k, v, key_padding_mask=jnp.asarray(pad.numpy().astype(np.int32)),
        interpret=True), jq, jk, jv)
    grads_t = fused_attention_bwd_reference(q, k, v, do, pad, row_term=d)
    for name, t, g in zip("qkv", grads_t, vjp(jdo)):
        g = np.asarray(g.astype(jnp.float32))
        err = np.abs(t.float().numpy() - g).max()
        assert err <= 2e-2 * np.abs(g).max(), (name, err)


def _rel_l2(x, ref):
    return ((x.double() - ref).norm() / ref.norm()).item()


@pytest.mark.parametrize("q_scale", [1, 8, 32, 64])
def test_row_term_dq_as_close_to_float64_as_the_jax_formula(q_scale):
    """dq from the card's row term is no further from float64 than 1.1x
    the JAX formula's (rowsum(dP P)), from attention with logits scaled up
    to q_scale x (peaked P).  The bf16 output alone, D = rowsum(dO
    round(out)), is several times further off there: the witness that the
    residual carries the row term."""
    b, s, h, hd = 2, 128, 2, 64
    q, k, v, do, pad = _bf16_case(b, s, h, hd, seed=7, q_scale=q_scale)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    p = torch.softmax(_logits(q64, k64, pad).double(), dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do64, v64)
    dq64 = torch.einsum("bhqk,bkhd->bqhd",
                        p * (dp - (dp * p).sum(-1, keepdim=True)), k64)

    out, resid = attention_residual_reference(q, k, v, pad)
    e_jax = _rel_l2(fused_attention_bwd_reference(q, k, v, do, pad)[0], dq64)
    e_row = _rel_l2(fused_attention_bwd_reference(
        q, k, v, do, pad, row_term=attention_row_term(out, resid, do))[0],
        dq64)
    assert e_row <= 1.1 * e_jax, (e_row, e_jax)
    if q_scale >= 8:
        e_out = _rel_l2(fused_attention_bwd_reference(
            q, k, v, do, pad,
            row_term=attention_row_term(out, torch.zeros_like(out), do))[0],
            dq64)
        assert e_out > 2 * e_jax, (e_out, e_jax)
