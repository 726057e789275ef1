"""simvg_tpu_torch's attention held against simvg_tpu's.

- ``multihead_attention`` (plain path) vs the JAX function, with and
  without padding, with ``return_weights``;
- ``fused_attention`` on CPU tensors, which takes its plain version, vs
  the JAX Pallas kernel itself in interpret mode, as
  tests/test_pallas_attention.py runs it;
- the wrapper's checks, which raise rather than fall back.

Tolerance 2e-5 (float32), the bound of tests/test_pallas_attention.py.
The CUDA kernel is held against its plain version on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simvg_tpu.ops.attention import multihead_attention as jax_mha
from simvg_tpu.ops.pallas_attention import fused_attention as jax_fused
from simvg_tpu_torch.ops.attention import multihead_attention
from simvg_tpu_torch.ops.fused_attention import (fused_attention,
                                                 fused_attention_reference)


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
    elif case == "head_dim":
        q = k = v = mk(hd=48)
    elif case == "shape":
        k = v = mk(s=8, hd=64)[:1]
    elif case == "mask":
        mask = torch.zeros(2, 9, dtype=torch.bool)
    elif case == "layout":
        q = mk().transpose(1, 2).contiguous().transpose(1, 2)
    else:
        q = mk().requires_grad_()
    _check(mk(), mk(), mk(), None)  # the good case passes
    with pytest.raises((TypeError, ValueError, NotImplementedError)):
        _check(q, k, v, mask)


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
