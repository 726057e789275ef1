"""simvg_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here skips where there is no CUDA device.  On a machine with an
NVIDIA Hopper GPU and nvcc, run (tests/conftest.py imports JAX, which the
port does not need, so it is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The cases reach what chip_smoke.py's flagship shapes do not: Sq != Sk,
fewer keys than one tile, a row with one live key.  Bounds:
float32 2e-5 (tests/test_pallas_attention.py); bf16 2e-2, one bf16 step
for |out| < 4, since the kernel rounds P before normalising and the plain
version after.
"""

import pytest
import torch

from simvg_tpu_torch.ops.fused_attention import (fused_attention,
                                                 fused_attention_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,sq,sk,h,hd,lengths", [
    (2, 421, 421, 12, 64, [421, 404]),  # the flagship, padded text
    (3, 13, 70, 3, 64, [70, 1, 33]),  # Sq != Sk, one live key
    (1, 200, 5, 2, 64, None),  # fewer keys than one 64-key tile
    (1, 1, 1, 1, 64, None),
])
def test_attention_fwd_matches_plain_version(gen, dtype, atol, b, sq, sk, h,
                                             hd, lengths):
    q = (torch.randn(b, sq, h, hd, device="cuda", generator=gen)
         * hd ** -0.5).to(dtype)
    k, v = (torch.randn(b, sk, h, hd, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    pad = None
    if lengths is not None:
        pad = (torch.arange(sk, device="cuda")[None]
               >= torch.tensor(lengths, device="cuda")[:, None])
    before = fused_attention.launches
    out = fused_attention(q, k, v, pad)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = fused_attention_reference(q, k, v, pad)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


def test_attention_fwd_raises_on_unsupported_head_dim(gen):
    q = torch.randn(1, 8, 2, 32, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="head_dim"):
        fused_attention(q, q, q)
