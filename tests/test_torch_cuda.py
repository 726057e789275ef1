"""simvg_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here skips where there is no CUDA device.  On a machine with an
NVIDIA Hopper GPU and nvcc, run (tests/conftest.py imports JAX, which the
port does not need, so it is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The data pipeline's card route is held here too: nvJPEG's encode -> decode
round trip (shape exact, mean |difference| <= 2 levels at quality 95, on
smooth images), grayscale and EXIF-oriented files, and the pixel ops on the
card against the same ops on the CPU, on the same decoded pixels (1 level
per resampling; the geometry exact).

The attention cases reach what chip_smoke.py's flagship shapes do not: Sq != Sk,
fewer keys than one tile, a row with one live key, S = 100 (not a
multiple of the 16-row mma fragments), S = 64 (exactly one tile), the
train step's shape, and logits scaled x8 so that later key tiles raise the
row max and the bf16 forward's online softmax rescales its sums.  Forward bounds:
float32 2e-5 (tests/test_pallas_attention.py); bf16 2e-2, one bf16 step
for |out| < 4, since the kernel rounds P before normalising and the plain
version after.  Backward (K2) bounds: float32 3e-4 absolute / 1e-3
relative (tests/test_pallas_attention.py); bf16 2e-2 of each gradient's
max |value|: five bf16 steps, since K2 takes the row term from the rounded
output (rowsum(dO * out)) and its own P, so a rounding of P or dS may land
one bf16 step away from the plain version's.
"""

import numpy as np
import pytest
import torch

from simvg_tpu_torch.tools.make_synth_data import smooth_image, with_exif

from simvg_tpu_torch.ops.fused_attention import (
    attention_bwd, attention_fwd, fused_attention, fused_attention_bwd_reference,
    fused_attention_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


CASES = [
    (2, 421, 421, 12, 64, [421, 404]),  # the flagship, padded text
    (3, 13, 70, 3, 64, [70, 1, 33]),  # Sq != Sk, one live key
    (1, 200, 5, 2, 64, None),  # fewer keys than one 64-key tile
    (1, 1, 1, 1, 64, None),
    (2, 100, 100, 4, 64, [100, 61]),  # S not a multiple of 16
    (2, 64, 64, 4, 64, [64, 47]),  # exactly one 64-row tile
    # the train step's call: batch 32, padded text as the encoder sees it
    (32, 421, 421, 12, 64, [404 + (i * 5) % 18 for i in range(32)]),
]


def _inputs(gen, dtype, b, sq, sk, h, hd, lengths):
    q = (torch.randn(b, sq, h, hd, device="cuda", generator=gen)
         * hd ** -0.5).to(dtype)
    k, v = (torch.randn(b, sk, h, hd, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    dout = torch.randn(b, sq, h, hd, device="cuda", generator=gen).to(dtype)
    pad = None
    if lengths is not None:
        pad = (torch.arange(sk, device="cuda")[None]
               >= torch.tensor(lengths, device="cuda")[:, None])
    return q, k, v, dout, pad


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,sq,sk,h,hd,lengths", CASES)
def test_attention_fwd_matches_plain_version(gen, dtype, atol, b, sq, sk, h,
                                             hd, lengths):
    q, k, v, _, pad = _inputs(gen, dtype, b, sq, sk, h, hd, lengths)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,hd,lengths", CASES)
def test_attention_bwd_matches_plain_version(gen, dtype, b, sq, sk, h, hd,
                                             lengths):
    q, k, v, dout, pad = _inputs(gen, dtype, b, sq, sk, h, hd, lengths)
    out, lse = attention_fwd(q, k, v, pad, with_lse=True)
    before = attention_bwd.launches
    grads = attention_bwd(q, k, v, out, dout, lse, pad)
    torch.cuda.synchronize()
    assert attention_bwd.launches == before + 1
    _assert_grads_close(grads, fused_attention_bwd_reference(
        q, k, v, dout, pad), dtype, pad)


def _assert_grads_close(grads, refs, dtype, pad):
    for name, g, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert g.dtype == dtype and g.shape == ref.shape, name
        if dtype == torch.float32:
            torch.testing.assert_close(g, ref, atol=3e-4, rtol=1e-3,
                                       msg=name)
        else:
            err = (g.float() - ref.float()).abs().max().item()
            assert err <= 2e-2 * ref.float().abs().max().item(), (name, err)
    if pad is not None:  # padded keys get exactly zero dk and dv
        for g in grads[1:]:
            assert not g[pad].any()


@pytest.mark.parametrize("b,sq,sk,h,hd,lengths", [CASES[0], CASES[4]])
def test_attention_bf16_sharp_logits(gen, b, sq, sk, h, hd, lengths):
    """Logits of std ~8: the row max grows across key tiles, so K1 rescales
    its running sums, and P is far from uniform in K1 and K2."""
    q, k, v, dout, pad = _inputs(gen, torch.bfloat16, b, sq, sk, h, hd,
                                 lengths)
    q = (q.float() * 8).to(torch.bfloat16)
    out, lse = attention_fwd(q, k, v, pad, with_lse=True)
    grads = attention_bwd(q, k, v, out, dout, lse, pad)
    torch.cuda.synchronize()
    ref = fused_attention_reference(q, k, v, pad)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    _assert_grads_close(grads, fused_attention_bwd_reference(
        q, k, v, dout, pad), torch.bfloat16, pad)


def test_attention_bwd_is_deterministic(gen):
    """Two runs give the same bits: no atomics, no order-dependent sums."""
    q, k, v, dout, pad = _inputs(gen, torch.bfloat16, *CASES[0])
    out, lse = attention_fwd(q, k, v, pad, with_lse=True)
    first = attention_bwd(q, k, v, out, dout, lse, pad)
    second = attention_bwd(q, k, v, out, dout, lse, pad)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_autograd_function_launches_k1_once_and_k2_once(gen):
    q, k, v, dout, pad = _inputs(gen, torch.float32, 2, 37, 37, 3, 64,
                                 [37, 20])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fused_attention.launches, attention_bwd.launches)
    fused_attention(*leaves, pad).backward(dout)
    torch.cuda.synchronize()
    assert (fused_attention.launches, attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    refs = fused_attention_bwd_reference(q, k, v, dout, pad)
    for t, ref in zip(leaves, refs):
        torch.testing.assert_close(t.grad, ref, atol=3e-4, rtol=1e-3)


@pytest.mark.parametrize("hw", [(480, 640), (427, 640), (120, 160)])
def test_nvjpeg_round_trip(gen, hw):
    from simvg_tpu_torch.data.jpeg import decode, encode, jpeg_geometry

    img = torch.from_numpy(smooth_image(*hw)).cuda()
    before = (encode.launches, decode.launches)
    data = encode(img, 95)
    assert jpeg_geometry(data)[:2] == hw
    got = decode(data, "cuda")
    torch.cuda.synchronize()
    assert (encode.launches, decode.launches) == (before[0] + 1,
                                                  before[1] + 1)
    assert got.shape == img.shape and got.dtype == torch.uint8
    assert got.is_cuda
    assert (got.int() - img.int()).abs().float().mean().item() <= 2


def test_nvjpeg_grayscale_gives_three_equal_channels(gen):
    from simvg_tpu_torch.data.jpeg import decode, encode, jpeg_geometry

    gray = torch.from_numpy(smooth_image(120, 160)[..., 1].copy()).cuda()
    data = encode(gray, 95)
    assert jpeg_geometry(data).components == 1
    got = decode(data, "cuda")
    torch.cuda.synchronize()
    assert got.shape == (120, 160, 3)
    assert torch.equal(got[..., 0], got[..., 1])
    assert torch.equal(got[..., 0], got[..., 2])
    assert (got[..., 0].int() - gray.int()).abs().float().mean().item() <= 2


@pytest.mark.parametrize("orientation", range(1, 9))
def test_nvjpeg_applies_exif_orientation(gen, orientation):
    from simvg_tpu_torch.data.jpeg import decode, encode, orient

    img = torch.from_numpy(smooth_image(48, 80, orientation)).cuda()
    data = encode(img, 95)
    plain = decode(data, "cuda")
    got = decode(with_exif(data, orientation), "cuda")
    torch.cuda.synchronize()
    want = (80, 48, 3) if orientation >= 5 else (48, 80, 3)
    assert got.shape == want
    assert torch.equal(got, orient(plain, orientation))


def test_pixel_ops_on_the_card_match_the_cpu(gen):
    import random

    from simvg_tpu_torch.data import transforms as T
    from simvg_tpu_torch.data.image_ops import collate_images
    from simvg_tpu_torch.data.jpeg import decode, encode

    norm = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])
    pipe = T.Compose([T.LargeScaleJitter(out_max_size=640),
                      T.Resize((640, 640), keep_ratio=False),
                      T.Normalize(**norm), T.Pad(size_divisor=32)])
    samples, decoded = [], []
    for i in range(8):
        h, w = (480, 640) if i % 2 else (427, 640)
        data = encode(torch.from_numpy(smooth_image(h, w, i)).cuda(), 95)
        s = pipe(dict(img_bytes=data, pixel_ops=[], img_shape=(h, w, 3),
                      ori_shape=(h, w, 3), with_bbox=True,
                      gt_bbox=np.asarray([40.0, 30.0, 300.0, 200.0]),
                      aug_rng=random.Random(f"{i}/aug")))
        samples.append(s)
        decoded.append(decode(data, "cuda"))
    card = collate_images(samples, 640, "cuda", decoded)
    cpu = collate_images(samples, 640, "cpu", [d.cpu() for d in decoded])
    torch.cuda.synchronize()
    assert card.shape == cpu.shape == (8, 640, 640, 3)
    levels = torch.tensor([sum(op == "resize" for op, _ in s["pixel_ops"])
                           for s in samples], dtype=torch.float32)
    bound = (levels[:, None, None, None]
             / torch.tensor(norm["std"])[None, None, None, :] + 1e-6)
    assert ((card.cpu() - cpu).abs() <= bound).all()
    for i, s in enumerate(samples):  # the pad region stays 0
        h, w = s["img_shape"][:2]
        assert not card[i, h:].any() and not card[i, :, w:].any()
