"""simvg_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here skips where there is no CUDA device.  On a machine with an
NVIDIA Hopper GPU and nvcc, run (tests/conftest.py imports JAX, which the
port does not need, so it is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The data pipeline's card route is held here too: the PNG kernel against the
plain decoder (bit for bit; also at the unfilter kernel's edges), the VP8
kernels against the plain route on every lossy WebP fixture (its own loop
filter, none and the simple one), the VP8L and TIFF predictor kernels on
the synthetic cases of tests/util_image_formats.py, nvJPEG's encode -> decode round trip (shape
exact, mean |difference| <= 2 levels at quality 95, on smooth images), grayscale and EXIF-oriented files, and the pixel ops on the
card against the same ops on the CPU, on the same decoded pixels (1 level
per resampling; the geometry exact; VGTRAugment's ops a level an op).

The attention cases reach what chip_smoke.py's flagship shapes do not: Sq != Sk,
fewer keys than one tile, a row with one live key, S = 100 (not a
multiple of the 16-row mma fragments), S = 64 (exactly one tile), the
train step's shape, and logits scaled x8 so that later key tiles raise the
row max and the bf16 forward's online softmax rescales its sums.  The bf16
forward's ragged ends, where TMA zero-fills the rows past Sq and Sk on a
load and clips them on a store, are held at every pair of Sq, Sk in
{1, 63, 65, 421}, with K2 on its outputs; a batch row whose keys are all
padded but the first must give exactly that key's value row; two calls
give the same bits, and out is the same with the residual and without.  Forward bounds:
float32 2e-5 (tests/test_pallas_attention.py); bf16 2e-2, one bf16 step
for |out| < 4, since the kernel rounds P before normalising and the plain
version after.  Backward (K2) bounds: float32 3e-4 absolute / 1e-3
relative (tests/test_pallas_attention.py); bf16 2e-2 of each gradient's
max |value|: five bf16 steps, since K2 sums its P and dP in another order,
so a rounding of P or dS may land one bf16 step away from the plain
version's.
"""

import os

import numpy as np
import pytest
import torch

from simvg_tpu_torch.tools.make_synth_data import smooth_image, with_exif
import util_image_formats as U
from util_torch_port import PNG_BOUNDARY_CASES, png_boundary_stream

from simvg_tpu_torch.ops.fused_attention import (
    attention_bwd, attention_fwd, attention_residual_reference, fused_attention,
    fused_attention_bwd_reference, fused_attention_reference)

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
    """No head_dim is unsupported, as none is for the TPU kernel: 160
    (padded to 256), 256 and 384 (the split route) each launch K1."""
    for hd in (160, 256, 384):
        q = torch.randn(1, 8, 2, hd, device="cuda", generator=gen)
        before = fused_attention.launches
        out = fused_attention(q, q, q)
        torch.cuda.synchronize()
        assert fused_attention.launches == before + 1
        assert out.shape == q.shape and torch.isfinite(out).all()


# K1 and K2 at the other head dims: the native 32 (64-byte swizzle, N = 32
# products), 128 (two boxes a tile, two N = 64 products a slice) and 256
# (four boxes; K1 with the residual and K2 in two column chunks), the split
# route above 256 (384, 512), and head dims with no instantiation,
# zero-padded to the next (48 -> 64, 16 -> 32, 80 -> 128, 160 -> 256,
# 320 -> 384)
HD_CASES = [
    (2, 421, 421, 3, 256, [421, 404]),  # the flagship at 3 heads
    (2, 421, 421, 2, 384, [421, 404]),  # the flagship at 2 heads
    (3, 13, 70, 3, 256, [70, 1, 33]),
    (3, 13, 70, 2, 512, [70, 1, 33]),
    (2, 100, 65, 2, 384, [65, 61]),
    (2, 100, 100, 2, 160, [100, 61]),
    (1, 64, 64, 2, 320, [40]),
    (2, 421, 421, 24, 32, [421, 404]),  # the flagship at 24 heads
    (2, 421, 421, 6, 128, [421, 404]),  # the flagship at 6 heads
    (3, 13, 70, 3, 32, [70, 1, 33]),
    (3, 13, 70, 3, 128, [70, 1, 33]),
    (2, 100, 65, 4, 128, [65, 61]),  # ragged ends, one partial tile each
    (2, 100, 100, 4, 48, [100, 61]),
    (1, 65, 63, 2, 16, None),
    (1, 64, 64, 2, 80, [40]),
]


@pytest.mark.parametrize("b,sq,sk,h,hd,lengths", HD_CASES)
def test_attention_at_other_head_dims(gen, b, sq, sk, h, hd, lengths):
    """float32 and bf16 K1 (with and without the residual) and K2 at
    head_dim 32, 128 and padded ones, each held to its plain version at the
    bounds above; in bf16 out is the same bits with the residual and
    without, and out + r is at least 8x closer to float32 than out."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dout, pad = _inputs(gen, dtype, b, sq, sk, h, hd, lengths)
        before = (fused_attention.launches, attention_bwd.launches)
        out, lse, resid = attention_fwd(q, k, v, pad, grad=True)
        serve, _, _ = attention_fwd(q, k, v, pad)
        grads = attention_bwd(q, k, v, out, dout, lse, resid, pad)
        torch.cuda.synchronize()
        assert (fused_attention.launches, attention_bwd.launches) == (
            before[0] + 2, before[1] + 1)
        assert out.shape == q.shape and torch.equal(out, serve)
        ref = fused_attention_reference(q, k, v, pad)
        atol = 2e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=0)
        _assert_grads_close(grads, fused_attention_bwd_reference(
            q, k, v, dout, pad), dtype, pad)
        if dtype == torch.bfloat16:
            assert resid.shape == q.shape
            o32 = fused_attention_reference(q.float(), k.float(), v.float(),
                                            pad)
            e_out = (out.float() - o32).abs().max().item()
            e_sum = (out.float() + resid.float() - o32).abs().max().item()
            assert 8 * e_sum <= e_out, (e_sum, e_out)


@pytest.mark.parametrize("hd", [32, 48, 128, 160, 256, 384])
def test_autograd_at_other_head_dims(gen, hd):
    """bf16 through fused_attention with a graph at head_dim 32, 48 and 160
    (padded), 128, 256 and 384 (split): one K1 and one K2 launch, the
    gradients within their bounds."""
    q, k, v, dout, pad = _inputs(gen, torch.bfloat16, 2, 77, 77, 3, hd,
                                 [77, 50])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fused_attention.launches, attention_bwd.launches)
    fused_attention(*leaves, pad).backward(dout)
    torch.cuda.synchronize()
    assert (fused_attention.launches, attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    _assert_grads_close([t.grad for t in leaves],
                        fused_attention_bwd_reference(q, k, v, dout, pad),
                        torch.bfloat16, pad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,hd,lengths", CASES)
def test_attention_bwd_matches_plain_version(gen, dtype, b, sq, sk, h, hd,
                                             lengths):
    q, k, v, dout, pad = _inputs(gen, dtype, b, sq, sk, h, hd, lengths)
    out, lse, resid = attention_fwd(q, k, v, pad, grad=True)
    before = attention_bwd.launches
    grads = attention_bwd(q, k, v, out, dout, lse, resid, pad)
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


# the sequences the accepted configs launch beyond the flagship's:
# (dtype, batch, S, heads, text tokens), the text padded as the encoder
# pads it
CONFIG_SHAPES = [
    (torch.bfloat16, 32, 277, 12, 20),  # mix/ViT-base/pretrain-cocoall.py
    (torch.bfloat16, 8, 462, 12, 20),  # refcoco_onestage_672.py
    (torch.bfloat16, 4, 421, 16, 20),  # ViT-large at 640 px
    (torch.bfloat16, 4, 165, 16, 20),  # ViT-large at 384 px, 20 tokens
    (torch.bfloat16, 4, 185, 16, 40),  # refcocog_umd_384.py, 40 tokens
    (torch.float32, 4, 27, 4, 10),  # smoke/tiny_synth.py
    (torch.float32, 4, 411, 4, 10),  # smoke/converge_synth_prune_deep.py
]


@pytest.mark.parametrize("dtype,b,s,h,text", CONFIG_SHAPES)
def test_attention_at_the_config_shapes(gen, dtype, b, s, h, text):
    lengths = [s - text + 3 + (i * 5) % (text - 2) for i in range(b)]
    q, k, v, dout, pad = _inputs(gen, dtype, b, s, s, h, 64, lengths)
    out, lse, resid = attention_fwd(q, k, v, pad, grad=True)
    grads = attention_bwd(q, k, v, out, dout, lse, resid, pad)
    torch.cuda.synchronize()
    ref = fused_attention_reference(q, k, v, pad)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    _assert_grads_close(grads, fused_attention_bwd_reference(
        q, k, v, dout, pad), dtype, pad)


@pytest.mark.parametrize("b,sq,sk,h,hd,lengths", [CASES[0], CASES[4]])
def test_attention_bf16_sharp_logits(gen, b, sq, sk, h, hd, lengths):
    """Logits of std ~8: the row max grows across key tiles, so K1 rescales
    its running sums, and P is far from uniform in K1 and K2."""
    q, k, v, dout, pad = _inputs(gen, torch.bfloat16, b, sq, sk, h, hd,
                                 lengths)
    q = (q.float() * 8).to(torch.bfloat16)
    out, lse, resid = attention_fwd(q, k, v, pad, grad=True)
    grads = attention_bwd(q, k, v, out, dout, lse, resid, pad)
    torch.cuda.synchronize()
    ref = fused_attention_reference(q, k, v, pad)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    _assert_grads_close(grads, fused_attention_bwd_reference(
        q, k, v, dout, pad), torch.bfloat16, pad)


def test_attention_bwd_is_deterministic(gen):
    """Two runs give the same bits: no atomics, no order-dependent sums."""
    q, k, v, dout, pad = _inputs(gen, torch.bfloat16, *CASES[0])
    out, lse, resid = attention_fwd(q, k, v, pad, grad=True)
    first = attention_bwd(q, k, v, out, dout, lse, resid, pad)
    second = attention_bwd(q, k, v, out, dout, lse, resid, pad)
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


@pytest.mark.parametrize("b,sq,sk,h,hd,lengths", [CASES[0], CASES[1]])
def test_attention_fwd_residual_carries_the_unrounded_output(
        gen, b, sq, sk, h, hd, lengths):
    """With grad=True, bf16 K1 also writes r: out is the serving route's
    bit for bit, and out + r is at least 8x closer to the float32 output
    than out (off by its bf16 rounding), as attention_residual_reference's
    is."""
    q, k, v, _, pad = _inputs(gen, torch.bfloat16, b, sq, sk, h, hd,
                              lengths)
    out, _, resid = attention_fwd(q, k, v, pad, grad=True)
    plain_out, _, _ = attention_fwd(q, k, v, pad)
    torch.cuda.synchronize()
    assert resid.shape == q.shape and resid.dtype == torch.bfloat16
    assert torch.equal(out, plain_out)
    o32 = fused_attention_reference(q.float(), k.float(), v.float(), pad)
    e_out = (out.float() - o32).abs().max().item()
    e_sum = (out.float() + resid.float() - o32).abs().max().item()
    assert 8 * e_sum <= e_out, (e_sum, e_out)
    ref_out, ref_r = attention_residual_reference(q, k, v, pad)
    e_ref = (ref_out.float() + ref_r.float() - o32).abs().max().item()
    assert 8 * e_ref <= e_out, (e_ref, e_out)


def test_bf16_autograd_launches_k1_with_the_residual_and_k2(gen):
    """bf16 through fused_attention with a graph: one K1 launch (with the
    residual, since a gradient is wanted) and one K2 launch, the gradients
    within the bf16 bounds of the plain backward."""
    q, k, v, dout, pad = _inputs(gen, torch.bfloat16, *CASES[0])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fused_attention.launches, attention_bwd.launches)
    fused_attention(*leaves, pad).backward(dout)
    torch.cuda.synchronize()
    assert (fused_attention.launches, attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    _assert_grads_close([t.grad for t in leaves],
                        fused_attention_bwd_reference(q, k, v, dout, pad),
                        torch.bfloat16, pad)


def test_attention_bwd_raises_without_the_residual(gen):
    q, k, v, dout, pad = _inputs(gen, torch.bfloat16, 1, 64, 64, 2, 64, None)
    out, lse, _ = attention_fwd(q, k, v, pad)
    with pytest.raises(ValueError, match="residual"):
        attention_bwd(q, k, v, out, dout, lse, q.new_empty((0,)), pad)


RAGGED = [1, 63, 65, 421]


@pytest.mark.parametrize("sq", RAGGED)
@pytest.mark.parametrize("sk", RAGGED)
def test_attention_fwd_bf16_ragged_ends(gen, sq, sk):
    """bf16 K1 with and without the residual at ragged Sq and Sk: out
    within the bf16 bound of the plain version and the same bits in both
    variants, out + r closer to float32 than out, and K2's gradients from
    its lse and r within their bounds.  At Sk = 1 (P = 1) the exact dq and
    dk are 0, which no bound relative to their max can hold K2's row term
    to, so K2 is held there by dv alone."""
    q, k, v, dout, pad = _inputs(gen, torch.bfloat16, 2, sq, sk, 3, 64,
                                 [sk, max(1, sk - 7)])
    out, lse, resid = attention_fwd(q, k, v, pad, grad=True)
    serve, _, _ = attention_fwd(q, k, v, pad)
    grads = attention_bwd(q, k, v, out, dout, lse, resid, pad)
    torch.cuda.synchronize()
    ref = fused_attention_reference(q, k, v, pad)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    assert torch.equal(out, serve)
    o32 = fused_attention_reference(q.float(), k.float(), v.float(), pad)
    e_out = (out.float() - o32).abs().max().item()
    e_sum = (out.float() + resid.float() - o32).abs().max().item()
    assert 8 * e_sum <= e_out, (e_sum, e_out)
    refs = fused_attention_bwd_reference(q, k, v, dout, pad)
    if sk > 1:
        _assert_grads_close(grads, refs, torch.bfloat16, pad)
    else:
        err = (grads[2].float() - refs[2].float()).abs().max().item()
        assert err <= 2e-2 * refs[2].float().abs().max().item(), ("dv", err)


@pytest.mark.parametrize("grad", [False, True])
def test_attention_fwd_bf16_row_with_one_live_key(gen, grad):
    """Batch row 1 pads every key but the first: each of its queries gives
    exactly v[1, 0] (P = 1 on that key, exp(-1e30 - m) = 0 on the rest);
    row 0 is held to the plain version."""
    q, k, v, _, pad = _inputs(gen, torch.bfloat16, 2, 421, 421, 12, 64,
                              [421, 1])
    out, _, _ = attention_fwd(q, k, v, pad, grad=grad)
    torch.cuda.synchronize()
    assert torch.equal(out[1], v[1, :1].expand_as(out[1]))
    ref = fused_attention_reference(q, k, v, pad)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)


@pytest.mark.parametrize("b,sq,sk,h,hd,lengths", [CASES[0], CASES[6]])
def test_attention_fwd_bf16_calls_are_bit_equal(gen, b, sq, sk, h, hd,
                                                lengths):
    """Two calls give the same bits in both variants (out, lse and r), and
    out with the residual is the serving variant's out."""
    q, k, v, _, pad = _inputs(gen, torch.bfloat16, b, sq, sk, h, hd, lengths)
    first = attention_fwd(q, k, v, pad, grad=True)
    second = attention_fwd(q, k, v, pad, grad=True)
    serve = [attention_fwd(q, k, v, pad)[:2] for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert all(torch.equal(x, y) for x, y in zip(*serve))
    assert torch.equal(first[0], serve[0][0])


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


@pytest.mark.parametrize("color_type,bit_depth", [
    (0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
    (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)])
def test_png_kernel_matches_plain_version(gen, color_type, bit_depth):
    """The PNG kernel (unfilter and convert on the card) against the plain
    numpy decoder, bit for bit: every filter type row by row, plain and
    Adam7, at a size with an empty Adam7 pass and at one taller than a
    block of the wavefront (600 rows, two groups of rows)."""
    from simvg_tpu_torch.data import png
    from util_torch_port import png_chunk, write_png

    r = np.random.default_rng(color_type * 100 + bit_depth)
    ch = png._CHANNELS[color_type]
    for h, w in ((3, 5), (37, 29), (600, 9)):
        samples = r.integers(0, 1 << bit_depth, (h, w, ch))
        before = b""
        if color_type == 3:
            n = (1 << bit_depth) - 1 if bit_depth < 8 else 200
            before = png_chunk(b"PLTE", r.integers(0, 256, 3 * n)
                               .astype(np.uint8).tobytes())
        for interlace in (False, True):
            data = write_png(samples, bit_depth, color_type, (0, 1, 2, 3, 4),
                             interlace, before)
            before_launches = png.decode.launches
            got = png.decode(data, "cuda")
            torch.cuda.synchronize()
            assert png.decode.launches == before_launches + 1
            want = png.decode(data, "cpu")
            assert got.is_cuda and torch.equal(got.cpu(), want), (h, w,
                                                                  interlace)


@pytest.mark.parametrize("case", PNG_BOUNDARY_CASES,
                         ids=[c[0] for c in PNG_BOUNDARY_CASES])
def test_png_kernel_matches_plain_version_at_its_edges(gen, case):
    """The PNG kernel against the plain decoder at the unfilter kernel's
    edges: heights around a warp's 32 rows and a block's 16 row groups,
    widths of 1 and 2 units at every bytes-per-pixel, unit counts one past
    a hand-over chunk and one past the ring, single filter types with and
    without Adam7."""
    from simvg_tpu_torch.data import png

    data = png_boundary_stream(case)
    got = png.decode(data, "cuda")
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), png.decode(data, "cpu")), case[0]


FORMATS = os.path.join(os.path.dirname(__file__), "fixtures", "formats")


@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(FORMATS) if n.startswith("webp_lossy")))
def test_vp8_kernels_match_plain_version(gen, name):
    """Every lossy WebP fixture through the card's VP8 route (host C++ and
    the reconstruction and loop-filter kernel) against the plain route,
    bit for bit, with its own loop filter and forced to none (type 0) and
    to the simple filter (type 1): every fixture codes the normal one."""
    from simvg_tpu_torch.data import vp8, webp

    with open(os.path.join(FORMATS, name), "rb") as f:
        frame = webp.parse(f.read()).bitstream
    got = vp8.decode(frame, "cuda")
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), vp8.decode(frame, "cpu"))
    fr = vp8.host_stage(frame, "cuda")
    for filter_type in (0, 1):
        forced = fr._replace(filter_type=filter_type)
        got = vp8.pixel_stage(forced, "cuda")
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), vp8.pixel_stage(forced, "cpu")), \
            filter_type


@pytest.mark.parametrize("label,w,h,bits,modes", U.vp8l_predictor_cases(),
                         ids=[c[0] for c in U.vp8l_predictor_cases()])
def test_vp8l_predictor_kernel_matches_plain_version(gen, label, w, h, bits,
                                                     modes):
    """The VP8L predictor kernel (``vp8l.transform_cuda``) against
    ``vp8l._inverse`` on the synthetic transforms the CPU replay is held
    to: every mode in every tile position, bits 2-9, the edge widths and
    heights; bit for bit, alpha included."""
    from simvg_tpu_torch.data import vp8l

    res, words = U.vp8l_predictor_input(w, h, bits, modes, seed=w * 31 + h)
    t = vp8l.Transform(vp8l.PREDICTOR, w, bits, words)
    got = vp8l.transform_cuda(t, torch.from_numpy(res.view(np.int32)).cuda(),
                              h)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  vp8l._inverse(t, res.copy(), h))


@pytest.mark.parametrize("spp,bits,big_endian,count,pad",
                         U.TIFF_PREDICTOR_CASES)
def test_tiff_predictor_kernel_matches_plain_version(gen, spp, bits,
                                                     big_endian, count, pad):
    """TIFF's predictor kernels (``undo_predictor_cuda``: the register
    route and, past 8 samples a pixel, the strided one) against
    ``undo_predictor_reference`` bit for bit, padding and the bytes past
    the last segment untouched."""
    from simvg_tpu_torch.data import image_convert

    data, segments, seg_bytes = U.tiff_predictor_input(spp, bits, count, pad)
    got = image_convert.undo_predictor_cuda(data, "cuda", segments, seg_bytes,
                                            count, spp, bits, big_endian)
    torch.cuda.synchronize()
    assert got.cpu().numpy().tobytes() == \
        image_convert.undo_predictor_reference(data, segments, seg_bytes,
                                               count, spp, bits, big_endian)


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


# the BEiT-3 task heads' sequences (models/beit3_heads.py at BEiT3-base,
# batch 8): vision-only at 224 and 384 px (no padding), joint at 480 px with
# 32 question tokens, 8 of them padded, and text-only, 32 tokens (one
# partial K/V tile), padded
HEAD_SHAPES = [(197, None), (577, None),
               (933, [933 - 8 - i % 3 for i in range(8)]),
               (32, [24 - i % 5 for i in range(8)])]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,lengths", HEAD_SHAPES)
def test_attention_at_the_task_heads_shapes(gen, dtype, atol, s, lengths):
    """K1 (with the residual, as a backward wants it) and K2 against their
    plain versions at the heads' shapes."""
    q, k, v, dout, pad = _inputs(gen, dtype, 8, s, s, 12, 64, lengths)
    out = fused_attention(q, k, v, pad)
    torch.testing.assert_close(out.float(), fused_attention_reference(
        q, k, v, pad).float(), atol=atol, rtol=0)
    out, lse, resid = attention_fwd(q, k, v, pad, grad=True)
    grads = attention_bwd(q, k, v, out, dout, lse, resid, pad)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), fused_attention_reference(
        q, k, v, pad).float(), atol=atol, rtol=0)
    _assert_grads_close(grads, fused_attention_bwd_reference(
        q, k, v, dout, pad), dtype, pad)


@pytest.mark.parametrize("seed", range(4))
def test_vgtr_pixel_ops_on_the_card_match_the_cpu(gen, seed):
    """VGTRAugment's ops (data/vgtr_aug.py) on a decoded image on the card
    against the same ops on the CPU: each op's arithmetic is OpenCV's and
    the same on both, but for the colour jitter's mean (another summation
    order), so at most a level an op."""
    import random

    from simvg_tpu_torch.data.image_ops import apply_pixel_ops
    from simvg_tpu_torch.data.jpeg import decode, encode
    from simvg_tpu_torch.data.vgtr_aug import VGTRAugment

    h, w = ((480, 640), (427, 640), (640, 480), (333, 500))[seed]
    img = decode(encode(torch.from_numpy(smooth_image(h, w, seed)).cuda(),
                        95), "cuda")
    s = VGTRAugment(512)(dict(
        pixel_ops=[], img_shape=(h, w, 3), expression="the left one",
        gt_bbox=np.asarray([40.0, 30.0, 300.0, 200.0]),
        aug_rng=random.Random(seed)))
    card = apply_pixel_ops(img, s["pixel_ops"])
    cpu = apply_pixel_ops(img.cpu(), s["pixel_ops"])
    assert card.shape == cpu.shape == (512, 512, 3)
    diff = (card.cpu().int() - cpu.int()).abs().max().item()
    assert diff <= len(s["pixel_ops"]), diff


# token pruning's sequences: keep=300 (the flagship's in-envelope point,
# S = 1 + 300 + 20) and a forced keep=200 (S=221), text padded as the
# encoder pads it
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s", [(8, 321), (32, 321), (8, 221)])
def test_attention_fwd_at_the_pruned_lengths(gen, dtype, atol, b, s):
    lengths = [s - 20 + 3 + (i * 5) % 18 for i in range(b)]
    q, k, v, _, pad = _inputs(gen, dtype, b, s, s, 12, 64, lengths)
    out = fused_attention(q, k, v, pad)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), fused_attention_reference(
        q, k, v, pad).float(), atol=atol, rtol=0)


def test_attention_op_launches_k1_once_a_call(gen):
    """The operator simvg::attention_fwd, which fused_attention calls,
    launches K1 once a call and gives its output and row LSE; without a
    gradient it writes no residual."""
    q, k, v, _, pad = _inputs(gen, torch.bfloat16, 2, 321, 321, 12, 64,
                              [321, 304])
    before = fused_attention.launches
    with torch.no_grad():
        out, lse, resid = torch.ops.simvg.attention_fwd(q, k, v, pad)
        out2 = fused_attention(q, k, v, pad)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 2
    assert resid.numel() == 0
    assert torch.equal(out, out2)
    want_lse = torch.logsumexp(torch.einsum(
        "bqhd,bkhd->bhqk", q.float(), k.float()).masked_fill(
            pad[:, None, None, :], -1e30), dim=-1)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    torch.testing.assert_close(out.float(), fused_attention_reference(
        q, k, v, pad).float(), atol=2e-2, rtol=0)


def test_exported_encoder_layer_holds_and_launches_k1(gen):
    """torch.export of a one-layer bf16 encoder with attn_impl="pallas": one
    simvg::attention_fwd node in the graph, one K1 launch a call, and the
    eager forward's output bit for bit."""
    from simvg_tpu_torch.models import init_random_weights
    from simvg_tpu_torch.models.beit3 import BEiT3Config, BEiT3Encoder

    cfg = BEiT3Config(img_size=64, patch_size=16, embed_dim=128,
                      num_heads=2, ffn_dim=256, num_layers=1,
                      vocab_size=100, drop_path_rate=0.0,
                      dtype=torch.bfloat16, attn_impl="pallas")
    with torch.device("cuda"):
        enc = BEiT3Encoder(cfg)
    init_random_weights(enc, 0)
    enc.eval()
    r = np.random.default_rng(0)
    args = (torch.from_numpy(r.normal(size=(2, 64, 64, 3)).astype(
                np.float32)).cuda(),
            torch.from_numpy(r.integers(1, 100, (2, 8))).cuda(),
            torch.zeros(2, 8, dtype=torch.int64, device="cuda"))
    args[2][1, 5:] = 1
    with torch.no_grad():
        program = torch.export.export(enc, args, strict=False)
    target = torch.ops.simvg.attention_fwd.default
    assert sum(n.op == "call_function" and n.target == target
               for n in program.graph.nodes) == 1
    before = fused_attention.launches
    with torch.no_grad():
        got = program.module()(*args)
        want = enc(*args)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# the flagship's int8 products, one encoder layer (ops/quant.py): M rows of
# the vision (B x 401) and text (B x 20) segments at batch 1 and 8, (K, N)
# of q/k/v/out (768, 768), fc1 (768, 3072) and fc2 (3072, 768); and M = 12,
# which the wrapper pads to cuBLASLt's 17 rows
INT_MM_CASES = [(m, k, n) for m in (20, 401, 160, 3208)
                for k, n in ((768, 768), (768, 3072), (3072, 768))] + [
    (12, 32, 64)]


@pytest.mark.parametrize("m,k,n", INT_MM_CASES)
def test_int_mm_is_exact_at_the_flagship_shapes(gen, m, k, n):
    """torch._int_mm through ``int_mm`` on the card: int8 [M, K] x the
    transposed view of an [N, K] weight (no copy) equals the float64
    product exactly (|sum| < 2^53), one launch a call."""
    from simvg_tpu_torch.ops.quant import int_mm

    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda",
                      generator=gen)
    w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device="cuda",
                      generator=gen)
    before = int_mm.launches
    out = int_mm(a, w.t())
    torch.cuda.synchronize()
    assert int_mm.launches == before + 1
    assert out.dtype == torch.int32 and out.shape == (m, n)
    assert torch.equal(out.double(), a.double() @ w.double().t())


def test_int8_static_layer_on_the_card_matches_the_cpu(gen):
    """An int8_static Linear in float32 at the flagship's fc1 shape: the
    card's quant tensors and output equal the CPU's bit for bit (the same
    int8 operands, exact int32 sums, an elementwise float32 rescale, and
    every division by 127 a true division on both)."""
    from simvg_tpu_torch.ops.quant import Int8Linear, set_quant_collection
    from simvg_tpu_torch.ops.quant import build_quant_collection

    layer = torch.nn.Sequential(Int8Linear(768, 3072, mode="static"))
    torch.nn.init.normal_(layer[0].weight, 0.0, 0.02)
    x = torch.randn(2, 421, 768)
    set_quant_collection(layer, build_quant_collection(
        layer, {"0.act_amax": x.abs().amax() * 0.9}))
    want = layer(x)
    cpu_quant = {k: v.clone() for k, v in layer.named_buffers()}
    layer.cuda()
    set_quant_collection(layer, build_quant_collection(
        layer, {"0.act_amax": x.cuda().abs().amax() * 0.9}))
    got = layer(x.cuda())
    torch.cuda.synchronize()
    for k, v in layer.named_buffers():
        assert torch.equal(v.cpu(), cpu_quant[k]), k
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_with_k1_k2_gives_the_gradients_of_no_remat(gen, policy):
    """A two-layer bf16 flagship encoder (S=421, batch 16) with K1/K2 and
    drop-path 0.1 on the card: the
    gradients with remat equal those without bit for bit (the recompute
    replays the generator's draws and the kernels are deterministic), K1
    launches twice a layer (forward and recompute), K2 once, and the peak
    memory of the step is lower."""
    from simvg_tpu_torch.models import init_random_weights
    from simvg_tpu_torch.models.beit3 import BEiT3Config, BEiT3Encoder
    from simvg_tpu_torch.models.layers import set_generator

    def step(remat):
        cfg = BEiT3Config(img_size=640, patch_size=32, embed_dim=768,
                          num_heads=12, ffn_dim=3072, num_layers=2,
                          vocab_size=100, drop_path_rate=0.1,
                          dtype=torch.bfloat16, attn_impl="pallas",
                          remat=remat, remat_policy=policy)
        with torch.device("cuda"):
            enc = BEiT3Encoder(cfg)
        init_random_weights(enc, 0)
        enc.train()
        set_generator(enc, torch.Generator(device="cuda").manual_seed(3))
        r = np.random.default_rng(0)
        args = (torch.from_numpy(r.normal(size=(16, 640, 640, 3)).astype(
                    np.float32)).cuda(),
                torch.from_numpy(r.integers(1, 100, (16, 20))).cuda(),
                torch.zeros(16, 20, dtype=torch.int64, device="cuda"))
        args[2][:, 12:] = 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1, k2 = fused_attention.launches, attention_bwd.launches
        loss = sum((o.float() ** 2).sum() for o in enc(*args))
        grads = torch.autograd.grad(loss, list(enc.parameters()),
                                    allow_unused=True)  # mask_token
        torch.cuda.synchronize()
        return (grads, fused_attention.launches - k1,
                attention_bwd.launches - k2,
                torch.cuda.max_memory_allocated())

    want, k1, k2, peak = step(False)
    got, rk1, rk2, rpeak = step(True)
    assert (k1, k2) == (2, 2) and (rk1, rk2) == (4, 2)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    assert rpeak < peak


@pytest.mark.parametrize("optimizer_type", ["AdamW", "SGD", "RMSProp"])
def test_optimizer_updates_on_the_card_match_the_cpu(gen, optimizer_type):
    """3 updates of AdamW, SGD and RMSProp over the 3 LR groups with a
    frozen encoder layer and the clip, on the card and on the CPU from the
    same float32 parameters and gradients: within 1e-6 of each tensor's
    max."""
    from simvg_tpu_torch.engine.train_state import create_optimizer

    names = ["vis_enc.beit3.encoder.layers.0.w",
             "vis_enc.beit3.encoder.layers.1.w", "lan_enc.w", "head.w",
             "head.b"]
    shapes = [(64, 48), (4096,), (33, 7), (300, 20), (20,)]
    cpu = torch.Generator().manual_seed(1)
    params = [torch.randn(s, generator=cpu) for s in shapes]
    grads = [[torch.randn(s, generator=cpu) * scale for s in shapes]
             for scale in (0.01, 3.0, 0.1)]
    opt = create_optimizer(1e-2, 2, warmup_epochs=2, freeze_layer=1,
                           optimizer_type=optimizer_type, weight_decay=0.05)
    out = {}
    for dev in ("cuda", "cpu"):
        p = [t.to(dev, copy=True) for t in params]
        state = opt.init(p)
        for g in grads:
            opt.apply(names, p, [t.to(dev, copy=True) for t in g], state)
        out[dev] = p
    for name, a, b in zip(names, out["cuda"], out["cpu"]):
        err = (a.cpu() - b).abs().max() / b.abs().max()
        assert err <= 1e-6, (name, err.item())
