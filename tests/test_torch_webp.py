"""WebP input of simvg_tpu_torch (``data/webp.py``, ``vp8.py``, ``vp8l.py``
behind ``data/image_file.py``) on the CPU, against the JAX package's own
reader, ``tools/serve.py::_decode_image`` (cv2.imdecode, IMREAD_COLOR:
libwebp).

The streams are made here from seed 0 by PIL and cv2 (lossy at quality
90, 70 and 30, at most 32 x 32 since the plain VP8 decoder is Python;
lossless at 48 x 64; with alpha, with an EXIF orientation, animated).
The port's plain route (the card's kernels and host C++ are held to it by
``chip_smoke.py``) must give the JAX reader's pixels bit for bit,
``image_geometry`` their shape, and raise a ValueError where the JAX
reader gets no image.  The card kernel's macroblock schedule is replayed
here with the plain steps on every lossy fixture of
``tests/fixtures/formats/`` (``util_image_formats.vp8_wavefront_replay``),
and the VP8L predictor kernel's row-group pipeline and branch-free
prediction on synthetic predictor transforms and on every lossless
fixture's own (``util_image_formats.vp8l_predictor_replay``).
"""

import functools
import os
import struct

import numpy as np
import pytest

import util_image_formats as U
from test_torch_image_formats import CASES, check_as_jax, jax_pixels
from simvg_tpu_torch.data import vp8, vp8l, webp
from simvg_tpu_torch.data.image_file import (decode_image, image_format,
                                             image_geometry)
from util_torch_port import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", sorted(CASES["webp"]))
def test_decodes_as_the_jax_reader(name):
    """Lossy at quality 90 and 30 (noise and smooth, an odd size), lossless
    (noise: subtract-green; smooth: predictor and cross-colour; a palette
    of 20 and of 3 colours: colour-indexing with and without pixel
    bundling), with alpha (an ALPH chunk, VP8L's own), with an EXIF
    orientation (applied, as cv2 applies it), and cv2's own encodes."""
    data = CASES["webp"][name]
    assert image_format(data) == "webp"
    check_as_jax(data)


def _riff(*chunks):
    body = b"WEBP" + b"".join(
        k + struct.pack("<I", len(p)) + p + b"\x00" * (len(p) & 1)
        for k, p in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _chunks(data):
    out, at = [], 12
    while at + 8 <= len(data):
        (n,) = struct.unpack_from("<I", data, at + 4)
        out.append((data[at:at + 4], data[at + 8:at + 8 + n]))
        at += 8 + n + (n & 1)
    return out


@pytest.mark.parametrize("lossless", [False, True])
def test_animation_first_frame_as_the_jax_reader(lossless):
    """An animated file gives its first frame: PIL's (the whole canvas)
    and one placed inside a larger canvas (transparent black around it,
    as libwebp's animation decoder draws a key frame)."""
    from PIL import Image
    import io

    frames = [Image.fromarray(U.noise(20, 28, s)[..., ::-1])
              for s in range(3)]
    b = io.BytesIO()
    frames[0].save(b, "WEBP", save_all=True, append_images=frames[1:],
                   lossless=lossless, quality=80)
    check_as_jax(b.getvalue())
    still = CASES["webp"]["lossless_noise" if lossless else "lossy_q90"]
    image = [c for c in _chunks(still) if c[0] in (b"VP8 ", b"VP8L")][0]
    w, h = (vp8l.header(image[1]) if lossless
            else vp8.frame_header(image[1]))[:2]
    cw, ch = w + 10, h + 6
    anmf = (bytes((2, 0, 0, 1, 0, 0)) + (w - 1).to_bytes(3, "little")
            + (h - 1).to_bytes(3, "little") + bytes((100, 0, 0, 0)))
    anmf += image[0] + struct.pack("<I", len(image[1])) + image[1] \
        + b"\x00" * (len(image[1]) & 1)
    vp8x = bytes((0x02, 0, 0, 0)) + (cw - 1).to_bytes(3, "little") \
        + (ch - 1).to_bytes(3, "little")
    data = _riff((b"VP8X", vp8x), (b"ANIM", bytes(6)), (b"ANMF", anmf))
    check_as_jax(data)
    got = decode_image(data, "cpu").numpy()
    assert (got[:2] == 0).all() and (got[:, :4] == 0).all()


def _broken():
    out = {}
    for name in ("lossy_q90", "lossless_smooth", "lossy_alpha",
                 "lossless_palette", "lossy_exif6"):
        data = CASES["webp"][name]
        out[f"{name}_half"] = data[:len(data) // 2]
        out[f"{name}_cut"] = data[:-10]
    lossy = CASES["webp"]["lossy_q90"]
    out["bad_start_code"] = lossy[:23] + b"\x00" + lossy[24:]
    lossless = CASES["webp"]["lossless_noise"]
    out["bad_vp8l_signature"] = lossless[:20] + b"\x00" + lossless[21:]
    frame = [c for c in _chunks(lossy) if c[0] == b"VP8 "][0][1]
    out["interframe"] = _riff((b"VP8 ", bytes((frame[0] | 1,)) + frame[1:]))
    out["canvas_mismatch"] = _riff(
        (b"VP8X", bytes(4) + (99).to_bytes(3, "little") + bytes(3)),
        (b"VP8 ", frame))
    return out


BROKEN = _broken()


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_broken_streams_raise_where_the_jax_reader_fails(name):
    data = BROKEN[name]
    assert jax_pixels(data) is None
    with pytest.raises(ValueError):
        decode_image(data, "cpu")


FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "formats")
LOSSY_FIXTURES = sorted(n for n in os.listdir(FIXTURES)
                        if n.startswith("webp_lossy"))


@functools.lru_cache(maxsize=None)
def _lossy_frame(name):
    """A lossy fixture's parsed frame and its unfiltered planes (plain)."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        fr = vp8.parse(webp.parse(f.read()).bitstream)
    return fr, vp8.reconstruct_unfiltered(fr)


@pytest.mark.parametrize("filter_type", ["coded", 0, 1])
@pytest.mark.parametrize("name", LOSSY_FIXTURES)
def test_vp8_wavefront_schedule_gives_the_plain_pixels(name, filter_type):
    """The card kernel's schedule (``csrc/vp8.cu``: diagonal t reconstructed
    from saved unfiltered edges while diagonal t - 1 is filtered in the
    frame), replayed with the plain per-macroblock steps, gives
    ``reconstruct_reference``'s pixels bit for bit on every lossy fixture:
    with the loop filter it codes (the normal one in each), forced to none
    and to the simple one.  The coded case runs each step's filters before
    its reconstructions and each diagonal bottom row first, as the kernel's
    concurrent warps may."""
    fr, planes = _lossy_frame(name)
    coded = filter_type == "coded"
    if not coded:
        fr = fr._replace(filter_type=filter_type)
    Y, U_, V = (p.copy() for p in planes)
    vp8.loop_filter(fr, Y, U_, V)
    want = vp8.to_bgr_reference(Y, U_, V, fr.width, fr.height)
    assert not coded or fr.filter_type == 2
    np.testing.assert_array_equal(U.vp8_wavefront_replay(fr, reverse=coded),
                                  want)


@pytest.mark.parametrize("label,w,h,bits,modes", U.vp8l_predictor_cases(),
                         ids=[c[0] for c in U.vp8l_predictor_cases()])
def test_vp8l_predictor_schedule_gives_the_plain_pixels(label, w, h, bits,
                                                        modes):
    """The card kernel's predictor schedule (``csrc/vp8l.cu``: a lane a
    row at lag 2, row groups handed over through rings, the prediction on
    packed words, selected without a branch) gives ``vp8l._inverse``'s
    pixels bit for bit: random residuals; random tile modes 0-15, or every
    mode in every tile position; bits 2-9; widths 1, 2, 2^bits - 1,
    2^bits + 1, 640, and 4097, 8192 and 16384 (the rings in device memory,
    past the widths shared memory holds; the two widest with every ring
    refilled); heights 1, 31, 32, 33 and one past the kernel's slots of 32
    rows."""
    res, words = U.vp8l_predictor_input(w, h, bits, modes, seed=w * 31 + h)
    t = vp8l.Transform(vp8l.PREDICTOR, w, bits, words)
    np.testing.assert_array_equal(
        U.vp8l_predictor_replay(res, w, h, bits, words),
        vp8l._inverse(t, res.copy(), h))


LOSSLESS_FIXTURES = sorted(n for n in os.listdir(FIXTURES)
                           if n.startswith("webp_lossless"))


@pytest.mark.parametrize("name", LOSSLESS_FIXTURES)
def test_vp8l_predictor_schedule_on_the_fixtures(name):
    """The same replay on each lossless fixture's own predictor transform
    (on its input: the pixels with the later transforms undone); a
    fixture without one undoes its transforms all the same."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        st = vp8l.parse(webp.parse(f.read()).bitstream)
    img = st.pixels
    for t in reversed(st.transforms):
        want = vp8l._inverse(t, img, st.height)
        if t.kind == vp8l.PREDICTOR:
            np.testing.assert_array_equal(U.vp8l_predictor_replay(
                img, t.xsize, st.height, t.bits, t.data), want)
        img = want
    assert img.shape == (st.width * st.height,)


def test_orientation_and_host_stage():
    """The EXIF orientation turns the geometry; the host stage's record:
    the frame's macroblocks, filter and quantiser steps, and VP8L's
    transforms in stream order."""
    data = CASES["webp"]["lossy_exif6"]
    f = webp.parse(data)
    assert f.orientation == 6 and not f.lossless
    geo = image_geometry(data)
    assert (geo.height, geo.width) == (f.width, f.height)
    fr = vp8.parse(f.bitstream)
    assert (fr.mb_w, fr.mb_h) == ((f.width + 15) // 16, (f.height + 15) // 16)
    assert fr.filter_type in (1, 2) and fr.info.shape == (
        fr.mb_w * fr.mb_h, vp8.INFO_COLUMNS)
    assert (fr.quant > 0).all() and fr.levels.shape[1:] == (25, 16)
    st = vp8l.parse(webp.parse(CASES["webp"]["lossless_smooth"]).bitstream)
    assert [t.kind for t in st.transforms] and all(
        t.kind in (vp8l.PREDICTOR, vp8l.CROSS_COLOR, vp8l.SUBTRACT_GREEN,
                   vp8l.COLOR_INDEXING) for t in st.transforms)
    st = vp8l.parse(webp.parse(CASES["webp"]["lossless_4colors"]).bitstream)
    t = st.transforms[-1]
    assert t.kind == vp8l.COLOR_INDEXING and t.bits == 2
    assert st.pixels.shape == (st.height * ((st.width + 3) // 4),)
