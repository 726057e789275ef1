"""BMP, PNM/PFM, Sun raster, Radiance HDR, GIF and TIFF input of
simvg_tpu_torch (``data/{bmp,pnm,sunras,hdr,gif,tiff,lzw,image_convert}.py``
behind ``data/image_file.py``) on the CPU, against the JAX package's own
reader, ``tools/serve.py::_decode_image`` (cv2.imdecode, IMREAD_COLOR).

The streams are made here from seed 0 (``util_image_formats``: cv2, PIL
and small writers of the cases they do not write).  The port's plain
route (the CPU route; ``chip_smoke.py`` holds the card's kernels to it)
must give the JAX reader's pixels bit for bit, ``image_geometry`` their
shape, and raise a ValueError where the JAX reader gets no image.  cv2
hands a gray PFM back as [h, w] even at IMREAD_COLOR; the port gives
[h, w, 3], the gray replicated, so that case is compared replicated.
"""

import base64
import glob
import importlib.util
import os

import numpy as np
import pytest
import torch

import util_image_formats as U
from util_synth import make_refcoco_style
from simvg_tpu.config import Config as JaxConfig
from simvg_tpu.data.builder import (build_dataset_from_cfg as jax_dataset,
                                    build_loader_from_cfg as jax_loader)
from simvg_tpu_torch.config import Config
from simvg_tpu_torch.data import image_convert, lzw, tiff
from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                          build_loader_from_cfg)
from simvg_tpu_torch.data.image_file import (decode_image, image_format,
                                             image_geometry)
from simvg_tpu_torch.data.raw import RawPreprocessor
from simvg_tpu_torch.tools.serve import read_image
from util_torch_port import one_torch_thread, write_png  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "configs/smoke/tiny_synth.py"
STD = np.asarray([58.395, 57.12, 57.375], np.float32)
FORMATS = ("bmp", "pnm", "sunras", "hdr", "gif", "tiff")
CASES = {f: dict(c) for f, c in U.cases().items()}


def _jax_reader():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_serve", os.path.join(REPO, "tools", "serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._decode_image


_decode_jax = _jax_reader()


def jax_pixels(data: bytes):
    """The JAX server's decode of a stream, None where it gets no image."""
    try:
        img = _decode_jax({"image_b64": base64.b64encode(data).decode()})
    except ValueError:
        return None
    return np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img


def check_as_jax(data: bytes):
    want = jax_pixels(data)
    assert want is not None
    got = decode_image(data, "cpu")
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    geo = image_geometry(data)
    assert (geo.height, geo.width) == want.shape[:2]


@pytest.mark.parametrize("fmt,name", [(f, n) for f in FORMATS
                                      for n in CASES[f]])
def test_decodes_as_the_jax_reader(fmt, name):
    """Every case of each format: BMP at 1/4/8/16/24/32 bits, the OS/2 and
    V5 headers, RLE4/RLE8 and top-down rows; P1-P6 at maxval 255, 100 and
    65535, ASCII and binary, PFM in both byte orders and with a scale;
    Sun raster at 1/8/24/32 bits, gray or colormapped; HDR run-length
    coded, flat, and too narrow for run-length; GIF interlaced, with
    transparency, a frame inside its screen and a local palette; TIFF
    uncompressed, LZW, Deflate and PackBits, predictor 2 at 8 and 16 bits,
    gray, bilevel, min-is-white, palette, RGBA, 16 bits, planar 2, strips
    and tiles, either byte order."""
    data = CASES[fmt][name]
    assert image_format(data) == fmt
    check_as_jax(data)


def _broken():
    out = {}
    for fmt, name in (("bmp", "bgr24"), ("bmp", "rle8"), ("bmp", "pal4"),
                      ("pnm", "p6_255"), ("pnm", "p5_65535"),
                      ("pnm", "p3_255"), ("pnm", "p1"), ("pnm", "pfm_le"),
                      ("sunras", "bgr24"), ("sunras", "map8"),
                      ("hdr", "rle"), ("hdr", "flat"), ("gif", "pil"),
                      ("gif", "interlaced"), ("tiff", "lzw"),
                      ("tiff", "deflate"), ("tiff", "none"),
                      ("tiff", "tiles_deflate")):
        data = CASES[fmt][name]
        out[f"{fmt}_{name}_half"] = data[:len(data) // 2]
        out[f"{fmt}_{name}_cut"] = data[:-10]
    out["gif_no_image"] = CASES["gif"]["pil"][:13 + 768] + b"\x3b"
    return out


BROKEN = _broken()


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_broken_streams_raise_where_the_jax_reader_fails(name):
    data = BROKEN[name]
    assert jax_pixels(data) is None
    with pytest.raises(ValueError):
        decode_image(data, "cpu")


@pytest.mark.parametrize("data,names", [
    (U.sunras(U.noise(6, 8), 24, rgb=True), "RT_FORMAT_RGB"),
    (U.sunras(depth=8, rle=True, index=np.zeros((6, 8), int)),
     "RT_BYTE_ENCODED"),
    (U.tiff(np.zeros((4, 4, 1), int), photometric=1, bits=2), "2-bit"),
    (U.tiff(U.noise(6, 8, channels=1) // 16, photometric=1, bits=4),
     "4-bit samples of photometric 1"),
    (U.tiff(U.noise(6, 8, channels=1).astype(int) * 16, photometric=1,
            bits=12), "12-bit"),
    (U._pil(np.random.default_rng(0).random((6, 8), np.float32), "TIFF",
            compression="tiff_adobe_deflate", tiffinfo={317: 3}),
     "32-bit samples of format 3"),
])
def test_what_the_jax_reader_refuses_is_refused(data, names):
    """cv2 5.0.0 opens no run-length or RGB-ordered Sun raster (its header
    check tests the image type where it means the encoding), and no TIFF
    of 2-bit samples, 4-bit gray samples, 10/12/14-bit samples or float
    samples (libtiff's RGBA reader refuses those depths; the float case
    carries predictor 3); the port refuses them too, naming them."""
    assert jax_pixels(data) is None
    with pytest.raises(ValueError, match=names):
        decode_image(data, "cpu")


def test_unread_tiff_compressions_raise_naming_them():
    """JPEG-in-TIFF and CCITT are not read yet: a ValueError names each."""
    for code, name in ((7, "JPEG"), (6, "old-style JPEG"),
                       (4, "CCITT Group 4")):
        data = U.tiff(U.noise(8, 8)[..., ::-1], compression=code)
        with pytest.raises(ValueError, match=name):
            decode_image(data, "cpu")


def test_refused_formats_are_named_and_the_server_refuses_them():
    """JPEG 2000, AVIF and OpenEXR (which this cv2 cannot read either) are
    named; the port's server refuses them (400) before decoding."""
    for data, name in ((b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(8),
                        "JPEG 2000"),
                       (b"\xff\x4f\xff\x51" + bytes(8), "JPEG 2000"),
                       (b"\x00\x00\x00\x1cftypavif" + bytes(8), "AVIF"),
                       (b"\x00\x00\x00\x1cftypavis" + bytes(8), "AVIF"),
                       (b"\x76\x2f\x31\x01" + bytes(8), "OpenEXR")):
        with pytest.raises(ValueError, match=f"{name} is not an image"):
            image_format(data)
        with pytest.raises(ValueError, match=name):
            read_image({"image_b64": base64.b64encode(data).decode()})


@pytest.mark.parametrize("kind", [lzw.GIF, lzw.TIFF])
def test_lzw_round_trips(kind):
    """The LZW decoder on streams PIL writes (table growth past 12 bits'
    worth of codes and its clear codes) and on the writer's literal-only
    stream; ``limit`` cuts the output."""
    from PIL import Image
    import io

    img = U.smooth(90, 120, 3, levels=8)
    if kind == lzw.GIF:
        b = io.BytesIO()
        Image.fromarray(img[..., ::-1]).convert("P").save(b, "GIF",
                                                          interlace=False)
        from simvg_tpu_torch.data import gif
        g = gif.parse(b.getvalue())
        want = np.asarray(Image.open(io.BytesIO(b.getvalue()))).tobytes()
        got = lzw.decode_reference(g.lzw_data, lzw.GIF, g.min_code_size)
        assert got[:len(want)] == want
        idx = np.arange(300) % 5
        lit = U._gif_lzw(idx, 3)
        assert lzw.decode_reference(lit, lzw.GIF, 3) == bytes(idx.tolist())
        assert lzw.decode_reference(lit, lzw.GIF, 3, 7) == bytes(
            idx[:7].tolist())
    else:
        data = U._pil(img[..., ::-1], "TIFF", compression="tiff_lzw")
        off, count, size, rows = tiff.TiffImage(data).chunks()[0]
        got = lzw.decode_reference(data[off:off + count], lzw.TIFF)
        assert got[:size] == img[:rows, :, ::-1].tobytes()


@pytest.mark.parametrize("spp,bits,big_endian,count,pad",
                         U.TIFF_PREDICTOR_CASES)
def test_tiff_predictor_scan_gives_the_plain_bytes(spp, bits, big_endian,
                                                   count, pad):
    """TIFF's predictor 2 in the card kernel's chunked scans
    (``csrc/image_convert.cu``: runs of whole pixels a lane, warp and
    cross-warp scans, a carry from pass to pass; the strided route past
    the register route's samples) gives ``undo_predictor_reference``'s
    bytes: spp 1-5, 8 and 9, 8 and 16 bits in both byte orders, counts
    around a warp and past a pass; the padding after each segment's
    pixels and the bytes after the last segment are left as they were."""
    data, segments, seg_bytes = U.tiff_predictor_input(spp, bits, count, pad)
    want = image_convert.undo_predictor_reference(
        data, segments, seg_bytes, count, spp, bits, big_endian)
    got = U.tiff_predictor_replay(data, segments, seg_bytes, count, spp,
                                  bits, big_endian)
    assert got == want
    pixels = count * spp * (bits // 8)
    for k in range(segments):
        at = k * seg_bytes + pixels
        assert got[at:at + pad] == data[at:at + pad]
    assert got[segments * seg_bytes:] == data[segments * seg_bytes:]


def test_convert_reference_raster_options():
    """The plain converter's less common descriptions: a frame outside the
    canvas edge, planar tiles, float scale and RGBE's zero exponent."""
    data = bytes(range(16)) * 4
    r = image_convert.Raster(data, 6, 5, 8, 1, image_convert.PALETTE, 4,
                             palette=np.arange(48, dtype=np.uint8).reshape(
                                 16, 3), frame=(3, 2, 4, 4),
                             background=(9, 8, 7))
    out = image_convert.convert_reference(r)
    assert (out[:2] == (9, 8, 7)).all() and (out[:, :3] == (9, 8, 7)).all()
    np.testing.assert_array_equal(out[2, 3], [0, 1, 2])
    rgbe = bytes([128, 64, 32, 0, 128, 64, 32, 129])
    r = image_convert.Raster(rgbe, 2, 1, 8, 4, image_convert.RGBE, 8)
    np.testing.assert_array_equal(image_convert.convert_reference(r),
                                  [[[0, 0, 0], [64, 128, 255]]])


def _write_as(fmt, pixels, i):
    """A stream of ``fmt`` holding BGR ``pixels`` exactly."""
    rgb = np.ascontiguousarray(pixels[..., ::-1])
    if fmt == "webp":
        return U._pil(rgb, "WEBP", lossless=True)
    if fmt == "gif":  # a GIF holds 256 colours: the pixels' own palette
        return U._pil(rgb, "GIF")
    if fmt == "tiff":
        return U._pil(rgb, "TIFF", compression=("tiff_lzw", "packbits")[i % 2],
                      tiffinfo={317: 2} if i % 2 == 0 else {})
    return U._cv2(".bmp", pixels)


@pytest.fixture(scope="module")
def mixed_synth(tmp_path_factory):
    """tests/util_synth.py's refcoco-style set with its images rewritten in
    place as WebP (lossless), GIF, TIFF and BMP in turn (the file names
    stay: both packages tell the format from the bytes)."""
    import cv2

    imgdir, ann = make_refcoco_style(
        str(tmp_path_factory.mktemp("formats_synth")), 4, 8)
    for i, path in enumerate(sorted(glob.glob(os.path.join(imgdir, "*")))):
        pixels = cv2.imread(path, cv2.IMREAD_COLOR)
        fmt = ("webp", "gif", "tiff", "bmp")[i % 4]
        with open(path, "wb") as f:
            f.write(_write_as(fmt, pixels, i))
    return imgdir, ann


def test_loader_reads_a_mixed_format_dataset_as_jax(mixed_synth):
    """The val loader over WebP, GIF, TIFF and BMP files against the JAX
    loader (cv2.imread) over the same files: every numpy key equal, the
    images within the one uint8 level of the resize (the decode is
    exact)."""
    imgdir, ann = mixed_synth
    kinds = {image_format(open(p, "rb").read())
             for p in glob.glob(os.path.join(imgdir, "*"))}
    assert kinds == {"webp", "gif", "tiff", "bmp"}
    opts = {f"data.val.{k}": v for k, v in (("annsfile", ann),
                                            ("imgsfile", imgdir))}
    jcfg = JaxConfig.fromfile(TINY)
    jcfg.merge_from_dict(opts)
    cfg = Config.fromfile(TINY)
    cfg.merge_from_dict(opts)
    jl = jax_loader(jax_dataset(jcfg.data.val, dataset_type=jcfg.dataset,
                                seed=6666), jcfg, train=False, canvas=64,
                    seed=6666)
    tl = build_loader_from_cfg(
        build_dataset_from_cfg(cfg.data.val, dataset_type=cfg.dataset,
                               seed=6666),
        cfg, train=False, canvas=64, seed=6666, device="cpu")
    n = 0
    for a, b in zip(jl, tl):
        n += 1
        for k in a:
            if k in ("meta", "image"):
                continue
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        diff = np.abs(b["image"].numpy() - a["image"])
        assert (diff <= 1 / STD + 1e-6).all(), diff.max()
    assert n == len(jl) > 0


@pytest.mark.parametrize("fmt", ["gif", "tiff", "bmp", "pnm", "hdr"])
def test_raw_sample_equals_the_pngs(fmt):
    """RawPreprocessor (the server's and the demo's route) on a stream of
    each format gives the batch it gives on a PNG of the same decoded
    pixels: every key and the image, bit for bit."""
    pre = RawPreprocessor(Config.fromfile(TINY), device="cpu")
    data = next(iter(CASES[fmt].values()))
    pixels = jax_pixels(data)
    as_png = write_png(pixels[..., ::-1])
    a, b = (pre.collate([pre(d, "the red box")]) for d in (data, as_png))
    for k in a:
        if k == "meta":
            continue
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), k
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), k)
