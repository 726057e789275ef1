"""PNG input of simvg_tpu_torch (``data/png.py``, ``data/image_file.py``) on
the CPU, against cv2 (libpng), which the JAX package reads images with.

The streams are written here with zlib and struct (``write_png``), so each
case picks its colour type, bit depth, filter types (every one, row by
row), palette with tRNS, Adam7 and ancillary chunks.  The plain decoder
(the CPU route; the card's kernel is held to it by ``chip_smoke.py``) must
give ``cv2.imdecode(..., IMREAD_COLOR)``'s pixels bit for bit, and raise
where libpng stops with an error.
"""

import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

from util_synth import make_refcoco_style
from simvg_tpu.config import Config as JaxConfig
from simvg_tpu.data.builder import (build_dataset_from_cfg as jax_dataset,
                                    build_loader_from_cfg as jax_loader)
from simvg_tpu_torch.config import Config
from simvg_tpu_torch.data import jpeg, png
from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                          build_loader_from_cfg)
from simvg_tpu_torch.data.image_file import (decode_image, image_format,
                                             image_geometry)
from simvg_tpu_torch.data.raw import RawPreprocessor
from util_torch_port import (PNG_BOUNDARY_CASES,
                             one_torch_thread,  # noqa: F401
                             png_boundary_stream, png_chunk, write_png)

TINY = "configs/smoke/tiny_synth.py"
STD = np.asarray([58.395, 57.12, 57.375], np.float32)
FILTERS = (0, 1, 2, 3, 4)


def _cv2(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def _exif(orientation):
    """An eXIf payload (TIFF, big-endian) whose IFD0 holds the
    orientation."""
    return (b"MM\x00\x2a" + struct.pack(">I", 8) + struct.pack(">H", 1)
            + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(">I", 0))


@pytest.mark.parametrize("color_type,bit_depth", [
    (ct, bd) for ct, depths in png._DEPTHS.items() for bd in depths])
def test_plain_decoder_matches_cv2(color_type, bit_depth):
    """Every colour type at every bit depth, plain and Adam7-interlaced,
    every filter type row by row, at a size with an empty pass (a 3 x 5
    image has no pixels in Adam7's third pass); a palette
    shorter than the indices (cv2 gives 0) with tRNS."""
    r = np.random.default_rng(color_type * 100 + bit_depth)
    ch = png._CHANNELS[color_type]
    for h, w in ((13, 11), (3, 5)):
        samples = r.integers(0, 1 << bit_depth, (h, w, ch))
        before = b""
        if color_type == 3:
            n = (1 << bit_depth) - 1 if bit_depth < 8 else 200
            before = (png_chunk(b"PLTE", r.integers(0, 256, 3 * n)
                                .astype(np.uint8).tobytes())
                      + png_chunk(b"tRNS", bytes(range(min(n, 9)))))
        for interlace in (False, True):
            data = write_png(samples, bit_depth, color_type, FILTERS,
                             interlace, before)
            want = _cv2(data)
            got = decode_image(data, "cpu")
            assert got.dtype == torch.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got.numpy(), want)
            geo = image_geometry(data)
            assert (geo.height, geo.width, geo.components) == (h, w, ch)


@pytest.mark.parametrize("case", PNG_BOUNDARY_CASES,
                         ids=[c[0] for c in PNG_BOUNDARY_CASES])
def test_plain_decoder_matches_cv2_at_the_kernel_edges(case):
    """The streams at the card kernel's edges (row groups, a block's
    groups, units a hand-over and a ring hold, every bytes-per-pixel at
    widths of 1 and 2 units, single filter types with and without Adam7),
    which ``chip_smoke.py`` holds the kernel to: the plain decoder gives
    cv2's pixels on each."""
    data = png_boundary_stream(case)
    want = _cv2(data)
    got = decode_image(data, "cpu")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_exif_orientation_as_cv2(orientation):
    """cv2 applies a PNG's eXIf orientation, before or after IDAT; a bad
    CRC drops the chunk (libpng warns), and cv2 does not rotate."""
    samples = np.random.default_rng(orientation).integers(0, 256, (6, 9, 3))
    chunk = png_chunk(b"eXIf", _exif(orientation))
    for data in (write_png(samples, chunks_before=chunk),
                 write_png(samples, chunks_after=chunk)):
        want = _cv2(data)
        np.testing.assert_array_equal(decode_image(data, "cpu").numpy(), want)
        assert image_geometry(data)[:2] == want.shape[:2]
        assert image_geometry(data).orientation == orientation
    bad = write_png(samples, chunks_before=png_chunk(
        b"eXIf", _exif(orientation), crc=1))
    np.testing.assert_array_equal(decode_image(bad, "cpu").numpy(), _cv2(bad))
    assert image_geometry(bad).orientation == 1


def test_broken_streams_raise_where_cv2_fails():
    """A truncated stream, a bad CRC on a critical chunk, an unknown
    critical chunk, a zlib stream that does not end, too little image data
    and a bad filter type raise (cv2 returns None for each); trailing bytes
    after IEND, a stream cut into several IDAT and too much data do not."""
    samples = np.random.default_rng(0).integers(0, 256, (8, 8, 3))
    good = write_png(samples, filters=FILTERS)
    ihdr_end = 8 + 25
    idat = good[ihdr_end:-12]
    raw = zlib.decompress(idat[8:-4])
    cut = zlib.compressobj()
    unfinished = cut.compress(raw) + cut.flush(zlib.Z_SYNC_FLUSH)
    bad_filter = bytearray(raw)
    bad_filter[0] = 7
    header = good[:ihdr_end]
    broken = {
        "truncated": good[:-30],
        "no IEND": good[:-12],
        "bad CRC": good[:ihdr_end - 1] + b"\x00" + good[ihdr_end:],
        "unknown critical": header + png_chunk(b"ABCD", b"x")
        + good[ihdr_end:],
        "unfinished zlib": header + png_chunk(b"IDAT", unfinished)
        + good[-12:],
        "too little": header + png_chunk(b"IDAT", zlib.compress(raw[:-5]))
        + good[-12:],
        "bad filter": header + png_chunk(b"IDAT", zlib.compress(
            bytes(bad_filter))) + good[-12:],
    }
    for name, data in broken.items():
        assert _cv2(data) is None, name
        with pytest.raises(ValueError):
            decode_image(data, "cpu")
    half = len(idat[8:-4]) // 2
    fine = {
        "after IEND": good + b"junk",
        "two IDAT": header + png_chunk(b"IDAT", idat[8:8 + half])
        + png_chunk(b"IDAT", idat[8 + half:-4]) + good[-12:],
        "too much": header + png_chunk(b"IDAT", zlib.compress(raw + raw[:30]))
        + good[-12:],
    }
    for name, data in fine.items():
        np.testing.assert_array_equal(decode_image(data, "cpu").numpy(),
                                      _cv2(data), err_msg=name)


def test_other_formats_raise_naming_them():
    """The formats cv2 reads and the port does not (JPEG 2000, AVIF,
    OpenEXR, PAM) raise naming them; BMP, GIF, WebP and TIFF, refused
    before, are read now."""
    for data, name in ((b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(8),
                        "JPEG 2000"),
                       (b"\x00\x00\x00\x1cftypavif" + bytes(8), "AVIF"),
                       (b"\x76\x2f\x31\x01" + bytes(8), "OpenEXR"),
                       (b"P7\nWIDTH 4\n", "PAM")):
        with pytest.raises(ValueError, match=f"{name} is not an image"):
            image_format(data)
        with pytest.raises(ValueError, match=name):
            decode_image(data, "cpu")
    with pytest.raises(ValueError, match="this stream is not"):
        image_geometry(b"hello")
    assert image_format(b"\xff\xd8\xff") == "jpeg"
    assert image_format(png.SIGNATURE) == "png"
    ok, bmp = cv2.imencode(".bmp", np.zeros((4, 4, 3), np.uint8))
    for data, kind in ((bmp.tobytes(), "bmp"), (b"GIF89a....", "gif"),
                       (b"RIFF\x00\x00\x00\x00WEBPVP8 ", "webp"),
                       (b"II*\x00\x08\x00", "tiff")):
        assert image_format(data) == kind


def test_cpu_routes_without_cv2(monkeypatch):
    """With cv2 absent a PNG still decodes on the CPU (no cv2 there), and
    the JPEG CPU routes raise an ImportError naming cv2 and the route."""
    samples = np.random.default_rng(1).integers(0, 256, (5, 7, 3))
    data = write_png(samples, filters=FILTERS)
    want = _cv2(data)
    ok, jpg = cv2.imencode(".jpg", want)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(decode_image(data, "cpu").numpy(), want)
    with pytest.raises(ImportError, match="cv2.*JPEG"):
        jpeg.decode(jpg.tobytes(), "cpu")
    with pytest.raises(ImportError, match="cv2.*JPEG"):
        jpeg.encode(torch.zeros(4, 4, 3, dtype=torch.uint8))


def test_raw_sample_of_a_png_equals_the_jpegs_pixels():
    """RawPreprocessor (the server's and the demo's route) on a PNG gives
    the batch that it gives on a JPEG whose cv2-decoded pixels the PNG
    holds: every key and the image, bit for bit."""
    cfg = Config.fromfile(TINY)
    pre = RawPreprocessor(cfg, device="cpu")
    pixels = np.random.default_rng(2).integers(0, 256, (50, 70, 3), np.uint8)
    ok, jpg = cv2.imencode(".jpg", pixels)
    decoded = _cv2(jpg.tobytes())
    as_png = write_png(decoded[..., ::-1], filters=FILTERS, interlace=True)
    a, b = (pre.collate([pre(d, "the red box")])
            for d in (jpg.tobytes(), as_png))
    assert a.keys() == b.keys()
    for k in a:
        if k == "meta":
            continue
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), k
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), k)


@pytest.fixture(scope="module")
def png_synth(tmp_path_factory):
    """tests/util_synth.py's refcoco-style set with every image rewritten
    in place as a PNG of its cv2-decoded pixels (the file names stay: both
    packages tell the format from the bytes)."""
    import glob
    import os

    imgdir, ann = make_refcoco_style(
        str(tmp_path_factory.mktemp("png_synth")), 4, 4)
    for i, path in enumerate(sorted(glob.glob(os.path.join(imgdir, "*")))):
        with open(path, "rb") as f:
            pixels = _cv2(f.read())
        with open(path, "wb") as f:
            f.write(write_png(pixels[..., ::-1], filters=FILTERS,
                              interlace=bool(i % 2)))
    return imgdir, ann


def test_loader_reads_a_png_dataset_as_jax(png_synth):
    """The val loader over PNG files against the JAX loader (cv2.imread)
    over the same files: every numpy key equal, the images within the one
    uint8 level of the resize (the decode is exact)."""
    imgdir, ann = png_synth
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
