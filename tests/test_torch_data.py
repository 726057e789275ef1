"""simvg_tpu_torch's data pipeline against simvg_tpu.data, on the CPU.

The same synthetic JPEG files (tests/util_synth.py) go through the JAX
loader (cv2 decode and resize) and the port's (header geometry on the
host, cv2 decode and torch bilinear resizes on the CPU route).  Every
numpy key of every batch must be equal, with the same sample order, over
two epochs.  The images may differ by the rounding of the resamplings:
``F.interpolate`` in float against cv2's fixed point lands at most one
uint8 level away per resampling, so 1 level on the val path (one resize)
and 2 on the jitter path (two), or that over std after Normalize, +1e-6.
"""

import cv2
import numpy as np
import pytest
import torch

from util_synth import make_refcoco_style
from simvg_tpu_torch.tools.make_synth_data import smooth_image, with_exif

from simvg_tpu.config import Config as JaxConfig
from simvg_tpu.data import transforms as jax_T
from simvg_tpu.data.builder import (build_dataset_from_cfg as jax_dataset,
                                    build_loader_from_cfg as jax_loader)
from simvg_tpu.data.spm import CONTROL, NORMAL, UNKNOWN, serialize_model_proto
from simvg_tpu.data.tokenization import build_tokenizer as jax_tokenizer
from simvg_tpu_torch.config import Config
from simvg_tpu_torch.data import transforms as T
from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                          build_loader_from_cfg)
from simvg_tpu_torch.data.image_ops import render, resize_u8
from simvg_tpu_torch.data.jpeg import decode, encode, jpeg_geometry
from simvg_tpu_torch.data.tokenization import build_tokenizer
from util_torch_port import one_torch_thread  # noqa: F401

TINY = "configs/smoke/tiny_synth.py"
STD = np.asarray([58.395, 57.12, 57.375], np.float32)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    return make_refcoco_style(str(root), 12, 6)


def _opts(synth):
    imgdir, ann = synth
    return {f"data.{s}.{k}": v for s in ("train", "val")
            for k, v in (("annsfile", ann), ("imgsfile", imgdir))}


@pytest.mark.parametrize("split,train,levels", [("val", False, 1),
                                                ("train", True, 2)])
def test_loader_batches_match_jax(synth, split, train, levels):
    jcfg = JaxConfig.fromfile(TINY)
    jcfg.merge_from_dict(_opts(synth))
    cfg = Config.fromfile(TINY)
    cfg.merge_from_dict(_opts(synth))
    jl = jax_loader(jax_dataset(jcfg.data[split], dataset_type=jcfg.dataset,
                                seed=6666),
                    jcfg, train=train, canvas=64, seed=6666)
    tl = build_loader_from_cfg(
        build_dataset_from_cfg(cfg.data[split], dataset_type=cfg.dataset,
                               seed=6666),
        cfg, train=train, canvas=64, seed=6666, device="cpu")
    assert len(jl) == len(tl) > 0
    for epoch in range(2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        n = 0
        for a, b in zip(jl, tl):
            n += 1
            assert [m["filename"] for m in a["meta"]] == \
                [m["filename"] for m in b["meta"]]
            assert [m["expression"] for m in a["meta"]] == \
                [m["expression"] for m in b["meta"]]
            for k in a:
                if k in ("meta", "image"):
                    continue
                assert b[k].dtype == a[k].dtype, k
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
            img = b["image"]
            assert img.device.type == "cpu" and img.dtype == torch.float32
            assert tuple(img.shape) == a["image"].shape
            diff = np.abs(img.numpy() - a["image"])
            assert (diff <= levels / STD + 1e-6).all(), diff.max()
        assert n == len(jl)


def test_global_rng_expression_draws_match_jax(synth):
    """``expr_sampling="global_rng"``: each sample's expression is
    ``np.random.choice`` from the global numpy stream, as JAX's
    (``simvg_tpu/data/datasets.py:184-186``); with the stream seeded alike
    and one worker, the train loaders of both packages give the same
    expressions over an epoch, and they differ from the deterministic
    draw's."""
    opts = dict(_opts(synth), **{"data.train.expr_sampling": "global_rng",
                                 "data.workers_per_gpu": 1})
    jcfg = JaxConfig.fromfile(TINY)
    jcfg.merge_from_dict(opts)
    cfg = Config.fromfile(TINY)
    cfg.merge_from_dict(opts)
    jl = jax_loader(jax_dataset(jcfg.data.train, dataset_type=jcfg.dataset,
                                seed=6666),
                    jcfg, train=True, canvas=64, seed=6666)
    tl = build_loader_from_cfg(
        build_dataset_from_cfg(cfg.data.train, dataset_type=cfg.dataset,
                               seed=6666),
        cfg, train=True, canvas=64, seed=6666, device="cpu")
    assert tl.ds.expr_sampling == "global_rng"

    def exprs(loader):
        np.random.seed(3)
        return [m["expression"] for b in loader for m in b["meta"]]

    want, got = exprs(jl), exprs(tl)
    assert got == want and len(got) >= 12
    cfg.merge_from_dict({"data.train.expr_sampling": "deterministic"})
    det = build_loader_from_cfg(
        build_dataset_from_cfg(cfg.data.train, dataset_type=cfg.dataset,
                               seed=6666),
        cfg, train=True, canvas=64, seed=6666, device="cpu")
    assert exprs(det) != got


@pytest.mark.parametrize("seed,crop_iou_thr", [
    (s, (0.5, 0.6, 0.7, 0.8, 0.9)) for s in range(12)] + [
    # no crop can reach an iou of 1.01: every upscale takes the give-up
    # path (the rescale back to the fit), a third resampling
    (s, (1.01,)) for s in range(12, 18)])
def test_jitter_geometry_and_pixels_match_jax(seed, crop_iou_thr):
    import random

    rng = np.random.default_rng(seed)
    h, w = (120, 160) if seed % 2 else (160, 110)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    x0, y0 = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
    box = np.asarray([x0, y0, x0 + rng.uniform(5, w / 2),
                      y0 + rng.uniform(5, h / 2)])
    kw = dict(out_max_size=64, crop_iou_thr=crop_iou_thr)
    jax_pipe = jax_T.Compose([jax_T.LargeScaleJitter(**kw),
                              jax_T.Resize((64, 64), keep_ratio=False)])
    pipe = T.Compose([T.LargeScaleJitter(**kw),
                      T.Resize((64, 64), keep_ratio=False)])

    def sample(**extra):
        return dict(ori_shape=img.shape, img_shape=img.shape, with_bbox=True,
                    gt_bbox=box.copy(), aug_rng=random.Random(f"{seed}/aug"),
                    **extra)

    a = jax_pipe(sample(img=img))
    b = pipe(sample(pixel_ops=[]))
    for k in ("img_shape", "scale_factor", "gt_bbox"):
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                      err_msg=k)
    n_resizes = sum(op == "resize" for op, _ in b["pixel_ops"])
    got = render(b, torch.from_numpy(img)).numpy()
    diff = np.abs(got.astype(int) - a["img"].astype(int))
    assert diff.max() <= n_resizes, (diff.max(), b["pixel_ops"])


@pytest.mark.parametrize("src,dst", [((120, 160), (64, 64)),
                                     ((427, 640), (203, 304)),
                                     ((37, 53), (64, 64)),
                                     ((64, 64), (64, 64))])
def test_resize_within_one_level_of_cv2(src, dst):
    img = np.random.default_rng(0).integers(0, 256, src + (3,), np.uint8)
    ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = resize_u8(torch.from_numpy(img), dst).numpy()
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("order", ["<", ">"])
def test_jpeg_geometry_and_orientation_match_cv2(tmp_path, orientation,
                                                 order):
    img = np.random.default_rng(orientation).integers(0, 256, (30, 50, 3),
                                                      np.uint8)
    data = with_exif(cv2.imencode(".jpg", img)[1].tobytes(), orientation,
                     order)
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
    geo = jpeg_geometry(data)
    assert (geo.height, geo.width) == ref.shape[:2]
    assert geo.orientation == orientation and geo.components == 3
    np.testing.assert_array_equal(decode(data, "cpu").numpy(), ref)


def test_grayscale_jpeg_decodes_to_three_equal_channels(tmp_path):
    gray = np.random.default_rng(1).integers(0, 256, (20, 30), np.uint8)
    data = encode(torch.from_numpy(gray))
    path = tmp_path / "g.jpg"
    path.write_bytes(data)
    ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert jpeg_geometry(data).components == 1
    got = decode(data, "cpu").numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[..., 0] == got[..., 2]).all()


def test_not_a_jpeg_raises():
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg_geometry(b"\x89PNG\r\n")


def test_make_synth_data_matches_the_jax_tool(tmp_path):
    from simvg_tpu_torch.tools.make_synth_data import main

    a_dir, a_ann = make_refcoco_style(str(tmp_path / "jax"), 3, 2)
    b_dir, b_ann = main(["--root", str(tmp_path / "port"), "--n-train", "3",
                         "--n-val", "2", "--device", "cpu"])
    assert open(a_ann).read() == open(b_ann).read()
    for name in sorted(__import__("os").listdir(a_dir)):
        assert open(f"{a_dir}/{name}", "rb").read() == \
            open(f"{b_dir}/{name}", "rb").read(), name


@pytest.fixture
def spm_file(tmp_path):
    s = "▁"
    pieces = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL),
              ("</s>", 0.0, CONTROL), (s + "the", -1.0, NORMAL),
              (s + "dog", -2.0, NORMAL), (s + "do", -3.0, NORMAL),
              ("g", -0.5, NORMAL), (s, -4.0, NORMAL), ("d", -1.0, NORMAL),
              ("o", -1.0, NORMAL), (s + "th", -5.0, NORMAL),
              ("e", -1.0, NORMAL)]
    p = tmp_path / "tiny.spm"
    p.write_bytes(serialize_model_proto(pieces))
    return str(p)


EXPRESSIONS = ["the green box", "green rectangle area", "The dog!",
               "the dogg, the-dog/thed", "a b c d e f g h i j k l m n"]


@pytest.mark.parametrize("kind", ["beit3_spm", "beit3_fallback", "simple"])
def test_tokenizer_copy_matches_jax(spm_file, kind):
    kw = {"beit3_spm": dict(spm_path=spm_file),
          "beit3_fallback": dict(spm_path="no/such/beit3.spm"),
          "simple": {}}[kind]
    name = "simple" if kind == "simple" else "beit3"
    a, b = jax_tokenizer(name, **kw), build_tokenizer(name, **kw)
    assert type(a).__name__ == type(b).__name__
    assert a.vocab_size == b.vocab_size
    for expr in EXPRESSIONS:
        for max_token in (6, 20):
            ids_a, mask_a = a.encode(expr, max_token)
            ids_b, mask_b = b.encode(expr, max_token)
            np.testing.assert_array_equal(ids_b, ids_a)
            np.testing.assert_array_equal(mask_b, mask_a)
    # an expression without tokens: the hash tokenizer raises, the spm one
    # frames an empty id list; the copy must do the same
    outcomes = []
    for tok in (a, b):
        try:
            outcomes.append([x.tolist() for x in tok.encode("", 20)])
        except RuntimeError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_unported_datasets_and_ops_raise(synth):
    """Nothing is left unported: VGTRAugment builds and gives a square
    sample (tests/test_torch_vgtr.py holds it to JAX's); with_mask builds
    (the mask path, tests/test_torch_masks.py) and, as JAX's dataset, needs
    a ``mask`` in each annotation, which the box-only synthetic data
    lacks."""
    cfg = Config.fromfile(TINY)
    cfg.merge_from_dict(_opts(synth))
    vgtr = [dict(type="LoadImageAnnotationsFromFile", with_bbox=True),
            dict(type="VGTRAugment", img_size=64)]
    ds = build_dataset_from_cfg(dict(cfg.data.val, pipeline=vgtr),
                                dataset_type=cfg.dataset)
    sample = ds[0]
    assert tuple(sample["img_shape"]) == (64, 64, 3)
    assert [op[0] for op in sample["pixel_ops"]][:2] == ["hsv", "jitter"]
    pipe = [dict(type="LoadImageAnnotationsFromFile", with_bbox=True,
                 with_mask=True)]
    ds = build_dataset_from_cfg(dict(cfg.data.val, pipeline=pipe),
                                dataset_type=cfg.dataset)
    assert ds.with_mask and ds.with_bbox
    with pytest.raises(KeyError, match="mask"):
        ds[0]


@pytest.mark.parametrize("hw", [(480, 640), (120, 160), (240, 320)])
def test_cpu_route_jpeg_round_trip_within_two_levels(hw):
    """The bound the card's nvJPEG round trip is held to
    (tests/test_torch_cuda.py), on the CPU route: shape exact, mean
    |difference| <= 2 levels at quality 95."""
    img = smooth_image(*hw)
    got = decode(encode(torch.from_numpy(img), 95), "cpu").numpy()
    assert got.shape == img.shape
    assert np.abs(got.astype(int) - img.astype(int)).mean() <= 2


def test_jpeg_divergence_saves_cv2_pixels(tmp_path):
    from simvg_tpu_torch.tools.jpeg_divergence import SETS, compare, main

    main(["save", str(tmp_path), "--n", "2", "--img-hw", "48", "64"])
    for name in SETS:
        arrays = np.load(tmp_path / name / "cv2_decoded.npz")
        assert len(arrays.files) == 2
        for fname in arrays.files:
            ref = cv2.imread(str(tmp_path / name / "images" / fname),
                             cv2.IMREAD_COLOR)
            np.testing.assert_array_equal(arrays[fname], ref)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs the card"):
            compare(str(tmp_path))
