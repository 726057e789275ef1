"""VGTRAugment of simvg_tpu_torch held against simvg_tpu's (cv2) on the CPU
(``simvg_tpu_torch/data/vgtr_aug.py``, ``data/image_ops.py``).

The port draws on the host and records pixel ops that ``image_ops`` replays
in OpenCV's 8-bit arithmetic.  For random images of odd sizes (upscaled and
downscaled to the canvas, and one halved exactly) and
several ``aug_rng`` seeds, covering both flip outcomes, blur and no blur,
and affine warps that reach the border fill:

- each pixel op alone lands within 1 level of its cv2 call on every pixel,
  on cv2's own input for that op (JAX's chain, step by step, on the same
  draws);
- the whole op gives JAX's box (within 1e-9) and expression exactly, and
  its pixels stay within the bound that the per-op bounds imply: each op's
  1 level times the gains of the ops after it (the colour jitter's
  b (c + |1 - c|); every other op has gain 1);
- a dataset sample whose expression says "left" is re-tokenised after the
  flip, as JAX's dataset does.
"""

import json
import random

import cv2
import numpy as np
import pytest
import torch

from util_synth import make_refcoco_style

from simvg_tpu.data import vgtr_aug as jv
from simvg_tpu.data.builder import build_dataset_from_cfg as jax_dataset
from simvg_tpu_torch.data import image_ops
from simvg_tpu_torch.data.builder import build_dataset_from_cfg
from simvg_tpu_torch.data.vgtr_aug import VGTRAugment
from util_torch_port import one_torch_thread  # noqa: F401

SIZE = 96
# (h, w): upscaled, upscaled, downscaled, halved (INTER_AREA's 2x2 blocks)
IMAGES = [(61, 83), (100, 47), (131, 173), (144, 192)]
SEEDS = range(6)
PHRASE = "the left one, not the right"


class _Replay:
    """An rng that returns recorded draws in order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def random(self):
        return self.draws.pop(0)


def _image(h, w, seed):
    """A smooth random image with sharp edges (a rectangle), so both the
    resamplers' averaging and their edges are exercised."""
    r = np.random.default_rng(seed)
    small = r.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(np.uint8)
    img = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
    img = np.clip(img.astype(int) + r.integers(-20, 21, img.shape), 0,
                  255).astype(np.uint8)
    img[h // 4:h // 2, w // 3:w // 2] = (10, 240, 30)
    return img


def _jax_chain(img, bbox, seed):
    """JAX's VGTRAugment step by step on ``aug_rng = Random(seed)``: the
    list of (input, output) images of each step, and the box and phrase."""
    rng = random.Random(seed)
    d = [rng.random() for _ in range(10)]
    steps = []
    x = img
    for fn, draws in ((jv._hsv_jitter, d[0:2]), (jv._color_jitter, d[2:4]),
                      (jv._gauss, d[4:5])):
        y = fn(x, _Replay(draws))
        steps.append((x, y))
        x = y
    y, bbox = jv._letterbox(x, bbox, SIZE)
    steps.append((x, y))
    x = y
    y, bbox = jv._random_affine(x, bbox, _Replay(d[5:9]))
    steps.append((x, y))
    x = y
    y, phrase, bbox = jv._horizontal_flip(x, PHRASE, bbox, _Replay(d[9:10]))
    steps.append((x, y))
    return steps, bbox, phrase


def _port(h, w, bbox, seed):
    s = {"img_shape": (h, w, 3), "ori_shape": (h, w, 3),
         "pad_shape": (h, w, 3), "pixel_ops": [], "expression": PHRASE,
         "gt_bbox": bbox.copy(), "aug_rng": random.Random(seed)}
    return VGTRAugment(img_size=SIZE)(s)


def _steps(ops):
    """The port's ops grouped as JAX's six steps (the letterbox is a resize
    and a border; a skipped blur or flip is an empty step)."""
    groups = [[] for _ in range(6)]
    step = {"hsv": 0, "jitter": 1, "blur": 2, "resize_area": 3, "border": 3,
            "warp": 4, "flip": 5}
    for op in ops:
        groups[step[op[0]]].append(op)
    return groups


def _gain(op):
    if op[0] == "jitter":
        b, c = op[1]
        return b * (c + abs(1 - c))
    return 1.0


def _cases():
    return [(hw, seed) for hw in IMAGES for seed in SEEDS]


@pytest.mark.parametrize("hw,seed", _cases())
def test_vgtr_ops_and_chain_match_cv2(hw, seed):
    h, w = hw
    img = _image(h, w, seed)
    bbox = np.asarray([w * 0.2, h * 0.3, w * 0.7, h * 0.9], np.float64)
    steps, jbox, jphrase = _jax_chain(img, bbox, seed)
    s = _port(h, w, bbox, seed)

    # the host's geometry and text are JAX's
    np.testing.assert_allclose(s["gt_bbox"], jbox, rtol=0, atol=1e-9)
    assert s["expression"] == jphrase
    assert tuple(s["img_shape"]) == steps[-1][1].shape == (SIZE, SIZE, 3)
    # and JAX's whole op is its chain
    whole = jv.VGTRAugment(img_size=SIZE)(
        {"img": img.copy(), "expression": PHRASE, "gt_bbox": bbox.copy(),
         "aug_rng": random.Random(seed)})
    np.testing.assert_array_equal(whole["img"], steps[-1][1])

    # each op on cv2's own input: within 1 level
    groups = _steps(s["pixel_ops"])
    for (x, want), ops in zip(steps, groups):
        got = image_ops.apply_pixel_ops(torch.from_numpy(x), ops).numpy()
        assert got.shape == want.shape, ops
        diff = np.abs(got.astype(int) - want.astype(int)).max()
        assert diff <= 1, (ops, diff)

    # the whole chain: within the bound the per-op bounds imply
    flat = [op for ops in groups for op in ops]
    bound = sum(np.prod([_gain(o) for o in flat[i + 1:]])
                for i in range(len(flat)))
    got = image_ops.apply_pixel_ops(torch.from_numpy(img), flat).numpy()
    diff = np.abs(got.astype(int) - steps[-1][1].astype(int))
    assert diff.max() <= bound, (diff.max(), bound)
    print(f"{hw} seed {seed}: bound {bound:.3f} levels, max {diff.max()}, "
          f"mean {diff.mean():.2e}")


def test_vgtr_cases_cover_flip_blur_and_fill():
    """The cases above reach both flip outcomes, blur and no blur, and
    warps whose output holds the border fill."""
    flips, blurs, fills = set(), set(), set()
    for (h, w), seed in _cases():
        bbox = np.asarray([w * 0.2, h * 0.3, w * 0.7, h * 0.9])
        kinds = [op[0] for op in _port(h, w, bbox, seed)["pixel_ops"]]
        flips.add("flip" in kinds)
        blurs.add("blur" in kinds)
        steps, _, _ = _jax_chain(_image(h, w, seed), bbox, seed)
        fills.add(bool((steps[4][1] == (124, 116, 104)).all(-1).any()))
    assert flips == blurs == {True, False} and True in fills


def test_vgtr_fill_and_matrix_helpers():
    from simvg_tpu_torch.data.vgtr_aug import (FILL_U8, invert_affine,
                                               rotation_matrix_2d)

    assert FILL_U8 == (124, 116, 104)  # cvRound, 103.5 half to even
    m = rotation_matrix_2d((48.0, 48.0), 11.3, 1.07)
    np.testing.assert_array_equal(m, cv2.getRotationMatrix2D((48.0, 48.0),
                                                             11.3, 1.07))
    np.testing.assert_allclose(invert_affine(m),
                               cv2.invertAffineTransform(m), rtol=0,
                               atol=1e-12)


@pytest.fixture(scope="module")
def left_synth(tmp_path_factory):
    """Synthetic RefCOCO data whose expressions say "left"."""
    imgdir, ann = make_refcoco_style(str(tmp_path_factory.mktemp("vgtr")),
                                     4, 2)
    with open(ann) as f:
        data = json.load(f)
    for split in data.values():
        for a in split:
            a["expressions"] = ["the box on the left side"]
    with open(ann, "w") as f:
        json.dump(data, f)
    return imgdir, ann


def test_dataset_retokenises_the_flipped_expression(left_synth):
    imgdir, ann = left_synth
    split = dict(type="RefCOCOUNC", which_set="train", imgsfile=imgdir,
                 annsfile=ann, pipeline=[
                     dict(type="LoadImageAnnotationsFromFile", max_token=20,
                          with_bbox=True, dataset="RefCOCOUNC"),
                     dict(type="VGTRAugment", img_size=64)])
    port = build_dataset_from_cfg(split)
    ref = jax_dataset(split)
    flipped = 0
    for epoch in range(3):
        port.epoch = ref.epoch = epoch
        for i in range(len(port)):
            got, want = port[i], ref[i]
            assert got["expression"] == want["expression"]
            np.testing.assert_array_equal(got["ref_expr_inds"],
                                          want["ref_expr_inds"])
            np.testing.assert_array_equal(got["text_attention_mask"],
                                          want["text_attention_mask"])
            np.testing.assert_allclose(got["gt_bbox"], want["gt_bbox"],
                                       rtol=0, atol=1e-9)
            if "right" in got["expression"]:
                flipped += 1
                ids, _ = port.tokenizer.encode("the box on the right side",
                                               20)
                np.testing.assert_array_equal(got["ref_expr_inds"], ids)
    assert flipped > 0


def test_loader_batches_with_vgtr_match_jax(left_synth):
    """The VGTR base's train pipeline at 64 px (VGTRAugment, Normalize,
    Pad) through both loaders for two epochs: every numpy key equal, the
    images within the chain's largest bound (1.875 + 6 levels: the
    jitter's gain at b = c = 1.25, and six ops after the HSV jitter) over
    std."""
    from simvg_tpu.data.builder import build_loader_from_cfg as jax_loader
    from simvg_tpu_torch.data.builder import build_loader_from_cfg

    imgdir, ann = left_synth
    std = np.asarray([58.395, 57.12, 57.375], np.float32)
    split = dict(type="RefCOCOUNC", which_set="train", imgsfile=imgdir,
                 annsfile=ann, pipeline=[
                     dict(type="LoadImageAnnotationsFromFile", max_token=20,
                          with_bbox=True, dataset="RefCOCOUNC"),
                     dict(type="VGTRAugment", img_size=64),
                     dict(type="Normalize", mean=[123.675, 116.28, 103.53],
                          std=std.tolist()),
                     dict(type="Pad", size_divisor=32)])
    cfg = {"data": {"samples_per_gpu": 2, "workers_per_gpu": 1}}
    jl = jax_loader(jax_dataset(split), cfg, train=True, canvas=64)
    tl = build_loader_from_cfg(build_dataset_from_cfg(split), cfg,
                               train=True, canvas=64, device="cpu")
    bound = (1.875 + 6) / std + 1e-6
    n = 0
    for epoch in range(2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        for a, b in zip(jl, tl):
            n += 1
            assert [m["expression"] for m in a["meta"]] == \
                [m["expression"] for m in b["meta"]]
            for k in a:
                if k not in ("meta", "image"):
                    np.testing.assert_array_equal(b[k], a[k], err_msg=k)
            diff = np.abs(b["image"].numpy() - a["image"])
            assert (diff <= bound).all(), diff.max()
    assert n == 2 * len(jl) > 0
