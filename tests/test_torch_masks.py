"""The port's mask path held against simvg_tpu's on the CPU, where the JAX
package runs cv2.

- ``ops/rle.py``: the RLE strings byte for byte JAX's on random masks,
  ``frPyObjects`` on random polygons over COCO's [0, w] x [0, h] (a
  vertex may round to x = w or y = h), ``merge``, ``area`` and ``iou``;
  the fill of integer polygons reaching past every edge of the image
  pixel for pixel OpenCV's;
- ``SampleMaskVertices`` exactly JAX's (cv2's contours, area, moments and
  point test) with both ``center_sampling`` settings, on blobs, several
  components, holes, one-pixel, one-row and one-column masks, masks on the
  border and the empty mask;
- ``Resize``, ``Pad`` and ``LargeScaleJitter`` with masks (with boxes, and
  mask-only with the crop search's mask cover) against JAX's on the same
  seeds: the bitmaps and the RLE exactly;
- the dataset with ``with_mask`` (polygon and RLE annotations, mask-only
  and box+mask) through the multi-task and segmentation pipelines;
- ``mask_accuracy`` and ``evaluate``'s mask mIoU with an injected
  ``pred_masks`` producer against JAX's;
- the outer contours and the thickness-2 outline of ``cv2.drawContours``,
  and ``imshow_expr_mask``'s pixels within 1 level of JAX's.
"""

import copy
import json
import random

import numpy as np
import pytest
import torch

from simvg_tpu.data import transforms as JT
from simvg_tpu.ops import rle as jrle
from simvg_tpu_torch.data import transforms as TT
from simvg_tpu_torch.ops import raster
from simvg_tpu_torch.ops import rle as trle

from util_synth import make_refcoco_style
from util_torch_port import one_torch_thread  # noqa: F401


def _random_mask(r, h, w):
    m = np.zeros((h, w), np.uint8)
    for _ in range(r.integers(1, 4)):
        y0, x0 = r.integers(0, h), r.integers(0, w)
        m[y0:y0 + r.integers(1, h + 1), x0:x0 + r.integers(1, w + 1)] = 1
    if r.random() < 0.5:  # punch a hole
        y0, x0 = r.integers(0, h), r.integers(0, w)
        m[y0:y0 + 2, x0:x0 + 2] = 0
    return m


def test_rle_strings_match_jax():
    r = np.random.default_rng(0)
    masks = [np.zeros((5, 7), np.uint8), np.ones((3, 4), np.uint8),
             np.zeros((0, 3), np.uint8), (r.random((1, 9)) < .5) * 1,
             (r.random((9, 1)) < .5).astype(bool)]
    masks += [_random_mask(r, int(r.integers(1, 50)), int(r.integers(1, 50)))
              for _ in range(40)]
    masks += [(r.random((30, 40)) < 0.5).astype(np.uint8) for _ in range(5)]
    for m in masks:
        got, want = trle.encode(m), jrle.encode(m)
        assert got == want
        if m.size:
            np.testing.assert_array_equal(trle.decode(got), jrle.decode(want))
            # str counts (as in a JSON annotation) and list counts
            s = dict(want, counts=want["counts"].decode())
            np.testing.assert_array_equal(trle.decode(s), jrle.decode(s))
            assert trle.area(got) == jrle.area(want)
    pairs = [trle.encode(m) for m in masks[5:15] if m.shape == masks[5].shape]
    assert trle.merge(pairs) == jrle.merge(pairs)
    a = [trle.encode(_random_mask(r, 20, 30)) for _ in range(4)]
    b = [trle.encode(_random_mask(r, 20, 30)) for _ in range(3)]
    np.testing.assert_array_equal(trle.iou(a, b, [0, 1, 0]),
                                  jrle.iou(a, b, [0, 1, 0]))


def _polygons(r, h, w, hi_x, hi_y, n):
    out = []
    for _ in range(r.integers(1, 3)):
        k = int(r.integers(3, n))
        out.append(np.stack([r.uniform(0, hi_x, k), r.uniform(0, hi_y, k)],
                            1).ravel().tolist())
    return out


def test_polygon_rle_matches_jax():
    """frPyObjects on random polygons (convex, concave, self-crossing, one
    or two parts) with vertices anywhere in COCO's [0, w] x [0, h], so a
    rounded vertex may lie on the right or bottom edge, x = w or y = h:
    byte-equal."""
    r = np.random.default_rng(1)
    for _ in range(300):
        h, w = int(r.integers(2, 70)), int(r.integers(2, 70))
        polys = _polygons(r, h, w, w, h, 14)
        got, want = trle.frPyObjects(polys, h, w), jrle.frPyObjects(
            polys, h, w)
        assert got == want, (h, w, polys)
        assert trle.merge(got) == jrle.merge(want)


def test_fill_past_the_right_edge_differs_in_the_last_column_only():
    """``fill_poly`` on one or two integer polygons whose vertices reach
    past every edge of the image, [-w, 2w] x [-h, 2h], so edges are clipped
    on each side and some clip to a point or a horizontal run: every pixel,
    in the last column and elsewhere, is cv2.fillPoly's."""
    import cv2

    r = np.random.default_rng(2)
    for _ in range(400):
        h, w = int(r.integers(2, 70)), int(r.integers(2, 70))
        polys = [np.stack([r.integers(-w, 2 * w + 1, k),
                           r.integers(-h, 2 * h + 1, k)], 1).astype(np.int32)
                 for k in r.integers(3, 14, int(r.integers(1, 3)))]
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, polys, 1)
        got = raster.fill_poly(np.zeros((h, w), np.uint8), polys, 1)
        np.testing.assert_array_equal(got, want, err_msg=str(polys))


def _vertex_cases():
    r = np.random.default_rng(3)
    cases = []
    for i in range(12):  # random blobs, several components, holes
        cases.append(_random_mask(r, int(r.integers(8, 60)),
                                  int(r.integers(8, 60))))
    yy, xx = np.mgrid[:48, :64]
    disk = ((yy - 20) ** 2 + (xx - 30) ** 2 < 15 ** 2).astype(np.uint8)
    ring = disk.copy()
    ring[(yy - 20) ** 2 + (xx - 30) ** 2 < 6 ** 2] = 0
    two = disk.copy()
    two[40:46, 2:60] = 1
    one_px = np.zeros((10, 10), np.uint8)
    one_px[4, 6] = 1
    row = np.zeros((10, 12), np.uint8)
    row[3, 2:11] = 1
    col = np.zeros((12, 10), np.uint8)
    col[1:11, 7] = 1
    border = np.zeros((20, 30), np.uint8)
    border[:, 20:] = 1
    border[:5] = 1
    full = np.ones((9, 11), np.uint8)
    cases += [disk, ring, two, one_px, row, col, border, full,
              np.zeros((16, 16), np.uint8)]
    return cases


@pytest.mark.parametrize("center_sampling", [False, True])
def test_sample_mask_vertices_match_jax(center_sampling):
    for i, m in enumerate(_vertex_cases()):
        pad = (m.shape[0] + 3, m.shape[1] + 5, 3)
        outs = []
        for mod in (JT, TT):
            s = {"with_mask": True, "gt_mask": m.copy(), "pad_shape": pad}
            outs.append(mod.SampleMaskVertices(center_sampling, 18)(s))
        want, got = outs
        for k in ("gt_mask_vertices", "mass_center"):
            assert got[k].dtype == want[k].dtype, (i, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{i} {k}")


def _jax_sample(img, mask, bbox, with_bbox, seed):
    s = {"img": img, "ori_shape": img.shape, "img_shape": img.shape,
         "pad_shape": img.shape, "scale_factor": np.ones(4, np.float32),
         "with_bbox": with_bbox, "with_mask": True, "gt_mask": mask.copy(),
         "gt_mask_rle": jrle.encode(mask),
         "aug_rng": random.Random(f"s/{seed}")}
    if with_bbox:
        s["gt_bbox"] = bbox.copy()
    return s


def _port_sample(img, mask, bbox, with_bbox, seed):
    s = {k: v for k, v in _jax_sample(img, mask, bbox, with_bbox,
                                      seed).items() if k != "img"}
    s["pixel_ops"] = []
    return s


@pytest.mark.parametrize("with_bbox", [True, False])
def test_transforms_with_masks_match_jax(with_bbox):
    """Resize + Pad (the multi-task pipeline) and LargeScaleJitter + Pad
    (the segmentation pipeline; mask-only, its crop search takes the mask
    cover) over 12 seeds each, and LargeScaleJitter upscaled on every seed,
    once with its crop search and once giving up (an unreachable cover)."""
    r = np.random.default_rng(4)
    for seed in range(12):
        h, w = int(r.integers(40, 90)), int(r.integers(40, 90))
        img = r.integers(0, 255, (h, w, 3), np.uint8)
        mask = _random_mask(r, h, w)
        bbox = np.asarray([w * .1, h * .2, w * .6, h * .7])
        for mods in ((lambda M: [M.Resize((64, 64), keep_ratio=True),
                                 M.Pad(size_divisor=32)]),
                     (lambda M: [M.LargeScaleJitter(64, 0.3, 1.4),
                                 M.Pad(size_divisor=32)]),
                     (lambda M: [M.LargeScaleJitter(64, 1.1, 1.4)]),
                     (lambda M: [M.LargeScaleJitter(
                         64, 1.1, 1.4, min_iou_thr=1.5, crop_iou_thr=(1.5,),
                         jitter_times=3)])):
            want = JT.Compose(mods(JT))(_jax_sample(img, mask, bbox,
                                                    with_bbox, seed))
            got = TT.Compose(mods(TT))(_port_sample(img, mask, bbox,
                                                    with_bbox, seed))
            np.testing.assert_array_equal(got["gt_mask"], want["gt_mask"])
            assert got["gt_mask_rle"] == want["gt_mask_rle"]
            assert got["pad_shape"][:2] == want["pad_shape"][:2]
            if with_bbox:
                np.testing.assert_array_equal(got["gt_bbox"], want["gt_bbox"])


@pytest.fixture(scope="module")
def mask_data(tmp_path_factory):
    from simvg_tpu_torch.tools.make_synth_data import add_masks

    imgdir, ann = make_refcoco_style(str(tmp_path_factory.mktemp("m")), 4, 8)
    return imgdir, add_masks(ann)


BASES = {"multi-task": "configs/_base_/datasets/multi-task/refcoco-unc.py",
         "segmentation":
             "configs/_base_/datasets/segmentation/refcoco-unc.py"}


@pytest.mark.parametrize("base", sorted(BASES))
def test_dataset_with_masks_matches_jax(mask_data, base):
    """Every val record (polygon, two-part polygon, RLE with a hole) through
    the base's train pipeline: the mask, its RLE, is_crowd, the vertices and
    the mass centre exactly JAX's, and the collated meta's RLE."""
    import os.path as osp

    from simvg_tpu.config import Config as JConfig
    from simvg_tpu.data.builder import build_dataset_from_cfg as jbuild
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.data.builder import build_dataset_from_cfg
    from simvg_tpu_torch.data.loader import collate

    imgdir, ann = mask_data
    repo = osp.dirname(osp.dirname(osp.abspath(__file__)))
    split = dict(Config.fromfile(osp.join(repo, BASES[base])).data.train,
                 annsfile=ann, imgsfile=imgdir, which_set="val")
    jsplit = dict(JConfig.fromfile(osp.join(repo, BASES[base])).data.train,
                  annsfile=ann, imgsfile=imgdir, which_set="val")
    ds = build_dataset_from_cfg(split, normalize_on_device=True)
    jds = jbuild(jsplit, normalize_on_device=True)
    assert ds.with_mask and ds.with_bbox == (base == "multi-task")
    crowd = set()
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        for k in ("gt_mask", "gt_mask_vertices", "mass_center"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["gt_mask_rle"] == want["gt_mask_rle"]
        assert got["is_crowd"] == want["is_crowd"]
        crowd.add(got["is_crowd"])
        if base == "multi-task":
            np.testing.assert_array_equal(got["gt_bbox"], want["gt_bbox"])
    assert crowd == {0, 1}
    batch = collate([ds[0], ds[1]], 640, device="cpu",
                    decoded=[torch.zeros(s["img_shape"], dtype=torch.uint8)
                             for s in (ds[0], ds[1])])
    assert batch["meta"][1]["gt_mask_rle"] == jds[1]["gt_mask_rle"]
    assert batch["meta"][1]["is_crowd"] == 1


def test_mask_accuracy_matches_jax():
    from simvg_tpu.engine.metrics import mask_accuracy as jmask
    from simvg_tpu_torch.engine.metrics import mask_accuracy

    r = np.random.default_rng(5)
    pred = [trle.encode(_random_mask(r, 24, 32)) for _ in range(6)]
    gt = [trle.encode(_random_mask(r, 24, 32)) for _ in range(6)]
    for crowd in (None, [0, 1, 0, 0, 1, 0]):
        assert mask_accuracy(pred, gt, crowd) == jmask(pred, gt, crowd)
    assert mask_accuracy([], []) == jmask([], [])


def test_evaluate_mask_miou_matches_jax():
    """``evaluate`` with a wrapper step that adds ``pred_masks`` (RLE for
    one branch, bitmaps for the other; crowd GT; a padded row), as
    tests/test_evaluate_loop.py drives JAX's: every mask key equal."""
    from simvg_tpu.engine.evaluate import evaluate as jevaluate
    from simvg_tpu_torch.engine.evaluate import evaluate

    r = np.random.default_rng(6)
    b = 4
    gt = [_random_mask(r, 32, 32) for _ in range(b)]
    pred = [np.roll(g, k, axis=1) for k, g in enumerate(gt)]
    boxes = np.tile(np.asarray([4, 4, 20, 20], np.float32), (b, 1))
    batch = {"image": np.zeros((b, 32, 32, 3), np.float32),
             "gt_boxes": boxes[:, None] + 1, "batch_valid":
                 np.asarray([True, True, True, False]),
             "meta": [{"gt_mask_rle": trle.encode(g), "is_crowd": i % 2}
                      for i, g in enumerate(gt)]}

    def step(*args):
        return {"decoder": {"best_box": boxes, "pred_masks": pred},
                "token": {"best_box": boxes, "pred_masks":
                          [trle.encode(p) for p in pred]}}

    want = jevaluate(None, None, [batch], eval_step=step)
    got = evaluate(torch.nn.Linear(1, 1), [copy.deepcopy(batch)],
                   eval_step=lambda device_batch: {
                       k: {kk: torch.from_numpy(vv) if kk == "best_box"
                           else vv for kk, vv in v.items()}
                       for k, v in step().items()})
    keys = [k for k in want if "mask" in k] + ["miou"]
    assert len(keys) == 13
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    assert got["decoder_mask_miou"] > 0


def test_synthetic_masks_cover_the_kinds(mask_data):
    _, ann = mask_data
    with open(ann) as f:
        records = json.load(f)["val"]
    kinds = [type(a["mask"]).__name__ + str(len(a["mask"]))
             for a in records]
    assert {"list1", "list2", "dict2"} <= set(kinds)


def test_outer_contours_and_outline_match_cv2():
    """RETR_EXTERNAL + CHAIN_APPROX_SIMPLE contours and the pixels of
    ``cv2.drawContours(..., thickness=2)``: exactly cv2's."""
    import cv2

    r = np.random.default_rng(7)
    for i in range(200):
        h, w = int(r.integers(2, 50)), int(r.integers(2, 50))
        m = (r.random((h, w)) < 0.4).astype(np.uint8) if i % 4 == 0 \
            else _random_mask(r, h, w)
        want, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
        got = raster.find_contours(m, external=True, simple=True)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b[:, 0])
        drawn = np.zeros((h, w), np.uint8)
        cv2.drawContours(drawn, want, -1, 1, 2)
        np.testing.assert_array_equal(raster.contour_outline((h, w), got),
                                      drawn.astype(bool))


def test_imshow_expr_mask_matches_jax_pixels():
    """The overlay of a predicted and a GT mask (the GT at another size, so
    it is resized nearest first) within 1 level of JAX's cv2 drawing."""
    from simvg_tpu.utils.visualize import imshow_expr_mask as jshow
    from simvg_tpu_torch.utils.visualize import imshow_expr_mask

    r = np.random.default_rng(8)
    for i in range(6):
        h, w = int(r.integers(20, 70)), int(r.integers(20, 70))
        img = r.integers(0, 256, (h, w, 3), np.uint8)
        pred = trle.encode(_random_mask(r, h, w))
        gt = trle.encode(_random_mask(r, h + 5 * (i % 2), w))
        want = jshow(img, pred, "", gt)
        got = imshow_expr_mask(torch.from_numpy(img), pred, "", gt).numpy()
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
