"""simvg_tpu_torch.losses held against simvg_tpu.losses on shared inputs.

Head outputs and targets are made with numpy from a seed and handed to
both packages; every key that ``set_criterion`` and
``simvg_branch_losses`` return must agree at 1e-5 relative (float32,
summation order only; the Hungarian assignments are identical,
tests/test_torch_hungarian.py).  Two shapes: the flagship's (1 query, one
target a sample, 3 decoder layers) and a GRefCOCO-like one (10 queries, up
to 3 targets a sample, an invalid slot and a label-1 no-target row).
The soft distillation route goes through the same comparison
(``distill_type="soft"``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simvg_tpu.losses import criterion as jc
from simvg_tpu_torch.losses import criterion as tc
from util_torch_port import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-7


def _head_out(r, layers, b, q, classes=2):
    def logits(n):
        return r.normal(size=(n, b, q, classes)).astype(np.float32) * 2

    def boxes(n):
        return (1 / (1 + np.exp(-r.normal(size=(n, b, q, 4))))).astype(
            np.float32)

    return {"class_decoder": logits(layers), "bbox_decoder": boxes(layers),
            "class_token": logits(1), "bbox_token": boxes(1)}


def _gt(r, b, t, grec):
    """Image-scale xyxy boxes in a 64x48 image, labels, valid."""
    xy = r.uniform(0, 30, (b, t, 2))
    wh = r.uniform(4, 30, (b, t, 2))
    gt = dict(gt_boxes=np.concatenate([xy, xy + wh], -1).astype(np.float32),
              gt_labels=np.zeros((b, t), np.int32),
              gt_valid=np.ones((b, t), bool),
              img_shape=np.tile(np.array([[48, 64]], np.int32), (b, 1)))
    if grec:
        gt["gt_valid"][0, 2] = False  # a padded slot
        gt["gt_valid"][2, 1:] = False
        gt["gt_labels"][1, 0] = 1  # a no-target row
        gt["gt_valid"][3] = False  # a sample without targets
    return gt


SHAPES = {"flagship": dict(layers=3, b=4, q=1, t=1, grec=False),
          "grec": dict(layers=3, b=4, q=10, t=3, grec=True)}


def _inputs(shape, seed):
    s = SHAPES[shape]
    r = np.random.default_rng(seed)
    out = _head_out(r, s["layers"], s["b"], s["q"])
    gt = _gt(r, s["b"], s["t"], s["grec"])
    # GRec: untruncated counts include one target past num_queries
    count = gt["gt_valid"].sum(1) + (1 if s["grec"] else 0)
    return out, gt, count.astype(np.int32)


def _targets(pkg, gt, mod):
    conv = (lambda x: jnp.asarray(x)) if pkg == "jax" else torch.from_numpy
    return mod.normalize_targets(*(conv(gt[k]) for k in (
        "gt_boxes", "gt_labels", "gt_valid", "img_shape")))


def _assert_losses(lt, lj):
    assert sorted(lt) == sorted(lj)
    for k in lj:
        np.testing.assert_allclose(float(lt[k]), float(lj[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("shape", ["flagship", "grec"])
@pytest.mark.parametrize("loss_class_type", ["ce_loss", "focal_loss",
                                             "weighted_ce_loss"])
def test_set_criterion_matches_jax(shape, loss_class_type):
    out, gt, count = _inputs(shape, seed=0)
    r = np.random.default_rng(1)
    weight = r.uniform(0.2, 1.0, gt["gt_valid"].shape).astype(np.float32)
    tj = _targets("jax", gt, jc)._replace(weight=jnp.asarray(weight))
    tt = _targets("torch", gt, tc)._replace(weight=torch.from_numpy(weight))
    kw = dict(loss_class_type=loss_class_type, dp_size=2)
    lj = jc.set_criterion(jnp.asarray(out["class_decoder"]),
                          jnp.asarray(out["bbox_decoder"]), tj,
                          gt_count=jnp.asarray(count), **kw)
    lt = tc.set_criterion(torch.from_numpy(out["class_decoder"]),
                          torch.from_numpy(out["bbox_decoder"]), tt,
                          gt_count=torch.from_numpy(count), **kw)
    _assert_losses(lt, lj)
    assert "loss_class_0" in lt and "loss_giou" in lt


BRANCHES = {
    "balanced": dict(branch_loss_weight={
        "decoder": 1.0, "balanced_distill": {"token": 2.0, "distill": 1.0}}),
    "hard_weighted": dict(branch_loss_weight={
        "decoder": 1.0, "token": 1.0, "distill": 0.5},
        distill_type="hard_weighted"),
    "hard_merge": dict(branch_loss_weight={
        "decoder": 1.0, "distill": 0.5, "merge": 0.3}, distill_type="hard"),
}


@pytest.mark.parametrize("mode", ["score_iou_weighted", "score_weighted"])
@pytest.mark.parametrize("branches,shape", [
    ("balanced", "flagship"), ("balanced", "grec"),
    ("hard_weighted", "flagship"), ("hard_weighted", "grec"),
    # merge targets need 2 x targets <= queries: GRefCOCO's shape only
    ("hard_merge", "grec"),
])
def test_simvg_branch_losses_match_jax(shape, mode, branches):
    out, gt, count = _inputs(shape, seed=2)
    kw = dict(BRANCHES[branches], prepare_target_mode=mode)
    lj = jc.simvg_branch_losses({k: jnp.asarray(v) for k, v in out.items()},
                                _targets("jax", gt, jc),
                                gt_count=jnp.asarray(count), **kw)
    before = tc.hungarian_assign.round_trips
    lt = tc.simvg_branch_losses(
        {k: torch.from_numpy(v) for k, v in out.items()},
        _targets("torch", gt, tc), gt_count=torch.from_numpy(count), **kw)
    _assert_losses(lt, lj)
    if branches == "balanced":
        # decoder, token-vs-GT, token-vs-teacher and, in score_iou_weighted
        # mode, the teacher's own match
        want = 4 if mode == "score_iou_weighted" else 3
        assert tc.hungarian_assign.round_trips == before + want


def test_no_target_rows_are_dropped_from_gt_losses():
    """A sample whose only row is label-1 contributes no box loss."""
    out, gt, _ = _inputs("flagship", seed=3)
    gt["gt_labels"][:] = 1
    lt = tc.simvg_branch_losses(
        {k: torch.from_numpy(v) for k, v in out.items()},
        _targets("torch", gt, tc), **BRANCHES["balanced"])
    assert float(lt["loss_distill_w"]) == 0.0
    assert float(lt["loss_kd"]) == 0.0


@pytest.mark.parametrize("shape", ["flagship", "grec"])
def test_soft_distill_is_not_ported(shape):
    """The soft route (named for the refusal it replaced):
    ``simvg_branch_losses(distill_type="soft")`` against JAX's, every key
    at 1e-5, in one Hungarian host round trip for the soft matching beside
    the decoder's and the token branch's."""
    out, gt, count = _inputs(shape, seed=4)
    kw = dict(branch_loss_weight={"decoder": 1.0, "token": 1.0,
                                  "distill": 0.5}, distill_type="soft")
    lj = jc.simvg_branch_losses({k: jnp.asarray(v) for k, v in out.items()},
                                _targets("jax", gt, jc),
                                gt_count=jnp.asarray(count), **kw)
    before = tc.hungarian_assign.round_trips
    lt = tc.simvg_branch_losses(
        {k: torch.from_numpy(v) for k, v in out.items()},
        _targets("torch", gt, tc), gt_count=torch.from_numpy(count), **kw)
    _assert_losses(lt, lj)
    assert float(lt["loss_kd"]) > 0
    assert tc.hungarian_assign.round_trips == before + 3
