"""The legacy losses of simvg_tpu_torch held against simvg_tpu's on the CPU
in float32 (``simvg_tpu_torch/losses/legacy.py``).

``label_smooth_ce`` (with and without weights) and ``box_loss``, with their
gradients, within 1e-6 of JAX's; ``mdetr_hungarian_match``'s assignment
JAX's and scipy's on random costs with padded targets.  Inputs are made
with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy.optimize import linear_sum_assignment

from simvg_tpu.losses import legacy as jl
from simvg_tpu_torch.losses import legacy as tl
from util_torch_port import one_torch_thread  # noqa: F401

TOL = 1e-6


def _close(got, want, what=""):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.detach().numpy().astype(np.float64) - want).max())
    assert err <= TOL * scale, (what, err)


@pytest.mark.parametrize("weighted", [False, True])
def test_label_smooth_ce_matches_jax(weighted):
    r = np.random.default_rng(0)
    logits = r.normal(size=(3, 5, 7)).astype(np.float32) * 3
    tgt = r.integers(0, 7, (3, 5)).astype(np.int32)
    w = r.uniform(0, 2, (3, 5)).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    want, want_g = jax.value_and_grad(
        lambda x: jl.label_smooth_ce(x, jnp.asarray(tgt), jw, 0.2))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = tl.label_smooth_ce(x, torch.from_numpy(tgt).long(),
                             None if w is None else torch.from_numpy(w), 0.2)
    got.backward()
    _close(got, want, "loss")
    _close(x.grad, want_g, "grad")


def _boxes(r, *shape):
    """cxcywh boxes inside the unit square."""
    return np.stack([r.uniform(0.3, 0.7, shape), r.uniform(0.3, 0.7, shape),
                     r.uniform(0.05, 0.3, shape), r.uniform(0.05, 0.3, shape)],
                    -1).astype(np.float32)


def test_box_loss_matches_jax():
    r = np.random.default_rng(1)
    pred, gt = _boxes(r, 6), _boxes(r, 6)
    gt[0] = pred[0]  # one perfect pair
    jout = jl.box_loss(jnp.asarray(pred), jnp.asarray(gt))
    want_g = jax.grad(lambda p: jl.box_loss(p, jnp.asarray(gt))[0])(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    tout = tl.box_loss(p, torch.from_numpy(gt))
    tout[0].backward()
    for name, g, w in zip(("total", "l1", "giou"), tout, jout):
        _close(g, w, name)
    _close(p.grad, want_g, "grad")


def test_mdetr_hungarian_match_is_jax_and_scipy():
    r = np.random.default_rng(3)
    b, q, t, v = 4, 6, 4, 10
    logits = r.normal(size=(b, q, v)).astype(np.float32)
    boxes, tboxes = _boxes(r, b, q), _boxes(r, b, t)
    valid = np.zeros((b, t), bool)
    for i, n in enumerate((3, 4, 1, 0)):
        valid[i, :n] = True
    pm = (r.uniform(0, 1, (b, t, v)) < 0.3).astype(np.float32)
    pm /= np.maximum(pm.sum(-1, keepdims=True), 1)
    args = (logits, boxes, tboxes, valid, pm)
    j_c4r, j_r4c = jl.mdetr_hungarian_match(*map(jnp.asarray, args))
    c4r, r4c = tl.mdetr_hungarian_match(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(c4r.numpy(), np.asarray(j_c4r))
    np.testing.assert_array_equal(r4c.numpy(), np.asarray(j_r4c))
    assert c4r.shape == (b, q) and r4c.shape == (b, t)

    # scipy on the port's own cost, valid targets only
    prob = torch.softmax(torch.from_numpy(logits), -1)
    cc = -torch.einsum("bqv,btv->bqt", prob, torch.from_numpy(pm))
    cb = (torch.from_numpy(boxes)[:, :, None] -
          torch.from_numpy(tboxes)[:, None]).abs().sum(-1)
    from simvg_tpu_torch.ops.boxes import (box_cxcywh_to_xyxy,
                                           generalized_box_iou_pairwise)
    cg = -generalized_box_iou_pairwise(
        box_cxcywh_to_xyxy(torch.from_numpy(boxes)),
        box_cxcywh_to_xyxy(torch.from_numpy(tboxes)))
    cost = (cc + 5 * cb + 2 * cg).numpy()
    for i in range(b):
        n = int(valid[i].sum())
        rows, cols = linear_sum_assignment(cost[i][:, :n])
        want = np.full(q, -1)
        want[rows] = cols
        np.testing.assert_array_equal(c4r[i].numpy(), want)
        assert (r4c[i, n:] == -1).all()
