"""simvg_tpu_torch.ops box functions and sine embeddings vs simvg_tpu.ops,
element by element (atol 1e-6, float32 on the CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import simvg_tpu.ops.boxes as jb
import simvg_tpu.ops.sine_embed as js
import simvg_tpu_torch.ops.boxes as tb
import simvg_tpu_torch.ops.sine_embed as ts
from util_torch_port import one_torch_thread  # noqa: F401


def _boxes(shape, seed):
    """Random well-formed xyxy boxes [*shape, 4]."""
    r = np.random.default_rng(seed)
    xy = r.uniform(0, 50, size=shape + (2,))
    wh = r.uniform(0.5, 30, size=shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh",
                                  "box_area"])
def test_unary_box_ops(name):
    b = _boxes((3, 5), seed=0)
    _close(getattr(tb, name)(torch.from_numpy(b)),
           getattr(jb, name)(jnp.asarray(b)))


@pytest.mark.parametrize("name", ["box_iou_pairwise",
                                  "generalized_box_iou_pairwise"])
def test_pairwise_box_ops(name):
    a, b = _boxes((2, 4), seed=1), _boxes((2, 6), seed=2)
    out_t = getattr(tb, name)(torch.from_numpy(a), torch.from_numpy(b))
    out_j = getattr(jb, name)(jnp.asarray(a), jnp.asarray(b))
    if name == "box_iou_pairwise":
        for t, j in zip(out_t, out_j):  # (iou, union)
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-6)
    else:
        _close(out_t, out_j)


def test_aligned_iou_and_clip():
    a, b = _boxes((7,), seed=3), _boxes((7,), seed=4)
    b[0] = a[0]  # one exact match
    _close(tb.box_iou_aligned(torch.from_numpy(a), torch.from_numpy(b)),
           jb.box_iou_aligned(jnp.asarray(a), jnp.asarray(b)))
    h = np.array([[30.0], [45.0]], np.float32)
    w = np.array([[20.0], [60.0]], np.float32)
    c = _boxes((2, 7), seed=5) - 10.0
    _close(tb.clip_boxes(torch.from_numpy(c), torch.from_numpy(h),
                         torch.from_numpy(w)),
           jb.clip_boxes(jnp.asarray(c), jnp.asarray(h), jnp.asarray(w)))
    _close(tb.clip_boxes(torch.from_numpy(c), 30.0, 20.0),
           jb.clip_boxes(jnp.asarray(c), 30.0, 20.0))


@pytest.mark.parametrize("num_pos_feats", [16, 128])
def test_sine_2d_from_pad_mask(num_pos_feats):
    pad = np.zeros((3, 5, 6), bool)
    pad[1, 3:, :] = True
    pad[2, :, 4:] = True
    _close(ts.sine_position_embedding_2d(torch.from_numpy(pad),
                                         num_pos_feats),
           js.sine_position_embedding_2d(jnp.asarray(pad), num_pos_feats))


@pytest.mark.parametrize("seq_len,dim", [(20, 256), (7, 32)])
def test_sine_1d_ref_int_cast_quirk(seq_len, dim):
    out = ts.sine_position_embedding_1d_ref(seq_len, dim)
    _close(out, js.sine_position_embedding_1d_ref(seq_len, dim))
    assert torch.all(out[:, 2::2] == 0) and torch.all(out[:, 3::2] == 1)
