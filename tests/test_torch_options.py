"""The SimVG options that no shipped config sets, held against simvg_tpu on
the CPU: the DETR encoder (``only_decoder=False``) and soft distillation
(``distill_type="soft"``).  The optimizers are in tests/test_torch_train.py,
the mask path in tests/test_torch_masks.py.

- the tiny model with a 2-layer DETR encoder, on JAX ``model.init``'s
  weights through ``export_simvg_full`` and a strict load: outputs within
  1e-5, and ``DetrEncoder`` alone within 1e-5 on the same inputs;
- ``soft_distill_losses`` on random inputs (L=2, B=3, Q=4): every term
  within 1e-5 relative, and the student's gradients against ``jax.grad``
  within 1e-5 of their max; on data-parallel ranks each half of the batch
  divided by the summed ``b * q`` gives terms that add up to the whole
  batch's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from util_torch_port import (jax_tiny_model, np_batch, to_jax, to_torch,
                             torch_tiny_model)

ENCODER = dict(only_decoder=False, num_encoder_layers=2)
OUT_KEYS = ("class_decoder", "bbox_decoder", "class_token", "bbox_token")


@pytest.fixture(scope="module")
def encoder_pair():
    """(JAX model, params, port model) with a 2-layer DETR encoder."""
    from simvg_tpu_torch.convert import load_jax_params

    jm = jax_tiny_model(**ENCODER)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(3), **to_jax(np_batch())))
    return jm, params, load_jax_params(torch_tiny_model(**ENCODER), params)


def test_encoder_model_matches_jax(encoder_pair):
    jm, params, tm = encoder_pair
    assert "encoder" in params["params"]["head"]
    assert len(tm.head.transformer.encoder.layers) == 2
    batch = np_batch(seed=1)
    out_j = jm.apply(params, **to_jax(batch))
    with torch.no_grad():
        out_t = tm(**to_torch(batch))
    for k in OUT_KEYS:
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_detr_encoder_alone_matches_jax(encoder_pair):
    from simvg_tpu.models.heads.detr_transformer import (
        DetrEncoder as JaxEncoder)

    _, params, tm = encoder_pair
    r = np.random.default_rng(2)
    x = r.normal(size=(3, 16, 32)).astype(np.float32)
    pos = r.normal(size=(3, 16, 32)).astype(np.float32)
    pad = np.zeros((3, 16), bool)
    pad[1, 12:] = True
    pad[2, 5:] = True
    enc = JaxEncoder(embed_dim=32, num_heads=8, feedforward_dim=2048,
                     num_layers=2)
    want = enc.apply({"params": params["params"]["head"]["encoder"]},
                     jnp.asarray(x), jnp.asarray(pos), jnp.asarray(pad))
    with torch.no_grad():
        got = tm.head.transformer.encoder(
            torch.from_numpy(x), query_pos=torch.from_numpy(pos),
            key_padding_mask=torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def _soft_inputs(seed=0, layers=2, b=3, q=4):
    r = np.random.default_rng(seed)
    sig = lambda x: (1 / (1 + np.exp(-x))).astype(np.float32)  # noqa: E731
    return (r.normal(size=(layers, b, q, 2)).astype(np.float32) * 2,
            sig(r.normal(size=(layers, b, q, 4))),
            r.normal(size=(b, q, 2)).astype(np.float32) * 2,
            sig(r.normal(size=(b, q, 4))))


def test_soft_distill_terms_and_gradients_match_jax():
    from simvg_tpu.losses.distill import soft_distill_losses as jax_soft
    from simvg_tpu_torch.losses.distill import soft_distill_losses

    s_log, s_box, t_log, t_box = _soft_inputs()
    lj = jax_soft(*(jnp.asarray(x) for x in (s_log, s_box, t_log, t_box)))
    gj = jax.grad(lambda a, c: jax_soft(a, c, jnp.asarray(t_log),
                                        jnp.asarray(t_box))["total"],
                  argnums=(0, 1))(jnp.asarray(s_log), jnp.asarray(s_box))

    ins = [torch.from_numpy(x).requires_grad_() for x in (s_log, s_box)]
    lt = soft_distill_losses(*ins, torch.from_numpy(t_log),
                             torch.from_numpy(t_box))
    assert sorted(lt) == sorted(lj)
    assert {"loss_cls_distill", "loss_bbox_distill_d0",
            "loss_iou_distill"} <= set(lt)
    for k in lj:
        np.testing.assert_allclose(float(lt[k].detach()), float(lj[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    gt = torch.autograd.grad(lt["total"], ins)
    for got, want in zip(gt, gj):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_soft_distill_teacher_is_detached():
    from simvg_tpu_torch.losses.distill import soft_distill_losses

    s_log, s_box, t_log, t_box = (torch.from_numpy(x).requires_grad_()
                                  for x in _soft_inputs(seed=1))
    total = soft_distill_losses(s_log, s_box, t_log, t_box)["total"]
    grads = torch.autograd.grad(total, (t_log, t_box), allow_unused=True)
    assert grads == (None, None)


def test_soft_distill_divides_by_the_global_batch():
    """Two data-parallel halves, each dividing by the summed ``b * q``
    (``batch_sum`` adding the other half's count): their terms add up to
    the whole batch's."""
    from simvg_tpu_torch.losses.distill import soft_distill_losses

    s_log, s_box, t_log, t_box = (torch.from_numpy(x)
                                  for x in _soft_inputs(seed=2, b=4))
    whole = soft_distill_losses(s_log, s_box, t_log, t_box)
    halves = [soft_distill_losses(
        s_log[:, sl], s_box[:, sl], t_log[sl], t_box[sl],
        batch_sum=lambda t: t * 2)  # each half holds b * q of the 2 * b * q
        for sl in (slice(0, 2), slice(2, 4))]
    for k, v in whole.items():
        np.testing.assert_allclose(float(halves[0][k] + halves[1][k]),
                                   float(v), rtol=1e-6, err_msg=k)
