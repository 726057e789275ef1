"""Activation checkpointing of the encoder's layers (``BEiT3Config.remat``,
``remat_policy``; ``models/beit3.py::remat_layer``) on the CPU.

- With drop-path on (rate 0.5, so every layer draws), the gradients of a
  train-mode step with ``remat`` "full" and "dots" equal those without
  remat bit for bit: the recompute replays the forward's draws from the
  step's explicit generator (``checkpoint`` alone restores only torch's
  default generators, and the recomputed masks would differ).
- "dots" saves exactly the parameter matmuls' outputs: 12 a layer.
- With dropout off, the port's remat gradients match JAX's ``nn.remat``
  gradients within the train step's bound (tests/test_torch_train.py).
- The builder reads ``remat`` and ``remat_policy`` from a config, as the
  ViT-large configs set them.
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util_torch_port import TINY_BEIT3, TINY_HEAD, cheap_jit

from simvg_tpu.losses.criterion import normalize_targets as jax_targets
from simvg_tpu.losses.criterion import simvg_branch_losses as jax_losses
from simvg_tpu_torch.convert import export_simvg_full, load_jax_params
from simvg_tpu_torch.engine.train import train_losses
from simvg_tpu_torch.models import beit3
from simvg_tpu_torch.models.layers import set_generator
from util_torch_port import one_torch_thread  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
BLW = {"decoder": 1.0, "balanced_distill": {"token": 2.0, "distill": 1.0}}
KEYS = ("image", "text_ids", "text_padding_mask", "img_shape")
# the head's dropout off: JAX's and torch's random streams cannot match
HEAD = dict(TINY_HEAD, attn_dropout=0.0, ffn_dropout=0.0)


def _batch(b=3, img=64, t=6, seed=0):
    r = np.random.default_rng(seed)
    xy = r.uniform(4, 24, (b, 1, 2))
    wh = r.uniform(8, 24, (b, 1, 2))
    pad = np.zeros((b, t), np.int32)
    pad[:, 4:] = 1
    return dict(
        image=r.normal(size=(b, img, img, 3)).astype(np.float32),
        text_ids=r.integers(1, 80, (b, t)).astype(np.int32),
        text_padding_mask=pad,
        img_shape=np.full((b, 2), img, np.int32),
        gt_boxes=np.concatenate([xy, xy + wh], -1).astype(np.float32),
        gt_labels=np.zeros((b, 1), np.int32),
        gt_valid=np.ones((b, 1), bool))


def _port_model(**beit3_kw):
    from simvg_tpu_torch.models.heads.tgqs_head import TGQSHeadConfig
    from simvg_tpu_torch.models.model import SimVGConfig, SimVGModel

    return SimVGModel(SimVGConfig(
        beit3=beit3.BEiT3Config(**dict(TINY_BEIT3, **beit3_kw)),
        head=TGQSHeadConfig(**HEAD)))


def _grads(model, batch, seed=None):
    """The train step's loss and gradients; ``seed`` seeds the explicit
    generator that dropout and drop-path draw from."""
    if seed is not None:
        set_generator(model, torch.Generator().manual_seed(seed))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = train_losses(model, tb, tb["image"], branch_loss_weight=BLW)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss["loss_total"], params,
                                allow_unused=True)
    return loss["loss_total"].item(), {
        n: np.zeros(p.shape, np.float32) if g is None else g.numpy()
        for n, p, g in zip(names, params, grads)}


@pytest.fixture(scope="module")
def no_remat():
    torch.manual_seed(0)
    model = _port_model(drop_path_rate=0.5)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    return state, _grads(model, _batch(), seed=5)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gradients_equal_no_remat_with_drop_path(no_remat, policy,
                                                      monkeypatch):
    state, (loss, want) = no_remat
    model = _port_model(drop_path_rate=0.5, remat=True, remat_policy=policy)
    model.load_state_dict(state, strict=True)
    calls = []
    real = beit3.remat_layer

    def counted(layer, xs, pad, layer_policy, seq=None):
        calls.append(layer_policy)
        return real(layer, xs, pad, layer_policy, seq)

    monkeypatch.setattr(beit3, "remat_layer", counted)
    got_loss, got = _grads(model, _batch(), seed=5)
    assert calls == [policy] * TINY_BEIT3["num_layers"]
    assert got_loss == loss
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # another seed draws other masks: the equality is not vacuous
    _, other = _grads(model, _batch(), seed=6)
    assert any(not np.array_equal(other[n], want[n]) for n in want)


def test_dots_policy_saves_the_parameter_matmuls(monkeypatch):
    """Under "dots" the selective checkpoint saves the outputs of the 12
    multiway Linears of each layer and nothing else; "full" consults no
    policy."""
    decisions = []
    real = beit3._save_param_matmuls

    def recording(ctx, op, *args, **kwargs):
        policy = real(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decisions.append((op, policy))
        return policy

    monkeypatch.setattr(beit3, "_save_param_matmuls", recording)
    for policy in ("dots", "full"):
        decisions.clear()
        model = _port_model(drop_path_rate=0.5, remat=True,
                            remat_policy=policy)
        _grads(model, _batch(), seed=5)
        saved = [op for op, p in decisions
                 if p == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE]
        if policy == "full":
            assert not decisions
        else:
            assert len(saved) == 12 * TINY_BEIT3["num_layers"], saved
            assert set(saved) <= set(beit3._PARAM_MATMULS)


def test_remat_off_without_gradients(monkeypatch):
    """Remat applies only where a gradient is taken: an eval forward under
    no_grad runs the layers as they are."""
    model = _port_model(remat=True).eval()
    calls = []
    real = beit3.remat_layer
    monkeypatch.setattr(beit3, "remat_layer",
                        lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        model(**{k: torch.from_numpy(v) for k, v in _batch().items()
                 if k in KEYS})
    assert not calls


@pytest.fixture(scope="module")
def jax_remat():
    """JAX's nn.remat gradients of the train loss (dropout off), and the
    weights and batch they were taken on."""
    from simvg_tpu.models import SimVGConfig, SimVGModel
    from simvg_tpu.models.beit3 import BEiT3Config
    from simvg_tpu.models.heads.tgqs_head import TGQSHeadConfig

    jm = SimVGModel(SimVGConfig(beit3=BEiT3Config(**dict(TINY_BEIT3,
                                                         remat=True)),
                                head=TGQSHeadConfig(**HEAD)))
    batch = _batch(seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree.map(np.asarray, cheap_jit(jm.init)(
        jax.random.PRNGKey(0), **{k: jb[k] for k in KEYS}))

    def loss_fn(p):
        out = jm.apply(p, **{k: jb[k] for k in KEYS}, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        targets = jax_targets(jb["gt_boxes"], jb["gt_labels"],
                              jb["gt_valid"], jb["img_shape"])
        return jax_losses(out, targets, branch_loss_weight=BLW)["loss_total"]

    grads = cheap_jit(jax.grad(loss_fn))(params)
    return params, batch, export_simvg_full(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gradients_match_jax_remat(jax_remat, policy):
    """Dropout off: the port's remat gradients, under either policy,
    against JAX's nn.remat gradients of the same loss on the same weights
    (the train step's bound, 1e-5 of each tensor's max |g|)."""
    params, batch, want = jax_remat
    model = load_jax_params(_port_model(remat=True, remat_policy=policy),
                            params)
    _, got = _grads(model, batch)
    assert sorted(got) == sorted(want)
    for name in want:
        scale = max(np.abs(want[name]).max(), 1e-30)
        err = np.abs(got[name] - want[name]).max()
        assert err <= 1e-5 * scale, (name, err, scale)


def test_builder_reads_remat_from_the_vit_large_config():
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.models import build_model

    cfg = Config.fromfile(osp.join(REPO, "configs", "single", "ViT-large",
                                   "refcoco", "refcoco_onestage.py"))
    assert cfg.model.vis_enc["remat"] is True
    model, _ = build_model(cfg.model, img_size=cfg.img_size,
                           dtype=torch.bfloat16, device="meta")
    enc = model.cfg.beit3
    assert (enc.remat, enc.remat_policy) == (True, "full")
    assert (enc.num_layers, enc.embed_dim, enc.num_heads) == (24, 1024, 16)
    with pytest.raises(ValueError, match="remat_policy"):
        build_model(dict(cfg.model, vis_enc=dict(
            cfg.model.vis_enc, remat_policy="some")), device="meta")
    with pytest.raises(ValueError, match="quant"):
        build_model(dict(cfg.model, vis_enc=dict(
            cfg.model.vis_enc, quant="int4")), device="meta")
