"""simvg_tpu_torch's train step, optimizer and stochastic layers held
against simvg_tpu's.

- Optimizer: amsgrad, Adam, AdamW, SGD, RMSProp, the clip, the freeze
  mask, mu_dtype, the schedules and the EMA against ``create_optimizer`` /
  ``ema_update`` on identical gradients over 5 steps, at 1e-6; each new
  optimizer's state through a checkpoint round trip.
- Train step: the tiny config of tests/test_train_step.py (32 px, patch
  16, D=32, 4 heads, 2 layers, drop-path and head dropout 0, so that no
  random draw enters), in float32, the same weights and batch through JAX
  ``make_train_step`` and the port's: every loss term and grad_norm at
  1e-5 relative for 3 steps; every gradient, by exported name, within 1e-5
  of that tensor's max |g|; the parameters after 3 steps.  In the last
  check elements whose JAX gradient is below 1e-6 in magnitude are left
  out: Adam divides a gradient by its own running magnitude, so noise-level
  gradients (fp32 summation order) move their parameters by up to +-lr in
  either package, and a gradient near 1e-6 still carries that noise into
  its update, so the bound is 1e-5: 1% of one step's lr (1e-3).  A
  GRefCOCO-shaped variant has 10 queries, up to 3
  targets a sample, an invalid slot and a label-1 no-target row; an
  "options" variant takes the DETR encoder (``only_decoder=False``, 2
  layers), soft distillation and SGD.
- Stochastic layers: keep rate, 1/keep scaling, one drop-path mask per
  sample for both segments, and the same masks from the same seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simvg_tpu.engine import create_optimizer as jax_create_optimizer
from simvg_tpu.engine import create_train_state as jax_create_train_state
from simvg_tpu.engine import make_train_step as jax_make_train_step
from simvg_tpu.engine.train_state import ema_update as jax_ema_update
from simvg_tpu.engine.train_state import make_lr_schedule as jax_schedule
from simvg_tpu.losses.criterion import normalize_targets as jax_targets
from simvg_tpu.losses.criterion import simvg_branch_losses as jax_losses
from util_torch_port import cheap_jit, one_torch_thread  # noqa: F401
from simvg_tpu_torch.engine import train_state as ts

BLW = {"decoder": 1.0, "balanced_distill": {"token": 2.0, "distill": 1.0}}
SOFT_BLW = {"decoder": 1.0, "token": 1.0, "distill": 1.0}
TINY_BEIT3 = dict(img_size=32, patch_size=16, embed_dim=32, num_heads=4,
                  ffn_dim=64, num_layers=2, vocab_size=64,
                  drop_path_rate=0.0)
TINY_HEAD = dict(in_channels=32, embed_dim=32, num_decoder_layers=2,
                 num_tgqg_layers=1, attn_dropout=0.0, ffn_dropout=0.0)

# ---------------------------------------------------------------- optimizer

# (JAX path under "params", port state-dict name, shape)
_LEAVES = [
    (("beit3", "layers_0", "w"), "vis_enc.beit3.encoder.layers.0.w", (3, 4)),
    (("beit3", "layers_1", "w"), "vis_enc.beit3.encoder.layers.1.w", (5,)),
    (("beit3", "text_embed", "embedding"), "vis_enc.beit3.text_embed.weight",
     (6, 2)),
    (("lan_enc", "w"), "lan_enc.w", (4,)),
    (("head", "w"), "head.w", (2, 3)),
]


def _jax_tree(values):
    tree = {}
    for (path, _, _), v in zip(_LEAVES, values):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.asarray(v)
    return {"params": tree}


def _jax_leaves(tree):
    out = []
    for path, _, _ in _LEAVES:
        node = tree["params"]
        for key in path:
            node = node[key]
        out.append(np.asarray(node))
    return out


OPTIMIZERS = {
    "amsgrad_clip_freeze": dict(freeze_layer=1),
    "adam": dict(amsgrad=False, grad_norm_clip=0.0),
    "adam_mu_bf16": dict(amsgrad=False, mu_dtype="bfloat16"),
    "cosine": dict(scheduler_type="CosineAnnealingLR",
                   scheduler_kw={"T_max": 3}),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax_over_5_steps(name):
    kw = dict(lr=1e-2, steps_per_epoch=2, warmup_epochs=2, **OPTIMIZERS[name])
    r = np.random.default_rng(0)
    init = [r.normal(size=s).astype(np.float32) for _, _, s in _LEAVES]
    # gradient norms on both sides of the 0.15 clip, step by step
    grads = [[(r.normal(size=s) * scale).astype(np.float32)
              for _, _, s in _LEAVES] for scale in (0.01, 2.0, 0.02, 5.0, 1.0)]

    tx = jax_create_optimizer(**kw)
    params_j = _jax_tree(init)
    opt_j = tx.init(params_j)
    opt = ts.create_optimizer(**kw)
    names = [n for _, n, _ in _LEAVES]
    params_t = [torch.from_numpy(x.copy()) for x in init]
    state = opt.init(params_t)
    for g in grads:
        upd, opt_j = tx.update(_jax_tree(g), opt_j, params_j)
        params_j = jax.tree.map(lambda p, u: p + u, params_j, upd)
        state = opt.apply(names, params_t, [torch.from_numpy(x.copy())
                                            for x in g], state)
    assert state.count == 5
    for n, a, b in zip(names, params_t, _jax_leaves(params_j)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6,
                                   err_msg=n)
    if "freeze_layer" in kw:  # encoder layer 0 never moved
        np.testing.assert_array_equal(params_t[0].numpy(), init[0])


def test_cpu_global_norm_matches_optax_at_full_width():
    """The clip's norm over 4,194,304 float32 values, 1/2000 of them 300x
    larger: on the CPU the port's global_norm is within 1e-6 of
    optax.global_norm (float32 sums over ~1e7 values drift ~1e-3 off)."""
    import optax

    r = np.random.default_rng(8)
    x = r.normal(size=4_194_304).astype(np.float32)
    x[r.choice(x.size, x.size // 2000, replace=False)] *= 300
    y = r.normal(size=(768, 768)).astype(np.float32)
    want = float(optax.global_norm([jnp.asarray(x), jnp.asarray(y)]))
    got = ts.global_norm([torch.from_numpy(x), torch.from_numpy(y)])
    assert got.dtype == torch.float32
    assert abs(got.item() - want) <= 1e-6 * want, (got.item(), want)


@pytest.mark.parametrize("scheduler_type,scheduler_kw", [
    ("MultiStepLRWarmUp", None),
    ("CosineAnnealingLR", {"T_max": 7, "eta_min": 1e-5}),
    ("CosineAnnealingLRWarmRestarts", {"T_0": 4}),
])
def test_schedules_match_jax(scheduler_type, scheduler_kw):
    kw = dict(steps_per_epoch=3, scheduler_type=scheduler_type,
              scheduler_kw=scheduler_kw, decay_steps=(5, 8))
    ours, theirs = ts.make_lr_schedule(5e-4, **kw), jax_schedule(5e-4, **kw)
    for step in range(40):
        np.testing.assert_allclose(ours(step), float(theirs(jnp.asarray(
            step))), rtol=1e-6, err_msg=str(step))


def test_ema_matches_jax_over_5_steps():
    r = np.random.default_rng(1)
    shadow = [r.normal(size=(3, 2)).astype(np.float32)]
    ema_j, ema_t = jnp.asarray(shadow[0]), [torch.from_numpy(shadow[0])]
    step_j, step_t = jnp.zeros((), jnp.int32), 0
    for _ in range(5):
        p = r.normal(size=(3, 2)).astype(np.float32)
        ema_j, step_j = jax_ema_update(ema_j, jnp.asarray(p), step_j, 0.9)
        step_t = ts.ema_update(ema_t, [torch.from_numpy(p)], step_t, 0.9)
    assert step_t == int(step_j) == 5
    np.testing.assert_allclose(ema_t[0].numpy(), np.asarray(ema_j),
                               rtol=0, atol=1e-6)


OTHER_OPTIMIZERS = {
    # amsgrad=True is given and ignored, as JAX's create_optimizer does
    "AdamW": dict(weight_decay=0.05, amsgrad=True),
    "SGD": dict(weight_decay=0.05),  # optax.sgd takes no weight decay
    "RMSProp": dict(eps=1e-3),  # optax's eps=1e-8, not the config's
}


def _run_optimizer(opt, names, params, grads, state=None):
    state = opt.init(params) if state is None else state
    for g in grads:
        state = opt.apply(names, params, [torch.from_numpy(x.copy())
                                          for x in g], state)
    return state


@pytest.mark.parametrize("optimizer_type", ["SGD", "RMSProp", "AdamW"])
def test_sgd_is_not_ported(optimizer_type):
    """AdamW, SGD and RMSProp (named for the refusal they replaced) against
    JAX's ``create_optimizer`` (optax) over 5 steps on the 3 LR groups, with
    ``freeze_layer``, the clip on both sides of its bound and the warm-up
    schedule: every parameter within 1e-6, the frozen layer unmoved."""
    kw = dict(lr=1e-2, steps_per_epoch=2, warmup_epochs=2, freeze_layer=1,
              optimizer_type=optimizer_type,
              **OTHER_OPTIMIZERS[optimizer_type])
    r = np.random.default_rng(3)
    init = [r.normal(size=s).astype(np.float32) for _, _, s in _LEAVES]
    grads = [[(r.normal(size=s) * scale).astype(np.float32)
              for _, _, s in _LEAVES] for scale in (0.01, 2.0, 0.02, 5.0, 1.0)]
    tx = jax_create_optimizer(**kw)
    params_j = _jax_tree(init)
    opt_j = tx.init(params_j)
    for g in grads:
        upd, opt_j = tx.update(_jax_tree(g), opt_j, params_j)
        params_j = jax.tree.map(lambda p, u: p + u, params_j, upd)
    opt = ts.create_optimizer(**kw)
    names = [n for _, n, _ in _LEAVES]
    params_t = [torch.from_numpy(x.copy()) for x in init]
    state = _run_optimizer(opt, names, params_t, grads)
    assert state.count == 5
    for n, a, b in zip(names, params_t, _jax_leaves(params_j)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6,
                                   err_msg=n)
    np.testing.assert_array_equal(params_t[0].numpy(), init[0])


@pytest.mark.parametrize("optimizer_type", ["SGD", "RMSProp", "AdamW"])
def test_optimizer_state_round_trips_a_checkpoint(optimizer_type, tmp_path):
    """3 steps, a save of the optimizer state under optax's names and a
    load into a fresh state, 2 more steps: bit for bit the run without the
    round trip."""
    from simvg_tpu_torch.utils.checkpoint import (load_opt_state,
                                                  opt_state_to_dict)

    want = {"AdamW": {"mu", "nu"}, "SGD": {"trace"},
            "RMSProp": {"nu", "trace"}}[optimizer_type]
    opt = ts.create_optimizer(1e-2, 2, optimizer_type=optimizer_type,
                              **OTHER_OPTIMIZERS[optimizer_type])
    r = np.random.default_rng(4)
    init = [r.normal(size=s).astype(np.float32) for _, _, s in _LEAVES]
    grads = [[r.normal(size=s).astype(np.float32) for _, _, s in _LEAVES]
             for _ in range(5)]
    names = [n for _, n, _ in _LEAVES]
    straight = [torch.from_numpy(x.copy()) for x in init]
    _run_optimizer(opt, names, straight, grads)
    resumed = [torch.from_numpy(x.copy()) for x in init]
    state = _run_optimizer(opt, names, resumed, grads[:3])
    saved = opt_state_to_dict(names, state)
    assert set(saved) == want | {"count"}
    torch.save(saved, tmp_path / "opt_state")
    fresh = load_opt_state(names, torch.load(tmp_path / "opt_state"),
                           opt.init(resumed))
    assert fresh.count == 3
    _run_optimizer(opt, names, resumed, grads[3:], fresh)
    for n, a, b in zip(names, resumed, straight):
        assert torch.equal(a, b), n


# --------------------------------------------------------------- train step


def _batch(variant, b=4, img=32, t=6, seed=0):
    r = np.random.default_rng(seed)
    tmax = 3 if variant == "grec" else 1
    xy = r.uniform(2, 12, (b, tmax, 2))
    wh = r.uniform(4, 12, (b, tmax, 2))
    pad = np.zeros((b, t), np.int32)
    pad[:, 4:] = 1
    batch = dict(
        image=r.normal(size=(b, img, img, 3)).astype(np.float32),
        text_ids=r.integers(1, 64, (b, t)).astype(np.int32),
        text_padding_mask=pad,
        img_shape=np.full((b, 2), img, np.int32),
        gt_boxes=np.concatenate([xy, xy + wh], -1).astype(np.float32),
        gt_labels=np.zeros((b, tmax), np.int32),
        gt_valid=np.ones((b, tmax), bool),
    )
    if variant == "grec":
        batch["gt_valid"][0, 2] = False  # an invalid slot
        batch["gt_valid"][2, 1:] = False
        batch["gt_labels"][1, 1] = 1  # a no-target row
    return batch


def _models(variant):
    from simvg_tpu.models import SimVGConfig, SimVGModel
    from simvg_tpu.models.beit3 import BEiT3Config
    from simvg_tpu.models.heads.tgqs_head import TGQSHeadConfig
    from simvg_tpu_torch.models.beit3 import BEiT3Config as TBEiT3Config
    from simvg_tpu_torch.models.heads.tgqs_head import (
        TGQSHeadConfig as THeadConfig)
    from simvg_tpu_torch.models.model import (SimVGConfig as TConfig,
                                              SimVGModel as TModel)

    head = dict(TINY_HEAD, num_queries=1 if variant != "grec" else 10)
    if variant == "options":  # the DETR encoder over the image memory
        head.update(only_decoder=False, num_encoder_layers=2)
    return (SimVGModel(SimVGConfig(beit3=BEiT3Config(**TINY_BEIT3),
                                   head=TGQSHeadConfig(**head))),
            TModel(TConfig(beit3=TBEiT3Config(**TINY_BEIT3),
                           head=THeadConfig(**head))))


def _loss_kw(variant):
    """The loss settings of a variant: the flagship's balanced
    distillation, or for "options" soft distillation beside the token
    branch's GT loss."""
    if variant == "options":
        return dict(branch_loss_weight=SOFT_BLW, distill_type="soft")
    return dict(branch_loss_weight=BLW)


def _torch_grads(model, batch, variant):
    from simvg_tpu_torch.engine.train import train_losses

    loss, _ = train_losses(model, batch, batch["image"], **_loss_kw(variant))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss["loss_total"], params,
                                allow_unused=True)
    return {n: np.zeros(p.shape, np.float32) if g is None else g.numpy()
            for n, p, g in zip(names, params, grads)}


def _jax_grads(model, params, batch, variant):
    def loss_fn(p):
        out = model.apply(p, **{k: batch[k] for k in (
            "image", "text_ids", "text_padding_mask", "img_shape")},
            deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
        targets = jax_targets(batch["gt_boxes"], batch["gt_labels"],
                              batch["gt_valid"], batch["img_shape"])
        return jax_losses(out, targets, **_loss_kw(variant))["loss_total"]

    return jax.jit(jax.grad(loss_fn))(params)


@pytest.fixture(scope="module", params=["refcoco", "grec", "options"])
def three_steps(request):
    """Both packages from the same weights through 3 steps on one batch;
    "options" takes the DETR encoder, soft distillation and SGD."""
    from simvg_tpu_torch.convert import export_simvg_full, load_jax_params
    from simvg_tpu_torch.engine import (create_optimizer, create_train_state,
                                        make_train_step)

    variant = request.param
    jm, tm = _models(variant)
    batch = _batch(variant)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = jax.tree.map(np.asarray, cheap_jit(jm.init)(
        jax.random.PRNGKey(0), **{k: jb[k] for k in (
            "image", "text_ids", "text_padding_mask", "img_shape")}))
    load_jax_params(tm, params)
    grads_j = export_simvg_full(jax.tree.map(
        np.asarray, _jax_grads(jm, params, jb, variant)))
    grads_t = _torch_grads(tm, tb, variant)

    kw = dict(lr=1e-3, steps_per_epoch=1000)
    if variant == "options":
        kw["optimizer_type"] = "SGD"
    tx = jax_create_optimizer(**kw)
    state_j = jax_create_train_state(params, tx, ema=True)
    step_j = jax.jit(jax_make_train_step(jm, tx, ema_alpha=0.99,
                                         **_loss_kw(variant)))
    opt = create_optimizer(**kw)
    state_t = create_train_state(tm, opt, ema=True)
    step_t = make_train_step(tm, opt, ema_alpha=0.99, **_loss_kw(variant))
    scalars = []
    for _ in range(3):
        state_j, sj = step_j(state_j, jb, jax.random.PRNGKey(1))
        state_t, st = step_t(state_t, tb, 1)
        scalars.append(({k: float(v) for k, v in sj.items()},
                        {k: float(v) for k, v in st.items()}))
    names = [n for n, _ in tm.named_parameters()]
    return dict(
        scalars=scalars, grads_j=grads_j, grads_t=grads_t,
        params_j=export_simvg_full(jax.tree.map(np.asarray, state_j.params)),
        params_t={n: p.detach().numpy() for n, p in tm.named_parameters()},
        ema_j=export_simvg_full(jax.tree.map(np.asarray,
                                             state_j.ema_params)),
        ema_t=dict(zip(names, (e.numpy() for e in state_t.ema_params))),
        state_t=state_t)


def test_train_step_losses_and_grad_norm_match_jax(three_steps):
    for step, (sj, st) in enumerate(three_steps["scalars"]):
        assert sorted(st) == sorted(sj)
        assert "grad_norm" in st and "loss_kd" in st
        for k in sj:
            np.testing.assert_allclose(st[k], sj[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {step} {k}")
    assert three_steps["state_t"].step == 3
    assert three_steps["state_t"].ema_step == 3


def test_train_step_grads_match_jax_by_name(three_steps):
    gj, gt = three_steps["grads_j"], three_steps["grads_t"]
    assert sorted(gj) == sorted(gt)
    for name in gj:
        scale = max(np.abs(gj[name]).max(), 1e-30)
        err = np.abs(gt[name] - gj[name]).max()
        assert err <= 1e-5 * scale, (name, err, scale)


def test_train_step_params_after_3_steps_match_jax(three_steps):
    gj = three_steps["grads_j"]
    for name, pj in three_steps["params_j"].items():
        live = np.abs(gj[name]) >= 1e-6  # see the module docstring
        np.testing.assert_allclose(three_steps["params_t"][name][live],
                                   pj[live], rtol=0, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(three_steps["ema_t"][name][live],
                                   three_steps["ema_j"][name][live],
                                   rtol=0, atol=1e-5, err_msg=name)


# -------------------------------------------------------- stochastic layers


def test_drop_path_rate_scaling_and_one_mask_per_sample():
    from simvg_tpu_torch.models.beit3 import DropPath

    dp = DropPath(0.3).train()
    dp.generator = torch.Generator().manual_seed(0)
    xs = (torch.ones(4000, 5, 2), torch.ones(4000, 3, 2))
    ys = dp(xs)
    kept = ys[0][:, 0, 0] != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.03
    for y in ys:  # the same samples survive in both segments, scaled 1/keep
        assert torch.equal(y != 0, kept[:, None, None].expand_as(y))
        torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0],
                                                              1 / 0.7))
    dp.generator = torch.Generator().manual_seed(0)
    assert all(torch.equal(a, b) for a, b in zip(ys, dp(xs)))
    assert dp.eval()(xs) is xs


def test_dropout_rate_scaling_and_seed():
    from simvg_tpu_torch.models.layers import Dropout, set_generator

    model = torch.nn.Sequential(Dropout(0.25), Dropout(0.0)).train()
    x = torch.ones(200, 100)
    set_generator(model, torch.Generator().manual_seed(3))
    y = model(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    set_generator(model, torch.Generator().manual_seed(3))
    assert torch.equal(model(x), y)
    set_generator(model, torch.Generator().manual_seed(4))
    assert not torch.equal(model(x), y)


def test_head_dropout_draws_from_the_step_generator():
    """With head dropout on, the train-mode forward depends only on the
    generator's seed: set_generator reaches the attention-prob dropout and
    the FFN dropout of every DETR layer."""
    from simvg_tpu_torch.models.layers import set_generator

    _, model = _models("refcoco")
    model.train()
    tb = {k: torch.from_numpy(v) for k, v in _batch("refcoco").items()}
    head_cfg = model.head.cfg
    assert head_cfg.attn_dropout == 0.0
    for m in model.head.modules():  # turn the head's dropout on
        if hasattr(m, "attn_dropout"):
            m.attn_dropout = 0.5
        if hasattr(m, "rate"):
            m.rate = 0.5

    def run(seed):
        set_generator(model, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return model(tb["image"], tb["text_ids"], tb["text_padding_mask"],
                         img_shape=tb["img_shape"])["class_decoder"]

    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))

