"""The OneStageModel family of simvg_tpu_torch held against simvg_tpu's on
the same weights (``configs/smoke/tiny_synth_onestage.py``).

Weights are JAX's ``init`` from a fixed key for DarkNet53 and the whole
model, and numpy draws with flax's statistics on the JAX module's shapes
for the other parts (``random_params``: ``jax.eval_shape`` of ``init``, so
no init is compiled), carried into the port by ``convert.export_composed``; inputs are made with numpy from a seed
and include padded word ids, so the reverse GRU runs over the pad.  In
float32 on the CPU every part (DarkNet53, the GRU encoder in its five
output modes, the fusion, the DETR head) and the whole model agree within
1e-5, the full-model tolerance of tests/test_converter_e2e.py.  The whole
model's outputs sit within ~5e-6 of each other at JAX's init; that bound
is near float32's own reach for nine GroupNorm layers: at one numpy draw
of the same statistics JAX's float32 logits were 1.5e-5 and the port's
2.7e-5 from the port's float64 forward.

One train step is held to JAX ``make_train_step`` called with its
defaults (the JAX train CLI cannot train this config: it raises KeyError
on ``prepare_target_mode``), at tests/test_torch_train.py's tolerances:
scalars 1e-5 relative, every gradient within 1e-5 of its tensor's max,
the parameters after the update at 1e-5; the eval step's decoded boxes
are JAX ``make_eval_step``'s.  The exception is the gradients that the
DarkNet backbone's features reach: the backbone's own (``vis_enc.*``)
sum over every pixel of the 64 px grid through nine GroupNorm layers,
and there float32 rounding alone puts the two packages up to 6.2e-5 of
the tensor's max apart at this batch (each is 1.5e-4 to 4e-4 from the
same step run in float64), so they are held at 1e-4; the fusion and the
head, which run on those features, come within 1.02e-5 and are held at
2e-5.  The language encoder's are held at 1e-5.

The port's train CLI trains the config one epoch and its test CLI
reproduces the epoch's evaluation (tests/test_torch_tools.py holds the
test CLI on a converted JAX checkpoint to JAX ``evaluate``'s Prec@0.5).
"""

import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from util_synth import make_refcoco_style

from simvg_tpu_torch.convert import export_composed, export_params
from util_torch_port import cheap_jit

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
ONESTAGE = osp.join(REPO, "configs", "smoke", "tiny_synth_onestage.py")
INPUTS = ("image", "text_ids", "text_padding_mask", "img_shape")
ATOL = 1e-5


def _ids(b=3, t=10, vocab=1000, seed=0):
    """Word ids with zero padding: full, 6 words and 3 words."""
    ids = np.random.default_rng(seed).integers(1, vocab, (b, t)).astype(
        np.int32)
    for i, n in enumerate((t, 6, 3)[:b]):
        ids[i, n:] = 0
    return ids


def _batch(b=3, img=64, seed=0):
    r = np.random.default_rng(seed)
    ids = _ids(b, seed=seed)
    xy = r.uniform(2, 30, (b, 1, 2))
    wh = r.uniform(8, 30, (b, 1, 2))
    return dict(
        image=r.normal(size=(b, img, img, 3)).astype(np.float32),
        text_ids=ids, text_padding_mask=(ids == 0).astype(np.int32),
        img_shape=np.full((b, 2), img, np.int32),
        gt_boxes=np.concatenate([xy, xy + wh], -1).astype(np.float32),
        gt_labels=np.zeros((b, 1), np.int32),
        gt_valid=np.ones((b, 1), bool))


def random_params(model, *args, seed=0):
    """Weights for ``model`` (a flax module) from numpy, on its parameter
    shapes, with the statistics of flax's initialisers: Dense and conv
    kernels and ``hh_kernel`` N(0, 1/fan_in) (the BEiT-3 encoder's N(0,
    0.02)), biases 0, scales 1, the word embedding N(0, 0.02), the other
    embedding tables N(0, 1/D), ``query_embed`` N(0, 1), the rest N(0,
    0.02)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        keys = [str(getattr(k, "key", k)) for k in path]
        name = keys[-1]
        if name == "scale" or name.endswith("bias"):
            return np.full(leaf.shape, float(name == "scale"), np.float32)
        std = (0.02 if "beit3" in keys or "lan_enc" in keys
               and name == "embedding" else
               np.prod(leaf.shape[:-1]) ** -0.5
               if name in ("kernel", "hh_kernel") else
               leaf.shape[-1] ** -0.5 if name == "embedding" else
               1.0 if name == "query_embed" else 0.02)
        return rng.normal(0, std, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax(batch, keys=INPUTS):
    return {k: jnp.asarray(batch[k]) for k in keys}


def _torch(batch, keys=None):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
            if keys is None or k in keys}


def _port_part(module, top, params):
    """Loads the JAX sub-tree ``params`` of part ``top`` into the port's
    ``module`` (strict)."""
    sd = export_composed({"params": {top: params["params"]}})
    module.load_state_dict({k[len(top) + 1:]: torch.from_numpy(v.copy())
                            for k, v in sd.items()}, strict=True)
    return module.eval()


def _close(got, want, atol=ATOL, err=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(
        got) else got), np.asarray(want), rtol=0, atol=atol, err_msg=err)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params from ``init`` at PRNGKey(1), the port's model
    on them, the config) for the tiny OneStage config."""
    from simvg_tpu.config import Config
    from simvg_tpu.models.builder import build_model as jax_build
    from simvg_tpu_torch.convert import load_jax_params
    from simvg_tpu_torch.models import build_model

    cfg = Config.fromfile(ONESTAGE)
    jm, _ = jax_build(cfg.model, img_size=64)
    params = jax.tree.map(np.asarray, cheap_jit(jm.init)(
        jax.random.PRNGKey(1), **_jax(_batch())))
    tm, _ = build_model(cfg.model, img_size=64, device="cpu")
    return jm, params, load_jax_params(tm, params).eval(), cfg


def test_darknet53_matches_jax():
    """Widths whose GroupNorm takes 8, 4, 8, 16 and 32 groups; a
    non-square image."""
    from simvg_tpu.models.vis_enc_zoo import DarkNet53 as JaxDarkNet
    from simvg_tpu_torch.models.vis_enc_zoo import DarkNet53

    kw = dict(stage_blocks=(1, 2, 1, 1, 1), stage_widths=(8, 12, 24, 48, 64))
    x = np.random.default_rng(3).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    jm = JaxDarkNet(**kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x))
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    tm = _port_part(DarkNet53(**kw), "vis_enc", params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 2, 3, 64)
    _close(got, want)


@pytest.mark.parametrize("mode,bidirectional", [
    ("original", True), ("mean", True), ("max", True), ("default", True),
    ("query", True), ("default", False)])
def test_gru_encoder_matches_jax(mode, bidirectional):
    from simvg_tpu.models.lan_encs import LSTMLanguageEncoder as JaxEnc
    from simvg_tpu_torch.models.lan_encs import LSTMLanguageEncoder

    kw = dict(vocab_size=50, word_emb_dim=12, hidden_size=8,
              bidirectional=bidirectional, output_type=mode, out_dim=16)
    ids = _ids(vocab=50)
    jm = JaxEnc(**kw)
    params = random_params(jm, jnp.asarray(ids), seed=4)
    want = cheap_jit(jm.apply)(params, jnp.asarray(ids))
    tm = _port_part(LSTMLanguageEncoder(**kw), "lan_enc", params)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    if mode == "original":
        assert np.array_equal(got["text_mask"].numpy(),
                              np.asarray(want["text_mask"]))
        got, want = got["text_feat"], want["text_feat"]
    assert got.shape == want.shape
    _close(got, want, err=mode)


def test_gru_encoder_freezes_the_embedding():
    from simvg_tpu_torch.models.lan_encs import LSTMLanguageEncoder

    ids = torch.from_numpy(_ids(vocab=50))
    for freeze in (True, False):
        enc = LSTMLanguageEncoder(50, 12, 8, output_type="mean",
                                  freeze_emb=freeze)
        torch.nn.init.normal_(enc.gru.weight_hh_l0)
        enc(ids).sum().backward()
        assert (enc.embedding.weight.grad is None) == freeze
        assert enc.gru.weight_hh_l0.grad.abs().sum() > 0


def test_fusion_matches_jax():
    from simvg_tpu.models.fusion import CrossAttentionFusion as JaxFusion
    from simvg_tpu_torch.models.fusion import CrossAttentionFusion

    r = np.random.default_rng(5)
    img = r.normal(size=(3, 2, 3, 24)).astype(np.float32)
    text = r.normal(size=(3, 10, 16)).astype(np.float32)
    mask = _ids() == 0
    jm = JaxFusion(embed_dim=16, num_heads=2)
    args = (jnp.asarray(img), jnp.asarray(text), jnp.asarray(mask))
    params = random_params(jm, *args, seed=6)
    want = cheap_jit(jm.apply)(params, *args)
    tm = _port_part(CrossAttentionFusion(24, 16, embed_dim=16, num_heads=2),
                    "fusion", params)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (img, text, mask)))
    _close(got, want)


@pytest.mark.parametrize("only_decoder", [False, True])
def test_detr_head_matches_jax(only_decoder):
    """Two decoder layers, every layer's output; a padded cell in the
    memory's mask; the token keys alias the decoder's last layer."""
    from simvg_tpu.models.heads.simple_head import DETRHead as JaxHead
    from simvg_tpu.models.heads.simple_head import (
        DETRHeadConfig as JaxHeadConfig)
    from simvg_tpu_torch.models.heads.simple_head import (DETRHead,
                                                          DETRHeadConfig)

    kw = dict(num_queries=3, in_channels=16, embed_dim=16,
              num_encoder_layers=1, num_decoder_layers=2,
              only_decoder=only_decoder)
    r = np.random.default_rng(7)
    x = r.normal(size=(3, 2, 3, 16)).astype(np.float32)
    pad = np.zeros((3, 2, 3), bool)
    pad[1, :, 2] = pad[2, 1] = True
    jm = JaxHead(JaxHeadConfig(**kw))
    params = random_params(jm, jnp.asarray(x), jnp.asarray(pad), seed=8)
    want = cheap_jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(pad))
    tm = _port_part(DETRHead(DETRHeadConfig(**kw)), "head", params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(pad))
    assert sorted(got) == sorted(want)
    assert got["class_decoder"].shape == (2, 3, 3, 2)
    for k in want:
        _close(got[k], want[k], err=k)
    assert torch.equal(got["bbox_token"], got["bbox_decoder"][-1:])


def test_composed_model_matches_jax(pair):
    jm, params, tm, _ = pair
    batch = _batch(seed=1)
    want = cheap_jit(jm.apply)(params, **_jax(batch))
    with torch.no_grad():
        got = tm(**_torch(batch, INPUTS))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], err=k)


def test_state_dict_names_and_init(pair):
    """Every port parameter has its JAX leaf (strict load above); the
    port's random init gives flax's statistics: GroupNorm/LayerNorm scales
    1, biases 0, word embedding N(0, 0.02), query_embed N(0, 1), the
    convs, Dense layers and GRU weights lecun_normal."""
    from simvg_tpu_torch.models import build_model, init_random_weights

    jm, params, tm, cfg = pair
    assert sorted(export_params(params)) == sorted(tm.state_dict())
    model, _ = build_model(cfg.model, img_size=64, device="cpu")
    sd = dict(init_random_weights(model, 0).named_parameters())
    assert torch.all(sd["vis_enc.stem_n.weight"] == 1)
    assert torch.all(sd["fusion.ln.bias"] == 0)
    assert torch.all(sd["lan_enc.gru.bias_hh_l0_reverse"] == 0)
    for name, std in (("lan_enc.embedding.weight", 0.02),
                      ("head.query_embed.weight", 1.0)):
        assert abs(sd[name].std().item() / std - 1) < 0.1, name
    for name in ("vis_enc.s3b0c2.weight", "lan_enc.gru.weight_hh_l0",
                 "lan_enc.gru.weight_ih_l0_reverse", "fusion.q.weight"):
        w = sd[name]
        fan_in = w[0].numel()
        assert abs(w.std().item() * fan_in ** 0.5 - 1) < 0.25, name
        assert w.abs().max() <= 2 * 0.87962566103423978 ** -1 \
            * fan_in ** -0.5 + 1e-6, name


@pytest.fixture(scope="module")
def one_step(pair):
    """One train step of both packages from the same weights and batch:
    the tiny config's optimizer (Adam amsgrad, vis_enc at lr/10), the
    criterion on {"decoder": 1.0} with make_train_step's defaults."""
    from simvg_tpu.engine import create_optimizer as jax_optimizer
    from simvg_tpu.engine import create_train_state as jax_state
    from simvg_tpu.engine import make_eval_step as jax_eval_step
    from simvg_tpu.engine import make_train_step as jax_train_step
    from simvg_tpu_torch.convert import load_jax_params
    from simvg_tpu_torch.engine import (create_optimizer,
                                        create_train_state, make_eval_step,
                                        make_train_step)
    from simvg_tpu_torch.models import build_model

    jm, params, _, cfg = pair
    batch = _batch(b=4, seed=2)
    oc = cfg.optimizer_config
    kw = dict(lr=oc.lr, steps_per_epoch=1000, lr_vis_enc=oc.lr_vis_enc,
              lr_lan_enc=oc.lr_lan_enc, warmup_epochs=1)
    blw = {"decoder": 1.0}

    tx = jax_optimizer(**kw)
    step_j = cheap_jit(jax_train_step(jm, tx, branch_loss_weight=blw))
    state_j, sj = step_j(jax_state(params, tx), _jax(batch, batch),
                         jax.random.PRNGKey(0))
    preds_j = cheap_jit(jax_eval_step(jm))(state_j.params, _jax(batch))

    tm, loss_cfg = build_model(cfg.model, img_size=64, device="cpu")
    load_jax_params(tm, params)
    grads_t = _port_grads(tm, _torch(batch), loss_cfg)
    opt = create_optimizer(**kw)
    step_t = make_train_step(
        tm, opt, branch_loss_weight=loss_cfg["branch_loss_weight"],
        prepare_target_mode=loss_cfg["prepare_target_mode"],
        distill_type=loss_cfg["distill_type"],
        mlp_aux_loss=loss_cfg["mlp_aux_loss"])
    _, st = step_t(create_train_state(tm, opt), _torch(batch), 0)
    preds_t = make_eval_step(tm)(_torch(batch, INPUTS))
    return dict(
        sj={k: float(v) for k, v in sj.items()},
        st={k: float(v) for k, v in st.items()},
        grads_j=export_params(jax.tree.map(np.asarray, _jax_grads(
            jm, params, batch, blw))),
        grads_t=grads_t,
        params_j=export_params(jax.tree.map(np.asarray, state_j.params)),
        params_t={n: p.detach().numpy() for n, p in tm.named_parameters()},
        preds_j=preds_j, preds_t=preds_t)


def _port_grads(model, batch, loss_cfg):
    from simvg_tpu_torch.engine.train import train_losses

    losses, _ = train_losses(
        model, batch, batch["image"],
        branch_loss_weight=loss_cfg["branch_loss_weight"],
        prepare_target_mode=loss_cfg["prepare_target_mode"],
        distill_type=loss_cfg["distill_type"])
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(losses["loss_total"], params,
                                allow_unused=True)
    return {n: np.zeros(p.shape, np.float32) if g is None else g.numpy()
            for n, p, g in zip(names, params, grads)}


def _jax_grads(model, params, batch, blw):
    from simvg_tpu.losses.criterion import (normalize_targets,
                                            simvg_branch_losses)

    jb = _jax(batch, batch)

    def loss_fn(p):
        out = model.apply(p, **{k: jb[k] for k in INPUTS},
                          deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        targets = normalize_targets(jb["gt_boxes"], jb["gt_labels"],
                                    jb["gt_valid"], jb["img_shape"])
        return simvg_branch_losses(out, targets,
                                   branch_loss_weight=blw)["loss_total"]

    return cheap_jit(jax.grad(loss_fn))(params)


def test_train_step_scalars_match_jax(one_step):
    sj, st = one_step["sj"], one_step["st"]
    assert sorted(st) == sorted(sj)
    assert {"loss_dgt", "loss_total", "grad_norm", "decoder_det_acc",
            "token_det_acc"} <= set(st)
    for k in sj:
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_train_step_grads_and_update_match_jax(one_step):
    """Every gradient by name within 1e-5 of its tensor's max |g| in the
    language encoder, 1e-4 in the backbone and 2e-5 downstream of it (see
    the module docstring); the frozen word embedding's is 0 in both.  The
    fusion's key bias adds the same q.b_k to every logit of a softmax row,
    so its gradient is 0 in exact arithmetic and float32 noise in both
    packages: it is held below 1e-6 of the largest gradient instead.  The
    parameters after the step at 1e-5 where JAX's gradient is above the
    noise (see tests/test_torch_train.py)."""
    gj, gt = one_step["grads_j"], one_step["grads_t"]
    assert sorted(gj) == sorted(gt)
    assert not gj["lan_enc.embedding.weight"].any()
    assert not gt["lan_enc.embedding.weight"].any()
    top = max(np.abs(g).max() for g in gj.values())
    for name in gj:
        if name == "fusion.k.bias":
            assert max(np.abs(gj[name]).max(),
                       np.abs(gt[name]).max()) <= 1e-6 * top
            continue
        scale = max(np.abs(gj[name]).max(), 1e-30)
        err = np.abs(gt[name] - gj[name]).max()
        bound = (1e-4 if name.startswith("vis_enc.") else
                 1e-5 if name.startswith("lan_enc.") else 2e-5)
        assert err <= bound * scale, (name, err, scale)
    # Adam's first update is g / (|g| + 1e-9) after the clip: where the
    # clipped gradient is near eps the update follows g's float32 noise.
    # This step's norm (~2e3) clips by ~1e-4, so the flagship test's 1e-6
    # cut on |g| is taken on the clipped gradient, 10x eps
    clip = min(1.0, 0.15 / one_step["sj"]["grad_norm"])
    for name, pj in one_step["params_j"].items():
        live = np.abs(gj[name]) * clip >= 1e-8
        _close(one_step["params_t"][name][live], pj[live], err=name)


def test_eval_step_matches_jax(one_step):
    """Both aliased branches decode the same boxes as JAX's eval step."""
    for branch in ("decoder", "token"):
        pj, pt = one_step["preds_j"][branch], one_step["preds_t"][branch]
        _close(pt["best_box"], pj["best_box"], atol=1e-3, err=branch)
        _close(pt["best_score"], pj["best_score"], err=branch)
    assert torch.equal(one_step["preds_t"]["decoder"]["best_box"],
                       one_step["preds_t"]["token"]["best_box"])


@pytest.mark.parametrize("output_type", ["original", "query"])
def test_float64_step_stays_float64(output_type):
    """chip_smoke.py holds the card's float64 step to the CPU's at 1e-7 of
    each tensor's max, which float32 anywhere on the gradient path would
    break: every tensor that a float64 train step computes from the
    parameters is float64 (the float32 ones are the targets and the
    image), no sum is taken in float32 (the cross-entropy's class weights
    normalise the loss), and the gradients are float64."""
    from torch.overrides import TorchFunctionMode
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.engine.train import train_losses
    from simvg_tpu_torch.models import build_model, init_random_weights

    cfg = Config.fromfile(ONESTAGE)
    cfg.merge_from_dict({"model.lan_enc.output_type": output_type})
    model, loss_cfg = build_model(cfg.model, img_size=64,
                                  dtype=torch.float64, device="cpu")
    init_random_weights(model, 0).to(torch.float64)
    batch = _torch(_batch(seed=3))
    float32 = []

    class Watch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in out if isinstance(out, (tuple, list)) else [out]:
                if torch.is_tensor(o) and o.dtype != torch.float64 and (
                        o.requires_grad or o.is_floating_point()
                        and getattr(func, "__name__", "") == "sum"):
                    float32.append(getattr(func, "__name__", str(func)))
            return out

    with Watch():
        losses, _ = train_losses(
            model, batch, batch["image"],
            branch_loss_weight=loss_cfg["branch_loss_weight"],
            prepare_target_mode=loss_cfg["prepare_target_mode"],
            distill_type=loss_cfg["distill_type"])
    assert not float32
    assert losses["loss_total"].dtype == torch.float64
    losses["loss_total"].backward()
    assert all(p.grad.dtype == torch.float64 for p in model.parameters()
               if p.grad is not None)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    imgdir, ann = make_refcoco_style(str(tmp_path_factory.mktemp("synth")),
                                     8, 8)
    return [f"data.{s}.{k}={v}" for s in ("train", "val")
            for k, v in (("annsfile", ann), ("imgsfile", imgdir))]


def test_train_cli_one_epoch_then_test_cli(tmp_path, synth):
    from simvg_tpu_torch.tools import test as test_cli
    from simvg_tpu_torch.tools import train as train_cli

    wd = tmp_path / "run"
    res = train_cli.main([ONESTAGE, "--work-dir", str(wd), "--device", "cpu",
                          "--cfg-options", *synth,
                          "scheduler_config.max_epoch=1"])
    assert res["step"] == 2 and osp.isdir(wd / "det_best")
    got = test_cli.main([ONESTAGE, str(wd / "det_best"), "--device", "cpu",
                         "--cfg-options", *synth])["val"]
    assert got == res["eval"]["val"], (got, res["eval"]["val"])


@pytest.mark.parametrize("part,value,item", [
    ("vis_enc", dict(type="SwinTransformer"), "M20b"),
    ("lan_enc", dict(type="ALBERTA"), "M20b")])
def test_unported_parts_raise(pair, part, value, item):
    """The parts of ROADMAP item M20b that were refused are ported: a Swin
    ``vis_enc`` and an ALBERTA ``lan_enc`` at their defaults build on
    ``meta`` with the names and shapes of JAX's ``init``."""
    from simvg_tpu.models.builder import build_model as jax_build
    from simvg_tpu_torch.models import build_model

    model_cfg = dict(pair[3].model, **{part: value})
    model, _ = build_model(model_cfg, img_size=64, device="meta")
    jm, _ = jax_build(model_cfg, img_size=64)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            **_jax(_batch()))
    want = export_params(jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32), shapes))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: v.shape for k, v in want.items()}
    assert type(getattr(model, part)).__name__ == {
        "vis_enc": "SwinTransformer", "lan_enc": "BERTLanguageEncoder"}[part]


@pytest.mark.parametrize("opts,option", [
    ({"model.vis_enc.token_prune_keep": 2}, "token pruning"),
    ({"model.vis_enc.quant": "int8_static"}, "int8"),
    ({"model.vis_enc.remat": True}, "remat"),
    ({"model.vis_enc.seq_parallel": True}, "sequence parallelism"),
    ({"model_parallel": 2}, "tensor parallelism")])
def test_beit3_only_options_raise(opts, option):
    """The options of the BEiT-3 encoder raise on this family, naming
    themselves; the config as shipped passes, also as a distributed run."""
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.tools.train import check_ported

    cfg = Config.fromfile(ONESTAGE)
    check_ported(cfg, distributed=True)
    cfg.merge_from_dict(opts)
    with pytest.raises(NotImplementedError, match=option):
        check_ported(cfg, distributed=True)
