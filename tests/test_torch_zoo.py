"""The vision-encoder zoo of simvg_tpu_torch held against simvg_tpu's, on the
CPU in float32 (``simvg_tpu_torch/models/vis_enc_zoo.py``, ``vis_encs.py``).

Every backbone at the tiny widths of tests/test_vis_enc_zoo.py, on JAX's
``init`` carried into the port by ``convert.export_composed`` and inputs
made with numpy from a seed: the outputs within 1e-5 of their max, the
parameter counts JAX's.  The cases that need care are inside those runs:
Swin at 72 px (an 18x18 grid that its window of 7 does not divide, every
second block shifted, batch 2, so the shift mask's batch-major tiling
counts); ViTDet with a window of 3 on a 4x4 grid; ViLT with 10 word ids
past its ``max_text_len`` of 8; YOLOS with text and, on the same weights
less ``text_proj``, without.

Each pure-vision backbone in the tiny OneStageModel
(``configs/smoke/tiny_synth_onestage.py`` with its ``vis_enc`` replaced),
built through ``build_model``: the state dict's names and shapes are those
of ``export_composed`` of JAX's ``model.init``, the port's random init has
its statistics (tests/test_torch_init.py's rule: mean and std within 6
standard errors, constants equal), ``freeze_layer`` freezes nothing in it
(JAX freezes ``layers_N`` leaves only) and the forward is JAX's.  For Swin
and ResNet one train step's loss terms and gradients are JAX
``make_train_step``'s (dropout 0 in the tiny head), at
tests/test_torch_onestage.py's tolerances; the JAX step hands its
gradients out through an optimizer that keeps them as its state.

``build_vis_enc`` takes every key and alias of JAX's registry, and a
OneStageModel with a mixed vision-language encoder raises.
"""

import contextlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_onestage import (INPUTS, ONESTAGE, _batch, _close, _jax,
                                 _port_grads, _torch)

from simvg_tpu_torch.convert import export_composed, export_params

# the tiny widths of tests/test_vis_enc_zoo.py's registry cases; Swin with
# two stages of two blocks so that both stages shift, ViTDet's window 3 on
# its 4x4 grid
BACKBONES = {
    "ResNet": dict(depths=(1, 1, 1, 1), widths=(8, 16, 32, 64)),
    "CSPDarknet": dict(stage_blocks=(1, 1, 1, 1), stage_widths=(8, 8, 8, 8)),
    "VIT": dict(img_size=64, patch_size=16, embed_dim=16, num_heads=2,
                ffn_dim=32, num_layers=1),
    "SwinTransformer": dict(patch_size=4, embed_dim=8, depths=(2, 2),
                            num_heads=(2, 2)),
    "PyramidVisionTransformerV2": dict(
        dims=(8, 8, 8, 8), depths=(1, 1, 1, 1), heads=(1, 1, 1, 1),
        sr_ratios=(8, 4, 2, 1), mlp_ratios=(2, 2, 2, 2)),
    "VITDet": dict(patch_size=16, embed_dim=16, num_heads=2, num_layers=3,
                   window=3, global_every=3),
}
N_SE = 6.0  # standard errors allowed for an init tensor's mean and std
# the most of JAX's own float32 distance from its float64 run (relative to
# the tensor's max) that a float32 bound may add
JAX_OWN_CAP = 5e-5


def _image(b=2, size=64, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (b, size, size, 3)
                                              ).astype(np.float32)


def _text(b=2, t=5, d=16):
    """Text features with a padded tail of 2 (tests/test_vis_enc_zoo.py)."""
    tf = np.random.default_rng(1).normal(0, 1, (b, t, d)).astype(np.float32)
    mask = np.zeros((b, t), bool)
    mask[:, -2:] = True
    return tf, mask


def _load(module, vis_params):
    """The JAX ``vis_enc`` tree into the port's encoder, every parameter of
    which it must fill; returns (the encoder, the tree's names it has
    not)."""
    sd = export_composed({"params": {"vis_enc": vis_params}})
    missing, unexpected = module.load_state_dict(
        {k[len("vis_enc."):]: torch.from_numpy(v.copy())
         for k, v in sd.items()}, strict=False)
    assert not missing, missing
    return module.eval(), unexpected


def jax_run(fn, *args):
    """``fn(*args)`` through jax.jit, compiled with LLVM's cheap passes only
    (a third less compile time on the CPU), as numpy arrays."""
    compiled = jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True})
    return jax.tree.map(np.asarray, compiled(*args))


class _Wide:
    """A module's ``jnp`` or ``np`` whose ``float32`` is ``float64``."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        return getattr(self._mod, "float64" if name == "float32" else name)


@contextlib.contextmanager
def jax_float64():
    """JAX's modules in float64: x64 on, and every ``jnp.float32`` and
    ``np.float32`` that simvg_tpu's code names (its LayerNorm, GroupNorm,
    softmax and loss casts) read as float64 while a program is traced.
    Modules built inside take ``dtype=jnp.float64`` (``_wide``)."""
    swapped = []
    for name, mod in list(sys.modules.items()):
        if mod is not None and name.split(".")[0] == "simvg_tpu":
            for attr, real in (("jnp", jnp), ("np", np)):
                if getattr(mod, attr, None) is real:
                    swapped.append((mod, attr, real))
                    setattr(mod, attr, _Wide(real))
    try:
        with jax.enable_x64(True):
            yield
    finally:
        for mod, attr, real in swapped:
            setattr(mod, attr, real)


def _wide(model_cfg):
    """A composed model config whose parts compute in float64 (JAX's
    ``build_composed_model`` gives them no dtype of its own)."""
    return dict(model_cfg, **{k: dict(model_cfg.get(k) or {},
                                      dtype=jnp.float64)
                              for k in ("vis_enc", "lan_enc", "fusion",
                                        "head")})


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        if a.dtype == np.float32 else a, tree)


def _n_params(tree):
    return sum(int(np.prod(v.shape)) for v in jax.tree.leaves(tree))


def _outputs_close(got, want, err="", rel=1e-5):
    """Every output within ``rel`` of its max |value|."""
    if not isinstance(want, dict):
        got, want = {"out": got}, {"out": want}
    assert sorted(got) == sorted(want), err
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, (err, k)
        _close(got[k], w, atol=rel * np.abs(w).max(), err=f"{err} {k}")


def _composed_cfg(typ):
    from simvg_tpu_torch.config import Config

    return dict(Config.fromfile(ONESTAGE).model,
                vis_enc=dict(type=typ, **BACKBONES[typ]))


@pytest.fixture(scope="module", params=sorted(BACKBONES))
def backbone(request):
    """(type, the JAX encoder, its ``init`` at PRNGKey(1) and its output,
    both from one compiled program, JAX's float64 output on that init, the
    input) at batch 2 and 64 px, Swin at 72 px (padded windows, shifted
    blocks; its windows those of the 64 px canvas)."""
    from simvg_tpu.models.vis_enc_zoo import build_vis_enc as jax_vis_enc

    typ = request.param
    jm = jax_vis_enc(dict(type=typ, **BACKBONES[typ]))
    x = _image(size=72 if typ == "SwinTransformer" else 64)

    def init_apply(key, x):
        params = jm.init(key, x)
        return params["params"], jm.apply(params, x)

    vis, want = jax_run(init_apply, jax.random.PRNGKey(1), jnp.asarray(x))
    with jax_float64():
        jm64 = jax_vis_enc(dict(type=typ, dtype=jnp.float64, **BACKBONES[typ]))
        want64 = jax_run(lambda p, x: jm64.apply({"params": p}, x),
                         _f64(vis), jnp.asarray(x, jnp.float64))
    return typ, vis, (want, want64), x


def test_backbone_matches_jax(backbone):
    from simvg_tpu_torch.models.vis_enc_zoo import build_vis_enc

    typ, vis, (want, want64), x = backbone
    cfg = dict(type=typ, **BACKBONES[typ])
    tm, unused = _load(build_vis_enc(cfg, img_size=64), vis)
    assert not unused, unused
    assert sum(p.numel() for p in tm.parameters()) == _n_params(vis)
    t64, _ = _load(build_vis_enc(cfg, img_size=64, dtype=torch.float64), vis)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        ref = t64.double()(torch.from_numpy(x).double()).numpy()
    assert tm.out_channels == want.shape[-1]
    assert want64.dtype == np.float64
    _outputs_close(ref, want64, f"{typ} float64", rel=1e-9)
    _outputs_close(got, want, typ)


def test_composed_model_names_and_init(backbone):
    """The OneStageModel with this backbone: state-dict names and shapes
    those of JAX's ``init`` (``jax.eval_shape``), the backbone's random
    init JAX's statistics, nothing frozen by ``freeze_layer``."""
    from simvg_tpu.models.builder import build_model as jax_build
    from simvg_tpu_torch.engine.train_state import is_frozen
    from simvg_tpu_torch.models import build_model, init_random_weights

    typ, vis, _, _ = backbone
    model_cfg = _composed_cfg(typ)
    jm, _ = jax_build(model_cfg, img_size=64)
    shapes = export_params(jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32),
        jax.eval_shape(jm.init, jax.random.PRNGKey(1), **_jax(_batch()))))
    tm, _ = build_model(model_cfg, img_size=64, device="cpu")
    sd = {k: v.numpy().astype(np.float64) for k, v in
          init_random_weights(tm, 0).state_dict().items()}
    assert {k: v.shape for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in shapes.items()}
    bad = []
    for k, w in export_params({"params": {"vis_enc": vis}}).items():
        got, w = sd[k], w.astype(np.float64)
        if w.std() == 0.0:  # a constant: zeros or ones
            if not np.array_equal(got, w):
                bad.append((k, "constant", got.mean(), w.mean()))
            continue
        sigma, n1, n2 = w.std(), got.size, w.size
        if abs(got.mean() - w.mean()) > N_SE * sigma * np.sqrt(
                1 / n1 + 1 / n2) or abs(got.std() - w.std()) > \
                N_SE * sigma * np.sqrt(1 / (2 * n1) + 1 / (2 * n2)):
            bad.append((k, got.mean(), got.std(), w.mean(), w.std()))
    assert not bad, (typ, bad)
    assert not any(is_frozen(k, 4) for k in sd)


def _grads_as_state():
    """An optax transformation that keeps the gradients as its state and
    updates nothing: ``make_train_step`` then hands them out."""
    import optax

    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("typ", ["ResNet", "SwinTransformer"])
def test_composed_train_step_matches_jax(typ):
    """JAX's ``init`` and one ``make_train_step`` step in one compiled
    program, and the same step in float64 (``jax_float64``) on that init.
    The port's float64 gradients within 1e-6 of JAX's float64 ones (both
    packages normalise the boxes in float32, which leaves ~7e-8).  Loss
    terms and grad_norm at 1e-5 relative; every float32 gradient within
    1e-5 of its tensor's max |g| in the language encoder, 2e-5 in the
    fusion and the head and 1e-4 in the backbone (tests/
    test_torch_onestage.py's bounds), plus JAX's own float32 distance
    from its float64 step, at most JAX_OWN_CAP of the max: flax's and
    torch's GroupNorm take the variance as E[x^2] - E[x]^2, which leaves
    ResNet's float32 gradients up to 5e-3 from float64 in both packages
    while they stay ~1e-5 from each other (the GRU's reverse weights 1.2e-5
    apart).  The fusion's key bias, 0 in exact arithmetic, below 1e-6 of
    the largest gradient."""
    from simvg_tpu.engine import create_train_state as jax_state
    from simvg_tpu.engine import make_train_step as jax_train_step
    from simvg_tpu.models.builder import build_model as jax_build
    from simvg_tpu_torch.convert import load_jax_params
    from simvg_tpu_torch.engine import (create_optimizer,
                                        create_train_state, make_train_step)
    from simvg_tpu_torch.models import build_model

    model_cfg = _composed_cfg(typ)
    batch = _batch(b=4, seed=2)
    jm, _ = jax_build(model_cfg, img_size=64)
    tx = _grads_as_state()
    step = jax_train_step(jm, tx, branch_loss_weight={"decoder": 1.0})

    def init_step(key, batch, rng):
        params = jm.init(key, **{k: batch[k] for k in INPUTS})
        state, scalars = step(jax_state(params, tx), batch, rng)
        return params, state.opt_state, scalars

    params, grads, sj = jax_run(init_step, jax.random.PRNGKey(1),
                                _jax(batch, batch), jax.random.PRNGKey(0))
    gj = export_params(grads)
    with jax_float64():
        jm64, _ = jax_build(_wide(model_cfg), img_size=64, dtype=jnp.float64)
        step64 = jax_train_step(jm64, tx, branch_loss_weight={"decoder": 1.0})
        b64 = _f64(batch)
        grads64 = jax_run(
            lambda p, b, rng: step64(jax_state(p, tx), b, rng)[0].opt_state,
            _f64(params), _jax(b64, b64), jax.random.PRNGKey(0))
    gj64 = export_params(grads64)

    tm, loss_cfg = build_model(model_cfg, img_size=64, device="cpu")
    load_jax_params(tm, params)
    gt = _port_grads(tm, _torch(batch), loss_cfg)
    t64, _ = build_model(model_cfg, img_size=64, dtype=torch.float64,
                         device="cpu")
    g64 = _port_grads(load_jax_params(t64, params).double(), _torch(batch),
                      loss_cfg)
    opt = create_optimizer(lr=1e-3, steps_per_epoch=1000)
    step_t = make_train_step(
        tm, opt, branch_loss_weight=loss_cfg["branch_loss_weight"],
        prepare_target_mode=loss_cfg["prepare_target_mode"],
        distill_type=loss_cfg["distill_type"],
        mlp_aux_loss=loss_cfg["mlp_aux_loss"])
    _, st = step_t(create_train_state(tm, opt), _torch(batch), 0)
    assert sorted(st) == sorted(sj)
    for k in sj:
        np.testing.assert_allclose(float(st[k]), float(sj[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)

    assert sorted(gj) == sorted(gt) == sorted(gj64)
    top = max(np.abs(g).max() for g in gj.values())
    top64 = max(np.abs(g).max() for g in gj64.values())
    for name in gj:
        assert gj64[name].dtype == np.float64, name
        scale64 = max(np.abs(gj64[name]).max(), 1e-6 * top64)
        assert np.abs(g64[name] - gj64[name]).max() <= 1e-6 * scale64, name
        if name == "fusion.k.bias":
            assert max(np.abs(gj[name]).max(),
                       np.abs(gt[name]).max()) <= 1e-6 * top
            continue
        scale = max(np.abs(gj[name]).max(), 1e-30)
        err = np.abs(gt[name] - gj[name]).max()
        own = min(np.abs(gj[name] - gj64[name]).max(), JAX_OWN_CAP * scale)
        bound = (1e-4 if name.startswith("vis_enc.") else
                 1e-5 if name.startswith("lan_enc.") else 2e-5)
        assert err <= bound * scale + own, (name, err, scale, own)


# the mixed vision-language encoders: (type, config, call) at the widths
# and text shapes of tests/test_vis_enc_zoo.py
def _vilt_ids():
    """10 word ids against a max_text_len of 8, a padded tail of 3."""
    ids = np.random.default_rng(2).integers(1, 50, (2, 10)).astype(np.int32)
    ids[:, 7:] = 0
    return ids, ids == 0


MIXED = {
    "VisionTransformerMix": dict(patch_size=16, embed_dim=16, num_heads=2,
                                 num_layers=2),
    "ConvolutionalVisionTransformerMix": dict(
        dims=(8, 16, 32), depths=(1, 1, 1), heads=(1, 2, 4), mlp_ratio=2.0),
    "YOLOS": dict(patch_size=16, embed_dim=16, num_heads=2, num_layers=2,
                  num_det_tokens=7),
    "ViLTransformerSS": dict(patch_size=16, embed_dim=16, num_heads=2,
                             num_layers=2, vocab_size=50, max_text_len=8),
}


@pytest.mark.parametrize("typ", sorted(MIXED))
def test_mixed_encoder_matches_jax(typ):
    """JAX's ``init`` with text and the outputs, from one compiled program;
    YOLOS also without text on the same weights, which then have no
    ``text_proj``."""
    from simvg_tpu.models.vis_enc_zoo import build_vis_enc as jax_vis_enc
    from simvg_tpu_torch.models.vis_enc_zoo import build_vis_enc

    cfg = dict(type=typ, **MIXED[typ])
    x = _image()
    args = (x, *(_vilt_ids() if typ == "ViLTransformerSS" else _text()))
    jm = jax_vis_enc(cfg)

    def init_apply(key, *args):
        params = jm.init(key, *args)
        outs = [jm.apply(params, *args)]
        if typ == "YOLOS":
            outs.append(jm.apply(params, args[0]))
        return params["params"], outs

    vis, outs = jax_run(init_apply, jax.random.PRNGKey(3),
                        *[jnp.asarray(a) for a in args])
    for want, run_args in zip(outs, (args, (x,))):
        text = len(run_args) > 1
        tm, unused = _load(build_vis_enc(
            cfg, img_size=64, text_dim=16 if text and typ != "ViLTransformerSS"
            else None), vis)
        assert sorted(unused) == ([] if text else
                                  ["text_proj.bias", "text_proj.weight"])
        assert sum(p.numel() for p in tm.parameters()) == _n_params(
            {k: v for k, v in vis.items() if text or k != "text_proj"})
        with torch.no_grad():
            got = tm(*[torch.from_numpy(a) for a in run_args])
        _outputs_close(got, want, f"{typ} text {text}")
    if typ == "ViLTransformerSS":
        assert got["text_feat"].shape == (2, 8, 16)


# JAX's registry keys (simvg_tpu/models/vis_enc_zoo.py::build_vis_enc),
# each with tiny widths of its family
REGISTRY = {
    "DarkNet53": dict(stage_blocks=(1,) * 5, stage_widths=(8,) * 5),
    "DarknetMM": dict(stage_blocks=(1,) * 5, stage_widths=(8,) * 5),
    "CSPDarknet": BACKBONES["CSPDarknet"],
    "ResNet": BACKBONES["ResNet"], "ResNetMM": BACKBONES["ResNet"],
    "SwinTransformer": BACKBONES["SwinTransformer"],
    "SwinTransformerMM": BACKBONES["SwinTransformer"],
    **{k: BACKBONES["PyramidVisionTransformerV2"] for k in (
        "PyramidVisionTransformerV2", "PyramidVisionTransformerMM",
        "PyramidVisionTransformerV2MM", "PyramidVisionTransformerV2MMMix")},
    "VIT": BACKBONES["VIT"], "VITDet": BACKBONES["VITDet"], **MIXED,
}


@pytest.mark.parametrize("typ", sorted(REGISTRY))
def test_build_vis_enc_takes_every_jax_key(typ):
    """Each key builds the class JAX's registry maps it to (by name; the
    parameter counts are held above); an unknown key raises KeyError in
    both."""
    from simvg_tpu.models.vis_enc_zoo import build_vis_enc as jax_vis_enc
    from simvg_tpu_torch.models.vis_enc_zoo import build_vis_enc

    cfg = dict(type=typ, **REGISTRY[typ])
    with torch.device("meta"):
        tm = build_vis_enc(cfg, img_size=64, text_dim=16)
    assert type(tm).__name__ == type(jax_vis_enc(cfg)).__name__
    for build in (jax_vis_enc, build_vis_enc):
        with pytest.raises(KeyError):
            build(dict(type=typ + "X"))


@pytest.mark.parametrize("typ", sorted(MIXED))
def test_onestage_refuses_a_mixed_encoder(typ):
    """OneStageModel calls its backbone on the image alone: a mixed
    encoder there fails in JAX and raises at build in the port."""
    from simvg_tpu_torch.models import build_model

    model_cfg = dict(_composed_cfg("VIT"), vis_enc=dict(type=typ,
                                                        **MIXED[typ]))
    with pytest.raises(TypeError, match="takes text"):
        build_model(model_cfg, img_size=64, device="meta")


def test_swin_gradient_on_a_zero_padded_canvas_grows_as_in_jax():
    """A copied reference behaviour (ROADMAP.md §3): Swin has no position
    table and flax initialises every bias to 0, so the windows of a
    zero-padded canvas stay exactly 0, and each LayerNorm's backward
    multiplies their gradient by 1/sqrt(1e-6).  Through four blocks at 224
    px (8 wide) the largest parameter gradient is ~4e19 in both packages
    and in the port's float64, and it grows with depth and canvas: at
    Swin-T's depth on 640 px canvases float32 overflows.  The three agree
    within a factor of 2."""
    from simvg_tpu.models.vis_enc_zoo import build_vis_enc as jax_vis_enc
    from simvg_tpu_torch.models.vis_enc_zoo import build_vis_enc

    cfg = dict(type="SwinTransformer", patch_size=4, embed_dim=8,
               depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2))
    x = _image(b=1, size=224)
    x[:, 120:] = 0
    x[:, :, 150:] = 0
    jm = jax_vis_enc(cfg)

    def init_grad(key, x):
        params = jm.init(key, x)
        return params["params"], jax.grad(
            lambda p: jnp.sum(jm.apply(p, x) ** 2))(params)["params"]

    vis, grads = jax_run(init_grad, jax.random.PRNGKey(4), jnp.asarray(x))
    tops = [max(np.abs(g).max() for g in jax.tree.leaves(grads))]
    for dt in (torch.float32, torch.float64):
        tm, _ = _load(build_vis_enc(cfg, dt, img_size=224), vis)
        tm = tm.to(dt)
        tm(torch.from_numpy(x).to(dt)).double().square().sum().backward()
        tops.append(max(p.grad.abs().max().item() for p in tm.parameters()))
    assert all(1e18 < t < 1e21 for t in tops), tops
    assert max(tops) / min(tops) < 2, tops
