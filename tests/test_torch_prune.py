"""Vision-token pruning in simvg_tpu_torch (``BEiT3Config.token_prune_keep``)
against simvg_tpu's, on the CPU: the counterparts of
tests/test_token_prune.py's cases that have no int8, plus

- a pruned tiny model on weights of JAX ``model.init`` (exported with
  ``simvg_tpu_torch.convert``): the kept indices equal JAX's, the token
  outputs within 1e-5 (tests/test_converter_e2e.py's bound for the full
  model), and the pad mask gathered at the kept indices;
- ties: the stable top-K keeps the lower index, as ``jax.lax.top_k`` does.

The JAX side runs float32 on the CPU under the repo's conftest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util_torch_port import (TINY_BEIT3, TINY_HEAD, assert_int8_close,
                             jax_tiny_model,
                             np_batch, to_jax, to_torch)

from simvg_tpu_torch.convert import export_simvg_full, load_jax_params
from simvg_tpu_torch.models import build_model, init_random_weights
from simvg_tpu_torch.models.beit3 import (BEiT3Config, BEiT3Encoder,
                                          stable_top_k)
from simvg_tpu_torch.models.heads.tgqs_head import TGQSHeadConfig
from simvg_tpu_torch.models.model import SimVGConfig, SimVGModel

KW = dict(img_size=64, patch_size=16, embed_dim=32, num_heads=4,
          ffn_dim=64, num_layers=3, vocab_size=60, drop_path_rate=0.0)
P = (64 // 16) ** 2  # 16 patch tokens
PRUNE = dict(token_prune_keep=5, token_prune_layer=1, token_prune_force=True)
HEAD = dict(num_queries=2, in_channels=32, embed_dim=32,
            num_decoder_layers=2, num_tgqg_layers=1, attn_dropout=0.0,
            ffn_dropout=0.0)


def _inputs(b=2, t=6, seed=0):
    r = np.random.default_rng(seed)
    img = torch.from_numpy(r.normal(size=(b, 64, 64, 3)).astype(np.float32))
    ids = torch.from_numpy(r.integers(1, 60, (b, t)).astype(np.int64))
    pad = torch.zeros(b, t, dtype=torch.int64)
    pad[:, 4:] = 1
    return img, ids, pad


def _encoder(seed=0, **kw):
    enc = BEiT3Encoder(BEiT3Config(**KW, **kw)).eval()
    init_random_weights(enc, seed)
    return enc


def _same_weights(dst, src):
    dst.load_state_dict(src.state_dict(), strict=True)
    return dst.eval()


def _model(**beit3_kw):
    model = SimVGModel(SimVGConfig(beit3=BEiT3Config(**KW, **beit3_kw),
                                   head=TGQSHeadConfig(**HEAD)))
    init_random_weights(model, 0)
    return model.eval()


@torch.no_grad()
def test_prune_params_and_shapes():
    """Same parameters as the unpruned encoder (checkpoints load
    unchanged); img_feat shrinks to [B, keep, D], text and CLS intact."""
    full = _encoder()
    pruned = BEiT3Encoder(BEiT3Config(**KW, **PRUNE))
    assert {k: v.shape for k, v in full.state_dict().items()} == \
        {k: v.shape for k, v in pruned.state_dict().items()}
    _same_weights(pruned, full)
    iv, tv, cv = pruned(*_inputs())
    assert iv.shape == (2, 5, 32)
    assert tv.shape == (2, 6, 32) and cv.shape == (2, 32)
    assert torch.isfinite(iv).all()


@torch.no_grad()
def test_prune_keep_all_is_identity():
    """keep = every patch: the gather is the identity permutation, so every
    output equals the unpruned encoder's."""
    img, ids, pad = _inputs(seed=1)
    full = _encoder()
    ref = full(img, ids, pad)
    noop = _same_weights(BEiT3Encoder(BEiT3Config(
        **KW, token_prune_keep=P, token_prune_layer=1)), full)
    for a, b in zip(noop(img, ids, pad), ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # keep > the patch count is refused
    with pytest.raises(ValueError, match="token_prune_keep"):
        BEiT3Encoder(BEiT3Config(**KW, token_prune_keep=P + 1,
                                 token_prune_layer=1))


@torch.no_grad()
def test_prune_is_exact_subset_at_prune_point():
    """The prune layer's own output is the unpruned one, and the next
    layer's vision input is CLS + keep of its rows, unchanged."""
    img, ids, pad = _inputs(seed=2)
    keep, layer = 5, 1
    full = _encoder()
    pruned = _same_weights(BEiT3Encoder(BEiT3Config(**KW, **PRUNE)), full)
    seen = {}

    def grab(name):
        def hook(module, args, out):
            seen.setdefault(name, []).append((args[0][0], out))
        return hook

    for name, enc in (("full", full), ("pruned", pruned)):
        for i in (layer, layer + 1):
            enc.encoder.layers[i].register_forward_hook(grab((name, i)))
        enc(img, ids, pad)
    (_, out_f), = seen[("full", layer)]
    (_, out_p), = seen[("pruned", layer)]
    out_p = out_p[0]  # (xs, cls_attn) at the prune layer
    torch.testing.assert_close(out_p[0], out_f[0], rtol=1e-6, atol=1e-6)
    (in_next, _), = seen[("pruned", layer + 1)]
    assert in_next.shape[1] == 1 + keep
    rows = out_f[0][:, 1:]
    for b in range(in_next.shape[0]):
        for r in in_next[b, 1:]:
            assert (rows[b] == r).all(dim=1).any()


@torch.no_grad()
def test_prune_model_token_branch_only():
    """A pruned SimVGModel serves the token branch: "both" maps to it, the
    decoder outputs are the head's dummies, "decoder" is refused."""
    model = _model(**PRUNE)
    img, ids, pad = _inputs()
    shp = torch.full((2, 2), 64)
    out = model(img, ids, pad, img_shape=shp)
    assert torch.isfinite(out["bbox_token"]).all()
    assert out["class_decoder"].abs().max().item() == 0.0
    assert (out["bbox_decoder"] == 0.5).all()
    with pytest.raises(ValueError, match="token branch only"):
        model(img, ids, pad, img_shape=shp, branches="decoder")


def test_prune_composes_with_export(tmp_path):
    """A pruned model exports, and the program's token predictions equal
    the eval step's."""
    from simvg_tpu_torch.engine import make_eval_step
    from simvg_tpu_torch.export import (export_serving, load_exported,
                                        save_exported)

    model = _model(**PRUNE)
    img, ids, pad = _inputs()
    batch = dict(image=img, text_ids=ids, text_padding_mask=pad,
                 img_shape=torch.full((2, 2), 64, dtype=torch.int32))
    f = str(tmp_path / "pruned.pt2")
    save_exported(f, export_serving(model, batch))
    out = load_exported(f).call(batch)
    direct = make_eval_step(model)(batch)
    for k in ("best_box", "best_score", "boxes", "scores"):
        torch.testing.assert_close(out["token"][k], direct["token"][k],
                                   rtol=0, atol=0)


def test_prune_refuses_training():
    model = _model(**PRUNE).train()
    img, ids, pad = _inputs()
    with pytest.raises(ValueError, match="serving-only"):
        model(img, ids, pad, img_shape=torch.full((2, 2), 64))


@torch.no_grad()
def test_prune_layer_default_clamps_explicit_rejects():
    """The default layer (4) clamps to L-2 on a shallow model; an explicit
    out-of-range layer raises."""
    enc = _encoder(token_prune_keep=5, token_prune_force=True)
    assert enc.prune_layer == 1
    assert enc(*_inputs())[0].shape[1] == 5
    with pytest.raises(ValueError, match="out of range"):
        BEiT3Encoder(BEiT3Config(**KW, token_prune_keep=5,
                                 token_prune_layer=2))


def test_prune_requires_unrolled_layers():
    cfg = dict(type="MIXDETRMB",
               vis_enc=dict(KW, token_prune_keep=12, token_prune_layer=1,
                            scan_layers=True),
               head=dict(HEAD))
    with pytest.raises(ValueError, match="scan_layers"):
        build_model(cfg, img_size=64, device="cpu")


@torch.no_grad()
def test_prune_envelope_guard():
    """The envelope (layer >= round(L/3), keep >= 75% of the patches) holds
    unless token_prune_force: 16 patches -> keep >= 12; 3 layers -> layer
    >= 1; 6 layers -> layer >= 2."""
    img, ids, pad = _inputs(seed=4)
    ok = _encoder(token_prune_keep=12, token_prune_layer=1)
    assert ok(img, ids, pad)[0].shape == (2, 12, 32)
    with pytest.raises(ValueError, match="measured-safe envelope"):
        BEiT3Encoder(BEiT3Config(**KW, token_prune_keep=11,
                                 token_prune_layer=1))
    forced = _encoder(token_prune_keep=11, token_prune_layer=1,
                      token_prune_force=True)
    assert forced(img, ids, pad)[0].shape == (2, 11, 32)
    with pytest.raises(ValueError, match="measured-safe envelope"):
        BEiT3Encoder(BEiT3Config(**dict(KW, num_layers=6),
                                 token_prune_keep=P, token_prune_layer=1))


def test_prune_envelope_through_builder():
    """token_prune_* flow through build_model: outside the envelope it
    raises, token_prune_force in the config dict unlocks it."""
    def cfg(**extra):
        return dict(type="MIXDETRMB",
                    vis_enc=dict(KW, token_prune_layer=1, **extra),
                    head=dict(HEAD))

    with pytest.raises(ValueError, match="measured-safe envelope"):
        build_model(cfg(token_prune_keep=5), img_size=64, device="cpu")
    forced, _ = build_model(cfg(token_prune_keep=5, token_prune_force=True),
                            img_size=64, device="cpu")
    init_random_weights(forced, 0)
    img, ids, pad = _inputs()
    with torch.no_grad():
        out = forced.eval()(img, ids, pad, img_shape=torch.full((2, 2), 64))
    assert torch.isfinite(out["bbox_token"]).all()
    assert forced.vis_enc["beit3"].prune_layer == 1


@pytest.fixture(scope="module")
def jax_init_params():
    """Params of JAX ``model.init`` on the tiny model (PRNGKey(11))."""
    params = jax.jit(jax_tiny_model().init)(jax.random.PRNGKey(11),
                                            **to_jax(np_batch()))
    return jax.tree.map(np.asarray, params)


def test_pruned_model_matches_jax(jax_init_params):
    """JAX and the port, pruned at layer 0 to keep 9 of 16 patches, on the
    same weights and batch (non-square valid extents): the same kept
    indices, token outputs within 1e-5, and the head's pad mask the
    unpruned mask's rows at the kept indices."""
    from simvg_tpu.models import SimVGConfig as JaxSimVGConfig
    from simvg_tpu.models import SimVGModel as JaxSimVGModel
    from simvg_tpu.models.beit3 import BEiT3Config as JaxBEiT3Config
    from simvg_tpu.models.beit3 import BEiT3Encoder as JaxEncoder
    from simvg_tpu.models.heads.tgqs_head import (
        TGQSHeadConfig as JaxHeadConfig)

    prune = dict(token_prune_keep=9, token_prune_layer=0,
                 token_prune_force=True)
    batch = np_batch(b=4, seed=3)
    jb = to_jax(batch)
    jcfg = JaxBEiT3Config(**TINY_BEIT3, **prune)
    jmodel = JaxSimVGModel(JaxSimVGConfig(beit3=jcfg,
                                          head=JaxHeadConfig(**TINY_HEAD)))
    out_j = jmodel.apply(jax_init_params, **jb)
    *_, idx_j = JaxEncoder(jcfg).apply(
        {"params": jax_init_params["params"]["beit3"]}, jb["image"],
        jb["text_ids"], jb["text_padding_mask"], return_prune_idx=True)

    port = SimVGModel(SimVGConfig(
        beit3=BEiT3Config(**TINY_BEIT3, **prune),
        head=TGQSHeadConfig(**TINY_HEAD)))
    load_jax_params(port, jax_init_params)
    port.eval()
    tb = to_torch(batch)
    masks = []
    port.head.register_forward_pre_hook(
        lambda m, args: masks.append(args[1]))
    with torch.no_grad():
        out_t = port(tb["image"], tb["text_ids"], tb["text_padding_mask"],
                     img_shape=tb["img_shape"])
        *_, idx_t = port.vis_enc["beit3"](
            tb["image"], tb["text_ids"], tb["text_padding_mask"],
            return_prune_idx=True)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    for k in ("class_token", "bbox_token", "class_decoder", "bbox_decoder"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    full = SimVGModel._img_pad_mask(4, 64, 64, 4, 4, tb["img_shape"],
                                    "cpu").reshape(4, 16)
    want = np.take_along_axis(full.numpy(), np.asarray(idx_j), axis=1)
    np.testing.assert_array_equal(masks[0][:, :, 0].numpy(), want)


@pytest.mark.parametrize("quant", ["int8", "int8_static"])
def test_prune_composes_with_int8(jax_init_params, quant, tmp_path):
    """Both serving levers together (tests/test_token_prune.py): the
    encoder pruned after layer 0 with w8a8 Linears keeps 5 patches, and
    matches the JAX encoder
    on the same weights and quant collection (int8_static: the port's
    calibration, read by JAX's load_quant_collection) within the int8
    bounds (``util_torch_port.assert_int8_close``), with the same kept
    indices."""
    from simvg_tpu.models.beit3 import BEiT3Config as JaxBEiT3Config
    from simvg_tpu.models.beit3 import BEiT3Encoder as JaxEncoder
    from simvg_tpu.ops.quant import load_quant_collection
    from simvg_tpu_torch.ops import quant as q

    kw = dict(TINY_BEIT3, **dict(PRUNE, token_prune_layer=0))
    params = {"params": jax_init_params["params"]["beit3"]}
    port = BEiT3Encoder(BEiT3Config(**kw, quant=quant)).eval()
    sd = export_simvg_full({"params": {"beit3": params["params"]}})
    port.load_state_dict({k[len("vis_enc.beit3."):]: torch.from_numpy(v)
                          for k, v in sd.items()}, strict=True)
    batch = np_batch(b=3, seed=4)
    args = [batch[k] for k in ("image", "text_ids", "text_padding_mask")]
    variables = dict(params)
    if quant == "int8_static":
        calib = BEiT3Encoder(BEiT3Config(**kw, quant="int8_calib")).eval()
        calib.load_state_dict(port.state_dict(), strict=True)
        with torch.no_grad():
            calib(*map(torch.from_numpy, args))
        npz = str(tmp_path / "q.npz")
        q.save_quant_collection(npz, q.build_quant_collection(
            calib, q.calibration_amax(calib)))
        q.attach_static_quant(port, npz)
        variables["quant"] = load_quant_collection(npz)
    *out_j, idx_j = JaxEncoder(JaxBEiT3Config(**kw, quant=quant)).apply(
        variables, *map(jnp.asarray, args), return_prune_idx=True)
    with torch.no_grad():
        *out_t, idx_t = port(*map(torch.from_numpy, args),
                             return_prune_idx=True)
    assert out_t[0].shape == (3, 5, 32)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    for a, b in zip(out_t, out_j):
        assert torch.isfinite(a).all()
        assert_int8_close(a.numpy(), b)


def test_stable_top_k_pins_the_lower_index_on_ties():
    """Scores whose ties straddle the K-th place: the same indices as
    ``jax.lax.top_k`` then a sort, the lower index kept."""
    r = np.random.default_rng(0)
    scores = np.round(r.uniform(size=(6, 40)) * 4) / 4  # 5 values, many ties
    scores[0] = 0.5  # all equal: the first K win
    scores = scores.astype(np.float32)
    for k in (1, 7, 20, 39):
        want = np.sort(np.asarray(jax.lax.top_k(jnp.asarray(scores), k)[1]),
                       axis=1)
        got = stable_top_k(torch.from_numpy(scores), k).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        stable_top_k(torch.from_numpy(scores), 7).numpy()[0], np.arange(7))


def test_pruned_cls_attention_equals_the_plain_row():
    """The prune layer's CLS row ([B, H, 1, S] product) equals row 0 of the
    plain path's probabilities, averaged over heads."""
    from simvg_tpu_torch.ops.attention import (cls_attention,
                                               multihead_attention)

    r = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(r.normal(size=(2, 30, 64)).astype(
        np.float32)) for _ in range(3))
    pad = torch.zeros(2, 30, dtype=torch.bool)
    pad[1, 25:] = True
    _, probs = multihead_attention(q, k, v, num_heads=4, key_padding_mask=pad,
                                   return_weights=True)
    got = cls_attention(q, k, num_heads=4, key_padding_mask=pad)
    torch.testing.assert_close(got, probs[:, :, 0].mean(1), rtol=0,
                               atol=1e-7)
