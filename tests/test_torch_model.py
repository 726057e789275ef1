"""simvg_tpu_torch's model held against simvg_tpu's on the same weights.

The JAX side runs as its own tests run it: float32 on the CPU under the
repo's conftest (matmul precision "highest").  Tolerances are the ones
the repo already holds torch against: 2e-5 for the encoder and head
(tests/test_checkpoint_convert.py) and 1e-5 for the full model
(tests/test_converter_e2e.py).
"""

import ast
import glob
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from util_torch_port import (cheap_jit, jax_tiny_model, np_batch, to_jax,
                             to_torch, torch_tiny_model)
from util_torch_port import one_torch_thread  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(REPO, "tests", "fixtures", "simvg_full_tiny.pth")
FLAGSHIP = "configs/single/ViT-base/refcoco/refcoco_onestage.py"
OUT_KEYS = ("class_decoder", "bbox_decoder", "class_token", "bbox_token")
# top-level modules absent from the GPU machine, and the JAX package itself
NOT_ON_THE_CARD = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2",
                   "simvg_tpu")


@pytest.fixture(scope="module")
def jax_pair():
    """(model, params) of the tiny JAX model, params from PRNGKey(7)."""
    model = jax_tiny_model()
    params = cheap_jit(model.init)(jax.random.PRNGKey(7), **to_jax(np_batch()))
    return model, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def torch_model(jax_pair):
    from simvg_tpu_torch.convert import load_jax_params

    return load_jax_params(torch_tiny_model(), jax_pair[1])


def _assert_outputs(out_t, out_j, atol, keys=OUT_KEYS):
    for k in keys:
        np.testing.assert_allclose(out_t[k].detach().numpy(),
                                   np.asarray(out_j[k]), atol=atol,
                                   rtol=0, err_msg=k)


def test_fixture_loads_strict_and_matches_jax():
    model = torch_tiny_model()
    sd = torch.load(FIXTURE, map_location="cpu")["state_dict"]
    model.load_state_dict(sd, strict=True)

    batch = np_batch()
    ref_model = jax_tiny_model()
    # the fixture was generated from PRNGKey(1234) on this config
    ref_params = cheap_jit(ref_model.init)(jax.random.PRNGKey(1234),
                                           **to_jax(batch))
    out_j = cheap_jit(ref_model.apply)(ref_params, **to_jax(batch))
    with torch.no_grad():
        out_t = model(**to_torch(batch))
    _assert_outputs(out_t, out_j, atol=1e-5)


def test_load_jax_params_matches_jax_forward(jax_pair, torch_model):
    model, params = jax_pair
    batch = np_batch(seed=1)
    out_j = cheap_jit(model.apply)(params, **to_jax(batch))
    with torch.no_grad():
        out_t = torch_model(**to_torch(batch))
    _assert_outputs(out_t, out_j, atol=1e-5)
    for k in ("token_features", "decoder_features"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("branches", ["token", "decoder"])
def test_single_branch_and_dummy_outputs_match_jax(jax_pair, torch_model,
                                                   branches):
    model, params = jax_pair
    batch = np_batch(seed=2)
    out_j = cheap_jit(model.apply, static_argnames="branches")(
        params, **to_jax(batch), branches=branches)
    with torch.no_grad():
        out_t = torch_model(**to_torch(batch), branches=branches)
    _assert_outputs(out_t, out_j, atol=1e-5,
                    keys=OUT_KEYS + ("decoder_features",))
    dummy = "class_token" if branches == "decoder" else "class_decoder"
    assert not out_t[dummy].any()


def test_encoder_alone_matches_jax(jax_pair, torch_model):
    from simvg_tpu.models.beit3 import BEiT3Encoder

    model, params = jax_pair
    batch = np_batch(seed=3)
    enc = BEiT3Encoder(model.cfg.beit3)
    out_j = cheap_jit(enc.apply)({"params": params["params"]["beit3"]},
                                 jnp.asarray(batch["image"]),
                                 jnp.asarray(batch["text_ids"]),
                                 jnp.asarray(batch["text_padding_mask"]))
    tb = to_torch(batch)
    with torch.no_grad():
        out_t = torch_model.vis_enc["beit3"](tb["image"], tb["text_ids"],
                                             tb["text_padding_mask"])
    for name, a, b in zip(("img", "text", "cls"), out_t, out_j):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=0, err_msg=name)


def test_head_alone_matches_jax(jax_pair, torch_model):
    from simvg_tpu.models.heads.tgqs_head import TGQSKDDETRHead

    model, params = jax_pair
    r = np.random.default_rng(4)
    b, t = 3, 6
    x_mm = r.normal(size=(b, 4, 4, 32)).astype(np.float32)
    pad = np.zeros((b, 4, 4), bool)
    pad[1, 3:, :] = True
    pad[2, :, 2:] = True
    cls = r.normal(size=(b, 32)).astype(np.float32)
    text = r.normal(size=(b, t, 32)).astype(np.float32)
    tmask = np.array([[0] * t, [0, 0, 0, 1, 1, 1], [0, 1, 1, 1, 1, 1]],
                     np.int32)
    head = TGQSKDDETRHead(model.cfg.head)
    out_j = cheap_jit(head.apply)({"params": params["params"]["head"]},
                                  *map(jnp.asarray,
                                       (x_mm, pad, cls, text, tmask)))
    with torch.no_grad():
        out_t = torch_model.head(*map(torch.from_numpy,
                                      (x_mm, pad, cls, text, tmask)))
    _assert_outputs(out_t, out_j, atol=2e-5)


def test_eval_step_and_prec_match_jax(jax_pair, torch_model):
    from simvg_tpu.engine.metrics import detection_accuracy as jax_acc
    from simvg_tpu.engine.train import make_eval_step as jax_eval_step
    from simvg_tpu_torch.engine import detection_accuracy, make_eval_step

    model, params = jax_pair
    batch = np_batch(b=4, seed=5)
    preds_j = cheap_jit(jax_eval_step(model))(params, to_jax(batch))
    preds_t = make_eval_step(torch_model)(to_torch(batch))
    gt = np.asarray(preds_j["decoder"]["best_box"]) + 3.0
    valid = np.array([1, 1, 1, 0], bool)
    for branch in ("decoder", "token"):
        for k in ("boxes", "scores", "best_box", "best_score"):
            np.testing.assert_allclose(
                preds_t[branch][k].numpy(), np.asarray(preds_j[branch][k]),
                atol=1e-4, rtol=1e-5, err_msg=f"{branch}/{k}")
        for k in ("labels", "best_label"):
            np.testing.assert_array_equal(preds_t[branch][k].numpy(),
                                          np.asarray(preds_j[branch][k]))
        box = preds_t[branch]["best_box"].numpy()
        assert detection_accuracy(box, gt, valid) == jax_acc(box, gt, valid)


def test_eval_step_runs_in_eval_mode_after_training(torch_model):
    """An eval step made before training still evaluates in eval mode
    after a train-mode forward (the train CLI evaluates between epochs)."""
    from simvg_tpu_torch.engine import make_eval_step

    step = make_eval_step(torch_model)
    batch = to_torch(np_batch())
    first = step(batch)
    torch_model.train()
    second = step(batch)
    assert not torch_model.training
    for branch in first:
        for k in first[branch]:
            assert torch.equal(first[branch][k], second[branch][k])


def test_evaluate_counts_valid_rows(torch_model):
    from simvg_tpu_torch.engine import evaluate, make_eval_step

    batch = np_batch(b=4, seed=6)
    preds = make_eval_step(torch_model)(to_torch(batch))
    exact = preds["decoder"]["best_box"].numpy()
    loader = [dict(batch, gt_boxes=exact[:, None, :],
                   batch_valid=np.array([1, 1, 1, 0], bool))]
    out = evaluate(torch_model, loader)
    assert out["n_samples"] == 3.0
    assert out["decoder_det_acc"] == pytest.approx(100.0)
    assert out["decoder_miou"] == pytest.approx(100.0)
    # max_batches stops early; log_fn hears every log_interval batches
    lines = []
    out = evaluate(torch_model, loader * 3, max_batches=2, log_interval=1,
                   log_fn=lines.append)
    assert out["n_samples"] == 6.0
    assert lines == ["eval [1/2]", "eval [2/2]"]


def test_device_normalization_matches_jax():
    from simvg_tpu.data.prefetch import normalize_images_on_device as jnorm
    from simvg_tpu_torch.engine import normalize_images_on_device

    r = np.random.default_rng(8)
    img = r.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    shape = np.array([[8, 5], [3, 8]], np.int32)
    mean, std = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]
    out_j = jnorm(jnp.asarray(img), mean, std, True, jnp.asarray(shape))
    out_t = normalize_images_on_device(torch.from_numpy(img), mean, std,
                                       True, torch.from_numpy(shape))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-6,
                               rtol=0)


def test_config_loader_matches_jax_package_on_every_config():
    from simvg_tpu.config import Config as JaxConfig
    from simvg_tpu_torch.config import Config

    paths = sorted(glob.glob(osp.join(REPO, "configs", "**", "*.py"),
                             recursive=True))
    assert len(paths) > 50
    for path in paths:
        assert Config.fromfile(path) == JaxConfig.fromfile(path), path
    flagship = Config.fromfile(osp.join(REPO, FLAGSHIP))
    assert flagship.model.vis_enc.attn_impl == "pallas"


def test_cfg_options_merge_and_dump_match_jax_package(tmp_path):
    from simvg_tpu.config import Config as JaxConfig
    from simvg_tpu.config import parse_cfg_options as jax_parse
    from simvg_tpu_torch.config import Config, parse_cfg_options

    pairs = ["model.head.num_queries=10", "data.samples_per_gpu=4",
             "data.train.annsfile=/data/x.json", "new.key.deep=[1, 2]",
             "lr=1e-4", "ema=True", "work_dir=runs/a=b"]
    assert parse_cfg_options(pairs) == jax_parse(pairs)
    a = Config.fromfile(osp.join(REPO, FLAGSHIP))
    b = JaxConfig.fromfile(osp.join(REPO, FLAGSHIP))
    a.merge_from_dict(parse_cfg_options(pairs))
    b.merge_from_dict(jax_parse(pairs))
    assert a == b
    assert a.model.head.num_queries == 10 and a.new.key.deep == [1, 2]
    a.dump(str(tmp_path / "a.py"))
    b.dump(str(tmp_path / "b.py"))
    assert (tmp_path / "a.py").read_text() == (tmp_path / "b.py").read_text()


def test_flagship_config_builds_on_meta():
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.models import build_model

    cfg = Config.fromfile(osp.join(REPO, FLAGSHIP))
    model, loss_cfg = build_model(cfg.model, img_size=cfg.img_size,
                                  dtype=torch.bfloat16, device="meta")
    enc = model.cfg.beit3
    assert (enc.num_layers, enc.embed_dim, enc.num_heads) == (12, 768, 12)
    assert enc.seq_vision + cfg.max_token == 421
    assert enc.attn_impl == "pallas"
    assert len(model.vis_enc["beit3"].encoder.layers) == 12
    assert model.cfg.head.num_tgqg_layers == 2
    assert loss_cfg["pretrain"] == cfg.model["vis_enc"]["pretrain"]
    assert all(p.is_meta for p in model.parameters())


TINY_MODEL_CFG = dict(
    type="MIXDETRMB",
    vis_enc=dict(img_size=64, patch_size=16, embed_dim=32, num_heads=4,
                 ffn_dim=64, num_layers=2, vocab_size=80),
    head=dict(num_queries=2, in_channels=32, embed_dim=32,
              num_decoder_layers=2, num_tgqg_layers=1))


def test_build_model_builds_on_the_cpu_when_asked():
    from simvg_tpu_torch.models import build_model

    model, _ = build_model(TINY_MODEL_CFG, img_size=64, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_build_model_defaults_to_the_card():
    """No device given: the model is built on the card, and where there is
    none the build raises instead of falling back to the CPU."""
    from simvg_tpu_torch.models import build_model

    if torch.cuda.is_available():
        model, _ = build_model(TINY_MODEL_CFG, img_size=64)
        assert {p.device.type for p in model.parameters()} == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(TINY_MODEL_CFG, img_size=64)


def test_port_imports_no_jax():
    code = (
        "import sys, simvg_tpu_torch, simvg_tpu_torch.models, "
        "simvg_tpu_torch.engine, simvg_tpu_torch.convert, "
        "simvg_tpu_torch.config, simvg_tpu_torch.ops.boxes, "
        "simvg_tpu_torch.ops.sine_embed, simvg_tpu_torch.losses, "
        "simvg_tpu_torch.engine.train, simvg_tpu_torch.engine.train_state, "
        "simvg_tpu_torch.ops.hungarian, simvg_tpu_torch.data.builder, "
        "simvg_tpu_torch.data.datasets, simvg_tpu_torch.data.image_ops, "
        "simvg_tpu_torch.data.jpeg, simvg_tpu_torch.data.loader, "
        "simvg_tpu_torch.data.spm, simvg_tpu_torch.data.tokenization, "
        "simvg_tpu_torch.data.transforms, simvg_tpu_torch.utils.checkpoint, "
        "simvg_tpu_torch.utils.logger, simvg_tpu_torch.tools.train, "
        "simvg_tpu_torch.tools.test, simvg_tpu_torch.tools.make_synth_data, "
        "simvg_tpu_torch.tools.jpeg_divergence, "
        "simvg_tpu_torch.tools.distill_proof_big, simvg_tpu_torch.export, "
        "simvg_tpu_torch.data.raw, simvg_tpu_torch.utils.visualize, "
        "simvg_tpu_torch.tools.demo, simvg_tpu_torch.tools.inference, "
        "simvg_tpu_torch.tools.serve, simvg_tpu_torch.tools.export_serving, "
        "simvg_tpu_torch.tools.prune_envelope, "
        "simvg_tpu_torch.tools.inference_time, simvg_tpu_torch.ops.quant, "
        "simvg_tpu_torch.tools.quantize_serving, simvg_tpu_torch.ops.rle, "
        "simvg_tpu_torch.ops.raster, simvg_tpu_torch.losses.distill, "
        "simvg_tpu_torch.engine.evaluate, simvg_tpu_torch.engine.metrics, "
        "simvg_tpu_torch.models.vis_enc_zoo, simvg_tpu_torch.models.lan_encs, "
        "simvg_tpu_torch.models.vis_encs, "
        "simvg_tpu_torch.models.fusion, "
        "simvg_tpu_torch.models.heads.simple_head, "
        "simvg_tpu_torch.tools.vis_cam, simvg_tpu_torch.tools.heatmap, "
        "simvg_tpu_torch.tools.attn_visual, simvg_tpu_torch.tools.parameters, "
        "simvg_tpu_torch.tools.browse_dataset, "
        "simvg_tpu_torch.tools.dataset_token_count, "
        "simvg_tpu_torch.tools.encoder_ablation, simvg_tpu_torch.ops._build, "
        "simvg_tpu_torch.models.beit3_heads, "
        "simvg_tpu_torch.models.legacy_layers, "
        "simvg_tpu_torch.losses.legacy, simvg_tpu_torch.data.vgtr_aug\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{NOT_ON_THE_CARD + ('tools',)})\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_chip_smoke_imports_nothing_of_jax_or_the_jax_package():
    with open(osp.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    imported = {alias.name for node in ast.walk(tree)
                if isinstance(node, ast.Import) for alias in node.names}
    imported |= {node.module for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) and node.module}
    assert "simvg_tpu_torch.engine" in imported
    bad = sorted(m for m in imported
                 if m.split(".")[0] in NOT_ON_THE_CARD)
    assert not bad, bad
