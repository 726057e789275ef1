"""The demo and inference CLIs of simvg_tpu_torch and what they share with the
server, against simvg_tpu, on the CPU.

- ``RawPreprocessor``: the sample of a JPEG and an expression equals JAX's
  (text, img_shape, scale_factor exact; the image within one uint8 level
  of the one resampling, over std after Normalize: cv2's fixed-point
  resize against F.interpolate), with and without ``normalize_on_device``;
- the demo's box and score, and the inference CLI's boxes and scores
  (GRefCOCO: those at or above ``--score-threshold``), equal JAX
  ``make_eval_step``'s on the same batch divided by ``scale_factor``,
  within 1e-4 (tests/test_torch_model.py's eval-step bound), on weights of
  JAX ``model.init`` exported with ``simvg_tpu_torch.convert``;
- ``--with-attn``: the recorded cross-attention equals the JAX CLI's
  ``attn_weights`` intermediate averaged over heads (1e-5), and the overlay
  files are written;
- drawing: the JET table equals ``cv2.applyColorMap`` on all 256 levels;
  box outlines equal ``cv2.rectangle``'s (thickness 2) on every pixel of
  60 random boxes, in and out of the image; the heat-map overlay is within
  the stated levels of cv2's resize, applyColorMap and addWeighted.
"""

import json
import os
import os.path as osp

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util_synth import make_grefcoco_style, make_refcoco_style

from simvg_tpu_torch.config import Config, parse_cfg_options
from simvg_tpu_torch.convert import export_simvg_full
from simvg_tpu_torch.data.raw import RawPreprocessor
from simvg_tpu_torch.tools import demo as demo_cli
from simvg_tpu_torch.tools import inference as inference_cli
from simvg_tpu_torch.utils.checkpoint import save_checkpoint
from simvg_tpu_torch.utils.visualize import (attention_overlay, draw_boxes,
                                             jet_table)
from util_torch_port import cheap_jit, one_torch_thread  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY = osp.join(REPO, "configs", "smoke", "tiny_synth.py")
GREC = osp.join(REPO, "configs", "smoke", "tiny_synth_grec.py")
STD = np.asarray([58.395, 57.12, 57.375], np.float32)
KEYS = ("image", "text_ids", "text_padding_mask", "img_shape")
BOX_TOL = 1e-4


def _jpeg(path, h=96, w=128, seed=3):
    img = np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)
    cv2.imwrite(str(path), img)
    with open(path, "rb") as f:
        return f.read()


def _cfgs(path, opts=()):
    """(the port's Config, the JAX package's Config) of one file."""
    from simvg_tpu.config import Config as JaxConfig
    from simvg_tpu.config import parse_cfg_options as jax_options

    cfg, jcfg = Config.fromfile(path), JaxConfig.fromfile(path)
    cfg.merge_from_dict(parse_cfg_options(list(opts)))
    jcfg.merge_from_dict(jax_options(list(opts)))
    return cfg, jcfg


# one JAX model, its jitted init and its jitted eval step for each model
# config, shared by the tests: each program compiles once per shape
_JAX = {}


def _jax_model(jcfg):
    """(model, jitted init, jitted eval step) of the config's model."""
    from simvg_tpu.engine.train import make_eval_step
    from simvg_tpu.models.builder import build_model

    key = json.dumps(jcfg.model, sort_keys=True, default=str)
    if key not in _JAX:
        model, _ = build_model(jcfg.model, img_size=64, dtype=jnp.float32)
        _JAX[key] = (model, cheap_jit(model.init),
                     cheap_jit(make_eval_step(model)))
    return _JAX[key]


def _jax_model_and_checkpoint(jcfg, work, seed):
    """JAX ``model.init`` params of the config's model and a port
    checkpoint of them under ``work``."""
    model, init, _ = _jax_model(jcfg)
    t = jcfg.get("max_token", 20)
    dummy = dict(image=jnp.zeros((1, 64, 64, 3), jnp.float32),
                 text_ids=jnp.zeros((1, t), jnp.int32),
                 text_padding_mask=jnp.zeros((1, t), jnp.int32),
                 img_shape=jnp.full((1, 2), 64, jnp.int32))
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed),
                                           **dummy))
    sd = {k: torch.from_numpy(v.copy())
          for k, v in export_simvg_full(params).items()}
    return model, params, save_checkpoint(str(work), "from_jax", params=sd,
                                          block=True)


def _jax_preds(model, params, batch):
    step = next(step for m, _, step in _JAX.values() if m is model)
    preds = step(params, {k: jnp.asarray(np.asarray(batch[k]))
                          for k in KEYS})
    return jax.tree.map(np.asarray, preds)


@pytest.mark.parametrize("norm_on_device", [False, True])
def test_raw_preprocessor_matches_jax(tmp_path, norm_on_device):
    from simvg_tpu.data.loader import collate as jax_collate
    from simvg_tpu.data.raw import RawPreprocessor as JaxRaw

    opts = [f"normalize_on_device={norm_on_device}"]
    cfg, jcfg = _cfgs(TINY, opts)
    data = _jpeg(tmp_path / "raw.jpg")
    expr = "the red box on the left"
    jpre = JaxRaw(jcfg)
    js = jpre(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
              expr)
    want = jax_collate([js], canvas=64, max_gt=1)
    pre = RawPreprocessor(cfg, "cpu")
    got = pre.collate([pre(data, expr)])
    for k in ("text_ids", "text_padding_mask", "img_shape", "scale_factor"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert pre.device_norm == jpre.device_norm
    diff = np.abs(got["image"].numpy().astype(np.float32)
                  - np.asarray(want["image"], np.float32))
    bound = 1.0 if norm_on_device else 1.0 / STD + 1e-5
    assert got["image"].dtype == (torch.uint8 if norm_on_device
                                  else torch.float32)
    assert (diff <= bound).all(), diff.max()


def test_demo_matches_jax_eval_step(tmp_path, capsys):
    """The demo's printed and returned box (original scale) and score: JAX
    ``make_eval_step`` on the same batch, divided by scale_factor."""
    cfg, jcfg = _cfgs(TINY)
    model, params, ckpt = _jax_model_and_checkpoint(jcfg, tmp_path, 4)
    img = tmp_path / "raw.jpg"
    data = _jpeg(img)
    expr = "the green box"
    out_dir = tmp_path / "demo_out"
    res = demo_cli.main(["--config", TINY, "--checkpoint", ckpt,
                         "--img", str(img), "--expression", expr,
                         "--output-dir", str(out_dir), "--device", "cpu"])
    pre = RawPreprocessor(cfg, "cpu")
    batch = pre.collate([pre(data, expr)])
    want = _jax_preds(model, params, batch)["token"]
    sf = batch["scale_factor"][0]
    np.testing.assert_allclose(res["box"], want["best_box"][0] / sf,
                               atol=BOX_TOL, rtol=0)
    assert abs(res["score"] - float(want["best_score"][0])) <= BOX_TOL
    assert max(res["box"]) <= 128 + 1e-3  # the 96x128 original's scale
    assert "box (xyxy, original scale)" in capsys.readouterr().out
    out = out_dir / "raw_pred.jpg"
    assert cv2.imread(str(out)).shape == (96, 128, 3)
    with open(str(out) + ".json") as f:
        record = json.load(f)
    assert record["expression"] == expr
    np.testing.assert_allclose(record["pred_boxes"], [res["box"]])


def _loader_batches(cfg, split="val", max_gt=1):
    from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                              build_loader_from_cfg)

    ds = build_dataset_from_cfg(cfg.data[split], dataset_type=cfg.dataset)
    return list(build_loader_from_cfg(ds, cfg, train=False, canvas=64,
                                      max_gt=max_gt, device="cpu"))


def test_inference_cli_matches_jax_with_attention(tmp_path):
    """Every written image's box and score equal JAX's on the same loader
    batch / scale_factor; the overlays are written; the recorded
    cross-attention equals the JAX intermediate the JAX CLI reads."""
    imgdir, ann = make_refcoco_style(str(tmp_path / "synth"), 2, 6)
    opts = [f"data.{s}.{k}={v}" for s in ("train", "val")
            for k, v in (("annsfile", ann), ("imgsfile", imgdir))]
    cfg, jcfg = _cfgs(TINY, opts)
    model, params, ckpt = _jax_model_and_checkpoint(jcfg, tmp_path, 6)
    out = tmp_path / "vis"
    records = inference_cli.main([TINY, ckpt, "--output-dir", str(out),
                                  "--with-attn", "--max-images", "5",
                                  "--device", "cpu", "--cfg-options", *opts])
    assert len(records) == 5
    files = sorted(os.listdir(out))
    assert len([f for f in files if f.endswith("_attn.jpg")]) == 5
    assert len([f for f in files if f.endswith(".jpg.json")]) == 5

    batches = _loader_batches(cfg)
    want_boxes, want_scores = [], []
    for batch in batches:
        p = _jax_preds(model, params, batch)["token"]
        for i in np.flatnonzero(batch["batch_valid"]):
            want_boxes.append(p["best_box"][i][None]
                              / batch["scale_factor"][i])
            want_scores.append(p["best_score"][i][None])
    for rec, box, score in zip(records, want_boxes, want_scores):
        np.testing.assert_allclose(rec["boxes"], box, atol=BOX_TOL, rtol=0)
        np.testing.assert_allclose(rec["scores"], score, atol=BOX_TOL,
                                   rtol=0)

    # the attention the overlays are made from, against JAX's
    from simvg_tpu_torch.engine import make_eval_step
    from simvg_tpu_torch.models.heads.detr_transformer import (
        recorded_cross_attention)
    from simvg_tpu_torch.tools.test import serving_model

    port = serving_model(cfg, ckpt, torch.device("cpu"))
    batch = batches[0]
    with recorded_cross_attention(port.head.transformer.decoder) as w:
        make_eval_step(port)({k: torch.as_tensor(batch[k]) for k in KEYS})
    _, inter = cheap_jit(lambda p, b: model.apply(
        p, **b, deterministic=True, mutable=["intermediates"]))(
        params, {k: jnp.asarray(np.asarray(batch[k])) for k in KEYS})
    dec = inter["intermediates"]["head"]["decoder"]
    last = sorted((k for k in dec if "cross_attn" in dec[k]),
                  key=lambda k: int(k.rsplit("_", 1)[-1]))[-1]
    (jw,) = dec[last]["cross_attn"]["attn_weights"]
    np.testing.assert_allclose(w[-1].float().mean(1).numpy(),
                               np.asarray(jw).mean(axis=1), atol=1e-5,
                               rtol=0)


def test_inference_cli_grec_threshold_matches_jax(tmp_path):
    """GRefCOCO: the boxes at or above --score-threshold, each equal to
    JAX's / scale_factor; the threshold falls between two of JAX's scores
    so that some queries are kept and some dropped."""
    imgdir, ann = make_grefcoco_style(str(tmp_path / "grec"), n=6)
    opts = [f"data.{s}.{k}={v}" for s in ("train", "val")
            for k, v in (("annsfile", ann), ("imgsfile", imgdir))]
    cfg, jcfg = _cfgs(GREC, opts)
    model, params, ckpt = _jax_model_and_checkpoint(jcfg, tmp_path, 8)
    from simvg_tpu_torch.tools.train import gt_settings

    batches = _loader_batches(cfg, max_gt=gt_settings(cfg)[1])
    preds = [_jax_preds(model, params, b)["token"] for b in batches]
    scores = np.sort(np.concatenate([p["scores"].ravel() for p in preds]))
    mid = len(scores) // 2
    assert scores[mid] - scores[mid - 1] > 4 * BOX_TOL
    thr = float(scores[mid - 1] + scores[mid]) / 2
    records = inference_cli.main([GREC, ckpt, "--output-dir",
                                  str(tmp_path / "vis"), "--max-images", "6",
                                  "--score-threshold", str(thr),
                                  "--device", "cpu", "--cfg-options", *opts])
    assert len(records) == 6
    kept = []
    for batch, p in zip(batches, preds):
        for i in np.flatnonzero(batch["batch_valid"]):
            keep = p["scores"][i] >= thr
            kept.append(int(keep.sum()))
            rec = records[len(kept) - 1]
            np.testing.assert_allclose(
                np.asarray(rec["boxes"]).reshape(-1, 4),
                p["boxes"][i][keep] / batch["scale_factor"][i],
                atol=BOX_TOL, rtol=0)
            np.testing.assert_allclose(rec["scores"], p["scores"][i][keep],
                                       atol=BOX_TOL, rtol=0)
    assert 0 < sum(kept) < 6 * p["scores"].shape[1], kept


def test_jet_table_equals_cv2():
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_JET)[:, 0, :]
    np.testing.assert_array_equal(jet_table().numpy(), lut)


def test_box_outlines_equal_cv2_rectangle():
    """Every pixel of 60 random outlines (corners in either order, partly
    outside the image) equals cv2.rectangle's, thickness 2."""
    r = np.random.default_rng(0)
    for _ in range(60):
        img = r.integers(0, 255, (40, 50, 3), np.uint8)
        box = r.uniform(-10, 60, 4)
        want = img.copy()
        cv2.rectangle(want, (int(box[0]), int(box[1])),
                      (int(box[2]), int(box[3])), (0, 0, 255), 2)
        got = draw_boxes(torch.from_numpy(img.copy()), box, (0, 0, 255))
        np.testing.assert_array_equal(got.numpy(), want)


def test_attention_overlay_close_to_cv2():
    """The overlay against cv2's resize -> applyColorMap -> addWeighted on
    the same map: F.interpolate may land one level away from cv2's
    fixed-point resize, which moves the JET colour by one step (at most 8
    levels a channel in the table) and the 0.45-weighted blend by at most
    4.  Upsampled 24-32x, the two resizes part on ~5% of the pixels here;
    at least 90% must agree exactly."""
    r = np.random.default_rng(1)
    img = r.integers(0, 255, (96, 128, 3), np.uint8)
    amap = r.uniform(size=(4, 4)).astype(np.float32)
    got = attention_overlay(torch.from_numpy(img), torch.from_numpy(amap))
    a = amap / max(float(amap.max()), 1e-8)
    heat = cv2.applyColorMap(cv2.resize((a * 255).astype(np.uint8),
                                        (128, 96)), cv2.COLORMAP_JET)
    want = cv2.addWeighted(img, 0.55, heat, 0.45, 0)
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 4, diff.max()
    assert (diff == 0).mean() >= 0.90, (diff == 0).mean()


@pytest.mark.parametrize("cli,argv", [
    ("demo", ["--config", TINY, "--img", "x.jpg", "--expression", "x"]),
    ("inference", [TINY, "ckpt"]),
    ("serve", [TINY]),
    ("export_serving", [TINY]),
    ("prune_envelope", [TINY, "ckpt"]),
    ("inference_time", [TINY]),
])
def test_serving_clis_default_to_the_card(cli, argv):
    """Every serving CLI runs on the card unless told --device cpu, and
    raises where there is none (no fallback to the CPU)."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    mod = importlib.import_module(f"simvg_tpu_torch.tools.{cli}")
    entry = mod.build_server if cli == "serve" else mod.main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(argv)


def test_inference_time_writes_a_gzipped_trace(tmp_path):
    """``inference_time --trace-dir DIR`` writes a torch.profiler Chrome
    trace of one step, gzipped, into DIR and returns its path, as the JAX
    tool's flag writes its trace; the file opens as JSON with the step's
    events."""
    import gzip
    import json

    from simvg_tpu_torch.tools import inference_time

    out = inference_time.main([TINY, "--device", "cpu", "--iters", "1",
                               "--warmup", "0", "--trace-dir",
                               str(tmp_path / "trace")])
    assert out["trace"] == str(tmp_path / "trace"
                               / "inference_time.pt.trace.json.gz")
    with gzip.open(out["trace"], "rt") as f:
        events = json.load(f)["traceEvents"]
    assert any("linear" in str(e.get("name", "")) for e in events)
