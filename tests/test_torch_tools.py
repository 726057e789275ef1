"""The config-facing tools of simvg_tpu_torch (``simvg_tpu_torch/tools``:
vis_cam, heatmap, attn_visual, parameters, browse_dataset,
dataset_token_count, encoder_ablation) and the root-level
``jax_checkpoint_to_torch.py``, in-process on the CPU, against the JAX
package's ``tools/misc`` on the same weights and batches.

- ``compute_cam`` of both families (the tiny flagship and the tiny
  OneStageModel) within 1e-4 of each map's max of JAX's;
- the decoder's cross-attention maps within 1e-5 of JAX's
  ``intermediates``;
- ``parameters`` and ``dataset_token_count`` print JAX's output line for
  line;
- ``browse_dataset``, ``vis_cam``, ``attn_visual`` and ``heatmap`` write
  their files and print the contracts of tests/test_misc_tools.py;
- a JAX orbax checkpoint of each family, converted, loads ``strict=True``
  and the port's test CLI on it gives JAX ``evaluate``'s Prec@0.5;
- ``tools/misc/summarize_run.py`` reads the port's ``metrics.jsonl``.
"""

import contextlib
import io
import os
import os.path as osp
import re
import runpy
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from util_synth import make_refcoco_style

from simvg_tpu_torch.convert import export_params
from test_torch_onestage import random_params
from util_torch_port import cheap_jit

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY = osp.join(REPO, "configs", "smoke", "tiny_synth.py")
ONESTAGE = osp.join(REPO, "configs", "smoke", "tiny_synth_onestage.py")
FAMILIES = {"MIXDETRMB": TINY, "OneStageModel": ONESTAGE}
INPUTS = ("image", "text_ids", "text_padding_mask", "img_shape")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    imgdir, ann = make_refcoco_style(str(tmp_path_factory.mktemp("synth")),
                                     6, 4)
    return [f"data.{s}.{k}={v}" for s in ("train", "val")
            for k, v in (("annsfile", ann), ("imgsfile", imgdir))]


def _small_weights(template, seed):
    """N(0, 0.02) weights, unit norm scales, zero biases, for the tests that
    go through both loaders: their images differ by up to a level (cv2's
    fixed-point resize against F.interpolate), which at these weights moves
    no box of the tiny flagship across the 0.5 IoU line
    (tests/test_torch_cli.py)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return np.ones(leaf.shape, np.float32)
        if name.endswith("bias"):
            return np.zeros(leaf.shape, np.float32)
        return rng.normal(0, 0.02, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, template)


@pytest.fixture(scope="module")
def families(synth):
    """Per family: (config, JAX model, params (``random_params``), the JAX
    val loader's first batch, the port's model on the params)."""
    from simvg_tpu.config import Config, parse_cfg_options
    from simvg_tpu.data.builder import (build_dataset_from_cfg,
                                        build_loader_from_cfg)
    from simvg_tpu.models.builder import build_model
    from simvg_tpu_torch.convert import load_jax_params
    from simvg_tpu_torch.models import build_model as port_build

    out = {}
    for family, path in FAMILIES.items():
        cfg = Config.fromfile(path)
        cfg.merge_from_dict(parse_cfg_options(synth))
        ds = build_dataset_from_cfg(cfg.data.val, dataset_type=cfg.dataset,
                                    seed=cfg.seed)
        loader = build_loader_from_cfg(ds, cfg, train=False, canvas=64,
                                       seed=cfg.seed)
        batch = next(iter(loader))
        model, _ = build_model(cfg.model, img_size=64)
        params = random_params(model, *(jnp.asarray(batch[k])
                                        for k in INPUTS), seed=len(out))
        port, _ = port_build(cfg.model, img_size=64, device="cpu")
        out[family] = (cfg, model, params, batch,
                       load_jax_params(port, params).eval())
    return out


def _port_inputs(batch):
    return {k: torch.from_numpy(np.asarray(batch[k])) for k in INPUTS}


@pytest.mark.parametrize("family,branch", [
    ("MIXDETRMB", "decoder"), ("MIXDETRMB", "token"),
    ("OneStageModel", "decoder")])
def test_compute_cam_matches_jax(families, family, branch):
    """The SimVG token branch reads the CLS and text features, not the
    grid: its CAM is 0 in both packages.  The OneStage token keys alias the
    decoder's, so its token CAM is the decoder's."""
    import types

    import tools.misc.vis_cam as jax_vis_cam
    from simvg_tpu_torch.tools.vis_cam import compute_cam

    cfg, model, params, batch, port = families[family]
    # JAX's compute_cam, jitted: its closing np.asarray (the host copy) is
    # the identity while it traces, and the copy is made after
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vis_cam, "np", types.SimpleNamespace(
            asarray=lambda x: x))
        want = np.asarray(cheap_jit(lambda p, i: jax_vis_cam.compute_cam(
            model, p, i, branch, 64, family=cfg.model.get("type")))(
            params, {k: jnp.asarray(batch[k]) for k in INPUTS}))
    got = compute_cam(port, _port_inputs(batch), branch).numpy()
    grid = 4 if family == "MIXDETRMB" else 2
    assert got.shape == want.shape == (4, grid, grid)
    if branch == "token":
        assert not want.any() and not got.any()
        return
    assert want.max() > 0
    for g, w in zip(got, want):  # a map that ReLU zeroes: the batch's max
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * (
            w.max() if w.max() > 0 else want.max()))
    if family == "OneStageModel":
        assert np.array_equal(compute_cam(port, _port_inputs(batch),
                                          "token").numpy(), got)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cross_attention_maps_match_jax_intermediates(families, family):
    from simvg_tpu_torch.tools.attn_visual import cross_attention_maps

    cfg, model, params, batch, port = families[family]
    _, inter = cheap_jit(lambda p, i: model.apply(
        p, **i, mutable=["intermediates"]))(
        params, {k: jnp.asarray(batch[k]) for k in INPUTS})
    want = {name: np.asarray(layer["cross_attn"]["attn_weights"][0]).mean(1)
            for name, layer in inter["intermediates"]["head"][
                "decoder"].items() if "cross_attn" in layer}
    got = cross_attention_maps(port, _port_inputs(batch))
    assert sorted(got) == sorted(want) and len(want) >= 1
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=0,
                                   atol=1e-5, err_msg=name)


def _jax_tool_output(script, argv):
    """stdout of a JAX ``tools/misc`` script run in-process."""
    buf = io.StringIO()
    old = sys.argv
    sys.argv = [script] + list(argv)
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(osp.join(REPO, "tools", "misc", script),
                           run_name="__main__")
    finally:
        sys.argv = old
    return buf.getvalue()


def _port_output(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    return buf.getvalue(), result


@pytest.mark.parametrize("config", [TINY, ONESTAGE])
def test_parameters_match_jax(config):
    from simvg_tpu_torch.tools import parameters

    want = _jax_tool_output("parameters.py", [config, "--platform", "cpu"])
    got, totals = _port_output(parameters.main, [config])
    assert got == want, (got, want)
    assert "total" in got and sum(totals.values()) > 0


def test_dataset_token_count_matches_jax(synth):
    from simvg_tpu_torch.tools import dataset_token_count

    ann = synth[0].split("=", 1)[1]
    argv = [ann, "--split", "train", "--tokenizer", "beit3"]
    want = _jax_tool_output("dataset_token_count.py", argv)
    got, res = _port_output(dataset_token_count.main, argv)
    assert got == want, (got, want)
    assert sum(res["histogram"].values()) == len(res["lengths"]) == 12


def test_browse_dataset_writes_images(synth, tmp_path):
    from simvg_tpu_torch.tools import browse_dataset

    out = tmp_path / "browse"
    files = browse_dataset.main([TINY, "--which-set", "train",
                                 "--output-dir", str(out), "--num", "2",
                                 "--device", "cpu", "--cfg-options", *synth])
    assert len(files) == 2
    assert all(osp.getsize(f) > 0 and osp.isfile(f + ".json") for f in files)


@pytest.mark.parametrize("tool,config", [
    ("vis_cam", TINY), ("attn_visual", TINY), ("vis_cam", ONESTAGE)])
def test_visualization_tools_write_files(synth, tmp_path, tool, config):
    import importlib

    main = importlib.import_module(f"simvg_tpu_torch.tools.{tool}").main
    out = tmp_path / tool
    printed, _ = _port_output(main, [
        config, "--which-set", "val", "--output-dir", str(out), "--num",
        "2", "--device", "cpu", "--cfg-options", *synth])
    files = os.listdir(out)
    assert len(files) >= 2 and re.search(r"wrote \d+", printed), files
    assert all(osp.getsize(out / f) > 0 for f in files)


def test_heatmap_raw_image(tmp_path):
    """One raw JPEG and an expression: the CAM blended with the predicted
    box, and the printed box in the original image's scale."""
    import cv2

    from simvg_tpu_torch.tools import heatmap

    img = np.random.default_rng(0).integers(0, 255, (90, 120, 3), np.uint8)
    cv2.rectangle(img, (20, 20), (60, 60), (0, 255, 0), -1)
    path = str(tmp_path / "raw.jpg")
    cv2.imwrite(path, img)
    out = tmp_path / "cam"
    printed, res = _port_output(heatmap.main, [
        TINY, "--image-path", path, "--text", "the green box",
        "--save-dir", str(out), "--branch", "decoder", "--device", "cpu"])
    m = re.search(r"box \(xyxy, original scale\): \[([^\]]+)\] "
                  r"score: ([\d.]+)", printed)
    assert m, printed
    box = [float(v) for v in m.group(1).split(",")]
    assert all(np.isfinite(box)) and max(box) <= 120 + 1e-3
    files = os.listdir(out)
    assert files == ["raw-decoder-heatmap.jpg"]
    assert osp.getsize(out / files[0]) > 0
    assert res["cam"].shape == (4, 4) and np.isfinite(res["cam"]).all()


def test_encoder_ablation_rows_on_the_cpu(monkeypatch):
    """Every row but the batch sweeps runs, on a one-layer narrow encoder
    at 64 px in place of BEiT3-base at 640."""
    from simvg_tpu_torch.models import beit3
    from simvg_tpu_torch.tools import encoder_ablation

    def small(cls, **kw):
        return cls(embed_dim=32, num_heads=2, ffn_dim=64, num_layers=1,
                   **dict(kw, img_size=64))

    monkeypatch.setattr(beit3.BEiT3Config, "base", classmethod(small))
    printed, rows = _port_output(encoder_ablation.main, [
        "--device", "cpu", "--batch", "2", "--iters", "1", "--only", "_"])
    assert [r["name"] for r in rows] == ["plain_attn", "ln_off", "attn_off",
                                         "gelu_tanh"]
    assert all(r["ms"] > 0 and r["host_ms"] > 0 for r in rows)
    assert "unrolled     not applicable" in printed


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_jax_checkpoint_to_torch(families, family, synth, tmp_path):
    """A JAX orbax checkpoint (params and EMA) converted: the port loads
    it strict and its test CLI gives JAX ``evaluate``'s Prec@0.5."""
    from simvg_tpu.data.builder import (build_dataset_from_cfg,
                                        build_loader_from_cfg)
    from simvg_tpu.engine.evaluate import evaluate
    from simvg_tpu.utils.checkpoint import save_checkpoint
    from simvg_tpu_torch.models import build_model
    from simvg_tpu_torch.tools import test as test_cli
    from simvg_tpu_torch.utils.checkpoint import load_checkpoint

    sys.path.insert(0, REPO)
    import jax_checkpoint_to_torch

    cfg, model, params, _, _ = families[family]
    if family == "MIXDETRMB":
        params = _small_weights(params, seed=0)
    config = FAMILIES[family]
    ema = jax.tree.map(lambda x: x * 0.5, params)
    save_checkpoint(str(tmp_path / "jax"), "det_best", params=params,
                    ema_params=ema, epoch=3, block=True)
    path = jax_checkpoint_to_torch.main([
        str(tmp_path / "jax" / "det_best"), "--config", config, "--out",
        str(tmp_path / "port")])
    ck = load_checkpoint(path, with_ema=True)
    assert ck["epoch"] == 3
    port, _ = build_model(cfg.model, img_size=64, device="cpu")
    port.load_state_dict(ck["params"], strict=True)
    want_ema = export_params(jax.tree.map(np.asarray, ema))
    assert sorted(ck["ema_params"]) == sorted(want_ema)
    for k, v in want_ema.items():
        assert np.array_equal(ck["ema_params"][k].numpy(), v), k

    ds = build_dataset_from_cfg(cfg.data.val, dataset_type=cfg.dataset,
                                seed=cfg.seed)
    want = evaluate(model, jax.tree.map(jnp.asarray, params),
                    build_loader_from_cfg(ds, cfg, train=False, canvas=64,
                                          seed=cfg.seed))
    got = test_cli.main([config, path, "--device", "cpu", "--cfg-options",
                         *synth])["val"]
    assert got["n_samples"] == want["n_samples"] == 4
    for k in ("det_acc", "decoder_det_acc", "token_det_acc"):
        assert got[k] == want[k], (k, got[k], want[k])


def test_summarize_run_reads_the_port_metrics(synth, tmp_path):
    from simvg_tpu_torch.tools import train as train_cli

    wd = tmp_path / "run"
    train_cli.main([TINY, "--work-dir", str(wd), "--device", "cpu",
                    "--cfg-options", *synth, "scheduler_config.max_epoch=1",
                    "data.samples_per_gpu=2"])
    buf = io.StringIO()
    old = sys.argv
    sys.argv = ["summarize_run.py", str(wd), "--key", "token_det_acc"]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(osp.join(REPO, "tools", "misc",
                                    "summarize_run.py"), run_name="__main__")
    finally:
        sys.argv = old
    out = buf.getvalue()
    assert "(1 evals)" in out and "final epoch    1" in out, out
    assert re.search(r"token_det_acc=\d+\.\d\d", out), out
