"""The port's train and test CLIs (``simvg_tpu_torch.tools``), in-process on
the CPU with ``configs/smoke/tiny_synth.py`` and synthetic data.

- the train CLI writes the JAX CLI's files (config dump, log, metrics.jsonl,
  det_best, latest, epoch_N) and the test CLI on det_best gives the
  det_acc that the train CLI's evaluation saved with it;
- the test CLI on weights exported from a JAX param tree gives the same
  Prec@0.5, per branch, as JAX ``evaluate`` on the same split (M8's done
  condition);
- both default to the card and raise without one; the options that are not
  ported yet raise NotImplementedError naming their ROADMAP item.
"""

import json
import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util_synth import make_refcoco_style

from simvg_tpu_torch.tools import test as test_cli
from simvg_tpu_torch.tools import train as train_cli

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY = osp.join(REPO, "configs", "smoke", "tiny_synth.py")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    imgdir, ann = make_refcoco_style(str(tmp_path_factory.mktemp("synth")),
                                     8, 8)
    return [f"data.{s}.{k}={v}" for s in ("train", "val")
            for k, v in (("annsfile", ann), ("imgsfile", imgdir))]


def test_train_then_test_cli(tmp_path, synth):
    wd = tmp_path / "run"
    res = train_cli.main([TINY, "--work-dir", str(wd), "--device", "cpu",
                          "--cfg-options", *synth, "save_interval=2"])
    files = sorted(os.listdir(wd))
    for name in ("config.py", "det_best", "latest", "epoch_2",
                 "metrics.jsonl"):
        assert name in files, files
    assert any(f.endswith("_train_log.txt") for f in files)
    assert res["step"] == 4 and len(res["epochs"]) == 2
    with open(wd / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [m["iter"] for m in lines if m["kind"] == "train"] == [1, 2, 1, 2]
    evals = [m for m in lines if m["kind"] == "eval"]
    assert [m["epoch"] for m in evals] == [1, 2]
    assert all(np.isfinite(m["loss_total"]) for m in lines
               if m["kind"] == "train")

    with open(wd / "det_best" / "meta.json") as f:
        best = json.load(f)
    saved = next(m for m in evals if m["epoch"] == best["epoch"])
    got = test_cli.main([TINY, str(wd / "det_best"), "--with-ema",
                         "--device", "cpu", "--cfg-options", *synth])
    assert set(got) == {"val", "val[EMA]"}
    for k, v in got["val"].items():
        assert v == saved[k], k
    assert got["val"]["det_acc"] == res["best_det_acc"]


def test_cli_runs_as_a_module(tmp_path, synth):
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "simvg_tpu_torch.tools.train", TINY,
         "--work-dir", str(tmp_path), "--device", "cpu", "--cfg-options",
         *synth, "scheduler_config.max_epoch=1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "training done" in proc.stderr
    assert osp.isfile(tmp_path / "latest" / "meta.json")


def test_clis_default_to_the_card(tmp_path, synth):
    assert train_cli.parse_args([TINY]).device == "cuda"
    assert test_cli.parse_args([TINY, "ck"]).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main([TINY, "--work-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_cli.main([TINY, str(tmp_path / "det_best")])


@pytest.mark.parametrize("extra,item", [
    (["--distributed"], "M16"),
    (["--cfg-options", "fsdp=True"], "M16"),
    (["--cfg-options", "model_parallel=2"], "M16"),
    (["--cfg-options", "model.vis_enc.seq_parallel=True"], "M16"),
    (["--cfg-options", "dataset=GRefCOCO", "data.train.type=GRefCOCO"],
     "M15"),
    (["--cfg-options", "data.train.pipeline=[{'type': "
      "'LoadImageAnnotationsFromFile', 'with_bbox': True, "
      "'with_mask': True}]"], "masks"),
])
def test_unported_options_raise(tmp_path, synth, extra, item):
    argv = [TINY, "--work-dir", str(tmp_path), "--device", "cpu"]
    if extra[0] == "--cfg-options":
        argv += ["--cfg-options", *synth, *extra[1:]]
    else:
        argv += extra + ["--cfg-options", *synth]
    with pytest.raises(NotImplementedError, match=item):
        train_cli.main(argv)


def test_quant_collection_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="M17"):
        test_cli.main([TINY, str(tmp_path), "--device", "cpu",
                       "--quant-collection", "q.npz"])


def test_test_cli_on_jax_weights_matches_jax_evaluate(tmp_path, synth):
    from simvg_tpu.config import Config as JaxConfig
    from simvg_tpu.config import parse_cfg_options
    from simvg_tpu.data.builder import (build_dataset_from_cfg,
                                        build_loader_from_cfg)
    from simvg_tpu.engine.evaluate import evaluate
    from simvg_tpu.models.builder import build_model
    from simvg_tpu_torch.convert import export_simvg_full
    from simvg_tpu_torch.models import build_model as port_build
    from simvg_tpu_torch.models import init_random_weights
    from simvg_tpu_torch.utils.checkpoint import save_checkpoint
    from util_torch_port import jax_params_from_port

    cfg = JaxConfig.fromfile(TINY)
    cfg.merge_from_dict(parse_cfg_options(synth))
    ds = build_dataset_from_cfg(cfg.data.val, dataset_type=cfg.dataset,
                                seed=cfg.seed)
    loader = build_loader_from_cfg(ds, cfg, train=False, canvas=64,
                                   seed=cfg.seed)
    model, _ = build_model(cfg.model, img_size=64, dtype=jnp.float32)
    # a JAX param tree (random weights, made through the port so that no
    # JAX init has to run), exported to the port's names and saved
    port, _ = port_build(cfg.model, img_size=64, device="cpu")
    init_random_weights(port, torch.Generator().manual_seed(3))
    batch = next(iter(loader))
    params = jax_params_from_port(
        model, {k: batch[k] for k in ("image", "text_ids",
                                      "text_padding_mask", "img_shape")},
        port.state_dict())
    want = evaluate(model, jax.tree.map(jnp.asarray, params), loader)
    sd = {k: torch.from_numpy(v) for k, v in export_simvg_full(params).items()}
    save_checkpoint(str(tmp_path), "from_jax", params=sd, block=True)

    got = test_cli.main([TINY, str(tmp_path / "from_jax"), "--device", "cpu",
                         "--cfg-options", *synth])["val"]
    assert got["n_samples"] == want["n_samples"] == 8
    for k in ("det_acc", "decoder_det_acc", "token_det_acc"):
        assert got[k] == want[k], (k, got[k], want[k])
    for k in ("decoder_miou", "token_miou"):
        assert abs(got[k] - want[k]) < 1e-3, (k, got[k], want[k])
