"""The port's train and test CLIs with ``--distributed``: 2-process gloo
runs on the CPU (``tests/_torch_parallel_worker.py cli``) with
``configs/smoke/tiny_synth.py`` and synthetic data.

- Evaluation: the test CLI with ``--distributed`` on FSDP-sharded weights
  (``fsdp_min_size=0``) over a 5-sample split in batches of 2 (3 batches
  over 2 ranks: one rank gets a flagged wrap-pad duplicate) gives, on every
  rank, the single-process CLI's counters: ``n_samples`` 5 and the same
  Prec@0.5 and mIoU per branch.
- Checkpoints both ways: an FSDP training writes checkpoints that the
  single-device test CLI loads and scores as the training's own
  evaluation did; a single-device ``latest`` resumes under FSDP (the
  params, amsgrad moments and EMA scattered to the ranks) to the same
  state, after one more epoch, as under DDP (which loads them whole).
"""

import json
import os.path as osp

import numpy as np
import pytest
import torch

from util_synth import make_refcoco_style
from util_torch_port import one_torch_thread, run_ranks  # noqa: F401

from simvg_tpu_torch.config import Config
from simvg_tpu_torch.models import build_model
from simvg_tpu_torch.tools import test as test_cli
from simvg_tpu_torch.tools import train as train_cli
from simvg_tpu_torch.utils.checkpoint import load_checkpoint

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY = osp.join(REPO, "configs", "smoke", "tiny_synth.py")
FSDP = ["fsdp=True", "fsdp_min_size=0"]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    imgdir, ann = make_refcoco_style(str(tmp_path_factory.mktemp("synth")),
                                     8, 5)
    return [f"data.{s}.{k}={v}" for s in ("train", "val")
            for k, v in (("annsfile", ann), ("imgsfile", imgdir))] + [
        "data.samples_per_gpu=2"]


def _ranks(d, which, argv):
    run_ranks(2, ["tests/_torch_parallel_worker.py", "cli", str(d), which,
                  *argv, "--distributed", "--device", "cpu"])
    out = []
    for rank in range(2):
        with open(osp.join(d, f"result_rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


def _close(got, want, keys):
    for k in keys:
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-9), k


@pytest.fixture(scope="module")
def fsdp_run(tmp_path_factory, synth):
    """One epoch of FSDP training on 2 ranks."""
    d = tmp_path_factory.mktemp("fsdp_cli")
    wd = d / "work"
    results = _ranks(d, "train", [TINY, "--work-dir", str(wd),
                                  "--cfg-options", *synth, *FSDP,
                                  "scheduler_config.max_epoch=1"])
    return d, wd, results


def test_fsdp_checkpoint_scores_the_same_on_one_device(fsdp_run, synth):
    _, wd, results = fsdp_run
    assert results[0]["eval"] == results[1]["eval"]
    lines = [json.loads(x) for x in open(wd / "metrics.jsonl")]
    saved = next(m for m in lines if m["kind"] == "eval")
    assert saved["n_samples"] == 5
    got = test_cli.main([TINY, str(wd / "det_best"), "--with-ema",
                         "--device", "cpu", "--cfg-options", *synth])
    _close(got["val"], saved, ("n_samples", "decoder_det_acc",
                               "decoder_miou", "token_det_acc",
                               "token_miou"))
    _close(got["val[EMA]"], results[0]["eval"]["val[EMA]"],
           ("decoder_det_acc", "decoder_miou", "token_det_acc",
            "token_miou"))
    # the single-device format: whole tensors, the optimizer item too
    ck = load_checkpoint(str(wd / "latest"), with_opt=True, with_ema=True)
    model, _ = build_model(Config.fromfile(TINY).model, img_size=64,
                           device="meta")
    for name, p in model.named_parameters():
        for tree in (ck["params"], ck["ema_params"],
                     *(ck["opt_state"][m] for m in ("mu", "nu", "nu_max"))):
            assert tree[name].shape == p.shape, name


def test_distributed_eval_on_an_uneven_split(fsdp_run, synth):
    d, wd, _ = fsdp_run
    want = test_cli.main([TINY, str(wd / "det_best"), "--device", "cpu",
                          "--cfg-options", *synth])["val"]
    assert want["n_samples"] == 5
    for got in _ranks(d, "test", [TINY, str(wd / "det_best"),
                                  "--cfg-options", *synth, *FSDP]):
        _close(got["val"], want, sorted(want))


def test_single_device_checkpoint_resumes_under_fsdp(tmp_path, synth):
    one = tmp_path / "one"
    train_cli.main([TINY, "--work-dir", str(one), "--device", "cpu",
                    "--cfg-options", *synth, "scheduler_config.max_epoch=1"])
    state = {}
    for layout, extra in (("ddp", []), ("fsdp", FSDP)):
        wd = tmp_path / layout
        _ranks(tmp_path, "train", [
            TINY, "--work-dir", str(wd), "--resume-from",
            str(one / "latest"), "--cfg-options", *synth, *extra,
            "scheduler_config.max_epoch=2"])
        state[layout] = load_checkpoint(str(wd / "latest"), with_opt=True,
                                        with_ema=True)
    a, b = state["ddp"], state["fsdp"]
    assert (a["epoch"], a["step"], a["ema_step"]) == (2, 6, 6)
    assert (b["epoch"], b["step"], b["ema_step"]) == (2, 6, 6)
    assert b["opt_state"]["count"] == a["opt_state"]["count"] == 6
    for item in ("params", "ema_params"):
        for k, v in a[item].items():
            torch.testing.assert_close(b[item][k], v, rtol=1e-5, atol=1e-6,
                                       msg=f"{item} {k}")
    for moment in ("mu", "nu", "nu_max"):
        for k, v in a["opt_state"][moment].items():
            torch.testing.assert_close(b["opt_state"][moment][k], v,
                                       rtol=1e-5, atol=1e-9,
                                       msg=f"{moment} {k}")
    np.testing.assert_equal(sorted(a["params"]), sorted(b["params"]))


def test_distributed_grec_eval_on_an_uneven_split(tmp_path):
    """GRefCOCO's F1/N-acc from the counters summed over 2 ranks (6 images
    in batches of 2: 3 batches, one rank with a wrap-pad duplicate) equal
    the single-process test CLI's."""
    from util_synth import make_grefcoco_style

    from simvg_tpu_torch.models import init_random_weights
    from simvg_tpu_torch.utils.checkpoint import save_checkpoint

    grec = osp.join(REPO, "configs", "smoke", "tiny_synth_grec.py")
    imgdir, ann = make_grefcoco_style(str(tmp_path / "grec"), n=6)
    opts = [f"data.{s}.{k}={v}" for s in ("train", "val")
            for k, v in (("annsfile", ann), ("imgsfile", imgdir))] + [
        "data.samples_per_gpu=2"]
    model, _ = build_model(Config.fromfile(grec).model, img_size=64,
                           device="cpu")
    init_random_weights(model, 5)
    save_checkpoint(str(tmp_path), "ck", params=model.state_dict(),
                    block=True)
    ck = str(tmp_path / "ck")
    want = test_cli.main([grec, ck, "--device", "cpu", "--cfg-options",
                          *opts])["val"]
    assert want["n_samples"] == 6
    for got in _ranks(tmp_path, "test", [grec, ck, "--cfg-options", *opts]):
        _close(got["val"], want, sorted(want))
