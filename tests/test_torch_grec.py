"""GRefCOCO and Mixed through simvg_tpu_torch, against simvg_tpu, on the CPU.

- loader batches: the same synthetic files (tests/util_synth.py) through the
  JAX loader and the port's; every numpy key equal (gt_boxes, gt_labels,
  gt_valid, gt_count, img_shape, scale_factor, ...), the untruncated
  ``meta["gt_bbox_all"]`` and ``meta["target"]`` equal, images within one
  uint8 level per resampling (over std after Normalize); Mixed's
  ``img_source`` filter drops the ``visual-genome`` record (whose image is
  absent) and the dataset lengths agree;
- ``grec_f1_nacc``: equal to JAX's on the hand cases of tests/test_grec.py
  and on seeded random cases;
- ``evaluate(is_grec=True)`` on weights of JAX ``model.init`` exported with
  ``export_simvg_full``: the per-branch F1/N-acc of JAX ``evaluate`` on the
  same batches;
- the CLIs: ``tiny_synth_grec.py`` trains then tests, and
  ``tiny_synth_mix_pretrain.py`` pretrains, then ``--finetune-from`` starts
  ``tiny_synth.py`` from it.
"""

import json
import os
import os.path as osp
import re

import numpy as np
import pytest
import torch

from util_synth import (make_grefcoco_style, make_mixed_style,
                        make_refcoco_style)

from simvg_tpu_torch.config import Config, parse_cfg_options
from simvg_tpu_torch.data.builder import (build_dataset_from_cfg,
                                          build_loader_from_cfg)
from simvg_tpu_torch.engine import evaluate, make_eval_step
from simvg_tpu_torch.engine.metrics import grec_f1_nacc
from simvg_tpu_torch.tools import test as test_cli
from simvg_tpu_torch.tools import train as train_cli
from simvg_tpu_torch.tools.train import gt_settings
from util_torch_port import cheap_jit, one_torch_thread  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SMOKE = osp.join(REPO, "configs", "smoke")
GREC = osp.join(SMOKE, "tiny_synth_grec.py")
MIX = osp.join(SMOKE, "tiny_synth_mix_pretrain.py")
TINY = osp.join(SMOKE, "tiny_synth.py")
STD = np.asarray([58.395, 57.12, 57.375], np.float32)


@pytest.fixture(scope="module")
def grec_data(tmp_path_factory):
    imgdir, ann = make_grefcoco_style(str(tmp_path_factory.mktemp("grec")),
                                      n=6)
    return [f"data.{s}.{k}={v}" for s in ("train", "val")
            for k, v in (("annsfile", ann), ("imgsfile", imgdir))]


@pytest.fixture(scope="module")
def mixed_data(tmp_path_factory):
    root, ann = make_mixed_style(str(tmp_path_factory.mktemp("mixed")),
                                 n_per_source=4, n_val=4)
    opts = []
    for s in ("train", "val"):
        opts.append(f"data.{s}.annsfile={ann}")
        opts += [f"data.{s}.imgsfile.{src}={osp.join(root, src)}"
                 for src in ("coco", "flickr")]
    return opts


def _cfgs(path, opts):
    from simvg_tpu.config import Config as JaxConfig

    out = []
    for cls in (JaxConfig, Config):
        cfg = cls.fromfile(path)
        cfg.merge_from_dict(parse_cfg_options(opts))
        out.append(cfg)
    return out


@pytest.mark.parametrize("which,split,train,levels", [
    ("grec", "val", False, 1), ("grec", "train", True, 2),
    ("mixed", "val", False, 1), ("mixed", "train", True, 2)])
def test_loader_batches_match_jax(grec_data, mixed_data, which, split, train,
                                  levels):
    from simvg_tpu.data.builder import build_dataset_from_cfg as jax_dataset
    from simvg_tpu.data.builder import build_loader_from_cfg as jax_loader

    path, opts = (GREC, grec_data) if which == "grec" else (MIX, mixed_data)
    jcfg, cfg = _cfgs(path, opts)
    _, max_gt = gt_settings(cfg)
    jds = jax_dataset(jcfg.data[split], dataset_type=jcfg.dataset, seed=6666)
    tds = build_dataset_from_cfg(cfg.data[split], dataset_type=cfg.dataset,
                                 seed=6666)
    assert len(tds) == len(jds)
    if which == "mixed" and split == "train":
        # 4 coco + 4 flickr; the visual-genome record is dropped unread
        assert len(tds) == 8
        assert {a["data_source"] for a in tds.anns_all["train"]} == \
            {"coco", "flickr"}
    jl = jax_loader(jds, jcfg, train=train, canvas=64, max_gt=max_gt,
                    seed=6666)
    tl = build_loader_from_cfg(tds, cfg, train=train, canvas=64,
                               max_gt=max_gt, seed=6666, device="cpu")
    assert len(jl) == len(tl) > 0
    no_target = 0
    for epoch in range(2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        n = 0
        for a, b in zip(jl, tl):
            n += 1
            for k in a:
                if k in ("meta", "image"):
                    continue
                assert b[k].dtype == a[k].dtype, k
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
            for ma, mb in zip(a["meta"], b["meta"]):
                for k in ("filename", "expression", "target"):
                    assert mb[k] == ma[k], k
                np.testing.assert_array_equal(mb["gt_bbox_all"],
                                              ma["gt_bbox_all"])
            no_target += int((b["gt_labels"] == 1).sum())
            img = b["image"]
            assert tuple(img.shape) == a["image"].shape
            diff = np.abs(img.numpy() - a["image"])
            assert (diff <= levels / STD + 1e-6).all(), diff.max()
        assert n == len(jl)
    if which == "grec":
        assert no_target > 0  # the no-target rule was exercised


def _box(x, y, w, h):
    return np.asarray([x, y, x + w, y + h], np.float64)


HAND_CASES = {
    # tests/test_grec.py::test_grec_f1_hand_cases
    "hand": (
        [np.stack([_box(10, 10, 20, 20), _box(50, 50, 5, 5)]),
         np.stack([_box(0, 0, 10, 10)]), np.stack([_box(0, 0, 10, 10)]),
         np.stack([_box(10, 10, 20, 20)])],
        [np.asarray([0.9, 0.1]), np.asarray([0.2]), np.asarray([0.95]),
         np.asarray([0.9])],
        [_box(10, 10, 20, 20)[None], _box(0, 0, 0, 0)[None],
         _box(0, 0, 0, 0)[None],
         np.stack([_box(10, 10, 20, 20), _box(60, 60, 20, 20)])],
        [[{"category_id": 1}], [{"category_id": -1}], [{"category_id": -1}],
         [{"category_id": 1}, {"category_id": 1}]]),
    # ::test_grec_score_filter_and_greedy_matching, one score under 0.7
    "score_filter": (
        [np.stack([_box(0, 0, 10, 10), _box(50, 50, 10, 10)])] * 2,
        [np.asarray([0.8, 0.75]), np.asarray([0.8, 0.5])],
        [np.stack([_box(0, 0, 10, 10), _box(50, 50, 10, 10)])] * 2,
        [[{"category_id": 1}, {"category_id": 1}]] * 2),
    # ::test_grec_full_gt_denominator_beyond_num_queries
    "beyond_queries": (
        [np.asarray([[10 * i, 0, 10 * i + 8, 8] for i in range(10)], float)]
        * 2,
        [np.full(10, 0.9)] * 2,
        [np.asarray([[10 * i, 0, 10 * i + 8, 8] for i in range(12)], float),
         np.asarray([[10 * i, 0, 10 * i + 8, 8] for i in range(10)], float)],
        [[{"category_id": 1}] * 12, [{"category_id": 1}] * 10]),
    # ::test_grec_equal_score_tiebreak_matches_reference_formula
    "tie_break": (
        [np.asarray([[0, 0, 10, 10], [20, 20, 30, 30]], float)] * 2
        + [np.asarray([[0, 0, 10, 10]], float)],
        [np.asarray([0.8, 0.8]), np.asarray([0.7, 0.7]), np.asarray([0.9])],
        [np.asarray([[0, 0, 10, 10]], float)] * 2 + [np.zeros((1, 4))],
        [[{"category_id": 1}]] * 2 + [[{"category_id": -1}]]),
}


def _random_case(seed):
    """Images with 0-4 targets (a fifth of them no-target), 1-10 queries
    near the targets, scores around the 0.7 filter, some of them equal."""
    r = np.random.default_rng(seed)
    preds, scores, gts, targets = [], [], [], []
    for _ in range(12):
        n_gt = int(r.integers(0, 5))
        if n_gt == 0 or r.random() < 0.2:
            gt = np.zeros((1, 4))
            tgt = [{"category_id": -1}]
        else:
            xy = r.uniform(0, 80, (n_gt, 2))
            gt = np.concatenate([xy, xy + r.uniform(5, 30, (n_gt, 2))], 1)
            tgt = [{"category_id": 1}] * n_gt
        nq = int(r.integers(1, 11))
        base = gt[r.integers(0, len(gt), nq)]
        p = base + r.normal(0, r.choice([0.5, 4.0]), base.shape)
        s = np.round(r.uniform(0.5, 1.0, nq), 1)  # ties at one decimal
        preds.append(p)
        scores.append(s)
        gts.append(gt)
        targets.append(tgt)
    return preds, scores, gts, targets


@pytest.mark.parametrize("case", list(HAND_CASES) + [f"seed{s}"
                                                     for s in range(6)])
def test_grec_f1_nacc_matches_jax(case):
    from simvg_tpu.engine.metrics import grec_f1_nacc as jax_grec

    args = (HAND_CASES[case] if case in HAND_CASES
            else _random_case(int(case[4:])))
    got, want = grec_f1_nacc(*args), jax_grec(*args)
    assert got == want
    if case == "hand":
        assert got["F1_score"] == 50.0 and got["N_acc"] == 50.0


@pytest.fixture(scope="module")
def grec_weights():
    """JAX ``model.init`` of tiny_synth_grec.py and its export to the
    port's state dict."""
    import jax
    import jax.numpy as jnp

    from simvg_tpu.config import Config as JaxConfig
    from simvg_tpu.models.builder import build_model as jax_build
    from simvg_tpu_torch.convert import export_simvg_full

    cfg = JaxConfig.fromfile(GREC)
    model, _ = jax_build(cfg.model, img_size=cfg.img_size, dtype=jnp.float32)
    t = cfg.max_token
    params = cheap_jit(model.init)(
        jax.random.PRNGKey(11),
        image=jnp.zeros((1, cfg.img_size, cfg.img_size, 3), jnp.float32),
        text_ids=jnp.ones((1, t), jnp.int32),
        text_padding_mask=jnp.zeros((1, t), jnp.int32),
        img_shape=jnp.full((1, 2), cfg.img_size, jnp.int32))
    params = jax.tree.map(np.asarray, params)
    sd = {k: torch.from_numpy(v.copy())
          for k, v in export_simvg_full(params).items()}
    return model, params, sd


def test_evaluate_grec_on_exported_weights_matches_jax(grec_data,
                                                       grec_weights):
    import jax
    import jax.numpy as jnp

    from simvg_tpu.data.builder import build_dataset_from_cfg as jax_dataset
    from simvg_tpu.data.builder import build_loader_from_cfg as jax_loader
    from simvg_tpu.engine.evaluate import evaluate as jax_evaluate
    from simvg_tpu.engine.train import make_eval_step as jax_eval_step
    from simvg_tpu_torch.models import build_model

    jmodel, params, sd = grec_weights
    jcfg, cfg = _cfgs(GREC, grec_data)
    _, max_gt = gt_settings(cfg)
    jds = jax_dataset(jcfg.data.val, dataset_type=jcfg.dataset, seed=6666)
    batches = list(jax_loader(jds, jcfg, train=False, canvas=64,
                              max_gt=max_gt, seed=6666))
    assert not all(b["batch_valid"].all() for b in batches)  # wrap-padded
    jparams = jax.tree.map(jnp.asarray, params)
    want = jax_evaluate(jmodel, jparams, batches, is_grec=True)

    model, _ = build_model(cfg.model, img_size=cfg.img_size, device="cpu")
    model.load_state_dict(sd, strict=True)
    step = make_eval_step(model)
    got = evaluate(model, batches, is_grec=True, eval_step=step)
    for k, v in want.items():
        assert got[k] == v, (k, got[k], v)
    assert got["n_samples"] == len(jds)

    # the decoded predictions F1/N-acc are computed from, in fp32
    keys = ("image", "text_ids", "text_padding_mask", "img_shape")
    jp = cheap_jit(jax_eval_step(jmodel))(
        jparams, {k: jnp.asarray(batches[0][k]) for k in keys})
    tp = step({k: torch.as_tensor(batches[0][k]) for k in keys})
    for branch in ("decoder", "token"):
        for k, tol in (("scores", 1e-5), ("boxes", 1e-3)):
            np.testing.assert_allclose(tp[branch][k].numpy(),
                                       np.asarray(jp[branch][k]), atol=tol)


def test_grec_train_then_test_cli(tmp_path, grec_data):
    wd = tmp_path / "grec"
    res = train_cli.main([GREC, "--work-dir", str(wd), "--device", "cpu",
                          "--cfg-options", *grec_data,
                          "scheduler_config.max_epoch=1"])
    assert res["step"] == 1
    with open(wd / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    train = [m for m in lines if m["kind"] == "train"]
    assert train and all(k in train[-1] for k in (
        "decoder_F1", "decoder_Nacc", "token_F1", "token_Nacc"))
    assert "decoder_det_acc" not in train[-1]  # no single-target metrics
    ev = res["eval"]["val"]
    for k in ("decoder_F1_score", "decoder_N_acc", "token_F1_score",
              "token_N_acc"):
        assert k in ev and 0.0 <= ev[k] <= 100.0, k
    assert ev["det_acc"] == (ev["decoder_F1_score"]
                             + ev["token_F1_score"]) / 2
    got = test_cli.main([GREC, str(wd / "det_best"), "--device", "cpu",
                         "--cfg-options", *grec_data])["val"]
    assert got == ev


def _log(work_dir):
    (name,) = [p for p in os.listdir(work_dir)
               if p.endswith("_train_log.txt")]
    with open(osp.join(work_dir, name)) as f:
        return f.read()


def test_mixed_pretrain_then_finetune_cli(tmp_path, mixed_data):
    wd = tmp_path / "pretrain"
    res = train_cli.main([MIX, "--work-dir", str(wd), "--device", "cpu",
                          "--cfg-options", *mixed_data,
                          "scheduler_config.max_epoch=1"])
    log = _log(wd)
    # 4 coco + 4 flickr; the visual-genome record was dropped before any
    # read (its image does not exist)
    m = re.search(r"train: (\d+) samples", log)
    assert m and int(m.group(1)) == 8, log[-2000:]
    assert res["step"] == 8  # batch 1
    with open(wd / "metrics.jsonl") as f:
        train = [json.loads(line) for line in f if '"train"' in line]
    # decoder-only pretraining: no token or distillation terms
    assert "loss_dgt" in train[-1]
    assert "loss_tgt" not in train[-1] and "loss_kd" not in train[-1]
    assert "det_acc" in res["eval"]["val"]

    imgdir, ann = make_refcoco_style(str(tmp_path / "refcoco"), 8, 4)
    opts = [f"data.{s}.{k}={v}" for s in ("train", "val")
            for k, v in (("annsfile", ann), ("imgsfile", imgdir))]
    res = train_cli.main([TINY, "--work-dir", str(tmp_path / "finetune"),
                          "--device", "cpu",
                          "--finetune-from", str(wd / "latest"),
                          "--cfg-options", *opts,
                          "scheduler_config.max_epoch=1"])
    assert "finetuned from" in _log(tmp_path / "finetune")
    assert res["start_epoch"] == 0 and res["step"] == 2
    with open(tmp_path / "finetune" / "metrics.jsonl") as f:
        train = [json.loads(line) for line in f if '"train"' in line]
    assert "loss_tgt" in train[-1] and "loss_kd" in train[-1]
