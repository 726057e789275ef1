"""The port's train and test CLIs (``simvg_tpu_torch.tools``), in-process on
the CPU with ``configs/smoke/tiny_synth.py`` and synthetic data.

- the train CLI writes the JAX CLI's files (config dump, log, metrics.jsonl,
  det_best, latest, epoch_N) and the test CLI on det_best gives the
  det_acc that the train CLI's evaluation saved with it;
- the test CLI on weights exported from a JAX param tree gives the same
  Prec@0.5, per branch, as JAX ``evaluate`` on the same split (M8's done
  condition), and on a GRefCOCO config the same F1/N-acc;
- the port's gates accept every top-level config under ``configs/``;
- both default to the card and raise without one; the M16 settings
  (``--distributed``, ``fsdp``, ``model_parallel``, ``seq_parallel``) pass
  the gates and train, as does a OneStageModel with a Swin backbone, and
  ``--quant-collection`` on a model without int8_static layers raises;
- the VGTR dataset base passes the gates under the flagship, and the train
  CLI trains an epoch with its ``VGTRAugment`` pipeline.
"""

import json
import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util_synth import make_grefcoco_style, make_refcoco_style
from util_torch_port import cheap_jit, one_torch_thread  # noqa: F401

from simvg_tpu_torch.tools import test as test_cli
from simvg_tpu_torch.tools import train as train_cli

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY = osp.join(REPO, "configs", "smoke", "tiny_synth.py")
GREC = osp.join(REPO, "configs", "smoke", "tiny_synth_grec.py")


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
    (["--cfg-options", "scheduler_config.max_epoch=1"], "M20b"),
    ([], "masks"),
])
def test_unported_options_raise(tmp_path, synth, extra, item, monkeypatch):
    """The M16 settings pass the gates, build and train one epoch
    (``--distributed`` in a 1-rank gloo group, DDP; the others on one
    device, where fsdp and the model axis shard nothing); "M20b"
    (ported) trains one epoch of ``tiny_synth_onestage.py`` with a tiny
    Swin in place of DarkNet53; "masks" (ported) trains one epoch of a
    config whose
    pipelines set ``with_mask`` (the train one with SampleMaskVertices) on
    masked annotations, and its evaluation's batches carry each sample's
    ``gt_mask_rle`` and ``is_crowd`` in their meta."""
    from util_torch_port import free_port

    if item == "masks":
        return _train_with_masks(tmp_path, synth, monkeypatch)
    config = TINY
    if item == "M20b":
        config = tmp_path / "tiny_swin_onestage.py"
        config.write_text(SWIN_CONFIG.format(onestage=ONESTAGE))
    argv = [str(config), "--work-dir", str(tmp_path), "--device", "cpu"]
    if extra[0] == "--cfg-options":
        argv += ["--cfg-options", *synth, *extra[1:]]
    else:
        argv += extra + ["--cfg-options", *synth]
    if item == "M20b":
        res = train_cli.main(argv)
        assert res["step"] == 2 and res["eval"]["val"]["n_samples"] == 8
        assert "SwinTransformer" in (tmp_path / "config.py").read_text()
        return
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    res = train_cli.main(argv + ["scheduler_config.max_epoch=1"])
    assert res["step"] == 2 and res["eval"]["val"]["n_samples"] == 8
    assert osp.isfile(tmp_path / "latest" / "meta.json")


ONESTAGE = osp.join(REPO, "configs", "smoke", "tiny_synth_onestage.py")
# the OneStage smoke config with a two-stage Swin 8 wide (window 7 on the
# 16x16 grid of 64 px, so the blocks pad and shift)
SWIN_CONFIG = """_base_ = [{onestage!r}]
model = dict(vis_enc=dict(_delete_=True, type="SwinTransformer", patch_size=4,
                          embed_dim=8, depths=(2, 2), num_heads=(2, 2)))
"""
MASK_CONFIG = """_base_ = [{tiny!r}]
train_pipeline = [
    dict(type="LoadImageAnnotationsFromFile", max_token=10, with_bbox=True,
         with_mask=True, use_token_type="beit3"),
    dict(type="Resize", img_scale=(64, 64), keep_ratio=False),
    dict(type="Pad", size_divisor=32),
    dict(type="SampleMaskVertices", num_ray=18, center_sampling=True),
]
val_pipeline = [
    dict(type="LoadImageAnnotationsFromFile", max_token=10, with_bbox=True,
         with_mask=True, use_token_type="beit3"),
    dict(type="Resize", img_scale=(64, 64), keep_ratio=False),
    dict(type="Pad", size_divisor=32),
]
data = dict(train=dict(pipeline=train_pipeline),
            val=dict(pipeline=val_pipeline))
"""


def _train_with_masks(tmp_path, synth, monkeypatch):
    import shutil

    from simvg_tpu_torch.tools.make_synth_data import add_masks

    ann = next(o.split("=", 1)[1] for o in synth
               if o.startswith("data.train.annsfile="))
    masked = str(tmp_path / "instances_masks.json")
    shutil.copy(ann, masked)
    add_masks(masked)
    opts = [o if "annsfile" not in o else o.split("=")[0] + "=" + masked
            for o in synth]
    config = tmp_path / "tiny_masks.py"
    config.write_text(MASK_CONFIG.format(tiny=TINY))
    metas = []
    real = train_cli.evaluate

    def recorded(model, loader, **kw):
        def batches():
            for batch in loader:
                metas.extend(batch["meta"])
                yield batch
        return real(model, list(batches()), **kw)

    monkeypatch.setattr(train_cli, "evaluate", recorded)
    res = train_cli.main([str(config), "--work-dir", str(tmp_path / "run"),
                          "--device", "cpu", "--cfg-options", *opts,
                          "scheduler_config.max_epoch=1"])
    assert res["step"] == 2 and res["eval"]["val"]["n_samples"] == 8
    assert len(metas) >= 8
    with open(masked) as f:
        val = json.load(f)["val"]
    crowd = [int(isinstance(a["mask"], list) and len(a["mask"]) > 1)
             for a in val]
    for m in metas[:8]:
        assert set(m["gt_mask_rle"]) == {"size", "counts"}
        assert m["gt_mask_rle"]["size"] == [64, 64]
    assert sorted(m["is_crowd"] for m in metas[:8]) == sorted(crowd)
    got = test_cli.main([str(config), str(tmp_path / "run" / "det_best"),
                         "--device", "cpu", "--cfg-options", *opts])
    assert got["val"]["det_acc"] == res["eval"]["val"]["det_acc"]


@pytest.mark.parametrize("optimizer_type", ["AdamW", "SGD", "RMSProp"])
def test_options_through_both_clis(tmp_path, synth, optimizer_type):
    """The DETR encoder, soft distillation and each of the other optimizers
    through the train CLI (one epoch) and the test CLI on its det_best,
    which gives the det_acc the train CLI's evaluation saved."""
    opts = [*synth, "scheduler_config.max_epoch=1",
            "model.head.only_decoder=False",
            "model.head.num_encoder_layers=1",
            "model.head.distill_type=soft",
            "model.head.branch_loss_weight={'decoder': 1.0, 'token': 1.0, "
            "'distill': 1.0}",
            f"optimizer_config.type={optimizer_type}",
            "optimizer_config.weight_decay=0.05"]
    wd = tmp_path / "run"
    res = train_cli.main([TINY, "--work-dir", str(wd), "--device", "cpu",
                          "--cfg-options", *opts])
    assert res["step"] == 2
    with open(wd / "metrics.jsonl") as f:
        train = [json.loads(line) for line in f if '"train"' in line]
    assert all(np.isfinite(m["loss_kd"]) for m in train)
    ck = torch.load(wd / "latest" / "params", map_location="cpu")
    assert any(k.startswith("head.transformer.encoder.layers.0.") for k in ck)
    got = test_cli.main([TINY, str(wd / "det_best"), "--device", "cpu",
                         "--cfg-options", *opts])
    assert got["val"]["det_acc"] == res["eval"]["val"]["det_acc"]


def test_quant_collection_raises(tmp_path, synth):
    """--quant-collection on a model without int8_static layers raises with
    JAX's message (the int8 path itself: tests/test_torch_quant.py)."""
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.models import build_model
    from simvg_tpu_torch.utils.checkpoint import save_checkpoint

    model, _ = build_model(Config.fromfile(TINY).model, img_size=64,
                           device="cpu")
    save_checkpoint(str(tmp_path), "ck", params=model.state_dict(),
                    block=True)
    with pytest.raises(SystemExit, match="no quant layers"):
        test_cli.main([TINY, str(tmp_path / "ck"), "--device", "cpu",
                       "--quant-collection", "q.npz", "--cfg-options",
                       *synth])


def test_test_cli_on_jax_weights_matches_jax_evaluate(tmp_path, synth):
    from simvg_tpu.config import Config as JaxConfig
    from simvg_tpu.config import parse_cfg_options
    from simvg_tpu.data.builder import (build_dataset_from_cfg,
                                        build_loader_from_cfg)
    from simvg_tpu.engine.evaluate import evaluate
    from simvg_tpu.models.builder import build_model
    from simvg_tpu_torch.convert import export_simvg_full
    from simvg_tpu_torch.models import build_model as port_build
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
    # JAX init has to run), exported to the port's names and saved.  The
    # weights are those of the former N(0, 0.02) fill: the two loaders'
    # images differ by up to a level (cv2's fixed-point resize against
    # F.interpolate), which at these weights moves mIoU by less than 1e-3;
    # the next test holds flax-init weights on the JAX loader's batches
    port, _ = port_build(cfg.model, img_size=64, device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for module in port.modules():
            for name, p in module.named_parameters(recurse=False):
                if isinstance(module, torch.nn.LayerNorm) and \
                        name == "weight":
                    p.fill_(1.0)
                elif name.endswith("bias"):
                    p.zero_()
                else:
                    p.normal_(0.0, 0.02, generator=gen)
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


def test_evaluate_on_jax_init_weights_and_batches_matches_jax(synth):
    """JAX ``model.init`` weights exported to the port, and the JAX
    loader's batches fed to both sides: the port's ``evaluate`` gives JAX
    ``evaluate``'s Prec@0.5 and mIoU per branch, so a gap between the test
    CLI and JAX on such weights comes from the loaders' images alone."""
    from simvg_tpu.config import Config as JaxConfig
    from simvg_tpu.config import parse_cfg_options
    from simvg_tpu.data.builder import (build_dataset_from_cfg,
                                        build_loader_from_cfg)
    from simvg_tpu.engine.evaluate import evaluate
    from simvg_tpu.models.builder import build_model
    from simvg_tpu_torch.convert import export_simvg_full
    from simvg_tpu_torch.engine import evaluate as port_evaluate
    from simvg_tpu_torch.models import build_model as port_build

    cfg = JaxConfig.fromfile(TINY)
    cfg.merge_from_dict(parse_cfg_options(synth))
    ds = build_dataset_from_cfg(cfg.data.val, dataset_type=cfg.dataset,
                                seed=cfg.seed)
    loader = build_loader_from_cfg(ds, cfg, train=False, canvas=64,
                                   seed=cfg.seed)
    batches = list(loader)
    model, _ = build_model(cfg.model, img_size=64, dtype=jnp.float32)
    params = cheap_jit(model.init)(
        jax.random.PRNGKey(3), **{k: jnp.asarray(batches[0][k]) for k in (
            "image", "text_ids", "text_padding_mask", "img_shape")})
    want = evaluate(model, params, batches)
    port, _ = port_build(cfg.model, img_size=64, device="cpu")
    port.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in
                          export_simvg_full(jax.tree.map(np.asarray,
                                                         params)).items()})
    got = port_evaluate(port, batches)
    assert got["n_samples"] == want["n_samples"] == 8
    for k in ("det_acc", "decoder_det_acc", "token_det_acc"):
        assert got[k] == want[k], (k, got[k], want[k])
    for k in ("decoder_miou", "token_miou"):
        assert abs(got[k] - want[k]) < 1e-3, (k, got[k], want[k])


def test_test_cli_on_jax_weights_matches_jax_evaluate_grec(tmp_path):
    """GRefCOCO: JAX ``model.init`` weights exported to the port; the test
    CLI's per-branch F1/N-acc equal JAX ``evaluate(is_grec=True)``'s."""
    from simvg_tpu.config import Config as JaxConfig
    from simvg_tpu.config import parse_cfg_options
    from simvg_tpu.data.builder import (build_dataset_from_cfg,
                                        build_loader_from_cfg)
    from simvg_tpu.engine.evaluate import evaluate
    from simvg_tpu.models.builder import build_model
    from simvg_tpu_torch.convert import export_simvg_full
    from simvg_tpu_torch.utils.checkpoint import save_checkpoint

    imgdir, ann = make_grefcoco_style(str(tmp_path / "grec"), n=6)
    opts = [f"data.{s}.{k}={v}" for s in ("train", "val")
            for k, v in (("annsfile", ann), ("imgsfile", imgdir))]
    cfg = JaxConfig.fromfile(GREC)
    cfg.merge_from_dict(parse_cfg_options(opts))
    ds = build_dataset_from_cfg(cfg.data.val, dataset_type=cfg.dataset,
                                seed=cfg.seed)
    loader = build_loader_from_cfg(ds, cfg, train=False, canvas=64,
                                   max_gt=cfg.max_gt, seed=cfg.seed)
    model, _ = build_model(cfg.model, img_size=64, dtype=jnp.float32)
    batch = next(iter(loader))
    params = cheap_jit(model.init)(
        jax.random.PRNGKey(5), **{k: jnp.asarray(batch[k]) for k in (
            "image", "text_ids", "text_padding_mask", "img_shape")})
    want = evaluate(model, params, loader, is_grec=True)
    sd = {k: torch.from_numpy(v.copy()) for k, v in
          export_simvg_full(jax.tree.map(np.asarray, params)).items()}
    save_checkpoint(str(tmp_path), "from_jax", params=sd, block=True)

    got = test_cli.main([GREC, str(tmp_path / "from_jax"), "--device", "cpu",
                         "--cfg-options", *opts])["val"]
    assert got["n_samples"] == len(ds) == 6
    for k in ("decoder_F1_score", "decoder_N_acc", "token_F1_score",
              "token_N_acc", "det_acc", "miou"):
        assert got[k] == want[k], (k, got[k], want[k])


def test_port_gates_accept_the_shipped_configs():
    """Config.fromfile, check_ported (also as a ``--distributed`` run),
    build_model on the meta device, every split's pipeline and dataset
    class, over every top-level config: all 73 pass, the OneStageModel
    family's ``tiny_synth_onestage.py`` included."""
    import glob

    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.data.builder import build_pipeline
    from simvg_tpu_torch.data.datasets import build_dataset
    from simvg_tpu_torch.models import build_model

    files = sorted(f for f in glob.glob(osp.join(REPO, "configs", "**",
                                                 "*.py"), recursive=True)
                   if "_base_" not in f)
    refused = {}
    for path in files:
        try:
            cfg = Config.fromfile(path)
            train_cli.check_ported(cfg, distributed=True)
            build_model(cfg.model, img_size=cfg.get("img_size", 640),
                        device="meta")
            for split in ["train"] + train_cli.eval_splits(cfg):
                split_cfg = cfg.data[split]
                build_pipeline(split_cfg.get("pipeline"))
                with pytest.raises(FileNotFoundError):  # class found first
                    build_dataset(split_cfg.get("type", cfg.get("dataset")),
                                  imgsfile="", annsfile=osp.join(
                                      REPO, "no_such_dir", "a.json"))
        except NotImplementedError as e:
            refused[osp.basename(path)] = str(e)
    assert len(files) == 73
    assert not refused, refused


def test_port_gates_accept_the_mask_bases_under_the_flagship():
    """The four segmentation and multi-task dataset bases (with_mask,
    SampleMaskVertices, the word-vocab tokenizer), each under the flagship
    model: every split's pipeline builds and its dataset class is found."""
    import glob

    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.data.builder import build_pipeline
    from simvg_tpu_torch.data.datasets import build_dataset
    from simvg_tpu_torch.data.transforms import SampleMaskVertices
    from simvg_tpu_torch.models import build_model

    flagship = Config.fromfile(osp.join(
        REPO, "configs", "single", "ViT-base", "refcoco",
        "refcoco_onestage.py"))
    bases = sorted(glob.glob(osp.join(REPO, "configs", "_base_", "datasets",
                                      "*", "*.py")))
    bases = [b for b in bases if "segmentation" in b or "multi-task" in b]
    assert len(bases) == 8
    for path in bases:
        cfg = Config.fromfile(path)
        train_cli.check_ported(flagship)
        build_model(flagship.model, device="meta")
        for split in ("train", "val", "testA", "testB", "test"):
            if split not in cfg.data:
                continue
            tfs, load = build_pipeline(cfg.data[split]["pipeline"])
            assert load["with_mask"], (path, split)
            assert any(isinstance(t, SampleMaskVertices) for t in tfs) == \
                (split == "train"), (path, split)
            with pytest.raises(FileNotFoundError):
                build_dataset(cfg.data[split]["type"], imgsfile="",
                              annsfile=osp.join(REPO, "no_such_dir", "a.json"),
                              with_mask=True,
                              with_bbox=load.get("with_bbox", False))


VGTR_BASE = osp.join(REPO, "configs", "_base_", "datasets", "detection",
                     "refcoco-unc_vgtr.py")
# the tiny config with the VGTR base's train pipeline at 64 px
VGTR_CONFIG = """_base_ = [{tiny!r}]
train_pipeline = [
    dict(type="LoadImageAnnotationsFromFile", max_token=10, with_bbox=True,
         dataset="RefCOCOUNC", use_token_type="beit3"),
    dict(type="VGTRAugment", img_size=64),
    dict(type="Normalize", mean=[123.675, 116.28, 103.53],
         std=[58.395, 57.12, 57.375]),
    dict(type="Pad", size_divisor=32),
    dict(type="DefaultFormatBundle"),
    dict(type="CollectData", keys=["img", "ref_expr_inds", "gt_bbox"]),
]
data = dict(train=dict(pipeline=train_pipeline))
"""


def test_port_gates_accept_the_vgtr_base_under_the_flagship():
    """``refcoco-unc_vgtr.py``, the one dataset base that sets
    VGTRAugment, under the flagship model: its splits' pipelines build
    (VGTRAugment at 512 px in train only) and its dataset class is
    found."""
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.data.builder import build_pipeline
    from simvg_tpu_torch.data.datasets import build_dataset
    from simvg_tpu_torch.data.vgtr_aug import VGTRAugment
    from simvg_tpu_torch.models import build_model

    flagship = Config.fromfile(osp.join(
        REPO, "configs", "single", "ViT-base", "refcoco",
        "refcoco_onestage.py"))
    train_cli.check_ported(flagship)
    build_model(flagship.model, device="meta")
    cfg = Config.fromfile(VGTR_BASE)
    for split in ("train", "val"):
        tfs, load = build_pipeline(cfg.data[split]["pipeline"])
        vgtr = [t for t in tfs if isinstance(t, VGTRAugment)]
        assert [t.img_size for t in vgtr] == ([512] if split == "train"
                                              else []), split
        assert load["with_bbox"] and load["max_token"] == 20
        with pytest.raises(FileNotFoundError):
            build_dataset(cfg.data[split]["type"], imgsfile="",
                          annsfile=osp.join(REPO, "no_such_dir", "a.json"),
                          with_bbox=True)


def test_train_cli_with_the_vgtr_pipeline(tmp_path, synth):
    """One epoch of the train CLI with VGTRAugment in the train pipeline:
    it trains (finite losses) and evaluates."""
    config = tmp_path / "tiny_vgtr.py"
    config.write_text(VGTR_CONFIG.format(tiny=TINY))
    wd = tmp_path / "run"
    res = train_cli.main([str(config), "--work-dir", str(wd), "--device",
                          "cpu", "--cfg-options", *synth,
                          "scheduler_config.max_epoch=1"])
    assert res["step"] == 2 and res["eval"]["val"]["n_samples"] == 8
    assert "VGTRAugment" in (wd / "config.py").read_text()
    with open(wd / "metrics.jsonl") as f:
        train = [json.loads(line) for line in f if '"train"' in line]
    assert train and all(np.isfinite(m["loss_total"]) for m in train)
