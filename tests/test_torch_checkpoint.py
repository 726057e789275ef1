"""simvg_tpu_torch's checkpoints, load modes and weight conversions, on the
CPU.

- a save and load round trip is bit-exact, saves snapshot the tensors at
  the call, and a kill between the item writes and the swap leaves the
  previous ``latest`` loadable;
- 2 epochs of the train CLI equal 1 epoch plus a resume from ``latest``,
  bit for bit (weights, optimizer moments, EMA, counters);
- ``--load-from`` and ``--finetune-from`` restore what the JAX CLI's do;
- port weights -> ``tools.convert_checkpoint.convert_simvg_full`` -> the
  JAX forward equals the port's forward at 1e-5 (the full-model bound of
  tests/test_converter_e2e.py);
- the BEiT-3 pretrain fixture through ``load_pretrained_into_model`` equals
  JAX ``load_pretrained_into_params`` + ``export_simvg_full`` key for key.
"""

import json
import os
import os.path as osp

import jax
import numpy as np
import pytest
import torch

from util_synth import make_refcoco_style
from util_torch_port import (cheap_jit, jax_params_from_port,
                             jax_tiny_model, np_batch, to_jax, to_torch,
                             torch_tiny_model)

from simvg_tpu_torch.engine import create_optimizer, create_train_state
from simvg_tpu_torch.models import init_random_weights
from simvg_tpu_torch.tools import train as train_cli
from simvg_tpu_torch.utils import checkpoint as ckpt
from util_torch_port import one_torch_thread  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY = osp.join(REPO, "configs", "smoke", "tiny_synth.py")


def _model_and_state(seed=0):
    model = torch_tiny_model()
    init_random_weights(model, torch.Generator().manual_seed(seed))
    opt = create_optimizer(1e-3, 2)
    state = create_train_state(model, opt, ema=True)
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    grads = [torch.randn_like(p) for p in params]
    state.opt_state = opt.apply(names, params, grads, state.opt_state)
    state.step, state.ema_step = 1, 1
    return model, state, names


def _save(work_dir, name, model, state, names, block=False, epoch=1):
    return ckpt.save_checkpoint(
        str(work_dir), name, params=model.state_dict(),
        opt_state=ckpt.opt_state_to_dict(names, state.opt_state),
        ema_params=dict(zip(names, state.ema_params)), epoch=epoch,
        step=state.step, metrics={"best_det_acc": 12.5},
        ema_step=state.ema_step, block=block)


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_round_trip_is_bit_exact(tmp_path):
    model, state, names = _model_and_state()
    path = _save(tmp_path, "latest", model, state, names)
    ck = ckpt.load_checkpoint(path, with_opt=True, with_ema=True)
    _assert_same(ck["params"], model.state_dict())
    _assert_same(ck["ema_params"], dict(zip(names, state.ema_params)))
    saved = ck["opt_state"]
    assert saved["count"] == 1
    for key in ("mu", "nu", "nu_max"):
        _assert_same(saved[key], dict(zip(names, getattr(state.opt_state,
                                                         key))))
    assert (ck["epoch"], ck["step"], ck["ema_step"]) == (1, 1, 1)
    assert ck["metrics"] == {"best_det_acc": 12.5}
    assert sorted(os.listdir(path)) == ["ema_params", "meta.json",
                                        "opt_state", "params"]
    # the optimizer item goes back into a fresh state in place
    fresh = create_train_state(model, create_optimizer(1e-3, 2))
    ckpt.load_opt_state(names, saved, fresh.opt_state)
    assert fresh.opt_state.count == 1
    for a, b in zip(fresh.opt_state.nu_max, state.opt_state.nu_max):
        assert torch.equal(a, b)


def test_save_snapshots_tensors_at_the_call(tmp_path):
    model, state, names = _model_and_state()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    path = _save(tmp_path, "latest", model, state, names)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)  # an in-place update while the write is pending
    ckpt.wait_for_checkpoints()
    _assert_same(ckpt.load_checkpoint(path)["params"], before)


def test_kill_between_item_write_and_swap_keeps_the_old_latest(
        tmp_path, monkeypatch):
    model, state, names = _model_and_state()
    old = {k: v.clone() for k, v in model.state_dict().items()}
    _save(tmp_path, "latest", model, state, names, block=True)

    def killed(tmp, path, meta):
        raise KeyboardInterrupt("killed before meta.json and the swap")

    monkeypatch.setattr(ckpt, "_commit", killed)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(2.0)
    with pytest.raises(KeyboardInterrupt):
        _save(tmp_path, "latest", model, state, names, block=True,
              epoch=2)
    partial = [d for d in os.listdir(tmp_path) if ".tmp" in d]
    assert partial and not osp.exists(tmp_path / partial[0] / "meta.json")
    latest = ckpt.latest_checkpoint(str(tmp_path))
    assert latest == str(tmp_path / "latest")
    ck = ckpt.load_checkpoint(latest)
    assert ck["epoch"] == 1
    _assert_same(ck["params"], old)
    with pytest.raises(FileNotFoundError, match="meta.json"):
        ckpt.load_checkpoint(str(tmp_path / partial[0]))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    imgdir, ann = make_refcoco_style(str(tmp_path_factory.mktemp("synth")),
                                     8, 4)
    return [f"data.{s}.{k}={v}" for s in ("train", "val")
            for k, v in (("annsfile", ann), ("imgsfile", imgdir))]


def _train(work_dir, synth, *extra, max_epoch=2):
    return train_cli.main([TINY, "--work-dir", str(work_dir), "--device",
                           "cpu", *extra, "--cfg-options", *synth,
                           f"scheduler_config.max_epoch={max_epoch}"])


@pytest.mark.parametrize("mode", ["--resume-from", "--auto-resume"])
def test_resume_equals_an_uninterrupted_run(tmp_path, synth, mode):
    full = _train(tmp_path / "full", synth)
    first = _train(tmp_path / "split", synth, max_epoch=1)
    assert first["step"] == 2
    args = ([mode, str(tmp_path / "split" / "latest")]
            if mode == "--resume-from" else [mode])
    resumed = _train(tmp_path / "split", synth, *args)
    assert resumed["start_epoch"] == 1 and resumed["step"] == full["step"]
    assert resumed["eval"] == full["eval"]
    assert resumed["best_det_acc"] == full["best_det_acc"]
    a = ckpt.load_checkpoint(str(tmp_path / "full" / "latest"),
                             with_opt=True, with_ema=True)
    b = ckpt.load_checkpoint(str(tmp_path / "split" / "latest"),
                             with_opt=True, with_ema=True)
    _assert_same(a["params"], b["params"])
    _assert_same(a["ema_params"], b["ema_params"])
    for key in ("mu", "nu", "nu_max"):
        _assert_same(a["opt_state"][key], b["opt_state"][key])
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 4
    assert (a["epoch"], a["step"], a["ema_step"]) == \
        (b["epoch"], b["step"], b["ema_step"]) == (2, 4, 4)


def test_load_from_and_finetune_from_restore_as_the_jax_cli(tmp_path):
    model, state, names = _model_and_state(seed=1)
    src = _save(tmp_path, "stage1", model, state, names, block=True,
                epoch=7)

    other, fresh, _ = _model_and_state(seed=2)
    fresh = create_train_state(other, create_optimizer(1e-3, 2), ema=True)
    start, best = train_cli.restore(other, fresh, load_from=src)
    # weights and EMA from the checkpoint; optimizer and counters anew
    assert (start, best, fresh.step, fresh.opt_state.count) == \
        (0, -1.0, 0, 0)
    _assert_same(other.state_dict(), model.state_dict())
    for a, b in zip(fresh.ema_params, state.ema_params):
        assert torch.equal(a, b)
    assert all(not m.any() for m in fresh.opt_state.mu)

    # finetune: weights only, non-strict: a checkpoint that lacks a key
    # and has an extra one loads the rest and reports both
    sd = dict(model.state_dict())
    dropped = names[0]
    del sd[dropped]
    sd["head.no_such_layer.weight"] = torch.zeros(3)
    ckpt.save_checkpoint(str(tmp_path), "partial", params=sd, block=True)
    third, _, _ = _model_and_state(seed=3)
    kept = third.state_dict()[dropped].clone()
    st3 = create_train_state(third, create_optimizer(1e-3, 2), ema=True)
    ema_before = [t.clone() for t in st3.ema_params]
    assert train_cli.restore(third, st3, finetune_from=str(
        tmp_path / "partial")) == (0, -1.0)
    got = third.state_dict()
    assert torch.equal(got[dropped], kept)
    for k in sd:
        if k in got:
            assert torch.equal(got[k], sd[k]), k
    for a, b in zip(st3.ema_params, ema_before):
        assert torch.equal(a, b)  # finetune leaves the EMA shadow alone
    res = train_cli.load_non_strict(third, sd, None)
    assert res.missing_keys == [dropped]


def test_resume_restores_every_counter(tmp_path):
    model, state, names = _model_and_state(seed=4)
    state.step, state.ema_step = 6, 5
    src = _save(tmp_path, "latest", model, state, names, block=True,
                epoch=3)
    other, _, _ = _model_and_state(seed=5)
    st = create_train_state(other, create_optimizer(1e-3, 2), ema=True)
    start, best = train_cli.restore(other, st, resume_from=src)
    assert (start, best, st.step, st.ema_step, st.opt_state.count) == \
        (3, 12.5, 6, 5, 1)
    _assert_same(other.state_dict(), model.state_dict())


def test_port_weights_round_trip_into_the_jax_forward():
    model = torch_tiny_model()
    init_random_weights(model, torch.Generator().manual_seed(7))
    batch = np_batch()
    jm = jax_tiny_model()
    params = jax_params_from_port(jm, batch, model.state_dict())
    ref = cheap_jit(lambda p, b: jm.apply(p, **b, deterministic=True))(
        params, to_jax(batch))
    with torch.no_grad():
        out = model(**to_torch(batch))
    for k in ("class_decoder", "bbox_decoder", "class_token", "bbox_token"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_pretrained_fixture_loads_as_in_jax():
    from simvg_tpu.models.builder import build_model as jax_build
    from simvg_tpu_torch.convert import load_pretrained_into_model
    from simvg_tpu_torch.models import build_model
    from tools.convert_checkpoint import (export_simvg_full,
                                          load_pretrained_into_params)

    cfg = {"type": "MIXDETRMB",
           "vis_enc": {"vit_type": "base", "img_size": 64, "patch_size": 16,
                       "vocab_size": 80, "embed_dim": 32, "num_heads": 4,
                       "ffn_dim": 64, "num_layers": 2},
           "head": {"num_queries": 2, "in_channels": 32, "embed_dim": 32}}
    path = osp.join(REPO, "tests", "fixtures", "beit3_pretrain_tiny.pth")
    model, _ = build_model(cfg, img_size=64, device="cpu")
    init_random_weights(model, torch.Generator().manual_seed(8))
    jm, _ = jax_build(cfg, img_size=64)
    # both start from the same weights, which stay where nothing loads
    params = jax_params_from_port(jm, np_batch(2, 6), model.state_dict())
    ref = export_simvg_full(load_pretrained_into_params(params, path))
    loaded = load_pretrained_into_model(model, path)
    got = model.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    # the 8x8-grid, patch-8 checkpoint was interpolated to 4x4, patch 16
    assert "vis_enc.beit3.encoder.embed_positions.A.weight" in loaded
    assert got["vis_enc.beit3.vision_embed.proj.weight"].shape[-1] == 16
    assert len(loaded) == 91


def test_meta_json_is_plain_json(tmp_path):
    model, state, names = _model_and_state()
    path = _save(tmp_path, "det_best", model, state, names, block=True)
    with open(osp.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["items"] == ["ema_params", "opt_state", "params"]
