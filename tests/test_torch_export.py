"""Serving export of simvg_tpu_torch (``simvg_tpu_torch/export.py``, on
``torch.export``), on the CPU: the counterparts of
tests/test_export_serving.py that have no int8 and no cross-platform
lowering.

- a saved and loaded program gives the eager eval step's predictions bit
  for bit (the same operators on the same device);
- a program exported at batch 2 with a polymorphic batch serves batches 1
  and 3;
- the graph holds the K1 operator ``simvg::attention_fwd`` once per encoder
  layer (``attn_impl="pallas"``; on CPU tensors it runs K1's plain
  version), so the exported path cannot fall back to plain attention;
- weights as an argument: one program, two weight sets;
- the CLI end to end, and a ``normalize_on_device`` config, whose program
  takes uint8 images and normalises them inside;
- ``platforms=`` has no counterpart and raises.
"""

import dataclasses
import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

from util_synth import make_refcoco_style
from util_torch_port import np_batch, to_torch, torch_tiny_model

from simvg_tpu_torch.engine import make_eval_step
from simvg_tpu_torch.export import (attention_op_count, export_serving,
                                    load_exported, make_serving_fn,
                                    save_exported)
from simvg_tpu_torch.models import init_random_weights
from simvg_tpu_torch.models.model import SimVGModel
from simvg_tpu_torch.tools import export_serving as export_cli
from util_torch_port import one_torch_thread  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY = osp.join(REPO, "configs", "smoke", "tiny_synth.py")


def _model(seed=0):
    cfg = torch_tiny_model().cfg
    cfg = dataclasses.replace(
        cfg, beit3=dataclasses.replace(cfg.beit3, attn_impl="pallas"))
    model = SimVGModel(cfg)
    init_random_weights(model, seed)
    return model.eval()


def _assert_equal(out, ref):
    assert set(out) == set(ref) == {"decoder", "token"}
    for br in ref:
        assert set(out[br]) == set(ref[br])
        for k in ref[br]:
            torch.testing.assert_close(out[br][k], ref[br][k], rtol=0,
                                       atol=0, msg=f"{br}/{k}")


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture(scope="module")
def polymorphic(model, tmp_path_factory):
    f = str(tmp_path_factory.mktemp("poly") / "m.pt2")
    save_exported(f, export_serving(model, to_torch(np_batch(b=2)),
                                    polymorphic_batch=True))
    return load_exported(f)


def test_export_roundtrip_equals_eager(model, tmp_path):
    batch = to_torch(np_batch(b=2))
    direct = make_eval_step(model)(batch)
    with torch.no_grad():
        _assert_equal(make_serving_fn(model)(batch), direct)
    f = str(tmp_path / "m.pt2")
    save_exported(f, export_serving(model, batch))
    prog = load_exported(f)
    assert prog.meta["inputs"]["image"] == [[2, 64, 64, 3], "float32"]
    _assert_equal(prog.call(batch), direct)
    # the dtype checks that torch.export put before each conversion are
    # out of the graph; the call checks the batch's dtypes instead
    assert not any(n.target == torch.ops.aten._assert_tensor_metadata.default
                   for n in prog.program.graph.nodes)
    with pytest.raises(TypeError, match="dtypes"):
        prog.call(dict(batch, image=batch["image"].double()))


def test_export_polymorphic_batch(model, polymorphic):
    """Exported at batch 2, called at 1 and 3; an example batch of 1 is
    traced at 2 (torch.export would specialise a dimension of size 1)."""
    from simvg_tpu_torch.export import serving_specs

    assert polymorphic.meta["polymorphic_batch"]
    example, dynamic = serving_specs(to_torch(np_batch(b=1)), True)
    assert example["image"].shape[0] == 2 and set(dynamic) == set(example)
    for b in (1, 3):
        batch = to_torch(np_batch(b=b, seed=b))
        out = polymorphic.call(batch)
        assert out["token"]["best_box"].shape == (b, 4)
        _assert_equal(out, make_eval_step(model)(batch))


def test_exported_graph_holds_the_k1_op(model, polymorphic):
    """One simvg::attention_fwd node per encoder layer, before and after a
    save and load; the plain path's einsum/softmax core is not in the
    encoder's place."""
    layers = model.cfg.beit3.num_layers
    assert attention_op_count(polymorphic) == layers
    prog = export_serving(model, to_torch(np_batch(b=2)))
    assert attention_op_count(prog) == layers
    # the same model with attn_impl="xla" has no such node
    cfg = model.cfg
    plain = SimVGModel(dataclasses.replace(
        cfg, beit3=dataclasses.replace(cfg.beit3, attn_impl="xla"))).eval()
    plain.load_state_dict(model.state_dict())
    assert attention_op_count(export_serving(
        plain, to_torch(np_batch(b=2)))) == 0


def test_export_weights_as_argument(model, tmp_path):
    """bake_weights=False: ``call(params, batch)``; the program holds no
    weights and serves two weight sets, each equal to its eager step."""
    batch = to_torch(np_batch(b=2))
    f = str(tmp_path / "arg.pt2")
    save_exported(f, export_serving(model, batch, bake_weights=False))
    prog = load_exported(f)
    assert prog.meta["weights_as_argument"]
    assert not prog.program.state_dict
    _assert_equal(prog.call(dict(model.state_dict()), batch),
                  make_eval_step(model)(batch))
    other = _model(seed=7)
    out2 = prog.call(dict(other.state_dict()), batch)
    _assert_equal(out2, make_eval_step(other)(batch))
    assert not torch.equal(out2["token"]["best_score"],
                           make_eval_step(model)(batch)["token"]["best_score"])
    with pytest.raises(TypeError, match="bake_weights=False"):
        prog.call(batch)


def _int8_static(seed=0):
    """The tiny model in int8_static, with K1, calibrated on one batch."""
    from simvg_tpu_torch.ops import quant as q

    base = _model(seed)
    models = {}
    for mode in ("int8_calib", "int8_static"):
        m = SimVGModel(dataclasses.replace(base.cfg, beit3=dataclasses.replace(
            base.cfg.beit3, quant=mode))).eval()
        m.load_state_dict(base.state_dict(), strict=True)
        models[mode] = m
    with torch.no_grad():
        models["int8_calib"](**to_torch(np_batch(b=2, seed=9)))
    static = models["int8_static"]
    q.set_quant_collection(static, q.build_quant_collection(
        static, q.calibration_amax(models["int8_calib"])))
    return static


def test_export_int8_static(tmp_path):
    """int8_static exports with baked weights and with weights as an
    argument: 12 _int_mm nodes a layer beside its K1 node, outputs equal
    to the eager step's bit for bit, "quantized" in the meta.  With
    weights as an argument the quant tensors travel in the argument
    (``serving_state``), not as constants of the program: other scales in
    the argument give other outputs."""
    from simvg_tpu_torch.export import int_mm_op_count, serving_state

    model = _int8_static()
    layers = model.cfg.beit3.num_layers
    batch = to_torch(np_batch(b=2))
    direct = make_eval_step(model)(batch)
    for bake in (True, False):
        f = str(tmp_path / f"q{bake}.pt2")
        save_exported(f, export_serving(model, batch, bake_weights=bake))
        prog = load_exported(f)
        assert prog.meta["quantized"]
        assert int_mm_op_count(prog) == 12 * layers
        assert attention_op_count(prog) == layers
        if bake:
            _assert_equal(prog.call(batch), direct)
            continue
        assert not prog.program.state_dict
        assert not any(v.dtype == torch.int8
                       for v in prog.program.constants.values())
        params = serving_state(model)
        assert {k for k in params if k.endswith(".w_q")}
        _assert_equal(prog.call(params, batch), direct)
        halved = {k: v / 2 if k.endswith(".act_scale") else v
                  for k, v in params.items()}
        assert not torch.equal(prog.call(halved, batch)["token"]["best_box"],
                               direct["token"]["best_box"])


def test_export_platforms_raise(model):
    with pytest.raises(ValueError, match="no counterpart"):
        export_serving(model, to_torch(np_batch(b=2)), platforms=("tpu",))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    imgdir, ann = make_refcoco_style(str(tmp_path_factory.mktemp("synth")),
                                     2, 2)
    return [f"data.val.annsfile={ann}", f"data.val.imgsfile={imgdir}"]


def test_export_cli_e2e(tmp_path, synth):
    """The CLI (random weights, polymorphic): file, meta, load, call."""
    out = str(tmp_path / "m.pt2")
    meta = export_cli.main([TINY, "--out", out, "--polymorphic-batch",
                            "--device", "cpu", "--cfg-options", *synth])
    assert os.path.getsize(out) == meta["bytes"]
    with open(out + ".json") as f:
        assert json.load(f) == meta
    assert meta["attention_op_nodes"] == 0  # tiny_synth.py: attn_impl xla
    prog = load_exported(out)
    b, t = 3, meta["inputs"]["text_ids"][0][1]
    r = np.random.default_rng(0)
    preds = prog.call(dict(
        image=torch.from_numpy(r.normal(size=(b, 64, 64, 3)).astype(
            np.float32)),
        text_ids=torch.from_numpy(r.integers(1, 100, (b, t)).astype(
            np.int32)),
        text_padding_mask=torch.zeros(b, t, dtype=torch.int32),
        img_shape=torch.full((b, 2), 64, dtype=torch.int32)))
    assert preds["token"]["best_box"].shape == (b, 4)
    assert torch.isfinite(preds["token"]["best_box"]).all()


def test_export_cli_normalize_on_device(tmp_path, synth):
    """normalize_on_device: the program's image input is uint8 (the host
    Normalize op left out) and it normalises inside, as the eval step with
    device_norm does."""
    from simvg_tpu_torch.config import Config
    from simvg_tpu_torch.tools.test import serving_model
    from simvg_tpu_torch.tools.train import device_norm_of

    out = str(tmp_path / "m.pt2")
    meta = export_cli.main([TINY, "--out", out, "--device", "cpu",
                            "--cfg-options", "normalize_on_device=True",
                            *synth])
    assert meta["inputs"]["image"][1] == "uint8", meta["inputs"]
    b, t = meta["inputs"]["image"][0][0], meta["inputs"]["text_ids"][0][1]
    r = np.random.default_rng(0)
    batch = dict(
        image=torch.from_numpy(r.integers(0, 255, (b, 64, 64, 3)).astype(
            np.uint8)),
        text_ids=torch.from_numpy(r.integers(1, 100, (b, t)).astype(
            np.int32)),
        text_padding_mask=torch.zeros(b, t, dtype=torch.int32),
        img_shape=torch.full((b, 2), 64, dtype=torch.int32))
    preds = load_exported(out).call(batch)
    cfg = Config.fromfile(TINY)
    cfg.merge_from_dict({"normalize_on_device": True})
    model = serving_model(cfg, None, torch.device("cpu"))
    _assert_equal(preds, make_eval_step(
        model, device_norm=device_norm_of(cfg))(batch))
