"""The port's int8 w8a8 path (``simvg_tpu_torch/ops/quant.py``, M17) held
against ``simvg_tpu/ops/quant.py`` on the CPU.

The same numpy-seeded weights and inputs go through JAX's ``Int8Dense``
and the port's ``Int8Linear`` in each mode: the int8 values and their
scales are bit-equal, the int32 accumulators equal, the float32 outputs
within OUT_ATOL (the same operations in the same order; only a float32
matmul in calib/qat sums in another order).

Tiny encoder and full model under ``int8`` and ``int8_static``: within
``util_torch_port.assert_int8_close`` of JAX (5e-3 at most, 2e-4 on the
mean).  It is looser than the float model's 1e-5 because a 2e-5
difference upstream (float32 summation order in a LayerNorm or matmul)
can move an activation across a k + 0.5 boundary of its int8 grid, which
changes that value by one step, s_x * s_w * |w_q| in the output.

Also: the ``.npz`` artifact both ways (JAX-written into the port,
port-written into JAX, and a stacked ``scan_layers`` one), the artifact
functions (EMA re-quantization keeps ``act_scale``, a missing one raises),
the training guards, the empty segment, and the CLIs' ``--quant-collection``.
"""

import dataclasses
import os
import os.path as osp
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util_synth import make_refcoco_style
from util_torch_port import (INT8_MEAN_ATOL, TINY_BEIT3, assert_int8_close,
                             jax_tiny_model, np_batch, to_jax, to_torch,
                             torch_tiny_model)

from simvg_tpu_torch.convert import (export_simvg_full, load_jax_params,
                                     quant_key_to_jax, quant_keys_from_jax)
from simvg_tpu_torch.models.beit3 import BEiT3Config, BEiT3Encoder
from simvg_tpu_torch.models.layers import Linear
from simvg_tpu_torch.ops import quant as q

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY = osp.join(REPO, "configs", "smoke", "tiny_synth.py")
OUT_ATOL = 1e-6  # Int8Linear vs Int8Dense, float32, |y| ~ 1
QAT_ATOL = 1e-5  # a float32 matmul on both sides, summed in another order
JAX_MODES = ("dynamic", "static", "calib", "qat")


def _np_linear(seed=0, d_in=32, d_out=64, shape=(2, 7)):
    r = np.random.default_rng(seed)
    w = r.normal(0, 0.05, (d_out, d_in)).astype(np.float32)  # torch layout
    b = r.normal(0, 0.1, d_out).astype(np.float32)
    x = r.normal(0, 1.0, shape + (d_in,)).astype(np.float32)
    return w, b, x


def _port_linear(mode, w, b):
    layer = q.Int8Linear(w.shape[1], w.shape[0], mode=mode)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
        layer.bias.copy_(torch.from_numpy(b))
    return torch.nn.Sequential(layer)  # a name ("0") for the collection


def test_quantize_symmetric_is_bit_equal_to_jax():
    from simvg_tpu.ops.quant import quantize_symmetric as jq

    w, _, x = _np_linear(1)
    x[0, 0, 0] = 0.0  # a zero, and a row of zeros: the 1e-8 floor
    w[3] = 0.0
    for arr, jax_axis, dim in ((w.T, 0, 1), (x, None, None)):
        qj, sj = jq(jnp.asarray(arr), axis=jax_axis)
        qt, st = q.quantize_symmetric(
            torch.from_numpy(arr.T.copy() if dim == 1 else arr), dim)
        qt = qt.numpy().T if dim == 1 else qt.numpy()
        assert qt.dtype == np.int8
        np.testing.assert_array_equal(qt, np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("mode", JAX_MODES)
def test_int8_linear_matches_int8_dense(mode, monkeypatch):
    from simvg_tpu.ops.quant import Int8Dense, quantize_symmetric as jq

    w, b, x = _np_linear(2)
    x2 = 1.5 * _np_linear(3)[2]  # a second calibration batch
    dense = Int8Dense(w.shape[0], dtype=jnp.float32, mode=mode)
    variables = {"params": {"kernel": jnp.asarray(w.T),
                            "bias": jnp.asarray(b)}}
    port = _port_linear(mode, w, b)
    act_scale = np.float32(0.8 * np.abs(x).max())  # some values saturate
    if mode == "static":
        w_q, s_w = jq(jnp.asarray(w.T), axis=0)
        variables["quant"] = {"w_q": w_q, "s_w": s_w,
                              "act_scale": jnp.asarray(act_scale)}
        q.set_quant_collection(port, {
            "0.w_q": torch.from_numpy(np.asarray(w_q).T.copy()),
            "0.s_w": torch.from_numpy(np.array(s_w)),
            "0.act_scale": torch.tensor(act_scale)})
    if mode == "calib":
        variables["quant"] = {"act_amax": jnp.zeros((), jnp.float32)}
        for xb in (x, x2):
            y_j, mut = dense.apply(variables, jnp.asarray(xb),
                                   mutable=["quant"])
            variables["quant"] = mut["quant"]
            with torch.no_grad():
                y_t = port(torch.from_numpy(xb))
        assert float(port[0].act_amax) == float(
            variables["quant"]["act_amax"]) == np.abs(x2).max()
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                                   atol=QAT_ATOL, rtol=0)
        return

    accumulators = []

    def recording(a, bm):
        out = torch._int_mm(a, bm)
        accumulators.append(out)
        return out

    monkeypatch.setattr(q, "int_mm", recording)
    xt = torch.from_numpy(x).requires_grad_(mode == "qat")
    y_t = port(xt)
    y_j = dense.apply(variables, jnp.asarray(x))
    if mode == "qat":
        np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                                   atol=QAT_ATOL, rtol=0)
        # the straight-through gradients, against JAX's on the same loss
        (y_t ** 2).sum().backward()
        g_j, gx_j = jax.grad(lambda v, xx: (dense.apply(v, xx) ** 2).sum(),
                             argnums=(0, 1))(variables, jnp.asarray(x))
        for got, want in ((port[0].weight.grad.numpy().T,
                           g_j["params"]["kernel"]),
                          (port[0].bias.grad.numpy(), g_j["params"]["bias"]),
                          (xt.grad.numpy(), gx_j)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                       atol=QAT_ATOL)
        assert not accumulators
        return

    # the int8 operands and int32 accumulators of Int8Dense's product
    if mode == "static":
        s_x = jnp.maximum(jnp.asarray(act_scale) / 127.0, 1e-8)
        x_q = jnp.clip(jnp.round(jnp.asarray(x) / s_x), -127,
                       127).astype(jnp.int8)
        w_q = variables["quant"]["w_q"]
    else:
        w_q, _ = jq(jnp.asarray(w.T), axis=0)
        x_q, _ = jq(jnp.asarray(x))
    acc_j = jax.lax.dot_general(x_q, w_q, (((2,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
    assert len(accumulators) == 1 and accumulators[0].dtype == torch.int32
    np.testing.assert_array_equal(accumulators[0].numpy(),
                                  np.asarray(acc_j).reshape(-1, w.shape[0]))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               atol=OUT_ATOL, rtol=0)
    assert not np.allclose(y_t.detach().numpy(),
                           x @ w.T + b, atol=1e-3)  # really quantized


def test_int8_linear_keeps_the_linear_parameters():
    """Every mode has Linear's state dict: checkpoints load strict, and the
    quant tensors stay out of it."""
    ref = torch.nn.Sequential(Linear(32, 64))
    for mode in ("dynamic", "static", "calib", "qat"):
        m = _port_linear(mode, *_np_linear()[:2])
        assert m.state_dict().keys() == ref.state_dict().keys()
        m.load_state_dict(ref.state_dict(), strict=True)
        if mode == "static":
            assert {n for n, _ in m.named_buffers()} == {
                "0.w_q", "0.s_w", "0.act_scale"}
            with pytest.raises(RuntimeError, match="attach_static_quant"):
                m(torch.zeros(2, 32))


def test_int8_linear_empty_segment():
    """A zero-length segment takes the float matmul; calib records
    nothing."""
    w, b, _ = _np_linear()
    for mode in ("dynamic", "static", "calib", "qat"):
        m = _port_linear(mode, w, b)
        if mode == "static":
            q.attach_static_quant(m)
        out = m(torch.zeros(2, 0, 32))
        assert out.shape == (2, 0, 64)
        if mode == "calib":
            assert float(m[0].act_amax) == 0.0


def test_int_mm_padding_rows_change_no_row():
    """The card's M > 16 rule: zero rows appended to a short operand leave
    the other rows' products as they were."""
    r = np.random.default_rng(4)
    a = torch.from_numpy(r.integers(-127, 128, (5, 32)).astype(np.int8))
    b = torch.from_numpy(r.integers(-127, 128, (64, 32)).astype(np.int8))
    padded = torch.cat([a, a.new_zeros(q._CUDA_MIN_ROWS - 5, 32)])
    want = a.double() @ b.double().t()
    assert torch.equal(torch._int_mm(padded, b.t())[:5].double(), want)
    assert torch.equal(q.int_mm(a, b.t()).double(), want)


# --- the encoder and the model against JAX ---------------------------------

def _jax_encoder(quant="none", **kw):
    from simvg_tpu.models.beit3 import BEiT3Config as JCfg, BEiT3Encoder as J

    return J(JCfg(**dict(TINY_BEIT3, quant=quant, **kw)))


def _enc_inputs(seed=5):
    b = np_batch(b=3, seed=seed)
    return b["image"], b["text_ids"], b["text_padding_mask"]


def _jax_calibrate(quant_model, params, batches, prefix=()):
    """JAX's calibration: an int8_calib apply per batch with the mutable
    "quant" collection, then build_quant_collection for the static model
    (quantize_serving.py's steps)."""
    from simvg_tpu.ops.quant import build_quant_collection

    calib, static = quant_model("int8_calib"), quant_model("int8_static")
    skel = jax.eval_shape(lambda: calib.init(jax.random.PRNGKey(0),
                                             *batches[0]))["quant"]
    amax = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), skel)
    step = jax.jit(lambda a, batch: calib.apply(
        {"params": params, "quant": a}, *batch, mutable=["quant"])[1])
    for batch in batches:
        amax = step(amax, batch)["quant"]
    skel_st = jax.eval_shape(lambda: static.init(jax.random.PRNGKey(0),
                                                 *batches[0]))["quant"]
    return static, skel_st, build_quant_collection(params, skel_st, amax,
                                                   margin=1.05)


@pytest.fixture(scope="module")
def enc_params():
    img, ids, pad = _enc_inputs()
    params = _jax_encoder().init(jax.random.PRNGKey(11), img, ids, pad)
    return jax.tree.map(np.asarray, params["params"])


def _port_encoder(params, quant="none", **kw):
    enc = BEiT3Encoder(BEiT3Config(**dict(TINY_BEIT3, quant=quant, **kw)))
    sd = export_simvg_full({"params": {"beit3": params}})
    enc.load_state_dict({k[len("vis_enc.beit3."):]: torch.from_numpy(v)
                         for k, v in sd.items()}, strict=True)
    return enc.eval()


def _assert_close(out_t, out_j):
    for a, b in zip(out_t, out_j):
        assert_int8_close(a.detach().numpy(), b)


@pytest.mark.parametrize("quant", ["int8", "int8_static"])
def test_tiny_encoder_int8_matches_jax(enc_params, quant, tmp_path):
    from simvg_tpu.ops.quant import save_quant_collection

    inputs = _enc_inputs(6)
    calib_batches = [_enc_inputs(s) for s in (7, 8)]
    variables = {"params": enc_params}
    port = _port_encoder(enc_params, quant)
    if quant == "int8_static":
        model, _, qcol = _jax_calibrate(_jax_encoder, enc_params,
                                        calib_batches)
        variables["quant"] = qcol
        npz = str(tmp_path / "q.npz")
        save_quant_collection(npz, jax.device_get(qcol))
        q.attach_static_quant(port, npz)
    else:
        model = _jax_encoder(quant)
    out_j = model.apply(variables, *inputs)
    with torch.no_grad():
        out_t = port(*map(torch.from_numpy, inputs))
    _assert_close(out_t, out_j)
    fp = _port_encoder(enc_params)
    with torch.no_grad():
        out_fp = fp(*map(torch.from_numpy, inputs))
    # the int8 model's own drift from float32 is ten times the bound
    assert min((a - b).abs().mean().item()
               for a, b in zip(out_t, out_fp)) > 10 * INT8_MEAN_ATOL


def _jax_model(quant):
    m = jax_tiny_model()
    return type(m)(dataclasses.replace(
        m.cfg, beit3=dataclasses.replace(m.cfg.beit3, quant=quant)))


def _port_model(quant):
    m = torch_tiny_model()
    return type(m)(dataclasses.replace(
        m.cfg, beit3=dataclasses.replace(m.cfg.beit3, quant=quant))).eval()


@pytest.fixture(scope="module")
def model_params():
    params = jax.jit(jax_tiny_model().init)(jax.random.PRNGKey(7),
                                            **to_jax(np_batch()))
    return jax.tree.map(np.asarray, params["params"])


def _model_batches():
    names = ("image", "text_ids", "text_padding_mask", "img_shape")
    return [tuple(np_batch(seed=s)[k] for k in names) for s in (21, 22)]


@pytest.fixture(scope="module")
def jax_artifact(model_params, tmp_path_factory):
    """JAX's calibrated artifact of the tiny model: (static model, its
    quant skeleton, the collection, the .npz path)."""
    from simvg_tpu.ops.quant import save_quant_collection

    static, skel, qcol = _jax_calibrate(_jax_model, model_params,
                                        _model_batches())
    npz = str(tmp_path_factory.mktemp("quant") / "jax.npz")
    save_quant_collection(npz, jax.device_get(qcol))
    return static, skel, qcol, npz


@pytest.mark.parametrize("quant", ["int8", "int8_static"])
def test_tiny_model_int8_matches_jax(model_params, jax_artifact, quant):
    batch = np_batch(seed=23)
    port = load_jax_params(_port_model(quant), {"params": model_params})
    if quant == "int8_static":
        model, _, qcol, npz = jax_artifact
        variables = {"params": model_params, "quant": qcol}
        q.attach_static_quant(port, npz)
    else:
        model, variables = _jax_model(quant), {"params": model_params}
    out_j = model.apply(variables, **to_jax(batch))
    with torch.no_grad():
        out_t = port(**to_torch(batch))
    for k in ("class_decoder", "bbox_decoder", "class_token", "bbox_token"):
        assert_int8_close(out_t[k].numpy(), out_j[k], err_msg=k)


# --- the .npz artifact both ways --------------------------------------------

def test_quant_keys_round_trip_through_the_jax_names():
    port = _port_model("int8_static")
    names = [f"{n}.{leaf}" for n in q.quant_layers(port)
             for leaf in ("w_q", "s_w", "act_scale")]
    assert len(names) == 3 * 12 * TINY_BEIT3["num_layers"]
    for name in names:
        key = quant_key_to_jax(name)
        assert key.startswith("beit3/layers_")
        assert quant_keys_from_jax(key, np.zeros(()))[0][0] == name
    assert quant_key_to_jax(
        "vis_enc.beit3.encoder.layers.1.ffn.B.fc2.w_q") \
        == "beit3/layers_1/ffn/fc2_B/w_q"
    assert quant_key_to_jax("encoder.layers.0.self_attn.v_proj.A.s_w") \
        == "layers_0/self_attn/v_proj_A/s_w"


def test_jax_artifact_loads_into_the_port(model_params, jax_artifact):
    """Every entry of JAX's .npz under the port's names, w_q transposed to
    [out, in]; attached to the port's model, its act_scale entries are
    JAX's and w_q/s_w its own quantization of the same weights."""
    _, _, qcol, npz = jax_artifact
    flat = _flatten(jax.device_get(qcol))
    loaded = q.load_quant_collection(npz)
    assert len(loaded) == len(flat)
    for key, want in flat.items():
        (name, _), = quant_keys_from_jax(key, want)
        got = loaded[name].numpy()
        np.testing.assert_array_equal(got.T if key.endswith("w_q") else got,
                                      want)
    port = load_jax_params(_port_model("int8_static"),
                           {"params": model_params})
    q.attach_static_quant(port, npz)
    for name, m in q.quant_layers(port).items():
        assert float(m.act_scale) == float(loaded[f"{name}.act_scale"])
        np.testing.assert_array_equal(m.s_w.numpy(),
                                      loaded[f"{name}.s_w"].numpy())
        assert (m.w_q.int() - loaded[f"{name}.w_q"].int()).abs().max() <= 1


def _flatten(tree, prefix=""):
    """A nested collection -> {"/"-joined flax path: numpy array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_port_artifact_loads_into_jax(model_params, jax_artifact, tmp_path):
    """The port's .npz has JAX's keys, dtypes and shapes (w_q [in, out]);
    JAX's load_quant_collection and attach_static_quant take it, and the
    JAX model serves the same outputs from it as from its own artifact."""
    from simvg_tpu.ops.quant import (attach_static_quant,
                                     load_quant_collection)

    static, skel, qcol, npz = jax_artifact
    port = load_jax_params(_port_model("int8_static"),
                           {"params": model_params})
    q.attach_static_quant(port, npz)
    ours = str(tmp_path / "port.npz")
    q.save_quant_collection(ours, q.build_quant_collection(port, {
        f"{n}.act_amax": m.act_scale / 1.05
        for n, m in q.quant_layers(port).items()}, margin=1.05))
    want = _flatten(jax.device_get(qcol))
    got = _flatten(load_quant_collection(ours))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        if k.endswith("act_scale"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    batch = to_jax(np_batch(seed=24))
    a = static.apply(attach_static_quant({"params": model_params}, skel,
                                         ours), **batch)
    b = static.apply(attach_static_quant({"params": model_params}, skel,
                                         npz), **batch)
    for k in ("bbox_token", "bbox_decoder"):
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   atol=1e-5, rtol=0)


def test_stacked_scan_layers_artifact_is_unstacked(model_params,
                                                   jax_artifact, tmp_path):
    """An artifact calibrated under JAX scan_layers=True holds stacked
    layers/... entries with a leading layer axis; the port splits them
    into its layers, and they are the unrolled calibration's."""
    from simvg_tpu.ops.quant import save_quant_collection
    from tools.convert_checkpoint import stack_scan_layers

    def scan_model(quant):
        m = _jax_model(quant)
        return type(m)(dataclasses.replace(m.cfg, beit3=dataclasses.replace(
            m.cfg.beit3, scan_layers=True)))

    stacked = stack_scan_layers({"params": dict(
        model_params, beit3=dict(model_params["beit3"]))})["params"]
    _, _, qcol = _jax_calibrate(scan_model, stacked, _model_batches())
    npz = str(tmp_path / "scan.npz")
    save_quant_collection(npz, jax.device_get(qcol))
    keys = list(_flatten(jax.device_get(qcol)))
    assert all(k.startswith("beit3/layers/") for k in keys), keys[:3]
    got = q.load_quant_collection(npz, only=("act_scale",))
    want = q.load_quant_collection(jax_artifact[3], only=("act_scale",))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5)


# --- the artifact functions and the guards -----------------------------------

def test_attach_requantizes_weights_and_keeps_act_scale(model_params,
                                                        jax_artifact):
    """EMA weights: attach_static_quant quantizes the weights the model
    holds now while keeping the .npz's calibrated act_scale."""
    npz = jax_artifact[3]
    port = load_jax_params(_port_model("int8_static"),
                           {"params": model_params})
    q.attach_static_quant(port, npz)
    raw = {n: (m.w_q.clone(), m.s_w.clone(), m.act_scale.clone())
           for n, m in q.quant_layers(port).items()}
    with torch.no_grad():
        for p in port.parameters():
            p.mul_(1.5)
    q.attach_static_quant(port, npz)
    for n, m in q.quant_layers(port).items():
        assert torch.equal(m.act_scale, raw[n][2])
        assert float(m.act_scale) != 1.0
        torch.testing.assert_close(m.s_w, raw[n][1] * 1.5)
        want_q, want_s = q.quantize_symmetric(m.weight, 1)
        assert torch.equal(m.w_q, want_q) and torch.equal(m.s_w, want_s)


def test_missing_act_scale_raises_and_no_npz_warns(model_params, jax_artifact,
                                                   tmp_path, caplog):
    port = load_jax_params(_port_model("int8_static"),
                           {"params": model_params})
    z = dict(np.load(jax_artifact[3]))
    z.pop("beit3/layers_1/ffn/fc2_B/act_scale")
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **z)
    with pytest.raises(ValueError, match="no act_scale"):
        q.attach_static_quant(port, bad)
    with caplog.at_level("WARNING"):
        q.attach_static_quant(port)
    assert "saturates" in caplog.text
    assert all(float(m.act_scale) == 1.0
               for m in q.quant_layers(port).values())
    with pytest.raises(SystemExit, match="no quant layers"):
        q.attach_static_quant(_port_model("int8"), jax_artifact[3])


@pytest.mark.parametrize("quant", ["int8", "int8_calib", "int8_static"])
def test_serving_modes_refuse_training(quant):
    model = _port_model(quant).train()
    with pytest.raises(ValueError, match="serving-only"):
        model(**to_torch(np_batch()))
    enc = model.vis_enc["beit3"]
    with pytest.raises(ValueError, match="serving-only"):
        enc(*map(torch.from_numpy, _enc_inputs()))


def test_qat_trains_then_serves_static(model_params):
    """int8_qat passes the guard and gives every encoder Linear a gradient;
    its state dict loads into an int8_static model, which serves."""
    from simvg_tpu_torch.models.layers import set_generator

    qat = load_jax_params(_port_model("int8_qat"),
                          {"params": model_params}).train()
    set_generator(qat, torch.Generator().manual_seed(0))
    out = qat(**to_torch(np_batch()))
    (out["bbox_token"].float() ** 2).sum().backward()
    for name, m in q.quant_layers(qat).items():
        assert m.weight.grad is not None and m.weight.grad.abs().max() > 0, \
            name
    static = _port_model("int8_static")
    static.load_state_dict(qat.state_dict(), strict=True)
    q.attach_static_quant(static)
    with torch.no_grad():
        assert torch.isfinite(static(**to_torch(np_batch()))[
            "bbox_token"]).all()


# --- the CLIs ----------------------------------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    imgdir, ann = make_refcoco_style(str(tmp_path_factory.mktemp("synth")),
                                     8, 8)
    return [f"data.{s}.{k}={v}" for s in ("train", "val")
            for k, v in (("annsfile", ann), ("imgsfile", imgdir))]


def test_test_cli_with_quant_collection_matches_jax_evaluate(tmp_path,
                                                             synth):
    """JAX calibrates the tiny config's int8_static model on its val
    loader and evaluates it; the port's test CLI, given the same weights
    (exported) and JAX's .npz, gives the same Prec@0.5."""
    from simvg_tpu.config import Config as JaxConfig
    from simvg_tpu.config import parse_cfg_options
    from simvg_tpu.data.builder import (build_dataset_from_cfg,
                                        build_loader_from_cfg)
    from simvg_tpu.engine.evaluate import evaluate
    from simvg_tpu.models.builder import build_model
    from simvg_tpu.ops.quant import (attach_static_quant,
                                     save_quant_collection)
    from simvg_tpu_torch.tools import test as test_cli
    from simvg_tpu_torch.utils.checkpoint import save_checkpoint

    opts = synth + ["model.vis_enc.quant=int8_static"]
    cfg = JaxConfig.fromfile(TINY)
    cfg.merge_from_dict(parse_cfg_options(opts))
    ds = build_dataset_from_cfg(cfg.data.val, dataset_type=cfg.dataset,
                                seed=cfg.seed)
    loader = build_loader_from_cfg(ds, cfg, train=False, canvas=64,
                                   seed=cfg.seed)
    keys = ("image", "text_ids", "text_padding_mask", "img_shape")
    batches = [tuple(jnp.asarray(b[k]) for k in keys) for b in loader]

    def jax_model(quant):
        mc = dict(cfg.model)
        mc["vis_enc"] = dict(mc["vis_enc"], quant=quant)
        return build_model(mc, img_size=64, dtype=jnp.float32)[0]

    params = jax_model("none").init(jax.random.PRNGKey(3), *batches[0])
    params = jax.tree.map(np.asarray, params["params"])
    static, skel, qcol = _jax_calibrate(jax_model, params, batches)
    npz = str(tmp_path / "q.npz")
    save_quant_collection(npz, jax.device_get(qcol))
    want = evaluate(static, attach_static_quant({"params": params}, skel,
                                                npz), loader)
    sd = {k: torch.from_numpy(v.copy())
          for k, v in export_simvg_full({"params": params}).items()}
    save_checkpoint(str(tmp_path), "from_jax", params=sd, block=True)
    got = test_cli.main([TINY, str(tmp_path / "from_jax"), "--device", "cpu",
                         "--quant-collection", npz, "--cfg-options",
                         *opts])["val"]
    assert got["n_samples"] == want["n_samples"] == 8
    for k in ("det_acc", "decoder_det_acc", "token_det_acc"):
        assert got[k] == want[k], (k, got[k], want[k])


@pytest.fixture(scope="module")
def trained(tmp_path_factory, synth):
    """A det_best of the tiny config and the port's calibration of it."""
    from simvg_tpu_torch.tools import quantize_serving
    from simvg_tpu_torch.tools import train as train_cli

    wd = tmp_path_factory.mktemp("run")
    train_cli.main([TINY, "--work-dir", str(wd), "--device", "cpu",
                    "--cfg-options", *synth, "total_epochs=1"])
    npz = str(wd / "q.npz")
    res = quantize_serving.main([TINY, str(wd / "det_best"), "--out", npz,
                                 "--num-batches", "2", "--device", "cpu",
                                 "--cfg-options", *synth])
    return str(wd / "det_best"), npz, res


def test_quantize_serving_starts_from_zero(trained, synth, tmp_path,
                                          monkeypatch):
    """The serving model is built on the meta device and moved with
    to_empty, which leaves the calibration buffers uninitialised: the tool
    zeroes them first, so stale memory never becomes a scale."""
    from simvg_tpu_torch.tools import quantize_serving, test as test_cli

    build = test_cli.serving_model

    def stale(*args, **kw):
        model = build(*args, **kw)
        for m in q.quant_layers(model, "calib").values():
            m.act_amax.fill_(593.0)
        return model

    monkeypatch.setattr(quantize_serving, "serving_model", stale)
    ckpt, npz, res = trained
    out = str(tmp_path / "q.npz")
    got = quantize_serving.main([TINY, ckpt, "--out", out, "--num-batches",
                                 "2", "--device", "cpu", "--cfg-options",
                                 *synth])
    assert got["act_amax_max"] == res["act_amax_max"] < 593.0
    a, b = np.load(out), np.load(npz)
    assert all(np.array_equal(a[k], b[k]) for k in b.files)


def test_quantize_serving_cli_writes_the_jax_artifact(trained, synth):
    """The port's calibration tool: JAX's JSON line, and an .npz whose
    keys, dtypes and shapes are those of JAX's collection for the config,
    with every act_scale from calibration (none left at 1.0)."""
    from simvg_tpu.config import Config as JaxConfig
    from simvg_tpu.models.builder import build_model
    from simvg_tpu.ops.quant import load_quant_collection

    _, npz, res = trained
    assert res["calibration_batches"] == 2 and res["margin"] == 1.05
    assert res["quantized_layers"] == 24
    assert 0 < res["act_amax_min"] <= res["act_amax_max"]
    cfg = JaxConfig.fromfile(TINY)
    mc = dict(cfg.model)
    mc["vis_enc"] = dict(mc["vis_enc"], quant="int8_static")
    model = build_model(mc, img_size=64, dtype=jnp.float32)[0]
    b = np_batch(b=2)
    skel = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                             **to_jax(b)))["quant"]
    want = _flatten(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                 skel))
    got = _flatten(load_quant_collection(npz))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert (got[k].shape, got[k].dtype) == (v.shape, v.dtype), k
        if k.endswith("act_scale"):
            assert float(got[k]) != 1.0


@pytest.mark.parametrize("cli", ["test", "inference", "demo", "export",
                                 "serve"])
def test_each_cli_takes_quant_collection(cli, trained, synth, tmp_path):
    """Each CLI serves the int8_static model with the calibrated .npz, and
    gives the same answers as the live model attached in-process; on a
    model without quant layers the flag raises with JAX's message."""
    from simvg_tpu_torch.tools import demo, export_serving, inference, serve
    from simvg_tpu_torch.tools import test as test_cli

    ckpt, npz, _ = trained
    opts = synth + ["model.vis_enc.quant=int8_static"]
    runs = {
        "test": lambda o: test_cli.main([TINY, ckpt, "--device", "cpu",
                                         "--quant-collection", npz,
                                         "--cfg-options", *o]),
        "inference": lambda o: inference.main(
            [TINY, ckpt, "--output-dir", str(tmp_path / "vis"),
             "--device", "cpu", "--quant-collection", npz,
             "--cfg-options", *o]),
        "demo": lambda o: demo.main(
            ["--config", TINY, "--checkpoint", ckpt, "--img",
             _first_jpeg(synth), "--expression", "the box",
             "--output-dir", str(tmp_path / "demo"), "--device", "cpu",
             "--quant-collection", npz, "--cfg-options", *o]),
        "export": lambda o: export_serving.main(
            [TINY, ckpt, "--out", str(tmp_path / "m.pt2"), "--device", "cpu",
             "--quant-collection", npz, "--cfg-options", *o]),
        # the server runs its warm-up batch before it listens
        "serve": lambda o: serve.build_server(
            [TINY, "--checkpoint", ckpt, "--port", "0", "--device", "cpu",
             "--quant-collection", npz, "--cfg-options", *o]),
    }
    out = runs[cli](opts)
    if cli == "test":
        assert out["val"]["n_samples"] == 8
    elif cli == "inference":
        assert len(out) == 8
    elif cli == "demo":
        assert np.isfinite(out["score"])
    elif cli == "serve":
        assert out.batcher.batches == 1  # the int8 warm-up batch
        thread = threading.Thread(target=out.serve_forever)
        thread.start()
        out.close()
        thread.join(timeout=60)
        assert not thread.is_alive()
    else:
        assert out["quantized"] and out["int_mm_nodes"] == 24
    with pytest.raises(SystemExit, match="no quant layers"):
        runs[cli](synth)


def _first_jpeg(synth):
    imgdir = [o.split("=", 1)[1] for o in synth if "imgsfile" in o][0]
    return osp.join(imgdir, sorted(os.listdir(imgdir))[0])
