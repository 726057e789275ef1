"""The serving server of simvg_tpu_torch (``simvg_tpu_torch/tools/serve.py``),
in-process on the CPU: the counterparts of tests/test_serve.py.

- predict and errors: 200 with boxes in the original image's coordinates,
  ``"all"``'s per-query lists; 400 for a request without an image, bad
  base64, an ``image_path`` without ``--image-root`` and a format the
  port does not read (JPEG 2000, named in the error); 404 off the two
  routes; a PNG and a BMP of a JPEG's decoded pixels answered as that JPEG
  is;
- dynamic batching: concurrent requests share a device batch;
- a response equals JAX ``make_eval_step`` on the same request's batch,
  divided by scale_factor, within 1e-4 (the eval-step bound of
  tests/test_torch_model.py), on weights of JAX ``model.init``;
- the exported backend (a fixed batch overrides ``--max-batch``) answers as
  the live one does, bit for bit, and a program exported with its weights
  as an argument needs ``--checkpoint`` and then equals the eval step;
- the ``image_path`` gate: refused by default, read under the root, no
  escape from it.
"""

import argparse
import base64
import json
import os.path as osp
import threading
import urllib.error
import urllib.request

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simvg_tpu_torch.config import Config
from simvg_tpu_torch.convert import export_simvg_full
from simvg_tpu_torch.data.raw import RawPreprocessor
from simvg_tpu_torch.engine import make_eval_step
from simvg_tpu_torch.export import (SERVING_INPUTS, export_serving,
                                    save_exported)
from simvg_tpu_torch.tools import export_serving as export_cli
from simvg_tpu_torch.tools import serve
from simvg_tpu_torch.tools.test import serving_model
from simvg_tpu_torch.utils.checkpoint import save_checkpoint
from util_torch_port import cheap_jit, one_torch_thread, write_png  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY = osp.join(REPO, "configs", "smoke", "tiny_synth.py")
BOX_TOL = 1e-4


def _jpg(seed=0, h=80, w=96):
    img = np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    assert ok
    return buf.tobytes()


def _b64(data):
    return base64.b64encode(data).decode()


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """(JAX model, JAX params, port checkpoint) of tiny_synth.py from JAX
    ``model.init``."""
    from simvg_tpu.config import Config as JaxConfig
    from simvg_tpu.models.builder import build_model

    jcfg = JaxConfig.fromfile(TINY)
    model, _ = build_model(jcfg.model, img_size=64, dtype=jnp.float32)
    t = jcfg.max_token
    dummy = dict(image=jnp.zeros((1, 64, 64, 3), jnp.float32),
                 text_ids=jnp.zeros((1, t), jnp.int32),
                 text_padding_mask=jnp.zeros((1, t), jnp.int32),
                 img_shape=jnp.full((1, 2), 64, jnp.int32))
    params = jax.tree.map(np.asarray, cheap_jit(model.init)(
        jax.random.PRNGKey(2), **dummy))
    sd = {k: torch.from_numpy(v.copy())
          for k, v in export_simvg_full(params).items()}
    ckpt = save_checkpoint(str(tmp_path_factory.mktemp("ck")), "from_jax",
                           params=sd, block=True)
    return model, params, ckpt


class _Running:
    """A server serving on a daemon thread (which cannot keep the test
    process alive if a test fails before ``close()``); ``close()`` stops
    it."""

    def __init__(self, argv):
        self.server = serve.build_server(argv)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.port = self.server.server_port

    def close(self):
        self.server.close()
        self.thread.join(timeout=60)
        assert not self.thread.is_alive()


def _request(port, path, payload=None, timeout=60):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _predict(port, data, expression, **extra):
    return _request(port, "/predict", dict(image_b64=_b64(data),
                                           expression=expression, **extra))


@pytest.fixture(scope="module")
def live(jax_weights):
    running = _Running([TINY, "--checkpoint", jax_weights[2], "--port", "0",
                        "--max-batch", "4", "--batch-timeout-ms", "100",
                        "--device", "cpu"])
    yield running
    running.close()


def _check_prediction(out, h=80, w=96):
    for br in ("token", "decoder"):
        box = out[br]["box"]
        assert len(box) == 4 and all(np.isfinite(box))
        # the request image's coordinates, not the 64 px canvas
        assert max(box[0], box[2]) <= w + 1e-3
        assert max(box[1], box[3]) <= h + 1e-3
        assert isinstance(out[br]["score"], float)
    assert out["batch_size"] >= 1


def test_serve_predict_and_errors(live):
    status, health = _request(live.port, "/healthz")
    assert status == 200 and health["status"] == "ok"
    assert health["backend"] == "live:from_jax" and health["max_batch"] == 4
    status, out = _predict(live.port, _jpg(), "the red box")
    assert status == 200, out
    _check_prediction(out)
    status, out = _predict(live.port, _jpg(1), "everything", all=True)
    assert status == 200
    nq = Config.fromfile(TINY).model.head.num_queries
    assert len(out["token"]["boxes"]) == len(out["token"]["scores"]) == nq

    jp2 = b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(16)
    for bad, why in (({"expression": "no image"}, "image_b64 or image_path"),
                     ({"image_b64": "!!notbase64", "expression": "x"},
                      "base64"),
                     ({"image_path": "/etc/passwd", "expression": "x"},
                      "disabled"),
                     ({"image_b64": _b64(jp2), "expression": "x"},
                      "JPEG 2000 is not an image format"),
                     ({"image_b64": _b64(b"\xff\xd8junk"),
                       "expression": "x"}, "")):
        status, out = _request(live.port, "/predict", bad)
        assert status == 400 and why in out["error"], (bad, out)
    assert _request(live.port, "/nothing")[0] == 404
    assert _request(live.port, "/nothing", {"x": 1})[0] == 404
    status, out = _predict(live.port, _jpg(2), "still up")
    assert status == 200
    pixels = cv2.imdecode(np.frombuffer(_jpg(3), np.uint8), cv2.IMREAD_COLOR)
    png = write_png(pixels[..., ::-1], filters=(0, 1, 2, 3, 4))
    ok, bmp = cv2.imencode(".bmp", pixels)
    (s1, from_jpg), (s2, from_png), (s3, from_bmp) = (
        _predict(live.port, d, "the red box") for d in (_jpg(3), png,
                                                        bmp.tobytes()))
    assert s1 == s2 == s3 == 200
    for br in ("token", "decoder"):
        for other in (from_png, from_bmp):
            np.testing.assert_allclose(other[br]["box"], from_jpg[br]["box"],
                                       atol=1e-4, rtol=0)


def test_serve_dynamic_batching(live):
    """Six concurrent requests through a max-batch-4 server: at least one
    device batch carried more than one request."""
    results = [None] * 6

    def hit(i):
        results[i] = _predict(live.port, _jpg(i), f"object {i}",
                              timeout=120)

    threads = [threading.Thread(target=hit, args=(i,), daemon=True)
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for status, out in results:
        assert status == 200
        _check_prediction(out)
    assert max(out["batch_size"] for _, out in results) > 1


def test_serve_response_matches_jax_eval_step(live, jax_weights):
    from simvg_tpu.engine.train import make_eval_step as jax_eval_step

    model, params, _ = jax_weights
    data, expr = _jpg(5, 120, 90), "the thing on the right"
    status, out = _predict(live.port, data, expr, all=True)
    assert status == 200
    pre = RawPreprocessor(Config.fromfile(TINY), "cpu")
    batch = pre.collate([pre(data, expr)])
    want = jax.tree.map(np.asarray, cheap_jit(jax_eval_step(model))(
        params, {k: jnp.asarray(np.asarray(batch[k]))
                 for k in SERVING_INPUTS}))
    sf = batch["scale_factor"][0]
    for br in ("token", "decoder"):
        np.testing.assert_allclose(out[br]["box"],
                                   want[br]["best_box"][0] / sf,
                                   atol=BOX_TOL, rtol=0)
        np.testing.assert_allclose(out[br]["boxes"],
                                   want[br]["boxes"][0] / sf,
                                   atol=BOX_TOL, rtol=0)
        np.testing.assert_allclose(out[br]["score"],
                                   want[br]["best_score"][0],
                                   atol=BOX_TOL, rtol=0)


def test_serve_exported_backend(live, jax_weights, tmp_path):
    """--exported: a program of fixed batch 4 (overriding --max-batch 2),
    the checkpoint's weights in it, answers as the live server does."""
    from util_synth import make_refcoco_style

    imgdir, ann = make_refcoco_style(str(tmp_path / "synth"), 2, 2)
    out = str(tmp_path / "m.pt2")
    export_cli.main([TINY, jax_weights[2], "--batch-size", "4", "--out", out,
                     "--device", "cpu", "--cfg-options",
                     f"data.val.annsfile={ann}",
                     f"data.val.imgsfile={imgdir}"])
    running = _Running([TINY, "--exported", out, "--max-batch", "2",
                        "--port", "0", "--device", "cpu"])
    try:
        status, health = _request(running.port, "/healthz")
        assert health["backend"] == "exported:m.pt2"
        assert health["max_batch"] == 4  # the program's fixed batch wins
        data = _jpg(9)
        status, res = _predict(running.port, data, "exported")
        assert status == 200, res
        _check_prediction(res)
        _, want = _predict(live.port, data, "exported")
        for br in ("token", "decoder"):
            assert res[br] == want[br]
    finally:
        running.close()


def test_serve_weights_as_argument_program(jax_weights, tmp_path):
    """A program exported with bake_weights=False needs --checkpoint, and
    then serves what the eval step gives on those weights, bit for bit."""
    cfg = Config.fromfile(TINY)
    model = serving_model(cfg, jax_weights[2], torch.device("cpu"))
    pre = RawPreprocessor(cfg, "cpu")
    batch = pre.collate([pre(_jpg(i), f"object {i}") for i in range(2)])
    dev = {k: torch.as_tensor(batch[k]) for k in SERVING_INPUTS}
    f = str(tmp_path / "wa.pt2")
    save_exported(f, export_serving(model, dev, bake_weights=False))

    args = argparse.Namespace(exported=f, checkpoint=None, max_batch=2)
    with pytest.raises(SystemExit, match="bake_weights=False"):
        serve.build_backend(args, cfg, torch.device("cpu"))
    args.checkpoint = jax_weights[2]
    run_batch, name, size = serve.build_backend(args, cfg,
                                                torch.device("cpu"))
    assert name.startswith("exported:") and size == 64
    out = run_batch(batch)
    direct = make_eval_step(model)(dev)
    for br in direct:
        for k in direct[br]:
            assert torch.equal(out[br][k], direct[br][k]), (br, k)


def test_read_image_path_gate(tmp_path):
    """--image-root: refused by default, resolved under the root, no
    traversal out of it; a JPEG, a PNG or a BMP, not an AVIF."""
    sub = tmp_path / "imgs"
    sub.mkdir()
    (sub / "a.jpg").write_bytes(_jpg(0, 8, 8))
    with pytest.raises(ValueError, match="disabled"):
        serve.read_image({"image_path": str(sub / "a.jpg")})
    data = serve.read_image({"image_path": "a.jpg"}, image_root=str(sub))
    assert data == _jpg(0, 8, 8)
    (tmp_path / "secret.jpg").write_bytes(b"x")
    for path in ("../secret.jpg", "/etc/passwd"):
        with pytest.raises(ValueError, match="escapes"):
            serve.read_image({"image_path": path}, image_root=str(sub))
    ok, png = cv2.imencode(".png", np.zeros((8, 8, 3), np.uint8))
    (sub / "b.png").write_bytes(png.tobytes())
    assert serve.read_image({"image_path": "b.png"},
                            image_root=str(sub)) == png.tobytes()
    ok, bmp = cv2.imencode(".bmp", np.zeros((8, 8, 3), np.uint8))
    (sub / "c.bmp").write_bytes(bmp.tobytes())
    assert serve.read_image({"image_path": "c.bmp"},
                            image_root=str(sub)) == bmp.tobytes()
    (sub / "d.avif").write_bytes(b"\x00\x00\x00\x1cftypavif" + bytes(16))
    with pytest.raises(ValueError, match="AVIF is not"):
        serve.read_image({"image_path": "d.avif"}, image_root=str(sub))
