"""Serving server of the port (counterpart of ``tools/serve.py``): HTTP with
dynamic micro-batching over one device forward.

A batcher thread coalesces concurrent requests into one device batch,
padded to ``--max-batch`` by repeating the last request's sample (padded
rows are real forwards whose outputs are dropped), and runs it on one of
two backends:

  * live:      the config's model with ``--checkpoint`` (random weights
               without it) through ``make_eval_step``;
  * exported:  ``--exported model.pt2`` from
               ``python -m simvg_tpu_torch.tools.export_serving`` (weights
               in the file; a program exported with its weights as an
               argument takes them from ``--checkpoint``).

API (JSON over HTTP, standard library only):

  GET  /healthz   -> {"status": "ok", "backend": ..., "max_batch": N,
                      "img_size": S}
  POST /predict   <- {"image_b64": <b64 image>, "expression": str}
                     (or {"image_path": str} under --image-root; refused
                      unless the server was started with it)
                  -> {"token":   {"box": [x0, y0, x1, y1], "score": f},
                      "decoder": {"box": [...], "score": f},
                      "batch_size": n, "latency_ms": f}
     "all": true adds each query's "boxes"/"scores" (GRefCOCO-style).

Boxes are in the original image's coordinates (the prediction divided by
the pipeline's scale_factor, as the demo does).  The server takes every
format ``data/image_file.py`` reads: JPEG (nvJPEG on the card), PNG,
WebP, GIF, TIFF, BMP, PNM/PFM, Sun raster and Radiance HDR (their
entropy and run-length coding on the host, the pixels in the port's
kernels on the card); any other stream (JPEG 2000, AVIF, OpenEXR, ...)
is answered with 400, naming its format where its first bytes tell it.
Requests are parsed, read and decoded in the HTTP handler threads, so the
host stages of concurrent requests run side by side; the batcher
thread builds the batch and runs the forward.  A warm-up batch runs before
the server listens.

    python -m simvg_tpu_torch.tools.serve CONFIG [--checkpoint CKPT]
        [--exported model.pt2] [--host 127.0.0.1] [--port 8900]
        [--max-batch 8] [--batch-timeout-ms 10] [--image-root DIR]
        [--device cuda|cpu] [--cfg-options ...]

It runs on the card unless ``--device cpu`` is given, and raises where
there is no card.  An ``int8_static`` model serves with
``--quant-collection`` (``tools/quantize_serving.py``'s .npz), on the live
backend and on a program exported with its weights as an argument (a
program with baked weights holds its quant tensors already).  In dynamic
``int8`` the activation scales are maxima over the whole device batch, so
a response depends on its batch mates (JAX's server does the same).
``build_server(argv)`` returns the server without serving it
(``serve_forever()`` then ``close()``).
"""

from __future__ import annotations

import argparse
import base64
import binascii
import json
import os
import os.path as osp
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from simvg_tpu_torch.config import Config, parse_cfg_options
from simvg_tpu_torch.data.image_file import image_format
from simvg_tpu_torch.data.jpeg import encode
from simvg_tpu_torch.data.raw import RawPreprocessor
from simvg_tpu_torch.engine import make_eval_step
from simvg_tpu_torch.export import (SERVING_INPUTS, load_exported,
                                    serving_state)

from .test import serving_model
from .train import check_ported, resolve_device, to_device


class Batcher:
    """Coalesces concurrent requests into one padded device batch."""

    def __init__(self, run_batch, preproc: RawPreprocessor, max_batch: int,
                 timeout_ms: float, request_timeout_s: float = 120.0):
        self.run_batch = run_batch
        self.preproc = preproc
        self.max_batch = max_batch
        self.timeout_s = timeout_ms / 1000.0
        self.request_timeout_s = request_timeout_s
        self.q: "queue.Queue" = queue.Queue()
        self.batches = 0  # device batches run
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, sample: dict, image: torch.Tensor, want_all: bool,
               timeout_s: float | None = None) -> dict:
        """Called from the HTTP handler threads with a request's sample and
        its decoded image; blocks until the batcher thread has run the
        request's batch.  ``timeout_s`` overrides the per-request wait (the
        warm-up passes a longer one)."""
        ev = threading.Event()
        slot = {"want_all": want_all}
        self.q.put((sample, image, ev, slot))
        if not ev.wait(timeout=timeout_s or self.request_timeout_s):
            # an abandoned request gives up its place in a later batch
            slot["cancelled"] = True
            raise TimeoutError("device batch did not complete")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["result"]

    def close(self) -> None:
        """Stops the batcher thread after the batch it is running."""
        self.q.put(None)
        self.thread.join(timeout=60)

    def _get_live(self, timeout=None):
        """The next queue item whose submitter still waits (None: close)."""
        while True:
            item = self.q.get(timeout=timeout)
            if item is None or not item[3].get("cancelled"):
                return item

    def _loop(self):
        while True:
            first = self._get_live()
            if first is None:
                return
            items, stop = [first], False
            deadline = time.monotonic() + self.timeout_s
            while len(items) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    item = self._get_live(timeout=left)
                except queue.Empty:
                    break
                if item is None:
                    stop = True
                    break
                items.append(item)
            # a submitter may have timed out while the batch was gathered
            items = [it for it in items if not it[3].get("cancelled")]
            if items:
                try:
                    self._run(items)
                except Exception as e:  # noqa: BLE001 — fan the error out
                    for _, _, ev, slot in items:
                        slot["error"] = f"{type(e).__name__}: {e}"
                        ev.set()
            if stop:
                return

    def _run(self, items):
        n = len(items)
        samples = [it[0] for it in items]
        images = [it[1] for it in items]
        # pad to max_batch with the last request, whose copies' outputs
        # are dropped
        samples += [samples[-1]] * (self.max_batch - n)
        images += [images[-1]] * (self.max_batch - n)
        batch = self.preproc.collate(samples, images)
        t0 = time.monotonic()
        self.batches += 1
        preds = self.run_batch(batch)
        preds = {br: {k: v.float().cpu().numpy() for k, v in p.items()}
                 for br, p in preds.items()}
        dt_ms = (time.monotonic() - t0) * 1000.0
        for i, (_, _, ev, slot) in enumerate(items):
            sf = batch["scale_factor"][i]
            out = {"batch_size": n, "latency_ms": round(dt_ms, 2)}
            for br in ("token", "decoder"):
                r = {"box": (preds[br]["best_box"][i] / sf).tolist(),
                     "score": float(preds[br]["best_score"][i])}
                if slot["want_all"]:
                    r["boxes"] = (preds[br]["boxes"][i] / sf).tolist()
                    r["scores"] = preds[br]["scores"][i].tolist()
                out[br] = r
            slot["result"] = out
            ev.set()


def build_backend(args, cfg, device, device_norm=None,
                  quant_collection=None):
    """-> (run_batch(batch) -> preds, backend name, img_size).  An exported
    program with a fixed batch sets ``args.max_batch`` to it.
    ``quant_collection``: the .npz of an int8_static model."""
    if args.exported:
        prog = load_exported(args.exported)
        meta = prog.meta
        b0 = meta["inputs"]["image"][0][0]
        if not meta["polymorphic_batch"] and args.max_batch != b0:
            print(f"[serve] exported program has fixed batch {b0}; "
                  f"overriding --max-batch {args.max_batch} -> {b0}")
            args.max_batch = b0
        name = f"exported:{osp.basename(args.exported)}"
        if not meta["weights_as_argument"]:
            if quant_collection:
                raise SystemExit(
                    f"{args.exported} holds its weights and quant tensors; "
                    "--quant-collection applies to the live backend and to "
                    "a program exported with its weights as an argument")
            return (lambda batch: prog.call(
                to_device(batch, device, SERVING_INPUTS)), name,
                meta["img_size"])
        if not args.checkpoint:
            raise SystemExit(
                f"{args.exported} was exported with bake_weights=False (its "
                "weights are an argument, not in the file); pass "
                "--checkpoint to restore the weights to serve with it")
        params = serving_state(serving_model(
            cfg, args.checkpoint, device,
            quant_collection=quant_collection))
        return (lambda batch: prog.call(
            params, to_device(batch, device, SERVING_INPUTS)), name,
            meta["img_size"])

    model = serving_model(cfg, args.checkpoint, device,
                          quant_collection=quant_collection)
    step = make_eval_step(model, device_norm=device_norm)
    name = ("live:" + osp.basename(osp.normpath(args.checkpoint))
            if args.checkpoint else "live:random-init")
    return (lambda batch: step(to_device(batch, device, SERVING_INPUTS)),
            name, cfg.get("img_size", 640))


def read_image(req: dict, image_root: str | None = None) -> bytes:
    """The request's image stream; raises ValueError on a request
    without an image, an ``image_path`` outside ``image_root`` (or any,
    without one), and a stream of any other format."""
    if "image_b64" in req:
        try:
            data = base64.b64decode(req["image_b64"], validate=True)
        except (binascii.Error, TypeError) as e:
            raise ValueError(f"image_b64 is not base64: {e}") from e
    elif "image_path" in req:
        # server-local reads let a client probe the file system: only under
        # an explicit --image-root, and never out of it
        if image_root is None:
            raise ValueError(
                "image_path requests are disabled; start the server with "
                "--image-root DIR to allow reads under DIR, or send "
                "image_b64")
        root = osp.realpath(image_root)
        path = osp.realpath(osp.join(root, req["image_path"]))
        if not (path + os.sep).startswith(root + os.sep) and path != root:
            raise ValueError("image_path escapes --image-root")
        with open(path, "rb") as f:
            data = f.read()
    else:
        raise ValueError("request needs image_b64 or image_path")
    image_format(data)  # raises on any other format
    return data


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="simvg_tpu_torch serving server")
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--exported", default=None,
                   help="a program from simvg_tpu_torch.tools.export_serving"
                        " (weights in the file)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8900)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--batch-timeout-ms", type=float, default=10.0,
                   help="how long the batcher waits to coalesce requests "
                        "before running a partial batch")
    p.add_argument("--request-timeout-s", type=float, default=120.0,
                   help="per-request wait for the device batch")
    p.add_argument("--warmup-timeout-s", type=float, default=600.0,
                   help="wait for the warm-up batch (kernel builds)")
    p.add_argument("--image-root", default=None,
                   help="allow {'image_path': ...} requests, resolved under "
                        "(and confined to) this directory")
    p.add_argument("--quant-collection", default=None,
                   help="int8_static calibration artifact (.npz) from "
                        "tools/quantize_serving.py")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--cfg-options", nargs="*", default=[])
    return p.parse_args(argv)


class Server(ThreadingHTTPServer):
    """The HTTP server with its batcher; ``close()`` stops both."""

    daemon_threads = True

    def close(self) -> None:
        self.shutdown()
        self.server_close()
        self.batcher.close()


def build_server(argv=None) -> Server:
    """Builds the backend and the batcher, runs the warm-up batch, and
    binds the server (``serve_forever()`` serves it)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(parse_cfg_options(args.cfg_options))
    check_ported(cfg)
    preproc = RawPreprocessor(cfg, device)
    run_batch, backend, img_size = build_backend(
        args, cfg, device, device_norm=preproc.device_norm,
        quant_collection=args.quant_collection)
    preproc.canvas = img_size
    batcher = Batcher(run_batch, preproc, max_batch=args.max_batch,
                      timeout_ms=args.batch_timeout_ms,
                      request_timeout_s=args.request_timeout_s)

    t0 = time.monotonic()
    warm = preproc(encode(torch.zeros(img_size, img_size, 3,
                                      dtype=torch.uint8, device=device)),
                   "warmup")
    batcher.submit(warm, preproc.decode(warm), want_all=False,
                   timeout_s=args.warmup_timeout_s)
    print(f"[serve] warm-up {time.monotonic() - t0:.1f}s (backend={backend}, "
          f"max_batch={args.max_batch}, img_size={img_size})", flush=True)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # no access log
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "backend": backend,
                                 "max_batch": args.max_batch,
                                 "img_size": img_size})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/predict":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                data = read_image(req, image_root=args.image_root)
                sample = preproc(data, req["expression"],
                                 filename="<request>")
                image = preproc.decode(sample)
            except Exception as e:  # noqa: BLE001 — any bad request: 400
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                out = batcher.submit(sample, image,
                                     want_all=bool(req.get("all")))
                self._json(200, out)
            except Exception as e:  # noqa: BLE001 — the batch failed: 500
                self._json(500, {"error": str(e)})

    server = Server((args.host, args.port), Handler)
    server.batcher = batcher
    print(f"[serve] listening on http://{args.host}:{server.server_port} "
          "(POST /predict)", flush=True)
    return server


def main(argv=None):
    server = build_server(argv)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


if __name__ == "__main__":
    main()
