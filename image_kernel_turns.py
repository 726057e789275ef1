"""The image kernels of simvg_tpu_torch that walk a chain (PNG's unfilter,
VP8's pixels, the VP8L and TIFF predictors) beside an earlier version of
their sources, timed in turns on one card.

    python3 image_kernel_turns.py --parent DIR [--kinds K ...] [--out DIR]
                                  [--iters N]

DIR holds the earlier source of each kind timed (``png.cu``, ``vp8.cu``,
``vp8l.cu``, ``image_convert.cu`` for tiff), for example

    git show <commit>:simvg_tpu_torch/csrc/png.cu > DIR/png.cu

Both versions are built with the port's nvcc flags (``ops/_build.py``): the
current one into the build directory, the earlier one into ``--out``
(default: a temporary directory).  Each is held bit for bit to the plain
decoders on every timed input, then the two are timed in turns, earlier,
current, current, earlier, twice: the kernels' device ms a call from
torch.profiler (``chip_smoke.kernel_split_ms``; the unfilter kernel for
PNG; the fused reconstruction and loop-filter kernel for VP8; the
predictor kernel for VP8L and TIFF), on

  png   480 x 640 RGB with every filter type row by row, and all Paeth;
  vp8   the textured and the posterised 480 x 640 lossy fixtures
        (``tests/fixtures/formats/``);
  vp8l  the predictor transform of the textured and the posterised
        480 x 640 lossless fixtures, on its input (the pixels with the
        later transforms undone);
  tiff  the predictor of the textured and the posterised 480 x 640 LZW
        TIFF fixtures (RGB, 480 segments of 640 pixels).

Prints the card's name and power limit, the ptxas lines of the current
kernels, one JSON line a timing and a last JSON line with the medians.
Needs a CUDA card; exits non-zero without one.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
FORMATS_DIR = os.path.join(REPO, "tests", "fixtures", "formats")
FIXTURES = {"vp8": ("webp_lossy_big_textured.webp",
                    "webp_lossy_big_lossy.webp"),
            "vp8l": ("webp_lossless_big_textured.webp",
                     "webp_lossless_big_lossless.webp"),
            "tiff": ("tiff_big_textured.tif", "tiff_big_lzw_pred2.tif")}
# each kind's source file and the kernel-name substrings whose device time
# a call is summed (the earlier and the current names)
SOURCES = {"png": "png", "vp8": "vp8", "vp8l": "vp8l",
           "tiff": "image_convert"}
KERNEL_KEYS = {"png": ("unfilter_kernel",),
               "vp8": ("reconstruct", "filter_kernel"),
               "vp8l": ("predictor",), "tiff": ("predictor",)}
# the kernels of KERNEL_KEYS a call launches (VP8: the fused reconstruction
# and filter kernel; a version with two reads None)
KERNEL_LAUNCHES = {"png": 1, "vp8": 1, "vp8l": 1, "tiff": 1}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters, keys, launches):
    """Device ms a call of the kernels whose names hold one of ``keys``, of
    which a call launches ``launches``: ``chip_smoke.kernel_split_ms``,
    the reader of chip_smoke.py's rows."""
    from chip_smoke import kernel_split_ms

    split = kernel_split_ms(fn, iters, {k: k for k in keys}, launches)
    seen = [v for v in split.values() if v is not None]
    return sum(seen) if seen else None


def build_earlier(src_dir, out_dir, sources):
    """The earlier sources built as the port builds its own."""
    from simvg_tpu_torch.ops import _build

    libs = {}
    for name in sources:
        out = os.path.join(out_dir, f"lib{name}_earlier.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
               os.path.join(src_dir, f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier {name}.cu:\n"
                               f"{proc.stderr}")
        libs[name] = ctypes.CDLL(out)
    return libs


def predictor_input(st):
    """(the predictor transform, its input ARGB pixels) of a parsed VP8L
    stream: the pixels with the transforms after it in the stream undone
    by the plain version."""
    from simvg_tpu_torch.data import vp8l

    img = st.pixels
    for t in reversed(st.transforms):
        if t.kind == vp8l.PREDICTOR:
            return t, img
        img = vp8l._inverse(t, img, st.height)
    raise ValueError("the stream has no predictor transform")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory with the earlier sources")
    ap.add_argument("--kinds", nargs="+", default=list(SOURCES),
                    choices=list(SOURCES))
    ap.add_argument("--out", default=None,
                    help="where the earlier libraries are built")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("image_kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from simvg_tpu_torch.data import image_convert, png, tiff, vp8, vp8l, webp
    from simvg_tpu_torch.ops import _build
    from util_torch_port import write_png

    modules = {"png": png, "vp8": vp8, "vp8l": vp8l, "tiff": image_convert}
    sources = sorted({SOURCES[k] for k in args.kinds})
    card = card_line()
    print(card, flush=True)
    current = _build.build_all(sources)
    for name, path in current.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    out_dir = args.out or tempfile.mkdtemp(prefix="image_kernel_turns_")
    os.makedirs(out_dir, exist_ok=True)
    earlier = build_earlier(args.parent, out_dir, sources)
    libs = {"earlier": {k: modules[k].bind(earlier[SOURCES[k]])
                        for k in args.kinds},
            "current": {k: modules[k].bind(ctypes.CDLL(str(
                current[SOURCES[k]]))) for k in args.kinds}}

    def fixture(name):
        with open(os.path.join(FORMATS_DIR, name), "rb") as f:
            return f.read()

    inputs = []  # (label, kind, call, plain output)
    if "png" in args.kinds:
        pixels = np.random.default_rng(0).integers(0, 256, (480, 640, 3))
        for label, filters in (("png every filter", (0, 1, 2, 3, 4)),
                               ("png all Paeth", (4,))):
            st = png.parse(write_png(pixels, 8, 2, filters))
            inputs.append((label, "png", lambda st=st: png.decode_cuda(
                st, "cuda"), torch.from_numpy(png.decode_reference(st))))
    for name in FIXTURES["vp8"] if "vp8" in args.kinds else ():
        fr = vp8.parse(webp.parse(fixture(name)).bitstream)
        inputs.append((f"vp8 {name}", "vp8", lambda fr=fr: vp8.decode_cuda(
            fr, "cuda"), torch.from_numpy(vp8.reconstruct_reference(fr))))
    for name in FIXTURES["vp8l"] if "vp8l" in args.kinds else ():
        st = vp8l.parse(webp.parse(fixture(name)).bitstream)
        t, img = predictor_input(st)
        x = torch.from_numpy(img.view(np.int32)).cuda()
        want = vp8l._inverse(t, img, st.height).view(np.int32)
        inputs.append((f"vp8l predictor {name}", "vp8l",
                       lambda t=t, x=x, h=st.height: vp8l.transform_cuda(
                           t, x, h), torch.from_numpy(want)))
    for name in FIXTURES["tiff"] if "tiff" in args.kinds else ():
        raw, _, segments = tiff.parse(fixture(name), "cpu")
        want = image_convert.undo_predictor_reference(raw, *segments)
        inputs.append((f"tiff predictor {name}", "tiff",
                       lambda raw=raw, seg=segments: (
                           image_convert.undo_predictor_cuda(
                               raw, "cuda", *seg)),
                       torch.frombuffer(bytearray(want), dtype=torch.uint8)))

    def call(version, kind, fn):
        modules[kind]._lib = libs[version][kind]
        return fn()

    times = {}
    for label, kind, fn, want in inputs:
        for version in ("earlier", "current"):
            got = call(version, kind, fn).cpu()
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: the {version} kernels differ "
                                     "from the plain decoder")
        for turn, version in enumerate(("earlier", "current", "current",
                                        "earlier") * 2):
            ms = device_ms(lambda: call(version, kind, fn), args.iters,
                           KERNEL_KEYS[kind], KERNEL_LAUNCHES[kind])
            times.setdefault(label, {}).setdefault(version, []).append(ms)
            print(json.dumps({"input": label, "turn": turn,
                              "version": version, "device_ms": ms,
                              "card": card}), flush=True)
    for mod in modules.values():
        mod._lib = None
    # a session that lost launches twice reads None and is left out
    print(json.dumps({"medians": {
        label: {v: statistics.median([x for x in t if x is not None] or [None])
                for v, t in by.items()}
        for label, by in times.items()}, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
