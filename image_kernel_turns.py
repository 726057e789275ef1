"""The PNG unfilter and VP8 pixel kernels of simvg_tpu_torch beside an
earlier version of their sources, timed in turns on one card.

    python3 image_kernel_turns.py --parent DIR [--out DIR] [--iters N]

DIR holds the earlier ``png.cu`` and ``vp8.cu``, for example

    git show <commit>:simvg_tpu_torch/csrc/png.cu > DIR/png.cu

Both versions are built with the port's nvcc flags (``ops/_build.py``): the
current one into the build directory, the earlier one into ``--out``
(default: a temporary directory).  Each is held bit for bit to the plain
decoders on every timed input, then the two are timed in turns, earlier,
current, current, earlier, twice: the kernels' device ms a call from
torch.profiler (the unfilter kernel for PNG; reconstruction and the loop
filter for VP8, one kernel or two), on

  PNG  480 x 640 RGB with every filter type row by row, and all Paeth;
  VP8  the textured and the posterised 480 x 640 lossy fixtures
       (``tests/fixtures/formats/``).

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
VP8_FIXTURES = ("webp_lossy_big_textured.webp", "webp_lossy_big_lossy.webp")
# the kernel-name substrings whose device time a call is summed
PNG_KERNELS = ("unfilter_kernel",)
VP8_KERNELS = ("reconstruct", "filter_kernel")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters, keys):
    """Device ms a call of the kernels whose names hold one of ``keys``,
    from torch.profiler over ``iters`` calls; None if it saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and any(k in e.name for k in keys))
    return us / 1e3 / iters if us else None


def build_earlier(src_dir, out_dir):
    """The earlier png.cu and vp8.cu built as the port builds its own."""
    from simvg_tpu_torch.ops import _build

    libs = {}
    for name in ("png", "vp8"):
        out = os.path.join(out_dir, f"lib{name}_earlier.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
               os.path.join(src_dir, f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier {name}.cu:\n"
                               f"{proc.stderr}")
        libs[name] = ctypes.CDLL(out)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory with the earlier png.cu and vp8.cu")
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
    from simvg_tpu_torch.data import png, vp8, webp
    from simvg_tpu_torch.ops import _build
    from util_torch_port import write_png

    card = card_line()
    print(card, flush=True)
    current = _build.build_all(("png", "vp8"))
    for name, path in current.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    out_dir = args.out or tempfile.mkdtemp(prefix="image_kernel_turns_")
    os.makedirs(out_dir, exist_ok=True)
    earlier = build_earlier(args.parent, out_dir)
    libs = {"earlier": {"png": png.bind(earlier["png"]),
                        "vp8": vp8.bind(earlier["vp8"])},
            "current": {"png": png.bind(ctypes.CDLL(str(current["png"]))),
                        "vp8": vp8.bind(ctypes.CDLL(str(current["vp8"])))}}

    rng = np.random.default_rng(0)
    pixels = rng.integers(0, 256, (480, 640, 3))
    inputs = []  # (label, kind, parsed, plain pixels)
    for label, filters in (("png every filter", (0, 1, 2, 3, 4)),
                           ("png all Paeth", (4,))):
        st = png.parse(write_png(pixels, 8, 2, filters))
        inputs.append((label, "png", st,
                       torch.from_numpy(png.decode_reference(st))))
    for name in VP8_FIXTURES:
        with open(os.path.join(FORMATS_DIR, name), "rb") as f:
            fr = vp8.parse(webp.parse(f.read()).bitstream)
        inputs.append((f"vp8 {name}", "vp8", fr,
                       torch.from_numpy(vp8.reconstruct_reference(fr))))

    def call(version, kind, parsed):
        mod = png if kind == "png" else vp8
        mod._lib = libs[version][kind]
        return mod.decode_cuda(parsed, "cuda")

    times = {}
    for label, kind, parsed, want in inputs:
        for version in ("earlier", "current"):
            got = call(version, kind, parsed).cpu()
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: the {version} kernels differ "
                                     "from the plain decoder")
        keys = PNG_KERNELS if kind == "png" else VP8_KERNELS
        for turn, version in enumerate(("earlier", "current", "current",
                                        "earlier") * 2):
            ms = device_ms(lambda: call(version, kind, parsed), args.iters,
                           keys)
            times.setdefault(label, {}).setdefault(version, []).append(ms)
            print(json.dumps({"input": label, "turn": turn,
                              "version": version, "device_ms": ms,
                              "card": card}), flush=True)
    png._lib = vp8._lib = None
    print(json.dumps({"medians": {
        label: {v: statistics.median(t) for v, t in by.items()}
        for label, by in times.items()}, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
