#!/usr/bin/env python
"""Writes tests/fixtures/formats/: image files of every format the port
reads besides JPEG and PNG, for ``chip_smoke.py``'s "formats" phase on a
machine with no encoder for them.

The files are the CPU tests' cases (``tests/util_image_formats.cases``:
48 x 64 and smaller, from seed 0) and one 480 x 640 image of each format
(``util_image_formats.big``), one textured 480 x 640 image of each of
lossy WebP, lossless WebP and LZW TIFF (``big_textured``), plus a few
broken streams.  ``digests.json``
records, for each file, cv2's decoded pixels (``cv2.imdecode(...,
IMREAD_COLOR)``: their shape and the sha256 of their bytes, a gray image
replicated to three channels as the port gives it) or that cv2 reads no
image from it.

Run from the repo root: python tests/fixtures/make_format_fixtures.py
"""

import hashlib
import json
import os
import os.path as osp
import sys

import cv2
import numpy as np

HERE = osp.dirname(osp.abspath(__file__))
sys.path.insert(0, osp.dirname(HERE))

import util_image_formats as U  # noqa: E402

OUT = osp.join(HERE, "formats")
EXT = {"webp": "webp", "bmp": "bmp", "pnm": "pnm", "sunras": "ras",
       "hdr": "hdr", "gif": "gif", "tiff": "tif", "webp_lossy": "webp",
       "webp_lossless": "webp"}


def digest(data: bytes):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        return {"error": True}
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return {"shape": list(img.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(img)
                                     .tobytes()).hexdigest()}


def main():
    os.makedirs(OUT, exist_ok=True)
    for f in os.listdir(OUT):
        os.unlink(osp.join(OUT, f))
    files = {}
    for fmt, cases in U.cases().items():
        for name, data in cases:
            files[f"{fmt}_{name}.{EXT[fmt]}"] = data
    for fmt in U.BIG_FORMATS:
        name, data = U.big(fmt)
        files[f"{fmt}_{name}.{EXT[fmt]}"] = data
    for fmt in U.TEXTURED_FORMATS:
        name, data = U.big_textured(fmt)
        files[f"{fmt}_{name}.{EXT[fmt]}"] = data
    lossy = files["webp_lossy_q90.webp"]
    files["broken_webp_truncated.webp"] = lossy[:len(lossy) // 2]
    files["broken_gif_no_image.gif"] = files["gif_pil.gif"][:13 + 768] + \
        b"\x3b"
    files["broken_bmp_truncated.bmp"] = files["bmp_bgr24.bmp"][:200]
    record = {}
    for name, data in sorted(files.items()):
        with open(osp.join(OUT, name), "wb") as f:
            f.write(data)
        record[name] = digest(data)
    with open(osp.join(OUT, "digests.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    total = sum(len(d) for d in files.values())
    print(f"{len(files)} files, {total} bytes in {OUT}")


if __name__ == "__main__":
    main()
