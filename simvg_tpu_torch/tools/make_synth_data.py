"""Synthetic RefCOCO-style dataset for running the CLIs without real data
(port of ``tools/make_synth_data.py`` and ``tests/util_synth.py``'s
``make_refcoco_style``).

    python -m simvg_tpu_torch.tools.make_synth_data --root DIR
        [--n-train 16] [--n-val 8] [--img-hw 120 160] [--device cuda|cpu]

Same ``instances.json`` schema, file names (``COCO_train2014_%012d.jpg``)
and numpy draws as the JAX tool, so both write the same annotations and,
before compression, the same pixels: uniform noise with one filled green
rectangle, the box of every expression.  The JPEG files are encoded by
``data/jpeg.py``: nvJPEG on the card (default), cv2 with ``--device cpu``.
GRefCOCO-style data waits for the GRefCOCO reader (ROADMAP: M15).
"""

from __future__ import annotations

import argparse
import json
import os
import struct
from typing import Tuple

import numpy as np
import torch

from simvg_tpu_torch.data.jpeg import encode


def make_refcoco_style(root: str, n_train: int = 8, n_val: int = 4,
                       img_hw: Tuple[int, int] = (120, 160),
                       device="cuda", quality: int = 95):
    """Writes ``root/images/*.jpg`` and ``root/instances.json``; returns
    (image dir, annotation file)."""
    imgdir = os.path.join(root, "images")
    os.makedirs(imgdir, exist_ok=True)
    rng = np.random.default_rng(0)
    anns = {"train": [], "val": []}
    for split, n in (("train", n_train), ("val", n_val)):
        for i in range(n):
            image_id = (0 if split == "train" else 1000) + i
            h, w = img_hw
            img = torch.from_numpy(rng.integers(0, 255, (h, w, 3), np.uint8))
            x, y = rng.integers(5, w // 2), rng.integers(5, h // 2)
            bw, bh = rng.integers(10, w // 2), rng.integers(10, h // 2)
            img = img.to(device)
            # a filled rectangle, both corners included (cv2.rectangle
            # with thickness -1), in BGR green
            img[int(y):int(y + bh) + 1, int(x):int(x + bw) + 1] = \
                torch.tensor([0, 255, 0], dtype=torch.uint8, device=device)
            with open(os.path.join(
                    imgdir, "COCO_train2014_%012d.jpg" % image_id),
                    "wb") as f:
                f.write(encode(img, quality))
            anns[split].append({
                "image_id": int(image_id),
                "height": h,
                "width": w,
                "bbox": [int(x), int(y), int(bw), int(bh)],  # xywh
                "expressions": ["the green box", "green rectangle area"],
            })
    path = os.path.join(root, "instances.json")
    with open(path, "w") as f:
        json.dump(anns, f)
    return imgdir, path


def smooth_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A uint8 BGR [h, w, 3] image of smooth colour gradients (periods of
    60-170 pixels), the content a JPEG at quality 95 keeps to about a level
    on average.  The codec checks use it; noise, or sharp colour edges,
    would measure the 4:2:0 chroma subsampling instead of the codec."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([127 + 100 * np.sin(xx / (60 + 20 * c) + yy / (80 + 15 * c)
                                       + r.uniform(0, 6))
                    for c in range(3)], -1)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def with_exif(data: bytes, orientation: int, order: str = "<") -> bytes:
    """A JPEG stream with an APP1 Exif segment holding one orientation tag
    (1-8), inserted after SOI; ``order`` is the TIFF byte order."""
    tiff = ({"<": b"II", ">": b"MM"}[order]
            + struct.pack(order + "HI", 42, 8) + struct.pack(order + "H", 1)
            + struct.pack(order + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(order + "I", 0))
    app1 = b"Exif\x00\x00" + tiff
    return (data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2)
            + app1 + data[2:])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--n-train", type=int, default=16)
    p.add_argument("--n-val", type=int, default=8)
    p.add_argument("--img-hw", type=int, nargs=2, default=(120, 160),
                   help="original image size (non-square by default so "
                        "eval exercises non-unit scale factors)")
    p.add_argument("--device", default="cuda",
                   help="where the JPEGs are encoded: cuda (nvJPEG, "
                        "default) or cpu (cv2)")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to encode "
                           "with cv2")
    imgdir, annfile = make_refcoco_style(args.root, args.n_train, args.n_val,
                                         img_hw=tuple(args.img_hw),
                                         device=args.device)
    print(f"images: {imgdir}\nannotations: {annfile}")
    return imgdir, annfile


if __name__ == "__main__":
    main()
