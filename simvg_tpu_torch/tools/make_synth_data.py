"""Synthetic datasets for running the CLIs without real data (port of
``tools/make_synth_data.py`` and of ``tests/util_synth.py``'s
``make_refcoco_style``, ``make_grefcoco_style`` and ``make_mixed_style``).

    python -m simvg_tpu_torch.tools.make_synth_data --root DIR
        [--style refcoco|grefcoco|mixed] [--n-train 16] [--n-val 8]
        [--img-hw H W] [--device cuda|cpu]

Same ``instances.json`` schema, file names and numpy draws as the JAX
helpers, so both write the same annotations and, before compression, the
same pixels: uniform noise with filled green rectangles, the boxes of the
expressions.

- ``refcoco`` (default; 120x160): one box per expression.
- ``grefcoco`` (480x640): one or two targets per expression, and every
  third expression has no target and no green content (GRefCOCO).
- ``mixed`` (480x640): ``--n-train`` records split between a ``coco`` and
  a ``flickr`` image root, plus one ``visual-genome`` record whose image is
  never written (the ``img_source`` filter must drop it before any read),
  and a ``val_refcoco_unc`` split (Mixed pretraining).

``add_masks`` gives every record of a refcoco-style annotation file a
``mask``, for the segmentation and multi-task pipelines.

The JPEG files are encoded by ``data/jpeg.py``: nvJPEG on the card
(default), cv2 with ``--device cpu``.
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
from simvg_tpu_torch.ops import rle as rle_ops


_GREEN = (0, 255, 0)  # BGR


def _noise_image(rng, h: int, w: int, device) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, 255, (h, w, 3), np.uint8)).to(
        device)


def _fill(img: torch.Tensor, x: int, y: int, bw: int, bh: int) -> None:
    """A filled rectangle, both corners included (cv2.rectangle with
    thickness -1), in BGR green."""
    img[y:y + bh + 1, x:x + bw + 1] = torch.tensor(_GREEN, dtype=torch.uint8,
                                                   device=img.device)


def _write(path: str, img: torch.Tensor, quality: int) -> None:
    with open(path, "wb") as f:
        f.write(encode(img, quality))


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
            img = _noise_image(rng, h, w, device)
            x, y = rng.integers(5, w // 2), rng.integers(5, h // 2)
            bw, bh = rng.integers(10, w // 2), rng.integers(10, h // 2)
            _fill(img, int(x), int(y), int(bw), int(bh))
            _write(os.path.join(imgdir, "COCO_train2014_%012d.jpg" % image_id),
                   img, quality)
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


def make_grefcoco_style(root: str, n_train: int = 6, n_val: int = 6,
                        img_hw: Tuple[int, int] = (480, 640), device="cuda",
                        quality: int = 95):
    """GRefCOCO-style data: multi-target and no-target expressions (every
    third has no target and no green content).  Returns (image dir,
    annotation file)."""
    imgdir = os.path.join(root, "images")
    os.makedirs(imgdir, exist_ok=True)
    rng = np.random.default_rng(1)
    anns = {"train": [], "val": []}
    h, w = img_hw
    for split, n in (("train", n_train), ("val", n_val)):
        for i in range(n):
            image_id = (2000 if split == "train" else 3000) + i
            img = _noise_image(rng, h, w, device)
            if i % 3 == 2:  # no target
                bbox = [[[0, 0, 0, 0]]]
                annotations = [[{"category_id": -1}]]
            else:
                boxes, targets = [], []
                for t in range(1 + i % 2):
                    # disjoint halves, so two targets never merge
                    x = int(rng.integers(t * w // 2, t * w // 2 + w // 4))
                    y = int(rng.integers(0, h // 2))
                    bw = int(rng.integers(w // 5, w // 4))
                    bh = int(rng.integers(h // 4, h // 2))
                    _fill(img, x, y, bw, bh)
                    boxes.append([x, y, bw, bh])
                    targets.append({"category_id": 1})
                bbox = [boxes]
                annotations = [targets]
            _write(os.path.join(imgdir, "COCO_train2014_%012d.jpg" % image_id),
                   img, quality)
            anns[split].append({
                "image_id": int(image_id), "height": h, "width": w,
                "bbox": bbox,  # [expression][target][xywh]
                "expressions": ["some things maybe"],
                "annotations": annotations,
            })
    path = os.path.join(root, "instances.json")
    with open(path, "w") as f:
        json.dump(anns, f)
    return imgdir, path


def make_mixed_style(root: str, n_per_source: int = 4, n_val: int = 4,
                     img_hw: Tuple[int, int] = (480, 640), device="cuda",
                     quality: int = 95):
    """Mixed-pretraining-style data: ``coco`` and ``flickr`` image roots,
    one ``visual-genome`` record whose image is never written, and a
    ``val_refcoco_unc`` split.  Returns ({source: image root}, annotation
    file)."""
    roots = {src: os.path.join(root, src) for src in ("coco", "flickr")}
    for d in roots.values():
        os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(3)
    h, w = img_hw

    def record(image_id, source):
        img = _noise_image(rng, h, w, device)
        x, y = int(rng.integers(5, w // 2)), int(rng.integers(5, h // 2))
        bw, bh = int(rng.integers(10, w // 2)), int(rng.integers(10, h // 2))
        _fill(img, x, y, bw, bh)
        if source == "coco":
            _write(os.path.join(roots["coco"],
                                "COCO_train2014_%012d.jpg" % image_id),
                   img, quality)
        elif source == "flickr":
            _write(os.path.join(roots["flickr"], f"{image_id}.jpg"), img,
                   quality)
        return {"image_id": int(image_id), "height": h, "width": w,
                "bbox": [x, y, bw, bh], "expressions": ["the green box"],
                "data_source": source}

    anns = {"train": [], "val_refcoco_unc": []}
    nid = 0
    for source in ("coco", "flickr"):
        for _ in range(n_per_source):
            anns["train"].append(record(nid, source))
            nid += 1
    anns["train"].append(record(nid, "visual-genome"))  # no image
    nid += 1
    for _ in range(n_val):
        anns["val_refcoco_unc"].append(record(1000 + nid, "coco"))
        nid += 1
    path = os.path.join(root, "instances.json")
    with open(path, "w") as f:
        json.dump(anns, f)
    return roots, path


def _box_mask(x: float, y: float, bw: float, bh: float, kind: int, h: int,
              w: int):
    """A ``mask`` annotation inside the box (x, y, bw, bh), by ``kind``: 0 a
    concave L-shaped polygon, 1 two polygons (a crowd mask), 2 an RLE ring
    (a hole), 3 the box as a polygon.  Vertices at fractional positions."""
    x0, y0, x1, y1 = x + 0.3, y + 0.4, x + bw - 0.3, y + bh - 0.2
    xm, ym = (x0 + x1) / 2, (y0 + y1) / 2
    if kind == 0:
        return [[x0, y0, x1, y0, x1, ym, xm, ym, xm, y1, x0, y1]]
    if kind == 1:
        return [[x0, y0, xm - 1, y0, x0, y1],
                [xm + 1, y1, x1, y1, x1, y0 + 2]]
    if kind == 2:
        m = np.zeros((h, w), np.uint8)
        m[int(y0):int(y1) + 1, int(x0):int(x1) + 1] = 1
        m[int(ym - bh / 5):int(ym + bh / 5) + 1,
          int(xm - bw / 5):int(xm + bw / 5) + 1] = 0
        r = rle_ops.encode(m)
        return {"size": r["size"], "counts": r["counts"].decode()}
    return [[x0, y0, x1, y0, x1, y1, x0, y1]]


def add_masks(annsfile: str) -> str:
    """Gives every record of ``annsfile`` a ``mask`` inside its box (the
    kinds of ``_box_mask`` in turn) and rewrites the file; returns it."""
    with open(annsfile) as f:
        anns = json.load(f)
    i = 0
    for records in anns.values():
        for a in records:
            a["mask"] = _box_mask(*a["bbox"], i % 4, a["height"], a["width"])
            i += 1
    with open(annsfile, "w") as f:
        json.dump(anns, f)
    return annsfile


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
    p.add_argument("--style", default="refcoco",
                   choices=("refcoco", "grefcoco", "mixed"))
    p.add_argument("--n-train", type=int, default=16,
                   help="train records (mixed: split between its coco and "
                        "flickr sources)")
    p.add_argument("--n-val", type=int, default=8)
    p.add_argument("--img-hw", type=int, nargs=2, default=None,
                   help="original image size; default 120 160 for refcoco, "
                        "480 640 for grefcoco and mixed (non-square so eval "
                        "exercises non-unit scale factors)")
    p.add_argument("--device", default="cuda",
                   help="where the JPEGs are encoded: cuda (nvJPEG, "
                        "default) or cpu (cv2)")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to encode "
                           "with cv2")
    if args.style == "refcoco":
        imgdir, annfile = make_refcoco_style(
            args.root, args.n_train, args.n_val,
            img_hw=tuple(args.img_hw or (120, 160)), device=args.device)
    elif args.style == "grefcoco":
        imgdir, annfile = make_grefcoco_style(
            args.root, args.n_train, args.n_val,
            img_hw=tuple(args.img_hw or (480, 640)), device=args.device)
    else:
        imgdir, annfile = make_mixed_style(
            args.root, args.n_train // 2, args.n_val,
            img_hw=tuple(args.img_hw or (480, 640)), device=args.device)
    print(f"images: {imgdir}\nannotations: {annfile}")
    return imgdir, annfile


if __name__ == "__main__":
    main()
