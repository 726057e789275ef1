"""How far nvJPEG's pixels are from cv2's for the same JPEG files.

nvJPEG's IDCT and 4:2:0 chroma upsampling are not libjpeg-turbo's, so the
card decodes the same file to slightly different pixels than the JAX
package's ``cv2.imread``.  The machine with the card has no cv2, so the
measurement takes two steps:

    # where cv2 is installed: 480x640 files encoded and decoded with cv2,
    # the decoded arrays saved beside them
    python -m simvg_tpu_torch.tools.jpeg_divergence save DIR
    # on the card: the same files decoded with nvJPEG, held to the arrays
    python -m simvg_tpu_torch.tools.jpeg_divergence compare DIR

Two sets of files: ``noise``, the synthetic dataset's images
(``make_synth_data``: uniform noise and a green box, the worst case for
4:2:0 chroma), and ``smooth``, smooth colour gradients (``smooth_image``).
``compare`` prints one JSON line for each: the max and mean |difference| in
uint8 levels over all pixels and channels, and the share of values that
differ, beside the card's name.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from simvg_tpu_torch.data.jpeg import decode, encode
from simvg_tpu_torch.tools.make_synth_data import (make_refcoco_style,
                                                   smooth_image)

SETS = ("noise", "smooth")


def save(root: str, n: int, img_hw) -> None:
    make_refcoco_style(os.path.join(root, "noise"), n, 0, img_hw=img_hw,
                       device="cpu")
    smooth_dir = os.path.join(root, "smooth", "images")
    os.makedirs(smooth_dir, exist_ok=True)
    for i in range(n):
        img = torch.from_numpy(smooth_image(*img_hw, seed=i))
        with open(os.path.join(smooth_dir, f"{i}.jpg"), "wb") as f:
            f.write(encode(img, 95))
    for name in SETS:
        imgdir = os.path.join(root, name, "images")
        arrays = {}
        for fname in sorted(os.listdir(imgdir)):
            with open(os.path.join(imgdir, fname), "rb") as f:
                arrays[fname] = decode(f.read(), "cpu").numpy()
        np.savez(os.path.join(root, name, "cv2_decoded.npz"), **arrays)
    print(f"saved {n} cv2-decoded images of each set under {root}")


def compare(root: str) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("compare decodes with nvJPEG: it needs the card")
    out = {}
    for name in SETS:
        ref = np.load(os.path.join(root, name, "cv2_decoded.npz"))
        diffs = []
        for fname in sorted(ref.files):
            with open(os.path.join(root, name, "images", fname), "rb") as f:
                got = decode(f.read(), "cuda").cpu().numpy()
            if got.shape != ref[fname].shape:
                raise AssertionError(f"{fname}: {got.shape} vs "
                                     f"{ref[fname].shape}")
            diffs.append(np.abs(got.astype(np.int16) - ref[fname]))
        d = np.stack(diffs)
        out[name] = {"set": name, "files": len(diffs),
                     "shape": list(d.shape[1:]), "max_abs": int(d.max()),
                     "mean_abs": float(d.mean()),
                     "share_differing": float((d > 0).mean()),
                     "share_over_1": float((d > 1).mean()),
                     "device": torch.cuda.get_device_name(0)}
        print(json.dumps(out[name]))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=("save", "compare"))
    p.add_argument("root")
    p.add_argument("--n", type=int, default=16)
    p.add_argument("--img-hw", type=int, nargs=2, default=(480, 640))
    args = p.parse_args(argv)
    if args.mode == "save":
        save(args.root, args.n, tuple(args.img_hw))
    else:
        compare(args.root)


if __name__ == "__main__":
    main()
