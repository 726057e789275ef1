"""Dataset readers for the shared ``instances.json`` annotation schema (port
of ``simvg_tpu/data/datasets.py``, its single-source readers).

As in the JAX module:

- annotation file: ``{split: [ann, ...]}`` where ann has ``image_id``,
  ``expressions`` (list[str]), ``bbox`` (xywh) and ``height``/``width``;
- per-dataset image filename schemes: ReferIt/Flickr ``{image_id}.jpg``,
  RefCOCO* ``COCO_train2014_%012d.jpg``;
- the expression draw is a pure function of (seed, epoch, index), and the
  per-sample ``aug_rng`` string seeds the augmentation;
- the aspect-ratio group flag for the group sampler, and the bbox clip.

What differs: ``_load_image`` returns the file's bytes and the image's
(h, w) from the JPEG header (EXIF orientation applied), not decoded pixels;
the loader decodes on its device (``data/jpeg.py``, ``data/image_ops.py``).
GRefCOCO and Mixed (the multi-target and multi-source readers) and masks
are not ported yet (ROADMAP: M15, masks) and raise.
"""

from __future__ import annotations

import copy
import json
import os.path as osp
import random
from typing import Optional, Sequence, Tuple

import numpy as np

from .jpeg import jpeg_geometry
from .tokenization import build_tokenizer, build_word_vocab
from .transforms import Compose

VALID_SETS = (
    "train", "val", "testA", "testB", "test",
    "val_refcoco_unc", "val_refcocoplus_unc", "val_refcocog_umd",
    "val_flickr30k", "val_referitgame_berkeley",
)
NOT_PORTED = {"GRefCOCO": "M15", "Mixed": "M15"}


def _filename_for(dataset: str, ann: dict, imgsfile) -> str:
    if "ReferItGame" in dataset or "Flickr30k" in dataset:
        return osp.join(imgsfile, "%d.jpg" % ann["image_id"])
    if "RefCOCO" in dataset:
        return osp.join(imgsfile,
                        "COCO_train2014_%012d.jpg" % ann["image_id"])
    raise ValueError(dataset)


class BaseDataset:
    """One split of one dataset + its sample pipeline."""

    dataset_name = "RefCOCOUNC"

    def __init__(
        self,
        imgsfile,
        annsfile: str,
        which_set: str = "train",
        tokenizer=None,
        max_token: int = 20,
        transforms: Optional[Sequence] = None,
        with_bbox: bool = True,
        with_mask: bool = False,
        use_token_type: str = "beit3",
        spm_path: str = "pretrain_weights/beit3.spm",
        corpus_path: Optional[str] = None,
        seed: int = 6666,
    ):
        assert which_set in VALID_SETS, which_set
        if not (with_bbox or with_mask):
            raise ValueError("set with_bbox and/or with_mask on the load op")
        if with_mask:
            raise NotImplementedError("masks are not ported yet (ROADMAP: "
                                      "masks)")
        self.which_set = which_set
        self.imgsfile = imgsfile
        self.max_token = max_token
        self.with_bbox = with_bbox
        self.with_mask = with_mask
        with open(annsfile) as f:
            self.anns_all = json.load(f)

        if tokenizer is None:
            if use_token_type == "default":
                tokenizer = build_tokenizer(
                    "default", token2idx=build_word_vocab(self.anns_all)
                )
            elif use_token_type == "copus":
                tokenizer = build_tokenizer(
                    "copus", corpus_path=corpus_path)
            else:
                tokenizer = build_tokenizer(use_token_type,
                                            spm_path=spm_path)
        self.tokenizer = tokenizer
        self.pipeline = Compose(transforms or [])
        self.seed = seed
        self.epoch = 0  # set by DataLoader.set_epoch for per-epoch
        # expression resampling; eval keeps 0 -> fully deterministic

        if which_set == "train":
            self._set_group_flag()
        else:
            self.flag = np.zeros(len(self), np.uint8)

    # -- core ----------------------------------------------------------
    def __len__(self):
        return len(self.anns_all[self.which_set])

    def _set_group_flag(self):
        """Aspect-ratio group flag: 1 if w/h > 1."""
        anns = self.anns_all[self.which_set]
        self.flag = np.asarray(
            [1 if a["width"] / a["height"] > 1 else 0 for a in anns],
            np.uint8,
        )

    def _load_image(self, ann: dict) -> Tuple[bytes, Tuple[int, int]]:
        """The JPEG file's bytes and the decoded image's (h, w)."""
        path = _filename_for(self.dataset_name, ann, self.imgsfile)
        with open(path, "rb") as f:
            data = f.read()
        geo = jpeg_geometry(data)
        return data, (geo.height, geo.width)

    def __getitem__(self, index: int) -> dict:
        ann = self.anns_all[self.which_set][index]
        data, (h, w) = self._load_image(ann)
        shape = (h, w, 3)
        s: dict = {
            "ann": ann,
            "filename": _filename_for(self.dataset_name, ann,
                                      self.imgsfile),
            "img_bytes": data,
            "pixel_ops": [],
            "img_shape": shape,
            "ori_shape": shape,
            "pad_shape": shape,
            "scale_factor": np.ones(4, np.float32),
            "with_bbox": self.with_bbox,
            "with_mask": self.with_mask,
        }
        exprs = ann["expressions"]
        expr_rng = np.random.default_rng((self.seed, self.epoch, index))
        expr_idx = int(expr_rng.integers(0, len(exprs)))
        # deterministic augmentation stream for this (epoch, sample)
        s["aug_rng"] = random.Random(
            f"{self.seed}/{self.epoch}/{index}/aug"
        )
        expression = exprs[expr_idx]
        ids, mask = self.tokenizer.encode(expression, self.max_token)
        s["expression"] = expression
        s["ref_expr_inds"] = ids
        s["text_attention_mask"] = mask
        s["max_token"] = self.max_token

        if self.with_bbox:
            self._load_bbox(s, ann, expr_idx)
        return self.pipeline(s)

    def _load_bbox(self, s: dict, ann: dict, expr_idx: int):
        """xywh -> xyxy, clipped to the image."""
        h, w = s["ori_shape"][:2]
        bbox = np.asarray(copy.deepcopy(ann["bbox"]), np.float64)
        bbox[2] += bbox[0]
        bbox[3] += bbox[1]
        bbox[0::2] = np.clip(bbox[0::2], 0, w - 1)
        bbox[1::2] = np.clip(bbox[1::2], 0, h - 1)
        s["gt_bbox"] = bbox


class RefCOCOUNC(BaseDataset):
    dataset_name = "RefCOCOUNC"


class RefCOCOGoogle(BaseDataset):
    dataset_name = "RefCOCOGoogle"


class RefCOCOgUMD(BaseDataset):
    dataset_name = "RefCOCOgUMD"


class RefCOCOgGoogle(BaseDataset):
    dataset_name = "RefCOCOgGoogle"


class RefCOCOPlusUNC(BaseDataset):
    dataset_name = "RefCOCOPlusUNC"


class ReferItGameBerkeley(BaseDataset):
    dataset_name = "ReferItGameBerkeley"


class Flickr30k(BaseDataset):
    dataset_name = "Flickr30k"


_REGISTRY = {c.__name__: c for c in (
    RefCOCOUNC, RefCOCOGoogle, RefCOCOgUMD, RefCOCOgGoogle,
    RefCOCOPlusUNC, ReferItGameBerkeley, Flickr30k,
)}


def build_dataset(dataset: str, **kw) -> BaseDataset:
    if dataset in NOT_PORTED:
        raise NotImplementedError(f"dataset {dataset!r} is not ported yet "
                                  f"(ROADMAP: {NOT_PORTED[dataset]})")
    return _REGISTRY[dataset](**kw)
