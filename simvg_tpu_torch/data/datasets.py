"""Dataset readers for the shared ``instances.json`` annotation schema (port
of ``simvg_tpu/data/datasets.py``).

As in the JAX module:

- annotation file: ``{split: [ann, ...]}`` where ann has ``image_id``,
  ``expressions`` (list[str]), ``bbox`` (xywh; for GRefCOCO a list per
  expression of multi-target xywh boxes), ``height``/``width``, optional
  ``data_source`` (Mixed), and for GRefCOCO ``annotations`` (a list per
  expression of target dicts, ``category_id == -1`` marking no target);
- per-dataset image filename schemes: ReferIt/Flickr ``{image_id}.jpg``,
  RefCOCO* and GRefCOCO ``COCO_train2014_%012d.jpg``, Mixed one root per
  ``data_source`` (the COCO scheme for the coco sources);
- Mixed's ``img_source`` filter of the train split, applied before any
  image is read;
- the expression draw is a pure function of (seed, epoch, index), and the
  per-sample ``aug_rng`` string seeds the augmentation;
- the aspect-ratio group flag for the group sampler, and the bbox clip.

What differs: ``_load_image`` returns the file's bytes and the image's
(h, w) from the JPEG header (EXIF orientation applied), not decoded pixels;
the loader decodes on its device (``data/jpeg.py``, ``data/image_ops.py``).
With ``with_mask`` the annotation's ``mask`` (polygons, or an RLE dict)
becomes ``gt_mask`` (a uint8 host bitmap), ``gt_mask_rle`` and ``is_crowd``
(1 for a polygon of several parts), through the port's ``ops/rle.py``.
"""

from __future__ import annotations

import copy
import json
import os.path as osp
import random
from typing import Optional, Sequence, Tuple

import numpy as np

from simvg_tpu_torch.ops import rle as rle_ops

from .jpeg import jpeg_geometry
from .tokenization import build_tokenizer, build_word_vocab
from .transforms import Compose

VALID_SETS = (
    "train", "val", "testA", "testB", "test",
    "val_refcoco_unc", "val_refcocoplus_unc", "val_refcocog_umd",
    "val_flickr30k", "val_referitgame_berkeley",
)


def _filename_for(dataset: str, ann: dict, imgsfile) -> str:
    if "ReferItGame" in dataset or "Flickr30k" in dataset:
        return osp.join(imgsfile, "%d.jpg" % ann["image_id"])
    if "RefCOCO" in dataset:  # RefCOCO* and GRefCOCO
        return osp.join(imgsfile,
                        "COCO_train2014_%012d.jpg" % ann["image_id"])
    if dataset == "Mixed":
        src = ann["data_source"]
        name = "COCO_train2014_%012d.jpg" if "coco" in src else "%d.jpg"
        return osp.join(imgsfile[src], name % ann["image_id"])
    raise ValueError(dataset)


class BaseDataset:
    """One split of one dataset + its sample pipeline."""

    dataset_name = "RefCOCOUNC"

    def __init__(
        self,
        imgsfile,
        annsfile: str,
        which_set: str = "train",
        img_source: Sequence[str] = ("coco",),
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
        self.which_set = which_set
        self.imgsfile = imgsfile
        self.max_token = max_token
        self.with_bbox = with_bbox
        self.with_mask = with_mask
        with open(annsfile) as f:
            self.anns_all = json.load(f)
        # Mixed pretraining: keep the train records of the configured
        # sources only, before any of their images is read
        train = self.anns_all.get("train")
        if train and train[0].get("data_source"):
            self.anns_all["train"] = [a for a in train
                                      if a["data_source"] in img_source]

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
        if self.with_mask:
            self._load_mask(s, ann)
        s = self.pipeline(s)
        if s["expression"] != expression:
            # a transform rewrote the text (VGTRAugment's flip swaps left
            # and right): the ids encoded above would keep the old side
            ids, mask = self.tokenizer.encode(s["expression"],
                                              self.max_token)
            s["ref_expr_inds"] = ids
            s["text_attention_mask"] = mask
        return s

    def _load_mask(self, s: dict, ann: dict):
        """Polygon-or-RLE GT mask -> bitmap, RLE and is_crowd."""
        mask = ann["mask"]
        h, w = s["ori_shape"][:2]
        is_crowd = 0
        if isinstance(mask, list):  # polygon(s)
            rles = rle_ops.frPyObjects(mask, h, w)
            if len(rles) > 1:
                is_crowd = 1
            r = rle_ops.merge(rles)
        else:
            r = mask
        s["gt_mask"] = rle_ops.decode(r)
        s["gt_mask_rle"] = r
        s["is_crowd"] = is_crowd

    def _load_bbox(self, s: dict, ann: dict, expr_idx: int):
        """xywh -> xyxy, clipped to the image."""
        h, w = s["ori_shape"][:2]
        bbox = np.asarray(copy.deepcopy(ann["bbox"]), np.float64)
        bbox[2] += bbox[0]
        bbox[3] += bbox[1]
        bbox[0::2] = np.clip(bbox[0::2], 0, w - 1)
        bbox[1::2] = np.clip(bbox[1::2], 0, h - 1)
        s["gt_bbox"] = bbox


class GRefCOCO(BaseDataset):
    """Generalized REC: multi-target and no-target expressions."""

    dataset_name = "GRefCOCO"

    def _load_bbox(self, s: dict, ann: dict, expr_idx: int):
        """The expression's boxes, each xywh -> xyxy and clipped, and its
        target dicts."""
        h, w = s["ori_shape"][:2]
        boxes = []
        for bb in ann["bbox"][expr_idx]:
            bb = np.asarray(bb, np.float64)
            bb[2] += bb[0]
            bb[3] += bb[1]
            bb[0::2] = np.clip(bb[0::2], 0, w - 1)
            bb[1::2] = np.clip(bb[1::2], 0, h - 1)
            boxes.append(bb)
        s["gt_bbox"] = boxes
        s["target"] = copy.deepcopy(ann["annotations"][expr_idx])


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


class Mixed(BaseDataset):
    dataset_name = "Mixed"


_REGISTRY = {c.__name__: c for c in (
    GRefCOCO, RefCOCOUNC, RefCOCOGoogle, RefCOCOgUMD, RefCOCOgGoogle,
    RefCOCOPlusUNC, ReferItGameBerkeley, Flickr30k, Mixed,
)}


def build_dataset(dataset: str, **kw) -> BaseDataset:
    return _REGISTRY[dataset](**kw)
