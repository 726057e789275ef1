"""Build datasets and loaders from reference-style config dicts (port of
``simvg_tpu/data/builder.py``).

- ``LoadImageAnnotationsFromFile`` parameters (max_token, use_token_type,
  with_bbox/with_mask) configure the dataset object itself;
- ``LargeScaleJitter``/``Resize``/``Normalize``/``Pad`` map 1:1 to
  ``simvg_tpu_torch.data.transforms`` (geometry on the host, pixels on the
  loader's device);
- ``DefaultFormatBundle``/``CollectData`` are no-ops: static-shape
  collation replaces them.

``SampleMaskVertices`` samples the mask's contour on the host;
``VGTRAugment`` (the legacy VGTR family, ``vgtr_aug.py``) draws on the host
and records its pixel ops for the loader's device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from . import transforms as T
from .datasets import BaseDataset, build_dataset
from .loader import DataLoader
from .vgtr_aug import VGTRAugment

_NOOP_TYPES = {"DefaultFormatBundle", "CollectData"}


def build_pipeline(pipeline_cfg, normalize_on_device: bool = False
                   ) -> Tuple[list, Dict[str, Any]]:
    """Returns (transform list, loader-level settings from the load op).

    normalize_on_device skips the Normalize op (images stay uint8; the
    train/eval step normalises) and records the norm constants under
    load_cfg["img_norm_cfg"]."""
    tfs = []
    load_cfg: Dict[str, Any] = {}
    for op in pipeline_cfg or []:
        op = dict(op)
        kind = op.pop("type")
        if kind == "LoadImageAnnotationsFromFile":
            load_cfg = op
        elif kind == "LargeScaleJitter":
            tfs.append(T.LargeScaleJitter(**op))
        elif kind == "Resize":
            tfs.append(T.Resize(tuple(op.pop("img_scale")),
                                keep_ratio=op.pop("keep_ratio", True)))
        elif kind == "Normalize":
            if normalize_on_device:
                load_cfg["img_norm_cfg"] = op
            else:
                tfs.append(T.Normalize(**op))
        elif kind == "Pad":
            tfs.append(T.Pad(**op))
        elif kind == "SampleMaskVertices":
            tfs.append(T.SampleMaskVertices(**op))
        elif kind == "VGTRAugment":
            tfs.append(VGTRAugment(**op))
        elif kind in _NOOP_TYPES:
            continue
        else:
            raise ValueError(f"unknown pipeline op {kind!r}")
    return tfs, load_cfg


def build_dataset_from_cfg(split_cfg: Dict[str, Any], *,
                           dataset_type: Optional[str] = None,
                           tokenizer=None, seed: int = 6666,
                           normalize_on_device: bool = False
                           ) -> BaseDataset:
    split_cfg = dict(split_cfg)
    ds_type = split_cfg.pop("type", dataset_type)
    tfs, load_cfg = build_pipeline(split_cfg.pop("pipeline", []),
                                   normalize_on_device)
    split_cfg.pop("word_emb_cfg", None)  # legacy GloVe path
    expr_sampling = split_cfg.pop(
        "expr_sampling", load_cfg.get("expr_sampling", "deterministic"))
    return build_dataset(
        ds_type,
        imgsfile=split_cfg.pop("imgsfile"),
        annsfile=split_cfg.pop("annsfile"),
        which_set=split_cfg.pop("which_set", "train"),
        img_source=split_cfg.pop("img_source", ("coco",)),
        tokenizer=tokenizer,
        max_token=load_cfg.get("max_token", 20),
        transforms=tfs,
        # reference defaults (loading.py:48-57): with_bbox False
        with_bbox=load_cfg.get("with_bbox", False),
        with_mask=load_cfg.get("with_mask", False),
        use_token_type=load_cfg.get("use_token_type", "beit3"),
        spm_path=load_cfg.get("spm_path", "pretrain_weights/beit3.spm"),
        corpus_path=load_cfg.get("corpus_path"),
        seed=seed,
        expr_sampling=expr_sampling,
    )


def build_loader_from_cfg(dataset: BaseDataset, cfg, *, train: bool,
                          canvas: int, max_gt: int = 1,
                          seed: int = 6666, shard_id: int = 0,
                          num_shards: int = 1, device="cuda") -> DataLoader:
    """The loader of one split; images land on ``device``."""
    data = cfg["data"]
    return DataLoader(
        dataset,
        batch_size=data.get("samples_per_gpu", 32),
        canvas=canvas,
        max_gt=max_gt,
        shuffle=train,
        drop_last=train,
        num_workers=data.get("workers_per_gpu", 8),
        seed=seed,
        shard_id=shard_id,
        num_shards=num_shards,
        text_buckets=cfg.get("text_buckets"),
        device=device,
    )
