"""Batching, static-shape collation and a loader that keeps one batch ahead
of the step (port of ``simvg_tpu/data/loader.py``).

As in the JAX loader:

- every batch has static shapes: images on a (canvas, canvas) NHWC canvas,
  GT boxes padded to ``max_gt`` with a validity mask, text padded to
  ``max_token`` upstream (or cut to a ``text_buckets`` width);
- aspect-ratio group batching with an epoch-seeded shuffle, wrap-padding
  with ``batch_valid``, and ``shard_id``/``num_shards`` slicing, with the
  same numpy RNG calls in the same order, so the sample order is the same;
- a thread pool runs the dataset (file read, image header, tokenizer and
  the transforms' geometry) for the samples of a batch, and a prefetch
  thread builds batch k+1 while batch k is consumed.

What differs: the image goes to the loader's ``device``.  The pool's
threads also decode each image there (nvJPEG, or zlib and the PNG kernel,
on a card), and the prefetch thread applies the pixel ops and fills the canvas
(``image_ops.collate_images``), all on a side stream of the loader's own
on a card; the consumer's stream waits on an event recorded after the
batch, so the step orders after its batch's decode and resize.  Every
other key stays a numpy array on the host, with the JAX collate's dtype.

Batch dict: image [B,H,W,3] float32 (uint8 when the pipeline leaves
normalisation to the step) on ``device``; numpy text_ids [B,T] i32,
text_padding_mask [B,T] i32, img_shape [B,2] i32, scale_factor [B,4] f32,
gt_boxes [B,max_gt,4] f32, gt_labels [B,max_gt] i32, gt_valid [B,max_gt]
bool, gt_count [B] i32, batch_valid [B] bool; meta: a list of per-sample
dicts (filename, expression, ori_shape, img_shape, target, gt_mask_rle,
is_crowd, gt_bbox_all).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .image_ops import collate_images
from .image_file import decode_image


def collate(samples: List[dict], canvas: int, max_gt: int = 1,
            valid: Optional[List[bool]] = None,
            text_buckets: Optional[List[int]] = None,
            device="cuda", decoded: Sequence = ()) -> Dict:
    """The batch of ``samples``, whose decoded images on ``device`` are
    ``decoded``."""
    b = len(samples)
    img_shape = np.zeros((b, 2), np.int32)
    scale_factor = np.ones((b, 4), np.float32)
    t = len(samples[0]["ref_expr_inds"])
    text_ids = np.zeros((b, t), np.int32)
    text_mask = np.ones((b, t), np.int32)
    gt_boxes = np.zeros((b, max_gt, 4), np.float32)
    gt_labels = np.zeros((b, max_gt), np.int32)
    gt_valid = np.zeros((b, max_gt), bool)
    gt_count = np.zeros((b,), np.int32)
    meta = []

    for i, s in enumerate(samples):
        img_shape[i] = (s["img_shape"][0], s["img_shape"][1])
        scale_factor[i] = s.get("scale_factor", np.ones(4, np.float32))
        text_ids[i] = s["ref_expr_inds"]
        text_mask[i] = s["text_attention_mask"]

        gb = s.get("gt_bbox")
        if gb is not None:
            boxes = gb if isinstance(gb, list) else [gb]
            target = s.get("target")
            # the untruncated count of object targets (GRefCOCO's no-target
            # rows left out) feeds the loss normalisation; the arrays stay
            # truncated to max_gt for the matcher's shapes
            if target is not None:
                gt_count[i] = sum(1 for tt in target
                                  if tt.get("category_id") != -1)
            else:
                gt_count[i] = len(boxes)
            for j, bb in enumerate(boxes[:max_gt]):
                gt_boxes[i, j] = bb
                gt_valid[i, j] = True
                if target is not None:  # a no-target row has label 1
                    gt_labels[i, j] = int(
                        target[j].get("category_id") == -1)
        meta.append({
            "filename": s.get("filename"),
            "expression": s.get("expression"),
            "ori_shape": s.get("ori_shape"),
            "img_shape": s.get("img_shape"),
            "target": s.get("target"),
            "gt_mask_rle": s.get("gt_mask_rle"),
            "is_crowd": s.get("is_crowd"),
            "gt_bbox_all": (
                np.asarray(
                    gb if isinstance(gb, list) else [gb], np.float64
                ).reshape(-1, 4)
                if gb is not None else None
            ),
        })

    if text_buckets:
        # shrink the text axis to the smallest bucket covering the
        # longest real expression in the batch
        real = int((text_mask == 0).sum(axis=1).max()) if b else 0
        fit = [bk for bk in sorted(text_buckets) if bk >= real]
        bucket = min(fit[0] if fit else t, t)
        text_ids = text_ids[:, :bucket]
        text_mask = text_mask[:, :bucket]

    return {
        "image": collate_images(samples, canvas, device, decoded),
        "text_ids": text_ids,
        "text_padding_mask": text_mask,
        "img_shape": img_shape,
        "scale_factor": scale_factor,
        "gt_boxes": gt_boxes,
        "gt_labels": gt_labels,
        "gt_valid": gt_valid,
        "gt_count": gt_count,
        "batch_valid": np.asarray(
            valid if valid is not None else [True] * b, bool
        ),
        "meta": meta,
    }


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        canvas: int,
        max_gt: int = 1,
        shuffle: bool = True,
        drop_last: Optional[bool] = None,
        num_workers: int = 8,
        seed: int = 6666,
        shard_id: int = 0,
        num_shards: int = 1,
        text_buckets: Optional[List[int]] = None,
        device="cuda",
    ):
        self.ds = dataset
        self.bs = batch_size
        self.canvas = canvas
        self.max_gt = max_gt
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        if num_shards > 1 and text_buckets:
            # every shard must pick the same width for one step
            text_buckets = [max(text_buckets)]
        self.text_buckets = text_buckets
        self.device = torch.device(device)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Epoch-seeded reshuffle and per-epoch expression resampling."""
        self.epoch = epoch
        if self.shuffle and hasattr(self.ds, "epoch"):
            self.ds.epoch = epoch

    def _index_batches(self) -> List[Tuple[List[int], bool]]:
        """Returns [(sample_indices, is_wrap_pad)] for this shard;
        is_wrap_pad marks whole-batch duplicates added only so every
        shard yields the same number of steps; their samples do not count
        in metrics (batch_valid=False)."""
        n = len(self.ds)
        rng = np.random.default_rng(self.seed + self.epoch)
        if not self.shuffle:
            batches = [np.arange(n)[k:k + self.bs].tolist()
                       for k in range(0, n, self.bs)]
        else:  # aspect-ratio groups, as the JAX loader's default
            order = []
            for flag in np.unique(self.ds.flag):
                idx = np.flatnonzero(self.ds.flag == flag)
                rng.shuffle(idx)
                order.append(idx)
            # round each group up to full batches by wrapping, like
            # mmdet GroupSampler
            chunks = []
            for idx in order:
                pad = (-len(idx)) % self.bs
                if pad and not self.drop_last:
                    idx = np.concatenate([idx, idx[:pad]])
                for k in range(0, len(idx) - (len(idx) % self.bs),
                               self.bs):
                    chunks.append(idx[k:k + self.bs].tolist())
            rng.shuffle(chunks)
            batches = chunks

        if self.drop_last:
            batches = [b for b in batches if len(b) == self.bs]
        flagged = [(b, False) for b in batches]
        if self.num_shards > 1 and flagged:
            pad = (-len(flagged)) % self.num_shards
            if pad:
                flagged = flagged + [(b, True) for b, _ in flagged[:pad]]
        return flagged[self.shard_id::self.num_shards]

    def __len__(self):
        return len(self._index_batches())

    def _load(self, index: int, stream) -> Tuple[dict, torch.Tensor]:
        """One sample's geometry and its decoded image, on a pool thread:
        nvJPEG's host stage (the Huffman decode) and a PNG's inflate run
        outside the interpreter lock, so the pool's threads decode side by
        side."""
        s = self.ds[index]
        if stream is None:
            return s, decode_image(s["img_bytes"], self.device)
        with torch.cuda.stream(stream):
            return s, decode_image(s["img_bytes"], self.device)

    def _make(self, item, ex, stream):
        idx_list, is_pad = item
        valid = [not is_pad] * len(idx_list)
        # static shapes: wrap-pad the final short batch
        while len(idx_list) < self.bs:
            idx_list = idx_list + idx_list[: self.bs - len(idx_list)]
            valid = valid + [False] * (len(idx_list) - len(valid))
        samples, decoded = zip(*ex.map(self._load, idx_list,
                                       [stream] * len(idx_list)))
        if stream is None:
            return collate(list(samples), self.canvas, self.max_gt, valid,
                           self.text_buckets, self.device, decoded), None
        with torch.cuda.stream(stream):
            batch = collate(list(samples), self.canvas, self.max_gt, valid,
                            self.text_buckets, self.device, decoded)
            ready = torch.cuda.Event()
            ready.record(stream)
        return batch, ready

    def __iter__(self) -> Iterator[Dict]:
        batches = self._index_batches()
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        # double-buffer: build batch k+1 while k is consumed
        with ThreadPoolExecutor(self.num_workers) as ex, \
                ThreadPoolExecutor(1) as prefetcher:
            fut = None
            for k, item in enumerate(batches):
                if fut is None:
                    fut = prefetcher.submit(self._make, item, ex, stream)
                cur, ready = fut.result()
                fut = (prefetcher.submit(self._make, batches[k + 1], ex,
                                         stream)
                       if k + 1 < len(batches) else None)
                if ready is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(ready)
                    cur["image"].record_stream(consumer)
                yield cur
