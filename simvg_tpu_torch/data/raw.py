"""Raw-source preprocessing shared by the demo and the server (port of
``simvg_tpu/data/raw.py``).

(image bytes, expression) -> the sample that the config's val
pipeline gives, by the dataset loader's own route: the geometry from the
file's header on the host (``data/image_file.py``), the transforms' sizes
and scale factors on the host (``data/transforms.py``), the pixels decoded
and resized on the device when the batch is made (``data/image_ops.py``).  So
the demo, the server and the loader cannot drift from each other.

``normalize_on_device`` configs are honoured: the Normalize op is skipped
(images stay uint8) and ``device_norm`` carries the ``img_norm_cfg`` that
the eval step must apply on the device.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .builder import build_pipeline
from .image_file import decode_image, image_geometry
from .loader import collate
from .tokenization import build_tokenizer


class RawPreprocessor:
    """(image bytes, expression) -> pipeline sample dict;
    ``collate`` makes the batch of such samples on ``device``.

    Built from a full config (the keys the test CLI reads):
    ``val_pipeline``, ``max_token``, ``tokenizer_spm``,
    ``normalize_on_device``, ``img_norm_cfg``, ``img_size``.
    """

    def __init__(self, cfg, device="cuda"):
        norm_on_device = cfg.get("normalize_on_device", False)
        tfs, load_cfg = build_pipeline(cfg.get("val_pipeline", []),
                                       normalize_on_device=norm_on_device)
        self.transforms = tfs
        self.max_token = load_cfg.get("max_token", cfg.get("max_token", 20))
        # the datasets' tokenizer resolution: the spm path lives in the
        # pipeline's load op, with the same default
        self.tokenizer = build_tokenizer(
            load_cfg.get("use_token_type", "beit3"),
            spm_path=load_cfg.get("spm_path", cfg.get("tokenizer_spm")
                                  or "pretrain_weights/beit3.spm"))
        self.device_norm = (dict(cfg.get("img_norm_cfg", {})) or None) \
            if norm_on_device else None
        self.canvas = cfg.get("img_size", 640)
        self.device = device

    def __call__(self, data: bytes, expression: str,
                 filename: str = "<raw>") -> dict:
        """The sample of one image stream (any format ``image_file``
        reads); raises ValueError on any other stream."""
        geo = image_geometry(data)
        shape = (geo.height, geo.width, 3)
        ids, mask = self.tokenizer.encode(expression, self.max_token)
        s = {
            "img_bytes": data,
            "pixel_ops": [],
            "ori_shape": shape,
            "img_shape": shape,
            "pad_shape": shape,
            "scale_factor": np.ones(4, np.float32),
            "with_bbox": False,
            "with_mask": False,
            "filename": filename,
            "expression": expression,
            "ref_expr_inds": ids,
            "text_attention_mask": mask,
        }
        for t in self.transforms:
            s = t(s)
        return s

    def decode(self, sample: dict):
        """The sample's decoded image on the device (nvJPEG or the PNG
        kernel on a card)."""
        return decode_image(sample["img_bytes"], self.device)

    def collate(self, samples: List[dict], decoded: Sequence = ()) -> dict:
        """The batch of ``samples`` (``max_gt`` 1), their images decoded here
        unless ``decoded`` gives them."""
        decoded = list(decoded) or [self.decode(s) for s in samples]
        return collate(samples, self.canvas, max_gt=1, device=self.device,
                       decoded=decoded)
