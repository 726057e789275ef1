"""Model construction from reference-style config dicts (port of
``simvg_tpu/models/builder.py``, ``type="MIXDETRMB"``).

Reads the same ``model = dict(type="MIXDETRMB", vis_enc=..., head=...)``
keys as the JAX builder, from the unchanged files under ``configs/``.
``pretrain`` is recorded in the returned settings, not loaded.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn as nn

from .beit3 import BEiT3Config
from .heads.tgqs_head import TGQSHeadConfig
from .layers import LayerNorm
from .model import SimVGConfig, SimVGModel

# vis_enc keys that change the forward and are not ported, with the value
# that leaves them off.  scan_layers and remat only change how JAX
# compiles the same forward, and gelu_impl only picks JAX's erf form:
# the port reads none of them.
_NOT_PORTED = {"quant": "none", "token_prune_keep": None,
               "seq_parallel": False}


def build_model(model_cfg: Dict[str, Any], *, img_size: int = 640,
                dtype: torch.dtype = torch.float32,
                device=None) -> Tuple[SimVGModel, Dict[str, Any]]:
    """Returns (model, loss_cfg).  ``device="meta"`` builds the module
    tree without allocating its parameters."""
    if model_cfg.get("type", "MIXDETRMB") != "MIXDETRMB":
        raise NotImplementedError(
            f"model type {model_cfg.get('type')!r} is not ported")
    ve = dict(model_cfg.get("vis_enc") or {})
    head = dict(model_cfg.get("head") or {})
    for key, off in _NOT_PORTED.items():
        if ve.get(key, off) != off:
            raise NotImplementedError(f"vis_enc.{key}={ve[key]!r} is not "
                                      "ported")

    common = dict(
        img_size=ve.get("img_size", img_size),
        patch_size=ve.get("patch_size", 32),
        vocab_size=ve.get("vocab_size", 64010),
        drop_path_rate=ve.get("drop_path_rate", 0.1),
        attention_dropout=ve.get("attention_dropout", 0.0),
        dtype=dtype,
        attn_impl=ve.get("attn_impl", "xla"),
    )
    extra = {k: ve[k] for k in ("embed_dim", "num_heads", "ffn_dim",
                                "num_layers") if k in ve}
    if extra:  # tiny encoders for smoke/CI runs
        beit3 = BEiT3Config(**common, **extra)
    elif ve.get("vit_type", "base") == "base":
        beit3 = BEiT3Config.base(**common)
    else:
        beit3 = BEiT3Config.large(**common)

    head_cfg = TGQSHeadConfig(
        num_queries=head.get("num_queries", 1),
        in_channels=head.get("in_channels", beit3.embed_dim),
        embed_dim=head.get("embed_dim", 256),
        num_classes=head.get("num_classes", 1),
        text_max_token=head.get("text_max_token", 20),
        num_encoder_layers=head.get("num_encoder_layers", 6),
        num_decoder_layers=head.get("num_decoder_layers", 3),
        num_tgqg_layers=head.get("num_tgqg_layers", 1),
        only_decoder=head.get("only_decoder", True),
        num_token_mlp_layers=head.get("num_token_mlp_layers", 1),
        text_guided_query_generation=head.get(
            "text_guided_query_generation", True),
        tgqs_mid_dim=head.get("tgqs_mid_dim", 512),
        share_predicthead=head.get("share_predicthead", False),
        dtype=dtype,
    )

    with torch.device(device or "cpu"):
        model = SimVGModel(SimVGConfig(beit3=beit3, head=head_cfg))

    loss_cfg = {
        "branch_loss_weight": dict(head.get(
            "branch_loss_weight",
            {"decoder": 1.0,
             "balanced_distill": {"token": 2.0, "distill": 1.0}},
        )),
        "prepare_target_mode": head.get("prepare_target_mode",
                                        "score_iou_weighted"),
        "distill_type": head.get("distill_type", "hard_weighted"),
        "mlp_aux_loss": head.get("mlp_aux_loss", False),
        "as_target_query_thr": head.get("as_target_query_thr", 0.0),
        "freeze_layer": ve.get("freeze_layer", -1),
        "pretrain": ve.get("pretrain", None),
    }
    return model, loss_cfg


@torch.no_grad()
def init_random_weights(model: nn.Module,
                        generator: torch.Generator) -> nn.Module:
    """Fills every parameter from ``generator`` (on the parameters'
    device): LayerNorm scales 1, biases 0, everything else N(0, 0.02),
    the JAX encoder's Dense init scale.  The same seed gives the same
    weights on every run."""
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if isinstance(module, LayerNorm) and name == "weight":
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=generator)
    return model
