"""Model construction from reference-style config dicts (port of
``simvg_tpu/models/builder.py``): ``type="MIXDETRMB"`` (the SimVG model)
and ``type="OneStageModel"`` (the composed legacy family).

Reads the same ``model = dict(type=..., vis_enc=..., head=...)`` keys as
the JAX builder, from the unchanged files under ``configs/``.
``pretrain`` is recorded in the returned settings, not loaded.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn as nn

from .beit3 import BEiT3Config
from .fusion import ComposedOneStageModel, CrossAttentionFusion
from .heads.simple_head import DETRHead, DETRHeadConfig
from .heads.tgqs_head import TGQSHeadConfig
from .lan_encs import build_lan_enc
from .model import SimVGConfig, SimVGModel
from .vis_enc_zoo import MIXED_TYPES, build_vis_enc

# scan_layers only changes how JAX compiles the same forward, and gelu_impl
# only picks JAX's erf form: the port reads neither (but refuses scan_layers
# with token pruning, as the JAX encoder does).


# make_train_step's defaults: the loss settings a composed model's head
# dict does not give (the JAX train CLI raises KeyError on them instead)
LOSS_DEFAULTS = {"prepare_target_mode": "score_iou_weighted",
                 "distill_type": "hard_weighted", "mlp_aux_loss": False,
                 "as_target_query_thr": 0.0}


def _resolve_device(device):
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_model: no CUDA device; pass "
                               "device='cpu' to build on the CPU")
        device = "cuda"
    return device


def build_composed_model(model_cfg: Dict[str, Any], *, img_size: int = 640,
                         dtype: torch.dtype = torch.float32, device=None
                         ) -> Tuple[ComposedOneStageModel, Dict[str, Any]]:
    """The reference's OneStageModel from its config dict: a pure-vision
    zoo ``vis_enc`` (its position tables and windows sized for the canvas
    ``img_size``), a GRU or ALBERTA ``lan_enc``, the cross-attention
    ``fusion`` and the ``DETRHead``.  Returns (model, loss_cfg), the loss
    settings completed with ``LOSS_DEFAULTS``; ``freeze_layer`` and
    ``pretrain`` are read from ``vis_enc`` as JAX reads them.  A mixed
    vision-language ``vis_enc`` raises: the model calls its backbone on
    the image alone, where JAX's fails."""
    ve = dict(model_cfg.get("vis_enc") or {})
    if ve.get("type") in MIXED_TYPES:
        raise TypeError(f"vis_enc type {ve['type']!r} takes text beside the "
                        "image, which OneStageModel does not give it")
    le = dict(model_cfg.get("lan_enc") or {})
    fu = dict(model_cfg.get("fusion") or {})
    hd = dict(model_cfg.get("head") or {})
    fu.pop("type", None)
    hd.pop("type", None)
    loss_cfg = {k: hd.pop(k) for k in ("branch_loss_weight",
                                       "prepare_target_mode", "distill_type",
                                       "mlp_aux_loss", "as_target_query_thr")
                if k in hd}
    with torch.device(_resolve_device(device)):
        vis_enc = build_vis_enc(ve, dtype, img_size)
        lan_enc = build_lan_enc(le, dtype)
        head_cfg = DETRHeadConfig(dtype=dtype, **hd)
        fusion = CrossAttentionFusion(vis_enc.out_channels,
                                      lan_enc.out_channels, dtype=dtype,
                                      **fu)
        # flax infers the head's input width: the fusion's, whatever
        # in_channels says
        head = DETRHead(dataclasses.replace(head_cfg,
                                            in_channels=fusion.embed_dim))
        model = ComposedOneStageModel(vis_enc, lan_enc, fusion, head)
    loss_cfg.setdefault("branch_loss_weight", {"decoder": 1.0})
    for k, v in LOSS_DEFAULTS.items():
        loss_cfg.setdefault(k, v)
    loss_cfg["freeze_layer"] = ve.get("freeze_layer", -1)
    loss_cfg["pretrain"] = ve.get("pretrain", None)
    return model, loss_cfg


def build_model(model_cfg: Dict[str, Any], *, img_size: int = 640,
                dtype: torch.dtype = torch.float32,
                device=None) -> Tuple[nn.Module, Dict[str, Any]]:
    """Returns (model, loss_cfg), built on the card unless ``device``
    names another (``"cpu"``, or ``"meta"`` for the module tree without
    its parameters).  With no device given and no card present it
    raises."""
    if model_cfg.get("type") == "OneStageModel":
        return build_composed_model(model_cfg, img_size=img_size,
                                    dtype=dtype, device=device)
    if model_cfg.get("type", "MIXDETRMB") != "MIXDETRMB":
        raise KeyError(f"unknown model type {model_cfg.get('type')!r}")
    ve = dict(model_cfg.get("vis_enc") or {})
    head = dict(model_cfg.get("head") or {})
    if ve.get("token_prune_keep") is not None and ve.get("scan_layers"):
        raise ValueError("token_prune_keep requires scan_layers=False (the "
                         "sequence length changes mid-stack)")

    common = dict(
        img_size=ve.get("img_size", img_size),
        patch_size=ve.get("patch_size", 32),
        vocab_size=ve.get("vocab_size", 64010),
        drop_path_rate=ve.get("drop_path_rate", 0.1),
        attention_dropout=ve.get("attention_dropout", 0.0),
        dtype=dtype,
        attn_impl=ve.get("attn_impl", "xla"),
        token_prune_keep=ve.get("token_prune_keep", None),
        token_prune_layer=ve.get("token_prune_layer", 4),
        token_prune_force=ve.get("token_prune_force", False),
        quant=ve.get("quant", "none"),
        remat=ve.get("remat", False),
        remat_policy=ve.get("remat_policy", "full"),
        seq_parallel=ve.get("seq_parallel", False),
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

    with torch.device(_resolve_device(device)):
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


# jax.nn.initializers.truncated_normal draws within two standard deviations;
# variance_scaling's truncated form divides its scale by the std of that
# draw, so lecun_normal keeps a variance of 1 / fan_in after the cut
_TRUNC_STD = 0.87962566103423978


_BEIT3 = "vis_enc.beit3."
# the BEiT-3 encoder under the SimVG model and under the task heads
_BEIT3_PATHS = (_BEIT3, "beit3.")
# the zoo's learned tables, drawn from flax's normal(0.02)
_ZOO_TABLES = ("pos_embed", "det_tokens", "det_pos", "img_pos", "txt_pos",
               "cls_token", "type_embed")


def _initializer(path: str, module: nn.Module, name: str, p: torch.Tensor):
    """(kind, std) of the flax initialiser of the JAX counterpart of
    ``path``: "ones", "zeros", "const" (the value in ``std``'s place),
    "normal" or "truncated" (two-std cut, ``std`` before the cut)."""
    if isinstance(module, nn.GRU):  # lan_encs.py: Dense "ih", "hh_kernel"
        if name.startswith("bias"):
            return "zeros", 0.0
        return "truncated", p[0].numel() ** -0.5 / _TRUNC_STD
    if isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
        return ("ones", 0.0) if name == "weight" else ("zeros", 0.0)
    if name == "rel_pos_bias":  # vis_enc_zoo.py: truncated_normal(0.02)
        return "truncated", 0.02
    if name.endswith("bias") or name == "mask_token":
        return "zeros", 0.0
    if name == "logit_scale":  # beit3_heads.py: log(1 / 0.07)
        return "const", math.log(1.0 / 0.07)
    if name == "cls_token" and path.startswith(_BEIT3_PATHS):
        return "truncated", 0.02  # beit3.py: truncated_normal(0.02)
    if name in _ZOO_TABLES:  # vis_enc_zoo.py, vis_encs.py: normal(0.02)
        return "normal", 0.02
    if isinstance(module, nn.Embedding):
        if path == "head.query_embed.weight":  # tgqs_head.py: normal(1.0)
            return "normal", 1.0
        if path == "lan_enc.embedding.weight":  # lan_encs.py: normal(0.02)
            return "normal", 0.02
        # text_embed: normal(D^-1/2); the position tables: flax's Embed
        # default, variance_scaling(1, fan_in, normal) over D
        return "normal", p.shape[1] ** -0.5
    if name == "query_embed":  # legacy_layers.py MDETR: normal(1.0)
        return "normal", 1.0
    if path.startswith(_BEIT3_PATHS) and isinstance(module, nn.Linear):
        return "truncated", 0.02  # beit3.py::_dense
    if isinstance(module, (nn.Linear, nn.Conv2d)) or \
            name == "in_proj_weight":
        # flax's Dense/Conv default, lecun_normal: fan_in is every axis but
        # the output one (torch keeps the output axis first)
        fan_in = p[0].numel()
        return "truncated", fan_in ** -0.5 / _TRUNC_STD
    raise ValueError(f"no initialiser for {path} ({type(module).__name__})")


@torch.no_grad()
def init_random_weights(model: nn.Module, seed) -> nn.Module:
    """Fills every parameter with the flax initialiser of its JAX
    counterpart: truncated N(0.02) on the encoder's Dense layers and
    ``cls_token``, zeros on ``mask_token`` and every bias, N(0, D^-1/2) on
    the embedding tables, N(0, 1) on ``query_embed``, lecun_normal on the
    patch conv and every head Dense, LayerNorm scales 1.  The composed
    family's: lecun_normal on the convs, the Dense layers and the GRU's
    weights, GroupNorm scales 1, N(0, 0.02) on the GRU's word embedding
    and the zoo's learned tables (``_ZOO_TABLES``), truncated N(0.02) on
    Swin's ``rel_pos_bias``, N(0, D^-1/2) on the other embedding tables
    (ALBERTA's, ViLT's ``word_embed``).

    ``seed``: an int or a CPU ``torch.Generator``.  Every draw is made on
    the CPU in float32 and copied to the parameter's device, so one seed
    gives the same weights on every device."""
    if isinstance(seed, torch.Generator):
        generator = seed
        if generator.device.type != "cpu":
            raise ValueError("init_random_weights draws on a CPU generator; "
                             f"got one on {generator.device}")
    else:
        generator = torch.Generator().manual_seed(int(seed))
    for mod_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            path = f"{mod_name}.{name}" if mod_name else name
            kind, std = _initializer(path, module, name, p)
            if kind in ("ones", "zeros", "const"):
                p.fill_({"ones": 1.0, "zeros": 0.0}.get(kind, std))
                continue
            t = torch.empty(p.shape, dtype=torch.float32)
            t.normal_(0.0, std, generator=generator)
            if kind == "truncated":
                # redraw the values outside two std until none is left:
                # the truncated normal, ~14x faster than trunc_normal_'s
                # inverse-CDF draw at these sizes
                flat = t.view(-1)
                idx = (flat.abs() > 2 * std).nonzero().squeeze(1)
                redo = flat[idx]
                while idx.numel():
                    out = redo.abs() > 2 * std
                    if not out.any():
                        break
                    redo[out] = torch.empty(int(out.sum())).normal_(
                        0.0, std, generator=generator)
                flat[idx] = redo
            p.copy_(t)
    return model
