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
from .model import SimVGConfig, SimVGModel

# scan_layers only changes how JAX compiles the same forward, and gelu_impl
# only picks JAX's erf form: the port reads neither (but refuses scan_layers
# with token pruning, as the JAX encoder does).


def build_model(model_cfg: Dict[str, Any], *, img_size: int = 640,
                dtype: torch.dtype = torch.float32,
                device=None) -> Tuple[SimVGModel, Dict[str, Any]]:
    """Returns (model, loss_cfg), built on the card unless ``device``
    names another (``"cpu"``, or ``"meta"`` for the module tree without
    its parameters).  With no device given and no card present it
    raises."""
    if model_cfg.get("type", "MIXDETRMB") != "MIXDETRMB":
        raise NotImplementedError(
            f"model type {model_cfg.get('type')!r} is not ported yet "
            "(ROADMAP: M20)")
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

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_model: no CUDA device; pass "
                               "device='cpu' to build on the CPU")
        device = "cuda"
    with torch.device(device):
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


def _initializer(path: str, module: nn.Module, name: str, p: torch.Tensor):
    """(kind, std) of the flax initialiser of the JAX counterpart of
    ``path``: "ones", "zeros", "normal" or "truncated" (two-std cut, ``std``
    before the cut)."""
    if isinstance(module, nn.LayerNorm):
        return ("ones", 0.0) if name == "weight" else ("zeros", 0.0)
    if name.endswith("bias") or name == "mask_token":
        return "zeros", 0.0
    if name == "cls_token":  # beit3.py: truncated_normal(0.02)
        return "truncated", 0.02
    if isinstance(module, nn.Embedding):
        if path == "head.query_embed.weight":  # tgqs_head.py: normal(1.0)
            return "normal", 1.0
        # text_embed: normal(D^-1/2); the position tables: flax's Embed
        # default, variance_scaling(1, fan_in, normal) over D
        return "normal", p.shape[1] ** -0.5
    if path.startswith("vis_enc.") and isinstance(module, nn.Linear):
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
    patch conv and every head Dense, LayerNorm scales 1.

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
            if kind in ("ones", "zeros"):
                p.fill_(1.0 if kind == "ones" else 0.0)
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
