"""Weight carry-over: from the JAX package, and from reference ``.pth``
checkpoints (M7, pretrained load).

The port's modules keep the reference's torch state-dict names, so a
``simvg_tpu`` parameter tree maps onto the port by the JAX package's own
exporter.  This module keeps a numpy-only copy of that exporter
(``tools/convert_checkpoint.py``: ``_flatten``, ``export_simvg_full``,
``_export_beit3_key``, ``_export_head_entry``), held to the original by
tests/test_torch_convert.py, so the port imports nothing of the JAX side.
The same mapping names a gradient tree, which has the parameters' shape.

``load_pretrained_into_model`` is the port's counterpart of
``tools/convert_checkpoint.py::load_pretrained_into_params``: a full SimVG
state dict (``vis_enc.*``, ``head.*``) or a BEiT-3 pretrain one
(``beit3.*``) goes into the model under the port's names, with the vision
position table and the patch projection interpolated to the model's grid
and patch size (``interpolate_pos_embed``, ``interpolate_patch_proj``, the
same bicubic resize).

``quant_key_to_jax`` and ``quant_keys_from_jax`` name the int8 serving
artifact's entries (``ops/quant.py``) both ways: the port's
``<module>.<leaf>`` and the flax path of JAX's ``.npz``.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_BEIT3 = "vis_enc.beit3."
_VIS_POS = _BEIT3 + "encoder.embed_positions.A.weight"
_TEXT_POS = _BEIT3 + "encoder.embed_positions.B.weight"
_PATCH_PROJ = _BEIT3 + "vision_embed.proj.weight"


def interpolate_pos_embed(weight: torch.Tensor, target_len: int,
                          num_extra: int = 3) -> torch.Tensor:
    """Bicubic grid interpolation of the vision position table; the first
    ``num_extra`` rows (pad offset x2, CLS) are kept as they are."""
    if weight.shape[0] == target_len:
        return weight
    extra, pos = weight[:num_extra], weight[num_extra:]
    orig = int(round(len(pos) ** 0.5))
    new = int(round((target_len - num_extra) ** 0.5))
    if orig * orig != len(pos) or new * new != target_len - num_extra:
        raise ValueError(f"position tables of {weight.shape[0]} and "
                         f"{target_len} rows are not square grids")
    t = pos.float().reshape(1, orig, orig, -1).permute(0, 3, 1, 2)
    t = F.interpolate(t, size=(new, new), mode="bicubic",
                      align_corners=False)
    return torch.cat([extra.float(), t.permute(0, 2, 3, 1).reshape(
        new * new, -1)], dim=0)


def interpolate_patch_proj(weight: torch.Tensor, target_hw) -> torch.Tensor:
    """Bicubic resize of the patchify conv kernel [out, in, kh, kw]."""
    if tuple(weight.shape[-2:]) == tuple(target_hw):
        return weight
    return F.interpolate(weight.float(), size=tuple(target_hw),
                         mode="bicubic", align_corners=False)


def _torch_load(path: str) -> Dict[str, torch.Tensor]:
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model", "module", "state_dict"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
            else v for k, v in ckpt.items()}


def pretrained_state_dict(sd: Dict[str, torch.Tensor],
                          target: Dict[str, torch.Tensor]
                          ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Maps a checkpoint's state dict onto ``target``'s names and shapes:
    returns (the tensors to load, the checkpoint keys left unused).
    Dispatches by key inventory: ``vis_enc.*`` is a full SimVG state dict
    under the port's own names, ``beit3.*`` a BEiT-3 pretrain one."""
    if any(k.startswith("vis_enc.") for k in sd):
        named = dict(sd)
    elif any(k.startswith("beit3.") for k in sd):
        named = {"vis_enc." + k: v for k, v in sd.items()
                 if k.startswith("beit3.")}
    elif any("embeddings.word_embeddings.weight" in k for k in sd):
        raise NotImplementedError("HF BERT checkpoints feed the legacy "
                                  "language encoders, not ported yet "
                                  "(ROADMAP: M20)")
    else:
        raise ValueError("unknown checkpoint layout: neither vis_enc.* nor "
                         "beit3.* keys")
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for key, value in named.items():
        if key not in target:
            unused.append(key)
            continue
        want = target[key]
        if key == _VIS_POS:
            value = interpolate_pos_embed(value, want.shape[0])
        elif key == _TEXT_POS and value.shape[0] != want.shape[0]:
            # learned text positions: keep every row the checkpoint has
            # that the model has too
            merged = want.detach().cpu().clone()
            n = min(value.shape[0], want.shape[0])
            merged[:n] = value[:n]
            value = merged
        elif key == _PATCH_PROJ:
            value = interpolate_patch_proj(value, want.shape[-2:])
        if tuple(value.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch at {key}: checkpoint "
                             f"{tuple(value.shape)}, model "
                             f"{tuple(want.shape)}")
        out[key] = value.to(want.dtype)
    return out, unused


@torch.no_grad()
def load_pretrained_into_model(model: torch.nn.Module, path: str,
                               logger: Optional[logging.Logger] = None
                               ) -> List[str]:
    """Loads a reference ``.pth`` (full SimVG or BEiT-3 pretrain) into
    ``model`` in place; logs the keys it loaded, the model keys it left as
    they were and the checkpoint keys it did not use.  Returns the loaded
    keys."""
    target = model.state_dict()
    mapped, unused = pretrained_state_dict(_torch_load(path), target)
    for key, value in mapped.items():
        target[key].copy_(value)
    missing = sorted(set(target) - set(mapped))
    if logger is not None:
        logger.info(f"pretrained {path}: loaded {len(mapped)} tensors; "
                    f"{len(missing)} model keys kept their values "
                    f"{missing[:8]}{' ...' if len(missing) > 8 else ''}; "
                    f"{len(unused)} checkpoint keys unused {unused[:8]}"
                    f"{' ...' if len(unused) > 8 else ''}")
    return sorted(mapped)


def load_jax_params(model: torch.nn.Module, params: Dict) -> torch.nn.Module:
    """Loads a flax param tree (``{"params": {"beit3": ..., "head": ...}}``,
    numpy or JAX arrays) into ``model`` with ``strict=True``."""
    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in export_simvg_full(params).items()}
    model.load_state_dict(sd, strict=True)
    return model


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, p))
        else:
            out[p] = np.asarray(v)
    return out


def export_simvg_full(params: Dict) -> Dict[str, np.ndarray]:
    """Inverse of convert_simvg_full: flax params -> torch state dict
    with the reference's key names (vis_enc.beit3.* / head.*), so
    trained weights can round-trip back to the reference stack."""
    flat = _flatten(params["params"])
    sd: Dict[str, np.ndarray] = {}

    def put(torch_key, value, transpose=False):
        sd[torch_key] = np.ascontiguousarray(value.T if transpose
                                             else value)

    packed_qkv: Dict[str, Dict[str, np.ndarray]] = {}

    for path, v in flat.items():
        parts = path.split("/")
        if parts[0] == "beit3":
            if path == "beit3/vision_embed/proj/kernel":
                # flax conv [kh, kw, in, out] -> torch [out, in, kh, kw]
                sd["vis_enc.beit3.vision_embed.proj.weight"] = (
                    np.ascontiguousarray(np.transpose(v, (3, 2, 0, 1)))
                )
                continue
            key = _export_beit3_key(parts[1:])
            if key is None:
                continue
            torch_key, transpose = key
            put("vis_enc.beit3." + torch_key, v, transpose)
        elif parts[0] == "head":
            _export_head_entry(parts[1:], v, sd, packed_qkv)

    # assemble packed in_proj tensors for the detrex attention modules
    for base, parts_map in packed_qkv.items():
        for suffix, names in (("weight", ("q_kernel", "k_kernel",
                                          "v_kernel")),
                              ("bias", ("q_bias", "k_bias", "v_bias"))):
            if names[0] in parts_map:
                mats = [parts_map[n] for n in names]
                if suffix == "weight":
                    mats = [m.T for m in mats]
                sd[base + f".in_proj_{suffix}"] = np.ascontiguousarray(
                    np.concatenate(mats, axis=0)
                )
    return sd


def _export_beit3_key(parts):
    """flax beit3 path -> (torch key under beit3., transpose?)."""
    p = "/".join(parts)
    simple = {
        "text_embed/embedding": ("text_embed.weight", False),
        "vision_pos_embed/embedding":
            ("encoder.embed_positions.A.weight", False),
        "text_pos_embed/embedding":
            ("encoder.embed_positions.B.weight", False),
        "vision_embed/cls_token": ("vision_embed.cls_token", False),
        "vision_embed/mask_token": ("vision_embed.mask_token", False),
        "vision_embed/proj/bias": ("vision_embed.proj.bias", False),
        "layer_norm_A/scale": ("encoder.layer_norm.A.weight", False),
        "layer_norm_A/bias": ("encoder.layer_norm.A.bias", False),
        "layer_norm_B/scale": ("encoder.layer_norm.B.weight", False),
        "layer_norm_B/bias": ("encoder.layer_norm.B.bias", False),
    }
    if p in simple:
        return simple[p]
    if p == "vision_embed/proj/kernel":
        return None  # 4-D conv kernel: handled by the caller
    if parts[0].startswith("layers_"):
        i = parts[0].split("_")[1]
        rest = parts[1:]
        base = f"encoder.layers.{i}."
        if rest[0] == "self_attn":
            name = rest[1]  # e.g. q_proj_A / inner_attn_ln_A
            leaf = rest[2]  # kernel/bias/scale
            mod, ab = name.rsplit("_", 1)
            tleaf = {"kernel": "weight", "scale": "weight",
                     "bias": "bias"}[leaf]
            return (f"{base}self_attn.{mod}.{ab}.{tleaf}",
                    leaf == "kernel")
        if rest[0] == "ffn":
            mod, ab = rest[1].rsplit("_", 1)
            leaf = rest[2]
            tleaf = {"kernel": "weight", "scale": "weight",
                     "bias": "bias"}[leaf]
            return (f"{base}ffn.{ab}.{mod}.{tleaf}", leaf == "kernel")
        mod, ab = rest[0].rsplit("_", 1)
        leaf = rest[1]
        tleaf = {"kernel": "weight", "scale": "weight",
                 "bias": "bias"}[leaf]
        return (f"{base}{mod}.{ab}.{tleaf}", False)
    return None


def _export_head_entry(parts, v, sd, packed_qkv):
    p = "/".join(parts)

    def put(key, val, transpose=False):
        sd["head." + key] = np.ascontiguousarray(val.T if transpose
                                                 else val)

    if p == "query_embed":
        put("query_embed.weight", v)
        return
    if parts[0] == "input_proj":
        if parts[1] == "kernel":
            put("input_proj.weight", v.T[:, :, None, None])
        else:
            put("input_proj.bias", v)
        return
    if parts[0] in ("input_text_proj", "input_cls_proj",
                    "class_embed_token", "class_embed_decoder"):
        put(f"{parts[0]}.{'weight' if parts[1] == 'kernel' else 'bias'}",
            v, parts[1] == "kernel")
        return
    if parts[0] in ("mlp", "bbox_embed_token", "bbox_embed_decoder"):
        i = parts[1].split("_")[1]
        put(f"{parts[0]}.layers.{i}."
            f"{'weight' if parts[2] == 'kernel' else 'bias'}",
            v, parts[2] == "kernel")
        return
    if parts[0] in ("decoder", "tgqg", "encoder"):
        tname = {"decoder": "transformer.decoder",
                 "encoder": "transformer.encoder",
                 "tgqg": "text_guided_query_generation_transformer"}[
            parts[0]]
        if parts[1] == "post_norm_layer":
            put(f"{tname}.post_norm_layer."
                f"{'weight' if parts[2] == 'scale' else 'bias'}", v)
            return
        i = parts[1].split("_")[1]
        base = f"{tname}.layers.{i}."
        rest = parts[2:]
        if rest[0] in ("self_attn", "cross_attn"):
            n = 0 if rest[0] == "self_attn" else 1
            attn_base = f"head.{base}attentions.{n}.attn"
            if rest[1] == "out_proj":
                put(f"{base}attentions.{n}.attn.out_proj."
                    f"{'weight' if rest[2] == 'kernel' else 'bias'}",
                    v, rest[2] == "kernel")
            else:  # q/k/v proj -> packed in_proj
                proj = rest[1][0]  # q/k/v
                leaf = "kernel" if rest[2] == "kernel" else "bias"
                packed_qkv.setdefault(attn_base, {})[
                    f"{proj}_{leaf}"] = v
            return
        if rest[0] == "ffn":
            idx = "0.0" if rest[1] == "fc1" else "1"
            put(f"{base}ffns.0.layers.{idx}."
                f"{'weight' if rest[2] == 'kernel' else 'bias'}",
                v, rest[2] == "kernel")
            return
        if rest[0].startswith("norm"):
            n = int(rest[0][4:]) - 1
            put(f"{base}norms.{n}."
                f"{'weight' if rest[1] == 'scale' else 'bias'}", v)
            return


def quant_key_to_jax(name: str) -> str:
    """A quant collection key of the port -> the flax path of JAX's
    ``.npz`` ('/'-joined): ``vis_enc.beit3.encoder.layers.0.self_attn.
    q_proj.A.w_q`` -> ``beit3/layers_0/self_attn/q_proj_A/w_q``,
    ``...layers.0.ffn.A.fc1.act_scale`` -> ``.../ffn/fc1_A/act_scale``.
    The inverse of ``quant_keys_from_jax`` on an unstacked key."""
    prefix, _, rest = name.partition("encoder.layers.")
    if prefix not in ("vis_enc.beit3.", ""):
        raise KeyError(f"not a quantized encoder layer: {name}")
    i, block, *mod, leaf = rest.split(".")
    if block == "self_attn":  # self_attn.q_proj.A
        path = f"self_attn/{mod[0]}_{mod[1]}"
    elif block == "ffn":  # ffn.A.fc1
        path = f"ffn/{mod[1]}_{mod[0]}"
    else:
        raise KeyError(f"not a quantized encoder layer: {name}")
    return f"{'beit3/' if prefix else ''}layers_{i}/{path}/{leaf}"


def quant_keys_from_jax(key: str, value: np.ndarray):
    """A flax path of JAX's ``.npz`` and its array -> [(the port's quant
    collection key, array)]: one entry, or one per layer for a stacked
    ``layers/...`` entry of a model calibrated under ``scan_layers=True``
    (a leading layer axis)."""
    parts = key.split("/")
    prefix = ""
    if parts[0] == "beit3":
        prefix, parts = "vis_enc.beit3.", parts[1:]
    if parts[0] == "layers":  # scan-stacked: split the leading axis
        return [pair for i in range(value.shape[0]) for pair in
                quant_keys_from_jax("/".join(
                    (["beit3"] if prefix else []) + [f"layers_{i}"]
                    + parts[1:]), value[i])]
    got = _export_beit3_key(parts[:-1] + ["kernel"])
    if got is None or not got[0].endswith(".weight"):
        raise KeyError(f"not a quantized encoder layer: {key}")
    return [(prefix + got[0][:-len("weight")] + parts[-1], value)]
