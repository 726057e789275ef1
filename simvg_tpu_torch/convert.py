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
same bicubic resize); an HF BERT/roberta one goes into the ALBERTA
``lan_enc`` (``convert_hf_bert``).

``export_composed`` does the same for a composed OneStageModel tree
(``vis_enc``/``lan_enc``/``fusion``/``head``): conv kernels go from flax's
[kh, kw, in, out] to torch's [out, in, kh, kw], Dense kernels and the
GRU's kernels are transposed (the GRU's into ``nn.GRU``'s names), and the
DETR head's decoder, encoder,
``input_proj`` and ``query_embed`` take the flagship head's names.
``export_beit3_heads`` maps a BEiT-3 task head's tree (``beit3`` plus
the head's own modules, ``models/beit3_heads.py``) and ``export_legacy``
a SeqTR/MDETR transformer's (``models/legacy_layers.py``).
``export_params`` picks the exporter from the tree's top-level keys.

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
    under the port's own names, ``beit3.*`` a BEiT-3 pretrain one, and
    ``embeddings.word_embeddings.weight`` (under ``roberta.``, ``bert.`` or
    no prefix) an HF BERT/roberta one for the ALBERTA ``lan_enc``."""
    if any(k.startswith("vis_enc.") for k in sd):
        named = dict(sd)
    elif any(k.startswith("beit3.") for k in sd):
        named = {"vis_enc." + k: v for k, v in sd.items()
                 if k.startswith("beit3.")}
    elif any("embeddings.word_embeddings.weight" in k for k in sd):
        named = convert_hf_bert(sd, target)
    else:
        raise ValueError("unknown checkpoint layout: neither vis_enc.* nor "
                         "beit3.* keys nor an HF BERT's")
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


# an HF BERT layer's modules and the ALBERTA encoder's names for them
_HF_BERT_LAYER = (("attention.self.query", "q"), ("attention.self.key", "k"),
                  ("attention.self.value", "v"),
                  ("attention.output.dense", "o"),
                  ("intermediate.dense", "fc1"), ("output.dense", "fc2"),
                  ("attention.output.LayerNorm", "attn_ln"),
                  ("output.LayerNorm", "ffn_ln"))


def convert_hf_bert(sd: Dict, target: Dict[str, torch.Tensor],
                    prefix: str = "lan_enc.") -> Dict[str, torch.Tensor]:
    """An HF BERT/roberta state dict (``roberta.``/``bert.`` prefixes
    dropped) -> the ALBERTA encoder's entries under ``prefix``; the port's
    copy of ``tools/convert_checkpoint.py::convert_hf_bert``.  HF adds its
    token-type row 0 to every position, so it is folded into the position
    table; torch's Linear weights keep their layout.  Raises ValueError
    unless the checkpoint has as many layers as ``target`` (a state dict
    naming ``{prefix}q_{i}.weight``)."""
    for model_prefix in ("roberta.", "bert."):
        if any(k.startswith(model_prefix + "embeddings.") for k in sd):
            sd = {k[len(model_prefix):]: v for k, v in sd.items()
                  if k.startswith(model_prefix)}
            break

    def f32(key):
        v = sd[key]
        return v.float() if torch.is_tensor(v) else torch.as_tensor(
            np.asarray(v, np.float32))

    pos = f32("embeddings.position_embeddings.weight").clone()
    if "embeddings.token_type_embeddings.weight" in sd:
        pos += f32("embeddings.token_type_embeddings.weight")[0]
    out = {prefix + "word_embeddings.weight":
           f32("embeddings.word_embeddings.weight"),
           prefix + "position_embeddings.weight": pos,
           prefix + "embeddings_ln.weight": f32("embeddings.LayerNorm.weight"),
           prefix + "embeddings_ln.bias": f32("embeddings.LayerNorm.bias")}
    i = 0
    while f"encoder.layer.{i}.attention.self.query.weight" in sd:
        for src, dst in _HF_BERT_LAYER:
            for leaf in ("weight", "bias"):
                out[f"{prefix}{dst}_{i}.{leaf}"] = f32(
                    f"encoder.layer.{i}.{src}.{leaf}")
        i += 1
    n_target = sum(1 for k in target if k.startswith(prefix + "q_")
                   and k.endswith(".weight"))
    if i != n_target:
        raise ValueError(f"HF checkpoint has {i} layers, encoder expects "
                         f"{n_target}")
    return out


@torch.no_grad()
def load_pretrained_into_model(model: torch.nn.Module, path: str,
                               logger: Optional[logging.Logger] = None
                               ) -> List[str]:
    """Loads a reference ``.pth`` (full SimVG, BEiT-3 pretrain or HF BERT)
    into ``model`` in place; logs the keys it loaded, the model keys it
    left as they were and the checkpoint keys it did not use.  Returns the
    loaded keys."""
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
    a composed model's, a BEiT-3 task head's or a legacy transformer's,
    numpy or JAX arrays) into ``model`` with ``strict=True``."""
    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in export_params(params).items()}
    model.load_state_dict(sd, strict=True)
    return model


def export_params(params: Dict) -> Dict[str, np.ndarray]:
    """A flax param (or gradient) tree -> the port's state dict:
    ``export_composed`` for a OneStageModel tree, ``export_simvg_full`` for
    a SimVG model's (``beit3`` and the DETR ``head``), ``export_beit3_heads``
    for a BEiT-3 task head's (``beit3`` beside the head's own modules; NLVR2's
    ``head`` is a TwoLayerMLP), else ``export_legacy``."""
    top = params["params"]
    if "vis_enc" in top:
        return export_composed(params)
    if "beit3" in top:
        if set(top) == {"beit3", "head"} and "dense1" not in top["head"]:
            return export_simvg_full(params)
        return export_beit3_heads(params)
    return export_legacy(params)


def export_beit3_heads(params: Dict) -> Dict[str, np.ndarray]:
    """A BEiT-3 task head's flax tree (``{"params": {"beit3": ..., "pooler"
    / "head" / "fc_norm" / ...}}``) -> the port's state dict: the encoder
    under ``beit3.`` by ``_export_beit3_key``, the rest by ``_torch_leaf``."""
    sd: Dict[str, np.ndarray] = {}
    for path, v in _flatten(params["params"]).items():
        top, _, rest = path.partition("/")
        if top != "beit3":
            name, value = _torch_leaf(path, v)
        elif rest == "vision_embed/proj/kernel":
            name, value = ("beit3.vision_embed.proj.weight",
                           np.transpose(v, (3, 2, 0, 1)))
        else:
            key, transpose = _export_beit3_key(rest.split("/"))
            name, value = "beit3." + key, (v.T if transpose else v)
        sd[name] = np.ascontiguousarray(value)
    return sd


# the legacy transformers' lists of layers: flax ``<name>_<i>``
_LEGACY_LISTS = ("encoder_layers", "decoder_layers", "enc", "dec")


def export_legacy(params: Dict) -> Dict[str, np.ndarray]:
    """An ``AutoRegressiveTransformer`` or ``MDETRTransformer`` flax tree ->
    the port's state dict: ``encoder_layers_0`` -> ``encoder_layers.0``
    (``enc_0`` -> ``enc.0``), then ``_torch_leaf``."""
    sd: Dict[str, np.ndarray] = {}
    for path, v in _flatten(params["params"]).items():
        parts = path.split("/")
        base, _, idx = parts[0].rpartition("_")
        if base in _LEGACY_LISTS and idx.isdigit():
            parts[0] = f"{base}.{idx}"
        name, value = _torch_leaf("/".join(parts), v)
        sd[name] = np.ascontiguousarray(value)
    return sd


# JAX's GRU module -> the suffix of nn.GRU's parameter names
_GRU = {"gru_fwd": "", "gru_bwd": "_reverse"}


def _torch_leaf(path: str, v: np.ndarray):
    """(torch name, value) of a flax leaf outside the DETR head's shared
    parts: ``layers_i`` -> ``layers.i``; a 4-D conv kernel transposed to
    [out, in, kh, kw], a Dense kernel to [out, in], the GRU's kernels
    into ``nn.GRU``'s ``weight_ih_l0``/``weight_hh_l0`` (``_reverse``);
    ``scale`` and ``embedding`` are the torch modules' ``weight``."""
    parts = [p.replace("layers_", "layers.") if p.startswith("layers_")
             else p for p in path.split("/")]
    leaf = parts[-1]
    gru = next((p for p in parts if p in _GRU), None)
    if gru is not None:
        # lan_enc/gru_{fwd,bwd}/ih/{kernel,bias} and .../hh_{kernel,bias}
        # -> lan_enc.gru.{weight,bias}_{ih,hh}_l0[_reverse]
        gate = "ih" if parts[-2] == "ih" else "hh"
        kind = "weight" if leaf.endswith("kernel") else "bias"
        name = f"{kind}_{gate}_l0{_GRU[gru]}"
        return ".".join(parts[:parts.index(gru)] + ["gru", name]), (
            v.T if kind == "weight" else v)
    if leaf == "kernel":
        v = np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T
        return ".".join(parts[:-1] + ["weight"]), v
    if leaf in ("scale", "embedding"):
        return ".".join(parts[:-1] + ["weight"]), v
    return ".".join(parts), v


def export_composed(params: Dict) -> Dict[str, np.ndarray]:
    """A composed OneStageModel's flax tree (``{"params": {"vis_enc",
    "lan_enc", "fusion", "head"}}``) -> the port's state dict."""
    sd: Dict[str, np.ndarray] = {}
    head: Dict = {}
    for path, v in _flatten(params["params"]).items():
        top, _, rest = path.partition("/")
        if top == "head" and rest.split("/")[0] not in ("class_embed",
                                                        "bbox_embed"):
            head[rest] = v
            continue
        name, value = _torch_leaf(path, v)
        sd[name] = np.ascontiguousarray(value)
    # the decoder, encoder, input_proj and query_embed: the flagship
    # head's export, which names them alike
    sd.update(export_simvg_full({"params": {"head": _unflatten(head)}}))
    return sd


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        *dirs, leaf = path.split("/")
        node = tree
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = v
    return tree


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
