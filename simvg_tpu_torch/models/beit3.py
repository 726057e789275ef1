"""BEiT-3 multiway encoder, joint mode (port of ``simvg_tpu/models/beit3.py``).

The joint sequence is ``[CLS] + image patches + text tokens``; every
multiway module holds two parameter sets, ``A`` for the vision segment
and ``B`` for the text segment.  As in the JAX package the two segments
travel as separate tensors and meet only inside the attention core.

Module and parameter names follow the reference's torchscale state dict
(``text_embed``, ``vision_embed``, ``encoder.embed_positions.A``,
``encoder.layers.N.self_attn.q_proj.A``, ...), so a converted checkpoint
loads with ``strict=True``.

Ported: the main path of the flagship; vision-token pruning
(``token_prune_keep``), the serving lever that keeps the top-K patch
tokens by the CLS query's attention after one layer; int8 w8a8 on the 12
multiway ``Linear``s of each layer (``quant``, ``ops/quant.py``); and
activation checkpointing of each layer (``remat``, ``remat_policy``); and
``seq_parallel``, the residual stream sharded over the sequence between
the blocks when a tensor-parallel layout sets ``seq_mesh``
(``parallel/mesh.py``); the vision-only and text-only encodes (an empty
other segment) and an additive ``attn_bias``, which the BEiT-3 task heads
use (``models/beit3_heads.py``).  Left out: ``scan_layers`` (a JAX compile
device).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from simvg_tpu_torch.ops.attention import cls_attention, multihead_attention
from .layers import LayerNorm, Linear, Stochastic, keep_mask


@dataclasses.dataclass(frozen=True)
class BEiT3Config:
    img_size: int = 640
    patch_size: int = 32
    in_chans: int = 3
    vocab_size: int = 64010
    embed_dim: int = 768
    num_heads: int = 12
    ffn_dim: int = 3072
    num_layers: int = 12
    max_source_positions: int = 1024
    drop_path_rate: float = 0.1
    attention_dropout: float = 0.0
    layernorm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32  # compute dtype; params stay fp32
    attn_impl: str = "xla"  # "xla" (plain torch) | "pallas" (Hopper kernel)
    # vision-token pruning for token-branch serving: after layer
    # token_prune_layer keep the token_prune_keep patch tokens the CLS
    # query attends to most (None: off).  Outside the measured envelope
    # (layer >= round(L/3), keep >= 75% of the patches) it raises unless
    # token_prune_force
    token_prune_keep: Optional[int] = None
    token_prune_layer: int = 4
    token_prune_force: bool = False
    # int8 w8a8 of the layers' Linears: "none" | "int8" (dynamic) |
    # "int8_calib" | "int8_static" | "int8_qat" (ops/quant.py); every mode
    # but "none" and "int8_qat" is serving-only
    quant: str = "none"
    # activation checkpointing of each layer when gradients are on:
    # "full" saves the layer's inputs only, "dots" also the outputs of its
    # parameter matmuls (JAX's dots_with_no_batch_dims_saveable)
    remat: bool = False
    remat_policy: str = "full"
    # shard the residual stream over the sequence on the model axis of a
    # tensor-parallel layout (a no-op on one device)
    seq_parallel: bool = False

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def seq_vision(self) -> int:
        """CLS + patch tokens = the multiway split position."""
        return self.num_patches + 1

    @classmethod
    def base(cls, **kw) -> "BEiT3Config":
        return cls(embed_dim=768, num_heads=12, ffn_dim=3072, num_layers=12,
                   **kw)

    @classmethod
    def large(cls, **kw) -> "BEiT3Config":
        return cls(embed_dim=1024, num_heads=16, ffn_dim=4096, num_layers=24,
                   **kw)


class Multiway(nn.Module):
    """Two parameter sets: ``A`` for the vision segment, ``B`` for the
    text segment; forward maps the (vision, text) pair."""

    def __init__(self, a: nn.Module, b: nn.Module):
        super().__init__()
        self.A = a
        self.B = b

    def forward(self, xs):
        return self.A(xs[0]), self.B(xs[1])


def _multiway(make) -> Multiway:
    return Multiway(make(), make())


def _dense(cfg: BEiT3Config, d_in: int, d_out: int) -> Linear:
    """The layers' Linear: ``Int8Linear`` in the int8 modes."""
    if cfg.quant == "none":
        return Linear(d_in, d_out, cfg.dtype)
    from simvg_tpu_torch.ops.quant import MODES, Int8Linear

    return Int8Linear(d_in, d_out, cfg.dtype, mode=MODES[cfg.quant])


def _gelu(h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Exact (erf) GELU in float32, cast back to the compute dtype."""
    return F.gelu(h.float()).to(dtype)


class _FFNWay(nn.Module):
    def __init__(self, cfg: BEiT3Config):
        super().__init__()
        self.fc1 = _dense(cfg, cfg.embed_dim, cfg.ffn_dim)
        self.fc2 = _dense(cfg, cfg.ffn_dim, cfg.embed_dim)
        self.ffn_layernorm = LayerNorm(cfg.ffn_dim, eps=cfg.layernorm_eps)
        self.dtype = cfg.dtype

    def forward(self, h):
        return self.fc2(self.ffn_layernorm(_gelu(self.fc1(h), self.dtype)))


class MultiwayFFN(Multiway):
    """fc1 -> exact GELU -> ffn_layernorm -> fc2, one set per modality."""

    def __init__(self, cfg: BEiT3Config):
        super().__init__(_FFNWay(cfg), _FFNWay(cfg))


class MultiwayAttention(nn.Module):
    """torchscale MultiheadAttention with multiway q/k/v/out projections
    and the subln ``inner_attn_ln``.  The joint sequence exists only for
    the attention core: q/k/v are concatenated once, the output split
    once."""

    def __init__(self, cfg: BEiT3Config):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, _multiway(lambda: _dense(cfg, d, d)))
        self.inner_attn_ln = _multiway(
            lambda: LayerNorm(d, eps=cfg.layernorm_eps))

    def forward(self, xs, key_padding_mask, return_cls_attn: bool = False,
                attn_bias=None):
        """With ``return_cls_attn`` also returns the CLS query's attention
        over the joint sequence, float32 [B, S] averaged over heads (the
        token-pruning score); the attention output still comes from
        ``multihead_attention`` (K1 with ``attn_impl="pallas"``, unless an
        additive ``attn_bias`` [S, S] sends it to the plain path)."""
        cfg = self.cfg
        split = xs[0].shape[1]

        def proj(m):
            return torch.cat(m(xs), dim=1)

        q, k = proj(self.q_proj), proj(self.k_proj)
        # this rank's heads: all of them, or num_heads / model_parallel of
        # them under tensor parallelism (column-parallel q/k/v)
        heads = q.shape[-1] * cfg.num_heads // cfg.embed_dim
        out = multihead_attention(
            q, k, proj(self.v_proj),
            num_heads=heads,
            key_padding_mask=key_padding_mask,
            attn_bias=attn_bias,
            dropout_rate=cfg.attention_dropout,
            deterministic=not self.training,
            dtype=cfg.dtype,
            impl=cfg.attn_impl,
        )
        out = self.out_proj(
            self.inner_attn_ln((out[:, :split], out[:, split:])))
        if not return_cls_attn:
            return out
        cls = cls_attention(q, k, num_heads=heads,
                            key_padding_mask=key_padding_mask,
                            dtype=cfg.dtype)
        if heads != cfg.num_heads:
            # tensor parallelism: the mean over this rank's heads, summed
            # over the model group into the mean over every head, so that
            # every rank keeps the same tokens
            cls = cls.detach() * heads
            mesh = self.q_proj.A.weight.device_mesh
            dist.all_reduce(cls, group=mesh.get_group("model"))
            cls = cls / cfg.num_heads
        return out, cls


class DropPath(Stochastic):
    """Per-sample stochastic depth on a residual branch, with ONE mask per
    sample for both segments, as the reference draws it over the whole
    joint sequence.  Identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, xs):
        if not self.training or self.rate == 0.0:
            return xs
        keep = 1.0 - self.rate
        mask = keep_mask((xs[0].shape[0], 1, 1), keep, self.generator,
                         xs[0].device).to(xs[0].dtype)
        return tuple(x / keep * mask for x in xs)


class EncoderLayer(nn.Module):
    """Pre-LN multiway transformer block on the (vision, text) pair.  The
    float32 LayerNorm outputs feed only Linears, which cast them to the
    compute dtype; the residual stream stays in the compute dtype."""

    def __init__(self, cfg: BEiT3Config, drop_path_rate: float):
        super().__init__()
        d, eps = cfg.embed_dim, cfg.layernorm_eps
        self.self_attn_layer_norm = _multiway(lambda: LayerNorm(d, eps=eps))
        self.self_attn = MultiwayAttention(cfg)
        self.final_layer_norm = _multiway(lambda: LayerNorm(d, eps=eps))
        self.ffn = MultiwayFFN(cfg)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, xs, key_padding_mask, return_cls_attn: bool = False,
                seq=None, attn_bias=None):
        """With ``seq`` (a ``SeqShard``) ``xs`` and the result are this
        rank's sequence shards, and each block takes the whole sequence
        after its LayerNorm."""
        gather = seq.gather if seq is not None else (lambda h: h)
        hs = self.self_attn(gather(self.self_attn_layer_norm(xs)),
                            key_padding_mask, return_cls_attn, attn_bias)
        if return_cls_attn:
            hs, cls_attn = hs
        hs = self.drop_path(hs)
        xs = (xs[0] + hs[0], xs[1] + hs[1])

        hs = self.drop_path(self.ffn(gather(self.final_layer_norm(xs))))
        out = xs[0] + hs[0], xs[1] + hs[1]
        return (out, cls_attn) if return_cls_attn else out


# the parameter matmuls of a layer (torch.nn.functional.linear reaches
# these, with or without the batch flattened); attention's products
# carry a batch dimension and are recomputed, as in JAX's policy
_PARAM_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_param_matmuls(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _PARAM_MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_layer(layer: nn.Module, xs, pad, policy: str = "full",
                seq=None, attn_bias=None):
    """``layer(xs, pad)`` under activation checkpointing
    (``torch.utils.checkpoint``, non-reentrant): ``"full"`` keeps the
    layer's inputs only, ``"dots"`` also its parameter matmuls' outputs.

    The recompute replays the forward's draws: checkpoint restores only
    torch's default generators, and the layer's dropout and drop-path draw
    from the explicit generator of its ``Stochastic`` modules, whose state
    is saved here before the forward and set again for the recompute (and
    put back after it), so the recomputed masks are the forward's."""
    gens = list({id(m.generator): m.generator for m in layer.modules()
                 if isinstance(m, Stochastic)
                 and m.generator is not None}.values())
    saved = [g.get_state() for g in gens]
    replay = []

    def run(xs, pad):
        if not replay:  # the forward
            replay.append(True)
            return layer(xs, pad, seq=seq, attn_bias=attn_bias)
        now = [g.get_state() for g in gens]
        for g, state in zip(gens, saved):
            g.set_state(state)
        try:
            return layer(xs, pad, seq=seq, attn_bias=attn_bias)
        finally:
            for g, state in zip(gens, now):
                g.set_state(state)

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_param_matmuls)
    return checkpoint(run, xs, pad, use_reentrant=False, **kw)


class VisionEmbedding(nn.Module):
    """Conv patchify + CLS prepend.  Takes an NHWC batch, viewed once as
    NCHW for ``Conv2d``."""

    def __init__(self, cfg: BEiT3Config):
        super().__init__()
        d = cfg.embed_dim
        self.dtype = cfg.dtype
        self.proj = nn.Conv2d(cfg.in_chans, d, cfg.patch_size,
                              stride=cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        # in BEiT-3 checkpoints (contain_mask_token=True); unused for REC
        self.mask_token = nn.Parameter(torch.zeros(1, 1, d))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = F.conv2d(images.to(dt).permute(0, 3, 1, 2),
                     self.proj.weight.to(dt), self.proj.bias.to(dt),
                     stride=self.proj.stride)
        x = x.flatten(2).transpose(1, 2)  # [B, h*w, D], row-major grid
        cls = self.cls_token.to(dt).expand(x.shape[0], 1, x.shape[2])
        return torch.cat([cls, x], dim=1)


class _EncoderStack(nn.Module):
    """torchscale ``Encoder``: positions, layers, final multiway LN."""

    def __init__(self, cfg: BEiT3Config):
        super().__init__()
        d = cfg.embed_dim
        self.embed_positions = Multiway(
            nn.Embedding(cfg.seq_vision + 2, d),
            nn.Embedding(cfg.max_source_positions, d))
        dpr = np.linspace(0.0, cfg.drop_path_rate, cfg.num_layers)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, float(r)) for r in dpr)
        self.layer_norm = _multiway(
            lambda: LayerNorm(d, eps=cfg.layernorm_eps))


def prune_layer_of(cfg: BEiT3Config) -> Optional[int]:
    """The layer after which token pruning runs, None when it is off;
    raises on a configuration that the JAX encoder refuses
    (``simvg_tpu/models/beit3.py:598-639``): keep outside (0, patches],
    an explicit layer past L-2 (the default 4 clamps to L-2 on a shallow
    model), or a point outside the measured envelope without
    ``token_prune_force``."""
    keep = cfg.token_prune_keep
    if keep is None:
        return None
    split, layers = cfg.seq_vision, cfg.num_layers
    if not 0 < keep < split:
        raise ValueError(f"token_prune_keep={keep} must be in [1, "
                         f"{split - 1}] (the patch tokens)")
    layer = cfg.token_prune_layer
    if layer > layers - 2:
        if layer != 4:  # only the default moves on a shallow model
            raise ValueError(
                f"token_prune_layer={layer} out of range for num_layers="
                f"{layers} (last prunable layer is {layers - 2})")
        layer = layers - 2
    if layer < 0:
        raise ValueError(f"token_prune_layer={cfg.token_prune_layer} with "
                         f"num_layers={layers}: no layer to prune after")
    if not cfg.token_prune_force:
        min_layer = max(1, round(layers / 3))
        min_keep = int(math.ceil(0.75 * (split - 1)))
        if layer < min_layer or keep < min_keep:
            raise ValueError(
                f"token_prune_keep={keep} at token_prune_layer={layer} is "
                f"outside the measured-safe envelope (prune at layer >= "
                f"{min_layer} = num_layers/3 and keep >= {min_keep} = 75% "
                f"of {split - 1} patch tokens).  Set token_prune_force=True "
                "to run anyway (validate accuracy on real weights first).")
    return layer


def stable_top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [B, k] of the k largest scores of each row, the lower index
    first among equal scores (``jax.lax.top_k``'s order; ``torch.topk``
    promises none), then sorted ascending."""
    order = torch.sort(-scores, dim=1, stable=True).indices[:, :k]
    return torch.sort(order, dim=1).values


class BEiT3Encoder(nn.Module):
    """The joint vision-language encoder.

    forward(images NHWC, text_ids [B, T], text_padding_mask [B, T] with
    1 = padded) -> (img_feat [B, P, D], text_feat [B, T, D], cls_feat
    [B, D]), all float32 (the final LayerNorms compute in float32).  With
    token pruning P is ``token_prune_keep``, and ``return_prune_idx`` adds
    the kept patches' [B, K] indices in the original grid (None when
    pruning is off).

    ``text_ids=None`` gives a vision-only encode and ``images=None`` a
    text-only one: the same layers run with an empty other segment, and
    the absent modality's outputs are None.  ``attn_bias`` is an additive
    [S, S] mask over the joint sequence (captioning's uni-directional
    mask); it takes the plain attention path.
    """

    def __init__(self, cfg: BEiT3Config, text: bool = True):
        """``text=False`` builds no text embedding, text positions or final
        text LayerNorm, as JAX's ``init`` of a vision-only encode makes
        none (the classification head's encoder); such an encoder refuses
        ``text_ids``."""
        super().__init__()
        if cfg.quant not in ("none", "int8", "int8_calib", "int8_static",
                             "int8_qat"):
            raise ValueError(f"unknown quant mode {cfg.quant!r}")
        if cfg.remat_policy not in ("full", "dots"):
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
        self.cfg = cfg
        self.prune_layer = prune_layer_of(cfg)
        # the model axis of a sequence-parallel layout (parallel/mesh.py
        # shard_model), None otherwise
        self.seq_mesh = None
        self.text_embed = (nn.Embedding(cfg.vocab_size, cfg.embed_dim)
                           if text else None)
        self.vision_embed = VisionEmbedding(cfg)
        self.encoder = _EncoderStack(cfg)
        if not text:
            self.encoder.embed_positions.B = None
            self.encoder.layer_norm.B = None

    def forward(self, images=None, text_ids=None, text_padding_mask=None,
                return_prune_idx: bool = False, attn_bias=None):
        cfg, dt = self.cfg, self.cfg.dtype
        if images is None and text_ids is None:
            raise ValueError("the encoder needs images, text_ids or both")
        if text_ids is not None and self.text_embed is None:
            raise ValueError("this encoder was built without text "
                             "parameters (text=False)")
        if self.training and cfg.quant not in ("none", "int8_qat"):
            # ValueError, not assert: int8 rounding has no gradient, so a
            # train step in a serving mode would silently kill the
            # encoder's gradients
            raise ValueError(
                f"quant={cfg.quant!r} is serving-only; train with "
                "quant='int8_qat' (STE) and serve with int8_static")
        if self.prune_layer is not None and (images is None
                                             or attn_bias is not None):
            raise ValueError("token_prune_keep needs vision input and no "
                             "attn_bias")
        remat = cfg.remat and torch.is_grad_enabled()
        pos = self.encoder.embed_positions
        if images is not None:
            x_vis = self.vision_embed(images)
            b, split = x_vis.shape[:2]
            if split != cfg.seq_vision:
                raise ValueError(f"image gives {split} vision tokens, the "
                                 f"config {cfg.seq_vision}")
            # fairseq positions start at 2 (padding_idx + 1)
            x_vis = x_vis + pos.A.weight[2:split + 2].to(dt)
            dev = x_vis.device
        else:
            b, split, dev = text_ids.shape[0], 0, text_ids.device
            x_vis = torch.zeros(b, 0, cfg.embed_dim, dtype=dt, device=dev)

        if text_ids is not None:
            t = text_ids.shape[1]
            x_txt = self.text_embed.weight.to(dt)[text_ids] \
                + pos.B.weight[2:t + 2].to(dt)
            if text_padding_mask is None:
                pad_txt = torch.zeros(b, t, dtype=torch.bool, device=dev)
            else:
                pad_txt = text_padding_mask.to(torch.bool)
            # padded text positions are zeroed after embedding
            x_txt = x_txt * (1.0 - pad_txt.to(dt))[..., None]
        else:
            t = 0
            x_txt = torch.zeros(b, 0, cfg.embed_dim, dtype=dt, device=dev)
            pad_txt = torch.zeros(b, 0, dtype=torch.bool, device=dev)

        pad = torch.cat([torch.zeros(b, split, dtype=torch.bool, device=dev),
                         pad_txt], dim=1)
        xs = (x_vis.to(dt), x_txt.to(dt))
        seq = None
        if self.seq_mesh is not None:
            from simvg_tpu_torch.parallel.mesh import SeqShard

            seq = SeqShard(self.seq_mesh, (split, t))
            xs = seq.shard(xs)
        prune_idx = None
        # the joint and single-modality encodes call the layers as before
        bias = {} if attn_bias is None else {"attn_bias": attn_bias}
        for i, layer in enumerate(self.encoder.layers):
            if i != self.prune_layer:
                xs = (remat_layer(layer, xs, pad, cfg.remat_policy, seq,
                                  **bias)
                      if remat else layer(xs, pad, seq=seq, **bias))
                continue
            xs, cls_attn = layer(xs, pad, return_cls_attn=True, seq=seq)
            if seq is not None:  # the kept patches are picked whole
                xs = seq.gather(xs)
            # rank the patch tokens (positions 1..split-1) by the CLS
            # query's attention and keep the top K in spatial order
            keep = self.cfg.token_prune_keep
            prune_idx = stable_top_k(cls_attn[:, 1:split], keep)
            patches = torch.gather(
                xs[0][:, 1:], 1,
                prune_idx[..., None].expand(-1, -1, xs[0].shape[-1]))
            xs = (torch.cat([xs[0][:, :1], patches], dim=1), xs[1])
            split = 1 + keep
            pad = torch.cat([torch.zeros(b, split, dtype=torch.bool,
                                         device=dev), pad_txt], dim=1)
            if seq is not None:
                seq = SeqShard(self.seq_mesh, (split, t))
                xs = seq.shard(xs)

        ln = self.encoder.layer_norm
        x_vis = ln.A(xs[0])
        text_feat = None if text_ids is None else ln.B(xs[1])
        if seq is not None:
            x_vis, text_feat = seq.gather((x_vis, text_feat))
        img_feat = x_vis[:, 1:] if split else None
        cls_feat = x_vis[:, 0] if split else None
        if return_prune_idx:
            return img_feat, text_feat, cls_feat, prune_idx
        return img_feat, text_feat, cls_feat
