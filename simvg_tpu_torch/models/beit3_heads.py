"""BEiT-3 task heads (port of ``simvg_tpu/models/beit3_heads.py``).

unilm's BEiT3For{ImageClassification, VisualQuestionAnswering,
VisualReasoning, Retrieval, Captioning} heads (the reference's vendored
modeling_finetune.py:57-276) over ``BEiT3Encoder``, which runs the joint,
vision-only and text-only encodes and captioning's additive mask that they
need.  No shipped SimVG config uses them.

With ``attn_impl="pallas"`` every head but captioning reaches K1 (and K2
on a backward) through ``fused_attention``; captioning's uni-directional
mask takes the plain path, as in the JAX package.  Greedy caption
generation re-runs the whole forward at each step, as JAX does.

Parameter names follow the JAX modules' (``beit3``, ``pooler``,
``head``, ``fc_norm``, ...), so ``convert.export_beit3_heads`` maps a flax
tree onto the port with ``strict=True``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .beit3 import BEiT3Config, BEiT3Encoder
from .layers import LayerNorm, Linear


def _ln(dim: int) -> LayerNorm:
    return LayerNorm(dim, eps=1e-5)


def _gelu(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.gelu(x.float()).to(dtype)


class TwoLayerMLP(nn.Module):
    """modeling_finetune.py:18-39."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, norm_input: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = _ln(in_features) if norm_input else None
        self.dense1 = Linear(in_features, hidden_features, dtype)
        self.norm2 = _ln(hidden_features)
        self.dense2 = Linear(hidden_features, out_features, dtype)

    def forward(self, x):
        if self.norm1 is not None:
            x = self.norm1(x).to(self.dtype)
        x = self.norm2(self.dense1(x)).to(self.dtype)
        return self.dense2(_gelu(x, self.dtype))


class Pooler(nn.Module):
    """CLS -> LN -> dense -> tanh (modeling_finetune.py:42-54)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = _ln(in_features)
        self.dense = Linear(in_features, out_features, dtype)

    def forward(self, cls_rep):
        x = self.dense(self.norm(cls_rep).to(self.dtype))
        return torch.tanh(x.float()).to(self.dtype)


class BEiT3ForImageClassification(nn.Module):
    """Vision-only encode -> mean of the patch tokens -> LN -> linear
    (modeling_finetune.py:106-131)."""

    def __init__(self, cfg: BEiT3Config, num_classes: int):
        super().__init__()
        # JAX's init of a vision-only encode makes no text parameters
        self.beit3 = BEiT3Encoder(cfg, text=False)
        self.fc_norm = _ln(cfg.embed_dim)
        self.head = Linear(cfg.embed_dim, num_classes)

    def forward(self, image):
        img_feat, _, _ = self.beit3(images=image)
        return self.head(self.fc_norm(img_feat.mean(dim=1)))


class BEiT3ForVisualQuestionAnswering(nn.Module):
    """Joint encode -> Pooler(CLS) -> 2-layer head
    (modeling_finetune.py:191-223)."""

    def __init__(self, cfg: BEiT3Config, num_classes: int):
        super().__init__()
        d, dt = cfg.embed_dim, cfg.dtype
        self.dtype = dt
        self.beit3 = BEiT3Encoder(cfg)
        self.pooler = Pooler(d, d, dt)
        self.head_dense1 = Linear(d, 2 * d, dt)
        self.head_norm = _ln(2 * d)
        self.head_dense2 = Linear(2 * d, num_classes)

    def forward(self, image, question_ids, padding_mask):
        _, _, cls_feat = self.beit3(images=image, text_ids=question_ids,
                                    text_padding_mask=padding_mask)
        h = self.head_dense1(self.pooler(cls_feat))
        h = _gelu(self.head_norm(h).to(self.dtype), self.dtype)
        return self.head_dense2(h)


class BEiT3ForVisualReasoning(nn.Module):
    """NLVR2: one shared encoder run on (image_a, text) and (image_b,
    text), the two CLS reps concatenated -> TwoLayerMLP
    (modeling_finetune.py:57-103)."""

    def __init__(self, cfg: BEiT3Config, num_classes: int = 2):
        super().__init__()
        d = cfg.embed_dim
        self.beit3 = BEiT3Encoder(cfg)
        self.head = TwoLayerMLP(2 * d, 2 * d, num_classes, dtype=cfg.dtype)

    def forward(self, image_a, image_b, text_ids, padding_mask):
        _, _, cls_a = self.beit3(images=image_a, text_ids=text_ids,
                                 text_padding_mask=padding_mask)
        _, _, cls_b = self.beit3(images=image_b, text_ids=text_ids,
                                 text_padding_mask=padding_mask)
        return self.head(torch.cat([cls_a, cls_b], dim=-1))


class BEiT3ForRetrieval(nn.Module):
    """Single-modality encodes -> normalised CLS heads and the logit scale
    (modeling_finetune.py:226-276).  Returns (vision_cls, language_cls,
    logit_scale); an absent input's output is None."""

    def __init__(self, cfg: BEiT3Config):
        super().__init__()
        d = cfg.embed_dim
        self.beit3 = BEiT3Encoder(cfg)
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(1.0 / 0.07), dtype=torch.float32))
        self.vision_head = Linear(d, d, cfg.dtype, bias=False)
        self.language_head = Linear(d, d, cfg.dtype, bias=False)

    def forward(self, image=None, text_ids=None, padding_mask=None):
        vision_cls = language_cls = None
        if image is not None:
            _, _, cls_feat = self.beit3(images=image)
            v = self.vision_head(cls_feat)
            vision_cls = v / torch.linalg.norm(v.float(), dim=-1,
                                               keepdim=True)
        if text_ids is not None:
            _, text_feat, _ = self.beit3(text_ids=text_ids,
                                         text_padding_mask=padding_mask)
            t = self.language_head(text_feat[:, 0, :])
            language_cls = t / torch.linalg.norm(t.float(), dim=-1,
                                                 keepdim=True)
        return vision_cls, language_cls, self.logit_scale


def captioning_uni_mask(image_len: int, text_len: int,
                        device=None) -> torch.Tensor:
    """Additive float32 [S, S] attention mask (modeling_finetune.py:
    148-158): image<->image full, caption->image full, caption->caption
    causal, image->caption blocked; 0 where allowed, -inf where masked."""
    s = image_len + text_len
    allowed = torch.zeros(s, s, dtype=torch.bool, device=device)
    allowed[:, :image_len] = True
    allowed[image_len:, image_len:] = torch.ones(
        text_len, text_len, dtype=torch.bool, device=device).tril()
    return torch.zeros(s, s, device=device).masked_fill(~allowed,
                                                        float("-inf"))


class BEiT3ForCaptioning(nn.Module):
    """Uni-masked joint encode -> MLM head over the text positions
    (modeling_finetune.py:133-188)."""

    def __init__(self, cfg: BEiT3Config):
        super().__init__()
        self.cfg = cfg
        self.beit3 = BEiT3Encoder(cfg)
        self.mlm_head = Linear(cfg.embed_dim, cfg.vocab_size)

    def forward(self, image, text_ids, padding_mask):
        bias = captioning_uni_mask(self.cfg.seq_vision, text_ids.shape[1],
                                   text_ids.device)
        _, text_feat, _ = self.beit3(images=image, text_ids=text_ids,
                                     text_padding_mask=padding_mask,
                                     attn_bias=bias)
        return self.mlm_head(text_feat)

    @torch.no_grad()
    def greedy_generate(self, image, bos_id: int, eos_id: int,
                        max_len: int = 20, pad_id: int = 1) -> torch.Tensor:
        """Greedy caption decode, re-running the whole forward at each step
        on a fixed [B, max_len] sequence; int64 ids."""
        b, dev = image.shape[0], image.device
        ids = torch.full((b, max_len), pad_id, dtype=torch.long, device=dev)
        ids[:, 0] = bos_id
        mask = torch.ones(b, max_len, dtype=torch.long, device=dev)
        mask[:, 0] = 0
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        for t in range(1, max_len):
            logits = self(image, ids, mask)
            nxt = logits[:, t - 1, :].argmax(dim=-1)
            nxt = torch.where(done, pad_id, nxt)
            ids[:, t] = nxt
            mask[:, t] = done.long()
            done = done | (nxt == eos_id)
        return ids
