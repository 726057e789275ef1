"""The legacy language encoders of the OneStageModel family (port of
``simvg_tpu/models/lan_encs.py``): a (bi)GRU over word embeddings, and
HF BERT.

JAX's recurrence (a ``lax.scan``) has the gates r, z, n in that order
with n = tanh(i_n + r * (h W_hn + b_hn)), which is torch's ``nn.GRU``
cell, so ``nn.GRU`` carries it.  It runs over the padded sequence with no
packing, as JAX does, so the reverse direction starts at the last padded
position.  ``convert.py`` transposes JAX's ``ih`` and ``hh`` kernels of
``gru_fwd``/``gru_bwd`` into ``weight_ih_l0``/``weight_hh_l0`` (and their
``_reverse``).

``BERTLanguageEncoder`` is the ``ALBERTA`` type: HF BERT/roberta's post-LN
layout under JAX's names (``word_embeddings``, ``q_i``, ``attn_ln_i``, ...),
which ``convert.convert_hf_bert`` fills from an HF state dict.

Not ported: the JAX GRU encoder's pretrained ``word_emb`` table (GloVe),
which no config sets: the word embedding starts from N(0, 0.02).
"""

from __future__ import annotations

import warnings

import torch
import torch.nn as nn
import torch.nn.functional as F

from simvg_tpu_torch.ops.attention import multihead_attention
from .layers import LayerNorm, Linear


class PhraseAttention(nn.Module):
    """Softmax attention over word positions, re-normalised after zeroing
    the padding; returns (weights [B, T], weighted embedding [B, C])."""

    def __init__(self, input_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = Linear(input_dim, 1, dtype)

    def forward(self, context, embedded, input_labels):
        scores = self.fc(context)[..., 0]
        attn = torch.softmax(scores.to(torch.promote_types(
            scores.dtype, torch.float32)), dim=-1)
        attn = attn * (input_labels != 0).to(attn.dtype)
        attn = attn / attn.sum(dim=1, keepdim=True).clamp_min(1e-12)
        weighted = torch.einsum("bt,btc->bc", attn.to(embedded.dtype),
                                embedded)
        return attn, weighted


class LSTMLanguageEncoder(nn.Module):
    """The reference's ``LSTM`` language encoder (whose cell is a GRU):
    word embeddings (frozen by default: no gradient reaches them), a
    (bi)GRU, then one of five outputs: "mean", "max", "default" (the last
    state of each direction), "query" (``num_query_parsers`` phrase
    attentions and a projection to ``out_dim``), each [B, N, C], or
    "original", every step's state with the padding mask."""

    def __init__(self, vocab_size: int, word_emb_dim: int = 300,
                 hidden_size: int = 512, bidirectional: bool = True,
                 output_type: str = "max", freeze_emb: bool = True,
                 out_dim: int = 256, num_query_parsers: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if output_type not in ("mean", "max", "default", "query",
                               "original"):
            raise ValueError(output_type)
        self.output_type = output_type
        self.bidirectional = bidirectional
        self.freeze_emb = freeze_emb
        self.dtype = dtype
        self.embedding = nn.Embedding(vocab_size, word_emb_dim)
        self.gru = nn.GRU(word_emb_dim, hidden_size, batch_first=True,
                          bidirectional=bidirectional)
        self.gru.flatten_parameters()  # cuDNN's one weight buffer
        self.hidden_size = hidden_size
        width = 2 * hidden_size if bidirectional else hidden_size
        if output_type == "query":
            for i in range(num_query_parsers):
                self.add_module(f"parser_{i}", PhraseAttention(width, dtype))
            self.linear = Linear(width, out_dim, dtype)
            width = out_dim
        self.num_query_parsers = num_query_parsers
        self.out_channels = width

    def _run_gru(self, x: torch.Tensor) -> torch.Tensor:
        """Every step's state [B, T, H or 2H] (forward, then backward);
        float32 weights run in ``dtype`` as JAX's ``param_dtype``/
        ``dtype`` split does."""
        if self.gru.weight_ih_l0.dtype == self.dtype:
            return self.gru(x)[0]
        cast = {k: v.to(self.dtype) for k, v in self.gru.named_parameters()}
        with warnings.catch_warnings():
            # the cast weights are new tensors each call, so cuDNN packs
            # them each call (3.7M values at the widest), as it warns
            warnings.filterwarnings("ignore", "RNN module weights")
            return torch.func.functional_call(self.gru, cast, (x,))[0]

    def forward(self, ref_expr_inds: torch.Tensor):
        y_mask = ref_expr_inds.abs() == 0  # True = padding
        y_word = self.embedding.weight.to(self.dtype)[ref_expr_inds]
        if self.freeze_emb:
            y_word = y_word.detach()
        y_word = self._run_gru(y_word)

        valid = (~y_mask)[..., None]
        if self.output_type == "mean":
            return ((y_word * valid).sum(1)
                    / valid.sum(1).clamp_min(1))[:, None]
        if self.output_type == "max":
            return y_word.masked_fill(~valid, -1e30).amax(dim=1)[:, None]
        if self.output_type == "default":
            # each direction's final state: the forward scan's last step,
            # the backward scan's first position
            h = y_word[:, -1, :self.hidden_size]
            if self.bidirectional:
                h = torch.cat([h, y_word[:, 0, self.hidden_size:]], dim=-1)
            return h[:, None]
        if self.output_type == "query":
            parsed = [getattr(self, f"parser_{i}")(y_word, y_word,
                                                   ref_expr_inds)[1]
                      for i in range(self.num_query_parsers)]
            return self.linear(torch.stack(parsed, dim=1))
        return {"text_feat": y_word, "text_mask": y_mask}


class BERTLanguageEncoder(nn.Module):
    """The ``ALBERTA`` language encoder: HF BERT/roberta's post-LN layout
    (residual add, then LayerNorm with epsilon 1e-12; exact GELU).  Word
    plus position embeddings (positions from ``position_offset``: 2 for
    roberta, 0 for BERT; HF's token-type row 0 is folded into the position
    table by ``convert_hf_bert``), then per layer attention, ``o``,
    ``attn_ln``, ``fc1``, ``fc2``, ``ffn_ln``.  As in JAX, the padding is
    where the word id is 0 unless a mask is given."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 256,
                 num_layers: int = 3, num_heads: int = 8,
                 max_positions: int = 512, position_offset: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers, self.num_heads = num_layers, num_heads
        self.position_offset, self.dtype = position_offset, dtype
        d = hidden_size
        self.word_embeddings = nn.Embedding(vocab_size, d)
        self.position_embeddings = nn.Embedding(max_positions, d)
        self.embeddings_ln = LayerNorm(d, eps=1e-12)
        for i in range(num_layers):
            for name in ("q", "k", "v", "o"):
                self.add_module(f"{name}_{i}", Linear(d, d, dtype))
            self.add_module(f"attn_ln_{i}", LayerNorm(d, eps=1e-12))
            self.add_module(f"fc1_{i}", Linear(d, 4 * d, dtype))
            self.add_module(f"fc2_{i}", Linear(4 * d, d, dtype))
            self.add_module(f"ffn_ln_{i}", LayerNorm(d, eps=1e-12))
        self.out_channels = d

    def forward(self, ids: torch.Tensor, padding_mask=None):
        dt, m = self.dtype, self.get_submodule
        if padding_mask is None:
            padding_mask = ids == 0
        pos = torch.arange(ids.shape[1], device=ids.device) \
            + self.position_offset
        x = (F.embedding(ids, self.word_embeddings.weight).to(dt)
             + F.embedding(pos, self.position_embeddings.weight).to(dt))
        x = self.embeddings_ln(x).to(dt)
        for i in range(self.num_layers):
            a = multihead_attention(m(f"q_{i}")(x), m(f"k_{i}")(x),
                                    m(f"v_{i}")(x), num_heads=self.num_heads,
                                    key_padding_mask=padding_mask, dtype=dt)
            x = m(f"attn_ln_{i}")(x + m(f"o_{i}")(a)).to(dt)
            h = m(f"fc2_{i}")(F.gelu(m(f"fc1_{i}")(x)))
            x = m(f"ffn_ln_{i}")(x + h).to(dt)
        return {"text_feat": x, "text_mask": padding_mask.bool()}


def build_lan_enc(cfg: dict, dtype: torch.dtype = torch.float32
                  ) -> nn.Module:
    """The language encoder of a reference-style ``lan_enc`` dict: the
    ``LSTM``/``RNN`` types ("original" output unless the dict says) and
    ``ALBERTA``."""
    cfg = dict(cfg)
    typ = cfg.pop("type", "LSTM")
    if typ == "ALBERTA":
        return BERTLanguageEncoder(dtype=dtype, **cfg)
    if typ not in ("LSTM", "RNN"):
        raise KeyError(f"unknown lan_enc type {typ!r}")
    cfg.setdefault("output_type", "original")
    return LSTMLanguageEncoder(dtype=dtype, **cfg)
