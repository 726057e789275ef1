"""Expression tokenisation (a copy of ``simvg_tpu/data/tokenization.py``,
so the port imports nothing of the JAX package).

The reference supports four tokenizer modes (loading.py:264-273):
``beit3`` (XLM-Roberta sentencepiece, the one every shipped config uses),
``bert`` (HF BertTokenizer), ``default`` (dataset word vocab) and
``copus`` (legacy).  We expose the same modes behind one interface:

    tok = build_tokenizer("beit3", spm_path=...)   # HF XLM-R, needs asset
    tok = build_tokenizer("simple", vocab=...)     # asset-free fallback
    ids, padding_mask = tok.encode(expression, max_token)

Semantics of ``encode`` follow ``_load_expression_tokenize_beit3``
(loading.py:157-182): clean -> subword ids -> truncate to max_token-2 ->
[BOS] + ids + [EOS] -> pad with PAD to max_token; padding_mask has
1 = PAD (note the inverted convention vs HF attention_mask).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_PUNCT = re.compile(r"([.,'!?\"()*#:;])")


def clean_string(expression: str) -> str:
    """Lowercase, strip punctuation, dash/slash -> space
    (loading.py:14-19)."""
    return (
        _PUNCT.sub("", expression.lower())
        .replace("-", " ")
        .replace("/", " ")
    )


class _TokenizerBase:
    bos_id: int
    eos_id: int
    pad_id: int

    def tokenize_to_ids(self, text: str) -> Sequence[int]:
        raise NotImplementedError

    @property
    def vocab_size(self) -> int:
        raise NotImplementedError

    def encode(self, expression: str, max_token: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        expression = clean_string(expression)
        ids = list(self.tokenize_to_ids(expression))
        if len(ids) == 0:
            raise RuntimeError(
                "The text segment should contains at least one tokens!"
            )
        if len(ids) > max_token - 2:
            ids = ids[: max_token - 2]
        ids = [self.bos_id] + ids + [self.eos_id]
        n = len(ids)
        padding_mask = [0] * n + [1] * (max_token - n)
        ids = ids + [self.pad_id] * (max_token - n)
        return (np.asarray(ids, np.int32),
                np.asarray(padding_mask, np.int32))


class XLMRobertaTokenizerWrapper(_TokenizerBase):
    """The reference's beit3 tokenizer: XLM-R sentencepiece model
    (``beit3.spm``), special ids bos=0, pad=1, eos=2, unk=3."""

    def __init__(self, spm_path: str):
        try:
            from transformers import XLMRobertaTokenizer
        except Exception as e:  # pragma: no cover
            raise RuntimeError(
                "transformers XLMRobertaTokenizer unavailable"
            ) from e
        self.tok = XLMRobertaTokenizer(spm_path)
        self.bos_id = self.tok.bos_token_id
        self.eos_id = self.tok.eos_token_id
        self.pad_id = self.tok.pad_token_id

    def tokenize_to_ids(self, text: str):
        return self.tok.convert_tokens_to_ids(self.tok.tokenize(text))

    @property
    def vocab_size(self):
        return self.tok.vocab_size


class XLMRSentencePieceTokenizer(_TokenizerBase):
    """beit3 mode WITHOUT the sentencepiece dependency: pure-Python
    unigram inference (simvg_tpu_torch.data.spm) over a real ``.spm`` model,
    plus the HF XLM-R id convention the reference relies on
    (loading.py:157-182): <s>=0, <pad>=1, </s>=2, <unk>=3, sentencepiece
    ids shifted by the fairseq offset (+1)."""

    FAIRSEQ_OFFSET = 1

    def __init__(self, spm_path: str):
        from .spm import SentencePieceUnigram

        self.sp = SentencePieceUnigram.from_file(spm_path)
        self.bos_id, self.pad_id, self.eos_id, self.unk_id = 0, 1, 2, 3
        self._special = {"<s>": self.bos_id, "<pad>": self.pad_id,
                         "</s>": self.eos_id, "<unk>": self.unk_id}

    def tokenize_to_ids(self, text: str):
        out = []
        for sid in self.sp.encode_ids(text):
            piece = self.sp.pieces[sid][0]
            if piece in self._special:
                out.append(self._special[piece])
            elif sid == self.sp.unk_id:
                out.append(self.unk_id)
            else:
                out.append(sid + self.FAIRSEQ_OFFSET)
        return out

    @property
    def vocab_size(self):
        # HF XLMRobertaTokenizer: sp size + fairseq offset + <mask>
        return self.sp.vocab_size() + self.FAIRSEQ_OFFSET + 1


class HFTokenizerWrapper(_TokenizerBase):
    """"bert" mode (loading.py:126-155): any HF tokenizer by name/path."""

    def __init__(self, name_or_path: str):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(name_or_path)

        def _first(*ids, default):
            # explicit None checks: legitimate special-token ids can be
            # 0 (bert-base-uncased's [PAD] IS 0 — `or` would replace it)
            for i in ids:
                if i is not None:
                    return i
            return default

        self.bos_id = _first(self.tok.cls_token_id,
                             self.tok.bos_token_id, default=0)
        self.eos_id = _first(self.tok.sep_token_id,
                             self.tok.eos_token_id, default=2)
        self.pad_id = _first(self.tok.pad_token_id, default=1)

    def tokenize_to_ids(self, text: str):
        return self.tok.convert_tokens_to_ids(self.tok.tokenize(text))

    @property
    def vocab_size(self):
        return self.tok.vocab_size


class SimpleTokenizer(_TokenizerBase):
    """Asset-free whitespace tokenizer with XLM-R-compatible special ids.

    Used for tests/demos when no sentencepiece model is available.  Words
    map into [num_special, vocab_size) either via a provided vocabulary
    or a stable hash.
    """

    NUM_SPECIAL = 4  # bos, pad, eos, unk

    def __init__(self, vocab: Optional[Dict[str, int]] = None,
                 vocab_size: int = 64010):
        self.bos_id, self.pad_id, self.eos_id, self.unk_id = 0, 1, 2, 3
        self.vocab = vocab
        self._vocab_size = vocab_size

    def tokenize_to_ids(self, text: str):
        out = []
        for w in text.split():
            if self.vocab is not None:
                out.append(self.vocab.get(w, self.unk_id))
            else:
                h = 0
                for ch in w:  # deterministic, python-hash-seed-free
                    h = (h * 131 + ord(ch)) % (2 ** 31)
                out.append(
                    self.NUM_SPECIAL
                    + h % (self._vocab_size - self.NUM_SPECIAL)
                )
        return out

    @property
    def vocab_size(self):
        return self._vocab_size


def build_word_vocab(anns_all: dict) -> Dict[str, int]:
    """Word -> index vocabulary over every expression in the annotation
    file, for the legacy "default" mode. Exact reference layout
    (datasets/utils.py:150-175): PAD=0, UNK=1, CLS=2, then words in
    first-seen order over split -> annotation -> expression."""
    vocab = {"PAD": 0, "UNK": 1, "CLS": 2}
    for split in anns_all:
        for ann in anns_all[split]:
            for expr in ann.get("expressions", []):
                for w in clean_string(expr).split():
                    if w not in vocab:
                        vocab[w] = len(vocab)
    return vocab


def tokenize(annsfile: str, anns_all: dict, word_emb_cfg=None):
    """The reference's cached vocabulary builder
    (datasets/utils.py:137-199): writes/reads ``token_to_ix.pkl``,
    ``ix_to_token.pkl`` and ``word_emb.npz`` next to the annotation
    file. The GloVe vectors come from spacy's en_vectors_web_lg when
    installed; otherwise a deterministic random table is cached instead
    (and a warning logged), keeping the cache format identical.

    Returns (token2ix, ix2token, word_emb [V, 300])."""
    import os.path as osp
    import pickle

    annsdir = osp.dirname(osp.abspath(annsfile))
    t2i_path = osp.join(annsdir, "token_to_ix.pkl")
    i2t_path = osp.join(annsdir, "ix_to_token.pkl")
    emb_path = osp.join(annsdir, "word_emb.npz")
    if (osp.exists(t2i_path) and osp.exists(i2t_path)
            and osp.exists(emb_path)):
        with open(t2i_path, "rb") as f:
            token2ix = pickle.load(f)
        with open(i2t_path, "rb") as f:
            ix2token = pickle.load(f)
        npz = np.load(emb_path, allow_pickle=True)
        return token2ix, ix2token, npz["word_emb"]

    token2ix = build_word_vocab(anns_all)
    ix2token = {ix: tok for tok, ix in token2ix.items()}

    loader = None
    if word_emb_cfg and word_emb_cfg.get("type") == "GloVe":
        try:
            import en_vectors_web_lg  # type: ignore

            nlp = en_vectors_web_lg.load()
            loader = lambda w: np.asarray(nlp(w).vector, np.float32)
        except ImportError:
            import logging

            logging.getLogger("simvg_tpu_torch").warning(
                "spacy en_vectors_web_lg unavailable; caching a "
                "deterministic random word_emb.npz instead"
            )
    if loader is None:
        rng = np.random.default_rng(0)
        loader = lambda w: rng.normal(
            0, 0.02, 300).astype(np.float32)

    word_emb = np.stack([loader(ix2token[i])
                         for i in range(len(ix2token))])

    with open(t2i_path, "wb") as f:
        pickle.dump(token2ix, f, protocol=pickle.HIGHEST_PROTOCOL)
    with open(i2t_path, "wb") as f:
        pickle.dump(ix2token, f, protocol=pickle.HIGHEST_PROTOCOL)
    np.savez_compressed(emb_path, word_emb=word_emb)
    return token2ix, ix2token, word_emb


class WordTokenizer(_TokenizerBase):
    """"default" mode (loading.py:105-124): word->idx, zero-padded, no
    BOS/EOS.  encode() overridden because the framing differs."""

    def __init__(self, token2idx: Dict[str, int]):
        self.token2idx = token2idx
        self.pad_id = 0
        self.bos_id = self.eos_id = -1  # unused

    @property
    def vocab_size(self):
        return len(self.token2idx)

    def encode(self, expression: str, max_token: int):
        expression = clean_string(expression)
        ids = np.zeros(max_token, np.int32)
        mask = np.ones(max_token, np.int32)
        for i, w in enumerate(expression.split()):
            if i >= max_token:
                break
            ids[i] = self.token2idx.get(w, self.token2idx["UNK"])
            mask[i] = 0
        return ids, mask


class CorpusTokenizer(_TokenizerBase):
    """"copus" mode (loading.py:184-209, 347-356).

    The reference loads a pickled vgtr ``Corpus`` object from a
    hardcoded user path, and the ``Corpus`` class itself is absent from
    the repo (instantiating it raises NameError) — the mode is broken
    legacy upstream. This is a WORKING equivalent: a word->id table
    loaded from json/pickle (or passed directly), with the reference's
    framing: zero-padded word ids.  The returned mask follows THIS
    framework's uniform 1 = PAD convention (every downstream consumer —
    collate -> batch['text_padding_mask'] -> the encoders — treats
    nonzero as padded), i.e. mask = (ids == 0)."""

    def __init__(self, corpus=None, corpus_path: Optional[str] = None,
                 unk_token: str = "UNK"):
        if corpus is None:
            if corpus_path is None:
                raise ValueError("corpus or corpus_path required")
            if corpus_path.endswith(".json"):
                import json

                corpus = json.load(open(corpus_path))
            else:
                import pickle

                corpus = pickle.load(open(corpus_path, "rb"))
        self.word2idx = dict(corpus)
        self.unk_id = self.word2idx.get(unk_token, 1)
        self.pad_id = 0
        self.bos_id = self.eos_id = -1  # unused

    @property
    def vocab_size(self):
        return max(self.word2idx.values()) + 1

    def encode(self, expression: str, max_token: int):
        expression = clean_string(expression)
        ids = np.zeros(max_token, np.int32)
        for i, w in enumerate(expression.split()):
            if i >= max_token:
                break
            ids[i] = self.word2idx.get(w, self.unk_id)
        mask = (ids == 0).astype(np.int32)  # 1 = PAD, like every mode
        return ids, mask


def load_word_embeddings(path: str, token2idx: Dict[str, int],
                         dim: int = 300) -> np.ndarray:
    """Load a cached GloVe table (``word_emb.npz`` with an 'emb' array,
    the reference's vocabulary cache format, datasets/utils.py:137-199)
    or fall back to random-normal vectors when the asset is absent."""
    import os.path as osp

    if path and osp.exists(path):
        data = np.load(path)
        key = "emb" if "emb" in data else list(data.keys())[0]
        emb = np.asarray(data[key], np.float32)
        assert emb.shape[0] >= len(token2idx), (
            emb.shape, len(token2idx)
        )
        return emb[: len(token2idx)]
    rng = np.random.default_rng(0)
    return rng.normal(0, 0.02, (len(token2idx), dim)).astype(np.float32)


def build_tokenizer(kind: str = "beit3", **kw) -> _TokenizerBase:
    if kind == "beit3":
        spm = kw.get("spm_path")
        if spm:
            import os.path as osp

            if osp.exists(spm):
                # native pure-python unigram inference (no sentencepiece
                # dependency); loads the released beit3.spm directly
                return XLMRSentencePieceTokenizer(spm)
        # asset-free fallback keeps the full pipeline runnable — but a
        # model TRAINED with the real beit3.spm gets hashed garbage ids
        # from it, so a missing/typo'd asset path must be loud
        import logging

        logging.getLogger("simvg_tpu_torch").warning(
            "beit3 tokenizer: sentencepiece model %r not found — "
            "falling back to the hash-based SimpleTokenizer. Fine for "
            "synthetic smoke runs; WRONG for any model trained with "
            "the real beit3.spm vocabulary.", spm)
        return SimpleTokenizer(vocab_size=kw.get("vocab_size", 64010))
    if kind == "bert":
        return HFTokenizerWrapper(kw.get("name_or_path",
                                         "bert-base-uncased"))
    if kind == "simple":
        return SimpleTokenizer(vocab=kw.get("vocab"),
                               vocab_size=kw.get("vocab_size", 64010))
    if kind == "default":
        return WordTokenizer(kw["token2idx"])
    if kind == "copus":
        return CorpusTokenizer(corpus=kw.get("corpus"),
                               corpus_path=kw.get("corpus_path"))
    raise ValueError(f"unknown tokenizer kind {kind!r}")
