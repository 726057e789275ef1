"""Pure-Python SentencePiece unigram inference (a copy of
``simvg_tpu/data/spm.py``).

The reference tokenizes expressions with
``XLMRobertaTokenizer("pretrain_weights/beit3.spm")``
(the reference's simvg/datasets/pipelines/loading.py:73,157-182), which
needs the ``sentencepiece`` C++ library. This module re-implements the
*inference* half natively so the framework has no sentencepiece
dependency:

- a minimal protobuf wire-format reader for the ``ModelProto`` layout
  (``pieces`` field 1: piece=1 string / score=2 float / type=3 enum) —
  it loads real ``.spm`` files, including the released ``beit3.spm``;
- Viterbi segmentation over the unigram lattice exactly as
  sentencepiece's encoder does it: NFKC normalisation, space -> U+2581
  with a dummy prefix, per-piece log scores, and unknown characters at
  ``min_score - 10`` (sentencepiece's kUnkPenalty);
- the XLM-R/HF id convention on top: <s>=0, <pad>=1, </s>=2, <unk>=3 and
  sentencepiece ids shifted by the fairseq offset (+1).

Only the unigram model type is supported (BPE .spm files raise).
"""

from __future__ import annotations

import struct
import unicodedata
from typing import Dict, List, Sequence, Tuple

_SPACE = "▁"  # ▁

# SentencePiece piece types (sentencepiece_model.proto)
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
UNUSED = 5
BYTE = 6


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _skip_field(buf: bytes, i: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, i = _read_varint(buf, i)
        return i
    if wire_type == 1:  # 64-bit
        return i + 8
    if wire_type == 2:  # length-delimited
        n, i = _read_varint(buf, i)
        return i + n
    if wire_type == 5:  # 32-bit
        return i + 4
    raise ValueError(f"unsupported protobuf wire type {wire_type}")


def parse_model_proto(data: bytes) -> List[Tuple[str, float, int]]:
    """Extract (piece, score, type) triplets from a serialized
    SentencePiece ModelProto. Unrecognised fields are skipped, so real
    .spm files (which carry trainer/normalizer specs) parse fine."""
    pieces: List[Tuple[str, float, int]] = []
    i, n = 0, len(data)
    while i < n:
        tag, i = _read_varint(data, i)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 2:  # repeated SentencePiece pieces
            ln, i = _read_varint(data, i)
            sub = data[i:i + ln]
            i += ln
            piece, score, ptype = "", 0.0, NORMAL
            j, m = 0, len(sub)
            while j < m:
                t2, j = _read_varint(sub, j)
                f2, w2 = t2 >> 3, t2 & 7
                if f2 == 1 and w2 == 2:
                    l2, j = _read_varint(sub, j)
                    piece = sub[j:j + l2].decode("utf-8")
                    j += l2
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", sub[j:j + 4])[0]
                    j += 4
                elif f2 == 3 and w2 == 0:
                    ptype, j = _read_varint(sub, j)
                else:
                    j = _skip_field(sub, j, w2)
            pieces.append((piece, score, ptype))
        else:
            i = _skip_field(data, i, wt)
    return pieces


def serialize_model_proto(
    pieces: Sequence[Tuple[str, float, int]]
) -> bytes:
    """Inverse of parse_model_proto — used to build .spm fixtures (the
    output is a real, sentencepiece-loadable ModelProto)."""
    out = bytearray()

    def varint(v: int) -> bytes:
        b = bytearray()
        while True:
            if v > 0x7F:
                b.append((v & 0x7F) | 0x80)
                v >>= 7
            else:
                b.append(v)
                return bytes(b)

    for piece, score, ptype in pieces:
        body = bytearray()
        pb = piece.encode("utf-8")
        body += b"\x0a" + varint(len(pb)) + pb          # field 1, wt 2
        body += b"\x15" + struct.pack("<f", score)      # field 2, wt 5
        body += b"\x18" + varint(ptype)                  # field 3, wt 0
        out += b"\x0a" + varint(len(body)) + bytes(body)
    return bytes(out)


class SentencePieceUnigram:
    """Unigram-model encoder over a parsed piece inventory."""

    UNK_PENALTY = 10.0

    def __init__(self, pieces: Sequence[Tuple[str, float, int]],
                 add_dummy_prefix: bool = True):
        self.pieces = list(pieces)
        self.add_dummy_prefix = add_dummy_prefix
        self.piece_to_id: Dict[str, int] = {}
        self.scores: Dict[str, float] = {}
        self.unk_id = 0
        self.max_piece_len = 1
        min_score = 0.0
        for idx, (piece, score, ptype) in enumerate(self.pieces):
            self.piece_to_id.setdefault(piece, idx)
            if ptype == UNKNOWN:
                self.unk_id = idx
            if ptype in (NORMAL, USER_DEFINED):
                self.scores[piece] = score
                self.max_piece_len = max(self.max_piece_len, len(piece))
                min_score = min(min_score, score)
        self.unk_score = min_score - self.UNK_PENALTY

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceUnigram":
        pieces = parse_model_proto(open(path, "rb").read())
        if not pieces:
            raise ValueError(f"{path}: no sentencepiece pieces found")
        return cls(pieces)

    def vocab_size(self) -> int:
        return len(self.pieces)

    def _normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        text = " ".join(text.split())  # nmt-style whitespace collapse
        text = text.replace(" ", _SPACE)
        if self.add_dummy_prefix and not text.startswith(_SPACE):
            text = _SPACE + text
        return text

    def encode_ids(self, text: str) -> List[int]:
        """Viterbi best segmentation -> sentencepiece piece ids."""
        s = self._normalize(text)
        n = len(s)
        if n == 0:
            return []
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Tuple[int, int]] = [(-1, -1)] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            top = min(self.max_piece_len, n - i)
            for ln in range(1, top + 1):
                sub = s[i:i + ln]
                sc = self.scores.get(sub)
                if sc is None:
                    continue
                cand = best[i] + sc
                if cand > best[i + ln]:
                    best[i + ln] = cand
                    back[i + ln] = (i, self.piece_to_id[sub])
            # unknown single character keeps the lattice connected
            cand = best[i] + self.unk_score
            if cand > best[i + 1]:
                best[i + 1] = cand
                back[i + 1] = (i, self.unk_id)
        ids: List[int] = []
        pos = n
        while pos > 0:
            prev, pid = back[pos]
            # sentencepiece merges a maximal run of unknown characters
            # into ONE <unk> piece; collapse consecutive unk ids so the
            # id sequence (and therefore length/truncation) matches.
            if not (pid == self.unk_id and ids
                    and ids[-1] == self.unk_id):
                ids.append(pid)
            pos = prev
        ids.reverse()
        return ids

    def encode_pieces(self, text: str) -> List[str]:
        return [self.pieces[i][0] for i in self.encode_ids(text)]
