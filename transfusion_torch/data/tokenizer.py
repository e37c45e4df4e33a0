"""Host-side text tokenization, the WordPiece half (port of
``transfusion_tpu/data/tokenizer.py:1-200``; the GPT-2 BPE and SentencePiece
tokenizers come with their language towers).

The reference tokenizes narration strings on CPU through the
sentence-transformers tokenizer inside the model forward
(``modeling/narration_embeds/narr_pooling_layers.py:153-159``). In the TPU
build tokenization is a host-side data-pipeline step producing fixed-length
``input_ids``/``attention_mask`` arrays ahead of the jit boundary.

``WordPieceTokenizer`` is a self-contained implementation of BERT's basic +
wordpiece tokenization (lowercasing, accent stripping, punctuation splitting,
greedy longest-match-first subwords) that loads a standard ``vocab.txt``. For
fully-offline environments without any vocab file, ``hash_vocab_tokenizer``
builds a deterministic placeholder vocab so the stack stays runnable.
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass

import numpy as np


def load_vocab(path: str) -> dict[str, int]:
    vocab: dict[str, int] = {}
    with open(path, encoding="utf-8") as fp:
        for idx, line in enumerate(fp):
            vocab[line.rstrip("\n")] = idx
    return vocab


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _basic_tokenize(text: str, lowercase: bool = True) -> list[str]:
    if lowercase:
        text = text.lower()
        text = unicodedata.normalize("NFD", text)
        text = "".join(ch for ch in text if unicodedata.category(ch) != "Mn")
    tokens: list[str] = []
    current = []
    for ch in text:
        if ch.isspace():
            if current:
                tokens.append("".join(current))
                current = []
        elif _is_punctuation(ch):
            if current:
                tokens.append("".join(current))
                current = []
            tokens.append(ch)
        else:
            current.append(ch)
    if current:
        tokens.append("".join(current))
    return tokens


@dataclass
class WordPieceTokenizer:
    vocab: dict[str, int]
    max_length: int = 128
    unk_token: str = "[UNK]"
    cls_token: str = "[CLS]"
    sep_token: str = "[SEP]"
    pad_token: str = "[PAD]"
    lowercase: bool = True
    max_chars_per_word: int = 100

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        return cls(load_vocab(path), **kw)

    def _wordpiece(self, word: str) -> list[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out = []
        for word in _basic_tokenize(text, self.lowercase):
            out.extend(self._wordpiece(word))
        return out

    def encode_batch(self, texts: list[str], max_length: int | None = None):
        """Returns (input_ids, attention_mask) int32 arrays [B, L], padded to
        ``max_length`` (static shape for the jit boundary)."""
        ml = max_length or self.max_length
        cls_id = self.vocab[self.cls_token]
        sep_id = self.vocab[self.sep_token]
        pad_id = self.vocab[self.pad_token]
        unk_id = self.vocab[self.unk_token]

        ids = np.full((len(texts), ml), pad_id, np.int32)
        mask = np.zeros((len(texts), ml), np.int32)
        for i, text in enumerate(texts):
            toks = [self.vocab.get(t, unk_id) for t in self.tokenize(text)][: ml - 2]
            seq = [cls_id] + toks + [sep_id]
            ids[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1
        return ids, mask

    def encode_batch_with_types(self, texts: list[str], type_names, max_length: int | None = None):
        """encode_batch plus inline ``word<t1,t2>`` type markers (SBertLayer,
        narr_pooling_layers.py:119-186): markers are stripped before
        tokenization; every wordpiece of the marked word gets its types set in
        the returned [B, L, T] bool mask. A marker after trailing punctuation
        ('bed,<t>') applies to the word, not the punctuation — matched by
        applying types to the first basic token of the space-split chunk."""
        ml = max_length or self.max_length
        cls_id = self.vocab[self.cls_token]
        sep_id = self.vocab[self.sep_token]
        pad_id = self.vocab[self.pad_token]
        unk_id = self.vocab[self.unk_token]
        t_index = {n: i for i, n in enumerate(type_names)}

        ids = np.full((len(texts), ml), pad_id, np.int32)
        mask = np.zeros((len(texts), ml), np.int32)
        tmask = np.zeros((len(texts), ml, len(type_names)), bool)
        for i, text in enumerate(texts):
            seq = [cls_id]
            spans: list[tuple[int, int, list[int]]] = []
            for chunk in text.split(" "):
                types: list[int] = []
                if "<" in chunk and ">" in chunk:
                    raw = chunk[chunk.index("<") + 1 : chunk.index(">")]
                    types = [t_index[t.strip()] for t in raw.split(",") if t.strip() in t_index]
                    chunk = chunk[: chunk.index("<")]
                for w_i, word in enumerate(_basic_tokenize(chunk, self.lowercase)):
                    pieces = self._wordpiece(word)
                    start = len(seq)
                    seq.extend(self.vocab.get(p, unk_id) for p in pieces)
                    if types and w_i == 0:
                        spans.append((start, len(seq), types))
            seq = seq[: ml - 1] + [sep_id]
            ids[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1
            for start, end, types in spans:
                for t in types:
                    tmask[i, start : min(end, ml - 1), t] = True
        return ids, mask, tmask


def hash_vocab_tokenizer(vocab_size: int = 30522, max_length: int = 128) -> WordPieceTokenizer:
    """Deterministic placeholder tokenizer for environments with no vocab file.

    Words map to stable pseudo-ids via a hash; specials occupy BERT's usual
    slots. NOT compatible with pretrained checkpoints — testing/bring-up only.
    """

    class _HashVocab(dict):
        def __init__(self):
            super().__init__(
                {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102, "[MASK]": 103}
            )

        def __contains__(self, key):
            return dict.__contains__(self, key) or not key.startswith("##")

        def get(self, key, default=None):
            if dict.__contains__(self, key):
                return dict.get(self, key)
            h = 2166136261
            for ch in key.encode():
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            return 999 + h % (vocab_size - 1000)

        def __getitem__(self, key):
            v = self.get(key)
            if v is None:
                raise KeyError(key)
            return v

    tok = WordPieceTokenizer(_HashVocab(), max_length=max_length)
    tok.is_hash_fallback = True
    return tok

