"""Host-side text tokenization (port of ``transfusion_tpu/data/tokenizer.py``):
BERT WordPiece for the sbert towers, GPT-2 byte-level BPE for distilgpt2 and
SentencePiece unigram for the T5 towers, each with a deterministic hash
fallback. Pure Python and numpy: neither ``transformers`` nor
``sentencepiece`` is imported.

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

# ------------------------------------------------------------- GPT-2 byte BPE


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode map."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def gpt2_words(text: str) -> list[str]:
    """GPT-2's pre-tokenization regex
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``
    implemented as a scanner (stdlib ``re`` has no ``\\p{}`` classes)."""
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        matched = None
        for c in ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d"):
            if text.startswith(c, i):
                matched = c
                break
        if matched:
            out.append(matched)
            i += len(matched)
            continue
        sp = ""
        if text[i].isspace():
            j = i
            while j < n and text[j].isspace():
                j += 1
            if j == n:  # trailing run: \s+(?!\S) takes it all
                out.append(text[i:j])
                break
            # A run followed by a token: everything but the last char matches
            # \s+(?!\S); a final literal space attaches to the next token via
            # its ' ?' prefix, any other whitespace char stands alone.
            if j - 1 > i:
                out.append(text[i : j - 1])
            if text[j - 1] != " ":
                out.append(text[j - 1])
                i = j
                continue
            # fall through with the space as the next token's ' ?' prefix
            # (contractions never absorb a preceding space in the pattern)
            sp = " "
            i = j
        ch = text[i]
        if _is_letter(ch):
            j = i
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(ch):
            j = i
            while j < n and _is_number(text[j]):
                j += 1
        else:
            j = i
            while j < n and not (
                text[j].isspace() or _is_letter(text[j]) or _is_number(text[j])
            ):
                j += 1
        out.append(sp + text[i:j])
        i = j
    return out


class GPT2BPETokenizer:
    """Byte-level BPE matching huggingface GPT2Tokenizer given the same
    ``vocab.json`` + ``merges.txt``. The reference tokenizes through
    ``AutoTokenizer.from_pretrained(model_v)`` with ``pad_token = eos_token``
    (``narr_pooling_layers.py:270-272``); here tokenization is a host-side
    data step with fixed-length padded output for the jit boundary."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 max_length: int = 128, eos_token: str = "<|endoftext|>"):
        self.vocab = vocab
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.max_length = max_length
        self.eos_id = vocab[eos_token]
        self.pad_id = self.eos_id  # reference sets pad_token = eos_token
        self.byte_enc = bytes_to_unicode()
        self._cache: dict[str, list[str]] = {}

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str, **kw) -> "GPT2BPETokenizer":
        import json

        with open(vocab_json, encoding="utf-8") as fp:
            vocab = json.load(fp)
        merges = []
        with open(merges_txt, encoding="utf-8") as fp:
            for line in fp:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        while len(word) > 1:
            pairs = {(word[k], word[k + 1]) for k in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 30))
            if best not in self.ranks:
                break
            a, b = best
            merged, k = [], 0
            while k < len(word):
                if k < len(word) - 1 and word[k] == a and word[k + 1] == b:
                    merged.append(a + b)
                    k += 2
                else:
                    merged.append(word[k])
                    k += 1
            word = merged
        self._cache[token] = word
        return word

    def tokenize(self, text: str) -> list[str]:
        pieces = []
        for w in gpt2_words(text):
            mapped = "".join(self.byte_enc[b] for b in w.encode("utf-8"))
            pieces.extend(self._bpe(mapped))
        return pieces

    def encode(self, text: str) -> list[int]:
        return [self.vocab[t] for t in self.tokenize(text)]

    def encode_batch(self, texts: list[str], max_length: int | None = None):
        """(input_ids, attention_mask) int32 [B, L]; GPT-2 adds no specials."""
        ml = max_length or self.max_length
        ids = np.full((len(texts), ml), self.pad_id, np.int32)
        mask = np.zeros((len(texts), ml), np.int32)
        for i, text in enumerate(texts):
            seq = self.encode(text)[:ml]
            ids[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1
        return ids, mask


# ------------------------------------------------- SentencePiece unigram (T5)


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def parse_sentencepiece_model(path: str) -> list[tuple[str, float, int]]:
    """Minimal protobuf walk of a ``.model`` file: returns
    [(piece, score, type)] from the repeated ``pieces`` field (field 1).
    Types: 1=normal, 2=unk, 3=control, 4=user_defined, 6=byte."""
    import struct

    with open(path, "rb") as fp:
        buf = fp.read()
    pieces = []
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 2:
            length, i = _read_varint(buf, i)
            payload = buf[i : i + length]
            i += length
            if field == 1:  # SentencePiece message
                piece, score, ptype = "", 0.0, 1
                j = 0
                while j < len(payload):
                    t2, j = _read_varint(payload, j)
                    f2, w2 = t2 >> 3, t2 & 7
                    if w2 == 2:
                        ln, j = _read_varint(payload, j)
                        if f2 == 1:
                            piece = payload[j : j + ln].decode("utf-8")
                        j += ln
                    elif w2 == 5:
                        if f2 == 2:
                            score = struct.unpack("<f", payload[j : j + 4])[0]
                        j += 4
                    elif w2 == 0:
                        val, j = _read_varint(payload, j)
                        if f2 == 3:
                            ptype = val
                    elif w2 == 1:
                        j += 8
                    else:
                        break
                pieces.append((piece, score, ptype))
        elif wire == 0:
            _, i = _read_varint(buf, i)
        elif wire == 5:
            i += 4
        elif wire == 1:
            i += 8
        else:
            break
    return pieces


class SentencePieceTokenizer:
    """Unigram-LM tokenizer (Viterbi best segmentation) compatible with T5's
    SentencePiece models. The reference tokenizes through
    ``AutoTokenizer.from_pretrained(t5_urls[model_v])``
    (``narr_pooling_layers.py:351-353``); this implementation loads the same
    ``spiece.model`` protobuf offline. T5 conventions: NFKC + whitespace
    collapse, ``add_dummy_prefix`` (leading ▁), ``</s>`` appended,
    pad id 0."""

    UNK_PENALTY = 10.0

    def __init__(self, pieces: list[tuple[str, float, int]], max_length: int = 128):
        self.max_length = max_length
        self.piece_score: dict[str, float] = {}
        self.piece_id: dict[str, int] = {}
        self.unk_id, self.pad_id, self.eos_id = 2, 0, 1
        min_score = 0.0
        for idx, (piece, score, ptype) in enumerate(pieces):
            self.piece_id[piece] = idx
            if ptype == 2:
                self.unk_id = idx
            elif ptype == 3:  # control: <pad> </s>
                if piece == "<pad>":
                    self.pad_id = idx
                elif piece == "</s>":
                    self.eos_id = idx
            if ptype in (1, 4, 6):
                self.piece_score[piece] = score
                min_score = min(min_score, score)
        self.max_piece_len = max((len(p) for p in self.piece_score), default=1)
        self.unk_score = min_score - self.UNK_PENALTY

    @classmethod
    def from_model_file(cls, path: str, **kw) -> "SentencePieceTokenizer":
        return cls(parse_sentencepiece_model(path), **kw)

    def _normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        text = " ".join(text.split())  # remove_extra_whitespaces
        return ("▁" + text.replace(" ", "▁")) if text else ""

    def tokenize(self, text: str) -> list[str]:
        s = self._normalize(text)
        n = len(s)
        if not n:
            return []
        # Viterbi: best[j] = (score, start, piece-or-None)
        NEG = -1e18
        best = [(NEG, -1, None)] * (n + 1)
        best[0] = (0.0, -1, None)
        for j in range(1, n + 1):
            lo = max(0, j - self.max_piece_len)
            for k in range(lo, j):
                if best[k][0] <= NEG:
                    continue
                sub = s[k:j]
                sc = self.piece_score.get(sub)
                if sc is not None and best[k][0] + sc > best[j][0]:
                    best[j] = (best[k][0] + sc, k, sub)
            if best[j][2] is None:  # unk: single char fallback
                k = j - 1
                if best[k][0] > NEG:
                    best[j] = (best[k][0] + self.unk_score, k, s[k:j])
        out = []
        j = n
        while j > 0:
            _, k, piece = best[j]
            out.append(piece)
            j = k
        return out[::-1]

    def encode(self, text: str) -> list[int]:
        return [self.piece_id.get(p, self.unk_id) for p in self.tokenize(text)]

    def encode_batch(self, texts: list[str], max_length: int | None = None):
        """(input_ids, attention_mask) int32 [B, L]; appends </s>, pads 0."""
        ml = max_length or self.max_length
        ids = np.full((len(texts), ml), self.pad_id, np.int32)
        mask = np.zeros((len(texts), ml), np.int32)
        for i, text in enumerate(texts):
            seq = self.encode(text)[: ml - 1] + [self.eos_id]
            ids[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1
        return ids, mask


def hash_gpt2_tokenizer(vocab_size: int = 50257, max_length: int = 128) -> GPT2BPETokenizer:
    """Offline placeholder GPT-2 tokenizer: byte-level tokens hash to stable
    pseudo-ids; no merges (pure byte fallback). NOT checkpoint-compatible."""

    class _HashVocab(dict):
        def __missing__(self, key):
            h = 2166136261
            for ch in key.encode():
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            return h % (vocab_size - 1)

    vocab = _HashVocab()
    vocab["<|endoftext|>"] = vocab_size - 1
    tok = GPT2BPETokenizer(vocab, [], max_length=max_length)
    tok.is_hash_fallback = True
    return tok


def hash_t5_tokenizer(vocab_size: int = 32128, max_length: int = 128) -> SentencePieceTokenizer:
    """Offline placeholder T5 tokenizer: characters as single-piece vocab with
    uniform scores plus byte-ish hashing. NOT checkpoint-compatible."""
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2)]
    import string

    for ch in "▁" + string.ascii_lowercase + string.ascii_uppercase + string.digits + string.punctuation:
        pieces.append((ch, -5.0, 1))
    tok = SentencePieceTokenizer(pieces, max_length=max_length)
    tok.is_hash_fallback = True
    return tok
