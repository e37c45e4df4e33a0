"""GloVe word-embedding narration features (port of
``transfusion_tpu/data/glove.py``).

The reference's embedding-table narration variant
(``modeling/narration_embeds/datasets/narration_embeddings.py:17-73``): load
``$DATA/glove.6B.{size}d.txt`` into a word -> vector dict (optionally
L2-normalized), patch nine Ego4D-vocabulary aliases, and pool each narration's
word vectors with max/mean into one sentence vector, cached per narration
string. The result feeds the identity text tower as ``batch["language_f"]``.
"""

from __future__ import annotations

import logging
import os

import numpy as np

log = logging.getLogger("transfusion_torch")

# narration_embeddings.py:35-43 — words missing from glove.6B remapped to
# close neighbors.
GLOVE_ALIASES = {
    "courgette": "zucchini",
    "airer": "hanger",
    "let-go": "drop",
    "turn-down": "reduce",
    "fishcakes": "nugget",
    "inspect/read": "read",
    "divide/pull": "pull",
    "clean/wipe": "clean",
    "indument": "cloth",
}


def load_glove_table(path: str, normalize: bool = True) -> dict:
    """Parse a glove .txt (word vec...) into {word: np.ndarray[size]}."""
    table: dict[str, np.ndarray] = {}
    with open(path) as fp:
        for line in fp:
            line = line.rstrip()
            if not line:
                continue
            sp = line.index(" ")
            word, vec = line[:sp], np.fromstring(line[sp:], sep=" ", dtype=np.float32)
            if normalize:
                n = np.sqrt(vec.dot(vec))
                if n > 0:
                    vec = vec / n
            table[word] = vec
    for alias, target in GLOVE_ALIASES.items():
        if target in table:
            table[alias] = table[target]
    return table


class GloveNarrationEmbedder:
    """narration string -> pooled sentence vector (max/mean over word vectors,
    ``apply_narration_embeds_pooling`` narration_embeddings.py:48-73). Unknown
    words are skipped with a warning; an all-unknown narration yields zeros."""

    def __init__(self, path: str, size: int = 300, pooling: str = "max",
                 normalize: bool = True):
        if pooling not in ("max", "mean"):
            raise ValueError(f"pooling {pooling!r} not implemented")  # :64-68
        self.size = size
        self.pooling = pooling
        self.table = load_glove_table(path, normalize)
        self._cache: dict[str, np.ndarray] = {}

    @classmethod
    def from_env(cls, size: int = 300, pooling: str = "max", normalize: bool = True):
        """$DATA/glove.6B.{size}d.txt (narration_embeddings.py:19); returns
        None (caller zero-fills) when the file is absent."""
        path = os.path.expandvars(f"$DATA/glove.6B.{size}d.txt")
        if not os.path.isfile(path):
            log.warning("glove table %s missing; language_f will be zeros", path)
            return None
        return cls(path, size=size, pooling=pooling, normalize=normalize)

    def __call__(self, narration: str) -> np.ndarray:
        hit = self._cache.get(narration)
        if hit is not None:
            return hit
        vecs = []
        for w in narration.replace(",", " ").split(" "):
            if not w:
                continue
            v = self.table.get(w)
            if v is None:
                log.warning("%r does not have embed", w)
            else:
                vecs.append(v)
        if not vecs:
            out = np.zeros(self.size, np.float32)
        else:
            arr = np.asarray(vecs, np.float32)
            out = arr.max(axis=0) if self.pooling == "max" else arr.mean(axis=0)
        self._cache[narration] = out
        return out
