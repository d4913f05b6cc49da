"""Copy of ``predictionio_tpu/ops/features.py`` (host numpy, no framework).

Feature vectorization: text hashing + categorical one-hot.

Parity roles: reference ``e2/.../engine/BinaryVectorizer.scala`` (categorical
properties -> binary vectors) and the classification templates' ad-hoc
tokenization (SURVEY.md section 2.5 #36). Feature hashing keeps the feature
space dense and static-shape -- the TPU-friendly choice for text.
"""

from __future__ import annotations

import re
import zlib
from dataclasses import dataclass, field

import numpy as np

_TOKEN_RE = re.compile(r"[A-Za-z0-9']+")


def tokenize(text: str) -> list[str]:
    return [t.lower() for t in _TOKEN_RE.findall(text)]


def hash_token(token: str, dim: int) -> int:
    # crc32: fast, stable across processes (unlike Python's salted hash)
    return zlib.crc32(token.encode("utf-8")) % dim


def hashing_vectorize(texts: list[str], dim: int = 4096) -> np.ndarray:
    """Bag-of-words feature hashing -> dense [n, dim] float32 counts."""
    out = np.zeros((len(texts), dim), dtype=np.float32)
    for i, text in enumerate(texts):
        for token in tokenize(text):
            out[i, hash_token(token, dim)] += 1.0
    return out


@dataclass
class BinaryVectorizer:
    """Categorical (field, value) pairs -> fixed binary columns.

    Fit on training dicts; unseen categories at transform time are ignored
    (reference BinaryVectorizer contract).
    """

    index: dict[tuple[str, str], int] = field(default_factory=dict)

    @classmethod
    def fit(cls, records: list[dict], fields: list[str]) -> "BinaryVectorizer":
        index: dict[tuple[str, str], int] = {}
        for record in records:
            for f in fields:
                if f in record:
                    key = (f, str(record[f]))
                    index.setdefault(key, len(index))
        return cls(index=index)

    @property
    def dim(self) -> int:
        return len(self.index)

    @property
    def _fields(self) -> list[str]:
        return sorted({f for f, _ in self.index})

    def transform(self, records: list[dict]) -> np.ndarray:
        out = np.zeros((len(records), max(self.dim, 1)), dtype=np.float32)
        fields = self._fields
        for i, record in enumerate(records):
            for f in fields:
                if f in record:
                    j = self.index.get((f, str(record[f])))
                    if j is not None:
                        out[i, j] = 1.0
        return out


@dataclass
class NumericVectorizer:
    """Numeric property columns -> dense matrix (missing -> 0)."""

    fields: list[str]

    def transform(self, records: list[dict]) -> np.ndarray:
        out = np.zeros((len(records), len(self.fields)), dtype=np.float32)
        for i, record in enumerate(records):
            for j, f in enumerate(self.fields):
                v = record.get(f)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    out[i, j] = float(v)
        return out
