"""e2: self-contained reference algorithms and evaluation helpers.

Port of ``predictionio_tpu/models/e2.py``:

- ``categorical_naive_bayes``: Naive Bayes over string-valued feature
  dicts through ``BinaryVectorizer`` and ``ops/classify.py``'s
  ``train_naive_bayes`` on ``device`` (``cuda`` unless the caller names
  ``"cpu"``);
- ``MarkovChain``: the first-order transition model (host numpy, copied);
- ``cross_validation_folds``: the k-fold splitter (copied);
- ``kmeans``: ``ops/kmeans.py::kmeans_fit``, the Lloyd step on the card
  (with a ``mesh``, the rows over its ``data`` axis).

``CategoricalNBModel`` is copied; it serves on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from predictionio_tpu_torch.ops.classify import NaiveBayesModel, train_naive_bayes
from predictionio_tpu_torch.ops.features import BinaryVectorizer
from predictionio_tpu_torch.ops.kmeans import KMeansModel, kmeans_fit as kmeans  # noqa: F401


@dataclass
class CategoricalNBModel:
    vectorizer: BinaryVectorizer
    classes: list[str]
    inner: NaiveBayesModel

    def predict(self, record: dict) -> str:
        x = self.vectorizer.transform([record])
        return self.classes[int(self.inner.scores(x)[0].argmax())]

    def log_score(self, record: dict, label: str) -> float:
        x = self.vectorizer.transform([record])
        return float(self.inner.scores(x)[0][self.classes.index(label)])


def categorical_naive_bayes(
    records: list[dict], labels: list[str], smoothing: float = 1.0, *, device=None
) -> CategoricalNBModel:
    fields = sorted({k for r in records for k in r})
    vectorizer = BinaryVectorizer.fit(records, fields)
    classes = sorted(set(labels))
    index = {c: i for i, c in enumerate(classes)}
    y = np.array([index[l] for l in labels], dtype=np.int32)
    inner = train_naive_bayes(
        vectorizer.transform(records), y, len(classes), smoothing=smoothing,
        device=device,
    )
    return CategoricalNBModel(vectorizer=vectorizer, classes=classes, inner=inner)


@dataclass
class MarkovChain:
    """First-order Markov chain over an integer state space."""

    transition: np.ndarray  # [S, S] row-stochastic
    states: list[str]

    @classmethod
    def fit(cls, sequences: list[list[str]], smoothing: float = 1e-3) -> "MarkovChain":
        state_index: dict[str, int] = {}
        pairs: list[tuple[int, int]] = []
        for seq in sequences:
            idx = [state_index.setdefault(s, len(state_index)) for s in seq]
            pairs.extend(zip(idx[:-1], idx[1:]))
        n = len(state_index)
        if n == 0:
            raise ValueError("no states in training sequences")
        counts = np.zeros((n, n))
        if pairs:
            src = np.array([p[0] for p in pairs])
            dst = np.array([p[1] for p in pairs])
            # O(P) scatter-add; a one-hot matmul here would materialize
            # [P, S] dense intermediates for no benefit at host scale
            np.add.at(counts, (src, dst), 1.0)
        counts = counts + smoothing
        transition = counts / counts.sum(axis=1, keepdims=True)
        return cls(transition=transition, states=list(state_index))

    def next_distribution(self, state: str) -> dict[str, float]:
        i = self.states.index(state)
        return dict(zip(self.states, self.transition[i].tolist()))

    def most_likely_next(self, state: str) -> str:
        i = self.states.index(state)
        return self.states[int(self.transition[i].argmax())]

    def sequence_log_prob(self, seq: list[str]) -> float:
        total = 0.0
        for a, b in zip(seq[:-1], seq[1:]):
            i, j = self.states.index(a), self.states.index(b)
            total += float(np.log(self.transition[i, j]))
        return total


def cross_validation_folds(n: int, k: int, seed: int = 0):
    """Yield (train_indices, test_indices) for k shuffled folds."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    for f in range(k):
        test = order[f::k]
        train = np.setdiff1d(order, test)
        yield train, test
