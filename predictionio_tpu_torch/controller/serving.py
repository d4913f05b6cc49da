"""Stock serving combinators: a copy of
``predictionio_tpu/controller/serving.py`` (``FirstServing``, with its
``serve_batch`` for the micro-batched query path, and ``AverageServing``)."""

from __future__ import annotations

from typing import Sequence

from predictionio_tpu_torch.controller.base import Serving


class FirstServing(Serving):
    """Return the first algorithm's prediction."""

    def serve(self, query, predictions: Sequence):
        if not predictions:
            raise ValueError("FirstServing received no predictions")
        return predictions[0]

    def serve_batch(self, queries, predictions: Sequence[Sequence]):
        # the dominant combinator on the serving hot path: one list
        # comprehension for the whole micro-batch, no per-query dispatch
        if any(not p for p in predictions):
            raise ValueError("FirstServing received no predictions")
        return [p[0] for p in predictions]


class AverageServing(Serving):
    """Average numeric predictions across algorithms.

    Works on plain numbers or on dicts with a numeric field per key.
    """

    def serve(self, query, predictions: Sequence):
        if not predictions:
            raise ValueError("AverageServing received no predictions")
        first = predictions[0]
        if isinstance(first, (int, float)):
            return sum(predictions) / len(predictions)
        if isinstance(first, dict):
            keys = set(first)
            out = {}
            for k in keys:
                values = [p[k] for p in predictions if isinstance(p.get(k), (int, float))]
                out[k] = sum(values) / len(values) if values else first[k]
            return out
        raise TypeError(
            f"AverageServing cannot average predictions of type {type(first).__name__}"
        )
