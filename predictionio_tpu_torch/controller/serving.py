"""Stock serving combinator (port of ``controller/serving.py::FirstServing``,
with its ``serve_batch`` for the micro-batched query path)."""

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
