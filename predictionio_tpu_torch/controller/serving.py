"""Stock serving combinator (port of ``controller/serving.py::FirstServing``)."""

from __future__ import annotations

from typing import Sequence

from predictionio_tpu_torch.controller.base import Serving


class FirstServing(Serving):
    """Return the first algorithm's prediction."""

    def serve(self, query, predictions: Sequence):
        if not predictions:
            raise ValueError("FirstServing received no predictions")
        return predictions[0]
