"""DASE component base classes, serving half.

Port of the parts of ``predictionio_tpu/controller/base.py`` that the
query server needs: ``Params``, the ``Algorithm`` contract (predict,
batch_predict, warm_up and the wire serde) and ``Serving``. The
DataSource/Preparator/train side comes with the training slice.
"""

from __future__ import annotations

import abc
from typing import Any, Mapping, Sequence


class Params(dict):
    """Engine-component parameters: a dict with attribute access
    (engine.json fragments deserialize straight into it)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def get_or(self, name: str, default: Any) -> Any:
        return self.get(name, default)


class Component:
    """Shared construction: every DASE component takes its params dict."""

    def __init__(self, params: Mapping[str, Any] | None = None):
        self.params = params if isinstance(params, Params) else Params(params or {})


class Algorithm(Component, abc.ABC):
    """Algorithm contract on the serving path: answer queries."""

    @abc.abstractmethod
    def predict(self, model, query): ...

    def batch_predict(self, model, queries: Sequence[tuple[Any, Any]]) -> list:
        """Default: loop predict. Override with a vectorized version."""
        return [(qid, self.predict(model, q)) for qid, q in queries]

    def warm_up(self, model) -> None:
        """Called once at deploy, before the first query: build serving
        caches (device-resident tables) here."""

    def query_from_json(self, obj: Any) -> Any:
        """Deserialize a /queries.json body. Default: pass the dict through."""
        return obj

    def result_to_json(self, prediction: Any) -> Any:
        """Serialize a prediction for the wire. Default: JSON-able as-is."""
        return prediction


class Serving(Component, abc.ABC):
    @abc.abstractmethod
    def serve(self, query, predictions: Sequence): ...
