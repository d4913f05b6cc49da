"""DASE components of the classification template, trained on the card.

Port of ``predictionio_tpu/models/classification/engine.py``: Naive
Bayes or logistic regression over labelled text events (feature-hashed)
or entity properties (one-hot categories and numeric columns).

- ``ClassificationDataSource`` reads the store (text mode through
  ``PEventStore.find``, properties mode through
  ``PEventStore.aggregate_properties``), or a JSON-lines events file when
  built with ``events_path=``; ``read_eval``'s ``evalFolds`` folds are
  the reference's.
- ``ClassificationPreparator``, ``FeatureSpace`` and ``ClassifierModel``
  are copied: vectorizing stays host numpy.
- ``NaiveBayesAlgorithm.train`` and ``LogisticRegressionAlgorithm.train``
  run ``ops/classify.py`` on ``device`` (``cuda`` unless the caller names
  ``"cpu"``; without a card and without that request construction
  raises), over ``ctx.mesh`` as the reference's do: the examples
  data-parallel over its ``data`` axis, so each rank of a multi-process
  ``pio train`` trains its share; rank 0 persists the model.
- ``predict`` is copied and serves on the host, as the reference's does
  (``model.inner.scores`` is numpy): one [1, D] x [D, C] product per
  query gains nothing on the card.

Query contract: ``{"text": "..."}`` or ``{"features": {...}}`` ->
``{"label": ..., "scores": {label: p, ...}}``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from predictionio_tpu_torch.controller.base import (
    Algorithm,
    DataSource,
    EvalInfo,
    ModelFiles,
    Preparator,
    SanityCheck,
    mesh_or_none,
)
from predictionio_tpu_torch.controller.engine import Engine
from predictionio_tpu_torch.controller.serving import FirstServing
from predictionio_tpu_torch.data.aggregation import aggregate_properties
from predictionio_tpu_torch.data.store import PEventStore, read_events
from predictionio_tpu_torch.ops.classify import train_logistic_regression, train_naive_bayes
from predictionio_tpu_torch.ops.features import (
    BinaryVectorizer,
    NumericVectorizer,
    hashing_vectorize,
)
from predictionio_tpu_torch.utils.device import resolve_device


@dataclass
class LabeledRecords(SanityCheck):
    records: list[dict]   # feature dicts (or {"text": ...})
    labels: list[str]
    mode: str             # "text" | "properties"

    def sanity_check(self) -> None:
        if not self.records:
            raise ValueError("no labeled training data found")
        if len(set(self.labels)) < 2:
            raise ValueError("need at least 2 classes to train a classifier")


class ClassificationDataSource(DataSource):
    """Params: appName; mode ("text"|"properties"); textKey/labelKey for text
    events (default eventNames ["train"]); entityType/attributeFields/
    labelField for property mode; evalFolds. With ``events_path`` the
    JSON-lines events file is read in place of the store."""

    def __init__(self, params=None, *, events_path: str | None = None):
        super().__init__(params)
        self.events_path = events_path

    def _file_events(self, keep) -> list:
        """The events file's events that ``keep`` accepts, in the
        store's order (event time at millisecond resolution, ties in
        file order)."""
        kept = [e for e in read_events(self.events_path) if keep(e)]
        return sorted(kept, key=lambda e: int(e.event_time.timestamp() * 1000))

    def _read(self) -> LabeledRecords:
        mode = self.params.get_or("mode", "text")
        if mode == "text":
            event_names = self.params.get_or("eventNames", ["train"])
            if self.events_path is None:
                events = PEventStore.find(self.params.appName, event_names=event_names)
            else:
                events = self._file_events(lambda e: e.event in event_names)
            text_key = self.params.get_or("textKey", "text")
            label_key = self.params.get_or("labelKey", "label")
            records, labels = [], []
            for e in events:
                text = e.properties.get_opt(text_key)
                label = e.properties.get_opt(label_key)
                if text is None or label is None:
                    continue
                records.append({"text": str(text)})
                labels.append(str(label))
            return LabeledRecords(records, labels, "text")
        entity_type = self.params.get_or("entityType", "user")
        if self.events_path is None:
            props = PEventStore.aggregate_properties(
                self.params.appName, entity_type=entity_type
            )
        else:
            props = aggregate_properties(
                self._file_events(lambda e: e.entity_type == entity_type)
            )
        label_field = self.params.get_or("labelField", "label")
        fields = self.params.get_or("attributeFields", None)
        records, labels = [], []
        for pm in props.values():
            if label_field not in pm:
                continue
            d = pm.to_dict()
            label = str(d.pop(label_field))
            if fields:
                d = {k: v for k, v in d.items() if k in fields}
            records.append(d)
            labels.append(label)
        return LabeledRecords(records, labels, "properties")

    def read_training(self, ctx) -> LabeledRecords:
        return self._read()

    def read_eval(self, ctx):
        data = self._read()
        folds = self.params.get_or("evalFolds", 3)
        out = []
        for f in range(folds):
            idx = np.arange(len(data.records))
            test = (idx % folds) == f
            train = LabeledRecords(
                [r for r, t in zip(data.records, test) if not t],
                [l for l, t in zip(data.labels, test) if not t],
                data.mode,
            )
            pairs = [
                (
                    {"text": r["text"]} if data.mode == "text" else {"features": r},
                    l,
                )
                for r, l, t in zip(data.records, data.labels, test)
                if t
            ]
            out.append((train, EvalInfo(fold=f), pairs))
        return out


@dataclass
class FeatureSpace:
    """Everything needed to vectorize one query at serving time."""

    mode: str
    hash_dim: int
    binary: BinaryVectorizer | None
    numeric: NumericVectorizer | None
    classes: list[str]

    def vectorize_records(self, records: list[dict]) -> np.ndarray:
        if self.mode == "text":
            return hashing_vectorize([r["text"] for r in records], self.hash_dim)
        parts = []
        if self.binary and self.binary.dim:
            parts.append(self.binary.transform(records))
        if self.numeric and self.numeric.fields:
            parts.append(self.numeric.transform(records))
        if not parts:
            raise ValueError("no usable features in training records")
        return np.concatenate(parts, axis=1)


class ClassificationPreparator(Preparator):
    """Vectorizes records; params: hashDim (text mode, default 4096)."""

    def prepare(self, ctx, data: LabeledRecords):
        classes = sorted(set(data.labels))
        class_index = {c: i for i, c in enumerate(classes)}
        y = np.array([class_index[l] for l in data.labels], dtype=np.int32)
        if data.mode == "text":
            space = FeatureSpace(
                mode="text",
                hash_dim=self.params.get_or("hashDim", 4096),
                binary=None,
                numeric=None,
                classes=classes,
            )
        else:
            categorical, numeric = [], []
            sample = data.records
            keys = sorted({k for r in sample for k in r})
            for k in keys:
                values = [r[k] for r in sample if k in r]
                if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in values):
                    numeric.append(k)
                else:
                    categorical.append(k)
            space = FeatureSpace(
                mode="properties",
                hash_dim=0,
                binary=BinaryVectorizer.fit(sample, categorical),
                numeric=NumericVectorizer(numeric),
                classes=classes,
            )
        x = space.vectorize_records(data.records)
        return space, x, y


@dataclass
class ClassifierModel:
    space: FeatureSpace
    inner: object  # NaiveBayesModel | LogisticRegressionModel


class _ClassifierBase(Algorithm):
    """Trains on ``device`` over ``ctx.mesh``; serves on the host."""

    model_files = ModelFiles(
        "classification", "predictionio_tpu_torch.models.classification.convert")

    def __init__(self, params=None, *, device=None):
        super().__init__(params)
        self.device = resolve_device(device)

    def predict(self, model: ClassifierModel, query) -> dict:
        if "text" in query:
            record = {"text": str(query["text"])}
        elif "features" in query:
            record = dict(query["features"])
        else:
            raise ValueError("query must contain 'text' or 'features'")
        x = model.space.vectorize_records([record])
        raw = model.inner.scores(x)[0]
        # normalize to probabilities for the wire (NB scores are log-space)
        if np.any(raw < 0) or raw.sum() <= 0 or raw.max() > 1:
            e = np.exp(raw - raw.max())
            probs = e / e.sum()
        else:
            probs = raw
        best = int(np.argmax(probs))
        return {
            "label": model.space.classes[best],
            "scores": {
                c: float(p) for c, p in zip(model.space.classes, probs)
            },
        }


class NaiveBayesAlgorithm(_ClassifierBase):
    """Params: smoothing (default 1.0)."""

    def train(self, ctx, prepared) -> ClassifierModel:
        space, x, y = prepared
        model = train_naive_bayes(
            x,
            y,
            len(space.classes),
            smoothing=self.params.get_or("smoothing", 1.0),
            mesh=mesh_or_none(ctx),  # dp over examples
            device=self.device,
        )
        return ClassifierModel(space=space, inner=model)


class LogisticRegressionAlgorithm(_ClassifierBase):
    """Params: reg, iterations, learningRate (accepted, unused: the
    L-BFGS line search sets every step)."""

    def train(self, ctx, prepared) -> ClassifierModel:
        space, x, y = prepared
        model = train_logistic_regression(
            x,
            y,
            len(space.classes),
            reg=self.params.get_or("reg", 1e-4),
            iterations=self.params.get_or("iterations", 100),
            learning_rate=self.params.get_or("learningRate", 0.1),
            mesh=mesh_or_none(ctx),  # dp over examples
            device=self.device,
        )
        return ClassifierModel(space=space, inner=model)


#: the engine.json algorithm names of the template (the reference
#: ``engine_factory``'s ``algorithm_class_map``)
ALGORITHMS = {
    "naive-bayes": NaiveBayesAlgorithm,
    "logistic-regression": LogisticRegressionAlgorithm,
}


def engine_factory() -> Engine:
    return Engine(
        data_source_class=ClassificationDataSource,
        preparator_class=ClassificationPreparator,
        algorithm_class_map=ALGORITHMS,
        serving_class=FirstServing,
    )
