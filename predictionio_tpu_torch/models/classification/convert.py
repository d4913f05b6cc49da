"""Carry a trained classification model into the port, and persist it.

The JAX package pickles its models; the port loads no pickle. A
``ClassifierModel`` (``predictionio_tpu/models/classification/
engine.py``) is its feature space and its inner model, both plain
numpy, so it crosses as they are (``from_reference``).

On disk a model is a directory of two pickle-free files:

- ``classifier.json``: ``mode``, ``hash_dim``, ``classes``,
  ``binary_index`` (the ``BinaryVectorizer``'s ``[field, value,
  column]`` triples in its insertion order, which is its column order;
  null without one), ``numeric_fields`` (null without a
  ``NumericVectorizer``) and ``inner``, which model it is
  (``naive_bayes`` or ``logistic_regression``);
- ``arrays.npz``: the inner model's arrays (``log_prior`` and
  ``log_likelihood``, or ``weights`` and ``bias``), loaded with
  ``allow_pickle=False``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from predictionio_tpu_torch.controller.base import open_model_file
from predictionio_tpu_torch.models.classification.engine import (
    ClassifierModel,
    FeatureSpace,
)
from predictionio_tpu_torch.ops.classify import LogisticRegressionModel, NaiveBayesModel
from predictionio_tpu_torch.ops.features import BinaryVectorizer, NumericVectorizer

#: inner model kind -> (class, its array fields)
INNER = {
    "naive_bayes": (NaiveBayesModel, ("log_prior", "log_likelihood")),
    "logistic_regression": (LogisticRegressionModel, ("weights", "bias")),
}


def _inner_kind(inner) -> str:
    """Which model ``inner`` is, by its fields (the port's or the
    reference's class)."""
    for kind, (_, fields) in INNER.items():
        if all(hasattr(inner, f) for f in fields):
            return kind
    raise TypeError(f"not a classifier's inner model: {type(inner).__name__}")


def from_reference(model) -> ClassifierModel:
    """The port's ``ClassifierModel`` from the JAX package's (or any
    object of the same fields): the vectorizers and the inner model's
    arrays, copied as float32."""
    space = model.space
    kind = _inner_kind(model.inner)
    cls, fields = INNER[kind]
    binary = None if space.binary is None else BinaryVectorizer(
        index={(str(f), str(v)): int(j) for (f, v), j in space.binary.index.items()})
    numeric = None if space.numeric is None else NumericVectorizer(
        fields=[str(f) for f in space.numeric.fields])
    return ClassifierModel(
        space=FeatureSpace(
            mode=space.mode, hash_dim=int(space.hash_dim), binary=binary,
            numeric=numeric, classes=[str(c) for c in space.classes],
        ),
        inner=cls(*(np.asarray(getattr(model.inner, f), np.float32) for f in fields)),
    )


def save_model(model: ClassifierModel, path: str) -> None:
    """Write ``model`` as the directory ``path`` (``classifier.json`` +
    ``arrays.npz``)."""
    os.makedirs(path, exist_ok=True)
    space = model.space
    kind = _inner_kind(model.inner)
    np.savez(os.path.join(path, "arrays.npz"),
             **{f: getattr(model.inner, f) for f in INNER[kind][1]})
    with open(os.path.join(path, "classifier.json"), "w") as f:
        json.dump({
            "mode": space.mode,
            "hash_dim": space.hash_dim,
            "classes": list(space.classes),
            "binary_index": None if space.binary is None else [
                [field, value, column] for (field, value), column in space.binary.index.items()],
            "numeric_fields": None if space.numeric is None else list(space.numeric.fields),
            "inner": kind,
        }, f)


def load_model(path) -> ClassifierModel:
    """Read a model written by ``save_model``: its directory, or an open
    ``zipfile.ZipFile`` of a model blob."""
    with open_model_file(path, "classifier.json") as f:
        meta = json.load(f)
    with open_model_file(path, "arrays.npz") as f, np.load(f, allow_pickle=False) as z:
        arrays = {name: z[name] for name in z.files}
    cls, fields = INNER[meta["inner"]]
    triples = meta["binary_index"]
    return ClassifierModel(
        space=FeatureSpace(
            mode=meta["mode"],
            hash_dim=meta["hash_dim"],
            binary=None if triples is None else BinaryVectorizer(
                index={(field, value): column for field, value, column in triples}),
            numeric=None if meta["numeric_fields"] is None else NumericVectorizer(
                fields=meta["numeric_fields"]),
            classes=meta["classes"],
        ),
        inner=cls(*(arrays[f] for f in fields)),
    )
