"""Engine parameters, the ported templates, and the model blob.

Counterpart of ``predictionio_tpu/controller/engine.py``:

- ``EngineParams`` is a copy of the reference's: the engine.json
  parameter block (``from_json_obj``), also rebuilt from what an engine
  instance records (``workflow/core_workflow.py``), and written back
  (``to_json_obj``) into each model-registry manifest
  (``online/registry.py``).
- ``Template`` and ``TEMPLATES`` stand where the reference's ``Engine``
  and its ``engineFactory`` callables stand: the port binds each ported
  template's DASE classes, its ``algorithm_class_map`` (engine.json
  algorithm name -> class; classification has two) and its pickle-free
  ``save_model`` / ``load_model`` here, and ``template_for`` maps an
  ``engineFactory`` path of the JAX package (or, without one, the first
  algorithm's name) to it, bound to the engine.json's first algorithm
  (``Template.bind``). No factory is ever imported.
- ``serialize_model`` / ``deserialize_model`` are the counterpart of
  ``Engine.serialize_models`` / ``prepare_deploy`` (reference
  ``:154-234``). The reference pickles its models; the port's blob is a
  stored (uncompressed) zip of exactly the files the template's
  ``save_model`` writes, plus ``manifest.json`` naming the template and
  the algorithm that trained it. A pickled blob (first byte ``0x80``: one
  the JAX package wrote) is refused with an error and never unpickled.
  ``load_serving_model`` is what a deploy, a hot swap and the retrain
  loop share: a blob, deserialized, beside the class that trained it
  (the manifest's algorithm) built with the given params.
- ``evaluate`` is the counterpart of ``Engine.eval`` (reference
  ``:259-282``) over a ``Template``: the DataSource's ``read_eval``
  folds, each prepared and trained, every fold's queries scored in one
  ``batch_predict`` pass (``batch_serve``).

A template serves its engine.json's first algorithm block through
``FirstServing`` (``first_algorithm``), as every ported template of the
reference does.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import zipfile
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Mapping

from predictionio_tpu_torch.controller.base import (
    Algorithm,
    DataSource,
    IdentityPreparator,
    Params,
    Preparator,
)
from predictionio_tpu_torch.controller.serving import FirstServing
from predictionio_tpu_torch.models import (
    classification,
    ecommerce,
    ncf,
    recommendation,
    sequence,
    similarproduct,
    universal,
)


@dataclass
class EngineParams:
    """Deserialized engine.json parameter block (reference EngineParams)."""

    data_source_params: Params = field(default_factory=Params)
    preparator_params: Params = field(default_factory=Params)
    algorithm_params_list: list[tuple[str, Params]] = field(default_factory=list)
    serving_params: Params = field(default_factory=Params)

    @classmethod
    def from_json_obj(cls, obj: Mapping[str, Any]) -> "EngineParams":
        algorithms = [
            (a.get("name", "default"), Params(a.get("params", {})))
            for a in obj.get("algorithms", [{"name": "default", "params": {}}])
        ]
        return cls(
            data_source_params=Params(obj.get("datasource", {}).get("params", {})),
            preparator_params=Params(obj.get("preparator", {}).get("params", {})),
            algorithm_params_list=algorithms,
            serving_params=Params(obj.get("serving", {}).get("params", {})),
        )

    def to_json_obj(self) -> dict[str, Any]:
        return {
            "datasource": {"params": dict(self.data_source_params)},
            "preparator": {"params": dict(self.preparator_params)},
            "algorithms": [
                {"name": name, "params": dict(params)}
                for name, params in self.algorithm_params_list
            ],
            "serving": {"params": dict(self.serving_params)},
        }


@dataclass(frozen=True)
class Template:
    """What the verbs need of one ported template, bound to one of its
    algorithms (``algorithm``: the engine.json's first algorithm name,
    by default the first of ``algorithms``)."""

    name: str                           # TEMPLATES key, recorded in the blob
    algorithms: Mapping[str, type[Algorithm]]  # engine.json name -> class
    preparator_class: type[Preparator]
    save_model: Callable
    load_model: Callable                # a directory path or an open ZipFile
    datasource_class: type[DataSource]  # reads the store, or ``events_path=``
    algorithm: str = ""                 # the bound algorithm name

    def __post_init__(self):
        if not self.algorithm:
            object.__setattr__(self, "algorithm", next(iter(self.algorithms)))

    @property
    def algorithm_class(self) -> type[Algorithm]:
        return self.algorithms[self.algorithm]

    def bind(self, algorithm: str) -> "Template":
        """This template bound to ``algorithm``, one of its names."""
        if algorithm not in self.algorithms:
            raise ValueError(
                f"the {self.name!r} template's algorithm is "
                f"{' or '.join(map(repr, self.algorithms))}, got {algorithm!r}"
            )
        return self if algorithm == self.algorithm else replace(self, algorithm=algorithm)


TEMPLATES = {
    "recommendation": Template(
        "recommendation", {"als": recommendation.ALSAlgorithm},
        recommendation.RecommendationPreparator, recommendation.save_model,
        recommendation.load_model, recommendation.RecommendationDataSource,
    ),
    "ncf": Template(
        "ncf", {"ncf": ncf.NCFAlgorithm}, ncf.NCFPreparator, ncf.save_model,
        ncf.load_model, recommendation.RecommendationDataSource,
    ),
    "sequence": Template(
        "sequence", {"sasrec": sequence.SASRecAlgorithm}, sequence.SequencePreparator,
        sequence.save_model, sequence.load_model, sequence.SequenceDataSource,
    ),
    "ecommerce": Template(
        "ecommerce", {"ecomm": ecommerce.ECommAlgorithm}, ecommerce.ECommercePreparator,
        ecommerce.save_model, ecommerce.load_model, ecommerce.ECommerceDataSource,
    ),
    "similarproduct": Template(
        "similarproduct", {"cooccurrence": similarproduct.CooccurrenceAlgorithm},
        IdentityPreparator, similarproduct.save_model, similarproduct.load_model,
        similarproduct.SimilarProductDataSource,
    ),
    "universal": Template(
        "universal", {"ur": universal.URAlgorithm}, IdentityPreparator,
        universal.save_model, universal.load_model, universal.URDataSource,
    ),
    "classification": Template(
        "classification", classification.ALGORITHMS,
        classification.ClassificationPreparator, classification.save_model,
        classification.load_model, classification.ClassificationDataSource,
    ),
}


def template_for(engine_factory: str, algorithm_name: str) -> Template:
    """The template of an engine.json, bound to its first algorithm: by
    ``engineFactory`` (``predictionio_tpu.models.<template>.
    engine_factory``, or the module path ``...<template>.engine.
    engine_factory`` the reference resolves too) when it names one, else
    the template one of whose algorithms is the first algorithm's name."""
    if engine_factory:
        parts = engine_factory.split(".")
        if len(parts) >= 3 and parts[-2:] == ["engine", "engine_factory"]:
            parts = parts[:-2] + parts[-1:]
        key = parts[-2] if len(parts) >= 2 and parts[-1] == "engine_factory" else None
        if key not in TEMPLATES:
            raise ValueError(
                f"engineFactory {engine_factory!r} is not a ported template; the "
                f"port serves {sorted(TEMPLATES)}"
            )
        template = TEMPLATES[key]
    else:
        template = next(
            (t for t in TEMPLATES.values() if algorithm_name in t.algorithms), None)
        if template is None:
            raise ValueError(
                f"algorithm {algorithm_name!r} is not a ported template's; the port "
                f"serves {sorted(a for t in TEMPLATES.values() for a in t.algorithms)}"
            )
    return template.bind(algorithm_name)


MANIFEST = "manifest.json"
BLOB_FORMAT = "predictionio_tpu_torch.model-zip"


class ModelBlobError(ValueError):
    """A model blob the port cannot deploy."""


def _blob_entry(name: str) -> zipfile.ZipInfo:
    """A blob's zip entry, stamped with zip's epoch: a blob is a function
    of its model alone, never of the clock (a registry version's shard
    blobs equal its full blob byte for byte)."""
    return zipfile.ZipInfo(name, date_time=(1980, 1, 1, 0, 0, 0))


def serialize_model(template: Template, model) -> bytes:
    """The model blob of one trained model: ``template.save_model``'s
    files, stored uncompressed, and ``manifest.json``."""
    with tempfile.TemporaryDirectory(prefix="pio-model-") as tmp:
        template.save_model(model, tmp)
        names = sorted(os.listdir(tmp))
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
            zf.writestr(_blob_entry(MANIFEST), json.dumps({
                "format": BLOB_FORMAT, "version": 1, "template": template.name,
                "algorithm": template.algorithm, "files": names,
            }))
            for name in names:
                with open(os.path.join(tmp, name), "rb") as f:
                    zf.writestr(_blob_entry(name), f.read())
    return buf.getvalue()


def _open_blob(template: Template, blob: bytes) -> tuple[zipfile.ZipFile, dict]:
    """The blob's zip and manifest; raises ``ModelBlobError`` for a
    pickled blob, a blob of another template or of an algorithm the
    template does not have, or one that is not the port's."""
    if blob[:1] == b"\x80":
        raise ModelBlobError(
            "this model blob is a pickle, written by the JAX package "
            "(predictionio_tpu); the port never unpickles a blob. Retrain it "
            "with the port's `train`, or carry its weights across with the "
            "template's convert.py (model_from_arrays / model_from_flax) and "
            "deploy the directory with --model"
        )
    try:
        zf = zipfile.ZipFile(io.BytesIO(blob))
        manifest = json.loads(zf.read(MANIFEST))
    except (zipfile.BadZipFile, KeyError, ValueError) as exc:
        raise ModelBlobError(f"not a model blob of the port: {exc}") from None
    if manifest.get("format") != BLOB_FORMAT:
        raise ModelBlobError(f"unknown model blob format {manifest.get('format')!r}")
    if manifest.get("template") != template.name:
        raise ModelBlobError(
            f"the blob holds a {manifest.get('template')!r} model; the engine.json "
            f"names the {template.name!r} template"
        )
    if manifest.get("algorithm") not in template.algorithms:
        raise ModelBlobError(
            f"the blob was trained by {manifest.get('algorithm')!r}, not an algorithm "
            f"of the {template.name!r} template ({sorted(template.algorithms)})"
        )
    return zf, manifest


def deserialize_model(template: Template, blob: bytes):
    """``template.load_model`` straight off the blob (no temporary
    directory); raises ``ModelBlobError`` as ``_open_blob`` does."""
    zf, _ = _open_blob(template, blob)
    with zf:
        return template.load_model(zf)


def load_serving_model(template: Template, engine_params: EngineParams,
                       blob: bytes, *, device=None, warm_up: bool = True):
    """``(algorithm, model)``: the class that trained the blob (its
    manifest's algorithm) with ``engine_params``' first algorithm block,
    which must name it, on ``device`` (``cuda`` unless ``"cpu"``), and
    the blob's model, its serving state built (``warm_up``: the
    retrieval index packed, so a swap's first query does not pay it)
    unless ``warm_up=False``."""
    zf, manifest = _open_blob(template, blob)
    with zf:
        trained = template.bind(manifest["algorithm"])
        algorithm = first_algorithm(trained, engine_params, device)
        model = trained.load_model(zf)
    if warm_up:
        algorithm.warm_up(model)
    return algorithm, model


def first_algorithm(template: Template, engine_params: EngineParams,
                    device=None) -> Algorithm:
    """The template's algorithm with the params of ``engine_params``'
    first block, on ``device``; a block naming another algorithm than
    the one the template is bound to raises."""
    name, params = engine_params.algorithm_params_list[0]
    if name != template.algorithm:
        raise ValueError(
            f"the {template.name!r} template's algorithm is "
            f"{template.algorithm!r}, got {name!r}"
        )
    return template.algorithm_class(params, device=device)


def batch_serve(algorithm: Algorithm, model, queries: list) -> list:
    """The served answer to each query: one ``batch_predict`` pass over
    all of them, each prediction through ``FirstServing`` (the live
    ``/queries.json`` combination)."""
    serving = FirstServing()
    indexed = list(enumerate(queries))
    predictions = dict(algorithm.batch_predict(model, indexed))
    return [serving.serve(q, [predictions[i]]) for i, q in indexed]


def evaluate(template: Template, ctx, engine_params: EngineParams
             ) -> list[tuple[Any, list[tuple[Any, Any, Any]]]]:
    """Run the evaluation folds of ``template`` under ``engine_params``
    on ``ctx.device`` (reference ``Engine.eval``).

    Returns ``[(eval_info, [(query, prediction, actual), ...]), ...]``.
    """
    template = template.bind(engine_params.algorithm_params_list[0][0])
    data_source = template.datasource_class(engine_params.data_source_params)
    preparator = template.preparator_class(engine_params.preparator_params)
    results = []
    for training_data, eval_info, qa_pairs in data_source.read_eval(ctx):
        prepared_data = preparator.prepare(ctx, training_data)
        algorithm = first_algorithm(template, engine_params, ctx.device)
        model = algorithm.train(ctx, prepared_data)
        served = batch_serve(algorithm, model, [q for q, _ in qa_pairs])
        results.append((eval_info, [(q, p, a) for (q, a), p in zip(qa_pairs, served)]))
    return results
