"""Engine: the central class tying DASE components + params together.

Port of ``predictionio_tpu/controller/engine.py``. ``EngineParams`` is a
copy of the reference's: the engine.json parameter block
(``from_json_obj``), also rebuilt from what an engine instance records
(``workflow/core_workflow.py``), and written back (``to_json_obj``) into
each model-registry manifest (``online/registry.py``). ``Engine`` binds
a DataSource, a Preparator, an algorithm map (engine.json algorithm name
-> class) and a Serving class; an ``engineFactory`` returns one
(``workflow/json_extractor.py::build_engine``; each ported template's is
``models/<template>/engine.py::engine_factory``). Its ``train``,
``serialize_models``, ``prepare_deploy``, ``shard_models`` and ``eval``
are the reference's, with these differences:

- Algorithms are built on an explicit device, ``ctx.device`` (``cuda``
  unless ``"cpu"``): ``Algorithm(params, device=...)``. ``train`` reads
  a JSON-lines events file instead of the store when given
  ``events_path``, through the DataSource's ``events_path=``.
- The model blob is a stored (uncompressed) zip, not a pickle.
  ``manifest.json`` names each algorithm block's entry, chosen by the
  reference's matrix: ``persistent`` (a ``PersistentModel`` that saved
  itself; the entry names its class), ``retrain`` (``persist_model =
  False``: retrained at deploy), ``files`` (an algorithm with
  ``model_files``: the files its ``save_model`` writes, under the
  entry's folder) or else ``pickle`` (the model pickled by the port into
  ``<i>/model.pkl`` of the zip). A blob of one ``files`` entry keeps the
  layout of the port's first blobs (manifest version 1: the files at the
  zip's root), byte for byte; any other is version 2. A bare pickle
  (first byte ``0x80``: a blob the JAX package wrote) is refused and
  never unpickled, and so is a ``pickle`` entry for an algorithm whose
  class has ``model_files``. ``prepare_deploy`` also reads a model
  directory (``deploy --model DIR``): one block's files, as its
  ``model_files`` wrote them.
- ``prepare_deploy`` lets a ``warm_up`` failure propagate (the reference
  logs it and serves on): a deploy that cannot build its serving state
  on the device fails instead of serving from another one. ``warm_up=
  False`` skips it for callers that do not serve (batch predict, the
  retrain loop).
- ``eval`` is the reference's; each fold's queries go through every
  algorithm's ``batch_predict`` in one pass.
"""

from __future__ import annotations

import io
import json
import logging
import os
import pickle
import tempfile
import time
import zipfile
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence, Type

from predictionio_tpu_torch.controller.base import (
    Algorithm,
    BlobFolder,
    DataSource,
    Params,
    PersistentModel,
    Preparator,
    SanityCheck,
    Serving,
    component_name,
)
from predictionio_tpu_torch.controller.serving import FirstServing

logger = logging.getLogger("pio.engine")


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


MANIFEST = "manifest.json"
BLOB_FORMAT = "predictionio_tpu_torch.model-zip"


class ModelBlobError(ValueError):
    """A model blob the port cannot deploy."""


class Engine:
    """Binds DASE component classes; instantiates them per run with params."""

    def __init__(
        self,
        data_source_class: Type[DataSource],
        preparator_class: Type[Preparator],
        algorithm_class_map: Mapping[str, Type[Algorithm]],
        serving_class: Type[Serving] = FirstServing,
    ):
        self.data_source_class = data_source_class
        self.preparator_class = preparator_class
        self.algorithm_class_map = dict(algorithm_class_map)
        self.serving_class = serving_class

    # -- construction helpers ----------------------------------------------
    def _algorithm_classes(self, engine_params: EngineParams) -> list[Type[Algorithm]]:
        classes = []
        for name, _ in engine_params.algorithm_params_list:
            if name not in self.algorithm_class_map:
                raise KeyError(
                    f"algorithm {name!r} not registered in engine"
                    f" (available: {sorted(self.algorithm_class_map)})"
                )
            classes.append(self.algorithm_class_map[name])
        if not classes:
            raise ValueError("engine_params names no algorithms")
        return classes

    def _algorithms(self, engine_params: EngineParams, device=None) -> list[Algorithm]:
        """Every algorithm block's class with its params, on ``device``
        (``cuda`` unless ``"cpu"``)."""
        return [
            cls(params, device=device)
            for cls, (_, params) in zip(
                self._algorithm_classes(engine_params), engine_params.algorithm_params_list
            )
        ]

    def serving(self, engine_params: EngineParams) -> Serving:
        return self.serving_class(engine_params.serving_params)

    def data_source(self, engine_params: EngineParams,
                    events_path: str | None = None) -> DataSource:
        """The DataSource with its params; it reads ``events_path`` (a
        JSON-lines events file) instead of the store when given."""
        if events_path is None:
            return self.data_source_class(engine_params.data_source_params)
        return self.data_source_class(
            engine_params.data_source_params, events_path=events_path
        )

    @staticmethod
    def _maybe_sanity_check(stage: str, obj: Any, skip: bool) -> None:
        if not skip and isinstance(obj, SanityCheck):
            logger.info("sanity check: %s", stage)
            obj.sanity_check()

    # -- train --------------------------------------------------------------
    def train(
        self,
        ctx,
        engine_params: EngineParams,
        skip_sanity_check: bool = False,
        *,
        events_path: str | None = None,
    ) -> list[Any]:
        """D -> P -> every algorithm block's ``train`` on ``ctx.device``;
        returns the models in block order. The stage seconds land in
        ``ctx.timings`` (``read``, ``prepare``, ``train[<name>]``)."""
        timings = getattr(ctx, "timings", {})

        t0 = time.perf_counter()
        data_source = self.data_source(engine_params, events_path)
        training_data = data_source.read_training(ctx)
        timings["read"] = time.perf_counter() - t0
        self._maybe_sanity_check("training data", training_data, skip_sanity_check)

        t0 = time.perf_counter()
        preparator = self.preparator_class(engine_params.preparator_params)
        prepared_data = preparator.prepare(ctx, training_data)
        timings["prepare"] = time.perf_counter() - t0
        self._maybe_sanity_check("prepared data", prepared_data, skip_sanity_check)

        models = []
        for algorithm, (name, _) in zip(
            self._algorithms(engine_params, getattr(ctx, "device", None)),
            engine_params.algorithm_params_list,
        ):
            logger.info("training algorithm %r (%s)", name, component_name(algorithm))
            t0 = time.perf_counter()
            model = algorithm.train(ctx, prepared_data)
            timings[f"train[{name}]"] = time.perf_counter() - t0
            self._maybe_sanity_check(f"model[{name}]", model, skip_sanity_check)
            models.append(model)
        if timings:
            logger.info(
                "stage timings: %s",
                ", ".join(f"{k}={v:.3f}s" for k, v in timings.items()),
            )
        return models

    # -- serialization + deploy rehydration ---------------------------------
    def serialize_models(
        self, ctx, engine_params: EngineParams, instance_id: str, models: Sequence[Any]
    ) -> bytes:
        """Encode the per-algorithm persistence choice into one blob."""
        entries, files = [], []
        for i, (model, cls, (name, params)) in enumerate(zip(
            models, self._algorithm_classes(engine_params),
            engine_params.algorithm_params_list,
        )):
            if isinstance(model, PersistentModel) and model.save(instance_id, params):
                entries.append({"algorithm": name, "kind": "persistent",
                                "class": component_name(model)})
            elif not cls.persist_model:
                entries.append({"algorithm": name, "kind": "retrain"})
            elif cls.model_files is not None:
                written = _model_files(cls, model)
                entries.append({"algorithm": name, "kind": "files",
                                "template": cls.model_files.template,
                                "files": sorted(written)})
                files += [(f"{i}/{n}", written[n]) for n in sorted(written)]
            else:
                entries.append({"algorithm": name, "kind": "pickle",
                                "file": f"{i}/model.pkl"})
                files.append((f"{i}/model.pkl",
                              pickle.dumps(model, protocol=pickle.HIGHEST_PROTOCOL)))
        if len(entries) == 1 and entries[0]["kind"] == "files":
            # the port's first layout: one algorithm's files at the root
            manifest = {"format": BLOB_FORMAT, "version": 1,
                        "template": entries[0]["template"],
                        "algorithm": entries[0]["algorithm"],
                        "files": entries[0]["files"]}
            files = [(name.partition("/")[2], data) for name, data in files]
        else:
            manifest = {"format": BLOB_FORMAT, "version": 2, "algorithms": entries}
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
            zf.writestr(_blob_entry(MANIFEST), json.dumps(manifest))
            for name, data in files:
                zf.writestr(_blob_entry(name), data)
        return buf.getvalue()

    def prepare_deploy(
        self,
        ctx,
        engine_params: EngineParams,
        instance_id: str,
        model_blob: bytes | str | None,
        shard: int | None = None,
        num_shards: int = 1,
        *,
        warm_up: bool = True,
    ) -> list[Any]:
        """Rehydrate per-algorithm models for serving (reference semantics:
        PersistentModelLoader -> load; the blob's files or pickle ->
        deserialize; persist_model=False -> retrain now, on
        ``ctx.device``). ``model_blob`` may also be the path of a model
        directory: the files of the one algorithm block, which has
        ``model_files``. With ``shard``/``num_shards`` set, the
        rehydrated models are partitioned through :meth:`shard_models`
        BEFORE warm-up, so serving caches are built against the shard's
        slice, never the full table. Raises ``ModelBlobError`` for a
        blob this engine cannot deploy, and whatever ``warm_up``
        raises."""
        classes = self._algorithm_classes(engine_params)
        device = getattr(ctx, "device", None)
        if isinstance(model_blob, str):
            if len(classes) != 1:
                raise ModelBlobError(
                    f"a model directory holds the files of one algorithm block;"
                    f" engine_params names {len(classes)}"
                )
            entries = [{"kind": "files", "template": None, "source": model_blob,
                        "algorithm": engine_params.algorithm_params_list[0][0]}]
        elif model_blob:
            entries = _open_blob(model_blob)
        else:
            entries = [{"kind": "retrain"}] * len(classes)
        if len(entries) != len(classes):
            raise ModelBlobError(
                f"model blob has {len(entries)} entries but engine_params names"
                f" {len(classes)} algorithms -- retrain required"
            )
        retrained: list[Any] | None = None
        models = []
        for i, (entry, cls, (name, params)) in enumerate(
            zip(entries, classes, engine_params.algorithm_params_list)
        ):
            kind = entry["kind"]
            files = cls.model_files
            held = entry.get("template")  # None for a model directory
            if kind == "files" and (files is None or held not in (None, files.template)):
                raise ModelBlobError(
                    (f"the blob holds a {held!r} model" if held
                     else f"{entry['source']} is a model directory")
                    + f"; algorithm {name!r} ({component_name(cls)}) reads "
                    + (f"{files.template!r} models" if files else "no model files")
                )
            if kind == "pickle" and files is not None:
                raise ModelBlobError(
                    f"the blob pickles algorithm {name!r}'s model, but"
                    f" {component_name(cls)} saves model files; the port"
                    " unpickles only a model whose class has no model_files"
                )
            if kind != "retrain" and entry["algorithm"] != name:
                if entry["algorithm"] not in self.algorithm_class_map:
                    raise ModelBlobError(
                        f"the blob was trained by {entry['algorithm']!r}, not an"
                        f" algorithm of this engine ({sorted(self.algorithm_class_map)})"
                    )
                raise ModelBlobError(
                    f"the blob's algorithm {i} is {entry['algorithm']!r}, got {name!r}"
                )
            if kind == "persistent":
                models.append(_resolve_class(entry["class"]).load(instance_id, params))
            elif kind == "files":
                models.append(files.load(entry["source"]))
            elif kind == "pickle":
                models.append(pickle.loads(entry["source"].zip.read(entry["file"])))
            elif kind == "retrain":
                if retrained is None:
                    logger.info("retrain-on-deploy: running engine.train")
                    retrained = self.train(ctx, engine_params, skip_sanity_check=True)
                models.append(retrained[i])
            else:  # pragma: no cover - corrupted blob
                raise ModelBlobError(f"unknown model persistence kind {kind!r}")
        if shard is not None and num_shards > 1:
            models = self.shard_models(engine_params, models, shard, num_shards, device)
        if warm_up:
            # serving caches (device-resident scorers, retrieval indexes)
            # build at deploy time, not on the unlucky first query; a
            # failure here fails the deploy
            for algorithm, model in zip(self._algorithms(engine_params, device), models):
                algorithm.warm_up(model)
        return models

    def shard_models(
        self,
        engine_params: EngineParams,
        models: Sequence[Any],
        shard: int,
        num_shards: int,
        device=None,
    ) -> list[Any]:
        """Per-algorithm :meth:`Algorithm.shard_model` over rehydrated
        models -- the deploy-side fallback when a registry generation has
        no per-shard blobs, and the publish-side partition step when the
        continuous-learning loop writes them. The algorithms are built on
        ``device`` (``cuda`` unless ``"cpu"``)."""
        if num_shards <= 1:
            return list(models)
        if not (0 <= shard < num_shards):
            raise ValueError(
                f"shard {shard} out of range for num_shards={num_shards}"
            )
        return [
            algorithm.shard_model(model, shard, num_shards)
            for algorithm, model in zip(self._algorithms(engine_params, device), models)
        ]

    # -- eval ---------------------------------------------------------------
    def eval(
        self, ctx, engine_params: EngineParams
    ) -> list[tuple[Any, list[tuple[Any, Any, Any]]]]:
        """Run evaluation folds on ``ctx.device``.

        Returns ``[(eval_info, [(query, prediction, actual), ...]), ...]``.
        """
        data_source = self.data_source_class(engine_params.data_source_params)
        preparator = self.preparator_class(engine_params.preparator_params)
        serving = self.serving(engine_params)
        folds = data_source.read_eval(ctx)
        results = []
        for training_data, eval_info, qa_pairs in folds:
            prepared_data = preparator.prepare(ctx, training_data)
            algorithms = self._algorithms(engine_params, getattr(ctx, "device", None))
            models = [a.train(ctx, prepared_data) for a in algorithms]
            indexed = list(enumerate(q for q, _ in qa_pairs))
            per_algo = [dict(a.batch_predict(m, indexed)) for a, m in zip(algorithms, models)]
            triples = []
            for qid, (query, actual) in enumerate(qa_pairs):
                predictions = [pa[qid] for pa in per_algo]
                triples.append((query, serving.serve(query, predictions), actual))
            results.append((eval_info, triples))
        return results


def _blob_entry(name: str) -> zipfile.ZipInfo:
    """A blob's zip entry, stamped with zip's epoch: a blob is a function
    of its models alone, never of the clock (a registry version's shard
    blobs equal its full blob byte for byte)."""
    return zipfile.ZipInfo(name, date_time=(1980, 1, 1, 0, 0, 0))


def _model_files(cls: Type[Algorithm], model) -> dict[str, bytes]:
    """The files ``cls.model_files`` writes for ``model``, by name."""
    with tempfile.TemporaryDirectory(prefix="pio-model-") as tmp:
        cls.model_files.save(model, tmp)
        out = {}
        for name in os.listdir(tmp):
            with open(os.path.join(tmp, name), "rb") as f:
                out[name] = f.read()
    return out


def _open_blob(blob: bytes) -> list[dict]:
    """The blob's entries, one per algorithm block, each with its
    ``source``: the ``BlobFolder`` of its files in the blob's zip; raises
    ``ModelBlobError`` for a bare pickle or a blob that is not the port's."""
    if blob[:1] == b"\x80":
        raise ModelBlobError(
            "this model blob is a bare pickle, written by the JAX package "
            "(predictionio_tpu); the port never unpickles a bare blob. Retrain it "
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
    if manifest.get("version") == 1:
        return [{"kind": "files", "algorithm": manifest.get("algorithm"),
                 "template": manifest.get("template"), "source": BlobFolder(zf, "")}]
    if manifest.get("version") != 2:
        raise ModelBlobError(f"unknown model blob version {manifest.get('version')!r}")
    return [dict(e, source=BlobFolder(zf, f"{i}/"))
            for i, e in enumerate(manifest["algorithms"])]


def _resolve_class(dotted: str):
    from predictionio_tpu_torch.workflow.json_extractor import resolve_dotted

    return resolve_dotted(dotted)
