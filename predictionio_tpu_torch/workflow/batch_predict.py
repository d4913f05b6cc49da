"""Batch predict: offline bulk scoring from a query file.

Port of ``predictionio_tpu/workflow/batch_predict.py`` (``pio
batchpredict``): JSON-lines queries in, JSON-lines predictions out,
through the deployed-equivalent model chain of an engine instance (the
latest COMPLETED one of the variant, or ``instance_id``): its models
(``Engine.prepare_deploy`` of its blob, with the params it was trained
with). Queries go through every algorithm's ``batch_predict`` in chunks
of 4,096 (on the card, one B2 launch a chunk for the known users of a
mips model, and none besides: the models are not warmed up), and each
query's predictions through the engine's Serving.

A chunk that raises is rescored one query at a time, and the trigger is
logged (reference ``:72-96``: one malformed query must not discard its
chunk's other results). One departure: only a query that the algorithm's
``query_from_json`` refuses becomes an ``{"query", "error"}`` row. A
query it accepts and that still fails to score failed on the model or
device side -- a kernel wrapper's refusal, a build or launch, the CUDA
runtime -- so the run raises instead of writing a chunk of error rows.
"""

from __future__ import annotations

import json
import logging

from predictionio_tpu_torch.controller.base import TrainContext
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.storage.base import STATUS_COMPLETED
from predictionio_tpu_torch.utils.device import resolve_device
from predictionio_tpu_torch.workflow.core_workflow import (
    engine_params_from_instance,
    resolve_engine_instance,
)
from predictionio_tpu_torch.workflow.json_extractor import EngineVariant, build_engine

logger = logging.getLogger("pio.batchpredict")

#: queries scored per batch_predict call (bounds the [chunk, items] score
#: matrix a vectorized algorithm materializes)
_CHUNK = 4096


def run_batch_predict(
    variant: EngineVariant,
    input_path: str,
    output_path: str,
    instance_id: str | None = None,
    *,
    device=None,
) -> int:
    """Score every JSON-lines query in ``input_path`` on ``device``
    (``cuda`` unless ``"cpu"``); returns the count of rows written."""
    engine = build_engine(variant)
    instance = resolve_engine_instance(variant, instance_id)
    if instance.status != STATUS_COMPLETED:
        raise LookupError(
            f"engine instance {instance.id!r} is {instance.status}, not COMPLETED"
        )
    engine_params = engine_params_from_instance(instance)
    blob = storage.get_model_data_models().get(instance.id)
    if blob is None:
        raise LookupError(f"engine instance {instance.id!r} has no model blob")
    ctx = TrainContext(device=resolve_device(device),
                       runtime_conf=dict(instance.runtime_conf or {}))
    # no warm-up: the first chunk builds the serving state (a deploy's
    # warm-up search only spares its first query the wait)
    models = engine.prepare_deploy(ctx, engine_params, instance.id, blob.models,
                                   warm_up=False)
    algorithms = engine._algorithms(engine_params, ctx.device)
    serving = engine.serving(engine_params)

    count = 0
    with open(input_path) as fin, open(output_path, "w") as fout:

        def score_one(obj) -> dict:
            try:
                queries = [a.query_from_json(obj) for a in algorithms]
            except Exception as exc:
                return {"query": obj, "error": str(exc)}
            # a failure past the query's own check is not the query's:
            # it fails the run
            predictions = [a.predict(m, q) for a, m, q in zip(algorithms, models, queries)]
            result = serving.serve(queries[0], predictions)
            return {"query": obj, "prediction": algorithms[0].result_to_json(result)}

        def flush(chunk_objs: list) -> None:
            nonlocal count
            if not chunk_objs:
                return
            # route through the batch_predict hook: a vectorized override
            # (ALS scores a chunk's known users in one search) gets its
            # batch shape
            try:
                per_algo, typed = [], None
                for a, m in zip(algorithms, models):
                    queries = [(i, a.query_from_json(obj)) for i, obj in enumerate(chunk_objs)]
                    typed = typed or queries
                    per_algo.append(dict(a.batch_predict(m, queries)))
                rows = [
                    {"query": obj, "prediction": algorithms[0].result_to_json(
                        serving.serve(typed[i][1], [results[i] for results in per_algo]))}
                    for i, obj in enumerate(chunk_objs)
                ]
            except Exception:
                # one malformed query must not discard the chunk's other
                # results: degrade to per-query scoring (only chunks
                # holding a failing query pay), recording an error row for
                # each query its parse refuses. Log the trigger
                logger.warning(
                    "batch scoring failed for a %d-query chunk; rescoring"
                    " per query",
                    len(chunk_objs),
                    exc_info=True,
                )
                rows = [score_one(obj) for obj in chunk_objs]
            for row in rows:
                fout.write(json.dumps(row) + "\n")
                count += 1
            chunk_objs.clear()

        chunk: list = []
        for line in fin:
            line = line.strip()
            if not line:
                continue
            chunk.append(json.loads(line))
            if len(chunk) >= _CHUNK:
                flush(chunk)
        flush(chunk)
    return count
