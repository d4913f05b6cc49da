"""Offline replay evaluation: the `pio eval --replay` core.

Port of ``predictionio_tpu/eval/replay.py`` over the port's templates
(``controller/engine.py::Template``). Replays a time-bounded event
prefix through the DASE hooks: the datasource's ``read_replay`` cuts
the timeline (train ``< t``, holdout ``>= t`` -- ``eval.split``), the
algorithm trains on the prefix (or a pinned registry generation is
rehydrated instead), EVERY held-out user is scored through the
template's vectorized ``batch_predict`` in one pass (B2 on the card
with ``retrieval: {"mode": "mips"}``; the engine.json's first algorithm
block, served through ``FirstServing``, as a deploy serves it), and the
ranked lists reduce to hit-rate@k / NDCG@k / MRR / recall@k
(``eval.metrics``). The fold's
training data carries the ``eval_fold`` flag, so a ``seenFilter:
"live"`` variant keeps the trained-in seen map, exactly as the k-fold
evaluator does.

The report also carries the standing retrieval guard: the scan and mips
arms re-rank the same split with the same model, reporting shortlist
recall@k and the response byte-identity rate -- the accuracy trip-wire
for every speed change to B2.

Everything runs on ``device`` (``cuda`` unless ``"cpu"``).
"""

from __future__ import annotations

import json
import logging
from typing import Any

from predictionio_tpu_torch.controller.base import TrainContext
from predictionio_tpu_torch.controller.engine import (
    EngineParams,
    batch_serve,
    first_algorithm,
    load_serving_model,
)
from predictionio_tpu_torch.eval.metrics import ranking_metrics, select_metrics
from predictionio_tpu_torch.eval.split import ReplayFold, SplitSpec
from predictionio_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("pio.eval")


def _ranked_ids(response: Any, k: int) -> list[str]:
    """A served response -> its ranked item ids (responses lacking
    ``itemScores`` rank nothing, i.e. score as a total miss)."""
    if not isinstance(response, dict):
        return []
    return [s["item"] for s in response.get("itemScores") or []][:k]


def _load_registry_models(template, variant, model_version, registry_dir, device):
    """Rehydrate a pinned registry generation -- the `pio deploy
    --model-version` resolution path (``load_serving_model``), so eval
    lineage names the exact bytes a rollback would serve. Raises
    ``RegistryError`` verbatim on a missing/GC'd/corrupt version, and
    ``ModelBlobError`` on a blob the port does not deploy (a pickle of
    the JAX package)."""
    from predictionio_tpu_torch.online.registry import ModelRegistry
    from predictionio_tpu_torch.workflow.core_workflow import (
        engine_params_from_instance,
        resolve_engine_instance,
    )

    registry = ModelRegistry.for_variant(variant, registry_dir=registry_dir)
    entry = registry.get(int(model_version))
    blob = entry.load_blob()  # CRC-verified
    params_obj = entry.engine_params_obj
    engine_params = (
        EngineParams.from_json_obj(params_obj)
        if params_obj
        else engine_params_from_instance(
            resolve_engine_instance(variant, entry.instance_id or None)
        )
    )
    algorithm, model = load_serving_model(template, engine_params, blob, device=device)
    lineage = {
        "source": "registry",
        "model_version": entry.version,
        "registry_source": entry.source,
        "instance_id": entry.instance_id or None,
        "registry_dir": registry.dir,
    }
    return engine_params, algorithm, model, lineage


def _retrieval_guard(template, engine_params, model, queries, k, device) -> dict | None:
    """Scan-vs-mips A/B on the SAME model and split: shortlist recall@k
    (overlap of the mips top-k with the scan top-k) and the response
    byte-identity rate. None when the primary algorithm has no
    retrieval surface (e.g. NCF's MLP scorer)."""
    _, algo_params = engine_params.algorithm_params_list[0]
    arms, shortlist = {}, None
    for mode in ("scan", "mips"):
        params = dict(algo_params)
        retrieval = dict(params.get("retrieval") or {})
        retrieval["mode"] = mode
        params["retrieval"] = retrieval
        arm_algo = template.algorithm_class(params, device=device)
        if not hasattr(arm_algo, "_retrieval"):
            return None
        arms[mode] = batch_serve(arm_algo, model, queries)
        if mode == "mips":
            shortlist = int(arm_algo._retrieval.shortlist)
    overlaps, identical, compared = [], 0, 0
    for qid in range(len(queries)):
        scan_ids = _ranked_ids(arms["scan"][qid], k)
        mips_ids = _ranked_ids(arms["mips"][qid], k)
        if not scan_ids:
            continue  # nothing to retrieve for this user in either arm
        compared += 1
        overlaps.append(len(set(scan_ids) & set(mips_ids)) / len(scan_ids))
        if json.dumps(arms["scan"][qid], sort_keys=True) == json.dumps(
            arms["mips"][qid], sort_keys=True
        ):
            identical += 1
    return {
        f"shortlist_recall_at_{k}": (
            round(sum(overlaps) / len(overlaps), 6) if overlaps else None
        ),
        "response_identity_rate": (
            round(identical / compared, 6) if compared else None
        ),
        "users_compared": compared,
        "shortlist": shortlist,
    }


def run_replay_eval(
    variant,
    *,
    split_time: str | None = None,
    split_frac: float | None = None,
    k: int = 10,
    metrics=None,
    model_version: int | None = None,
    registry_dir: str | None = None,
    retrieval_guard: bool = True,
    include_responses: bool = False,
    device=None,
) -> dict:
    """Run one replay evaluation on ``device``; returns the JSON-able
    report.

    Without ``model_version`` the algorithm trains on the prefix
    in-process (no instance row, no model blob -- evaluation owns no
    persistence side effects); with it, the pinned registry generation
    is rehydrated and scored against the same holdout, and the report's
    lineage block names the manifest it came from.

    Raises ``ValueError`` (bad spec / unknown metric / empty prefix / a
    blob the port does not deploy), ``NotImplementedError`` (a
    datasource without ``read_replay``), or
    ``online.registry.RegistryError`` (missing/corrupt pinned version);
    the CLI maps each onto the exit-2 contract.
    """
    names = select_metrics(metrics)
    if split_time is None and split_frac is None:
        split_frac = 0.8
    spec = SplitSpec(split_time=split_time, split_frac=split_frac, k=int(k))
    spec.validate()
    template = variant.template
    engine_params = variant.engine_params
    device = resolve_device(device)
    ctx = TrainContext(device=device, runtime_conf=dict(variant.runtime_conf),
                       mesh_shape=variant.runtime_conf.get("pio.mesh_shape"))

    data_source = template.datasource_class(engine_params.data_source_params)
    fold: ReplayFold = data_source.read_replay(ctx, spec)
    pairs = fold.pairs

    if model_version is not None:
        engine_params, algorithm, model, lineage = _load_registry_models(
            template, variant, model_version, registry_dir, device
        )
    else:
        fold.train_data.sanity_check()
        preparator = template.preparator_class(engine_params.preparator_params)
        prepared = preparator.prepare(ctx, fold.train_data)
        algorithm = first_algorithm(template, engine_params, device)
        model = algorithm.train(ctx, prepared)
        lineage = {"source": "replay-train", "model_version": None,
                   "instance_id": None}

    queries = [q for q, _ in pairs]
    responses = batch_serve(algorithm, model, queries)
    predicted = [_ranked_ids(r, spec.k) for r in responses]
    actual = [a for _, a in pairs]
    values = ranking_metrics(predicted, actual, spec.k, names)

    guard = None
    if retrieval_guard:
        guard = _retrieval_guard(template, engine_params, model, queries, spec.k, device)

    def _key(name: str) -> str:
        return "mrr" if name == "mrr" else f"{name}_at_{spec.k}"

    report = {
        "engine": variant.variant_id,
        "engine_variant": variant.path,
        "k": spec.k,
        "metrics": {
            _key(n): (round(v, 6) if v is not None else None)
            for n, v in values.items()
        },
        "split": fold.bounds.to_json_obj() if fold.bounds else None,
        "model": lineage,
        "retrieval_guard": guard,
    }
    if include_responses:
        report["responses"] = responses
        report["actual"] = [list(map(str, a)) for a in actual]
        report["queries"] = queries
    return report
