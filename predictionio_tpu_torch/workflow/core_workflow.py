"""The train and evaluation workflows and their instance records.

Counterpart of ``predictionio_tpu/workflow/core_workflow.py``
(``run_train`` ``:75-256``, ``run_evaluation`` ``:257-295``,
``resolve_engine_instance`` and ``engine_params_from_instance``
``:297-328``), over the port's templates (``controller/engine.py``):

- ``run_train``: the ``pio train`` core. An engine instance is recorded
  RUNNING, then COMPLETED with the model blob in the model repository
  (``Models``, keyed by the instance id), or FAILED when a stage raises.
  The instance holds what the reference's holds: the variant's identity,
  its params as JSON, the ``PIO_*`` environment and the runtime conf.
  Trains of one run key (variant + full params) are serialized by a
  ``RunLock``; their step checkpoints live under
  ``$PIO_FS_BASEDIR/checkpoints/<algorithm>-<run key>`` and are cleared
  once the blob is recorded. ``resume`` reuses the variant's latest
  instance that did not complete, and only when its params equal the
  run's; otherwise the train starts fresh. With ``pio.profile`` in the
  runtime conf (``pio train --profile``) training runs under a
  ``torch.profiler`` trace written into that directory as a Chrome trace
  (``<instance id>.pt.trace.json``, loadable in Perfetto or
  ``chrome://tracing``; CPU and CUDA activity on the card, CPU alone on
  ``device="cpu"``), where the reference opens ``jax.profiler.trace``;
  each trainer writes its journal beside it (``TrainContext.journal``:
  ``als-telemetry.jsonl`` a line per iteration, ``ncf-`` and
  ``sasrec-telemetry.jsonl`` a line per epoch).
- ``run_evaluation``: the ``pio eval`` core. An evaluation instance is
  recorded RUNNING, then COMPLETED with the ``MetricEvaluator``
  leaderboard (text, JSON, HTML), or FAILED when a stage raises.
- ``resolve_engine_instance``: the latest COMPLETED instance of a
  variant, or an explicit id (what ``deploy`` loads).
- ``load_instance_model``: that instance's blob, through the template's
  ``load_model``.

A multi-process launch (``PIO_COORDINATOR`` / ``PIO_NUM_PROCESSES`` /
``PIO_PROCESS_ID`` on every process, or the ``pio.*`` keys, reference
``:104-124``): every rank runs ``pio train`` and joins every collective
of the fit, and rank 0 alone takes the run lock and writes the engine
instance, the step checkpoints and the model blob. Another rank trains,
persists nothing, and returns an unrecorded COMPLETED instance. The
launch-scoped keys never reach the persisted runtime conf or env.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import json
import logging
import os
import time
import traceback
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass

from predictionio_tpu_torch.controller.base import TrainContext
from predictionio_tpu_torch.controller.engine import (
    EngineParams,
    deserialize_model,
    serialize_model,
)
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.storage.base import (
    STATUS_COMPLETED,
    STATUS_FAILED,
    STATUS_RUNNING,
    EngineInstance,
    EvaluationInstance,
    Model,
)
from predictionio_tpu_torch.obs.trace import global_tracer
from predictionio_tpu_torch.parallel.distributed import (
    LAUNCH_SCOPED_ENV,
    launch_process_id,
    strip_launch_conf,
)
from predictionio_tpu_torch.workflow.checkpoint import (
    RunLock,
    _checkpoint_base,
    clear_run_checkpoints,
)
from predictionio_tpu_torch.workflow.json_extractor import EngineVariant

logger = logging.getLogger("pio.workflow")

@dataclass
class WorkflowParams:
    """Train-workflow knobs (the reference's ``WorkflowParams`` fields
    that train uses)."""

    batch: str = ""
    skip_sanity_check: bool = False
    #: `pio train --resume`: reuse the variant's latest non-COMPLETED
    #: engine instance and continue from its step checkpoints
    resume: bool = False


def _utcnow() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def _pio_env() -> dict[str, str]:
    """PIO_* env snapshot persisted on instances -- minus launch identity."""
    return {
        k: v
        for k, v in os.environ.items()
        if k.startswith("PIO_") and k not in LAUNCH_SCOPED_ENV
    }


def _run_key(variant: EngineVariant, params_jsons: tuple[str, ...]) -> str:
    """Stable checkpoint key: same variant + same FULL params (datasource,
    preparator, algorithms, serving) -> same key, so a rerun after a
    crash locates the crashed attempt's checkpoints; any params change ->
    another key, so checkpoints of other data or hyperparameters never
    cross-resume."""
    material = "\x1f".join(
        (variant.variant_id, variant.engine_version, variant.path, *params_jsons)
    )
    return hashlib.sha256(material.encode()).hexdigest()[:16]


def _params_jsons(engine_params: EngineParams) -> tuple[str, str, str, str]:
    return (
        json.dumps(dict(engine_params.data_source_params)),
        json.dumps(dict(engine_params.preparator_params)),
        json.dumps(
            [
                {"name": n, "params": dict(p)}
                for n, p in engine_params.algorithm_params_list
            ]
        ),
        json.dumps(dict(engine_params.serving_params)),
    )


def build_components(variant: EngineVariant, *, device=None, events_path: str | None = None):
    """``(template, datasource, preparator, algorithm)`` of the variant:
    the template's classes with the engine.json's params, the first
    algorithm's. The DataSource reads the store, or ``events_path`` when
    given. The algorithm resolves the device, so without a card and
    without ``device="cpu"`` this raises."""
    template = variant.template
    params = variant.engine_params
    algorithm = template.algorithm_class(
        params.algorithm_params_list[0][1], device=device
    )
    datasource = template.datasource_class(
        params.data_source_params, events_path=events_path
    )
    preparator = template.preparator_class(params.preparator_params)
    return template, datasource, preparator, algorithm


def train_model(ctx: TrainContext, datasource, preparator, algorithm, *,
                skip_sanity_check: bool = False, timings: dict | None = None):
    """Read -> sanity check -> prepare -> ``Algorithm.train``; the stage
    seconds land in ``timings`` (``read_s``, ``prepare_s``, ``train_s``)
    when given."""
    t0 = time.perf_counter()
    data = datasource.read_training(ctx)
    if not skip_sanity_check:
        data.sanity_check()
    t1 = time.perf_counter()
    prepared = preparator.prepare(ctx, data)
    t2 = time.perf_counter()
    model = algorithm.train(ctx, prepared)
    if timings is not None:
        timings.update(read_s=t1 - t0, prepare_s=t2 - t1,
                       train_s=time.perf_counter() - t2)
    return model


def run_train(
    variant: EngineVariant,
    workflow_params: WorkflowParams | None = None,
    *,
    device=None,
    telemetry=None,
    timings: dict | None = None,
) -> EngineInstance:
    """The `pio train` core: returns the COMPLETED EngineInstance.

    Raises after recording FAILED status if any stage throws. ``device``
    is where training runs (``cuda`` unless ``"cpu"``); ``telemetry`` is
    handed to the algorithm (``TrainContext``); ``timings`` (a dict) is
    filled with the ``read_s``, ``prepare_s``, ``train_s`` and
    ``persist_s`` seconds of the run.
    """
    workflow_params = workflow_params or WorkflowParams()
    components = build_components(variant, device=device)
    if launch_process_id(variant.runtime_conf) != 0:
        # multi-process launch, non-primary rank: run the training compute
        # (every rank must take part in the collectives) but own NO
        # persistence side effects -- no run lock (ranks on one host share
        # PIO_FS_BASEDIR), no instance row, no step checkpoints, no model
        # blob. Rank 0 is the system of record.
        template, datasource, preparator, algorithm = components
        ctx = TrainContext(
            device=algorithm.device, resume=workflow_params.resume,
            telemetry=telemetry, mesh_shape=variant.runtime_conf.get("pio.mesh_shape"),
            runtime_conf=dict(variant.runtime_conf),
        )
        start = _utcnow()
        train_model(ctx, datasource, preparator, algorithm,
                    skip_sanity_check=workflow_params.skip_sanity_check, timings=timings)
        return EngineInstance(
            status=STATUS_COMPLETED,
            start_time=start,
            end_time=_utcnow(),
            engine_id=variant.variant_id,
            engine_version=variant.engine_version,
            engine_variant=variant.path,
            engine_factory=variant.engine_factory,
        )
    params_jsons = _params_jsons(variant.engine_params)
    run_key = _run_key(variant, params_jsons)
    # serialize trains sharing this run_key: a second identical train would
    # wipe the first's live step checkpoints and --resume would adopt its
    # still-RUNNING instance (raises RunLockHeld when the holder is alive)
    run_lock = RunLock(run_key).acquire()
    try:
        return _run_train_locked(
            variant, workflow_params, components, params_jsons, run_key,
            telemetry, timings,
        )
    finally:
        run_lock.release()


def _run_train_locked(variant, workflow_params, components, params_jsons, run_key,
                      telemetry, timings) -> EngineInstance:
    template, datasource, preparator, algorithm = components
    instances = storage.get_meta_data_engine_instances()
    ds_json, prep_json, algorithms_params_json, serving_json = params_jsons
    instance = None
    resume = False
    if workflow_params.resume:
        prior = instances.get_latest(
            variant.variant_id, variant.engine_version, variant.path
        )
        if prior is not None and prior.status != STATUS_COMPLETED:
            # the FULL params must match: factors checkpointed against
            # other data would misalign with the new id vocabulary
            prior_params = (
                prior.data_source_params,
                prior.preparator_params,
                prior.algorithms_params,
                prior.serving_params,
            )
            if prior_params == params_jsons:
                instance = prior
                instance.status = STATUS_RUNNING
                instance.end_time = None
                instances.update(instance)
                resume = True
                logger.info(
                    "resuming engine instance %s (was %s)", prior.id, prior.status
                )
            else:
                logger.warning(
                    "--resume requested but params changed since instance %s;"
                    " starting fresh",
                    prior.id,
                )
    if instance is None:
        instance = EngineInstance(
            status=STATUS_RUNNING,
            start_time=_utcnow(),
            engine_id=variant.variant_id,
            engine_version=variant.engine_version,
            engine_variant=variant.path,
            engine_factory=variant.engine_factory,
            batch=workflow_params.batch,
            env=_pio_env(),
            runtime_conf=strip_launch_conf(variant.runtime_conf),
            data_source_params=ds_json,
            preparator_params=prep_json,
            algorithms_params=algorithms_params_json,
            serving_params=serving_json,
        )
        instances.insert(instance)
    instance_id = instance.id
    profile_dir = variant.runtime_conf.get("pio.profile")
    ctx = TrainContext(
        device=algorithm.device,
        checkpoint_dir=_checkpoint_base(),
        resume=resume,
        telemetry=telemetry,
        mesh_shape=variant.runtime_conf.get("pio.mesh_shape"),
        run_key=run_key,
        runtime_conf=dict(variant.runtime_conf),
    )
    tracer = global_tracer()
    timings = {} if timings is None else timings
    try:
        trace_ctx = (
            profile_trace(profile_dir, algorithm.device, instance_id)
            if profile_dir else nullcontext()
        )
        with trace_ctx, tracer.span(
            "train.run",
            attrs={"instance": instance_id, "engine": variant.variant_id},
        ):
            model = train_model(
                ctx, datasource, preparator, algorithm,
                skip_sanity_check=workflow_params.skip_sanity_check, timings=timings,
            )
        t0 = time.perf_counter()
        with tracer.span("train.persist", attrs={"instance": instance_id}):
            storage.get_model_data_models().insert(
                Model(id=instance_id, models=serialize_model(template, model))
            )
        timings["persist_s"] = time.perf_counter() - t0
        instance.status = STATUS_COMPLETED
        instance.end_time = _utcnow()
        instances.update(instance)
        # model persisted -> step checkpoints are dead weight (and must not
        # silently resume into a later from-scratch retrain)
        clear_run_checkpoints(run_key)
        logger.info("training finished: instance %s", instance_id)
        return instance
    except Exception:
        instance.status = STATUS_FAILED
        instance.end_time = _utcnow()
        instances.update(instance)
        logger.error("training FAILED: instance %s\n%s", instance_id, traceback.format_exc())
        raise


def profiler_activities(device) -> list:
    """``torch.profiler`` activities of a run on ``device``: CPU and CUDA
    on the card, CPU alone on the CPU (the run's own device, never a
    probe for a card)."""
    import torch

    from predictionio_tpu_torch.utils.device import resolve_device

    activities = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


@contextmanager
def profile_trace(profile_dir: str, device, name: str):
    """Run the body under a ``torch.profiler`` trace of ``device``'s
    activities and write it to ``<profile_dir>/<name>.pt.trace.json``
    (Chrome trace JSON: Perfetto, ``chrome://tracing``). Yields the
    trace file's path. The trace is written even when the body raises."""
    import torch

    os.makedirs(str(profile_dir), exist_ok=True)
    path = os.path.join(str(profile_dir), f"{name}.pt.trace.json")
    prof = torch.profiler.profile(activities=profiler_activities(device))
    prof.start()
    try:
        yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)


def run_evaluation(
    evaluation,
    generator,
    evaluation_class: str = "",
    generator_class: str = "",
    runtime_conf: dict | None = None,
    batch: str = "",
    *,
    device=None,
) -> EvaluationInstance:
    """The `pio eval` core: the ``MetricEvaluator`` grid run of
    ``evaluation`` (``controller/metrics.py``) over ``generator``'s
    candidates on ``device`` (``cuda`` unless ``"cpu"``), its leaderboard
    persisted on an evaluation instance (RUNNING -> COMPLETED, or FAILED
    when a stage raises)."""
    from predictionio_tpu_torch.controller.metrics import MetricEvaluator
    from predictionio_tpu_torch.utils.device import resolve_device

    instances = storage.get_meta_data_evaluation_instances()
    instance = EvaluationInstance(
        status=STATUS_RUNNING,
        start_time=_utcnow(),
        evaluation_class=evaluation_class,
        engine_params_generator_class=generator_class,
        batch=batch,
        env=_pio_env(),
    )
    instance_id = instances.insert(instance)
    ctx = TrainContext(device=resolve_device(device),
                       runtime_conf=dict(runtime_conf or {}))
    try:
        result = MetricEvaluator(evaluation).run(ctx, generator)
        metric, extras = evaluation.metric, evaluation.metrics
        instance.status = STATUS_COMPLETED
        instance.end_time = _utcnow()
        instance.evaluator_results = result.leaderboard(metric, extras)
        instance.evaluator_results_json = result.to_json(metric, extras)
        instance.evaluator_results_html = (
            "<pre>" + result.leaderboard(metric, extras) + "</pre>"
        )
        instances.update(instance)
        logger.info("evaluation finished: instance %s", instance_id)
        return instance
    except Exception:
        instance.status = STATUS_FAILED
        instance.end_time = _utcnow()
        instances.update(instance)
        raise


def resolve_engine_instance(
    variant: EngineVariant, instance_id: str | None = None
) -> EngineInstance:
    """Latest COMPLETED instance for this variant (or an explicit id) --
    the deploy-time resolution step of reference CreateServer."""
    instances = storage.get_meta_data_engine_instances()
    if instance_id:
        instance = instances.get(instance_id)
        if instance is None:
            raise LookupError(f"engine instance {instance_id!r} not found")
        return instance
    instance = instances.get_latest_completed(
        variant.variant_id, variant.engine_version, variant.path
    )
    if instance is None:
        raise LookupError(
            f"no COMPLETED training of engine variant {variant.variant_id!r}"
            f" ({variant.path}); run `pio train` first"
        )
    return instance


def engine_params_from_instance(instance: EngineInstance) -> EngineParams:
    """Reconstruct the EngineParams a training run used (deploy fidelity)."""
    return EngineParams.from_json_obj(
        {
            "datasource": {"params": json.loads(instance.data_source_params)},
            "preparator": {"params": json.loads(instance.preparator_params)},
            "algorithms": json.loads(instance.algorithms_params),
            "serving": {"params": json.loads(instance.serving_params)},
        }
    )


def load_instance_model(variant: EngineVariant, instance_id: str | None = None):
    """``(instance, model)``: the resolved instance and its model, read
    from the model repository through the variant's template."""
    instance = resolve_engine_instance(variant, instance_id)
    if instance.status != STATUS_COMPLETED:
        raise LookupError(
            f"engine instance {instance.id!r} is {instance.status}, not COMPLETED"
        )
    record = storage.get_model_data_models().get(instance.id)
    if record is None:
        raise LookupError(f"engine instance {instance.id!r} has no model blob")
    return instance, deserialize_model(variant.template, record.models)
