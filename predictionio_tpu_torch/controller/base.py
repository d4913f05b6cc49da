"""DASE component base classes.

Port of the parts of ``predictionio_tpu/controller/base.py`` that the
train, deploy, continuous-learning and evaluation paths need:
``Params``, ``EvalInfo``, ``SanityCheck``, ``DataSource``
(``read_training``, ``online_handle``, ``read_eval``, ``read_replay``),
``Preparator``, the ``Algorithm`` contract (train, fold-in, predict,
batch_predict, warm_up, shard_model and the wire serde) and ``Serving``
(``serve``, ``serve_batch``); plus ``TrainContext``, the port's small
stand-in for the reference's ``RuntimeContext`` (device, checkpoint
directory, resume, the runtime conf, and the training mesh, built
lazily from the runtime conf as the reference's ``:101-130`` does), and
``mesh_or_none`` (the reference's ``TPUAlgorithm.mesh_or_none``).
"""

from __future__ import annotations

import abc
import io
import logging
import os
import zipfile
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

logger = logging.getLogger("pio.torch.controller")


def open_model_file(source, name: str):
    """One file of a saved model, opened for binary reading: ``source``
    is the directory a template's ``save_model`` wrote, or an open
    ``zipfile.ZipFile`` of a model blob (``controller/engine.py``), read
    without unpacking it to disk."""
    if isinstance(source, zipfile.ZipFile):
        return io.BytesIO(source.read(name))
    return open(os.path.join(source, name), "rb")


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


class EvalInfo(Params):
    """Per-fold metadata returned by ``DataSource.read_eval``."""


class Component:
    """Shared construction: every DASE component takes its params dict."""

    def __init__(self, params: Mapping[str, Any] | None = None):
        self.params = params if isinstance(params, Params) else Params(params or {})


class SanityCheck(abc.ABC):
    """Optional post-stage hook (reference SanityCheck trait): raise to abort."""

    @abc.abstractmethod
    def sanity_check(self) -> None: ...


class DataSource(Component, abc.ABC):
    """Reads TrainingData (reference ``PDataSource.readTraining``)."""

    @abc.abstractmethod
    def read_training(self, ctx): ...

    def online_handle(self):
        """Describe this datasource's interaction scan for the
        continuous-learning loop (``pio retrain --follow``): a
        ``models._streaming.StreamingHandle`` carrying app/channel/
        event-name/rating-key identity, or None (default) when the
        datasource cannot be followed online."""
        return None

    def read_eval(self, ctx):
        """k-fold evaluation folds: ``[(training data, EvalInfo, [(query,
        actual), ...]), ...]``. Default: unsupported."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement read_eval; "
            "evaluation is unavailable for this engine"
        )

    def read_replay(self, ctx, spec):
        """Time-travel replay split (``pio eval --replay``): train on
        events strictly before the boundary, hold out interactions
        at-or-after it. ``spec`` is an ``eval.split.SplitSpec``; returns
        an ``eval.split.ReplayFold`` whose pairs are per-held-out-user
        ``(query, [actual item ids])``. Default: unsupported."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement read_replay; "
            "`pio eval --replay` is unavailable for this engine"
        )


class Preparator(Component, abc.ABC):
    @abc.abstractmethod
    def prepare(self, ctx, training_data): ...


class IdentityPreparator(Preparator):
    """Pass-through preparator (reference IdentityPreparator)."""

    def prepare(self, ctx, training_data):
        return training_data


@dataclass
class TrainContext:
    """What the train path needs from its caller: the ``device`` the fit
    runs on (``cuda`` unless ``"cpu"`` is named), a ``checkpoint_dir``
    for step checkpoints (None disables them) and ``resume``: continue
    from the checkpoints found there instead of discarding them.
    ``telemetry`` receives each ALS iteration's wall time
    (``record_step(iteration, seconds)``), each NCF epoch's wall time
    and step losses (``record_epoch(epoch, seconds, losses)``) and the
    seconds of NCF's negative sampling and epoch permutations with the
    examples they produce or permute (``record_phase(name, seconds,
    rows)``).
    ``mesh_shape`` is the engine.json's ``sparkConf["pio.mesh_shape"]``.
    ``run_key`` (a train from the store) keys the checkpoints by run, as
    the reference's ``RuntimeContext.checkpoint_manager`` does: an
    algorithm's go to ``checkpoint_dir/<name>-<run_key>``.
    ``runtime_conf`` is the variant's runtime conf (``sparkConf`` /
    ``runtimeConf`` and the verbs' ``pio.*`` keys), as the reference's
    ``RuntimeContext.runtime_conf``: ``pio.profile`` turns on each
    trainer's telemetry journal (``journal``), ``pio.snapshot_*`` the
    replay read's snapshot, and the launch keys (``pio.coordinator``,
    ``pio.num_processes``, ``pio.process_id``, else the ``PIO_*`` env)
    with ``pio.mesh_shape`` / ``pio.mesh_axes`` / ``pio.dcn_mesh_shape``
    the ``mesh``."""

    device: Any = None
    checkpoint_dir: str | None = None
    resume: bool = False
    telemetry: Any = None
    mesh_shape: Any = None
    run_key: str | None = None
    runtime_conf: dict = field(default_factory=dict)
    _mesh: Any = field(default=None, init=False, repr=False, compare=False)

    @property
    def mesh(self):
        """The training mesh (``parallel.mesh.Mesh``), built on first use:
        joins the launch's process group (``init_distributed``; none
        without a coordinator), then lays ``pio.mesh_shape`` (default
        ``[-1, 1]``: every rank on ``data``; ``mesh_shape`` when set) over
        ``pio.mesh_axes`` (default ``("data", "model")``) on this
        context's device, a hybrid mesh across hosts with
        ``pio.dcn_mesh_shape``. One process gets a 1 x 1 mesh. A failure
        raises: a launch never degrades to one process."""
        if self._mesh is None:
            from predictionio_tpu_torch.parallel.distributed import (
                build_mesh,
                init_distributed,
            )

            conf = self.runtime_conf
            maybe_int = lambda v: None if v is None else int(v)
            init_distributed(
                coordinator=conf.get("pio.coordinator"),
                num_processes=maybe_int(conf.get("pio.num_processes")),
                process_id=maybe_int(conf.get("pio.process_id")),
                device=self.device,
            )
            shape = self.mesh_shape if self.mesh_shape is not None else conf.get(
                "pio.mesh_shape", [-1, 1])
            self._mesh = build_mesh(
                list(shape), tuple(conf.get("pio.mesh_axes", ("data", "model"))),
                dcn_mesh_shape=conf.get("pio.dcn_mesh_shape"), device=self.device,
            )
        return self._mesh

    def checkpoint_manager(self, name: str):
        """The step-checkpoint manager of one algorithm, or None when the
        context has no checkpoint directory or this process is not rank 0
        of a multi-process launch (``workflow.checkpoint.owns_checkpoints``:
        a second writer on the key would corrupt rank 0's steps). A
        non-resume run discards whatever an earlier run left under the
        name."""
        from predictionio_tpu_torch.workflow.checkpoint import owns_checkpoints

        if self.checkpoint_dir is None or not owns_checkpoints(self.runtime_conf):
            return None
        from predictionio_tpu_torch.workflow.checkpoint import CheckpointManager

        key = name if self.run_key is None else f"{name}-{self.run_key}"
        return CheckpointManager(
            os.path.join(self.checkpoint_dir, key), fresh=not self.resume
        )

    @contextmanager
    def journal(self, name: str, fields=None):
        """The telemetry one trainer records into: ``telemetry`` when the
        caller gave one; else, on a profiled run (``pio.profile`` in
        ``runtime_conf``), a ``TrainTelemetry`` journal at
        ``<profile-dir>/<name>-telemetry.jsonl``, closed on exit; else
        None, so an un-profiled loop pays no per-step device sync.
        ``fields()`` (called only for a journal) returns its extra
        ``TrainTelemetry`` arguments (``edges``,
        ``modeled_bytes_per_iter``, ``meta`` entries beside ``name`` and
        ``platform``). A journal that cannot be set up is logged and
        training goes on without it."""
        if self.telemetry is not None:
            yield self.telemetry
            return
        profile_dir = self.runtime_conf.get("pio.profile")
        journal = None
        if profile_dir:
            try:
                from predictionio_tpu_torch.obs.telemetry import TrainTelemetry
                from predictionio_tpu_torch.utils.device import resolve_device

                extra = dict(fields() if fields is not None else {})
                platform = "cpu" if resolve_device(self.device).type == "cpu" else "gpu"
                journal = TrainTelemetry(
                    os.path.join(str(profile_dir), f"{name}-telemetry.jsonl"),
                    meta={"name": name, "platform": platform, **extra.pop("meta", {})},
                    **extra,
                )
            except Exception:
                # telemetry must never fail a training run
                logger.warning("profile telemetry setup failed", exc_info=True)
        try:
            yield journal
        finally:
            if journal is not None:
                journal.close()


def mesh_or_none(ctx):
    """``ctx.mesh``, or None for a context without one (a caller passing
    no context, or an object that is not a ``TrainContext``). Unlike the
    reference's, a mesh that fails to build raises: a misconfigured
    launch must not quietly train each rank alone."""
    if getattr(type(ctx), "mesh", None) is None:
        return None
    return ctx.mesh


class Algorithm(Component, abc.ABC):
    """Algorithm contract: train on prepared data, answer queries."""

    supports_fold_in: bool = False

    @abc.abstractmethod
    def train(self, ctx: TrainContext, prepared_data): ...

    def fold_in(self, model, delta):
        """Incrementally absorb a delta window (``online.foldin.
        FoldinDelta``) into ``model``, returning a NEW model (the swap
        protocol needs immutability -- never mutate the argument) or None
        when the window holds nothing to absorb. May raise
        ``online.foldin.StalenessExceeded`` to demand a full retrain."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement fold_in"
        )

    @abc.abstractmethod
    def predict(self, model, query): ...

    def batch_predict(self, model, queries: Sequence[tuple[Any, Any]]) -> list:
        """Default: loop predict. Override with a vectorized version."""
        return [(qid, self.predict(model, q)) for qid, q in queries]

    def warm_up(self, model) -> None:
        """Called once at deploy, before the first query: build serving
        caches (device-resident tables) here."""

    def shard_model(self, model, shard: int, num_shards: int):
        """Restrict ``model`` to the user partition ``serving.shardmap.
        shard_of(user, num_shards) == shard`` owns, returning a NEW model
        (the swap protocol needs immutability). Item-side and other
        replicated state must stay intact: every shard answers userless /
        item-only queries identically, and a query routed to the owning
        shard must be answered byte-for-byte as the unsharded model would.

        Default: return the model unchanged (full replication) -- correct
        for any algorithm, it just forgoes the memory win.
        """
        return model

    def query_from_json(self, obj: Any) -> Any:
        """Deserialize a /queries.json body. Default: pass the dict through."""
        return obj

    def result_to_json(self, prediction: Any) -> Any:
        """Serialize a prediction for the wire. Default: JSON-able as-is."""
        return prediction


class Serving(Component, abc.ABC):
    @abc.abstractmethod
    def serve(self, query, predictions: Sequence): ...

    def serve_batch(self, queries: Sequence, predictions: Sequence[Sequence]) -> list:
        """Combine per-algorithm predictions for a whole micro-batch.

        ``predictions[i]`` holds query ``i``'s per-algorithm predictions
        (same shape ``serve`` receives). Default: loop ``serve``. Override
        when the combination itself vectorizes; the query server falls
        back to per-query ``serve`` if this raises, so an override only
        needs to handle the all-good path.
        """
        return [self.serve(q, preds) for q, preds in zip(queries, predictions)]
