"""The ``pio retrain --follow`` cycle: tail -> refresh -> fold-in -> swap.

Port of ``predictionio_tpu/online/loop.py`` over the variant's
``Engine``: the loop holds the engine's algorithms and their models,
rehydrated from the registry's latest version or from the engine
instance's blob through ``Engine.prepare_deploy``, and publishes
``Engine.serialize_models``' pickle-free zip. Each algorithm folds in
(``fold_in``; ALS's launches B1 once on ``cuda``, ``online/foldin.py``);
a window that an algorithm without the hook would have to absorb
escalates to a full retrain, the port's ``run_train`` from the store on
the loop's device. NCF, which has no ``fold_in`` hook, escalates every
window; SASRec's datasource describes no interaction scan, so its loop
is refused -- as the reference's are. ``scorer_shards > 1`` also
publishes per-shard blobs (``Engine.shard_models``, each through
``serialize_models``) for the serving fabric's swap path
(``serving/fabric.py``): a fold-in re-serializes only the shards that
own touched users and carries every other shard's bytes forward
verbatim; item growth, or a full retrain, recomputes every shard.

One iteration (:meth:`RetrainLoop.run_once`):

1. **tail** -- read the ingest WAL records in ``(cursor, storage
   checkpoint]`` (``online.follower``). Nothing new -> idle. A GC gap
   (follower was down past segment retention) -> resync: proceed with the
   window anchored at the cursor's snapshot bound.
2. **refresh** -- ``SnapshotStore.ensure(mode="refresh", until=now)``
   extends the columnar generation by exactly the uncovered scan window
   (``data/snapshot`` exactness rules apply: late/deleted rows force a
   rebuild, which fold-in tolerates because it maps entities by STRING id
   and re-solves from full history).
3. **fold-in** -- each algorithm's ``fold_in`` hook re-solves the touched
   user rows against frozen item factors (``online.foldin``); the
   staleness budget escalates to a FULL ``run_train`` when the delta
   outgrew the approximation.
4. **publish + swap** -- the new model serializes into the versioned
   registry (``online.registry``), then every ``--notify`` query server
   hot-swaps via ``POST /models/swap`` (the swap-epoch protocol in
   ``workflow/create_server``: in-flight batches finish on the old
   handle, zero dropped or mixed-version requests).
5. **advance** -- ONLY after publish + swap does the durable cursor move.
   A crash (SIGKILL included) at any earlier point replays the same
   window next run; fold-in's full-history re-solve makes that replay
   converge instead of double-applying.

Against a partitioned WAL (``--wal-partitions P``) step 1 becomes P
concurrent tail polls with one durable cursor each; their deltas merge
(touched-row/vocab union, window = min across partitions) into the ONE
refresh + fold-in + publish of steps 2-4, and step 5 advances each
participating cursor independently. A partition whose poll fails -- or
whose records are all future-dated -- is excluded from the merge alone:
its cursor holds and its window replays on recovery, while the siblings
keep publishing.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
import threading
import time
import urllib.request
from dataclasses import dataclass, field

from predictionio_tpu_torch.controller.base import TrainContext
from predictionio_tpu_torch.controller.engine import EngineParams
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.snapshot import (
    SnapshotSpec,
    SnapshotStore,
    snapshot_settings,
)
from predictionio_tpu_torch.data.storage.sql_common import ts_ms
from predictionio_tpu_torch.online.foldin import (
    FoldinDelta,
    StalenessBudget,
    StalenessExceeded,
)
from predictionio_tpu_torch.online.follower import (
    TailCursor,
    merge_batches,
    partition_tails,
)
from predictionio_tpu_torch.online.registry import ModelRegistry
from predictionio_tpu_torch.utils.device import resolve_device
from predictionio_tpu_torch.utils.metrics import global_registry
from predictionio_tpu_torch.workflow.core_workflow import (
    engine_params_from_instance,
    resolve_engine_instance,
    run_train,
)
from predictionio_tpu_torch.workflow.json_extractor import build_engine

logger = logging.getLogger("pio.online.loop")


@dataclass
class RetrainConfig:
    """Knobs of ``pio retrain [--follow]``."""

    interval_s: float = 2.0
    wal_dir: str | None = None          # default $PIO_FS_BASEDIR/wal
    registry_dir: str | None = None     # default $PIO_FS_BASEDIR/registry
    registry_keep: int = 5
    #: query servers to hot-swap after each publish; empty = batch mode
    #: (publishing IS the reflection boundary, e.g. feeding `pio deploy
    #: --model-version` restarts)
    notify_urls: list[str] = field(default_factory=list)
    budget: StalenessBudget = field(default_factory=StalenessBudget)
    #: 0 = run until stopped; tests and `pio retrain` (no --follow) bound it
    max_cycles: int = 0
    swap_timeout_s: float = 30.0
    #: escalation switch: False turns StalenessExceeded into a logged skip
    #: (for operators who schedule full retrains out of band)
    allow_full_retrain: bool = True
    #: publish per-shard model blobs (the `pio deploy --scorer-shards N`
    #: fabric's swap path) alongside the full blob; fold-in recomputes
    #: only the shards whose users were touched and carries the rest of
    #: the bytes forward verbatim. 0 = full blob only.
    scorer_shards: int = 0


class RetrainLoop:
    """Owns the follower cursor, the base model state, and the cycle."""

    def __init__(self, variant, config: RetrainConfig | None = None, *,
                 device=None, engine=None):
        self.variant = variant
        self.config = config or RetrainConfig()
        #: fold-ins and full retrains run here: ``cuda`` unless "cpu"
        self.device = resolve_device(device)
        self.engine = engine or build_engine(variant)
        self.registry = ModelRegistry.for_variant(
            variant,
            registry_dir=self.config.registry_dir,
            keep=self.config.registry_keep,
        )
        self._stop = threading.Event()

        self.instance = resolve_engine_instance(variant)
        base = self.registry.latest()
        if base is not None and base.engine_params_obj:
            self.engine_params = EngineParams.from_json_obj(base.engine_params_obj)
            blob = base.load_blob()
            base_until_ms = int(base.manifest.get("until_ms", 0))
            self.current_version = base.version
            logger.info(
                "resuming from registry version %d (%s)", base.version,
                base.source,
            )
        else:
            self.engine_params = engine_params_from_instance(self.instance)
            record = storage.get_model_data_models().get(self.instance.id)
            if record is None:
                raise LookupError(
                    f"engine instance {self.instance.id!r} has no model blob"
                )
            blob = record.models
            base_until_ms = ts_ms(self.instance.start_time)
            self.current_version = None
        self.ctx = TrainContext(device=self.device,
                                runtime_conf=dict(self.instance.runtime_conf or {}))
        # the loop folds, it does not serve: no serving state is built
        self.models = self.engine.prepare_deploy(
            self.ctx, self.engine_params, self.instance.id, blob, warm_up=False
        )
        self.algorithms = self.engine._algorithms(self.engine_params, self.device)

        data_source = self.engine.data_source_class(
            self.engine_params.data_source_params
        )
        self.handle = data_source.online_handle()
        if self.handle is None:
            raise ValueError(
                f"{type(data_source).__name__} exposes no online handle;"
                " `pio retrain --follow` needs the datasource to describe"
                " its interaction scan (app/channel/event names)"
            )
        wal_dir = self.config.wal_dir
        if not wal_dir:
            wal_dir = os.path.join(storage.base_dir(), "wal")
        # one tail per WAL partition, discovered off disk: a partitioned
        # ingest tier (--wal-partitions P) gets P independent change
        # detectors whose deltas merge before the single publish below
        self.tails = partition_tails(
            wal_dir,
            self.handle.app_id,
            self.handle.channel_id,
            self.handle.event_names,
        )
        self.partitions = len(self.tails)
        self.tail = self.tails[0]  # the P=1 alias tests and tools use
        mode, root = snapshot_settings(self.instance.runtime_conf)
        del mode  # the loop's backbone IS the snapshot; always refresh
        self.snapshots = SnapshotStore(
            root,
            SnapshotSpec(
                app_id=self.handle.app_id,
                channel_id=self.handle.channel_id,
                event_names=(
                    tuple(self.handle.event_names)
                    if self.handle.event_names
                    else None
                ),
                rating_key=self.handle.rating_key,
            ),
        )
        follow_dir = os.path.join(self.registry.dir, "follow")
        if self.partitions == 1:
            # the pre-partitioning path, byte-compatible: existing
            # followers resume from their old cursor file unchanged
            self.cursors = [TailCursor(os.path.join(follow_dir, "cursor.json"))]
        else:
            self.cursors = [
                TailCursor(os.path.join(follow_dir, f"cursor-p{k:05d}.json"))
                for k in range(self.partitions)
            ]
        self.cursor = self.cursors[0]  # the P=1 alias tests assert on
        for cursor in self.cursors:
            if cursor.until_ms == 0:
                # fresh cursor: the deployed base model reflects events up
                # to (at least) its training scan's start; fold-in windows
                # that overlap it are harmless (full-history re-solve)
                cursor.until_ms = base_until_ms
        self.last_lag_s = 0.0
        self.cycles = {"idle": 0, "foldin": 0, "full_retrain": 0,
                       "noop": 0, "swap_failed": 0}

    # -- one cycle -----------------------------------------------------------
    def _poll_partitions(self) -> list:
        """Poll every partition's tail; returns ``(part, cursor, batch)``
        triples where ``batch`` is None for a partition whose poll FAILED
        (I/O error, injected fault). Failure is isolated by design: a dead
        partition's cursor holds (its window replays once it recovers)
        while the siblings' deltas still merge and publish -- freshness
        degrades by one partition, not to zero. P > 1 polls concurrently:
        the scans are independent directory reads, and serializing them
        would re-serialize exactly the tail latency partitioning split."""

        def poll_one(k: int):
            self._test_fail_part(k)
            return self.tails[k].poll(self.cursors[k].seqno)

        results: list = [None] * self.partitions
        if self.partitions == 1:
            try:
                results[0] = poll_one(0)
            except Exception:
                logger.exception("WAL tail poll failed")
        else:
            def run(k: int) -> None:
                try:
                    results[k] = poll_one(k)
                except Exception:
                    logger.exception(
                        "partition %d tail poll failed; excluding its"
                        " window from this cycle (cursor holds, replays"
                        " on recovery)", k,
                    )

            pollers = [
                threading.Thread(target=run, args=(k,), daemon=True)
                for k in range(self.partitions)
            ]
            for t in pollers:
                t.start()
            for t in pollers:
                t.join()
        return [
            (k, self.cursors[k], results[k]) for k in range(self.partitions)
        ]

    def run_once(self) -> str:
        polls = self._poll_partitions()
        live = [(k, c, b) for k, c, b in polls if b is not None]
        if len(live) < self.partitions:
            self._count_part_failures(self.partitions - len(live))
        if not live:
            self._count("error")
            return "error"
        registry = global_registry()
        now = time.time()
        for k, c, b in live:
            if b.empty and b.last_seqno > c.seqno:
                # records were examined but none matched the followed scan
                # (another app/channel/event type): skip past them so a
                # busy multi-tenant WAL is not rescanned every poll. The
                # reflected-model bound (until_ms/rows) is untouched.
                c.advance(b.last_seqno, c.until_ms, c.snapshot_rows)
            registry.set_gauge(
                "pio_foldin_partition_lag_seconds", b.lag_seconds(now),
                labels={"part": str(k)},
                help="Age of the oldest unreflected event per WAL partition",
            )
        work = [(k, c, b) for k, c, b in live if not b.empty]
        if not work:
            self.last_lag_s = 0.0
            self._push_lag(0.0)
            self._count("idle")
            return "idle"
        self.last_lag_s = max(b.lag_seconds(now) for _, _, b in work)
        registry.set_gauge(
            "pio_foldin_lag_seconds", self.last_lag_s,
            help="Age of the oldest ingested event not yet reflected in a"
            " swapped model",
        )

        le = storage.get_l_events()
        until = _dt.datetime.now(_dt.timezone.utc)
        now_ms = int(until.timestamp() * 1000)
        # a partition whose EVERY pending record is future-dated (client
        # clock skew) defers alone -- the refresh bound (now) cannot cover
        # its window yet, so its cursor holds and it replays next poll --
        # while ready siblings still fold and publish
        ready = [
            (k, c, b) for k, c, b in work
            if not (b.min_event_ms is not None and b.min_event_ms >= now_ms)
        ]
        if not ready:
            self._count("deferred")
            return "deferred"
        # live-but-empty partitions ride the advance below: the published
        # model reflects the shared snapshot bound, and an empty window
        # advancing until_ms keeps future fold windows tight
        idle_live = [(k, c, b) for k, c, b in live if b.empty]
        merged = merge_batches([b for _, _, b in ready])
        snap = self.snapshots.ensure(le, "refresh", until_time=until)
        if snap is None:
            logger.error(
                "event backend has no columnar chunk scan; continuous"
                " learning requires it"
            )
            self._count("noop")
            return "unsupported"
        if merged.gap:
            # seqnos were GC'd before this follower saw them: the delta is
            # UNKNOWN (lost records may touch any user, with any event
            # time), so a fold-in cannot promise coverage -- rebaseline
            logger.warning(
                "WAL GC gap behind cursor(s) %s (oldest retained record is"
                " newer); escalating to a full retrain",
                [c.seqno for _, c, _ in ready],
            )
            return self._full_retrain(
                ready + idle_live, merged, snap,
                "WAL GC gap: records collected unseen",
            )
        # window = min across participating partitions: the fold must cover
        # the oldest unreflected event anywhere, and client-supplied event
        # times may predate a partition's cursor bound
        window_start_ms = min(
            c.until_ms if b.min_event_ms is None
            else min(c.until_ms, b.min_event_ms)
            for _, c, b in ready
        )
        batch = merged
        delta = FoldinDelta(
            snapshot=snap,
            window_start_ms=window_start_ms,
            touched_user_ids=set(batch.touched_users) or None,
            budget=self.config.budget,
            extras=dict(getattr(self.handle, "extras", None) or {}),
            set_entity_types=set(batch.touched_set_types) or None,
        )
        try:
            if not all(
                getattr(a, "supports_fold_in", False) for a in self.algorithms
            ):
                raise StalenessExceeded(
                    "algorithm(s) without a fold_in hook: "
                    + ", ".join(
                        type(a).__name__
                        for a in self.algorithms
                        if not getattr(a, "supports_fold_in", False)
                    )
                )
            new_models = []
            any_change = False
            for algorithm, model in zip(self.algorithms, self.models):
                folded = algorithm.fold_in(model, delta)
                if folded is None:
                    new_models.append(model)
                else:
                    any_change = True
                    new_models.append(folded)
        except StalenessExceeded as exc:
            return self._full_retrain(ready + idle_live, merged, snap, str(exc))
        if not any_change:
            # e.g. the window's records carried no scorable interaction
            self._maybe_advance(ready + idle_live, snap)
            self._count("noop")
            return "noop"

        self._test_hold()
        blob = self.engine.serialize_models(
            self.ctx, self.engine_params, self.instance.id, new_models
        )
        # shard_blobs must be derived BEFORE publish: untouched shards
        # reuse the still-latest version's bytes verbatim
        shard_blobs = self._shard_blobs(new_models, batch.touched_users)
        version = self.registry.publish(
            blob,
            meta=self._meta("foldin", batch, snap, models=new_models),
            shard_blobs=shard_blobs,
        )
        if not self._notify_swap(version.version):
            self._count("swap_failed")
            return "swap_failed"  # cursor stays; next cycle re-folds
        self.models = new_models
        self.current_version = version.version
        self._maybe_advance(ready + idle_live, snap)
        self._count("foldin")
        logger.info(
            "fold-in v%d: %d record(s), %d touched user(s), %d partition(s),"
            " lag %.2fs",
            version.version, batch.records, len(batch.touched_users),
            len(ready), self.last_lag_s,
        )
        return "foldin"

    def _full_retrain(self, parts, batch, snap, reason: str) -> str:
        if not self.config.allow_full_retrain:
            logger.warning(
                "staleness budget exceeded (%s) but full retrain is"
                " disabled; model keeps serving stale", reason,
            )
            self._count("noop")
            return "noop"
        logger.info("escalating to full retrain: %s", reason)
        instance = run_train(self.variant, device=self.device, engine=self.engine)
        record = storage.get_model_data_models().get(instance.id)
        if record is None:
            # every template ships SOME blob (even retrain-on-deploy marks);
            # a missing row means the train did not persist -- do not
            # publish an unloadable version, and leave the cursor so the
            # next cycle retries
            logger.error(
                "trained instance %s has no model blob; not publishing",
                instance.id,
            )
            self._count("error")
            return "error"
        self.instance = instance
        # re-derive params from the NEW instance: the operator may have
        # edited engine.json since the loop's base was published, and the
        # manifest/rehydration must describe the model actually trained
        self.engine_params = engine_params_from_instance(instance)
        self.algorithms = self.engine._algorithms(self.engine_params, self.device)
        self.models = self.engine.prepare_deploy(
            self.ctx, self.engine_params, instance.id, record.models, warm_up=False
        )
        version = self.registry.publish(
            record.models,
            meta=self._meta("train", batch, snap, instance_id=instance.id),
            shard_blobs=self._shard_blobs(self.models, None),
        )
        if not self._notify_swap(version.version):
            self._count("swap_failed")
            return "swap_failed"
        self.current_version = version.version
        self._advance(parts, snap)
        self._count("full_retrain")
        return "full_retrain"

    # -- plumbing ------------------------------------------------------------
    def _meta(
        self, source: str, batch, snap, instance_id: str | None = None,
        models=None,
    ) -> dict:
        meta = {
            "source": source,
            "instance_id": instance_id or self.instance.id,
            "engine_params": self.engine_params.to_json_obj(),
            "wal_seqno": batch.last_seqno,
            "until_ms": int(snap.manifest["until_ms"]),
            "records": batch.records,
            "touched_users": len(batch.touched_users),
        }
        if self.config.scorer_shards > 1:
            meta["shard_item_count"] = self._item_count(
                self.models if models is None else models
            )
        return meta

    @staticmethod
    def _item_count(models) -> int | None:
        """Item-vocabulary size across the models, or None when any model
        does not expose one. This is the reuse guard for untouched-shard
        bytes: fold-in freezes item factors, but it may APPEND zero rows
        for new items (within the growth budget), and that changes every
        shard's replicated item side."""
        counts = []
        for model in models:
            factors = getattr(model, "item_factors", None)
            if factors is None:
                factors = getattr(
                    getattr(model, "als", None), "item_factors", None
                )
            if factors is not None and hasattr(factors, "shape"):
                counts.append(int(factors.shape[0]))
                continue
            items = getattr(model, "item_ids", None)
            if items is not None:
                counts.append(len(items))
                continue
            return None
        return sum(counts) if counts else None

    def _shard_blobs(self, models, touched_users) -> list[bytes] | None:
        """Per-shard serialized blobs for ``registry.publish``. A fold-in
        recomputes ONLY the shards owning touched users; every other
        shard's bytes are carried forward verbatim from the still-latest
        version (same shard count, same item vocabulary) -- the publish
        cost of a small delta stays proportional to the delta.
        ``touched_users=None`` recomputes everything (full retrain)."""
        n = self.config.scorer_shards
        if n <= 1:
            return None
        from predictionio_tpu_torch.serving.shardmap import shard_of

        touched: set[int] | None = None
        prev = None
        if touched_users is not None:
            touched = {shard_of(u, n) for u in touched_users}
            prev = self.registry.latest()
            if prev is not None and (
                prev.shard_count != n
                or prev.manifest.get("shard_item_count")
                != self._item_count(models)
            ):
                prev = None
        blobs: list[bytes] = []
        for k in range(n):
            if prev is not None and touched is not None and k not in touched:
                try:
                    blobs.append(prev.load_blob(shard=k))
                    continue
                except Exception:
                    logger.warning(
                        "could not reuse shard %d bytes from version %d;"
                        " recomputing", k, prev.version, exc_info=True,
                    )
            sharded = self.engine.shard_models(
                self.engine_params, models, k, n, self.device
            )
            blobs.append(
                self.engine.serialize_models(
                    self.ctx, self.engine_params, self.instance.id, sharded
                )
            )
        return blobs

    def _advance(self, parts, snap) -> None:
        """Advance every participating partition's cursor -- each to ITS
        OWN last examined seqno (the seqno spaces are independent), all to
        the shared snapshot bound the published model reflects. R003's
        fsync-before-rename protocol runs inside each ``advance``, so a
        crash mid-loop leaves a PREFIX of partitions advanced: the rest
        replay their window, which fold-in absorbs."""
        until_ms = int(snap.manifest["until_ms"])
        rows = len(snap)
        for _, cursor, batch in parts:
            cursor.advance(batch.last_seqno, until_ms, rows)

    #: clock-skew horizon: a batch containing a record dated further ahead
    #: than this still advances (with a warning) instead of replaying every
    #: poll until the far-future time passes
    MAX_DEFER_SKEW_MS = 300_000

    def _maybe_advance(self, parts, snap) -> None:
        """Advance each participating cursor -- except a partition whose
        batch contains a record the refresh bound could not cover yet
        (future-dated via client clock skew, within ``MAX_DEFER_SKEW_MS``).
        The defer is PER PARTITION: one skewed client holds only its own
        partition's cursor (that window replays next poll), never its
        siblings'. Replay is free because fold-in re-solves from full
        history."""
        until_ms = int(snap.manifest["until_ms"])
        rows = len(snap)
        for part, cursor, batch in parts:
            if batch.max_event_ms is not None and batch.max_event_ms >= until_ms:
                skew = batch.max_event_ms - until_ms
                if skew < self.MAX_DEFER_SKEW_MS:
                    logger.info(
                        "deferring partition %d cursor: a record is dated"
                        " %.1fs ahead of the refresh bound (client clock"
                        " skew); will replay", part, skew / 1000.0,
                    )
                    continue
                logger.warning(
                    "partition %d record dated %.1fs in the future (beyond"
                    " the %.0fs defer horizon): advancing past it; it folds"
                    " at the next cycle after its event time passes",
                    part, skew / 1000.0, self.MAX_DEFER_SKEW_MS / 1000.0,
                )
            cursor.advance(batch.last_seqno, until_ms, rows)

    def _count_part_failures(self, n: int) -> None:
        self.cycles["part_failures"] = self.cycles.get("part_failures", 0) + n
        global_registry().inc(
            "pio_foldin_partition_failures_total", amount=float(n),
            help="Partition tail polls that failed and were excluded from"
            " a merge cycle",
        )

    def _test_fail_part(self, part: int) -> None:
        """Failure-injection hook for the partition-isolation chaos tests:
        kill ONE partition's poll on demand. Inert in production -- the
        env var is unset."""
        target = os.environ.get("PIO_ONLINE_TEST_FAIL_PART", "")
        if target != "" and int(target) == part:
            raise RuntimeError(f"injected partition {part} poll failure")

    def _count(self, result: str) -> None:
        self.cycles[result] = self.cycles.get(result, 0) + 1
        global_registry().inc(
            "pio_online_cycles_total", {"result": result},
            help="Continuous-learning cycles by outcome",
        )
        if self.current_version is not None:
            global_registry().set_gauge(
                "pio_model_version", float(self.current_version),
                help="Latest registry model version this loop swapped in",
            )

    def _test_hold(self) -> None:
        """Crash-injection window for the SIGKILL recovery tests: sleep
        between fold-in and publish when the env asks for it, announcing
        the window via a marker file so the killer does not race the
        fold. Inert in production -- the env vars are unset."""
        hold = float(os.environ.get("PIO_ONLINE_TEST_HOLD_S", "0") or 0)
        if hold > 0:
            marker = os.environ.get("PIO_ONLINE_TEST_HOLD_FILE")
            if marker:
                with open(marker, "w") as f:
                    f.write("holding")
            time.sleep(hold)

    def _post(self, url: str, path: str, obj: dict) -> dict:
        req = urllib.request.Request(
            f"{url}{path}",
            data=json.dumps(obj).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(
            req, timeout=self.config.swap_timeout_s
        ) as resp:
            return json.loads(resp.read().decode("utf-8") or "{}")

    def _notify_swap(self, version: int) -> bool:
        """Hot-swap ``version`` into every notify target. True once at
        least one server swapped (or none are configured: publish is the
        boundary in batch mode) -- a single dead replica must not wedge
        the cursor forever; it catches up from the registry on restart."""
        if not self.config.notify_urls:
            return True
        ok = 0
        for url in self.config.notify_urls:
            try:
                self._post(
                    url, "/models/swap",
                    {"version": version, "foldinLagSeconds": self.last_lag_s},
                )
                ok += 1
            except Exception as exc:
                logger.warning("swap notify failed for %s: %s", url, exc)
        return ok > 0

    def _push_lag(self, lag_s: float) -> None:
        """Best-effort lag heartbeat so `pio top` shows fold-in lag from
        the query server's /metrics even between swaps."""
        for url in self.config.notify_urls:
            try:
                self._post(url, "/models/lag", {"foldinLagSeconds": lag_s})
            except Exception:
                pass

    # -- the follow loop -----------------------------------------------------
    def stop(self) -> None:
        self._stop.set()

    def run_follow(self) -> dict:
        """Cycle until stopped (or ``max_cycles``); one failure logs and
        backs off instead of killing the loop. Returns the cycle counts."""
        n = 0
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception:
                logger.exception("retrain cycle failed; backing off")
                self._count("error")
            n += 1
            if self.config.max_cycles and n >= self.config.max_cycles:
                break
            self._stop.wait(self.config.interval_s)
        return dict(self.cycles)
