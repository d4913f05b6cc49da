"""Storage DAO contracts + metadata record types.

Behavioral model: reference ``data/.../storage/{Apps,Channels,AccessKeys,
EngineInstances,EvaluationInstances,Models,LEvents}.scala`` (apache/predictionio
layout, unverified -- SURVEY.md section 2.2 #7). The CRUD/query surface is kept;
the implementation and the ``PEvents`` RDD path are replaced by a columnar
batched reader (see ``predictionio_tpu_torch.data.store``).

Port copy: ``predictionio_tpu/data/storage/base.py`` (framework-free),
verbatim, under the port's package name; ``tests/test_torch_imports.py``
holds it to the original.
"""

from __future__ import annotations

import abc
import datetime as _dt
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator, Optional

from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event

# -- engine/evaluation instance status machine (SURVEY.md section 5.3) -------
STATUS_QUEUED = "QUEUED"
STATUS_RUNNING = "RUNNING"
STATUS_COMPLETED = "COMPLETED"
STATUS_FAILED = "FAILED"
STATUS_ABORTED = "ABORTED"


@dataclass
class App:
    name: str
    description: str = ""
    id: int | None = None


@dataclass
class Channel:
    name: str
    app_id: int
    id: int | None = None

    @staticmethod
    def is_valid_name(name: str) -> bool:
        return bool(name) and name.replace("-", "").replace("_", "").isalnum()


@dataclass
class AccessKey:
    key: str
    app_id: int
    events: list[str] = field(default_factory=list)  # empty = all events allowed


@dataclass
class EngineInstance:
    """One training run; persists params + status for deploy to resolve."""

    id: str | None = None
    status: str = STATUS_QUEUED
    start_time: _dt.datetime = field(
        default_factory=lambda: _dt.datetime.now(_dt.timezone.utc)
    )
    end_time: _dt.datetime | None = None
    engine_id: str = ""
    engine_version: str = ""
    engine_variant: str = ""
    engine_factory: str = ""
    batch: str = ""
    env: dict[str, str] = field(default_factory=dict)
    runtime_conf: dict[str, Any] = field(default_factory=dict)  # engine.json sparkConf analogue
    data_source_params: str = "{}"
    preparator_params: str = "{}"
    algorithms_params: str = "[]"
    serving_params: str = "{}"


@dataclass
class EvaluationInstance:
    id: str | None = None
    status: str = STATUS_QUEUED
    start_time: _dt.datetime = field(
        default_factory=lambda: _dt.datetime.now(_dt.timezone.utc)
    )
    end_time: _dt.datetime | None = None
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: dict[str, str] = field(default_factory=dict)
    evaluator_results: str = ""          # human-readable leaderboard
    evaluator_results_html: str = ""     # dashboard drill-down
    evaluator_results_json: str = ""     # machine-readable


@dataclass
class Model:
    """Serialized model blob keyed by EngineInstance id."""

    id: str
    models: bytes


def safe_blob_name(model_id: str) -> str:
    """Collision-free file/object name for a model id (shared by the
    localfs and s3 blob stores).

    Reversible encoding: ids starting with "x" always take the encoded
    branch, so a literal id can never collide with another id's hex
    encoding."""
    if not model_id.startswith("x") and all(
        c.isalnum() or c in "-_" for c in model_id
    ):
        safe = model_id
    else:
        safe = "x" + model_id.encode("utf-8").hex()
    return f"pio_model_{safe}.bin"


@dataclass
class StorageClientConfig:
    parallel: bool = False
    test: bool = False
    properties: dict[str, str] = field(default_factory=dict)


class BaseStorageClient(abc.ABC):
    """One configured connection to a backend (reference BaseStorageClient)."""

    def __init__(self, config: StorageClientConfig):
        self.config = config

    @abc.abstractmethod
    def get_dao(self, repo: str):
        """Return the DAO for ``repo`` in {apps, channels, access_keys,
        engine_instances, evaluation_instances, models, events}."""

    def close(self) -> None:  # pragma: no cover - backends override as needed
        pass


# -- DAO contracts -----------------------------------------------------------


class Apps(abc.ABC):
    @abc.abstractmethod
    def insert(self, app: App) -> int: ...

    @abc.abstractmethod
    def get(self, app_id: int) -> Optional[App]: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> Optional[App]: ...

    @abc.abstractmethod
    def get_all(self) -> list[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> None: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> None: ...


class Channels(abc.ABC):
    @abc.abstractmethod
    def insert(self, channel: Channel) -> int: ...

    @abc.abstractmethod
    def get(self, channel_id: int) -> Optional[Channel]: ...

    @abc.abstractmethod
    def get_by_app(self, app_id: int) -> list[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> None: ...


class AccessKeys(abc.ABC):
    @abc.abstractmethod
    def insert(self, access_key: AccessKey) -> str: ...

    @abc.abstractmethod
    def get(self, key: str) -> Optional[AccessKey]: ...

    @abc.abstractmethod
    def get_all(self) -> list[AccessKey]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> list[AccessKey]: ...

    @abc.abstractmethod
    def update(self, access_key: AccessKey) -> None: ...

    @abc.abstractmethod
    def delete(self, key: str) -> None: ...


class EngineInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EngineInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> list[EngineInstance]: ...

    @abc.abstractmethod
    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]: ...

    def get_latest(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]:
        """Most recent instance for a variant REGARDLESS of status -- the
        crash-resume lookup (`pio train --resume` reuses a non-COMPLETED
        instance instead of inserting a new one). Default implementation
        scans get_all(); SQL backends override with a WHERE query."""
        candidates = [
            i
            for i in self.get_all()
            if i.engine_id == engine_id
            and i.engine_version == engine_version
            and i.engine_variant == engine_variant
        ]
        if not candidates:
            return None
        epoch = _dt.datetime.min.replace(tzinfo=_dt.timezone.utc)
        return max(candidates, key=lambda i: i.start_time or epoch)

    @abc.abstractmethod
    def update(self, instance: EngineInstance) -> None: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> None: ...


class EvaluationInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EvaluationInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> list[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_completed(self) -> list[EvaluationInstance]: ...

    @abc.abstractmethod
    def update(self, instance: EvaluationInstance) -> None: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> None: ...


class Models(abc.ABC):
    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Optional[Model]: ...

    @abc.abstractmethod
    def delete(self, model_id: str) -> None: ...


class LEvents(abc.ABC):
    """Event-store DAO. ``channel_id=None`` addresses the default channel.

    ``find`` filter surface mirrors the reference ``LEvents.find`` signature
    (SURVEY.md section 2.2 #7).
    """

    @abc.abstractmethod
    def init_channel(self, app_id: int, channel_id: int | None = None) -> bool: ...

    @abc.abstractmethod
    def remove_channel(self, app_id: int, channel_id: int | None = None) -> bool: ...

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str: ...

    @abc.abstractmethod
    def batch_insert(
        self, events: Iterable[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]: ...

    def insert_batch(
        self,
        items: Iterable[tuple[Event, int, Optional[int]]],
        on_duplicate: str = "error",
    ) -> list[str]:
        """Heterogeneous group commit: ``(event, app_id, channel_id)`` tuples
        spanning apps/channels, applied as atomically as the backend allows
        (single transaction on the SQL backends, which override this).

        ``on_duplicate="ignore"`` skips rows whose event_id already exists --
        the WAL-replay idempotence contract (``data/ingest.py``). This loop
        fallback serves the non-SQL backends.
        """
        if on_duplicate not in ("error", "ignore"):
            raise ValueError(f"on_duplicate must be error|ignore, got {on_duplicate!r}")
        ids = []
        for event, app_id, channel_id in items:
            ev = event if event.event_id else event.with_id()
            if (
                on_duplicate == "ignore"
                and self.get(ev.event_id, app_id, channel_id) is not None
            ):
                ids.append(ev.event_id)
                continue
            ids.append(self.insert(ev, app_id, channel_id))
        return ids

    @abc.abstractmethod
    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Optional[Event]: ...

    @abc.abstractmethod
    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool: ...

    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: list[str] | None = None,
        target_entity_type: str | None | type(...) = ...,
        target_entity_id: str | None | type(...) = ...,
        limit: int | None = None,
        reversed: bool = False,
    ) -> Iterator[Event]: ...

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: int | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        required: list[str] | None = None,
    ) -> dict[str, PropertyMap]:
        from predictionio_tpu_torch.data.aggregation import aggregate_properties
        from predictionio_tpu_torch.data.event import SPECIAL_EVENTS

        events = self.find(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            event_names=sorted(SPECIAL_EVENTS),
        )
        result = aggregate_properties(events)
        if required:
            result = {
                k: v for k, v in result.items() if all(r in v for r in required)
            }
        return result
