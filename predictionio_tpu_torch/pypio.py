"""``pypio`` bridge: the notebook/shell convenience API.

Copy of ``predictionio_tpu/pypio.py`` on the port's ``data/store.py``
and storage registry. Behavioral model: reference ``python/pypio/pypio.py``
(v0.13+, apache/predictionio layout, unverified -- SURVEY.md section 2.5
#35): ``init()`` acquires runtime handles, ``find_events(app_name)``
returns the app's events as a DataFrame, ``save_model`` persists a
trained model. The reference rides py4j into the JVM; here the runtime
is already in-process, so ``init()`` just binds the storage registry and
``find_events`` returns the columnar ``EventDataset`` (the DataFrame
stand-in: dict-of-numpy-columns semantics).

``save_model`` pickles any object into the model store and
``load_model`` unpickles it: a notebook's own objects, not the engine
instances' blobs, which ``deploy`` reads and never unpickles.

Used from ``pio shell`` (preloaded as ``pypio``) and importable from any
notebook: ``from predictionio_tpu_torch import pypio``.
"""

from __future__ import annotations

import pickle
import uuid
from typing import Any

_initialized = False


def init() -> None:
    """Bind the storage registry (no-op if the env is already configured).

    Raises if storage is misconfigured, mirroring the reference's fail-fast
    JVM handle acquisition.
    """
    global _initialized
    from predictionio_tpu_torch.data import storage as storage_registry

    failures = storage_registry.verify_all_data_objects()
    if failures:
        raise RuntimeError(
            "storage verification failed: " + "; ".join(failures)
        )
    _initialized = True


def _require_init() -> None:
    if not _initialized:
        raise RuntimeError("call pypio.init() first")


def find_events(app_name: str, channel_name: str | None = None, **filters):
    """All events for an app as a columnar ``EventDataset``.

    ``filters`` pass through to ``PEventStore.find`` (entity_type,
    event_names, start_time, ...).
    """
    _require_init()
    from predictionio_tpu_torch.data.store import EventDataset, PEventStore

    events = PEventStore.find(app_name, channel_name=channel_name, **filters)
    return EventDataset.from_events(events)


def find_events_rows(app_name: str, **filters) -> list[dict]:
    """Row-oriented variant: events as plain dicts (JSON shape)."""
    _require_init()
    from predictionio_tpu_torch.data.store import PEventStore

    return [e.to_json_obj() for e in PEventStore.find(app_name, **filters)]


def save_model(model: Any, engine_instance_id: str | None = None) -> str:
    """Pickle a model into the model store; returns the blob id.

    Reference parity: ``pypio.save_model`` persists through the JVM Models
    DAO keyed by engine instance id; a fresh id is minted when none given.
    """
    _require_init()
    from predictionio_tpu_torch.data import storage as storage_registry
    from predictionio_tpu_torch.data.storage.base import Model

    blob_id = engine_instance_id or uuid.uuid4().hex
    storage_registry.get_model_data_models().insert(
        Model(id=blob_id, models=pickle.dumps(model))
    )
    return blob_id


def load_model(engine_instance_id: str) -> Any:
    """Inverse of :func:`save_model` (not in the reference API; convenience)."""
    _require_init()
    from predictionio_tpu_torch.data import storage as storage_registry

    record = storage_registry.get_model_data_models().get(engine_instance_id)
    if record is None:
        raise KeyError(f"no model blob {engine_instance_id!r}")
    return pickle.loads(record.models)
