"""Copy of ``predictionio_tpu/data/storage/elasticsearch/client.py``, the package renamed.

Elasticsearch implementations of every DAO contract.

Parity role of the reference's metadata-store-of-record module
``storage/elasticsearch/.../{StorageClient,ESApps,ESAccessKeys,ESChannels,
ESEngineInstances,ESEvaluationInstances,ESLEvents,ESSequences,ESUtils}.scala``
(apache/predictionio layout, unverified -- SURVEY.md section 2.2 #9): a
full-stack backend (metadata + events + models) over the ES REST JSON API.

Configuration (reference env-var contract, SURVEY.md section 5.6):

    PIO_STORAGE_SOURCES_ELASTICSEARCH_TYPE=elasticsearch
    PIO_STORAGE_SOURCES_ELASTICSEARCH_HOSTS=localhost
    PIO_STORAGE_SOURCES_ELASTICSEARCH_PORTS=9200
    PIO_STORAGE_SOURCES_ELASTICSEARCH_SCHEMES=http
    PIO_STORAGE_SOURCES_ELASTICSEARCH_USERNAME=...   (optional basic auth)
    PIO_STORAGE_SOURCES_ELASTICSEARCH_PASSWORD=...
    PIO_STORAGE_SOURCES_ELASTICSEARCH_INDEX=pio      (index name prefix)
    PIO_STORAGE_SOURCES_ELASTICSEARCH_TRANSPORT=fake (in-memory; CI only)

Design notes:

- integer ids (apps, channels) come from an ES sequence index whose doc
  ``_version`` increments atomically on every index op -- the reference's
  ESSequences trick.
- every write passes ``refresh=true`` so reads are immediately consistent
  (the DAO contract the rest of the framework assumes; matches reference
  ESUtils' refresh-on-write in metadata paths).
- event scans paginate via ``search_after`` on (event_time_ms, event_id),
  so arbitrarily large scans stream without ES's 10k window cap.
"""

from __future__ import annotations

import datetime as _dt
import json
import secrets
import uuid
from typing import Iterable, Iterator, Optional

from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    Model,
    StorageClientConfig,
)
from predictionio_tpu_torch.data.storage.elasticsearch.transport import (
    ESError,
    FakeTransport,
    HttpTransport,
)
from predictionio_tpu_torch.data.storage.sql_common import ts_from_str, ts_ms, ts_to_str

_SCAN_PAGE = 1000

# -- explicit index mappings (reference ESUtils' not_analyzed mappings) ------
#
# Without these, a live ES dynamic-maps every string to analyzed text: term
# queries on uppercase/spaced values (app names, entity ids) silently miss,
# and sorting on event_id 400s. keyword for ids/names/entities, long for
# *_ms, date for ISO8601 timestamps; large JSON blobs are stored-only
# (text, index:false -- never queried, only read back from _source).

_KW = {"type": "keyword"}
_LONG = {"type": "long"}
_TS = {"type": "date", "format": "strict_date_optional_time"}
_BLOB = {"type": "text", "index": False}


def mapping_for(kind: str) -> dict:
    """ES mapping body for one index kind (``events_*`` share one shape)."""
    if kind.startswith("events"):
        props = {
            "event_id": _KW,
            "event": _KW,
            "entity_type": _KW,
            "entity_id": _KW,
            "target_entity_type": _KW,
            "target_entity_id": _KW,
            "properties": _BLOB,
            "event_time": _TS,
            "event_time_ms": _LONG,
            "pr_id": _KW,
            "creation_time": _TS,
        }
    elif kind == "meta_apps":
        props = {"id": _LONG, "name": _KW, "description": _BLOB}
    elif kind == "meta_channels":
        props = {"id": _LONG, "name": _KW, "app_id": _LONG}
    elif kind == "meta_accesskeys":
        props = {"key": _KW, "app_id": _LONG, "events": _KW}
    elif kind == "meta_engine_instances":
        props = {
            "id": _KW,
            "status": _KW,
            "start_time": _TS,
            "end_time": _TS,
            "engine_id": _KW,
            "engine_version": _KW,
            "engine_variant": _KW,
            "engine_factory": _KW,
            "batch": _BLOB,
            "env": _BLOB,
            "runtime_conf": _BLOB,
            "data_source_params": _BLOB,
            "preparator_params": _BLOB,
            "algorithms_params": _BLOB,
            "serving_params": _BLOB,
        }
    elif kind == "meta_evaluation_instances":
        props = {
            "id": _KW,
            "status": _KW,
            "start_time": _TS,
            "end_time": _TS,
            "evaluation_class": _KW,
            "engine_params_generator_class": _KW,
            "batch": _BLOB,
            "env": _BLOB,
            "evaluator_results": _BLOB,
            "evaluator_results_html": _BLOB,
            "evaluator_results_json": _BLOB,
        }
    elif kind == "models":
        props = {"id": _KW, "models": {"type": "binary"}}
    elif kind == "sequences":
        props = {"n": _LONG}
    else:
        raise KeyError(f"no ES mapping defined for index kind {kind!r}")
    return {"properties": props}


class StorageClient(base.BaseStorageClient):
    def __init__(self, config: StorageClientConfig, transport=None):
        super().__init__(config)
        props = config.properties
        self.prefix = props.get("INDEX", "pio")
        self._ensured: set[str] = set()
        if transport is not None:
            self.transport = transport
        elif props.get("TRANSPORT", "").lower() == "fake":
            self.transport = FakeTransport()
        else:
            host = (props.get("HOSTS", "localhost")).split(",")[0]
            port = (props.get("PORTS", "9200")).split(",")[0]
            scheme = (props.get("SCHEMES", "http")).split(",")[0]
            self.transport = HttpTransport(
                f"{scheme}://{host}:{port}",
                username=props.get("USERNAME", ""),
                password=props.get("PASSWORD", ""),
            )

    # -- shared helpers ------------------------------------------------------
    def index_name(self, kind: str) -> str:
        return f"{self.prefix}_{kind}"

    def ensure_index(self, kind: str) -> None:
        """Create the index with its explicit mapping before first write.

        Relying on ES dynamic mapping would analyze every string field:
        term queries on uppercase/spaced values miss and event_id sorts
        400. Races/pre-existing indices surface as 400
        resource_already_exists, which is success here.
        """
        if kind in self._ensured:
            return
        if kind.startswith("events"):
            # a cluster-side index template covers paths this per-process
            # cache cannot: another process deletes an events index
            # (app data-delete) and our next write auto-creates it --
            # with the template, even auto-create carries the mappings
            self._ensure_events_template()
        try:
            self.transport.request(
                "PUT",
                f"/{self.index_name(kind)}",
                body={"mappings": mapping_for(kind)},
            )
        except ESError as exc:
            error_type = ""
            if isinstance(exc.body, dict):
                error_type = (exc.body.get("error") or {}).get("type", "")
            if exc.status != 400 or "exists" not in error_type:
                raise
        self._ensured.add(kind)

    def _ensure_events_template(self) -> None:
        if getattr(self, "_events_template_done", False):
            return
        name = f"{self.prefix}_events"
        patterns = [f"{self.prefix}_events_*"]
        try:
            self.transport.request(
                "PUT",
                f"/_index_template/{name}",
                body={
                    "index_patterns": patterns,
                    "template": {"mappings": mapping_for("events")},
                },
            )
        except ESError:
            # pre-7.8 clusters only know the legacy endpoint
            self.transport.request(
                "PUT",
                f"/_template/{name}",
                body={"index_patterns": patterns, "mappings": mapping_for("events")},
            )
        self._events_template_done = True

    def drop_index(self, kind: str) -> None:
        self.transport.request("DELETE", f"/{self.index_name(kind)}")
        self._ensured.discard(kind)

    def next_id(self, sequence: str) -> int:
        """Atomic int sequence via ES doc versioning (reference ESSequences)."""
        self.ensure_index("sequences")
        status, body = self.transport.request(
            "PUT",
            f"/{self.index_name('sequences')}/_doc/{sequence}",
            body={"n": 1},
            params={"refresh": "true"},
        )
        return int(body["_version"])

    def put(self, kind: str, doc_id: str, source: dict) -> None:
        self.ensure_index(kind)
        self.transport.request(
            "PUT",
            f"/{self.index_name(kind)}/_doc/{doc_id}",
            body=source,
            params={"refresh": "true"},
        )

    def get_source(self, kind: str, doc_id: str) -> Optional[dict]:
        status, body = self.transport.request(
            "GET", f"/{self.index_name(kind)}/_doc/{doc_id}"
        )
        if status == 404 or not body.get("found"):
            return None
        return body["_source"]

    def delete_doc(self, kind: str, doc_id: str) -> bool:
        status, body = self.transport.request(
            "DELETE",
            f"/{self.index_name(kind)}/_doc/{doc_id}",
            params={"refresh": "true"},
        )
        return status == 200 and body.get("result") == "deleted"

    def search(self, kind: str, query: dict, size: int = 10000, sort=None) -> list[dict]:
        body = {"query": query, "size": size}
        if sort:
            body["sort"] = sort
        status, result = self.transport.request(
            "POST", f"/{self.index_name(kind)}/_search", body=body
        )
        if status == 404:  # index not created yet = no documents
            return []
        return [h["_source"] for h in result["hits"]["hits"]]

    def get_dao(self, repo: str):
        return {
            "apps": ESApps,
            "channels": ESChannels,
            "access_keys": ESAccessKeys,
            "engine_instances": ESEngineInstances,
            "evaluation_instances": ESEvaluationInstances,
            "models": ESModels,
            "events": ESLEvents,
        }[repo](self)


class ESApps(base.Apps):
    KIND = "meta_apps"

    def __init__(self, client: StorageClient):
        self.c = client

    @staticmethod
    def _to_app(source: dict) -> App:
        return App(id=source["id"], name=source["name"], description=source["description"])

    def insert(self, app: App) -> int:
        app.id = app.id or self.c.next_id("apps")
        self.c.put(self.KIND, str(app.id), {
            "id": app.id, "name": app.name, "description": app.description,
        })
        return app.id

    def get(self, app_id: int) -> Optional[App]:
        source = self.c.get_source(self.KIND, str(app_id))
        return self._to_app(source) if source else None

    def get_by_name(self, name: str) -> Optional[App]:
        hits = self.c.search(self.KIND, {"term": {"name": name}}, size=1)
        return self._to_app(hits[0]) if hits else None

    def get_all(self) -> list[App]:
        hits = self.c.search(self.KIND, {"match_all": {}}, sort=[{"id": "asc"}])
        return [self._to_app(h) for h in hits]

    def update(self, app: App) -> None:
        self.c.put(self.KIND, str(app.id), {
            "id": app.id, "name": app.name, "description": app.description,
        })

    def delete(self, app_id: int) -> None:
        self.c.delete_doc(self.KIND, str(app_id))


class ESChannels(base.Channels):
    KIND = "meta_channels"

    def __init__(self, client: StorageClient):
        self.c = client

    @staticmethod
    def _to_channel(source: dict) -> Channel:
        return Channel(id=source["id"], name=source["name"], app_id=source["app_id"])

    def insert(self, channel: Channel) -> int:
        channel.id = channel.id or self.c.next_id("channels")
        self.c.put(self.KIND, str(channel.id), {
            "id": channel.id, "name": channel.name, "app_id": channel.app_id,
        })
        return channel.id

    def get(self, channel_id: int) -> Optional[Channel]:
        source = self.c.get_source(self.KIND, str(channel_id))
        return self._to_channel(source) if source else None

    def get_by_app(self, app_id: int) -> list[Channel]:
        hits = self.c.search(
            self.KIND, {"term": {"app_id": app_id}}, sort=[{"id": "asc"}]
        )
        return [self._to_channel(h) for h in hits]

    def delete(self, channel_id: int) -> None:
        self.c.delete_doc(self.KIND, str(channel_id))


class ESAccessKeys(base.AccessKeys):
    KIND = "meta_accesskeys"

    def __init__(self, client: StorageClient):
        self.c = client

    @staticmethod
    def _to_key(source: dict) -> AccessKey:
        return AccessKey(
            key=source["key"], app_id=source["app_id"], events=list(source["events"])
        )

    def insert(self, access_key: AccessKey) -> str:
        key = access_key.key or secrets.token_urlsafe(48)
        access_key.key = key
        self.c.put(self.KIND, key, {
            "key": key, "app_id": access_key.app_id, "events": access_key.events,
        })
        return key

    def get(self, key: str) -> Optional[AccessKey]:
        source = self.c.get_source(self.KIND, key)
        return self._to_key(source) if source else None

    def get_all(self) -> list[AccessKey]:
        return [self._to_key(h) for h in self.c.search(self.KIND, {"match_all": {}})]

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        hits = self.c.search(self.KIND, {"term": {"app_id": app_id}})
        return [self._to_key(h) for h in hits]

    def update(self, access_key: AccessKey) -> None:
        self.c.put(self.KIND, access_key.key, {
            "key": access_key.key,
            "app_id": access_key.app_id,
            "events": access_key.events,
        })

    def delete(self, key: str) -> None:
        self.c.delete_doc(self.KIND, key)


class ESEngineInstances(base.EngineInstances):
    KIND = "meta_engine_instances"

    def __init__(self, client: StorageClient):
        self.c = client

    @staticmethod
    def _to_source(i: EngineInstance) -> dict:
        return {
            "id": i.id,
            "status": i.status,
            "start_time": ts_to_str(i.start_time),
            "end_time": ts_to_str(i.end_time),
            "engine_id": i.engine_id,
            "engine_version": i.engine_version,
            "engine_variant": i.engine_variant,
            "engine_factory": i.engine_factory,
            "batch": i.batch,
            "env": json.dumps(i.env),
            "runtime_conf": json.dumps(i.runtime_conf),
            "data_source_params": i.data_source_params,
            "preparator_params": i.preparator_params,
            "algorithms_params": i.algorithms_params,
            "serving_params": i.serving_params,
        }

    @staticmethod
    def _to_instance(s: dict) -> EngineInstance:
        return EngineInstance(
            id=s["id"],
            status=s["status"],
            start_time=ts_from_str(s["start_time"]),
            end_time=ts_from_str(s.get("end_time")),
            engine_id=s["engine_id"],
            engine_version=s["engine_version"],
            engine_variant=s["engine_variant"],
            engine_factory=s["engine_factory"],
            batch=s["batch"],
            env=json.loads(s["env"]),
            runtime_conf=json.loads(s["runtime_conf"]),
            data_source_params=s["data_source_params"],
            preparator_params=s["preparator_params"],
            algorithms_params=s["algorithms_params"],
            serving_params=s["serving_params"],
        )

    def insert(self, instance: EngineInstance) -> str:
        instance.id = instance.id or uuid.uuid4().hex
        self.c.put(self.KIND, instance.id, self._to_source(instance))
        return instance.id

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        source = self.c.get_source(self.KIND, instance_id)
        return self._to_instance(source) if source else None

    def get_all(self) -> list[EngineInstance]:
        hits = self.c.search(
            self.KIND, {"match_all": {}}, sort=[{"start_time": "desc"}]
        )
        return [self._to_instance(h) for h in hits]

    def _variant_query(self, engine_id, engine_version, engine_variant, status=None):
        filters = [
            {"term": {"engine_id": engine_id}},
            {"term": {"engine_version": engine_version}},
            {"term": {"engine_variant": engine_variant}},
        ]
        if status is not None:
            filters.append({"term": {"status": status}})
        return {"bool": {"filter": filters}}

    def get_completed(self, engine_id, engine_version, engine_variant):
        hits = self.c.search(
            self.KIND,
            self._variant_query(
                engine_id, engine_version, engine_variant, base.STATUS_COMPLETED
            ),
            sort=[{"start_time": "desc"}],
        )
        return [self._to_instance(h) for h in hits]

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        completed = self.get_completed(engine_id, engine_version, engine_variant)
        return completed[0] if completed else None

    def get_latest(self, engine_id, engine_version, engine_variant):
        hits = self.c.search(
            self.KIND,
            self._variant_query(engine_id, engine_version, engine_variant),
            sort=[{"start_time": "desc"}],
            size=1,
        )
        return self._to_instance(hits[0]) if hits else None

    def update(self, instance: EngineInstance) -> None:
        self.c.put(self.KIND, instance.id, self._to_source(instance))

    def delete(self, instance_id: str) -> None:
        self.c.delete_doc(self.KIND, instance_id)


class ESEvaluationInstances(base.EvaluationInstances):
    KIND = "meta_evaluation_instances"

    def __init__(self, client: StorageClient):
        self.c = client

    @staticmethod
    def _to_source(i: EvaluationInstance) -> dict:
        return {
            "id": i.id,
            "status": i.status,
            "start_time": ts_to_str(i.start_time),
            "end_time": ts_to_str(i.end_time),
            "evaluation_class": i.evaluation_class,
            "engine_params_generator_class": i.engine_params_generator_class,
            "batch": i.batch,
            "env": json.dumps(i.env),
            "evaluator_results": i.evaluator_results,
            "evaluator_results_html": i.evaluator_results_html,
            "evaluator_results_json": i.evaluator_results_json,
        }

    @staticmethod
    def _to_instance(s: dict) -> EvaluationInstance:
        return EvaluationInstance(
            id=s["id"],
            status=s["status"],
            start_time=ts_from_str(s["start_time"]),
            end_time=ts_from_str(s.get("end_time")),
            evaluation_class=s["evaluation_class"],
            engine_params_generator_class=s["engine_params_generator_class"],
            batch=s["batch"],
            env=json.loads(s["env"]),
            evaluator_results=s["evaluator_results"],
            evaluator_results_html=s["evaluator_results_html"],
            evaluator_results_json=s["evaluator_results_json"],
        )

    def insert(self, instance: EvaluationInstance) -> str:
        instance.id = instance.id or uuid.uuid4().hex
        self.c.put(self.KIND, instance.id, self._to_source(instance))
        return instance.id

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        source = self.c.get_source(self.KIND, instance_id)
        return self._to_instance(source) if source else None

    def get_all(self) -> list[EvaluationInstance]:
        hits = self.c.search(
            self.KIND, {"match_all": {}}, sort=[{"start_time": "desc"}]
        )
        return [self._to_instance(h) for h in hits]

    def get_completed(self) -> list[EvaluationInstance]:
        hits = self.c.search(
            self.KIND,
            {"term": {"status": base.STATUS_COMPLETED}},
            sort=[{"start_time": "desc"}],
        )
        return [self._to_instance(h) for h in hits]

    def update(self, instance: EvaluationInstance) -> None:
        self.c.put(self.KIND, instance.id, self._to_source(instance))

    def delete(self, instance_id: str) -> None:
        self.c.delete_doc(self.KIND, instance_id)


class ESModels(base.Models):
    """Model blobs, base64-wrapped (ES documents are JSON)."""

    KIND = "models"

    def __init__(self, client: StorageClient):
        self.c = client

    def insert(self, model: Model) -> None:
        import base64

        self.c.put(self.KIND, model.id, {
            "id": model.id, "models": base64.b64encode(model.models).decode(),
        })

    def get(self, model_id: str) -> Optional[Model]:
        import base64

        source = self.c.get_source(self.KIND, model_id)
        if source is None:
            return None
        return Model(id=source["id"], models=base64.b64decode(source["models"]))

    def delete(self, model_id: str) -> None:
        self.c.delete_doc(self.KIND, model_id)


class ESLEvents(base.LEvents):
    """Events: one index per app/channel (reference one-table-per naming:
    ``pio_event:events_<appId>[_<channelId>]``, here ``<prefix>_events_...``)."""

    def __init__(self, client: StorageClient):
        self.c = client

    def _kind(self, app_id: int, channel_id: int | None) -> str:
        suffix = f"_{channel_id}" if channel_id else ""
        return f"events_{app_id}{suffix}"

    def init_channel(self, app_id: int, channel_id: int | None = None) -> bool:
        self.c.ensure_index(self._kind(app_id, channel_id))
        return True

    def remove_channel(self, app_id: int, channel_id: int | None = None) -> bool:
        self.c.drop_index(self._kind(app_id, channel_id))
        return True

    @staticmethod
    def _to_source(ev: Event) -> dict:
        return {
            "event_id": ev.event_id,
            "event": ev.event,
            "entity_type": ev.entity_type,
            "entity_id": ev.entity_id,
            "target_entity_type": ev.target_entity_type,
            "target_entity_id": ev.target_entity_id,
            "properties": json.dumps(ev.properties.to_dict()),
            "event_time": ev.event_time.isoformat(),
            "event_time_ms": ts_ms(ev.event_time),
            "pr_id": ev.pr_id,
            "creation_time": ev.creation_time.isoformat(),
        }

    @staticmethod
    def _to_event(s: dict) -> Event:
        return Event(
            event_id=s["event_id"],
            event=s["event"],
            entity_type=s["entity_type"],
            entity_id=s["entity_id"],
            target_entity_type=s.get("target_entity_type"),
            target_entity_id=s.get("target_entity_id"),
            properties=DataMap(json.loads(s["properties"])),
            event_time=_dt.datetime.fromisoformat(s["event_time"]),
            pr_id=s.get("pr_id"),
            creation_time=_dt.datetime.fromisoformat(s["creation_time"]),
        )

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        return self.batch_insert([event], app_id, channel_id)[0]

    def batch_insert(
        self, events: Iterable[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        kind = self._kind(app_id, channel_id)
        ids = []
        for ev in events:
            ev = ev if ev.event_id else ev.with_id()
            ids.append(ev.event_id)
            self.c.put(kind, ev.event_id, self._to_source(ev))
        return ids

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Optional[Event]:
        source = self.c.get_source(self._kind(app_id, channel_id), event_id)
        return self._to_event(source) if source else None

    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool:
        return self.c.delete_doc(self._kind(app_id, channel_id), event_id)

    @staticmethod
    def _build_query(
        start_time=None,
        until_time=None,
        entity_type=None,
        entity_id=None,
        event_names=None,
        target_entity_type=...,
        target_entity_id=...,
    ) -> dict:
        """Filter DSL shared by find() and scan_interactions(): one
        definition so the row and columnar paths cannot desynchronize."""
        filters: list[dict] = []
        must_not: list[dict] = []
        time_range: dict = {}
        if start_time is not None:
            time_range["gte"] = ts_ms(start_time)
        if until_time is not None:
            time_range["lt"] = ts_ms(until_time)
        if time_range:
            filters.append({"range": {"event_time_ms": time_range}})
        if entity_type is not None:
            filters.append({"term": {"entity_type": entity_type}})
        if entity_id is not None:
            filters.append({"term": {"entity_id": entity_id}})
        if event_names:
            filters.append({"terms": {"event": event_names}})
        if target_entity_type is not ...:
            if target_entity_type is None:
                must_not.append({"exists": {"field": "target_entity_type"}})
            else:
                filters.append({"term": {"target_entity_type": target_entity_type}})
        if target_entity_id is not ...:
            if target_entity_id is None:
                must_not.append({"exists": {"field": "target_entity_id"}})
            else:
                filters.append({"term": {"target_entity_id": target_entity_id}})
        return {"bool": {"filter": filters, "must_not": must_not}}

    def _scan(
        self,
        app_id: int,
        channel_id: int | None,
        query: dict,
        reversed: bool = False,
        limit: int | None = None,
        source_fields: list[str] | None = None,
    ) -> Iterator[dict]:
        """search_after-paginated hit stream (sources only)."""
        order = "desc" if reversed else "asc"
        sort = [{"event_time_ms": order}, {"event_id": order}]
        index = self.c.index_name(self._kind(app_id, channel_id))
        remaining = limit if (limit is not None and limit >= 0) else None
        search_after = None
        while True:
            page = _SCAN_PAGE if remaining is None else min(_SCAN_PAGE, remaining)
            if page == 0:
                return
            body = {"query": query, "size": page, "sort": sort}
            if source_fields is not None:
                body["_source"] = source_fields
            if search_after is not None:
                body["search_after"] = search_after
            status, result = self.c.transport.request(
                "POST", f"/{index}/_search", body=body
            )
            if status == 404:
                return
            hits = result["hits"]["hits"]
            for h in hits:
                yield h["_source"]
            if remaining is not None:
                remaining -= len(hits)
                if remaining <= 0:
                    return
            if len(hits) < page:
                return
            search_after = hits[-1]["sort"]

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: list[str] | None = None,
        target_entity_type=...,
        target_entity_id=...,
        limit: int | None = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        query = self._build_query(
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
        )
        for source in self._scan(
            app_id, channel_id, query, reversed=reversed, limit=limit
        ):
            yield self._to_event(source)

    def scan_interactions(
        self,
        app_id: int,
        channel_id: int | None = None,
        event_names: list[str] | None = None,
        target_entity_type=...,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        rating_key: str = "rating",
    ):
        """Columnar training scan (same contract as the SQL backends'
        ``scan_interactions``): five parallel lists, no Event/DataMap
        construction per hit, ``_source`` filtered to the training columns.
        The rating still needs a host-side parse of the properties JSON
        string, gated on a cheap substring test so unrated events skip it;
        the number-only rule matches ``EventDataset.from_events``.
        """
        query = self._build_query(
            start_time=start_time,
            until_time=until_time,
            event_names=event_names,
            target_entity_type=target_entity_type,
        )
        # the stored properties string came from json.dumps, so build the
        # needle the same way: a non-ASCII key is stored \u-escaped and a
        # raw f'"{key}"' would never match it
        needle = json.dumps(rating_key)
        ents: list = []
        tgts: list = []
        names: list = []
        times: list = []
        ratings: list = []
        for s in self._scan(
            app_id,
            channel_id,
            query,
            source_fields=[
                "entity_id", "target_entity_id", "event", "event_time",
                "properties",
            ],
        ):
            ents.append(s["entity_id"])
            tgts.append(s.get("target_entity_id"))
            names.append(s["event"])
            times.append(s["event_time"])
            rating = None
            props = s.get("properties")
            if props and needle in props:
                value = json.loads(props).get(rating_key)
                if isinstance(value, (int, float)) and not isinstance(value, bool):
                    rating = value
            ratings.append(rating)
        return ents, tgts, names, times, ratings
