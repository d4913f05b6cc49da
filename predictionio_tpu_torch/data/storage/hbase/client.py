"""Copy of ``predictionio_tpu/data/storage/hbase/client.py``, the package renamed.

HBase event-store backend (events only, like the reference module).

Parity role of the reference's event store of record ``storage/hbase/.../
{StorageClient,HBLEvents,HBEventsUtil}.scala`` (apache/predictionio layout,
unverified -- SURVEY.md section 2.2 #8): one table per app/channel
(reference ``pio_event:events_<appId>[_<channelId>]``), rowkeys encoding a
shard prefix + event time so time-range scans are prefix scans. Metadata
and models belong in another backend (the reference deployed HBase for
EVENTDATA with ES/JDBC for METADATA), mirroring how ``localfs`` is a
models-only backend here.

Configuration (reference env-var contract, SURVEY.md section 5.6):

    PIO_STORAGE_SOURCES_HBASE_TYPE=hbase
    PIO_STORAGE_SOURCES_HBASE_HOSTS=localhost    (REST gateway host)
    PIO_STORAGE_SOURCES_HBASE_PORTS=8080
    PIO_STORAGE_SOURCES_HBASE_NAMESPACE=pio_event
    PIO_STORAGE_SOURCES_HBASE_TRANSPORT=fake     (in-memory; CI only)

Row key design (TPU-first simplification of reference HBEventsUtil):
``SSTTTTTTTTTTTTTUUUUUUUUUUUUUUUU`` = 2-digit shard (hash of entity for
write distribution across regions) + 13-digit zero-padded event_time_ms +
16-hex uuid suffix. Within one shard, key order IS time order, so a
time-range find() is N_SHARDS prefix scans heap-merged by (time, key).
Event ids ARE row keys (reference HBase semantics: ids encode the row
key; preset ids on import are re-assigned).
"""

from __future__ import annotations

import datetime as _dt
import heapq
import json
from typing import Iterable, Iterator, Optional

from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import StorageClientConfig
from predictionio_tpu_torch.data.storage.hbase.transport import (
    FakeTransport,
    HttpTransport,
    new_suffix,
)
from predictionio_tpu_torch.data.storage.sql_common import ts_ms

N_SHARDS = 8
_FAMILY = "e"


class StorageClient(base.BaseStorageClient):
    def __init__(self, config: StorageClientConfig, transport=None):
        super().__init__(config)
        props = config.properties
        self.namespace = props.get("NAMESPACE", "pio_event")
        if transport is not None:
            self.transport = transport
        elif props.get("TRANSPORT", "").lower() == "fake":
            self.transport = FakeTransport()
        else:
            host = (props.get("HOSTS", "localhost")).split(",")[0]
            port = (props.get("PORTS", "8080")).split(",")[0]
            scheme = (props.get("SCHEMES", "http")).split(",")[0]
            self.transport = HttpTransport(f"{scheme}://{host}:{port}")

    def get_dao(self, repo: str):
        if repo != "events":
            raise NotImplementedError(
                "the hbase backend stores events only (reference parity:"
                " EVENTDATA on HBase, METADATA/MODELDATA on elasticsearch or"
                f" jdbc); requested repo {repo!r}"
            )
        return HBLEvents(self)


def shard_of(entity_type: str, entity_id: str) -> int:
    from predictionio_tpu_torch.utils.stablehash import stable_bucket

    # same crc32-of-utf8 bytes as the old inline modulus, so existing
    # rowkeys keep their shard prefix
    return stable_bucket(f"{entity_type}\x00{entity_id}", N_SHARDS)


def make_rowkey(event: Event, suffix: str | None = None) -> str:
    shard = shard_of(event.entity_type, event.entity_id)
    return f"{shard:02d}{ts_ms(event.event_time):013d}{suffix or new_suffix()}"


class HBLEvents(base.LEvents):
    def __init__(self, client: StorageClient):
        self.c = client

    def table(self, app_id: int, channel_id: int | None) -> str:
        suffix = f"_{channel_id}" if channel_id else ""
        return f"{self.c.namespace}:events_{app_id}{suffix}"

    def init_channel(self, app_id: int, channel_id: int | None = None) -> bool:
        self.c.transport.create_table(self.table(app_id, channel_id), [_FAMILY])
        return True

    def remove_channel(self, app_id: int, channel_id: int | None = None) -> bool:
        self.c.transport.delete_table(self.table(app_id, channel_id))
        return True

    @staticmethod
    def _to_cells(ev: Event) -> dict[str, bytes]:
        doc = {
            "event": ev.event,
            "entity_type": ev.entity_type,
            "entity_id": ev.entity_id,
            "target_entity_type": ev.target_entity_type,
            "target_entity_id": ev.target_entity_id,
            "properties": ev.properties.to_dict(),
            "event_time": ev.event_time.isoformat(),
            "pr_id": ev.pr_id,
            "creation_time": ev.creation_time.isoformat(),
        }
        # one JSON cell + a couple of raw filter columns: the reference
        # used one column per field; a single document cell round-trips
        # None-vs-absent cleanly through the gateway's base64 layer
        return {
            f"{_FAMILY}:d": json.dumps(doc).encode(),
            f"{_FAMILY}:etype": ev.entity_type.encode(),
            f"{_FAMILY}:name": ev.event.encode(),
        }

    @staticmethod
    def _to_event(rowkey: str, cells: dict[str, bytes]) -> Event:
        doc = json.loads(cells[f"{_FAMILY}:d"])
        return Event(
            event_id=rowkey,
            event=doc["event"],
            entity_type=doc["entity_type"],
            entity_id=doc["entity_id"],
            target_entity_type=doc.get("target_entity_type"),
            target_entity_id=doc.get("target_entity_id"),
            properties=DataMap(doc["properties"]),
            event_time=_dt.datetime.fromisoformat(doc["event_time"]),
            pr_id=doc.get("pr_id"),
            creation_time=_dt.datetime.fromisoformat(doc["creation_time"]),
        )

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        return self.batch_insert([event], app_id, channel_id)[0]

    def batch_insert(
        self, events: Iterable[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        rows, ids = [], []
        for ev in events:
            rowkey = make_rowkey(ev)  # ids ARE row keys (reference semantics)
            ids.append(rowkey)
            rows.append((rowkey, self._to_cells(ev)))
        self.c.transport.put_rows(self.table(app_id, channel_id), rows)
        return ids

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Optional[Event]:
        cells = self.c.transport.get_row(self.table(app_id, channel_id), event_id)
        return self._to_event(event_id, cells) if cells else None

    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool:
        return self.c.transport.delete_row(self.table(app_id, channel_id), event_id)

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
        table = self.table(app_id, channel_id)
        start_ms = ts_ms(start_time) if start_time is not None else 0

        # one prefix scan per shard; entity filters narrow to ONE shard
        # (the rowkey's shard is a pure function of the entity)
        if entity_type is not None and entity_id is not None:
            shards = [shard_of(entity_type, entity_id)]
        else:
            shards = list(range(N_SHARDS))

        def shard_stream(shard: int):
            start_row = f"{shard:02d}{start_ms:013d}"
            if until_time is not None:
                # exclusive end row: keys at exactly until_ms carry a suffix
                # and sort after this, so untilTime stays exclusive
                end_row = f"{shard:02d}{ts_ms(until_time):013d}"
            else:
                # unbounded: the next shard's prefix. A formatted
                # _MAX_TIME_MS+1 here is 14 digits, which sorts BEFORE the
                # 13-digit zero-padded times and made unbounded scans empty
                end_row = f"{shard + 1:02d}"
            for rowkey, cells in self.c.transport.scan(
                table, start_row=start_row, end_row=end_row
            ):
                yield rowkey[2:], rowkey, cells  # merge key: time+suffix

        def matches(ev: Event) -> bool:
            if entity_type is not None and ev.entity_type != entity_type:
                return False
            if entity_id is not None and ev.entity_id != entity_id:
                return False
            if event_names and ev.event not in event_names:
                return False
            if target_entity_type is not ... and ev.target_entity_type != target_entity_type:
                return False
            if target_entity_id is not ... and ev.target_entity_id != target_entity_id:
                return False
            return True

        merged = heapq.merge(*(shard_stream(s) for s in shards))
        if reversed:
            # HBase scanners are forward-only over the REST gateway; a
            # reversed find (the event server's default listing) is served
            # by materializing matches then walking backward. Bounded
            # queries (limit) dominate this path in practice.
            matched = [
                ev
                for _, rowkey, cells in merged
                if matches(ev := self._to_event(rowkey, cells))
            ]
            matched.reverse()
            yield from matched[: limit if limit is not None and limit >= 0 else None]
            return
        emitted = 0
        for _, rowkey, cells in merged:
            ev = self._to_event(rowkey, cells)
            if not matches(ev):
                continue
            yield ev
            emitted += 1
            if limit is not None and 0 <= limit <= emitted:
                return
