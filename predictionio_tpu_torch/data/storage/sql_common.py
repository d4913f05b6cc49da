"""Shared SQL DAO implementations, parameterized by dialect.

One copy of the relational mapping serves every SQL backend (parity role of
the reference's scalikejdbc-based JDBC module, ``storage/jdbc/.../JDBC*.scala``
-- apache/predictionio layout, unverified, SURVEY.md section 2.2 #10, which
likewise serves PostgreSQL and MySQL from one DAO set). Backends subclass
:class:`SQLStorageClient` and provide a DB-API connection plus the few
statements that differ by dialect (auto-id inserts, upserts, schema DDL).

DAO SQL is written with ``?`` placeholders; the client rewrites them to the
backend's paramstyle. None of the statements embed a literal ``?``.

Port copy: ``predictionio_tpu/data/storage/sql_common.py``
(framework-free), verbatim under the port's package name;
``tests/test_torch_imports.py`` holds it to the original.
"""

from __future__ import annotations

import abc
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
)

#: channel_id column value for the default channel (reference uses None).
DEFAULT_CHANNEL = 0

#: find(limit=N) at or under this uses the plain materializing query path --
#: a handful of rows never justifies a dedicated streaming connection (the
#: event server's GET /events.json hot path runs find(limit=20) per request)
SMALL_SCAN_LIMIT = 1000


class CursorResult:
    """Minimal ``rowcount`` carrier for backends whose cursors are closed
    before the DAO inspects the result."""

    def __init__(self, rowcount: int):
        self.rowcount = rowcount


def parse_jdbc_url_properties(
    props: dict[str, str],
    schemes: tuple[str, ...],
    backend_name: str,
    default_port: int,
    dbname_key: str = "dbname",
    query_keys: tuple[str, ...] = ("user", "password", "connect_timeout"),
) -> dict:
    """Shared URL/HOST/PORT/DBNAME/USERNAME/PASSWORD -> DB-API kwargs parsing.

    One copy serves every SQL dialect (the reference's JDBCUtils analogue):
    accepts the reference's ``jdbc:<scheme>://...`` URL form verbatim, with
    explicit HOST/PORT/DBNAME/USERNAME/PASSWORD properties overriding URL
    parts, and scheme validation against the dialect's accepted set.
    """
    from urllib.parse import parse_qs, urlparse

    kwargs: dict = {}
    url = props.get("URL", "")
    if url:
        if url.startswith("jdbc:"):
            url = url[len("jdbc:"):]
        parsed = urlparse(url)
        if parsed.scheme not in schemes:
            raise ValueError(
                f"unsupported URL scheme {parsed.scheme!r} for {backend_name} storage"
            )
        if parsed.hostname:
            kwargs["host"] = parsed.hostname
        if parsed.port:
            kwargs["port"] = parsed.port
        dbname = (parsed.path or "").lstrip("/")
        if dbname:
            kwargs[dbname_key] = dbname
        if parsed.username:
            kwargs["user"] = parsed.username
        if parsed.password:
            kwargs["password"] = parsed.password
        for key, values in parse_qs(parsed.query).items():
            if key in query_keys:
                value = values[-1]
                # MySQL drivers require a real int for connect_timeout;
                # credentials must stay strings even when all-digit
                if key == "connect_timeout" and value.isdigit():
                    kwargs[key] = int(value)
                else:
                    kwargs[key] = value
    if props.get("HOST"):
        kwargs["host"] = props["HOST"]
    if props.get("PORT"):
        kwargs["port"] = int(props["PORT"])
    if props.get("DBNAME"):
        kwargs[dbname_key] = props["DBNAME"]
    if props.get("USERNAME"):
        kwargs["user"] = props["USERNAME"]
    if props.get("PASSWORD"):
        kwargs["password"] = props["PASSWORD"]
    kwargs.setdefault("host", "localhost")
    kwargs.setdefault("port", default_port)
    kwargs.setdefault(dbname_key, "pio")
    return kwargs


def ts_to_str(ts: _dt.datetime | None) -> str | None:
    # normalize to UTC with fixed precision so text ORDER BY is chronological
    if ts is None:
        return None
    if ts.tzinfo is None:
        ts = ts.replace(tzinfo=_dt.timezone.utc)
    return ts.astimezone(_dt.timezone.utc).isoformat(timespec="microseconds")


def ts_from_str(s: str | None) -> _dt.datetime | None:
    return _dt.datetime.fromisoformat(s) if s else None


def ts_ms(ts: _dt.datetime) -> int:
    # same naive-means-UTC rule as Event.__post_init__, so stored values and
    # find() bounds agree on any host timezone
    if ts.tzinfo is None:
        ts = ts.replace(tzinfo=_dt.timezone.utc)
    return int(ts.timestamp() * 1000)


class SQLStorageClient(base.BaseStorageClient):
    """Backend contract the shared DAOs run against.

    Subclasses implement the five statement runners and set the dialect
    statements below. ``?`` placeholders in DAO SQL are rewritten via
    :meth:`sql` before execution.
    """

    #: paramstyle placeholder ("?" for sqlite, "%s" for postgres)
    placeholder = "?"
    #: insert-or-ignore into event_channels(app_id, channel_id)
    INSERT_IGNORE_EVENT_CHANNELS = (
        "INSERT OR IGNORE INTO event_channels (app_id, channel_id) VALUES (?, ?)"
    )
    #: upsert into models(id, models)
    UPSERT_MODEL = "INSERT OR REPLACE INTO models (id, models) VALUES (?, ?)"
    #: events insert that silently skips duplicate (app_id, channel_id,
    #: event_id) rows -- the WAL-replay idempotence statement. sqlite form
    #: here; postgres/mysql override. (prefix/suffix split because the
    #: dialects disagree on where the ignore clause goes.)
    INSERT_EVENTS_IGNORE_PREFIX = "INSERT OR IGNORE INTO events"
    INSERT_EVENTS_IGNORE_SUFFIX = ""
    #: dialect JSON extraction over the properties column, NUMBERS ONLY --
    #: NULL for strings/bools/objects, matching EventDataset.from_events'
    #: isinstance(int|float)-and-not-bool rating rule exactly. Placeholders
    #: bind to :meth:`json_number_params` in order. (sqlite form here;
    #: postgres/mysql override.)
    JSON_NUMBER_EXPR = (
        "CASE WHEN json_type(properties, ?) IN ('integer', 'real')"
        " THEN json_extract(properties, ?) END"
    )
    #: dialect modulo over event_time_ms ({mod} formatted in) -- the
    #: snapshot digest's per-row checksum term. sqlite has only the ``%``
    #: operator (MOD() needs a math-functions build); the %s-paramstyle
    #: dialects override with MOD(): a bare ``%`` in statement text would
    #: be eaten by psycopg2/pymysql's client-side interpolation. All three
    #: forms use TRUNCATED (sign-of-dividend) semantics.
    TIME_MOD_EXPR = "event_time_ms % {mod}"

    @classmethod
    def json_number_params(cls, key: str) -> tuple:
        """Bind values for JSON_NUMBER_EXPR's placeholders, in order."""
        path = cls._json_path(key)
        return (path, path)

    @staticmethod
    def _json_path(key: str) -> str:
        # JSON-path escaping is backslash-style (doubling quotes is SQL
        # string escaping and silently matches nothing in sqlite)
        escaped = key.replace("\\", "\\\\").replace('"', '\\"')
        return f'$."{escaped}"'

    def sql(self, statement: str) -> str:
        if self.placeholder == "?":
            return statement
        return statement.replace("?", self.placeholder)

    @abc.abstractmethod
    def execute(self, sql: str, params: tuple = ()):
        """Run one write statement; returns an object with ``rowcount``."""

    @abc.abstractmethod
    def executemany(self, sql: str, rows: list[tuple]): ...

    @abc.abstractmethod
    def insert_returning_id(self, sql: str, params: tuple) -> int:
        """Run an INSERT on a table with an auto-increment ``id``; return it."""

    @abc.abstractmethod
    def query(self, sql: str, params: tuple = ()) -> list[tuple]: ...

    @abc.abstractmethod
    def query_iter(self, sql: str, params: tuple = ()) -> Iterator[tuple]: ...

    def get_dao(self, repo: str):
        return {
            "apps": SQLApps,
            "channels": SQLChannels,
            "access_keys": SQLAccessKeys,
            "engine_instances": SQLEngineInstances,
            "evaluation_instances": SQLEvaluationInstances,
            "models": SQLModels,
            "events": SQLLEvents,
        }[repo](self)


class SQLApps(base.Apps):
    def __init__(self, client: SQLStorageClient):
        self.c = client

    def insert(self, app: App) -> int:
        app.id = self.c.insert_returning_id(
            self.c.sql("INSERT INTO apps (name, description) VALUES (?, ?)"),
            (app.name, app.description),
        )
        return app.id

    def get(self, app_id: int) -> Optional[App]:
        rows = self.c.query(
            self.c.sql("SELECT id, name, description FROM apps WHERE id=?"), (app_id,)
        )
        return App(id=rows[0][0], name=rows[0][1], description=rows[0][2]) if rows else None

    def get_by_name(self, name: str) -> Optional[App]:
        rows = self.c.query(
            self.c.sql("SELECT id, name, description FROM apps WHERE name=?"), (name,)
        )
        return App(id=rows[0][0], name=rows[0][1], description=rows[0][2]) if rows else None

    def get_all(self) -> list[App]:
        rows = self.c.query("SELECT id, name, description FROM apps ORDER BY id")
        return [App(id=r[0], name=r[1], description=r[2]) for r in rows]

    def update(self, app: App) -> None:
        self.c.execute(
            self.c.sql("UPDATE apps SET name=?, description=? WHERE id=?"),
            (app.name, app.description, app.id),
        )

    def delete(self, app_id: int) -> None:
        self.c.execute(self.c.sql("DELETE FROM apps WHERE id=?"), (app_id,))


class SQLChannels(base.Channels):
    def __init__(self, client: SQLStorageClient):
        self.c = client

    def insert(self, channel: Channel) -> int:
        channel.id = self.c.insert_returning_id(
            self.c.sql("INSERT INTO channels (name, app_id) VALUES (?, ?)"),
            (channel.name, channel.app_id),
        )
        return channel.id

    def get(self, channel_id: int) -> Optional[Channel]:
        rows = self.c.query(
            self.c.sql("SELECT id, name, app_id FROM channels WHERE id=?"),
            (channel_id,),
        )
        return Channel(id=rows[0][0], name=rows[0][1], app_id=rows[0][2]) if rows else None

    def get_by_app(self, app_id: int) -> list[Channel]:
        rows = self.c.query(
            self.c.sql(
                "SELECT id, name, app_id FROM channels WHERE app_id=? ORDER BY id"
            ),
            (app_id,),
        )
        return [Channel(id=r[0], name=r[1], app_id=r[2]) for r in rows]

    def delete(self, channel_id: int) -> None:
        self.c.execute(self.c.sql("DELETE FROM channels WHERE id=?"), (channel_id,))


class SQLAccessKeys(base.AccessKeys):
    def __init__(self, client: SQLStorageClient):
        self.c = client

    def insert(self, access_key: AccessKey) -> str:
        key = access_key.key or secrets.token_urlsafe(48)
        self.c.execute(
            self.c.sql("INSERT INTO access_keys (key, app_id, events) VALUES (?, ?, ?)"),
            (key, access_key.app_id, json.dumps(access_key.events)),
        )
        access_key.key = key
        return key

    def get(self, key: str) -> Optional[AccessKey]:
        rows = self.c.query(
            self.c.sql("SELECT key, app_id, events FROM access_keys WHERE key=?"),
            (key,),
        )
        if not rows:
            return None
        return AccessKey(key=rows[0][0], app_id=rows[0][1], events=json.loads(rows[0][2]))

    def get_all(self) -> list[AccessKey]:
        # must go through sql(): `key` is reserved on MySQL
        rows = self.c.query(
            self.c.sql("SELECT key, app_id, events FROM access_keys")
        )
        return [AccessKey(key=r[0], app_id=r[1], events=json.loads(r[2])) for r in rows]

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        rows = self.c.query(
            self.c.sql("SELECT key, app_id, events FROM access_keys WHERE app_id=?"),
            (app_id,),
        )
        return [AccessKey(key=r[0], app_id=r[1], events=json.loads(r[2])) for r in rows]

    def update(self, access_key: AccessKey) -> None:
        self.c.execute(
            self.c.sql("UPDATE access_keys SET app_id=?, events=? WHERE key=?"),
            (access_key.app_id, json.dumps(access_key.events), access_key.key),
        )

    def delete(self, key: str) -> None:
        self.c.execute(self.c.sql("DELETE FROM access_keys WHERE key=?"), (key,))


class SQLEngineInstances(base.EngineInstances):
    _COLS = (
        "id, status, start_time, end_time, engine_id, engine_version, engine_variant,"
        " engine_factory, batch, env, runtime_conf, data_source_params,"
        " preparator_params, algorithms_params, serving_params"
    )

    def __init__(self, client: SQLStorageClient):
        self.c = client

    def _row_to_instance(self, r: tuple) -> EngineInstance:
        return EngineInstance(
            id=r[0],
            status=r[1],
            start_time=ts_from_str(r[2]),
            end_time=ts_from_str(r[3]),
            engine_id=r[4],
            engine_version=r[5],
            engine_variant=r[6],
            engine_factory=r[7],
            batch=r[8],
            env=json.loads(r[9]),
            runtime_conf=json.loads(r[10]),
            data_source_params=r[11],
            preparator_params=r[12],
            algorithms_params=r[13],
            serving_params=r[14],
        )

    def insert(self, instance: EngineInstance) -> str:
        instance.id = instance.id or uuid.uuid4().hex
        self.c.execute(
            self.c.sql(
                f"INSERT INTO engine_instances ({self._COLS}) VALUES "
                "(?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)"
            ),
            (
                instance.id,
                instance.status,
                ts_to_str(instance.start_time),
                ts_to_str(instance.end_time),
                instance.engine_id,
                instance.engine_version,
                instance.engine_variant,
                instance.engine_factory,
                instance.batch,
                json.dumps(instance.env),
                json.dumps(instance.runtime_conf),
                instance.data_source_params,
                instance.preparator_params,
                instance.algorithms_params,
                instance.serving_params,
            ),
        )
        return instance.id

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        rows = self.c.query(
            self.c.sql(f"SELECT {self._COLS} FROM engine_instances WHERE id=?"),
            (instance_id,),
        )
        return self._row_to_instance(rows[0]) if rows else None

    def get_all(self) -> list[EngineInstance]:
        rows = self.c.query(
            f"SELECT {self._COLS} FROM engine_instances ORDER BY start_time DESC"
        )
        return [self._row_to_instance(r) for r in rows]

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        rows = self.c.query(
            self.c.sql(
                f"SELECT {self._COLS} FROM engine_instances WHERE status=? AND engine_id=?"
                " AND engine_version=? AND engine_variant=? ORDER BY start_time DESC"
            ),
            (base.STATUS_COMPLETED, engine_id, engine_version, engine_variant),
        )
        return [self._row_to_instance(r) for r in rows]

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]:
        completed = self.get_completed(engine_id, engine_version, engine_variant)
        return completed[0] if completed else None

    def get_latest(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]:
        rows = self.c.query(
            self.c.sql(
                f"SELECT {self._COLS} FROM engine_instances WHERE engine_id=?"
                " AND engine_version=? AND engine_variant=?"
                " ORDER BY start_time DESC LIMIT 1"
            ),
            (engine_id, engine_version, engine_variant),
        )
        return self._row_to_instance(rows[0]) if rows else None

    def update(self, instance: EngineInstance) -> None:
        self.c.execute(
            self.c.sql(
                "UPDATE engine_instances SET status=?, start_time=?, end_time=?,"
                " engine_id=?, engine_version=?, engine_variant=?, engine_factory=?,"
                " batch=?, env=?, runtime_conf=?, data_source_params=?,"
                " preparator_params=?, algorithms_params=?, serving_params=? WHERE id=?"
            ),
            (
                instance.status,
                ts_to_str(instance.start_time),
                ts_to_str(instance.end_time),
                instance.engine_id,
                instance.engine_version,
                instance.engine_variant,
                instance.engine_factory,
                instance.batch,
                json.dumps(instance.env),
                json.dumps(instance.runtime_conf),
                instance.data_source_params,
                instance.preparator_params,
                instance.algorithms_params,
                instance.serving_params,
                instance.id,
            ),
        )

    def delete(self, instance_id: str) -> None:
        self.c.execute(
            self.c.sql("DELETE FROM engine_instances WHERE id=?"), (instance_id,)
        )


class SQLEvaluationInstances(base.EvaluationInstances):
    _COLS = (
        "id, status, start_time, end_time, evaluation_class,"
        " engine_params_generator_class, batch, env, evaluator_results,"
        " evaluator_results_html, evaluator_results_json"
    )

    def __init__(self, client: SQLStorageClient):
        self.c = client

    def _row_to_instance(self, r: tuple) -> EvaluationInstance:
        return EvaluationInstance(
            id=r[0],
            status=r[1],
            start_time=ts_from_str(r[2]),
            end_time=ts_from_str(r[3]),
            evaluation_class=r[4],
            engine_params_generator_class=r[5],
            batch=r[6],
            env=json.loads(r[7]),
            evaluator_results=r[8],
            evaluator_results_html=r[9],
            evaluator_results_json=r[10],
        )

    def insert(self, instance: EvaluationInstance) -> str:
        instance.id = instance.id or uuid.uuid4().hex
        self.c.execute(
            self.c.sql(
                f"INSERT INTO evaluation_instances ({self._COLS}) VALUES"
                " (?,?,?,?,?,?,?,?,?,?,?)"
            ),
            (
                instance.id,
                instance.status,
                ts_to_str(instance.start_time),
                ts_to_str(instance.end_time),
                instance.evaluation_class,
                instance.engine_params_generator_class,
                instance.batch,
                json.dumps(instance.env),
                instance.evaluator_results,
                instance.evaluator_results_html,
                instance.evaluator_results_json,
            ),
        )
        return instance.id

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        rows = self.c.query(
            self.c.sql(f"SELECT {self._COLS} FROM evaluation_instances WHERE id=?"),
            (instance_id,),
        )
        return self._row_to_instance(rows[0]) if rows else None

    def get_all(self) -> list[EvaluationInstance]:
        rows = self.c.query(
            f"SELECT {self._COLS} FROM evaluation_instances ORDER BY start_time DESC"
        )
        return [self._row_to_instance(r) for r in rows]

    def get_completed(self) -> list[EvaluationInstance]:
        rows = self.c.query(
            self.c.sql(
                f"SELECT {self._COLS} FROM evaluation_instances WHERE status=?"
                " ORDER BY start_time DESC"
            ),
            (base.STATUS_COMPLETED,),
        )
        return [self._row_to_instance(r) for r in rows]

    def update(self, instance: EvaluationInstance) -> None:
        self.c.execute(
            self.c.sql(
                "UPDATE evaluation_instances SET status=?, start_time=?, end_time=?,"
                " evaluation_class=?, engine_params_generator_class=?, batch=?, env=?,"
                " evaluator_results=?, evaluator_results_html=?, evaluator_results_json=?"
                " WHERE id=?"
            ),
            (
                instance.status,
                ts_to_str(instance.start_time),
                ts_to_str(instance.end_time),
                instance.evaluation_class,
                instance.engine_params_generator_class,
                instance.batch,
                json.dumps(instance.env),
                instance.evaluator_results,
                instance.evaluator_results_html,
                instance.evaluator_results_json,
                instance.id,
            ),
        )

    def delete(self, instance_id: str) -> None:
        self.c.execute(
            self.c.sql("DELETE FROM evaluation_instances WHERE id=?"), (instance_id,)
        )


class SQLModels(base.Models):
    def __init__(self, client: SQLStorageClient):
        self.c = client

    def insert(self, model: Model) -> None:
        self.c.execute(self.c.sql(self.c.UPSERT_MODEL), (model.id, model.models))

    def get(self, model_id: str) -> Optional[Model]:
        rows = self.c.query(
            self.c.sql("SELECT id, models FROM models WHERE id=?"), (model_id,)
        )
        return Model(id=rows[0][0], models=bytes(rows[0][1])) if rows else None

    def delete(self, model_id: str) -> None:
        self.c.execute(self.c.sql("DELETE FROM models WHERE id=?"), (model_id,))


class SQLLEvents(base.LEvents):
    def __init__(self, client: SQLStorageClient):
        self.c = client

    @staticmethod
    def _ch(channel_id: int | None) -> int:
        return DEFAULT_CHANNEL if channel_id is None else channel_id

    def init_channel(self, app_id: int, channel_id: int | None = None) -> bool:
        self.c.execute(
            self.c.sql(self.c.INSERT_IGNORE_EVENT_CHANNELS),
            (app_id, self._ch(channel_id)),
        )
        return True

    def remove_channel(self, app_id: int, channel_id: int | None = None) -> bool:
        ch = self._ch(channel_id)
        self.c.execute(
            self.c.sql("DELETE FROM events WHERE app_id=? AND channel_id=?"),
            (app_id, ch),
        )
        self.c.execute(
            self.c.sql("DELETE FROM event_channels WHERE app_id=? AND channel_id=?"),
            (app_id, ch),
        )
        return True

    _EVENT_INSERT_COLS = (
        "(event_id, app_id, channel_id, event,"
        " entity_type, entity_id, target_entity_type, target_entity_id,"
        " properties, event_time, event_time_ms, pr_id, creation_time)"
        " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)"
    )

    def _event_row(self, ev: Event, app_id: int, channel_id: int | None) -> tuple:
        return (
            ev.event_id,
            app_id,
            self._ch(channel_id),
            ev.event,
            ev.entity_type,
            ev.entity_id,
            ev.target_entity_type,
            ev.target_entity_id,
            json.dumps(ev.properties.to_dict()),
            ev.event_time.isoformat(),
            ts_ms(ev.event_time),
            ev.pr_id,
            ev.creation_time.isoformat(),
        )

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        return self.batch_insert([event], app_id, channel_id)[0]

    def batch_insert(
        self, events: Iterable[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        return self.insert_batch((ev, app_id, channel_id) for ev in events)

    def insert_batch(
        self,
        items: Iterable[tuple[Event, int, int | None]],
        on_duplicate: str = "error",
    ) -> list[str]:
        """One ``executemany`` (= one transaction on every SQL backend) for a
        group commit spanning apps/channels -- the ingest pipeline's flush
        path. ``on_duplicate="error"`` keeps the append-only contract: a
        duplicate event_id is a caller bug and surfaces as an IntegrityError;
        ``"ignore"`` is the WAL-replay idempotence mode."""
        if on_duplicate not in ("error", "ignore"):
            raise ValueError(f"on_duplicate must be error|ignore, got {on_duplicate!r}")
        rows, ids = [], []
        for ev, app_id, channel_id in items:
            ev = ev if ev.event_id else ev.with_id()
            ids.append(ev.event_id)
            rows.append(self._event_row(ev, app_id, channel_id))
        if not rows:
            return ids
        prefix = (
            self.c.INSERT_EVENTS_IGNORE_PREFIX
            if on_duplicate == "ignore"
            else "INSERT INTO events"
        )
        suffix = self.c.INSERT_EVENTS_IGNORE_SUFFIX if on_duplicate == "ignore" else ""
        self.c.executemany(
            self.c.sql(f"{prefix} {self._EVENT_INSERT_COLS}{suffix}"), rows
        )
        return ids

    @staticmethod
    def _row_to_event(r: tuple) -> Event:
        return Event(
            event_id=r[0],
            event=r[1],
            entity_type=r[2],
            entity_id=r[3],
            target_entity_type=r[4],
            target_entity_id=r[5],
            properties=DataMap(json.loads(r[6])),
            event_time=_dt.datetime.fromisoformat(r[7]),
            pr_id=r[8],
            creation_time=_dt.datetime.fromisoformat(r[9]),
        )

    _EVENT_COLS = (
        "event_id, event, entity_type, entity_id, target_entity_type,"
        " target_entity_id, properties, event_time, pr_id, creation_time"
    )

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Optional[Event]:
        rows = self.c.query(
            self.c.sql(
                f"SELECT {self._EVENT_COLS} FROM events"
                " WHERE app_id=? AND channel_id=? AND event_id=?"
            ),
            (app_id, self._ch(channel_id), event_id),
        )
        return self._row_to_event(rows[0]) if rows else None

    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool:
        cur = self.c.execute(
            self.c.sql(
                "DELETE FROM events WHERE app_id=? AND channel_id=? AND event_id=?"
            ),
            (app_id, self._ch(channel_id), event_id),
        )
        return cur.rowcount > 0

    @staticmethod
    def _append_filters(
        sql: list,
        params: list,
        *,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: list[str] | None = None,
        target_entity_type=...,
        target_entity_id=...,
    ) -> None:
        """WHERE-clause builder shared by find() and scan_interactions():
        one definition so the row and columnar paths cannot desynchronize
        their filter semantics."""
        if start_time is not None:
            sql.append("AND event_time_ms >= ?")
            params.append(ts_ms(start_time))
        if until_time is not None:
            sql.append("AND event_time_ms < ?")
            params.append(ts_ms(until_time))
        if entity_type is not None:
            sql.append("AND entity_type = ?")
            params.append(entity_type)
        if entity_id is not None:
            sql.append("AND entity_id = ?")
            params.append(entity_id)
        if event_names:
            sql.append(f"AND event IN ({','.join('?' * len(event_names))})")
            params.extend(event_names)
        if target_entity_type is not ...:
            if target_entity_type is None:
                sql.append("AND target_entity_type IS NULL")
            else:
                sql.append("AND target_entity_type = ?")
                params.append(target_entity_type)
        if target_entity_id is not ...:
            if target_entity_id is None:
                sql.append("AND target_entity_id IS NULL")
            else:
                sql.append("AND target_entity_id = ?")
                params.append(target_entity_id)

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
        sql = [
            f"SELECT {self._EVENT_COLS} FROM events WHERE app_id=? AND channel_id=?"
        ]
        params: list = [app_id, self._ch(channel_id)]
        self._append_filters(
            sql,
            params,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
        )
        sql.append(f"ORDER BY event_time_ms {'DESC' if reversed else 'ASC'}")
        if limit is not None and limit >= 0:
            sql.append("LIMIT ?")
            params.append(limit)
        # small bounded scans (the event server's GET hot path runs
        # find(limit=20) per request) take the plain query path; only
        # unbounded/large scans pay for a dedicated streaming connection
        small = limit is not None and 0 <= limit <= SMALL_SCAN_LIMIT
        runner = self.c.query if small else self.c.query_iter
        for r in runner(self.c.sql(" ".join(sql)), tuple(params)):
            yield self._row_to_event(r)

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
        """Columnar training scan: the dataset-builder's fast path.

        Returns ``(entity_ids, target_entity_ids, event_names,
        event_times_iso, ratings_raw)`` -- five python lists -- WITHOUT
        constructing an Event (or json-parsing properties) per row: the
        rating is extracted server-side via the dialect's numbers-only JSON
        expression, so string/bool ratings come back NULL exactly like the
        row path's isinstance check. ``event_times_iso`` carries the stored
        ISO8601 strings (full microsecond precision; event_time_ms would
        truncate sub-ms ordering the row path preserves). Time-ordered like
        ``find`` (event_time_ms ASC, event_id tie-break). At ML-20M scale
        this is the difference between seconds and minutes of ``pio
        train`` read time.
        """
        cols: tuple[list, ...] = ([], [], [], [], [])
        for chunk in self.iter_interaction_chunks(
            app_id=app_id,
            channel_id=channel_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            start_time=start_time,
            until_time=until_time,
            rating_key=rating_key,
        ):
            for acc, part in zip(cols, chunk):
                acc.extend(part)
        return cols

    def count_interactions(
        self,
        app_id: int,
        channel_id: int | None = None,
        event_names: list[str] | None = None,
        target_entity_type=...,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
    ) -> int:
        """Row count of one bounded interaction scan -- a single SQL
        aggregate, no row transfer. The snapshot layer uses it to verify
        that a snapshot's covered prefix still matches the event table
        (late-arriving or deleted events force a full rebuild instead of
        an inexact append refresh). Shares find()/scan_interactions()'s
        filter builder so the three paths cannot disagree on semantics.
        """
        sql = ["SELECT COUNT(*) FROM events WHERE app_id=? AND channel_id=?"]
        params: list = [app_id, self._ch(channel_id)]
        self._append_filters(
            sql,
            params,
            start_time=start_time,
            until_time=until_time,
            event_names=event_names,
            target_entity_type=target_entity_type,
        )
        return int(self.c.query(self.c.sql(" ".join(sql)), tuple(params))[0][0])

    def interaction_digest(
        self,
        app_id: int,
        channel_id: int | None = None,
        event_names: list[str] | None = None,
        target_entity_type=...,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
    ) -> tuple[int, int]:
        """``(row count, sum of event_time_ms %% TIME_DIGEST_MOD)`` over one
        bounded scan -- a single aggregate query, no row transfer. The
        snapshot refresh path compares it against the digest accumulated
        at spill time: a deletion balanced by a late-arriving insert keeps
        the COUNT but (outside sum collisions) not the time checksum, so
        an inexact append refresh is caught and rebuilt instead. The
        per-row modulus keeps the sum exact in any dialect's 64-bit
        integer SUM (no bigint overflow / float fallback).
        """
        from predictionio_tpu_torch.data.snapshot import TIME_DIGEST_MOD

        mod_expr = self.c.TIME_MOD_EXPR.format(mod=TIME_DIGEST_MOD)
        sql = [
            f"SELECT COUNT(*), COALESCE(SUM({mod_expr}), 0)"
            " FROM events WHERE app_id=? AND channel_id=?"
        ]
        params: list = [app_id, self._ch(channel_id)]
        self._append_filters(
            sql,
            params,
            start_time=start_time,
            until_time=until_time,
            event_names=event_names,
            target_entity_type=target_entity_type,
        )
        row = self.c.query(self.c.sql(" ".join(sql)), tuple(params))[0]
        return int(row[0]), int(row[1])

    def iter_interaction_chunks(
        self,
        app_id: int,
        channel_id: int | None = None,
        event_names: list[str] | None = None,
        target_entity_type=...,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        rating_key: str = "rating",
        chunk_rows: int = 262_144,
    ):
        """``scan_interactions`` as a bounded-memory stream: yields the same
        five columns in chunks of at most ``chunk_rows`` rows, riding the
        dialect's streaming cursor (server-side for Postgres) instead of
        materializing the full result. Ordering is DETERMINISTIC across
        repeated scans and across processes (event_time_ms, event_id) --
        the sharded multi-host reader replays this stream on every process
        and must assign identical vocabulary ids and identical tie-breaks.
        """
        select = (
            "SELECT entity_id, target_entity_id, event, event_time,"
            f" {self.c.JSON_NUMBER_EXPR} FROM events"
        )
        sql = [select, "WHERE app_id=? AND channel_id=?"]
        # the JSON expr's placeholders appear FIRST in the statement
        params: list = [
            *self.c.json_number_params(rating_key),
            app_id,
            self._ch(channel_id),
        ]
        self._append_filters(
            sql,
            params,
            start_time=start_time,
            until_time=until_time,
            event_names=event_names,
            target_entity_type=target_entity_type,
        )
        sql.append("ORDER BY event_time_ms ASC, event_id ASC")
        cols: tuple[list, ...] = ([], [], [], [], [])
        for r in self.c.query_iter(self.c.sql(" ".join(sql)), tuple(params)):
            for acc, v in zip(cols, r):
                acc.append(v)
            if len(cols[0]) >= chunk_rows:
                yield cols
                cols = ([], [], [], [], [])
        if cols[0]:
            yield cols
