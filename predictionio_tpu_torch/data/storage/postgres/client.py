"""Copy of ``predictionio_tpu/data/storage/postgres/client.py``, the package renamed.

PostgreSQL implementations of every DAO contract.

Parity role of the reference's scalikejdbc module ``storage/jdbc/.../
JDBC{Apps,AccessKeys,Channels,EngineInstances,EvaluationInstances,LEvents,
PEvents,Models}.scala`` (apache/predictionio layout, unverified -- SURVEY.md
section 2.2 #10): a full-stack backend (events + metadata + models) for
PostgreSQL, with DDL auto-create on first connect. The DAO logic is shared
with the sqlite backend via ``sql_common``; only the connection, paramstyle,
and dialect DDL live here.

Configuration (reference env-var contract, SURVEY.md section 5.6):

    PIO_STORAGE_SOURCES_PGSQL_TYPE=postgres   (or: jdbc)
    PIO_STORAGE_SOURCES_PGSQL_URL=jdbc:postgresql://host:5432/pio
    PIO_STORAGE_SOURCES_PGSQL_USERNAME=pio
    PIO_STORAGE_SOURCES_PGSQL_PASSWORD=...

``URL`` accepts both ``jdbc:postgresql://`` (reference form) and plain
``postgresql://`` URLs; HOST/PORT/DBNAME properties may be used instead.
Driver: psycopg2 (optional dependency -- a clear error is raised when it is
not installed; nothing else in the framework depends on it).
"""

from __future__ import annotations

import threading
import uuid
from typing import Iterator

from predictionio_tpu_torch.data.storage import sql_common
from predictionio_tpu_torch.data.storage.base import StorageClientConfig

_SCHEMA_STATEMENTS = [
    """CREATE TABLE IF NOT EXISTS apps (
      id BIGSERIAL PRIMARY KEY,
      name TEXT UNIQUE NOT NULL,
      description TEXT NOT NULL DEFAULT ''
    )""",
    """CREATE TABLE IF NOT EXISTS channels (
      id BIGSERIAL PRIMARY KEY,
      name TEXT NOT NULL,
      app_id BIGINT NOT NULL,
      UNIQUE(app_id, name)
    )""",
    """CREATE TABLE IF NOT EXISTS access_keys (
      key TEXT PRIMARY KEY,
      app_id BIGINT NOT NULL,
      events TEXT NOT NULL DEFAULT '[]'
    )""",
    """CREATE TABLE IF NOT EXISTS engine_instances (
      id TEXT PRIMARY KEY,
      status TEXT NOT NULL,
      start_time TEXT NOT NULL,
      end_time TEXT,
      engine_id TEXT NOT NULL,
      engine_version TEXT NOT NULL,
      engine_variant TEXT NOT NULL,
      engine_factory TEXT NOT NULL,
      batch TEXT NOT NULL DEFAULT '',
      env TEXT NOT NULL DEFAULT '{}',
      runtime_conf TEXT NOT NULL DEFAULT '{}',
      data_source_params TEXT NOT NULL DEFAULT '{}',
      preparator_params TEXT NOT NULL DEFAULT '{}',
      algorithms_params TEXT NOT NULL DEFAULT '[]',
      serving_params TEXT NOT NULL DEFAULT '{}'
    )""",
    """CREATE TABLE IF NOT EXISTS evaluation_instances (
      id TEXT PRIMARY KEY,
      status TEXT NOT NULL,
      start_time TEXT NOT NULL,
      end_time TEXT,
      evaluation_class TEXT NOT NULL,
      engine_params_generator_class TEXT NOT NULL,
      batch TEXT NOT NULL DEFAULT '',
      env TEXT NOT NULL DEFAULT '{}',
      evaluator_results TEXT NOT NULL DEFAULT '',
      evaluator_results_html TEXT NOT NULL DEFAULT '',
      evaluator_results_json TEXT NOT NULL DEFAULT ''
    )""",
    """CREATE TABLE IF NOT EXISTS models (
      id TEXT PRIMARY KEY,
      models BYTEA NOT NULL
    )""",
    """CREATE TABLE IF NOT EXISTS event_channels (
      app_id BIGINT NOT NULL,
      channel_id BIGINT NOT NULL,
      PRIMARY KEY (app_id, channel_id)
    )""",
    """CREATE TABLE IF NOT EXISTS events (
      event_id TEXT NOT NULL,
      app_id BIGINT NOT NULL,
      channel_id BIGINT NOT NULL,
      event TEXT NOT NULL,
      entity_type TEXT NOT NULL,
      entity_id TEXT NOT NULL,
      target_entity_type TEXT,
      target_entity_id TEXT,
      properties TEXT NOT NULL DEFAULT '{}',
      event_time TEXT NOT NULL,
      event_time_ms BIGINT NOT NULL,
      pr_id TEXT,
      creation_time TEXT NOT NULL,
      PRIMARY KEY (app_id, channel_id, event_id)
    )""",
    """CREATE INDEX IF NOT EXISTS idx_events_scan
      ON events (app_id, channel_id, entity_type, event_time_ms)""",
    """CREATE INDEX IF NOT EXISTS idx_events_name
      ON events (app_id, channel_id, event, event_time_ms)""",
]


def parse_connection_properties(props: dict[str, str]) -> dict:
    """URL/HOST/PORT/DBNAME/USERNAME/PASSWORD properties -> psycopg2 kwargs.

    Accepts the reference's ``jdbc:postgresql://...`` URL form verbatim,
    including JDBC-style query params (?user=..&password=..&sslmode=..).
    """
    return sql_common.parse_jdbc_url_properties(
        props,
        schemes=("postgresql", "postgres"),
        backend_name="postgres",
        default_port=5432,
        dbname_key="dbname",
        query_keys=("user", "password", "sslmode", "connect_timeout"),
    )


class StorageClient(sql_common.SQLStorageClient):
    """Thread-safe psycopg2 connection with DDL auto-create."""

    placeholder = "%s"
    INSERT_IGNORE_EVENT_CHANNELS = (
        "INSERT INTO event_channels (app_id, channel_id) VALUES (?, ?)"
        " ON CONFLICT DO NOTHING"
    )
    UPSERT_MODEL = (
        "INSERT INTO models (id, models) VALUES (?, ?)"
        " ON CONFLICT (id) DO UPDATE SET models = EXCLUDED.models"
    )
    INSERT_EVENTS_IGNORE_PREFIX = "INSERT INTO events"
    INSERT_EVENTS_IGNORE_SUFFIX = " ON CONFLICT (app_id, channel_id, event_id) DO NOTHING"
    # properties is TEXT holding JSON; -> / ->> want jsonb and a bare key.
    # jsonb_typeof gate keeps string/bool ratings NULL (from_events parity)
    JSON_NUMBER_EXPR = (
        "CASE WHEN jsonb_typeof(properties::jsonb -> ?) = 'number'"
        " THEN (properties::jsonb ->> ?) END"
    )
    # MOD(), not the % operator: psycopg2's client-side interpolation
    # would eat a bare % in statement text (same truncated semantics)
    TIME_MOD_EXPR = "MOD(event_time_ms, {mod})"

    @classmethod
    def json_number_params(cls, key: str) -> tuple:
        return (key, key)

    def __init__(self, config: StorageClientConfig):
        super().__init__(config)
        try:
            import psycopg2
        except ImportError as exc:
            raise RuntimeError(
                "the postgres storage backend requires psycopg2; install it or"
                " switch PIO_STORAGE_SOURCES_*_TYPE to 'sqlite'"
            ) from exc
        kwargs = parse_connection_properties(config.properties)
        self._connect_kwargs = kwargs
        self._conn = psycopg2.connect(**kwargs)
        self._lock = threading.RLock()
        # `with conn:` = one transaction (commit on exit, rollback on error),
        # so batch_insert keeps the sqlite backend's all-or-nothing semantics
        with self._lock, self._conn, self._conn.cursor() as cur:
            for stmt in _SCHEMA_STATEMENTS:
                cur.execute(stmt)

    def execute(self, sql: str, params: tuple = ()):
        with self._lock, self._conn, self._conn.cursor() as cur:
            cur.execute(sql, params)
            return sql_common.CursorResult(cur.rowcount)

    def executemany(self, sql: str, rows: list[tuple]):
        with self._lock, self._conn, self._conn.cursor() as cur:
            cur.executemany(sql, rows)
            return sql_common.CursorResult(cur.rowcount)

    def insert_returning_id(self, sql: str, params: tuple) -> int:
        with self._lock, self._conn, self._conn.cursor() as cur:
            cur.execute(sql + " RETURNING id", params)
            return cur.fetchone()[0]

    def query(self, sql: str, params: tuple = ()) -> list[tuple]:
        with self._lock, self._conn, self._conn.cursor() as cur:
            cur.execute(sql, params)
            return cur.fetchall()

    def query_iter(self, sql: str, params: tuple = ()) -> Iterator[tuple]:
        """Stream via a server-side (named) cursor on a dedicated connection,
        mirroring the sqlite streaming path: a multi-GB event scan (train
        reads, export, aggregate_properties) never materializes client-side
        and never holds the client-wide lock across consumer yields."""
        import psycopg2

        conn = psycopg2.connect(**self._connect_kwargs)
        try:
            with conn, conn.cursor(name=f"pio_scan_{id(self)}_{uuid.uuid4().hex[:8]}") as cur:
                cur.execute(sql, params)
                while True:
                    rows = cur.fetchmany(1024)
                    if not rows:
                        return
                    yield from rows
        finally:
            conn.close()

    def close(self) -> None:
        with self._lock:
            self._conn.close()


