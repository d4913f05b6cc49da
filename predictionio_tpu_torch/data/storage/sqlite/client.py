"""SQLite storage backend: the zero-config dev default.

Parity role of the reference's JDBC quickstart path (SURVEY.md section 2.2
#10); the DAO logic itself lives in ``sql_common`` and is shared with the
postgres backend.

Port copy: ``predictionio_tpu/data/storage/sqlite/client.py``
(framework-free), verbatim, under the port's package name;
``tests/test_torch_imports.py`` holds it to the original.
"""

from __future__ import annotations

import sqlite3
import threading

from predictionio_tpu_torch.data.storage import sql_common
from predictionio_tpu_torch.data.storage.base import StorageClientConfig

_SCHEMA = """
CREATE TABLE IF NOT EXISTS apps (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL,
  description TEXT NOT NULL DEFAULT ''
);
CREATE TABLE IF NOT EXISTS channels (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT NOT NULL,
  app_id INTEGER NOT NULL,
  UNIQUE(app_id, name)
);
CREATE TABLE IF NOT EXISTS access_keys (
  key TEXT PRIMARY KEY,
  app_id INTEGER NOT NULL,
  events TEXT NOT NULL DEFAULT '[]'
);
CREATE TABLE IF NOT EXISTS engine_instances (
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
);
CREATE TABLE IF NOT EXISTS evaluation_instances (
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
);
CREATE TABLE IF NOT EXISTS models (
  id TEXT PRIMARY KEY,
  models BLOB NOT NULL
);
CREATE TABLE IF NOT EXISTS event_channels (
  app_id INTEGER NOT NULL,
  channel_id INTEGER NOT NULL,
  PRIMARY KEY (app_id, channel_id)
);
CREATE TABLE IF NOT EXISTS events (
  event_id TEXT NOT NULL,
  app_id INTEGER NOT NULL,
  channel_id INTEGER NOT NULL,
  event TEXT NOT NULL,
  entity_type TEXT NOT NULL,
  entity_id TEXT NOT NULL,
  target_entity_type TEXT,
  target_entity_id TEXT,
  properties TEXT NOT NULL DEFAULT '{}',
  event_time TEXT NOT NULL,
  event_time_ms INTEGER NOT NULL,
  pr_id TEXT,
  creation_time TEXT NOT NULL,
  PRIMARY KEY (app_id, channel_id, event_id)
);
CREATE INDEX IF NOT EXISTS idx_events_scan
  ON events (app_id, channel_id, entity_type, event_time_ms);
CREATE INDEX IF NOT EXISTS idx_events_name
  ON events (app_id, channel_id, event, event_time_ms);
"""


class StorageClient(sql_common.SQLStorageClient):
    """Thread-safe sqlite connection; one file holds all repositories."""

    def __init__(self, config: StorageClientConfig):
        super().__init__(config)
        path = config.properties.get("PATH", ":memory:")
        self._path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        # NORMAL (default) never fsyncs on commit in WAL-journal mode --
        # fast, but an OS crash can lose recent commits. FULL fsyncs every
        # commit: the durable per-request baseline the ingestion A/B
        # (ingest_bench) measures group commit against.
        sync_mode = config.properties.get("SYNCHRONOUS", "NORMAL").upper()
        if sync_mode not in ("OFF", "NORMAL", "FULL", "EXTRA"):
            raise ValueError(
                f"SYNCHRONOUS must be OFF|NORMAL|FULL|EXTRA, got {sync_mode!r}"
            )
        self._conn.execute(f"PRAGMA synchronous={sync_mode}")
        self._lock = threading.RLock()
        with self._lock, self._conn:
            self._conn.executescript(_SCHEMA)

    def execute(self, sql: str, params: tuple = ()) -> sqlite3.Cursor:
        with self._lock, self._conn:
            return self._conn.execute(sql, params)

    def executemany(self, sql: str, rows: list[tuple]) -> sqlite3.Cursor:
        with self._lock, self._conn:
            return self._conn.executemany(sql, rows)

    def insert_returning_id(self, sql: str, params: tuple) -> int:
        return self.execute(sql, params).lastrowid

    def query(self, sql: str, params: tuple = ()) -> list[tuple]:
        with self._lock:
            return self._conn.execute(sql, params).fetchall()

    def query_iter(self, sql: str, params: tuple = ()):
        """Stream rows without blocking writers.

        Opens a dedicated read connection (WAL mode gives it a consistent
        snapshot independent of concurrent writes on the shared connection).
        An in-memory database is private to its connection, so there we fall
        back to a single locked fetchall.
        """
        if self._path == ":memory:":
            yield from self.query(sql, params)
            return
        conn = sqlite3.connect(self._path, check_same_thread=False)
        try:
            cursor = conn.execute(sql, params)
            while True:
                rows = cursor.fetchmany(1024)
                if not rows:
                    return
                yield from rows
        finally:
            conn.close()

    def close(self) -> None:
        with self._lock:
            self._conn.close()
