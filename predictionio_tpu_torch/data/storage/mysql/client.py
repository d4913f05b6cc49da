"""Copy of ``predictionio_tpu/data/storage/mysql/client.py``, the package renamed.

MySQL implementations of every DAO contract.

The reference's scalikejdbc module (``storage/jdbc/.../JDBC*.scala`` --
apache/predictionio layout, unverified, SURVEY.md section 2.2 #10) serves
PostgreSQL *and* MySQL from one DAO set; this module is the MySQL half of
that contract. The DAO logic is shared with the sqlite/postgres backends via
``sql_common``; only the connection, dialect DDL, identifier quoting, and
conflict-handling statements live here.

Configuration (reference env-var contract, SURVEY.md section 5.6):

    PIO_STORAGE_SOURCES_MYSQL_TYPE=mysql   (or: jdbc with a mysql URL)
    PIO_STORAGE_SOURCES_MYSQL_URL=jdbc:mysql://host:3306/pio
    PIO_STORAGE_SOURCES_MYSQL_USERNAME=pio
    PIO_STORAGE_SOURCES_MYSQL_PASSWORD=...

Driver: PyMySQL (preferred) or MySQLdb/mysqlclient -- optional dependencies;
a clear error is raised when neither is installed.

MySQL dialect notes, relative to the shared DAO SQL:

- ``key`` (access_keys PK column) is a reserved word -> ``sql()`` backtick-
  quotes the bare token via word-boundary rewrite.
- TEXT columns cannot be primary keys -> VARCHAR(191) for id/key columns
  (191 keeps the index under the 767-byte utf8mb4 limit of older InnoDB).
- blobs use LONGBLOB, JSON payloads LONGTEXT.
"""

from __future__ import annotations

import re
import threading
from typing import Iterator

from predictionio_tpu_torch.data.storage import sql_common
from predictionio_tpu_torch.data.storage.base import StorageClientConfig

_SCHEMA_STATEMENTS = [
    """CREATE TABLE IF NOT EXISTS apps (
      id BIGINT AUTO_INCREMENT PRIMARY KEY,
      name VARCHAR(191) UNIQUE NOT NULL,
      description TEXT NOT NULL
    ) DEFAULT CHARSET=utf8mb4 COLLATE=utf8mb4_bin""",
    """CREATE TABLE IF NOT EXISTS channels (
      id BIGINT AUTO_INCREMENT PRIMARY KEY,
      name VARCHAR(191) NOT NULL,
      app_id BIGINT NOT NULL,
      UNIQUE KEY uq_channels (app_id, name)
    ) DEFAULT CHARSET=utf8mb4 COLLATE=utf8mb4_bin""",
    """CREATE TABLE IF NOT EXISTS access_keys (
      `key` VARCHAR(191) PRIMARY KEY,
      app_id BIGINT NOT NULL,
      events LONGTEXT NOT NULL
    ) DEFAULT CHARSET=utf8mb4 COLLATE=utf8mb4_bin""",
    """CREATE TABLE IF NOT EXISTS engine_instances (
      id VARCHAR(191) PRIMARY KEY,
      status VARCHAR(32) NOT NULL,
      start_time VARCHAR(64) NOT NULL,
      end_time VARCHAR(64),
      engine_id VARCHAR(191) NOT NULL,
      engine_version VARCHAR(191) NOT NULL,
      engine_variant TEXT NOT NULL,
      engine_factory TEXT NOT NULL,
      batch TEXT NOT NULL,
      env LONGTEXT NOT NULL,
      runtime_conf LONGTEXT NOT NULL,
      data_source_params LONGTEXT NOT NULL,
      preparator_params LONGTEXT NOT NULL,
      algorithms_params LONGTEXT NOT NULL,
      serving_params LONGTEXT NOT NULL
    ) DEFAULT CHARSET=utf8mb4 COLLATE=utf8mb4_bin""",
    """CREATE TABLE IF NOT EXISTS evaluation_instances (
      id VARCHAR(191) PRIMARY KEY,
      status VARCHAR(32) NOT NULL,
      start_time VARCHAR(64) NOT NULL,
      end_time VARCHAR(64),
      evaluation_class TEXT NOT NULL,
      engine_params_generator_class TEXT NOT NULL,
      batch TEXT NOT NULL,
      env LONGTEXT NOT NULL,
      evaluator_results LONGTEXT NOT NULL,
      evaluator_results_html LONGTEXT NOT NULL,
      evaluator_results_json LONGTEXT NOT NULL
    ) DEFAULT CHARSET=utf8mb4 COLLATE=utf8mb4_bin""",
    """CREATE TABLE IF NOT EXISTS models (
      id VARCHAR(191) PRIMARY KEY,
      models LONGBLOB NOT NULL
    ) DEFAULT CHARSET=utf8mb4 COLLATE=utf8mb4_bin""",
    """CREATE TABLE IF NOT EXISTS event_channels (
      app_id BIGINT NOT NULL,
      channel_id BIGINT NOT NULL,
      PRIMARY KEY (app_id, channel_id)
    ) DEFAULT CHARSET=utf8mb4 COLLATE=utf8mb4_bin""",
    """CREATE TABLE IF NOT EXISTS events (
      event_id VARCHAR(191) NOT NULL,
      app_id BIGINT NOT NULL,
      channel_id BIGINT NOT NULL,
      event VARCHAR(191) NOT NULL,
      entity_type VARCHAR(191) NOT NULL,
      entity_id TEXT NOT NULL,
      target_entity_type TEXT,
      target_entity_id TEXT,
      properties LONGTEXT NOT NULL,
      event_time VARCHAR(64) NOT NULL,
      event_time_ms BIGINT NOT NULL,
      pr_id TEXT,
      creation_time VARCHAR(64) NOT NULL,
      PRIMARY KEY (app_id, channel_id, event_id)
    ) DEFAULT CHARSET=utf8mb4 COLLATE=utf8mb4_bin""",
    """CREATE INDEX idx_events_scan
      ON events (app_id, channel_id, entity_type, event_time_ms)""",
    """CREATE INDEX idx_events_name
      ON events (app_id, channel_id, event, event_time_ms)""",
]

# `key` is reserved in MySQL; the shared DAO SQL uses it bare ONLY as the
# access_keys column. \b keeps access_keys/keys intact; the rewrite is
# scoped to access_keys statements and skips single-quoted string literals,
# so a statement carrying 'key' as data is never mangled.
_KEY_TOKEN = re.compile(r"\bkey\b")
_SQUOTE_LITERAL = re.compile(r"('(?:[^']|'')*')")


def parse_connection_properties(props: dict[str, str]) -> dict:
    """URL/HOST/PORT/DBNAME/USERNAME/PASSWORD properties -> DB-API kwargs.

    Accepts the reference's ``jdbc:mysql://...`` URL form verbatim.
    """
    return sql_common.parse_jdbc_url_properties(
        props,
        schemes=("mysql", "mariadb"),
        backend_name="mysql",
        default_port=3306,
        dbname_key="database",
    )


def _connect(kwargs: dict):
    """PyMySQL first (pure python, commonest), then MySQLdb (mysqlclient)."""
    try:
        import pymysql
    except ImportError:
        pymysql = None
    if pymysql is not None:
        return pymysql.connect(charset="utf8mb4", **kwargs)
    try:
        import MySQLdb
    except ImportError as exc:
        raise RuntimeError(
            "the mysql storage backend requires PyMySQL or mysqlclient;"
            " install one or switch PIO_STORAGE_SOURCES_*_TYPE to 'sqlite'"
        ) from exc
    kwargs = dict(kwargs)
    kwargs["db"] = kwargs.pop("database")
    if "password" in kwargs:
        kwargs["passwd"] = kwargs.pop("password")
    return MySQLdb.connect(charset="utf8mb4", **kwargs)


class StorageClient(sql_common.SQLStorageClient):
    """Thread-safe MySQL connection with DDL auto-create."""

    placeholder = "%s"
    INSERT_IGNORE_EVENT_CHANNELS = (
        "INSERT IGNORE INTO event_channels (app_id, channel_id) VALUES (?, ?)"
    )
    UPSERT_MODEL = (
        "INSERT INTO models (id, models) VALUES (?, ?)"
        " ON DUPLICATE KEY UPDATE models = VALUES(models)"
    )
    INSERT_EVENTS_IGNORE_PREFIX = "INSERT IGNORE INTO events"
    INSERT_EVENTS_IGNORE_SUFFIX = ""
    # MySQL's JSON_TYPE vocabulary is uppercase and splits the numeric kinds
    JSON_NUMBER_EXPR = (
        "CASE WHEN JSON_TYPE(JSON_EXTRACT(properties, ?)) IN"
        " ('INTEGER', 'DOUBLE', 'DECIMAL', 'UNSIGNED INTEGER')"
        " THEN JSON_EXTRACT(properties, ?) END"
    )
    # MOD(), not the % operator: pymysql/mysqlclient %-interpolation would
    # eat a bare % in statement text (same truncated semantics)
    TIME_MOD_EXPR = "MOD(event_time_ms, {mod})"

    def __init__(self, config: StorageClientConfig):
        super().__init__(config)
        kwargs = parse_connection_properties(config.properties)
        self._connect_kwargs = kwargs
        self._conn = _connect(kwargs)
        self._lock = threading.RLock()
        with self._lock:
            cur = self._conn.cursor()
            for stmt in _SCHEMA_STATEMENTS:
                try:
                    cur.execute(stmt)
                except Exception as exc:
                    # MySQL's CREATE INDEX has no IF NOT EXISTS; only the
                    # duplicate-index-name error (1061) on re-connect is
                    # expected -- anything else (permissions, disk, lost
                    # connection) must surface
                    code = exc.args[0] if exc.args else None
                    if code != 1061:
                        raise
            cur.close()
            self._conn.commit()

    def sql(self, statement: str) -> str:
        if "access_keys" in statement:
            statement = "".join(
                part
                if part.startswith("'")
                else _KEY_TOKEN.sub("`key`", part)
                for part in _SQUOTE_LITERAL.split(statement)
            )
        return statement.replace("?", self.placeholder)

    def execute(self, sql: str, params: tuple = ()):
        with self._lock:
            cur = self._conn.cursor()
            try:
                cur.execute(sql, params)
                self._conn.commit()
                return sql_common.CursorResult(cur.rowcount)
            except Exception:
                self._conn.rollback()
                raise
            finally:
                cur.close()

    def executemany(self, sql: str, rows: list[tuple]):
        with self._lock:
            cur = self._conn.cursor()
            try:
                cur.executemany(sql, rows)
                self._conn.commit()
                return sql_common.CursorResult(cur.rowcount)
            except Exception:
                self._conn.rollback()
                raise
            finally:
                cur.close()

    def insert_returning_id(self, sql: str, params: tuple) -> int:
        with self._lock:
            cur = self._conn.cursor()
            try:
                cur.execute(sql, params)
                self._conn.commit()
                return cur.lastrowid
            except Exception:
                self._conn.rollback()
                raise
            finally:
                cur.close()

    def query(self, sql: str, params: tuple = ()) -> list[tuple]:
        with self._lock:
            cur = self._conn.cursor()
            try:
                cur.execute(sql, params)
                rows = cur.fetchall()
                # end the implicit read transaction: under InnoDB REPEATABLE
                # READ a never-committed reader keeps a frozen snapshot and
                # stops seeing other processes' committed writes
                self._conn.commit()
                return rows
            except Exception:
                self._conn.rollback()
                raise
            finally:
                cur.close()

    def query_iter(self, sql: str, params: tuple = ()) -> Iterator[tuple]:
        """Stream on a dedicated connection with an unbuffered cursor so a
        multi-GB event scan never materializes client-side (the PyMySQL
        SSCursor / MySQLdb SSCursor server-side streaming cursor)."""
        conn = _connect(self._connect_kwargs)
        try:
            cursor_cls = None
            try:
                from pymysql.cursors import SSCursor as cursor_cls  # noqa: F811
            except ImportError:
                try:
                    from MySQLdb.cursors import SSCursor as cursor_cls  # noqa: F811
                except ImportError:
                    pass
            cur = conn.cursor(cursor_cls) if cursor_cls else conn.cursor()
            try:
                cur.execute(sql, params)
                while True:
                    rows = cur.fetchmany(1024)
                    if not rows:
                        return
                    yield from rows
            finally:
                cur.close()
        finally:
            conn.close()

    def close(self) -> None:
        with self._lock:
            self._conn.close()


