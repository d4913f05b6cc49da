"""Port of ``tests/test_mysql_backend.py``: the same cases against the port's copy
(``predictionio_tpu_torch``), the package renamed.

MySQL backend tests that run without a live server (driver is gated).

Shared DAO logic is covered by the sqlite suites (same ``sql_common`` code);
here we pin the dialect surface: URL parsing, identifier quoting (`key` is
reserved in MySQL), conflict SQL, the jdbc-TYPE scheme dispatch, and the
gated-driver error.
"""

import pytest

from predictionio_tpu_torch.data.storage.mysql.client import (
    StorageClient,
    parse_connection_properties,
)


class TestConnectionProperties:
    def test_jdbc_url(self):
        kwargs = parse_connection_properties(
            {"URL": "jdbc:mysql://db.example:3307/piodb"}
        )
        assert kwargs == {"host": "db.example", "port": 3307, "database": "piodb"}

    def test_plain_url_with_credentials(self):
        kwargs = parse_connection_properties({"URL": "mysql://pio:secret@h/pio"})
        assert kwargs["user"] == "pio"
        assert kwargs["password"] == "secret"
        assert kwargs["database"] == "pio"

    def test_explicit_properties_override_url(self):
        kwargs = parse_connection_properties(
            {
                "URL": "jdbc:mysql://ignored:1111/ignored",
                "HOST": "real",
                "PORT": "3306",
                "DBNAME": "prod",
                "USERNAME": "u",
                "PASSWORD": "p",
            }
        )
        assert kwargs == {
            "host": "real", "port": 3306, "database": "prod", "user": "u",
            "password": "p",
        }

    def test_defaults(self):
        assert parse_connection_properties({}) == {
            "host": "localhost", "port": 3306, "database": "pio",
        }

    def test_bad_scheme(self):
        with pytest.raises(ValueError, match="scheme"):
            parse_connection_properties({"URL": "postgresql://h/db"})


class TestDialect:
    def sql(self, stmt):
        return StorageClient.sql(StorageClient, stmt)

    def test_placeholder_rewrite(self):
        assert (
            self.sql("INSERT INTO apps (name, description) VALUES (?, ?)")
            == "INSERT INTO apps (name, description) VALUES (%s, %s)"
        )

    def test_reserved_key_column_is_backquoted(self):
        assert (
            self.sql("SELECT key, app_id, events FROM access_keys WHERE key=?")
            == "SELECT `key`, app_id, events FROM access_keys WHERE `key`=%s"
        )
        # table names containing 'key' stay untouched
        assert "access_keys" in self.sql("DELETE FROM access_keys WHERE key=?")
        assert "`access_keys`" not in self.sql("DELETE FROM access_keys WHERE key=?")

    def test_key_rewrite_scoped_to_access_keys_statements(self):
        # a non-access_keys statement with a bare `key` word stays intact
        stmt = "SELECT properties FROM events WHERE entity_id = 'key'"
        assert self.sql(stmt) == stmt
        # ... as does 'key' inside a string literal of an access_keys stmt
        assert (
            self.sql("SELECT key FROM access_keys WHERE key = 'key'")
            == "SELECT `key` FROM access_keys WHERE `key` = 'key'"
        )
        # escaped-quote literals stay protected
        assert (
            self.sql("SELECT key FROM access_keys WHERE app_id = 'a''key'''")
            == "SELECT `key` FROM access_keys WHERE app_id = 'a''key'''"
        )

    def test_conflict_sql_is_mysql_flavored(self):
        assert StorageClient.INSERT_IGNORE_EVENT_CHANNELS.startswith("INSERT IGNORE")
        assert "ON DUPLICATE KEY UPDATE" in StorageClient.UPSERT_MODEL
        assert "ON CONFLICT" not in StorageClient.UPSERT_MODEL
        assert "INSERT OR" not in StorageClient.UPSERT_MODEL


class TestGatedDriver:
    def test_missing_driver_is_a_clear_error(self, monkeypatch):
        import builtins

        real_import = builtins.__import__

        def no_mysql(name, *args, **kwargs):
            if name in ("pymysql", "MySQLdb"):
                raise ImportError(f"No module named {name!r}")
            return real_import(name, *args, **kwargs)

        monkeypatch.setattr(builtins, "__import__", no_mysql)
        from predictionio_tpu_torch.data.storage.base import StorageClientConfig

        with pytest.raises(RuntimeError, match="PyMySQL"):
            StorageClient(StorageClientConfig(properties={}))


class TestJdbcDispatch:
    def test_mysql_url_routes_to_mysql(self, monkeypatch):
        import builtins

        from predictionio_tpu_torch.data.storage import jdbc
        from predictionio_tpu_torch.data.storage.base import StorageClientConfig

        real_import = builtins.__import__

        def no_mysql(name, *args, **kwargs):
            if name in ("pymysql", "MySQLdb"):
                raise ImportError(f"No module named {name!r}")
            return real_import(name, *args, **kwargs)

        monkeypatch.setattr(builtins, "__import__", no_mysql)
        with pytest.raises(RuntimeError, match="PyMySQL"):
            jdbc.StorageClient(
                StorageClientConfig(properties={"URL": "jdbc:mysql://h/db"})
            )

    def test_postgres_url_routes_to_postgres(self, monkeypatch):
        import builtins

        from predictionio_tpu_torch.data.storage import jdbc
        from predictionio_tpu_torch.data.storage.base import StorageClientConfig

        real_import = builtins.__import__

        def no_pg(name, *args, **kwargs):
            if name == "psycopg2":
                raise ImportError("No module named 'psycopg2'")
            return real_import(name, *args, **kwargs)

        monkeypatch.setattr(builtins, "__import__", no_pg)
        with pytest.raises(RuntimeError, match="psycopg2"):
            jdbc.StorageClient(
                StorageClientConfig(properties={"URL": "jdbc:postgresql://h/db"})
            )
        # no URL at all keeps the round-1 default: postgres
        with pytest.raises(RuntimeError, match="psycopg2"):
            jdbc.StorageClient(StorageClientConfig(properties={}))
