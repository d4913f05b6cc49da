"""Copy of ``predictionio_tpu/data/storage/hbase/transport.py``, the package renamed.

HBase REST (Stargate) transport: real HTTP + an in-memory fake.

The backend speaks the HBase REST gateway's JSON protocol (cell values
base64-encoded) -- parity role of the reference's HBase client module
``storage/hbase/.../{StorageClient,HBLEvents,HBEventsUtil}.scala``
(apache/predictionio layout, unverified, SURVEY.md section 2.2 #8), which
used the Java HBase RPC client; REST is the gateway every HBase ships for
non-JVM clients.

Endpoints used: table schema PUT/DELETE, row PUT (multi-row), row GET,
row DELETE, scanner PUT/GET/DELETE with startRow/endRow/batch.

``FakeTransport`` models those endpoints over sorted in-memory tables, for
the zero-egress CI image (SURVEY.md section 4 tier 2 runs against a real
pseudo-distributed HBase in containers); the env-gated live test
(``PIO_TEST_HBASE_URL``) drives the identical DAO code over HTTP.
"""

from __future__ import annotations

import base64
import bisect
import json
import threading
import urllib.error
import urllib.request
import uuid
from typing import Optional


def b64(raw: bytes | str) -> str:
    if isinstance(raw, str):
        raw = raw.encode()
    return base64.b64encode(raw).decode()


def unb64(encoded: str) -> bytes:
    return base64.b64decode(encoded)


class HBaseError(RuntimeError):
    pass


class HttpTransport:
    """Minimal Stargate client over urllib."""

    def __init__(self, base_url: str, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _request(
        self, method: str, url: str, body: bytes | None = None
    ) -> tuple[int, dict, bytes]:
        req = urllib.request.Request(url, data=body, method=method)
        req.add_header("Accept", "application/json")
        if body is not None:
            req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, dict(resp.headers), resp.read()
        except urllib.error.HTTPError as exc:
            return exc.code, dict(exc.headers or {}), exc.read()

    def create_table(self, table: str, families: list[str]) -> None:
        body = json.dumps(
            {"name": table, "ColumnSchema": [{"name": f} for f in families]}
        ).encode()
        status, _, payload = self._request(
            "PUT", f"{self.base_url}/{table}/schema", body
        )
        if status not in (200, 201):
            raise HBaseError(f"create table {table}: {status} {payload[:200]!r}")

    def delete_table(self, table: str) -> None:
        self._request("DELETE", f"{self.base_url}/{table}/schema")

    def put_rows(self, table: str, rows: list[tuple[str, dict[str, bytes]]]) -> None:
        """rows: [(rowkey, {"family:qualifier": value_bytes})]"""
        payload = {
            "Row": [
                {
                    "key": b64(key),
                    "Cell": [
                        {"column": b64(col), "$": b64(val)}
                        for col, val in cells.items()
                    ],
                }
                for key, cells in rows
            ]
        }
        status, _, raw = self._request(
            "PUT",
            f"{self.base_url}/{table}/fakerow",  # rowkey in body per Stargate multi-put
            json.dumps(payload).encode(),
        )
        if status not in (200, 201):
            raise HBaseError(f"put rows into {table}: {status} {raw[:200]!r}")

    def get_row(self, table: str, rowkey: str) -> Optional[dict[str, bytes]]:
        status, _, payload = self._request(
            "GET", f"{self.base_url}/{table}/{urllib.request.quote(rowkey, safe='')}"
        )
        if status == 404:
            return None
        if status != 200:
            raise HBaseError(f"get row: {status} {payload[:200]!r}")
        doc = json.loads(payload)
        cells = {}
        for row in doc.get("Row", []):
            for cell in row.get("Cell", []):
                cells[unb64(cell["column"]).decode()] = unb64(cell["$"])
        return cells or None

    def delete_row(self, table: str, rowkey: str) -> bool:
        status, _, _ = self._request(
            "DELETE",
            f"{self.base_url}/{table}/{urllib.request.quote(rowkey, safe='')}",
        )
        return status == 200

    def scan(
        self,
        table: str,
        start_row: str | None = None,
        end_row: str | None = None,
        batch: int = 1000,
    ):
        """Yield (rowkey, cells) in key order."""
        spec: dict = {"batch": batch}
        if start_row is not None:
            spec["startRow"] = b64(start_row)
        if end_row is not None:
            spec["endRow"] = b64(end_row)
        status, headers, payload = self._request(
            "PUT", f"{self.base_url}/{table}/scanner", json.dumps(spec).encode()
        )
        if status == 404:
            return
        if status != 201:
            raise HBaseError(f"create scanner: {status} {payload[:200]!r}")
        location = headers.get("Location") or headers.get("location")
        try:
            while True:
                status, _, payload = self._request("GET", location)
                if status == 204 or not payload:
                    return
                if status != 200:
                    raise HBaseError(f"scanner next: {status} {payload[:200]!r}")
                doc = json.loads(payload)
                for row in doc.get("Row", []):
                    key = unb64(row["key"]).decode()
                    cells = {
                        unb64(c["column"]).decode(): unb64(c["$"])
                        for c in row.get("Cell", [])
                    }
                    yield key, cells
        finally:
            self._request("DELETE", location)


class FakeTransport:
    """In-memory Stargate: sorted tables of rowkey -> cells."""

    def __init__(self):
        self.tables: dict[str, dict[str, dict[str, bytes]]] = {}
        self._sorted_keys: dict[str, list[str]] = {}
        self._lock = threading.RLock()

    def create_table(self, table: str, families: list[str]) -> None:
        with self._lock:
            self.tables.setdefault(table, {})
            self._sorted_keys.setdefault(table, [])

    def delete_table(self, table: str) -> None:
        with self._lock:
            self.tables.pop(table, None)
            self._sorted_keys.pop(table, None)

    def put_rows(self, table: str, rows: list[tuple[str, dict[str, bytes]]]) -> None:
        with self._lock:
            if table not in self.tables:
                raise HBaseError(f"table {table!r} does not exist")
            data = self.tables[table]
            keys = self._sorted_keys[table]
            for key, cells in rows:
                if key not in data:
                    bisect.insort(keys, key)
                data.setdefault(key, {}).update(cells)

    def get_row(self, table: str, rowkey: str) -> Optional[dict[str, bytes]]:
        with self._lock:
            row = self.tables.get(table, {}).get(rowkey)
            return dict(row) if row else None

    def delete_row(self, table: str, rowkey: str) -> bool:
        with self._lock:
            data = self.tables.get(table, {})
            if rowkey in data:
                del data[rowkey]
                keys = self._sorted_keys[table]
                keys.pop(bisect.bisect_left(keys, rowkey))
                return True
            return False

    def scan(
        self,
        table: str,
        start_row: str | None = None,
        end_row: str | None = None,
        batch: int = 1000,
    ):
        with self._lock:
            if table not in self.tables:
                return
            keys = self._sorted_keys[table]
            lo = bisect.bisect_left(keys, start_row) if start_row is not None else 0
            hi = bisect.bisect_left(keys, end_row) if end_row is not None else len(keys)
            snapshot = [(k, dict(self.tables[table][k])) for k in keys[lo:hi]]
        yield from snapshot


def new_suffix() -> str:
    return uuid.uuid4().hex[:16]
