"""Copy of ``predictionio_tpu/data/storage/elasticsearch/transport.py``, the package renamed.

Elasticsearch REST transport: real HTTP + an in-memory fake.

The backend speaks the ES REST JSON API directly (parity role of the
reference's v0.13 REST-client module, ``storage/elasticsearch/.../
{StorageClient,ESUtils}.scala`` -- apache/predictionio layout, unverified,
SURVEY.md section 2.2 #9); no client library is required.

``FakeTransport`` interprets the exact query-DSL subset the DAOs emit
(bool filter: term/terms/range/exists + must_not, sort, size, search_after)
against in-memory indices. It exists because this CI image has no network
egress and no ES server (SURVEY.md section 4 tier 2 runs the same DAO suite
against real backends in containers); the env-gated live test
(``PIO_TEST_ES_URL``) drives the identical DAO code through HttpTransport.
"""

from __future__ import annotations

import base64
import json
import threading
import urllib.error
import urllib.request
from typing import Any


class ESError(RuntimeError):
    def __init__(self, status: int, body: Any):
        super().__init__(f"elasticsearch error {status}: {str(body)[:500]}")
        self.status = status
        self.body = body


class HttpTransport:
    """Minimal ES REST client over urllib (GET/PUT/POST/DELETE + JSON)."""

    def __init__(
        self,
        base_url: str,
        username: str = "",
        password: str = "",
        timeout: float = 30.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self._auth = None
        if username:
            token = base64.b64encode(f"{username}:{password}".encode()).decode()
            self._auth = f"Basic {token}"

    def request(
        self,
        method: str,
        path: str,
        body: dict | None = None,
        params: dict[str, str] | None = None,
    ) -> tuple[int, dict]:
        url = self.base_url + path
        if params:
            url += "?" + "&".join(f"{k}={v}" for k, v in params.items())
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        if self._auth:
            req.add_header("Authorization", self._auth)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = resp.read()
                return resp.status, json.loads(payload) if payload else {}
        except urllib.error.HTTPError as exc:
            payload = exc.read()
            try:
                parsed = json.loads(payload) if payload else {}
            except json.JSONDecodeError:
                parsed = {"raw": payload.decode("utf-8", "replace")}
            if exc.code == 404:
                return 404, parsed
            raise ESError(exc.code, parsed) from exc


class FakeTransport:
    """In-memory ES: documents per index + the DAO query-DSL subset.

    Deliberately strict: unknown endpoints or query clauses raise instead
    of returning empty results, so a DAO change that emits DSL the fake
    does not model fails loudly in CI rather than passing vacuously.
    """

    def __init__(self):
        # index -> doc_id -> {"_source": dict, "_version": int}
        self.indices: dict[str, dict[str, dict]] = {}
        # index -> the explicit mapping body it was created with
        self.mappings: dict[str, dict] = {}
        # template name -> {"index_patterns": [...], "template": {...}}
        self.index_templates: dict[str, dict] = {}
        self._lock = threading.RLock()

    # -- endpoint router -----------------------------------------------------
    def request(
        self,
        method: str,
        path: str,
        body: dict | None = None,
        params: dict[str, str] | None = None,
    ) -> tuple[int, dict]:
        with self._lock:
            parts = [p for p in path.split("/") if p]
            if not parts:
                return 200, {"cluster_name": "fake"}
            if parts[-1] == "_search":
                return self._search("/".join(parts[:-1]), body or {})
            if parts[-1] == "_refresh":
                return 200, {}
            if parts[-1] == "_delete_by_query":
                return self._delete_by_query("/".join(parts[:-1]), body or {})
            if parts[-1] == "_bulk":
                raise NotImplementedError("fake ES: _bulk not modeled")
            if len(parts) == 2 and parts[0] == "_index_template" and method == "PUT":
                self.index_templates[parts[1]] = dict(body or {})
                return 200, {"acknowledged": True}
            if len(parts) == 3 and parts[1] == "_doc":
                index, doc_id = parts[0], parts[2]
                if method in ("PUT", "POST"):
                    return self._index_doc(index, doc_id, body)
                if method == "GET":
                    return self._get_doc(index, doc_id)
                if method == "DELETE":
                    return self._delete_doc(index, doc_id)
            if len(parts) == 4 and parts[1] == "_update":
                raise NotImplementedError("fake ES: _update not modeled")
            if len(parts) == 1 and method == "PUT":  # create index
                if parts[0] in self.indices:
                    # real ES 400s on re-create; the DAO ensure_index path
                    # treats that as success, so model it faithfully
                    raise ESError(
                        400,
                        {"error": {"type": "resource_already_exists_exception"}},
                    )
                self.indices[parts[0]] = {}
                self.mappings[parts[0]] = (body or {}).get("mappings", {})
                return 200, {"acknowledged": True}
            if len(parts) == 1 and method == "DELETE":
                self.indices.pop(parts[0], None)
                self.mappings.pop(parts[0], None)
                return 200, {"acknowledged": True}
            if len(parts) == 1 and method == "HEAD":
                return (200 if parts[0] in self.indices else 404), {}
            raise NotImplementedError(f"fake ES: {method} {path!r} not modeled")

    # -- document ops --------------------------------------------------------
    def _index_doc(self, index: str, doc_id: str, body: dict) -> tuple[int, dict]:
        if index not in self.indices:
            # real ES would auto-create with DYNAMIC mappings here -- the
            # exact failure mode the explicit-mapping contract exists to
            # prevent (analyzed term queries, unsortable ids). Fail loudly
            # so a DAO write path that skipped ensure_index is caught in CI.
            raise NotImplementedError(
                f"fake ES: write to index {index!r} before explicit creation"
                " -- DAO must ensure_index (explicit mappings) first"
            )
        docs = self.indices[index]
        existing = docs.get(doc_id)
        version = (existing["_version"] + 1) if existing else 1
        docs[doc_id] = {"_source": dict(body or {}), "_version": version}
        return 200, {"_id": doc_id, "_version": version, "result": "updated" if existing else "created"}

    def _get_doc(self, index: str, doc_id: str) -> tuple[int, dict]:
        doc = self.indices.get(index, {}).get(doc_id)
        if doc is None:
            return 404, {"found": False}
        return 200, {"_id": doc_id, "found": True, "_source": dict(doc["_source"]), "_version": doc["_version"]}

    def _delete_doc(self, index: str, doc_id: str) -> tuple[int, dict]:
        docs = self.indices.get(index, {})
        if doc_id in docs:
            del docs[doc_id]
            return 200, {"result": "deleted"}
        return 404, {"result": "not_found"}

    def _delete_by_query(self, index: str, body: dict) -> tuple[int, dict]:
        docs = self.indices.get(index, {})
        doomed = [
            doc_id
            for doc_id, doc in docs.items()
            if self._matches(doc["_source"], body.get("query", {"match_all": {}}))
        ]
        for doc_id in doomed:
            del docs[doc_id]
        return 200, {"deleted": len(doomed)}

    # -- search --------------------------------------------------------------
    def _search(self, index: str, body: dict) -> tuple[int, dict]:
        # index may be a comma list or a wildcard pattern
        import fnmatch

        names = []
        for pat in index.split(","):
            if "*" in pat:
                names.extend(n for n in self.indices if fnmatch.fnmatch(n, pat))
            elif pat in self.indices:
                names.append(pat)
        hits = []
        for name in names:
            for doc_id, doc in self.indices[name].items():
                if self._matches(doc["_source"], body.get("query", {"match_all": {}})):
                    hits.append({"_index": name, "_id": doc_id, "_source": dict(doc["_source"])})

        for clause in reversed(body.get("sort", [])):
            if clause == "_doc":
                continue
            [(field, spec)] = clause.items() if isinstance(clause, dict) else [(clause, "asc")]
            order = spec.get("order", "asc") if isinstance(spec, dict) else spec
            hits.sort(
                key=lambda h: (h["_source"].get(field) is None, h["_source"].get(field)),
                reverse=(order == "desc"),
            )
        if body.get("search_after") is not None:
            after = body["search_after"]

            def sort_vals(h):
                vals = []
                for clause in body.get("sort", []):
                    [(field, spec)] = (
                        clause.items() if isinstance(clause, dict) else [(clause, "asc")]
                    )
                    vals.append(h["_source"].get(field))
                return vals

            # emit strictly-after hits in current sort order
            def after_key(h):
                return sort_vals(h)

            passed = []
            for h in hits:
                vals = after_key(h)
                cmp = self._tuple_cmp(vals, after, body.get("sort", []))
                if cmp > 0:
                    passed.append(h)
            hits = passed
        size = body.get("size", 10)
        hits = hits[: int(size)]
        for h in hits:
            h["sort"] = [
                h["_source"].get(next(iter(c))) if isinstance(c, dict) else None
                for c in body.get("sort", [])
            ]
        source_filter = body.get("_source")
        if isinstance(source_filter, list):
            for h in hits:
                h["_source"] = {
                    k: v for k, v in h["_source"].items() if k in source_filter
                }
        return 200, {"hits": {"total": {"value": len(hits)}, "hits": hits}}

    @staticmethod
    def _tuple_cmp(vals, after, sort_clauses) -> int:
        """-1/0/1 of vals vs after under the per-field sort orders."""
        for v, a, clause in zip(vals, after, sort_clauses):
            [(field, spec)] = (
                clause.items() if isinstance(clause, dict) else [(clause, "asc")]
            )
            order = spec.get("order", "asc") if isinstance(spec, dict) else spec
            if v == a:
                continue
            less = (v is None, v) < (a is None, a)
            if order == "desc":
                less = not less
            return -1 if less else 1
        return 0

    def _matches(self, source: dict, query: dict) -> bool:
        [(kind, clause)] = query.items()
        if kind == "match_all":
            return True
        if kind == "term":
            [(field, value)] = clause.items()
            if isinstance(value, dict):
                value = value["value"]
            return source.get(field) == value
        if kind == "terms":
            [(field, values)] = clause.items()
            return source.get(field) in values
        if kind == "range":
            [(field, bounds)] = clause.items()
            value = source.get(field)
            if value is None:
                return False
            if "gte" in bounds and not value >= bounds["gte"]:
                return False
            if "gt" in bounds and not value > bounds["gt"]:
                return False
            if "lte" in bounds and not value <= bounds["lte"]:
                return False
            if "lt" in bounds and not value < bounds["lt"]:
                return False
            return True
        if kind == "exists":
            return source.get(clause["field"]) is not None
        if kind == "bool":
            for sub in clause.get("filter", []):
                if not self._matches(source, sub):
                    return False
            for sub in clause.get("must", []):
                if not self._matches(source, sub):
                    return False
            for sub in clause.get("must_not", []):
                if self._matches(source, sub):
                    return False
            return True
        raise NotImplementedError(f"fake ES: query clause {kind!r} not modeled")
