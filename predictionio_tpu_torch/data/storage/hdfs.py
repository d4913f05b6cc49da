"""Copy of ``predictionio_tpu/data/storage/hdfs.py``, the package renamed.

HDFS model blob store over the WebHDFS REST API.

Parity role of reference ``storage/hdfs/.../HDFSModels.scala`` (apache/
predictionio layout, unverified -- SURVEY.md section 2.2 #11): a
``Models``-only backend writing one file per engine instance. The reference
used the Hadoop FileSystem client library; a JVM-free rebuild speaks
WebHDFS (the namenode's stock REST endpoint) directly over urllib -- no
driver dependency at all.

Configuration (reference env-var contract, SURVEY.md section 5.6):

    PIO_STORAGE_SOURCES_HDFS_TYPE=hdfs
    PIO_STORAGE_SOURCES_HDFS_HOSTS=namenode      (WebHDFS host)
    PIO_STORAGE_SOURCES_HDFS_PORTS=9870          (9870 Hadoop 3.x, 50070 2.x)
    PIO_STORAGE_SOURCES_HDFS_PATH=/pio/models    (base directory)
    PIO_STORAGE_SOURCES_HDFS_USERNAME=pio        (optional user.name= auth)
    PIO_STORAGE_SOURCES_HDFS_TRANSPORT=fake      (in-memory; CI only)

WebHDFS protocol notes: CREATE/OPEN are two-step -- the namenode answers
with a redirect to a datanode. urllib follows the GET redirect natively;
for PUT we request ``noredirect=true`` (Hadoop 2.8+: 200 + JSON Location)
and fall back to reading the 307 Location header.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import Model, StorageClientConfig


class WebHDFSTransport:
    """Minimal WebHDFS client: write / read / delete one file."""

    def __init__(self, base_url: str, user: str = "", timeout: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.user = user
        self.timeout = timeout

    def _url(self, path: str, op: str, **params) -> str:
        q = {"op": op, **params}
        if self.user:
            q["user.name"] = self.user
        return (
            f"{self.base_url}/webhdfs/v1{urllib.parse.quote(path)}"
            f"?{urllib.parse.urlencode(q)}"
        )

    def _request(self, method: str, url: str, data: bytes | None = None):
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/octet-stream")
        return urllib.request.urlopen(req, timeout=self.timeout)

    def write(self, path: str, data: bytes) -> None:
        url = self._url(path, "CREATE", overwrite="true", noredirect="true")
        location = None
        try:
            with self._request("PUT", url) as resp:
                payload = resp.read()
                if payload:
                    location = json.loads(payload).get("Location")
        except urllib.error.HTTPError as exc:
            if exc.code != 307:  # older namenodes redirect instead
                raise
            location = exc.headers.get("Location")
        if not location:
            raise RuntimeError(
                f"webhdfs CREATE for {path!r} returned no datanode location"
            )
        with self._request("PUT", location, data=data) as resp:
            if resp.status not in (200, 201):
                raise RuntimeError(
                    f"webhdfs datanode write for {path!r} failed: {resp.status}"
                )

    def read(self, path: str) -> bytes | None:
        try:
            # urllib follows the namenode->datanode redirect for GET
            with self._request("GET", self._url(path, "OPEN")) as resp:
                return resp.read()
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                return None
            raise

    def delete(self, path: str) -> bool:
        try:
            with self._request("DELETE", self._url(path, "DELETE")) as resp:
                return bool(json.loads(resp.read()).get("boolean"))
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                return False
            raise


class FakeTransport:
    """In-memory WebHDFS stand-in (this CI image has no HDFS; SURVEY.md
    section 4 tier 2 runs the same DAO suite against real backends)."""

    def __init__(self):
        self.files: dict[str, bytes] = {}

    def write(self, path: str, data: bytes) -> None:
        self.files[path] = bytes(data)

    def read(self, path: str) -> bytes | None:
        return self.files.get(path)

    def delete(self, path: str) -> bool:
        return self.files.pop(path, None) is not None


class StorageClient(base.BaseStorageClient):
    def __init__(self, config: StorageClientConfig, transport=None):
        super().__init__(config)
        props = config.properties
        self.base_path = "/" + props.get("PATH", "/pio/models").strip("/")
        if transport is not None:
            self.transport = transport
        elif props.get("TRANSPORT", "").lower() == "fake":
            self.transport = FakeTransport()
        else:
            host = (props.get("HOSTS", "localhost")).split(",")[0]
            port = (props.get("PORTS", "9870")).split(",")[0]
            scheme = (props.get("SCHEMES", "http")).split(",")[0]
            self.transport = WebHDFSTransport(
                f"{scheme}://{host}:{port}", user=props.get("USERNAME", "")
            )

    def get_dao(self, repo: str):
        if repo != "models":
            raise NotImplementedError(
                f"hdfs backend only provides the 'models' repository, not {repo!r}"
            )
        return HDFSModels(self.transport, self.base_path)

    def close(self) -> None:
        pass


class HDFSModels(base.Models):
    def __init__(self, transport, base_path: str):
        self.transport = transport
        self.base_path = base_path

    def _path(self, model_id: str) -> str:
        return f"{self.base_path}/{base.safe_blob_name(model_id)}"

    def insert(self, model: Model) -> None:
        self.transport.write(self._path(model.id), model.models)

    def get(self, model_id: str) -> Optional[Model]:
        data = self.transport.read(self._path(model_id))
        return Model(id=model_id, models=data) if data is not None else None

    def delete(self, model_id: str) -> None:
        self.transport.delete(self._path(model_id))
