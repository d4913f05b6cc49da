"""Port of ``tests/test_hdfs_models.py``: the same cases against the port's copy
(``predictionio_tpu_torch``), the package renamed.

HDFS model store: fake-transport DAO tests + the WebHDFS wire protocol
against a local stub namenode/datanode (zero-egress box; SURVEY.md section
2.2 #11 -- the reference's storage/hdfs module is a Models-only backend)."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from predictionio_tpu_torch.data.storage.base import Model, StorageClientConfig
from predictionio_tpu_torch.data.storage.hdfs import (
    FakeTransport,
    StorageClient,
    WebHDFSTransport,
)
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401


class TestHDFSModelsFake:
    def _client(self):
        return StorageClient(
            StorageClientConfig(properties={"TRANSPORT": "fake", "PATH": "/pio/models"})
        )

    def test_round_trip(self):
        dao = self._client().get_dao("models")
        dao.insert(Model(id="inst-1", models=b"\x00blob\xff"))
        got = dao.get("inst-1")
        assert got is not None and got.models == b"\x00blob\xff"
        dao.delete("inst-1")
        assert dao.get("inst-1") is None

    def test_missing_model_is_none(self):
        assert self._client().get_dao("models").get("nope") is None

    def test_weird_ids_encode(self):
        dao = self._client().get_dao("models")
        weird = "a/b?c=d e#f"
        dao.insert(Model(id=weird, models=b"x"))
        assert dao.get(weird).models == b"x"

    def test_non_models_repo_rejected(self):
        with pytest.raises(NotImplementedError, match="models"):
            self._client().get_dao("events")

    def test_registry_wiring(self, tmp_path, monkeypatch):
        from predictionio_tpu_torch.data import storage as storage_registry

        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
        monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE", "HDFS")
        monkeypatch.setenv("PIO_STORAGE_SOURCES_HDFS_TYPE", "hdfs")
        monkeypatch.setenv("PIO_STORAGE_SOURCES_HDFS_TRANSPORT", "fake")
        storage_registry.reset()
        try:
            models = storage_registry.get_model_data_models()
            models.insert(Model(id="via-registry", models=b"m"))
            assert models.get("via-registry").models == b"m"
        finally:
            storage_registry.reset()


class _StubWebHDFS(BaseHTTPRequestHandler):
    """Namenode + datanode in one server: CREATE answers with a Location
    (JSON or 307 depending on the server's ``redirect_style``), the
    datanode path accepts the payload, OPEN 307-redirects to a data URL."""

    def log_message(self, *a):  # quiet
        pass

    @property
    def store(self):
        return self.server.store

    def do_PUT(self):
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length)
        if self.path.startswith("/webhdfs/v1"):  # namenode CREATE
            datanode = f"http://127.0.0.1:{self.server.server_port}/datanode{self.path}"
            if self.server.redirect_style == "json":
                payload = json.dumps({"Location": datanode}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
            else:
                self.send_response(307)
                self.send_header("Location", datanode)
                self.send_header("Content-Length", "0")
                self.end_headers()
        elif self.path.startswith("/datanode"):
            path = self.path[len("/datanode"):].split("?")[0]
            self.store[path] = body
            self.send_response(201)
            self.send_header("Content-Length", "0")
            self.end_headers()
        else:
            self.send_error(400)

    def do_GET(self):
        clean = self.path.split("?")[0]
        if clean.startswith("/webhdfs/v1"):  # namenode OPEN -> redirect
            if clean not in self.store:
                self.send_error(404)
                return
            self.send_response(307)
            self.send_header(
                "Location",
                f"http://127.0.0.1:{self.server.server_port}/data{clean}",
            )
            self.send_header("Content-Length", "0")
            self.end_headers()
        elif clean.startswith("/data/"):
            data = self.store[clean[len("/data"):]]
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:
            self.send_error(400)

    def do_DELETE(self):
        clean = self.path.split("?")[0]
        existed = self.store.pop(clean, None) is not None
        payload = json.dumps({"boolean": existed}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)


@pytest.fixture(params=["json", "307"])
def stub_webhdfs(request):
    server = ThreadingHTTPServer(("127.0.0.1", 0), _StubWebHDFS)
    server.store = {}
    server.redirect_style = request.param
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    thread.join(timeout=5)


class TestWebHDFSProtocol:
    def test_write_read_delete_over_http(self, stub_webhdfs):
        t = WebHDFSTransport(stub_webhdfs, user="pio")
        t.write("/pio/models/m1", b"model-bytes")
        assert t.read("/pio/models/m1") == b"model-bytes"
        assert t.delete("/pio/models/m1") is True
        assert t.read("/pio/models/m1") is None
        assert t.delete("/pio/models/m1") is False
