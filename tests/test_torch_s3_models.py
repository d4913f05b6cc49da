"""Port of ``tests/test_s3_models.py``: the same cases against the port's copy
(``predictionio_tpu_torch``), the package renamed.

S3 model store tests against an in-memory fake boto3 (zero-egress box)."""

import sys
import types

import pytest

from predictionio_tpu_torch.data.storage.base import Model, StorageClientConfig


class _FakeBody:
    def __init__(self, data):
        self._data = data

    def read(self):
        return self._data


class _NoSuchKey(Exception):
    def __init__(self):
        self.response = {"Error": {"Code": "NoSuchKey"}}


class _FakeS3Client:
    def __init__(self, **kwargs):
        self.kwargs = kwargs
        self.objects = {}

    def put_object(self, Bucket, Key, Body):
        self.objects[(Bucket, Key)] = Body

    def get_object(self, Bucket, Key):
        if (Bucket, Key) not in self.objects:
            raise _NoSuchKey()
        return {"Body": _FakeBody(self.objects[(Bucket, Key)])}

    def delete_object(self, Bucket, Key):
        self.objects.pop((Bucket, Key), None)


@pytest.fixture()
def fake_boto3(monkeypatch):
    mod = types.ModuleType("boto3")
    clients = []

    def client(service, **kwargs):
        assert service == "s3"
        c = _FakeS3Client(**kwargs)
        clients.append(c)
        return c

    mod.client = client
    mod._clients = clients
    monkeypatch.setitem(sys.modules, "boto3", mod)
    return mod


class TestS3Models:
    def test_round_trip(self, fake_boto3):
        from predictionio_tpu_torch.data.storage.s3 import StorageClient

        sc = StorageClient(
            StorageClientConfig(
                properties={"BUCKET_NAME": "b", "BASE_PATH": "models/"}
            )
        )
        dao = sc.get_dao("models")
        dao.insert(Model(id="inst1", models=b"blob"))
        got = dao.get("inst1")
        assert got.models == b"blob"
        # key layout: prefix + collision-safe name
        assert ("b", "models/pio_model_inst1.bin") in fake_boto3._clients[0].objects

        assert dao.get("missing") is None
        dao.delete("inst1")
        assert dao.get("inst1") is None

    def test_weird_ids_encode(self, fake_boto3):
        from predictionio_tpu_torch.data.storage.s3 import StorageClient

        sc = StorageClient(StorageClientConfig(properties={"BUCKET_NAME": "b"}))
        dao = sc.get_dao("models")
        dao.insert(Model(id="a/b c", models=b"1"))
        assert dao.get("a/b c").models == b"1"
        keys = list(fake_boto3._clients[0].objects)
        assert "/" not in keys[0][1].removeprefix("pio_model_")

    def test_endpoint_and_region_forwarded(self, fake_boto3):
        from predictionio_tpu_torch.data.storage.s3 import StorageClient

        StorageClient(
            StorageClientConfig(
                properties={
                    "BUCKET_NAME": "b",
                    "ENDPOINT": "http://minio:9000",
                    "REGION": "us-x-1",
                }
            )
        )
        assert fake_boto3._clients[0].kwargs == {
            "endpoint_url": "http://minio:9000", "region_name": "us-x-1",
        }

    def test_missing_bucket_is_clear(self, fake_boto3):
        from predictionio_tpu_torch.data.storage.s3 import StorageClient

        with pytest.raises(RuntimeError, match="BUCKET_NAME"):
            StorageClient(StorageClientConfig(properties={}))

    def test_missing_driver_is_clear(self, monkeypatch):
        import builtins

        real_import = builtins.__import__

        def no_boto3(name, *args, **kwargs):
            if name == "boto3":
                raise ImportError("No module named 'boto3'")
            return real_import(name, *args, **kwargs)

        monkeypatch.setattr(builtins, "__import__", no_boto3)
        monkeypatch.delitem(sys.modules, "boto3", raising=False)
        from predictionio_tpu_torch.data.storage.s3 import StorageClient

        with pytest.raises(RuntimeError, match="boto3"):
            StorageClient(StorageClientConfig(properties={"BUCKET_NAME": "b"}))

    def test_non_models_repo_rejected(self, fake_boto3):
        from predictionio_tpu_torch.data.storage.s3 import StorageClient

        sc = StorageClient(StorageClientConfig(properties={"BUCKET_NAME": "b"}))
        with pytest.raises(NotImplementedError):
            sc.get_dao("events")
