"""Copy of ``predictionio_tpu/data/storage/s3.py``, the package renamed.

S3 model blob store.

Parity role of reference ``storage/s3/.../S3Models.scala`` (apache/
predictionio layout, unverified -- SURVEY.md section 2.2 #11): a
``Models``-only backend writing one object per engine instance.

Configuration:

    PIO_STORAGE_SOURCES_S3_TYPE=s3
    PIO_STORAGE_SOURCES_S3_BUCKET_NAME=my-bucket
    PIO_STORAGE_SOURCES_S3_BASE_PATH=models        (optional key prefix)
    PIO_STORAGE_SOURCES_S3_ENDPOINT=...            (optional, e.g. minio)
    PIO_STORAGE_SOURCES_S3_REGION=...              (optional)

Credentials come from the standard AWS chain (env/instance profile).
Driver: boto3 (optional dependency -- a clear error is raised when absent).
"""

from __future__ import annotations

from typing import Optional

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import Model, StorageClientConfig


class StorageClient(base.BaseStorageClient):
    def __init__(self, config: StorageClientConfig):
        super().__init__(config)
        try:
            import boto3
        except ImportError as exc:
            raise RuntimeError(
                "the s3 storage backend requires boto3; install it or switch"
                " PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE to a localfs/sqlite"
                " source"
            ) from exc
        props = config.properties
        bucket = props.get("BUCKET_NAME")
        if not bucket:
            raise RuntimeError(
                "s3 storage source is missing BUCKET_NAME"
                " (PIO_STORAGE_SOURCES_<S>_BUCKET_NAME)"
            )
        client_kwargs = {}
        if props.get("ENDPOINT"):
            client_kwargs["endpoint_url"] = props["ENDPOINT"]
        if props.get("REGION"):
            client_kwargs["region_name"] = props["REGION"]
        self._s3 = boto3.client("s3", **client_kwargs)
        self._bucket = bucket
        self._prefix = props.get("BASE_PATH", "").strip("/")

    def get_dao(self, repo: str):
        if repo != "models":
            raise NotImplementedError(
                f"s3 backend only provides the 'models' repository, not {repo!r}"
            )
        return S3Models(self._s3, self._bucket, self._prefix)

    def close(self) -> None:
        pass


class S3Models(base.Models):
    def __init__(self, s3_client, bucket: str, prefix: str):
        self.s3 = s3_client
        self.bucket = bucket
        self.prefix = prefix

    def _key(self, model_id: str) -> str:
        name = base.safe_blob_name(model_id)
        return f"{self.prefix}/{name}" if self.prefix else name

    def insert(self, model: Model) -> None:
        self.s3.put_object(
            Bucket=self.bucket, Key=self._key(model.id), Body=model.models
        )

    def get(self, model_id: str) -> Optional[Model]:
        try:
            resp = self.s3.get_object(Bucket=self.bucket, Key=self._key(model_id))
        except Exception as exc:
            # boto3 surfaces missing keys as ClientError NoSuchKey; match on
            # the error code without importing botocore at module scope
            code = getattr(exc, "response", {}).get("Error", {}).get("Code", "")
            if code in ("NoSuchKey", "404"):
                return None
            raise
        return Model(id=model_id, models=resp["Body"].read())

    def delete(self, model_id: str) -> None:
        self.s3.delete_object(Bucket=self.bucket, Key=self._key(model_id))
