"""Copy of ``predictionio_tpu/data/storage/postgres/__init__.py``, the package renamed.

PostgreSQL storage backend (reference JDBC-module parity)."""

from predictionio_tpu_torch.data.storage.postgres.client import StorageClient

__all__ = ["StorageClient"]
