"""Copy of ``predictionio_tpu/data/storage/mysql/__init__.py``, the package renamed.

MySQL storage backend (TYPE=mysql)."""

from predictionio_tpu_torch.data.storage.mysql.client import StorageClient

__all__ = ["StorageClient"]
