"""Copy of ``predictionio_tpu/data/storage/hbase/__init__.py``, the package renamed.

HBase event-store backend (TYPE=hbase, events only)."""

from predictionio_tpu_torch.data.storage.hbase.client import StorageClient

__all__ = ["StorageClient"]
