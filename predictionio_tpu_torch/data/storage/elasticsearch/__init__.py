"""Copy of ``predictionio_tpu/data/storage/elasticsearch/__init__.py``, the package renamed.

Elasticsearch storage backend (TYPE=elasticsearch)."""

from predictionio_tpu_torch.data.storage.elasticsearch.client import StorageClient

__all__ = ["StorageClient"]
