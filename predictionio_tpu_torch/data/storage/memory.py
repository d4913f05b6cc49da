"""In-memory storage backend (test/dev parity role of reference LocalFS+H2).

Reuses the sqlite implementation over an in-memory database so behavior is
identical to the persistent dev backend.

Port copy: ``predictionio_tpu/data/storage/memory.py`` (framework-free),
verbatim, under the port's package name; ``tests/test_torch_imports.py``
holds it to the original.
"""

from __future__ import annotations

from predictionio_tpu_torch.data.storage.base import StorageClientConfig
from predictionio_tpu_torch.data.storage.sqlite.client import StorageClient as _SQLiteClient


class StorageClient(_SQLiteClient):
    def __init__(self, config: StorageClientConfig):
        config.properties = dict(config.properties)
        config.properties["PATH"] = ":memory:"
        super().__init__(config)
