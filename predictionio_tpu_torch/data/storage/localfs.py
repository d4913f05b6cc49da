"""Local-filesystem model blob store.

Parity role of reference ``storage/localfs/.../LocalFSModels.scala``
(apache/predictionio layout, unverified -- SURVEY.md section 2.2 #11): a
``Models``-only backend writing one blob file per engine instance.

Port copy: ``predictionio_tpu/data/storage/localfs.py``
(framework-free), verbatim, under the port's package name;
``tests/test_torch_imports.py`` holds it to the original.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import Model, StorageClientConfig


class StorageClient(base.BaseStorageClient):
    def __init__(self, config: StorageClientConfig):
        super().__init__(config)
        self.base_path = Path(
            config.properties.get("PATH", os.path.expanduser("~/.pio_store/models"))
        )
        self.base_path.mkdir(parents=True, exist_ok=True)

    def get_dao(self, repo: str):
        if repo != "models":
            raise NotImplementedError(
                f"localfs backend only provides the 'models' repository, not {repo!r}"
            )
        return LocalFSModels(self.base_path)


class LocalFSModels(base.Models):
    def __init__(self, base_path: Path):
        self.base_path = base_path

    def _path(self, model_id: str) -> Path:
        return self.base_path / base.safe_blob_name(model_id)

    def insert(self, model: Model) -> None:
        tmp = self._path(model.id).with_suffix(".tmp")
        tmp.write_bytes(model.models)
        tmp.replace(self._path(model.id))

    def get(self, model_id: str) -> Optional[Model]:
        p = self._path(model_id)
        if not p.exists():
            return None
        return Model(id=model_id, models=p.read_bytes())

    def delete(self, model_id: str) -> None:
        p = self._path(model_id)
        if p.exists():
            p.unlink()
