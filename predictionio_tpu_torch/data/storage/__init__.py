"""Copy of ``predictionio_tpu/data/storage/__init__.py``, the package renamed.

Storage registry: env-configured, pluggable backend discovery.

Behavioral model: reference ``data/.../storage/Storage.scala`` (apache/
predictionio layout, unverified -- SURVEY.md section 2.2 #6). Configuration
plane is identical:

- ``PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,MODELDATA}_{NAME,SOURCE}``
- ``PIO_STORAGE_SOURCES_<SOURCE>_{TYPE,PATH,...}``

Where the reference discovers backends by JVM reflection on a class-name
convention, we resolve ``TYPE`` through an explicit registry dict (extensible
via :func:`register_backend`) and import the backend module lazily.

Defaults (no env set): a sqlite file under ``$PIO_FS_BASEDIR`` (default
``~/.pio_store``) backs all three repositories -- zero-config dev bring-up,
the parity role of the reference's PGSQL quickstart path.
"""

from __future__ import annotations

import importlib
import os
import threading
from typing import Optional

from predictionio_tpu_torch.data.storage.base import (
    AccessKeys,
    Apps,
    BaseStorageClient,
    Channels,
    EngineInstances,
    EvaluationInstances,
    LEvents,
    Models,
    StorageClientConfig,
)

#: TYPE value -> module path providing a StorageClient class.
_BACKENDS: dict[str, str] = {
    "sqlite": "predictionio_tpu_torch.data.storage.sqlite",
    "memory": "predictionio_tpu_torch.data.storage.memory",
    "localfs": "predictionio_tpu_torch.data.storage.localfs",
    "postgres": "predictionio_tpu_torch.data.storage.postgres",
    "mysql": "predictionio_tpu_torch.data.storage.mysql",
    "elasticsearch": "predictionio_tpu_torch.data.storage.elasticsearch",
    "hbase": "predictionio_tpu_torch.data.storage.hbase",
    # reference TYPE name for the scalikejdbc module; URL scheme picks
    # postgres vs mysql (postgres when absent)
    "jdbc": "predictionio_tpu_torch.data.storage.jdbc",
    "s3": "predictionio_tpu_torch.data.storage.s3",
    "hdfs": "predictionio_tpu_torch.data.storage.hdfs",
}

_REPOS = ("METADATA", "EVENTDATA", "MODELDATA")


def register_backend(type_name: str, module_path: str) -> None:
    """Register a third-party backend (module must expose ``StorageClient``)."""
    _BACKENDS[type_name] = module_path


class StorageError(RuntimeError):
    pass


def base_dir() -> str:
    """The filesystem root (``$PIO_FS_BASEDIR``) shared by storage defaults,
    daemon pidfiles/logs, and the native-kernel cache fallback."""
    return os.environ.get("PIO_FS_BASEDIR", os.path.expanduser("~/.pio_store"))


_base_dir = base_dir


class _Registry:
    """Process-wide singleton cache of storage clients and DAOs."""

    def __init__(self):
        self._lock = threading.RLock()
        self._clients: dict[str, BaseStorageClient] = {}

    # -- config resolution --------------------------------------------------
    def _repo_source(self, repo: str) -> str:
        return os.environ.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "PIO_SQLITE")

    def _source_config(self, source: str) -> tuple[str, StorageClientConfig]:
        prefix = f"PIO_STORAGE_SOURCES_{source}_"
        props = {
            k[len(prefix):]: v for k, v in os.environ.items() if k.startswith(prefix)
        }
        type_name = props.pop("TYPE", "sqlite" if source == "PIO_SQLITE" else None)
        if type_name is None:
            raise StorageError(
                f"storage source {source!r} has no {prefix}TYPE configured"
            )
        if type_name == "sqlite" and "PATH" not in props:
            os.makedirs(_base_dir(), exist_ok=True)
            props["PATH"] = os.path.join(_base_dir(), "pio.db")
        if type_name == "localfs" and "PATH" not in props:
            props["PATH"] = os.path.join(_base_dir(), "models")
        return type_name, StorageClientConfig(properties=props)

    def client_for_source(self, source: str) -> BaseStorageClient:
        with self._lock:
            if source not in self._clients:
                type_name, config = self._source_config(source)
                if type_name not in _BACKENDS:
                    raise StorageError(
                        f"unknown storage type {type_name!r}"
                        f" (known: {sorted(_BACKENDS)})"
                    )
                module = importlib.import_module(_BACKENDS[type_name])
                self._clients[source] = module.StorageClient(config)
            return self._clients[source]

    def dao(self, repo_env: str, dao_name: str):
        return self.client_for_source(self._repo_source(repo_env)).get_dao(dao_name)

    def reset(self) -> None:
        with self._lock:
            for client in self._clients.values():
                try:
                    client.close()
                except Exception:
                    pass
            self._clients.clear()


_registry = _Registry()


# -- public accessors (parity: Storage.getLEvents()/getMetaDataApps()/...) ---

def get_l_events() -> LEvents:
    return _registry.dao("EVENTDATA", "events")


def get_meta_data_apps() -> Apps:
    return _registry.dao("METADATA", "apps")


def get_meta_data_channels() -> Channels:
    return _registry.dao("METADATA", "channels")


def get_meta_data_access_keys() -> AccessKeys:
    return _registry.dao("METADATA", "access_keys")


def get_meta_data_engine_instances() -> EngineInstances:
    return _registry.dao("METADATA", "engine_instances")


def get_meta_data_evaluation_instances() -> EvaluationInstances:
    return _registry.dao("METADATA", "evaluation_instances")


def get_model_data_models() -> Models:
    return _registry.dao("MODELDATA", "models")


def reset() -> None:
    """Close cached clients (tests; env changes take effect on next access)."""
    _registry.reset()


#: property keys safe to echo in `pio status` output; anything else
#: (passwords, tokens, connection strings) is redacted
_SAFE_PROPERTY_KEYS = {"PATH", "HOSTS", "PORTS", "HOST", "PORT", "SCHEMES", "INDEX"}


def config_summary() -> dict[str, dict[str, str]]:
    """Resolved repository->source->type mapping (for ``pio status``)."""
    out = {}
    for repo in _REPOS:
        source = _registry._repo_source(repo)
        type_name, cfg = _registry._source_config(source)
        out[repo] = {
            "source": source,
            "type": type_name,
            **{
                k.lower(): (v if k in _SAFE_PROPERTY_KEYS else "<redacted>")
                for k, v in cfg.properties.items()
            },
        }
    return out


def verify_all_data_objects() -> list[str]:
    """Touch every repository; return list of failures (for ``pio status``).

    Parity role of ``Storage.verifyAllDataObjects`` (SURVEY.md section 2.2 #6).
    """
    failures = []
    checks = [
        ("metadata apps", get_meta_data_apps),
        ("metadata channels", get_meta_data_channels),
        ("metadata access keys", get_meta_data_access_keys),
        ("metadata engine instances", get_meta_data_engine_instances),
        ("metadata evaluation instances", get_meta_data_evaluation_instances),
        ("model data", get_model_data_models),
        ("event data", get_l_events),
    ]
    for name, fn in checks:
        try:
            fn()
        except Exception as exc:
            failures.append(f"{name}: {exc}")
    return failures
