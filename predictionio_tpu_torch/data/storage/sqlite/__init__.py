"""SQLite storage backend: full-stack (events + metadata + models).

Plays the parity role of the reference's JDBC backend
(``storage/jdbc/.../JDBC*.scala``, apache/predictionio layout, unverified --
SURVEY.md section 2.2 #10): a single relational source that can host all three
repositories, with DDL auto-create. SQLite is the zero-config dev default;
the same DAO contracts admit server-grade backends.

Port copy: ``predictionio_tpu/data/storage/sqlite/__init__.py``
(framework-free), verbatim, under the port's package name;
``tests/test_torch_imports.py`` holds it to the original.
"""

from predictionio_tpu_torch.data.storage.sqlite.client import StorageClient

__all__ = ["StorageClient"]
