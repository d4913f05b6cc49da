"""Copy of ``predictionio_tpu/data/storage/jdbc/__init__.py``, the package renamed.

TYPE=jdbc: the reference's storage type name, dispatched by URL scheme.

The reference's scalikejdbc module serves PostgreSQL and MySQL behind the one
``jdbc`` TYPE (SURVEY.md section 2.2 #10); here the URL scheme picks the
dialect module. No URL (or a postgres URL) keeps round-1 behavior: postgres.
"""

from __future__ import annotations

from predictionio_tpu_torch.data.storage.base import StorageClientConfig


def StorageClient(config: StorageClientConfig):
    """Factory matching the registry's ``module.StorageClient(config)`` call."""
    url = config.properties.get("URL", "")
    scheme = url[len("jdbc:"):] if url.startswith("jdbc:") else url
    if scheme.startswith(("mysql:", "mariadb:")):
        from predictionio_tpu_torch.data.storage.mysql import client as mysql_client

        return mysql_client.StorageClient(config)
    from predictionio_tpu_torch.data.storage.postgres import client as pg_client

    return pg_client.StorageClient(config)
