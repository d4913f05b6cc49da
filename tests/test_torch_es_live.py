"""Port of ``tests/test_es_live.py``: the same cases against the port's copy
(``predictionio_tpu_torch``), the package renamed.

Live Elasticsearch integration: the full DAO suite against a real server
(reference tier-2 scope, SURVEY.md section 4: upstream CI ran the ES specs
against containerized ES).

Env-gated -- zero-egress CI has no server, so these skip unless the
operator provides a URL:

    PIO_TEST_ES_URL=http://localhost:9200

Every test deletes all ``pio_test_*`` indices, so point this at a
DISPOSABLE cluster only.
"""

import os
import urllib.parse

import pytest

_URL = os.environ.get("PIO_TEST_ES_URL")

pytestmark = pytest.mark.skipif(not _URL, reason="no PIO_TEST_ES_URL configured")


def _wipe(client):
    # GET the wildcard (non-destructive, allowed by default) then delete by
    # concrete name: wildcard DELETE is blocked by ES's
    # action.destructive_requires_name default
    status, body = client.transport.request("GET", "/pio_test_*")
    for name in body if status == 200 else []:
        client.transport.request("DELETE", f"/{name}")


@pytest.fixture()
def storage_env(tmp_path, monkeypatch):
    """Same contract as conftest's sqlite fixture, against a live ES."""
    from predictionio_tpu_torch.data import storage as storage_registry

    u = urllib.parse.urlparse(_URL)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "LIVEES")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_LIVEES_TYPE", "elasticsearch")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_LIVEES_HOSTS", u.hostname or "localhost")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_LIVEES_PORTS", str(u.port or 9200))
    monkeypatch.setenv("PIO_STORAGE_SOURCES_LIVEES_SCHEMES", u.scheme or "http")
    if u.username:
        monkeypatch.setenv("PIO_STORAGE_SOURCES_LIVEES_USERNAME", u.username)
        monkeypatch.setenv("PIO_STORAGE_SOURCES_LIVEES_PASSWORD", u.password or "")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_LIVEES_INDEX", "pio_test")
    storage_registry.reset()
    _wipe(storage_registry._registry.client_for_source("LIVEES"))
    storage_registry.reset()
    yield storage_registry
    storage_registry.reset()


# Re-run the whole DAO/facade suite under the live fixture (shadows
# conftest's sqlite storage_env, same pattern as test_sql_live).
from test_torch_storage_suite import (  # noqa: E402,F401
    TestLEvents,
    TestMetaData,
    TestStoreFacades,
    mk_event,
)


def test_explicit_mappings_survive_live_roundtrip(storage_env):
    """The two failure modes dynamic mapping causes on a REAL ES: a term
    query on an uppercase/spaced name (analyzed text would tokenize it and
    miss) and an event_id sort (text fields 400 without fielddata)."""
    from predictionio_tpu_torch.data.storage.base import App

    apps = storage_env.get_meta_data_apps()
    apps.insert(App(name="My App 1"))
    assert apps.get_by_name("My App 1") is not None

    le = storage_env.get_l_events()
    le.init_channel(1)
    le.batch_insert([mk_event(i) for i in range(5)], app_id=1)
    got = list(le.find(1))  # sorts on (event_time_ms, event_id)
    assert len(got) == 5
