"""Port of ``tests/test_hbase_es_backends.py``: the DAO suite of
``tests/test_torch_storage_suite.py`` and the backend-specific cases
against the port's copies of the two backends, on their fake transports.

HBase + Elasticsearch backends: the full DAO/facade suite against the
in-memory transport fakes (reference tier-2 storage scope, SURVEY.md
section 4 -- upstream CI ran the same specs against containerized
HBase/ES; this zero-egress image uses the fakes, and ``test_sql_live``-style
env gating covers real servers via PIO_TEST_ES_URL / PIO_TEST_HBASE_URL).

`storage_env` here shadows conftest's sqlite fixture: the re-exported
test classes run once per backend parameterization.
"""

import datetime as dt

import pytest

from predictionio_tpu_torch.data.storage.base import App

# elasticsearch: full stack on the ES fake.
# hbase: EVENTDATA on the hbase fake; METADATA/MODELDATA stay sqlite
# (the reference's hbase module is events-only, deployed beside ES/JDBC).
_BACKENDS = ("elasticsearch", "hbase")


@pytest.fixture(params=_BACKENDS)
def storage_env(request, tmp_path, monkeypatch):
    from predictionio_tpu_torch.data import storage as storage_registry

    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    if request.param == "elasticsearch":
        for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
            monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "ES")
        monkeypatch.setenv("PIO_STORAGE_SOURCES_ES_TYPE", "elasticsearch")
        monkeypatch.setenv("PIO_STORAGE_SOURCES_ES_TRANSPORT", "fake")
    else:
        monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "HB")
        monkeypatch.setenv("PIO_STORAGE_SOURCES_HB_TYPE", "hbase")
        monkeypatch.setenv("PIO_STORAGE_SOURCES_HB_TRANSPORT", "fake")
    storage_registry.reset()
    yield storage_registry
    storage_registry.reset()


from test_torch_storage_suite import (  # noqa: E402,F401
    TestLEvents,
    TestMetaData,
    TestStoreFacades,
    mk_event,
)


class TestESSpecifics:
    def test_sequence_ids_increment(self, storage_env):
        if "hbase" in str(storage_env._registry._repo_source("EVENTDATA")) or (
            storage_env._registry._repo_source("METADATA") == "PIO_SQLITE"
        ):
            pytest.skip("ES-only check")
        apps = storage_env.get_meta_data_apps()
        ids = [apps.insert(App(name=f"A{i}")) for i in range(3)]
        assert ids == sorted(ids) and len(set(ids)) == 3

    def test_indices_created_with_explicit_mappings(self, storage_env):
        """Every index must carry explicit mappings at create time (keyword
        ids/names, long *_ms, date timestamps) -- dynamic text mapping on a
        live ES breaks term queries on uppercase/spaced values and 400s
        event_id sorts. The fake transport refuses writes to indices it
        never saw created, so this also proves no DAO path skips
        ensure_index."""
        if storage_env._registry._repo_source("EVENTDATA") != "ES":
            pytest.skip("ES-only check")
        apps = storage_env.get_meta_data_apps()
        apps.insert(App(name="My App 1"))
        assert apps.get_by_name("My App 1") is not None
        le = storage_env.get_l_events()
        le.init_channel(7)
        le.insert(mk_event(0), app_id=7)
        mappings = storage_env._registry.client_for_source("ES").transport.mappings
        app_props = mappings["pio_meta_apps"]["properties"]
        assert app_props["name"] == {"type": "keyword"}
        assert app_props["id"] == {"type": "long"}
        ev_props = mappings["pio_events_7"]["properties"]
        assert ev_props["entity_id"]["type"] == "keyword"
        assert ev_props["event"]["type"] == "keyword"
        assert ev_props["event_time_ms"]["type"] == "long"
        assert ev_props["event_time"]["type"] == "date"
        assert ev_props["properties"]["index"] is False
        assert mappings["pio_sequences"]["properties"]["n"]["type"] == "long"
        # cluster-side template: even an auto-created events index (another
        # process deleted it; our per-process ensure cache is stale) gets
        # the explicit mappings
        transport = storage_env._registry.client_for_source("ES").transport
        template = transport.index_templates["pio_events"]
        assert template["index_patterns"] == ["pio_events_*"]
        t_props = template["template"]["mappings"]["properties"]
        assert t_props["entity_id"]["type"] == "keyword"

    def test_scan_paginates_past_page_size(self, storage_env):
        """find() must stream beyond one search page (search_after path)."""
        import predictionio_tpu_torch.data.storage.elasticsearch.client as es_client

        if storage_env._registry._repo_source("EVENTDATA") != "ES":
            pytest.skip("ES-only check")
        le = storage_env.get_l_events()
        le.init_channel(1)
        n = 25
        le.batch_insert([mk_event(i) for i in range(n)], app_id=1)
        original = es_client._SCAN_PAGE
        es_client._SCAN_PAGE = 10  # force 3 pages
        try:
            events = list(le.find(1))
        finally:
            es_client._SCAN_PAGE = original
        assert len(events) == n
        times = [e.event_time for e in events]
        assert times == sorted(times)


class TestHBaseSpecifics:
    def _hbase_events(self, storage_env):
        if storage_env._registry._repo_source("EVENTDATA") != "HB":
            pytest.skip("hbase-only check")
        return storage_env.get_l_events()

    def test_rowkey_is_time_ordered_within_shard(self, storage_env):
        from predictionio_tpu_torch.data.storage.hbase.client import make_rowkey, shard_of

        e1 = mk_event(0, eid="same")
        e2 = mk_event(5, eid="same")
        k1, k2 = make_rowkey(e1), make_rowkey(e2)
        assert k1[:2] == k2[:2] == f"{shard_of('user', 'same'):02d}"
        assert k1 < k2  # later event time -> later key

    def test_entity_filter_narrows_to_one_shard_scan(self, storage_env):
        le = self._hbase_events(storage_env)
        le.init_channel(1)
        le.batch_insert([mk_event(i, eid=f"u{i % 3}") for i in range(9)], app_id=1)
        transport = storage_env._registry.client_for_source("HB").transport
        scans = []
        real_scan = transport.scan

        def counting_scan(table, **kw):
            scans.append(kw)
            return real_scan(table, **kw)

        transport.scan = counting_scan
        try:
            got = list(le.find(1, entity_type="user", entity_id="u1"))
        finally:
            transport.scan = real_scan
        assert len(got) == 3
        assert len(scans) == 1  # shard known from the entity -> one prefix scan

    def test_metadata_repo_rejected(self, storage_env):
        if storage_env._registry._repo_source("EVENTDATA") != "HB":
            pytest.skip("hbase-only check")
        client = storage_env._registry.client_for_source("HB")
        with pytest.raises(NotImplementedError, match="events only"):
            client.get_dao("apps")

    def test_time_range_scan_bounds(self, storage_env):
        le = self._hbase_events(storage_env)
        le.init_channel(1)
        base_t = dt.datetime(2021, 3, 1, tzinfo=dt.timezone.utc)
        le.batch_insert([mk_event(i, eid="u0") for i in range(10)], app_id=1)
        got = list(
            le.find(
                1,
                start_time=base_t + dt.timedelta(minutes=2),
                until_time=base_t + dt.timedelta(minutes=7),
            )
        )
        assert len(got) == 5
        assert all(
            base_t + dt.timedelta(minutes=2)
            <= e.event_time
            < base_t + dt.timedelta(minutes=7)
            for e in got
        )
