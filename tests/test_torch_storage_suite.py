"""Port of ``tests/test_storage.py``: the registry and DAO suite against the
port's copies (``predictionio_tpu_torch``), the package renamed, with a
sqlite ``storage_env`` of the port's own.

Storage registry + DAO tests (reference LEventsSpec / meta-data scope)."""

import datetime as dt

import pytest

from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import (
    STATUS_COMPLETED,
    STATUS_RUNNING,
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    Model,
)

UTC = dt.timezone.utc
T0 = dt.datetime(2021, 3, 1, tzinfo=UTC)


@pytest.fixture()
def storage_env(tmp_path, monkeypatch):
    """The port's registry on a fresh sqlite file per test (conftest's
    ``storage_env`` points the JAX package's registry)."""
    from predictionio_tpu_torch.data import storage as storage_registry

    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    storage_registry.reset()
    yield storage_registry
    storage_registry.reset()


def mk_event(i, name="view", etype="user", eid=None, tid=None, props=None):
    return Event(
        event=name,
        entity_type=etype,
        entity_id=eid or f"u{i % 5}",
        target_entity_type="item" if tid else None,
        target_entity_id=tid,
        properties=DataMap(props or {}),
        event_time=T0 + dt.timedelta(minutes=i),
    )


class TestMetaData:
    def test_apps_crud(self, storage_env):
        apps = storage_env.get_meta_data_apps()
        app_id = apps.insert(App(name="MyApp", description="d"))
        assert apps.get(app_id).name == "MyApp"
        assert apps.get_by_name("MyApp").id == app_id
        apps.update(App(id=app_id, name="MyApp2"))
        assert apps.get_by_name("MyApp2") is not None
        assert apps.get_by_name("MyApp") is None
        assert len(apps.get_all()) == 1
        apps.delete(app_id)
        assert apps.get(app_id) is None

    def test_channels_and_access_keys(self, storage_env):
        apps = storage_env.get_meta_data_apps()
        app_id = apps.insert(App(name="A"))
        channels = storage_env.get_meta_data_channels()
        ch_id = channels.insert(Channel(name="backtest", app_id=app_id))
        assert channels.get(ch_id).name == "backtest"
        assert [c.id for c in channels.get_by_app(app_id)] == [ch_id]
        assert Channel.is_valid_name("ok-name_1")
        assert not Channel.is_valid_name("bad name")

        keys = storage_env.get_meta_data_access_keys()
        key = keys.insert(AccessKey(key="", app_id=app_id, events=["view"]))
        assert len(key) > 20
        assert keys.get(key).events == ["view"]
        assert keys.get_by_app_id(app_id)[0].key == key
        keys.delete(key)
        assert keys.get(key) is None

    def test_engine_instances_status_machine(self, storage_env):
        ei = storage_env.get_meta_data_engine_instances()
        inst = EngineInstance(
            engine_id="rec", engine_version="1", engine_variant="default",
            engine_factory="x.Factory", status=STATUS_RUNNING,
        )
        iid = ei.insert(inst)
        assert ei.get_latest_completed("rec", "1", "default") is None
        inst.status = STATUS_COMPLETED
        inst.end_time = dt.datetime.now(UTC)
        ei.update(inst)
        got = ei.get_latest_completed("rec", "1", "default")
        assert got.id == iid
        # a newer completed run wins
        inst2 = EngineInstance(
            engine_id="rec", engine_version="1", engine_variant="default",
            engine_factory="x.Factory", status=STATUS_COMPLETED,
            start_time=inst.start_time + dt.timedelta(hours=1),
        )
        iid2 = ei.insert(inst2)
        assert ei.get_latest_completed("rec", "1", "default").id == iid2
        assert len(ei.get_completed("rec", "1", "default")) == 2

    def test_evaluation_instances(self, storage_env):
        dao = storage_env.get_meta_data_evaluation_instances()
        iid = dao.insert(EvaluationInstance(evaluation_class="E", status=STATUS_COMPLETED))
        assert dao.get(iid).evaluation_class == "E"
        assert len(dao.get_completed()) == 1

    def test_models_blob(self, storage_env):
        models = storage_env.get_model_data_models()
        models.insert(Model(id="m1", models=b"\x00\x01bytes"))
        assert models.get("m1").models == b"\x00\x01bytes"
        models.insert(Model(id="m1", models=b"v2"))  # upsert
        assert models.get("m1").models == b"v2"
        models.delete("m1")
        assert models.get("m1") is None

    def test_localfs_models_backend(self, storage_env, monkeypatch, tmp_path):
        monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE", "FS")
        monkeypatch.setenv("PIO_STORAGE_SOURCES_FS_TYPE", "localfs")
        monkeypatch.setenv("PIO_STORAGE_SOURCES_FS_PATH", str(tmp_path / "m"))
        storage_env.reset()
        models = storage_env.get_model_data_models()
        models.insert(Model(id="abc", models=b"blob"))
        assert models.get("abc").models == b"blob"
        assert models.get("missing") is None

    def test_verify_all_data_objects(self, storage_env):
        assert storage_env.verify_all_data_objects() == []


class TestLEvents:
    def test_insert_get_delete(self, storage_env):
        le = storage_env.get_l_events()
        le.init_channel(1)
        eid = le.insert(mk_event(0), app_id=1)
        got = le.get(eid, app_id=1)
        assert got.event == "view" and got.event_id == eid
        assert le.delete(eid, app_id=1)
        assert not le.delete(eid, app_id=1)
        assert le.get(eid, app_id=1) is None

    def test_find_filters(self, storage_env):
        le = storage_env.get_l_events()
        le.init_channel(1)
        le.batch_insert(
            [
                mk_event(0, name="view", eid="u1", tid="i1"),
                mk_event(1, name="buy", eid="u1", tid="i2"),
                mk_event(2, name="view", eid="u2", tid="i1"),
                mk_event(3, name="$set", etype="item", eid="i1", props={"p": 1}),
            ],
            app_id=1,
        )
        assert len(list(le.find(1))) == 4
        assert len(list(le.find(1, event_names=["view"]))) == 2
        assert len(list(le.find(1, entity_type="user", entity_id="u1"))) == 2
        assert len(list(le.find(1, target_entity_id="i1"))) == 2
        assert len(list(le.find(1, start_time=T0 + dt.timedelta(minutes=1)))) == 3
        assert len(list(le.find(1, until_time=T0 + dt.timedelta(minutes=1)))) == 1
        assert len(list(le.find(1, limit=2))) == 2
        times = [e.event_time for e in le.find(1, reversed=True)]
        assert times == sorted(times, reverse=True)

    def test_channel_isolation(self, storage_env):
        le = storage_env.get_l_events()
        le.init_channel(1)
        le.init_channel(1, 7)
        le.insert(mk_event(0), app_id=1)
        le.insert(mk_event(1), app_id=1, channel_id=7)
        assert len(list(le.find(1))) == 1
        assert len(list(le.find(1, channel_id=7))) == 1
        le.remove_channel(1, 7)
        assert len(list(le.find(1, channel_id=7))) == 0
        assert len(list(le.find(1))) == 1

    def test_aggregate_properties_dao(self, storage_env):
        le = storage_env.get_l_events()
        le.init_channel(1)
        le.batch_insert(
            [
                mk_event(0, name="$set", etype="item", eid="i1", props={"cat": "a", "x": 1}),
                mk_event(1, name="$set", etype="item", eid="i2", props={"cat": "b"}),
                mk_event(2, name="$unset", etype="item", eid="i1", props={"x": None}),
            ],
            app_id=1,
        )
        props = le.aggregate_properties(1, "item")
        assert props["i1"].to_dict() == {"cat": "a"}
        assert props["i2"].to_dict() == {"cat": "b"}
        only_x = le.aggregate_properties(1, "item", required=["x"])
        assert only_x == {}


class TestStoreFacades:
    def test_event_store_and_dataset(self, storage_env):
        from predictionio_tpu_torch.data.store import (
            AppNotFoundError,
            LEventStore,
            PEventStore,
        )
        import pytest

        apps = storage_env.get_meta_data_apps()
        app_id = apps.insert(App(name="Shop"))
        le = storage_env.get_l_events()
        le.init_channel(app_id)
        le.batch_insert(
            [
                mk_event(0, name="rate", eid="u1", tid="i1", props={"rating": 4.0}),
                mk_event(1, name="rate", eid="u2", tid="i1", props={"rating": 3.0}),
                mk_event(2, name="view", eid="u1", tid="i2"),
            ],
            app_id=app_id,
        )
        assert len(list(LEventStore.find_by_entity("Shop", "user", "u1"))) == 2
        with pytest.raises(AppNotFoundError):
            list(LEventStore.find("NoSuchApp"))

        ds = PEventStore.dataset("Shop", event_names=["rate"])
        assert len(ds) == 2
        assert ds.entity_id_vocab == ["u1", "u2"]
        assert ds.target_entity_id_vocab == ["i1"]
        assert list(ds.ratings) == [4.0, 3.0]

    def test_dataset_fast_scan_matches_row_path(self, storage_env):
        """SQL backends build datasets through the columnar fast scan (no
        Event per row); it must produce exactly what from_events does --
        same vocab first-appearance order, -1 sentinel for absent targets,
        NaN for absent ratings, same time ordering."""
        import numpy as np

        from predictionio_tpu_torch.data.store import EventDataset, PEventStore

        apps = storage_env.get_meta_data_apps()
        apps.insert(App(name="FastScan"))
        le = storage_env.get_l_events()
        app_id = apps.get_by_name("FastScan").id
        le.init_channel(app_id)
        import dataclasses

        sub_ms = mk_event(5, name="rate", eid="u9", tid="i2", props={"rating": 2})
        sub_ms = dataclasses.replace(
            sub_ms, event_time=sub_ms.event_time.replace(microsecond=123456)
        )
        le.batch_insert(
            [
                mk_event(0, name="rate", eid="u3", tid="i9", props={"rating": 5.0}),
                mk_event(1, name="view", eid="u1", tid="i2"),
                mk_event(2, name="rate", eid="u3", tid="i2", props={"rating": 1.5}),
                mk_event(3, name="$set", eid="u1", props={"vip": True}),
                mk_event(4, name="rate", eid="u2", tid="i9", props={"other": 1}),
                # from_events accepts only real JSON numbers as ratings: the
                # string "4.5" and true must come back NaN from BOTH paths,
                # and the microsecond timestamp must survive exactly
                mk_event(6, name="rate", eid="u2", tid="i2", props={"rating": "4.5"}),
                mk_event(7, name="rate", eid="u1", tid="i9", props={"rating": True}),
                sub_ms,
            ],
            app_id=app_id,
        )
        fast = PEventStore.dataset("FastScan")
        slow = EventDataset.from_events(
            PEventStore.find("FastScan"), rating_key="rating"
        )
        assert fast.entity_id_vocab == slow.entity_id_vocab
        assert fast.target_entity_id_vocab == slow.target_entity_id_vocab
        assert fast.event_name_vocab == slow.event_name_vocab
        np.testing.assert_array_equal(fast.entity_ids, slow.entity_ids)
        np.testing.assert_array_equal(fast.target_entity_ids, slow.target_entity_ids)
        np.testing.assert_array_equal(fast.event_names, slow.event_names)
        np.testing.assert_allclose(fast.event_times, slow.event_times)
        np.testing.assert_allclose(fast.ratings, slow.ratings)
        # unsupported filters (entity_id) transparently use the row path
        filtered = PEventStore.dataset("FastScan", entity_id="u3")
        assert len(filtered) == 2 and len(filtered.events) == 2

    def test_dataset_survives_sql_rejected_json(self, storage_env):
        """python's json accepts NaN but SQL JSON functions reject it: one
        such stored row must degrade dataset() to the row path (which
        parses it fine), not abort training for the whole app."""
        from predictionio_tpu_torch.data.store import PEventStore

        apps = storage_env.get_meta_data_apps()
        apps.insert(App(name="NaNApp"))
        app_id = apps.get_by_name("NaNApp").id
        le = storage_env.get_l_events()
        le.init_channel(app_id)
        le.batch_insert(
            [
                mk_event(0, name="rate", eid="u1", tid="i1", props={"rating": 4.0}),
                mk_event(1, name="rate", eid="u2", tid="i1",
                         props={"rating": float("nan")}),
            ],
            app_id=app_id,
        )
        ds = PEventStore.dataset("NaNApp")
        assert len(ds) == 2
        assert ds.ratings[0] == 4.0
