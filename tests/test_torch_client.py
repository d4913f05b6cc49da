"""The port's client SDK and ``pypio`` against the JAX package's, on the CPU.

``EventClient`` and ``EngineClient`` (``predictionio_tpu_torch/client.py``)
talk to the port's event and query servers as the reference's SDK talks
to the reference's (``tests/test_client_sdk.py``): the same calls on two
stores made the same way give the same answers, event ids and times
masked. The query server serves a recommendation model trained on the
CPU (``device="cpu"``). ``pypio``'s round trips equal the reference's.
"""

import datetime as dt
import importlib
import json
import os
import threading

import pytest
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401

PACKAGES = ("predictionio_tpu", "predictionio_tpu_torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture()
def stores(tmp_path, monkeypatch):
    for key in [k for k in os.environ if k.startswith(("PIO_STORAGE_", "PIO_SNAPSHOT"))]:
        monkeypatch.delenv(key)

    def use(pkg):
        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / pkg))
        storage = _mod(pkg, "data.storage")
        storage.reset()
        return storage

    yield use
    for pkg in PACKAGES:
        _mod(pkg, "data.storage").reset()


@pytest.fixture()
def event_servers(stores):
    """A started event server per package on its own store, app
    ``SdkApp`` with one access key: ``{pkg: (url, key, app_id)}``."""
    started, out = [], {}
    try:
        for pkg in PACKAGES:
            storage = stores(pkg)
            base = _mod(pkg, "data.storage.base")
            app_id = storage.get_meta_data_apps().insert(base.App(name="SdkApp"))
            key = storage.get_meta_data_access_keys().insert(base.AccessKey(key="", app_id=app_id))
            storage.get_l_events().init_channel(app_id)
            svc = _mod(pkg, "data.api.eventserver").create_event_server(
                host="127.0.0.1", port=0).start()
            started.append(svc)
            out[pkg] = (f"http://127.0.0.1:{svc.port}", key, app_id)
        yield out
    finally:
        for svc in started:
            svc.stop()


def mask(obj):
    if isinstance(obj, list):
        return [mask(x) for x in obj]
    if isinstance(obj, dict):
        return {k: ("<masked>" if k in ("eventId", "creationTime") else mask(v))
                for k, v in obj.items()}
    return obj


def sdk_script(client_module, url, key) -> list:
    """Every EventClient call, errors as ``(class name, status)``."""
    c = client_module.EventClient(url, access_key=key)
    out = []

    def step(fn, *args, **kw):
        try:
            answer = fn(*args, **kw)
            out.append("<event id>" if isinstance(answer, str) else mask(answer))
        except client_module.PIOServerError as exc:
            out.append((type(exc).__name__, exc.status))

    when = dt.datetime(2024, 5, 1, 12, 0, tzinfo=dt.timezone.utc)
    eid = c.create(event="rate", entity_type="user", entity_id="u1",
                   target_entity_type="item", target_entity_id="i1",
                   properties={"rating": 4}, event_time=when)
    step(c.get, eid)
    step(c.create, event="buy", entity_type="user", entity_id="u1",
         target_entity_type="item", target_entity_id="i2", event_time="2024-05-01T12:00:01Z")
    step(c.find, event="rate")
    step(c.find, entityType="user", entityId="u1", limit=-1)
    step(c.set_properties, "item", "i9", {"categories": ["a", "b"], "price": 3})
    step(c.unset_properties, "item", "i9", ["price"])
    step(c.set_properties, "user", "u1", {})
    step(c.delete_entity, "item", "i9")
    step(c.create_batch, [
        {"event": "buy", "entityType": "user", "entityId": "u2",
         "targetEntityType": "item", "targetEntityId": "i2",
         "eventTime": "2024-05-01T12:00:02Z"},
        {"event": "$bad", "entityType": "user", "entityId": "u2"}])
    step(c.delete, eid)
    step(c.get, eid)
    step(c.delete, "no-such-event")
    step(client_module.EventClient(url, access_key="wrong").create,
         event="x", entity_type="user", entity_id="u")
    step(client_module.EventClient("http://127.0.0.1:9", access_key="k", timeout=2.0).create,
         event="buy", entity_type="user", entity_id="u1")
    return out


def test_event_client_answers_as_the_reference(event_servers):
    answers = {}
    for pkg in PACKAGES:
        url, key, _ = event_servers[pkg]
        answers[pkg] = sdk_script(_mod(pkg, "client"), url, key)
    got, want = answers["predictionio_tpu_torch"], answers["predictionio_tpu"]
    assert got == want
    assert got[0]["event"] == "rate" and got[0]["properties"] == {"rating": 4}
    assert [s["status"] for s in got[8]] == [201, 400]
    assert got[10:] == [("PIOServerError", 404), ("PIOServerError", 404),
                        ("PIOServerError", 401), ("PIOConnectionError", 0)]


def test_property_helpers_aggregate_on_the_ports_store(event_servers):
    from predictionio_tpu_torch.client import EventClient
    from predictionio_tpu_torch.data import storage

    url, key, app_id = event_servers["predictionio_tpu_torch"]
    c = EventClient(url, access_key=key)
    c.set_properties("item", "i9", {"categories": ["a", "b"], "price": 3})
    c.unset_properties("item", "i9", ["price"])
    props = storage.get_l_events().aggregate_properties(app_id=app_id, entity_type="item")
    assert props["i9"].get("categories") == ["a", "b"] and "price" not in props["i9"]
    c.delete_entity("item", "i9")
    assert "i9" not in storage.get_l_events().aggregate_properties(
        app_id=app_id, entity_type="item")


def test_the_references_sdk_speaks_to_the_ports_server(event_servers):
    """One wire contract: the JAX package's SDK against the port's server
    answers as the port's SDK does."""
    from predictionio_tpu import client as jax_client
    from predictionio_tpu_torch import client

    url, key, _ = event_servers["predictionio_tpu_torch"]
    ours = sdk_script(client, url, key)
    theirs = sdk_script(jax_client, url, key)
    # the second run's find of u1 also sees the first run's buy and $set
    # (its rate event was deleted); every other answer is the same
    assert [len(theirs[2]), len(theirs[3])] == [len(ours[2]), len(ours[3]) + 2]
    assert theirs[:2] + theirs[4:] == ours[:2] + ours[4:]


def test_empty_properties_survive_to_the_wire():
    from predictionio_tpu_torch.client import EventClient

    body = EventClient._event_body(event="$set", entity_type="user", entity_id="u1",
                                   properties={})
    assert body["properties"] == {}
    assert "properties" not in EventClient._event_body(event="buy", entity_type="user",
                                                       entity_id="u1")


def train_and_serve(stores, tmp_path):
    """The recommendation template trained on the port's store on the
    CPU, served on port 0: ``(server, thread)``."""
    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.tools import cli
    from predictionio_tpu_torch.workflow.core_workflow import run_train
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    storage = stores("predictionio_tpu_torch")
    app_id = storage.get_meta_data_apps().insert(App(name="RateApp"))
    le = storage.get_l_events()
    le.init_channel(app_id)
    base = dt.datetime(2024, 2, 1, tzinfo=dt.timezone.utc)
    le.batch_insert([
        Event(event="rate", entity_type="user", entity_id=f"u{u}", target_entity_type="item",
              target_entity_id=f"i{(u * 3 + k) % 11}", properties=DataMap({"rating": 1 + (u + k) % 5}),
              event_time=base + dt.timedelta(seconds=u * 10 + k))
        for u in range(12) for k in range(5)], app_id)
    with open(os.path.join(REPO, "examples", "recommendation", "engine.json")) as f:
        variant = json.load(f)
    variant["datasource"]["params"]["appName"] = "RateApp"
    variant["algorithms"][0]["params"].update(numIterations=3, rank=4)
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(variant))
    run_train(load_engine_variant(str(engine_json)), device="cpu")
    server, _ = cli.build_query_server(str(engine_json), port=0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def test_engine_client_queries_the_ports_query_server(stores, tmp_path):
    import requests

    from predictionio_tpu import client as jax_client
    from predictionio_tpu_torch.client import EngineClient, PIOServerError

    server, thread = train_and_serve(stores, tmp_path)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        client = EngineClient(url)
        for query in ({"user": "u1", "num": 4}, {"items": ["i3"], "num": 3},
                      {"user": "nobody", "num": 2}):
            got = client.query(query)
            assert got == requests.post(f"{url}/queries.json", json=query, timeout=30).json()
            assert got == jax_client.EngineClient(url).query(query)
        scores = [s["score"] for s in client.query({"user": "u1", "num": 4})["itemScores"]]
        assert len(scores) == 4 and scores == sorted(scores, reverse=True)
        with pytest.raises(PIOServerError) as err:
            client.query({"num": "many"})
        assert err.value.status == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


# --------------------------------------------------------------------------
# pypio
# --------------------------------------------------------------------------


def fill_shop(pkg, storage):
    base = _mod(pkg, "data.storage.base")
    datamap = _mod(pkg, "data.datamap")
    event = _mod(pkg, "data.event")
    record, _ = _mod(pkg, "tools.app_ops").create_app("Shop")
    when = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
    levents = storage.get_l_events()
    for n, (user, item, rating) in enumerate(
            [("u1", "i1", 4.0), ("u1", "i2", 2.0), ("u2", "i1", 5.0)]):
        levents.insert(event.Event(
            event="rate", entity_type="user", entity_id=user, target_entity_type="item",
            target_entity_id=item, properties=datamap.DataMap({"rating": rating}),
            event_time=when + dt.timedelta(seconds=n), event_id=f"ev{n}"), app_id=record.id)
    levents.insert(event.Event(event="$set", entity_type="item", entity_id="i1",
                               properties=datamap.DataMap({"cat": "x"}),
                               event_time=when, event_id="ev9"), app_id=record.id)
    assert isinstance(record, base.App)


def pypio_script(pkg, storage):
    pypio = _mod(pkg, "pypio")
    pypio._initialized = False
    out = []
    with pytest.raises(RuntimeError, match="init"):
        pypio.find_events("Shop")
    pypio.init()
    ds = pypio.find_events("Shop")
    out.append((len(ds), sorted(ds.entity_id_vocab)))
    rate = pypio.find_events("Shop", event_names=["rate"], entity_type="user")
    out.append(len(rate))
    rows = pypio.find_events_rows("Shop", event_names=["rate"])
    out.append([{k: v for k, v in r.items() if k != "creationTime"} for r in rows])
    blob_id = pypio.save_model({"factors": [1, 2, 3]})
    out.append(pypio.load_model(blob_id))
    named = pypio.save_model([4, 5], engine_instance_id="inst-1")
    out.append((named, pypio.load_model("inst-1")))
    with pytest.raises(KeyError):
        pypio.load_model("missing")
    with pytest.raises(LookupError):
        pypio.find_events("NoSuchApp")
    pypio._initialized = False
    return out


def test_pypio_round_trips_equal_the_reference(stores):
    answers = {}
    for pkg in PACKAGES:
        storage = stores(pkg)
        fill_shop(pkg, storage)
        answers[pkg] = pypio_script(pkg, storage)
    got = answers["predictionio_tpu_torch"]
    assert got == answers["predictionio_tpu"]
    assert got[0] == (4, ["i1", "u1", "u2"]) and got[1] == 3
    assert [r["eventId"] for r in got[2]] == ["ev0", "ev1", "ev2"]
    assert got[3] == {"factors": [1, 2, 3]} and got[4] == ("inst-1", [4, 5])


def test_pypio_init_fails_fast_on_a_broken_store(stores, monkeypatch):
    from predictionio_tpu_torch import pypio

    stores("predictionio_tpu_torch")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE", "NOPE")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_NOPE_TYPE", "sqlite")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_NOPE_PATH", "/dev/null/models.db")
    _mod("predictionio_tpu_torch", "data.storage").reset()
    pypio._initialized = False
    with pytest.raises(RuntimeError, match="storage verification failed"):
        pypio.init()
    assert not pypio._initialized
