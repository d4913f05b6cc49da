"""The port's event server against the JAX package's, over live sockets.

Each package serves its own store (its own ``PIO_FS_BASEDIR``), with the
same app, channel and access keys. One script of requests -- single
posts, batches with invalid items and past the 50-event limit, ``find``
with each filter, ``GET``/``DELETE`` of one event, webhooks (JSON and
form), ``/stats.json``, bad keys and malformed bodies -- must give equal
status codes and bodies; event ids, creation times, trace ids and the
uptime are masked. Then concurrent posts through the port's
``ThreadingHTTPServer`` all land; the WAL ingest mode answers as the
reference's in the same mode, through the service, the server and the
command line; and both refuse TLS at the multi-process frontends
(``tests/test_torch_fabric.py`` serves through them).
"""

import datetime as dt
import importlib
import json
import os
import threading
import urllib.parse

import pytest
import requests
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401

PACKAGES = ("predictionio_tpu", "predictionio_tpu_torch")
KEY, LIMITED_KEY = "key-all", "key-rate-only"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture()
def servers(tmp_path, monkeypatch):
    """A started event server per package, each on its own store:
    ``{pkg: base_url}``."""
    for key in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("PIO_TRACE_SAMPLE", "1")
    started = {}
    try:
        for pkg in PACKAGES:
            storage = _mod(pkg, "data.storage")
            base = _mod(pkg, "data.storage.base")
            monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / pkg))
            storage.reset()
            app_id = storage.get_meta_data_apps().insert(base.App(name="ESApp"))
            storage.get_meta_data_channels().insert(base.Channel(name="backtest", app_id=app_id))
            keys = storage.get_meta_data_access_keys()
            keys.insert(base.AccessKey(key=KEY, app_id=app_id))
            keys.insert(base.AccessKey(key=LIMITED_KEY, app_id=app_id, events=["rate"]))
            storage.get_l_events().init_channel(app_id)
            svc = _mod(pkg, "data.api.eventserver").create_event_server(
                host="127.0.0.1", port=0, stats=True).start()
            started[pkg] = svc
        yield {pkg: f"http://127.0.0.1:{svc.port}" for pkg, svc in started.items()}
    finally:
        for svc in started.values():
            svc.stop()
        for pkg in PACKAGES:
            _mod(pkg, "data.storage").reset()


T0 = dt.datetime(2024, 5, 1, 8, 0, tzinfo=dt.timezone.utc)


def rate(user, item, rating, second, **extra):
    return {"event": "rate", "entityType": "user", "entityId": user,
            "targetEntityType": "item", "targetEntityId": item,
            "properties": {"rating": rating},
            "eventTime": (T0 + dt.timedelta(seconds=second)).isoformat(), **extra}


def script():
    """(method, path, params, body kind, body) requests in order;
    ``{first}`` in a path is the first posted event's id. The events a
    ``find`` returns have distinct times: the store orders ties by
    nothing in particular."""
    q = {"accessKey": KEY}
    batch = [rate(f"u{i % 3}", f"i{i % 7}", 1 + i % 5, 10 + i) for i in range(30)]
    batch[4] = {"event": "$bogus", "entityType": "user", "entityId": "x"}
    batch[9] = {"event": "rate", "entityType": "user"}
    batch[11] = "not an object"
    return [
        ("GET", "/", {}, None, None),
        ("POST", "/events.json", q, "json", rate("u1", "i1", 4, 0)),
        ("POST", "/events.json", q, "json",
         {"event": "$set", "entityType": "item", "entityId": "i1",
          "properties": {"color": "red"},
          "eventTime": (T0 - dt.timedelta(seconds=1)).isoformat()}),
        ("POST", "/events.json", q, "json",
         dict(rate("u2", "i2", 3, 1), creationTime="2000-01-01T00:00:00Z")),
        ("POST", "/events.json", q, "json", {"event": "$bogus", "entityType": "u",
                                             "entityId": "1"}),
        ("POST", "/events.json", q, "raw", b"not json"),
        ("POST", "/events.json", {}, "json", rate("u1", "i1", 4, 2)),
        ("POST", "/events.json", {"accessKey": "wrong"}, "json", rate("u1", "i1", 4, 2)),
        ("POST", "/events.json", {"accessKey": KEY, "channel": "nope"}, "json",
         rate("u1", "i1", 4, 2)),
        ("POST", "/events.json", {"accessKey": KEY, "channel": "backtest"}, "json",
         rate("u9", "i9", 2, 3)),
        ("POST", "/events.json", {"accessKey": LIMITED_KEY}, "json", rate("u3", "i3", 5, 4)),
        ("POST", "/events.json", {"accessKey": LIMITED_KEY}, "json",
         dict(rate("u3", "i3", 5, 5), event="buy")),
        ("POST", "/batch/events.json", q, "json", batch),
        ("POST", "/batch/events.json", q, "json", [rate("u", "i", 1, 0)] * 51),
        ("POST", "/batch/events.json", q, "json", {"not": "a list"}),
        ("POST", "/batch/events.json", {"accessKey": LIMITED_KEY}, "json",
         [rate("u4", "i4", 1, 50), dict(rate("u4", "i5", 1, 51), event="buy")]),
        ("GET", "/events.json", q, None, None),
        ("GET", "/events.json", dict(q, limit="-1"), None, None),
        ("GET", "/events.json", dict(q, limit="5", reversed="true"), None, None),
        ("GET", "/events.json", dict(q, entityType="user", entityId="u1", limit="-1"),
         None, None),
        ("GET", "/events.json", dict(q, event="rate,buy", limit="-1"), None, None),
        ("GET", "/events.json", dict(q, targetEntityType="item", targetEntityId="i2",
                                     limit="-1"), None, None),
        ("GET", "/events.json", dict(q, startTime=(T0 + dt.timedelta(seconds=20)).isoformat(),
                                     untilTime=(T0 + dt.timedelta(seconds=30)).isoformat()),
         None, None),
        ("GET", "/events.json", dict(q, channel="backtest"), None, None),
        ("GET", "/events.json", dict(q, limit="x"), None, None),
        ("GET", "/events.json", dict(q, limit="-2"), None, None),
        ("GET", "/events.json", dict(q, startTime="yesterday"), None, None),
        ("GET", "/events/{first}.json", q, None, None),
        ("DELETE", "/events/{first}.json", q, None, None),
        ("GET", "/events/{first}.json", q, None, None),
        ("DELETE", "/events/{first}.json", q, None, None),
        ("GET", "/events/{first}.json", {"accessKey": "wrong"}, None, None),
        ("POST", "/webhooks/example.json", q, "json",
         {"type": "signup", "userId": 42, "properties": {"plan": "pro"},
          "timestamp": (T0 + dt.timedelta(seconds=99)).isoformat()}),
        ("POST", "/webhooks/example.json", q, "json", {"userId": 42}),
        ("POST", "/webhooks/segmentio.json", q, "json",
         {"type": "track", "userId": "s1", "event": "clicked",
          "timestamp": (T0 + dt.timedelta(seconds=98)).isoformat()}),
        ("POST", "/webhooks/nope.json", q, "json", {}),
        ("POST", "/webhooks/exampleform.json", q, "form",
         {"type": "visit", "userId": "f1", "page": "home"}),
        ("POST", "/webhooks/mailchimp.json", q, "form",
         {"type": "subscribe", "fired_at": "2024-05-01 09:00:00", "data[id]": "m1",
          "data[list_id]": "L1", "data[email]": "a@b.c"}),
        ("POST", "/webhooks/mailchimp.json", q, "form", {"type": "bounce"}),
        ("GET", "/webhooks/segmentio.json", {}, None, None),
        ("GET", "/webhooks/nope.json", {}, None, None),
        ("GET", "/events.json", dict(q, entityType="user", entityId="42"), None, None),
        ("GET", "/stats.json", {}, None, None),
        ("PUT", "/events.json", q, None, None),
        ("GET", "/no/such/route", {}, None, None),
    ]


MASKED = ("eventId", "creationTime", "traceId", "uptime")


def mask(value):
    if isinstance(value, dict):
        return {k: ("*" if k in MASKED else mask(v)) for k, v in value.items()}
    if isinstance(value, list):
        return [mask(v) for v in value]
    return value


def run_script(base_url):
    out, first = [], None
    with requests.Session() as http:
        for method, path, params, kind, body in script():
            if "{first}" in path:
                path = path.replace("{first}", urllib.parse.quote(first))
            kwargs = {"params": params}
            if kind == "json":
                kwargs["json"] = body
            elif kind == "form":
                kwargs["data"] = body
            elif kind == "raw":
                kwargs["data"] = body
                kwargs["headers"] = {"Content-Type": "application/json"}
            r = http.request(method, base_url + path, timeout=30, **kwargs)
            try:
                payload = r.json()
            except ValueError:
                payload = r.text
            if first is None and r.status_code == 201:
                first = payload["eventId"]
            out.append((method, path.replace(first or "\0", "FIRST"), r.status_code,
                        mask(payload)))
    return out


def test_one_script_of_requests_answers_as_the_reference(servers):
    answers = {pkg: run_script(url) for pkg, url in servers.items()}
    port, ref = answers["predictionio_tpu_torch"], answers["predictionio_tpu"]
    assert len(port) == len(ref)
    for got, want in zip(port, ref):
        assert got == want
    statuses = [status for _, _, status, _ in ref]
    assert {200, 201, 400, 401, 403, 404, 405} <= set(statuses)
    batch = next(body for method, path, status, body in ref
                 if path == "/batch/events.json" and isinstance(body, list) and len(body) == 30)
    assert [item["status"] for item in batch].count(201) == 27


def test_concurrent_posts_all_land(servers):
    """Eight client threads (more than the cores) post at once through the
    port's threaded server and the sqlite client's shared connection, the
    interpreter switching threads often: every event is stored once."""
    import sys

    url = servers["predictionio_tpu_torch"]
    errors = []

    def post(worker):
        with requests.Session() as http:
            for n in range(15):
                body = [rate(f"w{worker}", f"i{n}", 1 + n % 5, worker * 100 + n)] * 2
                r = http.post(f"{url}/batch/events.json", params={"accessKey": KEY},
                              json=body, timeout=30)
                one = http.post(f"{url}/events.json", params={"accessKey": KEY},
                                json=rate(f"w{worker}", f"j{n}", 3, worker * 100 + n),
                                timeout=30)
                if r.status_code != 200 or one.status_code != 201 or any(
                        item["status"] != 201 for item in r.json()):
                    errors.append((r.status_code, one.status_code))

    threads = [threading.Thread(target=post, args=(w,)) for w in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    found = requests.get(f"{url}/events.json", params={"accessKey": KEY, "limit": "-1"},
                         timeout=30).json()
    assert len(found) == 8 * 15 * 3
    assert len({e["eventId"] for e in found}) == len(found)


def test_unported_ingest_modes_raise():
    """What both packages refuse: TLS at the multi-process frontends,
    and an ingest mode other than sync or wal."""
    es = _mod("predictionio_tpu_torch", "data.api.eventserver")
    ref = _mod("predictionio_tpu", "data.api.eventserver")
    for mod in (es, ref):
        with pytest.raises(ValueError, match="does not support --ssl-cert"):
            mod.run_event_server(port=0, frontend_workers=2, ssl_cert="cert.pem")
    with pytest.raises(ValueError, match="sync or wal"):
        es.EventService(ingest_mode="async")


def _wal_store(pkg, basedir, monkeypatch):
    """One package's store under ``basedir`` with the app and ``KEY``."""
    storage = _mod(pkg, "data.storage")
    base = _mod(pkg, "data.storage.base")
    monkeypatch.setenv("PIO_FS_BASEDIR", str(basedir))
    storage.reset()
    app_id = storage.get_meta_data_apps().insert(base.App(name="ESApp"))
    storage.get_meta_data_access_keys().insert(base.AccessKey(key=KEY, app_id=app_id))
    storage.get_l_events().init_channel(app_id)
    return storage


def test_wal_ingest_mode_serves_as_the_reference(tmp_path, monkeypatch):
    """``ingest_mode="wal"`` through ``EventService`` /
    ``create_event_server`` (P = 1 and P = 3) and through the command
    line: every event is acknowledged 201 after the WAL's fsync, lands in
    the store once, the checkpoint covers every record, ``/metrics``
    carries the ingest and WAL gauges, the statuses equal the JAX
    package's in the same mode, and a stopped pipeline answers 429 with
    ``Retry-After``."""
    import re
    import signal
    import subprocess
    import sys

    for key in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(key)
    body = [rate(f"u{n % 7}", f"i{n}", 1 + n % 5, n) for n in range(45)]
    body.insert(3, {"event": "rate"})  # invalid: a 400 inside the batch
    statuses = {}
    for partitions in (1, 3):
        for pkg in PACKAGES:
            storage = _wal_store(pkg, tmp_path / f"{pkg}-{partitions}", monkeypatch)
            es = _mod(pkg, "data.api.eventserver")
            if pkg == "predictionio_tpu":
                config = _mod(pkg, "data.ingest").IngestConfig(
                    mode="wal", wal_partitions=partitions)
                svc = es.create_event_server(host="127.0.0.1", port=0,
                                             ingest_config=config).start()
            else:
                svc = es.create_event_server(host="127.0.0.1", port=0, ingest_mode="wal",
                                             wal_partitions=partitions).start()
            url = f"http://127.0.0.1:{svc.port}"
            try:
                r = requests.post(f"{url}/batch/events.json", params={"accessKey": KEY},
                                  json=body, timeout=30)
                one = requests.post(f"{url}/events.json", params={"accessKey": KEY},
                                    json=rate("u0", "late", 4, 99), timeout=30)
                metrics = requests.get(f"{url}/metrics", timeout=30).text
            finally:
                svc.stop()
            statuses[(pkg, partitions)] = ([x["status"] for x in r.json()], one.status_code)
            assert re.search(r"^pio_wal_fsyncs_total [1-9]", metrics, re.M)
            assert re.search(rf"^pio_ingest_partitions {partitions}(\.0)?$", metrics, re.M)
            stored = list(storage.get_l_events().find(app_id=1))
            assert len(stored) == 46 and len({e.event_id for e in stored}) == 46
            wal = _mod(pkg, "data.wal")
            wal_dir = str(tmp_path / f"{pkg}-{partitions}" / "wal")
            assert wal.partition_count(wal_dir) == partitions
            assert sum(map(wal.read_checkpoint, wal.partition_dirs(wal_dir))) == 46
        assert statuses[(PACKAGES[0], partitions)] == statuses[(PACKAGES[1], partitions)]
    assert statuses[(PACKAGES[1], 1)] == ([201] * 3 + [400] + [201] * 42, 201)

    # a stopped pipeline refuses with 429 + Retry-After, never a hang
    _wal_store(PACKAGES[1], tmp_path / "stopped", monkeypatch)
    es = _mod(PACKAGES[1], "data.api.eventserver")
    http = _mod(PACKAGES[1], "utils.http")
    service = es.EventService(ingest_mode="wal")
    service.shutdown_ingest()
    svc = http.ServiceThread(http.make_server(service.router, "127.0.0.1", 0, "t")).start()
    try:
        r = requests.post(f"http://127.0.0.1:{svc.port}/events.json",
                          params={"accessKey": KEY}, json=rate("u1", "i1", 3, 1), timeout=30)
    finally:
        svc.stop()
    assert r.status_code == 429 and int(r.headers["Retry-After"]) >= 1

    # the command line: `eventserver --ingest-mode wal --wal-partitions 2`
    basedir = tmp_path / "cli"
    _wal_store(PACKAGES[1], basedir, monkeypatch)
    _mod(PACKAGES[1], "data.storage").reset()
    env = dict(os.environ, PIO_FS_BASEDIR=str(basedir),
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "eventserver",
         "--ip", "127.0.0.1", "--port", "0", "--ingest-mode", "wal",
         "--wal-partitions", "2"],
        env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "ingest=wal" in line and "wal-partitions=2" in line, line
        url = re.search(r"http://[\d.]+:\d+", line).group(0)
        r = requests.post(f"{url}/batch/events.json", params={"accessKey": KEY},
                          json=body[:10], timeout=30)
        assert [x["status"] for x in r.json()] == [201] * 3 + [400] + [201] * 6
    finally:
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    storage = _mod(PACKAGES[1], "data.storage")
    storage.reset()
    assert len(list(storage.get_l_events().find(app_id=1))) == 9
    storage.reset()
    _mod(PACKAGES[0], "data.storage").reset()
