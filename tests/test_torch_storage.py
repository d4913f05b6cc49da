"""The port's storage layer against the JAX package's, on the CPU.

The port keeps its own copy of the storage registry, the DAO contracts,
the SQL DAOs and every backend (sqlite, memory, localfs and the remote
ones). Here one script of DAO operations runs through each package's
registry, each in its own ``PIO_FS_BASEDIR`` (Elasticsearch and HBase on
their in-memory fake transports), and every answer must be equal. Then
each package reads the store the other wrote (one on-disk format for
sqlite, one wire format for the fakes), ``pio import``/``export`` round
trips agree, and every remote ``TYPE`` resolves to its backend as the
reference's does, never to sqlite.
"""

import dataclasses
import datetime as dt
import importlib
import itertools
import json
import os
import re

import numpy as np
import pytest

PACKAGES = ("predictionio_tpu", "predictionio_tpu_torch")

#: repository -> (source name, type) per backend under test
BACKENDS = {
    "sqlite": {},
    "memory": {"METADATA": "MEM", "EVENTDATA": "MEM", "MODELDATA": "MEM"},
    "localfs": {"MODELDATA": "FS"},
    "elasticsearch": {"METADATA": "ES", "EVENTDATA": "ES", "MODELDATA": "ES"},
    # the reference's hbase module stores events only: sqlite keeps the rest
    "hbase": {"EVENTDATA": "HB"},
}


def mods(pkg):
    """The storage registry, base, event and store modules of a package."""
    return (importlib.import_module(f"{pkg}.data.storage"),
            importlib.import_module(f"{pkg}.data.storage.base"),
            importlib.import_module(f"{pkg}.data.event"),
            importlib.import_module(f"{pkg}.data.store"))


@pytest.fixture()
def stores(tmp_path, monkeypatch):
    """Point each package at a basedir of its own, per backend; the
    registries are reset before and after."""

    def configure(backend: str, pkg: str, base: str) -> None:
        for key in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
            monkeypatch.delenv(key)
        monkeypatch.setenv("PIO_FS_BASEDIR", base)
        for repo, source in BACKENDS[backend].items():
            monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", source)
        monkeypatch.setenv("PIO_STORAGE_SOURCES_MEM_TYPE", "memory")
        monkeypatch.setenv("PIO_STORAGE_SOURCES_FS_TYPE", "localfs")
        monkeypatch.setenv("PIO_STORAGE_SOURCES_FS_PATH", os.path.join(base, "blobs"))
        for source, type_name in (("ES", "elasticsearch"), ("HB", "hbase")):
            monkeypatch.setenv(f"PIO_STORAGE_SOURCES_{source}_TYPE", type_name)
            monkeypatch.setenv(f"PIO_STORAGE_SOURCES_{source}_TRANSPORT", "fake")
        if backend == "hbase":  # row keys end in a random suffix: count instead
            counter = itertools.count()
            monkeypatch.setattr(importlib.import_module(f"{pkg}.data.storage.hbase.client"),
                                "new_suffix", lambda: f"{next(counter):016x}")
        for p in PACKAGES:
            mods(p)[0].reset()

    yield configure
    for p in PACKAGES:
        mods(p)[0].reset()


T0 = dt.datetime(2024, 3, 1, 12, 0, tzinfo=dt.timezone.utc)


def _norm(value):
    """Plain, comparable form of a DAO answer."""
    if dataclasses.is_dataclass(value) and hasattr(value, "to_json_obj"):
        return value.to_json_obj()
    if dataclasses.is_dataclass(value):
        return {f.name: _norm(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, dict):
        return {k: _norm(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_norm(v) for v in value]
    if isinstance(value, dt.datetime):
        return value.isoformat()
    if hasattr(value, "first_updated"):  # PropertyMap
        return [value.to_dict(), value.first_updated.isoformat(),
                value.last_updated.isoformat()]
    return value


def _events(event_mod):
    Event, DataMap = event_mod.Event, event_mod.DataMap
    out = []
    for i in range(12):
        out.append(Event(
            event=("rate", "buy", "view")[i % 3], entity_type="user",
            entity_id=f"u{i % 4}", target_entity_type="item", target_entity_id=f"i{i % 5}",
            properties=DataMap({"rating": (i % 5) + 1} if i % 3 == 0 else {"rating": "high"}),
            event_time=T0 + dt.timedelta(seconds=i // 2), event_id=f"e{i:02d}",
            creation_time=T0,
        ))
    out.append(Event(event="$set", entity_type="item", entity_id="i1",
                     properties=DataMap({"color": "red", "size": 3}),
                     event_time=T0 + dt.timedelta(hours=1), event_id="s1", creation_time=T0))
    out.append(Event(event="$unset", entity_type="item", entity_id="i1",
                     properties=DataMap({"size": None}),
                     event_time=T0 + dt.timedelta(hours=2), event_id="s2", creation_time=T0))
    out.append(Event(event="$set", entity_type="item", entity_id="i2",
                     properties=DataMap({"color": "blue"}),
                     event_time=T0 + dt.timedelta(hours=3), event_id="s3", creation_time=T0))
    out.append(Event(event="$delete", entity_type="item", entity_id="i2",
                     event_time=T0 + dt.timedelta(hours=4), event_id="s4", creation_time=T0))
    return out


def attempt(fn, *args, **kwargs):
    """``fn``'s answer, or the error it raised (a backend may refuse an
    operation, as the Elasticsearch fake refuses a model id with a
    slash: the reference's refusal is then the answer to equal)."""
    try:
        return fn(*args, **kwargs)
    except Exception as exc:  # the outcome compared, not a failure
        return ("raised", type(exc).__name__, str(exc))


def optional(dao, name, *args, **kwargs):
    """An optional capability of an events DAO (the columnar scan the
    SQL and Elasticsearch backends have, HBase's has not): its answer,
    or ``"absent"``."""
    if not hasattr(dao, name):
        return "absent"
    return getattr(dao, name)(*args, **kwargs)


def dao_script(pkg: str) -> list:
    """Every DAO operation of the contracts, in one order; the answers."""
    storage, base, event_mod, _ = mods(pkg)
    out = []
    apps = storage.get_meta_data_apps()
    a1 = apps.insert(base.App(name="A", description="first"))
    a2 = apps.insert(base.App(name="B"))
    out += [a1, a2, apps.get(a1), apps.get_by_name("B"), apps.get_all(), apps.get(99)]
    apps.update(base.App(name="A2", description="renamed", id=a1))
    apps.delete(a2)
    out += [apps.get_all(), apps.get_by_name("B")]

    channels = storage.get_meta_data_channels()
    c1 = channels.insert(base.Channel(name="ch-1", app_id=a1))
    c2 = channels.insert(base.Channel(name="ch_2", app_id=a1))
    out += [c1, c2, channels.get(c1), channels.get_by_app(a1)]
    channels.delete(c2)
    out += [channels.get_by_app(a1), base.Channel.is_valid_name("bad name")]

    keys = storage.get_meta_data_access_keys()
    out += [keys.insert(base.AccessKey(key="k1", app_id=a1)),
            keys.insert(base.AccessKey(key="k2", app_id=a1, events=["rate"]))]
    generated = keys.insert(base.AccessKey(key="", app_id=7))
    out += [len(generated), keys.get("k2"), keys.get_by_app_id(a1)]
    keys.update(base.AccessKey(key="k2", app_id=a1, events=["rate", "buy"]))
    keys.delete("k1")
    out += [keys.get("k2"), keys.get("k1"),
            sorted(k.key for k in keys.get_all() if k.key != generated)]

    instances = storage.get_meta_data_engine_instances()
    for n, status in enumerate(("COMPLETED", "FAILED", "COMPLETED", "RUNNING")):
        out.append(instances.insert(base.EngineInstance(
            id=f"ei{n}", status=status, start_time=T0 + dt.timedelta(minutes=n),
            end_time=T0 + dt.timedelta(minutes=n, seconds=30), engine_id="rec",
            engine_version="1", engine_variant="/v.json", engine_factory="f",
            batch="b", env={"PIO_X": "1"}, runtime_conf={"pio.mesh_shape": [-1, 1]},
            data_source_params='{"appName": "A"}', algorithms_params="[]",
        )))
    inst = instances.get("ei1")
    inst.status = "COMPLETED"
    instances.update(inst)
    out += [instances.get("ei0"), instances.get("nope"), len(instances.get_all()),
            instances.get_latest_completed("rec", "1", "/v.json"),
            [i.id for i in instances.get_completed("rec", "1", "/v.json")],
            instances.get_latest("rec", "1", "/v.json").id,
            instances.get_latest_completed("other", "1", "/v.json")]
    instances.delete("ei3")
    out.append(sorted(i.id for i in instances.get_all()))

    evals = storage.get_meta_data_evaluation_instances()
    out.append(evals.insert(base.EvaluationInstance(
        id="ev0", status="COMPLETED", start_time=T0, end_time=T0,
        evaluation_class="E", engine_params_generator_class="G",
        evaluator_results="r", evaluator_results_json="{}")))
    evals.insert(base.EvaluationInstance(id="ev1", status="RUNNING", start_time=T0))
    out += [evals.get("ev0"), [e.id for e in evals.get_completed()], len(evals.get_all())]
    evals.delete("ev1")
    out.append(len(evals.get_all()))

    models = storage.get_model_data_models()
    models.insert(base.Model(id="ei0", models=b"\x00blob\xff"))
    out.append(attempt(models.insert, base.Model(id="x/odd id", models=b"two")))
    out += [models.get("ei0"), attempt(models.get, "x/odd id"), models.get("nope")]
    models.delete("ei0")
    out.append(models.get("ei0"))

    le = storage.get_l_events()
    out += [le.init_channel(a1), le.init_channel(a1, c1)]
    evs = _events(event_mod)
    out.append(le.insert(evs[0], a1))
    out.append(le.batch_insert(evs[1:], a1))
    out.append(le.insert(evs[0].__class__(event="view", entity_type="user", entity_id="c",
                                          event_time=T0, event_id="ch0", creation_time=T0),
                         a1, c1))
    out.append(le.insert_batch([(evs[0], a1, None), (evs[1].with_id("new1"), a1, None)],
                               on_duplicate="ignore"))
    out += [le.get("e03", a1), le.get("e03", a1, c1), le.delete("e05", a1), le.delete("e05", a1)]
    for kwargs in (
        {}, {"limit": 3}, {"reversed": True, "limit": 4}, {"entity_type": "user"},
        {"entity_id": "u1"}, {"event_names": ["rate", "buy"]},
        {"target_entity_type": None}, {"target_entity_type": "item"},
        {"target_entity_id": "i2"}, {"start_time": T0 + dt.timedelta(seconds=2)},
        {"until_time": T0 + dt.timedelta(seconds=3)}, {"channel_id": c1},
    ):
        out.append([e.event_id for e in le.find(a1, **kwargs)])
    out.append(le.aggregate_properties(a1, "item"))
    out.append(le.aggregate_properties(a1, "item", required=["size"]))
    scan = optional(le, "scan_interactions", a1, event_names=["rate", "buy", "view"],
                    target_entity_type="item")
    out += [scan, optional(le, "count_interactions", a1, event_names=["rate"]),
            optional(le, "interaction_digest", a1, target_entity_type="item")]
    chunks = optional(le, "iter_interaction_chunks", a1, chunk_rows=4)
    out.append(chunks if chunks == "absent" else [len(c[0]) for c in chunks])
    out += [le.remove_channel(a1, c1), list(le.find(a1, channel_id=c1))]
    return [_norm(x) for x in out]


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_every_dao_operation_equals_the_reference(stores, tmp_path, backend):
    answers = {}
    for pkg in PACKAGES:
        stores(backend, pkg, str(tmp_path / pkg))
        answers[pkg] = dao_script(pkg)
    assert answers["predictionio_tpu_torch"] == answers["predictionio_tpu"]
    if backend == "localfs":  # the blobs are files of the same names
        assert sorted(os.listdir(tmp_path / "predictionio_tpu_torch" / "blobs")) == sorted(
            os.listdir(tmp_path / "predictionio_tpu" / "blobs"))


def _write_store(pkg: str) -> int:
    storage, base, event_mod, _ = mods(pkg)
    app_id = storage.get_meta_data_apps().insert(base.App(name="Cross"))
    le = storage.get_l_events()
    le.init_channel(app_id)
    le.batch_insert(_events(event_mod), app_id)
    return app_id


def _read_store(pkg: str) -> list:
    _, _, _, store = mods(pkg)
    ds = store.PEventStore.dataset("Cross", event_names=["rate", "buy"],
                                   target_entity_type="item")
    row_ds = store.PEventStore.dataset("Cross", entity_type="user")  # the row path
    return [
        [e.to_json_obj() for e in store.PEventStore.find("Cross")],
        [e.to_json_obj() for e in store.LEventStore.find_by_entity("Cross", "user", "u1")],
        [ds.entity_id_vocab, ds.target_entity_id_vocab, ds.event_name_vocab,
         ds.entity_ids.tolist(), ds.target_entity_ids.tolist(), ds.event_names.tolist(),
         ds.event_times.tolist(), np.nan_to_num(ds.ratings, nan=-1).tolist()],
        [row_ds.entity_id_vocab, row_ds.entity_ids.tolist(),
         np.nan_to_num(row_ds.ratings, nan=-1).tolist()],
        _norm(store.PEventStore.aggregate_properties("Cross", "item")),
        store.resolve_app_channel("Cross"),
    ]


#: the fake transport of each remote backend's events
FAKE_SOURCES = {"elasticsearch": "ES", "hbase": "HB"}


@pytest.mark.parametrize("backend", ["sqlite", *sorted(FAKE_SOURCES)])
@pytest.mark.parametrize("writer", PACKAGES)
def test_each_package_reads_the_store_the_other_wrote(stores, tmp_path, writer, backend):
    """One on-disk format: the same sqlite store, written by ``writer``,
    reads the same through both packages. One wire format: each
    package's Elasticsearch or HBase client reads the same through the
    fake server (transport) the writer's client wrote to."""
    stores(backend, writer, str(tmp_path))
    _write_store(writer)
    shared = None
    if backend in FAKE_SOURCES:
        shared = mods(writer)[0]._registry.client_for_source(FAKE_SOURCES[backend]).transport
    for p in PACKAGES:
        mods(p)[0].reset()
    reads = []
    for pkg in PACKAGES:
        if shared is not None:
            mods(pkg)[0]._registry.client_for_source(FAKE_SOURCES[backend]).transport = shared
        reads.append(_read_store(pkg))
    assert reads[1] == reads[0]
    assert len(reads[0][0]) == 16 and reads[0][2][0]  # both paths saw data


def _cli(pkg):
    return importlib.import_module(f"{pkg}.tools.import_export")


def _run_import_export(pkg, capsys, events_path, out_path, fmt):
    import argparse

    storage, base, _, _ = mods(pkg)
    app_id = storage.get_meta_data_apps().insert(base.App(name="IO"))
    ie = _cli(pkg)
    rc_in = ie.cmd_import(argparse.Namespace(appid=app_id, channel=None,
                                             input=events_path, format=None))
    said_in = capsys.readouterr()
    rc_out = ie.cmd_export(argparse.Namespace(appid=app_id, channel=None,
                                              output=out_path, format=fmt))
    said_out = capsys.readouterr().out.replace(out_path, "OUT")
    return rc_in, said_in.out, said_in.err, rc_out, said_out


@pytest.mark.parametrize("fmt", ["json", "parquet"])
def test_import_export_round_trips_equal_the_reference(stores, tmp_path, capsys, fmt):
    if fmt == "parquet":
        pytest.importorskip("pyarrow")
    lines = [json.dumps(e.to_json_obj()) for e in _events(mods("predictionio_tpu")[2])]
    lines.insert(3, "not json")
    lines.insert(5, json.dumps({"event": "$bogus", "entityType": "u", "entityId": "1"}))
    src = tmp_path / "events.jsonl"
    src.write_text("\n".join(lines) + "\n\n")
    results = {}
    for pkg in PACKAGES:
        stores("sqlite", pkg, str(tmp_path / pkg))
        out = str(tmp_path / f"{pkg}.{fmt}")
        results[pkg] = _run_import_export(pkg, capsys, str(src), out, fmt)
        if fmt == "json":
            with open(out) as f:
                results[pkg] += ([json.loads(line) for line in f],)
        else:  # export -> import round trip through the parquet file
            stores("sqlite", pkg, str(tmp_path / f"{pkg}-back"))
            results[pkg] += (_run_import_export(pkg, capsys, out, out + ".json", "json"),)
    assert results["predictionio_tpu_torch"] == results["predictionio_tpu"]
    assert results["predictionio_tpu"][0] == 1  # the two bad rows were rejected


def test_parquet_without_pyarrow_raises_the_reference_message(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pyarrow(name, *args, **kwargs):
        if name.startswith("pyarrow"):
            raise ImportError("no pyarrow here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    with pytest.raises(SystemExit, match="parquet format requires pyarrow"):
        _cli("predictionio_tpu_torch")._pyarrow()


#: remote TYPE -> (repository it serves here, its source's extra properties)
REMOTE = {
    "postgres": ("EVENTDATA", {}),
    "mysql": ("EVENTDATA", {}),
    "jdbc": ("EVENTDATA", {"URL": "jdbc:mysql://localhost/pio"}),
    "elasticsearch": ("EVENTDATA", {"TRANSPORT": "fake"}),
    "hbase": ("EVENTDATA", {"TRANSPORT": "fake"}),
    "s3": ("MODELDATA", {"BUCKET_NAME": "pio-models"}),
    "hdfs": ("MODELDATA", {"TRANSPORT": "fake"}),
}
GETTERS = {"EVENTDATA": "get_l_events", "MODELDATA": "get_model_data_models"}


def _remote_outcome(pkg, getter):
    """What the repository resolves to: its DAO's class, or the error."""
    storage = mods(pkg)[0]
    storage.reset()
    try:
        dao = getattr(storage, getter)()
    except Exception as exc:  # the outcome compared, not a failure
        return ("raised", type(exc).__name__, str(exc))
    return ("dao", type(dao).__module__.removeprefix(pkg), type(dao).__name__)


@pytest.mark.parametrize("kind", sorted(REMOTE))
def test_each_remote_type_resolves_to_its_backend_as_the_reference(
        stores, tmp_path, monkeypatch, kind):
    """Every remote ``TYPE`` reaches the port's copy of its backend: a DAO
    of that backend's module, or, with its driver missing (psycopg2,
    pymysql, boto3 are blocked here), the reference's own error. Both
    packages answer alike, and the repository never lands on sqlite."""
    import builtins

    real_import = builtins.__import__

    def no_drivers(name, *args, **kwargs):
        if name.split(".")[0] in ("psycopg2", "pymysql", "MySQLdb", "boto3"):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_drivers)
    repo, props = REMOTE[kind]
    outcomes = {}
    for pkg in PACKAGES:
        stores("sqlite", pkg, str(tmp_path / pkg))
        monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "REMOTE")
        monkeypatch.setenv("PIO_STORAGE_SOURCES_REMOTE_TYPE", kind)
        for key, value in props.items():
            monkeypatch.setenv(f"PIO_STORAGE_SOURCES_REMOTE_{key}", value)
        outcomes[pkg] = _remote_outcome(pkg, GETTERS[repo])
        assert mods(pkg)[0].get_meta_data_apps().get_all() == []  # sqlite serves the rest
    got = outcomes["predictionio_tpu_torch"]
    assert got == outcomes["predictionio_tpu"]
    assert "NotImplementedError" not in got and "Sqlite" not in got[2]
    if got[0] == "dao":
        backend = "mysql" if kind == "jdbc" else kind
        assert got[1].startswith(f".data.storage.{backend}"), got
    else:
        assert got[1] == "RuntimeError" and re.search("psycopg2|PyMySQL|boto3", got[2]), got


def test_unknown_type_raises_and_never_falls_back(stores, tmp_path, monkeypatch):
    """A ``TYPE`` no backend registers raises the reference's error; the
    repository is not served by sqlite in its place."""
    outcomes = {}
    for pkg in PACKAGES:
        stores("sqlite", pkg, str(tmp_path / pkg))
        monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "REMOTE")
        monkeypatch.setenv("PIO_STORAGE_SOURCES_REMOTE_TYPE", "cassandra")
        outcomes[pkg] = _remote_outcome(pkg, "get_l_events")
        failures = mods(pkg)[0].verify_all_data_objects()
        assert [f.split(":")[0] for f in failures] == ["event data"]
    assert outcomes["predictionio_tpu_torch"] == outcomes["predictionio_tpu"]
    assert outcomes["predictionio_tpu_torch"][:2] == ("raised", "StorageError")
    assert "unknown storage type 'cassandra'" in outcomes["predictionio_tpu_torch"][2]


@pytest.mark.parametrize("mode", ["use", "refresh"])
def test_snapshot_modes_equal_the_reference(stores, tmp_path, monkeypatch, caplog, mode):
    """``PEventStore.dataset`` served from a training snapshot: both
    packages read one sqlite store, each through its own snapshot
    directory, and answer alike -- the first read (the snapshot built),
    and after a new event (``use`` replays the stale spill, ``refresh``
    appends the event), by argument and by ``PIO_SNAPSHOT_MODE``. A
    failing snapshot layer degrades to the live scan with a warning, as
    the reference's does."""
    stores("sqlite", "predictionio_tpu", str(tmp_path))
    _write_store("predictionio_tpu")

    def read(pkg, **kwargs):
        ds = mods(pkg)[3].PEventStore.dataset(
            "Cross", event_names=["rate", "buy"], target_entity_type="item",
            snapshot_dir=str(tmp_path / f"snap-{pkg}"), **kwargs)
        return [ds.entity_id_vocab, ds.target_entity_id_vocab, ds.event_name_vocab,
                ds.entity_ids.tolist(), ds.target_entity_ids.tolist(),
                ds.event_names.tolist(), ds.event_times.tolist(),
                np.nan_to_num(ds.ratings, nan=-1).tolist()]

    first = [read(pkg, snapshot_mode=mode) for pkg in PACKAGES]
    assert first[1] == first[0] and len(first[0][3]) == 8
    for pkg in PACKAGES:
        assert any(n.startswith("gen-") for _, dirs, _ in os.walk(tmp_path / f"snap-{pkg}")
                   for n in dirs)
    _, _, event_mod, _ = mods("predictionio_tpu")
    storage = mods("predictionio_tpu")[0]
    storage.get_l_events().insert(event_mod.Event(
        event="rate", entity_type="user", entity_id="u9", target_entity_type="item",
        target_entity_id="i9", properties=event_mod.DataMap({"rating": 2}),
        event_time=dt.datetime.now(dt.timezone.utc) - dt.timedelta(seconds=1)), 1)
    monkeypatch.setenv("PIO_SNAPSHOT_MODE", mode)
    second = [read(pkg) for pkg in PACKAGES]
    assert second[1] == second[0]
    assert len(second[0][3]) == (8 if mode == "use" else 9)
    # a broken snapshot layer: the live scan answers, with a warning
    snapshot = importlib.import_module("predictionio_tpu_torch.data.snapshot")
    monkeypatch.setattr(snapshot.SnapshotStore, "ensure",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("disk gone")))
    degraded = read("predictionio_tpu_torch")
    assert "falling back to the live scan" in caplog.text
    monkeypatch.setenv("PIO_SNAPSHOT_MODE", "off")
    assert degraded == read("predictionio_tpu_torch") and len(degraded[3]) == 9


def test_fast_scan_failure_falls_back_to_the_row_path(stores, tmp_path, monkeypatch, caplog):
    """The reference's storage behaviour: a failed columnar scan degrades
    to the row path, with a warning, and the answer is the same."""
    stores("sqlite", "predictionio_tpu_torch", str(tmp_path))
    _write_store("predictionio_tpu_torch")
    storage, _, _, store = mods("predictionio_tpu_torch")
    fast = store.PEventStore.dataset("Cross", event_names=["rate", "buy"])
    le_class = type(storage.get_l_events())
    monkeypatch.setattr(le_class, "scan_interactions",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
    slow = store.PEventStore.dataset("Cross", event_names=["rate", "buy"])
    assert "falling back to the row path" in caplog.text

    def decoded(ds):  # the row path breaks time ties otherwise: compare rows
        return sorted(zip(np.asarray(ds.entity_id_vocab)[ds.entity_ids].tolist(),
                          np.asarray(ds.target_entity_id_vocab)[ds.target_entity_ids].tolist(),
                          ds.event_times.tolist(), np.nan_to_num(ds.ratings, nan=-1).tolist()))

    assert decoded(slow) == decoded(fast) and len(fast) == 8
    assert len(slow.events) == len(fast) and fast.events == []
