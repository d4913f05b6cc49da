"""The port's training snapshots against the JAX package's, on the CPU.

``data/snapshot.py`` is a verbatim copy over the port's SQL scan
(``sql_common.iter_interaction_chunks``), so over one sqlite store both
packages must spill the same generation: equal column bytes,
vocabularies, ``until_ms``, row count and time digest -- after a build,
after an append-only refresh (which must also equal a cold build at the
same bound), and after a late-arriving row inside the covered prefix,
which forces a rebuild. Each package loads the generation the other
wrote. ``pio train --snapshot-mode`` trains from the snapshot to the
same factors as from the live scan. Exact equality throughout: the
snapshot is a byte format, and the training read it feeds is the same.
"""

import datetime as dt
import importlib
import json
import os

import numpy as np
import pytest

PACKAGES = ("predictionio_tpu", "predictionio_tpu_torch")
T0 = dt.datetime(2024, 6, 1, tzinfo=dt.timezone.utc)
COLUMNS = ("users", "items", "names", "times", "ratings")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture()
def shared_store(tmp_path, monkeypatch):
    """One sqlite store under ``tmp_path``, open in both packages;
    ``add(pkg_events)`` inserts ``(user, item, name, seconds, rating)``
    rows through the JAX package."""
    for key in [k for k in os.environ if k.startswith(("PIO_STORAGE_", "PIO_SNAPSHOT"))]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    for pkg in PACKAGES:
        _mod(pkg, "data.storage").reset()
    storage = _mod(PACKAGES[0], "data.storage")
    base = _mod(PACKAGES[0], "data.storage.base")
    event_mod = _mod(PACKAGES[0], "data.event")
    app_id = storage.get_meta_data_apps().insert(base.App(name="SnapApp"))
    storage.get_l_events().init_channel(app_id)
    counter = iter(range(10**6))

    def add(rows):
        storage.get_l_events().batch_insert([
            event_mod.Event(
                event=name, entity_type="user", entity_id=user, target_entity_type="item",
                target_entity_id=item, event_time=T0 + dt.timedelta(seconds=sec),
                properties=event_mod.DataMap({} if rating is None else {"rating": rating}),
                event_id=f"ev{next(counter):05d}",
            )
            for user, item, name, sec, rating in rows
        ], app_id)

    yield add, app_id
    for pkg in PACKAGES:
        _mod(pkg, "data.storage").reset()


def _rows(seed, n, start, users=9, items=14):
    """Seeded rows one second apart, with a same-second pair (a time tie
    the scan breaks by event id) and events the spec filters out."""
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(n):
        name = ("rate", "rate", "buy", "view")[k % 4]
        rating = None if name == "buy" else float(rng.integers(1, 6))
        rows.append((f"u{rng.integers(0, users)}", f"i{rng.integers(0, items)}", name,
                     start + k - (k % 5 == 4), rating))
    return rows


def _spec(pkg, app_id):
    return _mod(pkg, "data.snapshot").SnapshotSpec(
        app_id=app_id, event_names=("rate", "buy"), target_entity_type="item")


def _contents(snap):
    """Everything a generation holds, comparable across packages."""
    manifest = snap.manifest
    return (
        {name: np.asarray(snap.column(name)).tobytes() for name in COLUMNS},
        {which: snap.vocab(which) for which in ("users", "items", "names")},
        manifest["until_ms"], manifest["row_count"], manifest.get("time_digest"),
        manifest["spec"],
    )


def test_build_refresh_and_rebuild_equal_the_reference(shared_store, tmp_path, caplog):
    add, app_id = shared_store
    add(_rows(1, 40, 0))

    def step(until, method, chunk_rows=7):
        out = []
        for pkg in PACKAGES:
            store = _mod(pkg, "data.snapshot").SnapshotStore(
                str(tmp_path / f"snap-{pkg}"), _spec(pkg, app_id))
            le = _mod(pkg, "data.storage").get_l_events()
            out.append(_contents(getattr(store, method)(le, until, chunk_rows=chunk_rows)))
        assert out[1] == out[0]
        return out[0]

    def cold(until):
        out = []
        for pkg in PACKAGES:
            store = _mod(pkg, "data.snapshot").SnapshotStore(
                str(tmp_path / f"cold-{pkg}-{until.timestamp()}"), _spec(pkg, app_id))
            out.append(_contents(store.build(_mod(pkg, "data.storage").get_l_events(),
                                             until)))
        assert out[1] == out[0]
        return out[0]

    built = step(T0 + dt.timedelta(seconds=30), "build")
    assert built[3] == 23 and built[2] == 1717200030000
    add(_rows(2, 30, 45))
    refreshed = step(T0 + dt.timedelta(seconds=60), "refresh")
    # append-only refresh reproduces a cold build at the same bound
    assert refreshed == cold(T0 + dt.timedelta(seconds=60)) and refreshed[3] > built[3]
    # a late row inside the covered prefix: the refresh rebuilds, exactly
    add([("u-late", "i-late", "rate", 3, 4.0)])
    rebuilt = step(T0 + dt.timedelta(seconds=90), "refresh")
    assert "covered prefix drifted" in caplog.text
    assert rebuilt == cold(T0 + dt.timedelta(seconds=90))
    # the late user is renumbered into the stream, not appended
    users = rebuilt[1]["users"]
    assert users.index("u-late") < len(users) - 1
    # each package loads the generation the other wrote
    for writer, reader in (PACKAGES, PACKAGES[::-1]):
        loaded = _mod(reader, "data.snapshot").SnapshotStore(
            str(tmp_path / f"snap-{writer}"), _spec(reader, app_id)).load()
        assert _contents(loaded) == rebuilt


@pytest.mark.parametrize("mode", ["use", "refresh"])
def test_train_from_the_snapshot_equals_the_live_scan(shared_store, tmp_path,
                                                      monkeypatch, mode):
    """``pio train --snapshot-mode MODE`` (the port's command line) builds
    a generation and trains the same factors, bit for bit, as a train
    from the live scan."""
    from predictionio_tpu_torch.controller.engine import deserialize_model
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.tools import cli
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    add, _ = shared_store
    add(_rows(3, 120, 0))
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps({
        "id": "snap-rec",
        "datasource": {"params": {"appName": "SnapApp"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 4, "numIterations": 3, "seed": 2, "checkpointInterval": 0}}],
    }))
    # the train verb mirrors the flags into the environment, as the
    # reference's does; monkeypatch restores it
    monkeypatch.setenv("PIO_SNAPSHOT_MODE", "off")
    monkeypatch.setenv("PIO_SNAPSHOT_DIR", str(tmp_path / "unused"))
    factors = []
    for flags in ([], ["--snapshot-mode", mode, "--snapshot-dir", str(tmp_path / "s")]):
        assert cli.main(["train", "--variant", str(engine_json), "--device", "cpu",
                         *flags]) == 0
        variant = load_engine_variant(str(engine_json))
        instance = storage.get_meta_data_engine_instances().get_latest_completed(
            variant.variant_id, variant.engine_version, variant.path)
        model = deserialize_model(variant.template,
                                  storage.get_model_data_models().get(instance.id).models)
        factors.append((model.als.user_factors, model.als.item_factors, model.item_ids))
    assert os.environ["PIO_SNAPSHOT_MODE"] == mode
    assert any(n.startswith("gen-") for _, dirs, _ in os.walk(tmp_path / "s") for n in dirs)
    np.testing.assert_array_equal(factors[1][0], factors[0][0])
    np.testing.assert_array_equal(factors[1][1], factors[0][1])
    assert factors[1][2] == factors[0][2]
