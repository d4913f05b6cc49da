"""The port's WAL, ingest replay and WAL follower against the JAX package's.

``data/wal.py``, ``data/ingest.py`` and ``online/follower.py`` are
verbatim copies, so the on-disk format must be one: the same records
written by either package give the same bytes, and each package replays
the log the other wrote -- P = 1 (the flat layout) and P = 3 (the
partitioned one), past a checkpoint that collected segments and after a
torn tail -- to the same records, seqnos, checkpoint and surviving
segments; the replay into each package's store gives the same events;
and the followers of both packages poll the log and keep their cursors
alike. Exact equality throughout (no tolerance: bytes and integers).
"""

import datetime as dt
import importlib
import os
import shutil

import numpy as np
import pytest

PACKAGES = ("predictionio_tpu", "predictionio_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _events(pkg, n=60, users=8, seed=11):
    """Seeded rate events with fixed ids, one a second, in ``pkg``'s
    Event class."""
    event_mod = _mod(pkg, "data.event")
    rng = np.random.default_rng(seed)
    base = dt.datetime(2024, 5, 1, tzinfo=dt.timezone.utc)
    return [
        event_mod.Event(
            event="rate" if k % 7 else "view", entity_type="user",
            entity_id=f"u{rng.integers(0, users)}", target_entity_type="item",
            target_entity_id=f"i{rng.integers(0, 20)}",
            properties=event_mod.DataMap({"rating": int(rng.integers(1, 6))}),
            event_time=base + dt.timedelta(seconds=k), event_id=f"ev{k:04d}",
            creation_time=base + dt.timedelta(seconds=k),
        )
        for k in range(n)
    ]


def write_log(pkg, directory, partitions):
    """Append 60 routed records in three syncs, checkpoint each partition
    after the first 40 (collecting the covered segments), close.
    Returns the records past the checkpoint per partition."""
    wal_mod, ingest = _mod(pkg, "data.wal"), _mod(pkg, "data.ingest")
    wal = wal_mod.PartitionedWal(directory, partitions=partitions, segment_bytes=700)
    written = [[] for _ in range(partitions)]
    try:
        for k, event in enumerate(_events(pkg)):
            part = ingest.partition_of(event, partitions)
            payload = ingest.wal_payload(event, 1, None)
            written[part].append((wal.part(part).append(payload), payload))
            if k in (19, 39, 59):
                for p in wal.parts:
                    p.sync()
            if k == 39:
                for p, records in zip(wal.parts, written):
                    if records:
                        p.checkpoint(records[-1][0])
    finally:
        wal.close()
    return [records[next((i for i, (s, _) in enumerate(records)
                          if s > wal_mod.read_checkpoint(d)), len(records)):]
            for records, d in zip(written, wal_mod.partition_dirs(directory, partitions))]


def _tree(directory):
    """{relative path: bytes} of every file under ``directory``."""
    out = {}
    for root, _, files in os.walk(directory):
        for name in files:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, directory)] = f.read()
    return out


@pytest.mark.parametrize("partitions", [1, 3])
def test_both_packages_write_the_same_bytes(tmp_path, partitions):
    trees = []
    for pkg in PACKAGES:
        write_log(pkg, str(tmp_path / pkg), partitions)
        trees.append(_tree(str(tmp_path / pkg)))
    assert trees[1] == trees[0]
    # the checkpoint collected the segments it covered
    wal_mod = _mod(PACKAGES[0], "data.wal")
    dirs = wal_mod.partition_dirs(str(tmp_path / PACKAGES[0]), partitions)
    assert all(wal_mod.oldest_seqno(d) > 1 for d in dirs)
    assert ("wal.parts" in trees[0]) == (partitions > 1)


@pytest.mark.parametrize("partitions", [1, 3])
@pytest.mark.parametrize("writer", PACKAGES)
def test_each_package_replays_the_others_wal(tmp_path, storage_env, monkeypatch,
                                             writer, partitions):
    """A torn tail after the last intact frame of partition 0 hides
    nothing: both readers see the same records past the checkpoint, with
    the same seqnos, replay them into their stores as the same events,
    and end on the same checkpoint and segment files."""
    source = str(tmp_path / "written")
    pending = write_log(writer, source, partitions)
    wal_mod = _mod(writer, "data.wal")
    part0 = wal_mod.partition_dirs(source, partitions)[0]
    newest = sorted(n for n in os.listdir(part0) if n.endswith(".log"))[-1]
    with open(os.path.join(part0, newest), "ab") as f:
        f.write(b"\x30\x00\x00\x00\xde\xad")  # a frame header cut short
    seen = {}
    for reader in PACKAGES:
        directory = str(tmp_path / f"read-{reader}")
        shutil.copytree(source, directory)
        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / f"store-{reader}"))
        storage = _mod(reader, "data.storage")
        storage.reset()
        storage.get_l_events().init_channel(1)
        wal = _mod(reader, "data.wal").PartitionedWal(directory)  # adopts P
        try:
            records = [list(p.replay()) for p in wal.parts]
            replayed = _mod(reader, "data.ingest").replay_partitioned_wal(wal)
        finally:
            wal.close()
        stored = sorted(e.to_json_obj()["eventId"] for e in
                        storage.get_l_events().find(app_id=1))
        dirs = _mod(reader, "data.wal").partition_dirs(directory)
        seen[reader] = (
            wal.partitions, records, replayed, stored,
            [_mod(reader, "data.wal").read_checkpoint(d) for d in dirs],
            sorted(p for p in _tree(directory) if p.endswith(".log")),
        )
        storage.reset()
    assert seen[PACKAGES[1]] == seen[PACKAGES[0]]
    got_partitions, records, replayed, stored, checkpoints, _ = seen[PACKAGES[0]]
    assert got_partitions == partitions
    assert records == pending and replayed == 20
    assert stored == [f"ev{k:04d}" for k in range(40, 60)]
    assert checkpoints == [r[-1][0] if r else c for r, c in zip(
        pending, [wal_mod.read_checkpoint(d)
                  for d in wal_mod.partition_dirs(source, partitions)])]


@pytest.mark.parametrize("partitions", [1, 3])
def test_followers_poll_alike(tmp_path, partitions):
    """``partition_tails`` + ``WalTail.poll`` of both packages over one
    log, from the start and from a cursor one package wrote and the other
    read: equal batches (touched users and items, counts, event-time
    bounds, seqnos, the gap flag)."""
    directory = str(tmp_path / "wal")
    write_log(PACKAGES[0], directory, partitions)

    def polls(pkg, cursor_path):
        follower = _mod(pkg, "online.follower")
        cursors = follower.TailCursor(cursor_path)
        out = []
        for tail in follower.partition_tails(directory, 1, None, ["rate"]):
            b = tail.poll(cursors.seqno)
            out.append((b.last_seqno, b.records, sorted(b.touched_users),
                        sorted(b.touched_items), b.min_event_ms, b.max_event_ms,
                        b.gap, b.empty))
        merged = follower.merge_batches([tail.poll(0) for tail in
                                         follower.partition_tails(directory, 1, None,
                                                                  ["rate"])])
        return out, (merged.records, sorted(merged.touched_users), merged.gap)

    fresh = [polls(pkg, str(tmp_path / "none.json")) for pkg in PACKAGES]
    assert fresh[1] == fresh[0]
    # the checkpoint collected segments: a fresh cursor sees a gap
    assert fresh[0][1][2] and all(o[6] for o in fresh[0][0])
    for writer, reader in (PACKAGES, PACKAGES[::-1]):
        path = str(tmp_path / f"cursor-{writer}.json")
        _mod(writer, "online.follower").TailCursor(path).advance(45, 1234, 7)
        cursor = _mod(reader, "online.follower").TailCursor(path)
        assert (cursor.seqno, cursor.until_ms, cursor.snapshot_rows) == (45, 1234, 7)
    assert polls(PACKAGES[0], path) == polls(PACKAGES[1], path)


@pytest.mark.parametrize("damage", ["lost", "emptied", "cut short"])
def test_a_lost_or_torn_checkpoint_only_lengthens_the_replay(tmp_path, monkeypatch,
                                                            damage):
    """The risk ``pio check`` accepts at ``WriteAheadLog.checkpoint``
    (R003: its rename has no fsync before it). A checkpoint that a crash
    lost, emptied or cut short ("40" -> "4") makes the next startup replay
    start at the oldest retained record, re-delivering records the store
    already holds -- never losing one: the store ends with every event
    once, and the replay re-derives the checkpoint."""
    port = PACKAGES[1]
    wal_mod, ingest = _mod(port, "data.wal"), _mod(port, "data.ingest")
    directory = str(tmp_path / "wal")
    pending = write_log(port, directory, 1)
    checkpoint = wal_mod.read_checkpoint(directory)
    oldest = wal_mod.oldest_seqno(directory)
    assert (checkpoint, len(pending[0])) == (40, 20) and 1 < oldest <= checkpoint
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
    storage = _mod(port, "data.storage")
    storage.reset()
    try:
        l_events = storage.get_l_events()
        l_events.init_channel(1)
        # the storage flush the checkpoint stood for (P = 1: event k is seqno k + 1)
        l_events.insert_batch([(e, 1, None) for e in _events(port)[:checkpoint]])
        path = os.path.join(directory, "wal.ckpt")
        if damage == "lost":
            os.remove(path)
        else:
            with open(path, "w") as f:
                f.write("" if damage == "emptied" else str(checkpoint)[:-1])
        wal = wal_mod.PartitionedWal(directory)
        try:
            replayed = ingest.replay_partitioned_wal(wal)
        finally:
            wal.close()
        assert replayed == 60 - oldest + 1 > len(pending[0])
        stored = sorted(e.to_json_obj()["eventId"] for e in l_events.find(app_id=1))
        assert stored == [f"ev{k:04d}" for k in range(60)]
        assert wal_mod.read_checkpoint(directory) == 60
    finally:
        storage.reset()
