"""The port's streaming reader (``parallel/reader.py``) against its full
build and against the JAX package's reader, on the CPU.

The single-process cases of ``tests/test_sharded_reader.py``, ported (one
process on one card: ``mesh=None``, whose rows are all rows):
``build_als_data_sharded`` packs the same layout as ``build_als_data``
and as the JAX package's one-device reader, and a fit over it equals the
full build's bit for bit; the store's chunked scan (``store_coo_chunks``,
``store_multi_event_chunks``) and a snapshot's replay feed the reader
with the chunks, ids and vocabularies the JAX package's sources yield
over the same events, stable across passes; the user-rows CSR of the
cooccurrence templates (``build_cooc_csr_sharded``) gives the full
path's counts and indicators, also over chunk spans that are not
8-aligned, and the empty stream, a layout built for another ``chunk``
and a sharded CSR mixed with a full one are refused; a snapshot packs
into the same block store as the JAX package's under the generation's
``blocks/`` directory. A mesh, a model axis above 1 or a second process
raises ``NotImplementedError`` (ROADMAP.md Queue A item 8).
"""

import datetime as dt
import os

import numpy as np
import pytest

from predictionio_tpu.data import storage as jax_storage
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.snapshot import SnapshotSpec as JaxSnapshotSpec
from predictionio_tpu.data.snapshot import SnapshotStore as JaxSnapshotStore
from predictionio_tpu.data.storage.base import App as JaxApp
from predictionio_tpu.parallel import als as jax_als
from predictionio_tpu.parallel import reader as jax_reader
from predictionio_tpu.parallel.mesh import local_mesh
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.snapshot import SnapshotSpec, SnapshotStore
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.ops.cooccurrence import (
    cooccurrence,
    cooccurrence_indicators,
    distinct_user_counts,
)
from predictionio_tpu_torch.ops.ragged import pack_padded_csr
from predictionio_tpu_torch.parallel import als, reader
from predictionio_tpu_torch.parallel.als import ALSConfig, als_fit, build_als_data
from predictionio_tpu_torch.parallel.reader import (
    array_coo_chunks,
    build_als_data_sharded,
    build_cooc_csr_sharded,
    distinct_user_counts_sharded,
)
from test_torch_store_train import basedir, fill_store  # noqa: F401

APP = "ReaderApp"
BASE = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)


def _coo(seed=5, n_u=120, n_i=40, n_e=2500):
    rng = np.random.default_rng(seed)
    uu = rng.integers(0, n_u, size=n_e)
    ii = (np.minimum(rng.random(n_e) ** 2, 0.999) * n_i).astype(np.int64)
    rr = rng.integers(1, 6, size=n_e).astype(np.float32)
    tt = rng.permutation(n_e).astype(np.float64)
    return n_u, n_i, uu, ii, rr, tt


def _drain(source):
    cols = [[], [], [], []]
    for chunk in source():
        for acc, part in zip(cols, chunk):
            acc.append(part)
    return [np.concatenate(c) if c else np.empty(0) for c in cols]


def reader_events(n: int = 400, seed: int = 0) -> list[dict]:
    """Rate (with a rating), buy and view events, one a second; every 11th
    has no target entity (the scan drops it, the snapshot keeps a -1)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        name = ("rate", "buy", "view")[k % 3]
        e = {"eventId": f"ev{k:05d}", "event": name, "entityType": "user",
             "entityId": f"u{rng.integers(0, 30)}",
             "properties": {"rating": float(rng.integers(1, 6))} if name == "rate" else {},
             "eventTime": (BASE + dt.timedelta(seconds=k)).isoformat()}
        if k % 11 != 10:
            e.update(targetEntityType="item", targetEntityId=f"i{rng.integers(0, 12)}")
        out.append(e)
    return out


@pytest.fixture()
def stores(basedir, tmp_path):  # noqa: F811
    """The same events in each package's store; ``use(name)`` points both
    registries at one of them. Returns (use, app id)."""
    paths = {name: str(tmp_path / name) for name in ("jax", "port")}
    events = reader_events()
    basedir(paths["jax"])
    app_id = fill_store(jax_storage, JaxApp, JaxEvent, events, app_name=APP)
    basedir(paths["port"])
    assert fill_store(storage, App, Event, events, app_name=APP) == app_id
    return (lambda name: basedir(paths[name])), app_id


def _assert_same_als_data(got, want):
    for g_side, w_side in ((got.by_row, want.by_row), (got.by_col, want.by_col)):
        np.testing.assert_array_equal(g_side.slot_of, w_side.slot_of)
        assert (g_side.num_rows, g_side.total_slots) == (w_side.num_rows, w_side.total_slots)
        assert len(g_side.blocks) == len(w_side.blocks)
        for gb, wb in zip(g_side.blocks, w_side.blocks):
            for name in ("indices", "values", "mask"):
                np.testing.assert_array_equal(getattr(gb, name), getattr(wb, name))


class TestSingleProcessEquivalence:
    @pytest.mark.parametrize("buckets,max_len", [(1, None), (3, 32)])
    def test_layout_matches_full_and_reference_builds(self, buckets, max_len):
        """Same plans, blocks and slot maps as ``build_als_data`` and as the
        JAX package's reader on one device: chunking and retention are
        layout-invisible."""
        n_u, n_i, uu, ii, rr, tt = _coo()
        cfg = ALSConfig(rank=4, buckets=buckets, max_len=max_len)
        full = build_als_data(uu, ii, rr, n_u, n_i, cfg, times=tt)
        shard = build_als_data_sharded(array_coo_chunks(uu, ii, rr, tt, chunk_rows=300),
                                       n_u, n_i, cfg)
        _assert_same_als_data(shard, full)
        for f_side, s_side in ((full.by_row, shard.by_row), (full.by_col, shard.by_col)):
            assert s_side.global_rows == tuple(b.indices.shape[0] for b in f_side.blocks)
        assert shard.by_row.retained_edges == shard.by_col.retained_edges == len(uu)
        want = jax_reader.build_als_data_sharded(
            jax_reader.array_coo_chunks(uu, ii, rr, tt, chunk_rows=300), n_u, n_i,
            jax_als.ALSConfig(rank=4, buckets=buckets, max_len=max_len), local_mesh(1, 1))
        _assert_same_als_data(shard, want)
        for g_side, w_side in ((shard.by_row, want.by_row), (shard.by_col, want.by_col)):
            assert (g_side.global_rows, g_side.retained_edges) == (
                w_side.global_rows, w_side.retained_edges)

    def test_fit_matches_full_build(self):
        n_u, n_i, uu, ii, rr, tt = _coo()
        cfg = ALSConfig(rank=4, iterations=4, reg=0.05, seed=2, buckets=2)
        m_full = als_fit(build_als_data(uu, ii, rr, n_u, n_i, cfg, times=tt), cfg, "cpu")
        m_shard = als_fit(build_als_data_sharded(
            array_coo_chunks(uu, ii, rr, tt, chunk_rows=500), n_u, n_i, cfg), cfg, "cpu")
        np.testing.assert_array_equal(m_full.user_factors, m_shard.user_factors)
        np.testing.assert_array_equal(m_full.item_factors, m_shard.item_factors)

    def test_entity_counts_grow_with_the_stream(self):
        """Unknown counts (None) come from pass 1; given counts are lower
        bounds, grown by ids past them."""
        n_u, n_i, uu, ii, rr, tt = _coo()
        cfg = ALSConfig(rank=4)
        grown = build_als_data_sharded(array_coo_chunks(uu, ii, rr, tt), None, 3, cfg)
        assert grown.by_row.num_rows == int(uu.max()) + 1
        assert grown.by_col.num_rows == int(ii.max()) + 1

    def test_mesh_model_axis_and_world_size_raise(self, monkeypatch):
        n_u, n_i, uu, ii, rr, tt = _coo(n_e=200)
        cfg = ALSConfig(rank=4)
        source = array_coo_chunks(uu, ii, rr, tt)
        for call in (lambda: build_als_data_sharded(source, n_u, n_i, cfg, object()),
                     lambda: build_als_data_sharded(source, n_u, n_i, cfg, model_shards=2),
                     lambda: build_cooc_csr_sharded(source, n_u, n_i, object()),
                     lambda: reader.cooc_global_rows(n_u, object(), 8)):
            with pytest.raises(NotImplementedError, match="Queue A item 8"):
                call()
        monkeypatch.setattr(als, "world_size", lambda: 4)
        with pytest.raises(NotImplementedError, match="world size of 4"):
            build_als_data_sharded(source, n_u, n_i, cfg)


class TestStoreChunkScan:
    @pytest.mark.parametrize("event_values", [None, {"rate": 3.0, "buy": 2.0}])
    def test_chunked_scan_equals_the_reference(self, stores, event_values):
        """events table -> ``iter_interaction_chunks`` -> COO chunks: the
        same chunks, ids and vocabularies as the JAX package's scan, over
        a bounded prefix (a later write does not enter)."""
        use, app_id = stores
        until = BASE + dt.timedelta(seconds=300)
        kw = dict(event_names=["rate", "buy"], chunk_rows=64, until_time=until,
                  event_values=event_values)
        use("jax")
        src, want_u, want_i = jax_reader.store_coo_chunks(jax_storage.get_l_events(), app_id,
                                                          **kw)
        want = _drain(src)
        use("port")
        source, users_enc, items_enc = reader.store_coo_chunks(storage.get_l_events(),
                                                               app_id, **kw)
        got = _drain(source)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert users_enc.ids == want_u.ids and items_enc.ids == want_i.ids
        storage.get_l_events().insert(Event(
            event="rate", entity_type="user", entity_id="late", target_entity_type="item",
            target_entity_id="i-late", event_time=BASE + dt.timedelta(seconds=350)), app_id)
        for g, w in zip(_drain(source), want):
            np.testing.assert_array_equal(g, w)

    def test_chunked_scan_feeds_the_reader(self, stores):
        """The whole store-backed path: chunked scan -> reader (entity
        counts unknown before the first pass) -> fit."""
        use, app_id = stores
        use("port")
        source, users_enc, items_enc = reader.store_coo_chunks(
            storage.get_l_events(), app_id, event_names=["rate"], chunk_rows=32)
        cfg = ALSConfig(rank=4, iterations=3, buckets=2)
        data = build_als_data_sharded(source, None, None, cfg)
        rates = sum(1 for e in reader_events() if e["event"] == "rate" and "targetEntityId" in e)
        assert data.by_row.retained_edges == rates
        assert data.by_row.num_rows == len(users_enc.ids)
        assert data.by_col.num_rows == len(items_enc.ids)
        model = als_fit(data, cfg, "cpu")
        assert np.isfinite(model.user_factors).all()
        assert model.user_factors.shape == (len(users_enc.ids), 4)

    def test_encoder_stable_across_passes(self, stores):
        use, app_id = stores
        use("port")
        source, users_enc, _ = reader.store_coo_chunks(storage.get_l_events(), app_id,
                                                       chunk_rows=16)
        first = np.concatenate([c[0] for c in source()])
        vocab = dict(users_enc.vocab)
        second = np.concatenate([c[0] for c in source()])
        np.testing.assert_array_equal(first, second)
        assert users_enc.vocab == vocab

    def test_multi_event_sources_equal_the_reference(self, stores):
        """One shared universe over every type's source, primed by
        ``universe_pass``; the snapshot replay gives the same."""
        use, app_id = stores
        names = ["buy", "view"]
        use("jax")
        srcs, want_u, want_i = jax_reader.store_multi_event_chunks(
            jax_storage.get_l_events(), app_id, names, chunk_rows=48)
        jax_reader.universe_pass(srcs)
        want = {n: _drain(srcs[n]) for n in names}
        use("port")
        le = storage.get_l_events()
        sources, users_enc, items_enc = reader.store_multi_event_chunks(le, app_id, names,
                                                                        chunk_rows=48)
        reader.universe_pass(sources)
        assert users_enc.ids == want_u.ids and items_enc.ids == want_i.ids
        for n in names:
            for g, w in zip(_drain(sources[n]), want[n]):
                np.testing.assert_array_equal(g, w)
        until = BASE + dt.timedelta(seconds=10_000)
        snap = SnapshotStore(os.path.join(os.environ["PIO_FS_BASEDIR"], "snaps"),
                             SnapshotSpec(app_id=app_id, event_names=tuple(names))).build(
            le, until, chunk_rows=64)
        rep, rep_u, rep_i = reader.snapshot_multi_event_chunks(snap, names, chunk_rows=48)
        assert rep_u.ids == want_u.ids and rep_i.ids == want_i.ids
        for n in names:
            for g, w in zip(_drain(rep[n]), want[n]):
                np.testing.assert_array_equal(g, w)


class TestSnapshotBlockStore:
    def test_snapshot_packs_the_reference_block_store(self, stores):
        """``snapshot_streamed_als_data``: the port's snapshot replayed into
        a block store under its generation's ``blocks/`` directory, byte
        for byte the JAX package's from its own snapshot of the same
        events."""
        use, app_id = stores
        until = BASE + dt.timedelta(seconds=10_000)
        cfg_kw = dict(max_len=16, buckets=2)
        use("jax")
        jax_snap = JaxSnapshotStore(
            os.path.join(os.environ["PIO_FS_BASEDIR"], "snaps"),
            JaxSnapshotSpec(app_id=app_id, event_names=("rate", "buy"))).build(
            jax_storage.get_l_events(), until)
        want_u, want_i, want = jax_reader.snapshot_streamed_als_data(
            jax_snap, jax_als.ALSConfig(**cfg_kw), block_rows=16)
        use("port")
        snap = SnapshotStore(os.path.join(os.environ["PIO_FS_BASEDIR"], "snaps"),
                             SnapshotSpec(app_id=app_id, event_names=("rate", "buy"))).build(
            storage.get_l_events(), until)
        users_enc, items_enc, got = reader.snapshot_streamed_als_data(
            snap, ALSConfig(**cfg_kw), block_rows=16)
        assert got.directory.startswith(os.path.join(snap.path, "blocks"))
        assert users_enc.ids == want_u.ids and items_enc.ids == want_i.ids
        assert os.path.basename(got.directory) == os.path.basename(want.directory)
        for name in sorted(os.listdir(want.directory)):
            if name.endswith(".bin"):
                with open(os.path.join(want.directory, name), "rb") as f, open(
                        os.path.join(got.directory, name), "rb") as g:
                    assert g.read() == f.read(), name
        with pytest.raises(NotImplementedError, match="Queue A item 8"):
            reader.snapshot_streamed_als_data(snap, ALSConfig(**cfg_kw), mesh=object())


class TestShardedCooccurrence:
    def test_matches_full_path_and_the_reference(self):
        """The reader's CSR through the cooccurrence, LLR and top-k equals
        the full-host path bit for bit (the same layout, the same chunks),
        the distinct-user totals too; and its local block equals the JAX
        package's one-device build."""
        rng = np.random.default_rng(3)
        n_u, n_i, n_e = 300, 40, 4000
        uu, ii = rng.integers(0, n_u, n_e), rng.integers(0, n_i, n_e)
        vv = np.ones(n_e, np.float32)
        full = pack_padded_csr(uu, ii, vv, n_u, n_i)
        counts = distinct_user_counts(full)
        idx_f, val_f = cooccurrence_indicators(
            full, top_k=10, llr_row_totals=counts, llr_col_totals=counts, total=n_u,
            chunk=64, device="cpu")
        s = build_cooc_csr_sharded(array_coo_chunks(uu, ii, vv, chunk_rows=700), n_u, n_i,
                                   chunk=64)
        counts_s = distinct_user_counts_sharded(s)
        np.testing.assert_array_equal(counts, counts_s)
        idx_s, val_s = cooccurrence_indicators(
            s, top_k=10, llr_row_totals=counts_s, llr_col_totals=counts_s, total=n_u,
            chunk=64, device="cpu")
        np.testing.assert_array_equal(idx_f, idx_s)
        np.testing.assert_array_equal(val_f, val_s)
        want = jax_reader.build_cooc_csr_sharded(
            jax_reader.array_coo_chunks(uu, ii, vv, chunk_rows=700), n_u, n_i,
            local_mesh(1, 1), chunk=64)
        assert (s.global_rows, s.row_lo, s.row_hi, s.num_rows, s.num_cols, s.retained_edges,
                s.global_edges) == (want.global_rows, want.row_lo, want.row_hi, want.num_rows,
                                    want.num_cols, want.retained_edges, want.global_edges)
        for name in ("indices", "values", "mask"):
            np.testing.assert_array_equal(getattr(s.local, name), getattr(want.local, name))

    def test_cross_occurrence_matches_full_path(self):
        rng = np.random.default_rng(4)
        n_u, n_i = 200, 30
        a_u, a_i = rng.integers(0, n_u, 1500), rng.integers(0, n_i, 1500)
        b_u, b_i = rng.integers(0, n_u, 2500), rng.integers(0, n_i, 2500)
        ones = lambda n: np.ones(n, np.float32)
        full = cooccurrence(pack_padded_csr(a_u, a_i, ones(1500), n_u, n_i),
                            pack_padded_csr(b_u, b_i, ones(2500), n_u, n_i),
                            chunk=16, device="cpu")
        got = cooccurrence(
            build_cooc_csr_sharded(array_coo_chunks(a_u, a_i, ones(1500)), n_u, n_i, chunk=16),
            build_cooc_csr_sharded(array_coo_chunks(b_u, b_i, ones(2500)), n_u, n_i, chunk=16),
            chunk=16, device="cpu")
        np.testing.assert_array_equal(got, full)

    def test_unaligned_chunk_spans(self):
        """The cooc layout's chunk-based spans need not be 8-aligned: 100
        users at chunk 3 are 105 rows, the local pack exactly that."""
        rng = np.random.default_rng(5)
        uu, ii = rng.integers(0, 100, 1200), rng.integers(0, 12, 1200)
        vv = np.ones(1200, np.float32)
        s = build_cooc_csr_sharded(array_coo_chunks(uu, ii, vv), 100, 12, chunk=3)
        assert s.global_rows == 105 and s.local.indices.shape[0] == 105
        got = cooccurrence(s, chunk=3, device="cpu")
        want = cooccurrence(pack_padded_csr(uu, ii, vv, 100, 12), device="cpu")
        np.testing.assert_array_equal(got, want)

    def test_empty_stream_rejected(self):
        with pytest.raises(ValueError, match="empty event store"):
            build_cooc_csr_sharded(
                array_coo_chunks(np.array([]), np.array([]), np.array([], np.float32)),
                None, None)

    def test_layout_mismatch_and_mixing_rejected(self):
        rng = np.random.default_rng(3)
        uu, ii = rng.integers(0, 100, 500), rng.integers(0, 10, 500)
        vv = np.ones(500, np.float32)
        s = build_cooc_csr_sharded(array_coo_chunks(uu, ii, vv), 100, 10, chunk=3)
        with pytest.raises(ValueError, match="rebuild"):
            cooccurrence(s, chunk=4096, device="cpu")  # 104 rows, not 105
        with pytest.raises(ValueError, match="mixing"):
            cooccurrence(s, pack_padded_csr(uu, ii, vv, 100, 10), chunk=3, device="cpu")
