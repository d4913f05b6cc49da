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
``blocks/`` directory, also laid out for a mesh's axes. Across gloo
processes (the ports of the reference's two-process tests): each rank
retains about its half of the edges and the fit over the mesh equals
the one-process full build's and JAX's; the sharded cooccurrence's
per-rank CSRs, summed counts and indicators equal the one-process full
path's.
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
from predictionio_tpu_torch.parallel import reader
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

    def test_mesh_model_axis_and_world_size_raise(self):
        """Over the port's 1 x 1 mesh (one process) with a model axis's
        packing, the reader, the cooccurrence layout and its row range
        equal the JAX package's on ``local_mesh(1, 1)``; the layout
        arithmetic of wider meshes (``cooc_global_rows``) equals the
        reference's too. Several processes: the two-process tests below."""
        from predictionio_tpu_torch.parallel.mesh import local_mesh as torch_mesh

        n_u, n_i, uu, ii, rr, tt = _coo(n_e=200)
        cfg = ALSConfig(rank=4, buckets=2)
        one = torch_mesh(device="cpu")
        got = build_als_data_sharded(array_coo_chunks(uu, ii, rr, tt), n_u, n_i, cfg, one,
                                     model_shards=2)
        want = jax_reader.build_als_data_sharded(
            jax_reader.array_coo_chunks(uu, ii, rr, tt), n_u, n_i,
            jax_als.ALSConfig(rank=4, buckets=2), local_mesh(1, 1), model_shards=2)
        _assert_same_als_data(got, want)
        assert got.by_row.global_rows == want.by_row.global_rows
        assert all(r % 16 == 0 for r in got.by_row.global_rows)
        ones = np.ones(len(uu), np.float32)
        s = build_cooc_csr_sharded(array_coo_chunks(uu, ii, ones), n_u, n_i, one, chunk=8)
        w = jax_reader.build_cooc_csr_sharded(jax_reader.array_coo_chunks(uu, ii, ones),
                                              n_u, n_i, local_mesh(1, 1), chunk=8)
        assert (s.global_rows, s.row_lo, s.row_hi) == (w.global_rows, w.row_lo, w.row_hi)
        np.testing.assert_array_equal(s.local.indices, w.local.indices)
        for d in (1, 2, 4, 8):
            for n, chunk in ((n_u, 8), (37, 16), (1, 4096)):
                assert reader.cooc_global_rows(n, local_mesh(d, 1), chunk) == \
                    jax_reader.cooc_global_rows(n, local_mesh(d, 1), chunk)
        assert reader._local_row_range(None, 48) == reader._local_row_range(one, 48) == (0, 48)


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
        # over a mesh: laid out for its data axis and model_shards, as the
        # reference's (the port's one process: a 1 x 1 mesh)
        from predictionio_tpu_torch.parallel.mesh import local_mesh as torch_mesh

        _, _, got = reader.snapshot_streamed_als_data(
            snap, ALSConfig(**cfg_kw), mesh=torch_mesh(device="cpu"), model_shards=2,
            block_rows=16)
        use("jax")
        _, _, want = jax_reader.snapshot_streamed_als_data(
            jax_snap, jax_als.ALSConfig(**cfg_kw), mesh=local_mesh(1, 1), model_shards=2,
            block_rows=16)
        assert got.row_multiple == want.row_multiple == 16
        assert os.path.basename(got.directory) == os.path.basename(want.directory)
        for name in sorted(os.listdir(want.directory)):
            if name.endswith(".bin"):
                with open(os.path.join(want.directory, name), "rb") as f, open(
                        os.path.join(got.directory, name), "rb") as g:
                    assert g.read() == f.read(), name


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


_READER_WORKER = """
import sys
import numpy as np
from predictionio_tpu_torch.parallel.distributed import init_distributed, build_mesh
from predictionio_tpu_torch.parallel.als import ALSConfig, als_fit
from predictionio_tpu_torch.parallel.reader import array_coo_chunks, build_als_data_sharded

assert init_distributed(device="cpu")
mesh = build_mesh([2, 1], ("data", "model"), device="cpu")
rng = np.random.default_rng(17)
n_e = 3000
uu = rng.integers(0, 96, size=n_e)
ii = rng.integers(0, 40, size=n_e)
rr = rng.integers(1, 6, size=n_e).astype(np.float32)
cfg = ALSConfig(rank=4, iterations=4, reg=0.05, seed=2, buckets=2)
data = build_als_data_sharded(array_coo_chunks(uu, ii, rr, chunk_rows=512), 96, 40, cfg, mesh)
# THE memory-scaling assertion: this process retained about half the
# edge set per side, never the whole thing
for side in (data.by_row, data.by_col):
    assert 0.3 * n_e < side.retained_edges < 0.7 * n_e, side.retained_edges
model = als_fit(data, cfg, mesh=mesh)
np.savez(sys.argv[1] + f"-{mesh.rank}.npz", users=model.user_factors, items=model.item_factors,
         retained=np.array([data.by_row.retained_edges, data.by_col.retained_edges]),
         **{f"u_idx{b}": block.indices for b, block in enumerate(data.by_row.blocks)})
print("OK", flush=True)
"""


def test_two_process_sharded_reader_matches_single_process(tmp_path):
    """Two gloo processes on a 2 x 1 mesh: each retains only ~its half of
    the edges (asserted inside the workers), its blocks are its rows of
    the full build's, and the factors equal a one-process full-build
    train (1e-5) and JAX's on a 2 x 1 mesh of virtual devices (1e-4)."""
    from predictionio_tpu.parallel.reader import array_coo_chunks as jax_chunks
    from test_torch_distributed import run_workers

    out = str(tmp_path / "factors")
    run_workers(_READER_WORKER, n=2, args=(out,))
    rng = np.random.default_rng(17)
    n_e = 3000
    uu = rng.integers(0, 96, size=n_e)
    ii = rng.integers(0, 40, size=n_e)
    rr = rng.integers(1, 6, size=n_e).astype(np.float32)
    kw = dict(rank=4, iterations=4, reg=0.05, seed=2, buckets=2)
    full = build_als_data(uu, ii, rr, 96, 40, ALSConfig(**kw), num_shards=2)
    one = als_fit(full, ALSConfig(**kw), "cpu")
    ref = jax_als.als_fit(
        jax_reader.build_als_data_sharded(jax_chunks(uu, ii, rr, chunk_rows=512), 96, 40,
                                          jax_als.ALSConfig(**kw), local_mesh(2, 1)),
        jax_als.ALSConfig(**kw), local_mesh(2, 1))
    got = [np.load(f"{out}-{r}.npz") for r in range(2)]
    assert sum(int(g["retained"][0]) for g in got) == n_e
    for rank, g in enumerate(got):
        assert (g["retained"] < 0.7 * n_e).all()
        for b, block in enumerate(full.by_row.blocks):
            half = block.indices.shape[0] // 2
            np.testing.assert_array_equal(g[f"u_idx{b}"],
                                          block.indices[rank * half:(rank + 1) * half])
        np.testing.assert_array_equal(g["users"], got[0]["users"])
    np.testing.assert_allclose(got[0]["users"], one.user_factors, atol=1e-5)
    np.testing.assert_allclose(got[0]["items"], one.item_factors, atol=1e-5)
    np.testing.assert_allclose(got[0]["users"], ref.user_factors, atol=1e-4)
    np.testing.assert_allclose(got[0]["items"], ref.item_factors, atol=1e-4)


_COOC_WORKER = """
import sys
import numpy as np
from predictionio_tpu_torch.parallel.distributed import init_distributed, build_mesh
from predictionio_tpu_torch.ops.cooccurrence import cooccurrence, cooccurrence_indicators
from predictionio_tpu_torch.parallel.reader import (
    array_coo_chunks, build_cooc_csr_sharded, distinct_user_counts_sharded)

assert init_distributed(device="cpu")
mesh = build_mesh([2, 1], ("data", "model"), device="cpu")
rng = np.random.default_rng(23)
n_u, n_i, n_e = 400, 30, 5000
uu = rng.integers(0, n_u, n_e)
ii = rng.integers(0, n_i, n_e)
vv = np.ones(n_e, np.float32)
s = build_cooc_csr_sharded(array_coo_chunks(uu, ii, vv, chunk_rows=600), n_u, n_i, mesh,
                           chunk=32)
assert s.retained_edges < 0.7 * n_e, s.retained_edges
counts = distinct_user_counts_sharded(s, mesh)
idx, vals = cooccurrence_indicators(s, top_k=8, llr_row_totals=counts,
                                    llr_col_totals=counts, total=n_u, chunk=32, mesh=mesh)
raw = cooccurrence(s, chunk=32, mesh=mesh)
np.savez(sys.argv[1] + f"-{mesh.rank}.npz", idx=idx, vals=vals, counts=counts, raw=raw,
         retained=np.array([s.retained_edges]), lo=np.array([s.row_lo, s.row_hi]))
print("OK", flush=True)
"""


def test_two_process_sharded_cooccurrence(tmp_path):
    """The sharded cooccurrence across two gloo processes: each rank
    retains its half of the user rows, the distinct-user counts sum over
    the data axis, and the raw counts, the LLR indicators and the counts
    equal the one-process full path's (and the JAX package's on a 2 x 1
    mesh) bit for bit."""
    from predictionio_tpu.ops import cooccurrence as jax_cooc
    from test_torch_distributed import run_workers

    out = str(tmp_path / "cooc")
    run_workers(_COOC_WORKER, n=2, args=(out,))
    rng = np.random.default_rng(23)
    n_u, n_i, n_e = 400, 30, 5000
    uu = rng.integers(0, n_u, n_e)
    ii = rng.integers(0, n_i, n_e)
    vv = np.ones(n_e, np.float32)
    full = pack_padded_csr(uu, ii, vv, n_u, n_i)
    counts = distinct_user_counts(full)
    idx_f, val_f = cooccurrence_indicators(
        full, top_k=8, llr_row_totals=counts, llr_col_totals=counts, total=n_u,
        chunk=32, device="cpu")
    idx_j, val_j = jax_cooc.cooccurrence_indicators(
        full, top_k=8, llr_row_totals=counts, llr_col_totals=counts, total=n_u,
        mesh=local_mesh(2, 1), chunk=32)
    got = [np.load(f"{out}-{r}.npz") for r in range(2)]
    assert sum(int(g["retained"][0]) for g in got) == n_e
    assert [tuple(g["lo"]) for g in got] == [(0, 224), (224, 448)]
    for g in got:
        assert g["retained"][0] < 0.7 * n_e
        np.testing.assert_array_equal(g["counts"], counts)
        np.testing.assert_array_equal(g["raw"], cooccurrence(full, chunk=32, device="cpu"))
        np.testing.assert_array_equal(g["idx"], idx_f)
        np.testing.assert_array_equal(g["vals"], val_f)
        np.testing.assert_array_equal(g["idx"], np.asarray(idx_j))
        np.testing.assert_allclose(g["vals"], np.asarray(val_j), atol=1e-4)
