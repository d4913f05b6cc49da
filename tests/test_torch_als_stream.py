"""The port's streamed ALS epochs (``parallel/stream.py``, ``parallel/als.py::
als_fit_streamed``) against its resident fit and against the JAX package,
on the CPU.

The cases of ``tests/test_als_stream.py``, ported: a block store the port
builds is byte-identical to the JAX package's (manifest, index, value and
n_obs files) and each package reads the other's; ``als_fit_streamed``
equals the port's resident ``als_fit`` bit for bit on the CPU, at equal
block shapes and in smaller blocks alike, for explicit and implicit
feedback, f32 and bf16 factors, uniform-value blocks and all-padding
blocks; against JAX's ``als_fit_streamed`` over the same store (its
``"xla"`` path, and ``"pallas"`` in interpret mode) the factors are held
to the reference's own solver-parity bar
(``tests/test_als_gram.py::test_fit_matches_xla``: ``atol`` 1e-4 for f32,
5e-3 for bf16, whose stored factors round once per iteration). Also the
cache reuse, the torn and foreign stores, the two-block bound, peak host
memory, the transfer model, the device budget and the refusals. A
``cuda``-marked test holds the card's streamed fit to its resident one.
"""

import dataclasses
import json
import os
import tempfile
import tracemalloc

import numpy as np
import pytest
import torch

from predictionio_tpu.parallel import als as jax_als
from predictionio_tpu.parallel import stream as jax_stream
from predictionio_tpu.parallel.mesh import local_mesh
from predictionio_tpu.parallel.reader import array_coo_chunks as jax_chunks
from predictionio_tpu_torch.parallel import als
from predictionio_tpu_torch.parallel.als import (
    ALSConfig,
    als_fit,
    als_fit_streamed,
    build_als_data,
)
from predictionio_tpu_torch.parallel.mesh import local_mesh as local_mesh_torch
from predictionio_tpu_torch.parallel.reader import array_coo_chunks
from predictionio_tpu_torch.parallel.stream import (
    StreamStats,
    build_streamed_als_data,
    load_streamed_als_data,
    reship_bytes_per_half_step,
    stream_bytes_per_half_step,
)

#: the reference's solver-parity bar (``tests/test_als_gram.py:198``)
JAX_ATOL = {"float32": 1e-4, "bfloat16": 5e-3}
#: manifest fields that are wall times of the build, not layout
TIMING_FIELDS = ("spill_seconds", "pack_seconds")


@pytest.fixture(scope="module")
def synthetic():
    rng = np.random.default_rng(42)
    n_u, n_i = 96, 64
    mask = rng.random((n_u, n_i)) < 0.22
    uu, ii = np.nonzero(mask)
    rr = (rng.normal(size=len(uu)) + 3).astype(np.float32)
    tt = rng.random(len(uu)).astype(np.float64)
    return n_u, n_i, uu, ii, rr, tt


def _fit_both(synthetic, cfg, block_rows=1 << 20, values=None, stats=None, budget=0):
    n_u, n_i, uu, ii, rr, tt = synthetic
    vals = rr if values is None else values
    data = build_als_data(uu, ii, vals, n_u, n_i, cfg, times=tt)
    resident = als_fit(data, cfg, "cpu")
    with tempfile.TemporaryDirectory() as td:
        streamed_data = build_streamed_als_data(
            array_coo_chunks(uu, ii, vals, times=tt), n_u, n_i, cfg, td,
            block_rows=block_rows,
        )
        streamed = als_fit_streamed(streamed_data, cfg, "cpu", stats=stats,
                                    device_budget_bytes=budget)
        specs = {
            side: [(s.rows, s.pad_len, s.const) for s in getattr(streamed_data, side).specs]
            for side in ("by_row", "by_col")
        }
    return resident, streamed, data, specs


def _assert_bit_identical(resident, streamed):
    np.testing.assert_array_equal(resident.user_factors, streamed.user_factors)
    np.testing.assert_array_equal(resident.item_factors, streamed.item_factors)


def _both_stores(synthetic, root, values=None, **build):
    """The same chunks built into a block store by each package: (JAX
    package's, port's)."""
    n_u, n_i, uu, ii, rr, tt = synthetic
    vals = rr if values is None else values
    kw = dict(rank=8, iterations=2, reg=0.01, seed=1, buckets=2)
    want = jax_stream.build_streamed_als_data(
        jax_chunks(uu, ii, vals, times=tt), n_u, n_i, jax_als.ALSConfig(**kw),
        os.path.join(root, "jax"), **build)
    got = build_streamed_als_data(
        array_coo_chunks(uu, ii, vals, times=tt), n_u, n_i, ALSConfig(**kw),
        os.path.join(root, "port"), **build)
    return want, got


class TestBlockStoreAgainstTheReference:
    @pytest.mark.parametrize("build", [
        {"block_rows": 1 << 20}, {"block_rows": 32}, {"block_bytes": 4096}, {"uniform": True},
    ], ids=["bucket_blocks", "sub_bucket_blocks", "byte_sized_blocks", "uniform_values"])
    def test_store_is_byte_identical(self, synthetic, tmp_path, build):
        build = dict(build)
        values = np.ones(len(synthetic[2]), np.float32) if build.pop("uniform", False) else None
        want, got = _both_stores(synthetic, str(tmp_path), values, **build)
        assert os.path.basename(got.directory) == os.path.basename(want.directory)
        names = sorted(os.listdir(want.directory))
        assert sorted(os.listdir(got.directory)) == names
        for name in names:
            with open(os.path.join(want.directory, name), "rb") as f:
                want_bytes = f.read()
            with open(os.path.join(got.directory, name), "rb") as f:
                got_bytes = f.read()
            if name == "manifest.json":
                w, g = json.loads(want_bytes), json.loads(got_bytes)
                for key in TIMING_FIELDS:
                    w.pop(key), g.pop(key)
                assert g == w
            else:
                assert got_bytes == want_bytes, name
        if values is not None:
            assert all(s.const == 1.0 for s in got.by_row.specs)
            assert not any(n.endswith(".val.bin") for n in names)

    def test_each_package_reads_the_others_store(self, synthetic, tmp_path):
        want, got = _both_stores(synthetic, str(tmp_path), block_rows=32)
        for reader, store, other in ((load_streamed_als_data, want, got),
                                     (jax_stream.load_streamed_als_data, got, want)):
            loaded = reader(store.directory)
            assert loaded is not None
            for side in ("by_row", "by_col"):
                a, b = getattr(loaded, side), getattr(other, side)
                assert [dataclasses.astuple(s) for s in a.specs] == [
                    dataclasses.astuple(s) for s in b.specs]
                np.testing.assert_array_equal(a.slot_of, b.slot_of)
                assert (a.num_rows, a.total_slots) == (b.num_rows, b.total_slots)
                for spec in a.specs:
                    for x, y in zip(a.load_block(spec), b.load_block(spec)):
                        if x is None:
                            assert y is None
                        else:
                            np.testing.assert_array_equal(x, y)

    def test_load_block_into_equals_load_block(self, synthetic, tmp_path):
        _, got = _both_stores(synthetic, str(tmp_path), block_rows=32)
        side = got.by_row
        cap = max(s.idx_bytes() + s.val_bytes() + s.nobs_bytes() for s in side.specs)
        buffer = np.empty(cap, np.uint8)
        for spec in side.specs:
            want = side.load_block(spec)
            into = side.load_block_into(spec, buffer)
            for x, y in zip(into, want):
                np.testing.assert_array_equal(x, y)
            assert into[0].base is not None  # a view of the buffer, no copy
            assert side.load_block_into(spec, buffer, with_nobs=False)[2] is None


class TestStreamedResidentParity:
    """Bit parity with the port's resident fit; the reference's bar against
    JAX's streamed fit over the same store."""

    @pytest.mark.parametrize(
        "implicit,dtype,solver",
        [
            (False, "float32", "xla"),
            (True, "float32", "xla"),
            (False, "float32", "pallas"),
            (True, "float32", "pallas"),
            (False, "bfloat16", "xla"),
            (True, "bfloat16", "pallas"),
        ],
    )
    def test_equal_shapes_bit_identical(self, synthetic, implicit, dtype, solver):
        cfg = ALSConfig(rank=8, iterations=2, reg=0.01, seed=1, buckets=2,
                        implicit=implicit, alpha=5.0, dtype=dtype, solver=solver)
        resident, streamed, _, _ = _fit_both(synthetic, cfg)
        _assert_bit_identical(resident, streamed)

    @pytest.mark.parametrize(
        "implicit,dtype,solver",
        [
            (False, "float32", "xla"),
            (True, "float32", "xla"),
            (False, "float32", "pallas"),
            (True, "float32", "pallas"),
            (False, "bfloat16", "xla"),
            (True, "bfloat16", "pallas"),
        ],
    )
    def test_matches_the_reference_streamed_fit(self, synthetic, tmp_path, implicit, dtype,
                                                solver):
        """Over one store (the JAX package's), both packages' streamed fits:
        JAX's ``"pallas"`` runs its kernel in interpret mode."""
        kw = dict(rank=8, iterations=2, reg=0.01, seed=1, buckets=2,
                  implicit=implicit, alpha=5.0, dtype=dtype, solver=solver)
        want_store, _ = _both_stores(synthetic, str(tmp_path), block_rows=32)
        want = jax_als.als_fit_streamed(want_store, jax_als.ALSConfig(**kw), local_mesh(1, 1))
        got = als_fit_streamed(load_streamed_als_data(want_store.directory),
                               ALSConfig(**kw), "cpu")
        np.testing.assert_allclose(got.user_factors, want.user_factors, atol=JAX_ATOL[dtype])
        np.testing.assert_allclose(got.item_factors, want.item_factors, atol=JAX_ATOL[dtype])

    def test_uniform_value_elision_bit_identical(self, synthetic):
        """All-ones implicit data: the value stream never ships (blocks
        record a const, made on the device with ``torch.full``) and the
        factors are still bit-identical."""
        cfg = ALSConfig(rank=8, iterations=2, reg=0.01, seed=1, buckets=2,
                        implicit=True, alpha=5.0)
        ones = np.ones(len(synthetic[2]), np.float32)
        resident, streamed, _, specs = _fit_both(synthetic, cfg, values=ones)
        assert all(c == 1.0 for _, _, c in specs["by_row"])
        _assert_bit_identical(resident, streamed)

    def test_sub_bucket_blocks_bit_identical(self, synthetic):
        """A bucket cut into smaller blocks (a ragged last block among
        them) changes only the solve's batch sizes: on the CPU each row's
        products and solve do not depend on them."""
        cfg = ALSConfig(rank=8, iterations=3, reg=0.01, seed=1, buckets=2)
        resident, streamed, _, specs = _fit_both(synthetic, cfg, block_rows=32)
        assert len({r for r, _, _ in specs["by_row"]}) > 1
        _assert_bit_identical(resident, streamed)

    def test_all_padding_blocks(self, synthetic):
        """Entities beyond the interacting ones make whole blocks of
        padding rows, solved to the resident result (zeros for the
        explicit ridge) without a value file."""
        n_u, n_i, uu, ii, rr, tt = synthetic
        wide = (n_u + 250, n_i, uu, ii, rr, tt)
        cfg = ALSConfig(rank=8, iterations=2, reg=0.01, seed=1)
        resident, streamed, _, specs = _fit_both(wide, cfg, block_rows=64)
        assert [s for s in specs["by_row"] if s[2] == 0.0]
        _assert_bit_identical(resident, streamed)
        never = np.setdiff1d(np.arange(n_u + 250), uu)
        assert np.all(streamed.user_factors[never] == 0.0)


class TestBlockStore:
    def test_packed_blocks_match_resident_layout(self, synthetic):
        n_u, n_i, uu, ii, rr, tt = synthetic
        cfg = ALSConfig(rank=8, iterations=1, reg=0.01, seed=1, buckets=2)
        data = build_als_data(uu, ii, rr, n_u, n_i, cfg, times=tt)
        with tempfile.TemporaryDirectory() as td:
            sd = build_streamed_als_data(array_coo_chunks(uu, ii, rr, times=tt), n_u, n_i,
                                         cfg, td, block_rows=1 << 20)
            for side_name in ("by_row", "by_col"):
                side, resident_side = getattr(sd, side_name), getattr(data, side_name)
                np.testing.assert_array_equal(side.slot_of, resident_side.slot_of)
                assert side.total_slots == resident_side.total_slots
                for spec, block in zip(side.specs, resident_side.blocks):
                    idx, val, nobs = side.load_block(spec)
                    np.testing.assert_array_equal(idx, block.indices)
                    np.testing.assert_array_equal(val, block.values)
                    np.testing.assert_array_equal(nobs, block.mask.sum(axis=1))
            assert sd.real_edges == len(uu) == als.real_edges(sd) == als.real_edges(data)
            assert als.modeled_bytes_per_iteration(sd, 8, 4, True) == (
                als.modeled_bytes_per_iteration(data, 8, 4, True))

    def test_cache_reuse_skips_rebuild(self, synthetic):
        n_u, n_i, uu, ii, rr, tt = synthetic
        cfg = ALSConfig(rank=8, iterations=1, reg=0.01, seed=1)
        chunks = array_coo_chunks(uu, ii, rr, times=tt)
        with tempfile.TemporaryDirectory() as td:
            first = build_streamed_als_data(chunks, n_u, n_i, cfg, td)
            manifest = os.path.join(first.directory, "manifest.json")
            stamp = os.path.getmtime(manifest)
            again = build_streamed_als_data(chunks, n_u, n_i, cfg, td)
            assert again.directory == first.directory
            assert os.path.getmtime(manifest) == stamp
            other = build_streamed_als_data(chunks, n_u, n_i, cfg, td, block_rows=64)
            assert other.directory != first.directory
            # values, times and endpoints are in the key, not only the counts
            perm = np.random.default_rng(9).permutation(len(ii))
            for changed in (array_coo_chunks(uu, ii, rr * 2.0, times=tt),
                            array_coo_chunks(uu, ii, rr, times=tt[::-1].copy()),
                            array_coo_chunks(uu, ii[perm], rr, times=tt)):
                assert build_streamed_als_data(changed, n_u, n_i, cfg, td).directory != (
                    first.directory)

    def test_torn_store_rejected(self, synthetic):
        n_u, n_i, uu, ii, rr, tt = synthetic
        cfg = ALSConfig(rank=8, iterations=1, reg=0.01, seed=1)
        chunks = array_coo_chunks(uu, ii, rr, times=tt)
        with tempfile.TemporaryDirectory() as td:
            sd = build_streamed_als_data(chunks, n_u, n_i, cfg, td)
            spec = sd.by_row.specs[0]
            with open(sd.by_row._path(spec, "idx"), "ab") as f:
                f.truncate(spec.idx_bytes() - 4)
            assert load_streamed_als_data(sd.directory) is None
            rebuilt = build_streamed_als_data(chunks, n_u, n_i, cfg, td)
            assert load_streamed_als_data(rebuilt.directory) is not None

    def test_foreign_indices_refused_before_any_launch(self, synthetic, monkeypatch):
        """A block whose sizes pass the manifest checks but whose indices
        point past the opposite side's table (B1 does not bounds-check)
        is refused on the host, before the half-step runs."""
        n_u, n_i, uu, ii, rr, tt = synthetic
        cfg = ALSConfig(rank=8, iterations=1, reg=0.01, seed=1)
        with tempfile.TemporaryDirectory() as td:
            sd = build_streamed_als_data(array_coo_chunks(uu, ii, rr, times=tt), n_u, n_i,
                                         cfg, td)
            spec = sd.by_col.specs[0]
            idx = np.fromfile(sd.by_col._path(spec, "idx"), np.int32)
            idx[3] = sd.by_row.total_slots + 1
            idx.tofile(sd.by_col._path(spec, "idx"))
            loaded = load_streamed_als_data(sd.directory)
            assert loaded is not None  # the sizes still match
            calls, real = [], als.gram_rhs
            monkeypatch.setattr(als, "gram_rhs",
                                lambda *a, **k: (calls.append(1), real(*a, **k))[1])
            with pytest.raises(ValueError, match="foreign block store"):
                als_fit_streamed(loaded, dataclasses.replace(cfg, solver="pallas"), "cpu")
            # the user side's blocks ran; the item side's bad block did not
            assert len(calls) == len(loaded.by_row.specs)


class TestFeederResidency:
    def test_at_most_two_blocks_in_flight(self, synthetic):
        cfg = ALSConfig(rank=8, iterations=2, reg=0.01, seed=1)
        stats = StreamStats()
        _fit_both(synthetic, cfg, block_rows=16, stats=stats)
        assert stats.max_inflight_blocks <= 2
        assert stats.blocks_streamed > 8

    def test_peak_host_memory_is_block_bounded(self):
        """tracemalloc (numpy buffers, not torch's allocator) shows the
        feeder holding O(block), not O(edges)."""
        rng = np.random.default_rng(7)
        n_u, n_i, n_e = 8192, 512, 800_000
        uu = rng.integers(0, n_u, n_e)
        ii = rng.integers(0, n_i, n_e)
        vv = rng.random(n_e).astype(np.float32)  # mixed: no const elision
        cfg = ALSConfig(rank=8, iterations=2, reg=0.01, seed=1, implicit=True, max_len=128)
        with tempfile.TemporaryDirectory() as td:
            sd = build_streamed_als_data(array_coo_chunks(uu, ii, vv), n_u, n_i, cfg, td,
                                         block_rows=384)
            sizes = [s.idx_bytes() + s.val_bytes() + s.nobs_bytes()
                     for side in (sd.by_row, sd.by_col) for s in side.specs]
            block_bytes, total_bytes = max(sizes), sum(sizes)
            assert total_bytes > 12 * block_bytes
            als_fit_streamed(sd, cfg, "cpu")  # first calls' one-time allocations
            tracemalloc.start()
            try:
                als_fit_streamed(sd, cfg, "cpu")
                _, peak = tracemalloc.get_traced_memory()
            finally:
                tracemalloc.stop()
        factor_bytes = (sd.by_row.total_slots + sd.by_col.total_slots) * 8 * 8
        budget = 3 * block_bytes + 3 * factor_bytes + 1024 * 1024
        assert budget < total_bytes // 2
        assert peak < budget, f"peak {peak} vs block {block_bytes}, store {total_bytes}"


class TestTransferAccounting:
    def test_measured_matches_model_and_beats_reship(self, synthetic):
        n_u, n_i, uu, ii, _rr, _tt = synthetic
        cfg = ALSConfig(rank=8, iterations=3, reg=0.01, seed=1, implicit=True, alpha=5.0)
        ones = np.ones(len(uu), np.float32)
        stats = StreamStats()
        with tempfile.TemporaryDirectory() as td:
            sd = build_streamed_als_data(array_coo_chunks(uu, ii, ones), n_u, n_i, cfg, td,
                                         block_rows=64)
            als_fit_streamed(sd, cfg, "cpu", stats=stats)
            modeled = stream_bytes_per_half_step(sd, implicit=True)
            reship = reship_bytes_per_half_step(sd, cfg.rank, 4)
        assert stats.half_steps == 2 * cfg.iterations
        assert stats.bytes_per_half_step == pytest.approx(modeled)
        assert stats.bytes_per_half_step <= reship / 3.0
        assert stats.h2d_scalar_bytes < 0.01 * stats.h2d_block_bytes + 4096

    @pytest.mark.parametrize("implicit", [False, True])
    def test_explicit_ships_nobs_and_matches_the_model(self, synthetic, implicit):
        cfg = ALSConfig(rank=8, iterations=2, reg=0.01, seed=1, implicit=implicit)
        stats = StreamStats()
        n_u, n_i, uu, ii, rr, tt = synthetic
        with tempfile.TemporaryDirectory() as td:
            sd = build_streamed_als_data(array_coo_chunks(uu, ii, rr, times=tt), n_u, n_i,
                                         cfg, td, block_rows=32)
            als_fit_streamed(sd, cfg, "cpu", stats=stats)
            assert stats.bytes_per_half_step == pytest.approx(
                stream_bytes_per_half_step(sd, implicit=implicit))

    def test_device_budget_pins_blocks(self, synthetic):
        cfg = ALSConfig(rank=8, iterations=4, reg=0.01, seed=1)
        pinned_stats = StreamStats()
        _, pinned_model, _, _ = _fit_both(synthetic, cfg, block_rows=64, stats=pinned_stats,
                                          budget=1 << 30)
        nblocks = pinned_stats.blocks_streamed
        assert pinned_stats.pinned_bytes == pinned_stats.h2d_block_bytes
        assert pinned_stats.blocks_pinned == nblocks * (cfg.iterations - 1)
        streamed_stats = StreamStats()
        _, streamed_model, _, _ = _fit_both(synthetic, cfg, block_rows=64,
                                            stats=streamed_stats)
        assert streamed_stats.blocks_pinned == 0
        assert pinned_stats.h2d_block_bytes * cfg.iterations == pytest.approx(
            streamed_stats.h2d_block_bytes)
        _assert_bit_identical(pinned_model, streamed_model)


class TestStreamedEpochEndToEnd:
    def test_streamed_epoch_converges(self):
        rng = np.random.default_rng(3)
        n_u, n_i, k = 300, 120, 8
        U = rng.normal(size=(n_u, k)) / np.sqrt(k)
        V = rng.normal(size=(n_i, k)) / np.sqrt(k)
        mask = rng.random((n_u, n_i)) < 0.2
        uu, ii = np.nonzero(mask)
        rr = (np.sum(U[uu] * V[ii], axis=1) + 0.01 * rng.normal(size=len(uu))
              ).astype(np.float32)
        cfg = ALSConfig(rank=8, iterations=6, reg=0.01, seed=1, buckets=2)
        with tempfile.TemporaryDirectory() as td:
            sd = build_streamed_als_data(array_coo_chunks(uu, ii, rr, chunk_rows=4096),
                                         n_u, n_i, cfg, td, block_rows=128)
            model = als_fit_streamed(sd, cfg, "cpu")
        pred = np.sum(model.user_factors[uu] * model.item_factors[ii], axis=1)
        assert np.sqrt(np.mean((pred - rr) ** 2)) < 0.05

    def test_callback_init_and_validation(self, synthetic, monkeypatch):
        n_u, n_i, uu, ii, rr, tt = synthetic
        cfg = ALSConfig(rank=8, iterations=3, reg=0.01, seed=1)
        seen = []
        with tempfile.TemporaryDirectory() as td:
            sd = build_streamed_als_data(array_coo_chunks(uu, ii, rr, times=tt), n_u, n_i,
                                         cfg, td)
            full = als_fit_streamed(sd, cfg, "cpu",
                                    callback=lambda it, u, i: seen.append((it, u, i)))
            assert [(it, u.shape) for it, u, _ in seen] == [(0, (n_u, 8)), (1, (n_u, 8))]
            # resuming from iteration 0's factors equals the uninterrupted run
            resumed = als_fit_streamed(sd, cfg, "cpu", init=(seen[0][1], seen[0][2]),
                                       start_iteration=1)
            _assert_bit_identical(full, resumed)
            steps = []

            class Telemetry:
                def record_step(self, it, seconds):
                    steps.append(it)

            als_fit_streamed(sd, cfg, "cpu", telemetry=Telemetry())
            assert steps == [0, 1, 2]
            # a forged 10-row block cannot tile the 8-row layout
            bad_spec = dataclasses.replace(sd.by_row.specs[0], rows=10)
            bad = dataclasses.replace(
                sd, by_row=dataclasses.replace(sd.by_row, specs=[bad_spec] + sd.by_row.specs[1:]))
            with pytest.raises(ValueError, match="data axis"):
                als_fit_streamed(bad, cfg, "cpu")
            with pytest.raises(ValueError, match="dtype"):
                als_fit_streamed(sd, dataclasses.replace(cfg, dtype="int8"), "cpu")
            # the 1 x 1 mesh's model-sharded streamed fit is the replicated
            # one bit for bit (several ranks: tests/test_torch_als_sharded.py)
            model = als_fit_streamed(sd, dataclasses.replace(cfg, factor_sharding="model"),
                                     "cpu")
            _assert_bit_identical(full, model)
            one = local_mesh_torch(device="cpu")
            _assert_bit_identical(full, als_fit_streamed(sd, cfg, mesh=one))
            with pytest.raises(ValueError, match="factor_sharding"):
                als_fit_streamed(sd, dataclasses.replace(cfg, factor_sharding="rows"), "cpu")

    def test_default_device_without_cuda_raises(self, synthetic, monkeypatch):
        n_u, n_i, uu, ii, rr, tt = synthetic
        cfg = ALSConfig(rank=8, iterations=1)
        with tempfile.TemporaryDirectory() as td:
            sd = build_streamed_als_data(array_coo_chunks(uu, ii, rr), n_u, n_i, cfg, td)
            monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                als_fit_streamed(sd, cfg)


@pytest.mark.cuda
def test_card_streamed_equals_resident():
    """On the card: a streamed fit through B1 (pinned staging, the copy
    stream) is within 1e-4 of the resident one, in buckets and in smaller
    blocks, and a device budget pins every block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from predictionio_tpu_torch.ops import als_gram

    rng = np.random.default_rng(5)
    n_u, n_i, n_e = 5000, 1200, 200_000
    uu, ii = rng.integers(0, n_u, n_e), rng.integers(0, n_i, n_e)
    rr = rng.integers(1, 6, n_e).astype(np.float32)
    for implicit in (False, True):
        cfg = ALSConfig(rank=16, iterations=3, reg=0.05, seed=2, implicit=implicit, buckets=2)
        resident = als_fit(build_als_data(uu, ii, rr, n_u, n_i, cfg), cfg, "cuda")
        with tempfile.TemporaryDirectory() as td:
            for block_rows, budget in ((None, 0), (256, 0), (256, 1 << 40)):
                sd = build_streamed_als_data(array_coo_chunks(uu, ii, rr), n_u, n_i, cfg, td,
                                             block_rows=block_rows)
                stats = StreamStats()
                before = als_gram.gram_rhs.launches
                got = als_fit_streamed(sd, cfg, "cuda", stats=stats, device_budget_bytes=budget)
                blocks = len(sd.by_row.specs) + len(sd.by_col.specs)
                assert als_gram.gram_rhs.launches - before == blocks * cfg.iterations
                assert stats.max_inflight_blocks <= 2
                np.testing.assert_allclose(got.user_factors, resident.user_factors, atol=1e-4)
                np.testing.assert_allclose(got.item_factors, resident.item_factors, atol=1e-4)
                if budget:
                    assert stats.blocks_pinned == blocks * (cfg.iterations - 1)
