"""The port's ALS (``parallel/als``, ``ops/linalg``, ``online/foldin``)
against the JAX package on the CPU.

Packing is numpy on both sides and must be byte-identical. The fits run
the same arithmetic in another framework, so they are held to the
reference's own solver-parity bars (``tests/test_als_gram.py:198``):
``atol`` 1e-4 for f32 factors and 5e-3 for bf16, whose stored factors
round once per iteration.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.online import foldin as jax_foldin
from predictionio_tpu.ops.linalg import batched_spd_solve as jax_solve
from predictionio_tpu.parallel import als as jax_als
from predictionio_tpu_torch.online import foldin
from predictionio_tpu_torch.ops.linalg import batched_spd_solve
from predictionio_tpu_torch.parallel import als


@pytest.fixture(scope="module")
def synthetic():
    """The reference's solver-parity data: low-rank ratings plus noise."""
    rng = np.random.default_rng(7)
    n_u, n_i, k = 120, 72, 6
    U = rng.normal(size=(n_u, k)) / np.sqrt(k)
    V = rng.normal(size=(n_i, k)) / np.sqrt(k)
    mask = rng.random((n_u, n_i)) < 0.2
    uu, ii = np.nonzero(mask)
    rr = (
        np.sum(U[uu] * V[ii], axis=1) + 0.01 * rng.normal(size=len(uu))
    ).astype(np.float32)
    return n_u, n_i, uu, ii, rr


@pytest.fixture(scope="module")
def skewed():
    """Zipf-like item popularity (the recipe of the bench's stand-in for
    MovieLens), with times, so the cap truncates and buckets differ."""
    rng = np.random.default_rng(11)
    n_u, n_i, n = 300, 200, 6000
    users = rng.integers(0, n_u, n)
    items = (np.minimum(rng.random(n) ** 2.2, 0.999999) * n_i).astype(np.int64)
    ratings = rng.integers(1, 6, n).astype(np.float32)
    times = rng.random(n) * 1e6
    return n_u, n_i, users, items, ratings, times


def _assert_sides_equal(j_side, t_side):
    assert np.array_equal(j_side.slot_of, t_side.slot_of)
    assert (j_side.num_rows, j_side.total_slots) == (t_side.num_rows, t_side.total_slots)
    assert len(j_side.blocks) == len(t_side.blocks)
    for jb, tb in zip(j_side.blocks, t_side.blocks):
        for name in ("indices", "values", "mask"):
            a, b = getattr(jb, name), getattr(tb, name)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes(), name
        assert (jb.num_rows, jb.num_cols, jb.truncated) == (
            tb.num_rows, tb.num_cols, tb.truncated
        )


@pytest.mark.parametrize("buckets", [1, 3])
def test_build_als_data_is_byte_identical(skewed, buckets):
    n_u, n_i, users, items, ratings, times = skewed
    kw = dict(rank=8, max_len=24, buckets=buckets)
    j = jax_als.build_als_data(
        users, items, ratings, n_u, n_i, jax_als.ALSConfig(**kw), times=times
    )
    t = als.build_als_data(
        users, items, ratings, n_u, n_i, als.ALSConfig(**kw), times=times
    )
    assert t.by_row.truncated > 0 or t.by_col.truncated > 0
    _assert_sides_equal(j.by_row, t.by_row)
    _assert_sides_equal(j.by_col, t.by_col)
    for side_j, side_t, seed in ((j.by_row, t.by_row, 3), (j.by_col, t.by_col, 4)):
        a = jax_als._initial_side_factors(side_j, 8, seed)
        b = als._initial_side_factors(side_t, 8, seed)
        assert a.tobytes() == b.tobytes()
    assert als.real_edges(t) == jax_als.real_edges(j)
    for fused in (True, False):
        assert als.modeled_bytes_per_iteration(t, 8, 4, fused) == (
            jax_als.modeled_bytes_per_iteration(j, 8, 4, fused)
        )


@pytest.mark.parametrize("times_kind", ["random", "ties", "two_sorted_runs", "none"])
@pytest.mark.parametrize("max_len", [None, 5])
def test_pack_padded_csr_is_byte_identical(times_kind, max_len):
    """The port orders entries by two stable sorts where the reference
    calls ``np.lexsort``: the packed arrays are the same bytes, with ties
    in the times (input order decides), a log of two presorted runs (as
    a view log followed by a buy log) and no times."""
    from predictionio_tpu.ops.ragged import pack_padded_csr as jax_pack
    from predictionio_tpu_torch.ops.ragged import pack_padded_csr

    rng = np.random.default_rng(5)
    n_u, n_i, n = 70, 40, 3000
    users = rng.integers(0, n_u, n)
    items = rng.integers(0, n_i, n)
    vals = rng.random(n).astype(np.float32)
    times = {
        "random": rng.random(n) * 1e6,
        "ties": rng.integers(0, 20, n).astype(np.float64),
        "two_sorted_runs": np.concatenate([np.arange(2000.0), np.sort(rng.random(1000)) * 2000]),
        "none": None,
    }[times_kind]
    a = jax_pack(users, items, vals, n_u, n_i, max_len=max_len, times=times)
    b = pack_padded_csr(users, items, vals, n_u, n_i, max_len=max_len, times=times)
    for name in ("indices", "values", "mask"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), name
    assert (a.num_rows, a.num_cols, a.truncated) == (b.num_rows, b.num_cols, b.truncated)
    assert max_len is None or b.truncated > 0


def test_batched_spd_solve_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(50, 8, 8)).astype(np.float32)
    gram = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(8, dtype=np.float32)
    gram[3] = 0.0  # an entity with no interactions: the jitter carries it
    rhs = rng.normal(size=(50, 8)).astype(np.float32)
    rhs[3] = 0.0
    got = batched_spd_solve(torch.from_numpy(gram), torch.from_numpy(rhs)).numpy()
    want = np.asarray(jax_solve(jnp.asarray(gram), jnp.asarray(rhs), unroll=False))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert np.abs(got[3]).max() == 0.0


def _fit_both(data_args, implicit, dtype, **extra):
    n_u, n_i, uu, ii, vals = data_args
    kw = dict(rank=6, iterations=2, reg=0.01, seed=1, implicit=implicit,
              alpha=10.0, dtype=dtype, **extra)
    j_cfg, t_cfg = jax_als.ALSConfig(**kw), als.ALSConfig(**kw)
    j = jax_als.als_fit(jax_als.build_als_data(uu, ii, vals, n_u, n_i, j_cfg), j_cfg)
    t = als.als_fit(
        als.build_als_data(uu, ii, vals, n_u, n_i, t_cfg), t_cfg, device="cpu"
    )
    return j, t


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_als_fit_matches_jax(synthetic, implicit, dtype):
    n_u, n_i, uu, ii, rr = synthetic
    vals = np.ones(len(uu), np.float32) if implicit else rr
    j, t = _fit_both((n_u, n_i, uu, ii, vals), implicit, dtype)
    atol = 1e-4 if dtype == "float32" else 5e-3
    assert t.user_factors.dtype == np.float32
    np.testing.assert_allclose(t.user_factors, j.user_factors, atol=atol)
    np.testing.assert_allclose(t.item_factors, j.item_factors, atol=atol)


@pytest.mark.parametrize("implicit", [False, True])
def test_bucketed_fit_matches_jax(synthetic, implicit):
    n_u, n_i, uu, ii, rr = synthetic
    vals = np.ones(len(uu), np.float32) if implicit else rr
    j, t = _fit_both((n_u, n_i, uu, ii, vals), implicit, "float32", buckets=3)
    np.testing.assert_allclose(t.user_factors, j.user_factors, atol=1e-4)
    np.testing.assert_allclose(t.item_factors, j.item_factors, atol=1e-4)


def test_every_solver_is_the_plain_version_on_cpu(synthetic):
    """On the CPU "auto", "pallas" and "xla" all compute through the
    plain version: the three fits are identical."""
    n_u, n_i, uu, ii, rr = synthetic
    fits = []
    for solver in ("auto", "pallas", "xla"):
        cfg = als.ALSConfig(rank=6, iterations=2, reg=0.01, seed=1, solver=solver)
        data = als.build_als_data(uu, ii, rr, n_u, n_i, cfg)
        fits.append(als.als_fit(data, cfg, device="cpu"))
    for other in fits[1:]:
        assert np.array_equal(other.user_factors, fits[0].user_factors)
        assert np.array_equal(other.item_factors, fits[0].item_factors)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resumed_fit_equals_uninterrupted(synthetic, dtype):
    """Factors handed to the callback after iteration k, fed back as
    ``init`` with ``start_iteration=k+1``, finish as the whole run does."""
    n_u, n_i, uu, ii, rr = synthetic
    cfg = als.ALSConfig(rank=6, iterations=4, reg=0.01, seed=1, dtype=dtype, buckets=2)
    data = als.build_als_data(uu, ii, rr, n_u, n_i, cfg)
    seen = {}
    whole = als.als_fit(
        data, cfg, device="cpu",
        callback=lambda it, u, v: seen.setdefault(it, (u, v)), callback_interval=2,
    )
    assert sorted(seen) == [1]  # iteration 3 is the last: no callback
    resumed = als.als_fit(data, cfg, device="cpu", init=seen[1], start_iteration=2)
    assert np.array_equal(resumed.user_factors, whole.user_factors)
    assert np.array_equal(resumed.item_factors, whole.item_factors)


def test_telemetry_gets_every_iteration(synthetic):
    n_u, n_i, uu, ii, rr = synthetic
    cfg = als.ALSConfig(rank=6, iterations=3, seed=1)
    steps = []

    class Recorder:
        def record_step(self, it, seconds):
            steps.append((it, seconds))

    als.als_fit(als.build_als_data(uu, ii, rr, n_u, n_i, cfg), cfg,
                device="cpu", telemetry=Recorder())
    assert [it for it, _ in steps] == [0, 1, 2]
    assert all(s > 0 for _, s in steps)


def test_als_fit_refuses_what_it_does_not_do(synthetic):
    """``factor_sharding="model"`` without a mesh is the 1 x 1 mesh's
    model-sharded fit: the replicated fit bit for bit, and JAX's
    model-sharded fit on ``local_mesh(1, 1)`` within the f32 bar (the
    multi-rank cases: ``tests/test_torch_als_sharded.py``). A bad dtype,
    solver or sharding still raises."""
    from predictionio_tpu.parallel.mesh import local_mesh

    n_u, n_i, uu, ii, rr = synthetic
    data = als.build_als_data(uu, ii, rr, n_u, n_i, als.ALSConfig(rank=6))
    kw = dict(rank=6, iterations=2, reg=0.01, seed=1)
    model = als.als_fit(data, als.ALSConfig(factor_sharding="model", **kw), device="cpu")
    plain = als.als_fit(data, als.ALSConfig(**kw), device="cpu")
    np.testing.assert_array_equal(model.user_factors, plain.user_factors)
    np.testing.assert_array_equal(model.item_factors, plain.item_factors)
    j_cfg = jax_als.ALSConfig(factor_sharding="model", **kw)
    want = jax_als.als_fit(jax_als.build_als_data(uu, ii, rr, n_u, n_i, j_cfg), j_cfg,
                           local_mesh(1, 1))
    np.testing.assert_allclose(model.user_factors, want.user_factors, atol=1e-4)
    np.testing.assert_allclose(model.item_factors, want.item_factors, atol=1e-4)
    with pytest.raises(ValueError, match="factor_sharding"):
        als.als_fit(data, als.ALSConfig(rank=6, factor_sharding="rows"), device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        als.als_fit(data, als.ALSConfig(rank=6, dtype="int8"), device="cpu")
    with pytest.raises(ValueError, match="solver"):
        als.als_fit(data, als.ALSConfig(rank=6, solver="mosaic"), device="cpu")


@pytest.mark.parametrize("implicit", [False, True])
def test_fold_in_users_matches_jax(synthetic, implicit):
    n_u, n_i, uu, ii, rr = synthetic
    rng = np.random.default_rng(9)
    item_factors = (rng.normal(size=(n_i, 6)) / np.sqrt(6)).astype(np.float32)
    # 20 users' full histories, re-indexed into local rows
    picked = np.flatnonzero(np.isin(uu, np.arange(0, n_u, 6)))
    rows = uu[picked] // 6
    cols, vals = ii[picked], rr[picked]
    times = rng.random(picked.size)
    kw = dict(rank=6, reg=0.05, alpha=10.0, implicit=implicit, max_len=8)
    got = foldin.fold_in_users(
        item_factors, rows, cols, vals, 20, als.ALSConfig(**kw),
        times=times, device="cpu",
    )
    want = jax_foldin.fold_in_users(
        item_factors, rows, cols, vals, 20, jax_als.ALSConfig(**kw), times=times
    )
    assert got.shape == (20, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)
    # the frozen table is cached on the device by identity
    assert foldin._device_factors(item_factors, torch.device("cpu")) is (
        foldin._device_factors(item_factors, torch.device("cpu"))
    )
