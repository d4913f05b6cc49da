"""The port's cooccurrence and LLR ops against the JAX package's, on the CPU.

The same seeded interactions go through ``predictionio_tpu.ops.
cooccurrence`` (its own CPU path, as ``tests/test_similarity_templates.py``
runs it) and ``predictionio_tpu_torch.ops.cooccurrence`` with
``device="cpu"``. Counts sum 0/1 products, so they must be EQUAL, self
and cross, whatever the chunking. LLR values are held at rtol = atol =
1e-5 (the port evaluates the reference's own f32 log, XLA's polynomial,
so on the CPU they agree bit for bit; ``torch.log`` would not: the LLR's
cancelling sums grow its ulp differences past 1e-4); the indicators'
values likewise, and their indices equal except where two values lie
within that tolerance of each other; exact ties rank the lower index
first, as ``jax.lax.top_k`` does. ``distinct_user_counts`` and ``top_k_sparsify``
are copies and must return identical arrays. A ``cuda``-marked test
holds the card to the CPU at a few thousand users.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import cooccurrence as jax_cooc
from predictionio_tpu.ops.ragged import pack_padded_csr as jax_pack
from predictionio_tpu_torch.ops import cooccurrence as cooc
from predictionio_tpu_torch.ops.ragged import pack_padded_csr

TOL = 1e-5


def interactions(seed: int, users: int, items: int, density: float,
                 duplicates: int = 0):
    """Seeded (users, items) pairs of a random binary matrix, plus
    ``duplicates`` repeated pairs (a user's repeat counts once)."""
    rng = np.random.default_rng(seed)
    u, i = np.nonzero(rng.random((users, items)) < density)
    if duplicates:
        pick = rng.integers(0, u.size, duplicates)
        u, i = np.concatenate([u, u[pick]]), np.concatenate([i, i[pick]])
    return u, i


def both_csrs(u, i, users: int, items: int, max_len=None):
    """The same interactions packed by each package."""
    args = (u, i, np.ones(u.size, np.float32), users, items)
    return jax_pack(*args, max_len=max_len), pack_padded_csr(*args, max_len=max_len)


def pair(seed=5, users=61, items=13, density=0.3, other_density=0.25):
    """(jax primary, port primary, jax other, port other) over one user
    universe; the other type has a different catalog size."""
    ja, ta = both_csrs(*interactions(seed, users, items, density, duplicates=7),
                       users, items)
    jb, tb = both_csrs(*interactions(seed + 1, users, items + 4, other_density),
                       users, items + 4)
    return ja, ta, jb, tb


def assert_same_indicators(got, want, tol=TOL):
    """Per row, values within ``tol`` position by position; an index may
    differ from the reference's only at a near-tie: its value lies
    within ``tol`` of another value of the row, or of the row's k-th."""
    (gi, gv), (wi, wv) = got, want
    assert gi.shape == wi.shape and gi.dtype == np.int32 and gv.dtype == np.float32
    np.testing.assert_allclose(gv, wv, rtol=tol, atol=tol)
    for r, c in zip(*np.nonzero(gi != wi)):
        v = wv[r, c]
        others = np.delete(wv[r], c)
        assert np.any(np.abs(others - v) <= tol + tol * abs(v)), (r, c, gi[r], wi[r], wv[r])
    # the index sets agree up to entries at the k-th value
    for r in range(gi.shape[0]):
        kth = wv[r, -1]
        for idx, vals, ref in ((gi[r], gv[r], set(wi[r])), (wi[r], wv[r], set(gi[r]))):
            for j, v in zip(idx, vals):
                assert j in ref or abs(v - kth) <= tol + tol * abs(kth), (r, j)


def assert_ties_lower_index_first(idx, vals):
    for r in range(idx.shape[0]):
        for c in range(1, idx.shape[1]):
            if vals[r, c] == vals[r, c - 1]:
                assert idx[r, c] > idx[r, c - 1], (r, idx[r], vals[r])


@pytest.mark.parametrize("chunk", [16, 7, 4096])
@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_counts_equal_the_reference(chunk, cross):
    """Self and cross counts, with duplicate pairs, a user count (61, 64
    physical rows) that no chunk but the whole divides, exactly equal."""
    ja, ta, jb, tb = pair()
    want = jax_cooc.cooccurrence(ja, jb if cross else None, chunk=chunk)
    got = cooc.cooccurrence(ta, tb if cross else None, chunk=chunk, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # and equal to the dense binarized product
    dense_a = np.zeros((61, 13), np.float32)
    dense_a[interactions(5, 61, 13, 0.3, duplicates=7)] = 1.0
    if not cross:
        np.testing.assert_array_equal(got, dense_a.T @ dense_a)


def test_counts_tensor_stays_on_the_device():
    _, ta, _, tb = pair()
    counts = cooc.cooccurrence_counts(ta, tb, chunk=9, device="cpu")
    assert isinstance(counts, torch.Tensor) and counts.dtype == torch.float32
    assert tuple(counts.shape) == (13, 17)
    np.testing.assert_array_equal(counts.numpy(), cooc.cooccurrence(ta, tb, device="cpu"))


def test_llr_scores_match_the_reference():
    ja, ta, jb, _ = pair(users=120, items=20)
    counts = jax_cooc.cooccurrence(ja, jb)
    rows = jax_cooc.distinct_user_counts(ja)
    cols = jax_cooc.distinct_user_counts(jb)
    want = jax_cooc.llr_scores(counts, rows, cols, total=120)
    got = cooc.llr_scores(counts, rows, cols, total=120, device="cpu")
    assert got.dtype == np.float32 and (want > 0).sum() > 50
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the reference's own example: a perfectly correlated pair beats a
    # popular item, which scores 0
    llr = cooc.llr_scores(np.array([[4.0, 4.0, 4.0]]), np.array([4.0]),
                          np.array([4.0, 4.0, 100.0]), total=100, device="cpu")
    assert llr[0, 1] > llr[0, 2] and llr[0, 2] == pytest.approx(0.0, abs=1e-3)


@pytest.mark.parametrize("total", [5_000, 138_000])
def test_llr_scores_match_the_reference_at_a_full_user_count(total):
    """At the training stand-in's user count the LLR cancels terms near
    N ln N (1.6e6 at 138,000): the port's log must be the reference's
    for the 1e-5 bar to hold."""
    rng = np.random.default_rng(total)
    rows = rng.integers(1, total // 4, 40).astype(np.float32)
    cols = rng.integers(1, total // 4, 60).astype(np.float32)
    counts = np.minimum(rng.integers(0, 2_000, (40, 60)),
                        np.minimum(rows[:, None], cols[None, :])).astype(np.float32)
    want = jax_cooc.llr_scores(counts, rows, cols, total=total)
    got = cooc.llr_scores(counts, rows, cols, total=total, device="cpu")
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert got.max() > 100


@pytest.mark.parametrize("llr", [True, False], ids=["llr", "counts"])
@pytest.mark.parametrize("cross,drop_diagonal", [
    (False, None), (False, True), (False, False), (True, None), (True, False)])
def test_indicators_match_the_reference(llr, drop_diagonal, cross):
    """Self and cross, the diagonal dropped by default, on request or
    not (a cross product cannot drop it: its error is tested below)."""
    ja, ta, jb, tb = pair(seed=9, users=90, items=24)
    kw = dict(top_k=6, chunk=16, drop_diagonal=drop_diagonal)
    jkw, tkw = dict(kw), dict(kw, device="cpu")
    if llr:
        rows = jax_cooc.distinct_user_counts(ja)
        cols = jax_cooc.distinct_user_counts(jb if cross else ja)
        for d in (jkw, tkw):
            d.update(llr_row_totals=rows, llr_col_totals=cols, total=90)
    want = jax_cooc.cooccurrence_indicators(ja, jb if cross else None, **jkw)
    got = cooc.cooccurrence_indicators(ta, tb if cross else None, **tkw)
    assert_same_indicators(got, want)
    assert_ties_lower_index_first(*got)
    if not llr:  # integer counts: bit-equal values, so index-identical
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    if drop_diagonal is not False and not cross:
        assert not np.any(got[0] == np.arange(24)[:, None])


def test_exact_ties_rank_the_lower_index_first():
    """Four items every user holds (every count ties) and a top-k that
    cuts through the tie: the reference's lower-index-first order."""
    users, items = 10, 9
    u = np.repeat(np.arange(users), items)
    i = np.tile(np.arange(items), users)
    keep = (i < 4) | (u % 3 == i % 3)
    ja, ta = both_csrs(u[keep], i[keep], users, items)
    for llr in (False, True):
        kw = dict(top_k=3, chunk=4)
        if llr:
            t = jax_cooc.distinct_user_counts(ja)
            kw.update(llr_row_totals=t, llr_col_totals=t, total=users)
        want = jax_cooc.cooccurrence_indicators(ja, **kw)
        got = cooc.cooccurrence_indicators(ta, device="cpu", **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=TOL, atol=TOL)
        assert_ties_lower_index_first(*got)


def test_blocked_rows_equal_one_block():
    """The LLR, diagonal drop and top-k over row blocks give what one
    block gives."""
    _, ta, _, _ = pair(seed=2, users=70, items=31)
    counts = cooc.cooccurrence_counts(ta, device="cpu")
    totals = torch.tensor(cooc.distinct_user_counts(ta))
    kw = dict(row_totals=totals, col_totals=totals, total=70.0, drop_diagonal=True)
    whole = cooc.indicators_from_counts(counts, 5, block_rows=31, **kw)
    for rows in (1, 4, 30):
        part = cooc.indicators_from_counts(counts, 5, block_rows=rows, **kw)
        assert all(torch.equal(a, b) for a, b in zip(part, whole))


def test_distinct_user_counts_and_top_k_sparsify_are_the_reference_s():
    ja, ta, _, _ = pair(seed=4, users=50, items=12)
    got = cooc.distinct_user_counts(ta)
    want = jax_cooc.distinct_user_counts(ja)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    rng = np.random.default_rng(0)
    m = rng.integers(0, 5, (12, 12)).astype(np.float32)
    for k, drop in ((3, True), (4, False), (20, True)):
        for a, b in zip(cooc.top_k_sparsify(m, k, drop), jax_cooc.top_k_sparsify(m, k, drop)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("case", ["one_total", "no_grand_total", "not_square", "universe"])
def test_validation_errors_are_the_reference_s(case):
    _, ta, _, tb = pair(users=20, items=6)
    ja, _, jb, _ = pair(users=20, items=6)
    ones = np.ones(6, np.float32)
    kwargs = {
        "one_total": dict(top_k=3, llr_row_totals=ones),
        "no_grand_total": dict(top_k=3, llr_row_totals=ones, llr_col_totals=ones),
        "not_square": dict(top_k=3, drop_diagonal=True),
        "universe": dict(top_k=3),
    }[case]
    other_j = jb if case == "not_square" else None
    other_t = tb if case == "not_square" else None
    if case == "universe":
        other_j = jax_pack(np.array([0]), np.array([1]), np.ones(1, np.float32), 9, 6)
        other_t = pack_padded_csr(np.array([0]), np.array([1]), np.ones(1, np.float32), 9, 6)
    with pytest.raises(ValueError) as want:
        jax_cooc.cooccurrence_indicators(ja, other_j, **kwargs)
    with pytest.raises(ValueError) as got:
        cooc.cooccurrence_indicators(ta, other_t, device="cpu", **kwargs)
    assert str(got.value) == str(want.value)


def test_a_sharded_reader_csr_is_not_ported():
    """The streaming reader's ``ShardedPaddedCSR`` is taken (one process:
    its local block is the whole padded layout): self and cross, counts
    equal the full CSR's and the JAX package's over its own one-device
    sharded CSR, indicators too; a layout built for another ``chunk`` and
    a sharded CSR beside a full one are refused with the reference's
    messages; over a 1 x 1 mesh the same (several ranks:
    ``test_torch_sharded_reader.py``)."""
    from predictionio_tpu.parallel import reader as jax_reader
    from predictionio_tpu.parallel.mesh import local_mesh
    from predictionio_tpu_torch.parallel import reader

    ja, ta, jb, tb = pair(users=61, items=13)
    u, i = interactions(5, 61, 13, 0.3, duplicates=7)
    ones = np.ones(u.size, np.float32)
    got = reader.build_cooc_csr_sharded(reader.array_coo_chunks(u, i, ones), 61, 13, chunk=16)
    want = jax_reader.build_cooc_csr_sharded(jax_reader.array_coo_chunks(u, i, ones), 61, 13,
                                             local_mesh(1, 1), chunk=16)
    np.testing.assert_array_equal(cooc.cooccurrence(got, chunk=16, device="cpu"),
                                  cooc.cooccurrence(ta, chunk=16, device="cpu"))
    np.testing.assert_array_equal(
        cooc.cooccurrence(got, chunk=16, device="cpu"),
        np.asarray(jax_cooc.cooccurrence(want, mesh=local_mesh(1, 1), chunk=16)))
    totals = reader.distinct_user_counts_sharded(got)
    np.testing.assert_array_equal(totals, cooc.distinct_user_counts(ta))
    kwargs = dict(top_k=5, llr_row_totals=totals, llr_col_totals=totals, total=61, chunk=16)
    idx_s, val_s = cooc.cooccurrence_indicators(got, device="cpu", **kwargs)
    idx_f, val_f = cooc.cooccurrence_indicators(ta, device="cpu", **kwargs)
    np.testing.assert_array_equal(idx_s, idx_f)
    np.testing.assert_array_equal(val_s, val_f)
    with pytest.raises(ValueError) as want_err:
        jax_cooc.cooccurrence(want, mesh=local_mesh(1, 1), chunk=3)
    with pytest.raises(ValueError) as got_err:
        cooc.cooccurrence(got, chunk=3, device="cpu")
    assert "rebuild" in str(got_err.value) and "rebuild" in str(want_err.value)
    with pytest.raises(ValueError, match="mixing a sharded-reader CSR"):
        cooc.cooccurrence_indicators(ta, got, top_k=2, chunk=16, device="cpu")
    # over a mesh (one process: 1 x 1) the same CSR, counts and indicators
    from predictionio_tpu_torch.parallel.mesh import local_mesh as torch_mesh

    one = torch_mesh(device="cpu")
    on_mesh = reader.build_cooc_csr_sharded(reader.array_coo_chunks(u, i, ones), 61, 13, one,
                                            chunk=16)
    np.testing.assert_array_equal(on_mesh.local.indices, want.local.indices)
    np.testing.assert_array_equal(reader.distinct_user_counts_sharded(on_mesh, one), totals)
    idx_m, val_m = cooc.cooccurrence_indicators(on_mesh, mesh=one, **kwargs)
    np.testing.assert_array_equal(idx_m, idx_f)
    np.testing.assert_array_equal(val_m, val_f)


def test_default_device_without_cuda_raises(monkeypatch):
    _, ta, _, _ = pair(users=8, items=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cooc.cooccurrence_indicators(ta, top_k=2)


@pytest.mark.cuda
def test_card_equals_the_cpu():
    """On the card: counts equal the CPU's bit for bit; indicators agree
    up to near-ties at rtol = atol = 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    users, items = 3000, 700
    u, i = interactions(8, users, items, 0.02, duplicates=500)
    ta = pack_padded_csr(u, i, np.ones(u.size, np.float32), users, items)
    u2, i2 = interactions(9, users, items + 50, 0.03)
    tb = pack_padded_csr(u2, i2, np.ones(u2.size, np.float32), users, items + 50)
    for other in (None, tb):
        np.testing.assert_array_equal(
            cooc.cooccurrence(ta, other, chunk=512, device="cuda"),
            cooc.cooccurrence(ta, other, chunk=512, device="cpu"))
        rows = cooc.distinct_user_counts(ta)
        cols = cooc.distinct_user_counts(other if other is not None else ta)
        kw = dict(top_k=50, chunk=512, llr_row_totals=rows, llr_col_totals=cols, total=users)
        assert_same_indicators(cooc.cooccurrence_indicators(ta, other, device="cuda", **kw),
                               cooc.cooccurrence_indicators(ta, other, device="cpu", **kw))
