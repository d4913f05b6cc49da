"""The port's two-stage MIPS retrieval against the JAX reference.

Same inputs, made with numpy from a seed, go through
``predictionio_tpu.ops`` (the stage-1 Pallas kernel in interpret mode, as
``tests/test_mips.py`` runs it) and ``predictionio_tpu_torch.ops`` (the
plain torch twin of the CUDA kernel, since the tensors lie on the CPU).
Tolerances: candidate indices exact; stage-1 scores within
``rtol=atol=1e-5``, because the two sum the K products in different
orders.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import mips as jax_mips
from predictionio_tpu.ops import quantize as jax_quantize
from predictionio_tpu_torch.ops import mips as torch_mips
from predictionio_tpu_torch.ops import quantize as torch_quantize


def _factors(n, k=16, seed=0):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)


def _raw_table(nb, bi, k, seed):
    """An int8 table of ``nb`` tiles of ``bi`` rows and its f32 scales,
    made directly: ``pack_int8_blockwise`` takes only multiples of 8."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (nb * bi, k)).astype(np.int8)
    return q, rng.uniform(0.01, 0.05, (nb, 1)).astype(np.float32)


def _integer_table(n, k, block_items, seed):
    """Factors in {-127, 0, 127}: every tile's scale is exactly 1.0, so
    with small integer queries every score is an exact integer in any
    summation order and ties abound."""
    f = 127 * np.random.default_rng(seed).integers(-1, 2, (n, k))
    return torch_quantize.pack_int8_blockwise(f.astype(np.float32), block_items)


def _stage1_both_raw(q, q_table, scales, r, num_items):
    js, ji = jax_mips.mips_block_topk(
        q, q_table, scales, block_topk=r, num_items=num_items, interpret=True,
    )
    ts, ti = torch_mips.mips_block_topk(
        torch.from_numpy(q), torch.from_numpy(q_table), torch.from_numpy(scales),
        block_topk=r, num_items=num_items,
    )
    return (np.asarray(js), np.asarray(ji)), (ts.numpy(), ti.numpy())


def _stage1_both(f, q, block_items, r, num_items=None):
    num_items = f.shape[0] if num_items is None else num_items
    packed = jax_quantize.pack_int8_blockwise(f, block_items)
    js, ji = jax_mips.mips_block_topk(
        q, packed.q, packed.scales, block_topk=r, num_items=num_items,
        interpret=True,
    )
    ts, ti = torch_mips.mips_block_topk(
        torch.from_numpy(q), torch.from_numpy(packed.q),
        torch.from_numpy(packed.scales), block_topk=r, num_items=num_items,
    )
    return (np.asarray(js), np.asarray(ji)), (ts.numpy(), ti.numpy())


@pytest.mark.parametrize(
    "num_items,block_items", [(300, 64), (10, 16), (64, 8), (1, 8)]
)
def test_pack_int8_blockwise_byte_identical(num_items, block_items):
    f = _factors(num_items, seed=num_items) * np.linspace(
        0.1, 3.0, num_items
    ).astype(np.float32)[:, None]
    f[: num_items // 3] = 0.0  # all-zero rows (and blocks) keep scale 1.0
    ref = jax_quantize.pack_int8_blockwise(f, block_items)
    port = torch_quantize.pack_int8_blockwise(f, block_items)
    assert port.q.dtype == ref.q.dtype and port.scales.dtype == ref.scales.dtype
    assert port.q.tobytes() == ref.q.tobytes()
    assert port.scales.tobytes() == ref.scales.tobytes()
    assert (port.num_items, port.block_items) == (ref.num_items, ref.block_items)


def test_stage1_random_tiles_match_reference():
    f = _factors(300, seed=4)  # 5 tiles of 64, the last one part padding
    q = _factors(16, seed=5)
    (js, ji), (ts, ti) = _stage1_both(f, q, 64, 8)
    assert ti.shape == ji.shape == (16, 5 * 8) and ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_items,k,block_items", [(1100, 400, 512), (9000, 16, 8192)])
def test_stage1_wide_tiles_match_reference(num_items, k, block_items):
    """Rank 400 at 512-item tiles and 8,192-item tiles at rank 16: tiles
    whose int8 rows or score rows pass a CUDA block's shared memory (the
    kernel then stages them in passes and keeps the scores in a global
    scratch). The plain stage 1 the kernel is held to gives the
    reference's candidates index for index."""
    f = _factors(num_items, k=k, seed=k)
    q = _factors(8, k=k, seed=k + 1)
    (js, ji), (ts, ti) = _stage1_both(f, q, block_items, 16)
    nb = -(-num_items // block_items)
    assert ti.shape == ji.shape == (8, nb * 16)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)


#: odd ranks (5: one partial 16-column step; 17, 33: partial 32-column
#: chunks) and odd tiles (100 items: a partial tensor-core tile; 1,000: two
#: sub-tiles of the kernel's 512); R = BI at 1,000 only at rank 5, since
#: the reference's interpret mode unrolls R passes (about a minute there)
ODD_STAGE1 = [
    (k, bi, r)
    for k in (5, 17, 33)
    for bi in (100, 1000)
    for r in (1, 16, bi)
    if not (bi == 1000 and r == bi and k != 5)
]


@pytest.mark.parametrize("k,bi,r", ODD_STAGE1)
def test_stage1_odd_ranks_and_tiles_match_reference(k, bi, r):
    """Stage 1 at ranks and tiles that are not multiples of the kernel's
    steps, the last tile part padding: the plain version gives the
    reference's candidates index for index."""
    q_table, scales = _raw_table(3, bi, k, seed=k * bi)
    q = _factors(8, k=k, seed=k + bi)
    num_items = 3 * bi - 7
    (js, ji), (ts, ti) = _stage1_both_raw(q, q_table, scales, r, num_items)
    assert ti.shape == ji.shape == (8, 3 * r) and ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("r", [1, 16, 32])
@pytest.mark.parametrize("bi", [16, 100, 512, 8192])
@pytest.mark.parametrize("k", [1, 5, 16, 17, 33, 400])
def test_mips_instance(k, bi, r):
    """Every rank and tile of the grid runs the tensor-core instance at
    R <= 32; an R past the tile is refused, as the wrapper refuses it."""
    if r > bi:
        with pytest.raises(ValueError):
            torch_mips.mips_instance(k, bi, r)
    else:
        assert torch_mips.mips_instance(k, bi, r) == "mma"


@pytest.mark.parametrize(
    "k,bi,r,instance",
    [(16, 512, 64, "mma"), (16, 512, 65, "passes"), (2048, 512, 16, "mma"),
     (2049, 512, 16, "passes"), (400, 8192, 48, "mma"), (16, 8192, 512, "passes")],
)
def test_mips_instance_limits(k, bi, r, instance):
    """Past R = 64 or rank 2,048 the SIMT passes instance runs."""
    assert torch_mips.mips_instance(k, bi, r) == instance
    for bad in ((0, bi, r), (k, 0, 1), (k, bi, 0)):
        with pytest.raises(ValueError):
            torch_mips.mips_instance(*bad)


def test_stage1_ties_break_to_lowest_index():
    f = np.ones((32, 8), np.float32)  # every row ties inside both tiles
    q = np.ones((8, 8), np.float32)
    (js, ji), (ts, ti) = _stage1_both(f, q, 16, 3)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ti[0], [0, 1, 2, 16, 17, 18])


def test_stage1_padding_never_outranks_real_negatives():
    rng = np.random.default_rng(90)
    f = -np.abs(rng.standard_normal((10, 8))).astype(np.float32)
    q = np.abs(rng.standard_normal((8, 8))).astype(np.float32)  # all scores < 0
    (js, ji), (ts, ti) = _stage1_both(f, q, 16, 16)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)
    for row in range(8):
        assert set(ti[row, :10].tolist()) == set(range(10))
        # the tail drains DISTINCT padding columns, in ascending order
        np.testing.assert_array_equal(ti[row, 10:], np.arange(10, 16))


def test_stage1_validation_raises():
    packed = torch_quantize.pack_int8_blockwise(_factors(32), block_items=32)
    table, scales = torch.from_numpy(packed.q), torch.from_numpy(packed.scales)
    q8 = torch.from_numpy(_factors(8))
    bad = [
        (torch.from_numpy(_factors(5)), table, scales, 4, 32),  # B % 8
        (q8, table, scales, 0, 32),                             # R < 1
        (q8, table, scales, 33, 32),                            # R > BI
        (q8, table, scales, 4, 0),                              # no items
        (q8, table, scales, 4, 33),                             # past padding
        (q8.double(), table, scales, 4, 32),                    # dtype
        (q8, table.float(), scales, 4, 32),                     # dtype
        (torch.from_numpy(_factors(8, k=8)), table, scales, 4, 32),  # K
    ]
    for q, t, s, r, n in bad:
        with pytest.raises((ValueError, TypeError)):
            torch_mips.mips_block_topk(q, t, s, block_topk=r, num_items=n)


def test_stage1_cpu_takes_plain_and_counts_no_launch():
    packed = torch_quantize.pack_int8_blockwise(_factors(64), block_items=32)
    args = (
        torch.from_numpy(_factors(8, seed=1)), torch.from_numpy(packed.q),
        torch.from_numpy(packed.scales),
    )
    before = torch_mips.mips_block_topk.launches
    a = torch_mips.mips_block_topk(*args, block_topk=4, num_items=64)
    b = torch_mips.mips_block_topk_plain(*args, block_topk=4, num_items=64)
    assert torch_mips.mips_block_topk.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


SEARCH_CASES = {
    # num_items <= shortlist: the exhaustive branch (no stage 1)
    "exhaustive": (100, jax_mips.RetrievalConfig(
        mode="mips", shortlist=128, block_items=64, block_topk=64)),
    # two-stage: merge over 8 tiles' candidates, shortlist < candidates
    "two_stage": (500, jax_mips.RetrievalConfig(
        mode="mips", shortlist=32, block_items=64, block_topk=8)),
}


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_search_indices_match_reference(case):
    num_items, jconf = SEARCH_CASES[case]
    tconf = torch_mips.RetrievalConfig(
        mode=jconf.mode, shortlist=jconf.shortlist,
        block_items=jconf.block_items, block_topk=jconf.block_topk,
    )
    f = _factors(num_items, seed=6)
    q = _factors(5, seed=7)  # pads to a batch of 8 on both sides
    ji, js = jax_mips.RetrievalIndex(f, jconf).search(q)
    ti, ts = torch_mips.RetrievalIndex(f, tconf, device="cpu").search(q)
    assert ti.dtype == np.int32 and ti.shape == ji.shape
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)


def test_search_zero_rows_tie_like_lax_top_k():
    """More all-zero rows (cold items) than the shortlist, each scoring
    exactly 0 above every real (negative) score: the merge must keep
    the lowest candidate positions among the ties, as ``lax.top_k``
    does, so the shortlist equals the reference's index for index."""
    rng = np.random.default_rng(11)
    f = -np.abs(rng.standard_normal((512, 16))).astype(np.float32)
    zero_rows = rng.choice(512, size=100, replace=False)
    f[zero_rows] = 0.0
    q = np.abs(rng.standard_normal((3, 16))).astype(np.float32)
    jconf = jax_mips.RetrievalConfig(
        mode="mips", shortlist=32, block_items=64, block_topk=16
    )
    tconf = torch_mips.RetrievalConfig(
        mode="mips", shortlist=32, block_items=64, block_topk=16
    )
    ji, _ = jax_mips.RetrievalIndex(f, jconf).search(q)
    ti, _ = torch_mips.RetrievalIndex(f, tconf, device="cpu").search(q)
    np.testing.assert_array_equal(ti, ji)
    assert set(ti[0].tolist()) <= set(zero_rows.tolist())


def test_retrieval_config_and_bytes_match_reference():
    raw = {"mode": "mips", "shortlist": 64, "blockItems": 128, "blockTopk": 8}
    j = jax_mips.RetrievalConfig.from_params(raw)
    t = torch_mips.RetrievalConfig.from_params(raw)
    assert (t.mode, t.shortlist, t.block_items, t.block_topk) == (
        j.mode, j.shortlist, j.block_items, j.block_topk
    )
    for bad in ({"mode": "turbo"}, {"mode": "mips", "shortList": 9}, "mips"):
        with pytest.raises(ValueError):
            torch_mips.RetrievalConfig.from_params(bad)
    for args in ((1_000_000, 16, 256), (1000, 8, 8, 64, 4, 32)):
        assert torch_mips.mips_bytes(*args) == jax_mips.mips_bytes(*args)
    assert torch_mips.scan_bytes(1000, 16, 8) == jax_mips.scan_bytes(1000, 16, 8)


def test_reference_shortlist_matches_reference():
    f = _factors(700, seed=12)
    q = _factors(4, seed=13)
    for conf in (
        jax_mips.RetrievalConfig(mode="mips", shortlist=64, block_items=64, block_topk=8),
        jax_mips.RetrievalConfig(mode="mips", shortlist=1024),
    ):
        tconf = torch_mips.RetrievalConfig(
            mode="mips", shortlist=conf.shortlist,
            block_items=conf.block_items, block_topk=conf.block_topk,
        )
        np.testing.assert_array_equal(
            torch_mips.reference_shortlist(f, q, tconf),
            jax_mips.reference_shortlist(f, q, conf),
        )


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain twin on the card (the chip's
    own check lives in ``chip_smoke.py``; this is its pytest form)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    f = _factors(3000, seed=14)
    packed = torch_quantize.pack_int8_blockwise(f, block_items=512)
    args = [
        torch.from_numpy(x).cuda()
        for x in (_factors(16, seed=15), packed.q, packed.scales)
    ]
    before = torch_mips.mips_block_topk.launches
    ks, ki = torch_mips.mips_block_topk(*args, block_topk=16, num_items=3000)
    torch.cuda.synchronize()
    assert torch_mips.mips_block_topk.launches == before + 1
    ps, pi = torch_mips.mips_block_topk_plain(*args, block_topk=16, num_items=3000)
    assert torch.equal(ki, pi)
    torch.testing.assert_close(ks, ps, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("num_items,k,block_items", [(3001, 400, 512), (20_000, 16, 8192)])
def test_kernel_matches_plain_on_card_at_wide_tiles(num_items, k, block_items):
    """The kernel's passes over K and its global score rows: rank 400 at
    512-item tiles and 8,192-item tiles at rank 16 against the plain
    twin on the card, one launch each; indices equal except where two
    scores lie within the sums' rounding of the R-th (the two sum the K
    products in different orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    packed = torch_quantize.pack_int8_blockwise(_factors(num_items, k=k, seed=16), block_items)
    args = [
        torch.from_numpy(x).cuda()
        for x in (_factors(16, k=k, seed=17), packed.q, packed.scales)
    ]
    before = torch_mips.mips_block_topk.launches
    ks, ki = torch_mips.mips_block_topk(*args, block_topk=16, num_items=num_items)
    torch.cuda.synchronize()
    assert torch_mips.mips_block_topk.launches == before + 1
    ps, pi = torch_mips.mips_block_topk_plain(*args, block_topk=16, num_items=num_items)
    torch.testing.assert_close(ks, ps, rtol=1e-5, atol=1e-5)
    kth = ps.reshape(16, -1, 16)[:, :, -1:]
    near = ((ks.reshape(16, -1, 16) - kth).abs() <= 1e-5 * (1 + kth.abs())).reshape(ks.shape)
    assert bool(((ki == pi) | near).all())


def _stage1_card(args, r, num_items, exact):
    """One launch of the kernel against the plain version on the card:
    indices equal (``exact``), or else, per (query, tile), the sorted
    scores within 1e-5 and the index sets equal except entries whose
    score lies within that of the R-th (the two sum the K products in
    different orders, so near-equal scores may swap places)."""
    before = torch_mips.mips_block_topk.launches
    ks, ki = torch_mips.mips_block_topk(*args, block_topk=r, num_items=num_items)
    torch.cuda.synchronize()
    assert torch_mips.mips_block_topk.launches == before + 1
    ps, pi = torch_mips.mips_block_topk_plain(*args, block_topk=r, num_items=num_items)
    if exact:
        torch.testing.assert_close(ks, ps, rtol=1e-5, atol=1e-5)
        assert torch.equal(ki, pi)
        return
    b = args[0].shape[0]
    ks, ki, ps, pi = (x.reshape(b, -1, r) for x in (ks, ki, ps, pi))
    torch.testing.assert_close(torch.sort(ks, dim=2, descending=True).values, ps,
                               rtol=1e-5, atol=1e-5)
    kth = ps[:, :, -1:]
    near_k = (ks - kth).abs() <= 1e-5 * (1 + kth.abs())
    near_p = (ps - kth).abs() <= 1e-5 * (1 + kth.abs())
    k_in_p = (ki[..., :, None] == pi[..., None, :]).any(-1)
    p_in_k = (pi[..., :, None] == ki[..., None, :]).any(-1)
    assert bool((k_in_p | near_k).all()) and bool((p_in_k | near_p).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k,bi,r", ODD_STAGE1)
def test_kernel_matches_plain_on_card_at_odd_ranks_and_tiles(k, bi, r):
    """The odd ranks and tiles of the CPU cases on the card (R = 1,000
    runs the passes instance)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q_table, scales = _raw_table(40, bi, k, seed=k * bi)
    args = [torch.from_numpy(x).cuda() for x in (_factors(24, k=k, seed=k), q_table, scales)]
    _stage1_card(args, r, 40 * bi - 7, exact=False)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case,num_items,k,block_items,r",
    [("all_equal", 2048, 16, 512, 16),          # every score ties: past the survivor buffer
     ("ties_across_subtiles", 20_000, 16, 8192, 16),
     ("ties_r32", 5000, 33, 1000, 32),
     ("ties_r48", 5000, 16, 512, 48),           # R > 32: register passes
     ("ties_r100", 5000, 16, 512, 100)],        # R > 64: the passes instance
)
def test_kernel_ties_match_plain_on_card(case, num_items, k, block_items, r):
    """Exact scores (integer factors at scale 1.0, integer queries) with
    ties everywhere, within and across the kernel's 512-column sub-tiles:
    the kernel's indices equal the plain version's, lowest index first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if case == "all_equal":
        packed = torch_quantize.pack_int8_blockwise(
            np.ones((num_items, k), np.float32), block_items)
    else:
        packed = _integer_table(num_items, k, block_items, seed=num_items + k)
    q = np.random.default_rng(k).integers(-3, 4, (16, k)).astype(np.float32)
    args = [torch.from_numpy(x).cuda() for x in (q, packed.q, packed.scales)]
    _stage1_card(args, r, num_items, exact=True)
