"""The port's fused gather->Gram/rhs (``ops/als_gram``) against the JAX
package's Pallas kernel, run in interpret mode as the reference's own
tests run it on the CPU. On a CPU tensor the port's ``gram_rhs`` takes
its plain version, so these hold the arithmetic the CUDA kernel must
reproduce; the kernel itself is held to the plain version on the card
(``test_kernel_matches_plain_on_card`` and ``chip_smoke.py``).

Bars are the reference's: ``atol=1e-4`` on real padded-CSR blocks and
``1e-5`` on the small uneven block (``tests/test_als_gram.py:79,120``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als_gram as jax_gram
from predictionio_tpu.parallel.als import ALSConfig as JaxALSConfig
from predictionio_tpu.parallel.als import build_als_data as jax_build_als_data
from predictionio_tpu_torch.ops import als_gram


@pytest.fixture(scope="module")
def synthetic():
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


def _tables(host: np.ndarray, dtype: str):
    """The same factor table for both packages: f32, or bf16 rounded once
    by torch and handed to JAX as exactly representable values."""
    t = torch.from_numpy(host.astype(np.float32))
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
        return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return t, jnp.asarray(t.numpy())


def _both(idx, val, host_table, alpha, implicit, dtype="float32"):
    t_table, j_table = _tables(host_table, dtype)
    gram, rhs = als_gram.gram_rhs(
        torch.from_numpy(idx), torch.from_numpy(val), t_table, alpha,
        implicit=implicit,
    )
    j_gram, j_rhs = jax_gram.gram_rhs(
        jnp.asarray(idx), jnp.asarray(val), j_table, alpha,
        implicit=implicit, interpret=True,
    )
    return gram.numpy(), rhs.numpy(), np.asarray(j_gram), np.asarray(j_rhs)


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_kernel_on_padded_csr(synthetic, implicit, dtype):
    n_u, n_i, uu, ii, rr = synthetic
    data = jax_build_als_data(uu, ii, rr, n_u, n_i, JaxALSConfig(rank=6))
    block = data.by_row.blocks[0]
    rng = np.random.default_rng(3)
    table = np.concatenate(
        [rng.normal(size=(data.by_col.total_slots, 6)), np.zeros((1, 6))]
    )
    gram, rhs, j_gram, j_rhs = _both(
        block.indices, block.values, table, 10.0, implicit, dtype
    )
    assert gram.dtype == np.float32 and rhs.dtype == np.float32
    np.testing.assert_allclose(gram, j_gram, atol=1e-4)
    np.testing.assert_allclose(rhs, j_rhs, atol=1e-4)


@pytest.mark.parametrize("implicit", [False, True])
def test_padding_rows_contribute_exactly_zero(implicit):
    """Sentinel indices hit the appended zero row, so an all-padding
    row's Gram and rhs are exactly zero (no mask stream needed)."""
    rng = np.random.default_rng(0)
    s, k, l = 24, 6, 16
    table = np.concatenate([rng.normal(size=(s, k)), np.zeros((1, k))])
    idx = np.full((8, l), s, np.int32)
    idx[0, :4] = [1, 2, 3, 4]
    val = np.zeros((8, l), np.float32)
    val[0, :4] = 1.0
    gram, rhs, j_gram, j_rhs = _both(idx, val, table, 5.0, implicit)
    assert np.abs(gram[1:]).max() == 0.0 and np.abs(rhs[1:]).max() == 0.0
    assert np.abs(gram[0]).max() > 0.0
    np.testing.assert_allclose(gram, j_gram, atol=1e-5)
    np.testing.assert_allclose(rhs, j_rhs, atol=1e-5)


@pytest.mark.parametrize("rows", [12, 13, 1])
def test_uneven_row_counts(rows):
    """Row counts that no block size divides (the reference shrinks its
    row block; the port has one CUDA block per row)."""
    rng = np.random.default_rng(rows)
    s, k, l = 16, 4, 8
    table = np.concatenate([rng.normal(size=(s, k)), np.zeros((1, k))])
    idx = rng.integers(0, s + 1, size=(rows, l)).astype(np.int32)
    val = rng.random((rows, l)).astype(np.float32)
    gram, rhs, j_gram, j_rhs = _both(idx, val, table, 0.0, False)
    np.testing.assert_allclose(gram, j_gram, atol=1e-5)
    np.testing.assert_allclose(rhs, j_rhs, atol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize(
    "shape", [(138_000, 200, 16, 4), (27_000, 256, 16, 2), (8, 8, 64, 4)]
)
def test_half_step_bytes_matches_reference(shape, fused):
    assert als_gram.half_step_bytes(*shape, fused) == jax_gram.half_step_bytes(
        *shape, fused
    )


@pytest.mark.parametrize("implicit", [False, True])
def test_matches_jax_kernel_at_rank_128(implicit):
    """A rank past the 5 x 1,024 entries one CUDA block holds (the kernel
    splits the K (K + 1) entries into groups there): the plain version
    the kernel is held to against the reference's Pallas kernel at
    K = 128, padding slots and an all-padding row included."""
    rng = np.random.default_rng(128)
    s, k, l, r = 60, 128, 16, 9
    table = np.concatenate([rng.normal(size=(s, k)), np.zeros((1, k))])
    idx = rng.integers(0, s, size=(r, l)).astype(np.int32)
    idx[:, -3:] = s
    idx[4] = s
    val = rng.integers(1, 6, size=(r, l)).astype(np.float32)
    gram, rhs, j_gram, j_rhs = _both(idx, val, table, 2.5, implicit)
    assert gram.shape == (r, k, k) and rhs.shape == (r, k)
    assert not gram[4].any() and not rhs[4].any()
    np.testing.assert_allclose(gram, j_gram, atol=1e-4)
    np.testing.assert_allclose(rhs, j_rhs, atol=1e-4)


@pytest.mark.parametrize("k", [17, 33])
@pytest.mark.parametrize("l", [8, 40])
@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_kernel_at_odd_ranks(k, l, implicit, dtype):
    """Ranks that leave ragged 16 x 8 tiles in the tensor-core instance
    (17, 33), at one 8-slot step (L = 8) and at several: the plain
    version the kernel is held to against the reference's Pallas kernel,
    with padding slots and an all-padding row."""
    rng = np.random.default_rng(k * 100 + l)
    s, r = 40, 7
    table = np.concatenate([rng.normal(size=(s, k)), np.zeros((1, k))])
    idx = rng.integers(0, s, size=(r, l)).astype(np.int32)
    idx[:, -3:] = s
    idx[2] = s
    val = rng.random((r, l)).astype(np.float32)
    gram, rhs, j_gram, j_rhs = _both(idx, val, table, 1.5, implicit, dtype)
    assert gram.shape == (r, k, k) and rhs.shape == (r, k)
    assert not gram[2].any() and not rhs[2].any()
    np.testing.assert_allclose(gram, j_gram, atol=1e-4)
    np.testing.assert_allclose(rhs, j_rhs, atol=1e-4)


@pytest.mark.parametrize(
    "k, instance",
    [(1, "mma"), (16, "mma"), (256, "mma"), (als_gram.MMA_MAX_RANK, "mma"),
     (als_gram.MMA_MAX_RANK + 1, "simt"), (als_gram.MAX_RANK, "simt")],
)
def test_gram_instance(k, instance):
    """The rank -> kernel instance map: the tensor-core instance through
    ``MMA_MAX_RANK`` (512), the grouped SIMT one past it up to
    ``MAX_RANK``."""
    assert als_gram.gram_instance(k) == instance


@pytest.mark.parametrize("k", [0, als_gram.MAX_RANK + 1])
def test_gram_instance_refuses_ranks_no_instance_takes(k):
    with pytest.raises(ValueError, match="outside the kernel's ranks"):
        als_gram.gram_instance(k)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    idx = torch.zeros((8, 8), dtype=torch.int32)
    val = torch.zeros((8, 8), dtype=torch.float32)
    table = torch.zeros((4, 16), dtype=torch.float32)
    with pytest.raises(TypeError, match="int32 indices"):
        als_gram.gram_rhs(idx.long(), val, table)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        als_gram.gram_rhs(idx, val, table.double())
    with pytest.raises(ValueError, match="multiple of 8"):
        als_gram.gram_rhs(idx[:, :6], val[:, :6], table)
    with pytest.raises(ValueError, match=r"\[R, L\]"):
        als_gram.gram_rhs(idx, val[:4], table)


def _card_block(rng, s, k, r, l, dtype=torch.float32):
    """A random table with its zero row, indices (row 2, if there is one,
    all padding) and values 1..5, on the card."""
    table = torch.from_numpy(
        np.concatenate([rng.normal(size=(s, k)), np.zeros((1, k))]).astype(np.float32)
    ).to("cuda", dtype)
    idx = rng.integers(0, s + 1, (r, l)).astype(np.int32)
    if r > 2:
        idx[2] = s
    val = rng.integers(1, 6, (r, l)).astype(np.float32)
    return torch.from_numpy(idx).cuda(), torch.from_numpy(val).cuda(), table


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k", [8, 16, 17, 24, 33, 64, 65, 128, 200, 256, als_gram.MMA_MAX_RANK,
          als_gram.MMA_MAX_RANK + 1]
)
@pytest.mark.parametrize("l", [8, 200])
@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(k, l, implicit, dtype):
    """The CUDA kernel against its plain version on the card, per row
    relative to max|gram| (the two sum over L in different orders): at
    the template's rank, at ranks that leave ragged tensor-core tiles
    (8, 17, 24, 33), that split a row's tiles over warps and groups of
    blocks (64 to 512), and past the tensor-core instance (513); at one
    8-slot step (L = 8) and at many. The all-padding row is exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(5)
    idx, val, table = _card_block(rng, 3000, k, 1001, l, dtype)
    before = als_gram.gram_rhs.launches
    gram, rhs = als_gram.gram_rhs(idx, val, table, 0.5, implicit=implicit)
    torch.cuda.synchronize()
    assert als_gram.gram_rhs.launches == before + 1
    assert not gram[2].any() and not rhs[2].any()
    p_gram, p_rhs = als_gram.gram_rhs_plain(idx, val, table, 0.5, implicit=implicit)
    scale = p_gram.abs().amax(dim=(1, 2)).clamp(min=1e-30)
    assert float(((gram - p_gram).abs().amax(dim=(1, 2)) / scale).max()) < 1e-5
    scale = p_rhs.abs().amax(dim=1).clamp(min=1e-30)
    assert float(((rhs - p_rhs).abs().amax(dim=1) / scale).max()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 72, 128, 200, als_gram.MMA_MAX_RANK, als_gram.MMA_MAX_RANK + 1])
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_kernel_few_rows_on_card(k, rows):
    """Few rows: at rank 16 fewer than the 8 rows a tensor-core block
    runs, at the wider ranks every group's block of a row at the same
    time (no block may store into another's entries). Each entry has one
    owner that sums it in a fixed order, so repeated launches must agree
    bit for bit, and each must match the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(k + rows)
    s, l = 500, 64
    table = torch.from_numpy(
        np.concatenate([rng.normal(size=(s, k)), np.zeros((1, k))]).astype(np.float32)
    ).cuda()
    idx = torch.from_numpy(rng.integers(0, s + 1, (rows, l)).astype(np.int32)).cuda()
    val = torch.from_numpy(rng.integers(1, 6, (rows, l)).astype(np.float32)).cuda()
    p_gram, p_rhs = als_gram.gram_rhs_plain(idx, val, table, 0.5, implicit=True)
    first = None
    for _ in range(8):
        gram, rhs = als_gram.gram_rhs(idx, val, table, 0.5, implicit=True)
        torch.cuda.synchronize()
        if first is None:
            first = (gram.clone(), rhs.clone())
        assert torch.equal(gram, first[0]) and torch.equal(rhs, first[1])
    scale = p_gram.abs().amax(dim=(1, 2)).clamp(min=1e-30)
    assert float(((gram - p_gram).abs().amax(dim=(1, 2)) / scale).max()) < 1e-5
    scale = p_rhs.abs().amax(dim=1).clamp(min=1e-30)
    assert float(((rhs - p_rhs).abs().amax(dim=1) / scale).max()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16, 17, 64, 128, als_gram.MMA_MAX_RANK])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_gram_is_symmetric_on_card(k, dtype):
    """The tensor-core instance computes the tiles on or above the
    diagonal and mirrors them: ``gram`` equals its transpose exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    idx, val, table = _card_block(np.random.default_rng(k), 700, k, 333, 64, dtype)
    for implicit in (False, True):
        gram, _ = als_gram.gram_rhs(idx, val, table, 0.5, implicit=implicit)
        torch.cuda.synchronize()
        assert torch.equal(gram, gram.transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16, als_gram.MMA_MAX_RANK, als_gram.MMA_MAX_RANK + 1,
                               als_gram.MAX_RANK, als_gram.MAX_RANK + 1])
def test_kernel_instance_agrees_with_python(k):
    """The C launcher's instance choice is ``gram_instance``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from predictionio_tpu_torch import _kernels

    got = _kernels.library("als_gram").als_gram_instance(k)
    if k > als_gram.MAX_RANK:
        assert got == -1
    else:
        assert got == {"mma": 1, "simt": 0}[als_gram.gram_instance(k)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 33, 300, als_gram.MMA_MAX_RANK + 1])
def test_kernel_gathers_a_nonzero_last_row_on_card(k):
    """The kernel writes padding slots as zeros without gathering them
    only where the table's last row is zero, as the contract says; a
    table whose last row is not zero is gathered like any other row and
    still matches the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(k)
    idx, val, table = _card_block(rng, 400, k, 97, 64)
    table[-1] = torch.from_numpy(rng.normal(size=k).astype(np.float32)).cuda()
    gram, rhs = als_gram.gram_rhs(idx, val, table, 0.5, implicit=True)
    torch.cuda.synchronize()
    p_gram, p_rhs = als_gram.gram_rhs_plain(idx, val, table, 0.5, implicit=True)
    assert gram[2].abs().max() > 0  # row 2 indexes only the last row
    scale = p_gram.abs().amax(dim=(1, 2)).clamp(min=1e-30)
    assert float(((gram - p_gram).abs().amax(dim=(1, 2)) / scale).max()) < 1e-5
    scale = p_rhs.abs().amax(dim=1).clamp(min=1e-30)
    assert float(((rhs - p_rhs).abs().amax(dim=1) / scale).max()) < 1e-5
