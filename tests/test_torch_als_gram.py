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


@pytest.mark.cuda
@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(implicit, dtype):
    """The CUDA kernel against its plain version on the card, per row
    relative to max|gram| (the two sum over L in different orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(5)
    s, k, l, r = 3000, 16, 200, 1001
    table = torch.from_numpy(
        np.concatenate([rng.normal(size=(s, k)), np.zeros((1, k))]).astype(np.float32)
    ).to("cuda", dtype)
    idx = torch.from_numpy(rng.integers(0, s + 1, (r, l)).astype(np.int32)).cuda()
    val = torch.from_numpy(rng.integers(1, 6, (r, l)).astype(np.float32)).cuda()
    before = als_gram.gram_rhs.launches
    gram, rhs = als_gram.gram_rhs(idx, val, table, 0.5, implicit=implicit)
    torch.cuda.synchronize()
    assert als_gram.gram_rhs.launches == before + 1
    p_gram, p_rhs = als_gram.gram_rhs_plain(idx, val, table, 0.5, implicit=implicit)
    scale = p_gram.abs().amax(dim=(1, 2)).clamp(min=1e-30)
    assert float(((gram - p_gram).abs().amax(dim=(1, 2)) / scale).max()) < 1e-5
    scale = p_rhs.abs().amax(dim=1).clamp(min=1e-30)
    assert float(((rhs - p_rhs).abs().amax(dim=1) / scale).max()) < 1e-5
