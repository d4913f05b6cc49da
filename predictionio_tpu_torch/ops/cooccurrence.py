"""Item-item cooccurrence and LLR scoring on the card.

Port of ``predictionio_tpu/ops/cooccurrence.py``: the similar-product
template's cooccurrence and the Universal Recommender's correlated
cross-occurrence with log-likelihood-ratio weighting. The reference
computes them with plain ``jnp`` (no Pallas kernel), so the port is plain
torch on an explicit device (``cuda`` unless the caller names ``"cpu"``).

Cooccurrence is a product: with the user-history one-hot ``A [users,
items]``, the cooccurrence of primary events with another type's is
``A_primaryᵀ @ A_other``. The compact padded CSR (``indices``, ``mask``)
goes to the device once; fixed ``chunk``-user blocks of it are scattered
into dense one-hot rows there (``_dense_onehot``) and their products
accumulate into an ``[items_p, items_o]`` f32 tensor. The one-hot rows
sum 0/1 values and a count never passes the number of users, so f32 is
exact: the counts equal the reference's bit for bit.

Departures from the reference, none of which changes a value:

- The reference's ``shard_map`` over the mesh's ``data`` axis and its
  ``psum``: a ``ShardedPaddedCSR`` (``parallel/reader.py``, the
  streaming reader's CSR) is taken as the reference takes it
  (``:171-194``), its layout held to ``cooc_global_rows`` for ``mesh``
  and never mixed with a full CSR. Each rank accumulates its own user
  rows (its ``local`` block, already padded to whole chunks), and over a
  mesh an all-reduce over ``data`` sums the accumulators (counts below
  2^24, so the f32 sum is exact and equals one process's). Without a
  mesh a full CSR or the one-process sharded CSR goes up as it is.
- The LLR, the diagonal drop and the per-row top-k run over row blocks of
  the accumulator (``indicators_from_counts``): the reference's
  whole-matrix temporaries (``k12``, ``k21``, ``k22``, four ``_xlogx``
  terms and ``jnp.eye(items)``) would take tens of GB at 27,000 items.
- The top-k is a stable descending sort, then the first k: equal values
  rank the lower index first, as ``jax.lax.top_k`` does (``torch.topk``
  promises no order among ties).

``distinct_user_counts`` and ``top_k_sparsify`` are numpy and copied.
"""

from __future__ import annotations

import numpy as np
import torch

from predictionio_tpu_torch.ops.ragged import PaddedCSR
from predictionio_tpu_torch.utils.device import resolve_device

#: elements of one row block's temporaries in ``indicators_from_counts``
#: (2**26 f32: 256 MiB each; about a dozen live at once)
BLOCK_ELEMENTS = 1 << 26


def _dense_onehot(indices: torch.Tensor, mask: torch.Tensor, num_cols: int) -> torch.Tensor:
    """Binarized dense ``[rows, num_cols]`` from padded-CSR rows: a
    scatter-add, then clamped to 1 (a user's duplicate pairs count once),
    the sentinel column dropped."""
    rows = indices.shape[0]
    flat = indices.long() + (
        torch.arange(rows, device=indices.device, dtype=torch.long) * (num_cols + 1)
    )[:, None]
    out = torch.zeros(rows * (num_cols + 1), dtype=torch.float32, device=indices.device)
    out.index_add_(0, flat.reshape(-1), mask.reshape(-1).to(torch.float32))
    return out.view(rows, num_cols + 1)[:, :num_cols].clamp(max=1.0)


def _normalize(primary: PaddedCSR, other: PaddedCSR | None) -> PaddedCSR:
    """Shared preamble of the entry points: resolve self-cooccurrence and
    validate the shared user universe."""
    other = other if other is not None else primary
    if primary.num_rows != other.num_rows:
        raise ValueError(
            f"CSRs must share the user universe: {primary.num_rows} vs {other.num_rows}"
        )
    return other


def _pad_rows_sentinel(csr: PaddedCSR, rows: int) -> tuple[np.ndarray, np.ndarray]:
    """(indices, mask) grown to ``rows`` rows; padding rows carry the
    sentinel column with mask 0, so they contribute nothing."""
    pad = rows - csr.indices.shape[0]
    indices = np.pad(csr.indices, ((0, pad), (0, 0)), constant_values=csr.num_cols)
    mask = np.pad(csr.mask, ((0, pad), (0, 0)))
    return indices, mask


def cooccurrence_counts(
    primary: PaddedCSR,
    other: PaddedCSR | None = None,
    chunk: int = 4096,
    device=None,
    mesh=None,
) -> torch.Tensor:
    """``A_primaryᵀ @ A_other`` as an ``[items_p, items_o]`` f32 tensor
    on ``device``: the CSRs go up once, then fixed ``chunk``-user blocks
    are scattered to one-hot rows and their products accumulated (the
    reference's ``lax.scan`` body). The user rows pad to a whole number of
    chunks with sentinel rows; a ``ShardedPaddedCSR`` pair comes padded
    so by ``build_cooc_csr_sharded`` for the same ``chunk`` and ``mesh``,
    or raises; over a mesh each rank accumulates its rows and the
    accumulators are summed over ``data``."""
    from predictionio_tpu_torch.parallel.reader import ShardedPaddedCSR, cooc_global_rows

    device = mesh.device if mesh is not None else resolve_device(device)
    other = _normalize(primary, other)
    sharded = isinstance(primary, ShardedPaddedCSR)
    if sharded != isinstance(other, ShardedPaddedCSR):
        raise ValueError(
            "mixing a sharded-reader CSR with a full host CSR is not "
            "supported: build both sides sharded (or neither)"
        )
    if sharded:
        rows = primary.global_rows
        expect = cooc_global_rows(primary.num_rows, mesh, chunk)
        if rows != expect or other.global_rows != rows:
            raise ValueError(
                f"sharded CSR was built for a different mesh/chunk layout "
                f"(rows {rows}/{other.global_rows}, this call expects "
                f"{expect}); rebuild with build_cooc_csr_sharded(mesh=..., "
                f"chunk={chunk})"
            )
        local_rows = primary.row_hi - primary.row_lo
        chunk = max(1, min(chunk, local_rows))
        rows = local_rows
    else:
        phys_rows = max(primary.indices.shape[0], other.indices.shape[0])
        chunk = max(1, min(chunk, phys_rows))
        rows = -(-phys_rows // chunk) * chunk
    self_cooc = other is primary

    def upload(csr):
        if sharded:  # this rank's rows, padded to whole chunks by the reader
            idx, msk = csr.local.indices, csr.local.mask
        else:
            idx, msk = _pad_rows_sentinel(csr, rows)
        return (torch.from_numpy(np.ascontiguousarray(idx)).to(device),
                torch.from_numpy(np.ascontiguousarray(msk)).to(device))

    idx_p, msk_p = upload(primary)
    idx_o, msk_o = (idx_p, msk_p) if self_cooc else upload(other)
    acc = torch.zeros((primary.num_cols, other.num_cols), dtype=torch.float32, device=device)
    for start in range(0, rows, chunk):
        stop = start + chunk
        a = _dense_onehot(idx_p[start:stop], msk_p[start:stop], primary.num_cols)
        b = a if self_cooc else _dense_onehot(
            idx_o[start:stop], msk_o[start:stop], other.num_cols)
        acc.addmm_(a.t(), b)
    if sharded and mesh is not None:
        from predictionio_tpu_torch.parallel.mesh import all_reduce_sum

        acc = all_reduce_sum(mesh, ("data",), acc)
    return acc


def cooccurrence(
    primary: PaddedCSR,
    other: PaddedCSR | None = None,
    chunk: int = 4096,
    device=None,
    mesh=None,
) -> np.ndarray:
    """``A_primaryᵀ @ A_other`` over shared user rows -> [items_p, items_o].

    ``other=None`` means self-cooccurrence. Both CSRs must be row-indexed
    by the same user universe (same ``num_rows``)."""
    return _run_cooc(primary, _normalize(primary, other), chunk, device, mesh=mesh)


#: the f32 coefficients of the reference's log (Cephes ``logf``)
_LOG_P = [float(np.float32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)]
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = float(np.float32(0.693359375))
_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32: the product of two f32 values
    is exact in f64, so only the sum rounds (to f64, then to f32)."""
    f64 = lambda v: v.double() if isinstance(v, torch.Tensor) else v
    return (f64(a) * f64(b) + f64(c)).float()


def _log(x: torch.Tensor) -> torch.Tensor:
    """The f32 natural log of positive normal ``x`` as the reference's
    ``jnp.log`` computes it on the host (XLA's Cephes ``logf``
    polynomial with fused multiply-adds), so the LLR's cancelling sums
    start from the same terms: ``torch.log`` is correctly rounded and
    differs from it by an ulp on about 1% of integers, which the
    cancellation grows past 1e-5. Elementwise IEEE operations only, so
    the card and the host agree bit for bit."""
    bits = torch.clamp(x, min=_MIN_NORMAL).view(torch.int32)
    e = ((bits >> 23) - 0x7E).float()
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    small = m < 0.707106781186547524
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma(t, p[0], p[1])
    y1 = _fma(t, p[3], p[4])
    y2 = _fma(t, p[6], p[7])
    y = _fma(y, t, p[2])
    y1 = _fma(y1, t, p[5])
    y2 = _fma(y2, t, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    t = _fma(x2, -0.5, t) + y
    return _fma(e, _LOG_Q2, t)


def _xlogx(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x * _log(x), torch.zeros_like(x))


def _llr_math(k11, row_totals, col_totals, total):
    """G^2 log-likelihood-ratio over the 2x2 contingency per (i, j) pair."""
    k12 = torch.clamp(row_totals[:, None] - k11, min=0.0)
    k21 = torch.clamp(col_totals[None, :] - k11, min=0.0)
    k22 = torch.clamp(total - k11 - k12 - k21, min=0.0)
    h_k = _xlogx(k11) + _xlogx(k12) + _xlogx(k21) + _xlogx(k22)
    h_rows = _xlogx(k11 + k12) + _xlogx(k21 + k22)
    h_cols = _xlogx(k11 + k21) + _xlogx(k12 + k22)
    h_total = _xlogx(k11 + k12 + k21 + k22)
    llr = 2.0 * (h_k + h_total - h_rows - h_cols)
    return torch.where(k11 > 0, torch.clamp(llr, min=0.0), torch.zeros_like(llr))


def indicators_from_counts(
    counts: torch.Tensor,
    top_k: int,
    *,
    row_totals: torch.Tensor | None = None,
    col_totals: torch.Tensor | None = None,
    total: float = 0.0,
    drop_diagonal: bool = False,
    block_rows: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-``top_k`` of the (optionally LLR-weighted) counts, with
    the diagonal dropped when asked, over row blocks of ``counts`` (on
    its device). Returns (indices int32, values f32 with the dropped
    diagonal's -inf as 0); equal values rank the lower index first."""
    num_p, num_o = counts.shape
    if block_rows is None:
        block_rows = max(1, BLOCK_ELEMENTS // max(num_o, 1))
    idx_out = torch.empty((num_p, top_k), dtype=torch.int32, device=counts.device)
    val_out = torch.empty((num_p, top_k), dtype=torch.float32, device=counts.device)
    for start in range(0, num_p, block_rows):
        stop = min(start + block_rows, num_p)
        m = counts[start:stop]
        if row_totals is not None:
            m = _llr_math(m, row_totals[start:stop], col_totals, total)
        elif drop_diagonal:
            m = m.clone()
        if drop_diagonal:
            rows = torch.arange(stop - start, device=counts.device)
            m[rows, rows + start] = -torch.inf
        # + 0.0 turns a -0.0 into 0.0, so a radix sort ties it with 0.0
        vals, idx = torch.sort(m + 0.0, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :top_k], idx[:, :top_k]
        idx_out[start:stop] = idx.to(torch.int32)
        val_out[start:stop] = torch.where(torch.isfinite(vals), vals, torch.zeros_like(vals))
    return idx_out, val_out


def _run_cooc(
    primary: PaddedCSR,
    other: PaddedCSR,
    chunk: int,
    device,
    *,
    top_k: int = 0,
    llr: bool = False,
    drop_diagonal: bool = False,
    total: float = 0.0,
    row_totals=None,
    col_totals=None,
    mesh=None,
):
    """Accumulate on ``device`` (over ``mesh``: summed over its ranks),
    then fetch: ``top_k == 0`` returns the
    raw accumulator, otherwise the (optionally LLR-weighted) per-row
    top-k indicators, so the ``[items, items]`` matrix never reaches the
    host."""
    device = mesh.device if mesh is not None else resolve_device(device)
    acc = cooccurrence_counts(primary, other, chunk, device, mesh=mesh)
    if top_k == 0:
        return acc.cpu().numpy()
    to_dev = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    idx, vals = indicators_from_counts(
        acc, top_k,
        row_totals=to_dev(row_totals) if llr else None,
        col_totals=to_dev(col_totals) if llr else None,
        total=float(total), drop_diagonal=drop_diagonal,
    )
    return idx.cpu().numpy(), vals.cpu().numpy()


def distinct_user_counts(csr: PaddedCSR) -> np.ndarray:
    """Per-item distinct-user count in O(nnz) on the host -- the diagonal of
    the (binarized) self-cooccurrence, without the [items, items] matmul."""
    rows = np.repeat(np.arange(csr.indices.shape[0]), csr.max_len)
    cols = csr.indices.reshape(-1)
    valid = (csr.mask.reshape(-1) > 0) & (cols < csr.num_cols)
    pairs = np.unique(
        rows[valid].astype(np.int64) * csr.num_cols + cols[valid].astype(np.int64)
    )
    return np.bincount(
        (pairs % csr.num_cols).astype(np.int64), minlength=csr.num_cols
    ).astype(np.float32)


def llr_scores(
    cooc: np.ndarray,
    row_totals: np.ndarray,
    col_totals: np.ndarray,
    total: float,
    device=None,
) -> np.ndarray:
    """LLR significance of each cooccurrence count (same shape as cooc),
    computed on ``device``."""
    device = resolve_device(device)
    to_dev = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return _llr_math(
        to_dev(cooc), to_dev(row_totals), to_dev(col_totals), float(total)
    ).cpu().numpy()


def cooccurrence_indicators(
    primary: PaddedCSR,
    other: PaddedCSR | None = None,
    *,
    top_k: int,
    llr_row_totals: np.ndarray | None = None,
    llr_col_totals: np.ndarray | None = None,
    total: float | None = None,
    drop_diagonal: bool | None = None,
    chunk: int = 4096,
    device=None,
    mesh=None,
):
    """Fused cooc -> (optional LLR) -> per-row top-k, on ``device``
    (``mesh``: the sharded reader's CSRs, summed over the data axis).

    Returns ``(indices [items_p, k], values [items_p, k])`` like
    :func:`top_k_sparsify`. Providing ``llr_row_totals``/``llr_col_totals``
    (+ ``total``) applies the G^2 weighting before ranking; only the
    ``[items_p, k]`` indicator arrays come back to the host."""
    self_cooc = other is None or other is primary
    other = _normalize(primary, other)
    if (llr_row_totals is None) != (llr_col_totals is None):
        raise ValueError("provide both llr totals or neither")
    if llr_row_totals is not None and total is None:
        raise ValueError("LLR weighting needs the grand total")
    if drop_diagonal is None:
        drop_diagonal = self_cooc
    if drop_diagonal and primary.num_cols != other.num_cols:
        raise ValueError("drop_diagonal requires a square matrix")
    idx, vals = _run_cooc(
        primary,
        other,
        chunk,
        device,
        top_k=min(top_k, other.num_cols),
        llr=llr_row_totals is not None,
        drop_diagonal=drop_diagonal,
        total=float(total or 0.0),
        row_totals=llr_row_totals,
        col_totals=llr_col_totals,
        mesh=mesh,
    )
    return np.asarray(idx), np.asarray(vals)


def top_k_sparsify(matrix: np.ndarray, k: int, drop_diagonal: bool = True):
    """Keep the top-k entries per ROW -> (indices [n, k], values [n, k]).

    The serving-side 'indicator' form (reference UR keeps top-N correlators
    per item in Elasticsearch)."""
    m = matrix.copy()
    if drop_diagonal and m.shape[0] == m.shape[1]:
        np.fill_diagonal(m, -np.inf)
    k = min(k, m.shape[1])
    idx = np.argpartition(-m, k - 1, axis=1)[:, :k]
    vals = np.take_along_axis(m, idx, axis=1)
    order = np.argsort(-vals, axis=1)
    idx = np.take_along_axis(idx, order, axis=1)
    vals = np.take_along_axis(vals, order, axis=1)
    vals = np.where(np.isfinite(vals), vals, 0.0)
    return idx.astype(np.int32), vals.astype(np.float32)
