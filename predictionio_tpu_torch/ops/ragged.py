"""Ragged -> padded-block layout: the host-side packing step.

Copy of ``predictionio_tpu/ops/ragged.py``: COO interaction triples
become padded CSR blocks of static shape, the layout the ALS half-step
kernel (``ops/als_gram``) gathers from. As in the reference, the native
C++ packer (``predictionio_tpu_torch/native``: a row-bucket counting
sort) runs first, and the numpy path takes what it does not: the
``PIO_NATIVE=0`` knob, integer times at 2^53 or beyond, input it
rejects. A failed build of the native library raises
(``native.NativeBuildError``) instead of falling back. ``PACK_ROUTES``
counts each pack by route (``"native"`` / ``"numpy"``; an empty input
packs neither way). One departure on the numpy path: the (row, time)
order comes from two stable sorts (``_row_time_order``) instead of
``np.lexsort``; the permutation is the same.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from predictionio_tpu_torch import native

#: packs so far, by route: "native" (the C++ packer) or "numpy"
PACK_ROUTES: Counter = Counter()


def pack_routes() -> dict:
    """``{"native": packs, "numpy": packs}`` so far."""
    return {"native": PACK_ROUTES["native"], "numpy": PACK_ROUTES["numpy"]}


@dataclass
class PaddedCSR:
    """Padded row-major interactions.

    ``indices[r, l]`` is the column id of row ``r``'s ``l``-th interaction,
    ``values[r, l]`` its value; ``mask`` marks real entries. Rows with more
    than ``max_len`` interactions are truncated (most recent kept if
    timestamps were provided). ``indices`` of padding slots point at column
    ``num_cols`` -- callers append a zero row to factor matrices so gathers
    stay in-bounds without branching.
    """

    indices: np.ndarray  # int32 [rows, L]
    values: np.ndarray   # float32 [rows, L]
    mask: np.ndarray     # float32 [rows, L] (1.0 real, 0.0 pad)
    num_rows: int
    num_cols: int
    truncated: int       # number of interactions dropped by the cap

    @property
    def max_len(self) -> int:
        return self.indices.shape[1]


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _row_time_order(rows: np.ndarray, times: np.ndarray | None) -> np.ndarray:
    """``np.lexsort((times, rows))``: entries by row, each row's by time,
    ties in input order. The same permutation from two stable sorts:
    numpy's of the times (a merge sort that runs through presorted
    stretches, as event logs mostly are), then torch's of the rows in
    that order (several times numpy's for tens of millions of rows)."""
    first = None if times is None else np.argsort(times, kind="stable")
    keyed = rows if first is None else rows[first]
    dtype = np.int32 if int(keyed.max()) < 2**31 else np.int64
    second = torch.sort(torch.from_numpy(keyed.astype(dtype)), stable=True).indices.numpy()
    return second if first is None else first[second]


def pack_padded_csr(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    num_rows: int,
    num_cols: int,
    max_len: int | None = None,
    times: np.ndarray | None = None,
    len_multiple: int = 8,
    row_multiple: int = 8,
    pad_len: int | None = None,
) -> PaddedCSR:
    """COO (rows, cols, vals) -> PaddedCSR.

    - ``max_len`` caps per-row history (None = longest row).
    - ``times`` (same length) lets truncation keep the most recent entries.
    - lengths round up to ``len_multiple`` and rows to ``row_multiple`` so
      the arrays tile cleanly.
    - ``pad_len`` forces the padded length instead of deriving it from the
      data (every bucket of a side agrees on its block shape).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    if rows.size == 0:
        padded_rows = max(round_up(max(num_rows, 1), row_multiple), row_multiple)
        length = pad_len or len_multiple
        return PaddedCSR(
            indices=np.full((padded_rows, length), num_cols, dtype=np.int32),
            values=np.zeros((padded_rows, length), dtype=np.float32),
            mask=np.zeros((padded_rows, length), dtype=np.float32),
            num_rows=num_rows,
            num_cols=num_cols,
            truncated=0,
        )

    counts = np.bincount(rows, minlength=num_rows)
    natural_max = int(counts.max())
    if pad_len is not None:
        if natural_max > pad_len and not max_len:
            raise ValueError(
                f"pad_len={pad_len} is shorter than the longest row "
                f"({natural_max}) and no max_len truncation was requested"
            )
        length = pad_len
    else:
        length = min(natural_max, max_len) if max_len else natural_max
        length = max(round_up(length, len_multiple), len_multiple)

    padded_rows = max(round_up(num_rows, row_multiple), row_multiple)
    indices = np.full((padded_rows, length), num_cols, dtype=np.int32)
    values = np.zeros((padded_rows, length), dtype=np.float32)
    mask = np.zeros((padded_rows, length), dtype=np.float32)

    # the native pack: a row-bucket counting sort, O(n) against two sorts
    truncated = native.pack_padded_csr_native(
        rows, cols, vals, times, num_rows, length, padded_rows, num_cols,
        indices, values, mask,
    )
    if truncated is not None:
        PACK_ROUTES["native"] += 1
        return PaddedCSR(indices=indices, values=values, mask=mask, num_rows=num_rows,
                         num_cols=num_cols, truncated=truncated)

    PACK_ROUTES["numpy"] += 1
    order = _row_time_order(rows, None if times is None else np.asarray(times))
    rows, cols, vals = rows[order], cols[order], vals[order]

    # within-row position of each (already row-sorted, time-ascending) entry
    row_starts = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=row_starts[1:])
    pos_in_row = np.arange(rows.size) - row_starts[rows]
    # truncation keeps the LAST (most recent) `length` entries of each row
    keep_from = np.maximum(counts[rows] - length, 0)
    keep = pos_in_row >= keep_from
    slot = (pos_in_row - keep_from)[keep]
    r_kept, c_kept, v_kept = rows[keep], cols[keep], vals[keep]
    indices[r_kept, slot] = c_kept.astype(np.int32)
    values[r_kept, slot] = v_kept
    mask[r_kept, slot] = 1.0

    return PaddedCSR(
        indices=indices,
        values=values,
        mask=mask,
        num_rows=num_rows,
        num_cols=num_cols,
        truncated=int(rows.size - keep.sum()),
    )
