"""Vectorized ranking metrics over one batched prediction pass.

The scoring pass is the templates' ``batch_predict`` (one device/matmul
pass over every held-out user); this module reduces its ranked lists to
hit-rate@k / NDCG@k / MRR / recall@k in a handful of whole-array numpy
ops -- there is no per-user python scoring loop anywhere in the replay
path. All accumulation is float64, and ``tests/test_eval.py`` pins the
results to a plain per-user oracle at 1e-9.

Ids are opaque strings (predicted lists come straight out of
``itemScores``), encoded on the fly so metrics work identically for
in-process-trained models and pinned registry generations whose item
vocabulary differs from the live store's.

Copy of ``predictionio_tpu/eval/metrics.py`` (framework-free), verbatim after
the package rename.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np

#: metric name -> definition, the ``pio eval`` catalog (printed on an
#: unknown-metric error, the ``pio check --rules`` exit-2 contract)
METRIC_CATALOG: Mapping[str, str] = {
    "hit_rate": "fraction of held-out users with >=1 held-out item in"
                " their top-k",
    "ndcg": "normalized discounted cumulative gain@k (binary relevance,"
            " log2 position discount, ideal = all holdouts up front)",
    "mrr": "mean reciprocal rank of each user's FIRST held-out hit"
           " (0 when the top-k misses entirely)",
    "recall": "mean fraction of each user's held-out items recovered in"
              " the top-k",
}

DEFAULT_METRICS: tuple[str, ...] = tuple(METRIC_CATALOG)


def select_metrics(names: Iterable[str] | str | None = None) -> tuple[str, ...]:
    """Validate a metric selection against the catalog.

    Accepts a comma-separated string or an iterable; None/empty selects
    everything. Unknown names raise ``ValueError`` carrying the full
    catalog -- the CLI surfaces it verbatim and exits 2.
    """
    if names is None:
        return DEFAULT_METRICS
    if isinstance(names, str):
        names = [n.strip() for n in names.split(",") if n.strip()]
    wanted = [str(n).lower() for n in names]
    if not wanted:
        return DEFAULT_METRICS
    unknown = sorted(set(wanted) - set(METRIC_CATALOG))
    if unknown:
        raise ValueError(
            f"unknown metric(s): {unknown} (known: {sorted(METRIC_CATALOG)})"
        )
    # catalog order, deduplicated -- reports stay stably keyed
    seen = set(wanted)
    return tuple(n for n in METRIC_CATALOG if n in seen)


def _encode(
    predicted: Sequence[Sequence], actual: Sequence[Iterable], k: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(ranked [U, k] codes with -1 padding, per-user holdout sizes,
    sorted (user, item) pair codes of the holdout sets, code width)."""
    codes: dict = {}
    u_count = len(predicted)
    ranked = np.full((u_count, k), -1, np.int64)
    for u, row in enumerate(predicted):
        for j, item in enumerate(row[:k]):
            c = codes.get(item)
            if c is None:
                c = len(codes)
                codes[item] = c
            ranked[u, j] = c
    n_actual = np.zeros(u_count, np.int64)
    pair_rows, pair_cols = [], []
    for u, row in enumerate(actual):
        uniq = set(row)
        n_actual[u] = len(uniq)
        for item in uniq:
            c = codes.get(item)
            if c is None:
                c = len(codes)
                codes[item] = c
            pair_rows.append(u)
            pair_cols.append(c)
    width = max(len(codes), 1)
    pairs = (
        np.asarray(pair_rows, np.int64) * width
        + np.asarray(pair_cols, np.int64)
        if pair_rows else np.empty(0, np.int64)
    )
    pairs.sort()
    return ranked, n_actual, pairs, width


def relevance_matrix(
    predicted: Sequence[Sequence], actual: Sequence[Iterable], k: int
) -> tuple[np.ndarray, np.ndarray]:
    """(rel [U, k] bool, n_actual [U]): whether each ranked slot is one
    of its user's held-out items -- ONE searchsorted over the whole
    batch, the membership kernel every metric reduces."""
    ranked, n_actual, pairs, width = _encode(predicted, actual, k)
    flat = np.arange(len(predicted), dtype=np.int64)[:, None] * width + ranked
    pos = np.searchsorted(pairs, flat.ravel())
    pos = np.minimum(pos, max(pairs.size - 1, 0))
    hit = (
        pairs[pos] == flat.ravel()
        if pairs.size else np.zeros(flat.size, bool)
    )
    rel = hit.reshape(ranked.shape) & (ranked >= 0)
    return rel, n_actual


def ranking_metrics(
    predicted: Sequence[Sequence],
    actual: Sequence[Iterable],
    k: int,
    metrics: Iterable[str] | str | None = None,
) -> dict[str, float | None]:
    """Selected metrics over one batch of ranked lists.

    ``predicted[u]`` is user ``u``'s ranked item ids (best first, may be
    shorter than ``k``); ``actual[u]`` their held-out ids. An empty batch
    returns every metric as None (the empty-holdout report stays honest
    instead of inventing zeros).
    """
    names = select_metrics(metrics)
    if len(predicted) != len(actual):
        raise ValueError(
            f"predicted ({len(predicted)}) and actual ({len(actual)})"
            " user counts differ"
        )
    if not predicted:
        return {name: None for name in names}
    rel, n_actual = relevance_matrix(predicted, actual, k)
    hits = rel.sum(axis=1)
    out: dict[str, float | None] = {}
    if "hit_rate" in names:
        out["hit_rate"] = float((hits > 0).mean())
    if "ndcg" in names:
        discount = 1.0 / np.log2(np.arange(k, dtype=np.float64) + 2.0)
        dcg = (rel * discount).sum(axis=1)
        ideal_cum = np.concatenate([[0.0], np.cumsum(discount)])
        idcg = ideal_cum[np.minimum(n_actual, k)]
        out["ndcg"] = float(
            np.where(idcg > 0, dcg / np.maximum(idcg, 1e-300), 0.0).mean()
        )
    if "mrr" in names:
        first = np.argmax(rel, axis=1)  # 0 when no hit; masked below
        out["mrr"] = float(
            np.where(hits > 0, 1.0 / (first + 1.0), 0.0).mean()
        )
    if "recall" in names:
        out["recall"] = float(
            np.where(n_actual > 0, hits / np.maximum(n_actual, 1), 0.0).mean()
        )
    return {name: out[name] for name in names}
