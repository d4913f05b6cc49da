"""Offline replay evaluation -- the DASE "E" pillar of the port.

``pio eval --replay`` cuts the event timeline at ``t`` (train ``< t``,
holdout ``>= t``), trains on the prefix (or rehydrates a pinned registry
generation), scores every held-out user in one batched ``batch_predict``
pass, and reports vectorized ranking metrics plus the standing
scan-vs-mips retrieval guard.

Copy of ``predictionio_tpu/eval/__init__.py`` (framework-free), verbatim after
the package rename.
"""

from predictionio_tpu_torch.eval.metrics import (
    DEFAULT_METRICS,
    METRIC_CATALOG,
    ranking_metrics,
    relevance_matrix,
    select_metrics,
)
from predictionio_tpu_torch.eval.replay import run_replay_eval
from predictionio_tpu_torch.eval.split import (
    ReplayFold,
    SplitBounds,
    SplitSpec,
    parse_split_time,
    resolve_split_seconds,
    split_interactions,
)

__all__ = [
    "DEFAULT_METRICS",
    "METRIC_CATALOG",
    "ReplayFold",
    "SplitBounds",
    "SplitSpec",
    "parse_split_time",
    "ranking_metrics",
    "relevance_matrix",
    "resolve_split_seconds",
    "run_replay_eval",
    "select_metrics",
    "split_interactions",
]
