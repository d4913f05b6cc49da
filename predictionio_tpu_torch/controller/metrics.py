"""Evaluation API: Metric combinators + MetricEvaluator.

Port of ``predictionio_tpu/controller/metrics.py`` (framework-free):
``Metric`` with ``calculate``; the Average/OptionAverage/Stdev/Sum/Zero
combinators; ``Evaluation``, ``EngineParamsGenerator`` and the
``MetricEvaluator`` that runs an EngineParams grid and prints a
leaderboard. The one departure: an ``Evaluation`` binds the port's
``Template`` (``controller/engine.py``), not an ``Engine``, and each
candidate runs through ``controller/engine.py::evaluate`` (the
counterpart of ``Engine.eval``).
"""

from __future__ import annotations

import abc
import json
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from predictionio_tpu_torch.controller.engine import EngineParams, Template, evaluate


class Metric(abc.ABC):
    """Computes a score over per-fold (query, prediction, actual) triples."""

    #: larger is better by default; metrics may flip this
    higher_is_better: bool = True

    @abc.abstractmethod
    def calculate(
        self, per_fold: Sequence[tuple[Any, Sequence[tuple[Any, Any, Any]]]]
    ) -> float: ...

    def header(self) -> str:
        return type(self).__name__

    def compare(self, a: float, b: float) -> int:
        if a == b:
            return 0
        better = a > b if self.higher_is_better else a < b
        return 1 if better else -1


class _PointwiseMetric(Metric):
    """Base for metrics that score each (q, p, a) triple independently."""

    def __init__(self, score: Callable[[Any, Any, Any, Any], Optional[float]] | None = None):
        if score is not None:
            self._score = score

    def score(self, eval_info, query, prediction, actual) -> Optional[float]:
        return self._score(eval_info, query, prediction, actual)

    def _all_scores(self, per_fold) -> list[Optional[float]]:
        return [
            self.score(eval_info, q, p, a)
            for eval_info, triples in per_fold
            for q, p, a in triples
        ]


class AverageMetric(_PointwiseMetric):
    """Mean of per-triple scores (None scores count as 0 -- use
    OptionAverageMetric to skip them)."""

    def calculate(self, per_fold) -> float:
        scores = [s if s is not None else 0.0 for s in self._all_scores(per_fold)]
        return sum(scores) / len(scores) if scores else float("nan")


class OptionAverageMetric(_PointwiseMetric):
    """Mean of non-None per-triple scores."""

    def calculate(self, per_fold) -> float:
        scores = [s for s in self._all_scores(per_fold) if s is not None]
        return sum(scores) / len(scores) if scores else float("nan")


class StdevMetric(_PointwiseMetric):
    """Population standard deviation of per-triple scores."""

    def calculate(self, per_fold) -> float:
        scores = [s if s is not None else 0.0 for s in self._all_scores(per_fold)]
        if not scores:
            return float("nan")
        mean = sum(scores) / len(scores)
        return math.sqrt(sum((s - mean) ** 2 for s in scores) / len(scores))


class SumMetric(_PointwiseMetric):
    """Sum of per-triple scores."""

    def calculate(self, per_fold) -> float:
        return float(sum(s for s in self._all_scores(per_fold) if s is not None))


class ZeroMetric(Metric):
    """Always 0 (placeholder, reference parity)."""

    def calculate(self, per_fold) -> float:
        return 0.0


@dataclass
class Evaluation:
    """Binds a template to metrics (reference Evaluation, whose ``engine``
    is an ``Engine``; the port's templates are ``controller/engine.py``'s
    ``Template`` objects, e.g. ``TEMPLATES["sequence"]``).

    ``metric`` drives parameter selection; ``metrics`` (optional extras) are
    reported alongside.
    """

    template: Template
    metric: Metric
    metrics: list[Metric] = field(default_factory=list)


class EngineParamsGenerator:
    """Supplies the grid of candidate EngineParams (reference parity)."""

    def __init__(self, engine_params_list: Sequence[EngineParams]):
        self.engine_params_list = list(engine_params_list)


@dataclass
class MetricEvaluatorResult:
    best_score: float
    best_engine_params: EngineParams
    best_index: int
    #: per-candidate: (engine_params, primary score, extra metric scores)
    results: list[tuple[EngineParams, float, list[float]]]

    def leaderboard(self, metric: Metric, extras: Sequence[Metric]) -> str:
        lines = ["Metric Evaluator leaderboard:", ""]
        header = [metric.header()] + [m.header() for m in extras]
        for i, (params, score, extra_scores) in enumerate(self.results):
            marker = " <= BEST" if i == self.best_index else ""
            scores = ", ".join(
                f"{h}={s:.6f}" for h, s in zip(header, [score] + list(extra_scores))
            )
            lines.append(f"  [{i}] {scores}{marker}")
            lines.append(f"      params: {json.dumps(params.to_json_obj())}")
        return "\n".join(lines)

    def to_json(self, metric: Metric, extras: Sequence[Metric]) -> str:
        return json.dumps(
            {
                "bestScore": self.best_score,
                "bestIndex": self.best_index,
                "bestEngineParams": self.best_engine_params.to_json_obj(),
                "metric": metric.header(),
                "results": [
                    {
                        "engineParams": p.to_json_obj(),
                        "score": s,
                        "extraScores": dict(
                            zip([m.header() for m in extras], extra)
                        ),
                    }
                    for p, s, extra in self.results
                ],
            }
        )


class MetricEvaluator:
    """Runs the template over each candidate EngineParams and ranks by
    metric (reference MetricEvaluator + NameParamsEvaluator role).
    ``ctx`` is a ``TrainContext``: its device is where every fold
    trains and scores."""

    def __init__(self, evaluation: Evaluation):
        self.evaluation = evaluation

    def run(self, ctx, generator: EngineParamsGenerator) -> MetricEvaluatorResult:
        if not generator.engine_params_list:
            raise ValueError("engine params generator produced no candidates")
        metric = self.evaluation.metric
        extras = self.evaluation.metrics
        results = []
        best_index, best_score = 0, None
        for i, engine_params in enumerate(generator.engine_params_list):
            if not isinstance(engine_params, EngineParams):
                raise TypeError(
                    f"candidate {i} is a {type(engine_params).__module__}."
                    f"{type(engine_params).__name__}, not the port's EngineParams"
                )
            per_fold = evaluate(self.evaluation.template, ctx, engine_params)
            score = metric.calculate(per_fold)
            extra_scores = [m.calculate(per_fold) for m in extras]
            results.append((engine_params, score, extra_scores))
            if best_score is None or metric.compare(score, best_score) > 0:
                best_index, best_score = i, score
        return MetricEvaluatorResult(
            best_score=best_score,
            best_engine_params=results[best_index][0],
            best_index=best_index,
            results=results,
        )
