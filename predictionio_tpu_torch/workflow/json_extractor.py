"""engine.json loading.

Copy of ``EngineVariant`` and ``load_engine_variant``
(``predictionio_tpu/workflow/json_extractor.py:26-62``): the parsed
engine.json, its identity (``id``, version, absolute path: what an
engine instance records and ``deploy`` resolves by) and its
``sparkConf`` / ``runtimeConf`` as the runtime conf.

The reference resolves ``engineFactory`` by importing it (``:64-110``),
which would import the JAX package's template. The port never does:
``template`` maps the factory path (or, without one, the first
algorithm's name) to the port's own template
(``controller/engine.py::template_for``). So ``engineFactory`` may be
absent here; the reference requires it.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any

from predictionio_tpu_torch.controller.engine import (
    EngineParams,
    Template,
    template_for,
)


class EngineConfigError(ValueError):
    pass


@dataclass
class EngineVariant:
    """Parsed engine.json."""

    path: str
    engine_dir: str
    variant_id: str
    description: str
    engine_factory: str
    engine_params: EngineParams
    runtime_conf: dict[str, Any] = field(default_factory=dict)

    @property
    def engine_version(self) -> str:
        return "1"

    @property
    def template(self) -> Template:
        """The port's template of this engine.json."""
        algorithms = self.engine_params.algorithm_params_list
        if not algorithms:
            raise EngineConfigError(f"{self.path} names no algorithms")
        return template_for(self.engine_factory, algorithms[0][0])


def load_engine_variant(path: str) -> EngineVariant:
    if not os.path.exists(path):
        raise EngineConfigError(f"engine variant file not found: {path}")
    with open(path) as f:
        try:
            obj = json.load(f)
        except json.JSONDecodeError as exc:
            raise EngineConfigError(f"{path} is not valid JSON: {exc}") from exc
    if not obj.get("algorithms"):
        raise EngineConfigError(f"{path} names no algorithms")
    runtime_conf = obj.get("sparkConf", {}) | obj.get("runtimeConf", {})
    return EngineVariant(
        path=os.path.abspath(path),
        engine_dir=os.path.dirname(os.path.abspath(path)),
        variant_id=obj.get("id", "default"),
        description=obj.get("description", ""),
        engine_factory=obj.get("engineFactory", ""),
        engine_params=EngineParams.from_json_obj(obj),
        runtime_conf=runtime_conf,
    )
