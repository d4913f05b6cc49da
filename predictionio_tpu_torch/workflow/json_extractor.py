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
absent here; the reference requires it. ``resolve_dotted`` (a copy of
the reference's ``:68-100``) resolves what ``pio eval`` names: a user's
``Evaluation`` and ``EngineParamsGenerator``.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
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


def resolve_dotted(dotted: str, engine_dir: str | None = None):
    """The dotted-path resolver (evaluations, params generators): walks
    nested qualnames, prepends the engine directory to ``sys.path``,
    raises EngineConfigError on failure."""
    if engine_dir and engine_dir not in sys.path:
        sys.path.insert(0, engine_dir)
    module_path, _, attr_path = dotted.rpartition(".")
    if not module_path:
        raise EngineConfigError(f"{dotted!r} must be a dotted module path")
    # qualnames may nest (Outer.Inner): retry shorter module prefixes
    probe = module_path
    while True:
        try:
            obj = importlib.import_module(probe)
            break
        except ModuleNotFoundError as exc:
            if "." not in probe:
                raise EngineConfigError(
                    f"cannot import module for {dotted!r}: {exc}"
                ) from exc
            probe, _, rest = probe.rpartition(".")
            attr_path = f"{rest}.{attr_path}"
    for part in attr_path.split("."):
        try:
            obj = getattr(obj, part)
        except AttributeError:
            raise EngineConfigError(
                f"{probe!r} has no attribute path {attr_path!r}"
            ) from None
    return obj
