"""engine.json loading + engine factory resolution.

Port of ``predictionio_tpu/workflow/json_extractor.py``: ``EngineVariant``
and ``load_engine_variant`` (the parsed engine.json, its identity --
``id``, version, absolute path: what an engine instance records and
``deploy`` resolves by -- and its ``sparkConf`` / ``runtimeConf`` as the
runtime conf), ``resolve_dotted``, ``resolve_engine_factory`` and
``build_engine`` (``:66-115``): ``engineFactory`` is a dotted path,
imported with the engine directory on ``sys.path``, to a callable
returning the port's ``Engine``. ``template_engine`` is a ported
template's engine, by the template's name.

What the port does of its own:

- An ``engineFactory`` of the JAX package's templates,
  ``predictionio_tpu.models.<template>.engine_factory`` (or its module
  path ``...<template>.engine.engine_factory``), resolves to the port's
  ``predictionio_tpu_torch.models.<template>.engine_factory``, so the
  ``examples/*/engine.json`` files serve both packages; no other path
  into the JAX package is imported.
- ``engineFactory`` may be absent: the template is then the one whose
  engine has an algorithm of the first block's name.
- A factory that returns anything but the port's ``Engine`` (the JAX
  package's, say) raises ``EngineConfigError`` naming both classes.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any

from predictionio_tpu_torch.controller.engine import Engine, EngineParams

#: the ported templates, by their package under ``predictionio_tpu_torch/models``
TEMPLATES = ("recommendation", "ncf", "sequence", "ecommerce", "similarproduct",
             "universal", "classification")


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
    """The one dotted-path resolver (factories, persistent model classes,
    evaluations): walks nested qualnames, prepends the engine directory to
    ``sys.path`` (parity role of the reference's engine-assembly classpath
    assembly in Runner.scala), raises EngineConfigError on failure.
    """
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


def resolve_engine_factory(dotted: str, engine_dir: str | None = None):
    """``resolve_dotted`` of an ``engineFactory``; a path of the JAX
    package's templates resolves to the port's own."""
    parts = dotted.split(".")
    if parts[0] == "predictionio_tpu":
        template = parts[2] if len(parts) > 2 and parts[1] == "models" else None
        if template not in TEMPLATES or parts[3:] not in (
                ["engine_factory"], ["engine", "engine_factory"]):
            raise EngineConfigError(
                f"engineFactory {dotted!r} names the JAX package, which the port never "
                f"imports; of it the port resolves its templates' factories "
                f"(predictionio_tpu.models.<template>.engine_factory, {', '.join(TEMPLATES)})"
            )
        dotted = _template_factory(template)
    return resolve_dotted(dotted, engine_dir)


def _template_factory(template: str) -> str:
    return f"predictionio_tpu_torch.models.{template}.engine_factory"


def template_engine(template: str) -> Engine:
    """The port's engine of a ported template (its ``engine_factory``)."""
    return resolve_dotted(_template_factory(template))()


def _factory_path(variant: EngineVariant) -> str:
    """The variant's ``engineFactory``, or without one the factory of the
    ported template whose engine has the first algorithm block's name."""
    if variant.engine_factory:
        return variant.engine_factory
    first = variant.engine_params.algorithm_params_list[0][0]
    names = {}
    for template in TEMPLATES:
        for name in template_engine(template).algorithm_class_map:
            names.setdefault(name, _template_factory(template))
    if first not in names:
        raise EngineConfigError(
            f"{variant.path} names no engineFactory, and {first!r} is no algorithm of a "
            f"ported template ({sorted(names)})"
        )
    return names[first]


def build_engine(variant: EngineVariant) -> Engine:
    factory = resolve_engine_factory(_factory_path(variant), variant.engine_dir)
    engine = factory() if callable(factory) else factory
    if hasattr(engine, "apply") and not isinstance(engine, Engine):
        engine = engine.apply()
    if not isinstance(engine, Engine):
        cls = type(engine)
        raise EngineConfigError(
            f"engineFactory {variant.engine_factory!r} returned"
            f" {cls.__module__}.{cls.__qualname__}, expected"
            f" {Engine.__module__}.{Engine.__qualname__}"
        )
    return engine
