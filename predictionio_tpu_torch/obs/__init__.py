"""Observability substrate of the port: the span tracer.

Counterpart of ``predictionio_tpu/obs/__init__.py``: ``obs.trace`` (a
copy of the reference's low-overhead span tracer, W3C ``traceparent``
in and out, bounded ring buffers, ``GET /traces.json`` on every service
router) with the same re-exports. The structured logs, the training
telemetry journal and ``pio top`` are ROADMAP.md Queue A item 5.
"""

from predictionio_tpu_torch.obs.trace import (  # noqa: F401
    NULL_TRACER,
    Tracer,
    current_context,
    format_traceparent,
    global_tracer,
    parse_traceparent,
)
