"""Observability substrate of the port: tracing, structured logs,
training telemetry, ``pio top``.

Counterpart of ``predictionio_tpu/obs/__init__.py``, with the same
re-exports. Every module is a copy of the reference's (framework-free):

- ``obs.trace``     -- the low-overhead span tracer (W3C ``traceparent``
  in and out, bounded ring buffers, ``GET /traces.json`` on every
  service router).
- ``obs.logs``      -- ``--log-format json``: one JSON object per record,
  with ``trace_id``/``span_id`` when a span is active.
- ``obs.telemetry`` -- the per-step training journal behind ``pio train
  --profile`` (wall time, edges/sec, modeled-bytes achieved GB/s).
- ``obs.top``       -- the ``pio top`` live terminal view over
  ``/metrics`` + ``/traces.json``.
"""

from predictionio_tpu_torch.obs.trace import (  # noqa: F401
    NULL_TRACER,
    Tracer,
    current_context,
    format_traceparent,
    global_tracer,
    parse_traceparent,
)
