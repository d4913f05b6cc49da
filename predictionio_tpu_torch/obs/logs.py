"""Shared log formatting: plain text (default, unchanged) or JSON lines.

Copy of ``predictionio_tpu/obs/logs.py`` (framework-free), verbatim
after the package rename. ``--log-format json`` on the port's service
verbs (``eventserver``, ``train``, ``deploy``, ``retrain``) swaps the
root handler's formatter for :class:`JsonLogFormatter`: one JSON object
per record, with ``trace_id``/``span_id`` whenever the logging call
happens under an active span (``obs.trace``). The default text path
stays ``logging.basicConfig``.
"""

from __future__ import annotations

import json
import logging
import time

from predictionio_tpu_torch.obs import trace

LOG_FORMATS = ("text", "json")


class TraceContextFilter(logging.Filter):
    """Stamp ``trace_id``/``span_id`` (or None) onto every record so any
    formatter -- including user-supplied text formats with
    ``%(trace_id)s`` -- can reference them."""

    def filter(self, record: logging.LogRecord) -> bool:
        ctx = trace.current_context()
        record.trace_id = ctx[0] if ctx else None
        record.span_id = ctx[1] if ctx else None
        return True


class JsonLogFormatter(logging.Formatter):
    """One JSON object per record; trace ids only when a span is active."""

    def format(self, record: logging.LogRecord) -> str:
        obj = {
            "ts": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)
            ) + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        # the filter normally stamps these; resolve here too so the
        # formatter works on handlers without the filter attached
        ctx = (
            (record.__dict__.get("trace_id"), record.__dict__.get("span_id"))
            if "trace_id" in record.__dict__
            else (trace.current_context() or (None, None))
        )
        if ctx[0]:
            obj["trace_id"], obj["span_id"] = ctx[0], ctx[1]
        if record.exc_info:
            obj["exc"] = self.formatException(record.exc_info)
        return json.dumps(obj, default=str)


def configure_logging(log_format: str = "text", level: int | str = logging.INFO) -> None:
    """Install the chosen format on the root logger (service CLI entry).

    ``text`` keeps stdlib ``basicConfig`` behavior untouched; ``json``
    replaces the root handlers with one stderr handler emitting JSON
    lines (idempotent: calling twice reconfigures in place).
    """
    if log_format not in LOG_FORMATS:
        raise ValueError(
            f"log_format must be one of {LOG_FORMATS}, got {log_format!r}"
        )
    root = logging.getLogger()
    if log_format == "text":
        logging.basicConfig(level=level)
        return
    handler = logging.StreamHandler()
    handler.setFormatter(JsonLogFormatter())
    handler.addFilter(TraceContextFilter())
    root.handlers[:] = [handler]
    root.setLevel(level)


def add_logging_arguments(parser) -> None:
    """The shared ``--log-format`` flag every service CLI exposes."""
    parser.add_argument(
        "--log-format",
        choices=LOG_FORMATS,
        default="text",
        help="log output format: 'json' emits one JSON object per record"
        " with trace_id/span_id when a span is active (default: text,"
        " unchanged stdlib format)",
    )
