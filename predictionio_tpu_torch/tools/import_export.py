"""``pio import`` / ``pio export``: bulk event transfer.

Behavioral model: reference ``tools/.../imprt/FileToEvents.scala`` +
``tools/.../export/EventsToFile.scala`` (apache/predictionio layout,
unverified -- SURVEY.md section 2.4 #30). Formats match the reference:
JSON-lines (one event JSON object per line, identical to the REST wire
shape) for both directions, plus parquet export (EventsToFile's second
format; pyarrow). Import additionally accepts parquet files produced by
the exporter, so export -> import round-trips either format.

Port copy: ``predictionio_tpu/tools/import_export.py`` (framework-free),
verbatim, under the port's package name; ``tests/test_torch_imports.py``
holds it to the original.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Iterator

from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.event import Event, EventValidationError

#: parquet columns, in the wire-contract field names. `properties` is the
#: JSON-encoded object (parquet nesting buys nothing for a free-form map).
_PARQUET_FIELDS = (
    "eventId", "event", "entityType", "entityId", "targetEntityType",
    "targetEntityId", "properties", "eventTime", "prId", "creationTime",
)


def register(sub: argparse._SubParsersAction) -> None:
    imp = sub.add_parser("import", help="import events into an app")
    imp.add_argument("--appid", type=int, required=True)
    imp.add_argument("--channel", default=None)
    imp.add_argument("--input", required=True)
    imp.add_argument(
        "--format", choices=["json", "parquet"], default=None,
        help="default: parquet when --input ends with .parquet, else json-lines",
    )
    imp.set_defaults(func=cmd_import)

    exp = sub.add_parser("export", help="export an app's events to a file")
    exp.add_argument("--appid", type=int, required=True)
    exp.add_argument("--channel", default=None)
    exp.add_argument("--output", required=True)
    exp.add_argument("--format", choices=["json", "parquet"], default="json")
    exp.set_defaults(func=cmd_export)


def _channel_id(app_id: int, channel_name: str | None) -> int | None:
    if channel_name is None:
        return None
    for ch in storage.get_meta_data_channels().get_by_app(app_id):
        if ch.name == channel_name:
            return ch.id
    raise SystemExit(f"Error: channel {channel_name!r} not found in app {app_id}")


def _pyarrow():
    try:
        import pyarrow
        import pyarrow.parquet
    except ImportError as exc:  # baked into most images; be clear when not
        raise SystemExit(
            "Error: parquet format requires pyarrow; use --format json"
        ) from exc
    return pyarrow


def _iter_parquet_rows(path: str) -> Iterator[tuple[int, dict]]:
    """(row_number, raw-row-dict) pairs from an exported parquet file.

    `properties` stays a JSON STRING here: decoding happens in the
    consumer's per-row try block, so one bad cell is a counted rejection
    rather than an exception out of the for-statement that aborts the
    whole import mid-way."""
    pa = _pyarrow()
    f = pa.parquet.ParquetFile(path)
    rowno = 0
    for batch in f.iter_batches(batch_size=5000):
        for row in batch.to_pylist():
            rowno += 1
            yield rowno, {k: v for k, v in row.items() if v is not None}


def _iter_json_lines(path: str) -> Iterator[tuple[int, str]]:
    """(line_number, raw-json-line) pairs; parsing stays with the caller so
    a bad line is a per-row error, not an aborted import."""
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if line:
                yield lineno, line


def cmd_import(args: argparse.Namespace) -> int:
    if storage.get_meta_data_apps().get(args.appid) is None:
        print(f"Error: app id {args.appid} does not exist.")
        return 1
    channel_id = _channel_id(args.appid, args.channel)
    le = storage.get_l_events()
    le.init_channel(args.appid, channel_id)
    imported = errors = 0
    batch: list[Event] = []

    def flush():
        nonlocal imported
        if batch:
            le.batch_insert(batch, args.appid, channel_id)
            imported += len(batch)
            batch.clear()

    fmt = args.format or (
        "parquet" if args.input.endswith(".parquet") else "json"
    )
    rows = _iter_parquet_rows(args.input) if fmt == "parquet" else _iter_json_lines(args.input)
    for lineno, raw in rows:
        try:
            obj = json.loads(raw) if isinstance(raw, str) else dict(raw)
            if isinstance(obj.get("properties"), str):  # parquet cell
                obj["properties"] = json.loads(obj["properties"])
            batch.append(Event.from_json_obj(obj))
        except (json.JSONDecodeError, EventValidationError) as exc:
            errors += 1
            print(f"  row {lineno}: {exc}", file=sys.stderr)
            continue
        if len(batch) >= 5000:
            flush()
    flush()
    print(f"Imported {imported} events" + (f" ({errors} rejected)" if errors else "") + ".")
    return 0 if errors == 0 else 1


def cmd_export(args: argparse.Namespace) -> int:
    if storage.get_meta_data_apps().get(args.appid) is None:
        print(f"Error: app id {args.appid} does not exist.")
        return 1
    channel_id = _channel_id(args.appid, args.channel)
    events = storage.get_l_events().find(args.appid, channel_id)
    if args.format == "parquet":
        count = _export_parquet(events, args.output)
    else:
        count = 0
        with open(args.output, "w") as f:
            for event in events:
                f.write(json.dumps(event.to_json_obj()) + "\n")
                count += 1
    print(f"Exported {count} events to {args.output}.")
    return 0


def _export_parquet(events, output: str) -> int:
    pa = _pyarrow()
    schema = pa.schema([(name, pa.string()) for name in _PARQUET_FIELDS])
    count = 0
    with pa.parquet.ParquetWriter(output, schema) as writer:
        chunk: list[dict] = []

        def flush():
            nonlocal count
            if chunk:
                writer.write_table(
                    pa.Table.from_pylist(chunk, schema=schema)
                )
                count += len(chunk)
                chunk.clear()

        for event in events:
            obj = event.to_json_obj()
            row = {name: obj.get(name) for name in _PARQUET_FIELDS}
            if row.get("properties") is not None:
                row["properties"] = json.dumps(row["properties"])
            chunk.append(row)
            if len(chunk) >= 5000:
                flush()
        flush()
    return count
