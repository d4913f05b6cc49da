"""``pio top``: live terminal view over ``/metrics`` + ``/traces.json``.

Copy of ``predictionio_tpu/obs/top.py`` (framework-free, stdlib only),
verbatim after the package rename. Polls one or more services and
renders, per poll interval: request rate (qps), error rate, latency
quantiles (p50/p99 from the ``pio_http_request_duration_seconds``
histogram DELTA between polls), ingest queue depth, micro-batch
occupancy, and the current slowest traces. ``parse_prometheus``,
``compute_stats`` and ``render`` are pure functions.
"""

from __future__ import annotations

import json
import re
import time
import urllib.request

_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> dict[str, dict[tuple, float]]:
    """Prometheus text exposition -> ``{name: {label-kv-tuple: value}}``."""
    out: dict[str, dict[tuple, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, labels_raw, value = m.group(1), m.group(2) or "", m.group(3)
        labels = tuple(
            (k, v.replace('\\"', '"').replace("\\\\", "\\"))
            for k, v in _LABEL_RE.findall(labels_raw)
        )
        try:
            out.setdefault(name, {})[labels] = float(value)
        except ValueError:
            continue
    return out


def fetch_snapshot(url: str, timeout: float = 3.0) -> dict:
    """One poll of a service: parsed /metrics + /traces.json (either may
    be missing; a dead endpoint yields an ``error`` entry, not a crash)."""
    snap: dict = {"url": url, "time": time.perf_counter()}
    try:
        with urllib.request.urlopen(f"{url}/metrics", timeout=timeout) as r:
            snap["metrics"] = parse_prometheus(r.read().decode("utf-8"))
    except Exception as exc:
        snap["metrics"] = None
        snap["error"] = f"/metrics: {exc}"
    try:
        with urllib.request.urlopen(
            f"{url}/traces.json?limit=5", timeout=timeout
        ) as r:
            snap["traces"] = json.loads(r.read().decode("utf-8"))
    except Exception:
        snap["traces"] = None
    return snap


#: routes `pio top` itself hits every poll -- excluded from qps/error/latency
#: or an idle service would show nothing but the tool's own scrape traffic
_SELF_ROUTES = frozenset(("/metrics", "/traces.json"))


def _total(series: dict[tuple, float] | None, **match: str) -> float:
    if not series:
        return 0.0
    total = 0.0
    for labels, value in series.items():
        d = dict(labels)
        if all(d.get(k) == v for k, v in match.items()):
            total += value
    return total


def _histogram_delta(prev: dict, cur: dict, name: str) -> list[tuple[float, float]]:
    """Sorted ``(le, cumulative-count-delta)`` for one histogram, buckets
    summed across label sets (routes)."""
    pb = (prev or {}).get(f"{name}_bucket", {})
    cb = (cur or {}).get(f"{name}_bucket", {})
    by_le: dict[float, float] = {}
    for labels, value in cb.items():
        d = dict(labels)
        le = d.get("le")
        if le is None or d.get("route") in _SELF_ROUTES:
            continue
        le_f = float("inf") if le == "+Inf" else float(le)
        by_le[le_f] = by_le.get(le_f, 0.0) + value - pb.get(labels, 0.0)
    return sorted(by_le.items())


def _quantile_ms(buckets: list[tuple[float, float]], q: float) -> float | None:
    """Linear-interpolated quantile (ms) from cumulative bucket deltas --
    the standard histogram_quantile() estimate."""
    if not buckets:
        return None
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = q * total
    lo_le, lo_count = 0.0, 0.0
    for le, count in buckets:
        if count >= rank:
            if le == float("inf"):
                return round(lo_le * 1000.0, 2)  # open bucket: lower bound
            span = count - lo_count
            frac = (rank - lo_count) / span if span > 0 else 1.0
            return round((lo_le + (le - lo_le) * frac) * 1000.0, 2)
        lo_le, lo_count = le, count
    return round(lo_le * 1000.0, 2)


def compute_stats(prev: dict, cur: dict) -> dict:
    """Point-in-time stats for one service from two consecutive snapshots."""
    stats: dict = {"url": cur["url"]}
    if cur.get("error"):
        stats["error"] = cur["error"]
        return stats
    pm, cm = prev.get("metrics") or {}, cur.get("metrics") or {}
    dt = max(cur["time"] - prev["time"], 1e-9)
    req = {
        k: v
        for k, v in cm.get("pio_http_requests_total", {}).items()
        if dict(k).get("route") not in _SELF_ROUTES
    }
    preq = pm.get("pio_http_requests_total", {})
    d_total = sum(v - preq.get(k, 0.0) for k, v in req.items())
    d_err = sum(
        v - preq.get(k, 0.0)
        for k, v in req.items()
        if dict(k).get("status", "").startswith(("4", "5"))
    )
    stats["qps"] = round(d_total / dt, 1)
    stats["error_rate"] = round(d_err / d_total, 4) if d_total > 0 else 0.0
    lat = _histogram_delta(pm, cm, "pio_http_request_duration_seconds")
    stats["p50_ms"] = _quantile_ms(lat, 0.50)
    stats["p99_ms"] = _quantile_ms(lat, 0.99)
    depth = cm.get("pio_ingest_queue_depth")
    if depth:
        stats["ingest_queue_depth"] = int(sum(depth.values()))
    serving_depth = cm.get("pio_serving_queue_depth")
    if serving_depth:
        stats["ingest_queue_depth"] = stats.get(
            "ingest_queue_depth", 0
        ) + int(sum(serving_depth.values()))
    wpr = cm.get("pio_scorer_wakeups_per_request")
    if wpr:
        # the scorer's measured dispatch cost: cross-thread wakeups per
        # query (async fast path <= 2, sync dispatcher chain ~4)
        stats["wakeups_per_request"] = round(max(wpr.values()), 2)
    workers = cm.get("pio_frontend_workers")
    if workers:
        # the multi-process serving tier: configured frontend count plus
        # the per-worker forwarded totals (aggregated across processes)
        stats["frontend_workers"] = int(sum(workers.values()))
        fw_req = cm.get("pio_frontend_requests_total", {})
        pfw_req = pm.get("pio_frontend_requests_total", {})
        # clamp per series: a respawned worker restarts its counters at
        # zero while the scrape stays healthy, so an un-clamped delta
        # would render a large negative qps for that poll interval
        d_fw = sum(
            max(v - pfw_req.get(k, 0.0), 0.0) for k, v in fw_req.items()
        )
        stats["frontend_qps"] = round(d_fw / dt, 1)
    parts = cm.get("pio_ingest_partitions")
    if parts:
        # the partitioned ingest tier: WAL partition count in the PART
        # column (per-partition queue depth and commit latency live in
        # pio_ingest_partition_depth{part=} / pio_ingest_commit_seconds{part=})
        stats["wal_partitions"] = int(max(parts.values()))
    shards = cm.get("pio_scorer_shard_count")
    if shards:
        # the sharded serving fabric: scorer shard count in the SHARD
        # column. pio_model_version carries a shard label there, so the
        # MODEL column below (max across series) briefly leads by one
        # version mid-swap -- exactly the fabric's allowed skew window
        stats["scorer_shards"] = int(max(shards.values()))
    # continuous-learning gauges (pio retrain --follow): which model
    # version is live, how long ago it swapped in, and how many seconds of
    # ingested events are not yet reflected in it
    mv = cm.get("pio_model_version")
    if mv:
        stats["model_version"] = int(max(mv.values()))
    swap_ts = cm.get("pio_model_last_swap_timestamp_seconds")
    if swap_ts:
        stats["swap_age_s"] = round(max(0.0, time.time() - max(swap_ts.values())), 1)
    lag = cm.get("pio_foldin_lag_seconds")
    if lag:
        stats["foldin_lag_s"] = round(max(lag.values()), 1)
    d_batches = _total(cm.get("pio_serving_batch_size_count")) - _total(
        pm.get("pio_serving_batch_size_count")
    )
    d_batched = _total(cm.get("pio_serving_batch_size_sum")) - _total(
        pm.get("pio_serving_batch_size_sum")
    )
    if d_batches > 0:
        stats["batch_occupancy"] = round(d_batched / d_batches, 2)
    build = cm.get("pio_build_info")
    if build:
        stats["build"] = dict(next(iter(build)))
    return stats


def _fmt(value, suffix: str = "") -> str:
    return "-" if value is None else f"{value}{suffix}"


def render(stats_list: list[dict], snapshots: list[dict], width: int = 100) -> str:
    """One text frame for the terminal (also the format tests assert on)."""
    lines = [
        time.strftime("pio top — %H:%M:%S", time.localtime()),
        "",
        f"{'SERVICE':<32}{'QPS':>8}{'P50MS':>9}{'P99MS':>9}"
        f"{'ERR%':>7}{'QUEUE':>7}{'BATCH':>7}{'WKR':>5}{'SHARD':>6}"
        f"{'PART':>6}{'WAKE':>6}{'MODEL':>7}{'SWAP':>8}{'LAG':>7}",
    ]
    for s in stats_list:
        if s.get("error"):
            lines.append(f"{s['url']:<32}  unreachable: {s['error']}")
            continue
        lines.append(
            f"{s['url']:<32}"
            f"{_fmt(s.get('qps')):>8}"
            f"{_fmt(s.get('p50_ms')):>9}"
            f"{_fmt(s.get('p99_ms')):>9}"
            f"{_fmt(round(s.get('error_rate', 0.0) * 100, 1)):>7}"
            f"{_fmt(s.get('ingest_queue_depth')):>7}"
            f"{_fmt(s.get('batch_occupancy')):>7}"
            f"{_fmt(s.get('frontend_workers')):>5}"
            f"{_fmt(s.get('scorer_shards')):>6}"
            f"{_fmt(s.get('wal_partitions')):>6}"
            f"{_fmt(s.get('wakeups_per_request')):>6}"
            f"{_fmt(s.get('model_version')):>7}"
            f"{_fmt(s.get('swap_age_s'), 's'):>8}"
            f"{_fmt(s.get('foldin_lag_s'), 's'):>7}"
        )
    slowest: list[tuple[float, str, dict]] = []
    for snap in snapshots:
        traces = (snap.get("traces") or {}).get("slowest") or []
        for t in traces:
            slowest.append((t.get("durationMs", 0.0), snap["url"], t))
    slowest.sort(key=lambda e: -e[0])
    if slowest:
        lines.append("")
        lines.append("SLOWEST TRACES")
        for dur, url, t in slowest[:8]:
            ops = " > ".join(s["op"] for s in t.get("spans", [])[:6])
            lines.append(
                f"  {dur:>9.1f}ms  {t.get('status', '?'):<5} "
                f"{t.get('traceId', '')[:16]}  {t.get('op', '')}"
            )
            if ops:
                lines.append(f"{'':>14}{ops[: width - 14]}")
    return "\n".join(lines)


def run_top(
    urls: list[str],
    interval: float = 2.0,
    iterations: int = 0,
    clear: bool = True,
    out=print,
) -> None:
    """The polling loop. ``iterations=0`` runs until interrupted; tests
    pass a finite count and a capture ``out``. The first frame needs two
    snapshots (rates are deltas), so the loop primes once silently."""
    prev = [fetch_snapshot(u) for u in urls]
    n = 0
    while iterations <= 0 or n < iterations:
        time.sleep(interval)
        cur = [fetch_snapshot(u) for u in urls]
        stats = [compute_stats(p, c) for p, c in zip(prev, cur)]
        frame = render(stats, cur)
        if clear:
            out("\x1b[2J\x1b[H" + frame)
        else:
            out(frame)
        prev = cur
        n += 1
