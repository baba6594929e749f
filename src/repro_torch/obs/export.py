"""Exporters: metrics snapshots to JSON/JSONL and Prometheus text, plus a
one-call ``dump()`` used by the Scheduler's shutdown path, and the
JSONL-side half of cross-process aggregation (the port's copy of
``repro.obs.export``).

Formats:
  * JSON / JSONL — ``Registry.snapshot()`` verbatim; the JSONL writer
    APPENDS one snapshot object per call so a long run leaves a time
    series (each line stamped with wall time and an optional caller tag).
    ``read_last_snapshot`` / ``merge_snapshot_files`` are the read side:
    each replica process dumps its own JSONL, the aggregator reads the
    last line of each and folds them through
    ``metrics.merge_snapshots`` into one view.
  * Prometheus exposition text — one ``# HELP``/``# TYPE`` header per
    metric FAMILY (bare dotted name) followed by every series in that
    family with its label set rendered (values escaped per the
    exposition format); histograms emit the conventional
    ``_bucket{le=...}`` / ``_sum`` / ``_count`` triplet with cumulative
    bucket counts and labels merged into the bucket line.  Metric names
    sanitize ``.``/``-`` to ``_`` (dots namespace the registry,
    underscores namespace Prometheus).
"""

from __future__ import annotations

import json
import time
from typing import List, Optional

from repro_torch.obs.metrics import (Counter, Gauge, Registry,
                                     escape_label_value, merge_snapshots,
                                     registry)
from repro_torch.obs.tracing import Tracer, tracer


def _prom_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def _prom_labels(labels: dict, extra: Optional[dict] = None) -> str:
    """Render a label set as ``{k="v",...}`` (sorted keys, escaped values);
    empty string for no labels.  ``extra`` merges in exporter-owned labels
    like a histogram bucket's ``le``."""
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def prometheus_text(reg: Optional[Registry] = None) -> str:
    """Render the registry in Prometheus exposition format.

    Series are grouped into families by bare metric name — labeled series
    of one family share a single ``# HELP``/``# TYPE`` header, per the
    format.  HELP carries the dotted registry name so the original
    namespacing survives the ``.`` → ``_`` sanitization."""
    reg = reg if reg is not None else registry()
    families: dict = {}
    for _, m in sorted(reg._metrics.items()):
        families.setdefault(m.name, []).append(m)
    lines: List[str] = []
    for name in sorted(families):
        pn = _prom_name(name)
        series = families[name]
        kind = ("counter" if isinstance(series[0], Counter)
                else "gauge" if isinstance(series[0], Gauge)
                else "histogram")
        lines.append(f"# HELP {pn} {name}")
        lines.append(f"# TYPE {pn} {kind}")
        for m in series:
            lab = _prom_labels(m.labels)
            if kind in ("counter", "gauge"):
                lines.append(f"{pn}{lab} {m.value:g}")
            else:                               # Histogram
                cum = 0
                for edge, c in zip(m.bounds, m.counts):
                    cum += c
                    ble = _prom_labels(m.labels, {"le": f"{edge:g}"})
                    lines.append(f"{pn}_bucket{ble} {cum}")
                binf = _prom_labels(m.labels, {"le": "+Inf"})
                lines.append(f"{pn}_bucket{binf} {m.count}")
                lines.append(f"{pn}_sum{lab} {m.sum:g}")
                lines.append(f"{pn}_count{lab} {m.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(path: str, reg: Optional[Registry] = None) -> None:
    with open(path, "w") as f:
        f.write(prometheus_text(reg))


def write_metrics_json(path: str, reg: Optional[Registry] = None,
                       extra: Optional[dict] = None) -> None:
    reg = reg if reg is not None else registry()
    snap = reg.snapshot()
    if extra:
        snap["extra"] = dict(extra)
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True)
        f.write("\n")


def write_metrics_jsonl(path: str, reg: Optional[Registry] = None,
                        tag: str = "", extra: Optional[dict] = None) -> None:
    """Append one snapshot line — repeated calls build a time series."""
    reg = reg if reg is not None else registry()
    line = {"time": round(time.time(), 3), **reg.snapshot()}
    if tag:
        line["tag"] = tag
    if extra:
        line["extra"] = dict(extra)
    with open(path, "a") as f:
        f.write(json.dumps(line, sort_keys=True) + "\n")


def read_last_snapshot(path: str) -> dict:
    """Last snapshot line of a metrics JSONL file — a process's final state
    (every line is a full snapshot, so the last one supersedes the rest)."""
    last: Optional[dict] = None
    with open(path) as f:
        for raw in f:
            raw = raw.strip()
            if raw:
                last = json.loads(raw)
    if last is None:
        raise ValueError(f"no snapshot lines in {path!r}")
    return last


def merge_snapshot_files(paths) -> dict:
    """Aggregate N per-process metrics JSONL dumps into one snapshot view:
    read each file's last line, fold through ``merge_snapshots``.  This is
    the replica-aggregation entry point item 3's tier composes on."""
    return merge_snapshots([read_last_snapshot(p) for p in paths])


def dump(metrics_path: Optional[str] = None,
         trace_path: Optional[str] = None,
         prom_path: Optional[str] = None,
         reg: Optional[Registry] = None,
         tr: Optional[Tracer] = None,
         tag: str = "") -> None:
    """Write whichever artifacts were configured.  ``metrics_path`` ending
    in ``.jsonl`` appends a snapshot line (time series); any other suffix
    overwrites with a pretty JSON snapshot.  ``trace_path`` gets the
    Chrome-trace JSON.  The tracer's ring-drop count is published as the
    ``tracer.dropped_spans`` gauge first, so every artifact records whether
    the trace it sits next to is complete."""
    reg = reg if reg is not None else registry()
    t = tr if tr is not None else tracer()
    if reg.enabled and t.dropped_spans:
        reg.set("tracer.dropped_spans", float(t.dropped_spans))
    if metrics_path:
        if metrics_path.endswith(".jsonl"):
            write_metrics_jsonl(metrics_path, reg, tag=tag)
        else:
            write_metrics_json(metrics_path, reg)
    if trace_path:
        t.export_chrome(trace_path)
    if prom_path:
        write_prometheus(prom_path, reg)
