"""repro_torch.obs — metrics, tracing, exporters and SLOs (the port's copy
of ``repro.obs``).

Pure Python at import time (torch is only touched inside the optional
profiler passthrough), so any module of the port can import it.

    from repro_torch import obs
    obs.registry().observe("serve.ttft_s", dt)
    obs.registry().inc("serve.finished", tenant="a")   # labeled series
    with obs.registry().timer("serve.run_s") as t:
        ...
    with obs.tracer().span("prefill_chunk", track="sched", segs=3):
        ...
    obs.dump(metrics_path="m.jsonl", trace_path="trace.json")
    obs.merge_snapshot_files(["r0.jsonl", "r1.jsonl"])  # N replicas -> 1
    obs.set_enabled(False)      # all of the above become no-ops
"""

from repro_torch.obs.export import (dump, merge_snapshot_files,
                                    prometheus_text, read_last_snapshot,
                                    write_metrics_json, write_metrics_jsonl,
                                    write_prometheus)
from repro_torch.obs.metrics import (DEFAULT_BOUNDS, UNIT_BOUNDS, Counter,
                                     Gauge, Histogram, Registry,
                                     escape_label_value, merge_snapshots,
                                     publish, registry, series_key)
from repro_torch.obs.slo import SLOSpec, evaluate, records_from_spans
from repro_torch.obs.tracing import (Span, Tracer, start_profiler,
                                     stop_profiler, tracer)


def set_enabled(flag: bool) -> None:
    """Toggle the global registry AND tracer in one call — the single
    switch Scheduler/Trainer/bench obs flags map onto."""
    registry().enabled = flag
    tracer().enabled = flag


def enabled() -> bool:
    return registry().enabled


__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "SLOSpec", "Span",
    "Tracer", "DEFAULT_BOUNDS", "UNIT_BOUNDS",
    "dump", "enabled", "escape_label_value", "evaluate",
    "merge_snapshot_files", "merge_snapshots", "prometheus_text", "publish",
    "read_last_snapshot", "records_from_spans", "registry", "series_key",
    "set_enabled", "start_profiler", "stop_profiler", "tracer",
    "write_metrics_json", "write_metrics_jsonl", "write_prometheus",
]
