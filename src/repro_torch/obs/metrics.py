"""Process-local metrics registry: counters, gauges, histograms, with
label sets and cross-process snapshot aggregation (the port's copy of
``repro.obs.metrics``; same API, same snapshot format).

  * **Pure-Python hot path** — recording is a dict lookup plus a float op;
    no numpy, no torch, no locks on the observe path.  The block allocator
    (``repro_torch.serve.paged_kv``) and the scheduler
    (``repro_torch.serve.scheduler``) call into this on every event.
  * **Zero writes when disabled** — ``Registry.enabled = False`` makes
    every convenience call return before touching any state, and the
    factory methods hand back a shared no-op metric that is never stored.
  * **Fixed-bucket streaming quantiles** — histograms keep a bounded
    vector of bucket counts (no sample retention); p50/p90/p99 are
    interpolated within the covering bucket, clamped to the observed
    min/max.  Memory is O(buckets) regardless of request count.

Device values (a loss, a grad norm) reach ``publish`` only after the
caller has moved them to the host where it syncs anyway: ``publish``
itself calls ``float()``, which on a CUDA tensor would BE the sync.

Labels: every factory/convenience call takes ``**labels``
(``registry.counter("serve.finished", tenant="a")``); each distinct label
set is its own series, keyed by the Prometheus-style rendering
``name{k="v",...}`` with sorted keys and escaped values.

Aggregation: ``merge_snapshots`` merges per-process
``Registry.snapshot()`` dicts into one view — counters and histogram
buckets ADD; gauges merge per kind (``set_max`` high-waters take the max,
last-value gauges the value with the newest update stamp).  The merge is
commutative and associative.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence


def _geometric_bounds(lo: float, hi: float, per_decade: int = 4) -> tuple:
    """Geometric bucket bounds from ``lo`` to ``hi`` (inclusive-ish)."""
    import math
    n = int(math.ceil((math.log10(hi) - math.log10(lo)) * per_decade))
    return tuple(lo * (10.0 ** (i / per_decade)) for i in range(n + 1))


# Default bounds cover microseconds..minutes in seconds AND dimensionless
# ratios (packing efficiency, entropy in [0, 1]) with ~78%-wide buckets.
DEFAULT_BOUNDS = _geometric_bounds(1e-6, 1e3)

# Linear [0, 1] bounds for ratio-valued histograms (efficiency, drop rate,
# normalized entropy) where geometric spacing would waste resolution.
UNIT_BOUNDS = tuple(i / 20.0 for i in range(21))


def escape_label_value(v: str) -> str:
    """Prometheus exposition escaping for label values: backslash, double
    quote, and newline.  Shared by the registry's series keys and the text
    exporter so a snapshot key IS the rendered series name."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def series_key(name: str, labels: Optional[dict]) -> str:
    """Registry/snapshot key of one series: the bare name, or
    ``name{k="v",...}`` with sorted keys — identical across processes, so
    ``merge_snapshots`` matches series by string equality."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


# Monotone per-process sequence for gauge update stamps: ``time.time()``
# orders updates across processes (coarsely — wall clock), the sequence
# breaks ties within one (the property test's single-process registries
# update faster than the clock ticks).
_STAMP_SEQ = itertools.count(1)


def _stamp() -> list:
    return [time.time(), next(_STAMP_SEQ)]


class Counter:
    """Monotone float counter."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Optional[dict] = None):
        self.name = name
        self.labels = labels or {}
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    """Last-value gauge; ``set_max`` keeps a high-water mark instead.

    Each update records a ``stamp`` ([wall time, process-monotone seq]) and
    the gauge's merge ``kind`` ("last" or "max") so ``merge_snapshots`` can
    combine per-process values commutatively: high-waters take the max,
    last-value gauges take the newest stamp's value."""

    __slots__ = ("name", "labels", "value", "stamp", "kind")

    def __init__(self, name: str, labels: Optional[dict] = None):
        self.name = name
        self.labels = labels or {}
        self.value = 0.0
        self.stamp = [0.0, 0]
        self.kind = "last"

    def set(self, v: float) -> None:
        self.value = v
        self.stamp = _stamp()

    def set_max(self, v: float) -> None:
        self.kind = "max"
        if v > self.value:
            self.value = v
            self.stamp = _stamp()


class Histogram:
    """Fixed-bucket streaming histogram with interpolated quantiles.

    ``bounds`` are the bucket upper edges; values land in the first bucket
    whose edge is >= v, with one overflow bucket past the last edge.
    ``quantile(q)`` walks the cumulative counts to the covering bucket and
    interpolates linearly inside it, clamping to the observed min/max — so
    a single observation reports itself exactly and bucket-width error is
    bounded by the bucket, never by the sample count.
    """

    __slots__ = ("name", "labels", "bounds", "counts", "count", "sum",
                 "min", "max")

    def __init__(self, name: str, bounds: Optional[Sequence[float]] = None,
                 labels: Optional[dict] = None):
        self.name = name
        self.labels = labels or {}
        self.bounds = tuple(bounds) if bounds is not None else DEFAULT_BOUNDS
        assert all(a < b for a, b in zip(self.bounds, self.bounds[1:])), (
            "histogram bounds must be strictly increasing")
        self.counts = [0] * (len(self.bounds) + 1)   # +1 overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        lo, hi = 0, len(self.bounds)                 # bisect, inlined: the
        while lo < hi:                               # hot path stays free of
            mid = (lo + hi) // 2                     # module lookups
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                b_lo = self.bounds[i - 1] if i > 0 else self.min
                b_hi = self.bounds[i] if i < len(self.bounds) else self.max
                b_lo = max(b_lo, self.min)
                b_hi = min(b_hi, self.max)
                if b_hi <= b_lo:
                    return b_lo
                frac = (target - cum) / c
                return b_lo + frac * (b_hi - b_lo)
            cum += c
        return self.max

    def percentiles(self) -> Dict[str, float]:
        return {"p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}

    def summary(self) -> dict:
        """JSON summary.  Carries the raw ``bounds``/``counts`` vectors —
        not just the interpolated quantiles — so snapshots from different
        processes can be bucket-added by ``merge_snapshots`` and the merged
        quantiles recomputed exactly as a shared registry would report
        them."""
        out = {"count": self.count, "sum": self.sum,
               "bounds": list(self.bounds), "counts": list(self.counts)}
        if self.count:
            out.update(min=self.min, max=self.max,
                       mean=self.sum / self.count, **self.percentiles())
        return out


class _Null:
    """Shared no-op metric handed out by a disabled registry (never stored)."""

    name = "<disabled>"
    labels: dict = {}
    value = 0.0

    def inc(self, v: float = 1.0) -> None: pass
    def set(self, v: float) -> None: pass
    def set_max(self, v: float) -> None: pass
    def observe(self, v: float) -> None: pass
    def quantile(self, q: float) -> float: return 0.0
    def percentiles(self) -> dict: return {}
    def summary(self) -> dict: return {}


_NULL = _Null()


class _Timer:
    """``Registry.timer`` scope: measures always, records iff the registry
    handed it a live histogram."""

    __slots__ = ("hist", "t0", "dt")

    def __init__(self, hist):
        self.hist = hist
        self.t0 = 0.0
        self.dt = 0.0

    def __enter__(self) -> "_Timer":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.dt = time.perf_counter() - self.t0
        if self.hist is not None:
            self.hist.observe(self.dt)


class Registry:
    """Name -> metric map with a fast-exit ``enabled`` switch.

    Creation is lock-guarded (instrumented code may run under the data
    pipeline's prefetch thread); the record path is a plain attribute
    update, safe under the GIL for the float ops used here.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- factories
    def _get(self, name: str, cls, labels: dict, *args):
        if not self.enabled:
            return _NULL
        key = series_key(name, labels) if labels else name
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, *args, labels=labels)
                    self._metrics[key] = m
        assert isinstance(m, cls), (
            f"metric {key!r} already registered as {type(m).__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, Counter, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, Gauge, labels)

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        return self._get(name, Histogram, labels, bounds)

    # ---------------------------------------------------------- convenience
    def inc(self, name: str, v: float = 1.0, **labels) -> None:
        if self.enabled:
            self.counter(name, **labels).inc(v)

    def set(self, name: str, v: float, **labels) -> None:
        if self.enabled:
            self.gauge(name, **labels).set(v)

    def set_max(self, name: str, v: float, **labels) -> None:
        if self.enabled:
            self.gauge(name, **labels).set_max(v)

    def observe(self, name: str, v: float,
                bounds: Optional[Sequence[float]] = None, **labels) -> None:
        if self.enabled:
            self.histogram(name, bounds, **labels).observe(v)

    def timer(self, name: str, bounds: Optional[Sequence[float]] = None,
              **labels) -> "_Timer":
        """Context manager that observes its scope's elapsed seconds into
        histogram ``name`` and exposes the measurement as ``.dt`` — the
        replacement for hand-rolled ``t0 = time.monotonic()`` pairs.  The
        clock always runs (callers use ``.dt`` for throughput math and
        straggler detection even with obs off); only the histogram write is
        gated on ``enabled`` — the write-free-when-disabled invariant."""
        return _Timer(self.histogram(name, bounds, **labels)
                      if self.enabled else None)

    # -------------------------------------------------------------- reading
    def get(self, name: str, **labels):
        return self._metrics.get(series_key(name, labels))

    def snapshot(self) -> dict:
        """{"counters": {key: value}, "gauges": {...}, "gauges_meta": {...},
        "histograms": {key: summary}} — JSON-ready.  Keys are series keys
        (``series_key``: bare names, or ``name{k="v"}`` for labeled
        series).  ``gauges_meta`` carries each gauge's merge kind and
        update stamp for ``merge_snapshots``."""
        out: dict = {"counters": {}, "gauges": {}, "gauges_meta": {},
                     "histograms": {}}
        for key, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                out["counters"][key] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][key] = m.value
                out["gauges_meta"][key] = {"kind": m.kind,
                                           "stamp": list(m.stamp)}
            else:
                out["histograms"][key] = m.summary()
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


# The process-global default registry every instrumented module reports to.
REGISTRY = Registry()


def registry() -> Registry:
    return REGISTRY


def publish(values: dict, prefix: str = "",
            reg: Optional[Registry] = None, kind: str = "gauge") -> dict:
    """Host half of the device-metrics pattern (module docstring): record a
    dict of scalars under ``prefix``.  Call it with values you have ALREADY
    host-synced (the step's existing ``float(v)`` point) — ``float()`` here
    is then free; on a still-on-device array it would itself be the
    transfer.  ``kind``: "gauge" (last value) or "histogram" (distribution).
    Returns the recorded {name: float} map."""
    reg = reg if reg is not None else REGISTRY
    if not reg.enabled:
        return {}
    rec = reg.observe if kind == "histogram" else reg.set
    out = {}
    for k, v in values.items():
        f = float(v)
        rec(prefix + k, f)
        out[prefix + k] = f
    return out


# ------------------------------------------------- cross-process aggregation
def _merged_quantile(bounds: List[float], counts: List[int], count: int,
                     vmin: float, vmax: float, q: float) -> float:
    """``Histogram.quantile`` over merged bucket vectors (same math,
    operating on snapshot data instead of a live metric)."""
    if count == 0:
        return 0.0
    target = q * count
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            b_lo = bounds[i - 1] if i > 0 else vmin
            b_hi = bounds[i] if i < len(bounds) else vmax
            b_lo = max(b_lo, vmin)
            b_hi = min(b_hi, vmax)
            if b_hi <= b_lo:
                return b_lo
            frac = (target - cum) / c
            return b_lo + frac * (b_hi - b_lo)
        cum += c
    return vmax


def merge_snapshots(snaps: Sequence[dict]) -> dict:
    """Commutative merge of ``Registry.snapshot()`` dicts from N processes
    into one aggregate view (DESIGN §12) — the per-replica JSONL lines of
    ``export.write_metrics_jsonl`` are exactly this shape.

    Per series (matched by snapshot key, labels included): counters SUM;
    histograms bucket-add (bounds must agree — the same code registered
    them) with count/sum added, min/max combined, and quantiles recomputed
    from the merged buckets; gauges merge per recorded kind — ``max``
    (high-waters) take the max value, ``last`` take the value carrying the
    newest update stamp (ties break toward the larger value, keeping the
    merge order-independent).  Associative and commutative: any merge
    order over any grouping yields the same result, which is what lets a
    tree of per-replica aggregators exist."""
    out: dict = {"counters": {}, "gauges": {}, "gauges_meta": {},
                 "histograms": {}}
    for snap in snaps:
        for k, v in snap.get("counters", {}).items():
            out["counters"][k] = out["counters"].get(k, 0.0) + v
        meta = snap.get("gauges_meta", {})
        for k, v in snap.get("gauges", {}).items():
            m = meta.get(k, {"kind": "last", "stamp": [0.0, 0]})
            if k not in out["gauges"]:
                out["gauges"][k] = v
                out["gauges_meta"][k] = {"kind": m["kind"],
                                         "stamp": list(m["stamp"])}
                continue
            have = out["gauges_meta"][k]
            if m["kind"] == "max":
                have["kind"] = "max"
            if have["kind"] == "max":
                if v > out["gauges"][k]:
                    out["gauges"][k] = v
                    have["stamp"] = list(m["stamp"])
            else:
                key_new = (list(m["stamp"]), v)
                key_old = (list(have["stamp"]), out["gauges"][k])
                if key_new > key_old:
                    out["gauges"][k] = v
                    have["stamp"] = list(m["stamp"])
        for k, h in snap.get("histograms", {}).items():
            if k not in out["histograms"]:
                out["histograms"][k] = {
                    "count": h["count"], "sum": h["sum"],
                    "bounds": list(h["bounds"]),
                    "counts": list(h["counts"]),
                    "min": h.get("min", float("inf")),
                    "max": h.get("max", float("-inf"))}
                continue
            a = out["histograms"][k]
            assert a["bounds"] == list(h["bounds"]), (
                f"histogram {k!r}: differing bucket bounds across "
                "snapshots cannot be merged")
            a["counts"] = [x + y for x, y in zip(a["counts"], h["counts"])]
            a["count"] += h["count"]
            a["sum"] += h["sum"]
            a["min"] = min(a["min"], h.get("min", float("inf")))
            a["max"] = max(a["max"], h.get("max", float("-inf")))
    for k, a in out["histograms"].items():
        if a["count"]:
            a["mean"] = a["sum"] / a["count"]
            for nm, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
                a[nm] = _merged_quantile(a["bounds"], a["counts"],
                                         a["count"], a["min"], a["max"], q)
        else:
            a.pop("min", None)
            a.pop("max", None)
    return out
