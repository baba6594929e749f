"""Span tracing with ring-buffer retention and Chrome-trace export (the
port's copy of ``repro.obs.tracing``).

A ``Span`` is one named interval on one named ``track`` — per-request
tracks ("req3") give every request its own row in ``chrome://tracing`` /
Perfetto, so the admission→chunked-prefill→decode→finish lifecycle reads
left-to-right per request while scheduler-wide work ("sched") stacks on
its own row.

Two recording styles, because the Scheduler interleaves requests:

  * ``with tracer.span("prefill_chunk", track="sched", segs=3):`` — for
    code where the interval IS a lexical scope;
  * ``tracer.add("prefill", t0, t1, track="req3", ...)`` — explicit
    timestamps for phases that open in one scheduler iteration and close
    many iterations later.  ``tracer.now()`` supplies the monotonic,
    tracer-epoch-relative clock for saved timestamps.

Retention is a bounded deque (default 65536 spans); exporters surface the
count of overwritten spans (``dropped_spans``).  Exporters:
``chrome_trace()`` → the Trace Event Format dict (ph:"X" complete events,
µs), ``export_jsonl()`` → one span per line.

``torch.profiler`` passthrough (where the JAX package has
``jax.profiler``): setting ``tracer.annotate = True`` wraps every
``span()`` scope in ``torch.profiler.record_function`` so host-side spans
land on the profiler's timeline beside the device kernels, and
``start_profiler(logdir)`` / ``stop_profiler()`` bracket a run with a
``torch.profiler.profile`` whose Chrome trace is written into ``logdir``.
Host spans time the host: a span around asynchronous CUDA work ends when
the work is queued unless the code inside it synchronises.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from contextlib import contextmanager
from typing import NamedTuple


class Span(NamedTuple):
    name: str
    t0: float          # seconds since tracer epoch
    dur: float         # seconds
    track: str
    args: dict


class Tracer:
    def __init__(self, capacity: int = 65536, enabled: bool = True):
        self.enabled = enabled
        self.annotate = False      # torch.profiler.record_function passthrough
        self._epoch = time.perf_counter()
        self._spans: deque = deque(maxlen=capacity)
        self._dropped = 0          # spans overwritten by the ring

    def _push(self, span: "Span") -> None:
        """Ring append with drop accounting: a full deque silently evicts
        its oldest span; exporters surface the count (``dropped_spans``)
        so a truncated trace is never mistaken for a complete one."""
        if len(self._spans) == self._spans.maxlen:
            self._dropped += 1
        self._spans.append(span)

    @property
    def dropped_spans(self) -> int:
        return self._dropped

    # ------------------------------------------------------------ recording
    def now(self) -> float:
        """Monotonic seconds since tracer epoch (feed back into ``add``)."""
        return time.perf_counter() - self._epoch

    @contextmanager
    def span(self, name: str, track: str = "main", **args):
        if not self.enabled:
            yield
            return
        ann = self._annotation(name)
        if ann is not None:
            ann.__enter__()
        t0 = self.now()
        try:
            yield
        finally:
            self._push(Span(name, t0, self.now() - t0, track, args))
            if ann is not None:
                ann.__exit__(None, None, None)

    def add(self, name: str, t0: float, t1: float,
            track: str = "main", **args) -> None:
        """Record a completed interval from saved ``now()`` timestamps."""
        if self.enabled:
            self._push(Span(name, t0, max(t1 - t0, 0.0), track, args))

    def instant(self, name: str, track: str = "main", **args) -> None:
        """Zero-duration marker (finish, preempt, evict...)."""
        if self.enabled:
            self._push(Span(name, self.now(), 0.0, track, args))

    def _annotation(self, name: str):
        if not self.annotate:
            return None
        import torch.profiler
        return torch.profiler.record_function(name)

    # ------------------------------------------------------------- reading
    def spans(self) -> list:
        return list(self._spans)

    def __len__(self) -> int:
        return len(self._spans)

    def reset(self) -> None:
        self._spans.clear()
        self._dropped = 0
        self._epoch = time.perf_counter()

    # ------------------------------------------------------------ exporters
    def chrome_trace(self) -> dict:
        """Trace Event Format: one pid, one tid per track, ph:"X" events in
        µs.  Load via chrome://tracing or https://ui.perfetto.dev."""
        tids: dict = {}
        events = []
        for s in self._spans:
            tid = tids.setdefault(s.track, len(tids))
            ev = {"name": s.name, "ph": "X", "pid": 0, "tid": tid,
                  "ts": round(s.t0 * 1e6, 3), "dur": round(s.dur * 1e6, 3)}
            if s.args:
                ev["args"] = s.args
            events.append(ev)
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                 "args": {"name": track}} for track, tid in tids.items()]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": self._dropped}}

    def export_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
            f.write("\n")

    def export_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for s in self._spans:
                f.write(json.dumps({"name": s.name, "t0": round(s.t0, 6),
                                    "dur": round(s.dur, 6),
                                    "track": s.track, **s.args}) + "\n")


# Process-global default tracer, mirroring metrics.REGISTRY.
TRACER = Tracer()


def tracer() -> Tracer:
    return TRACER


_PROFILE = None                  # the running torch.profiler.profile
_PROFILE_DIR = None


def start_profiler(logdir: str, annotate: bool = True) -> bool:
    """Begin a ``torch.profiler`` trace of the host and, where there is
    one, the CUDA device, and turn on span annotation; ``stop_profiler``
    writes it to ``logdir/trace.json``.  Returns False when a profile is
    already running."""
    global _PROFILE, _PROFILE_DIR
    if _PROFILE is not None:
        return False
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    _PROFILE = profile(activities=acts)
    _PROFILE.__enter__()
    _PROFILE_DIR = logdir
    TRACER.annotate = annotate
    return True


def stop_profiler() -> bool:
    """End the profile begun by ``start_profiler`` and write its Chrome
    trace.  Returns False when none was running."""
    global _PROFILE, _PROFILE_DIR
    TRACER.annotate = False
    if _PROFILE is None:
        return False
    prof, logdir = _PROFILE, _PROFILE_DIR
    _PROFILE = _PROFILE_DIR = None
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return True
