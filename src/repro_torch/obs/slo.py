"""SLO specs and goodput accounting over per-request records (the port's
copy of ``repro.obs.slo``).

Throughput under overload is a vanity metric: a saturated server can post
high tokens/s while every request blows its latency budget in the queue.
The number serving claims should be judged by is **goodput**:
the fraction of offered requests that finish AND meet every SLO
(TTFT ≤ x, TPOT ≤ y).  A scheduler that sheds or preempts excess load
keeps goodput near capacity through overload; one that admits everything
collapses TTFT for all requests at once, and goodput falls off a cliff.

The unit of account is a per-request **record** dict::

    {"rid": int, "tenant": str, "outcome": "finished" | "shed",
     "t_arrival": float, "queue_delay_s": float,
     "ttft_s": float | None, "tpot_s": float | None, "new_tokens": int}

Two independent producers emit the same schema:

  * ``Scheduler.records`` — written live at finish/shed time (bounded);
  * ``records_from_spans(tracer.spans())`` — reconstructed offline from
    the span lifecycle (queued → prefill → decode → finish), so a
    Chrome-trace artifact alone is enough to recompute goodput after the
    fact.

Semantics: TTFT is **arrival-based** (first token minus ``submit()``
time — queue wait included, surviving preemption), because under load the
queue IS the latency.  A shed request counts against goodput (it was
offered and not served within SLO) but not against ``served_goodput``
(quality of service for admitted work — the "degrade gracefully" half of
the overload gate).  Single-token requests carry no TPOT obligation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Declarative SLO: a request meets it iff it finished, its TTFT is
    within ``ttft_s``, and (when ``tpot_s`` is set and the request decoded
    ≥ 2 tokens) its per-token decode latency is within ``tpot_s``."""

    ttft_s: float
    tpot_s: Optional[float] = None
    name: str = "slo"

    def met(self, rec: dict) -> bool:
        if rec.get("outcome") != "finished":
            return False
        ttft = rec.get("ttft_s")
        if ttft is None or ttft > self.ttft_s:
            return False
        if self.tpot_s is not None:
            tpot = rec.get("tpot_s")
            if tpot is not None and tpot > self.tpot_s:
                return False
        return True

    def as_dict(self) -> dict:
        return {"name": self.name, "ttft_s": self.ttft_s,
                "tpot_s": self.tpot_s}


def _pct(xs: List[float], q: float) -> float:
    """Linear-interpolated percentile of a non-empty sorted list."""
    if len(xs) == 1:
        return xs[0]
    pos = q * (len(xs) - 1)
    i = int(pos)
    frac = pos - i
    if i + 1 >= len(xs):
        return xs[-1]
    return xs[i] + frac * (xs[i + 1] - xs[i])


def _latency_summary(values: List[float]) -> dict:
    xs = sorted(v for v in values if v is not None)
    if not xs:
        return {"count": 0}
    return {"count": len(xs), "mean": sum(xs) / len(xs),
            "p50": _pct(xs, 0.50), "p90": _pct(xs, 0.90),
            "p99": _pct(xs, 0.99), "max": xs[-1]}


def _bucket_stats(records: Sequence[dict], spec: SLOSpec) -> dict:
    finished = [r for r in records if r.get("outcome") == "finished"]
    shed = [r for r in records if r.get("outcome") == "shed"]
    met = sum(1 for r in records if spec.met(r))
    total = len(records)
    return {
        "total": total,
        "finished": len(finished),
        "shed": len(shed),
        "slo_met": met,
        "goodput": met / total if total else 0.0,
        "served_goodput": met / len(finished) if finished else 0.0,
        "ttft": _latency_summary([r.get("ttft_s") for r in finished]),
        "tpot": _latency_summary([r.get("tpot_s") for r in finished]),
        "queue_delay": _latency_summary(
            [r.get("queue_delay_s") for r in finished]),
        "new_tokens": sum(r.get("new_tokens", 0) for r in finished),
    }


def evaluate(records: Sequence[dict], spec: SLOSpec) -> dict:
    """Goodput + latency summary of ``records`` against ``spec``, with a
    per-tenant breakdown (records with an empty tenant group under "")."""
    out = _bucket_stats(records, spec)
    out["spec"] = spec.as_dict()
    tenants: Dict[str, list] = {}
    for r in records:
        tenants.setdefault(r.get("tenant", ""), []).append(r)
    if len(tenants) > 1 or (tenants and "" not in tenants):
        out["per_tenant"] = {t: _bucket_stats(rs, spec)
                             for t, rs in sorted(tenants.items())}
    return out


def records_from_spans(spans) -> List[dict]:
    """Reconstruct per-request records from tracer spans — the offline twin
    of ``Scheduler.records`` (same schema, parity-tested bit-exact on fully
    drained runs).

    Per ``req<rid>`` track: the earliest "queued" span's start is the
    arrival, the last one's duration the (final) queue delay; TTFT is the
    end of the last non-preempted "prefill" minus arrival; TPOT is the
    "decode" span's duration over its ``tokens - 1`` inter-token gaps;
    outcome comes from the "finish"/"shed" instant (requests that left no
    terminal instant — still queued or in flight when the trace was cut —
    report ``outcome="incomplete"``)."""
    tracks: Dict[int, list] = {}
    for s in spans:
        if s.track.startswith("req"):
            try:
                rid = int(s.track[3:])
            except ValueError:
                continue
            tracks.setdefault(rid, []).append(s)
    records = []
    for rid in sorted(tracks):
        ss = tracks[rid]
        queued = [s for s in ss if s.name == "queued"]
        # TTFT comes off the prefill that produced the FIRST token: skip
        # preempted partials and post-preemption re-prefills (resumed).
        prefills = [s for s in ss if s.name == "prefill"
                    and not s.args.get("preempted")
                    and not s.args.get("resumed")]
        decodes = [s for s in ss if s.name == "decode"
                   and not s.args.get("preempted")]
        finish = next((s for s in ss if s.name == "finish"), None)
        shed = next((s for s in ss if s.name == "shed"), None)
        term = finish or shed
        rec = {"rid": rid,
               "tenant": term.args.get("tenant", "") if term else "",
               "outcome": ("finished" if finish is not None
                           else "shed" if shed is not None
                           else "incomplete"),
               "t_arrival": (min(s.t0 for s in queued) if queued
                             else shed.t0 if shed else 0.0),
               "queue_delay_s": queued[-1].dur if queued else 0.0,
               "ttft_s": None, "tpot_s": None,
               "new_tokens": finish.args.get("tokens", 0) if finish else 0}
        if finish is not None and prefills:
            p = prefills[-1]
            rec["ttft_s"] = (p.t0 + p.dur) - rec["t_arrival"]
        if finish is not None and decodes:
            d = decodes[-1]
            toks = d.args.get("tokens", 0)
            if toks >= 2:
                rec["tpot_s"] = d.dur / (toks - 1)
        records.append(rec)
    return records
