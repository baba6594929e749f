"""Seeded load generation for the timed Scheduler mode (the port's copy of
``repro.serve.loadgen``; the same seed gives the same stream).

Drain-a-preloaded-queue runs measure capacity, not service: every serving
claim that matters under traffic (TTFT/TPOT tails, goodput through
overload) depends on the ARRIVAL PROCESS, which pre-queueing erases.
This module builds seeded, reproducible request streams and the source
objects ``Scheduler.run(source=...)`` pumps them through:

  * **Open loop** — arrivals at predetermined times, independent of how
    the server keeps up (the overload-honest discipline: a slow server
    faces a growing queue, exactly like production).  Poisson arrivals
    (``poisson_workload``) model independent users; Gamma interarrivals
    with CV > 1 (``bursty_workload``) model correlated bursts.
  * **Closed loop** — a fixed number of outstanding requests; each
    completion immediately triggers the next submit.  Self-throttling, so
    it cannot show overload — its role is measuring the *sustainable*
    service rate the open-loop sweep is then scaled against.

Per-tenant mixes: each ``TenantSpec`` carries a sampling weight plus
prompt-length / max-new ranges, and every arrival is tagged with its
tenant name — the Scheduler threads it into labeled metrics and SLO
records.  Everything is driven by one ``numpy`` Generator seed: the same
(seed, rate, n, tenants) produces the identical stream, so bench numbers
are replayable.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic mix: relative arrival ``weight`` and inclusive
    ``(lo, hi)`` ranges for prompt length and decode budget."""

    name: str
    weight: float = 1.0
    prompt_len: tuple = (8, 48)
    max_new: tuple = (4, 24)


DEFAULT_TENANTS = (TenantSpec("default"),)


class Arrival(NamedTuple):
    t: float              # seconds since run start (0.0 for closed loop)
    tenant: str
    prompt: np.ndarray    # int32 token ids
    max_new: int


def _gen_requests(rng: np.random.Generator, n: int,
                  tenants: Sequence[TenantSpec], vocab: int):
    w = np.asarray([t.weight for t in tenants], np.float64)
    w = w / w.sum()
    out = []
    for _ in range(n):
        t = tenants[int(rng.choice(len(tenants), p=w))]
        plen = int(rng.integers(t.prompt_len[0], t.prompt_len[1] + 1))
        mnew = int(rng.integers(t.max_new[0], t.max_new[1] + 1))
        prompt = rng.integers(0, vocab, size=(plen,), dtype=np.int32)
        out.append((t.name, prompt, mnew))
    return out


def poisson_workload(rate: float, n: int, seed: int, vocab: int,
                     tenants: Optional[Sequence[TenantSpec]] = None
                     ) -> List[Arrival]:
    """``n`` arrivals with exponential interarrival times (mean ``1/rate``
    req/s) — the memoryless independent-users model."""
    assert rate > 0 and n > 0
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / rate, size=n))
    reqs = _gen_requests(rng, n, tenants or DEFAULT_TENANTS, vocab)
    return [Arrival(float(t), name, p, m)
            for t, (name, p, m) in zip(times, reqs)]


def bursty_workload(rate: float, n: int, seed: int, vocab: int,
                    tenants: Optional[Sequence[TenantSpec]] = None,
                    cv: float = 3.0) -> List[Arrival]:
    """``n`` arrivals with Gamma interarrivals: mean ``1/rate`` but
    coefficient of variation ``cv`` (> 1 ⇒ burstier than Poisson — long
    gaps punctuated by clumps, the tail-stressing traffic shape)."""
    assert rate > 0 and n > 0 and cv > 0
    rng = np.random.default_rng(seed)
    shape = 1.0 / (cv * cv)
    times = np.cumsum(rng.gamma(shape, 1.0 / (rate * shape), size=n))
    reqs = _gen_requests(rng, n, tenants or DEFAULT_TENANTS, vocab)
    return [Arrival(float(t), name, p, m)
            for t, (name, p, m) in zip(times, reqs)]


def closed_workload(n: int, seed: int, vocab: int,
                    tenants: Optional[Sequence[TenantSpec]] = None
                    ) -> List[Arrival]:
    """``n`` requests with no arrival times (t=0) — feed a
    ``ClosedLoopSource``.  Same per-tenant sampling as the open-loop
    workloads, so closed-loop calibration and the open-loop sweep measure
    the same request population."""
    rng = np.random.default_rng(seed)
    reqs = _gen_requests(rng, n, tenants or DEFAULT_TENANTS, vocab)
    return [Arrival(0.0, name, p, m) for name, p, m in reqs]


class OpenLoopSource:
    """Submit each arrival when its timestamp comes due, regardless of
    server progress."""

    def __init__(self, arrivals: Sequence[Arrival]):
        self.arrivals = sorted(arrivals, key=lambda a: a.t)
        self.submitted_rids: List[int] = []
        self._i = 0

    def pump(self, sched, now: float) -> None:
        while (self._i < len(self.arrivals)
               and self.arrivals[self._i].t <= now):
            a = self.arrivals[self._i]
            self.submitted_rids.append(
                sched.submit(a.prompt, a.max_new, tenant=a.tenant))
            self._i += 1

    def exhausted(self) -> bool:
        return self._i >= len(self.arrivals)

    def next_arrival_in(self, now: float) -> Optional[float]:
        if self.exhausted():
            return None
        return max(self.arrivals[self._i].t - now, 0.0)


class ClosedLoopSource:
    """Hold ``concurrency`` requests outstanding: every completion (or
    shed) frees a slot that the next request immediately fills."""

    def __init__(self, requests: Sequence[Arrival], concurrency: int):
        assert concurrency > 0
        self.requests = list(requests)
        self.concurrency = concurrency
        self.submitted_rids: List[int] = []
        self._i = 0

    def pump(self, sched, now: float) -> None:
        done = sum(1 for rid in self.submitted_rids
                   if rid in sched.results)
        while (self._i < len(self.requests)
               and len(self.submitted_rids) - done < self.concurrency):
            a = self.requests[self._i]
            self.submitted_rids.append(
                sched.submit(a.prompt, a.max_new, tenant=a.tenant))
            self._i += 1
            done = sum(1 for rid in self.submitted_rids
                       if rid in sched.results)

    def exhausted(self) -> bool:
        return self._i >= len(self.requests)

    def next_arrival_in(self, now: float) -> Optional[float]:
        # The next submit is triggered by a completion, not by the clock —
        # there is in-flight work whenever we are not exhausted.
        return None if self.exhausted() else 0.0
