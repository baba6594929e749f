"""Fault tolerance of the train loop (port of
``repro.dist.fault_tolerance``): host-side, no device state.

  * ``Heartbeat``         — file-based liveness: each rank rewrites one JSON
                            file, ``<dir>/heartbeats/rank_<r>.json``,
                            atomically; any rank (or a watchdog) lists
                            stale peers by mtime.  The JAX package's
                            format, so either package's ``stale_ranks``
                            reads the other's files.  No collective: it
                            keeps working while a failed rank is wedged
                            inside one.
  * ``StragglerMonitor``  — flags step-time outliers by z-score against a
                            running mean/std of healthy steps.
  * ``PreemptionHandler`` — SIGTERM/SIGINT set a flag; the train loop
                            checkpoints at the next step boundary (on a
                            mesh the ranks agree on that step by a max
                            all-reduce of the flag).
  * ``elastic_plan``      — a ``(data[, pod], model)`` mesh shape for the
                            devices that survive, shrinking the data axis
                            first and reporting devices left idle.
"""

from __future__ import annotations

import json
import os
import signal
import time
from typing import List


# ------------------------------------------------------------------ heartbeat
class Heartbeat:
    """File-based liveness beacon, one file per rank.

    ``beat`` atomically rewrites ``<dir>/heartbeats/rank_<r>.json``; staleness
    is judged by file mtime so readers need no clock agreement with writers
    beyond the shared filesystem's.
    """

    SUBDIR = "heartbeats"

    def __init__(self, directory: str, rank: int):
        self.rank = int(rank)
        self.dir = os.path.join(directory, self.SUBDIR)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, f"rank_{self.rank}.json")

    def beat(self, step: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"rank": self.rank, "step": int(step),
                       "time": time.time()}, f)
        os.replace(tmp, self.path)

    @staticmethod
    def stale_ranks(directory: str, timeout_s: float) -> List[int]:
        """Ranks whose last beat is at least ``timeout_s`` seconds old."""
        hb_dir = os.path.join(directory, Heartbeat.SUBDIR)
        if not os.path.isdir(hb_dir):
            return []
        now = time.time()
        stale = []
        for name in os.listdir(hb_dir):
            if not (name.startswith("rank_") and name.endswith(".json")):
                continue
            try:
                rank = int(name[len("rank_"):-len(".json")])
            except ValueError:
                continue
            try:
                age = now - os.path.getmtime(os.path.join(hb_dir, name))
            except OSError:
                age = float("inf")
            if age >= timeout_s:
                stale.append(rank)
        return sorted(stale)


# ----------------------------------------------------------------- stragglers
class StragglerMonitor:
    """Z-score step-time outlier detector.

    Keeps a running mean/variance (Welford) of *healthy* step times; a step is
    a straggler when, after ``warmup_steps`` healthy samples, its one-sided
    z-score exceeds ``z_threshold``.  Flagged steps are excluded from the
    statistics so a long stall does not raise the baseline and mask the next
    one.  A relative floor on the std keeps near-constant step times (var ~ 0)
    from turning measurement noise into infinite z-scores.
    """

    def __init__(self, z_threshold: float = 3.0, warmup_steps: int = 10):
        self.z_threshold = float(z_threshold)
        self.warmup_steps = int(warmup_steps)
        self.n = 0
        self.mean = 0.0
        self._m2 = 0.0
        self.events: list = []

    def _std(self) -> float:
        var = self._m2 / self.n if self.n > 0 else 0.0
        std = max(var, 0.0) ** 0.5
        return max(std, 1e-2 * abs(self.mean), 1e-9)

    def record(self, step: int, dt: float) -> bool:
        """Record one step time; True iff this step is flagged a straggler."""
        dt = float(dt)
        flagged = False
        if self.n >= self.warmup_steps:
            z = (dt - self.mean) / self._std()
            flagged = z > self.z_threshold
        if flagged:
            self.events.append({"step": int(step), "dt": dt})
            return True
        self.n += 1
        delta = dt - self.mean
        self.mean += delta / self.n
        self._m2 += delta * (dt - self.mean)
        return False

    def summary(self) -> dict:
        return {
            "straggler_events": len(self.events),
            "healthy_steps": self.n,
            "mean_step_s": self.mean,
            "std_step_s": (self._m2 / self.n) ** 0.5 if self.n else 0.0,
            "events": list(self.events),
        }


# ----------------------------------------------------------------- preemption
class PreemptionHandler:
    """Convert SIGTERM/SIGINT into a cooperative ``requested`` flag.
    ``restore`` reinstates the previous handlers (safe to call twice)."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, signals=SIGNALS):
        self.requested = False
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            except (ValueError, OSError):  # not the main thread
                pass

    def _on_signal(self, signum, frame):
        self.requested = True

    def restore(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev = {}


# ----------------------------------------------------------------- elasticity
def elastic_plan(n_devices: int, tp: int = 16, want_pods: bool = False,
                 pod_data: int = 16) -> dict:
    """Mesh shape for ``n_devices`` surviving chips.

    Policy: tensor parallelism is load-bearing (it sets the per-device weight
    shard sizes a restored checkpoint expects), so ``tp`` is preserved when
    possible — shrunk only when fewer than ``tp`` devices remain — and host
    loss shrinks the *data* axis.  Devices beyond ``data * tp`` idle (a lost
    host inside a pod leaves a ragged remainder: 248 chips at tp=16 run as a
    (15, 16) mesh with 8 idle).  With ``want_pods`` a large data axis splits
    into ``(pod, data)`` with ``data == pod_data`` when it divides evenly.

    Returns ``{"shape", "axes", "devices_idle", "n_devices", "tp"}`` ready
    for ``repro_torch.launch.mesh.make_mesh(plan["shape"], plan["axes"])``.
    """
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    tp_eff = max(1, min(int(tp), n))
    data = n // tp_eff
    shape = (data, tp_eff)
    axes = ("data", "model")
    if want_pods and data > pod_data and data % pod_data == 0:
        shape = (data // pod_data, pod_data, tp_eff)
        axes = ("pod", "data", "model")
    used = 1
    for s in shape:
        used *= s
    return {"shape": shape, "axes": axes, "devices_idle": n - used,
            "n_devices": n, "tp": tp_eff}
