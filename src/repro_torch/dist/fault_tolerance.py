"""Fault tolerance of the train loop (port of ``PreemptionHandler`` from
``repro.dist.fault_tolerance``; heartbeats, the straggler monitor and the
elastic plan are not ported yet).

``PreemptionHandler`` is signal-based: SIGTERM/SIGINT only set a flag,
and the train loop checks it at step boundaries and checkpoints before it
exits.
"""

from __future__ import annotations

import signal


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
