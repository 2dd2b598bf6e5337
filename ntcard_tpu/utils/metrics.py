"""Structured timing/metrics — the replacement for the reference's single
``Runtime(sec):`` stderr line (ntcard.cpp:321,476), per SURVEY.md §5.

Phases: decode+pack (host), device (dispatch+compute), merge+finalize,
estimate, output. Enabled with ``--metrics`` (ntcard CLI) or
``NTCARD_METRICS=1``; emits one JSON object to stderr. ``NTCARD_PROFILE=dir``
additionally captures a ``jax.profiler`` trace of the device phase.
"""

from __future__ import annotations

import json
import os
import sys
import time
from contextlib import contextmanager
from typing import Dict, Optional


class Metrics:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled or bool(os.environ.get("NTCARD_METRICS"))
        self.phases: Dict[str, float] = {}
        self.counters: Dict[str, float] = {}
        self._t0 = time.monotonic()
        self._profile_dir: Optional[str] = os.environ.get("NTCARD_PROFILE") or None
        self._profiling = False

    @contextmanager
    def phase(self, name: str):
        t = time.monotonic()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (time.monotonic() - t)

    def add(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def tag(self, name: str, value: str) -> None:
        """Non-numeric annotation (e.g. which engine ran)."""
        self.tags = getattr(self, "tags", {})
        self.tags[name] = value

    def start_profile(self) -> None:
        if self._profile_dir and not self._profiling:
            from ntcard_tpu import _jax_config  # noqa: F401
            import jax

            jax.profiler.start_trace(self._profile_dir)
            self._profiling = True

    def stop_profile(self) -> None:
        if self._profiling:
            from ntcard_tpu import _jax_config  # noqa: F401
            import jax

            jax.profiler.stop_trace()
            self._profiling = False

    def report(self, stream=None) -> Optional[dict]:
        if not self.enabled:
            return None
        total = time.monotonic() - self._t0
        out = {
            "total_sec": round(total, 4),
            "phases_sec": {k: round(v, 4) for k, v in self.phases.items()},
            "counters": {k: round(v, 1) for k, v in self.counters.items()},
        }
        out.update(getattr(self, "tags", {}))
        if "jax" in sys.modules:  # device runs: peak device memory of the run
            import jax

            peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in jax.local_devices()]
            peaks = [p for p in peaks if p is not None]
            if peaks:
                out["device_peak_bytes"] = max(peaks)
        bases = self.counters.get("bases", 0)
        reads = self.counters.get("reads", 0)
        if bases and total > 0:
            out["gbp_per_sec"] = round(bases / total / 1e9, 4)
        if reads and total > 0:
            out["reads_per_sec"] = round(reads / total, 1)
        (stream or sys.stderr).write(json.dumps(out) + "\n")
        return out
