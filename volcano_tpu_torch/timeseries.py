"""A bounded per-cycle flight recorder: what the scheduler has been doing,
cycle over cycle.

The port's copy of ``volcano_tpu/timeseries.py``.  An armed process keeps
a bounded ring of samples; the scheduler records one ``kind="cycle"``
sample after every completed cycle (``Scheduler._record_cycle``): its
wall, the fast cycle's phases, the backlog (pending tasks entering the
solve), the binds and evictions published, the applier's queued entries,
and under ``delta: on`` the engine's ``mode``, ``fallback_reason``,
``backlog_gangs``, ``held_gangs`` and ``shed_gangs``, and while the
profiler is armed (``vtprof.py``) the cycle's ``host_s``, ``device_s``
(dispatch + wait) and ``transfer_s`` segments and, on a multi-controller
run, the per-host solve walls ``mesh_hosts``.  The profiler's sentinels
record ``kind="anomaly"`` samples: ``anomaly`` carries the trip class
(``steady-state-recompile``, ``device-bytes-leak``) beside the trip's
fields.  The metrics server serves the ring at ``/debug/timeseries``
(:func:`debug_payload`); the store server's flush samples wait for item 11.

Unarmed is the default and costs one module attribute check per site
(``RECORDER is None``); :func:`arm` arms in-process.  The JAX package's
``VOLCANO_TPU_TIMESERIES`` variable comes with the port's daemon, its only
reader (ROADMAP item 11).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

DEFAULT_RING = 2048


class Recorder:
    """Bounded ring of samples."""

    def __init__(self, ring: int = DEFAULT_RING):
        self.ring_size = max(int(ring), 1)
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=self.ring_size)
        self._seq = 0

    def record(self, kind: str, **fields: Any) -> None:
        with self._mu:
            self._seq += 1
            self._ring.append({"seq": self._seq, "kind": kind, "ts": time.time(), **fields})

    def samples(self) -> List[Dict[str, Any]]:
        """The ring, oldest first."""
        with self._mu:
            return list(self._ring)

    def payload(self) -> Dict[str, Any]:
        return {"armed": True, "pid": os.getpid(), "now": time.time(),
                "ring": self.ring_size, "samples": self.samples()}


#: the process recorder; None: unarmed, and every recording site is one
#: ``timeseries.RECORDER is None`` check
RECORDER: Optional[Recorder] = None


def arm(recorder: Optional[Recorder] = None) -> Recorder:
    """Arm recording in-process; returns the recorder."""
    global RECORDER
    RECORDER = recorder or Recorder()
    return RECORDER


def disarm() -> None:
    global RECORDER
    RECORDER = None


def record(kind: str, **fields: Any) -> None:
    """Record one sample when armed; nothing otherwise."""
    rec = RECORDER
    if rec is not None:
        rec.record(kind, **fields)


def samples() -> List[Dict[str, Any]]:
    rec = RECORDER
    return rec.samples() if rec is not None else []


def debug_payload() -> Dict[str, Any]:
    """The ``/debug/timeseries`` response body (the metrics server's)."""
    rec = RECORDER
    if rec is None:
        return {"armed": False, "pid": os.getpid(), "now": time.time(), "samples": []}
    return rec.payload()
