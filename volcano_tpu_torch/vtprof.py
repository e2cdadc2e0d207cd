"""vtprof: the device/host critical-path profiler.

The port's copy of ``volcano_tpu/vtprof.py``, designed for the card.  The
trace (``trace.py``) answers "what happened inside one trace", the time
series (``timeseries.py``) "what has the control plane been doing cycle
over cycle"; this module answers the question every performance change
starts from: **which side of the dispatch boundary does the time live
on?**  The fast cycle's ``phases`` are wall clock only, so vtprof splits
every phase into four segments:

* ``host``      — Python, numpy and PyTorch host work (the phase's wall
                  minus the rest);
* ``dispatch``  — a kernel wrapper's launch returning (launches are
                  asynchronous: the host only enqueues);
* ``wait``      — the wait at a sanctioned fetch boundary, a stream
                  synchronize: device work the host actually waited on;
* ``transfer``  — the device-to-host copy of the packed output.

The sanctioned boundaries are :func:`fetch` / :func:`fetch_outputs`
(``tensor_actions``' allocate and dynamic solves, the sharded and
multi-controller fetches) and :func:`device_get` (the contention passes
of ``fast_victims.py`` and the object path's victim solve).

**Launch-shape sentinel** (the counterpart of the JAX module's compile
sentinel; the port has no JIT, so nothing compiles per shape): armed,
each kernel wrapper registers the shape key of every launch
(:func:`launch_begin`), and per-shape workspaces and each kernel library
build register as they are made (:func:`note_compile`).  The registry's
growth per kernel is what ``volcano_jit_compiles_total{kernel=}`` counts
on the card: a new launch shape, a new workspace or a library build.
After the warmup handshake (``Scheduler.prewarm`` calls
:meth:`Profiler.warmup_handshake`) the first cycle without growth marks
steady state, and any later growth is a ``steady-state-recompile``
**anomaly**: a time-series event, an entry of the ``anomalies`` section of
``trace.crash_dump()``, and a count of ``volcano_prof_anomalies_total``.
Unlike JAX's compile caches the registry records only while the
profiler is armed: a wrapper builds no shape key disarmed.  A shape first
launched armed is growth, which the first armed cycles absorb before
steady state (the handshake waits for a cycle without growth).

**Device time**: armed, a wrapper on the card records a CUDA event before
and after its launch; the pairs resolve (``Event.query``) at the next
fetch or cycle end into the kernel's ``device_s``, which
``volcano_kernel_device_seconds{kernel=}`` observes.  On the CPU (the
plain versions) the series observes wait + transfer, as the JAX module's.

**Memory watermarks**: per-cycle ``volcano_device_bytes{component=}``
gauges for the mirror, the snapshot and the device's allocated bytes
(``torch.cuda.memory_allocated``, 0 without a CUDA context), with the
anchored leak sentinel (``device-bytes-leak``).

**Disarmed is the default and costs one module attribute check per site**
(``PROFILER is None``); ``VOLCANO_TPU_PROF=1`` (or ``{"ring": N}``) arms at
import, tests arm in-process via :func:`arm`.  The profile is served at
``/debug/prof`` by the metrics server (``scheduler/metrics_server.py``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

ENV_VAR = "VOLCANO_TPU_PROF"
DEFAULT_RING = 512
MAX_ANOMALIES = 256

#: leak sentinel: compare the min device-bytes watermark of the trailing
#: window against the baseline window; trip once when it grew past
#: ratio x baseline AND by more than the absolute floor
LEAK_WINDOW = 16
LEAK_RATIO = 1.5
LEAK_MIN_BYTES = 16 << 20

_SEGMENTS = ("host", "dispatch", "wait", "transfer")
#: fast-cycle phases timed inside another phase (its sub-segments): the
#: attribution leaves them out, so that no second of a cycle counts twice
#: (the JAX module's attribution counts them beside their parent)
SUB_PHASES = {"publish_build": "publish", "publish_ship": "publish", "residue_vec": "subcycle"}

#: kernel name -> the launch-shape keys its wrapper has seen
_SHAPES: Dict[str, set] = {}
#: kernel name -> registry size: distinct launch shapes, plus the
#: workspaces and library builds made for it
_REGISTRY: Dict[str, int] = {}
_registry_mu = threading.Lock()


def note_compile(kernel: str, n: int = 1) -> None:
    """Armed, count ``n`` compile-like events of ``kernel`` in the
    registry: a per-shape workspace made, or a kernel library built."""
    if PROFILER is None:
        return
    with _registry_mu:
        _REGISTRY[kernel] = _REGISTRY.get(kernel, 0) + n


def registry_cache_sizes() -> Dict[str, int]:
    """The registry's size per kernel name."""
    with _registry_mu:
        return dict(_REGISTRY)


def launch_begin(kernel: str, key: tuple, device: torch.device):
    """A kernel wrapper's entry, before its device branch, armed only (the
    wrapper checks ``PROFILER is not None`` before it builds ``key``):
    register the launch shape ``key`` and count one dispatch of
    ``kernel``; on a CUDA device it returns a token holding a start event
    for :func:`launch_end`, else None."""
    prof = PROFILER
    if prof is None:
        return None
    shapes = _SHAPES.get(kernel)
    if shapes is None or key not in shapes:
        with _registry_mu:
            shapes = _SHAPES.setdefault(kernel, set())
            if key not in shapes:
                shapes.add(key)
                _REGISTRY[kernel] = _REGISTRY.get(kernel, 0) + 1
    prof.note_dispatch(kernel)
    if device.type != "cuda":
        return None
    start = torch.cuda.Event(enable_timing=True)
    start.record(torch.cuda.current_stream(device))
    return kernel, device, start


def count_dispatch(kernel: str) -> None:
    """Armed, count one dispatch of ``kernel`` made inside another
    wrapper's launch (K12a's blocked solve is a launch of K3 too)."""
    prof = PROFILER
    if prof is not None:
        prof.note_dispatch(kernel)


def launch_end(tok) -> None:
    """Close :func:`launch_begin`'s token after the launch: its end event,
    resolved into the kernel's device time at the next fetch or cycle
    end."""
    if tok is None:
        return
    kernel, device, start = tok
    end = torch.cuda.Event(enable_timing=True)
    end.record(torch.cuda.current_stream(device))
    prof = PROFILER
    if prof is not None:
        prof.pend_events(kernel, start, end)


def array_bytes(obj: Any) -> int:
    """Total nbytes of the numpy arrays and tensors hanging off ``obj`` (its
    attribute dict, or the mapping itself): the watermark estimator for the
    mirror and the snapshot.  Other attributes are ignored."""
    if obj is None:
        return 0
    values = obj.values() if isinstance(obj, dict) else vars(obj).values()
    total = 0
    for v in values:
        n = getattr(v, "nbytes", None)
        if isinstance(n, int):
            total += n
    return total


def _live_device_bytes() -> int:
    """Bytes the caching allocator holds for live tensors on the current
    card; 0 without a CUDA context (a ``cpu`` backend)."""
    if not torch.cuda.is_initialized():
        return 0
    return int(torch.cuda.memory_allocated())


def _kernel_row() -> Dict[str, float]:
    return {"dispatches": 0, "dispatch_s": 0.0, "wait_s": 0.0, "transfer_s": 0.0,
            "device_s": 0.0}


class Profiler:
    """Per-process critical-path accumulator: a bounded ring of per-cycle
    segment breakdowns, cumulative per-kernel totals, the launch-shape
    sentinel, and the memory watermarks."""

    def __init__(self, ring: int = DEFAULT_RING):
        self.ring_size = max(int(ring), 1)
        self._mu = threading.Lock()
        #: per-cycle records, oldest first
        self.cycles: deque = deque(maxlen=self.ring_size)
        #: kernel -> {dispatches, dispatch_s, wait_s, transfer_s, device_s,
        #: compiles}
        self.totals: Dict[str, Dict[str, float]] = {}
        self.anomalies: List[Dict[str, Any]] = []
        self.compiles_total = 0
        self._cache_seen: Dict[str, int] = {}
        self._warmed = False
        self.steady = False
        self._cycle_n = 0
        self._leak_tripped = False
        #: the anchored baseline: min device bytes over the first full
        #: window, captured once (a sliding one would let a slow leak
        #: outrun the ring)
        self._leak_baseline: Optional[int] = None
        #: the current cycle's accumulator; None outside a cycle (prewarm
        #: threads still record, into the totals only)
        self._cur: Optional[Dict[str, Any]] = None
        #: (kernel, start, end) CUDA event pairs not resolved yet
        self._events: List[tuple] = []
        #: the async applier's latest drain attribution (apply.py)
        self.drain: Dict[str, float] = {}
        #: mesh host id -> cumulative {build_s, dispatch_s, fetch_s} of the
        #: multi-controller solve (parallel/multihost.py, tensor_actions)
        self.hosts: Dict[str, Dict[str, float]] = {}

    # -- the hot sites -------------------------------------------------------

    def dispatch_end(self, tok: float, kernel: str, phase: str = "") -> None:
        """The wrapper call since ``tok`` (the site's ``time.perf_counter()``
        before it, taken armed only) returned: its wall is dispatch time of
        ``kernel`` in ``phase`` (the launches it made count in the wrappers,
        :func:`launch_begin`)."""
        self._note(kernel, phase, dispatch_s=time.perf_counter() - tok)

    def note_dispatch(self, kernel: str) -> None:
        self._note(kernel, None, dispatches=1)

    def record_fetch(self, kernel: str, phase: str, wait_s: float, transfer_s: float) -> None:
        self._note(kernel, phase, wait_s=wait_s, transfer_s=transfer_s)
        self.resolve_events()

    def pend_events(self, kernel: str, start, end) -> None:
        with self._mu:
            self._events.append((kernel, start, end))

    def resolve_events(self) -> None:
        """Fold the event pairs whose end has completed into their kernels'
        ``device_s``; later ones wait for the next call."""
        with self._mu:
            pending, self._events = self._events, []
        done, left = [], []
        for kernel, start, end in pending:
            if end.query():
                done.append((kernel, start.elapsed_time(end) / 1e3))
            else:
                left.append((kernel, start, end))
        with self._mu:
            self._events = left + self._events
        for kernel, seconds in done:
            self._note(kernel, None, device_s=seconds)

    def _note(self, kernel: str, phase: Optional[str], **incr) -> None:
        """Add ``incr`` to the kernel's totals and the current cycle's
        kernel row; the time segments also to ``phase``'s device row
        (``phase=None``: counts and device time, which are no segment)."""
        with self._mu:
            tot = self.totals.setdefault(kernel, dict(_kernel_row(), compiles=0))
            for k, v in incr.items():
                tot[k] += v
            cur = self._cur
            if cur is None:
                return
            kc = cur["kernels"].setdefault(kernel, _kernel_row())
            for k, v in incr.items():
                kc[k] += v
            if phase is None:
                return
            pd = cur["phase_dev"].setdefault(phase or "device",
                                             {"dispatch": 0.0, "wait": 0.0, "transfer": 0.0})
            pd["dispatch"] += incr.get("dispatch_s", 0.0)
            pd["wait"] += incr.get("wait_s", 0.0)
            pd["transfer"] += incr.get("transfer_s", 0.0)

    def note_host(self, name: str, seconds: float) -> None:
        """A named host sub-segment (volsolve's claim interning): rides the
        cycle record for the report's host breakdown."""
        with self._mu:
            cur = self._cur
            if cur is not None:
                cur["host_notes"][name] = cur["host_notes"].get(name, 0.0) + seconds

    def note_mesh_host(self, host, **walls: float) -> None:
        """Accumulate one mesh host's solve walls (``build_s`` /
        ``dispatch_s`` / ``fetch_s``) across cycles (the payload's
        ``hosts`` table)."""
        with self._mu:
            row = self.hosts.setdefault(str(host), {})
            for k, v in walls.items():
                row[k] = row.get(k, 0.0) + float(v)

    def count(self, name: str, n: int = 1) -> None:
        with self._mu:
            cur = self._cur
            if cur is not None:
                cur["counts"][name] = cur["counts"].get(name, 0) + n

    def note_bytes(self, component: str, nbytes: int) -> None:
        with self._mu:
            cur = self._cur
            if cur is not None:
                cur["bytes"][component] = int(nbytes)

    # -- the launch-shape sentinel --------------------------------------------

    def _scan_compiles_locked(self) -> Dict[str, int]:
        deltas: Dict[str, int] = {}
        for name, size in registry_cache_sizes().items():
            d = size - self._cache_seen.get(name, 0)
            if d > 0:
                deltas[name] = d
            self._cache_seen[name] = size
        return deltas

    def _fold_compiles_locked(self, deltas: Dict[str, int]) -> int:
        n = sum(deltas.values())
        self.compiles_total += n
        for k, d in deltas.items():
            self.totals.setdefault(k, dict(_kernel_row(), compiles=0))["compiles"] += d
        return n

    def warmup_handshake(self) -> None:
        """End of warmup: the registry's growth so far was expected
        (prewarm, first launches).  The first cycle without growth after
        this marks steady state; later growth is an anomaly."""
        with self._mu:
            deltas = self._scan_compiles_locked()
            self._fold_compiles_locked(deltas)
            self._warmed = True
        self._emit_compile_metrics(deltas)

    def _emit_compile_metrics(self, deltas: Dict[str, int]) -> None:
        if not deltas:
            return
        from volcano_tpu_torch.scheduler import metrics

        for kernel, d in deltas.items():
            metrics.register_jit_compile(kernel, d)

    # -- cycle scope -----------------------------------------------------------

    @staticmethod
    def _empty_cur() -> Dict[str, Any]:
        return {"kernels": {}, "phase_dev": {}, "host_notes": {}, "counts": {}, "bytes": {}}

    def begin_cycle(self) -> None:
        with self._mu:
            self._cur = self._empty_cur()

    def end_cycle(self, dur_s: float, phases: Dict[str, float], path: str,
                  mirror: Any = None) -> None:
        """Close the cycle scope: fold the site records into one per-cycle
        segment breakdown, scan the launch-shape registry, sample the
        memory watermarks, and run the sentinels.  Armed-only (callers
        check ``PROFILER is None`` first)."""
        if mirror is not None:
            self.note_bytes("mirror", array_bytes(mirror))
        self.resolve_events()
        dev_bytes = _live_device_bytes()
        with self._mu:
            cur = self._cur or self._empty_cur()
            self._cur = None
            deltas = self._scan_compiles_locked()
            ncomp = self._fold_compiles_locked(deltas)
            cur["bytes"]["device"] = dev_bytes
            per_phase = self._attribute_locked(dur_s, phases, cur)
            seg = {s: 0.0 for s in _SEGMENTS}
            for row in per_phase.values():
                for s in _SEGMENTS:
                    seg[s] += row[s]
            rec = {
                "cycle": self._cycle_n,
                "path": path,
                "dur_s": round(dur_s, 6),
                "phases": {k: round(v, 6) for k, v in (phases or {}).items()},
                "per_phase": per_phase,
                "seg": {k: round(v, 6) for k, v in seg.items()},
                "kernels": cur["kernels"],
                "host_notes": {k: round(v, 6) for k, v in cur["host_notes"].items()},
                "counts": cur["counts"],
                "bytes": cur["bytes"],
                "compiles": deltas,
            }
            self._cycle_n += 1
            self.cycles.append(rec)
            anomalies_out = []
            if self._warmed:
                if ncomp == 0:
                    self.steady = True
                elif self.steady:
                    anomalies_out.append({"kind": "steady-state-recompile",
                                          "cycle": rec["cycle"], "kernels": dict(deltas)})
            leak = self._leak_check_locked()
            if leak is not None:
                anomalies_out.append(leak)
            for a in anomalies_out:
                if len(self.anomalies) < MAX_ANOMALIES:
                    self.anomalies.append(a)
        # emitted outside the lock: the metrics and time-series layers take
        # their own locks
        self._emit_cycle_metrics(rec, deltas, anomalies_out)

    def _attribute_locked(self, dur_s, phases, cur) -> Dict[str, Dict]:
        """Per-phase host/dispatch/wait/transfer rows.  Device parts
        recorded under a fast-cycle phase name live inside that phase's
        wall; parts under any other label (the object path, prewarm
        stragglers) become their own pseudo-phase.  ``SUB_PHASES`` get no
        row: their parent's covers them."""
        per_phase: Dict[str, Dict[str, float]] = {}
        phase_dev = cur["phase_dev"]
        for name, total in (phases or {}).items():
            if name in SUB_PHASES:
                continue
            dev = phase_dev.get(name, {})
            d, w, t = dev.get("dispatch", 0.0), dev.get("wait", 0.0), dev.get("transfer", 0.0)
            per_phase[name] = {"total": total, "host": max(total - d - w - t, 0.0),
                               "dispatch": d, "wait": w, "transfer": t}
        extra_dev = 0.0
        for name, dev in phase_dev.items():
            if name in per_phase:
                continue
            d, w, t = dev["dispatch"], dev["wait"], dev["transfer"]
            per_phase[name] = {"total": d + w + t, "host": 0.0,
                               "dispatch": d, "wait": w, "transfer": t}
            extra_dev += d + w + t
        if not phases:
            # an object-path cycle has no phase breakdown: everything
            # outside the recorded device parts is host work
            rest = max(dur_s - extra_dev, 0.0)
            per_phase["cycle"] = {"total": rest, "host": rest,
                                  "dispatch": 0.0, "wait": 0.0, "transfer": 0.0}
        return {name: {k: round(v, 6) for k, v in row.items()}
                for name, row in per_phase.items()}

    def _leak_check_locked(self) -> Optional[Dict[str, Any]]:
        if self._leak_tripped:
            return None
        if self._leak_baseline is None:
            if len(self.cycles) < LEAK_WINDOW:
                return None
            series = [c["bytes"].get("device", 0) for c in self.cycles]
            self._leak_baseline = min(series[:LEAK_WINDOW])
        if len(self.cycles) < 2 * LEAK_WINDOW:
            return None
        baseline = self._leak_baseline
        recent = min(c["bytes"].get("device", 0) for c in list(self.cycles)[-LEAK_WINDOW:])
        if recent > baseline * LEAK_RATIO and recent - baseline > LEAK_MIN_BYTES:
            self._leak_tripped = True
            return {"kind": "device-bytes-leak", "cycle": self.cycles[-1]["cycle"],
                    "baseline_bytes": int(baseline), "recent_bytes": int(recent)}
        return None

    def _emit_cycle_metrics(self, rec, deltas, anomalies_out) -> None:
        from volcano_tpu_torch import timeseries
        from volcano_tpu_torch.scheduler import metrics

        self._emit_compile_metrics(deltas)
        for phase, row in rec["per_phase"].items():
            for segment in _SEGMENTS:
                if row[segment] > 0.0:
                    metrics.observe_prof_segment(phase, segment, row[segment])
        for kernel, kc in rec["kernels"].items():
            if kc.get("dispatches"):
                metrics.register_kernel_dispatch(kernel, kc["dispatches"])
            dev = kc.get("device_s", 0.0) or kc.get("wait_s", 0.0) + kc.get("transfer_s", 0.0)
            if dev > 0.0:
                metrics.observe_kernel_device_seconds(kernel, dev)
        for component, n in rec["bytes"].items():
            metrics.update_device_bytes(component, n)
        for a in anomalies_out:
            metrics.register_prof_anomaly(a["kind"])
            # the sample's kind stays "anomaly"; the trip class rides as
            # its ``anomaly`` field
            timeseries.record("anomaly", anomaly=a["kind"],
                              **{k: v for k, v in a.items() if k != "kind"})

    # -- readout ---------------------------------------------------------------

    def anomalies_snapshot(self) -> List[Dict[str, Any]]:
        with self._mu:
            return list(self.anomalies)

    def note_drain(self, stats: Dict[str, float]) -> None:
        """Snapshot the applier's cumulative drain attribution into the
        payload."""
        snap = dict(stats)
        with self._mu:
            self.drain = snap

    def payload(self) -> Dict[str, Any]:
        """The ``/debug/prof`` response body and the report's input."""
        with self._mu:
            return {
                "armed": True,
                "pid": os.getpid(),
                "now": time.time(),
                "ring": self.ring_size,
                "steady": self.steady,
                "compiles_total": self.compiles_total,
                "cycles": list(self.cycles),
                "totals": {k: dict(v) for k, v in self.totals.items()},
                "anomalies": list(self.anomalies),
                "drain": dict(self.drain),
                "hosts": {h: {k: round(v, 6) for k, v in row.items()}
                          for h, row in self.hosts.items()},
            }

    def summary(self) -> Dict[str, Any]:
        """Compact form for crash-dump artifacts."""
        with self._mu:
            return {
                "cycles": self._cycle_n,
                "steady": self.steady,
                "compiles_total": self.compiles_total,
                "totals": {k: dict(v) for k, v in self.totals.items()},
                "last_cycle": self.cycles[-1] if self.cycles else None,
            }


# -- attribution and report over a payload -------------------------------------


def attribution(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Coverage over a payload's cycle ring: how much of the sampled wall
    lands in named host/dispatch/wait/transfer segments (the bar: 0.95)."""
    wall = 0.0
    attributed = 0.0
    seg_totals = {s: 0.0 for s in _SEGMENTS}
    phase_rows: Dict[str, Dict[str, float]] = {}
    for cyc in payload.get("cycles", ()):
        wall += cyc.get("dur_s", 0.0)
        for name, row in cyc.get("per_phase", {}).items():
            agg = phase_rows.setdefault(name, {"total": 0.0, **{s: 0.0 for s in _SEGMENTS}})
            agg["total"] += row["total"]
            for s in _SEGMENTS:
                agg[s] += row[s]
                seg_totals[s] += row[s]
            attributed += row["total"]
    return {
        "wall_s": wall,
        "attributed_s": attributed,
        "coverage": (attributed / wall) if wall > 0 else 1.0,
        "segments": seg_totals,
        "phases": phase_rows,
    }


def report_text(payload: Dict[str, Any], width: int = 28) -> str:
    """Flame-style text report: per-phase bars split into host / dispatch /
    wait / transfer, the per-kernel table, the memory watermarks and the
    anomaly tail."""
    if not payload.get("armed") or not payload.get("cycles"):
        return "no profile samples (arm the profiler with VOLCANO_TPU_PROF=1)\n"
    att = attribution(payload)
    lines = [
        f"vtprof: {len(payload['cycles'])} cycle(s) sampled "
        f"(pid {payload.get('pid', '?')}), wall {att['wall_s']:.3f}s, "
        f"attributed {att['coverage'] * 100:.1f}%"
        + (" [steady]" if payload.get("steady") else ""),
    ]
    wall = max(att["wall_s"], 1e-9)
    seg_mark = {"host": "H", "dispatch": "D", "wait": "W", "transfer": "T"}
    for name, row in sorted(att["phases"].items(), key=lambda kv: -kv[1]["total"]):
        bar = "".join(seg_mark[s] * int(round(width * row[s] / wall)) for s in _SEGMENTS)
        lines.append(
            f"  {name:<12} {row['total']:.4f}s |{bar:<{width}}| "
            + " ".join(f"{s}={row[s]:.4f}" for s in _SEGMENTS if row[s] > 0))
    unatt = att["wall_s"] - att["attributed_s"]
    lines.append(f"  {'unattributed':<12} {max(unatt, 0.0):.4f}s")
    totals = payload.get("totals", {})
    if totals:
        lines.append("kernels:")
        for kernel, t in sorted(totals.items()):
            lines.append(
                f"  {kernel:<28} dispatches={int(t.get('dispatches', 0)):<6} "
                f"compiles={int(t.get('compiles', 0)):<3} "
                f"dispatch={t.get('dispatch_s', 0.0):.4f}s "
                f"wait={t.get('wait_s', 0.0):.4f}s "
                f"transfer={t.get('transfer_s', 0.0):.4f}s "
                f"device={t.get('device_s', 0.0):.4f}s")
    last = payload["cycles"][-1]
    if last.get("bytes"):
        lines.append("memory watermarks (last cycle): " + " ".join(
            f"{k}={v / (1 << 20):.1f}MiB" for k, v in sorted(last["bytes"].items())))
    hosts = payload.get("hosts") or {}
    if hosts:
        lines.append("mesh hosts (solve critical path, cumulative):")
        for h, row in sorted(hosts.items(), key=lambda kv: kv[0]):
            lines.append(f"  host {h:<4} path={sum(row.values()):.4f}s " + " ".join(
                f"{k.removesuffix('_s')}={v:.4f}s" for k, v in sorted(row.items())))
    anomalies = payload.get("anomalies") or []
    if anomalies:
        lines.append(f"anomalies: {len(anomalies)}")
        for a in anomalies[-5:]:
            detail = " ".join(f"{k}={v}" for k, v in sorted(a.items()) if k != "kind")
            lines.append(f"  {a['kind']} {detail}")
    else:
        lines.append("anomalies: none")
    return "\n".join(lines) + "\n"


# -- arming ----------------------------------------------------------------------


def _profiler_from_env(raw: str) -> Optional[Profiler]:
    raw = (raw or "").strip()
    if not raw or raw in ("0", "off", "none"):
        return None
    if raw.startswith("{"):
        try:
            cfg = json.loads(raw)
        except ValueError:
            cfg = {}
        return Profiler(ring=int(cfg.get("ring", DEFAULT_RING)))
    return Profiler()


#: the process profiler; None: disarmed, and every instrumentation site is
#: one ``vtprof.PROFILER is None`` attribute check
PROFILER: Optional[Profiler] = _profiler_from_env(os.environ.get(ENV_VAR, ""))


def arm(profiler: Optional[Profiler] = None) -> Profiler:
    """Arm profiling in-process (tests, embedders); returns the profiler."""
    global PROFILER
    PROFILER = profiler or Profiler()
    return PROFILER


def disarm() -> None:
    global PROFILER
    PROFILER = None


# -- the sanctioned fetch boundaries ---------------------------------------------


def _wait(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def fetch(out: torch.Tensor, kernel: str, phase: str = "", span: Any = None) -> np.ndarray:
    """THE sanctioned device-to-host fetch of one packed solve output:
    disarmed it is exactly a stream synchronize and ``out.cpu().numpy()``;
    armed it times the two apart (wait, transfer), attributes both to
    ``kernel`` / ``phase``, and annotates the enclosing trace span when
    given."""
    prof = PROFILER
    if prof is None:
        _wait(out)
        return out.cpu().numpy()
    t0 = time.perf_counter()
    _wait(out)
    t1 = time.perf_counter()
    arr = out.cpu().numpy()
    t2 = time.perf_counter()
    prof.record_fetch(kernel, phase, t1 - t0, t2 - t1)
    if span is not None:
        span.annotate(wait_s=round(t1 - t0, 6), transfer_s=round(t2 - t1, 6))
    return arr


def fetch_outputs(outs: Sequence[torch.Tensor], kernel: str, phase: str = "solve",
                  host=None, span: Any = None) -> tuple:
    """THE sanctioned per-host fetch of a solve-output tuple: disarmed it
    is :func:`fetch` per output; armed, each output's wait and transfer
    attribute to ``kernel`` / ``phase``, and with ``host`` the whole
    boundary's wall rolls up under that mesh host's ``fetch_s``."""
    prof = PROFILER
    if prof is None:
        return tuple(fetch(o, kernel) for o in outs)
    t0 = time.perf_counter()
    arrs = tuple(fetch(o, kernel=kernel, phase=phase, span=span) for o in outs)
    if host is not None:
        prof.note_mesh_host(host, fetch_s=time.perf_counter() - t0)
    return arrs


def _host_copies(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Host copies of ``tensors`` in ONE device-to-host transfer: their
    bytes are packed into one buffer on the device and split on the host."""
    flat = [t.detach().reshape(-1) for t in tensors]
    host = torch.cat([f.view(torch.uint8) for f in flat]).cpu().numpy()
    out, at = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel() * f.element_size()
        dt = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(host[at:at + n].view(dt).reshape(tuple(t.shape)).copy())
        at += n
    return out


def device_get(tensors: Sequence[torch.Tensor], kernel: str, phase: str = "") -> List[np.ndarray]:
    """THE sanctioned whole-pass fetch of the contention solves: host
    copies of ``tensors`` in one transfer.  Disarmed it is exactly that
    copy (which waits for the stream); armed a stream synchronize first
    splits the wait from the transfer."""
    prof = PROFILER
    if prof is None:
        return _host_copies(tensors)
    t0 = time.perf_counter()
    _wait(tensors[0])
    t1 = time.perf_counter()
    out = _host_copies(tensors)
    t2 = time.perf_counter()
    prof.record_fetch(kernel, phase, t1 - t0, t2 - t1)
    return out


def debug_payload() -> Dict[str, Any]:
    """The ``/debug/prof`` response body (the metrics server's)."""
    prof = PROFILER
    if prof is None:
        return {"armed": False, "pid": os.getpid(), "now": time.time(),
                "cycles": [], "totals": {}, "anomalies": [], "drain": {}, "hosts": {}}
    return prof.payload()
