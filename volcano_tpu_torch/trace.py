"""vtrace: scheduling traces and a per-process flight recorder.

The port's copy of ``volcano_tpu/trace.py``: every control-plane process
gets a span runtime whose **disarmed default costs one module attribute
check per instrumentation site** (``TRACER is None``); arming is opt-in
through ``VOLCANO_TPU_TRACE``.

Concepts
--------

* A **span** is one timed unit of work (a scheduler cycle, one action,
  one plugin callback, a device solve, a bind).  Spans carry a
  ``trace_id`` / ``span_id`` / ``parent_id`` triple; nesting is ambient
  (thread-local): a span opened inside another becomes its child, a span
  opened with no ambient context roots a fresh trace.
* The **flight recorder** is a bounded per-process ring buffer of
  completed spans.  ``/debug/trace`` on the metrics server
  (``scheduler/metrics_server.py``) serves it live, and
  :func:`crash_dump` writes it as a JSON artifact on an invariant
  violation, with the time-series ring and the profiler's anomalies and
  summary beside the spans.
* **Propagation** rides the objects: a gang's root trace id in the
  ``volcano.sh/trace-id`` annotation (:func:`stamp`), which the
  scheduler joins at bind time.  The ``X-Volcano-Trace`` header helpers
  (:func:`format_header`, :func:`parse_header`, :func:`request_context`)
  carry a client's context into the store server's request span
  (``store/client.py``, ``store/server.py``).

Arming: ``VOLCANO_TPU_TRACE=1`` (defaults) or a JSON dict
``{"ring": 4096, "dir": "/path/for/crash/dumps"}``.  ``0``/``off``/unset
disarm.  Tests arm in-process via :func:`arm`/:func:`disarm`.

Discipline: spans are opened with ``with span(...)`` only, never around a
kernel launch's inside; device work is timed at the sanctioned fetch
boundaries (``vtprof.fetch`` / ``vtprof.device_get``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple


ENV_VAR = "VOLCANO_TPU_TRACE"
#: wire header carrying "trace_id span_id" between RemoteStore and server
HEADER = "X-Volcano-Trace"
#: object annotation carrying a gang's trace id across the store bus
TRACE_ID_KEY = "volcano.sh/trace-id"
DEFAULT_RING = 4096

_uid_mu = threading.Lock()
_uid_n = 0


def new_id(prefix: str) -> str:
    """Process-unique, creation-ordered id (pid-salted so ids from
    different daemons never collide in a merged dump)."""
    global _uid_n
    with _uid_mu:
        _uid_n += 1
        n = _uid_n
    return f"{prefix}-{os.getpid():x}-{n:08d}"


class _Ctx(threading.local):
    """Ambient trace context: each thread nests its own span stack."""

    trace_id = ""
    span_id = ""
    component = ""


_ctx = _Ctx()
#: process-default component name (first set_component wins); threads can
#: override for themselves (several "daemons" in one process)
_proc_component = ""


def set_component(name: str) -> None:
    """Name the daemon this thread's spans belong to ("scheduler",
    "controller", "kubelet", "apiserver", ...)."""
    global _proc_component
    _ctx.component = name
    if not _proc_component:
        _proc_component = name


def component() -> str:
    return _ctx.component or _proc_component


def current() -> Tuple[str, str]:
    """(trace_id, span_id) of the ambient context — what the RemoteStore
    client attaches to the X-Volcano-Trace header."""
    return _ctx.trace_id, _ctx.span_id


def format_header(trace_id: str, span_id: str) -> str:
    return f"{trace_id} {span_id}"


def parse_header(value: str) -> Tuple[str, str]:
    parts = (value or "").split()
    if not parts:
        return "", ""
    return parts[0], parts[1] if len(parts) > 1 else ""


class Tracer:
    """The flight recorder: a bounded ring of completed span records."""

    def __init__(self, ring: int = DEFAULT_RING, dump_dir: str = ""):
        self.ring_size = max(int(ring), 1)
        self.dump_dir = dump_dir
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=self.ring_size)

    def record(self, rec: Dict[str, Any]) -> None:
        with self._mu:
            self._ring.append(rec)

    def records(self) -> List[Dict[str, Any]]:
        """Snapshot of the ring, oldest first."""
        with self._mu:
            return list(self._ring)

    def dump(self, reason: str = "") -> Dict[str, Any]:
        return {
            "pid": os.getpid(),
            "component": component(),
            "reason": reason,
            "ring": self.ring_size,
            "spans": self.records(),
        }

    def dump_to(self, path: str, reason: str = "",
                extra: Optional[Dict[str, Any]] = None) -> str:
        """Atomic artifact write (temp + rename); ``extra`` merges
        additional top-level keys into the payload (crash_dump attaches
        the time-series ring this way)."""
        payload = self.dump(reason)
        if extra:
            payload.update(extra)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path


class _NoopSpan:
    """Shared do-nothing span returned while disarmed: entering, exiting,
    annotating and linking are all no-ops, so instrumentation sites never
    branch on armed-ness themselves."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs):
        return self

    def link(self, *trace_ids):
        return self


NOOP = _NoopSpan()


class Span:
    """A live span; records into the tracer ring on ``__exit__``.

    Entering installs (trace_id, span_id) as the ambient context, so
    nested spans become children and outbound RemoteStore requests carry
    this context in their header.  ``trace_id=...`` joins an explicit
    trace (a gang's) instead of the ambient one; ``link(t)`` marks the
    span as participating in another trace without re-rooting it (the
    per-cycle span tree links every traced gang it schedules)."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "attrs", "links", "_t0", "_start", "_prev")

    def __init__(self, tracer: Tracer, name: str,
                 trace_id: Optional[str] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self._tracer = tracer
        self.name = name
        ambient_trace, ambient_span = _ctx.trace_id, _ctx.span_id
        if trace_id:
            self.trace_id = trace_id
            # only a same-trace ambient span can be the parent
            self.parent_id = ambient_span if ambient_trace == trace_id else ""
        elif ambient_trace:
            self.trace_id = ambient_trace
            self.parent_id = ambient_span
        else:
            self.trace_id = new_id("t")
            self.parent_id = ""
        self.span_id = new_id("s")
        self.attrs = dict(attrs) if attrs else {}
        self.links: List[str] = []
        self._prev = (ambient_trace, ambient_span)

    def __enter__(self) -> "Span":
        _ctx.trace_id, _ctx.span_id = self.trace_id, self.span_id
        self._start = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter() - self._t0
        _ctx.trace_id, _ctx.span_id = self._prev
        if exc and exc[0] is not None:
            self.attrs["error"] = getattr(exc[0], "__name__", str(exc[0]))
        self._tracer.record({
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "component": component(),
            "start": self._start,
            "dur": dur,
            "attrs": self.attrs,
            "links": self.links,
        })
        return False

    def annotate(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def link(self, *trace_ids: str) -> "Span":
        for t in trace_ids:
            if t and t != self.trace_id and t not in self.links:
                self.links.append(t)
        return self


def _tracer_from_env(raw: str) -> Optional[Tracer]:
    raw = (raw or "").strip()
    if not raw or raw in ("0", "off", "none"):
        return None
    if raw.startswith("{"):
        try:
            cfg = json.loads(raw)
        except ValueError:
            cfg = {}
        return Tracer(ring=int(cfg.get("ring", DEFAULT_RING)),
                      dump_dir=str(cfg.get("dir", "")))
    return Tracer()


#: the process tracer; None = disarmed, and every instrumentation site is
#: a single ``trace.TRACER is None`` attribute check
TRACER: Optional[Tracer] = _tracer_from_env(os.environ.get(ENV_VAR, ""))


def arm(tracer: Optional[Tracer] = None) -> Tracer:
    """Arm tracing in-process (tests, embedders); returns the tracer."""
    global TRACER
    TRACER = tracer or Tracer()
    return TRACER


def disarm() -> None:
    global TRACER
    TRACER = None


def span(name: str, trace_id: Optional[str] = None, **attrs):
    """Open a span: ``with span("scheduler.cycle") as s: ...``.  Disarmed
    this returns the shared no-op and allocates nothing."""
    tr = TRACER
    if tr is None:
        return NOOP
    return Span(tr, name, trace_id, attrs)


@contextmanager
def context(trace_id: str, span_id: str = ""):
    """Install an ambient context without opening a span — the server
    side of header propagation (the request span then parents to the
    client's span across the process boundary)."""
    prev = (_ctx.trace_id, _ctx.span_id)
    _ctx.trace_id, _ctx.span_id = trace_id, span_id
    try:
        yield
    finally:
        _ctx.trace_id, _ctx.span_id = prev


@contextmanager
def request_context(header_value: str, name: str, **attrs):
    """Continue a client's ``X-Volcano-Trace`` context around one server
    request: installs the remote context (when present) and opens the
    request span under it."""
    tid, sid = parse_header(header_value)
    if tid:
        with context(tid, sid):
            with span(name, **attrs) as s:
                yield s
    else:
        with span(name, **attrs) as s:
            yield s


def stamp(meta) -> str:
    """Write the ambient trace id into an object's annotations (the
    job's submitter does this on the Job) so watch-driven daemons
    can join the trace.  Returns the id written ("" when disarmed or no
    ambient trace)."""
    if TRACER is None:
        return ""
    tid = _ctx.trace_id
    if tid:
        meta.annotations[TRACE_ID_KEY] = tid
    return tid


def gang_trace(meta) -> str:
    """The trace id an object carries, "" when untraced."""
    return meta.annotations.get(TRACE_ID_KEY, "")


# -- reconstruction -----------------------------------------------------------


def spans_for_trace(records: List[Dict[str, Any]],
                    trace_id: str) -> List[Dict[str, Any]]:
    """Every span belonging to ``trace_id``: direct members, spans that
    ``link`` it (a scheduler cycle serving many gangs), and the full
    subtree under any selected span (the cycle's actions/plugins keep the
    cycle's own trace id but describe the linked gang's scheduling too).
    Sorted by start time."""
    children: Dict[Tuple[str, str], List[Dict[str, Any]]] = {}
    for r in records:
        children.setdefault((r["trace"], r["parent"]), []).append(r)
    selected: Dict[str, Dict[str, Any]] = {}
    frontier = [r for r in records
                if r["trace"] == trace_id or trace_id in r.get("links", ())]
    while frontier:
        nxt: List[Dict[str, Any]] = []
        for r in frontier:
            if r["span"] in selected:
                continue
            selected[r["span"]] = r
            nxt.extend(children.get((r["trace"], r["span"]), ()))
        frontier = nxt
    return sorted(selected.values(), key=lambda r: (r["start"], r["span"]))


def trace_ids(records: List[Dict[str, Any]]) -> List[str]:
    """Distinct trace ids in the ring, oldest root first."""
    seen: List[str] = []
    for r in records:
        if r["trace"] not in seen:
            seen.append(r["trace"])
    return seen


#: span names that are pure cycle machinery: every idle scheduler cycle
#: roots a fresh trace of these (and, on an armed daemon, its contexted
#: store reads land as store.* spans in the same trace), so "the last
#: trace" must look past them
_MACHINERY = frozenset({
    "scheduler.cycle", "scheduler.residue", "session.snapshot",
    "session.close", "action", "plugin", "statement.commit",
    "statement.discard", "device.allocate_solve", "device.dynamic_solve",
})


def _is_machinery(name: str) -> bool:
    return name in _MACHINERY or name.startswith("store.")


def latest_trace(records: List[Dict[str, Any]]) -> str:
    """The most recent trace carrying a non-machinery span (a submitted
    gang, a CLI op) — what a trace viewer renders by default.
    Falls back to the newest trace of any kind."""
    best = ""
    for r in records:
        if not _is_machinery(r["name"]):
            best = r["trace"]
    if best:
        return best
    return records[-1]["trace"] if records else ""


def render_tree(records: List[Dict[str, Any]], trace_id: str) -> str:
    """Human span tree for one trace."""
    spans = spans_for_trace(records, trace_id)
    if not spans:
        return f"no spans recorded for trace {trace_id}\n"
    by_id = {r["span"]: r for r in spans}
    kids: Dict[str, List[Dict[str, Any]]] = {}
    roots: List[Dict[str, Any]] = []
    for r in spans:
        if r["parent"] in by_id:
            kids.setdefault(r["parent"], []).append(r)
        else:
            roots.append(r)
    lines = [f"trace {trace_id} ({len(spans)} spans)"]

    def fmt(r, depth):
        attrs = " ".join(f"{k}={v}" for k, v in sorted(r["attrs"].items()))
        linked = " ~linked" if trace_id in r.get("links", ()) else ""
        comp = f"[{r['component']}] " if r.get("component") else ""
        lines.append(
            f"{'  ' * depth}{r['name']} {comp}{r['dur'] * 1e3:.2f}ms"
            f"{linked}{(' ' + attrs) if attrs else ''}"
        )
        for c in kids.get(r["span"], ()):
            fmt(c, depth + 1)

    for r in roots:
        fmt(r, 1)
    return "\n".join(lines) + "\n"


# -- debug endpoint / crash artifacts -----------------------------------------


def debug_payload() -> Dict[str, Any]:
    """The ``/debug/trace`` response body (the metrics server's)."""
    tr = TRACER
    if tr is None:
        return {"armed": False, "pid": os.getpid(), "now": time.time(),
                "spans": []}
    out = tr.dump()
    out["armed"] = True
    # the serving process's wall clock at response build, from which a
    # fleet harvester estimates this process's clock offset
    out["now"] = time.time()
    return out


def crash_dump(reason: str) -> Optional[str]:
    """Dump the flight recorder as a JSON artifact, called on an invariant
    violation.  When the time-series recorder is armed, its ring rides
    along under ``"timeseries"``; when the vtprof profiler is armed, its
    sentinel trips ride under ``"anomalies"`` and its critical-path
    summary under ``"profile"``.  Returns the path written, or None when
    disarmed.  Never raises: forensics must not mask the original failure.
    When a digest source is registered (the scheduler's mirror), its view
    and last verdict ride under ``"audit"``, so that a
    steady-state-divergence dump names the kinds that differ."""
    from volcano_tpu_torch import timeseries, vtaudit, vtprof

    tr = TRACER
    if tr is None:
        return None
    directory = tr.dump_dir or "."
    name = f"vtrace-{component() or 'proc'}-{os.getpid()}-{reason}.json"
    path = os.path.join(directory, name)
    extra = None
    if timeseries.RECORDER is not None:
        extra = {"timeseries": timeseries.RECORDER.samples()}
    if vtprof.PROFILER is not None:
        extra = dict(extra or {})
        extra["anomalies"] = vtprof.PROFILER.anomalies_snapshot()
        extra["profile"] = vtprof.PROFILER.summary()
    if vtaudit.has_debug_source():
        extra = dict(extra or {})
        extra["audit"] = vtaudit.debug_payload()
    try:
        os.makedirs(directory, exist_ok=True)
        return tr.dump_to(path, reason, extra=extra)
    except OSError:
        return None
