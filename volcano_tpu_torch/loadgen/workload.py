"""Seeded open-loop workload: a deterministic arrival and departure
schedule, replayed against a store.

The port's copy of ``volcano_tpu/loadgen/workload.py``.

* :func:`build_schedule` turns a :class:`LoadSpec` into the whole event
  list up front (arrival times at ``qps`` with Poisson inter-arrivals,
  gang sizes, per-pod resources, queues, dwell after placement), every
  draw from one numpy generator seeded by ``spec.seed``: the same seed
  gives the same schedule, and the JAX package's for the same spec.
* :class:`LoadGen` replays it against a store: ``submit_due(now)``
  creates the due gangs (a PodGroup and its pods), ``observe()`` records
  first-seen -> bind latency for the pods bound since the last call (into
  its own histogram and ``metrics.update_pod_e2e_latency``), and
  ``depart_due()`` deletes the gangs whose dwell expired.

``now`` is the caller's (wall seconds for a real open-loop run, virtual
ticks for a lockstep one); latency is always the monotonic clock between
the actual submit and observe instants.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np

from volcano_tpu_torch.api import POD_GROUP_KEY, Resource
from volcano_tpu_torch.api.objects import Metadata, Pod, PodGroup, PodSpec
from volcano_tpu_torch.api.types import PodGroupPhase
from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.scheduler.metrics import Histogram


@dataclass(frozen=True)
class LoadSpec:
    """The distributions of one open-loop run (every draw seeded)."""

    qps: float = 20.0                 # gang arrivals a second
    duration_s: float = 5.0           # the arrival window
    seed: int = 0
    #: (gang size, weight); the weights need not sum to 1
    gang_sizes: Tuple[Tuple[int, float], ...] = ((1, 6.0), (2, 3.0), (4, 1.0))
    cpu_millis: Tuple[int, ...] = (100, 250, 500)
    mem_mb: Tuple[int, ...] = (128, 256, 512)
    queues: Tuple[str, ...] = ("default",)
    namespace: str = "load"
    #: mean seconds a placed gang stays before it departs; 0: forever
    dwell_s: float = 0.0
    prefix: str = "lg"


@dataclass(frozen=True)
class Arrival:
    """One scheduled gang arrival."""

    t: float                      # seconds since the run started
    name: str                     # the gang's (PodGroup's) name
    queue: str
    cpu_millis: Tuple[int, ...]   # a pod each
    mem_bytes: Tuple[int, ...]    # a pod each
    dwell_s: float                # life after placement (inf: forever)

    @property
    def size(self) -> int:
        return len(self.cpu_millis)

    def pod_names(self) -> List[str]:
        return [f"{self.name}-{i}" for i in range(self.size)]


def build_schedule(spec: LoadSpec) -> List[Arrival]:
    """The event list of ``spec``: every random draw happens here, in a
    fixed order, from one seeded generator."""
    rng = np.random.default_rng(spec.seed)
    sizes = np.array([s for s, _ in spec.gang_sizes], np.int64)
    weights = np.array([w for _, w in spec.gang_sizes], np.float64)
    weights = weights / weights.sum()
    out: List[Arrival] = []
    t = 0.0
    i = 0
    while True:
        t += float(rng.exponential(1.0 / max(spec.qps, 1e-9)))
        if t > spec.duration_s:
            break
        size = int(rng.choice(sizes, p=weights))
        cpus = tuple(int(c) for c in rng.choice(spec.cpu_millis, size))
        mems = tuple(int(m) * (1 << 20) for m in rng.choice(spec.mem_mb, size))
        queue = str(rng.choice(spec.queues))
        dwell = float(rng.exponential(spec.dwell_s)) if spec.dwell_s > 0 else math.inf
        out.append(Arrival(t=t, name=f"{spec.prefix}{spec.seed}-{i:06d}", queue=queue,
                           cpu_millis=cpus, mem_bytes=mems, dwell_s=dwell))
        i += 1
    return out


class LoadGen:
    """Replays a :class:`LoadSpec` schedule against a store that has
    ``create`` / ``list`` / ``delete``."""

    def __init__(self, store, spec: LoadSpec, clock=time.monotonic):
        self.store = store
        self.spec = spec
        self.schedule = build_schedule(spec)
        self._clock = clock
        self._next = 0
        #: pod key -> monotonic submit instant, for the unbound pods
        self.inflight: Dict[str, float] = {}
        #: gang name -> {"arr", "pods" (unbound keys), "bound_at"}
        self.gangs: Dict[str, Dict[str, Any]] = {}
        #: first-seen -> bind latency in seconds (the run's own readout;
        #: every sample also goes to metrics.update_pod_e2e_latency)
        self.hist = Histogram()
        self.submitted_pods = 0
        self.bound_pods = 0
        self.departed_gangs = 0

    def due(self, now_s: float) -> List[Arrival]:
        """Arrivals due at or before ``now_s`` and not yet submitted."""
        out = []
        j = self._next
        while j < len(self.schedule) and self.schedule[j].t <= now_s:
            out.append(self.schedule[j])
            j += 1
        return out

    def submit(self, arr: Arrival) -> None:
        """Create one gang (its PodGroup and pods), in schedule order
        (ValueError otherwise).  A store error propagates, the caller
        retrying; a resubmit after a partial failure skips the objects the
        earlier attempt created (KeyError) and creates the rest."""
        if self._next >= len(self.schedule) or self.schedule[self._next] is not arr:
            raise ValueError("arrivals must be submitted in schedule order")
        ns = self.spec.namespace
        pg = PodGroup(meta=Metadata(name=arr.name, namespace=ns),
                      min_member=arr.size, queue=arr.queue)
        pg.status.phase = PodGroupPhase.PENDING  # enqueue admits it
        try:
            self.store.create("PodGroup", pg)
        except KeyError:
            pass  # an earlier attempt created it
        keys = []
        for i, pod_name in enumerate(arr.pod_names()):
            try:
                self.store.create("Pod", Pod(
                    meta=Metadata(name=pod_name, namespace=ns,
                                  annotations={POD_GROUP_KEY: arr.name}),
                    spec=PodSpec(resources=Resource(float(arr.cpu_millis[i]),
                                                    float(arr.mem_bytes[i])))))
            except KeyError:
                pass  # a resubmit of a partly created gang
            keys.append(f"{ns}/{pod_name}")
        # first seen: when the gang's last pod reached the store (one clock
        # read a gang)
        t_sub = self._clock()
        for k in keys:
            self.inflight[k] = t_sub
        self.gangs[arr.name] = {"arr": arr, "pods": set(keys), "bound_at": None}
        self.submitted_pods += arr.size
        self._next += 1

    def submit_due(self, now_s: float) -> int:
        """Submit every due arrival; returns the gangs submitted."""
        n = 0
        for arr in self.due(now_s):
            self.submit(arr)
            n += 1
        return n

    def observe(self) -> int:
        """Record the latency of every in-flight pod bound since the last
        call; returns how many."""
        if not self.inflight:
            return 0
        now = self._clock()
        ns_prefix = self.spec.namespace + "/"
        n = 0
        for pod in self.store.list("Pod"):
            key = pod.meta.key
            if not key.startswith(ns_prefix):
                continue
            t_sub = self.inflight.get(key)
            if t_sub is None or not pod.node_name:
                continue
            lat = max(now - t_sub, 0.0)
            self.hist.observe(lat)
            metrics.update_pod_e2e_latency(lat * 1e3)
            del self.inflight[key]
            self.bound_pods += 1
            n += 1
            gang = self.gangs.get(key.rsplit("-", 1)[0].split("/", 1)[1])
            if gang is not None:
                gang["pods"].discard(key)
                if not gang["pods"] and gang["bound_at"] is None:
                    gang["bound_at"] = now
        return n

    def depart_due(self) -> int:
        """Delete the placed gangs whose dwell expired; returns how many."""
        now = self._clock()
        gone = []
        for name, gang in self.gangs.items():
            bound_at = gang["bound_at"]
            if bound_at is None or math.isinf(gang["arr"].dwell_s):
                continue
            if now - bound_at < gang["arr"].dwell_s:
                continue
            ns = self.spec.namespace
            for pod_name in gang["arr"].pod_names():
                self.store.delete("Pod", f"{ns}/{pod_name}")
            self.store.delete("PodGroup", f"{ns}/{name}")
            gone.append(name)
        for name in gone:
            del self.gangs[name]
            self.departed_gangs += 1
        return len(gone)

    @property
    def pending_pods(self) -> int:
        """Submitted and not yet seen bound: the backlog."""
        return len(self.inflight)

    @property
    def all_submitted(self) -> bool:
        return self._next >= len(self.schedule)

    @property
    def done(self) -> bool:
        """Every gang submitted and every pod seen bound."""
        return self.all_submitted and not self.inflight

    def quantile_ms(self, q: float) -> float:
        return self.hist.quantile(q) * 1e3

    def placements(self) -> List[Tuple[str, str]]:
        """The (pod key, node) pairs of this generator's namespace."""
        ns_prefix = self.spec.namespace + "/"
        return sorted((p.meta.key, p.node_name) for p in self.store.list("Pod")
                      if p.meta.key.startswith(ns_prefix) and p.node_name)
