"""Multi-dimensional resource arithmetic with epsilon-tolerant comparisons.

The port's own copy of ``volcano_tpu/api/resource.py``.  Dimensions: cpu
in millicores, memory in bytes, plus scalar resources in milli-units;
differences below MIN_MILLI_CPU / MIN_MEMORY / MIN_SCALAR count as equal,
``sub`` refuses to go negative, and ``fit_delta`` subtracts request +
epsilon so that a negative dimension means insufficient.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional

MIN_MILLI_CPU = 10.0
MIN_MEMORY = 10.0 * 1024 * 1024
MIN_SCALAR = 10.0

_MEM_UNITS = {
    "k": 1000.0, "M": 1000.0**2, "G": 1000.0**3, "T": 1000.0**4,
    "Ki": 1024.0, "Mi": 1024.0**2, "Gi": 1024.0**3, "Ti": 1024.0**4,
    "": 1.0,
}


def parse_quantity(name: str, value) -> float:
    """k8s-style quantity -> canonical float (cpu: millicores, memory:
    bytes, scalars: milli-units)."""
    if isinstance(value, (int, float)):
        num = float(value)
        if name == "cpu":
            return num * 1000.0
        return num * 1000.0 if name not in ("cpu", "memory") else num
    s = str(value).strip()
    if name == "cpu":
        if s.endswith("m"):
            return float(s[:-1])
        return float(s) * 1000.0
    if name == "memory":
        for suffix in sorted(_MEM_UNITS, key=len, reverse=True):
            if suffix and s.endswith(suffix):
                return float(s[: -len(suffix)]) * _MEM_UNITS[suffix]
        return float(s)
    if s.endswith("m"):
        return float(s[:-1])
    return float(s) * 1000.0


class Resource:
    """A point in resource space: (milli_cpu, memory, scalars...)."""

    __slots__ = ("milli_cpu", "memory", "scalars", "max_task_num")

    def __init__(
        self,
        milli_cpu: float = 0.0,
        memory: float = 0.0,
        scalars: Optional[Mapping[str, float]] = None,
        max_task_num: Optional[int] = None,
    ):
        self.milli_cpu = float(milli_cpu)
        self.memory = float(memory)
        self.scalars: Dict[str, float] = dict(scalars or {})
        # pod-count capacity, used by predicates only
        self.max_task_num = max_task_num

    @classmethod
    def from_resource_list(cls, rl: Optional[Mapping[str, object]]) -> "Resource":
        r = cls()
        for name, q in (rl or {}).items():
            if name == "cpu":
                r.milli_cpu += parse_quantity(name, q)
            elif name == "memory":
                r.memory += parse_quantity(name, q)
            elif name == "pods":
                r.max_task_num = int(float(q))
            else:
                r.scalars[name] = r.scalars.get(name, 0.0) + parse_quantity(name, q)
        return r

    def clone(self) -> "Resource":
        return Resource(self.milli_cpu, self.memory, dict(self.scalars), self.max_task_num)

    def is_empty(self) -> bool:
        if not (self.milli_cpu < MIN_MILLI_CPU and self.memory < MIN_MEMORY):
            return False
        return all(q < MIN_SCALAR for q in self.scalars.values())

    def is_zero(self, name: str) -> bool:
        if name == "cpu":
            return self.milli_cpu < MIN_MILLI_CPU
        if name == "memory":
            return self.memory < MIN_MEMORY
        return self.scalars.get(name, 0.0) < MIN_SCALAR

    def less(self, other: "Resource") -> bool:
        """Strictly less in every dimension."""
        if not (self.milli_cpu < other.milli_cpu and self.memory < other.memory):
            return False
        if not self.scalars:
            return bool(other.scalars)
        for name, q in self.scalars.items():
            if q >= other.scalars.get(name, 0.0):
                return False
        return True

    def less_equal(self, other: "Resource") -> bool:
        """Epsilon-tolerant <= in every dimension."""
        ok = (
            self.milli_cpu < other.milli_cpu
            or abs(other.milli_cpu - self.milli_cpu) < MIN_MILLI_CPU
        ) and (
            self.memory < other.memory or abs(other.memory - self.memory) < MIN_MEMORY
        )
        if not ok:
            return False
        for name, q in self.scalars.items():
            oq = other.scalars.get(name, 0.0)
            if not (q < oq or abs(oq - q) < MIN_SCALAR):
                return False
        return True

    def add(self, other: "Resource") -> "Resource":
        self.milli_cpu += other.milli_cpu
        self.memory += other.memory
        for name, q in other.scalars.items():
            self.scalars[name] = self.scalars.get(name, 0.0) + q
        return self

    def sub(self, other: "Resource") -> "Resource":
        if not other.less_equal(self):
            raise ValueError(f"resource not sufficient: {self} sub {other}")
        self.milli_cpu -= other.milli_cpu
        self.memory -= other.memory
        for name, q in other.scalars.items():
            if name in self.scalars:
                self.scalars[name] -= q
        return self

    def multi(self, ratio: float) -> "Resource":
        self.milli_cpu *= ratio
        self.memory *= ratio
        for name in self.scalars:
            self.scalars[name] *= ratio
        return self

    def set_max(self, other: "Resource") -> "Resource":
        self.milli_cpu = max(self.milli_cpu, other.milli_cpu)
        self.memory = max(self.memory, other.memory)
        for name, q in other.scalars.items():
            if q > self.scalars.get(name, 0.0):
                self.scalars[name] = q
        return self

    def fit_delta(self, req: "Resource") -> "Resource":
        """Subtract req + epsilon per requested dim; negative => insufficient."""
        if req.milli_cpu > 0:
            self.milli_cpu -= req.milli_cpu + MIN_MILLI_CPU
        if req.memory > 0:
            self.memory -= req.memory + MIN_MEMORY
        for name, q in req.scalars.items():
            if q > 0:
                self.scalars[name] = self.scalars.get(name, 0.0) - (q + MIN_SCALAR)
        return self

    def get(self, name: str) -> float:
        if name == "cpu":
            return self.milli_cpu
        if name == "memory":
            return self.memory
        return self.scalars.get(name, 0.0)

    def names(self) -> Iterable[str]:
        return ["cpu", "memory", *self.scalars.keys()]

    @staticmethod
    def min(l: "Resource", r: "Resource") -> "Resource":
        res = Resource(min(l.milli_cpu, r.milli_cpu), min(l.memory, r.memory))
        if l.scalars and r.scalars:
            for name, q in l.scalars.items():
                res.scalars[name] = min(q, r.scalars.get(name, 0.0))
        return res

    @staticmethod
    def share(l: float, r: float) -> float:
        """l/r with 0/0 = 0 and x/0 = 1."""
        if r == 0:
            return 0.0 if l == 0 else 1.0
        return l / r

    def dominant_share(self, total: "Resource") -> float:
        """Max over dims of allocated/total: the DRF share."""
        res = 0.0
        for name in total.names():
            res = max(res, Resource.share(self.get(name), total.get(name)))
        return res

    def __eq__(self, other) -> bool:
        if not isinstance(other, Resource):
            return NotImplemented
        names = set(self.scalars) | set(other.scalars)
        return (
            self.milli_cpu == other.milli_cpu
            and self.memory == other.memory
            and all(self.scalars.get(n, 0.0) == other.scalars.get(n, 0.0) for n in names)
        )

    def __repr__(self) -> str:
        s = f"Resource(cpu={self.milli_cpu:.0f}m, mem={self.memory:.0f}"
        for name, q in self.scalars.items():
            s += f", {name}={q:.0f}"
        return s + ")"
