"""Multi-dimensional resource arithmetic with epsilon-tolerant comparisons.

The port's own copy of ``volcano_tpu/api/resource.py``, cut to what the
express cycle uses.  Dimensions: cpu in millicores, memory in bytes, plus
scalar resources in milli-units; differences below MIN_MILLI_CPU /
MIN_MEMORY / MIN_SCALAR count as equal.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

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

    def set_max(self, other: "Resource") -> "Resource":
        self.milli_cpu = max(self.milli_cpu, other.milli_cpu)
        self.memory = max(self.memory, other.memory)
        for name, q in other.scalars.items():
            if q > self.scalars.get(name, 0.0):
                self.scalars[name] = q
        return self

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
