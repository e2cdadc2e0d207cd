"""Conformance plugin: protect system-critical pods from eviction (the
port's copy of ``volcano_tpu/scheduler/plugins/conformance.py``)."""

from __future__ import annotations

from volcano_tpu_torch.scheduler.framework import Plugin
from volcano_tpu_torch.scheduler.session import Session

_CRITICAL_CLASSES = ("system-cluster-critical", "system-node-critical")


class ConformancePlugin(Plugin):
    name = "conformance"

    def on_session_open(self, ssn: Session) -> None:
        def evictable_fn(evictor, evictees):
            victims = []
            for evictee in evictees:
                if evictee.priority_class in _CRITICAL_CLASSES:
                    continue
                if evictee.namespace == "kube-system":
                    continue
                victims.append(evictee)
            return victims

        ssn.add_preemptable_fn(self.name, evictable_fn)
        ssn.add_reclaimable_fn(self.name, evictable_fn)
