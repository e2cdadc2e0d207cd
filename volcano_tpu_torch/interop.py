"""State carried into the port from plain data.

* ``snapshot_from_arrays`` builds the port's ``TensorSnapshot`` from a dict
  of a snapshot's fields as numpy arrays and lists (for example
  ``dataclasses.asdict``-style fields of the JAX package's snapshot);
  fields the port does not model are ignored.
* ``store_from_spec`` builds the port's ``Store`` from a plain description
  of a cluster, so that one seeded description can be instantiated in both
  packages:

      {"queues":    [{"name", "weight"}],
       "nodes":     [{"name", "allocatable": {"cpu", "memory", "pods"},
                      "labels"?}],
       "podgroups": [{"name", "namespace"?, "min_member", "queue",
                      "phase"?, "priority_class_name"?}],
       "pods":      [{"name", "namespace"?, "group"?, "resources": {...},
                      "priority"?, "node_name"?, "phase"?, "deleting"?,
                      "labels"?}]}

  Resources are k8s-style resource lists ({"cpu": "500m", "memory":
  "1Gi"}); phases are the enum values ("Running", "Inqueue", ...).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from volcano_tpu_torch.api.objects import (
    POD_GROUP_KEY,
    Metadata,
    Node,
    Pod,
    PodGroup,
    PodSpec,
    Queue,
)
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import PodGroupPhase, PodPhase
from volcano_tpu_torch.scheduler.snapshot import TensorSnapshot
from volcano_tpu_torch.store.store import Store


def snapshot_from_arrays(fields: Dict[str, Any]) -> TensorSnapshot:
    kw = {}
    for f in dataclasses.fields(TensorSnapshot):
        v = fields[f.name]
        kw[f.name] = list(v) if isinstance(v, (list, tuple)) else np.array(v, copy=True)
    return TensorSnapshot(**kw)


def store_from_spec(spec: Dict[str, Any]) -> Store:
    store = Store()
    for q in spec.get("queues", ()):
        store.create("Queue", Queue(meta=Metadata(name=q["name"], namespace=""),
                                    weight=q.get("weight", 1)))
    for n in spec.get("nodes", ()):
        store.create("Node", Node(
            meta=Metadata(name=n["name"], namespace=""),
            allocatable=Resource.from_resource_list(n["allocatable"]),
            labels=dict(n.get("labels", {})),
        ))
    for g in spec.get("podgroups", ()):
        pg = PodGroup(
            meta=Metadata(name=g["name"], namespace=g.get("namespace", "default")),
            min_member=g.get("min_member", 1),
            queue=g.get("queue", "default"),
            priority_class_name=g.get("priority_class_name", ""),
        )
        pg.status.phase = PodGroupPhase(g.get("phase", "Pending"))
        store.create("PodGroup", pg)
    for p in spec.get("pods", ()):
        group = p.get("group", "")
        store.create("Pod", Pod(
            meta=Metadata(
                name=p["name"], namespace=p.get("namespace", "default"),
                annotations={POD_GROUP_KEY: group} if group else {},
                labels=dict(p.get("labels", {})),
            ),
            spec=PodSpec(resources=Resource.from_resource_list(p.get("resources", {})),
                         priority=p.get("priority", 0)),
            phase=PodPhase(p.get("phase", "Pending")),
            node_name=p.get("node_name", ""),
            deleting=bool(p.get("deleting", False)),
        ))
    return store
