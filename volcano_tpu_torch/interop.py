"""State carried into the port from plain data.

* ``snapshot_from_arrays`` builds the port's ``TensorSnapshot`` from a dict
  of a snapshot's fields as numpy arrays and lists (for example
  ``dataclasses.asdict``-style fields of the JAX package's snapshot);
  fields the port does not model are ignored.
* ``victim_from_arrays`` builds the port's ``VictimConsts`` and
  ``VictimState`` from the same fields as numpy arrays (for example the
  JAX package's ``VictimConsts`` / ``VictimState`` fetched to the host, or
  ``simargs.build_victim_sim``'s dicts).
* ``volsel_from_payload`` carries a volume payload in the JAX package's
  form (``volsolve.VolumePartition.payload``: ``task_volmask_w``,
  ``task_claims``, ``claim_group``, ``group_cap``, ``group_global``) into
  the packed ``volsel`` tuple the port's exact solve takes.
* ``store_from_spec`` builds the port's ``Store`` from a plain description
  of a cluster, so that one seeded description can be instantiated in both
  packages:

      {"queues":    [{"name", "weight"}],
       "nodes":     [{"name", "allocatable": {"cpu", "memory", "pods"},
                      "labels"?}],
       "priority_classes": [{"name", "value"}],
       "storage_classes": [{"name", "provisioner"?}],
       "pvs":       [{"name", "capacity", "storage_class",
                      "node_affinity"?, "claim_ref"?}],
       "pvcs":      [{"name", "namespace"?, "size", "storage_class",
                      "volume_name"?, "phase"?}],
       "podgroups": [{"name", "namespace"?, "min_member", "queue",
                      "phase"?, "priority_class_name"?}],
       "pdbs":      [{"name", "namespace"?, "owner": (kind, name),
                      "min_available"}],
       "pods":      [{"name", "namespace"?, "group"?, "resources": {...},
                      "priority"?, "node_name"?, "phase"?, "deleting"?,
                      "labels"?, "host_ports"?, "pod_affinity"?,
                      "pod_anti_affinity"?, "node_selector"?,
                      "volumes"?, "owner"?: (kind, name)}]}

  Resources are k8s-style resource lists ({"cpu": "500m", "memory":
  "1Gi"}); phases are the enum values ("Running", "Inqueue", ...);
  ``pod_affinity`` / ``pod_anti_affinity`` are lists of label selectors
  ({"app": "web"}).  A resident pod is a pod with a ``node_name`` and a
  phase such as "Running".  A storage class's ``provisioner`` defaults to
  a dynamic one ("" makes it static); a PV's ``node_affinity`` is a
  node-label selector ({"kubernetes.io/hostname": "n3"}); a pod's
  ``volumes`` are the names of the claims it mounts, in its namespace.  A
  PodDisruptionBudget's ``owner`` names the controller whose plain pods
  (pods with that ``owner`` and no group) form its shadow gang.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from volcano_tpu_torch.api.objects import (
    POD_GROUP_KEY,
    Affinity,
    Metadata,
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    PodDisruptionBudget,
    PodGroup,
    PodSpec,
    PriorityClass,
    Queue,
    StorageClass,
)
from volcano_tpu_torch.api.resource import Resource
from volcano_tpu_torch.api.types import PodGroupPhase, PodPhase
from volcano_tpu_torch.scheduler.kernels import pack_volsel
from volcano_tpu_torch.scheduler.snapshot import TensorSnapshot
from volcano_tpu_torch.scheduler.victim_kernels import VictimConsts, VictimState
from volcano_tpu_torch.store.store import Store


def snapshot_from_arrays(fields: Dict[str, Any]) -> TensorSnapshot:
    kw = {}
    for f in dataclasses.fields(TensorSnapshot):
        v = fields[f.name]
        if isinstance(v, (list, tuple)):
            kw[f.name] = list(v)
        elif isinstance(v, (bool, np.bool_)):
            kw[f.name] = bool(v)
        else:
            kw[f.name] = np.array(v, copy=True)
    return TensorSnapshot(**kw)


def victim_from_arrays(consts: Dict[str, Any], state: Dict[str, Any],
                       device: torch.device = torch.device("cpu")):
    """(VictimConsts, VictimState) on ``device`` from numpy fields named as
    the JAX package's NamedTuples (``w_least``/``w_balanced`` scalars)."""
    def t(v):
        return torch.from_numpy(np.array(v, copy=True)).to(device)

    c = VictimConsts(**{f: (float(consts[f]) if f in ("w_least", "w_balanced")
                            else t(consts[f])) for f in VictimConsts._fields})
    return c, VictimState(**{f: t(state[f]) for f in VictimState._fields})


def volsel_from_payload(payload: Dict[str, Any],
                        device: torch.device = torch.device("cpu")) -> tuple:
    """The packed ``volsel`` tuple on ``device`` from a payload dict of
    numpy arrays in the JAX package's form."""
    return tuple(torch.from_numpy(np.array(x, copy=True)).to(device)
                 for x in pack_volsel(payload))


def store_from_spec(spec: Dict[str, Any]) -> Store:
    store = Store()
    for pc in spec.get("priority_classes", ()):
        store.create("PriorityClass", PriorityClass(
            meta=Metadata(name=pc["name"], namespace=""), value=pc["value"]))
    for q in spec.get("queues", ()):
        store.create("Queue", Queue(meta=Metadata(name=q["name"], namespace=""),
                                    weight=q.get("weight", 1)))
    for n in spec.get("nodes", ()):
        store.create("Node", Node(
            meta=Metadata(name=n["name"], namespace=""),
            allocatable=Resource.from_resource_list(n["allocatable"]),
            labels=dict(n.get("labels", {})),
        ))
    for sc in spec.get("storage_classes", ()):
        kw = {"provisioner": sc["provisioner"]} if "provisioner" in sc else {}
        store.create("StorageClass", StorageClass(
            meta=Metadata(name=sc["name"], namespace=""), **kw))
    for pv in spec.get("pvs", ()):
        store.create("PV", PersistentVolume(
            meta=Metadata(name=pv["name"], namespace=""), capacity=pv.get("capacity", ""),
            storage_class=pv.get("storage_class", ""),
            node_affinity=dict(pv.get("node_affinity", {})),
            claim_ref=pv.get("claim_ref", "")))
    for c in spec.get("pvcs", ()):
        store.create("PVC", PersistentVolumeClaim(
            meta=Metadata(name=c["name"], namespace=c.get("namespace", "default")),
            size=c.get("size", ""), storage_class=c.get("storage_class", ""),
            volume_name=c.get("volume_name", ""), phase=c.get("phase", "Pending")))
    for g in spec.get("podgroups", ()):
        pg = PodGroup(
            meta=Metadata(name=g["name"], namespace=g.get("namespace", "default")),
            min_member=g.get("min_member", 1),
            queue=g.get("queue", "default"),
            priority_class_name=g.get("priority_class_name", ""),
        )
        pg.status.phase = PodGroupPhase(g.get("phase", "Pending"))
        store.create("PodGroup", pg)
    for b in spec.get("pdbs", ()):
        owner = b.get("owner")
        store.create("PodDisruptionBudget", PodDisruptionBudget(
            meta=Metadata(name=b["name"], namespace=b.get("namespace", "default"),
                          owner=tuple(owner) if owner else None),
            min_available=b.get("min_available", 1)))
    for p in spec.get("pods", ()):
        group = p.get("group", "")
        affinity = None
        if p.get("pod_affinity") or p.get("pod_anti_affinity"):
            affinity = Affinity(
                pod_affinity=[dict(x) for x in p.get("pod_affinity", ())],
                pod_anti_affinity=[dict(x) for x in p.get("pod_anti_affinity", ())],
            )
        store.create("Pod", Pod(
            meta=Metadata(
                name=p["name"], namespace=p.get("namespace", "default"),
                annotations={POD_GROUP_KEY: group} if group else {},
                labels=dict(p.get("labels", {})),
                owner=tuple(p["owner"]) if p.get("owner") else None,
            ),
            spec=PodSpec(resources=Resource.from_resource_list(p.get("resources", {})),
                         priority=p.get("priority", 0), affinity=affinity,
                         host_ports=list(p.get("host_ports", ())),
                         node_selector=dict(p.get("node_selector", {}))),
            phase=PodPhase(p.get("phase", "Pending")),
            node_name=p.get("node_name", ""),
            deleting=bool(p.get("deleting", False)),
            volumes=list(p.get("volumes", ())),
        ))
    return store
