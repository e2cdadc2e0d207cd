"""Wire equality: the port's codec, server and client against the JAX
package's, byte for byte and in both directions.

- ``encode``: for equal objects, built from one seed in both packages,
  ``json.dumps(encode(obj), sort_keys=True)`` is the JAX package's, for
  every kind the port has (test_remote_store.py:62 is the round trip); the
  classes reachable from each kind have the JAX fields in the JAX order.
- A JAX ``RemoteStore`` against the port's ``StoreServer``, and the port's
  ``RemoteStore`` against a JAX ``StoreServer``: create, get, list, update,
  CAS, patch (dotted, conditional), bulk with a columnar run, a decision
  segment, delete and watch (test_remote_store.py:119, :434, :463).
- The same ops through both servers give equal watch streams.  What differs
  from run to run is frozen, not normalized: the uid counter and its
  process token (Event names and uids), the clock (creation stamps); the JAX
  server's digest beacons (ROADMAP item 11b) are left out of its stream.
"""

import dataclasses
import json
import time

import numpy as np
import pytest

from volcano_tpu import events as jevents
from volcano_tpu import leader as jleader
from volcano_tpu.api import objects as jobjects
from volcano_tpu.api import resource as jresource
from volcano_tpu.api import types as jtypes
from volcano_tpu.store import codec as jcodec
from volcano_tpu.store.client import RemoteStore as JRemoteStore
from volcano_tpu.store.segment import DecisionSegment as JSegment
from volcano_tpu.store.server import StoreServer as JStoreServer
from volcano_tpu_torch import events as tevents
from volcano_tpu_torch import leader as tleader
from volcano_tpu_torch.api import objects as tobjects
from volcano_tpu_torch.api import resource as tresource
from volcano_tpu_torch.api import types as ttypes
from volcano_tpu_torch.store import codec as tcodec
from volcano_tpu_torch.store.client import RemoteStore
from volcano_tpu_torch.store.segment import DecisionSegment
from volcano_tpu_torch.store.server import StoreServer

JAX = {"o": jobjects, "r": jresource, "t": jtypes, "ev": jevents, "le": jleader}
PORT = {"o": tobjects, "r": tresource, "t": ttypes, "ev": tevents, "le": tleader}


def samples(pkg, seed):
    """One object of every kind the port has, every field set from ``seed``
    (the same values in either package)."""
    o, r, t = pkg["o"], pkg["r"], pkg["t"]
    rng = np.random.default_rng(seed)

    def num():
        return int(rng.integers(1, 1000))

    def meta(name, ns="default"):
        return o.Metadata(name=f"{name}{num()}", namespace=ns, uid=f"uid-{num()}",
                          labels={"l": str(num())}, annotations={"a": str(num())},
                          resource_version=num(), creation_timestamp=float(num()) / 7,
                          owner=("ReplicaSet", f"rs{num()}"))

    def res():
        return r.Resource(float(num()) * 10, float(num()) * 2 ** 20,
                          {"tpu.dev/v5e": float(num())}, max_task_num=num())

    spec = o.PodSpec(
        resources=res(), init_resources=res(), image=f"img{num()}",
        node_selector={"zone": f"z{num()}"},
        affinity=o.Affinity(node_terms=[[("zone", "In", (f"a{num()}", "b"))]],
                            preferred_node_terms=[(num(), [("ssd", "Exists", ())])],
                            pod_affinity=[{"app": f"x{num()}"}],
                            pod_anti_affinity=[{"app": f"y{num()}"}]),
        tolerations=[o.Toleration(key=f"k{num()}", operator="Exists", value="", effect="")],
        host_ports=[num()], priority_class=f"pc{num()}", priority=num(),
        restart_policy="Never", scheduler_name="volcano-tpu", best_effort=bool(num() % 2))
    pg = o.PodGroup(meta=meta("pg"), min_member=num(), queue=f"q{num()}",
                    priority_class_name=f"pc{num()}", min_resources=res())
    pg.status = o.PodGroupStatus(
        phase=t.PodGroupPhase.INQUEUE,
        conditions=[o.PodGroupCondition(kind="Unschedulable", status="True",
                                        reason=f"r{num()}", message=f"m{num()}")],
        running=num(), succeeded=num(), failed=num())
    q = o.Queue(meta=meta("q", ""), weight=num())
    q.status.pending = num()
    q.status.running = num()
    return {
        "Pod": o.Pod(meta=meta("p"), spec=spec, phase=t.PodPhase.RUNNING,
                     node_name=f"n{num()}", deleting=True, exit_code=num(),
                     subdomain=f"s{num()}", hostname=f"h{num()}", env={"E": str(num())},
                     volumes=[f"c{num()}"]),
        "PodGroup": pg,
        "Queue": q,
        "Node": o.Node(meta=meta("n", ""), allocatable=res(), capacity=res(),
                       labels={"zone": f"z{num()}"},
                       taints=[o.Taint(key=f"t{num()}", value="v", effect="NoExecute")],
                       unschedulable=True,
                       conditions=[o.NodeCondition("Ready", "False"),
                                   o.NodeCondition("DiskPressure", "True")]),
        "PriorityClass": o.PriorityClass(meta=meta("pc", ""), value=num(), global_default=True),
        "PVC": o.PersistentVolumeClaim(meta=meta("c"), size=f"{num()}Gi",
                                       storage_class=f"sc{num()}", volume_name=f"v{num()}",
                                       phase="Bound"),
        "PV": o.PersistentVolume(meta=meta("v", ""), capacity=f"{num()}Gi",
                                 storage_class=f"sc{num()}", node_affinity={"h": str(num())},
                                 claim_ref=f"default/c{num()}", provisioned=True),
        "StorageClass": o.StorageClass(meta=meta("sc", ""), provisioner="",
                                       volume_binding_mode="Immediate"),
        "PodDisruptionBudget": o.PodDisruptionBudget(meta=meta("b"), min_available=num()),
        "Lease": pkg["le"].Lease(meta=meta("l", ""), holder=f"h{num()}",
                                 renewed_at=float(num()) / 3, duration=float(num()),
                                 transitions=num()),
        "Event": pkg["ev"].ClusterEvent(meta=meta("e", ""), involved=("Pod", f"default/p{num()}"),
                                        reason=f"R{num()}", message=f"M{num()}",
                                        type="Warning", count=num()),
    }


def _dump(codec, obj, sort_keys=True):
    return json.dumps(codec.encode(obj), sort_keys=sort_keys)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_byte_equal_to_jax_for_every_kind(seed):
    j, t = samples(JAX, seed), samples(PORT, seed)
    assert set(t) == set(tcodec.KIND_CLASSES) and set(j) >= set(t)
    for kind in t:
        assert _dump(tcodec, t[kind]) == _dump(jcodec, j[kind]), kind
        # the fields' order too: the unsorted dumps agree
        assert _dump(tcodec, t[kind], False) == _dump(jcodec, j[kind], False), kind
        # and the JAX encoding decodes in the port to an equal encoding
        wire = json.loads(_dump(jcodec, j[kind]))
        back = tcodec.decode_object(kind, wire)
        assert back == t[kind] and _dump(tcodec, back) == _dump(jcodec, j[kind])


def _fields(cls, seen):
    if not dataclasses.is_dataclass(cls) or cls.__name__ in seen:
        return
    import typing

    hints = typing.get_type_hints(cls)
    seen[cls.__name__] = [f.name for f in dataclasses.fields(cls)]
    for f in dataclasses.fields(cls):
        for arg in [hints[f.name], *typing.get_args(hints[f.name])]:
            for a in [arg, *typing.get_args(arg)]:
                if dataclasses.is_dataclass(a):
                    _fields(a, seen)


def test_classes_keep_the_jax_fields_in_order():
    for kind, cls in tcodec.KIND_CLASSES.items():
        mine, theirs = {}, {}
        _fields(cls, mine)
        _fields(jcodec.KIND_CLASSES[kind], theirs)
        assert mine == theirs, kind


def test_unknown_kinds_raise_naming_the_kind():
    for kind in ("Job", "Command", "NodePool", "ConfigMap", "Service"):
        with pytest.raises(KeyError, match=f"'{kind}'.*ROADMAP item 12"):
            tcodec.decode_object(kind, {})
    with pytest.raises(KeyError, match="'Gadget'"):
        tcodec.decode_object("Gadget", {})


def test_dotted_field_hints_resolve_as_jax():
    for path in ("status.phase", "status.running", "spec.resources", "meta.labels",
                 "node_name", "allocatable", "status.conditions"):
        for kind in ("Pod", "PodGroup", "Node"):
            t = tcodec._resolve_hint(tcodec.KIND_CLASSES[kind], path)
            j = jcodec._resolve_hint(jcodec.KIND_CLASSES[kind], path)
            assert (t is None) == (j is None), (kind, path)
            if t is not None:
                assert getattr(t, "__name__", str(t)) == getattr(j, "__name__", str(j))


# -- the cross wires -------------------------------------------------------------------


def _drive(rs, pkg, Segment, seed=0):
    """One client's history: every verb, each checked on its reply."""
    o, r, t = pkg["o"], pkg["r"], pkg["t"]
    objs = samples(pkg, seed)
    rs.create("Queue", o.Queue(meta=o.Metadata(name="default", namespace=""), weight=2))
    rs.create("Node", o.Node(meta=o.Metadata(name="n0", namespace=""),
                             allocatable=r.Resource.from_resource_list(
                                 {"cpu": "8", "memory": "16Gi", "pods": 110})))
    pg = o.PodGroup(meta=o.Metadata(name="pg"), min_member=2)
    pg.status.phase = t.PodGroupPhase.PENDING
    rs.create("PodGroup", pg)
    for i in range(20):
        rs.create("Pod", o.Pod(meta=o.Metadata(name=f"p{i}",
                                               annotations={tobjects.POD_GROUP_KEY: "pg"}),
                               spec=o.PodSpec(resources=r.Resource(500.0, 2.0 ** 28))))
    for kind in ("PV", "Lease", "PodDisruptionBudget"):
        rs.create(kind, objs[kind])
    with pytest.raises(KeyError):
        rs.create("Queue", o.Queue(meta=o.Metadata(name="default", namespace="")))
    n = rs.get("Node", "/n0")
    n.labels["zone"] = "z1"
    rs.update("Node", n)
    stale = rs.get("Node", "/n0")
    n.unschedulable = True
    rs.update("Node", n)
    with pytest.raises(Exception) as e:
        rs.update_cas("Node", stale, stale.meta.resource_version)
    assert type(e.value).__name__ == "Conflict"
    out = rs.patch("PodGroup", "default/pg", {"status.phase": t.PodGroupPhase.INQUEUE},
                   when={"status.phase": t.PodGroupPhase.PENDING})
    assert out.status.phase == t.PodGroupPhase.INQUEUE
    with pytest.raises(Exception) as e:
        rs.patch("PodGroup", "default/pg", {"status.phase": t.PodGroupPhase.RUNNING},
                 when={"status.phase": t.PodGroupPhase.PENDING})
    assert type(e.value).__name__ == "PreconditionFailed"
    # 16 same-shape patches ship as one patch_col run
    res = rs.bulk([{"op": "patch", "kind": "Pod", "key": f"default/p{i}",
                    "fields": {"phase": t.PodPhase.PENDING, "hostname": f"h{i % 2}"}}
                   for i in range(16)]
                  + [{"op": "patch", "kind": "Pod", "key": "default/ghost",
                      "fields": {"node_name": "n0"}},
                     {"op": "delete", "kind": "Pod", "key": "default/p19"}])
    assert res[:16] == [None] * 16 and res[16].startswith("NotFound") and res[17] is None
    seg = Segment.build(["default/p0", "default/p1", "default/ghost"], [0, 0, 0], ["n0"],
                        evicts=[("default/p2", "Preempted")])
    res = rs.apply_segment(seg)
    assert [row for row, _ in res["binds"]] == [2] and not res["evicts"]
    assert rs.delete("Pod", "default/p3") is not None
    assert rs.get("Pod", "default/p3") is None


def _check_state(rs, pkg):
    o = pkg["o"]
    pods = {p.meta.key: (p.node_name, p.deleting, p.hostname) for p in rs.list("Pod")}
    assert len(pods) == 18 and pods["default/p0"] == ("n0", False, "h0")
    assert pods["default/p2"][1] is True
    assert rs.get("Node", "/n0").labels["zone"] == "z1"
    assert sorted(e.reason for e in rs.list("Event")) == ["Evict", "Scheduled", "Scheduled"]
    assert isinstance(rs.get("PodGroup", "default/pg"), o.PodGroup)


@pytest.mark.parametrize("direction", ["jax-client-port-server", "port-client-jax-server"])
def test_cross_wire_crud_patch_bulk_segment_watch(direction):
    if direction == "jax-client-port-server":
        srv, Client, pkg, Segment = StoreServer().start(), JRemoteStore, JAX, JSegment
    else:
        srv, Client, pkg, Segment = JStoreServer().start(), RemoteStore, PORT, DecisionSegment
    try:
        watcher = Client(srv.url)
        qs = {k: watcher.watch(k) for k in ("Pod", "Node", "PodGroup", "Event")}
        rs = Client(srv.url)
        _drive(rs, pkg, Segment)
        _check_state(rs, pkg)
        got = {k: [] for k in qs}
        for k, q in qs.items():
            while q:
                ev = q.popleft()
                got[k].append((ev.type.value, ev.obj.meta.key))
        assert got["Node"] == [("Added", "/n0"), ("Updated", "/n0"), ("Updated", "/n0")]
        assert got["PodGroup"] == [("Added", "default/pg"), ("Updated", "default/pg")]
        assert sum(1 for ty, _ in got["Pod"] if ty == "Added") == 20
        assert ("Deleted", "default/p19") in got["Pod"] and ("Deleted", "default/p3") in got["Pod"]
        assert [ty for ty, _ in got["Event"]] == ["Added"] * 3
        # the other package's client reads the same objects back
        other = RemoteStore if Client is JRemoteStore else JRemoteStore
        ocodec = tcodec if other is RemoteStore else jcodec
        mine = tcodec if ocodec is jcodec else jcodec
        for kind in ("Pod", "Node", "PodGroup", "Queue", "PV", "Lease", "PodDisruptionBudget"):
            a = sorted(_dump(mine, x) for x in rs.list(kind))
            b = sorted(_dump(ocodec, x) for x in other(srv.url).list(kind))
            assert a == b, kind
    finally:
        srv.stop()


def _frozen_stream(monkeypatch, make_server, Client, pkg, Segment):
    for objects in (jobjects, tobjects):
        monkeypatch.setattr(objects, "_uid_token", "t0")
        monkeypatch.setattr(objects, "_uid_next", 1000)
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    # a digest beacon after every mutation: the streams then carry the
    # state digest at each step, compared without its wall-clock stamp
    monkeypatch.setenv("VOLCANO_TPU_AUDIT_BEACON_S", "0")
    srv = make_server().start()
    try:
        _drive(Client(srv.url), pkg, Segment)
        return [dict(e, digest={k: v for k, v in e["digest"].items() if k != "ts"})
                if e["kind"] == "__beacon__" else e
                for e in srv.watch_since(0, set(), 0)["events"]]
    finally:
        srv.stop()


def test_same_ops_give_equal_watch_streams(monkeypatch):
    """Both packages' servers, each driven by its own client with the same
    history, log the same stream byte for byte."""
    port = _frozen_stream(monkeypatch, StoreServer, RemoteStore, PORT, DecisionSegment)
    jax = _frozen_stream(monkeypatch, JStoreServer, JRemoteStore, JAX, JSegment)
    assert len(port) == len(jax) > 30
    assert sum(e["kind"] == "__beacon__" for e in port) > 10
    for a, b in zip(port, jax):
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True), (a, b)
