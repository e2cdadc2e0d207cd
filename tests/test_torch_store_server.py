"""The port's apiserver (``store/server.py``) and ``RemoteStore``
(``store/client.py``) against the JAX package's tests of its own.

Each case mirrors one of ``tests/test_remote_store.py`` (its line named),
run on the port's objects, server and client; the four cases with Jobs,
the job controller or admission (``:157``, ``:213``, ``:278``, ``:546``)
wait for the controllers (ROADMAP item 12).  Then what the port refuses
by name: a Job write (item 12), ``/debug/digest`` (item 11b part 2),
replication and ``/repl/*`` (part 3), the seq bus and the process mesh
(part 4), ``/chaos`` (item 13); and the partitioned bus (part 1) booting.  Then the process rule: importing the server loads
no torch, and a spawned server never initializes CUDA.

Every server listens on port 0 and keeps its state under ``tmp_path``, so
that the cases run side by side under xdist.  The port builders below
(``pod``, ``node``, ``podgroup``, ``queue``) serve the other
``test_torch_*`` store files too.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from volcano_tpu_torch.api import (
    POD_GROUP_KEY,
    Affinity,
    Metadata,
    Node,
    Pod,
    PodGroup,
    PodGroupPhase,
    PodPhase,
    PodSpec,
    Queue,
    Resource,
    Toleration,
)
from volcano_tpu_torch.store import Store
from volcano_tpu_torch.store.client import AdmissionError, RemoteStore, StaleWatch
from volcano_tpu_torch.store.codec import KIND_CLASSES, decode, encode
from volcano_tpu_torch.store.server import StoreServer
from volcano_tpu_torch.store.store import Conflict, PreconditionFailed


@pytest.fixture(autouse=True)
def _op_determined_seqs(monkeypatch):
    """The digest beacons take seqs on a wall-clock cadence (1 s by
    default), so a slow run would slip one in where these cases expect
    only their own writes: the cadence is pinned past each case, as
    ``tests/test_procmesh.py:118`` does.  The digest stays armed;
    ``stamp_beacon`` still stamps one on demand."""
    monkeypatch.setenv("VOLCANO_TPU_AUDIT_BEACON_S", "3600")


# -- the port's builders (tests/helpers.py's, on the port's classes) -----------


def node(name, cpu="4", memory="8Gi", pods=110, labels=None):
    return Node(meta=Metadata(name=name, namespace=""),
                allocatable=Resource.from_resource_list(
                    {"cpu": cpu, "memory": memory, "pods": pods}),
                labels=dict(labels or {}))


def pod(name, group="", cpu="1", memory="1Gi", namespace="default", node_name="",
        phase=PodPhase.PENDING):
    ann = {POD_GROUP_KEY: group} if group else {}
    return Pod(meta=Metadata(name=name, namespace=namespace, annotations=ann),
               spec=PodSpec(resources=Resource.from_resource_list(
                   {"cpu": cpu, "memory": memory})),
               phase=phase, node_name=node_name)


def podgroup(name, min_member=1, queue="default", phase=PodGroupPhase.INQUEUE):
    pg = PodGroup(meta=Metadata(name=name, namespace="default"), min_member=min_member,
                  queue=queue)
    pg.status.phase = phase
    return pg


def queue(name, weight=1):
    return Queue(meta=Metadata(name=name, namespace=""), weight=weight)


@pytest.fixture()
def server():
    srv = StoreServer().start()
    yield srv
    srv.stop()


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _send(url, method, path, payload):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 method=method, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


# -- codec ---------------------------------------------------------------------


def test_codec_round_trips_every_kind():
    """test_remote_store.py:62, on every kind the port has."""
    from volcano_tpu_torch.api import (
        PersistentVolume,
        PersistentVolumeClaim,
        PodDisruptionBudget,
        PriorityClass,
        StorageClass,
    )
    from volcano_tpu_torch.events import ClusterEvent
    from volcano_tpu_torch.leader import Lease

    samples = {
        "Pod": Pod(
            meta=Metadata(name="p", labels={"a": "b"}, owner=("Job", "j")),
            spec=PodSpec(
                resources=Resource(2000, 4 << 30, {"tpu.dev/v5e": 4.0}),
                affinity=Affinity(node_terms=[[("zone", "In", ("a", "b"))]],
                                  preferred_node_terms=[(5, [("ssd", "Exists", ())])],
                                  pod_anti_affinity=[{"app": "web"}]),
                tolerations=[Toleration(key="k", value="v", effect="NoSchedule")],
                host_ports=[8080]),
            phase=PodPhase.RUNNING, node_name="n1", env={"X": "1"}, volumes=["c"]),
        "Node": Node(meta=Metadata(name="n", namespace=""), allocatable=Resource(8000, 16 << 30)),
        "Queue": Queue(meta=Metadata(name="q", namespace=""), weight=4),
        "PodGroup": PodGroup(meta=Metadata(name="pg"), min_member=3),
        "PriorityClass": PriorityClass(meta=Metadata(name="hi", namespace=""), value=9),
        "PVC": PersistentVolumeClaim(meta=Metadata(name="c"), size="5Gi"),
        "PV": PersistentVolume(meta=Metadata(name="v", namespace=""), capacity="9Gi",
                               node_affinity={"zone": "a"}),
        "StorageClass": StorageClass(meta=Metadata(name="sc", namespace=""), provisioner=""),
        "PodDisruptionBudget": PodDisruptionBudget(
            meta=Metadata(name="b", owner=("ReplicaSet", "rs")), min_available=2),
        "Lease": Lease(meta=Metadata(name="l", namespace=""), holder="a", renewed_at=1.5),
        "Event": ClusterEvent(meta=Metadata(name="e", namespace=""),
                              involved=("Pod", "default/p"), reason="Scheduled"),
    }
    assert set(samples) == set(KIND_CLASSES)
    for kind, obj in samples.items():
        wire = json.loads(json.dumps(encode(obj)))
        assert decode(KIND_CLASSES[kind], wire) == obj, f"{kind} did not round-trip"


# -- CRUD and watch over HTTP ---------------------------------------------------


def test_remote_crud_and_watch(server):
    """test_remote_store.py:119."""
    a = RemoteStore(server.url)
    b = RemoteStore(server.url)
    watch_q = b.watch("Node")
    n = Node(meta=Metadata(name="n1", namespace=""), allocatable=Resource(4000, 8 << 30))
    a.create("Node", n)
    assert n.meta.resource_version > 0  # server-stamped, propagated back
    got = b.get("Node", "/n1")
    assert got is not None and got.allocatable == n.allocatable
    assert [x.meta.name for x in b.list("Node")] == ["n1"]
    got.unschedulable = True
    b.update("Node", got)
    assert a.get("Node", "/n1").unschedulable
    ev = watch_q.popleft()
    assert (ev.type.value, ev.obj.meta.name) == ("Added", "n1")
    ev = watch_q.popleft()
    assert ev.type.value == "Updated" and ev.obj.unschedulable
    assert ev.old is not None and not ev.old.unschedulable
    assert a.delete("Node", "/n1") is not None
    assert a.get("Node", "/n1") is None
    assert watch_q.popleft().type.value == "Deleted"
    assert not watch_q


def test_create_conflict_and_update_missing(server):
    """test_remote_store.py:148."""
    s = RemoteStore(server.url)
    s.create("Queue", queue("q"))
    with pytest.raises(KeyError):
        s.create("Queue", queue("q"))
    with pytest.raises(KeyError):
        s.update("Queue", queue("ghost"))


def test_update_cas_rejects_stale_writes(server):
    """test_remote_store.py:181."""
    s = RemoteStore(server.url)
    s.create("Node", node("n1", cpu="1", memory="1Gi"))
    stale = s.get("Node", "/n1")
    fresh = s.get("Node", "/n1")
    fresh.unschedulable = True
    s.update("Node", fresh)
    stale.labels["x"] = "y"
    with pytest.raises(Conflict):
        s.update_cas("Node", stale, stale.meta.resource_version)
    assert s.get("Node", "/n1").unschedulable


def test_leader_election_create_race_does_not_crash_loser(server):
    """test_remote_store.py:200: both candidates see no lease; the create
    loser stands by."""
    from volcano_tpu_torch.leader import LeaderElector

    e1 = LeaderElector(RemoteStore(server.url), "vk-scheduler", "a")
    e2 = LeaderElector(RemoteStore(server.url), "vk-scheduler", "b")
    assert (e1.try_acquire(), e2.try_acquire()) == (True, False)
    assert e1.is_leader() and not e2.is_leader()


def test_leader_election_across_clients(server):
    """test_remote_store.py:244."""
    from volcano_tpu_torch.leader import LeaderElector

    clock = [0.0]
    e1 = LeaderElector(RemoteStore(server.url), "vk-controllers", "a", clock=lambda: clock[0])
    e2 = LeaderElector(RemoteStore(server.url), "vk-controllers", "b", clock=lambda: clock[0])
    assert e1.try_acquire()
    assert not e2.try_acquire()
    clock[0] += 20.0  # the lease expires without a renewal
    assert e2.try_acquire()
    assert not e1.try_acquire()
    assert e2.is_leader() and not e1.is_leader()


def test_watch_relist_after_log_overflow(server):
    """test_remote_store.py:260."""
    from volcano_tpu_torch.store.server import LOG_CAP

    s = RemoteStore(server.url)
    s.watch("Queue")
    s.poll()
    server.log[:] = []  # everything this client missed fell off the cap
    server.seq += LOG_CAP + 1
    with pytest.raises(StaleWatch):
        s.poll()
    assert s.poll() == 0  # the cursor moved to the head


# -- durability -------------------------------------------------------------------


def test_server_state_survives_restart(tmp_path):
    """test_remote_store.py:357: every object, its rv and the version line
    survive; a cursor from before the restart relists."""
    state = str(tmp_path / "state.json")
    srv = StoreServer(state_path=state, save_interval=0.0).start()
    rs = RemoteStore(srv.url)
    rs.create("Queue", queue("q"))
    rs.create("Node", node("n0"))
    node_rv = rs.get("Node", "/n0").meta.resource_version
    seq_before = srv.seq
    srv.stop()
    srv2 = StoreServer(state_path=state, save_interval=0.0).start()
    try:
        rs2 = RemoteStore(srv2.url)
        n = rs2.get("Node", "/n0")
        assert n is not None and n.meta.resource_version == node_rv
        assert rs2.get("Queue", "/q") is not None
        n.labels["zone"] = "z1"
        assert rs2.update("Node", n).meta.resource_version > node_rv
        assert srv2.watch_since(seq_before + 100, set(), 0).get("relist")
    finally:
        srv2.stop()


def test_state_kinds_survive_double_restart(tmp_path):
    """test_remote_store.py:396: the flush after a restart keeps the kinds
    it did not dirty (the encoded cache is seeded at load)."""
    state = str(tmp_path / "state.json")
    srv = StoreServer(state_path=state).start()
    srv.store.create("Queue", queue("q"))
    srv.store.create("Node", node("n0"))
    with srv.lock:
        srv._pump_log()
    srv.stop()
    srv2 = StoreServer(state_path=state).start()
    q = srv2.store.get("Queue", "/q")
    q.weight = 7
    srv2.store.update("Queue", q)
    with srv2.lock:
        srv2._pump_log()
    srv2.stop()
    srv3 = StoreServer(state_path=state).start()
    try:
        assert srv3.store.get("Node", "/n0") is not None, "Node dropped from the state"
        assert srv3.store.get("Queue", "/q").weight == 7
    finally:
        srv3.stop()


def test_flush_state_picks_up_direct_store_writes(tmp_path):
    """test_remote_store.py:555."""
    state = str(tmp_path / "state.json")
    srv = StoreServer(state_path=state)  # never started
    srv.store.create("Queue", queue("direct"))
    srv.flush_state()
    srv.kill()
    srv2 = StoreServer(state_path=state)
    try:
        assert srv2.store.get("Queue", "/direct") is not None
    finally:
        srv2.kill()


def test_sync_persist_mode_is_durable_before_ack(tmp_path):
    """test_remote_store.py:569: save_interval <= 0 writes the state file
    before the reply."""
    state = str(tmp_path / "state.json")
    srv = StoreServer(state_path=state, save_interval=0).start()
    try:
        rs = RemoteStore(srv.url)
        rs.create("Pod", pod("dur1"))
        rs.bulk([{"op": "patch", "kind": "Pod", "key": "default/dur1",
                  "fields": {"node_name": "n1"}}])
        pods = json.load(open(state))["kinds"]["Pod"]
        assert len(pods) == 1 and pods[0]["node_name"] == "n1"
    finally:
        srv.stop()


# -- patch and bulk over the wire -----------------------------------------------


def test_remote_patch_and_bulk_round_trip(server):
    """test_remote_store.py:434."""
    s = RemoteStore(server.url)
    s.create("Pod", pod("bp1"))
    s.create("Pod", pod("bp2"))
    out = s.patch("Pod", "default/bp1", {"node_name": "n7"})
    assert out.node_name == "n7" and s.get("Pod", "default/bp1").node_name == "n7"
    with pytest.raises(KeyError):
        s.patch("Pod", "default/ghost", {"node_name": "n7"})
    results = s.bulk([
        {"op": "patch", "kind": "Pod", "key": "default/bp2",
         "fields": {"node_name": "n8", "deleting": True}},
        {"op": "patch", "kind": "Pod", "key": "default/ghost", "fields": {"node_name": "n8"}},
        {"op": "create", "kind": "Pod", "object": pod("bp3")},
        {"op": "delete", "kind": "Pod", "key": "default/bp1"},
    ])
    assert results[0] is None and results[2] is None and results[3] is None
    assert results[1] is not None and "ghost" in results[1]
    p2 = s.get("Pod", "default/bp2")
    assert p2.node_name == "n8" and p2.deleting
    assert s.get("Pod", "default/bp3") is not None
    assert s.get("Pod", "default/bp1") is None


def test_conditional_dotted_patch_local_and_remote(server):
    """test_remote_store.py:463: a dotted patch with a precondition, the
    same in process and over HTTP."""

    def drive(s):
        pg = podgroup("cp1", min_member=3, phase=PodGroupPhase.PENDING)
        pg.status.running = 2
        s.create("PodGroup", pg)
        out = s.patch("PodGroup", "default/cp1", {"status.phase": PodGroupPhase.INQUEUE},
                      when={"status.phase": PodGroupPhase.PENDING})
        assert out.status.phase == PodGroupPhase.INQUEUE
        got = s.get("PodGroup", "default/cp1")
        assert got.status.phase == PodGroupPhase.INQUEUE and got.status.running == 2
        rv = got.meta.resource_version
        with pytest.raises(PreconditionFailed):
            s.patch("PodGroup", "default/cp1", {"status.phase": PodGroupPhase.RUNNING},
                    when={"status.phase": PodGroupPhase.PENDING})
        got = s.get("PodGroup", "default/cp1")
        assert got.status.phase == PodGroupPhase.INQUEUE and got.meta.resource_version == rv
        s.create("PodGroup", podgroup("cp2", phase=PodGroupPhase.PENDING))
        res = s.bulk([
            {"op": "patch", "kind": "PodGroup", "key": "default/cp2",
             "fields": {"status.phase": PodGroupPhase.INQUEUE},
             "when": {"status.phase": PodGroupPhase.PENDING}},
            {"op": "patch", "kind": "PodGroup", "key": "default/cp1",
             "fields": {"status.phase": PodGroupPhase.RUNNING},
             "when": {"status.phase": PodGroupPhase.PENDING}},
            {"op": "patch", "kind": "PodGroup", "key": "default/cp2",
             "fields": {"status.nope": 1}},
        ])
        assert res[0] is None
        assert res[1] is not None and res[1].startswith("PreconditionFailed")
        assert res[2] is not None and "nope" in res[2]
        assert s.get("PodGroup", "default/cp2").status.phase == PodGroupPhase.INQUEUE

    drive(Store())
    drive(RemoteStore(server.url))


def test_remote_bulk_events_flow_to_watchers(server):
    """test_remote_store.py:523."""
    writer = RemoteStore(server.url)
    watcher = RemoteStore(server.url)
    writer.create("Pod", pod("wp1"))
    q = watcher.watch("Pod")
    writer.bulk([{"op": "patch", "kind": "Pod", "key": "default/wp1",
                  "fields": {"node_name": "n1"}}])
    deadline = time.monotonic() + 5
    seen = []
    while time.monotonic() < deadline and not seen:
        watcher.poll()
        while q:
            seen.append(q.popleft())
    assert any(ev.obj.meta.key == "default/wp1" and ev.obj.node_name == "n1" for ev in seen)


def test_patch_runs_ship_columnar(server):
    """``RemoteStore._compress_patch_runs``: 16 same-shape patches are one
    ``patch_col`` op, its per-key results flattened back."""
    s = RemoteStore(server.url)
    for i in range(20):
        s.create("Pod", pod(f"c{i}"))
    ops = [{"op": "patch", "kind": "Pod", "key": f"default/c{i}",
            "fields": {"node_name": f"n{i % 3}"}} for i in range(20)]
    wire = RemoteStore._compress_patch_runs([dict(o) for o in ops])
    assert [w["op"] for w in wire] == ["patch_col"]
    assert RemoteStore._compress_patch_runs([dict(o) for o in ops[:15]]) == ops[:15]
    ops.append({"op": "patch", "kind": "Pod", "key": "default/ghost",
                "fields": {"node_name": "n0"}})
    res = s.bulk(ops)
    assert res[:20] == [None] * 20 and res[20].startswith("NotFound")
    assert [p.node_name for p in s.list("Pod")] == [f"n{i % 3}" for i in range(20)]


# -- refused by name -------------------------------------------------------------


def test_job_writes_fail_naming_item_12(server):
    """The Job kind (and Command, NodePool, ConfigMap, Service) comes with
    the controllers: every write of it answers 422 naming item 12."""
    url = server.url
    body = {"object": {"meta": {"name": "j", "namespace": "default"}}}
    for method, path, payload in (
        ("POST", "/apis/Job", body),
        ("PUT", "/apis/Job", body),
        ("PATCH", "/apis/Job/obj?key=default/j", {"fields": {"max_retry": 5}}),
        ("DELETE", "/apis/Command/obj?key=default/c", {}),
    ):
        code, out = _send(url, method, path, payload)
        assert code == 422 and "ROADMAP item 12" in out["error"], (method, path, out)
    code, out = _get(url, "/apis/Job")
    assert code == 422 and "item 12" in out["error"]
    s = RemoteStore(url)
    with pytest.raises(AdmissionError, match="item 12"):
        s.create("Job", queue("j"))
    res = s.bulk([{"op": "create", "kind": "Job", "object": queue("j")},
                  {"op": "delete", "kind": "ConfigMap", "key": "default/x"}])
    assert all("item 12" in r for r in res)


def test_later_options_and_routes_fail_naming_their_item(server, tmp_path):
    """The options and routes of later parts raise or answer naming their
    item; the partitioned bus (item 11b part 1) boots, serves and applies:
    ``shards=4`` with and without the WAL, ``/watch?shard=``, a shard-tagged
    segment op, a partitioned WAL directory at boot.  ``/debug/digest``
    (item 11b part 2) answers with the state digest."""
    for kw, item in (({"repl": {"peers": []}}, "item 11b part 3"),
                     ({"seq_bus": object()}, "item 11b part 4"),
                     ({"proc_shard": (0, 2)}, "item 11b part 4")):
        with pytest.raises(ValueError, match=item):
            StoreServer(**kw)
    url = server.url
    for path, item in (("/repl/status", "part 3"), ("/repl/feed?from=0", "part 3")):
        code, out = _get(url, path)
        assert code == 404 and f"item 11b {item}" in out["error"], (path, out)
    code, out = _get(url, "/debug/digest")
    assert code == 200 and out["enabled"] and out["seq"] == server.seq, out
    assert out["root"] == _get(url, "/debug/digest?recompute=1")[1]["root"]
    assert out["root"] == server.store.recompute_digest().payload()["root"]
    code, out = _get(url, "/chaos")
    assert code == 404 and "item 13" in out["error"]
    code, out = _send(url, "POST", "/chaos", {"rules": []})
    assert code == 404 and "item 13" in out["error"]
    from volcano_tpu_torch.store.partition import shard_of
    from volcano_tpu_torch.store.segment import DecisionSegment

    state = str(tmp_path / "state.json")
    shard = shard_of("default", 4)
    for wal in (False, True):
        srv = StoreServer(shards=4, state_path=state, wal=wal).start()
        try:
            assert _get(srv.url, "/healthz")[1]["shards"] == 4
            rs = RemoteStore(srv.url)
            since = srv.seq
            rs.create("Pod", pod(f"x{int(wal)}"))
            code, out = _get(srv.url, f"/watch?since={since}&shard={shard}")
            assert code == 200 and [e["object"]["meta"]["name"]
                                    for e in out["events"]] == [f"x{int(wal)}"]
            op = DecisionSegment.build([f"default/x{int(wal)}"], [0], ["n0"]).to_wire()
            op["shard"] = shard
            res = rs._request("POST", "/bulk", {"ops": [op]})[1]["results"][0]
            assert not res["binds"] and not res["evicts"], res
            assert rs.get("Pod", f"default/x{int(wal)}").node_name == "n0"
        finally:
            srv.stop()
    # the partitioned life's WAL directory boots a one-shard server with
    # every acknowledged record
    assert (tmp_path / "state.json.wal" / f"s{shard:02d}").is_dir()
    srv = StoreServer(state_path=state, wal=True).start()
    try:
        assert [srv.store.get("Pod", f"default/x{i}").node_name for i in (0, 1)] == ["n0"] * 2
    finally:
        srv.stop()


# -- the process rule --------------------------------------------------------------


def test_server_import_loads_no_torch():
    """The apiserver process imports no torch: the card is the scheduler's."""
    code = ("import sys; import volcano_tpu_torch.store.server, volcano_tpu_torch.store.client, "
            "volcano_tpu_torch.store.wal; print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_spawned_server_never_initializes_cuda():
    """A server spawned as chip_smoke.py's phase 29 spawns it
    (``serve_in_child`` under the spawn context) serves, and its process
    maps neither torch nor the CUDA runtime or driver (read from the
    parent, in /proc/<pid>/maps): it cannot have initialized CUDA."""
    import multiprocessing as mp

    from volcano_tpu_torch.store.server import serve_in_child

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=serve_in_child, args=(q,), daemon=True)
    proc.start()
    try:
        url = q.get(timeout=60)
        rs = RemoteStore(url)
        rs.create("Queue", queue("q"))
        assert [x.meta.name for x in rs.list("Queue")] == ["q"]
        with open(f"/proc/{proc.pid}/maps") as f:
            libs = {os.path.basename(line.split()[-1]) for line in f if "/" in line}
        assert any(lib.startswith("libc.so") for lib in libs)  # the maps were read
        assert not [lib for lib in libs
                    if lib.startswith(("libtorch", "libc10", "libcudart", "libcuda.so"))]
    finally:
        proc.terminate()
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    assert proc.exitcode == 0  # SIGTERM: the graceful stop


def test_concurrent_writers_see_one_ordered_log(server):
    """Threads writing through their own clients: every write lands once in
    the log, seqs strictly increasing."""
    def writer(k):
        s = RemoteStore(server.url)
        for i in range(10):
            s.create("Pod", pod(f"w{k}-{i}"))
            s.patch("Pod", f"default/w{k}-{i}", {"node_name": f"n{k}"})

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rows = server.watch_since(0, {"Pod"}, 0)["events"]
    assert len(rows) == 80
    seqs = [e["seq"] for e in rows]
    assert seqs == sorted(seqs) and len(set(seqs)) == 80
    assert all(p.node_name for p in RemoteStore(server.url).list("Pod"))
