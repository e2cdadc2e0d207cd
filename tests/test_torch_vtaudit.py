"""The port's state digest (``volcano_tpu_torch/vtaudit.py``) against the
JAX package's, hex for hex.

The cases of ``tests/test_vtaudit.py``, each run on the port and, wherever
an output can be compared, on the JAX package with the same objects: the
digest algebra (order independence, removal as the inverse, field deltas
equal to a full digest, the resource version left out); the store's table
through every verb (the patch's delta, the in-process segment, the lazy
staging of the columnar wire, ``patch_col``); the corruption drill walked
through ``/debug/digest``'s tiers down to the flipped object; the mirror's
own table verifying in-process and against beacons, across packages both
ways; the WAL replay's digest, each package's of the other's WAL; the
beacons on every shard's watch; the audit's metric families.
"""

import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

from volcano_tpu import vtaudit as jvtaudit
from volcano_tpu.api import objects as jobjects
from volcano_tpu.scheduler import metrics as jmetrics
from volcano_tpu.scheduler.fastpath import ArrayMirror as JArrayMirror
from volcano_tpu.store import Store as JStore
from volcano_tpu.store.client import RemoteStore as JRemoteStore
from volcano_tpu.store.segment import DecisionSegment as JSegment
from volcano_tpu.store.server import StoreServer as JStoreServer
from volcano_tpu_torch import vtaudit
from volcano_tpu_torch.api import objects as tobjects
from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.scheduler.fastpath.mirror import ArrayMirror
from volcano_tpu_torch.store import Store, codec
from volcano_tpu_torch.store.client import RemoteStore, StaleWatch
from volcano_tpu_torch.store.segment import DecisionSegment
from volcano_tpu_torch.store.server import StoreServer

from helpers import build_node, build_pod, build_podgroup
from test_torch_codec_wire import JAX, PORT, jcodec, samples
from test_torch_object import _convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    not (vtaudit.enabled() and jvtaudit.enabled()), reason="digest audit disarmed in env")


@pytest.fixture(autouse=True)
def _beacons_on_demand(monkeypatch):
    """Beacons only where a case stamps one (``stamp_beacon``) or sets its
    own cadence: a wall-clock one would slip in between a case's steps."""
    monkeypatch.setenv("VOLCANO_TPU_AUDIT_BEACON_S", "3600")


@pytest.fixture()
def frozen(monkeypatch):
    """Equal uids and creation stamps in both packages' stores."""
    for objects in (jobjects, tobjects):
        monkeypatch.setattr(objects, "_uid_token", "t0")
        monkeypatch.setattr(objects, "_uid_next", 1000)
    monkeypatch.setattr(time, "time", lambda: 1234.5)


def _fetch(url, path):
    with urllib.request.urlopen(url.rstrip("/") + path, timeout=10) as r:
        return json.load(r)


def _port(kind, jobj):
    """The port's copy of a JAX object, equal on the wire."""
    tobj = _convert(kind, jobj)
    tobj.meta.creation_timestamp = jobj.meta.creation_timestamp
    tobj.meta.resource_version = jobj.meta.resource_version
    return tobj


def _pods(n, ns=lambda i: "default", **kw):
    jp = [build_pod(f"p{i}", namespace=ns(i), **kw) for i in range(n)]
    return jp, [_port("Pod", p) for p in jp]


def _tables_equal(t, j, nshards=4):
    assert t.payload(nshards) == j.payload(nshards)
    assert t.bucket_payload() == j.bucket_payload()
    for (kind, ns) in j.buckets:
        assert t.object_payload(kind, ns) == j.object_payload(kind, ns), (kind, ns)


# -- the digest algebra (test_vtaudit.py:50-110) ----------------------------------


def test_leaf_hash_key_mult_and_object_digests_equal_jax():
    """The primitives and every kind's object digest equal JAX's; the walk on
    the decoded object equals the flatten of its encoding."""
    for path, v in (("a", None), ("a", True), ("a", False), ("a", 1), ("b", 1.0), ("b", "1"),
                    ("meta.name", "p0"), ("x", "\x01{}"), ("y", -3), ("z", 2.5e9)):
        assert vtaudit.leaf_hash(path, v) == jvtaudit.leaf_hash(path, v), (path, v)
    for kind, key in (("Pod", "default/p0"), ("Node", "/n0"), ("Queue", "/q")):
        assert vtaudit.key_mult(kind, key) == jvtaudit.key_mult(kind, key)
    for seed in range(3):
        t, j = samples(PORT, seed), samples(JAX, seed)
        for kind in t:
            enc = codec.encode(t[kind])
            assert vtaudit.value_leaf_sum(t[kind]) == vtaudit.leaf_sum(enc), kind
            assert vtaudit.obj_digest(kind, t[kind]) == jvtaudit.obj_digest(kind, j[kind]), kind
            assert (vtaudit.obj_digest_enc(kind, t[kind].meta.key, enc)
                    == jvtaudit.obj_digest(kind, j[kind])), kind


def _walk_values(pkg):
    """Values whose encodings take each of the encoder's rules: a Resource
    with and without scalars and with a pod cap of None, 0 and more, an
    enum, empty and nested containers, dict keys that are not strings."""
    r, t = pkg["r"], pkg["t"]
    return [
        r.Resource(1500.0, 2.0 * 2 ** 30),
        r.Resource(0.0, 0.0, {"nvidia.com/gpu": 2.0}, max_task_num=0),
        r.Resource(250.0, 1.0, {}, max_task_num=110),
        {"a": r.Resource(1.0, 1.0, {"x": 1.0}), "b": [], "c": {}},
        t.PodPhase.RUNNING,
        {1: [t.PodGroupPhase.INQUEUE, None], 2: ()},
        [[], {}, [r.Resource(3.0, 4.0)]],
    ]


@pytest.mark.parametrize("i", range(7))
def test_decoded_walk_equals_the_encodings_flatten_and_jax(i):
    """``value_leaf_sum``, the walk on the decoded value, equals the leaf
    sum of its encoding, and the JAX digest of the same value, under a root
    and under a field path; ``field_delta`` between two values agrees."""
    tv, jv = _walk_values(PORT)[i], _walk_values(JAX)[i]
    for path in ("", "spec.resources"):
        want = jvtaudit.leaf_sum(jcodec.encode(jv), path)
        assert vtaudit.value_leaf_sum(tv, path) == want
        assert vtaudit.leaf_sum(codec.encode(tv), path) == want
    other = _walk_values(PORT)[(i + 1) % 7]
    jother = _walk_values(JAX)[(i + 1) % 7]
    assert vtaudit.field_delta("spec.x", tv, other) == jvtaudit.field_delta("spec.x", jv, jother)


def test_digest_order_independent_and_removal_inverse():
    jp, tp = _pods(12, ns=lambda i: f"ns{i % 3}")
    a = vtaudit.table_from_objects(("Pod", p) for p in tp)
    b = vtaudit.table_from_objects(("Pod", p) for p in reversed(tp))
    assert a.root() == b.root()
    assert a.bucket_payload() == b.bucket_payload()
    _tables_equal(a, jvtaudit.table_from_objects(("Pod", p) for p in jp))
    before = a.payload(4)
    jextra = build_pod("extra", namespace="ns1")
    extra = _port("Pod", jextra)
    a.set_obj("Pod", extra.meta.key, extra)
    assert a.payload(4) != before
    j = jvtaudit.table_from_objects(("Pod", p) for p in jp + [jextra])
    _tables_equal(a, j)
    a.remove("Pod", extra.meta.key)
    assert a.payload(4) == before


def test_field_delta_patch_equals_full_redigest():
    from volcano_tpu.api.types import PodGroupPhase as JPhase
    from volcano_tpu_torch.api.types import PodGroupPhase

    t, j = vtaudit.DigestTable(), jvtaudit.DigestTable()
    jpod = build_pod("p0")
    p = _port("Pod", jpod)
    t.set_obj("Pod", p.meta.key, p)
    j.set_obj("Pod", jpod.meta.key, jpod)
    old = p.node_name
    p.node_name = jpod.node_name = "n7"
    t.apply_fields("Pod", p.meta.key, (("node_name", old, "n7"),), obj=p)
    j.apply_fields("Pod", jpod.meta.key, (("node_name", old, "n7"),), obj=jpod)
    fresh = vtaudit.table_from_objects([("Pod", p)])
    assert t.root() == fresh.root()
    assert t.object_payload("Pod", "default") == fresh.object_payload("Pod", "default")
    _tables_equal(t, j)
    # an enum and a dataclass value through the delta, as a patch carries them
    jpg = build_podgroup("pg")
    pg = _port("PodGroup", jpg)
    t.set_obj("PodGroup", pg.meta.key, pg)
    j.set_obj("PodGroup", jpg.meta.key, jpg)
    t.apply_fields("PodGroup", pg.meta.key, (("status.phase", pg.status.phase,
                                              PodGroupPhase.RUNNING),
                                             ("min_resources", pg.min_resources,
                                              tobjects.Resource(500.0, 2.0 ** 30))))
    j.apply_fields("PodGroup", jpg.meta.key, (("status.phase", jpg.status.phase, JPhase.RUNNING),
                                              ("min_resources", jpg.min_resources,
                                               jobjects.Resource(500.0, 2.0 ** 30))))
    _tables_equal(t, j)
    pg.status.phase, pg.min_resources = PodGroupPhase.RUNNING, tobjects.Resource(500.0, 2.0 ** 30)
    assert t.objd["PodGroup"][pg.meta.key] == vtaudit.obj_digest("PodGroup", pg)


def test_merge_digest_payloads_equals_jax_and_the_union():
    """Per-slice payloads of disjoint namespaces merge into the union's root
    and kinds, as the JAX merge does (the process mesh's router, part 4)."""
    jp, tp = _pods(12, ns=lambda i: f"ns{i % 4}")
    slices = [[p for p in tp if p.meta.namespace in part] for part in (("ns0", "ns1"),
                                                                        ("ns2",), ("ns3",))]
    payloads = [vtaudit.table_from_objects(("Pod", p) for p in sl).payload(1) for sl in slices]
    merged = vtaudit.merge_digest_payloads(payloads)
    assert merged == jvtaudit.merge_digest_payloads(payloads)
    union = vtaudit.table_from_objects(("Pod", p) for p in tp).payload(1)
    assert (merged["root"], merged["kinds"]) == (union["root"], union["kinds"])
    assert merged["shards"] == [p["root"] for p in payloads]


def test_resource_version_is_digest_neutral():
    jpod = build_pod("p0")
    p = _port("Pod", jpod)
    p.meta.resource_version = jpod.meta.resource_version = 1
    d1 = vtaudit.obj_digest("Pod", p)
    assert d1 == jvtaudit.obj_digest("Pod", jpod)
    p.meta.resource_version = 999
    assert vtaudit.obj_digest("Pod", p) == d1
    p.node_name = jpod.node_name = "n1"
    assert vtaudit.obj_digest("Pod", p) != d1
    assert vtaudit.obj_digest("Pod", p) == jvtaudit.obj_digest("Pod", jpod)


def _verbs(st, pkg, Segment):
    """The same history of every verb on a store of either package."""
    o, t = pkg["o"], pkg["t"]
    st.create("Queue", o.Queue(meta=o.Metadata(name="q", namespace="")))
    st.create("Node", o.Node(meta=o.Metadata(name="n0", namespace=""),
                             allocatable=pkg["r"].Resource.from_resource_list(
                                 {"cpu": "4", "memory": "8Gi", "pods": 110})))
    pg = o.PodGroup(meta=o.Metadata(name="pg", namespace="ns1"), min_member=2)
    pg.status.phase = t.PodGroupPhase.PENDING
    st.create("PodGroup", pg)
    for i in range(10):
        st.create("Pod", o.Pod(meta=o.Metadata(name=f"p{i}", namespace=f"ns{i % 2}"),
                               spec=o.PodSpec(resources=pkg["r"].Resource(250.0, 2.0 ** 28))))
    st.patch("Pod", "ns1/p1", {"node_name": "n0"})
    st.patch("PodGroup", "ns1/pg", {"status.phase": t.PodGroupPhase.INQUEUE},
             when={"status.phase": t.PodGroupPhase.PENDING})
    p3 = st.get("Pod", "ns1/p3")
    p3.phase = t.PodPhase.RUNNING
    st.update("Pod", p3)
    st.delete("Pod", "ns0/p4")
    st.apply_segment(Segment.build(["ns0/p0", "ns1/p5"], [0, 0], ["n0"],
                                   evicts=[("ns0/p2", "preempt")]))
    st.apply_segment_lazy(Segment.build(["ns0/p6", "ns1/p7", "ns1/p1"], [0, 0, 0], ["n0"],
                                        evicts=[("ns0/p8", "reclaim")]), stamp=99.0)
    return st


def test_store_maintains_digest_through_every_verb(frozen):
    """create, update, patch (a dotted enum field too), delete, the
    in-process segment and the lazy staging keep the kept table equal to a
    recompute and to the JAX store's, before and after the staged rows
    materialize."""
    st = _verbs(Store(), PORT, DecisionSegment)
    jst = _verbs(JStore(), JAX, JSegment)
    for s in (st, jst):
        assert s._digest is not None
    _tables_equal(st._digest, jst._digest)
    assert st.digest_payload(4) == jst.digest_payload(4)
    assert st.digest_buckets(1, 4) == jst.digest_buckets(1, 4)
    assert st.digest_objects("Pod", "ns1") == jst.digest_objects("Pod", "ns1")
    before = st.digest_payload(4)
    truth = st.recompute_digest()  # materializes the staged rows
    assert truth.payload(4) == before == st.digest_payload(4)
    _tables_equal(truth, jst.recompute_digest())


def test_digest_disarmed_by_env_and_rebuilt_on_unpickle(monkeypatch):
    import pickle

    monkeypatch.setenv("VOLCANO_TPU_AUDIT", "0")
    st = _verbs(Store(), PORT, DecisionSegment)
    assert st._digest is None and st.digest_payload() is None
    assert ArrayMirror(st, "volcano-tpu", "default")._audit is None
    blob = pickle.dumps(st)
    monkeypatch.setenv("VOLCANO_TPU_AUDIT", "1")
    back = pickle.loads(blob)
    assert back._digest is not None
    assert back.digest_payload(4) == back.recompute_digest().payload(4)


# -- the corruption drill (test_vtaudit.py:113-167) -------------------------------


def test_corruption_localizes_to_exact_object_locally():
    jp, tp = _pods(8, ns=lambda i: f"ns{i % 2}")
    st = Store()
    for p in tp:
        st.create("Pod", p)
    assert st.digest_payload(4) == st.recompute_digest().payload(4)
    st._objects["Pod"]["ns1/p5"].node_name = "flipped"
    truth = st.recompute_digest()
    assert truth.root() != st._digest.root()
    buckets = vtaudit.diff_maps(st.digest_buckets(), truth.bucket_payload())
    assert buckets == ["Pod|ns1"]
    objs = vtaudit.diff_maps(st.digest_objects("Pod", "ns1"), truth.object_payload("Pod", "ns1"))
    assert objs == ["ns1/p5"]
    # the JAX package's own walk over the same corruption names the same pod
    from volcano_tpu.cli import vtctl

    jst = JStore()
    for p in jp:
        jst.create("Pod", p)
    jst._objects["Pod"]["ns1/p5"].node_name = "flipped"
    text = vtctl.cmd_audit_local(jst)
    assert "Pod ns1/p5" in text and text.count("maintained=") - 1 == 1


def _server_walk(url):
    """``/debug/digest``'s tiers walked by hand, kept against recomputed:
    the shards, their buckets, the buckets' objects; returns ``kind key``
    of every object that differs."""
    top, rec = _fetch(url, "/debug/digest"), _fetch(url, "/debug/digest?recompute=1")
    found = []
    for s, (a, b) in enumerate(zip(top["shards"], rec["shards"])):
        if a == b:
            continue
        mb = _fetch(url, f"/debug/digest?detail=buckets&shard={s}")["buckets"]
        rb = _fetch(url, f"/debug/digest?detail=buckets&shard={s}&recompute=1")["buckets"]
        for bucket in vtaudit.diff_maps(mb, rb):
            kind, ns = bucket.split("|", 1)
            mo = _fetch(url, f"/debug/digest?kind={kind}&namespace={ns}")["objects"]
            ro = _fetch(url, f"/debug/digest?kind={kind}&namespace={ns}&recompute=1")["objects"]
            found += [f"{kind} {k}" for k in vtaudit.diff_maps(mo, ro)]
    return found


@pytest.mark.parametrize("server", ["port", "jax"])
def test_corruption_localizes_over_partitioned_server(server):
    """The remote drill on a 4-shard server of either package: the walk of
    its ``/debug/digest`` tiers, kept against recomputed, names exactly the
    flipped pod (the JAX package's ``vtctl audit`` walks the same tiers)."""
    Srv, Client, _, port_objs = _PKGS[server]
    srv = Srv(shards=4).start()
    try:
        rs = Client(srv.url)
        for i in range(10):
            p = build_pod(f"p{i}", namespace=f"team{i % 4}")
            rs.create("Pod", _port("Pod", p) if port_objs else p)
        assert _server_walk(srv.url) == []
        srv.store._objects["Pod"]["team2/p6"].node_name = "flipped"
        assert _server_walk(srv.url) == ["Pod team2/p6"]
    finally:
        srv.stop()


def _spawn_server(cmd, env=None):
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=ROOT, env=env)
    line = proc.stdout.readline().strip()
    assert "listening on" in line or line.startswith("http://"), line
    return proc, line.rsplit(" ", 1)[-1]


def test_debug_digest_tiers_equal_across_spawned_packages():
    """A spawned 4-shard server of each package, loaded with the same objects
    through its own client: every ``/debug/digest`` tier equal (the kept one
    and the recomputed one), equal to ``/healthz``'s rollup."""
    jcode = ("import sys; from volcano_tpu.store.server import StoreServer; "
             "s = StoreServer(shards=4); print(s.url, flush=True); s.serve_forever()")
    procs = []
    try:
        procs.append(_spawn_server([sys.executable, "-m", "volcano_tpu_torch.store.server",
                                    "--port", "0", "--shards", "4", "--no-default-queue"]))
        procs.append(_spawn_server([sys.executable, "-c", jcode],
                                   env={**os.environ, "JAX_PLATFORMS": "cpu"}))
        (_, url), (_, jurl) = procs
        jobjs = [("Node", build_node("n0")), ("PodGroup", build_podgroup("pg", namespace="t1"))]
        jobjs += [("Pod", build_pod(f"p{i}", group="pg", namespace=f"t{i % 3}"))
                  for i in range(9)]
        for i, (kind, o) in enumerate(jobjs):
            o.meta.uid = f"u{i}"
            o.meta.creation_timestamp = 100.0 + i
        rs, jrs = RemoteStore(url), JRemoteStore(jurl)
        for kind, o in jobjs:
            jrs.create(kind, o)
            rs.create(kind, _port(kind, o))
        rs.patch("Pod", "t1/p1", {"node_name": "n0"})
        jrs.patch("Pod", "t1/p1", {"node_name": "n0"})
        for q in ("", "?recompute=1", "?detail=buckets", "?detail=buckets&shard=2",
                  "?kind=Pod&namespace=t1", "?kind=Pod&namespace=t1&recompute=1"):
            a, b = _fetch(url, "/debug/digest" + q), _fetch(jurl, "/debug/digest" + q)
            for d in (a, b):
                d.pop("seq"), d.pop("shard_seq", None)
            assert a == b, q
        hz, jhz = _fetch(url, "/healthz")["digest"], _fetch(jurl, "/healthz")["digest"]
        assert hz["root"] == jhz["root"] == _fetch(url, "/debug/digest")["root"]
        assert [s["digest"] for s in hz["shards"]] == [s["digest"] for s in jhz["shards"]]
    finally:
        for proc, _ in procs:
            proc.terminate()
            proc.wait(30)


def test_debug_digest_recompute_tier_matches_maintained_when_clean():
    srv = StoreServer(shards=4).start()
    try:
        rs = RemoteStore(srv.url)
        for i in range(6):
            rs.create("Pod", _port("Pod", build_pod(f"p{i}", namespace=f"team{i % 3}")))
        dbg = _fetch(srv.url, "/debug/digest")
        rec = _fetch(srv.url, "/debug/digest?recompute=1")
        assert dbg["enabled"] and rec["recompute"]
        assert dbg["root"] == rec["root"] and dbg["shards"] == rec["shards"]
        assert _fetch(srv.url, "/healthz")["digest"]["root"] == dbg["root"]
    finally:
        srv.stop()


# -- the mirror half (test_vtaudit.py:170-259) ------------------------------------


def _seed_cluster(create, port):
    conv = (lambda k, o: _port(k, o)) if port else (lambda k, o: o)
    create("Queue", conv("Queue", jobjects.Queue(meta=jobjects.Metadata(name="default",
                                                                        namespace=""))))
    create("Node", conv("Node", build_node("n0")))
    create("PodGroup", conv("PodGroup", build_podgroup("pg", min_member=1)))
    for i in range(5):
        create("Pod", conv("Pod", build_pod(f"p{i}", group="pg")))


def test_mirror_audit_verify_in_process_and_detects_tampering(frozen):
    """The port's mirror verifies against its in-process store as the JAX
    mirror does against the JAX store, with equal tables, through traffic;
    a poisoned table is named by kind and healed by the resync."""
    st, jst = Store(), JStore()

    def both(kind, o):
        jst.create(kind, o)
        st.create(kind, _port(kind, o))

    _seed_cluster(both, False)
    m = ArrayMirror(st, "volcano-tpu", "default")
    jm = JArrayMirror(jst, "volcano-tpu", "default")
    for mirror in (m, jm):
        mirror.drain()
        res = mirror.audit_verify()
        assert res is not None and res["ok"] and res["mode"] == "store", res
    assert m._audit.payload(4) == jm._audit.payload(4)
    for s in (st, jst):
        s.patch("Pod", "default/p1", {"node_name": "n0"})
        s.delete("Pod", "default/p4")
    for mirror in (m, jm):
        mirror.drain()
        res = mirror.audit_verify()
        assert res is not None and res["ok"], res
    assert m._audit.payload(4) == jm._audit.payload(4)
    m._audit.set_enc("Pod", "default/poison", {"meta": {"name": "poison"}})
    res = m.audit_verify()
    assert res is not None and not res["ok"] and res["kinds"] == ["Pod"]
    assert m.audit_divergences == 1
    m.drain()
    res = m.audit_verify()
    assert res is not None and res["ok"], res


_PKGS = {"port": (StoreServer, RemoteStore, ArrayMirror, True),
         "jax": (JStoreServer, JRemoteStore, JArrayMirror, False)}


@pytest.mark.parametrize("server,mirror", [("port", "port"), ("jax", "port"),
                                           ("port", "jax"), ("jax", "jax")])
def test_mirror_reaches_digest_equality_with_partitioned_server(server, mirror):
    """The merged watch stream of a 4-shard server drives a mirror's own
    table to beacon-pinned equality with the server's, either package's
    mirror against either package's server, with no divergence."""
    Srv, _, _, port_objs = _PKGS[server]
    _, Client, Mirror, _ = _PKGS[mirror]
    srv = Srv(shards=4).start()
    try:
        writer = (RemoteStore if port_objs else JRemoteStore)(srv.url)
        _seed_cluster(writer.create, port_objs)
        m = Mirror(Client(srv.url), "volcano-tpu", "default")
        m.drain()
        for step in range(2):
            if step:
                writer.patch("Pod", "default/p2", {"node_name": "n0"})
                writer.delete("Pod", "default/p0")
            with srv.lock:
                assert srv.stamp_beacon()
            m.drain()
            res = m.audit_verify()
            assert res is not None and res["ok"], res
            assert res["mode"] == "beacon" and res["seq"] == srv.seq
        assert m.audit_checks == 2 and m.audit_divergences == 0
    finally:
        srv.stop()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_beacon_rides_every_shard_watch_and_is_not_an_object(server):
    """A beacon reaches every shard's watcher of the port's client as a
    beacon and never as an event, from either package's server."""
    Srv, _, _, port_objs = _PKGS[server]
    srv = Srv(shards=4).start()
    try:
        rs = RemoteStore(srv.url)
        for i in range(8):
            p = build_pod(f"p{i}", namespace=f"team{i}")
            rs.create("Pod", _port("Pod", p))
        watchers = [RemoteStore(srv.url, shard=s) for s in range(4)]
        queues = [w.watch("Pod") for w in watchers]
        for w in watchers:
            w.poll()
        with srv.lock:
            assert srv.stamp_beacon()
            assert not srv._maybe_beacon()
        for w, q in zip(watchers, queues):
            while q:
                q.popleft()
            w.poll()
            assert not q
            assert w.last_beacon is not None and w.beacon_is_tail
            assert w.last_beacon["seq"] == srv.seq
        dbg = _fetch(srv.url, "/debug/digest")
        assert watchers[0].last_beacon["root"] == dbg["root"]
        assert len(rs.list("Pod")) == 8
        # a write after the beacon ends the batch: the beacon is no longer
        # its tail
        from volcano_tpu_torch.store.partition import shard_of

        rs.patch("Pod", "team1/p1", {"node_name": "n0"})
        s = shard_of("team1", 4)
        watchers[s].poll()
        assert not watchers[s].beacon_is_tail and len(queues[s]) == 1
    finally:
        srv.stop()


def test_beacons_stamp_on_cadence_without_a_write(monkeypatch):
    """A server whose log moved stamps a beacon on the poll path once the
    cadence interval passed; a quiet one stamps none."""
    monkeypatch.setenv("VOLCANO_TPU_AUDIT_BEACON_S", "0.05")
    srv = StoreServer(shards=2).start()
    try:
        rs = RemoteStore(srv.url)
        rs.watch("Pod")
        rs.create("Pod", _port("Pod", build_pod("p0")))
        time.sleep(0.1)
        rs.poll(timeout=0.5)
        assert rs.last_beacon is not None and rs.beacon_is_tail
        seq = srv.seq
        time.sleep(0.1)
        rs.poll()
        assert srv.seq == seq  # no write, no new beacon
    finally:
        srv.stop()


# -- the WAL half (test_vtaudit.py:262-307) ---------------------------------------


def _wal_server(tmp_path, cls=StoreServer, port=0):
    return cls(state_path=str(tmp_path / "state.json"), save_interval=3600, wal=True,
               shards=4, port=port).start()


def test_wal_replay_digest_matches_live_server(tmp_path):
    srv = _wal_server(tmp_path)
    try:
        rs = RemoteStore(srv.url)
        _seed_cluster(rs.create, True)
        rs.patch("Pod", "default/p3", {"node_name": "n0"})
        rs.delete("Pod", "default/p1")
        live = _fetch(srv.url, "/debug/digest")
        res = vtaudit.replay_wal_digest(str(tmp_path / "state.json"))
        assert res["digest"] is not None
        assert res["digest"]["root"] == live["root"]
        assert res["digest"]["shards"] == live["shards"]
        assert res["seq"] == live["seq"] and res["shards"] == 4
    finally:
        srv.stop()


def test_wal_replay_digest_survives_kill_and_matches_reboot(tmp_path):
    srv = _wal_server(tmp_path)
    rs = RemoteStore(srv.url)
    _seed_cluster(rs.create, True)
    rs.patch("Pod", "default/p2", {"node_name": "n0"})
    srv.kill()
    res = vtaudit.replay_wal_digest(str(tmp_path / "state.json"))
    srv2 = _wal_server(tmp_path, port=srv.port)
    try:
        live = _fetch(srv2.url, "/debug/digest")
        assert res["digest"]["root"] == live["root"]
        assert res["digest"]["shards"] == live["shards"]
    finally:
        srv2.stop()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_replay_wal_digest_of_the_other_package_equals_its_own(tmp_path, writer, frozen):
    """Each package's ``replay_wal_digest`` of a WAL directory either package
    wrote gives the same payload and seq."""
    Srv, Client, _, port_objs = _PKGS[writer]
    srv = _wal_server(tmp_path, cls=Srv)
    try:
        rs = Client(srv.url)
        _seed_cluster(rs.create, port_objs)
        rs.patch("Pod", "default/p3", {"node_name": "n0"})
        seg = (DecisionSegment if port_objs else JSegment).build(
            ["default/p2"], [0], ["n0"], evicts=[("default/p4", "preempt")])
        rs.apply_segment(seg)
        live = _fetch(srv.url, "/debug/digest")
    finally:
        srv.kill()
    state = str(tmp_path / "state.json")
    mine, theirs = vtaudit.replay_wal_digest(state), jvtaudit.replay_wal_digest(state)
    assert mine["digest"] == theirs["digest"]
    assert mine["digest"]["root"] == live["root"]
    assert mine["seq"] == theirs["seq"]


def test_corruption_drill_flipped_byte_detected_and_localized(tmp_path):
    """The digest half of ``tests/test_crash_recovery.py:1124`` on the port's
    WAL-backed server: a field flipped behind the verbs is found by the walk
    of the ``/debug/digest`` tiers as exactly ``Pod ns1/p3``, and the WAL
    replay's digest sides with the kept table, not the raw state."""
    srv = StoreServer(state_path=str(tmp_path / "state.json"), wal=True,
                      save_interval=3600).start()
    try:
        rs = RemoteStore(srv.url)
        rs.create("Queue", tobjects.Queue(meta=tobjects.Metadata(name="default", namespace="")))
        for i in range(8):
            rs.create("Pod", _port("Pod", build_pod(f"p{i}", namespace=f"ns{i % 2}")))
        assert _server_walk(srv.url) == []
        maint_root = srv.store.digest_payload(srv.shards)["root"]
        srv.store._objects["Pod"]["ns1/p3"].node_name = "flipped"
        assert _server_walk(srv.url) == ["Pod ns1/p3"]
        srv.flush_state()
        replay = vtaudit.replay_wal_digest(str(tmp_path / "state.json"))
        assert replay["digest"]["root"] == maint_root
        assert vtaudit.hexd(srv.store.recompute_digest().root()) != maint_root
    finally:
        srv.stop()


# -- the audit's metric families (test_vtaudit.py:310-326) -------------------------


def test_audit_metrics_registered_and_monotonic():
    metrics.reset()
    jmetrics.reset()
    for reg in (metrics, jmetrics):
        c0 = reg.get_counter("volcano_audit_digest_checks_total")
        d0 = reg.get_counter("volcano_audit_divergence_total")
        reg.register_audit_check()
        reg.register_audit_divergence()
        reg.observe_beacon_lag(0.25)
        assert reg.get_counter("volcano_audit_digest_checks_total") == c0 + 1
        assert reg.get_counter("volcano_audit_divergence_total") == d0 + 1
    text, jtext = metrics.expose_text(), jmetrics.expose_text()
    for name in ("volcano_audit_digest_checks_total", "volcano_audit_divergence_total",
                 "volcano_audit_beacon_lag_seconds"):
        assert name in text
        assert [ln for ln in text.splitlines() if name in ln] == \
            [ln for ln in jtext.splitlines() if name in ln]
    metrics.reset()
    jmetrics.reset()


def test_audit_verify_survives_stale_watch_during_quiescence_peek():
    """The quiescence peek of ``audit_verify`` polls the wire, so it can fall
    off the server's log: it relists as ``drain`` does, reports not
    quiescent, and the next beacon-pinned check passes."""

    class _StaleQueue:
        def __bool__(self):
            raise StaleWatch("watch cursor fell off the server log")

        def clear(self):
            pass

    srv = StoreServer(shards=2).start()
    try:
        rs = RemoteStore(srv.url)
        _seed_cluster(rs.create, True)
        m = ArrayMirror(RemoteStore(srv.url), "volcano-tpu", "default")
        m.drain()
        with srv.lock:
            assert srv.stamp_beacon()
        m.drain()
        assert m.audit_verify()["ok"]
        relists = m.stale_relists
        stale = ("Pod", _StaleQueue())
        m._watches.insert(0, stale)
        assert m.audit_verify() is None
        assert m.stale_relists == relists + 1
        m._watches.remove(stale)
        rs.patch("Pod", "default/p1", {"node_name": "n1"})
        with srv.lock:
            assert srv.stamp_beacon()
        m.drain()
        res = m.audit_verify()
        assert res is not None and res["ok"], res
    finally:
        srv.stop()


def test_mirror_checkpoint_leaves_the_table_out_and_restore_rebuilds(tmp_path):
    """A checkpoint carries no digest table: the restore rebuilds it from the
    store, so a table poisoned before the save cannot mask drift."""
    import pickle

    st = Store()
    _seed_cluster(st.create, True)
    m = ArrayMirror(st, "volcano-tpu", "default")
    m.drain()
    m._audit.set_enc("Pod", "default/poison", {"meta": {"name": "poison"}})
    path = str(tmp_path / "mirror.ckpt")
    m.save_checkpoint(path)
    with open(path, "rb") as f:
        state = pickle.load(f)["state"]
    assert "_audit" not in state and "_audit_pending" not in state
    m2 = ArrayMirror(st, "volcano-tpu", "default")
    assert m2.try_restore_checkpoint(path)
    res = m2.audit_verify()
    assert res is not None and res["ok"], res


def test_checkpoint_restore_seeds_the_table_from_its_own_lists(tmp_path):
    """The armed restore lists every watched kind once: the delta relist's
    lists seed the digest table, as the full sync's do (over a RemoteStore
    a second list of every pod would cost as much as the first)."""
    from volcano_tpu_torch.scheduler.fastpath.mirror import WATCHED_KINDS

    st = Store()
    _seed_cluster(st.create, True)
    m = ArrayMirror(st, "volcano-tpu", "default")
    m.drain()
    path = str(tmp_path / "mirror.ckpt")
    m.save_checkpoint(path)
    listed = []
    real = st.list
    st.list = lambda kind: listed.append(kind) or real(kind)
    m2 = ArrayMirror(st, "volcano-tpu", "default")
    assert m2.try_restore_checkpoint(path)
    assert sorted(listed) == sorted(WATCHED_KINDS), listed
    res = m2.audit_verify()
    assert res is not None and res["ok"], res
