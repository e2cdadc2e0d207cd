"""The port's partitioned store bus (``store/partition.py`` and
``StoreServer(shards=N)``) against the JAX package's.

Each of the first cases mirrors one of ``tests/test_partitioned_store.py``
(its line named), run on the port's objects, server and client, and held
to the JAX function or a JAX server where an output can be compared: the
shard hash and the WAL routing equal over many namespaces and every record
shape, the split's sub-segments equal to JAX's byte for byte, the
partitioned watch stream byte for byte the one-shard one's and the JAX
partitioned server's, the zero-loss kill, the per-shard floors, the kill
storm, the leftover-tail absorb, the independent group commit, the
shard-count change, the untagged segment and the applier's split ship with
its ``shardNN_s`` attribution.  The sixteenth JAX case (``:513``, the
per-shard digest in ``/healthz``) waits for the digest audit (ROADMAP item
11b part 2).

Then what reaches across the packages: either package's client against
the other's 4-shard server (shard-tagged segment ops, ``/watch?shard=``,
the applier's split ship); either package's server booting from the
other's partitioned WAL directory; and the port Scheduler over a spawned
4-shard port apiserver against the JAX Scheduler over a spawned 4-shard
JAX apiserver, cycle by cycle (``tests/test_torch_remote_cycle.py``'s
pattern).  Then the re-ship of one sub-segment (nothing lands twice) and
concurrent sub-segment ships beside held bulks (the shard lock before the
server lock).  The JAX servers here run with ``VOLCANO_TPU_AUDIT=0``: their
digest beacons wait for part 2 in the port's client.

Every server listens on port 0 and keeps its state under ``tmp_path``.
Tolerance: exact everywhere.
"""

import json
import os
import sys
import threading
import time

import pytest
import torch

from volcano_tpu.api import objects as japi_objects
from volcano_tpu.store import partition as jpartition
from volcano_tpu.store.client import RemoteStore as JRemoteStore
from volcano_tpu.store.segment import DecisionSegment as JSegment
from volcano_tpu.store.server import StoreServer as JStoreServer
from volcano_tpu_torch.api import objects as api_objects
from volcano_tpu_torch.api.objects import Metadata, Queue
from volcano_tpu_torch.scheduler.cache import SchedulerCache
from volcano_tpu_torch.store.client import RemoteStore
from volcano_tpu_torch.store.partition import (
    ShardedWAL,
    leftover_shard_dirs,
    shard_of,
    shard_of_key,
    shard_wal_dir,
    split_segment,
    wal_shard,
)
from volcano_tpu_torch.store.segment import DecisionSegment
from volcano_tpu_torch.store.server import StoreServer

from helpers import build_pod as jbuild_pod
from test_torch_store_server import pod

torch.set_num_threads(1)

NSHARDS = 4

#: namespaces spread across every shard (asserted below)
_NAMESPACES = [f"team{i}" for i in range(8)]


@pytest.fixture(autouse=True)
def _op_determined_seqs(monkeypatch):
    """The digest beacons take seqs on a wall-clock cadence (1 s by
    default), so a slow run would slip one in where these cases expect
    only their own writes: the cadence is pinned past each case, as
    ``tests/test_procmesh.py:118`` does.  The digest stays armed;
    ``stamp_beacon`` still stamps one on demand."""
    monkeypatch.setenv("VOLCANO_TPU_AUDIT_BEACON_S", "3600")


def _seed_pods(create, n, namespaces=_NAMESPACES, build=pod):
    for i in range(n):
        create("Pod", build(f"p{i}", namespace=namespaces[i % len(namespaces)]))


def _mixed_rows(n=24, n_evict=4):
    bind_keys, bind_nodes, table = [], [], ["n0", "n1", "n2"]
    for i in range(n):
        bind_keys.append(f"{_NAMESPACES[i % len(_NAMESPACES)]}/p{i}")
        bind_nodes.append(i % len(table))
    evicts = [(f"{_NAMESPACES[i % len(_NAMESPACES)]}/p{n + i}", "preempt")
              for i in range(n_evict)]
    return bind_keys, bind_nodes, table, evicts


def _mixed_segment(n=24, n_evict=4, cls=DecisionSegment):
    """One cycle-shaped segment whose rows span every shard."""
    return cls.build(*_mixed_rows(n, n_evict))


def _freeze(monkeypatch):
    for objects in (japi_objects, api_objects):
        monkeypatch.setattr(objects, "_uid_token", "t0")
        monkeypatch.setattr(objects, "_uid_next", 1000)
    monkeypatch.setattr(time, "time", lambda: 1234.5)


# -- the hash and the split (test_partitioned_store.py:72-133) -------------------------


def test_shard_of_is_stable_and_covers_all_shards():
    """:72, and every hash equal to JAX's over many namespaces and counts."""
    assert shard_of("team0", 4) == shard_of("team0", 4)
    assert shard_of_key("team0/p1", 4) == shard_of("team0", 4)
    assert shard_of_key("/cluster-scoped", 4) == shard_of("", 4)
    assert shard_of("anything", 1) == 0
    assert {shard_of(ns, NSHARDS) for ns in _NAMESPACES} == set(range(NSHARDS))
    names = [f"ns-{i}" for i in range(500)] + ["", "default", "kube-system", "ünïcode"]
    for n in (1, 2, 3, 4, 7, 16):
        assert [shard_of(ns, n) for ns in names] == [jpartition.shard_of(ns, n) for ns in names]
        keys = [f"{ns}/obj{i}" for i, ns in enumerate(names)]
        assert ([shard_of_key(k, n) for k in keys]
                == [jpartition.shard_of_key(k, n) for k in keys])
    assert shard_wal_dir("/w", 3) == jpartition.shard_wal_dir("/w", 3)


def test_split_segment_is_a_partition_preserving_order(monkeypatch):
    """:86, and each sub-segment's wire bytes equal to JAX's split of the
    same rows (node tables and reserved uid blocks included)."""
    _freeze(monkeypatch)
    seg = _mixed_segment(n=24, n_evict=4)
    subs = split_segment(seg, NSHARDS)
    assert {s for s, _ in subs} <= set(range(NSHARDS))
    all_binds, all_evicts = [], []
    for shard, sub in subs:
        for k in sub.bind_keys + sub.evict_keys:
            assert shard_of_key(k, NSHARDS) == shard
        assert set(sub.node_table) == set(sub.bind_hosts)
        all_binds.extend(zip(sub.bind_keys, sub.bind_hosts))
        all_evicts.extend(sub.evict_pairs())
        assert len(sub.bind_keys) + len(sub.evict_keys) >= 1
    assert sorted(all_binds) == sorted(zip(seg.bind_keys, seg.bind_hosts))
    assert sorted(all_evicts) == sorted(seg.evict_pairs())
    orig = {k: i for i, k in enumerate(seg.bind_keys)}
    for _, sub in subs:
        idxs = [orig[k] for k in sub.bind_keys]
        assert idxs == sorted(idxs)
    assert split_segment(seg, 1) == [(0, seg)]
    # the JAX split of the same rows from the same uid counter
    for objects in (japi_objects, api_objects):
        monkeypatch.setattr(objects, "_uid_next", 5000)
    mine = [(s, json.dumps(sub.to_wire())) for s, sub in split_segment(seg, NSHARDS)]
    jseg = JSegment.build(*_mixed_rows(24, 4))
    monkeypatch.setattr(japi_objects, "_uid_next", 5000)
    theirs = [(s, json.dumps(sub.to_wire())) for s, sub in jpartition.split_segment(jseg, NSHARDS)]
    assert mine == theirs
    # a node table in first-reference order, several reserved blocks
    assert len({json.loads(w)["events"]["start"] for _, w in mine}) == len(mine) > 1


def test_wal_shard_routes_every_record_shape():
    """:115, and equal to JAX's on every record shape at several counts."""
    assert wal_shard({"op": "segment", "shard": 3}, 4) == 3
    assert wal_shard({"op": "patch", "kind": "Pod", "key": "team0/p0"}, 4) == shard_of("team0", 4)
    assert wal_shard({"op": "patch_col", "kind": "Pod", "keys": ["team1/p0", "team1/p1"]},
                     4) == shard_of("team1", 4)
    assert wal_shard({"op": "create", "kind": "Pod",
                      "object": {"meta": {"namespace": "team2", "name": "x"}}},
                     4) == shard_of("team2", 4)
    assert wal_shard({"op": "delete", "kind": "Node", "key": "/n0"}, 1) == 0
    recs = [{"op": "segment", "shard": 6}, {"op": "segment"},
            {"op": "patch", "key": "team5/p"}, {"op": "delete", "key": "/n3"},
            {"op": "patch_col", "keys": ["team7/a", "team0/b"]}, {"op": "patch_col", "keys": []},
            {"op": "create", "object": {"meta": {"namespace": "team3"}}},
            {"op": "update", "object": {"meta": {}}}, {"op": "create", "object": "x"}, {}]
    for n in (1, 2, 4, 5):
        assert [wal_shard(r, n) for r in recs] == [jpartition.wal_shard(r, n) for r in recs]


# -- the watch stream (:134-216) --------------------------------------------------------


def _run_stream(monkeypatch, make_server, build, Segment, split, shards):
    """The same sub-segment sequence (uids and clock frozen) through a fresh
    server; (server, its whole stream)."""
    _freeze(monkeypatch)
    srv = make_server(shards=shards).start()
    _seed_pods(srv.store.create, 32, build=build)
    with srv.lock:
        srv._pump_log()  # the seeds' events drain with fixed seqs
    seg = _mixed_segment(n=24, n_evict=4, cls=Segment)
    for shard, sub in split(seg, NSHARDS):
        # one after the other, in shard order: both servers see one sequence
        res = srv._apply_segment(dict(sub.to_wire(), shard=shard))
        assert not res["binds"] and not res["evicts"]
    return srv, srv.watch_since(0, set(), 0)["events"]


def test_partitioned_watch_stream_byte_identical_to_single_shard(monkeypatch):
    """:159, and the JAX 4-shard server's stream and slices byte for byte."""
    srv1, stream1 = _run_stream(monkeypatch, StoreServer, pod, DecisionSegment, split_segment, 1)
    srvN, streamN = _run_stream(monkeypatch, StoreServer, pod, DecisionSegment, split_segment,
                                NSHARDS)
    srvJ, streamJ = _run_stream(monkeypatch, JStoreServer, jbuild_pod, JSegment,
                                jpartition.split_segment, NSHARDS)
    try:
        assert json.dumps(streamN) == json.dumps(stream1)
        assert json.dumps(streamN) == json.dumps(streamJ)

        def shard_of_event(e):
            # a segment's Event is cluster-scoped but rides its pod's shard
            if e["kind"] == "Event":
                return shard_of_key(e["object"]["involved"][1], NSHARDS)
            return shard_of(e["object"]["meta"].get("namespace") or "", NSHARDS)

        covered = 0
        for s in range(NSHARDS):
            slice_s = srvN.watch_since(0, set(), 0, shard=s)["events"]
            expect = [e for e in stream1 if shard_of_event(e) == s]
            assert json.dumps(slice_s) == json.dumps(expect), f"shard {s}"
            assert json.dumps(slice_s) == json.dumps(
                srvJ.watch_since(0, set(), 0, shard=s)["events"]), f"shard {s}"
            covered += len(slice_s)
        assert covered == len(stream1)
        assert srvN._shard_seq == srvJ._shard_seq
    finally:
        for srv in (srv1, srvN, srvJ):
            srv.stop()


def test_shard_scoped_remote_watcher_sees_only_its_namespaces():
    """:189."""
    srv = StoreServer(shards=NSHARDS).start()
    try:
        rs = RemoteStore(srv.url)
        _seed_pods(rs.create, 8)
        target = shard_of("team0", NSHARDS)
        watcher = RemoteStore(srv.url, shard=target)
        q = watcher.watch("Pod")
        seg = _mixed_segment(n=8, n_evict=0)
        for shard, sub in split_segment(seg, NSHARDS):
            rs.apply_segment(sub, shard=shard)
        watcher.poll()
        got = []
        while q:
            got.append(q.popleft())
        assert got, "the shard's watcher saw nothing"
        assert all(shard_of(e.obj.meta.namespace, NSHARDS) == target for e in got)
        assert len(got) == sum(1 for k in seg.bind_keys if shard_of_key(k, NSHARDS) == target)
    finally:
        srv.stop()


# -- the applier's split ship (:220-275, :458-483) ------------------------------------


def _applier_ship(url, seg, make_cache=None):
    cache = (make_cache or (lambda rs: SchedulerCache(rs, async_apply=True)))(RemoteStore(url))
    try:
        cache.publish_segment(seg)
        assert cache.applier.flush(timeout=30.0)
        assert cache.err_log == []
        return dict(cache.applier.drain_stats)
    finally:
        cache.applier.stop(flush=False)


def test_applier_splits_and_ships_concurrently_with_attribution():
    """:220."""
    srv = StoreServer(shards=NSHARDS).start()
    try:
        rs = RemoteStore(srv.url)
        rs.create("Queue", Queue(meta=Metadata(name="default", namespace="")))
        _seed_pods(rs.create, 32)
        assert rs.segment_shards == NSHARDS
        seg = _mixed_segment(n=24, n_evict=4)
        stats = _applier_ship(srv.url, seg)
        for i, key in enumerate(seg.bind_keys):
            assert rs.get("Pod", key).node_name == seg.bind_hosts[i]
        for key in seg.evict_keys:
            assert rs.get("Pod", key).deleting is True
        assert len(rs.list("Event")) == len(seg.bind_keys) + len(seg.evict_keys)
        shard_keys = {k for k in stats if k.startswith("shard")}
        assert shard_keys == {f"shard{s:02d}_s" for s, _ in split_segment(seg, NSHARDS)}
        assert stats["split_s"] > 0 and stats["ship_s"] > 0
    finally:
        srv.stop()


def test_unsharded_server_keeps_single_segment_path():
    """:252."""
    srv = StoreServer().start()
    try:
        rs = RemoteStore(srv.url)
        _seed_pods(rs.create, 8)
        assert rs.segment_shards == 1
        stats = _applier_ship(srv.url, _mixed_segment(n=8, n_evict=0))
        assert not any(k.startswith("shard") for k in stats)
        assert stats["split_s"] == 0.0 and stats["ship_s"] == 0.0
    finally:
        srv.stop()


def test_sharded_fanout_wire_attribution_not_inflated():
    """:483."""
    srv = StoreServer(shards=NSHARDS).start()
    try:
        rs = RemoteStore(srv.url)
        _seed_pods(rs.create, 32)
        t0 = time.perf_counter()
        stats = _applier_ship(srv.url, _mixed_segment(n=24, n_evict=0))
        wall = time.perf_counter() - t0
        assert stats["wire_s"] <= wall + 0.05, (stats["wire_s"], wall)
        assert stats["ship_s"] <= wall
    finally:
        srv.stop()


# -- the zero-acked-loss gate on the partitioned WAL (:281-455) ----------------------


def _boot(tmp_path, shards, port=0, cls=StoreServer):
    return cls(state_path=str(tmp_path / "state.json"), wal=True, shards=shards,
               save_interval=3600, port=port).start()


def test_partitioned_wal_zero_acked_loss_after_kill(tmp_path):
    """:288."""
    srv = _boot(tmp_path, NSHARDS)
    rs = RemoteStore(srv.url)
    _seed_pods(rs.create, 32)
    subs = split_segment(_mixed_segment(n=24, n_evict=4), NSHARDS)
    for shard, sub in subs:
        res = rs.apply_segment(sub, shard=shard)
        assert not res["binds"] and not res["evicts"]
    assert len(leftover_shard_dirs(str(tmp_path / "state.json.wal"))) == NSHARDS
    stats = srv.wal.stats()
    assert stats["shards"] == NSHARDS
    for shard, _ in subs:
        assert stats["per_shard"][shard]["records"] >= 1
    acked = {p.meta.key: (p.node_name, p.deleting, p.meta.resource_version)
             for p in rs.list("Pod")}
    acked_events = {e.meta.name for e in rs.list("Event")}
    seq, rv = srv.seq, srv.store._rv
    srv.kill()
    srv2 = _boot(tmp_path, NSHARDS, port=srv.port)
    try:
        rs2 = RemoteStore(srv2.url)
        assert {p.meta.key: (p.node_name, p.deleting, p.meta.resource_version)
                for p in rs2.list("Pod")} == acked
        assert {e.meta.name for e in rs2.list("Event")} == acked_events
        assert srv2.seq == seq and srv2.store._rv == rv
    finally:
        srv2.stop()


def test_partitioned_wal_checkpoint_carries_per_shard_floors(tmp_path):
    """:327."""
    srv = _boot(tmp_path, NSHARDS)
    try:
        rs = RemoteStore(srv.url)
        _seed_pods(rs.create, 8)
        for shard, sub in split_segment(_mixed_segment(n=8, n_evict=0), NSHARDS):
            rs.apply_segment(sub, shard=shard)
        srv.flush_state(force=True)
        with open(tmp_path / "state.json") as f:
            floors = json.load(f)["wal_floor"]
        assert isinstance(floors, list) and len(floors) == NSHARDS
        assert all(isinstance(f, int) and f >= 2 for f in floors)
    finally:
        srv.stop()


def test_partitioned_crash_kill_storm_keeps_gate_green(tmp_path):
    """:345."""
    srv = _boot(tmp_path, NSHARDS)
    port = srv.port
    rs = RemoteStore(srv.url)
    _seed_pods(rs.create, 40)
    expect = {p.meta.key: "" for p in rs.list("Pod")}
    for round_ in range(3):
        seg = DecisionSegment.build(
            [f"{_NAMESPACES[(round_ * 5 + i) % len(_NAMESPACES)]}/p{(round_ * 5 + i) % 40}"
             for i in range(5)], [0] * 5, [f"n{round_}"])
        for shard, sub in split_segment(seg, NSHARDS):
            assert not rs.apply_segment(sub, shard=shard)["binds"]
        expect.update(zip(seg.bind_keys, seg.bind_hosts))
        srv.kill()
        srv = _boot(tmp_path, NSHARDS, port=port)
        rs = RemoteStore(srv.url)
        assert {p.meta.key: p.node_name for p in rs.list("Pod")} == expect, f"round {round_}"
    srv.stop()


def test_wal_off_boot_absorbs_partitioned_leftover_tail(tmp_path):
    """:378."""
    srv = _boot(tmp_path, NSHARDS)
    rs = RemoteStore(srv.url)
    _seed_pods(rs.create, 16)
    for shard, sub in split_segment(_mixed_segment(n=12, n_evict=0), NSHARDS):
        rs.apply_segment(sub, shard=shard)
    acked = {p.meta.key: p.node_name for p in rs.list("Pod")}
    srv.kill()
    srv2 = StoreServer(state_path=str(tmp_path / "state.json"), save_interval=3600,
                       port=srv.port).start()
    try:
        assert {p.meta.key: p.node_name for p in RemoteStore(srv2.url).list("Pod")} == acked
        for d in leftover_shard_dirs(str(tmp_path / "state.json.wal")):
            assert [n for n in os.listdir(d) if n.endswith(".wal")] == []
    finally:
        srv2.stop()


def test_sharded_wal_independent_group_commit(tmp_path):
    """:403, and the JAX ShardedWAL replays the port's directory alike."""
    wal = ShardedWAL(str(tmp_path / "w"), 4)
    wal.append({"op": "patch", "kind": "Pod", "key": "team0/p0", "fields": {}, "seq": 1})
    wal.append({"op": "patch", "kind": "Pod", "key": "team1/p0", "fields": {}, "seq": 2})
    wal.commit()
    stats = wal.stats()
    assert stats["records"] == 2
    touched = [p for p in stats["per_shard"] if p["records"]]
    assert len(touched) == 2 and all(p["fsync_total"] == 1 for p in touched)
    assert all(p["fsync_total"] == 0 for p in stats["per_shard"] if not p["records"])
    wal.sync_close()
    wal2 = ShardedWAL(str(tmp_path / "w"), 4)
    assert [rec["seq"] for rec in wal2.replay([0, 0, 0, 0])] == [1, 2]
    wal2.sync_close()
    jwal = jpartition.ShardedWAL(str(tmp_path / "w"), 4)
    assert [rec["seq"] for rec in jwal.replay([0, 0, 0, 0])] == [1, 2]
    jwal.sync_close()


@pytest.mark.parametrize("old_shards,new_shards", [(4, 1), (1, 4), (4, 2)])
def test_shard_count_change_across_kill_keeps_acked_records(tmp_path, old_shards, new_shards):
    """:429."""
    srv = _boot(tmp_path, old_shards)
    rs = RemoteStore(srv.url)
    _seed_pods(rs.create, 16)
    for shard, sub in split_segment(_mixed_segment(n=12, n_evict=0), old_shards):
        assert not rs.apply_segment(sub, shard=shard)["binds"]
    acked = {p.meta.key: p.node_name for p in rs.list("Pod")}
    srv.kill()
    srv2 = _boot(tmp_path, new_shards, port=srv.port)
    try:
        after = {p.meta.key: p.node_name for p in RemoteStore(srv2.url).list("Pod")}
        assert after == acked, f"{old_shards}->{new_shards} lost acknowledged state"
        # killed again with no traffic: the absorbed tail was made durable
        # before the other layout's segments went
        srv2.kill()
        srv3 = _boot(tmp_path, new_shards, port=srv.port)
        try:
            assert {p.meta.key: p.node_name
                    for p in RemoteStore(srv3.url).list("Pod")} == acked
        finally:
            srv3.stop()
    finally:
        if not srv2._killed:
            srv2.stop()


def test_untagged_segment_reaches_every_shard_watcher():
    """:466."""
    srv = StoreServer(shards=NSHARDS).start()
    try:
        rs = RemoteStore(srv.url)
        _seed_pods(rs.create, 8)
        watchers = []
        for s in range(NSHARDS):
            w = RemoteStore(srv.url, shard=s)
            watchers.append((s, w, w.watch("Pod")))
        seg = _mixed_segment(n=8, n_evict=0)
        rs.apply_segment(seg)  # the whole segment, no shard tag
        for s, w, q in watchers:
            w.poll()
            got = []
            while q:
                got.append(q.popleft().obj.meta.key)
            assert got == seg.bind_keys, f"shard {s}'s watcher missed rows"
        assert srv._shard_seq == [srv.seq] * NSHARDS
    finally:
        srv.stop()


# -- across the packages ------------------------------------------------------------------


@pytest.mark.parametrize("direction", ["jax-client-port-server", "port-client-jax-server"])
def test_cross_package_client_against_partitioned_server(direction):
    """The other package's client against a 4-shard server: its shard count
    from /healthz, shard-tagged segment ops, a shard watcher's slice, the
    applier's split ship with its shardNN_s keys, and every object read
    back through both clients equal."""
    if direction == "jax-client-port-server":
        srv, Client, Segment, build = StoreServer(shards=NSHARDS).start(), JRemoteStore, \
            JSegment, jbuild_pod
        split = jpartition.split_segment
        from volcano_tpu.scheduler.cache import SchedulerCache as Cache
    else:
        srv, Client, Segment, build = JStoreServer(shards=NSHARDS).start(), RemoteStore, \
            DecisionSegment, pod
        split, Cache = split_segment, SchedulerCache
    try:
        rs = Client(srv.url)
        _seed_pods(rs.create, 40, build=build)
        assert rs.segment_shards == NSHARDS
        target = shard_of("team1", NSHARDS)
        watcher = Client(srv.url, shard=target)
        q = watcher.watch("Pod")
        seg = Segment.build(*_mixed_rows(n=16, n_evict=2))
        for shard, sub in split(seg, NSHARDS):
            res = rs.apply_segment(sub, shard=shard)
            assert not res["binds"] and not res["evicts"]
        got = []
        while q:
            got.append(q.popleft().obj.meta.key)
        keys = seg.bind_keys + seg.evict_keys
        assert got == [k for k in keys if shard_of_key(k, NSHARDS) == target]
        seg2 = Segment.build([f"{_NAMESPACES[(20 + i) % 8]}/p{20 + i}" for i in range(16)],
                             [i % 2 for i in range(16)], ["n5", "n6"])
        cache = Cache(Client(srv.url), async_apply=True)
        try:
            cache.publish_segment(seg2)
            assert cache.applier.flush(timeout=30.0)
            assert cache.err_log == []
            assert {k for k in cache.applier.drain_stats if k.startswith("shard")} == {
                f"shard{s:02d}_s" for s, _ in split(seg2, NSHARDS)}
        finally:
            cache.applier.stop(flush=False)
        pods = {p.meta.key: (p.node_name, p.deleting) for p in rs.list("Pod")}
        other = RemoteStore if Client is JRemoteStore else JRemoteStore
        assert {p.meta.key: (p.node_name, p.deleting) for p in other(srv.url).list("Pod")} == pods
        for i, k in enumerate(seg.bind_keys):
            assert pods[k][0] == seg.bind_hosts[i]
        for i, k in enumerate(seg2.bind_keys):
            assert pods[k][0] == seg2.bind_hosts[i]
        assert all(pods[k][1] for k in seg.evict_keys)
        assert len(rs.list("Event")) == 16 + 2 + 16
    finally:
        srv.stop()


def _state_of(rs):
    from volcano_tpu_torch.store.codec import encode

    return {(kind, o.meta.key): json.dumps(encode(o), sort_keys=True)
            for kind in ("Pod", "Event") for o in rs.list(kind)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_servers_boot_from_each_others_partitioned_wal(tmp_path, writer):
    """One package's 4-shard server acknowledges sub-segments into four WAL
    directories and is killed with no flush; the other package's 4-shard
    server boots from that directory with every acknowledged record (the
    seq and rv lines continued), then the first package's boots from what
    the second checkpointed."""
    first, other = (JStoreServer, StoreServer) if writer == "jax" else (StoreServer, JStoreServer)
    Client, Segment, build, split = (
        (JRemoteStore, JSegment, jbuild_pod, jpartition.split_segment) if writer == "jax"
        else (RemoteStore, DecisionSegment, pod, split_segment))
    srv = _boot(tmp_path, NSHARDS, cls=first)
    rs = Client(srv.url)
    _seed_pods(rs.create, 32, build=build)
    for shard, sub in split(Segment.build(*_mixed_rows(24, 4)), NSHARDS):
        assert not rs.apply_segment(sub, shard=shard)["binds"]
    rs.patch("Pod", "team6/p30", {"node_name": "n9"})
    rs.delete("Pod", "team7/p31")
    before = _state_of(RemoteStore(srv.url))
    seq, rv = srv.seq, srv.store._rv
    srv.kill()
    srv2 = _boot(tmp_path, NSHARDS, port=srv.port, cls=other)
    try:
        assert srv2.wal.stats()["replayed_records"] > 0
        assert _state_of(RemoteStore(srv2.url)) == before
        assert (srv2.seq, srv2.store._rv) == (seq, rv)
    finally:
        srv2.stop()
    srv3 = _boot(tmp_path, NSHARDS, port=srv.port, cls=first)
    try:
        assert _state_of(RemoteStore(srv3.url)) == before
    finally:
        srv3.stop()


def _spread_store(spec):
    """The JAX store of a ``cfg5_shaped_spec`` with gang j (its PodGroup and
    pods) in namespace ``team{j % 8}``: the segments span every shard."""
    from volcano_tpu.api import POD_GROUP_KEY, Resource
    from volcano_tpu.api import objects as jobj
    from volcano_tpu.api.types import PodGroupPhase
    from volcano_tpu.store import Store as JStore

    ns_of = {g["name"]: _NAMESPACES[j % 8] for j, g in enumerate(spec["podgroups"])}
    store = JStore()
    for q in spec["queues"]:
        store.create("Queue", jobj.Queue(meta=jobj.Metadata(name=q["name"], namespace=""),
                                         weight=q["weight"]))
    for n in spec["nodes"]:
        store.create("Node", jobj.Node(meta=jobj.Metadata(name=n["name"], namespace=""),
                                       allocatable=Resource.from_resource_list(n["allocatable"])))
    for g in spec["podgroups"]:
        pg = jobj.PodGroup(meta=jobj.Metadata(name=g["name"], namespace=ns_of[g["name"]]),
                           min_member=g["min_member"], queue=g["queue"])
        pg.status.phase = PodGroupPhase(g["phase"])
        store.create("PodGroup", pg)
    for p in spec["pods"]:
        store.create("Pod", jobj.Pod(
            meta=jobj.Metadata(name=p["name"], namespace=ns_of[p["group"]],
                               annotations={POD_GROUP_KEY: p["group"]}),
            spec=jobj.PodSpec(resources=Resource.from_resource_list(p["resources"]))))
    return store


_JAX_SHARDED_SERVER = (
    "import sys\n"
    "from volcano_tpu.store.server import StoreServer\n"
    f"srv = StoreServer(shards={NSHARDS}).start()\n"
    "print('apiserver listening on ' + srv.url, flush=True)\n"
    "sys.stdin.read()\n"  # serve until the parent closes the pipe
    "srv.stop()\n"
)


def test_remote_cycles_over_partitioned_servers_equal_jax():
    """The port Scheduler over a spawned 4-shard port apiserver against the
    JAX Scheduler over a spawned 4-shard JAX apiserver, three cycles under
    the applier (each splitting its segment over the four shards): equal
    binds, PodGroup statuses, pods and Events (by content) after every
    cycle, and both appliers' shardNN_s keys equal."""
    from test_torch_remote_cycle import FLUSH_S, _complete, _load, _outcome, _Spawned
    from test_torch_cycle import cfg5_shaped_spec
    from test_torch_object import port_store
    from volcano_tpu.scheduler import conf as jconf
    from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
    from volcano_tpu_torch.scheduler import conf as tconf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    tsrv = _Spawned([sys.executable, "-m", "volcano_tpu_torch.store.server", "--port", "0",
                     "--no-default-queue", "--shards", str(NSHARDS)])
    try:
        jsrv = _Spawned([sys.executable, "-c", _JAX_SHARDED_SERVER])
    except Exception:
        tsrv.close()
        raise
    jsched = tsched = None
    try:
        spec = cfg5_shaped_spec(n_nodes=64, n_jobs=40, tasks_per_job=20, best_effort=10)
        for n in spec["nodes"]:  # fewer cores than the gangs ask: some wait
            n["allocatable"]["cpu"] = "4"
        jlocal = _spread_store(spec)
        jremote, tremote = JRemoteStore(jsrv.url), RemoteStore(tsrv.url)
        _load(jremote, jlocal)
        _load(tremote, port_store(jlocal))
        assert jremote.segment_shards == tremote.segment_shards == NSHARDS
        jc = jconf.full_conf("tpu")
        jc.exact_topk = True
        jc.apply_mode = "async"
        tc = tconf.full_conf("cpu")
        tc.apply_mode = "async"
        jsched, tsched = JScheduler(jremote, conf=jc), Scheduler(tremote, conf=tc)
        since = 0
        per_cycle = []
        for cycle in range(3):
            jsched.run_once()
            tsched.run_once()
            assert jsched.cache.applier.flush(FLUSH_S) and tsched.cache.applier.flush(FLUSH_S)
            assert tsched.last_path == "fast"
            want = _outcome(JRemoteStore(jsrv.url), jsched, since)
            got = _outcome(RemoteStore(tsrv.url), tsched, since)
            for key in ("binds", "groups", "events", "pods", "errs"):
                assert got[key] == want[key], (cycle, key)
            jkeys = {k for k in jsched.cache.applier.drain_stats if k.startswith("shard")}
            tkeys = {k for k in tsched.cache.applier.drain_stats if k.startswith("shard")}
            assert tkeys == jkeys and len(tkeys) > 1, (cycle, tkeys, jkeys)
            per_cycle.append(len(got["binds"]))
            since = len(tsched.cache.bind_log)
            done = sorted({k.split("/")[1].split("-")[0] for k, _ in got["binds"]
                           if not k.split("/")[1].startswith("be")})[:4]
            _complete(jremote, done)
            _complete(tremote, done)
        assert all(per_cycle), per_cycle
    finally:
        if jsched is not None:
            jsched.cache.applier.stop()
        if tsched is not None:
            tsched.close()
        tsrv.close()
        jsrv.close()


# -- the re-ship and the lock order ---------------------------------------------------------


def test_reshipped_sub_segment_lands_nothing_twice():
    """A re-ship of one sub-segment (the applier's answer to a cut reply)
    dedupes on that sub-segment's reserved uid block: no second Event, no
    second log row; a sibling sub-segment of the same split still lands."""
    srv = StoreServer(shards=NSHARDS).start()
    try:
        rs = RemoteStore(srv.url)
        _seed_pods(rs.create, 32)
        subs = split_segment(_mixed_segment(n=24, n_evict=4), NSHARDS)
        (s0, first), rest = subs[0], subs[1:]
        rs.apply_segment(first, shard=s0)
        seq, events = srv.seq, len(rs.list("Event"))
        res = rs.apply_segment(first, shard=s0)
        assert not res["binds"] and not res["evicts"]
        assert len(rs.list("Event")) == events
        rows = srv.watch_since(seq, set(), 0)["events"]
        assert [e for e in rows if e["kind"] == "Event"] == []
        for shard, sub in rest:
            rs.apply_segment(sub, shard=shard)
        assert len(rs.list("Event")) == 24 + 4
    finally:
        srv.stop()


def test_concurrent_sub_segment_ships_beside_held_bulks_do_not_deadlock():
    """Four threads ship sub-segments (the shard lock, then the server lock)
    while two threads send multi-op bulks with a segment inside (the server
    lock held, the shard lock skipped); every ship lands, in time."""
    srv = StoreServer(shards=NSHARDS).start()
    try:
        rs = RemoteStore(srv.url)
        _seed_pods(rs.create, 400)
        errors = []

        def shipper(k):
            try:
                c = RemoteStore(srv.url)
                for r in range(10):
                    keys = [f"{_NAMESPACES[i % 8]}/p{i}" for i in range(k * 100, k * 100 + 100)
                            if i % 10 == r]
                    seg = DecisionSegment.build(keys, [0] * len(keys), [f"n{r}"])
                    for shard, sub in split_segment(seg, NSHARDS):
                        assert not c.apply_segment(sub, shard=shard)["binds"]
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        def bulker(k):
            try:
                c = RemoteStore(srv.url)
                for r in range(10):
                    # p{8r} lives in team0
                    seg = DecisionSegment.build([f"team0/p{r * 8}"], [0], ["nb"])
                    op = dict(seg.to_wire(), shard=shard_of("team0", NSHARDS))
                    out = c._request("POST", "/bulk", {"ops": [
                        {"op": "patch", "kind": "Pod", "key": f"team{k}/p{k}",
                         "fields": {"hostname": f"h{r}"}}, op]})[1]
                    assert out["results"][0] is None
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=shipper, args=(k,)) for k in range(4)]
        threads += [threading.Thread(target=bulker, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads), "a ship is stuck"
        assert errors == []
        pods = {p.meta.key: p.node_name for p in rs.list("Pod")}
        assert all(pods[f"{_NAMESPACES[i % 8]}/p{i}"] for i in range(400))
    finally:
        srv.stop()


# -- the per-shard digest (test_partitioned_store.py:513) ---------------------------


def test_healthz_carries_per_shard_digest_and_seq(monkeypatch):
    """``/healthz`` serves the kept digest of each shard beside that shard's
    newest seq, the shards summing to the root, equal to ``/debug/digest``
    and to the JAX server's for the same writes; one more write in one
    namespace moves exactly its shard's digest and seq."""
    import urllib.request

    from volcano_tpu_torch import vtaudit

    def healthz(url):
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            return json.load(r)["digest"]

    _freeze(monkeypatch)
    jsrv = JStoreServer(shards=NSHARDS).start()
    try:
        _seed_pods(JRemoteStore(jsrv.url).create, 16, build=jbuild_pod)
        jdg = healthz(jsrv.url)
    finally:
        jsrv.stop()
    _freeze(monkeypatch)
    srv = StoreServer(shards=NSHARDS).start()
    try:
        rs = RemoteStore(srv.url)
        _seed_pods(rs.create, 16)
        dg = healthz(srv.url)
        assert dg == jdg
        assert dg["seq"] == srv.seq and len(dg["shards"]) == NSHARDS
        total = sum(int(s["digest"], 16) for s in dg["shards"]) % (1 << 64)
        assert vtaudit.hexd(total) == dg["root"]
        touched = {shard_of(ns, NSHARDS) for ns in _NAMESPACES}
        for s, entry in enumerate(dg["shards"]):
            assert entry["seq"] <= dg["seq"]
            if s in touched:
                assert entry["seq"] > 0
        with urllib.request.urlopen(srv.url + "/debug/digest", timeout=10) as r:
            dbg = json.load(r)
        assert dbg["root"] == dg["root"]
        assert dbg["shards"] == [e["digest"] for e in dg["shards"]]
        assert dbg["shard_seq"] == [e["seq"] for e in dg["shards"]]
        before = dg["shards"]
        rs.create("Pod", pod("extra", namespace=_NAMESPACES[0]))
        after = healthz(srv.url)["shards"]
        hot = shard_of(_NAMESPACES[0], NSHARDS)
        for s in range(NSHARDS):
            if s == hot:
                assert after[s]["digest"] != before[s]["digest"]
                assert after[s]["seq"] > before[s]["seq"]
            else:
                assert after[s] == before[s]
    finally:
        srv.stop()
