"""The port's write-ahead log (``store/wal.py``) and the apiserver's
durability, against the JAX package's gate for its own.

Each case mirrors one of ``tests/test_crash_recovery.py`` (its line named):
the WAL primitives (CRC framing, torn tails, group commit, the checkpoint's
rotation and truncation), zero acknowledged loss across a kill, segment
atomicity and the idempotent resubmit, the applier's one re-ship through a
connection cut, the mirror's relist after a restart, the WAL metrics and
the recovery span, the SIGTERM flush of the daemon entry, and the review
regressions (a failed fsync, the WAL-off absorb, the live segment, the
floor stamp).  The chaos and controller kill storms (``:830-1011``) wait
for ROADMAP items 12 and 13, the digest corruption drill (``:1124``) for
item 11b: here a flipped byte is found by its record's CRC and localized
to that record.  Then both packages' servers boot from the state file and
WAL the other wrote, with equal objects.

No case kills a process with SIGKILL storms or asserts a wall-clock time;
servers listen on port 0, state lives under ``tmp_path``.
"""

import glob
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from volcano_tpu_torch import trace
from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.store.client import RemoteStore, wait_healthy
from volcano_tpu_torch.store.codec import encode
from volcano_tpu_torch.store.segment import DecisionSegment
from volcano_tpu_torch.store.server import StoreServer
from volcano_tpu_torch.store.wal import WriteAheadLog, frame_record, read_records

from test_torch_store_server import node, pod, podgroup, queue

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _op_determined_seqs(monkeypatch):
    """The digest beacons take seqs on a wall-clock cadence (1 s by
    default), so a slow run would slip one in where these cases expect
    only their own writes: the cadence is pinned past each case, as
    ``tests/test_procmesh.py:118`` does.  The digest stays armed;
    ``stamp_beacon`` still stamps one on demand."""
    monkeypatch.setenv("VOLCANO_TPU_AUDIT_BEACON_S", "3600")


# -- the WAL primitives ----------------------------------------------------------


def test_wal_framing_roundtrip(tmp_path):
    """test_crash_recovery.py:61."""
    wal = WriteAheadLog(str(tmp_path / "wal"))
    recs = [{"op": "patch", "kind": "Pod", "key": f"/p{i}", "fields": {"node_name": f"n{i}"}}
            for i in range(10)]
    for r in recs:
        wal.append(r)
    wal.commit()
    wal.sync_close()
    wal2 = WriteAheadLog(str(tmp_path / "wal"))
    assert list(wal2.replay(0)) == recs
    assert wal2.torn_tails == 0
    wal2.sync_close()


def test_wal_frames_equal_jax(tmp_path):
    """A record's frame is the JAX package's byte for byte."""
    from volcano_tpu.store.wal import frame_record as jframe

    for rec in ({"i": 0}, {"op": "segment", "binds": {"keys": ["a/b"], "nodes": [0],
                                                      "node_table": ["n0"]}, "stamp": 1.5}):
        assert frame_record(rec) == jframe(rec)


def test_wal_torn_tail_truncated_and_crc_corrupt_discarded(tmp_path):
    """test_crash_recovery.py:75: a truncated record and a flipped byte are
    discarded with everything after them; nothing raises."""
    d = str(tmp_path / "wal")
    wal = WriteAheadLog(d)
    for i in range(5):
        wal.append({"i": i})
    wal.commit()
    wal.sync_close()
    seg = sorted(glob.glob(os.path.join(d, "*.wal")))[0]
    size = os.path.getsize(seg)
    with open(seg, "r+b") as f:
        f.truncate(size - 3)
    recs, torn = read_records(seg)
    assert torn and [r["i"] for r in recs] == [0, 1, 2, 3]
    rec_size = len(frame_record({"i": 0}))
    with open(seg, "r+b") as f:
        f.seek(4 * rec_size - 2)
        b = f.read(1)
        f.seek(4 * rec_size - 2)
        f.write(bytes([b[0] ^ 0xFF]))
    recs, torn = read_records(seg)
    assert torn and [r["i"] for r in recs] == [0, 1, 2]
    w2 = WriteAheadLog(d)
    assert [r["i"] for r in w2.replay(0)] == [0, 1, 2]
    assert w2.torn_tails == 1
    w2.sync_close()


@pytest.mark.parametrize("flip", [0, 3, 7])
def test_flipped_byte_found_and_localized(tmp_path, flip):
    """A byte flipped inside record ``flip`` of an acknowledged tail (the
    drill of test_crash_recovery.py:1124, at the WAL's level): its CRC finds
    it, replay stops exactly before that record, the segment counts one
    torn tail, and a server recovering from that directory shows exactly the
    records before it."""
    state = str(tmp_path / "state.json")
    srv = StoreServer(state_path=state, save_interval=3600, wal=True)
    for i in range(8):
        code, _ = srv.create("Queue", {"object": encode(queue(f"q{i}"))})
        assert code == 201
    srv._commit_ack()
    srv.kill()
    seg = sorted(glob.glob(state + ".wal/*.wal"))[-1]
    records, torn = read_records(seg)
    assert not torn and [r["object"]["meta"]["name"] for r in records] == [
        f"q{i}" for i in range(8)]
    offsets = []
    off = 0
    for r in records:
        offsets.append(off)
        off += len(frame_record(r))
    with open(seg, "r+b") as f:
        f.seek(offsets[flip] + 8 + 5)  # inside the record's payload
        b = f.read(1)
        f.seek(offsets[flip] + 8 + 5)
        f.write(bytes([b[0] ^ 0x01]))
    got, torn = read_records(seg)
    assert torn and len(got) == flip
    srv2 = StoreServer(state_path=state, save_interval=3600, wal=True)
    try:
        assert srv2.wal.torn_tails == 1 and srv2.wal.replayed_records == flip
        assert sorted(q.meta.name for q in srv2.store.list("Queue")) == [
            f"q{i}" for i in range(flip)]
    finally:
        srv2.kill()


def test_wal_torn_mid_log_segment_does_not_drop_later_segments(tmp_path):
    """test_crash_recovery.py:109."""
    d = str(tmp_path / "wal")
    a = WriteAheadLog(d)
    a.append({"life": "A", "i": 0})
    a.append({"life": "A", "i": 1})
    a.commit()
    a.kill()
    seg_a = sorted(glob.glob(os.path.join(d, "*.wal")))[0]
    with open(seg_a, "r+b") as f:
        f.truncate(os.path.getsize(seg_a) - 2)
    b = WriteAheadLog(d)
    assert [r.get("i") for r in b.replay(0)] == [0]
    b.append({"life": "B", "i": 2})
    b.commit()
    b.kill()
    c = WriteAheadLog(d)
    assert [(r["life"], r["i"]) for r in c.replay(0)] == [("A", 0), ("B", 2)]
    c.sync_close()


def test_wal_group_commit_amortizes_fsync(tmp_path):
    """test_crash_recovery.py:136."""
    wal = WriteAheadLog(str(tmp_path / "wal"))
    for i in range(100):
        wal.append({"i": i})
    wal.commit()
    assert wal.fsync_total == 1 and wal.appended_records == 100

    def worker(k):
        for i in range(20):
            wal.commit(wal.append({"w": k, "i": i}))

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wal.appended_records == 260
    assert wal.fsync_total < 1 + 160, wal.fsync_total
    wal.sync_close()
    w2 = WriteAheadLog(str(tmp_path / "wal"))
    assert sum(1 for _ in w2.replay(0)) == 260
    w2.sync_close()


def test_wal_checkpoint_rotates_and_drops_covered_segments(tmp_path):
    """test_crash_recovery.py:163."""
    state = str(tmp_path / "state.json")
    srv = StoreServer(state_path=state, save_interval=3600, wal=True)
    srv.store.create("Queue", queue("q"))
    srv.flush_state()
    data = json.load(open(state))
    assert data["wal_floor"] == 2 and data["rv"] == srv.store._rv
    assert srv.wal.segment_indices() == [2]
    srv.kill()
    srv2 = StoreServer(state_path=state, save_interval=3600, wal=True)
    assert srv2.store.get("Queue", "/q") is not None
    assert srv2.wal.replayed_records == 0
    srv2.kill()


# -- zero acknowledged loss and atomicity -------------------------------------------


def _boot(tmp_path, save_interval=3600):
    return StoreServer(state_path=str(tmp_path / "state.json"), save_interval=save_interval,
                       wal=True).start()


def test_acked_mutations_survive_kill_bit_for_bit(tmp_path):
    """test_crash_recovery.py:192: every 2xx-replied mutation, a whole
    decision segment among them, with the rvs the client saw."""
    srv = _boot(tmp_path)
    rs = RemoteStore(srv.url)
    rs.create("Queue", queue("q"))
    for i in range(6):
        rs.create("Pod", pod(f"p{i}"))
    rs.create("Node", node("n0"))
    n2 = rs.get("Node", "/n0")
    n2.labels["zone"] = "z1"
    rs.update("Node", n2)
    rs.patch("Pod", "default/p5", {"node_name": "n0"})
    assert rs.bulk([{"op": "patch", "kind": "Pod", "key": f"default/p{i}",
                     "fields": {"node_name": "n0"}} for i in range(3)]) == [None] * 3
    seg = DecisionSegment.build(["default/p3", "default/p4"], [0, 0], ["n0"],
                                evicts=[("default/p0", "Preempted")])
    res = rs.apply_segment(seg)
    assert not res["binds"] and not res["evicts"]
    rs.delete("Pod", "default/p1")
    acked = {p.meta.key: (p.node_name, p.deleting, p.meta.resource_version)
             for p in rs.list("Pod")}
    acked_events = {e.meta.name for e in rs.list("Event")}
    seq, rv = srv.seq, srv.store._rv
    srv.kill()
    srv2 = _boot(tmp_path)
    try:
        rs2 = RemoteStore(srv2.url)
        assert {p.meta.key: (p.node_name, p.deleting, p.meta.resource_version)
                for p in rs2.list("Pod")} == acked
        assert {e.meta.name for e in rs2.list("Event")} == acked_events
        assert rs2.get("Node", "/n0").labels["zone"] == "z1"
        assert srv2.seq == seq and srv2.store._rv == rv
        n3 = rs2.get("Node", "/n0")
        rs2.update_cas("Node", n3, n3.meta.resource_version)  # CAS goes on
    finally:
        srv2.stop()


def test_no_observable_half_applied_segment_across_crash(tmp_path):
    """test_crash_recovery.py:243: a segment whose record survived recovers
    whole; one whose record was lost recovers not at all."""
    srv = _boot(tmp_path)
    rs = RemoteStore(srv.url)
    for i in range(8):
        rs.create("Pod", pod(f"p{i}"))
    seg = DecisionSegment.build([f"default/p{i}" for i in range(8)], [0] * 8, ["n0"])
    assert not rs.apply_segment(seg)["binds"]
    srv.kill()
    srv2 = _boot(tmp_path)
    rs2 = RemoteStore(srv2.url)
    assert all(p.node_name == "n0" for p in rs2.list("Pod"))
    assert len(rs2.list("Event")) == 8
    seg2 = DecisionSegment.build([f"default/p{i}" for i in range(8)], [0] * 8, ["m1"],
                                 evicts=[("default/p7", "Preempted")])
    assert not rs2.apply_segment(seg2)["binds"]
    srv2.kill()
    live = sorted(glob.glob(str(tmp_path / "state.json.wal" / "*.wal")))[-1]
    records, _ = read_records(live)
    assert records, "the segment record should be in the newest segment"
    with open(live, "r+b") as f:
        f.truncate(os.path.getsize(live) - 10)  # tear the segment record
    srv3 = _boot(tmp_path)
    try:
        rs3 = RemoteStore(srv3.url)
        assert all(p.node_name == "n0" and not p.deleting for p in rs3.list("Pod"))
        assert len(rs3.list("Event")) == 8
    finally:
        srv3.stop()


def test_segment_resubmit_is_idempotent_on_uid_block(tmp_path):
    """test_crash_recovery.py:287: the same segment twice gives no duplicate
    Event, no extra patch event and the state of one apply."""
    srv = _boot(tmp_path)
    try:
        rs = RemoteStore(srv.url)
        for i in range(4):
            rs.create("Pod", pod(f"p{i}"))
        seg = DecisionSegment.build([f"default/p{i}" for i in range(4)], [0] * 4, ["n0"],
                                    evicts=[("default/p3", "Overcommit")])
        watcher = RemoteStore(srv.url)
        q = watcher.watch("Event")
        assert not rs.apply_segment(seg)["binds"]
        watcher.poll()
        first = len(q)
        assert first == 5
        once = {(p.meta.key, p.node_name, p.deleting, p.meta.resource_version)
                for p in rs.list("Pod")}
        events_once = sorted(e.meta.name for e in rs.list("Event"))
        res = rs.apply_segment(seg)
        assert not res["binds"] and not res["evicts"]
        watcher.poll()
        assert len(q) == first, "the resubmit fanned out duplicate events"
        assert {(p.meta.key, p.node_name, p.deleting, p.meta.resource_version)
                for p in rs.list("Pod")} == once
        assert sorted(e.meta.name for e in rs.list("Event")) == events_once
    finally:
        srv.stop()


def test_applier_reships_segment_through_one_connection_cut():
    """test_crash_recovery.py:322: a connection-level cut during the ship
    re-ships the same segment once instead of dropping the decisions."""
    from volcano_tpu_torch.scheduler.apply import AsyncApplier
    from volcano_tpu_torch.store import Store

    class _Cache:
        def __init__(self, store):
            self.store = store
            self.errs = []

        def _record_err(self, verb, key, e):
            self.errs.append((verb, key, repr(e)))

    class _CutOnceStore:
        def __init__(self, inner):
            self._inner = inner
            self.calls = 0

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def apply_segment(self, seg):
            self.calls += 1
            if self.calls == 1:
                raise ConnectionResetError("cut mid-request")
            return self._inner.apply_segment(seg)

    inner = Store()
    for i in range(3):
        inner.create("Pod", pod(f"p{i}"))
    store = _CutOnceStore(inner)
    cache = _Cache(store)
    applier = AsyncApplier(cache)
    try:
        applier.submit_segment(DecisionSegment.build(
            [f"default/p{i}" for i in range(3)], [0] * 3, ["n0"]))
        assert applier.flush(timeout=10)
        assert store.calls == 2 and cache.errs == []
        assert all(p.node_name == "n0" for p in inner.list("Pod"))
        assert len(inner.list("Event")) == 3
    finally:
        applier.stop()


def test_applier_reships_through_a_real_cut_once_only(tmp_path):
    """Over HTTP: a server that died mid-ship (refused) costs one re-ship;
    a second failure lands in err_log for the next cycle."""
    from volcano_tpu_torch.scheduler.apply import AsyncApplier

    class _Cache:
        def __init__(self, store):
            self.store = store
            self.errs = []

        def _record_err(self, verb, key, e):
            self.errs.append((verb, key))

    srv = _boot(tmp_path)
    rs = RemoteStore(srv.url, timeout=5)
    rs.create("Pod", pod("p0"))
    srv.kill()  # nothing listens: every ship is refused
    cache = _Cache(rs)
    applier = AsyncApplier(cache)
    calls = []
    real = rs.apply_segment
    rs.apply_segment = lambda seg: (calls.append(1), real(seg))[1]
    try:
        applier.submit_segment(DecisionSegment.build(["default/p0"], [0], ["n0"]))
        assert applier.flush(timeout=30)
        assert len(calls) == 2 and cache.errs == [("bind", "default/p0")]
    finally:
        applier.stop()


def test_restarted_server_relists_watchers_and_mirror_converges(tmp_path):
    """test_crash_recovery.py:373: an active mirror behind a crash and a
    restart relists (StaleWatch), converges, then goes on incrementally."""
    from volcano_tpu_torch.scheduler.fastpath import ArrayMirror

    srv = _boot(tmp_path)
    writer = RemoteStore(srv.url)
    writer.create("Queue", queue("default"))
    writer.create("Node", node("n0"))
    writer.create("PodGroup", podgroup("pg"))
    writer.create("Pod", pod("p0", group="pg"))
    m = ArrayMirror(RemoteStore(srv.url), "volcano-tpu", "default")
    m.drain()
    assert int(m.p_live.sum()) == 1 and m.stale_relists == 0
    writer.create("Pod", pod("p1", group="pg"))
    writer.delete("Pod", "default/p0")
    port = srv.port
    srv.kill()
    srv2 = StoreServer(port=port, state_path=str(tmp_path / "state.json"),
                       save_interval=3600, wal=True).start()
    try:
        m.drain()
        assert m.stale_relists == 1
        assert int(m.p_live.sum()) == 1
        assert "default/p1" in m.pods.key_row and "default/p0" not in m.pods.key_row
        RemoteStore(srv2.url).create("Pod", pod("p2", group="pg"))
        m.drain()
        assert int(m.p_live.sum()) == 2 and m.stale_relists == 1
    finally:
        srv2.stop()


# -- observability -----------------------------------------------------------------


def test_wal_metrics_monotonic_and_exposed(tmp_path):
    """test_crash_recovery.py:415."""
    a0 = metrics.get_counter("volcano_store_wal_appended_records_total")
    f0 = metrics.get_counter("volcano_store_wal_fsync_total")
    r0 = metrics.get_counter("volcano_store_wal_recovery_replayed_records_total")
    srv = _boot(tmp_path)
    rs = RemoteStore(srv.url)
    rs.create("Queue", queue("q"))
    rs.create("Queue", queue("r"))
    a1 = metrics.get_counter("volcano_store_wal_appended_records_total")
    assert a1 >= a0 + 2
    assert metrics.get_counter("volcano_store_wal_fsync_total") >= f0 + 1
    srv.kill()
    srv2 = _boot(tmp_path)
    try:
        assert metrics.get_counter("volcano_store_wal_recovery_replayed_records_total") >= r0 + 2
        assert metrics.get_counter("volcano_store_wal_appended_records_total") >= a1
        text = metrics.expose_text()
        for name in ("volcano_store_wal_appended_records_total",
                     "volcano_store_wal_fsync_total",
                     "volcano_store_wal_fsync_seconds",
                     "volcano_store_wal_recovery_replayed_records_total"):
            assert name in text
        health = RemoteStore(srv2.url)._request("GET", "/healthz")[1]
        assert health["wal"]["replayed_records"] == 2 and health["wal"]["torn_tails"] == 0
    finally:
        srv2.stop()


def test_wal_metric_exposition_equals_jax():
    """The WAL families expose as the JAX registry's for the same calls."""
    from volcano_tpu.scheduler import metrics as jmetrics

    for m in (metrics, jmetrics):
        m.reset()
        m.register_wal_append(3)
        m.register_wal_fsync()
        m.observe_wal_fsync(0.0042)
        m.register_wal_recovery(7)
    try:
        assert metrics.expose_text() == jmetrics.expose_text()
    finally:
        metrics.reset()
        jmetrics.reset()


def test_recovery_emits_store_recover_span(tmp_path):
    """test_crash_recovery.py:446."""
    srv = _boot(tmp_path)
    rs = RemoteStore(srv.url)
    rs.create("Queue", queue("q"))
    rs.create("Queue", queue("r"))
    srv.kill()
    tracer = trace.arm(trace.Tracer(ring=1024))
    try:
        srv2 = _boot(tmp_path)
        srv2.stop()
        spans = [r for r in tracer.records() if r.get("name") == "store.recover"]
        assert spans, "recovery did not trace store.recover"
        attrs = spans[-1]["attrs"]
        assert attrs["replayed"] == 2 and attrs["torn_tails"] == 0
    finally:
        trace.disarm()


def test_sigterm_flushes_state_and_wal_before_exit(tmp_path):
    """test_crash_recovery.py:468: the daemon entry flushes the state and
    fsyncs the WAL on SIGTERM; a write acknowledged just before is in the
    state file."""
    state = str(tmp_path / "state.json")
    p = subprocess.Popen(
        [sys.executable, "-m", "volcano_tpu_torch.store.server", "--port", "0",
         "--state", state, "--wal"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(REPO))
    try:
        url = p.stdout.readline().strip().rsplit(" ", 1)[-1]
        assert wait_healthy(url, timeout=30)
        RemoteStore(url).create("Queue", queue("sigterm-q"))
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=30) == 0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    names = [q["meta"]["name"] for q in json.load(open(state))["kinds"]["Queue"]]
    assert "sigterm-q" in names and "default" in names
    srv = StoreServer(state_path=state, wal=True)
    try:
        assert srv.store.get("Queue", "/sigterm-q") is not None
        assert srv.wal.replayed_records == 0  # the shutdown checkpoint truncated the WAL
    finally:
        srv.kill()


# -- review regressions --------------------------------------------------------------


def test_failed_fsync_does_not_mark_records_synced(tmp_path, monkeypatch):
    """test_crash_recovery.py:1022."""
    wal = WriteAheadLog(str(tmp_path / "wal"))
    t = wal.append({"i": 0})
    real_fsync = os.fsync
    calls = {"n": 0}

    def flaky(fd):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError(5, "injected EIO")
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", flaky)
    with pytest.raises(OSError):
        wal.commit(t)
    assert wal.fsync_total == 0
    wal.commit(t)
    assert wal.fsync_total == 1
    monkeypatch.setattr(os, "fsync", real_fsync)
    wal.sync_close()
    w2 = WriteAheadLog(str(tmp_path / "wal"))
    assert [r["i"] for r in w2.replay(0)] == [0]
    w2.sync_close()


def test_wal_off_boot_absorbs_acked_tail_and_retires_segments(tmp_path):
    """test_crash_recovery.py:1050."""
    state = str(tmp_path / "state.json")
    srv1 = StoreServer(state_path=state, save_interval=3600, wal=True)
    srv1.store.create("Queue", queue("acked"))
    with srv1.lock:
        srv1._pump_log()
        srv1._wal_append({"op": "create", "kind": "Queue",
                          "object": {"meta": {"name": "acked", "namespace": "",
                                              "resource_version": 1}}})
    srv1.wal.commit()
    srv1.kill()
    assert not os.path.exists(state)
    srv2 = StoreServer(state_path=state, save_interval=3600)
    assert srv2.store.get("Queue", "/acked") is not None
    assert json.load(open(state))["kinds"]["Queue"]
    assert glob.glob(str(tmp_path / "state.json.wal" / "*.wal")) == []
    srv2.store.create("Queue", queue("newer"))
    srv2.flush_state()
    srv2.kill()
    srv3 = StoreServer(state_path=state, save_interval=3600, wal=True)
    assert srv3.store.get("Queue", "/acked") is not None
    assert srv3.store.get("Queue", "/newer") is not None
    assert srv3.wal.replayed_records == 0
    assert "wal_floor" in json.load(open(state))
    srv3.kill()


def test_drop_below_never_unlinks_the_live_segment(tmp_path):
    """test_crash_recovery.py:1092."""
    d = str(tmp_path / "wal")
    wal = WriteAheadLog(d)
    wal.drop_below(7)
    assert wal.segment_indices() == [1]
    wal.append({"i": 0})
    wal.commit()
    wal.sync_close()
    w2 = WriteAheadLog(d)
    assert [r["i"] for r in w2.replay(0)] == [0]
    w2.sync_close()


def test_floor_stamp_written_even_for_empty_inherited_snapshot(tmp_path):
    """test_crash_recovery.py:1108."""
    state = str(tmp_path / "state.json")
    with open(state, "w") as f:
        json.dump({"seq": 5, "rv": 5, "store_uid": "u", "kinds": {}}, f)
    srv = StoreServer(state_path=state, save_interval=3600, wal=True)
    data = json.load(open(state))
    assert "wal_floor" in data and data["seq"] == 5
    srv.kill()


# -- either package boots from the other's state directory ------------------------------


def _workload(rs, api, Segment):
    """The same acknowledged history through either package's client:
    creates, an update, a patch, a bulk, a segment with an eviction, a
    delete.  ``api`` is the package's builders (the JAX tests' helpers or
    this file's)."""
    rs.create("Queue", api["queue"]("default"))
    rs.create("Node", api["node"]("n0"))
    rs.create("PodGroup", api["podgroup"]("pg"))
    for i in range(6):
        rs.create("Pod", api["pod"](f"p{i}", group="pg"))
    n = rs.get("Node", "/n0")
    n.labels["zone"] = "z1"
    rs.update("Node", n)
    rs.patch("Pod", "default/p5", {"node_name": "n0"})
    assert rs.bulk([{"op": "patch", "kind": "Pod", "key": f"default/p{i}",
                     "fields": {"node_name": "n0"}} for i in range(2)]) == [None] * 2
    seg = Segment.build(["default/p2", "default/p3"], [0, 0], ["n0"],
                        evicts=[("default/p0", "Preempted")])
    res = rs.apply_segment(seg)
    assert not res["binds"] and not res["evicts"]
    rs.delete("Pod", "default/p4")


def _state_of(rs):
    """Every object's encoding by (kind, key), Events by name."""
    out = {}
    for kind in ("Queue", "Node", "PodGroup", "Pod", "Event"):
        for o in rs.list(kind):
            out[(kind, o.meta.key)] = json.dumps(encode(o), sort_keys=True)
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_servers_boot_from_each_others_state_and_wal(tmp_path, writer):
    """A server of one package runs the workload with the WAL armed, is
    killed without a flush (its history is the WAL alone, past the boot's
    floor stamp), and a server of the other package recovers that directory:
    every object equal, the seq and rv lines continued."""
    from tests import helpers as jhelpers
    from volcano_tpu.store.client import RemoteStore as JRemoteStore
    from volcano_tpu.store.segment import DecisionSegment as JSegment
    from volcano_tpu.store.server import StoreServer as JStoreServer

    state = str(tmp_path / "state.json")
    port_api = {"queue": queue, "node": node, "podgroup": podgroup, "pod": pod}
    jax_api = {"queue": jhelpers.build_queue, "node": jhelpers.build_node,
               "podgroup": jhelpers.build_podgroup, "pod": jhelpers.build_pod}
    if writer == "jax":
        srv = JStoreServer(state_path=state, save_interval=3600, wal=True).start()
        rs = JRemoteStore(srv.url)
        _workload(rs, jax_api, JSegment)
    else:
        srv = StoreServer(state_path=state, save_interval=3600, wal=True).start()
        rs = RemoteStore(srv.url)
        _workload(rs, port_api, DecisionSegment)
    before = _state_of(RemoteStore(srv.url))
    seq, rv = srv.seq, srv.store._rv
    srv.kill()
    other = StoreServer if writer == "jax" else JStoreServer
    srv2 = other(state_path=state, save_interval=3600, wal=True).start()
    try:
        assert srv2.wal.replayed_records > 0
        assert _state_of(RemoteStore(srv2.url)) == before
        assert (srv2.seq, srv2.store._rv) == (seq, rv)
    finally:
        srv2.stop()
    # and back: the state the second server checkpointed boots the first
    first = JStoreServer if writer == "jax" else StoreServer
    srv3 = first(state_path=state, save_interval=3600, wal=True).start()
    try:
        assert _state_of(RemoteStore(srv3.url)) == before
    finally:
        srv3.stop()
