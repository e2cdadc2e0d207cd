"""The server half of the port's columnar wire: ``Store.apply_segment_lazy``,
the StoreServer's segment verb and log blocks (``PatchLogBlock``,
``EventLogBlock``, ``encode_event_row``), against the JAX package's tests.

Each case mirrors one of ``tests/test_columnar_wire.py:82-504`` that
``tests/test_torch_publish_wire.py`` does not (its line named): the Event
row encoding byte for byte, a segment's watch rows equal to the
per-object encoding, the watch stream
equal to the per-object publish path's, the remote watcher's decode, the
lazy rows (deferred until read, Events never materialized unless listed, a
later patch stacking on a lazy row, no-op binds with their Event only, row
errors), the lazy rows through ``flush_state`` and a restart, the log
blocks' partial trim and the relist horizon.  The chaos storm (``:585``)
waits for ROADMAP item 13.

The stream comparisons freeze what differs from run to run: the uid
counter and its process token (``api.objects._uid_token`` / ``_uid_next``:
Event names and uids) and the clock (``time.time``: creation stamps).
"""

import json
import re
import time

import pytest

from volcano_tpu_torch.api import objects as api_objects
from volcano_tpu_torch.events import events_for
from volcano_tpu_torch.scheduler.cache import SchedulerCache
from volcano_tpu_torch.store.client import RemoteStore
from volcano_tpu_torch.store.codec import encode
from volcano_tpu_torch.store.segment import (
    DecisionSegment,
    encode_event_row,
    event_name,
    materialize_event,
)
from volcano_tpu_torch.store.server import StoreServer

from test_torch_store_server import node, pod, podgroup


@pytest.fixture(autouse=True)
def _op_determined_seqs(monkeypatch):
    """The digest beacons take seqs on a wall-clock cadence (1 s by
    default), so a slow run would slip one in where these cases expect
    only their own writes: the cadence is pinned past each case, as
    ``tests/test_procmesh.py:118`` does.  The digest stays armed;
    ``stamp_beacon`` still stamps one on demand."""
    monkeypatch.setenv("VOLCANO_TPU_AUDIT_BEACON_S", "3600")


def _seg(bind_pairs, evicts=(), node_table=None):
    """A segment from (key, host) pairs, the hosts interned."""
    table = list(node_table) if node_table else sorted({h for _, h in bind_pairs})
    idx = {h: i for i, h in enumerate(table)}
    return DecisionSegment.build([k for k, _ in bind_pairs], [idx[h] for _, h in bind_pairs],
                                 table, list(evicts))


def _seed_pods(create, n, nodes=("n0", "n1")):
    for name in nodes:
        create("Node", node(name, cpu="64", memory="64Gi"))
    create("PodGroup", podgroup("pg1"))
    for i in range(n):
        create("Pod", pod(f"p{i}", group="pg1", cpu="1"))


# -- wire format ------------------------------------------------------------------


def test_segment_event_encoding_matches_codec_byte_for_byte():
    """test_columnar_wire.py:82, and equal to the JAX package's rows."""
    from volcano_tpu.store.segment import encode_event_row as jrow

    for args in ((event_name("tok", 7), "default/p0", "Scheduled",
                  "Successfully assigned default/p0 to n1", "Normal", 42, 1234.5),
                 (event_name("tok", 8), "default/p1", "Evict", "Evicted for preempt",
                  "Warning", 43, 1234.5)):
        assert json.dumps(encode_event_row(*args)) == json.dumps(
            encode(materialize_event(*args)))
        assert json.dumps(encode_event_row(*args)) == json.dumps(jrow(*args))


def test_segment_pod_rows_decode_equal_per_object_encode():
    """test_columnar_wire.py:98."""
    srv = StoreServer().start()
    try:
        rs = RemoteStore(srv.url)
        _seed_pods(rs.create, 3)
        cursor = rs.resource_version
        rs.apply_segment(_seg([("default/p0", "n0"), ("default/p1", "n1")],
                              evicts=[("default/p2", "too-hot")]))
        rows = srv.watch_since(cursor, {"Pod"}, 0)["events"]
        assert [e["type"] for e in rows] == ["Updated"] * 3
        for e in rows:
            obj = srv.store.get("Pod", f"default/{e['object']['meta']['name']}")
            assert json.dumps(e["object"]) == json.dumps(encode(obj))
        ev_rows = srv.watch_since(cursor, {"Event"}, 0)["events"]
        evs = {e.meta.key: e for e in srv.store.list("Event")}
        assert len(ev_rows) == 3 and len(evs) == 3
        for e in ev_rows:
            key = f"/{e['object']['meta']['name']}"
            assert json.dumps(e["object"]) == json.dumps(encode(evs[key]))
    finally:
        srv.stop()


# -- the watch stream against the per-object path -----------------------------------

_EV_ID = re.compile(r"event-t0-\d{8}(?:-t0-\d{8})?")


def _normalize(stream) -> str:
    """json bytes of a stream with the Event identities (name and uid,
    opaque ids: the per-object path draws a second counter slot for the uid,
    the segment reuses the name) replaced by first-appearance ordinals."""
    out = json.loads(json.dumps(stream))
    for e in out:
        if e["kind"] == "Event":
            for side in ("object", "old"):
                o = e.get(side)
                if o:
                    o["meta"]["uid"] = o["meta"]["name"]
    seen = {}
    return _EV_ID.sub(lambda m: seen.setdefault(m.group(0), f"EV{len(seen)}"), json.dumps(out))


def _run_publish(monkeypatch, columnar: bool):
    """24 binds and 6 evictions through the port's applier against a fresh
    server, per object or as one segment; the server's whole log."""
    monkeypatch.setattr(api_objects, "_uid_token", "t0")
    monkeypatch.setattr(api_objects, "_uid_next", 1000)
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    srv = StoreServer().start()
    try:
        rs = RemoteStore(srv.url)
        _seed_pods(rs.create, 30, nodes=("n0", "n1", "n2"))
        cache = SchedulerCache(rs, async_apply=True)
        binds = [(f"default/p{i}", f"n{i % 3}") for i in range(24)]
        evicts = [(f"default/p{24 + i}", "preempt") for i in range(6)]
        applier = cache.applier
        try:
            # drive the drain on this thread, one batch, as a cycle's is
            if columnar:
                applier._apply([("segment", _seg(binds, evicts), None)])
            else:
                applier._apply([("bind", k, h) for k, h in binds]
                               + [("evict", k, r) for k, r in evicts])
        finally:
            applier.stop(flush=False)
        assert cache.err_log == []
        return srv.watch_since(0, set(), 0)["events"]
    finally:
        srv.stop()


def test_watch_stream_byte_identical_to_per_object_path(monkeypatch):
    """test_columnar_wire.py:186."""
    per_object = _run_publish(monkeypatch, columnar=False)
    columnar = _run_publish(monkeypatch, columnar=True)
    assert _normalize(columnar) == _normalize(per_object)
    kinds = [e["kind"] for e in columnar]
    assert kinds.count("Event") == 30
    assert sum(1 for e in columnar if e["kind"] == "Pod" and e["type"] == "Updated") == 30


def test_remote_watch_client_decodes_segment_rows():
    """test_columnar_wire.py:198."""
    srv = StoreServer().start()
    try:
        rs = RemoteStore(srv.url)
        _seed_pods(rs.create, 2)
        watcher = RemoteStore(srv.url)
        q = watcher.watch("Pod")
        qe = watcher.watch("Event")
        rs.apply_segment(_seg([("default/p0", "n1"), ("default/p1", "n0")]))
        got = []
        while q:
            got.append(q.popleft())
        assert [(e.obj.meta.name, e.obj.node_name) for e in got] == [("p0", "n1"), ("p1", "n0")]
        assert all(e.old is not None and not e.old.node_name for e in got)
        evs = []
        while qe:
            evs.append(qe.popleft())
        assert [e.obj.reason for e in evs] == ["Scheduled", "Scheduled"]
        assert evs[0].obj.message.endswith("assigned default/p0 to n1")
        assert evs[0].enc == encode(evs[0].obj)  # the wire form rides along
    finally:
        srv.stop()


# -- the lazy rows -----------------------------------------------------------------------


def test_lazy_apply_defers_object_writes_until_read():
    """test_columnar_wire.py:227."""
    srv = StoreServer().start()
    try:
        rs = RemoteStore(srv.url)
        _seed_pods(rs.create, 2)
        store = srv.store
        rv_before = store.resource_version
        rs.apply_segment(_seg([("default/p0", "n1"), ("default/p1", "n0")]))
        # rvs advanced at the ACK (2 patches + 2 Events), the objects untouched
        assert store.resource_version == rv_before + 4
        assert store._objects["Pod"]["default/p0"].node_name == ""
        assert len(store._lazy_patch["Pod"]) == 2
        p0 = store.get("Pod", "default/p0")
        assert p0.node_name == "n1" and p0.meta.resource_version == rv_before + 1
        assert "default/p0" not in store._lazy_patch["Pod"]
        # the shadow materialized too: the same value again stays quiescent
        rv = store.resource_version
        store.patch("Pod", "default/p0", {"node_name": "n1"})
        assert store.resource_version == rv
    finally:
        srv.stop()


def test_lazy_events_never_materialize_unless_listed():
    """test_columnar_wire.py:253."""
    srv = StoreServer().start()
    try:
        rs = RemoteStore(srv.url)
        _seed_pods(rs.create, 2)
        rs.apply_segment(_seg([("default/p0", "n1"), ("default/p1", "n0")]))
        store = srv.store
        assert store._objects["Event"] == {}
        assert len(store._lazy_create["Event"]) == 2
        assert [e.reason for e in events_for(store, "Pod", "default/p0")] == ["Scheduled"]
        assert store._lazy_create["Event"] == {}
        ordered = sorted(store.list("Event"), key=lambda e: e.meta.uid)
        assert [e.involved[1] for e in ordered] == ["default/p0", "default/p1"]
    finally:
        srv.stop()


def test_later_patch_stacks_on_lazy_row_and_noop_binds_event_only():
    """test_columnar_wire.py:273."""
    srv = StoreServer().start()
    try:
        rs = RemoteStore(srv.url)
        _seed_pods(rs.create, 1)
        cursor = rs.resource_version
        rs.apply_segment(_seg([("default/p0", "n1")]))
        rs.patch("Pod", "default/p0", {"deleting": True})
        rows = srv.watch_since(cursor, {"Pod"}, 0)["events"]
        assert [e["object"]["node_name"] for e in rows] == ["n1", "n1"]
        assert rows[1]["object"]["deleting"] is True and rows[1]["old"]["node_name"] == "n1"
        seq = srv.seq
        assert rs.apply_segment(_seg([("default/p0", "n1")]))["binds"] == []
        assert [e["kind"] for e in srv.watch_since(seq, set(), 0)["events"]] == ["Event"]
    finally:
        srv.stop()


def test_segment_row_errors_surface_and_pods_vanish_cleanly():
    """test_columnar_wire.py:297."""
    srv = StoreServer().start()
    try:
        rs = RemoteStore(srv.url)
        _seed_pods(rs.create, 1)
        res = rs.apply_segment(_seg([("default/p0", "n1"), ("default/ghost", "n0")],
                                    evicts=[("default/gone", "preempt")]))
        assert [row for row, _ in res["binds"]] == [1] and "NotFound" in res["binds"][0][1]
        assert [row for row, _ in res["evicts"]] == [0]
        assert rs.get("Pod", "default/p0").node_name == "n1"
        assert [e.reason for e in srv.store.list("Event")] == ["Scheduled"]
    finally:
        srv.stop()


def test_flush_state_persists_lazy_rows(tmp_path):
    """test_columnar_wire.py:316."""
    state = str(tmp_path / "state.json")
    srv = StoreServer(state_path=state, save_interval=3600).start()
    try:
        rs = RemoteStore(srv.url)
        _seed_pods(rs.create, 1)
        rs.apply_segment(_seg([("default/p0", "n1")]))
        srv.flush_state()
        data = json.load(open(state))
        pods = {p["meta"]["name"]: p for p in data["kinds"]["Pod"]}
        assert pods["p0"]["node_name"] == "n1"
        assert len(data["kinds"]["Event"]) == 1
    finally:
        srv.stop()


def test_lazy_rows_survive_a_restart(tmp_path):
    """The lazy rows through the state file and a new server: the pod bound,
    its Event there with the segment's stamp."""
    state = str(tmp_path / "state.json")
    srv = StoreServer(state_path=state, save_interval=3600).start()
    rs = RemoteStore(srv.url)
    _seed_pods(rs.create, 2)
    rs.apply_segment(_seg([("default/p0", "n1"), ("default/p1", "n0")],
                          evicts=[("default/p0", "x")]))
    before = {p.meta.key: (p.node_name, p.deleting, p.meta.resource_version)
              for p in rs.list("Pod")}
    events = sorted((e.meta.name, e.reason, e.meta.creation_timestamp)
                    for e in rs.list("Event"))
    srv.stop()
    srv2 = StoreServer(state_path=state, save_interval=3600).start()
    try:
        rs2 = RemoteStore(srv2.url)
        assert {p.meta.key: (p.node_name, p.deleting, p.meta.resource_version)
                for p in rs2.list("Pod")} == before
        assert sorted((e.meta.name, e.reason, e.meta.creation_timestamp)
                      for e in rs2.list("Event")) == events
    finally:
        srv2.stop()


def test_log_blocks_trim_partially_and_relist_horizon_holds(monkeypatch):
    """test_columnar_wire.py:332."""
    from volcano_tpu_torch.store import server as server_mod

    monkeypatch.setattr(server_mod, "LOG_CAP", 10)
    srv = StoreServer().start()
    try:
        rs = RemoteStore(srv.url)
        _seed_pods(rs.create, 8)  # 11 seed events: over the cap already
        cursor = rs.resource_version
        rs.apply_segment(_seg([(f"default/p{i}", f"n{i % 2}") for i in range(8)]))
        assert srv._log_rows == 10
        horizon = srv.seq - srv._log_rows
        assert horizon > cursor  # the trim ate into the patch block
        assert srv.watch_since(horizon - 1, set(), 0).get("relist")
        out = srv.watch_since(horizon + 1, set(), 0)
        assert [e["seq"] for e in out["events"]] == list(range(horizon + 2, srv.seq + 1))
        assert [e["kind"] for e in out["events"]] == ["Pod"] + ["Event"] * 8
    finally:
        srv.stop()


def test_restart_seeds_obj_enc_for_segment_delta_bases(tmp_path):
    """test_columnar_wire.py:437."""
    state = str(tmp_path / "state.json")
    srv = StoreServer(state_path=state, save_interval=0.0).start()
    _seed_pods(RemoteStore(srv.url).create, 2)
    srv.stop()
    srv2 = StoreServer(state_path=state, save_interval=0.0).start()
    try:
        assert ("Pod", "default/p0") in srv2._obj_enc
        rs2 = RemoteStore(srv2.url)
        cursor = rs2.resource_version
        rs2.apply_segment(_seg([("default/p0", "n1")]))
        rows = srv2.watch_since(cursor, {"Pod"}, 0)["events"]
        assert rows[0]["object"]["node_name"] == "n1" and rows[0]["old"]["node_name"] == ""
        assert json.dumps(rows[0]["object"]) == json.dumps(
            encode(srv2.store.get("Pod", "default/p0")))
    finally:
        srv2.stop()


def test_store_pickle_materializes_lazy_rows():
    """``Store.__getstate__`` folds the pending rows first: the pickle holds
    plain objects, and the copy reads as the original."""
    import pickle

    srv = StoreServer()
    try:
        _seed_pods(srv.store.create, 2)
        srv.store.apply_segment_lazy(_seg([("default/p0", "n1")]), stamp=5.0)
        copy = pickle.loads(pickle.dumps(srv.store))
        assert not copy._lazy_patch["Pod"] and not copy._lazy_create["Event"]
        assert copy.get("Pod", "default/p0").node_name == "n1"
        assert [e.meta.creation_timestamp for e in copy.list("Event")] == [5.0]
        copy.patch("Pod", "default/p1", {"node_name": "n0"})  # the lock came back
    finally:
        srv.kill()
