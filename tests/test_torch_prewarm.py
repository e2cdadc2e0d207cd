"""The port's ``Scheduler.prewarm`` and mirror checkpoint against the JAX
package's.

The counterparts of ``tests/test_prewarm.py`` (its two XLA compilation
cache tests have none: the port keeps no compile cache, its kernel build
directory persists):

* which kernel variants a prewarm launches: every call of the allocate
  solve (its task bucket and pending count), the dynamic solve, the storm
  solves and the victim step is recorded in both packages (the JAX
  prewarm's compiles, the port's launches) and the two multisets must be
  equal, for the express, full-conf, contended, dynamic and object-path
  clusters; the port's split into the critical part and the later part is
  checked by name;
* a prewarm binds nothing and writes nothing to the store, and the cycle
  after it schedules as before; a queueless or empty cluster does not
  crash it; a background part joins and records no failure;
* a mirror restored from a checkpoint reconciles what changed while it was
  cold (a bind, a deletion, a new pod, a PodGroup update) into the
  snapshot a full list builds, in the port and against the JAX package;
* a checkpoint from another store lineage, another scheduler name or an
  unreadable file is refused;
* a Scheduler restarted from a checkpoint restores instead of listing and
  binds what the JAX Scheduler restarted the same way binds.

Tolerance: exact (decisions and snapshot arrays).
"""

import dataclasses

import numpy as np
import pytest
import torch

from volcano_tpu.api.types import PodPhase
from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler import tensor_actions as jTA
from volcano_tpu.scheduler import victim_kernels as jVK
from volcano_tpu.scheduler.fastpath import ArrayMirror as JMirror
from volcano_tpu.scheduler.fastpath import build_fast_snapshot as jbuild_fast
from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
from volcano_tpu_torch.scheduler import conf as tconf
from volcano_tpu_torch.scheduler import tensor_actions as TA
from volcano_tpu_torch.scheduler import victim_kernels as VK
from volcano_tpu_torch.scheduler.fastpath.mirror import ArrayMirror
from volcano_tpu_torch.scheduler.fastpath.snapshot_build import build_fast_snapshot
from volcano_tpu_torch.scheduler.scheduler import Scheduler
from volcano_tpu_torch.store import Store

from helpers import build_node, build_pod, build_podgroup, make_store
from test_torch_object import _convert, _running, port_conf, port_store

torch.set_num_threads(1)

STORM = ("preempt_solve", "preempt_rounds", "reclaim_solve")


def _store(n_nodes=3, n_tasks=4):
    return make_store(
        nodes=[build_node(f"n{i}") for i in range(n_nodes)],
        podgroups=[build_podgroup("pg", min_member=n_tasks)],
        pods=[build_pod(f"p{i}", group="pg", cpu="1") for i in range(n_tasks)])


def _contended():
    """Full nodes of low-priority residents and a pending high-priority
    gang: the preempt precheck finds work now."""
    low = build_podgroup("pg-low", min_member=1)
    high = build_podgroup("pg-high", min_member=2)
    pods = [_running(f"low-{i}-{k}", "pg-low", f"n{i}", cpu="2") for i in range(2)
            for k in range(2)]
    pods += [build_pod(f"high-{k}", group="pg-high", cpu="2", priority=100) for k in range(2)]
    return make_store(nodes=[build_node(f"n{i}", cpu="4") for i in range(2)],
                      podgroups=[low, high], pods=pods)


def _dynamic():
    """Express gangs and one gang whose pods take a host port."""
    store = _store()
    store.create("PodGroup", build_podgroup("dyn", min_member=2))
    for k in range(2):
        pod = build_pod(f"d{k}", group="dyn", cpu="1")
        pod.spec.host_ports = [8080]
        store.create("Pod", pod)
    return store


class Calls:
    """Records the solve calls of one package's prewarm: (solve, task
    rows, pending count passed) for the allocate solve, the name (and mode)
    for the rest."""

    def __init__(self, monkeypatch, port: bool):
        self.log = []
        if port:
            self._wrap(monkeypatch, TA, "torch_allocate_solve", self._alloc)
            self._wrap(monkeypatch, TA, "torch_dynamic_solve", self._named("dynamic_solve"))
            mod = VK
        else:
            self._wrap(monkeypatch, jTA, "jax_allocate_solve", self._alloc)
            self._wrap(monkeypatch, jTA, "jax_dynamic_solve", self._named("dynamic_solve"))
            mod = jVK
        for name in STORM:
            self._wrap(monkeypatch, mod, name, self._named(name))
            if port:
                self._wrap(monkeypatch, mod, name + "_sharded", self._named(name))
        self._wrap(monkeypatch, mod, "victim_step", self._step)
        if port:
            self._wrap(monkeypatch, mod, "victim_step_sharded", self._step)

    def _wrap(self, monkeypatch, mod, name, record):
        orig = getattr(mod, name)

        def call(*args, **kw):
            record(*args, **kw)
            return orig(*args, **kw)

        monkeypatch.setattr(mod, name, call)

    def _alloc(self, backend, snap, n_pending=None):
        self.log.append(("allocate", snap.task_req.shape[0], n_pending))

    def _named(self, name):
        return lambda *a, **kw: self.log.append((name,))

    def _step(self, *a, mode="queue", **kw):
        self.log.append(("victim_step", mode))


def _prewarm_pair(monkeypatch, build, jc):
    """Both packages' prewarm (blocking) over copies of one store; returns
    (JAX calls, port calls, port scheduler, port store)."""
    js = build()
    ts = port_store(js)
    tc = port_conf(jc)
    jc.backend = "tpu"
    out = []
    for port, store, conf, make in ((False, js, jc, JScheduler), (True, ts, tc, Scheduler)):
        with monkeypatch.context() as mp:
            calls = Calls(mp, port)
            sched = make(store, conf=conf)
            sched.prewarm(bucket_levels=1, background=False)
            out.append(calls.log)
    return out[0], out[1], sched, ts


def _rv(store):
    return store.resource_version, len(store.list("Event"))


@pytest.mark.parametrize("case,build,conf,critical,later", [
    ("express", _store, lambda: jconf.default_conf("tpu"),
     ["allocate_solve"], ["allocate_solve@L1"]),
    ("full", _store, lambda: jconf.full_conf("tpu"),
     ["allocate_solve"], ["allocate_solve@L1", "contention", "preempt_solve", "preempt_rounds",
                          "reclaim_solve", "victim_step:queue", "victim_step:job",
                          "victim_step:reclaim"]),
    ("contended", _contended, lambda: jconf.full_conf("tpu"),
     ["allocate_solve", "preempt_solve", "preempt_rounds", "reclaim_solve"],
     ["allocate_solve@L1", "victim_step:queue", "victim_step:job", "victim_step:reclaim"]),
    ("dynamic", _dynamic, lambda: jconf.full_conf("tpu"),
     ["allocate_solve", "dynamic_solve"], ["allocate_solve@L1"]),
    ("object", _contended, lambda: dataclasses.replace(jconf.full_conf("tpu"), fast_path="off"),
     ["allocate_solve", "preempt_solve", "preempt_rounds", "reclaim_solve"],
     ["allocate_solve@L1", "victim_step:queue", "victim_step:job", "victim_step:reclaim"]),
    ("batch", _store, lambda: dataclasses.replace(jconf.default_conf("tpu"), solve_mode="batch"),
     ["allocate_solve_batch"], ["allocate_solve_batch@L1"]),
])
def test_prewarm_launches_the_variants_jax_warms(monkeypatch, case, build, conf, critical,
                                                 later):
    jcalls, tcalls, sched, store = _prewarm_pair(monkeypatch, build, conf())
    assert sorted(tcalls) == sorted(jcalls), case
    assert sched.prewarm_tasks == {"critical": critical, "later": later}
    if "contention" in later:
        # deferred: nothing contends now, so even the storm uploads waited
        assert sorted(n for n, *_ in tcalls if n != "allocate") == sorted(
            list(STORM) + ["victim_step"] * 3)
    assert not sched.prewarm_errors and sched.prewarm_device_error is None


def test_prewarm_writes_nothing_and_the_cycle_after_it_schedules(monkeypatch):
    ts = port_store(_store())
    sched = Scheduler(ts, conf=tconf.full_conf("cpu"))
    before = _rv(ts)
    spent = sched.prewarm(bucket_levels=1)
    sched.prewarm_background.join()
    assert spent > 0.0 and not sched.prewarm_errors
    assert _rv(ts) == before
    assert sched.cache.bind_log == [] and sched.cache.evict_log == []
    sched.run_once()
    assert len(sched.cache.bind_log) == 4
    sched.close()
    assert sched.prewarm_background is None


def test_background_failure_is_recorded_not_raised(monkeypatch):
    ts = port_store(_store())
    sched = Scheduler(ts, conf=tconf.default_conf("cpu"))
    orig = TA.torch_allocate_solve

    def fail_padded(backend, snap, n_pending=None):
        if snap.task_req.shape[0] > 8:
            raise RuntimeError("launch failed")
        return orig(backend, snap, n_pending=n_pending)

    monkeypatch.setattr(TA, "torch_allocate_solve", fail_padded)
    sched.prewarm(bucket_levels=1)
    sched.prewarm_background.join()
    assert len(sched.prewarm_errors) == 1 and "allocate_solve@L1" in sched.prewarm_errors[0]
    with pytest.raises(RuntimeError, match="launch failed"):
        sched.prewarm(bucket_levels=1, background=False)


def test_prewarm_queueless_and_empty_cluster_do_not_crash():
    store = make_store(nodes=[build_node("n0")], queues=[],
                       podgroups=[build_podgroup("pg", min_member=1)],
                       pods=[build_pod("p0", group="pg", cpu="1")])
    for q in list(store.items("Queue")):
        store.delete("Queue", q.meta.key)
    sched = Scheduler(port_store(store), conf=tconf.full_conf("cpu"))
    sched.prewarm(bucket_levels=0, background=False)
    sched = Scheduler(Store(), conf=tconf.full_conf("cpu"))
    sched.prewarm(bucket_levels=0, background=False)
    assert not sched.prewarm_errors


def _bigger_store(n_nodes=12, n_jobs=8, tasks=3):
    pods, pgs = [], []
    for j in range(n_jobs):
        pgs.append(build_podgroup(f"pg{j}", min_member=tasks))
        pods.extend(build_pod(f"p{j}-{t}", group=f"pg{j}", cpu="500m") for t in range(tasks))
    return make_store(nodes=[build_node(f"n{i}") for i in range(n_nodes)],
                      podgroups=pgs, pods=pods)


FIELDS = ("node_used", "node_idle", "node_task_count", "task_req", "task_job", "task_valid",
          "job_queue", "job_min_available", "job_ready_init", "job_schedulable", "job_start",
          "job_ntasks", "queue_alloc_init", "queue_request")


def _cold_window(store, convert):
    """A bind, a deletion, a new pod and a PodGroup update while the
    checkpoint is cold."""
    store.patch("Pod", "default/p0-0", {"node_name": "n0", "phase": convert(PodPhase.RUNNING)})
    store.delete("Pod", "default/p1-0")
    store.create("Pod", convert(build_pod("late", group="pg2", cpu="250m")))
    store.patch("PodGroup", "default/pg3", {"min_member": 1})


def test_mirror_checkpoint_restore_reconciles_deltas(tmp_path):
    from volcano_tpu_torch import api as tapi

    js = _bigger_store()
    ts = port_store(js)
    m = ArrayMirror(ts, "volcano-tpu", "default")
    m.drain()
    jm = JMirror(js, "volcano-tpu", "default")
    jm.drain()
    ckpt, jckpt = str(tmp_path / "mirror.ckpt"), str(tmp_path / "jax.ckpt")
    m.save_checkpoint(ckpt)
    jm.save_checkpoint(jckpt)

    def to_port(obj):
        if isinstance(obj, PodPhase):
            return tapi.PodPhase(obj.value)
        return _convert("Pod", obj)

    _cold_window(ts, to_port)
    _cold_window(js, lambda o: o)

    restored = ArrayMirror(ts, "volcano-tpu", "default")
    assert restored.try_restore_checkpoint(ckpt)
    fresh = ArrayMirror(ts, "volcano-tpu", "default")
    fresh.drain()
    jrestored = JMirror(js, "volcano-tpu", "default")
    assert jrestored.try_restore_checkpoint(jckpt)
    s1, a1 = build_fast_snapshot(restored, 1.0)
    s2, a2 = build_fast_snapshot(fresh, 1.0)
    s3, a3 = jbuild_fast(jrestored)
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(s1, field), getattr(s2, field), err_msg=field)
        np.testing.assert_array_equal(getattr(s1, field), getattr(s3, field), err_msg=field)
    assert s1.job_uids == s2.job_uids == s3.job_uids
    assert a1["pe_rows"].size == a2["pe_rows"].size == a3["pe_rows"].size
    # the rows carry the store's versions again
    row = restored.pods.key_row["default/p0-0"]
    assert restored.p_rv[row] == ts.get("Pod", "default/p0-0").meta.resource_version
    # the watch events queued meanwhile re-apply harmlessly
    restored.drain()
    s4, _ = build_fast_snapshot(restored, 1.0)
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(s4, field), getattr(s2, field), err_msg=field)


def test_mirror_checkpoint_rejects_foreign_lineage(tmp_path):
    store = port_store(_bigger_store())
    m = ArrayMirror(store, "volcano-tpu", "default")
    m.drain()
    ckpt = str(tmp_path / "mirror.ckpt")
    m.save_checkpoint(ckpt)
    younger = port_store(_bigger_store(n_nodes=2, n_jobs=1))  # fewer writes
    assert not ArrayMirror(younger, "volcano-tpu", "default").try_restore_checkpoint(ckpt)
    older_other = port_store(_bigger_store(n_nodes=20, n_jobs=10))  # more writes, other uid
    assert older_other.resource_version > store.resource_version
    assert not ArrayMirror(older_other, "volcano-tpu", "default").try_restore_checkpoint(ckpt)
    assert not ArrayMirror(store, "other-scheduler", "default").try_restore_checkpoint(ckpt)
    assert not ArrayMirror(store, "volcano-tpu", "default").try_restore_checkpoint(
        str(tmp_path / "missing.ckpt"))
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"not a checkpoint")
    m2 = ArrayMirror(store, "volcano-tpu", "default")
    assert not m2.try_restore_checkpoint(str(bad)) and not m2._synced


def test_scheduler_checkpoint_roundtrip_schedules_as_jax(tmp_path):
    """Run a cycle, checkpoint, add work, restart with mirrorCheckpoint:
    the restarted scheduler restores, binds what the JAX one restarted the
    same way binds, and what a scheduler that lists the cluster binds."""
    js = _bigger_store()
    ts, ts_full = port_store(js), port_store(js)
    jc = jconf.full_conf("tpu")
    jc.mirror_checkpoint = str(tmp_path / "jax.ckpt")
    tc = port_conf(jc)
    tc.mirror_checkpoint = str(tmp_path / "port.ckpt")
    binds = {}
    for name, store, conf, make, convert in (
            ("jax", js, jc, JScheduler, lambda k, o: o),
            ("port", ts, tc, Scheduler, _convert),
            ("full", ts_full, dataclasses.replace(tc, mirror_checkpoint=None), Scheduler,
             _convert)):
        sched = make(store, conf=conf)
        sched.prewarm(background=False) if name != "jax" else sched.prewarm()
        sched.run_once()
        assert sched.save_mirror_checkpoint() == (name != "full")
        # fresh objects a run: a store keeps (and a bind edits) the one it is given
        store.create("PodGroup", convert("PodGroup", build_podgroup("fresh", min_member=1)))
        store.create("Pod", convert("Pod", build_pod("fresh-0", group="fresh", cpu="250m")))
        again = make(store, conf=conf)
        if name == "jax":
            again.prewarm()
        else:
            again.prewarm(background=False)
        assert again.fast_cycle.restored_from_checkpoint == (name != "full")
        again.run_once()
        assert "default/fresh-0" in dict(again.cache.bind_log)
        binds[name] = (list(sched.cache.bind_log), list(again.cache.bind_log))
    assert binds["port"] == binds["jax"] == binds["full"]


def test_checkpoint_skipped_while_decisions_are_queued(tmp_path):
    import threading

    conf = tconf.full_conf("cpu")
    conf.apply_mode = "async"
    conf.mirror_checkpoint = str(tmp_path / "m.ckpt")
    store = port_store(_store())
    sched = Scheduler(store, conf=conf)
    gate = threading.Event()
    orig = store.apply_segment
    store.apply_segment = lambda seg: (gate.wait(30), orig(seg))[1]
    try:
        sched.run_once()
        assert sched.cache.applier.pending
        assert not sched.save_mirror_checkpoint()
    finally:
        gate.set()
        sched.cache.applier.flush(timeout=30)
    assert sched.save_mirror_checkpoint()
    sched.close()


def test_checkpoint_after_the_write_back_rereads_only_what_changed(tmp_path, monkeypatch):
    """The save drains the watch first: after an async cycle whose binds
    landed, a restore re-reads only the objects that changed since the
    save (one new pod), not every pod the cycle bound."""
    conf = tconf.full_conf("cpu")
    conf.apply_mode = "async"
    conf.mirror_checkpoint = str(tmp_path / "m.ckpt")
    store = port_store(_bigger_store())
    sched = Scheduler(store, conf=conf)
    sched.run_once()
    assert sched.cache.applier.flush(timeout=30) and len(sched.cache.bind_log) == 24
    assert sched.save_mirror_checkpoint()
    sched.close()
    store.create("Pod", _convert("Pod", build_pod("late", group="pg2", cpu="250m")))
    ingested = []
    orig = ArrayMirror._on_pod
    monkeypatch.setattr(ArrayMirror, "_on_pod",
                        lambda self, pod: (ingested.append(pod.meta.key), orig(self, pod))[1])
    restored = ArrayMirror(store, "volcano-tpu", "default")
    assert restored.try_restore_checkpoint(conf.mirror_checkpoint)
    assert ingested == ["default/late"]
