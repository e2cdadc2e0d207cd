"""The port's leader election and retry backoff against the JAX package's.

* ``leader.LeaderElector`` over the port's store: the leader cases of
  ``tests/test_observability.py`` (one winner, renewal, takeover after the
  lease expires, a release hands off, a standby Scheduler binds nothing
  until it takes over), the lease's compare-and-swap (``Store.update_cas``
  raising ``Conflict``), and the candidate's paced retries; each sequence
  of acquisitions equals the JAX elector's under the same clock.
* ``backoff.Backoff``: the same seeded delay stream as the JAX class,
  capped, reset to its base, argument checks.
* An async scheduler deposed with its decisions still queued: the standby
  cycle drops them (``AsyncApplier.abort_pending``) and rebuilds its mirror
  from the store (``FastCycle.reset_after_abort``); nothing it decided
  lands, and once it leads again its next cycle binds what the JAX
  Scheduler's does through the same sequence (binds, pods, PodGroup
  statuses; tolerance: exact).
"""

import threading

import numpy as np
import pytest
import torch

from volcano_tpu import backoff as jbackoff
from volcano_tpu import leader as jleader
from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
from volcano_tpu.store import Store as JStore
from volcano_tpu_torch import backoff as tbackoff
from volcano_tpu_torch import leader as tleader
from volcano_tpu_torch.scheduler import conf as tconf
from volcano_tpu_torch.scheduler.scheduler import Scheduler
from volcano_tpu_torch.store import Store
from volcano_tpu_torch.store.store import Conflict

from helpers import build_node, build_pod, build_podgroup, make_store
from test_torch_object import _outcome, port_conf, port_store
from test_torch_publish_wire import FLUSH_S, HeldApplier, caches  # noqa: F401  (fixture)

torch.set_num_threads(1)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


PACKAGES = [(tleader, Store), (jleader, JStore)]


def _pair(name="vt-scheduler", **kw):
    """([port a, port b, JAX a, JAX b], clock): two candidates over each
    package's store, one clock."""
    clock = FakeClock()
    out = []
    for mod, store_cls in PACKAGES:
        store = store_cls()
        out += [mod.LeaderElector(store, name, "a", clock=clock, **kw),
                mod.LeaderElector(store, name, "b", clock=clock, **kw)]
    return out, clock


def _both(electors, who):
    """try_acquire of the port's and the JAX elector ``who`` (0: a, 1: b);
    they must agree."""
    got = electors[who].try_acquire(), electors[2 + who].try_acquire()
    assert got[0] == got[1]
    return got[0]


def test_leader_election_single_winner():
    el, clock = _pair(lease_duration=15)
    assert _both(el, 0)
    assert not _both(el, 1)
    assert el[0].is_leader() and not el[1].is_leader()
    clock.t = 10
    assert _both(el, 0)  # renewal keeps the lease
    clock.t = 20
    assert not _both(el, 1)  # renewed at t=10, expires at t=25


def test_leader_election_takeover_after_expiry():
    el, clock = _pair(lease_duration=15)
    assert _both(el, 0)
    clock.t = 16  # a stopped renewing
    assert _both(el, 1)
    assert el[1].is_leader() and not el[0].is_leader()
    lease = el[0].store.get("Lease", "/vt-scheduler")
    assert lease.transitions == el[2].store.get("Lease", "/vt-scheduler").transitions == 1


def test_leader_election_release_hands_off():
    el, clock = _pair(name="s")
    assert _both(el, 0)
    el[0].release()
    el[2].release()
    assert _both(el, 1)


def test_lost_candidates_pace_their_retries():
    """A loss backs the candidate off: until the backoff delay passes it
    answers False without a store round trip, as the JAX elector does."""
    el, clock = _pair(lease_duration=15)
    for e in el:
        e.backoff = (tbackoff if e.__class__.__module__.startswith("volcano_tpu_torch")
                     else jbackoff).Backoff(base=1.0, cap=4.0, seed=7)
    assert _both(el, 0)
    calls = {"n": 0}
    orig = el[1].store.get

    def counted(kind, key):
        calls["n"] += 1
        return orig(kind, key)

    el[1].store.get = counted
    seq = []
    for step in range(12):
        clock.t = 0.5 * step
        seq.append(_both(el, 1))
    assert not any(seq)
    assert calls["n"] < 12  # paced: most calls made no store round trip


def test_update_cas_conflict():
    from volcano_tpu_torch.api.objects import Metadata

    store = Store()
    lease = tleader.Lease(meta=Metadata(name="l", namespace=""), holder="a")
    store.create("Lease", lease)
    rv = lease.meta.resource_version
    lease.renewed_at = 1.0
    store.update_cas("Lease", lease, rv)
    with pytest.raises(Conflict):
        lease.renewed_at = 2.0
        store.update_cas("Lease", lease, rv)
    with pytest.raises(KeyError):
        store.update_cas("Lease", tleader.Lease(meta=Metadata(name="x", namespace="")), 0)
    assert store.uid != Store().uid


def _one_gang_store():
    return make_store(nodes=[build_node("n1")],
                      podgroups=[build_podgroup("pg", min_member=1)],
                      pods=[build_pod("p0", group="pg")])


def test_standby_scheduler_does_not_bind():
    clock = FakeClock()
    store = port_store(_one_gang_store())
    conf = tconf.default_conf("cpu")
    leader = Scheduler(store, conf=conf,
                       elector=tleader.LeaderElector(store, "sched", "leader", clock=clock))
    standby = Scheduler(store, conf=tconf.default_conf("cpu"),
                        elector=tleader.LeaderElector(store, "sched", "standby", clock=clock))
    leader.run_once()
    standby.run_once()
    assert leader.cache.bind_log and not standby.cache.bind_log
    assert standby.last_path == "standby"

    # the leader dies; the standby takes over once the lease expires
    store2 = port_store(_one_gang_store())
    clock2 = FakeClock()
    dead = tleader.LeaderElector(store2, "sched", "dead", clock=clock2)
    assert dead.try_acquire()
    standby2 = Scheduler(store2, conf=tconf.default_conf("cpu"),
                         elector=tleader.LeaderElector(store2, "sched", "standby",
                                                       clock=clock2))
    standby2.run_once()
    assert not standby2.cache.bind_log
    clock2.t = 20.0
    standby2.run_once()
    assert standby2.cache.bind_log == [("default/p0", "n1")]


def test_backoff_stream_equals_jax():
    for seed in (0, 3, 11):
        t, j = tbackoff.Backoff(base=0.05, cap=2.0, seed=seed), jbackoff.Backoff(
            base=0.05, cap=2.0, seed=seed)
        got = [t.next() for _ in range(40)]
        assert got == [j.next() for _ in range(40)]
        assert got[0] == 0.05 and max(got) <= 2.0 and min(got) >= 0.05
        t.reset()
        assert t.next() == 0.05
    slept = []
    b = tbackoff.Backoff(base=0.1, cap=0.1, seed=1)
    assert b.sleep(slept.append) == 0.1 and slept == [0.1]
    for base, cap in ((0.0, 1.0), (2.0, 1.0)):
        with pytest.raises(ValueError):
            tbackoff.Backoff(base=base, cap=cap)


def _cluster():
    """Two nodes and six gangs of two tasks."""
    return make_store(
        nodes=[build_node(f"n{i}", cpu="4", memory="8Gi") for i in range(2)],
        podgroups=[build_podgroup(f"j{g}", min_member=2) for g in range(6)],
        pods=[build_pod(f"p{g}-{k}", group=f"j{g}", cpu="500m") for g in range(6)
              for k in range(2)])


def _occupy(applier):
    """A status op that the held applier thread takes and blocks on, so
    that the next cycle's decisions stay queued behind it."""
    applier.submit_ops([{"op": "patch", "kind": "PodGroup", "key": "default/j0", "fields": {}}])
    for _ in range(2000):
        if applier.pending == 1 and not applier._q:
            return
        threading.Event().wait(0.005)
    raise AssertionError("the applier did not take the status op")


def _deposed_run(monkeypatch, sched, store, rival, clock):
    """Lead one cycle with the write-back held, lose the lease, stand by
    (dropping the queued decisions), then lead again; returns what was
    dropped."""
    held = HeldApplier(monkeypatch, store)
    held.hold()
    applier = sched.cache.applier
    try:
        _occupy(applier)
        sched.run_once()
        assert sched.cache.bind_log and applier.inflight_binds
        if isinstance(sched, Scheduler):
            assert sched.last_path == "fast"
        clock.t = 20.0  # the lease (15 s) expired: the rival takes it
        assert rival.try_acquire()
        sched.run_once()
        if isinstance(sched, Scheduler):
            assert sched.last_path == "standby"
        dropped = dict(sched.cache.bind_log)
        assert applier.inflight_view() == ({}, {})
    finally:
        held.release()
    assert applier.flush(timeout=FLUSH_S)
    assert all(not p.node_name for p in store.list("Pod"))  # nothing landed
    clock.t = 40.0  # the rival never renewed
    sched.run_once()
    assert applier.flush(timeout=FLUSH_S)
    return dropped


def test_async_standby_drops_queued_decisions_then_equals_jax(caches, monkeypatch):  # noqa: F811
    js = _cluster()
    ts = port_store(js)
    jc = jconf.full_conf("tpu")
    jc.apply_mode = "async"
    jc.exact_topk = True
    tc = port_conf(jc)
    tc.apply_mode = "async"
    runs = []
    for store, mod, make, conf in ((js, jleader, JScheduler, jc), (ts, tleader, Scheduler, tc)):
        clock = FakeClock()
        sched = make(store, conf=conf,
                     elector=mod.LeaderElector(store, "sched", "a", clock=clock))
        caches.append(sched.cache)
        rival = mod.LeaderElector(store, "sched", "b", clock=clock)
        if isinstance(sched, Scheduler):
            reset = []
            orig = sched.fast_cycle.reset_after_abort
            monkeypatch.setattr(sched.fast_cycle, "reset_after_abort",
                                lambda: (reset.append(1), orig())[1])
        dropped = _deposed_run(monkeypatch, sched, store, rival, clock)
        runs.append((store, sched, dropped))
    (js_, jsched, jdropped), (ts_, tsched, tdropped) = runs
    assert reset == [1]
    assert tdropped == jdropped and len(tdropped) == 12
    # the mirror was rebuilt from the store: no row kept the dropped binds
    # before the cycle that led again bound them
    jo, to = _outcome(js_, jsched), _outcome(ts_, tsched)
    for key in ("binds", "pods", "groups"):
        assert to[key] == jo[key], key
    assert sum(1 for p in ts_.list("Pod") if p.node_name) == 12
    m = tsched.fast_cycle.mirror
    live = np.nonzero(m.p_live)[0]
    assert (m.p_node[live] >= 0).all()
