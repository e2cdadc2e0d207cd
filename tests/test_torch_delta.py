"""Incremental scheduling (``delta: on``) in the port against the JAX package.

Each scenario of ``tests/test_delta.py`` is built once with the JAX test
helpers and copied object by object, uids kept, into the port's store
(``test_torch_object.port_store``); every later event (gang arrivals, pod
and group deletions, node churn, queue moves) goes to both stores.  The
JAX ``Scheduler`` (backend ``tpu``) and the port's (backend ``cpu``) run
the same conf with ``delta: on`` cycle by cycle and must give, after every
cycle, the same bind log, evictions, pods, PodGroup phases and conditions
(``Backlogged`` included) and the same (mode, fallback reason) of the
delta engine.  The port's ``snapshot-incremental`` oracle is on in every
case but the timed shape case, so each of its micro builds also equals a
full build bit for bit.  Tolerance: exact everywhere (decisions, counters,
condition texts); no case reads the wall clock.
"""

import random
import threading

import pytest
import torch

from volcano_tpu import timeseries as jts
from volcano_tpu.api.objects import Metadata as JMetadata
from volcano_tpu.api.objects import PriorityClass as JPriorityClass
from volcano_tpu.api.types import PodPhase as JPodPhase
from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler import metrics as jmetrics
from volcano_tpu.scheduler.delta import engine as jengine
from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
from volcano_tpu_torch import timeseries as tts
from volcano_tpu_torch.scheduler import conf as tconf
from volcano_tpu_torch.scheduler import metrics as tmetrics
from volcano_tpu_torch.scheduler.delta import DirtySet
from volcano_tpu_torch.scheduler.delta import engine as tengine
from volcano_tpu_torch.scheduler.scheduler import Scheduler

from helpers import build_node, build_pod, build_podgroup, build_queue, make_store
from test_delta import _mixed_store, _starved_store, _trickle_store
from test_torch_object import _convert, _outcome, port_conf, port_store

torch.set_num_threads(1)

DELTA_KEYS = ("delta", "delta_admit_qps", "delta_burst", "delta_high_watermark",
              "delta_low_watermark", "delta_oracle")


@pytest.fixture(autouse=True)
def _clean():
    for mod in (jmetrics, tmetrics):
        mod.reset()
    for mod in (jts, tts):
        mod.disarm()
    yield
    for mod in (jts, tts):
        mod.disarm()
    for mod in (jmetrics, tmetrics):
        mod.reset()


def _confs(base="default", apply_mode="sync", **kw):
    """The JAX conf (backend tpu, delta on, its oracle on) and the port's."""
    jc = getattr(jconf, f"{base}_conf")("tpu")
    jc.delta = "on"
    jc.delta_oracle = True
    for k, v in kw.items():
        setattr(jc, k, v)
    tc = port_conf(jc)
    for k in DELTA_KEYS:
        setattr(tc, k, getattr(jc, k))
    tc.apply_mode = apply_mode
    return jc, tc


class Stores:
    """A JAX store and its port copy; every event goes to both."""

    def __init__(self, jstore, jc, tc):
        self.js, self.ts = jstore, port_store(jstore)
        self.jsched = JScheduler(self.js, conf=jc)
        self.tsched = Scheduler(self.ts, conf=tc)
        self.n = 0

    def cycle(self):
        self.jsched.run_once()
        self.tsched.run_once()

    def create(self, kind, obj):
        self.js.create(kind, obj)
        self.ts.create(kind, _convert(kind, obj))

    def delete(self, kind, key):
        self.js.delete(kind, key)
        self.ts.delete(kind, key)

    def patch(self, kind, key, fields):
        self.js.patch(kind, key, fields)
        self.ts.patch(kind, key, fields)


class Twin(Stores):
    """``cycle()`` runs one cycle of each scheduler and checks them equal."""

    def modes(self):
        """(mode, fallback_reason) of each engine's last build."""
        return tuple((s.fast_cycle.delta.last["mode"], s.fast_cycle.delta.last["fallback_reason"])
                     for s in (self.jsched, self.tsched))

    def cycle(self):
        self.jsched.run_once()
        self.tsched.run_once()
        applier = self.tsched.cache.applier
        if applier is not None:
            assert applier.flush(60.0)
        jo, to = _outcome(self.js, self.jsched), _outcome(self.ts, self.tsched)
        for key in ("binds", "evicts", "pods", "groups"):
            assert to[key] == jo[key], f"cycle {self.n}: {key}"
        jm, tm = self.modes()
        assert tm == jm, f"cycle {self.n}: (mode, reason)"
        for k in ("backlog_gangs", "held_gangs", "shed_gangs"):
            assert (self.tsched.fast_cycle.delta.last[k]
                    == self.jsched.fast_cycle.delta.last[k]), f"cycle {self.n}: {k}"
        self.n += 1
        return tm

    def close(self):
        self.tsched.close()


def _micro(pkg_metrics):
    return pkg_metrics.get_counter("volcano_delta_micro_cycles_total")


def _fuzz(twin, rng, steps):
    """tests/test_delta.py's event stream on both stores: gang arrivals,
    gang deletions, node adds and queue moves, a cycle after each step."""
    created = []
    for step in range(steps):
        ev = rng.random()
        if ev < 0.55 or not created:
            name = f"fz{step:03d}"
            twin.create("PodGroup", build_podgroup(name, min_member=1,
                                                   queue=rng.choice(["qa", "qb"])))
            for t in range(rng.randint(1, 3)):
                twin.create("Pod", build_pod(f"{name}-{t}", group=name,
                                             cpu=rng.choice(["100m", "250m"]),
                                             memory="128Mi", priority=rng.choice([0, 5])))
            created.append(name)
        elif ev < 0.75:
            victim = created.pop(rng.randrange(len(created)))
            for p in list(twin.js.list("Pod")):
                if p.meta.name.startswith(victim + "-"):
                    twin.delete("Pod", f"{p.meta.namespace}/{p.meta.name}")
            twin.delete("PodGroup", f"default/{victim}")
        elif ev < 0.9:
            twin.create("Node", build_node(f"nx{step:03d}", cpu="4", memory="8Gi"))
        else:
            victim = rng.choice(created)
            pg = twin.js.get("PodGroup", f"default/{victim}")
            if pg is not None:
                twin.patch("PodGroup", f"default/{victim}",
                           {"queue": "qb" if pg.queue == "qa" else "qa"})
        twin.cycle()


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_equals_jax_cycle_by_cycle(seed):
    """The randomized stream of test_micro_cycle_snapshot_parity_fuzz:
    every cycle equal to JAX's, every port micro build equal to its full
    build (the oracle raises inside run_once otherwise), and micro cycles
    the bulk of the stream."""
    twin = Twin(_mixed_store(seed), *_confs())
    twin.cycle()
    _fuzz(twin, random.Random(1000 + seed), steps=25)
    assert _micro(tmetrics) == _micro(jmetrics) >= 10


@pytest.mark.parametrize("apply_mode", ["sync", "async"])
@pytest.mark.parametrize("seed", range(4))
def test_delta_binds_equal_full_replay_and_jax(seed, apply_mode, monkeypatch):
    """test_delta_binds_equal_full_cycle_replay in both publish modes: the
    port with delta on (cycle by cycle equal to JAX's) and the port with
    delta off replay the same stream into the same bind log.  Under the
    async applier only the cycle's thread feeds the dirty set."""
    feeders = set()
    for name in ("pod", "pods_many", "structural"):
        orig = getattr(DirtySet, name)

        def spy(self, *a, _orig=orig):
            feeders.add(threading.current_thread().name)
            return _orig(self, *a)

        monkeypatch.setattr(DirtySet, name, spy)
    twin = Twin(_mixed_store(seed), *_confs(apply_mode=apply_mode))
    try:
        twin.cycle()
        _fuzz(twin, random.Random(2000 + seed), steps=20)
        if apply_mode == "async":
            assert twin.tsched.cache.applier is not None
    finally:
        twin.close()
    assert feeders == {threading.current_thread().name}
    delta_log = list(twin.tsched.cache.bind_log)

    jc_off = jconf.default_conf("tpu")
    replay = Stores(_mixed_store(seed), jc_off, port_conf(jc_off))
    assert replay.tsched.fast_cycle.delta is None
    replay.cycle()
    _fuzz(replay, random.Random(2000 + seed), steps=20)
    assert list(replay.tsched.cache.bind_log) == delta_log
    assert list(replay.jsched.cache.bind_log) == delta_log
    assert len(delta_log) > 5


def test_structural_events_force_full_with_reason_then_micro_resumes():
    twin = Twin(_mixed_store(3), *_confs(base="full"))
    assert twin.cycle() == ("full", "arm")
    assert twin.cycle()[0] == "micro"
    twin.create("Node", build_node("late", cpu="8", memory="16Gi"))
    assert twin.cycle() == ("full", "node-add")
    assert twin.cycle()[0] == "micro"
    twin.delete("Node", "/late")
    assert twin.cycle() == ("full", "node-remove")
    pg5 = twin.js.get("PodGroup", "default/job5")
    twin.patch("PodGroup", "default/job5", {"queue": "qb" if pg5.queue == "qa" else "qa"})
    assert twin.cycle() == ("full", "job-requeue")
    for p in list(twin.js.list("Pod")):
        if p.meta.name.startswith("job5-"):
            twin.delete("Pod", f"{p.meta.namespace}/{p.meta.name}")
    twin.delete("PodGroup", "default/job5")
    assert twin.cycle() == ("full", "job-remove")
    assert twin.cycle()[0] == "micro"


def test_dirty_storm_falls_back(monkeypatch):
    twin = Twin(_mixed_store(0, n_jobs=2, running_jobs=0), *_confs())
    for _ in range(3):  # arm, then the first cycle's own bind echoes
        twin.cycle()
    assert twin.modes()[1][0] == "micro"
    monkeypatch.setattr(jengine, "DIRTY_STORM", 4)
    monkeypatch.setattr(tengine, "DIRTY_STORM", 4)
    for i in range(4):
        twin.create("PodGroup", build_podgroup(f"w{i}", min_member=1, queue="qa"))
        for t in range(2):
            twin.create("Pod", build_pod(f"w{i}-{t}", group=f"w{i}", cpu="100m",
                                         memory="128Mi"))
    assert twin.cycle() == ("full", "dirty-storm")
    # the wave's own bind echoes may trip the shrunk bound once more
    for _ in range(3):
        twin.cycle()
    assert twin.modes()[1][0] == "micro"


def test_contention_wave_rebuilds_full_with_reason():
    """A preempt wave in steady micro state: the same cycle rebuilds full
    (reason ``contention``) before the victim pool, in both packages, with
    the same evictions, and the urgent gang lands after the reap."""
    store = make_store(nodes=[build_node(f"n{i}", cpu="4", memory="8Gi") for i in range(4)],
                       queues=[build_queue("qa", weight=1), build_queue("default")],
                       podgroups=[], pods=[])
    store.create("PriorityClass", JPriorityClass(meta=JMetadata(name="urgent", namespace=""),
                                                 value=10))
    store.create("PriorityClass", JPriorityClass(meta=JMetadata(name="low", namespace=""),
                                                 value=1))
    for i in range(8):
        pg = build_podgroup(f"low{i}", min_member=1, queue="qa")
        pg.priority_class_name = "low"
        store.create("PodGroup", pg)
        store.create("Pod", build_pod(f"low{i}-0", group=f"low{i}", cpu="2", memory="2Gi",
                                      priority=1, node_name=f"n{i % 4}",
                                      phase=JPodPhase.RUNNING))
    twin = Twin(store, *_confs(base="full"))
    for _ in range(3):
        twin.cycle()
    assert twin.modes()[1][0] == "micro"
    hi = build_podgroup("hi", min_member=2, queue="qa")
    hi.priority_class_name = "urgent"
    twin.create("PodGroup", hi)
    for t in range(2):
        twin.create("Pod", build_pod(f"hi-{t}", group="hi", cpu="2", memory="2Gi", priority=10))
    assert twin.cycle() == ("full", "contention")
    for pkg in (jmetrics, tmetrics):
        assert pkg.get_counter("volcano_delta_full_fallbacks_total", reason="contention") == 1
    evicted = [k for k, _ in twin.tsched.cache.evict_log]
    assert evicted
    for key in evicted:  # the kubelet reaps the victims
        twin.delete("Pod", key)
    for _ in range(3):
        twin.cycle()
    hi_pods = [p for p in twin.ts.list("Pod") if p.meta.name.startswith("hi-")]
    assert hi_pods and all(p.node_name for p in hi_pods)


def _submit_backlog(twin, n, cpu="4", prio=None):
    for i in range(n):
        twin.create("PodGroup", build_podgroup(f"g{i}", min_member=1, queue="default"))
        twin.create("Pod", build_pod(f"g{i}-0", group=f"g{i}", cpu=cpu, memory="4Gi",
                                     priority=(prio(i) if prio else 0)))


def test_token_bucket_admission_holds_then_drains():
    """rate 2 gangs/s, burst 2, on one injected clock for both packages:
    the burst admits two, the rest are held and drain as the clock moves,
    each gang charged once."""
    clock = [0.0]
    store = make_store(nodes=[build_node("n0", cpu="16", memory="32Gi")],
                       queues=[build_queue("default")], podgroups=[], pods=[])
    twin = Twin(store, *_confs(delta_admit_qps=2.0, delta_burst=2))
    twin.cycle()
    for s in (twin.jsched, twin.tsched):
        bucket = s.fast_cycle.delta.admission.bucket
        bucket._now = lambda: clock[0]
        bucket._last = 0.0
    _submit_backlog(twin, 6, cpu="100m")
    bound = lambda: sum(1 for p in twin.ts.list("Pod") if p.node_name)  # noqa: E731
    twin.cycle()
    last = twin.tsched.fast_cycle.delta.last
    assert (last["backlog_gangs"], last["held_gangs"], bound()) == (6, 4, 2)
    twin.cycle()
    assert (twin.tsched.fast_cycle.delta.last["held_gangs"], bound()) == (4, 2)
    clock[0] = 1.0
    twin.cycle()
    assert (twin.tsched.fast_cycle.delta.last["held_gangs"], bound()) == (2, 4)
    clock[0] = 2.0
    twin.cycle()
    assert (twin.tsched.fast_cycle.delta.last["held_gangs"], bound()) == (0, 6)
    twin.cycle()
    assert twin.tsched.fast_cycle.delta.last["backlog_gangs"] == 0
    assert twin.tsched.fast_cycle.delta.admission.admitted == set()


def test_shed_to_backlogged_condition_and_readmit():
    """Above the high watermark the lowest-priority gangs get the
    Backlogged condition (their pods stay), sticky across cycles with a
    flat counter, and it clears at the low watermark: the conditions equal
    JAX's after every cycle (the twin compares every PodGroup's)."""
    twin = Twin(_starved_store(), *_confs(delta_high_watermark=4))
    twin.cycle()
    _submit_backlog(twin, 8, prio=lambda i: 8 - i)
    twin.cycle()
    last = twin.tsched.fast_cycle.delta.last
    assert (last["backlog_gangs"], last["shed_gangs"]) == (8, 4)
    shed = {pg.meta.name for pg in twin.ts.list("PodGroup")
            if any(c.kind == "Backlogged" for c in pg.status.conditions)}
    assert shed == {"g4", "g5", "g6", "g7"}
    for pg in twin.ts.list("PodGroup"):
        for c in pg.status.conditions:
            if c.kind == "Backlogged":
                assert (c.status, c.reason) == ("True", "AdmissionShed")
    assert len(twin.ts.list("Pod")) == 8
    twin.cycle()
    for pkg in (jmetrics, tmetrics):
        assert pkg.get_counter("volcano_delta_shed_gangs_total") == 4
    for i in range(6):
        if f"g{i}" not in shed:
            twin.delete("Pod", f"default/g{i}-0")
            twin.delete("PodGroup", f"default/g{i}")
    for n in sorted(shed)[:2]:
        twin.delete("Pod", f"default/{n}-0")
        twin.delete("PodGroup", f"default/{n}")
    twin.cycle()
    last = twin.tsched.fast_cycle.delta.last
    assert (last["backlog_gangs"], last["shed_gangs"]) == (2, 0)
    for pg in twin.ts.list("PodGroup"):
        assert not any(c.kind == "Backlogged" for c in pg.status.conditions)


def _delta_lines(text):
    return [ln for ln in text.splitlines() if "volcano_delta_" in ln]


def test_delta_metrics_exposition_equals_jax():
    """The three delta families' exposition lines, HELP and TYPE included,
    byte-equal to the JAX registry's after the same cycles."""
    twin = Twin(_mixed_store(2), *_confs(delta_high_watermark=1))
    for _ in range(3):
        twin.cycle()
    got = _delta_lines(tmetrics.expose_text())
    assert got == _delta_lines(jmetrics.expose_text())
    text = "\n".join(got)
    assert 'volcano_delta_full_fallbacks_total{reason="arm"} 1' in text
    assert "# HELP volcano_delta_micro_cycles_total" in text
    assert "volcano_delta_shed_gangs_total" in text


_ROW_KEYS = ("path", "cycle", "binds", "backlog", "evictions", "residue_jobs", "mode",
             "fallback_reason", "backlog_gangs", "held_gangs", "shed_gangs")


def test_cycle_rows_carry_mode_and_reason_as_jax():
    """Armed recorders: each cycle's row has the JAX row's fields and values
    (wall times aside; the phase names equal)."""
    jts.arm()
    tts.arm()
    twin = Twin(_mixed_store(1), *_confs())
    twin.cycle()
    twin.create("PodGroup", build_podgroup("late", min_member=1, queue="qa"))
    twin.create("Pod", build_pod("late-0", group="late", cpu="100m", memory="128Mi"))
    twin.cycle()
    jrows = [s for s in jts.samples() if s["kind"] == "cycle"]
    trows = [s for s in tts.samples() if s["kind"] == "cycle"]
    assert len(trows) == len(jrows) == 2
    for jr, tr in zip(jrows, trows):
        assert {k: tr.get(k) for k in _ROW_KEYS} == {k: jr.get(k) for k in _ROW_KEYS}
        assert set(tr["phases"]) == set(jr["phases"])
    assert (trows[0]["mode"], trows[0]["fallback_reason"]) == ("full", "arm")
    assert trows[-1]["mode"] == "micro" and trows[-1]["binds"] == 1


def test_checkpoint_restore_falls_back_with_arm(tmp_path):
    """A scheduler restored from its mirror checkpoint starts on a full
    build with reason ``arm`` (the hook is never pickled; the new engine
    arms the restored mirror), then micro cycles resume, as in JAX."""
    jc, tc = _confs(mirror_checkpoint=str(tmp_path / "jax.ckpt"))
    tc.mirror_checkpoint = str(tmp_path / "port.ckpt")
    twin = Twin(_mixed_store(4), jc, tc)
    twin.cycle()
    twin.cycle()
    assert twin.jsched.save_mirror_checkpoint() and twin.tsched.save_mirror_checkpoint()
    twin.create("PodGroup", build_podgroup("cold", min_member=1, queue="qa"))
    twin.create("Pod", build_pod("cold-0", group="cold", cpu="100m", memory="128Mi"))
    twin.jsched = JScheduler(twin.js, conf=jc)
    twin.tsched = Scheduler(twin.ts, conf=tc)
    assert twin.cycle() == ("full", "arm")
    assert twin.tsched.fast_cycle.restored_from_checkpoint
    assert twin.tsched.fast_cycle.mirror.delta_hook is twin.tsched.fast_cycle.delta.dirty
    assert twin.cycle()[0] == "micro"


def test_fifty_micro_cycles_keep_one_launch_shape(monkeypatch):
    """The port's counterpart of the JAX compile-counter case: after the
    warm-up, 50 trickle cycles (1-5 tasks a gang, admission on) are all
    micro builds, hand the allocate solve one (T, N, J, Q, C) shape, add no
    key to the victim kernels' per-shape workspaces and load or build no
    kernel library."""
    from volcano_tpu_torch import _build
    from volcano_tpu_torch.scheduler import victim_kernels
    from volcano_tpu_torch.scheduler.fastpath import cycle as cycle_mod

    store = port_store(_trickle_store())
    conf = tconf.default_conf("cpu")
    conf.delta, conf.delta_admit_qps = "on", 1e9
    sched = Scheduler(store, conf=conf)

    def gang(name, n):
        store.create("PodGroup", _convert("PodGroup", build_podgroup(name, min_member=n)))
        for t in range(n):
            store.create("Pod", _convert("Pod", build_pod(f"{name}-{t}", group=name,
                                                           cpu="10m", memory="16Mi")))

    for i in range(70):  # the J bucket pinned at 128 through the trickle
        gang(f"w{i:03d}", 1)
    sched.run_once()
    for i in range(2):
        gang(f"t{i:03d}", 1)
        sched.run_once()
    shapes = []
    orig = cycle_mod.torch_allocate_solve

    def spy(backend, snap, *a, **kw):
        shapes.append((snap.task_req.shape[0], snap.node_idle.shape[0],
                       snap.job_queue.shape[0], snap.queue_weight.shape[0],
                       snap.class_node_mask.shape[0]))
        return orig(backend, snap, *a, **kw)

    def no_build(*a, **kw):
        raise AssertionError("a micro cycle loaded or built the kernel library")

    monkeypatch.setattr(cycle_mod, "torch_allocate_solve", spy)
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    ws_before = set(victim_kernels._WORKSPACES)
    micro0 = _micro(tmetrics)
    for i in range(50):
        gang(f"k{i:03d}", 1 + (i % 5))
        sched.run_once()
        assert sched.fast_cycle.delta.last["mode"] == "micro", i
    assert _micro(tmetrics) - micro0 == 50
    assert len(shapes) == 50 and len(set(shapes)) == 1, sorted(set(shapes))
    assert set(victim_kernels._WORKSPACES) == ws_before
    assert all(p.node_name for p in store.list("Pod"))


def test_pod_joining_a_live_gang_is_a_dirty_row():
    """A pod created for a group the mirror already holds dirties only its
    own row (no structural event): the micro build must count it, as the
    oracle checks, and place it as JAX does."""
    twin = Twin(_mixed_store(6, running_jobs=0), *_confs())
    twin.cycle()
    twin.cycle()
    for t in range(3):
        twin.create("Pod", build_pod(f"job1-x{t}", group="job1", cpu="250m", memory="128Mi"))
        assert twin.cycle()[0] == "micro"


def test_podgroup_without_pods_past_the_row_capacity_builds_micro():
    """A PodGroup whose pods have not arrived takes a new job row; past the
    mirror's row capacity (64 here) the JAX engine's micro gather indexes
    past its accumulators and raises IndexError.  The port's aggregates
    follow the mirror's rows: the cycle builds micro (the oracle holds it
    to a full build) and the gang binds once its pod arrives."""
    jstore = make_store(nodes=[build_node("n0", cpu="64", memory="64Gi")],
                        queues=[build_queue("default")], podgroups=[], pods=[])
    for i in range(63):
        jstore.create("PodGroup", build_podgroup(f"g{i}"))
        jstore.create("Pod", build_pod(f"g{i}-0", group=f"g{i}", cpu="10m", memory="1Mi"))
    store = port_store(jstore)
    _, tc = _confs()
    sched = Scheduler(store, conf=tc)
    sched.run_once()
    sched.run_once()
    assert len(sched.fast_cycle.mirror.j_live) == 64
    for name in ("late0", "late1"):
        store.create("PodGroup", _convert("PodGroup", build_podgroup(name)))
    sched.run_once()
    assert sched.fast_cycle.delta.last["mode"] == "micro"
    store.create("Pod", _convert("Pod", build_pod("late1-0", group="late1", cpu="10m",
                                                   memory="1Mi")))
    sched.run_once()
    assert sched.fast_cycle.delta.last["mode"] == "micro"
    assert store.get("Pod", "default/late1-0").node_name == "n0"
