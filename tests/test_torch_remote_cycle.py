"""The port's Scheduler through its apiserver in another process, against
the JAX Scheduler through the JAX apiserver (config 7's topology at a small
size), and the mirror's relist when its watch falls off the event log.

Both servers are spawned as processes of their own (``python -m
volcano_tpu_torch.store.server`` and a JAX ``StoreServer`` in a ``python
-c`` child), on 127.0.0.1 port 0.  A seeded cluster (64 nodes, 40 gangs of
20 and 10 best-effort pods, more than the nodes hold) is built in the JAX
package, copied uid for uid into the port's objects
(``tests/test_torch_object.py`` ``port_store``) and loaded into each
server through its own package's ``RemoteStore.bulk``.  Then the JAX
``Scheduler`` on a JAX ``RemoteStore`` and ``Scheduler(backend="cpu")`` on
the port's run three cycles under ``apply_mode: async``, each applier
flushed after its cycle; before cycles 2 and 3 both stores lose the pods of
the first bound gangs (the kubelet's completion), so that later cycles bind
anew.  After every cycle the binds, the PodGroup statuses (phase, running,
conditions) and the Events by (involved, reason, message, type, count)
must be equal.
"""

import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch

from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
from volcano_tpu.store.client import RemoteStore as JRemoteStore
from volcano_tpu_torch.scheduler import conf as tconf
from volcano_tpu_torch.scheduler.scheduler import Scheduler
from volcano_tpu_torch.store import Store
from volcano_tpu_torch.store.client import RemoteStore, wait_healthy
from volcano_tpu_torch.store.server import StoreServer

from test_torch_cycle import cfg5_shaped_spec, jax_store_from_spec
from test_torch_object import port_store

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
KINDS = ("Queue", "PriorityClass", "Node", "PodGroup", "Pod")
FLUSH_S = 60.0

_JAX_SERVER = (
    "import sys, threading\n"
    "from volcano_tpu.store.server import StoreServer\n"
    "srv = StoreServer().start()\n"
    "print('apiserver listening on ' + srv.url, flush=True)\n"
    "sys.stdin.read()\n"  # serve until the parent closes the pipe
    "srv.stop()\n"
)


@pytest.fixture(autouse=True)
def _op_determined_seqs(monkeypatch):
    """The digest beacons take seqs on a wall-clock cadence (1 s by
    default), so a slow run would slip one in where these cases expect
    only their own writes: the cadence is pinned past each case, as
    ``tests/test_procmesh.py:118`` does.  The digest stays armed;
    ``stamp_beacon`` still stamps one on demand."""
    monkeypatch.setenv("VOLCANO_TPU_AUDIT_BEACON_S", "3600")


class _Spawned:
    """An apiserver in a process of its own; its URL from its first line."""

    def __init__(self, argv):
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        self.proc = subprocess.Popen(argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True, cwd=str(REPO),
                                     env=env)
        line = self.proc.stdout.readline()
        if "listening on" not in line:
            self.close()
            raise RuntimeError(f"the apiserver did not start: {line!r}")
        self.url = line.strip().rsplit(" ", 1)[-1]
        assert wait_healthy(self.url, timeout=60)

    def close(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(10)


@pytest.fixture
def servers():
    port = _Spawned([sys.executable, "-m", "volcano_tpu_torch.store.server", "--port", "0",
                     "--no-default-queue"])
    try:
        jax = _Spawned([sys.executable, "-c", _JAX_SERVER])
    except Exception:
        port.close()
        raise
    try:
        yield port.url, jax.url
    finally:
        port.close()
        jax.close()


def _load(remote, store):
    ops = [{"op": "create", "kind": kind, "object": o}
           for kind in KINDS for o in store.list(kind)]
    for i in range(0, len(ops), 4000):
        assert not [e for e in remote.bulk(ops[i:i + 4000]) if e]


def _outcome(store, sched, since):
    groups = {g.meta.key: (g.status.phase.value, g.status.running,
                           [(c.kind, c.status, c.reason, c.message) for c in g.status.conditions])
              for g in store.list("PodGroup")}
    events = Counter((e.involved[0], e.involved[1], e.reason, e.message, e.type, e.count)
                     for e in store.list("Event"))
    pods = {p.meta.key: p.node_name for p in store.list("Pod")}
    return {"binds": list(sched.cache.bind_log[since:]), "groups": groups, "events": events,
            "pods": pods, "errs": [op for op, _, _ in sched.cache.err_log]}


def _complete(store, gangs):
    """The kubelet's completion: the pods of ``gangs`` leave the store."""
    for p in store.list("Pod"):
        if p.meta.name.split("-")[0] in gangs:
            store.delete("Pod", p.meta.key)


def test_remote_cycles_equal_jax_over_the_wire(servers):
    port_url, jax_url = servers
    spec = cfg5_shaped_spec(n_nodes=64, n_jobs=40, tasks_per_job=20, best_effort=10)
    for n in spec["nodes"]:  # fewer cores than the gangs ask: some wait
        n["allocatable"]["cpu"] = "4"
    jlocal = jax_store_from_spec(spec)
    jremote, tremote = JRemoteStore(jax_url), RemoteStore(port_url)
    _load(jremote, jlocal)
    _load(tremote, port_store(jlocal))
    jc = jconf.full_conf("tpu")
    jc.exact_topk = True
    jc.apply_mode = "async"
    tc = tconf.full_conf("cpu")
    tc.apply_mode = "async"
    jsched, tsched = JScheduler(jremote, conf=jc), Scheduler(tremote, conf=tc)
    try:
        since = 0
        per_cycle = []
        for cycle in range(3):
            jsched.run_once()
            tsched.run_once()
            assert jsched.cache.applier.flush(FLUSH_S) and tsched.cache.applier.flush(FLUSH_S)
            assert tsched.last_path == "fast"
            want = _outcome(JRemoteStore(jax_url), jsched, since)
            got = _outcome(RemoteStore(port_url), tsched, since)
            for key in ("binds", "groups", "events", "pods", "errs"):
                assert got[key] == want[key], (cycle, key)
            if cycle == 0:
                assert not all(got["pods"].values())  # some gangs wait
            per_cycle.append(len(got["binds"]))
            since = len(tsched.cache.bind_log)
            done = sorted({k.split("/")[1].split("-")[0] for k, _ in got["binds"]
                           if not k.split("/")[1].startswith("be")})[:4]
            _complete(jremote, done)
            _complete(tremote, done)
        assert all(per_cycle), per_cycle  # every cycle bound gangs anew
    finally:
        jsched.close() if hasattr(jsched, "close") else jsched.cache.applier.stop()
        tsched.close()


def test_forced_log_overflow_relists_and_converges(monkeypatch):
    """The port's mirror over a RemoteStore whose server keeps a tiny event
    log: cycle 1's write-back overflows it, the next drain gets StaleWatch,
    relists (``stale_relists`` rises) and the cycles go on to the state of
    the same cycles on an in-process Store."""
    from volcano_tpu_torch import interop
    from volcano_tpu_torch.store import server as server_mod

    monkeypatch.setattr(server_mod, "LOG_CAP", 64)
    spec = cfg5_shaped_spec(n_nodes=64, n_jobs=40, tasks_per_job=20, best_effort=10)
    for n in spec["nodes"]:
        n["allocatable"]["cpu"] = "4"
    srv = StoreServer().start()
    scheds = []
    try:
        remote = RemoteStore(srv.url)
        _load(remote, interop.store_from_spec(spec))
        local = Store()
        _load(local, interop.store_from_spec(spec))
        for store in (remote, local):
            tc = tconf.full_conf("cpu")
            tc.apply_mode = "async"
            scheds.append(Scheduler(store, conf=tc))
        rsched, lsched = scheds
        for cycle in range(3):
            for s in scheds:
                s.run_once()
                assert s.cache.applier.flush(FLUSH_S)
            assert rsched.cache.bind_log == lsched.cache.bind_log, cycle
            done = sorted({k.split("/")[1].split("-")[0] for k, _ in rsched.cache.bind_log
                           if not k.split("/")[1].startswith("be")})[:4]
            _complete(remote, done)
            _complete(local, done)
        relists = rsched.fast_cycle.mirror.stale_relists
        assert relists >= 1
        assert {p.meta.key: p.node_name for p in remote.list("Pod")} == \
            {p.meta.key: p.node_name for p in local.list("Pod")}
        assert sorted(k for k, _ in rsched.cache.bind_log) == \
            sorted(k for k, _ in lsched.cache.bind_log)
    finally:
        for s in scheds:
            s.close()
        srv.stop()
