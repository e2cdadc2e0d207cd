"""The port's scheduler daemon (``python -m volcano_tpu_torch.cli
scheduler``) as an OS process, on the CPU.

Every daemon here is asked for the CPU (``VOLCANO_TPU_BACKEND=cpu`` in its
environment; the test configuration sets ``host`` for the JAX package's
daemons, which the port refuses).  The cases: the port's apiserver and
scheduler as two processes binding a short open loop with the digest
audit verifying over the wire; the same daemon against a spawned JAX
apiserver with its audit armed; an apiserver SIGKILLed with its WAL and
restarted on the same port under a running daemon; the refusals (``--peers``,
no card without a request for the CPU, a mesh host id out of range, the
subcommands of later items); the deployed apply mode of a conf file
without ``applyMode``; and ``chip_smoke.py`` phase 32's cluster and load
held to ``bench.py``'s config 8.
"""

import os
import subprocess
import sys
import time
import urllib.request

import pytest

import bench
import chip_smoke
from volcano_tpu_torch.loadgen import LoadSpec, run_open_loop
from volcano_tpu_torch.store.client import RemoteStore

from test_torch_chip_cells import _fields, _record_config8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CLI = chip_smoke.PORT_CLI

#: the daemons' environment: the CPU asked for, beacons every 50 ms
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "VOLCANO_TPU_BACKEND": "cpu",
       "VOLCANO_TPU_AUDIT_BEACON_S": "0.05", "VOLCANO_TPU_AUDIT": "1"}


def _spawn(argv, env=ENV):
    return chip_smoke.Proc("daemon", argv, env)


def _url(line):
    return line.rsplit(" ", 1)[-1].strip()


def _port_apiserver(*extra, env=ENV):
    api = _spawn(PORT_CLI + ["apiserver", "--port", "0", "--no-default-queue", *extra], env=env)
    return api, _url(api.wait_line("listening on", 120))


def _scheduler(url, *extra, env=ENV):
    sch = _spawn(PORT_CLI + ["scheduler", "--server", url, "--period", "0.05",
                             "--metrics-port", "0", *extra], env=env)
    metrics_url = _url(sch.wait_line("metrics on http", 120)).rsplit("/metrics", 1)[0]
    return sch, metrics_url


def _metric(metrics_url, name):
    with urllib.request.urlopen(metrics_url + "/metrics", timeout=10) as r:
        text = r.read().decode()
    for line in text.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{"):
            return float(line.rsplit(" ", 1)[-1])
    return 0.0


def _load_cluster(client, nodes=4):
    """Phase 30's cluster shape at ``nodes`` nodes: one weight-1 queue and
    nodes of 8,000m / 16 GiB / 110 pods."""
    ops = chip_smoke.cfg8_cluster_ops(n_nodes=nodes)
    assert not [e for e in client.bulk(ops) if e]


def _open_loop(client, qps=30.0, duration_s=1.0, seed=3, namespace="sub"):
    spec = LoadSpec(qps=qps, duration_s=duration_s, seed=seed, cpu_millis=(100,),
                    mem_mb=(64,), namespace=namespace)
    return run_open_loop(client, spec, lambda: None, settle_s=60.0, idle_sleep_s=0.02)


def _audited(metrics_url, timeout=30.0):
    """Wait for the daemon's first digest check; (checks, divergences)."""
    deadline = time.monotonic() + timeout
    while True:
        checks = _metric(metrics_url, "volcano_audit_digest_checks_total")
        if checks >= 1 or time.monotonic() > deadline:
            return checks, _metric(metrics_url, "volcano_audit_divergence_total")
        time.sleep(0.1)


def test_daemons_bind_an_open_loop_with_the_audit_verifying():
    """The port's apiserver and scheduler daemon, two processes: an open loop
    from this process binds every pod; the daemon's mirror verifies its
    digest against the beacons with no divergence, and its /debug/digest
    kinds equal the apiserver's once quiet; SIGTERM stops both with 0."""
    api, url = _port_apiserver("--shards", "4")
    sch = None
    try:
        client = RemoteStore(url)
        _load_cluster(client)
        sch, murl = _scheduler(url)
        sch.wait_line("solves warm in", 120)
        report = _open_loop(client)
        assert report.sustained and report.bound_pods == report.submitted_pods > 10, \
            report.as_dict()
        sch.wait_line("first cycle (fast) done", 120)
        checks, divergences = _audited(murl)
        assert checks >= 1 and divergences == 0, (checks, divergences)
        # once quiet, the mirror's kinds equal the apiserver's over the kinds
        # it watches
        mine, theirs = chip_smoke.quiet_digests(murl, url, timeout_s=30.0)
        assert mine["divergences"] == 0 and mine["last"]["mode"] == "beacon", mine
        assert mine["pending"] == 0 and mine["digest"]["kinds"] == theirs["kinds"], (mine, theirs)
    finally:
        if sch is not None:
            assert sch.stop() == 0, sch.lines[-20:]
        assert api.stop() == 0, api.lines[-20:]


def test_daemon_schedules_against_a_jax_apiserver():
    """The port's daemon against a spawned JAX apiserver with its digest
    audit armed: its client reads the JAX beacons, the open loop binds
    every pod, the checks pass with no divergence."""
    jcode = ("import sys; from volcano_tpu.store.server import StoreServer; "
             "s = StoreServer(shards=4); print('listening on', s.url, flush=True); "
             "import signal; signal.signal(signal.SIGTERM, lambda *a: sys.exit(0)); "
             "s.serve_forever()")
    api = _spawn([sys.executable, "-c", jcode])
    sch = None
    try:
        url = _url(api.wait_line("listening on", 120))
        client = RemoteStore(url)
        _load_cluster(client)
        sch, murl = _scheduler(url, "--no-leader-elect")
        report = _open_loop(client, seed=5, namespace="jx")
        assert report.sustained and report.bound_pods == report.submitted_pods > 10, \
            report.as_dict()
        checks, divergences = _audited(murl)
        assert checks >= 1 and divergences == 0, (checks, divergences)
    finally:
        if sch is not None:
            sch.stop()
        api.stop()


def test_daemon_rides_out_an_apiserver_sigkill_and_restart(tmp_path):
    """The apiserver SIGKILLed with its WAL on, then restarted on the same
    port from its state: the daemon logs the outage and the recovery and
    binds the pods created after it."""
    state = str(tmp_path / "state.json")
    api, url = _port_apiserver("--state", state, "--wal")
    sch = None
    try:
        client = RemoteStore(url)
        _load_cluster(client)
        sch, _ = _scheduler(url)
        report = _open_loop(client, duration_s=0.5)
        assert report.bound_pods == report.submitted_pods > 0, report.as_dict()
        mark = len(sch.lines)
        api.proc.kill()
        api.proc.wait(10)
        sch.wait_line("store unavailable", 120, start=mark)
        port = url.rsplit(":", 1)[-1]
        api = _spawn(PORT_CLI + ["apiserver", "--port", port, "--no-default-queue",
                                 "--state", state, "--wal"])
        assert _url(api.wait_line("listening on", 120)) == url
        sch.wait_line("store back", 120, start=mark)
        report = _open_loop(RemoteStore(url), duration_s=0.5, seed=9, namespace="after")
        assert report.sustained and report.bound_pods == report.submitted_pods > 0, \
            report.as_dict()
    finally:
        if sch is not None:
            sch.stop()
        api.stop()


def _run(args, env=ENV, timeout=120):
    return subprocess.run(PORT_CLI + args, capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=timeout)


def test_peers_exits_naming_part_3():
    out = _run(["scheduler", "--server", "http://127.0.0.1:9", "--peers",
                "http://127.0.0.1:9,http://127.0.0.1:10"])
    assert out.returncode != 0 and "item 11b part 3" in out.stderr, out.stderr[-2000:]


def test_no_card_without_a_cpu_request_exits_before_scheduling():
    """``VOLCANO_TPU_BACKEND`` unset on a machine with no card: the daemon
    raises the Scheduler's RuntimeError and never cycles or writes."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default backend runs on it")
    api, url = _port_apiserver()
    try:
        client = RemoteStore(url)
        _load_cluster(client)
        env = {k: v for k, v in ENV.items() if k != "VOLCANO_TPU_BACKEND"}
        root = chip_smoke._get_json(url, "/debug/digest")["root"]
        out = _run(["scheduler", "--server", url, "--metrics-port", "-1"], env=env)
        assert out.returncode != 0, out.stdout[-2000:]
        assert "RuntimeError" in out.stderr and "CUDA" in out.stderr, out.stderr[-2000:]
        assert "cycling every" not in out.stdout
        # no lease, no write: the state digest did not move
        assert chip_smoke._get_json(url, "/debug/digest")["root"] == root
        assert not client.list("Lease")
    finally:
        api.stop()


@pytest.mark.parametrize("backend", ["host", "native"])
def test_backends_without_a_counterpart_raise(backend):
    out = _run(["scheduler", "--server", "http://127.0.0.1:9", "--metrics-port", "-1"],
               env={**ENV, "VOLCANO_TPU_BACKEND": backend})
    assert out.returncode != 0 and "ValueError" in out.stderr and backend in out.stderr


def test_mesh_host_id_out_of_range_exits():
    out = _run(["scheduler", "--server", "http://127.0.0.1:9", "--mesh-hosts", "2",
                "--mesh-host-id", "2"])
    assert out.returncode != 0
    assert "--mesh-host-id 2 out of range for --mesh-hosts 2" in out.stderr
    out = _run(["scheduler", "--server", "http://127.0.0.1:9"],
               env={**ENV, "VOLCANO_TPU_MESH_HOSTS": "4", "VOLCANO_TPU_MESH_HOST_ID": "7"})
    assert out.returncode != 0 and "--mesh-host-id 7 out of range" in out.stderr


@pytest.mark.parametrize("cmd,item", [("controller", "item 12"), ("kubelet", "item 12"),
                                      ("elastic", "item 12"), ("job", "item 13"),
                                      ("top", "item 13"), ("audit", "item 13"),
                                      ("replica", "item 11b part 3"),
                                      ("shard", "item 11b part 4")])
def test_later_subcommands_exit_naming_their_item(cmd, item):
    from volcano_tpu_torch.cli import daemons

    assert daemons.main(["--server", "http://127.0.0.1:9", cmd, "list"]) != 0
    assert item in daemons.LATER_COMMANDS[cmd]


def test_conf_without_apply_mode_runs_async(tmp_path, monkeypatch):
    """A conf file that names no ``applyMode`` runs the deployed async apply
    in the daemon; one that names ``sync`` keeps it.  The daemon is driven
    in this process up to its first cycle against an in-thread apiserver."""
    from volcano_tpu_torch.cli import daemons
    from volcano_tpu_torch.scheduler import scheduler as sched_mod
    from volcano_tpu_torch.scheduler.conf import load_conf
    from volcano_tpu_torch.store.server import StoreServer

    assert load_conf("backend: cpu\n").apply_mode == "sync"
    srv = StoreServer().start()
    try:
        for text, want in (("backend: cpu\n", "async"),
                           ("backend: cpu\napplyMode: sync\n", "sync")):
            path = tmp_path / "conf.yaml"
            path.write_text(text)
            seen = []

            class Stop(Exception):
                pass

            class Probe(sched_mod.Scheduler):
                def run_once(self):
                    seen.append((self.conf.apply_mode, self.cache.applier is not None))
                    self.close()
                    raise Stop

            monkeypatch.setattr(sched_mod, "Scheduler", Probe)
            with pytest.raises(Stop):
                daemons.run_scheduler(srv.url, conf_path=str(path), leader_elect=False,
                                      period=0.01, metrics_port=-1,
                                      announce=lambda *a, **k: None)
            assert seen == [(want, want == "async")]
    finally:
        srv.stop()


def test_daemon_arms_the_time_series_from_the_environment(monkeypatch):
    from volcano_tpu_torch import timeseries

    monkeypatch.setenv("VOLCANO_TPU_TIMESERIES", '{"ring": 7}')
    try:
        rec = timeseries.arm_from_env()
        assert rec is timeseries.RECORDER and rec.ring_size == 7
    finally:
        timeseries.disarm()
    monkeypatch.setenv("VOLCANO_TPU_TIMESERIES", "0")
    assert timeseries.arm_from_env() is None


def test_phase32_cluster_and_load_equal_bench_config8(monkeypatch):
    """``chip_smoke.py`` phase 32 loads phase 30's cluster through the wire
    (``cfg8_cluster_ops``) and runs phase 30's base LoadSpec after its warm
    burst: both held to ``bench.py``'s config 8 field for field."""
    from volcano_tpu_torch.store import Store

    ops = chip_smoke.cfg8_cluster_ops()
    store = Store()
    assert not [e for e in store.bulk(ops) if e]
    jstore = bench._build_open_loop_store()

    def nodes(st):
        return [(n.meta.name, n.allocatable.milli_cpu, n.allocatable.memory,
                 n.allocatable.max_task_num, n.unschedulable, dict(n.labels))
                for n in st.list("Node")]

    assert nodes(store) == nodes(jstore) and len(nodes(store)) == 200
    assert ([(q.meta.name, q.weight) for q in store.list("Queue")]
            == [(q.meta.name, q.weight) for q in jstore.list("Queue")])
    seen = _record_config8(monkeypatch)
    warm, base = chip_smoke.cfg8_daemon_specs()
    (_, jwarm, _, _), (_, jbase, settle, _) = seen["loops"][:2]
    assert _fields(warm) == _fields(jwarm) and _fields(base) == _fields(jbase)
    assert chip_smoke.CFG8["settle_s"] == settle
