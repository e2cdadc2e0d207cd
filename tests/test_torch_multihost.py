"""The port's multi-controller cycle (K13, ``parallel/multihost.py``) against
the JAX package's.

* ``run_lockstep`` over a (hosts, nodes) mesh at ``build_sim_args(512,
  2048, 128, 2, seed=11)``: one host bit for bit equal to the sharded cycle
  on as many blocks and to the JAX sharded cycle (exact top-K), the node
  state chained into a second cycle included; 1, 2 and 4 hosts over four
  blocks equal to the JAX ``run_lockstep(exact_topk=True)`` merged outputs
  and to the one-block run (tolerance: exact, all 11 outputs);
* ``host_bounds`` and ``host_plane_shard`` equal to JAX's, a task count
  the host count does not divide included; the owned output slices cover
  every row once;
* a gloo group of 4 ranks (2 hosts x 2 columns, and 4 hosts x 1) with the
  task planes split over the hosts, bit for bit against the one-block run
  (``tests/torch_gloo_worker.py``, its own 240 s deadline);
* the deployed seam, the JAX ``tests/test_multihost.py`` cases: the
  two-host CLI run clean with ``--backend cpu``, the worker's degrade when
  its coordinator is dead, the conf validation and the preempt / reclaim
  guard, the coordinator / worker publish split (disjoint binds whose union
  is the single-host run, each equal to the JAX Scheduler's split), the
  worker's skip of the cycles its fast cycle declines, and the one-host
  CLI.  Each subprocess has a 240 s deadline.  With best-effort pods the
  coordinator's backfill counts only its own block's placements in both
  packages (ROADMAP section 3); that case equals the JAX split bind for
  bind.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from volcano_tpu.parallel import make_mesh as jax_make_mesh
from volcano_tpu.parallel import make_sharded_cycle as jax_make_sharded_cycle
from volcano_tpu.parallel import multihost as JMH
from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler.fastpath.snapshot_build import host_plane_shard as jax_host_plane_shard
from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
from volcano_tpu.scheduler.simargs import build_sim_args
from volcano_tpu_torch.parallel import multihost as MH
from volcano_tpu_torch.parallel import sharded as S
from volcano_tpu_torch.scheduler import conf as tconf
from volcano_tpu_torch.scheduler.fastpath.snapshot_build import host_plane_shard
from volcano_tpu_torch.scheduler.scheduler import Scheduler

from helpers import build_node, build_pod, build_podgroup, make_store
from test_torch_object import port_store
from test_torch_parallel import spawn_ranks
from torch_gloo_worker import run_rank_multihost

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

SWEEP = dict(n_nodes=512, n_tasks=2048, n_jobs=128, n_queues=2, seed=11)
CHUNKS = dict(m_chunk=32, p_chunk=8)
#: seconds a CLI subprocess may take
CLI_DEADLINE_S = 240
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS, NODES, JOBS = 256, 64, 16


@pytest.fixture(scope="module")
def sweep_args():
    return build_sim_args(**SWEEP)


@pytest.fixture(scope="module")
def one_block(sweep_args):
    mesh = S.LocalMesh(1, "cpu")
    fn, dargs = S.make_sharded_cycle(mesh, sweep_args, **CHUNKS)
    return S.fetch_outputs(fn(dargs), mesh)


def _assert_outputs_equal(got, want, tag):
    for name, g, w in zip(MH.OUTPUT_NAMES, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f"{name}@{tag}")


def test_multihost_degenerate_single_host_bitwise_parity(sweep_args):
    """One host over eight blocks is the sharded cycle: bit for bit equal
    to it and to the JAX sharded cycle on eight devices, and again on the
    node state chained into a second cycle."""
    def sharded(a):
        mesh = S.LocalMesh(8, "cpu")
        fn, dargs = S.make_sharded_cycle(mesh, a, **CHUNKS)
        return S.fetch_outputs(fn(dargs), mesh)

    def jax_sharded(a):
        fn, dargs = jax_make_sharded_cycle(mesh=jax_make_mesh(8), args=a, exact_topk=True,
                                           **CHUNKS)
        return [np.asarray(jax.device_get(x)) for x in fn(dargs)]

    args = sweep_args
    for tag in ("cycle 1", "chained"):
        got = MH.run_lockstep(args, 1, n_blocks=8, device="cpu", **CHUNKS)["outputs"]
        _assert_outputs_equal(got, sharded(args), f"1 host, {tag}")
        _assert_outputs_equal(got, jax_sharded(args), f"1 host vs JAX, {tag}")
        args = dict(args)
        for name in ("idle", "releasing", "used"):
            args[name] = np.asarray(got[MH.OUTPUT_NAMES.index(name)])


def test_multihost_two_host_lockstep_merges_to_single_host(sweep_args):
    """Two hosts, each fetching only its owned slices: the merged outputs
    equal the one-host run bit for bit, the bind set included, and the
    task axis splits into two adjacent blocks."""
    one = MH.run_lockstep(sweep_args, 1, n_blocks=4, device="cpu", **CHUNKS)["outputs"]
    two = MH.run_lockstep(sweep_args, 2, n_blocks=4, device="cpu", **CHUNKS)["outputs"]
    _assert_outputs_equal(two, one, "2 hosts")
    kind1, kind2 = one[1], two[1]
    np.testing.assert_array_equal(kind2 == 1, kind1 == 1)
    np.testing.assert_array_equal(two[0][kind2 == 1], one[0][kind1 == 1])
    assert (kind1 == 1).sum() > 0
    bounds = MH.host_bounds(kind1.shape[0], 2)
    assert bounds[0][1] == bounds[1][0] and bounds[1][1] == kind1.shape[0]


def test_armed_lockstep_counts_each_host_fetch_once(sweep_args):
    """Armed, two-host lockstep: vtprof's hosts table holds each host's
    build and dispatch walls as the run reports them, and its fetch_s once,
    from the host's fetch boundary inside the run's own fetch wall."""
    from volcano_tpu_torch import vtprof

    prof = vtprof.arm()
    try:
        res = MH.run_lockstep(sweep_args, 2, n_blocks=4, device="cpu", **CHUNKS)
    finally:
        vtprof.disarm()
    for h, row in enumerate(res["per_host"]):
        got = prof.hosts[str(h)]
        assert (got["build_s"], got["dispatch_s"]) == (row["build_s"], row["dispatch_s"])
        assert 0.0 < got["fetch_s"] <= row["fetch_s"], (h, got, row)


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_run_lockstep_equals_jax(sweep_args, one_block, n_hosts):
    """Tolerance: exact, all 11 merged outputs, against the JAX
    ``run_lockstep(exact_topk=True)`` at the same host count (eight
    devices) and against the port's one-block run; per-host walls for
    every host."""
    res = MH.run_lockstep(sweep_args, n_hosts, n_blocks=4, device="cpu", **CHUNKS)
    want = JMH.run_lockstep(sweep_args, n_hosts, exact_topk=True, **CHUNKS)["outputs"]
    _assert_outputs_equal(res["outputs"], want, f"{n_hosts} hosts vs JAX")
    _assert_outputs_equal(res["outputs"], one_block, f"{n_hosts} hosts vs one block")
    assert res["n_hosts"] == n_hosts and len(res["per_host"]) == n_hosts
    for row in res["per_host"]:
        assert row["path_s"] == pytest.approx(row["build_s"] + row["dispatch_s"]
                                              + row["fetch_s"])
    assert res["critical_path_s"] == max(r["path_s"] for r in res["per_host"])


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    """``make_host_mesh``, ``make_mesh``, ``run_cycle_reference`` and
    ``run_lockstep`` take the card when no device is given, and raise when
    there is none; the CPU runs only when asked for."""
    small = build_sim_args(n_nodes=8, n_tasks=16, n_jobs=4, n_queues=2, seed=0)
    if torch.cuda.is_available():
        assert MH.make_host_mesh(2, 4).device.type == "cuda"
        assert S.make_mesh(4).device.type == "cuda"
    else:
        for call in (lambda: MH.make_host_mesh(2, 4), lambda: S.make_mesh(4),
                     lambda: S.resolve_mesh("4"), lambda: S.run_cycle_reference(small, **CHUNKS),
                     lambda: MH.run_lockstep(small, 2, n_blocks=4, **CHUNKS)):
            with pytest.raises(RuntimeError, match="none is available"):
                call()
    assert MH.make_host_mesh(2, 4, "cpu").device.type == "cpu"
    assert S.make_mesh(4, "cpu").device.type == "cpu"
    res = MH.run_lockstep(small, 2, n_blocks=4, device="cpu", **CHUNKS)
    assert res["n_hosts"] == 2 and res["n_blocks"] == 4


@pytest.mark.parametrize("n_rows,n_hosts", [(2048, 1), (2048, 2), (2048, 3), (10, 4),
                                            (3, 4), (0, 2), (512, 8)])
def test_host_bounds_equal_jax(n_rows, n_hosts):
    assert MH.host_bounds(n_rows, n_hosts) == JMH.host_bounds(n_rows, n_hosts)


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 4])
def test_host_plane_shard_equals_jax(sweep_args, n_hosts):
    """Every host's shard equals JAX's (3 hosts do not divide the 2048 task
    rows), and a cycle argument with no declared placement raises."""
    for h in range(n_hosts):
        got = host_plane_shard(sweep_args, h, n_hosts)
        want = jax_host_plane_shard(sweep_args, h, n_hosts)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k}@host {h}")
    with pytest.raises(KeyError, match="no declared"):
        host_plane_shard(dict(sweep_args, mystery=np.zeros(3)), 0, n_hosts)


@pytest.mark.parametrize("n_hosts", [2, 4])
def test_owned_output_slices_cover_each_row_once(sweep_args, one_block, n_hosts):
    """Each host's slice is its task block and its node block; only host 0
    holds the global outputs; the slices tile each plane exactly."""
    mesh = MH.LocalHostMesh(n_hosts, 4, "cpu")
    fn, dargs = MH.make_multihost_cycle(mesh, sweep_args, **CHUNKS)
    assert len(dargs["task_req"]) == n_hosts
    out = fn(dargs)
    slices = [MH.owned_output_slices(out, h, n_hosts, mesh) for h in range(n_hosts)]
    T, N = one_block[0].shape[0], one_block[6].shape[0]
    for h, sl in enumerate(slices):
        tlo, thi = MH.host_bounds(T, n_hosts)[h]
        nlo, nhi = MH.host_bounds(N, n_hosts)[h]
        assert sl["task_node"].shape[0] == thi - tlo and sl["idle"].shape[0] == nhi - nlo
        assert ("ready" in sl) == (h == 0)
    assert sum(sl["task_kind"].shape[0] for sl in slices) == T
    assert sum(sl["used"].shape[0] for sl in slices) == N
    _assert_outputs_equal(MH.merge_output_slices(slices), one_block, f"{n_hosts} hosts merged")


@pytest.mark.parametrize("n_hosts,n_blocks", [(2, 4), (4, 4)])
def test_gloo_host_mesh_equals_one_block(sweep_args, one_block, tmp_path, n_hosts, n_blocks):
    """Four gloo ranks as ``n_hosts`` hosts over ``n_blocks`` node blocks,
    each rank holding only its host's task block (gathered along the host
    axis before the solve): every rank's outputs equal the one-block run bit
    for bit, and the ranks' owned slices merge into it."""
    world = 4
    spawn_ranks(run_rank_multihost, world, tmp_path, n_hosts, n_blocks, SWEEP)
    slices = []
    for r in range(world):
        with np.load(tmp_path / f"mh{r}.npz") as f:
            got = [f[f"out_{n}"] for n in MH.OUTPUT_NAMES]
            slices.append({k[4:]: f[k] for k in f.files if k.startswith("own_")})
        _assert_outputs_equal(got, one_block, f"gloo rank {r}, {n_hosts} hosts")
    _assert_outputs_equal(MH.merge_output_slices(slices), one_block, "gloo owned slices")


# -- the deployed seam (tests/test_multihost.py) ---------------------------------

def _cli(extra, outdir=None):
    cmd = [sys.executable, "-m", "volcano_tpu_torch.parallel.multihost", "--backend", "cpu",
           "--nodes", str(NODES), "--tasks", str(TASKS), "--jobs", str(JOBS), "--seed", "3"]
    if outdir is not None:
        cmd += ["--outdir", str(outdir)]
    return subprocess.run(cmd + extra, cwd=REPO, capture_output=True, text=True,
                          timeout=CLI_DEADLINE_S)


def _payload(proc):
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip().startswith("{")]
    assert lines, (proc.returncode, proc.stdout, proc.stderr[-800:])
    return json.loads(lines[-1])


def test_two_host_coordinator_runs_one_clean_cycle(tmp_path):
    """``--mesh-hosts 2``: the coordinator spawns one worker process, both
    run the lockstep cycle, the worker ships its owned slices through the
    rendezvous directory and the coordinator checks them: one clean cycle,
    nothing degraded, and the shipped slice is the owned half."""
    proc = _cli(["--mesh-hosts", "2"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-800:]
    summary = _payload(proc)
    assert summary["ok"] is True and summary["hosts"] == 2
    assert summary["degraded"] is False, summary
    assert [w["ok"] for w in summary["workers"]] == [True]
    assert summary["workers"][0]["rc"] == 0
    assert summary["binds"] > 0 and len(summary["per_host"]) == 2
    with np.load(tmp_path / "host01.npz") as shipped:
        assert shipped["task_node"].shape[0] == TASKS // 2
        assert shipped["idle"].shape[0] == NODES // 2


def test_worker_degrades_to_full_cycle_when_coordinator_dies(tmp_path):
    """A worker whose coordinator is dead degrades to a full single-host
    cycle, ships full planes, flags ``fallback`` and exits cleanly."""
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait(timeout=30)
    proc = _cli(["--mesh-hosts", "2", "--host-id", "1", "--coordinator-pid", str(dead.pid)],
                tmp_path)
    assert proc.returncode == 0, proc.stderr[-800:]
    assert _payload(proc)["fallback"] is True
    with np.load(tmp_path / "host01.npz") as shipped:
        assert shipped["task_node"].shape[0] == TASKS
        assert shipped["idle"].shape[0] == NODES
        assert (shipped["task_kind"] == 1).sum() > 0


def test_mesh_hosts_conf_validation():
    """The host count and id validate at construction (JAX validates at
    load; the port has no YAML loader yet), and again in the Scheduler;
    preempt and reclaim are refused with more than one host.  The JAX
    package also refuses backends other than "tpu" there, to keep out its
    host and native backends; both of the port's backends are the tensor
    path, so "cpu" is accepted."""
    conf = tconf.SchedulerConf(mesh_hosts=2, mesh_host_id=1)
    assert (conf.mesh_hosts, conf.mesh_host_id) == (2, 1)
    with pytest.raises(ValueError, match=">= 1"):
        tconf.SchedulerConf(mesh_hosts=0)
    with pytest.raises(ValueError, match="outside"):
        tconf.SchedulerConf(mesh_hosts=2, mesh_host_id=2)
    store = port_store(make_store(nodes=[build_node("n0")]))
    conf = tconf.default_conf("cpu")
    conf.mesh_hosts, conf.mesh_host_id = 2, 5
    with pytest.raises(ValueError, match="outside"):
        Scheduler(store, conf=conf)
    conf.mesh_host_id = 1
    conf.actions = ["allocate", "preempt"]
    with pytest.raises(ValueError, match="preempt"):
        Scheduler(store, conf=conf)
    conf.actions = ["enqueue", "reclaim", "allocate"]
    with pytest.raises(ValueError, match="reclaim"):
        Scheduler(store, conf=conf)
    conf.actions = ["enqueue", "allocate", "backfill"]
    assert Scheduler(store, conf=conf).fast_cycle.is_coordinator is False


def _split_store():
    return make_store(
        nodes=[build_node(f"n{i}", cpu="4") for i in range(16)],
        podgroups=[build_podgroup(f"pg{j}", min_member=2) for j in range(4)],
        pods=[build_pod(f"p{j}-{i}", group=f"pg{j}", cpu="1") for j in range(4)
              for i in range(2)],
    )


def _jax_binds(mesh_lines, actions=None):
    conf = jconf.load_conf("backend: tpu\nsolveMode: batch\nexactTopK: true\n" + mesh_lines)
    if actions is not None:
        conf.actions = list(actions)
    sched = JScheduler(_split_store(), conf=conf)
    sched.run_once()
    return dict(sched.cache.bind_log)


def _port_run(hosts, host_id, mesh="off", actions=None):
    conf = tconf.default_conf("cpu")
    conf.solve_mode, conf.mesh = "batch", mesh
    conf.mesh_hosts, conf.mesh_host_id = hosts, host_id
    if actions is not None:
        conf.actions = list(actions)
    sched = Scheduler(port_store(_split_store()), conf=conf)
    sched.run_once()
    return dict(sched.cache.bind_log), sched


@pytest.mark.parametrize("mesh", ["off", "4"])
def test_deployed_coordinator_worker_publish_split(mesh):
    """A coordinator-conf'd and a worker-conf'd Scheduler, each over its own
    copy of the store, publish disjoint bind sets whose union is the
    single-host run, each equal to the JAX Scheduler's at the same host
    id."""
    single, _ = _port_run(1, 0, mesh)
    coord, csched = _port_run(2, 0, mesh)
    worker, wsched = _port_run(2, 1, mesh)
    assert csched.last_path == wsched.last_path == "fast"
    assert set(coord) | set(worker) == set(single)
    assert not set(coord) & set(worker)
    assert all(single[k] == v for k, v in {**coord, **worker}.items())
    assert coord and worker
    assert single == _jax_binds("")
    assert coord == _jax_binds("meshHosts: 2\nmeshHostId: 0\n")
    assert worker == _jax_binds("meshHosts: 2\nmeshHostId: 1\n")
    # statuses are the coordinator's
    groups = {g.meta.key: g.status.phase for g in wsched.cache.store.list("PodGroup")}
    assert all(p.value == "Inqueue" for p in groups.values()), groups


def test_worker_skips_the_cycles_its_fast_cycle_declines():
    """An action order outside the canonical one sends the cycle to the
    object path: the coordinator runs it (binding what the single host
    binds), the worker skips it, as in the JAX package."""
    actions = ["backfill", "allocate"]
    single, ssched = _port_run(1, 0, actions=actions)
    coord, csched = _port_run(2, 0, actions=actions)
    worker, wsched = _port_run(2, 1, actions=actions)
    assert ssched.last_path == csched.last_path == "object"
    assert wsched.last_path == "mesh-worker-skip"
    assert coord == single and single and not worker
    assert worker == _jax_binds("meshHosts: 2\nmeshHostId: 1\n", actions)
    assert coord == _jax_binds("meshHosts: 2\nmeshHostId: 0\n", actions)


def test_degenerate_single_host_cli(tmp_path):
    """``--mesh-hosts 1`` is one full in-process cycle: no subprocess, no
    rendezvous."""
    proc = _cli(["--mesh-hosts", "1"])
    assert proc.returncode == 0, proc.stderr[-800:]
    payload = _payload(proc)
    assert payload["ok"] is True and payload["hosts"] == 1 and payload["binds"] > 0
    assert not list(tmp_path.iterdir())


def _be_store():
    """Four nodes of four pod slots, four gangs of two one-cpu tasks, and
    six best-effort pods in gang pg0."""
    pods = [build_pod(f"p{j}-{i}", group=f"pg{j}", cpu="1") for j in range(4) for i in range(2)]
    pods += [build_pod(f"be{i}", group="pg0", cpu="0", memory="0") for i in range(6)]
    return make_store(nodes=[build_node(f"n{i}", cpu="4", pods=4) for i in range(4)],
                      podgroups=[build_podgroup(f"pg{j}", min_member=2) for j in range(4)],
                      pods=pods)


def test_deployed_split_with_best_effort_pods_equals_jax():
    """Best-effort pods are the coordinator's to backfill, and its backfill
    counts only its own task block's placements, in both packages: here it
    puts four pods on n0, where the worker placed two, so the merged binds
    hold six pods on a four-slot node that the single host fills to four
    (ROADMAP section 3).  The port's coordinator and worker equal the JAX
    package's bind for bind; the gang tasks equal the single host's."""
    def jax_run(lines):
        conf = jconf.load_conf("backend: tpu\nsolveMode: batch\nexactTopK: true\n" + lines)
        sched = JScheduler(_be_store(), conf=conf)
        sched.run_once()
        return dict(sched.cache.bind_log)

    def port_run(hosts, host_id):
        conf = tconf.default_conf("cpu")
        conf.solve_mode, conf.mesh_hosts, conf.mesh_host_id = "batch", hosts, host_id
        sched = Scheduler(port_store(_be_store()), conf=conf)
        sched.run_once()
        return dict(sched.cache.bind_log)

    single, coord, worker = port_run(1, 0), port_run(2, 0), port_run(2, 1)
    assert single == jax_run("")
    assert coord == jax_run("meshHosts: 2\nmeshHostId: 0\n")
    assert worker == jax_run("meshHosts: 2\nmeshHostId: 1\n")
    assert not set(coord) & set(worker) and set(coord) | set(worker) == set(single)
    be = {k for k in single if k.startswith("default/be")}
    assert be <= set(coord)
    assert {k: v for k, v in {**coord, **worker}.items() if k not in be} == {
        k: v for k, v in single.items() if k not in be}
    per_node = [n for n in {**coord, **worker}.values()]
    assert per_node.count("n0") == 6 and list(single.values()).count("n0") == 4
