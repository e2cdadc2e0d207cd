"""The port's node-sharded cycle (K12a) against the JAX package's.

* ``make_sharded_cycle`` on local meshes of 1, 2, 4 and 8 node blocks
  against the JAX ``make_sharded_cycle(..., exact_topk=True)`` on 1, 2, 4
  and 8 virtual CPU devices (the conftest's), at
  ``build_sim_args(512, 2048, 128, 2, seed=11)``: all 11 outputs equal
  (tolerance: exact);
* the same against ``run_cycle_reference`` at ``build_sim_args(32, 64,
  16, 2, seed=3)``, and the batched solve with the dynamic pass's portsel
  on 2-8 blocks against the JAX solve (``tests/test_torch_dynamic.py``
  cases);
* a gloo process group of 4 ranks (``torch.multiprocessing``, a
  ``FileStore`` under ``tmp_path``, so no network port) running the same
  case, one and two blocks a rank, bit for bit against the one-block run
  and the JAX sharded cycle, under its own deadline;
* the conf ``mesh`` key: the port's Scheduler with ``mesh`` "8" and "2"
  against ``"off"`` and against the JAX Scheduler with the same mesh on the
  same store (binds equal), with dynamic jobs, and with contention under
  ``solve_mode: auto`` (unsharded contention solves, as in the JAX
  package);
* ``resolve_mesh`` and the cases out of this slice, which raise.
"""

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from volcano_tpu.parallel import make_mesh as jax_make_mesh
from volcano_tpu.parallel import make_sharded_cycle as jax_make_sharded_cycle
from volcano_tpu.parallel import run_cycle_reference as jax_run_cycle_reference
from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
from volcano_tpu.scheduler.simargs import build_sim_args
from volcano_tpu_torch import interop
from volcano_tpu_torch.parallel import sharded as S
from volcano_tpu_torch.scheduler import conf as tconf
from volcano_tpu_torch.scheduler.scheduler import Scheduler

from helpers import build_node, build_pod, build_podgroup, make_store
from test_torch_object import port_store
from torch_gloo_worker import run_rank

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

SWEEP = dict(n_nodes=512, n_tasks=2048, n_jobs=128, n_queues=2, seed=11)
#: seconds the gloo rehearsal may take before its ranks are killed
GLOO_DEADLINE_S = 240


def _jax_outputs(out):
    return [np.asarray(jax.device_get(x)) for x in out]


def _port_cycle(args, n_blocks, **kw):
    mesh = S.LocalMesh(n_blocks, "cpu")
    fn, dargs = S.make_sharded_cycle(mesh, args, **kw)
    return S.fetch_outputs(fn(dargs), mesh)


def _assert_outputs_equal(got, want, tag):
    for name, g, w in zip(S.OUTPUT_NAMES, got, want):
        np.testing.assert_array_equal(g, w, err_msg=f"{name}@{tag}")


@pytest.fixture(scope="module")
def sweep_args():
    return build_sim_args(**SWEEP)


@pytest.mark.parametrize("n_blocks", [1, 2, 4, 8])
def test_sharded_cycle_equals_jax_mesh_sweep(sweep_args, n_blocks):
    """Tolerance: exact, all 11 outputs, against the JAX sharded cycle on
    as many devices with the exact top-K."""
    jfn, jargs = jax_make_sharded_cycle(mesh=jax_make_mesh(n_blocks), args=sweep_args,
                                        m_chunk=32, p_chunk=8, exact_topk=True)
    want = _jax_outputs(jfn(jargs))
    got = _port_cycle(sweep_args, n_blocks, m_chunk=32, p_chunk=8)
    _assert_outputs_equal(got, want, f"{n_blocks} blocks")
    assert int(got[-1]) > 1 and (got[1] > 0).sum() > 0  # rounds ran, tasks placed


@pytest.mark.parametrize("n_blocks", [1, 8])
def test_sharded_cycle_equals_jax_reference(n_blocks):
    """Against the JAX unsharded reference (whose approximate top-K is
    exact at this size) and the port's own reference: exact."""
    args = build_sim_args(n_nodes=32, n_tasks=64, n_jobs=16, n_queues=2, seed=3)
    want = _jax_outputs(jax_run_cycle_reference(args, m_chunk=8, p_chunk=4))
    got = _port_cycle(args, n_blocks, m_chunk=8, p_chunk=4)
    _assert_outputs_equal(got, want, f"{n_blocks} blocks vs JAX")
    ref = S.fetch_outputs(S.run_cycle_reference(args, m_chunk=8, p_chunk=4))
    _assert_outputs_equal(got, ref, f"{n_blocks} blocks vs port reference")


@pytest.mark.parametrize("n_blocks", [2, 4, 8])
@pytest.mark.parametrize("seed,w_podaff,chunks", [
    (0, 1.0, dict(m_chunk=4, p_chunk=3)), (1, 0.1, {}), (3, 1.0, dict(m_chunk=4, p_chunk=3)),
])
def test_sharded_solve_with_portsel_equals_jax(seed, w_podaff, chunks, n_blocks):
    """The dynamic solve on node blocks (the resident port and selector
    planes split with the rows; blocks of 2-8 rows, fewer than K, so
    padded records) against the JAX batched solve with portsel and the
    exact top-K: decisions exact, float state within rtol 1e-6."""
    from test_torch_dynamic import _assert_same, _solve_both, portsel_case, torch_portsel
    from volcano_tpu_torch.scheduler import kernels as TK

    a, p = portsel_case(seed, w_podaff)
    oj, _ = _solve_both(a, p, True, **chunks)
    ps = torch_portsel(p)
    t = {k: torch.from_numpy(a[k]) for k in TK._SOLVE_ARGS if k != "queue_deserved"}
    repl = {k: v for k, v in t.items() if k not in TK.NODE_PLANES}
    repl["queue_deserved"] = TK.water_fill(*[torch.from_numpy(a[k]) for k in (
        "queue_weight", "queue_request", "total", "eps", "queue_participates")])
    mesh = S.LocalMesh(n_blocks, "cpu")
    planes = {k: S.split_rows(mesh, k, t[k]) for k in TK.NODE_PLANES}
    planes["node_ports_w"] = S.split_rows(mesh, "node_ports_w", ps[0])
    planes["node_selcnt"] = S.split_rows(mesh, "node_selcnt", ps[2])
    out = S.sharded_solve(mesh, planes, repl, 1.0, 1.0, portsel_task=ps[1:2] + ps[3:], **chunks)
    _assert_same(oj, out)


def test_sharded_blocks_hold_their_rows(sweep_args):
    """Each block's node planes are its own rows, and the blocks' outputs
    concatenate to the one-block run's planes."""
    mesh = S.LocalMesh(4, "cpu")
    fn, dargs = S.make_sharded_cycle(mesh, sweep_args, m_chunk=32, p_chunk=8)
    assert [b.shape[0] for b in dargs["idle"]] == [128] * 4
    assert [tuple(b.shape) for b in dargs["class_mask"]] == [(sweep_args["class_mask"].shape[0],
                                                              128)] * 4
    np.testing.assert_array_equal(dargs["idle"][2].numpy(), sweep_args["idle"][256:384])
    assert dargs["task_req"].shape == sweep_args["task_req"].shape


@pytest.mark.parametrize("n_blocks", [4, 8])
def test_gloo_group_of_four_equals_one_block(sweep_args, tmp_path, n_blocks):
    """Four gloo ranks, n_blocks / 4 blocks each: every rank's outputs equal
    the one-block run and the JAX sharded cycle on as many devices (exact
    top-K) bit for bit."""
    world = 4
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=run_rank,
                         args=(r, world, str(tmp_path / "store"), str(tmp_path), n_blocks,
                               SWEEP))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(GLOO_DEADLINE_S)
        late = [p.pid for p in procs if p.is_alive()]
        assert not late, f"gloo ranks {late} still running after {GLOO_DEADLINE_S} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0] * world
    want = _port_cycle(sweep_args, 1, m_chunk=32, p_chunk=8)
    jfn, jargs = jax_make_sharded_cycle(mesh=jax_make_mesh(n_blocks), args=sweep_args,
                                        m_chunk=32, p_chunk=8, exact_topk=True)
    jax_want = _jax_outputs(jfn(jargs))
    for r in range(world):
        with np.load(tmp_path / f"rank{r}.npz") as f:
            got = [f[f"arr_{i}"] for i in range(len(S.OUTPUT_NAMES))]
        _assert_outputs_equal(got, want, f"gloo rank {r}, {n_blocks} blocks")
        _assert_outputs_equal(got, jax_want, f"gloo rank {r} vs JAX, {n_blocks} blocks")


# -- the conf mesh key in the deployed Scheduler ---------------------------------

def _small_store():
    return make_store(
        nodes=[build_node(f"n{i}", cpu="4") for i in range(16)],
        podgroups=[build_podgroup(f"pg{j}", min_member=2) for j in range(4)],
        pods=[build_pod(f"p{j}-{i}", group=f"pg{j}", cpu="1") for j in range(4)
              for i in range(2)],
    )


def _jax_conf(mesh, solve_mode="batch"):
    return jconf.load_conf(f"backend: tpu\nsolveMode: {solve_mode}\nexactTopK: true\n"
                           f"mesh: {mesh}\n")


def _port_conf(mesh, solve_mode="batch"):
    conf = tconf.default_conf("cpu")
    conf.solve_mode = solve_mode
    conf.mesh = mesh
    return conf


@pytest.fixture
def sharded_calls(monkeypatch):
    """Counts the sharded solve's plain runs (the CPU backend's)."""
    calls = []
    orig = S.batch_blocks_plain

    def spy(*args, **kw):
        calls.append(args[2])  # the block count
        return orig(*args, **kw)

    monkeypatch.setattr(S, "batch_blocks_plain", spy)
    return calls


@pytest.mark.parametrize("mesh", ["8", "2"])
def test_mesh_scheduler_conf_equals_off_and_jax(mesh, sharded_calls):
    """``mesh: N`` reaches the deployed Scheduler: the batched solve runs on
    N node blocks and binds what ``mesh: off`` and the JAX Scheduler with
    the same mesh bind."""
    js = _small_store()
    jsched = JScheduler(js, conf=_jax_conf(mesh))
    jsched.run_once()
    binds = {}
    for setting in (mesh, "off"):
        sched = Scheduler(port_store(_small_store()), conf=_port_conf(setting))
        assert (sched.mesh is None) == (setting == "off")
        sched.run_once()
        binds[setting] = dict(sched.cache.bind_log)
    assert sched.mesh is None and S.LocalMesh(int(mesh), "cpu").size == int(mesh)
    assert sharded_calls == [int(mesh)]
    assert binds[mesh] == binds["off"] == dict(jsched.cache.bind_log)
    assert len(binds[mesh]) == 8


def test_mesh_object_path_equals_jax(sharded_calls):
    """With ``fast_path: off`` the object path's batched solve shards too."""
    jc = _jax_conf("4")
    jc.fast_path = "off"
    js = _small_store()
    jsched = JScheduler(js, conf=jc)
    jsched.run_once()
    conf = _port_conf("4")
    conf.fast_path = "off"
    sched = Scheduler(port_store(_small_store()), conf=conf)
    sched.run_once()
    assert sched.last_path == "object" and sharded_calls == [4]
    assert dict(sched.cache.bind_log) == dict(jsched.cache.bind_log)


def test_mesh_with_dynamic_jobs_equals_jax(sharded_calls):
    """Dynamic jobs (host ports, pod (anti)affinity) on the batched solve
    under a mesh: the resident port and selector planes split with the
    node rows; binds and phases equal the JAX Scheduler's."""
    from test_torch_dynamic import ACTIONS, _state, dyn_spec
    from test_torch_dynamic import jax_store_from_spec as dyn_jax_store

    spec = dyn_spec(21, n_nodes=8, jobs=(5, 8))
    jc, tc = jconf.full_conf("tpu"), tconf.full_conf("cpu")
    for c in (jc, tc):
        c.actions = list(ACTIONS)
        c.solve_mode = "batch"
        c.mesh = "2"
    jc.exact_topk = True
    js, ts = dyn_jax_store(spec), interop.store_from_spec(spec)
    jsched, tsched = JScheduler(js, conf=jc), Scheduler(ts, conf=tc)
    jsched.run_once()
    tsched.run_once()
    assert "dyn_solve" in tsched.fast_cycle.phases
    assert sharded_calls == [2, 2]  # the express solve and the dynamic one
    assert _state(ts) == _state(js)
    assert sorted(tsched.cache.bind_log) == sorted(jsched.cache.bind_log)


def test_mesh_contention_auto_runs_unsharded_like_jax(monkeypatch):
    """Under ``solve_mode: auto`` the contention solves keep whole node
    planes, as the JAX package does, and the storm cycle equals it."""
    from test_torch_contention import Recorder, jax_store_from_spec, storm_spec
    from volcano_tpu.scheduler import fast_victims as jfv
    from volcano_tpu_torch.scheduler import fast_victims as tfv

    spec = storm_spec(n_nodes=8, per_node=4, n_gangs=6, gang_size=3)
    jrec, trec = Recorder(monkeypatch, jfv), Recorder(monkeypatch, tfv)
    jc, tc = jconf.full_conf("tpu"), tconf.full_conf("cpu")
    jc.mesh = tc.mesh = "2"
    js, ts = jax_store_from_spec(spec), interop.store_from_spec(spec)
    jsched, tsched = JScheduler(js, conf=jc), Scheduler(ts, conf=tc)
    for _ in range(2):
        jsched.run_once()
        tsched.run_once()
        assert dict(tsched.cache.bind_log) == dict(jsched.cache.bind_log)
        assert tsched.cache.evict_log == jsched.cache.evict_log
        assert trec.pipes == jrec.pipes
    assert tsched.cache.evict_log


def test_resolve_mesh():
    assert S.resolve_mesh("off") is None
    assert S.resolve_mesh(None) is None
    assert S.resolve_mesh("auto") is None  # no process group: one block
    assert S.resolve_mesh("1") is None
    mesh = S.resolve_mesh("4")
    assert isinstance(mesh, S.LocalMesh) and mesh.size == 4 and mesh.device.type == "cpu"
    for bad, match in (("3", "power of two"), ("6", "power of two"),
                       (str(2 * S.MAX_LOCAL_BLOCKS), "at most"), ("x", "block count")):
        with pytest.raises(ValueError, match=match):
            S.resolve_mesh(bad)


def test_mesh_that_cannot_divide_the_node_rows_raises():
    args = build_sim_args(n_nodes=8, n_tasks=16, n_jobs=4, n_queues=2, seed=0)
    with pytest.raises(ValueError, match="not divisible"):
        S.make_sharded_cycle(S.LocalMesh(16, "cpu"), args)


def test_mesh_hosts_raise():
    conf = _port_conf("2")
    conf.mesh_hosts = 2
    with pytest.raises(NotImplementedError, match="K13.*item 10"):
        Scheduler(port_store(_small_store()), conf=conf)


def test_mesh_contention_in_batch_mode_raises():
    """A contention pass under a mesh and ``solve_mode: batch`` (K10 on node
    blocks) raises naming its ROADMAP item."""
    from test_torch_contention import storm_spec

    conf = tconf.full_conf("cpu")
    conf.solve_mode = "batch"
    conf.mesh = "2"
    sched = Scheduler(interop.store_from_spec(storm_spec(n_nodes=8, per_node=4, n_gangs=6,
                                                         gang_size=3)), conf=conf)
    with pytest.raises(NotImplementedError, match="item 10c"):
        sched.run_once()


def test_mesh_victim_solve_in_batch_mode_raises():
    """The object path's victim solve under a mesh and ``solve_mode:
    batch`` (K7 on node blocks, make_sharded_victim_step) raises naming its
    ROADMAP item."""
    from test_torch_contention import storm_spec

    conf = tconf.full_conf("cpu")
    conf.solve_mode = "batch"
    conf.mesh = "2"
    conf.fast_path = "off"
    sched = Scheduler(interop.store_from_spec(storm_spec(n_nodes=8, per_node=4, n_gangs=6,
                                                         gang_size=3)), conf=conf)
    with pytest.raises(NotImplementedError, match="K12b.*item 10"):
        sched.run_once()
