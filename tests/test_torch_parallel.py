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
  package; ``tests/test_torch_contention_mesh.py`` holds them on node
  blocks under ``solve_mode: batch``);
* ``resolve_mesh`` and the cases out of this slice, which raise;
* the victim solve on node blocks (K12b, ``make_sharded_victim_step``):
  local meshes of 1, 2, 4 and 8 blocks at ``build_victim_sim(64, 256, 16,
  n_queues=1, seed=5)`` against the JAX ``victim_step`` on one device and
  the JAX ``make_sharded_victim_step`` on as many virtual devices
  (decisions exact, state within the JAX test's rtol 1e-5 / atol 1e-3) and
  against the port's one-block solve (exact, state included); a sweep of
  3 seeds x the three modes x 4 flag sets on 2 and 4 blocks; a chain of 10
  preemptors with the blocked state fed back; a gloo group of 4 ranks at 1
  and 2 blocks a rank; the object path's preempt and reclaim scenarios of
  ``tests/test_torch_object.py`` and config 6r with a best-effort reclaimer
  at 1/20 scale under ``mesh`` "2" / "4" with ``solve_mode: batch``
  against the JAX Scheduler with the same mesh (binds, ordered evictions,
  pipelines, pods and PodGroup phases equal cycle by cycle).
"""

import copy
import itertools

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from volcano_tpu.parallel import make_mesh as jax_make_mesh
from volcano_tpu.parallel import make_sharded_cycle as jax_make_sharded_cycle
from volcano_tpu.parallel import run_cycle_reference as jax_run_cycle_reference
from volcano_tpu.parallel.sharded import make_sharded_victim_step as jax_make_sharded_victim_step
from volcano_tpu.scheduler import conf as jconf
from volcano_tpu.scheduler import simargs as jsim
from volcano_tpu.scheduler import victim_kernels as jvk
from volcano_tpu.scheduler.scheduler import Scheduler as JScheduler
from volcano_tpu.scheduler.simargs import build_sim_args
from volcano_tpu_torch import interop
from volcano_tpu_torch.parallel import sharded as S
from volcano_tpu_torch.scheduler import conf as tconf
from volcano_tpu_torch.scheduler import victim_kernels as tvk
from volcano_tpu_torch.scheduler.scheduler import Scheduler

from helpers import build_node, build_pod, build_podgroup, make_store
import test_torch_object as tobj
from test_torch_object import FLAG_SETS, port_store, run_pair
from test_torch_object import SCENARIOS as OBJECT_SCENARIOS
from torch_gloo_worker import run_rank, run_rank_victim

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
    ref = S.fetch_outputs(S.run_cycle_reference(args, m_chunk=8, p_chunk=4, device="cpu"))
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


def spawn_ranks(target, world, tmp_path, *args):
    """Run ``target(rank, world, store_path, out_dir, *args)`` in ``world``
    spawned processes joined by a FileStore under ``tmp_path``; every rank
    must exit 0 within ``GLOO_DEADLINE_S`` (late ranks are killed)."""
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, world, str(tmp_path / "store"), str(tmp_path)) + args)
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


@pytest.mark.parametrize("n_blocks", [4, 8])
def test_gloo_group_of_four_equals_one_block(sweep_args, tmp_path, n_blocks):
    """Four gloo ranks, n_blocks / 4 blocks each: every rank's outputs equal
    the one-block run and the JAX sharded cycle on as many devices (exact
    top-K) bit for bit."""
    world = 4
    spawn_ranks(run_rank, world, tmp_path, n_blocks, SWEEP)
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
    mesh = S.resolve_mesh("4", "cpu")
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
    """The multi-controller launch refuses the contention actions, whose
    victim state lies outside any one host's task block (the JAX guard);
    the conf refuses a host id outside [0, mesh_hosts)."""
    conf = tconf.full_conf("cpu")
    conf.mesh = "2"
    conf.mesh_hosts = 2
    with pytest.raises(ValueError, match=r"\['preempt', 'reclaim'\]"):
        Scheduler(port_store(_small_store()), conf=conf)
    conf.actions = ["enqueue", "allocate", "backfill"]
    conf.mesh_host_id = 2
    with pytest.raises(ValueError, match="outside"):
        Scheduler(port_store(_small_store()), conf=conf)


def test_mesh_victim_solve_in_batch_mode_raises():
    """The object path's victim solve under a mesh and ``solve_mode:
    batch`` runs on node blocks (K12b) and raises when the mesh's blocks
    cannot divide the snapshot's node rows (no silent one-block run): 16
    blocks over an 8-row node bucket."""
    from test_torch_contention import storm_spec

    conf = tconf.full_conf("cpu")
    conf.solve_mode = "batch"
    conf.mesh = "16"
    conf.fast_path = "off"
    sched = Scheduler(interop.store_from_spec(storm_spec(n_nodes=8, per_node=4, n_gangs=6,
                                                         gang_size=3)), conf=conf)
    with pytest.raises(ValueError, match="do not divide into 16 blocks"):
        sched.run_once()


# -- K12b: the victim solve on node blocks ----------------------------------------

VICTIM_SIM = dict(n_nodes=64, n_victims=256, n_jobs=16, n_queues=1, seed=5)
#: the JAX test's state tolerance for its sharded solve (XLA's float32
#: segment sums against the port's float64 ones)
STATE_RTOL, STATE_ATOL = 1e-5, 1e-3


def _victim_inputs(sim):
    c, s = jsim.build_victim_sim(**sim)
    return c, s, tvk.VictimConsts(**c), tvk.VictimState(**s)


def _jax_step(c, s, t_req, t_cls, jt, qt, n_dev=None, **kw):
    """The JAX victim solve: ``victim_step`` on one device, or
    ``make_sharded_victim_step`` on ``n_dev`` virtual devices; host values."""
    import jax.numpy as jnp

    if n_dev is None:
        jc = jvk.VictimConsts(**{k: jnp.asarray(v) for k, v in c.items()})
        js = jvk.VictimState(**{k: jnp.asarray(v) for k, v in s.items()})
        out = jvk.victim_step(jc, js, jnp.asarray(t_req), t_cls, jt, qt, **kw)
    else:
        fn, dc, ds = jax_make_sharded_victim_step(
            jax_make_mesh(n_dev), jvk.VictimConsts(**c), jvk.VictimState(**s), **kw)
        out = fn(dc, ds, jnp.asarray(t_req), t_cls, jt, qt)
    state = {f: np.asarray(jax.device_get(getattr(out[0], f))) for f in jvk.VictimState._fields}
    return state, bool(out[1]), int(out[2]), np.asarray(out[3]), bool(out[4])


def _rows(x):
    return (torch.cat(x) if isinstance(x, tuple) else x).numpy()


def _assert_step_equal(port, want, tag, exact):
    """``port``: (state, assigned, nstar, vmask, clean) of the port;
    ``want``: the same from JAX (``exact`` False: state within the JAX
    tolerance) or from the port's one-block solve (``exact``)."""
    state, assigned, nstar, vmask, clean = port
    w_state, w_assigned, w_nstar, w_vmask, w_clean = want
    assert (assigned, clean) == (w_assigned, w_clean), tag
    assert nstar == (w_nstar if w_assigned else 0), tag
    np.testing.assert_array_equal(vmask, w_vmask, err_msg=f"vmask {tag}")
    for f in tvk.VictimState._fields:
        got, exp = _rows(getattr(state, f)), np.asarray(w_state[f] if isinstance(
            w_state, dict) else _rows(getattr(w_state, f)))
        if exact or not np.issubdtype(got.dtype, np.floating):
            np.testing.assert_array_equal(got, exp, err_msg=f"state.{f} {tag}")
        else:
            np.testing.assert_allclose(got, exp, rtol=STATE_RTOL, atol=STATE_ATOL,
                                       err_msg=f"state.{f} {tag}")


def _port_one_block(tc, ts, t_req, t_cls, jt, qt, **kw):
    out = tvk.victim_step(tc, ts, torch.from_numpy(t_req), t_cls, jt, qt, **kw)
    assigned, nstar, vmask, clean = tvk.unpack_step(out.packed.numpy(), tc.run_req.shape[0])
    return out.state, assigned, nstar, vmask, clean


@pytest.mark.parametrize("n_blocks", [1, 2, 4, 8])
def test_victim_step_mesh_sweep_equals_jax(n_blocks):
    """The JAX package's mesh sweep: decisions exact against JAX
    ``victim_step`` on one device and ``make_sharded_victim_step`` on as
    many devices, state within rtol 1e-5 / atol 1e-3; decisions and state
    exact against the port's one-block solve."""
    c, s, tc, ts = _victim_inputs(VICTIM_SIM)
    t_req = np.array([2000.0, 2 * (1 << 30)], np.float32)
    kw = dict(mode="queue", use_gang=True, use_drf=False)
    fn, dc, ds = S.make_sharded_victim_step(S.LocalMesh(n_blocks, "cpu"), tc, ts, **kw)
    assert [b.shape[0] for b in ds.idle] == [64 // n_blocks] * n_blocks
    got = fn(dc, ds, t_req, 0, 0, 0)
    assert got[1], "the preemptor was not assigned"
    _assert_step_equal(got, _jax_step(c, s, t_req, 0, 0, 0, **kw), "JAX one device", False)
    _assert_step_equal(got, _jax_step(c, s, t_req, 0, 0, 0, n_dev=n_blocks, **kw),
                       f"JAX {n_blocks} devices", False)
    tc1, ts1 = interop.victim_from_arrays(c, s)
    _assert_step_equal(got, _port_one_block(tc1, ts1, t_req, 0, 0, 0, **kw), "one block", True)


@pytest.mark.parametrize("mode,flags", list(itertools.product(
    ["queue", "job", "reclaim"], range(len(FLAG_SETS)))))
def test_victim_step_blocks_sweep(mode, flags):
    """3 seeds on 2 and 4 blocks: exact against the port's one-block solve,
    decisions exact and state within rtol 1e-5 / atol 1e-3 against JAX
    ``victim_step``."""
    kw = dict(mode=mode, **FLAG_SETS[flags])
    for seed, k in itertools.product(range(3), range(3)):
        c, s, tc, ts = _victim_inputs(dict(n_nodes=16, n_victims=120, n_jobs=10, n_queues=3,
                                           seed=seed))
        rng = np.random.default_rng(200 + 3 * seed + k)
        t_req = np.array([rng.choice([500, 1500, 3000]), rng.choice([512, 2048]) * (1 << 20)],
                         np.float32)
        if rng.random() < 0.2:
            t_req[:] = 0
        jt = int(rng.integers(0, 10))
        qt = int(c["job_queue"][jt])
        jax_out = _jax_step(c, s, t_req, 0, jt, qt, **kw)
        tc1, ts1 = interop.victim_from_arrays(c, s)
        one = _port_one_block(tc1, ts1, t_req, 0, jt, qt, **kw)
        for n_blocks in (2, 4):
            fn, dc, ds = S.make_sharded_victim_step(S.LocalMesh(n_blocks, "cpu"), tc, ts, **kw)
            got = fn(dc, ds, t_req, 0, jt, qt)
            tag = f"seed {seed}, preemptor {k}, {n_blocks} blocks"
            _assert_step_equal(got, one, tag, True)
            _assert_step_equal(got, jax_out, tag, False)



def _chain(sim, n):
    """``n`` seeded preemptors (t_req, t_cls, jt, qt) for ``sim``."""
    c, _ = jsim.build_victim_sim(**sim)
    rng = np.random.default_rng(sim["seed"])
    J = c["job_queue"].shape[0]
    out = []
    for _ in range(n):
        jt = int(rng.integers(0, J))
        out.append(([float(rng.choice([1000, 2000, 4000])),
                     float(rng.choice([1, 2, 4]) * (1 << 30))], 0, jt, int(c["job_queue"][jt])))
    return out


CHAIN_KW = dict(mode="queue", use_gang=True, use_drf=True, use_conformance=True)


def _one_block_chain(sim, preemptors, **kw):
    c, s = jsim.build_victim_sim(**sim)
    tc, ts = interop.victim_from_arrays(c, s)
    out = []
    for t_req, t_cls, jt, qt in preemptors:
        res = _port_one_block(tc, ts, np.asarray(t_req, np.float32), t_cls, jt, qt, **kw)
        out.append(res)
        if res[1]:
            ts = res[0]
    return out, ts


def test_victim_step_blocks_chain_equals_one_block():
    """10 preemptors, each assignment's blocked state fed to the next (the
    solve returns its updated state whenever it assigns; the object path
    keeps the clean ones): every decision and the final state equal
    the one-block chain's bit for bit, on 2 and 4 blocks; the decisions
    equal the JAX chain's."""
    import jax.numpy as jnp

    preemptors = _chain(VICTIM_SIM, 10)
    want, want_state = _one_block_chain(VICTIM_SIM, preemptors, **CHAIN_KW)
    assert sum(w[1] for w in want) >= 3
    c, s = jsim.build_victim_sim(**VICTIM_SIM)
    jc = jvk.VictimConsts(**{k: jnp.asarray(v) for k, v in c.items()})
    js = jvk.VictimState(**{k: jnp.asarray(v) for k, v in s.items()})
    for t_req, t_cls, jt, qt in preemptors:
        jout = jvk.victim_step(jc, js, jnp.asarray(np.asarray(t_req, np.float32)), t_cls, jt,
                               qt, **CHAIN_KW)
        w = want.pop(0)
        assert (bool(jout[1]), bool(jout[4])) == (w[1], w[4])
        np.testing.assert_array_equal(np.asarray(jout[3]), w[3])
        want.append(w)
        if bool(jout[1]):
            js = jout[0]
    for n_blocks in (2, 4):
        _, _, tc, ts = _victim_inputs(VICTIM_SIM)
        fn, dc, ds = S.make_sharded_victim_step(S.LocalMesh(n_blocks, "cpu"), tc, ts,
                                                **CHAIN_KW)
        for i, (t_req, t_cls, jt, qt) in enumerate(preemptors):
            got = fn(dc, ds, t_req, t_cls, jt, qt)
            _assert_step_equal(got, want[i], f"step {i}, {n_blocks} blocks", True)
            if got[1]:
                ds = got[0]
        for f in tvk.VictimState._fields:
            np.testing.assert_array_equal(_rows(getattr(ds, f)), _rows(getattr(want_state, f)),
                                          err_msg=f"final state.{f}, {n_blocks} blocks")


@pytest.mark.parametrize("per_rank", [1, 2])
def test_victim_step_gloo_group_equals_one_block(tmp_path, per_rank):
    """Four gloo ranks, ``per_rank`` blocks each, run the 10-preemptor chain
    with the records exchanged over the group: every rank's decisions and
    final state (node planes gathered) equal the one-block chain's bit for
    bit."""
    world = 4
    preemptors = _chain(VICTIM_SIM, 10)
    spawn_ranks(run_rank_victim, world, tmp_path, world * per_rank, VICTIM_SIM, preemptors,
                CHAIN_KW)
    want, want_state = _one_block_chain(VICTIM_SIM, preemptors, **CHAIN_KW)
    for r in range(world):
        with np.load(tmp_path / f"victim{r}.npz") as f:
            for i, w in enumerate(want):
                assert f[f"decision{i}"].tolist() == [w[1], w[2] if w[1] else 0, w[4]], (r, i)
                np.testing.assert_array_equal(f[f"vmask{i}"], w[3])
            for name in tvk.VictimState._fields:
                np.testing.assert_array_equal(f[name], _rows(getattr(want_state, name)),
                                              err_msg=f"rank {r} state.{name}")


# -- the object path's victim solve on node blocks, against the JAX Scheduler ----

VICTIM_SCENARIOS = [name for name in OBJECT_SCENARIOS
                    if name.startswith(("preempt", "reclaim", "victims"))]


@pytest.fixture
def sharded_victims(monkeypatch):
    """Counts the port's and the JAX package's victim solves."""
    from volcano_tpu_torch.scheduler import tensor_actions

    calls = {"port": 0, "jax": 0}

    def counting(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tensor_actions, "victim_step_sharded",
                        counting(tensor_actions.victim_step_sharded, "port"))
    monkeypatch.setattr(jvk, "victim_step", counting(jvk.victim_step, "jax"))
    return calls


def _mesh_pair(monkeypatch, build, mesh, kw, **run_kw):
    """``run_pair`` with both Schedulers under ``mesh`` and
    ``solve_mode: batch`` (JAX: ``exactTopK: true``)."""
    # a copy: the scenario table's confs are shared with other tests
    jc = copy.deepcopy(kw.get("jax_conf")) or jconf.default_conf("tpu")
    jc.solve_mode, jc.exact_topk, jc.mesh = "batch", True, mesh
    monkeypatch.setattr(tobj, "port_conf", _meshed(tobj.port_conf, mesh))
    extra = {k: v for k, v in kw.items() if k != "jax_conf"}
    return run_pair(monkeypatch, build, jax_conf=jc, **extra, **run_kw)


def _meshed(port_conf, mesh):
    def conf(jc):
        c = port_conf(jc)
        c.mesh = mesh
        return c
    return conf


@pytest.mark.parametrize("name,mesh", list(itertools.product(VICTIM_SCENARIOS, ["2", "4"])))
def test_mesh_object_path_victims_equal_jax(name, mesh, monkeypatch, sharded_victims):
    """Each preempt / reclaim scenario of the object-path tests under a
    mesh with ``solve_mode: batch``: every victim solve runs on the node
    blocks, and binds, ordered evictions, pipelines, pods and phases equal
    the JAX Scheduler's under the same mesh."""
    build, kw = OBJECT_SCENARIOS[name]
    _, sched = _mesh_pair(monkeypatch, build, mesh, kw)
    assert sched.mesh is not None and sched.mesh.size == int(mesh)
    assert sharded_victims["port"] == sharded_victims["jax"], sharded_victims


@pytest.mark.parametrize("mesh", ["2", "4"])
def test_mesh_cfg6r_best_effort_reclaimer_equals_jax(mesh, monkeypatch, sharded_victims):
    """Config 6r with a best-effort reclaimer at 1/20 scale, three cycles
    with the victims reaped, under ``mesh`` with ``solve_mode: batch``:
    every cycle on the object path, every victim solve on the node blocks,
    the JAX package's per-cycle pattern, and each cycle equal to the JAX
    Scheduler's under the same mesh."""
    history, sched = _mesh_pair(
        monkeypatch, tobj.cfg6r_be_store,
        mesh, dict(jax_conf=tobj._full(["enqueue", "reclaim", "allocate", "backfill",
                                        "preempt"])),
        fast_path="auto", cycles=3, reap=True)
    assert sched.last_path == "object"
    assert history == tobj.CFG6R_BE_PATTERN
    assert sharded_victims["port"] == sharded_victims["jax"] > 30
