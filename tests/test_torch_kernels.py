"""Kernel parity: the port's kernels (volcano_tpu_torch/scheduler/kernels.py)
against the JAX package's on the same numpy inputs.

On the CPU the port's wrappers run their plain PyTorch versions; JAX runs
its jitted kernels on the CPU.  The int32 decision outputs (task_node,
task_kind, task_seq, ready, dropped, steps) must be equal.  The float
outputs are held to rtol=1e-6, though bit-equality is expected:
build_sim_args requests are multiples of 250 millicores and 256 MiB, so
every sum is exact in float32 whatever the order, and the score's fused
multiply-adds are reproduced.  The batch solve runs JAX with
exact_topk=True (the port's top-K is exact).

The CUDA kernels against their plain versions: tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcano_tpu.scheduler import kernels as JK
from volcano_tpu.scheduler.simargs import build_sim_args as jax_build_sim_args
from volcano_tpu_torch.scheduler import kernels as TK
from volcano_tpu_torch import interop
from volcano_tpu_torch.scheduler.simargs import (
    BATCH_EDGE_CASES,
    EXACT_EDGE_CASES,
    PORTSEL_KEYS,
    add_releasing,
    build_water_fill_args,
    build_batch_edge_args,
    build_exact_edge_args,
    build_sim_args,
)

# the plain versions are many small ops: one intra-op thread each, so that
# parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

DECISIONS = ("task_node", "task_kind", "task_seq", "ready", "dropped", "steps")
ORDER = ("priority", "gang", "drf")


def _water_fill_inputs(a):
    return (a["queue_weight"], a["queue_request"], a["total"], a["eps"],
            a["queue_participates"])


def _run_both(a, batch, w=(1.0, 1.0), jax_kw=None, torch_kw=None, **kw):
    des_j = np.asarray(JK.water_fill(*[jnp.asarray(x) for x in _water_fill_inputs(a)]))
    des_t = TK.water_fill(*[torch.from_numpy(x) for x in _water_fill_inputs(a)])
    np.testing.assert_allclose(des_t.numpy(), des_j, rtol=1e-6)
    jargs = [jnp.asarray(des_j) if k == "queue_deserved" else jnp.asarray(a[k])
             for k in TK._SOLVE_ARGS]
    targs = [des_t if k == "queue_deserved" else torch.from_numpy(a[k])
             for k in TK._SOLVE_ARGS]
    jw = (jnp.float32(w[0]), jnp.float32(w[1]))
    if batch:
        oj = JK.allocate_solve_batch(*jargs, *jw, exact_topk=True, **kw)
        ot = TK.allocate_solve_batch(*targs, *w, **kw)
    else:
        oj = JK.allocate_solve(*jargs, *jw, **kw, **(jax_kw or {}))
        ot = TK.allocate_solve(*targs, *w, **kw, **(torch_kw or {}))
    return oj, ot


def _assert_same(oj, ot):
    for i, name in enumerate(TK.SolveOut._fields):
        x, y = np.asarray(oj[i]), ot[i].numpy()
        if name in DECISIONS:
            np.testing.assert_array_equal(y, x, err_msg=name)
        else:
            np.testing.assert_allclose(y, x, rtol=1e-6, err_msg=name)


def test_build_sim_args_is_the_jax_copy():
    a, b = build_sim_args(20, 64, 16, seed=3, n_classes=2), jax_build_sim_args(20, 64, 16, seed=3, n_classes=2)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed,n_queues", [(0, 2), (1, 3), (2, 4), (3, 1)])
def test_water_fill_matches_jax(seed, n_queues):
    a = build_sim_args(16, 96, 24, n_queues=n_queues, seed=seed)
    a["queue_request"][0] *= 0.25  # one queue capped below its share
    des_j = np.asarray(JK.water_fill(*[jnp.asarray(x) for x in _water_fill_inputs(a)]))
    des_t = TK.water_fill(*[torch.from_numpy(x) for x in _water_fill_inputs(a)])
    np.testing.assert_allclose(des_t.numpy(), des_j, rtol=1e-6)


@pytest.mark.parametrize("case", ["staggered_1024", "cells_2048"])
def test_water_fill_many_cells_matches_jax(case):
    """K1's plain version against JAX where the card's kernel works
    hardest: 1,024 queues with staggered requests (21 rounds) and 2,048
    (queue, dim) cells.  rtol=1e-6 as above; bit-equality is expected
    (both sum over queues in index order)."""
    a = build_water_fill_args(case)
    des_j = np.asarray(JK.water_fill(*[jnp.asarray(x) for x in _water_fill_inputs(a)]))
    des_t = TK.water_fill(*[torch.from_numpy(x) for x in _water_fill_inputs(a)])
    assert des_t.shape[0] == 1024
    np.testing.assert_allclose(des_t.numpy(), des_j, rtol=1e-6)


@pytest.mark.parametrize("case", ["staggered_4096", "staggered_8192"])
def test_water_fill_two_level_matches_jax(case):
    """K1's plain version against JAX above 1,024 queues, where both sum in
    two levels of windows, up to the 8,192-cell cap.  rtol=1e-6: XLA
    contracts ``deserved + remaining * frac`` into a fused multiply-add in
    one column of its fused loop (ROADMAP.md section 3)."""
    a = build_water_fill_args(case)
    des_j = np.asarray(JK.water_fill(*[jnp.asarray(x) for x in _water_fill_inputs(a)]))
    des_t = TK.water_fill(*[torch.from_numpy(x) for x in _water_fill_inputs(a)])
    assert des_t.shape[0] * des_t.shape[1] == 8_192
    np.testing.assert_allclose(des_t.numpy(), des_j, rtol=1e-6)


WINDOW_SUM_LENGTHS = [1, 2, 31, 32, 33, 64, 65, 500, 1023, 1024, 1025, 1057,
                      4097, 8192, 32769, 65536, 100000]


@pytest.mark.parametrize("cols", [None, 1, 2, 5], ids=lambda c: f"cols{c}")
@pytest.mark.parametrize("n", WINDOW_SUM_LENGTHS)
def test_window_sum_matches_xla_bit_for_bit(n, cols):
    """K1's sum order (``window_sum0``) against ``jax.jit(jnp.sum)`` over
    axis 0 of a 1-D or [n, cols] float32 input of seeded inexact values
    spread over six decades, equal bit for bit."""
    rng = np.random.default_rng(n * 7 + (cols or 0))
    shape = (n,) if cols is None else (n, cols)
    x = (rng.random(shape) * 10.0 ** rng.integers(-3, 3, size=shape)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.sum(v, axis=0))(x))
    got = TK.window_sum0(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


SOLVE_CASES = [
    # (seed, n_classes, class_fill, max_tasks, releasing, options)
    (0, 1, 1.0, None, False, {}),
    (1, 3, 0.6, 4, True, {}),
    (2, 3, 0.6, None, False, {}),
    (3, 1, 1.0, 5, True, dict(use_proportion=False, use_gang_ready=False,
                              job_key_order=("drf", "gang", "priority"))),
    (4, 3, 0.5, 3, False, dict(use_gang_ready=False)),
    (5, 1, 1.0, 4, True, dict(use_proportion=False,
                              job_key_order=("gang", "priority", "drf"))),
]


def _case_args(seed, n_classes, fill, max_tasks, releasing=False):
    a = build_sim_args(12, 64, 16, n_queues=3, seed=seed, n_classes=n_classes,
                       class_fill=fill)
    if releasing:
        add_releasing(a, seed)
    if max_tasks is not None:
        a["node_max_tasks"][:] = max_tasks
    return a


@pytest.mark.parametrize("seed,n_classes,fill,max_tasks,releasing,opts", SOLVE_CASES)
def test_exact_solve_matches_jax(seed, n_classes, fill, max_tasks, releasing, opts):
    a = _case_args(seed, n_classes, fill, max_tasks, releasing)
    oj, ot = _run_both(a, batch=False, **opts)
    assert int(ot.steps) > 0
    _assert_same(oj, ot)


@pytest.mark.parametrize("seed,n_classes,fill,max_tasks,releasing,opts", SOLVE_CASES)
def test_batch_solve_matches_jax(seed, n_classes, fill, max_tasks, releasing, opts):
    a = _case_args(seed, n_classes, fill, max_tasks, releasing)
    oj, ot = _run_both(a, batch=True, **opts)
    _assert_same(oj, ot)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_solve_small_chunks_matches_jax(seed):
    """m_chunk/p_chunk below the job and task counts: many rounds, spill
    over several targets, pipelined placements, and lowest-rank drops with
    gang rollback."""
    a = _case_args(seed, 3, 0.6, 4, releasing=seed > 0)
    oj, ot = _run_both(a, batch=True, m_chunk=4, p_chunk=3)
    assert int(ot.steps) > 2
    _assert_same(oj, ot)


def _check_edge_shape(case, a, opts, out):
    """The case reached the shape it names."""
    F = min(opts.get("m_chunk", 512), a["job_queue"].shape[0]) * opts.get("p_chunk", 16)
    seq, node = out.task_seq.numpy(), out.task_node.numpy()
    first = (seq >= 0) & (seq < F)
    n_jobs = int((a["job_queue"] >= 0).sum())
    if case == "tied_chunks":
        assert n_jobs > TK.SEL_CHUNK and int((seq >= 0).sum()) == n_jobs
    elif case == "few_active":
        assert int(a["job_schedulable"].sum()) < opts["m_chunk"]
    elif case == "prio_zero":
        assert (a["job_prio"][:n_jobs] == 0).any() and (a["job_prio"][:n_jobs] > 0).any()
    elif case == "many_queues":
        q_first = set(a["job_queue"][a["task_job"][first]].tolist())
        assert q_first == set(a["job_queue"][:n_jobs].tolist()) and len(q_first) > 20
    elif case == "hot_node":
        assert int((first & (node == 0)).sum()) > 2 * opts["p_chunk"]
    elif case == "drop_rollback":
        dropped = np.nonzero(out.dropped.numpy())[0]
        assert dropped.size and int(out.steps) > 2
        assert (out.task_kind.numpy()[a["task_job"] == dropped[0]] == 0).all()


@pytest.mark.parametrize("case", BATCH_EDGE_CASES)
def test_batch_solve_edge_shapes_match_jax(case):
    """The shapes the batched solve's chunked select and spread accept must
    get right (simargs.build_batch_edge_args): the plain version against
    JAX with the exact top-K."""
    a, opts = build_batch_edge_args(case)
    oj, ot = _run_both(a, batch=True, **opts)
    _assert_same(oj, ot)
    _check_edge_shape(case, a, opts, ot)


VOLSEL_FIELDS = ("task_volmask_w", "task_claims", "claim_group", "group_cap", "group_global")


def _jax_portsel(p):
    def bits(w):
        return TK.unpack_bits(w).numpy()

    return (jnp.asarray(bits(p["node_ports"])), jnp.asarray(bits(p["task_ports"])),
            jnp.asarray(p["node_selcnt"].astype(np.float32)),
            jnp.asarray(bits(p["task_aff"]).astype(np.float32)),
            jnp.asarray(bits(p["task_anti"]).astype(np.float32)),
            jnp.asarray(bits(p["task_self"]).astype(np.float32)), jnp.float32(p["w_podaff"]))


def _check_exact_edge_shape(case, a, ps, vs, out):
    """The case reached the shape it names."""
    node, kind, seq = out.task_node.numpy(), out.task_kind.numpy(), out.task_seq.numpy()
    job, dropped = a["task_job"], out.dropped.numpy()
    n_tasks = int(a["task_valid"].sum())
    if case == "tied_scores":
        valid = a["node_valid"]
        assert (a["node_alloc"][valid] == a["node_alloc"][0]).all() and not a["class_score"].any()
        assert node[seq == 0][0] == 0
    elif case == "odd_nodes":
        assert a["idle"].shape[0] == 13 and int(out.steps) > 0
    elif case == "queue_drops":
        n_jobs = int((a["job_queue"] >= 0).sum())
        placed = np.bincount(job[:n_tasks][kind[:n_tasks] > 0], minlength=n_jobs)
        left = ~dropped[:n_jobs] & (placed < a["job_ntasks"][:n_jobs])
        assert a["queue_alloc_init"].shape[0] == 128 and left.any()
    elif case == "unfit_head":
        assert dropped[3] and (kind[job == 3] == 0).all()
    elif case == "long_gang":
        s0 = np.sort(seq[(job == 0) & (kind > 0)])
        assert s0.size == 32 and (np.diff(s0) == 1).all()
    elif case == "releasing_only":
        assert (kind == 2).sum() > 0 and (a["idle"][:6] == 0).all()
    elif case == "global_pool":
        cap = out.vol_cap.numpy()
        assert (cap[0] < vs["group_cap"][0]).all() and int(out.claim_node[0]) >= 0
    elif case == "port_conflict":
        hosts = node[:4][kind[:4] > 0]
        assert hosts.size >= 2 and len(set(hosts.tolist())) == hosts.size and 0 in hosts
    elif case == "anti_veto":
        mine = (job == 0) & (kind > 0)
        assert mine.any() and (node[mine] != 0).all() and (node[(job != 0) & (kind > 0)] == 0).any()


@pytest.mark.parametrize("case", EXACT_EDGE_CASES)
def test_exact_solve_edge_shapes_match_jax(case):
    """The shapes the exact solve's cluster kernel must get right
    (simargs.build_exact_edge_args): the plain version against JAX, with
    portsel and volsel where the case carries them (the JAX solve returns
    no final volume state; the decisions are compared)."""
    a, opts, ps, vs = build_exact_edge_args(case)
    jkw, tkw = {}, {}
    if ps is not None:
        jkw["portsel"] = _jax_portsel(ps)
        tkw["portsel"] = tuple(ps[k] if k == "w_podaff" else torch.from_numpy(ps[k])
                               for k in PORTSEL_KEYS)
    if vs is not None:
        jkw["volsel"] = tuple(jnp.asarray(vs[k]) for k in VOLSEL_FIELDS)
        tkw["volsel"] = interop.volsel_from_payload(vs)
    oj, ot = _run_both(a, batch=False, jax_kw=jkw, torch_kw=tkw, **opts)
    _assert_same(oj, ot)
    _check_exact_edge_shape(case, a, ps, vs, ot)


def test_releasing_capacity_pipelines():
    """The releasing cases above exercise the pipeline path (task_kind 2)."""
    kinds = []
    for seed, *_ in SOLVE_CASES:
        a = _case_args(seed, 3, 0.6, 5, releasing=True)
        for batch in (False, True):
            _, ot = _run_both(a, batch=batch)
            kinds.append(int((ot.task_kind == 2).sum()))
    assert sum(kinds) > 0


def test_score_weights_match_jax():
    a = _case_args(6, 1, 1.0, None)
    oj, ot = _run_both(a, batch=False, w=(0.7, 1.3))
    _assert_same(oj, ot)


def test_packed_layout():
    """K4: one int32 [3T + J] array, task_node | task_kind | task_seq |
    ready, equal to the JAX packed wrapper's concatenation.  Outputs that
    already lie in that layout (as the CUDA solves write them) come back as
    the buffer itself, not a copy."""
    a = _case_args(0, 1, 1.0, None)
    oj, ot = _run_both(a, batch=False)
    packed = TK.pack_outputs(ot)
    T, J = a["task_req"].shape[0], a["job_queue"].shape[0]
    assert packed.dtype == torch.int32 and packed.shape == (3 * T + J,)
    want = np.concatenate([np.asarray(oj[i]).astype(np.int32) for i in range(4)])
    np.testing.assert_array_equal(packed.numpy(), want)

    buf = torch.from_numpy(want.copy())
    views = TK.SolveOut(buf[:T], buf[T:2 * T], buf[2 * T:3 * T], buf[3 * T:], *ot[4:])
    same = TK.pack_outputs(views)
    assert same.data_ptr() == buf.data_ptr() and torch.equal(same, buf)


def test_water_fill_raises_at_round_cap(monkeypatch):
    """The reference loop has no cap; the port raises at its cap rather
    than return a partial fill."""
    a = build_sim_args(16, 96, 24, n_queues=3, seed=0)
    a["queue_request"][0] *= 0.25  # one queue capped: needs a second round
    monkeypatch.setattr(TK, "WATER_FILL_MAX_ROUNDS", 1)
    with pytest.raises(RuntimeError, match="no convergence"):
        TK.water_fill(*[torch.from_numpy(x) for x in _water_fill_inputs(a)])


def test_cpu_tensors_never_count_kernel_launches():
    a = _case_args(1, 1, 1.0, None)
    TK.reset_launches()
    _run_both(a, batch=True)
    assert all(v == 0 for v in TK.LAUNCHES.values())


def test_wrapper_rejects_bad_inputs_on_the_kernel_path():
    """The CUDA launch helper validates dtype/shape/contiguity before any
    launch (checked here with a stand-in library that must not be called)."""
    a = _case_args(0, 1, 1.0, None)
    t = {k: torch.from_numpy(a[k]) for k in TK._SOLVE_ARGS if k != "queue_deserved"}
    t["queue_deserved"] = torch.zeros(a["queue_alloc_init"].shape)
    t["task_req"] = t["task_req"].double()

    class NoLib:
        def __getattr__(self, name):
            raise AssertionError("launched despite bad inputs")

    with pytest.raises(ValueError, match="task_req"):
        TK.solve_launch(NoLib(), 0, False, t, 1.0, 1.0, ORDER, True, True)
