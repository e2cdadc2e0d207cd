"""The port's contention solves (K8 reclaim_solve, K9 preempt_solve, K10
preempt_rounds) against the JAX package's on the CPU.

Inputs come from ``build_victim_sim`` (seeded numpy) plus seeded preemptor
jobs, carried into the port with ``interop.victim_from_arrays``.  Every
output is compared: the final state, ``pipe``, the records, and the
scalars (``att_total``, ``last_v``, ``any_p1`` / ``any_commit``,
``abort``).  Decisions must be equal and float state bit-equal: the
requests are whole numbers of millicores and MiB-multiples of bytes, so
every float32 sum of these sizes is exact in both packages (the module note
of ``volcano_tpu_torch/scheduler/victim_kernels.py`` has the rule).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volcano_tpu.scheduler import victim_kernels as JV
from volcano_tpu.scheduler.simargs import build_victim_sim as jax_build_victim_sim
from volcano_tpu_torch import interop
from volcano_tpu_torch.scheduler import victim_kernels as TV
from volcano_tpu_torch.scheduler.kernels import SEL_CHUNK
from volcano_tpu_torch.scheduler.simargs import (
    ROUNDS_EDGE_CASES,
    WALK_EDGE_CASES,
    WALK_ROW_COUNTS,
    build_reclaim_abort_sim,
    build_rounds_edge_args,
    build_storm_sim,
    build_victim_sim,
    build_walk_edge_args,
    storm_inputs,
)

torch.set_num_threads(1)

KEY_ORDERS = [("priority", "gang", "drf"), ("drf", "gang", "priority"),
              ("gang", "priority", "drf")]


def _jax(c, s):
    return (JV.VictimConsts(**{k: jnp.asarray(v) for k, v in c.items()}),
            JV.VictimState(**{k: jnp.asarray(v) for k, v in s.items()}))


def assert_same(jout, tout, fields):
    """Every output equal, bit for bit; JAX's tuple is positional."""
    jv = jax.tree_util.tree_map(np.asarray, jout)
    for name, j_part in zip(fields, jv):
        t_part = getattr(tout, name)
        if hasattr(t_part, "_fields"):
            jf = dict(zip(t_part._fields, j_part))
            for f in t_part._fields:
                _eq(f"{name}.{f}", jf[f], getattr(t_part, f))
        else:
            _eq(name, j_part, t_part)


def _eq(name, a, b):
    a = np.asarray(a)
    b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape, f"{name}: shape {a.shape} vs {b.shape}"
    assert np.array_equal(a, b.astype(a.dtype)), (
        f"{name} differs at {np.argwhere(a != b.astype(a.dtype))[:5].tolist()}")


def _t(a):
    return torch.from_numpy(np.asarray(a))


RECLAIM_FIELDS = ("state", "pipe", "rec", "abort")
PREEMPT_FIELDS = ("state", "pipe", "rec", "att_total", "last_v", "any_p1", "abort")
ROUNDS_FIELDS = ("state", "pipe", "rec", "att_total", "last_v", "any_commit", "cursor",
                 "dropped")


def run_reclaim(c, s, args, **kw):
    jc, js = _jax(c, s)
    jo = JV.reclaim_solve(jc, js, *[jnp.asarray(a) for a in args], **kw)
    tc, ts = interop.victim_from_arrays(c, s)
    to = TV.reclaim_solve(tc, ts, *[_t(a) for a in args], **kw)
    assert_same(jo, to, RECLAIM_FIELDS)
    return to


def run_preempt(c, s, args, **kw):
    jc, js = _jax(c, s)
    jo = JV.preempt_solve(jc, js, *[jnp.asarray(a) for a in args], **kw)
    tc, ts = interop.victim_from_arrays(c, s)
    to = TV.preempt_solve(tc, ts, *[_t(a) for a in args], **kw)
    assert_same(jo, to, PREEMPT_FIELDS)
    return to


def run_rounds(c, s, args, **kw):
    jc, js = _jax(c, s)
    jo = JV.preempt_rounds(jc, js, *[jnp.asarray(a) for a in args], **kw)
    tc, ts = interop.victim_from_arrays(c, s)
    to = TV.preempt_rounds(tc, ts, *[_t(a) for a in args], **kw)
    assert_same(jo, to, ROUNDS_FIELDS)
    return to


def test_build_victim_sim_is_the_jax_copy():
    for seed in range(3):
        a, b = build_victim_sim(8, 40, 6, seed=seed), jax_build_victim_sim(8, 40, 6, seed=seed)
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("use_prop,use_gang,use_conformance", [
    (True, True, True), (False, True, False), (True, False, True), (False, False, False),
])
def test_reclaim_matches_jax(seed, use_prop, use_gang, use_conformance):
    c, s, t = build_storm_sim(seed)
    kw = dict(use_gang=use_gang, use_prop=use_prop, use_conformance=use_conformance,
              order_by_priority=True, has_proportion=seed != 1,
              job_key_order=KEY_ORDERS[seed % 3])
    run_reclaim(c, s, storm_inputs("reclaim", c, s, t), **kw)


def test_reclaim_cases_exercise_the_loop():
    """The seeded reclaim cases above place preemptors and evict."""
    ok = 0
    for seed, prop in itertools.product(range(3), (True, False)):
        c, s, t = build_storm_sim(seed)
        kw = dict(use_gang=True, use_prop=prop, use_conformance=True, order_by_priority=True,
                  has_proportion=True)
        out = run_reclaim(c, s, storm_inputs("reclaim", c, s, t), **kw)
        ok += int(out.rec.att)
    assert ok >= 6


@pytest.mark.parametrize("seed", [0, 5, 9, 29])
@pytest.mark.parametrize("use_drf,use_gang,order_by_priority,gang_pipelined", [
    (True, True, True, True), (False, True, False, True), (True, False, True, False),
    (False, False, True, True),
])
def test_preempt_matches_jax(seed, use_drf, use_gang, order_by_priority, gang_pipelined):
    c, s, t = build_storm_sim(seed, big=seed == 9)
    kw = dict(use_gang=use_gang, use_drf=use_drf, use_conformance=seed != 29,
              order_by_priority=order_by_priority, job_key_order=KEY_ORDERS[seed % 3],
              gang_pipelined=gang_pipelined)
    run_preempt(c, s, storm_inputs("preempt", c, s, t), **kw)


def test_preempt_rollback_and_phase_two():
    """Gangs that cannot pipeline are discarded (their statements' attempts
    count in att_total but leave no record); pool jobs with pending tasks
    take within-job victims in phase 2."""
    c, s, t = build_storm_sim(5)
    kw = dict(use_gang=True, use_drf=False, use_conformance=True, order_by_priority=True)
    out = run_preempt(c, s, storm_inputs("preempt", c, s, t), **kw)
    assert not bool(out.abort)
    assert int(out.att_total) > int(out.rec.att), "no discarded attempt was counted"
    run_job = torch.from_numpy(c["run_job"])
    own = [int(j) for j in t["pre"] if j < t["n_jobs"] - 3]
    ev = out.rec.evict_att >= 0
    assert any(bool((ev & (run_job == j)).any()) and int(out.pipe[j]) for j in own)


def test_build_reclaim_abort_sim():
    """clean=False: a node earlier in the walk is valid (its victims fit
    one dimension) but does not cover; the solve aborts with the state of
    the last clean attempt, as the JAX loop does."""
    c, s, t = build_reclaim_abort_sim()
    out = run_reclaim(c, s, storm_inputs("reclaim", c, s, t), use_gang=False, use_prop=False,
                      use_conformance=False, order_by_priority=True, has_proportion=True)
    assert bool(out.abort)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("use_drf,order_by_priority,chunks", [
    (False, True, dict(m_chunk=4, p_chunk=3, k_chunk=2)),
    (True, True, dict(m_chunk=2, p_chunk=4, k_chunk=3)),
    (False, False, dict()),
    (True, False, dict(m_chunk=8, p_chunk=2, k_chunk=4)),
])
def test_rounds_match_jax(seed, use_drf, order_by_priority, chunks):
    c, s, t = build_storm_sim(seed, n_new=4, big=seed == 2)
    kw = dict(use_gang=True, use_drf=use_drf, use_conformance=True,
              order_by_priority=order_by_priority, job_key_order=KEY_ORDERS[seed % 3],
              gang_pipelined=seed != 1, **chunks)
    run_rounds(c, s, storm_inputs("rounds", c, s, t), **kw)


def test_rounds_with_inexact_requests_over_40_queues_match_jax():
    """K10's per-node sum of a round's placements over queues (JAX
    ``consumed`` over 40 queues, in XLA's window order) and its victim
    sums, with inexact requests (pool requests scaled by seeded factors in
    [1, 1.37), the preemptors' by 1.0131).  The decisions (``pipe``, the
    records, the scalars) are equal; the float state is held, column by
    column, to 1e-6 of that column's cluster total, the rounding of one sum
    of a few terms, since the port sums in float64 rounded once where JAX sums in
    float32 (ROADMAP.md section 3)."""
    c, s, t = build_storm_sim(0, n_nodes=6, n_victims=200, n_jobs=40, n_queues=40, n_new=8)
    rng = np.random.default_rng(0)
    c["run_req"] = (c["run_req"] * (1 + rng.random(c["run_req"].shape) * 0.37)).astype(np.float32)
    args = list(storm_inputs("rounds", c, s, t))
    args[0] = (np.asarray(args[0]) * 1.0131).astype(np.float32)
    kw = dict(use_gang=True, use_drf=False, use_conformance=True, order_by_priority=True,
              job_key_order=KEY_ORDERS[0], gang_pipelined=True)
    jc, js = _jax(c, s)
    jo = jax.tree_util.tree_map(np.asarray, JV.preempt_rounds(
        jc, js, *[jnp.asarray(a) for a in args], **kw))
    tc, ts = interop.victim_from_arrays(c, s)
    to = TV.preempt_rounds(tc, ts, *[_t(a) for a in args], **kw)
    assert int(to.att_total) > 0
    assert ROUNDS_FIELDS[0] == "state"
    assert_same(jo[1:], to, ROUNDS_FIELDS[1:])
    for f, a in zip(to.state._fields, jo[0]):
        b = getattr(to.state, f).numpy()
        if b.dtype == np.float32:
            # each column against its own total: a CPU value off by 0.096 m fails
            off = np.abs(b.astype(np.float64) - a) > 1e-6 * c["total"].astype(np.float64)
            assert not off.any(), f"{f}: {np.argwhere(off)[:4].tolist()}"
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


def test_rounds_cases_exercise_commits_and_victims():
    total = 0
    for seed in range(3):
        c, s, t = build_storm_sim(seed, n_new=4)
        out = run_rounds(c, s, storm_inputs("rounds", c, s, t), use_gang=True, use_drf=False,
                         use_conformance=True, order_by_priority=True,
                         m_chunk=4, p_chunk=3, k_chunk=2)
        total += int(out.att_total)
        assert int(out.att_total) == 0 or bool((out.rec.evict_att >= 0).any())
    assert total >= 6


@pytest.mark.parametrize("case", ROUNDS_EDGE_CASES)
def test_rounds_edge_matches_jax(case):
    """The rounds solve on each edge shape of its within-job count and job
    select (``build_rounds_edge_args``): every output equal to JAX's."""
    c, s, t, kw = build_rounds_edge_args(case)
    out = run_rounds(c, s, storm_inputs("rounds", c, s, t), **kw)
    assert int(out.att_total) > 0


@pytest.mark.parametrize("case", ROUNDS_EDGE_CASES)
def test_rounds_edge_reaches_its_shape(case):
    """Each rounds edge case builds the shape it names."""
    c, s, t, kw = build_rounds_edge_args(case)
    live = s["run_live"]
    J = c["job_queue"].shape[0]
    per_job = np.bincount(c["run_job"][live], minlength=J)
    active = t["pre"]
    m_chunk = kw.get("m_chunk", 128)
    if case == "padded_job0":
        dead0 = ~live & (c["run_job"] == 0) & (c["run_node"] == 0)
        assert dead0.sum() > 2 * TV.ROUNDS_COUNT_TILE
        assert per_job[0] > 0 and c["job_min"][0] > 1
    elif case == "big_job":
        j = int(per_job.argmax())
        assert per_job[j] > TV.ROUNDS_COUNT_TILE and c["job_min"][j] > 1
        assert np.unique(c["run_node"][live & (c["run_job"] == j)]).size > 1
    elif case == "tied_rows":
        key = np.stack([c["run_job"], c["run_node"], c["run_prio"], c["run_rank"]], 1)[live]
        assert np.unique(key, axis=0).shape[0] < key.shape[0]
    elif case == "no_priority_order":
        assert not kw["order_by_priority"]
        rows = np.flatnonzero(live & (c["run_node"] == 0))
        prio, rank = c["run_prio"][rows], c["run_rank"][rows]
        assert ((prio[:, None] < prio[None, :]) & (rank[:, None] > rank[None, :])).any()
    elif case == "many_chunks":
        assert J > SEL_CHUNK and active.size > m_chunk
        assert (active < SEL_CHUNK).sum() > m_chunk and (active >= SEL_CHUNK).sum() > m_chunk
        assert (t["job_prio"][active] == 0).any() and (t["job_prio"][active] != 0).any()
    elif case == "few_active":
        assert active.size < min(m_chunk, J)


def test_victim_from_arrays_round_trip():
    c, s = build_victim_sim(4, 16, 4, seed=3)
    tc, ts = interop.victim_from_arrays(c, s)
    for k, v in c.items():
        got = getattr(tc, k)
        np.testing.assert_array_equal(np.asarray(v), got.numpy() if torch.is_tensor(got) else got)
    for k, v in s.items():
        np.testing.assert_array_equal(v, getattr(ts, k).numpy())


def test_preempt_cases_exercise_rollback_and_abort():
    """The seeded preempt cases above reach every branch the comparison
    must cover: discarded statements (att_total above the kept attempts),
    an aborted walk, and clean runs with phase-1 victims."""
    kinds = set()
    for seed in (0, 5, 9, 29):
        for use_drf, use_gang, obp, gp in [(True, True, True, True), (True, False, True, False)]:
            c, s, t = build_storm_sim(seed, big=seed == 9)
            tc, ts = interop.victim_from_arrays(c, s)
            args = [a if isinstance(a, int) else _t(a) for a in storm_inputs("preempt", c, s, t)]
            out = TV.preempt_solve(tc, ts, *args, use_gang=use_gang, use_drf=use_drf,
                                   use_conformance=seed != 29, order_by_priority=obp,
                                   gang_pipelined=gp)
            kinds.add("abort" if bool(out.abort) else "clean")
            if int(out.att_total) > int(out.rec.att):
                kinds.add("rollback")
            if bool(out.any_p1):
                kinds.add("phase1")
    assert kinds == {"abort", "clean", "rollback", "phase1"}


@pytest.mark.parametrize("kind", ["reclaim", "preempt", "rounds"])
def test_scalar_resource_solves_match_jax(kind):
    """A third, scalar resource (device counts) in every request, node and
    share (the solves' resource loops run over R = 3), and tasks of three
    predicate classes with partial node masks and static scores."""
    c, s, t = build_storm_sim(0, n_new=4 if kind == "rounds" else 3, scalar=True, classes=3)
    args = storm_inputs(kind, c, s, t)
    if kind == "reclaim":
        out = run_reclaim(c, s, args, use_gang=True, use_prop=True, use_conformance=True,
                          order_by_priority=True, has_proportion=True)
        assert int(out.rec.att)
    elif kind == "preempt":
        out = run_preempt(c, s, args, use_gang=True, use_drf=True, use_conformance=True,
                          order_by_priority=True)
        assert int(out.att_total)
    else:
        out = run_rounds(c, s, args, use_gang=True, use_drf=True, use_conformance=True,
                         order_by_priority=True, m_chunk=4, p_chunk=3, k_chunk=2)
        assert int(out.att_total)


@pytest.mark.parametrize("kind", ["reclaim", "preempt"])
@pytest.mark.parametrize("case", WALK_EDGE_CASES)
def test_walk_edge_matches_jax(case, kind):
    """The reclaim and preempt walks on each edge shape of their cluster
    and node-block kernels (``build_walk_edge_args``): every output equal
    to JAX's."""
    c, s, t, kw = build_walk_edge_args(case, kind)
    run = run_reclaim if kind == "reclaim" else run_preempt
    run(c, s, storm_inputs(kind, c, s, t), **kw)


@pytest.mark.parametrize("kind", ["reclaim", "preempt"])
@pytest.mark.parametrize("case", WALK_EDGE_CASES)
def test_walk_edge_reaches_its_shape(case, kind):
    """Each walk edge case builds the shape it names, and the walk takes
    the course it names."""
    c, s, t, kw = build_walk_edge_args(case, kind)
    live = s["run_live"]
    R = c["run_req"].shape[1]
    tc, ts = interop.victim_from_arrays(c, s)
    args = [a if isinstance(a, int) else _t(a) for a in storm_inputs(kind, c, s, t)]
    out = (TV.reclaim_solve if kind == "reclaim" else TV.preempt_solve)(tc, ts, *args, **kw)
    rows = np.bincount(c["run_node"][live], minlength=c["node_alloc"].shape[0])
    if case == "row_counts":
        assert tuple(rows[:len(WALK_ROW_COUNTS)]) == WALK_ROW_COUNTS
        assert rows.max() > 1024 and int(out.rec.att) > 0
        # one attempt evicts more victims than the apply stages at once (16)
        ev = out.rec.evict_att.numpy()
        assert np.bincount(ev[ev >= 0]).max() > 16
    elif case == "tied_keys":
        n = int(c["node_valid"].sum())
        assert n == 64 and (rows[:n] == 4).all()
        assert np.unique(c["run_req"][live], axis=0).shape[0] == 1
        assert np.unique(s["used"][:n], axis=0).shape[0] == 1
        assert int(out.rec.att) > 0
    elif case == "none_covered":
        assert (t["task_req"][:t["nt"]] > c["node_alloc"].max(0)).all()
        assert int(out.rec.att) == 0 and not bool(out.abort)
    elif case == "unclean":
        assert bool(out.abort)
    elif case == "discard" and kind == "preempt":
        assert int(out.att_total) > int(out.rec.att) and not bool(out.abort)
    elif case in ("r4", "r8"):
        assert R == int(case[1:]) and int(out.rec.att) > 0
    elif case == "scalar":
        assert R == 3 and c["class_mask"].shape[0] == 3 and int(out.rec.att) > 0
