"""The contention solves on node blocks (K15a-c) and the fast cycle's
reclaim and preempt passes under a conf mesh with ``solve_mode="batch"``.

* The port's ``Scheduler`` under ``mesh`` "2" and "4" with
  ``solve_mode="batch"`` against the JAX ``Scheduler`` under the same conf
  (``exactTopK``) on the conftest's 8 virtual devices, on the scenarios of
  ``tests/test_torch_contention.py`` (``run_pair``: binds, ordered
  evictions, pipelines, pods and PodGroup phases, cycle by cycle), and
  config 6r at 1/10 scale over three cycles with the victims reaped; every
  pass runs its solve on the blocks and none on whole planes.
* The plain versions of K15a-c (``parallel/sharded.reclaim_blocks_plain``,
  ``preempt_blocks_plain``, ``rounds_blocks_plain``) against the one-block
  plain versions on seeded ``build_storm_sim`` inputs at 1, 2, 4 and 8
  local blocks, every output bit for bit (the state's node planes
  gathered): the veto and order flags, key orders and chunk sizes, a
  phase-1 statement discarded (the journal) and aborted walks.
* The same over gloo groups of 2 and 4 spawned ranks
  (``tests/torch_gloo_worker.py``), the records and sums exchanged over the
  group.
* Blocks that cannot divide the node rows raise ``ValueError``.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from volcano_tpu_torch.parallel import sharded as S
from volcano_tpu_torch.scheduler import conf as tconf
from volcano_tpu_torch.scheduler import victim_kernels as tvk
from volcano_tpu_torch.scheduler.scheduler import Scheduler
from volcano_tpu_torch import interop

from test_torch_contention import (
    TENTH_PATTERN,
    preempt_spec,
    random_contended_spec,
    reclaim_spec,
    run_pair,
    storm_spec,
    tenth_scale_spec,
)
from test_torch_parallel import spawn_ranks
from torch_gloo_worker import contention_case, flat_outputs, run_rank_contention

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

torch.set_num_threads(1)

SOLVES = ("reclaim_solve", "preempt_solve", "preempt_rounds")


@pytest.fixture
def solve_calls(monkeypatch):
    """Counts the port's contention solves: on blocks and on whole planes."""
    calls = {}

    def counting(name):
        fn = getattr(tvk, name)

        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped

    for name in SOLVES + tuple(n + "_sharded" for n in SOLVES):
        monkeypatch.setattr(tvk, name, counting(name))
    return calls


def _best_effort_spec():
    spec = preempt_spec()
    spec["pods"].append({"name": "hi-be", "group": "hi", "resources": {}})
    return spec


#: name -> (spec, run_pair keywords, the blocked solves it must launch)
SCENARIOS = {
    "storm": (lambda: storm_spec(n_nodes=8, per_node=4, n_gangs=6, gang_size=3),
              dict(cycles=2, reap=True), ("preempt_rounds_sharded",)),
    "reclaim": (reclaim_spec, dict(cycles=2, reap=True), ("reclaim_solve_sharded",)),
    "preempt": (preempt_spec, dict(cycles=2, reap=True), ("preempt_rounds_sharded",)),
    "best_effort": (_best_effort_spec, dict(actions=["enqueue", "allocate", "preempt"]),
                    ("preempt_solve_sharded",)),
    **{f"random{seed}": (lambda seed=seed: random_contended_spec(seed), {}, ())
       for seed in range(4)},
}


@pytest.mark.parametrize("name,mesh", list(itertools.product(SCENARIOS, ["2", "4"])))
def test_mesh_contention_equals_jax(name, mesh, monkeypatch, solve_calls):
    """Each scenario under ``mesh`` with ``solve_mode: batch``: the port's
    cycles equal the JAX Scheduler's under the same mesh, and every
    contention solve ran on the node blocks."""
    build, kw, launched = SCENARIOS[name]
    run_pair(build(), monkeypatch, solve_mode="batch", mesh=mesh, **kw)
    assert not any(solve_calls.get(n) for n in SOLVES), solve_calls
    assert all(solve_calls.get(n) for n in launched), solve_calls


def test_mesh_cfg6r_at_tenth_scale_equals_jax(monkeypatch, solve_calls):
    """Config 6r at 1/10 scale (1,000 nodes, 10,000 residents, 10 x 20
    reclaiming gangs) under mesh "4" with ``solve_mode: batch``, three
    cycles, the victims reaped: the JAX Scheduler's cycles under the same
    mesh and its per-cycle pattern, every reclaim pass on the blocks."""
    _, _, history = run_pair(tenth_scale_spec("cfg6r"), monkeypatch, solve_mode="batch",
                             mesh="4", cycles=3, reap=True)
    assert history == TENTH_PATTERN["cfg6r"]
    assert solve_calls.get("reclaim_solve_sharded") == 3 and not solve_calls.get("reclaim_solve")


# -- the plain blocked versions against the one-block ones ---------------------

KEY_ORDERS = [("priority", "gang", "drf"), ("drf", "gang", "priority"),
              ("gang", "priority", "drf")]

#: kind -> [(seed, flags and sim shape)]
CASES = {
    "reclaim": [
        (seed, dict(use_gang=gang, use_prop=prop, use_conformance=conf, order_by_priority=True,
                    has_proportion=seed != 1, job_key_order=KEY_ORDERS[seed % 3]))
        for seed in range(3)
        for prop, gang, conf in [(True, True, True), (False, True, False), (True, False, True),
                                 (False, False, False)]
    ],
    "preempt": [
        (seed, dict(use_gang=gang, use_drf=drf, use_conformance=seed != 29,
                    order_by_priority=obp, job_key_order=KEY_ORDERS[seed % 3],
                    gang_pipelined=gp, big=seed == 9))
        for seed in (0, 5, 9, 29)
        for drf, gang, obp, gp in [(True, True, True, True), (False, True, False, True),
                                   (True, False, True, False)]
    ],
    "rounds": [
        (seed, dict(use_gang=True, use_drf=drf, use_conformance=True, order_by_priority=obp,
                    job_key_order=KEY_ORDERS[seed % 3], gang_pipelined=seed != 1, n_new=4,
                    big=seed == 2, **chunks))
        for seed in range(3)
        for drf, obp, chunks in [(False, True, dict(m_chunk=4, p_chunk=3, k_chunk=2)),
                                 (True, True, dict(m_chunk=2, p_chunk=4, k_chunk=3)),
                                 (False, False, dict()),
                                 (True, False, dict(m_chunk=8, p_chunk=2, k_chunk=4))]
    ],
}
PLAIN = {"reclaim": (tvk.reclaim_solve_plain, S.reclaim_blocks_plain),
         "preempt": (tvk.preempt_solve_plain, S.preempt_blocks_plain),
         "rounds": (tvk.preempt_rounds_plain, S.rounds_blocks_plain)}


def _flags(kw):
    return {k: v for k, v in kw.items() if k not in ("big", "n_new")}


def _host(res):
    return {k: (torch.cat(v) if isinstance(v, tuple) else v).numpy()
            for k, v in flat_outputs(res).items()}


def _assert_outputs_equal(got, want, tag):
    assert got.keys() == want.keys(), tag
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k}: {tag}")


def _one_block(kind, seed, kw):
    tc, ts, args = contention_case(kind, seed, kw)
    return _host(PLAIN[kind][0](tc, ts, *args, **_flags(kw)))


@pytest.mark.parametrize("kind", sorted(CASES))
@pytest.mark.parametrize("n_blocks", [1, 2, 4, 8])
def test_blocked_plain_equals_one_block(kind, n_blocks):
    """Every case of ``kind`` on ``n_blocks`` local blocks: each output of
    the blocked plain version equals the one-block plain version's, state
    included (its node planes as the blocks' rows)."""
    mesh = S.LocalMesh(n_blocks, "cpu")
    for seed, kw in CASES[kind]:
        tc, ts, args = contention_case(kind, seed, kw)
        nb = tc.node_alloc.shape[0] // n_blocks
        got = PLAIN[kind][1](S._place_victim(mesh, tc), S._place_victim(mesh, ts), *args, mesh,
                             nb, **_flags(kw))
        assert isinstance(got.state.used, tuple) and len(got.state.used) == n_blocks
        _assert_outputs_equal(_host(got), _one_block(kind, seed, kw),
                              f"{kind} seed {seed} {kw} on {n_blocks} blocks")


def test_blocked_cases_reach_discards_aborts_and_commits():
    """The cases above reach what the comparison must cover: preempt
    statements discarded (ok attempts counted above the kept ones) and
    aborted walks, a reclaim walk that aborts (``build_reclaim_abort_sim``,
    held here on 2 blocks), rounds that commit and evict."""
    from volcano_tpu_torch.scheduler.simargs import build_reclaim_abort_sim, storm_inputs

    kinds = set()
    for seed, kw in CASES["preempt"]:
        out = _one_block("preempt", seed, kw)
        kinds.add("abort" if out["abort"] else "clean")
        if out["att_total"] > out["rec.att"]:
            kinds.add("discard")
    assert kinds == {"abort", "clean", "discard"}
    assert any(_one_block("rounds", seed, kw)["att_total"] for seed, kw in CASES["rounds"])
    assert any(_one_block("reclaim", seed, kw)["rec.att"] for seed, kw in CASES["reclaim"])
    c, s, t = build_reclaim_abort_sim()
    tc, ts = interop.victim_from_arrays(c, s)
    args = [torch.from_numpy(np.asarray(a)) for a in storm_inputs("reclaim", c, s, t)]
    kw = dict(use_gang=False, use_prop=False, use_conformance=False, order_by_priority=True,
              has_proportion=True)
    want = _host(tvk.reclaim_solve_plain(tc, ts, *args, **kw))
    assert want["abort"]
    mesh = S.LocalMesh(2, "cpu")
    got = tvk.reclaim_solve_sharded(S._place_victim(mesh, tc), S._place_victim(mesh, ts), *args,
                                    mesh, **kw)
    _assert_outputs_equal(_host(got), want, "reclaim abort on 2 blocks")


#: one case of each kind for the gloo groups: a discard, a drf reclaim, rounds
GLOO_CASES = [("preempt", 0, CASES["preempt"][0][1]), ("reclaim", 0, CASES["reclaim"][0][1]),
              ("rounds", 1, CASES["rounds"][1][1])]


@pytest.mark.parametrize("world", [2, 4])
def test_blocked_solves_over_gloo_equal_one_block(tmp_path, world):
    """``world`` gloo ranks, two blocks each, run the three solves with the
    records and the victim sums exchanged over the group: every rank's
    outputs (node planes gathered) equal the one-block plain versions'."""
    spawn_ranks(run_rank_contention, world, tmp_path, 2 * world, GLOO_CASES)
    wants = [_one_block(kind, seed, kw) for kind, seed, kw in GLOO_CASES]
    for r in range(world):
        with np.load(tmp_path / f"contention{r}.npz") as f:
            for i, want in enumerate(wants):
                got = {k.split(":", 1)[1]: f[k] for k in f.files if k.startswith(f"{i}:")}
                _assert_outputs_equal(got, want, f"rank {r}, case {GLOO_CASES[i][:2]}")


def test_blocks_that_cannot_divide_the_node_rows_raise():
    """A reclaim pass under 16 blocks over an 8-row node bucket raises (no
    silent one-block run); so does a solve given blocks of unequal rows or
    another count than the mesh's."""
    conf = tconf.full_conf("cpu")
    conf.solve_mode, conf.mesh = "batch", "16"
    sched = Scheduler(interop.store_from_spec(reclaim_spec()), conf=conf)
    with pytest.raises(ValueError, match="do not divide into 16 blocks"):
        sched.run_once()
    tc, ts, args = contention_case("reclaim", 0, {})
    mesh = S.LocalMesh(2, "cpu")
    dc, ds = S._place_victim(mesh, tc), S._place_victim(mesh, ts)
    flags = _flags(CASES["reclaim"][0][1])
    with pytest.raises(ValueError, match="must hold this process's 4 blocks"):
        tvk.reclaim_solve_sharded(dc, ds, *args, S.LocalMesh(4, "cpu"), **flags)
    uneven = ds._replace(used=(ds.used[0][:-1], ds.used[1]))
    with pytest.raises(ValueError, match="row counts differ"):
        tvk.reclaim_solve_sharded(dc, uneven, *args, mesh, **flags)
