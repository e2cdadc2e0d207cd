"""The victim solve's per-node groups (``victim_kernels.victim_groups``)
against the JAX package's orders, and K7 / K12b driven by them.

* ``victim_groups_plain`` against ``_orders_drf``, ``_orders_prop`` and
  ``_orders_evict`` (preempt and reclaim, ``order_by_priority`` on and
  off) on ``build_victim_sim`` pools whose padding rows are dead: each
  node's list equals JAX's global order restricted to that node and to
  the rows of the mask (every row, or the live rows);
* chains of 16 ``victim_step_plain`` calls over one grouping, the state
  carried through the evictions, against the JAX ``victim_step`` chain in
  all three modes: the decision, the victim mask and every state field
  bit for bit;
* the same chain on node blocks (``victim_blocks_plain`` over one grouping
  of the whole pool);
* the edge pools of the cluster group build (``build_group_edge_args``:
  empty nodes, a node of 1,500 rows, 65,536 node rows, out-of-range nodes,
  a live mask with holes): ``group_build_plain`` on 1, 2 and 4 node
  blocks, both eviction kinds, ``order_by_priority`` on and off, against
  the JAX orders;
* groups of other constants, shapes or eviction order, or missing a live
  row, raising ValueError;
* the object path's ``_VictimDriver`` building one grouping per snapshot.

Every comparison is exact.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from volcano_tpu.scheduler import simargs as jsim
from volcano_tpu.scheduler import victim_kernels as jvk
from volcano_tpu_torch import interop
from volcano_tpu_torch.parallel import sharded as S
from volcano_tpu_torch.scheduler import tensor_actions as TA
from volcano_tpu_torch.scheduler import victim_kernels as tvk
from volcano_tpu_torch.scheduler.simargs import GROUP_EDGE_CASES, build_group_edge_args

torch.set_num_threads(1)


def _sim(seed, n_nodes=12, n_victims=90, n_jobs=9):
    c, s = jsim.build_victim_sim(n_nodes, n_victims, n_jobs, n_queues=3, seed=seed)
    jc = jvk.VictimConsts(**{k: jnp.asarray(v) for k, v in c.items()})
    js = jvk.VictimState(**{k: jnp.asarray(v) for k, v in s.items()})
    return c, s, jc, js


def _per_node(order, run_node, rows, N):
    """JAX's global order restricted to each node and to ``rows``."""
    order = np.asarray(order)
    keep = rows[order]
    return [order[keep & (run_node[order] == n)] for n in range(N)]


@pytest.mark.parametrize("seed,order_by_priority,mask",
                         list(itertools.product(range(3), (True, False), ("every", "live"))))
def test_groups_plain_equal_jax_orders(seed, order_by_priority, mask):
    c, s, jc, _ = _sim(seed)
    tc, ts = interop.victim_from_arrays(c, s)
    V, N, Q = c["run_req"].shape[0], c["node_alloc"].shape[0], s["queue_alloc"].shape[0]
    assert not s["run_live"].all(), "the pool must hold dead rows"
    rows = s["run_live"] if mask == "live" else np.ones(V, bool)
    g = tvk.victim_groups_plain(tc, torch.from_numpy(rows),
                                order_by_priority=order_by_priority)
    off = g.node_off.numpy()
    assert off[0] == 0 and off[-1] == rows.sum()
    for lst in g[1:5]:
        assert (lst.numpy()[off[-1]:] == -1).all()
    want = {
        "l_drf": jvk._orders_drf(jc)[0],
        "l_prop": jvk._orders_prop(jc, Q)[0],
        "l_ev": jvk._orders_evict(jc, order_by_priority, False)[0],
        "l_vidx": jvk._orders_evict(jc, order_by_priority, True)[0],
    }
    for name, order in want.items():
        per_node = _per_node(order, c["run_node"], rows, N)
        got = getattr(g, name).numpy()
        for n in range(N):
            np.testing.assert_array_equal(got[off[n]:off[n + 1]], per_node[n],
                                          err_msg=f"{name} node {n}")


def _node_sorted(order, node, rows):
    """JAX's global ``order`` restricted to ``rows``, stably by node: every
    node's list one after the other, as the groups lay them out."""
    order = np.asarray(order)
    order = order[rows[order]]
    return order[np.argsort(node[order], kind="stable")]


@pytest.mark.parametrize("case,n_blocks,order_by_priority",
                         list(itertools.product(GROUP_EDGE_CASES, (1, 2, 4), (True, False))))
def test_group_edge_shapes_equal_jax_orders(case, n_blocks, order_by_priority):
    """The group build's edge pools: each block's groups
    (``group_build_plain``, the plain version of a block's build: rows on
    other blocks' nodes not grouped), in both eviction kinds (preempt's
    order and reclaim's pool order as l_ev), against the JAX orders
    restricted to the block's nodes and the live rows.  JAX's orders do
    not clamp a row's node; the build clamps it into [0, N) as K7 does, so
    JAX sorts over the clamped nodes (exact: integer keys)."""
    c, s = build_group_edge_args(case)
    N, V = c["node_alloc"].shape[0], c["run_req"].shape[0]
    Q = s["queue_alloc"].shape[0]
    node = np.clip(c["run_node"], 0, N - 1).astype(np.int32)
    jc = jvk.VictimConsts(**{k: jnp.asarray(node if k == "run_node" else v)
                             for k, v in c.items()})
    rows = s["run_live"]
    tc, ts = interop.victim_from_arrays(c, s)
    want = {
        "l_drf": _node_sorted(jvk._orders_drf(jc)[0], node, rows),
        "l_prop": _node_sorted(jvk._orders_prop(jc, Q)[0], node, rows),
        "l_vidx": _node_sorted(jvk._orders_evict(jc, order_by_priority, True)[0], node, rows),
        ("l_ev", "preempt"): _node_sorted(jvk._orders_evict(jc, order_by_priority, False)[0],
                                          node, rows),
    }
    want["l_ev", "reclaim"] = want["l_vidx"]
    counts = np.bincount(node[rows], minlength=N)
    nb = N // n_blocks
    for b, ev_kind in itertools.product(range(n_blocks), ("preempt", "reclaim")):
        g = tvk.group_build_plain(tc, ts.run_live, order_by_priority, nb, ev_kind=ev_kind,
                                  n0=b * nb, nt=N)
        off = g.node_off.numpy()
        np.testing.assert_array_equal(np.diff(off), counts[b * nb:(b + 1) * nb])
        lo = counts[:b * nb].sum()
        for name in ("l_drf", "l_prop", "l_vidx", "l_ev"):
            order = want[(name, ev_kind) if name == "l_ev" else name]
            got = getattr(g, name).numpy()
            np.testing.assert_array_equal(got[:off[-1]], order[lo:lo + off[-1]],
                                          err_msg=f"{name} block {b} {ev_kind}")
            assert (got[off[-1]:] == -1).all() and got.shape == (V,)
    if case == "big_node":
        assert counts.max() == 1_500


FLAGS = [
    dict(use_gang=True, use_drf=True, use_prop=False, use_conformance=True,
         order_by_priority=True),
    dict(use_gang=False, use_drf=False, use_prop=True, use_conformance=False,
         order_by_priority=False),
    dict(use_gang=True, use_drf=True, use_prop=True, use_conformance=False,
         order_by_priority=True),
    # no drf or proportion veto: the job mode's own-job victims pass
    dict(use_gang=True, use_drf=False, use_prop=False, use_conformance=True,
         order_by_priority=False),
]


def _chain(seed, n_jobs=9):
    rng = np.random.default_rng(200 + seed)
    out = []
    for _ in range(16):
        t_req = np.array([rng.choice([250, 500, 1500, 3000]),
                          rng.choice([256, 512, 2048]) * (1 << 20)], np.float32)
        if rng.random() < 0.15:
            t_req[:] = 0  # an empty request: the do-while takes one victim
        out.append((t_req, int(rng.integers(0, n_jobs))))
    return out


def _assert_same(tout, jout, V, tag):
    assigned, nstar, vmask, clean = tvk.unpack_step(tout.packed.numpy(), V)
    assert assigned == bool(jout[1]) and clean == bool(jout[4]), tag
    assert nstar == (int(jout[2]) if assigned else 0), tag
    np.testing.assert_array_equal(vmask, np.asarray(jout[3]), err_msg=tag)
    assert int(tout.packed[3]) == int(vmask.sum()), tag
    for f in tvk.VictimState._fields:
        x = getattr(tout.state, f)
        x = torch.cat(x) if isinstance(x, tuple) else x
        np.testing.assert_array_equal(x.numpy(), np.asarray(getattr(jout[0], f)),
                                      err_msg=f"{tag} {f}")
    return assigned


@pytest.mark.parametrize("seed,mode", list(itertools.product(range(2),
                                                             ["queue", "job", "reclaim"])))
def test_chain_over_one_grouping_equals_jax(seed, mode):
    """16 solves over the groups of the first state's live rows, each
    assignment's state fed to the next, as ``_VictimDriver`` does."""
    c, s, jc, js = _sim(seed)
    tc, ts = interop.victim_from_arrays(c, s)
    V = c["run_req"].shape[0]
    n_evicted = 0
    for kw in FLAGS:
        g = tvk.victim_groups_plain(tc, ts.run_live,
                                    order_by_priority=kw["order_by_priority"])
        tstate, jstate = ts, js
        for i, (t_req, jt) in enumerate(_chain(seed)):
            qt = int(c["job_queue"][jt])
            jout = jvk.victim_step(jc, jstate, jnp.asarray(t_req), 0, jt, qt, mode=mode, **kw)
            tout = tvk.victim_step_plain(tc, tstate, torch.from_numpy(t_req), 0, jt, qt,
                                         mode=mode, groups=g, **kw)
            if _assert_same(tout, jout, V, f"{kw} step {i}"):
                n_evicted += int(tout.packed[3])
                tstate, jstate = tout.state, jout[0]
    assert n_evicted, "the chains must evict"


def test_chain_with_inexact_requests_matches_jax():
    """K7's sum of an attempt's victims (JAX ``vsum`` over the pool rows,
    in XLA's window order; the port's in float64, rounded once) with
    inexact requests: 16 reclaim solves over 600 pool rows whose requests
    are scaled by seeded factors in [1, 1.37).  Decisions and victim masks
    are equal; the float state is held to 1e-6 of its column's cluster
    total, the rounding of one sum of a few terms, since the port's
    rounded float64 sums differ from JAX's float32 ones where those are
    inexact (ROADMAP.md section 3)."""
    c, s = jsim.build_victim_sim(8, 600, 20, n_queues=3, seed=11)
    rng = np.random.default_rng(11)
    c["run_req"] = (c["run_req"] * (1 + rng.random(c["run_req"].shape) * 0.37)).astype(np.float32)
    jc = jvk.VictimConsts(**{k: jnp.asarray(v) for k, v in c.items()})
    js = jvk.VictimState(**{k: jnp.asarray(v) for k, v in s.items()})
    tc, ts = interop.victim_from_arrays(c, s)
    V = c["run_req"].shape[0]
    kw = FLAGS[0]
    g = tvk.victim_groups_plain(tc, ts.run_live, order_by_priority=kw["order_by_priority"])
    many = 0
    for i in range(16):
        t_req = np.array([rng.choice([3000, 6000, 12000]) * 1.013,
                          rng.choice([4096, 8192]) * (1 << 20) * 1.007], np.float32)
        jt = int(rng.integers(0, 20))
        qt = int(c["job_queue"][jt])
        jout = jvk.victim_step(jc, js, jnp.asarray(t_req), 0, jt, qt, mode="reclaim", **kw)
        tout = tvk.victim_step_plain(tc, ts, torch.from_numpy(t_req), 0, jt, qt,
                                     mode="reclaim", groups=g, **kw)
        assigned, nstar, vmask, clean = tvk.unpack_step(tout.packed.numpy(), V)
        assert (assigned, clean) == (bool(jout[1]), bool(jout[4])), i
        assert nstar == (int(jout[2]) if assigned else 0), i
        np.testing.assert_array_equal(vmask, np.asarray(jout[3]), err_msg=str(i))
        many += int(vmask.sum()) >= 3
        for f in tvk.VictimState._fields:
            x, y = getattr(tout.state, f).numpy(), np.asarray(getattr(jout[0], f))
            if x.dtype == np.float32:
                # each column against its own total: a CPU value off by 0.128 m fails
                off = np.abs(x.astype(np.float64) - y) > 1e-6 * c["total"].astype(np.float64)
                assert not off.any(), f"step {i} {f}: {np.argwhere(off)[:4].tolist()}"
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"step {i} {f}")
    assert many, "some solves must sum three or more victims"


@pytest.mark.parametrize("n_blocks,mode", list(itertools.product((2, 4),
                                                                 ["queue", "reclaim"])))
def test_blocks_chain_over_one_grouping_equals_jax(n_blocks, mode):
    """The chain on node blocks: one grouping of the whole pool for every
    block, equal to the same grouping built from the whole constants."""
    c, s, jc, js = _sim(1, n_nodes=16)
    tc, ts = interop.victim_from_arrays(c, s)
    V, N = c["run_req"].shape[0], c["node_alloc"].shape[0]
    mesh = S.LocalMesh(n_blocks, "cpu")
    dc, ds = S._place_victim(mesh, tc), S._place_victim(mesh, ts)
    kw = FLAGS[0]
    g = tvk.victim_groups_plain(dc, ds.run_live, mesh=mesh)
    whole = tvk.victim_groups_plain(tc, ts.run_live)
    for x, y in zip(g[:5], whole[:5]):
        assert torch.equal(x, y)
    tstate, jstate = ds, js
    for i, (t_req, jt) in enumerate(_chain(1)):
        qt = int(c["job_queue"][jt])
        jout = jvk.victim_step(jc, jstate, jnp.asarray(t_req), 0, jt, qt, mode=mode, **kw)
        tout = tvk.victim_step_sharded(dc, tstate, torch.from_numpy(t_req), 0, jt, qt, mesh,
                                       mode=mode, groups=g, **kw)
        if _assert_same(tout, jout, V, f"{n_blocks} blocks step {i}"):
            tstate, jstate = tout.state, jout[0]
    assert N % n_blocks == 0


def test_groups_of_other_constants_raise():
    c, s, _, _ = _sim(0)
    tc, ts = interop.victim_from_arrays(c, s)
    t_req = torch.tensor([1000.0, float(1 << 30)])
    g = tvk.victim_groups_plain(tc, ts.run_live)
    # the same arrays in new tensors are other constants
    tc2, _ = interop.victim_from_arrays(c, s)
    with pytest.raises(ValueError, match="other constants"):
        tvk.victim_step(tc2, ts, t_req, 0, 0, 0, groups=g)
    with pytest.raises(ValueError, match="order_by_priority"):
        tvk.victim_step(tc, ts, t_req, 0, 0, 0, groups=g, order_by_priority=False)
    with pytest.raises(ValueError, match="VictimGroups"):
        tvk.victim_step(tc, ts, t_req, 0, 0, 0, groups=tuple(g))
    # other shapes: a grouping cut to fewer node rows
    short = g._replace(node_off=g.node_off[:-1])
    with pytest.raises(ValueError, match="groups of"):
        tvk.victim_step_plain(tc, ts, t_req, 0, 0, 0, groups=short)
    mesh = S.LocalMesh(2, "cpu")
    dc, ds = S._place_victim(mesh, tc), S._place_victim(mesh, ts)
    with pytest.raises(ValueError, match="other constants"):
        tvk.victim_step_sharded(dc, ds, t_req, 0, 0, 0, mesh,
                                groups=tvk.victim_groups_plain(tc2, ts.run_live))
    with pytest.raises(ValueError, match="need their mesh"):
        tvk.victim_groups(dc, ds.run_live)
    # a grouping of the whole constants serves their blocks: same tensors
    out = tvk.victim_step_sharded(dc, ds, t_req, 0, 0, 0, mesh, groups=g)
    ref = tvk.victim_step(tc, ts, t_req, 0, 0, 0, groups=g)
    assert torch.equal(out.packed, ref.packed)


def test_groups_missing_a_live_row_raise():
    """Groups of an earlier mask serve a state whose live rows they hold
    (rows that died since are skipped), and raise on one that lives again."""
    c, s, _, _ = _sim(2)
    tc, ts = interop.victim_from_arrays(c, s)
    t_req = torch.tensor([1000.0, float(1 << 30)])
    live = ts.run_live.clone()
    v = int(torch.nonzero(live)[0, 0])
    live[v] = False
    g = tvk.victim_groups_plain(tc, live)
    dead = ts._replace(run_live=live)
    ref = tvk.victim_step_plain(tc, dead, t_req, 0, 0, 0)
    assert torch.equal(tvk.victim_step_plain(tc, dead, t_req, 0, 0, 0, groups=g).packed,
                       ref.packed)
    with pytest.raises(ValueError, match="miss rows live"):
        tvk.victim_step_plain(tc, ts, t_req, 0, 0, 0, groups=g)
    mesh = S.LocalMesh(2, "cpu")
    dc, ds = S._place_victim(mesh, tc), S._place_victim(mesh, ts)
    with pytest.raises(ValueError, match="miss rows live"):
        tvk.victim_step_sharded(dc, ds, t_req, 0, 0, 0, mesh, groups=g)


def _contended_store(n_nodes=4):
    """Low-priority singleton gangs fill every node of queue qa (two a
    node) and qb (one a node); an urgent qa gang preempts, a qb gang of
    weight 3 reclaims."""
    spec = {"priority_classes": [{"name": "urgent", "value": 10}, {"name": "low", "value": 1}],
            "queues": [{"name": "qa"}, {"name": "qb", "weight": 3}, {"name": "default"}],
            "nodes": [{"name": f"n{i}", "allocatable": {"cpu": "6", "memory": "12Gi",
                                                        "pods": 20}} for i in range(n_nodes)],
            "podgroups": [], "pods": []}
    for k, (i, q) in enumerate(itertools.product(range(n_nodes), ("qa", "qa", "qb"))):
        spec["podgroups"].append({"name": f"run{k}", "min_member": 1, "queue": q,
                                  "priority_class_name": "low", "phase": "Running"})
        spec["pods"].append({"name": f"run{k}-0", "group": f"run{k}", "priority": 1,
                             "resources": {"cpu": "2", "memory": "4Gi"},
                             "node_name": f"n{i}", "phase": "Running"})
    spec["podgroups"] += [
        {"name": "hot", "min_member": 2, "queue": "qa", "priority_class_name": "urgent",
         "phase": "Inqueue"},
        {"name": "recl", "min_member": 1, "queue": "qb", "phase": "Inqueue"}]
    spec["pods"] += [{"name": f"hot-{t}", "group": "hot", "priority": 10,
                      "resources": {"cpu": "2", "memory": "2Gi"}} for t in range(2)]
    spec["pods"].append({"name": "recl-0", "group": "recl",
                         "resources": {"cpu": "2", "memory": "2Gi"}})
    return interop.store_from_spec(spec)


def test_victim_loop_groups_once_per_snapshot(monkeypatch):
    """The object path builds one grouping per load of the snapshot
    (``_VictimDriver``'s first load and each resync) and hands it to every
    attempt."""
    from volcano_tpu_torch.scheduler.conf import full_conf
    from volcano_tpu_torch.scheduler.scheduler import Scheduler

    builds, seen, resyncs = [], [], []
    real_groups, real_step = TA.victim_groups, TA.victim_step

    def groups(*args, **kwargs):
        builds.append(real_groups(*args, **kwargs))
        return builds[-1]

    def step(*args, **kwargs):
        seen.append(kwargs.get("groups"))
        return real_step(*args, **kwargs)

    real_resync = TA._VictimDriver.resync

    def resync(vd):
        resyncs.append(vd)
        real_resync(vd)

    monkeypatch.setattr(TA, "victim_groups", groups)
    monkeypatch.setattr(TA, "victim_step", step)
    monkeypatch.setattr(TA._VictimDriver, "resync", resync)
    conf = full_conf("cpu")
    conf.fast_path = "off"
    store = _contended_store()
    sched = Scheduler(store, conf=conf)
    sched.run_once()
    assert sched.cache.evict_log, "the store must contend"
    assert len(seen) > len(builds) >= 1
    assert all(any(g is b for b in builds) for g in seen)
    # a _VictimDriver per action (preempt, reclaim), one grouping each, and one
    # more for each resync after a host detour
    assert len(builds) <= 2 + len(resyncs)
