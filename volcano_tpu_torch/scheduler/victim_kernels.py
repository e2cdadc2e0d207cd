"""The contention device programs: one preemptor's victim solve, reclaim,
preempt and the batched preempt rounds, as hand-written CUDA kernels for
Hopper, each with the plain PyTorch version it must agree with.

Counterpart of ``volcano_tpu/scheduler/victim_kernels.py``.  The storm
entries (``reclaim_solve``, ``preempt_solve``, ``preempt_rounds``) take the
same arguments as their JAX namesakes and return the same fields;
``victim_step`` takes the JAX function's arguments and returns the new
state with the decision packed into one int32 tensor (``unpack_step``
reads it after the one fetch):

* given CPU tensors it runs the plain PyTorch version (``*_plain``), a
  transcription of the JAX function;
* given CUDA tensors it launches the kernel of ``csrc/victim_*.cu`` (built
  at first use by ``_build``) or raises.  There is no fallback.

The victim core (``_victim_core``: candidate mask, DRF and proportion
vetoes, per-node eviction-order prefix sums, cover test, best node, state
update) is a set of device functions in ``csrc/victim_common.cuh``, run by
each storm solve and by ``victim_step``'s own launch (the object path's
preempt and reclaim, one per preemptor).  ``victim_step`` takes the pool
grouped by node once per constants (``victim_groups``: each node's rows
in the JAX orders, ``_orders_*`` restricted to the node), so an attempt
is one launch; the object path's ``_VictimDriver`` builds the groups
once per snapshot load.  ``victim_step_sharded`` (K12b)
runs the same core on node blocks of the constants and state: each
block's core over its own rows, one record exchange over the mesh, a
replicated merge and apply (``parallel/sharded.victim_blocks_plain`` is
its plain version; it shares ``_victim_flags``, the candidate and prefix
masks over a set of pool rows, and ``_victim_apply``, the state update,
with ``_victim_core``).  The storm solves run on node blocks too (K15a-c:
``reclaim_solve_sharded``, ``preempt_solve_sharded``,
``preempt_rounds_sharded``): the reclaim and preempt walks take K12b's
records, merge and owner-row apply once an attempt, and the rounds run
per block with two exchanges a round.  Their plain versions are the walks
here with ``parallel/sharded._blocks_core`` as the attempt and
``parallel/sharded.rounds_blocks_plain``, whose one-block case is
``preempt_rounds_plain`` (as K10 is K15c's).

Float rules shared by both versions:

* Segment sums (the per-(node, job), per-(node, queue) and per-node prefix
  sums, node totals, and the per-job, per-queue and per-node sums of an
  attempt's or a round's victims and grants) are accumulated in float64
  and rounded to float32 once.  Resource requests are whole numbers
  (millicores, bytes, counts), so these float64 sums are exact and do not
  depend on the order of their terms.  The JAX functions take the same
  sums in float32 as a global cumulative sum minus each segment's base;
  the two agree wherever those float32 sums are exact, which holds at the
  test sizes and fails once a global sum passes 2**24 ulps of its terms
  (see ROADMAP, section 3).
* Each state update adds or subtracts that one rounded sum, in the order
  the JAX function applies its terms.
* ``_score_nodes`` and the batch rounds' jitter round their fused
  multiply-adds once, as in ``kernels.py``.

Tie-breaks are part of the contract: every argmin takes the lowest index
among equals, and the rounds' top-K follows ``lax.top_k`` (values
descending, lower index first, ``-inf`` fill).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import numpy as np
import torch

from volcano_tpu_torch import vtprof
from volcano_tpu_torch.scheduler.kernels import (
    POS_INF,
    SEL_CHUNK,
    _KEY_CODE,
    _MAX_R,
    _check,
    _launch_key,
    _lexsort,
    _raise_on,
    _score_nodes,
    _stream,
    dominant_share,
    less_equal,
    water_fill_check,
)

SHARE_DELTA = 1e-6
#: one round's per-job proposal window in preempt_rounds; a gang whose
#: remaining min-need exceeds it must take the exact loop
ROUNDS_P_CHUNK = 32
#: node rows a CTA of the rounds kernel scores in shared memory (32 KB of
#: floats); the score pass runs over ceil(N / ROUNDS_TILE) tiles
ROUNDS_TILE = 8192
#: entries of a job's bucket that one work item of the rounds solve's
#: within-job count compares with its live rows (csrc VTT_CNT_TILE)
ROUNDS_COUNT_TILE = 256

#: kernel launches since the last ``reset_launches()``; each CUDA wrapper
#: adds one where it launches its kernel, and nowhere else
LAUNCHES: Dict[str, int] = {
    "victim_groups": 0,
    "victim_step": 0,
    "victim_step_sharded": 0,
    "reclaim_solve": 0,
    "preempt_solve": 0,
    "preempt_rounds": 0,
    "reclaim_solve_sharded": 0,
    "preempt_solve_sharded": 0,
    "preempt_rounds_sharded": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class VictimConsts(NamedTuple):
    """Cycle-constant arrays for victim selection."""

    run_req: torch.Tensor        # [V, R] f32 resreq of running tasks
    run_node: torch.Tensor       # [V] i32 node index
    run_job: torch.Tensor        # [V] i32 job index
    run_prio: torch.Tensor       # [V] i32 task priority
    run_rank: torch.Tensor       # [V] i32 arrival rank (reverse-order ties)
    run_evictable: torch.Tensor  # [V] bool conformance veto precomputed
    job_queue: torch.Tensor      # [J] i32
    job_min: torch.Tensor        # [J] i32
    node_alloc: torch.Tensor     # [N, R] f32
    node_max_tasks: torch.Tensor  # [N] i32
    node_valid: torch.Tensor     # [N] bool
    class_mask: torch.Tensor     # [C, N] bool
    class_score: torch.Tensor    # [C, N] f32
    queue_deserved: torch.Tensor  # [Q, R] f32
    total: torch.Tensor          # [R] f32
    eps: torch.Tensor            # [R] f32
    w_least: float
    w_balanced: float


class VictimState(NamedTuple):
    """The session state a solve mutates (the solves return a new one)."""

    run_live: torch.Tensor      # [V] bool not yet evicted
    idle: torch.Tensor          # [N, R] f32
    releasing: torch.Tensor     # [N, R] f32
    used: torch.Tensor          # [N, R] f32
    task_count: torch.Tensor    # [N] i32
    job_alloc: torch.Tensor     # [J, R] f32 drf allocated
    job_occupied: torch.Tensor  # [J] i32 ready task count
    queue_alloc: torch.Tensor   # [Q, R] f32 proportion allocated


class VictimGroups(NamedTuple):
    """The rows of a live mask grouped by node (``victim_groups``): node n's rows are
    ``l_*[node_off[n]:node_off[n + 1]]`` in four orders, pool order, (job,
    row), (queue, row) and the preempt eviction order; reclaim evicts in
    pool order.  Each node's list is the JAX package's global lexsort
    (``_orders_*``) restricted to that node and to the grouped rows, a
    row's node clamped into [0, N).  The lists read only the constants, so
    one grouping serves every solve over those constants whose state has
    no live row outside it (rows that die stay in the lists and are
    skipped); under a mesh one grouping of the whole pool serves every
    block, a block's lists the slice of its node rows."""

    node_off: torch.Tensor  # [N + 1] i32
    l_vidx: torch.Tensor    # [V] i32, -1 past node_off[N]
    l_ev: torch.Tensor      # [V] i32 (priority asc when order_by_priority, rank desc, row)
    l_drf: torch.Tensor     # [V] i32 (job, row)
    l_prop: torch.Tensor    # [V] i32 (queue, row)
    order_by_priority: bool
    source: tuple           # the constants' tensors the lists were built from


class VictimStepOut(NamedTuple):
    """``victim_step``'s result: the new state (the input state is left
    untouched) and the decision as int32 [4 + ceil(V / 32)]: assigned,
    nstar (0 when unassigned), clean, the victim count, then the victim
    mask, bit ``v % 32`` of word ``v // 32``."""

    state: "VictimState"
    packed: torch.Tensor


class StormRecords(NamedTuple):
    """A storm solve's decision log, turned into ordered eviction and
    pipeline lists on the host after one fetch."""

    evict_att: torch.Tensor  # [V] i32 ok-attempt seq that evicted the row, -1
    pipe_node: torch.Tensor  # [T] i32 node the task pipelined onto, -1
    pipe_att: torch.Tensor   # [T] i32 ok-attempt seq of the pipeline, -1
    att: torch.Tensor        # i32 count of ok attempts


class ReclaimOut(NamedTuple):
    state: VictimState
    pipe: torch.Tensor       # [J] i32
    rec: StormRecords
    abort: torch.Tensor      # bool


class PreemptOut(NamedTuple):
    state: VictimState
    pipe: torch.Tensor
    rec: StormRecords
    att_total: torch.Tensor  # i32 ok attempts, rollbacks included
    last_v: torch.Tensor     # i32 victims of the last phase-1 ok attempt
    any_p1: torch.Tensor     # bool any phase-1 ok attempt
    abort: torch.Tensor


class RoundsOut(NamedTuple):
    state: VictimState
    pipe: torch.Tensor
    rec: StormRecords
    att_total: torch.Tensor  # i32 committed tasks
    last_v: torch.Tensor     # i32 victims of the last progressing round
    any_commit: torch.Tensor  # bool
    cursor: torch.Tensor     # [J] i32
    dropped: torch.Tensor    # [J] bool


# --------------------------------------------------------------------------
# shared pieces of the plain versions
# --------------------------------------------------------------------------

def _seg_cumsum(values, new_seg):
    """Inclusive prefix sums within runs delimited by ``new_seg`` flags,
    accumulated in float64 and rounded once (see the module note)."""
    n = values.shape[0]
    v = values.double()
    cum = torch.cumsum(v, dim=0)
    idx = torch.arange(n, device=values.device)
    start = torch.cummax(torch.where(new_seg, idx, torch.zeros_like(idx)), dim=0).values
    return (cum - (cum[start] - v[start])).to(values.dtype)


def _segment_sum(values, seg, n_seg):
    """Per-segment sums of [V, R] float values in float64, rounded once."""
    out = torch.zeros((n_seg,) + tuple(values.shape[1:]), dtype=torch.float64,
                      device=values.device)
    out.index_add_(0, seg.long(), values.double())
    return out.float()


def _segment_count(mask, seg, n_seg):
    out = torch.zeros(n_seg, dtype=torch.int32, device=mask.device)
    out.index_add_(0, seg.long(), mask.int())
    return out


def _seg_flags(*keys):
    """True where any of the (already sorted) keys changes, and at 0."""
    n = keys[0].shape[0]
    flag = torch.zeros(n, dtype=torch.bool, device=keys[0].device)
    if n:
        flag[0] = True
    for k in keys:
        flag[1:] |= k[1:] != k[:-1]
    return flag


def _lex_argmin(mask, keys):
    """First index minimizing (keys...) lexicographically within mask."""
    m = mask
    for k in keys:
        kmin = torch.min(torch.where(m, k, torch.full_like(k, POS_INF)))
        m = m & (k == kmin)
    return int(torch.argmax(m.to(torch.int8)))


def _orders_drf(c: VictimConsts):
    """(node, job, pool-index) order + segment-start flags."""
    V = c.run_req.shape[0]
    vidx = torch.arange(V, device=c.run_req.device)
    o = _lexsort((vidx, c.run_job, c.run_node))
    return o, _seg_flags(c.run_node[o], c.run_job[o])


def _orders_prop(c: VictimConsts, Q: int):
    """(node, queue, pool-index) order + segment flags."""
    V = c.run_req.shape[0]
    vidx = torch.arange(V, device=c.run_req.device)
    rq = torch.clamp(c.job_queue[c.run_job], 0, Q - 1)
    o = _lexsort((vidx, rq, c.run_node))
    return o, _seg_flags(c.run_node[o], rq[o])


def _orders_evict(c: VictimConsts, order_by_priority: bool, reclaim_mode: bool):
    """Per-node eviction order: preempt drains (priority asc, rank desc);
    reclaim evicts in pool (insertion) order."""
    V = c.run_req.shape[0]
    vidx = torch.arange(V, device=c.run_req.device)
    if reclaim_mode:
        o = _lexsort((vidx, c.run_node))
    else:
        prio = c.run_prio if order_by_priority else torch.zeros_like(c.run_prio)
        o = _lexsort((vidx, -c.run_rank, prio, c.run_node))
    return o, _seg_flags(c.run_node[o])


def _group_source(c: VictimConsts) -> tuple:
    """The constants' tensors a grouping reads."""
    return (c.run_node, c.run_job, c.job_queue, c.run_prio, c.run_rank)


def _group_nodes(c: VictimConsts, mesh=None) -> int:
    """Node rows of the constants: whole, or this process's blocks of
    ``mesh``."""
    if mesh is None:
        if isinstance(c.node_alloc, (tuple, list)):
            raise ValueError("victim_groups: constants in blocks need their mesh")
        return int(c.node_alloc.shape[0])
    return int(c.node_alloc[0].shape[0]) * mesh.size


def victim_groups_plain(c: VictimConsts, live, *, order_by_priority=True,
                        mesh=None) -> VictimGroups:
    """The plain PyTorch version of ``victim_groups``."""
    N = _group_nodes(c, mesh)
    V = c.run_req.shape[0]
    Q = c.queue_deserved.shape[0]
    dev = c.run_req.device
    rows = torch.nonzero(live, as_tuple=False)[:, 0]
    node = torch.clamp(c.run_node[rows], 0, N - 1)
    job = c.run_job[rows]
    queue = torch.clamp(c.job_queue[job], 0, Q - 1)
    prio = c.run_prio[rows] if order_by_priority else torch.zeros_like(node)

    def lists(*keys):
        out = torch.full((V,), -1, dtype=torch.int32, device=dev)
        out[:rows.shape[0]] = rows[_lexsort((rows,) + keys + (node,))].int()
        return out

    node_off = torch.zeros(N + 1, dtype=torch.int32, device=dev)
    node_off[1:] = torch.cumsum(torch.bincount(node, minlength=N), 0)
    return VictimGroups(node_off, lists(), lists(-c.run_rank[rows], prio), lists(job),
                        lists(queue), bool(order_by_priority), _group_source(c))


def group_build_plain(c: VictimConsts, live, order_by_priority, n_nodes, *,
                      ev_kind="preempt", n0=0, nt=None) -> VictimGroups:
    """The plain version of ``victim_groups_launch``: the groups of the rows
    of ``live`` over node rows [n0, n0 + n_nodes) of ``nt``, l_ev in the
    eviction order ``ev_kind``.  A block's groups are the slice of the
    whole pool's (``victim_groups_plain``) at its node rows; reclaim's
    eviction order is the pool order, the rounds solve's (queue, priority,
    -rank, row) within each node."""
    nt = n_nodes if nt is None else nt
    if ev_kind not in EV_KINDS:
        raise ValueError(f"group_build_plain: ev_kind must be one of {tuple(EV_KINDS)}")
    if nt != _group_nodes(c) or not 0 <= n0 <= nt - n_nodes:
        raise ValueError(f"group_build_plain: node rows [{n0}, {n0 + n_nodes}) of {nt}, the "
                         f"constants have {_group_nodes(c)}")
    g = victim_groups_plain(c, live, order_by_priority=order_by_priority)
    lo, hi = int(g.node_off[n0]), int(g.node_off[n0 + n_nodes])
    V = c.run_req.shape[0]

    def cut(lst):
        out = torch.full((V,), -1, dtype=torch.int32, device=lst.device)
        out[:hi - lo] = lst[lo:hi]
        return out

    l_ev = {"preempt": g.l_ev, "reclaim": g.l_vidx}.get(ev_kind)
    if l_ev is None:
        rows = g.l_vidx.long()[:int(g.node_off[-1])]
        Q = c.queue_deserved.shape[0]
        node = torch.clamp(c.run_node[rows], 0, nt - 1)
        queue = torch.clamp(c.job_queue[c.run_job[rows]], 0, Q - 1)
        prio = c.run_prio[rows] if order_by_priority else torch.zeros_like(node)
        l_ev = rows[_lexsort((rows, -c.run_rank[rows], prio, queue, node))].int()
    return VictimGroups(g.node_off[n0:n0 + n_nodes + 1] - lo, cut(g.l_vidx), cut(l_ev),
                        cut(g.l_drf), cut(g.l_prop), bool(order_by_priority), g.source)


def _check_groups(name, g, c: VictimConsts, n_nodes: int, order_by_priority) -> None:
    """``g`` groups the pool of ``c`` over ``n_nodes`` rows, on its device,
    in the eviction order asked for; else ValueError."""
    if not isinstance(g, VictimGroups):
        raise ValueError(f"{name}: groups must be a VictimGroups, got {type(g).__name__}")
    if len(g.source) != 5 or any(x is not y for x, y in zip(g.source, _group_source(c))):
        raise ValueError(f"{name}: the groups were built for other constants")
    V = c.run_req.shape[0]
    if g.node_off.shape != (n_nodes + 1,) or any(x.shape != (V,) for x in g[1:5]):
        raise ValueError(f"{name}: groups of {g.node_off.shape[0] - 1} nodes and "
                         f"{g.l_vidx.shape[0]} rows, the solve has {n_nodes} and {V}")
    if any(x.device != c.run_req.device or x.dtype != torch.int32 for x in g[:5]):
        raise ValueError(f"{name}: groups must be int32 on {c.run_req.device}")
    if g.order_by_priority != bool(order_by_priority):
        raise ValueError(f"{name}: groups built with order_by_priority="
                         f"{g.order_by_priority}, the solve asks {bool(order_by_priority)}")


def _step_groups(name, c, live, groups, order_by_priority, mesh=None) -> VictimGroups:
    """``groups`` checked against the solve and against the rows live in
    ``live`` (each must be grouped), or the plain grouping of those rows
    when not given."""
    if groups is None:
        return victim_groups_plain(c, live, order_by_priority=order_by_priority, mesh=mesh)
    _check_groups(name, groups, c, _group_nodes(c, mesh), order_by_priority)
    grouped = torch.zeros_like(live)
    grouped[groups.l_vidx[:int(groups.node_off[-1])].long()] = True
    if bool((live & ~grouped).any()):
        raise ValueError(f"{name}: the groups miss rows live in the state")
    return groups


def _group_orders(c, g: VictimGroups, Q, n_nodes, reclaim, use_drf, use_prop):
    """The (order, segment-start flags) pairs of ``_victim_flags`` from the
    groups' lists: drf and proportion where their vetoes are on, then the
    eviction order (reclaim: pool order)."""
    m = int(g.node_off[-1])
    node = torch.clamp(c.run_node, 0, n_nodes - 1)

    def order(lst, *keys):
        o = lst[:m].long()
        return o, _seg_flags(node[o], *(k[o] for k in keys))

    none = (None, None)
    drf = order(g.l_drf, c.run_job) if use_drf else none
    prop = (order(g.l_prop, torch.clamp(c.job_queue[c.run_job], 0, Q - 1)) if use_prop
            else none)
    return drf + prop + order(g.l_vidx if reclaim else g.l_ev)


def _job_order_keys(c, s, job_prio, job_key_order):
    """The session job order as lexicographic keys (priority desc, gang
    not-ready first, DRF share asc), then the job index."""
    J = c.job_queue.shape[0]
    keys = []
    for name in job_key_order:
        if name == "priority":
            keys.append(-job_prio.float())
        elif name == "gang":
            keys.append((s.job_occupied >= c.job_min).float())
        elif name == "drf":
            keys.append(dominant_share(s.job_alloc, c.total[None, :]))
    keys.append(torch.arange(J, device=job_prio.device).float())
    return keys


def _clone_state(s: VictimState) -> VictimState:
    """A copy of the state; node planes held as tuples of blocks stay so."""
    return VictimState(*[tuple(b.clone() for b in x) if isinstance(x, tuple) else x.clone()
                         for x in s])


def _victim_flags(c, s, t_req, jt, base, o_drf, seg_drf, o_prop, seg_prop, o_ev, seg_ev, *,
                  use_gang, use_drf, use_prop, use_conformance, rows=None):
    """(cand, in_prefix) bool [V]: the pool rows that pass the vetoes, and
    those in their node's eviction-order prefix that covers ``t_req``.
    Each order (``o_*``) groups the pool by node, with its segment-start
    flags (``seg_*``).  ``rows`` (bool [V], whole nodes) restricts both to
    those pool rows, as one node block of the mesh sees them: each order
    keeps its rows' node segments, whose start flags stay as they were."""
    V = c.run_req.shape[0]
    Q = s.queue_alloc.shape[0]
    dev = c.run_req.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    none = torch.zeros(V, dtype=torch.bool, device=dev)

    def keep(o, seg):
        if rows is None:
            return o, seg
        k = rows[o]
        return o[k], seg[k]

    cand = base.clone() if rows is None else base & rows
    if rows is not None and not bool(rows.any()):
        return cand, none
    rq_raw = c.job_queue[c.run_job]
    has_q = rq_raw >= 0
    run_q = torch.clamp(rq_raw, 0, Q - 1)

    if use_conformance:
        cand &= c.run_evictable
    if use_gang:
        occ = s.job_occupied[c.run_job]
        vmin = c.job_min[c.run_job]
        cand &= (vmin <= occ - 1) | (vmin == 1)
    if use_drf:
        o, seg = keep(o_drf, seg_drf)
        ls = dominant_share(s.job_alloc[jt] + t_req, c.total)
        sreq = torch.where(base[o, None], c.run_req[o], zero)
        relcum = _seg_cumsum(sreq, seg)
        rs = dominant_share(s.job_alloc[c.run_job[o]] - relcum, c.total)
        admit = none.clone()
        admit[o] = (ls < rs) | (torch.abs(ls - rs) <= SHARE_DELTA)
        cand &= admit
    if use_prop:
        o, seg = keep(o_prop, seg_prop)
        sreq = torch.where((base & has_q)[o, None], c.run_req[o], zero)
        relcum = _seg_cumsum(sreq, seg)
        sq = run_q[o]
        admit = none.clone()
        admit[o] = less_equal(c.queue_deserved[sq], s.queue_alloc[sq] - relcum,
                              c.eps) & has_q[o]
        cand &= admit

    # eviction-order prefix sums per node; the host loop evicts a node's
    # first admitted victim before its cover check (do-while), so the
    # first candidate of each node is in the prefix unconditionally
    o, seg = keep(o_ev, seg_ev)
    cand_s = cand[o]
    s2req = torch.where(cand_s[:, None], c.run_req[o], zero)
    cum_excl = _seg_cumsum(s2req, seg) - s2req
    cand_cnt = _seg_cumsum(cand_s.float()[:, None], seg)[:, 0]
    first_cand = cand_s & (cand_cnt == 1)
    in_prefix = none.clone()
    in_prefix[o] = cand_s & (first_cand | ~less_equal(t_req[None, :], cum_excl, c.eps))
    return cand, in_prefix


def _victim_apply(c, s, t_req, jt, qt, assigned, vmask):
    """The node-free part of one solve's state update: (run_live,
    job_alloc, job_occupied, queue_alloc), with the victims' summed request
    and the preemptor's granted request, which ``_add_to_node`` adds to
    nstar's rows."""
    J = c.job_queue.shape[0]
    Q = s.queue_alloc.shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=c.run_req.device)
    vreq = torch.where(vmask[:, None], c.run_req, zero)
    vsum = vreq.double().sum(0).float()
    t_add = t_req if assigned else torch.zeros_like(t_req)
    job_alloc = s.job_alloc - _segment_sum(vreq, c.run_job, J)
    job_alloc[jt] = job_alloc[jt] + t_add
    job_occupied = s.job_occupied - _segment_count(vmask, c.run_job, J)
    rq_raw = c.job_queue[c.run_job]
    run_q = torch.clamp(rq_raw, 0, Q - 1)
    qtgt = torch.where(rq_raw >= 0, run_q, torch.full_like(run_q, Q))
    queue_alloc = s.queue_alloc - _segment_sum(vreq, qtgt, Q + 1)[:Q]
    if qt >= 0:
        queue_alloc[min(qt, Q - 1)] = queue_alloc[min(qt, Q - 1)] + t_add
    return (s.run_live & ~vmask, job_alloc, job_occupied, queue_alloc), vsum, t_add


def _add_to_node(releasing, used, task_count, row, vsum, t_add, assigned):
    """nstar's rows after the solve (in place): its victims' request now
    releasing less the granted request, which it now uses."""
    releasing[row] = releasing[row] + (vsum - t_add)
    used[row] = used[row] + t_add
    task_count[row] += 1 if assigned else 0


def _victim_core(c, s, t_req, t_cls, jt, qt, base, o_drf, seg_drf, o_prop,
                 seg_prop, o_ev, seg_ev, *, use_gang, use_drf, use_prop,
                 use_conformance, reclaim_mode):
    """One preemptor's victim solve over all nodes.  Returns (new_state,
    assigned, nstar, vmask, clean); ``clean=False`` means the reference's
    host walk would strand evictions on a node that cannot cover the
    request, and the new state must be discarded."""
    N = s.idle.shape[0]
    dev = c.run_req.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    cand, in_prefix = _victim_flags(
        c, s, t_req, jt, base, o_drf, seg_drf, o_prop, seg_prop, o_ev, seg_ev,
        use_gang=use_gang, use_drf=use_drf, use_prop=use_prop, use_conformance=use_conformance)

    node_tgt = torch.where(cand, c.run_node, torch.full_like(c.run_node, N))
    node_tot = _segment_sum(torch.where(cand[:, None], c.run_req, zero), node_tgt, N + 1)[:N]
    any_adm = _segment_count(cand, node_tgt, N + 1)[:N] > 0
    pred_ok = c.node_valid & c.class_mask[t_cls] & (s.task_count + 1 <= c.node_max_tasks)
    validate = ~torch.all(node_tot < t_req[None, :], dim=-1)
    valid_node = pred_ok & any_adm & validate
    covered = less_equal(t_req[None, :], node_tot, c.eps) & valid_node

    score = _score_nodes(t_req, s.used, c.node_alloc, c.class_score[t_cls],
                         c.w_least, c.w_balanced)
    if reclaim_mode:
        walk_key = torch.arange(N, device=dev).float()
    else:
        walk_key = -score
    inf = torch.full_like(walk_key, POS_INF)
    kmin_cov = torch.min(torch.where(covered, walk_key, inf))
    nstar = int(torch.argmax((covered & (walk_key == kmin_cov)).to(torch.int8)))
    kmin_val = torch.min(torch.where(valid_node, walk_key, inf))
    nstar_val = int(torch.argmax((valid_node & (walk_key == kmin_val)).to(torch.int8)))
    assigned = bool(covered.any())
    if assigned:
        clean = bool(kmin_val == kmin_cov) and nstar_val == nstar
    else:
        clean = not bool(valid_node.any())

    vmask = in_prefix & (c.run_node == nstar) & assigned
    (run_live, job_alloc, job_occupied, queue_alloc), vsum, t_add = _victim_apply(
        c, s, t_req, jt, qt, assigned, vmask)
    releasing, used, task_count = s.releasing.clone(), s.used.clone(), s.task_count.clone()
    _add_to_node(releasing, used, task_count, nstar, vsum, t_add, assigned)
    new_state = VictimState(
        run_live=run_live, idle=s.idle, releasing=releasing,
        used=used, task_count=task_count, job_alloc=job_alloc,
        job_occupied=job_occupied, queue_alloc=queue_alloc,
    )
    return new_state, assigned, nstar, vmask, clean


# --------------------------------------------------------------------------
# K7: one preemptor's victim solve
# --------------------------------------------------------------------------

_STEP_MODES = {"queue": 0, "job": 1, "reclaim": 2}


def _step_base(c, s, jt, qt, mode):
    """The candidate pool by mode; raw queue rows keep -1 (a job whose
    queue is missing) so such residents never match a real queue."""
    rq_raw = c.job_queue[c.run_job]
    if mode == "queue":
        return s.run_live & (rq_raw == qt) & (c.run_job != jt)
    if mode == "job":
        return s.run_live & (c.run_job == jt)
    return s.run_live & (rq_raw != qt)


def pack_step(assigned: bool, nstar: int, clean: bool, vmask: torch.Tensor) -> torch.Tensor:
    """The packed int32 decision of ``VictimStepOut`` from its parts."""
    V = vmask.shape[0]
    nw = (V + 31) // 32
    bits = torch.zeros(nw * 32, dtype=torch.int64, device=vmask.device)
    bits[:V] = vmask.long()
    words = (bits.view(nw, 32) << torch.arange(32, device=vmask.device)).sum(1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words).int()
    head = torch.tensor([int(assigned), nstar if assigned else 0, int(clean),
                         int(vmask.sum())], dtype=torch.int32, device=vmask.device)
    return torch.cat([head, words])


def unpack_step(packed, V: int):
    """(assigned, nstar, vmask [V] bool numpy, clean) from the fetched
    packed decision (numpy int32)."""
    words = np.ascontiguousarray(packed[4:]).view(np.uint8)
    vmask = np.unpackbits(words, bitorder="little")[:V].astype(bool)
    return bool(packed[0]), int(packed[1]), vmask, bool(packed[2])


def victim_step_plain(c, s, t_req, t_cls, jt, qt, *, mode="queue", use_gang=True,
                      use_drf=False, use_prop=False, use_conformance=False,
                      order_by_priority=True, groups=None) -> VictimStepOut:
    """The JAX ``victim_step``: the mode's base mask over ``_victim_core``,
    each node's orders the lists of ``groups`` (``victim_groups_plain`` of
    the rows live in ``s`` when not given)."""
    N = s.idle.shape[0]
    groups = _step_groups("victim_step", c, s.run_live, groups, order_by_priority)
    base = _step_base(c, s, jt, qt, mode)
    orders = _group_orders(c, groups, s.queue_alloc.shape[0], N, mode == "reclaim", use_drf,
                           use_prop)
    new_s, assigned, nstar, vmask, clean = _victim_core(
        c, s, t_req, t_cls, jt, qt, base, *orders,
        use_gang=use_gang, use_drf=use_drf, use_prop=use_prop,
        use_conformance=use_conformance, reclaim_mode=(mode == "reclaim"))
    return VictimStepOut(new_s, pack_step(assigned, nstar, clean, vmask))


def _empty_records(V, T, dev):
    return dict(
        evict_att=torch.full((V,), -1, dtype=torch.int32, device=dev),
        pipe_node=torch.full((T,), -1, dtype=torch.int32, device=dev),
        pipe_att=torch.full((T,), -1, dtype=torch.int32, device=dev),
        att=0,
    )


def _records(rec, dev) -> StormRecords:
    return StormRecords(rec["evict_att"], rec["pipe_node"], rec["pipe_att"],
                        torch.tensor(rec["att"], dtype=torch.int32, device=dev))


def _record_ok(rec, vmask, t, nstar):
    """An ok attempt: its victims, its pipeline, the next sequence number."""
    rec["evict_att"][vmask] = rec["att"]
    rec["pipe_node"][t] = nstar
    rec["pipe_att"][t] = rec["att"]
    rec["att"] += 1


# --------------------------------------------------------------------------
# K8: the whole reclaim action
# --------------------------------------------------------------------------

def _walk_core(c, Q, reclaim, *, use_gang, use_drf, use_prop, use_conformance,
               order_by_priority, blocks=None):
    """The attempt of a storm walk as ``core(s, t_req, t_cls, jt, qt, base)``
    -> (new_state, assigned, nstar, vmask, clean): ``_victim_core`` over
    whole node planes or, with ``blocks`` = (mesh, rows a block), over the
    node blocks of ``parallel/sharded._blocks_core``.  The pool orders are
    taken once a solve."""
    none = (None, None)
    orders = ((_orders_drf(c) if use_drf else none) + (_orders_prop(c, Q) if use_prop else none)
              + _orders_evict(c, order_by_priority, reclaim))
    flags = dict(use_gang=use_gang, use_drf=use_drf, use_prop=use_prop,
                 use_conformance=use_conformance)
    if blocks is not None:
        from volcano_tpu_torch.parallel.sharded import _blocks_core

        mesh, nb = blocks
        return lambda s, t_req, t_cls, jt, qt, base: _blocks_core(
            c, s, t_req, t_cls, jt, qt, base, orders, flags, mesh, nb, reclaim)
    return lambda s, t_req, t_cls, jt, qt, base: _victim_core(
        c, s, t_req, t_cls, jt, qt, base, *orders, reclaim_mode=reclaim, **flags)


def reclaim_solve_plain(c, s0, task_req, task_class, job_first, job_prio,
                        job_cand0, queue_live0, pipe0, *, use_gang, use_prop,
                        use_conformance, order_by_priority, has_proportion,
                        job_key_order=("priority", "gang", "drf"), blocks=None):
    """reclaim.go:42-201: pop the queue with the lowest proportion share,
    pop its best job once, attempt its head task cross-queue, re-arm the
    queue only on success.  ``blocks`` (mesh, rows a block): the node
    planes of ``c`` and ``s0`` are tuples of this process's blocks, and each
    attempt runs on them (K15a's plain version)."""
    dev = c.run_req.device
    T = task_req.shape[0]
    J = c.job_queue.shape[0]
    Q = s0.queue_alloc.shape[0]
    V = c.run_req.shape[0]
    core = _walk_core(c, Q, True, use_gang=use_gang, use_drf=False, use_prop=use_prop,
                      use_conformance=use_conformance, order_by_priority=order_by_priority,
                      blocks=blocks)
    cap = 2 * (J + Q) + 64

    s = _clone_state(s0)
    qlive = queue_live0.clone()
    javail = job_cand0.clone()
    pipe = pipe0.clone()
    rec = _empty_records(V, T, dev)
    abort = False
    iters = 0
    while not abort and bool(qlive.any()) and iters < cap:
        if has_proportion:
            q_share = dominant_share(s.queue_alloc, c.queue_deserved)
        else:
            q_share = torch.zeros(Q, dtype=torch.float32, device=dev)
        qkey = torch.where(qlive, q_share, torch.full_like(q_share, POS_INF))
        qstar = int(torch.argmax((qlive & (q_share == qkey.min())).to(torch.int8)))
        overused = has_proportion and bool(
            less_equal(c.queue_deserved[qstar], s.queue_alloc[qstar], c.eps))
        jcand = javail & (c.job_queue == qstar)
        if not bool(jcand.any()) or overused:
            qlive[qstar] = False
        else:
            keys = _job_order_keys(c, s, job_prio, job_key_order)
            j = _lex_argmin(jcand, keys)
            t = min(max(int(job_first[j]), 0), T - 1)
            qt = int(c.job_queue[j])
            base = s.run_live & (c.job_queue[c.run_job] != qt)
            new_s, assigned, nstar, vmask, clean = core(s, task_req[t], int(task_class[t]), j,
                                                        qt, base)
            ok = assigned and clean
            javail[j] = False
            qlive[qstar] = ok
            if ok:
                s = new_s
                pipe[j] += 1
                _record_ok(rec, vmask, t, nstar)
            abort = not clean
        iters += 1
    abort = abort or iters >= cap
    return ReclaimOut(s, pipe, _records(rec, dev),
                      torch.tensor(abort, device=dev))


# --------------------------------------------------------------------------
# K9: the whole preempt action
# --------------------------------------------------------------------------

def preempt_solve_plain(c, s0, task_req, task_class, task_attempt, job_start,
                        job_ntasks, job_prio, job_avail0, under_request, nu,
                        queues_order, nq, pipe0, *, use_gang, use_drf,
                        use_conformance, order_by_priority,
                        job_key_order=("priority", "gang", "drf"),
                        gang_pipelined=True, blocks=None):
    """preempt.go:45-273: per queue, phase-1 same-queue cross-job
    preemption with a statement (checkpoint / discard) per preemptor job,
    then phase-2 within-job preemption over every under-request job.
    ``blocks`` (mesh, rows a block): the node planes of ``c`` and ``s0``
    are tuples of this process's blocks, and each attempt runs on them
    (K15b's plain version)."""
    dev = c.run_req.device
    T = task_req.shape[0]
    J = c.job_queue.shape[0]
    Q = queues_order.shape[0]
    V = c.run_req.shape[0]
    nu, nq = int(nu), int(nq)
    core = _walk_core(c, s0.queue_alloc.shape[0], False, use_gang=use_gang, use_drf=use_drf,
                      use_prop=False, use_conformance=use_conformance,
                      order_by_priority=order_by_priority, blocks=blocks)
    cap = 4 * T + 4 * J + nq * (nu + 4) + 64
    job_queue = c.job_queue
    rq_raw = job_queue[c.run_job]

    s = _clone_state(s0)
    pipe = pipe0.clone()
    rec = _empty_records(V, T, dev)
    ck = None  # (state, pipe, records) at the current job's pop
    job_avail = job_avail0.clone()
    cursor = torch.zeros(J, dtype=torch.int32, device=dev)
    qpos = phase = cur_job = j2pos = last_v = att_total = iters = 0
    assigned = any_p1 = abort = False

    def pipelined(j):
        if gang_pipelined:
            return int(s.job_occupied[j]) + int(pipe[j]) >= int(c.job_min[j])
        return True

    def finish_job():
        """Discard when the gang never pipelined; keep the job available
        only when it pipelined and placed something this pop."""
        nonlocal s, pipe, rec, phase
        j = cur_job
        pip = pipelined(j)
        if not pip:
            s, pipe, rec = ck[0], ck[1], ck[2]
        job_avail[j] = pip and assigned
        phase = 0

    while not abort and qpos < nq and iters < cap:
        do_att, t, jt, qm = False, 0, 0, True
        if phase == 0:
            q = int(queues_order[min(max(qpos, 0), Q - 1)])
            cand = job_avail & (job_queue == q)
            if bool(cand.any()):
                j = _lex_argmin(cand, _job_order_keys(c, s, job_prio, job_key_order))
                cur_job, assigned = j, False
                job_avail[j] = False
                ck = (_clone_state(s), pipe.clone(),
                      {k: (v.clone() if torch.is_tensor(v) else v) for k, v in rec.items()})
                phase = 1
            else:
                phase, j2pos = 2, 0
        elif phase == 1:
            j = cur_job
            exhausted = int(cursor[j]) >= int(job_ntasks[j])
            t = min(max(int(job_start[j]) + int(cursor[j]), 0), T - 1)
            do_att = not exhausted and bool(task_attempt[t])
            jt = j
            if not exhausted:
                cursor[j] += 1
            else:
                finish_job()
        else:
            done = j2pos >= nu
            j = int(under_request[min(max(j2pos, 0), J - 1)])
            exhausted = int(cursor[j]) >= int(job_ntasks[j])
            t = min(max(int(job_start[j]) + int(cursor[j]), 0), T - 1)
            do_att = not done and not exhausted and bool(task_attempt[t])
            jt, qm = j, False
            if done:
                qpos += 1
                phase = 0
            elif exhausted:
                j2pos += 1
            else:
                cursor[j] += 1
        if do_att and not abort:
            qt = int(job_queue[jt])
            if qm:
                base = s.run_live & (rq_raw == qt) & (c.run_job != jt)
            else:
                base = s.run_live & (c.run_job == jt)
            new_s, assigned_t, nstar, vmask, clean = core(s, task_req[t], int(task_class[t]),
                                                          jt, qt, base)
            ok = assigned_t and clean
            abort = abort or not clean
            if ok:
                s = new_s
                pipe[jt] += 1
                _record_ok(rec, vmask, t, nstar)
                att_total += 1
                if qm:
                    assigned = True
                    last_v = int(vmask.sum())
                    any_p1 = True
            if not qm and clean and not assigned_t:
                j2pos += 1  # phase 2 stops a job's drain at its first failure
            # phase 1 checks JobPipelined after every attempt, ok or not
            if qm and not abort and pipelined(jt):
                finish_job()
        iters += 1
    abort = abort or qpos < nq
    i32 = dict(dtype=torch.int32, device=dev)
    return PreemptOut(s, pipe, _records(rec, dev), torch.tensor(att_total, **i32),
                      torch.tensor(last_v, **i32), torch.tensor(any_p1, device=dev),
                      torch.tensor(abort, device=dev))


# --------------------------------------------------------------------------
# K10: batched preempt rounds
# --------------------------------------------------------------------------

def preempt_rounds_plain(c, s0, task_req, task_class, rows_packed, job_pstart,
                         job_pcount, job_prio, job_avail0, pipe0, **kw) -> RoundsOut:
    """Rounds of parallel victim-capacity placement (the JAX docstring
    has the five steps): candidate analysis over the pool, per-(node,
    queue) capacity curves, top-M jobs proposing P tasks over their K best
    nodes, (node, rank) prefix checks with gang all-or-nothing commit, and
    victims materialised at round end.  The one-block case of
    ``parallel/sharded.rounds_blocks_plain``, as K10 is K15c's."""
    from volcano_tpu_torch.parallel.sharded import rounds_blocks_plain

    return _whole(rounds_blocks_plain(*_as_one_block(c, s0), task_req, task_class, rows_packed,
                                      job_pstart, job_pcount, job_prio, job_avail0, pipe0,
                                      _OneBlock, s0.idle.shape[0], **kw))


# --------------------------------------------------------------------------
# CUDA wrappers
# --------------------------------------------------------------------------

_PTR_FIELDS = (
    "run_req", "run_node", "run_job", "run_prio", "run_rank", "run_evictable",
    "job_queue", "job_min", "node_alloc", "node_max_tasks", "node_valid",
    "class_mask", "class_score", "queue_deserved", "total", "eps",
    "run_live", "releasing", "used", "task_count", "job_alloc", "job_occupied",
    "queue_alloc",
    "task_req", "task_class", "task_attempt", "job_start", "job_ntasks", "job_prio",
    "under_request", "queues_order", "rows_packed", "job_pstart", "job_pcount",
    "job_avail", "queue_live", "pipe", "cursor", "dropped",
    "evict_att", "pipe_node", "pipe_att", "ctl",
    "node_off", "node_fill", "bucket", "l_vidx", "l_ev", "l_drf", "l_prop", "flag",
    "jr_addr", "jr_old",
    "job_off", "job_fill", "job_bucket", "job_key", "item_off", "cnt_in_job", "cap_flat",
    "cons_flat", "cons_node", "placed", "act_q", "ls_q",
    "job_active", "job_keys", "sel", "c_key", "c_job", "c_rank", "c_cnt",
    "p_node", "p_t", "p_job", "p_flags",
    "t_val", "t_idx", "t_any",
    "walk", "send", "recv", "p_rec", "p_key", "part", "x_split",
)
_INT_FIELDS = (
    "V", "N", "R", "T", "J", "Q", "C", "nu", "nq", "M", "P", "K", "F", "jr_cap", "TB", "TILE",
    "use_gang", "use_drf", "use_prop", "use_conformance", "order_by_priority",
    "has_proportion", "gang_pipelined", "n_keys", "key0", "key1", "key2",
    "n0", "NT", "S", "W", "W2", "nC", "cluster",
)


class VictimArgs(ctypes.Structure):
    """Mirror of ``struct VttVictimArgs`` in csrc/victim_common.cuh (field
    order and types must match exactly)."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _PTR_FIELDS]
                + [(n, ctypes.c_int64) for n in _INT_FIELDS]
                + [("w_least", ctypes.c_float), ("w_balanced", ctypes.c_float)])


# ctl words (csrc/victim_common.cuh)
_VC_ATT, _VC_ABORT, _VC_ATT_TOTAL, _VC_LAST_V, _VC_ANY, _VC_ERROR = 0, 1, 2, 3, 4, 6
_VC_ITERS, _VC_ACTIVE, _VC_PROGRESS = 5, 7, 8


def _check_victim_inputs(c: VictimConsts, s: VictimState, task_req, task_class):
    dev = c.run_req.device
    V, R = c.run_req.shape
    N = s.idle.shape[0]
    J = c.job_queue.shape[0]
    Q = s.queue_alloc.shape[0]
    C = c.class_mask.shape[0]
    T = task_req.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    spec = {
        "run_req": (c.run_req, f32, (V, R)), "run_node": (c.run_node, i32, (V,)),
        "run_job": (c.run_job, i32, (V,)), "run_prio": (c.run_prio, i32, (V,)),
        "run_rank": (c.run_rank, i32, (V,)), "run_evictable": (c.run_evictable, b8, (V,)),
        "job_queue": (c.job_queue, i32, (J,)), "job_min": (c.job_min, i32, (J,)),
        "node_alloc": (c.node_alloc, f32, (N, R)),
        "node_max_tasks": (c.node_max_tasks, i32, (N,)),
        "node_valid": (c.node_valid, b8, (N,)), "class_mask": (c.class_mask, b8, (C, N)),
        "class_score": (c.class_score, f32, (C, N)),
        "queue_deserved": (c.queue_deserved, f32, (Q, R)),
        "total": (c.total, f32, (R,)), "eps": (c.eps, f32, (R,)),
        "run_live": (s.run_live, b8, (V,)), "releasing": (s.releasing, f32, (N, R)),
        "used": (s.used, f32, (N, R)), "task_count": (s.task_count, i32, (N,)),
        "job_alloc": (s.job_alloc, f32, (J, R)), "job_occupied": (s.job_occupied, i32, (J,)),
        "queue_alloc": (s.queue_alloc, f32, (Q, R)),
        "task_req": (task_req, f32, (T, R)), "task_class": (task_class, i32, (T,)),
    }
    for name, (t, dt, shape) in spec.items():
        _check(name, t, dt, shape, dev)
    if not 2 <= R <= _MAX_R:
        raise ValueError(f"victim kernels take 2 <= R <= {_MAX_R}, got {R}")
    return dev, V, N, R, T, J, Q, C


def _victim_args(c, s0, task_req, task_class, extra, sizes, flags):
    """Fill the argument block: working copies of the state and records,
    scratch.  Returns (args, state, buffers)."""
    dev, V, N, R, T, J, Q, C = _check_victim_inputs(c, s0, task_req, task_class)
    i32 = dict(dtype=torch.int32, device=dev)
    st = VictimState(*[x.clone() for x in s0])
    bufs = dict(zip(VictimState._fields, st))
    bufs.update(
        run_req=c.run_req, run_node=c.run_node, run_job=c.run_job, run_prio=c.run_prio,
        run_rank=c.run_rank, run_evictable=c.run_evictable, job_queue=c.job_queue,
        job_min=c.job_min, node_alloc=c.node_alloc, node_max_tasks=c.node_max_tasks,
        node_valid=c.node_valid, class_mask=c.class_mask, class_score=c.class_score,
        queue_deserved=c.queue_deserved, total=c.total, eps=c.eps,
        task_req=task_req, task_class=task_class,
        evict_att=torch.full((V,), -1, **i32), pipe_node=torch.full((T,), -1, **i32),
        pipe_att=torch.full((T,), -1, **i32), ctl=torch.zeros(16, **i32),
        node_off=torch.empty(N + 1, **i32), node_fill=torch.empty(N, **i32),
        bucket=torch.empty(V * GROUP_KEY_WORDS, **i32),
        l_vidx=torch.empty(V, **i32), l_ev=torch.empty(V, **i32), l_drf=torch.empty(V, **i32),
        l_prop=torch.empty(V, **i32), flag=torch.zeros(V, dtype=torch.uint8, device=dev),
    )
    bufs.update(extra)
    args = VictimArgs()
    for name in _PTR_FIELDS:
        t = bufs.get(name)
        if t is not None:
            setattr(args, name, t.data_ptr())
    codes = [_KEY_CODE[k] for k in flags.pop("job_key_order")] + [0, 0, 0]
    if len(codes) > 6:
        raise ValueError("job_key_order takes at most three keys")
    vals = dict(V=V, N=N, R=R, T=T, J=J, Q=Q, C=C, n_keys=len(codes) - 3,
                key0=codes[0], key1=codes[1], key2=codes[2])
    vals.update(sizes)
    vals.update({k: int(bool(v)) for k, v in flags.items()})
    for name in _INT_FIELDS:
        setattr(args, name, int(vals.get(name, 0)))
    args.w_least = float(c.w_least)
    args.w_balanced = float(c.w_balanced)
    return args, st, bufs


def _victim_launch(lib, stream, entry, c, s0, task_req, task_class, extra, sizes, flags):
    """Launch ``entry`` of ``lib`` on ``stream`` over a filled argument
    block; returns the state and the buffers."""
    args, st, bufs = _victim_args(c, s0, task_req, task_class, extra, sizes, flags)
    _raise_on(getattr(lib, entry)(ctypes.byref(args), stream), entry)
    return st, bufs


def _storm_records(bufs) -> StormRecords:
    ctl = bufs["ctl"]
    return StormRecords(bufs["evict_att"], bufs["pipe_node"], bufs["pipe_att"], ctl[_VC_ATT])


def _device_of(c: VictimConsts, name: str) -> torch.device:
    dev = c.run_req.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _lib_stream(dev):
    from volcano_tpu_torch import _build

    return _build.load(), _stream(dev)


def victim_groups(c: VictimConsts, live, *, order_by_priority=True,
                  mesh=None) -> VictimGroups:
    """The rows of ``live`` (bool [V]) in the pool of ``c`` grouped by node
    (``VictimGroups``); the object path passes the rows live at its
    snapshot.  With ``mesh``, ``c``'s node planes are this process's blocks
    and the groups span the mesh's rows.

    Replaces volcano_tpu/scheduler/victim_kernels.py:131-182 (``_orders_drf``,
    ``_orders_prop``, ``_orders_evict``), which the JAX package hoists out
    of its storm loops; K7 and K12b take the groups as they are, so a
    solve over the same constants runs no setup of its own.  Bound on the
    card by latency (the bytes take about 1.3 us at config 4).  Design
    (csrc/victim_common.cuh ``vtt_group_kernel``, the one group build of
    the library, which the storm solves' setup launches too): one launch of
    one thread-block cluster, its scratch zeroed inside the launch; count,
    scan over nodes, bucket and rank separated by cluster barriers, each
    row ranked among its node's rows by full comparison.  CPU tensors run
    ``victim_groups_plain``."""
    dev = _device_of(c, "victim_groups")
    tok = None
    if vtprof.PROFILER is not None:  # disarmed, no launch key is built
        tok = vtprof.launch_begin(
            "victim_groups", _launch_key(c, live, order_by_priority=order_by_priority), dev)
    if dev.type == "cpu":
        return victim_groups_plain(c, live, order_by_priority=order_by_priority, mesh=mesh)
    out = victim_groups_launch(*_lib_stream(dev), c, live, order_by_priority,
                               _group_nodes(c, mesh))
    LAUNCHES["victim_groups"] += 1
    vtprof.launch_end(tok)
    return out


#: int32 words of a grouped row's keys in the build's scratch bucket (csrc
#: VttGroupKey)
GROUP_KEY_WORDS = 8
#: the group build's eviction orders (csrc VTT_EV_*): reclaim's pool order,
#: preempt's (priority, -rank, row), the rounds solve's (queue, priority,
#: -rank, row)
EV_KINDS = {"reclaim": 0, "preempt": 1, "rounds": 2}


def victim_groups_launch(lib, stream, c, live, order_by_priority, n_nodes, *,
                         ev_kind="preempt", n0=0, nt=None) -> VictimGroups:
    """Validate, launch the group build (csrc/victim_step.cu
    ``vtt_victim_groups``) and return the groups of the rows of ``live``
    over node rows [n0, n0 + n_nodes) of ``nt`` (default n_nodes; a row on
    another block's node is not grouped, as in the storm solves' setup on a
    block), in the eviction order ``ev_kind`` (``EV_KINDS``)."""
    dev = c.run_req.device
    V = c.run_req.shape[0]
    J, Q = c.job_queue.shape[0], c.queue_deserved.shape[0]
    nt = n_nodes if nt is None else nt
    i32 = dict(dtype=torch.int32, device=dev)
    for name, (t, dt, shape) in {
        "run_node": (c.run_node, torch.int32, (V,)), "run_job": (c.run_job, torch.int32, (V,)),
        "run_prio": (c.run_prio, torch.int32, (V,)), "run_rank": (c.run_rank, torch.int32, (V,)),
        "job_queue": (c.job_queue, torch.int32, (J,)),
        "queue_deserved": (c.queue_deserved, torch.float32, (Q, c.run_req.shape[1])),
    }.items():
        _check(name, t, dt, shape, dev)
    _check("live", live, torch.bool, (V,), dev)
    if n_nodes < 1 or not 0 <= n0 <= nt - n_nodes:
        raise ValueError(f"victim_groups: node rows [{n0}, {n0 + n_nodes}) of {nt}")
    if ev_kind not in EV_KINDS:
        raise ValueError(f"victim_groups: ev_kind must be one of {tuple(EV_KINDS)}")
    key = ("groups", dev, V, n_nodes)
    scratch = _workspace(key, lambda: dict(node_fill=torch.empty(n_nodes, **i32),
                                           bucket=torch.empty(V * GROUP_KEY_WORDS, **i32)))
    g = VictimGroups(torch.empty(n_nodes + 1, **i32), *(torch.empty(V, **i32) for _ in range(4)),
                     bool(order_by_priority), _group_source(c))
    args = VictimArgs()
    for name, t in dict(scratch, run_node=c.run_node, run_job=c.run_job, run_prio=c.run_prio,
                        run_rank=c.run_rank, job_queue=c.job_queue, node_off=g.node_off,
                        l_vidx=g.l_vidx, l_ev=g.l_ev, l_drf=g.l_drf, l_prop=g.l_prop).items():
        setattr(args, name, t.data_ptr())
    args.V, args.N, args.NT, args.n0, args.Q = V, n_nodes, nt, n0, Q
    args.order_by_priority = int(bool(order_by_priority))
    _raise_on(lib.vtt_victim_groups(ctypes.byref(args), live.data_ptr(), EV_KINDS[ev_kind],
                                    stream), "vtt_victim_groups")
    return g


def victim_step(c, s, t_req, t_cls, jt, qt, *, mode="queue", use_gang=True, use_drf=False,
                use_prop=False, use_conformance=False, order_by_priority=True,
                groups=None) -> VictimStepOut:
    """One preemptor's victim solve over all nodes (JAX ``victim_step``);
    ``t_req`` is the preemptor's [R] request on the pool's device, the
    other preemptor arguments are host integers (``qt`` -1: no queue).
    ``groups``: ``victim_groups`` of ``c`` over rows that include every
    row live in ``s`` (built here from the rows live in ``s`` when not
    given: the cold path); groups of other constants raise ValueError, and
    the plain version also raises on groups that miss a live row.

    Replaces volcano_tpu/scheduler/victim_kernels.py:362.  Bound on the
    card by latency: one launch and the slowest node's walk, far above the
    bytes.  Design (csrc/victim_step.cu): one launch over the card, a
    thread a node, the last CTA merging the CTAs' records, applying and
    packing the decision for one fetch; the state copied inside it."""
    if mode not in _STEP_MODES:
        raise ValueError(f"victim_step: mode must be one of {tuple(_STEP_MODES)}, got {mode!r}")
    kw = dict(mode=mode, use_gang=use_gang, use_drf=use_drf, use_prop=use_prop,
              use_conformance=use_conformance, order_by_priority=order_by_priority)
    dev = _device_of(c, "victim_step")
    tok = None
    if vtprof.PROFILER is not None:  # disarmed, no launch key is built
        tok = vtprof.launch_begin("victim_step", _launch_key(c, s, t_req, **kw), dev)
    if dev.type == "cpu":
        return victim_step_plain(c, s, t_req, t_cls, jt, qt, groups=groups, **kw)
    if groups is None:
        groups = victim_groups(c, s.run_live, order_by_priority=order_by_priority)
    out = victim_step_launch(*_lib_stream(dev), c, s, t_req, t_cls, jt, qt, groups=groups, **kw)
    LAUNCHES["victim_step"] += 1
    vtprof.launch_end(tok)
    return out


#: threads of a K7 / K12b core CTA, one node a thread (csrc/victim_step.cu
#: VTT_STEP_THREADS)
STEP_THREADS = 128
#: most local blocks a K12b launch takes (VTT_VB_MAX)
VB_MAX = 64
#: ctl word of the first CTA ticket (VTT_STEP_TICKET)
_STEP_TICKET = 12


class _StepOut(ctypes.Structure):
    """Mirror of ``struct VttStepOut`` (csrc/victim_step.cu)."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "run_live", "job_alloc", "job_occupied", "queue_alloc", "releasing", "used",
        "task_count", "packed")]


class _VbIn(ctypes.Structure):
    """Mirror of ``struct VttVbIn``: each local block's input node rows."""

    _fields_ = [(n, ctypes.c_void_p * VB_MAX) for n in ("releasing", "used", "task_count")]


class _VbConst(ctypes.Structure):
    """Mirror of ``struct VttVbConst``: a local block's constant planes."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "node_alloc", "node_max_tasks", "node_valid", "class_mask", "class_score")] + [
        ("n0", ctypes.c_int64)]


_STATE_REPLICATED = ("run_live", "job_alloc", "job_occupied", "queue_alloc")
_STEP_CONSTS = ("run_req", "run_node", "run_job", "run_prio", "run_rank", "run_evictable",
                "job_queue", "job_min", "queue_deserved", "total", "eps")


class _StepWorkspace:
    """K7's or K12b's scratch and argument block for one device and shape
    (``L`` local blocks of ``nb`` rows; K7 is one block of all rows),
    reused across calls on the port's one stream: the row flags, the
    ok-attempt counter and the CTA tickets (zero between launches), the
    CTA and block records, and the records the apply writes that nothing
    reads.  The constants are checked and their pointers set once per
    constants object, the groups once per groups object; a call sets the
    state's and the request's pointers and the flags."""

    def __init__(self, dev, V, nb, R, J, Q, C, L, S):
        i32 = dict(dtype=torch.int32, device=dev)
        cpb = -(-nb // STEP_THREADS)
        self.bufs = dict(
            flag=torch.zeros(V, dtype=torch.uint8, device=dev),
            ctl=torch.zeros(_STEP_TICKET + VB_MAX, **i32),
            evict_att=torch.full((V,), -1, **i32), pipe=torch.zeros(J, **i32),
            pipe_node=torch.full((1,), -1, **i32), pipe_att=torch.full((1,), -1, **i32),
            send=torch.empty(L * cpb * VB_WORDS, **i32))
        self.block_send = torch.empty((L, VB_WORDS), **i32)
        self.args = VictimArgs()
        for name, t in self.bufs.items():
            setattr(self.args, name, t.data_ptr())
        for name, v in dict(V=V, N=nb, NT=nb * S, R=R, T=1, J=J, Q=Q, C=C, S=S).items():
            setattr(self.args, name, v)
        self.out, self.vb_in = _StepOut(), _VbIn()
        self.consts = self.groups = self.dblk = None
        self.trusted = ()

    def bind_consts(self, c, blocks=None):
        """The constants' pointers (``blocks``: the local blocks' constant
        planes, placed in device memory)."""
        for name in _STEP_CONSTS:
            setattr(self.args, name, getattr(c, name).data_ptr())
        if blocks is None:
            for name in CONST_NODE_PLANES:
                setattr(self.args, name, getattr(c, name).data_ptr())
        else:
            raw = bytearray(bytes(blocks))
            self.dblk = torch.frombuffer(raw, dtype=torch.uint8).clone().to(c.run_req.device)
        self.args.w_least, self.args.w_balanced = float(c.w_least), float(c.w_balanced)
        self.consts, self.groups = c, None

    def bind_call(self, s, t_req, groups, flags):
        """The state's replicated fields, the request, the groups, the
        flags; returns the fresh replicated outputs."""
        a = self.args
        if groups is not self.groups:
            for name in ("node_off", "l_vidx", "l_ev", "l_drf", "l_prop"):
                setattr(a, name, getattr(groups, name).data_ptr())
            self.groups = groups
        for name in _STATE_REPLICATED:
            setattr(a, name, getattr(s, name).data_ptr())
        a.task_req = t_req.data_ptr()
        for name, v in flags.items():
            setattr(a, name, int(bool(v)))
        outs = {name: torch.empty_like(getattr(s, name)) for name in _STATE_REPLICATED}
        for name, t in outs.items():
            setattr(self.out, name, t.data_ptr())
        return outs


#: workspaces by (kind, device, shape): a solve's ``_StepWorkspace``, the
#: group build's scratch (the build zeroes what it counts in); a few shapes
#: live at a time
_WORKSPACES: Dict[tuple, object] = {}
#: the kernel a workspace kind serves, under which vtprof's launch-shape
#: registry counts the workspaces made
_WORKSPACE_KERNEL = {"groups": "victim_groups", "step": "victim_step",
                     "blocks": "victim_step_sharded"}


def _workspace(key, make):
    ws = _WORKSPACES.get(key)
    if ws is None:
        if len(_WORKSPACES) >= 8:
            _WORKSPACES.clear()
        ws = _WORKSPACES[key] = make()
        vtprof.note_compile(_WORKSPACE_KERNEL[key[0]])
    return ws


def _launch_in(key, entry, err) -> None:
    """Raise on a failed launch, dropping the workspace (its tickets may
    be left set)."""
    if err:
        _WORKSPACES.pop(key, None)
    _raise_on(err, entry)


def _check_step_consts(c, Q, name):
    """The replicated constants of a K7 / K12b solve."""
    dev = c.run_req.device
    V, R = c.run_req.shape
    J = c.job_queue.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    for field, (dt, shape) in {
        "run_req": (f32, (V, R)), "run_node": (i32, (V,)), "run_job": (i32, (V,)),
        "run_prio": (i32, (V,)), "run_rank": (i32, (V,)), "run_evictable": (b8, (V,)),
        "job_queue": (i32, (J,)), "job_min": (i32, (J,)), "queue_deserved": (f32, (Q, R)),
        "total": (f32, (R,)), "eps": (f32, (R,)),
    }.items():
        _check(field, getattr(c, field), dt, shape, dev)
    if not 2 <= R <= _MAX_R:
        raise ValueError(f"{name}: victim kernels take 2 <= R <= {_MAX_R}, got {R}")


def _check_step_state(s, V, R, J, Q, dev):
    for field, (dt, shape) in {
        "run_live": (torch.bool, (V,)), "job_alloc": (torch.float32, (J, R)),
        "job_occupied": (torch.int32, (J,)), "queue_alloc": (torch.float32, (Q, R)),
    }.items():
        _check(field, getattr(s, field), dt, shape, dev)


def _check_preemptor(name, t_req, t_cls, jt, qt, R, J, C, dev):
    _check("t_req", t_req, torch.float32, (R,), dev)
    if not (0 <= jt < J and 0 <= t_cls < C and qt >= -1):
        raise ValueError(f"{name}: jt {jt}, t_cls {t_cls}, qt {qt} outside J={J}, C={C}")


def victim_step_launch(lib, stream, c, s, t_req, t_cls, jt, qt, *, mode, use_gang, use_drf,
                       use_prop, use_conformance, order_by_priority,
                       groups) -> VictimStepOut:
    """Validate, launch csrc/victim_step.cu's K7 on this shape's workspace
    and return its outputs (fresh tensors; ``idle`` is the input's, which
    no solve writes)."""
    dev = c.run_req.device
    V, R = c.run_req.shape
    N = c.node_alloc.shape[0]
    J, Q, C = c.job_queue.shape[0], s.queue_alloc.shape[0], c.class_mask.shape[0]
    key = ("step", dev, V, N, R, J, Q, C)
    ws = _workspace(key, lambda: _StepWorkspace(dev, V, N, R, J, Q, C, 1, 1))
    if ws.consts is not c:
        _check_step_consts(c, Q, "victim_step")
        for field, (dt, shape) in {
            "node_alloc": (torch.float32, (N, R)), "node_max_tasks": (torch.int32, (N,)),
            "node_valid": (torch.bool, (N,)), "class_mask": (torch.bool, (C, N)),
            "class_score": (torch.float32, (C, N)),
        }.items():
            _check(field, getattr(c, field), dt, shape, dev)
        ws.bind_consts(c)
    if groups is not ws.groups or groups.order_by_priority != bool(order_by_priority):
        _check_groups("victim_step", groups, c, N, order_by_priority)
    if not any(s is t for t in ws.trusted):
        _check_step_state(s, V, R, J, Q, dev)
        for field, (dt, shape) in {"releasing": (torch.float32, (N, R)),
                                   "used": (torch.float32, (N, R)),
                                   "task_count": (torch.int32, (N,))}.items():
            _check(field, getattr(s, field), dt, shape, dev)
    _check_preemptor("victim_step", t_req, t_cls, jt, qt, R, J, C, dev)
    outs = ws.bind_call(s, t_req, groups, dict(
        use_gang=use_gang, use_drf=use_drf, use_prop=use_prop, use_conformance=use_conformance,
        order_by_priority=order_by_priority))
    a, o = ws.args, ws.out
    for name in ("releasing", "used", "task_count"):
        t = getattr(s, name)
        setattr(a, name, t.data_ptr())
        outs[name] = torch.empty_like(t)
        setattr(o, name, outs[name].data_ptr())
    packed = torch.empty(4 + (V + 31) // 32, dtype=torch.int32, device=dev)
    o.packed = packed.data_ptr()
    _launch_in(key, "vtt_victim_step", lib.vtt_victim_step(
        ctypes.byref(a), ctypes.byref(o), int(t_cls), int(jt), int(qt), _STEP_MODES[mode],
        stream))
    water_fill_check()  # the shares' round word, copied before this launch
    state = VictimState(idle=s.idle, **outs)
    ws.trusted = (s, state)
    return VictimStepOut(state, packed)


# --------------------------------------------------------------------------
# K12b: the victim solve on node blocks
# --------------------------------------------------------------------------

#: the node planes of VictimConsts / VictimState, held in blocks of rows
#: under a mesh (``parallel/sharded._VICTIM_SPECS`` maps them to their axes)
CONST_NODE_PLANES = ("node_alloc", "node_max_tasks", "node_valid", "class_mask", "class_score")
STATE_NODE_PLANES = ("idle", "releasing", "used", "task_count")
#: int32 words of one block's record (csrc/victim_common.cuh VTT_VB_WORDS)
VB_WORDS = 6


class _OneBlock:
    """The mesh of one block on this process: K10 is K15c's one-block case."""

    size = n_local = 1
    first = 0

    @staticmethod
    def exchange(send: torch.Tensor) -> torch.Tensor:
        return send


def _as_one_block(c: VictimConsts, s: VictimState):
    """(c, s) with every node plane a 1-tuple: the one block of ``_OneBlock``."""
    return (c._replace(**{k: (getattr(c, k),) for k in CONST_NODE_PLANES}),
            s._replace(**{k: (getattr(s, k),) for k in STATE_NODE_PLANES}))


def _whole(out):
    """A solve's outputs with the one block's node planes unwrapped."""
    return out._replace(state=out.state._replace(
        **{k: getattr(out.state, k)[0] for k in STATE_NODE_PLANES}))


def victim_step_sharded(c, s, t_req, t_cls, jt, qt, mesh, *, mode="queue", use_gang=True,
                        use_drf=False, use_prop=False, use_conformance=False,
                        order_by_priority=True, groups=None) -> VictimStepOut:
    """``victim_step`` with the node planes of ``c`` and ``s`` in blocks of
    rows: each of ``CONST_NODE_PLANES`` / ``STATE_NODE_PLANES`` is a tuple of
    this process's blocks of ``mesh`` (``parallel/sharded.py``), the other
    fields whole.  Returns the new state (its node planes again tuples of
    this process's blocks) and the packed decision, equal bit for bit to
    the one-block solve's.  ``groups``: ``victim_groups(c, live, mesh=mesh)``
    over rows that include every row live in ``s`` (built here from the
    rows live in ``s`` when not given), as for ``victim_step``.

    Replaces volcano_tpu/parallel/sharded.py:202 make_sharded_victim_step.
    CPU tensors run ``parallel/sharded.victim_blocks_plain``; CUDA tensors
    launch csrc/victim_step.cu's block entries (every local block's cores
    in one launch, the mesh's record exchange, the replicated merge and
    apply in a second) or raise."""
    if mode not in _STEP_MODES:
        raise ValueError(f"victim_step: mode must be one of {tuple(_STEP_MODES)}, got {mode!r}")
    kw = dict(mode=mode, use_gang=use_gang, use_drf=use_drf, use_prop=use_prop,
              use_conformance=use_conformance, order_by_priority=order_by_priority)
    dev = _device_of(c, "victim_step_sharded")
    nb = _check_blocks(c, s, mesh)
    tok = None
    if vtprof.PROFILER is not None:  # disarmed, no launch key is built
        tok = vtprof.launch_begin("victim_step_sharded", _launch_key(c, s, t_req, **kw), dev)
    if dev.type == "cpu":
        from volcano_tpu_torch.parallel.sharded import victim_blocks_plain

        return victim_blocks_plain(c, s, t_req, t_cls, jt, qt, mesh, nb, groups=groups, **kw)
    if groups is None:
        groups = victim_groups(c, s.run_live, order_by_priority=order_by_priority, mesh=mesh)
    out = victim_sharded_launch(*_lib_stream(dev), c, s, t_req, t_cls, jt, qt, mesh, nb,
                                groups=groups, **kw)
    LAUNCHES["victim_step_sharded"] += 1
    vtprof.launch_end(tok)
    return out


def _check_blocks(c, s, mesh, fn="victim_step_sharded") -> int:
    """Every node plane a tuple of this process's blocks, all of one row
    count; returns it."""
    rows = set()
    for tup, names in ((c, CONST_NODE_PLANES), (s, STATE_NODE_PLANES)):
        for name in names:
            blocks = getattr(tup, name)
            if not isinstance(blocks, (tuple, list)) or len(blocks) != mesh.n_local:
                raise ValueError(f"{fn}: {name} must hold this process's "
                                 f"{mesh.n_local} blocks")
            axis = 1 if name in ("class_mask", "class_score") else 0
            rows.update(int(b.shape[axis]) for b in blocks)
    if len(rows) != 1:
        raise ValueError(f"{fn}: the blocks' row counts differ: {sorted(rows)}")
    return rows.pop()


def _blocks_args(c, s0, task_req, task_class, mesh, nb, extra, sizes, flags, block_extra,
                 block_groups=True):
    """The argument blocks of a solve on node blocks: the base (this
    process's replicated inputs and working state, ``extra``) and each local
    block's (its node planes, working copies of its node state, its setup
    scratch and ``block_extra(i)``).  Without ``block_groups`` the pool is
    grouped once over the mesh's rows, in the base's node_off and lists,
    and each block reads its slice of them.  Returns (base, blocks, state,
    bufs, block buffers); ``state`` is the working state, node planes as
    tuples."""
    dev = c.run_req.device
    V, R = c.run_req.shape
    J, Q, T = c.job_queue.shape[0], s0.queue_alloc.shape[0], task_req.shape[0]
    C = c.class_mask[0].shape[0]
    L, S = mesh.n_local, mesh.size
    N = nb * S
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    spec = {
        "run_req": (c.run_req, f32, (V, R)), "run_node": (c.run_node, i32, (V,)),
        "run_job": (c.run_job, i32, (V,)), "run_prio": (c.run_prio, i32, (V,)),
        "run_rank": (c.run_rank, i32, (V,)), "run_evictable": (c.run_evictable, b8, (V,)),
        "job_queue": (c.job_queue, i32, (J,)), "job_min": (c.job_min, i32, (J,)),
        "queue_deserved": (c.queue_deserved, f32, (Q, R)),
        "total": (c.total, f32, (R,)), "eps": (c.eps, f32, (R,)),
        "run_live": (s0.run_live, b8, (V,)), "job_alloc": (s0.job_alloc, f32, (J, R)),
        "job_occupied": (s0.job_occupied, i32, (J,)),
        "queue_alloc": (s0.queue_alloc, f32, (Q, R)),
        "task_req": (task_req, f32, (T, R)), "task_class": (task_class, i32, (T,)),
    }
    for name, (t, dt, shape) in spec.items():
        _check(name, t, dt, shape, dev)
    bspec = {"node_alloc": (f32, (nb, R)), "node_max_tasks": (i32, (nb,)),
             "node_valid": (b8, (nb,)), "class_mask": (b8, (C, nb)),
             "class_score": (f32, (C, nb)), "idle": (f32, (nb, R)),
             "releasing": (f32, (nb, R)), "used": (f32, (nb, R)), "task_count": (i32, (nb,))}
    for name, (dt, shape) in bspec.items():
        for i, b in enumerate(getattr(c if name in CONST_NODE_PLANES else s0, name)):
            _check(f"block {i} {name}", b, dt, shape, dev)
    if not 2 <= R <= _MAX_R:
        raise ValueError(f"victim kernels take 2 <= R <= {_MAX_R}, got {R}")

    def empty(n, dt=i32):
        return torch.empty(n, dtype=dt, device=dev)

    rep = dict(run_live=s0.run_live.clone(), job_alloc=s0.job_alloc.clone(),
               job_occupied=s0.job_occupied.clone(), queue_alloc=s0.queue_alloc.clone())
    bufs = dict(
        run_req=c.run_req, run_node=c.run_node, run_job=c.run_job, run_prio=c.run_prio,
        run_rank=c.run_rank, run_evictable=c.run_evictable, job_queue=c.job_queue,
        job_min=c.job_min, queue_deserved=c.queue_deserved, total=c.total, eps=c.eps,
        task_req=task_req, task_class=task_class,
        evict_att=torch.full((V,), -1, dtype=i32, device=dev),
        pipe_node=torch.full((T,), -1, dtype=i32, device=dev),
        pipe_att=torch.full((T,), -1, dtype=i32, device=dev),
        ctl=torch.zeros(16, dtype=i32, device=dev), bucket=empty(V * GROUP_KEY_WORDS),
        l_vidx=empty(V), l_ev=empty(V), l_drf=empty(V), l_prop=empty(V),
        flag=torch.zeros(V, dtype=torch.uint8, device=dev), **rep)
    if not block_groups:
        bufs.update(node_off=empty(N + 1), node_fill=empty(N))
    bufs.update(extra)
    base = VictimArgs()
    for name, t in bufs.items():
        setattr(base, name, t.data_ptr())
    codes = [_KEY_CODE[k] for k in flags.pop("job_key_order")] + [0, 0, 0]
    if len(codes) > 6:
        raise ValueError("job_key_order takes at most three keys")
    vals = dict(V=V, N=N, R=R, T=T, J=J, Q=Q, C=C, NT=N, n0=0, S=S, n_keys=len(codes) - 3,
                key0=codes[0], key1=codes[1], key2=codes[2])
    vals.update(sizes)
    vals.update({k: int(bool(v)) for k, v in flags.items()})
    for name in _INT_FIELDS:
        setattr(base, name, int(vals.get(name, 0)))
    base.w_least, base.w_balanced = float(c.w_least), float(c.w_balanced)
    blocks, keep = (VictimArgs * L)(), []
    rows = {k: [] for k in ("releasing", "used", "task_count")}
    for i in range(L):
        blk = VictimArgs.from_buffer_copy(base)
        planes = {k: getattr(c, k)[i] for k in CONST_NODE_PLANES}
        for k in rows:
            rows[k].append(getattr(s0, k)[i].clone())
            planes[k] = rows[k][-1]
        if block_groups:
            planes.update(node_off=empty(nb + 1), node_fill=empty(nb),
                          bucket=empty(V * GROUP_KEY_WORDS),
                          l_vidx=empty(V), l_ev=empty(V), l_drf=empty(V), l_prop=empty(V))
        planes.update(block_extra(i))
        for k, t in planes.items():
            setattr(blk, k, t.data_ptr())
        blk.N, blk.n0 = nb, (mesh.first + i) * nb
        if not block_groups:
            blk.node_off = bufs["node_off"][blk.n0:].data_ptr()
        blocks[i] = blk
        keep.append(planes)
    state = VictimState(idle=s0.idle, **{k: tuple(v) for k, v in rows.items()}, **rep)
    return base, blocks, state, bufs, keep


def _exchanged(mesh, send: torch.Tensor) -> torch.Tensor:
    """Every block's rows of ``send`` in block order, over the mesh."""
    recv = mesh.exchange(send)
    want = (mesh.size,) + tuple(send.shape[1:])
    if tuple(recv.shape) != want or recv.dtype != send.dtype:
        raise ValueError(f"exchange returned {tuple(recv.shape)} {recv.dtype}, expected "
                         f"{want} {send.dtype}")
    return recv


def victim_sharded_launch(lib, stream, c, s, t_req, t_cls, jt, qt, mesh, nb, *, mode, use_gang,
                          use_drf, use_prop, use_conformance, order_by_priority, groups):
    """Validate, launch csrc/victim_step.cu's block entries around the
    mesh's exchange on this shape's workspace and return ``VictimStepOut``
    (the node planes of the new state views of one buffer a plane)."""
    dev = c.run_req.device
    V, R = c.run_req.shape
    J, Q = c.job_queue.shape[0], s.queue_alloc.shape[0]
    C = c.class_mask[0].shape[0]
    L, S = mesh.n_local, mesh.size
    if L > VB_MAX:
        raise ValueError(f"victim_step_sharded: at most {VB_MAX} local blocks, got {L}")
    key = ("blocks", dev, V, nb, R, J, Q, C, L, S, mesh.first)
    ws = _workspace(key, lambda: _StepWorkspace(dev, V, nb, R, J, Q, C, L, S))
    if ws.consts is not c:
        _check_step_consts(c, Q, "victim_step_sharded")
        blocks = (_VbConst * L)()
        for i in range(L):
            for name, (dt, shape) in {
                "node_alloc": (torch.float32, (nb, R)), "node_max_tasks": (torch.int32, (nb,)),
                "node_valid": (torch.bool, (nb,)), "class_mask": (torch.bool, (C, nb)),
                "class_score": (torch.float32, (C, nb)),
            }.items():
                t = getattr(c, name)[i]
                _check(f"block {i} {name}", t, dt, shape, dev)
                setattr(blocks[i], name, t.data_ptr())
            blocks[i].n0 = (mesh.first + i) * nb
        ws.bind_consts(c, blocks)
    if groups is not ws.groups or groups.order_by_priority != bool(order_by_priority):
        _check_groups("victim_step_sharded", groups, c, nb * S, order_by_priority)
    if not any(s is t for t in ws.trusted):
        _check_step_state(s, V, R, J, Q, dev)
        for name, (dt, shape) in {"releasing": (torch.float32, (nb, R)),
                                  "used": (torch.float32, (nb, R)),
                                  "task_count": (torch.int32, (nb,))}.items():
            for i, b in enumerate(getattr(s, name)):
                _check(f"block {i} {name}", b, dt, shape, dev)
    _check_preemptor("victim_step_sharded", t_req, t_cls, jt, qt, R, J, C, dev)
    outs = ws.bind_call(s, t_req, groups, dict(
        use_gang=use_gang, use_drf=use_drf, use_prop=use_prop, use_conformance=use_conformance,
        order_by_priority=order_by_priority))
    a, o, vb_in = ws.args, ws.out, ws.vb_in
    for name in ("releasing", "used", "task_count"):
        ptrs = getattr(vb_in, name)
        for i, b in enumerate(getattr(s, name)):
            ptrs[i] = b.data_ptr()
        b0 = getattr(s, name)[0]
        whole = torch.empty((L * nb,) + tuple(b0.shape[1:]), dtype=b0.dtype, device=dev)
        setattr(o, name, whole.data_ptr())
        outs[name] = whole.split(nb)
    packed = torch.empty(4 + (V + 31) // 32, dtype=torch.int32, device=dev)
    o.packed = packed.data_ptr()
    mode_i = _STEP_MODES[mode]
    _launch_in(key, "vtt_victim_blocks_core", lib.vtt_victim_blocks_core(
        ctypes.byref(a), ws.dblk.data_ptr(), ctypes.byref(vb_in), ctypes.byref(o), L,
        int(t_cls), int(jt), int(qt), mode_i, ws.block_send.data_ptr(), stream))
    recv = _exchanged(mesh, ws.block_send)
    _launch_in(key, "vtt_victim_blocks_apply", lib.vtt_victim_blocks_apply(
        ctypes.byref(a), ctypes.byref(o), recv.data_ptr(), S, mesh.first * nb, L * nb,
        int(t_cls), int(jt), int(qt), mode_i, stream))
    water_fill_check()  # the shares' round word, copied before these launches
    state = VictimState(idle=s.idle, **outs)
    ws.trusted = (s, state)
    return VictimStepOut(state, packed)


#: the timed walk's stages, in the order of its split buffer (indices 2-7):
#: the advance with its job selects, the selects alone, the node scan, the
#: reduce and record exchange, the cluster barriers, the apply with the
#: walk's bookkeeping; index 8 counts attempts, 9 job selects, 12 holds the
#: cluster size the walk ran on
WALK_STAGES = ("advance", "select", "scan", "reduce_exchange", "barrier", "apply")


#: cluster sizes the reclaim and preempt walks run on (CTAs of one
#: thread-block cluster; 16 is the H100's non-portable size)
WALK_CLUSTERS = (1, 2, 4, 8, 16)


def _cluster_sizes(cluster) -> dict:
    """The argument block's cluster size (0: the largest the card admits)."""
    if cluster is not None and cluster not in WALK_CLUSTERS:
        raise ValueError(f"cluster {cluster}: the walks take one of {WALK_CLUSTERS}")
    return dict(cluster=cluster or 0)


def _split_extra(split, dev) -> dict:
    """The argument block's split buffer, validated, or nothing."""
    if split is None:
        return {}
    _check("split", split, torch.int64, (32,), dev)
    return dict(x_split=split)


def reclaim_solve(c, s0, task_req, task_class, job_first, job_prio, job_cand0,
                  queue_live0, pipe0, *, use_gang, use_prop, use_conformance,
                  order_by_priority, has_proportion,
                  job_key_order=("priority", "gang", "drf")) -> ReclaimOut:
    """The whole reclaim action (JAX ``victim_kernels.reclaim_solve``).

    Replaces volcano_tpu/scheduler/victim_kernels.py:457.  Bound on the
    card by latency: a chain of dependent attempts, each a walk of the pool
    and the nodes.  Design (csrc/reclaim_solve.cu): the pool grouped by
    node once per launch, then one launch of one thread-block cluster runs
    the loop, one node a thread, two cluster barriers an attempt."""
    kw = dict(use_gang=use_gang, use_prop=use_prop, use_conformance=use_conformance,
              order_by_priority=order_by_priority, has_proportion=has_proportion,
              job_key_order=tuple(job_key_order))
    dev = _device_of(c, "reclaim_solve")
    tok = None
    if vtprof.PROFILER is not None:  # disarmed, no launch key is built
        tok = vtprof.launch_begin("reclaim_solve", _launch_key(c, s0, task_req, **kw), dev)
    if dev.type == "cpu":
        return reclaim_solve_plain(c, s0, task_req, task_class, job_first, job_prio,
                                   job_cand0, queue_live0, pipe0, **kw)
    out = reclaim_launch(*_lib_stream(dev), c, s0, task_req, task_class, job_first,
                         job_prio, job_cand0, queue_live0, pipe0, **kw)
    LAUNCHES["reclaim_solve"] += 1
    vtprof.launch_end(tok)
    return out


def reclaim_launch(lib, stream, c, s0, task_req, task_class, job_first, job_prio,
                   job_cand0, queue_live0, pipe0, *, use_gang, use_prop, use_conformance,
                   order_by_priority, has_proportion,
                   job_key_order=("priority", "gang", "drf"), cluster=None,
                   split=None) -> ReclaimOut:
    """Validate, launch csrc/reclaim_solve.cu and return its outputs.
    The walk runs as one cluster of ``cluster`` CTAs (one of
    ``WALK_CLUSTERS``; None: the largest the card admits), and raises if
    the card refuses that size.  ``split``, an int64 [32] tensor, runs the
    timed instantiation, which writes its stage split there
    (``WALK_STAGES``)."""
    dev = c.run_req.device
    J, Q = c.job_queue.shape[0], s0.queue_alloc.shape[0]
    for name, t, dt, shape in (
        ("job_first", job_first, torch.int32, (J,)), ("job_prio", job_prio, torch.int32, (J,)),
        ("job_cand0", job_cand0, torch.bool, (J,)), ("queue_live0", queue_live0, torch.bool, (Q,)),
        ("pipe0", pipe0, torch.int32, (J,)),
    ):
        _check(name, t, dt, shape, dev)
    extra = dict(job_start=job_first, job_prio=job_prio, job_avail=job_cand0.clone(),
                 queue_live=queue_live0.clone(), pipe=pipe0.clone(), **_split_extra(split, dev))
    flags = dict(use_gang=use_gang, use_drf=False, use_prop=use_prop,
                 use_conformance=use_conformance, order_by_priority=order_by_priority,
                 has_proportion=has_proportion, job_key_order=job_key_order)
    st, bufs = _victim_launch(lib, stream, "vtt_reclaim_solve", c, s0, task_req, task_class,
                              extra, _cluster_sizes(cluster), flags)
    return ReclaimOut(st, bufs["pipe"], _storm_records(bufs), bufs["ctl"][_VC_ABORT] != 0)


def preempt_solve(c, s0, task_req, task_class, task_attempt, job_start, job_ntasks,
                  job_prio, job_avail0, under_request, nu, queues_order, nq, pipe0, *,
                  use_gang, use_drf, use_conformance, order_by_priority,
                  job_key_order=("priority", "gang", "drf"),
                  gang_pipelined=True) -> PreemptOut:
    """The whole preempt action (JAX ``victim_kernels.preempt_solve``).
    On the card, ``nu`` and ``nq`` are host integers.

    Replaces volcano_tpu/scheduler/victim_kernels.py:607.  Bound by
    latency, as K8.  Design (csrc/preempt_solve.cu): K8's cluster walk;
    its rank 0 runs the two-phase state machine, and a statement's discard
    replays an undo journal of the words its attempts wrote."""
    kw = dict(use_gang=use_gang, use_drf=use_drf, use_conformance=use_conformance,
              order_by_priority=order_by_priority, job_key_order=tuple(job_key_order),
              gang_pipelined=gang_pipelined)
    dev = _device_of(c, "preempt_solve")
    args = (c, s0, task_req, task_class, task_attempt, job_start, job_ntasks, job_prio,
            job_avail0, under_request, nu, queues_order, nq, pipe0)
    tok = None
    if vtprof.PROFILER is not None:  # disarmed, no launch key is built
        tok = vtprof.launch_begin("preempt_solve", _launch_key(c, s0, task_req, **kw), dev)
    if dev.type == "cpu":
        return preempt_solve_plain(*args, **kw)
    out = preempt_launch(*_lib_stream(dev), *args, **kw)
    LAUNCHES["preempt_solve"] += 1
    vtprof.launch_end(tok)
    return out


def preempt_launch(lib, stream, c, s0, task_req, task_class, task_attempt, job_start,
                   job_ntasks, job_prio, job_avail0, under_request, nu, queues_order, nq,
                   pipe0, *, use_gang, use_drf, use_conformance, order_by_priority,
                   job_key_order=("priority", "gang", "drf"),
                   gang_pipelined=True, cluster=None, split=None) -> PreemptOut:
    """Validate, launch csrc/preempt_solve.cu and return its outputs;
    ``cluster`` and ``split`` as ``reclaim_launch`` takes them."""
    dev = c.run_req.device
    T = task_req.shape[0]
    J, Q = c.job_queue.shape[0], queues_order.shape[0]
    V, R = c.run_req.shape
    for name, t, dt, shape in (
        ("task_attempt", task_attempt, torch.bool, (T,)),
        ("job_start", job_start, torch.int32, (J,)), ("job_ntasks", job_ntasks, torch.int32, (J,)),
        ("job_prio", job_prio, torch.int32, (J,)), ("job_avail0", job_avail0, torch.bool, (J,)),
        ("under_request", under_request, torch.int32, (J,)),
        ("queues_order", queues_order, torch.int32, (Q,)), ("pipe0", pipe0, torch.int32, (J,)),
    ):
        _check(name, t, dt, shape, dev)
    # undo journal: per statement at most the job's tasks' node, job, queue
    # and record words plus four words and two resource rows per victim
    jr_cap = T * (4 * R + 6) + V * (2 * R + 4) + 64
    extra = dict(
        task_attempt=task_attempt, job_start=job_start, job_ntasks=job_ntasks,
        job_prio=job_prio, under_request=under_request, queues_order=queues_order,
        job_avail=job_avail0.clone(), pipe=pipe0.clone(),
        cursor=torch.zeros(J, dtype=torch.int32, device=dev),
        jr_addr=torch.empty(jr_cap, dtype=torch.int64, device=dev),
        jr_old=torch.empty(jr_cap, dtype=torch.int32, device=dev), **_split_extra(split, dev),
    )
    flags = dict(use_gang=use_gang, use_drf=use_drf, use_prop=False,
                 use_conformance=use_conformance, order_by_priority=order_by_priority,
                 gang_pipelined=gang_pipelined, job_key_order=job_key_order)
    st, bufs = _victim_launch(lib, stream, "vtt_preempt_solve", c, s0, task_req, task_class,
                              extra, dict(nu=int(nu), nq=int(nq), jr_cap=jr_cap,
                                          **_cluster_sizes(cluster)), flags)
    ctl = bufs["ctl"]
    if int(ctl[_VC_ERROR]):
        raise RuntimeError("preempt_solve: undo journal overflow")
    return PreemptOut(st, bufs["pipe"], _storm_records(bufs), ctl[_VC_ATT_TOTAL],
                      ctl[_VC_LAST_V], ctl[_VC_ANY] != 0, ctl[_VC_ABORT] != 0)


def preempt_rounds(c, s0, task_req, task_class, rows_packed, job_pstart, job_pcount,
                   job_prio, job_avail0, pipe0, *, use_gang, use_drf, use_conformance,
                   order_by_priority, job_key_order=("priority", "gang", "drf"),
                   gang_pipelined=True, m_chunk=128, p_chunk=ROUNDS_P_CHUNK,
                   k_chunk=8) -> RoundsOut:
    """Batched preempt rounds (JAX ``victim_kernels.preempt_rounds``).

    Replaces volcano_tpu/scheduler/victim_kernels.py:830.  Bound by its
    launches, barriers and the host's read of one 48-byte control block
    between rounds, a round's work being far below the card's rates.
    Design (csrc/preempt_rounds.cu): once a solve, the pool bucketed by job
    and each live row's within-job count spread over the card; a round's
    kernels, the job select a top-M by chunks."""
    kw = dict(use_gang=use_gang, use_drf=use_drf, use_conformance=use_conformance,
              order_by_priority=order_by_priority, job_key_order=tuple(job_key_order),
              gang_pipelined=gang_pipelined)
    dev = _device_of(c, "preempt_rounds")
    args = (c, s0, task_req, task_class, rows_packed, job_pstart, job_pcount, job_prio,
            job_avail0, pipe0)
    kw.update(m_chunk=m_chunk, p_chunk=p_chunk, k_chunk=k_chunk)
    tok = None
    if vtprof.PROFILER is not None:  # disarmed, no launch key is built
        tok = vtprof.launch_begin("preempt_rounds", _launch_key(c, s0, task_req, **kw), dev)
    if dev.type == "cpu":
        return preempt_rounds_plain(*args, **kw)
    out = rounds_launch(*_lib_stream(dev), *args, **kw)
    LAUNCHES["preempt_rounds"] += 1
    vtprof.launch_end(tok)
    return out


def rounds_launch(lib, stream, c, s0, task_req, task_class, rows_packed, job_pstart,
                  job_pcount, job_prio, job_avail0, pipe0, **kw) -> RoundsOut:
    """Validate, run csrc/preempt_rounds.cu as one block and return its
    outputs."""
    _check_victim_inputs(c, s0, task_req, task_class)
    return _whole(rounds_blocks_launch(lib, stream, *_as_one_block(c, s0), task_req, task_class,
                                       rows_packed, job_pstart, job_pcount, job_prio, job_avail0,
                                       pipe0, _OneBlock, s0.idle.shape[0], **kw))


# --------------------------------------------------------------------------
# K15a-c: the contention solves on node blocks
# --------------------------------------------------------------------------

#: bytes of a walk's state on the card (csrc/victim_common.cuh VttWalk)
WALK_BYTES = 512


def _walk_launch(lib, stream, kind, c, s0, task_req, task_class, mesh, nb, extra, sizes,
                 flags):
    """K15a / K15b on the card: begin (the pool grouped over the mesh's
    rows, the walk to its first attempt), then per pending attempt every
    local block's core, the exchange of their records and the step.
    Returns the state (node planes as tuples) and the buffers."""
    dev = c.run_req.device
    L = mesh.n_local
    i32 = dict(dtype=torch.int32, device=dev)
    send = torch.empty((L, VB_WORDS), **i32)
    cta_rec = torch.empty((L * -(-nb // STEP_THREADS), VB_WORDS), **i32)
    tickets = torch.zeros(L, **i32)
    extra = dict(extra, walk=torch.zeros(WALK_BYTES, dtype=torch.uint8, device=dev))
    base, blocks, state, bufs, keep = _blocks_args(c, s0, task_req, task_class, mesh, nb, extra,
                                                   sizes, flags, lambda i: {"send": send[i]},
                                                   block_groups=False)
    raw = bytearray(bytes(blocks))
    dblk = torch.frombuffer(raw, dtype=torch.uint8).clone().to(dev)
    pending = ctypes.c_int(0)
    begin = f"vtt_{kind}_blocks_begin"
    step = f"vtt_{kind}_blocks_step"
    _raise_on(getattr(lib, begin)(ctypes.byref(base), dblk.data_ptr(), L, ctypes.byref(pending),
                                  stream), begin)
    while pending.value:
        _raise_on(lib.vtt_walk_blocks_core(dblk.data_ptr(), L, nb, cta_rec.data_ptr(),
                                           tickets.data_ptr(), stream), "vtt_walk_blocks_core")
        recv = _exchanged(mesh, send)
        base.recv = recv.data_ptr()
        _raise_on(getattr(lib, step)(ctypes.byref(base), dblk.data_ptr(), L,
                                     ctypes.byref(pending), stream), step)
    return state, bufs


def reclaim_solve_sharded(c, s0, task_req, task_class, job_first, job_prio, job_cand0,
                          queue_live0, pipe0, mesh, *, use_gang, use_prop, use_conformance,
                          order_by_priority, has_proportion,
                          job_key_order=("priority", "gang", "drf")) -> ReclaimOut:
    """``reclaim_solve`` with the node planes of ``c`` and ``s0`` in blocks
    of rows (K15a): each of ``CONST_NODE_PLANES`` / ``STATE_NODE_PLANES`` a
    tuple of this process's blocks of ``mesh``, the rest whole.  Returns
    the one-block solve's outputs bit for bit, the state's node planes again
    tuples of this process's blocks.

    Replaces volcano_tpu/scheduler/victim_kernels.py:457 as the JAX fast
    cycle runs it under a mesh with solveMode: batch
    (volcano_tpu/scheduler/fast_victims.py:148-163).  Bound on the card by
    latency: each attempt of the walk is a host round trip (the blocks'
    cores, the exchange of one record a block, the step), far above its
    bytes.  Design (csrc/reclaim_solve.cu): K8's walk with its state in
    global memory, the pool grouped once a solve over the mesh's rows, each
    attempt's core over several CTAs a block (K12b's records), the merge
    and an owner-row apply from the chosen node's lists.  CPU tensors
    run ``parallel/sharded.reclaim_blocks_plain``; CUDA tensors launch the
    kernels or raise."""
    kw = dict(use_gang=use_gang, use_prop=use_prop, use_conformance=use_conformance,
              order_by_priority=order_by_priority, has_proportion=has_proportion,
              job_key_order=tuple(job_key_order))
    dev = _device_of(c, "reclaim_solve_sharded")
    nb = _check_blocks(c, s0, mesh, "reclaim_solve_sharded")
    args = (c, s0, task_req, task_class, job_first, job_prio, job_cand0, queue_live0, pipe0)
    tok = None
    if vtprof.PROFILER is not None:  # disarmed, no launch key is built
        tok = vtprof.launch_begin("reclaim_solve_sharded", _launch_key(c, s0, task_req, **kw), dev)
    if dev.type == "cpu":
        from volcano_tpu_torch.parallel.sharded import reclaim_blocks_plain

        return reclaim_blocks_plain(*args, mesh, nb, **kw)
    out = reclaim_blocks_launch(*_lib_stream(dev), *args, mesh, nb, **kw)
    LAUNCHES["reclaim_solve_sharded"] += 1
    vtprof.launch_end(tok)
    return out


def reclaim_blocks_launch(lib, stream, c, s0, task_req, task_class, job_first, job_prio,
                          job_cand0, queue_live0, pipe0, mesh, nb, *, use_gang, use_prop,
                          use_conformance, order_by_priority, has_proportion,
                          job_key_order=("priority", "gang", "drf")) -> ReclaimOut:
    """Validate, run csrc/reclaim_solve.cu's block entries around the mesh's
    exchange and return ``ReclaimOut``."""
    dev = c.run_req.device
    J, Q = c.job_queue.shape[0], s0.queue_alloc.shape[0]
    for name, t, dt, shape in (
        ("job_first", job_first, torch.int32, (J,)), ("job_prio", job_prio, torch.int32, (J,)),
        ("job_cand0", job_cand0, torch.bool, (J,)), ("queue_live0", queue_live0, torch.bool, (Q,)),
        ("pipe0", pipe0, torch.int32, (J,)),
    ):
        _check(name, t, dt, shape, dev)
    extra = dict(job_start=job_first, job_prio=job_prio, job_avail=job_cand0.clone(),
                 queue_live=queue_live0.clone(), pipe=pipe0.clone())
    flags = dict(use_gang=use_gang, use_drf=False, use_prop=use_prop,
                 use_conformance=use_conformance, order_by_priority=order_by_priority,
                 has_proportion=has_proportion, job_key_order=job_key_order)
    st, bufs = _walk_launch(lib, stream, "reclaim", c, s0, task_req, task_class, mesh, nb, extra,
                            {}, flags)
    return ReclaimOut(st, bufs["pipe"], _storm_records(bufs), bufs["ctl"][_VC_ABORT] != 0)


def preempt_solve_sharded(c, s0, task_req, task_class, task_attempt, job_start, job_ntasks,
                          job_prio, job_avail0, under_request, nu, queues_order, nq, pipe0, mesh,
                          *, use_gang, use_drf, use_conformance, order_by_priority,
                          job_key_order=("priority", "gang", "drf"),
                          gang_pipelined=True) -> PreemptOut:
    """``preempt_solve`` with the node planes in blocks (K15b), as
    ``reclaim_solve_sharded`` is K8's.

    Replaces volcano_tpu/scheduler/victim_kernels.py:607 under
    fast_victims.py:148-163, :191-198.  Bound by latency, as K15a.  Design
    (csrc/preempt_solve.cu): K9's state machine with its state and undo
    journal in global memory; each process journals its replicated words
    and its own blocks' node rows."""
    kw = dict(use_gang=use_gang, use_drf=use_drf, use_conformance=use_conformance,
              order_by_priority=order_by_priority, job_key_order=tuple(job_key_order),
              gang_pipelined=gang_pipelined)
    dev = _device_of(c, "preempt_solve_sharded")
    nb = _check_blocks(c, s0, mesh, "preempt_solve_sharded")
    args = (c, s0, task_req, task_class, task_attempt, job_start, job_ntasks, job_prio,
            job_avail0, under_request, nu, queues_order, nq, pipe0)
    tok = None
    if vtprof.PROFILER is not None:  # disarmed, no launch key is built
        tok = vtprof.launch_begin("preempt_solve_sharded", _launch_key(c, s0, task_req, **kw), dev)
    if dev.type == "cpu":
        from volcano_tpu_torch.parallel.sharded import preempt_blocks_plain

        return preempt_blocks_plain(*args, mesh, nb, **kw)
    out = preempt_blocks_launch(*_lib_stream(dev), *args, mesh, nb, **kw)
    LAUNCHES["preempt_solve_sharded"] += 1
    vtprof.launch_end(tok)
    return out


def preempt_blocks_launch(lib, stream, c, s0, task_req, task_class, task_attempt, job_start,
                          job_ntasks, job_prio, job_avail0, under_request, nu, queues_order, nq,
                          pipe0, mesh, nb, *, use_gang, use_drf, use_conformance,
                          order_by_priority, job_key_order=("priority", "gang", "drf"),
                          gang_pipelined=True) -> PreemptOut:
    """Validate, run csrc/preempt_solve.cu's block entries around the mesh's
    exchange and return ``PreemptOut``."""
    dev = c.run_req.device
    T = task_req.shape[0]
    J, Q = c.job_queue.shape[0], queues_order.shape[0]
    V, R = c.run_req.shape
    for name, t, dt, shape in (
        ("task_attempt", task_attempt, torch.bool, (T,)),
        ("job_start", job_start, torch.int32, (J,)), ("job_ntasks", job_ntasks, torch.int32, (J,)),
        ("job_prio", job_prio, torch.int32, (J,)), ("job_avail0", job_avail0, torch.bool, (J,)),
        ("under_request", under_request, torch.int32, (J,)),
        ("queues_order", queues_order, torch.int32, (Q,)), ("pipe0", pipe0, torch.int32, (J,)),
    ):
        _check(name, t, dt, shape, dev)
    # the undo journal, as preempt_launch sizes it
    jr_cap = T * (4 * R + 6) + V * (2 * R + 4) + 64
    extra = dict(
        task_attempt=task_attempt, job_start=job_start, job_ntasks=job_ntasks,
        job_prio=job_prio, under_request=under_request, queues_order=queues_order,
        job_avail=job_avail0.clone(), pipe=pipe0.clone(),
        cursor=torch.zeros(J, dtype=torch.int32, device=dev),
        jr_addr=torch.empty(jr_cap, dtype=torch.int64, device=dev),
        jr_old=torch.empty(jr_cap, dtype=torch.int32, device=dev),
    )
    flags = dict(use_gang=use_gang, use_drf=use_drf, use_prop=False,
                 use_conformance=use_conformance, order_by_priority=order_by_priority,
                 gang_pipelined=gang_pipelined, job_key_order=job_key_order)
    st, bufs = _walk_launch(lib, stream, "preempt", c, s0, task_req, task_class, mesh, nb, extra,
                            dict(nu=int(nu), nq=int(nq), jr_cap=jr_cap), flags)
    ctl = bufs["ctl"]
    if int(ctl[_VC_ERROR]):
        raise RuntimeError("preempt_solve_sharded: undo journal overflow")
    return PreemptOut(st, bufs["pipe"], _storm_records(bufs), ctl[_VC_ATT_TOTAL],
                      ctl[_VC_LAST_V], ctl[_VC_ANY] != 0, ctl[_VC_ABORT] != 0)


def preempt_rounds_sharded(c, s0, task_req, task_class, rows_packed, job_pstart, job_pcount,
                           job_prio, job_avail0, pipe0, mesh, *, use_gang, use_drf,
                           use_conformance, order_by_priority,
                           job_key_order=("priority", "gang", "drf"), gang_pipelined=True,
                           m_chunk=128, p_chunk=ROUNDS_P_CHUNK, k_chunk=8) -> RoundsOut:
    """``preempt_rounds`` with the node planes in blocks (K15c), as
    ``reclaim_solve_sharded`` is K8's.

    Replaces volcano_tpu/scheduler/victim_kernels.py:830 under
    fast_victims.py:148-163.  Bound by its launches, barriers and two host
    round trips a round (the exchanges).  Design (csrc/preempt_rounds.cu,
    the same code as K10): per block the candidate analysis, the tile pass
    and records, the cells' grants and the victims; replicated the
    within-job count, the select, the proposals from the gathered records
    and the accept; the blocks' victim sums in a second exchange a round.
    CPU tensors run ``parallel/sharded.rounds_blocks_plain``."""
    kw = dict(use_gang=use_gang, use_drf=use_drf, use_conformance=use_conformance,
              order_by_priority=order_by_priority, job_key_order=tuple(job_key_order),
              gang_pipelined=gang_pipelined, m_chunk=m_chunk, p_chunk=p_chunk, k_chunk=k_chunk)
    dev = _device_of(c, "preempt_rounds_sharded")
    nb = _check_blocks(c, s0, mesh, "preempt_rounds_sharded")
    args = (c, s0, task_req, task_class, rows_packed, job_pstart, job_pcount, job_prio,
            job_avail0, pipe0)
    tok = None
    if vtprof.PROFILER is not None:  # disarmed, no launch key is built
        tok = vtprof.launch_begin("preempt_rounds_sharded", _launch_key(c, s0, task_req, **kw), dev)
    if dev.type == "cpu":
        from volcano_tpu_torch.parallel.sharded import rounds_blocks_plain

        return rounds_blocks_plain(*args, mesh, nb, **kw)
    out = rounds_blocks_launch(*_lib_stream(dev), *args, mesh, nb, **kw)
    LAUNCHES["preempt_rounds_sharded"] += 1
    vtprof.launch_end(tok)
    return out


def rounds_blocks_launch(lib, stream, c, s0, task_req, task_class, rows_packed, job_pstart,
                         job_pcount, job_prio, job_avail0, pipe0, mesh, nb, *, use_gang,
                         use_drf, use_conformance, order_by_priority,
                         job_key_order=("priority", "gang", "drf"), gang_pipelined=True,
                         m_chunk=128, p_chunk=ROUNDS_P_CHUNK, k_chunk=8) -> RoundsOut:
    """Validate, run csrc/preempt_rounds.cu on the local blocks around the
    mesh's two exchanges a round and return ``RoundsOut`` (node planes as
    tuples of this process's blocks)."""
    dev = c.run_req.device
    T = task_req.shape[0]
    J, Q = c.job_queue.shape[0], s0.queue_alloc.shape[0]
    V, R = c.run_req.shape
    L, S = mesh.n_local, mesh.size
    N = nb * S
    M, P, K = min(m_chunk, J), p_chunk, min(k_chunk, N)
    F = M * P
    W = 5 + R
    for name, t, dt, shape in (
        ("rows_packed", rows_packed, torch.int32, (T,)),
        ("job_pstart", job_pstart, torch.int32, (J,)),
        ("job_pcount", job_pcount, torch.int32, (J,)),
        ("job_prio", job_prio, torch.int32, (J,)), ("job_avail0", job_avail0, torch.bool, (J,)),
        ("pipe0", pipe0, torch.int32, (J,)),
    ):
        _check(name, t, dt, shape, dev)
    if not (1 <= P <= 32 and 1 <= K <= 32) or F > 16384:
        raise ValueError(f"rounds kernel takes p_chunk, k_chunk in [1, 32] and F = m_chunk "
                         f"* p_chunk <= 16384 (the accept sort's shared memory), got {P}, "
                         f"{K}, {F}")
    # the score pass runs over node tiles of each block: any N; the select
    # over chunks of SEL_CHUNK job rows
    TB = -(-nb // ROUNDS_TILE)
    nC = -(-J // SEL_CHUNK)
    # a block's partial row: victims' sums per job and queue, per-job
    # counts, the victim count, the evicted rows' mask words in pairs
    W2 = J * R + Q * R + J + 1 + -(-(-(-V // 32)) // 2)
    i32 = dict(dtype=torch.int32, device=dev)
    f32, f64 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.float64, device=dev)
    u8 = dict(dtype=torch.uint8, device=dev)
    send = torch.empty((L, M * K * W), **i32)
    part = torch.zeros((L, W2), **f64)
    extra = dict(
        rows_packed=rows_packed, job_pstart=job_pstart, job_pcount=job_pcount,
        job_prio=job_prio, job_avail=job_avail0, pipe=pipe0.clone(),
        cursor=torch.zeros(J, **i32), dropped=torch.zeros(J, dtype=torch.bool, device=dev),
        job_off=torch.empty(J + 1, **i32), job_fill=torch.zeros(3 * J, **i32),
        job_bucket=torch.empty(V, **i32), job_key=torch.empty(2 * V, dtype=torch.int64,
                                                              device=dev),
        item_off=torch.empty(J + 1, **i32), cnt_in_job=torch.zeros(V, **i32),
        act_q=torch.empty(Q, **i32), ls_q=torch.empty(Q, **i32),
        job_active=torch.empty(J, **u8), job_keys=torch.zeros(J * 4, **f32),
        sel=torch.empty(M, **i32), c_key=torch.empty(nC * M * 4, **f32),
        c_job=torch.empty(nC * M, **i32), c_rank=torch.empty(nC * M, **i32),
        c_cnt=torch.empty(nC, **i32),
        p_node=torch.empty(F, **i32), p_t=torch.empty(F, **i32), p_job=torch.empty(F, **i32),
        p_flags=torch.empty(F, **u8), p_rec=torch.empty(F * W, **i32),
        p_key=torch.empty(F, dtype=torch.int64, device=dev), recv=send, part=part,
    )

    def block_extra(i):
        return dict(cap_flat=torch.empty(nb * Q * R, **f32),
                    cons_flat=torch.empty(nb * Q * R, **f32),
                    cons_node=torch.empty(nb * R, **f64), placed=torch.empty(nb, **i32),
                    t_val=torch.empty(M * TB * K, **f32), t_idx=torch.empty(M * TB * K, **i32),
                    t_any=torch.empty(M * TB, **u8), send=send[i], part=part[i])

    flags = dict(use_gang=use_gang, use_drf=use_drf, use_prop=False,
                 use_conformance=use_conformance, order_by_priority=order_by_priority,
                 gang_pipelined=gang_pipelined, job_key_order=job_key_order)
    base, blocks, st, bufs, keep = _blocks_args(
        c, s0, task_req, task_class, mesh, nb, extra,
        dict(M=M, P=P, K=K, F=F, TB=TB, TILE=ROUNDS_TILE, W=W, W2=W2, nC=nC), flags,
        block_extra)
    ctl = (ctypes.c_int32 * 12)()
    _raise_on(lib.vtt_rounds_begin(ctypes.byref(base), blocks, L, ctl, stream),
              "vtt_rounds_begin")
    while ctl[_VC_PROGRESS] and ctl[_VC_ACTIVE] > 0 and ctl[_VC_ITERS] < J + 8:
        _raise_on(lib.vtt_rounds_candidates(ctypes.byref(base), blocks, L, stream),
                  "vtt_rounds_candidates")
        recv = _exchanged(mesh, send)
        base.recv = recv.data_ptr()
        _raise_on(lib.vtt_rounds_decide(ctypes.byref(base), blocks, L, stream),
                  "vtt_rounds_decide")
        recv2 = _exchanged(mesh, part)
        base.part = recv2.data_ptr()
        _raise_on(lib.vtt_rounds_finish(ctypes.byref(base), ctl, stream), "vtt_rounds_finish")
    ctl_dev = bufs["ctl"]
    return RoundsOut(st, bufs["pipe"], _storm_records(bufs), ctl_dev[_VC_ATT_TOTAL],
                     ctl_dev[_VC_LAST_V], ctl_dev[_VC_ANY] != 0, bufs["cursor"], bufs["dropped"])
