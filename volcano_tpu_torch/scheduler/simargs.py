"""Simulated solve arguments for benches, the chip smoke run, and tests.

``build_sim_args`` is copied verbatim from ``volcano_tpu/scheduler/
simargs.py``: the dense argument set of the allocate solves for a synthetic
cluster — N nodes with mixed cpu/mem capacity, T pending tasks grouped into
J gang jobs across Q weighted queues — plus the water-fill inputs.
``build_portsel_args`` adds seeded host-port and pod (anti)affinity
bitsets for the same cluster, packed as the port's solves take them, and
``build_volsel_args`` seeded volume payloads (``kernels.pack_volsel``
packs them for the port's solve), ``build_batch_edge_args`` the edge
shapes of the batched solve's select and accept, and
``build_exact_edge_args`` those of the exact solve.
``build_victim_sim`` (also verbatim) is the victim-selection scenario of
the contention solves: running tasks spread over nodes, with the derived
node, job and queue state; ``build_storm_sim`` adds seeded preemptor jobs
to it (and ``storm_inputs`` the solves' arguments), and
``build_reclaim_abort_sim`` is the smallest pool on which the reference's
reclaim walk strands an eviction; ``build_rounds_edge_args`` reshapes a
storm into the edge shapes of the rounds solve's within-job count and job
select.
"""

from __future__ import annotations

import numpy as np

from volcano_tpu_torch.scheduler.kernels import pack_bits
from volcano_tpu_torch.scheduler.snapshot import _bucket


def build_sim_args(
    n_nodes: int,
    n_tasks: int,
    n_jobs: int,
    n_queues: int = 2,
    seed: int = 0,
    n_classes: int = 1,
    class_fill: float = 1.0,
):
    """Return the host-side (numpy) kwargs dict for one allocate cycle.

    Keys match the parameter names of ``allocate_solve_batch`` plus the
    ``water_fill`` inputs (queue_weight/queue_request/queue_participates).
    """
    assert n_tasks % n_jobs == 0, "tasks must divide evenly into jobs"
    rng = np.random.default_rng(seed)
    R = 2
    N, T, J, Q = (
        _bucket(n_nodes),
        _bucket(n_tasks),
        _bucket(n_jobs),
        _bucket(n_queues, 4),
    )

    node_alloc = np.zeros((N, R), np.float32)
    node_alloc[:n_nodes, 0] = rng.choice([8000, 16000, 32000], n_nodes)
    node_alloc[:n_nodes, 1] = rng.choice([16, 32, 64], n_nodes) * (1 << 30)
    node_valid = np.zeros(N, bool)
    node_valid[:n_nodes] = True

    tasks_per_job = n_tasks // n_jobs
    task_req = np.zeros((T, R), np.float32)
    task_req[:n_tasks, 0] = rng.choice([250, 500, 1000, 2000], n_tasks)
    task_req[:n_tasks, 1] = rng.choice([256, 512, 1024, 2048], n_tasks) * (1 << 20)
    task_valid = np.zeros(T, bool)
    task_valid[:n_tasks] = True
    task_job = np.zeros(T, np.int32)
    task_job[:n_tasks] = np.repeat(np.arange(n_jobs, dtype=np.int32), tasks_per_job)

    job_start = np.zeros(J, np.int32)
    job_ntasks = np.zeros(J, np.int32)
    job_start[:n_jobs] = np.arange(n_jobs, dtype=np.int32) * tasks_per_job
    job_ntasks[:n_jobs] = tasks_per_job
    job_min = np.zeros(J, np.int32)
    job_min[:n_jobs] = rng.integers(1, tasks_per_job + 1, n_jobs)
    job_queue = np.full(J, -1, np.int32)
    job_queue[:n_jobs] = rng.integers(0, n_queues, n_jobs)
    job_prio = np.zeros(J, np.int32)
    job_prio[:n_jobs] = rng.choice([0, 0, 5, 10], n_jobs)
    job_schedulable = np.zeros(J, bool)
    job_schedulable[:n_jobs] = True

    queue_weight = np.zeros(Q, np.float32)
    queue_weight[:n_queues] = np.arange(n_queues, 0, -1, dtype=np.float32)
    queue_request = np.zeros((Q, R), np.float32)
    q_of_task = job_queue[task_job[:n_tasks]]
    for q in range(n_queues):
        queue_request[q] = task_req[:n_tasks][q_of_task == q].sum(0)
    queue_participates = np.zeros(Q, bool)
    queue_participates[:n_queues] = True

    eps = np.array([10.0, 10 * 1024 * 1024], np.float32)
    total = node_alloc[node_valid].sum(0)

    # predicate classes (BASELINE config 3 shape): tasks of one job share a
    # class; each class admits a random ``class_fill`` fraction of nodes
    # (node-affinity-style masks) and carries a static affinity score
    C = max(n_classes, 1)
    task_class = np.zeros(T, np.int32)
    if n_classes > 1:
        job_class = rng.integers(0, n_classes, n_jobs).astype(np.int32)
        task_class[:n_tasks] = job_class[task_job[:n_tasks]]
    if n_classes > 1 or class_fill < 1.0:
        class_mask = np.zeros((C, N), bool)
        class_mask[:, :n_nodes] = rng.random((C, n_nodes)) < class_fill
        # a class that matched no node would make its jobs trivially
        # unschedulable; rescue with ONE random node so the requested
        # sparsity is preserved (not flipped to all-True)
        for c in np.nonzero(~class_mask[:, :n_nodes].any(1))[0]:
            class_mask[c, rng.integers(0, n_nodes)] = True
        class_score = np.where(
            class_mask, rng.random((C, N)).astype(np.float32) * 10.0, 0.0
        ).astype(np.float32)
    else:
        class_mask = np.ones((C, N), bool)
        class_score = np.zeros((C, N), np.float32)

    return dict(
        idle=node_alloc.copy(),
        releasing=np.zeros((N, R), np.float32),
        used=np.zeros((N, R), np.float32),
        node_alloc=node_alloc,
        node_max_tasks=np.full(N, 2**31 - 1, np.int32),
        task_count=np.zeros(N, np.int32),
        node_valid=node_valid,
        task_req=task_req,
        task_job=task_job,
        task_class=task_class,
        task_valid=task_valid,
        job_queue=job_queue,
        job_min=job_min,
        job_prio=job_prio,
        job_ready_init=np.zeros(J, np.int32),
        job_alloc_init=np.zeros((J, R), np.float32),
        job_schedulable=job_schedulable,
        job_start=job_start,
        job_ntasks=job_ntasks,
        queue_alloc_init=np.zeros((Q, R), np.float32),
        class_mask=class_mask,
        class_score=class_score,
        total=total,
        eps=eps,
        queue_weight=queue_weight,
        queue_request=queue_request,
        queue_participates=queue_participates,
    )


def add_releasing(args: dict, seed: int = 0, busy_frac: float = 0.6) -> dict:
    """Make a ``busy_frac`` share of the valid nodes busy in ``args`` (in
    place): part of each busy node's capacity used and part of that
    releasing, in whole multiples of 250 millicores and 256 MiB, so that
    placements also pipeline onto releasing capacity."""
    rng = np.random.default_rng(seed + 100)
    N = args["node_valid"].shape[0]
    busy = args["node_valid"] & (rng.random(N) < busy_frac)
    units = np.array([250.0, 256.0 * (1 << 20)], np.float32)
    used = np.floor(args["node_alloc"] * rng.uniform(0.5, 1.0, (N, 1)) / units) * units
    used[~busy] = 0
    args["used"] = used.astype(np.float32)
    args["idle"] = np.maximum(args["node_alloc"] - used, 0).astype(np.float32)
    args["releasing"] = (np.floor(used * rng.uniform(0.2, 1.0, (N, 1)) / units)
                         * units).astype(np.float32)
    args["task_count"] = np.where(busy, rng.integers(1, 4, N), 0).astype(np.int32)
    return args


#: the shapes the batched solve's select and accept must get right
#: (``build_batch_edge_args``)
BATCH_EDGE_CASES = ("tied_chunks", "few_active", "prio_zero", "many_queues", "hot_node",
                    "drop_rollback")


def _refresh_totals(a: dict) -> None:
    """Recompute idle, total and the queues' requests after a reshape."""
    a["idle"] = a["node_alloc"].copy()
    a["total"] = a["node_alloc"][a["node_valid"]].sum(0).astype(np.float32)
    n_tasks = int(a["task_valid"].sum())
    q_of_task = a["job_queue"][a["task_job"][:n_tasks]]
    for q in range(a["queue_request"].shape[0]):
        a["queue_request"][q] = a["task_req"][:n_tasks][q_of_task == q].sum(0)


def build_batch_edge_args(case: str, seed: int = 0):
    """``(args, opts)``: ``build_sim_args`` inputs reshaped into one edge
    shape of the batched solve's select and accept, and the solve options
    that reach it:

    * ``tied_chunks``: 2,100 one-task jobs of one queue at one priority on
      64 nodes with room for all: more jobs than one select chunk (2,048),
      every tier key tied, so the job index alone orders them;
    * ``few_active``: 40 jobs of which 20 are schedulable, m_chunk 32:
      fewer active jobs than M;
    * ``prio_zero``: priority 0 (the key -0.0) beside priority 3, the
      priority key first;
    * ``many_queues``: 96 two-task jobs over 24 queues, all selected in the
      first round, with room for all: winners in every queue in one round;
    * ``hot_node``: one node a hundred times the size of the others, which
      are too small for any task: every proposal lands on that node (one
      long node segment);
    * ``drop_rollback``: three 6-task gangs (min 6) on four nodes with room
      for three tasks each, no proportion: a round with no win drops the
      lowest-ranked gang and unwinds its placements.
    """
    if case == "tied_chunks":
        a = build_sim_args(64, 2100, 2100, n_queues=1, seed=seed)
        a["job_prio"][:] = 0
        a["node_alloc"] *= 100
        opts = dict(p_chunk=2)
    elif case == "few_active":
        a = build_sim_args(16, 160, 40, n_queues=2, seed=seed)
        a["job_schedulable"][:40:2] = False
        opts = dict(m_chunk=32, p_chunk=3)
    elif case == "prio_zero":
        a = build_sim_args(16, 128, 32, n_queues=2, seed=seed)
        a["job_prio"][:32] = np.where(np.arange(32) % 3 == 0, 3, 0)
        opts = dict(m_chunk=8, p_chunk=3, job_key_order=("priority", "drf", "gang"))
    elif case == "many_queues":
        a = build_sim_args(32, 192, 96, n_queues=24, seed=seed)
        a["node_alloc"] *= 10
        opts = dict(m_chunk=96, p_chunk=2)
    elif case == "hot_node":
        a = build_sim_args(16, 256, 32, n_queues=2, seed=seed)
        a["node_alloc"][0] *= 100
        a["node_alloc"][1:16] = (100.0, 64.0 * (1 << 20))
        opts = dict(m_chunk=32, p_chunk=8)
    elif case == "drop_rollback":
        a = build_sim_args(4, 18, 3, n_queues=1, seed=seed)
        a["task_req"][:18] = (1000.0, 1024.0 * (1 << 20))
        a["node_alloc"][:4] = (3000.0, 3072.0 * (1 << 20))
        a["job_min"][:3] = 6
        opts = dict(m_chunk=3, p_chunk=3, use_proportion=False)
    else:
        raise ValueError(f"unknown batch edge case {case!r}")
    _refresh_totals(a)
    return a, opts


#: the shapes the exact solve's cluster kernel must get right
#: (``build_exact_edge_args``)
EXACT_EDGE_CASES = ("tied_scores", "odd_nodes", "queue_drops", "unfit_head", "long_gang",
                    "releasing_only", "global_pool", "port_conflict", "anti_veto")


def _slice_nodes(a: dict, n: int) -> None:
    """Cut the node axis of ``a`` to its first ``n`` rows (any N, not a
    bucket size)."""
    for k in ("idle", "releasing", "used", "node_alloc", "node_max_tasks", "task_count",
              "node_valid"):
        a[k] = np.ascontiguousarray(a[k][:n])
    for k in ("class_mask", "class_score"):
        a[k] = np.ascontiguousarray(a[k][:, :n])


def _empty_portsel(N: int, T: int) -> dict:
    z = np.zeros
    return dict(node_ports=z((N, 4), np.int32), task_ports=z((T, 4), np.int32),
                node_selcnt=z((N, 64), np.int32), task_aff=z((T, 2), np.int32),
                task_anti=z((T, 2), np.int32), task_self=z((T, 2), np.int32), w_podaff=1.0)


def build_exact_edge_args(case: str, seed: int = 0):
    """``(args, opts, portsel, volsel)``: ``build_sim_args`` inputs reshaped
    into one edge shape of the exact solve, the solve options, and the
    packed ``portsel`` dict (``PORTSEL_KEYS``) and ``volsel`` payload
    (``build_volsel_args``' form) the case needs, or None:

    * ``tied_scores``: 40 identical nodes and no class score: every node
      scores the same at the first step, so the lowest index must win;
    * ``odd_nodes``: 13 nodes (not a bucket, not a multiple of 8 or 16,
      fewer than a warp);
    * ``queue_drops``: 128 queues on six nodes that cannot hold their
      requests: queues reach their deserved share and drop with active
      jobs left;
    * ``unfit_head``: job 3's tasks ask ten times the largest node: its head
      task fits nowhere and the job drops;
    * ``long_gang``: job 0 is a 32-task gang whose min member is its size:
      it stays current for 32 place steps;
    * ``releasing_only``: six of eight nodes have no idle capacity, only
      releasing: placements pipeline;
    * ``global_pool``: two jobs share claims of a global PV pool (one count
      on every node) and one a pinned pool: an idle-fit placement folds a
      decrement into the global group's whole row;
    * ``port_conflict``: node 0 is ten times the others and four one-task
      jobs ask the same host port: one lands on node 0, the rest elsewhere;
    * ``anti_veto``: node 0 is ten times the others and holds a resident
      matching the anti selector of job 0's tasks: they avoid node 0.
    """
    ps = vs = None
    opts = {}
    if case == "tied_scores":
        a = build_sim_args(40, 64, 16, n_queues=2, seed=seed)
        a["node_alloc"][:40] = (16000.0, 32.0 * (1 << 30))
    elif case == "odd_nodes":
        a = build_sim_args(13, 40, 10, n_queues=2, seed=seed)
        _slice_nodes(a, 13)
    elif case == "queue_drops":
        a = build_sim_args(6, 256, 128, n_queues=100, seed=seed)
    elif case == "unfit_head":
        a = build_sim_args(16, 64, 16, n_queues=2, seed=seed)
        a["task_req"][a["task_job"] == 3] = a["node_alloc"].max(0) * 10
    elif case == "long_gang":
        a = build_sim_args(16, 96, 3, n_queues=1, seed=seed)
        a["job_min"][0] = 32
        a["node_alloc"][:16] = (32000.0, 64.0 * (1 << 30))
    elif case == "releasing_only":
        a = build_sim_args(8, 32, 8, n_queues=2, seed=seed)
        a["node_alloc"][6:8] = (250.0, 256.0 * (1 << 20))
        _refresh_totals(a)
        a["used"][:6] = a["node_alloc"][:6]
        a["idle"][:6] = 0
        a["releasing"][:6] = a["node_alloc"][:6]
        return a, opts, ps, vs
    elif case == "global_pool":
        a = build_sim_args(12, 32, 8, n_queues=2, seed=seed)
        N, T = a["node_valid"].shape[0], a["task_valid"].shape[0]
        claims = np.zeros((T, 8), bool)
        claims[a["task_job"] == 0, 0] = True
        claims[a["task_job"] == 1, 1] = True
        claims[a["task_job"] == 2, 2] = True
        claims[32:] = False
        cap = np.zeros((2, N), np.int32)
        cap[0, :] = 2
        cap[1, :4] = 1
        bits = np.zeros((T, max(1, (N + 31) // 32) * 32), bool)
        bits[:, :N] = True
        vs = dict(task_volmask_w=pack_bits(bits), task_claims=claims,
                  claim_group=np.array([0, 0, 1, 0, 0, 0, 0, 0], np.int32), group_cap=cap,
                  group_global=np.array([True, False]))
    elif case in ("port_conflict", "anti_veto"):
        a = build_sim_args(8, 32, 8 if case == "anti_veto" else 32, n_queues=1, seed=seed)
        a["node_alloc"][0] *= 10
        N, T = a["node_valid"].shape[0], a["task_valid"].shape[0]
        ps = _empty_portsel(N, T)
        if case == "port_conflict":
            ps["task_ports"][:4, 0] = 1 << 5
        else:
            ps["node_selcnt"][0, 7] = 1
            ps["task_anti"][a["task_job"] == 0, 0] = 1 << 7
            ps["task_anti"][32:] = 0
    else:
        raise ValueError(f"unknown exact edge case {case!r}")
    _refresh_totals(a)
    return a, opts, ps, vs


def build_portsel_args(
    n_nodes: int,
    n_tasks: int,
    seed: int = 0,
    n_jobs: int = 0,
    w_podaff: float = 1.0,
    resident_frac: float = 0.4,
):
    """Seeded ``portsel`` inputs (host ports, pod (anti)affinity) for the
    ``build_sim_args`` cluster of the same ``n_nodes`` / ``n_tasks`` /
    ``n_jobs`` (0: one task per job), PACKED as the port's solves take
    them: u32 bitset words carried as int32, resident counts as int32.

    Residents: a ``resident_frac`` share of the nodes hold one host port
    and a few selector matches.  Each job is one kind, its tasks sharing
    the template: plain, ``ports`` (one host port), ``aff`` (a required
    selector), ``anti`` (an anti selector), ``self-anti`` (labels matching
    its own anti selector) or ``mixed`` (only the first task has a port,
    the second an anti selector).  Port and selector bits sit at seeded
    positions: six of the 128 ports and five of the 64 selectors, plus bit
    31 and the last bit, so that the top bit of a word is among them.

    Returns a dict: node_ports [N, 4], task_ports [T, 4], node_selcnt
    [N, 64], task_aff / task_anti / task_self [T, 2], w_podaff."""
    rng = np.random.default_rng(seed + 1000)
    N, T = _bucket(n_nodes), _bucket(n_tasks)
    n_jobs = n_jobs or n_tasks
    tpj = n_tasks // n_jobs
    PB, S = 128, 64
    port_ids = np.unique(np.concatenate([[127, 31], rng.choice(PB, 6, replace=False)]))
    sel_ids = np.unique(np.concatenate([[63, 31], rng.choice(S, 5, replace=False)]))

    node_ports = np.zeros((N, PB), bool)
    node_selcnt = np.zeros((N, S), np.int32)
    res = np.nonzero(rng.random(n_nodes) < resident_frac)[0]
    node_ports[res, rng.choice(port_ids, res.size)] = True
    for k in range(2):
        node_selcnt[res, rng.choice(sel_ids, res.size)] += rng.integers(0, 3, res.size)

    task_ports = np.zeros((T, PB), bool)
    aff = np.zeros((T, S), bool)
    anti = np.zeros((T, S), bool)
    self_ = np.zeros((T, S), bool)
    kinds = rng.choice(["plain", "ports", "aff", "anti", "self-anti", "mixed"], n_jobs)
    for j in range(n_jobs):
        rows = np.arange(j * tpj, (j + 1) * tpj)
        port, sel = rng.choice(port_ids), rng.choice(sel_ids)
        self_[rows, rng.choice(sel_ids)] = rng.random() < 0.5
        if kinds[j] == "ports":
            task_ports[rows, port] = True
        elif kinds[j] == "aff":
            aff[rows, sel] = True
        elif kinds[j] == "anti":
            anti[rows, sel] = True
        elif kinds[j] == "self-anti":
            anti[rows, sel] = True
            self_[rows, sel] = True
        elif kinds[j] == "mixed":
            task_ports[rows[0], port] = True
            anti[rows[1:2], sel] = True
    def words(bits):
        return pack_bits(bits).view(np.int32)

    return dict(
        node_ports=words(node_ports), task_ports=words(task_ports),
        node_selcnt=node_selcnt, task_aff=words(aff), task_anti=words(anti),
        task_self=words(self_), w_podaff=float(w_podaff),
    )


PORTSEL_KEYS = ("node_ports", "task_ports", "node_selcnt", "task_aff",
                "task_anti", "task_self", "w_podaff")


#: job kinds of build_volsel_args, in the order every seed lays them out
VOLSEL_KINDS = ("plain", "bound", "pinned", "global", "two-claims", "bound-pinned",
                "exhausted", "pinned")


def build_volsel_args(n_nodes: int, n_tasks: int, seed: int = 0, n_jobs: int = 0):
    """Seeded ``volsel`` payload, in the JAX package's form
    (``volsolve.VolumePartition.payload``), for the ``build_sim_args``
    cluster of the same ``n_nodes`` / ``n_tasks`` / ``n_jobs``.

    Job j is of kind ``VOLSEL_KINDS[j % 8]``: ``plain`` (no volume state),
    ``bound`` (its tasks may use a seeded set of one to three nodes, as a
    bound PV's affinity gives), ``pinned`` (one claim the job's tasks share,
    of group 0: node-pinned PVs on a few nodes, one or two a node, so that
    the two ``pinned`` jobs contend for them), ``global`` (one shared claim
    of group 1: network PVs, a count on every node), ``two-claims`` (two
    claims of group 0 on every task, which its first placement assumes
    together), ``bound-pinned`` (a node set and a group-0 claim), and
    ``exhausted`` (a claim of group 2, whose pool is empty).

    Returns a dict: task_volmask_w [T, VW] u32, task_claims [T, CL] bool,
    claim_group [CL] i32, group_cap [G, N] i32, group_global [G] bool."""
    rng = np.random.default_rng(seed + 2000)
    N, T = _bucket(n_nodes), _bucket(n_tasks)
    n_jobs = n_jobs or n_tasks
    tpj = n_tasks // n_jobs
    VW = max(1, (N + 31) // 32)
    G = 4
    group_cap = np.zeros((G, N), np.int32)
    pins = rng.choice(n_nodes, size=min(3, n_nodes), replace=False)
    group_cap[0, pins] = rng.integers(1, 3, pins.size)
    group_cap[1, :] = int(rng.integers(1, 4))
    group_global = np.array([False, True, True, False])
    node_sets = np.zeros((T, N), bool)
    node_sets[:] = True
    claims = []          # (task rows, group)
    for j in range(n_jobs):
        rows = np.arange(j * tpj, (j + 1) * tpj)
        kind = VOLSEL_KINDS[j % len(VOLSEL_KINDS)]
        if kind in ("bound", "bound-pinned"):
            allowed = np.zeros(N, bool)
            allowed[rng.choice(n_nodes, size=int(rng.integers(1, 4)), replace=False)] = True
            node_sets[rows] = allowed
        if kind in ("pinned", "bound-pinned"):
            claims.append((rows, 0))
        elif kind == "global":
            claims.append((rows, 1))
        elif kind == "two-claims":
            claims += [(rows, 0), (rows, 0)]
        elif kind == "exhausted":
            claims.append((rows, 2))
    CL = _bucket(max(len(claims), 1), minimum=8)
    task_claims = np.zeros((T, CL), bool)
    claim_group = np.zeros(CL, np.int32)
    for c, (rows, g) in enumerate(claims):
        task_claims[rows, c] = True
        claim_group[c] = g
    bits = np.zeros((T, VW * 32), bool)
    bits[:, :N] = node_sets
    return dict(task_volmask_w=pack_bits(bits), task_claims=task_claims,
                claim_group=claim_group, group_cap=group_cap, group_global=group_global)


def build_victim_sim(
    n_nodes: int,
    n_victims: int,
    n_jobs: int,
    n_queues: int = 2,
    seed: int = 0,
    node_cpu: float = 16000.0,
    node_mem: float = 32.0 * (1 << 30),
):
    """(consts_kwargs, state_kwargs) numpy dicts for one victim-selection
    scenario: ``n_victims`` running tasks spread over ``n_nodes``, with all
    derived state (used/idle, per-job allocation and occupancy, per-node
    task counts, per-queue allocation) accumulated consistently. Job row 0
    is reserved for the preemptor (no residents). Field names match
    ``VictimConsts`` / ``VictimState`` — construct with ``Consts(**c)``.
    """
    assert n_jobs >= 2, "n_jobs must be >= 2: job 0 is the reserved preemptor"
    rng = np.random.default_rng(seed)
    R = 2
    N, V, J, Q = (
        _bucket(n_nodes),
        _bucket(n_victims),
        _bucket(n_jobs, 4),
        _bucket(n_queues, 4),
    )

    node_alloc = np.zeros((N, R), np.float32)
    node_alloc[:n_nodes, 0] = node_cpu
    node_alloc[:n_nodes, 1] = node_mem
    run_req = np.zeros((V, R), np.float32)
    run_req[:n_victims, 0] = rng.choice([250, 500, 1000], n_victims)
    run_req[:n_victims, 1] = rng.choice([256, 512, 1024], n_victims) * (1 << 20)
    run_node = np.zeros(V, np.int32)
    run_node[:n_victims] = rng.integers(0, n_nodes, n_victims)
    run_job = np.zeros(V, np.int32)
    run_job[:n_victims] = rng.integers(1, n_jobs, n_victims)  # job 0 = preemptor
    job_queue = np.zeros(J, np.int32)
    job_queue[:n_jobs] = rng.integers(0, n_queues, n_jobs)
    job_queue[0] = 0  # the reserved preemptor job; callers pass qt=0

    live = np.arange(V) < n_victims
    used = np.zeros((N, R), np.float32)
    np.add.at(used, run_node[live], run_req[live])
    job_alloc = np.zeros((J, R), np.float32)
    np.add.at(job_alloc, run_job[live], run_req[live])
    occupied = np.zeros(J, np.int32)
    np.add.at(occupied, run_job[live], 1)
    task_count = np.zeros(N, np.int32)
    np.add.at(task_count, run_node[live], 1)
    queue_alloc = np.zeros((Q, R), np.float32)
    np.add.at(queue_alloc, job_queue[run_job[live]], run_req[live])

    total = node_alloc[:n_nodes].sum(0).astype(np.float32)
    consts = dict(
        run_req=run_req,
        run_node=run_node,
        run_job=run_job,
        run_prio=rng.integers(0, 3, V).astype(np.int32),
        run_rank=rng.permutation(V).astype(np.int32),
        run_evictable=np.ones(V, bool),
        job_queue=job_queue,
        job_min=np.ones(J, np.int32),
        node_alloc=node_alloc,
        node_max_tasks=np.full(N, 2**31 - 1, np.int32),
        node_valid=(np.arange(N) < n_nodes),
        class_mask=np.ones((1, N), bool),
        class_score=np.zeros((1, N), np.float32),
        queue_deserved=np.full((Q, R), 1e15, np.float32),
        total=total,
        eps=np.array([10.0, 10 * 1024 * 1024], np.float32),
        w_least=np.float32(1.0),
        w_balanced=np.float32(1.0),
    )
    state = dict(
        run_live=live.copy(),
        idle=np.maximum(node_alloc - used, 0.0).astype(np.float32),
        releasing=np.zeros((N, R), np.float32),
        used=used,
        task_count=task_count,
        job_alloc=job_alloc,
        job_occupied=occupied,
        queue_alloc=queue_alloc,
    )
    return consts, state


def build_storm_sim(seed, n_nodes=6, n_victims=60, n_jobs=12, n_queues=2, n_new=3,
                    n_old=2, big=False, scalar=False, classes=1):
    """Victim pool + preemptor jobs: ``n_new`` fresh gangs (no residents,
    min_member = their task count, job rows past the pool's jobs) and
    ``n_old`` pool jobs with extra pending tasks (phase-2 material).  With
    ``big`` one fresh gang asks more than any node's victims can cover, so
    its statement is discarded; with ``scalar`` every request and node
    carries a third, scalar resource (0-2 devices a pod, 8 a node); with
    ``classes`` > 1 the tasks cycle through predicate classes whose masks
    admit random halves of the nodes, with random static scores."""
    c, s = build_victim_sim(n_nodes, n_victims, n_jobs, n_queues=n_queues, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    if scalar:
        live = s["run_live"]
        V, N = c["run_req"].shape[0], c["node_alloc"].shape[0]
        dev = np.where(live, rng.integers(0, 3, V), 0).astype(np.float32)
        c["run_req"] = np.concatenate([c["run_req"], dev[:, None]], 1)
        c["node_alloc"] = np.concatenate(
            [c["node_alloc"], np.where(c["node_valid"], 8.0, 0.0).astype(np.float32)[:, None]], 1)
        c["total"] = c["node_alloc"].sum(0).astype(np.float32)
        c["eps"] = np.append(c["eps"], np.float32(10.0))
        R = 3
        used = np.zeros((N, R), np.float32)
        np.add.at(used, c["run_node"][live], c["run_req"][live])
        job_alloc = np.zeros((s["job_alloc"].shape[0], R), np.float32)
        np.add.at(job_alloc, c["run_job"][live], c["run_req"][live])
        queue_alloc = np.zeros((s["queue_alloc"].shape[0], R), np.float32)
        np.add.at(queue_alloc, c["job_queue"][c["run_job"][live]], c["run_req"][live])
        s.update(used=used, idle=np.maximum(c["node_alloc"] - used, 0.0).astype(np.float32),
                 releasing=np.zeros((N, R), np.float32), job_alloc=job_alloc,
                 queue_alloc=queue_alloc)
    J = c["job_queue"].shape[0]
    Q = s["queue_alloc"].shape[0]
    assert n_jobs + n_new <= J
    c["job_min"][:n_jobs] = rng.choice([1, 1, 2, 3], n_jobs)
    c["run_evictable"][:] = rng.random(c["run_evictable"].shape[0]) < 0.9
    c["run_prio"][:] = rng.integers(0, 3, c["run_prio"].shape[0])
    # one queue below its deserved share (the reclaimers' queue), the others
    # above it (their residents are reclaimable)
    under = seed % n_queues
    factor = np.where(np.arange(Q) == under, 1.5, 0.6)[:, None]
    c["queue_deserved"] = (s["queue_alloc"] * factor).astype(np.float32)
    new = np.arange(n_jobs, n_jobs + n_new)
    c["job_queue"][new] = rng.integers(0, n_queues, n_new)
    c["job_queue"][new[:2]] = under
    old = rng.choice(np.arange(1, n_jobs), n_old, replace=False)
    pre = np.concatenate([new, old])
    counts = np.zeros(J, np.int32)
    counts[new] = rng.integers(2, 5, n_new)
    counts[old] = rng.integers(1, 3, n_old)
    c["job_min"][new] = counts[new]
    nt = int(counts.sum())
    T = 8
    while T < nt:
        T *= 2
    job_start = np.zeros(J, np.int32)
    job_start[1:] = np.cumsum(counts)[:-1]
    task_req = np.zeros((T, c["run_req"].shape[1]), np.float32)
    task_req[:nt, 0] = rng.choice([250, 500, 1000], nt)
    task_req[:nt, 1] = rng.choice([256, 512], nt) * (1 << 20)
    if scalar:
        task_req[:nt, 2] = rng.integers(0, 2, nt)
    if big:
        j = new[0]
        task_req[job_start[j]:job_start[j] + counts[j], 0] = 9000
    prio = np.zeros(J, np.int32)
    prio[:n_jobs] = rng.choice([0, 5], n_jobs)
    prio[new] = 10
    task_class = np.zeros(T, np.int32)
    if classes > 1:
        N = c["node_alloc"].shape[0]
        task_class[:nt] = np.arange(nt) % classes
        mask = rng.random((classes, N)) < 0.5
        mask[0] = True
        c["class_mask"] = mask & c["node_valid"][None, :]
        c["class_score"] = np.where(c["class_mask"], rng.random((classes, N)) * 10.0,
                                    0.0).astype(np.float32)
    return c, s, dict(task_req=task_req, task_class=task_class,
                      job_start=job_start, job_ntasks=counts, job_prio=prio,
                      pre=np.sort(pre), nt=nt, n_jobs=n_jobs + n_new)


def _reclaim_inputs(c, s, t):
    J = c["job_queue"].shape[0]
    Q = s["queue_alloc"].shape[0]
    cand = np.zeros(J, bool)
    cand[t["pre"]] = True
    live = np.zeros(Q, bool)
    live[np.unique(c["job_queue"][t["pre"]])] = True
    return [t["task_req"], t["task_class"], t["job_start"], t["job_prio"], cand, live,
            np.zeros(J, np.int32)]


def _preempt_inputs(c, s, t):
    J = c["job_queue"].shape[0]
    Q = s["queue_alloc"].shape[0]
    T = t["task_req"].shape[0]
    attempt = np.zeros(T, bool)
    attempt[:t["nt"]] = True
    avail = np.zeros(J, bool)
    avail[t["pre"]] = True
    under = np.zeros(J, np.int32)
    under[:t["pre"].size] = t["pre"]
    qs = c["job_queue"][:t["n_jobs"]]
    _, first = np.unique(qs, return_index=True)
    qorder = qs[np.sort(first)].astype(np.int32)
    qpad = np.zeros(Q, np.int32)
    qpad[:qorder.size] = qorder
    return [t["task_req"], t["task_class"], attempt, t["job_start"], t["job_ntasks"],
            t["job_prio"], avail, under, t["pre"].size, qpad, qorder.size,
            np.zeros(J, np.int32)]


def _rounds_inputs(c, s, t):
    J = c["job_queue"].shape[0]
    T = t["task_req"].shape[0]
    rows = np.zeros(T, np.int32)
    rows[:t["nt"]] = np.arange(t["nt"])
    avail = np.zeros(J, bool)
    avail[t["pre"]] = True
    return [t["task_req"], t["task_class"], rows, t["job_start"], t["job_ntasks"],
            t["job_prio"], avail, np.zeros(J, np.int32)]


def storm_inputs(kind, c, s, t):
    """The positional arguments after (consts, state) of ``reclaim_solve``,
    ``preempt_solve`` or ``preempt_rounds`` for a storm scenario, as numpy
    arrays and ints."""
    return {"reclaim": _reclaim_inputs, "preempt": _preempt_inputs,
            "rounds": _rounds_inputs}[kind](c, s, t)


#: the shapes the rounds solve's within-job count and job select must get
#: right (``build_rounds_edge_args``)
ROUNDS_EDGE_CASES = ("padded_job0", "big_job", "tied_rows", "no_priority_order",
                     "many_chunks", "few_active")


def _move_rows(c, s, rows, job):
    """Rows ``rows`` of the pool into job ``job``; the jobs' allocation and
    occupancy summed again from the live rows, as ``build_victim_sim`` sums
    them."""
    c["run_job"][rows] = job
    live = s["run_live"]
    job_alloc = np.zeros_like(s["job_alloc"])
    np.add.at(job_alloc, c["run_job"][live], c["run_req"][live])
    occupied = np.zeros_like(s["job_occupied"])
    np.add.at(occupied, c["run_job"][live], 1)
    s["job_alloc"], s["job_occupied"] = job_alloc, occupied


def build_rounds_edge_args(case: str, seed: int = 0):
    """``(consts, state, tasks, opts)``: a ``build_storm_sim`` scenario
    reshaped into one edge shape of the rounds solve's within-job count or
    job select, and the solve options that reach it (``storm_inputs("rounds",
    ...)`` gives its arguments):

    * ``padded_job0``: a pool padded to its bucket whose dead rows (job 0,
      node 0) fill more than two count tiles, with 24 live rows of job 0
      (min member 3, queue 0, first in their nodes' eviction order) beside
      them: the padding rows keep those off node 0 out of the gang budget;
    * ``big_job``: one live job of 616 rows over every node, its gang
      budget 40 rows: a bucket of three count tiles and 20 row chunks;
    * ``tied_rows``: each node's rows of one job share one priority and one
      rank, so only the pool index orders them;
    * ``no_priority_order``: ``order_by_priority`` off, over a 300-row job
      whose rows' priorities disagree with their ranks;
    * ``many_chunks``: 1,900 fresh gangs and 400 pool jobs with pending
      tasks (4,096 job rows, active jobs in both select chunks), the fresh
      ones at priority 0 (the key -0.0) or 3, the gang key first, so most
      keys tie and the job index orders them;
    * ``few_active``: five active jobs against m_chunk 16.
    """
    kw = dict(use_gang=True, use_drf=False, use_conformance=True, order_by_priority=True)
    if case == "padded_job0":
        c, s, t = build_storm_sim(seed, n_nodes=8, n_victims=1100, n_jobs=40, n_new=6)
        live = np.flatnonzero(s["run_live"])
        c["job_queue"][0] = 0
        c["job_min"][0] = 3
        _move_rows(c, s, live[:24], 0)
        # job 0's rows first in their nodes' eviction order
        c["run_prio"][live] = np.where(c["run_job"][live] == 0, 0, 2)
        kw.update(m_chunk=8, p_chunk=6, k_chunk=3)
    elif case == "big_job":
        c, s, t = build_storm_sim(seed, n_nodes=12, n_victims=900, n_jobs=26, n_new=6)
        live = np.flatnonzero(s["run_live"])
        c["job_queue"][1] = 0
        _move_rows(c, s, live[:600], 1)
        c["job_min"][1] = s["job_occupied"][1] - 40
        kw.update(use_drf=True)
    elif case == "tied_rows":
        c, s, t = build_storm_sim(seed, n_nodes=6, n_victims=200, n_jobs=12, n_new=4)
        live = s["run_live"]
        key = c["run_job"] * 1024 + c["run_node"]
        for k in np.unique(key[live]):
            rows = np.flatnonzero(live & (key == k))
            c["run_prio"][rows] = c["run_prio"][rows[0]]
            c["run_rank"][rows] = c["run_rank"][rows[0]]
        c["job_min"][:12] = 2
    elif case == "no_priority_order":
        c, s, t = build_storm_sim(seed, n_nodes=8, n_victims=400, n_jobs=12, n_new=4)
        live = np.flatnonzero(s["run_live"])
        c["job_queue"][2] = 0
        c["job_min"][2] = 4
        _move_rows(c, s, live[:300], 2)
        c["run_prio"][live] = np.arange(live.size) % 3
        kw.update(order_by_priority=False, m_chunk=4, p_chunk=8, k_chunk=4)
    elif case == "many_chunks":
        c, s, t = build_storm_sim(seed, n_nodes=16, n_victims=300, n_jobs=2100, n_new=1900,
                                  n_old=400)
        new = np.arange(2100, 4000)
        t["job_prio"][new] = np.where(new % 5 == 0, 3, 0)
        kw.update(job_key_order=("gang", "priority", "drf"), p_chunk=2, k_chunk=2)
    elif case == "few_active":
        c, s, t = build_storm_sim(seed, n_nodes=8, n_victims=120, n_jobs=12, n_new=3)
        kw.update(m_chunk=16)
    else:
        raise ValueError(f"unknown rounds edge case {case!r}")
    return c, s, t, kw


def build_reclaim_abort_sim():
    """Two nodes, one victim each in queue 0; the reclaimer (queue 1) asks
    2000m / 256Mi.  Node 0's victim has 1000m / 1Gi: valid (not below the
    request in every dimension) but not covering; node 1's 4000m / 1Gi
    covers.  The reference walks node 0 first and strands its eviction."""
    c, s = build_victim_sim(2, 2, 2, n_queues=2, seed=0)
    V = c["run_req"].shape[0]
    c["run_node"][:2] = [0, 1]
    c["run_job"][:2] = 1
    c["run_req"][:2] = [[1000, 1 << 30], [4000, 1 << 30]]
    c["job_queue"][:] = 0
    c["job_queue"][0] = 1
    s["run_live"][:] = np.arange(V) < 2
    used = np.zeros_like(s["used"])
    np.add.at(used, c["run_node"][:2], c["run_req"][:2])
    s["used"] = used
    s["idle"] = np.maximum(c["node_alloc"] - used, 0).astype(np.float32)
    s["job_alloc"][:] = 0
    s["job_alloc"][1] = c["run_req"][:2].sum(0)
    s["job_occupied"][:] = 0
    s["job_occupied"][1] = 2
    s["queue_alloc"][:] = 0
    s["queue_alloc"][0] = c["run_req"][:2].sum(0)
    s["task_count"][:2] = 1
    J = c["job_queue"].shape[0]
    T = 8
    task_req = np.zeros((T, 2), np.float32)
    task_req[0] = [2000, 256 << 20]
    counts = np.zeros(J, np.int32)
    counts[0] = 1
    return c, s, dict(task_req=task_req, task_class=np.zeros(T, np.int32),
                      job_start=np.zeros(J, np.int32), job_ntasks=counts,
                      job_prio=np.zeros(J, np.int32), pre=np.array([0]), nt=1, n_jobs=2)


#: the shapes the reclaim and preempt walks must get right on a
#: thread-block cluster and on node blocks (``build_walk_edge_args``)
WALK_EDGE_CASES = ("row_counts", "tied_keys", "none_covered", "unclean", "discard", "r4", "r8",
                   "scalar")
#: the walk edge cases' node row counts, nodes 0-5 (``row_counts``)
WALK_ROW_COUNTS = (0, 1, 31, 32, 33, 1100)


def _resum(c, s):
    """The state's node, job and queue sums again from the live rows, as
    ``build_victim_sim`` sums them."""
    live = s["run_live"]
    rows, req = c["run_node"][live], c["run_req"][live]
    N, R = c["node_alloc"].shape
    used = np.zeros((N, R), np.float32)
    np.add.at(used, rows, req)
    count = np.zeros(N, np.int32)
    np.add.at(count, rows, 1)
    job_alloc = np.zeros((s["job_alloc"].shape[0], R), np.float32)
    np.add.at(job_alloc, c["run_job"][live], req)
    occupied = np.zeros_like(s["job_occupied"])
    np.add.at(occupied, c["run_job"][live], 1)
    queue_alloc = np.zeros((s["queue_alloc"].shape[0], R), np.float32)
    np.add.at(queue_alloc, c["job_queue"][c["run_job"][live]], req)
    s.update(used=used, idle=np.maximum(c["node_alloc"] - used, 0.0).astype(np.float32),
             releasing=np.zeros((N, R), np.float32), task_count=count, job_alloc=job_alloc,
             job_occupied=occupied, queue_alloc=queue_alloc)


def _deserve(c, s, seed, n_queues=2):
    """``build_storm_sim``'s deserved shares from the queues' allocation:
    queue ``seed % n_queues`` below its share, the others above."""
    Q = s["queue_alloc"].shape[0]
    factor = np.where(np.arange(Q) == seed % n_queues, 1.5, 0.6)[:, None]
    c["queue_deserved"] = (s["queue_alloc"] * factor).astype(np.float32)


def _add_scalars(c, s, t, n, rng):
    """``n`` more scalar resources (0-2 devices a pod, 8 a node, 0-1 a
    preemptor task), as ``build_storm_sim(scalar=True)`` adds one."""
    live, valid = s["run_live"], c["node_valid"]
    V, T = c["run_req"].shape[0], t["task_req"].shape[0]
    for _ in range(n):
        c["run_req"] = np.concatenate(
            [c["run_req"], np.where(live, rng.integers(0, 3, V), 0).astype(np.float32)[:, None]], 1)
        c["node_alloc"] = np.concatenate(
            [c["node_alloc"], np.where(valid, 8.0, 0.0).astype(np.float32)[:, None]], 1)
        c["eps"] = np.append(c["eps"], np.float32(10.0))
        col = np.where(np.arange(T) < t["nt"], rng.integers(0, 2, T), 0).astype(np.float32)
        t["task_req"] = np.concatenate([t["task_req"], col[:, None]], 1)
    c["total"] = c["node_alloc"].sum(0).astype(np.float32)


def build_walk_edge_args(case: str, kind: str = "preempt", seed: int = 0):
    """``(consts, state, tasks, opts)``: a ``build_storm_sim`` scenario
    reshaped into one edge shape of the reclaim or preempt walk (``kind``),
    and that solve's options (``storm_inputs(kind, ...)`` gives its
    arguments):

    * ``row_counts``: nodes of 0, 1, 31, 32, 33 and 1,100 rows
      (``WALK_ROW_COUNTS``, the last node's capacity 80 nodes'), the rest
      over six more nodes: a node longer than a CTA's lanes, ranges of a
      cluster that hold no node; one preemptor that only the long node
      covers, with dozens of victims;
    * ``tied_keys``: 64 equal nodes of four equal rows, so every covering
      node has the same walk key (preempt's score) and nodes in every CTA
      of a cluster tie;
    * ``none_covered``: every preemptor asks more than any node holds in
      every resource: no node is valid, the walk stays clean;
    * ``unclean``: ``build_reclaim_abort_sim`` without the vetoes (for
      preempt the preemptor in its victims' queue): the first node of the
      walk is valid but does not cover, and the walk aborts;
    * ``discard``: a fresh gang whose first task is small and its others
      cover nowhere: its statement takes victims, then is discarded and the
      journal replayed (preempt);
    * ``r4`` / ``r8``: two or six scalar resources beside cpu and memory;
    * ``scalar``: ``build_storm_sim(scalar=True, classes=3)``.
    """
    if kind == "reclaim":
        kw = dict(use_gang=True, use_prop=True, use_conformance=True, order_by_priority=True,
                  has_proportion=True)
    elif kind == "preempt":
        kw = dict(use_gang=True, use_drf=True, use_conformance=True, order_by_priority=True)
    else:
        raise ValueError(f"unknown walk kind {kind!r}")
    rng = np.random.default_rng(seed + 2000)
    if case == "row_counts":
        c, s, t = build_storm_sim(seed, n_nodes=12, n_victims=1260, n_jobs=12)
        live = np.flatnonzero(s["run_live"])
        node = np.repeat(np.arange(len(WALK_ROW_COUNTS)), WALK_ROW_COUNTS)
        rest = live.size - node.size
        c["run_node"][live] = np.concatenate([node, 6 + np.arange(rest) % 6])
        c["node_alloc"][5] *= 80
        c["total"] = c["node_alloc"].sum(0).astype(np.float32)
        _resum(c, s)
        _deserve(c, s, seed)
        # the first fresh gang's head task fits only the long node, whose
        # eviction prefix then holds dozens of victims
        t["task_req"][t["job_start"][12]] = [20000.0, float(40 << 30)]
    elif case == "tied_keys":
        c, s, t = build_storm_sim(seed, n_nodes=64, n_victims=256, n_jobs=12)
        live = np.flatnonzero(s["run_live"])
        c["run_req"][live] = [500.0, float(512 << 20)]
        c["run_node"][live] = np.arange(live.size) % 64
        _resum(c, s)
        _deserve(c, s, seed)
    elif case == "none_covered":
        c, s, t = build_storm_sim(seed)
        t["task_req"][:t["nt"]] = [1e7, float(1 << 40)]
    elif case == "unclean":
        c, s, t = build_reclaim_abort_sim()
        kw.update(use_gang=False, use_conformance=False,
                  **({"use_prop": False} if kind == "reclaim" else {"use_drf": False}))
        if kind == "preempt":
            c["job_queue"][0] = 0
    elif case == "discard":
        c, s, t = build_storm_sim(seed, n_new=3)
        j = 12  # the first fresh gang (build_storm_sim's n_jobs)
        first, n = int(t["job_start"][j]), int(t["job_ntasks"][j])
        t["task_req"][first] = [250.0, float(256 << 20)]
        t["task_req"][first + 1:first + n] = [1e7, float(1 << 40)]
    elif case in ("r4", "r8"):
        c, s, t = build_storm_sim(seed)
        _add_scalars(c, s, t, int(case[1:]) - 2, rng)
        _resum(c, s)
        _deserve(c, s, seed)
    elif case == "scalar":
        c, s, t = build_storm_sim(seed, scalar=True, classes=3)
    else:
        raise ValueError(f"unknown walk edge case {case!r}")
    return c, s, t, kw


#: the pools the group build must get right on a thread-block cluster
#: (``build_group_edge_args``)
GROUP_EDGE_CASES = ("empty_nodes", "big_node", "nodes_65536", "clamp", "holes")


def build_group_edge_args(case: str, seed: int = 0):
    """(consts, state) numpy dicts of ``build_victim_sim`` whose pool
    stresses the group build (``victim_kernels.victim_groups``):

    * ``empty_nodes``: 512 rows on every fourth node of 64, the rest empty;
    * ``big_node``: 1,500 of 2,000 rows on node 7 (more rows than a CTA has
      threads), the rest over 31 other nodes;
    * ``nodes_65536``: 6,000 rows over 65,536 node rows, most of them
      empty (the node counts of one cluster's shared memory at their
      largest shape in the port);
    * ``clamp``: rows whose node lies below 0 or past the node planes,
      which the build clamps into [0, N) as K7 does;
    * ``holes``: a live mask with random holes and a run of dead rows.

    The state's sums are not recomputed: the build reads only the pool's
    node, job, priority and rank columns, the job queues and the mask."""
    rng = np.random.default_rng(700 + seed)
    if case == "empty_nodes":
        c, s = build_victim_sim(64, 512, 16, n_queues=3, seed=seed)
        c["run_node"][:512] = rng.choice(np.arange(0, 64, 4), 512)
    elif case == "big_node":
        c, s = build_victim_sim(32, 2_000, 16, n_queues=3, seed=seed)
        others = np.setdiff1d(np.arange(32), [7])
        c["run_node"][:2_000] = rng.choice(others, 2_000)
        c["run_node"][rng.permutation(2_000)[:1_500]] = 7
    elif case == "nodes_65536":
        c, s = build_victim_sim(65_536, 6_000, 64, n_queues=4, seed=seed)
    elif case == "clamp":
        c, s = build_victim_sim(16, 200, 8, n_queues=3, seed=seed)
        out = rng.permutation(200)[:40]
        c["run_node"][out[:20]] = rng.integers(-5, 0, 20)
        c["run_node"][out[20:]] = rng.integers(16, 40, 20)
    elif case == "holes":
        c, s = build_victim_sim(24, 400, 12, n_queues=3, seed=seed)
        s["run_live"][rng.random(s["run_live"].shape[0]) < 0.3] = False
        s["run_live"][100:150] = False
    else:
        raise ValueError(f"unknown group edge case {case!r}")
    return c, s


#: K1's shapes (``build_water_fill_args``): the config-5 cell's, 128
#: queues, 2,048 (queue, dim) cells, and 1,024 queues that take 21 rounds
WATER_FILL_CASES = ("config5", "queues_128", "cells_2048", "staggered_1024",
                    "staggered_4096", "staggered_8192")
#: the staggered cases' (queues, dims): above 1,024 queues K1 sums in two
#: levels of windows, and 8,192 cells is its cap
_STAGGERED = {"staggered_1024": (1_024, 2), "staggered_4096": (4_096, 2),
              "staggered_8192": (8_192, 1)}
_WATER_FILL_KEYS = ("queue_weight", "queue_request", "total", "eps", "queue_participates")


def build_water_fill_args(case: str) -> dict:
    """K1's five inputs (``queue_weight``, ``queue_request``, ``total``,
    ``eps``, ``queue_participates``) as numpy arrays: ``config5`` is
    ``build_sim_args(10,000, 100,000, 5,000)``'s, ``queues_128``
    ``build_sim_args(10,000, 4,000, 200, n_queues=128, seed=5)``'s,
    ``cells_2048`` ``build_sim_args(1,000, 4,000, 2,000, n_queues=600,
    seed=6)``'s (1,024 queue rows x 2 dims), and ``staggered_1024`` 1,024
    queues of weight 0.95**q whose requests cycle through 1-16 x (250
    millicores, 256 MiB), sharing 95% of their sum: the fill caps a few
    queues a round and takes 21 rounds.  ``staggered_4096`` (4,096 queues x
    2 dims) and ``staggered_8192`` (8,192 x the millicores alone) repeat
    that pattern every 1,024 queues, up to K1's cap of 8,192 cells."""
    if case == "config5":
        a = build_sim_args(10_000, 100_000, 5_000)
    elif case == "queues_128":
        a = build_sim_args(10_000, 4_000, 200, n_queues=128, seed=5)
    elif case == "cells_2048":
        a = build_sim_args(1_000, 4_000, 2_000, n_queues=600, seed=6)
    elif case in _STAGGERED:
        n, dims = _STAGGERED[case]
        q = np.arange(n)
        steps = (1 + q % 16).astype(np.float32)
        req = np.stack([250.0 * steps, steps * float(1 << 28)], 1)[:, :dims].astype(np.float32)
        return dict(queue_weight=(0.95 ** (q % 1_024)).astype(np.float32), queue_request=req,
                    total=(req.sum(0) * 0.95).astype(np.float32),
                    eps=np.array([10.0, 10 * 1024 * 1024], np.float32)[:dims],
                    queue_participates=np.ones(n, bool))
    else:
        raise ValueError(f"unknown water fill case {case!r}")
    return {k: a[k] for k in _WATER_FILL_KEYS}
