"""Simulated solve arguments for benches, the chip smoke run, and tests.

``build_sim_args`` is copied verbatim from ``volcano_tpu/scheduler/
simargs.py``: the dense argument set of the allocate solves for a synthetic
cluster — N nodes with mixed cpu/mem capacity, T pending tasks grouped into
J gang jobs across Q weighted queues — plus the water-fill inputs.
"""

from __future__ import annotations

import numpy as np

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
