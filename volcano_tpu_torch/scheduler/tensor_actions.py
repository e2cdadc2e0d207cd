"""Allocate-solve dispatch with ONE device -> host fetch.

The port's cut of ``volcano_tpu/scheduler/tensor_actions.py:448-604``:
pick the exact or the batched solve, upload the snapshot, and let the
solve write its four decision outputs into one int32 [3T + J] array (the
layout of the JAX ``_packed_solve`` wrapper), which is the only thing the
host copies back.
"""

from __future__ import annotations

import numpy as np
import torch

from volcano_tpu_torch.scheduler.kernels import (
    allocate_solve, allocate_solve_batch, pack_outputs,
)


def use_batch_solve(backend, n_pending: int) -> bool:
    return backend.solve_mode == "batch" or (
        backend.solve_mode == "auto" and n_pending > backend.batch_threshold
    )


def torch_allocate_solve(backend, snap, n_pending=None):
    """Run the allocate solve for ``snap``; returns numpy (task_node,
    task_kind, task_seq, ready)."""
    if n_pending is None:
        n_pending = int(snap.task_valid.sum())
    solve = allocate_solve_batch if use_batch_solve(backend, n_pending) else allocate_solve
    w_least, w_balanced = backend.score_weights()
    dev = backend.to_device
    out = solve(
        dev(snap.node_idle), dev(snap.node_releasing), dev(snap.node_used),
        dev(snap.node_alloc), dev(snap.node_max_tasks), dev(snap.node_task_count),
        dev(snap.node_valid),
        dev(snap.task_req), dev(snap.task_job), dev(snap.task_class), dev(snap.task_valid),
        dev(snap.job_queue), dev(snap.job_min_available), dev(snap.job_priority),
        dev(snap.job_ready_init), dev(snap.job_alloc_init), dev(snap.job_schedulable),
        dev(snap.job_start), dev(snap.job_ntasks),
        dev(snap.queue_alloc_init), backend.deserved(),
        dev(snap.class_node_mask), dev(snap.class_node_score),
        dev(snap.total), dev(snap.eps),
        w_least, w_balanced,
        job_key_order=backend.job_key_order,
        use_gang_ready=backend.gang_job_ready,
        use_proportion=backend.proportion_queue_order,
    )
    # the one fetch boundary: wait for the device, copy the packed array
    packed = pack_outputs(out)
    if packed.device.type == "cuda":
        torch.cuda.synchronize(packed.device)
    flat = packed.cpu().numpy()
    T = snap.task_req.shape[0]
    J = snap.job_queue.shape[0]
    return (
        flat[:T], flat[T:2 * T], flat[2 * T:3 * T],
        np.ascontiguousarray(flat[3 * T:3 * T + J]),
    )
