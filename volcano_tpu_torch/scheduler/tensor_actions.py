"""Allocate-solve dispatch with ONE device -> host fetch.

The port's cut of ``volcano_tpu/scheduler/tensor_actions.py:448-764``:
pick the exact or the batched solve, upload the snapshot, and let the
solve write its four decision outputs into one int32 [3T + J] array (the
layout of the JAX ``_packed_solve`` wrapper), which is the only thing the
host copies back.  The dynamic solve (host ports, pod (anti)affinity,
volumes) runs the same kernels with the ``portsel`` extension over the
dyn-expr jobs' tasks, and with the ``volsel`` extension when a task carries
volume state, which forces the exact solve; the bitsets go up packed and
are tested in place by the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from volcano_tpu_torch.scheduler.kernels import (
    allocate_solve, allocate_solve_batch, pack_outputs, pack_volsel,
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
    return _fetch(out, snap.task_req.shape[0], snap.job_queue.shape[0])


def _fetch(out, T, J):
    """The one fetch boundary: wait for the device, copy the packed array."""
    packed = pack_outputs(out)
    if packed.device.type == "cuda":
        torch.cuda.synchronize(packed.device)
    flat = packed.cpu().numpy()
    return (
        flat[:T], flat[T:2 * T], flat[2 * T:3 * T],
        np.ascontiguousarray(flat[3 * T:3 * T + J]),
    )


def dyn_solve_args(backend, snap, dyn, n_pending=None):
    """(solve, positional args, keyword args) of the dynamic solve for the
    dyn inputs ``dyn`` (``build_dyn_solve_inputs``), on the device: the
    same exact-or-batch rule as the express solve, except that volume state
    (``dyn["volsel"]``) is ordered and always takes the exact solve; the u32
    words go up as int32 (bit-identical), the u16 selector counts as int32."""
    if n_pending is None:
        n_pending = int(dyn["task_valid"].sum())
    has_vol = dyn.get("volsel") is not None
    use_batch = not has_vol and use_batch_solve(backend, n_pending)
    solve = allocate_solve_batch if use_batch else allocate_solve
    w_least, w_balanced = backend.score_weights()
    dev = backend.to_device

    def words(name):
        return dev(dyn[name].view(np.int32))

    portsel = (
        words("node_ports_w"), words("task_ports_w"),
        dev(dyn["node_selcnt"].astype(np.int32)),
        words("task_aff_w"), words("task_anti_w"), words("task_self_w"),
        backend.podaffinity_weight(),
    )
    args = (
        dev(dyn["node_idle"]), dev(dyn["node_releasing"]), dev(dyn["node_used"]),
        dev(snap.node_alloc), dev(snap.node_max_tasks), dev(dyn["node_task_count"]),
        dev(snap.node_valid),
        dev(dyn["task_req"]), dev(dyn["task_job"]), dev(dyn["task_class"]),
        dev(dyn["task_valid"]),
        dev(snap.job_queue), dev(snap.job_min_available), dev(snap.job_priority),
        dev(dyn["job_ready_init"]), dev(dyn["job_alloc_init"]),
        dev(dyn["job_schedulable"]), dev(dyn["job_start"]), dev(dyn["job_ntasks"]),
        dev(dyn["queue_alloc_init"]), backend.deserved(),
        dev(dyn["class_mask"]), dev(dyn["class_score"]),
        dev(snap.total), dev(snap.eps),
        w_least, w_balanced,
    )
    kwargs = dict(
        job_key_order=backend.job_key_order,
        use_gang_ready=backend.gang_job_ready,
        use_proportion=backend.proportion_queue_order,
        portsel=portsel,
    )
    if has_vol:
        kwargs["volsel"] = tuple(dev(x) for x in pack_volsel(dyn["volsel"]))
    return solve, args, kwargs


def torch_dynamic_solve(backend, snap, dyn, n_pending=None):
    """Run the dynamic solve; returns numpy (task_node, task_kind,
    task_seq, ready) over the dyn task layout, in ONE packed fetch."""
    solve, args, kwargs = dyn_solve_args(backend, snap, dyn, n_pending)
    return _fetch(solve(*args, **kwargs), dyn["task_req"].shape[0], snap.job_queue.shape[0])
