"""Backfill action: place BestEffort (empty-request) tasks on any node
passing predicates, with no scoring (the port's copy of
``volcano_tpu/scheduler/actions/backfill.py``).  A task that finds no
node records a Warning Event on its gang, once for a given message.
"""

from __future__ import annotations

from volcano_tpu_torch import events
from volcano_tpu_torch.api.types import PodGroupPhase, TaskStatus
from volcano_tpu_torch.scheduler import util
from volcano_tpu_torch.scheduler.cache import VolumeBindingError
from volcano_tpu_torch.scheduler.framework import Action
from volcano_tpu_torch.scheduler.model import render_fit_error
from volcano_tpu_torch.scheduler.session import Session


class BackfillAction(Action):
    name = "backfill"

    def execute(self, ssn: Session, job_filter=None) -> None:
        # ``job_filter`` restricts the pass to a job subset: the residue
        # jobs of the fast cycle (scheduler.run_object_residue)
        all_nodes = util.get_node_list(ssn.nodes)
        for job in list(ssn.jobs.values()):
            if job_filter is not None and not job_filter(job):
                continue
            if (
                job.pod_group is not None
                and job.pod_group.status.phase == PodGroupPhase.PENDING
            ):
                continue
            for task in list(
                job.task_status_index.get(TaskStatus.PENDING, {}).values()
            ):
                if not task.init_resreq.is_empty():
                    continue
                reasons: dict = {}
                placed = False
                feasible = util.predicate_nodes(
                    task, all_nodes, ssn.predicate_fn, reasons
                )
                for node in feasible:
                    try:
                        ssn.allocate(task, node.name)
                    except VolumeBindingError:
                        reasons["volume binding failed"] = (
                            reasons.get("volume binding failed", 0) + 1
                        )
                        continue  # try the next node
                    placed = True
                    break
                if not placed:
                    # surface the aggregated reasons, keeping allocate's
                    # head-task histogram if it recorded one (that is what
                    # blocks the gang), and record a Warning Event for the
                    # task once, so that a parked task lets the cluster
                    # quiesce
                    if (
                        not job.fit_errors
                        and not job.nodes_fit_delta
                        and job.fit_error_fn is None
                    ):
                        job.fit_errors = reasons
                        job.fit_total_nodes = len(all_nodes)
                    msg = (render_fit_error(len(all_nodes), reasons)
                           if reasons else "0 nodes are available")
                    events.record_once(
                        ssn.cache.store, "PodGroup", f"{job.namespace}/{job.name}",
                        "Unschedulable", f"task {task.key} unschedulable: {msg}",
                        type=events.WARNING)
