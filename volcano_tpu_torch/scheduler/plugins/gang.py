"""Gang plugin: all-or-nothing co-scheduling on min_available (the port's
copy of ``volcano_tpu/scheduler/plugins/gang.py``): at session close an
unready job gets the Unschedulable condition, a Warning Event on the
condition's transitions only, and its unschedule and retry metrics.
"""

from __future__ import annotations

from volcano_tpu_torch import events
from volcano_tpu_torch.api.objects import PodGroupCondition
from volcano_tpu_torch.scheduler import metrics
from volcano_tpu_torch.scheduler.framework import Plugin
from volcano_tpu_torch.scheduler.session import Session, ValidateResult

NOT_ENOUGH_PODS = "NotEnoughPods"
NOT_ENOUGH_RESOURCES = "NotEnoughResources"


class GangPlugin(Plugin):
    name = "gang"

    def on_session_open(self, ssn: Session) -> None:
        def valid_job_fn(job):
            vtn = job.valid_task_num()
            if vtn < job.min_available:
                return ValidateResult(
                    passed=False,
                    reason=NOT_ENOUGH_PODS,
                    message=(
                        f"Not enough valid tasks for gang-scheduling, "
                        f"valid: {vtn}, min: {job.min_available}"
                    ),
                )
            return None

        ssn.add_job_valid_fn(self.name, valid_job_fn)

        def preemptable_fn(preemptor, preemptees):
            victims = []
            for preemptee in preemptees:
                job = ssn.jobs[preemptee.job_uid]
                occupied = job.ready_task_num()
                # victim allowed only if its job would stay at/above gang size
                if job.min_available <= occupied - 1 or job.min_available == 1:
                    victims.append(preemptee)
            return victims

        ssn.add_preemptable_fn(self.name, preemptable_fn)
        ssn.add_reclaimable_fn(self.name, preemptable_fn)

        def job_order_fn(l, r):
            l_ready, r_ready = l.ready(), r.ready()
            if l_ready and r_ready:
                return 0
            if l_ready:
                return 1
            if r_ready:
                return -1
            return 0

        ssn.add_job_order_fn(self.name, job_order_fn)
        ssn.add_job_ready_fn(self.name, lambda job: job.ready())
        ssn.add_job_pipelined_fn(self.name, lambda job: job.pipelined())

    def on_session_close(self, ssn: Session) -> None:
        unschedulable_jobs = 0
        for job in ssn.jobs.values():
            if job.ready():
                # clear a stale Unschedulable condition so the next failure
                # episode is a fresh transition
                if job.pod_group is not None and any(
                    c.kind == "Unschedulable"
                    for c in job.pod_group.status.conditions
                ):
                    job.pod_group.status.conditions = [
                        c
                        for c in job.pod_group.status.conditions
                        if c.kind != "Unschedulable"
                    ]
            else:
                unready = job.min_available - job.ready_task_num()
                unschedulable_jobs += 1
                metrics.update_unschedule_task_count(job.name, int(unready))
                metrics.register_job_retry(job.name)
                if job.pod_group is not None:
                    # gang.go:138-139 appends FitError(); "" means the cycle
                    # produced no fit data (quota-blocked job) — append
                    # nothing rather than a misleading "0 nodes" claim
                    fe = job.fit_error()
                    cond = PodGroupCondition(
                        kind="Unschedulable",
                        status="True",
                        reason=NOT_ENOUGH_RESOURCES,
                        message=(
                            f"{unready}/{len(job.tasks)} tasks in gang "
                            f"unschedulable" + (f": {fe}" if fe else "")
                        ),
                    )
                    prev = next((c for c in job.pod_group.status.conditions
                                 if c.kind == "Unschedulable"), None)
                    job.pod_group.status.conditions = [
                        c
                        for c in job.pod_group.status.conditions
                        if c.kind != "Unschedulable"
                    ] + [cond]
                    # the unschedulable Warning Event (cache.go:467) on
                    # condition transitions only, so that a parked gang
                    # writes nothing on idle cycles
                    if prev is None or prev.message != cond.message:
                        events.record(ssn.cache.store, "PodGroup",
                                      f"{job.namespace}/{job.name}", "Unschedulable",
                                      cond.message, type=events.WARNING)
        metrics.update_unschedule_job_count(unschedulable_jobs)
