"""Action registry bootstrap: importing this package registers the five
built-in actions."""

from volcano_tpu_torch.scheduler.framework import register_action
from volcano_tpu_torch.scheduler.actions import allocate, backfill, enqueue, preempt, reclaim

register_action(enqueue.EnqueueAction())
register_action(allocate.AllocateAction())
register_action(backfill.BackfillAction())
register_action(preempt.PreemptAction())
register_action(reclaim.ReclaimAction())
