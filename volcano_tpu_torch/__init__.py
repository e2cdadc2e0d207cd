"""volcano_tpu_torch: the PyTorch + CUDA port of volcano_tpu's fast
scheduling cycle (enqueue, reclaim, allocate, backfill, preempt), with
hand-written Hopper kernels.

Entry point: ``volcano_tpu_torch.scheduler.scheduler.Scheduler``.  It runs
on the card (``backend="cuda"``, the default) unless the caller asks for
the CPU (``backend="cpu"``); without a card, ``"cuda"`` raises.
"""
