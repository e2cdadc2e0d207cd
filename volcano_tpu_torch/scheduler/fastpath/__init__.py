from volcano_tpu_torch.scheduler.fastpath.cycle import FastCycle
from volcano_tpu_torch.scheduler.fastpath.mirror import ArrayMirror
from volcano_tpu_torch.scheduler.fastpath.snapshot_build import build_fast_snapshot

__all__ = ["ArrayMirror", "FastCycle", "build_fast_snapshot"]
