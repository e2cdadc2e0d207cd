from volcano_tpu_torch.store.store import EventType, PreconditionFailed, Store

__all__ = ["EventType", "PreconditionFailed", "Store"]
