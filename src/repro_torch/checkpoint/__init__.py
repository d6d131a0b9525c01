from repro_torch.checkpoint.ckpt import (
    AsyncCheckpointer,
    gc_keep_k,
    latest_step,
    restore,
    save,
)

__all__ = ["save", "restore", "latest_step", "gc_keep_k", "AsyncCheckpointer"]
