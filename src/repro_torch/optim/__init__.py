from repro_torch.optim.adamw import adamw_init, adamw_update, clip_by_global_norm
from repro_torch.optim.compress import compress_grads_int8, decompress_grads_int8
from repro_torch.optim.schedule import cosine_warmup

__all__ = [
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_warmup",
    "compress_grads_int8",
    "decompress_grads_int8",
]
