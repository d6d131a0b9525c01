from repro_torch.runtime.driver import (
    StragglerMonitor,
    TrainDriver,
    fit_parallel_to_devices,
)

__all__ = ["TrainDriver", "StragglerMonitor", "fit_parallel_to_devices"]
