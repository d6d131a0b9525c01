from repro_torch.data.pipeline import (
    DataLoader,
    MemmapDataset,
    ProducerError,
    SyntheticDataset,
)

__all__ = ["DataLoader", "MemmapDataset", "ProducerError", "SyntheticDataset"]
