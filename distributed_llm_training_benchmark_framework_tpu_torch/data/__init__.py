from .synthetic import SyntheticDataset, step_batch

__all__ = ["SyntheticDataset", "step_batch"]
