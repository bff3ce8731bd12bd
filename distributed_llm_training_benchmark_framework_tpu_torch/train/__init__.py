from .loop import run_benchmark
from .step import TrainStep

__all__ = ["TrainStep", "run_benchmark"]
