from .mesh import AXES, Mesh, MeshAxes, make_mesh
from .strategies import STRATEGIES, Optimizer, StrategyConfig, get_strategy, make_optimizer

__all__ = [
    "AXES", "Mesh", "MeshAxes", "STRATEGIES", "Optimizer", "StrategyConfig", "get_strategy",
    "make_mesh", "make_optimizer",
]
