from .mesh import AXES, Mesh, MeshAxes, make_mesh, mesh_axes_dict
from .strategies import (
    STRATEGIES,
    Optimizer,
    StrategyConfig,
    apply_strategy,
    check_ported,
    get_strategy,
    make_optimizer,
)

__all__ = [
    "AXES", "Mesh", "MeshAxes", "STRATEGIES", "Optimizer", "StrategyConfig", "apply_strategy",
    "check_ported", "get_strategy", "make_mesh", "make_optimizer", "mesh_axes_dict",
]
