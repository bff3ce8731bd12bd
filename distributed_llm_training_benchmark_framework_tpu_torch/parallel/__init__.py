from .mesh import AXES, Mesh, MeshAxes, make_mesh, mesh_axes_dict
from .offload import HostOffload
from .strategies import (
    STRATEGIES,
    Optimizer,
    StrategyConfig,
    apply_strategy,
    check_ported,
    from_deepspeed_config,
    get_strategy,
    is_deepspeed_config,
    load_strategy_config,
    make_optimizer,
)

__all__ = [
    "AXES", "HostOffload", "Mesh", "MeshAxes", "STRATEGIES", "Optimizer", "StrategyConfig",
    "apply_strategy", "check_ported", "from_deepspeed_config", "get_strategy",
    "is_deepspeed_config", "load_strategy_config", "make_mesh", "make_optimizer",
    "mesh_axes_dict",
]
