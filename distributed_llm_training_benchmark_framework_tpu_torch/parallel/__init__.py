from .strategies import STRATEGIES, Optimizer, StrategyConfig, get_strategy, make_optimizer

__all__ = ["STRATEGIES", "Optimizer", "StrategyConfig", "get_strategy", "make_optimizer"]
