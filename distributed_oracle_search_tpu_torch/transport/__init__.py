from .wire import RuntimeConfig, StatsRow

__all__ = ["RuntimeConfig", "StatsRow"]
