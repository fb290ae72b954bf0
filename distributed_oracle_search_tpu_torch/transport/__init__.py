from .wire import STATS_HEADER, RuntimeConfig, StatsRow

__all__ = ["RuntimeConfig", "STATS_HEADER", "StatsRow"]
