from .log import get_logger, set_verbosity

__all__ = ["get_logger", "set_verbosity"]
