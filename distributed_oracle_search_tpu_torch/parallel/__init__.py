from .partition import DistributionController, parse_conf

__all__ = ["DistributionController", "parse_conf"]
