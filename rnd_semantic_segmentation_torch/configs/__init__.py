from .node import CfgNode, ConfigError
from .defaults import get_default_cfg

__all__ = ["CfgNode", "ConfigError", "get_default_cfg"]
