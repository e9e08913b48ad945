from .device import resolve_device
from .io import dump_json, load_json
from .logging import setup_logger
from .meters import MetricLogger, SmoothedValue

__all__ = ["MetricLogger", "SmoothedValue", "dump_json", "load_json",
           "resolve_device", "setup_logger"]
