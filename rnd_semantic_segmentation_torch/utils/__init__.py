from .device import resolve_device
from .io import dump_json, load_json, load_text
from .logging import setup_logger
from .meters import MetricLogger, SmoothedValue

__all__ = ["MetricLogger", "SmoothedValue", "dump_json", "load_json", "load_text",
           "resolve_device", "setup_logger"]
