from .device import resolve_device
from .io import load_json
from .logging import setup_logger

__all__ = ["load_json", "resolve_device", "setup_logger"]
