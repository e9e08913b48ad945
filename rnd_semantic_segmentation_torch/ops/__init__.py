from .pool import max_pool
from .resize import resize_bilinear

__all__ = ["max_pool", "resize_bilinear"]
