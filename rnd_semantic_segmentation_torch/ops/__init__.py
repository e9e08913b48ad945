from .pool import avg_pool, max_pool
from .resize import resize_bilinear, scaled_size

__all__ = ["avg_pool", "max_pool", "resize_bilinear", "scaled_size"]
