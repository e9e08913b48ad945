"""Training meters: a windowed median and average with a global average
(counterpart of the JAX package's utils/meters.py)."""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict

import numpy as np


class SmoothedValue:
    """Windowed median/avg + global average."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.series = []
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        value = float(value)
        self.deque.append(value)
        self.series.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self) -> float:
        return float(np.median(list(self.deque)))

    @property
    def avg(self) -> float:
        return float(np.mean(list(self.deque)))

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter: str = "\t"):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in ("meters", "delimiter"):
            raise AttributeError(attr)
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items())
