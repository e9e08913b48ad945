"""Small JSON helpers (counterpart of the JAX package's utils/io.py)."""

from __future__ import annotations

import json
from typing import Any


def load_json(path: str) -> Any:
    with open(path) as fh:
        return json.load(fh)
