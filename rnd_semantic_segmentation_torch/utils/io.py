"""Small JSON helpers (counterpart of the JAX package's utils/io.py)."""

from __future__ import annotations

import json
import os
from typing import Any, List


def load_json(path: str) -> Any:
    with open(path) as fh:
        return json.load(fh)


def load_text(path: str) -> List[str]:
    with open(path) as fh:
        return [line.rstrip() for line in fh]


def dump_json(path: str, data: Any) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(data, fh)
