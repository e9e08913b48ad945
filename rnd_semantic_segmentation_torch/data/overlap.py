"""Host-pipeline overlap model (counterpart of the JAX package's
data/overlap.py).

``measure_overlap`` answers "would the device wait for its input?" by driving
a real loader (decode, augmentation, collate: what ``build_dataset`` and
``DataLoader`` assemble) against a consumer paced at a device rate in images
per second, and accounting each second of the wall clock to the device's
work or to the wait for data.  The trainers log the same wait as their
``data`` meter, so the two numbers compare.
"""

from __future__ import annotations

import time
from typing import Dict, Optional


def measure_overlap(loader, device_rate_img_per_sec: float,
                    max_batches: Optional[int] = None,
                    warmup_batches: int = 1) -> Dict:
    """Runs ``loader`` against an emulated device that takes
    ``batch / device_rate_img_per_sec`` seconds a batch, by sleeping, which
    releases the interpreter lock as a step waiting on the card does.  The
    first ``warmup_batches`` batches (the pipeline's ramp) are left out of
    the accounting.

    Returns the wall, data-wait and device-busy seconds, the images per
    second achieved, ``device_idle_fraction`` (wait over wall) and
    ``input_bound`` (that fraction above 5%)."""
    it = iter(loader)
    idle = busy = 0.0
    n_img = n_batch = 0
    wall0 = time.perf_counter()
    while max_batches is None or n_batch < max_batches:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            break
        waited = time.perf_counter() - t0
        bs = int(next(v.shape[0] for v in batch.values() if hasattr(v, "shape")))
        n_batch += 1
        if n_batch > warmup_batches:
            idle += waited
            n_img += bs
        step = bs / device_rate_img_per_sec
        time.sleep(step)
        if n_batch > warmup_batches:
            busy += step
        else:
            wall0 = time.perf_counter()  # the steady state starts after the ramp
    wall = time.perf_counter() - wall0
    frac = idle / wall if wall > 0 else 0.0
    return {
        "device_rate_img_per_sec": round(device_rate_img_per_sec, 2),
        "batches": n_batch,
        "wall_s": round(wall, 3),
        "data_wait_s": round(idle, 3),
        "device_busy_s": round(busy, 3),
        "achieved_img_per_sec": round(n_img / wall, 2) if wall > 0 else 0.0,
        "device_idle_fraction": round(frac, 4),
        "input_bound": bool(frac > 0.05),
    }


def stage_times(dataset, transform_tag: str, n: int = 16) -> Dict:
    """ms an item of a whole ``__getitem__`` (decode and augmentation) over
    the first ``n`` items."""
    n = min(n, len(dataset))
    t0 = time.perf_counter()
    for i in range(n):
        dataset[i]
    dt = time.perf_counter() - t0
    return {"pipeline": transform_tag, "getitem_ms_per_item": round(1000 * dt / n, 2)}
