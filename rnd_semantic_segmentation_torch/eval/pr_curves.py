"""Per-class precision-recall curves (counterpart of the JAX package's
eval/pr_curves.py): pure numpy, a threshold sweep, written as JSON and
drawn as a figure (``utils/plots.py``, Pillow).  As in the JAX package the
figure is best effort: a failure to draw it is passed over, the JSON is
always written."""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np


def pr_curve(predictions: np.ndarray, labels: np.ndarray,
             num_thresholds: int = 127) -> Dict[str, list]:
    """predictions: [N] probabilities; labels: [N] {0,1}.

    Returns thresholds, precision and recall, with the thresholds evenly
    spaced in [0, 1] (TensorBoard's convention)."""
    thresholds = np.linspace(0.0, 1.0, num_thresholds)
    labels = labels.astype(bool)
    pos = labels.sum()
    precision, recall = [], []
    order = np.argsort(-predictions)
    sorted_labels = labels[order]
    sorted_preds = predictions[order]
    tp_cum = np.cumsum(sorted_labels)
    for t in thresholds:
        k = np.searchsorted(-sorted_preds, -t, side="right")
        tp = tp_cum[k - 1] if k > 0 else 0
        precision.append(float(tp / max(k, 1)))
        recall.append(float(tp / max(pos, 1)))
    return {"thresholds": thresholds.tolist(),
            "precision": precision, "recall": recall}


def dump_pr_curves(pred: np.ndarray, label: np.ndarray, id2name: Dict, out_dir: str,
                   writer=None, plot: bool = True) -> Dict[str, Dict]:
    """pred: [N, C] per-class probabilities; label: [N] class ids.  Writes
    ``pr_curves.json`` (and ``pr_curves.png``) to ``out_dir``; a ``writer``
    with ``add_pr_curve`` also gets each class's curve."""
    os.makedirs(out_dir, exist_ok=True)
    curves = {}
    for cls in range(pred.shape[1]):
        name = id2name.get(str(cls), id2name.get(cls, str(cls)))
        binary = (label == cls).astype(np.int32)
        if writer is not None:
            writer.add_pr_curve(name, binary, pred[:, cls], cls)
        curves[name] = pr_curve(pred[:, cls], binary)

    with open(os.path.join(out_dir, "pr_curves.json"), "w") as fh:
        json.dump(curves, fh)

    if plot:
        try:
            from ..utils.plots import line_plot

            line_plot([(c["recall"], c["precision"], name) for name, c in curves.items()],
                      xlabel="recall", ylabel="precision", size=(600, 500)).save(
                os.path.join(out_dir, "pr_curves.png"))
        except Exception:
            pass
    return curves
