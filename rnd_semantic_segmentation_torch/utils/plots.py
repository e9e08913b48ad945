"""Plots and mask helpers (counterpart of the JAX package's utils/plots.py).

``threshold_mask`` and ``preds2ignorepreds`` are the JAX functions.  The
figures (``plot_confusion_matrix``'s heat map, ``LineChartPlotter``'s curves,
``line_plot`` and ``image_grid``, which the PR curves, ``cli.visualize`` and
``cli.demo`` draw with) are drawn with Pillow and numpy: the port does not
depend on matplotlib, which the JAX package draws with, so it draws the same
content its own way.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

# matplotlib's "Reds" at 0, 1/4, 1/2, 3/4 and 1, interpolated linearly between
_REDS = np.array([(255, 245, 240), (252, 187, 161), (251, 106, 74), (203, 24, 29),
                  (103, 0, 13)], np.float64)
# line colours, matplotlib's default cycle
_CYCLE = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189),
          (140, 86, 75), (227, 119, 194), (127, 127, 127), (188, 189, 34), (23, 190, 207))
_FONT = None


def _font():
    global _FONT
    if _FONT is None:
        _FONT = ImageFont.load_default()
    return _FONT


def _text_size(draw: ImageDraw.ImageDraw, text: str) -> Tuple[int, int]:
    x0, y0, x1, y1 = draw.textbbox((0, 0), text, font=_font())
    return x1 - x0, y1 - y0


def _save(image: Image.Image, out_path: str) -> str:
    parent = os.path.dirname(out_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    image.save(out_path)
    return out_path


def threshold_mask(x: np.ndarray, threshold: float = 128) -> np.ndarray:
    """1 where ``x >= threshold``, else 0 (int32)."""
    return (np.asarray(x) >= threshold).astype(np.int32)


def preds2ignorepreds(id_to_trainid: Dict, gt: np.ndarray, pd: np.ndarray,
                      ignore_label: int = 255):
    """Remaps ground-truth ids to train ids and carries the ignore label
    into the predictions."""
    gt = np.asarray(gt)
    label_copy = np.full(gt.shape, ignore_label, np.float32)
    for k, v in id_to_trainid.items():
        label_copy[gt == int(k)] = v
    pd = np.asarray(pd).copy()
    pd[label_copy == ignore_label] = ignore_label
    return label_copy, pd


def _reds(values: np.ndarray) -> np.ndarray:
    """Values in [0, 1] -> uint8 RGB of the "Reds" colour map."""
    v = np.clip(np.asarray(values, np.float64), 0.0, 1.0) * (len(_REDS) - 1)
    lo = np.minimum(np.floor(v).astype(int), len(_REDS) - 2)
    t = (v - lo)[..., None]
    return np.round(_REDS[lo] * (1 - t) + _REDS[lo + 1] * t).astype(np.uint8)


def plot_confusion_matrix(cm: np.ndarray, classes: Sequence[str], normalize: bool = True,
                          title: str = "Confusion matrix",
                          out_path: str = "confusion_matrix.png") -> str:
    """The heat map of ``cm`` (rows true, columns predicted; each row
    normalised to sum 1 when ``normalize``), class names on both axes, a
    colour bar; returns ``out_path``."""
    cm = np.asarray(cm, np.float64)
    if normalize:
        cm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1e-10)
    n = len(classes)
    cell = max(12, min(40, 600 // max(n, 1)))
    probe = ImageDraw.Draw(Image.new("RGB", (1, 1)))
    label_w = max([_text_size(probe, str(c))[0] for c in classes] + [10]) + 8
    line_h = _text_size(probe, "Ag")[1] + 6
    left, top = label_w + line_h, 2 * line_h
    size = n * cell
    bar_x = left + size + 16
    width, height = bar_x + 60, top + size + label_w + line_h
    image = Image.new("RGB", (width, height), "white")
    vmax = cm.max() if cm.size and cm.max() > 0 else 1.0
    cells = _reds(cm / vmax)
    image.paste(Image.fromarray(cells).resize((size, size), Image.NEAREST), (left, top))
    draw = ImageDraw.Draw(image)
    draw.text((left, 4), title, fill="black", font=_font())
    for i, name in enumerate(classes):
        w, h = _text_size(draw, str(name))
        draw.text((left - w - 4, top + i * cell + (cell - h) // 2), str(name), fill="black",
                  font=_font())
        tag = Image.new("RGBA", (w + 2, h + 4), (255, 255, 255, 0))
        ImageDraw.Draw(tag).text((0, 0), str(name), fill="black", font=_font())
        tag = tag.rotate(90, expand=True)
        image.paste(tag, (left + i * cell + (cell - tag.width) // 2, top + size + 4), tag)
    draw.text((4, top + size // 2), "True", fill="black", font=_font())
    draw.text((left + size // 2 - 20, height - line_h), "Predicted", fill="black", font=_font())
    bar = _reds(np.linspace(1.0, 0.0, size)[:, None].repeat(14, axis=1))
    image.paste(Image.fromarray(bar), (bar_x, top))
    draw.text((bar_x + 18, top), f"{vmax:.3g}", fill="black", font=_font())
    draw.text((bar_x + 18, top + size - line_h), "0", fill="black", font=_font())
    return _save(image, out_path)


def _ticks(lo: float, hi: float) -> List[float]:
    return [lo + (hi - lo) * i / 4 for i in range(5)]


def line_plot(series: Sequence[Tuple[Sequence[float], Sequence[float], str]],
              title: str = "", xlabel: str = "", ylabel: str = "",
              size: Tuple[int, int] = (640, 480), alphas: Optional[Sequence[float]] = None
              ) -> Image.Image:
    """Lines ``(xs, ys, label)`` on shared axes with five ticks each, a
    legend, a title and axis labels; ``alphas`` fades lines (1 = opaque)."""
    width, height = size
    image = Image.new("RGB", size, "white")
    draw = ImageDraw.Draw(image, "RGBA")
    line_h = _text_size(draw, "Ag")[1] + 6
    xs_all = [float(v) for xs, _, _ in series for v in xs]
    ys_all = [float(v) for _, ys, _ in series for v in ys if np.isfinite(v)]
    x0, x1 = (min(xs_all), max(xs_all)) if xs_all else (0.0, 1.0)
    y0, y1 = (min(ys_all), max(ys_all)) if ys_all else (0.0, 1.0)
    x1, y1 = (x1 if x1 > x0 else x0 + 1.0), (y1 if y1 > y0 else y0 + 1.0)
    left, right, top, bottom = 70, width - 16, 2 * line_h, height - 2 * line_h - 8
    px = lambda x: left + (x - x0) / (x1 - x0) * (right - left)
    py = lambda y: bottom - (y - y0) / (y1 - y0) * (bottom - top)
    draw.rectangle((left, top, right, bottom), outline="black")
    for t in _ticks(x0, x1):
        label = f"{t:.4g}"
        w, _ = _text_size(draw, label)
        draw.line((px(t), bottom, px(t), bottom + 4), fill="black")
        draw.text((px(t) - w / 2, bottom + 6), label, fill="black", font=_font())
    for t in _ticks(y0, y1):
        label = f"{t:.4g}"
        w, h = _text_size(draw, label)
        draw.line((left - 4, py(t), left, py(t)), fill="black")
        draw.text((left - w - 6, py(t) - h / 2), label, fill="black", font=_font())
    for i, (xs, ys, label) in enumerate(series):
        alpha = int(255 * (alphas[i] if alphas else 1.0))
        colour = _CYCLE[i % len(_CYCLE)] + (alpha,)
        points = [(px(float(x)), py(float(y))) for x, y in zip(xs, ys) if np.isfinite(y)]
        if len(points) > 1:
            draw.line(points, fill=colour, width=1)
        elif points:
            draw.point(points, fill=colour)
        draw.line((right - 150, top + 8 + i * line_h, right - 130, top + 8 + i * line_h),
                  fill=colour, width=2)
        draw.text((right - 126, top + 2 + i * line_h), label, fill="black", font=_font())
    w, _ = _text_size(draw, title)
    draw.text(((width - w) / 2, 4), title, fill="black", font=_font())
    w, _ = _text_size(draw, xlabel)
    draw.text(((left + right - w) / 2, height - line_h - 2), xlabel, fill="black",
              font=_font())
    draw.text((4, 4), ylabel, fill="black", font=_font())
    return image


def image_grid(rows: Sequence[Sequence[Tuple[Image.Image, str]]],
               cell: Tuple[int, int] = (320, 240)) -> Image.Image:
    """Rows of ``(image, title)`` as one picture, each image fitted into a
    ``cell`` (aspect kept) under its title."""
    width, height = cell
    cols = max(len(r) for r in rows)
    probe = ImageDraw.Draw(Image.new("RGB", (1, 1)))
    line_h = _text_size(probe, "Ag")[1] + 6
    grid = Image.new("RGB", (cols * (width + 8), len(rows) * (height + line_h + 8)), "white")
    draw = ImageDraw.Draw(grid)
    for r, row in enumerate(rows):
        for c, (image, title) in enumerate(row):
            x, y = c * (width + 8) + 4, r * (height + line_h + 8) + 4
            draw.text((x, y), title, fill="black", font=_font())
            fitted = image.convert("RGB")
            fitted.thumbnail((width, height))
            grid.paste(fitted, (x, y + line_h))
    return grid


class LineChartPlotter:
    """Loss and LR curves: ``add_chart({"x", "y", "label"})``, then
    ``display()`` writes the figure to ``filepath``."""

    def __init__(self, title: str, xlabel: str, ylabel: str, filepath: str):
        self.title = title
        self.xlabel = xlabel
        self.ylabel = ylabel
        self.filepath = filepath
        self.charts = []

    def add_chart(self, chart: Dict):
        self.charts.append(chart)

    def display(self):
        image = line_plot([(c["x"], c["y"], c["label"]) for c in self.charts],
                          self.title, self.xlabel, self.ylabel)
        _save(image, self.filepath)
