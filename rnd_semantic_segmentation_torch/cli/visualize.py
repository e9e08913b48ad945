"""Training curves from a trainer's ``<family>_chart_params.json``.

    python -m rnd_semantic_segmentation_torch.cli.visualize \\
        -j <OUTPUT_DIR>/gald_chart_params.json -o curves.png [-w 150]

One panel per series (the loss, the learning rate), each with its moving
average, drawn with Pillow (``utils/plots.py``).
"""

from __future__ import annotations

import argparse
import os

from PIL import Image

from ..utils import load_json
from ..utils.plots import line_plot


def moving_average(numbers, window_size: int = 150):
    out = []
    for i in range(len(numbers) - window_size + 1):
        out.append(sum(numbers[i:i + window_size]) / window_size)
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="plot training curves")
    parser.add_argument("-j", "--json", required=True, help="chart params json")
    parser.add_argument("-o", "--output", default="curves.png")
    parser.add_argument("-w", "--window", type=int, default=150)
    return parser


def cli(argv=None):
    args = build_parser().parse_args(argv)
    data = load_json(args.json)
    panels = []
    for key, series in data.items():
        smooth = moving_average(series, min(args.window, max(len(series) // 2, 1)))
        panels.append(line_plot(
            [(range(len(series)), series, key),
             (range(len(series) - len(smooth), len(series)), smooth, f"{key} (smoothed)")],
            title=key, alphas=(0.3, 1.0)))
    figure = Image.new("RGB", (sum(p.width for p in panels), panels[0].height), "white")
    for i, panel in enumerate(panels):
        figure.paste(panel, (i * panel.width, 0))
    parent = os.path.dirname(args.output)
    if parent:
        os.makedirs(parent, exist_ok=True)
    figure.save(args.output)
    print(f"saved {args.output}")


if __name__ == "__main__":
    cli()
