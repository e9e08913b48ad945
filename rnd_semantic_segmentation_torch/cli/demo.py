"""Comparison grids over several checkpoints, and their PR curves.

    python -m rnd_semantic_segmentation_torch.cli.demo \\
        -cfg configs/deeplabv2_r101_src.yaml -c <render.json> -o grid.png -n 4

The render JSON gives ``demo_image_path`` (a text file of image paths),
optionally ``demo_groundtruth_path`` (label PNGs, one per image),
``weights`` (column name -> checkpoint; default one column of ``resume``),
``palette`` and ``trainid2name``.  Each row is the image, its ground truth
and each column's palette prediction, drawn with Pillow
(``utils/plots.py``).  One predictor per column (cli/inference.py), so one
Tester and one checkpoint load for each; ``TEST.QUANT`` applies to every
column.  With ground truth, each column's per-class PR curves go to
``OUTPUT_DIR/pr_curves/<column>/``; with ``"tensorboard": true`` the first
column's predictions go to ``OUTPUT_DIR/tb_demo`` as image events
(utils/tb_writer.py).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

from ..eval.palette import get_color_palette
from ..eval.pr_curves import dump_pr_curves
from ..utils import load_json, load_text, setup_logger
from ..utils.plots import image_grid
from .common import load_cfg
from .inference import build_predictor


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="GPU segmentation demo grids")
    parser.add_argument("-cfg", "--config-file", default="", metavar="FILE", type=str)
    parser.add_argument("-c", "--config_path", default="renders/cityscapes.json")
    parser.add_argument("-o", "--output", default="demo_grid.png")
    parser.add_argument("-n", "--num-samples", type=int, default=4)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


def cli(argv=None):
    args = build_parser().parse_args(argv)
    cfg = load_cfg(args)
    render = load_json(args.config_path)
    logger = setup_logger("demo", cfg.OUTPUT_DIR, 0)

    image_list = render.get("demo_image_path")
    gt_list = render.get("demo_groundtruth_path")
    images = load_text(image_list)[: args.num_samples] if image_list else []
    gts = load_text(gt_list)[: args.num_samples] if gt_list else []
    if not images:
        raise SystemExit("render config has no demo_image_path list")

    weights = render.get("weights") or {"prediction": cfg.resume}
    palette = render.get("palette", [0, 0, 0, 255, 255, 255])
    predictors = {}
    for key, ckpt in weights.items():
        cfg_k = cfg.clone()
        cfg_k.defrost()
        cfg_k.resume = ckpt
        cfg_k.freeze()
        predictors[key] = build_predictor(cfg_k, logger)

    # per column: every pixel's probabilities, and the labels, for the PR curves
    big_preds = {key: [] for key in weights}
    big_labels = []
    preds = {}
    rows = []
    for r, img_path in enumerate(images):
        row = [(Image.open(img_path), os.path.basename(img_path))]
        if gts:
            gt_img = Image.open(gts[r])
            row.append((gt_img, "ground truth"))
        for key in weights:
            pred, probs = predictors[key](img_path, return_probs=True)
            preds[key, r] = pred
            row.append((get_color_palette(pred, palette), key))
            if gts:
                big_preds[key].append(probs.reshape(-1, probs.shape[-1]))
        if gts:
            gt = np.asarray(gt_img.resize(pred.shape[::-1], Image.NEAREST))
            big_labels.append(gt.reshape(-1))
        rows.append(row)
    parent = os.path.dirname(args.output)
    if parent:
        os.makedirs(parent, exist_ok=True)
    image_grid(rows).save(args.output)
    logger.info(f"saved {args.output}")

    if gts:
        label = np.concatenate(big_labels)
        id2name = render.get("trainid2name", {})
        for key in weights:
            out_dir = os.path.join(cfg.OUTPUT_DIR, "pr_curves", key)
            dump_pr_curves(np.concatenate(big_preds[key]), label, id2name, out_dir)
            logger.info(f"PR curves for '{key}' in {out_dir}")

    if render.get("tensorboard"):
        from ..utils.tb_writer import SummaryWriter

        writer = SummaryWriter(os.path.join(cfg.OUTPUT_DIR, "tb_demo"))
        first = next(iter(weights))
        for r, img_path in enumerate(images):
            colored = np.asarray(get_color_palette(preds[first, r], palette).convert("RGB"))
            writer.add_image(os.path.basename(img_path), colored, step=r)
        writer.close()
        logger.info(f"tensorboard events in {cfg.OUTPUT_DIR}/tb_demo")
    return preds


if __name__ == "__main__":
    cli()
