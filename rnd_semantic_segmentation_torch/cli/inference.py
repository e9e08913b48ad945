"""Single-image inference CLI: one image through the configured model, its
argmax written as a palette PNG.

    python -m rnd_semantic_segmentation_torch.cli.inference \\
        -cfg configs/deeplabv2_r101_src.yaml -c renders/cityscapes.json \\
        -i image.png -o pred.png [TEST.QUANT int8] resume <Aspp-N.pth>

The image goes through the family's test transform and the ``Tester``'s
probability head; under ``TEST.QUANT`` the first image's batch calibrates
the activation scales (serve/quant.py).  Runs on the CUDA card unless
``MODEL.DEVICE cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

from ..data.augment import Augmenter
from ..data.loader import preprocess_eval_image
from ..eval.palette import get_color_palette
from ..eval.tester import Tester
from ..serve.quant import quant_scope
from ..utils import load_json, setup_logger
from .common import load_cfg


class _OneImageLoader:
    """One batch, as a test loader: what the Tester calibrates on."""

    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        yield self.batch

    def __len__(self):
        return 1


def build_predictor(cfg, logger):
    """``predict(image_path, return_probs=False)`` -> the argmax [H,W] (and
    the probabilities [H,W,C]).  One Tester and one checkpoint load for the
    predictor, made at its first call; under ``TEST.QUANT`` that first
    image's batch calibrates, and later images reuse the scales."""
    transform = Augmenter(cfg, mode="test", is_source=False).build_transform()
    state = {}

    def _batch(image_path: str):
        img = preprocess_eval_image(Image.open(image_path).convert("RGB"), transform)
        return {"image": img[None], "label": np.zeros(img.shape[:2], np.int32)[None],
                "name": [os.path.basename(image_path)]}

    def predict(image_path: str, return_probs: bool = False):
        batch = _batch(image_path)
        if "tester" not in state:
            tester = Tester(cfg, logger, test_loader=_OneImageLoader(batch))
            tester._load_checkpoint()
            state["tester"] = tester
        tester = state["tester"]
        x, size = tester._loader_input(batch)
        with quant_scope(tester.make_quant_context()):
            probs = tester._probs_impl(x, size)
        pred = probs[0].argmax(dim=0).cpu().numpy()
        if return_probs:
            return pred, probs[0].permute(1, 2, 0).cpu().numpy()
        return pred

    return predict


def get_pred(cfg, image_path: str, logger):
    return build_predictor(cfg, logger)(image_path)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="GPU single-image inference")
    parser.add_argument("-cfg", "--config-file", default="", metavar="FILE", type=str)
    parser.add_argument("-i", "--image", required=True, help="input image path")
    parser.add_argument("-o", "--output", default="pred.png", help="output PNG")
    parser.add_argument("-c", "--config_path", default="renders/cityscapes.json")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


def cli(argv=None):
    args = build_parser().parse_args(argv)
    cfg = load_cfg(args)
    render = load_json(args.config_path) if os.path.exists(args.config_path) else {}
    logger = setup_logger("inference", cfg.OUTPUT_DIR, 0)
    pred = get_pred(cfg, args.image, logger)
    palette = render.get("palette", [0, 0, 0, 255, 255, 255])
    get_color_palette(pred, palette).save(args.output)
    logger.info(f"saved prediction to {args.output}")
    return pred


if __name__ == "__main__":
    cli()
