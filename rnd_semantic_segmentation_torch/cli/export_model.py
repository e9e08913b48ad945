"""Deployment export CLI: checkpoint -> a ``torch.export`` program of the
eval head (serve/export.py).

    python -m rnd_semantic_segmentation_torch.cli.export_model \\
        -cfg configs/deeplabv2_r101_src.yaml -o exported/deeplab --batch 2 \\
        [TEST.QUANT int8] resume <Aspp-N.pth>

Writes ``<output>.pt2`` and ``<output>.json``; ``serve.export.load_exported``
runs it without the model code or the checkpoint.  Under ``TEST.QUANT`` the
first ``TEST.QUANT_CALIB_BATCHES`` batches of DATASETS.TEST calibrate before
the export.  ``--platforms`` may name only the device the program is traced
on (``MODEL.DEVICE``'s type).
"""

from __future__ import annotations

import argparse

from ..data import DataLoader, build_collate_fn, build_dataset
from ..eval.tester import Tester
from ..serve.export import export_eval
from ..utils import setup_logger
from .common import load_cfg


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="torch.export deployment export")
    parser.add_argument("-cfg", "--config-file", default="", metavar="FILE", type=str)
    parser.add_argument("-o", "--output", default="exported/model",
                        help="artifact path prefix (.pt2/.json added)")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--platforms", default="",
                        help="comma list; only the traced device (default: it)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


def cli(argv=None):
    args = build_parser().parse_args(argv)
    cfg = load_cfg(args)
    logger = setup_logger("export", cfg.OUTPUT_DIR, 0)
    test_loader = DataLoader(
        build_dataset(cfg, mode="test", is_source=False),
        batch_size=max(cfg.TEST.BATCH_SIZE, 1), shuffle=False, drop_last=False,
        num_workers=cfg.DATA_PIPE.NUM_WORKERS,
        worker_processes=cfg.DATA_PIPE.WORKER_PROCESSES, collate_fn=build_collate_fn(cfg))
    tester = Tester(cfg, logger, test_loader=test_loader)
    tester._load_checkpoint()
    qctx = tester.make_quant_context()  # calibrates when TEST.QUANT != none
    platforms = [p.strip() for p in args.platforms.split(",") if p.strip()] or None
    meta = export_eval(tester, args.batch, args.output, quant_ctx=qctx, platforms=platforms,
                       logger=logger)
    test_loader.close()
    return meta


if __name__ == "__main__":
    cli()
