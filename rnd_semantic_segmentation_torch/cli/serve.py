"""Serving CLI: micro-batched HTTP inference daemon (serve/server.py).

    python -m rnd_semantic_segmentation_torch.cli.serve \\
        -cfg configs/deeplabv2_r101_src.yaml --port 8500 resume <Aspp-N.pth>
    python -m rnd_semantic_segmentation_torch.cli.serve \\
        -cfg configs/gald_src.yaml --port 8500 resume <weights.pth>
    python -m rnd_semantic_segmentation_torch.cli.serve \\
        -cfg configs/attn_src_kvasir.yaml -c renders/kvasir.json \\
        MODEL.FUSED_MBCONV True resume <weights.pth>
    python -m rnd_semantic_segmentation_torch.cli.serve \\
        -cfg configs/pranet_src_polyp.yaml -c renders/kvasir.json --max-batch 1 \\
        resume <PraNet-N.pth>

Serves every family the port builds (deeplab, gald, attn, attnwrap,
pranet); ``-c`` names the render config whose palette colours the masks.
The pranet head normalises over its whole batch, so ``--max-batch 1`` gives
each request a mask of its own image alone.  Runs on the CUDA
card unless ``MODEL.DEVICE cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from ..serve.server import serve_forever
from ..utils import load_json, setup_logger
from .common import load_cfg


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="GPU inference server")
    parser.add_argument("-cfg", "--config-file", default="", metavar="FILE",
                        type=str)
    parser.add_argument("-c", "--config_path",
                        default="renders/cityscapes.json")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8500)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--batch-timeout-ms", type=float, default=5.0)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


def cli():
    args = build_parser().parse_args()
    cfg = load_cfg(args)
    render = (load_json(args.config_path)
              if os.path.exists(args.config_path) else {})
    logger = setup_logger("serve", cfg.OUTPUT_DIR, 0)
    serve_forever(cfg, render, logger, host=args.host, port=args.port,
                  max_batch=args.max_batch,
                  batch_timeout_ms=args.batch_timeout_ms)


if __name__ == "__main__":
    cli()
