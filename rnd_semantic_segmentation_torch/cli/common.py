"""Shared CLI plumbing: the YACS-style ``-cfg <yaml> [KEY VALUE ...]`` surface."""

from __future__ import annotations

import argparse

from ..configs import get_default_cfg


def base_parser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("-cfg", "--config-file", default="", metavar="FILE",
                        help="path to config file", type=str)
    parser.add_argument("--local_rank", type=int, default=0,
                        help="the process's card under torch.distributed.launch; "
                             "LOCAL_RANK wins when torchrun sets it")
    parser.add_argument("opts", help="Modify config options from the command line",
                        default=None, nargs=argparse.REMAINDER)
    return parser


def load_cfg(args):
    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg
