"""Shared CLI plumbing: the YACS-style ``-cfg <yaml> [KEY VALUE ...]`` surface."""

from __future__ import annotations

from ..configs import get_default_cfg


def load_cfg(args):
    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg
