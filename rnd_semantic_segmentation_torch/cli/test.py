"""Evaluation CLI: mIoU/F1 and the confusion matrix on DATASETS.TEST.

    python -m rnd_semantic_segmentation_torch.cli.test \\
        -cfg configs/deeplabv2_r101_src.yaml DATASETS.TEST synthetic_val \\
        [TEST.FLIP_TTA True] [TEST.MULTI_SCALE True] resume <Aspp-N.pth>
    python -m rnd_semantic_segmentation_torch.cli.test \\
        -cfg configs/attn_src_kvasir.yaml -c renders/kvasir.json \\
        DATASETS.TEST synthetic_val resume <weights.pth>

    python -m rnd_semantic_segmentation_torch.cli.test --saveres \
        -cfg configs/deeplabv2_r101_adv.yaml -c renders/cityscapes.json \
        DATASETS.TEST cityscapes_train PSEUDO_DIR <dir> resume <AsppFada-N.pth>

``-c`` names the render config (class names for the confusion matrix, and
the palette of the PNGs).  ``--saveres`` also writes each prediction as a
palette PNG to ``PSEUDO_DIR/inference/<DATASETS.TEST>/``: with PSEUDO_DIR
``<DATASET_DIR>/cityscapes/soft_labels`` and DATASETS.TEST
``cityscapes_train`` these are the labels of
``cityscapes_self_distill_train`` (``cli.train_distill``).  Runs on the CUDA
card unless ``MODEL.DEVICE cpu`` is given, ``TEST.BATCH_SIZE`` images a
batch.  Under ``torchrun`` with DIST.INITIALIZE True each of the processes
evaluates its shard (``process_shard``), ``TEST.BATCH_SIZE // world`` images
a batch; the last ``len % world`` images are left out, as in the JAX
package, and logged by name:

    torchrun --nproc_per_node 2 -m rnd_semantic_segmentation_torch.cli.test \
        -cfg configs/deeplabv2_r101_src.yaml DATASETS.TEST synthetic_val \
        MODEL.DEVICE cpu DIST.INITIALIZE True resume <Aspp-N.pth>
"""

from __future__ import annotations

import argparse
import os

from ..data import DataLoader, build_collate_fn, build_dataset
from ..eval.tester import Tester
from ..parallel import initialize_distributed, rank, world_size
from ..utils import load_json, setup_logger
from .common import load_cfg


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="GPU semantic segmentation testing")
    parser.add_argument("-cfg", "--config-file", default="", metavar="FILE", type=str)
    parser.add_argument("--saveres", action="store_true", help="save the result")
    parser.add_argument("-c", "--config_path", default="renders/cityscapes.json",
                        help="path to render config")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


def make_tester(cfg, render_config, saveres: bool = False, logger=None) -> Tester:
    initialize_distributed(cfg)
    name = render_config.get("name", cfg.MODEL.NAME)
    logger = logger or setup_logger(name + "_test", cfg.OUTPUT_DIR, rank())
    logger.info("#" * 20 + " Start Testing " + "#" * 20)
    logger.info(f"INPUT_SIZE_TEST: {cfg.INPUT.INPUT_SIZE_TEST}")
    test_data = build_dataset(cfg, mode="test", is_source=False)
    world = world_size()
    test_loader = DataLoader(
        # TEST.BATCH_SIZE is global; each process loads its shard
        test_data, batch_size=max(cfg.TEST.BATCH_SIZE // world, 1), shuffle=False,
        drop_last=False, num_workers=cfg.DATA_PIPE.NUM_WORKERS,
        worker_processes=cfg.DATA_PIPE.WORKER_PROCESSES,
        collate_fn=build_collate_fn(cfg), process_shard=world > 1)
    left_out = test_loader.left_out()
    if left_out:
        names = getattr(test_data, "image_paths", None)
        logger.warning(
            f"process_shard over {world} processes leaves out the last {len(left_out)} "
            f"image(s): " + ", ".join(os.path.basename(names[i]) if names else f"#{i}"
                                      for i in left_out))
    tester = Tester(cfg, logger, test_loader=test_loader,
                    trainid2name=render_config.get("trainid2name"), saveres=saveres,
                    palette=render_config.get("palette"))
    tester._load_checkpoint()
    return tester


def test(cfg, render_config, args):
    return make_tester(cfg, render_config, saveres=args.saveres).test()


def cli():
    args = build_parser().parse_args()
    render_config = load_json(args.config_path)
    cfg = load_cfg(args)
    print(f"Loaded configuration file {args.config_file}")
    test(cfg, render_config, args)


if __name__ == "__main__":
    cli()
