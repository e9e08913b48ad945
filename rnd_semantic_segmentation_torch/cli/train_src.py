"""Source-only supervised training CLI.

    python -m rnd_semantic_segmentation_torch.cli.train_src \\
        -cfg configs/deeplabv2_r101_src.yaml DATASETS.SOURCE_TRAIN synthetic_train
    python -m rnd_semantic_segmentation_torch.cli.train_src \\
        -cfg configs/gald_src.yaml DATASETS.SOURCE_TRAIN synthetic_train
    python -m rnd_semantic_segmentation_torch.cli.train_src \\
        -cfg configs/attn_src_kvasir.yaml DATASETS.SOURCE_TRAIN synthetic_train
    python -m rnd_semantic_segmentation_torch.cli.train_src \\
        -cfg configs/pranet_src_polyp.yaml DATASETS.DATASET_DIR <root> \\
        INPUT.SOURCE_INPUT_SIZE_TRAIN "(352, 352)"

The model family (deeplab, gald, attn, attnwrap or pranet) comes from
MODEL.NAME through the registry.  The pranet configs leave the size the
Kvasir-fold and BLI readers resize to at its default, which the model
cannot take: set it to TRAINSIZE squared.  Runs on the CUDA card unless ``MODEL.DEVICE cpu`` is
given.  Data parallel over processes under ``torchrun`` with DIST.INITIALIZE
True (NCCL on cards, gloo on the CPU; SOLVER.BATCH_SIZE is the global
batch):

    torchrun --nproc_per_node 2 -m rnd_semantic_segmentation_torch.cli.train_src \
        -cfg configs/deeplabv2_r101_src.yaml DATASETS.SOURCE_TRAIN synthetic_train \
        MODEL.DEVICE cpu DIST.INITIALIZE True
"""

from __future__ import annotations

from ..data import DataLoader, build_collate_fn, build_dataset
from ..parallel import initialize_distributed
from ..train.trainer import Trainer
from .common import base_parser, load_cfg


def build_parser():
    return base_parser("GPU semantic segmentation source training")


def make_trainer(name: str, cfg, local_rank: int = 0, logger=None) -> Trainer:
    initialize_distributed(cfg, local_rank)
    train_data = build_dataset(cfg, "train", is_source=True)
    train_loader = DataLoader(
        train_data,
        batch_size=cfg.SOLVER.BATCH_SIZE,
        shuffle=True,
        drop_last=True,
        num_workers=cfg.DATA_PIPE.NUM_WORKERS,
        worker_processes=cfg.DATA_PIPE.WORKER_PROCESSES,
        collate_fn=build_collate_fn(cfg),
        seed=cfg.DATA_PIPE.SEED,
    )
    return Trainer(name, cfg, train_loader, logger=logger)


def main(name: str, cfg, local_rank: int = 0) -> None:
    make_trainer(name, cfg, local_rank).train()


def cli():
    args = build_parser().parse_args()
    cfg = load_cfg(args)
    name = cfg.MODEL.NAME.split("_")[0]
    main(name, cfg, args.local_rank)


if __name__ == "__main__":
    cli()
