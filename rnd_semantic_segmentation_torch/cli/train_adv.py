"""Adversarial domain-adaptation (FADA) training CLI.

    python -m rnd_semantic_segmentation_torch.cli.train_adv \\
        -cfg configs/deeplabv2_r101_adv.yaml \\
        DATASETS.SOURCE_TRAIN synthetic_train DATASETS.TARGET_TRAIN synthetic_shift_train
    python -m rnd_semantic_segmentation_torch.cli.train_adv -cfg configs/gald_adv.yaml ...
    python -m rnd_semantic_segmentation_torch.cli.train_adv -cfg configs/attn_adv_kvasir.yaml ...
    python -m rnd_semantic_segmentation_torch.cli.train_adv -cfg configs/pranet_adv_polyp_bli.yaml \\
        DATASETS.DATASET_DIR <root> INPUT.SOURCE_INPUT_SIZE_TRAIN "(352, 352)" \\
        INPUT.TARGET_INPUT_SIZE_TRAIN "(352, 352)"

The source and target loaders each take ``SOLVER.BATCH_SIZE // 2`` images a
step, and the target dataset is repeated 9 times, as in the reference, so
that zipping the two streams does not cut the source's epoch short.  The run
is named ``<family>_fada`` and writes ``{Prefix}Fada-{epoch}.pth``, which
``cli.test ... resume <file>`` evaluates.  Runs on the CUDA card unless
``MODEL.DEVICE cpu`` is given; under ``torchrun`` with DIST.INITIALIZE True,
data parallel over the processes (each stream's global batch split over
them).
"""

from __future__ import annotations

from ..data import DataLoader, build_collate_fn, build_dataset
from ..parallel import initialize_distributed
from ..train.trainer import FadaTrainer
from .common import base_parser, load_cfg


class _Repeat:
    """``ConcatDataset([dataset] * times)``."""

    def __init__(self, dataset, times: int = 9):
        self.dataset = dataset
        self.times = times
        self.image_paths = dataset.image_paths * times

    def __len__(self):
        return len(self.dataset) * self.times

    def __getitem__(self, i):
        return self.dataset[i % len(self.dataset)]


def build_parser():
    return base_parser("GPU semantic segmentation adversarial domain adaptation training")


def make_trainer(name: str, cfg, local_rank: int = 0, logger=None) -> FadaTrainer:
    initialize_distributed(cfg, local_rank)
    src_data = build_dataset(cfg, "train", is_source=True)
    tgt_data = _Repeat(build_dataset(cfg, "train", is_source=False), 9)
    kwargs = dict(shuffle=True, drop_last=True, num_workers=cfg.DATA_PIPE.NUM_WORKERS,
                  worker_processes=cfg.DATA_PIPE.WORKER_PROCESSES,
                  collate_fn=build_collate_fn(cfg), seed=cfg.DATA_PIPE.SEED)
    src_loader = DataLoader(src_data, batch_size=cfg.SOLVER.BATCH_SIZE // 2, **kwargs)
    tgt_loader = DataLoader(tgt_data, batch_size=cfg.SOLVER.BATCH_SIZE // 2, **kwargs)
    return FadaTrainer(name, cfg, src_loader, tgt_loader, logger=logger)


def main(name: str, cfg, local_rank: int = 0) -> None:
    make_trainer(name, cfg, local_rank).train()


def cli():
    args = build_parser().parse_args()
    cfg = load_cfg(args)
    main(cfg.MODEL.NAME.split("_")[0] + "_fada", cfg, args.local_rank)


if __name__ == "__main__":
    cli()
