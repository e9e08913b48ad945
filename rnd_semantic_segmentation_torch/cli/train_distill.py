"""Target self-distillation training CLI, the offline recipe.

    python -m rnd_semantic_segmentation_torch.cli.test --saveres \\
        -cfg configs/deeplabv2_r101_adv.yaml -c renders/cityscapes.json \\
        DATASETS.DATASET_DIR <root> DATASETS.TEST cityscapes_train \\
        PSEUDO_DIR <root>/cityscapes/soft_labels resume <AsppFada-N.pth>
    python -m rnd_semantic_segmentation_torch.cli.train_distill \\
        -cfg configs/deeplabv2_r101_tgt_self_distill.yaml DATASETS.DATASET_DIR <root>

The first command exports the teacher's predictions as palette PNGs; the
second trains on them: it is ``cli.train_src``'s run over
``cityscapes_self_distill_train`` (the Cityscapes images, the exported PNGs as
labels), named ``<family>_distill``.  ``DISTILL.ONLINE True`` (the teacher's
forward inside the train step) raises NotImplementedError until the next
slice.  Runs on the CUDA card unless ``MODEL.DEVICE cpu`` is given.
"""

from __future__ import annotations

from .common import base_parser, load_cfg
from .train_src import make_trainer


def build_parser():
    return base_parser("GPU semantic segmentation self-distillation")


def main(name: str, cfg, local_rank: int = 0) -> None:
    if cfg.DISTILL.ONLINE:
        raise NotImplementedError(
            "DISTILL.ONLINE: online self-distillation (the teacher's forward in the "
            "train step) comes with the next slice; the offline recipe runs with "
            "DISTILL.ONLINE False")
    make_trainer(name, cfg, local_rank).train()


def cli():
    args = build_parser().parse_args()
    cfg = load_cfg(args)
    main(cfg.MODEL.NAME.split("_")[0] + "_distill", cfg, args.local_rank)


if __name__ == "__main__":
    cli()
