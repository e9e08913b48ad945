"""Target self-distillation training CLI, offline or online.

Offline (the reference's recipe):

    python -m rnd_semantic_segmentation_torch.cli.test --saveres \\
        -cfg configs/deeplabv2_r101_adv.yaml -c renders/cityscapes.json \\
        DATASETS.DATASET_DIR <root> DATASETS.TEST cityscapes_train \\
        PSEUDO_DIR <root>/cityscapes/soft_labels resume <AsppFada-N.pth>
    python -m rnd_semantic_segmentation_torch.cli.train_distill \\
        -cfg configs/deeplabv2_r101_tgt_self_distill.yaml DATASETS.DATASET_DIR <root>

The first command exports the teacher's predictions as palette PNGs; the
second trains on them: it is ``cli.train_src``'s run over
``cityscapes_self_distill_train`` (the Cityscapes images, the exported PNGs as
labels), named ``<family>_distill``.

Online (``DISTILL.ONLINE True``): the same loader and ``Trainer``, whose step
becomes ``make_online_distill_step`` (train/distill.py): a frozen teacher
labels each batch inside the step, and the loader's labels are read and
ignored.

    python -m rnd_semantic_segmentation_torch.cli.train_distill \\
        -cfg configs/deeplabv2_r101_tgt_self_distill.yaml DATASETS.DATASET_DIR <root> \\
        DISTILL.ONLINE True DISTILL.TEACHER <AsppFada-N.pth> \\
        DISTILL.CONFIDENCE_THRESHOLD 0.9

The teacher is a second ``Segmentor`` of MODEL.NAME, loaded from
DISTILL.TEACHER: a ``.pth`` in the reference's layout, a ``{Prefix}-N.pth``
of the port's trainer or a ``{Prefix}Fada-N.pth`` of its FADA trainer (the
spec's parts only).  An Orbax directory of the JAX package raises
NotImplementedError (ROADMAP Queue 1 item 3).  DISTILL.CONFIDENCE_THRESHOLD
above 0 maps the teacher's less confident pixels to INPUT.IGNORE_LABEL, and
raises ValueError for the pranet, attn and attnwrap families.  The online
step reads neither SOLVER.GRAD_CLIP nor SOLVER.ACCUM_STEPS (pranet's 0.5
clamp is absent), as the JAX step; pranet still takes three steps a batch at
its rates, each image labelled at its rate's size.  Runs on the CUDA card
unless ``MODEL.DEVICE cpu`` is given; under ``torchrun`` with DIST.INITIALIZE
True, data parallel over the processes (``cli.train_src``'s trainer).
"""

from __future__ import annotations

from ..ckpt.torch_import import load_part, load_reference_checkpoint
from ..models.build import build_segmentor
from ..train.distill import make_online_distill_step
from ..train.segmentor import Segmentor
from .common import base_parser, load_cfg
from .train_src import make_trainer


def build_parser():
    return base_parser("GPU semantic segmentation self-distillation")


def _check_teacher_path(path: str) -> None:
    if not path:
        raise ValueError("DISTILL.ONLINE needs DISTILL.TEACHER, the teacher's .pth")
    if not path.endswith(".pth"):
        raise NotImplementedError(
            f"DISTILL.ONLINE with DISTILL.TEACHER {path!r}: the port reads .pth teachers; "
            f"Orbax directories of the JAX package wait for a converter (ROADMAP Queue 1 "
            f"item 3)")


def load_teacher(cfg, device) -> Segmentor:
    """A ``Segmentor`` of MODEL.NAME on ``device`` with DISTILL.TEACHER's
    parts, in eval mode with its parameters frozen."""
    path = cfg.DISTILL.TEACHER
    _check_teacher_path(path)
    parts = load_reference_checkpoint(path)
    spec = build_segmentor(cfg)
    for name, module in spec.modules.items():
        if name not in parts:
            raise KeyError(f"teacher {path} lacks part {name!r} of {cfg.MODEL.NAME}")
        load_part(module, parts[name], name)
    teacher = Segmentor(spec, cfg.MODEL.NUM_CLASSES).to(device)
    return teacher.eval().requires_grad_(False)


def make_online_trainer(name: str, cfg, local_rank: int = 0, logger=None):
    """``cli.train_src``'s trainer with its step swapped for the online
    distillation step; the teacher is ``trainer.teacher``."""
    _check_teacher_path(cfg.DISTILL.TEACHER)  # before the loader forks its workers
    trainer = make_trainer(name, cfg, local_rank, logger=logger)
    trainer.teacher = load_teacher(cfg, trainer.device)
    trainer.step_fn = make_online_distill_step(
        trainer.segmentor, cfg, trainer.steps_per_epoch, trainer.state, trainer.teacher,
        confidence_threshold=cfg.DISTILL.CONFIDENCE_THRESHOLD, seed=cfg.SEED + 1)
    return trainer


def main(name: str, cfg, local_rank: int = 0) -> None:
    if cfg.DISTILL.ONLINE:
        make_online_trainer(name, cfg, local_rank).train()
    else:
        make_trainer(name, cfg, local_rank).train()


def cli():
    args = build_parser().parse_args()
    cfg = load_cfg(args)
    main(cfg.MODEL.NAME.split("_")[0] + "_distill", cfg, args.local_rank)


if __name__ == "__main__":
    cli()
