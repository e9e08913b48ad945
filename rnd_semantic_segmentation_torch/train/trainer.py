"""Source-supervised and adversarial trainers (counterparts of ``Trainer``
and ``FadaTrainer`` in the JAX package's train/trainer.py).

Loop semantics kept from the reference trainers:
  * the LR is rewritten every iteration (inside the step);
  * a log line every 20 iterations with windowed meters; ``data`` is the time
    a step waited for its batch and ``time`` the whole step;
  * a checkpoint every SOLVER.CHECKPOINT_PERIOD epochs, ``{Prefix}-{epoch}.pth``,
    pruned to SOLVER.KEEP_CHECKPOINTS (the source trainer only: FADA keeps
    every ``{Prefix}Fada-{epoch}.pth``);
  * the step's series dumped to ``<family>_chart_params.json`` (FADA:
    ``<family>_fada_chart_params.json``, six series);
  * resume from ``cfg.resume`` (a file, or ``latest`` in OUTPUT_DIR);
  * the step's drop-connect generator is seeded from ``SEED + 1``, as the
    JAX trainer's ``base_rng`` is, and reseeded per step from the step count;
  * pranet trains each batch at three rates (``MULTISCALE_RATES``): three
    optimizer steps, at sides ``round(TRAINSIZE * rate / 32) * 32`` (256,
    352 and 448 at 352), the image and the float label resized bilinearly
    with ``align_corners=True`` and the label rounded half to even;
    ``iteration`` and the series count batches (the last rate's loss and
    LR), ``state.step`` counts optimizer steps.  The FADA trainer takes one
    step a batch at any family, as the JAX one does;
  * with DATA_PIPE.DEVICE_AUG each batch goes through the device augmenter
    (data/device_pipe.py) after it reaches the device and before pranet's
    resize to its rates, its draws seeded by the batch's ``iteration``; the
    FADA trainer has one for each stream (the target's with its own draws,
    its train size and no jitter);
  * with SOLVER.BN_RECAL_BATCHES > 0 the source trainer re-estimates the
    BatchNorm running statistics after its last epoch over that many
    train-loader batches (device-augmented when DEVICE_AUG is on; the
    drop-connect generator seeded from ``SEED + 2``) and writes
    ``{Prefix}-{SOLVER.EPOCHS}.pth`` again; the FADA trainer never does,
    as in the JAX package; under more than one process it logs a warning
    and skips it, as the JAX trainer does;
  * with SOLVER.ASYNC_CHECKPOINT a save copies the tensors and leaves the
    file to a background writer (ckpt/async_writer.py): pruned to
    ``max(KEEP - 1, 1)`` before the save, as in the JAX trainer; the trainer
    waits for the writer before the next save, before the recalibration's
    re-save and at the end of ``train()``, and ``resume latest`` waits too.
    ``save_blocked_ms`` holds how long the loop waited at each save.

One process holds one device.  In a world of more than one
(``parallel.initialize_distributed``; DIST.INITIALIZE) each rank builds the
same seeded parts, takes rank 0's (``broadcast_module``), turns its
BatchNorms into ``CrossRankBatchNorm2d`` and loads its slice of each global
batch (``DataLoader.global_batch_slice``); the steps average the gradients.
The primary process alone writes ``config.yaml``, the checkpoints, the
charts and the logs, and each epoch's save ends in a barrier; every rank
reads ``resume``.  DIST.SPATIAL_PARALLEL > 1 raises.

MODEL.WEIGHTS lays a pretrained backbone ``.pth`` over the freshly built
parts (ckpt/pretrained.py), before they reach the device, are broadcast from
rank 0 (every rank reads the file) and get their optimizers, and so before
``resume``, which wins where both are given.  The online-distillation
student is a ``Trainer`` and loads it too.
"""

from __future__ import annotations

import datetime
import os
import time

import torch

from ..ckpt.async_writer import AsyncCheckpointWriter, wait_for_checkpoints
from ..ckpt.checkpoint_io import (
    checkpoint_name,
    latest_checkpoint,
    load_checkpoint,
    prune_checkpoints,
    save_checkpoint,
)
from ..ckpt.pretrained import load_pretrained_backbone
from ..data.device_pipe import make_device_augmenter
from ..data.loader import DataLoader, device_prefetch
from ..models.build import build_adversarial_discriminator, build_segmentor, set_conv_rewrites
from ..ops import resize_bilinear
from ..parallel import (
    barrier,
    broadcast_module,
    check_world,
    convert_batchnorm,
    process_is_primary,
    rank,
    world_size,
)
from ..utils import MetricLogger, dump_json, resolve_device, setup_logger
from .bn_recal import recalibrate_batch_stats
from .fada import DISC_PART, make_disc_optimizer, make_fada_train_step
from .segmentor import Segmentor
from .state import TrainState, make_optimizers
from .checkify import wrap_step_checkify
from .steps import make_src_train_step


MULTISCALE_RATES = (0.75, 1.0, 1.25)  # pranet's source training


def rate_side(trainsize: int, rate: float) -> int:
    """The side of a multi-scale step: ``TRAINSIZE * rate`` rounded (half to
    even, Python's ``round``) to a multiple of 32."""
    return int(round(trainsize * rate / 32) * 32)


def resize_batch_to(batch, size: int):
    """``{"image": [B,H,W,3], "label": [B,H,W]}`` at ``size`` x ``size``: the
    image and the label as floats resized bilinearly with
    ``align_corners=True``, then the label rounded half to even (as
    ``np.rint``) back to its type."""
    image = batch["image"].float().permute(0, 3, 1, 2)
    image = resize_bilinear(image, (size, size), align_corners=True)
    label = resize_bilinear(batch["label"].float().unsqueeze(1), (size, size),
                            align_corners=True)
    return {"image": image.permute(0, 2, 3, 1).contiguous(),
            "label": torch.round(label[:, 0]).to(batch["label"].dtype)}


def _refuse_unported(cfg) -> None:
    """Knobs of the JAX trainer whose counterparts are not ported yet raise
    (DIST.SPATIAL_PARALLEL > 1 in ``check_world``, with DIST.NUM_DEVICES
    against the world); none is silently ignored."""
    check_world(cfg)


class Trainer:
    """The source-only trainer; ``FadaTrainer`` runs its loop on two streams."""

    # chart title -> metric of the step, dumped to <chart name>_chart_params.json
    CHART = {"learning rate": "lr", "loss": "loss"}

    def __init__(self, name: str, cfg, train_loader: DataLoader, logger=None):
        self._build(name, cfg, logger)
        self.train_loader = self._slice(train_loader)
        self.state = TrainState(optimizers=make_optimizers(self.spec, cfg))
        self.ckpt_prefix, self.ckpt_modules = self.spec.ckpt_prefix, self.spec.modules
        self.chart_name = self.spec.family
        if self.spec.family == "pranet":
            self.rates = MULTISCALE_RATES
        self.start_epoch = self._resume()
        self.steps_per_epoch = len(train_loader)
        self.step_fn = self._checked(make_src_train_step(
            self.segmentor, cfg, self.steps_per_epoch, self.state, seed=cfg.SEED + 1))
        self.device_augs = ((make_device_augmenter(cfg),) if cfg.DATA_PIPE.DEVICE_AUG
                            else None)

    def _build(self, name: str, cfg, logger) -> None:
        _refuse_unported(cfg)
        self.cfg = cfg
        self.name = name
        self.world = world_size()
        self.logger = logger or setup_logger(name + "_train", cfg.OUTPUT_DIR, rank())
        self.device = resolve_device(cfg.MODEL.DEVICE)
        if cfg.DEBUG.NANS:
            torch.autograd.set_detect_anomaly(True)
        torch.manual_seed(cfg.SEED)
        self.spec = build_segmentor(cfg)
        if cfg.MODEL.WEIGHTS:
            self.logger.info(f"Loading pretrained backbone from {cfg.MODEL.WEIGHTS}")
            load_pretrained_backbone(self.spec, cfg, self.spec.modules)
        self.segmentor = Segmentor(self.spec, cfg.MODEL.NUM_CLASSES).to(self.device)
        for module in self.spec.modules.values():
            self._replicate(module)
        self.series = {key: [] for key in self.CHART.values()}
        self.rates = (1.0,)  # optimizer steps a batch, at these rates of its side
        self.ckpt_writer = (AsyncCheckpointWriter() if cfg.SOLVER.ASYNC_CHECKPOINT
                            and process_is_primary() else None)
        self.save_blocked_ms = []

    def _checked(self, step_fn):
        """DEBUG.CHECKIFY: the step under the float checks of train/checkify.py,
        which raise ``FloatingPointError`` after a step that made a NaN or
        divided by zero."""
        if not self.cfg.DEBUG.CHECKIFY:
            return step_fn
        return wrap_step_checkify(step_fn, self.ckpt_modules)

    def _replicate(self, module) -> None:
        """Under more than one process: rank 0's parameters and buffers, and
        BatchNorm statistics across the ranks."""
        if self.world > 1:
            convert_batchnorm(module)
            broadcast_module(module)

    def _slice(self, loader: DataLoader) -> DataLoader:
        """This rank's slice of each of the loader's global batches."""
        return loader.global_batch_slice(rank(), self.world) if self.world > 1 else loader

    def _resume(self) -> int:
        """Restores ``ckpt_modules`` and ``state`` from ``cfg.resume`` (a file,
        or ``latest`` of ``ckpt_prefix`` in OUTPUT_DIR); returns the epoch to
        start from."""
        resume = self.cfg.resume
        if resume == "latest":
            resume = latest_checkpoint(self.cfg.OUTPUT_DIR, self.ckpt_prefix) or ""
        if not resume:
            return 1
        self.logger.info(f"Loading checkpoint from {resume}")
        return load_checkpoint(resume, self.ckpt_modules, self.state)

    @property
    def lr_data(self):
        return self.series["lr"]

    @property
    def loss_data(self):
        return self.series["loss"]

    def _batches(self, epoch: int):
        """The step's arguments but the epoch, one tuple a step."""
        self.train_loader.set_epoch(epoch)  # shuffle order is f(seed, epoch)
        for batch in device_prefetch(iter(self.train_loader), self.cfg.DATA_PIPE.PREFETCH,
                                     device=self.device):
            yield (batch,)

    def _augment(self, args, iteration: int):
        """The step's batches through the device augmenters, if any."""
        if self.device_augs is None:
            return args
        return tuple(aug(batch, iteration) for aug, batch in zip(self.device_augs, args))

    def _prune_checkpoints(self) -> None:
        """Before each save: prune to keep-1, so that retention lands at
        SOLVER.KEEP_CHECKPOINTS (0 keeps all) after it, but never below one
        complete checkpoint while the new one is written."""
        keep = self.cfg.SOLVER.KEEP_CHECKPOINTS
        if keep > 0:
            prune_checkpoints(self.cfg.OUTPUT_DIR, self.ckpt_prefix, max(keep - 1, 1))

    def _peak_memory_mb(self) -> float:
        if self.device.type != "cuda":
            return 0.0
        return torch.cuda.max_memory_allocated(self.device) / 1024.0 / 1024.0

    def train(self) -> TrainState:
        cfg = self.cfg
        self.meters = meters = MetricLogger(delimiter="  ")
        max_iter = cfg.SOLVER.EPOCHS * self.steps_per_epoch
        self.logger.info("#" * 20 + f" Start {self.ckpt_prefix} Training " + "#" * 20)
        if process_is_primary():
            # reproducibility: snapshot the resolved config next to the run
            os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
            with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as fh:
                fh.write(cfg.dump())
        start = time.time()

        iteration = self.state.step
        for epoch in range(self.start_epoch, cfg.SOLVER.EPOCHS + 1):
            epoch0 = float(epoch - 1)
            it = self._batches(epoch)
            while True:
                tic = time.time()
                try:
                    # fetched explicitly, so that a stall of the host pipeline
                    # shows: `data` is the time the device waited for input
                    args = next(it)
                except StopIteration:
                    break
                data_time = time.time() - tic
                args = self._augment(args, iteration)
                for rate in self.rates:
                    step_args = args if rate == 1.0 else (resize_batch_to(
                        args[0], rate_side(cfg.INPUT.TRAINSIZE, rate)),)
                    metrics = self.step_fn(*step_args, epoch0)  # ends in a device sync
                iteration += 1
                meters.update(time=time.time() - tic, data=data_time,
                              **{k: v for k, v in metrics.items() if k.startswith("loss")})
                for key, values in self.series.items():
                    values.append(metrics[key])
                if iteration % 20 == 0 or iteration == max_iter:
                    eta = meters.meters["time"].global_avg * (max_iter - iteration)
                    self.logger.info(
                        f"Epoch: {epoch}  eta: {datetime.timedelta(seconds=int(eta))}  "
                        f"iter: {iteration}  {meters}  lr: {metrics['lr']:.6f}  "
                        f"max mem: {self._peak_memory_mb():.0f}")
            if epoch % cfg.SOLVER.CHECKPOINT_PERIOD == 0:
                self._save(epoch, prune=True)

        self._finish()
        wait_for_checkpoints()
        total = time.time() - start
        self.logger.info(
            f"Total training time: {datetime.timedelta(seconds=int(total))} "
            f"({total / max(cfg.SOLVER.EPOCHS, 1):.4f} s / epoch)")
        if process_is_primary():
            dump_json(os.path.join(cfg.OUTPUT_DIR, f"{self.chart_name}_chart_params.json"),
                      {title: self.series[key] for title, key in self.CHART.items()})
        return self.state

    def _save(self, epoch: int, prune: bool) -> None:
        """``{Prefix}-{epoch}.pth`` from the primary process, after the
        writes in flight and, when ``prune``, the pruning; then a barrier.
        The time the loop waited goes to ``save_blocked_ms``."""
        if process_is_primary():
            tic = time.perf_counter()
            wait_for_checkpoints()
            if prune:
                self._prune_checkpoints()
            path = checkpoint_name(self.cfg.OUTPUT_DIR, self.ckpt_prefix, epoch)
            save_checkpoint(path, self.ckpt_modules, self.state, epoch, writer=self.ckpt_writer)
            self.save_blocked_ms.append((time.perf_counter() - tic) * 1e3)
            self.logger.info(f"[Saving Snapshot:] {path}")
        barrier()

    def _finish(self) -> None:
        """After the last epoch: the BatchNorm recalibration, when asked."""
        if self.cfg.SOLVER.BN_RECAL_BATCHES > 0:
            self._recalibrate_bn(self.cfg.SOLVER.BN_RECAL_BATCHES)

    def _recalibrate_bn(self, n_batches: int) -> None:
        """The running statistics re-estimated over ``n_batches`` train-loader
        batches, device-augmented as in training (the first batches' steps
        0, 1, ...), then ``{Prefix}-{SOLVER.EPOCHS}.pth`` written again with
        the optimizers' state, so that eval and resume see them."""
        cfg = self.cfg
        if self.world > 1:
            # each rank's loader slice would recalibrate its replica on other
            # data and tell the ranks' statistics apart
            self.logger.warning("SOLVER.BN_RECAL_BATCHES ignored under multi-process "
                                "training (per-process loader shards)")
            return
        batches = []
        for i, batch in enumerate(device_prefetch(iter(self.train_loader),
                                                  cfg.DATA_PIPE.PREFETCH, device=self.device)):
            if self.device_augs is not None:
                batch = self.device_augs[0](batch, i)
            batches.append(batch["image"])
            if len(batches) >= n_batches:
                break
        generator = torch.Generator(device=self.device)
        n = recalibrate_batch_stats(self.segmentor, batches, generator=generator,
                                    seed=cfg.SEED + 2)
        self.logger.info(f"[BN-recal] running stats re-estimated over {n} batches")
        self._save(cfg.SOLVER.EPOCHS, prune=False)


class FadaTrainer(Trainer):
    """The adversarial trainer (counterpart of the JAX package's
    ``FadaTrainer``): source and target loaders zipped, an epoch of
    ``min(len(src), len(tgt))`` steps of ``make_fada_train_step``.

    The discriminator is sized from the segmentor's tap and seeded from
    ``SEED + 2``, the step's drop-connect generator from ``SEED + 3``.  A
    checkpoint ``{Prefix}Fada-{epoch}.pth`` holds the segmentor's parts and
    ``model_D``, each with its optimizer, and ``epoch`` and ``step`` (the
    reference's combined layout); ``resume`` restores all of them.  Every
    checkpoint is kept, whatever SOLVER.KEEP_CHECKPOINTS says, as the JAX
    ``FadaTrainer`` keeps them."""

    CHART = {"learning rate": "lr", "discriminator learning rate": "lr_D",
             "segmentation loss": "loss_seg", "target adversarial loss": "loss_adv_tgt",
             "source discriminator loss": "loss_D_src",
             "target discriminator loss": "loss_D_tgt"}

    def __init__(self, name: str, cfg, src_loader: DataLoader, tgt_loader: DataLoader,
                 logger=None):
        self._build(name, cfg, logger)
        self.src_loader, self.tgt_loader = self._slice(src_loader), self._slice(tgt_loader)
        torch.manual_seed(cfg.SEED + 2)
        self.disc = build_adversarial_discriminator(cfg, self.spec).to(self.device)
        # the JAX package's rewrite policies are the process's: its
        # discriminator's convs take them too
        set_conv_rewrites(self.disc, int(cfg.MODEL.S2D_MAX_CHANNELS),
                          bool(cfg.MODEL.SUBPIXEL_DECONV))
        self._replicate(self.disc)
        self.state = TrainState(optimizers={**make_optimizers(self.spec, cfg),
                                            DISC_PART: make_disc_optimizer(self.disc)})
        self.ckpt_prefix = f"{self.spec.ckpt_prefix}Fada"
        self.ckpt_modules = {**self.spec.modules, DISC_PART: self.disc}
        self.chart_name = f"{self.spec.family}_fada"
        self.start_epoch = self._resume()
        self.steps_per_epoch = min(len(src_loader), len(tgt_loader))
        self.step_fn = self._checked(make_fada_train_step(
            self.segmentor, self.disc, cfg, self.steps_per_epoch, self.state,
            seed=cfg.SEED + 3))
        self.device_augs = ((make_device_augmenter(cfg, is_source=True),
                             make_device_augmenter(cfg, is_source=False))
                            if cfg.DATA_PIPE.DEVICE_AUG else None)

    @property
    def loss_data(self):
        return self.series["loss_seg"]

    def _prune_checkpoints(self) -> None:
        """Prunes nothing: the JAX ``FadaTrainer`` keeps every
        ``{Prefix}Fada-N`` checkpoint whatever SOLVER.KEEP_CHECKPOINTS says."""

    def _finish(self) -> None:
        """Nothing: the JAX ``FadaTrainer`` never recalibrates its BatchNorms,
        whatever SOLVER.BN_RECAL_BATCHES says."""

    def _batches(self, epoch: int):
        streams = []
        for loader in (self.src_loader, self.tgt_loader):
            loader.set_epoch(epoch)
            streams.append(device_prefetch(iter(loader), self.cfg.DATA_PIPE.PREFETCH,
                                           device=self.device))
        return zip(*streams)
