"""SOLVER.ASYNC_CHECKPOINT in the port: the background writer
(ckpt/async_writer.py) and the trainer's use of it, on the CPU.

  * a background save loads equal, tensor for tensor, to a synchronous one,
    and holds the values of the moment it was asked for;
  * the trainer prunes before each save (``max(KEEP - 1, 1)``), so that at
    KEEP_CHECKPOINTS 1 two files remain and at 2 two remain, and its files
    load equal to those of the same run saving synchronously;
  * ``train()`` returns only after the last write; ``resume latest`` and
    ``latest_checkpoint`` wait for a write in flight;
  * a writer's exception is raised in the training thread.
"""

import logging
import os
import threading
import time

import pytest
import torch

from rnd_semantic_segmentation_torch.ckpt import async_writer
from rnd_semantic_segmentation_torch.ckpt.async_writer import (
    AsyncCheckpointWriter,
    wait_for_checkpoints,
)
from rnd_semantic_segmentation_torch.ckpt.checkpoint_io import latest_checkpoint, save_checkpoint
from rnd_semantic_segmentation_torch.cli import train_src
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.train.state import TrainState, make_optimizer

torch.set_num_threads(2)  # six test workers share the host's cores


def _model_and_state():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    opt = make_optimizer("adam", model.parameters())
    model(torch.randn(2, 3, 8, 8)).sum().backward()
    opt.step()
    return {"model": model}, TrainState(optimizers={"model": opt}, step=3)


def _assert_loads_equal(a, b):
    a = torch.load(a, map_location="cpu", weights_only=True)
    b = torch.load(b, map_location="cpu", weights_only=True)

    def same(x, y, where):
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype, where
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=where)
        elif isinstance(x, dict):
            assert list(x) == list(y), where
            for k in x:
                same(x[k], y[k], f"{where}/{k}")
        elif isinstance(x, (list, tuple)):
            assert len(x) == len(y), where
            for i, (u, v) in enumerate(zip(x, y)):
                same(u, v, f"{where}/{i}")
        else:
            assert x == y, where
    same(a, b, "")


def test_background_save_loads_equal_to_the_synchronous_one_and_snapshots(tmp_path):
    modules, state = _model_and_state()
    sync = save_checkpoint(str(tmp_path / "sync.pth"), modules, state, epoch=2)
    writer = AsyncCheckpointWriter()
    path = save_checkpoint(str(tmp_path / "async.pth"), modules, state, epoch=2, writer=writer)
    with torch.no_grad():  # the next "step" changes the weights in place
        for p in modules["model"].parameters():
            p.add_(1.0)
    writer.close()
    _assert_loads_equal(sync, path)
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def _cfg(out_dir, *opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.DEVICE", "cpu", "MODEL.DTYPE", "float32", "MODEL.NAME",
                         "deeplab_resnet18", "MODEL.NUM_CLASSES", "3",
                         "DATASETS.SOURCE_TRAIN", "synthetic_train", "AUG.NAME", "none",
                         "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(48, 48)", "SOLVER.BATCH_SIZE", "2",
                         "DATASETS.SYNTHETIC_LENGTH", "2", "SOLVER.EPOCHS", "3",
                         "SOLVER.CHECKPOINT_PERIOD", "1", "DATA_PIPE.NUM_WORKERS", "1",
                         "OUTPUT_DIR", str(out_dir), *opts])
    return cfg


def _train(out_dir, *opts):
    trainer = train_src.make_trainer("deeplab", _cfg(out_dir, *opts),
                                     logger=logging.getLogger("async_ckpt"))
    trainer.train()
    return trainer


@pytest.mark.parametrize("keep,kept", [(1, [2, 3]), (2, [2, 3]), (0, [1, 2, 3])])
def test_the_trainer_prunes_before_each_save_and_writes_the_synchronous_files(
        tmp_path, keep, kept):
    runs = {}
    for mode in ("False", "True"):
        out = tmp_path / mode
        trainer = _train(out, "SOLVER.ASYNC_CHECKPOINT", mode,
                         "SOLVER.KEEP_CHECKPOINTS", str(keep))
        runs[mode] = out
        assert (trainer.ckpt_writer is not None) == (mode == "True")
        assert len(trainer.save_blocked_ms) == 3
        assert sorted(p for p in os.listdir(out) if p.endswith(".pth")) == \
            [f"Aspp-{e}.pth" for e in kept]
    for epoch in kept:
        _assert_loads_equal(runs["False"] / f"Aspp-{epoch}.pth",
                            runs["True"] / f"Aspp-{epoch}.pth")


class _SlowWrites:
    """``async_writer.write_file`` that waits on an event first."""

    def __init__(self, monkeypatch, fail=False):
        self.release = threading.Event()
        self.started = threading.Event()
        self.fail = fail
        original = async_writer.write_file

        def write(path, ckpt):
            self.started.set()
            assert self.release.wait(timeout=60)
            if self.fail:
                raise OSError(f"disk full writing {path}")
            return original(path, ckpt)
        monkeypatch.setattr(async_writer, "write_file", write)


def test_latest_checkpoint_and_resume_wait_for_a_write_in_flight(tmp_path, monkeypatch):
    modules, state = _model_and_state()
    slow = _SlowWrites(monkeypatch)
    writer = AsyncCheckpointWriter()
    save_checkpoint(str(tmp_path / "Aspp-1.pth"), modules, state, epoch=1, writer=writer)
    assert slow.started.wait(timeout=60)
    threading.Timer(0.3, slow.release.set).start()
    tic = time.perf_counter()
    assert latest_checkpoint(str(tmp_path), "Aspp") == str(tmp_path / "Aspp-1.pth")
    assert time.perf_counter() - tic >= 0.25  # it waited for the write
    writer.close()


def test_train_returns_after_the_last_write_and_resume_latest_reads_it(tmp_path, monkeypatch):
    slow = _SlowWrites(monkeypatch)
    threading.Timer(0.5, slow.release.set).start()
    trainer = _train(tmp_path, "SOLVER.ASYNC_CHECKPOINT", "True", "SOLVER.EPOCHS", "1")
    assert os.path.exists(tmp_path / "Aspp-1.pth")   # written before train() returned
    assert not trainer.ckpt_writer._pending
    resumed = train_src.make_trainer("deeplab", _cfg(tmp_path, "SOLVER.ASYNC_CHECKPOINT", "True",
                                                     "SOLVER.EPOCHS", "2", "resume", "latest"),
                                     logger=logging.getLogger("async_ckpt"))
    assert resumed.start_epoch == 2 and resumed.state.step == 1


def test_a_writers_exception_is_raised_in_the_training_thread(tmp_path, monkeypatch):
    slow = _SlowWrites(monkeypatch, fail=True)
    slow.release.set()
    with pytest.raises(OSError, match="disk full"):
        _train(tmp_path, "SOLVER.ASYNC_CHECKPOINT", "True", "SOLVER.EPOCHS", "2")
    wait_for_checkpoints()  # the error was raised once, and not kept
