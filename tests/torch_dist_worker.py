"""One rank of a gloo world on the CPU, for the tests of the port's data
parallelism (``tests/test_torch_dist*.py``).

    python tests/torch_dist_worker.py <case> <out_dir> <rank> <world> <port> [args...]

Each rank starts the process group over ``tcp://127.0.0.1:<port>``, runs
the case on its share of inputs made from a seed with numpy (the functions
below, which the tests call too for the whole batch), and writes every
result to ``<out_dir>/<case>_rank<rank>.npz``; the test compares in its own
process.  Imports nothing of the JAX package.
"""

from __future__ import annotations

import logging
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from rnd_semantic_segmentation_torch import losses  # noqa: E402
from rnd_semantic_segmentation_torch.configs import get_default_cfg  # noqa: E402
from rnd_semantic_segmentation_torch.models.build import (  # noqa: E402
    build_adversarial_discriminator,
    build_segmentor,
    randomize_weights_,
)
from rnd_semantic_segmentation_torch.models.efficientnet import EfficientNetEncoder  # noqa: E402
from rnd_semantic_segmentation_torch.parallel import (  # noqa: E402
    CrossRankBatchNorm2d,
    convert_batchnorm,
)
from rnd_semantic_segmentation_torch.train.fada import (  # noqa: E402
    DISC_PART,
    make_disc_optimizer,
    make_fada_train_step,
)
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor  # noqa: E402
from rnd_semantic_segmentation_torch.train.state import TrainState, make_optimizers  # noqa: E402
from rnd_semantic_segmentation_torch.train.steps import make_src_train_step  # noqa: E402

STEPS_PER_EPOCH = 10
BN_SHAPE = (4, 6, 5, 7)    # the global batch of the BatchNorm case, NCHW
LOSS_SHAPE = (4, 3, 8, 10)
STEP_SIZE = 64


# -- inputs, global batches made from a seed -------------------------------------------------

def bn_inputs(seed: int = 0):
    rng = np.random.RandomState(seed)
    n, c = BN_SHAPE[:2]
    return {"x": (rng.randn(*BN_SHAPE) * 2.0 + 0.5).astype(np.float32),
            "g": rng.randn(*BN_SHAPE).astype(np.float32),
            "weight": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.uniform(-0.2, 0.2, c).astype(np.float32),
            "mean": rng.uniform(-0.2, 0.2, c).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}


def loss_inputs(seed: int = 1):
    """Logits, labels with 255 split unevenly (rank 0's half mostly
    ignored), a soft one-hot target and a mask."""
    rng = np.random.RandomState(seed)
    b, c, h, w = LOSS_SHAPE
    label = rng.randint(0, c, (b, h, w)).astype(np.int64)
    label[0, :, :] = 255
    label[1, :6, :] = 255
    label[3, :1, :2] = 255
    soft = np.eye(c, dtype=np.float32)[rng.randint(0, c, (b, h, w))].transpose(0, 3, 1, 2)
    soft = np.clip(soft + rng.uniform(-0.2, 0.2, soft.shape), 0, 1).astype(np.float32)
    return {"logits": rng.randn(b, c, h, w).astype(np.float32), "label": label,
            "soft": soft, "pred1": rng.randn(b, 1, h, w).astype(np.float32),
            "mask": (rng.rand(b, 1, h, w) > 0.5).astype(np.float32)}


def step_batch(nc: int, seed: int = 9, n: int = 4, size: int = STEP_SIZE):
    """A global batch of ``n`` NHWC images; the ignored pixels are split
    unevenly over two halves (rank 0's half has many)."""
    rng = np.random.RandomState(seed)
    label = rng.randint(0, nc, (n, size, size)).astype(np.int32)
    label[0, :40, :] = 255
    label[1, :20, :30] = 255
    label[3, :3, :5] = 255
    return {"image": rng.rand(n, size, size, 3).astype(np.float32), "label": label}


def fada_batches(nc: int, seed: int = 11, n: int = 4):
    rng = np.random.RandomState(seed)
    label = rng.randint(0, nc, (n, 48, 40)).astype(np.int32)
    label[:2, :10, :12] = 255
    src = {"image": rng.rand(n, 48, 40, 3).astype(np.float32), "label": label}
    tgt = {"image": (rng.rand(n, 40, 32, 3) * 0.7).astype(np.float32),
           "label": np.zeros((n, 40, 32), np.int32)}
    return src, tgt


def port_cfg(*opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.DEVICE", "cpu", "MODEL.DTYPE", "float32", "SOLVER.EPOCHS", "2",
                         "SOLVER.BASE_LR", "1e-3", "SOLVER.BASE_LR_D", "1e-4", *opts])
    return cfg


DEEPLAB_OPTS = ("MODEL.NAME", "deeplab_resnet18", "MODEL.NUM_CLASSES", "5",
                "MODEL.FREEZE_BN", "False")
ATTN_OPTS = ("MODEL.NAME", "attn_efficientnet-b0", "MODEL.NUM_CLASSES", "2",
             "SOLVER.WEIGHT_DECAY", "1e-4")
FADA_OPTS = ("MODEL.NAME", "deeplab_resnet18", "MODEL.NUM_CLASSES", "3",
             "MODEL.FREEZE_BN", "False", "SOLVER.WEIGHT_DECAY", "1e-4")


def port_segmentor(cfg, drop_connect: bool = True, seed: int = 10) -> Segmentor:
    spec = build_segmentor(cfg)
    if spec.family == "attn" and not drop_connect:
        spec.modules["encoder"] = EfficientNetEncoder(spec.backbone, drop_connect_rate=0.0)
    seg = Segmentor(spec, cfg.MODEL.NUM_CLASSES)
    return randomize_weights_(seg, seed=seed)


def rows(batch, rank: int, world: int):
    """A rank's contiguous rows of a global batch (numpy or torch)."""
    b = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def src_step(cfg, batch, drop_connect: bool = True):
    """One source step of a fresh seeded segmentor on ``batch``: its state
    dicts after the step, and the metrics."""
    seg = port_segmentor(cfg, drop_connect)
    for module in seg.spec.modules.values():
        convert_batchnorm(module)
    state = TrainState(optimizers=make_optimizers(seg.spec, cfg))
    step = make_src_train_step(seg, cfg, STEPS_PER_EPOCH, state)
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()}, 0.0)
    return seg, metrics


def fada_step(cfg, src, tgt):
    seg = port_segmentor(cfg)
    disc = randomize_weights_(build_adversarial_discriminator(cfg, seg.spec), seed=11)
    for module in list(seg.spec.modules.values()) + [disc]:
        convert_batchnorm(module)
    state = TrainState(optimizers={**make_optimizers(seg.spec, cfg),
                                   DISC_PART: make_disc_optimizer(disc)})
    step = make_fada_train_step(seg, disc, cfg, STEPS_PER_EPOCH, state)
    metrics = step({k: torch.from_numpy(v) for k, v in src.items()},
                   {k: torch.from_numpy(v) for k, v in tgt.items()}, 0.0)
    return seg, disc, metrics


def flat_state(prefix: str, modules) -> dict:
    return {f"{prefix}/{name}/{key}": value.detach().float().numpy()
            for name, module in modules.items()
            for key, value in module.state_dict().items()}


# -- cases -------------------------------------------------------------------------------

def case_units(rank: int, world: int, out_dir: str) -> dict:
    out = {}
    inp = bn_inputs()
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        bn = CrossRankBatchNorm2d(BN_SHAPE[1])
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(inp["weight"]))
            bn.bias.copy_(torch.from_numpy(inp["bias"]))
            bn.running_mean.copy_(torch.from_numpy(inp["mean"]))
            bn.running_var.copy_(torch.from_numpy(inp["var"]))
        x = torch.from_numpy(rows({"x": inp["x"]}, rank, world)["x"]).to(dtype)
        x.requires_grad_(True)
        g = torch.from_numpy(rows({"g": inp["g"]}, rank, world)["g"])
        y = bn.train()(x)
        (y.float() * g).sum().backward()
        out.update({f"bn/{name}/y": y.detach().float().numpy(),
                    f"bn/{name}/dx": x.grad.float().numpy(),
                    f"bn/{name}/dweight": bn.weight.grad.numpy(),
                    f"bn/{name}/dbias": bn.bias.grad.numpy(),
                    f"bn/{name}/running_mean": bn.running_mean.numpy(),
                    f"bn/{name}/running_var": bn.running_var.numpy(),
                    f"bn/{name}/out_dtype": np.array(str(y.dtype))})

    inp = rows(loss_inputs(), rank, world)
    cases = {
        "ce": (lambda t: losses.cross_entropy(t, torch.from_numpy(inp["label"]), 255,
                                              across_ranks=True), "logits"),
        "tversky": (lambda t: losses.tversky_loss(t, torch.from_numpy(inp["soft"]),
                                                  across_ranks=True), "logits"),
        "bce": (lambda t: losses.bce_with_logits(t, torch.from_numpy(inp["soft"])), "logits"),
        "soft_ce": (lambda t: losses.soft_label_cross_entropy(
            t, torch.from_numpy(inp["soft"])), "logits"),
        "structure": (lambda t: losses.structure_loss(t, torch.from_numpy(inp["mask"])),
                      "pred1"),
    }
    for name, (fn, key) in cases.items():
        t = torch.from_numpy(inp[key]).requires_grad_(True)
        value = fn(t)
        value.backward()
        out[f"loss/{name}/value"] = value.detach().numpy()
        out[f"loss/{name}/grad"] = t.grad.numpy()
    return out


def case_steps(rank: int, world: int, out_dir: str) -> dict:
    out = {}
    cfg = port_cfg(*DEEPLAB_OPTS)
    seg, metrics = src_step(cfg, rows(step_batch(5), rank, world))
    out.update(flat_state("deeplab", seg.spec.modules))
    out["deeplab/loss"] = np.array(metrics["loss"])

    cfg = port_cfg(*ATTN_OPTS)
    for tag, drop in (("attn", False), ("attn_drop", True)):
        seg, metrics = src_step(cfg, rows(step_batch(2, seed=12), rank, world), drop)
        out.update(flat_state(tag, seg.spec.modules))
        out[f"{tag}/loss"] = np.array(metrics["loss"])

    cfg = port_cfg(*FADA_OPTS)
    src, tgt = fada_batches(3)
    seg, disc, metrics = fada_step(cfg, rows(src, rank, world), rows(tgt, rank, world))
    out.update(flat_state("fada", {**seg.spec.modules, "model_D": disc}))
    for key, value in metrics.items():
        out[f"fada/metric/{key}"] = np.array(value)

    trainer = train_run(os.path.join(out_dir, "train"), "DIST.INITIALIZE", "True")
    out.update(flat_state("trainer", trainer.spec.modules))
    out["trainer/loss"] = np.array(trainer.loss_data)
    out["trainer/blocked_ms"] = np.array(trainer.save_blocked_ms)
    out["trainer/output_dir"] = np.array(trainer.cfg.OUTPUT_DIR)
    return out


def train_run(out_dir: str, *opts):
    """``cli.train_src``'s trainer: deeplab_resnet18 with trainable BatchNorm
    on 8 synthetic images at 64x64, global batch 4, 2 epochs, a checkpoint
    each epoch written in the background, 2 kept.  The aspp augmentation
    runs on the device (flips and jitter drawn per step for the global
    batch); the host's would draw from each process's ``random``."""
    from rnd_semantic_segmentation_torch.cli import train_src

    cfg = port_cfg(*DEEPLAB_OPTS, "DATASETS.SOURCE_TRAIN", "synthetic_train",
                   "INPUT.SOURCE_INPUT_SIZE_TRAIN", f"({STEP_SIZE}, {STEP_SIZE})",
                   "SOLVER.BATCH_SIZE", "4", "DATASETS.SYNTHETIC_LENGTH", "8",
                   "SOLVER.CHECKPOINT_PERIOD", "1", "SOLVER.KEEP_CHECKPOINTS", "2",
                   "SOLVER.ASYNC_CHECKPOINT", "True", "DATA_PIPE.NUM_WORKERS", "1",
                   "AUG.NAME", "aspp", "DATA_PIPE.DEVICE_AUG", "True",
                   "INPUT.HORIZONTAL_FLIP_PROB_TRAIN", "0.5", "INPUT.BRIGHTNESS", "0.3",
                   "OUTPUT_DIR", out_dir, *opts)
    trainer = train_src.make_trainer("deeplab", cfg, logger=logging.getLogger("dist_train"))
    trainer.train()
    trainer.train_loader.close()
    return trainer


def case_eval(rank: int, world: int, out_dir: str, config: str, ckpt: str,
              length: str) -> dict:
    """``cli.test``'s tester on ``length`` synthetic images, TEST.BATCH_SIZE 4,
    with ``--saveres``; then ``TEST.QUANT int8``."""
    from rnd_semantic_segmentation_torch.cli import test as test_cli

    out = {}
    for tag, quant in (("float32", "none"), ("int8", "int8")):
        cfg = eval_cfg(config, out_dir, ckpt, length, "TEST.QUANT", quant,
                       "OUTPUT_DIR", os.path.join(out_dir, tag))
        tester = test_cli.make_tester(cfg, RENDER, saveres=tag == "float32")
        summary = tester.test()
        out.update({f"{tag}/{k}": np.array(v) for k, v in summary.items()})
        out[f"{tag}/confusion"] = np.asarray(tester.confusion)
        report = getattr(tester, "quant_report", {})
        out[f"{tag}/reason"] = np.array(report.get("reason", ""))
        out[f"{tag}/mode"] = np.array(report.get("mode", ""))
        tester.test_loader.close()
    return out


RENDER = {"name": "dist_synthetic", "palette": [0, 0, 0, 255, 0, 0, 0, 255, 0],
          "trainid2name": {"0": "a", "1": "b", "2": "c"}}


def eval_cfg(config: str, out_dir: str, ckpt: str, length: str, *opts):
    cfg = get_default_cfg()
    cfg.merge_from_file(config)
    cfg.merge_from_list(["MODEL.DEVICE", "cpu", "MODEL.NAME", "deeplab_resnet18",
                         "MODEL.NUM_CLASSES", "3", "DATASETS.TEST", "synthetic_val",
                         "DATASETS.SYNTHETIC_LENGTH", length, "INPUT.INPUT_SIZE_TEST",
                         "(48, 40)", "TEST.BATCH_SIZE", "4", "DATA_PIPE.NUM_WORKERS", "1",
                         "PSEUDO_DIR", os.path.join(out_dir, "pseudo"), "resume", ckpt,
                         "DIST.INITIALIZE", "True", *opts])
    return cfg


CASES = {"units": case_units, "steps": case_steps, "eval": case_eval}


# -- the test's side ---------------------------------------------------------------------------

def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_world(case: str, out_dir: str, *args: str, world: int = 2, timeout: float = 300.0):
    """Runs ``case`` in a world of ``world`` processes; returns each rank's
    results (a dict of arrays a rank).  Every process is killed when the
    world has not ended within ``timeout`` seconds, and the call raises."""
    import subprocess
    import time

    port = str(free_port())
    env = {**os.environ, "OMP_NUM_THREADS": "2", "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), case, out_dir,
                               str(r), str(world), port, *args],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise RuntimeError(f"the world of {world} running {case!r} passed {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {case!r} exited {p.returncode}:\n{log[-4000:]}")
    results = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"{case}_rank{r}.npz")) as npz:
            results.append({k: npz[k] for k in npz.files})
    return results, logs


def main(argv) -> int:
    case, out_dir, rank, world, port, *args = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    logging.basicConfig(level=logging.WARNING)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        results = CASES[case](rank, world, out_dir, *args)
        np.savez(os.path.join(out_dir, f"{case}_rank{rank}.npz"), **results)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
