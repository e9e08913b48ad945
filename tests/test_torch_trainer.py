"""The port's source-training entry point, end to end on the CPU at a tiny size:
``cli/train_src.py`` -> ``Trainer`` -> checkpoints -> ``resume latest`` ->
``Tester``.  GALD at 224x224, 3 classes, batch 2, 4 synthetic images, so an
epoch is 2 steps.
"""

import json
import os
import random
import shutil
import subprocess
import sys

import pytest
import torch

from rnd_semantic_segmentation_torch.ckpt.checkpoint_io import (
    checkpoint_name,
    latest_checkpoint,
    prune_checkpoints,
)
from rnd_semantic_segmentation_torch.ckpt.torch_import import load_reference_checkpoint
from rnd_semantic_segmentation_torch.cli import train_src
from rnd_semantic_segmentation_torch.cli.common import load_cfg
from rnd_semantic_segmentation_torch.eval.tester import Tester

torch.set_num_threads(2)  # six test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS, STEPS_PER_EPOCH = 3, 2


def _args(out_dir, *opts):
    return ["-cfg", os.path.join(REPO, "configs", "gald_src.yaml"),
            "MODEL.DEVICE", "cpu", "MODEL.NUM_CLASSES", "3",
            "DATASETS.SOURCE_TRAIN", "synthetic_train", "DATASETS.SYNTHETIC_LENGTH", "4",
            "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(224, 224)", "SOLVER.BATCH_SIZE", "2",
            "SOLVER.EPOCHS", str(EPOCHS), "SOLVER.CHECKPOINT_PERIOD", "1",
            "SOLVER.KEEP_CHECKPOINTS", "2", "DATA_PIPE.NUM_WORKERS", "2",
            "OUTPUT_DIR", str(out_dir), *opts]


def _cfg(out_dir, *opts):
    return load_cfg(train_src.build_parser().parse_args(_args(out_dir, *opts)))


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """Three epochs through the CLI's own ``cli()``; yields its directory and
    its loss and LR series, and removes the checkpoints afterwards."""
    out_dir = tmp_path_factory.mktemp("train_full")
    argv = sys.argv
    sys.argv = ["train_src"] + _args(out_dir)
    try:
        train_src.cli()
    finally:
        sys.argv = argv
    with open(out_dir / "gald_chart_params.json") as fh:
        chart = json.load(fh)
    yield out_dir, chart
    shutil.rmtree(out_dir, ignore_errors=True)


def test_cli_trains_and_writes_its_outputs(full_run):
    out_dir, chart = full_run
    losses, lrs = chart["loss"], chart["learning rate"]
    assert len(losses) == len(lrs) == EPOCHS * STEPS_PER_EPOCH
    assert all(l == l and abs(l) < 1e4 for l in losses)
    assert lrs[0] == 1e-4 and all(a > b for a, b in zip(lrs, lrs[1:]))  # poly decay
    assert "gald_hardnet68" in (out_dir / "config.yaml").read_text()
    assert "iter: 6" in (out_dir / "gald_train.txt").read_text()  # the last-iteration line


def test_checkpoints_are_pruned_to_keep_checkpoints(full_run):
    out_dir, _ = full_run
    found = sorted(p.name for p in out_dir.glob("Gald-*.pth"))
    assert found == ["Gald-2.pth", "Gald-3.pth"]
    assert latest_checkpoint(str(out_dir), "Gald") == str(out_dir / "Gald-3.pth")
    assert checkpoint_name("x", "Gald", 12) == os.path.join("x", "Gald-12.pth")
    assert not list(out_dir.glob("*.tmp"))


def test_checkpoint_loads_with_weights_only_and_holds_the_reference_layout(full_run):
    out_dir, _ = full_run
    ckpt = torch.load(out_dir / "Gald-2.pth", map_location="cpu", weights_only=True)
    assert set(ckpt) == {"encoder", "decoder", "optimizer_encoder", "optimizer_decoder",
                         "epoch", "step"}
    assert ckpt["epoch"] == 2 and ckpt["step"] == 2 * STEPS_PER_EPOCH
    assert "long_relation.gamma" in ckpt["decoder"]
    assert len(ckpt["optimizer_decoder"]["state"]) == len(
        [k for k in ckpt["decoder"] if not ("running_" in k or "num_batches" in k)])
    parts = load_reference_checkpoint(str(out_dir / "Gald-2.pth"))
    assert set(parts) == {"encoder", "decoder"}  # exactly the model parts


def test_resume_latest_continues_where_the_run_was(full_run, tmp_path):
    """A directory that holds only the epoch-2 checkpoint, as after a run cut
    during epoch 3: ``resume latest`` starts at epoch 3, step 4, and its two
    steps repeat the uninterrupted run's losses and LRs."""
    out_dir, chart = full_run
    os.link(out_dir / "Gald-2.pth", tmp_path / "Gald-2.pth")
    trainer = train_src.make_trainer("gald", _cfg(tmp_path, "resume", "latest"))
    assert trainer.start_epoch == 3 and trainer.state.step == 2 * STEPS_PER_EPOCH
    adam = trainer.state.optimizers["decoder"]
    assert all(int(s["step"]) == 2 * STEPS_PER_EPOCH for s in adam.state.values())
    trainer.train()
    assert trainer.state.step == EPOCHS * STEPS_PER_EPOCH
    assert trainer.lr_data == pytest.approx(chart["learning rate"][-STEPS_PER_EPOCH:], rel=1e-12)
    # the same arithmetic on the same CPU: equal but for thread scheduling in reductions
    assert trainer.loss_data == pytest.approx(chart["loss"][-STEPS_PER_EPOCH:], rel=1e-5)
    assert sorted(p.name for p in tmp_path.glob("Gald-*.pth")) == ["Gald-2.pth", "Gald-3.pth"]
    for p in tmp_path.glob("Gald-*.pth"):
        p.unlink()


def test_tester_resumes_latest(full_run):
    import logging

    out_dir, _ = full_run
    tester = Tester(_cfg(out_dir, "resume", "latest"), logging.getLogger("torch_trainer"))
    tester._load_checkpoint()
    ckpt = torch.load(out_dir / "Gald-3.pth", map_location="cpu", weights_only=True)
    for part, module in tester.spec.modules.items():
        for key, value in module.state_dict().items():
            assert torch.equal(value, ckpt[part][key]), (part, key)
    x = torch.rand(1, 3, 224, 224, generator=torch.Generator().manual_seed(0))
    probs = tester._probs_impl(x, (224, 224))
    assert probs.shape == (1, 3, 224, 224) and torch.isfinite(probs).all()
    assert not tester.segmentor.training
    empty = Tester(_cfg(out_dir / "nothing_here", "resume", "latest"),
                   logging.getLogger("torch_trainer"))
    with pytest.raises(FileNotFoundError):
        empty._load_checkpoint()


def test_prune_checkpoints(tmp_path):
    for epoch in (1, 2, 10):
        (tmp_path / f"Gald-{epoch}.pth").write_bytes(b"x")
    (tmp_path / "GaldFada-3.pth").write_bytes(b"x")
    prune_checkpoints(str(tmp_path), "Gald", -1)
    assert len(list(tmp_path.iterdir())) == 4
    prune_checkpoints(str(tmp_path), "Gald", 2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["Gald-10.pth", "Gald-2.pth",
                                                         "GaldFada-3.pth"]
    assert latest_checkpoint(str(tmp_path), "Gald") == str(tmp_path / "Gald-10.pth")
    prune_checkpoints(str(tmp_path), "Gald", 0)
    assert [p.name for p in tmp_path.iterdir()] == ["GaldFada-3.pth"]
    assert latest_checkpoint(str(tmp_path), "Gald") is None
    assert latest_checkpoint(str(tmp_path / "missing"), "Gald") is None


@pytest.mark.parametrize("opts", [
    ("MODEL.WEIGHTS", "hardnet68.pth"),
    ("DIST.SPATIAL_PARALLEL", "2"),
    ("MODEL.DTYPE", "float16"),  # the kernels take float32 and bfloat16 only
    # HarDNet85 is ported but has no taps, in the JAX package too: GALD's
    # decoder reads HarDNet68's four
    ("MODEL.NAME", "gald_hardnet85"),
], ids=lambda o: o[0])
def test_every_knob_that_waits_raises(tmp_path, opts):
    if opts[0] == "MODEL.WEIGHTS":
        # no longer waits: a seeded hardnet68-layout file is the encoder's start
        _knob_loads_a_seeded_hardnet68(tmp_path, opts[1])
        return
    with pytest.raises(NotImplementedError):
        train_src.make_trainer("gald", _cfg(tmp_path, *opts))
    assert not list(tmp_path.glob("*.pth"))


# the knobs that waited until the zoo slice, with the value that makes each
# act: DEBUG.CHECKIFY's float checks, and the JAX package's exact conv
# rewrites, space-to-depth on HarDNet's stem and narrow convs (64 channels at
# most) and sub-pixel on the attn decoder's transposed convs (GALD has none)
ZOO_SLICE_KNOBS = {
    "DEBUG.CHECKIFY": (("DEBUG.CHECKIFY", "True"), ()),
    "MODEL.S2D_MAX_CHANNELS": (("MODEL.S2D_MAX_CHANNELS", "64"), ()),
    "MODEL.SUBPIXEL_DECONV": (("MODEL.SUBPIXEL_DECONV", "True"),
                              ("MODEL.NAME", "attn_efficientnet-b0", "AUG.NAME", "attn",
                               "AUG.COLLATE", "attn")),
}
KNOB_REL = 2e-4  # the JAX package's whole-model tolerance of the rewrites


@pytest.mark.parametrize("knob", ["DEBUG.CHECKIFY", "MODEL.S2D_MAX_CHANNELS",
                                  "MODEL.SUBPIXEL_DECONV"])
def test_the_knobs_of_the_zoo_slice_train_like_the_knob_off(tmp_path, knob):
    """They raised until the zoo slice; now an epoch (2 steps) trains with
    each.  DEBUG.CHECKIFY gives the same losses and weights bit for bit (in
    the config's bfloat16); a rewrite gives a first loss within 2e-4 of the
    knob off's in float32 (in bfloat16 the rewritten sums round apart by
    1e-3; the second loss follows Adam's first update, the LR times the sign
    of each gradient element, which a rounding flip of a near-zero element
    turns around: 1.4e-3 apart for S2D on GALD)."""
    setting, family = ZOO_SLICE_KNOBS[knob]
    dtype = () if knob == "DEBUG.CHECKIFY" else ("MODEL.DTYPE", "float32")
    runs = []
    for on in (False, True):
        out = tmp_path / ("on" if on else "off")
        # the attn augmentation draws from the random module: one loader
        # thread, seeded, gives both runs the same batches
        random.seed(0)
        trainer = train_src.make_trainer("gald", _cfg(
            out, *family, *dtype, *(setting if on else ()), "SOLVER.EPOCHS", "1",
            "SOLVER.CHECKPOINT_PERIOD", "5", "DATA_PIPE.NUM_WORKERS", "0"))
        trainer.train()
        runs.append((trainer.loss_data, {n: p.detach().clone() for m in
                                         trainer.spec.modules.values()
                                         for n, p in m.named_parameters()}))
    (off, w_off), (on, w_on) = runs
    assert len(off) == len(on) == STEPS_PER_EPOCH
    if knob == "DEBUG.CHECKIFY":
        assert off == on and all(torch.equal(w_on[n], w) for n, w in w_off.items())
    else:
        assert abs(on[0] - off[0]) <= KNOB_REL * abs(off[0])


@pytest.mark.parametrize("knob", ["MODEL.S2D_MAX_CHANNELS", "MODEL.SUBPIXEL_DECONV"])
def test_the_rewrites_evaluate_and_serve_like_the_knob_off(tmp_path, knob):
    """``build_segmentor`` refused the rewrites until the zoo slice, so eval
    and serving did too; now the Tester's logits with the knob are within
    2e-4 of their magnitude of the knob off, and the server's masks agree
    with the knob off's but on at most 2e-4 of the pixels."""
    import io
    import logging

    import numpy as np
    from PIL import Image

    from rnd_semantic_segmentation_torch.ckpt.torch_import import save_reference_checkpoint
    from rnd_semantic_segmentation_torch.models.build import randomize_weights_
    from rnd_semantic_segmentation_torch.serve.server import make_server

    setting, family = ZOO_SLICE_KNOBS[knob]
    family = family or ("AUG.NAME", "gald")
    logger = logging.getLogger("torch_trainer")
    pth = str(tmp_path / "seeded.pth")
    base = (*family, "INPUT.INPUT_SIZE_TEST", "(224, 224)", "resume", pth)
    seeded = Tester(_cfg(tmp_path, *base), logger)
    randomize_weights_(seeded.segmentor, seed=5)
    save_reference_checkpoint(seeded.spec.modules, pth)
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 3, 224, 224).astype(np.float32))
    arr = (np.random.RandomState(4).rand(224, 224, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    logits, masks = [], []
    for opts in (base, (*base, *setting)):
        cfg = _cfg(tmp_path, *opts)
        tester = Tester(cfg, logger)
        tester._load_checkpoint()
        with torch.no_grad():
            logits.append(tester.segmentor(x)[0][0])
        inf, httpd = make_server(cfg, {"name": "gald"}, logger, port=0)
        try:
            assert inf.ready.wait(300)
            masks.append(inf.predict(buf.getvalue()))
        finally:
            httpd.server_close()
            inf.shutdown()
    off, on = logits
    assert (on - off).abs().max() <= KNOB_REL * off.abs().max()
    assert masks[0].shape == (224, 224)
    assert (masks[0] != masks[1]).mean() <= KNOB_REL


def _knob_loads_a_seeded_hardnet68(tmp_path, name):
    from rnd_semantic_segmentation_torch.models.build import randomize_weights_
    from rnd_semantic_segmentation_torch.models.gcpa import GCPAEncoder

    encoder = randomize_weights_(GCPAEncoder(), 3)
    published = {k[len("hardnet."):]: v for k, v in encoder.state_dict().items()
                 if "num_batches_tracked" not in k}
    torch.save({**published, "base.19.3.weight": torch.zeros(1000, 1024)}, tmp_path / name)
    trainer = train_src.make_trainer("gald", _cfg(tmp_path, "MODEL.WEIGHTS",
                                                  str(tmp_path / name)))
    loaded = trainer.segmentor.parts["encoder"].state_dict()
    for key, value in published.items():
        assert torch.equal(loaded["hardnet." + key], value), key
    assert trainer.start_epoch == 1 and trainer.state.step == 0


@pytest.fixture
def world_of_one(monkeypatch):
    """``torchrun``'s variables for a world of one; the group it starts is
    ended afterwards."""
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                       ("MASTER_ADDR", "127.0.0.1")):
        monkeypatch.setenv(key, value)
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        monkeypatch.setenv("MASTER_PORT", str(sock.getsockname()[1]))
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("opts", [
    ("SOLVER.ASYNC_CHECKPOINT", "True"),
    ("DIST.NUM_DEVICES", "1"),
    ("DIST.INITIALIZE", "True"),
    ("DATA_PIPE.NATIVE_DECODE", "True"),
], ids=lambda o: o[0])
def test_knobs_the_parallelism_slice_ported_build_a_trainer(tmp_path, world_of_one, opts):
    """Async checkpoints, the DIST knobs (a world of one process here) and the
    native decoder waited until the parallelism slice; they build a trainer
    now.  DIST.NUM_DEVICES other than 0 or the world size raises."""
    trainer = train_src.make_trainer("gald", _cfg(tmp_path, *opts))
    assert (trainer.ckpt_writer is not None) == (opts[0] == "SOLVER.ASYNC_CHECKPOINT")
    assert trainer.train_loader.dataset.use_native_decode == (opts[0] == "DATA_PIPE.NATIVE_DECODE")
    assert torch.distributed.is_initialized() == (opts[0] == "DIST.INITIALIZE")
    assert trainer.world == 1
    with pytest.raises(ValueError, match="NUM_DEVICES"):
        train_src.make_trainer("gald", _cfg(tmp_path, *opts, "DIST.NUM_DEVICES", "4"))


@pytest.mark.parametrize("opts", [
    ("SOLVER.BN_RECAL_BATCHES", "2"),
    ("DATA_PIPE.DEVICE_AUG", "True"),
], ids=lambda o: o[0])
def test_knobs_the_distillation_slice_ported_build_a_trainer(tmp_path, opts):
    """BN recalibration and device augmentation waited until the online
    distillation slice; they build a trainer now."""
    trainer = train_src.make_trainer("gald", _cfg(tmp_path, *opts))
    assert (trainer.device_augs is not None) == (opts[0] == "DATA_PIPE.DEVICE_AUG")
    assert trainer.cfg.SOLVER.BN_RECAL_BATCHES == (2 if opts[0].startswith("SOLVER") else 0)


@pytest.mark.parametrize("opts", [
    ("SOLVER.REMAT", "full"),
    ("MODEL.REMAT_BLOCKS", "True"),
], ids=lambda o: o[0])
def test_knobs_the_precision_slice_ported_build_a_trainer(tmp_path, opts):
    """Rematerialisation waited until the precision slice; it builds a
    trainer now, MODEL.REMAT_BLOCKS with every HarDBlock turned on."""
    from rnd_semantic_segmentation_torch.models.hardnet import HarDBlock

    trainer = train_src.make_trainer("gald", _cfg(tmp_path, *opts))
    blocks = [m for m in trainer.segmentor.modules() if isinstance(m, HarDBlock)]
    assert len(blocks) == 5
    assert all(b.remat == (opts[0] == "MODEL.REMAT_BLOCKS") for b in blocks)


@pytest.mark.parametrize("opts", [
    ("DATA_PIPE.WORKER_PROCESSES", "2"),
    ("DATASETS.SOURCE_TRAIN", "gta5_train"),
    ("AUG.NAME", "pra"),
], ids=lambda o: o[0])
def test_knobs_the_data_slice_ported_reach_the_trainer(tmp_path, opts):
    """What waited for the data slice builds a trainer now: worker processes
    behind its loader, the GTA5 reader on files, the pra transform."""
    from rnd_semantic_segmentation_torch.data import datasets, trees

    trees.write_dataset_trees(str(tmp_path), seed=0, trees={"gta5": (2, 1, (64, 48))})
    trainer = train_src.make_trainer("gald", _cfg(tmp_path, "DATASETS.DATASET_DIR",
                                                  str(tmp_path), "INPUT.TRAINSIZE", "32",
                                                  *opts))
    loader = trainer.train_loader
    try:
        batch = next(iter(loader))
        if opts[0] == "DATA_PIPE.WORKER_PROCESSES":
            assert loader._pool is not None and len(loader._pool._procs) == 2
            assert batch["image"].shape == (2, 224, 224, 3)
        elif opts[0] == "DATASETS.SOURCE_TRAIN":
            assert isinstance(loader.dataset, datasets.GTA5FoldDataSet) and len(loader) == 1
            assert batch["image"].shape == (2, 48, 64, 3) and batch["image"].max() <= 1
        else:
            assert batch["image"].shape == (2, 32, 32, 3) and batch["image"].min() < 0
    finally:
        loader.close()


def test_cuda_is_the_default_device_and_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device resolves")
    args = [a for a in _args(tmp_path) if a not in ("MODEL.DEVICE", "cpu")]
    cfg = load_cfg(train_src.build_parser().parse_args(args))
    assert cfg.MODEL.DEVICE == "cuda"
    with pytest.raises(RuntimeError, match="MODEL.DEVICE"):
        train_src.make_trainer("gald", cfg)


def test_training_entry_point_imports_without_jax():
    code = (
        "import sys\n"
        "import rnd_semantic_segmentation_torch.cli.train_src\n"
        "import rnd_semantic_segmentation_torch.train.trainer\n"
        "import rnd_semantic_segmentation_torch.ckpt.checkpoint_io\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "              'rnd_semantic_segmentation_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
