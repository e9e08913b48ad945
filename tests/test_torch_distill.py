"""The port's offline self-distillation recipe (eval/palette.py, the
``saveres`` branch of ``Tester.test``, cli/train_distill.py) and FADA's
checkpoint retention, against the JAX package's, on the CPU.

One module-scoped run goes through the recipe as its users run it, from
files: ``cli.train_adv`` (GTA5 -> Cityscapes, deeplab_resnet18 at 64x64,
three epochs with SOLVER.KEEP_CHECKPOINTS 1), ``cli.test --saveres`` with the
last ``AsppFada-3.pth`` on ``cityscapes_train``, then ``cli.train_distill`` over
``cityscapes_self_distill_train``, whose labels are the PNGs just written.
The PNGs are compared by their decoded indices and palette, never by their
bytes: PIL and the JAX package's libpng writer may encode the same image
differently.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.data.catalog import build_dataset as jax_build_dataset
from rnd_semantic_segmentation_tpu.eval.palette import save_pseudo_label as jax_save_pseudo_label

from rnd_semantic_segmentation_torch.cli import test as test_cli
from rnd_semantic_segmentation_torch.cli import train_adv, train_distill
from rnd_semantic_segmentation_torch.cli.common import load_cfg
from rnd_semantic_segmentation_torch.data import DataLoader, build_dataset, trees
from rnd_semantic_segmentation_torch.eval.palette import save_pseudo_label
from rnd_semantic_segmentation_torch.utils import load_json

torch.set_num_threads(2)  # six test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDER = os.path.join(REPO, "renders", "cityscapes.json")
TREES = {"gta5": (4, 1, (72, 40)), "cityscapes": (4, 2, (64, 32))}


def _decode(path):
    img = Image.open(path)
    return img.mode, np.asarray(img), img.getpalette()


def test_save_pseudo_label_matches_the_jax_one(tmp_path):
    rng = np.random.RandomState(0)
    for render in ("cityscapes.json", "bli.json"):
        palette = load_json(os.path.join(REPO, "renders", render))["palette"]
        for i, shape in enumerate([(32, 64), (7, 5), (1, 3)]):
            pred = rng.randint(0, 19 if render[0] == "c" else 2, shape)
            name = f"img{i}_leftImg8bit"
            got = save_pseudo_label(pred, palette, str(tmp_path / "port"), "ds", name)
            ref = jax_save_pseudo_label(pred, palette, str(tmp_path / "jax"), "ds", name + ".png")
            assert got == str(tmp_path / "port" / "inference" / "ds" / f"{name}.png")
            assert os.path.basename(ref) == os.path.basename(got)
            (mode, indices, pal), (rmode, rindices, rpal) = _decode(got), _decode(ref)
            assert mode == rmode == "P" and pal[:len(palette)] == palette
            assert pal[:len(palette)] == rpal[:len(palette)]
            np.testing.assert_array_equal(indices, rindices)
            np.testing.assert_array_equal(indices, pred)


def _opts(root, out_dir, config, *more):
    return ["-cfg", os.path.join(REPO, "configs", config), "MODEL.NAME", "deeplab_resnet18",
            "MODEL.DEVICE", "cpu", "DATASETS.DATASET_DIR", str(root),
            "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(64, 64)", "INPUT.TARGET_INPUT_SIZE_TRAIN",
            "(64, 32)", "INPUT.INPUT_SIZE_TEST", "(64, 32)", "DATA_PIPE.NUM_WORKERS", "2",
            "OUTPUT_DIR", str(out_dir), *more]


def _run_cli(module, argv):
    saved = sys.argv
    sys.argv = [module.__name__] + argv
    try:
        return module.cli()
    finally:
        sys.argv = saved


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    trees.write_dataset_trees(str(root), seed=4, trees=TREES)
    fada, distill = root / "fada", root / "distill"
    _run_cli(train_adv, _opts(root, fada, "deeplabv2_r101_adv.yaml", "SOLVER.BATCH_SIZE", "4",
                              "SOLVER.EPOCHS", "3", "SOLVER.KEEP_CHECKPOINTS", "1"))
    pseudo = root / "cityscapes" / "soft_labels"
    test_args = ["-c", RENDER] + _opts(root, fada, "deeplabv2_r101_adv.yaml",
                                       "DATASETS.TEST", "cityscapes_train", "PSEUDO_DIR",
                                       str(pseudo), "resume", str(fada / "AsppFada-3.pth"))
    _run_cli(test_cli, ["--saveres"] + test_args)
    distill_opts = _opts(root, distill, "deeplabv2_r101_tgt_self_distill.yaml",
                         "SOLVER.BATCH_SIZE", "2", "SOLVER.EPOCHS", "1",
                         "SOLVER.CHECKPOINT_PERIOD", "1")
    _run_cli(train_distill, distill_opts)
    return {"root": root, "fada": fada, "distill": distill, "test_args": test_args,
            "distill_opts": distill_opts,
            "labels": pseudo / "inference" / "cityscapes_train"}


def test_fada_keeps_every_checkpoint_as_the_jax_trainer_does(recipe):
    """SOLVER.KEEP_CHECKPOINTS 1 prunes the source trainer's checkpoints
    (to two while the newest is written, so a third epoch shows it), never
    FADA's: all three epochs' AsppFada files stay."""
    assert sorted(p.name for p in recipe["fada"].glob("*.pth")) == [
        "AsppFada-1.pth", "AsppFada-2.pth", "AsppFada-3.pth"]
    chart = json.loads((recipe["fada"] / "deeplab_fada_chart_params.json").read_text())
    assert len(chart["segmentation loss"]) == 6 and all(np.isfinite(chart["segmentation loss"]))


def test_saveres_writes_each_prediction_as_the_jax_function_would(recipe, tmp_path):
    """One P-mode PNG an image at the label's size (64x32: the test transform
    resizes the image only), the render config's palette, the indices of the
    argmax of a plain ``Tester`` forward of the same image; the JAX
    ``save_pseudo_label`` of that argmax decodes to the same indices and
    palette."""
    palette = load_json(RENDER)["palette"]
    args = test_cli.build_parser().parse_args(recipe["test_args"])
    tester = test_cli.make_tester(load_cfg(args), load_json(RENDER))
    written = sorted(os.listdir(recipe["labels"]))
    assert len(written) == 4
    seen = []
    for batch in tester.test_loader:
        x = torch.from_numpy(batch["image"]).permute(0, 3, 1, 2).contiguous()
        preds = tester._probs_impl(x, tuple(batch["label"].shape[1:3])).argmax(1).numpy()
        for pred, name in zip(preds, batch["name"]):
            seen.append(f"{name}.png")
            mode, indices, pal = _decode(recipe["labels"] / f"{name}.png")
            assert mode == "P" and indices.shape == (32, 64) and pal[:len(palette)] == palette
            np.testing.assert_array_equal(indices, pred)
            ref = jax_save_pseudo_label(pred, palette, str(tmp_path), "cityscapes_train", name)
            _, rindices, rpal = _decode(ref)
            np.testing.assert_array_equal(indices, rindices)
            assert rpal[:len(palette)] == palette
    assert sorted(seen) == written


def test_train_distill_trains_on_the_pseudo_labels(recipe):
    """Two steps of batch 2 from the exported PNGs; the self-distill reader
    gives each PNG's indices as labels (identity over the train ids), as the
    JAX reader does, and a batch holds only those ids or 255 (the crop's
    padding)."""
    chart = json.loads((recipe["distill"] / "deeplab_chart_params.json").read_text())
    assert len(chart["loss"]) == 2 and all(np.isfinite(chart["loss"]))
    assert chart["learning rate"][0] == 5e-4
    assert (recipe["distill"] / "Aspp-1.pth").exists()
    args = train_distill.build_parser().parse_args(recipe["distill_opts"])
    cfg = load_cfg(args)
    jcfg = jax_default_cfg()
    jcfg.merge_from_file(args.config_file)
    jcfg.merge_from_list(args.opts)
    plain = [c.clone() for c in (cfg, jcfg)]
    for c in plain:
        c.defrost()
        c.merge_from_list(["AUG.NAME", "gald"])
    ours, theirs = build_dataset(plain[0], "train"), jax_build_dataset(plain[1], "train")
    ids = set()
    for i in range(len(theirs)):
        (image, label, name), ref = ours[i], theirs[i]
        assert name == ref[2] and label.dtype == ref[1].dtype == np.float32
        np.testing.assert_array_equal(image, ref[0])
        np.testing.assert_array_equal(label, ref[1])
        np.testing.assert_array_equal(label, _decode(recipe["labels"] / f"{name}.png")[1])
        ids |= set(np.unique(label).tolist())
    batch = next(iter(DataLoader(build_dataset(cfg, "train"), batch_size=2, seed=1)))
    assert batch["label"].shape == (2, 64, 64)
    assert set(np.unique(batch["label"]).tolist()) <= ids | {255}


def test_online_distillation_raises(recipe):
    """Online distillation runs since its slice (tests/test_torch_distill_online.py);
    from an Orbax directory of the JAX package as the teacher it raises."""
    opts = recipe["distill_opts"] + ["DISTILL.ONLINE", "True", "DISTILL.TEACHER",
                                     str(recipe["fada"])]
    with pytest.raises(NotImplementedError, match="DISTILL.ONLINE"):
        _run_cli(train_distill, opts)
