"""The port's eval extras against the JAX package's, on the CPU: the PR
curves (eval/pr_curves.py), the plots and mask helpers (utils/plots.py), the
TensorBoard writer (utils/tb_writer.py), and the inference, demo and
visualize CLIs.

The PR-curve JSON, the moving average, the mask helpers and the event
records (wall times pinned) must be equal.  The inference CLI runs a seeded
deeplab_resnet18 ``.pth`` at 64x64 that both packages read: its palette PNG
must hold the JAX CLI's class ids on every pixel whose top-2 JAX probability
gap exceeds TIE (the heads agree to 1e-4, tests/test_torch_deeplab.py); under
``TEST.QUANT int8`` both calibrate on the image, with scales equal to 1e-5
(tests/test_torch_quant.py), and the ids must agree on 99.5% of those pixels.
The figures are drawn with Pillow, so they are checked for what they hold,
not against the JAX package's matplotlib figures.
"""

import json
import logging
import os
import time

import numpy as np
import pytest
import torch
from PIL import Image

from rnd_semantic_segmentation_tpu.cli import inference as jax_inference
from rnd_semantic_segmentation_tpu.cli.visualize import moving_average as jax_moving_average
from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.eval import pr_curves as jax_pr
from rnd_semantic_segmentation_tpu.utils import plots as jax_plots
from rnd_semantic_segmentation_tpu.utils import tb_writer as jax_tb

from rnd_semantic_segmentation_torch.ckpt.torch_import import save_reference_checkpoint
from rnd_semantic_segmentation_torch.cli import demo, inference, visualize
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.eval import pr_curves
from rnd_semantic_segmentation_torch.eval.tester import Tester
from rnd_semantic_segmentation_torch.models.build import randomize_weights_
from rnd_semantic_segmentation_torch.utils import plots, tb_writer

torch.set_num_threads(2)  # six test workers share the host's cores

CONFIG = "configs/deeplabv2_r101_src.yaml"
SIZE, NC = 64, 3
TIE = 2e-4
OPTS = ["MODEL.NAME", "deeplab_resnet18", "MODEL.NUM_CLASSES", str(NC),
        "MODEL.DTYPE", "float32", "INPUT.INPUT_SIZE_TEST", f"({SIZE}, {SIZE})"]
RENDER = {"palette": [0, 0, 0, 255, 0, 0, 0, 255, 0],
          "trainid2name": {"0": "road", "1": "car", "2": "sky"}}


# -- numbers ---------------------------------------------------------------------------

def test_pr_curves_equal_the_jax_curves(tmp_path):
    rng = np.random.RandomState(0)
    pred = rng.rand(700, 3).astype(np.float32)
    pred /= pred.sum(1, keepdims=True)
    label = rng.randint(0, 3, 700)
    for c in range(3):
        assert pr_curves.pr_curve(pred[:, c], label == c) == jax_pr.pr_curve(pred[:, c],
                                                                           label == c)
    got = pr_curves.dump_pr_curves(pred, label, RENDER["trainid2name"], str(tmp_path / "p"))
    want = jax_pr.dump_pr_curves(pred, label, RENDER["trainid2name"], str(tmp_path / "j"),
                                 plot=False)
    assert got == want
    assert (json.load(open(tmp_path / "p" / "pr_curves.json"))
            == json.load(open(tmp_path / "j" / "pr_curves.json")))
    assert Image.open(tmp_path / "p" / "pr_curves.png").size == (600, 500)


def test_moving_average_and_mask_helpers_equal_the_jax_ones():
    rng = np.random.RandomState(1)
    series = list(rng.rand(40))
    for window in (1, 5, 40):
        assert visualize.moving_average(series, window) == jax_moving_average(series, window)
    x = rng.randint(0, 256, (7, 9))
    np.testing.assert_array_equal(plots.threshold_mask(x), jax_plots.threshold_mask(x))
    gt, pd = rng.randint(0, 8, (6, 6)), rng.randint(0, 3, (6, 6))
    id_map = {"1": 0, "3": 1, "7": 2}
    for a, b in zip(plots.preds2ignorepreds(id_map, gt, pd),
                    jax_plots.preds2ignorepreds(id_map, gt, pd)):
        np.testing.assert_array_equal(a, b)


def test_event_records_equal_the_jax_writer_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)  # the only difference
    image = (np.random.RandomState(2).rand(5, 7, 3) * 255).astype(np.uint8)
    files = []
    for module, sub in ((tb_writer, "port"), (jax_tb, "jax")):
        writer = module.SummaryWriter(str(tmp_path / sub))
        writer.add_scalar("loss", 0.125, step=3)
        writer.add_image("mask", image, step=4)
        writer.add_image("soft", image / 255.0, step=5)
        writer.close()
        (name,) = os.listdir(tmp_path / sub)
        files.append(open(tmp_path / sub / name, "rb").read())
    assert files[0] == files[1] and len(files[0]) > 200


def test_confusion_heat_map_and_line_chart(tmp_path):
    cm = np.array([[50, 0, 0], [5, 40, 5], [0, 0, 0]])
    path = plots.plot_confusion_matrix(cm, ["road", "car", "sky"],
                                       out_path=str(tmp_path / "sub" / "cm.png"))
    image = np.asarray(Image.open(path).convert("RGB")).astype(int)
    white = (image == 255).all(-1).mean()
    assert 0.2 < white < 0.95  # a heat map with labels, not a blank page
    # the full-row cell is the darkest red the map has; an empty row stays pale
    assert image[..., 0].min() < 120 and (image[..., 1] < 20).any()
    chart = plots.LineChartPlotter("loss", "step", "value", str(tmp_path / "chart.png"))
    chart.add_chart({"x": [0, 1, 2], "y": [1.0, 0.5, 0.25], "label": "loss"})
    chart.display()
    assert Image.open(tmp_path / "chart.png").size == (640, 480)


def test_visualize_cli_writes_the_curves(tmp_path):
    params = {"loss": list(np.linspace(2, 0.1, 30)), "learning rate": [1e-3] * 30}
    json.dump(params, open(tmp_path / "gald_chart_params.json", "w"))
    visualize.cli(["-j", str(tmp_path / "gald_chart_params.json"), "-o",
                   str(tmp_path / "curves.png"), "-w", "4"])
    assert Image.open(tmp_path / "curves.png").size == (2 * 640, 480)


# -- the CLIs --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """Two seeded deeplab_resnet18 ``.pth`` files, two images with labels,
    and a render JSON listing them."""
    tmp = tmp_path_factory.mktemp("torch_eval_extras")
    cfg = _port_cfg(tmp)
    for seed, name in ((41, "a.pth"), (7, "b.pth")):  # seeds whose argmax holds 2+ classes
        t = Tester(cfg, logging.getLogger("eval_extras"))
        randomize_weights_(t.segmentor, seed=seed)
        save_reference_checkpoint(t.spec.modules, str(tmp / name))
    rng = np.random.RandomState(3)
    images, gts = [], []
    for i in range(2):
        images.append(str(tmp / f"img{i}.png"))
        Image.fromarray((rng.rand(SIZE, SIZE, 3) * 255).astype(np.uint8)).save(images[-1])
        gts.append(str(tmp / f"gt{i}.png"))
        Image.fromarray(rng.randint(0, NC, (SIZE, SIZE)).astype(np.uint8)).save(gts[-1])
    (tmp / "images.txt").write_text("\n".join(images) + "\n")
    (tmp / "gts.txt").write_text("\n".join(gts) + "\n")
    render = {**RENDER, "demo_image_path": str(tmp / "images.txt"),
              "demo_groundtruth_path": str(tmp / "gts.txt"),
              "weights": {"first": str(tmp / "a.pth"), "second": str(tmp / "b.pth")},
              "tensorboard": True}
    json.dump(render, open(tmp / "render.json", "w"))
    return tmp, images


def _port_cfg(tmp, *more):
    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(OPTS + ["MODEL.DEVICE", "cpu", "OUTPUT_DIR", str(tmp), *more])
    return cfg


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_inference_cli_palette_png_equals_the_jax_cli(quant, seeded):
    tmp, images = seeded
    out = str(tmp / f"pred_{quant}.png")
    inference.cli(["-cfg", CONFIG, "-i", images[0], "-o", out, "-c", str(tmp / "render.json")]
                  + OPTS + ["MODEL.DEVICE", "cpu", "OUTPUT_DIR", str(tmp / quant),
                            "TEST.QUANT", quant, "resume", str(tmp / "a.pth")])
    png = Image.open(out)
    assert png.mode == "P" and png.getpalette()[:9] == RENDER["palette"]
    got = np.asarray(png)

    jcfg = jax_default_cfg()
    jcfg.merge_from_file(CONFIG)
    jcfg.merge_from_list(OPTS + ["OUTPUT_DIR", str(tmp / "jax"), "TEST.QUANT", quant,
                                 "resume", str(tmp / "a.pth")])
    want, probs = jax_inference.build_predictor(jcfg, logging.getLogger("jax_extras"))(
        images[0], return_probs=True)
    top2 = np.sort(probs, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > TIE
    assert got.shape == want.shape == (SIZE, SIZE) and clear.mean() > 0.99
    assert len(np.unique(want)) > 1
    agree = (got[clear] == want[clear]).mean()
    assert agree == 1.0 if quant == "none" else agree >= 0.995


def test_demo_grid_pr_curves_and_events_under_fake_quantization(seeded):
    tmp, images = seeded
    out_dir = tmp / "demo"
    preds = demo.cli(["-cfg", CONFIG, "-c", str(tmp / "render.json"), "-o",
                      str(out_dir / "grid.png"), "-n", "2"]
                     + OPTS + ["MODEL.DEVICE", "cpu", "OUTPUT_DIR", str(out_dir),
                               "TEST.QUANT", "fake"])
    grid = Image.open(out_dir / "grid.png")
    assert grid.size[0] >= 4 * 320 and grid.size[1] >= 2 * 240  # image, gt, two columns
    for column in ("first", "second"):
        curves = json.load(open(out_dir / "pr_curves" / column / "pr_curves.json"))
        assert set(curves) == {"road", "car", "sky"}
        assert (out_dir / "pr_curves" / column / "pr_curves.png").exists()
    (events,) = os.listdir(out_dir / "tb_demo")
    assert events.startswith("events.out.tfevents")
    # each column is its own checkpoint, quantized ("fake") after calibrating
    # on the first image, as cli.inference's predictor does
    first = inference.build_predictor(_port_cfg(tmp, "TEST.QUANT", "fake", "resume",
                                                str(tmp / "a.pth")),
                                      logging.getLogger("eval_extras"))
    np.testing.assert_array_equal(preds["first", 0], first(images[0]))
    np.testing.assert_array_equal(preds["first", 1], first(images[1]))
    assert not np.array_equal(preds["first", 0], preds["second", 0])
