"""Multi-process evaluation of the port on the CPU: ``cli.test``'s Tester in a
gloo world of two processes against one process on the images the two
evaluate.

Eleven synthetic images at 48x40 with ``TEST.BATCH_SIZE 4``: under
``process_shard`` rank r takes images r, r+2, ..., r+8, two a batch, and
image 10 (the last ``11 % 2``) is left out and named in the log, as in the
JAX package; each rank's last batch holds one image and is padded with an
ignore-label row.  The global batches are then the one process's batches
of 4, 4 and 2 over the first ten images, so the macro and micro summaries
and the confusion matrix must be equal.  ``--saveres`` writes each rank's
PNGs; ``TEST.QUANT int8`` evaluates in float32 with the reason
``multiprocess``.  One world runs both (``torch_dist_worker.case_eval``, a
module-scoped fixture with its own timeout).
"""

import logging
import os

import numpy as np
import pytest
import torch

from rnd_semantic_segmentation_torch.ckpt.torch_import import save_reference_checkpoint
from rnd_semantic_segmentation_torch.cli import test as test_cli
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.eval.tester import Tester
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_

import torch_dist_worker as W

torch.set_num_threads(2)  # six test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "deeplabv2_r101_src.yaml")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("eval")
    cfg = W.eval_cfg(CONFIG, str(out), "", "11")
    spec = build_segmentor(cfg)
    randomize_weights_(torch.nn.ModuleDict(spec.modules), seed=3)
    ckpt = str(out / "seeded.pth")
    save_reference_checkpoint(spec.modules, ckpt)
    ranks, _ = W.run_world("eval", str(out), CONFIG, ckpt, "11", timeout=300)
    one = W.eval_cfg(CONFIG, str(out / "one"), ckpt, "10", "DIST.INITIALIZE", "False",
                     "OUTPUT_DIR", str(out / "one"))
    tester = test_cli.make_tester(one, W.RENDER, logger=logging.getLogger("dist_eval"))
    summary = tester.test()
    return out, ranks, summary, tester.confusion


def test_two_ranks_give_the_one_process_summary(run):
    _, ranks, summary, confusion = run
    for r in ranks:
        for key, value in summary.items():
            np.testing.assert_array_equal(r[f"float32/{key}"], np.asarray(value), err_msg=key)
        np.testing.assert_array_equal(r["float32/confusion"], confusion)
    assert confusion.sum() == 10 * 48 * 40


def test_the_left_out_image_is_named_and_each_rank_saves_its_shard(run):
    out, _, _, _ = run
    log = (out / "float32" / "dist_synthetic_test.txt").read_text()
    assert "leaves out the last 1 image(s): synthetic_00010" in log
    saved = sorted(os.listdir(out / "pseudo" / "inference" / "synthetic_val"))
    assert saved == [f"synthetic_{i:05d}.png" for i in range(10)]
    # the primary alone writes the JSON and the heat map
    assert (out / "float32" / "deeplab_confusion_matrix.json").exists()


def test_quantized_eval_over_two_ranks_runs_in_float32(run):
    _, ranks, _, _ = run
    for r in ranks:
        assert str(r["int8/reason"]) == "multiprocess" and str(r["int8/mode"]) == "none"
        np.testing.assert_array_equal(r["int8/confusion"], r["float32/confusion"])


def test_pranet_head_of_a_padded_batch_spans_its_real_rows():
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", "pranet_res2net50", "MODEL.DEVICE", "cpu"])
    tester = Tester(cfg, logging.getLogger("dist_eval"))
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    # a padding row far from the images, so that it would move the min-max
    padded = torch.cat([x, torch.full((1, 3, 64, 64), 50.0)])
    torch.testing.assert_close(tester._probs_impl(padded, (64, 64), valid=2)[:2],
                               tester._probs_impl(x, (64, 64)), rtol=0, atol=1e-6)
    assert not torch.allclose(tester._probs_impl(padded, (64, 64))[:2],
                              tester._probs_impl(x, (64, 64)), atol=1e-6)
