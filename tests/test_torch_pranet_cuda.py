"""The PraNet slice on the card: a seeded pranet_res2net50 (and its CRANet
variant) at 64x64 gives the CPU's four maps within 1e-4 of their largest
magnitude (cuDNN with TF32 off, eval mode), and one source train step on the
card, three rates of a batch of 2 at TRAINSIZE 96 through the trainer's
resize, moves every parameter and every BN running statistic with no hand
kernel launched.  Both skip without a card.

This file imports nothing of the JAX package, so that it collects on a
machine that has the card and not the JAX package's dependencies; the CPU
parity of the same paths is in tests/test_torch_pranet.py and
tests/test_torch_pranet_train.py.
"""

import numpy as np
import pytest
import torch

from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.ops import ccattn, mbconv
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor
from rnd_semantic_segmentation_torch.train.state import TrainState, make_optimizers
from rnd_semantic_segmentation_torch.train.steps import make_src_train_step
from rnd_semantic_segmentation_torch.train.trainer import (
    MULTISCALE_RATES,
    rate_side,
    resize_batch_to,
)
from rnd_semantic_segmentation_torch.utils import resolve_device

NC = 2


def _cfg(name, *opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", name, "MODEL.NUM_CLASSES", str(NC),
                         "MODEL.DEVICE", "cpu", "SOLVER.BASE_LR", "1e-4",
                         "MODEL.DTYPE", "float32", *opts])
    return cfg


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pranet_res2net50", "pranet_resnet50"])
def test_card_maps_match_the_cpu_maps(name):
    device = _card()
    seg = Segmentor(build_segmentor(_cfg(name)), NC)
    randomize_weights_(seg, seed=12)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        ref, _ = seg(x)
        out, _ = seg.to(device)(x.to(device))
    for o, r in zip(out, ref):
        assert (o.cpu() - r).abs().max() <= 1e-4 * r.abs().max()


@pytest.mark.cuda
def test_one_multiscale_batch_on_the_card():
    device = _card()
    rng = np.random.RandomState(9)
    batch = {"image": torch.from_numpy(rng.randn(2, 96, 96, 3).astype(np.float32)),
             "label": torch.from_numpy((rng.rand(2, 96, 96) > 0.7).astype(np.int32))}
    cfg = _cfg("pranet_res2net50")
    seg = Segmentor(build_segmentor(cfg), NC)
    randomize_weights_(seg, seed=10)
    seg.to(device)
    before = {k: v.clone() for k, v in seg.state_dict().items()}
    tstate = TrainState(optimizers=make_optimizers(seg.spec, cfg))
    step = make_src_train_step(seg, cfg, 10, tstate)
    counts = (ccattn.KERNEL_LAUNCHES, ccattn.BWD_KERNEL_LAUNCHES, mbconv.KERNEL_LAUNCHES)
    on_card = {k: v.to(device) for k, v in batch.items()}
    for rate in MULTISCALE_RATES:
        side = rate_side(96, rate)
        out = step(on_card if rate == 1.0 else resize_batch_to(on_card, side), 0.0)
        assert np.isfinite(out["loss"])
    assert tstate.step == 3
    assert counts == (ccattn.KERNEL_LAUNCHES, ccattn.BWD_KERNEL_LAUNCHES, mbconv.KERNEL_LAUNCHES)
    assert all(not torch.equal(p, before[k]) for k, p in seg.named_parameters())
    stats = [k for k in before if k.endswith(("running_mean", "running_var"))]
    assert stats and all(not torch.equal(seg.state_dict()[k], before[k]) for k in stats)
