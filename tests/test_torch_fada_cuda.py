"""The FADA slice on the card: one FADA step of a seeded ``deeplab_resnet18``
at 64x64 on the card against the same step on the CPU, a GALD FADA step that
launches the criss-cross kernels as often as the step says, and the seeded
``deeplab_vgg16`` logits on the card against the CPU's.  Each skips without
a card.

This file imports nothing of the JAX package, so that it collects on a
machine that has the card and not the JAX package's dependencies; the CPU
parity of the same paths is in tests/test_torch_fada.py and
tests/test_torch_vgg.py.

Tolerances: the four losses within 1e-4 relative and both LRs exact; each
SGD leaf's update within 5e-3 of its largest element plus one float32 ulp
of the leaf (cuDNN and the CPU sum in other orders, as the CPU and XLA do
within 2e-3 in tests/test_torch_fada.py); D's first Adam step: every element
moved by at most lr on both devices, and where the CPU's gradient exceeds
1e-5 and both devices moved the element the same way, within 2e-3 of lr
(one Adam step moves an element by lr*g/(|g|+eps) whatever the size of g);
the VGG16 logits within 1e-4 of their largest magnitude.
"""

import copy

import numpy as np
import pytest
import torch

from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.models.build import (
    build_adversarial_discriminator,
    build_segmentor,
    randomize_weights_,
)
from rnd_semantic_segmentation_torch.ops import ccattn
from rnd_semantic_segmentation_torch.train.fada import (
    DISC_PART,
    make_disc_optimizer,
    make_fada_train_step,
)
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor
from rnd_semantic_segmentation_torch.train.state import TrainState, make_optimizers
from rnd_semantic_segmentation_torch.utils import resolve_device

NC = 3


def _cfg(name, *opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", name, "MODEL.NUM_CLASSES", str(NC),
                         "MODEL.FREEZE_BN", "True", "MODEL.DEVICE", "cpu",
                         "SOLVER.BASE_LR", "1e-3", "SOLVER.BASE_LR_D", "1e-4",
                         "MODEL.DTYPE", "float32", *opts])
    return cfg


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return resolve_device("cuda")


def _models(name, *opts):
    cfg = _cfg(name, *opts)
    seg = Segmentor(build_segmentor(cfg), NC)
    randomize_weights_(seg, seed=10)
    disc = randomize_weights_(build_adversarial_discriminator(cfg, seg.spec), seed=11)
    return cfg, seg, disc


def _batches(src_hw, tgt_hw, n=2):
    rng = np.random.RandomState(9)
    label = rng.randint(0, NC, (n,) + src_hw).astype(np.int32)
    label[:, :6, :10] = 255
    return ({"image": torch.from_numpy(rng.rand(n, *src_hw, 3).astype(np.float32)),
             "label": torch.from_numpy(label)},
            {"image": torch.from_numpy((rng.rand(n, *tgt_hw, 3) * 0.7).astype(np.float32)),
             "label": torch.zeros((n,) + tgt_hw, dtype=torch.int32)})


def _step(seg, disc, cfg, src, tgt, device):
    seg.to(device)
    disc.to(device)
    state = TrainState(optimizers={**make_optimizers(seg.spec, cfg),
                                   DISC_PART: make_disc_optimizer(disc)})
    step = make_fada_train_step(seg, disc, cfg, 10, state)
    return step({k: v.to(device) for k, v in src.items()},
                {k: v.to(device) for k, v in tgt.items()}, 0.0)


@pytest.mark.cuda
def test_fada_step_on_the_card_matches_the_cpu_step():
    device = _card()
    cfg, seg, disc = _models("deeplab_resnet18", "SOLVER.ADV_WEIGHT", "1.0")
    seg_gpu, disc_gpu = copy.deepcopy(seg), copy.deepcopy(disc)
    start = {k: v.clone() for k, v in seg.state_dict().items()}
    dstart = {k: v.clone() for k, v in disc.state_dict().items()}
    src, tgt = _batches((64, 64), (48, 64))
    ref = _step(seg, disc, cfg, src, tgt, "cpu")
    got = _step(seg_gpu, disc_gpu, cfg, src, tgt, device)
    for key, value in ref.items():
        tol = 0.0 if key.startswith("lr") else 1e-4 * abs(value)
        assert abs(got[key] - value) <= tol, (key, got[key], value)
    for (key, p), p_gpu in zip(seg.named_parameters(), seg_gpu.parameters()):
        want, have = p.detach() - start[key], p_gpu.detach().cpu() - start[key]
        assert want.abs().max() > 0, key
        ulp = 1.2e-7 * p.detach().abs().max()
        assert (have - want).abs().max() <= 5e-3 * want.abs().max() + ulp, key
    lr, checked, total = 1e-4, 0, 0
    for (key, p), p_gpu in zip(disc.named_parameters(), disc_gpu.parameters()):
        want, have = p.detach() - dstart[key], p_gpu.detach().cpu() - dstart[key]
        assert want.abs().max() <= lr * 1.001 and have.abs().max() <= lr * 1.001, key
        clear = (torch.sign(want) == torch.sign(have)) & (p.grad.abs() > 1e-5)
        if clear.any():
            assert (have - want)[clear].abs().max() <= 2e-3 * lr, key
        checked += int(clear.sum())
        total += int((p.grad.abs() > 1e-5).sum())
    assert checked > 0.9 * total


@pytest.mark.cuda
def test_gald_fada_step_launches_both_criss_cross_kernels():
    """Kernel #1 twice a forward on both domains, kernel #2 twice for the
    source decoder only: the target's soft label is detached and the
    adversarial term reaches the encoder alone."""
    device = _card()
    cfg, seg, disc = _models("gald_hardnet68")
    src, tgt = _batches((256, 256), (224, 256))
    ccattn.KERNEL_LAUNCHES = ccattn.BWD_KERNEL_LAUNCHES = 0
    out = _step(seg, disc, cfg, src, tgt, device)
    torch.cuda.synchronize()
    assert (ccattn.KERNEL_LAUNCHES, ccattn.BWD_KERNEL_LAUNCHES) == (4, 2)
    assert all(np.isfinite(v) for v in out.values())


@pytest.mark.cuda
def test_vgg16_logits_on_the_card_match_the_cpu_logits():
    device = _card()
    _, seg, _ = _models("deeplab_vgg16")
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        (ref,), _ = seg(x)
        (out,), _ = seg.to(device)(x.to(device))
    assert (out.cpu() - ref).abs().max() <= 1e-4 * ref.abs().max()
