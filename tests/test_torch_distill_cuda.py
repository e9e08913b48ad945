"""Online self-distillation and device-side augmentation on the card: each
apply function of data/device_pipe.py on the card against the same function
on the CPU with the same draws, and the launches of the hand kernels in a
GALD online step (criss-cross forward 4, backward 2) and in an attn online
step with MODEL.FUSED_MBCONV on (fused MBConv 17, all the teacher's).  Each
skips without a card.

This file imports nothing of the JAX package, so that it collects on a
machine that has the card and not the JAX package's dependencies; the CPU
parity of the same paths is in tests/test_torch_device_pipe.py and
tests/test_torch_distill_online.py.

Tolerances: flips, rot90 and every label exact; the images within 1e-5
absolute (the card's float32 transcendental and sum orders against the
CPU's; 1e-5 times 255 with TO_BGR255).
"""

import numpy as np
import pytest
import torch

from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.data import device_pipe as dp
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.ops import ccattn, mbconv
from rnd_semantic_segmentation_torch.train.distill import make_online_distill_step
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor
from rnd_semantic_segmentation_torch.train.state import TrainState, make_optimizers
from rnd_semantic_segmentation_torch.utils import resolve_device

torch.set_num_threads(2)  # six test workers share the host's cores

ATOL = 1e-5
B = 6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return resolve_device("cuda")


def _on(draws, device):
    return {k: (_on(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in draws.items()}


def _batch(h, w, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.rand(B, h, w, 3).astype(np.float32)),
            torch.from_numpy(rng.randint(0, classes, (B, h, w)).astype(np.int32)))


def _assert_same(got, ref, atol=ATOL):
    got = got.cpu()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if ref.dtype.is_floating_point:
        torch.testing.assert_close(got, ref, rtol=0, atol=atol)
    else:
        assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", ["pra", "attn", "aspp", "aspp_bgr255"])
def test_apply_functions_on_the_card_match_the_cpu(pipeline):
    device = _card()
    gen = torch.Generator().manual_seed(3)
    if pipeline == "pra":
        x, y = _batch(32, 32, classes=2)
        draws = dp.draw_pra(gen, B)
        fn, kw, atol = dp.augment_batch_pra, {}, ATOL
    elif pipeline == "attn":
        x, y = _batch(40, 24, classes=2)
        draws = dp.draw_attn(gen, B, prob=1.0)
        fn, kw, atol = dp.augment_batch_attn, {}, ATOL
    else:
        bgr = pipeline == "aspp_bgr255"
        x, y = _batch(36, 60, classes=19)
        draws = dp.draw_aspp(gen, B, 0.5, (0.5, 0.5, 0.5, 0.2))
        kw = dict(size=(24, 40), to_bgr255=bgr,
                  mean=(102.9801, 115.9465, 122.7717) if bgr else dp.IMAGENET_MEAN,
                  std=(1.0, 1.0, 1.0) if bgr else dp.IMAGENET_STD)
        fn, atol = dp.augment_batch, ATOL * (255 if bgr else 1 / 0.224)
    ref = fn(x, y, draws, **kw)
    got = fn(x.to(device), y.to(device), _on(draws, device), **kw)
    _assert_same(got["image"], ref["image"], atol)
    _assert_same(got["label"], ref["label"])
    # and the helpers alone
    _assert_same(dp.flip_select(x.to(device), y.to(device), torch.arange(B).to(device) % 3,
                                torch.ones(B, dtype=torch.bool, device=device))[1],
                 dp.flip_select(x, y, torch.arange(B) % 3, torch.ones(B, dtype=torch.bool))[1])


@pytest.mark.cuda
def test_the_augmenter_draws_on_the_batch_device():
    device = _card()
    cfg = get_default_cfg()
    cfg.merge_from_list(["AUG.NAME", "attn", "AUG.PROB", "1.0"])
    x, y = _batch(16, 16)
    aug = dp.make_device_augmenter(cfg)
    a = aug({"image": x.to(device), "label": y.to(device)}, 4)
    b = aug({"image": x.to(device), "label": y.to(device)}, 4)
    # the image in MODEL.DTYPE (bfloat16 by default)
    assert a["image"].device.type == "cuda" and a["image"].dtype == torch.bfloat16
    assert torch.equal(a["image"], b["image"])


def _online_step(name, nc, side, batch, *opts):
    device = _card()
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", name, "MODEL.NUM_CLASSES", str(nc), "MODEL.DEVICE",
                         "cuda", *opts])
    student = randomize_weights_(Segmentor(build_segmentor(cfg), nc), seed=10).to(device)
    teacher = randomize_weights_(Segmentor(build_segmentor(cfg), nc), seed=20).to(device)
    state = TrainState(optimizers=make_optimizers(student.spec, cfg))
    step = make_online_distill_step(student, cfg, 10, state, teacher, seed=cfg.SEED + 1)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(batch, side, side, 3).astype(np.float32)).to(device)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    ccattn.KERNEL_LAUNCHES = ccattn.BWD_KERNEL_LAUNCHES = mbconv.KERNEL_LAUNCHES = 0
    metrics = step({"image": x, "label": torch.zeros(batch, side, side, dtype=torch.int32,
                                                      device=device)}, 0.0)
    torch.cuda.synchronize()
    counts = (ccattn.KERNEL_LAUNCHES, ccattn.BWD_KERNEL_LAUNCHES, mbconv.KERNEL_LAUNCHES)
    assert np.isfinite(metrics["loss"])
    for key, value in teacher.state_dict().items():
        assert torch.equal(value, before[key]), key
    return counts


@pytest.mark.cuda
def test_gald_online_step_launches_the_criss_cross_kernels():
    """Teacher forward (eval): the forward kernel twice; student (train):
    the forward twice and the backward twice."""
    assert _online_step("gald_hardnet68", 3, 224, 2) == (4, 2, 0)


@pytest.mark.cuda
def test_attn_online_step_launches_the_fused_mbconv_from_the_teacher_only():
    """MODEL.FUSED_MBCONV on: the eval-mode teacher takes the fused kernel 17
    times a forward under no_grad; the train-mode student never."""
    assert _online_step("attn_efficientnet-b2", 2, 128, 2,
                        "MODEL.FUSED_MBCONV", "True") == (0, 0, 17)
