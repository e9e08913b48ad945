"""MODEL.DTYPE bfloat16 and MODEL.REMAT_BLOCKS on the card: a bfloat16 GALD
step through kernels #1 and #2 against the same step with the plain
criss-cross core, a bfloat16 attn teacher forward through kernel #3 against
the unfused path, and a float32 step with MODEL.REMAT_BLOCKS on against it
off.  Each skips without a card.

This file imports nothing of the JAX package, so that it collects on a
machine that has the card and not the JAX package's dependencies; the CPU
parity of the same paths is in tests/test_torch_precision.py,
tests/test_torch_precision_steps.py and tests/test_torch_remat.py.

Tolerances: the GALD gradients, all leaves as one vector, within 1e-2 of
their norm (``BWD_TOLERANCE[bfloat16]`` of chip_smoke.py) at the training
shape in eval mode, where BatchNorm applies running statistics: in train
mode from random weights it turns the ulp by which the kernels and the
plain core round their bfloat16 outputs apart into a few percent of the
gradient (8e-2 at the training shape, 2e-2 between two runs of the
kernels alone), and no leaf is held alone (the key convolution's bias has
a true gradient of 0); the losses within 1e-2 relative; the fused teacher
within 3e-2 + 1e-2 of the unfused output's magnitude, the bfloat16
tolerance of chip_smoke.py; remat within 1e-6 of each gradient's largest
element, with cuDNN deterministic and the labels at the classifier's size
(the bilinear resize to a larger label adds its gradient with atomics on
the card), the BatchNorm counters equal and the running statistics within
1e-6.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.models import gcpa
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.models.efficientnet import MBConvBlock
from rnd_semantic_segmentation_torch.ops import ccattn, mbconv
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor
from rnd_semantic_segmentation_torch.train.state import TrainState, make_optimizers
from rnd_semantic_segmentation_torch.train.steps import make_family_loss, make_src_train_step
from rnd_semantic_segmentation_torch.utils import resolve_device

torch.set_num_threads(2)  # six test workers share the host's cores

GRAD_TOLERANCE = 1e-2
LOSS_TOLERANCE = 1e-2
FUSED_TOLERANCE = (3e-2, 1e-2)
REMAT_TOLERANCE = 1e-6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return resolve_device("cuda")


def _cfg(name, nc, *opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", name, "MODEL.NUM_CLASSES", str(nc),
                         "SOLVER.BASE_LR", "1e-4", *opts])
    return cfg


def _segmentor(cfg, device, seed=0):
    seg = Segmentor(build_segmentor(cfg), cfg.MODEL.NUM_CLASSES)
    return randomize_weights_(seg, seed=seed).to(device)


def _global_rel(grads, refs) -> float:
    """||grad - ref|| / ||ref|| over all leaves as one vector."""
    num = sum((grads[n] - r).float().square().sum().item() for n, r in refs.items())
    return (num / sum(r.float().square().sum().item() for r in refs.values())) ** 0.5


def _grads(seg, loss_fn, x, label, train=False):
    seg.zero_grad(set_to_none=True)
    outputs, _ = seg(x, train=train)
    loss = loss_fn(outputs, label)
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {n: p.grad.clone() for n, p in seg.named_parameters()}


@pytest.mark.cuda
def test_bfloat16_gald_step_through_the_kernels_matches_the_plain_core():
    """A step at 224x224 launches #1 twice and #2 twice on bfloat16 q, k, v;
    then, at the training shape (6 at 1280x720) in eval mode, the loss and
    gradients through the kernels against the same forward and backward with
    the plain core."""
    device = _card()
    cfg = _cfg("gald_hardnet68", 3, "MODEL.DTYPE", "bfloat16")
    seg = _segmentor(cfg, device)
    rng = np.random.RandomState(0)
    image = torch.from_numpy(rng.rand(2, 224, 224, 3).astype(np.float32)).to(device)
    label = torch.from_numpy(rng.randint(0, 3, (2, 224, 224)).astype(np.int32)).to(device)
    seen = []
    hook = seg.parts["decoder"].long_relation.register_forward_hook(
        lambda m, inp, out: seen.append((inp[0].dtype, out.dtype)))
    state = TrainState(optimizers=make_optimizers(seg.spec, cfg))
    step = make_src_train_step(seg, cfg, 10, state)
    ccattn.KERNEL_LAUNCHES = ccattn.BWD_KERNEL_LAUNCHES = 0
    metrics = step({"image": image, "label": label}, 0.0)
    torch.cuda.synchronize()
    hook.remove()
    assert (ccattn.KERNEL_LAUNCHES, ccattn.BWD_KERNEL_LAUNCHES) == (2, 2)
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 2 and np.isfinite(metrics["loss"])

    loss_fn = make_family_loss(seg.spec, 3)
    x = torch.from_numpy(rng.rand(6, 3, 720, 1280).astype(np.float32)).to(device).bfloat16()
    label = torch.from_numpy(rng.randint(0, 3, (6, 720, 1280)).astype(np.int64)).to(device)
    loss_k, grads_k = _grads(seg, loss_fn, x, label)
    with mock.patch.object(gcpa, "cc_attention_core", ccattn.cc_attention_core_plain):
        before = (ccattn.KERNEL_LAUNCHES, ccattn.BWD_KERNEL_LAUNCHES)
        loss_p, grads_p = _grads(seg, loss_fn, x, label)
        assert (ccattn.KERNEL_LAUNCHES, ccattn.BWD_KERNEL_LAUNCHES) == before
    assert abs(loss_k - loss_p) <= LOSS_TOLERANCE * abs(loss_p)
    assert _global_rel(grads_k, grads_p) <= GRAD_TOLERANCE


@pytest.mark.cuda
def test_bfloat16_attn_teacher_through_the_fused_kernel_matches_the_unfused_path():
    """An eval-mode attn B2 forward on a bfloat16 image with
    MODEL.FUSED_MBCONV on launches #3 17 times in its bfloat16 instance, and
    its outputs agree with the same forward with the switch off."""
    device = _card()
    cfg = _cfg("attn_efficientnet-b2", 2, "MODEL.FUSED_MBCONV", "True")
    seg = _segmentor(cfg, device, seed=20).eval()
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.rand(2, 3, 128, 128).astype(np.float32)).to(device).bfloat16()
    mbconv.KERNEL_LAUNCHES = 0
    with torch.no_grad():
        fused, _ = seg(x, label_size=(128, 128), train=False)
        torch.cuda.synchronize()
        assert mbconv.KERNEL_LAUNCHES == 17
        for block in seg.modules():
            if isinstance(block, MBConvBlock):
                block.fused_mbconv = False
        unfused, _ = seg(x, label_size=(128, 128), train=False)
    assert mbconv.KERNEL_LAUNCHES == 17
    atol, rtol = FUSED_TOLERANCE
    for a, b in zip(fused, unfused):
        assert a.dtype == b.dtype == torch.bfloat16
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= atol * scale + rtol * scale


@pytest.mark.cuda
def test_remat_blocks_on_the_card_matches_it_off():
    """Two float32 deeplab_resnet18 steps (BatchNorm) with MODEL.REMAT_BLOCKS
    off and on, labels at the classifier's 12x12: each gradient within 1e-6
    of its largest element, every BatchNorm counter equal and running
    statistic within 1e-6."""
    device = _card()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rng = np.random.RandomState(2)
        batches = [{"image": torch.from_numpy(rng.rand(2, 96, 96, 3).astype(np.float32))
                    .to(device),
                    "label": torch.from_numpy(rng.randint(0, 3, (2, 12, 12)).astype(np.int32))
                    .to(device)} for _ in range(2)]
        runs = {}
        for on in ("False", "True"):
            cfg = _cfg("deeplab_resnet18", 3, "MODEL.DTYPE", "float32",
                       "MODEL.REMAT_BLOCKS", on)
            seg = _segmentor(cfg, device, seed=3)
            step = make_src_train_step(seg, cfg, 10, TrainState(
                optimizers=make_optimizers(seg.spec, cfg)))
            losses = [step(b, 0.0)["loss"] for b in batches]
            runs[on] = (losses, {n: p.grad.clone() for n, p in seg.named_parameters()},
                        {k: v.clone() for k, v in seg.state_dict().items()
                         if "running" in k or "num_batches" in k})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (l_off, g_off, b_off), (l_on, g_on, b_on) = runs["False"], runs["True"]
    assert np.allclose(l_off, l_on, rtol=1e-6, atol=0)
    for name, g in g_off.items():
        err = (g_on[name] - g).abs().max().item()
        assert err <= REMAT_TOLERANCE * g.abs().max().item(), name
    assert b_off.keys() == b_on.keys() and b_off
    for key, value in b_off.items():
        if key.endswith("num_batches_tracked"):
            assert torch.equal(value, b_on[key]) and int(value) == 2, key
        else:
            assert torch.allclose(value, b_on[key], rtol=1e-6, atol=1e-7), key
