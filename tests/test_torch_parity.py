"""Activation parity: our Flax models vs the reference's torch modules.

Weights flow through ckpt/torch_import.py, so these tests validate BOTH the
weight importer and the layer semantics end to end (north-star: logits <=1e-3
vs reference, BASELINE.md).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rnd_semantic_segmentation_tpu.ckpt.torch_import import (
    HARDNET_RULES,
    PRANET_RULES,
    RES2NET_RULES,
    RESNET_RULES,
    convert_state_dict,
)
from rnd_semantic_segmentation_tpu.models import HarDNet, PraNet, Res2Net
from rnd_semantic_segmentation_tpu.models.resnet import ResNet

from torch_ref import load_pranet, load_ref_module, to_nchw, torch_state_dict_np

torch.set_num_threads(2)  # six test workers share the host's cores

TOL = 2e-3  # north-star parity budget is 1e-3 on logits; activations compound


def _assert_close(ours, ref_nchw, tol=TOL):
    """Scale-aware closeness: the torch oracles here are RANDOM-init (torch's
    global RNG, different weights every run), so unnormalized deep
    activations reach magnitudes of hundreds — a fixed ABSOLUTE tol on those
    is a lottery ticket on float accumulation order (a 0.00207 max-abs diff
    on ~480-magnitude res2net layer4 activations — 4e-6 relative — failed
    one run and passed the next).  The budget applies to unit-scale values
    and scales with the oracle's own magnitude past 1.0."""
    ref = np.transpose(ref_nchw.detach().numpy(), (0, 2, 3, 1))
    ours = np.asarray(ours, np.float32)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = max(1.0, float(np.max(np.abs(ref))) / 10.0)
    diff = np.max(np.abs(ours - ref))
    assert diff < tol * scale, (f"max abs diff {diff} vs budget "
                                f"{tol * scale} (ref scale {scale})")


def test_res2net_backbone_parity(rng):
    ref_mod = load_ref_module("core/models/classifiers/pranet/Res2Net_v1b.py", "ref_res2net")
    tmodel = ref_mod.Res2Net(ref_mod.Bottle2neck, [3, 4, 6, 3], baseWidth=26, scale=4)
    tmodel.eval()
    x = rng.rand(1, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        t = to_nchw(x)
        t = tmodel.maxpool(tmodel.relu(tmodel.bn1(tmodel.conv1(t))))
        t1 = tmodel.layer1(t)
        t4 = tmodel.layer4(tmodel.layer3(tmodel.layer2(t1)))

    variables = convert_state_dict(torch_state_dict_np(tmodel), RES2NET_RULES)
    ours = Res2Net().apply(variables, jnp.asarray(x), train=False)
    _assert_close(ours["layer1"], t1)
    _assert_close(ours["layer4"], t4)


def test_hardnet_taps_parity(rng):
    ref_mod = load_ref_module(
        "core/models/classifiers/gcpacc/encoders/hardnet_68.py", "ref_hardnet")
    tmodel = ref_mod.HarDNet(arch=68)
    tmodel.eval()
    x = rng.rand(1, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        ref_taps = tmodel(to_nchw(x))

    variables = convert_state_dict(torch_state_dict_np(tmodel), HARDNET_RULES,
                                   skip=("num_batches_tracked", "base.19"))
    ours = HarDNet(arch=68).apply(variables, jnp.asarray(x), train=False)
    for o, r in zip(ours, ref_taps):
        _assert_close(o, r)


def test_resnet_dilated_backbone_parity(rng):
    ref_mod = load_ref_module("core/components/resnet.py", "ref_resnet")
    tmodel = ref_mod.ResNet(ref_mod.Bottleneck, [3, 4, 6, 3],
                            replace_stride_with_dilation=[False, True, True])
    tmodel.eval()
    x = rng.rand(1, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        t = to_nchw(x)
        t = tmodel.maxpool(tmodel.relu(tmodel.bn1(tmodel.conv1(t))))
        t4 = tmodel.layer4(tmodel.layer3(tmodel.layer2(tmodel.layer1(t))))

    variables = convert_state_dict(torch_state_dict_np(tmodel), RESNET_RULES)
    ours = ResNet(arch="resnet50",
                  replace_stride_with_dilation=(False, True, True)).apply(
        variables, jnp.asarray(x), train=False)
    _assert_close(ours["layer4"], t4)


def test_pranet_full_parity(rng):
    ref_mod = load_pranet()
    tmodel = ref_mod.PraNet()
    tmodel.eval()
    x = rng.rand(1, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        ref_outs = tmodel(to_nchw(x))

    variables = convert_state_dict(torch_state_dict_np(tmodel), PRANET_RULES)
    ours = PraNet().apply(variables, jnp.asarray(x), train=False)
    for o, r in zip(ours, ref_outs):
        _assert_close(o, r, tol=5e-3)  # 4 resizes + sigmoid chains compound
