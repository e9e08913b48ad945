"""The port's research encoders (models/encoders_zoo.py: RepVGG in train and
deploy form with its reparameterisation, B2ResNet, B2VGG, SE-ResNet,
DeepLabV3 and its ASPP) against the JAX package's, on the CPU in float32,
at 64-pixel inputs.

Eval-mode outputs are held to 1e-4 of the reference's largest magnitude
with the weights carried over by ``research_state_dict_from_flax`` (round
trip exact; tests/test_torch_zoo.py ``hold``); the norms of the ResNet-shaped
nets are damped to [0.25, 0.75], as ``randomize_weights_`` damps them, so
that the sums of their residual blocks stay of order 1 under running
statistics.  SE-ResNet is also held in train mode
(tests/test_torch_nets_zoo.py ``hold_train``).  ``repvgg_reparam`` turns the
port's train-form ``state_dict`` into the deploy form's: the deploy net's
eval output equals the train form's to 1e-5 of its magnitude, and the fused
kernels and biases equal the JAX ``repvgg_reparam``'s to 1e-6 of theirs.
"""

import jax
import numpy as np
import pytest
import torch

from rnd_semantic_segmentation_tpu.models import encoders_zoo as J

from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    research_flax_from_state_dict,
    research_state_dict_from_flax,
)
from rnd_semantic_segmentation_torch.models import encoders_zoo as P

from test_torch_nets_zoo import hold_train
from test_torch_zoo import _x, hold

torch.set_num_threads(2)  # six test workers share the host's cores

DAMPED = (0.25, 0.75)


def test_repvgg_train_form_deploy_form_and_reparam():
    x = _x(2, 64, 64, 3)
    variables = hold("RepVGG", J.RepVGG("RepVGG-A0"), P.RepVGG("RepVGG-A0"), [x],
                     bn_scale=DAMPED)
    train_form = P.RepVGG("RepVGG-A0")
    train_form.load_state_dict(research_state_dict_from_flax("RepVGG", variables))
    sd = train_form.state_dict()
    assert {"stage0.rbr_dense.conv.weight", "stage1.0.rbr_1x1.bn.running_var",
            "stage1.1.rbr_identity.weight"} <= set(sd)
    assert "stage1.0.rbr_identity.weight" not in sd  # stride 2: no identity branch
    deploy_sd = P.repvgg_reparam(sd)
    deploy = P.RepVGG("RepVGG-A0", deploy=True)
    deploy.load_state_dict(deploy_sd)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        want, got = train_form.eval()(xt), deploy.eval()(xt)
    assert len(got) == 4 and got[3].shape == (2, 1280, 2, 2)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()
    # the fused parameters against the JAX conversion, through the bridge
    ref = J.repvgg_reparam(variables, "RepVGG-A0")
    back = research_flax_from_state_dict("RepVGG", deploy_sd, ref)["params"]
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref["params"])[0]:
        node = back
        for key in path:
            node = node[key.key]
        leaf = np.asarray(leaf)
        assert np.abs(node - leaf).max() <= 1e-6 * np.abs(leaf).max(), str(path)
    # and the JAX deploy net on the JAX fused parameters
    hold_deploy = P.RepVGG("RepVGG-A0", deploy=True)
    hold("RepVGG", J.RepVGG("RepVGG-A0", deploy=True), hold_deploy, [x])


def test_b2_resnet_and_b2_vgg():
    variables = hold("B2ResNet", J.B2ResNet(), P.B2ResNet(), [_x(2, 64, 64, 3)],
                     bn_scale=DAMPED)
    sd = research_state_dict_from_flax("B2ResNet", variables)
    assert {"layer3_1.0.downsample.0.weight", "layer4_2.2.bn3.running_mean",
            "layer1.0.conv1.weight"} <= set(sd)
    hold("B2VGG", J.B2VGG(), P.B2VGG(), [_x(2, 64, 64, 3)])


def test_se_resnet_eval_and_train():
    x = _x(2, 64, 64, 3)
    jax_net, port_net = J.SEResNet(), P.SEResNet()
    variables = hold("SEResNet", jax_net, port_net, [x], bn_scale=DAMPED)
    sd = research_state_dict_from_flax("SEResNet", variables)
    assert {"layer2.0.se.fc1.weight", "layer2.0.downsample.1.running_var"} <= set(sd)
    hold_train("SEResNet", jax_net, port_net, [x], variables)


def test_se_basic_block():
    hold("SEBasicBlock", J.SEBasicBlock(32, 2, True), P.SEBasicBlock(16, 32, 2, True),
         [_x(2, 9, 10, 16)])


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_deeplab_v3(arch):
    variables = hold("DeepLabV3", J.DeepLabV3(5, arch), P.DeepLabV3(5, arch),
                     [_x(2, 64, 64, 3)], bn_scale=DAMPED)
    sd = research_state_dict_from_flax("DeepLabV3", variables)
    assert {"backbone.layer4.0.conv1.weight", "aspp.b3_conv.weight",
            "aspp.project_bn.running_mean", "classifier.bias"} <= set(sd)


def test_deeplab_v3_aspp():
    hold("DeepLabV3ASPP", J.DeepLabV3ASPP(24), P.DeepLabV3ASPP(16, 24), [_x(2, 9, 11, 16)])
