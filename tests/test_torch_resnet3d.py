"""The port's 3D ResNet (models/resnet3d.py) against the JAX package's, on
the CPU in float32: two clips of 8 frames of 32 x 32 pixels, NCTHW in the
port and NTHWC in the JAX package.

Eval-mode taps are held to 1e-4 of the reference's largest magnitude
(tests/test_torch_zoo.py ``hold``, norms damped to [0.25, 0.75] as
``randomize_weights_`` damps a ResNet's), and in train mode
(tests/test_torch_nets_zoo.py ``hold_train``): the batch statistics, the
unbiased running variance and the gradients.  The 3D kernels go from DHWIO
to OIDHW in ``research_state_dict_from_flax`` and back exactly.
"""

import torch

from rnd_semantic_segmentation_tpu.models import resnet3d as J

from rnd_semantic_segmentation_torch.ckpt.torch_import import research_state_dict_from_flax
from rnd_semantic_segmentation_torch.models import resnet3d as P

from test_torch_nets_zoo import hold_train
from test_torch_zoo import _x, hold

torch.set_num_threads(2)  # six test workers share the host's cores


def test_resnet3d_eval_and_train():
    x = _x(2, 8, 32, 32, 3)
    jax_net, port_net = J.ResNet3D(), P.ResNet3D()
    variables = hold("ResNet3D", jax_net, port_net, [x], bn_scale=(0.25, 0.75))
    sd = research_state_dict_from_flax("ResNet3D", variables)
    assert tuple(sd["conv1.weight"].shape) == (64, 3, 7, 7, 7)
    assert {"layer2.0.downsample.0.weight", "layer4.1.bn2.running_var"} <= set(sd)
    with torch.no_grad():
        taps = port_net(torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy()))
    assert [tuple(t.shape) for t in taps] == [(2, 64, 4, 8, 8), (2, 128, 2, 4, 4),
                                             (2, 256, 1, 2, 2), (2, 512, 1, 1, 1)]



def test_resnet3d_train_mode():
    """One block a stage on 2 clips of 8 x 64 x 64, so that layer4's train-mode
    norms see 8 values a channel: at 32 x 32 they see 2, and the JAX
    package's one-pass variance (E[x^2] - E[x]^2) and torch's two-pass one
    then differ in float32 by 3e-3 of the tap."""
    x = _x(2, 8, 64, 64, 3, seed=4)
    jax_net, port_net = J.ResNet3D((1, 1, 1, 1)), P.ResNet3D((1, 1, 1, 1))
    variables = hold("ResNet3D", jax_net, port_net, [x], bn_scale=(0.25, 0.75))
    hold_train("ResNet3D", jax_net, port_net, [x], variables)


def test_basic_block_3d():
    hold("BasicBlock3d", J.BasicBlock3d(24, 2, True), P.BasicBlock3d(16, 24, 2, True),
         [_x(2, 4, 6, 5, 16)])
