"""The port's classification hubs (models/cls_hubs.py: NLResNet, CGNLResNet)
against the JAX package's, on the CPU in float32: NLResNet on 32-pixel
CIFAR-sized inputs, CGNLResNet on 64-pixel inputs with a 2 x 2 final pool
(the JAX net's ``pool_size``; 224-pixel inputs take the default 7).

Eval-mode logits are held to 1e-4 of the reference's largest magnitude
(tests/test_torch_zoo.py ``hold``, norms damped to [0.25, 0.75] as
``randomize_weights_`` damps a ResNet's), NLResNet18 also in train mode
(tests/test_torch_nets_zoo.py ``hold_train``).  The inserted non-local block
reads its channels off its input in the JAX package, so the Bottleneck
depths work there; the port builds it for those channels.  ``count_params``
of utils/profiling.py equals the JAX package's count of the same net.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from rnd_semantic_segmentation_tpu.models import cls_hubs as J
from rnd_semantic_segmentation_tpu.utils import profiling as jax_profiling

from rnd_semantic_segmentation_torch.ckpt.torch_import import research_state_dict_from_flax
from rnd_semantic_segmentation_torch.models import cls_hubs as P
from rnd_semantic_segmentation_torch.utils.profiling import count_params

from test_torch_nets_zoo import hold_train
from test_torch_zoo import _x, hold

torch.set_num_threads(2)  # six test workers share the host's cores

DAMPED = (0.25, 0.75)


@pytest.mark.parametrize("arch,non_local", [("resnet18", True), ("resnet18", False),
                                            ("resnet50", True)])
def test_nl_resnet(arch, non_local):
    x = _x(2, 32, 32, 3)
    jax_net = J.NLResNet(arch, num_classes=10, non_local=non_local)
    port_net = P.NLResNet(arch, num_classes=10, non_local=non_local)
    variables = hold("NLResNet", jax_net, port_net, [x], bn_scale=DAMPED)
    sd = research_state_dict_from_flax("NLResNet", variables)
    assert ("layer3_nl.W_z_bn.running_var" in sd) == non_local
    assert "linear.weight" in sd and "layer3.0.downsample.1.weight" in sd
    assert count_params(port_net) == jax_profiling.count_params(variables["params"])
    if arch == "resnet18" and non_local:
        hold_train("NLResNet", jax_net, port_net, [x], variables)


@pytest.mark.parametrize("nl_type", [None, "nl", "cgnl", "cgnlx"])
def test_cgnl_resnet(nl_type):
    kw = dict(num_classes=7, nl_type=nl_type, nl_nums=1 if nl_type else 0, pool_size=2)
    jax_net = J.CGNLResNet("resnet50", **kw)
    port_net = P.CGNLResNet("resnet50", input_size=64, **kw)
    variables = hold("CGNLResNet", jax_net, port_net, [_x(2, 64, 64, 3)], bn_scale=DAMPED)
    sd = research_state_dict_from_flax("CGNLResNet", variables)
    assert ("layer3_nl.z.weight" in sd) == bool(nl_type)
    assert tuple(sd["fc.weight"].shape) == (7, 2048)
    assert count_params(port_net) == jax_profiling.count_params(variables["params"])


def test_cgnl_resnet_drops_out_in_train_mode_only():
    net = P.CGNLResNet("resnet50", num_classes=3, nl_type="cgnl", nl_nums=1, pool_size=2,
                       dropout_rate=0.5, input_size=64)
    x = torch.randn(2, 3, 64, 64)
    with torch.no_grad():
        net.eval()
        a, b = net(x), net(x)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        net.train()
        torch.manual_seed(0)
        c = net(x)
        torch.manual_seed(1)
        d = net(x)
    assert not torch.equal(c, d)
    with pytest.raises(ValueError, match="nl_type"):
        P.CGNLResNet("resnet50", nl_type="bogus", nl_nums=1)
    shapes = jax.eval_shape(J.CGNLResNet("resnet50", nl_type="cgnl", nl_nums=1).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    assert count_params(P.CGNLResNet("resnet50", nl_type="cgnl", nl_nums=1)) == \
        jax_profiling.count_params(shapes["params"])
