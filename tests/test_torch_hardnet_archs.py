"""HarDNet39 and HarDNet85 in the port (models/hardnet.py) against the JAX
package's, on the CPU in float32 at 64 x 64.

The two archs have the JAX parameter tree, carried over by
``research_state_dict_from_flax("HarDNet", ...)`` onto the reference's
``base.N`` keys and back exactly; the forward runs every layer and returns
no taps, as the JAX ``HarDNet`` does for any arch but 68, so there is no
output to compare.  HarDNet68 keeps its four taps.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from rnd_semantic_segmentation_tpu.models import hardnet as J

from rnd_semantic_segmentation_torch.ckpt.torch_import import research_state_dict_from_flax
from rnd_semantic_segmentation_torch.models import hardnet as P

from test_torch_zoo import _x, hold

torch.set_num_threads(2)  # six test workers share the host's cores


@pytest.mark.parametrize("arch,blocks,last", [(39, 4, 1024), (85, 6, 1280)])
def test_hardnet_arch_has_the_jax_parameters_and_no_taps(arch, blocks, last):
    port_net = P.HarDNet(arch)
    variables = hold("HarDNet", J.HarDNet(arch), port_net, [_x(1, 64, 64, 3)])
    assert jax.jit(J.HarDNet(arch).apply)(variables, jnp.zeros((1, 64, 64, 3))) == ()
    with torch.no_grad():
        assert port_net.eval()(torch.zeros(1, 3, 64, 64)) == ()
    sd = research_state_dict_from_flax("HarDNet", variables)
    assert set(sd) == set(port_net.state_dict())
    assert sum(isinstance(m, P.HarDBlock) for m in port_net.base) == blocks
    assert port_net.base[len(port_net.base) - 1].conv.out_channels == last


def test_hardnet68_keeps_its_taps_and_other_archs_raise():
    with torch.no_grad():
        taps = P.HarDNet(68).eval()(torch.zeros(1, 3, 64, 64))
    assert [t.shape[1] for t in taps] == [128, 320, 640, 1024]
    with pytest.raises(NotImplementedError, match="HarDNet50"):
        P.HarDNet(50)
