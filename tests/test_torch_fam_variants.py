"""The port's FAM variants (models/fam_variants.py: FAMAG, FAMAGv3, FAMPra,
FAMSCWS) against the JAX package's, on the CPU in float32, at a small width
(interplanes 16) on three taps of 12 x 14, 6 x 7 and 3 x 4 pixels.

Eval-mode outputs are held to 1e-4 of the reference's largest magnitude
(tests/test_torch_zoo.py ``hold``), FAMAG also in train mode
(tests/test_torch_nets_zoo.py ``hold_train``).  FAMAG's padded 1x1 convs
grow the map by 2 a call, in both packages.
"""

import pytest
import torch

from rnd_semantic_segmentation_tpu.models import fam_variants as J

from rnd_semantic_segmentation_torch.ckpt.torch_import import research_state_dict_from_flax
from rnd_semantic_segmentation_torch.models import fam_variants as P

from test_torch_nets_zoo import hold_train
from test_torch_zoo import _x, hold

torch.set_num_threads(2)  # six test workers share the host's cores

IP = 16
TAPS = [_x(2, 12, 14, 8, seed=0), _x(2, 6, 7, 12, seed=1), _x(2, 3, 4, 20, seed=2)]


@pytest.mark.parametrize("name", ["FAMAG", "FAMAGv3", "FAMSCWS"])
def test_fam_variant(name):
    jax_net = getattr(J, name)(interplanes=IP)
    port_net = getattr(P, name)(8, 12, 20, interplanes=IP)
    rules = "FAMAG" if name == "FAMAGv3" else name
    variables = hold(rules, jax_net, port_net, TAPS)
    with torch.no_grad():
        out = port_net(*(torch.from_numpy(t.transpose(0, 3, 1, 2).copy()) for t in TAPS))
    grown = 2 if name.startswith("FAMAG") else 0
    assert out.shape == (2, IP, 12 + grown, 14 + grown)
    sd = research_state_dict_from_flax(rules, variables)
    if name == "FAMSCWS":
        assert {"conv0.weight", "bn2.running_var", "conv_att3.bias"} <= set(sd)
    else:
        assert {"l0.conv.weight", "psi_3.bn.running_mean", "bn_out.weight"} <= set(sd)
    if name == "FAMAG":
        hold_train("FAMAG", jax_net, port_net, TAPS, variables)


def test_fam_pra():
    crop = _x(2, 12, 14, 1, seed=3)
    variables = hold("FAMPra", J.FAMPra(IP), P.FAMPra(8, 12, 20, IP), TAPS + [crop])
    sd = research_state_dict_from_flax("FAMPra", variables)
    assert {"fam.conv0.weight", "fam.bn3.running_var", "fam.conv_d2.bias",
            "linear.weight"} <= set(sd)
