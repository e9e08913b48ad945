"""The port's context-aggregation heads (models/contextagg.py), the GALD
blocks of models/gcpa.py and ``Res2Net(gc_blocks=True)`` against the JAX
package's, on the CPU in float32, at small widths (the fixed widths of
CA, SRM, SA and GCPAGALDNet stay theirs).

As in tests/test_torch_zoo.py: seeded JAX variables, carried over by
``research_state_dict_from_flax`` (round trip exact), eval-mode outputs held
to 1e-4 of the reference's largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnd_semantic_segmentation_tpu.models import contextagg as J
from rnd_semantic_segmentation_tpu.models import gcpa as JG
from rnd_semantic_segmentation_tpu.models.res2net import Res2Net as JaxRes2Net

from rnd_semantic_segmentation_torch.ckpt.torch_import import research_state_dict_from_flax
from rnd_semantic_segmentation_torch.models import contextagg as P
from rnd_semantic_segmentation_torch.models import gcpa as PG
from rnd_semantic_segmentation_torch.models.res2net import Res2Net

from test_torch_zoo import _x, hold

torch.set_num_threads(2)  # six test workers share the host's cores


def test_spatial_cgnl_and_gald_block():
    hold("SpatialCGNL", JG.SpatialCGNL(32), PG.SpatialCGNL(64, 32), [_x(2, 9, 11, 64)])
    hold("SpatialCGNL", JG.SpatialCGNL(32, use_scale=True),
         PG.SpatialCGNL(64, 32, use_scale=True), [_x(2, 9, 11, 64)])
    sd = research_state_dict_from_flax("GALDBlock", hold(
        "GALDBlock", JG.GALDBlock(32), PG.GALDBlock(64, 32), [_x(2, 15, 17, 64)]))
    assert {"down.0.weight", "down.1.running_var", "long_relation.gn.weight",
            "local_attention.dconv2.0.weight"} <= set(sd)


def test_channel_self_refinement_and_spatial_attention():
    hold("CA", J.CA(), P.CA(48, 40), [_x(2, 6, 7, 48), _x(2, 3, 4, 40, seed=1)])
    hold("SRM", J.SRM(), P.SRM(48), [_x(2, 6, 7, 48)])
    hold("SA", J.SA(), P.SA(48, 40), [_x(2, 6, 8, 48), _x(2, 3, 4, 40, seed=1)])
    hold("SmallLocalAttenModule", J.SmallLocalAttenModule(), P.SmallLocalAttenModule(32),
         [_x(2, 5, 6, 32)])


def test_gald_head():
    sd = research_state_dict_from_flax("GALDHead", hold(
        "GALDHead", J.GALDHead(64, 5), P.GALDHead(96, 64, 5), [_x(2, 15, 15, 96)]))
    assert {"conva.0.weight", "a2block.down.0.weight", "bottleneck.3.weight"} <= set(sd)


def test_gcpa_gald_net():
    """Res2Net50 + the GALD head at 224, the least side its GALD block takes;
    the norm scales damped to [0.25, 0.75] as ``randomize_weights_`` damps a
    Res2Net's (at [0.5, 1.5] its 16 residual blocks in eval mode overflow
    float32 in the CGNL products)."""
    hold("GCPAGALDNet", J.GCPAGALDNet(1), P.GCPAGALDNet(1),
         [np.random.RandomState(3).rand(1, 224, 224, 3).astype(np.float32)],
         bn_scale=(0.25, 0.75))


def test_psp_module():
    sd = research_state_dict_from_flax("PSPModule", hold(
        "PSPModule", J.PSPModule(32), P.PSPModule(48, 32), [_x(2, 13, 11, 48)]))
    assert {"stages.3.1.weight", "stages.3.2.running_mean", "bottleneck.0.weight"} <= set(sd)


@pytest.mark.parametrize("pool,fusions", [("att", ("channel_add",)),
                                          ("att", ("channel_add", "channel_mul")),
                                          ("avg", ("channel_mul",))])
def test_gcnet_blocks(pool, fusions):
    sd = research_state_dict_from_flax("ContextBlock2d", hold(
        "ContextBlock2d", J.ContextBlock2d(64, pool=pool, fusions=fusions),
        P.ContextBlock2d(64, 64, pool=pool, fusions=fusions), [_x(2, 5, 6, 64)]))
    assert sd[f"{fusions[0]}_conv.1.weight"].shape == (8, 1, 1)  # LayerNorm([C, 1, 1])
    hold("SNLBlock2d", J.SNLBlock2d(32, pool=pool, fusions=fusions),
         P.SNLBlock2d(32, 32, pool=pool, fusions=fusions), [_x(2, 5, 6, 32)])


def test_gc_head():
    hold("GCHead", J.GCHead(64, 5), P.GCHead(48, 64, 5), [_x(2, 7, 9, 48)])


def test_holistic_attention():
    np.testing.assert_array_equal(P.gkern(31, 4), J.gkern(31, 4))
    x = _x(2, 7, 9, 3)
    np.testing.assert_allclose(
        P.min_max_norm(torch.from_numpy(x.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1).numpy(),
        np.asarray(J.min_max_norm(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(P.HolisticAttention().gaussian_kernel.detach()[0, 0].numpy(),
                                  np.float32(J.gkern(31, 4)))
    attention = np.abs(_x(2, 40, 36, 1, seed=1))
    hold("HolisticAttention", J.HolisticAttention(), P.HolisticAttention(),
         [attention, _x(2, 40, 36, 1, seed=2)])


def test_res2net_with_gc_blocks():
    sd = research_state_dict_from_flax("Res2Net", hold(
        "Res2Net", JaxRes2Net(layers=(1, 1, 1, 1), gc_blocks=True),
        Res2Net(layers=(1, 1, 1, 1), gc_blocks=True), [_x(1, 64, 64, 3)]))
    assert {"conv1.0.weight", "layer2_gcb.conv_mask.weight", "layer4_gcb.channel_add_conv.3.bias",
            "layer2.0.downsample.1.weight"} <= set(sd)
    assert not any(k.startswith("layer1_gcb") for k in sd)
