"""The port's ``deeplab_vgg16`` (the VGG16-FCN feature extractor under the
ASPP-V2 head) against the JAX package's, on the CPU in float32 with TF32 off.

Weights start as JAX variables from ``jax.eval_shape`` filled with numpy
(conv kernels at variance 1.7/fan_in, biases in [-0.1, 0.1]) and reach the
port through ``deeplab_state_dicts_from_flax``, which must invert the JAX
package's ``convert_state_dict`` with ``VGG16_RULES`` exactly.

Tolerances: the features and logits within 1e-4 of their largest magnitude
(15 convolutions of up to 9,216 products each, summed in another order than
XLA's; measured about 2e-6); the weight round trips: exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnd_semantic_segmentation_tpu.ckpt.torch_import import VGG16_RULES, convert_state_dict
from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.models.build import build_segmentor as jax_build
from rnd_semantic_segmentation_tpu.train.segmentor import Segmentor as JaxSegmentor

from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    deeplab_flax_from_state_dicts,
    deeplab_state_dicts_from_flax,
    load_part,
)
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.models.aspp import VGG16FeatureExtractor
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor

torch.set_num_threads(2)  # six test workers share the host's cores

NAME, NC = "deeplab_vgg16", 5
CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def port_cfg(*opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", NAME, "MODEL.NUM_CLASSES", str(NC),
                         "MODEL.DEVICE", "cpu", *opts])
    return cfg


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_model():
    cfg = jax_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", NAME, "MODEL.NUM_CLASSES", str(NC)])
    seg = JaxSegmentor(jax_build(cfg), NC)
    template = jax.eval_shape(seg.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    rng = np.random.RandomState(1)

    def fill(path, leaf):
        if str(getattr(path[-1], "key", path[-1])) == "kernel":
            return (rng.randn(*leaf.shape) * np.sqrt(1.7 / np.prod(leaf.shape[:-1]))
                    ).astype(np.float32)
        return rng.uniform(-0.1, 0.1, leaf.shape).astype(np.float32)

    return seg, jax.tree_util.tree_map_with_path(fill, template)


@pytest.fixture(scope="module")
def port_model(jax_model):
    _, variables = jax_model
    seg = Segmentor(build_segmentor(port_cfg()), NC)
    for name, sd in deeplab_state_dicts_from_flax(variables).items():
        load_part(seg.spec.modules[name], sd, name)
    return seg


def test_build_gives_vgg16_fcn_under_the_aspp_head():
    """Thirteen biased 3x3 convs in torchvision's layout, pools after blocks 1-3
    only, block 5 dilated 2, fc6/fc7 dilated 4 to 1024 channels, no norm;
    MODEL.FREEZE_BN changes nothing."""
    for freeze_bn in ("True", "False"):
        spec = build_segmentor(port_cfg("MODEL.FREEZE_BN", freeze_bn))
        assert (spec.family, spec.backbone, spec.optimizer, spec.ckpt_prefix,
                spec.disc_tap) == ("deeplab", "vgg16", "sgd", "Aspp", "features")
        assert spec.lr_mults == {"feature_extractor": 1.0, "classifier": 10.0}
        fea = spec.modules["feature_extractor"]
        convs = [i for i, m in enumerate(fea.features) if isinstance(m, torch.nn.Conv2d)]
        assert tuple(convs) == CONV_IDX and len(fea.features) == 30
        assert [fea.features[i].dilation for i in convs] == [(1, 1)] * 10 + [(2, 2)] * 3
        assert [fea.features[i].padding for i in convs] == [(1, 1)] * 10 + [(2, 2)] * 3
        assert isinstance(fea.features[23], torch.nn.Identity)  # pool4 dropped
        assert all(fea.features[i].bias is not None for i in convs)
        assert (fea.fc6.dilation, fea.fc6.padding, fea.fc7.out_channels) == ((4, 4), (4, 4), 1024)
        assert spec.modules["classifier"].conv2d_list[0].in_channels == 1024
        assert not any("Norm" in type(m).__name__ for m in fea.modules())


def test_port_keys_are_those_the_jax_rules_read(port_model, jax_model):
    """``convert_state_dict(sd, VGG16_RULES)`` of the JAX package reads the
    port's feature extractor into the JAX tree: every path, leaf for leaf."""
    _, variables = jax_model
    sd = {k: v.numpy() for k, v in port_model.spec.modules["feature_extractor"]
          .state_dict().items()}
    assert {k.rsplit(".", 1)[0] for k in sd} == (
        {f"features.{i}" for i in CONV_IDX} | {"fc6", "fc7"})
    converted = _flat(convert_state_dict(sd, VGG16_RULES))
    want = _flat({"params": variables["feature_extractor"]["params"]})
    assert set(converted) == set(want)
    for key, leaf in want.items():
        np.testing.assert_array_equal(converted[key], leaf, err_msg=key)


def test_weight_round_trip_is_exact(port_model, jax_model):
    _, variables = jax_model
    sds = {n: m.state_dict() for n, m in port_model.spec.modules.items()}
    back = _flat(deeplab_flax_from_state_dicts(sds, variables))
    want = _flat(variables)
    assert set(back) == set(want)
    for key, leaf in want.items():
        np.testing.assert_array_equal(back[key], leaf, err_msg=key)


@pytest.mark.parametrize("hw", [(64, 64), (67, 75)], ids=["64x64", "67x75"])
def test_features_and_logits_match_the_jax_ones(port_model, jax_model, hw):
    """At 67x75 the floor-mode pools take 67 -> 33 -> 16 -> 8, as XLA's
    reduce_window does."""
    jseg, variables = jax_model
    x = np.random.RandomState(3).rand(2, *hw, 3).astype(np.float32)
    params = {n: t["params"] for n, t in variables.items()}
    (ref,), _, ref_fea = jseg.forward(params, {n: {} for n in variables}, jnp.asarray(x))
    with torch.no_grad():
        (out,), fea = port_model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tuple(fea.shape) == (2, 1024, hw[0] // 2 // 2 // 2, hw[1] // 2 // 2 // 2)
    for got, want in ((fea, ref_fea), (out, ref)):
        got, want = got.permute(0, 2, 3, 1).numpy(), np.asarray(want)
        assert got.shape == want.shape and np.isfinite(got).all()
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert err <= 1e-4 * scale, f"{err} > 1e-4 x {scale}"


def test_seeded_vgg16_logits_are_finite_and_of_order_one():
    """No norm damps VGG16: ``randomize_weights_`` draws each conv at variance
    1.7/fan_in, which with a ReLU keeps the second moment within 0.85x per
    layer, so the logits stay finite and of order 0.1 to 10."""
    seg = Segmentor(build_segmentor(port_cfg()), NC)
    randomize_weights_(seg, seed=0)
    x = torch.rand(1, 3, 96, 128, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        (logits,), fea = seg(x)
    assert torch.isfinite(logits).all() and tuple(logits.shape) == (1, NC, 96, 128)
    assert 0.1 < logits.abs().max() < 10
    assert (fea > 0).float().mean() > 0.05  # the ReLUs have not all died


def test_vgg16_feature_extractor_takes_any_three_channel_image():
    fea = VGG16FeatureExtractor()
    with torch.no_grad():
        out = fea(torch.zeros(1, 3, 17, 9))
    assert tuple(out.shape) == (1, 1024, 2, 1)
