"""The port's DeepLabV2 slice (dilated ResNet + ASPP-V2, FrozenBN, the deeplab
probability head with its test-time augmentation, the SGD train step, the
``aspp`` transforms and the three CLIs) against the JAX package's, on the CPU
in float32 with TF32 off.

Weights start as JAX variables from ``jax.eval_shape`` (nothing compiles),
filled with numpy: conv kernels at variance 1.7/fan_in, nonzero biases, norm
weights in [0.25, 0.75] inside the ResNet (as ``randomize_weights_`` does:
with running statistics nothing normalises a residual sum, and at [0.5, 1.5]
ResNet101's logits pass 1e5) and random running statistics.  They reach the
port through ``deeplab_state_dicts_from_flax``, which must invert the JAX
package's ``convert_state_dict`` exactly; the train-step tests go the other
way, from the port's ``randomize_weights_`` through
``deeplab_flax_from_state_dicts``.

Tolerances, relative to the largest magnitude of the JAX tensor: float32
sums over up to 4,608 products (3x3x512) in another order than XLA's differ
by about 1e-6 of the magnitude per layer.  Single blocks and the ASPP head:
2e-5.  ResNet50's features and logits (53 convolutions deep): 1e-4, inside
the 1e-3 the slice is held to.  Probabilities: 1e-4 absolute (bounded to
[0, 1] by the softmax), argmax equal wherever the JAX top-2 gap exceeds twice
that.  The train step is in the docstring of its test.
"""

import json
import logging
import os
import random
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnd_semantic_segmentation_tpu.ckpt import torch_import as TI
from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.data import transforms as JT
from rnd_semantic_segmentation_tpu.data.augment import Augmenter as JaxAugmenter
from rnd_semantic_segmentation_tpu.eval.tester import Tester as JaxTester
from rnd_semantic_segmentation_tpu.models import layers as jax_layers
from rnd_semantic_segmentation_tpu.models import resnet as jax_resnet
from rnd_semantic_segmentation_tpu.models.aspp import ASPPClassifierV2 as JaxASPP
from rnd_semantic_segmentation_tpu.models.build import build_segmentor as jax_build
from rnd_semantic_segmentation_tpu.train.segmentor import Segmentor as JaxSegmentor
from rnd_semantic_segmentation_tpu.train.steps import (
    make_optimizers as jax_make_optimizers,
    make_src_train_step as jax_make_step,
)

from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    deeplab_flax_from_state_dicts,
    deeplab_state_dicts_from_flax,
    load_part,
)
from rnd_semantic_segmentation_torch.cli import test as test_cli
from rnd_semantic_segmentation_torch.cli import train_src
from rnd_semantic_segmentation_torch.cli.common import load_cfg
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.data import Augmenter
from rnd_semantic_segmentation_torch.data import transforms as T
from rnd_semantic_segmentation_torch.eval.tester import Tester
from rnd_semantic_segmentation_torch.models import resnet
from rnd_semantic_segmentation_torch.models.aspp import ASPPClassifierV2
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.models.layers import FrozenBatchNorm2d, make_norm
from rnd_semantic_segmentation_torch.serve.server import make_server
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor
from rnd_semantic_segmentation_torch.train.state import TrainState, make_optimizers
from rnd_semantic_segmentation_torch.train.steps import make_src_train_step

torch.set_num_threads(2)  # six test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "deeplabv2_r101_src.yaml")
SIZE, NC = 64, 5
PROB_TOL = 1e-4


def jax_cfg(name, freeze_bn=True, *opts):
    cfg = jax_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", name, "MODEL.NUM_CLASSES", str(NC),
                         "MODEL.FREEZE_BN", str(freeze_bn), *opts])
    return cfg


def port_cfg(name, freeze_bn=True, *opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", name, "MODEL.NUM_CLASSES", str(NC),
                         "MODEL.FREEZE_BN", str(freeze_bn), "MODEL.DEVICE", "cpu", *opts])
    return cfg


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _assert_close_to_max(out, ref, rel):
    ref = np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all()
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, f"max abs error {err} > {rel} x {scale}"


def _assert_probs_agree(probs, ref):
    ref = np.asarray(ref)
    assert probs.shape == ref.shape
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    err = np.abs(probs - ref).max()
    assert err <= PROB_TOL, f"probability error {err} > {PROB_TOL}"
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * PROB_TOL
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(probs.argmax(-1)[clear], ref.argmax(-1)[clear])


def _template(name, freeze_bn, size=SIZE):
    seg = JaxSegmentor(jax_build(jax_cfg(name, freeze_bn)), NC)
    return seg, jax.eval_shape(seg.init, jax.random.PRNGKey(0),
                               jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32))


def _randomise(path, leaf, rng):
    names = [str(getattr(p, "key", p)) for p in path]
    shape, name = leaf.shape, names[-1]
    if name == "kernel":
        return (rng.randn(*shape) * np.sqrt(1.7 / np.prod(shape[:-1]))).astype(np.float32)
    lo, hi = {"bias": (-0.1, 0.1), "mean": (-0.2, 0.2), "var": (0.5, 1.5),
              "scale": (0.25, 0.75), "weight": (0.25, 0.75)}[name]
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _jax_variables(template, seed=1):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(lambda p, l: _randomise(p, l, rng), template)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


# -- weights ---------------------------------------------------------------------

@pytest.fixture(scope="module", params=[True, False], ids=["frozen", "bn"])
def r101(request):
    """deeplab_resnet101's JAX variables, numpy-filled, and the port's model."""
    _, template = _template("deeplab_resnet101", request.param)
    spec = build_segmentor(port_cfg("deeplab_resnet101", request.param))
    return request.param, _jax_variables(template), spec


def test_port_keys_and_shapes_are_those_the_jax_rules_expect(r101):
    freeze_bn, variables, spec = r101
    sds = deeplab_state_dicts_from_flax(variables)
    for name, module in spec.modules.items():
        want = {k: tuple(v.shape) for k, v in sds[name].items()}
        assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == want
    fe = sds["feature_extractor"]
    assert fe["backbone.layer3.0.conv2.weight"].shape == (256, 256, 3, 3)
    assert fe["backbone.layer3.22.conv3.weight"].shape == (1024, 256, 1, 1)
    assert fe["backbone.layer1.0.downsample.0.weight"].shape == (256, 64, 1, 1)
    assert "backbone.layer1.1.downsample.0.weight" not in fe
    assert fe["backbone.layer4.2.bn3.running_var"].shape == (2048,)
    assert ("backbone.bn1.num_batches_tracked" in fe) != freeze_bn
    assert sds["classifier"]["conv2d_list.3.weight"].shape == (NC, 2048, 3, 3)
    assert sds["classifier"]["conv2d_list.0.bias"].shape == (NC,)
    norms = [m for m in spec.modules["feature_extractor"].modules()
             if isinstance(m, (FrozenBatchNorm2d, torch.nn.BatchNorm2d))]
    assert len(norms) == 104 and all(isinstance(m, FrozenBatchNorm2d) == freeze_bn
                                     for m in norms)
    if freeze_bn:  # the optimizer never sees a frozen buffer
        assert not any("bn" in n or "downsample.1" in n
                       for n, _ in spec.modules["feature_extractor"].named_parameters())


def test_weight_round_trip_is_exact(r101):
    freeze_bn, variables, _ = r101
    sds = deeplab_state_dicts_from_flax(variables)
    numpy_sds = {part: {k: v.numpy() for k, v in sd.items()} for part, sd in sds.items()}
    back = {"feature_extractor": TI.convert_state_dict(numpy_sds["feature_extractor"],
                                                       TI.RESNET_BACKBONE_RULES,
                                                       freeze_bn=freeze_bn),
            "classifier": TI.convert_state_dict(numpy_sds["classifier"],
                                                TI.ASPP_CLASSIFIER_RULES)}
    want, got = _flat(variables), _flat(back)
    assert set(got) == set(want) and len(want) > 300
    assert any("['frozen']" in k for k in want) == freeze_bn
    for key, leaf in want.items():
        assert got[key].dtype == leaf.dtype and got[key].shape == leaf.shape, key
        np.testing.assert_array_equal(got[key], leaf, err_msg=key)
    again = _flat(deeplab_flax_from_state_dicts(sds, variables))
    assert set(again) == set(want)
    for key, leaf in want.items():
        np.testing.assert_array_equal(again[key], leaf, err_msg=key)


@pytest.mark.parametrize("backbone", ["resnet18", "resnet34", "resnet50", "resnet101",
                                      "resnet152"])
@pytest.mark.parametrize("freeze_bn", [True, False], ids=["frozen", "bn"])
def test_build_segmentor_builds_every_resnet(backbone, freeze_bn):
    spec = build_segmentor(port_cfg(f"deeplab_{backbone}", freeze_bn))
    assert (spec.family, spec.backbone, spec.optimizer, spec.ckpt_prefix,
            spec.disc_tap) == ("deeplab", backbone, "sgd", "Aspp", "features")
    assert spec.lr_mults == {"feature_extractor": 1.0, "classifier": 10.0}
    head = spec.modules["classifier"].conv2d_list
    assert [c.dilation for c in head] == [(6, 6), (12, 12), (18, 18), (24, 24)]
    assert [c.padding for c in head] == [(6, 6), (12, 12), (18, 18), (24, 24)]
    assert head[0].in_channels == resnet.output_channels(backbone)
    norm = spec.modules["feature_extractor"].backbone.bn1
    assert type(norm) is (FrozenBatchNorm2d if freeze_bn else torch.nn.BatchNorm2d)


@pytest.mark.parametrize("name", ["deeplab_vgg19", "deeplab_resnext50_32x4d",
                                  "deeplab_resnet200", "deeplab"])
def test_unported_deeplab_backbones_raise(name):
    with pytest.raises(NotImplementedError, match="one of vgg16, resnet18"):
        build_segmentor(port_cfg(name))


def test_seeded_resnet101_logits_stay_of_order_one(r101):
    """``randomize_weights_`` draws a ResNet's norm weights from [0.25, 0.75]:
    with running statistics nothing normalises a residual sum, and at
    BatchNorm's [0.5, 1.5] the 33 blocks of ResNet101 blow the logits up
    (about 6e5 here)."""
    _, _, spec = r101
    seg = Segmentor(spec, NC)
    randomize_weights_(seg, seed=0)
    x = torch.randn(1, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        (damped,), _ = seg(x)
        gen = torch.Generator().manual_seed(1)
        for m in seg.modules():
            if isinstance(m, (FrozenBatchNorm2d, torch.nn.BatchNorm2d)):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
        (undamped,), _ = seg(x)
    assert 0.1 < damped.abs().max() < 10
    assert undamped.abs().max() > 1e4


# -- modules ---------------------------------------------------------------------

def test_frozen_batchnorm_applies_no_epsilon():
    """running_var 1e-4: an eps of 1e-5 would change the output by 5%."""
    rng = np.random.RandomState(3)
    c = 6
    buffers = {"weight": rng.uniform(0.5, 1.5, c), "bias": rng.randn(c),
               "mean": rng.randn(c), "var": np.full(c, 1e-4)}
    buffers = {k: v.astype(np.float32) for k, v in buffers.items()}
    x = rng.randn(2, 5, 7, c).astype(np.float32)
    ref = jax_layers.FrozenBatchNorm().apply({"frozen": buffers}, jnp.asarray(x))
    bn = FrozenBatchNorm2d(c)
    bn.load_state_dict({"weight": torch.from_numpy(buffers["weight"]),
                        "bias": torch.from_numpy(buffers["bias"]),
                        "running_mean": torch.from_numpy(buffers["mean"]),
                        "running_var": torch.from_numpy(buffers["var"])})
    for train in (True, False):  # frozen either way
        out = _nhwc(bn.train(train)(_nchw(x)))
        _assert_close_to_max(out, ref, 1e-6)
    scale = buffers["weight"] / np.sqrt(buffers["var"] + 1e-5)  # with eps: far off
    eps = x * scale + (buffers["bias"] - buffers["mean"] * scale)
    assert np.abs(eps - np.asarray(ref)).max() > 1e-2 * np.abs(np.asarray(ref)).max()
    assert not list(bn.parameters())
    assert type(make_norm("bn")(c)) is torch.nn.BatchNorm2d and make_norm("bn")(c).eps == 1e-5
    assert type(make_norm("frozen")(c)) is FrozenBatchNorm2d
    with pytest.raises(ValueError):
        make_norm("group")


@pytest.mark.parametrize("kind,stride,dilation,inplanes,planes,norm", [
    ("bottleneck", 2, 2, 32, 16, "bn"),
    ("bottleneck", 2, 2, 32, 16, "frozen"),
    ("bottleneck", 1, 4, 64, 16, "frozen"),     # no downsample: 64 = 16 x 4
    ("basic", 2, 1, 16, 32, "bn"),
    ("basic", 1, 1, 32, 32, "frozen"),
], ids=["bottleneck-s2-d2-ds-bn", "bottleneck-s2-d2-ds-frozen", "bottleneck-d4-frozen",
        "basic-s2-ds-bn", "basic-frozen"])
def test_residual_block_matches_the_jax_block(kind, stride, dilation, inplanes, planes,
                                              norm):
    port_cls = resnet.Bottleneck if kind == "bottleneck" else resnet.BasicBlock
    jax_cls = jax_resnet.Bottleneck if kind == "bottleneck" else jax_resnet.BasicBlock
    has_ds = stride != 1 or inplanes != planes * port_cls.expansion
    block = port_cls(inplanes, planes, stride=stride, dilation=dilation,
                     has_downsample=has_ds, norm=make_norm(norm))
    randomize_weights_(block, seed=4)
    assert (block.downsample is not None) == has_ds
    sd = {k: v.numpy() for k, v in block.state_dict().items()}
    variables = TI.convert_state_dict(sd, TI.RESNET_RULES, freeze_bn=norm == "frozen")
    x = np.random.RandomState(5).randn(2, 13, 11, inplanes).astype(np.float32)
    ref = jax_cls(planes=planes, stride=stride, dilation=dilation, has_downsample=has_ds,
                  norm=jax_layers.make_norm(norm)).apply(variables, jnp.asarray(x))
    with torch.no_grad():
        out = _nhwc(block.eval()(_nchw(x)))
    assert out.shape[1:3] == ((7, 6) if stride == 2 else (13, 11))
    _assert_close_to_max(out, ref, 2e-5)


@pytest.mark.parametrize("fea_hw", [(7, 9), (52, 56)], ids=["padding", "every-tap-inside"])
def test_aspp_head_at_a_label_size_other_than_8x(fea_hw):
    """At 7x9 most taps of the dilated branches fall into the padding; at
    52x56 every tap of every branch reaches a feature somewhere."""
    rng = np.random.RandomState(6)
    fea = rng.randn(2, *fea_hw, 64).astype(np.float32)
    head = ASPPClassifierV2(64, NC)
    assert float(head.conv2d_list[0].weight.detach().std()) == pytest.approx(0.01, rel=0.1)
    assert not head.conv2d_list[2].bias.any()
    randomize_weights_(head, seed=6)
    sd = {k: v.numpy() for k, v in head.state_dict().items()}
    variables = TI.convert_state_dict(sd, TI.ASPP_CLASSIFIER_RULES)
    for size in ((50, 61), (7, 9), (3, 4)):
        ref = JaxASPP(num_classes=NC).apply(variables, jnp.asarray(fea), size=size)
        with torch.no_grad():
            out = _nhwc(head(_nchw(fea), size))
        assert out.shape == (2, *size, NC)
        _assert_close_to_max(out, ref, 2e-5)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).randn(2, SIZE, SIZE, 3).astype(np.float32)


@pytest.fixture(scope="module")
def r50(images):
    seg, template = _template("deeplab_resnet50", True)
    variables = _jax_variables(template, seed=2)
    params = {n: v["params"] for n, v in variables.items()}
    stats = {n: {k: c for k, c in v.items() if k != "params"} for n, v in variables.items()}
    fwd = jax.jit(lambda p, s, x: seg.forward(p, s, x, label_size=(SIZE, SIZE))[::2])
    (logits,), features = fwd(params, stats, jnp.asarray(images))
    tester = Tester(port_cfg("deeplab_resnet50"), logging.getLogger("torch_deeplab"))
    sds = deeplab_state_dicts_from_flax(variables)
    for name, module in tester.spec.modules.items():
        load_part(module, sds[name], name)
    return tester, np.asarray(features), np.asarray(logits)


def test_resnet50_features_and_logits_match(r50, images):
    tester, ref_features, ref_logits = r50
    with torch.no_grad():
        (logits,), features = tester.segmentor(_nchw(images), label_size=(SIZE, SIZE))
    assert features.shape == (2, 2048, 8, 8) and logits.shape == (2, NC, SIZE, SIZE)
    _assert_close_to_max(_nhwc(features), ref_features, 1e-4)
    _assert_close_to_max(_nhwc(logits), ref_logits, 1e-4)
    assert 0.1 < np.abs(ref_logits).max() < 100  # the seeded scale stays of order 1


# -- probability head and test-time augmentation ------------------------------------

@pytest.fixture(scope="module")
def r18_tester_pair(tmp_path_factory):
    """A JAX and a port deeplab_resnet18 Tester over the same weights, for
    each TTA setting."""
    _, template = _template("deeplab_resnet18", True)
    variables = _jax_variables(template, seed=3)
    sds = deeplab_state_dicts_from_flax(variables)

    def make(*opts):
        tmp = tmp_path_factory.mktemp("tta")
        jt = JaxTester(jax_cfg("deeplab_resnet18", True, "OUTPUT_DIR", str(tmp), *opts),
                       None, logging.getLogger("jax_deeplab"))
        jt.variables = variables
        port = Tester(port_cfg("deeplab_resnet18", True, *opts),
                      logging.getLogger("torch_deeplab"))
        for name, module in port.spec.modules.items():
            load_part(module, sds[name], name)
        return jt, port
    return make


@pytest.mark.parametrize("opts", [(), ("TEST.FLIP_TTA", "True"),
                                  ("TEST.MULTI_SCALE", "True", "TEST.FLIP_TTA", "True"),
                                  ("TEST.MULTI_SCALE", "True", "TEST.SCALES", "(0.5, 1.25)")],
                         ids=["plain", "flip", "multi-scale-flip", "multi-scale"])
def test_tester_probabilities_match(r18_tester_pair, opts):
    jt, port = r18_tester_pair(*opts)
    x = np.random.RandomState(8).randn(1, 56, 72, 3).astype(np.float32)
    label_size = (60, 70)
    ref = jt._probs_impl(jt.variables, jnp.asarray(x), label_size)
    probs = port._probs_impl(_nchw(x), label_size)
    assert probs.shape == (1, NC, *label_size)
    _assert_probs_agree(_nhwc(probs), ref)


@pytest.mark.parametrize("opts", [("TEST.FLIP_TTA", "True"), ("TEST.MULTI_SCALE", "True")],
                         ids=["flip", "multi-scale"])
def test_tta_with_more_than_one_image_raises(opts):
    tester = Tester(port_cfg("deeplab_resnet18", True, *opts), logging.getLogger("tta"))
    with pytest.raises(ValueError, match="TEST.BATCH_SIZE"):
        tester._probs_impl(torch.zeros(2, 3, 32, 32), (32, 32))
    assert tester._probs_impl(torch.zeros(1, 3, 32, 32), (32, 32)).shape == (1, NC, 32, 32)


# -- train step --------------------------------------------------------------------

STEPS_PER_EPOCH = 10
TRAIN_OPTS = ("SOLVER.BASE_LR", "1e-3", "SOLVER.EPOCHS", "2", "MODEL.DTYPE", "float32")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(9)
    label = rng.randint(0, NC, (2, SIZE, SIZE)).astype(np.int32)
    label[:, :20, :30] = 255
    return {"image": rng.randn(2, SIZE, SIZE, 3).astype(np.float32), "label": label}


def _state_dicts(seg):
    return {n: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for n, m in seg.spec.modules.items()}


def _params(seg, template):
    tree = deeplab_flax_from_state_dicts(_state_dicts(seg), template)
    return _flat({n: t["params"] for n, t in tree.items()})


@pytest.mark.parametrize("freeze_bn", [True, False], ids=["frozen", "bn"])
def test_two_sgd_steps_match_the_jax_steps(batch, freeze_bn):
    """Two steps of deeplab_resnet18 at 64x64, batch 2, SGD (momentum 0.9,
    weight decay 5e-4) with the classifier at 10x LR, poly LR.

    The update of every parameter leaf after one and after two steps is
    held against the JAX one: it is LR times the momentum sum of the
    gradients plus weight decay, linear in the gradients, so it holds the
    gradients and the optimizer together.  Both losses: 1e-5 relative
    (measured 4e-7).  With FrozenBN the step is as well conditioned as eval
    mode: each leaf's update within 2e-3 of its largest element (measured
    6.5e-4 at worst, in a leaf with small gradients).  With trainable BN every
    norm divides by the statistics of 2 images (layer4: 128 pixels), which
    amplifies rounding as GALD's train step does (``tests/test_torch_train.py``):
    each leaf's update within 2e-2 of its norm (measured 6.7e-3), and the BN
    running statistics within 1e-3 of their magnitude.
    """
    seg = Segmentor(build_segmentor(port_cfg("deeplab_resnet18", freeze_bn, *TRAIN_OPTS)), NC)
    randomize_weights_(seg, seed=10)
    jseg, template = _template("deeplab_resnet18", freeze_bn)
    variables = deeplab_flax_from_state_dicts(_state_dicts(seg), template)
    jcfg = jax_cfg("deeplab_resnet18", freeze_bn, *TRAIN_OPTS)
    state = jseg.make_states(variables, jax_make_optimizers(jseg.spec, jcfg))
    jstep = jax.jit(jax_make_step(jseg, jcfg, STEPS_PER_EPOCH))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    refs, metrics = [_flat({n: m.params for n, m in state.modules.items()})], []
    for _ in range(2):
        state, m = jstep(state, jbatch, jnp.float32(0))
        refs.append(_flat({n: m_.params for n, m_ in state.modules.items()}))
        metrics.append(m)

    cfg = port_cfg("deeplab_resnet18", freeze_bn, *TRAIN_OPTS)
    tstate = TrainState(optimizers=make_optimizers(seg.spec, cfg))
    assert all(isinstance(o, torch.optim.SGD) and o.param_groups[0]["momentum"] == 0.9
               and o.param_groups[0]["weight_decay"] == 5e-4
               for o in tstate.optimizers.values())
    step = make_src_train_step(seg, cfg, STEPS_PER_EPOCH, tstate)
    frozen_before = {k: v.clone() for k, v in seg.named_buffers()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = [_params(seg, template)]
    results = []
    for _ in range(2):
        results.append(step(tbatch, 0.0))
        got.append(_params(seg, template))
    lrs = {n: o.param_groups[0]["lr"] for n, o in tstate.optimizers.items()}
    assert lrs["classifier"] == pytest.approx(10 * lrs["feature_extractor"], rel=1e-12)
    assert results[0]["lr"] == 1e-3 and results[1]["lr"] == pytest.approx(
        1e-3 * (1 - 1 / 20) ** 0.9)
    for port, jx in zip(results, metrics):
        assert abs(port["lr"] - float(jx["lr"])) <= 1e-6 * port["lr"]
        assert abs(port["loss"] - float(jx["loss"])) <= 1e-5 * abs(float(jx["loss"]))
    assert results[1]["loss"] < results[0]["loss"]

    rel = 2e-3 if freeze_bn else 2e-2
    for i in (1, 2):
        for key, r in refs[i].items():
            want, have = r - refs[0][key], got[i][key] - got[0][key]
            assert np.abs(want).max() > 0, key  # every parameter moved
            if freeze_bn:
                err, scale = np.abs(have - want).max(), np.abs(want).max()
            else:
                err, scale = np.linalg.norm(have - want), np.linalg.norm(want)
            assert err <= rel * scale, f"step {i} {key}: {err} > {rel} x {scale}"

    buffers = dict(seg.named_buffers())
    if freeze_bn:  # FrozenBN buffers are bit-equal after two train steps
        assert all(torch.equal(buffers[k], v) for k, v in frozen_before.items())
        assert len(frozen_before) == 4 * 20
    else:
        stats = _flat({n: {"batch_stats": m.stats["batch_stats"]}
                       for n, m in state.modules.items() if "batch_stats" in m.stats})
        tree = deeplab_flax_from_state_dicts(_state_dicts(seg), template)
        mine = _flat({n: {"batch_stats": t["batch_stats"]} for n, t in tree.items()
                      if "batch_stats" in t})
        assert set(mine) == set(stats) and len(stats) == 2 * 20
        for key, r in stats.items():
            _assert_close_to_max(mine[key], r, 1e-3)


# -- transforms ----------------------------------------------------------------------

AUG_OPTS = ["AUG.NAME", "aspp", "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(40, 30)",
            "INPUT.TARGET_INPUT_SIZE_TRAIN", "(24, 20)", "INPUT.INPUT_SIZE_TEST", "(36, 28)"]
JITTER = ["INPUT.BRIGHTNESS", "0.4", "INPUT.CONTRAST", "0.3", "INPUT.SATURATION", "0.2",
          "INPUT.HUE", "0.1"]


def _aug_pair(mode, is_source, opts, seed):
    port = get_default_cfg()
    port.merge_from_list(AUG_OPTS + opts)
    jcfg = jax_default_cfg()
    jcfg.merge_from_list(AUG_OPTS + opts)
    ours = Augmenter(port, mode, is_source, rng=random.Random(seed)).build_transform()
    random.seed(seed)
    theirs = JaxAugmenter(jcfg, mode, is_source).build_transform()
    return ours, theirs


def _sample(seed):
    rng = np.random.RandomState(seed)
    image = (rng.rand(33, 45, 3) * 255).astype(np.uint8)
    label = rng.randint(0, NC, (33, 45)).astype(np.float32)
    return image, label


@pytest.mark.parametrize("mode,is_source,opts", [
    ("train", True, []),
    ("train", False, []),
    ("train", True, ["INPUT.TO_BGR255", "True", "INPUT.PIXEL_MEAN", "[102.9, 115.9, 123.2]",
                     "INPUT.PIXEL_STD", "[1.0, 1.0, 1.0]"]),
    ("test", False, []),
], ids=["source", "target", "bgr255", "test"])
def test_aspp_transforms_without_randomness_equal_the_jax_ones(mode, is_source, opts):
    image, label = _sample(0)
    ours, theirs = _aug_pair(mode, is_source, opts, seed=0)
    a, b = ours(image, label), theirs(image, label)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[0].dtype == np.float32
    if mode == "train":
        w, h = (40, 30) if is_source else (24, 20)
        assert a[0].shape == (h, w, 3) and a[1].shape == (h, w)
    else:
        assert a[0].shape == (28, 36, 3) and a[1].shape == label.shape  # label kept


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_aspp_pipeline_equals_the_jax_one_under_random_seed(seed):
    """Jitter, RandomScale, RandomCrop with padding and flip, all drawing from
    one ``random.Random(seed)`` against the global generator after
    ``random.seed(seed)``: the same pixels and labels, several images in a row."""
    opts = JITTER + ["INPUT.INPUT_SCALES_TRAIN", "(0.5, 1.5)",
                     "INPUT.HORIZONTAL_FLIP_PROB_TRAIN", "0.5"]
    ours, theirs = _aug_pair("train", True, opts, seed)
    outs = []
    for i in range(4):
        image, label = _sample(10 + i)
        a = ours(image, label)
        b = theirs(image, label)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
        assert a[0].shape == (30, 40, 3)
        outs.append(a)
    assert any((np.asarray(o[1]) == 255).any() for o in outs)  # some crop was padded


@pytest.mark.parametrize("name", ["scale", "crop", "flip", "jitter"])
def test_each_seeded_transform_equals_the_jax_one(name):
    make = {"scale": lambda m, **kw: m.RandomScale((0.6, 1.4), **kw),
            "crop": lambda m, **kw: m.RandomCrop((40, 50), pad_if_needed=True, **kw),
            "flip": lambda m, **kw: m.RandomHorizontalFlip(0.5, **kw),
            "jitter": lambda m, **kw: m.ColorJitter(0.4, 0.3, 0.2, 0.1, **kw)}[name]
    ours = make(T, rng=random.Random(21))
    random.seed(21)
    theirs = make(JT)
    for i in range(5):
        image, label = _sample(20 + i)
        a, b = ours(image, label), theirs(image, label)
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


# -- entry points ----------------------------------------------------------------------

def _cli_opts(out_dir, *more):
    return ["-cfg", CONFIG, "MODEL.NAME", "deeplab_resnet18", "MODEL.DEVICE", "cpu",
            "DATASETS.SOURCE_TRAIN", "synthetic_train", "DATASETS.TEST", "synthetic_val",
            "DATASETS.SYNTHETIC_LENGTH", "4", "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(48, 40)",
            "INPUT.INPUT_SIZE_TEST", "(48, 32)", "SOLVER.BATCH_SIZE", "2",
            "SOLVER.EPOCHS", "1", "DATA_PIPE.NUM_WORKERS", "2", "OUTPUT_DIR", str(out_dir),
            *more]


def test_train_test_and_serve_entry_points(tmp_path):
    """``cli.train_src`` takes 2 steps and writes ``Aspp-1.pth``; ``cli.test``
    evaluates it; the server built from the same options answers /predict."""
    import http.client
    import io

    from PIL import Image

    argv = sys.argv
    sys.argv = ["train_src"] + _cli_opts(tmp_path)
    try:
        train_src.cli()
    finally:
        sys.argv = argv
    chart = json.loads((tmp_path / "deeplab_chart_params.json").read_text())
    assert len(chart["loss"]) == 2 and all(np.isfinite(chart["loss"]))
    assert chart["learning rate"][0] == 5e-4
    ckpt = torch.load(tmp_path / "Aspp-1.pth", map_location="cpu", weights_only=True)
    assert {"feature_extractor", "classifier", "optimizer_feature_extractor",
            "optimizer_classifier"} <= set(ckpt)
    assert "backbone.layer4.1.bn2.running_var" in ckpt["feature_extractor"]

    args = test_cli.build_parser().parse_args(
        ["-c", os.path.join(REPO, "renders", "cityscapes.json")]
        + _cli_opts(tmp_path, "resume", "latest"))
    cfg = load_cfg(args)
    summary = test_cli.test(cfg, json.loads(open(args.config_path).read()), args)
    assert 0 <= summary["micro_miou"] <= 1
    cmt = json.loads((tmp_path / "deeplab_confusion_matrix.json").read_text())["cmt"]
    assert np.asarray(cmt).sum() == 4 * 48 * 32

    inf, httpd = make_server(cfg, {"palette": [0, 0, 0] * 19}, logging.getLogger("serve"),
                             port=0, max_batch=2)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        assert inf.ready.wait(120)
        buf = io.BytesIO()
        Image.fromarray((np.random.RandomState(0).rand(32, 48, 3) * 255)
                        .astype(np.uint8)).save(buf, format="PNG")
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
        conn.request("POST", "/predict?format=raw", body=buf.getvalue())
        resp = conn.getresponse()
        mask = np.asarray(Image.open(io.BytesIO(resp.read())))
        conn.close()
        assert resp.status == 200 and mask.shape == (32, 48) and mask.max() < 19
    finally:
        httpd.shutdown()
        httpd.server_close()
        inf.shutdown()
        thread.join(30)
    assert not thread.is_alive()
