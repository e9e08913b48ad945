"""The port's PraNet modules (``avg_pool``, ``scaled_size``, Res2Net50-v1b and
its ``Bottle2neck``, PraNet on Res2Net50 and on ResNet50, the weight bridge,
the structure loss, the min-max probability head and its batch coupling in
the server) against the JAX package's, on the CPU in float32 with TF32 off.

Weights start as JAX variables from ``jax.eval_shape`` (nothing compiles),
filled with numpy: conv kernels at variance 1.7/fan_in, small nonzero
biases, norm weights in [0.25, 0.75] and random running statistics (with
running statistics nothing normalises a residual sum, as in
``tests/test_torch_deeplab.py``).  They reach the port through
``pranet_state_dicts_from_flax``, which must invert the JAX package's
``convert_state_dict`` with ``PRANET_RULES`` and ``CRANET_RULES`` exactly.
The single-module tests go the other way, from the port's
``randomize_weights_`` through ``convert_state_dict``.  The JAX model runs
unjitted (a Res2Net50 forward at 64x64 costs about 20 s of op-by-op
dispatch here, less than its compile).

Tolerances, relative to the largest magnitude of the JAX tensor:
  * ``avg_pool``: 1e-6 (sums of at most 961 terms); the resizes: 4e-6 (the
    JAX package's interpolation weights are matrices, torch's computed per
    pixel: one float32 rounding of each apart, 1.03e-6 measured);
  * a ``Bottle2neck``, in eval and in train mode: 2e-5;
  * the Res2Net50 taps, the four PraNet maps and the layer4 tap at 64x64
    and 96x96: 1e-4 (about 60 convolutions deep; measured 4e-6 at worst);
  * the structure loss: 1e-6 relative, its gradient 1e-5 of its magnitude;
  * the probabilities of the head: 1e-4 absolute (the batch min-max
    stretches the sigmoid's range of about 0.1 to [0, 1]);
  * weight round trips: exact.
Every input side is a multiple of 32, as every side the JAX model runs:
the JAX shortcut pool floors its output size where the reference's (and the
port's) rounds up, and the two agree only on even sides.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnd_semantic_segmentation_tpu import losses as jax_losses
from rnd_semantic_segmentation_tpu.ckpt import torch_import as TI
from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.eval.tester import Tester as JaxTester
from rnd_semantic_segmentation_tpu.models import res2net as jax_res2net
from rnd_semantic_segmentation_tpu.models.build import build_segmentor as jax_build
from rnd_semantic_segmentation_tpu.ops import avg_pool as jax_avg_pool
from rnd_semantic_segmentation_tpu.ops import resize_bilinear as jax_resize
from rnd_semantic_segmentation_tpu.ops import scaled_size as jax_scaled_size
from rnd_semantic_segmentation_tpu.train.segmentor import Segmentor as JaxSegmentor
from rnd_semantic_segmentation_tpu.train.steps import make_family_loss as jax_family_loss

from rnd_semantic_segmentation_torch import losses
from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    load_part,
    pranet_flax_from_state_dicts,
    pranet_state_dicts_from_flax,
    save_reference_checkpoint,
)
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.eval.tester import Tester
from rnd_semantic_segmentation_torch.models.build import (
    build_adversarial_discriminator,
    build_segmentor,
    randomize_weights_,
    tap_channels,
)
from rnd_semantic_segmentation_torch.models.pranet import PraNet
from rnd_semantic_segmentation_torch.models.res2net import Bottle2neck, Res2Net
from rnd_semantic_segmentation_torch.ops import avg_pool, resize_bilinear, scaled_size
from rnd_semantic_segmentation_torch.serve.server import InferenceServer
from rnd_semantic_segmentation_torch.train.steps import make_family_loss

torch.set_num_threads(2)  # six test workers share the host's cores

NC = 2
BACKBONES = ("res2net50", "resnet50")


def jax_cfg(name, *opts):
    cfg = jax_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", name, "MODEL.NUM_CLASSES", str(NC), *opts])
    return cfg


def port_cfg(name, *opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", name, "MODEL.NUM_CLASSES", str(NC),
                         "MODEL.DEVICE", "cpu", *opts])
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


def _randomise(path, leaf, rng):
    name = str(getattr(path[-1], "key", path[-1]))
    shape = leaf.shape
    if name == "kernel":
        return (rng.randn(*shape) * np.sqrt(1.7 / np.prod(shape[:-1]))).astype(np.float32)
    lo, hi = {"bias": (-0.1, 0.1), "mean": (-0.2, 0.2), "var": (0.5, 1.5),
              "scale": (0.25, 0.75)}[name]
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _split(variables):
    return ({n: v["params"] for n, v in variables.items()},
            {n: {k: c for k, c in v.items() if k != "params"} for n, v in variables.items()})


# -- ops -----------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,stride,padding,include", [
    (2, 2, 0, False),   # the Res2Net shortcut
    (3, 1, 1, True),    # a stage block of layer1
    (3, 2, 1, True),    # a stage block of layers 2-4
    (31, 1, 15, True),  # the structure loss: the JAX package's separable path
], ids=["k2-s2-no-pad-count", "k3-s1-p1", "k3-s2-p1", "k31-p15-separable"])
def test_avg_pool_matches_the_jax_pool(kernel, stride, padding, include):
    x = np.random.RandomState(kernel).rand(2, 34, 40, 3).astype(np.float32)
    ref = jax_avg_pool(jnp.asarray(x), kernel, stride, padding=padding,
                       count_include_pad=include)
    out = _nhwc(avg_pool(_nchw(x), kernel, stride, padding=padding,
                         count_include_pad=include))
    _assert_close_to_max(out, ref, 1e-6)


@pytest.mark.parametrize("size,scale", [((13, 9), 0.25), ((3, 2), 2.0), ((11, 7), 8.0),
                                        ((2, 3), 32.0)])
def test_resize_to_the_scaled_size_matches_the_jax_one(size, scale):
    """PraNet resizes to ``floor(dim * s)`` explicitly; 13x9 at 1/4 is 3x2,
    where a resize by ``scale_factor`` would map coordinates by 4, not 13/3."""
    assert scaled_size(size, scale) == jax_scaled_size(size, scale) == (
        int(size[0] * scale), int(size[1] * scale))
    x = np.random.RandomState(0).randn(2, *size, 1).astype(np.float32)
    out_size = scaled_size(size, scale)
    ref = jax_resize(jnp.asarray(x), out_size, align_corners=False)
    out = _nhwc(resize_bilinear(_nchw(x), out_size, align_corners=False))
    _assert_close_to_max(out, ref, 4e-6)
    if size == (13, 9):
        by_factor = torch.nn.functional.interpolate(_nchw(x), scale_factor=scale,
                                                    mode="bilinear", align_corners=False)
        assert np.abs(_nhwc(by_factor) - np.asarray(ref)).max() > 1e-3


# -- Res2Net50-v1b --------------------------------------------------------------------

@pytest.mark.parametrize("stype,stride,inplanes,planes", [
    ("stage", 1, 64, 64),      # layer1's first block: the shortcut without a pool
    ("stage", 2, 256, 128),    # layer2's first block: both pools
    ("normal", 1, 512, 128),   # a later block: the running sum over the splits
], ids=["stage-s1", "stage-s2", "normal-s1"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bottle2neck_matches_the_jax_block(stype, stride, inplanes, planes, train):
    has_ds = stride != 1 or inplanes != planes * 4
    block = Bottle2neck(inplanes, planes, stride=stride, has_downsample=has_ds, stype=stype)
    randomize_weights_(block, seed=4)
    assert block.width == int(np.floor(planes * 26 / 64)) and len(block.convs) == 3
    sd = {k: v.numpy() for k, v in block.state_dict().items()}
    variables = TI.convert_state_dict(sd, TI.RES2NET_RULES)
    x = np.random.RandomState(5).randn(2, 16, 16, inplanes).astype(np.float32)
    jblock = jax_res2net.Bottle2neck(planes=planes, stride=stride, has_downsample=has_ds,
                                     stype=stype)
    if train:
        ref, _ = jblock.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        ref = jblock.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        out = _nhwc(block.train(train)(_nchw(x)))
    assert out.shape == (2, 16 // stride, 16 // stride, planes * 4)
    _assert_close_to_max(out, ref, 2e-5)


def test_res2net50_taps_match():
    net = Res2Net()
    randomize_weights_(net, seed=6)
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    assert "conv1.6.weight" in sd and "layer3.0.downsample.2.running_var" in sd
    assert isinstance(net.layer2[0].downsample[0], torch.nn.AvgPool2d)
    variables = TI.convert_state_dict(sd, TI.RES2NET_RULES)
    x = np.random.RandomState(7).randn(2, 64, 64, 3).astype(np.float32)
    ref = jax_res2net.Res2Net().apply(variables, jnp.asarray(x))
    with torch.no_grad():
        taps = net.eval()(_nchw(x))
    for name, side, channels in (("layer1", 16, 256), ("layer2", 8, 512),
                                 ("layer3", 4, 1024), ("layer4", 2, 2048)):
        assert taps[name].shape == (2, channels, side, side)
        _assert_close_to_max(_nhwc(taps[name]), ref[name], 1e-4)


def test_gc_blocks_raise():
    """``gc_blocks`` no longer raises: the GCNet blocks of
    models/contextagg.py sit before layers 2-4 (held against the JAX
    Res2Net_GC in tests/test_torch_contextagg.py)."""
    net = Res2Net(gc_blocks=True)
    assert [n for n, _ in net.named_children() if n.endswith("_gcb")] == [
        "layer2_gcb", "layer3_gcb", "layer4_gcb"]
    assert net.layer2_gcb.conv_mask.in_channels == 256
    assert net.layer4_gcb.channel_add_conv[0].out_channels == 1024 // 8


# -- PraNet ---------------------------------------------------------------------------

def _template(backbone, size=64):
    seg = JaxSegmentor(jax_build(jax_cfg(f"pranet_{backbone}")), NC)
    return seg, jax.eval_shape(seg.init, jax.random.PRNGKey(0),
                               jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32))


@pytest.fixture(scope="module", params=BACKBONES)
def variables(request):
    """The JAX pranet variables of one backbone, numpy-filled."""
    seg, template = _template(request.param)
    rng = np.random.RandomState(1)
    return request.param, seg, jax.tree_util.tree_map_with_path(
        lambda p, l: _randomise(p, l, rng), template)


def _port_segmentor(backbone, variables):
    tester = Tester(port_cfg(f"pranet_{backbone}"), logging.getLogger("torch_pranet"))
    load_part(tester.spec.modules["model"],
              pranet_state_dicts_from_flax(variables)["model"], "model")
    return tester


@pytest.mark.parametrize("size", [64, 96])
def test_pranet_maps_and_tap_match(variables, size):
    backbone, seg, var = variables
    x = np.random.RandomState(size).randn(2, size, size, 3).astype(np.float32)
    params, stats = _split(var)
    ref, _, ref_tap = seg.forward(params, stats, jnp.asarray(x))
    tester = _port_segmentor(backbone, var)
    with torch.no_grad():
        maps, tap = tester.segmentor(_nchw(x))
    assert len(maps) == len(ref) == 4
    for out, r in zip(maps, ref):
        assert out.shape == (2, 1, size, size)
        _assert_close_to_max(_nhwc(out), r, 1e-4)
    assert tap.shape == (2, 2048, size // 32, size // 32)
    _assert_close_to_max(_nhwc(tap), ref_tap, 1e-4)


KEYS = {"res2net50": ("resnet.conv1.0.weight", "resnet.conv1.4.running_mean",
                      "resnet.conv1.6.weight", "resnet.bn1.weight",
                      "resnet.layer1.0.convs.2.weight", "resnet.layer1.0.bns.0.bias",
                      "resnet.layer2.0.downsample.1.weight",
                      "resnet.layer4.0.downsample.2.running_var"),
        "resnet50": ("resnet.conv1.weight", "resnet.bn1.running_var",
                     "resnet.layer1.0.conv2.weight", "resnet.layer2.0.downsample.0.weight",
                     "resnet.layer4.0.downsample.1.bias")}


def test_port_keys_are_the_rules_and_the_bridge_round_trips(variables):
    backbone, _, var = variables
    sds = pranet_state_dicts_from_flax(var)
    model = build_segmentor(port_cfg(f"pranet_{backbone}")).modules["model"]
    assert ({k: tuple(v.shape) for k, v in model.state_dict().items()}
            == {k: tuple(v.shape) for k, v in sds["model"].items()})
    for key in KEYS[backbone] + ("rfb2_1.branch0.0.conv.weight",
                                 "rfb4_1.branch3.3.bn.running_mean",
                                 "rfb3_1.conv_cat.conv.weight", "agg1.conv_upsample5.bn.weight",
                                 "agg1.conv5.bias", "ra4_conv5.bn.running_var",
                                 "ra2_conv4.conv.weight"):
        assert key in sds["model"], key
    rules = TI.PRANET_RULES if backbone == "res2net50" else TI.CRANET_RULES
    back = TI.convert_state_dict({k: v.numpy() for k, v in sds["model"].items()}, rules)
    want = _flat(var["model"])
    for tree in (back, pranet_flax_from_state_dicts(sds, var)["model"]):
        got = _flat(tree)
        assert set(got) == set(want) and len(want) > 300
        for key, leaf in want.items():
            assert got[key].dtype == leaf.dtype and got[key].shape == leaf.shape, key
            np.testing.assert_array_equal(got[key], leaf, err_msg=key)


@pytest.mark.parametrize("backbone", BACKBONES)
def test_build_segmentor_builds_the_pranet_family(backbone):
    """One part ``model``, Adam at 1/8, prefix PraNet, D on the 2048-channel
    layer4 tap; MODEL.FREEZE_BN (True in both configs) does not reach it."""
    cfg = port_cfg(f"pranet_{backbone}", "MODEL.FREEZE_BN", "True")
    spec = build_segmentor(cfg)
    assert (spec.family, spec.backbone, spec.optimizer, spec.ckpt_prefix,
            spec.disc_tap) == ("pranet", backbone, "adam", "PraNet", "layer4")
    assert list(spec.modules) == ["model"] and spec.lr_mults == {"model": 0.125}
    assert tap_channels(spec) == 2048
    disc = build_adversarial_discriminator(cfg, spec)
    assert disc.D[0].in_channels == 2048 and disc.cls1.out_channels == NC
    norms = [m for m in spec.modules["model"].modules() if "BatchNorm" in type(m).__name__]
    assert norms and all(type(m) is torch.nn.BatchNorm2d for m in norms)
    assert build_segmentor(port_cfg("pranet")).backbone == "res2net50"
    with pytest.raises(NotImplementedError, match="pranet backbone"):
        PraNet(backbone="hardnet68")


# -- loss --------------------------------------------------------------------------------

@pytest.mark.parametrize("paper", [False, True], ids=["reference_mean", "paper_weighted"])
def test_structure_loss_and_its_gradient_match(paper):
    rng = np.random.RandomState(11)
    pred = (rng.randn(2, 40, 36, 1) * 3).astype(np.float32)
    yy, xx = np.mgrid[:40, :36]
    mask = np.stack([((yy - 18) ** 2 + (xx - 15) ** 2 < 120),
                     ((yy - 8) ** 2 + (xx - 30) ** 2 < 40)]).astype(np.float32)[..., None]

    def jax_loss(p):
        return jax_losses.structure_loss(p, jnp.asarray(mask), paper_weighted_bce=paper)

    ref, ref_grad = jax.value_and_grad(jax_loss)(jnp.asarray(pred))
    t = _nchw(pred).requires_grad_()
    loss = losses.structure_loss(t, _nchw(mask), paper_weighted_bce=paper)
    loss.backward()
    assert abs(loss.item() - float(ref)) <= 1e-6 * abs(float(ref))
    _assert_close_to_max(_nhwc(t.grad), ref_grad, 1e-5)
    other = losses.structure_loss(_nchw(pred), _nchw(mask), paper_weighted_bce=not paper)
    assert abs(other.item() - loss.item()) > 1e-4  # the two BCE terms differ


def test_family_loss_sums_the_structure_loss_over_the_four_maps():
    rng = np.random.RandomState(12)
    outs = [(rng.randn(2, 24, 24, 1) * 2).astype(np.float32) for _ in range(4)]
    label = (rng.rand(2, 24, 24) > 0.6).astype(np.int32)
    spec = build_segmentor(port_cfg("pranet_resnet50"))
    got = make_family_loss(spec, NC)([_nchw(o) for o in outs], torch.from_numpy(label))
    ref = jax_family_loss(jax_build(jax_cfg("pranet_resnet50")), NC)(
        [jnp.asarray(o) for o in outs], jnp.asarray(label))
    assert abs(got.item() - float(ref)) <= 1e-6 * abs(float(ref))


# -- probability head and its batch coupling ---------------------------------------------

@pytest.fixture(scope="module")
def head_pair(tmp_path_factory):
    """A JAX and a port pranet_resnet50 Tester over the same numpy weights."""
    seg, template = _template("resnet50")
    rng = np.random.RandomState(13)
    var = jax.tree_util.tree_map_with_path(lambda p, l: _randomise(p, l, rng), template)
    tmp = tmp_path_factory.mktemp("pranet_head")
    jt = JaxTester(jax_cfg("pranet_resnet50", "OUTPUT_DIR", str(tmp)), None,
                   logging.getLogger("jax_pranet"))
    jt.variables = var
    return jt, _port_segmentor("resnet50", var)


def test_tester_probabilities_match_and_couple_the_batch(head_pair):
    """Map 2 -> bilinear to the label size -> sigmoid -> one min-max over the
    batch -> [1 - p, p], against the JAX head with every row valid; then a
    changed second image changes the first image's probabilities on both
    sides, by the same amount."""
    jt, port = head_pair
    rng = np.random.RandomState(14)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    label_size = (70, 60)
    valid = jnp.asarray([True, True])
    ref = np.asarray(jt._probs_impl(jt.variables, jnp.asarray(x), label_size, valid))
    probs = port._probs_impl(_nchw(x), label_size)
    assert probs.shape == (2, 2, *label_size)
    out = _nhwc(probs)
    assert np.abs(out - ref).max() <= 1e-4
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-6)
    assert out[..., 1].min() == 0.0 and out[..., 1].max() == pytest.approx(1.0, abs=1e-6)

    x2 = x.copy()
    x2[1] = rng.randn(64, 64, 3) * 3
    ref2 = np.asarray(jt._probs_impl(jt.variables, jnp.asarray(x2), label_size, valid))
    out2 = _nhwc(port._probs_impl(_nchw(x2), label_size))
    moved_ref, moved = np.abs(ref2[0] - ref[0]).max(), np.abs(out2[0] - out[0]).max()
    assert moved_ref > 1e-2 and moved > 1e-2
    assert np.abs(out2 - ref2).max() <= 1e-4
    # a padded row that the JAX Tester masks out is simply absent in the port
    masked = np.asarray(jt._probs_impl(jt.variables, jnp.asarray(x2), label_size,
                                       jnp.asarray([True, False])))
    alone = _nhwc(port._probs_impl(_nchw(x2[:1]), label_size))
    assert np.abs(alone[0] - masked[0]).max() <= 1e-4


def test_served_pranet_masks_depend_on_the_rest_of_the_batch(head_pair, tmp_path):
    """The server runs the head over its zero-padded bucket, as the JAX server
    does: one image's mask changes with its neighbour in the batch and with
    the zero rows of a padded bucket.  With one image a batch (both configs
    set TEST.BATCH_SIZE 1; serve with --max-batch 1) it is its own."""
    _, port = head_pair
    pth = tmp_path / "PraNet-seeded.pth"
    save_reference_checkpoint(port.spec.modules, str(pth))
    cfg = port_cfg("pranet_resnet50", "INPUT.INPUT_SIZE_TEST", "(64, 64)",
                   "INPUT.TRAINSIZE", "64", "AUG.NAME", "pra", "OUTPUT_DIR", str(tmp_path),
                   "resume", str(pth))
    inf = InferenceServer(cfg, {}, logging.getLogger("torch_pranet_serve"), max_batch=2)
    try:
        assert inf.ready.wait(120)
        rng = np.random.RandomState(15)
        a, b, c = (rng.randn(64, 64, 3).astype(np.float32) * s for s in (1, 1, 3))
        alone = inf._run(a[None])[0]
        with_b = inf._run(np.stack([a, b]))[0]
        with_c = inf._run(np.stack([a, c]))[0]
        padded = np.stack([a, np.zeros_like(a)])
        padded_mask = inf._run(padded, n=1)[0]
    finally:
        inf.shutdown()
    assert (with_b != with_c).mean() > 1e-3  # 1.0% of a's pixels change class here
    # the zero row of a bucket of 2 moves a's probabilities (by 2.3e-3 here,
    # a thousand times float32 rounding), and its mask follows them
    probs = inf.tester._probs_impl(_nchw(padded), (64, 64))[0]
    probs_alone = inf.tester._probs_impl(_nchw(a[None]), (64, 64))[0]
    assert (probs - probs_alone).abs().max() > 1e-3
    np.testing.assert_array_equal(padded_mask, probs.argmax(0).numpy())
    np.testing.assert_array_equal(alone, probs_alone.argmax(0).numpy())
