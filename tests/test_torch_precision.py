"""MODEL.DTYPE bfloat16 in the port against the JAX package in bfloat16, on the
CPU, module by module (tests/test_torch_precision_steps.py takes whole steps).

The criterion: for the same inputs and weights (seeded, carried by name into
the JAX variables), the port's bfloat16 result differs from its own float32
result by at most twice what the JAX package's bfloat16 result differs from
its float32 result, plus a floor of one bfloat16 rounding (2^-8) of the
largest element: ``err = max|bf16 - f32| / max|f32|``.  The two float32
results are held to each other too (1e-4 of the largest element), so that
the weights did carry over.  Each output's type must be the JAX one's:
activations bfloat16, the resized heads float32; parameters and their
gradients stay float32.

Also here: the device augmentation's image in MODEL.DTYPE against the JAX
pipeline's on the same draws, to bfloat16 rounding; the BatchNorm
recalibration in the batches' type; the GALD step in bfloat16 against its own
float32 step (port only: the JAX GALD step takes over a minute to compile
here); MODEL.DTYPE float16 refused.
"""

import copy

import numpy as np
import pytest
import torch
from torch import nn

import flax.linen as fnn
import jax
import jax.numpy as jnp

from rnd_semantic_segmentation_tpu.data import device_pipe as jdp
from rnd_semantic_segmentation_tpu.models.attn_unet import AdditiveAttnGate as JaxGate
from rnd_semantic_segmentation_tpu.models.discriminator import \
    PixelDiscriminator as JaxPixelDiscriminator
from rnd_semantic_segmentation_tpu.models.efficientnet import MBConvBlock as JaxMBConvBlock
from rnd_semantic_segmentation_tpu.models.gcpa import CrissCrossAttention as JaxCrissCross
from rnd_semantic_segmentation_tpu.models.layers import BatchNorm as JaxBatchNorm
from rnd_semantic_segmentation_tpu.models.layers import Conv2d as JaxConv2d
from rnd_semantic_segmentation_tpu.models.layers import FrozenBatchNorm as JaxFrozenBN
from rnd_semantic_segmentation_tpu.models.pranet import BasicConv2d as JaxBasicConv2d

from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.data import device_pipe as dp
from rnd_semantic_segmentation_torch.models.attn_unet import AdditiveAttnGate
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.models.discriminator import PixelDiscriminator
from rnd_semantic_segmentation_torch.models.efficientnet import MBConvBlock
from rnd_semantic_segmentation_torch.models.gcpa import CrissCrossAttention
from rnd_semantic_segmentation_torch.models.layers import BatchNorm, Conv2d, FrozenBatchNorm2d
from rnd_semantic_segmentation_torch.models.pranet import BasicConv2d, PraNet
from rnd_semantic_segmentation_torch.ops.ccattn import (
    CrissCrossFunction,
    cc_attention_core_plain,
)
from rnd_semantic_segmentation_torch.train.bn_recal import recalibrate_batch_stats
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor
from rnd_semantic_segmentation_torch.train.state import TrainState, make_optimizers
from rnd_semantic_segmentation_torch.train.steps import make_src_train_step
from rnd_semantic_segmentation_torch.utils.device import compute_dtype

from test_torch_device_pipe import _jax_aspp_draws, _jax_attn_draws, _jax_pra_draws

torch.set_num_threads(2)  # six test workers share the host's cores

FLOOR = 2.0 ** -8       # one bfloat16 rounding of the largest element
F32_AGREE = 1e-4        # port float32 against JAX float32
BF16 = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return _np(t.permute(0, 2, 3, 1)) if t.dim() == 4 else _np(t)


def hold(port, jax_out, what: str, types=None):
    """``port`` and ``jax_out``: {"float32": out, "bfloat16": out}, NCHW
    tensors and NHWC arrays, of the ``types`` (the compute types by
    default).  Returns (port error, JAX error)."""
    for name, (tdt, jdt) in (types or BF16).items():
        assert port[name].dtype == tdt and jax_out[name].dtype == jdt, (what, name)
    p32, p16 = _nhwc(port["float32"]), _nhwc(port["bfloat16"])
    j32, j16 = _np(jax_out["float32"]), _np(jax_out["bfloat16"])
    assert _rel(p32, j32) <= F32_AGREE, (what, "float32", _rel(p32, j32))
    e_port, e_jax = _rel(p16, p32), _rel(j16, j32)
    assert e_port <= 2 * e_jax + FLOOR, (what, e_port, e_jax)
    return e_port, e_jax


def to_flax(module: nn.Module, rename=None) -> dict:
    """The port module's weights as flax variables, by name: ``_name`` ->
    ``name`` (``rename`` maps a dotted module name to a path otherwise);
    convolutions OIHW -> HWIO, BatchNorm to params and batch_stats, FrozenBN
    to ``frozen``, other parameters (``gamma``) as they are."""
    out: dict = {}

    def put(coll, path, leaf, value):
        node = out.setdefault(coll, {})
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(value.detach().float().numpy())

    for name, m in module.named_modules():
        path = (rename or {}).get(name) or tuple(p.lstrip("_") for p in name.split(".") if p)
        if isinstance(m, nn.Conv2d):
            put("params", path, "kernel", m.weight.permute(2, 3, 1, 0))
            if m.bias is not None:
                put("params", path, "bias", m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            put("params", path, "scale", m.weight)
            put("params", path, "bias", m.bias)
            put("batch_stats", path, "mean", m.running_mean)
            put("batch_stats", path, "var", m.running_var)
        elif isinstance(m, FrozenBatchNorm2d):
            for leaf, buf in (("weight", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                              ("var", "running_var")):
                put("frozen", path, leaf, getattr(m, buf))
        for pname, p in m.named_parameters(recurse=False):
            if not isinstance(m, (nn.Conv2d, nn.BatchNorm2d)):
                put("params", path, pname, p)
    return out


def run_both(port_module, jax_module, variables, port_inputs, jax_inputs, train=False,
             port_call=None, **jax_kw):
    """Each side in float32 and in bfloat16 (floating inputs cast), from one
    set of weights: the port module deep-copied for each type."""
    port, jout = {}, {}
    for name, (tdt, jdt) in BF16.items():
        module = copy.deepcopy(port_module).train(train)
        args = [a.to(tdt) if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                for a in port_inputs]
        port[name] = module(*args) if port_call is None else port_call(module, *args)
        jargs = [a.astype(jdt) if isinstance(a, jnp.ndarray) and a.dtype == jnp.float32
                 else a for a in jax_inputs]
        res = jax_module.apply(variables, *jargs, mutable=["batch_stats"] if train else False,
                               **jax_kw)
        jout[name] = res[0] if train else res
    return port, jout


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _both(a):
    """numpy NHWC -> (torch NCHW, jax NHWC)."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))), jnp.asarray(a)


# -- modules ---------------------------------------------------------------------

class _JaxConvBN(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = True):
        return JaxBatchNorm(name="bn")(JaxConv2d(16, 3, padding=1, name="conv")(x), train)


class _ConvBN(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv, self.bn = Conv2d(8, 16, 3, padding=1), BatchNorm(16)

    def forward(self, x):
        return self.bn(self.conv(x))


def test_conv_bn_in_bfloat16():
    """A biased 3x3 convolution and a train-mode BatchNorm: bfloat16 out,
    float32 running statistics, parameters and gradients."""
    port = randomize_weights_(_ConvBN(), seed=1)
    x, jx = _both(_rand((2, 6, 10, 8), 0))
    out, jout = run_both(port, _JaxConvBN(), to_flax(port), [x], [jx], train=True)
    hold(out, jout, "conv+BN")
    module = copy.deepcopy(port).train()
    y = module(x.bfloat16())
    y.float().square().sum().backward()
    assert y.dtype == torch.bfloat16
    for name, p in module.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
    for buf in (module.bn.running_mean, module.bn.running_var):
        assert buf.dtype == torch.float32


def test_frozen_bn_folds_in_float32_and_applies_in_bfloat16():
    port = FrozenBatchNorm2d(8)
    randomize_weights_(nn.Sequential(port), seed=2)
    x, jx = _both(_rand((2, 5, 7, 8), 1))
    out, jout = run_both(port, JaxFrozenBN(), to_flax(port), [x], [jx])
    hold(out, jout, "FrozenBN")
    assert port.weight.dtype == torch.float32


def test_criss_cross_attention_with_gamma_in_bfloat16():
    """q, k, v in bfloat16, float32 inside the core, the output in bfloat16,
    ``gamma * out`` in float32 cast back before the residual."""
    port = randomize_weights_(CrissCrossAttention(32), seed=3, gamma=0.7)
    x, jx = _both(_rand((2, 6, 10, 32), 2))
    out, jout = run_both(port, JaxCrissCross(use_pallas=False), to_flax(port), [x], [jx])
    hold(out, jout, "CrissCrossAttention")


def test_criss_cross_function_keeps_bfloat16_through_its_gradient():
    """``CrissCrossFunction`` (the kernels' autograd function; its plain
    versions on the CPU) takes bfloat16 q, k, v and returns bfloat16, and its
    gradients are bfloat16 within bfloat16 rounding of autograd through the
    plain forward."""
    q, k, v = (torch.from_numpy(_rand((2, 5, 7, c), s)).bfloat16().requires_grad_()
               for s, c in ((4, 4), (5, 4), (6, 16)))
    g = torch.from_numpy(_rand((2, 5, 7, 16), 7)).bfloat16()
    out = CrissCrossFunction.apply(q, k, v)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, (q, k, v), g)
    ref = torch.autograd.grad(cc_attention_core_plain(q, k, v), (q, k, v), g)
    for name, a, b in zip("qkv", grads, ref):
        assert a.dtype == torch.bfloat16, name
        assert _rel(_np(a), _np(b)) <= 2 * FLOOR, name


def test_mbconv_block_with_drop_connect_on_the_jax_masks():
    """A train-mode identity MBConv block (expansion 6, SE) at drop-connect
    0.5: the JAX block draws its masks, which its output shows (a dropped
    sample's output is its input, bit for bit); the port's body takes them."""
    port = randomize_weights_(MBConvBlock(16, 16, 3, 1, 6, 0.25, drop_connect_rate=0.5), seed=4)
    x, jx = _both(_rand((8, 8, 8, 16), 3))
    jax_block = JaxMBConvBlock(16, 16, 3, 1, 6, 0.25, drop_connect_rate=0.5)
    variables = to_flax(port)
    rngs = {"dropout": jax.random.PRNGKey(5)}
    j32 = jax_block.apply(variables, jx, True, rngs=rngs, mutable=["batch_stats"])[0]
    kept = np.asarray(j32 != jx).reshape(8, -1).any(axis=1)
    assert 0 < kept.sum() < 8
    mask = torch.from_numpy(kept).view(8, 1, 1, 1)
    out, jout = run_both(port, jax_block, variables, [x, mask], [jx, True], train=True,
                         port_call=lambda m, a, b: m.body(a, b), rngs=rngs)
    hold(out, jout, "MBConvBlock")


def test_additive_attention_gate_in_bfloat16():
    port = randomize_weights_(AdditiveAttnGate(16, 8), seed=5)
    (x, jx), (g, jg) = _both(_rand((2, 4, 4, 16), 4)), _both(_rand((2, 8, 8, 8), 5))
    out, jout = run_both(port, JaxGate(16, 8), to_flax(port), [x, g], [jx, jg])
    hold(out, jout, "AdditiveAttnGate")


class _JaxReverseAttention(fnn.Module):
    """The JAX PraNet's branch 3 (models/pranet.py:174-179 of the JAX
    package, inline in its ``__call__`` there), on its own."""

    @fnn.compact
    def __call__(self, crop, x, train: bool = True):
        crop = crop.astype(x.dtype)
        h = (-jax.nn.sigmoid(crop) + 1.0) * x
        h = JaxBasicConv2d(64, 1, name="ra3_conv1")(h, train)
        h = jax.nn.relu(JaxBasicConv2d(64, 3, padding=1, name="ra3_conv2")(h, train))
        h = jax.nn.relu(JaxBasicConv2d(64, 3, padding=1, name="ra3_conv3")(h, train))
        return JaxBasicConv2d(1, 3, padding=1, name="ra3_conv4")(h, train) + crop


def test_pranet_reverse_attention_block_in_bfloat16():
    """The float32 crop (a resize) cast to the features' type, the branch in
    bfloat16, train-mode BatchNorm."""
    convs = nn.ModuleDict({"ra3_conv1": BasicConv2d(32, 64, 1),
                           "ra3_conv2": BasicConv2d(64, 64, 3, padding=1),
                           "ra3_conv3": BasicConv2d(64, 64, 3, padding=1),
                           "ra3_conv4": BasicConv2d(64, 1, 3, padding=1)})
    randomize_weights_(convs, seed=6)
    crop, jcrop = _both(_rand((2, 8, 8, 1), 6, 2.0))  # float32 on both sides
    x, jx = _both(_rand((2, 8, 8, 32), 7))

    def call(m, c, feats):
        return PraNet._reverse_attention(None, c, feats, list(m.values()))

    port, jout = {}, {}
    for name, (tdt, jdt) in BF16.items():
        module = copy.deepcopy(convs).train()
        port[name] = call(module, crop, x.to(tdt))
        jout[name] = _JaxReverseAttention().apply(to_flax(convs), jcrop, jx.astype(jdt),
                                                  mutable=["batch_stats"])[0]
    hold(port, jout, "reverse attention")


def test_pixel_discriminator_on_a_bfloat16_tap():
    """D on a bfloat16 tap: its convolutions in bfloat16, its two heads
    resized in float32 to the input size."""
    port = randomize_weights_(PixelDiscriminator(32, ndf=64, num_classes=3), seed=7)
    x, jx = _both(_rand((2, 6, 8, 32), 8))
    variables = to_flax(port, rename={"D.0": ("d0",), "D.2": ("d1",)})
    out, jout = run_both(port, JaxPixelDiscriminator(ndf=64, num_classes=3), variables,
                         [x, (12, 16)], [jx], size=(12, 16))
    f32 = (torch.float32, jnp.float32)  # the resized heads, whatever the tap's type
    hold(out, jout, "PixelDiscriminator", types={"float32": f32, "bfloat16": f32})


# -- the device augmentation -----------------------------------------------------

@pytest.mark.parametrize("pipeline", ["pra", "attn", "aspp"])
def test_device_pipe_emits_the_jax_bfloat16_image(pipeline):
    """Each apply function with ``dtype`` bfloat16 against the JAX one with
    ``dtype="bfloat16"`` on the same draws: float32 arithmetic, the cast last,
    so the two agree to one bfloat16 rounding; the label keeps its type."""
    rng = np.random.RandomState(3)
    b, h = 6, 16
    x = rng.rand(b, h, h, 3).astype(np.float32)
    y = rng.randint(0, 3, (b, h, h)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    if pipeline == "pra":
        ref = jdp.augment_batch_pra(jnp.asarray(x), jnp.asarray(y), key, dtype="bfloat16")
        got = dp.augment_batch_pra(tx, ty, _jax_pra_draws(key, b), torch.bfloat16)
    elif pipeline == "attn":
        ref = jdp.augment_batch_attn(jnp.asarray(x), jnp.asarray(y), key, dtype="bfloat16")
        got = dp.augment_batch_attn(tx, ty, _jax_attn_draws(key, b), torch.bfloat16)
    else:
        jitter = (0.3, 0.3, 0.3, 0.05)
        norm = dict(mean=dp.IMAGENET_MEAN, std=dp.IMAGENET_STD)
        ref = jdp.augment_batch(jnp.asarray(x), jnp.asarray(y), key, size=(12, 20),
                                flip_prob=0.5, brightness=jitter[0], contrast=jitter[1],
                                saturation=jitter[2], hue=jitter[3], dtype="bfloat16", **norm)
        got = dp.augment_batch(tx, ty, _jax_aspp_draws(key, b, 0.5, jitter), size=(12, 20),
                               dtype=torch.bfloat16, **norm)
    assert got["image"].dtype == torch.bfloat16 and ref["image"].dtype == jnp.bfloat16
    want = _np(ref["image"])
    diff = np.abs(_np(got["image"]) - want)
    assert (diff <= 2.0 ** -7 * np.abs(want) + 1e-6).all(), diff.max()
    assert got["label"].dtype == ty.dtype
    np.testing.assert_array_equal(got["label"].numpy(), np.asarray(ref["label"]))


# -- BatchNorm recalibration, the refused type, the GALD step ---------------------

def _port(name, nc, *opts, seed=3):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", name, "MODEL.NUM_CLASSES", str(nc), "MODEL.DEVICE",
                         "cpu", "SOLVER.EPOCHS", "2", "SOLVER.BASE_LR", "1e-4", *opts])
    spec = build_segmentor(cfg)
    return cfg, randomize_weights_(Segmentor(spec, nc), seed=seed)


def test_recalibration_runs_in_the_batches_type():
    """bfloat16 batches: the forwards in bfloat16 (the first convolution sees
    it), the statistics float32 and within bfloat16 rounding of the float32
    recalibration's."""
    _, seg = _port("deeplab_resnet18", 3)
    batches = [torch.from_numpy(np.random.RandomState(i).rand(2, 32, 32, 3)
                                .astype(np.float32)) for i in range(3)]
    seen = []
    half = copy.deepcopy(seg)
    conv1 = seg.parts["feature_extractor"].backbone.conv1
    hook = conv1.register_forward_hook(lambda m, inp, out: seen.append(inp[0].dtype))
    recalibrate_batch_stats(seg, batches)
    hook.remove()
    hook = half.parts["feature_extractor"].backbone.conv1.register_forward_hook(
        lambda m, inp, out: seen.append(inp[0].dtype))
    recalibrate_batch_stats(half, [b.bfloat16() for b in batches])
    hook.remove()
    assert seen == [torch.float32] * 3 + [torch.bfloat16] * 3
    ref, got = seg.state_dict(), half.state_dict()
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert stats
    for key in stats:
        assert got[key].dtype == torch.float32
        assert _rel(_np(got[key]), _np(ref[key])) <= 0.05, key


def test_model_dtype_float16_raises():
    cfg, seg = _port("deeplab_resnet18", 3, "MODEL.DTYPE", "float16")
    with pytest.raises(NotImplementedError, match="float16"):
        compute_dtype(cfg)
    with pytest.raises(NotImplementedError, match="float16"):
        make_src_train_step(seg, cfg, 10, TrainState(optimizers=make_optimizers(seg.spec, cfg)))
    with pytest.raises(NotImplementedError, match="float16"):
        dp.make_device_augmenter(cfg)


# GALD at 224 in train mode is badly conditioned (tests/test_torch_train.py):
# its bfloat16 loss stays within 2% of the float32 one (measured 0.03%)
GALD_LOSS_REL = 2e-2


def test_gald_step_in_bfloat16_against_its_float32_step():
    """One GALD source step at 224x224 in each type from the same weights:
    the criss-cross core gets q, k, v in bfloat16 and returns bfloat16, the
    four heads are float32 (resized), the loss float32 within 2% of the
    float32 step's, and every parameter and gradient float32."""
    rng = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rng.rand(2, 224, 224, 3).astype(np.float32)),
             "label": torch.from_numpy(rng.randint(0, 3, (2, 224, 224)).astype(np.int32))}
    losses, seen = {}, {}
    for name in BF16:
        cfg, seg = _port("gald_hardnet68", 3, "MODEL.DTYPE", name)
        relation = seg.parts["decoder"].long_relation
        calls = seen.setdefault(name, [])
        hooks = [relation.register_forward_hook(
            lambda m, inp, out, calls=calls: calls.append((inp[0].dtype, out.dtype)))]
        heads = seg.parts["decoder"].linear2
        hooks.append(heads.register_forward_hook(
            lambda m, inp, out, calls=calls: calls.append(("head", out.dtype))))
        state = TrainState(optimizers=make_optimizers(seg.spec, cfg))
        losses[name] = make_src_train_step(seg, cfg, 10, state)(batch, 0.0)["loss"]
        for h in hooks:
            h.remove()
        for pname, p in seg.named_parameters():
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, pname
        x = batch["image"].permute(0, 3, 1, 2).to(BF16[name][0])
        with torch.no_grad():
            outs, tap = seg(x, train=True)
        assert tap.dtype == BF16[name][0] and all(o.dtype == torch.float32 for o in outs)
    assert seen["bfloat16"] == [(torch.bfloat16, torch.bfloat16)] * 2 \
        + [("head", torch.bfloat16)]
    assert seen["float32"] == [(torch.float32, torch.float32)] * 2 + [("head", torch.float32)]
    assert abs(losses["bfloat16"] - losses["float32"]) <= GALD_LOSS_REL * losses["float32"]
