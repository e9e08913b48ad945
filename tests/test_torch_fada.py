"""The port's FADA slice (``soft_label_cross_entropy``, the discriminators and
their weight bridge, ``gradient_reverse``, the FADA train step,
``FadaTrainer`` and ``cli.train_adv``) against the JAX package's, on the CPU
in float32 with TF32 off.

Weights come from the port's ``randomize_weights_`` and reach the JAX trees
through ``deeplab_flax_from_state_dicts``, ``attn_flax_from_state_dicts``
and ``disc_flax_from_state_dict``.  The step tests take one step on each
side from the same weights and batches: ``deeplab_resnet18`` (FrozenBN, SGD)
with a 32x32 source and a 24x32 target, 3 classes, 2+2 images, at the default
``SOLVER.ADV_WEIGHT`` 0.001 and at 1.0; ``attn_efficientnet-b0`` (BatchNorm
on batch statistics, Adam) at 64x64 with drop-connect off on both sides.

Tolerances:
  * the losses on the same inputs: 1e-6 relative; the discriminators'
    outputs and the gradient reversal: 1e-5 of the magnitude (float32 sums
    of 3x3 convolutions in another order);
  * the four losses of a step: 1e-5 relative (measured 2e-7 at worst);
    both LRs: 1e-6 relative;
  * deeplab's SGD parts: each leaf's update within 2e-3 of its largest
    element, as in ``tests/test_torch_deeplab.py`` (FrozenBN makes the step
    as well conditioned as eval mode), plus one float32 ulp of the leaf's
    largest element: at 32x32 some updates are near the resolution of the
    parameter they move;
  * D's and attn's Adam steps: one Adam step moves an element by
    lr*g/(|g|+eps) whatever the size of g, so every element moves by at most
    lr on both sides, and where the port's gradient exceeds 1e-5 and both
    sides moved the same way, the two agree to 2e-3 of lr, as in
    ``tests/test_torch_attn_train.py``; attn's displacement per leaf and
    over all leaves within 0.1 and 5e-3 of its norm (the 2e-3 does not
    hold everywhere because of the elements whose gradient is rounding
    noise, which Adam moves by a whole lr of either sign);
  * the weight round trips and the pure properties: exact.

The GALD step is held with the port alone at 224x224 (two images a domain):
its JAX step takes over a minute to compile on the CPU, where the JAX
package's own test of it is marked slow.
"""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnd_semantic_segmentation_tpu import losses as jax_losses
from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.models.build import (
    build_adversarial_discriminator as jax_build_disc,
    build_segmentor as jax_build,
)
from rnd_semantic_segmentation_tpu.models.discriminator import (
    FCDiscriminator as JaxFCDiscriminator,
    PixelDiscriminator as JaxPixelDiscriminator,
)
from rnd_semantic_segmentation_tpu.models.efficientnet import EfficientNetEncoder as JaxEncoder
from rnd_semantic_segmentation_tpu.models.grl import gradient_reverse as jax_gradient_reverse
from rnd_semantic_segmentation_tpu.train.fada import FadaState, make_fada_train_step as jax_fada
from rnd_semantic_segmentation_tpu.train.segmentor import Segmentor as JaxSegmentor
from rnd_semantic_segmentation_tpu.train.state import ModuleState
from rnd_semantic_segmentation_tpu.train.state import make_optimizer as jax_make_optimizer
from rnd_semantic_segmentation_tpu.train.steps import make_optimizers as jax_make_optimizers

from rnd_semantic_segmentation_torch import losses
from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    attn_flax_from_state_dicts,
    deeplab_flax_from_state_dicts,
    disc_flax_from_state_dict,
    disc_state_dict_from_flax,
)
from rnd_semantic_segmentation_torch.cli import test as test_cli
from rnd_semantic_segmentation_torch.cli import train_adv
from rnd_semantic_segmentation_torch.cli.common import load_cfg
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.models.build import (
    build_adversarial_discriminator,
    build_segmentor,
    randomize_weights_,
    tap_channels,
)
from rnd_semantic_segmentation_torch.models.discriminator import (
    FCDiscriminator,
    PixelDiscriminator,
)
from rnd_semantic_segmentation_torch.models.efficientnet import EfficientNetEncoder
from rnd_semantic_segmentation_torch.models.grl import gradient_reverse
from rnd_semantic_segmentation_torch.train.fada import (
    DISC_PART,
    TEMPERATURE,
    make_disc_optimizer,
    make_fada_train_step,
)
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor
from rnd_semantic_segmentation_torch.train.state import TrainState, apply_updates, make_optimizers

torch.set_num_threads(2)  # six test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "deeplabv2_r101_adv.yaml")
NC = 3
STEPS_PER_EPOCH = 10
DEEPLAB = "deeplab_resnet18"
ATTN = "attn_efficientnet-b0"
BASE = ["MODEL.NUM_CLASSES", str(NC), "MODEL.FREEZE_BN", "True", "MODEL.DTYPE", "float32",
        "SOLVER.EPOCHS", "2",
        "SOLVER.BASE_LR", "1e-3", "SOLVER.BASE_LR_D", "1e-4", "SOLVER.WEIGHT_DECAY", "1e-4"]


def port_cfg(name, *opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(BASE + ["MODEL.NAME", name, "MODEL.DEVICE", "cpu", *opts])
    return cfg


def jax_cfg(name, *opts):
    cfg = jax_default_cfg()
    cfg.merge_from_list(BASE + ["MODEL.NAME", name, *opts])
    return cfg


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _state_dicts(seg):
    return {n: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for n, m in seg.spec.modules.items()}


def _assert_close_to_max(out, ref, rel):
    ref = np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all()
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, f"max abs error {err} > {rel} x {scale}"


def _port_models(name, *opts, drop_connect=False, seed=10):
    cfg = port_cfg(name, *opts)
    spec = build_segmentor(cfg)
    if spec.family == "attn" and not drop_connect:
        spec.modules["encoder"] = EfficientNetEncoder(spec.backbone, drop_connect_rate=0.0)
    seg = Segmentor(spec, NC)
    randomize_weights_(seg, seed=seed)
    disc = randomize_weights_(build_adversarial_discriminator(cfg, spec), seed=seed + 1)
    return cfg, seg, disc


def _batches(src_hw, tgt_hw, seed=9):
    rng = np.random.RandomState(seed)
    label = rng.randint(0, NC, (2,) + src_hw).astype(np.int32)
    label[:, :6, :10] = 255
    src = {"image": rng.rand(2, *src_hw, 3).astype(np.float32), "label": label}
    tgt = {"image": (rng.rand(2, *tgt_hw, 3) * 0.7).astype(np.float32),
           "label": np.zeros((2,) + tgt_hw, np.int32)}
    return src, tgt


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- losses, discriminators, gradient reversal -------------------------------------------

def test_soft_label_cross_entropy_matches_the_jax_loss():
    rng = np.random.RandomState(0)
    pred = (rng.randn(2, 6, 5, 7) * 3).astype(np.float32)
    soft = rng.rand(2, 6, 5, 7).astype(np.float32)
    ours = losses.soft_label_cross_entropy(_nchw(pred), _nchw(soft)).item()
    ref = float(jax_losses.soft_label_cross_entropy(jnp.asarray(pred), jnp.asarray(soft)))
    assert abs(ours - ref) <= 1e-6 * abs(ref)


def _jax_disc_variables(module, shape, seed, **kw):
    template = jax.eval_shape(lambda r, x: module.init(r, x, **kw), jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct(shape, jnp.float32))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        if str(getattr(path[-1], "key", path[-1])) == "kernel":
            return (rng.randn(*leaf.shape) * np.sqrt(1.7 / np.prod(leaf.shape[:-1]))
                    ).astype(np.float32)
        return rng.uniform(-0.1, 0.1, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, template)


@pytest.mark.parametrize("size", [None, (13, 19)], ids=["tap_size", "resized"])
def test_pixel_discriminator_matches_the_jax_one(size):
    """ndf 64, 40 input channels, 5 classes: the reference's keys, an exact
    weight round trip, and the same 2C outputs with and without ``size``."""
    x = np.random.RandomState(1).randn(2, 6, 9, 40).astype(np.float32)
    jd = JaxPixelDiscriminator(ndf=64, num_classes=5)
    variables = _jax_disc_variables(jd, x.shape, seed=2, size=None)
    sd = disc_state_dict_from_flax(variables)
    disc = PixelDiscriminator(40, ndf=64, num_classes=5)
    assert set(sd) == set(disc.state_dict())
    assert {k.rsplit(".", 1)[0] for k in sd} == {"D.0", "D.2", "cls1", "cls2"}
    disc.load_state_dict(sd)
    back = _flat(disc_flax_from_state_dict(disc.state_dict(), variables))
    for key, leaf in _flat(variables).items():
        np.testing.assert_array_equal(back[key], leaf, err_msg=key)
    ref = jd.apply(variables, jnp.asarray(x), size=size)
    with torch.no_grad():
        out = disc(_nchw(x), size)
    assert out.shape[1] == 10 and tuple(out.shape[2:]) == (size or (6, 9))
    _assert_close_to_max(_nhwc(out), ref, 1e-5)


def test_fc_discriminator_matches_the_jax_one():
    x = np.random.RandomState(3).randn(2, 64, 48, 12).astype(np.float32)
    jd = JaxFCDiscriminator(ndf=8)
    variables = _jax_disc_variables(jd, x.shape, seed=4)
    disc = FCDiscriminator(12, ndf=8)
    sd = disc_state_dict_from_flax(variables)
    assert set(sd) == set(disc.state_dict())
    disc.load_state_dict(sd)
    with torch.no_grad():
        out = disc(_nchw(x))
    assert tuple(out.shape) == (2, 1, 2, 1)
    _assert_close_to_max(_nhwc(out), jd.apply(variables, jnp.asarray(x)), 1e-5)


def test_gradient_reverse_forward_and_vjp_match_the_jax_ones():
    rng = np.random.RandomState(5)
    x, g = rng.randn(3, 4).astype(np.float32), rng.randn(3, 4).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: jax_gradient_reverse(v, 0.3), jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    out = gradient_reverse(t, 0.3)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(t.grad.numpy(), -0.3 * g, rtol=1e-6)


@pytest.mark.parametrize("name,channels", [
    ("deeplab_resnet18", 512), ("deeplab_resnet50", 2048), ("deeplab_vgg16", 1024),
    ("gald_hardnet68", 1024), ("attn_efficientnet-b0", 1280),
    ("attn_efficientnet-b2", 1408)])
def test_discriminator_is_sized_from_the_tap(name, channels):
    """The JAX table (``_DISC_FEATURES``) says 2048 for every ResNet and 1408
    for every EfficientNet; flax reads the tap instead, and so does the port.
    ndf is mid_nc=256 and each head has NUM_CLASSES channels."""
    cfg = port_cfg(name)
    spec = build_segmentor(cfg)
    disc = build_adversarial_discriminator(cfg, spec)
    assert tap_channels(spec) == channels == disc.D[0].in_channels
    assert disc.D[0].out_channels == 256 and disc.D[2].out_channels == 128
    assert disc.cls1.out_channels == disc.cls2.out_channels == NC


def test_attnwrap_has_no_tap_for_fada():
    spec = build_segmentor(port_cfg("attnwrap_efficientnet-b0"))
    with pytest.raises(NotImplementedError, match="no discriminator tap"):
        tap_channels(spec)


# -- one FADA step against the JAX step ---------------------------------------------------

def _jax_step(name, seg, disc, src, tgt, opts, size):
    jcfg = jax_cfg(name, *opts)
    spec = jax_build(jcfg)
    if spec.family == "attn":
        spec.modules["encoder"] = JaxEncoder(spec.backbone, drop_connect_rate=0.0)
    jseg = JaxSegmentor(spec, NC)
    template = jax.eval_shape(jseg.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32))
    to_flax = deeplab_flax_from_state_dicts if spec.family == "deeplab" \
        else attn_flax_from_state_dicts
    seg_state = jseg.make_states(to_flax(_state_dicts(seg), template),
                                 jax_make_optimizers(spec, jcfg))
    jdisc = jax_build_disc(jcfg)
    tap = jnp.zeros((1, 4, 4, disc.D[0].in_channels), jnp.float32)
    dtemplate = jax.eval_shape(lambda r, x: jdisc.init(r, x, size=None),
                               jax.random.PRNGKey(0), tap)
    dparams = disc_flax_from_state_dict(disc.state_dict(), dtemplate)["params"]
    tx_d = jax_make_optimizer("adam", betas=(0.9, 0.99))
    state = FadaState(seg=seg_state, disc=ModuleState(params=dparams, stats={},
                                                      opt_state=tx_d.init(dparams)))
    step = jax_fada(jseg, jdisc, jcfg, STEPS_PER_EPOCH)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in src.items()},
                        {k: jnp.asarray(v) for k, v in tgt.items()}, jnp.float32(0))
    start = _flat({n: m.params for n, m in seg_state.modules.items()})
    return (template, dtemplate, start, _flat(dparams),
            _flat({n: m.params for n, m in new.seg.modules.items()}),
            _flat(new.disc.params), {k: float(v) for k, v in metrics.items()})


def _port_step(seg, disc, cfg, src, tgt):
    tstate = TrainState(optimizers={**make_optimizers(seg.spec, cfg),
                                    DISC_PART: make_disc_optimizer(disc)})
    step = make_fada_train_step(seg, disc, cfg, STEPS_PER_EPOCH, tstate)
    metrics = step(_torch_batch(src), _torch_batch(tgt), 0.0)
    assert tstate.step == 1
    return tstate, metrics


def _assert_adam_step(start, ref, got, grads, lr, what):
    """One Adam step: at most lr on both sides; within 2e-3 of lr where the
    port's gradient is clear of rounding and both moved the same way."""
    checked = total = 0
    for key, r in ref.items():
        ulp = 2.5e-7 * max(np.abs(r).max(), 1.0)
        want, have = r - start[key], got[key] - start[key]
        for side in (want, have):
            assert np.abs(side).max() <= lr(key) * 1.001 + ulp, (what, key)
        clear = (np.sign(want) == np.sign(have)) & (np.abs(grads[key]) > 1e-5)
        if clear.any():
            assert np.abs(have - want)[clear].max() <= 2e-3 * lr(key) + ulp, (what, key)
        checked += clear.sum()
        total += (np.abs(grads[key]) > 1e-5).sum()
    assert checked > 0.9 * total, (what, checked, total)


def _check_metrics(metrics, ref, lr, lr_d):
    assert set(metrics) == set(ref) == {"loss_seg", "loss_adv_tgt", "loss_D_src",
                                        "loss_D_tgt", "lr", "lr_D"}
    assert metrics["lr"] == pytest.approx(lr, rel=1e-12)
    assert metrics["lr_D"] == pytest.approx(lr_d, rel=1e-12)
    for key, value in ref.items():
        assert np.isfinite(metrics[key])
        assert abs(metrics[key] - value) <= (1e-6 if key.startswith("lr") else 1e-5) \
            * abs(value), (key, metrics[key], value)


@pytest.mark.parametrize("adv_weight", ["0.001", "1.0"])
def test_deeplab_fada_step_matches_the_jax_step(adv_weight):
    """deeplab_resnet18, FrozenBN, SGD with the classifier at 10x: the four
    losses and both LRs, every SGD part's update and D's Adam step."""
    opts = ["SOLVER.ADV_WEIGHT", adv_weight]
    cfg, seg, disc = _port_models(DEEPLAB, *opts)
    src, tgt = _batches((32, 32), (24, 32))
    (template, dtemplate, start, dstart, ref, dref, jmetrics) = _jax_step(
        DEEPLAB, seg, disc, src, tgt, opts, 32)
    tstate, metrics = _port_step(seg, disc, cfg, src, tgt)
    _check_metrics(metrics, jmetrics, 1e-3, 1e-4)
    tree = deeplab_flax_from_state_dicts(_state_dicts(seg), template)
    got = _flat({n: t["params"] for n, t in tree.items()})
    assert set(got) == set(ref)
    for key, r in ref.items():
        want, have = r - start[key], got[key] - start[key]
        assert np.abs(want).max() > 0, key  # every parameter moved
        err, scale = np.abs(have - want).max(), np.abs(want).max()
        ulp = 1.2e-7 * np.abs(r).max()
        assert err <= 2e-3 * scale + ulp, f"{key}: {err} > 2e-3 x {scale} + {ulp}"
    dgot = _flat(disc_flax_from_state_dict(disc.state_dict(), dtemplate)["params"])
    grads = _flat(disc_flax_from_state_dict(
        {k: p.grad for k, p in disc.named_parameters()}, dtemplate)["params"])
    _assert_adam_step(dstart, dref, dgot, grads, lambda key: 1e-4, "D")


def test_attn_fada_step_matches_the_jax_step():
    """attn_efficientnet-b0 at 64x64, drop-connect 0, warm-up cosine at epoch 0
    (2e-4 for the encoder, 2e-3 for the decoder, 2e-5 for D), Adam with L2
    1e-4 on the segmentor; the five-scale loss on the raw outputs."""
    cfg, seg, disc = _port_models(ATTN)
    src, tgt = _batches((64, 64), (64, 64))
    (template, dtemplate, start, dstart, ref, dref, jmetrics) = _jax_step(
        ATTN, seg, disc, src, tgt, [], 64)
    tstate, metrics = _port_step(seg, disc, cfg, src, tgt)
    _check_metrics(metrics, jmetrics, 2e-4, 2e-5)
    tree = attn_flax_from_state_dicts(_state_dicts(seg), template)
    got = _flat({n: t["params"] for n, t in tree.items()})
    grads = {n: {k: p.grad + 1e-4 * p.detach() for k, p in m.named_parameters()}
             for n, m in seg.spec.modules.items()}
    grads = _flat({n: t["params"] for n, t in
                   attn_flax_from_state_dicts(grads, template).items()})
    assert set(got) == set(ref)
    _assert_adam_step(start, ref, got, grads,
                      lambda key: 2e-3 if key.startswith("['decoder']") else 2e-4, "segmentor")
    num = den = 0.0
    for key, r in ref.items():
        want, have = r - start[key], got[key] - start[key]
        assert np.abs(want).max() > 0, key
        err, scale = np.linalg.norm(have - want), np.linalg.norm(want)
        assert err <= 0.1 * scale, f"{key}: {err} > 0.1 x {scale}"
        num, den = num + err ** 2, den + scale ** 2
    assert num ** 0.5 <= 5e-3 * den ** 0.5
    dgot = _flat(disc_flax_from_state_dict(disc.state_dict(), dtemplate)["params"])
    dgrads = _flat(disc_flax_from_state_dict(
        {k: p.grad for k, p in disc.named_parameters()}, dtemplate)["params"])
    _assert_adam_step(dstart, dref, dgot, dgrads, lambda key: 2e-5, "D")


# -- pure properties ----------------------------------------------------------------------

def _capture_disc_inputs(disc):
    seen = []
    disc.register_forward_hook(lambda mod, inp, out: seen.append(inp[0].detach().clone()))
    return seen


def test_d_after_the_step_equals_a_d_only_step_on_the_detached_taps():
    """At ADV_WEIGHT 1.0 the generator's backward passes through D; D's update
    must still equal the one a D-only step makes from the taps and soft
    labels of the pre-update forwards, bit for bit."""
    cfg, seg, disc = _port_models(DEEPLAB, "SOLVER.ADV_WEIGHT", "1.0")
    src, tgt = _batches((32, 32), (24, 32))
    disc0 = copy.deepcopy(disc)
    forwards = []  # the step's own outputs and taps
    seg.register_forward_hook(lambda mod, inp, out: forwards.append(
        (out[0][0].detach(), out[1].detach(), tuple(inp[0].shape[-2:]))))
    tstate, metrics = _port_step(seg, disc, cfg, src, tgt)
    assert len(forwards) == 2

    def soft_label(out):
        return torch.softmax(out / TEMPERATURE, dim=1).clamp(max=0.9)

    (src_out, src_tap, src_size), (tgt_out, tgt_tap, tgt_size) = forwards
    src_soft, tgt_soft = soft_label(src_out), soft_label(tgt_out)
    assert (src_size, tgt_size) == ((32, 32), (24, 32))
    opt = make_disc_optimizer(disc0)
    zeros = torch.zeros_like
    loss = 0.5 * losses.soft_label_cross_entropy(
        disc0(src_tap, src_size), torch.cat([src_soft, zeros(src_soft)], 1)) \
        + 0.5 * losses.soft_label_cross_entropy(
            disc0(tgt_tap, tgt_size), torch.cat([zeros(tgt_soft), tgt_soft], 1))
    loss.backward()
    apply_updates(opt, metrics["lr_D"])
    for (name, p), p0 in zip(disc.named_parameters(), disc0.parameters()):
        assert torch.equal(p.grad, p0.grad), name
        assert torch.equal(p, p0), name
    saved = tstate.optimizers[DISC_PART].state_dict()["state"]
    for i, s in opt.state_dict()["state"].items():
        assert torch.equal(saved[i]["exp_avg"], s["exp_avg"])
        assert torch.equal(saved[i]["exp_avg_sq"], s["exp_avg_sq"])


def test_both_forwards_of_a_step_draw_the_same_drop_connect_masks():
    """attn b0 with drop-connect on, the same images in both domains: the two
    forwards give equal taps, because the generator is reseeded with the same
    seed before each; a forward from another seed gives another tap."""
    cfg, seg, disc = _port_models(ATTN, drop_connect=True)
    assert max(b.drop_connect_rate for b in seg.spec.modules["encoder"].blocks) > 0.15
    src, _ = _batches((64, 64), (64, 64))
    seg0 = copy.deepcopy(seg)
    seen = _capture_disc_inputs(disc)
    _port_step(seg, disc, cfg, src, {**src, "label": np.zeros_like(src["label"])})
    assert len(seen) == 3  # the generator's term, then D on the source and the target
    assert torch.equal(seen[1], seen[2]) and torch.equal(seen[0], seen[2])
    x = _torch_batch(src)["image"].permute(0, 3, 1, 2)
    with torch.no_grad():
        _, other = seg0(x, train=True, generator=torch.Generator().manual_seed(123))
    assert (other - seen[1]).abs().max() > 1e-3 * seen[1].abs().max()


def test_gald_step_taps_the_last_encoder_feature_and_labels_from_out2():
    """gald_hardnet68 at 224x224, two images a domain (a batch of one makes
    BatchNorm raise on the decoder's pooled 1x1 features): D reads ``taps[3]``
    (1024 channels at 7x7), and the four losses are those of soft labels made
    from out2, the last output, on the pre-update weights."""
    cfg, seg, disc = _port_models("gald_hardnet68")
    rng = np.random.RandomState(2)
    src = {"image": rng.rand(2, 224, 224, 3).astype(np.float32),
           "label": rng.randint(0, NC, (2, 224, 224)).astype(np.int32)}
    tgt = {"image": (rng.rand(2, 224, 224, 3) * 0.7).astype(np.float32),
           "label": np.zeros((2, 224, 224), np.int32)}
    disc0 = copy.deepcopy(disc)
    seen = _capture_disc_inputs(disc)
    taps, forwards = [], []  # the step's own encoder taps and segmentor outputs
    seg.parts["encoder"].register_forward_hook(lambda mod, inp, out: taps.append(out[3]))
    seg.register_forward_hook(lambda mod, inp, out: forwards.append(
        tuple(o.detach() for o in out[0])))
    _, metrics = _port_step(seg, disc, cfg, src, tgt)
    src_tap, tgt_tap = (t.detach() for t in taps)
    src_outs, tgt_outs = forwards
    assert tuple(src_tap.shape) == (2, 1024, 7, 7) and len(src_outs) == 4
    for got, want in zip(seen, (tgt_tap, src_tap, tgt_tap)):
        assert torch.equal(got, want)

    def d_losses(final):
        soft = [torch.softmax(o[final] / TEMPERATURE, 1).clamp(max=0.9)
                for o in (src_outs, tgt_outs)]
        z = [torch.zeros_like(s) for s in soft]
        with torch.no_grad():
            return (0.5 * losses.soft_label_cross_entropy(
                        disc0(src_tap, (224, 224)), torch.cat([soft[0], z[0]], 1)).item(),
                    0.5 * losses.soft_label_cross_entropy(
                        disc0(tgt_tap, (224, 224)), torch.cat([z[1], soft[1]], 1)).item())

    want, other = d_losses(-1), d_losses(0)
    got = (metrics["loss_D_src"], metrics["loss_D_tgt"])
    assert got == pytest.approx(want, rel=1e-6)
    assert abs(other[0] - want[0]) > 1e-3 * abs(want[0])


# -- FadaTrainer and the CLIs -------------------------------------------------------------

def _cli_opts(out_dir, *more):
    return ["-cfg", CONFIG, "MODEL.NAME", DEEPLAB, "MODEL.DEVICE", "cpu",
            "MODEL.NUM_CLASSES", str(NC),
            "DATASETS.SOURCE_TRAIN", "synthetic_train",
            "DATASETS.TARGET_TRAIN", "synthetic_shift_train",
            "DATASETS.TEST", "synthetic_val", "DATASETS.SYNTHETIC_LENGTH", "4",
            "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(64, 64)",
            "INPUT.TARGET_INPUT_SIZE_TRAIN", "(64, 64)", "INPUT.INPUT_SIZE_TEST", "(64, 48)",
            "SOLVER.BATCH_SIZE", "4", "SOLVER.EPOCHS", "1", "DATA_PIPE.NUM_WORKERS", "2",
            "OUTPUT_DIR", str(out_dir), *more]


@pytest.fixture(scope="module")
def fada_run(tmp_path_factory):
    """``cli.train_adv``'s own ``cli()``: one epoch of 2 steps (2 + 2 images)."""
    out_dir = tmp_path_factory.mktemp("fada")
    argv = sys.argv
    sys.argv = ["train_adv"] + _cli_opts(out_dir)
    try:
        train_adv.cli()
    finally:
        sys.argv = argv
    return out_dir


def test_cli_writes_the_combined_checkpoint_and_six_series(fada_run):
    ckpt = torch.load(fada_run / "AsppFada-1.pth", map_location="cpu", weights_only=True)
    parts = ("feature_extractor", "classifier", DISC_PART)
    assert set(ckpt) == {"epoch", "step", *parts, *(f"optimizer_{p}" for p in parts)}
    assert (ckpt["epoch"], ckpt["step"]) == (1, 2)
    assert set(ckpt[DISC_PART]) == {"D.0.weight", "D.0.bias", "D.2.weight", "D.2.bias",
                                    "cls1.weight", "cls1.bias", "cls2.weight", "cls2.bias"}
    assert ckpt[DISC_PART]["D.0.weight"].shape == (256, 512, 3, 3)
    adam = ckpt[f"optimizer_{DISC_PART}"]
    assert adam["param_groups"][0]["betas"] == (0.9, 0.99)
    assert all(int(s["step"]) == 2 for s in adam["state"].values()) and len(adam["state"]) == 8
    assert "momentum_buffer" in ckpt["optimizer_classifier"]["state"][0]
    chart = json.loads((fada_run / "deeplab_fada_chart_params.json").read_text())
    assert list(chart) == ["learning rate", "discriminator learning rate",
                           "segmentation loss", "target adversarial loss",
                           "source discriminator loss", "target discriminator loss"]
    assert all(len(v) == 2 and np.isfinite(v).all() for v in chart.values())
    assert chart["learning rate"][0] == 2.5e-4 and chart["discriminator learning rate"][0] == 1e-4


def test_resume_restores_the_parts_d_and_its_adam_state(fada_run, tmp_path):
    pth = str(fada_run / "AsppFada-1.pth")
    cfg = load_cfg(train_adv.build_parser().parse_args(
        _cli_opts(tmp_path, "SOLVER.EPOCHS", "2", "resume", pth)))
    trainer = train_adv.make_trainer("deeplab_fada", cfg)
    ckpt = torch.load(pth, map_location="cpu", weights_only=True)
    assert trainer.start_epoch == 2 and trainer.state.step == 2
    for key, value in trainer.disc.state_dict().items():
        assert torch.equal(value, ckpt[DISC_PART][key]), key
    for key, value in trainer.segmentor.parts["classifier"].state_dict().items():
        assert torch.equal(value, ckpt["classifier"][key]), key
    restored = trainer.state.optimizers[DISC_PART].state_dict()
    for i, s in ckpt[f"optimizer_{DISC_PART}"]["state"].items():
        assert torch.equal(restored["state"][i]["exp_avg_sq"], s["exp_avg_sq"])
    trainer.train()
    assert trainer.state.step == 4 and (tmp_path / "AsppFada-2.pth").exists()
    # poly LR carries on from the saved step: iterations 2 and 3 of 4
    assert trainer.series["lr"] == pytest.approx(
        [2.5e-4 * (1 - it / 4) ** 0.9 for it in (2, 3)], rel=1e-12)


def test_tester_evaluates_the_fada_checkpoint(fada_run):
    pth = str(fada_run / "AsppFada-1.pth")
    args = test_cli.build_parser().parse_args(
        ["-c", os.path.join(REPO, "renders", "cityscapes.json")]
        + _cli_opts(fada_run, "resume", pth))
    cfg = load_cfg(args)
    tester = test_cli.make_tester(cfg, json.loads(open(args.config_path).read()))
    ckpt = torch.load(pth, map_location="cpu", weights_only=True)
    for part in ("feature_extractor", "classifier"):
        for key, value in tester.segmentor.parts[part].state_dict().items():
            assert torch.equal(value, ckpt[part][key]), key
    summary = tester.test()
    assert 0 <= summary["micro_miou"] <= 1
    assert np.asarray(tester.confusion).sum() == 4 * 64 * 48


@pytest.mark.parametrize("opts,match", [
    (("MODEL.WEIGHTS", "resnet18.pth"), "MODEL.WEIGHTS"),
    (("DIST.SPATIAL_PARALLEL", "2"), "SPATIAL_PARALLEL"),
    (("MODEL.S2D_MAX_CHANNELS", "64"), "S2D_MAX_CHANNELS"),  # ResNet18's stem and layer1
], ids=lambda o: o[0] if isinstance(o, tuple) else "")
def test_fada_trainer_refuses_the_knobs_that_wait(tmp_path, opts, match):
    if opts[0] == "MODEL.WEIGHTS":
        # no longer waits: a seeded torchvision-layout ResNet18 is the backbone's start
        _fada_knob_loads_a_seeded_resnet18(tmp_path, opts[1])
        return
    if opts[0] == "MODEL.S2D_MAX_CHANNELS":
        # no longer waits: the space-to-depth rewrite reaches every conv
        _fada_knob_rewrites_the_narrow_convs(tmp_path, opts[1])
        return
    cfg = load_cfg(train_adv.build_parser().parse_args(_cli_opts(tmp_path, *opts)))
    with pytest.raises(NotImplementedError, match=match):
        train_adv.make_trainer("deeplab_fada", cfg)


def _fada_knob_rewrites_the_narrow_convs(tmp_path, limit):
    """The threshold sits on every conv of the segmentor and of the
    discriminator (the JAX package's policy is the process's); the first
    step's losses in float32 are within 2e-4 of the knob off's."""
    from rnd_semantic_segmentation_torch.models.layers import Conv2d

    import random

    losses = []
    for opts in ((), ("MODEL.S2D_MAX_CHANNELS", limit)):
        # the augmentation draws from the random module: one loader thread,
        # seeded, gives both runs the same batches
        random.seed(0)
        args = train_adv.build_parser().parse_args(_cli_opts(
            tmp_path / str(len(opts)), "MODEL.DTYPE", "float32", *opts,
            "SOLVER.CHECKPOINT_PERIOD", "5", "DATA_PIPE.NUM_WORKERS", "0"))
        trainer = train_adv.make_trainer("deeplab_fada", load_cfg(args))
        convs = [m for part in trainer.ckpt_modules.values() for m in part.modules()
                 if isinstance(m, Conv2d)]
        assert convs and all(c.s2d_max_channels == (int(limit) if opts else 0) for c in convs)
        trainer.train()
        losses.append(trainer.series["loss_seg"][0])
    assert abs(losses[1] - losses[0]) <= 2e-4 * abs(losses[0])


def _fada_knob_loads_a_seeded_resnet18(tmp_path, name):
    from rnd_semantic_segmentation_torch.models.aspp import ResNetFeatureExtractor

    features = randomize_weights_(ResNetFeatureExtractor("resnet18", freeze_bn=True), 4)
    published = {k[len("backbone."):]: v for k, v in features.state_dict().items()}
    torch.save({**published, "fc.weight": torch.zeros(1000, 512), "fc.bias": torch.zeros(1000)},
               tmp_path / name)
    trainer = train_adv.make_trainer("deeplab_fada", load_cfg(train_adv.build_parser().parse_args(
        _cli_opts(tmp_path, "MODEL.WEIGHTS", str(tmp_path / name)))))
    loaded = trainer.segmentor.parts["feature_extractor"].state_dict()
    for key, value in published.items():
        assert torch.equal(loaded["backbone." + key], value), key
    assert trainer.state.step == 0 and DISC_PART in trainer.state.optimizers


def test_fada_trainer_builds_under_async_checkpoints(tmp_path):
    """SOLVER.ASYNC_CHECKPOINT waited until the parallelism slice."""
    cfg = load_cfg(train_adv.build_parser().parse_args(
        _cli_opts(tmp_path, "SOLVER.ASYNC_CHECKPOINT", "True")))
    trainer = train_adv.make_trainer("deeplab_fada", cfg)
    assert trainer.ckpt_writer is not None and trainer.save_blocked_ms == []
