"""The port's attn training slice (the Tversky and BCE losses at five scales,
per-sample drop-connect, train-mode BatchNorm, the Adam step with L2 weight
decay, the train-mode ``attn`` augmentation, the ``attnwrap`` variant and its
weight bridge, and the CLIs) against the JAX package's, on the CPU in float32
with TF32 off, at ``attn_efficientnet-b0`` and 64x64 unless a test says
otherwise.

Weights come from the port's ``randomize_weights_`` and reach the JAX tree
through ``attn_flax_from_state_dicts``.  Drop-connect is off on both sides in
the step tests (its bits cannot equal ``jax.random``'s): the port's encoder is
built with rate 0, and the JAX spec gets ``EfficientNetEncoder(...,
drop_connect_rate=0.0)`` in place of its own.  The JAX step is jitted once and
takes both steps.

Tolerances:
  * losses on the same logits: 1e-6 relative (float32 sums in another order);
  * the loss of each step: 1e-5 relative (measured 8e-8 and 1e-6);
  * the first step: one Adam step moves an element by lr*g/(|g|+eps) whatever
    the size of g, so every element moves by at most lr on both sides, and
    where the port's gradient (with the weight decay) exceeds 1e-5 and both
    sides moved the same way (92% of the elements here) the two agree to 2e-3
    of lr (measured 6e-4 of lr, one float32 ulp of a parameter near 1);
  * the displacement after one and after two steps, per leaf and over all
    leaves: 0.1 of the leaf's norm and 5e-3 of the whole (measured 3.7e-2
    and 1.5e-3).  These are looser than the 2e-3 above because of the 8% of
    elements whose gradient is rounding noise (a conv bias under a
    batch-statistics BN, a weight feeding a 2x2 map of 2 images): Adam moves
    each of them by a whole lr, with a sign that rounding picks, and the
    second gradient is then taken at points that differ by that much;
  * the BN running statistics (momentum 0.01 in the encoder, 0.1 in the
    decoder, unbiased variance; the JAX layer takes the variance in one pass
    as E[x^2] - E[x]^2): 1e-4 of their magnitude after one step and 1e-3
    after two (measured 2.5e-6 and 5.3e-5);
  * forward outputs through the bridge: 1e-4 of the magnitude, as in
    ``tests/test_torch_attn.py``; fused against unfused eval: 1e-5;
  * the augmentation and the weight round trips: exact.
"""

import copy
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

from rnd_semantic_segmentation_tpu import losses as jax_losses
from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.data.augment import Augmenter as JaxAugmenter
from rnd_semantic_segmentation_tpu.models.build import build_segmentor as jax_build
from rnd_semantic_segmentation_tpu.models.efficientnet import EfficientNetEncoder as JaxEncoder
from rnd_semantic_segmentation_tpu.train.segmentor import Segmentor as JaxSegmentor
from rnd_semantic_segmentation_tpu.train.steps import (
    make_family_loss as jax_family_loss,
    make_optimizers as jax_make_optimizers,
    make_src_train_step as jax_make_step,
)

from rnd_semantic_segmentation_torch import losses
from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    attn_flax_from_state_dicts,
    attn_state_dicts_from_flax,
    attnwrap_flax_from_state_dicts,
    attnwrap_state_dicts_from_flax,
    load_part,
)
from rnd_semantic_segmentation_torch.cli import test as test_cli
from rnd_semantic_segmentation_torch.cli import train_src
from rnd_semantic_segmentation_torch.cli.common import load_cfg
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.data import Augmenter
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.models.efficientnet import (
    BN_MOMENTUM,
    EfficientNetEncoder,
    MBConvBlock,
)
from rnd_semantic_segmentation_torch.serve.server import make_server
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor
from rnd_semantic_segmentation_torch.train.state import (
    TrainState,
    apply_updates,
    make_optimizers,
)
from rnd_semantic_segmentation_torch.train.steps import (
    make_family_loss,
    make_src_train_step,
    step_seed,
)

torch.set_num_threads(2)  # six test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "attn_src_kvasir.yaml")
SIZE, NC = 64, 2
MODEL = "attn_efficientnet-b0"
STEPS_PER_EPOCH = 10
WD = 1e-4
# warm-up cosine at epoch 0: BASE_LR * 1/5; the decoder at 10x
LR = {"encoder": 2e-4, "decoder": 2e-3}
OPTS = ["MODEL.NAME", MODEL, "MODEL.NUM_CLASSES", str(NC), "MODEL.DTYPE", "float32",
        "SOLVER.BASE_LR", "1e-3", "SOLVER.WEIGHT_DECAY", str(WD), "SOLVER.EPOCHS", "2"]


def port_cfg(*opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(OPTS + ["MODEL.DEVICE", "cpu", *opts])
    return cfg


def jax_cfg(*opts):
    cfg = jax_default_cfg()
    cfg.merge_from_list(OPTS + list(opts))
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


def _port_segmentor(*opts, drop_connect=False, seed=10):
    cfg = port_cfg(*opts)
    spec = build_segmentor(cfg)
    if not drop_connect:
        spec.modules["encoder"] = EfficientNetEncoder(
            "efficientnet-b0", drop_connect_rate=0.0,
            fused_mbconv=bool(cfg.MODEL.FUSED_MBCONV))
    seg = Segmentor(spec, NC)
    randomize_weights_(seg, seed=seed)
    return seg


def _randomise(path, leaf, rng):
    name = str(getattr(path[-1], "key", path[-1]))
    if name == "kernel":
        return (rng.randn(*leaf.shape) * np.sqrt(1.7 / np.prod(leaf.shape[:-1]))
                ).astype(np.float32)
    lo, hi = {"bias": (-0.1, 0.1), "scale": (0.5, 1.5), "mean": (-0.2, 0.2),
              "var": (0.5, 1.5)}[name]
    return rng.uniform(lo, hi, leaf.shape).astype(np.float32)


def _jax_template(name):
    seg = JaxSegmentor(jax_build(jax_cfg("MODEL.NAME", name)), NC)
    return seg, jax.eval_shape(seg.init, jax.random.PRNGKey(0),
                               jax.ShapeDtypeStruct((1, SIZE, SIZE, 3), jnp.float32))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(9)
    label = rng.randint(0, NC, (2, SIZE, SIZE)).astype(np.int32)
    label[:, :10, :20] = 255  # ignored pixels: a one-hot row of zeros
    return {"image": rng.rand(2, SIZE, SIZE, 3).astype(np.float32), "label": label}


# -- losses ----------------------------------------------------------------------

def test_tversky_and_bce_match_the_jax_losses(batch):
    rng = np.random.RandomState(1)
    logits = (rng.randn(2, SIZE, SIZE, NC) * 3).astype(np.float32)   # NHWC
    onehot = np.asarray(jax.nn.one_hot(batch["label"], NC, dtype=jnp.float32))
    assert (onehot[:, :10, :20] == 0).all() and onehot.sum() < 2 * SIZE * SIZE
    for port, ref in ((losses.tversky_loss, jax_losses.tversky_loss),
                      (losses.bce_with_logits, jax_losses.bce_with_logits)):
        want = float(ref(jnp.asarray(logits), jnp.asarray(onehot)))
        got = port(_nchw(logits), _nchw(onehot))
        assert got.dtype == torch.float32
        assert abs(got.item() - want) <= 1e-6 * abs(want), (port.__name__, got, want)
    # float32 reduction whatever the type of the logits
    half = losses.tversky_loss(_nchw(logits).half(), _nchw(onehot))
    assert half.dtype == torch.float32
    # alpha weighs the false negatives: all-negative predictions lose 0.7 of each class
    sure_no = torch.full((1, NC, 4, 4), -30.0)
    target = torch.zeros(1, NC, 4, 4)
    target[:, :, :2] = 1.0
    assert losses.tversky_loss(sure_no, target, eps=0.0).item() == pytest.approx(1.0)
    assert losses.tversky_loss(sure_no, target).item() == pytest.approx(1 - 1 / (0.7 * 8 + 1),
                                                                         rel=1e-5)


@pytest.mark.parametrize("family", ["attn", "attnwrap"])
def test_five_scale_family_loss_matches_the_jax_one(family, batch):
    class Spec:
        pass
    Spec.family = family
    rng = np.random.RandomState(2)
    outputs = [(rng.randn(2, SIZE >> i, SIZE >> i, NC) * 2).astype(np.float32)
               for i in range(5)]
    want = float(jax_family_loss(Spec, NC, 255)([jnp.asarray(o) for o in outputs],
                                                jnp.asarray(batch["label"])))
    got = make_family_loss(Spec, NC, 255)([_nchw(o) for o in outputs],
                                          torch.from_numpy(batch["label"]))
    assert abs(got.item() - want) <= 1e-6 * abs(want), (got, want)
    # the ignored pixels: their one-hot row is zero, not an error
    clean = batch["label"].copy()
    clean[:, :10, :20] = 0
    other = make_family_loss(Spec, NC, 255)([_nchw(o) for o in outputs],
                                            torch.from_numpy(clean))
    assert abs(other.item() - got.item()) > 1e-4


# -- drop-connect ----------------------------------------------------------------------

def _identity_block(rate):
    block = MBConvBlock(8, 8, 3, 1, 6, 0.25, drop_connect_rate=rate)
    randomize_weights_(block, seed=3)
    return block


def test_drop_connect_keeps_or_drops_each_sample_whole():
    """Each sample's output is its input, or its input plus branch/keep, with
    branch from the rate-0 block on the same weights and BN state."""
    rate, keep = 0.3, 0.7
    x = torch.from_numpy(np.random.RandomState(4).randn(200, 8, 3, 3).astype(np.float32))
    block = _identity_block(rate).train()
    zero = copy.deepcopy(block)
    zero.drop_connect_rate = 0.0
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        out = block(x, gen)
        branch = zero(x) - x
    dropped = torch.isclose(out, x, rtol=0, atol=1e-6).flatten(1).all(1)
    kept = torch.isclose(out, x + branch / keep, rtol=1e-5, atol=1e-6).flatten(1).all(1)
    assert bool((dropped ^ kept).all())
    assert abs(int(kept.sum()) - keep * 200) < 4 * (200 * keep * rate) ** 0.5
    assert branch.abs().min() < branch.abs().max() and branch.abs().mean() > 0.1

    # eval mode takes no draw and applies no mask
    block.eval(), zero.eval()
    with torch.no_grad():
        torch.testing.assert_close(block(x), zero(x), rtol=0, atol=0)
    # a train-mode block that drops needs its generator
    with pytest.raises(ValueError, match="torch.Generator"):
        block.train()(x)


def test_drop_connect_follows_the_explicit_generator_only():
    x = torch.from_numpy(np.random.RandomState(6).randn(16, 8, 3, 3).astype(np.float32))
    block = _identity_block(0.5).train()
    with torch.no_grad():
        torch.manual_seed(0)
        a = block(x, torch.Generator().manual_seed(7))
        torch.manual_seed(123)
        b = block(x, torch.Generator().manual_seed(7))
        c = block(x, torch.Generator().manual_seed(8))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)
    # the rates grow with the block index, as in the JAX package
    blocks = EfficientNetEncoder("efficientnet-b0").blocks
    assert [b.drop_connect_rate for b in blocks] == [0.2 * i / 16 for i in range(16)]
    assert step_seed(1, 3) != step_seed(1, 4) != step_seed(2, 3)


def test_train_mode_segmentor_needs_a_generator_and_runs_with_one(batch):
    seg = _port_segmentor(drop_connect=True)
    x = _nchw(batch["image"])
    with pytest.raises(ValueError, match="generator"):
        seg(x, train=True)
    with torch.no_grad():
        a, _ = seg(x, train=True, generator=torch.Generator().manual_seed(1))
        b, _ = seg(x, train=True, generator=torch.Generator().manual_seed(2))
    assert len(a) == 5 and a[0].shape == (2, NC, SIZE, SIZE) and a[4].shape == (2, NC, 4, 4)
    assert not torch.allclose(a[0], b[0])


# -- train steps -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_steps(batch):
    """Two JAX steps (one jit) from the port's seeded weights, without drop-connect."""
    jcfg = jax_cfg()
    spec = jax_build(jcfg)
    spec.modules["encoder"] = JaxEncoder("efficientnet-b0", drop_connect_rate=0.0)
    jseg = JaxSegmentor(spec, NC)
    template = jax.eval_shape(jseg.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, SIZE, SIZE, 3), jnp.float32))
    variables = attn_flax_from_state_dicts(_state_dicts(_port_segmentor()), template)
    state = jseg.make_states(variables, jax_make_optimizers(spec, jcfg))
    step = jax.jit(jax_make_step(jseg, jcfg, STEPS_PER_EPOCH))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = [(_flat({n: m.params for n, m in state.modules.items()}), None, None)]
    for _ in range(2):
        state, metrics = step(state, jbatch, jnp.float32(0))
        out.append((_flat({n: m.params for n, m in state.modules.items()}),
                    _flat({n: m.stats for n, m in state.modules.items()}),
                    {k: float(v) for k, v in metrics.items()}))
    return template, out


@pytest.fixture(scope="module")
def port_steps(batch, jax_steps):
    template, _ = jax_steps
    seg = _port_segmentor()
    cfg = port_cfg()
    tstate = TrainState(optimizers=make_optimizers(seg.spec, cfg))
    step = make_src_train_step(seg, cfg, STEPS_PER_EPOCH, tstate)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    def snapshot():
        tree = attn_flax_from_state_dicts(_state_dicts(seg), template)
        return (_flat({n: t["params"] for n, t in tree.items()}),
                _flat({n: {"batch_stats": t["batch_stats"]} for n, t in tree.items()}))

    out = [snapshot() + (None, None)]
    for _ in range(2):
        metrics = step(tbatch, 0.0)
        grads = {n: {k: p.grad + WD * p.detach() for k, p in m.named_parameters()}
                 for n, m in seg.spec.modules.items()}
        grads = _flat({n: t["params"] for n, t in
                       attn_flax_from_state_dicts(grads, template).items()})
        out.append(snapshot() + (metrics, grads))
    assert tstate.step == 2
    return seg, tstate, out


def _lr(key):
    return LR["decoder" if key.startswith("['decoder']") else "encoder"]


def test_optimizers_and_norms_of_the_attn_family():
    spec = build_segmentor(port_cfg())
    opts = make_optimizers(spec, port_cfg())
    assert spec.lr_mults == {"encoder": 1.0, "decoder": 10.0}
    for opt in opts.values():
        group = opt.param_groups[0]
        assert isinstance(opt, torch.optim.Adam) and group["weight_decay"] == WD
    norms = {n: [m for m in spec.modules[n].modules() if isinstance(m, torch.nn.BatchNorm2d)]
             for n in spec.modules}
    assert len(norms["encoder"]) == 49 and len(norms["decoder"]) == 8
    assert {m.momentum for m in norms["encoder"]} == {BN_MOMENTUM} == {0.01}
    assert {m.momentum for m in norms["decoder"]} == {0.1}
    # MODEL.FREEZE_BN (True in the attn config) reaches the ResNets only
    frozen = build_segmentor(port_cfg("MODEL.FREEZE_BN", "True"))
    assert all(type(m) is torch.nn.BatchNorm2d for part in frozen.modules.values()
               for m in part.modules() if "BatchNorm" in type(m).__name__)


@pytest.mark.parametrize("n", [1, 2], ids=["one_step", "two_steps"])
def test_train_steps_match_the_jax_steps(n, jax_steps, port_steps):
    _, ref = jax_steps
    _, _, got = port_steps
    start = ref[0][0]
    ref_params, ref_stats, ref_metrics = ref[n]
    params, stats, metrics, _ = got[n]
    assert metrics["lr"] == pytest.approx(2e-4, rel=1e-12)
    assert abs(ref_metrics["lr"] - metrics["lr"]) <= 1e-6 * metrics["lr"]
    assert abs(metrics["loss"] - ref_metrics["loss"]) <= 1e-5 * abs(ref_metrics["loss"])
    assert set(params) == set(ref_params) and len(params) == 278

    num = den = 0.0
    for key, r in ref_params.items():
        want, have = r - start[key], params[key] - start[key]
        assert np.abs(want).max() > 0, key   # every parameter moved
        err, scale = np.linalg.norm(have - want), np.linalg.norm(want)
        assert err <= 0.1 * scale, f"step {n} {key}: {err} > 0.1 x {scale}"
        num, den = num + err ** 2, den + scale ** 2
    assert num ** 0.5 <= 5e-3 * den ** 0.5

    assert set(stats) == set(ref_stats) and len(ref_stats) == 2 * 57
    for key, r in ref_stats.items():
        err = np.abs(stats[key] - r).max()
        assert err <= (1e-4 if n == 1 else 1e-3) * np.abs(r).max(), (key, err)
    moved = [k for k in ref_stats if np.abs(ref_stats[k] - got[0][1][k]).max() > 0]
    assert len(moved) == len(ref_stats)


def test_first_step_moves_each_element_as_the_jax_step(jax_steps, port_steps):
    _, ref = jax_steps
    _, _, got = port_steps
    start, (ref_params, _, _), (params, _, _, grads) = ref[0][0], ref[1], got[1]
    checked = total = 0
    for key, r in ref_params.items():
        lr = _lr(key)
        ulp = 2.5e-7 * max(np.abs(r).max(), 1.0)
        want, have = r - start[key], params[key] - start[key]
        for side in (want, have):   # one Adam step moves an element by at most lr
            assert np.abs(side).max() <= lr * 1.001 + ulp, key
        clear = (np.sign(want) == np.sign(have)) & (np.abs(grads[key]) > 1e-5)
        if clear.any():
            assert np.abs(have - want)[clear].max() <= 2e-3 * lr + ulp, key
        checked += clear.sum()
        total += clear.size
    assert checked > 0.85 * total, (checked, total)


def test_fused_eval_after_training_sees_the_new_weights(batch):
    """The fold cache of the fused MBConv path, on weights and BN statistics
    that a train step moved, and again after a further update made in eval
    mode (no mode switch clears the cache then): fused equals unfused."""
    seg = _port_segmentor("MODEL.FUSED_MBCONV", "True")
    cfg = port_cfg("MODEL.FUSED_MBCONV", "True")
    tstate = TrainState(optimizers=make_optimizers(seg.spec, cfg))
    step = make_src_train_step(seg, cfg, STEPS_PER_EPOCH, tstate)
    step({k: torch.from_numpy(v) for k, v in batch.items()}, 0.0)
    x = _nchw(batch["image"])
    blocks = seg.parts["encoder"].blocks

    def both():
        with torch.no_grad():
            fused, _ = seg(x)
            for b in blocks:
                b.fused_mbconv = False
            plain, _ = seg(x)
            for b in blocks:
                b.fused_mbconv = True
        return fused, plain

    first, plain = both()
    assert sum(b._folded is not None for b in blocks) == 11
    for f, p in zip(first, plain):
        assert (f - p).abs().max() <= 1e-5 * p.abs().max()
    for name, opt in tstate.optimizers.items():   # a further update in eval mode
        apply_updates(opt, 1e-3 * seg.spec.lr_mults[name])
    second, plain = both()
    assert (second[0] - first[0]).abs().max() > 1e-3
    for f, p in zip(second, plain):
        assert (f - p).abs().max() <= 1e-5 * p.abs().max()


# -- attnwrap and the weight bridges -------------------------------------------------

@pytest.mark.parametrize("family", ["attn", "attnwrap"])
def test_weight_bridge_round_trips_exactly(family):
    name = f"{family}_efficientnet-b0"
    _, template = _jax_template(name)
    rng = np.random.RandomState(3)
    variables = jax.tree_util.tree_map_with_path(lambda p, l: _randomise(p, l, rng), template)
    to_torch, to_flax = ((attn_state_dicts_from_flax, attn_flax_from_state_dicts)
                         if family == "attn" else
                         (attnwrap_state_dicts_from_flax, attnwrap_flax_from_state_dicts))
    sds = to_torch(variables)
    spec = build_segmentor(port_cfg("MODEL.NAME", name))
    assert set(sds) == set(spec.modules)
    for part, module in spec.modules.items():
        assert set(module.state_dict()) == set(sds[part])
        load_part(module, sds[part], part)
    back = to_flax({p: m.state_dict() for p, m in spec.modules.items()}, variables)
    want, have = _flat(variables), _flat(back)
    assert set(have) == set(want) and len(want) == 392
    for key, leaf in want.items():
        assert have[key].dtype == leaf.dtype
        np.testing.assert_array_equal(have[key], leaf, err_msg=key)


def test_attnwrap_keys_and_forward_through_the_bridge():
    jseg, template = _jax_template("attnwrap_efficientnet-b0")
    rng = np.random.RandomState(4)
    variables = jax.tree_util.tree_map_with_path(lambda p, l: _randomise(p, l, rng), template)
    spec = build_segmentor(port_cfg("MODEL.NAME", "attnwrap_efficientnet-b0"))
    assert (spec.family, spec.ckpt_prefix, spec.lr_mults, spec.optimizer) == \
        ("attnwrap", "AttnWrap", {"model": 1.0}, "adam")
    attn = build_segmentor(port_cfg())
    want = {f"{part}.{k}" for part, m in attn.modules.items() for k in m.state_dict()}
    assert set(spec.modules["model"].state_dict()) == want
    assert "encoder.encoder._blocks.15._bn2.running_var" in want
    assert "decoder.ups_1.weight" in want
    load_part(spec.modules["model"], attnwrap_state_dicts_from_flax(variables)["model"],
              "model")
    seg = Segmentor(spec, NC)
    x = np.random.RandomState(5).rand(2, SIZE, SIZE, 3).astype(np.float32)
    ref = jax.jit(lambda v, x: jseg.spec.modules["model"].apply(v, x))(
        variables["model"], jnp.asarray(x))
    with torch.no_grad():
        outs, tap = seg(_nchw(x))
    assert tap is None and len(outs) == 5
    for out, r in zip(outs, ref):
        r = np.asarray(r)
        assert np.abs(_nhwc(out) - r).max() <= 1e-4 * np.abs(r).max()


# -- the train-mode attn augmentation -------------------------------------------------

class _Recording(random.Random):
    """A ``random.Random`` that keeps what each ``choice`` returned."""

    def __init__(self, seed):
        super().__init__(seed)
        self.chosen = []

    def choice(self, seq):
        value = super().choice(seq)
        self.chosen.append(value)
        return value


def test_attn_train_transform_equals_the_jax_one_pixel_for_pixel():
    """``random.Random(s)`` against ``random.seed(s)``, four images a seed,
    uint8 and float images: until every branch has been taken."""
    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    jcfg = jax_default_cfg()
    jcfg.merge_from_file(CONFIG)
    chosen, early, dtypes = set(), 0, set()
    for seed in range(12):
        rng = _Recording(seed)
        ours = Augmenter(cfg, "train", rng=rng).build_transform()
        random.seed(seed)
        theirs = JaxAugmenter(jcfg, "train").build_transform()
        for i in range(4):
            pix = np.random.RandomState(100 * seed + i)
            image = pix.rand(40, 56, 3).astype(np.float32)
            if i % 2:
                image = (image * 255).astype(np.uint8)
            label = (pix.rand(40, 56) > 0.6).astype(np.float32)
            a, b = ours(image, label), theirs(image, label)
            assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            early += a[0] is image
            dtypes.add((image.dtype.name, a[0].dtype.name))
        chosen.update(rng.chosen)
    assert {3, 5, 7, "h", "v", "d1", "d2", 0, 1, -1} <= chosen
    assert early > 0
    # both dtypes come out: float (no PIL step) and uint8 (rotation or jitter)
    assert {("float32", "float32"), ("float32", "uint8"), ("uint8", "uint8")} <= dtypes


# -- entry points ----------------------------------------------------------------------

def _cli_opts(out_dir, name, *more):
    return ["-cfg", CONFIG, "MODEL.NAME", name, "MODEL.DEVICE", "cpu",
            "DATASETS.SOURCE_TRAIN", "synthetic_train", "DATASETS.TEST", "synthetic_val",
            "DATASETS.SYNTHETIC_LENGTH", "4", "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(64, 64)",
            "INPUT.INPUT_SIZE_TEST", "(64, 64)", "SOLVER.BATCH_SIZE", "2",
            "SOLVER.EPOCHS", "1", "SOLVER.CHECKPOINT_PERIOD", "1", "TEST.BATCH_SIZE", "2",
            "DATA_PIPE.NUM_WORKERS", "2", "OUTPUT_DIR", str(out_dir), *more]


@pytest.mark.parametrize("name,prefix,parts", [
    ("attn_efficientnet-b2", "Attn", {"encoder", "decoder"}),
    ("attnwrap_efficientnet-b2", "AttnWrap", {"model"}),
], ids=["attn", "attnwrap"])
def test_train_test_and_serve_entry_points(name, prefix, parts, tmp_path):
    """``cli.train_src`` takes 2 steps of B2 with the config's augmentation
    and writes ``{prefix}-1.pth``; ``cli.test`` evaluates it; the server built
    from the same options answers /predict."""
    import http.client
    import io

    from PIL import Image

    argv = sys.argv
    sys.argv = ["train_src"] + _cli_opts(tmp_path, name)
    try:
        train_src.cli()
    finally:
        sys.argv = argv
    family = name.split("_")[0]
    chart = json.loads((tmp_path / f"{family}_chart_params.json").read_text())
    assert len(chart["loss"]) == 2 and all(np.isfinite(chart["loss"]))
    assert chart["learning rate"] == [2e-4, 2e-4]
    ckpt = torch.load(tmp_path / f"{prefix}-1.pth", map_location="cpu", weights_only=True)
    assert parts | {f"optimizer_{p}" for p in parts} <= set(ckpt)

    args = test_cli.build_parser().parse_args(
        ["-c", os.path.join(REPO, "renders", "kvasir.json")]
        + _cli_opts(tmp_path, name, "resume", "latest"))
    cfg = load_cfg(args)
    tester = test_cli.make_tester(cfg, json.loads(open(args.config_path).read()))
    trained = {k: v for p in parts for k, v in ckpt[p].items()}
    for key, value in tester.spec.modules[sorted(parts)[0]].state_dict().items():
        assert torch.equal(value, trained[key]), key
    summary = tester.test()
    assert 0 <= summary["micro_miou"] <= 1
    cmt = json.loads((tmp_path / f"{family}_confusion_matrix.json").read_text())["cmt"]
    assert np.asarray(cmt).sum() == 4 * SIZE * SIZE

    inf, httpd = make_server(cfg, {"palette": [0, 0, 0, 255, 255, 255]},
                             logging.getLogger("serve"), port=0, max_batch=2)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        assert inf.ready.wait(120)
        buf = io.BytesIO()
        Image.fromarray((np.random.RandomState(0).rand(SIZE, SIZE, 3) * 255)
                        .astype(np.uint8)).save(buf, format="PNG")
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
        conn.request("POST", "/predict?format=raw", body=buf.getvalue())
        resp = conn.getresponse()
        mask = np.asarray(Image.open(io.BytesIO(resp.read())))
        conn.close()
        assert resp.status == 200 and mask.shape == (SIZE, SIZE) and mask.max() < NC
    finally:
        httpd.shutdown()
        httpd.server_close()
        inf.shutdown()
        thread.join(30)
    assert not thread.is_alive()
