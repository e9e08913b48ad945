"""The port's PraNet training slice (the multi-scale rates of the source
trainer, the Adam step with its 0.5 clamp and 1/8 LR, the pranet FADA step
with its 1-channel soft labels, and the CLIs) against the JAX package's, on
the CPU in float32 with TF32 off.

Weights come from the port's ``randomize_weights_`` and reach the JAX trees
through ``pranet_flax_from_state_dicts`` and ``disc_flax_from_state_dict``.
The JAX steps are jitted once each (a pranet_res2net50 step at 64x64 takes
about 30 s to compile here): the source step takes both of its steps from
one jit; the FADA step runs pranet_resnet50 (the CRANet variant), whose
graph compiles faster.

Tolerances:
  * the multi-scale resize: the image within 2e-5 of its magnitude (float32
    interpolation weights, matrices in the JAX package; 7.8e-6 measured),
    the label exact;
  * the source step on 4 images at 64x64 with BN on batch statistics is
    badly conditioned: against the port's float64 gradient the float32
    gradients are off by a median of several percent of a leaf's norm, and
    a BN bias ahead of a convolution and another BN has a true gradient near
    1e-17, which float32 rounding alone sets.  One Adam step moves such an
    element by a whole lr of either sign.  So the loss after one step is
    held to 1e-5 relative (1.4e-6 measured) but after two to 5e-3 (1.2e-3
    measured; the JAX step's float32 loss is itself 1.7e-3 from the port's
    float64 one at these shapes); the BN running statistics to 1e-3 of
    their magnitude after one step and 3e-2 after two (1.2e-4 and 9.0e-3
    measured); the first step's direction to the float64 gradient's sign
    where that exceeds 1e-6, the port's at least as often as the JAX step's
    less 0.1% (99.81% and 99.20% measured); and each of the port's updates
    to the JAX package's own optimizer (``apply_updates``: the clamp, then
    optax's Adam) applied to the port's gradients, within 1e-3 of lr plus
    one float32 ulp of the parameter;
  * the four losses of the FADA step: 1e-4 relative (2.5e-5 measured: D
    reads the layer4 tap of a train-mode forward, 2x2 at 64x64); every LR:
    1e-6 relative; D's Adam step: at most lr on both sides, and within 2e-3
    of lr where the port's gradient exceeds 1e-5 and both sides moved the
    same way (as in ``tests/test_torch_fada.py``).
"""

import json
import logging
import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.models.build import (
    build_adversarial_discriminator as jax_build_disc,
    build_segmentor as jax_build,
)
from rnd_semantic_segmentation_tpu.train.fada import FadaState, make_fada_train_step as jax_fada
from rnd_semantic_segmentation_tpu.train.segmentor import Segmentor as JaxSegmentor
from rnd_semantic_segmentation_tpu.train.state import ModuleState
from rnd_semantic_segmentation_tpu.train.state import apply_updates as jax_apply_updates
from rnd_semantic_segmentation_tpu.train.state import make_optimizer as jax_make_optimizer
from rnd_semantic_segmentation_tpu.train.steps import (
    make_optimizers as jax_make_optimizers,
    make_src_train_step as jax_make_step,
)
from rnd_semantic_segmentation_tpu.train.trainer import _resize_batch_to as jax_resize_batch_to

from rnd_semantic_segmentation_torch import losses
from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    disc_flax_from_state_dict,
    pranet_flax_from_state_dicts,
)
from rnd_semantic_segmentation_torch.cli import test as test_cli
from rnd_semantic_segmentation_torch.cli import train_adv, train_src
from rnd_semantic_segmentation_torch.cli.common import load_cfg
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.data.trees import write_dataset_trees
from rnd_semantic_segmentation_torch.models.build import (
    build_adversarial_discriminator,
    build_segmentor,
    randomize_weights_,
)
from rnd_semantic_segmentation_torch.serve.server import make_server
from rnd_semantic_segmentation_torch.train.fada import (
    DISC_PART,
    TEMPERATURE,
    make_disc_optimizer,
    make_fada_train_step,
)
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor
from rnd_semantic_segmentation_torch.train.state import TrainState, make_optimizers
from rnd_semantic_segmentation_torch.train.steps import make_family_loss, make_src_train_step
from rnd_semantic_segmentation_torch.train.trainer import (
    MULTISCALE_RATES,
    rate_side,
    resize_batch_to,
)

torch.set_num_threads(2)  # six test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_CONFIG = os.path.join(REPO, "configs", "pranet_src_polyp.yaml")
ADV_CONFIG = os.path.join(REPO, "configs", "pranet_adv_polyp_bli.yaml")
NC, SIZE = 2, 64
STEPS_PER_EPOCH = 10
BASE_LR = 1e-4
LOSS_TOL = (1e-5, 5e-3)   # relative, after one and two steps
STATS_TOL = (1e-3, 3e-2)  # of the magnitude, after one and two steps
BASE = ["MODEL.NUM_CLASSES", str(NC), "MODEL.DTYPE", "float32", "SOLVER.EPOCHS", "2",
        "SOLVER.BASE_LR", str(BASE_LR), "SOLVER.BASE_LR_D", "1e-4"]


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


def _state_dicts(seg):
    return {n: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for n, m in seg.spec.modules.items()}


def _template(name):
    jseg = JaxSegmentor(jax_build(jax_cfg(name)), NC)
    return jseg, jax.eval_shape(jseg.init, jax.random.PRNGKey(0),
                                jax.ShapeDtypeStruct((1, SIZE, SIZE, 3), jnp.float32))


def _port_segmentor(name, seed=10):
    seg = Segmentor(build_segmentor(port_cfg(name)), NC)
    return randomize_weights_(seg, seed=seed)


def _polyp_batch(n, side, seed):
    """Normalised-looking images and binary masks of two discs each."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:side, :side]
    label = np.zeros((n, side, side), np.int32)
    for i in range(n):
        for _ in range(2):
            cy, cx, r = rng.randint(0, side, 2).tolist() + [rng.randint(side // 8, side // 3)]
            label[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 1
    image = (rng.randn(n, side, side, 3) + label[..., None] * 0.8).astype(np.float32)
    return {"image": image, "label": label}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- multi-scale rates ------------------------------------------------------------------

def test_rate_sides():
    """round(TRAINSIZE * rate / 32) * 32 with Python's round (half to even):
    at 64 every rate gives 64, so the accounting test runs at 96."""
    assert [rate_side(352, r) for r in MULTISCALE_RATES] == [256, 352, 448]
    assert [rate_side(96, r) for r in MULTISCALE_RATES] == [64, 96, 128]
    assert [rate_side(64, r) for r in MULTISCALE_RATES] == [64, 64, 64]


@pytest.mark.parametrize("size", [64, 72, 128])
def test_multiscale_resize_matches_the_jax_one(size):
    batch = _polyp_batch(2, 96, seed=1)
    ref = jax_resize_batch_to(dict(batch), size)
    got = resize_batch_to(_torch_batch(batch), size)
    assert got["image"].shape == (2, size, size, 3) and got["label"].dtype == torch.int32
    err = np.abs(got["image"].numpy() - ref["image"]).max()
    assert err <= 2e-5 * np.abs(ref["image"]).max()
    np.testing.assert_array_equal(got["label"].numpy(), ref["label"])
    assert set(np.unique(ref["label"])) == {0, 1}


def test_labels_round_half_to_even_as_np_rint():
    """A 0/1 column pair resized 2 -> 3 with align_corners=True puts exactly
    0.5 in the middle: both round it to 0."""
    label = np.array([[[0, 1], [0, 1]]], np.int32)
    batch = {"image": np.zeros((1, 2, 2, 3), np.float32), "label": label}
    got = resize_batch_to(_torch_batch(batch), 3)["label"].numpy()
    np.testing.assert_array_equal(got, jax_resize_batch_to(batch, 3)["label"])
    np.testing.assert_array_equal(got[0, 0], [0, 0, 1])


def _trainer_opts(out_dir, *more):
    return ["-cfg", SRC_CONFIG, "MODEL.DEVICE", "cpu", "DATASETS.SOURCE_TRAIN",
            "synthetic_train", "DATASETS.SYNTHETIC_LENGTH", "4", "AUG.NAME", "none",
            "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(96, 96)", "INPUT.TRAINSIZE", "96",
            "SOLVER.BATCH_SIZE", "2", "SOLVER.EPOCHS", "1", "DATA_PIPE.NUM_WORKERS", "1",
            "OUTPUT_DIR", str(out_dir), *more]


def _spy(trainer):
    seen = []
    step = trainer.step_fn

    def spied(*args):
        seen.append(tuple(tuple(b["image"].shape[1:3]) for b in args[:-1]))
        return step(*args)
    trainer.step_fn = spied
    return seen


def test_source_trainer_takes_three_steps_a_batch(tmp_path):
    """TRAINSIZE 96: each of the 2 batches is stepped at 64, 96 and 128; the
    step count is 6, the iteration count and the series 2; the labels stay
    binary after the resize."""
    cfg = load_cfg(train_src.build_parser().parse_args(_trainer_opts(tmp_path)))
    trainer = train_src.make_trainer("pranet", cfg)
    assert trainer.rates == MULTISCALE_RATES
    seen = _spy(trainer)
    labels = []
    step = trainer.step_fn
    trainer.step_fn = lambda batch, ep: (labels.append(batch["label"].unique().tolist()),
                                         step(batch, ep))[1]
    trainer.train()
    assert seen == [((64, 64),), ((96, 96),), ((128, 128),)] * 2
    assert trainer.state.step == 6 and len(trainer.loss_data) == 2
    assert all(set(v) <= {0, 1} for v in labels)
    assert all(np.isfinite(trainer.loss_data))
    # gradual warm-up at epoch 0: BASE_LR itself, the model at 1/8 of it
    assert trainer.lr_data == [pytest.approx(1e-4)] * 2
    assert trainer.state.optimizers["model"].param_groups[0]["lr"] == pytest.approx(1.25e-5)
    assert (tmp_path / "PraNet-1.pth").exists() is False  # CHECKPOINT_PERIOD 5
    chart = json.loads((tmp_path / "pranet_chart_params.json").read_text())
    assert len(chart["loss"]) == 2


def test_fada_trainer_takes_one_step_a_batch_for_pranet(tmp_path):
    """The FADA trainer inherits the loop but not the rates, as the JAX
    ``FadaTrainer`` takes one step a batch at any family."""
    opts = ["-cfg", ADV_CONFIG, "MODEL.DEVICE", "cpu", "MODEL.NAME", "pranet_resnet50",
            "DATASETS.SOURCE_TRAIN", "synthetic_train", "DATASETS.TARGET_TRAIN",
            "synthetic_shift_train", "DATASETS.SYNTHETIC_LENGTH", "4", "AUG.NAME", "none",
            "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(96, 96)", "INPUT.TRAINSIZE", "96",
            "SOLVER.BATCH_SIZE", "4",
            "SOLVER.EPOCHS", "1", "SOLVER.CHECKPOINT_PERIOD", "1",
            "DATA_PIPE.NUM_WORKERS", "1", "OUTPUT_DIR", str(tmp_path)]
    cfg = load_cfg(train_adv.build_parser().parse_args(opts))
    trainer = train_adv.make_trainer("pranet_fada", cfg)
    assert trainer.rates == (1.0,) and trainer.disc.D[0].in_channels == 2048
    seen = _spy(trainer)
    trainer.train()
    assert seen == [((96, 96), (96, 96))] * 2 and trainer.state.step == 2
    for values in trainer.series.values():
        assert len(values) == 2 and all(np.isfinite(values))
    ckpt = torch.load(tmp_path / "PraNetFada-1.pth", map_location="cpu", weights_only=True)
    assert {"model", DISC_PART, "optimizer_model", f"optimizer_{DISC_PART}"} <= set(ckpt)


# -- two Adam steps against the JAX step ---------------------------------------------------

BATCH = 4


@pytest.fixture(scope="module")
def batch():
    return _polyp_batch(BATCH, SIZE, seed=9)


@pytest.fixture(scope="module")
def jax_steps(batch):
    """Two JAX steps of pranet_res2net50 (one jit) from the port's seeded weights."""
    jseg, template = _template("pranet_res2net50")
    jcfg = jax_cfg("pranet_res2net50")
    variables = pranet_flax_from_state_dicts(
        _state_dicts(_port_segmentor("pranet_res2net50")), template)
    state = jseg.make_states(variables, jax_make_optimizers(jseg.spec, jcfg))
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
    """Two port steps; after each, the parameters, the BN statistics, the
    metrics and the gradients the optimizer took (clamped), in flax layout."""
    template, _ = jax_steps
    seg = _port_segmentor("pranet_res2net50")
    cfg = port_cfg("pranet_res2net50")
    tstate = TrainState(optimizers=make_optimizers(seg.spec, cfg))
    step = make_src_train_step(seg, cfg, STEPS_PER_EPOCH, tstate)

    def snapshot():
        tree = pranet_flax_from_state_dicts(_state_dicts(seg), template)
        return (_flat({n: t["params"] for n, t in tree.items()}),
                _flat({n: {"batch_stats": t["batch_stats"]} for n, t in tree.items()}))

    out = [snapshot() + (None, None)]
    for _ in range(2):
        metrics = step(_torch_batch(batch), 0.0)
        grads = {n: {k: p.grad.clone() for k, p in m.named_parameters()}
                 for n, m in seg.spec.modules.items()}
        out.append(snapshot() + (metrics, pranet_flax_from_state_dicts(grads, template)))
    assert tstate.step == 2
    return seg, tstate, out


@pytest.fixture(scope="module")
def float64_gradient(batch, jax_steps):
    """The first step's gradient from the port in float64: the reference both
    float32 steps are held to where their rounding decides a sign."""
    template, _ = jax_steps
    seg = _port_segmentor("pranet_res2net50").double()
    outputs, _ = seg(_torch_batch(batch)["image"].double().permute(0, 3, 1, 2), train=True)
    make_family_loss(seg.spec, NC)(outputs, torch.from_numpy(batch["label"])).backward()
    grads = {n: {k: p.grad.float() for k, p in m.named_parameters()}
             for n, m in seg.spec.modules.items()}
    return _flat({n: t["params"] for n, t in
                  pranet_flax_from_state_dicts(grads, template).items()})


def test_optimizer_clamp_and_lr_of_the_pranet_step(port_steps):
    """Adam without weight decay, the model at 1/8 of the gradual warm-up's
    LR, and every gradient element clamped to [-0.5, 0.5]: some reached
    the clamp in these two steps."""
    _, tstate, got = port_steps
    opt = tstate.optimizers["model"]
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.Adam) and group["weight_decay"] == 0.0
    assert group["lr"] == pytest.approx(BASE_LR / 8, rel=1e-12)
    assert got[1][2]["lr"] == pytest.approx(BASE_LR, rel=1e-12)
    peaks = [np.abs(g).max() for i in (1, 2) for g in _flat(got[i][3]).values()]
    assert max(peaks) == pytest.approx(0.5, abs=1e-7)


@pytest.mark.parametrize("n", [1, 2], ids=["one_step", "two_steps"])
def test_train_steps_match_the_jax_steps(n, jax_steps, port_steps):
    _, ref = jax_steps
    _, _, got = port_steps
    start = ref[0][0]
    ref_params, ref_stats, ref_metrics = ref[n]
    params, stats, metrics, _ = got[n]
    assert abs(ref_metrics["lr"] - metrics["lr"]) <= 1e-6 * metrics["lr"]
    tol = LOSS_TOL[n - 1]
    assert abs(metrics["loss"] - ref_metrics["loss"]) <= tol * abs(ref_metrics["loss"])
    assert set(params) == set(ref_params) and len(params) > 400
    for key, r in ref_params.items():   # every parameter moved on both sides
        assert np.abs(r - start[key]).max() > 0 and np.abs(params[key] - start[key]).max() > 0
    assert set(stats) == set(ref_stats) and len(ref_stats) > 200
    for key, r in ref_stats.items():
        err = np.abs(stats[key] - r).max()
        assert err <= STATS_TOL[n - 1] * np.abs(r).max(), (key, err)
        assert np.abs(r - got[0][1][key]).max() > 0, key


def test_each_step_is_the_jax_optimizers_update_of_the_ports_gradient(port_steps):
    """The JAX package's own update (``apply_updates``: the 0.5 clamp, then
    optax's Adam at 1/8 of the LR) applied to the port's gradients gives the
    port's parameters after each of the two steps."""
    _, _, got = port_steps
    tx = jax_make_optimizer("adam")
    structure = got[1][3]["model"]["params"]
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(structure)[0]]
    tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(structure), [
        got[0][0]["['model']" + jax.tree_util.keystr(p)] for p in paths])
    state = ModuleState(params=tree, stats={}, opt_state=tx.init(tree))
    lr = BASE_LR / 8
    for i in (1, 2):
        state = jax_apply_updates(state, got[i][3]["model"]["params"], tx, lr, grad_clip=0.5)
        mine = _flat({"model": state.params})
        for key, want in got[i][0].items():
            ulp = 2.5e-7 * max(np.abs(want).max(), 1.0)
            err = np.abs(mine[key] - want).max()
            assert err <= 1e-3 * lr + ulp, (i, key, err)


def test_first_step_moves_with_the_float64_gradient_as_often_as_the_jax_step(
        jax_steps, port_steps, float64_gradient):
    """In train mode on 4 images at 64x64 this step is badly conditioned:
    against the port's float64 gradient the float32 gradients are off by a
    median of several percent of a leaf's norm (the port's about 3%, the JAX
    step's about 8%, at 2 images), and a BN bias ahead of a convolution and
    another BN has a true gradient of about 1e-17, so its float32 gradient
    is rounding alone.  One Adam step moves each element by lr times the
    sign of its gradient; so each side's first step is held to the signs of
    the float64 gradient where that exceeds 1e-6: the port must get them
    right at least as often as the JAX step does, less 0.1%, and both in
    more than 97% of the elements."""
    _, ref = jax_steps
    _, _, got = port_steps
    start = ref[0][0]
    wrong = {"jax": 0, "port": 0}
    total = 0
    for key, g in float64_gradient.items():
        clear = np.abs(g) > 1e-6
        total += clear.sum()
        for side, moved in (("jax", ref[1][0][key]), ("port", got[1][0][key])):
            step = moved - start[key]
            wrong[side] += (clear & (np.sign(step) != -np.sign(g))).sum()
    share = {side: 1 - w / total for side, w in wrong.items()}
    assert total > 2e7
    assert share["port"] >= share["jax"] - 1e-3 and min(share.values()) > 0.97, share


def _assert_adam_step(start, ref, got, grads, lr, share):
    """One Adam step: at most lr on both sides; within 2e-3 of lr where the
    port's gradient is clear of rounding and both moved the same way."""
    checked = total = 0
    for key, r in ref.items():
        ulp = 2.5e-7 * max(np.abs(r).max(), 1.0)
        want, have = r - start[key], got[key] - start[key]
        for side in (want, have):
            assert np.abs(side).max() <= lr * 1.001 + ulp, key
        clear = (np.sign(want) == np.sign(have)) & (np.abs(grads[key]) > 1e-5)
        if clear.any():
            assert np.abs(have - want)[clear].max() <= 2e-3 * lr + ulp, key
        checked += clear.sum()
        total += (np.abs(grads[key]) > 1e-5).sum()
    assert checked > share * total, (checked, total)


# -- one FADA step against the JAX step -----------------------------------------------------

CRANET = "pranet_resnet50"


def test_fada_step_matches_the_jax_step():
    """pranet_resnet50 at 64x64, 2 + 2 images: the structure loss on the raw
    maps, the soft labels [1 - p, p] of lateral map 5 at temperature 1.8,
    clipped at 0.9, poly LR (1e-4 for the model's 1/8 and for D), Adam with
    no weight decay and no clamp; the four losses, both LRs and D's step."""
    cfg = port_cfg(CRANET)
    seg = _port_segmentor(CRANET)
    disc = randomize_weights_(build_adversarial_discriminator(cfg, seg.spec), seed=11)
    src = _polyp_batch(2, SIZE, seed=12)
    tgt = {"image": (np.random.RandomState(13).rand(2, SIZE, SIZE, 3) * 0.7
                     ).astype(np.float32), "label": np.zeros((2, SIZE, SIZE), np.int32)}

    jcfg = jax_cfg(CRANET)
    jseg, template = _template(CRANET)
    seg_state = jseg.make_states(pranet_flax_from_state_dicts(_state_dicts(seg), template),
                                 jax_make_optimizers(jseg.spec, jcfg))
    jdisc = jax_build_disc(jcfg)
    dtemplate = jax.eval_shape(lambda r, x: jdisc.init(r, x, size=None), jax.random.PRNGKey(0),
                               jnp.zeros((1, 2, 2, 2048), jnp.float32))
    dparams = disc_flax_from_state_dict(disc.state_dict(), dtemplate)["params"]
    tx_d = jax_make_optimizer("adam", betas=(0.9, 0.99))
    state = FadaState(seg=seg_state, disc=ModuleState(params=dparams, stats={},
                                                      opt_state=tx_d.init(dparams)))
    new, jmetrics = jax_fada(jseg, jdisc, jcfg, STEPS_PER_EPOCH)(
        state, {k: jnp.asarray(v) for k, v in src.items()},
        {k: jnp.asarray(v) for k, v in tgt.items()}, jnp.float32(0))
    jmetrics = {k: float(v) for k, v in jmetrics.items()}

    seen = []  # the step's forwards: maps and taps
    seg.register_forward_hook(lambda mod, inp, out: seen.append(
        (tuple(o.detach() for o in out[0]), out[1].detach())))
    tstate = TrainState(optimizers={**make_optimizers(seg.spec, cfg),
                                    DISC_PART: make_disc_optimizer(disc)})
    disc0 = {k: v.clone() for k, v in disc.state_dict().items()}
    metrics = make_fada_train_step(seg, disc, cfg, STEPS_PER_EPOCH, tstate)(
        _torch_batch(src), _torch_batch(tgt), 0.0)
    assert tstate.step == 1 and len(seen) == 2
    assert set(metrics) == set(jmetrics)
    assert metrics["lr"] == pytest.approx(1e-4, rel=1e-12) == metrics["lr_D"]
    assert tstate.optimizers["model"].param_groups[0]["lr"] == pytest.approx(1.25e-5)
    assert tstate.optimizers["model"].param_groups[0]["weight_decay"] == 0.0
    for key, value in jmetrics.items():
        assert np.isfinite(metrics[key])
        assert abs(metrics[key] - value) <= (1e-6 if key.startswith("lr") else 1e-4) \
            * abs(value), (key, metrics[key], value)

    # D's loss on the source is that of the soft labels of lateral map 5, not map 2
    maps, tap = seen[0]
    disc_before = build_adversarial_discriminator(cfg, seg.spec)
    disc_before.load_state_dict(disc0)

    def d_src(final):
        p = torch.sigmoid(final / TEMPERATURE)
        soft = torch.cat([1 - p, p], 1).clamp(max=0.9)
        with torch.no_grad():
            return 0.5 * losses.soft_label_cross_entropy(
                disc_before(tap, (SIZE, SIZE)), torch.cat([soft, torch.zeros_like(soft)], 1))

    assert abs(d_src(maps[0]).item() - metrics["loss_D_src"]) <= 1e-6 * metrics["loss_D_src"]
    assert abs(d_src(maps[3]).item() - metrics["loss_D_src"]) > 1e-4 * metrics["loss_D_src"]

    dgot = _flat(disc_flax_from_state_dict(disc.state_dict(), dtemplate)["params"])
    dgrads = _flat(disc_flax_from_state_dict(
        {k: p.grad for k, p in disc.named_parameters()}, dtemplate)["params"])
    _assert_adam_step(_flat(dparams), _flat(new.disc.params), dgot, dgrads, 1e-4, share=0.9)


# -- entry points -------------------------------------------------------------------------

def test_the_polyp_reader_resizes_to_source_input_size_train_in_both_packages(tmp_path):
    """configs/pranet_src_polyp.yaml leaves INPUT.SOURCE_INPUT_SIZE_TRAIN at
    its default (1280, 720), and the Kvasir-fold reader resizes each item to
    it after the pra transform, in both packages: the rate-1.0 step would
    then run at 720x1280, whose /16 map (45) no 2x upsampling of the /32 map
    (23) meets.  The runs of this config set the size to TRAINSIZE squared,
    where the reader's resize is the identity."""
    from rnd_semantic_segmentation_tpu.data import build_dataset as jax_build_dataset

    from rnd_semantic_segmentation_torch.data import build_dataset

    write_dataset_trees(str(tmp_path), seed=7, trees={"kvasir": (1, 1, (90, 70))})
    base = ["DATASETS.DATASET_DIR", str(tmp_path), "INPUT.TRAINSIZE", "96"]
    for more, shape in (([], (720, 1280)), (["INPUT.SOURCE_INPUT_SIZE_TRAIN", "(96, 96)"],
                                            (96, 96))):
        cfg = load_cfg(train_src.build_parser().parse_args(["-cfg", SRC_CONFIG] + base + more))
        jcfg = jax_default_cfg()
        jcfg.merge_from_file(SRC_CONFIG)
        jcfg.merge_from_list(base + more)
        for build, c in ((build_dataset, cfg), (jax_build_dataset, jcfg)):
            image, label, _ = build(c, "train")[0]
            assert image.shape == shape + (3,) and label.shape == shape

def test_train_test_and_serve_entry_points(tmp_path):
    """configs/pranet_src_polyp.yaml at a tiny size on polyp files:
    ``cli.train_src`` takes 2 batches of 2 at 96 (6 optimizer steps) and
    writes PraNet-1.pth; ``cli.test`` evaluates it on polyp_val and bli_val;
    the server built from the same options answers /predict."""
    import http.client
    import io

    from PIL import Image

    write_dataset_trees(str(tmp_path / "data"), seed=6,
                        trees={"kvasir": (4, 2, (80, 72)), "bli": (2, 2, (72, 80))})
    opts = ["-cfg", SRC_CONFIG, "MODEL.DEVICE", "cpu", "MODEL.NAME", CRANET,
            "DATASETS.DATASET_DIR", str(tmp_path / "data"), "INPUT.TRAINSIZE", "96",
            "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(96, 96)",
            "INPUT.INPUT_SIZE_TEST", "(96, 96)", "SOLVER.BATCH_SIZE", "2",
            "SOLVER.EPOCHS", "1", "SOLVER.CHECKPOINT_PERIOD", "1",
            "DATA_PIPE.NUM_WORKERS", "1", "OUTPUT_DIR", str(tmp_path)]
    argv = sys.argv
    sys.argv = ["train_src"] + opts
    try:
        train_src.cli()
    finally:
        sys.argv = argv
    chart = json.loads((tmp_path / "pranet_chart_params.json").read_text())
    assert len(chart["loss"]) == 2 and all(np.isfinite(chart["loss"]))
    ckpt = torch.load(tmp_path / "PraNet-1.pth", map_location="cpu", weights_only=True)
    assert {"model", "optimizer_model"} <= set(ckpt) and ckpt["step"] == 6
    assert "resnet.layer4.2.bn3.running_var" in ckpt["model"]

    for dataset, render, images in (("polyp_val", "kvasir.json", 2), ("bli_val", "bli.json", 2)):
        args = test_cli.build_parser().parse_args(
            ["-c", os.path.join(REPO, "renders", render)] + opts
            + ["DATASETS.TEST", dataset, "resume", "latest"])
        cfg = load_cfg(args)
        summary = test_cli.test(cfg, json.loads(open(args.config_path).read()), args)
        assert 0 <= summary["micro_miou"] <= 1
        cmt = json.loads((tmp_path / "pranet_confusion_matrix.json").read_text())["cmt"]
        assert np.asarray(cmt).sum() == images * 96 * 96

    inf, httpd = make_server(cfg, {"palette": [0, 0, 0, 255, 255, 255]},
                             logging.getLogger("serve"), port=0, max_batch=1)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        assert inf.ready.wait(120)
        buf = io.BytesIO()
        Image.fromarray((np.random.RandomState(0).rand(120, 100, 3) * 255)
                        .astype(np.uint8)).save(buf, format="PNG")
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
        conn.request("POST", "/predict?format=raw", body=buf.getvalue())
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        assert resp.status == 200, body[:300]
        mask = np.asarray(Image.open(io.BytesIO(body)))
        assert mask.shape == (96, 96) and mask.max() <= 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        inf.shutdown()
        thread.join(30)
    assert not thread.is_alive()
