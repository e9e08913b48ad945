"""The port's online self-distillation (train/distill.py, the online branch of
cli/train_distill.py) against the JAX package's ``make_online_distill_step``,
on the CPU in float32 with TF32 off.

Student and teacher are seeded with the port's ``randomize_weights_`` (seeds
10 and 20) and reach the JAX trees through the ``*_flax_from_state_dicts``
bridges.  A seeded deeplab teacher predicts one class with a nearly flat
softmax, so ``_sharpen`` centres its class means over the batch and scales
its classifier until its logits spread (std 4.5): at threshold 0.9 about
40% of the pixels are then ignored.

Tolerances:
  * the loss of a step (taken before its update): 1e-5 relative for deeplab
    and attn; pranet_res2net50's train-mode forward on two images at 64x64
    is badly conditioned (as in ``tests/test_torch_pranet_train.py``): its
    loss within 1e-4 of the JAX step's (6.8e-5 measured) and within 5e-5 of
    the port's own float64 loss (2.8e-5 measured; the JAX float32 loss is
    itself 9.6e-5 from it), as the pranet FADA step is held to 1e-4; the LR:
    1e-6 relative (the JAX step computes it in float32);
  * deeplab_resnet18 (FrozenBN, SGD, classifier at 10x): each leaf's update
    within 2e-3 of its largest element plus one float32 ulp of the leaf, as
    ``tests/test_torch_fada.py`` holds the FADA step;
  * the pseudo-labels: equal wherever the teacher's top two probabilities
    (or a sigmoid and 0.5, or a confidence and the threshold) are more than
    1e-4 apart;
  * the teacher after the steps: bit-equal.

The GALD online step runs in the port alone, at 224x224 with two images: the
JAX GALD step takes over a minute to compile on the CPU.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.models.build import build_segmentor as jax_build
from rnd_semantic_segmentation_tpu.models.efficientnet import EfficientNetEncoder as JaxEncoder
from rnd_semantic_segmentation_tpu.train.distill import (
    make_online_distill_step as jax_make_online_distill_step,
)
from rnd_semantic_segmentation_tpu.train.segmentor import Segmentor as JaxSegmentor
from rnd_semantic_segmentation_tpu.train.steps import make_optimizers as jax_make_optimizers

from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    attn_flax_from_state_dicts,
    deeplab_flax_from_state_dicts,
    pranet_flax_from_state_dicts,
)
from rnd_semantic_segmentation_torch.cli import train_adv, train_distill, train_src
from rnd_semantic_segmentation_torch.cli.common import load_cfg
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.models.efficientnet import EfficientNetEncoder
from rnd_semantic_segmentation_torch.train import distill
from rnd_semantic_segmentation_torch.train.distill import (
    make_online_distill_step,
    pseudo_labels,
    teacher_logits,
)
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor
from rnd_semantic_segmentation_torch.train.state import TrainState, make_optimizers
from rnd_semantic_segmentation_torch.train.steps import make_family_loss, step_seed

torch.set_num_threads(2)  # six test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS_PER_EPOCH = 10
MARGIN = 1e-4
LOSS_TOL = {"attn_efficientnet-b0": 1e-5, "pranet_res2net50": 1e-4}
PRANET_FLOAT64_TOL = 5e-5
BRIDGES = {"deeplab": deeplab_flax_from_state_dicts, "attn": attn_flax_from_state_dicts,
           "pranet": pranet_flax_from_state_dicts}


def _opts(name, nc, *more):
    return ["MODEL.NAME", name, "MODEL.NUM_CLASSES", str(nc), "MODEL.DTYPE", "float32",
            "MODEL.FREEZE_BN", "True", "SOLVER.EPOCHS", "2", "SOLVER.BASE_LR", "1e-3",
            "SOLVER.WEIGHT_DECAY", "1e-4", *more]


def port_cfg(name, nc, *more):
    cfg = get_default_cfg()
    cfg.merge_from_list(_opts(name, nc, "MODEL.DEVICE", "cpu", *more))
    return cfg


def _segmentor(cfg, seed, drop_connect=True):
    spec = build_segmentor(cfg)
    if spec.family == "attn" and not drop_connect:
        spec.modules["encoder"] = EfficientNetEncoder(spec.backbone, drop_connect_rate=0.0)
    return randomize_weights_(Segmentor(spec, cfg.MODEL.NUM_CLASSES), seed=seed)


def _teacher(cfg, seed=20):
    return _segmentor(cfg, seed).eval().requires_grad_(False)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


@torch.no_grad()
def _sharpen(teacher, x, std=4.5):
    """The deeplab teacher's class means over ``x`` off its bias, then its
    classifier scaled until the logits' std is ``std``."""
    convs = teacher.parts["classifier"].conv2d_list
    convs[0].bias -= teacher_logits(teacher, x).mean(dim=(0, 2, 3))
    scale = std / teacher_logits(teacher, x).std().item()
    for conv in convs:
        conv.weight *= scale
        conv.bias *= scale
    return teacher


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _state_dicts(seg):
    return {n: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for n, m in seg.spec.modules.items()}


def _jax_side(name, nc, side, student, teacher, threshold, *more):
    """The JAX segmentor, its template, the student's state and the
    teacher's variables from the port's weights, and the jitted online step."""
    jcfg = jax_default_cfg()
    jcfg.merge_from_list(_opts(name, nc, *more))
    spec = jax_build(jcfg)
    if spec.family == "attn":
        spec.modules["encoder"] = JaxEncoder(spec.backbone, drop_connect_rate=0.0)
    jseg = JaxSegmentor(spec, nc)
    template = jax.eval_shape(jseg.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, side, side, 3), jnp.float32))
    to_flax = BRIDGES[spec.family]
    state = jseg.make_states(to_flax(_state_dicts(student), template),
                             jax_make_optimizers(spec, jcfg))
    tvars = to_flax(_state_dicts(teacher), template)
    t_params = {n: v["params"] for n, v in tvars.items()}
    t_stats = {n: {c: t for c, t in v.items() if c != "params"} for n, v in tvars.items()}
    step = jax_make_online_distill_step(jseg, jcfg, STEPS_PER_EPOCH, t_params, t_stats,
                                        confidence_threshold=threshold,
                                        base_rng=jax.random.PRNGKey(jcfg.SEED + 1))
    return jseg, template, state, (t_params, t_stats), step


def _jax_teacher_logits(jseg, tvars, image):
    outputs, _, _ = jseg.forward(*tvars, jnp.asarray(image), label_size=image.shape[1:3],
                                 train=False)
    fam = jseg.spec.family
    return np.asarray(outputs[-1] if fam in ("gald", "pranet") else outputs[0], np.float32)


def _assert_pseudo_labels_match(got, jax_logits, threshold=0.0):
    """``got`` [B,H,W] against the JAX branch's labels, away from ties."""
    z = jax_logits.astype(np.float64)
    if z.shape[-1] == 1:
        p = 1 / (1 + np.exp(-z[..., 0]))
        want, conf, margin = (p >= 0.5).astype(np.int32), np.maximum(p, 1 - p), np.abs(p - 0.5)
    else:
        probs = np.exp(z - z.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        top = np.sort(probs, -1)
        want, conf, margin = probs.argmax(-1).astype(np.int32), top[..., -1], \
            top[..., -1] - top[..., -2]
    if threshold > 0:
        want = np.where(conf >= threshold, want, 255)
        margin = np.minimum(margin, np.abs(conf - threshold))
    clear = margin > MARGIN
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])
    return want


def _port_step(cfg, student, teacher, batch, threshold):
    state = TrainState(optimizers=make_optimizers(student.spec, cfg))
    step = make_online_distill_step(student, cfg, STEPS_PER_EPOCH, state, teacher,
                                    confidence_threshold=threshold, seed=cfg.SEED + 1)
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()}, 0.0)
    assert state.step == 1
    return metrics


def _batch(n, side, nc, seed=9):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(n, side, side, 3).astype(np.float32),
            # the loader's labels: read and ignored by the online step
            "label": rng.randint(0, nc, (n, side, side)).astype(np.int32)}


# -- one step against the JAX step -------------------------------------------------------

@pytest.mark.parametrize("threshold", [0.0, 0.9])
def test_deeplab_online_step_matches_the_jax_step(threshold):
    """deeplab_resnet18, 3 classes, 32x32: the loss, the LR, the pseudo-labels
    and every SGD part's update; the teacher unchanged."""
    name, nc, side = "deeplab_resnet18", 3, 32
    cfg = port_cfg(name, nc)
    batch = _batch(2, side, nc)
    student = _segmentor(cfg, 10)
    teacher = _sharpen(_teacher(cfg), _nchw(batch["image"]))
    jseg, template, jstate, tvars, jstep = _jax_side(name, nc, side, student, teacher,
                                                     threshold)
    start = _flat({n: m.params for n, m in jstate.modules.items()})
    jnew, jmetrics = jstep(jstate, {"image": jnp.asarray(batch["image"])}, jnp.float32(0))
    ref = _flat({n: m.params for n, m in jnew.modules.items()})

    with torch.no_grad():
        got = pseudo_labels(teacher_logits(teacher, _nchw(batch["image"])), threshold)
    want = _assert_pseudo_labels_match(got, _jax_teacher_logits(jseg, tvars, batch["image"]),
                                       threshold)
    if threshold:
        assert 0.2 < (want == 255).mean() < 0.8
    assert len(set(np.unique(want)) - {255}) == nc

    before = _state_dicts(teacher)
    metrics = _port_step(cfg, student, teacher, batch, threshold)
    assert abs(metrics["loss"] - float(jmetrics["loss"])) <= 1e-5 * abs(float(jmetrics["loss"]))
    assert metrics["lr"] == pytest.approx(float(jmetrics["lr"]), rel=1e-6)
    tree = deeplab_flax_from_state_dicts(_state_dicts(student), template)
    got_params = _flat({n: t["params"] for n, t in tree.items()})
    assert set(got_params) == set(ref)
    for key, r in ref.items():
        want_d, have_d = r - start[key], got_params[key] - start[key]
        assert np.abs(want_d).max() > 0, key
        err, scale = np.abs(have_d - want_d).max(), np.abs(want_d).max()
        ulp = 1.2e-7 * np.abs(r).max()
        assert err <= 2e-3 * scale + ulp, f"{key}: {err} > 2e-3 x {scale} + {ulp}"
    for part, sd in _state_dicts(teacher).items():
        for key, value in sd.items():
            assert torch.equal(value, before[part][key]), key


@pytest.mark.parametrize("name,side", [("attn_efficientnet-b0", 64),
                                       ("pranet_res2net50", 64)])
def test_attn_and_pranet_online_steps_match_the_jax_step(name, side):
    """One step of each at 64x64 with two images (drop-connect off on both
    sides): the loss and the LR; pranet's pseudo-labels are binary, both
    classes present, as the JAX branch's ``p >= 0.5``."""
    nc = 2
    cfg = port_cfg(name, nc)
    batch = _batch(2, side, nc)
    student = _segmentor(cfg, 10, drop_connect=False)
    teacher = _teacher(cfg)
    jseg, _, jstate, tvars, jstep = _jax_side(name, nc, side, student, teacher, 0.0)
    _, jmetrics = jstep(jstate, {"image": jnp.asarray(batch["image"])}, jnp.float32(0))
    with torch.no_grad():
        got = pseudo_labels(teacher_logits(teacher, _nchw(batch["image"])))
    want = _assert_pseudo_labels_match(got, _jax_teacher_logits(jseg, tvars, batch["image"]))
    assert set(np.unique(want)) == set(got.unique().tolist()) == {0, 1}
    if name == "pranet_res2net50":
        exact = _segmentor(cfg, 10).double()
        with torch.no_grad():
            outputs, _ = exact(_nchw(batch["image"]).double(), train=True)
            loss64 = make_family_loss(exact.spec, nc)(outputs, got).item()
    metrics = _port_step(cfg, student, teacher, batch, 0.0)
    assert np.isfinite(metrics["loss"])
    ref = float(jmetrics["loss"])
    assert abs(metrics["loss"] - ref) <= LOSS_TOL[name] * abs(ref)
    if name == "pranet_res2net50":
        assert abs(metrics["loss"] - loss64) <= PRANET_FLOAT64_TOL * abs(loss64)
    assert metrics["lr"] == pytest.approx(float(jmetrics["lr"]), rel=1e-6)


@pytest.mark.parametrize("name", ["pranet_res2net50", "attn_efficientnet-b0",
                                  "attnwrap_efficientnet-b0"])
def test_a_threshold_on_a_family_without_an_ignore_label_raises(name):
    cfg = port_cfg(name, 2)
    student = _segmentor(cfg, 10)
    state = TrainState(optimizers=make_optimizers(student.spec, cfg))
    with pytest.raises(ValueError, match=name.split("_")[0]):
        make_online_distill_step(student, cfg, STEPS_PER_EPOCH, state, student,
                                 confidence_threshold=0.5)


def test_the_online_step_takes_no_clamp_and_no_micro_batches():
    """The JAX online step has no gradient clamp (pranet's 0.5 included) and
    reads neither SOLVER.GRAD_CLIP nor SOLVER.ACCUM_STEPS: the port's online
    step leaves the gradients as they came and the batch whole."""
    cfg = port_cfg("deeplab_resnet18", 3, "SOLVER.GRAD_CLIP", "1e-9",
                   "SOLVER.ACCUM_STEPS", "2")
    batch = _batch(2, 32, 3)
    student, teacher = _segmentor(cfg, 10), _teacher(cfg)
    seen = []
    hook = student.parts["classifier"].register_forward_hook(
        lambda m, a, o: seen.append(a[0].shape[0]))
    _port_step(cfg, student, teacher, batch, 0.0)
    hook.remove()
    assert seen == [2]
    grads = [p.grad.abs().max().item() for p in student.parameters() if p.grad is not None]
    assert max(grads) > 1e-6


def test_step_seeds_draw_apart_on_the_cpu():
    """The CPU generator keeps only the low 32 bits of a seed: a step seed
    must vary there with the seed as well as with the step, or every
    ``SEED`` (the source step's SEED + 1, FADA's SEED + 3, the device
    augmenter's DATA_PIPE.SEED) draws the same drop-connect masks."""
    def draws(seed):
        return torch.rand(8, generator=torch.Generator().manual_seed(seed))

    for step in (0, 1, 7):
        for a, b in ((1, 2), (1, 3), (0, 7919)):
            assert not torch.equal(draws(step_seed(a, step)), draws(step_seed(b, step)))
        assert not torch.equal(draws(step_seed(1, step)), draws(step_seed(1, step + 1)))
    assert step_seed(1, 3) == step_seed(1, 3) and 0 <= step_seed(5, 2) < 2 ** 64


# -- GALD, in the port alone ---------------------------------------------------------------

def test_gald_online_step_trains_the_attention_and_keeps_the_teacher():
    """gald_hardnet68 at 224x224, two images, 3 classes: the teacher's labels
    come from its last head (out2, at the image's size); the loss is finite,
    the student's criss-cross attention receives gradients and moves, the
    teacher stays bit-equal."""
    cfg = port_cfg("gald_hardnet68", 3, "MODEL.FREEZE_BN", "False")
    batch = _batch(2, 224, 3)
    student, teacher = _segmentor(cfg, 10), _teacher(cfg)
    before_teacher = _state_dicts(teacher)
    attention = {n: p.detach().clone() for n, p in student.named_parameters()
                 if n.endswith(("query_conv.weight", "key_conv.weight", "value_conv.weight",
                                "gamma"))}
    assert attention
    labels = []
    real = distill.pseudo_labels

    def spy(logits, *args):
        out = real(logits, *args)
        labels.append((tuple(logits.shape), out))
        return out

    distill.pseudo_labels = spy
    try:
        metrics = _port_step(cfg, student, teacher, batch, 0.0)
    finally:
        distill.pseudo_labels = real
    assert np.isfinite(metrics["loss"]) and labels[0][0] == (2, 3, 224, 224)
    with torch.no_grad():
        outs, _ = teacher(_nchw(batch["image"]))
    assert torch.equal(labels[0][1], torch.argmax(torch.softmax(outs[-1], 1), 1).int())
    params = dict(student.named_parameters())
    for n, value in attention.items():
        assert params[n].grad is not None and params[n].grad.abs().max() > 0, n
        assert not torch.equal(params[n].detach(), value), n
    for part, sd in _state_dicts(teacher).items():
        for key, value in sd.items():
            assert torch.equal(value, before_teacher[part][key]), key


# -- the CLI -------------------------------------------------------------------------------

def _cli_opts(config, out_dir, *more):
    return ["-cfg", os.path.join(REPO, "configs", config), "MODEL.DEVICE", "cpu",
            "MODEL.NAME", "deeplab_resnet18", "MODEL.NUM_CLASSES", "3",
            "DATASETS.SOURCE_TRAIN", "synthetic_train", "DATASETS.TARGET_TRAIN",
            "synthetic_shift_train", "DATASETS.SYNTHETIC_LENGTH", "4",
            "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(32, 32)", "INPUT.TARGET_INPUT_SIZE_TRAIN",
            "(32, 32)", "SOLVER.BATCH_SIZE", "2", "SOLVER.EPOCHS", "1",
            "SOLVER.CHECKPOINT_PERIOD", "1", "DATA_PIPE.NUM_WORKERS", "1",
            "OUTPUT_DIR", str(out_dir), *more]


def _run_cli(module, argv):
    saved = sys.argv
    sys.argv = [module.__name__] + argv
    try:
        return module.cli()
    finally:
        sys.argv = saved


@pytest.fixture(scope="module")
def teachers(tmp_path_factory):
    """A source checkpoint (``cli.train_src``) and a FADA one (``cli.train_adv``)."""
    root = tmp_path_factory.mktemp("teachers")
    _run_cli(train_src, _cli_opts("deeplabv2_r101_src.yaml", root / "src"))
    _run_cli(train_adv, _cli_opts("deeplabv2_r101_adv.yaml", root / "fada",
                                  "SOLVER.BATCH_SIZE", "4"))
    return {"src": root / "src" / "Aspp-1.pth", "fada": root / "fada" / "AsppFada-1.pth"}


def test_cli_distills_online_from_a_source_checkpoint(teachers, tmp_path):
    out = tmp_path / "student"
    _run_cli(train_distill, _cli_opts(
        "deeplabv2_r101_tgt_self_distill.yaml", out, "INPUT.INPUT_SCALES_TRAIN", "(1, 1)",
        "DISTILL.ONLINE", "True", "DISTILL.TEACHER", str(teachers["src"]),
        "DISTILL.CONFIDENCE_THRESHOLD", "0.5"))
    chart = json.loads((out / "deeplab_chart_params.json").read_text())
    assert len(chart["loss"]) == 2 and np.isfinite(chart["loss"]).all()
    ckpt = torch.load(out / "Aspp-1.pth", map_location="cpu", weights_only=True)
    assert (ckpt["epoch"], ckpt["step"]) == (1, 2)


def test_a_fada_checkpoint_teaches_and_stays_unchanged(teachers, tmp_path, monkeypatch):
    """``{Prefix}Fada-N.pth`` as the teacher: its segmentor parts load (D is
    left out), it labels every batch, and after the run the teacher still
    equals the file."""
    cfg = load_cfg(train_distill.build_parser().parse_args(_cli_opts(
        "deeplabv2_r101_tgt_self_distill.yaml", tmp_path, "INPUT.INPUT_SCALES_TRAIN",
        "(1, 1)", "DISTILL.ONLINE", "True", "DISTILL.TEACHER", str(teachers["fada"]))))
    trainer = train_distill.make_online_trainer("deeplab_distill", cfg)
    ckpt = torch.load(teachers["fada"], map_location="cpu", weights_only=True)
    assert "model_D" in ckpt and not trainer.teacher.training
    assert not any(p.requires_grad for p in trainer.teacher.parameters())
    calls = []
    real = distill.pseudo_labels
    monkeypatch.setattr(distill, "pseudo_labels",
                        lambda *a: (calls.append(a[0].shape), real(*a))[1])
    trainer.train()
    assert len(calls) == 2 and trainer.state.step == 2
    for part in ("feature_extractor", "classifier"):
        # the FADA config's FrozenBN buffers fill the distill config's
        # BatchNorms, whose counters the file does not hold
        assert set(trainer.teacher.parts[part].state_dict()) - set(ckpt[part]) <= {
            k for k in trainer.teacher.parts[part].state_dict() if "num_batches" in k}
        for key, value in ckpt[part].items():
            assert torch.equal(trainer.teacher.parts[part].state_dict()[key], value), key
    student = trainer.segmentor.parts["classifier"].state_dict()
    assert any(not torch.equal(v, ckpt["classifier"][k]) for k, v in student.items())


def test_an_orbax_teacher_raises(tmp_path):
    orbax = tmp_path / "Aspp-1"
    orbax.mkdir()
    cfg = load_cfg(train_distill.build_parser().parse_args(_cli_opts(
        "deeplabv2_r101_tgt_self_distill.yaml", tmp_path, "DISTILL.ONLINE", "True",
        "DISTILL.TEACHER", str(orbax))))
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        train_distill.main("deeplab_distill", cfg)
    with pytest.raises(ValueError, match="DISTILL.TEACHER"):
        train_distill.make_online_trainer("deeplab_distill", _without_teacher(cfg))


def _without_teacher(cfg):
    cfg = cfg.clone()
    cfg.defrost()
    cfg.DISTILL.TEACHER = ""
    return cfg
