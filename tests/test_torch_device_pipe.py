"""The port's device-side augmentation (data/device_pipe.py), the host's share
under DATA_PIPE.DEVICE_AUG (``Augmenter._device_stub``) and the trainers'
hook, against the JAX package's, on the CPU.

The port draws its random numbers from a ``torch.Generator`` and the JAX
package from ``jax.random`` keys, so the draws agree in distribution only.
The arithmetic is held exactly: these tests compute the draws the JAX
function makes from its key and hand them to the port's apply functions.
``_jax_pra_draws``, ``_jax_attn_draws`` and ``_jax_aspp_draws`` mirror the
key splits of the JAX package's data/device_pipe.py at lines 192-196 (pra),
223-237 (attn) and 268-274 (aspp), and ``_jax_jitter_draws`` mirrors
``_color_jitter``'s own draws at lines 52-69.

Tolerances: flips, rot90, the label of every op and the host stub: exact;
the blur, the rotation and the jitter: 2e-6 absolute on [0, 1] images
(float32 sums in XLA's order against torch's); aspp's bilinear resize and
normalisation: 1e-5 (the JAX resize is a matrix product).
"""

import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.data import device_pipe as jdp
from rnd_semantic_segmentation_tpu.data.augment import Augmenter as JaxAugmenter
from rnd_semantic_segmentation_tpu.data.catalog import build_dataset as jax_build_dataset
from rnd_semantic_segmentation_tpu.data.loader import DataLoader as JaxDataLoader

from rnd_semantic_segmentation_torch.cli import train_adv, train_src
from rnd_semantic_segmentation_torch.cli.common import load_cfg
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.data import DataLoader, build_dataset, trees
from rnd_semantic_segmentation_torch.data import device_pipe as dp
from rnd_semantic_segmentation_torch.data.augment import Augmenter
from rnd_semantic_segmentation_torch.utils.seeding import mix_seed

torch.set_num_threads(2)  # six test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-6
B = 6


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(h, w, seed=0, classes=3):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, h, w, 3).astype(np.float32),
            rng.randint(0, classes, (B, h, w)).astype(np.int32))


def _jax_jitter_draws(keys, b, brightness, contrast, saturation, hue):
    """device_pipe.py:52-69: one key a knob, in this order."""
    out = {}
    for key, name, v in ((keys[0], "brightness", brightness), (keys[1], "contrast", contrast),
                         (keys[2], "saturation", saturation)):
        if v > 0:
            out[name] = _t(jax.random.uniform(key, (b, 1, 1, 1), minval=max(0, 1 - v),
                                              maxval=1 + v))
    if hue > 0:
        out["hue"] = _t(jax.random.uniform(keys[3], (b, 1, 1), minval=-hue, maxval=hue))
    return out


def _jax_pra_draws(rng, b):
    """device_pipe.py:192-196."""
    keys = jax.random.split(rng, 6)
    return {"rot_k": _t(jax.random.randint(keys[0], (b,), 0, 4)),
            "flip_code": _t(jax.random.randint(keys[1], (b,), 0, 4)),
            "jitter": _jax_jitter_draws(keys[2:6], b, 0.2, 0.2, 0.2, 0.1)}


def _jax_attn_draws(rng, b, prob=0.7, blur_prob=0.7, rotate_prob=0.7, jitter_prob=0.7,
                    flip_prob=0.7):
    """device_pipe.py:223-237, with _motion_blur_batch's split (:108-111)."""
    keys = jax.random.split(rng, 9)
    kd, kk = jax.random.split(keys[2])
    return {"apply": _t(jax.random.bernoulli(keys[0], prob, (b,))),
            "blur": _t(jax.random.bernoulli(keys[1], blur_prob, (b,))),
            "blur_direction": _t(jax.random.randint(kd, (b,), 0, 4)),
            "blur_size": _t(jax.random.randint(kk, (b,), 0, 3)),
            "rotate": _t(jax.random.bernoulli(keys[3], rotate_prob, (b,))),
            "angle": _t(jax.random.uniform(keys[4], (b,), minval=-jnp.pi / 2,
                                           maxval=jnp.pi / 2)),
            "jitter_on": _t(jax.random.bernoulli(keys[5], jitter_prob, (b,))),
            "jitter": _jax_jitter_draws(jax.random.split(keys[6], 4), b, 0.2, 0.2, 0.2, 0.2),
            "flip": _t(jax.random.bernoulli(keys[7], flip_prob, (b,))),
            "flip_code": _t(jax.random.randint(keys[8], (b,), 0, 3))}


def _jax_aspp_draws(rng, b, flip_prob, jitter):
    """device_pipe.py:268-274."""
    keys = jax.random.split(rng, 5)
    out = {"jitter": _jax_jitter_draws(keys[1:5], b, *jitter)}
    if flip_prob > 0:
        out["flip"] = _t(jax.random.bernoulli(keys[0], flip_prob, (b, 1, 1, 1)))
    return out


def _close(got, ref, atol=ATOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def _equal(got, ref):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


# -- each helper with the JAX function's draws ---------------------------------------

@pytest.mark.parametrize("knobs", [(0.5, 0.0, 0.0, 0.0), (0.0, 0.5, 0.0, 0.0),
                                   (0.0, 0.0, 0.5, 0.0), (0.0, 0.0, 0.0, 0.2),
                                   (0.2, 0.2, 0.2, 0.1)], ids=str)
def test_color_jitter_matches_the_jax_function(knobs):
    x, _ = _batch(9, 11)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    ref = jdp._color_jitter(jnp.asarray(x), keys, *knobs)
    got = dp.color_jitter(_t(x), _jax_jitter_draws(keys, B, *knobs))
    _close(got, ref)


def test_flip_select_matches_the_jax_function():
    x, y = _batch(5, 7)
    code = np.array([0, 1, 2, 0, 1, 2], np.int32)
    active = np.array([True, True, True, False, False, True])
    rx, ry = jdp._flip_select(jnp.asarray(x), jnp.asarray(y), jnp.asarray(code),
                              jnp.asarray(active))
    gx, gy = dp.flip_select(_t(x), _t(y), _t(code), _t(active))
    _equal(gx, rx)
    _equal(gy, ry)


def test_rot90_select_matches_the_jax_function():
    x, y = _batch(8, 8)
    k = np.array([0, 1, 2, 3, 1, 3], np.int32)
    rx, ry = jdp._rot90_select(jnp.asarray(x), jnp.asarray(y), jnp.asarray(k))
    gx, gy = dp.rot90_select(_t(x), _t(y), _t(k))
    _equal(gx, rx)
    _equal(gy, ry)


def test_motion_blur_matches_the_jax_function():
    x, _ = _batch(10, 12)
    key = jax.random.PRNGKey(5)
    active = np.array([True, True, False, True, True, True])
    ref = jdp._motion_blur_batch(jnp.asarray(x), key, jnp.asarray(active))
    kd, kk = jax.random.split(key)
    got = dp.motion_blur(_t(x), _t(jax.random.randint(kd, (B,), 0, 4)),
                         _t(jax.random.randint(kk, (B,), 0, 3)), _t(active))
    _close(got, ref)


@pytest.mark.parametrize("hw", [(12, 12), (9, 14)], ids=str)
def test_rotate_matches_the_jax_function(hw):
    x, y = _batch(*hw)
    theta = np.array([0.3, -1.2, 1.5707, -0.01, 0.9, 2.0], np.float32)
    active = np.array([True, True, True, True, False, True])
    rx, ry = jdp._rotate_batch(jnp.asarray(x), jnp.asarray(y), jnp.asarray(theta),
                               jnp.asarray(active))
    gx, gy = dp.rotate(_t(x), _t(y), _t(theta), _t(active))
    _close(gx, rx)
    _equal(gy, ry)
    assert (gy.numpy()[:4] == 0).any()  # fill 0 for the label too, not 255


# -- each pipeline with the JAX function's draws -------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_batch_pra_matches_the_jax_pipeline(seed):
    x, y = _batch(16, 16, seed=seed, classes=2)
    rng = jax.random.PRNGKey(seed)
    ref = jdp.augment_batch_pra(jnp.asarray(x), jnp.asarray(y), rng, dtype="float32")
    got = dp.augment_batch_pra(_t(x), _t(y), _jax_pra_draws(rng, B))
    _close(got["image"], ref["image"], atol=1e-5)
    _equal(got["label"], ref["label"])
    with pytest.raises(ValueError, match="square"):
        dp.augment_batch_pra(_t(x[:, :8]), _t(y[:, :8]), _jax_pra_draws(rng, B))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_batch_attn_matches_the_jax_pipeline(seed):
    x, y = _batch(14, 10, seed=seed, classes=2)
    rng = jax.random.PRNGKey(seed)
    ref = jdp.augment_batch_attn(jnp.asarray(x), jnp.asarray(y), rng, dtype="float32")
    draws = _jax_attn_draws(rng, B)
    got = dp.augment_batch_attn(_t(x), _t(y), draws)
    _close(got["image"], ref["image"])
    _equal(got["label"], ref["label"])
    assert 0 <= got["image"].min() and got["image"].max() <= 1


@pytest.mark.parametrize("case", [
    dict(size=(12, 20), flip_prob=0.5, jitter=(0.5, 0.5, 0.5, 0.2), to_bgr255=False),
    dict(size=(40, 24), flip_prob=0.0, jitter=(0.3, 0.0, 0.0, 0.0), to_bgr255=True),
    dict(size=None, flip_prob=0.5, jitter=(0.0, 0.0, 0.0, 0.0), to_bgr255=False),
], ids=["down", "up_bgr255", "same_size"])
def test_augment_batch_matches_the_jax_pipeline(case):
    x, y = _batch(18, 30, seed=4, classes=19)
    rng = jax.random.PRNGKey(7)
    mean, std = ((102.9801, 115.9465, 122.7717), (1.0, 1.0, 1.0)) if case["to_bgr255"] \
        else (dp.IMAGENET_MEAN, dp.IMAGENET_STD)
    b, c, s, h = case["jitter"]
    ref = jdp.augment_batch(jnp.asarray(x), jnp.asarray(y), rng, size=case["size"],
                            flip_prob=case["flip_prob"], brightness=b, contrast=c,
                            saturation=s, hue=h, mean=mean, std=std, dtype="float32",
                            to_bgr255=case["to_bgr255"])
    draws = _jax_aspp_draws(rng, B, case["flip_prob"], case["jitter"])
    got = dp.augment_batch(_t(x), _t(y), draws, size=case["size"], mean=mean, std=std,
                           to_bgr255=case["to_bgr255"])
    scale = 255.0 if case["to_bgr255"] else 1 / 0.224
    _close(got["image"], ref["image"], atol=1e-5 * scale)
    _equal(got["label"], ref["label"])


# -- the augmenter: dispatch, sizes, dtype, seeds ------------------------------------

def _cfg(*opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.DEVICE", "cpu", "MODEL.DTYPE", "bfloat16", *opts])
    return cfg


def _torch_batch(h, w, classes=2, seed=0):
    x, y = _batch(h, w, seed=seed, classes=classes)
    return {"image": _t(x), "label": _t(y), "name": [str(i) for i in range(B)]}


def test_make_device_augmenter_dispatches_on_aug_name():
    batch = _torch_batch(16, 16)
    pra = dp.make_device_augmenter(_cfg("AUG.NAME", "pra"))(batch, 3)
    gen = torch.Generator().manual_seed(mix_seed(0, 3))
    ref = dp.augment_batch_pra(batch["image"], batch["label"], dp.draw_pra(gen, B),
                               torch.bfloat16)
    assert torch.equal(pra["image"], ref["image"]) and pra["image"].min() < -1
    attn = dp.make_device_augmenter(_cfg("AUG.NAME", "attn", "AUG.PROB", "1.0"))(batch, 3)
    assert 0 <= attn["image"].min() and attn["image"].max() <= 1
    assert not torch.equal(attn["image"], batch["image"])
    for name in ("aspp", "gald", "none"):
        out = dp.make_device_augmenter(_cfg("AUG.NAME", name, "INPUT.SOURCE_INPUT_SIZE_TRAIN",
                                            "(24, 8)"))(batch, 3)
        assert out["image"].shape == (B, 8, 24, 3) and out["label"].shape == (B, 8, 24)
    for out in (pra, attn, out):
        # the image in MODEL.DTYPE; the label's type and the names kept
        assert out["image"].dtype == torch.bfloat16 and out["label"].dtype == torch.int32
        assert out["name"] == batch["name"]


def test_a_fada_target_takes_its_size_and_no_jitter():
    # float32 out, so that the normalisation inverts to float32 rounding
    cfg = _cfg("AUG.NAME", "aspp", "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(20, 12)",
               "INPUT.TARGET_INPUT_SIZE_TRAIN", "(16, 16)", "INPUT.BRIGHTNESS", "0.9",
               "INPUT.CONTRAST", "0.9", "MODEL.DTYPE", "float32")
    batch = _torch_batch(16, 16)
    tgt = dp.make_device_augmenter(cfg, is_source=False)(batch, 0)
    mean, std = torch.tensor(cfg.INPUT.PIXEL_MEAN), torch.tensor(cfg.INPUT.PIXEL_STD)
    # no flip (probability 0), no jitter: the normalisation alone, invertible
    torch.testing.assert_close(tgt["image"] * std + mean, batch["image"], rtol=0, atol=1e-6)
    src = dp.make_device_augmenter(cfg, is_source=True)(batch, 0)
    assert src["image"].shape == (B, 12, 20, 3)
    src_same = dp.make_device_augmenter(
        _cfg("AUG.NAME", "aspp", "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(16, 16)",
             "INPUT.BRIGHTNESS", "0.9", "INPUT.CONTRAST", "0.9", "MODEL.DTYPE", "float32"),
        is_source=True)(batch, 0)
    assert (src_same["image"] * std + mean - batch["image"]).abs().max() > 0.05


def test_draws_repeat_for_a_step_and_differ_across_steps_and_streams():
    cfg = _cfg("AUG.NAME", "attn", "AUG.PROB", "1.0")
    batch = _torch_batch(12, 12)
    src, tgt = dp.make_device_augmenter(cfg), dp.make_device_augmenter(cfg, is_source=False)
    again = dp.make_device_augmenter(cfg)
    a, b = src(batch, 5), again(batch, 5)
    assert torch.equal(a["image"], b["image"]) and torch.equal(a["label"], b["label"])
    assert not torch.equal(src(batch, 6)["image"], a["image"])
    assert not torch.equal(tgt(batch, 5)["image"], a["image"])
    seeded = dp.make_device_augmenter(_cfg("AUG.NAME", "attn", "AUG.PROB", "1.0",
                                           "DATA_PIPE.SEED", "1"))
    assert not torch.equal(seeded(batch, 5)["image"], a["image"])
    assert mix_seed(0, 5) != mix_seed(dp.TARGET_SEED_OFFSET, 5)


def test_draws_follow_their_distributions():
    """The port's draws are not the JAX package's: hold their ranges and
    rates instead, over 4000 images."""
    gen = torch.Generator().manual_seed(0)
    n = 4000
    attn = dp.draw_attn(gen, n, prob=0.7, blur_prob=0.5)
    assert abs(attn["apply"].float().mean() - 0.7) < 0.03
    assert abs(attn["blur"].float().mean() - 0.5) < 0.03
    assert set(attn["blur_direction"].tolist()) == {0, 1, 2, 3}
    assert set(attn["blur_size"].tolist()) == {0, 1, 2}
    assert set(attn["flip_code"].tolist()) == {0, 1, 2}
    assert attn["angle"].abs().max() <= np.pi / 2 and attn["angle"].std() > 0.8
    pra = dp.draw_pra(gen, n)
    assert set(pra["rot_k"].tolist()) == set(pra["flip_code"].tolist()) == {0, 1, 2, 3}
    jit = pra["jitter"]
    assert 0.8 <= jit["brightness"].min() and jit["brightness"].max() <= 1.2
    assert -0.1 <= jit["hue"].min() and jit["hue"].max() <= 0.1
    assert jit["hue"].shape == (n, 1, 1) and jit["contrast"].shape == (n, 1, 1, 1)
    aspp = dp.draw_aspp(gen, n, flip_prob=0.25)
    assert aspp["flip"].shape == (n, 1, 1, 1) and abs(aspp["flip"].float().mean() - 0.25) < 0.03
    assert dp.draw_aspp(gen, n, flip_prob=0.0) == {"jitter": {}}


# -- the host's share ----------------------------------------------------------------

def _both_cfgs(*opts):
    out = []
    for make in (get_default_cfg, jax_default_cfg):
        cfg = make()
        cfg.merge_from_list(["DATA_PIPE.DEVICE_AUG", "True", "INPUT.TRAINSIZE", "24", *opts])
        out.append(cfg)
    return out


@pytest.mark.parametrize("opts", [
    ("AUG.NAME", "pra"),
    ("AUG.NAME", "aspp"),
    ("AUG.NAME", "aspp", "INPUT.INPUT_SCALES_TRAIN", "(0.5, 1.5)",
     "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(36, 28)"),
    ("AUG.NAME", "attn"),
    ("AUG.NAME", "gald"),
    ("AUG.NAME", "none"),
], ids=lambda o: "_".join(o[1::2]))
def test_host_stub_equals_the_jax_stub_under_one_seeded_random(opts):
    cfg, jcfg = _both_cfgs(*opts)
    rng = np.random.RandomState(0)
    for i in range(6):
        img = (rng.rand(30 + i, 40, 3) * 255).astype(np.uint8)
        lab = (rng.rand(30 + i, 40) > 0.5).astype(np.float32)
        random.seed(100 + i)
        got = Augmenter(cfg, "train").build_transform()(img, lab)
        random.seed(100 + i)
        ref = JaxAugmenter(jcfg, "train").build_transform()(img, lab)
        for g, r in zip(got, ref):
            g, r = np.asarray(g), np.asarray(r)
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)
    if opts[1] == "pra":
        assert got[0].dtype == np.uint8 and got[0].shape == (24, 24, 3)
    # test mode keeps the host's test transforms
    got = Augmenter(cfg, "test").build_transform()(img, lab)
    ref = JaxAugmenter(jcfg, "test").build_transform()(img, lab)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))


def test_the_stub_runs_in_forked_worker_processes_as_the_jax_workers(tmp_path):
    """polyp_train through the pra stub (crop draws from ``random``) in two
    worker processes: uint8 -> [0, 1] batches at TRAINSIZE, equal to the JAX
    workers' batches."""
    trees.write_dataset_trees(str(tmp_path), seed=6,
                              trees={"kvasir": (6, 1, ((240, 230), (260, 300)))})
    loaders = []
    for make, build, loader in ((get_default_cfg, build_dataset, DataLoader),
                                (jax_default_cfg, jax_build_dataset, JaxDataLoader)):
        cfg = make()
        cfg.merge_from_list(["DATASETS.DATASET_DIR", str(tmp_path), "DATASETS.SOURCE_TRAIN",
                             "polyp_train", "AUG.NAME", "pra", "INPUT.TRAINSIZE", "32",
                             "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(32, 32)",
                             "DATA_PIPE.DEVICE_AUG", "True"])
        loaders.append(loader(build(cfg, "train"), batch_size=2, shuffle=False,
                              worker_processes=2, seed=3))
    try:
        ours, theirs = (list(loader) for loader in loaders)
    finally:
        for loader in loaders:
            loader.close()
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a["image"].shape == (2, 32, 32, 3) and a["image"].dtype == np.float32
        assert 0 <= a["image"].min() and a["image"].max() <= 1
        for key in ("image", "label"):
            np.testing.assert_array_equal(a[key], b[key])


# -- the trainers' hook --------------------------------------------------------------

def test_device_aug_batches_go_through_trainer_and_fada_trainer(tmp_path):
    """One step of each trainer on synthetic data with DEVICE_AUG on: the
    batch the step sees is the augmenter's output for that iteration."""
    common = ["MODEL.DEVICE", "cpu", "MODEL.NAME", "deeplab_resnet18", "MODEL.NUM_CLASSES",
              "3", "DATASETS.SOURCE_TRAIN", "synthetic_train", "DATASETS.SYNTHETIC_LENGTH",
              "2", "SOLVER.BATCH_SIZE", "2", "SOLVER.EPOCHS", "1", "SOLVER.CHECKPOINT_PERIOD",
              "5", "DATA_PIPE.NUM_WORKERS", "1", "DATA_PIPE.DEVICE_AUG", "True",
              "INPUT.HORIZONTAL_FLIP_PROB_TRAIN", "0.5", "INPUT.BRIGHTNESS", "0.3"]
    cfg = load_cfg(train_src.build_parser().parse_args(
        ["-cfg", os.path.join(REPO, "configs", "deeplabv2_r101_src.yaml"), *common,
         "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(40, 32)", "OUTPUT_DIR", str(tmp_path / "src")]))
    trainer = train_src.make_trainer("deeplab", cfg)
    seen = []
    step = trainer.step_fn
    trainer.step_fn = lambda *a: (seen.append(a[:-1]), step(*a))[1]
    raw = next(trainer._batches(1))[0]
    trainer.train()
    assert trainer.state.step == 1 and len(seen) == 1
    (batch,) = seen[0]
    ref = dp.make_device_augmenter(cfg)(raw, 0)
    assert batch["image"].shape == (2, 32, 40, 3) and not torch.equal(batch["image"],
                                                                        raw["image"])
    assert torch.equal(batch["image"], ref["image"]) and torch.equal(batch["label"], ref["label"])

    cfg = load_cfg(train_adv.build_parser().parse_args(
        ["-cfg", os.path.join(REPO, "configs", "deeplabv2_r101_adv.yaml"), *common,
         "DATASETS.TARGET_TRAIN", "synthetic_shift_train", "SOLVER.BATCH_SIZE", "4",
         "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(40, 32)", "INPUT.TARGET_INPUT_SIZE_TRAIN",
         "(24, 16)", "OUTPUT_DIR", str(tmp_path / "fada")]))
    fada = train_adv.make_trainer("deeplab_fada", cfg)
    seen.clear()
    step = fada.step_fn
    fada.step_fn = lambda *a: (seen.append(a[:-1]), step(*a))[1]
    raw_src, raw_tgt = next(fada._batches(1))
    fada.train()
    assert fada.state.step == 1 and len(seen) == 1
    src, tgt = seen[0]
    ref_tgt = dp.make_device_augmenter(cfg, is_source=False)(raw_tgt, 0)
    assert src["image"].shape == (2, 32, 40, 3) and tgt["image"].shape == (2, 16, 24, 3)
    assert torch.equal(src["image"], dp.make_device_augmenter(cfg)(raw_src, 0)["image"])
    assert torch.equal(tgt["image"], ref_tgt["image"])
