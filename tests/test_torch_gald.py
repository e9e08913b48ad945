"""The port's GALD slice (HarDNet68 + GCPA-CC + the gald probability head)
against the JAX package's, on the CPU in float32.

Weights start as JAX-initialised variables, randomised with numpy (conv
kernels at variance 1.7/fan_in so logits are O(1-10), nonzero biases and BN
affines, random BN running statistics, and the criss-cross ``gamma`` at 0.7:
at its init value 0 the attention would contribute nothing and an error in
it would stay hidden).  They reach the port through
``gald_state_dicts_from_flax``, which must invert the JAX package's
``convert_state_dict`` exactly.  A second check goes the other way: the
port's own seeded weights, written as a reference-layout ``.pth``, loaded by
the JAX ``Tester`` through ``resume``.

Tolerances are relative to the largest magnitude of the reference tensor:
float32 sums over up to 5,760 products (3x3x640) in other orders than XLA's
differ by about 1e-6 of the magnitude per layer, and HarDNet68 stacks 68 of
them.  Module outputs: 2e-5 of the magnitude.  HarDNet taps: 1e-4.  The
probabilities: 1e-4 absolute, as the head's softmax bounds them to [0, 1].
Argmax must agree on every pixel whose top-2 probability gap in the JAX
result exceeds twice that tolerance — closer pairs are ties at this precision.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnd_semantic_segmentation_tpu.ckpt import torch_import as TI
from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.eval.tester import Tester as JaxTester
from rnd_semantic_segmentation_tpu.models.build import build_segmentor as jax_build
from rnd_semantic_segmentation_tpu.models.gcpa import (
    FAM as JaxFAM,
    CrissCrossAttention as JaxCC,
    LocalAttenModule as JaxLocalAtten,
)
from rnd_semantic_segmentation_tpu.train.segmentor import Segmentor as JaxSegmentor

from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    gald_state_dicts_from_flax,
    load_part,
    save_reference_checkpoint,
)
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.eval.tester import Tester
from rnd_semantic_segmentation_torch.models.build import randomize_weights_

torch.set_num_threads(2)  # six test workers share the host's cores

SIZE = 224  # the smallest input GALD takes (the /32 map must survive two VALID stride-2 convs)
NC = 3
PROB_TOL = 1e-4


def jax_cfg(**kv):
    cfg = jax_default_cfg()
    cfg.MODEL.NAME = "gald_hardnet68"
    cfg.MODEL.NUM_CLASSES = NC
    for k, v in kv.items():
        setattr(cfg, k, v)
    return cfg


def port_cfg(*opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", "gald_hardnet68", "MODEL.NUM_CLASSES", str(NC),
                         "MODEL.DEVICE", "cpu", *opts])
    return cfg


class _OneBatch:
    def __init__(self, x):
        self.batch = {"image": x, "label": np.zeros(x.shape[:3], np.int32), "name": ["g"]}
        self.batch_size = x.shape[0]

    def __iter__(self):
        yield self.batch


def _randomise(path, leaf, rng):
    a = np.asarray(leaf)
    name = path[-1].key
    if name == "kernel":
        return (rng.randn(*a.shape) * np.sqrt(1.7 / np.prod(a.shape[:-1]))).astype(np.float32)
    lo, hi = {"bias": (-0.1, 0.1), "scale": (0.5, 1.5), "mean": (-0.2, 0.2),
              "var": (0.5, 1.5), "gamma": (0.7, 0.7)}[name]
    return rng.uniform(lo, hi, a.shape).astype(np.float32)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).rand(2, SIZE, SIZE, 3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_variables(images):
    seg = JaxSegmentor(jax_build(jax_cfg()), NC)
    init = jax.jit(seg.init)(jax.random.PRNGKey(0), jnp.asarray(images[:1]))
    rng = np.random.RandomState(1)
    return jax.tree_util.tree_map_with_path(lambda p, l: _randomise(p, l, rng),
                                            jax.tree.map(np.asarray, init))


@pytest.fixture(scope="module")
def jax_tester(images, tmp_path_factory):
    """One JAX ``Tester`` for the module: its ``_probs`` is jitted per
    instance, so each new Tester would trace and compile the forward again."""
    return JaxTester(jax_cfg(OUTPUT_DIR=str(tmp_path_factory.mktemp("jax_gald"))),
                     _OneBatch(images), logging.getLogger("jax_gald"))


@pytest.fixture(scope="module")
def port_tester(jax_variables):
    tester = Tester(port_cfg(), logging.getLogger("torch_gald"))
    sds = gald_state_dicts_from_flax(jax_variables)
    for name, module in tester.spec.modules.items():
        load_part(module, sds[name], name)
    return tester


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _assert_close_to_max(out, ref, rel):
    ref = np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all()
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, f"max abs error {err} > {rel} x {scale}"


def _assert_probs_agree(probs, ref):
    ref = np.asarray(ref)
    assert probs.shape == ref.shape
    err = np.abs(probs - ref).max()
    assert err <= PROB_TOL, f"probability error {err} > {PROB_TOL}"
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * PROB_TOL
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(probs.argmax(-1)[clear], ref.argmax(-1)[clear])


def test_weight_transfer_round_trips_exactly(jax_variables):
    sds = gald_state_dicts_from_flax(jax_variables)
    back = {
        "encoder": TI.convert_state_dict({k: v.numpy() for k, v in sds["encoder"].items()},
                                         TI.GCPA_ENCODER_RULES),
        "decoder": TI.convert_state_dict({k: v.numpy() for k, v in sds["decoder"].items()},
                                         TI.GCPA_DECODER_RULES),
    }
    want = jax.tree_util.tree_flatten_with_path(jax_variables)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        assert got[path].dtype == leaf.dtype and got[path].shape == leaf.shape, path
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))
    assert sds["decoder"]["long_relation.gamma"].shape == (1,)
    assert "hardnet.base.3.layers.3.conv.weight" in sds["encoder"]  # first HarDBlock
    for key in ("conva.0.weight", "local_attention_4.dconv1.0.weight",
                "fam45.conv0.weight", "linear2.weight"):
        assert key in sds["decoder"]


def test_port_state_dict_keys_are_the_reference_keys(jax_variables, port_tester):
    sds = gald_state_dicts_from_flax(jax_variables)
    for name, module in port_tester.spec.modules.items():
        assert set(module.state_dict()) == set(sds[name])


def test_criss_cross_attention_module(jax_variables, port_tester):
    x = np.random.RandomState(2).randn(2, 9, 13, 256).astype(np.float32)
    p = jax_variables["decoder"]["params"]["long_relation"]
    assert np.all(p["gamma"] == np.float32(0.7))
    ref = JaxCC().apply({"params": p}, jnp.asarray(x))
    with torch.no_grad():
        out = port_tester.segmentor.parts["decoder"].long_relation(_nchw(x))
    _assert_close_to_max(_nhwc(out), ref, 2e-5)


def test_local_atten_module(jax_variables, port_tester):
    x = np.random.RandomState(3).randn(2, 15, 17, 256).astype(np.float32)
    v = {c: jax_variables["decoder"][c]["local_attention_4"]
         for c in ("params", "batch_stats")}
    ref = JaxLocalAtten().apply(v, jnp.asarray(x))
    with torch.no_grad():
        out = port_tester.segmentor.parts["decoder"].local_attention_4(_nchw(x))
    _assert_close_to_max(_nhwc(out), ref, 2e-5)


def test_fam_module(jax_variables, port_tester):
    rng = np.random.RandomState(4)
    left = rng.randn(2, 14, 14, 640).astype(np.float32)
    down = rng.randn(2, 7, 7, 256).astype(np.float32)
    right = rng.randn(2, 7, 7, 256).astype(np.float32)
    v = {c: jax_variables["decoder"][c]["fam45"] for c in ("params", "batch_stats")}
    ref = JaxFAM(256).apply(v, *(jnp.asarray(a) for a in (left, down, right)))
    with torch.no_grad():
        out = port_tester.segmentor.parts["decoder"].fam45(_nchw(left), _nchw(down),
                                                           _nchw(right))
    _assert_close_to_max(_nhwc(out), ref, 2e-5)


def test_hardnet68_taps(jax_variables, port_tester, images):
    enc = jax_build(jax_cfg()).modules["encoder"]
    ref = jax.jit(enc.apply)(jax_variables["encoder"], jnp.asarray(images))
    with torch.no_grad():
        taps = port_tester.segmentor.parts["encoder"](_nchw(images))
    assert [t.shape[1] for t in taps] == [128, 320, 640, 1024]
    for t, r in zip(taps, ref):
        _assert_close_to_max(_nhwc(t), r, 1e-4)


def test_whole_slice_probabilities(jax_variables, port_tester, images, jax_tester):
    ref = jax_tester._probs(jax_variables, jnp.asarray(images), (SIZE, SIZE))
    probs = port_tester._probs_impl(_nchw(images), (SIZE, SIZE))
    assert probs.shape == (2, NC, SIZE, SIZE)
    _assert_probs_agree(_nhwc(probs), ref)


def test_same_pth_in_both_packages(images, tmp_path, jax_tester):
    cfg = port_cfg("resume", str(tmp_path / "Gald-seeded.pth"))
    seeded = Tester(cfg, logging.getLogger("torch_gald"))
    randomize_weights_(seeded.segmentor, seed=5)
    save_reference_checkpoint(seeded.spec.modules, cfg.resume)

    port = Tester(cfg, logging.getLogger("torch_gald"))
    port._load_checkpoint()
    probs = port._probs_impl(_nchw(images), (SIZE, SIZE))

    jt = JaxTester(jax_cfg(OUTPUT_DIR=str(tmp_path), resume=cfg.resume),
                   _OneBatch(images), logging.getLogger("jax_gald"))
    jt._load_checkpoint()
    ref = jax_tester._probs(jt.variables, jnp.asarray(images), (SIZE, SIZE))
    _assert_probs_agree(_nhwc(probs), ref)
