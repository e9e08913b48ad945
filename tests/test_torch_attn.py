"""The port's attn family (EfficientNet encoder + attention-gated UNet decoder
+ the sigmoid probability head) against the JAX package's, on the CPU in
float32, at efficientnet-b0 and 64x64.

Weights start as JAX-initialised variables, randomised with numpy (conv
kernels at variance 1.7/fan_in, nonzero biases and BN affines, random BN
running statistics).  They reach the port through
``attn_state_dicts_from_flax``, which must invert the JAX package's
``convert_state_dict`` exactly, transposed-conv kernels included.  A second
check goes the other way: the port's own seeded weights, written as a
reference-layout ``.pth``, are loaded by the JAX ``Tester``.

Tolerances are relative to the largest magnitude of the reference tensor:
float32 sums in other orders than XLA's differ by about 1e-6 of the magnitude
per layer, and the b0 encoder stacks 16 blocks of five convolutions.  Encoder
endpoints and decoder outputs: 1e-4 of the magnitude.  Single modules: 2e-5.
The probabilities: 1e-4 absolute, as the sigmoid bounds them to [0, 1]; the
argmax must agree wherever the two JAX probabilities differ by more than
twice that.  Fused against unfused in the port: 1e-5 of the magnitude (the
same weights, one BatchNorm fold apart).
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from rnd_semantic_segmentation_tpu.ckpt import torch_import as TI
from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.eval.tester import Tester as JaxTester
from rnd_semantic_segmentation_tpu.models.attn_unet import AdditiveAttnGate as JaxGate
from rnd_semantic_segmentation_tpu.models.build import build_segmentor as jax_build
from rnd_semantic_segmentation_tpu.models.efficientnet import (
    EfficientNetEncoder as JaxEncoder,
)
from rnd_semantic_segmentation_tpu.train.segmentor import Segmentor as JaxSegmentor

from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    attn_state_dicts_from_flax,
    load_part,
    save_reference_checkpoint,
)
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.eval.tester import Tester
from rnd_semantic_segmentation_torch.models import efficientnet
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.models.efficientnet import (
    EfficientNetEncoder,
    _SameConv,
    head_channels,
    round_filters,
    round_repeats,
    same_padding,
)
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor

torch.set_num_threads(2)  # six test workers share the host's cores

SIZE = 64
NC = 2
MODEL = "attn_efficientnet-b0"
PROB_TOL = 1e-4
ENDPOINTS = [f"reduction_{i}" for i in range(1, 6)]


def jax_cfg(**kv):
    cfg = jax_default_cfg()
    cfg.MODEL.NAME = MODEL
    cfg.MODEL.NUM_CLASSES = NC
    for k, v in kv.items():
        setattr(cfg, k, v)
    return cfg


def port_cfg(*opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", MODEL, "MODEL.NUM_CLASSES", str(NC),
                         "MODEL.DEVICE", "cpu", *opts])
    return cfg


class _OneBatch:
    def __init__(self, x):
        self.batch = {"image": x, "label": np.zeros(x.shape[:3], np.int32), "name": ["a"]}
        self.batch_size = x.shape[0]

    def __iter__(self):
        yield self.batch


def _randomise(path, leaf, rng):
    a = np.asarray(leaf)
    name = path[-1].key
    if name == "kernel":
        return (rng.randn(*a.shape) * np.sqrt(1.7 / np.prod(a.shape[:-1]))).astype(np.float32)
    lo, hi = {"bias": (-0.1, 0.1), "scale": (0.5, 1.5), "mean": (-0.2, 0.2),
              "var": (0.5, 1.5)}[name]
    return rng.uniform(lo, hi, a.shape).astype(np.float32)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).rand(2, SIZE, SIZE, 3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_spec():
    return jax_build(jax_cfg())


@pytest.fixture(scope="module")
def jax_variables(images, jax_spec):
    seg = JaxSegmentor(jax_spec, NC)
    init = jax.jit(seg.init)(jax.random.PRNGKey(0), jnp.asarray(images[:1]))
    rng = np.random.RandomState(1)
    return jax.tree_util.tree_map_with_path(lambda p, l: _randomise(p, l, rng),
                                            jax.tree.map(np.asarray, init))


@pytest.fixture(scope="module")
def jax_forward(images, jax_spec, jax_variables):
    """Endpoints and the five decoder outputs of the JAX modules, one jit."""
    enc, dec = jax_spec.modules["encoder"], jax_spec.modules["decoder"]

    def forward(variables, x):
        endpoints = enc.apply(variables["encoder"], x)
        return endpoints, dec.apply(variables["decoder"], endpoints)
    endpoints, outs = jax.jit(forward)(jax_variables, jnp.asarray(images))
    return jax.tree.map(np.asarray, endpoints), [np.asarray(o) for o in outs]


def _tester(jax_variables, *opts):
    tester = Tester(port_cfg(*opts), logging.getLogger("torch_attn"))
    sds = attn_state_dicts_from_flax(jax_variables)
    for name, module in tester.spec.modules.items():
        load_part(module, sds[name], name)
    return tester


@pytest.fixture(scope="module")
def jax_tester(images, tmp_path_factory):
    """One JAX ``Tester`` for the module: its ``_probs`` is jitted per
    instance, so each new Tester would trace and compile the forward again."""
    return JaxTester(jax_cfg(OUTPUT_DIR=str(tmp_path_factory.mktemp("jax_attn"))),
                     _OneBatch(images), logging.getLogger("jax_attn"))


@pytest.fixture(scope="module")
def port_tester(jax_variables):
    return _tester(jax_variables)


@pytest.fixture(scope="module")
def fused_tester(jax_variables):
    return _tester(jax_variables, "MODEL.FUSED_MBCONV", "True")


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


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


def _back_to_flax(sds):
    return {
        "encoder": TI.convert_state_dict({k: v.numpy() for k, v in sds["encoder"].items()},
                                         TI.ATTN_ENCODER_RULES),
        "decoder": TI.convert_state_dict({k: v.numpy() for k, v in sds["decoder"].items()},
                                         TI.ATTN_DECODER_RULES,
                                         transposed_conv_paths=TI.ATTN_DECODER_TRANSPOSED,
                                         skip=("num_batches_tracked", "decode_0")),
    }


def test_weight_transfer_round_trips_exactly(jax_variables):
    sds = attn_state_dicts_from_flax(jax_variables)
    back = _back_to_flax(sds)
    want = jax.tree_util.tree_flatten_with_path(jax_variables)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        assert got[path].dtype == leaf.dtype and got[path].shape == leaf.shape, path
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))
    # a transposed-conv kernel comes back as (I, O, kh, kw), flipped along both axes
    flax_kernel = jax_variables["decoder"]["params"]["ups_4"]["kernel"]  # (4, 4, 112, 40)
    torch_kernel = sds["decoder"]["ups_4.weight"].numpy()
    assert torch_kernel.shape == (112, 40, 4, 4)
    np.testing.assert_array_equal(torch_kernel[5, 7, 0, 3], flax_kernel[3, 0, 5, 7])
    for key in ("encoder._conv_stem.weight", "encoder._bn0.running_var",
                "encoder._blocks.0._depthwise_conv.weight",
                "encoder._blocks.3._expand_conv.weight", "encoder._blocks.3._bn0.weight",
                "encoder._blocks.15._se_reduce.bias", "encoder._blocks.15._project_conv.weight",
                "encoder._blocks.15._bn2.running_mean", "encoder._conv_head.weight",
                "encoder._bn1.bias"):
        assert key in sds["encoder"], key
    for key in ("attn_mid.conv_g.bias", "attn_mid.conv_x.weight", "attn_2.conv_group.weight",
                "mid_upsampler.weight", "ups_1.weight", "decode_4.0.weight",
                "decode_4.1.running_var", "decode_1.3.bias", "decode_1.4.weight",
                "out_0.0.weight", "out_4.0.bias"):
        assert key in sds["decoder"], key
    assert not any(k.startswith("decode_0") for k in sds["decoder"])
    assert "encoder._blocks.0._expand_conv.weight" not in sds["encoder"]  # expand ratio 1


def test_port_state_dict_keys_are_the_reference_keys(jax_variables, port_tester):
    sds = attn_state_dicts_from_flax(jax_variables)
    for name, module in port_tester.spec.modules.items():
        assert set(module.state_dict()) == set(sds[name])
        for key, value in module.state_dict().items():
            assert value.shape == sds[name][key].shape, key


@pytest.mark.parametrize("backbone", ["efficientnet-b2", "efficientnet-b4"])
def test_wider_encoders_have_the_jax_shapes(backbone):
    """The block list of a wider, deeper variant, by shape only: the port's
    ``state_dict`` mapped onto a flax tree against ``eval_shape`` of the JAX init."""
    port = EfficientNetEncoder(backbone)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    tree = TI.convert_state_dict(sd, TI.ATTN_ENCODER_RULES)
    want = jax.eval_shape(JaxEncoder(backbone).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3), jnp.float32))
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda s: s.shape, dict(want),
                                                is_leaf=lambda s: hasattr(s, "shape")))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda a: a.shape, tree, is_leaf=lambda a: isinstance(a, np.ndarray)))[0])
    assert len(got) == len(want) and len(want) > 400
    for path, shape in want:
        assert got[path] == shape, path


def test_width_and_depth_rounding():
    assert [round_filters(f, 1.1) for f in (32, 16, 24, 40, 80, 112, 192, 320, 1280)] == \
        [32, 16, 24, 48, 88, 120, 208, 352, 1408]
    assert [round_repeats(r, 1.2) for r in (1, 2, 3, 4)] == [2, 3, 4, 5]
    assert head_channels("efficientnet-b0") == 1280 and head_channels("efficientnet-b4") == 1792
    assert len(efficientnet.block_list("efficientnet-b0")) == 16
    with pytest.raises(NotImplementedError):
        EfficientNetEncoder("efficientnet-b7")


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [3, 5])
@pytest.mark.parametrize("h,w", [(8, 16), (9, 15), (16, 7), (5, 5)])
def test_same_conv_pads_like_lax_same(h, w, kernel, stride):
    rng = np.random.RandomState(h * 100 + w * 10 + kernel + stride)
    x = rng.randn(2, h, w, 4).astype(np.float32)
    wt = rng.randn(kernel, kernel, 4, 6).astype(np.float32)
    ref = lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(wt), (stride, stride), "SAME",
                                   dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = _SameConv(4, 6, kernel, stride)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(wt.transpose(3, 2, 0, 1)))
        out = conv(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-5, atol=1e-5)
    before, after = same_padding(h, kernel, stride)
    assert after - before in (0, 1) and (h + before + after - kernel) // stride + 1 == -(-h // stride)


def test_same_padding_at_the_stem_of_a_512_input():
    assert same_padding(512, 3, 2) == (0, 1)   # 0 before, 1 after: not expressible as padding=
    assert same_padding(511, 3, 2) == (1, 1)   # an odd size changes the split
    assert same_padding(128, 5, 2) == (1, 2)
    assert same_padding(128, 5, 1) == (2, 2)


@pytest.mark.parametrize("name", ENDPOINTS)
def test_encoder_endpoints(name, jax_forward, port_tester, images):
    with torch.no_grad():
        endpoints = port_tester.segmentor.parts["encoder"](_nchw(images))
    assert sorted(endpoints) == ENDPOINTS
    _assert_close_to_max(_nhwc(endpoints[name]), jax_forward[0][name], 1e-4)


@pytest.mark.parametrize("index", range(5))
def test_decoder_outputs_from_the_jax_endpoints(index, jax_forward, port_tester):
    endpoints = {k: _nchw(v) for k, v in jax_forward[0].items()}
    with torch.no_grad():
        outs = port_tester.segmentor.parts["decoder"](endpoints)
    assert len(outs) == 5
    assert outs[index].shape == (2, NC, SIZE >> index, SIZE >> index)
    _assert_close_to_max(_nhwc(outs[index]), jax_forward[1][index], 1e-4)


def test_additive_attn_gate_module(jax_variables, port_tester):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 7, 112).astype(np.float32)
    g = rng.randn(2, 10, 14, 40).astype(np.float32)
    p = jax_variables["decoder"]["params"]["attn_4"]
    ref = JaxGate(112, 40).apply({"params": p}, jnp.asarray(x), jnp.asarray(g))
    with torch.no_grad():
        out = port_tester.segmentor.parts["decoder"].attn_4(_nchw(x), _nchw(g))
    _assert_close_to_max(_nhwc(out), ref, 2e-5)


def test_whole_forward_fused_and_unfused(jax_forward, port_tester, fused_tester, images,
                                         monkeypatch):
    calls = []
    core = efficientnet.fused_mbconv_core
    monkeypatch.setattr(efficientnet, "fused_mbconv_core",
                        lambda *a: calls.append(tuple(a[0].shape)) or core(*a))
    with torch.no_grad():
        unfused, tap = port_tester.segmentor(_nchw(images))
        assert not calls
        fused, fused_tap = fused_tester.segmentor(_nchw(images))
    # b0 has 11 blocks with expansion and stride 1 (1 + 1 + 2 + 3 + 3 + 1 of 16)
    assert len(calls) == 11 and calls[0] == (2, 24, 16, 16) and calls[-1] == (2, 192, 2, 2)
    assert tap.shape == (2, 1280, 2, 2)
    _assert_close_to_max(_nhwc(tap), jax_forward[0]["reduction_5"], 1e-4)
    for out, fout, ref in zip(unfused, fused, jax_forward[1]):
        _assert_close_to_max(_nhwc(out), ref, 1e-4)
        _assert_close_to_max(_nhwc(fout), ref, 1e-4)
        _assert_close_to_max(fout.numpy(), out.numpy(), 1e-5)
    _assert_close_to_max(fused_tap.numpy(), tap.numpy(), 1e-5)


def test_attn_training_waits_for_its_slice(images):
    """Train mode runs (drop-connect from an explicit generator) and moves
    every BatchNorm's running statistics; attnwrap builds; a backbone other
    than EfficientNet-B0..B4 still raises."""
    seg = Segmentor(build_segmentor(port_cfg()), NC)
    randomize_weights_(seg, seed=6)
    norms = [m for m in seg.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    before = [(m.running_mean.clone(), m.running_var.clone()) for m in norms]
    with torch.no_grad():
        outs, tap = seg(_nchw(images), train=True, generator=torch.Generator().manual_seed(0))
    assert seg.training and len(outs) == 5 and tap.shape == (2, 1280, 2, 2)
    assert all(torch.isfinite(o).all() for o in outs)
    assert len(norms) == 57 and all(
        not torch.equal(m.running_mean, mean) and not torch.equal(m.running_var, var)
        for m, (mean, var) in zip(norms, before))
    spec = build_segmentor(port_cfg("MODEL.NAME", "attnwrap_efficientnet-b0"))
    assert (spec.family, list(spec.modules), spec.ckpt_prefix) == ("attnwrap", ["model"],
                                                                   "AttnWrap")
    with pytest.raises(NotImplementedError):
        build_segmentor(port_cfg("MODEL.NAME", "attn_resnet50"))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_probabilities_of_the_tester_head(fused, jax_variables, port_tester, fused_tester,
                                          images, jax_tester):
    ref = jax_tester._probs(jax_variables, jnp.asarray(images), (SIZE, SIZE))
    tester = fused_tester if fused else port_tester
    probs = tester._probs_impl(_nchw(images), (SIZE, SIZE))
    assert probs.shape == (2, NC, SIZE, SIZE) and probs.dtype == torch.float32
    _assert_probs_agree(_nhwc(probs), ref)


def test_same_pth_in_both_packages(images, tmp_path, jax_tester):
    cfg = port_cfg("resume", str(tmp_path / "Attn-seeded.pth"))
    seeded = Tester(cfg, logging.getLogger("torch_attn"))
    randomize_weights_(seeded.segmentor, seed=5)
    save_reference_checkpoint(seeded.spec.modules, cfg.resume)

    port = Tester(cfg, logging.getLogger("torch_attn"))
    port._load_checkpoint()
    probs = port._probs_impl(_nchw(images), (SIZE, SIZE))

    jt = JaxTester(jax_cfg(OUTPUT_DIR=str(tmp_path), resume=cfg.resume),
                   _OneBatch(images), logging.getLogger("jax_attn"))
    jt._load_checkpoint()
    ref = jax_tester._probs(jt.variables, jnp.asarray(images), (SIZE, SIZE))
    _assert_probs_agree(_nhwc(probs), ref)


def test_seeded_weights_cover_transposed_convs():
    seg = Segmentor(build_segmentor(port_cfg()), NC)
    before = {k: v.clone() for k, v in seg.state_dict().items()}
    randomize_weights_(seg, seed=3)
    ups = seg.parts["decoder"].ups_3.weight
    assert not torch.equal(ups, before["parts.decoder.ups_3.weight"])
    assert 0.5 < ups.std() / (1.7 / (ups.shape[0] * 4)) ** 0.5 < 1.5
