"""The port's post-training int8 quantization (serve/quant.py, the
``layers.Conv2d`` hook, the quantization keys of models/build.py, the Tester
and the server under ``TEST.QUANT``) against the JAX package's, on the CPU.

Tolerances:
  * one conv: the activation and weight scales, and the int8 outputs given
    the same scales, to 1e-6 of the largest magnitude (the same float32
    divisions and roundings; int32 sums are exact); the port's ``int8``
    equals its ``fake`` to 1e-6 (float32 sums of integers below 2^24 are
    exact too);
  * deeplab_resnet18 at 64x64 through the bridge: scales to 1e-5 relative
    (a conv's input absmax after up to 20 float32 convs in another order);
    with the JAX scales copied in, probabilities within PROB_TOL and the
    argmax equal on at least 99.5% of pixels: an activation that lands within
    float32 rounding of a .5 quantization boundary rounds to the other
    integer on one side, which moves that conv's output by one quantum.
"""

import logging
import threading

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
from flax import linen as fnn

from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.data import (
    DataLoader as JaxDataLoader,
    build_collate_fn as jax_collate_fn,
    build_dataset as jax_build_dataset,
)
from rnd_semantic_segmentation_tpu.eval.tester import Tester as JaxTester
from rnd_semantic_segmentation_tpu.models.build import build_segmentor as jax_build
from rnd_semantic_segmentation_tpu.models.layers import Conv2d as JaxConv2d
from rnd_semantic_segmentation_tpu.serve import quant as jq
from rnd_semantic_segmentation_tpu.train.segmentor import Segmentor as JaxSegmentor

from rnd_semantic_segmentation_torch.ckpt.torch_import import save_reference_checkpoint
from rnd_semantic_segmentation_torch.cli import test as test_cli
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.eval.tester import Tester
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.models.layers import Conv2d
from rnd_semantic_segmentation_torch.serve import quant as pq
from rnd_semantic_segmentation_torch.serve.server import InferenceServer
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor
from rnd_semantic_segmentation_torch.utils import load_json

from test_quant import OutlierNet

torch.set_num_threads(2)  # six test workers share the host's cores

CONFIG = "configs/deeplabv2_r101_src.yaml"
SIZE, NC, IMAGES, BATCH = 64, 5, 4, 2
OPTS = ["MODEL.NAME", "deeplab_resnet18", "MODEL.NUM_CLASSES", str(NC),
        "MODEL.DTYPE", "float32", "INPUT.INPUT_SIZE_TEST", f"({SIZE}, {SIZE})",
        "DATASETS.TEST", "synthetic_val", "DATASETS.SYNTHETIC_LENGTH", str(IMAGES),
        "TEST.BATCH_SIZE", str(BATCH), "DATA_PIPE.NUM_WORKERS", "1"]
PROB_TOL = 2e-2
REL = 1e-6


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _port_cfg(tmp, *more):
    cfg = get_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(OPTS + ["MODEL.DEVICE", "cpu", "OUTPUT_DIR", str(tmp),
                                "resume", str(tmp / "Aspp-seeded.pth"), *more])
    return cfg


def _jax_cfg(tmp, *more):
    cfg = jax_default_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(OPTS + ["OUTPUT_DIR", str(tmp / "jax"),
                                "resume", str(tmp / "Aspp-seeded.pth"), *more])
    return cfg


class _NoLoader:
    batch_size = BATCH

    def __iter__(self):
        return iter(())


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """A seeded deeplab_resnet18 ``.pth``: the port's modules, read by both
    packages (the JAX Tester through its reference-checkpoint importer)."""
    tmp = tmp_path_factory.mktemp("torch_quant")
    t = Tester(_port_cfg(tmp), logging.getLogger("torch_quant"))
    randomize_weights_(t.segmentor, seed=21)
    save_reference_checkpoint(t.spec.modules, str(tmp / "Aspp-seeded.pth"))
    return tmp


@pytest.fixture(scope="module")
def pair(seeded):
    """(port Tester, JAX Tester, an input batch NHWC) on the seeded weights."""
    pt = Tester(_port_cfg(seeded), logging.getLogger("torch_quant"))
    pt._load_checkpoint()
    jt = JaxTester(_jax_cfg(seeded), _NoLoader(), logging.getLogger("jax_quant"))
    jt._load_checkpoint()
    x = np.random.RandomState(3).rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
    return pt, jt, x


# -- one conv ------------------------------------------------------------------------

class _JaxOneConv(fnn.Module):
    features: int
    k: int
    stride: int
    dilation: int
    padding: int
    bias: bool

    @fnn.compact
    def __call__(self, x):
        return JaxConv2d(self.features, self.k, self.stride, self.padding, self.dilation,
                         use_bias=self.bias, name="conv")(x)


# (ci, co, k, stride, dilation, padding, bias): 72 pads to 96 (the rule of 32),
# 130 to 256 (the rule of 128), 64, 96 and 128 not at all
CONV_CASES = [(64, 72, 3, 1, 1, 1, True), (130, 96, 3, 2, 1, 1, True),
              (96, 130, 3, 1, 2, 2, False), (128, 64, 1, 1, 1, 0, True)]


@pytest.mark.parametrize("ci,co,k,stride,dilation,padding,bias", CONV_CASES)
def test_one_quantized_conv_matches_the_jax_conv(ci, co, k, stride, dilation, padding, bias):
    rng = np.random.RandomState(ci + co)
    x = rng.randn(2, 9, 11, ci).astype(np.float32)
    kernel = (rng.randn(k, k, ci, co) * (2.0 / (k * k * ci)) ** 0.5).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, co).astype(np.float32)
    model = _JaxOneConv(co, k, stride, dilation, padding, bias)
    params = {"conv": {"kernel": kernel, **({"bias": b} if bias else {})}}
    jcfg = jq.QuantConfig(mode="int8", calib_batches=1)
    jctx = jq.QuantContext(config=jcfg, mode="calibrate")
    with jq.quant_scope(jctx):
        model.apply({"params": params}, jnp.asarray(x))
    jctx.finalize_scales()
    jctx.mode = "int8"
    with jq.quant_scope(jctx):
        want = np.asarray(model.apply({"params": params}, jnp.asarray(x)))

    conv = Conv2d(ci, co, k, stride, padding, dilation, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        if bias:
            conv.bias.copy_(torch.from_numpy(b))
    conv.quant_key = "conv"
    xt = _nchw(x)
    pctx = pq.QuantContext(config=pq.QuantConfig(mode="int8", calib_batches=1),
                           mode="calibrate")
    with torch.no_grad(), pq.quant_scope(pctx):
        conv(xt)
    pctx.finalize_scales()
    assert set(pctx.act_scales) == set(jctx.act_scales) == {"conv"}
    np.testing.assert_allclose(pctx.act_scales["conv"], jctx.act_scales["conv"], rtol=REL)

    pctx.act_scales = dict(jctx.act_scales)
    outs = {}
    for mode in ("int8", "fake"):
        pctx.mode = mode
        with torch.no_grad(), pq.quant_scope(pctx):
            outs[mode] = conv(xt).permute(0, 2, 3, 1).numpy()
    scale = np.abs(want).max()
    assert outs["int8"].shape == want.shape
    assert np.abs(outs["int8"] - want).max() <= REL * scale
    assert np.abs(outs["int8"] - outs["fake"]).max() <= REL * scale
    # the float conv is a different function: quantization moves it visibly
    with torch.no_grad():
        plain = conv(xt).permute(0, 2, 3, 1).numpy()
    assert 1e-4 * scale < np.abs(plain - want).max() < 5e-2 * scale


@pytest.mark.parametrize("rows", [1, 7, 16, 17, 33])
def test_int8_conv_is_exact_at_every_row_count(rows):
    """``int8_conv2d`` against float64 of the same integers, at output row
    counts (B*Ho*Wo) below, at and above the product's row tile."""
    rng = np.random.RandomState(rows)
    x8 = torch.from_numpy(rng.randint(-127, 128, (rows, 64, 1, 1)).astype(np.int8))
    k8 = torch.from_numpy(rng.randint(-127, 128, (96, 64, 1, 1)).astype(np.int8))
    got = pq.int8_conv2d(x8, k8)
    want = torch.nn.functional.conv2d(x8.double(), k8.double())
    assert got.dtype == torch.int32 and torch.equal(got.double(), want)
    x8 = torch.from_numpy(rng.randint(-127, 128, (1, 40, 5, rows)).astype(np.int8))
    k8 = torch.from_numpy(rng.randint(-127, 128, (48, 40, 3, 3)).astype(np.int8))
    got = pq.int8_conv2d(x8, k8, (2, 1), (1, 2), (1, 2))
    want = torch.nn.functional.conv2d(x8.double(), k8.double(), None, (2, 1), (1, 2), (1, 2))
    assert torch.equal(got.double(), want)


# -- a model -------------------------------------------------------------------------

def test_calibration_matches_the_jax_calibration(pair):
    pt, jt, x = pair
    jctx = jq.calibrate_segmentor(jt.segmentor, jt.variables, [{"image": jnp.asarray(x)}],
                                  config=jq.QuantConfig(mode="int8", calib_batches=1))
    pctx = pq.calibrate_segmentor(pt.segmentor, [{"image": x}],
                                  config=pq.QuantConfig(mode="int8", calib_batches=1))
    assert len(jctx.act_scales) == 19  # resnet18's convs of 64+ channels; ASPP's 5 out
    assert set(pctx.act_scales) == set(jctx.act_scales)
    for key, want in jctx.act_scales.items():
        np.testing.assert_allclose(pctx.act_scales[key], want, rtol=1e-5, err_msg=key)

    pctx.act_scales = dict(jctx.act_scales)
    with jq.quant_scope(jctx):
        want = np.asarray(jax.jit(lambda xx: jt._probs_impl(jt.variables, xx, (SIZE, SIZE)))(
            jnp.asarray(x)))
    with pq.quant_scope(pctx):
        got = pt._probs_impl(_nchw(x), (SIZE, SIZE)).permute(0, 2, 3, 1).numpy()
    float_probs = pt._probs_impl(_nchw(x), (SIZE, SIZE)).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= PROB_TOL
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.995
    assert np.abs(float_probs - want).max() > 1e-4  # the quantized head is not the float one


FAMILIES = [("deeplab_resnet18", 64), ("deeplab_vgg16", 64), ("gald_hardnet68", 224),
            ("attn_efficientnet-b0", 64), ("attnwrap_efficientnet-b0", 64),
            ("pranet_res2net50", 64), ("pranet_resnet50", 64)]
_SAME_CONVS = ("conv_stem", "expand_conv", "depthwise_conv", "project_conv", "conv_head")


def _split_seen(seen, config, ctx):
    """(every hooked conv, the quantized keys, the skipped keys) of one
    calibrating forward; ``seen`` holds (key, ci, co, groups)."""
    gated = {p for p, ci, co, g in seen
             if (g == 1 or config.quantize_grouped) and min(ci, co) >= config.min_channels}
    return set(seen), set(ctx.traced), {p for p in gated if ctx._skipped(p)}


@pytest.mark.parametrize("name,size", FAMILIES)
def test_quantized_and_skipped_keys_equal_the_jax_keys(name, size, monkeypatch):
    jseen, pseen = [], []
    jconv, pconv = jq.QuantContext.conv2d, pq.QuantContext.conv2d

    def jspy(self, path, x, kernel, bias, kw):
        jseen.append((path, kernel.shape[2], kernel.shape[3], kw["feature_group_count"]))
        return jconv(self, path, x, kernel, bias, kw)

    def pspy(self, path, x, weight, bias, *args):
        pseen.append((path, weight.shape[1], weight.shape[0], args[-1]))
        return pconv(self, path, x, weight, bias, *args)

    monkeypatch.setattr(jq.QuantContext, "conv2d", jspy)
    monkeypatch.setattr(pq.QuantContext, "conv2d", pspy)
    jcfg = jax_default_cfg()
    jcfg.merge_from_list(["MODEL.NAME", name, "MODEL.NUM_CLASSES", "3"])
    seg = JaxSegmentor(jax_build(jcfg), 3)
    spec = jax.ShapeDtypeStruct((2, size, size, 3), jnp.float32)
    template = jax.eval_shape(seg.init, jax.random.PRNGKey(0), spec)
    jctx = jq.QuantContext(mode="calibrate")

    def trace(variables, x):
        params = {n: dict(v)["params"] for n, v in variables.items()}
        stats = {n: {k: c for k, c in dict(v).items() if k != "params"}
                 for n, v in variables.items()}
        with jq.quant_scope(jctx):
            seg.forward(params, stats, x, label_size=(size, size), train=False)
        return 0

    jax.eval_shape(trace, template, spec)

    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", name, "MODEL.NUM_CLASSES", "3", "MODEL.DEVICE", "cpu"])
    model = Segmentor(build_segmentor(cfg), 3).eval()
    pctx = pq.QuantContext(mode="calibrate")
    with torch.no_grad(), pq.quant_scope(pctx):
        model(torch.rand(2, 3, size, size, generator=torch.Generator().manual_seed(0)))

    j_all, j_quant, j_skip = _split_seen(jseen, jq.QuantConfig(), jctx)
    p_all, p_quant, p_skip = _split_seen(pseen, pq.QuantConfig(), pctx)
    assert p_all == j_all
    assert p_quant == j_quant and p_skip == j_skip
    assert p_quant and not any(p.endswith(_SAME_CONVS) for p, *_ in p_all)


def test_keys_come_from_the_bridge_and_raise_without_it():
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", "deeplab_resnet18", "MODEL.DEVICE", "cpu"])
    spec = build_segmentor(cfg)
    keys = {n: m.quant_key for part in spec.modules.values()
            for n, m in part.named_modules() if isinstance(m, Conv2d)}
    assert keys["backbone.layer1.0.conv1"] == "backbone/layer1_0/conv1"
    assert keys["backbone.layer4.0.downsample.0"] == "backbone/layer4_0/downsample_conv"
    assert keys["conv2d_list.3"] == "conv2d_3"
    with pytest.raises(KeyError, match="quantization key"), \
            pq.quant_scope(pq.QuantContext(mode="calibrate")):
        Conv2d(3, 8, 1)(torch.zeros(1, 3, 4, 4))


# -- the policy -----------------------------------------------------------------------

class _PortOutlierNet(nn.Module):
    """tests/test_quant.py's ``OutlierNet`` in the port: conv_b's input
    carries a spike about 1000 times its other values."""

    def __init__(self, params):
        super().__init__()
        self.convs = nn.ModuleDict()
        for name, ci, co, k in (("conv_a", 3, 16, 3), ("conv_b", 16, 16, 3),
                                ("conv_head", 16, 4, 1)):
            conv = Conv2d(ci, co, k, padding=k // 2)
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(
                    np.array(params[name]["kernel"]).transpose(3, 2, 0, 1)))
                conv.bias.copy_(torch.from_numpy(np.array(params[name]["bias"])))
            conv.quant_key = name
            self.convs[name] = conv

    def forward(self, x):
        h = torch.relu(self.convs["conv_a"](x))
        spike = torch.zeros_like(h)
        spike[:, 0, 0, 0] = 3000.0
        return self.convs["conv_head"](torch.relu(self.convs["conv_b"](h + spike)))


def _calibrated(model, x, mode="int8", **config):
    config = {"skip_patterns": (), "min_channels": 0, **config}
    ctx = pq.QuantContext(config=pq.QuantConfig(mode=mode, calib_batches=1, **config),
                          mode="calibrate")
    with torch.no_grad(), pq.quant_scope(ctx):
        model(x)
    ctx.finalize_scales()
    ctx.mode = mode
    return ctx


@pytest.fixture(scope="module")
def outlier():
    """The JAX OutlierNet, its calibrated context and probabilities; the
    port's on the same weights and input."""
    rng = np.random.RandomState(5)
    x = 3 * rng.randn(2, 16, 16, 3).astype(np.float32)
    jmodel = OutlierNet()
    variables = jmodel.init(jax.random.PRNGKey(5), jnp.asarray(x))
    jctx = jq.QuantContext(config=jq.QuantConfig(mode="int8", calib_batches=1,
                                                 skip_patterns=(), min_channels=0),
                           mode="calibrate")
    with jq.quant_scope(jctx):
        jmodel.apply(variables, jnp.asarray(x))
    jctx.finalize_scales()
    jctx.mode = "int8"

    def jprobs(xx, label_size):
        return jax.nn.softmax(jmodel.apply(variables, xx), axis=-1)

    pmodel = _PortOutlierNet(variables["params"])

    def pprobs(xx, label_size):
        with torch.no_grad():
            return torch.softmax(pmodel(xx), dim=1)

    return (jctx, jprobs, jnp.asarray(x)), (pmodel, pprobs, _nchw(x))


def test_outlier_sensitivity_and_repair_match_the_jax_policy(outlier):
    (jctx, jprobs, jx), (pmodel, pprobs, px) = outlier
    pctx = _calibrated(pmodel, px)
    assert set(pctx.act_scales) == set(jctx.act_scales) == {"conv_a", "conv_b", "conv_head"}
    for key, want in jctx.act_scales.items():
        np.testing.assert_allclose(pctx.act_scales[key], want, rtol=1e-5, err_msg=key)
    jerrs = jq.quant_sensitivity(jprobs, jx, None, jctx)
    perrs = pq.quant_sensitivity(pprobs, px, None, pctx)
    assert sorted(perrs, key=perrs.get) == sorted(jerrs, key=jerrs.get)
    assert max(perrs, key=perrs.get) == "conv_b"
    for key, want in jerrs.items():
        np.testing.assert_allclose(perrs[key], want, rtol=1e-3, err_msg=key)
    before = pq.argmax_agreement(pprobs, px, None, pctx)
    np.testing.assert_allclose(before, jq.argmax_agreement(jprobs, jx, None, jctx), atol=2e-3)
    assert before < 0.9
    jagree, jexcluded = jq.repair_exclusions(jprobs, jx, None, jctx, floor=0.99, max_exclude=2)
    pagree, pexcluded = pq.repair_exclusions(pprobs, px, None, pctx, floor=0.99, max_exclude=2)
    assert pexcluded == jexcluded and pctx.exclude == set(pexcluded)
    assert pagree >= 0.99 and abs(pagree - jagree) <= 2e-3


def test_agreement_is_computed_fresh_after_an_unquantized_call(outlier):
    """The analog of test_quant.py's ``test_agreement_defeats_jit_cache``:
    after the float head ran, the agreement still compares the quantized
    forward, equal to an eager comparison."""
    _, (pmodel, pprobs, px) = outlier
    ctx = _calibrated(pmodel, px)
    float_pred = pprobs(px, None).argmax(1)
    a = pq.argmax_agreement(pprobs, px, None, ctx)
    with pq.quant_scope(ctx):
        quant_pred = pprobs(px, None).argmax(1)
    assert a == float((float_pred == quant_pred).float().mean())
    assert a < 0.9


def test_repair_stops_after_two_rounds_without_gain(monkeypatch):
    rounds = {"sens": 0}

    def fake_sens(probs_fn, x, label_size, ctx):
        rounds["sens"] += 1
        return {f"conv_{rounds['sens']}": 1.0}  # always another candidate, none helps

    def fake_argmax(ctx, probs_fn, x, label_size):
        pred = torch.zeros(100, dtype=torch.long)
        if ctx is not None:
            pred[:50] = 1  # agreement pinned at 0.5
        return pred

    monkeypatch.setattr(pq, "quant_sensitivity", fake_sens)
    monkeypatch.setattr(pq, "_argmax_under", fake_argmax)
    agreement, excluded = pq.repair_exclusions(None, None, None, pq.QuantContext(mode="fake"),
                                               floor=0.95, max_exclude=10)
    assert agreement == 0.5 and len(excluded) == 2 and rounds["sens"] == 2


def _two_conv(seed):
    torch.manual_seed(seed)
    model = nn.Sequential(Conv2d(3, 16, 3, padding=1), nn.ReLU(), Conv2d(16, 8, 1))
    model[0].quant_key, model[2].quant_key = "conv_a", "conv_b"
    return model, torch.randn(2, 3, 16, 16, generator=torch.Generator().manual_seed(seed))


def test_gates_exclusions_skips_and_an_inactive_scope_keep_the_float_path():
    model, x = _two_conv(4)
    with torch.no_grad():
        ref = model(x)
        with pq.quant_scope(None):
            assert torch.equal(model(x), ref)
        gated = _calibrated(model, x, mode="fake", min_channels=256)
        assert gated.act_scales == {}  # 16- and 8-channel convs under the gate
        with pq.quant_scope(gated):
            assert torch.equal(model(x), ref)
        ctx = _calibrated(model, x)
        assert set(ctx.act_scales) == {"conv_a", "conv_b"}
        with pq.quant_scope(ctx):
            quantized = model(x)
        assert not torch.equal(quantized, ref)
        assert (quantized - ref).norm() / ref.norm() < 0.03
        ctx.exclude = set(ctx.act_scales)
        with pq.quant_scope(ctx):
            assert torch.equal(model(x), ref)
        skipped = _calibrated(model, x, skip_patterns=("*conv_b*",))
        assert set(skipped.act_scales) == {"conv_a"}


def test_resolve_mode():
    assert pq.resolve_mode("none") == "none"
    assert pq.resolve_mode("fake", device="cpu") == "fake"
    assert pq.supports_int8_conv("cpu") and pq.resolve_mode("int8", device="cpu") == "int8"
    assert pq.resolve_mode("auto", area=4096, max_area=1024, device="cpu") == "none"
    assert pq.resolve_mode("auto", area=1024, max_area=1024, device="cpu") == "int8"
    assert pq.resolve_mode("auto", area=10 ** 9, max_area=0, device="cpu") == "int8"
    with pytest.raises(ValueError, match="int4"):
        pq.resolve_mode("int4")


# -- the Tester and the server --------------------------------------------------------

REPORT_CASES = {"int8": ("TEST.QUANT", "int8"), "fake": ("TEST.QUANT", "fake"),
                "auto": ("TEST.QUANT", "auto"),
                "geometry": ("TEST.QUANT", "auto", "TEST.QUANT_MAX_AREA", "1024"),
                "accuracy": ("TEST.QUANT", "auto", "TEST.QUANT_AGREEMENT_FLOOR", "1.01",
                             "TEST.QUANT_REPAIR_MAX", "0")}


@pytest.mark.parametrize("case", list(REPORT_CASES))
def test_tester_under_test_quant_reports_what_the_jax_tester_does(case, seeded):
    opts = REPORT_CASES[case]
    jcfg = _jax_cfg(seeded, *opts)
    loader = JaxDataLoader(jax_build_dataset(jcfg, mode="test", is_source=False),
                           batch_size=BATCH, shuffle=False, drop_last=False, num_workers=1,
                           collate_fn=jax_collate_fn(jcfg))
    jt = JaxTester(jcfg, loader, logging.getLogger("jax_quant"))
    jt._load_checkpoint()
    jt.make_quant_context()
    want = jt.quant_report

    out = seeded / f"report_{case}"
    tester = test_cli.make_tester(_port_cfg(seeded, *opts, "OUTPUT_DIR", str(out)), {},
                                  logger=logging.getLogger("torch_quant"))
    summary = tester.test()
    got = tester.quant_report
    assert (got["requested"], got["mode"], got["reason"]) == (
        want["requested"], want["mode"], want["reason"])
    if want["agreement"] is None:
        assert got["agreement"] is None
    else:
        assert abs(got["agreement"] - want["agreement"]) <= 5e-3
    assert (tester._qctx is None) == (want["mode"] == "none")
    assert np.isfinite(summary["macro_miou"])
    assert load_json(str(out / "deeplab_confusion_matrix.json"))["cmt"]
    assert (out / "deeplab_confusion_matrix.png").stat().st_size > 0


def test_server_calibrates_on_its_first_real_batch_in_the_dispatcher(seeded, monkeypatch):
    calls = []
    conv = pq.QuantContext.conv2d

    def spy(self, path, *args):
        calls.append((self.mode, threading.current_thread().name))
        return conv(self, path, *args)

    monkeypatch.setattr(pq.QuantContext, "conv2d", spy)
    cfg = _port_cfg(seeded, "TEST.QUANT", "int8")
    inf = InferenceServer(cfg, {}, logging.getLogger("torch_quant"), max_batch=2,
                          batch_timeout_ms=20.0)
    try:
        assert inf.ready.wait(120)
        assert calls == [] and inf._qctx is None  # the warmup's zeros calibrate nothing
        assert inf.quant_state() == "pending-calibration"
        image = (np.random.RandomState(8).rand(SIZE, SIZE, 3) * 255).astype(np.uint8)
        from PIL import Image
        import io
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, format="PNG")
        pred = inf.predict(buf.getvalue())
        assert inf.quant_state() == "int8"
        x = inf.preprocess(buf.getvalue())
    finally:
        inf.shutdown()
    dispatcher = inf._thread.name
    assert {t for _, t in calls} == {dispatcher}
    assert {m for m, _ in calls} == {"calibrate", "int8"}
    # the scales are those of the first dispatched batch: the image in a bucket of 1
    want = pq.calibrate_segmentor(inf.tester.segmentor, [{"image": x[None]}],
                                  pq.QuantConfig(mode="int8", calib_batches=1))
    assert inf._qctx.act_scales == want.act_scales
    with pq.quant_scope(inf._qctx):
        probs = inf.tester._probs_impl(_nchw(x[None]), (SIZE, SIZE))
    np.testing.assert_array_equal(pred, probs[0].argmax(0).numpy())
