"""int8 quantization and the kernels' operators on the card: the integer
conv (``torch._int_mm`` on columns built from int8 views) against
``F.conv2d`` in float64 of the same integers, which it must equal bit for
bit (int32 sums of s8 products are exact, and so are float64 sums below
2^53), over the conv shape classes of the quantized models and output row
counts 1-17 and 33 (the product's rows are padded to a multiple of 32); the
quantized conv in ``int8`` against ``fake``; kernels #1 and #3 through
their operators against their wrappers, bit for bit; and exported programs
(int8 DeepLab, GALD with #1) that load and run on the card, equal to the
Tester.  Each skips without a card.

This file imports nothing of the JAX package, so that it collects on a
machine that has the card and not the JAX package's dependencies.
"""

import logging

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.eval.tester import Tester
from rnd_semantic_segmentation_torch.models.build import randomize_weights_
from rnd_semantic_segmentation_torch.models.layers import Conv2d
from rnd_semantic_segmentation_torch.ops import ccattn, mbconv
from rnd_semantic_segmentation_torch.serve import quant as pq
from rnd_semantic_segmentation_torch.serve.export import export_eval, load_exported
from rnd_semantic_segmentation_torch.utils import resolve_device

# (name, ci, co, k, stride, padding, dilation): the classes of the quantized
# convs (ResNet's 1x1 and 3x3, its strided and dilated 3x3, HarDNet's odd
# widths, a 1x1 conv on a pooled map)
SHAPE_CLASSES = [("1x1", 256, 64, 1, 1, 0, 1), ("3x3", 64, 64, 3, 1, 1, 1),
                 ("3x3 dilated", 128, 96, 3, 1, 2, 2), ("3x3 strided", 64, 128, 3, 2, 1, 1),
                 ("odd widths", 72, 130, 3, 1, 1, 1), ("pooled", 1152, 48, 1, 1, 0, 1)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return resolve_device("cuda")


def _int8(shape, gen):
    return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("name,ci,co,k,stride,padding,dilation", SHAPE_CLASSES)
def test_int8_conv_equals_float64_of_its_integers(name, ci, co, k, stride, padding, dilation):
    device = _card()
    gen = torch.Generator().manual_seed(ci * co)
    k8 = _int8((co, ci, k, k), gen).to(device)
    sizes = [(8, 16, 32)] + [(rows, 1, 1) for rows in range(1, 18)] + [(33, 1, 1)]
    if k > 1:
        sizes = [(b, max(h, k), max(w, k)) for b, h, w in sizes]
    for b, h, w in sizes:
        x8 = _int8((b, ci, h, w), gen).to(device)
        got = pq.int8_conv2d(x8, k8, (stride, stride), (padding, padding), (dilation, dilation))
        want = F.conv2d(x8.double(), k8.double(), None, stride, padding, dilation)
        assert got.dtype == torch.int32 and got.shape == want.shape, (name, b, h, w)
        assert torch.equal(got.double(), want), (name, b, h, w)


@pytest.mark.cuda
def test_quantized_conv_int8_equals_fake_on_the_card():
    device = _card()
    torch.manual_seed(0)
    conv = Conv2d(130, 72, 3, 2, 1).to(device)
    conv.quant_key = "conv"
    x = torch.randn(2, 130, 33, 17, device=device)
    ctx = pq.QuantContext(config=pq.QuantConfig(calib_batches=1), mode="calibrate")
    with torch.no_grad(), pq.quant_scope(ctx):
        conv(x)
    ctx.finalize_scales()
    outs = {}
    for mode in ("int8", "fake"):
        ctx.mode = mode
        with torch.no_grad(), pq.quant_scope(ctx):
            outs[mode] = conv(x)
    assert (outs["int8"] - outs["fake"]).abs().max() <= 1e-6 * outs["fake"].abs().max()


@pytest.mark.cuda
def test_operators_equal_the_kernel_wrappers():
    device = _card()
    gen = torch.Generator().manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        q, k = (torch.randn(2, 16, 32, 32, generator=gen).to(device, dtype) for _ in range(2))
        v = torch.randn(2, 16, 32, 256, generator=gen).to(device, dtype)
        assert torch.equal(torch.ops.rnd_seg_torch.cc_attention_fwd(q, k, v),
                           ccattn.cc_attention_core_cuda(q, k, v))
        x = torch.randn(2, 24, 37, 21, generator=gen).to(device, dtype)
        w_exp = (torch.randn(72, 24, generator=gen) * 0.2).to(device, dtype)
        w_dw = (torch.randn(72, 5, 5, generator=gen) * 0.2).to(device)
        s0, b0, s1, b1 = (torch.rand(72, generator=gen).to(device) + 0.5 for _ in range(4))
        args = (x, w_exp, s0, b0, w_dw, s1, b1)
        assert torch.equal(torch.ops.rnd_seg_torch.fused_mbconv_fwd(*args),
                           mbconv.fused_mbconv_core_cuda(*args))
    before = ccattn.KERNEL_LAUNCHES
    with torch.no_grad():
        ccattn.cc_attention_core(q, k, v)
    assert ccattn.KERNEL_LAUNCHES == before + 1  # the eval path launches through the op


@pytest.mark.cuda
@pytest.mark.parametrize("name,side,quant", [("deeplab_resnet18", 64, "int8"),
                                             ("gald_hardnet68", 224, "none")])
def test_a_cuda_export_loads_and_runs(name, side, quant, tmp_path):
    device = _card()
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", name, "MODEL.NUM_CLASSES", "3",
                         "INPUT.INPUT_SIZE_TEST", f"({side}, {side})",
                         "resume", str(tmp_path / "seeded.pth")])
    tester = Tester(cfg, logging.getLogger("torch_quant_cuda"))
    randomize_weights_(tester.segmentor, seed=3)
    tester.segmentor.to(device)
    images = np.random.RandomState(3).rand(2, side, side, 3).astype(np.float32)
    x = torch.from_numpy(images).to(device).permute(0, 3, 1, 2).contiguous()
    qctx = None
    if quant == "int8":
        qctx = pq.calibrate_segmentor(tester.segmentor, [x],
                                      pq.QuantConfig(mode="int8", calib_batches=1))
    meta = export_eval(tester, 2, str(tmp_path / "program"), quant_ctx=qctx)
    assert meta["platforms"] == ["cuda"] and meta["quant"] == quant
    call, _ = load_exported(str(tmp_path / "program"))
    with pq.quant_scope(qctx):
        want = tester._probs_impl(x, (side, side)).argmax(1).cpu().numpy()
    np.testing.assert_array_equal(call(images), want)
