"""The exact conv rewrites of the port (ops/s2d.py, ops/subpixel.py and their
hooks in models/layers.py) against the plain convs and the JAX package's
functions, on the CPU in float32.

  * ``space_to_depth``/``depth_to_space`` equal the JAX ones bit for bit;
    ``s2d_supported`` and ``s2d_applies`` give the JAX answers on a grid of
    shapes;
  * ``conv2d_s2d`` and ``conv_transpose_subpixel`` against ``F.conv2d`` /
    ``F.conv_transpose2d`` and against the JAX functions on the same
    weights: outputs within 1e-5 and the gradients on input and weight
    within 1e-4 of their magnitude;
  * the layers take the rewrite exactly where the knob and the gate say,
    and give the plain layer's output and gradients;
  * the attn family (``attn_efficientnet-b0`` at 64 x 64) under
    MODEL.SUBPIXEL_DECONV: logits within 2e-4 of the knob off (the JAX
    package's whole-model tolerance, tests/test_subpixel.py) and of the JAX
    model under ``subpixel_scope``.  PraNet and GALD under
    MODEL.S2D_MAX_CHANNELS are in tests/test_torch_rewrites_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from rnd_semantic_segmentation_tpu.ops import s2d as jax_s2d
from rnd_semantic_segmentation_tpu.ops import subpixel as jax_subpixel

from rnd_semantic_segmentation_torch.models import layers
from rnd_semantic_segmentation_torch.models.build import set_conv_rewrites
from rnd_semantic_segmentation_torch.ops import s2d, subpixel

from test_torch_rewrites_models import hold_family

torch.set_num_threads(2)  # six test workers share the host's cores

OUT_REL, GRAD_REL = 1e-5, 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _nhwc(t):
    return np.ascontiguousarray(t.detach().permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("b", [2, 3])
def test_space_to_depth_is_the_jax_one(b):
    x = np.random.RandomState(0).randn(2, 6 * b // 2 * 2, 4 * b, 5).astype(np.float32)
    got = s2d.space_to_depth(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), b)
    want = np.asarray(jax_s2d.space_to_depth(jnp.asarray(x), b))
    np.testing.assert_array_equal(_nhwc(got), want)
    back = s2d.depth_to_space(torch.from_numpy(want.transpose(0, 3, 1, 2).copy()), b)
    np.testing.assert_array_equal(_nhwc(back), x)


def test_gates_give_the_jax_answers():
    cases = 0
    for h in (1, 2, 7, 8):
        for k in (1, 2, 3, 5):
            for stride in (1, 2, 3):
                for pad in (0, 1, 2):
                    for dil, groups in ((1, 1), (2, 1), (1, 2)):
                        for cin, cout, limit in ((8, 16, 16), (32, 8, 16), (8, 8, 0)):
                            x_shape, w_shape = (1, cin, h, h + 2), (cout, cin // groups, k, k)
                            args = ((stride, stride), (pad, pad), (dil, dil), groups)
                            jx = ((1, h, h + 2, cin), (k, k, cin // groups, cout),
                                  (stride, stride), ((pad, pad), (pad, pad)), (dil, dil), groups)
                            assert s2d.s2d_supported(x_shape, w_shape, *args) == \
                                jax_s2d.s2d_supported(*jx)
                            with jax_s2d.s2d_scope(limit):
                                assert s2d.s2d_applies(x_shape, w_shape, *args, limit) == \
                                    jax_s2d.s2d_applies(*jx)
                            cases += 1
    assert cases == 4 * 4 * 3 * 3 * 3 * 3


def _grads(fn, x, w, g):
    x = torch.from_numpy(x).requires_grad_()
    w = torch.from_numpy(w).requires_grad_()
    y = fn(x, w)
    (y * torch.from_numpy(g)).sum().backward()
    return y.detach().numpy(), x.grad.numpy(), w.grad.numpy()


@pytest.mark.parametrize("h,w,k,stride,pad", [(8, 8, 3, 1, 1), (10, 12, 3, 2, 1),
                                             (10, 10, 5, 1, 2), (12, 10, 7, 2, 3),
                                             (10, 8, 3, 1, 0), (9, 11, 3, 1, 1)])
def test_conv2d_s2d_against_the_plain_conv_and_jax(h, w, k, stride, pad):
    rng = np.random.RandomState(h * w + k)
    x = rng.randn(2, 6, h, w).astype(np.float32)
    weight = (rng.randn(5, 6, k, k) / k).astype(np.float32)
    supported = s2d.s2d_supported(x.shape, weight.shape, stride, pad, 1, 1)
    assert supported == ((h + 2 * pad) % 2 == 0 and (w + 2 * pad) % 2 == 0)
    if not supported:
        return
    plain = F.conv2d(torch.from_numpy(x), torch.from_numpy(weight), None, stride, pad)
    g = rng.randn(*plain.shape).astype(np.float32)
    ref = _grads(lambda a, b: F.conv2d(a, b, None, stride, pad), x, weight, g)
    got = _grads(lambda a, b: s2d.conv2d_s2d(a, b, stride, pad), x, weight, g)
    assert _rel(got[0], ref[0]) <= OUT_REL
    for have, want in zip(got[1:], ref[1:]):
        assert _rel(have, want) <= GRAD_REL

    def jax_fn(xj, kj):
        y = jax_s2d.conv2d_s2d(xj, kj, (stride, stride), ((pad, pad), (pad, pad)))
        return jnp.sum(y * jnp.asarray(g.transpose(0, 2, 3, 1))), y

    (_, y), (gx, gk) = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(weight.transpose(2, 3, 1, 0)))
    assert _rel(got[0], np.asarray(y).transpose(0, 3, 1, 2)) <= OUT_REL
    assert _rel(got[1], np.asarray(gx).transpose(0, 3, 1, 2)) <= GRAD_REL
    assert _rel(got[2], np.asarray(gk).transpose(3, 2, 0, 1)) <= GRAD_REL


@pytest.mark.parametrize("h,w,k,stride,pad,op", [(8, 8, 4, 2, 1, 0), (5, 7, 3, 2, 1, 1),
                                                (5, 5, 2, 2, 0, 0), (4, 6, 5, 3, 2, 1),
                                                (7, 5, 3, 2, 0, 0)])
def test_conv_transpose_subpixel_against_the_plain_conv_and_jax(h, w, k, stride, pad, op):
    rng = np.random.RandomState(h + w * k)
    x = rng.randn(2, 6, h, w).astype(np.float32)
    weight = (rng.randn(6, 4, k, k) / k).astype(np.float32)      # IOHW
    plain = F.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(weight), None, stride,
                               pad, op)
    g = rng.randn(*plain.shape).astype(np.float32)
    ref = _grads(lambda a, b: F.conv_transpose2d(a, b, None, stride, pad, op), x, weight, g)
    got = _grads(lambda a, b: subpixel.conv_transpose_subpixel(a, b, stride, pad, op),
                 x, weight, g)
    assert _rel(got[0], ref[0]) <= OUT_REL
    for have, want in zip(got[1:], ref[1:]):
        assert _rel(have, want) <= GRAD_REL
    # the JAX kernel is the weight in correlation orientation: flipped, HWIO
    corr = np.ascontiguousarray(weight[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))

    def jax_fn(xj, kj):
        y = jax_subpixel.conv_transpose_subpixel(xj, kj, (stride, stride), (pad, pad), op)
        return jnp.sum(y * jnp.asarray(g.transpose(0, 2, 3, 1))), y

    (_, y), (gx, gk) = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(corr))
    assert _rel(got[0], np.asarray(y).transpose(0, 3, 1, 2)) <= OUT_REL
    assert _rel(got[1], np.asarray(gx).transpose(0, 3, 1, 2)) <= GRAD_REL
    gk = np.asarray(gk).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    assert _rel(got[2], gk) <= GRAD_REL
    # and the JAX package's own dilated lowering agrees with torch
    dilated = lax.conv_general_dilated(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(corr), (1, 1),
        ((k - 1 - pad, k - 1 - pad + op), (k - 1 - pad, k - 1 - pad + op)),
        lhs_dilation=(stride, stride), dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert _rel(np.asarray(dilated).transpose(0, 3, 1, 2), ref[0]) <= OUT_REL


def _count(monkeypatch, name):
    calls = []
    real = getattr(layers, name)
    monkeypatch.setattr(layers, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_layers_take_the_rewrites_where_the_knobs_say(monkeypatch):
    s2d_calls = _count(monkeypatch, "conv2d_s2d")
    sub_calls = _count(monkeypatch, "conv_transpose_subpixel")
    torch.manual_seed(0)
    net = torch.nn.Sequential(
        layers.Conv2d(3, 16, 3, 2, padding=1),            # stride 2: rewritten
        layers.Conv2d(16, 16, 3, padding=1, bias=False),  # rewritten
        layers.Conv2d(16, 32, 3, padding=1),              # 32 > 16: plain
        layers.Conv2d(32, 16, 1),                          # 1x1: plain
        layers.Conv2d(16, 16, 3, padding=2, dilation=2),  # dilated: plain
        layers.ConvTranspose2d(16, 8, 4, 2, padding=1),   # sub-pixel
        layers.ConvTranspose2d(8, 8, 3, 1, padding=1))    # stride 1: plain
    x = torch.randn(2, 3, 16, 20)
    ref = net(x)
    ref.square().sum().backward()
    ref_grads = [p.grad.clone() for p in net.parameters()]
    net.zero_grad()
    assert set_conv_rewrites(net, 16, True) == 7
    got = net(x)
    got.square().sum().backward()
    assert (len(s2d_calls), len(sub_calls)) == (2, 1)
    assert _rel(got.detach(), ref.detach()) <= OUT_REL
    for p, g in zip(net.parameters(), ref_grads):
        assert _rel(p.grad, g) <= GRAD_REL
    set_conv_rewrites(net, 0, False)
    net(x)
    assert (len(s2d_calls), len(sub_calls)) == (2, 1)


def test_attn_under_subpixel_deconv():
    """Five transposed convs of the attn decoder take the rewrite."""
    gap, counts = hold_family("attn_efficientnet-b0", 64, "MODEL.SUBPIXEL_DECONV", "True")
    assert counts == (0, 5) and gap <= 2e-4


def test_export_under_both_rewrites(tmp_path):
    """``torch.export`` of the attn eval head (b0 at 64, MODEL.FUSED_MBCONV)
    with MODEL.S2D_MAX_CHANNELS 32 and MODEL.SUBPIXEL_DECONV: the program
    holds the rewrites (their gather indexes are buffers of the layers), and
    its class ids equal the Tester's with the knobs on every pixel and the
    knobs-off Tester's on all but 2e-4 of them."""
    import logging

    from rnd_semantic_segmentation_torch.ckpt.torch_import import save_reference_checkpoint
    from rnd_semantic_segmentation_torch.configs import get_default_cfg
    from rnd_semantic_segmentation_torch.eval.tester import Tester
    from rnd_semantic_segmentation_torch.models.build import randomize_weights_
    from rnd_semantic_segmentation_torch.serve.export import export_eval, load_exported

    pth = str(tmp_path / "attn.pth")

    def tester(*knobs):
        cfg = get_default_cfg()
        cfg.merge_from_list(["MODEL.NAME", "attn_efficientnet-b0", "MODEL.NUM_CLASSES", "2",
                             "MODEL.DEVICE", "cpu", "MODEL.FUSED_MBCONV", "True",
                             "INPUT.INPUT_SIZE_TEST", "(64, 64)", "OUTPUT_DIR", str(tmp_path),
                             "resume", pth, *knobs])
        return Tester(cfg, logging.getLogger("torch_rewrites"))

    seeded = tester()
    randomize_weights_(seeded.segmentor, seed=8)
    save_reference_checkpoint(seeded.spec.modules, pth)
    plain, rewritten = tester(), tester("MODEL.S2D_MAX_CHANNELS", "32",
                                        "MODEL.SUBPIXEL_DECONV", "True")
    for t in (plain, rewritten):
        t._load_checkpoint()
    images = np.random.RandomState(9).rand(2, 64, 64, 3).astype(np.float32)
    x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
    ids = {name: t._probs_impl(x, (64, 64)).argmax(1).numpy()
           for name, t in (("plain", plain), ("rewritten", rewritten))}
    prefix = str(tmp_path / "exported")
    export_eval(rewritten, 2, prefix)
    call, _ = load_exported(prefix)
    np.testing.assert_array_equal(call(images), ids["rewritten"])
    assert (ids["plain"] != ids["rewritten"]).mean() <= 2e-4
    graph = str(torch.export.load(prefix + ".pt2").graph)
    assert "s2d_taps" in graph and "subpixel_taps" in graph
