"""The port's fused MBConv segment (rnd_semantic_segmentation_torch/ops/mbconv.py)
against the JAX package's (rnd_semantic_segmentation_tpu/ops/mbconv.py).

On the CPU the wrapper takes its plain version, so these tests hold the plain
version against the JAX oracle ``fused_mbconv_core_jnp`` and against the Pallas
kernel in interpret mode, on the same numpy inputs.  The port's layout is NCHW
and the JAX package's NHWC; the helpers transpose.  float32 tolerance: 1e-4
absolute and relative, as in tests/test_mbconv.py — float32 sums over up to 24
products and 25 taps in other orders.  bfloat16: 0.05, the rounding of the
output (and, in the Pallas kernel, of the staged expand value) to 8 mantissa
bits.  The CUDA kernel itself is compared with the plain version on the card
by the tests marked ``cuda`` (and by chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rnd_semantic_segmentation_tpu.ops.mbconv import (
    fused_mbconv_core_jnp,
    fused_mbconv_core_pallas,
)

from rnd_semantic_segmentation_torch.models.build import randomize_weights_
from rnd_semantic_segmentation_torch.models.efficientnet import MBConvBlock, block_list
from rnd_semantic_segmentation_torch.ops import mbconv
from rnd_semantic_segmentation_torch.ops.mbconv import (
    fused_mbconv_applies,
    fused_mbconv_core,
    fused_mbconv_core_cuda,
    fused_mbconv_core_plain,
)

torch.set_num_threads(2)  # six test workers share the host's cores

TOL = 1e-4
SHAPES = [((2, 16, 16, 8), 3), ((1, 12, 20, 16), 5), ((2, 8, 8, 24), 3)]  # NHWC, k
# every fused shape of an EfficientNet-B2 forward at 512x512, as (C, H=W, k)
B2_SHAPES = [(24, 128, 3), (48, 64, 5), (88, 32, 3), (88, 32, 5), (120, 32, 5),
             (208, 16, 5), (208, 16, 3), (352, 16, 3)]
ODD_SHAPES = [(2, 8, 7, 11, 3), (1, 16, 3, 5, 5), (2, 24, 37, 21, 5)]  # B, C, H, W, k
# (b, c, h, w, k, f, x scale, x at an offset of one element)
EDGE_CASES = {
    "tf32-sensitive": (1, 352, 8, 8, 3, 48, 20.0, False),
    "c12": (2, 12, 9, 9, 3, 36, 1.0, False),
    "c20": (2, 20, 12, 10, 5, 60, 1.0, False),
    "f50": (1, 16, 16, 16, 3, 50, 1.0, False),
    "hw17": (2, 24, 17, 17, 5, 72, 1.0, False),
    "hw33": (1, 24, 33, 33, 3, 72, 1.0, False),
    "h17-w33": (1, 24, 17, 33, 5, 72, 1.0, False),
    "offset-view": (2, 24, 16, 16, 3, 72, 1.0, True),
    "offset-view-odd": (1, 20, 12, 20, 5, 60, 1.0, True),
    "smaller-than-halo": (2, 16, 2, 3, 5, 48, 1.0, False),
    "one-pixel": (1, 40, 1, 1, 3, 120, 1.0, False),
}


def _inputs(seed, b, h, w, c, f, k):
    """numpy NHWC inputs in the JAX argument order, with affines far from the
    identity: a bias of up to 0.5 makes the expand value of a padded position,
    swish(b0), visibly nonzero."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32) * 0.5
    we = rng.randn(c, f).astype(np.float32) * 0.3
    wd = rng.randn(k, k, f).astype(np.float32) * 0.3
    s0, s1 = (rng.uniform(0.5, 1.5, f).astype(np.float32) for _ in range(2))
    b0, b1 = (rng.uniform(-0.5, 0.5, f).astype(np.float32) for _ in range(2))
    return x, we, s0, b0, wd, s1, b1


def _to_port(args, dtype=torch.float32):
    """JAX-order NHWC numpy inputs -> the port's NCHW tensors."""
    x, we, s0, b0, wd, s1, b1 = args
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(x.transpose(0, 3, 1, 2)).to(dtype), t(we.T).to(dtype), t(s0), t(b0),
            t(wd.transpose(2, 0, 1)), t(s1), t(b1))


def _nhwc(y: torch.Tensor) -> np.ndarray:
    return y.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape,k", SHAPES)
def test_plain_matches_jnp_oracle(shape, k):
    b, h, w, c = shape
    args = _inputs(0, b, h, w, c, 3 * c, k)
    ref = np.asarray(fused_mbconv_core_jnp(*(jnp.asarray(a) for a in args)))
    out = fused_mbconv_core(*_to_port(args))  # CPU tensors: the plain version
    assert out.shape == (b, 3 * c, h, w) and out.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(out), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,k", SHAPES)
def test_plain_matches_pallas_kernel_in_interpret_mode(shape, k):
    b, h, w, c = shape
    args = _inputs(1, b, h, w, c, 3 * c, k)
    ref = np.asarray(fused_mbconv_core_pallas(*(jnp.asarray(a) for a in args),
                                              interpret=True))
    np.testing.assert_allclose(_nhwc(fused_mbconv_core_plain(*_to_port(args))), ref,
                               rtol=TOL, atol=TOL)


def test_plain_matches_pallas_kernel_over_several_tiles():
    """A small VMEM budget makes the Pallas kernel cut H into tiles of 4 rows:
    its halo rows and edge masks against the plain version's zero padding."""
    b, h, w, c, f, k = 1, 16, 12, 8, 16, 3
    args = _inputs(2, b, h, w, c, f, k)
    budget = (h + 2) * (w + 2) * c * 2 + 6 * (w + 2) * f * 4 + 4 * w * f * 4
    ref = np.asarray(fused_mbconv_core_pallas(*(jnp.asarray(a) for a in args),
                                              interpret=True, vmem_budget=budget))
    np.testing.assert_allclose(_nhwc(fused_mbconv_core_plain(*_to_port(args))), ref,
                               rtol=TOL, atol=TOL)


def test_plain_in_bfloat16_matches_both_jax_versions():
    args = _inputs(3, 1, 8, 8, 8, 24, 3)
    jargs = tuple(jnp.asarray(a).astype(jnp.bfloat16) if i in (0, 1, 4) else jnp.asarray(a)
                  for i, a in enumerate(args))
    out = fused_mbconv_core_plain(*_to_port(args, torch.bfloat16))
    assert out.dtype == torch.bfloat16
    for ref in (fused_mbconv_core_jnp(*jargs),
                fused_mbconv_core_pallas(*jargs, interpret=True)):
        np.testing.assert_allclose(_nhwc(out), np.asarray(ref, np.float32),
                                   rtol=0.05, atol=0.05)


@pytest.mark.parametrize("k", [3, 5])
def test_border_pixels_on_their_own(k):
    """TF-SAME needs the expand value to be zero outside the image, where a
    naive fusion would see swish(b0).  Only the ring of width (k-1)/2 can show
    that, so it is compared apart from the interior, and it must differ from
    what the wrong padding would give."""
    b, h, w, c, f = 2, 9, 14, 8, 24
    p = (k - 1) // 2
    args = _inputs(4, b, h, w, c, f, k)
    ref = np.asarray(fused_mbconv_core_jnp(*(jnp.asarray(a) for a in args)))
    pargs = _to_port(args)
    out = _nhwc(fused_mbconv_core_plain(*pargs))
    ring = np.ones((h, w), bool)
    ring[p:h - p, p:w - p] = False
    np.testing.assert_allclose(out[:, ring], ref[:, ring], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out[:, ~ring], ref[:, ~ring], rtol=TOL, atol=TOL)

    # the wrong version: expand the zero-padded input, so the ring holds swish(b0)
    x, w_exp, s0, b0, w_dw, s1, b1 = pargs
    xp = torch.nn.functional.pad(x, (p, p, p, p))
    e = torch.einsum("bchw,fc->bfhw", xp, w_exp) * s0.view(1, -1, 1, 1) + b0.view(1, -1, 1, 1)
    y = torch.nn.functional.conv2d(mbconv.swish(e), w_dw[:, None], groups=f)
    wrong = _nhwc(mbconv.swish(y * s1.view(1, -1, 1, 1) + b1.view(1, -1, 1, 1)))
    assert np.abs(wrong[:, ring] - ref[:, ring]).max() > 100 * TOL
    np.testing.assert_allclose(wrong[:, ~ring], ref[:, ~ring], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("h,w", [(3, 5), (1, 1), (4, 2)])
def test_image_smaller_than_the_stencil(h, w):
    args = _inputs(5, 2, h, w, 16, 48, 5)
    jargs = tuple(jnp.asarray(a) for a in args)
    out = _nhwc(fused_mbconv_core_plain(*_to_port(args)))
    np.testing.assert_allclose(out, np.asarray(fused_mbconv_core_jnp(*jargs)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        out, np.asarray(fused_mbconv_core_pallas(*jargs, interpret=True)),
        rtol=TOL, atol=TOL)


def test_applies_gate():
    assert fused_mbconv_applies((2, 16, 64, 64), 3, 96)
    assert fused_mbconv_applies((1, 512, 8, 4096), 5, 16384)  # no size limit on the card
    assert not fused_mbconv_applies((2, 16, 64, 64), 4, 96)   # even k
    assert not fused_mbconv_applies((2, 16, 64, 64), 7, 96)   # odd, but no kernel built
    assert not fused_mbconv_applies((16, 64, 64), 3, 96)      # not 4-D


def _valid():
    return list(_to_port(_inputs(6, 1, 6, 6, 8, 24, 3)))


def _bad(index, change):
    args = _valid()
    args[index] = change(args[index])
    return args


@pytest.mark.parametrize("args,error", [
    (_bad(0, lambda x: x.double()), TypeError),                       # x float64
    (_bad(1, lambda w: w.bfloat16()), TypeError),                     # w_exp not x's type
    (_bad(2, lambda s: s.bfloat16()), TypeError),                     # affine not float32
    (_bad(4, lambda w: w.bfloat16()), TypeError),                     # w_dw not float32
    (_bad(0, lambda x: x[0]), ValueError),                            # x not 4-D
    (_bad(0, lambda x: x.permute(0, 1, 3, 2)), ValueError),           # x not contiguous
    (_bad(1, lambda w: w[:, :4]), ValueError),                        # w_exp not contiguous
    (_bad(1, lambda w: w[:, :4].contiguous()), ValueError),           # w_exp [F, C'] != C
    (_bad(4, lambda w: w[:, :2, :2].contiguous()), ValueError),       # even k
    (_bad(4, lambda w: w.new_zeros(24, 7, 7)), ValueError),           # k the kernel lacks
    (_bad(4, lambda w: w[:12].contiguous()), ValueError),             # w_dw [F', k, k]
    (_bad(5, lambda s: s[:12].contiguous()), ValueError),             # affine [F']
    (_bad(3, lambda b: b.to("meta")), ValueError),                    # mixed devices
    (_valid(), ValueError),                                           # CPU tensors
], ids=["x-float64", "w_exp-type", "affine-type", "w_dw-type", "x-3d", "x-strided",
        "w_exp-strided", "w_exp-width", "even-k", "k-not-built", "w_dw-channels",
        "affine-length", "mixed-devices", "cpu-tensors"])
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(args, error):
    before = mbconv.KERNEL_LAUNCHES
    with pytest.raises(error):
        fused_mbconv_core_cuda(*args)
    assert mbconv.KERNEL_LAUNCHES == before


def test_dispatch_takes_the_plain_version_only_for_cpu_tensors(monkeypatch):
    calls = []
    monkeypatch.setattr(mbconv, "fused_mbconv_core_cuda",
                        lambda *a: calls.append("cuda") or a[0])
    # a copy: without autograd the CPU call goes through the operator
    # fused_mbconv_fwd, whose output may not alias an input
    monkeypatch.setattr(mbconv, "fused_mbconv_core_plain",
                        lambda *a: calls.append("plain") or a[0].clone())
    fused_mbconv_core(*_valid())
    fused_mbconv_core(*_bad(0, lambda x: x.to("meta")))
    assert calls == ["plain", "cuda"]


def _block(kernel=3, fused=True):
    block = MBConvBlock(in_filters=8, out_filters=8, kernel=kernel, stride=1,
                        expand_ratio=6, se_ratio=0.25, fused_mbconv=fused)
    randomize_weights_(block, seed=kernel)
    with torch.no_grad():  # running statistics far from (0, 1), so the fold matters
        for bn in (block._bn0, block._bn1, block._bn2):
            n = bn.num_features
            bn.running_mean += 0.3 * torch.arange(n) / n
            bn.running_var += 0.3 * torch.arange(n).flip(0) / n
    return block


@pytest.mark.parametrize("kernel", [3, 5])
def test_mbconv_block_fused_matches_unfused(kernel, monkeypatch):
    block = _block(kernel).eval()
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 8, 16, 16).astype(np.float32))
    calls = []
    core = mbconv.fused_mbconv_core
    from rnd_semantic_segmentation_torch.models import efficientnet
    monkeypatch.setattr(efficientnet, "fused_mbconv_core",
                        lambda *a: calls.append(a[0].shape) or core(*a))
    with torch.no_grad():
        out = block(x)
        assert calls == [x.shape]
        block.fused_mbconv = False
        ref = block(x)
    assert calls == [x.shape]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=TOL, atol=TOL)

    # a checkpoint loaded after construction is honoured: the fold reads the live buffers
    block.fused_mbconv = True
    with torch.no_grad():
        block._bn0.running_var.mul_(4.0)
        block._bn1.bias.add_(0.5)
        moved = block(x)
        block.fused_mbconv = False
        np.testing.assert_allclose(moved.numpy(), block(x).numpy(), rtol=TOL, atol=TOL)
    assert (moved - out).abs().max() > 0.01


def _count_folds(monkeypatch):
    from rnd_semantic_segmentation_torch.models import efficientnet
    calls = []
    fold = efficientnet.fold_bn
    monkeypatch.setattr(efficientnet, "fold_bn", lambda bn: calls.append(bn) or fold(bn))
    return lambda: len(calls) // 2  # one fold reads both BatchNorms


def test_mbconv_block_folds_once_per_weight_state(monkeypatch):
    folds = _count_folds(monkeypatch)
    block = _block().eval()
    x = torch.from_numpy(np.random.RandomState(9).randn(1, 8, 10, 10).astype(np.float32))
    with torch.no_grad():
        first, second = block(x), block(x)
        assert folds() == 1
        block(x.to(torch.bfloat16).float())  # same dtype after the round trip: no refold
        assert folds() == 1
    torch.testing.assert_close(first, second, rtol=0, atol=0)


def test_mbconv_block_refolds_after_load_state_dict(monkeypatch):
    folds = _count_folds(monkeypatch)
    block = _block().eval()
    x = torch.from_numpy(np.random.RandomState(10).randn(1, 8, 10, 10).astype(np.float32))
    state = {k: v.clone() for k, v in block.state_dict().items()}
    state["_bn1.running_var"] *= 3.0
    state["_expand_conv.weight"] *= -1.0
    with torch.no_grad():
        before = block(x)
        block.load_state_dict(state)
        after = block(x)
        assert folds() == 2
        block.fused_mbconv = False
        np.testing.assert_allclose(after.numpy(), block(x).numpy(), rtol=TOL, atol=TOL)
    assert (after - before).abs().max() > 0.01


def test_mbconv_block_refolds_after_train_then_eval(monkeypatch):
    folds = _count_folds(monkeypatch)
    block = _block().eval()
    x = torch.from_numpy(np.random.RandomState(11).randn(2, 8, 10, 10).astype(np.float32))
    with torch.no_grad():
        block(x)
        block.train()(x)       # batch statistics: updates the running buffers
        assert folds() == 1    # train mode never folds
        out = block.eval()(x)
        assert folds() == 2
        block.fused_mbconv = False
        np.testing.assert_allclose(out.numpy(), block(x).numpy(), rtol=TOL, atol=TOL)


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def test_tolerance_catches_a_single_tf32_pass():
    """The float32 tolerance (1e-4 + 1e-4*|plain|) holds the kernel to
    float32 accuracy: the plain version on x and w_exp rounded to TF32, which
    is what one TF32 pass of the product sees, misses it, while the plain
    version itself agrees with the JAX oracle.  The inputs are the
    "tf32-sensitive" case of the kernel test below: C=352 (the widest fused
    product of B2) with |x| around 10."""
    b, c, h, w, k, f, scale, _ = EDGE_CASES["tf32-sensitive"]
    args = list(_to_port(_inputs(9, b, h, w, c, f, k)))
    args[0] = args[0] * scale
    ref = fused_mbconv_core_plain(*args)
    assert _round_tf32(torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12])).tolist() == [
        1.0 + 2.0 ** -10, 1.0]
    rounded = fused_mbconv_core_plain(_round_tf32(args[0]), _round_tf32(args[1]), *args[2:])
    bad = (rounded - ref).abs() > TOL + TOL * ref.abs()
    assert bad.float().mean() > 0.05
    jargs = [a.numpy() for a in args]
    oracle = fused_mbconv_core_jnp(jnp.asarray(jargs[0].transpose(0, 2, 3, 1)),
                                   jnp.asarray(jargs[1].T), *(jnp.asarray(a) for a in jargs[2:4]),
                                   jnp.asarray(jargs[4].transpose(1, 2, 0)),
                                   *(jnp.asarray(a) for a in jargs[5:]))
    np.testing.assert_allclose(_nhwc(ref), np.asarray(oracle), rtol=TOL, atol=TOL)


def test_train_mode_and_ineligible_blocks_never_take_the_fused_path(monkeypatch):
    from rnd_semantic_segmentation_torch.models import efficientnet

    def boom(*a):
        raise AssertionError("the fused core was called")
    monkeypatch.setattr(efficientnet, "fused_mbconv_core", boom)
    x = torch.from_numpy(np.random.RandomState(8).randn(4, 8, 12, 12).astype(np.float32))
    fused, plain = _block(fused=True).train(), _block(fused=False).train()
    out, ref = fused(x), plain(x)  # batch statistics, running statistics updated
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(fused._bn1.running_var, plain._bn1.running_var, rtol=0, atol=0)
    assert out.requires_grad
    for kwargs in (dict(stride=2, expand_ratio=6), dict(stride=1, expand_ratio=1)):
        block = MBConvBlock(8, 8, 3, se_ratio=0.25, fused_mbconv=True, **kwargs).eval()
        with torch.no_grad():
            block(x)


def test_b2_block_list_gives_the_17_fused_launches():
    hw, shapes = 256, []
    for k, stride, expand, c_in, _, _ in block_list("efficientnet-b2"):
        hw = -(-hw // stride)
        if expand != 1 and stride == 1:
            shapes.append((c_in, hw, k))
    assert len(block_list("efficientnet-b2")) == 23 and len(shapes) == 17
    assert sorted(set(shapes)) == sorted(B2_SHAPES)


# -- on the card --------------------------------------------------------------

def _cuda_inputs(b, c, h, w, k, f, dtype):
    """``_inputs`` with seed 9 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _to_port(_inputs(9, b, h, w, c, f, k), dtype)
    return tuple(a.cuda() for a in args)


def _assert_kernel_matches_plain(args, dtype):
    before = mbconv.KERNEL_LAUNCHES
    out = fused_mbconv_core(*args)
    torch.cuda.synchronize()
    assert mbconv.KERNEL_LAUNCHES == before + 1
    ref = fused_mbconv_core_plain(*args)
    assert out.dtype == dtype and out.shape == ref.shape
    # float32: sums in another order; bfloat16: outputs round to 8 mantissa bits
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (3e-2, 1e-2)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("c,hw,k", B2_SHAPES)
def test_cuda_kernel_matches_plain_at_the_b2_shapes(c, hw, k, batch, dtype):
    _assert_kernel_matches_plain(_cuda_inputs(batch, c, hw, hw, k, 6 * c, dtype), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,c,h,w,k", ODD_SHAPES + [(1, 8, 20, 33, 3), (3, 40, 1, 1, 5)])
def test_cuda_kernel_matches_plain_at_odd_shapes(b, c, h, w, k, dtype):
    _assert_kernel_matches_plain(_cuda_inputs(b, c, h, w, k, 3 * c, dtype), dtype)




@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_cuda_kernel_matches_plain_at_edge_cases(case, dtype):
    """C no multiple of the mma's K step, F no multiple of the channel chunk,
    maps just past a tile edge, x at an address aligned only to its element,
    images smaller than the halo, and inputs where one TF32 pass would fail."""
    b, c, h, w, k, f, scale, offset = EDGE_CASES[case]
    args = list(_cuda_inputs(b, c, h, w, k, f, dtype))
    x = args[0] * scale
    if offset:
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=x.device)
        buf[1:].copy_(x.flatten())
        x = buf[1:].view(x.shape)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    args[0] = x
    _assert_kernel_matches_plain(tuple(args), dtype)


@pytest.mark.cuda
def test_cuda_wrapper_raises_under_grad_mode():
    args = list(_cuda_inputs(1, 8, 6, 6, 3, 24, torch.float32))
    args[1] = args[1].requires_grad_()
    before = mbconv.KERNEL_LAUNCHES
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_mbconv_core(*args)
    assert mbconv.KERNEL_LAUNCHES == before
    with torch.no_grad():
        assert not fused_mbconv_core(*args).requires_grad
    assert mbconv.KERNEL_LAUNCHES == before + 1
