"""The port's criss-cross attention core against the JAX package's.

``cc_attention_core_plain`` (rnd_semantic_segmentation_torch/ops/ccattn.py) is
held against the JAX einsum oracle ``cc_attention_core_jnp`` and against the
Pallas kernel run in interpret mode, on the same numpy inputs.  On the CPU the
port's dispatcher takes the plain version; the CUDA kernel is held against the
plain version on the card (the ``cuda``-marked test below, and chip_smoke.py).

Tolerances: float32 at atol 1e-5 + rtol 1e-5 — both sides compute the same
sums in float32 in different orders, and outputs are O(1).  bfloat16 at atol
2e-2: inputs round identically, the math runs in float32, and the outputs
round to bfloat16 (8 bits of mantissa, so one ulp is 1.6e-2 at magnitude 2-4).

The backward: ``cc_attention_core_bwd_plain`` is held against ``jax.vjp`` of the
JAX oracle, against the Pallas backward kernel in interpret mode and against
``torch.autograd.grad`` of the plain forward.  Gradients here reach magnitudes
of 5 to 50 (sums over H+W keys and up to 64 channels of O(1) products), so the
float32 tolerance is 1e-5 of the reference's largest magnitude plus rtol 1e-5.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax

from rnd_semantic_segmentation_tpu.ops.ccattn import (
    cc_attention_core_jnp,
    cc_attention_core_pallas,
    cc_attention_core_pallas_bwd,
)
from rnd_semantic_segmentation_torch.ops import ccattn

# (B, H, W, C): square, rectangular and odd, the serving aspect, and H=1
# (a column branch that is fully masked inside the joint softmax)
SHAPES = [(2, 8, 8, 16), (1, 7, 11, 32), (2, 16, 32, 64), (1, 1, 5, 16)]


def _inputs(shape, seed=0):
    b, h, w, c = shape
    cq = max(c // 8, 1)
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, cq).astype(np.float32),
            rng.randn(b, h, w, cq).astype(np.float32),
            rng.randn(b, h, w, c).astype(np.float32))


def _port(arrays, dtype=torch.float32):
    return ccattn.cc_attention_core_plain(
        *(torch.from_numpy(a).to(dtype) for a in arrays))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jnp_oracle(shape):
    arrays = _inputs(shape)
    ref = np.asarray(cc_attention_core_jnp(*(jnp.asarray(a) for a in arrays)))
    out = _port(arrays).numpy()
    assert out.shape == shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape):
    arrays = _inputs(shape, seed=1)
    ref = np.asarray(cc_attention_core_pallas(*(jnp.asarray(a) for a in arrays),
                                              interpret=True))
    np.testing.assert_allclose(_port(arrays).numpy(), ref, atol=1e-5, rtol=1e-5)


def test_plain_bf16_matches_jnp_oracle():
    arrays = _inputs((2, 8, 12, 32), seed=2)
    ref = cc_attention_core_jnp(*(jnp.asarray(a, jnp.bfloat16) for a in arrays))
    out = _port(arrays, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=2e-2, rtol=0)


def test_cpu_tensors_take_the_plain_version_uncounted():
    arrays = _inputs((1, 4, 6, 16))
    before = ccattn.KERNEL_LAUNCHES
    out = ccattn.cc_attention_core(*(torch.from_numpy(a) for a in arrays))
    assert ccattn.KERNEL_LAUNCHES == before
    torch.testing.assert_close(out, _port(arrays), atol=0, rtol=0)


@pytest.mark.parametrize("case", ["float64", "noncontiguous", "shapes",
                                  "smem_limit", "cpu"])
def test_kernel_wrapper_rejects_what_it_cannot_take(case):
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 4, 6, 16)))
    expected = ValueError
    if case == "float64":
        q, k, v = q.double(), k.double(), v.double()
        expected = TypeError
    elif case == "noncontiguous":
        v = v.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "shapes":
        k = k[:, :3].contiguous()
    elif case == "smem_limit":
        q = torch.zeros(1, 1, ccattn.MAX_H_PLUS_W_PLUS_CQ, 1)
        k, v = q.clone(), torch.zeros(1, 1, ccattn.MAX_H_PLUS_W_PLUS_CQ, 8)
    with pytest.raises(expected):
        ccattn.cc_attention_core_cuda(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 1e-4),
                                             (torch.bfloat16, 3e-2, 1e-2)])
@pytest.mark.parametrize("shape", SHAPES + [(8, 16, 32, 256), (1, 64, 128, 256)])
def test_kernel_matches_plain_on_card(shape, dtype, atol, rtol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, v = (torch.from_numpy(a).cuda().to(dtype) for a in _inputs(shape))
    before = ccattn.KERNEL_LAUNCHES
    out = ccattn.cc_attention_core(q, k, v)
    torch.cuda.synchronize()
    assert ccattn.KERNEL_LAUNCHES == before + 1 and out.dtype == dtype
    ref = ccattn.cc_attention_core_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


# ---------------------------------------------------------------- backward


def _inputs_bwd(shape, seed=0):
    q, k, v = _inputs(shape, seed)
    g = np.random.RandomState(seed + 100).randn(*v.shape).astype(np.float32)
    return q, k, v, g


def _assert_grads_close(got, ref):
    for name, o, r in zip(("dq", "dk", "dv"), got, ref):
        o, r = np.asarray(o), np.asarray(r)
        assert o.shape == r.shape and np.isfinite(o).all(), name
        np.testing.assert_allclose(o, r, atol=1e-5 * np.abs(r).max(), rtol=1e-5,
                                   err_msg=name)


def _port_bwd(arrays):
    return [t.numpy() for t in ccattn.cc_attention_core_bwd_plain(
        *(torch.from_numpy(a) for a in arrays))]


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plain_matches_jax_vjp(shape):
    q, k, v, g = _inputs_bwd(shape)
    _, vjp = jax.vjp(cc_attention_core_jnp, *(jnp.asarray(a) for a in (q, k, v)))
    _assert_grads_close(_port_bwd((q, k, v, g)), vjp(jnp.asarray(g)))


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plain_matches_pallas_bwd_interpret(shape):
    arrays = _inputs_bwd(shape, seed=1)
    ref = cc_attention_core_pallas_bwd(*(jnp.asarray(a) for a in arrays), interpret=True)
    _assert_grads_close(_port_bwd(arrays), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plain_matches_autograd_of_plain_forward(shape):
    arrays = _inputs_bwd(shape, seed=2)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    g = torch.from_numpy(arrays[3])
    ref = torch.autograd.grad(ccattn.cc_attention_core_plain(q, k, v), (q, k, v), g)
    _assert_grads_close(_port_bwd(arrays), [r.numpy() for r in ref])


def test_function_gradcheck_float64_cpu():
    rng = np.random.RandomState(3)
    q, k = (torch.from_numpy(rng.randn(1, 3, 4, 2)).requires_grad_() for _ in range(2))
    v = torch.from_numpy(rng.randn(1, 3, 4, 5)).requires_grad_()
    assert torch.autograd.gradcheck(ccattn.CrissCrossFunction.apply, (q, k, v),
                                    eps=1e-6, atol=1e-6)


def test_function_backward_takes_a_permuted_gradient():
    """The caller permutes the output to NCHW, so the gradient that reaches
    ``backward`` is a non-contiguous view."""
    arrays = _inputs_bwd((2, 7, 11, 32), seed=4)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    g_nchw = torch.from_numpy(arrays[3]).permute(0, 3, 1, 2).contiguous()
    out = ccattn.CrissCrossFunction.apply(q, k, v).permute(0, 3, 1, 2)
    before = ccattn.BWD_KERNEL_LAUNCHES
    got = torch.autograd.grad(out, (q, k, v), g_nchw)
    assert ccattn.BWD_KERNEL_LAUNCHES == before  # CPU tensors: the plain backward
    _assert_grads_close([t.numpy() for t in got], _port_bwd(arrays))
    # autograd casts a gradient to the output's type before it calls backward,
    # so a mismatch can only come from a direct call
    ctx = types.SimpleNamespace(saved_tensors=(q.detach(), k.detach(), v.detach()))
    with pytest.raises(TypeError):
        ccattn.CrissCrossFunction.backward(ctx, torch.from_numpy(arrays[3]).bfloat16())


@pytest.mark.parametrize("case", ["g_dtype", "g_noncontiguous", "smem_limit", "cpu"])
def test_bwd_kernel_wrapper_rejects_what_it_cannot_take(case):
    q, k, v, g = (torch.from_numpy(a) for a in _inputs_bwd((1, 4, 6, 16)))
    expected = ValueError
    if case == "g_dtype":
        g, expected = g.bfloat16(), TypeError
    elif case == "g_noncontiguous":
        g = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    elif case == "smem_limit":
        n = ccattn.MAX_BWD_SHARED_FLOATS // 2
        q = torch.zeros(1, 1, n, 1)
        k, v = q.clone(), torch.zeros(1, 1, n, 8)
        g = v.clone()
    with pytest.raises(expected):
        ccattn.cc_attention_core_bwd_cuda(q, k, v, g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", SHAPES + [(6, 22, 40, 256), (8, 16, 32, 256)])
def test_function_matches_plain_backward_on_card(shape, dtype, rel):
    """Tolerance as a share of the plain result's largest magnitude: float32
    sums in another order; bfloat16 outputs round to 8 mantissa bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, v, g = (torch.from_numpy(a).cuda().to(dtype) for a in _inputs_bwd(shape))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = ccattn.KERNEL_LAUNCHES, ccattn.BWD_KERNEL_LAUNCHES
    out = ccattn.cc_attention_core(*leaves).permute(0, 3, 1, 2)
    got = torch.autograd.grad(out, leaves, g.permute(0, 3, 1, 2))
    torch.cuda.synchronize()
    assert ccattn.KERNEL_LAUNCHES == fwd + 1 and ccattn.BWD_KERNEL_LAUNCHES == bwd + 1
    ref = ccattn.cc_attention_core_bwd_plain(q, k, v, g)
    for name, o, r in zip(("dq", "dk", "dv"), got, ref):
        assert o.dtype == dtype and torch.isfinite(o).all(), name
        err = (o.float() - r.float()).abs().max().item()
        assert err <= rel * r.float().abs().max().item(), (name, err)
    again = torch.autograd.grad(ccattn.cc_attention_core(*leaves), leaves, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: repeatable


@pytest.mark.cuda
def test_backward_through_attention_module_reaches_its_parameters_on_card():
    """Before the autograd Function, the kernel's output had no grad_fn: the
    gradient flowed through the residual only, and the q/k/v convolutions and
    gamma silently received none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from rnd_semantic_segmentation_torch.models.build import randomize_weights_
    from rnd_semantic_segmentation_torch.models.gcpa import CrissCrossAttention
    from rnd_semantic_segmentation_torch.utils import resolve_device

    resolve_device("cuda")  # TF32 off, or cuDNN's 1x1 convolutions keep 3 digits
    module = randomize_weights_(CrissCrossAttention(64), seed=0).cuda()
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 64, 7, 11).astype(np.float32))
    module(x.cuda()).square().sum().backward()
    ref = randomize_weights_(CrissCrossAttention(64), seed=0)
    ref(x).square().sum().backward()  # CPU: the plain core under ordinary autograd
    top = max(r.grad.abs().max().item() for r in ref.parameters())
    for (name, p), (_, r) in zip(module.named_parameters(), ref.named_parameters()):
        assert p.grad is not None, name
        if name == "key_conv.bias":
            # it shifts every energy of a query alike, so its true gradient is
            # zero: both sides hold rounding noise
            assert max(p.grad.abs().max().item(), r.grad.abs().max().item()) <= 1e-3 * top
            continue
        assert p.grad.abs().max() > 1e-3 * top, name
        # float32 on both sides; the CPU and cuDNN sum in other orders
        err = (p.grad.cpu() - r.grad).abs().max().item()
        assert err <= 1e-4 * r.grad.abs().max().item(), (name, err)
