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

The two passes of the CUDA forward (row partials, then the column branch
combined with them) and the three of the CUDA backward are re-stated in torch
and held against the JAX package here, where the kernels cannot run.
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
    expected, match = ValueError, None
    if case == "float64":
        q, k, v = q.double(), k.double(), v.double()
        expected = TypeError
    elif case == "noncontiguous":
        v = v.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "shapes":
        k = k[:, :3].contiguous()
    elif case == "smem_limit":
        # the forward streams its keys, so no line length or channel count
        # bounds its shared memory: what it keeps is the pixel limit of its
        # grid and indices (meta tensors: the shape alone is checked, and the
        # message tells this limit from the device check that follows it)
        q = torch.empty(1, 2 ** 16, 2 ** 15, 1, device="meta")
        k, v = q.clone(), torch.empty(1, 2 ** 16, 2 ** 15, 8, device="meta")
        match = r"B\*H\*W = 2147483648 exceeds"
    with pytest.raises(expected, match=match):
        ccattn.cc_attention_core_cuda(q, k, v)


def _two_pass_fwd(q, k, v, key_tile):
    """The output as the two passes of csrc/ccattn_fwd.cu compute it, in torch
    on the CPU: the row pass online over key tiles of ``key_tile`` pixels,
    into the row partials (m_r, l_r) and the unnormalised row output O_r;
    then the column pass online over key tiles, the query's own row masked
    (with the guard for a column of one pixel), combined with the row
    partials into the output."""
    ein = torch.einsum
    b, h, w, _ = q.shape

    def online(keys, energies, values, n):
        m = torch.full((b, h, w), float("-inf"))
        l = torch.zeros((b, h, w))
        o = torch.zeros(v.shape)
        for j0 in range(0, n, key_tile):
            e = energies(j0, min(j0 + key_tile, n))
            m_new = torch.maximum(m, e.amax(-1))
            found = torch.isfinite(m_new)  # false only in a column of one pixel
            alpha = torch.where(found, torch.exp(m - m_new), torch.ones_like(m))
            p = torch.where(found[..., None], torch.exp(e - m_new[..., None]),
                            torch.zeros_like(e))
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + values(p, j0, min(j0 + key_tile, n))
            m = m_new
        return m, l, o

    # pass 1: one image row at a time
    m_r, l_r, o_r = online(
        k, lambda j0, j1: ein("bhwc,bhjc->bhwj", q, k[:, :, j0:j1]),
        lambda p, j0, j1: ein("bhwj,bhjc->bhwc", p, v[:, :, j0:j1]), w)

    # pass 2: one image column at a time, the query's own row masked
    def col_energies(j0, j1):
        e = ein("bhwc,bjwc->bhwj", q, k[:, j0:j1])
        own = torch.arange(h)[:, None] == torch.arange(j0, j1)[None, :]
        return e.masked_fill(own[:, None, :], float("-inf"))

    m_c, l_c, o_c = online(
        k, col_energies, lambda p, j0, j1: ein("bhwj,bjwc->bhwc", p, v[:, j0:j1]), h)
    m = torch.maximum(m_r, m_c)  # finite: the row branch is never masked
    a_r = torch.exp(m_r - m)
    a_c = torch.where(l_c > 0, torch.exp(m_c - m), torch.zeros_like(m))
    return ((a_r[..., None] * o_r + a_c[..., None] * o_c)
            / (a_r * l_r + a_c * l_c)[..., None])


@pytest.mark.parametrize("oracle", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("key_tile", [3, None])
@pytest.mark.parametrize("shape", SHAPES)
def test_two_pass_algebra_matches_jax(shape, key_tile, oracle):
    """The decomposition the CUDA forward runs, rehearsed where the kernel
    cannot run: key tiles of 3 pixels take the online rescaling across
    tiles, None a whole line in one tile; (1, 1, 5, 16) takes the guard of
    a fully masked column."""
    arrays = _inputs(shape, seed=8)
    if oracle == "jnp":
        ref = cc_attention_core_jnp(*(jnp.asarray(a) for a in arrays))
    else:
        ref = cc_attention_core_pallas(*(jnp.asarray(a) for a in arrays), interpret=True)
    got = _two_pass_fwd(*(torch.from_numpy(a) for a in arrays),
                        key_tile=key_tile or max(shape[1], shape[2]))
    assert got.shape == shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def _check_kernel_on_card(q, k, v, atol, rtol):
    before = ccattn.KERNEL_LAUNCHES
    out = ccattn.cc_attention_core_cuda(q, k, v)
    torch.cuda.synchronize()
    assert ccattn.KERNEL_LAUNCHES == before + 1
    assert out.dtype == q.dtype and out.shape == v.shape and torch.isfinite(out).all()
    ref = ccattn.cc_attention_core_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    return out


# (B, H, W, C), Cq = C // 8, beyond SHAPES and the serving and 64x128 maps: a
# row of 130 (three key tiles of 44 and five query tiles of 26) and a column
# of 70 (two key tiles, three query tiles); the long row and the long column
# that the previous kernel's shared-memory limit took; channels that are no
# multiple of 4 (Cq = 25: 4-byte copies), more than one channel group
# (C = 520, 2040) and Cq over one 32-channel slice (Cq = 65, 255)
FWD_TILING_SHAPES = [(1, 5, 130, 64), (2, 70, 6, 32), (1, 2, 1000, 64), (1, 600, 3, 64),
                     (2, 9, 11, 200), (1, 6, 10, 520), (1, 16, 20, 2040)]

ON_CARD_TOLERANCE = [(torch.float32, 1e-4, 1e-4), (torch.bfloat16, 3e-2, 1e-2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", ON_CARD_TOLERANCE)
@pytest.mark.parametrize("shape", SHAPES + [(8, 16, 32, 256), (1, 64, 128, 256)]
                         + FWD_TILING_SHAPES)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", ON_CARD_TOLERANCE)
def test_kernel_takes_unaligned_views_on_card(dtype, atol, rtol):
    """Contiguous views one element into their storage: no 16-byte (float32)
    or 8-byte (bfloat16) vector copy lines up, so every line goes by 4-byte
    cp.async or 2-byte loads."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    views = []
    for a in _inputs((2, 7, 11, 256), seed=7):
        flat = torch.zeros(a.size + 1, dtype=dtype, device="cuda")
        flat[1:] = torch.from_numpy(a).cuda().to(dtype).flatten()
        views.append(flat[1:].view(a.shape))
    assert all(t.is_contiguous() and t.data_ptr() % 8 != 0 for t in views)
    _check_kernel_on_card(*views, atol, rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", ON_CARD_TOLERANCE)
@pytest.mark.parametrize("shape", [(6, 22, 40, 256), (1, 5, 130, 64)])
def test_kernel_gives_equal_bits_twice_on_card(shape, dtype, atol, rtol):
    """One writer per output pixel, sums in a fixed order, no atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, v = (torch.from_numpy(a).cuda().to(dtype) for a in _inputs(shape, seed=9))
    out = _check_kernel_on_card(q, k, v, atol, rtol)
    assert torch.equal(out, ccattn.cc_attention_core_cuda(q, k, v))


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


def _longest_bwd_side(side):
    n = 1
    while ccattn.bwd_shared_bytes(*((n + 1, 2) if side == "h" else (2, n + 1))) \
            <= ccattn.MAX_BWD_SHARED_BYTES:
        n += 1
    return n


@pytest.mark.parametrize("case", ["g_dtype", "g_noncontiguous", "smem_limit",
                                  "smem_limit_column", "cpu"])
def test_bwd_kernel_wrapper_rejects_what_it_cannot_take(case):
    """The backward's block holds a whole image column, and a row or a tile of
    64 pixels of it against the whole row: a column of more than 137 pixels or
    a row of more than 259 (the documented limits) needs more shared memory
    than a block can have, whatever the channels."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs_bwd((1, 4, 6, 16)))
    expected = ValueError
    if case == "g_dtype":
        g, expected = g.bfloat16(), TypeError
    elif case == "g_noncontiguous":
        g = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    elif case.startswith("smem_limit"):
        longest_h, longest_w = _longest_bwd_side("h"), _longest_bwd_side("w")
        assert (longest_h, longest_w) == (137, 259)
        size = (1, 2, longest_w + 1) if case == "smem_limit" else (1, longest_h + 1, 2)
        q = torch.zeros(*size, 1)
        k, v = q.clone(), torch.zeros(*size, 8)
        g = v.clone()
    with pytest.raises(expected):
        ccattn.cc_attention_core_bwd_cuda(q, k, v, g)


def _three_pass_bwd(q, k, v, g):
    """dq, dk, dv as the three passes of csrc/ccattn_bwd.cu compute them, in
    torch on the CPU: the row branch's softmax partials (m_r, l_r, t_r); the
    column branch's, with the guard for a column of one pixel, combined into
    the final max m, 1/l and s, then the column contributions; then the row
    branch from the final statistics, plus the column contributions."""
    ein = torch.einsum
    # pass 1: one image row at a time
    e_r = ein("bhwc,bhjc->bhwj", q, k)
    d_r = ein("bhwc,bhjc->bhwj", g, v)
    m_r = e_r.amax(-1)
    p_r = torch.exp(e_r - m_r[..., None])
    l_r, t_r = p_r.sum(-1), (p_r * d_r).sum(-1)
    # pass 2: one image column at a time, the query's own row masked
    h = q.shape[1]
    diag = torch.eye(h, dtype=torch.bool)[:, None, :]
    e_c = ein("bhwc,bjwc->bhwj", q, k).masked_fill(diag, float("-inf"))
    d_c = ein("bhwc,bjwc->bhwj", g, v)
    m_c = e_c.amax(-1)
    found = torch.isfinite(m_c)  # false only where H = 1
    p_c = torch.exp(e_c - torch.where(found, m_c, torch.zeros_like(m_c))[..., None])
    l_c, t_c = p_c.sum(-1), (p_c * d_c).sum(-1)
    m = torch.maximum(m_r, m_c)
    w_r = torch.exp(m_r - m)
    w_c = torch.where(l_c > 0, torch.exp(m_c - m), torch.zeros_like(m))
    inv_l = 1 / (l_r * w_r + l_c * w_c)
    s = (t_r * w_r + t_c * w_c) * inv_l
    a_c = torch.exp(e_c - m[..., None]) * inv_l[..., None]
    de_c = a_c * (d_c - s[..., None])
    dq_c = ein("bhwj,bjwc->bhwc", de_c, k)
    dk_c = ein("bhwj,bhwc->bjwc", de_c, q)
    dv_c = ein("bhwj,bhwc->bjwc", a_c, g)
    # pass 3: the row branch from the final statistics, and the sum
    a_r = torch.exp(e_r - m[..., None]) * inv_l[..., None]
    de_r = a_r * (d_r - s[..., None])
    return (ein("bhwj,bhjc->bhwc", de_r, k) + dq_c,
            ein("bhwj,bhwc->bhjc", de_r, q) + dk_c,
            ein("bhwj,bhwc->bhjc", a_r, g) + dv_c)


@pytest.mark.parametrize("shape", SHAPES)
def test_three_pass_algebra_matches_jax_vjp(shape):
    """The decomposition the CUDA backward runs, rehearsed where the kernel
    cannot run; (1, 1, 5, 16) takes the guard of a fully masked column."""
    q, k, v, g = _inputs_bwd(shape, seed=5)
    _, vjp = jax.vjp(cc_attention_core_jnp, *(jnp.asarray(a) for a in (q, k, v)))
    got = _three_pass_bwd(*(torch.from_numpy(a) for a in (q, k, v, g)))
    _assert_grads_close([t.numpy() for t in got], vjp(jnp.asarray(g)))


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


def _check_bwd_kernel_on_card(q, k, v, g, rel):
    before = ccattn.BWD_KERNEL_LAUNCHES
    got = ccattn.cc_attention_core_bwd_cuda(q, k, v, g)
    torch.cuda.synchronize()
    assert ccattn.BWD_KERNEL_LAUNCHES == before + 1
    ref = ccattn.cc_attention_core_bwd_plain(q, k, v, g)
    for name, o, r in zip(("dq", "dk", "dv"), got, ref):
        assert o.dtype == q.dtype and o.shape == r.shape and torch.isfinite(o).all(), name
        err = (o.float() - r.float()).abs().max().item()
        assert err <= rel * r.float().abs().max().item(), (name, err)
    again = ccattn.cc_attention_core_bwd_cuda(q, k, v, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: repeatable


# (B, H, W, C), Cq = C // 8: lines that are no multiple of the 2x2 and 4x4
# register tiles, with n = 65 and 127 on the 4x4 side; rows of 127, 200 and
# 259 pixels in row tiles, the last one short; the longest column (137) and
# row (259) the kernel takes; channels that are no multiple of the 32-channel
# slice (Cq = 25, 65 and 255, C = 200, 520 and 2040: Cq not a multiple of 4
# takes the 4-byte copies); operands too wide to stage whole (C = 1024 and
# 2040), which stream in slices, the first in row tiles; and the 64x128 map of
# a 2048x4096 input
BWD_TILING_SHAPES = [(2, 13, 37, 64), (1, 65, 9, 32), (1, 3, 127, 16), (2, 9, 11, 200),
                     (1, 6, 10, 520), (1, 2, 200, 32), (1, 137, 3, 16), (1, 2, 259, 16),
                     (1, 16, 20, 2040), (1, 3, 100, 1024), (1, 64, 128, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", BWD_TILING_SHAPES)
def test_bwd_kernel_matches_plain_at_tiling_edges_on_card(shape, dtype, rel):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    _check_bwd_kernel_on_card(
        *(torch.from_numpy(a).cuda().to(dtype) for a in _inputs_bwd(shape, seed=6)), rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_bwd_kernel_takes_unaligned_views_on_card(dtype, rel):
    """Contiguous views one element into their storage: no 16-byte (float32)
    or 8-byte (bfloat16) vector copy lines up, so every slice goes by 4-byte
    cp.async or 2-byte loads."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    views = []
    for a in _inputs_bwd((2, 7, 11, 256), seed=7):
        flat = torch.zeros(a.size + 1, dtype=dtype, device="cuda")
        flat[1:] = torch.from_numpy(a).cuda().to(dtype).flatten()
        views.append(flat[1:].view(a.shape))
    assert all(t.is_contiguous() and t.data_ptr() % 8 != 0 for t in views)
    _check_bwd_kernel_on_card(*views, rel)


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
