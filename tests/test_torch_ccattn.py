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
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rnd_semantic_segmentation_tpu.ops.ccattn import (
    cc_attention_core_jnp,
    cc_attention_core_pallas,
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
