"""The port's resize and pooling ops against the JAX package's.

``resize_bilinear`` is ``F.interpolate`` in the port and an interpolation
matrix product in the JAX package; both follow PyTorch's coordinate rules,
so they agree to float32 rounding (atol 1e-5 on values in [0, 1)).
``max_pool`` is exact on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rnd_semantic_segmentation_tpu.ops import max_pool as jax_max_pool
from rnd_semantic_segmentation_tpu.ops import resize_bilinear as jax_resize
from rnd_semantic_segmentation_torch.ops import max_pool, resize_bilinear

torch.set_num_threads(2)  # six test workers share the host's cores


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("src,dst", [((7, 9), (16, 32)),    # upsampling
                                     ((64, 48), (13, 20)),  # downsampling
                                     ((7, 9), (7, 9)),      # identity
                                     ((5, 12), (1, 24))])   # mixed, one row out
def test_resize_bilinear_matches_jax(src, dst, align_corners):
    x = np.random.RandomState(0).rand(2, *src, 3).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(x), dst, align_corners=align_corners))
    out = resize_bilinear(_nchw(x), dst, align_corners=align_corners)
    assert tuple(out.shape) == (2, 3, *dst)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kernel,stride,padding", [(3, 2, 1), (2, 2, 0)])
@pytest.mark.parametrize("hw", [(16, 16), (15, 9)])
def test_max_pool_matches_jax_exactly(kernel, stride, padding, hw):
    x = np.random.RandomState(1).randn(2, *hw, 4).astype(np.float32)
    ref = np.asarray(jax_max_pool(jnp.asarray(x), kernel, stride, padding=padding))
    out = max_pool(_nchw(x), kernel, stride, padding).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(out, ref)
