"""The port's research-zoo blocks (models/zoo.py) against the JAX package's,
on the CPU in float32, at small widths.

Each case fills the JAX module's variables from a seed (conv and Dense
kernels at variance 1.7/fan_in, nonzero biases and norm affines, random
BatchNorm statistics, the criss-cross ``gamma`` at 0.7), carries them to
the port with ``research_state_dict_from_flax`` (whose inverse must give
them back exactly), and holds the eval-mode outputs on the same seeded input
to 1e-4 of the reference's largest magnitude (float32 sums in other orders;
the Taylor terms of SpatialCGNLx reach 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnd_semantic_segmentation_tpu.models import zoo as J

from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    research_flax_from_state_dict,
    research_state_dict_from_flax,
)
from rnd_semantic_segmentation_torch.models import zoo as P

torch.set_num_threads(2)  # six test workers share the host's cores

REL = 1e-4


def _randomise(path, leaf, rng, bn_scale=(0.5, 1.5)):
    shape, name = leaf.shape, path[-1].key
    if name == "kernel":
        fan_in = np.prod(shape[:-1])
        return (rng.randn(*shape) * np.sqrt(1.7 / fan_in)).astype(np.float32)
    lo, hi = {"bias": (-0.1, 0.1), "scale": bn_scale, "mean": (-0.2, 0.2),
              "var": (0.5, 1.5), "gamma": (0.7, 0.7), "gaussian_kernel": (0.0, 2e-3)}[name]
    return rng.uniform(lo, hi, shape).astype(np.float32)


def hold(name, jax_module, port_module, inputs, seed=1, bn_scale=(0.5, 1.5)):
    """The two modules on ``inputs`` (channels-last numpy: NHWC, NTHWC, or
    [N, C] features) with one seeded set of
    weights, norm scales drawn from ``bn_scale``; returns the JAX variables.
    Shared with tests/test_torch_contextagg.py and test_torch_seg_nets.py."""
    xs = [jnp.asarray(a) for a in inputs]
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), *xs)
    rng = np.random.RandomState(seed)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, l: _randomise(p, l, rng, bn_scale), shapes)
    ref = jax.jit(jax_module.apply)(variables, *xs)
    sd = research_state_dict_from_flax(name, variables)
    assert set(sd) == set(port_module.state_dict())
    port_module.load_state_dict(sd)
    back = research_flax_from_state_dict(name, sd, variables)
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf, err_msg=str(path))
    with torch.no_grad():
        out = port_module.eval()(*(torch.from_numpy(
            a.transpose(0, a.ndim - 1, *range(1, a.ndim - 1)).copy()) for a in inputs))
    if isinstance(out, dict):  # Res2Net's taps
        out, ref = tuple(out.values()), tuple(ref[k] for k in out)
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        o, r = o.permute(0, *range(2, o.dim()), 1).numpy(), np.asarray(r)
        assert o.shape == r.shape and np.isfinite(o).all()
        err, scale = np.abs(o - r).max(), np.abs(r).max()
        assert err <= REL * scale, f"{name}: max abs error {err} > {REL} x {scale}"
    return variables


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("mode,bn_layer", [("gaussian", True), ("embedded", True),
                                           ("dot", True), ("concatenate", True),
                                           ("embedded", False)])
def test_nl_block(mode, bn_layer):
    hold("NLBlockND", J.NLBlockND(mode=mode, bn_layer=bn_layer),
         P.NLBlockND(16, mode=mode, bn_layer=bn_layer), [_x(2, 5, 6, 16)])


def test_a2net():
    hold("A2Net", J.A2Net(12, 10), P.A2Net(16, 12, 10), [_x(2, 5, 6, 16)])


def test_pyramid_self_attention_apnb_and_afnb():
    hold("PyramidSelfAttention", J.PyramidSelfAttention(8, 12),
         P.PyramidSelfAttention(16, 8, 12), [_x(2, 9, 10, 16)])
    hold("APNB", J.APNB(20, 8, 12), P.APNB(16, 20, 8, 12), [_x(2, 9, 10, 16)])
    hold("AFNB", J.AFNB(20, 8, 12), P.AFNB(16, 24, 20, 8, 12),
         [_x(2, 9, 10, 16), _x(2, 5, 6, 24, seed=1)])


def test_apnb_drops_whole_channels_in_train_mode():
    """JAX draws a [B,1,1,C] keep mask and scales by 1/(1-p); the port's
    ``dropout2d`` does the same (the draws differ: another generator)."""
    apnb = P.APNB(16, 20, 8, 12, dropout=0.5).train()
    x = torch.randn(2, 16, 9, 10)
    torch.manual_seed(0)
    dropped = apnb(x).flatten(2)
    apnb.dropout = 0.0
    kept = apnb(x).flatten(2)
    zero = (dropped == 0).all(dim=2)
    assert zero.any() and not zero.all()
    torch.testing.assert_close(dropped[~zero], 2 * kept[~zero], rtol=1e-6, atol=1e-6)


def test_graph_convolutions():
    hold("SpatialGCN", J.SpatialGCN(), P.SpatialGCN(16), [_x(2, 5, 6, 16)])
    variables = hold("DualGCN", J.DualGCN(), P.DualGCN(32), [_x(2, 17, 18, 32)])
    assert variables["params"]["conv_adj"]["kernel"].shape == (8, 8)  # Dense -> Conv1d
    hold("DualGCNHead", J.DualGCNHead(32, 5), P.DualGCNHead(24, 32, 5), [_x(2, 17, 18, 24)])
    sd = research_state_dict_from_flax("DualGCN", variables)
    assert sd["conv_adj.weight"].shape == (8, 8, 1)
    assert "local.5.running_var" in sd and "final.1.weight" in sd


@pytest.mark.parametrize("order,use_scale", [(2, False), (3, True)])
def test_spatial_cgnlx(order, use_scale):
    hold("SpatialCGNLx", J.SpatialCGNLx(32, order=order, use_scale=use_scale),
         P.SpatialCGNLx(64, 32, order=order, use_scale=use_scale), [_x(2, 5, 6, 64)])


def test_rcca_module_applies_one_criss_cross_recurrence_times():
    variables = hold("RCCAModule", J.RCCAModule(24, 5), P.RCCAModule(64, 24, 5),
                     [_x(2, 7, 9, 64)])
    assert float(variables["params"]["cca"]["gamma"][0]) == pytest.approx(0.7)
    sd = research_state_dict_from_flax("RCCAModule", variables)
    assert {"conva.0.weight", "cca.query_conv.weight", "cca.gamma", "convb.1.running_mean",
            "bottleneck.0.weight", "bottleneck.3.bias"} <= set(sd)
    calls = []
    port = P.RCCAModule(64, 24, 5, recurrence=3)
    port.cca.register_forward_hook(lambda *a: calls.append(1))
    port.eval()(torch.randn(1, 64, 5, 6))
    assert len(calls) == 3


def test_spatial_nl_and_se_block():
    hold("SpatialNL", J.SpatialNL(12, use_scale=True), P.SpatialNL(16, 12, use_scale=True),
         [_x(2, 5, 6, 16)])
    hold("SEBlock", J.SEBlock(4), P.SEBlock(32, 4), [_x(2, 5, 6, 32)])
