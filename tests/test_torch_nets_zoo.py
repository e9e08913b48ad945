"""The port's whole research nets (models/nets_zoo.py: UNet, CE-Net and its
DAC and SPP blocks, BiSeNetV1) against the JAX package's, on the CPU in
float32, at small sizes (64-pixel inputs; 192 where CE-Net's SPP block
needs a 6 x 6 centre map).

As in tests/test_torch_zoo.py: seeded JAX variables, carried over by
``research_state_dict_from_flax`` (round trip exact), eval-mode outputs held
to 1e-4 of the reference's largest magnitude.  UNet is also held in train
mode (``hold_train``, shared with the other tests of the zoo's modules):
outputs to 1e-4 of their magnitude, the updated BatchNorm statistics to 1e-4
of theirs, and the gradients of a seeded weighting of the outputs.  Train-mode
BatchNorm makes some of those gradients badly conditioned: a norm's bias
before a ReLU and another train-mode norm gets a gradient that is a small
difference of large sums, and the port's own float32 gradient of UNet's
``inc.bn1.bias`` is 5.7e-4 of its norm away from its float64 one, the JAX
package's float32 ``down1.bn0.bias`` 2.0e-3, and the port's whole float32
gradient of NLResNet18 1.4e-4 of its norm (the JAX package's whole float32
gradient of UNet 1.4e-3 of its).  So the gradients are held against the
port's float64 gradient on the same weights: each leaf to 1e-2 (relative to
the larger of the leaf's norm and 1e-3 of the largest leaf's), all leaves
together to 1e-3 of the whole gradient's norm for the port's float32
gradient and 1e-2 for ``jax.grad``'s, which ties the float64 port to the
JAX package.  A wrong gradient is off by its own order.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnd_semantic_segmentation_tpu.models import nets_zoo as J

from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    research_flax_from_state_dict,
    research_state_dict_from_flax,
)
from rnd_semantic_segmentation_torch.models import nets_zoo as P

from test_torch_zoo import _x, hold

torch.set_num_threads(2)  # six test workers share the host's cores

REL = 1e-4
GRAD_REL = {"port": 1e-3, "jax": 1e-2}   # the whole gradient, against float64
LEAF_REL = 1e-2                          # each leaf, against float64


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _nchw(a, ndim=4):
    a = np.asarray(a)
    return a.transpose(0, ndim - 1, *range(1, ndim - 1))


def _nhwc(t):
    return t.detach().permute(0, *range(2, t.dim()), 1).numpy()


def hold_train(name, jax_module, port_module, inputs, variables, seed=7, apply_kw=None):
    """Train mode on ``inputs`` (channels-last numpy, 4-D or 5-D) with the
    JAX ``variables`` (already loaded into ``port_module``): the outputs, the
    updated BatchNorm statistics and the gradients of ``sum(out * w)`` over
    the outputs with seeded ``w``."""
    apply_kw = apply_kw or {}
    wide = copy.deepcopy(port_module).double()
    xs = [jnp.asarray(a) for a in inputs]
    outs = _outputs(jax_module.apply(variables, *xs, train=True, mutable=["batch_stats"],
                                     **apply_kw)[0])
    rng = np.random.RandomState(seed)
    weights = [rng.randn(*np.shape(o)).astype(np.float32) for o in outs]

    def loss(params):
        out, upd = jax_module.apply({**variables, "params": params}, *xs, train=True,
                                    mutable=["batch_stats"], **apply_kw)
        total = sum(jnp.sum(o * w) for o, w in zip(_outputs(out), weights))
        return total, (out, upd)

    (_, (ref, upd)), g_params = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    port_module.train().zero_grad()
    got = _outputs(port_module(*(torch.from_numpy(_nchw(a, a.ndim).copy()) for a in inputs)))
    total = sum((o * torch.from_numpy(_nchw(w, w.ndim).copy())).sum()
                for o, w in zip(got, weights))
    total.backward()
    for o, r in zip(got, _outputs(ref)):
        o, r = _nhwc(o), np.asarray(r)
        assert o.shape == r.shape and np.isfinite(o).all()
        assert np.abs(o - r).max() <= REL * np.abs(r).max(), name
    sd = port_module.state_dict()
    stats = research_flax_from_state_dict(name, sd, {"batch_stats": upd["batch_stats"]})
    for path, leaf in jax.tree_util.tree_flatten_with_path(upd["batch_stats"])[0]:
        node = stats["batch_stats"]
        for key in path:
            node = node[key.key]
        leaf = np.asarray(leaf)
        assert np.abs(node - leaf).max() <= REL * max(np.abs(leaf).max(), 1e-6), str(path)
    wide.train().zero_grad()
    got64 = _outputs(wide(*(torch.from_numpy(_nchw(a, a.ndim).copy()).double() for a in inputs)))
    sum((o * torch.from_numpy(_nchw(w, w.ndim).copy()).double()).sum()
        for o, w in zip(got64, weights)).backward()
    as_tree = lambda m: research_flax_from_state_dict(  # noqa: E731
        name, {n: p.grad for n, p in m.named_parameters()},
        {"params": variables["params"]})["params"]
    port, exact = as_tree(port_module), as_tree(wide)
    leaves = jax.tree_util.tree_flatten_with_path(g_params)[0]
    floor = 1e-3 * max(np.linalg.norm(np.asarray(r)) for _, r in leaves)
    errors = {"port": [], "jax": []}
    total = []
    for path, r in leaves:
        p64, p32 = exact, port
        for key in path:
            p64, p32 = p64[key.key], p32[key.key]
        scale = max(np.linalg.norm(p64), floor)
        for who, have in (("port", p32), ("jax", np.asarray(r, np.float64))):
            err = np.linalg.norm(have - p64)
            assert err <= LEAF_REL * scale, f"{who} {name} {jax.tree_util.keystr(path)}"
            errors[who].append(err ** 2)
        total.append(np.linalg.norm(p64) ** 2)
    for who, errs in errors.items():
        assert np.sqrt(sum(errs)) <= GRAD_REL[who] * np.sqrt(sum(total)), (who, name)


def test_unet_eval_and_train():
    x = _x(2, 64, 64, 3)
    jax_net, port_net = J.UNet(2), P.UNet(2)
    variables = hold("UNet", jax_net, port_net, [x])
    sd = research_state_dict_from_flax("UNet", variables)
    assert {"inc.conv0.weight", "up4.bn1.running_var", "outc.bias"} <= set(sd)
    hold_train("UNet", jax_net, port_net, [x], variables)


@pytest.mark.parametrize("name", ["DACBlock", "DACBlockNoAtrous", "DACBlockInception",
                                  "DACBlockInceptionBlocks", "SPPBlock"])
def test_cenet_centre_blocks(name):
    variables = hold(name, getattr(J, name)(), getattr(P, name)(16), [_x(2, 13, 12, 16)])
    if name == "DACBlockNoAtrous":
        assert {"dilate1", "dilate2", "dilate3", "conv1x1"} == set(variables["params"])


@pytest.mark.parametrize("dac,use_spp,side", [("atrous", True, 192), ("no_atrous", False, 64),
                                              ("inception", False, 64),
                                              ("inception_blocks", False, 64)])
def test_cenet(dac, use_spp, side):
    jax_net = J.CENet(num_classes=2, dac=dac, use_spp=use_spp)
    port_net = P.CENet(num_classes=2, dac=dac, use_spp=use_spp)
    # norms damped as in ``randomize_weights_``: with running statistics the
    # ResNet34's sums grow block by block, and the sigmoid then saturates
    variables = hold("CENet", jax_net, port_net, [_x(1, side, side, 3)], bn_scale=(0.25, 0.75))
    sd = research_state_dict_from_flax("CENet", variables)
    assert {"resnet.layer2.0.downsample.1.running_mean", "decoder4.deconv2.weight",
            "finaldeconv1.weight"} <= set(sd)
    # transposed convs are (I, O, kh, kw)
    assert tuple(sd["finaldeconv1.weight"].shape) == (64, 32, 4, 4)
    assert tuple(sd["decoder4.conv1.weight"].shape)[1] == (516 if use_spp else 512)


def test_cenet_oct_gives_logits():
    jax_net, port_net = J.CENetOCT(), P.CENetOCT()
    hold("CENet", jax_net, port_net, [_x(1, 192, 192, 3, seed=2)], bn_scale=(0.25, 0.75))
    with torch.no_grad():
        out = port_net(torch.from_numpy(_x(1, 3, 192, 192, seed=2)))
    assert out.shape == (1, 12, 192, 192) and (out < 0).any()


@pytest.mark.parametrize("output_aux", [True, False])
def test_bisenet_v1(output_aux):
    jax_net, port_net = J.BiSeNetV1(3, output_aux=output_aux), P.BiSeNetV1(3, output_aux)
    variables = hold("BiSeNetV1", jax_net, port_net, [_x(2, 64, 64, 3)])
    sd = research_state_dict_from_flax("BiSeNetV1", variables)
    assert {"cp_resnet.layer4.1.conv2.weight", "arm32.conv.conv.weight",
            "ffm.convblk.bn.running_var", "conv_out_out.weight"} <= set(sd)
    with torch.no_grad():
        outs = _outputs(port_net(torch.from_numpy(_x(2, 3, 64, 64))))
    assert all(o.shape == (2, 3, 64, 64) for o in outs) and len(outs) == (3 if output_aux else 1)


def test_pixel_shuffle_order_is_the_jax_one():
    """Channel (i * f + j) * C + c lands at row phase i, column phase j."""
    x = np.random.RandomState(3).randn(2, 3, 4, 2 * 2 * 5).astype(np.float32)
    ref = np.asarray(J._pixel_shuffle(jnp.asarray(x), 2))
    got = P.depth_to_space(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
