"""The port's research segmentation nets (models/seg_nets.py) against the
JAX package's, on the CPU in float32, at a cut depth (``layers=(1, 1, 2,
1)``) and full widths, on 64-72 pixel inputs.

As in tests/test_torch_zoo.py: seeded JAX variables (the criss-cross
``gamma`` at 0.7, so that the attention contributes), carried over by
``research_state_dict_from_flax`` (round trip exact), eval-mode ``(main,
dsn)`` held to 1e-4 of the reference's largest magnitude.  CCNet's input and
parameter gradients are held against ``jax.grad`` of the JAX module (its
einsum criss-cross core on the CPU) in eval mode, per leaf to 1e-4 of the
leaf's norm.  Then the output-stride-8 shapes, where the floor-mode stem pool
shows, and the backward kernel's shape limit, which the wrapper checks
before it looks for a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnd_semantic_segmentation_tpu.models import seg_nets as J

from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    research_flax_from_state_dict,
    research_state_dict_from_flax,
)
from rnd_semantic_segmentation_torch.models import seg_nets as P
from rnd_semantic_segmentation_torch.ops import ccattn

from test_torch_zoo import _x, hold

torch.set_num_threads(2)  # six test workers share the host's cores

LAYERS = (1, 1, 2, 1)
NC = 5
GRAD_REL = 1e-4


@pytest.mark.parametrize("name,side", [
    ("DilatedSegBackbone", 64), ("GALDNetFull", 72), ("CCNetSegModel", 65),
    ("PSPNetFull", 64), ("PSPHead", 64), ("DualSegNet", 64)])
def test_net_against_the_jax_net(name, side):
    if name == "DilatedSegBackbone":
        jax_net, port_net = J.DilatedSegBackbone(LAYERS), P.DilatedSegBackbone(LAYERS)
    elif name == "PSPHead":
        jax_net, port_net = J.PSPHead(LAYERS), P.PSPHead(LAYERS)
    else:
        jax_net, port_net = getattr(J, name)(NC, layers=LAYERS), getattr(P, name)(NC, layers=LAYERS)
    variables = hold(name, jax_net, port_net, [_x(2, side, side, 3)])
    sd = research_state_dict_from_flax(name, variables)
    assert {"conv1.weight", "bn3.running_var", "layer4.0.conv2.weight",
            "layer2.0.downsample.1.weight"} <= set(sd)
    if name not in ("DilatedSegBackbone", "PSPHead"):
        assert {"dsn.0.weight", "dsn.1.running_mean", "dsn.3.bias"} <= set(sd)
    assert port_net.layer3[0].conv2.dilation == (2, 2)
    assert port_net.layer4[0].conv2.dilation == (4, 4)


def test_ccnet_gradients_against_jax_grad():
    """Eval mode (running statistics), gamma at 0.7: the loss is a seeded
    weighting of both outputs; Cq = 64 and C = 512, CCNet's own widths.  The
    query and key kernels are drawn at a tenth of the other convs' scale: at
    the full scale the criss-cross energies reach 2.4e3, the joint softmax is
    saturated, and the port's own float32 gradients then differ from its
    float64 ones by 5.5e-4 to 6.4e-4 of their norm (measured on this net), in
    either package.  A leaf's error is held to 1e-4 of the larger of its norm
    and 1e-3 of the largest leaf's (the key conv's bias shifts every energy
    of a query alike, which the softmax ignores: its gradient is 0 up to
    rounding)."""
    x = _x(2, 65, 65, 3)
    jax_net, port_net = J.CCNetSegModel(NC, layers=LAYERS), P.CCNetSegModel(NC, layers=LAYERS)
    variables = hold("CCNetSegModel", jax_net, port_net, [x])
    cca = variables["params"]["head"]["cca"]
    for conv in ("query_conv", "key_conv"):
        cca[conv]["kernel"] = cca[conv]["kernel"] * np.float32(0.1)
    port_net.load_state_dict(research_state_dict_from_flax("CCNetSegModel", variables))
    assert port_net.head.cca.query_conv.out_channels == 64
    assert port_net.head.cca.value_conv.out_channels == 512
    rng = np.random.RandomState(7)
    w_main, w_dsn = rng.randn(2, 9, 9, NC).astype(np.float32), rng.randn(2, 9, 9, NC).astype(
        np.float32)

    def jax_loss(params, image):
        main, dsn = jax_net.apply({**variables, "params": params}, image)
        return jnp.sum(main * w_main) + jnp.sum(dsn * w_dsn)

    g_params, g_x = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(variables["params"],
                                                               jnp.asarray(x))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    port_net.eval().zero_grad()
    main, dsn = port_net(xt)
    loss = ((main * torch.from_numpy(w_main.transpose(0, 3, 1, 2).copy())).sum()
            + (dsn * torch.from_numpy(w_dsn.transpose(0, 3, 1, 2).copy())).sum())
    loss.backward()
    grads = {name: p.grad for name, p in port_net.named_parameters()}
    tree = research_flax_from_state_dict("CCNetSegModel", grads,
                                         {"params": variables["params"]})["params"]
    leaves = jax.tree_util.tree_flatten_with_path(g_params)[0]
    floor = 1e-3 * max(np.linalg.norm(np.asarray(ref)) for _, ref in leaves)
    for path, ref in leaves:
        node = tree
        for key in path:
            node = node[key.key]
        ref = np.asarray(ref)
        rel = np.linalg.norm(node - ref) / max(np.linalg.norm(ref), floor)
        assert rel <= GRAD_REL, f"{jax.tree_util.keystr(path)}: {rel}"
    gx = xt.grad.permute(0, 2, 3, 1).numpy()
    assert np.linalg.norm(gx - np.asarray(g_x)) <= GRAD_REL * np.linalg.norm(np.asarray(g_x))
    assert np.abs(np.asarray(g_params["head"]["cca"]["gamma"])).max() > 1e-2 * floor


@pytest.mark.parametrize("side", [64, 65, 66, 67, 769])
def test_output_stride_8_with_the_floor_mode_stem_pool(side):
    """Both packages floor the stem pool: 64 gives a 32 stem map, a 16 pool
    map and an 8 x 8 OS8 map, where the reference's ceil mode gives 17 and 9;
    769 gives 97 either way."""
    jax_shapes = jax.eval_shape(
        lambda v, x: J.DilatedSegBackbone((1, 1, 1, 1)).apply(v, x),
        jax.eval_shape(J.DilatedSegBackbone((1, 1, 1, 1)).init, jax.random.PRNGKey(0),
                       jnp.zeros((1, side, side, 3))),
        jnp.zeros((1, side, side, 3)))
    stem = (side - 1) // 2 + 1
    pooled = (stem - 1) // 2 + 1
    os8 = (pooled - 1) // 2 + 1
    assert [s.shape[1:3] for s in jax_shapes] == [(os8, os8)] * 2
    if side < 100:
        with torch.no_grad():
            taps = P.DilatedSegBackbone((1, 1, 1, 1)).eval()(torch.zeros(1, 3, side, side))
        assert [tuple(t.shape[-2:]) for t in taps] == [(os8, os8)] * 2
    assert (os8 == 8) if side == 64 else True
    assert (os8 == 97) if side == 769 else True


@pytest.mark.parametrize("h,w,fits", [(97, 97, True), (128, 256, True), (137, 259, True),
                                      (138, 97, False), (97, 260, False), (145, 289, False)])
def test_the_backward_kernel_refuses_maps_past_its_shared_memory(h, w, fits):
    """CCNet at 769 (97 x 97) and a 1024 x 2048 frame (128 x 256) fit the
    backward's shared memory; a larger map raises before any launch, whatever
    the device, and never falls back to the plain core."""
    q = torch.zeros(1, h, w, 2)
    v = torch.zeros(1, h, w, 4)
    with pytest.raises(ValueError) as err:
        ccattn.cc_attention_core_bwd_cuda(q, q, v, v)
    assert ("not CUDA" in str(err.value)) == fits
    assert ("shared memory" in str(err.value)) != fits
