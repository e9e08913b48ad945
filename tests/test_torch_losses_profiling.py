"""The port's ``compound_loss`` and ``generalized_dice_loss`` (losses) and
utils/profiling.py against the JAX package's, on the CPU in float32.

Loss values and the gradients on the logits are held to 1e-5 of their
magnitude, for the three class weightings, labels with ignored pixels and a
one-hot target.  ``count_params`` equals the JAX count of the same net;
``cal_params`` counts a conv's 2 x MACs (``FlopCounterMode``) and the bytes
of every op's inputs and outputs; ``clever_format`` prints as the JAX one;
``trace`` writes a TensorBoard or a Chrome trace.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnd_semantic_segmentation_tpu import losses as jax_losses
from rnd_semantic_segmentation_tpu.models import nets_zoo as JZ
from rnd_semantic_segmentation_tpu.utils import profiling as jax_profiling

from rnd_semantic_segmentation_torch import losses
from rnd_semantic_segmentation_torch.models import nets_zoo as PZ
from rnd_semantic_segmentation_torch.utils import profiling

torch.set_num_threads(2)  # six test workers share the host's cores

REL = 1e-5


def _inputs(seed=0, b=2, c=4, h=6, w=7):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, h, w, c) * 2).astype(np.float32)
    label = rng.randint(0, c, (b, h, w)).astype(np.int64)
    label[0, :2] = 255
    label[1, :, :3] = 255
    label[label == 2] = 1  # class 2 absent: its weight is 1 / eps
    onehot = np.eye(c, dtype=np.float32)[rng.randint(0, c, (b, h, w))]
    return logits, label, onehot


def _hold(port_fn, jax_fn, logits, target, nchw_target):
    value, grad = jax.value_and_grad(lambda z: jax_fn(z, jnp.asarray(target)))(
        jnp.asarray(logits))
    z = torch.from_numpy(logits.transpose(0, 3, 1, 2).copy()).requires_grad_()
    t = torch.from_numpy(target.transpose(0, 3, 1, 2).copy() if nchw_target else target)
    got = port_fn(z, t)
    got.backward()
    assert abs(float(got.detach()) - float(value)) <= REL * abs(float(value))
    grad = np.asarray(grad).transpose(0, 3, 1, 2)
    assert np.abs(z.grad.numpy() - grad).max() <= REL * np.abs(grad).max()
    return float(value)


@pytest.mark.parametrize("weight_type", ["square", "identity", "sqrt"])
@pytest.mark.parametrize("target", ["labels", "onehot"])
def test_generalized_dice_loss(weight_type, target):
    logits, label, onehot = _inputs()
    t = label if target == "labels" else onehot
    value = _hold(lambda z, y: losses.generalized_dice_loss(z, y, weight_type=weight_type),
                  lambda z, y: jax_losses.generalized_dice_loss(z, y, weight_type=weight_type),
                  logits, t, target == "onehot")
    assert 0.0 < value < 1.0 + 1e-6
    with pytest.raises(ValueError, match="weight_type"):
        losses.generalized_dice_loss(torch.zeros(1, 2, 2, 2), torch.zeros(1, 2, 2), weight_type="x")


@pytest.mark.parametrize("weights", [None, (0.3, 1.7)])
def test_compound_loss(weights):
    logits, _, onehot = _inputs(seed=1)
    port = losses.compound_loss([losses.tversky_loss, losses.bce_with_logits], weights)
    ref = jax_losses.compound_loss([jax_losses.tversky_loss, jax_losses.bce_with_logits], weights)
    _hold(port, ref, logits, onehot, True)


def test_count_params_and_cal_params():
    net = PZ.UNet(2)
    shapes = jax.eval_shape(JZ.UNet(2).init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    assert profiling.count_params(net) == jax_profiling.count_params(shapes["params"])
    assert profiling.count_params(net.state_dict()) > profiling.count_params(net)  # + stats
    conv = torch.nn.Conv2d(3, 8, 3, padding=1)
    x = torch.randn(2, 3, 16, 16)
    stats = profiling.cal_params(conv, x)
    assert stats["flops"] == 2 * 2 * 8 * 16 * 16 * 3 * 9
    assert stats["gflops"] == stats["flops"] / 1e9
    # one op: x, weight and bias in, y out (4 bytes each)
    assert stats["bytes_accessed"] >= 4 * (x.numel() + conv.weight.numel() + 8 + 2 * 8 * 16 * 16)
    for value in (0, 12.5, 2.5e4, 3.2e9, -7e12, 5e20):
        assert profiling.clever_format(value, "B") == jax_profiling.clever_format(value, "B")


@pytest.mark.parametrize("chrome", [False, True])
def test_trace_writes_a_trace(tmp_path, chrome):
    conv = torch.nn.Conv2d(3, 4, 3)
    with profiling.trace(str(tmp_path), chrome=chrome) as prof:
        conv(torch.randn(1, 3, 8, 8))
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert files and prof is not None
    with open(tmp_path / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)


def test_print_model_stats(capsys):
    conv = torch.nn.Conv2d(3, 4, 3)
    out = profiling.print_model_stats(conv, conv, torch.randn(1, 3, 8, 8))
    assert out["params"] == 4 * 3 * 9 + 4 and out["flops"] == 2 * 4 * 6 * 6 * 27
    assert "FLOPs: " in capsys.readouterr().out
