"""Whole training steps in MODEL.DTYPE bfloat16, the port against the JAX
package, on the CPU: a source step of ``deeplab_resnet18`` (BatchNorm) and
of ``attn_efficientnet-b0`` here; a FADA step of ``deeplab_resnet18``
(FrozenBN) and an online distillation step of ``attn_efficientnet-b0`` (its
teacher in bfloat16 too) in tests/test_torch_precision_adapt.py.  The attn encoders run without drop-connect on both sides
(the port's draws cannot equal ``jax.random``'s).

The criterion of tests/test_torch_precision.py, on whole steps: each
quantity's bfloat16 value differs from the float32 value of the same package
by at most twice the JAX package's difference plus 2^-8, relative to the
float32 value.  The quantities: the loss (each of FADA's four), and the
gradients (source steps: the JAX gradients from ``jax.value_and_grad`` of
the step's own forward and family loss) or the parameters' updates (FADA's
SGD, the online step's Adam), as one vector over all leaves.  The port's
outputs and tap have the JAX ones' types (taps bfloat16, heads resized in
float32), its losses, parameters and gradients are float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.models.build import build_segmentor as jax_build
from rnd_semantic_segmentation_tpu.models.efficientnet import EfficientNetEncoder as JaxEncoder
from rnd_semantic_segmentation_tpu.train.segmentor import Segmentor as JaxSegmentor
from rnd_semantic_segmentation_tpu.train.steps import make_family_loss as jax_family_loss
from rnd_semantic_segmentation_tpu.train.steps import make_optimizers as jax_make_optimizers

from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    attn_flax_from_state_dicts,
    deeplab_flax_from_state_dicts,
)
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.models.efficientnet import EfficientNetEncoder
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor
from rnd_semantic_segmentation_torch.train.state import TrainState, make_optimizers
from rnd_semantic_segmentation_torch.train.steps import make_src_train_step

torch.set_num_threads(2)  # six test workers share the host's cores

NC = 3
STEPS_PER_EPOCH = 10
FLOOR = 2.0 ** -8
DTYPES = ("float32", "bfloat16")
BRIDGES = {"deeplab": deeplab_flax_from_state_dicts, "attn": attn_flax_from_state_dicts}
BASE = ["MODEL.NUM_CLASSES", str(NC), "SOLVER.EPOCHS", "2", "SOLVER.BASE_LR", "1e-3",
        "SOLVER.BASE_LR_D", "1e-4", "SOLVER.WEIGHT_DECAY", "1e-4"]


def _opts(name, dtype, *more):
    return BASE + ["MODEL.NAME", name, "MODEL.DTYPE", dtype, *more]


def port_cfg(name, dtype, *more):
    cfg = get_default_cfg()
    cfg.merge_from_list(_opts(name, dtype, "MODEL.DEVICE", "cpu", *more))
    return cfg


def jax_cfg(name, dtype, *more):
    cfg = jax_default_cfg()
    cfg.merge_from_list(_opts(name, dtype, *more))
    return cfg


def _port_segmentor(cfg, seed=10):
    spec = build_segmentor(cfg)
    if spec.family == "attn":
        spec.modules["encoder"] = EfficientNetEncoder(spec.backbone, drop_connect_rate=0.0)
    return randomize_weights_(Segmentor(spec, NC), seed=seed)


def _state_dicts(seg):
    return {n: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for n, m in seg.spec.modules.items()}


def _jax_segmentor(jcfg, side):
    spec = jax_build(jcfg)
    if spec.family == "attn":
        spec.modules["encoder"] = JaxEncoder(spec.backbone, drop_connect_rate=0.0)
    jseg = JaxSegmentor(spec, NC)
    template = jax.eval_shape(jseg.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, side, side, 3), jnp.float32))
    return jseg, template


def _vector(leaves) -> np.ndarray:
    return np.concatenate([np.asarray(leaf, np.float64).ravel() for leaf in leaves])


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def hold(port, ref, what):
    """``port``, ``ref``: {dtype: value}.  Returns (port error, JAX error)."""
    e_port = _rel(port["bfloat16"], port["float32"])
    e_jax = _rel(ref["bfloat16"], ref["float32"])
    assert e_port <= 2 * e_jax + FLOOR, (what, e_port, e_jax)
    return e_port, e_jax


def _batch(side, seed=9, n=2, scale=1.0):
    rng = np.random.RandomState(seed)
    label = rng.randint(0, NC, (n, side, side)).astype(np.int32)
    label[:, :6, :10] = 255
    return {"image": (rng.rand(n, side, side, 3) * scale).astype(np.float32), "label": label}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _check_types(seg, x, dtype, jax_outputs, jax_tap):
    """The port's train-mode outputs and tap in the JAX ones' types."""
    with torch.no_grad():
        outputs, tap = seg(x.permute(0, 3, 1, 2).to(dtype), label_size=x.shape[1:3],
                           train=True)
    want = [str(o.dtype) for o in jax_outputs]
    assert [str(o.dtype).replace("torch.", "") for o in outputs] == want
    assert str(tap.dtype).replace("torch.", "") == str(jax_tap.dtype)


@pytest.mark.parametrize("name,side", [("deeplab_resnet18", 48), ("attn_efficientnet-b0", 64)])
def test_source_step_in_bfloat16(name, side):
    batch = _batch(side)
    losses, grads, jlosses, jgrads = {}, {}, {}, {}
    for dtype in DTYPES:
        cfg = port_cfg(name, dtype)
        seg = _port_segmentor(cfg)
        start = _state_dicts(seg)
        state = TrainState(optimizers=make_optimizers(seg.spec, cfg))
        losses[dtype] = make_src_train_step(seg, cfg, STEPS_PER_EPOCH, state)(
            _torch(batch), 0.0)["loss"]
        params = [p for m in seg.spec.modules.values() for p in m.parameters()]
        assert all(p.dtype == p.grad.dtype == torch.float32 for p in params)
        grads[dtype] = _vector(p.grad.numpy() for p in params)

        jcfg = jax_cfg(name, dtype)
        jseg, template = _jax_segmentor(jcfg, side)
        variables = BRIDGES[jseg.spec.family](start, template)
        jstate = jseg.make_states(variables, jax_make_optimizers(jseg.spec, jcfg))
        jparams = {n: m.params for n, m in jstate.modules.items()}
        stats = {n: m.stats for n, m in jstate.modules.items()}
        loss_fn = jax_family_loss(jseg.spec, NC, 255)
        x = jnp.asarray(batch["image"]).astype(jnp.dtype(dtype))
        label = jnp.asarray(batch["label"])

        def compute(p):
            outputs, _, tap = jseg.forward(p, stats, x, label_size=label.shape[1:3],
                                           train=True, rngs={"dropout": jax.random.PRNGKey(0)})
            return loss_fn(outputs, label), (outputs, tap)

        (jloss, (jouts, jtap)), g = jax.jit(jax.value_and_grad(compute, has_aux=True))(jparams)
        assert jloss.dtype == jnp.float32
        jlosses[dtype] = float(jloss)
        jgrads[dtype] = _vector(jax.tree_util.tree_leaves(g))
        _check_types(seg, torch.from_numpy(batch["image"]), getattr(torch, dtype), jouts, jtap)
    assert abs(losses["float32"] - jlosses["float32"]) <= 1e-4 * abs(jlosses["float32"])
    hold(losses, jlosses, "loss")
    hold(grads, jgrads, "gradients")
