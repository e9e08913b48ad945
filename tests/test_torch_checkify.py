"""DEBUG.CHECKIFY in the port (train/checkify.py) against the JAX package's
``checkify.float_checks`` (``wrap_step_checkify``), on the CPU.

  * Small functions, one float op each where it matters: both raise for a
    NaN made by an op (log of -1, sqrt of -1, 0 x inf, inf - inf) and for a
    division by a divisor holding a zero; neither raises for an overflow to
    Inf or a clean function;
  * a ``deeplab_resnet18`` source step at 32 x 32 (the JAX package's own
    checkify test, tests/test_debug_nans.py): a batch with a NaN pixel, or an
    Inf pixel (which the first conv turns into inf - inf), raises in both
    packages, the port's ``FloatingPointError`` naming the aten op and the
    module; a clean step raises in neither, and under the checks it leaves
    parameters, BatchNorm statistics and optimizer state bit-equal to the
    step without them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.models import build_segmentor as jax_build
from rnd_semantic_segmentation_tpu.train import Segmentor as JaxSegmentor
from rnd_semantic_segmentation_tpu.train import make_optimizers as jax_optimizers
from rnd_semantic_segmentation_tpu.train import make_src_train_step as jax_step
from rnd_semantic_segmentation_tpu.train import wrap_step_checkify as jax_wrap

from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.train.checkify import FloatChecks, wrap_step_checkify
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor
from rnd_semantic_segmentation_torch.train.state import TrainState, make_optimizers
from rnd_semantic_segmentation_torch.train.steps import make_src_train_step

torch.set_num_threads(2)  # six test workers share the host's cores

FUNCTIONS = {
    # name: (jax function, port function, raises)
    "log_of_negative": (lambda x: jnp.log(x - 2.0), lambda x: torch.log(x - 2.0), True),
    "sqrt_of_negative": (lambda x: jnp.sqrt(-x), lambda x: torch.sqrt(-x), True),
    "zero_times_inf": (lambda x: (x * 0.0) * jnp.inf, lambda x: (x * 0.0) * float("inf"), True),
    "division_by_zero": (lambda x: x / (x - x), lambda x: x / (x - x), True),
    "overflow_to_inf": (lambda x: jnp.exp(x * 1000.0), lambda x: torch.exp(x * 1000.0), False),
    "clean": (lambda x: jnp.tanh(x) / (x * x + 1.0), lambda x: torch.tanh(x) / (x * x + 1.0),
              False),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_float_checks_flag_what_checkify_flags(name):
    jax_fn, port_fn, raises = FUNCTIONS[name]
    x = np.linspace(0.5, 1.5, 6, dtype=np.float32)
    err, _ = checkify.checkify(jax_fn, errors=checkify.float_checks)(jnp.asarray(x))
    assert (err.get() is not None) == raises
    checks = FloatChecks()
    with checks:
        port_fn(torch.from_numpy(x))
    bad = checks.first()
    assert (bad is not None) == raises
    if raises:
        what = "division by zero" if name == "division_by_zero" else "nan generated"
        assert bad[0] == what and bad[1].startswith("aten.")


def _port_setup(seed=0):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", "deeplab_resnet18", "MODEL.NUM_CLASSES", "3",
                         "MODEL.FREEZE_BN", "True", "SOLVER.BASE_LR", "1e-4",
                         "SOLVER.EPOCHS", "1", "MODEL.DEVICE", "cpu",
                         "MODEL.DTYPE", "float32"])
    spec = build_segmentor(cfg)
    for module in spec.modules.values():
        randomize_weights_(module, seed)
    seg = Segmentor(spec, 3)
    state = TrainState(optimizers=make_optimizers(spec, cfg))
    return seg, state, make_src_train_step(seg, cfg, 10, state)


def _batches():
    rng = np.random.RandomState(0)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 3, size=(2, 32, 32)).astype(np.int64)
    nan, inf = x.copy(), x.copy()
    nan[0, 0, 0, 0] = np.nan
    inf[1, 5, 7, 2] = np.inf
    return {"clean": x, "nan_pixel": nan, "inf_pixel": inf}, y


@pytest.fixture(scope="module")
def jax_raises():
    """Which batches the JAX package's checkified step raises on."""
    cfg = jax_default_cfg()
    cfg.MODEL.NAME = "deeplab_resnet18"
    cfg.MODEL.NUM_CLASSES = 3
    cfg.MODEL.FREEZE_BN = True
    cfg.MODEL.DTYPE = "float32"
    cfg.SOLVER.BASE_LR = 1e-4
    cfg.SOLVER.EPOCHS = 1
    spec = jax_build(cfg)
    seg = JaxSegmentor(spec, 3)
    variables = seg.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    step = jax_wrap(jax_step(seg, cfg, steps_per_epoch=10))
    xs, y = _batches()
    out = {}
    for name, x in xs.items():
        # the step donates its state: each batch starts from a copy
        state = seg.make_states(jax.tree.map(jnp.copy, variables), jax_optimizers(spec, cfg))
        try:
            _, metrics = step(state, {"image": jnp.asarray(x), "label": jnp.asarray(y)},
                              jnp.float32(0))
            float(metrics["loss"])
            out[name] = None
        except Exception as exc:  # checkify's JaxRuntimeError
            out[name] = str(exc)
    return out


@pytest.mark.parametrize("batch", ["clean", "nan_pixel", "inf_pixel"])
def test_checkified_step_raises_where_the_jax_step_raises(jax_raises, batch):
    xs, y = _batches()
    seg, state, step = _port_setup()
    checked = wrap_step_checkify(step, seg.spec.modules)
    data = {"image": torch.from_numpy(xs[batch]), "label": torch.from_numpy(y)}
    if jax_raises[batch] is None:
        assert batch == "clean"
        metrics = checked(data, 0)
        assert np.isfinite(metrics["loss"])
        return
    # both name the convolution that made the first NaN: the stem conv for a
    # NaN pixel, layer1's first conv for an Inf one (the stem gives +-Inf,
    # which the next conv's sums turn into inf - inf)
    assert "nan generated by primitive: conv_general_dilated" in jax_raises[batch]
    with pytest.raises(FloatingPointError,
                       match=r"nan generated: aten op aten\.convolution") as info:
        checked(data, 0)
    where = {"nan_pixel": "conv1", "inf_pixel": "layer1.0.conv1"}[batch]
    assert str(info.value).endswith(f"in module feature_extractor.backbone.{where}")


def test_clean_step_is_bit_equal_with_and_without_the_checks():
    xs, y = _batches()
    data = {"image": torch.from_numpy(xs["clean"]), "label": torch.from_numpy(y)}
    runs = []
    for wrap in (False, True):
        seg, state, step = _port_setup()
        if wrap:
            step = wrap_step_checkify(step, seg.spec.modules)
        losses = [step(data, 0)["loss"] for _ in range(2)]
        opt_state = [v for opt in state.optimizers.values()
                     for s in opt.state.values() for v in s.values()
                     if isinstance(v, torch.Tensor)]
        runs.append((losses, list(seg.state_dict().values()), opt_state))
    (l0, sd0, o0), (l1, sd1, o1) = runs
    assert l0 == l1 and len(sd0) == len(sd1) and len(o0) == len(o1) > 0
    assert all(torch.equal(a, b) for a, b in zip(sd0, sd1))
    assert all(torch.equal(a, b) for a, b in zip(o0, o1))
