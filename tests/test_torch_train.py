"""The port's GALD training slice against the JAX package's, on the CPU in float32.

Weights come from the port's ``randomize_weights_`` (criss-cross ``gamma`` at
0.7, so the attention and its gradient carry signal) and reach the JAX tree
through ``gald_flax_from_state_dicts``; gradients and updated parameters come
back the same way and are compared leaf by leaf.  The JAX side runs its own
loss closure and its own ``make_src_train_step``, jitted once per module.

Conditioning decides the tolerances.  In train mode this network, with random
weights at this size, is badly conditioned: every BatchNorm divides by batch
statistics, and the port's own float32 gradients differ from its float64
gradients by up to 26% of a leaf's largest magnitude (outputs by 1.6e-4),
because ReLU gates of near-zero activations fall either way and a weight
gradient is a sum of terms of random sign.  In eval mode the same comparison
gives 7e-3 (outputs 2e-6).  So the gradient wiring of every layer is held
tightly in eval mode, BatchNorm's train-mode arithmetic is held tightly on the
layer alone, and the whole train-mode step is held as tightly as its
conditioning allows:
  * eval-mode loss 1e-5 relative, gradients 2e-2 of each leaf's largest
    magnitude; a leaf below 1e-3 of the largest leaf is held to that floor;
  * train-mode outputs 2e-3 of the largest magnitude, loss 1e-5 relative, BN
    running statistics 3e-3, gradients 0.3 of each leaf's norm (a leaf
    below 1e-3 of the largest norm is held to that floor) and 0.15 in the
    norm over all leaves; a leaf whose true gradient is zero (a conv bias
    under a batch-statistics BN) holds rounding noise on both sides and falls
    under the floor;
  * optimizers on identical gradients: rtol 1e-5 plus 3e-6, which is 3e-5 of
    the largest step (0.1): the same formula evaluated in another order;
  * a whole step: loss and LR of the first step 1e-5; after it, every
    parameter has moved by at most lr, and where both sides' gradients have
    one sign and exceed 1e-5 (a thousand times Adam's eps) the parameters
    agree to 2e-3 of lr, because one Adam step moves an element by
    lr*g/(|g|+eps) whatever the size of g; the second step's loss 2e-2.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from rnd_semantic_segmentation_tpu import losses as jax_losses
from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from rnd_semantic_segmentation_tpu.data.loader import DataLoader as JaxLoader
from rnd_semantic_segmentation_tpu.models.build import build_segmentor as jax_build
from rnd_semantic_segmentation_tpu.train import schedules as jax_schedules
from rnd_semantic_segmentation_tpu.train import state as jax_state
from rnd_semantic_segmentation_tpu.train.segmentor import Segmentor as JaxSegmentor
from rnd_semantic_segmentation_tpu.train.steps import (
    make_family_loss as jax_family_loss,
    make_optimizers as jax_make_optimizers,
    make_src_train_step as jax_make_step,
)

from rnd_semantic_segmentation_torch import losses
from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    gald_flax_from_state_dicts,
    gald_state_dicts_from_flax,
)
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.data import DataLoader, SyntheticDataset, build_dataset
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.train import schedules
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor
from rnd_semantic_segmentation_torch.train.state import (
    TrainState,
    apply_updates,
    make_optimizer,
    make_optimizers,
)
from rnd_semantic_segmentation_torch.train.steps import (
    make_family_loss,
    make_lr_schedule,
    make_src_train_step,
)

torch.set_num_threads(2)  # six test workers share the host's cores

SIZE = 224
NC = 3
STEPS_PER_EPOCH = 10
OPTS = ["MODEL.NAME", "gald_hardnet68", "MODEL.NUM_CLASSES", str(NC),
        "MODEL.DTYPE", "float32", "SOLVER.BASE_LR", "1e-4", "SOLVER.EPOCHS", "2"]


def port_cfg(*opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(OPTS + ["MODEL.DEVICE", "cpu", *opts])
    return cfg


def jax_cfg(*opts):
    cfg = jax_default_cfg()
    cfg.merge_from_list(OPTS + list(opts))
    return cfg


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _port_segmentor(seed=0):
    seg = Segmentor(build_segmentor(port_cfg()), NC)
    randomize_weights_(seg, seed=seed)
    return seg


def _state_dicts(seg):
    return {n: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for n, m in seg.spec.modules.items()}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    label = rng.randint(0, NC, (2, SIZE, SIZE)).astype(np.int32)
    label[:, :40, :60] = 255  # some pixels ignored
    return {"image": rng.rand(2, SIZE, SIZE, 3).astype(np.float32), "label": label}


@pytest.fixture(scope="module")
def jax_segmentor():
    return JaxSegmentor(jax_build(jax_cfg()), NC)


@pytest.fixture(scope="module")
def template(jax_segmentor, batch):
    init = jax.jit(jax_segmentor.init)(jax.random.PRNGKey(0), jnp.asarray(batch["image"][:1]))
    return jax.tree.map(np.asarray, init)


@pytest.fixture(scope="module")
def jax_variables(template):
    """The port's seeded weights, laid out as the JAX variables."""
    variables = gald_flax_from_state_dicts(_state_dicts(_port_segmentor()), template)
    back = gald_state_dicts_from_flax(variables)
    for part, sd in _state_dicts(_port_segmentor()).items():  # the bridge round-trips
        for key, value in sd.items():
            if not key.endswith("num_batches_tracked"):
                assert torch.equal(back[part][key], value), (part, key)
    return variables


def _jax_loss_and_grads(jax_segmentor, jax_variables, batch, train):
    loss_fn = jax_family_loss(jax_segmentor.spec, NC, 255)
    params = {n: v["params"] for n, v in jax_variables.items()}
    stats = {n: {"batch_stats": v["batch_stats"]} for n, v in jax_variables.items()}
    x, y = jnp.asarray(batch["image"]), jnp.asarray(batch["label"])

    def compute_loss(params):
        outputs, new_stats, _ = jax_segmentor.forward(params, stats, x, train=train, rngs={})
        return loss_fn(outputs, y), (new_stats, outputs)

    (loss, (new_stats, outputs)), grads = jax.jit(
        jax.value_and_grad(compute_loss, has_aux=True))(params)
    return float(loss), _flat(grads), _flat(new_stats), [np.asarray(o) for o in outputs]


def _port_loss_and_grads(batch, train):
    seg = _port_segmentor()
    outputs, _ = seg(_nchw(batch["image"]), train=train)
    loss = make_family_loss(seg.spec, NC, 255)(outputs, torch.from_numpy(batch["label"]))
    loss.backward()
    return seg, loss.item(), [o.detach().permute(0, 2, 3, 1).numpy() for o in outputs]


@pytest.fixture(scope="module")
def jax_loss_and_grads(jax_segmentor, jax_variables, batch):
    return _jax_loss_and_grads(jax_segmentor, jax_variables, batch, train=True)


@pytest.fixture(scope="module")
def port_loss_and_grads(batch):
    return _port_loss_and_grads(batch, train=True)


def _port_grads_as_flax(seg, template):
    grads = {n: {k: p.grad for k, p in m.named_parameters()}
             for n, m in seg.spec.modules.items()}
    assert all(g is not None for part in grads.values() for g in part.values())
    tree = gald_flax_from_state_dicts(grads, template)
    return _flat({n: t["params"] for n, t in tree.items()})


def _assert_leaves_close(got, ref, rel, floor_share=0.0):
    assert set(got) == set(ref)
    top = max(np.abs(r).max() for r in ref.values())
    for key, r in ref.items():
        scale = max(np.abs(r).max(), floor_share * top)
        err = np.abs(got[key] - r).max()
        assert got[key].shape == r.shape and err <= rel * scale, \
            f"{key}: max abs error {err} > {rel} x {scale}"


def test_eval_mode_loss_and_every_gradient_leaf_match(jax_segmentor, jax_variables,
                                                      template, batch):
    ref_loss, ref_grads, _, ref_outputs = _jax_loss_and_grads(jax_segmentor, jax_variables,
                                                              batch, train=False)
    seg, loss, outputs = _port_loss_and_grads(batch, train=False)
    for out, ref in zip(outputs, ref_outputs):
        assert np.abs(out - ref).max() <= 2e-5 * np.abs(ref).max()
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    got = _port_grads_as_flax(seg, template)
    assert len(got) == len(ref_grads) == 309
    _assert_leaves_close(got, ref_grads, 2e-2, floor_share=1e-3)
    for leaf in ("query_conv", "key_conv", "value_conv"):
        for name in ("kernel", "bias"):
            key = f"['decoder']['long_relation']['{leaf}']['{name}']"
            assert np.abs(got[key]).max() > 1e-3 * np.abs(ref_grads[key]).max() > 0
    assert abs(got["['decoder']['long_relation']['gamma']"][0]) > 0


def test_train_forward_and_loss_match(jax_loss_and_grads, port_loss_and_grads):
    ref_loss, _, _, ref_outputs = jax_loss_and_grads
    _, loss, outputs = port_loss_and_grads
    for out, ref in zip(outputs, ref_outputs):
        assert out.shape == ref.shape == (2, SIZE, SIZE, NC)
        assert np.abs(out - ref).max() <= 2e-3 * np.abs(ref).max()
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)


def test_train_mode_gradients_match_within_their_conditioning(
        jax_loss_and_grads, port_loss_and_grads, template):
    _, ref_grads, _, _ = jax_loss_and_grads
    seg, _, _ = port_loss_and_grads
    got = _port_grads_as_flax(seg, template)
    top = max(np.linalg.norm(r) for r in ref_grads.values())
    worst = max((np.linalg.norm(got[k] - r) / max(np.linalg.norm(r), 1e-3 * top), k)
                for k, r in ref_grads.items())
    assert worst[0] <= 0.3, worst
    err = np.sqrt(sum(np.square(got[k] - r).sum() for k, r in ref_grads.items()))
    assert err <= 0.15 * np.sqrt(sum(np.square(r).sum() for r in ref_grads.values()))


def test_bn_running_statistics_after_a_train_forward(jax_loss_and_grads,
                                                     port_loss_and_grads, template):
    _, _, ref_stats, _ = jax_loss_and_grads
    seg, _, _ = port_loss_and_grads
    tree = gald_flax_from_state_dicts(_state_dicts(seg), template)
    got = _flat({n: {"batch_stats": t["batch_stats"]} for n, t in tree.items()})
    _assert_leaves_close(got, ref_stats, 3e-3)
    before = _flat({n: {"batch_stats": v["batch_stats"]} for n, v in
                    gald_flax_from_state_dicts(_state_dicts(_port_segmentor()),
                                               template).items()})
    assert any(np.abs(got[k] - before[k]).max() > 1e-3 for k in got)  # they did move


def test_batchnorm_train_mode_matches_the_jax_layer():
    """Biased variance normalises, the unbiased one goes into running_var."""
    from rnd_semantic_segmentation_tpu.models.layers import BatchNorm as JaxBN
    from rnd_semantic_segmentation_torch.models.layers import BatchNorm

    rng = np.random.RandomState(1)
    x = (rng.randn(3, 5, 4, 6) * 2 + 1).astype(np.float32)  # NHWC
    variables = {"params": {"scale": rng.rand(6).astype(np.float32) + 0.5,
                            "bias": rng.randn(6).astype(np.float32)},
                 "batch_stats": {"mean": rng.randn(6).astype(np.float32),
                                 "var": rng.rand(6).astype(np.float32) + 0.5}}
    ref, mut = JaxBN().apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    bn = BatchNorm(6).train()
    bn.load_state_dict({"weight": torch.from_numpy(variables["params"]["scale"]),
                        "bias": torch.from_numpy(variables["params"]["bias"]),
                        "running_mean": torch.from_numpy(variables["batch_stats"]["mean"]),
                        "running_var": torch.from_numpy(variables["batch_stats"]["var"])},
                       strict=False)
    out = bn(_nchw(x)).detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), mut["batch_stats"]["mean"],
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), mut["batch_stats"]["var"],
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("kind,kwargs,clip", [
    ("adam", {}, 0.0),
    ("adam", {"weight_decay": 5e-4}, 0.0),
    ("sgd", {"momentum": 0.9, "weight_decay": 5e-4}, 0.0),
    ("sgd", {"momentum": 0.9}, 0.5),
])
def test_optimizers_on_identical_gradients(kind, kwargs, clip):
    """Three steps, two parts at LR multipliers 1 and 10, the same numpy
    gradients on both sides.  Gradients span 1e-6..1, all well above eps."""
    rng = np.random.RandomState(2)
    shapes = {"w": (4, 3, 3, 3), "b": (7,)}
    mults = {"encoder": 1.0, "decoder": 10.0}
    init = {part: {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
            for part in mults}
    grads = [{part: {k: (rng.randn(*s) * 10.0 ** rng.uniform(-6, 0, s)).astype(np.float32)
                     for k, s in shapes.items()} for part in mults} for _ in range(3)]
    lrs = [1e-2, 7e-3, 4e-3]

    params = {part: {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in tree.items()}
              for part, tree in init.items()}
    opts = {part: make_optimizer(kind, tree.values(), **kwargs)
            for part, tree in params.items()}
    tx = jax_state.make_optimizer(kind, **({"momentum": 0.9} | kwargs))
    states = {part: jax_state.ModuleState(params=jax.tree.map(jnp.asarray, tree), stats={},
                                          opt_state=tx.init(jax.tree.map(jnp.asarray, tree)))
              for part, tree in init.items()}
    for lr, g in zip(lrs, grads):
        for part, mult in mults.items():
            for k, p in params[part].items():
                p.grad = torch.from_numpy(g[part][k].copy())
            apply_updates(opts[part], lr * mult, grad_clip=clip)
            states[part] = jax_state.apply_updates(
                states[part], jax.tree.map(jnp.asarray, g[part]), tx, lr * mult,
                grad_clip=clip)
    for part in mults:
        for k, p in params[part].items():
            ref = np.asarray(states[part].params[k])
            assert np.abs(ref - init[part][k]).max() > 1e-4  # it moved
            np.testing.assert_allclose(p.detach().numpy(), ref, rtol=1e-5, atol=3e-6)


def test_make_optimizers_follow_the_family():
    spec = build_segmentor(port_cfg())
    opts = make_optimizers(spec, port_cfg())
    assert set(opts) == {"encoder", "decoder"} and spec.lr_mults == {"encoder": 1.0,
                                                                    "decoder": 10.0}
    for opt in opts.values():
        group = opt.param_groups[0]
        assert isinstance(opt, torch.optim.Adam) and group["weight_decay"] == 0.0
        assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8


def test_whole_step_matches_the_jax_step(jax_segmentor, jax_variables, jax_loss_and_grads,
                                         template, batch):
    jcfg = jax_cfg()
    state = jax_segmentor.make_states(jax_variables,
                                      jax_make_optimizers(jax_segmentor.spec, jcfg))
    jstep = jax_make_step(jax_segmentor, jcfg, STEPS_PER_EPOCH)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state, m1 = jstep(state, jbatch, jnp.float32(0))
    ref = _flat({n: m.params for n, m in state.modules.items()})   # after one step
    state, m2 = jstep(state, jbatch, jnp.float32(0))
    _, ref_grads, _, _ = jax_loss_and_grads   # the first step's gradients

    seg = _port_segmentor()
    start = _flat({n: t["params"] for n, t in
                   gald_flax_from_state_dicts(_state_dicts(seg), template).items()})
    tstate = TrainState(optimizers=make_optimizers(seg.spec, port_cfg()))
    step = make_src_train_step(seg, port_cfg(), STEPS_PER_EPOCH, tstate)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    p1 = step(tbatch, 0.0)
    grads = _port_grads_as_flax(seg, template)
    got = _flat({n: t["params"] for n, t in
                 gald_flax_from_state_dicts(_state_dicts(seg), template).items()})
    p2 = step(tbatch, 0.0)
    assert tstate.step == 2 == int(state.step)
    assert abs(p1["loss"] - float(m1["loss"])) <= 1e-5 * p1["loss"]
    assert abs(p2["loss"] - float(m2["loss"])) <= 2e-2 * p2["loss"]
    for port, jx in ((p1, m1), (p2, m2)):
        assert abs(port["lr"] - float(jx["lr"])) <= 1e-6 * port["lr"]
    assert p1["lr"] == 1e-4 and p2["lr"] == pytest.approx(1e-4 * (1 - 1 / 20) ** 0.9)

    checked = total = 0
    for key, r in ref.items():
        lr = 1e-4 * (10.0 if key.startswith("['decoder']") else 1.0)
        ulp = 2.5e-7 * max(np.abs(r).max(), 1.0)
        for side in (got[key], r):   # one Adam step moves an element by at most lr
            assert np.abs(side - start[key]).max() <= lr * 1.001 + ulp, key
        clear = ((np.sign(grads[key]) == np.sign(ref_grads[key]))
                 & (np.abs(grads[key]) > 1e-5) & (np.abs(ref_grads[key]) > 1e-5))
        if clear.any():
            assert np.abs(got[key] - r)[clear].max() <= 2e-3 * lr + ulp, key
            assert np.abs(r - start[key])[clear].min() >= 0.99 * lr - ulp, key
        checked += clear.sum()
        total += clear.size
    assert checked > 0.5 * total, (checked, total)


def test_cross_entropy_with_some_and_with_all_pixels_ignored():
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 6, 5, 4).astype(np.float32)        # NHWC
    label = rng.randint(0, 4, (2, 6, 5)).astype(np.int32)
    label[0, :3] = 255
    x = _nchw(logits).requires_grad_()
    got = losses.cross_entropy(x, torch.from_numpy(label))
    ref = jax_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(label))
    assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))
    got.backward()
    gref = jax.grad(lambda l: jax_losses.cross_entropy(l, jnp.asarray(label)))(jnp.asarray(logits))
    np.testing.assert_allclose(x.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gref),
                               atol=1e-7, rtol=1e-5)

    ignored = np.full_like(label, 255)
    x = _nchw(logits).requires_grad_()
    got = losses.cross_entropy(x, torch.from_numpy(ignored))
    got.backward()
    assert float(got) == 0.0 == float(jax_losses.cross_entropy(jnp.asarray(logits),
                                                               jnp.asarray(ignored)))
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() == 0


@pytest.mark.parametrize("name,args", [
    ("poly_lr", (0.02, 37, 100, 0.9)), ("poly_lr", (0.02, 100, 100, 0.9)),
    ("poly_lr", (0.02, 250, 100, 0.9)),                      # past max_iter: 0, not NaN
    ("step_decay_lr", (0.02, 65, 0.1, 30)),
    ("warmup_cosine_lr", (0.02, 2)), ("warmup_cosine_lr", (0.02, 5)),
    ("warmup_cosine_lr", (0.02, 31)),
    ("gradual_warmup_cosine_lr", (0.02, 3)), ("gradual_warmup_cosine_lr", (0.02, 5)),
    ("gradual_warmup_cosine_lr", (0.02, 40)),
])
def test_schedules_match(name, args):
    got = getattr(schedules, name)(*args)
    ref = float(getattr(jax_schedules, name)(*args))
    assert isinstance(got, float) and np.isfinite(got)
    assert abs(got - ref) <= 1e-6 * max(abs(ref), 1e-12)
    if args[1] == 250:
        assert got == 0.0


def test_lr_schedule_with_batch_reference_and_warmup():
    spec = build_segmentor(port_cfg())
    cfg = port_cfg("SOLVER.LR_BATCH_REF", "4", "SOLVER.BATCH_SIZE", "8",
                   "SOLVER.WARMUP_ITERS", "5")
    sched = make_lr_schedule(spec, cfg, STEPS_PER_EPOCH)
    assert sched(0.0, 0.0) == pytest.approx(2e-4 * 1 / 5)
    assert sched(10.0, 1.0) == pytest.approx(2e-4 * 0.5 ** 0.9)
    with pytest.raises(NotImplementedError):
        make_lr_schedule(spec, port_cfg("SOLVER.LR_METHOD", "exotic"), STEPS_PER_EPOCH)


def test_accum_steps_average_micro_batch_gradients():
    """ACCUM_STEPS 2 on a batch of 4: the gradient is the mean of the two
    micro-batch gradients, the second taken with the BN statistics the first
    left behind."""
    rng = np.random.RandomState(4)
    image = _nchw(rng.rand(4, SIZE, SIZE, 3).astype(np.float32))
    label = torch.from_numpy(rng.randint(0, NC, (4, SIZE, SIZE)).astype(np.int32))
    seg = _port_segmentor()
    cfg = port_cfg("SOLVER.ACCUM_STEPS", "2")
    tstate = TrainState(optimizers=make_optimizers(seg.spec, cfg))
    for opt in tstate.optimizers.values():   # see the gradients, not the update
        opt.step = lambda: None
    metrics = make_src_train_step(seg, cfg, STEPS_PER_EPOCH, tstate)(
        {"image": image.permute(0, 2, 3, 1), "label": label}, 0.0)

    ref = _port_segmentor()
    loss_fn = make_family_loss(ref.spec, NC, 255)
    total = 0.0
    for i in (0, 2):
        outputs, _ = ref(image[i:i + 2], train=True)
        loss = loss_fn(outputs, label[i:i + 2]) / 2
        loss.backward()
        total += loss.item()
    assert metrics["loss"] == pytest.approx(total, rel=1e-6) and tstate.step == 1
    for (name, p), (_, r) in zip(seg.named_parameters(), ref.named_parameters()):
        torch.testing.assert_close(p.grad, r.grad, atol=1e-6 * float(r.grad.abs().max()) + 1e-12,
                                   rtol=1e-5, msg=name)
    for (name, b), (_, r) in zip(seg.named_buffers(), ref.named_buffers()):
        torch.testing.assert_close(b, r, msg=name)


def test_synthetic_dataset_and_batch_order_equal_the_jax_packages():
    kw = dict(size=(24, 32), num_classes=4, length=10, seed=3)
    port_ds, jax_ds = SyntheticDataset(**kw), JaxSynthetic(**kw)
    assert len(port_ds) == len(jax_ds) == 10
    for variant in ("none", "swap"):
        a, b = SyntheticDataset(shift=variant, **kw)[7], JaxSynthetic(shift=variant, **kw)[7]
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2] == "synthetic_00007"
    port, ref = (cls(ds, batch_size=3, shuffle=True, drop_last=True, num_workers=2, seed=5)
                 for cls, ds in ((DataLoader, port_ds), (JaxLoader, jax_ds)))
    assert len(port) == len(ref) == 3
    names = []
    for epoch in (1, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for pb, rb in zip(port, ref, strict=True):
            assert pb["name"] == rb["name"]
            np.testing.assert_array_equal(pb["image"], rb["image"])
            np.testing.assert_array_equal(pb["label"], rb["label"])
            assert pb["image"].dtype == np.float32 and pb["label"].dtype == np.int32
            names.append(pb["name"])
    assert names[:3] != names[3:]  # the epochs shuffle differently


def test_catalog_builds_synthetic_and_refuses_the_rest():
    cfg = port_cfg("DATASETS.SOURCE_TRAIN", "synthetic_train", "DATASETS.TEST",
                   "synthetic_val", "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(48, 32)",
                   "INPUT.INPUT_SIZE_TEST", "(40, 24)", "DATASETS.SYNTHETIC_LENGTH", "5",
                   "AUG.NAME", "gald")
    train, val = build_dataset(cfg, "train"), build_dataset(cfg, "test")
    assert len(train) == 5 and train[0][0].shape == (32, 48, 3)
    assert val[0][0].shape == (24, 40, 3) and val[0][1].max() < NC
    with pytest.raises(RuntimeError, match="imagenet_train"):
        build_dataset(port_cfg("DATASETS.SOURCE_TRAIN", "imagenet_train", "AUG.NAME", "gald"),
                      "train")
    # the parallelism slice: the native decoder, and a process's shard
    assert build_dataset(port_cfg("DATASETS.SOURCE_TRAIN", "synthetic_train",
                                  "DATA_PIPE.NATIVE_DECODE", "True"), "train").use_native_decode
    shard = DataLoader(train, batch_size=2, process_shard=True, process_index=1,
                       process_count=2, shuffle=False, drop_last=False)
    assert [b["name"] for b in shard] == [["synthetic_00001", "synthetic_00003"]]
    assert shard.left_out() == [4]


def test_unported_step_knobs_and_families_raise():
    seg = _port_segmentor()
    cfg = port_cfg("MODEL.DTYPE", "float16")
    with pytest.raises(NotImplementedError):
        make_src_train_step(seg, cfg, STEPS_PER_EPOCH,
                            TrainState(optimizers=make_optimizers(seg.spec, cfg)))
    # DEBUG.CHECKIFY no longer waits: the step builds, and the trainers wrap
    # it in train/checkify.py's float checks (tests/test_torch_checkify.py),
    # as the JAX trainers wrap theirs
    cfg = port_cfg("DEBUG.CHECKIFY", "True")
    assert callable(make_src_train_step(seg, cfg, STEPS_PER_EPOCH,
                                        TrainState(optimizers=make_optimizers(seg.spec, cfg))))

    class Spec:
        family = "hrnet"  # a family neither package builds
    with pytest.raises(NotImplementedError, match="hrnet"):
        make_family_loss(Spec, NC)
