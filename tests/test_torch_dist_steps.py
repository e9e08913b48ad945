"""Train steps of the port in a gloo world of two processes on the CPU, each
rank on half of a global batch, against one step on the whole batch:

  * ``deeplab_resnet18`` at 64x64 with trainable BatchNorm (statistics
    across the ranks) and ignored pixels split unevenly (rank 0's half has
    most: CE divides by the group's count) against the JAX
    ``make_src_train_step`` on the global batch;
  * ``attn_efficientnet-b0`` (Tversky over the group, BCE) against the JAX
    step, with drop-connect off on both sides (its draws cannot equal
    ``jax.random``'s), and with drop-connect on against the port's own
    one-process step, whose masks every rank draws for the global batch;
  * one FADA step of ``deeplab_resnet18`` against the port's one-process
    step;
  * ``cli.train_src``'s trainer under DIST.INITIALIZE (rank 0's weights
    broadcast, BatchNorms across the ranks, each rank's slice of the global
    batches, checkpoints written in the background by the primary alone)
    for two epochs of two steps against the one-process trainer.

One world runs all four (``torch_dist_worker.case_steps``, a module-scoped
fixture with its own timeout).  Both ranks must end with equal parameters
and BatchNorm buffers, bit for bit.

Tolerances (train-mode BatchNorm on four images amplifies rounding, as
``tests/test_torch_deeplab.py`` and ``tests/test_torch_attn_train.py`` say;
the two-rank BatchNorm also takes its variance as E[x^2] - E[x]^2, as the
JAX layer does, where ``nn.BatchNorm2d`` does not): the loss within 1e-5
relative; the deeplab update per leaf within 5e-2 of its norm and over all
leaves within 2e-3 (measured 3.0e-2 at layer3's downsample norm and 5.7e-4;
the port's one-process step on the same batch measures the same against the
JAX step, so the batch's conditioning sets it, not the ranks); an Adam
part's update per leaf within 0.1 of its norm and over all leaves within
5e-3 (Adam moves an element whose gradient is rounding noise by a whole lr;
measured at most 2.5e-2 and 1.1e-3); the BatchNorm running statistics
within 1e-3 of their magnitude.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.models.build import build_segmentor as jax_build
from rnd_semantic_segmentation_tpu.models.efficientnet import EfficientNetEncoder as JaxEncoder
from rnd_semantic_segmentation_tpu.train.segmentor import Segmentor as JaxSegmentor
from rnd_semantic_segmentation_tpu.train.steps import (
    make_optimizers as jax_make_optimizers,
    make_src_train_step as jax_make_step,
)

from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    attn_flax_from_state_dicts,
    deeplab_flax_from_state_dicts,
)

import torch_dist_worker as W

torch.set_num_threads(2)  # six test workers share the host's cores

WORLD = 2


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    ranks, _ = W.run_world("steps", str(tmp_path_factory.mktemp("steps")), world=WORLD,
                           timeout=400)
    return ranks


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _state_dicts(seg):
    return {n: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for n, m in seg.spec.modules.items()}


def _from_npz(ranks, prefix, r=0):
    out = {}
    for key, value in ranks[r].items():
        head, _, rest = key.partition("/")
        if head == prefix and "/" in rest and not rest.startswith("metric/"):
            part, _, name = rest.partition("/")
            out.setdefault(part, {})[name] = torch.from_numpy(np.array(value))
    return out


def _jax_cfg(*opts):
    cfg = jax_default_cfg()
    cfg.merge_from_list(["MODEL.DTYPE", "float32", "SOLVER.EPOCHS", "2", "SOLVER.BASE_LR",
                         "1e-3", "SOLVER.BASE_LR_D", "1e-4", *opts])
    return cfg


def _jax_step(opts, to_flax, batch, drop_free_encoder=False):
    """One JAX step on the whole batch from the port's seeded weights:
    (template, params before, params after, stats after, loss)."""
    jcfg = _jax_cfg(*opts)
    spec = jax_build(jcfg)
    if drop_free_encoder:
        spec.modules["encoder"] = JaxEncoder(spec.backbone, drop_connect_rate=0.0)
    jseg = JaxSegmentor(spec, jcfg.MODEL.NUM_CLASSES)
    template = jax.eval_shape(jseg.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, W.STEP_SIZE, W.STEP_SIZE, 3),
                                                   jnp.float32))
    seg = W.port_segmentor(W.port_cfg(*opts), drop_connect=not drop_free_encoder)
    variables = to_flax(_state_dicts(seg), template)
    state = jseg.make_states(variables, jax_make_optimizers(spec, jcfg))
    start = _flat({n: m.params for n, m in state.modules.items()})
    step = jax.jit(jax_make_step(jseg, jcfg, W.STEPS_PER_EPOCH))
    state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                          jnp.float32(0))
    return (template, start, _flat({n: m.params for n, m in state.modules.items()}),
            _flat({n: {"batch_stats": m.stats["batch_stats"]}
                   for n, m in state.modules.items() if "batch_stats" in m.stats}),
            float(metrics["loss"]))


def _check_update(start, ref, got, per_leaf, overall=None):
    num = den = 0.0
    assert set(ref) == set(got)
    worst = []
    for key, r in ref.items():
        want, have = r - start[key], got[key] - start[key]
        assert np.abs(want).max() > 0, key   # every parameter moved
        err, scale = np.linalg.norm(have - want), np.linalg.norm(want)
        worst.append((err / scale, key))
        num, den = num + err ** 2, den + scale ** 2
    for ratio, key in worst:
        assert ratio <= per_leaf, f"{key}: {ratio} > {per_leaf}"
    if overall is not None:
        assert num ** 0.5 <= overall * den ** 0.5


def _check_stats(ref, got):
    assert set(ref) == set(got) and ref
    for key, r in ref.items():
        err = np.abs(got[key] - r).max()
        assert err <= 1e-3 * np.abs(r).max(), (key, err)


@pytest.mark.parametrize("prefix", ["deeplab", "attn", "attn_drop", "fada", "trainer"])
def test_both_ranks_end_with_the_same_state(steps, prefix):
    keys = [k for k in steps[0] if k.startswith(prefix + "/")
            and not k.endswith(("/blocked_ms", "/output_dir"))]
    assert keys and set(keys) <= set(steps[1])
    for key in keys:
        np.testing.assert_array_equal(steps[0][key], steps[1][key], err_msg=key)


def test_deeplab_step_on_two_ranks_matches_the_jax_step_on_the_global_batch(steps):
    batch = W.step_batch(5)
    template, start, ref, ref_stats, loss = _jax_step(W.DEEPLAB_OPTS,
                                                      deeplab_flax_from_state_dicts, batch)
    tree = deeplab_flax_from_state_dicts(_from_npz(steps, "deeplab"), template)
    got = _flat({n: t["params"] for n, t in tree.items()})
    stats = _flat({n: {"batch_stats": t["batch_stats"]} for n, t in tree.items()
                   if "batch_stats" in t})
    assert abs(float(steps[0]["deeplab/loss"]) - loss) <= 1e-5 * abs(loss)
    _check_update(start, ref, got, 5e-2, 2e-3)
    _check_stats(ref_stats, stats)
    assert len(ref_stats) == 2 * 20


def test_attn_step_on_two_ranks_matches_the_jax_step_on_the_global_batch(steps):
    batch = W.step_batch(2, seed=12)
    template, start, ref, ref_stats, loss = _jax_step(W.ATTN_OPTS, attn_flax_from_state_dicts,
                                                      batch, drop_free_encoder=True)
    tree = attn_flax_from_state_dicts(_from_npz(steps, "attn"), template)
    got = _flat({n: t["params"] for n, t in tree.items()})
    stats = _flat({n: {"batch_stats": t["batch_stats"]} for n, t in tree.items()})
    assert abs(float(steps[0]["attn/loss"]) - loss) <= 1e-5 * abs(loss)
    _check_update(start, ref, got, 0.1, 5e-3)
    _check_stats(ref_stats, stats)


def _one_process(prefix):
    """The port's one-process step on the whole batch: its state dicts and
    its loss (or FADA metrics), and the state dicts before it."""
    if prefix == "fada":
        cfg = W.port_cfg(*W.FADA_OPTS)
        src, tgt = W.fada_batches(3)
        seg, disc, metrics = W.fada_step(cfg, src, tgt)
        before = W.port_segmentor(cfg)
        start = {**_state_dicts(before), "model_D": W.randomize_weights_(
            W.build_adversarial_discriminator(cfg, before.spec), seed=11).state_dict()}
        return start, {**_state_dicts(seg), "model_D": disc.state_dict()}, metrics
    cfg = W.port_cfg(*W.ATTN_OPTS)
    seg, metrics = W.src_step(cfg, W.step_batch(2, seed=12), drop_connect=True)
    return _state_dicts(W.port_segmentor(cfg)), _state_dicts(seg), metrics


def _flat_parts(parts, names):
    return {f"{p}/{k}": v.detach().float().numpy() for p, sd in parts.items()
            for k, v in sd.items() if k in names[p]}


@pytest.mark.parametrize("prefix", ["attn_drop", "fada"])
def test_two_ranks_match_the_ports_one_process_step(steps, prefix):
    """attn with drop-connect on (the ranks draw the global batch's masks and
    keep their rows) and the FADA step (the segmentation loss over the
    group, the segmentor's and D's gradients averaged, the four losses the
    ranks' means)."""
    start, whole, metrics = _one_process(prefix)
    ranks = _from_npz(steps, prefix)
    if prefix == "fada":
        for key, value in metrics.items():
            got = float(steps[0][f"fada/metric/{key}"])
            assert abs(got - value) <= 1e-5 * abs(value), (key, got, value)
    else:
        assert abs(float(steps[0]["attn_drop/loss"]) - metrics["loss"]) \
            <= 1e-5 * abs(metrics["loss"])
        # drop-connect dropped something: the drop-free step moves other weights
        head = "encoder/encoder._conv_head.weight"
        assert not np.array_equal(steps[0][f"attn_drop/{head}"], steps[0][f"attn/{head}"])
    params = {p: {k for k, v in sd.items() if v.dtype.is_floating_point
                  and "running" not in k} for p, sd in whole.items()}
    _check_update(_flat_parts(start, params), _flat_parts(whole, params),
                  _flat_parts(ranks, params), 0.1, 5e-3)
    running = {p: {k for k in sd if "running" in k} for p, sd in whole.items()}
    _check_stats(_flat_parts(whole, running), _flat_parts(ranks, running))


def test_the_trainer_over_two_ranks_matches_the_one_process_trainer(steps, tmp_path):
    """The loss series and the weights after four steps; the primary wrote
    the config, the chart and the two checkpoints kept (KEEP_CHECKPOINTS 2,
    pruned before each save), which hold its weights; rank 1 waited at no
    save of its own."""
    one = W.train_run(str(tmp_path))
    # the first step's loss 1e-5 relative; rounding grows over four steps of
    # train-mode BatchNorm (measured 2.0e-4 at the fourth)
    np.testing.assert_allclose(steps[0]["trainer/loss"][0], one.loss_data[0], rtol=1e-5)
    np.testing.assert_allclose(steps[0]["trainer/loss"], one.loss_data, rtol=1e-3)
    whole = _state_dicts(one)
    params = {p: {k for k, v in sd.items() if "running" not in k and "num_batches" not in k}
              for p, sd in whole.items()}
    ranks = _from_npz(steps, "trainer")
    _check_update(_flat_parts(_state_dicts(W.port_segmentor(W.port_cfg(*W.DEEPLAB_OPTS))),
                              params),
                  _flat_parts(whole, params), _flat_parts(ranks, params), 0.1, 5e-3)
    out = str(steps[0]["trainer/output_dir"])
    assert sorted(os.listdir(out)) == ["Aspp-1.pth", "Aspp-2.pth", "config.yaml",
                                       "deeplab_chart_params.json"]
    saved = torch.load(os.path.join(out, "Aspp-2.pth"), map_location="cpu", weights_only=True)
    for part, sd in ranks.items():
        for key, value in sd.items():
            torch.testing.assert_close(saved[part][key].float(), value, rtol=0, atol=0)
    assert len(steps[0]["trainer/blocked_ms"]) == 2 and len(steps[1]["trainer/blocked_ms"]) == 0
