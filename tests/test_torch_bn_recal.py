"""The port's BatchNorm recalibration (train/bn_recal.py) and the source
trainer's hook (SOLVER.BN_RECAL_BATCHES) against the JAX package's, on the
CPU in float32.

Weights come from the port's ``randomize_weights_`` and reach the JAX trees
through the ``*_flax_from_state_dicts`` bridges; the JAX function's
statistics come back through ``*_state_dicts_from_flax``.  Both packages
recalibrate over the same three batches.

Tolerances, of each layer's largest magnitude: deeplab_resnet18's running
means and variances within 2e-5 of the JAX function's (3.1e-6 measured).
pranet_res2net50's train-mode forward on two images at 64x64 is badly
conditioned, and the JAX BatchNorm takes the variance as E[x^2] - E[x]^2 in
float32: against the port's float64 recalibration the port is within 5e-4
(2.4e-4 measured, median 3.2e-6) and the JAX function within 2e-3 (1.0e-3
measured, median 1.8e-5), and the two within 2e-3 of each other.  attn b0:
2e-5.  The untouched buffers: exact.  attn's
drop-connect draws cannot match across the two generators, so attn b0 is
held against the JAX package with drop-connect off (its BatchNorms have
momenta 0.01 and 0.1), and with drop-connect on against the mean of the
batch statistics that forward hooks capture in the same port run.
"""

import os

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.models.build import build_segmentor as jax_build
from rnd_semantic_segmentation_tpu.models.efficientnet import EfficientNetEncoder as JaxEncoder
from rnd_semantic_segmentation_tpu.train.bn_recal import (
    recalibrate_batch_stats as jax_recalibrate,
)
from rnd_semantic_segmentation_tpu.train.segmentor import Segmentor as JaxSegmentor

from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    attn_flax_from_state_dicts,
    attn_state_dicts_from_flax,
    deeplab_flax_from_state_dicts,
    deeplab_state_dicts_from_flax,
    pranet_flax_from_state_dicts,
    pranet_state_dicts_from_flax,
)
from rnd_semantic_segmentation_torch.cli import train_adv, train_src
from rnd_semantic_segmentation_torch.cli.common import load_cfg
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.models.efficientnet import EfficientNetEncoder
from rnd_semantic_segmentation_torch.models.layers import FrozenBatchNorm2d
from rnd_semantic_segmentation_torch.train import trainer as trainer_module
from rnd_semantic_segmentation_torch.train.bn_recal import recalibrate_batch_stats
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor

torch.set_num_threads(2)  # six test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC = 3
TOL = 2e-5
PRANET_TOL = {"port_float64": 5e-4, "jax_float64": 2e-3, "jax": 2e-3}
BRIDGES = {"deeplab": (deeplab_flax_from_state_dicts, deeplab_state_dicts_from_flax),
           "attn": (attn_flax_from_state_dicts, attn_state_dicts_from_flax),
           "pranet": (pranet_flax_from_state_dicts, pranet_state_dicts_from_flax)}


def _opts(name, *more):
    return ["MODEL.NAME", name, "MODEL.NUM_CLASSES", str(NC), *more]


def _port(name, *opts, drop_connect=True):
    cfg = get_default_cfg()
    cfg.merge_from_list(_opts(name, "MODEL.DEVICE", "cpu", *opts))
    spec = build_segmentor(cfg)
    if spec.family == "attn" and not drop_connect:
        spec.modules["encoder"] = EfficientNetEncoder(spec.backbone, drop_connect_rate=0.0)
    return randomize_weights_(Segmentor(spec, NC), seed=10)


def _batches(side, n=3, b=2, seed=4):
    rng = np.random.RandomState(seed)
    return [(rng.rand(b, side, side, 3) * 2 - 0.5).astype(np.float32) for _ in range(n)]


def _state_dicts(seg):
    return {n: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for n, m in seg.spec.modules.items()}


def _jax_recalibrated(seg, name, opts, batches):
    """The JAX function's running statistics from ``seg``'s weights, under
    the torch keys."""
    cfg = jax_default_cfg()
    cfg.merge_from_list(_opts(name, *opts))
    spec = jax_build(cfg)
    if spec.family == "attn":
        spec.modules["encoder"] = JaxEncoder(spec.backbone, drop_connect_rate=0.0)
    jseg = JaxSegmentor(spec, NC)
    side = batches[0].shape[1]
    template = jax.eval_shape(jseg.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, side, side, 3), jnp.float32))
    to_flax, from_flax = BRIDGES[spec.family]
    tree = to_flax(_state_dicts(seg), template)
    params = {n: t["params"] for n, t in tree.items()}
    stats = {n: {c: v for c, v in t.items() if c != "params"} for n, t in tree.items()}
    new = jax_recalibrate(jseg, params, stats, [jnp.asarray(b) for b in batches],
                          rng=jax.random.PRNGKey(2))
    return _running(from_flax({n: {"params": params[n], **new[n]} for n in tree}))


def _running(state_dicts):
    return {part: {k: v.detach().double().numpy() for k, v in sd.items()
                   if k.endswith(("running_mean", "running_var"))}
            for part, sd in state_dicts.items()}


def _stats(seg):
    return _running(_state_dicts(seg))


def _assert_stats_close(got, ref, tol=TOL):
    checked = 0
    for part, stats in got.items():
        for key, value in stats.items():
            want = np.asarray(ref[part][key], np.float64)
            err = np.abs(value - want).max()
            assert err <= tol * max(np.abs(want).max(), 1e-3), (part, key, err)
            checked += 1
    assert checked > 0


def _torch_batches(batches):
    return [torch.from_numpy(b) for b in batches]


@pytest.mark.parametrize("name,opts,side", [
    ("deeplab_resnet18", ("MODEL.FREEZE_BN", "False"), 32),
    ("pranet_res2net50", (), 64),
], ids=["deeplab_resnet18", "pranet_res2net50"])
def test_recalibrated_statistics_match_the_jax_function(name, opts, side):
    seg = _port(name, *opts)
    batches = _batches(side)
    ref = _jax_recalibrated(seg, name, opts, batches)
    before = _state_dicts(seg)
    seg.eval()
    n = recalibrate_batch_stats(seg, _torch_batches(batches),
                                generator=torch.Generator(), seed=2)
    assert n == 3 and not seg.training
    if name == "deeplab_resnet18":
        _assert_stats_close(_stats(seg), ref)
    else:
        seg64 = _port(name, *opts).double()
        recalibrate_batch_stats(seg64, [b.double() for b in _torch_batches(batches)])
        exact = _stats(seg64)
        _assert_stats_close(_stats(seg), exact, PRANET_TOL["port_float64"])
        _assert_stats_close(ref, exact, PRANET_TOL["jax_float64"])
        _assert_stats_close(_stats(seg), ref, PRANET_TOL["jax"])
    moved = 0
    for part, module in seg.spec.modules.items():
        for key, value in module.state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                moved += not torch.equal(value, before[part][key])
            else:  # weights and the counters stay
                assert torch.equal(value, before[part][key]), key
    assert moved > 0
    for m in seg.modules():
        if isinstance(m, nn.BatchNorm2d):
            assert m.momentum == 0.1


def test_attn_b0_mixed_momenta_match_the_jax_function_without_drop_connect():
    seg = _port("attn_efficientnet-b0", drop_connect=False)
    batches = _batches(64)
    ref = _jax_recalibrated(seg, "attn_efficientnet-b0", (), batches)
    momenta = {n: m.momentum for n, m in seg.named_modules() if isinstance(m, nn.BatchNorm2d)}
    assert set(momenta.values()) == {0.01, 0.1}
    recalibrate_batch_stats(seg, _torch_batches(batches))
    _assert_stats_close(_stats(seg), ref)
    assert momenta == {n: m.momentum for n, m in seg.named_modules()
                       if isinstance(m, nn.BatchNorm2d)}


def test_attn_b0_with_drop_connect_averages_the_statistics_of_its_batches():
    """Hooks take each BatchNorm input's batch mean and unbiased variance in
    the recalibration's own forwards; the running statistics must be their
    average over the batches."""
    seg = _port("attn_efficientnet-b0")
    seen = {}

    def hook(module, args, _out):
        x = args[0].detach().double()
        seen.setdefault(module, []).append((x.mean(dim=(0, 2, 3)),
                                            x.var(dim=(0, 2, 3), unbiased=True)))

    norms = [m for m in seg.modules() if isinstance(m, nn.BatchNorm2d)]
    handles = [m.register_forward_hook(hook) for m in norms]
    try:
        recalibrate_batch_stats(seg, [{"image": b} for b in _torch_batches(_batches(64))],
                                generator=torch.Generator(), seed=2)
    finally:
        for h in handles:
            h.remove()
    assert len(seen) == len(norms)
    for m in norms:
        mean = torch.stack([s[0] for s in seen[m]]).mean(0)
        var = torch.stack([s[1] for s in seen[m]]).mean(0)
        for got, want in ((m.running_mean, mean), (m.running_var, var)):
            err = (got.double() - want).abs().max().item()
            assert err <= TOL * max(want.abs().max().item(), 1e-3), err


def test_frozen_and_unreached_buffers_are_untouched():
    """FREEZE_BN True: the ResNet's FrozenBatchNorm2d buffers stay bit-equal;
    a BatchNorm that no forward reaches keeps its statistics and counter."""
    seg = _port("deeplab_resnet18", "MODEL.FREEZE_BN", "True")
    assert any(isinstance(m, FrozenBatchNorm2d) for m in seg.modules())
    unused = nn.BatchNorm2d(4)
    unused.running_mean.fill_(0.25)
    unused.running_var.fill_(3.0)
    unused.num_batches_tracked.fill_(7)
    seg.parts["classifier"].unused = unused
    before = {k: v.clone() for k, v in seg.state_dict().items()}
    recalibrate_batch_stats(seg, _torch_batches(_batches(32)))
    for key, value in seg.state_dict().items():
        assert torch.equal(value, before[key]), key
    assert recalibrate_batch_stats(seg, []) == 0


# -- the trainers' hook ----------------------------------------------------------------

def _cli_opts(out_dir, *more):
    return ["-cfg", os.path.join(REPO, "configs", "deeplabv2_r101_src.yaml"),
            "MODEL.DEVICE", "cpu", "MODEL.NAME", "deeplab_resnet18", "MODEL.FREEZE_BN",
            "False", "MODEL.NUM_CLASSES", str(NC), "DATASETS.SOURCE_TRAIN", "synthetic_train",
            "DATASETS.SYNTHETIC_LENGTH", "6", "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(32, 32)",
            "SOLVER.BATCH_SIZE", "2", "SOLVER.EPOCHS", "2", "SOLVER.CHECKPOINT_PERIOD", "1",
            "DATA_PIPE.NUM_WORKERS", "1", "OUTPUT_DIR", str(out_dir), *more]


def test_the_source_trainer_recalibrates_and_saves_again(tmp_path, monkeypatch):
    """``cli.train_src`` with BN_RECAL_BATCHES 2: after the last epoch the
    statistics are recalibrated over two train-loader batches and
    ``Aspp-2.pth`` is written again with them and with the optimizers."""
    calls = []
    real = trainer_module.recalibrate_batch_stats

    def spy(segmentor, batches, **kw):
        calls.append(({k: v.clone() for k, v in segmentor.state_dict().items()},
                      [b.clone() for b in batches], kw))
        return real(segmentor, batches, **kw)

    monkeypatch.setattr(trainer_module, "recalibrate_batch_stats", spy)
    cfg = load_cfg(train_src.build_parser().parse_args(
        _cli_opts(tmp_path, "SOLVER.BN_RECAL_BATCHES", "2")))
    trainer = train_src.make_trainer("deeplab", cfg)
    trainer.train()
    assert len(calls) == 1 and trainer.state.step == 6
    before, batches, kw = calls[0]
    assert len(batches) == 2 and batches[0].shape == (2, 32, 32, 3) and kw["seed"] == cfg.SEED + 2
    ckpt = torch.load(tmp_path / "Aspp-2.pth", map_location="cpu", weights_only=True)
    assert (ckpt["epoch"], ckpt["step"]) == (2, 6)
    assert "momentum_buffer" in ckpt["optimizer_feature_extractor"]["state"][0]
    # the same recalibration from the state before it, on the same batches
    ref = _port("deeplab_resnet18", "MODEL.FREEZE_BN", "False")
    ref.load_state_dict(before)
    real(ref, batches)
    moved = 0
    for part in ("feature_extractor", "classifier"):
        for key, value in ckpt[part].items():
            want = ref.parts[part].state_dict()[key]
            torch.testing.assert_close(value, want, rtol=0, atol=0, msg=key)
            if key.endswith("running_var"):
                moved += not torch.equal(value, before[f"parts.{part}.{key}"])
            elif not key.endswith(("running_mean", "running_var")):
                assert torch.equal(value, before[f"parts.{part}.{key}"]), key
    assert moved > 0
    assert sorted(p.name for p in tmp_path.glob("*.pth")) == ["Aspp-1.pth", "Aspp-2.pth"]


def test_the_fada_trainer_never_recalibrates(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(trainer_module, "recalibrate_batch_stats",
                        lambda *a, **kw: calls.append(a))
    opts = _cli_opts(tmp_path, "SOLVER.BN_RECAL_BATCHES", "2", "DATASETS.TARGET_TRAIN",
                     "synthetic_shift_train", "INPUT.TARGET_INPUT_SIZE_TRAIN", "(32, 32)",
                     "SOLVER.BATCH_SIZE", "4", "SOLVER.EPOCHS", "1")
    opts[1] = os.path.join(REPO, "configs", "deeplabv2_r101_adv.yaml")
    fada = train_adv.make_trainer("deeplab_fada", load_cfg(
        train_adv.build_parser().parse_args(opts)))
    fada.train()
    assert fada.state.step == 3 and calls == []
    assert [p.name for p in tmp_path.glob("*.pth")] == ["AsppFada-1.pth"]
