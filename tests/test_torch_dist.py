"""The port's data parallelism on the CPU: ``CrossRankBatchNorm2d`` and the
global-batch losses in a gloo world of two processes against the JAX
package on the whole batch, the loader's two ways to split the data against
the JAX ``DataLoader``, and the DIST knobs.

One world of two runs every case of ``torch_dist_worker.case_units`` (a
module-scoped fixture, with its own timeout); each rank takes half of each
batch, made from a seed with numpy, and the test compares in this process.

Tolerances:
  * BatchNorm in float32: output, input gradient and the weight and bias
    gradients (summed over the ranks) within 1e-5 of their magnitude, the
    running statistics 1e-6 (the same sums in another order);
  * BatchNorm in bfloat16: the output and the input gradient within 2e-2 of
    their magnitude (a few bfloat16 ulps: both compute in float32 and round
    once, but the rounding of x and of the output amplifies a 1-ulp gap),
    the weight and bias gradients and the statistics 1e-3 (float32
    reductions of the same bfloat16 values);
  * losses: the ranks' mean of the values and the gradients (each rank's,
    over the world size) within 1e-6 of their magnitude of the JAX loss on
    the whole batch.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnd_semantic_segmentation_tpu import losses as jax_losses
from rnd_semantic_segmentation_tpu.data.loader import DataLoader as JaxLoader
from rnd_semantic_segmentation_tpu.models.layers import BatchNorm as JaxBatchNorm

from rnd_semantic_segmentation_torch import losses
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.data.loader import DataLoader
from rnd_semantic_segmentation_torch.models.build import build_segmentor
from rnd_semantic_segmentation_torch.models.layers import FrozenBatchNorm2d
from rnd_semantic_segmentation_torch.parallel import (
    CrossRankBatchNorm2d,
    check_world,
    convert_batchnorm,
    initialize_distributed,
    world_size,
)

import torch_dist_worker as W

torch.set_num_threads(2)  # six test workers share the host's cores

WORLD = 2


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    ranks, _ = W.run_world("units", str(tmp_path_factory.mktemp("units")), world=WORLD,
                           timeout=240)
    return ranks


def _rel(have, want):
    have, want = np.asarray(have, np.float64), np.asarray(want, np.float64)
    assert have.shape == want.shape and np.isfinite(have).all()
    return np.abs(have - want).max() / max(np.abs(want).max(), 1e-30)


def _jax_batchnorm(dtype):
    inp = W.bn_inputs()
    variables = {"params": {"scale": jnp.asarray(inp["weight"]),
                            "bias": jnp.asarray(inp["bias"])},
                 "batch_stats": {"mean": jnp.asarray(inp["mean"]),
                                 "var": jnp.asarray(inp["var"])}}
    x = jnp.asarray(inp["x"].transpose(0, 2, 3, 1)).astype(dtype)
    g = jnp.asarray(inp["g"].transpose(0, 2, 3, 1))
    bn = JaxBatchNorm()

    def loss(params, x):
        y, upd = bn.apply({**variables, "params": params}, x, train=True,
                          mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * g), (y, upd["batch_stats"])

    (_, (y, stats)), (dparams, dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], x)
    nchw = lambda a: np.asarray(a.astype(jnp.float32)).transpose(0, 3, 1, 2)  # noqa: E731
    return {"y": nchw(y), "dx": nchw(dx), "dweight": np.asarray(dparams["scale"]),
            "dbias": np.asarray(dparams["bias"]), "running_mean": np.asarray(stats["mean"]),
            "running_var": np.asarray(stats["var"]), "dtype": str(y.dtype)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_across_two_ranks_equals_the_jax_batchnorm_on_the_whole_batch(units, dtype):
    ref = _jax_batchnorm(jnp.float32 if dtype == "float32" else jnp.bfloat16)
    got = {k: np.concatenate([r[f"bn/{dtype}/{k}"] for r in units]) for k in ("y", "dx")}
    got.update({k: sum(r[f"bn/{dtype}/{k}"] for r in units) for k in ("dweight", "dbias")})
    assert all(str(r[f"bn/{dtype}/out_dtype"]) == f"torch.{dtype}" for r in units)
    assert ref["dtype"] == dtype
    tol = {"float32": (1e-5, 1e-5, 1e-6), "bfloat16": (2e-2, 1e-3, 1e-3)}[dtype]
    for key in ("y", "dx"):
        assert _rel(got[key], ref[key]) <= tol[0], key
    for key in ("dweight", "dbias"):
        assert _rel(got[key], ref[key]) <= tol[1], key
    for key in ("running_mean", "running_var"):
        # every rank holds the statistics of the whole batch
        for r in units:
            assert _rel(r[f"bn/{dtype}/{key}"], ref[key]) <= tol[2], key
    np.testing.assert_array_equal(units[0][f"bn/{dtype}/running_var"],
                                  units[1][f"bn/{dtype}/running_var"])


def test_batchnorm_in_a_world_of_one_is_nn_batchnorm():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 6, 5, 7, generator=gen)
    ref, bn = torch.nn.BatchNorm2d(6), CrossRankBatchNorm2d(6)
    bn.load_state_dict(ref.state_dict())
    assert list(bn.state_dict()) == list(ref.state_dict())
    for train in (True, False):
        ref.train(train), bn.train(train)
        torch.testing.assert_close(bn(x), ref(x), rtol=0, atol=0)
    for key, value in ref.state_dict().items():
        torch.testing.assert_close(bn.state_dict()[key], value, rtol=0, atol=0)


def test_convert_batchnorm_swaps_the_class_and_keeps_state_and_frozen_norms():
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", "deeplab_resnet18", "MODEL.FREEZE_BN", "True",
                         "MODEL.DEVICE", "cpu"])
    spec = build_segmentor(cfg)
    before = {n: {k: v.clone() for k, v in m.state_dict().items()}
              for n, m in spec.modules.items()}
    params = [id(p) for m in spec.modules.values() for p in m.parameters()]
    for module in spec.modules.values():
        assert convert_batchnorm(module) is module
    norms = [m for m in spec.modules["feature_extractor"].modules()
             if isinstance(m, (torch.nn.BatchNorm2d, FrozenBatchNorm2d))]
    assert norms and all(type(m) is FrozenBatchNorm2d for m in norms)
    cfg.merge_from_list(["MODEL.FREEZE_BN", "False"])
    bn_spec = build_segmentor(cfg)
    convert_batchnorm(bn_spec.modules["feature_extractor"])
    norms = [m for m in bn_spec.modules["feature_extractor"].modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(norms) == 20 and all(type(m) is CrossRankBatchNorm2d for m in norms)
    assert params == [id(p) for m in spec.modules.values() for p in m.parameters()]
    for n, m in spec.modules.items():
        assert list(m.state_dict()) == list(before[n])


LOSSES = ("ce", "tversky", "bce", "soft_ce", "structure")


def _jax_loss(name, inp):
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    fns = {
        "ce": (lambda z: jax_losses.cross_entropy(z, jnp.asarray(inp["label"]), 255),
               "logits"),
        "tversky": (lambda z: jax_losses.tversky_loss(z, nhwc(inp["soft"])), "logits"),
        "bce": (lambda z: jax_losses.bce_with_logits(z, nhwc(inp["soft"])), "logits"),
        "soft_ce": (lambda z: jax_losses.soft_label_cross_entropy(z, nhwc(inp["soft"])),
                    "logits"),
        "structure": (lambda z: jax_losses.structure_loss(z, nhwc(inp["mask"])), "pred1"),
    }
    fn, key = fns[name]
    value, grad = jax.value_and_grad(fn)(nhwc(inp[key]))
    return float(value), np.asarray(grad).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("name", LOSSES)
def test_losses_over_two_ranks_equal_the_jax_losses_on_the_whole_batch(units, name):
    """CE divides by the group's count of valid pixels (rank 0's half is
    mostly ignored) and Tversky sums over the group; BCE, the soft-label CE
    and the structure loss are means over equal shards and need only the
    ranks' plain mean.  The ranks' mean of the values is the global loss;
    the ranks' gradients, divided by the world size (the mean that the
    gradient all-reduce takes), are its gradient."""
    value, grad = _jax_loss(name, W.loss_inputs())
    values = [float(r[f"loss/{name}/value"]) for r in units]
    assert abs(np.mean(values) - value) <= 1e-6 * abs(value), (name, values, value)
    got = np.concatenate([r[f"loss/{name}/grad"] for r in units]) / WORLD
    gap = _rel(got, grad)
    assert gap <= 1e-6, (name, gap)
    if name == "ce":  # uneven shards: the mean of the ranks' own means is another loss
        inp = W.loss_inputs()
        own = [float(losses.cross_entropy(torch.from_numpy(p["logits"]),
                                          torch.from_numpy(p["label"])))
               for p in (W.rows(inp, r, WORLD) for r in range(WORLD))]
        assert abs(np.mean(own) - value) > 1e-2 * value


@pytest.mark.parametrize("name", ["ce", "tversky"])
def test_across_ranks_changes_nothing_in_a_world_of_one(name):
    inp = W.loss_inputs()
    z = torch.from_numpy(inp["logits"])
    if name == "ce":
        fn = lambda **kw: losses.cross_entropy(z, torch.from_numpy(inp["label"]), **kw)  # noqa
    else:
        fn = lambda **kw: losses.tversky_loss(z, torch.from_numpy(inp["soft"]), **kw)  # noqa
    assert world_size() == 1
    torch.testing.assert_close(fn(across_ranks=True), fn(), rtol=0, atol=0)


class _Items:
    def __init__(self, n):
        self.image_paths = [f"item_{i}" for i in range(n)]

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, i):
        return (np.full((2, 2, 3), i, np.uint8), np.full((2, 2), i % 3, np.float32),
                self.image_paths[i])


@pytest.mark.parametrize("n,world,batch,shuffle", [(11, 2, 2, False), (10, 3, 2, True),
                                                   (9, 2, 4, False)])
def test_process_shard_takes_the_jax_loaders_rows(n, world, batch, shuffle):
    """Each process's batches, and the items no process takes, are the JAX
    ``DataLoader(process_shard=True)``'s, in process."""
    taken, left = [], set()
    for index in range(world):
        kw = dict(batch_size=batch, shuffle=shuffle, drop_last=False, num_workers=1, seed=3,
                  process_shard=True, process_index=index, process_count=world)
        port, ref = DataLoader(_Items(n), **kw), JaxLoader(_Items(n), **kw)
        port.set_epoch(2), ref.set_epoch(2)
        assert len(port) == len(ref)
        left.add(tuple(port.left_out()))  # the epoch's order, before it is walked
        got, want = list(port), list(ref)
        assert [b["name"] for b in got] == [b["name"] for b in want]
        taken += [name for b in got for name in b["name"]]
    assert len(taken) == len(set(taken)) == (n // world) * world
    (left,) = left  # every process names the same items
    assert len(left) == n % world
    assert sorted(taken + [f"item_{i}" for i in left]) == sorted(_Items(n).image_paths)


@pytest.mark.parametrize("workers", [0, 2])
def test_global_batch_slices_reassemble_the_one_process_batches(workers):
    """Every rank walks the same shuffled global batches and loads its
    contiguous rows: the ranks' slices, stacked, are the one-process batch,
    with threads and with worker processes."""
    kw = dict(batch_size=4, shuffle=True, drop_last=True, num_workers=2, seed=5)
    whole = DataLoader(_Items(10), **kw)
    whole.set_epoch(1)
    want = list(whole)
    slices = []
    for r in range(WORLD):
        loader = DataLoader(_Items(10), worker_processes=workers, **kw)
        assert loader.global_batch_slice(r, WORLD) is loader
        loader.set_epoch(1)
        slices.append(list(loader))
        assert len(loader) == len(whole) == 2
        loader.close()
    for i, batch in enumerate(want):
        for key in ("image", "label"):
            np.testing.assert_array_equal(
                np.concatenate([s[i][key] for s in slices]), batch[key])
        assert sum((s[i]["name"] for s in slices), []) == batch["name"]
    with pytest.raises(ValueError):
        DataLoader(_Items(10), batch_size=3).global_batch_slice(0, 2)
    with pytest.raises(ValueError):
        DataLoader(_Items(10), batch_size=4, drop_last=False).global_batch_slice(0, 2)


def _cfg(*opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.DEVICE", "cpu", *opts])
    return cfg


def test_dist_knobs_against_a_world_of_one():
    check_world(_cfg("DIST.NUM_DEVICES", "1"))
    check_world(_cfg("DIST.NUM_DEVICES", "0", "DIST.INITIALIZE", "True"))
    with pytest.raises(ValueError, match="NUM_DEVICES"):
        check_world(_cfg("DIST.NUM_DEVICES", "4"))
    with pytest.raises(NotImplementedError, match="SPATIAL_PARALLEL"):
        check_world(_cfg("DIST.SPATIAL_PARALLEL", "2"))


def test_initialize_distributed_starts_a_gloo_world_of_one_from_torchrun_variables(
        monkeypatch):
    """The ``env://`` variables that ``torchrun`` sets; gloo for the CPU.
    The group is ended before the test returns."""
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                       ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(W.free_port()))):
        monkeypatch.setenv(key, value)
    cfg = _cfg("DIST.INITIALIZE", "True", "DIST.NUM_DEVICES", "1")
    try:
        initialize_distributed(cfg)
        assert torch.distributed.is_initialized()
        assert torch.distributed.get_backend() == "gloo" and world_size() == 1
        initialize_distributed(cfg)  # a second call leaves the group as it is
    finally:
        torch.distributed.destroy_process_group()
    initialize_distributed(_cfg())  # without DIST.INITIALIZE nothing starts
    assert not torch.distributed.is_initialized()
