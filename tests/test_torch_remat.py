"""MODEL.REMAT_BLOCKS and SOLVER.REMAT in the port (models/remat.py), on the
CPU, held to the same step without rematerialisation, as tests/test_remat.py
holds the JAX package.

On the CPU the recompute runs the same kernels on the same inputs, so
everything is held bit-equal: the loss, every gradient, every parameter after
the optimizer step, and every BatchNorm ``running_mean``, ``running_var`` and
``num_batches_tracked`` (the recompute's own updates must not land, and
drop-connect's masks must be drawn once).  Shapes are small: ResNet18 and
Res2Net50 at 64x64, GALD at 224x224, EfficientNet-B0 at 64x64.
"""

import numpy as np
import pytest
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.models.build import (
    build_adversarial_discriminator,
    build_segmentor,
    randomize_weights_,
)
from rnd_semantic_segmentation_torch.models.efficientnet import MBConvBlock
from rnd_semantic_segmentation_torch.models.remat import (
    RematBlock,
    checkpoint_call,
    remat_wrap,
    set_remat_blocks,
)
from rnd_semantic_segmentation_torch.train.distill import make_online_distill_step
from rnd_semantic_segmentation_torch.train.fada import DISC_PART, make_disc_optimizer, \
    make_fada_train_step
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor
from rnd_semantic_segmentation_torch.train.state import TrainState, make_optimizers
from rnd_semantic_segmentation_torch.train.steps import check_step_knobs, make_src_train_step

torch.set_num_threads(2)  # six test workers share the host's cores

NC = 3
STEPS_PER_EPOCH = 10
# family -> (MODEL.NAME, side, the RematBlock type count it must hold)
FAMILIES = {
    "deeplab": ("deeplab_resnet18", 64, 8),
    "pranet": ("pranet_res2net50", 64, 16),
    "gald": ("gald_hardnet68", 224, 5),
    "attn": ("attn_efficientnet-b0", 64, 16),
}


def _cfg(name, *opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", name, "MODEL.NUM_CLASSES", str(NC), "MODEL.DEVICE",
                         "cpu", "MODEL.DTYPE", "float32", "SOLVER.EPOCHS", "2",
                         "SOLVER.BASE_LR", "1e-3", *opts])
    return cfg


def _segmentor(cfg, seed=3):
    spec = build_segmentor(cfg)
    seg = Segmentor(spec, cfg.MODEL.NUM_CLASSES)
    randomize_weights_(seg, seed=seed)
    return seg, (1 if spec.family == "pranet" else NC)  # pranet: a 0/1 mask


def _batch(side, nc, n=2, seed=0):
    rng = np.random.RandomState(seed)
    return {"image": torch.from_numpy(rng.rand(n, side, side, 3).astype(np.float32)),
            "label": torch.from_numpy(rng.randint(0, max(nc, 2), (n, side, side))
                                      .astype(np.int32))}


def _norm_buffers(seg):
    return {f"{n}.{b}": getattr(m, b).clone() for n, m in seg.named_modules()
            if isinstance(m, nn.BatchNorm2d)
            for b in ("running_mean", "running_var", "num_batches_tracked")}


def _snapshot(seg, losses):
    return {"losses": losses,
            "grads": {n: p.grad.clone() for n, p in seg.named_parameters()
                      if p.grad is not None},
            "params": {n: p.detach().clone() for n, p in seg.named_parameters()},
            "buffers": _norm_buffers(seg)}


def _assert_bit_equal(a, b):
    assert a["losses"] == b["losses"]
    for key in ("grads", "params", "buffers"):
        assert a[key].keys() == b[key].keys() and a[key], key
        for name, t in a[key].items():
            assert torch.equal(t, b[key][name]), (key, name)


def _src_run(name, side, *opts, steps=2):
    cfg = _cfg(name, *opts)
    seg, nc = _segmentor(cfg)
    state = TrainState(optimizers=make_optimizers(seg.spec, cfg))
    step = make_src_train_step(seg, cfg, STEPS_PER_EPOCH, state)
    losses = [step(_batch(side, nc, n=4 if "SOLVER.ACCUM_STEPS" in opts else 2, seed=i), 0.0)
              ["loss"] for i in range(steps)]
    return seg, _snapshot(seg, losses)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_blocks_is_bit_equal_after_two_steps(family):
    """Two source steps with MODEL.REMAT_BLOCKS off and on: the same bits
    everywhere.  attn keeps its drop-connect (rate 0.2 over the blocks): the
    masks are drawn once, before the rematerialised body."""
    name, side, n_blocks = FAMILIES[family]
    seg_off, off = _src_run(name, side)
    seg_on, on = _src_run(name, side, "MODEL.REMAT_BLOCKS", "True")
    blocks = [m for m in seg_on.modules() if isinstance(m, RematBlock)]
    assert len(blocks) == n_blocks and all(b.remat for b in blocks)
    assert not any(m.remat for m in seg_off.modules() if isinstance(m, RematBlock))
    if family == "attn":
        assert sum(isinstance(b, MBConvBlock) and b.drop_connect_rate > 0
                   and b.in_filters == b.out_filters and b.stride == 1 for b in blocks) > 5
    _assert_bit_equal(off, on)
    tracked = [t for k, t in on["buffers"].items() if k.endswith("num_batches_tracked")]
    assert tracked and all(int(t) == 2 for t in tracked)


def test_remat_blocks_keeps_the_state_dict_and_loads_across_the_knob(tmp_path):
    """The keys are the same with the knob on and off, and a checkpoint saved
    with it on loads with it off (and gives the same forward)."""
    for name, side, _ in FAMILIES.values():
        keys = [{f"{part}.{k}" for part, m in build_segmentor(
                    _cfg(name, "MODEL.REMAT_BLOCKS", on)).modules.items()
                 for k in m.state_dict()} for on in ("True", "False")]
        assert keys[0] == keys[1], name
    seg_on, _ = _src_run("deeplab_resnet18", 64, "MODEL.REMAT_BLOCKS", "True", steps=1)
    path = str(tmp_path / "on.pth")
    torch.save({n: m.state_dict() for n, m in seg_on.spec.modules.items()}, path)
    seg_off, _ = _segmentor(_cfg("deeplab_resnet18"), seed=11)
    for n, sd in torch.load(path, weights_only=True).items():
        seg_off.spec.modules[n].load_state_dict(sd, strict=True)
    x = _batch(64, NC)["image"].permute(0, 3, 1, 2)
    with torch.no_grad():
        assert torch.equal(seg_off(x)[0][0], seg_on(x)[0][0])


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_solver_remat_source_step_with_accum_is_bit_equal(mode):
    """SOLVER.REMAT around each of two micro-batches (SOLVER.ACCUM_STEPS 2) of
    the attn step with drop-connect on: the recompute of a micro-batch draws
    the masks that its first run drew."""
    name, side, _ = FAMILIES["attn"]
    _, none = _src_run(name, side, "SOLVER.ACCUM_STEPS", "2")
    _, rem = _src_run(name, side, "SOLVER.ACCUM_STEPS", "2", "SOLVER.REMAT", mode)
    _assert_bit_equal(none, rem)


def _fada_run(*opts):
    cfg = _cfg("deeplab_resnet18", "SOLVER.BASE_LR_D", "1e-4", *opts)
    seg, _ = _segmentor(cfg)
    disc = randomize_weights_(build_adversarial_discriminator(cfg, seg.spec), seed=4)
    state = TrainState(optimizers={**make_optimizers(seg.spec, cfg),
                                   DISC_PART: make_disc_optimizer(disc)})
    step = make_fada_train_step(seg, disc, cfg, STEPS_PER_EPOCH, state)
    metrics = [step(_batch(48, NC, seed=i), _batch(32, NC, seed=10 + i), 0.0)
               for i in range(2)]
    snap = _snapshot(seg, metrics)
    snap["params"].update({f"D.{n}": p.detach().clone() for n, p in disc.named_parameters()})
    return snap


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_solver_remat_fada_step_is_bit_equal(mode):
    """Two FADA steps of deeplab_resnet18 (BatchNorm, both domains chained):
    the four losses, the segmentor's gradients, every parameter of the
    segmentor and of D, and the running statistics."""
    _assert_bit_equal(_fada_run(), _fada_run("SOLVER.REMAT", mode))


def _online_run(*opts):
    name, side, _ = FAMILIES["attn"]
    cfg = _cfg(name, *opts)
    seg, _ = _segmentor(cfg)
    teacher, _ = _segmentor(cfg, seed=5)
    state = TrainState(optimizers=make_optimizers(seg.spec, cfg))
    step = make_online_distill_step(seg, cfg, STEPS_PER_EPOCH, state, teacher)
    losses = [step(_batch(side, NC, seed=i), 0.0)["loss"] for i in range(2)]
    return _snapshot(seg, losses)


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_solver_remat_online_step_is_bit_equal(mode):
    """Two online distillation steps of attn_efficientnet-b0 with
    drop-connect on and its teacher outside the rematerialised loss."""
    _assert_bit_equal(_online_run(), _online_run("SOLVER.REMAT", mode))


def test_solver_remat_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="none|full|dots"):
        check_step_knobs(_cfg("deeplab_resnet18", "SOLVER.REMAT", "everything"))
    for off in ("none", "None", "", "false", "0"):
        check_step_knobs(_cfg("deeplab_resnet18", "SOLVER.REMAT", off))


class _OpCount(TorchDispatchMode):
    """Counts the ATen ops that reach it."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


class _Net(nn.Module):
    """A convolution, a BatchNorm, and two linear layers whose outputs the
    backward reads (a product of the two); the addmm outputs are what
    ``dots`` keeps."""

    def __init__(self):
        super().__init__()
        self.conv, self.bn = nn.Conv2d(3, 8, 3, padding=1), nn.BatchNorm2d(8)
        self.fc1, self.fc2 = nn.Linear(8, 6), nn.Linear(8, 6)

    def forward(self, x):
        h = torch.relu(self.bn(self.conv(x))).mean(dim=(2, 3))
        return (self.fc1(h) * self.fc2(h)).sum()


@pytest.mark.parametrize("mode", ["none", "full", "dots"])
def test_dots_keeps_the_products_and_recomputes_the_convolutions(mode):
    """The forward ops that run again in the backward: ``full`` reruns the
    convolution and both addmm; ``dots`` reruns the convolution and neither
    addmm, whose outputs it kept; ``none`` reruns nothing.  The gradients
    and the BatchNorm counter are those of ``none``."""
    torch.manual_seed(0)
    net = _Net().train()
    x = torch.randn(2, 3, 6, 6)
    cfg = _cfg("deeplab_resnet18", "SOLVER.REMAT", mode)
    loss = remat_wrap(net, cfg, (net,))(x)
    with _OpCount() as count:
        loss.backward()
    conv = count.counts.get(torch.ops.aten.convolution.default, 0)
    addmm = count.counts.get(torch.ops.aten.addmm.default, 0)
    assert (conv, addmm) == {"none": (0, 0), "full": (1, 2), "dots": (1, 0)}[mode]
    assert int(net.bn.num_batches_tracked) == 1
    torch.manual_seed(0)
    ref = _Net().train()
    ref(x).backward()
    for (n, p), q in zip(net.named_parameters(), ref.parameters()):
        assert torch.equal(p.grad, q.grad), n


def test_checkpoint_call_restores_an_explicit_generator_for_the_recompute():
    """A function that draws from an explicit generator: its recompute draws
    what its first run drew, and the generator ends where the first run
    left it."""
    gen = torch.Generator().manual_seed(7)
    w = torch.randn(4, requires_grad=True)

    def fn(x):
        return (x * w * torch.rand(4, generator=gen)).sum()

    state = gen.get_state()
    loss = checkpoint_call(fn, torch.ones(4), generator=gen)
    after = gen.get_state()
    loss.backward()
    assert torch.equal(gen.get_state(), after)
    gen.set_state(state)
    assert torch.equal(w.grad, torch.rand(4, generator=gen))


def test_set_remat_blocks_toggles_only_remat_blocks():
    seg, _ = _segmentor(_cfg("attn_efficientnet-b0"))
    set_remat_blocks(seg, True)
    blocks = [m for m in seg.modules() if isinstance(m, RematBlock)]
    assert len(blocks) == 16 and all(b.remat for b in blocks)
    set_remat_blocks(seg, False)
    assert not any(b.remat for b in blocks)
