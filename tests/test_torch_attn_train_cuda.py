"""The attn training slice on the card: one train step of a seeded
``attn_efficientnet-b0`` at 64x64 on the card against the same step on the
CPU (drop-connect off), training that never launches the fused MBConv
kernel, and the trained model's fused eval against its plain version on the
card.  Each skips without a card.

This file imports nothing of the JAX package, so that it collects on a
machine that has the card and not the JAX package's dependencies; the CPU
parity of the same paths is in tests/test_torch_attn_train.py.

Tolerances: the losses within 1e-5 relative; after one Adam step every
element moved by at most lr on both devices, and where the CPU's gradient
(with the weight decay) exceeds 1e-5 and both devices moved the element the
same way (most elements; a gradient that is rounding noise takes either
sign), within 2e-3 of lr, since one Adam step moves an element by
lr*g/(|g|+eps) whatever the size of g; the BN running statistics within 1e-4
of their magnitude; the fused eval against the unfused one and against the
fused path with the plain core, 1e-4 of the output's magnitude (the kernel's
product is 3xTF32, the tolerance chip_smoke.py holds the kernel to).
"""

import copy

import numpy as np
import pytest
import torch

from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.models import efficientnet
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.models.efficientnet import EfficientNetEncoder
from rnd_semantic_segmentation_torch.ops import mbconv
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor
from rnd_semantic_segmentation_torch.train.state import TrainState, make_optimizers
from rnd_semantic_segmentation_torch.train.steps import make_src_train_step
from rnd_semantic_segmentation_torch.utils import resolve_device

SIZE, NC = 64, 2
LR = {"encoder": 2e-4, "decoder": 2e-3}   # warm-up cosine at epoch 0, decoder at 10x
WD = 1e-4


def _cfg(*opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", "attn_efficientnet-b0", "MODEL.NUM_CLASSES", str(NC),
                         "MODEL.DEVICE", "cpu", "SOLVER.BASE_LR", "1e-3",
                         "SOLVER.WEIGHT_DECAY", str(WD), "MODEL.DTYPE", "float32", *opts])
    return cfg


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return resolve_device("cuda")


def _segmentor(cfg, drop_connect: bool):
    spec = build_segmentor(cfg)
    if not drop_connect:
        spec.modules["encoder"] = EfficientNetEncoder(
            "efficientnet-b0", drop_connect_rate=0.0,
            fused_mbconv=bool(cfg.MODEL.FUSED_MBCONV))
    seg = Segmentor(spec, NC)
    randomize_weights_(seg, seed=10)
    return seg


def _batch():
    rng = np.random.RandomState(9)
    label = rng.randint(0, NC, (2, SIZE, SIZE)).astype(np.int32)
    label[:, :10, :20] = 255
    return {"image": torch.from_numpy(rng.rand(2, SIZE, SIZE, 3).astype(np.float32)),
            "label": torch.from_numpy(label)}


def _one_step(seg, cfg, batch, device):
    seg.to(device)
    tstate = TrainState(optimizers=make_optimizers(seg.spec, cfg))
    out = make_src_train_step(seg, cfg, 10, tstate)(
        {k: v.to(device) for k, v in batch.items()}, 0.0)
    grads = {f"parts.{n}.{k}": (p.grad + WD * p.detach()).cpu()
             for n, m in seg.spec.modules.items() for k, p in m.named_parameters()}
    return out, {k: v.detach().cpu() for k, v in seg.state_dict().items()}, grads


@pytest.mark.cuda
def test_one_train_step_on_the_card_matches_the_cpu_step():
    device = _card()
    cfg = _cfg()
    seg = _segmentor(cfg, drop_connect=False)
    start = {k: v.clone() for k, v in seg.state_dict().items()}
    batch = _batch()
    ref, ref_sd, grads = _one_step(copy.deepcopy(seg), cfg, batch, torch.device("cpu"))
    out, sd, _ = _one_step(seg, cfg, batch, device)
    assert np.isfinite(out["loss"]) and out["lr"] == ref["lr"]
    assert abs(out["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    checked = total = 0
    for key, g in grads.items():
        lr = LR[key.split(".")[1]]
        want, have = ref_sd[key] - start[key], sd[key] - start[key]
        assert have.abs().max() <= lr * 1.001 + 2.5e-7 * max(start[key].abs().max(), 1.0)
        clear = (torch.sign(want) == torch.sign(have)) & (g.abs() > 1e-5)
        if clear.any():
            assert (have - want)[clear].abs().max() <= 2e-3 * lr + 1e-7, key
        checked += int(clear.sum())
        total += clear.numel()
    assert checked > 0.85 * total, (checked, total)
    stats = [k for k in ref_sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 57
    for key in stats:
        assert not torch.equal(sd[key], start[key]), key
        assert (sd[key] - ref_sd[key]).abs().max() <= 1e-4 * ref_sd[key].abs().max(), key


@pytest.mark.cuda
def test_training_never_launches_the_fused_kernel_and_its_eval_matches_plain(monkeypatch):
    device = _card()
    cfg = _cfg("MODEL.FUSED_MBCONV", "True")
    seg = _segmentor(cfg, drop_connect=True).to(device)
    batch = {k: v.to(device) for k, v in _batch().items()}
    tstate = TrainState(optimizers=make_optimizers(seg.spec, cfg))
    step = make_src_train_step(seg, cfg, 10, tstate)
    before = mbconv.KERNEL_LAUNCHES
    losses = [step(batch, 0.0)["loss"] for _ in range(2)]
    torch.cuda.synchronize()
    assert mbconv.KERNEL_LAUNCHES == before and all(np.isfinite(losses))

    x = batch["image"].permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        fused, _ = seg(x)
        torch.cuda.synchronize()
        assert mbconv.KERNEL_LAUNCHES == before + 11   # b0: 11 eligible blocks
        with monkeypatch.context() as m:
            m.setattr(efficientnet, "fused_mbconv_core", mbconv.fused_mbconv_core_plain)
            plain_core, _ = seg(x)
        for block in seg.parts["encoder"].blocks:
            block.fused_mbconv = False
        unfused, _ = seg(x)
    assert mbconv.KERNEL_LAUNCHES == before + 11
    for f, p, u in zip(fused, plain_core, unfused):
        assert torch.isfinite(f).all()
        assert (f - p).abs().max() <= 1e-4 * p.abs().max()
        assert (f - u).abs().max() <= 1e-4 * u.abs().max()
