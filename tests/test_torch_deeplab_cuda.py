"""The DeepLab slice on the card: a seeded deeplab_resnet18 at 64x64 gives
the CPU's logits within 1e-4 of their largest magnitude (cuDNN with TF32
off), and one SGD train step on the card moves every parameter and leaves
every FrozenBN buffer as it was.  Both skip without a card.

This file imports nothing of the JAX package, so that it collects on a
machine that has the card and not the JAX package's dependencies; the CPU
parity of the same paths is in tests/test_torch_deeplab.py.
"""

import numpy as np
import pytest
import torch

from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor
from rnd_semantic_segmentation_torch.train.state import TrainState, make_optimizers
from rnd_semantic_segmentation_torch.train.steps import make_src_train_step
from rnd_semantic_segmentation_torch.utils import resolve_device

SIZE, NC = 64, 5


def _cfg(*opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", "deeplab_resnet18", "MODEL.NUM_CLASSES", str(NC),
                         "MODEL.FREEZE_BN", "True", "MODEL.DEVICE", "cpu",
                         "SOLVER.BASE_LR", "1e-3", "MODEL.DTYPE", "float32", *opts])
    return cfg


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return resolve_device("cuda")


@pytest.mark.cuda
def test_card_logits_match_the_cpu_logits():
    device = _card()
    seg = Segmentor(build_segmentor(_cfg()), NC)
    randomize_weights_(seg, seed=12)
    x = torch.randn(2, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        (ref,), _ = seg(x)
        (out,), _ = seg.to(device)(x.to(device))
    assert (out.cpu() - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.cuda
def test_one_train_step_on_the_card():
    device = _card()
    rng = np.random.RandomState(9)
    batch = {"image": torch.from_numpy(rng.randn(2, SIZE, SIZE, 3).astype(np.float32)),
             "label": torch.from_numpy(rng.randint(0, NC, (2, SIZE, SIZE)).astype(np.int32))}
    cfg = _cfg()
    seg = Segmentor(build_segmentor(cfg), NC)
    randomize_weights_(seg, seed=10)
    seg.to(device)
    before = {k: v.clone() for k, v in seg.state_dict().items()}
    tstate = TrainState(optimizers=make_optimizers(seg.spec, cfg))
    step = make_src_train_step(seg, cfg, 10, tstate)
    out = step({k: v.to(device) for k, v in batch.items()}, 0.0)
    assert np.isfinite(out["loss"])
    assert all(not torch.equal(p, before[k]) for k, p in seg.named_parameters())
    assert all(torch.equal(b, before[k]) for k, b in seg.named_buffers())
