"""CCNet on the card: a seeded ``CCNetSegModel`` at a cut depth (``layers=(1,
1, 2, 1)``) and its own attention widths (Cq = 64, C = 512) gives the CPU's
outputs and gradients, its two criss-cross passes through kernels #1 and #2
(two launches of each for one forward and backward).  Skips without a card.

Eval mode (running statistics), gamma at 0.7, the query and key kernels at a
tenth of their seeded scale so that the joint softmax is not saturated
(tests/test_torch_seg_nets.py says why).  Tolerances: outputs 1e-4 of their
largest magnitude; gradients 1e-4 of each leaf's norm, or of 1e-3 of the
largest leaf's where that is larger (cuDNN with TF32 off and the kernels sum
in other orders than the CPU).

This file imports nothing of the JAX package, so that it collects on a
machine that has the card and not the JAX package's dependencies; the CPU
parity of the same net is in tests/test_torch_seg_nets.py.
"""

import copy

import pytest
import torch

from rnd_semantic_segmentation_torch.models.build import randomize_weights_
from rnd_semantic_segmentation_torch.models.seg_nets import CCNetSegModel
from rnd_semantic_segmentation_torch.ops import ccattn
from rnd_semantic_segmentation_torch.utils import resolve_device

NC, SIDE = 5, 129  # a 17 x 17 map at output stride 8


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return resolve_device("cuda")


def _grads(net, x, weights):
    net.zero_grad()
    x = x.clone().requires_grad_()
    main, dsn = net(x)
    loss = (main * weights[0]).sum() + (dsn * weights[1]).sum()
    loss.backward()
    return (main.detach(), dsn.detach(), x.grad,
            {n: p.grad.detach() for n, p in net.named_parameters()})


@pytest.mark.cuda
def test_ccnet_forward_and_backward_on_the_card_match_the_cpu():
    device = _card()
    net = randomize_weights_(CCNetSegModel(NC, layers=(1, 1, 2, 1)), seed=17).eval()
    with torch.no_grad():
        net.head.cca.query_conv.weight.mul_(0.1)
        net.head.cca.key_conv.weight.mul_(0.1)
    gen = torch.Generator().manual_seed(17)
    x = torch.randn(2, 3, SIDE, SIDE, generator=gen)
    weights = [torch.randn(2, NC, 17, 17, generator=gen) for _ in range(2)]
    ref = _grads(net, x, weights)
    card = copy.deepcopy(net).to(device)
    fwd, bwd = ccattn.KERNEL_LAUNCHES, ccattn.BWD_KERNEL_LAUNCHES
    got = _grads(card, x.to(device), [w.to(device) for w in weights])
    torch.cuda.synchronize()
    assert (ccattn.KERNEL_LAUNCHES - fwd, ccattn.BWD_KERNEL_LAUNCHES - bwd) == (2, 2)
    for out, want in zip(got[:3], ref[:3]):
        assert (out.cpu() - want).abs().max() <= 1e-4 * want.abs().max()
    floor = 1e-3 * max(g.norm() for g in ref[3].values())
    for name, want in ref[3].items():
        err = (got[3][name].cpu() - want).norm() / max(want.norm(), floor)
        assert err <= 1e-4, f"{name}: {err}"
