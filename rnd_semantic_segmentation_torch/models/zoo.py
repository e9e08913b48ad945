"""Attention and context blocks of the research zoo (counterpart of the JAX
package's models/zoo.py), on NCHW tensors.

  * NLBlockND — the non-local block in its four pairwise modes (gaussian,
    embedded, dot, concatenate);
  * A2Net — double attention: gather with softmax(B) over the pixels, then
    distribute with softmax(V) over the channels;
  * PyramidSelfAttention / APNB / AFNB — self-attention whose keys and values
    are pooled to a pyramid of 1, 3, 6 and 8 bins (``F.adaptive_avg_pool2d``,
    the JAX ``_adaptive_avg_pool``); AFNB takes its queries from a second,
    high-level input;
  * SpatialGCN / DualGCN / DualGCNHead — graph convolution over the spatial
    tokens and over a projected coordinate space (1x1 ``Conv1d`` over
    [B, C, N] tokens and ``BatchNorm1d``, where the JAX package has a Dense
    and a token BatchNorm);
  * SpatialCGNLx — CGNL with the Taylor-expanded gaussian RBF kernel;
  * RCCAModule — the recurrent criss-cross head: conva, one
    ``CrissCrossAttention`` applied ``recurrence`` times with shared weights
    (kernels #1 and #2 of ops/ccattn.py on CUDA tensors), convb, the
    bottleneck on [x, out] and its classifier; the reference's InPlaceABNSync
    is BatchNorm + LeakyReLU(0.01);
  * SpatialNL — the plain spatial non-local block;
  * SEBlock — the squeeze-and-excitation gate.

Keys are the reference's where the JAX docstrings cite one (ccnet.py:
``conva.0``, ``cca.query_conv``, ``bottleneck.3`` for the classifier;
DualGCNNet.py: ``local.4``, ``out.1``, ``final.0``, ``conv_wg``;
cgnonlocal.py: ``t``, ``p``, ``g``, ``z``, ``gn``); elsewhere they are the
JAX scopes (``W_z_conv``, ``stage0.f_key``, ``fc1``).  ``ckpt/torch_import.py``
(``RESEARCH_RULES``) maps the two.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import resize_bilinear
from .contextagg import _bottleneck_classifier, _conv_bn_relu
from .gcpa import CrissCrossAttention
from .layers import BatchNorm, Conv1d, Conv2d, GroupNorm, Linear, relu


def _tokens(t: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, H*W]."""
    return t.flatten(2)


class NLBlockND(nn.Module):
    """2D non-local block; mode in {gaussian, embedded, dot, concatenate}."""

    def __init__(self, in_channels: int, inter_channels: Optional[int] = None,
                 mode: str = "embedded", bn_layer: bool = True):
        super().__init__()
        if mode not in ("gaussian", "embedded", "dot", "concatenate"):
            raise ValueError(mode)
        self.mode, self.bn_layer = mode, bn_layer
        inter = inter_channels or max(in_channels // 2, 1)
        self.g = Conv2d(in_channels, inter, 1)
        if mode != "gaussian":
            self.theta = Conv2d(in_channels, inter, 1)
            self.phi = Conv2d(in_channels, inter, 1)
        if mode == "concatenate":
            self.W_f = Conv2d(2 * inter, 1, 1)
        self.W_z_conv = Conv2d(inter, in_channels, 1)
        if bn_layer:
            # a zero BN scale makes the block the identity at init
            self.W_z_bn = BatchNorm(in_channels)
            nn.init.zeros_(self.W_z_bn.weight)
        else:
            nn.init.zeros_(self.W_z_conv.weight)
            nn.init.zeros_(self.W_z_conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        n = h * w
        g_x = _tokens(self.g(x)).transpose(1, 2)                  # [B, N, inter]
        if self.mode == "gaussian":
            theta = phi = _tokens(x).transpose(1, 2)
        else:
            theta = _tokens(self.theta(x)).transpose(1, 2)
            phi = _tokens(self.phi(x)).transpose(1, 2)
        if self.mode == "concatenate":
            inter = theta.shape[-1]
            pairs = torch.cat([theta[:, :, None, :].expand(b, n, n, inter),
                               phi[:, None, :, :].expand(b, n, n, inter)], dim=-1)
            f = relu(self.W_f(pairs.permute(0, 3, 1, 2))).view(b, n, n)
        else:
            f = theta @ phi.transpose(1, 2)
        f = torch.softmax(f, dim=-1) if self.mode in ("gaussian", "embedded") else f / n
        y = (f @ g_x).transpose(1, 2).reshape(b, -1, h, w)
        y = self.W_z_conv(y)
        if self.bn_layer:
            y = self.W_z_bn(y)
        return y + x


class A2Net(nn.Module):
    """Double attention: gather (A softmax(B)^T), then distribute (softmax V)."""

    def __init__(self, in_channels: int, c_m: int, c_n: int):
        super().__init__()
        self.convA = Conv2d(in_channels, c_m, 1)
        self.convB = Conv2d(in_channels, c_n, 1)
        self.convV = Conv2d(in_channels, c_n, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        a = _tokens(self.convA(x))                                # [B, c_m, N]
        att_b = torch.softmax(_tokens(self.convB(x)), dim=2)      # over the pixels
        att_v = torch.softmax(_tokens(self.convV(x)), dim=1)      # over c_n
        gathered = torch.einsum("bmn,bcn->bmc", a, att_b)         # [B, c_m, c_n]
        return torch.einsum("bmc,bcn->bmn", gathered, att_v).view(b, -1, h, w)


def _pyramid_tokens(t: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """[B, C, S]: t pooled to each s x s grid, the bins in row-major order."""
    return torch.cat([_tokens(F.adaptive_avg_pool2d(t, s)) for s in sizes], dim=2)


class PyramidSelfAttention(nn.Module):
    """Self-attention with pyramid-pooled keys and values.  ``fusion`` (AFNB)
    takes the queries from ``high`` through their own conv and BN; otherwise
    the queries share ``f_key`` and ``f_key_bn`` with the keys."""

    def __init__(self, in_channels: int, key_channels: int, value_channels: int,
                 out_channels: Optional[int] = None, psp_size: Sequence[int] = (1, 3, 6, 8),
                 fusion: bool = False, query_in_channels: Optional[int] = None):
        super().__init__()
        self.key_channels, self.value_channels = key_channels, value_channels
        self.psp_size, self.fusion = tuple(psp_size), fusion
        q_in = query_in_channels or in_channels
        self.f_key = Conv2d(in_channels, key_channels, 1)
        self.f_key_bn = BatchNorm(key_channels)
        if fusion:
            self.f_query = Conv2d(q_in, key_channels, 1)
            self.f_query_bn = BatchNorm(key_channels)
        self.f_value = Conv2d(in_channels, value_channels, 1)
        self.W = Conv2d(value_channels, out_channels or q_in, 1)
        nn.init.zeros_(self.W.weight)
        nn.init.zeros_(self.W.bias)

    def forward(self, low: torch.Tensor, high: Optional[torch.Tensor] = None) -> torch.Tensor:
        q_src = high if (self.fusion and high is not None) else low
        b, _, h, w = q_src.shape
        key = relu(self.f_key_bn(self.f_key(low)))
        if self.fusion:
            query = relu(self.f_query_bn(self.f_query(q_src)))
        else:
            query = relu(self.f_key_bn(self.f_key(q_src)))
        key_t = _pyramid_tokens(key, self.psp_size)                # [B, Ck, S]
        value_t = _pyramid_tokens(self.f_value(low), self.psp_size)
        sim = torch.einsum("bcq,bcs->bqs", _tokens(query), key_t) * self.key_channels ** -0.5
        ctx = torch.einsum("bqs,bcs->bcq", torch.softmax(sim, dim=-1), value_t)
        return self.W(ctx.reshape(b, self.value_channels, h, w))


class APNB(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, key_channels: int,
                 value_channels: int, dropout: float = 0.05,
                 psp_size: Sequence[int] = (1, 3, 6, 8)):
        super().__init__()
        self.dropout = dropout
        self.stage0 = PyramidSelfAttention(in_channels, key_channels, value_channels,
                                           in_channels, psp_size)
        self.conv_bn_conv = Conv2d(2 * in_channels, out_channels, 1)
        self.conv_bn_bn = BatchNorm(out_channels)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        out = torch.cat([self.stage0(feats), feats], dim=1)
        out = relu(self.conv_bn_bn(self.conv_bn_conv(out)))
        if self.training and self.dropout > 0:
            out = F.dropout2d(out, self.dropout)  # whole channels, as the JAX mask [B,1,1,C]
        return out


class AFNB(nn.Module):
    """Fusion variant: low-level keys and values attend into high-level queries."""

    def __init__(self, low_in_channels: int, high_in_channels: int, out_channels: int,
                 key_channels: int, value_channels: int, dropout: float = 0.05,
                 psp_size: Sequence[int] = (1, 3, 6, 8)):
        super().__init__()
        self.stage0 = PyramidSelfAttention(low_in_channels, key_channels, value_channels,
                                           out_channels, psp_size, fusion=True,
                                           query_in_channels=high_in_channels)
        self.conv_bn_conv = Conv2d(out_channels + high_in_channels, out_channels, 1)
        self.conv_bn_bn = BatchNorm(out_channels)

    def forward(self, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
        out = torch.cat([self.stage0(low, high), high], dim=1)
        return self.conv_bn_bn(self.conv_bn_conv(out))


class SpatialGCN(nn.Module):
    """Graph convolution over the spatial tokens."""

    def __init__(self, plane: int):
        super().__init__()
        inter = plane // 2
        self.node_k = Conv2d(plane, inter, 1)
        self.node_v = Conv2d(plane, inter, 1)
        self.node_q = Conv2d(plane, inter, 1)
        self.conv_wg = Conv1d(inter, inter, 1, bias=False)
        self.bn_wg = nn.BatchNorm1d(inter)
        self.out = nn.Sequential(Conv2d(inter, plane, 1), BatchNorm(plane))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        k, v, q = (_tokens(conv(x)) for conv in (self.node_k, self.node_v, self.node_q))
        av = torch.softmax(q @ v.transpose(1, 2), dim=2)           # [B, inter, inter]
        av = (k.transpose(1, 2) @ av).transpose(1, 2)              # [B, inter, N]
        avw = self.bn_wg(self.conv_wg(av)).view(b, -1, h, w)
        return relu(self.out(avw) + x)


class DualGCN(nn.Module):
    """Coordinate-space and feature-space graph convolution."""

    def __init__(self, planes: int, ratio: int = 4):
        super().__init__()
        r1, r2 = planes // ratio, planes // ratio * 2
        self.phi = Conv2d(planes, r2, 1, bias=False)
        self.bn_phi = BatchNorm(r2)
        self.theta = Conv2d(planes, r1, 1, bias=False)
        self.bn_theta = BatchNorm(r1)
        self.conv_adj = Conv1d(r1, r1, 1, bias=False)
        self.bn_adj = nn.BatchNorm1d(r1)
        self.conv_wg = Conv1d(r2, r2, 1, bias=False)
        self.bn_wg = nn.BatchNorm1d(r2)
        self.conv3 = Conv2d(r2, planes, 1, bias=False)
        self.bn3 = BatchNorm(planes)
        local = []
        for _ in range(3):
            local += [Conv2d(planes, planes, 3, 2, padding=1, groups=planes, bias=False),
                      BatchNorm(planes)]
        self.local = nn.Sequential(*local)
        self.gcn_local_attention = SpatialGCN(planes)
        self.final = nn.Sequential(Conv2d(2 * planes, planes, 1, bias=False),
                                   BatchNorm(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        local = self.gcn_local_attention(self.local(x))
        local = resize_bilinear(local.float(), (h, w), align_corners=True).to(x.dtype)
        spatial_local_feat = x * local + x

        x_sqz = _tokens(self.bn_phi(self.phi(x)))                  # [B, r2, N]
        bproj = _tokens(self.bn_theta(self.theta(x)))              # [B, r1, N]
        z_idt = x_sqz @ bproj.transpose(1, 2)                      # [B, r2, r1]
        z = self.bn_adj(self.conv_adj(z_idt.transpose(1, 2)))      # [B, r1, r2]
        z = z.transpose(1, 2) + z_idt                              # Laplacian smoothing
        z = self.bn_wg(self.conv_wg(z))                            # [B, r2, r1]
        y = (z @ bproj).view(b, -1, h, w)                          # [B, r2, H, W]
        g_out = relu(x + self.bn3(self.conv3(y)))
        return self.final(torch.cat([spatial_local_feat, g_out], dim=1))


class DualGCNHead(nn.Module):
    def __init__(self, inplanes: int, interplanes: int, num_classes: int):
        super().__init__()
        self.conva = _conv_bn_relu(inplanes, interplanes)
        self.dualgcn = DualGCN(interplanes)
        self.convb = _conv_bn_relu(interplanes, interplanes)
        self.bottleneck = _bottleneck_classifier(inplanes + interplanes, interplanes,
                                                 num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.convb(self.dualgcn(self.conva(x)))
        return self.bottleneck(torch.cat([x, out], dim=1))


def _grouped(t: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, G, C/G, H, W] in float32."""
    b, c, h, w = t.shape
    return t.float().view(b, groups, c // groups, h, w)


class SpatialCGNLx(nn.Module):
    """CGNL with the Taylor-expanded gaussian RBF kernel (gamma 1e-4):
    out = sum_n beta (2 gamma)^n / n! * <p^n, g> * t^n, per group."""

    def __init__(self, inplanes: int, planes: int, groups: int = 8, order: int = 2,
                 use_scale: bool = False):
        super().__init__()
        self.planes, self.groups, self.order, self.use_scale = planes, groups, order, use_scale
        self.t = Conv2d(inplanes, planes, 1, bias=False)
        self.p = Conv2d(inplanes, planes, 1, bias=False)
        self.g = Conv2d(inplanes, planes, 1, bias=False)
        self.z = Conv2d(planes, inplanes, 1, groups=groups, bias=False)
        self.gn = GroupNorm(groups, inplanes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        tg, pg, gg = (_grouped(conv(x), self.groups) for conv in (self.t, self.p, self.g))
        gamma = torch.tensor(1e-4, dtype=torch.float32)
        beta = torch.exp(-2.0 * gamma)
        out = torch.zeros_like(tg)
        for n in range(self.order + 1):
            coef = beta * (2 * gamma) ** n / math.factorial(n)
            att = (pg ** n * gg).sum(dim=(2, 3, 4), keepdim=True)
            if self.use_scale:
                att = att / float(self.planes // self.groups * h * w) ** 0.5
            out = out + coef * att * tg ** n
        out = out.view(b, self.planes, h, w).to(x.dtype)
        return self.gn(self.z(out)) + x


class RCCAModule(nn.Module):
    """Recurrent criss-cross head; ``cca`` (Cq = in_channels / 32, C =
    in_channels / 4) runs ``recurrence`` times on its own output."""

    def __init__(self, in_channels: int, out_channels: int, num_classes: int,
                 recurrence: int = 2):
        super().__init__()
        inter = in_channels // 4
        self.recurrence = recurrence
        self.conva = nn.Sequential(Conv2d(in_channels, inter, 3, padding=1, bias=False),
                                   BatchNorm(inter), nn.LeakyReLU(0.01))
        self.cca = CrissCrossAttention(inter)
        self.convb = nn.Sequential(Conv2d(inter, inter, 3, padding=1, bias=False),
                                   BatchNorm(inter), nn.LeakyReLU(0.01))
        self.bottleneck = nn.Sequential(
            Conv2d(in_channels + inter, out_channels, 3, padding=1, bias=False),
            BatchNorm(out_channels), nn.LeakyReLU(0.01),
            Conv2d(out_channels, num_classes, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conva(x)
        for _ in range(self.recurrence):
            out = self.cca(out)
        out = self.convb(out)
        return self.bottleneck(torch.cat([x, out], dim=1))


class SpatialNL(nn.Module):
    """Plain spatial non-local block with softmax attention."""

    def __init__(self, inplanes: int, planes: int, use_scale: bool = False):
        super().__init__()
        self.planes, self.use_scale = planes, use_scale
        self.t = Conv2d(inplanes, planes, 1, bias=False)
        self.p = Conv2d(inplanes, planes, 1, bias=False)
        self.g = Conv2d(inplanes, planes, 1, bias=False)
        self.z = Conv2d(planes, inplanes, 1, bias=False)
        self.bn = BatchNorm(inplanes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        t, p, g = (_tokens(conv(x)) for conv in (self.t, self.p, self.g))
        att = t.transpose(1, 2) @ p                                # [B, N, N]
        if self.use_scale:
            att = att / float(self.planes) ** 0.5
        y = g @ torch.softmax(att, dim=-1).transpose(1, 2)         # [B, planes, N]
        return self.bn(self.z(y.view(b, self.planes, h, w))) + x


class SEBlock(nn.Module):
    """Squeeze-and-excitation channel gate."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = Linear(channels, channels // reduction)
        self.fc2 = Linear(channels // reduction, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = relu(self.fc1(x.mean(dim=(2, 3))))
        return x * torch.sigmoid(self.fc2(s))[:, :, None, None]
