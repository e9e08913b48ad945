"""Weights between the JAX package's variables and reference ``state_dict``s.

``deeplab_state_dicts_from_flax``, ``gald_state_dicts_from_flax``,
``attn_state_dicts_from_flax``, ``pranet_state_dicts_from_flax`` and
``disc_state_dict_from_flax`` are the inverses of the JAX package's
``convert_state_dict`` with its ResNet backbone or VGG16 and ASPP
classifier, GCPA, attn encoder and decoder, PraNet (``PRANET_RULES`` on
Res2Net50-v1b, ``CRANET_RULES`` on a ResNet) and discriminator rule tables:
flax scope paths become the reference's torch keys, and by role

  * conv kernels go from HWIO to OIHW (depthwise ones too);
  * transposed-conv kernels, which the JAX package stores flipped in
    correlation orientation (kh, kw, I, O), are transposed to (I, O, kh, kw)
    and flipped back along both spatial axes;
  * BN ``scale``/``bias`` become ``weight``/``bias``, and ``batch_stats``
    ``mean``/``var`` become ``running_mean``/``running_var``;
  * FrozenBN's ``frozen`` collection (``weight``, ``bias``, ``mean``,
    ``var``) becomes the buffers ``weight``, ``bias``, ``running_mean`` and
    ``running_var``;
  * the criss-cross ``gamma`` keeps its shape (1,).

They take the variables as nested dicts of arrays (numpy, or anything
``np.asarray`` reads) and import no JAX.

``gald_flax_from_state_dicts``, ``deeplab_flax_from_state_dicts``,
``attn_flax_from_state_dicts``, ``pranet_flax_from_state_dicts`` and
``disc_flax_from_state_dict`` go the other way, for the training tests:
the port's tensors by ``state_dict`` key (weights, or gradients by parameter
name) are laid out as a flax tree, so that loss, gradients and updated
parameters can be compared leaf by leaf.  ``attnwrap_state_dicts_from_flax``
and ``attnwrap_flax_from_state_dicts`` are the pair for the single-module
variant: its ``model`` part holds the attn encoder and decoder, under
``encoder``/``decoder`` scopes in flax and ``encoder.``/``decoder.`` key
prefixes in torch.

``research_state_dict_from_flax`` and ``research_flax_from_state_dict`` are
the pair for one module of the research zoo (models/contextagg.py, zoo.py,
seg_nets.py, nets_zoo.py, encoders_zoo.py, cls_hubs.py, fam_variants.py,
resnet3d.py, the GALD blocks of gcpa.py, ``Res2Net`` with its GCNet blocks,
``HarDNet`` of any arch), by class name (``RESEARCH_RULES``): Dense kernels
become Linear weights or 1x1 ``Conv1d`` weights (O, I, 1), the GCNet
LayerNorm's affine (C, 1, 1) and HolisticAttention's kernel (1, 1, 31, 31),
3D conv kernels go from DHWIO to OIDHW, and CE-Net's transposed convs
(``deconv2``, ``finaldeconv1``) are flipped as above.
``PRETRAINED_LAYOUTS`` says where a published backbone ``.pth`` lands in
each family's parts (MODEL.WEIGHTS, ckpt/pretrained.py).

``load_reference_checkpoint`` reads the model parts of a reference-layout
``.pth`` (``{"encoder": sd, "decoder": sd}``, with or without the optimizer
states, epoch and step a training checkpoint adds);
``save_reference_checkpoint`` writes one from the port's modules.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# flax scope path -> torch key prefix, applied in order
_ENCODER_RULES = [
    (r"base_(\d+)", r"base.\1"),
    (r"layers_(\d+)", r"layers.\1"),
    (r"/", "."),
]
_DECODER_RULES = [
    (r"^conva_conv$", "conva.0"),
    (r"^conva_bn$", "conva.1"),
    (r"dconv(\d)_conv$", r"dconv\1.0"),
    (r"dconv(\d)_bn$", r"dconv\1.1"),
    (r"^fam(\d+)/b(\d)/conv$", r"fam\1.conv\2"),
    (r"^fam(\d+)/b(\d)/bn$", r"fam\1.bn\2"),
    (r"/", "."),
]
# the attn family: efficientnet-pytorch's underscored attributes under the
# reference's ``encoder`` wrapper; the decoder's Sequential decode blocks
# (conv, BN, LeakyReLU twice: indices 0, 1, 3, 4) and one-conv heads
_ATTN_ENCODER_RULES = [
    (r"^blocks_(\d+)/", r"_blocks.\1._"),
    (r"^(?!_blocks)", "_"),
    (r"^", "encoder."),
]
_ATTN_DECODER_RULES = [
    (r"^decode_(\d)/conv0$", r"decode_\1.0"),
    (r"^decode_(\d)/bn0$", r"decode_\1.1"),
    (r"^decode_(\d)/conv1$", r"decode_\1.3"),
    (r"^decode_(\d)/bn1$", r"decode_\1.4"),
    (r"^out_(\d)$", r"out_\1.0"),
    (r"/", "."),
]
_ATTN_DECODER_TRANSPOSED = (r"^mid_upsampler$", r"^ups_\d$")
# the deeplab family: torchvision ResNet under the reference's ``backbone``
# (layer blocks and the downsample Sequential), and the ASPP ``conv2d_list``
_RESNET_BACKBONE_RULES = [
    (r"layer(\d+)_(\d+)", r"layer\1.\2"),
    (r"downsample_conv$", "downsample.0"),
    (r"downsample_bn$", "downsample.1"),
    (r"/", "."),
]
_ASPP_CLASSIFIER_RULES = [
    (r"^conv2d_(\d+)$", r"conv2d_list.\1"),
    (r"/", "."),
]
# VGG16-FCN: conv0..conv12 are torchvision's ``features`` convs; fc6, fc7 keep
# their names
_VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG16_RULES = [
    (r"^conv(\d+)$", lambda m: f"features.{_VGG16_CONV_IDX[int(m.group(1))]}"),
    (r"/", "."),
]
# PixelDiscriminator: the trunk Sequential ``D`` has its convs at 0 and 2;
# FCDiscriminator's conv1..conv4 and classifier keep their names
_DISC_RULES = [
    (r"^d0$", "D.0"),
    (r"^d1$", "D.2"),
    (r"/", "."),
]
# PraNet: the RFB branches are Sequentials of BasicConv2d; Res2Net50-v1b's
# deep stem is the Sequential ``conv1`` (convs at 0, 3, 6, BNs at 1, 4) and
# its shortcut ``downsample`` holds the pool at 0, the conv at 1 and the BN
# at 2; the CRANet ResNet's is torchvision's (conv 0, BN 1)
_PRANET_HEAD_RULES = [
    (r"branch(\d)_(\d)", r"branch\1.\2"),
    (r"/", "."),
]
_PRANET_RULES = [
    (r"^resnet/stem_conv0$", "resnet/conv1/0"),
    (r"^resnet/stem_bn0$", "resnet/conv1/1"),
    (r"^resnet/stem_conv1$", "resnet/conv1/3"),
    (r"^resnet/stem_bn1$", "resnet/conv1/4"),
    (r"^resnet/stem_conv2$", "resnet/conv1/6"),
    (r"layer(\d+)_(\d+)", r"layer\1.\2"),
    (r"convs_(\d+)$", r"convs.\1"),
    (r"bns_(\d+)$", r"bns.\1"),
    (r"downsample_conv$", "downsample.1"),
    (r"downsample_bn$", "downsample.2"),
] + _PRANET_HEAD_RULES
_CRANET_RULES = [
    (r"layer(\d+)_(\d+)", r"layer\1.\2"),
    (r"downsample_conv$", "downsample.0"),
    (r"downsample_bn$", "downsample.1"),
] + _PRANET_HEAD_RULES
# The research zoo (models/contextagg.py, zoo.py, seg_nets.py and the GCNet
# blocks of Res2Net): one table per top-level module, by class name.  The
# reference's Sequentials: conva/convb/bottleneck (conv 0, BN 1, the
# classifier at bottleneck.3), GALDBlock's down (conv 0, BN 1), DualGCN's
# local (convs at 0, 2, 4, BNs at 1, 3, 5), out and final (conv 0, BN 1),
# GCNet's channel transforms (conv 0, LayerNorm 1, conv 3), PSPModule's
# stages (pool 0, conv 1, BN 2); the deep-stem backbone's attributes sit on
# the net (``backbone/stem_conv0`` -> ``conv1``, ``backbone/bn1``, the third
# stem norm, -> ``bn3``) and the dsn's classifier at dsn.3.  Everything else
# keeps its JAX scope.
_HEAD_SEQ_RULES = [
    (r"(^|/)(conva|convb|bottleneck)_conv$", r"\1\2/0"),
    (r"(^|/)(conva|convb|bottleneck)_bn$", r"\1\2/1"),
    (r"(^|/)classifier$", r"\1bottleneck/3"),
]
_GALD_BLOCK_RULES = [
    (r"(^|/)down_conv$", r"\1down/0"),
    (r"(^|/)down_bn$", r"\1down/1"),
    (r"dconv(\d)_conv$", r"dconv\1/0"),
    (r"dconv(\d)_bn$", r"dconv\1/1"),
]
_GCB_RULES = [
    (r"channel_(add|mul)_0$", r"channel_\1_conv/0"),
    (r"channel_(add|mul)_ln$", r"channel_\1_conv/1"),
    (r"channel_(add|mul)_1$", r"channel_\1_conv/3"),
]
_DUALGCN_RULES = [
    (r"local_conv(\d)$", lambda m: f"local/{2 * int(m.group(1))}"),
    (r"local_bn(\d)$", lambda m: f"local/{2 * int(m.group(1)) + 1}"),
    (r"(^|/)(out|final)_conv$", r"\1\2/0"),
    (r"(^|/)(out|final)_bn$", r"\1\2/1"),
]
_PSP_RULES = [
    (r"stage(\d+)_conv$", r"stages/\1/1"),
    (r"stage(\d+)_bn$", r"stages/\1/2"),
]
_SEG_BACKBONE_RULES = [
    (r"^(backbone/)?bn1$", "bn3"),
    (r"^(backbone/)?stem_conv(\d)$", lambda m: f"conv{int(m.group(2)) + 1}"),
    (r"^(backbone/)?stem_bn(\d)$", lambda m: f"bn{int(m.group(2)) + 1}"),
    (r"^backbone/", ""),
    (r"layer(\d+)_(\d+)", r"layer\1/\2"),
    (r"downsample_conv$", "downsample/0"),
    (r"downsample_bn$", "downsample/1"),
]
_DSN_RULES = [(r"^dsn/conv$", "dsn/0"), (r"^dsn/bn$", "dsn/1"), (r"^dsn/cls$", "dsn/3")]
_RES2NET_RULES = [
    (r"^stem_conv0$", "conv1/0"),
    (r"^stem_bn0$", "conv1/1"),
    (r"^stem_conv1$", "conv1/3"),
    (r"^stem_bn1$", "conv1/4"),
    (r"^stem_conv2$", "conv1/6"),
    (r"layer(\d+)_(\d+)", r"layer\1/\2"),
    (r"convs_(\d+)$", r"convs/\1"),
    (r"bns_(\d+)$", r"bns/\1"),
    (r"downsample_conv$", "downsample/1"),
    (r"downsample_bn$", "downsample/2"),
] + _GCB_RULES
_SLASH = [(r"/", ".")]
_REPVGG_RULES = [
    (r"^stage(\d+)_(\d+)", r"stage\1/\2"),
    (r"rbr_(dense|1x1)_(conv|bn)$", r"rbr_\1/\2"),
]
_FAM_BRANCH_RULES = [(r"(^|/)b(\d)/(conv|bn)$", r"\1\3\2")]
RESEARCH_RULES = {
    "SpatialCGNL": _SLASH,
    "GALDBlock": _GALD_BLOCK_RULES + _SLASH,
    "CA": _SLASH,
    "SRM": _SLASH,
    "SA": _SLASH,
    "SmallLocalAttenModule": _GALD_BLOCK_RULES + _SLASH,
    "GALDHead": _HEAD_SEQ_RULES + _GALD_BLOCK_RULES + _SLASH,
    "GCPAGALDNet": _GALD_BLOCK_RULES + _DECODER_RULES[:-1] + _PRANET_RULES,
    "PSPModule": _PSP_RULES + _HEAD_SEQ_RULES + _SLASH,
    "ContextBlock2d": _GCB_RULES + _SLASH,
    "SNLBlock2d": _SLASH,
    "GCHead": _HEAD_SEQ_RULES + _GCB_RULES + _SLASH,
    "HolisticAttention": _SLASH,
    "NLBlockND": _SLASH,
    "A2Net": _SLASH,
    "PyramidSelfAttention": _SLASH,
    "APNB": _SLASH,
    "AFNB": _SLASH,
    "SpatialGCN": _DUALGCN_RULES + _SLASH,
    "DualGCN": _DUALGCN_RULES + _SLASH,
    "DualGCNHead": _HEAD_SEQ_RULES + _DUALGCN_RULES + _SLASH,
    "SpatialCGNLx": _SLASH,
    "RCCAModule": _HEAD_SEQ_RULES + _SLASH,
    "SpatialNL": _SLASH,
    "SEBlock": _SLASH,
    "Res2Net": _RES2NET_RULES + _SLASH,
    "DilatedSegBackbone": _SEG_BACKBONE_RULES + _SLASH,
    "GALDNetFull": _SEG_BACKBONE_RULES + _DSN_RULES + _HEAD_SEQ_RULES + _GALD_BLOCK_RULES
    + _SLASH,
    "CCNetSegModel": _SEG_BACKBONE_RULES + _DSN_RULES + _HEAD_SEQ_RULES + _SLASH,
    "PSPNetFull": _SEG_BACKBONE_RULES + _DSN_RULES
    + [(r"^head/", "head/0/"), (r"^cls$", "head/1")] + _PSP_RULES + _HEAD_SEQ_RULES + _SLASH,
    "PSPHead": _SEG_BACKBONE_RULES + _PSP_RULES + _HEAD_SEQ_RULES + _SLASH,
    "DualSegNet": _SEG_BACKBONE_RULES + _DSN_RULES + _HEAD_SEQ_RULES + _DUALGCN_RULES
    + _SLASH,
    # models/nets_zoo.py: JAX scopes, the ResNet encoders torchvision's
    # (``_RESNET_BACKBONE_RULES``, as the deeplab backbone's)
    "UNet": _SLASH,
    "DACBlock": _SLASH,
    "DACBlockNoAtrous": _SLASH,
    "DACBlockInception": _SLASH,
    "DACBlockInceptionBlocks": _SLASH,
    "SPPBlock": _SLASH,
    "CENet": _RESNET_BACKBONE_RULES,
    "BiSeNetV1": _RESNET_BACKBONE_RULES,
    # models/encoders_zoo.py: RepVGG's stages and branches are the
    # reference's Sequentials (``stage1.0.rbr_dense.conv``)
    "RepVGGBlock": _REPVGG_RULES + _SLASH,
    "RepVGG": _REPVGG_RULES + _SLASH,
    # layer3_1_0 is block 0 of the branch layer3_1; then torchvision's shortcut
    "B2ResNet": [(r"^(layer\d+(?:_\d)?)_(\d+)", r"\1.\2")] + _RESNET_BACKBONE_RULES[1:],
    "B2VGG": _SLASH,
    "SEBasicBlock": _RESNET_BACKBONE_RULES,
    "SEResNet": _RESNET_BACKBONE_RULES,
    "DeepLabV3": _RESNET_BACKBONE_RULES,
    "DeepLabV3ASPP": _SLASH,
    # models/cls_hubs.py: the inserted context block keeps its scope ``layer3_nl``
    "NLResNet": _RESNET_BACKBONE_RULES,
    "CGNLResNet": _RESNET_BACKBONE_RULES,
    # models/fam_variants.py: the FAM branches ``bN/conv``, ``bN/bn`` are the
    # live FAM's ``convN``, ``bnN``
    "FAMAG": _SLASH,
    "FAMPra": _FAM_BRANCH_RULES + _SLASH,
    "FAMSCWS": _FAM_BRANCH_RULES + _SLASH,
    # models/resnet3d.py
    "BasicBlock3d": _RESNET_BACKBONE_RULES,
    "ResNet3D": _RESNET_BACKBONE_RULES,
    # models/hardnet.py, any arch: the reference's ``base.N.layers.M``
    "HarDNet": _ENCODER_RULES,
}
# the research modules' transposed convs (CE-Net's decoder), by torch prefix
_RESEARCH_TRANSPOSED = (r"(^|\.)deconv2$", r"(^|\.)finaldeconv1$")
# torch key -> the port's shape of a leaf the JAX package stores flatter: the
# graph convolutions' Dense kernels are 1x1 Conv1d weights (O, I, 1), the
# GCNet LayerNorm's affine is (C, 1, 1), the gaussian kernel (1, 1, 31, 31)
_RESEARCH_SHAPES = [
    (r"(^|\.)conv_(wg|adj)\.weight$", lambda shape: shape + (1,)),
    (r"channel_(add|mul)_conv\.1\.(weight|bias)$", lambda shape: shape + (1, 1)),
    (r"(^|\.)gaussian_kernel$", lambda shape: (1, 1) + shape),
]
# MODEL.WEIGHTS (ckpt/pretrained.py): a backbone's published ``.pth`` laid
# over a fresh model.  The port's parts keep the reference's keys, so a
# file key lands at ``prefix + key`` in its part, after the renames; a
# rename to None marks a key that has no home.  Keys holding any of ``skip``
# are dropped, as by the JAX ``load_pretrained_backbone``, beside
# PRETRAINED_SKIP.  Per (family, backbone kind): (part, prefix, skip, renames).
PRETRAINED_SKIP = ("num_batches_tracked", "fc.", "_fc.")
PRETRAINED_LAYOUTS = {
    # torchvision ResNet, under the feature extractor's ``backbone``
    ("deeplab", "resnet"): ("feature_extractor", "backbone.", (), ()),
    # torchvision VGG16: ``features`` as in the port; its classifier dropped
    ("deeplab", "vgg16"): ("feature_extractor", "", ("classifier.",), ()),
    # hardnet68.pth: ``base.N``; base.19 is its ImageNet classifier
    ("gald", "hardnet68"): ("encoder", "hardnet.", ("base.19",), ()),
    # Res2Net50-v1b: the deep stem ``conv1.0-6`` and the shortcut
    # ``downsample.1`` (conv), ``downsample.2`` (BN) after its pool
    ("pranet", "res2net50"): ("model", "resnet.", (), ()),
    # the same layout read into the CRANet ResNet, whose shortcut is
    # torchvision's: the conv at 0, the BN at 1, and no pool
    ("pranet", "resnet50"): ("model", "resnet.", (), (
        (r"\.downsample\.0\.", None),
        (r"\.downsample\.1\.", ".downsample.0."),
        (r"\.downsample\.2\.", ".downsample.1."))),
    # efficientnet-pytorch: ``_conv_stem``, ``_blocks.N._depthwise_conv``
    ("attn", "efficientnet"): ("encoder", "encoder.", (), ()),
    ("attnwrap", "efficientnet"): ("model", "encoder.encoder.", (), ()),
}
_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 "gamma": "gamma", "gaussian_kernel": "gaussian_kernel"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}
_FROZEN_LEAVES = {"weight": "weight", "bias": "bias", "mean": "running_mean",
                  "var": "running_var"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_prefix(scope: Tuple[str, ...], rules) -> str:
    out = "/".join(scope)
    for pat, rep in rules:
        out = re.sub(pat, rep, out)
    return out


# torch module name of a conv -> its flax scope path: the inverse of the rule
# tables above for the names of convolutions (the quantization keys of
# serve/quant.py are the JAX package's flax scopes).  ``conv_scopes``
# checks every result by mapping it forward again.
_INDEX = r"\.(\d+)(?=\.|$)"
_ENCODER_SCOPES = [(_INDEX, r"_\1"), (r"\.", "/")]
_DECODER_SCOPES = [
    (r"^conva\.0$", "conva_conv"),
    (r"dconv(\d)\.0$", r"dconv\1_conv"),
    # fam*.conv0-conv2 are the convs of the conv+BN pairs b0-b2; conv3 is a
    # conv of its own
    (r"^fam(\d+)\.conv([0-2])$", r"fam\1/b\2/conv"),
    (r"\.", "/"),
]
_ATTN_ENCODER_SCOPES = [
    (r"^encoder\.", ""),
    (r"^_blocks\.(\d+)\._", r"blocks_\1/"),
    (r"^_", ""),
    (r"\.", "/"),
]
_ATTN_DECODER_SCOPES = [
    (r"^decode_(\d)\.0$", r"decode_\1/conv0"),
    (r"^decode_(\d)\.3$", r"decode_\1/conv1"),
    (r"^out_(\d)\.0$", r"out_\1"),
    (r"\.", "/"),
]
_RESNET_BACKBONE_SCOPES = [
    (r"layer(\d+)\.(\d+)", r"layer\1_\2"),
    (r"downsample\.0$", "downsample_conv"),
    (r"\.", "/"),
]
_ASPP_CLASSIFIER_SCOPES = [(r"^conv2d_list\.(\d+)$", r"conv2d_\1"), (r"\.", "/")]
_VGG16_SCOPES = [
    (r"^features\.(\d+)$", lambda m: f"conv{_VGG16_CONV_IDX.index(int(m.group(1)))}"),
    (r"\.", "/"),
]
_PRANET_HEAD_SCOPES = [(r"branch(\d)\.(\d)", r"branch\1_\2"), (r"\.", "/")]
_PRANET_SCOPES = [
    (r"^resnet\.conv1\.0$", "resnet.stem_conv0"),
    (r"^resnet\.conv1\.3$", "resnet.stem_conv1"),
    (r"^resnet\.conv1\.6$", "resnet.stem_conv2"),
    (r"layer(\d+)\.(\d+)", r"layer\1_\2"),
    (r"convs\.(\d+)$", r"convs_\1"),
    (r"downsample\.1$", "downsample_conv"),
] + _PRANET_HEAD_SCOPES
_CRANET_SCOPES = [
    (r"layer(\d+)\.(\d+)", r"layer\1_\2"),
    (r"downsample\.0$", "downsample_conv"),
] + _PRANET_HEAD_SCOPES


def _part_tables(family: str, part: str, names) -> Tuple[list, list]:
    """(flax -> torch rules, torch -> flax conv rules) of one part; ``names``
    are the part's module names, which tell the backbone apart."""
    names = set(names)
    if family == "deeplab":
        if part == "classifier":
            return _ASPP_CLASSIFIER_RULES, _ASPP_CLASSIFIER_SCOPES
        if "backbone" in names:
            return _RESNET_BACKBONE_RULES, _RESNET_BACKBONE_SCOPES
        return _VGG16_RULES, _VGG16_SCOPES
    if family == "gald":
        return ((_ENCODER_RULES, _ENCODER_SCOPES) if part == "encoder"
                else (_DECODER_RULES, _DECODER_SCOPES))
    if family == "attn":
        return ((_ATTN_ENCODER_RULES, _ATTN_ENCODER_SCOPES) if part == "encoder"
                else (_ATTN_DECODER_RULES, _ATTN_DECODER_SCOPES))
    if family == "pranet":
        return ((_PRANET_RULES, _PRANET_SCOPES) if "resnet.conv1.0" in names
                else (_CRANET_RULES, _CRANET_SCOPES))
    raise NotImplementedError(f"{family}: no weight bridge for part {part!r}")


def conv_scopes(family: str, part: str, names, convs) -> Dict[str, str]:
    """``{torch module name: flax scope path}`` for the convs ``convs`` of one
    part whose module names are ``names`` (they tell the backbone apart).
    The scope is the JAX package's ``module_path`` of the same conv: the path,
    inside its part, to which the bridge maps its ``weight``.  attnwrap's
    ``model`` part holds the attn encoder and decoder under ``encoder.`` and
    ``decoder.`` here and ``encoder/`` and ``decoder/`` there.  Each scope is
    mapped forward through the part's rules again; a name that does not come
    back raises."""
    names, convs = list(names), list(convs)
    if family == "attnwrap":
        out = {}
        for sub in ("encoder", "decoder"):
            inner = lambda group: [n[len(sub) + 1:] for n in group if n.startswith(sub + ".")]
            out.update({f"{sub}.{n}": f"{sub}/{s}" for n, s in
                        conv_scopes("attn", sub, inner(names), inner(convs)).items()})
        return out
    rules, scopes = _part_tables(family, part, names)
    out = {}
    for name in convs:
        scope = name
        for pat, rep in scopes:
            scope = re.sub(pat, rep, scope)
        back = _torch_prefix((scope,), rules)
        if back != name:
            raise ValueError(f"{family} {part}: conv {name!r} maps to scope {scope!r}, "
                             f"which the bridge maps to {back!r}")
        out[name] = scope
    return out


def _key(prefix: str, leaf: str) -> str:
    return f"{prefix}.{leaf}" if prefix else leaf


def _state_dict_from_flax(variables: Mapping, rules,
                          transposed_conv_paths: Tuple[str, ...] = (), shapes=()
                          ) -> Dict[str, torch.Tensor]:
    """``shapes``: (torch key pattern, f(shape) -> the port's shape) for the
    leaves the port holds with more (singleton) axes."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables["params"]):
        arr = np.asarray(value, dtype=np.float32)
        prefix = _torch_prefix(path[:-1], rules)
        if path[-1] == "kernel" and arr.ndim == 2:
            arr = arr.T  # Dense (I, O) -> Linear (O, I)
        elif path[-1] == "kernel" and arr.ndim == 5:
            arr = np.transpose(arr, (4, 3, 0, 1, 2))  # DHWIO -> OIDHW
        elif path[-1] == "kernel":
            if any(re.search(p, prefix) for p in transposed_conv_paths):
                # flipped (kh, kw, I, O) -> (I, O, kh, kw), flipped back
                arr = np.transpose(arr, (2, 3, 0, 1))[:, :, ::-1, ::-1]
            else:
                arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        key = _key(prefix, _PARAM_LEAVES[path[-1]])
        for pat, shape in shapes:
            if re.search(pat, key):
                arr = arr.reshape(shape(arr.shape))
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    for path, value in _flatten(variables.get("batch_stats", {})):
        prefix = _torch_prefix(path[:-1], rules)
        arr = np.asarray(value, dtype=np.float32)
        sd[_key(prefix, _STAT_LEAVES[path[-1]])] = torch.from_numpy(arr.copy())
        sd[_key(prefix, "num_batches_tracked")] = torch.tensor(0, dtype=torch.long)
    for path, value in _flatten(variables.get("frozen", {})):
        prefix = _torch_prefix(path[:-1], rules)
        arr = np.asarray(value, dtype=np.float32)
        sd[_key(prefix, _FROZEN_LEAVES[path[-1]])] = torch.from_numpy(arr.copy())
    return sd


def _feature_extractor_rules(variables: Mapping[str, Any]):
    """A ResNet feature extractor holds its scopes under ``backbone``; VGG16's
    are its convs."""
    return (_RESNET_BACKBONE_RULES if "backbone" in variables["params"]
            else _VGG16_RULES)


def deeplab_state_dicts_from_flax(variables: Mapping[str, Any]) -> Dict[str, Dict]:
    """JAX deeplab variables ``{"feature_extractor": ..., "classifier": ...}``
    (ResNet backbone with BatchNorm or FrozenBN, or VGG16) -> torch state dicts."""
    fea = variables["feature_extractor"]
    return {"feature_extractor": _state_dict_from_flax(fea, _feature_extractor_rules(fea)),
            "classifier": _state_dict_from_flax(variables["classifier"],
                                                _ASPP_CLASSIFIER_RULES)}


def gald_state_dicts_from_flax(variables: Mapping[str, Any]) -> Dict[str, Dict]:
    """JAX GALD variables ``{"encoder": ..., "decoder": ...}`` -> torch state dicts."""
    return {"encoder": _state_dict_from_flax(variables["encoder"], _ENCODER_RULES),
            "decoder": _state_dict_from_flax(variables["decoder"], _DECODER_RULES)}


def attn_state_dicts_from_flax(variables: Mapping[str, Any]) -> Dict[str, Dict]:
    """JAX attn variables ``{"encoder": ..., "decoder": ...}`` -> torch state dicts."""
    return {"encoder": _state_dict_from_flax(variables["encoder"], _ATTN_ENCODER_RULES),
            "decoder": _state_dict_from_flax(variables["decoder"], _ATTN_DECODER_RULES,
                                             _ATTN_DECODER_TRANSPOSED)}


def attnwrap_state_dicts_from_flax(variables: Mapping[str, Any]) -> Dict[str, Dict]:
    """JAX attnwrap variables ``{"model": ...}`` -> ``{"model": state dict}``."""
    parts = attn_state_dicts_from_flax(_split_scopes(variables["model"]))
    return {"model": {f"{part}.{key}": value for part, sd in parts.items()
                      for key, value in sd.items()}}


def _pranet_rules(variables: Mapping[str, Any]):
    """Res2Net50-v1b has a deep stem (``stem_conv0``); the CRANet ResNet has not."""
    return (_PRANET_RULES if "stem_conv0" in variables["params"]["resnet"]
            else _CRANET_RULES)


def pranet_state_dicts_from_flax(variables: Mapping[str, Any]) -> Dict[str, Dict]:
    """JAX pranet variables ``{"model": ...}`` (Res2Net50-v1b or a ResNet
    backbone) -> ``{"model": state dict}``."""
    model = variables["model"]
    return {"model": _state_dict_from_flax(model, _pranet_rules(model))}


def _split_scopes(variables: Mapping[str, Any]) -> Dict[str, Dict]:
    """``{collection: {"encoder": t, "decoder": t}}`` ->
    ``{"encoder": {collection: t}, "decoder": {collection: t}}``."""
    return {part: {c: tree[part] for c, tree in variables.items() if part in tree}
            for part in ("encoder", "decoder")}


def _flax_from_state_dict(sd: Mapping, template: Mapping, rules,
                          transposed_conv_paths: Tuple[str, ...] = ()) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for collection, leaves in (("params", _PARAM_LEAVES), ("batch_stats", _STAT_LEAVES),
                               ("frozen", _FROZEN_LEAVES)):
        leaf_shapes = {p: np.shape(v) for p, v in _flatten(template.get(collection, {}))}
        paths = list(leaf_shapes)
        keys = {p: _key(_torch_prefix(p[:-1], rules), leaves[p[-1]]) for p in paths}
        present = [p for p in paths if keys[p] in sd]
        if not present:
            continue
        if len(present) != len(paths):
            missing = [keys[p] for p in paths if keys[p] not in sd]
            raise KeyError(f"{collection}: {len(missing)} keys missing, e.g. {missing[:5]}")
        tree: Dict[str, Any] = {}
        for path in paths:
            value = sd[keys[path]]
            if isinstance(value, torch.Tensor):
                value = value.detach().cpu().numpy()
            arr = np.asarray(value, dtype=np.float32)
            if path[-1] == "kernel" and len(leaf_shapes[path]) == 2:
                arr = arr.reshape(arr.shape[:2]).T  # Linear (O, I) or Conv1d (O, I, 1)
            elif path[-1] == "kernel" and arr.ndim == 5:
                arr = np.transpose(arr, (2, 3, 4, 1, 0))  # OIDHW -> DHWIO
            elif path[-1] == "kernel":
                prefix = _torch_prefix(path[:-1], rules)
                if any(re.search(p, prefix) for p in transposed_conv_paths):
                    # (I, O, kh, kw), flipped back -> flipped (kh, kw, I, O)
                    arr = np.transpose(arr[:, :, ::-1, ::-1], (2, 3, 0, 1))
                else:
                    arr = np.transpose(arr, (2, 3, 1, 0))  # OIHW -> HWIO
            node = tree
            for name in path[:-1]:
                node = node.setdefault(name, {})
            node[path[-1]] = np.ascontiguousarray(arr.reshape(leaf_shapes[path]))
        out[collection] = tree
    return out


def gald_flax_from_state_dicts(tensors: Mapping[str, Mapping],
                               template: Mapping[str, Any]) -> Dict[str, Dict]:
    """The inverse of ``gald_state_dicts_from_flax``.

    ``tensors`` is ``{"encoder": {torch key: array}, "decoder": {...}}``: whole
    ``state_dict``s, or gradients by parameter name.  ``template`` is a JAX
    GALD variables tree, read for its paths only.  Returns, per part, the
    collections (``params``, ``batch_stats``) whose keys ``tensors`` holds, as
    nested dicts of numpy arrays; a collection held in part raises.
    """
    return {"encoder": _flax_from_state_dict(tensors["encoder"], template["encoder"],
                                             _ENCODER_RULES),
            "decoder": _flax_from_state_dict(tensors["decoder"], template["decoder"],
                                             _DECODER_RULES)}


def deeplab_flax_from_state_dicts(tensors: Mapping[str, Mapping],
                                  template: Mapping[str, Any]) -> Dict[str, Dict]:
    """The inverse of ``deeplab_state_dicts_from_flax``, as
    ``gald_flax_from_state_dicts`` is for GALD; the collections are
    ``params``, ``batch_stats`` and ``frozen``."""
    fea = template["feature_extractor"]
    return {"feature_extractor": _flax_from_state_dict(
                tensors["feature_extractor"], fea, _feature_extractor_rules(fea)),
            "classifier": _flax_from_state_dict(tensors["classifier"],
                                                template["classifier"],
                                                _ASPP_CLASSIFIER_RULES)}


def disc_state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``PixelDiscriminator`` or ``FCDiscriminator`` variables -> the
    reference's torch state dict (``D.0``, ``D.2``, ``cls1``, ``cls2``)."""
    return _state_dict_from_flax(variables, _DISC_RULES)


def disc_flax_from_state_dict(sd: Mapping[str, Any],
                              template: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of ``disc_state_dict_from_flax``; ``template`` is a JAX
    discriminator variables tree, read for its paths only."""
    return _flax_from_state_dict(sd, template, _DISC_RULES)


def attn_flax_from_state_dicts(tensors: Mapping[str, Mapping],
                               template: Mapping[str, Any]) -> Dict[str, Dict]:
    """The inverse of ``attn_state_dicts_from_flax``, as
    ``gald_flax_from_state_dicts`` is for GALD (transposed-conv kernels
    flipped and transposed back)."""
    return {"encoder": _flax_from_state_dict(tensors["encoder"], template["encoder"],
                                             _ATTN_ENCODER_RULES),
            "decoder": _flax_from_state_dict(tensors["decoder"], template["decoder"],
                                             _ATTN_DECODER_RULES, _ATTN_DECODER_TRANSPOSED)}


def attnwrap_flax_from_state_dicts(tensors: Mapping[str, Mapping],
                                   template: Mapping[str, Any]) -> Dict[str, Dict]:
    """The inverse of ``attnwrap_state_dicts_from_flax``: ``{"model":
    {torch key: array}}`` -> ``{"model": {collection: {"encoder": ...,
    "decoder": ...}}}``."""
    parts = {part: {k[len(part) + 1:]: v for k, v in tensors["model"].items()
                    if k.startswith(part + ".")} for part in ("encoder", "decoder")}
    trees = attn_flax_from_state_dicts(parts, _split_scopes(template["model"]))
    model: Dict[str, Dict] = {}
    for part, tree in trees.items():
        for collection, value in tree.items():
            model.setdefault(collection, {})[part] = value
    return {"model": model}


def pranet_flax_from_state_dicts(tensors: Mapping[str, Mapping],
                                 template: Mapping[str, Any]) -> Dict[str, Dict]:
    """The inverse of ``pranet_state_dicts_from_flax``, as
    ``gald_flax_from_state_dicts`` is for GALD."""
    model = template["model"]
    return {"model": _flax_from_state_dict(tensors["model"], model, _pranet_rules(model))}


def research_state_dict_from_flax(name: str, variables: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """JAX variables of one research-zoo module, by its class name (a key of
    ``RESEARCH_RULES``: models/contextagg.py, zoo.py, seg_nets.py, the GALD
    blocks of gcpa.py and ``Res2Net`` with its GCNet blocks) -> the port's
    state dict; Dense kernels become Linear or 1x1 Conv1d weights."""
    return _state_dict_from_flax(variables, RESEARCH_RULES[name], _RESEARCH_TRANSPOSED,
                                 shapes=_RESEARCH_SHAPES)


def research_flax_from_state_dict(name: str, sd: Mapping[str, Any],
                                  template: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of ``research_state_dict_from_flax``; ``template`` is the
    JAX module's variables tree, read for its paths and leaf shapes only."""
    return _flax_from_state_dict(sd, template, RESEARCH_RULES[name], _RESEARCH_TRANSPOSED)


def _strip_prefix(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    if sd and all(k.startswith(prefix) for k in sd):
        return {k[len(prefix):]: v for k, v in sd.items()}
    return sd


def load_reference_checkpoint(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """A reference-layout ``.pth`` -> ``{part: state_dict}`` on the CPU.

    A part is an entry that maps names to tensors; a training checkpoint's
    optimizer states, epoch and step are left out."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an Orbax checkpoint of the JAX package); "
            f"the port reads reference-layout .pth files only so far")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: expected a dict of per-part state dicts")
    return {part: _strip_prefix(dict(sd), "module.") for part, sd in ckpt.items()
            if isinstance(sd, Mapping) and sd
            and all(isinstance(v, torch.Tensor) for v in sd.values())}


def save_reference_checkpoint(modules: Mapping[str, nn.Module], path: str) -> None:
    torch.save({name: {k: v.detach().cpu() for k, v in m.state_dict().items()}
                for name, m in modules.items()}, path)


def load_part(module: nn.Module, sd: Mapping[str, torch.Tensor], part: str) -> None:
    """Loads one part, raising on any parameter or statistic the file lacks.

    ``num_batches_tracked`` may be absent (eval mode never reads it), and keys
    the module has no place for (a backbone's classifier head) are ignored.
    """
    result = module.load_state_dict(dict(sd), strict=False)
    missing = [k for k in result.missing_keys if not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"checkpoint part {part!r} lacks {len(missing)} keys, "
                       f"e.g. {missing[:5]}")
