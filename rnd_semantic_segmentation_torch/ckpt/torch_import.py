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
_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 "gamma": "gamma"}
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


def _state_dict_from_flax(variables: Mapping, rules,
                          transposed_conv_paths: Tuple[str, ...] = ()
                          ) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables["params"]):
        arr = np.asarray(value, dtype=np.float32)
        prefix = _torch_prefix(path[:-1], rules)
        if path[-1] == "kernel":
            if any(re.search(p, prefix) for p in transposed_conv_paths):
                # flipped (kh, kw, I, O) -> (I, O, kh, kw), flipped back
                arr = np.transpose(arr, (2, 3, 0, 1))[:, :, ::-1, ::-1]
            else:
                arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        key = f"{prefix}.{_PARAM_LEAVES[path[-1]]}"
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    for path, value in _flatten(variables.get("batch_stats", {})):
        prefix = _torch_prefix(path[:-1], rules)
        arr = np.asarray(value, dtype=np.float32)
        sd[f"{prefix}.{_STAT_LEAVES[path[-1]]}"] = torch.from_numpy(arr.copy())
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    for path, value in _flatten(variables.get("frozen", {})):
        prefix = _torch_prefix(path[:-1], rules)
        arr = np.asarray(value, dtype=np.float32)
        sd[f"{prefix}.{_FROZEN_LEAVES[path[-1]]}"] = torch.from_numpy(arr.copy())
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
        paths = [p for p, _ in _flatten(template.get(collection, {}))]
        keys = {p: f"{_torch_prefix(p[:-1], rules)}.{leaves[p[-1]]}" for p in paths}
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
            if path[-1] == "kernel":
                prefix = _torch_prefix(path[:-1], rules)
                if any(re.search(p, prefix) for p in transposed_conv_paths):
                    # (I, O, kh, kw), flipped back -> flipped (kh, kw, I, O)
                    arr = np.transpose(arr[:, :, ::-1, ::-1], (2, 3, 0, 1))
                else:
                    arr = np.transpose(arr, (2, 3, 1, 0))  # OIHW -> HWIO
            node = tree
            for name in path[:-1]:
                node = node.setdefault(name, {})
            node[path[-1]] = np.ascontiguousarray(arr)
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
