"""GALD weights between the JAX package's variables and reference ``state_dict``s.

``gald_state_dicts_from_flax`` is the inverse of the JAX package's
``convert_state_dict`` with its GCPA encoder and decoder rule tables: flax
scope paths become the reference's torch keys, and by role

  * conv kernels go from HWIO to OIHW (depthwise ones too);
  * BN ``scale``/``bias`` become ``weight``/``bias``, and ``batch_stats``
    ``mean``/``var`` become ``running_mean``/``running_var``;
  * the criss-cross ``gamma`` keeps its shape (1,).

It takes the variables as nested dicts of arrays (numpy, or anything
``np.asarray`` reads) and imports no JAX.

``load_reference_checkpoint`` reads a reference-layout ``.pth``
(``{"encoder": sd, "decoder": sd}``); ``save_reference_checkpoint`` writes
one from the port's modules.
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
_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 "gamma": "gamma"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


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


def _state_dict_from_flax(variables: Mapping, rules) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables["params"]):
        arr = np.asarray(value, dtype=np.float32)
        if path[-1] == "kernel":
            arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        key = f"{_torch_prefix(path[:-1], rules)}.{_PARAM_LEAVES[path[-1]]}"
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    for path, value in _flatten(variables.get("batch_stats", {})):
        prefix = _torch_prefix(path[:-1], rules)
        arr = np.asarray(value, dtype=np.float32)
        sd[f"{prefix}.{_STAT_LEAVES[path[-1]]}"] = torch.from_numpy(arr.copy())
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def gald_state_dicts_from_flax(variables: Mapping[str, Any]) -> Dict[str, Dict]:
    """JAX GALD variables ``{"encoder": ..., "decoder": ...}`` -> torch state dicts."""
    return {"encoder": _state_dict_from_flax(variables["encoder"], _ENCODER_RULES),
            "decoder": _state_dict_from_flax(variables["decoder"], _DECODER_RULES)}


def _strip_prefix(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    if sd and all(k.startswith(prefix) for k in sd):
        return {k[len(prefix):]: v for k, v in sd.items()}
    return sd


def load_reference_checkpoint(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """A reference-layout ``.pth`` -> ``{part: state_dict}`` on the CPU."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an Orbax checkpoint of the JAX package); "
            f"the port reads reference-layout .pth files only so far")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: expected a dict of per-part state dicts")
    return {part: _strip_prefix(dict(sd), "module.") for part, sd in ckpt.items()
            if isinstance(sd, Mapping)}


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
