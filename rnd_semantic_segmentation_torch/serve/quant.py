"""Post-training int8 quantization of the eval and serving paths
(counterpart of the JAX package's serve/quant.py).

  * **Activations**: a static scale per conv from a calibration pass.
    ``calibrate_segmentor`` runs N batches through the segmentor with a
    context in ``calibrate`` mode; every ``layers.Conv2d`` records the absmax
    of its input under its key, the flax scope path of the JAX package's
    conv (``models/layers.py``: ``backbone/layer1_0/conv1``, ``conv2d_0``),
    which the build gives each conv from the weight bridge's rule tables.
    Scales are Python floats.
  * **Weights**: a symmetric scale per output channel, computed from the
    float32 weight at each call (the parameters stay float32, so checkpoints
    are untouched).
  * **Compute**, ``int8``: the quantized input and kernel as int8, their
    channels padded with zeros (to 32 up to 128 channels, to 128 above), the
    input's columns for the conv's stride, dilation and padding built from
    int8 views, and one integer matrix product ``torch._int_mm`` (s8 x s8 ->
    s32: cuBLASLt's integer tensor-core path on the card); then rescaled in
    float32 by ``sx * sw``, the bias added, and cast to the input's type.
    ``fake`` is the same quantized values through ``F.conv2d`` in float32:
    the oracle, equal to ``int8`` while a conv's sums stay below 2^24.
    ``calibrate`` records, and a ``probe`` context also records each
    quantized conv's relative error against the float conv on the same
    input (``quant_sensitivity``).
  * **Policy**: ``resolve_mode`` turns ``TEST.QUANT`` (none, int8, fake,
    auto) into a mode: ``auto`` is ``none`` above ``TEST.QUANT_MAX_AREA``
    pixels and ``int8`` below, and ``int8`` is ``fake`` on a device whose
    ``torch._int_mm`` fails its probe.  The accuracy half (argmax agreement
    against float32, and ``repair_exclusions``, which takes the worst convs
    out of the quantized set) lives in the callers, eval/tester.py and
    serve/server.py.  Another value raises ``ValueError`` (the JAX conv
    treats any other mode as ``fake``).

Hook: ``models.layers.Conv2d`` reads ``current_quant()`` at each call; enter
``quant_scope(ctx)`` around calibration and the quantized forwards.  The
scope is a ``contextvars`` variable: a new thread starts outside it.
Convs whose key matches ``QuantConfig.skip_patterns`` (the final classifier
convs by default), grouped convs, and convs with fewer than ``min_channels``
input or output channels stay float32.  EfficientNet's ``_SameConv`` (stem,
expand, depthwise, project) and the fused MBConv kernel are not hooked, as
in the JAX package.
"""

from __future__ import annotations

import contextlib
import contextvars
import fnmatch
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MODES = ("none", "int8", "fake", "auto")

_QCTX: contextvars.ContextVar = contextvars.ContextVar("segtorch_quant_ctx", default=None)


@dataclass
class QuantConfig:
    mode: str = "int8"                       # int8 | fake
    calib_batches: int = 2
    # the final logit convs stay float32 (classifier heads, score layers)
    skip_patterns: Tuple[str, ...] = (
        "*classifier*", "*conv_out*", "*score*", "*cls*", "*out_0*",
    )
    # percentile of the per-batch absmax taken as the activation scale; 1.0 = max
    calib_percentile: float = 1.0
    # grouped and depthwise convs stay float32 unless this is set
    quantize_grouped: bool = False
    # only convs with at least this many input and output channels are quantized
    min_channels: int = 64
    # pad channels before the int8 product: to 32 up to 128 channels, to 128
    # above (the JAX package's rule).  Off, they still pad to a multiple of 8,
    # which torch._int_mm needs on the card.
    pad_channels: bool = True


def _pad_to(c: int, pad_channels: bool) -> int:
    """The zero channels added to ``c`` before the int8 product."""
    if not pad_channels:
        return (-c) % 8
    return (-c) % (32 if c <= 128 else 128)


# cuBLASLt's int8 product rejects 16 rows or fewer, and on the H100 (torch
# 2.11, CUDA 12.8) most products whose rows are not a multiple of 32: the
# columns of a 1x1 conv on a pooled 1x1 map have one row per image.  Rows are
# padded with zeros to a multiple of ROW_TILE, and the extra rows dropped.
ROW_TILE = 32


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M,K] int8 x [K,N] int8 -> [M,N] int32 through ``torch._int_mm``, the
    rows padded to a multiple of ROW_TILE (K and N must be multiples of 8)."""
    m = a.shape[0]
    pad = (-m) % ROW_TILE
    if pad:
        a = torch.cat([a, a.new_zeros((pad, a.shape[1]))])
    return torch._int_mm(a, b)[:m]


def int8_conv2d(x8: torch.Tensor, k8: torch.Tensor, stride=(1, 1), padding=(0, 0),
                dilation=(1, 1), groups: int = 1, pad_channels: bool = True) -> torch.Tensor:
    """The integer conv: x8 [B,Ci,H,W] int8, k8 [Co,Ci/groups,kh,kw] int8 ->
    [B,Co,Ho,Wo] int32, exact (a sum of at most 2^17 products of 127 x 127
    fits int32).  Each group's columns [B*Ho*Wo, kh*kw*Ci'] (Ci' its padded
    channels) are built from an int8 NHWC copy of the padded input through
    ``as_strided``, and multiplied by the kernel laid out [kh*kw*Ci', Co']."""
    b, ci, h, w = x8.shape
    co, cig, kh, kw = k8.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    hp, wp = h + 2 * ph, w + 2 * pw
    ho, wo = (hp - dh * (kh - 1) - 1) // sh + 1, (wp - dw * (kw - 1) - 1) // sw + 1
    cog = co // groups
    pad_i, pad_o = _pad_to(cig, pad_channels), _pad_to(cog, pad_channels)
    cp = cig + pad_i
    outs = []
    for g in range(groups):
        # spatial and channel padding and the NHWC layout in one copy
        xn = x8.new_zeros((b, hp, wp, cp))
        xn[:, ph:ph + h, pw:pw + w, :cig] = x8[:, g * cig:(g + 1) * cig].permute(0, 2, 3, 1)
        cols = xn.as_strided((b, ho, wo, kh, kw, cp),
                             (hp * wp * cp, sh * wp * cp, sw * cp, dh * wp * cp, dw * cp, 1))
        cols = cols.reshape(b * ho * wo, kh * kw * cp)
        kg = k8[g * cog:(g + 1) * cog].permute(2, 3, 1, 0)          # OIHW -> HWIO
        km = k8.new_zeros((kh, kw, cp, cog + pad_o))
        km[:, :, :cig, :cog] = kg
        y = int8_matmul(cols, km.reshape(kh * kw * cp, cog + pad_o))[:, :cog]
        outs.append(y)
    y = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return y.reshape(b, ho, wo, co).permute(0, 3, 1, 2).contiguous()


@dataclass
class QuantContext:
    """Calibration state and scales, shared by every Conv2d call site."""

    config: QuantConfig = field(default_factory=QuantConfig)
    mode: str = "int8"                        # calibrate | int8 | fake
    act_scales: Dict[str, float] = field(default_factory=dict)
    observed: Dict[str, List[float]] = field(default_factory=dict)
    # per-conv input absmax of the current forward, as 0-dim tensors
    traced: Dict[str, List[torch.Tensor]] = field(default_factory=dict)
    # calibrated convs taken out by the sensitivity repair (repair_exclusions)
    exclude: set = field(default_factory=set)
    # probe mode: each quantized conv also records its relative error against
    # the float conv on the same input
    probe: bool = False
    err_traced: Dict[str, torch.Tensor] = field(default_factory=dict)

    # -- key filtering -------------------------------------------------------
    def _skipped(self, path: str) -> bool:
        if path in self.exclude:
            return True
        return any(fnmatch.fnmatch(path, p) for p in self.config.skip_patterns)

    # -- calibration ---------------------------------------------------------
    def record(self, path: str, x: torch.Tensor) -> None:
        if self._skipped(path):
            return
        self.traced.setdefault(path, []).append(x.detach().float().abs().amax())

    def traced_maxes(self) -> Dict[str, torch.Tensor]:
        """One value per key: a conv called twice, or two convs that share a
        key, take the larger absmax."""
        return {p: v[0] if len(v) == 1 else torch.stack(v).amax()
                for p, v in self.traced.items()}

    def absorb(self, maxes: Dict[str, float]) -> None:
        for path, v in maxes.items():
            self.observed.setdefault(path, []).append(float(v))

    def finalize_scales(self) -> Dict[str, float]:
        if not self.observed and self.traced:
            self.absorb(_to_floats(self.traced_maxes()))
        pct = self.config.calib_percentile
        for path, maxes in self.observed.items():
            v = (max(maxes) if pct >= 1.0
                 else float(np.quantile(np.asarray(maxes), pct)))
            # a conv whose input was zero throughout (a dead branch) stays float32
            if v > 0.0:
                self.act_scales[path] = v / 127.0
        return self.act_scales

    # -- the Conv2d hook -----------------------------------------------------
    def conv2d(self, path: str, x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], stride, padding, dilation,
               groups: int) -> Optional[torch.Tensor]:
        """The quantized conv, or None where the conv takes its float path
        (calibration, a gate, a skipped or excluded key, no scale)."""
        if groups > 1 and not self.config.quantize_grouped:
            return None
        co, ci = weight.shape[0], weight.shape[1]
        if min(ci, co) < self.config.min_channels:
            return None
        if self.mode == "calibrate":
            self.record(path, x)
            return None
        if self._skipped(path) or path not in self.act_scales:
            return None
        if self.mode not in ("int8", "fake"):
            raise ValueError(f"QuantContext.mode {self.mode!r}: int8, fake or calibrate")
        sx = self.act_scales[path]
        kw = dict(stride=stride, padding=padding, dilation=dilation, groups=groups)

        xf = x.float()
        kf = weight.float()
        # per-output-channel symmetric weight scale, [Co]
        sw = (kf.abs().amax(dim=(1, 2, 3)) / 127.0).clamp_min(1e-12)
        # a 0-dim tensor on x's device: true division, as the JAX package's
        # (the card divides by a host scalar as a multiply by its reciprocal)
        xq = torch.clamp(torch.round(xf / xf.new_full((), sx)), -127, 127)
        kq = torch.clamp(torch.round(kf / sw.view(-1, 1, 1, 1)), -127, 127)
        if self.mode == "int8":
            y = int8_conv2d(xq.to(torch.int8), kq.to(torch.int8), stride, padding, dilation,
                            groups, self.config.pad_channels).float()
        else:  # fake: the same integers through the float conv
            y = F.conv2d(xq, kq, **kw)
        y = y * (sx * sw).view(1, -1, 1, 1)
        if bias is not None:
            y = y + bias.float().view(1, -1, 1, 1)
        if self.probe:
            yf = F.conv2d(xf, kf, None if bias is None else bias.float(), **kw)
            self.err_traced[path] = (torch.linalg.vector_norm(y - yf)
                                     / (torch.linalg.vector_norm(yf) + 1e-12))
        return y.to(x.dtype)


def _to_floats(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """0-dim tensors -> floats with one device-to-host copy."""
    if not tensors:
        return {}
    values = torch.stack([t.float() for t in tensors.values()]).tolist()
    return dict(zip(tensors, values))


def current_quant() -> Optional[QuantContext]:
    return _QCTX.get()


@contextlib.contextmanager
def quant_scope(ctx: Optional[QuantContext]):
    token = _QCTX.set(ctx)
    try:
        yield ctx
    finally:
        _QCTX.reset(token)


def module_path(module) -> str:
    """A conv's quantization key: the flax scope path the model build gave
    it (``models/build.py``, from the weight bridge's rule tables)."""
    key = getattr(module, "quant_key", None)
    if key is None:
        raise KeyError(f"{type(module).__name__} has no quantization key: build the model "
                       f"with models.build.build_segmentor, or give its convs keys with "
                       f"ckpt.torch_import.assign_quant_keys")
    return key


_INT8_SUPPORT: Dict[str, bool] = {}


def supports_int8_conv(device="cuda") -> bool:
    """Probes (once per device type) whether ``torch._int_mm`` multiplies
    int8 matrices on ``device``."""
    kind = torch.device(device).type
    if kind not in _INT8_SUPPORT:
        try:
            a = torch.ones((ROW_TILE, 32), dtype=torch.int8, device=device)
            _INT8_SUPPORT[kind] = int(torch._int_mm(a, a.t().contiguous())[0, 0]) == 32
        except (RuntimeError, NotImplementedError):
            _INT8_SUPPORT[kind] = False
    return _INT8_SUPPORT[kind]


def resolve_mode(mode: str, area: Optional[int] = None, max_area: int = 0,
                 device="cuda") -> str:
    """``TEST.QUANT`` against the geometry and the device.

    ``auto`` is ``none`` when ``area`` exceeds ``max_area`` (0 disables the
    gate) and ``int8`` otherwise.  The gate's default, TEST.QUANT_MAX_AREA
    1048576, is the JAX package's value of the config tree, chosen there
    for a TPU; it is not a measurement of this card.  ``int8`` becomes
    ``fake`` where ``supports_int8_conv`` fails.  The accuracy half of
    ``auto`` needs a calibrated context and lives in the callers."""
    if mode not in MODES:
        raise ValueError(f"TEST.QUANT {mode!r}: one of {', '.join(MODES)}")
    if mode == "auto":
        if max_area and area is not None and area > max_area:
            return "none"
        mode = "int8"
    if mode == "int8" and not supports_int8_conv(device):
        return "fake"
    return mode


def _argmax_under(ctx, probs_fn, x, label_size) -> torch.Tensor:
    """The argmax of ``probs_fn(x, label_size)`` ([B,C,H,W]) under
    ``quant_scope(ctx)``.  PyTorch runs each call anew, so no cache can hand
    one scope the other's result (the JAX package traces a fresh function
    here for that reason)."""
    with quant_scope(ctx):
        return probs_fn(x, label_size).argmax(dim=1)


def argmax_agreement(probs_fn, x, label_size, ctx: QuantContext) -> float:
    """The share of pixels whose argmax is the same under ``ctx`` as in
    float32: the accuracy half of the ``auto`` policy."""
    ref = _argmax_under(None, probs_fn, x, label_size)
    quant = _argmax_under(ctx, probs_fn, x, label_size)
    return float((ref == quant).float().mean())


def quant_sensitivity(probs_fn, x, label_size, ctx: QuantContext) -> Dict[str, float]:
    """Each quantized conv's relative error against the float conv on the
    same (quantized upstream) input, from one probe forward: the ranking of
    ``repair_exclusions``."""
    pctx = QuantContext(config=ctx.config, mode=ctx.mode, act_scales=dict(ctx.act_scales),
                        exclude=set(ctx.exclude), probe=True)
    with quant_scope(pctx):
        probs_fn(x, label_size)
    return _to_floats(pctx.err_traced)


def repair_exclusions(probs_fn, x, label_size, ctx: QuantContext, floor: float,
                      max_exclude: int = 6, logger=None) -> Tuple[float, List[str]]:
    """Greedy repair: exclude the conv of largest local error, one a round,
    until the argmax agreement on ``x`` reaches ``floor`` or ``max_exclude``
    convs are out; ``ctx.exclude`` is updated in place.  Stops after two
    rounds in a row without a gain: one exclusion can be flat while a
    downstream conv whose scale the same outlier spoiled still hides the
    jump.  Returns (agreement, excluded keys in order)."""
    ref = _argmax_under(None, probs_fn, x, label_size)

    def _agree() -> float:
        return float((ref == _argmax_under(ctx, probs_fn, x, label_size)).float().mean())

    agreement = _agree()
    excluded: List[str] = []
    best = agreement
    stagnant = 0
    while agreement < floor and len(excluded) < max_exclude:
        # ranked anew each round: once an offender is out, the next one's
        # error shows only on the repaired forward
        errs = quant_sensitivity(probs_fn, x, label_size, ctx)
        if not errs:
            break
        worst = max(errs, key=errs.get)
        ctx.exclude.add(worst)
        excluded.append(worst)
        agreement = _agree()
        if logger is not None:
            logger.info(f"quant repair: excluded {worst} (local err {errs[worst]:.4f}) "
                        f"-> agreement {agreement:.4f}")
        if agreement > best + 1e-3:
            best = agreement
            stagnant = 0
        else:
            stagnant += 1
            if stagnant >= 2:
                if logger is not None:
                    logger.info(f"quant repair: no gain for 2 rounds, stopping "
                                f"(agreement {agreement:.4f} < floor {floor})")
                break
    return agreement, excluded


def calibrate_segmentor(segmentor, batches, config: Optional[QuantConfig] = None,
                        label_size: Optional[Tuple[int, int]] = None) -> QuantContext:
    """Activation ranges of every hooked conv over the first
    ``config.calib_batches`` of ``batches``, in eval mode without autograd;
    returns a context ready to serve in ``config.mode``.

    A batch is a loader dict whose ``image`` is [B,H,W,3] (numpy or a
    tensor), or a model input [B,3,H,W] tensor; it goes to the segmentor's
    device."""
    cfg = config or QuantConfig()
    ctx = QuantContext(config=cfg, mode="calibrate")
    device = next(segmentor.parameters()).device
    for i, batch in enumerate(batches):
        if i >= cfg.calib_batches:
            break
        if isinstance(batch, dict):
            x = torch.as_tensor(batch["image"]).to(device).permute(0, 3, 1, 2).contiguous()
        else:
            x = batch.to(device)
        ls = label_size or tuple(x.shape[-2:])
        run = QuantContext(config=cfg, mode="calibrate")
        with torch.inference_mode(), quant_scope(run):
            segmentor(x, label_size=ls, train=False)
        ctx.absorb(_to_floats(run.traced_maxes()))
    ctx.finalize_scales()
    ctx.mode = cfg.mode
    return ctx


def quant_error_report(ctx: QuantContext) -> Dict[str, float]:
    """Summary of the calibration outcome, for logs."""
    return {
        "quantized_convs": len(ctx.act_scales),
        "mode": ctx.mode,
        "max_act_scale": max(ctx.act_scales.values()) if ctx.act_scales else 0.0,
        "min_act_scale": min(ctx.act_scales.values()) if ctx.act_scales else 0.0,
    }
