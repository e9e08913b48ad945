"""Fused MBConv segment (expand 1x1 -> affine+swish -> depthwise -> affine+swish):
one CUDA kernel and its plain version.

Counterpart of rnd_semantic_segmentation_tpu/ops/mbconv.py.  The function is
the one its ``fused_mbconv_core_jnp`` computes,

    y = swish(s1 * dwconv_k(swish(s0 * (W_exp . x) + b0)) + b1)

with a stride-1, odd-k, TF-SAME depthwise convolution, whose input counts as
zero outside the image.  ``s0, b0, s1, b1`` are BatchNorm affines folded from
running statistics, so this is the eval path; there is no gradient.

Layout is the port's NCHW (the JAX function is NHWC): x ``[B,C,H,W]``,
``w_exp [F,C]`` (``_expand_conv.weight`` without its two unit axes),
``w_dw [F,k,k]`` (``_depthwise_conv.weight`` without its unit axis), the
affines ``[F]``; the result is ``[B,F,H,W]`` in x's type.  x and ``w_exp`` are
float32 or bfloat16, ``w_dw`` and the affines float32, and everything inside
is float32.

``fused_mbconv_core`` dispatches by the device the tensors lie on.  CUDA
tensors go to ``fused_mbconv_core_cuda``, which launches the kernel in
``csrc/mbconv_fwd.cu`` or raises; CPU tensors go to
``fused_mbconv_core_plain``.  ``KERNEL_LAUNCHES`` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from . import native

SOURCE = "mbconv_fwd"
SOURCES = (SOURCE,)
KERNEL_LAUNCHES = 0

# The kernel is instantiated for these depthwise sizes (EfficientNet's).  Its
# shared memory (a 16x16 tile with halo for 48 channels) does not grow with C,
# F, H or W, so the only other limits are its flat grid and its 32-bit plane
# offsets.  It takes any pointer aligned to its element.
KERNEL_SIZES = (3, 5)
MAX_BLOCKS = 2 ** 31 - 1
TILE = 16
CHANNELS_PER_BLOCK = 48

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def fused_mbconv_applies(x_shape: Sequence[int], k: int, f: int) -> bool:
    """Shape gate of the fused path: a 4-D input and an odd depthwise size the
    kernel is built for.  No limit hangs on ``f``: the kernel cuts F into chunks."""
    del f
    return len(x_shape) == 4 and k in KERNEL_SIZES


def fused_mbconv_core_plain(x, w_exp, s0, b0, w_dw, s1, b1) -> torch.Tensor:
    """[B,C,H,W] -> [B,F,H,W] in ordinary PyTorch ops, float32 inside."""
    f, k = w_dw.shape[0], w_dw.shape[-1]
    s0, b0, s1, b1 = (a.float().view(1, -1, 1, 1) for a in (s0, b0, s1, b1))
    e = F.conv2d(x.float(), w_exp.float()[:, :, None, None])
    e = swish(e * s0 + b0)
    y = F.conv2d(e, w_dw.float()[:, None], padding=(k - 1) // 2, groups=f)
    return swish(y * s1 + b1).to(x.dtype)


def _library() -> ctypes.CDLL:
    lib = native.load(SOURCE)
    fn = lib.fused_mbconv_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def instance_info(k: int, dtype: torch.dtype) -> dict:
    """What the runtime reports for the kernel's (k, dtype) instance:
    registers a thread, local (spill) bytes, dynamic shared memory and
    resident blocks per SM.  Needs a card."""
    lib = _library()
    fn = lib.fused_mbconv_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    res = (ctypes.c_int * 4)()
    err = fn(k, _DTYPE_CODES[dtype], res)
    if err != 0:
        raise RuntimeError(f"fused_mbconv_info failed with CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), res))


def _check(x, w_exp, s0, b0, w_dw, s1, b1) -> None:
    named = (("x", x), ("w_exp", w_exp), ("s0", s0), ("b0", b0), ("w_dw", w_dw),
             ("s1", s1), ("b1", b1))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"fused_mbconv_core: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_mbconv_core: {name} must be contiguous, got shape "
                             f"{tuple(t.shape)} with strides {t.stride()}")
    if x.dtype not in _DTYPE_CODES or w_exp.dtype != x.dtype:
        raise TypeError(f"fused_mbconv_core: x is {x.dtype}, w_exp {w_exp.dtype}; the "
                        f"kernel takes both float32 or both bfloat16")
    for name, t in named[2:]:
        if t.dtype != torch.float32:
            raise TypeError(f"fused_mbconv_core: {name} is {t.dtype}; the affines and "
                            f"w_dw are float32")
    if x.dim() != 4 or w_exp.dim() != 2 or w_exp.shape[1] != x.shape[1]:
        raise ValueError(f"fused_mbconv_core: x {tuple(x.shape)} must be [B,C,H,W] and "
                         f"w_exp {tuple(w_exp.shape)} [F,C]")
    f = w_exp.shape[0]
    if w_dw.dim() != 3 or w_dw.shape[0] != f or w_dw.shape[1] != w_dw.shape[2]:
        raise ValueError(f"fused_mbconv_core: w_dw {tuple(w_dw.shape)} must be [F,k,k] "
                         f"with F = {f}")
    k = w_dw.shape[-1]
    if k not in KERNEL_SIZES:
        raise ValueError(f"fused_mbconv_core: depthwise size {k}; the kernel is built "
                         f"for {KERNEL_SIZES}")
    for name, t in named[2:4] + named[5:]:
        if t.shape != (f,):
            raise ValueError(f"fused_mbconv_core: {name} {tuple(t.shape)} must be [{f}]")


def fused_mbconv_core_cuda(x, w_exp, s0, b0, w_dw, s1, b1) -> torch.Tensor:
    """Launches the kernel on the current stream; raises on what it can't take.

    The result carries no autograd history, and the kernel has no backward: a
    call that autograd would have to record raises instead of cutting the
    graph silently."""
    global KERNEL_LAUNCHES
    args = (x, w_exp, s0, b0, w_dw, s1, b1)
    _check(*args)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv_core_cuda: tensors on {x.device}, not CUDA")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError("fused_mbconv_core: the CUDA kernel is forward-only (eval); "
                           "call it under torch.no_grad() or inference_mode(), or "
                           "use the unfused ops to train")
    b, c, h, w = x.shape
    f, k = w_dw.shape[0], w_dw.shape[-1]
    out = torch.empty((b, f, h, w), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    blocks = b * -(-h // TILE) * -(-w // TILE) * -(-f // CHANNELS_PER_BLOCK)
    if blocks > MAX_BLOCKS or h * w >= 2 ** 31:
        raise ValueError(f"fused_mbconv_core: x {tuple(x.shape)} with F = {f} needs "
                         f"{blocks} blocks; the kernel's grid holds {MAX_BLOCKS} and "
                         f"its plane offsets 2^31")
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_mbconv_fwd(x.data_ptr(), w_exp.data_ptr(), s0.data_ptr(),
                                   b0.data_ptr(), w_dw.data_ptr(), s1.data_ptr(),
                                   b1.data_ptr(), out.data_ptr(), b, c, f, h, w, k,
                                   _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_mbconv_fwd launch failed with CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return out


def fused_mbconv_core(x, w_exp, s0, b0, w_dw, s1, b1) -> torch.Tensor:
    args = (x, w_exp, s0, b0, w_dw, s1, b1)
    if all(t.device.type == "cpu" for t in args):
        return fused_mbconv_core_plain(*args)
    return fused_mbconv_core_cuda(*args)
