"""Criss-cross (axial H+W) attention core: a CUDA kernel and its plain version.

Counterpart of rnd_semantic_segmentation_tpu/ops/ccattn.py.  The function is
the one its ``cc_attention_core_jnp`` computes: energies down the column (the
query's own row masked to -inf) and along the row, one softmax over the joint
H+W axis, and the two aggregations summed.  Layout is the JAX package's NHWC:
q, k ``[B,H,W,Cq]``, v ``[B,H,W,C]``.

``cc_attention_core`` dispatches by the device the tensors lie on: CUDA
tensors go to the kernel in ``csrc/ccattn_fwd.cu`` (or raise), CPU tensors to
``cc_attention_core_plain``.  ``KERNEL_LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import native

SOURCE = "ccattn_fwd"
KERNEL_LAUNCHES = 0

# The kernel keeps H+W energies and the Cq query values in dynamic shared
# memory, under the 48 KB a block gets without opting in to more.
MAX_H_PLUS_W_PLUS_CQ = 12000

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def cc_attention_core_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """[B,H,W,Cq] x2, [B,H,W,C] -> [B,H,W,C]; einsum form, f32 inside."""
    h = q.shape[1]
    qf, kf, vf = (t.float() for t in (q, k, v))
    energy_h = torch.einsum("bhwc,bkwc->bhwk", qf, kf)
    diag = torch.eye(h, dtype=torch.bool, device=q.device)[None, :, None, :]
    energy_h = energy_h.masked_fill(diag, float("-inf"))
    energy_w = torch.einsum("bhwc,bhkc->bhwk", qf, kf)
    att = torch.softmax(torch.cat([energy_h, energy_w], dim=-1), dim=-1)
    att_h, att_w = att[..., :h], att[..., h:]
    out_h = torch.einsum("bhwk,bkwc->bhwc", att_h, vf)
    out_w = torch.einsum("bhwk,bhkc->bhwc", att_w, vf)
    return (out_h + out_w).to(v.dtype)


def _library() -> ctypes.CDLL:
    lib = native.load(SOURCE)
    fn = lib.cc_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"cc_attention_core: {name} on {t.device}, q on {q.device}")
        if t.dtype not in _DTYPE_CODES or t.dtype != q.dtype:
            raise TypeError(f"cc_attention_core: {name} is {t.dtype}; the kernel takes "
                            f"q, k, v all float32 or all bfloat16")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"cc_attention_core: {name} must be a contiguous "
                             f"[B,H,W,C] tensor, got shape {tuple(t.shape)}")
    if k.shape != q.shape or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"cc_attention_core: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    b, h, w, cq = q.shape
    if h + w + cq > MAX_H_PLUS_W_PLUS_CQ:
        raise ValueError(f"cc_attention_core: H+W+Cq = {h + w + cq} exceeds the "
                         f"kernel's shared-memory limit {MAX_H_PLUS_W_PLUS_CQ}")
    if b * h * w >= 2 ** 31:
        raise ValueError("cc_attention_core: B*H*W exceeds the kernel's grid")


def cc_attention_core_cuda(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Launches the kernel on the current stream; raises on what it can't take."""
    global KERNEL_LAUNCHES
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"cc_attention_core_cuda: tensors on {q.device}, not CUDA")
    out = torch.empty_like(v)
    if out.numel() == 0:
        return out
    b, h, w, cq = q.shape
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cc_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), b, h, w, cq, v.shape[-1],
                                   _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"cc_attention_fwd launch failed with CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return out


def cc_attention_core(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return cc_attention_core_plain(q, k, v)
    return cc_attention_core_cuda(q, k, v)
