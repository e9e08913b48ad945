"""Criss-cross (axial H+W) attention core: two CUDA kernels and their plain versions.

Counterpart of rnd_semantic_segmentation_tpu/ops/ccattn.py.  The function is
the one its ``cc_attention_core_jnp`` computes: energies down the column (the
query's own row masked to -inf) and along the row, one softmax over the joint
H+W axis, and the two aggregations summed.  Layout is the JAX package's NHWC:
q, k ``[B,H,W,Cq]``, v ``[B,H,W,C]``.

``cc_attention_core`` dispatches by the device the tensors lie on.  CUDA
tensors go through ``CrissCrossFunction``, whose forward is the kernel in
``csrc/ccattn_fwd.cu`` and whose backward is the kernel in
``csrc/ccattn_bwd.cu`` (or they raise).  Both take one image row or column
(or a tile of one) per block and stage its q, k, v in shared memory once.
The forward runs two passes: row blocks write each query's row softmax
partials (max, sum) and unnormalised row output to float32 workspaces;
column blocks form the column branch with the query's own row masked,
combine it with the row partials as flash attention combines key blocks, and
write the output.  Keys stream in tiles, so the forward takes any line
length; what bounds it is the launch grid (blocks < 2^31) and B*H*W < 2^31.
At the serving shape B=8, 16x32, Cq=32, C=256 in float32 it must move
9.44 MB, 2.8 us at 3.35 TB/s: bytes bound it.  The backward recomputes the
attention from the saved q, k, v, as the JAX package's custom VJP does, in
three passes: the row branch's softmax partials, the column branch in full
(joint statistics and its contributions), then the row branch and the sum.
CPU tensors go to ``cc_attention_core_plain`` under ordinary autograd.
``KERNEL_LAUNCHES`` counts forward calls and ``BWD_KERNEL_LAUNCHES``
backward calls.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import native

SOURCE = "ccattn_fwd"
BWD_SOURCE = "ccattn_bwd"
SOURCES = (SOURCE, BWD_SOURCE)
KERNEL_LAUNCHES = 0
BWD_KERNEL_LAUNCHES = 0

# The forward's grid holds at most 2^31 - 1 blocks per pass, and pixel
# indices stay below 2^31.
MAX_PIXELS = 2 ** 31 - 1
# The backward runs one block per image column and per image row (rows longer
# than BWD_TILE pixels in tiles of BWD_TILE).  A block keeps its two float32
# [queries, keys+1] matrices and, at the least, two stages of BWD_SLICE-channel
# slices of its operands in dynamic shared memory, which must fit the
# MAX_BWD_SHARED_BYTES a block can opt in to on the H100: H <= 137 and
# W <= 259, whatever Cq and C are.
BWD_SLICE, BWD_TILE = 32, 64
MAX_BWD_SHARED_BYTES = 232448


def bwd_shared_bytes(h: int, w: int) -> int:
    """Dynamic shared memory of the backward's largest block at H x W with its
    operands in slices (``pass_floats`` in csrc/ccattn_bwd.cu)."""
    def rect(nq, nk):
        return -(-2 * nq * (nk + 1) // 4) * 4 + 4 * nq + 2 * (nq + nk) * (BWD_SLICE + 4)

    rows = [rect(w, w)] if w <= BWD_TILE else [rect(BWD_TILE, w), rect(w, BWD_TILE)]
    return 4 * max(rect(h, h), *rows)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _inner_dtype(t: torch.Tensor) -> torch.dtype:
    """float32 inside, whatever the inputs' type; float64 stays float64."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _attention(qf: torch.Tensor, kf: torch.Tensor) -> torch.Tensor:
    """The joint softmax [B,H,W,H+W]: column keys first, then row keys."""
    h = qf.shape[1]
    energy_h = torch.einsum("bhwc,bkwc->bhwk", qf, kf)
    diag = torch.eye(h, dtype=torch.bool, device=qf.device)[None, :, None, :]
    energy_h = energy_h.masked_fill(diag, float("-inf"))
    energy_w = torch.einsum("bhwc,bhkc->bhwk", qf, kf)
    return torch.softmax(torch.cat([energy_h, energy_w], dim=-1), dim=-1)


def cc_attention_core_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """[B,H,W,Cq] x2, [B,H,W,C] -> [B,H,W,C]; einsum form, f32 inside."""
    h = q.shape[1]
    inner = _inner_dtype(q)
    qf, kf, vf = (t.to(inner) for t in (q, k, v))
    att = _attention(qf, kf)
    att_h, att_w = att[..., :h], att[..., h:]
    out_h = torch.einsum("bhwk,bkwc->bhwc", att_h, vf)
    out_w = torch.einsum("bhwk,bhkc->bhwc", att_w, vf)
    return (out_h + out_w).to(v.dtype)


def cc_attention_core_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of ``cc_attention_core_plain`` for the output gradient g.

    The explicit formula, f32 inside: a = softmax(e); da = <g, v_j>;
    s = sum_j a*da over both branches; de = a*(da - s); dq = sum_j de*k_j;
    dk_j += de*q; dv_j += a*g.
    """
    h = q.shape[1]
    inner = _inner_dtype(q)
    qf, kf, vf, gf = (t.to(inner) for t in (q, k, v, g))
    att = _attention(qf, kf)
    d_att = torch.cat([torch.einsum("bhwc,bkwc->bhwk", gf, vf),
                       torch.einsum("bhwc,bhkc->bhwk", gf, vf)], dim=-1)
    s = (att * d_att).sum(dim=-1, keepdim=True)
    d_e = att * (d_att - s)
    att_h, att_w = att[..., :h], att[..., h:]
    de_h, de_w = d_e[..., :h], d_e[..., h:]
    dq = (torch.einsum("bhwk,bkwc->bhwc", de_h, kf)
          + torch.einsum("bhwk,bhkc->bhwc", de_w, kf))
    dk = (torch.einsum("bhwk,bhwc->bkwc", de_h, qf)
          + torch.einsum("bhwk,bhwc->bhkc", de_w, qf))
    dv = (torch.einsum("bhwk,bhwc->bkwc", att_h, gf)
          + torch.einsum("bhwk,bhwc->bhkc", att_w, gf))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _library(source: str) -> ctypes.CDLL:
    lib = native.load(source)
    if source == SOURCE:
        fn, n_ptr = lib.cc_attention_fwd, 6
    else:
        fn, n_ptr = lib.cc_attention_bwd, 9
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _pass_info(source: str, fn_name: str, keys, shape, dtype, pass_index) -> dict:
    fn = getattr(_library(source), fn_name)
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    res = (ctypes.c_int * len(keys))()
    err = fn(*shape, _DTYPE_CODES[dtype], pass_index, res)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed with CUDA error {err}")
    return dict(zip(keys, res))


FWD_PASSES = ("rows", "columns and the sum")


def fwd_pass_info(shape, dtype: torch.dtype, pass_index: int) -> dict:
    """What the runtime reports for pass ``pass_index`` of the forward at
    ``shape`` = (B, H, W, Cq, C): registers a thread, local (spill) bytes,
    dynamic shared memory, resident blocks per SM, the blocks of the grid, the
    pixels of a block's query tile and key tile, and its channel groups.
    Needs a card."""
    return _pass_info(SOURCE, "cc_attention_fwd_info",
                      ("registers", "local_bytes", "smem_bytes", "blocks_per_sm", "blocks",
                       "query_tile", "key_tile", "groups"), shape, dtype, pass_index)


BWD_PASSES = ("row statistics", "columns", "rows and the sum")


def bwd_pass_info(shape, dtype: torch.dtype, pass_index: int) -> dict:
    """What the runtime reports for pass ``pass_index`` of the backward at
    ``shape`` = (B, H, W, Cq, C): registers a thread, local (spill) bytes,
    dynamic shared memory, resident blocks per SM, whether the operands are
    staged whole, the blocks of the grid and the pixels of a block's line or
    row tile.  Needs a card."""
    return _pass_info(BWD_SOURCE, "cc_attention_bwd_info",
                      ("registers", "local_bytes", "smem_bytes", "blocks_per_sm", "whole",
                       "blocks", "tile"), shape, dtype, pass_index)


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
    b, h, w, _ = q.shape
    if b * h * w > MAX_PIXELS:
        raise ValueError(f"cc_attention_core: B*H*W = {b * h * w} exceeds the kernels' "
                         f"limit of {MAX_PIXELS} pixels")


def cc_attention_core_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launches the forward kernel (its two passes: rows, then columns and
    the sum) on the current stream; raises on what it can't take.  The
    result carries no autograd history: gradients come from
    ``CrissCrossFunction``, which calls this from its forward."""
    global KERNEL_LAUNCHES
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"cc_attention_core_cuda: tensors on {q.device}, not CUDA")
    out = torch.empty_like(v)
    if out.numel() == 0:
        return out
    b, h, w, cq = q.shape
    c = v.shape[-1]
    # float32 scratch: each query's row max and sum, and its unnormalised row output
    stats = torch.empty((b, h, w, 2), dtype=torch.float32, device=q.device)
    partial = torch.empty((b, h, w, c), dtype=torch.float32, device=q.device)
    lib = _library(SOURCE)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cc_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), stats.data_ptr(), partial.data_ptr(),
                                   b, h, w, cq, c, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"cc_attention_fwd launch failed with CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return out


def cc_attention_core_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Launches the backward kernel (its three passes: row statistics, column
    branch, row branch and sum) on the current stream and returns (dq, dk, dv)
    in the inputs' type; raises on what it can't take."""
    global BWD_KERNEL_LAUNCHES
    _check(q, k, v)
    if g.device != q.device or g.dtype != q.dtype:
        raise TypeError(f"cc_attention_core_bwd: g is {g.dtype} on {g.device}, "
                        f"q is {q.dtype} on {q.device}")
    if g.shape != v.shape or not g.is_contiguous():
        raise ValueError(f"cc_attention_core_bwd: g must be contiguous with v's shape "
                         f"{tuple(v.shape)}, got {tuple(g.shape)}")
    b, h, w, cq = q.shape
    c = v.shape[-1]
    if bwd_shared_bytes(h, w) > MAX_BWD_SHARED_BYTES:
        raise ValueError(f"cc_attention_core_bwd: H x W = {h} x {w} needs "
                         f"{bwd_shared_bytes(h, w)} bytes of shared memory in a block, "
                         f"over the {MAX_BWD_SHARED_BYTES} it can have (H <= 137, "
                         f"W <= 259)")
    if q.device.type != "cuda":
        raise ValueError(f"cc_attention_core_bwd_cuda: tensors on {q.device}, not CUDA")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dv.numel() == 0 or dq.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # float32 scratch: each query's softmax statistics, and the column
    # branch's contributions to dq, dk and dv of each pixel
    stats = torch.empty((b, h, w, 3), dtype=torch.float32, device=q.device)
    contrib = torch.empty((b, h, w, 2 * cq + c), dtype=torch.float32, device=q.device)
    lib = _library(BWD_SOURCE)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.cc_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                   dv.data_ptr(), stats.data_ptr(), contrib.data_ptr(),
                                   b, h, w, cq, c, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"cc_attention_bwd launch failed with CUDA error {err}")
    BWD_KERNEL_LAUNCHES += 1
    return dq, dk, dv


class CrissCrossFunction(torch.autograd.Function):
    """The core with its hand-written gradient.  Saves q, k, v and recomputes
    the attention in the backward.  CUDA tensors take the two kernels; CPU
    tensors take the two plain versions."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cuda":
            return cc_attention_core_cuda(q, k, v)
        return cc_attention_core_plain(q, k, v)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        if grad_out.dtype != q.dtype:
            raise TypeError(f"CrissCrossFunction.backward: gradient is {grad_out.dtype}, "
                            f"q is {q.dtype}")
        # the caller permutes the output to NCHW, so the gradient arrives as a
        # permuted view: the kernel needs it contiguous NHWC
        g = grad_out.contiguous()
        if q.device.type == "cuda":
            return cc_attention_core_bwd_cuda(q, k, v, g)
        return cc_attention_core_bwd_plain(q, k, v, g)


def cc_attention_core(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return cc_attention_core_plain(q, k, v)
    return CrissCrossFunction.apply(q, k, v)
