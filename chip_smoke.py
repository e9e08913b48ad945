#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (rnd_semantic_segmentation_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU, nvcc and the port's sources; exits non-zero and prints
no result line on any failure.  Phases, each of which raises:

  1. device   the card's name and power limit (nvidia-smi) and torch's view;
  2. build    every CUDA source of the port, one nvcc each, all started at once;
  3. kernels  each kernel against its plain PyTorch version on the card, in
              float32 and bfloat16, at the shapes the main paths give it and
              more (the criss-cross forward and backward also two of their
              calls for equal bits, with each pass's resources and device
              time; the forward also beside a masked
              scaled_dot_product_attention over the H*W pixels, its library
              yardstick, and with its channels split into other numbers of
              groups; the backward also against autograd of the plain
              forward; the fused MBConv also against the unfused module
              path), and its time beside its bound and the plain version's
              (the fused MBConv also beside a tensor-core bound, after a
              report of its instances: ptxas registers and spills, shared
              memory, blocks per SM, HMMA instructions);
  4. serve    the GALD serving path: GALD (HarDNet68 + GCPA-CC, 19 classes, full
              width, seeded weights) behind the port's HTTP server at
              1024x512, 16 PNG requests from 8 threads; kernel launches are
              counted over exactly that traffic, and one batch of masks is
              checked against the same forward with the plain attention core;
  5. train    the GALD training path: the same model through the source-training
              CLI's parser and ``Trainer`` at 1280x720, batch 6, Adam, float32,
              on the synthetic dataset, for 6 steps; forward and backward
              kernel launches are counted over exactly those steps, the
              attention's parameters must receive gradients and move, one
              step's gradients are held against the same step with the plain
              core, and the checkpoint it wrote loads back into ``Tester``;
  6. eval_attn   the attn eval path: Attention-EfficientNet-B2-UNet (2 classes,
              full width and depth, seeded weights) through the test CLI's
              parser and ``Tester.test()`` at 512x512, batch 8, on the
              synthetic dataset, with MODEL.FUSED_MBCONV on: 17 fused-MBConv
              launches per forward, a finite summary, and the confusion matrix
              of the same run with the switch off;
  7. serve_attn  the attn serving path: the same model behind the HTTP server
              with the switch on, 16 PNG requests from 8 threads, launches
              counted over exactly that traffic, one batch of masks checked
              against the unfused forward.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  ``--phases a,b`` runs only the named
phases (kernels, kernels_bwd, kernels_mbconv, serve, train, eval_attn,
serve_attn; device and build always run) and prints no result lines: an aid
while working on one path.
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch

from rnd_semantic_segmentation_torch.ckpt.torch_import import save_reference_checkpoint
from rnd_semantic_segmentation_torch.cli import test as test_cli
from rnd_semantic_segmentation_torch.cli import train_src
from rnd_semantic_segmentation_torch.cli.common import load_cfg
from rnd_semantic_segmentation_torch.cli.serve import build_parser
from rnd_semantic_segmentation_torch.eval.tester import Tester
from rnd_semantic_segmentation_torch.models import gcpa
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.models.efficientnet import MBConvBlock, block_list
from rnd_semantic_segmentation_torch.ops import ccattn, mbconv, native
from rnd_semantic_segmentation_torch.serve.server import make_server
from rnd_semantic_segmentation_torch.utils import load_json, resolve_device

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; FLOP/s for float32 (no
# tensor cores at full float32 precision) and for bfloat16 (tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# a product on the tensor cores: float32 as three TF32 passes (495 TFLOP/s
# each), bfloat16 at its own rate; the rest of the work stays at 67 TFLOP/s
PEAK_TC_FLOP_PER_S = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}

# serving geometry: (W, H) = (1024, 512); the /32 map is 16x32 with 256 channels
SERVE_W, SERVE_H = 1024, 512
# training geometry: (W, H) = (1280, 720), batch 6; the /32 map is 22x40
TRAIN_W, TRAIN_H, TRAIN_BATCH, TRAIN_STEPS = 1280, 720, 6, 6
TRAIN_CC_SHAPE = (TRAIN_BATCH, 22, 40, 32, 256)
CC_SHAPES = [(1, 16, 32, 32, 256), (8, 16, 32, 32, 256),   # serving, B in {1, 8}
             TRAIN_CC_SHAPE,
             (2, 7, 11, 32, 256),                          # rectangular, odd
             (1, 1, 5, 32, 256),                           # column branch all masked
             (1, 64, 128, 32, 256)]                        # 2048x4096 input
MAIN_CC_SHAPE = (8, 16, 32, 32, 256)
# |kernel - plain| <= atol + rtol*|plain|: float32 sums in another order;
# bfloat16 outputs round to 8 mantissa bits on both sides
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 1e-2)}
# the backward's outputs are sums of up to H+W+... products whose size grows
# with the shape, so its tolerance is a share of the plain result's largest
# magnitude: float32 sums in another order; bfloat16 outputs round to 8
# mantissa bits (2^-8 of the value) on both sides
BWD_TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# one train step's gradients, kernels against plain core, as ||difference|| over
# ||plain|| per leaf: the cores agree to 1e-5, and the backward of the bilinear
# upsampling adds with atomics, in an order that differs from run to run (the
# run prints that spread beside the comparison); both differences pass through
# 68 layers of batch-statistics BatchNorm and ReLU, which amplify them (2e-5
# for the atomics alone and 7e-4 for the cores on an NVIDIA H100)
GRAD_TOLERANCE = 5e-3
N_REQUESTS, N_THREADS, MAX_BATCH = 16, 8, 8
MIN_MASK_AGREEMENT = 0.999
# the attn paths: Attention-EfficientNet-B2-UNet, 2 classes, 512x512, batch 8
ATTN_MODEL, ATTN_SIZE, ATTN_BATCH, ATTN_EVAL_IMAGES = "attn_efficientnet-b2", 512, 8, 32
MBCONV_LAUNCHES_PER_FORWARD = 17
# fused-MBConv shapes beyond the model's, as (B, C, H, W, k) with F = 3C: odd
# and rectangular; smaller than the 5x5 stencil; no multiple of the 16x16 tile
MBCONV_ODD_SHAPES = [(2, 8, 7, 11, 3), (1, 16, 3, 5, 5), (2, 24, 37, 21, 5)]
MAIN_MBCONV_SHAPE = (ATTN_BATCH, 24, 128, 128, 3)   # blocks 3 and 4: most bytes
# fused and unfused eval of the same weights: the share of pixels whose argmax
# may differ (ties at float32 precision between two sigmoid outputs)
MAX_TIE_SHARE = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run "
                         "needs an NVIDIA GPU")
    resolve_device("cuda")  # also switches TF32 off for the whole run
    line = card_line()
    log(f"[device] nvidia-smi: {line}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return line


BUILD_OUTPUT = {}


def phase_build() -> None:
    t0 = time.perf_counter()
    built = native.build(ccattn.SOURCES + mbconv.SOURCES)
    BUILD_OUTPUT.update({name: out for name, (_, out) in built.items()})
    for name, (seconds, out) in built.items():
        log(f"[build] {name}: {seconds:.2f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all sources in {time.perf_counter() - t0:.2f} s")


def cc_inputs(shape, dtype, seed=0):
    b, h, w, cq, c = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(size, device="cuda", generator=gen).to(dtype)
                 for size in ((b, h, w, cq), (b, h, w, cq), (b, h, w, c)))


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time per call: ``reps`` calls captured in a CUDA graph, replayed,
    timed with CUDA events (no host launch cost in the window)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def cc_bound(shape, dtype):
    """Least time for the function at ``shape``: each input read once and the
    output written once, against the operations it must do at the input
    type's peak rate."""
    b, h, w, cq, c = shape
    item = torch.tensor([], dtype=dtype).element_size()
    pixels = b * h * w
    nbytes = item * pixels * (2 * cq + 2 * c)
    flops = pixels * ((h + w) * (2 * cq + 3 + 2 * c) + c)  # energies, softmax, sums
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOP_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cc_bwd_bound(shape, dtype):
    """Least time for the backward at ``shape``: q, k, v, g read once and dq,
    dk, dv written once, against its five contractions (e, da, dq, dk, dv) and
    the softmax at the input type's peak rate."""
    b, h, w, cq, c = shape
    item = torch.tensor([], dtype=dtype).element_size()
    pixels = b * h * w
    nbytes = item * pixels * (4 * cq + 3 * c)
    flops = pixels * (h + w) * (6 * cq + 4 * c + 8)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOP_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bwd_pass_us(q, k, v, g, calls: int = 10) -> list:
    """Median device time of each of the backward's three kernel launches
    (row statistics, columns, rows and the sum) over the last ``calls`` of
    ``calls + 5`` calls, from torch.profiler's CUDA activity (the tracer may
    miss the first launches after it starts, so the window ends on whole
    calls)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls + 5):
            ccattn.cc_attention_core_bwd_cuda(q, k, v, g)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if "cc_attention_bwd_kernel" in e.name),
                    key=lambda e: e.time_range.start)[-3 * calls:]
    if len(events) != 3 * calls:
        raise AssertionError(f"profiled {len(events)} backward launches, want {3 * calls}")
    return [float(np.median([e.device_time for e in events[i::3]])) for i in range(3)]


def phase_kernels_bwd() -> dict:
    """Kernel #2 against its plain version and autograd of the plain forward
    at every shape of CC_SHAPES, in float32 and bfloat16, with its time beside
    its bound and the plain version's; two calls at the training shape must
    give the same bits.  First, what the runtime says of the instances that
    each pass takes at the training shape and at 64x128."""
    for shape in (TRAIN_CC_SHAPE, CC_SHAPES[-1]):
        for i, name in enumerate(ccattn.BWD_PASSES):
            log(f"[kernel] cc_attention_bwd {shape} float32, pass {i + 1} ({name}): "
                f"{ccattn.bwd_pass_info(shape, torch.float32, i)}")
    result = {}
    for shape in CC_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = cc_inputs(shape, dtype)
            g = cc_inputs(shape, dtype, seed=1)[2]
            got = ccattn.cc_attention_core_bwd_cuda(q, k, v, g)
            torch.cuda.synchronize()
            if shape == TRAIN_CC_SHAPE:
                again = ccattn.cc_attention_core_bwd_cuda(q, k, v, g)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                log(f"[kernel] cc_attention_bwd {shape} {str(dtype)[6:]}: two calls "
                    f"give {'the same bits' if same else 'DIFFERENT BITS'}")
                if not same:
                    raise AssertionError(f"cc_attention_bwd is not repeatable at {shape} "
                                         f"{dtype}")
            plain = ccattn.cc_attention_core_bwd_plain(q, k, v, g)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            auto = torch.autograd.grad(ccattn.cc_attention_core_plain(*leaves), leaves, g)
            rel = BWD_TOLERANCE[dtype]
            err, ok = 0.0, True
            for name, o, p, a in zip(("dq", "dk", "dv"), got, plain, auto):
                for ref in (p, a):
                    scale = ref.float().abs().max().item()
                    e = (o.float() - ref.float()).abs().max().item()
                    err = max(err, e)
                    ok = ok and o.dtype == dtype and o.shape == ref.shape \
                        and bool(torch.isfinite(o).all()) and e <= rel * scale
            log(f"[kernel] cc_attention_bwd {shape} {str(dtype)[6:]}: max abs err "
                f"{err:.3e} against the plain backward and autograd of the plain "
                f"forward (tolerance {rel:g} x max|plain|) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"cc_attention_bwd disagrees with its plain version "
                                     f"at {shape} {dtype}: {err}")
            ms = graph_ms(lambda: ccattn.cc_attention_core_bwd_cuda(q, k, v, g))
            plain_ms = graph_ms(lambda: ccattn.cc_attention_core_bwd_plain(q, k, v, g))
            bound_ms, bound_by = cc_bwd_bound(shape, dtype)
            log(f"[kernel]   {ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
                f"({bound_by}), plain version {plain_ms * 1e3:.2f} us")
            if dtype == torch.float32:
                passes = bwd_pass_us(q, k, v, g)
                log(f"[kernel]   by pass (torch.profiler, device us): " + ", ".join(
                    f"{name} {us:.2f}" for name, us in zip(ccattn.BWD_PASSES, passes)))
            if shape == TRAIN_CC_SHAPE and dtype == torch.float32:
                result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by}
    return result


def fwd_pass_us(q, k, v, calls: int = 10) -> list:
    """Median device time of each of the forward's two kernel launches (rows;
    columns and the sum) over the last ``calls`` of ``calls + 5`` calls, from
    torch.profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls + 5):
            ccattn.cc_attention_core_cuda(q, k, v)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if "cc_attention_fwd_kernel" in e.name),
                    key=lambda e: e.time_range.start)[-2 * calls:]
    if len(events) != 2 * calls:
        raise AssertionError(f"profiled {len(events)} forward launches, want {2 * calls}")
    return [float(np.median([e.device_time for e in events[i::2]])) for i in range(2)]


def cc_sdpa(q, k, v, mask):
    """The yardstick: the same function as one masked
    ``scaled_dot_product_attention`` over the H*W pixels of an image, dense in
    (H*W)^2; the port never calls it."""
    b, h, w, cq = q.shape
    out = torch.nn.functional.scaled_dot_product_attention(
        q.view(b, 1, h * w, cq), k.view(b, 1, h * w, cq), v.view(b, 1, h * w, -1),
        attn_mask=mask, scale=1.0)
    return out.view(v.shape)


def cc_mask(h: int, w: int) -> torch.Tensor:
    """[H*W, H*W] boolean: pixel p sees p' in its row (itself included) and in
    its column: the W row keys and the H-1 column keys, each once."""
    rows = torch.arange(h, device="cuda").repeat_interleave(w)
    cols = torch.arange(w, device="cuda").repeat(h)
    return (rows[:, None] == rows[None, :]) | (cols[:, None] == cols[None, :])


def _within(out, ref, dtype):
    atol, rtol = TOLERANCE[dtype]
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all()) and out.dtype == dtype
    return diff.max().item(), ok


def phase_kernels() -> dict:
    """Kernel #1 against its plain version at every shape of CC_SHAPES, in
    float32 and bfloat16, with its time beside its bound, the plain version's
    and the masked-SDPA yardstick's (checked against the plain version
    first); two calls at the training shape must give the same bits.  First,
    what the runtime says of each pass at the training shape and at 64x128."""
    for shape in (TRAIN_CC_SHAPE, CC_SHAPES[-1]):
        for i, name in enumerate(ccattn.FWD_PASSES):
            log(f"[kernel] cc_attention_fwd {shape} float32, pass {i + 1} ({name}): "
                f"{ccattn.fwd_pass_info(shape, torch.float32, i)}")
    result = {}
    for shape in CC_SHAPES:
        mask = cc_mask(*shape[1:3])
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = cc_inputs(shape, dtype)
            out = ccattn.cc_attention_core(q, k, v)
            torch.cuda.synchronize()
            ref = ccattn.cc_attention_core_plain(q, k, v)
            err, ok = _within(out, ref, dtype)
            atol, rtol = TOLERANCE[dtype]
            log(f"[kernel] cc_attention_fwd {shape} {str(dtype)[6:]}: max abs err "
                f"{err:.3e} (tolerance {atol:g} + {rtol:g}*|plain|) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"cc_attention_fwd disagrees with its plain version "
                                     f"at {shape} {dtype}: {err}")
            if shape == TRAIN_CC_SHAPE:
                same = torch.equal(out, ccattn.cc_attention_core_cuda(q, k, v))
                log(f"[kernel] cc_attention_fwd {shape} {str(dtype)[6:]}: two calls "
                    f"give {'the same bits' if same else 'DIFFERENT BITS'}")
                if not same:
                    raise AssertionError(f"cc_attention_fwd is not repeatable at {shape} "
                                         f"{dtype}")
            sdpa_err, sdpa_ok = _within(cc_sdpa(q, k, v, mask), ref, dtype)
            log(f"[kernel]   masked SDPA yardstick: max abs err {sdpa_err:.3e} against the "
                f"plain version {'ok' if sdpa_ok else 'FAIL'}")
            if not sdpa_ok:
                raise AssertionError(f"masked SDPA disagrees with the plain version at "
                                     f"{shape} {dtype}: {sdpa_err}")
            ms = graph_ms(lambda: ccattn.cc_attention_core(q, k, v))
            plain_ms = graph_ms(lambda: ccattn.cc_attention_core_plain(q, k, v))
            library_ms = graph_ms(lambda: cc_sdpa(q, k, v, mask))
            bound_ms, bound_by = cc_bound(shape, dtype)
            log(f"[kernel]   {ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
                f"({bound_by}), plain version {plain_ms * 1e3:.2f} us, masked SDPA "
                f"{library_ms * 1e3:.2f} us")
            if dtype == torch.float32:
                passes = fwd_pass_us(q, k, v)
                log(f"[kernel]   by pass (torch.profiler, device us): " + ", ".join(
                    f"{name} {us:.2f}" for name, us in zip(ccattn.FWD_PASSES, passes)))
            if shape in (MAIN_CC_SHAPE, TRAIN_CC_SHAPE) and dtype == torch.float32:
                result[shape] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": bound_by,
                                 "library_ms": library_ms}
    return result


def attn_mbconv_shapes(size: int = ATTN_SIZE) -> dict:
    """{(C, H, W, k): number of blocks} of the MBConv blocks of one forward that
    take the fused path (expansion, stride 1), from the model's block list."""
    shapes, hw = {}, -(-size // 2)  # the stem halves the input
    for k, stride, expand, c_in, _, _ in block_list(ATTN_MODEL.split("_")[1]):
        hw = -(-hw // stride)
        if expand != 1 and stride == 1:
            shapes[(c_in, hw, hw, k)] = shapes.get((c_in, hw, hw, k), 0) + 1
    return shapes


def mbconv_inputs(shape, f, dtype, seed=0):
    """x, w_exp, s0, b0, w_dw, s1, b1 with activations and affines of order 1."""
    b, c, h, w, k = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *size: torch.randn(size, device="cuda", generator=gen)
    rand = lambda lo, hi: torch.rand(f, device="cuda", generator=gen) * (hi - lo) + lo
    x = randn(b, c, h, w).to(dtype)
    w_exp = (randn(f, c) * (1.7 / c) ** 0.5).to(dtype)
    w_dw = randn(f, k, k) * (1.7 / (k * k)) ** 0.5
    return x, w_exp, rand(0.5, 1.5), rand(-0.2, 0.2), w_dw, rand(0.5, 1.5), rand(-0.2, 0.2)


def _mbconv_bytes_s(shape, f, dtype):
    """x and the weights read once and y written once, over the HBM rate."""
    b, c, h, w, k = shape
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * b * h * w * (c + f) + item * f * c + 4 * f * (k * k + 4)
    return nbytes / PEAK_BYTES_PER_S


def _bound(t_bytes, t_ops):
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def mbconv_bound(shape, f, dtype):
    """Least time for the function at ``shape``: its bytes against the product
    (2C per output), the stencil (2k^2) and the two affines and swishes (12)
    at the input type's peak."""
    b, c, h, w, k = shape
    flops = b * h * w * f * (2 * c + 2 * k * k + 12)
    return _bound(_mbconv_bytes_s(shape, f, dtype), flops / PEAK_FLOP_PER_S[dtype])


def mbconv_tc_bound(shape, f, dtype):
    """``mbconv_bound`` for a kernel whose product runs on the tensor cores:
    the same bytes, against the product (2C per output) at the tensor-core
    rate plus the stencil and swishes (2k^2 + 12) at 67 TFLOP/s."""
    b, c, h, w, k = shape
    outputs = b * h * w * f
    t_ops = (outputs * 2 * c / PEAK_TC_FLOP_PER_S[dtype]
             + outputs * (2 * k * k + 12) / PEAK_FLOP_PER_S[torch.float32])
    return _bound(_mbconv_bytes_s(shape, f, dtype), t_ops)


_INSTANCE = re.compile(r"fused_mbconv_fwd_kernelI(f|13__nv_bfloat16)Li(\d)E")


def _instance_name(mangled: str) -> str:
    m = _INSTANCE.search(mangled)
    return f"{'float32' if m.group(1) == 'f' else 'bfloat16'} k={m.group(2)}" if m else ""


def mbconv_build_report() -> None:
    """ptxas' registers and spills of each instance, the runtime's view of
    its shared memory and residency, and the HMMA (tensor-core) instructions
    in its machine code."""
    current = ""
    for line in BUILD_OUTPUT.get(mbconv.SOURCE, "").splitlines():
        if "Compiling entry function" in line:
            current = _instance_name(line)
        elif current and ("registers" in line or "spill" in line):
            log(f"[kernel] ptxas {current}: {line.strip()}")
    for k in mbconv.KERNEL_SIZES:
        for dtype in (torch.float32, torch.bfloat16):
            log(f"[kernel] runtime {str(dtype)[6:]} k={k}: {mbconv.instance_info(k, dtype)}")
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        log("[kernel] HMMA instructions: not measured (no cuobjdump)")
        return
    sass = subprocess.run([cuobjdump, "-sass", native.library_path(mbconv.SOURCE)],
                          capture_output=True, text=True, timeout=120).stdout
    counts, current = {}, ""
    for line in sass.splitlines():
        if "Function :" in line:
            current = _instance_name(line)
        elif current and "HMMA" in line:
            counts[current] = counts.get(current, 0) + 1
    log(f"[kernel] HMMA instructions in {os.path.basename(native.library_path(mbconv.SOURCE))}"
        f" by instance (cuobjdump -sass): {counts or 'none'}")


def _mbconv_compare(shape, f, dtype):
    """The kernel against its plain version, borders and interior apart."""
    b, c, h, w, k = shape
    args = mbconv_inputs(shape, f, dtype)
    out = mbconv.fused_mbconv_core(*args)
    torch.cuda.synchronize()
    ref = mbconv.fused_mbconv_core_plain(*args)
    atol, rtol = TOLERANCE[dtype]
    diff = (out.float() - ref.float()).abs()
    bad = diff > atol + rtol * ref.float().abs()
    p = (k - 1) // 2
    border = torch.ones((h, w), dtype=torch.bool, device="cuda")
    border[p:h - p, p:w - p] = False
    err_border = diff[..., border].max().item() if border.any() else 0.0
    err_inner = diff[..., ~border].max().item() if (~border).any() else 0.0
    ok = (out.dtype == dtype and out.shape == (b, f, h, w) and not bool(bad.any())
          and bool(torch.isfinite(out).all()))
    log(f"[kernel] fused_mbconv_fwd B={b} C={c}->F={f} {h}x{w} k={k} {str(dtype)[6:]}: "
        f"max abs err {max(err_border, err_inner):.3e} (border ring {err_border:.3e}, "
        f"interior {err_inner:.3e}; tolerance {atol:g} + {rtol:g}*|plain|) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fused_mbconv_fwd disagrees with its plain version at "
                             f"{shape} F={f} {dtype}")
    return args, max(err_border, err_inner)


def phase_kernels_mbconv() -> dict:
    """Kernel #3 against its plain version at every shape of the B2 forward
    (B in {1, 8}) and at odd shapes; its time beside its bound, the plain
    version's time and the unfused module path's (several library calls)."""
    shapes = attn_mbconv_shapes()
    if sum(shapes.values()) != MBCONV_LAUNCHES_PER_FORWARD or len(shapes) != 8:
        raise AssertionError(f"{ATTN_MODEL} at {ATTN_SIZE}: fused blocks {shapes}")
    mbconv_build_report()
    before = mbconv.KERNEL_LAUNCHES
    for shape in MBCONV_ODD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            _mbconv_compare(shape, 3 * shape[1], dtype)
    per_shape, main = [], {}
    for (c, h, w, k), count in shapes.items():
        f = 6 * c
        for dtype in (torch.float32, torch.bfloat16):
            _mbconv_compare((1, c, h, w, k), f, dtype)
            shape = (ATTN_BATCH, c, h, w, k)
            args, err = _mbconv_compare(shape, f, dtype)
            with torch.inference_mode():
                ms = graph_ms(lambda: mbconv.fused_mbconv_core(*args))
                plain_ms = graph_ms(lambda: mbconv.fused_mbconv_core_plain(*args))
            bound_ms, bound_by = mbconv_bound(shape, f, dtype)
            tc_bound_ms, tc_bound_by = mbconv_tc_bound(shape, f, dtype)
            entry = {"shape": list(shape), "f": f, "blocks": count, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "tc_bound_ms": tc_bound_ms,
                     "tc_bound_by": tc_bound_by}
            if dtype == torch.float32:
                # the module's own two routes through the segment, from one set of
                # weights: the fused one folds both BatchNorms and launches the
                # kernel, the unfused one is conv, BN, swish, conv, BN, swish
                block = MBConvBlock(c, c, k, 1, 6, 0.25, fused_mbconv=True)
                randomize_weights_(block, seed=c + k).cuda().eval()
                with torch.inference_mode():
                    fused, unfused = block.segment_fused(args[0]), block.segment_unfused(args[0])
                    seg_err = (fused - unfused).abs().max().item()
                    atol, rtol = TOLERANCE[dtype]
                    if bool(((fused - unfused).abs() > atol + rtol * unfused.abs()).any()):
                        raise AssertionError(f"MBConvBlock fused and unfused segments differ "
                                             f"at {shape}: {seg_err}")
                    entry["segment_ms"] = graph_ms(lambda: block.segment_fused(args[0]))
                    entry["unfused_ms"] = graph_ms(lambda: block.segment_unfused(args[0]))
                entry["segment_max_abs_err"] = seg_err
                per_shape.append(entry)
                log(f"[kernel]   x{count} blocks: kernel {ms * 1e3:.2f} us, bound "
                    f"{bound_ms * 1e3:.2f} us ({bound_by}), tensor-core bound "
                    f"{tc_bound_ms * 1e3:.2f} us ({tc_bound_by}), plain version "
                    f"{plain_ms * 1e3:.2f} us; module segment fused (BN folds + kernel) "
                    f"{entry['segment_ms'] * 1e3:.2f} us vs unfused (conv, BN, swish, conv, "
                    f"BN, swish: library calls) {entry['unfused_ms'] * 1e3:.2f} us, "
                    f"unfused / kernel {entry['unfused_ms'] / ms:.2f}, "
                    f"fused vs unfused max abs err {seg_err:.3e}")
                if shape == MAIN_MBCONV_SHAPE:
                    main = {k2: entry[k2] for k2 in ("max_abs_err", "ms", "plain_ms",
                                                     "bound_ms", "bound_by", "tc_bound_ms",
                                                     "tc_bound_by", "unfused_ms")}
            else:
                per_shape[-1]["bf16"] = entry
                log(f"[kernel]   bfloat16: kernel {ms * 1e3:.2f} us, bound "
                    f"{bound_ms * 1e3:.2f} us ({bound_by}), tensor-core bound "
                    f"{tc_bound_ms * 1e3:.2f} us ({tc_bound_by}), plain version "
                    f"{plain_ms * 1e3:.2f} us; bfloat16 / float32 kernel "
                    f"{ms / per_shape[-1]['ms']:.2f}")
    totals = {key: sum(e[key] * e["blocks"] for e in per_shape)
              for key in ("ms", "bound_ms", "tc_bound_ms", "plain_ms", "segment_ms",
                          "unfused_ms")}
    log(f"[kernel] fused_mbconv_fwd over the {MBCONV_LAUNCHES_PER_FORWARD} blocks of one "
        f"B={ATTN_BATCH} forward, float32: kernel {totals['ms']:.3f} ms, bound "
        f"{totals['bound_ms']:.3f} ms, tensor-core bound {totals['tc_bound_ms']:.3f} ms, "
        f"plain version {totals['plain_ms']:.3f} ms, module segment fused "
        f"{totals['segment_ms']:.3f} ms vs unfused {totals['unfused_ms']:.3f} ms, "
        f"unfused / kernel {totals['unfused_ms'] / totals['ms']:.2f}; bfloat16 kernel "
        f"{sum(e['bf16']['ms'] * e['blocks'] for e in per_shape):.3f} ms")
    if not main or mbconv.KERNEL_LAUNCHES == before:
        raise AssertionError("the main fused-MBConv shape was not measured")
    return {**main, "shape": list(MAIN_MBCONV_SHAPE), "per_shape": per_shape,
            "per_forward_ms": totals}


def host_ms(fn, reps: int = 3) -> float:
    """Host-clock time per call after one warm call; ``fn`` ends in a sync."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _png(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG", compress_level=1)
    return buf.getvalue()


def _post(port: int, body: bytes, path="/predict?format=raw"):
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    return resp.status, data, time.perf_counter() - t0


def _get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _stderr_logger(name: str, level=logging.WARNING):
    logger = logging.getLogger(name)
    logger.addHandler(logging.StreamHandler(sys.stderr))
    logger.setLevel(level)
    return logger


def _seeded_checkpoint(tag: str, cfg, pth: str) -> None:
    spec = build_segmentor(cfg)
    randomize_weights_(torch.nn.ModuleDict(spec.modules), seed=0)
    save_reference_checkpoint(spec.modules, pth)
    log(f"[{tag}] seeded full-width weights: "
        f"{sum(p.numel() for m in spec.modules.values() for p in m.parameters())} "
        f"parameters -> {pth}")


def serve_traffic(tag: str, cfg, args, render, w: int, h: int, card: str, counter):
    """Starts the daemon, sends N_REQUESTS PNGs of w x h from N_THREADS threads
    and stops it.  ``counter`` is (module, attribute) of the kernel's launch
    count: set to 0 just before the traffic and read just after.  Returns the
    stopped server, the request bodies, the masks, the number of batches, the
    launches and the wall time of the traffic."""
    from PIL import Image

    t0 = time.perf_counter()
    inf, httpd = make_server(cfg, render, _stderr_logger(f"chip_smoke.{tag}"), port=0,
                             max_batch=args.max_batch,
                             batch_timeout_ms=args.batch_timeout_ms)
    port = httpd.server_address[1]
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    try:
        while _get(port, "/healthz")[0] != 200:
            if time.perf_counter() - t0 > 600 or not inf._thread.is_alive():
                raise RuntimeError("server did not become ready")
            time.sleep(0.2)
        log(f"[{tag}] ready on port {port} after {time.perf_counter() - t0:.1f} s "
            f"(model load + warm-up of buckets 1..{MAX_BATCH} at {w}x{h})")

        rng = np.random.RandomState(0)
        images = [(rng.rand(h, w, 3) * 255).astype(np.uint8) for _ in range(N_REQUESTS)]
        bodies = [_png(a) for a in images]
        results = [None] * N_REQUESTS

        def client(i0):
            for i in range(i0, N_REQUESTS, N_THREADS):
                results[i] = _post(port, bodies[i])

        before = inf.snapshot_stats()
        setattr(*counter, 0)
        t_start = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t_start
        launches = getattr(*counter)
        after = inf.snapshot_stats()
        if any(t.is_alive() for t in threads):
            raise RuntimeError("requests did not finish")

        masks = []
        for i, (status, data, _) in enumerate(results):
            if status != 200:
                raise AssertionError(f"request {i}: HTTP {status} {data[:200]!r}")
            mask = np.asarray(Image.open(io.BytesIO(data)))
            if mask.shape != (h, w) or mask.max() >= cfg.MODEL.NUM_CLASSES:
                raise AssertionError(f"request {i}: mask {mask.shape}, max {mask.max()}")
            masks.append(mask)
        batches = after["batches"] - before["batches"]
        served = after["batched_images"] - before["batched_images"]
        status, body = _get(port, "/stats")
        stats = json.loads(body)
        log(f"[{tag}] {N_REQUESTS} requests from {N_THREADS} threads: {batches} batches, "
            f"{served} images, /stats {stats}")
        if (status != 200 or served != N_REQUESTS or after["errors"] != before["errors"]
                or after["requests"] - before["requests"] != N_REQUESTS):
            raise AssertionError(f"stats disagree with the traffic: {before} -> {after}")

        lat = np.array([r[2] for r in results]) * 1e3
        log(f"[{tag}] on {card}: request latency p50 {np.percentile(lat, 50):.1f} ms, "
            f"p99 {np.percentile(lat, 99):.1f} ms, {N_REQUESTS / wall:.2f} images/s "
            f"(PNG decode to mask PNG, {N_THREADS} clients, max batch {MAX_BATCH})")
    finally:
        httpd.shutdown()
        httpd.server_close()
        inf.shutdown()
        http_thread.join(60)
    return inf, bodies, masks, batches, launches, wall


def serve_breakdown(tag: str, inf, bodies, masks, w: int, h: int, batches: int,
                    wall: float, card: str) -> torch.Tensor:
    """Where a request's time goes: host decode, one full-batch dispatch (copy
    in, forward, argmax, copy out), the forward alone, and the mask encode.
    Returns the device batch it used."""
    tester = inf.tester
    batch = np.stack([inf.preprocess(b) for b in bodies[:MAX_BATCH]])
    x = torch.from_numpy(batch).to(tester.device).permute(0, 3, 1, 2).contiguous()
    decode_ms = host_ms(lambda: inf.preprocess(bodies[0]))
    run_ms = host_ms(lambda: inf._run(batch))
    forward_ms = host_ms(lambda: tester._probs_impl(x, (h, w)).sum().item())
    encode_ms = host_ms(lambda: inf.encode_png(masks[0]))
    log(f"[{tag}] breakdown on {card}: decode+preprocess {decode_ms:.1f} ms/image, "
        f"dispatch of {MAX_BATCH} {run_ms:.1f} ms (forward alone {forward_ms:.1f} ms), "
        f"palette PNG encode {encode_ms:.1f} ms/mask; {batches} batches x forward "
        f"<= {batches * forward_ms / (wall * 1e3):.0%} of the {wall * 1e3:.0f} ms window")
    return x


def _check_agreement(tag: str, what: str, probs: torch.Tensor, masks) -> None:
    if not torch.isfinite(probs).all():
        raise AssertionError(f"{what}: probabilities are not finite")
    other = probs.argmax(1).to(torch.uint8).cpu().numpy()
    agreement = float((other == np.stack(masks[:MAX_BATCH])).mean())
    log(f"[{tag}] served masks vs {what}: argmax agreement {agreement:.6f} "
        f"(minimum {MIN_MASK_AGREEMENT})")
    if agreement < MIN_MASK_AGREEMENT:
        raise AssertionError(f"argmax agreement {agreement} < {MIN_MASK_AGREEMENT}")


def phase_serve(tmp: str, card: str) -> int:
    pth = os.path.join(tmp, "Gald-seeded.pth")
    args = build_parser().parse_args([
        "--max-batch", str(MAX_BATCH), "MODEL.NAME", "gald_hardnet68",
        "MODEL.NUM_CLASSES", "19", "INPUT.INPUT_SIZE_TEST", f"({SERVE_W}, {SERVE_H})",
        "AUG.NAME", "gald", "OUTPUT_DIR", tmp, "resume", pth])
    cfg = load_cfg(args)
    _seeded_checkpoint("serve", cfg, pth)
    render = load_json(os.path.join(HERE, "renders", "cityscapes.json"))
    inf, bodies, masks, batches, launches, wall = serve_traffic(
        "serve", cfg, args, render, SERVE_W, SERVE_H, card, (ccattn, "KERNEL_LAUNCHES"))
    if launches != 2 * batches or launches == 0:
        raise AssertionError(f"cc_attention_fwd launched {launches} times for "
                             f"{batches} batches; want 2 per batch")
    log(f"[serve] cc_attention_fwd launches: {launches} = 2 x {batches} batches")
    x = serve_breakdown("serve", inf, bodies, masks, SERVE_W, SERVE_H, batches, wall, card)

    # one batch against the same forward with the plain attention core
    with mock.patch.object(gcpa, "cc_attention_core", ccattn.cc_attention_core_plain):
        probs = inf.tester._probs_impl(x, (SERVE_H, SERVE_W))
    if (probs.sum(1) - 1).abs().max() > 1e-4:
        raise AssertionError("plain-core probabilities are not a distribution")
    _check_agreement("serve", "plain-core forward", probs, masks)
    return launches


def _set_fused(tester, enabled: bool) -> None:
    for block in tester.spec.modules["encoder"].blocks:
        block.fused_mbconv = enabled


def _attn_opts(tmp: str, pth: str, *more):
    return ["-cfg", os.path.join(HERE, "configs", "attn_src_kvasir.yaml"),
            "-c", os.path.join(HERE, "renders", "kvasir.json"),
            "OUTPUT_DIR", tmp, "resume", pth, *more]


def _check_attn_geometry(cfg) -> None:
    geometry = (cfg.MODEL.NAME, cfg.MODEL.NUM_CLASSES, tuple(cfg.INPUT.INPUT_SIZE_TEST))
    if geometry != (ATTN_MODEL, 2, (ATTN_SIZE, ATTN_SIZE)):
        raise AssertionError(f"configs/attn_src_kvasir.yaml gives {geometry}")


def phase_eval_attn(tmp: str, card: str) -> int:
    """``cli.test``'s own function on the attn family with the fused kernel
    on, then the same run with it off."""
    pth = os.path.join(tmp, "Attn-seeded.pth")
    logger = _stderr_logger("chip_smoke.eval_attn", logging.INFO)
    runs = {}
    for fused in (True, False):
        out_dir = os.path.join(tmp, f"eval_attn_{'fused' if fused else 'unfused'}")
        args = test_cli.build_parser().parse_args(_attn_opts(
            out_dir, pth, "DATASETS.TEST", "synthetic_val",
            "DATASETS.SYNTHETIC_LENGTH", str(ATTN_EVAL_IMAGES),
            "TEST.BATCH_SIZE", str(ATTN_BATCH), "MODEL.FUSED_MBCONV", str(fused)))
        cfg = load_cfg(args)
        _check_attn_geometry(cfg)
        if fused:
            _seeded_checkpoint("eval_attn", cfg, pth)
        tester = test_cli.make_tester(cfg, load_json(args.config_path), logger=logger)
        forwards = []
        hook = tester.segmentor.register_forward_hook(
            lambda mod, inp, out: forwards.append(tuple(inp[0].shape)))
        torch.cuda.synchronize()
        mbconv.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        summary = tester.test()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = mbconv.KERNEL_LAUNCHES
        hook.remove()
        want = [(ATTN_BATCH, 3, ATTN_SIZE, ATTN_SIZE)] * (ATTN_EVAL_IMAGES // ATTN_BATCH)
        if forwards != want:
            raise AssertionError(f"eval forwards {forwards}, want {want}")
        expected = MBCONV_LAUNCHES_PER_FORWARD * len(forwards) if fused else 0
        if launches != expected:
            raise AssertionError(f"fused_mbconv_fwd launched {launches} times over "
                                 f"{len(forwards)} forwards with FUSED_MBCONV {fused}; "
                                 f"want {expected}")
        scalars = [v for v in summary.values() if isinstance(v, float)]
        if not scalars or not all(np.isfinite(scalars)) or not 0 < summary["micro_miou"] <= 1:
            raise AssertionError(f"summary {summary}")
        cmt = tester.confusion
        written = load_json(os.path.join(out_dir, "attn_confusion_matrix.json"))
        if cmt.sum() != ATTN_EVAL_IMAGES * ATTN_SIZE ** 2 or written["cmt"] != cmt.tolist():
            raise AssertionError(f"confusion matrix {cmt.tolist()} / file {written}")
        x = torch.rand(ATTN_BATCH, 3, ATTN_SIZE, ATTN_SIZE, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))
        forward_ms = host_ms(
            lambda: tester._probs_impl(x, (ATTN_SIZE, ATTN_SIZE)).sum().item())
        # the same forward replayed from a CUDA graph: device time with no host in the way
        device_ms = graph_ms(lambda: tester._probs_impl(x, (ATTN_SIZE, ATTN_SIZE)),
                             reps=2, replays=5)
        log(f"[eval_attn] FUSED_MBCONV {fused} on {card}: {ATTN_EVAL_IMAGES} images in "
            f"{len(forwards)} batches of {ATTN_BATCH} at {ATTN_SIZE}x{ATTN_SIZE}, "
            f"{launches} fused_mbconv_fwd launches"
            f"{f' = {MBCONV_LAUNCHES_PER_FORWARD} x {len(forwards)} forwards' if fused else ''}"
            f"; first pass {wall * 1e3:.0f} ms ({ATTN_EVAL_IMAGES / wall:.1f} images/s, "
            f"loader and warm-up included); forward of {ATTN_BATCH} alone "
            f"{forward_ms:.1f} ms on the host's clock, {device_ms:.2f} ms of device time "
            f"(CUDA graph replay); micro mIoU {summary['micro_miou']:.4f}, macro mIoU "
            f"{summary['macro_miou']:.4f}, confusion matrix {cmt.tolist()}")
        runs[fused] = (cmt, summary, launches)
    moved = int(np.abs(runs[True][0] - runs[False][0]).sum()) // 2
    limit = int(MAX_TIE_SHARE * ATTN_EVAL_IMAGES * ATTN_SIZE ** 2)
    log(f"[eval_attn] fused vs unfused confusion matrices: {moved} pixels moved "
        f"(at most {limit}: ties at float32 precision)")
    if moved > limit:
        raise AssertionError(f"fused and unfused eval disagree on {moved} pixels")
    return runs[True][2]


def phase_serve_attn(tmp: str, card: str) -> int:
    pth = os.path.join(tmp, "Attn-seeded-serve.pth")
    args = build_parser().parse_args(
        ["--max-batch", str(MAX_BATCH)]
        + _attn_opts(tmp, pth, "MODEL.FUSED_MBCONV", "True"))
    cfg = load_cfg(args)
    _check_attn_geometry(cfg)
    _seeded_checkpoint("serve_attn", cfg, pth)
    inf, bodies, masks, batches, launches, wall = serve_traffic(
        "serve_attn", cfg, args, load_json(args.config_path), ATTN_SIZE, ATTN_SIZE, card,
        (mbconv, "KERNEL_LAUNCHES"))
    if launches != MBCONV_LAUNCHES_PER_FORWARD * batches or launches == 0:
        raise AssertionError(f"fused_mbconv_fwd launched {launches} times for {batches} "
                             f"batches; want {MBCONV_LAUNCHES_PER_FORWARD} per batch")
    log(f"[serve_attn] fused_mbconv_fwd launches: {launches} = "
        f"{MBCONV_LAUNCHES_PER_FORWARD} x {batches} batches")
    x = serve_breakdown("serve_attn", inf, bodies, masks, ATTN_SIZE, ATTN_SIZE, batches,
                        wall, card)

    # one batch against the same forward through the unfused blocks
    _set_fused(inf.tester, False)
    before = mbconv.KERNEL_LAUNCHES
    probs = inf.tester._probs_impl(x, (ATTN_SIZE, ATTN_SIZE))
    unfused_ms = host_ms(
        lambda: inf.tester._probs_impl(x, (ATTN_SIZE, ATTN_SIZE)).sum().item())
    if mbconv.KERNEL_LAUNCHES != before:
        raise AssertionError("the unfused forward launched the kernel")
    log(f"[serve_attn] unfused forward of {MAX_BATCH} alone {unfused_ms:.1f} ms on {card}")
    _check_agreement("serve_attn", "unfused forward", probs, masks)
    return launches


ATTENTION_PARAMS = ("query_conv.weight", "key_conv.weight", "value_conv.weight", "gamma")


def _one_step_grads(segmentor, loss_fn, x, label):
    segmentor.zero_grad(set_to_none=True)
    outputs, _ = segmentor(x, train=True)
    loss = loss_fn(outputs, label)
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {n: p.grad.clone() for n, p in segmentor.named_parameters()}


def _worst_leaf(grads, refs):
    """The largest ||grad - ref|| / ||ref|| over the leaves, with its name.  A
    leaf whose gradient is rounding noise (a conv bias under a batch-statistics
    BN) is held to a floor: 1e-4 of the largest leaf's RMS value."""
    rms = {n: r.float().square().mean().sqrt().item() for n, r in refs.items()}
    floor = 1e-4 * max(rms.values())
    worst, worst_name = 0.0, ""
    for name, ref in refs.items():
        err = (grads[name] - ref).float().square().mean().sqrt().item()
        rel = err / max(rms[name], floor)
        if rel > worst:
            worst, worst_name = rel, name
    return worst, worst_name


def phase_train(tmp: str, card: str):
    from rnd_semantic_segmentation_torch.train.steps import make_family_loss

    out_dir = os.path.join(tmp, "train")
    opts = ["-cfg", os.path.join(HERE, "configs", "gald_src.yaml"),
            "DATASETS.SOURCE_TRAIN", "synthetic_train",
            "DATASETS.SYNTHETIC_LENGTH", str(TRAIN_BATCH * TRAIN_STEPS),
            "SOLVER.EPOCHS", "1", "SOLVER.CHECKPOINT_PERIOD", "1", "OUTPUT_DIR", out_dir]
    cfg = load_cfg(train_src.build_parser().parse_args(opts))
    geometry = (cfg.MODEL.NAME, cfg.MODEL.NUM_CLASSES, cfg.SOLVER.BATCH_SIZE,
                tuple(cfg.INPUT.SOURCE_INPUT_SIZE_TRAIN))
    if geometry != ("gald_hardnet68", 19, TRAIN_BATCH, (TRAIN_W, TRAIN_H)):
        raise AssertionError(f"configs/gald_src.yaml gives {geometry}")
    logger = _stderr_logger("chip_smoke.train", logging.INFO)

    trainer = train_src.make_trainer("gald", cfg, logger=logger)
    segmentor = trainer.segmentor
    randomize_weights_(segmentor, seed=0)  # gamma 0.7: the attention carries signal
    relation = segmentor.parts["decoder"].long_relation
    attention = {n: p for n, p in relation.named_parameters() if n in ATTENTION_PARAMS}
    if set(attention) != set(ATTENTION_PARAMS):
        raise AssertionError(f"attention parameters {sorted(attention)}")
    before = {n: p.detach().clone() for n, p in attention.items()}
    seen = []
    hook = relation.register_forward_hook(
        lambda mod, inp, out: seen.append(tuple(inp[0].shape)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ccattn.KERNEL_LAUNCHES = ccattn.BWD_KERNEL_LAUNCHES = 0
    trainer.train()
    torch.cuda.synchronize()
    fwd_launches, bwd_launches = ccattn.KERNEL_LAUNCHES, ccattn.BWD_KERNEL_LAUNCHES
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    hook.remove()

    steps = trainer.state.step
    if steps != TRAIN_STEPS or len(trainer.loss_data) != TRAIN_STEPS:
        raise AssertionError(f"{steps} steps taken, want {TRAIN_STEPS}")
    if not all(np.isfinite(trainer.loss_data)):
        raise AssertionError(f"losses {trainer.loss_data}")
    log(f"[train] {steps} steps of batch {TRAIN_BATCH} at {TRAIN_W}x{TRAIN_H}: losses "
        f"{[round(v, 4) for v in trainer.loss_data]}, lr {trainer.lr_data[0]:.3g} -> "
        f"{trainer.lr_data[-1]:.3g}")
    b, c, h, w = seen[0]
    if (b, h, w, max(c // 8, 1), c) != TRAIN_CC_SHAPE or len(seen) != 2 * steps:
        raise AssertionError(f"criss-cross inputs {seen[:2]} x{len(seen)}, want "
                             f"{TRAIN_CC_SHAPE} twice a step")
    if fwd_launches != 2 * steps or bwd_launches != 2 * steps:
        raise AssertionError(f"launches over {steps} steps: forward {fwd_launches}, "
                             f"backward {bwd_launches}; want {2 * steps} each")
    log(f"[train] launches over {steps} steps: cc_attention_fwd {fwd_launches}, "
        f"cc_attention_bwd {bwd_launches} = 2 x steps each, at {TRAIN_CC_SHAPE}")
    for name, p in attention.items():
        grad = 0.0 if p.grad is None else p.grad.abs().max().item()
        moved = (p.detach() - before[name]).abs().max().item()
        log(f"[train]   long_relation.{name}: max |grad| {grad:.3e}, moved {moved:.3e}")
        if not (grad > 0 and moved > 0 and np.isfinite(grad)):
            raise AssertionError(f"long_relation.{name} got no gradient or did not move")

    times = trainer.meters.meters["time"].series[1:]   # the first step warms cuDNN up
    waits = trainer.meters.meters["data"].series[1:]
    step_ms = float(np.median(times)) * 1e3
    log(f"[train] on {card}: {step_ms:.1f} ms/step (median of steps 2..{steps}; first "
        f"step {trainer.meters.meters['time'].series[0] * 1e3:.0f} ms), "
        f"{TRAIN_BATCH / step_ms * 1e3:.2f} images/s, data share of a step "
        f"{sum(waits) / sum(times):.1%}, peak memory {peak_mib:.0f} MiB, float32, TF32 off")

    # one step's gradients: the kernels against the same step with the plain core
    loader = trainer.train_loader
    loader.set_epoch(1)
    sample = next(iter(loader))
    x = torch.from_numpy(sample["image"]).to(trainer.device).permute(0, 3, 1, 2).contiguous()
    label = torch.from_numpy(sample["label"]).to(trainer.device)
    loss_fn = make_family_loss(trainer.spec, cfg.MODEL.NUM_CLASSES, cfg.INPUT.IGNORE_LABEL)
    loss_k, grads_k = _one_step_grads(segmentor, loss_fn, x, label)
    with mock.patch.object(gcpa, "cc_attention_core", ccattn.cc_attention_core_plain):
        before_plain = ccattn.KERNEL_LAUNCHES
        loss_p, grads_p = _one_step_grads(segmentor, loss_fn, x, label)
        if ccattn.KERNEL_LAUNCHES != before_plain:
            raise AssertionError("the plain-core step launched the kernel")
    _, grads_k2 = _one_step_grads(segmentor, loss_fn, x, label)
    worst, worst_name = _worst_leaf(grads_k, grads_p)
    noise, noise_name = _worst_leaf(grads_k2, grads_k)
    log(f"[train] one step, kernels vs plain core: loss {loss_k:.6f} vs {loss_p:.6f}; "
        f"worst gradient leaf {worst_name} off by {worst:.3e} of its norm (tolerance "
        f"{GRAD_TOLERANCE:g}, {len(grads_p)} leaves); the same step twice with the "
        f"kernels differs by {noise:.3e} at {noise_name}")
    if worst > GRAD_TOLERANCE or abs(loss_k - loss_p) > 1e-4 * abs(loss_p):
        raise AssertionError(f"gradients disagree with the plain-core step: {worst_name} "
                             f"{worst}")

    # the checkpoint the trainer wrote loads back into Tester through `resume latest`
    ckpt = os.path.join(out_dir, "Gald-1.pth")
    if not os.path.exists(ckpt):
        raise AssertionError(f"{ckpt} was not written")
    test_cfg = load_cfg(train_src.build_parser().parse_args(opts + ["resume", "latest"]))
    tester = Tester(test_cfg, logger)
    tester._load_checkpoint()
    trained = dict(segmentor.named_parameters())
    for name, p in tester.segmentor.named_parameters():
        if not torch.equal(p, trained[name]):
            raise AssertionError(f"{name} differs between the trainer and {ckpt}")
    probs = tester._probs_impl(x[:1, :, :SERVE_H, :SERVE_W].contiguous(), (SERVE_H, SERVE_W))
    if probs.shape != (1, 19, SERVE_H, SERVE_W) or not torch.isfinite(probs).all():
        raise AssertionError(f"Tester on {ckpt}: probabilities {tuple(probs.shape)}")
    log(f"[train] {ckpt} ({os.path.getsize(ckpt) / 2 ** 20:.0f} MiB) loads into Tester; "
        f"parameters equal the trainer's")
    return fwd_launches, bwd_launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default="", help="comma-separated phases to run "
                        "(development aid: prints no result lines)")
    only = [p for p in parser.parse_args(argv).phases.split(",") if p]
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    if only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            for name in only:
                fn = globals()[f"phase_{name}"]
                fn(tmp, card) if fn.__code__.co_argcount else fn()
                torch.cuda.empty_cache()
        log(f"[done] phases {only} in {time.perf_counter() - t0:.1f} s; no result lines")
        return 0
    fwd = phase_kernels()
    bwd = phase_kernels_bwd()
    mb = phase_kernels_mbconv()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        serve_launches = phase_serve(tmp, card)
        torch.cuda.empty_cache()
        train_fwd_launches, train_bwd_launches = phase_train(tmp, card)
        torch.cuda.empty_cache()
        eval_attn_launches = phase_eval_attn(tmp, card)
        torch.cuda.empty_cache()
        serve_attn_launches = phase_serve_attn(tmp, card)
    kernels = [{
        "name": "cc_attention_fwd", "route": "cuda",
        "source": "rnd_semantic_segmentation_torch/ops/csrc/ccattn_fwd.cu",
        "replaces": "rnd_semantic_segmentation_tpu/ops/ccattn.py:54",
        "launches": serve_launches + train_fwd_launches,
        "launches_serve": serve_launches, "launches_train": train_fwd_launches,
        **fwd[MAIN_CC_SHAPE], "library": "torch.nn.functional.scaled_dot_product_attention "
                                          "over H*W pixels with the criss-cross mask",
        "shape": list(MAIN_CC_SHAPE),
        "at_train_shape": {**fwd[TRAIN_CC_SHAPE], "shape": list(TRAIN_CC_SHAPE)},
    }, {
        "name": "cc_attention_bwd", "route": "cuda",
        "source": "rnd_semantic_segmentation_torch/ops/csrc/ccattn_bwd.cu",
        "replaces": "rnd_semantic_segmentation_tpu/ops/ccattn.py:124",
        "launches": train_bwd_launches, **bwd, "library_ms": None,
        "shape": list(TRAIN_CC_SHAPE),
    }, {
        "name": "fused_mbconv_fwd", "route": "cuda",
        "source": "rnd_semantic_segmentation_torch/ops/csrc/mbconv_fwd.cu",
        "replaces": "rnd_semantic_segmentation_tpu/ops/mbconv.py:113",
        "launches": eval_attn_launches + serve_attn_launches,
        "launches_eval_attn": eval_attn_launches,
        "launches_serve_attn": serve_attn_launches,
        **mb, "library_ms": None,
    }]
    log(f"[done] {time.perf_counter() - t0:.1f} s in all")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
