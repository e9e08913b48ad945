#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (rnd_semantic_segmentation_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU, nvcc and the port's sources; exits non-zero and prints
no result line on any failure.  Phases, each of which raises:

  1. device   the card's name and power limit (nvidia-smi) and torch's view;
  2. build    every CUDA source of the port, one nvcc each, all started at once;
  3. kernels  each kernel against its plain PyTorch version on the card, in
              float32 and bfloat16, at the serving and training shapes and
              more (the backward also against autograd of the plain forward),
              and its time beside its bound and the plain version's time;
  4. serve    the serving path: GALD (HarDNet68 + GCPA-CC, 19 classes, full
              width, seeded weights) behind the port's HTTP server at
              1024x512, 16 PNG requests from 8 threads; kernel launches are
              counted over exactly that traffic, and one batch of masks is
              checked against the same forward with the plain attention core;
  5. train    the training path: the same model through the source-training
              CLI's parser and ``Trainer`` at 1280x720, batch 6, Adam, float32,
              on the synthetic dataset, for 6 steps; forward and backward
              kernel launches are counted over exactly those steps, the
              attention's parameters must receive gradients and move, one
              step's gradients are held against the same step with the plain
              core, and the checkpoint it wrote loads back into ``Tester``.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import http.client
import io
import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch

from rnd_semantic_segmentation_torch.ckpt.torch_import import save_reference_checkpoint
from rnd_semantic_segmentation_torch.cli import train_src
from rnd_semantic_segmentation_torch.cli.common import load_cfg
from rnd_semantic_segmentation_torch.cli.serve import build_parser
from rnd_semantic_segmentation_torch.eval.tester import Tester
from rnd_semantic_segmentation_torch.models import gcpa
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.ops import ccattn, native
from rnd_semantic_segmentation_torch.serve.server import make_server
from rnd_semantic_segmentation_torch.utils import load_json, resolve_device

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; FLOP/s for float32 (no
# tensor cores at full float32 precision) and for bfloat16 (tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}

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


def phase_build() -> None:
    t0 = time.perf_counter()
    built = native.build(ccattn.SOURCES)
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


def phase_kernels_bwd() -> dict:
    result = {}
    for shape in CC_SHAPES[:-1]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = cc_inputs(shape, dtype)
            g = cc_inputs(shape, dtype, seed=1)[2]
            got = ccattn.cc_attention_core_bwd_cuda(q, k, v, g)
            torch.cuda.synchronize()
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
            if shape == TRAIN_CC_SHAPE and dtype == torch.float32:
                result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by}
    return result


def phase_kernels() -> dict:
    result = {}
    for shape in CC_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = cc_inputs(shape, dtype)
            out = ccattn.cc_attention_core(q, k, v)
            torch.cuda.synchronize()
            ref = ccattn.cc_attention_core_plain(q, k, v)
            atol, rtol = TOLERANCE[dtype]
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            ok = bool((diff <= atol + rtol * ref.float().abs()).all()) and out.dtype == dtype
            log(f"[kernel] cc_attention_fwd {shape} {str(dtype)[6:]}: max abs err "
                f"{err:.3e} (tolerance {atol:g} + {rtol:g}*|plain|) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"cc_attention_fwd disagrees with its plain version "
                                     f"at {shape} {dtype}: {err}")
            ms = graph_ms(lambda: ccattn.cc_attention_core(q, k, v))
            plain_ms = graph_ms(lambda: ccattn.cc_attention_core_plain(q, k, v))
            bound_ms, bound_by = cc_bound(shape, dtype)
            log(f"[kernel]   {ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
                f"({bound_by}), plain version {plain_ms * 1e3:.2f} us")
            if shape in (MAIN_CC_SHAPE, TRAIN_CC_SHAPE) and dtype == torch.float32:
                result[shape] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": bound_by}
    return result


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


def phase_serve(tmp: str, card: str) -> int:
    from PIL import Image

    pth = os.path.join(tmp, "Gald-seeded.pth")
    args = build_parser().parse_args([
        "--max-batch", str(MAX_BATCH), "MODEL.NAME", "gald_hardnet68",
        "MODEL.NUM_CLASSES", "19", "INPUT.INPUT_SIZE_TEST", f"({SERVE_W}, {SERVE_H})",
        "AUG.NAME", "gald", "OUTPUT_DIR", tmp, "resume", pth])
    cfg = load_cfg(args)
    spec = build_segmentor(cfg)
    randomize_weights_(torch.nn.ModuleDict(spec.modules), seed=0)
    save_reference_checkpoint(spec.modules, pth)
    log(f"[serve] seeded full-width weights: "
        f"{sum(p.numel() for m in spec.modules.values() for p in m.parameters())} "
        f"parameters -> {pth}")

    logger = logging.getLogger("chip_smoke.serve")
    logger.addHandler(logging.StreamHandler(sys.stderr))
    logger.setLevel(logging.WARNING)
    render = load_json(os.path.join(HERE, "renders", "cityscapes.json"))
    t0 = time.perf_counter()
    inf, httpd = make_server(cfg, render, logger, port=0, max_batch=args.max_batch,
                             batch_timeout_ms=args.batch_timeout_ms)
    port = httpd.server_address[1]
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    try:
        while _get(port, "/healthz")[0] != 200:
            if time.perf_counter() - t0 > 600 or not inf._thread.is_alive():
                raise RuntimeError("server did not become ready")
            time.sleep(0.2)
        log(f"[serve] ready on port {port} after {time.perf_counter() - t0:.1f} s "
            f"(model load + warm-up of buckets 1..{MAX_BATCH} at {SERVE_W}x{SERVE_H})")

        rng = np.random.RandomState(0)
        images = [(rng.rand(SERVE_H, SERVE_W, 3) * 255).astype(np.uint8)
                  for _ in range(N_REQUESTS)]
        bodies = [_png(a) for a in images]
        results = [None] * N_REQUESTS

        def client(i0):
            for i in range(i0, N_REQUESTS, N_THREADS):
                results[i] = _post(port, bodies[i])

        before = inf.snapshot_stats()
        ccattn.KERNEL_LAUNCHES = 0
        t_start = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t_start
        launches = ccattn.KERNEL_LAUNCHES
        after = inf.snapshot_stats()
        if any(t.is_alive() for t in threads):
            raise RuntimeError("requests did not finish")

        masks = []
        for i, (status, data, _) in enumerate(results):
            if status != 200:
                raise AssertionError(f"request {i}: HTTP {status} {data[:200]!r}")
            mask = np.asarray(Image.open(io.BytesIO(data)))
            if mask.shape != (SERVE_H, SERVE_W) or mask.max() >= cfg.MODEL.NUM_CLASSES:
                raise AssertionError(f"request {i}: mask {mask.shape}, max {mask.max()}")
            masks.append(mask)
        batches = after["batches"] - before["batches"]
        served = after["batched_images"] - before["batched_images"]
        status, body = _get(port, "/stats")
        stats = json.loads(body)
        log(f"[serve] {N_REQUESTS} requests from {N_THREADS} threads: {batches} batches, "
            f"{served} images, /stats {stats}")
        if (status != 200 or served != N_REQUESTS or after["errors"] != before["errors"]
                or after["requests"] - before["requests"] != N_REQUESTS):
            raise AssertionError(f"stats disagree with the traffic: {before} -> {after}")
        if launches != 2 * batches or launches == 0:
            raise AssertionError(f"cc_attention_fwd launched {launches} times for "
                                 f"{batches} batches; want 2 per batch")
        log(f"[serve] cc_attention_fwd launches: {launches} = 2 x {batches} batches")

        lat = np.array([r[2] for r in results]) * 1e3
        log(f"[serve] on {card}: request latency p50 {np.percentile(lat, 50):.1f} ms, "
            f"p99 {np.percentile(lat, 99):.1f} ms, {N_REQUESTS / wall:.2f} images/s "
            f"(PNG decode to mask PNG, {N_THREADS} clients, max batch {MAX_BATCH})")
    finally:
        httpd.shutdown()
        httpd.server_close()
        inf.shutdown()
        http_thread.join(60)

    # where a request's time goes: host decode, one full-batch dispatch (copy
    # in, forward, argmax, copy out), the forward alone, and the mask encode
    tester = inf.tester
    batch = np.stack([inf.preprocess(b) for b in bodies[:MAX_BATCH]])
    x = torch.from_numpy(batch).to(tester.device).permute(0, 3, 1, 2).contiguous()
    decode_ms = host_ms(lambda: inf.preprocess(bodies[0]))
    run_ms = host_ms(lambda: inf._run(batch))
    forward_ms = host_ms(lambda: tester._probs_impl(x, (SERVE_H, SERVE_W)).sum().item())
    encode_ms = host_ms(lambda: inf.encode_png(masks[0]))
    log(f"[serve] breakdown on {card}: decode+preprocess {decode_ms:.1f} ms/image, "
        f"dispatch of {MAX_BATCH} {run_ms:.1f} ms (forward alone {forward_ms:.1f} ms), "
        f"palette PNG encode {encode_ms:.1f} ms/mask; {batches} batches x forward "
        f"<= {batches * forward_ms / (wall * 1e3):.0%} of the {wall * 1e3:.0f} ms window")

    # one batch against the same forward with the plain attention core
    with mock.patch.object(gcpa, "cc_attention_core", ccattn.cc_attention_core_plain):
        probs = tester._probs_impl(x, (SERVE_H, SERVE_W))
    if not torch.isfinite(probs).all() or (probs.sum(1) - 1).abs().max() > 1e-4:
        raise AssertionError("plain-core probabilities are not a distribution")
    plain = probs.argmax(1).to(torch.uint8).cpu().numpy()
    agreement = float((plain == np.stack(masks[:MAX_BATCH])).mean())
    log(f"[serve] served masks vs plain-core forward: argmax agreement {agreement:.6f} "
        f"(minimum {MIN_MASK_AGREEMENT})")
    if agreement < MIN_MASK_AGREEMENT:
        raise AssertionError(f"argmax agreement {agreement} < {MIN_MASK_AGREEMENT}")
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
    logger = logging.getLogger("chip_smoke.train")
    logger.addHandler(logging.StreamHandler(sys.stderr))
    logger.setLevel(logging.INFO)

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


def main() -> int:
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    fwd = phase_kernels()
    bwd = phase_kernels_bwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        serve_launches = phase_serve(tmp, card)
        torch.cuda.empty_cache()
        train_fwd_launches, train_bwd_launches = phase_train(tmp, card)
    kernels = [{
        "name": "cc_attention_fwd", "route": "cuda",
        "source": "rnd_semantic_segmentation_torch/ops/csrc/ccattn_fwd.cu",
        "replaces": "rnd_semantic_segmentation_tpu/ops/ccattn.py:54",
        "launches": serve_launches + train_fwd_launches,
        "launches_serve": serve_launches, "launches_train": train_fwd_launches,
        **fwd[MAIN_CC_SHAPE], "library_ms": None,
        "shape": list(MAIN_CC_SHAPE),
        "at_train_shape": {**fwd[TRAIN_CC_SHAPE], "shape": list(TRAIN_CC_SHAPE)},
    }, {
        "name": "cc_attention_bwd", "route": "cuda",
        "source": "rnd_semantic_segmentation_torch/ops/csrc/ccattn_bwd.cu",
        "replaces": "rnd_semantic_segmentation_tpu/ops/ccattn.py:124",
        "launches": train_bwd_launches, **bwd, "library_ms": None,
        "shape": list(TRAIN_CC_SHAPE),
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
