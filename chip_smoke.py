#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (rnd_semantic_segmentation_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU, nvcc and the port's sources; exits non-zero and prints
no result line on any failure.  Phases, each of which raises:

  1. device   the card's name and power limit (nvidia-smi) and torch's view;
  2. build    every CUDA source of the port, one nvcc each, all started at once;
  3. kernels  each kernel against its plain PyTorch version on the card, in
              float32 and bfloat16, at the serving shapes and more, and its
              time beside its bound and the plain version's time;
  4. serve    the main path: GALD (HarDNet68 + GCPA-CC, 19 classes, full
              width, seeded weights) behind the port's HTTP server at
              1024x512, 16 PNG requests from 8 threads; kernel launches are
              counted over exactly that traffic, and one batch of masks is
              checked against the same forward with the plain attention core.

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
from rnd_semantic_segmentation_torch.cli.common import load_cfg
from rnd_semantic_segmentation_torch.cli.serve import build_parser
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
CC_SHAPES = [(1, 16, 32, 32, 256), (8, 16, 32, 32, 256),   # serving, B in {1, 8}
             (2, 7, 11, 32, 256),                          # rectangular, odd
             (1, 64, 128, 32, 256)]                        # 2048x4096 input
MAIN_CC_SHAPE = (8, 16, 32, 32, 256)
# |kernel - plain| <= atol + rtol*|plain|: float32 sums in another order;
# bfloat16 outputs round to 8 mantissa bits on both sides
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 1e-2)}
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
    built = native.build([ccattn.SOURCE])
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
            if shape == MAIN_CC_SHAPE and dtype == torch.float32:
                result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
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


def main() -> int:
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    timing = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches = phase_serve(tmp, card)
    kernels = [{
        "name": "cc_attention_fwd", "route": "cuda",
        "source": "rnd_semantic_segmentation_torch/ops/csrc/ccattn_fwd.cu",
        "replaces": "rnd_semantic_segmentation_tpu/ops/ccattn.py:54",
        "launches": launches, "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": None,
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
