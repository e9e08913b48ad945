"""Micro-batched HTTP inference server (counterpart of the JAX package's serve/server.py).

Concurrent requests are gathered into one device batch, run through the
``Tester`` probability head the offline eval uses (gald: softmax over the
classes; attn: one sigmoid per class; pranet: a sigmoid min-maxed over the
whole padded bucket, as in the JAX server, so a pranet mask depends on the
rest of its batch), and fanned back out as argmax masks.

Endpoints:
  * ``POST /predict``  image bytes (JPEG/PNG) -> palette-PNG mask
    (``?format=raw`` returns the HxW uint8 class-id PNG without a palette)
  * ``GET  /healthz``  readiness (200 once every batch bucket has run once)
  * ``GET  /stats``    request/batch counters incl. mean batch occupancy

Design notes:
  * one dispatcher thread owns the device; handler threads only enqueue and
    wait.
  * batch shapes are power-of-two buckets up to ``max_batch``: a batch is
    padded to the smallest bucket that fits, so the host->device copy scales
    with occupancy; every bucket runs once before /healthz turns ready.
  * the argmax and the uint8 cast run on the device, and only the occupied
    rows are copied back.
  * preprocessing reuses the family's test ``Augmenter`` transform.
  * Pillow decodes and encodes the images; it is imported where it is used.
  * ``TEST.QUANT`` (serve/quant.py): the geometry half of ``auto`` resolves
    at construction (the serving shape is fixed); the activation scales are
    calibrated on the first real batch (the warmup's zeros would calibrate
    nothing), with the Tester's accuracy policy; until then the server
    answers in float32 and reports ``pending-calibration``.  The dispatcher
    thread enters the quant scope itself: a new thread starts outside the
    constructing thread's ``contextvars`` context.  ``/stats``, ``/healthz``
    and the startup log give the resolved mode.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

__all__ = ["InferenceServer", "Overloaded", "make_server", "serve_forever"]


class Overloaded(RuntimeError):
    """Queue full — the HTTP layer maps this to 429."""


class _Pending:
    __slots__ = ("image", "event", "pred", "error")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.event = threading.Event()
        self.pred: Optional[np.ndarray] = None
        self.error: Optional[str] = None


class InferenceServer:
    def __init__(self, cfg, render: dict, logger, max_batch: int = 8,
                 batch_timeout_ms: float = 5.0, max_queue: int = 0):
        from ..data.augment import Augmenter
        from ..eval.tester import Tester
        from .quant import resolve_mode

        self.cfg = cfg
        self.logger = logger
        self.palette = list(render.get("palette", [])) or None
        self.max_batch = int(max_batch)
        self.batch_timeout = float(batch_timeout_ms) / 1e3
        # backpressure: reject beyond this many queued requests (default 8
        # full batches — bounded latency instead of an unbounded pile-up)
        self.max_queue = int(max_queue) or 8 * self.max_batch
        self.transform = Augmenter(cfg, mode="test",
                                   is_source=False).build_transform()
        self.tester = Tester(cfg, logger)
        self.tester._load_checkpoint()
        h, w = self._shape()
        self._qctx = None
        self._quant_mode = resolve_mode(cfg.TEST.QUANT, area=h * w,
                                        max_area=cfg.TEST.QUANT_MAX_AREA,
                                        device=self.tester.device)
        if cfg.TEST.QUANT != "none" and self._quant_mode == "none":
            logger.info(f"TEST.QUANT={cfg.TEST.QUANT}: {w}x{h} exceeds QUANT_MAX_AREA="
                        f"{cfg.TEST.QUANT_MAX_AREA}; serving float32")
        self._needs_calib = self._quant_mode != "none"

        self._queue: List[_Pending] = []
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self.ready = threading.Event()
        # every stats mutation goes through _count() under this lock
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "batched_images": 0,
                      "errors": 0, "rejected": 0}
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._thread.start()

    # -- preprocessing -------------------------------------------------------
    def preprocess(self, data: bytes) -> np.ndarray:
        from PIL import Image

        from ..data.loader import preprocess_eval_image

        h, w = self._shape()
        image = Image.open(io.BytesIO(data)).convert("RGB")
        if image.size != (w, h):
            # the serving geometry is fixed; resize up front with the same
            # bicubic the test Resize transform uses
            image = image.resize((w, h), Image.BICUBIC)
        return preprocess_eval_image(image, self.transform)

    # -- device loop ---------------------------------------------------------
    def _bucket(self, n: int) -> int:
        """Smallest power-of-two batch bucket >= n (capped at max_batch)."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def _warmup(self):
        h, w = self._shape()
        b = 1
        while True:
            b = self._bucket(b)
            self._run(np.zeros((b, h, w, 3), np.float32))
            if b >= self.max_batch:
                break
            b *= 2
        self.ready.set()
        self.logger.info(f"server warm: batch buckets <= {self.max_batch} @ {h}x{w} "
                         f"on {self.tester.device}, TEST.QUANT={self.cfg.TEST.QUANT} resolved "
                         f"to {self._quant_mode} ({self.quant_state()})")

    def quant_state(self) -> str:
        """The resolved mode being served: ``none``, ``int8`` or ``fake``, or
        ``pending-calibration`` before the first real batch."""
        if self._qctx is not None:
            return self._qctx.mode
        return "pending-calibration" if self._needs_calib else "none"

    def _calibrate(self, x: np.ndarray) -> None:
        """Calibrates on the first real batch x [B,H,W,3] (the dispatcher's)
        through ``Tester.make_quant_context``, with x as its one test batch:
        the Tester's policy (``auto`` serves float32 when the argmax agreement
        stays below the floor after the repair; an explicit mode is honoured
        with a warning) and its ``quant_report``."""
        self.tester.test_loader = [{"image": x}]
        self._qctx = self.tester.make_quant_context()
        self._needs_calib = False
        self.logger.info(f"serving quantization calibrated on the first batch: "
                         f"{self.tester.quant_report}")

    def _shape(self):
        size = self.cfg.INPUT.INPUT_SIZE_TEST
        return int(size[1]), int(size[0])  # (H, W) from (W, H) convention

    def _run(self, x: np.ndarray, n: Optional[int] = None) -> List[np.ndarray]:
        """x [B,H,W,3] float32 -> the first ``n`` argmax maps (default: all),
        under the quant scope, which this (the dispatcher's) thread enters."""
        from .quant import quant_scope

        dev = self.tester.device
        xt = torch.from_numpy(x).to(dev).permute(0, 3, 1, 2).contiguous()
        with quant_scope(self._qctx):
            probs = self.tester._probs_impl(xt, tuple(xt.shape[-2:]))
        preds = probs.argmax(dim=1).to(torch.uint8)
        n = preds.shape[0] if n is None else n
        return list(preds[:n].cpu().numpy())

    def _dispatch_loop(self):
        try:
            self._warmup()
        except Exception as e:  # surface init failures via /healthz and the log
            self.logger.exception(f"server warmup failed: {e}")
            return
        h, w = self._shape()
        while not self._stop.is_set():
            with self._cv:
                while not self._queue and not self._stop.is_set():
                    self._cv.wait(timeout=0.1)
                if self._stop.is_set():
                    return
                deadline = time.monotonic() + self.batch_timeout
                while (len(self._queue) < self.max_batch
                       and time.monotonic() < deadline):
                    self._cv.wait(timeout=max(deadline - time.monotonic(), 0))
                batch = self._queue[:self.max_batch]
                del self._queue[:len(batch)]
            try:
                x = np.zeros((self._bucket(len(batch)), h, w, 3), np.float32)
                for i, p in enumerate(batch):
                    x[i] = p.image
                if self._needs_calib:
                    self._calibrate(x)
                preds = self._run(x, n=len(batch))
                for i, p in enumerate(batch):
                    p.pred = preds[i]
            except Exception as e:  # answer the batch's requests, keep serving
                self.logger.exception("batch failed")
                for p in batch:
                    p.error = str(e)  # counted once per request in predict()
            self._count("batches")
            self._count("batched_images", len(batch))
            for p in batch:
                p.event.set()

    # -- public API ----------------------------------------------------------
    def _count(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    def snapshot_stats(self) -> dict:
        with self._stats_lock:
            return dict(self.stats)

    def predict(self, data: bytes, timeout: float = 60.0) -> np.ndarray:
        self._count("requests")
        try:
            img = self.preprocess(data)
        except Exception:
            self._count("errors")
            raise
        h, w = self._shape()
        if img.shape != (h, w, 3):
            self._count("errors")
            raise ValueError(f"transform produced {img.shape}, want {(h, w, 3)}")
        pending = _Pending(img)
        with self._cv:
            if len(self._queue) >= self.max_queue:
                self._count("rejected")
                raise Overloaded(f"queue full ({self.max_queue} pending)")
            self._queue.append(pending)
            self._cv.notify()
        if not pending.event.wait(timeout):
            self._count("errors")
            raise TimeoutError("prediction timed out")
        if pending.error:
            self._count("errors")
            raise RuntimeError(pending.error)
        return pending.pred

    def encode_png(self, pred: np.ndarray, with_palette: bool = True) -> bytes:
        from PIL import Image

        im = Image.fromarray(np.ascontiguousarray(pred, dtype=np.uint8))  # mode L
        if with_palette and self.palette:
            im.putpalette(self.palette)  # L -> P
        buf = io.BytesIO()
        im.save(buf, format="PNG")
        return buf.getvalue()

    def shutdown(self, timeout: float = 60.0):
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout)


def _make_handler(server: InferenceServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through our logger
            server.logger.info("http: " + fmt % args)

        def _send(self, code, body: bytes, ctype="application/json", headers=()):
            self.send_response(code)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                if server.ready.is_set():
                    self._send(200, json.dumps({"status": "ok",
                                                "quant": server.quant_state()}).encode())
                else:
                    self._send(503, b'{"status": "warming"}')
            elif self.path.startswith("/stats"):
                s = server.snapshot_stats()
                s["mean_batch_occupancy"] = round(
                    s["batched_images"] / max(s["batches"], 1), 3)
                s["ready"] = server.ready.is_set()
                s["model"] = server.cfg.MODEL.NAME
                s["quant"] = server.quant_state()
                self._send(200, json.dumps(s).encode())
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            if not self.path.startswith("/predict"):
                self._send(404, b'{"error": "not found"}')
                return
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            try:
                pred = server.predict(data)
            except Overloaded as e:
                self._send(429, json.dumps({"error": str(e)}).encode(),
                           headers=(("Retry-After", "1"),))
                return
            except Exception as e:  # predict() already counted the error
                self._send(400, json.dumps({"error": str(e)[:300]}).encode())
                return
            raw = "format=raw" in (self.path.split("?", 1) + [""])[1]
            self._send(200, server.encode_png(pred, with_palette=not raw),
                       ctype="image/png")

    return Handler


def make_server(cfg, render, logger, host="127.0.0.1", port=8500, max_batch=8,
                batch_timeout_ms=5.0, max_queue=0):
    """The inference server and its HTTP front end, not yet serving."""
    inf = InferenceServer(cfg, render, logger, max_batch=max_batch,
                          batch_timeout_ms=batch_timeout_ms, max_queue=max_queue)
    return inf, ThreadingHTTPServer((host, port), _make_handler(inf))


def serve_forever(cfg, render, logger, host="127.0.0.1", port=8500,
                  max_batch=8, batch_timeout_ms=5.0):
    inf, httpd = make_server(cfg, render, logger, host, port, max_batch,
                             batch_timeout_ms)
    logger.info(f"serving {cfg.MODEL.NAME} on http://{host}:{port}")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        inf.shutdown()
