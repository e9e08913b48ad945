"""The port's micro-batched HTTP server (rnd_semantic_segmentation_torch/serve/server.py)
on the CPU, serving GALD at 224x224 with seeded weights.

Served masks are held against the argmax of the JAX package's
``Tester._probs`` on the same images and the same ``.pth``; they must be
equal on every pixel that is not a tie at float32 precision (top-2 JAX
probability gap above 2e-4, twice the probability tolerance of
test_torch_gald.py).
"""

import http.client
import io
import json
import logging
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.eval.tester import Tester as JaxTester

from rnd_semantic_segmentation_torch.ckpt.torch_import import save_reference_checkpoint
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.eval.tester import Tester
from rnd_semantic_segmentation_torch.models.build import randomize_weights_
from rnd_semantic_segmentation_torch.serve.server import (
    InferenceServer,
    ThreadingHTTPServer,
    _make_handler,
)

torch.set_num_threads(2)  # six test workers share the host's cores

SIZE = 224
NC = 3
PALETTE = [0, 0, 0, 255, 0, 0, 0, 255, 0]


def _port_cfg(tmp, *opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", "gald_hardnet68", "MODEL.NUM_CLASSES", str(NC),
                         "MODEL.DEVICE", "cpu", "INPUT.INPUT_SIZE_TEST", f"({SIZE}, {SIZE})",
                         "AUG.NAME", "gald", "OUTPUT_DIR", str(tmp),
                         "resume", str(tmp / "Gald-seeded.pth"), *opts])
    return cfg


def _png(seed):
    arr = (np.random.RandomState(seed).rand(SIZE, SIZE, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return arr, buf.getvalue()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serve")
    cfg = _port_cfg(tmp)
    seeded = Tester(cfg, logging.getLogger("torch_serve"))
    randomize_weights_(seeded.segmentor, seed=7)
    save_reference_checkpoint(seeded.spec.modules, cfg.resume)

    inf = InferenceServer(cfg, {"palette": PALETTE}, logging.getLogger("torch_serve"),
                          max_batch=4, batch_timeout_ms=50.0)
    assert inf.ready.wait(300), "server warmup timed out"
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(inf))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield inf, httpd.server_address[1], cfg
    httpd.shutdown()
    httpd.server_close()
    inf.shutdown()
    t.join(30)
    assert not t.is_alive()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


def _post_all(port, bodies, path="/predict"):
    results = [None] * len(bodies)

    def worker(i):
        results[i] = _request(port, "POST", path, bodies[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(not t.is_alive() for t in threads)
    return results


def test_healthz_stats_and_concurrent_predict(served):
    inf, port, _ = served
    status, _, body = _request(port, "GET", "/healthz")
    assert status == 200 and json.loads(body)["status"] == "ok"
    before = inf.snapshot_stats()

    results = _post_all(port, [_png(i)[1] for i in range(6)])
    for status, ctype, data in results:
        assert status == 200 and ctype == "image/png"
        im = Image.open(io.BytesIO(data))
        assert im.mode == "P" and im.size == (SIZE, SIZE)
        assert np.asarray(im).max() < NC

    status, _, body = _request(port, "GET", "/stats")
    stats = json.loads(body)
    assert status == 200 and stats["ready"] and stats["model"] == "gald_hardnet68"
    assert stats["requests"] == before["requests"] + 6
    assert stats["batched_images"] == before["batched_images"] + 6
    assert before["batches"] < stats["batches"] <= before["batches"] + 6
    assert stats["mean_batch_occupancy"] >= 1.0 and stats["errors"] == 0

    status, ctype, raw = _request(port, "POST", "/predict?format=raw", _png(0)[1])
    assert status == 200 and Image.open(io.BytesIO(raw)).mode == "L"


def test_served_masks_equal_jax_tester_argmax(served):
    inf, port, cfg = served
    arrays, bodies = zip(*(_png(10 + i) for i in range(3)))
    masks = [np.asarray(Image.open(io.BytesIO(data)))
             for status, _, data in _post_all(port, list(bodies), "/predict?format=raw")
             if status == 200]
    assert len(masks) == 3

    jcfg = jax_default_cfg()
    jcfg.MODEL.NAME, jcfg.MODEL.NUM_CLASSES = "gald_hardnet68", NC
    jcfg.OUTPUT_DIR, jcfg.resume = cfg.OUTPUT_DIR, cfg.resume
    x = np.stack(arrays).astype(np.float32) / 255.0

    class _Loader:
        batch_size = len(x)

        def __iter__(self):
            yield {"image": x, "label": np.zeros(x.shape[:3], np.int32)}

    jt = JaxTester(jcfg, _Loader(), logging.getLogger("jax_serve"))
    jt._load_checkpoint()
    probs = np.asarray(jt._probs(jt.variables, jnp.asarray(x), (SIZE, SIZE)))
    top2 = np.sort(probs, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2e-4
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(np.stack(masks)[clear], probs.argmax(-1)[clear])


def test_request_past_max_queue_gets_429(served, monkeypatch):
    inf, port, _ = served
    entered, release = threading.Event(), threading.Event()
    run = inf._run

    def held_run(x, n=None):
        entered.set()
        assert release.wait(120)
        return run(x, n)

    monkeypatch.setattr(inf, "_run", held_run)
    monkeypatch.setattr(inf, "max_queue", 1)
    body = _png(0)[1]
    first = []
    t1 = threading.Thread(target=lambda: first.append(_request(port, "POST", "/predict", body)))
    t1.start()
    assert entered.wait(60)  # the dispatcher holds request 1; the queue is empty
    t2 = threading.Thread(target=lambda: first.append(_request(port, "POST", "/predict", body)))
    t2.start()
    for _ in range(600):  # request 2 waits in the queue
        if len(inf._queue) == 1:
            break
        time.sleep(0.05)
    rejected_before = inf.snapshot_stats()["rejected"]
    status, _, data = _request(port, "POST", "/predict", body)
    release.set()
    t1.join(120)
    t2.join(120)
    assert status == 429 and b"queue full" in data
    assert inf.snapshot_stats()["rejected"] == rejected_before + 1
    assert [r[0] for r in first] == [200, 200]


def test_bad_input_is_a_clean_400(served):
    _, port, _ = served
    status, _, data = _request(port, "POST", "/predict", b"not an image")
    assert status == 400 and b"error" in data


def test_cuda_device_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _port_cfg(tmp_path, "MODEL.DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        Tester(cfg, logging.getLogger("torch_serve"))


def test_quantized_serving_resolves_its_mode_at_construction(served):
    """TEST.QUANT: an unknown mode raises; ``auto`` above QUANT_MAX_AREA
    serves float32 from the start; ``int8`` waits for its first real batch
    to calibrate (tests/test_torch_quant.py serves it)."""
    tmp = Path(served[2].OUTPUT_DIR)
    with pytest.raises(ValueError, match="int4"):
        InferenceServer(_port_cfg(tmp, "TEST.QUANT", "int4"), {},
                        logging.getLogger("torch_serve"))
    for mode, area, state in (("auto", "1024", "none"), ("int8", "0", "pending-calibration")):
        inf = InferenceServer(_port_cfg(tmp, "TEST.QUANT", mode,
                                        "TEST.QUANT_MAX_AREA", area), {},
                              logging.getLogger("torch_serve"), max_batch=1)
        try:
            assert inf.ready.wait(300)
            assert inf.quant_state() == state and inf._qctx is None
        finally:
            inf.shutdown()
