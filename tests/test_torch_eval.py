"""The port's evaluation path (eval/metrics.py, eval/tester.py ``test()``,
cli/test.py) and attn serving, against the JAX package's, on the CPU.

Metrics are integer counts: the port's areas and confusion matrices must
equal the JAX functions' exactly.  The slice as a whole runs
``attn_efficientnet-b0`` at 64x64 on ``synthetic_val`` from one seeded
``.pth``: the port's summary against the JAX ``Tester``'s.  The two forwards
agree to 1e-4 in probability (tests/test_torch_attn.py), so a pixel can only
change class where the two sigmoid outputs are closer than that; the
confusion matrices may differ by that many pixels (counted from the JAX
probabilities) and the summary by the share they make up.  Fused and unfused
evaluation of the port must give the same confusion matrix up to the same
count.
"""

import http.client
import io
import json
import logging
import re
import shutil
import threading

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.data import (
    DataLoader as JaxDataLoader,
    build_collate_fn as jax_collate_fn,
    build_dataset as jax_build_dataset,
)
from rnd_semantic_segmentation_tpu.eval import metrics as jax_metrics
from rnd_semantic_segmentation_tpu.eval.tester import Tester as JaxTester

from rnd_semantic_segmentation_torch.ckpt.torch_import import save_reference_checkpoint
from rnd_semantic_segmentation_torch.cli import test as test_cli
from rnd_semantic_segmentation_torch.cli.common import load_cfg
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.data import Augmenter
from rnd_semantic_segmentation_torch.eval import metrics
from rnd_semantic_segmentation_torch.eval.tester import Tester
from rnd_semantic_segmentation_torch.models import efficientnet
from rnd_semantic_segmentation_torch.models.build import randomize_weights_
from rnd_semantic_segmentation_torch.serve.server import (
    InferenceServer,
    ThreadingHTTPServer,
    _make_handler,
)
from rnd_semantic_segmentation_torch.utils import load_json

torch.set_num_threads(2)  # six test workers share the host's cores

SIZE, NC, IMAGES, BATCH = 64, 2, 6, 2
MODEL = "attn_efficientnet-b0"
TIE = 2e-4  # twice the probability tolerance of tests/test_torch_attn.py
RENDER = {"name": "attn_synthetic", "palette": [0, 0, 0, 255, 255, 255],
          "trainid2name": {"0": "background", "1": "polyp"}}
OPTS = ["MODEL.NAME", MODEL, "MODEL.NUM_CLASSES", str(NC), "AUG.NAME", "attn",
        "AUG.COLLATE", "attn", "INPUT.INPUT_SIZE_TEST", f"({SIZE}, {SIZE})",
        "DATASETS.TEST", "synthetic_val", "DATASETS.SYNTHETIC_LENGTH", str(IMAGES),
        "TEST.BATCH_SIZE", str(BATCH)]


# -- metrics ---------------------------------------------------------------------

@pytest.mark.parametrize("nc,shape,seed", [(2, (3, 17, 13), 0), (19, (2, 32, 24), 1),
                                           (5, (257,), 2)])
def test_areas_and_confusion_matrix_equal_the_jax_functions(nc, shape, seed):
    rng = np.random.RandomState(seed)
    pred = rng.randint(0, nc, shape).astype(np.int32)
    target = rng.randint(0, nc, shape).astype(np.int32)
    target[rng.rand(*shape) < 0.2] = 255
    want = jax_metrics.intersection_and_union(jnp.asarray(pred), jnp.asarray(target), nc, 255)
    got = metrics.intersection_and_union(torch.from_numpy(pred), torch.from_numpy(target),
                                         nc, 255)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (nc,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    inter, union, tgt, out = (g.numpy() for g in got)
    valid = target != 255
    assert tgt.sum() == out.sum() == valid.sum()
    assert inter.sum() == (pred == target)[valid].sum()

    want_cmt = np.asarray(jax_metrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(target),
                                                       nc, 255))
    cmt = metrics.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(target), nc, 255)
    assert cmt.shape == (nc, nc) and cmt.dtype == torch.int64
    np.testing.assert_array_equal(cmt.numpy(), want_cmt)
    np.testing.assert_array_equal(np.diag(cmt.numpy()), inter)  # rows true, cols predicted
    np.testing.assert_array_equal(cmt.numpy().sum(1), tgt)


def test_everything_ignored_and_labels_past_the_last_class():
    pred = torch.tensor([0, 1, 1, 0])
    areas = metrics.intersection_and_union(pred, torch.full((4,), 255), 2, 255)
    assert all(a.sum() == 0 for a in areas)
    assert metrics.confusion_matrix(pred, torch.full((4,), 255), 2, 255).sum() == 0
    # a label of 7 with 2 classes is no class and not the ignore label: like the
    # JAX one-hot it counts in no target area, but the prediction there counts
    target = torch.tensor([0, 7, 1, 255])
    want = jax_metrics.intersection_and_union(jnp.asarray(pred.numpy()),
                                              jnp.asarray(target.numpy()), 2, 255)
    for g, w in zip(metrics.intersection_and_union(pred, target, 2, 255), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_average_meter_summary_key_by_key():
    rng = np.random.RandomState(3)
    port, ref = metrics.AverageMeter(3), jax_metrics.AverageMeter(3)
    for _ in range(4):
        pred = rng.randint(0, 3, (2, 16, 16))
        target = rng.randint(0, 3, (2, 16, 16))
        target[rng.rand(2, 16, 16) < 0.1] = 255
        areas = metrics.intersection_and_union(torch.from_numpy(pred),
                                               torch.from_numpy(target), 3, 255)
        port.update(*torch.stack(areas).numpy())
        ref.update(*jax_metrics.intersection_and_union(jnp.asarray(pred),
                                                       jnp.asarray(target), 3, 255))
    lines = []

    class _Log:
        info = staticmethod(lines.append)
    got, want = port.summary(_Log), ref.summary()
    assert list(got) == list(want) and port.count == 4
    for key in want:
        assert got[key] == want[key], key
    assert len(lines) == 2 + 2 * 3 and lines[0].startswith("Macro metric, val result: mIoU/mF1")
    np.testing.assert_array_equal(port.micro_precision, ref.micro_precision)
    np.testing.assert_array_equal(port.micro_recall, ref.micro_recall)
    port.reset()
    assert port.count == 0 and port.summary()["micro_miou"] == 0.0


# -- the slice as a whole ----------------------------------------------------------

def _port_args(tmp, out_dir, *opts):
    render = tmp / "render.json"
    if not render.exists():
        render.write_text(json.dumps(RENDER))
    return test_cli.build_parser().parse_args(
        ["-c", str(render), *OPTS, "MODEL.DEVICE", "cpu", "OUTPUT_DIR", str(out_dir),
         "resume", str(tmp / "Attn-seeded.pth"), *opts])


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_eval")
    cfg = load_cfg(_port_args(tmp, tmp))
    seeded = Tester(cfg, logging.getLogger("torch_eval"))
    randomize_weights_(seeded.segmentor, seed=11)
    save_reference_checkpoint(seeded.spec.modules, cfg.resume)
    return tmp


@pytest.fixture(scope="module")
def jax_run(workdir):
    """The JAX ``Tester`` on the same ``.pth`` and dataset: its summary, its
    confusion matrix, its probabilities, and the number of pixels whose two
    probabilities are closer than ``TIE``."""
    cfg = jax_default_cfg()
    cfg.merge_from_list(OPTS + ["OUTPUT_DIR", str(workdir / "jax"),
                                "resume", str(workdir / "Attn-seeded.pth")])
    data = jax_build_dataset(cfg, mode="test", is_source=False)
    loader = JaxDataLoader(data, batch_size=BATCH, shuffle=False, drop_last=False,
                           num_workers=1, collate_fn=jax_collate_fn(cfg))
    jt = JaxTester(cfg, loader, logging.getLogger("jax_eval"),
                   trainid2name=RENDER["trainid2name"])
    jt._load_checkpoint()
    summary = jt.test()
    cmt = np.asarray(load_json(str(workdir / "jax" / "attn_confusion_matrix.json"))["cmt"])
    images = np.concatenate([b["image"] for b in loader])
    probs = np.concatenate([
        np.asarray(jt._probs(jt.variables, jnp.asarray(images[i:i + BATCH]), (SIZE, SIZE)))
        for i in range(0, IMAGES, BATCH)])
    ties = int((np.abs(probs[..., 1] - probs[..., 0]) <= TIE).sum())
    assert ties < 0.01 * probs[..., 0].size
    return summary, cmt, images, probs, ties


def _run_cli(workdir, name, *opts):
    args = _port_args(workdir, workdir / name, *opts)
    summary = test_cli.test(load_cfg(args), load_json(args.config_path), args)
    written = load_json(str(workdir / name / "attn_confusion_matrix.json"))
    assert written["classes"] == ["background", "polyp"]
    return summary, np.asarray(written["cmt"])


@pytest.fixture(scope="module")
def port_run(workdir):
    return _run_cli(workdir, "unfused")


def test_cli_test_summary_matches_the_jax_tester(port_run, jax_run):
    summary, cmt = port_run
    jax_summary, jax_cmt, _, _, ties = jax_run
    assert cmt.sum() == jax_cmt.sum() == IMAGES * SIZE * SIZE
    assert cmt.min() > 0  # seeded weights predict both classes, the labels hold both
    assert np.abs(cmt - jax_cmt).sum() <= 2 * ties
    assert list(summary) == list(jax_summary)
    # a pixel that changes class moves an area by 1 of at least cmt.min() pixels
    tol = 4 * (ties + 1) / cmt.min()
    for key, want in jax_summary.items():
        np.testing.assert_allclose(summary[key], want, rtol=0, atol=tol, err_msg=key)
    assert 0 < summary["micro_miou"] < 1 and summary["micro_recall"] > 0


def test_cli_test_fused_equals_unfused(workdir, port_run, jax_run, monkeypatch):
    calls = []
    core = efficientnet.fused_mbconv_core
    monkeypatch.setattr(efficientnet, "fused_mbconv_core",
                        lambda *a: calls.append(a[0].shape[0]) or core(*a))
    summary, cmt = _run_cli(workdir, "fused", "MODEL.FUSED_MBCONV", "True")
    assert calls == [BATCH] * (11 * IMAGES // BATCH)  # 11 eligible blocks in b0, 3 batches
    assert np.abs(cmt - port_run[1]).sum() <= 2 * jax_run[4]
    for key, want in port_run[0].items():
        np.testing.assert_allclose(summary[key], want, rtol=0,
                                   atol=4 * (jax_run[4] + 1) / cmt.min(), err_msg=key)


def test_a_short_last_batch_counts_every_image_once(workdir):
    summary, cmt = _run_cli(workdir, "short", "DATASETS.SYNTHETIC_LENGTH", "5",
                            "TEST.BATCH_SIZE", "4")
    assert cmt.sum() == 5 * SIZE * SIZE and np.isfinite(summary["macro_miou"])


def test_gald_goes_through_the_same_loop(tmp_path):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", "gald_hardnet68", "MODEL.NUM_CLASSES", "3",
                         "MODEL.DEVICE", "cpu", "AUG.NAME", "gald",
                         "INPUT.INPUT_SIZE_TEST", "(224, 224)", "DATASETS.TEST",
                         "synthetic_val", "DATASETS.SYNTHETIC_LENGTH", "2",
                         "TEST.BATCH_SIZE", "2", "OUTPUT_DIR", str(tmp_path),
                         "resume", str(tmp_path / "Gald-seeded.pth")])
    seeded = Tester(cfg, logging.getLogger("torch_eval"))
    randomize_weights_(seeded.segmentor, seed=1)
    save_reference_checkpoint(seeded.spec.modules, cfg.resume)
    tester = test_cli.make_tester(cfg, {}, logger=logging.getLogger("torch_eval"))
    summary = tester.test()
    assert tester.confusion.shape == (3, 3) and tester.confusion.sum() == 2 * 224 * 224
    assert len(summary["per_class_macro_iou"]) == 3
    assert load_json(str(tmp_path / "gald_confusion_matrix.json"))["classes"] == []


def test_what_waits_raises(workdir, monkeypatch):
    log = logging.getLogger("torch_eval")
    cfg = load_cfg(_port_args(workdir, workdir / "raises"))
    with pytest.raises(ValueError, match="palette"):  # --saveres writes palette PNGs
        Tester(cfg, log, saveres=True)
    with pytest.raises(ValueError, match="test_loader"):
        Tester(cfg, log).test()
    quant = load_cfg(_port_args(workdir, workdir / "raises", "TEST.QUANT", "int4"))
    with pytest.raises(ValueError, match="int4"):
        test_cli.make_tester(quant, RENDER, logger=log).test()
    unknown = load_cfg(_port_args(workdir, workdir / "raises", "AUG.NAME", "exotic"))
    with pytest.raises(ValueError, match="exotic"):
        Augmenter(unknown, mode="train").build_transform()
    image = np.zeros((4, 4, 3), np.uint8)
    assert Augmenter(cfg, mode="test").build_transform()(image, None)[0] is image

    # the card is the default device: without one the CLI raises, it does not fall back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _port_args(workdir, workdir / "raises")
    args.opts = [o for o in args.opts if o not in ("MODEL.DEVICE", "cpu")]
    with pytest.raises(RuntimeError, match="is_available"):
        test_cli.test(load_cfg(args), RENDER, args)


def test_empty_resume_loads_the_newest_checkpoint_in_output_dir(workdir, tmp_path):
    """An empty ``resume`` takes the newest ``{Prefix}-N.pth`` in OUTPUT_DIR,
    like ``resume latest``, as the JAX ``Tester`` does: ``cli.test -cfg X``
    and ``cli.serve -cfg X`` after a training run."""
    log = logging.getLogger("torch_eval")
    cfg = load_cfg(_port_args(workdir, tmp_path, "resume", ""))
    assert cfg.resume == ""
    older = Tester(cfg, log)
    randomize_weights_(older.segmentor, seed=12)
    save_reference_checkpoint(older.spec.modules, str(tmp_path / "Attn-2.pth"))
    shutil.copy(workdir / "Attn-seeded.pth", tmp_path / "Attn-10.pth")  # newest by number
    tester = Tester(cfg, log)
    tester._load_checkpoint()
    seeded = Tester(load_cfg(_port_args(workdir, tmp_path)), log)
    seeded._load_checkpoint()
    want = seeded.segmentor.state_dict()
    for name, value in tester.segmentor.state_dict().items():
        assert torch.equal(value, want[name]), name


def test_empty_resume_without_a_checkpoint_raises(workdir, tmp_path):
    cfg = load_cfg(_port_args(workdir, tmp_path, "resume", ""))
    tester = Tester(cfg, logging.getLogger("torch_eval"))
    with pytest.raises(FileNotFoundError, match=rf"Attn-N\.pth .*{re.escape(str(tmp_path))}"):
        tester._load_checkpoint()


# -- serving the attn family ---------------------------------------------------------

def _post_all(port, bodies, path):
    results = [None] * len(bodies)

    def worker(i):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", path, body=bodies[i])
        resp = conn.getresponse()
        results[i] = (resp.status, resp.read())
        conn.close()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(not t.is_alive() for t in threads)
    return results


@pytest.mark.parametrize("fused", ["False", "True"], ids=["unfused", "fused"])
def test_server_answers_attn_requests_with_the_jax_masks(fused, workdir, jax_run):
    _, _, images, probs, _ = jax_run
    # PNGs hold 8 bits: quantise the images, and let the JAX side see the same pixels
    arrays = [(img * 255).round().astype(np.uint8) for img in images[:BATCH]]
    bodies = []
    for arr in arrays:
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        bodies.append(buf.getvalue())
    cfg = load_cfg(_port_args(workdir, workdir / "serve", "MODEL.FUSED_MBCONV", fused))
    inf = InferenceServer(cfg, RENDER, logging.getLogger("torch_eval"), max_batch=BATCH,
                          batch_timeout_ms=50.0)
    assert inf.ready.wait(300), "server warmup timed out"
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(inf))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        port = httpd.server_address[1]
        raw = _post_all(port, bodies, "/predict?format=raw")
        pal = _post_all(port, bodies[:1], "/predict")
    finally:
        httpd.shutdown()
        httpd.server_close()
        inf.shutdown()
        thread.join(30)
    assert [status for status, _ in raw + pal] == [200] * (BATCH + 1)
    masks = np.stack([np.asarray(Image.open(io.BytesIO(data))) for _, data in raw])
    assert masks.shape == (BATCH, SIZE, SIZE) and set(np.unique(masks)) == {0, 1}
    im = Image.open(io.BytesIO(pal[0][1]))
    assert im.mode == "P" and im.getpalette()[:6] == RENDER["palette"]

    jt_cfg = jax_default_cfg()
    jt_cfg.merge_from_list(OPTS + ["OUTPUT_DIR", str(workdir / "jax"),
                                   "resume", str(workdir / "Attn-seeded.pth")])

    class _Loader:
        batch_size = BATCH

        def __iter__(self):
            return iter(())
    jt = JaxTester(jt_cfg, _Loader(), logging.getLogger("jax_eval"))
    jt._load_checkpoint()
    x = np.stack(arrays).astype(np.float32) / 255.0
    ref = np.asarray(jt._probs(jt.variables, jnp.asarray(x), (SIZE, SIZE)))
    clear = np.abs(ref[..., 1] - ref[..., 0]) > TIE
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(masks[clear], ref.argmax(-1)[clear])
    assert np.abs(ref - probs[:BATCH]).max() < 0.1  # 8-bit pixels move the probabilities little
