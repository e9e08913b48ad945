"""The port's deployment export (serve/export.py, cli/export_model.py) on the
CPU: ``torch.export`` programs of the eval head for deeplab (float32 and
int8), GALD (kernel #1's operator), attn with MODEL.FUSED_MBCONV (kernel
#3's operator) and pranet (the batch min-max head), loaded back and held against the ``Tester``'s argmax on the
same batch, which they must equal on every pixel (the same operations on the
same device).  The metadata has the JAX package's keys and values
(``export_eval`` of the JAX package at the same geometry)."""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.eval.tester import Tester as JaxTester
from rnd_semantic_segmentation_tpu.serve.export import export_eval as jax_export_eval

from rnd_semantic_segmentation_torch.ckpt.torch_import import save_reference_checkpoint
from rnd_semantic_segmentation_torch.cli import export_model
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.eval.tester import Tester
from rnd_semantic_segmentation_torch.models.build import randomize_weights_
from rnd_semantic_segmentation_torch.serve import quant as pq
from rnd_semantic_segmentation_torch.serve.export import export_eval, load_exported

torch.set_num_threads(2)  # six test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 2
# (MODEL.NAME, side, classes, more options)
FAMILIES = {"deeplab": ("deeplab_resnet18", 64, 5, ()),
            "gald": ("gald_hardnet68", 224, 3, ()),
            "attn": ("attn_efficientnet-b0", 64, 2, ("MODEL.FUSED_MBCONV", "True")),
            "pranet": ("pranet_res2net50", 64, 2, ())}
OPS = {"gald": "rnd_seg_torch.cc_attention_fwd", "attn": "rnd_seg_torch.fused_mbconv_fwd"}


def _opts(family, tmp):
    name, side, nc, more = FAMILIES[family]
    return ["MODEL.NAME", name, "MODEL.NUM_CLASSES", str(nc), "MODEL.DTYPE", "float32",
            "INPUT.INPUT_SIZE_TEST", f"({side}, {side})", "DATASETS.TEST", "synthetic_val",
            "DATASETS.SYNTHETIC_LENGTH", "2", "TEST.BATCH_SIZE", str(BATCH),
            "DATA_PIPE.NUM_WORKERS", "1", "OUTPUT_DIR", str(tmp),
            "resume", str(tmp / f"{family}.pth"), *more]


def _tester(family, tmp, *more):
    cfg = get_default_cfg()
    cfg.merge_from_list(_opts(family, tmp) + ["MODEL.DEVICE", "cpu", *more])
    tester = Tester(cfg, logging.getLogger("torch_export"))
    tester._load_checkpoint()
    return tester


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_export")
    for i, family in enumerate(FAMILIES):
        cfg = get_default_cfg()
        cfg.merge_from_list(_opts(family, tmp) + ["MODEL.DEVICE", "cpu"])
        seeded = Tester(cfg, logging.getLogger("torch_export"))
        randomize_weights_(seeded.segmentor, seed=30 + i)
        save_reference_checkpoint(seeded.spec.modules, cfg.resume)
    return tmp


def _images(side, seed=0):
    return np.random.RandomState(seed).rand(BATCH, side, side, 3).astype(np.float32)


def _tester_ids(tester, images, qctx=None):
    x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
    with pq.quant_scope(qctx):
        return tester._probs_impl(x, tuple(images.shape[1:3])).argmax(1).numpy()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_export_round_trip_equals_the_tester(family, workdir):
    tester = _tester(family, workdir)
    out = str(workdir / f"exported_{family}")
    meta = export_eval(tester, BATCH, out)
    call, loaded = load_exported(out)
    assert loaded == meta and meta["quant"] == "none" and meta["platforms"] == ["cpu"]
    assert meta["bytes"] == os.path.getsize(out + ".pt2")
    images = _images(FAMILIES[family][1])
    ids = call(images)
    assert ids.dtype == np.int32 and ids.shape == images.shape[:3]
    np.testing.assert_array_equal(ids, _tester_ids(tester, images))
    graph = str(torch.export.load(out + ".pt2").graph)
    for fam, op in OPS.items():
        assert (op in graph) == (fam == family), op


def test_int8_export_holds_the_integer_product(workdir):
    tester = _tester("deeplab", workdir)
    images = _images(64, seed=1)
    qctx = pq.calibrate_segmentor(tester.segmentor, [{"image": images}],
                                  pq.QuantConfig(mode="int8", calib_batches=1))
    out = str(workdir / "exported_deeplab_int8")
    meta = export_eval(tester, BATCH, out, quant_ctx=qctx)
    assert meta["quant"] == "int8"
    graph = str(torch.export.load(out + ".pt2").graph)
    assert graph.count("aten._int_mm") == len(qctx.act_scales) == 19
    call, _ = load_exported(out)
    np.testing.assert_array_equal(call(images), _tester_ids(tester, images, qctx))


def test_metadata_has_the_jax_keys_and_values(workdir):
    tester = _tester("deeplab", workdir)
    meta = export_eval(tester, BATCH, str(workdir / "meta_port"))
    jcfg = jax_default_cfg()
    jcfg.merge_from_list(_opts("deeplab", workdir))

    class _NoLoader:
        batch_size = BATCH

        def __iter__(self):
            return iter(())
    jt = JaxTester(jcfg, _NoLoader(), logging.getLogger("jax_export"))
    jt._load_checkpoint()
    want = jax_export_eval(jt, BATCH, str(workdir / "meta_jax"))
    assert list(meta) == list(want)
    for key in ("model", "num_classes", "input", "input_dtype", "output", "quant",
                "platforms"):
        assert meta[key] == want[key], key


def test_platforms_name_the_traced_device_only(workdir):
    tester = _tester("deeplab", workdir)
    for platforms in (["tpu"], ["cuda"], ["cpu", "tpu"]):
        with pytest.raises(ValueError, match="runs"):
            export_eval(tester, BATCH, str(workdir / "never"), platforms=platforms)
    out = str(workdir / "exported_deeplab")
    if not os.path.exists(out + ".json"):
        export_eval(tester, BATCH, out)
    meta = json.load(open(out + ".json"))
    with open(str(workdir / "tpu.json"), "w") as f:
        json.dump({**meta, "platforms": ["tpu"]}, f)
    with pytest.raises(ValueError, match="tpu"):
        load_exported(str(workdir / "tpu"))


def test_export_cli_quantizes_and_a_fresh_process_loads_it(workdir):
    out = str(workdir / "cli_int8")
    meta = export_model.cli(["-o", out, "--batch", str(BATCH)]
                            + _opts("gald", workdir)
                            + ["MODEL.DEVICE", "cpu", "TEST.QUANT", "int8",
                               "TEST.QUANT_CALIB_BATCHES", "1"])
    assert meta["quant"] == "int8" and meta["input"] == [BATCH, 224, 224, 3]
    graph = str(torch.export.load(out + ".pt2").graph)
    assert "aten._int_mm" in graph and OPS["gald"] in graph
    images = _images(224, seed=2)
    np.save(str(workdir / "images.npy"), images)
    code = ("import sys, numpy as np; "
            "from rnd_semantic_segmentation_torch.serve.export import load_exported; "
            "call, meta = load_exported(sys.argv[1]); "
            "np.save(sys.argv[2], call(np.load(sys.argv[3])))")
    subprocess.run([sys.executable, "-c", code, out, str(workdir / "ids.npy"),
                    str(workdir / "images.npy")], check=True, cwd=REPO, timeout=300,
                   env={**os.environ, "OMP_NUM_THREADS": "2"})
    call, _ = load_exported(out)
    np.testing.assert_array_equal(np.load(str(workdir / "ids.npy")), call(images))
