"""DATA_PIPE.NATIVE_DECODE in the port: ``native/segdata.cpp``, unedited,
built into the port's build directory with the JAX package's command, and
bound through ctypes (data/native_decode.py), on this host, which has g++,
libjpeg and libpng.

  * the library's decode equals the JAX ``native_loader``'s bit for bit on a
    PNG and a JPEG, and PIL's on the PNG (and on a grey PNG, its channel
    repeated);
  * a dataset built with NATIVE_DECODE gives the JAX dataset's items (the
    JAX one decoding natively too);
  * a file the library cannot decode (a GIF) goes through PIL and is
    counted;
  * a build that fails (a missing compiler, a source that does not compile)
    raises with the compiler's message, and so does ``build_dataset``: there
    is no quiet fallback to PIL;
  * the batch decoder and the palette writer agree with the JAX bindings
    and with PIL.
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch
from PIL import Image

from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.data import native_loader as jax_native
from rnd_semantic_segmentation_tpu.data.catalog import build_dataset as jax_build_dataset
from rnd_semantic_segmentation_tpu.data.datasets import KvasirDataSet as JaxKvasir

from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.data import build_dataset, native_decode, trees
from rnd_semantic_segmentation_torch.data.datasets import KvasirDataSet

torch.set_num_threads(2)  # six test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREES = {"kvasir": (3, 1, ((20, 16), (44, 36))), "bli": (3, 1, ((20, 16), (44, 36)))}
SIZES = ["INPUT.SOURCE_INPUT_SIZE_TRAIN", "(32, 24)", "INPUT.TARGET_INPUT_SIZE_TRAIN",
         "(28, 20)", "INPUT.INPUT_SIZE_TEST", "(36, 28)", "INPUT.TRAINSIZE", "24"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    trees.write_dataset_trees(str(root), seed=4, trees=TREES)
    return root


def _files(root):
    png = sorted((root / "kvasir" / "fold1" / "images").iterdir())[0]
    mask = sorted((root / "kvasir" / "fold1" / "masks").iterdir())[0]
    jpeg = sorted((root / "BLI" / "train" / "images").iterdir())[0]
    return str(png), str(mask), str(jpeg)


def test_the_library_builds_into_the_ports_build_directory():
    path = native_decode.build_library()
    assert path == native_decode.LIBRARY
    assert os.path.dirname(path).endswith(os.path.join("rnd_semantic_segmentation_torch",
                                                       "build", "segdata"))
    assert os.path.getmtime(path) >= os.path.getmtime(native_decode.SOURCE)
    assert native_decode.load_library() is native_decode.load_library()


def test_decode_equals_the_jax_decoder_and_pil(root):
    png, mask, jpeg = _files(root)
    jax_ds = JaxKvasir(str(root / "kvasir"))
    jax_ds.use_native_decode = True
    assert jax_native.get_lib() is not None  # the JAX package decodes natively too
    for path in (png, jpeg, mask):
        got = native_decode.decode(path)
        assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3
        np.testing.assert_array_equal(got, np.asarray(jax_ds._open_rgb(path)))
    for path in (png, mask):
        np.testing.assert_array_equal(native_decode.decode(path),
                                      np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("name,mode", [("polyp_train", "train"), ("bli_val", "test"),
                                       ("kvasir_train", "train")])
def test_a_native_dataset_gives_the_jax_datasets_items(root, name, mode):
    cfgs = []
    for make in (get_default_cfg, jax_default_cfg):
        cfg = make()
        cfg.merge_from_list(["DATASETS.DATASET_DIR", str(root), "AUG.NAME", "gald",
                             "DATA_PIPE.NATIVE_DECODE", "True", "DATASETS.SOURCE_TRAIN", name,
                             "DATASETS.TEST", name, *SIZES])
        cfgs.append(cfg)
    port = build_dataset(cfgs[0], mode)
    ref = jax_build_dataset(cfgs[1], mode)
    assert port.use_native_decode and ref.use_native_decode
    assert port.image_paths == ref.image_paths and len(port) > 0
    for i in range(len(port)):
        got, want = port[i], ref[i]
        assert got[2] == want[2]
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert port.native_fallbacks == 0


def test_a_file_the_library_refuses_goes_through_pil_and_is_counted(tmp_path):
    rng = np.random.RandomState(0)
    gif = str(tmp_path / "frame.gif")
    Image.fromarray(rng.randint(0, 255, (12, 10, 3), np.uint8)).save(gif)
    assert native_decode.decode(gif) is None
    ds = KvasirDataSet(str(tmp_path))
    ds.use_native_decode = True
    np.testing.assert_array_equal(np.asarray(ds._open_rgb(gif)),
                                  np.asarray(Image.open(gif).convert("RGB")))
    assert ds.native_fallbacks == 1


def test_a_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    source = str(tmp_path / "segdata.cpp")
    shutil.copy(native_decode.SOURCE, source)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native_decode.build_library(str(tmp_path / "a.so"), source, cxx="no-such-compiler")
    broken = str(tmp_path / "broken.cpp")
    with open(broken, "w") as fh:
        fh.write("#include <no_such_header_here.h>\n")
    with pytest.raises(RuntimeError, match="no_such_header_here.h"):
        native_decode.build_library(str(tmp_path / "b.so"), broken)
    # build_dataset under NATIVE_DECODE raises too, never quietly decoding with PIL
    monkeypatch.setattr(native_decode, "_lib", None)
    monkeypatch.setattr(native_decode, "LIBRARY", str(tmp_path / "c.so"))
    monkeypatch.setattr(native_decode, "CXX", "no-such-compiler")
    cfg = get_default_cfg()
    cfg.merge_from_list(["DATASETS.SOURCE_TRAIN", "synthetic_train",
                         "DATA_PIPE.NATIVE_DECODE", "True", *SIZES])
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        build_dataset(cfg, "train")


def test_a_newer_source_is_built_again(tmp_path):
    source = str(tmp_path / "segdata.cpp")
    shutil.copy(native_decode.SOURCE, source)
    lib = str(tmp_path / "lib.so")
    native_decode.build_library(lib, source)
    first = os.path.getmtime(lib)
    native_decode.build_library(lib, source)
    assert os.path.getmtime(lib) == first          # up to date: not rebuilt
    later = time.time() + 5
    os.utime(source, (later, later))
    native_decode.build_library(lib, source)
    assert os.path.getmtime(lib) > first


def test_batch_decoder_and_palette_writer(root, tmp_path):
    png, _, jpeg = _files(root)
    got, ok = native_decode.load_batch([png, jpeg, str(tmp_path / "missing.png")], (16, 12))
    want, want_ok = jax_native.load_batch([png, jpeg, str(tmp_path / "missing.png")], (16, 12))
    np.testing.assert_array_equal(ok, [True, True, False])
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_array_equal(got, want)
    pred = np.random.RandomState(1).randint(0, 3, (9, 13)).astype(np.uint8)
    palette = [0, 0, 0, 255, 0, 0, 0, 255, 0]
    path = str(tmp_path / "pred.png")
    assert native_decode.save_palette_png(path, pred, palette)
    img = Image.open(path)
    assert img.mode == "P" and img.getpalette()[:9] == palette
    np.testing.assert_array_equal(np.asarray(img), pred)
    paths = [str(tmp_path / f"b{i}.png") for i in range(2)]
    ok = native_decode.save_palette_png_batch(paths, np.stack([pred, pred[::-1]]), palette)
    assert ok.all()
    np.testing.assert_array_equal(np.asarray(Image.open(paths[1])), pred[::-1])
