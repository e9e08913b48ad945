"""The port's dataset readers, catalog and host transforms (data/datasets.py,
data/catalog.py, data/augment.py) against the JAX package's, on the CPU.

Every reader runs on small trees in each dataset's on-disk layout, written
into tmp by ``trees.write_dataset_trees`` (the writer of the card's
``data_files`` phase) and, for SYNTHIA and the pseudo-label sets, here.  Both
packages must return the same images and labels (exact, with their dtypes),
the same names and the same order; ``cv2_resize`` and the ``pra`` pipeline
must be exact, the latter from equal seeds: ``random.Random(s)`` in the port
against ``random.seed(s)`` in the JAX package.
"""

import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.data import augment as jax_augment
from rnd_semantic_segmentation_tpu.data.catalog import DatasetCatalog as JaxCatalog
from rnd_semantic_segmentation_tpu.data.catalog import build_dataset as jax_build_dataset

from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.data import (
    Augmenter,
    DatasetCatalog,
    build_dataset,
    cv2_resize,
    default_collate,
)
from rnd_semantic_segmentation_torch.data import augment as port_augment
from rnd_semantic_segmentation_torch.data import datasets as port_datasets
from rnd_semantic_segmentation_torch.data import trees

torch.set_num_threads(2)  # six test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f for f in os.listdir(os.path.join(REPO, "configs")) if f.endswith(".yaml"))
TREES = {"gta5": (3, 2, (40, 24)), "cityscapes": (3, 2, (48, 24)),
         "kvasir": (5, 2, ((20, 16), (44, 36))), "bli": (3, 2, ((20, 16), (44, 36)))}
SIZES = ["INPUT.SOURCE_INPUT_SIZE_TRAIN", "(32, 24)", "INPUT.TARGET_INPUT_SIZE_TRAIN",
         "(28, 20)", "INPUT.INPUT_SIZE_TEST", "(36, 28)", "INPUT.TRAINSIZE", "24"]


def _cfgs(root, *opts):
    out = []
    for make in (get_default_cfg, jax_default_cfg):
        cfg = make()
        cfg.merge_from_list(["DATASETS.DATASET_DIR", str(root), "PSEUDO_DIR",
                             str(root / "pseudo"), *SIZES, *opts])
        out.append(cfg)
    return out


def _write_synthia(root, rng, n=4):
    """SYNTHIA-RAND-CITYSCAPES: RGB/ and GT/LABELS/ (ids in channel 0 of a
    3-channel label), and a list file that leaves one image out."""
    for i in range(n):
        image, label = trees.scene(rng, (30, 20), list(range(23)), 0)
        for sub, arr in (("RGB", image), ("GT/LABELS", np.stack([label] * 3, -1))):
            os.makedirs(root / "synthia" / sub, exist_ok=True)
            Image.fromarray(arr).save(root / "synthia" / sub / f"{i:07d}.png")
    (root / "synthia_train_list.txt").write_text(
        "".join(f"{i:07d}.png\n" for i in range(n) if i != 1))


def _write_pseudo_labels(label_dir, names, shape, rng, ids):
    os.makedirs(label_dir, exist_ok=True)
    for name in names:
        pred = rng.choice(ids, size=shape).astype(np.uint8)
        img = Image.fromarray(pred).convert("P")
        img.putpalette([7 * i % 256 for i in range(768)])
        img.save(os.path.join(label_dir, name + ".png"))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    trees.write_dataset_trees(str(root), seed=3, trees=TREES)
    rng = np.random.RandomState(5)
    _write_synthia(root, rng)
    city = root / "cityscapes" / "leftImg8bit" / "train" / trees.CITY
    names = sorted(p[:-4] for p in os.listdir(city))
    _write_pseudo_labels(root / "cityscapes" / "soft_labels" / "inference" / "cityscapes_train",
                         names, (24, 48), rng, [0, 3, 18, 19, 40])
    _write_pseudo_labels(root / "pseudo" / "inference" / "synthetic_val",
                         [f"synthetic_{i:05d}" for i in range(3)], (24, 32), rng, [0, 1, 7])
    return root


def _assert_same_items(port_ds, jax_ds):
    assert type(port_ds).__name__ == type(jax_ds).__name__
    assert port_ds.image_paths == jax_ds.image_paths and len(port_ds) == len(jax_ds) > 0
    for i in range(len(jax_ds)):
        got, ref = port_ds[i], jax_ds[i]
        assert got[2] == ref[2]
        for a, b in zip(got[:2], ref[:2]):
            assert type(a) is np.ndarray and a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    return [port_ds[i] for i in range(len(port_ds))]


@pytest.mark.parametrize("name,mode,aug,opts", [
    ("gta5_train", "train", "gald", ()),
    ("gta5_val", "test", "gald", ()),
    ("gta5_train", "train", "gald", ("DATASETS.CROSS_VAL", "1")),
    ("cityscapes_train", "train", "gald", ()),
    ("cityscapes_val", "test", "aspp", ()),
    ("cityscapes_val", "val", "gald", ("MODEL.NUM_CLASSES", "16")),
    ("cityscapes_self_distill_train", "train", "gald", ()),
    ("kvasir_train", "train", "gald", ()),
    ("kvasir_val", "test", "gald", ()),
    ("polyp_train", "train", "none", ()),
    ("polyp_val", "test", "attn", ()),
    ("bli_train", "train", "none", ()),
    ("bli_val", "test", "attn", ()),
    ("synthia_train", "train", "gald", ("MODEL.NUM_CLASSES", "16")),
    ("synthetic_self_distill_train", "train", "gald", ("DATASETS.SYNTHETIC_LENGTH", "3")),
], ids=lambda v: v if isinstance(v, str) else "-".join(v) or "defaults")
def test_each_reader_returns_what_the_jax_one_returns(root, name, mode, aug, opts):
    key = "DATASETS.SOURCE_TRAIN" if mode == "train" else "DATASETS.TEST"
    cfg, jcfg = _cfgs(root, key, name, "AUG.NAME", aug, *opts)
    items = _assert_same_items(build_dataset(cfg, mode), jax_build_dataset(jcfg, mode))
    images, labels, _ = zip(*items)
    if name.startswith(("gta5", "cityscapes", "synthia")):
        assert all(lb.dtype == np.float32 for lb in labels)
    if name.startswith(("polyp", "bli")):  # resized after the transform, bilinear
        want = (28, 36) if mode == "test" else (24, 32) if name[0] == "p" else (20, 28)
        assert all(im.shape[:2] == lb.shape == want for im, lb in zip(images, labels))
    if name == "cityscapes_val" and aug == "aspp":  # the label keeps its size
        assert images[0].shape == (28, 36, 3) and labels[0].shape == (24, 48)


def test_readers_read_the_layout_and_remap_the_ids(root):
    """What the trees hold: the fold split by the digit in the folder's name,
    the pairing of each image with its label, the remaps."""
    cfg, _ = _cfgs(root, "AUG.NAME", "gald")
    gta_train = DatasetCatalog.get(cfg, "gta5_train", "train", 19, cross_val=0)
    gta_val = DatasetCatalog.get(cfg, "gta5_val", "val", 19, cross_val=0)
    assert len(gta_train) == 3 and len(gta_val) == 2
    assert all("/fold1/" in p for p in gta_train.image_paths)
    assert all("/fold0/" in p for p in gta_val.image_paths)
    raw = np.asarray(Image.open(gta_train.image_paths[0].replace("/images/", "/labels/")))
    _, label, _ = gta_train[0]
    want = np.full(raw.shape, 255, np.float32)
    for k, v in port_datasets.CITYSCAPES_ID_TO_TRAINID.items():
        want[raw == k] = v
    np.testing.assert_array_equal(label, want)
    city = DatasetCatalog.get(cfg, "cityscapes_val", "val", 16)
    assert city.trainid2name == port_datasets.SYNTHIA_TRAINID2NAME
    assert city._label_path(city.image_paths[0]).endswith(
        "gtFine/val/aachen/aachen_000004_000019_gtFine_labelIds.png")
    distill = DatasetCatalog.get(cfg, "cityscapes_self_distill_train", "train", 19)
    assert set(np.unique(distill[0][1])) <= {0, 3, 18, 255}  # 19 and 40 are no train ids
    kvasir = DatasetCatalog.get(cfg, "kvasir_train", "train", 2, cross_val=0)
    assert set(np.unique(kvasir[0][1])) <= {0.0, 1.0} and len(kvasir) == 5


def test_cv2_resize_equals_the_jax_one():
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    mask = (rng.rand(37, 53) > 0.5).astype(np.uint8)
    for img, lab, size in ((image, mask, (64, 48)), (image, None, (20, 30)),
                           (image.astype(np.float32) / 255, mask * 255, (53, 37))):
        got, ref = cv2_resize(img, lab, size), jax_augment.cv2_resize(img, lab, size)
        assert got[0].dtype == ref[0].dtype and got[0].shape == (size[1], size[0], 3)
        np.testing.assert_array_equal(got[0], ref[0])
        if lab is None:
            assert got[1] is None and ref[1] is None
        else:   # bilinear through float32: fractions at the mask's edges
            assert got[1].dtype == ref[1].dtype == np.float32
            np.testing.assert_array_equal(got[1], ref[1])
    assert np.any(cv2_resize(image, mask, (64, 48))[1] % 1 > 0)


class _Recording(random.Random):
    """A ``random.Random`` that keeps what each ``choice`` returned."""

    def __init__(self, seed):
        super().__init__(seed)
        self.drawn = []

    def choice(self, seq):
        value = super().choice(seq)
        self.drawn.append(value)
        return value


@pytest.mark.parametrize("mode", ["train", "test"])
def test_pra_transform_equals_the_jax_one_from_equal_seeds(mode, monkeypatch):
    """Over 16 seeds, three images a seed through one transform, below and
    above the 220 crop: in train mode every flip code and both kinds of crop
    are taken."""
    cfg, jcfg = get_default_cfg(), jax_default_cfg()
    for c in (cfg, jcfg):
        c.merge_from_list(["AUG.NAME", "pra", "INPUT.TRAINSIZE", "40"])
    crops = []
    crop = port_augment._pra_random_crop

    def recording_crop(image, label, rng):
        out = crop(image, label, rng)
        if out[0].shape != image.shape:
            i, j = (image.shape[0] - 220) // 2, (image.shape[1] - 220) // 2
            centre = np.array_equal(out[0], image[i:i + 220, j:j + 220])
            crops.append("centre" if centre else "random")
        return out

    monkeypatch.setattr(port_augment, "_pra_random_crop", recording_crop)
    drawn = set()
    for seed in range(16):
        rng = _Recording(seed)
        ours = Augmenter(cfg, mode, rng=rng).build_transform()
        random.seed(seed)
        theirs = jax_augment.Augmenter(jcfg, mode).build_transform()
        pix = np.random.RandomState(seed)
        for hw in ((50, 70), (260, 300), (230, 221)):  # one stream: the draws' order counts
            image = pix.randint(0, 256, hw + (3,)).astype(np.uint8)
            label = (pix.rand(*hw) > 0.5).astype(np.float32)
            a, b = ours(image, label), theirs(image, label)
            assert a[0].dtype == b[0].dtype == np.float32 and a[0].shape == (40, 40, 3)
            assert a[1].dtype == b[1].dtype and a[1].shape == (40, 40)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
        drawn.update(rng.drawn)
    if mode == "train":
        assert {0, 1, -1, None} <= drawn and {"centre", "random"} <= set(crops)
    else:
        assert not drawn and not crops


def test_bli_mask_name_drops_five_characters_whatever_the_extension(tmp_path):
    """``x.jpeg`` pairs with ``x.png``; ``abcde.jpg`` with ``abcd.png``, a name
    one letter short, in both packages (a fault shared with the JAX package,
    kept)."""
    images, masks = tmp_path / "BLI" / "test" / "images", tmp_path / "BLI" / "test" / "masks"
    os.makedirs(images)
    os.makedirs(masks)
    rng = np.random.RandomState(1)
    for name, mask in (("frame.jpeg", "frame.png"), ("abcde.jpg", "abcd.png"),
                       ("other.JPG", "othe.png")):
        Image.fromarray(rng.randint(0, 256, (12, 16, 3)).astype(np.uint8)).save(
            images / name, format="JPEG")
        Image.fromarray(((rng.rand(12, 16) > 0.5) * 255).astype(np.uint8)).save(masks / mask)
    cfg, jcfg = _cfgs(tmp_path, "DATASETS.TEST", "bli_val", "AUG.NAME", "attn")
    items = _assert_same_items(build_dataset(cfg, "test"), jax_build_dataset(jcfg, "test"))
    assert [name for _, _, name in items] == ["abcd", "frame", "othe"]
    assert port_datasets.BLIDataset.mask_path(str(images / "abcde.jpg")) == str(masks / "abcd.png")
    os.remove(masks / "abcd.png")
    Image.fromarray(np.zeros((12, 16), np.uint8)).save(masks / "abcde.png")
    for ds in (build_dataset(cfg, "test"), jax_build_dataset(jcfg, "test")):
        with pytest.raises(FileNotFoundError):
            ds[0]   # abcde.png is there; the reader looks for abcd.png


def test_a_polyp_batch_through_the_attn_train_transform_is_uint8(root):
    """The uint8/float question of the attn pipeline: Kvasir images decode to
    uint8 and every branch of the transform keeps uint8, so every image of a
    polyp_train batch is uint8 and the collate scales the whole batch to
    [0, 1].  Only the synthetic datasets, whose images are float, mix ranges."""
    cfg, _ = _cfgs(root, "DATASETS.SOURCE_TRAIN", "polyp_train", "AUG.NAME", "attn")
    dataset = build_dataset(cfg, "train")
    for seed in range(6):
        dataset.transform = Augmenter(cfg, "train", rng=random.Random(seed)).build_transform()
        samples = [dataset[i] for i in range(len(dataset))]
        assert all(image.dtype == np.uint8 for image, _, _ in samples)
        batch = default_collate(samples[:4])
        assert batch["image"].dtype == np.float32 and batch["label"].dtype == np.int32
        assert 0.0 <= batch["image"].min() and batch["image"].max() <= 1.0


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: c[:-5])
def test_every_config_dataset_name_resolves_to_the_same_reader(config, tmp_path):
    cfg, jcfg = _cfgs(tmp_path)
    for c in (cfg, jcfg):
        c.merge_from_file(os.path.join(REPO, "configs", config))
    names = {n for n in (cfg.DATASETS.SOURCE_TRAIN, cfg.DATASETS.TARGET_TRAIN,
                         cfg.DATASETS.TEST) if n}
    assert names
    for name in names:
        for mode in ("train", "val"):
            got = DatasetCatalog.get(cfg, name, mode, cfg.MODEL.NUM_CLASSES, cross_val=0)
            ref = JaxCatalog.get(jcfg, name, mode, jcfg.MODEL.NUM_CLASSES, cross_val=0)
            assert type(got).__name__ == type(ref).__name__, name
            assert got.image_paths == ref.image_paths


def test_the_deeplab_kvasir_tpu_recipe_cannot_batch_frames_of_two_sizes_in_either_package(root):
    """configs/deeplabv2_r101_src_kvasir_tpu.yaml reads kvasir_train, whose
    frames keep their own sizes, and under DATA_PIPE.DEVICE_AUG the host's
    aspp stub crops nothing at INPUT_SCALES_TRAIN (1, 1): the collate meets
    frames of two sizes and raises, in both packages (ROADMAP Queue 3, kept
    on purpose; the on-card recipe run writes frames of one size)."""
    from rnd_semantic_segmentation_tpu.data.loader import DataLoader as JaxLoader
    from rnd_semantic_segmentation_tpu.data.loader import build_collate_fn as jax_collate

    from rnd_semantic_segmentation_torch.data import DataLoader, build_collate_fn

    cfgs = []
    for make in (get_default_cfg, jax_default_cfg):
        cfg = make()
        cfg.merge_from_file(os.path.join(REPO, "configs", "deeplabv2_r101_src_kvasir_tpu.yaml"))
        cfg.merge_from_list(["DATASETS.DATASET_DIR", str(root), "DATA_PIPE.NATIVE_DECODE",
                             "False", "MODEL.DEVICE", "cpu"])
        cfgs.append(cfg)
    port, ref = build_dataset(cfgs[0], "train"), jax_build_dataset(cfgs[1], "train")
    assert len({port[i][0].shape for i in range(len(port))}) > 1
    for loader in (DataLoader(port, batch_size=len(port), num_workers=1,
                              collate_fn=build_collate_fn(cfgs[0])),
                   JaxLoader(ref, batch_size=len(ref), num_workers=1,
                             collate_fn=jax_collate(cfgs[1]))):
        with pytest.raises(ValueError, match="same shape"):
            next(iter(loader))


def test_unknown_names_and_native_decode_raise(tmp_path, monkeypatch):
    """Unknown names raise in both packages.  DATA_PIPE.NATIVE_DECODE builds
    a dataset that decodes with the native library, and raises when the
    library cannot be built (here a missing compiler): it never falls back
    to PIL quietly."""
    from rnd_semantic_segmentation_torch.data import native_decode

    cfg, jcfg = _cfgs(tmp_path, "DATASETS.SOURCE_TRAIN", "imagenet_train")
    for catalog, c in ((DatasetCatalog, cfg), (JaxCatalog, jcfg)):
        with pytest.raises(RuntimeError, match="imagenet_train"):
            catalog.get(c, "imagenet_train", "train", 2)
    cfg, _ = _cfgs(tmp_path, "DATASETS.SOURCE_TRAIN", "synthetic_train",
                   "DATA_PIPE.NATIVE_DECODE", "True")
    assert build_dataset(cfg, "train").use_native_decode
    monkeypatch.setattr(native_decode, "_lib", None)
    monkeypatch.setattr(native_decode, "LIBRARY", str(tmp_path / "libsegdata.so"))
    monkeypatch.setattr(native_decode, "CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="NATIVE_DECODE"):
        build_dataset(cfg, "train")
