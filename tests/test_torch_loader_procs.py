"""The port's loader worker processes (data/loader.py: ``_worker_main``,
``_ProcessPool`` and the ``worker_processes`` path of ``DataLoader``) and
data/overlap.py, against the JAX package's, on the CPU.

Two worker processes must give the batches of the thread pool and of the JAX
loader (with threads and with processes), equal arrays in the same order,
over two epochs (the port's workers pass each batch through a file, the JAX
package's through the result queue); a worker's failure, death or silence
must raise in the parent, and ``close()`` must join the workers.
``measure_overlap`` runs on a fake loader under a fake clock, so that both
packages' accounting can be compared exactly.
"""

import os
import signal
import time

import numpy as np
import pytest
import torch

from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.data import overlap as jax_overlap
from rnd_semantic_segmentation_tpu.data.catalog import build_dataset as jax_build_dataset
from rnd_semantic_segmentation_tpu.data.loader import DataLoader as JaxDataLoader

from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.data import DataLoader, build_dataset, overlap, trees
from rnd_semantic_segmentation_torch.data import loader as port_loader

torch.set_num_threads(2)  # six test workers share the host's cores

EPOCHS = (3, 4)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """polyp_train from a small Kvasir tree, identity transform: both
    packages' readers, deterministic."""
    root = tmp_path_factory.mktemp("kvasir")
    trees.write_dataset_trees(str(root), seed=2,
                              trees={"kvasir": (7, 1, ((20, 16), (40, 30)))})
    out = []
    for make, build in ((get_default_cfg, build_dataset), (jax_default_cfg, jax_build_dataset)):
        cfg = make()
        cfg.merge_from_list(["DATASETS.DATASET_DIR", str(root), "DATASETS.SOURCE_TRAIN",
                             "polyp_train", "AUG.NAME", "none",
                             "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(24, 20)"])
        out.append(build(cfg, "train"))
    return out


def _epochs(loader, epochs=EPOCHS):
    batches = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        batches += list(loader)
    return batches


def _assert_same_batches(got, ref):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a["name"] == b["name"] and set(a) == set(b)
        for key in ("image", "label"):
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
            np.testing.assert_array_equal(a[key], b[key])


def test_two_worker_processes_give_the_thread_and_jax_batches_in_order(datasets):
    dataset, jax_dataset = datasets
    kw = dict(batch_size=2, shuffle=True, drop_last=False, num_workers=2, seed=7)
    ref = _epochs(DataLoader(dataset, **kw))
    assert [len(b["name"]) for b in ref[:4]] == [2, 2, 2, 1]
    procs = DataLoader(dataset, worker_processes=2, **kw)
    jax_procs = JaxDataLoader(jax_dataset, worker_processes=2, **kw)
    try:
        _assert_same_batches(_epochs(procs), ref)
        _assert_same_batches(_epochs(JaxDataLoader(jax_dataset, **kw)), ref)
        _assert_same_batches(_epochs(jax_procs), ref)
        # an iteration left after one batch: its batches still in flight are
        # dropped, and the next iteration is whole
        procs.set_epoch(EPOCHS[0])
        next(iter(procs))
        _assert_same_batches(_epochs(procs), ref)
    finally:
        procs.close()
        jax_procs.close()


class _FirstItem:
    """``n`` indices that all read item 0 of ``dataset`` through its train
    transform: the batches differ only by their augmentation draws."""

    def __init__(self, dataset, n):
        self.dataset, self.image_paths = dataset, [str(i) for i in range(n)]

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, i):
        image, label, name = self.dataset[0]
        return image, label, f"{name}-{i}"


def test_each_worker_makes_its_own_augmentation_draws_as_the_jax_workers(tmp_path):
    """polyp_train through the attn train transform, whose draws come from
    ``random``: each worker reseeds it, so two workers' first batches of the
    same item differ, and the batches equal the JAX worker processes'."""
    trees.write_dataset_trees(str(tmp_path), seed=5,
                              trees={"kvasir": (2, 1, ((20, 16), (40, 30)))})
    loaders = []
    for make, build, loader in ((get_default_cfg, build_dataset, DataLoader),
                                (jax_default_cfg, jax_build_dataset, JaxDataLoader)):
        cfg = make()
        cfg.merge_from_list(["DATASETS.DATASET_DIR", str(tmp_path), "DATASETS.SOURCE_TRAIN",
                             "polyp_train", "AUG.NAME", "attn",
                             "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(24, 20)"])
        loaders.append(loader(_FirstItem(build(cfg, "train"), 8), batch_size=1,
                              shuffle=False, worker_processes=2, seed=7))
    try:
        ours, theirs = (list(loader) for loader in loaders)
    finally:
        for loader in loaders:
            loader.close()
    _assert_same_batches(ours, theirs)
    # batches 0, 2, .. come from worker 0 and 1, 3, .. from worker 1
    assert any(not np.array_equal(a["image"], b["image"]) for a, b in zip(ours[::2], ours[1::2]))


class _Items:
    """Four items of 4x4 images; item ``bad`` raises, and every item sleeps
    ``delay`` seconds first."""

    def __init__(self, bad=-1, delay=0.0):
        self.bad, self.delay = bad, delay
        self.image_paths = [str(i) for i in range(4)]

    def __len__(self):
        return 4

    def __getitem__(self, i):
        time.sleep(self.delay)
        if i == self.bad:
            raise ValueError(f"bad item {i}")
        return np.full((4, 4, 3), i, np.uint8), np.zeros((4, 4), np.float32), str(i)


def test_a_failing_getitem_raises_with_the_workers_traceback():
    loader = DataLoader(_Items(bad=2), batch_size=1, shuffle=False, worker_processes=2)
    try:
        with pytest.raises(RuntimeError, match=r"(?s)loader worker failed:.*Traceback.*"
                                               r"ValueError: bad item 2"):
            list(loader)
        assert loader._pool.closed
    finally:
        loader.close()


def test_a_killed_worker_raises(monkeypatch):
    monkeypatch.setattr(port_loader._ProcessPool, "_GET_TIMEOUT_S", 0.2)
    loader = DataLoader(_Items(), batch_size=1, shuffle=False, worker_processes=2)
    try:
        victim = loader._pool._procs[0]
        os.kill(victim.pid, signal.SIGKILL)
        victim.join(timeout=10)
        assert victim.exitcode == -signal.SIGKILL
        with pytest.raises(RuntimeError, match=f"died: pid={victim.pid} exitcode=-9"):
            list(loader)
    finally:
        loader.close()


def test_silent_workers_raise_after_the_stall_limit(monkeypatch):
    monkeypatch.setattr(port_loader._ProcessPool, "_GET_TIMEOUT_S", 0.1)
    monkeypatch.setattr(port_loader._ProcessPool, "_STALL_LIMIT_S", 0.3)
    loader = DataLoader(_Items(delay=1.0), batch_size=1, shuffle=False, worker_processes=1)
    try:
        with pytest.raises(RuntimeError, match="silent"):
            list(loader)
    finally:
        loader.close()


def test_close_joins_the_workers_and_a_new_iteration_forks_again():
    """``close()`` joins the workers and removes the directory the batches
    pass through; the next iteration forks a new pool."""
    loader = DataLoader(_Items(), batch_size=2, shuffle=False, worker_processes=2)
    procs, spill_dir = list(loader._pool._procs), loader._pool._spill_dir
    assert all(p.is_alive() for p in procs)
    next(iter(loader))   # the second batch may wait in its file
    loader.close()
    assert not any(p.is_alive() for p in procs) and [p.exitcode for p in procs] == [0, 0]
    assert not os.path.exists(spill_dir)
    loader.close()  # a second close does nothing
    try:
        batches = list(loader)
        assert [b["name"] for b in batches] == [["0", "1"], ["2", "3"]]
        assert loader._pool._procs[0].pid not in {p.pid for p in procs}
    finally:
        loader.close()


class _Clock:
    """``time.perf_counter`` and ``time.sleep`` of a fake clock."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def sleep(self, seconds):
        self.now += seconds


class _FakeLoader:
    """Batches of ``sizes`` images; fetching batch i takes ``waits[i]`` s."""

    def __init__(self, clock, waits, sizes):
        self.clock, self.waits, self.sizes = clock, waits, sizes

    def __iter__(self):
        for wait, size in zip(self.waits, self.sizes):
            self.clock.now += wait
            yield {"image": np.zeros((size, 2, 2, 3), np.float32), "name": ["x"] * size}


@pytest.mark.parametrize("warmup,max_batches", [(0, None), (1, None), (2, 4)])
def test_measure_overlap_accounts_as_the_jax_one(monkeypatch, warmup, max_batches):
    waits, sizes = [0.9, 0.05, 0.3, 0.0, 0.12, 0.2], [4, 4, 4, 4, 4, 2]
    results = []
    for module in (overlap, jax_overlap):
        clock = _Clock()
        monkeypatch.setattr(time, "perf_counter", clock.perf_counter)
        monkeypatch.setattr(time, "sleep", clock.sleep)
        results.append(module.measure_overlap(_FakeLoader(clock, waits, sizes), 20.0,
                                              max_batches=max_batches,
                                              warmup_batches=warmup))
    assert results[0] == results[1]
    got = results[0]
    counted = slice(warmup, max_batches)
    assert got["batches"] == len(waits[:max_batches])
    assert got["data_wait_s"] == round(sum(waits[counted]), 3)
    assert got["device_busy_s"] == round(sum(sizes[counted]) / 20.0, 3)
    assert got["input_bound"] == (got["device_idle_fraction"] > 0.05)


def test_stage_times_reports_as_the_jax_one(monkeypatch):
    results = []
    for module in (overlap, jax_overlap):
        clock = _Clock()
        monkeypatch.setattr(time, "perf_counter", clock.perf_counter)

        class Items(_Items):
            def __getitem__(self, i):
                clock.now += 0.01 * (i + 1)
                return super().__getitem__(i)

        results.append(module.stage_times(Items(), "none", n=3))
    assert results[0] == results[1] == {"pipeline": "none", "getitem_ms_per_item": 20.0}
