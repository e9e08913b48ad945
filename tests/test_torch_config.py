"""The port's config tree against the JAX package's, and the port's import
isolation: it must run on a machine without JAX."""

import glob
import os
import subprocess
import sys

import pytest

from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_torch.configs import ConfigError, get_default_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
OVERRIDE = ["MODEL.NUM_CLASSES", "19", "INPUT.INPUT_SIZE_TEST", "(1024, 512)",
            "SOLVER.BASE_LR", "1e-3", "TEST.FLIP_TTA", "true"]


def _without_device(cfg):
    d = cfg.to_dict()
    d["MODEL"].pop("DEVICE")
    return d


def test_defaults_equal_but_for_the_device():
    port, ref = get_default_cfg(), jax_default_cfg()
    assert port.MODEL.DEVICE == "cuda" and ref.MODEL.DEVICE == "tpu"
    assert _without_device(port) == _without_device(ref)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_every_config_merges_to_the_same_tree(path):
    port, ref = get_default_cfg(), jax_default_cfg()
    for cfg in (port, ref):
        cfg.merge_from_file(path)
        cfg.merge_from_list(OVERRIDE)
        cfg.freeze()
    assert _without_device(port) == _without_device(ref)
    with pytest.raises(ConfigError):
        port.MODEL.NAME = "x"


def test_port_and_chip_smoke_import_without_jax():
    """Imports every module of the port and chip_smoke.py in a fresh process
    and checks that neither JAX, flax nor the JAX package came with them."""
    code = (
        "import pkgutil, sys\n"
        "import rnd_semantic_segmentation_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    __import__(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'rnd_semantic_segmentation_tpu'))\n"
        "n = sum(n.startswith(pkg.__name__) for n in sys.modules)\n"
        "print(n, bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 59  # every module was imported
