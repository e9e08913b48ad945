"""Whole families under the exact conv rewrites, on the CPU in float32:
PraNet (``pranet_res2net50`` at 64 x 64) under MODEL.S2D_MAX_CHANNELS 256,
which takes the narrow Res2Net branch convs and the RFB convs the JAX
docstring names (ops/s2d.py), and GALD (``gald_hardnet68`` at 224 x 224)
under MODEL.S2D_MAX_CHANNELS 64, HarDNet's stem and narrow block convs.

``hold_family`` (shared with tests/test_torch_rewrites.py) fills the JAX
family's variables from a seed, carries them over with the family's bridge,
runs the port's eval forward with the knob off and on, and holds every
output of the knob-on forward within 2e-4 of its largest magnitude of the
knob-off one (the JAX package's whole-model tolerance, tests/test_s2d.py)
and of the JAX forward under the same policy (``s2d_scope`` or
``subpixel_scope``).  It returns the knob's gap and how many convs of each
kind took the rewrite in one forward.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.models.build import build_segmentor as jax_build
from rnd_semantic_segmentation_tpu.ops import s2d as jax_s2d
from rnd_semantic_segmentation_tpu.ops import subpixel as jax_subpixel
from rnd_semantic_segmentation_tpu.train.segmentor import Segmentor as JaxSegmentor

from rnd_semantic_segmentation_torch.ckpt import torch_import as TI
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.models import layers
from rnd_semantic_segmentation_torch.models.build import build_segmentor
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor

torch.set_num_threads(2)  # six test workers share the host's cores

NC = 2
MODEL_REL = 2e-4
BRIDGES = {"pranet": TI.pranet_state_dicts_from_flax, "gald": TI.gald_state_dicts_from_flax,
           "attn": TI.attn_state_dicts_from_flax}


def _randomise(path, leaf, rng):
    name = path[-1].key
    if name == "kernel":
        return (rng.randn(*leaf.shape) * np.sqrt(1.7 / np.prod(leaf.shape[:-1]))).astype(
            np.float32)
    lo, hi = {"bias": (-0.1, 0.1), "scale": (0.25, 0.75), "mean": (-0.2, 0.2),
              "var": (0.5, 1.5), "gamma": (0.7, 0.7)}[name]
    return rng.uniform(lo, hi, leaf.shape).astype(np.float32)


def _port_outputs(name, opts, variables, x):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", name, "MODEL.NUM_CLASSES", str(NC), "MODEL.DEVICE",
                         "cpu", "MODEL.DTYPE", "float32", *opts])
    spec = build_segmentor(cfg)
    sds = BRIDGES[spec.family](variables)
    for part, module in spec.modules.items():
        TI.load_part(module, sds[part], part)
    calls = {"conv2d_s2d": 0, "conv_transpose_subpixel": 0}
    real = {n: getattr(layers, n) for n in calls}

    def counting(n):
        def fn(*a, **k):
            calls[n] += 1
            return real[n](*a, **k)
        return fn

    try:
        for n in calls:
            setattr(layers, n, counting(n))
        with torch.no_grad():
            outs, _ = Segmentor(spec, NC).eval()(
                torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    finally:
        for n, fn in real.items():
            setattr(layers, n, fn)
    return [o.permute(0, 2, 3, 1).numpy() for o in outs], tuple(calls.values())


def hold_family(name, size, knob, value):
    jcfg = jax_default_cfg()
    jcfg.merge_from_list(["MODEL.NAME", name, "MODEL.NUM_CLASSES", str(NC)])
    seg = JaxSegmentor(jax_build(jcfg), NC)
    template = jax.eval_shape(seg.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32))
    rng = np.random.RandomState(1)
    variables = jax.tree_util.tree_map_with_path(lambda p, l: _randomise(p, l, rng), template)
    params = {n: v["params"] for n, v in variables.items()}
    stats = {n: {k: c for k, c in v.items() if k != "params"} for n, v in variables.items()}
    x = np.random.RandomState(2).rand(2, size, size, 3).astype(np.float32)
    scope = (jax_s2d.s2d_scope(int(value)) if knob == "MODEL.S2D_MAX_CHANNELS"
             else jax_subpixel.subpixel_scope(True))
    with scope:  # the policy is read when the forward is traced
        ref = jax.jit(lambda p, s, xx: seg.forward(p, s, xx)[0])(params, stats, jnp.asarray(x))
    off, none = _port_outputs(name, [], variables, x)
    on, counts = _port_outputs(name, [knob, value], variables, x)
    assert none == (0, 0)
    gap = 0.0
    for a, b, r in zip(on, off, ref):
        r = np.asarray(r)
        assert a.shape == r.shape and np.isfinite(a).all()
        scale = np.abs(b).max()
        gap = max(gap, float(np.abs(a - b).max() / scale))
        assert np.abs(a - r).max() <= MODEL_REL * np.abs(r).max(), name
    assert len(on) == len(ref)
    logging.getLogger(__name__).info("%s %s %s: gap %.3g, rewritten %s", name, knob, value,
                                     gap, counts)
    return gap, counts


def test_pranet_under_s2d():
    gap, (s2d_convs, subpixel_convs) = hold_family("pranet_res2net50", 64,
                                                   "MODEL.S2D_MAX_CHANNELS", "256")
    assert s2d_convs > 20 and subpixel_convs == 0 and gap <= MODEL_REL


def test_gald_under_s2d():
    gap, (s2d_convs, subpixel_convs) = hold_family("gald_hardnet68", 224,
                                                   "MODEL.S2D_MAX_CHANNELS", "64")
    assert s2d_convs > 2 and subpixel_convs == 0 and gap <= MODEL_REL
