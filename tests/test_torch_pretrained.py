"""MODEL.WEIGHTS: the port's ``load_pretrained_backbone`` against the JAX
package's, on the CPU in float32.

Each case writes a backbone ``.pth`` in its published layout from seeded
weights (the port's own modules under ``randomize_weights_``, their keys
stripped of the part's prefix), with the keys both loaders skip added
(``fc.``, ``_fc.``, ``num_batches_tracked``, VGG16's ``classifier.``,
HarDNet's ``base.19``).  Both packages start from the same random variables
(a JAX tree, carried to the port by ``*_state_dicts_from_flax``), load the
file, and must then hold equal weights everywhere (exactly: both copy the
file's float32 values) and equal backbone features at 64x64, to 1e-4 of the
reference's largest magnitude (float32 sums in other orders through up to 50
layers).  Then the errors, which must be the JAX loader's, and the trainers:
``Trainer``, ``FadaTrainer`` and the online-distillation student start from
the file, and ``resume`` wins over it.
"""

import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rnd_semantic_segmentation_tpu.ckpt.pretrained import (
    load_pretrained_backbone as jax_load_pretrained_backbone,
)
from rnd_semantic_segmentation_tpu.configs import get_default_cfg as jax_default_cfg
from rnd_semantic_segmentation_tpu.models.build import build_segmentor as jax_build
from rnd_semantic_segmentation_tpu.models.res2net import Res2Net as JaxRes2Net
from rnd_semantic_segmentation_tpu.train.segmentor import Segmentor as JaxSegmentor

from rnd_semantic_segmentation_torch.ckpt import torch_import as TI
from rnd_semantic_segmentation_torch.ckpt.pretrained import load_pretrained_backbone
from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    load_part,
    save_reference_checkpoint,
)
from rnd_semantic_segmentation_torch.cli import train_distill, train_src
from rnd_semantic_segmentation_torch.cli.common import load_cfg
from rnd_semantic_segmentation_torch.configs import get_default_cfg
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_

torch.set_num_threads(2)  # six test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC = 3
SIZE = 64
FEATURE_TOL = 1e-4

# MODEL.NAME -> (the part the file lands in, the prefix of its keys there,
# which of the part's keys the published file holds, the keys it holds that
# both loaders skip, the bridge from JAX variables to the port's parts)
CASES = {
    "deeplab_resnet18": ("feature_extractor", "backbone.", lambda k: True,
                         {"fc.weight": (10, 512), "fc.bias": (10,)},
                         TI.deeplab_state_dicts_from_flax),
    "deeplab_vgg16": ("feature_extractor", "", lambda k: k.startswith("features."),
                      {"classifier.0.weight": (10, 7), "classifier.6.bias": (10,)},
                      TI.deeplab_state_dicts_from_flax),
    "gald_hardnet68": ("encoder", "hardnet.", lambda k: True,
                       {"base.19.3.weight": (10, 1024), "base.19.3.bias": (10,)},
                       TI.gald_state_dicts_from_flax),
    "pranet_res2net50": ("model", "resnet.", lambda k: True,
                         {"fc.weight": (10, 2048), "fc.bias": (10,)},
                         TI.pranet_state_dicts_from_flax),
    "attn_efficientnet-b0": ("encoder", "encoder.", lambda k: True,
                             {"_fc.weight": (10, 1280), "_fc.bias": (10,)},
                             TI.attn_state_dicts_from_flax),
    "attnwrap_efficientnet-b0": ("model", "encoder.encoder.", lambda k: True,
                                 {"_fc.weight": (10, 1280), "_fc.bias": (10,)},
                                 TI.attnwrap_state_dicts_from_flax),
}


def _split(tree, scope):
    return {c: t[scope] for c, t in tree.items() if scope in t}


# MODEL.NAME -> (the port's backbone features, the JAX package's)
FEATURES = {
    "deeplab_resnet18": (lambda m, x: m["feature_extractor"](x),
                         lambda s, v, x: s.modules["feature_extractor"].apply(
                             v["feature_extractor"], x)),
    "deeplab_vgg16": (lambda m, x: m["feature_extractor"](x),
                      lambda s, v, x: s.modules["feature_extractor"].apply(
                          v["feature_extractor"], x)),
    "gald_hardnet68": (lambda m, x: m["encoder"](x),
                       lambda s, v, x: s.modules["encoder"].apply(v["encoder"], x)),
    "pranet_res2net50": (lambda m, x: m["model"].resnet(x),
                         lambda s, v, x: JaxRes2Net().apply(_split(v["model"], "resnet"), x)),
    "attn_efficientnet-b0": (lambda m, x: m["encoder"](x),
                             lambda s, v, x: s.modules["encoder"].apply(v["encoder"], x)),
    "attnwrap_efficientnet-b0": (
        lambda m, x: m["model"].encoder(x),
        lambda s, v, x: jax_build(_jax_cfg("attn_efficientnet-b0")).modules["encoder"].apply(
            _split(v["model"], "encoder"), x)),
}


def _jax_cfg(name, *opts):
    cfg = jax_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", name, "MODEL.NUM_CLASSES", str(NC), *opts])
    return cfg


def _port_cfg(name, *opts):
    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.NAME", name, "MODEL.NUM_CLASSES", str(NC),
                         "MODEL.DEVICE", "cpu", *opts])
    return cfg


def _randomise(path, leaf, rng):
    shape = leaf.shape
    name = path[-1].key
    if name == "kernel":
        return (rng.randn(*shape) * np.sqrt(1.7 / np.prod(shape[:-1]))).astype(np.float32)
    lo, hi = {"bias": (-0.1, 0.1), "scale": (0.5, 1.5), "weight": (0.5, 1.5),
              "mean": (-0.2, 0.2), "var": (0.5, 1.5), "gamma": (0.7, 0.7)}[name]
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _published_file(name, path, *opts, seed=5, wrap=False):
    """The backbone ``.pth`` of case ``name``, from the port's seeded modules;
    returns {file key: tensor} as written (skipped keys included)."""
    part, prefix, held, skipped, _ = CASES[name]
    module = build_segmentor(_port_cfg(name, *opts)).modules[part]
    randomize_weights_(module, seed)
    sd = {k[len(prefix):]: v.clone() for k, v in module.state_dict().items()
          if k.startswith(prefix) and held(k) and "num_batches_tracked" not in k}
    gen = torch.Generator().manual_seed(seed)
    for key, shape in skipped.items():
        sd[key] = torch.randn(shape, generator=gen)
    if "running_mean" in " ".join(sd):
        sd[next(k for k in sd if k.endswith("running_mean"))[:-len("running_mean")]
           + "num_batches_tracked"] = torch.tensor(7)
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}} if wrap else sd,
               path)
    return sd


def _both_from(name, *opts):
    """Equal random starts: the JAX variables and the port's parts."""
    jax_spec = jax_build(_jax_cfg(name, *opts))
    side = 224 if name.startswith("gald") else SIZE  # the GCPA decoder's least input
    shapes = jax.eval_shape(JaxSegmentor(jax_spec, NC).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, side, side, 3), jnp.float32))
    rng = np.random.RandomState(1)
    variables = jax.tree_util.tree_map_with_path(lambda p, l: _randomise(p, l, rng), shapes)
    port_spec = build_segmentor(_port_cfg(name, *opts))
    for part, sd in CASES[name][4](variables).items():
        load_part(port_spec.modules[part], sd, part)
    return jax_spec, variables, port_spec


def _leaves(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name,opts", [
    ("deeplab_resnet18", ()),
    ("deeplab_resnet18", ("MODEL.FREEZE_BN", "True")),
    ("deeplab_vgg16", ()),
    ("gald_hardnet68", ()),
    ("pranet_res2net50", ()),
    ("attn_efficientnet-b0", ()),
    ("attnwrap_efficientnet-b0", ()),
], ids=["deeplab_resnet18", "deeplab_resnet18_frozen", "deeplab_vgg16", "gald_hardnet68",
        "pranet_res2net50", "attn_efficientnet-b0", "attnwrap_efficientnet-b0"])
def test_the_backbone_file_loads_as_in_the_jax_package(name, opts, tmp_path):
    pth = tmp_path / "backbone.pth"
    written = _published_file(name, pth, *opts, wrap=name == "deeplab_resnet18")
    jax_spec, variables, port_spec = _both_from(name, *opts)
    variables = jax_load_pretrained_backbone(
        jax_spec, _jax_cfg(name, "MODEL.WEIGHTS", str(pth), *opts), variables)
    load_pretrained_backbone(port_spec, _port_cfg(name, "MODEL.WEIGHTS", str(pth), *opts),
                             port_spec.modules)

    part, prefix, _, skipped, bridge = CASES[name]
    port_sd = port_spec.modules[part].state_dict()
    for key, value in written.items():  # the file's tensors, skipped keys left out
        if key in skipped or "num_batches_tracked" in key:
            continue
        assert torch.equal(port_sd[prefix + key], value), key
    for part_name, want in bridge(variables).items():  # and everything equals the JAX result
        have = port_spec.modules[part_name].state_dict()
        for key, value in want.items():
            if "num_batches_tracked" not in key:
                assert torch.equal(have[key], value), (part_name, key)

    if opts:
        return  # FREEZE_BN: the frozen buffers above are the whole difference
    x = np.random.RandomState(2).rand(1, SIZE, SIZE, 3).astype(np.float32)
    port_fn, jax_fn = FEATURES[name]
    for module in port_spec.modules.values():
        module.eval()
    with torch.no_grad():
        outs = _leaves(port_fn(port_spec.modules, torch.from_numpy(x.transpose(0, 3, 1, 2))))
    refs = _leaves(jax.jit(lambda v, x: jax_fn(jax_spec, v, x))(variables, jnp.asarray(x)))
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        out, ref = out.permute(0, 2, 3, 1).numpy(), np.asarray(ref)
        assert out.shape == ref.shape and np.isfinite(out).all()
        err, scale = np.abs(out - ref).max(), np.abs(ref).max()
        assert err <= FEATURE_TOL * scale, f"max abs error {err} > {FEATURE_TOL} x {scale}"


@pytest.fixture(scope="module")
def resnet18_start():
    return _both_from("deeplab_resnet18")


def _errors_of(loader, *args):
    try:
        loader(*args)
    except (FileNotFoundError, KeyError, ValueError) as e:
        return type(e)
    return None


@pytest.mark.parametrize("case,want", [
    ("url", FileNotFoundError),
    ("missing", FileNotFoundError),
    ("extra_key", KeyError),
    ("wrong_shape", ValueError),
])
def test_errors_are_the_jax_loaders(case, want, tmp_path, resnet18_start):
    jax_spec, variables, port_spec = resnet18_start
    pth = str(tmp_path / "backbone.pth")
    if case == "url":
        pth = "https://download.pytorch.org/models/resnet18-f37072fd.pth"
    elif case != "missing":
        sd = _published_file("deeplab_resnet18", pth)
        if case == "extra_key":
            sd["layer9.0.conv1.weight"] = torch.zeros(3, 3, 1, 1)
        else:
            sd["layer1.0.conv1.weight"] = torch.zeros(64, 64, 1, 1)
        torch.save(sd, pth)
    before = {k: v.clone() for k, v in port_spec.modules["feature_extractor"].state_dict().items()}
    assert _errors_of(jax_load_pretrained_backbone, jax_spec,
                      _jax_cfg("deeplab_resnet18", "MODEL.WEIGHTS", pth), variables) is want
    assert _errors_of(load_pretrained_backbone, port_spec,
                      _port_cfg("deeplab_resnet18", "MODEL.WEIGHTS", pth),
                      port_spec.modules) is want
    after = port_spec.modules["feature_extractor"].state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())  # nothing written


def test_the_cranet_resnet_reads_the_res2net_layout(tmp_path):
    """pranet_resnet50 reads the file in the Res2Net50-v1b layout, as the JAX
    loader does: the shortcut conv and BN at downsample.1 and .2 land on the
    torchvision shortcut's 0 and 1, and a torchvision file's downsample.0
    (the pool's place there) has no home."""
    spec = build_segmentor(_port_cfg("pranet_resnet50"))
    model = spec.modules["model"]
    jax_spec = jax_build(_jax_cfg("pranet_resnet50"))
    variables = jax.tree.map(lambda l: np.zeros(l.shape, l.dtype), jax.eval_shape(
        JaxSegmentor(jax_spec, NC).init, jax.random.PRNGKey(0),
        jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)))
    sd = {"layer1.0.downsample.1.weight": torch.randn(256, 64, 1, 1),
          "layer1.0.downsample.2.weight": torch.rand(256) + 0.5,
          "layer1.0.downsample.2.bias": torch.randn(256),
          "layer1.0.downsample.2.running_mean": torch.randn(256),
          "layer1.0.downsample.2.running_var": torch.rand(256) + 0.5}
    pth = str(tmp_path / "res2net_layout.pth")
    torch.save(sd, pth)
    load_pretrained_backbone(spec, _port_cfg("pranet_resnet50", "MODEL.WEIGHTS", pth),
                             spec.modules)
    jax_sd = TI.pranet_state_dicts_from_flax(jax_load_pretrained_backbone(
        jax_spec, _jax_cfg("pranet_resnet50", "MODEL.WEIGHTS", pth), variables))["model"]
    for key in ("resnet.layer1.0.downsample.0.weight", "resnet.layer1.0.downsample.1.running_var"):
        assert torch.equal(model.state_dict()[key], jax_sd[key]), key
    assert torch.equal(model.resnet.layer1[0].downsample[0].weight, sd[
        "layer1.0.downsample.1.weight"])
    pth = str(tmp_path / "torchvision_layout.pth")
    torch.save({"layer1.0.downsample.0.weight": torch.randn(256, 64, 1, 1)}, pth)
    for loader, cfg, tree in ((load_pretrained_backbone, _port_cfg, spec.modules),
                              (jax_load_pretrained_backbone, _jax_cfg, variables)):
        with pytest.raises(KeyError):
            loader(spec if loader is load_pretrained_backbone else jax_spec,
                   cfg("pranet_resnet50", "MODEL.WEIGHTS", pth), tree)


def _train_opts(out_dir, *more, config="deeplabv2_r101_src.yaml"):
    return ["-cfg", os.path.join(REPO, "configs", config),
            "MODEL.NAME", "deeplab_resnet18", "MODEL.DEVICE", "cpu",
            "MODEL.NUM_CLASSES", str(NC), "DATASETS.SOURCE_TRAIN", "synthetic_train",
            "DATASETS.SYNTHETIC_LENGTH", "4", "INPUT.SOURCE_INPUT_SIZE_TRAIN", "(32, 32)",
            "SOLVER.BATCH_SIZE", "2", "SOLVER.EPOCHS", "1", "DATA_PIPE.NUM_WORKERS", "1",
            "OUTPUT_DIR", str(out_dir), *more]


def _assert_backbone_is(modules, written):
    sd = modules["feature_extractor"].state_dict()
    for key, value in written.items():
        if not key.startswith("fc.") and "num_batches_tracked" not in key:
            assert torch.equal(sd["backbone." + key], value), key


def test_resume_wins_over_the_backbone_file(tmp_path):
    """The trainer loads MODEL.WEIGHTS before ``resume``: a checkpoint's
    weights are the ones it trains from."""
    cfg = load_cfg(train_src.build_parser().parse_args(_train_opts(tmp_path / "a")))
    first = train_src.make_trainer("deeplab", cfg)
    with torch.no_grad():
        for p in first.segmentor.parameters():
            p.add_(0.5)
    first._save(1, prune=False)
    written = _published_file("deeplab_resnet18", tmp_path / "backbone.pth",
                              "MODEL.FREEZE_BN", "True")
    resumed = train_src.make_trainer("deeplab", load_cfg(train_src.build_parser().parse_args(
        _train_opts(tmp_path / "b", "MODEL.WEIGHTS", str(tmp_path / "backbone.pth"),
                    "resume", str(tmp_path / "a" / "Aspp-1.pth")))))
    want = first.segmentor.state_dict()
    for key, value in resumed.segmentor.state_dict().items():
        assert torch.equal(value, want[key]), key
    fresh = train_src.make_trainer("deeplab", load_cfg(train_src.build_parser().parse_args(
        _train_opts(tmp_path / "c", "MODEL.WEIGHTS", str(tmp_path / "backbone.pth")))))
    _assert_backbone_is(fresh.spec.modules, written)


def test_the_online_student_starts_from_the_backbone_file(tmp_path):
    """``DISTILL.ONLINE``: the student is a ``Trainer`` and loads MODEL.WEIGHTS;
    the teacher comes from DISTILL.TEACHER alone."""
    teacher_spec = build_segmentor(_port_cfg("deeplab_resnet18", "MODEL.FREEZE_BN", "True"))
    for module in teacher_spec.modules.values():
        randomize_weights_(module, 9)
    save_reference_checkpoint(teacher_spec.modules, str(tmp_path / "teacher.pth"))
    written = _published_file("deeplab_resnet18", tmp_path / "backbone.pth",
                              "MODEL.FREEZE_BN", "True")
    cfg = load_cfg(train_distill.build_parser().parse_args(
        _train_opts(tmp_path, "MODEL.WEIGHTS", str(tmp_path / "backbone.pth"),
                    "INPUT.INPUT_SCALES_TRAIN", "(1, 1)", "DISTILL.ONLINE", "True",
                    "DISTILL.TEACHER", str(tmp_path / "teacher.pth"),
                    config="deeplabv2_r101_tgt_self_distill.yaml")))
    trainer = train_distill.make_online_trainer("deeplab_distill", cfg,
                                                logger=logging.getLogger("pretrained"))
    _assert_backbone_is(trainer.spec.modules, written)
    teacher = trainer.teacher.parts["feature_extractor"].state_dict()
    for key, value in teacher_spec.modules["feature_extractor"].state_dict().items():
        assert torch.equal(teacher[key], value), key
