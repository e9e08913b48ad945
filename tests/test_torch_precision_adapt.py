"""A FADA step and an online distillation step in MODEL.DTYPE bfloat16, the
port against the JAX package, on the CPU: ``deeplab_resnet18`` FADA
(FrozenBN, D on the bfloat16 tap, soft labels and losses float32) and
``attn_efficientnet-b0`` online (its teacher in bfloat16 too, without
drop-connect on both sides), under the criterion of
tests/test_torch_precision_steps.py, whose helpers this file shares (a
second file so that the two share the test workers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rnd_semantic_segmentation_tpu.models.build import (
    build_adversarial_discriminator as jax_build_disc,
)
from rnd_semantic_segmentation_tpu.train.distill import (
    make_online_distill_step as jax_make_online_step,
)
from rnd_semantic_segmentation_tpu.train.fada import FadaState, make_fada_train_step as jax_fada
from rnd_semantic_segmentation_tpu.train.state import ModuleState
from rnd_semantic_segmentation_tpu.train.state import make_optimizer as jax_make_optimizer
from rnd_semantic_segmentation_tpu.train.steps import make_optimizers as jax_make_optimizers

from rnd_semantic_segmentation_torch.ckpt.torch_import import (
    attn_flax_from_state_dicts,
    deeplab_flax_from_state_dicts,
    disc_flax_from_state_dict,
)
from rnd_semantic_segmentation_torch.models.build import (
    build_adversarial_discriminator,
    randomize_weights_,
)
from rnd_semantic_segmentation_torch.train.distill import make_online_distill_step
from rnd_semantic_segmentation_torch.train.fada import DISC_PART, make_disc_optimizer, \
    make_fada_train_step
from rnd_semantic_segmentation_torch.train.state import TrainState, make_optimizers

from test_torch_precision_steps import (
    DTYPES,
    STEPS_PER_EPOCH,
    _batch,
    _jax_segmentor,
    _port_segmentor,
    _state_dicts,
    _torch,
    _vector,
    hold,
    jax_cfg,
    port_cfg,
)

torch.set_num_threads(2)  # six test workers share the host's cores


def _port_fada(dtype):
    cfg = port_cfg("deeplab_resnet18", dtype, "MODEL.FREEZE_BN", "True")
    seg = _port_segmentor(cfg)
    disc = randomize_weights_(build_adversarial_discriminator(cfg, seg.spec), seed=11)
    start = _state_dicts(seg)
    dstart = {k: v.clone() for k, v in disc.state_dict().items()}
    state = TrainState(optimizers={**make_optimizers(seg.spec, cfg),
                                   DISC_PART: make_disc_optimizer(disc)})
    src, tgt = _batch(32), _batch(24, seed=10, scale=0.7)
    metrics = make_fada_train_step(seg, disc, cfg, STEPS_PER_EPOCH, state)(
        _torch(src), _torch(tgt), 0.0)
    moved = _vector((p.detach() - start[n][k]).numpy()
                    for n, m in seg.spec.modules.items() for k, p in m.named_parameters())
    return seg, disc, start, dstart, metrics, moved, (src, tgt)


def test_fada_step_in_bfloat16():
    """Both domains cast, D on the bfloat16 tap, soft labels and losses
    float32: the four losses and the segmentor's SGD update."""
    port, ref = {}, {}
    for dtype in DTYPES:
        seg, disc, start, dstart, metrics, moved, (src, tgt) = _port_fada(dtype)
        port[dtype] = dict(metrics, moved=moved)
        jcfg = jax_cfg("deeplab_resnet18", dtype, "MODEL.FREEZE_BN", "True")
        jseg, template = _jax_segmentor(jcfg, 32)
        seg_state = jseg.make_states(deeplab_flax_from_state_dicts(start, template),
                                     jax_make_optimizers(jseg.spec, jcfg))
        jdisc = jax_build_disc(jcfg)
        tap = jnp.zeros((1, 4, 4, disc.D[0].in_channels), jnp.float32)
        dtemplate = jax.eval_shape(lambda r, t: jdisc.init(r, t, size=None),
                                   jax.random.PRNGKey(0), tap)
        dparams = disc_flax_from_state_dict(dstart, dtemplate)["params"]
        tx_d = jax_make_optimizer("adam", betas=(0.9, 0.99))
        state = FadaState(seg=seg_state, disc=ModuleState(params=dparams, stats={},
                                                          opt_state=tx_d.init(dparams)))
        before = [np.asarray(leaf, np.float64) for leaf in jax.tree_util.tree_leaves(
            {n: m.params for n, m in seg_state.modules.items()})]
        new, metrics = jax_fada(jseg, jdisc, jcfg, STEPS_PER_EPOCH)(
            state, {k: jnp.asarray(v) for k, v in src.items()},
            {k: jnp.asarray(v) for k, v in tgt.items()}, jnp.float32(0))
        after = jax.tree_util.tree_leaves({n: m.params for n, m in new.seg.modules.items()})
        ref[dtype] = dict({k: float(v) for k, v in metrics.items()},
                          moved=_vector(np.asarray(a, np.float64) - b
                                        for a, b in zip(after, before)))
    for key in ("loss_seg", "loss_adv_tgt", "loss_D_src", "loss_D_tgt", "moved"):
        hold({d: port[d][key] for d in DTYPES}, {d: ref[d][key] for d in DTYPES}, key)


def test_online_distillation_step_in_bfloat16():
    """The image cast before the teacher's forward (the teacher computes in
    bfloat16), float32 pseudo-labels, the student's Adam step: the loss and
    the update."""
    name, side = "attn_efficientnet-b0", 64
    batch = _batch(side)
    port, ref = {}, {}
    for dtype in DTYPES:
        cfg = port_cfg(name, dtype)
        student = _port_segmentor(cfg)
        teacher = _port_segmentor(cfg, seed=20).eval().requires_grad_(False)
        start, tstart = _state_dicts(student), _state_dicts(teacher)
        state = TrainState(optimizers=make_optimizers(student.spec, cfg))
        loss = make_online_distill_step(student, cfg, STEPS_PER_EPOCH, state, teacher)(
            _torch(batch), 0.0)["loss"]
        moved = _vector((p.detach() - start[n][k]).numpy()
                        for n, m in student.spec.modules.items()
                        for k, p in m.named_parameters())
        port[dtype] = {"loss": loss, "moved": moved}

        jcfg = jax_cfg(name, dtype)
        jseg, template = _jax_segmentor(jcfg, side)
        jstate = jseg.make_states(attn_flax_from_state_dicts(start, template),
                                  jax_make_optimizers(jseg.spec, jcfg))
        tvars = attn_flax_from_state_dicts(tstart, template)
        t_params = {n: v["params"] for n, v in tvars.items()}
        t_stats = {n: {c: t for c, t in v.items() if c != "params"} for n, v in tvars.items()}
        step = jax_make_online_step(jseg, jcfg, STEPS_PER_EPOCH, t_params, t_stats,
                                    base_rng=jax.random.PRNGKey(jcfg.SEED + 1))
        before = [np.asarray(leaf, np.float64) for leaf in jax.tree_util.tree_leaves(
            {n: m.params for n, m in jstate.modules.items()})]
        new, metrics = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                            jnp.float32(0))
        after = jax.tree_util.tree_leaves({n: m.params for n, m in new.modules.items()})
        ref[dtype] = {"loss": float(metrics["loss"]),
                      "moved": _vector(np.asarray(a, np.float64) - b
                                       for a, b in zip(after, before))}
    for key in ("loss", "moved"):
        hold({d: port[d][key] for d in DTYPES}, {d: ref[d][key] for d in DTYPES}, key)
