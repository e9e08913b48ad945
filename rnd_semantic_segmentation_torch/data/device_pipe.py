"""Device-side augmentation (counterpart of the JAX package's data/device_pipe.py).

With ``DATA_PIPE.DEVICE_AUG`` the host keeps only the geometry that needs the
image before the collate (``Augmenter._device_stub``: pra's crop and resize,
aspp's random scale and crop), and the per-pixel work runs on the batch's
device, on NHWC tensors as the loader gives them:

  * ``pra``  -> ``augment_batch_pra``: rot90, flip (codes 0, 1, 2 or none),
    colour jitter (0.2, 0.2, 0.2, 0.1), clip, ImageNet normalisation;
  * ``attn`` -> ``augment_batch_attn``: an outer apply-probability, then
    motion blur, rotation by an angle in [-90, 90] degrees, colour jitter
    (0.2 x 4) and flip (codes 0, 1, 2), each with its own probability;
    clipped to [0, 1], not normalised (the attn family takes [0, 1]);
  * any other ``AUG.NAME`` -> ``augment_batch`` (aspp's): bilinear resize
    (``align_corners=False``; labels nearest, ``floor(i * in / out)``) to the
    domain's train size, horizontal flip, colour jitter (the source domain
    only), clip, ``TO_BGR255``, normalisation.

Each augmenter is split in two.  A draw function (``draw_pra``,
``draw_attn``, ``draw_aspp``) makes every random number of a batch from a
``torch.Generator`` on the batch's device; ``make_device_augmenter`` seeds it
for each call from ``(DATA_PIPE.SEED, step)``, with 7919 added to the seed
for a FADA target stream.  The apply function takes those draws as tensors
(codes, factors, angles, masks) and does the arithmetic, which is the JAX
package's: the tests hand both packages the same draws.  The draws
themselves differ from the JAX package's (a ``torch.Generator`` against
``jax.random`` keys): equal in distribution only.

Semantics kept from the JAX package: flip code 2 is the host's -1 (both
axes); rot90 is ``numpy.rot90`` over the H and W axes; the motion blur
averages wrap-around shifts (``numpy.roll``) over k in {3, 5, 7}; the
rotation is PIL's counter-clockwise turn with y down, bilinear for the
image and nearest for the label, with 0 outside the source for both; the
hue is a rotation in YIQ, not in HSV; the jitter's order is brightness,
contrast, saturation, hue, each factor drawn per image.  The arithmetic is
float32; the output image is cast last to ``dtype`` (float32 by default;
``make_device_augmenter`` passes MODEL.DTYPE, as the JAX augmenter does), and
the label keeps its type.

In a world of more than one process each rank draws for the global batch
(``world`` times its rows) and keeps its own rows (``_rank_draws``), so a
sample's draws do not depend on the number of ranks.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.dist import rank_rows, world_size
from ..utils.device import compute_dtype
from ..utils.seeding import mix_seed

TARGET_SEED_OFFSET = 7919      # a FADA target stream's draws (JAX: PRNGKey(SEED + 7919))
PRA_JITTER = (0.2, 0.2, 0.2, 0.1)
ATTN_JITTER = (0.2, 0.2, 0.2, 0.2)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# (dy, dx) roll steps of the blur's directions: along W, along H, both diagonals
BLUR_DIRECTIONS = ((0, 1), (1, 0), (1, 1), (1, -1))


# -- draws ---------------------------------------------------------------------------

def _uniform(gen, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def _bernoulli(gen, b, p):
    return torch.rand((b,), generator=gen, device=gen.device) < p


def _randint(gen, b, n):
    return torch.randint(0, n, (b,), generator=gen, device=gen.device)


def draw_jitter(gen: torch.Generator, b: int, brightness: float, contrast: float,
                saturation: float, hue: float) -> Dict[str, torch.Tensor]:
    """Per-image factors of ``color_jitter``: brightness, contrast and
    saturation uniform in [max(0, 1 - v), 1 + v] as [B,1,1,1], the hue
    uniform in [-hue, hue] (turns) as [B,1,1]; a knob at 0 draws nothing."""
    out = {}
    for key, v in (("brightness", brightness), ("contrast", contrast),
                   ("saturation", saturation)):
        if v > 0:
            out[key] = _uniform(gen, (b, 1, 1, 1), max(0.0, 1.0 - v), 1.0 + v)
    if hue > 0:
        out["hue"] = _uniform(gen, (b, 1, 1), -hue, hue)
    return out


def draw_pra(gen: torch.Generator, b: int) -> Dict:
    """rot90's k in 0..3, the flip code in 0..3 (3: no flip) and the jitter."""
    return {"rot_k": _randint(gen, b, 4), "flip_code": _randint(gen, b, 4),
            "jitter": draw_jitter(gen, b, *PRA_JITTER)}


def draw_attn(gen: torch.Generator, b: int, prob: float = 0.7, blur_prob: float = 0.7,
              rotate_prob: float = 0.7, jitter_prob: float = 0.7,
              flip_prob: float = 0.7) -> Dict:
    """The outer gate and each op's own coin (``augment_batch_attn`` ands
    them), the blur's direction (0..3) and size code (0..2: k = 3, 5, 7), the
    angle in radians in [-pi/2, pi/2], the jitter, the flip code (0..2)."""
    return {"apply": _bernoulli(gen, b, prob),
            "blur": _bernoulli(gen, b, blur_prob),
            "blur_direction": _randint(gen, b, 4), "blur_size": _randint(gen, b, 3),
            "rotate": _bernoulli(gen, b, rotate_prob),
            "angle": _uniform(gen, (b,), -math.pi / 2, math.pi / 2),
            "jitter_on": _bernoulli(gen, b, jitter_prob),
            "jitter": draw_jitter(gen, b, *ATTN_JITTER),
            "flip": _bernoulli(gen, b, flip_prob), "flip_code": _randint(gen, b, 3)}


def draw_aspp(gen: torch.Generator, b: int, flip_prob: float = 0.5,
              jitter: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)) -> Dict:
    """The horizontal flip's coin as [B,1,1,1] (none at flip_prob 0) and the
    jitter."""
    out = {"jitter": draw_jitter(gen, b, *jitter)}
    if flip_prob > 0:
        out["flip"] = (torch.rand((b,), generator=gen, device=gen.device)
                       < flip_prob).view(b, 1, 1, 1)
    return out


# -- arithmetic ----------------------------------------------------------------------

def _gray(x: torch.Tensor) -> torch.Tensor:
    return (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]).unsqueeze(-1)


def color_jitter(x: torch.Tensor, factors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-image colour jitter of [B,H,W,3] in [0, 1], in the order
    brightness, contrast, saturation, hue: PIL ``ImageEnhance`` arithmetic
    for the first three (contrast about the image's mean grey), a rotation
    by ``hue * 2 pi`` of the I and Q axes of YIQ for the hue."""
    if "brightness" in factors:
        x = x * factors["brightness"]
    if "contrast" in factors:
        m = torch.mean(_gray(x), dim=(1, 2, 3), keepdim=True)
        x = (x - m) * factors["contrast"] + m
    if "saturation" in factors:
        g = _gray(x)
        x = (x - g) * factors["saturation"] + g
    if "hue" in factors:
        theta = factors["hue"] * 2 * math.pi
        y = _gray(x)[..., 0]
        i = 0.596 * x[..., 0] - 0.274 * x[..., 1] - 0.322 * x[..., 2]
        q = 0.211 * x[..., 0] - 0.523 * x[..., 1] + 0.312 * x[..., 2]
        cos, sin = torch.cos(theta), torch.sin(theta)
        i2 = cos * i - sin * q
        q2 = sin * i + cos * q
        x = torch.stack([y + 0.956 * i2 + 0.621 * q2,
                         y - 0.272 * i2 - 0.647 * q2,
                         y - 1.106 * i2 + 1.703 * q2], dim=-1)
    return x


def flip_select(x, y, code, active):
    """Per image: code 0 flips H, 1 flips W, 2 (the host's -1) both, where
    ``active``."""
    v = active & ((code == 0) | (code == 2))
    h = active & ((code == 1) | (code == 2))
    x = torch.where(v.view(-1, 1, 1, 1), x.flip(1), x)
    y = torch.where(v.view(-1, 1, 1), y.flip(1), y)
    x = torch.where(h.view(-1, 1, 1, 1), x.flip(2), x)
    y = torch.where(h.view(-1, 1, 1), y.flip(2), y)
    return x, y


def rot90_select(x, y, k):
    """Per image ``numpy.rot90(., k)`` over the H and W axes of a square batch."""
    xo, yo = x, y
    for i in (1, 2, 3):
        m = k == i
        xo = torch.where(m.view(-1, 1, 1, 1), torch.rot90(x, i, (1, 2)), xo)
        yo = torch.where(m.view(-1, 1, 1), torch.rot90(y, i, (1, 2)), yo)
    return xo, yo


def motion_blur(x, direction, size, active):
    """Per image, where ``active``: the mean of k = 3, 5 or 7 (``size`` 0, 1,
    2) copies of the image rolled with wrap-around by -k//2..k//2 pixels
    along ``direction`` (0: W, 1: H, 2 and 3: the diagonals)."""
    out = torch.zeros_like(x)
    for d, (sy, sx) in enumerate(BLUR_DIRECTIONS):
        acc, per_k = x, []
        for o in (1, 2, 3):
            acc = (acc + torch.roll(x, (o * sy, o * sx), (1, 2))
                   + torch.roll(x, (-o * sy, -o * sx), (1, 2)))
            per_k.append(acc / (2 * o + 1))
        sel = torch.where((size == 0).view(-1, 1, 1, 1), per_k[0],
                          torch.where((size == 1).view(-1, 1, 1, 1), per_k[1], per_k[2]))
        out = out + torch.where((direction == d).view(-1, 1, 1, 1), sel, 0.0)
    return torch.where(active.view(-1, 1, 1, 1), out, x)


def rotate(x, y, theta, active):
    """Per image, where ``active``: a turn by ``theta`` radians
    counter-clockwise on screen (y down) about the centre, as PIL's
    ``Image.rotate``: the image bilinear, the label nearest, 0 where the
    source falls outside the image (for both)."""
    b, h, w, c = x.shape
    dev = x.device
    yy = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos = torch.cos(theta).view(-1, 1, 1)
    sin = torch.sin(theta).view(-1, 1, 1)
    dx, dy = xx - cx, yy - cy
    # the inverse map, output -> source
    sx = cos * dx - sin * dy + cx
    sy = sin * dx + cos * dy + cy

    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0).unsqueeze(-1), (sy - y0).unsqueeze(-1)
    valid = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    x0i = torch.clamp(x0, 0, w - 1).long()
    x1i = torch.clamp(x0 + 1, 0, w - 1).long()
    y0i = torch.clamp(y0, 0, h - 1).long()
    y1i = torch.clamp(y0 + 1, 0, h - 1).long()
    flat = x.reshape(b, h * w, c)

    def g(yi, xi):
        idx = (yi * w + xi).reshape(b, h * w, 1).expand(b, h * w, c)
        return torch.gather(flat, 1, idx).reshape(b, h, w, c)

    img = (g(y0i, x0i) * (1 - wx) * (1 - wy) + g(y0i, x1i) * wx * (1 - wy)
           + g(y1i, x0i) * (1 - wx) * wy + g(y1i, x1i) * wx * wy)
    img = torch.where(valid.unsqueeze(-1), img, 0.0)
    x_out = torch.where(active.view(-1, 1, 1, 1), img, x)

    xn = torch.clamp(torch.round(sx), 0, w - 1).long()
    yn = torch.clamp(torch.round(sy), 0, h - 1).long()
    lab = torch.gather(y.reshape(b, h * w), 1, (yn * w + xn).reshape(b, h * w))
    lab = torch.where(valid, lab.reshape(b, h, w), 0).to(y.dtype)
    y_out = torch.where(active.view(-1, 1, 1), lab, y)
    return x_out, y_out


def resize_pair(x, y, size: Tuple[int, int]):
    """[B,H,W,3] bilinear (``align_corners=False``) and the [B,H,W] label
    nearest (``floor(i * in / out)``, in float64 as the JAX package's index
    arrays) to ``size`` = (H, W)."""
    h_in, w_in = x.shape[1:3]
    h_out, w_out = int(size[0]), int(size[1])
    if (h_in, w_in) == (h_out, w_out):
        return x, y
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(h_out, w_out), mode="bilinear",
                      align_corners=False).permute(0, 2, 3, 1)
    rows = np.minimum((np.arange(h_out) * (h_in / h_out)).astype(np.int64), h_in - 1)
    cols = np.minimum((np.arange(w_out) * (w_in / w_out)).astype(np.int64), w_in - 1)
    y = y[:, torch.from_numpy(rows).to(y.device)][:, :, torch.from_numpy(cols).to(y.device)]
    return x, y


def _normalize(x, mean, std):
    return (x - torch.tensor(mean, dtype=torch.float32, device=x.device)) \
        / torch.tensor(std, dtype=torch.float32, device=x.device)


def augment_batch_pra(images, labels, draws,
                      dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The device half of the pra pipeline on a square batch in [0, 1]:
    rot90, flip (code 3: none), jitter, clip, normalise.  The 220 crop and
    the resize stay on the host (they need the image before the resize)."""
    if images.shape[1] != images.shape[2]:
        raise ValueError(f"the pra pipeline takes square images, not {tuple(images.shape)}")
    x, y = rot90_select(images.float(), labels, draws["rot_k"])
    code = draws["flip_code"]
    x, y = flip_select(x, y, code, code < 3)
    x = color_jitter(x, draws["jitter"])
    x = torch.clamp(x, 0.0, 1.0)
    return {"image": _normalize(x, IMAGENET_MEAN, IMAGENET_STD).to(dtype).contiguous(),
            "label": y.contiguous()}


def augment_batch_attn(images, labels, draws,
                       dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The device half of the attn pipeline on [0, 1] images: each op where
    the outer gate and its own coin both came up, in the order blur, rotate,
    jitter, flip; clipped to [0, 1], not normalised."""
    x, y = images.float(), labels
    apply = draws["apply"]
    x = motion_blur(x, draws["blur_direction"], draws["blur_size"], apply & draws["blur"])
    x, y = rotate(x, y, draws["angle"], apply & draws["rotate"])
    xj = color_jitter(x, draws["jitter"])
    x = torch.where((apply & draws["jitter_on"]).view(-1, 1, 1, 1), xj, x)
    x, y = flip_select(x, y, draws["flip_code"], apply & draws["flip"])
    return {"image": torch.clamp(x, 0.0, 1.0).to(dtype).contiguous(), "label": y.contiguous()}


def augment_batch(images, labels, draws, size: Optional[Tuple[int, int]] = None,
                  mean: Sequence[float] = IMAGENET_MEAN, std: Sequence[float] = IMAGENET_STD,
                  to_bgr255: bool = False,
                  dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The aspp pipeline on [0, 1] images: resize to ``size`` = (H, W),
    horizontal flip, jitter, clip, ``TO_BGR255`` (channels reversed, times
    255), normalise."""
    x, y = images.float(), labels
    if size is not None:
        x, y = resize_pair(x, y, size)
    if "flip" in draws:
        do = draws["flip"]
        x = torch.where(do, x.flip(2), x)
        y = torch.where(do[..., 0], y.flip(2), y)
    x = color_jitter(x, draws["jitter"])
    x = torch.clamp(x, 0.0, 1.0)
    if to_bgr255:
        x = x.flip(-1) * 255.0
    return {"image": _normalize(x, mean, std).to(dtype).contiguous(), "label": y.contiguous()}


# -- the trainers' hook --------------------------------------------------------------

def device_aug_active(cfg, mode: str = "train") -> bool:
    """Whether device augmentation replaces the host's train transforms: the
    host ``Augmenter`` and the trainers ask the same question.  Eval keeps
    the host's test transforms."""
    return bool(cfg.DATA_PIPE.DEVICE_AUG) and mode == "train"


def _rank_draws(draw_fn, gen: torch.Generator, rows: int, *args) -> Dict:
    """``draw_fn(gen, rows * world, *args)`` with every tensor cut to this
    rank's ``rows`` rows."""
    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return rank_rows(tree, rows)
    return cut(draw_fn(gen, rows * world_size(), *args))


def make_device_augmenter(cfg, is_source: bool = True):
    """``aug(batch, step) -> batch``: the pipeline of ``cfg.AUG.NAME`` on the
    batch's device, its draws from a generator seeded with
    ``mix_seed(DATA_PIPE.SEED (+ 7919 for a FADA target), step)``.  A
    target stream in the aspp pipeline takes the target train size and no
    jitter (aspp's ColorJitter is the source domain's only).  The image
    comes out in MODEL.DTYPE."""
    name = cfg.AUG.NAME
    seed = cfg.DATA_PIPE.SEED + (0 if is_source else TARGET_SEED_OFFSET)
    dtype = compute_dtype(cfg)
    generators: Dict[torch.device, torch.Generator] = {}

    if name == "pra":
        def impl(image, label, gen):
            return augment_batch_pra(image, label, _rank_draws(draw_pra, gen, image.shape[0]),
                                     dtype)
    elif name == "attn":
        aug = cfg.AUG
        probs = (aug.PROB, aug.BLUR_PROB, aug.ROTATE_PROB, aug.JITTER_PROB, aug.FLIP_PROB)

        def impl(image, label, gen):
            return augment_batch_attn(image, label,
                                      _rank_draws(draw_attn, gen, image.shape[0], *probs), dtype)
    else:  # aspp's pipeline, also for AUG.NAME gald and none
        inp = cfg.INPUT
        w, h = inp.SOURCE_INPUT_SIZE_TRAIN if is_source else inp.TARGET_INPUT_SIZE_TRAIN
        jitter = ((inp.BRIGHTNESS, inp.CONTRAST, inp.SATURATION, inp.HUE) if is_source
                  else (0.0, 0.0, 0.0, 0.0))
        flip_prob = inp.HORIZONTAL_FLIP_PROB_TRAIN

        def impl(image, label, gen):
            draws = _rank_draws(draw_aspp, gen, image.shape[0], flip_prob, jitter)
            return augment_batch(image, label, draws, size=(h, w), mean=tuple(inp.PIXEL_MEAN),
                                 std=tuple(inp.PIXEL_STD), to_bgr255=inp.TO_BGR255,
                                 dtype=dtype)

    def fn(batch: Dict, step: int) -> Dict:
        image = batch["image"]
        gen = generators.get(image.device)
        if gen is None:
            gen = generators[image.device] = torch.Generator(device=image.device)
        gen.manual_seed(mix_seed(seed, step))
        out = impl(image, batch["label"], gen)
        if "name" in batch:
            out["name"] = batch["name"]
        return out

    return fn
