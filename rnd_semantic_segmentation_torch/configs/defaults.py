"""Default config tree.

The same keys and values as the JAX package's configs/defaults.py, so every
``configs/*.yaml`` merges into equal trees in both packages.  One value
differs: ``MODEL.DEVICE`` is ``"cuda"`` here, and the port uses the CPU only
when a caller sets ``MODEL.DEVICE cpu``.

The port reads, for serving: MODEL.NAME, MODEL.NUM_CLASSES, MODEL.DEVICE,
MODEL.FREEZE_BN (deeplab family: FrozenBN in the ResNet), MODEL.FUSED_MBCONV
(attn family, eval mode: the fused MBConv kernel), INPUT.INPUT_SIZE_TEST,
INPUT.PIXEL_MEAN/PIXEL_STD/TO_BGR255 (the aspp transforms), AUG.NAME,
TEST.QUANT, TEST.QUANT_CALIB_BATCHES, TEST.QUANT_MAX_AREA,
TEST.QUANT_AGREEMENT_FLOOR, TEST.QUANT_MIN_CHANNELS and TEST.QUANT_REPAIR_MAX
(post-training int8 quantization of eval, serving, inference and export,
serve/quant.py; an unknown TEST.QUANT raises ValueError),
TEST.FLIP_TTA/MULTI_SCALE/SCALES (deeplab test-time
augmentation, one image a batch), OUTPUT_DIR and resume; for evaluation also
DATASETS.DATASET_DIR/TEST/CROSS_VAL/SYNTHETIC_LENGTH, TEST.BATCH_SIZE,
INPUT.IGNORE_LABEL, INPUT.TRAINSIZE (the pra transforms, and pranet's
multi-scale rates in training), AUG.COLLATE,
DATA_PIPE.NUM_WORKERS/WORKER_PROCESSES/PREFETCH/SEED, and PSEUDO_DIR (where
``--saveres`` writes its PNGs); and for source training (``cli.train_src``,
and ``cli.train_distill``) also
INPUT.SOURCE_INPUT_SIZE_TRAIN, INPUT.TARGET_INPUT_SIZE_TRAIN,
INPUT.BRIGHTNESS/CONTRAST/SATURATION/HUE, INPUT.HORIZONTAL_FLIP_PROB_TRAIN,
INPUT.INPUT_SCALES_TRAIN (the aspp train transforms), the AUG probabilities
(the attn train transforms), INPUT.IGNORE_LABEL,
DATASETS.SOURCE_TRAIN/TEST/SYNTHETIC_LENGTH, AUG.COLLATE, SEED, DEBUG.NANS,
DATA_PIPE.NUM_WORKERS/WORKER_PROCESSES/PREFETCH/SEED, DATA_PIPE.DEVICE_AUG
(the augmentation on the device, data/device_pipe.py, both trainers),
PSEUDO_DIR (the self-distill datasets' labels), DISTILL.ONLINE,
DISTILL.TEACHER and DISTILL.CONFIDENCE_THRESHOLD (online self-distillation,
``cli.train_distill``) and the SOLVER keys EPOCHS, LR_METHOD, BASE_LR,
LR_POWER, DECAY_RATE, DECAY_EPOCH, MOMENTUM, WEIGHT_DECAY, BATCH_SIZE,
LR_BATCH_REF, WARMUP_ITERS, GRAD_CLIP, ACCUM_STEPS, CHECKPOINT_PERIOD,
KEEP_CHECKPOINTS and BN_RECAL_BATCHES (the source trainer's BatchNorm
recalibration after the last epoch), MODEL.DTYPE (the training compute type,
float32 or bfloat16; another raises), MODEL.REMAT_BLOCKS and SOLVER.REMAT
(rematerialisation, models/remat.py; every training step); and for FADA also DATASETS.TARGET_TRAIN
and SOLVER.BASE_LR_D and ADV_WEIGHT (the FADA step, like the JAX one, reads
neither LR_METHOD, LR_BATCH_REF, WARMUP_ITERS, GRAD_CLIP nor ACCUM_STEPS,
and the FADA trainer, like the JAX one, prunes no checkpoint and never
recalibrates; the online distillation step, like the JAX one, reads neither
GRAD_CLIP nor ACCUM_STEPS).  Every trainer, the test CLI and the Tester also
read DIST.INITIALIZE (data parallelism over processes started by
``torchrun``, parallel/dist.py) and DIST.NUM_DEVICES (0 or the world size;
another value raises ValueError), the trainers SOLVER.ASYNC_CHECKPOINT (the
background checkpoint writer, ckpt/async_writer.py), and every dataset
DATA_PIPE.NATIVE_DECODE (the libjpeg/libpng decoder, data/native_decode.py).
Every trainer reads MODEL.WEIGHTS (a pretrained backbone, a local .pth,
ckpt/pretrained.py).  Every built model reads MODEL.S2D_MAX_CHANNELS and
MODEL.SUBPIXEL_DECONV (the exact conv rewrites of ops/s2d.py and
ops/subpixel.py), and the source and FADA trainers DEBUG.CHECKIFY (their
steps' float checks, train/checkify.py; the online distillation step, like
the JAX one, does not read it).
A knob whose counterpart is not ported yet raises NotImplementedError when it
is set (DIST.SPATIAL_PARALLEL > 1, and an Orbax directory as
DISTILL.TEACHER).
The other keys belong to parts of the JAX package not yet ported and are kept
so that their configs load.  The port trains in MODEL.DTYPE (the image cast
to it, parameters, gradients and losses float32), as the JAX package does,
while evaluation and serving compute in float32, which the JAX package's
tester and server do whatever MODEL.DTYPE says; MODEL.FREEZE_BN does not reach the gald,
attn and pranet families, here as in the JAX package (both pranet configs
set it, and their BatchNorms train on batch statistics), and TEST.FLIP_TTA/MULTI_SCALE act on
the deeplab family only, as there.
"""

from .node import CfgNode

_C = CfgNode()

# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------
_C.MODEL = CfgNode()
_C.MODEL.NAME = "deeplab_resnet101"       # "<family>_<backbone>"
_C.MODEL.NUM_CLASSES = 2
_C.MODEL.DEVICE = "cuda"                  # "cuda" | "cpu"; "cuda" without a card raises
_C.MODEL.WEIGHTS = ""
_C.MODEL.FREEZE_BN = False
_C.MODEL.DTYPE = "bfloat16"
_C.MODEL.S2D_MAX_CHANNELS = 0
_C.MODEL.SUBPIXEL_DECONV = False
_C.MODEL.FUSED_MBCONV = False
_C.MODEL.REMAT_BLOCKS = False

# ---------------------------------------------------------------------------
# Input / preprocessing
# ---------------------------------------------------------------------------
_C.INPUT = CfgNode()
_C.INPUT.TRAINSIZE = 352
_C.INPUT.SOURCE_INPUT_SIZE_TRAIN = (1280, 720)   # (W, H)
_C.INPUT.TARGET_INPUT_SIZE_TRAIN = (1024, 512)
_C.INPUT.INPUT_SIZE_TEST = (1024, 512)           # (W, H): the serving geometry
_C.INPUT.INPUT_SCALES_TRAIN = (1.0, 1.0)
_C.INPUT.IGNORE_LABEL = 255
_C.INPUT.PIXEL_MEAN = [0.485, 0.456, 0.406]
_C.INPUT.PIXEL_STD = [0.229, 0.224, 0.225]
_C.INPUT.TO_BGR255 = False
_C.INPUT.BRIGHTNESS = 0.0
_C.INPUT.CONTRAST = 0.0
_C.INPUT.SATURATION = 0.0
_C.INPUT.HUE = 0.0
_C.INPUT.HORIZONTAL_FLIP_PROB_TRAIN = 0.0

# ---------------------------------------------------------------------------
# Augmentation pipeline selector
# ---------------------------------------------------------------------------
_C.AUG = CfgNode()
_C.AUG.NAME = "attn"                      # attn | pra | aspp | gald | none
_C.AUG.BLUR_PROB = 0.7
_C.AUG.ROTATE_PROB = 0.7
_C.AUG.JITTER_PROB = 0.7
_C.AUG.FLIP_PROB = 0.7
_C.AUG.PROB = 0.7
_C.AUG.COLLATE = "attn"

# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------
_C.DATASETS = CfgNode()
_C.DATASETS.DATASET_DIR = ""
_C.DATASETS.SOURCE_TRAIN = ""
_C.DATASETS.TARGET_TRAIN = ""
_C.DATASETS.VALIDATION = ""
_C.DATASETS.TEST = ""
_C.DATASETS.CROSS_VAL = 0
_C.DATASETS.SYNTHETIC_LENGTH = 64

# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------
_C.SOLVER = CfgNode()
_C.SOLVER.EPOCHS = 5
_C.SOLVER.MAX_ITER = 16000
_C.SOLVER.STOP_ITER = 10000
_C.SOLVER.LR_METHOD = "poly"
_C.SOLVER.BASE_LR = 0.02
_C.SOLVER.BASE_LR_D = 0.008
_C.SOLVER.LR_POWER = 0.9
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.WEIGHT_DECAY = 0.0005
_C.SOLVER.WEIGHT_DECAY_BIAS = 0.0
_C.SOLVER.DECAY_RATE = 0.1
_C.SOLVER.DECAY_EPOCH = 50
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.CHECKPOINT_PERIOD = 5
_C.SOLVER.KEEP_CHECKPOINTS = 0
_C.SOLVER.ASYNC_CHECKPOINT = False
_C.SOLVER.BATCH_SIZE = 8                  # global batch size
_C.SOLVER.BATCH_SIZE_VAL = 1
_C.SOLVER.LR_BATCH_REF = 0
_C.SOLVER.WARMUP_ITERS = 0
_C.SOLVER.GRAD_CLIP = 0.0
_C.SOLVER.ADV_WEIGHT = 0.001
_C.SOLVER.ACCUM_STEPS = 1
_C.SOLVER.REMAT = "none"
_C.SOLVER.BN_RECAL_BATCHES = 0

# ---------------------------------------------------------------------------
# Test / serving
# ---------------------------------------------------------------------------
_C.TEST = CfgNode()
_C.TEST.BATCH_SIZE = 1
_C.TEST.FLIP_TTA = False
_C.TEST.MULTI_SCALE = False
_C.TEST.SCALES = (0.7, 1.0, 1.3)
_C.TEST.QUANT = "none"                    # none | int8 | fake | auto (serve/quant.py)
_C.TEST.QUANT_CALIB_BATCHES = 2
_C.TEST.QUANT_MAX_AREA = 1048576  # the JAX tree's value (a TPU's policy), not the port's measurement
_C.TEST.QUANT_AGREEMENT_FLOOR = 0.95
_C.TEST.QUANT_MIN_CHANNELS = 64
_C.TEST.QUANT_REPAIR_MAX = 6

# ---------------------------------------------------------------------------
# Distribution
# ---------------------------------------------------------------------------
_C.DIST = CfgNode()
_C.DIST.DATA_AXIS = "data"
_C.DIST.SPATIAL_AXIS = "spatial"
_C.DIST.SPATIAL_PARALLEL = 1
_C.DIST.NUM_DEVICES = 0
_C.DIST.INITIALIZE = False

# ---------------------------------------------------------------------------
# Host data pipeline
# ---------------------------------------------------------------------------
_C.DATA_PIPE = CfgNode()
_C.DATA_PIPE.NUM_WORKERS = 4
_C.DATA_PIPE.WORKER_PROCESSES = 0
_C.DATA_PIPE.PREFETCH = 2
_C.DATA_PIPE.SEED = 0
_C.DATA_PIPE.DEVICE_AUG = False
_C.DATA_PIPE.NATIVE_DECODE = False

# ---------------------------------------------------------------------------
# Self-distillation
# ---------------------------------------------------------------------------
_C.DISTILL = CfgNode()
_C.DISTILL.ONLINE = False
_C.DISTILL.TEACHER = ""
_C.DISTILL.CONFIDENCE_THRESHOLD = 0.0

# ---------------------------------------------------------------------------
# Debug
# ---------------------------------------------------------------------------
_C.DEBUG = CfgNode()
_C.DEBUG.NANS = False                     # torch.autograd anomaly detection in the trainer
_C.DEBUG.CHECKIFY = False

_C.OUTPUT_DIR = "."
_C.resume = ""
_C.PSEUDO_DIR = ""
_C.SEED = 0


def get_default_cfg() -> CfgNode:
    return _C.clone()
