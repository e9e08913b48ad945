#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (rnd_semantic_segmentation_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU, nvcc and the port's sources; exits non-zero and prints
no result line on any failure.  Phases, each of which raises:

  1. device   the card's name and power limit (nvidia-smi) and torch's view;
  2. build    every CUDA source of the port, one nvcc each, all started at once;
  3. kernels  each kernel against its plain PyTorch version on the card, in
              float32 and bfloat16, at the shapes the main paths give it and
              more (the criss-cross forward and backward also two of their
              calls for equal bits, with each pass's resources and device
              time; the forward also beside a masked
              scaled_dot_product_attention over the H*W pixels, its library
              yardstick, and with its channels split into other numbers of
              groups; the backward also against autograd of the plain
              forward; the fused MBConv also against the unfused module
              path), and its time beside its bound and the plain version's
              (the fused MBConv also beside a tensor-core bound, after a
              report of its instances: ptxas registers and spills, shared
              memory, blocks per SM, HMMA instructions);
  4. serve    the GALD serving path: GALD (HarDNet68 + GCPA-CC, 19 classes, full
              width, seeded weights) behind the port's HTTP server at
              1024x512, 16 PNG requests from 8 threads; kernel launches are
              counted over exactly that traffic, and one batch of masks is
              checked against the same forward with the plain attention core;
  5. train    the GALD training path: the same model through the source-training
              CLI's parser and ``Trainer`` at 1280x720, batch 6, Adam, float32,
              on the synthetic dataset, for 6 steps; forward and backward
              kernel launches are counted over exactly those steps, the
              attention's parameters must receive gradients and move, one
              step's gradients are held against the same step with the plain
              core on the kernel step's decoder ReLU masks, and the checkpoint
              it wrote loads back into ``Tester``;
  6. eval_attn   the attn eval path: Attention-EfficientNet-B2-UNet (2 classes,
              full width and depth, seeded weights) through the test CLI's
              parser and ``Tester.test()`` at 512x512, batch 8, on the
              synthetic dataset, with MODEL.FUSED_MBCONV on: 17 fused-MBConv
              launches per forward, a finite summary, and the confusion matrix
              of the same run with the switch off;
  7. serve_attn  the attn serving path: the same model behind the HTTP server
              with the switch on, 16 PNG requests from 8 threads, launches
              counted over exactly that traffic, one batch of masks checked
              against the unfused forward;
  8. train_deeplab  the DeepLab main path: DeepLabV2-ResNet101 + ASPP
              (configs/deeplabv2_r101_src.yaml: output stride 8, FrozenBN, 19
              classes, full width and depth, seeded weights) through the
              source-training CLI's parser and ``Trainer`` at 1280x720, batch
              6, SGD with the classifier at 10x LR, poly LR, float32, TF32
              off, on the synthetic dataset, for 6 steps; the loss must be
              finite, every parameter of both parts move, every FrozenBN
              buffer stay bit-equal, the checkpoint load into ``Tester``; a
              step split into forward, backward and optimizer;
  9. eval_deeplab  that checkpoint through the test CLI's parser and
              ``Tester.test()`` on 32 synthetic images at 1024x512, batch 1;
              one image with flip and one with multi-scale test-time
              augmentation; and a seeded ResNet18 DeepLab at 64x64 on the card
              against the same forward on the CPU;
 10. serve_deeplab  the same model behind the HTTP server, 16 PNG requests of
              1024x512 from 8 threads, one batch of masks checked against the
              same forward outside the server;
 11. train_attn  the attn training path: configs/attn_src_kvasir.yaml
              (attn_efficientnet-b2, 2 classes, full width and depth, seeded
              weights) through the source-training CLI's parser and
              ``Trainer`` at 512x512, batch 20, Adam with L2 weight decay
              1e-4 and the decoder at 10x LR, warm-up cosine per epoch,
              Tversky + BCE at five scales, drop-connect on, the config's
              attn augmentation, float32, TF32 off, MODEL.FUSED_MBCONV on, on
              the synthetic dataset, for 6 steps; the loss must be finite,
              every parameter of both parts and every BN running statistic
              move, and no hand kernel launch; a step split into forward,
              backward and optimizer; two generator states must give two
              train-mode outputs; then the checkpoint it wrote through the
              test CLI's function as in eval_attn (17 launches per fused
              forward, the fused and unfused confusion matrices within the
              same tolerance);
 12. train_fada_deeplab  the FADA main path: configs/deeplabv2_r101_adv.yaml
              (DeepLabV2-ResNet101, FrozenBN, 19 classes, full width and depth,
              seeded weights; D sized from the 2048-channel tap) through the
              adversarial CLI's parser and ``FadaTrainer``: 4 synthetic source
              images at 1280x720 and 4 shifted target images at 1024x512 a
              step, SGD at 2.5e-4 with the classifier at 10x, D on Adam at
              1e-4, poly LR, for 3 steps; the four losses must be finite,
              every parameter of both parts and of D move, no hand kernel
              launch; a step split into the generator's forwards and backward,
              the segmentor's update, D's forwards and backward and D's
              update; then its AsppFada-1.pth through the test CLI's
              function on 4 synthetic images at 1024x512;
 13. train_fada_gald  configs/gald_adv.yaml at full width: 2 + 2 images a
              step at 1280x720 and 1024x512, 4 steps; kernel #1 must launch 4
              times a step (both domains) and kernel #2 twice (the source);
 14. train_fada_attn  configs/attn_adv_kvasir.yaml: B2, 2 classes, 10 + 10
              images at 512x512 a step, drop-connect and the attn
              augmentation on, MODEL.FUSED_MBCONV on, 4 steps; no hand kernel;
 15. fada_vgg16  the train_fada_deeplab path with MODEL.NAME deeplab_vgg16, 2
              steps, after the seeded VGG16's logits at 1280x720 (finite, of
              order one: no norm damps them);
 16. data_files  the datasets on disk, written from seed 0 into the run's
              tmp directory in each one's layout (``write_dataset_trees``):
              GTA5 12 + 4 images at 1914x1052, Cityscapes 12 + 4 at
              2048x1024, Kvasir 120 + 8 and BLI 20 + 8 at sizes from 332x487
              to 1350x1080, smooth noise with blobs, PNG (BLI images JPEG);
              one item of each reader timed through its config's transform;
 17. train_fada_files  configs/deeplabv2_r101_adv.yaml with only
              DATASETS.DATASET_DIR (and OUTPUT_DIR, the length of the run)
              set: gta5_train -> cityscapes_train from those files, 3 steps of
              4 + 4 images, as train_fada_deeplab checks it; no hand kernel;
 18. saveres_cityscapes  ``cli.test --saveres -c renders/cityscapes.json``
              with that AsppFada-1.pth, its logits centred over one batch,
              on cityscapes_train (PSEUDO_DIR <root>/cityscapes/soft_labels):
              12 palette PNGs at 2048x1024, each with more than one id,
              unlike the others and the argmax of a plain ``Tester``
              forward of its image;
 19. train_distill_files  ``cli.train_distill`` with
              configs/deeplabv2_r101_tgt_self_distill.yaml over
              cityscapes_self_distill_train (those PNGs as labels): batch 5 at
              1024x512, scales 0.5-1.5 and flips, 2 steps from seeded weights;
              a batch's labels are two or more pseudo-label ids and 255; no
              hand kernel;
 20. train_attn_files  configs/attn_src_kvasir.yaml on polyp_train files:
              ``measure_overlap`` of the config's thread loader and of a loader
              of N worker processes (N = the host's cores less 2) over two
              epochs against PR 9's attn step, then two epochs of 6 steps of
              20 at 512x512 with each, the second reported; then the last
              checkpoint through ``cli.test`` on bli_val files
              (renders/bli.json) with MODEL.FUSED_MBCONV on: 17 launches of
              kernel #3 a forward;
 21. train_pranet  configs/pranet_src_polyp.yaml (pranet_res2net50: Res2Net50-v1b
              26w x 4s, channel 32, 2 classes, full width and depth, seeded
              weights) on polyp_train files through the source-training CLI's
              parser and ``Trainer``: an epoch of 7 batches of 16, each
              stepped at the three rates (sides 256, 352 and 448), Adam at
              1/8 of the gradual warm-up's LR, the 0.5 clamp, the structure
              loss on the four maps, the pra augmentation, float32, TF32 off;
              the loss finite, 3 optimizer steps a batch, every parameter and
              BN running statistic moved, no hand kernel; ms a batch and a
              step at each side, the data share, peak memory, the
              checkpoint's load into ``Tester``, a 352 step split into
              forward, backward and optimizer, and the kernels of a step at
              256 and at 352 under ``torch.profiler``;
 22. eval_pranet  that PraNet-1.pth through the test CLI's function on polyp_val
              and bli_val files, batch 1 at 352; the head on two images
              against its plain recomputation from map 2 (sigmoid, batch
              min-max, stack); a forward's host and device time; a seeded
              pranet_res2net50 at 64x64 on the card against the CPU;
 23. serve_pranet  the daemon on that checkpoint at 352x352, 16 PNG requests
              from 8 threads; the largest dispatched batch of masks against
              ``Tester._probs_impl`` on the same padded bucket (the head's
              min-max spans the bucket);
 24. train_fada_pranet  configs/pranet_adv_polyp_bli.yaml: polyp_train ->
              bli_train files, 8 + 8 images a step at 352, an epoch of 15
              steps, D on the 2048-channel layer4 tap; the four losses
              finite, every parameter of the model and of D moved, no hand
              kernel; the kernels of a step under ``torch.profiler``; then
              PraNetFada-1.pth through the test CLI's function on bli_val.
 25. train_distill_online  online self-distillation (``cli.train_distill``
              with DISTILL.ONLINE): configs/deeplabv2_r101_tgt_self_distill.yaml,
              its teacher train_fada_files' AsppFada-1.pth with the class
              means centred as saveres_cityscapes wrote it, at
              DISTILL.CONFIDENCE_THRESHOLD 0.9, on the cityscapes files (the
              reader's pseudo-label PNGs read and ignored), batch 5 at
              1024x512, 2 steps; the first batch's labels the argmax of a
              ``Tester`` forward of the teacher, 255 exactly where its largest
              probability is below 0.9; the loss finite, every student
              parameter moved, every teacher tensor bit-equal, no hand kernel;
 26. train_distill_online_gald  configs/gald_tgt_self_distill.yaml online at full
              width, its teacher the train phase's Gald-1.pth (seeded when that
              phase did not run), batch 5 of synthetic images at 1024x512, 3
              steps: kernel #1 4 launches a step (the teacher's 2, the
              student's 2), #2 2; the student's attention moved;
 27. train_distill_online_polyp  attn B2 online from train_attn_files'
              checkpoint with MODEL.FUSED_MBCONV on, 3 steps of 20 at 512x512
              of polyp_train files: kernel #3 17 launches a step, all the
              teacher's; pranet_res2net50 online from train_pranet's
              PraNet-1.pth, 2 batches of 16 at the three rates: binary
              pseudo-labels, every step finite;
 28. device_aug  DATA_PIPE.DEVICE_AUG: (a) each apply function of
              data/device_pipe.py on the card against the CPU with the same
              draws; (b) configs/attn_src_kvasir.yaml with it and
              SOLVER.BN_RECAL_BATCHES 8, N worker processes, two epochs of 6
              steps of 20 on polyp_train files, reported beside
              train_attn_files' numbers; every running statistic changed by the
              recalibration, the re-saved checkpoint different from the state
              before only there, eval mode closer to train mode on a train
              batch, then that checkpoint through ``cli.test`` on bli_val with
              kernel #3; (c) configs/pranet_src_polyp_tpu.yaml with only
              NATIVE_DECODE and ASYNC_CHECKPOINT turned off, one epoch of 7
              batches of 16, beside train_pranet's numbers; (d)
              configs/deeplabv2_r101_adv.yaml with it on gta5_train ->
              cityscapes_train files, 3 steps of 4 + 4, the target at
              1024x512 with no jitter, beside train_fada_files' numbers.
 29. train_bf16  MODEL.DTYPE: each family's own config at its default
              bfloat16 beside the same run pinned to float32, in one process,
              on the synthetic dataset: deeplabv2_r101_src.yaml and
              gald_src.yaml 6 at 1280x720, attn_src_kvasir.yaml (B2) 20 at
              512, 3 steps (the first a warm-up); pranet_src_polyp.yaml 16 at
              the three rates, 2 batches; ms a step, peak memory, the losses,
              float32 parameters and every convolution's output in the run's
              type; the GALD runs launch #1 and #2 twice a step (the bfloat16
              instances in the bfloat16 run), and one bfloat16 step's
              gradients through them are held against the plain core at
              BWD_TOLERANCE[bfloat16] in eval mode (train mode reported);
 30. train_fada_bf16  configs/deeplabv2_r101_adv.yaml at bfloat16, 3 steps of
              4 + 4 as train_fada_deeplab checks them, D on the bfloat16 tap,
              then the step split with the kernel tables of the generator's
              and D's parts;
 31. distill_online_bf16  online distillation at bfloat16, the image cast
              before the teacher: configs/gald_tgt_self_distill.yaml, 3 steps
              of 5 synthetic images at 1024x512 (#1 4 launches a step, #2 2,
              on bfloat16 q, k, v); attn B2 with MODEL.FUSED_MBCONV from
              train_attn_files' checkpoint (seeded when that phase did not
              run), 3 steps of 20 synthetic images at 512 (#3 17 a step on
              bfloat16 activations, all the teacher's);
 32. remat    attn B2, 20 at 512, bfloat16, MODEL.REMAT_BLOCKS off against
              on (AUG.PROB 0, so that both see the same batches);
              DeepLabV2-ResNet101, 6 at 1280x720, bfloat16,
              MODEL.REMAT_BLOCKS with SOLVER.REMAT full against neither; 4
              steps a run; ms a step, peak memory (which must be lower with
              rematerialisation), the largest differences in the losses, the
              last step's gradients and the BatchNorm running statistics.
 33. quant_deeplab  post-training int8 quantization (serve/quant.py) on
              DeepLabV2-ResNet101 (configs/deeplabv2_r101_src.yaml, seeded):
              the int8 conv (columns of int8 views, ``torch._int_mm``) bit-equal
              to float64 of its integers at each shape class (1x1, 3x3,
              dilated, strided, pooled maps of 1-8 rows), timed beside cuDNN
              float32; 32 images at 1024x512 through ``Tester.test()`` with
              TEST.QUANT none, int8 and auto (ms per image, quantized convs,
              agreement, ``quant_report``, the confusion heat map); the forward
              of 1 and of 8 in float32 and int8 with peak memory and
              agreement; 16 requests served under int8 (p50, max; masks
              against the Tester's int8 forward); 4 images at 2048x1024 in
              float32 and int8, where auto resolves to float32;
 34. quant_gald  GALD served at 1024x512 under int8, 16 requests: kernel #1
              twice a forward (the calibrating forward and the agreement's two
              included); agreement with float32; the forward of 8 in both;
 35. quant_attn  attn B2 at 512x512 with MODEL.FUSED_MBCONV, 32 images in
              batches of 8 under int8 through ``Tester.test()``: kernel #3 17
              times a forward over the 8 forwards (2 calibrating, 2 for the
              agreement, 4 evaluating); the forward of 8 in both;
 36. export   ``serve.export.export_eval`` (``torch.export``) at batch 2:
              DeepLab-R101 at 1024x512 in float32 and int8, GALD and fused attn
              B2 in float32, into the run's tmp directory; one fresh process
              loads the four, whose class ids must equal the Tester's on the
              same batch; the GALD program holds kernel #1's operator and
              launches it twice a call, the attn program #3's 17 times, the
              int8 one ``aten._int_mm``; bytes, export seconds, ms a call;
 37. inference_cli  ``cli.inference`` on a 1024x512 PNG (palette PNG equal to
              the Tester's argmax), ``cli.demo`` with two checkpoint columns
              and ground truth (grid, PR curves, image events), and
              ``cli.visualize`` (figures drawn with Pillow).
 38. dist_deeplab  configs/deeplabv2_r101_src.yaml in bfloat16 through
              ``cli.train_src``, 4 steps of 6 at 1280x720, without DIST and
              with DIST.INITIALIZE in a world of one over NCCL (the script
              sets the ``env://`` variables): equal loss series (1e-2), ms a
              step and peak memory of both;
 39. dist_gald_2rank  two processes of this script (``--dist-worker``) on
              the one card over gloo (NCCL takes one rank a device), each a
              rank of GALD's ``cli.train_src`` trainer under DIST.INITIALIZE:
              2 images at 1024x512 a rank, 3 steps, float32, against this
              process taking all 4; the losses, weights and BatchNorm buffers
              within DIST_GALD_TOLERANCE; #1 and #2 twice a step in each rank;
 40. dist_eval  ``cli.test`` with two ranks on the card over gloo against
              this process on 10 of 11 synthetic images (DeepLab-R101's
              checkpoint at 1024x512, TEST.BATCH_SIZE 4): the confusion
              matrices agree on MIN_MASK_AGREEMENT of the pixels (cuDNN sums
              in another order at 2 images a forward than at 4), micro mIoU
              within 1e-3, the left-out image named in the log;
              TEST.QUANT int8 over two ranks in float32, reason
              ``multiprocess``;
 41. async_ckpt  DeepLab-R101 in bfloat16, 3 epochs of 2 steps, a
              checkpoint each epoch, 2 kept, written in the loop and then in
              the background: ms the loop waited at each save, the bytes;
              the background file equal to a synchronous save of the same
              state; ``resume latest`` waits for a write in flight;
 42. native_decode  the libjpeg/libpng decoder built on this machine and
              timed against PIL, and attn from files with NATIVE_DECODE off
              and on; where it does not build, the port's raise with the
              compiler's message;
 43. recipes_tpu  each configs/*_tpu.yaml recipe through its train CLI from
              files for one epoch, with async checkpoints, device
              augmentation, worker processes and native decode as written
              (the overrides are listed in ``phase_recipes_tpu``): images/s,
              data share, peak memory, the checkpoint's wait; the GALD
              recipe launches #1 and #2 twice a step;
 44. ccnet    CCNet (models/seg_nets.py: ResNet-101, recurrence 2, 19 classes,
              full width and depth, seeded weights, gamma 0.7) in float32:
              3 train steps of 2 images at 769x769 (SGD, CE of main plus 0.4
              x CE of dsn), then one eval forward of a 1024x2048 frame; #1
              launches twice a forward and #2 twice a step, both held against
              their plain versions on the operands the step fed them (Cq 64,
              C 512, 97x97; #1 also at the frame's 128x256), the loss against
              the plain core's, with their times, bounds and the masked-SDPA
              yardstick; one train-mode forward each of GALDNet, PSPNet and
              DualSeg at 769 and of Res2Net with GCNet blocks at 352;
 45. pretrained  MODEL.WEIGHTS: a seeded torchvision-layout ResNet-101 .pth
              under the DeepLab source trainer (2 steps) and a hardnet68 one
              under GALD FADA (one step): the backbone equals the file after
              the load, the classifier keys skipped, the load's seconds.
 46. zoo_nets the rest of the research zoo at published sizes, float32,
              seeded weights: UNet (16 at 352), CE-Net ResNet34 (8 at 448),
              BiSeNetV1 (8 at 1024, 19 classes), DeepLabV3 ResNet-101 (8 at
              513, output stride 16), B2ResNet (10 at 352), RepVGG-A0,
              CGNLResNet-50 (cgnl) and SE-ResNet (32 at 224), ResNet3D
              (8 x 3 x 16 x 112 x 112) and the four FAM variants (interplanes
              256 on the taps of a 1024x512 frame, 8 a batch): a warm-up and a
              timed SGD step with each reference's loss (``_zoo_loss``), an
              eval forward, peak memory; RepVGG-A0's deploy form
              (``repvgg_reparam``) against its train form on the card;
 47. rewrites the exact conv rewrites, each pair from the same seeded weights
              on one batch, knob off then on: GALD's source step of 6 at
              1280x720 under MODEL.S2D_MAX_CHANNELS 64 (#1 and #2 twice a
              step), PraNet Res2Net50's of 16 at 352 under 256, attn B2's
              eval forward at 512 under MODEL.SUBPIXEL_DECONV with
              MODEL.FUSED_MBCONV (#3 17 times a forward): the convs rewritten,
              ms off and on; the eval outputs, the first losses and the maps
              within 2e-4 (largest relative gap), the first step's train-mode
              outputs within 2e-4 or 3 times what an image scaled by
              1 + 2^-20 does, the first backwards' gradient gaps logged;
 48. checkify DEBUG.CHECKIFY on DeepLab-R101's source step of 6 at 1280x720:
              ms without and with the float checks, the first forward's
              outputs bit-equal, the parameters after one step within twice
              the unchecked repeat's gap; then a batch with a pixel at +inf
              must raise ``FloatingPointError`` naming the op.
Every phase before train_bf16 pins MODEL.DTYPE float32 (``FLOAT32``).
The online phases cut the datasets to their steps (``_FirstItems``); each
earlier phase keeps its depth.
The PraNet phases set INPUT.SOURCE_INPUT_SIZE_TRAIN and
TARGET_INPUT_SIZE_TRAIN to 352 squared besides the data, the output and the
run's length: the configs leave them at their defaults, to which the
readers resize each item after the pra transform (ROADMAP Queue 3).
Hand kernels lie on the GALD paths (#1 and #2: serving, training, FADA and
online distillation, in float32 and in bfloat16, each rank of a world of two,
the GALD TPU recipe, the GALD FADA run from a pretrained file and GALD under
space-to-depth; #1 also in int8 serving and the GALD export), on CCNet's (#1
and #2) and on the attn eval paths (#3: eval, serving, the bli_val evals, the
online attn teacher, the last also in bfloat16, int8 eval, the attn export
and the sub-pixel forward); no hand kernel lies on the DeepLab, VGG16 or
PraNet paths, nor on attn training (source, FADA or the online student), the
device augmentation or the zoo's other nets: their phases check that none
of the three launched.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  ``--phases a,b`` runs only the named
phases (kernels, kernels_bwd, kernels_mbconv, serve, train, eval_attn,
serve_attn, train_deeplab, eval_deeplab, serve_deeplab, train_attn,
train_fada_deeplab, train_fada_gald, train_fada_attn, fada_vgg16, data_files,
train_fada_files, saveres_cityscapes, train_distill_files, train_attn_files,
train_pranet, eval_pranet, serve_pranet, train_fada_pranet, train_distill_online,
train_distill_online_gald, train_distill_online_polyp, device_aug, train_bf16,
train_fada_bf16, distill_online_bf16, remat, quant_deeplab, quant_gald,
quant_attn, export, inference_cli, dist_deeplab, dist_gald_2rank, dist_eval, async_ckpt,
native_decode, recipes_tpu, ccnet, pretrained, zoo_nets, rewrites, checkify; device and
build always run) and prints no result lines: an aid while
working on one path.  A phase before data_files that evaluates or serves a
checkpoint makes a seeded one when the phase that trains it did not run; a
phase after it that reads another's output (files, a checkpoint,
pseudo-labels) raises, naming that phase.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import http.client
import io
import json
import logging
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch

from rnd_semantic_segmentation_torch.ckpt.torch_import import save_reference_checkpoint
from rnd_semantic_segmentation_torch.cli import test as test_cli
from rnd_semantic_segmentation_torch.cli import train_adv, train_src
from rnd_semantic_segmentation_torch.cli.common import load_cfg
from rnd_semantic_segmentation_torch.cli.serve import build_parser
from rnd_semantic_segmentation_torch.data.trees import write_dataset_trees
from rnd_semantic_segmentation_torch.eval.tester import Tester
from rnd_semantic_segmentation_torch.models import gcpa
from rnd_semantic_segmentation_torch.models.build import build_segmentor, randomize_weights_
from rnd_semantic_segmentation_torch.models.efficientnet import MBConvBlock, block_list
from rnd_semantic_segmentation_torch.ops import ccattn, mbconv, native
from rnd_semantic_segmentation_torch.serve.server import make_server
from rnd_semantic_segmentation_torch.train.segmentor import Segmentor
from rnd_semantic_segmentation_torch.utils import load_json, resolve_device
from rnd_semantic_segmentation_torch.utils.device import compute_dtype

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; FLOP/s for float32 (no
# tensor cores at full float32 precision) and for bfloat16 (tensor cores)
# every phase before the bfloat16 ones trains (and evaluates) in float32,
# whatever its config's MODEL.DTYPE says, so that its numbers keep their meaning
FLOAT32 = ("MODEL.DTYPE", "float32")
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# a product on the tensor cores: float32 as three TF32 passes (495 TFLOP/s
# each), bfloat16 at its own rate; the rest of the work stays at 67 TFLOP/s
PEAK_TC_FLOP_PER_S = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}

# serving geometry: (W, H) = (1024, 512); the /32 map is 16x32 with 256 channels
SERVE_W, SERVE_H = 1024, 512
# training geometry: (W, H) = (1280, 720), batch 6; the /32 map is 22x40
TRAIN_W, TRAIN_H, TRAIN_BATCH, TRAIN_STEPS = 1280, 720, 6, 6
TRAIN_CC_SHAPE = (TRAIN_BATCH, 22, 40, 32, 256)
CC_SHAPES = [(1, 16, 32, 32, 256), (8, 16, 32, 32, 256),   # serving, B in {1, 8}
             TRAIN_CC_SHAPE,
             (2, 7, 11, 32, 256),                          # rectangular, odd
             (1, 1, 5, 32, 256),                           # column branch all masked
             (1, 64, 128, 32, 256)]                        # 2048x4096 input
MAIN_CC_SHAPE = (8, 16, 32, 32, 256)
# |kernel - plain| <= atol + rtol*|plain|: float32 sums in another order;
# bfloat16 outputs round to 8 mantissa bits on both sides
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 1e-2)}
# the backward's outputs are sums of up to H+W+... products whose size grows
# with the shape, so its tolerance is a share of the plain result's largest
# magnitude: float32 sums in another order; bfloat16 outputs round to 8
# mantissa bits (2^-8 of the value) on both sides
BWD_TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# one train step's gradients, kernels against plain core, as ||difference|| over
# ||plain|| per leaf: the cores agree to 1e-5, and the backward of the bilinear
# upsampling adds with atomics, in an order that differs from run to run (the
# run prints that spread beside the comparison); both differences pass through
# 68 layers of batch-statistics BatchNorm and ReLU, which amplify them (2e-5
# for the atomics alone and 7e-4 for the cores on an NVIDIA H100).  The plain
# step runs on the kernel step's decoder ReLU masks (``_ReluPins``): a ReLU
# whose input lies within rounding of 0 would otherwise put the two steps on
# different linear pieces, and one such element in a local-attention branch
# moved a BatchNorm bias's gradient by 8.4e-3 of its norm on an H100
GRAD_TOLERANCE = 5e-3
N_REQUESTS, N_THREADS, MAX_BATCH = 16, 8, 8
MIN_MASK_AGREEMENT = 0.999
# int8 masks served in batches of other sizes against the same images in one
# batch of 8: cuDNN's float convolutions (the stem, the narrow convs under
# QUANT_MIN_CHANNELS) sum in another order at another batch size, and where a
# value lies within that rounding of a .5 quantization boundary the next
# int8 conv sees a whole quantum more or less (GALD: 0.9949 in one run,
# DeepLab: 1.0, on an NVIDIA H100 80GB HBM3 at 700 W)
MIN_QUANT_MASK_AGREEMENT = 0.99
# the attn paths: Attention-EfficientNet-B2-UNet, 2 classes, 512x512, batch 8
ATTN_MODEL, ATTN_SIZE, ATTN_BATCH, ATTN_EVAL_IMAGES = "attn_efficientnet-b2", 512, 8, 32
MBCONV_LAUNCHES_PER_FORWARD = 17
# fused-MBConv shapes beyond the model's, as (B, C, H, W, k) with F = 3C: odd
# and rectangular; smaller than the 5x5 stencil; no multiple of the 16x16 tile
MBCONV_ODD_SHAPES = [(2, 8, 7, 11, 3), (1, 16, 3, 5, 5), (2, 24, 37, 21, 5)]
MAIN_MBCONV_SHAPE = (ATTN_BATCH, 24, 128, 128, 3)   # blocks 3 and 4: most bytes
# fused and unfused eval of the same weights: the share of pixels whose argmax
# may differ (ties at float32 precision between two sigmoid outputs)
MAX_TIE_SHARE = 1e-3
# the DeepLab paths: configs/deeplabv2_r101_src.yaml, as (MODEL.NAME,
# NUM_CLASSES, FREEZE_BN, SOLVER.BATCH_SIZE, SOURCE_INPUT_SIZE_TRAIN,
# INPUT_SIZE_TEST, TEST.BATCH_SIZE); 32 synthetic images evaluated
DEEPLAB_GEOMETRY = ("deeplab_resnet101", 19, True, TRAIN_BATCH, (TRAIN_W, TRAIN_H),
                    (SERVE_W, SERVE_H), 1)
DEEPLAB_EVAL_IMAGES = 32
# the attn training path: configs/attn_src_kvasir.yaml as (MODEL.NAME,
# NUM_CLASSES, SOLVER.BATCH_SIZE, SOURCE_INPUT_SIZE_TRAIN, AUG.NAME, the AUG
# probabilities (PROB, BLUR, ROTATE, JITTER, FLIP), BASE_LR, WEIGHT_DECAY)
ATTN_TRAIN_GEOMETRY = (ATTN_MODEL, 2, 20, (ATTN_SIZE, ATTN_SIZE), "attn", (0.7,) * 5,
                       1e-3, 1e-4)
ATTN_TRAIN_STEPS = 6
# the FADA paths, as (MODEL.NAME, NUM_CLASSES, SOLVER.BATCH_SIZE, SOURCE and
# TARGET_INPUT_SIZE_TRAIN, BASE_LR, BASE_LR_D) of configs/deeplabv2_r101_adv.yaml
# (and with MODEL.NAME deeplab_vgg16), gald_adv.yaml and attn_adv_kvasir.yaml;
# each step takes BATCH_SIZE // 2 images of each domain
DEEPLAB_FADA_GEOMETRY = ("deeplab_resnet101", 19, 8, (TRAIN_W, TRAIN_H), (SERVE_W, SERVE_H),
                         2.5e-4, 1e-4)
VGG_FADA_GEOMETRY = ("deeplab_vgg16",) + DEEPLAB_FADA_GEOMETRY[1:]
GALD_FADA_GEOMETRY = ("gald_hardnet68", 19, 5, (TRAIN_W, TRAIN_H), (SERVE_W, SERVE_H),
                      0.5e-4, 1e-4)
ATTN_FADA_GEOMETRY = (ATTN_MODEL, 2, 20, (ATTN_SIZE, ATTN_SIZE), (ATTN_SIZE, ATTN_SIZE),
                      1e-3, 1e-4)
FADA_STEPS = {"deeplab": 3, "gald": 4, "attn": 4, "vgg16": 2}
FADA_EVAL_IMAGES = 4
# the paths on files (DATA_TREES): steps of FADA (12 GTA5 images, 4 a step),
# of the distillation (12 Cityscapes images, 5 a step), of attn (two
# epochs of 120 Kvasir images, 20 a step) and of pranet's FADA (120 Kvasir
# images, 8 a step)
FILE_STEPS = {"fada": 3, "distill": 2, "attn": 12, "pranet_fada": 15}
ATTN_FILE_EPOCHS = 2
# configs/deeplabv2_r101_tgt_self_distill.yaml as (MODEL.NAME, NUM_CLASSES,
# SOURCE_TRAIN, BATCH_SIZE, SOURCE_INPUT_SIZE_TRAIN, INPUT_SCALES_TRAIN,
# HORIZONTAL_FLIP_PROB_TRAIN, DISTILL.ONLINE)
DISTILL_GEOMETRY = ("deeplab_resnet101", 19, "cityscapes_self_distill_train", 5, (1024, 512),
                    (0.5, 1.5), 0.5, False)
# the PraNet paths: configs/pranet_src_polyp.yaml as (MODEL.NAME, NUM_CLASSES,
# SOLVER.BATCH_SIZE, INPUT.TRAINSIZE, INPUT_SIZE_TEST, TEST.BATCH_SIZE, BASE_LR,
# AUG.NAME), the sides of its three rates, and pranet_adv_polyp_bli.yaml as the
# FADA geometry (each step takes BATCH_SIZE // 2 images of each domain)
PRANET_SIDE = 352
PRANET_GEOMETRY = ("pranet_res2net50", 2, 16, PRANET_SIDE, (PRANET_SIDE, PRANET_SIDE), 1,
                   1e-4, "pra")
PRANET_RATE_SIDES = (256, 352, 448)
PRANET_FADA_GEOMETRY = ("pranet_res2net50", 2, 16, (PRANET_SIDE, PRANET_SIDE),
                        (PRANET_SIDE, PRANET_SIDE), 1e-4, 1e-4)
# the head against its plain recomputation on the same device: the same
# operations in the same order, up to the resize's float32 rounding
PRANET_HEAD_TOLERANCE = 1e-5
# the card against the CPU: a seeded pranet_res2net50 at 64x64 in eval mode,
# the maps within this share of their largest magnitude (float32 sums in
# other orders through about 60 convolutions; cuDNN without TF32)
PRANET_CPU_TOLERANCE = 1e-4
# PR 9's attn step of 20 at 512x512 on the card (NVIDIA H100 80GB HBM3, 700 W)
ATTN_PR9_STEP_MS = 273.8
# the card against the CPU: a seeded deeplab_resnet18 at 64x64, logits within
# this share of their largest magnitude (float32 sums in other orders through
# 20 convolutions; cuDNN without TF32)
DEEPLAB_CPU_TOLERANCE = 1e-4
# online distillation: the steps each phase takes (the datasets cut to that
# many batches), and the criss-cross launches of a GALD online step (teacher
# 2 forwards; student 2 forwards, 2 backwards); DISTILL.CONFIDENCE_THRESHOLD
# of the deeplab phase
ONLINE_STEPS = {"deeplab": 2, "gald": 3, "attn": 3, "pranet": 2}
ONLINE_GALD_LAUNCHES = (4, 2)
ONLINE_THRESHOLD = 0.9
# the device augmentation's apply functions on the card against the CPU with
# the same draws: float32 transcendentals and sums in other orders (x255
# after TO_BGR255, x1/0.224 after the ImageNet normalisation)
DEVICE_AUG_TOLERANCE = 1e-5
DEVICE_AUG_EPOCHS = 2
# numbers of one phase that a later one reports beside its own
MEASURED = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run "
                         "needs an NVIDIA GPU")
    resolve_device("cuda")  # also switches TF32 off for the whole run
    line = card_line()
    log(f"[device] nvidia-smi: {line}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return line


BUILD_OUTPUT = {}


def phase_build() -> None:
    t0 = time.perf_counter()
    built = native.build(ccattn.SOURCES + mbconv.SOURCES)
    BUILD_OUTPUT.update({name: out for name, (_, out) in built.items()})
    for name, (seconds, out) in built.items():
        log(f"[build] {name}: {seconds:.2f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all sources in {time.perf_counter() - t0:.2f} s")


def cc_inputs(shape, dtype, seed=0):
    b, h, w, cq, c = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(size, device="cuda", generator=gen).to(dtype)
                 for size in ((b, h, w, cq), (b, h, w, cq), (b, h, w, c)))


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time per call: ``reps`` calls captured in a CUDA graph, replayed,
    timed with CUDA events (no host launch cost in the window)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def cc_bound(shape, dtype):
    """Least time for the function at ``shape``: each input read once and the
    output written once, against the operations it must do at the input
    type's peak rate."""
    b, h, w, cq, c = shape
    item = torch.tensor([], dtype=dtype).element_size()
    pixels = b * h * w
    nbytes = item * pixels * (2 * cq + 2 * c)
    flops = pixels * ((h + w) * (2 * cq + 3 + 2 * c) + c)  # energies, softmax, sums
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOP_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cc_bwd_bound(shape, dtype):
    """Least time for the backward at ``shape``: q, k, v, g read once and dq,
    dk, dv written once, against its five contractions (e, da, dq, dk, dv) and
    the softmax at the input type's peak rate."""
    b, h, w, cq, c = shape
    item = torch.tensor([], dtype=dtype).element_size()
    pixels = b * h * w
    nbytes = item * pixels * (4 * cq + 3 * c)
    flops = pixels * (h + w) * (6 * cq + 4 * c + 8)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOP_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _pass_us(run, kernel: str, passes: int, calls: int = 10):
    """Median device time of each of the ``passes`` launches of ``kernel`` that
    one ``run()`` makes, over the last ``calls`` of ``calls + 5`` runs, from
    torch.profiler's CUDA activity (the tracer may miss the first launches
    after it starts, so the window ends on whole calls).  None when the
    tracer recorded no launch of it in two tries: it saw no device activity
    (it has missed a whole first use in a process), and the per-pass times
    are not measured."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls + 5):
                run()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if kernel in e.name),
                        key=lambda e: e.time_range.start)[-passes * calls:]
        if events:
            break
    if not events:
        return None
    if len(events) != passes * calls:
        raise AssertionError(f"profiled {len(events)} launches of {kernel}, want "
                             f"{passes * calls}")
    return [float(np.median([e.device_time for e in events[i::passes]]))
            for i in range(passes)]


def _log_passes(names, passes) -> None:
    if passes is None:
        log("[kernel]   by pass: not measured (torch.profiler recorded no device activity)")
    else:
        log("[kernel]   by pass (torch.profiler, device us): " + ", ".join(
            f"{name} {us:.2f}" for name, us in zip(names, passes)))


def phase_kernels_bwd() -> dict:
    """Kernel #2 against its plain version and autograd of the plain forward
    at every shape of CC_SHAPES, in float32 and bfloat16, with its time beside
    its bound and the plain version's; two calls at the training shape must
    give the same bits.  First, what the runtime says of the instances that
    each pass takes at the training shape and at 64x128."""
    for shape in (TRAIN_CC_SHAPE, CC_SHAPES[-1]):
        for i, name in enumerate(ccattn.BWD_PASSES):
            log(f"[kernel] cc_attention_bwd {shape} float32, pass {i + 1} ({name}): "
                f"{ccattn.bwd_pass_info(shape, torch.float32, i)}")
    result = {}
    for shape in CC_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = cc_inputs(shape, dtype)
            g = cc_inputs(shape, dtype, seed=1)[2]
            got = ccattn.cc_attention_core_bwd_cuda(q, k, v, g)
            torch.cuda.synchronize()
            if shape == TRAIN_CC_SHAPE:
                again = ccattn.cc_attention_core_bwd_cuda(q, k, v, g)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                log(f"[kernel] cc_attention_bwd {shape} {str(dtype)[6:]}: two calls "
                    f"give {'the same bits' if same else 'DIFFERENT BITS'}")
                if not same:
                    raise AssertionError(f"cc_attention_bwd is not repeatable at {shape} "
                                         f"{dtype}")
            plain = ccattn.cc_attention_core_bwd_plain(q, k, v, g)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            auto = torch.autograd.grad(ccattn.cc_attention_core_plain(*leaves), leaves, g)
            rel = BWD_TOLERANCE[dtype]
            err, ok = 0.0, True
            for name, o, p, a in zip(("dq", "dk", "dv"), got, plain, auto):
                for ref in (p, a):
                    scale = ref.float().abs().max().item()
                    e = (o.float() - ref.float()).abs().max().item()
                    err = max(err, e)
                    ok = ok and o.dtype == dtype and o.shape == ref.shape \
                        and bool(torch.isfinite(o).all()) and e <= rel * scale
            log(f"[kernel] cc_attention_bwd {shape} {str(dtype)[6:]}: max abs err "
                f"{err:.3e} against the plain backward and autograd of the plain "
                f"forward (tolerance {rel:g} x max|plain|) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"cc_attention_bwd disagrees with its plain version "
                                     f"at {shape} {dtype}: {err}")
            ms = graph_ms(lambda: ccattn.cc_attention_core_bwd_cuda(q, k, v, g))
            plain_ms = graph_ms(lambda: ccattn.cc_attention_core_bwd_plain(q, k, v, g))
            bound_ms, bound_by = cc_bwd_bound(shape, dtype)
            log(f"[kernel]   {ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
                f"({bound_by}), plain version {plain_ms * 1e3:.2f} us")
            if dtype == torch.float32:
                _log_passes(ccattn.BWD_PASSES, _pass_us(
                    lambda: ccattn.cc_attention_core_bwd_cuda(q, k, v, g),
                    "cc_attention_bwd_kernel", 3))
            if shape == TRAIN_CC_SHAPE:
                result[dtype] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": bound_by}
    return {**result[torch.float32], "bf16": result[torch.bfloat16]}


def cc_sdpa(q, k, v, mask):
    """The yardstick: the same function as one masked
    ``scaled_dot_product_attention`` over the H*W pixels of an image, dense in
    (H*W)^2; the port never calls it."""
    b, h, w, cq = q.shape
    out = torch.nn.functional.scaled_dot_product_attention(
        q.view(b, 1, h * w, cq), k.view(b, 1, h * w, cq), v.view(b, 1, h * w, -1),
        attn_mask=mask, scale=1.0)
    return out.view(v.shape)


def cc_mask(h: int, w: int) -> torch.Tensor:
    """[H*W, H*W] boolean: pixel p sees p' in its row (itself included) and in
    its column: the W row keys and the H-1 column keys, each once."""
    rows = torch.arange(h, device="cuda").repeat_interleave(w)
    cols = torch.arange(w, device="cuda").repeat(h)
    return (rows[:, None] == rows[None, :]) | (cols[:, None] == cols[None, :])


def _within(out, ref, dtype):
    atol, rtol = TOLERANCE[dtype]
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all()) and out.dtype == dtype
    return diff.max().item(), ok


def phase_kernels() -> dict:
    """Kernel #1 against its plain version at every shape of CC_SHAPES, in
    float32 and bfloat16, with its time beside its bound, the plain version's
    and the masked-SDPA yardstick's (checked against the plain version
    first); two calls at the training shape must give the same bits.  First,
    what the runtime says of each pass at the training shape and at 64x128."""
    for shape in (TRAIN_CC_SHAPE, CC_SHAPES[-1]):
        for i, name in enumerate(ccattn.FWD_PASSES):
            log(f"[kernel] cc_attention_fwd {shape} float32, pass {i + 1} ({name}): "
                f"{ccattn.fwd_pass_info(shape, torch.float32, i)}")
    result = {}
    for shape in CC_SHAPES:
        mask = cc_mask(*shape[1:3])
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = cc_inputs(shape, dtype)
            out = ccattn.cc_attention_core(q, k, v)
            torch.cuda.synchronize()
            ref = ccattn.cc_attention_core_plain(q, k, v)
            err, ok = _within(out, ref, dtype)
            atol, rtol = TOLERANCE[dtype]
            log(f"[kernel] cc_attention_fwd {shape} {str(dtype)[6:]}: max abs err "
                f"{err:.3e} (tolerance {atol:g} + {rtol:g}*|plain|) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"cc_attention_fwd disagrees with its plain version "
                                     f"at {shape} {dtype}: {err}")
            if shape == TRAIN_CC_SHAPE:
                same = torch.equal(out, ccattn.cc_attention_core_cuda(q, k, v))
                log(f"[kernel] cc_attention_fwd {shape} {str(dtype)[6:]}: two calls "
                    f"give {'the same bits' if same else 'DIFFERENT BITS'}")
                if not same:
                    raise AssertionError(f"cc_attention_fwd is not repeatable at {shape} "
                                         f"{dtype}")
            sdpa_err, sdpa_ok = _within(cc_sdpa(q, k, v, mask), ref, dtype)
            log(f"[kernel]   masked SDPA yardstick: max abs err {sdpa_err:.3e} against the "
                f"plain version {'ok' if sdpa_ok else 'FAIL'}")
            if not sdpa_ok:
                raise AssertionError(f"masked SDPA disagrees with the plain version at "
                                     f"{shape} {dtype}: {sdpa_err}")
            ms = graph_ms(lambda: ccattn.cc_attention_core(q, k, v))
            plain_ms = graph_ms(lambda: ccattn.cc_attention_core_plain(q, k, v))
            library_ms = graph_ms(lambda: cc_sdpa(q, k, v, mask))
            bound_ms, bound_by = cc_bound(shape, dtype)
            log(f"[kernel]   {ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
                f"({bound_by}), plain version {plain_ms * 1e3:.2f} us, masked SDPA "
                f"{library_ms * 1e3:.2f} us")
            if dtype == torch.float32:
                _log_passes(ccattn.FWD_PASSES, _pass_us(
                    lambda: ccattn.cc_attention_core_cuda(q, k, v),
                    "cc_attention_fwd_kernel", 2))
            if shape in (MAIN_CC_SHAPE, TRAIN_CC_SHAPE):
                result[shape, dtype] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                        "bound_ms": bound_ms, "bound_by": bound_by,
                                        "library_ms": library_ms}
    return result


def attn_mbconv_shapes(size: int = ATTN_SIZE) -> dict:
    """{(C, H, W, k): number of blocks} of the MBConv blocks of one forward that
    take the fused path (expansion, stride 1), from the model's block list."""
    shapes, hw = {}, -(-size // 2)  # the stem halves the input
    for k, stride, expand, c_in, _, _ in block_list(ATTN_MODEL.split("_")[1]):
        hw = -(-hw // stride)
        if expand != 1 and stride == 1:
            shapes[(c_in, hw, hw, k)] = shapes.get((c_in, hw, hw, k), 0) + 1
    return shapes


def mbconv_inputs(shape, f, dtype, seed=0):
    """x, w_exp, s0, b0, w_dw, s1, b1 with activations and affines of order 1."""
    b, c, h, w, k = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *size: torch.randn(size, device="cuda", generator=gen)
    rand = lambda lo, hi: torch.rand(f, device="cuda", generator=gen) * (hi - lo) + lo
    x = randn(b, c, h, w).to(dtype)
    w_exp = (randn(f, c) * (1.7 / c) ** 0.5).to(dtype)
    w_dw = randn(f, k, k) * (1.7 / (k * k)) ** 0.5
    return x, w_exp, rand(0.5, 1.5), rand(-0.2, 0.2), w_dw, rand(0.5, 1.5), rand(-0.2, 0.2)


def _mbconv_bytes_s(shape, f, dtype):
    """x and the weights read once and y written once, over the HBM rate."""
    b, c, h, w, k = shape
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * b * h * w * (c + f) + item * f * c + 4 * f * (k * k + 4)
    return nbytes / PEAK_BYTES_PER_S


def _bound(t_bytes, t_ops):
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def mbconv_bound(shape, f, dtype):
    """Least time for the function at ``shape``: its bytes against the product
    (2C per output), the stencil (2k^2) and the two affines and swishes (12)
    at the input type's peak."""
    b, c, h, w, k = shape
    flops = b * h * w * f * (2 * c + 2 * k * k + 12)
    return _bound(_mbconv_bytes_s(shape, f, dtype), flops / PEAK_FLOP_PER_S[dtype])


def mbconv_tc_bound(shape, f, dtype):
    """``mbconv_bound`` for a kernel whose product runs on the tensor cores:
    the same bytes, against the product (2C per output) at the tensor-core
    rate plus the stencil and swishes (2k^2 + 12) at 67 TFLOP/s."""
    b, c, h, w, k = shape
    outputs = b * h * w * f
    t_ops = (outputs * 2 * c / PEAK_TC_FLOP_PER_S[dtype]
             + outputs * (2 * k * k + 12) / PEAK_FLOP_PER_S[torch.float32])
    return _bound(_mbconv_bytes_s(shape, f, dtype), t_ops)


_INSTANCE = re.compile(r"fused_mbconv_fwd_kernelI(f|13__nv_bfloat16)Li(\d)E")


def _instance_name(mangled: str) -> str:
    m = _INSTANCE.search(mangled)
    return f"{'float32' if m.group(1) == 'f' else 'bfloat16'} k={m.group(2)}" if m else ""


def mbconv_build_report() -> None:
    """ptxas' registers and spills of each instance, the runtime's view of
    its shared memory and residency, and the HMMA (tensor-core) instructions
    in its machine code."""
    current = ""
    for line in BUILD_OUTPUT.get(mbconv.SOURCE, "").splitlines():
        if "Compiling entry function" in line:
            current = _instance_name(line)
        elif current and ("registers" in line or "spill" in line):
            log(f"[kernel] ptxas {current}: {line.strip()}")
    for k in mbconv.KERNEL_SIZES:
        for dtype in (torch.float32, torch.bfloat16):
            log(f"[kernel] runtime {str(dtype)[6:]} k={k}: {mbconv.instance_info(k, dtype)}")
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        log("[kernel] HMMA instructions: not measured (no cuobjdump)")
        return
    sass = subprocess.run([cuobjdump, "-sass", native.library_path(mbconv.SOURCE)],
                          capture_output=True, text=True, timeout=120).stdout
    counts, current = {}, ""
    for line in sass.splitlines():
        if "Function :" in line:
            current = _instance_name(line)
        elif current and "HMMA" in line:
            counts[current] = counts.get(current, 0) + 1
    log(f"[kernel] HMMA instructions in {os.path.basename(native.library_path(mbconv.SOURCE))}"
        f" by instance (cuobjdump -sass): {counts or 'none'}")


def _mbconv_compare(shape, f, dtype):
    """The kernel against its plain version, borders and interior apart."""
    b, c, h, w, k = shape
    args = mbconv_inputs(shape, f, dtype)
    out = mbconv.fused_mbconv_core(*args)
    torch.cuda.synchronize()
    ref = mbconv.fused_mbconv_core_plain(*args)
    atol, rtol = TOLERANCE[dtype]
    diff = (out.float() - ref.float()).abs()
    bad = diff > atol + rtol * ref.float().abs()
    p = (k - 1) // 2
    border = torch.ones((h, w), dtype=torch.bool, device="cuda")
    border[p:h - p, p:w - p] = False
    err_border = diff[..., border].max().item() if border.any() else 0.0
    err_inner = diff[..., ~border].max().item() if (~border).any() else 0.0
    ok = (out.dtype == dtype and out.shape == (b, f, h, w) and not bool(bad.any())
          and bool(torch.isfinite(out).all()))
    log(f"[kernel] fused_mbconv_fwd B={b} C={c}->F={f} {h}x{w} k={k} {str(dtype)[6:]}: "
        f"max abs err {max(err_border, err_inner):.3e} (border ring {err_border:.3e}, "
        f"interior {err_inner:.3e}; tolerance {atol:g} + {rtol:g}*|plain|) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fused_mbconv_fwd disagrees with its plain version at "
                             f"{shape} F={f} {dtype}")
    return args, max(err_border, err_inner)


def phase_kernels_mbconv() -> dict:
    """Kernel #3 against its plain version at every shape of the B2 forward
    (B in {1, 8}) and at odd shapes; its time beside its bound, the plain
    version's time and the unfused module path's (several library calls)."""
    shapes = attn_mbconv_shapes()
    if sum(shapes.values()) != MBCONV_LAUNCHES_PER_FORWARD or len(shapes) != 8:
        raise AssertionError(f"{ATTN_MODEL} at {ATTN_SIZE}: fused blocks {shapes}")
    mbconv_build_report()
    before = mbconv.KERNEL_LAUNCHES
    for shape in MBCONV_ODD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            _mbconv_compare(shape, 3 * shape[1], dtype)
    per_shape, main, main_bf16 = [], {}, {}
    for (c, h, w, k), count in shapes.items():
        f = 6 * c
        for dtype in (torch.float32, torch.bfloat16):
            _mbconv_compare((1, c, h, w, k), f, dtype)
            shape = (ATTN_BATCH, c, h, w, k)
            args, err = _mbconv_compare(shape, f, dtype)
            with torch.inference_mode():
                ms = graph_ms(lambda: mbconv.fused_mbconv_core(*args))
                plain_ms = graph_ms(lambda: mbconv.fused_mbconv_core_plain(*args))
            bound_ms, bound_by = mbconv_bound(shape, f, dtype)
            tc_bound_ms, tc_bound_by = mbconv_tc_bound(shape, f, dtype)
            entry = {"shape": list(shape), "f": f, "blocks": count, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "tc_bound_ms": tc_bound_ms,
                     "tc_bound_by": tc_bound_by}
            if dtype == torch.float32:
                # the module's own two routes through the segment, from one set of
                # weights: the fused one folds both BatchNorms and launches the
                # kernel, the unfused one is conv, BN, swish, conv, BN, swish
                block = MBConvBlock(c, c, k, 1, 6, 0.25, fused_mbconv=True)
                randomize_weights_(block, seed=c + k).cuda().eval()
                with torch.inference_mode():
                    fused, unfused = block.segment_fused(args[0]), block.segment_unfused(args[0])
                    seg_err = (fused - unfused).abs().max().item()
                    atol, rtol = TOLERANCE[dtype]
                    if bool(((fused - unfused).abs() > atol + rtol * unfused.abs()).any()):
                        raise AssertionError(f"MBConvBlock fused and unfused segments differ "
                                             f"at {shape}: {seg_err}")
                    entry["segment_ms"] = graph_ms(lambda: block.segment_fused(args[0]))
                    entry["unfused_ms"] = graph_ms(lambda: block.segment_unfused(args[0]))
                entry["segment_max_abs_err"] = seg_err
                per_shape.append(entry)
                log(f"[kernel]   x{count} blocks: kernel {ms * 1e3:.2f} us, bound "
                    f"{bound_ms * 1e3:.2f} us ({bound_by}), tensor-core bound "
                    f"{tc_bound_ms * 1e3:.2f} us ({tc_bound_by}), plain version "
                    f"{plain_ms * 1e3:.2f} us; module segment fused (BN folds + kernel) "
                    f"{entry['segment_ms'] * 1e3:.2f} us vs unfused (conv, BN, swish, conv, "
                    f"BN, swish: library calls) {entry['unfused_ms'] * 1e3:.2f} us, "
                    f"unfused / kernel {entry['unfused_ms'] / ms:.2f}, "
                    f"fused vs unfused max abs err {seg_err:.3e}")
                if shape == MAIN_MBCONV_SHAPE:
                    main = {k2: entry[k2] for k2 in ("max_abs_err", "ms", "plain_ms",
                                                     "bound_ms", "bound_by", "tc_bound_ms",
                                                     "tc_bound_by", "unfused_ms")}
            else:
                per_shape[-1]["bf16"] = entry
                if shape == MAIN_MBCONV_SHAPE:
                    main_bf16 = {k2: entry[k2] for k2 in ("max_abs_err", "ms", "plain_ms",
                                                          "bound_ms", "bound_by")}
                log(f"[kernel]   bfloat16: kernel {ms * 1e3:.2f} us, bound "
                    f"{bound_ms * 1e3:.2f} us ({bound_by}), tensor-core bound "
                    f"{tc_bound_ms * 1e3:.2f} us ({tc_bound_by}), plain version "
                    f"{plain_ms * 1e3:.2f} us; bfloat16 / float32 kernel "
                    f"{ms / per_shape[-1]['ms']:.2f}")
    totals = {key: sum(e[key] * e["blocks"] for e in per_shape)
              for key in ("ms", "bound_ms", "tc_bound_ms", "plain_ms", "segment_ms",
                          "unfused_ms")}
    log(f"[kernel] fused_mbconv_fwd over the {MBCONV_LAUNCHES_PER_FORWARD} blocks of one "
        f"B={ATTN_BATCH} forward, float32: kernel {totals['ms']:.3f} ms, bound "
        f"{totals['bound_ms']:.3f} ms, tensor-core bound {totals['tc_bound_ms']:.3f} ms, "
        f"plain version {totals['plain_ms']:.3f} ms, module segment fused "
        f"{totals['segment_ms']:.3f} ms vs unfused {totals['unfused_ms']:.3f} ms, "
        f"unfused / kernel {totals['unfused_ms'] / totals['ms']:.2f}; bfloat16 kernel "
        f"{sum(e['bf16']['ms'] * e['blocks'] for e in per_shape):.3f} ms")
    if not main or mbconv.KERNEL_LAUNCHES == before:
        raise AssertionError("the main fused-MBConv shape was not measured")
    return {**main, "shape": list(MAIN_MBCONV_SHAPE), "bf16": main_bf16,
            "per_shape": per_shape, "per_forward_ms": totals}


def host_ms(fn, reps: int = 3) -> float:
    """Host-clock time per call after one warm call; ``fn`` ends in a sync."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _png(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG", compress_level=1)
    return buf.getvalue()


def _post(port: int, body: bytes, path="/predict?format=raw"):
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    return resp.status, data, time.perf_counter() - t0


def _get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _stderr_logger(name: str, level=logging.WARNING):
    logger = logging.getLogger(name)
    logger.addHandler(logging.StreamHandler(sys.stderr))
    logger.setLevel(level)
    return logger


def _seeded_checkpoint(tag: str, cfg, pth: str) -> None:
    spec = build_segmentor(cfg)
    randomize_weights_(torch.nn.ModuleDict(spec.modules), seed=0)
    save_reference_checkpoint(spec.modules, pth)
    log(f"[{tag}] seeded full-width weights: "
        f"{sum(p.numel() for m in spec.modules.values() for p in m.parameters())} "
        f"parameters -> {pth}")


def serve_traffic(tag: str, cfg, args, render, w: int, h: int, card: str, counter):
    """Starts the daemon, sends N_REQUESTS PNGs of w x h from N_THREADS threads
    and stops it.  ``counter`` is (module, attribute) of the kernel's launch
    count: set to 0 just before the traffic and read just after.  Returns the
    stopped server, the request bodies, the masks, the number of batches, the
    launches and the wall time of the traffic."""
    from PIL import Image

    t0 = time.perf_counter()
    inf, httpd = make_server(cfg, render, _stderr_logger(f"chip_smoke.{tag}"), port=0,
                             max_batch=args.max_batch,
                             batch_timeout_ms=args.batch_timeout_ms)
    port = httpd.server_address[1]
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    try:
        while _get(port, "/healthz")[0] != 200:
            if time.perf_counter() - t0 > 600 or not inf._thread.is_alive():
                raise RuntimeError("server did not become ready")
            time.sleep(0.2)
        log(f"[{tag}] ready on port {port} after {time.perf_counter() - t0:.1f} s "
            f"(model load + warm-up of buckets 1..{MAX_BATCH} at {w}x{h})")

        rng = np.random.RandomState(0)
        images = [(rng.rand(h, w, 3) * 255).astype(np.uint8) for _ in range(N_REQUESTS)]
        bodies = [_png(a) for a in images]
        results = [None] * N_REQUESTS

        def client(i0):
            for i in range(i0, N_REQUESTS, N_THREADS):
                results[i] = _post(port, bodies[i])

        before = inf.snapshot_stats()
        setattr(*counter, 0)
        t_start = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t_start
        launches = getattr(*counter)
        after = inf.snapshot_stats()
        if any(t.is_alive() for t in threads):
            raise RuntimeError("requests did not finish")

        masks = []
        for i, (status, data, _) in enumerate(results):
            if status != 200:
                raise AssertionError(f"request {i}: HTTP {status} {data[:200]!r}")
            mask = np.asarray(Image.open(io.BytesIO(data)))
            if mask.shape != (h, w) or mask.max() >= cfg.MODEL.NUM_CLASSES:
                raise AssertionError(f"request {i}: mask {mask.shape}, max {mask.max()}")
            masks.append(mask)
        batches = after["batches"] - before["batches"]
        served = after["batched_images"] - before["batched_images"]
        status, body = _get(port, "/stats")
        stats = json.loads(body)
        log(f"[{tag}] {N_REQUESTS} requests from {N_THREADS} threads: {batches} batches, "
            f"{served} images, /stats {stats}")
        if (status != 200 or served != N_REQUESTS or after["errors"] != before["errors"]
                or after["requests"] - before["requests"] != N_REQUESTS):
            raise AssertionError(f"stats disagree with the traffic: {before} -> {after}")

        lat = np.array([r[2] for r in results]) * 1e3
        log(f"[{tag}] on {card}: request latency p50 {np.percentile(lat, 50):.1f} ms, "
            f"p90 {np.percentile(lat, 90):.1f} ms (of {N_REQUESTS}: the highest percentile "
            f"with a sample above it), max {lat.max():.1f} ms, {N_REQUESTS / wall:.2f} images/s "
            f"(PNG decode to mask PNG, {N_THREADS} clients, max batch {MAX_BATCH})")
    finally:
        httpd.shutdown()
        httpd.server_close()
        inf.shutdown()
        http_thread.join(60)
    return inf, bodies, masks, batches, launches, wall


def serve_breakdown(tag: str, inf, bodies, masks, w: int, h: int, batches: int,
                    wall: float, card: str) -> torch.Tensor:
    """Where a request's time goes: host decode, one full-batch dispatch (copy
    in, forward, argmax, copy out), the forward alone, and the mask encode.
    Returns the device batch it used."""
    tester = inf.tester
    batch = np.stack([inf.preprocess(b) for b in bodies[:MAX_BATCH]])
    x = torch.from_numpy(batch).to(tester.device).permute(0, 3, 1, 2).contiguous()
    decode_ms = host_ms(lambda: inf.preprocess(bodies[0]))
    run_ms = host_ms(lambda: inf._run(batch))
    forward_ms = host_ms(lambda: tester._probs_impl(x, (h, w)).sum().item())
    encode_ms = host_ms(lambda: inf.encode_png(masks[0]))
    log(f"[{tag}] breakdown on {card}: decode+preprocess {decode_ms:.1f} ms/image, "
        f"dispatch of {MAX_BATCH} {run_ms:.1f} ms (forward alone {forward_ms:.1f} ms), "
        f"palette PNG encode {encode_ms:.1f} ms/mask; {batches} batches x forward "
        f"<= {batches * forward_ms / (wall * 1e3):.0%} of the {wall * 1e3:.0f} ms window")
    return x


def _check_agreement(tag: str, what: str, probs: torch.Tensor, masks,
                     minimum: float = MIN_MASK_AGREEMENT) -> None:
    if not torch.isfinite(probs).all():
        raise AssertionError(f"{what}: probabilities are not finite")
    other = probs.argmax(1).to(torch.uint8).cpu().numpy()
    agreement = float((other == np.stack(masks[:MAX_BATCH])).mean())
    log(f"[{tag}] served masks vs {what}: argmax agreement {agreement:.6f} "
        f"(minimum {minimum})")
    if agreement < minimum:
        raise AssertionError(f"argmax agreement {agreement} < {minimum}")


def phase_serve(tmp: str, card: str) -> int:
    pth = os.path.join(tmp, "Gald-seeded.pth")
    args = build_parser().parse_args([
        "--max-batch", str(MAX_BATCH), "MODEL.NAME", "gald_hardnet68",
        "MODEL.NUM_CLASSES", "19", "INPUT.INPUT_SIZE_TEST", f"({SERVE_W}, {SERVE_H})",
        "AUG.NAME", "gald", *FLOAT32, "OUTPUT_DIR", tmp, "resume", pth])
    cfg = load_cfg(args)
    _seeded_checkpoint("serve", cfg, pth)
    render = load_json(os.path.join(HERE, "renders", "cityscapes.json"))
    inf, bodies, masks, batches, launches, wall = serve_traffic(
        "serve", cfg, args, render, SERVE_W, SERVE_H, card, (ccattn, "KERNEL_LAUNCHES"))
    if launches != 2 * batches or launches == 0:
        raise AssertionError(f"cc_attention_fwd launched {launches} times for "
                             f"{batches} batches; want 2 per batch")
    log(f"[serve] cc_attention_fwd launches: {launches} = 2 x {batches} batches")
    x = serve_breakdown("serve", inf, bodies, masks, SERVE_W, SERVE_H, batches, wall, card)

    # one batch against the same forward with the plain attention core
    with mock.patch.object(gcpa, "cc_attention_core", ccattn.cc_attention_core_plain):
        probs = inf.tester._probs_impl(x, (SERVE_H, SERVE_W))
    if (probs.sum(1) - 1).abs().max() > 1e-4:
        raise AssertionError("plain-core probabilities are not a distribution")
    _check_agreement("serve", "plain-core forward", probs, masks)
    return launches


def _set_fused(tester, enabled: bool) -> None:
    for block in tester.spec.modules["encoder"].blocks:
        block.fused_mbconv = enabled


def _attn_opts(tmp: str, pth: str, *more):
    return ["-cfg", os.path.join(HERE, "configs", "attn_src_kvasir.yaml"),
            "-c", os.path.join(HERE, "renders", "kvasir.json"),
            *FLOAT32, "OUTPUT_DIR", tmp, "resume", pth, *more]


def _check_attn_geometry(cfg) -> None:
    geometry = (cfg.MODEL.NAME, cfg.MODEL.NUM_CLASSES, tuple(cfg.INPUT.INPUT_SIZE_TEST))
    if geometry != (ATTN_MODEL, 2, (ATTN_SIZE, ATTN_SIZE)):
        raise AssertionError(f"configs/attn_src_kvasir.yaml gives {geometry}")


def _eval_attn_checkpoint(tag: str, tmp: str, pth: str, card: str) -> int:
    """``cli.test``'s own function on the attn checkpoint ``pth``, with the
    fused kernel on, then the same run with it off; returns the fused run's
    launches."""
    logger = _stderr_logger(f"chip_smoke.{tag}", logging.INFO)
    runs = {}
    for fused in (True, False):
        out_dir = os.path.join(tmp, f"{tag}_{'fused' if fused else 'unfused'}")
        args = test_cli.build_parser().parse_args(_attn_opts(
            out_dir, pth, "DATASETS.TEST", "synthetic_val",
            "DATASETS.SYNTHETIC_LENGTH", str(ATTN_EVAL_IMAGES),
            "TEST.BATCH_SIZE", str(ATTN_BATCH), "MODEL.FUSED_MBCONV", str(fused)))
        cfg = load_cfg(args)
        _check_attn_geometry(cfg)
        tester = test_cli.make_tester(cfg, load_json(args.config_path), logger=logger)
        forwards = []
        hook = tester.segmentor.register_forward_hook(
            lambda mod, inp, out: forwards.append(tuple(inp[0].shape)))
        torch.cuda.synchronize()
        mbconv.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        summary = tester.test()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = mbconv.KERNEL_LAUNCHES
        hook.remove()
        want = [(ATTN_BATCH, 3, ATTN_SIZE, ATTN_SIZE)] * (ATTN_EVAL_IMAGES // ATTN_BATCH)
        if forwards != want:
            raise AssertionError(f"eval forwards {forwards}, want {want}")
        expected = MBCONV_LAUNCHES_PER_FORWARD * len(forwards) if fused else 0
        if launches != expected:
            raise AssertionError(f"fused_mbconv_fwd launched {launches} times over "
                                 f"{len(forwards)} forwards with FUSED_MBCONV {fused}; "
                                 f"want {expected}")
        scalars = [v for v in summary.values() if isinstance(v, float)]
        if not scalars or not all(np.isfinite(scalars)) or not 0 < summary["micro_miou"] <= 1:
            raise AssertionError(f"summary {summary}")
        cmt = tester.confusion
        written = load_json(os.path.join(out_dir, "attn_confusion_matrix.json"))
        if cmt.sum() != ATTN_EVAL_IMAGES * ATTN_SIZE ** 2 or written["cmt"] != cmt.tolist():
            raise AssertionError(f"confusion matrix {cmt.tolist()} / file {written}")
        x = torch.rand(ATTN_BATCH, 3, ATTN_SIZE, ATTN_SIZE, device=tester.device,
                       generator=torch.Generator(device=tester.device).manual_seed(0))
        forward_ms = host_ms(
            lambda: tester._probs_impl(x, (ATTN_SIZE, ATTN_SIZE)).sum().item())
        # the same forward replayed from a CUDA graph: device time with no host in the way
        device_ms = graph_ms(lambda: tester._probs_impl(x, (ATTN_SIZE, ATTN_SIZE)),
                             reps=2, replays=5)
        log(f"[{tag}] FUSED_MBCONV {fused} on {card}: {ATTN_EVAL_IMAGES} images in "
            f"{len(forwards)} batches of {ATTN_BATCH} at {ATTN_SIZE}x{ATTN_SIZE}, "
            f"{launches} fused_mbconv_fwd launches"
            f"{f' = {MBCONV_LAUNCHES_PER_FORWARD} x {len(forwards)} forwards' if fused else ''}"
            f"; first pass {wall * 1e3:.0f} ms ({ATTN_EVAL_IMAGES / wall:.1f} images/s, "
            f"loader and warm-up included); forward of {ATTN_BATCH} alone "
            f"{forward_ms:.1f} ms on the host's clock, {device_ms:.2f} ms of device time "
            f"(CUDA graph replay); micro mIoU {summary['micro_miou']:.4f}, macro mIoU "
            f"{summary['macro_miou']:.4f}, confusion matrix {cmt.tolist()}")
        runs[fused] = (cmt, summary, launches)
    moved = int(np.abs(runs[True][0] - runs[False][0]).sum()) // 2
    limit = int(MAX_TIE_SHARE * ATTN_EVAL_IMAGES * ATTN_SIZE ** 2)
    log(f"[{tag}] fused vs unfused confusion matrices: {moved} pixels moved "
        f"(at most {limit}: ties at float32 precision)")
    if moved > limit:
        raise AssertionError(f"fused and unfused eval disagree on {moved} pixels")
    return runs[True][2]


def phase_eval_attn(tmp: str, card: str) -> int:
    """The attn eval path on seeded weights."""
    pth = os.path.join(tmp, "Attn-seeded.pth")
    cfg = load_cfg(test_cli.build_parser().parse_args(_attn_opts(tmp, pth)))
    _check_attn_geometry(cfg)
    _seeded_checkpoint("eval_attn", cfg, pth)
    return _eval_attn_checkpoint("eval_attn", tmp, pth, card)


def phase_serve_attn(tmp: str, card: str) -> int:
    pth = os.path.join(tmp, "Attn-seeded-serve.pth")
    args = build_parser().parse_args(
        ["--max-batch", str(MAX_BATCH)]
        + _attn_opts(tmp, pth, "MODEL.FUSED_MBCONV", "True"))
    cfg = load_cfg(args)
    _check_attn_geometry(cfg)
    _seeded_checkpoint("serve_attn", cfg, pth)
    inf, bodies, masks, batches, launches, wall = serve_traffic(
        "serve_attn", cfg, args, load_json(args.config_path), ATTN_SIZE, ATTN_SIZE, card,
        (mbconv, "KERNEL_LAUNCHES"))
    if launches != MBCONV_LAUNCHES_PER_FORWARD * batches or launches == 0:
        raise AssertionError(f"fused_mbconv_fwd launched {launches} times for {batches} "
                             f"batches; want {MBCONV_LAUNCHES_PER_FORWARD} per batch")
    log(f"[serve_attn] fused_mbconv_fwd launches: {launches} = "
        f"{MBCONV_LAUNCHES_PER_FORWARD} x {batches} batches")
    x = serve_breakdown("serve_attn", inf, bodies, masks, ATTN_SIZE, ATTN_SIZE, batches,
                        wall, card)

    # one batch against the same forward through the unfused blocks
    _set_fused(inf.tester, False)
    before = mbconv.KERNEL_LAUNCHES
    probs = inf.tester._probs_impl(x, (ATTN_SIZE, ATTN_SIZE))
    unfused_ms = host_ms(
        lambda: inf.tester._probs_impl(x, (ATTN_SIZE, ATTN_SIZE)).sum().item())
    if mbconv.KERNEL_LAUNCHES != before:
        raise AssertionError("the unfused forward launched the kernel")
    log(f"[serve_attn] unfused forward of {MAX_BATCH} alone {unfused_ms:.1f} ms on {card}")
    _check_agreement("serve_attn", "unfused forward", probs, masks)
    return launches


ATTENTION_PARAMS = ("query_conv.weight", "key_conv.weight", "value_conv.weight", "gamma")


def _one_step_grads(segmentor, loss_fn, x, label, train: bool = True):
    segmentor.zero_grad(set_to_none=True)
    outputs, _ = segmentor(x, train=train)
    loss = loss_fn(outputs, label)
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {n: p.grad.clone() for n, p in segmentor.named_parameters()}


def _worst_leaf(grads, refs):
    """The largest ||grad - ref|| / ||ref|| over the leaves, with its name.  A
    leaf whose gradient is rounding noise (a conv bias under a batch-statistics
    BN) is held to a floor: 1e-4 of the largest leaf's RMS value."""
    rms = {n: r.float().square().mean().sqrt().item() for n, r in refs.items()}
    floor = 1e-4 * max(rms.values())
    worst, worst_name = 0.0, ""
    for name, ref in refs.items():
        err = (grads[name] - ref).float().square().mean().sqrt().item()
        rel = err / max(rms[name], floor)
        if rel > worst:
            worst, worst_name = rel, name
    return worst, worst_name


class _ReluPins:
    """Pins the GALD decoder's ReLU masks from one step to the next.

    The criss-cross cores feed the local-attention and FAM branches, whose
    ReLUs follow train-mode BatchNorms.  Two steps whose attention outputs
    differ by rounding can then put an element near 0 on either side of a
    ReLU, and one such flip in ``local_attention_*.dconv2`` (216 elements a
    channel at 1280x720, batch 6) moves its BatchNorm bias's gradient by
    about 1e-2 of its norm: a different linear piece, not a kernel's error.
    Inside ``pinned()`` the first step records every decoder ReLU's mask
    (``x > 0``) and returns ``F.relu(x)`` unchanged; after ``replay()`` the
    next step applies the recorded masks (``x * mask``), so that both take
    the gradient of the same piece, and ``flips`` counts the elements whose
    sign differed."""

    def __init__(self):
        self.masks, self.at, self.flips, self.replaying = [], 0, 0, False

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not self.replaying:
            self.masks.append(x.detach() > 0)
            return torch.nn.functional.relu(x)
        mask = self.masks[self.at]
        self.at += 1
        self.flips += int(((x.detach() > 0) != mask).sum())
        return x * mask.to(x.dtype)

    def replay(self) -> None:
        self.at, self.flips, self.replaying = 0, 0, True

    def pinned(self):
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(gcpa, "relu", self))
        stack.enter_context(mock.patch.object(torch.nn.ReLU, "forward",
                                              lambda module, x: self(x)))
        return stack


def _kernels_vs_plain_grads(segmentor, loss_fn, x, label) -> dict:
    """One train-mode step's gradients with kernels #1 and #2 against the same
    step with the plain core: per leaf (``_worst_leaf``) as the steps run,
    and again with the plain step on the kernel step's ReLU masks
    (``_ReluPins``), which is what ``GRAD_TOLERANCE`` holds; and the spread of
    the same kernel step run twice."""
    pins = _ReluPins()
    with pins.pinned():
        loss_k, grads_k = _one_step_grads(segmentor, loss_fn, x, label)
    with mock.patch.object(gcpa, "cc_attention_core", ccattn.cc_attention_core_plain):
        before_plain = ccattn.KERNEL_LAUNCHES
        loss_p, grads_p = _one_step_grads(segmentor, loss_fn, x, label)
        pins.replay()
        with pins.pinned():
            loss_pinned, grads_pinned = _one_step_grads(segmentor, loss_fn, x, label)
        if ccattn.KERNEL_LAUNCHES != before_plain:
            raise AssertionError("the plain-core step launched the kernel")
    if pins.at != len(pins.masks):
        raise AssertionError(f"the plain step met {pins.at} decoder ReLUs, the kernel step "
                             f"{len(pins.masks)}")
    _, grads_k2 = _one_step_grads(segmentor, loss_fn, x, label)
    return {"loss_k": loss_k, "loss_p": loss_p, "loss_pinned": loss_pinned,
            "free": _worst_leaf(grads_k, grads_p), "pinned": _worst_leaf(grads_k, grads_pinned),
            "noise": _worst_leaf(grads_k2, grads_k), "flips": pins.flips,
            "relus": len(pins.masks), "masked": sum(m.numel() for m in pins.masks),
            "leaves": len(grads_p)}


def _report_steps(tag: str, trainer, card: str, peak_mib: float, batch: int = 0) -> float:
    """Logs ms a step (the median after the first, which warms cuDNN up),
    images/s (``batch`` images a step, SOLVER.BATCH_SIZE by default), the
    data share and the peak memory; returns the ms a step."""
    times = trainer.meters.meters["time"].series[1:]
    waits = trainer.meters.meters["data"].series[1:]
    step_ms = float(np.median(times)) * 1e3
    batch = batch or trainer.cfg.SOLVER.BATCH_SIZE
    log(f"[{tag}] on {card}: {step_ms:.1f} ms/step of {batch} (median of steps "
        f"2..{len(times) + 1}; first step "
        f"{trainer.meters.meters['time'].series[0] * 1e3:.0f} ms), "
        f"{batch / step_ms * 1e3:.2f} images/s, data share of a step "
        f"{sum(waits) / sum(times):.1%}, peak memory {peak_mib:.0f} MiB, "
        f"{trainer.cfg.MODEL.DTYPE}, TF32 off")
    return step_ms


def _check_checkpoint_loads(tag: str, trainer, opts, logger, x: torch.Tensor) -> None:
    """The checkpoint the trainer wrote loads back into ``Tester`` through
    ``resume latest``: the same weights and buffers, finite probabilities
    at 1024x512 from the first image of ``x``."""
    ckpt = os.path.join(trainer.cfg.OUTPUT_DIR, f"{trainer.spec.ckpt_prefix}-1.pth")
    if not os.path.exists(ckpt):
        raise AssertionError(f"{ckpt} was not written")
    tester = Tester(load_cfg(train_src.build_parser().parse_args(opts + ["resume", "latest"])),
                    logger)
    tester._load_checkpoint()
    trained = trainer.segmentor.state_dict()
    for name, value in tester.segmentor.state_dict().items():
        if not torch.equal(value, trained[name]):
            raise AssertionError(f"{name} differs between the trainer and {ckpt}")
    probs = tester._probs_impl(x[:1, :, :SERVE_H, :SERVE_W].contiguous(), (SERVE_H, SERVE_W))
    if (probs.shape != (1, 19, SERVE_H, SERVE_W) or not torch.isfinite(probs).all()
            or (probs.sum(1) - 1).abs().max() > 1e-4):
        raise AssertionError(f"Tester on {ckpt}: probabilities {tuple(probs.shape)}")
    log(f"[{tag}] {ckpt} ({os.path.getsize(ckpt) / 2 ** 20:.0f} MiB) loads into Tester; "
        f"its weights and buffers equal the trainer's")


def phase_train(tmp: str, card: str):
    from rnd_semantic_segmentation_torch.train.steps import make_family_loss

    out_dir = os.path.join(tmp, "train")
    opts = ["-cfg", os.path.join(HERE, "configs", "gald_src.yaml"),
            "DATASETS.SOURCE_TRAIN", "synthetic_train",
            "DATASETS.SYNTHETIC_LENGTH", str(TRAIN_BATCH * TRAIN_STEPS),
            "SOLVER.EPOCHS", "1", "SOLVER.CHECKPOINT_PERIOD", "1", *FLOAT32, "OUTPUT_DIR", out_dir]
    cfg = load_cfg(train_src.build_parser().parse_args(opts))
    geometry = (cfg.MODEL.NAME, cfg.MODEL.NUM_CLASSES, cfg.SOLVER.BATCH_SIZE,
                tuple(cfg.INPUT.SOURCE_INPUT_SIZE_TRAIN))
    if geometry != ("gald_hardnet68", 19, TRAIN_BATCH, (TRAIN_W, TRAIN_H)):
        raise AssertionError(f"configs/gald_src.yaml gives {geometry}")
    logger = _stderr_logger("chip_smoke.train", logging.INFO)

    trainer = train_src.make_trainer("gald", cfg, logger=logger)
    segmentor = trainer.segmentor
    randomize_weights_(segmentor, seed=0)  # gamma 0.7: the attention carries signal
    relation = segmentor.parts["decoder"].long_relation
    attention = {n: p for n, p in relation.named_parameters() if n in ATTENTION_PARAMS}
    if set(attention) != set(ATTENTION_PARAMS):
        raise AssertionError(f"attention parameters {sorted(attention)}")
    before = {n: p.detach().clone() for n, p in attention.items()}
    seen = []
    hook = relation.register_forward_hook(
        lambda mod, inp, out: seen.append(tuple(inp[0].shape)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ccattn.KERNEL_LAUNCHES = ccattn.BWD_KERNEL_LAUNCHES = 0
    trainer.train()
    torch.cuda.synchronize()
    fwd_launches, bwd_launches = ccattn.KERNEL_LAUNCHES, ccattn.BWD_KERNEL_LAUNCHES
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    hook.remove()

    steps = trainer.state.step
    if steps != TRAIN_STEPS or len(trainer.loss_data) != TRAIN_STEPS:
        raise AssertionError(f"{steps} steps taken, want {TRAIN_STEPS}")
    if not all(np.isfinite(trainer.loss_data)):
        raise AssertionError(f"losses {trainer.loss_data}")
    log(f"[train] {steps} steps of batch {TRAIN_BATCH} at {TRAIN_W}x{TRAIN_H}: losses "
        f"{[round(v, 4) for v in trainer.loss_data]}, lr {trainer.lr_data[0]:.3g} -> "
        f"{trainer.lr_data[-1]:.3g}")
    b, c, h, w = seen[0]
    if (b, h, w, max(c // 8, 1), c) != TRAIN_CC_SHAPE or len(seen) != 2 * steps:
        raise AssertionError(f"criss-cross inputs {seen[:2]} x{len(seen)}, want "
                             f"{TRAIN_CC_SHAPE} twice a step")
    if fwd_launches != 2 * steps or bwd_launches != 2 * steps:
        raise AssertionError(f"launches over {steps} steps: forward {fwd_launches}, "
                             f"backward {bwd_launches}; want {2 * steps} each")
    log(f"[train] launches over {steps} steps: cc_attention_fwd {fwd_launches}, "
        f"cc_attention_bwd {bwd_launches} = 2 x steps each, at {TRAIN_CC_SHAPE}")
    for name, p in attention.items():
        grad = 0.0 if p.grad is None else p.grad.abs().max().item()
        moved = (p.detach() - before[name]).abs().max().item()
        log(f"[train]   long_relation.{name}: max |grad| {grad:.3e}, moved {moved:.3e}")
        if not (grad > 0 and moved > 0 and np.isfinite(grad)):
            raise AssertionError(f"long_relation.{name} got no gradient or did not move")

    _report_steps("train", trainer, card, peak_mib)
    loader = trainer.train_loader
    loader.set_epoch(1)
    sample = next(iter(loader))
    x = torch.from_numpy(sample["image"]).to(trainer.device).permute(0, 3, 1, 2).contiguous()
    label = torch.from_numpy(sample["label"]).to(trainer.device)
    _check_checkpoint_loads("train", trainer, opts, logger, x)

    # one step's gradients: the kernels against the same step with the plain core
    loss_fn = make_family_loss(trainer.spec, cfg.MODEL.NUM_CLASSES, cfg.INPUT.IGNORE_LABEL)
    grads = _kernels_vs_plain_grads(segmentor, loss_fn, x, label)
    (free, free_name), (worst, worst_name) = grads["free"], grads["pinned"]
    noise, noise_name = grads["noise"]
    loss_k, loss_p = grads["loss_k"], grads["loss_pinned"]
    log(f"[train] one step, kernels vs plain core: loss {loss_k:.6f} vs {loss_p:.6f}; "
        f"on the kernel step's masks of the {grads['relus']} decoder ReLUs the worst "
        f"gradient leaf {worst_name} is off by {worst:.3e} of its norm (tolerance "
        f"{GRAD_TOLERANCE:g}, {grads['leaves']} leaves); with its own masks the plain step "
        f"flips {grads['flips']} of {grads['masked']} ReLU elements and its worst leaf "
        f"{free_name} is off by {free:.3e}; the same step twice with the kernels differs "
        f"by {noise:.3e} at {noise_name}")
    if (worst > GRAD_TOLERANCE or abs(loss_k - loss_p) > 1e-4 * abs(loss_p)
            or abs(loss_k - grads["loss_p"]) > 1e-4 * abs(loss_p)):
        raise AssertionError(f"gradients disagree with the plain-core step: {worst_name} "
                             f"{worst}")
    return fwd_launches, bwd_launches


KERNEL_COUNTERS = ((ccattn, "KERNEL_LAUNCHES"), (ccattn, "BWD_KERNEL_LAUNCHES"),
                   (mbconv, "KERNEL_LAUNCHES"))


def _zero_kernel_counts() -> None:
    for module, name in KERNEL_COUNTERS:
        setattr(module, name, 0)


def _check_no_kernel(tag: str) -> int:
    """No hand kernel lies on the DeepLab path, and none on the attn training
    path: the three counts, set to 0 before the phase's run, must still be 0."""
    counts = {f"{m.__name__.rsplit('.', 1)[1]}.{n}": getattr(m, n) for m, n in KERNEL_COUNTERS}
    log(f"[{tag}] hand-kernel launches in this run: {counts}")
    if any(counts.values()):
        raise AssertionError(f"a hand kernel ran on the {tag} path: {counts}")
    return 0


def _deeplab_opts(out_dir: str, *more):
    return ["-cfg", os.path.join(HERE, "configs", "deeplabv2_r101_src.yaml"),
            "DATASETS.SOURCE_TRAIN", "synthetic_train", "DATASETS.TEST", "synthetic_val",
            *FLOAT32, "OUTPUT_DIR", out_dir, *more]


def _check_deeplab_geometry(cfg) -> None:
    geometry = (cfg.MODEL.NAME, cfg.MODEL.NUM_CLASSES, bool(cfg.MODEL.FREEZE_BN),
                cfg.SOLVER.BATCH_SIZE, tuple(cfg.INPUT.SOURCE_INPUT_SIZE_TRAIN),
                tuple(cfg.INPUT.INPUT_SIZE_TEST), cfg.TEST.BATCH_SIZE)
    if geometry != DEEPLAB_GEOMETRY:
        raise AssertionError(f"configs/deeplabv2_r101_src.yaml gives {geometry}, "
                             f"want {DEEPLAB_GEOMETRY}")


def _deeplab_checkpoint(tmp: str) -> str:
    """The checkpoint train_deeplab wrote, or (when that phase did not run)
    seeded full-width weights at the same path."""
    pth = os.path.join(tmp, "train_deeplab", "Aspp-1.pth")
    if not os.path.exists(pth):
        os.makedirs(os.path.dirname(pth), exist_ok=True)
        cfg = load_cfg(train_src.build_parser().parse_args(_deeplab_opts(tmp)))
        _seeded_checkpoint("deeplab", cfg, pth)
    return pth


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                        _dilation, transposed, _output_padding, _groups, output_mask,
                        out_shape, **kwargs) -> int:
    """Each gradient of a convolution (input, weight) costs what its forward
    costs.  torch.utils.flop_counter's own rule counts the weight gradient of
    a grouped convolution as if it were not grouped: a depthwise one's
    C times over, which made an EfficientNet backward read 26 times its
    forward.  Without groups the two rules give the same count."""
    from torch.utils.flop_counter import conv_flop_count

    return sum(bool(m) for m in output_mask[:2]) * conv_flop_count(
        x_shape, w_shape, grad_out_shape, transposed)


def _counted_flops(fn) -> int:
    """The floating-point operations of ``fn()`` as torch.utils.flop_counter
    counts them from the shapes of its convolutions and products (2 per
    multiply-add; a convolution's backward by ``_conv_backward_flop``): the
    work the function must do, whatever the device."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flop})
    with counter:
        fn()
    return counter.get_total_flops()


def _step_split(trainer, x, label, reps: int = 3) -> dict:
    """Host-clock ms of a train step's forward (with the loss), backward and
    optimizer updates, each ended by a device sync: medians of ``reps`` steps
    at the trainer's last LR; and the counted operations of the forward and
    of the backward.  The forward draws drop-connect (the attn families)
    from a generator of its own."""
    from rnd_semantic_segmentation_torch.train.state import apply_updates
    from rnd_semantic_segmentation_torch.train.steps import make_family_loss

    cfg, spec, segmentor = trainer.cfg, trainer.spec, trainer.segmentor
    loss_fn = make_family_loss(spec, cfg.MODEL.NUM_CLASSES, cfg.INPUT.IGNORE_LABEL)
    size = tuple(label.shape[1:3])
    gen = torch.Generator(device=x.device).manual_seed(0)
    held = []
    flops = {"forward": _counted_flops(lambda: held.append(
        loss_fn(segmentor(x, label_size=size, train=True, generator=gen)[0], label)))}
    flops["backward"] = _counted_flops(lambda: held.pop().backward())
    lr = trainer.lr_data[-1]
    parts = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(reps):
        for opt in trainer.state.optimizers.values():
            opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outputs, _ = segmentor(x, label_size=size, train=True, generator=gen)
        loss = loss_fn(outputs, label)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for name, opt in trainer.state.optimizers.items():
            apply_updates(opt, lr * spec.lr_mults[name])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, t in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(t * 1e3)
    return {key: float(np.median(v)) for key, v in parts.items()}, flops


def phase_train_deeplab(tmp: str, card: str) -> int:
    from rnd_semantic_segmentation_torch.models.layers import FrozenBatchNorm2d

    out_dir = os.path.join(tmp, "train_deeplab")
    opts = _deeplab_opts(out_dir, "DATASETS.SYNTHETIC_LENGTH", str(TRAIN_BATCH * TRAIN_STEPS),
                         "SOLVER.EPOCHS", "1", "SOLVER.CHECKPOINT_PERIOD", "1")
    cfg = load_cfg(train_src.build_parser().parse_args(opts))
    _check_deeplab_geometry(cfg)
    logger = _stderr_logger("chip_smoke.train_deeplab", logging.INFO)
    trainer = train_src.make_trainer("deeplab", cfg, logger=logger)
    segmentor = trainer.segmentor
    randomize_weights_(segmentor, seed=0)
    parts = trainer.spec.modules
    before = {name: {n: p.detach().clone() for n, p in m.named_parameters()}
              for name, m in parts.items()}
    norms = [m for m in segmentor.modules() if isinstance(m, FrozenBatchNorm2d)]
    buffers = dict(segmentor.named_buffers())
    if len(norms) != 104 or len(buffers) != 4 * len(norms):
        raise AssertionError(f"{len(norms)} FrozenBN modules, {len(buffers)} buffers; "
                             f"want 104 and 416 (ResNet101, FREEZE_BN)")
    frozen = {n: b.clone() for n, b in buffers.items()}
    log(f"[train_deeplab] {cfg.MODEL.NAME}: "
        f"{sum(p.numel() for p in segmentor.parameters())} parameters, "
        f"{len(norms)} FrozenBN modules, seeded weights")
    with torch.inference_mode():  # the seeded logits' scale on the card
        probe = torch.randn(1, 3, TRAIN_H, TRAIN_W, device=trainer.device,
                            generator=torch.Generator(trainer.device).manual_seed(0))
        (logits,), features = segmentor(probe)
    log(f"[train_deeplab] seeded forward at {TRAIN_W}x{TRAIN_H}: features "
        f"{tuple(features.shape)}, logits {tuple(logits.shape)}, max |logit| "
        f"{logits.abs().max().item():.3f}, logit std {logits.std().item():.3f}")
    del probe, logits, features

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_kernel_counts()
    trainer.train()
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = _check_no_kernel("train_deeplab")

    steps = trainer.state.step
    if steps != TRAIN_STEPS or len(trainer.loss_data) != TRAIN_STEPS:
        raise AssertionError(f"{steps} steps taken, want {TRAIN_STEPS}")
    if not all(np.isfinite(trainer.loss_data)):
        raise AssertionError(f"losses {trainer.loss_data}")
    lrs = {n: o.param_groups[0]["lr"] for n, o in trainer.state.optimizers.items()}
    log(f"[train_deeplab] {steps} steps of batch {TRAIN_BATCH} at {TRAIN_W}x{TRAIN_H}: "
        f"losses {[round(v, 4) for v in trainer.loss_data]}, lr {trainer.lr_data[0]:.3g} "
        f"-> {trainer.lr_data[-1]:.3g}; last LR by part {lrs}")
    if abs(lrs["classifier"] - 10 * lrs["feature_extractor"]) > 1e-9 * lrs["classifier"]:
        raise AssertionError(f"the classifier's LR is not 10x the backbone's: {lrs}")
    for name, module in parts.items():
        moved = [(p.detach() - before[name][n]).abs().max().item()
                 for n, p in module.named_parameters()]
        log(f"[train_deeplab]   {name}: {sum(m > 0 for m in moved)} of {len(moved)} "
            f"parameters moved, by at most {max(moved):.3e}")
        if not all(m > 0 and np.isfinite(m) for m in moved):
            raise AssertionError(f"a parameter of {name} did not move")
    changed = [n for n, b in segmentor.named_buffers() if not torch.equal(b, frozen[n])]
    log(f"[train_deeplab]   FrozenBN buffers bit-equal after {steps} steps: "
        f"{len(frozen) - len(changed)} of {len(frozen)}")
    if changed:
        raise AssertionError(f"FrozenBN buffers changed: {changed[:5]}")

    step_ms = _report_steps("train_deeplab", trainer, card, peak_mib)

    loader = trainer.train_loader
    loader.set_epoch(1)
    sample = next(iter(loader))
    x = torch.from_numpy(sample["image"]).to(trainer.device).permute(0, 3, 1, 2).contiguous()
    label = torch.from_numpy(sample["label"]).to(trainer.device)
    _check_checkpoint_loads("train_deeplab", trainer, opts, logger, x)

    split, flops = _step_split(trainer, x, label)
    peak = PEAK_FLOP_PER_S[torch.float32]
    bound_ms = (flops["forward"] + flops["backward"]) / peak * 1e3
    log(f"[train_deeplab] a step on {card} (host clock, a device sync after each part, "
        f"median of 3): forward and loss {split['forward']:.1f} ms "
        f"({flops['forward'] / 1e12:.3f} TFLOP counted, "
        f"{flops['forward'] / split['forward'] / 1e9:.1f} TFLOP/s), backward "
        f"{split['backward']:.1f} ms ({flops['backward'] / 1e12:.3f} TFLOP, "
        f"{flops['backward'] / split['backward'] / 1e9:.1f} TFLOP/s), optimizer "
        f"{split['optimizer']:.1f} ms; bound of a step {bound_ms:.1f} ms (operations at "
        f"{peak / 1e12:.0f} TFLOP/s float32), {bound_ms / step_ms:.0%} of the measured step")
    return launches


def phase_eval_deeplab(tmp: str, card: str) -> int:
    """``cli.test``'s own function on the DeepLab checkpoint, then one image
    with each test-time augmentation, then the card against the CPU."""
    pth = _deeplab_checkpoint(tmp)
    out_dir = os.path.join(tmp, "eval_deeplab")
    render = os.path.join(HERE, "renders", "cityscapes.json")
    base = ["-c", render] + _deeplab_opts(
        out_dir, "DATASETS.SYNTHETIC_LENGTH", str(DEEPLAB_EVAL_IMAGES), "resume", pth)
    args = test_cli.build_parser().parse_args(base)
    cfg = load_cfg(args)
    _check_deeplab_geometry(cfg)
    logger = _stderr_logger("chip_smoke.eval_deeplab", logging.INFO)
    tester = test_cli.make_tester(cfg, load_json(args.config_path), logger=logger)
    forwards = []
    hook = tester.segmentor.register_forward_hook(
        lambda mod, inp, out: forwards.append(tuple(inp[0].shape)))
    torch.cuda.synchronize()
    _zero_kernel_counts()
    t0 = time.perf_counter()
    summary = tester.test()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _check_no_kernel("eval_deeplab")
    want = [(1, 3, SERVE_H, SERVE_W)] * DEEPLAB_EVAL_IMAGES
    if forwards != want:
        raise AssertionError(f"eval forwards {forwards[:3]} x{len(forwards)}, want {want[0]} "
                             f"x{len(want)}")
    scalars = [v for v in summary.values() if isinstance(v, float)]
    if not scalars or not all(np.isfinite(scalars)) or not 0 < summary["micro_miou"] <= 1:
        raise AssertionError(f"summary {summary}")
    cmt = tester.confusion
    written = load_json(os.path.join(out_dir, "deeplab_confusion_matrix.json"))
    if cmt.sum() != DEEPLAB_EVAL_IMAGES * SERVE_H * SERVE_W or written["cmt"] != cmt.tolist():
        raise AssertionError("the confusion matrix does not count every pixel once")
    x = torch.randn(1, 3, SERVE_H, SERVE_W, device=tester.device,
                    generator=torch.Generator(tester.device).manual_seed(0))
    forward_ms = host_ms(lambda: tester._probs_impl(x, (SERVE_H, SERVE_W)).sum().item())
    device_ms = graph_ms(lambda: tester._probs_impl(x, (SERVE_H, SERVE_W)), reps=2, replays=5)
    flops = _counted_flops(lambda: tester._probs_impl(x, (SERVE_H, SERVE_W)))
    bound_ms = flops / PEAK_FLOP_PER_S[torch.float32] * 1e3
    log(f"[eval_deeplab] forward of one {SERVE_W}x{SERVE_H} image: {flops / 1e12:.3f} TFLOP "
        f"counted, bound {bound_ms:.2f} ms at 67 TFLOP/s float32, "
        f"{flops / device_ms / 1e9:.1f} TFLOP/s achieved ({bound_ms / device_ms:.0%} of peak)")
    log(f"[eval_deeplab] on {card}: {DEEPLAB_EVAL_IMAGES} images one at a time at "
        f"{SERVE_W}x{SERVE_H}; first pass {wall * 1e3:.0f} ms "
        f"({DEEPLAB_EVAL_IMAGES / wall:.1f} images/s, loader and warm-up included); "
        f"forward of 1 alone {forward_ms:.1f} ms on the host's clock, {device_ms:.2f} ms "
        f"of device time (CUDA graph replay); micro mIoU {summary['micro_miou']:.4f}, "
        f"macro mIoU {summary['macro_miou']:.4f}")

    # one image with each test-time augmentation: the head reads TEST.* per call
    for opts, passes in ((("TEST.FLIP_TTA", "True"), [(2, 3, SERVE_H, SERVE_W)]),
                         (("TEST.MULTI_SCALE", "True"),
                          [(1, 3, int(SERVE_H * s), int(SERVE_W * s)) for s in cfg.TEST.SCALES])):
        tester.cfg = load_cfg(test_cli.build_parser().parse_args(base + list(opts)))
        forwards.clear()
        probs = tester._probs_impl(x, (SERVE_H, SERVE_W))
        tta_ms = host_ms(lambda: tester._probs_impl(x, (SERVE_H, SERVE_W)).sum().item())
        err = (probs.sum(1) - 1).abs().max().item()
        log(f"[eval_deeplab] {opts[0]} on one image: forwards {forwards[:len(passes)]}, "
            f"{tta_ms:.1f} ms on the host's clock; probabilities sum to 1 within {err:.1e}")
        if (forwards[:len(passes)] != passes or probs.shape != (1, 19, SERVE_H, SERVE_W)
                or not torch.isfinite(probs).all() or err > 1e-4):
            raise AssertionError(f"{opts[0]}: forwards {forwards}, probabilities "
                                 f"{tuple(probs.shape)}, sum error {err}")
    hook.remove()

    # the card against the CPU: cuDNN with TF32 off computes what the CPU tests hold
    small = load_cfg(test_cli.build_parser().parse_args(
        base + ["MODEL.NAME", "deeplab_resnet18", "MODEL.DEVICE", "cpu"]))
    segmentor = Segmentor(build_segmentor(small), small.MODEL.NUM_CLASSES)
    randomize_weights_(segmentor, seed=0)
    xs = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        (ref,), _ = segmentor(xs)
        (out,), _ = segmentor.to(tester.device)(xs.to(tester.device))
    err, scale = (out.cpu() - ref).abs().max().item(), ref.abs().max().item()
    log(f"[eval_deeplab] deeplab_resnet18 at 64x64, card against CPU: max abs logit "
        f"difference {err:.3e} of max |logit| {scale:.3f} (tolerance "
        f"{DEEPLAB_CPU_TOLERANCE:g} x max)")
    if not err <= DEEPLAB_CPU_TOLERANCE * scale:
        raise AssertionError(f"card and CPU logits differ by {err} (max {scale})")
    return launches


def phase_serve_deeplab(tmp: str, card: str) -> int:
    pth = _deeplab_checkpoint(tmp)
    args = build_parser().parse_args(
        ["--max-batch", str(MAX_BATCH), "-c", os.path.join(HERE, "renders", "cityscapes.json")]
        + _deeplab_opts(tmp, "resume", pth))
    cfg = load_cfg(args)
    _check_deeplab_geometry(cfg)
    _zero_kernel_counts()
    inf, bodies, masks, batches, _, wall = serve_traffic(
        "serve_deeplab", cfg, args, load_json(args.config_path), SERVE_W, SERVE_H, card,
        (ccattn, "KERNEL_LAUNCHES"))
    launches = _check_no_kernel("serve_deeplab")
    x = serve_breakdown("serve_deeplab", inf, bodies, masks, SERVE_W, SERVE_H, batches,
                        wall, card)
    # one batch of masks against the same forward outside the server
    _check_agreement("serve_deeplab", "the Tester's forward", inf.tester._probs_impl(
        x, (SERVE_H, SERVE_W)), masks)
    return launches


def phase_train_attn(tmp: str, card: str):
    """The attn training path through the source-training CLI's parser and
    ``Trainer``, then its checkpoint through ``cli.test``'s own function with
    the fused kernel on and off.  Returns the fused kernel's launches in
    training (must be 0) and in the fused eval of the checkpoint."""
    from rnd_semantic_segmentation_torch.ckpt.torch_import import load_reference_checkpoint
    from rnd_semantic_segmentation_torch.data import Augmenter

    out_dir = os.path.join(tmp, "train_attn")
    batch = ATTN_TRAIN_GEOMETRY[2]
    opts = ["-cfg", os.path.join(HERE, "configs", "attn_src_kvasir.yaml"),
            "DATASETS.SOURCE_TRAIN", "synthetic_train",
            "DATASETS.SYNTHETIC_LENGTH", str(batch * ATTN_TRAIN_STEPS),
            "SOLVER.EPOCHS", "1", "SOLVER.CHECKPOINT_PERIOD", "1",
            "MODEL.FUSED_MBCONV", "True", *FLOAT32, "OUTPUT_DIR", out_dir]
    cfg = load_cfg(train_src.build_parser().parse_args(opts))
    aug = cfg.AUG
    geometry = (cfg.MODEL.NAME, cfg.MODEL.NUM_CLASSES, cfg.SOLVER.BATCH_SIZE,
                tuple(cfg.INPUT.SOURCE_INPUT_SIZE_TRAIN), aug.NAME,
                (aug.PROB, aug.BLUR_PROB, aug.ROTATE_PROB, aug.JITTER_PROB, aug.FLIP_PROB),
                cfg.SOLVER.BASE_LR, cfg.SOLVER.WEIGHT_DECAY)
    if geometry != ATTN_TRAIN_GEOMETRY:
        raise AssertionError(f"configs/attn_src_kvasir.yaml gives {geometry}, "
                             f"want {ATTN_TRAIN_GEOMETRY}")
    logger = _stderr_logger("chip_smoke.train_attn", logging.INFO)
    trainer = train_src.make_trainer("attn", cfg, logger=logger)
    segmentor = trainer.segmentor
    randomize_weights_(segmentor, seed=0)
    parts = trainer.spec.modules
    before = {name: {n: p.detach().clone() for n, p in m.named_parameters()}
              for name, m in parts.items()}
    stats = {n: b.clone() for n, b in segmentor.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    rates = [b.drop_connect_rate for b in parts["encoder"].blocks]
    log(f"[train_attn] {cfg.MODEL.NAME}: "
        f"{sum(p.numel() for p in segmentor.parameters())} parameters, "
        f"{len(stats) // 2} BatchNorms on batch statistics, drop-connect at "
        f"0..{max(rates):.4f} over {len(rates)} blocks, seeded weights")

    # the host's share: the synthetic images and the attn augmentation alone
    dataset = trainer.train_loader.dataset
    t0 = time.perf_counter()
    raw = [dataset._gen(i)[:2] for i in range(batch)]
    make_ms = (time.perf_counter() - t0) / batch * 1e3
    transform = Augmenter(cfg, "train", rng=random.Random(0)).build_transform()
    t0 = time.perf_counter()
    for image, label in raw:
        transform(image, label)
    aug_ms = (time.perf_counter() - t0) / batch * 1e3

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_kernel_counts()
    trainer.train()
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    train_launches = _check_no_kernel("train_attn")

    steps = trainer.state.step
    if steps != ATTN_TRAIN_STEPS or len(trainer.loss_data) != ATTN_TRAIN_STEPS:
        raise AssertionError(f"{steps} steps taken, want {ATTN_TRAIN_STEPS}")
    if not all(np.isfinite(trainer.loss_data)):
        raise AssertionError(f"losses {trainer.loss_data}")
    lrs = {n: o.param_groups[0]["lr"] for n, o in trainer.state.optimizers.items()}
    log(f"[train_attn] {steps} steps of batch {batch} at {ATTN_SIZE}x{ATTN_SIZE}: losses "
        f"{[round(v, 4) for v in trainer.loss_data]}; LR by part {lrs}")
    if abs(lrs["decoder"] - 10 * lrs["encoder"]) > 1e-9 * lrs["decoder"]:
        raise AssertionError(f"the decoder's LR is not 10x the encoder's: {lrs}")
    for name, module in parts.items():
        moved = [(p.detach() - before[name][n]).abs().max().item()
                 for n, p in module.named_parameters()]
        log(f"[train_attn]   {name}: {sum(m > 0 for m in moved)} of {len(moved)} "
            f"parameters moved, by at most {max(moved):.3e}")
        if not all(m > 0 and np.isfinite(m) for m in moved):
            raise AssertionError(f"a parameter of {name} did not move")
    buffers = dict(segmentor.named_buffers())
    still = [n for n, b in stats.items() if torch.equal(buffers[n], b)]
    log(f"[train_attn]   BN running statistics moved: {len(stats) - len(still)} of "
        f"{len(stats)}")
    if still:
        raise AssertionError(f"BN running statistics did not move: {still[:5]}")
    _report_steps("train_attn", trainer, card, peak_mib)
    log(f"[train_attn] host, one core: synthetic image and label {make_ms:.1f} ms, attn "
        f"augmentation (config probabilities) {aug_ms:.1f} ms an image at "
        f"{ATTN_SIZE}x{ATTN_SIZE}; the loader runs {cfg.DATA_PIPE.NUM_WORKERS} threads")

    # the checkpoint holds what was trained; it goes through the eval path
    pth = os.path.join(out_dir, "Attn-1.pth")
    saved = load_reference_checkpoint(pth)
    for name, module in parts.items():
        for key, value in module.state_dict().items():
            if not torch.equal(saved[name][key], value.cpu()):
                raise AssertionError(f"{name}.{key} differs between the trainer and {pth}")
    log(f"[train_attn] {pth} ({os.path.getsize(pth) / 2 ** 20:.0f} MiB) holds the "
        f"trained weights and statistics")
    eval_launches = _eval_attn_checkpoint("eval_attn_trained", tmp, pth, card)

    loader = trainer.train_loader
    loader.set_epoch(1)
    sample = next(iter(loader))
    x = torch.from_numpy(sample["image"]).to(trainer.device).permute(0, 3, 1, 2).contiguous()
    label = torch.from_numpy(sample["label"]).to(trainer.device)
    split, flops = _step_split(trainer, x, label)
    peak = PEAK_FLOP_PER_S[torch.float32]
    bound_ms = (flops["forward"] + flops["backward"]) / peak * 1e3
    log(f"[train_attn] a step on {card} (host clock, a device sync after each part, "
        f"median of 3): forward and loss {split['forward']:.1f} ms "
        f"({flops['forward'] / 1e12:.3f} TFLOP counted, "
        f"{flops['forward'] / split['forward'] / 1e9:.1f} TFLOP/s), backward "
        f"{split['backward']:.1f} ms ({flops['backward'] / 1e12:.3f} TFLOP, "
        f"{flops['backward'] / split['backward'] / 1e9:.1f} TFLOP/s), optimizer "
        f"{split['optimizer']:.1f} ms; operations bound {bound_ms:.1f} ms at "
        f"{peak / 1e12:.0f} TFLOP/s float32")

    # drop-connect is on in train mode: two generator states, two outputs
    with torch.no_grad():
        outs = [segmentor(x, train=True, generator=torch.Generator(
            device=trainer.device).manual_seed(seed))[0][0] for seed in (1, 1, 2)]
    same = (outs[0] - outs[1]).abs().max().item()
    differ = (outs[0] - outs[2]).abs().max().item()
    scale = outs[0].abs().max().item()
    log(f"[train_attn] drop-connect, one batch in train mode: seeds 1 and 2 differ by "
        f"{differ:.3e}, seed 1 twice by {same:.3e} (max |logit| {scale:.3f})")
    if not differ > max(10 * same, 1e-3 * scale):
        raise AssertionError("drop-connect drew the same masks from two generator states")
    return train_launches, eval_launches


def _fada_opts(config: str, out_dir: str, *more):
    return ["-cfg", os.path.join(HERE, "configs", config),
            "DATASETS.SOURCE_TRAIN", "synthetic_train",
            "DATASETS.TARGET_TRAIN", "synthetic_shift_train",
            "SOLVER.EPOCHS", "1", *FLOAT32, "OUTPUT_DIR", out_dir, *more]


def _run_fada(tag: str, tmp: str, card: str, config: str, geometry: tuple, steps: int,
              *more, data_dir: str = ""):
    """One epoch of ``steps`` FADA steps through ``cli.train_adv``'s parser and
    ``FadaTrainer`` from seeded weights: the synthetic source and its shifted
    target, or with ``data_dir`` the config's own datasets read from the files
    there, SOLVER.BATCH_SIZE // 2 images of each a step.  Checks the
    config's geometry (MODEL.NAME, NUM_CLASSES, BATCH_SIZE, the source and
    target sizes, BASE_LR, BASE_LR_D), that the four losses are finite and
    that every parameter of every segmentor part and of D moved.  The kernel
    counts are set to 0 just before the run; the caller reads them after."""
    from rnd_semantic_segmentation_torch.train.fada import DISC_PART

    out_dir = os.path.join(tmp, tag)
    half = geometry[2] // 2
    opts = (["-cfg", os.path.join(HERE, "configs", config), "DATASETS.DATASET_DIR", data_dir,
             "SOLVER.EPOCHS", "1", *FLOAT32, "OUTPUT_DIR", out_dir, *more] if data_dir else
            _fada_opts(config, out_dir, "DATASETS.SYNTHETIC_LENGTH", str(half * steps), *more))
    cfg = load_cfg(train_adv.build_parser().parse_args(opts))
    got = (cfg.MODEL.NAME, cfg.MODEL.NUM_CLASSES, cfg.SOLVER.BATCH_SIZE,
           tuple(cfg.INPUT.SOURCE_INPUT_SIZE_TRAIN), tuple(cfg.INPUT.TARGET_INPUT_SIZE_TRAIN),
           cfg.SOLVER.BASE_LR, cfg.SOLVER.BASE_LR_D)
    if got != geometry:
        raise AssertionError(f"configs/{config} gives {got}, want {geometry}")
    logger = _stderr_logger(f"chip_smoke.{tag}", logging.INFO)
    trainer = train_adv.make_trainer(cfg.MODEL.NAME.split("_")[0] + "_fada", cfg,
                                     logger=logger)
    randomize_weights_(trainer.segmentor, seed=0)
    parts = {**trainer.spec.modules, DISC_PART: trainer.disc}
    before = {name: {n: p.detach().clone() for n, p in m.named_parameters()}
              for name, m in parts.items()}
    (sw, sh), (tw, th) = got[3], got[4]
    log(f"[{tag}] {cfg.MODEL.NAME}: {sum(p.numel() for p in trainer.segmentor.parameters())} "
        f"parameters, D {sum(p.numel() for p in trainer.disc.parameters())} on "
        f"{trainer.disc.D[0].in_channels} tap channels, seeded weights; {half} source "
        f"images at {sw}x{sh} and {half} target images at {tw}x{th} a step")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_kernel_counts()
    trainer.train()
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    if trainer.state.step != steps or len(trainer.loss_data) != steps:
        raise AssertionError(f"{trainer.state.step} steps taken, want {steps}")
    for key, values in trainer.series.items():
        if not all(np.isfinite(values)):
            raise AssertionError(f"{key} {values}")
    log(f"[{tag}] {steps} steps: " + "; ".join(
        f"{key} {[float(f'{v:.4g}') for v in values]}" for key, values in trainer.series.items()))
    for name, module in parts.items():
        moved = [(p.detach() - before[name][n]).abs().max().item()
                 for n, p in module.named_parameters()]
        log(f"[{tag}]   {name}: {sum(m > 0 for m in moved)} of {len(moved)} parameters "
            f"moved, by at most {max(moved):.3e}")
        if not all(m > 0 and np.isfinite(m) for m in moved):
            raise AssertionError(f"a parameter of {name} did not move")
    _report_steps(tag, trainer, card, peak_mib, batch=2 * half)
    return trainer


def _fada_split(trainer, reps: int = 3, profile: bool = True, tag: str = "train_fada_deeplab"):
    """Host-clock ms of the four parts of a deeplab FADA step, each ended by a
    device sync, medians of ``reps`` steps at the run's last LRs: the
    generator's two forwards, loss and backward; the segmentor's update; D's
    two forwards, loss and backward; D's update.  Also the counted operations
    of the generator's part and of D's."""
    from rnd_semantic_segmentation_torch import losses
    from rnd_semantic_segmentation_torch.train.fada import DISC_PART, TEMPERATURE
    from rnd_semantic_segmentation_torch.train.state import apply_updates
    from rnd_semantic_segmentation_torch.train.steps import make_family_loss

    cfg, spec, seg, disc = trainer.cfg, trainer.spec, trainer.segmentor, trainer.disc
    loss_fn = make_family_loss(spec, cfg.MODEL.NUM_CLASSES, cfg.INPUT.IGNORE_LABEL)
    opts = trainer.state.optimizers
    lr, lr_d = trainer.series["lr"][-1], trainer.series["lr_D"][-1]
    seg_params = [p for m in spec.modules.values() for p in m.parameters()]
    batches = []
    for loader in (trainer.src_loader, trainer.tgt_loader):
        loader.set_epoch(1)
        sample = next(iter(loader))
        batches.append((torch.from_numpy(sample["image"]).to(trainer.device)
                        .to(compute_dtype(cfg)).permute(0, 3, 1, 2).contiguous(),
                        torch.from_numpy(sample["label"]).to(trainer.device)))
    (src, label), (tgt, _) = batches
    soft = lambda out: torch.softmax(out.detach() / TEMPERATURE, 1).clamp(max=0.9)
    pad = lambda p, first: torch.cat([p, torch.zeros_like(p)][::1 if first else -1], 1)

    def generator():
        (so,), st = seg(src, train=True)
        (to,), tt = seg(tgt, train=True)
        ss, ts = soft(so), soft(to)
        loss = loss_fn((so / TEMPERATURE,), label) + cfg.SOLVER.ADV_WEIGHT * \
            losses.soft_label_cross_entropy(disc(tt, tgt.shape[-2:]), pad(ts, True))
        loss.backward(inputs=seg_params)
        return st.detach(), tt.detach(), ss, ts

    def discriminator(st, tt, ss, ts):
        loss = 0.5 * losses.soft_label_cross_entropy(disc(st, src.shape[-2:]), pad(ss, True)) \
            + 0.5 * losses.soft_label_cross_entropy(disc(tt, tgt.shape[-2:]), pad(ts, False))
        loss.backward()

    held = []
    flops = {"generator": _counted_flops(lambda: held.append(generator())),
             "discriminator": _counted_flops(lambda: discriminator(*held.pop()))}
    calls = {"generator": lambda: held.append(generator()),
             "segmentor update": lambda: [apply_updates(opts[n], lr * spec.lr_mults[n])
                                          for n in spec.modules],
             "discriminator": lambda: discriminator(*held.pop()),
             "discriminator update": lambda: apply_updates(opts[DISC_PART], lr_d)}
    parts = {key: [] for key in calls}
    peaks = {}
    for _ in range(reps):
        for opt in opts.values():
            opt.zero_grad(set_to_none=True)
        for key, call in calls.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            parts[key].append((time.perf_counter() - t0) * 1e3)
            peaks[key] = torch.cuda.max_memory_allocated() / 2 ** 20
    for key in ("generator", "discriminator") if profile else ():
        _kernel_table(f"{tag} {key}", calls, key)
    return {key: float(np.median(v)) for key, v in parts.items()}, flops, peaks


def _kernel_table(tag: str, calls, key: str, top: int = 6) -> None:
    """One call of ``calls[key]`` (after the parts before it, outside the
    profile) under ``torch.profiler``: the device time of its kernels by
    name, the largest first, and their sum against the host clock."""
    from torch.profiler import ProfilerActivity, profile

    names = list(calls)
    for name in names[:names.index(key)]:
        calls[name]()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        calls[key]()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    for name in names[names.index(key) + 1:]:
        calls[name]()
    rows = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                  key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    if not rows:
        log(f"[{tag}] torch.profiler saw no device time: kernel split not measured")
        return
    log(f"[{tag}] torch.profiler: kernels {busy:.1f} ms of device time in {wall:.1f} ms "
        f"on the host's clock; the largest: " + "; ".join(
            f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.1f} ms "
            f"({e.self_device_time_total / 1e3 / busy:.0%})" for e in rows[:top]))


def phase_train_fada_deeplab(tmp: str, card: str) -> int:
    """The FADA main path: configs/deeplabv2_r101_adv.yaml, then its
    checkpoint through ``cli.test``'s own function."""
    trainer = _run_fada("train_fada_deeplab", tmp, card, "deeplabv2_r101_adv.yaml",
                        DEEPLAB_FADA_GEOMETRY, FADA_STEPS["deeplab"],
                        "SOLVER.CHECKPOINT_PERIOD", "1")
    launches = _check_no_kernel("train_fada_deeplab")
    pth = os.path.join(trainer.cfg.OUTPUT_DIR, "AsppFada-1.pth")
    args = test_cli.build_parser().parse_args(
        ["-c", os.path.join(HERE, "renders", "cityscapes.json")] + _fada_opts(
            "deeplabv2_r101_adv.yaml", os.path.join(tmp, "eval_fada_deeplab"),
            "DATASETS.TEST", "synthetic_val",
            "DATASETS.SYNTHETIC_LENGTH", str(FADA_EVAL_IMAGES), "resume", pth))
    cfg = load_cfg(args)
    tester = test_cli.make_tester(cfg, load_json(args.config_path),
                                  logger=_stderr_logger("chip_smoke.eval_fada_deeplab"))
    for name, module in trainer.spec.modules.items():
        trained = module.state_dict()
        for key, value in tester.segmentor.parts[name].state_dict().items():
            if not torch.equal(value, trained[key]):
                raise AssertionError(f"{name}.{key} differs between the trainer and {pth}")
    _zero_kernel_counts()
    t0 = time.perf_counter()
    summary = tester.test()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches += _check_no_kernel("eval_fada_deeplab")
    scalars = [v for v in summary.values() if isinstance(v, float)]
    if (not scalars or not all(np.isfinite(scalars))
            or tester.confusion.sum() != FADA_EVAL_IMAGES * SERVE_H * SERVE_W):
        raise AssertionError(f"summary {summary}")
    log(f"[eval_fada_deeplab] {pth} ({os.path.getsize(pth) / 2 ** 20:.0f} MiB: the parts, "
        f"model_D and their optimizers) through cli.test's function on {card}: "
        f"{FADA_EVAL_IMAGES} images at {SERVE_W}x{SERVE_H} in {wall * 1e3:.0f} ms (first "
        f"pass, loader and warm-up included); micro mIoU {summary['micro_miou']:.4f}")
    split, flops, peaks = _fada_split(trainer)
    peak = PEAK_FLOP_PER_S[torch.float32]
    total = sum(split.values())
    log(f"[train_fada_deeplab] a step on {card} (host clock, a device sync after each "
        f"part, median of 3; {total:.1f} ms in all): " + ", ".join(
            f"{key} {ms:.1f} ms (peak {peaks[key]:.0f} MiB)" for key, ms in split.items())
        + f"; counted: generator {flops['generator'] / 1e12:.3f} TFLOP "
        f"({flops['generator'] / split['generator'] / 1e9:.1f} TFLOP/s), discriminator "
        f"{flops['discriminator'] / 1e12:.3f} TFLOP "
        f"({flops['discriminator'] / split['discriminator'] / 1e9:.1f} TFLOP/s); operations "
        f"bound of a step {sum(flops.values()) / peak * 1e3:.1f} ms at {peak / 1e12:.0f} "
        f"TFLOP/s float32")
    # the same split with torch.backends.cudnn.benchmark on (PERF.md) is
    # left out, for the script's time
    return launches


def phase_train_fada_gald(tmp: str, card: str):
    """GALD FADA: kernels #1 (twice a forward, both domains) and #2 (twice a
    step, the source decoder only) must launch as often as the step says."""
    steps = FADA_STEPS["gald"]
    _run_fada("train_fada_gald", tmp, card, "gald_adv.yaml", GALD_FADA_GEOMETRY, steps,
              "SOLVER.CHECKPOINT_PERIOD", "2")
    fwd, bwd = ccattn.KERNEL_LAUNCHES, ccattn.BWD_KERNEL_LAUNCHES
    log(f"[train_fada_gald] launches over {steps} steps: cc_attention_fwd {fwd} "
        f"(4 a step: two forwards, two per forward), cc_attention_bwd {bwd} (2 a step), "
        f"fused_mbconv_fwd {mbconv.KERNEL_LAUNCHES}")
    if fwd != 4 * steps or bwd != 2 * steps or mbconv.KERNEL_LAUNCHES:
        raise AssertionError(f"launches over {steps} steps: forward {fwd}, backward {bwd}; "
                             f"want {4 * steps} and {2 * steps}")
    return fwd, bwd


def phase_train_fada_attn(tmp: str, card: str) -> int:
    """attn FADA with drop-connect and the config's attn augmentation, and
    MODEL.FUSED_MBCONV on, which train mode never takes."""
    _run_fada("train_fada_attn", tmp, card, "attn_adv_kvasir.yaml", ATTN_FADA_GEOMETRY,
              FADA_STEPS["attn"], "SOLVER.CHECKPOINT_PERIOD", "2",
              "MODEL.FUSED_MBCONV", "True")
    return _check_no_kernel("train_fada_attn")


def phase_fada_vgg16(tmp: str, card: str) -> int:
    """The deeplab FADA path with the VGG16 backbone, after its seeded logits'
    scale at the full training size (no norm damps them)."""
    cfg = load_cfg(train_adv.build_parser().parse_args(_fada_opts(
        "deeplabv2_r101_adv.yaml", tmp, "MODEL.NAME", "deeplab_vgg16")))
    device = resolve_device(cfg.MODEL.DEVICE)
    segmentor = Segmentor(build_segmentor(cfg), cfg.MODEL.NUM_CLASSES).to(device)
    randomize_weights_(segmentor, seed=0)
    with torch.inference_mode():
        probe = torch.rand(1, 3, TRAIN_H, TRAIN_W, device=device,
                           generator=torch.Generator(device).manual_seed(0))
        (logits,), features = segmentor(probe)
    top = logits.abs().max().item()
    log(f"[fada_vgg16] seeded deeplab_vgg16 at {TRAIN_W}x{TRAIN_H}: features "
        f"{tuple(features.shape)}, max |logit| {top:.4f}, logit std {logits.std().item():.4f}")
    if not (torch.isfinite(logits).all() and 1e-2 < top < 1e2):
        raise AssertionError(f"seeded VGG16 logits out of range: max {top}")
    del segmentor, probe, logits, features
    _run_fada("fada_vgg16", tmp, card, "deeplabv2_r101_adv.yaml", VGG_FADA_GEOMETRY,
              FADA_STEPS["vgg16"], "SOLVER.CHECKPOINT_PERIOD", "2",
              "MODEL.NAME", "deeplab_vgg16")
    return _check_no_kernel("fada_vgg16")


def _needs(path: str, phase: str) -> str:
    """``path``, which ``phase`` writes; raises when that phase did not run."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} is missing: run the phase {phase} first")
    return path


def _data_root(tmp: str) -> str:
    """The trees phase_data_files wrote."""
    return _needs(os.path.join(tmp, "data"), "data_files")


def _data_share(trainer) -> float:
    """The share of steps 2.. that waited for the loader."""
    times = trainer.meters.meters["time"].series[1:]
    return sum(trainer.meters.meters["data"].series[1:]) / sum(times)


def phase_data_files(tmp: str, card: str) -> None:
    """Writes the GTA5, Cityscapes, Kvasir and BLI trees (DATA_TREES) from
    seed 0, then times one item of each reader through its config's train
    transform on the host (``stage_times``)."""
    from rnd_semantic_segmentation_torch.data import build_dataset, stage_times

    root = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    written = write_dataset_trees(root, seed=0)
    seconds = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    log(f"[data_files] {written} files ({size / 2 ** 20:.0f} MiB) written in {seconds:.1f} s "
        f"under {root}: smooth noise with blobs, PNG (BLI images JPEG)")
    for config, key, name in (("deeplabv2_r101_adv.yaml", "SOURCE_TRAIN", "gta5_train"),
                              ("deeplabv2_r101_adv.yaml", "TARGET_TRAIN", "cityscapes_train"),
                              ("attn_src_kvasir.yaml", "SOURCE_TRAIN", "polyp_train"),
                              ("attn_adv_kvasir.yaml", "TARGET_TRAIN", "bli_train")):
        cfg = load_cfg(train_src.build_parser().parse_args(
            ["-cfg", os.path.join(HERE, "configs", config), "DATASETS.DATASET_DIR", root]))
        if getattr(cfg.DATASETS, key) != name:
            raise AssertionError(f"configs/{config} gives {key} {getattr(cfg.DATASETS, key)}")
        dataset = build_dataset(cfg, "train", is_source=key == "SOURCE_TRAIN")
        image, label, _ = dataset[0]
        timing = stage_times(dataset, cfg.AUG.NAME, n=4)
        log(f"[data_files] {name} ({type(dataset).__name__}, {len(dataset)} images, "
            f"{config}'s {cfg.AUG.NAME} train transform): {image.shape} {image.dtype} "
            f"image, {label.shape} {label.dtype} label; "
            f"{timing['getitem_ms_per_item']} ms an item on one host core")


def phase_train_fada_files(tmp: str, card: str) -> int:
    """configs/deeplabv2_r101_adv.yaml as its users run it: gta5_train ->
    cityscapes_train from the files, 3 steps of 4 + 4 images."""
    trainer = _run_fada("train_fada_files", tmp, card, "deeplabv2_r101_adv.yaml",
                        DEEPLAB_FADA_GEOMETRY, FILE_STEPS["fada"], data_dir=_data_root(tmp))
    names = (trainer.cfg.DATASETS.SOURCE_TRAIN, trainer.cfg.DATASETS.TARGET_TRAIN)
    if names != ("gta5_train", "cityscapes_train"):
        raise AssertionError(f"the config's datasets are {names}")
    log(f"[train_fada_files] {names[0]} ({type(trainer.src_loader.dataset).__name__}) -> "
        f"{names[1]} ({type(trainer.tgt_loader.dataset.dataset).__name__}); data share "
        f"{_data_share(trainer):.1%}")
    MEASURED["train_fada_files"] = (
        float(np.median(trainer.meters.meters["time"].series[1:])) * 1e3, _data_share(trainer))
    return _check_no_kernel("train_fada_files")


def _centred_teacher(tag: str, cfg, render, pth: str, out: str) -> str:
    """``pth`` with each class's mean logit over the first batch of
    DATASETS.TEST taken off its classifier's bias, written to ``out``.  A
    seeded teacher trained for a few steps gives every class a logit that is
    nearly constant over the image, and one class wins everywhere; centred,
    the argmax follows the image, so the PNGs it writes can be told apart."""
    probe = test_cli.make_tester(cfg, render, logger=_stderr_logger(f"chip_smoke.{tag}"))
    batch = next(iter(probe.test_loader))
    x = torch.from_numpy(batch["image"]).to(probe.device).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        (logits,), _ = probe.segmentor(x)
    mean = logits.float().mean(dim=(0, 2, 3)).cpu()
    ckpt = torch.load(pth, map_location="cpu", weights_only=True)
    ckpt["classifier"]["conv2d_list.0.bias"] -= mean
    torch.save(ckpt, out)
    log(f"[{tag}] teacher: {pth} with the class means of its logits over "
        f"{len(batch['name'])} images ({mean.min().item():.3f} to {mean.max().item():.3f}) "
        f"taken off the classifier's bias")
    del probe, x, logits
    return out


def phase_saveres_cityscapes(tmp: str, card: str) -> int:
    """``cli.test --saveres`` with the FADA checkpoint of train_fada_files,
    centred (``_centred_teacher``), on cityscapes_train: one palette PNG an
    image, at the label's 2048x1024, into the folder that
    cityscapes_self_distill_train reads; each must hold more than one id,
    differ from the others and decode to the argmax of a plain ``Tester``
    forward of the same image."""
    from PIL import Image

    from rnd_semantic_segmentation_torch.data import device_prefetch

    root = _data_root(tmp)
    pseudo = os.path.join(root, "cityscapes", "soft_labels")
    out_dir = os.path.join(tmp, "saveres_cityscapes")
    os.makedirs(out_dir, exist_ok=True)

    def parse(pth):
        args = test_cli.build_parser().parse_args(
            ["--saveres", "-c", os.path.join(HERE, "renders", "cityscapes.json"),
             "-cfg", os.path.join(HERE, "configs", "deeplabv2_r101_adv.yaml"),
             "DATASETS.DATASET_DIR", root, "DATASETS.TEST", "cityscapes_train",
             "PSEUDO_DIR", pseudo, *FLOAT32, "OUTPUT_DIR", out_dir, "resume", pth])
        return args, load_cfg(args), load_json(args.config_path)

    fada = _needs(os.path.join(tmp, "train_fada_files", "AsppFada-1.pth"), "train_fada_files")
    args, cfg, render = parse(fada)
    args, cfg, render = parse(_centred_teacher("saveres_cityscapes", cfg, render, fada,
                                               os.path.join(out_dir, "teacher.pth")))
    tester = test_cli.make_tester(cfg, render, saveres=args.saveres,
                                  logger=_stderr_logger("chip_smoke.saveres_cityscapes"))
    torch.cuda.synchronize()
    _zero_kernel_counts()
    t0 = time.perf_counter()
    summary = tester.test()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _check_no_kernel("saveres_cityscapes")
    label_dir = os.path.join(pseudo, "inference", "cityscapes_train")
    n = len(tester.test_loader.dataset)
    if sorted(os.listdir(label_dir)) != sorted(
            os.path.basename(p) for p in tester.test_loader.dataset.image_paths):
        raise AssertionError(f"{label_dir} holds {os.listdir(label_dir)}")
    # the same images again through a plain forward: each PNG is its argmax
    palette, moved, pixels, written = render["palette"], 0, 0, {}
    t0 = time.perf_counter()
    for batch in device_prefetch(iter(tester.test_loader), 2, tester.device):
        x = batch["image"].permute(0, 3, 1, 2).contiguous()
        preds = tester._probs_impl(x, tuple(batch["label"].shape[1:3])).argmax(1).cpu().numpy()
        for pred, name in zip(preds, batch["name"]):
            png = Image.open(os.path.join(label_dir, f"{name}.png"))
            indices = np.asarray(png)
            if (png.mode != "P" or indices.shape != pred.shape
                    or png.getpalette()[:len(palette)] != palette):
                raise AssertionError(f"{name}.png: {png.mode} {indices.shape}, palette "
                                     f"{png.getpalette()[:6]}...")
            moved += int((indices != pred).sum())
            pixels += pred.size
            written[name] = indices
    plain = time.perf_counter() - t0
    ids = [len(np.unique(v)) for v in written.values()]
    distinct = len({v.tobytes() for v in written.values()})
    log(f"[saveres_cityscapes] the number of ids in each PNG: {ids}; {distinct} distinct "
        f"PNGs of {n}")
    if min(ids) < 2 or distinct != n:
        raise AssertionError("a PNG holds one id, or two PNGs are equal")
    log(f"[saveres_cityscapes] cli.test --saveres on {card}: {n} Cityscapes images at "
        f"{cfg.INPUT.INPUT_SIZE_TEST[0]}x{cfg.INPUT.INPUT_SIZE_TEST[1]}, {n} palette PNGs at "
        f"{pred.shape[1]}x{pred.shape[0]} in {wall:.2f} s ({wall / n * 1e3:.0f} ms an "
        f"image; the same pass without the PNGs {plain / n * 1e3:.0f} ms an image); micro "
        f"mIoU {summary['micro_miou']:.4f}; {moved} of {pixels} pixels differ from the "
        f"plain forward's argmax")
    if moved > MAX_TIE_SHARE * pixels:
        raise AssertionError(f"the PNGs differ from the argmax at {moved} pixels")
    return launches


def phase_train_distill_files(tmp: str, card: str) -> int:
    """``cli.train_distill`` with configs/deeplabv2_r101_tgt_self_distill.yaml
    over cityscapes_self_distill_train: the pseudo-labels of
    saveres_cityscapes, batch 5 at 1024x512,
    scales 0.5-1.5 with flip, 2 steps from seeded weights."""
    from rnd_semantic_segmentation_torch.cli import train_distill

    root = _data_root(tmp)
    label_dir = _needs(os.path.join(root, "cityscapes", "soft_labels", "inference",
                                    "cityscapes_train"), "saveres_cityscapes")
    opts = ["-cfg", os.path.join(HERE, "configs", "deeplabv2_r101_tgt_self_distill.yaml"),
            "DATASETS.DATASET_DIR", root, "SOLVER.EPOCHS", "1",
            *FLOAT32, "OUTPUT_DIR", os.path.join(tmp, "train_distill_files")]
    cfg = load_cfg(train_distill.build_parser().parse_args(opts))
    geometry = (cfg.MODEL.NAME, cfg.MODEL.NUM_CLASSES, cfg.DATASETS.SOURCE_TRAIN,
                cfg.SOLVER.BATCH_SIZE, tuple(cfg.INPUT.SOURCE_INPUT_SIZE_TRAIN),
                tuple(cfg.INPUT.INPUT_SCALES_TRAIN), cfg.INPUT.HORIZONTAL_FLIP_PROB_TRAIN,
                bool(cfg.DISTILL.ONLINE))
    if geometry != DISTILL_GEOMETRY:
        raise AssertionError(f"configs/deeplabv2_r101_tgt_self_distill.yaml gives {geometry}, "
                             f"want {DISTILL_GEOMETRY}")
    trainer = train_distill.make_trainer("deeplab_distill", cfg, logger=_stderr_logger(
        "chip_smoke.train_distill_files", logging.INFO))
    randomize_weights_(trainer.segmentor, seed=0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_kernel_counts()
    trainer.train()
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = _check_no_kernel("train_distill_files")
    steps = FILE_STEPS["distill"]
    if trainer.state.step != steps or not all(np.isfinite(trainer.loss_data)):
        raise AssertionError(f"{trainer.state.step} steps, losses {trainer.loss_data}")
    log(f"[train_distill_files] {steps} steps over {cfg.DATASETS.SOURCE_TRAIN} "
        f"({len(trainer.train_loader.dataset)} images, labels from {label_dir}): losses "
        f"{[round(v, 4) for v in trainer.loss_data]}; data share {_data_share(trainer):.1%}")
    _report_steps("train_distill_files", trainer, card, peak_mib)
    from PIL import Image
    ids = set()
    for name in os.listdir(label_dir):
        ids |= set(np.unique(np.asarray(Image.open(os.path.join(label_dir, name)))).tolist())
    trainer.train_loader.set_epoch(1)
    batch = next(iter(trainer.train_loader))
    got = set(np.unique(batch["label"]).tolist())
    log(f"[train_distill_files] a batch {batch['image'].shape}: label ids {sorted(got)}; the "
        f"pseudo-labels hold {sorted(ids)}")
    if not got <= ids | {255} or len(got - {255}) < 2:
        raise AssertionError(f"labels {sorted(got)}: want two or more pseudo-label ids, and "
                             f"nothing else but 255")
    return launches


def _loader_procs() -> int:
    """The worker processes of the file phases: the host's cores less 2."""
    return max(1, len(os.sched_getaffinity(0)) - 2)


def phase_train_attn_files(tmp: str, card: str) -> int:
    """configs/attn_src_kvasir.yaml on polyp_train files, with the config's
    threads and then with N worker processes (N = the host's cores less 2):
    first each loader against a device at PR 9's attn step
    (``measure_overlap`` over two epochs, the first N batches left out),
    then two epochs of 6 steps of 20 at 512x512, reported over the second
    (the first is the ramp: N workers build their first batches at once);
    then the last checkpoint through ``cli.test`` on bli_val files with the
    fused MBConv kernel on.  Returns the kernel's launches in that eval."""
    from rnd_semantic_segmentation_torch.data import (
        DataLoader,
        build_collate_fn,
        build_dataset,
        measure_overlap,
    )

    root = _data_root(tmp)
    procs = _loader_procs()

    def opts(workers: int, out_dir: str):
        return ["-cfg", os.path.join(HERE, "configs", "attn_src_kvasir.yaml"),
                "DATASETS.DATASET_DIR", root, "SOLVER.EPOCHS", str(ATTN_FILE_EPOCHS),
                "SOLVER.CHECKPOINT_PERIOD", "1", "MODEL.FUSED_MBCONV", "True",
                "DATA_PIPE.WORKER_PROCESSES", str(workers), *FLOAT32, "OUTPUT_DIR", out_dir]

    def kind(cfg):
        workers = cfg.DATA_PIPE.WORKER_PROCESSES
        return f"{workers} worker processes" if workers else f"{cfg.DATA_PIPE.NUM_WORKERS} threads"

    cfg = load_cfg(train_src.build_parser().parse_args(opts(0, tmp)))
    dataset = build_dataset(cfg, "train")
    batch = cfg.SOLVER.BATCH_SIZE
    per_epoch = len(dataset) // batch
    if (cfg.DATASETS.SOURCE_TRAIN, batch, per_epoch * ATTN_FILE_EPOCHS) != (
            "polyp_train", 20, FILE_STEPS["attn"]):
        raise AssertionError(f"{cfg.DATASETS.SOURCE_TRAIN}: {len(dataset)} images, batch {batch}")
    for workers in (0, procs):
        cfg = load_cfg(train_src.build_parser().parse_args(opts(workers, tmp)))
        loader = DataLoader(train_adv._Repeat(dataset, ATTN_FILE_EPOCHS), batch_size=batch,
                            num_workers=cfg.DATA_PIPE.NUM_WORKERS, worker_processes=workers,
                            collate_fn=build_collate_fn(cfg), seed=cfg.DATA_PIPE.SEED)
        try:
            r = measure_overlap(loader, batch / ATTN_PR9_STEP_MS * 1e3, warmup_batches=procs)
        finally:
            loader.close()
        log(f"[train_attn_files] measure_overlap, {kind(cfg)}, {ATTN_FILE_EPOCHS} epochs "
            f"against a device at PR 9's step ({ATTN_PR9_STEP_MS} ms a step of {batch}), the "
            f"first {procs} batches left out: {json.dumps(r)}")

    results, pth = {}, ""
    for workers in (0, procs):
        out_dir = os.path.join(tmp, f"train_attn_files_{workers}")
        cfg = load_cfg(train_src.build_parser().parse_args(opts(workers, out_dir)))
        trainer = train_src.make_trainer("attn", cfg, logger=_stderr_logger(
            "chip_smoke.train_attn_files", logging.INFO))
        try:
            randomize_weights_(trainer.segmentor, seed=0)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _zero_kernel_counts()
            trainer.train()
            torch.cuda.synchronize()
            peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
            _check_no_kernel("train_attn_files")
        finally:
            trainer.train_loader.close()
        if trainer.state.step != FILE_STEPS["attn"] or not all(np.isfinite(trainer.loss_data)):
            raise AssertionError(f"{trainer.state.step} steps, losses {trainer.loss_data}")
        times = trainer.meters.meters["time"].series
        waits = trainer.meters.meters["data"].series
        log(f"[train_attn_files] loader: {kind(cfg)}; losses "
            f"{[round(v, 4) for v in trainer.loss_data]}; ms a step "
            f"{[round(t * 1e3) for t in times]}, of which waiting for data "
            f"{[round(t * 1e3) for t in waits]}; peak memory {peak_mib:.0f} MiB")
        # epoch 1 is the ramp; epoch 2 (its start's wait included) is the result
        rates = [batch * per_epoch / sum(times[e * per_epoch:(e + 1) * per_epoch])
                 for e in range(ATTN_FILE_EPOCHS)]
        share = sum(waits[per_epoch:]) / sum(times[per_epoch:])
        results[kind(cfg)] = (rates, share)
        pth = os.path.join(out_dir, f"Attn-{ATTN_FILE_EPOCHS}.pth")
    log(f"[train_attn_files] polyp_train from files on {card}, epochs of {per_epoch} steps of "
        f"{batch} at {ATTN_SIZE}x{ATTN_SIZE}, the second epoch: " + "; ".join(
        f"{k}: {rates[-1]:.2f} images/s, data share {share:.1%} (the first epoch, the ramp: "
        f"{rates[0]:.2f} images/s)" for k, (rates, share) in results.items()))

    MEASURED["train_attn_files"] = {k: (rates[-1], share) for k, (rates, share) in results.items()}
    return _eval_bli_files("eval_bli_files", tmp, root, pth)


def _eval_bli_files(tag: str, tmp: str, root: str, pth: str) -> int:
    """The attn checkpoint ``pth`` through ``cli.test`` on bli_val files with
    the fused MBConv kernel on: 17 launches of it a forward, a finite
    summary.  Returns the launches."""
    args = test_cli.build_parser().parse_args(
        ["-c", os.path.join(HERE, "renders", "bli.json"),
         "-cfg", os.path.join(HERE, "configs", "attn_src_kvasir.yaml"),
         "DATASETS.DATASET_DIR", root, "DATASETS.TEST", "bli_val", "MODEL.FUSED_MBCONV",
         "True", *FLOAT32, "OUTPUT_DIR", os.path.join(tmp, tag), "resume", pth])
    cfg = load_cfg(args)
    tester = test_cli.make_tester(cfg, load_json(args.config_path),
                                  logger=_stderr_logger(f"chip_smoke.{tag}"))
    images = len(tester.test_loader.dataset)
    torch.cuda.synchronize()
    _zero_kernel_counts()
    t0 = time.perf_counter()
    summary = tester.test()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mbconv.KERNEL_LAUNCHES
    forwards = -(-images // cfg.TEST.BATCH_SIZE)
    log(f"[{tag}] {pth} through cli.test on bli_val ({images} BLI images at "
        f"{ATTN_SIZE}x{ATTN_SIZE}, batch {cfg.TEST.BATCH_SIZE}): {wall:.2f} s; "
        f"fused_mbconv_fwd launched {launches} times over {forwards} forwards; micro mIoU "
        f"{summary['micro_miou']:.4f}")
    scalars = [v for v in summary.values() if isinstance(v, float)]
    if launches != MBCONV_LAUNCHES_PER_FORWARD * forwards or not all(np.isfinite(scalars)):
        raise AssertionError(f"{launches} launches over {forwards} forwards, summary {summary}")
    if tester.confusion.sum() != images * ATTN_SIZE ** 2:
        raise AssertionError(f"confusion matrix {tester.confusion.tolist()}")
    return launches


def _pranet_opts(config: str, root: str, out_dir: str, *more):
    """A PraNet config with only the data, the output, the run's length and
    the readers' resize set: the Kvasir-fold and BLI readers resize each
    item, after the pra transform, to INPUT.SOURCE/TARGET_INPUT_SIZE_TRAIN,
    which both configs leave at the defaults (1280x720, 1024x512); at
    TRAINSIZE squared the resize is the identity (ROADMAP Queue 3)."""
    side = f"({PRANET_SIDE}, {PRANET_SIDE})"
    return ["-cfg", os.path.join(HERE, "configs", config), "DATASETS.DATASET_DIR", root,
            "INPUT.SOURCE_INPUT_SIZE_TRAIN", side, "INPUT.TARGET_INPUT_SIZE_TRAIN", side,
            "SOLVER.EPOCHS", "1", "SOLVER.CHECKPOINT_PERIOD", "1", *FLOAT32, "OUTPUT_DIR", out_dir,
            *more]


def _check_pranet_geometry(cfg, config: str) -> None:
    geometry = (cfg.MODEL.NAME, cfg.MODEL.NUM_CLASSES, cfg.SOLVER.BATCH_SIZE,
                cfg.INPUT.TRAINSIZE, tuple(cfg.INPUT.INPUT_SIZE_TEST), cfg.TEST.BATCH_SIZE,
                cfg.SOLVER.BASE_LR, cfg.AUG.NAME)
    if geometry != PRANET_GEOMETRY:
        raise AssertionError(f"configs/{config} gives {geometry}, want {PRANET_GEOMETRY}")


def _pranet_checkpoint(tmp: str) -> str:
    return _needs(os.path.join(tmp, "train_pranet", "PraNet-1.pth"), "train_pranet")


def phase_train_pranet(tmp: str, card: str) -> int:
    """configs/pranet_src_polyp.yaml on polyp_train files through
    ``cli.train_src``'s parser and ``Trainer``: an epoch of batches of 16,
    each taken at the three rates (256, 352 and 448), from seeded weights."""
    from rnd_semantic_segmentation_torch.train.trainer import MULTISCALE_RATES, rate_side

    root = _data_root(tmp)
    out_dir = os.path.join(tmp, "train_pranet")
    opts = _pranet_opts("pranet_src_polyp.yaml", root, out_dir)
    cfg = load_cfg(train_src.build_parser().parse_args(opts))
    _check_pranet_geometry(cfg, "pranet_src_polyp.yaml")
    sides = [rate_side(cfg.INPUT.TRAINSIZE, r) for r in MULTISCALE_RATES]
    if sides != list(PRANET_RATE_SIDES):
        raise AssertionError(f"rate sides {sides}, want {PRANET_RATE_SIDES}")
    logger = _stderr_logger("chip_smoke.train_pranet", logging.INFO)
    trainer = train_src.make_trainer("pranet", cfg, logger=logger)
    segmentor = trainer.segmentor
    randomize_weights_(segmentor, seed=0)
    model = trainer.spec.modules["model"]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    batch = cfg.SOLVER.BATCH_SIZE
    batches = len(trainer.train_loader.dataset) // batch
    log(f"[train_pranet] {cfg.MODEL.NAME}: {sum(p.numel() for p in model.parameters())} "
        f"parameters, {len(stats) // 2} BatchNorms on batch statistics (MODEL.FREEZE_BN "
        f"{cfg.MODEL.FREEZE_BN} does not reach the family), seeded weights; "
        f"{cfg.DATASETS.SOURCE_TRAIN} ({len(trainer.train_loader.dataset)} images), "
        f"{batches} batches of {batch}, rates {MULTISCALE_RATES} -> sides {sides}")

    per_side, seen = {}, []
    step = trainer.step_fn

    def timed(b, epoch0):
        side = int(b["image"].shape[1])
        seen.append(side)
        t0 = time.perf_counter()
        out = step(b, epoch0)  # ends in a device sync
        per_side.setdefault(side, []).append(time.perf_counter() - t0)
        return out

    trainer.step_fn = timed
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_kernel_counts()
    trainer.train()
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = _check_no_kernel("train_pranet")
    trainer.step_fn = step

    steps = trainer.state.step
    if (len(trainer.loss_data) != batches or steps != 3 * batches
            or seen != sides * batches):
        raise AssertionError(f"{steps} steps over {len(trainer.loss_data)} batches at sides "
                             f"{seen}; want 3 a batch over {batches} at {sides}")
    if not all(np.isfinite(trainer.loss_data)):
        raise AssertionError(f"losses {trainer.loss_data}")
    lr = trainer.state.optimizers["model"].param_groups[0]["lr"]
    log(f"[train_pranet] {steps} optimizer steps over {batches} batches: losses (the "
        f"448 step's) {[round(v, 4) for v in trainer.loss_data]}; LR {trainer.lr_data[0]:.3g}, "
        f"the model's {lr:.3g} (1/8)")
    if abs(lr - cfg.SOLVER.BASE_LR / 8) > 1e-12:
        raise AssertionError(f"the model's LR is {lr}, want BASE_LR / 8")
    moved = [(p.detach() - before[n]).abs().max().item() for n, p in model.named_parameters()]
    buffers = dict(model.named_buffers())
    still = [n for n, b in stats.items() if torch.equal(buffers[n], b)]
    log(f"[train_pranet]   {sum(m > 0 for m in moved)} of {len(moved)} parameters moved, by "
        f"at most {max(moved):.3e}; BN running statistics moved: {len(stats) - len(still)} "
        f"of {len(stats)}")
    if not all(m > 0 and np.isfinite(m) for m in moved) or still:
        raise AssertionError(f"a parameter or statistic did not move: {still[:5]}")

    times = trainer.meters.meters["time"].series[1:]
    batch_ms = float(np.median(times)) * 1e3
    side_ms = {side: float(np.median(v[1:])) * 1e3 for side, v in per_side.items()}
    log(f"[train_pranet] on {card}: {batch_ms:.1f} ms a batch of {batch} at three rates "
        f"(median of batches 2..{batches}; the first "
        f"{trainer.meters.meters['time'].series[0] * 1e3:.0f} ms), "
        f"{batch / batch_ms * 1e3:.2f} images/s; ms a step by side (median of batches "
        f"2..): " + ", ".join(f"{s}: {side_ms[s]:.1f}" for s in sides)
        + f"; data share {_data_share(trainer):.1%}; peak memory {peak_mib:.0f} MiB; "
        f"float32, TF32 off")

    MEASURED["train_pranet"] = (batch / batch_ms * 1e3, _data_share(trainer))
    # the checkpoint loads back into Tester through `resume latest`
    tester = Tester(load_cfg(train_src.build_parser().parse_args(opts + ["resume", "latest"])),
                    logger)
    tester._load_checkpoint()
    trained = trainer.segmentor.state_dict()
    for name, value in tester.segmentor.state_dict().items():
        if not torch.equal(value, trained[name]):
            raise AssertionError(f"{name} differs between the trainer and its checkpoint")
    pth = _pranet_checkpoint(tmp)
    log(f"[train_pranet] {pth} ({os.path.getsize(pth) / 2 ** 20:.0f} MiB) loads into Tester; "
        f"its weights and buffers equal the trainer's")

    loader = trainer.train_loader
    loader.set_epoch(1)
    sample = next(iter(loader))
    x = torch.from_numpy(sample["image"]).to(trainer.device).permute(0, 3, 1, 2).contiguous()
    label = torch.from_numpy(sample["label"]).to(trainer.device)
    split, flops = _step_split(trainer, x, label)
    peak = PEAK_FLOP_PER_S[torch.float32]
    bound_ms = (flops["forward"] + flops["backward"]) / peak * 1e3
    log(f"[train_pranet] a step of {batch} at {PRANET_SIDE} on {card} (host clock, a device "
        f"sync after each part, median of 3): forward and loss {split['forward']:.1f} ms "
        f"({flops['forward'] / 1e12:.3f} TFLOP counted, "
        f"{flops['forward'] / split['forward'] / 1e9:.1f} TFLOP/s), backward "
        f"{split['backward']:.1f} ms ({flops['backward'] / 1e12:.3f} TFLOP, "
        f"{flops['backward'] / split['backward'] / 1e9:.1f} TFLOP/s), optimizer "
        f"{split['optimizer']:.1f} ms; operations bound {bound_ms:.1f} ms at "
        f"{peak / 1e12:.0f} TFLOP/s float32")
    # where a whole step's time goes: kernels against the host's clock
    from rnd_semantic_segmentation_torch.train.trainer import resize_batch_to

    at_352 = {"image": x.permute(0, 2, 3, 1).contiguous(), "label": label}
    for side in PRANET_RATE_SIDES[:2]:
        b = at_352 if side == PRANET_SIDE else resize_batch_to(at_352, side)
        _kernel_table(f"train_pranet step at {side}",
                      {"step": lambda: trainer.step_fn(b, 0.0)}, "step")
    return launches


def _device_batch(loader, device) -> dict:
    """The first batch of ``loader``'s epoch 1 on ``device``, NHWC as the
    loader gives it."""
    loader.set_epoch(1)
    sample = next(iter(loader))
    return {k: torch.from_numpy(sample[k]).to(device) for k in ("image", "label")}


def _pranet_head(tester, x: torch.Tensor, size) -> torch.Tensor:
    """The pranet head recomputed from the model's map-2 logits: bilinear to
    ``size``, sigmoid, one min-max over the batch, ``[1 - p, p]``."""
    with torch.inference_mode():
        maps, _ = tester.segmentor(x)
        p = torch.sigmoid(torch.nn.functional.interpolate(
            maps[3].float(), size=size, mode="bilinear", align_corners=False))[:, 0]
        p = (p - p.min()) / (p.max() - p.min() + 1e-8)
        return torch.stack([1 - p, p], dim=1)


def phase_eval_pranet(tmp: str, card: str) -> int:
    """train_pranet's PraNet-1.pth through ``cli.test``'s own function on
    polyp_val and bli_val (batch 1 at 352), the head against its plain
    recomputation, then the card against the CPU."""
    pth = _pranet_checkpoint(tmp)
    root = _data_root(tmp)
    logger = _stderr_logger("chip_smoke.eval_pranet")
    launches = 0
    side = PRANET_SIDE
    for dataset, render in (("polyp_val", "kvasir.json"), ("bli_val", "bli.json")):
        out_dir = os.path.join(tmp, f"eval_pranet_{dataset}")
        args = test_cli.build_parser().parse_args(
            ["-c", os.path.join(HERE, "renders", render)]
            + _pranet_opts("pranet_src_polyp.yaml", root, out_dir, "DATASETS.TEST", dataset,
                           "resume", pth))
        cfg = load_cfg(args)
        _check_pranet_geometry(cfg, "pranet_src_polyp.yaml")
        tester = test_cli.make_tester(cfg, load_json(args.config_path), logger=logger)
        images = len(tester.test_loader.dataset)
        torch.cuda.synchronize()
        _zero_kernel_counts()
        t0 = time.perf_counter()
        summary = tester.test()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches += _check_no_kernel("eval_pranet")
        scalars = [v for v in summary.values() if isinstance(v, float)]
        if not scalars or not all(np.isfinite(scalars)) or not 0 <= summary["micro_miou"] <= 1:
            raise AssertionError(f"summary {summary}")
        if tester.confusion.sum() != images * side * side:
            raise AssertionError(f"confusion matrix {tester.confusion.tolist()}")
        log(f"[eval_pranet] {dataset} ({images} images at {side}x{side}, batch "
            f"{cfg.TEST.BATCH_SIZE}) on {card}: {wall * 1e3:.0f} ms "
            f"({images / wall:.1f} images/s, loader and warm-up included); micro mIoU "
            f"{summary['micro_miou']:.4f}, macro mIoU {summary['macro_miou']:.4f}")

    # the head on two of the last dataset's images against its plain recomputation
    loader = tester.test_loader
    pair = loader.collate_fn([loader.dataset[i] for i in range(2)])
    x = torch.from_numpy(pair["image"]).to(tester.device).permute(0, 3, 1, 2).contiguous()
    probs = tester._probs_impl(x, (side, side))
    ref = _pranet_head(tester, x, (side, side))
    err = (probs - ref).abs().max().item()
    log(f"[eval_pranet] the head on a batch of 2 against sigmoid, batch min-max and stack "
        f"of map 2: max abs difference {err:.2e} (tolerance {PRANET_HEAD_TOLERANCE:g}); "
        f"p spans {probs[:, 1].min().item():.3f} to {probs[:, 1].max().item():.3f}")
    if probs.shape != (2, 2, side, side) or not err <= PRANET_HEAD_TOLERANCE:
        raise AssertionError(f"head {tuple(probs.shape)}, error {err}")

    one = x[:1]
    forward_ms = host_ms(lambda: tester._probs_impl(one, (side, side)).sum().item())
    device_ms = graph_ms(lambda: tester._probs_impl(one, (side, side)), reps=2, replays=5)
    flops = _counted_flops(lambda: tester._probs_impl(one, (side, side)))
    bound_ms = flops / PEAK_FLOP_PER_S[torch.float32] * 1e3
    log(f"[eval_pranet] forward of one {side}x{side} image on {card}: {forward_ms:.2f} ms on "
        f"the host's clock, {device_ms:.2f} ms of device time (CUDA graph replay); "
        f"{flops / 1e9:.2f} GFLOP counted, bound {bound_ms:.3f} ms at 67 TFLOP/s float32, "
        f"{flops / device_ms / 1e9:.1f} TFLOP/s achieved")

    # the card against the CPU: a seeded pranet_res2net50 at 64x64
    small = load_cfg(test_cli.build_parser().parse_args(
        ["-cfg", os.path.join(HERE, "configs", "pranet_src_polyp.yaml"),
         "MODEL.DEVICE", "cpu"]))
    segmentor = Segmentor(build_segmentor(small), small.MODEL.NUM_CLASSES)
    randomize_weights_(segmentor, seed=0)
    xs = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        refs, _ = segmentor.eval()(xs)
        outs, _ = segmentor.to(tester.device)(xs.to(tester.device))
    errs = [((o.cpu() - r).abs().max() / r.abs().max()).item() for o, r in zip(outs, refs)]
    log(f"[eval_pranet] pranet_res2net50 at 64x64, card against CPU: the four maps within "
        f"{max(errs):.2e} of their largest magnitude (tolerance {PRANET_CPU_TOLERANCE:g})")
    if not max(errs) <= PRANET_CPU_TOLERANCE:
        raise AssertionError(f"card and CPU maps differ: {errs}")
    return launches


def phase_serve_pranet(tmp: str, card: str) -> int:
    """The daemon on train_pranet's checkpoint at 352x352: 16 PNG requests from
    8 threads.  The pranet head min-maxes over its batch, zero rows of a
    padded bucket included, so one dispatched batch of masks is checked
    against ``Tester._probs_impl`` on that same bucket outside the server."""
    from rnd_semantic_segmentation_torch.serve.server import InferenceServer

    pth = _pranet_checkpoint(tmp)
    args = build_parser().parse_args(
        ["--max-batch", str(MAX_BATCH), "-c", os.path.join(HERE, "renders", "kvasir.json")]
        + _pranet_opts("pranet_src_polyp.yaml", _data_root(tmp), tmp, "resume", pth))
    cfg = load_cfg(args)
    _check_pranet_geometry(cfg, "pranet_src_polyp.yaml")
    dispatched = []
    run = InferenceServer._run

    def recording(self, x, n=None):
        preds = run(self, x, n)
        if n is not None:
            dispatched.append((x.copy(), n, preds))
        return preds

    _zero_kernel_counts()
    with mock.patch.object(InferenceServer, "_run", recording):
        inf, bodies, masks, batches, _, wall = serve_traffic(
            "serve_pranet", cfg, args, load_json(args.config_path), PRANET_SIDE, PRANET_SIDE,
            card, (ccattn, "KERNEL_LAUNCHES"))
    launches = _check_no_kernel("serve_pranet")
    serve_breakdown("serve_pranet", inf, bodies, masks, PRANET_SIDE, PRANET_SIDE, batches,
                    wall, card)
    x, n, preds = max(dispatched, key=lambda d: d[1])
    xt = torch.from_numpy(x).to(inf.tester.device).permute(0, 3, 1, 2).contiguous()
    ref = inf.tester._probs_impl(xt, (PRANET_SIDE, PRANET_SIDE)).argmax(1).to(torch.uint8)
    ref = ref[:n].cpu().numpy()
    differ = int(sum((p != r).sum() for p, r in zip(preds, ref)))
    log(f"[serve_pranet] {len(dispatched)} dispatched batches of {[d[1] for d in dispatched]} "
        f"requests; the batch of {n} in a bucket of {len(x)} against Tester._probs_impl on "
        f"the same bucket: {differ} of {n * PRANET_SIDE ** 2} pixels differ")
    if differ:
        raise AssertionError(f"{differ} pixels of the served masks differ from the Tester's")
    return launches


def phase_train_fada_pranet(tmp: str, card: str) -> int:
    """configs/pranet_adv_polyp_bli.yaml: polyp_train -> bli_train from the
    files, 8 + 8 images a step at 352 (SOLVER.BATCH_SIZE // 2 each, as the
    JAX CLI), one epoch; then PraNetFada-1.pth through ``cli.test`` on
    bli_val."""
    root = _data_root(tmp)
    side = f"({PRANET_SIDE}, {PRANET_SIDE})"
    trainer = _run_fada("train_fada_pranet", tmp, card, "pranet_adv_polyp_bli.yaml",
                        PRANET_FADA_GEOMETRY, FILE_STEPS["pranet_fada"],
                        "SOLVER.CHECKPOINT_PERIOD", "1", "INPUT.SOURCE_INPUT_SIZE_TRAIN", side,
                        "INPUT.TARGET_INPUT_SIZE_TRAIN", side, data_dir=root)
    launches = _check_no_kernel("train_fada_pranet")
    names = (trainer.cfg.DATASETS.SOURCE_TRAIN, trainer.cfg.DATASETS.TARGET_TRAIN)
    if names != ("polyp_train", "bli_train") or trainer.rates != (1.0,):
        raise AssertionError(f"datasets {names}, rates {trainer.rates}")
    log(f"[train_fada_pranet] {names[0]} -> {names[1]}, one step a batch; data share "
        f"{_data_share(trainer):.1%}")
    src, tgt = (_device_batch(loader, trainer.device)
                for loader in (trainer.src_loader, trainer.tgt_loader))
    _kernel_table("train_fada_pranet step", {"step": lambda: trainer.step_fn(src, tgt, 0.0)},
                  "step", top=8)
    pth = os.path.join(tmp, "train_fada_pranet", "PraNetFada-1.pth")
    args = test_cli.build_parser().parse_args(
        ["-c", os.path.join(HERE, "renders", "bli.json")]
        + _pranet_opts("pranet_adv_polyp_bli.yaml", root, os.path.join(tmp, "eval_fada_pranet"),
                       "resume", pth))
    cfg = load_cfg(args)
    tester = test_cli.make_tester(cfg, load_json(args.config_path),
                                  logger=_stderr_logger("chip_smoke.eval_fada_pranet"))
    _zero_kernel_counts()
    t0 = time.perf_counter()
    summary = tester.test()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches += _check_no_kernel("eval_fada_pranet")
    images = len(tester.test_loader.dataset)
    scalars = [v for v in summary.values() if isinstance(v, float)]
    if (cfg.DATASETS.TEST != "bli_val" or not all(np.isfinite(scalars))
            or tester.confusion.sum() != images * PRANET_SIDE ** 2):
        raise AssertionError(f"{cfg.DATASETS.TEST}: summary {summary}")
    log(f"[train_fada_pranet] {pth} through cli.test on bli_val ({images} images at "
        f"{PRANET_SIDE}x{PRANET_SIDE}): {wall * 1e3:.0f} ms, micro mIoU "
        f"{summary['micro_miou']:.4f}")
    return launches


class _FirstItems:
    """The first ``n`` items of ``dataset``: a phase cut to fewer steps."""

    def __init__(self, dataset, n: int):
        if n > len(dataset):
            raise AssertionError(f"{type(dataset).__name__} has {len(dataset)} items, not {n}")
        self.dataset, self.n = dataset, n
        self.image_paths = dataset.image_paths[:n]

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.dataset[i]


def _online_trainer(tag: str, opts, batches=None):
    """``cli.train_distill``'s online trainer for ``opts`` (DISTILL.ONLINE on),
    its student from seeded weights, its loader cut to ``batches`` batches."""
    from rnd_semantic_segmentation_torch.cli import train_distill

    cfg = load_cfg(train_distill.build_parser().parse_args(opts))
    if not cfg.DISTILL.ONLINE:
        raise AssertionError(f"[{tag}] DISTILL.ONLINE is off")
    trainer = train_distill.make_online_trainer(
        cfg.MODEL.NAME.split("_")[0] + "_distill", cfg,
        logger=_stderr_logger(f"chip_smoke.{tag}", logging.INFO))
    loader = trainer.train_loader
    if batches is not None:
        if loader.worker_processes:
            raise AssertionError(f"[{tag}] a cut dataset would not reach forked workers")
        loader.dataset = _FirstItems(loader.dataset, batches * loader.batch_size)
        trainer.steps_per_epoch = len(loader)
    randomize_weights_(trainer.segmentor, seed=0)
    return trainer


def _run_online(tag: str, trainer, card: str) -> dict:
    """Trains the online trainer for its epoch with the kernel counts set to 0
    just before; records each step's loss, the first batch and every
    pseudo-label map.  Checks the losses are finite, every student
    parameter moved and every teacher tensor stayed bit-equal; returns the
    records and the three kernel counts."""
    from rnd_semantic_segmentation_torch.train import distill

    student = {n: p.detach().clone() for n, p in trainer.segmentor.named_parameters()}
    teacher = {k: v.clone() for k, v in trainer.teacher.state_dict().items()}
    rec = {"losses": [], "images": [], "labels": []}
    step, real = trainer.step_fn, distill.pseudo_labels

    def recording_step(batch, epoch0):
        if not rec["images"]:
            rec["images"].append(batch["image"].clone())
        out = step(batch, epoch0)
        rec["losses"].append(out["loss"])
        return out

    def recording_labels(logits, *args):
        labels = real(logits, *args)
        rec["labels"].append(labels)
        return labels

    trainer.step_fn = recording_step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_kernel_counts()
    with mock.patch.object(distill, "pseudo_labels", recording_labels):
        trainer.train()
    torch.cuda.synchronize()
    rec["counts"] = tuple(getattr(m, n) for m, n in KERNEL_COUNTERS)
    rec["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    trainer.step_fn = step
    if not rec["losses"] or not all(np.isfinite(rec["losses"])):
        raise AssertionError(f"[{tag}] losses {rec['losses']}")
    moved = [(p.detach() - student[n]).abs().max().item()
             for n, p in trainer.segmentor.named_parameters()]
    changed = [k for k, v in trainer.teacher.state_dict().items() if not torch.equal(v, teacher[k])]
    cfg = trainer.cfg
    log(f"[{tag}] {cfg.MODEL.NAME} online from {cfg.DISTILL.TEACHER} (threshold "
        f"{cfg.DISTILL.CONFIDENCE_THRESHOLD}): {trainer.state.step} steps over "
        f"{len(trainer.train_loader.dataset)} images of {cfg.DATASETS.SOURCE_TRAIN}, losses "
        f"{[round(v, 4) for v in rec['losses']]}; {sum(m > 0 for m in moved)} of {len(moved)} "
        f"student parameters moved; {len(changed)} of {len(teacher)} teacher tensors changed")
    if not all(m > 0 and np.isfinite(m) for m in moved) or changed:
        raise AssertionError(f"[{tag}] a student parameter did not move, or the teacher "
                             f"changed: {changed[:5]}")
    _report_steps(tag, trainer, card, rec["peak_mib"])
    return rec


def phase_train_distill_online(tmp: str, card: str) -> int:
    """configs/deeplabv2_r101_tgt_self_distill.yaml online, its teacher
    train_fada_files' AsppFada-1.pth as saveres_cityscapes centred it, at
    threshold 0.9, on the cityscapes
    files (the reader's pseudo-label PNGs, from saveres_cityscapes, are read
    and ignored): batch 5 at 1024x512, 2 steps.  The first batch's labels
    must be the argmax of a ``Tester`` forward of the teacher, and 255
    exactly where its largest probability is below 0.9."""
    root = _data_root(tmp)
    _needs(os.path.join(root, "cityscapes", "soft_labels", "inference", "cityscapes_train"),
           "saveres_cityscapes")
    # train_fada_files' AsppFada-1.pth as saveres_cityscapes centred it: uncentred,
    # it gives one class everywhere at probability 1.000 (0% ignored at 0.9)
    teacher = _needs(os.path.join(tmp, "saveres_cityscapes", "teacher.pth"), "saveres_cityscapes")
    opts = ["-cfg", os.path.join(HERE, "configs", "deeplabv2_r101_tgt_self_distill.yaml"),
            "DATASETS.DATASET_DIR", root, "SOLVER.EPOCHS", "1", *FLOAT32,
            "OUTPUT_DIR", os.path.join(tmp, "train_distill_online"), "DISTILL.ONLINE", "True",
            "DISTILL.TEACHER", teacher, "DISTILL.CONFIDENCE_THRESHOLD", str(ONLINE_THRESHOLD)]
    trainer = _online_trainer("train_distill_online", opts)
    geometry = (trainer.cfg.MODEL.NAME, trainer.cfg.SOLVER.BATCH_SIZE,
                tuple(trainer.cfg.INPUT.SOURCE_INPUT_SIZE_TRAIN))
    if geometry != ("deeplab_resnet101", 5, (1024, 512)):
        raise AssertionError(f"configs/deeplabv2_r101_tgt_self_distill.yaml gives {geometry}")
    rec = _run_online("train_distill_online", trainer, card)
    launches = _check_no_kernel("train_distill_online")
    if trainer.state.step != ONLINE_STEPS["deeplab"]:
        raise AssertionError(f"{trainer.state.step} steps, want {ONLINE_STEPS['deeplab']}")

    tester = Tester(load_cfg(train_src.build_parser().parse_args(opts + ["resume", teacher])),
                    _stderr_logger("chip_smoke.train_distill_online"))
    tester._load_checkpoint()
    x = rec["images"][0].permute(0, 3, 1, 2).contiguous()
    conf, arg = tester._probs_impl(x, tuple(x.shape[2:])).max(dim=1)
    want = torch.where(conf >= ONLINE_THRESHOLD, arg.int(), trainer.cfg.INPUT.IGNORE_LABEL)
    got = rec["labels"][0]
    differ = int((got != want).sum())
    ignored = (got == trainer.cfg.INPUT.IGNORE_LABEL).float().mean().item()
    classes = sorted(set(got.unique().tolist()) - {trainer.cfg.INPUT.IGNORE_LABEL})
    log(f"[train_distill_online] the first batch's pseudo-labels {tuple(got.shape)} against "
        f"a Tester forward of the teacher: {differ} of {got.numel()} pixels differ; "
        f"{ignored:.1%} ignored (largest probability below {ONLINE_THRESHOLD}), classes "
        f"present {classes}; the teacher's largest probability spans "
        f"{conf.min().item():.3f} to {conf.max().item():.3f}")
    if differ > MAX_TIE_SHARE * got.numel():
        raise AssertionError(f"the pseudo-labels differ from the teacher's argmax at {differ} "
                             f"pixels")
    return launches


def phase_train_distill_online_gald(tmp: str, card: str):
    """configs/gald_tgt_self_distill.yaml online at full width, its teacher the
    train phase's Gald-1.pth (seeded when that phase did not run): batch 5 of
    synthetic images at 1024x512, 3 steps.  Kernel #1 launches 4 times a step
    (2 teacher, 2 student) and #2 twice; the student's criss-cross attention
    receives gradients and moves."""
    out_dir = os.path.join(tmp, "train_distill_online_gald")
    opts = ["-cfg", os.path.join(HERE, "configs", "gald_tgt_self_distill.yaml"),
            "DATASETS.SOURCE_TRAIN", "synthetic_train", "SOLVER.EPOCHS", "1",
            *FLOAT32, "OUTPUT_DIR", out_dir, "DISTILL.ONLINE", "True"]
    cfg = load_cfg(train_src.build_parser().parse_args(opts))
    steps = ONLINE_STEPS["gald"]
    pth = os.path.join(tmp, "train", "Gald-1.pth")
    if not os.path.exists(pth):
        pth = os.path.join(tmp, "gald_teacher.pth")
        _seeded_checkpoint("train_distill_online_gald", cfg, pth)
    trainer = _online_trainer("train_distill_online_gald", opts + [
        "DATASETS.SYNTHETIC_LENGTH", str(cfg.SOLVER.BATCH_SIZE * steps), "DISTILL.TEACHER", pth])
    geometry = (trainer.cfg.MODEL.NAME, trainer.cfg.MODEL.NUM_CLASSES,
                trainer.cfg.SOLVER.BATCH_SIZE, tuple(trainer.cfg.INPUT.SOURCE_INPUT_SIZE_TRAIN))
    if geometry != ("gald_hardnet68", 19, 5, (1024, 512)):
        raise AssertionError(f"configs/gald_tgt_self_distill.yaml gives {geometry}")
    relation = trainer.segmentor.parts["decoder"].long_relation
    attention = {n: p for n, p in relation.named_parameters() if n in ATTENTION_PARAMS}
    before = {n: p.detach().clone() for n, p in attention.items()}
    rec = _run_online("train_distill_online_gald", trainer, card)
    fwd, bwd, fused = rec["counts"]
    want = tuple(n * steps for n in ONLINE_GALD_LAUNCHES)
    log(f"[train_distill_online_gald] launches over {trainer.state.step} steps: "
        f"cc_attention_fwd {fwd}, cc_attention_bwd {bwd}, fused_mbconv_fwd {fused}; want "
        f"{want[0]} and {want[1]} ({ONLINE_GALD_LAUNCHES[0]} and {ONLINE_GALD_LAUNCHES[1]} a "
        f"step) and 0")
    if trainer.state.step != steps or (fwd, bwd) != want or fused:
        raise AssertionError(f"{trainer.state.step} steps, launches {rec['counts']}")
    for name, p in attention.items():
        grad = 0.0 if p.grad is None else p.grad.abs().max().item()
        moved = (p.detach() - before[name]).abs().max().item()
        log(f"[train_distill_online_gald]   student long_relation.{name}: max |grad| "
            f"{grad:.3e}, moved {moved:.3e}")
        if not (grad > 0 and moved > 0 and np.isfinite(grad)):
            raise AssertionError(f"long_relation.{name} got no gradient or did not move")
    labels = rec["labels"][0]
    log(f"[train_distill_online_gald] pseudo-labels {tuple(labels.shape)}, classes present "
        f"{len(labels.unique())} of 19")
    return fwd, bwd


def _attn_files_checkpoint(tmp: str) -> str:
    return _needs(os.path.join(tmp, f"train_attn_files_{_loader_procs()}",
                               f"Attn-{ATTN_FILE_EPOCHS}.pth"), "train_attn_files")


def phase_train_distill_online_polyp(tmp: str, card: str) -> int:
    """attn B2 online from train_attn_files' checkpoint with
    MODEL.FUSED_MBCONV on (the teacher takes kernel #3 17 times a step, the
    student never), 3 steps of 20 at 512x512 of polyp_train files; then
    pranet_res2net50 online from train_pranet's PraNet-1.pth, 2 batches of
    16, each at the three rates, its pseudo-labels binary.  Returns kernel
    #3's launches."""
    root = _data_root(tmp)
    steps = ONLINE_STEPS["attn"]
    opts = ["-cfg", os.path.join(HERE, "configs", "attn_src_kvasir.yaml"),
            "DATASETS.DATASET_DIR", root, "SOLVER.EPOCHS", "1", "MODEL.FUSED_MBCONV", "True",
            *FLOAT32, "OUTPUT_DIR", os.path.join(tmp, "train_distill_online_attn"),
            "DISTILL.ONLINE", "True", "DISTILL.TEACHER", _attn_files_checkpoint(tmp)]
    trainer = _online_trainer("train_distill_online_attn", opts, batches=steps)
    rec = _run_online("train_distill_online_attn", trainer, card)
    fwd, bwd, fused = rec["counts"]
    fg = torch.cat([v.flatten() for v in rec["labels"]]).float().mean().item()
    log(f"[train_distill_online_attn] launches over {trainer.state.step} steps: "
        f"fused_mbconv_fwd {fused} (want {MBCONV_LAUNCHES_PER_FORWARD} x {steps}, the "
        f"teacher's), cc_attention_fwd {fwd}, cc_attention_bwd {bwd}; pseudo-label "
        f"foreground share {fg:.1%}")
    if trainer.state.step != steps or (fwd, bwd, fused) != (
            0, 0, MBCONV_LAUNCHES_PER_FORWARD * steps):
        raise AssertionError(f"{trainer.state.step} steps, launches {rec['counts']}")

    batches = ONLINE_STEPS["pranet"]
    opts = _pranet_opts("pranet_src_polyp.yaml", root,
                        os.path.join(tmp, "train_distill_online_pranet"),
                        "SOLVER.CHECKPOINT_PERIOD", "5", "DISTILL.ONLINE", "True",
                        "DISTILL.TEACHER", _pranet_checkpoint(tmp))
    trainer = _online_trainer("train_distill_online_pranet", opts, batches=batches)
    rec = _run_online("train_distill_online_pranet", trainer, card)
    _check_no_kernel("train_distill_online_pranet")
    values = set(torch.cat([v.flatten() for v in rec["labels"]]).unique().tolist())
    shares = [round(v.float().mean().item(), 4) for v in rec["labels"]]
    log(f"[train_distill_online_pranet] {trainer.state.step} steps over {batches} batches "
        f"(sides {[tuple(v.shape[1:]) for v in rec['labels']]}): every step's loss finite; "
        f"pseudo-label values {sorted(values)}, foreground share per step {shares}")
    if trainer.state.step != 3 * batches or len(rec["losses"]) != 3 * batches \
            or not values <= {0, 1}:
        raise AssertionError(f"{trainer.state.step} steps, pseudo-label values {values}")
    return fused


def _device_aug_apply_on_card(device) -> None:
    """Each apply function on the card against the same function on the CPU
    with the same draws."""
    from rnd_semantic_segmentation_torch.data import device_pipe as dp

    def on(draws):
        return {k: on(v) if isinstance(v, dict) else v.to(device) for k, v in draws.items()}

    gen = torch.Generator().manual_seed(0)
    cases = []
    for name, (h, w), draw, fn, kw in (
            ("augment_batch_pra", (352, 352), lambda b: dp.draw_pra(gen, b),
             dp.augment_batch_pra, {}),
            ("augment_batch_attn", (512, 512), lambda b: dp.draw_attn(gen, b, prob=1.0),
             dp.augment_batch_attn, {}),
            ("augment_batch", (1052, 1914),
             lambda b: dp.draw_aspp(gen, b, 0.5, (0.5, 0.5, 0.5, 0.2)), dp.augment_batch,
             {"size": (720, 1280)})):
        x = torch.rand(4, h, w, 3, generator=gen)
        y = torch.randint(0, 19, (4, h, w), generator=gen, dtype=torch.int32)
        draws = draw(4)
        ref = fn(x, y, draws, **kw)
        got = fn(x.to(device), y.to(device), on(draws), **kw)
        err = (got["image"].cpu() - ref["image"]).abs().max().item()
        scale = 1 / min(dp.IMAGENET_STD) if fn is not dp.augment_batch_attn else 1.0
        labels = int((got["label"].cpu() != ref["label"]).sum())
        cases.append(f"{name} {tuple(x.shape)}: image max abs difference {err:.2e} "
                     f"(tolerance {DEVICE_AUG_TOLERANCE * scale:.2e}), {labels} labels differ")
        if not err <= DEVICE_AUG_TOLERANCE * scale or labels:
            raise AssertionError(f"{name} on the card differs from the CPU: {cases[-1]}")
    log("[device_aug] (a) the apply functions on the card against the CPU with the same "
        "draws: " + "; ".join(cases))


def _eval_train_gap(segmentor, x: torch.Tensor) -> float:
    """||eval-mode output - train-mode output|| / ||train-mode output|| of a
    copy of ``segmentor`` on ``x`` (NCHW): how far the running statistics
    are from the batch's (the train-mode forward's drop-connect seeded)."""
    model = copy.deepcopy(segmentor)
    with torch.no_grad():
        evals, _ = model(x, train=False)
        trains, _ = model(x, train=True,
                          generator=torch.Generator(device=x.device).manual_seed(0))
    return ((evals[0] - trains[0]).norm() / trains[0].norm()).item()


def phase_device_aug(tmp: str, card: str) -> int:
    """DATA_PIPE.DEVICE_AUG: (a) the apply functions on the card against the
    CPU; (b) configs/attn_src_kvasir.yaml with it and SOLVER.BN_RECAL_BATCHES
    8 on polyp_train files with N worker processes (as train_attn_files),
    two epochs of 6 steps of 20, then the recalibration's checks and the
    re-saved checkpoint through ``cli.test`` on bli_val with kernel #3;
    (c) configs/pranet_src_polyp_tpu.yaml with only NATIVE_DECODE and
    ASYNC_CHECKPOINT off besides the data, output and run length, one epoch
    of 7 batches of 16; (d) configs/deeplabv2_r101_adv.yaml with it on
    gta5_train -> cityscapes_train files, 4 + 4 a step.  Returns kernel #3's
    launches (the bli_val eval)."""
    from rnd_semantic_segmentation_torch.data import device_pipe as dp
    from rnd_semantic_segmentation_torch.data import device_prefetch
    from rnd_semantic_segmentation_torch.train import trainer as trainer_module

    root = _data_root(tmp)
    device = resolve_device("cuda")
    _device_aug_apply_on_card(device)

    # (b) attn, device augmentation and BN recalibration
    procs = _loader_procs()
    out_dir = os.path.join(tmp, "device_aug_attn")
    opts = ["-cfg", os.path.join(HERE, "configs", "attn_src_kvasir.yaml"),
            "DATASETS.DATASET_DIR", root, "SOLVER.EPOCHS", str(DEVICE_AUG_EPOCHS),
            "SOLVER.CHECKPOINT_PERIOD", "1", "MODEL.FUSED_MBCONV", "True",
            "DATA_PIPE.WORKER_PROCESSES", str(procs), "DATA_PIPE.DEVICE_AUG", "True",
            "SOLVER.BN_RECAL_BATCHES", "8", *FLOAT32, "OUTPUT_DIR", out_dir]
    cfg = load_cfg(train_src.build_parser().parse_args(opts))
    trainer = train_src.make_trainer("attn", cfg, logger=_stderr_logger(
        "chip_smoke.device_aug", logging.INFO))
    recal = {}
    real = trainer_module.recalibrate_batch_stats

    def recording(segmentor, batches, **kw):
        recal["before"] = copy.deepcopy(segmentor.state_dict())
        recal["batches"] = len(batches)
        t0 = time.perf_counter()
        n = real(segmentor, batches, **kw)
        torch.cuda.synchronize()
        recal["ms"] = (time.perf_counter() - t0) * 1e3
        return n

    try:
        randomize_weights_(trainer.segmentor, seed=0)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_kernel_counts()
        with mock.patch.object(trainer_module, "recalibrate_batch_stats", recording):
            trainer.train()
        torch.cuda.synchronize()
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        _check_no_kernel("device_aug")
        loader = trainer.train_loader
        loader.set_epoch(1)
        raw = next(device_prefetch(iter(loader), 1, device=device))
    finally:
        trainer.train_loader.close()
    per_epoch = len(trainer.train_loader)
    steps = per_epoch * DEVICE_AUG_EPOCHS
    if trainer.state.step != steps or not all(np.isfinite(trainer.loss_data)):
        raise AssertionError(f"{trainer.state.step} steps, losses {trainer.loss_data}")
    times = trainer.meters.meters["time"].series
    waits = trainer.meters.meters["data"].series
    rate = cfg.SOLVER.BATCH_SIZE * per_epoch / sum(times[per_epoch:])
    share = sum(waits[per_epoch:]) / sum(times[per_epoch:])
    before_files = MEASURED.get("train_attn_files", {}).get(f"{procs} worker processes")
    log(f"[device_aug] (b) attn_src_kvasir.yaml with DEVICE_AUG on polyp_train files, {procs} "
        f"worker processes, {DEVICE_AUG_EPOCHS} epochs of {per_epoch} steps of "
        f"{cfg.SOLVER.BATCH_SIZE} at {ATTN_SIZE}x{ATTN_SIZE} on {card}: the second epoch "
        f"{rate:.2f} images/s, data share {share:.1%}; the host's attn transform in "
        f"train_attn_files of this run: " + (
            f"{before_files[0]:.2f} images/s, data share {before_files[1]:.1%}"
            if before_files else "not run in this call")
        + f"; losses {[round(v, 4) for v in trainer.loss_data]}; peak {peak_mib:.0f} MiB")

    before = recal["before"]
    after = trainer.segmentor.state_dict()
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    still = [k for k in stats if torch.equal(after[k], before[k])]
    log(f"[device_aug] (b) BN recalibration over {recal['batches']} device-augmented batches "
        f"(SOLVER.BN_RECAL_BATCHES 8; an epoch of the loader holds {per_epoch}) in "
        f"{recal['ms']:.0f} ms: {len(stats) - len(still)} of {len(stats)} running statistics "
        f"changed")
    if still or recal["batches"] != min(8, per_epoch):
        raise AssertionError(f"running statistics unchanged: {still[:5]}")
    pth = os.path.join(out_dir, f"Attn-{DEVICE_AUG_EPOCHS}.pth")
    ckpt = torch.load(pth, map_location="cpu", weights_only=True)
    other = []
    for part in trainer.spec.modules:
        for key, value in ckpt[part].items():
            full = f"parts.{part}.{key}"
            if not torch.equal(value, after[full].cpu()):
                raise AssertionError(f"{pth}: {full} is not the recalibrated model's")
            if not key.endswith(("running_mean", "running_var")) \
                    and not torch.equal(value, before[full].cpu()):
                other.append(full)
    if other or "optimizer_encoder" not in ckpt:
        raise AssertionError(f"{pth} differs from the state before the recalibration outside "
                             f"the BatchNorm statistics: {other[:5]}")
    batch = trainer.device_augs[0](raw, 0)
    x = batch["image"].permute(0, 3, 1, 2).contiguous()
    pre = copy.deepcopy(trainer.segmentor)
    pre.load_state_dict(before)
    gap_before, gap_after = _eval_train_gap(pre, x), _eval_train_gap(trainer.segmentor, x)
    log(f"[device_aug] (b) {pth} is the recalibrated model, and differs from the state "
        f"before only in BatchNorm statistics; on one train batch, ||eval - train|| / "
        f"||train|| of the output: {gap_before:.4f} before, {gap_after:.4f} after")
    if not gap_after < gap_before:
        raise AssertionError("the recalibration did not bring eval closer to train mode")
    del pre
    launches = _eval_bli_files("device_aug_eval_bli", tmp, root, pth)

    # (c) the PraNet TPU recipe with the knobs that still raise turned off
    out_dir = os.path.join(tmp, "device_aug_pranet")
    opts = _pranet_opts("pranet_src_polyp_tpu.yaml", root, out_dir,
                        "DATA_PIPE.NATIVE_DECODE", "False", "SOLVER.ASYNC_CHECKPOINT", "False")
    cfg = load_cfg(train_src.build_parser().parse_args(opts))
    if not (cfg.DATA_PIPE.DEVICE_AUG and cfg.DATA_PIPE.WORKER_PROCESSES):
        raise AssertionError("configs/pranet_src_polyp_tpu.yaml: DEVICE_AUG or worker "
                             "processes off")
    trainer = train_src.make_trainer("pranet", cfg, logger=_stderr_logger(
        "chip_smoke.device_aug", logging.INFO))
    try:
        randomize_weights_(trainer.segmentor, seed=0)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_kernel_counts()
        trainer.train()
        torch.cuda.synchronize()
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        _check_no_kernel("device_aug")
    finally:
        trainer.train_loader.close()
    batches = len(trainer.train_loader)
    if trainer.state.step != 3 * batches or not all(np.isfinite(trainer.loss_data)):
        raise AssertionError(f"{trainer.state.step} steps, losses {trainer.loss_data}")
    batch_ms = float(np.median(trainer.meters.meters["time"].series[1:])) * 1e3
    before_pranet = MEASURED.get("train_pranet")
    log(f"[device_aug] (c) pranet_src_polyp_tpu.yaml ({cfg.DATA_PIPE.WORKER_PROCESSES} worker "
        f"processes, DEVICE_AUG) on {card}: {batches} batches of {cfg.SOLVER.BATCH_SIZE} at "
        f"the three rates, {batch_ms:.1f} ms a batch (median of 2..), "
        f"{cfg.SOLVER.BATCH_SIZE / batch_ms * 1e3:.2f} images/s, data share "
        f"{_data_share(trainer):.1%}, peak {peak_mib:.0f} MiB; train_pranet of this run (4 "
        f"threads, the host's pra transform): " + (
            f"{before_pranet[0]:.2f} images/s, data share {before_pranet[1]:.1%}"
            if before_pranet else "not run in this call"))

    # (d) FADA, both streams through the device
    seen = []
    augment = train_adv.FadaTrainer._augment

    def recording_augment(self, args, iteration):
        out = augment(self, args, iteration)
        if not seen:
            seen.append((args, out, self))
        return out

    with mock.patch.object(train_adv.FadaTrainer, "_augment", recording_augment):
        trainer = _run_fada("device_aug_fada", tmp, card, "deeplabv2_r101_adv.yaml",
                            DEEPLAB_FADA_GEOMETRY, FILE_STEPS["fada"], "DATA_PIPE.DEVICE_AUG",
                            "True", data_dir=root)
    _check_no_kernel("device_aug")
    (raw_src, raw_tgt), (src, tgt), fada = seen[0]
    inp = fada.cfg.INPUT
    plain = dp.augment_batch(raw_tgt["image"], raw_tgt["label"], {"jitter": {}},
                             size=(inp.TARGET_INPUT_SIZE_TRAIN[1], inp.TARGET_INPUT_SIZE_TRAIN[0]),
                             mean=tuple(inp.PIXEL_MEAN), std=tuple(inp.PIXEL_STD))
    before_fada = MEASURED.get("train_fada_files")
    step_ms = float(np.median(trainer.meters.meters["time"].series[1:])) * 1e3
    log(f"[device_aug] (d) deeplabv2_r101_adv.yaml with DEVICE_AUG: source "
        f"{tuple(raw_src['image'].shape)} -> {tuple(src['image'].shape)}, target "
        f"{tuple(raw_tgt['image'].shape)} -> {tuple(tgt['image'].shape)}; {step_ms:.1f} ms a "
        f"step, data share {_data_share(trainer):.1%}; train_fada_files of this run (the "
        f"host's aspp transform): " + (f"{before_fada[0]:.1f} ms a step, data share "
                                       f"{before_fada[1]:.1%}" if before_fada
                                       else "not run in this call"))
    if (tuple(src["image"].shape) != (4, 720, 1280, 3)
            or tuple(tgt["image"].shape) != (4, 512, 1024, 3)
            or not torch.equal(tgt["image"], plain["image"])):
        raise AssertionError("the FADA batches are not at the train sizes, or the target "
                             "was jittered or flipped")
    return launches


# -- bfloat16 training (MODEL.DTYPE) and rematerialisation --------------------------

BF16_STEPS = 3                 # a run: one warm-up step and 2 timed
BF16_PRANET_BATCHES = 2        # each at the three rates: one warm-up batch, one timed
BF16_ONLINE_STEPS = 3
REMAT_STEPS = 4
# (config, family, MODEL.NAME, NUM_CLASSES, batch, (W, H)): each family's own config
BF16_CONFIGS = (
    ("deeplabv2_r101_src.yaml", "deeplab", "deeplab_resnet101", 19, TRAIN_BATCH,
     (TRAIN_W, TRAIN_H)),
    ("gald_src.yaml", "gald", "gald_hardnet68", 19, TRAIN_BATCH, (TRAIN_W, TRAIN_H)),
    ("attn_src_kvasir.yaml", "attn", ATTN_MODEL, 2, 20, (ATTN_SIZE, ATTN_SIZE)),
    ("pranet_src_polyp.yaml", "pranet", "pranet_res2net50", 2, 16,
     (PRANET_SIDE, PRANET_SIDE)),
)


def _conv_types(modules):
    """Records the output type of every convolution of ``modules``; returns
    the set it fills and a function that removes the hooks."""
    seen, hooks = set(), []
    for module in modules:
        for m in module.modules():
            if isinstance(m, torch.nn.Conv2d):
                hooks.append(m.register_forward_hook(
                    lambda mod, inp, out: seen.add(str(out.dtype)[6:])))
    return seen, lambda: [h.remove() for h in hooks]


def _synthetic_trainer(tag: str, tmp: str, config: str, family: str, steps: int, *more):
    """The source trainer of ``config`` on the synthetic dataset, ``steps``
    batches long, from seeded weights; ``more`` overrides the config."""
    out_dir = os.path.join(tmp, tag)
    opts = ["-cfg", os.path.join(HERE, "configs", config), "DATASETS.SOURCE_TRAIN",
            "synthetic_train", "SOLVER.EPOCHS", "1", "SOLVER.CHECKPOINT_PERIOD", "5",
            "OUTPUT_DIR", out_dir, *more]
    batch = load_cfg(train_src.build_parser().parse_args(opts)).SOLVER.BATCH_SIZE
    cfg = load_cfg(train_src.build_parser().parse_args(
        opts + ["DATASETS.SYNTHETIC_LENGTH", str(batch * steps)]))
    trainer = train_src.make_trainer(family, cfg, logger=_stderr_logger(
        f"chip_smoke.{tag}", logging.WARNING))
    randomize_weights_(trainer.segmentor, seed=0)
    return trainer


def _timed_train(tag: str, trainer, card: str) -> dict:
    """Trains the trainer's epoch with the kernel counts set to 0 just before:
    ms a step (median after the first), peak memory, the loss series, the
    types of every convolution's output and of the parameters."""
    types, unhook = _conv_types(trainer.segmentor.parts.values())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_kernel_counts()
    trainer.train()
    torch.cuda.synchronize()
    counts = tuple(getattr(m, n) for m, n in KERNEL_COUNTERS)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    unhook()
    if not trainer.loss_data or not all(np.isfinite(trainer.loss_data)):
        raise AssertionError(f"[{tag}] losses {trainer.loss_data}")
    params = {str(p.dtype)[6:] for p in trainer.segmentor.parameters()}
    step_ms = _report_steps(tag, trainer, card, peak_mib)
    log(f"[{tag}] losses {[round(v, 4) for v in trainer.loss_data]}; parameters {params}, "
        f"convolution outputs {sorted(types)}; launches (cc fwd, cc bwd, mbconv) {counts}")
    want = trainer.cfg.MODEL.DTYPE
    if params != {"float32"} or types != {want}:
        raise AssertionError(f"[{tag}] parameters {params}, convolutions {types}, want "
                             f"float32 parameters and {want} convolutions")
    return {"ms": step_ms, "peak_mib": peak_mib, "losses": list(trainer.loss_data),
            "counts": counts}


def _global_rel(grads, refs) -> float:
    """||grad - ref|| / ||ref|| over all leaves as one vector."""
    num = sum((grads[n] - r).float().square().sum().item() for n, r in refs.items())
    return (num / sum(r.float().square().sum().item() for r in refs.values())) ** 0.5


def _gald_bf16_grads(trainer) -> float:
    """One bfloat16 GALD step's gradients through kernels #1 and #2 against
    the same step with the plain core, all leaves as one vector, in eval
    mode (BatchNorm on running statistics, where the step is well
    conditioned) within BWD_TOLERANCE[bfloat16]; the train-mode step's
    difference is reported beside the kernels' own run-to-run difference:
    in bfloat16, train-mode BatchNorm from random weights amplifies an ulp
    of either core's output into a few percent of the gradient.  The
    losses agree within the tolerance in both modes.  A leaf whose true
    gradient is 0 (the key convolution's bias: the softmax ignores a
    constant shift of the energies) is rounding noise, so no leaf is held
    alone.  Returns the eval-mode difference."""
    from rnd_semantic_segmentation_torch.train.steps import make_family_loss

    cfg, segmentor = trainer.cfg, trainer.segmentor
    loader = trainer.train_loader
    loader.set_epoch(1)
    sample = next(iter(loader))
    x = torch.from_numpy(sample["image"]).to(trainer.device).to(torch.bfloat16) \
        .permute(0, 3, 1, 2).contiguous()
    label = torch.from_numpy(sample["label"]).to(trainer.device)
    loss_fn = make_family_loss(trainer.spec, cfg.MODEL.NUM_CLASSES, cfg.INPUT.IGNORE_LABEL)
    tol = BWD_TOLERANCE[torch.bfloat16]
    result = {}
    for train in (False, True):
        mode = "train" if train else "eval"
        loss_k, grads_k = _one_step_grads(segmentor, loss_fn, x, label, train)
        _, grads_k2 = _one_step_grads(segmentor, loss_fn, x, label, train)
        with mock.patch.object(gcpa, "cc_attention_core", ccattn.cc_attention_core_plain):
            before = ccattn.KERNEL_LAUNCHES + ccattn.BWD_KERNEL_LAUNCHES
            loss_p, grads_p = _one_step_grads(segmentor, loss_fn, x, label, train)
            if ccattn.KERNEL_LAUNCHES + ccattn.BWD_KERNEL_LAUNCHES != before:
                raise AssertionError("the plain-core step launched a kernel")
        result[mode] = _global_rel(grads_k, grads_p)
        worst, worst_name = _worst_leaf(grads_k, grads_p)
        log(f"[train_bf16] gald, one bfloat16 step in {mode} mode, kernels vs plain core: "
            f"loss {loss_k:.6f} vs {loss_p:.6f}; gradient off by {result[mode]:.3e} of its "
            f"norm (the kernels twice: {_global_rel(grads_k2, grads_k):.3e}); worst leaf "
            f"{worst_name} {worst:.3e}")
        if abs(loss_k - loss_p) > tol * abs(loss_p):
            raise AssertionError(f"bfloat16 {mode}-mode loss {loss_k} against {loss_p}")
    if result["eval"] > tol:
        raise AssertionError(f"bfloat16 eval-mode gradients off by {result['eval']} of their "
                             f"norm from the plain-core step's (tolerance {tol})")
    return result["eval"]


def phase_train_bf16(tmp: str, card: str) -> dict:
    """Each family's own config at its default MODEL.DTYPE bfloat16 beside
    the same run at float32, in one process, on the synthetic dataset at the
    float32 phases' shapes: deeplab and gald 6 at 1280x720, attn B2 20 at
    512, 3 steps (one warm-up); pranet 16 at the three rates, 2 batches.
    The GALD runs launch kernels #1 and #2 twice a step each, in their
    bfloat16 instances in the bfloat16 run, and one bfloat16 step's
    gradients through them are held against the plain core
    (``_gald_bf16_grads``).  Returns the bfloat16 runs' launches of #1 and
    #2."""
    launches = [0, 0]
    for config, family, name, nc, batch, size in BF16_CONFIGS:
        steps = BF16_PRANET_BATCHES if family == "pranet" else BF16_STEPS
        more = ("INPUT.SOURCE_INPUT_SIZE_TRAIN", f"({size[0]}, {size[1]})") \
            if family == "pranet" else ()
        runs = {}
        for dtype in ("float32", "bfloat16"):
            tag = f"train_bf16 {family} {dtype}"
            pin = FLOAT32 if dtype == "float32" else ()
            trainer = _synthetic_trainer(f"train_bf16_{family}_{dtype}", tmp, config, family,
                                         steps, *more, *pin)
            cfg = trainer.cfg
            got = (cfg.MODEL.NAME, cfg.MODEL.NUM_CLASSES, cfg.SOLVER.BATCH_SIZE,
                   tuple(cfg.INPUT.SOURCE_INPUT_SIZE_TRAIN), cfg.MODEL.DTYPE)
            if got != (name, nc, batch, size, dtype):
                raise AssertionError(f"configs/{config} gives {got}")
            runs[dtype] = _timed_train(tag, trainer, card)
            fwd, bwd, fused = runs[dtype]["counts"]
            optimizer_steps = trainer.state.step
            if family == "gald":
                if (fwd, bwd, fused) != (2 * optimizer_steps, 2 * optimizer_steps, 0):
                    raise AssertionError(f"[{tag}] launches {runs[dtype]['counts']} over "
                                         f"{optimizer_steps} steps, want 2 and 2 a step")
                if dtype == "bfloat16":
                    launches[0] += fwd
                    launches[1] += bwd
                    _gald_bf16_grads(trainer)
            elif any(runs[dtype]["counts"]):
                raise AssertionError(f"[{tag}] a hand kernel ran: {runs[dtype]['counts']}")
            del trainer
            torch.cuda.empty_cache()
        f32, bf16 = runs["float32"], runs["bfloat16"]
        log(f"[train_bf16] {family} on {card}: bfloat16 {bf16['ms']:.1f} ms/step, "
            f"{bf16['peak_mib']:.0f} MiB peak; float32 {f32['ms']:.1f} ms/step, "
            f"{f32['peak_mib']:.0f} MiB peak; bfloat16 / float32 time "
            f"{bf16['ms'] / f32['ms']:.2f}, memory {bf16['peak_mib'] / f32['peak_mib']:.2f}")
    return tuple(launches)


def phase_train_fada_bf16(tmp: str, card: str) -> int:
    """configs/deeplabv2_r101_adv.yaml at its default MODEL.DTYPE bfloat16:
    3 steps of 4 + 4, D on the bfloat16 tap; the step split, with the
    kernel tables of the generator's and D's parts."""
    trainer = _run_fada("train_fada_bf16", tmp, card, "deeplabv2_r101_adv.yaml",
                        DEEPLAB_FADA_GEOMETRY, 3, "MODEL.DTYPE", "bfloat16")
    launches = _check_no_kernel("train_fada_bf16")
    types, unhook = _conv_types(list(trainer.spec.modules.values()) + [trainer.disc])
    split, flops, peaks = _fada_split(trainer, tag="train_fada_bf16")
    unhook()
    log(f"[train_fada_bf16] on {card}: step split (ms, host clock, medians of 3) "
        + "; ".join(f"{k} {v:.1f}" for k, v in split.items())
        + f"; generator {flops['generator'] / 1e12:.2f} TFLOP, discriminator "
        f"{flops['discriminator'] / 1e12:.2f} TFLOP; convolution outputs {sorted(types)}")
    if types != {"bfloat16"}:
        raise AssertionError(f"[train_fada_bf16] convolutions in {types}")
    return launches


def _seeded_or(tag: str, cfg, pth: str, seeded: str) -> str:
    """``pth`` when an earlier phase wrote it, else a seeded checkpoint
    written to ``seeded``."""
    if os.path.exists(pth):
        return pth
    _seeded_checkpoint(tag, cfg, seeded)
    return seeded


def phase_distill_online_bf16(tmp: str, card: str):
    """Online distillation at MODEL.DTYPE bfloat16, the image cast before
    the teacher: configs/gald_tgt_self_distill.yaml, 3 steps of 5 synthetic
    images at 1024x512 (#1 4 launches a step, #2 2, both on bfloat16 q, k,
    v); attn B2 with MODEL.FUSED_MBCONV from train_attn_files' checkpoint
    (seeded when that phase did not run), 3 steps of 20 synthetic images at
    512 (#3 17 launches a step, all the teacher's, on bfloat16
    activations).  Returns the launches (#1, #2, #3)."""
    from rnd_semantic_segmentation_torch.models import efficientnet

    steps = BF16_ONLINE_STEPS
    out_dir = os.path.join(tmp, "distill_online_bf16_gald")
    opts = ["-cfg", os.path.join(HERE, "configs", "gald_tgt_self_distill.yaml"),
            "DATASETS.SOURCE_TRAIN", "synthetic_train", "SOLVER.EPOCHS", "1",
            "OUTPUT_DIR", out_dir, "DISTILL.ONLINE", "True"]
    cfg = load_cfg(train_src.build_parser().parse_args(opts))
    pth = _seeded_or("distill_online_bf16", cfg, os.path.join(tmp, "train", "Gald-1.pth"),
                     os.path.join(tmp, "gald_teacher_bf16.pth"))
    trainer = _online_trainer("distill_online_bf16_gald", opts + [
        "DATASETS.SYNTHETIC_LENGTH", str(cfg.SOLVER.BATCH_SIZE * steps), "DISTILL.TEACHER", pth])
    if (trainer.cfg.MODEL.DTYPE, trainer.cfg.SOLVER.BATCH_SIZE,
            tuple(trainer.cfg.INPUT.SOURCE_INPUT_SIZE_TRAIN)) != ("bfloat16", 5, (1024, 512)):
        raise AssertionError("configs/gald_tgt_self_distill.yaml: not bfloat16, 5 at 1024x512")
    seen = []
    hooks = [seg.parts["decoder"].long_relation.register_forward_hook(
        lambda m, inp, out: seen.append((str(inp[0].dtype)[6:], str(out.dtype)[6:])))
        for seg in (trainer.segmentor, trainer.teacher)]
    rec = _run_online("distill_online_bf16_gald", trainer, card)
    for h in hooks:
        h.remove()
    fwd, bwd, _ = rec["counts"]
    want = tuple(n * steps for n in ONLINE_GALD_LAUNCHES)
    log(f"[distill_online_bf16] gald launches over {trainer.state.step} steps: "
        f"cc_attention_fwd {fwd}, cc_attention_bwd {bwd} (want {want}); criss-cross "
        f"inputs and outputs {sorted(set(seen))}")
    if (fwd, bwd) != want or set(seen) != {("bfloat16", "bfloat16")} or rec["counts"][2]:
        raise AssertionError(f"gald online bf16: launches {rec['counts']}, types {set(seen)}")
    del trainer
    torch.cuda.empty_cache()

    out_dir = os.path.join(tmp, "distill_online_bf16_attn")
    opts = ["-cfg", os.path.join(HERE, "configs", "attn_src_kvasir.yaml"),
            "DATASETS.SOURCE_TRAIN", "synthetic_train", "SOLVER.EPOCHS", "1",
            "DATASETS.SYNTHETIC_LENGTH", str(20 * steps), "MODEL.FUSED_MBCONV", "True",
            "OUTPUT_DIR", out_dir, "DISTILL.ONLINE", "True"]
    cfg = load_cfg(train_src.build_parser().parse_args(opts))
    pth = _seeded_or("distill_online_bf16", cfg, os.path.join(
        tmp, f"train_attn_files_{_loader_procs()}", f"Attn-{ATTN_FILE_EPOCHS}.pth"),
        os.path.join(tmp, "attn_teacher_bf16.pth"))
    trainer = _online_trainer("distill_online_bf16_attn", opts + ["DISTILL.TEACHER", pth])
    fused_types = []
    real = efficientnet.fused_mbconv_core

    def recording(x, *args):
        fused_types.append(str(x.dtype)[6:])
        return real(x, *args)

    with mock.patch.object(efficientnet, "fused_mbconv_core", recording):
        rec = _run_online("distill_online_bf16_attn", trainer, card)
    fused = rec["counts"][2]
    log(f"[distill_online_bf16] attn launches over {trainer.state.step} steps: "
        f"fused_mbconv_fwd {fused} (want {MBCONV_LAUNCHES_PER_FORWARD} x {steps}) on "
        f"{sorted(set(fused_types))} activations")
    if (trainer.state.step != steps or rec["counts"] != (0, 0, MBCONV_LAUNCHES_PER_FORWARD
                                                          * steps)
            or set(fused_types) != {"bfloat16"}):
        raise AssertionError(f"attn online bf16: launches {rec['counts']}, {set(fused_types)}")
    return fwd, bwd, fused


def _remat_pair(tag: str, tmp: str, card: str, config: str, family: str, knobs,
                same=()) -> None:
    """The same run from the same weights and batches with ``knobs`` off
    and on (``same`` in both): ms a step, peak memory, the largest
    differences in the losses, the last step's gradients and the BatchNorm
    running statistics.  Fails unless the peak memory is lower with them on."""
    runs, grads, stats = {}, {}, {}
    for on in (False, True):
        more = tuple(same) + (tuple(knobs) if on else ())
        trainer = _synthetic_trainer(f"{tag}_{'on' if on else 'off'}", tmp, config, family,
                                     REMAT_STEPS, *more)
        label = f"{tag} {'on' if on else 'off'}"
        runs[on] = _timed_train(label, trainer, card)
        grads[on] = {n: p.grad.detach().float().clone()
                     for n, p in trainer.segmentor.named_parameters() if p.grad is not None}
        stats[on] = {n: b.detach().float().clone() for n, b in
                     trainer.segmentor.named_buffers()
                     if n.endswith(("running_mean", "running_var", "num_batches_tracked"))}
        dtype = trainer.cfg.MODEL.DTYPE
        del trainer
        torch.cuda.empty_cache()
    loss_diff = max(abs(a - b) for a, b in zip(runs[False]["losses"], runs[True]["losses"]))
    grad_diff = max(((grads[True][n] - g).abs().max() / g.abs().max().clamp(min=1e-30)).item()
                    for n, g in grads[False].items())
    stat_diff = max([(stats[True][n] - s).abs().max().item() for n, s in stats[False].items()]
                    or [0.0])
    off, on = runs[False], runs[True]
    log(f"[{tag}] on {card}, {dtype}: off {off['ms']:.1f} ms/step, {off['peak_mib']:.0f} MiB "
        f"peak; on ({' '.join(knobs)}) {on['ms']:.1f} ms/step, {on['peak_mib']:.0f} MiB peak; "
        f"time x{on['ms'] / off['ms']:.2f}, memory x{on['peak_mib'] / off['peak_mib']:.2f}; "
        f"largest differences: loss {loss_diff:.3e}, gradient {grad_diff:.3e} of the leaf's "
        f"largest, BatchNorm buffer {stat_diff:.3e} ({len(stats[False])} buffers)")
    if not on["peak_mib"] < off["peak_mib"]:
        raise AssertionError(f"[{tag}] peak memory {on['peak_mib']:.0f} MiB with "
                             f"rematerialisation, {off['peak_mib']:.0f} without")
    if any(on["counts"]) or any(off["counts"]):
        raise AssertionError(f"[{tag}] a hand kernel ran")


def phase_remat(tmp: str, card: str) -> None:
    """attn B2, 20 at 512, bfloat16, MODEL.REMAT_BLOCKS off against on, the
    host augmentation off (AUG.PROB 0: its draws from the ``random`` module
    in the loader's threads would give the two runs other batches); then
    DeepLabV2-ResNet101, 6 at 1280x720, bfloat16, MODEL.REMAT_BLOCKS with
    SOLVER.REMAT full against neither; 4 steps a run (one warm-up)."""
    _remat_pair("remat_attn", tmp, card, "attn_src_kvasir.yaml", "attn",
                ("MODEL.REMAT_BLOCKS", "True"), same=("AUG.PROB", "0.0"))
    _remat_pair("remat_deeplab", tmp, card, "deeplabv2_r101_src.yaml", "deeplab",
                ("MODEL.REMAT_BLOCKS", "True", "SOLVER.REMAT", "full"))


# -- int8 quantization, export and the eval entry points (serve/quant.py) ------------

# the quantized paths: DeepLabV2-ResNet101 evaluated on QUANT_IMAGES synthetic
# images at 1024x512, then QUANT_LARGE_IMAGES at 2048x1024, where TEST.QUANT
# auto resolves to float32 (TEST.QUANT_MAX_AREA 1048576 pixels)
QUANT_IMAGES, QUANT_LARGE_IMAGES = 32, 4
LARGE_W, LARGE_H = 2048, 1024
EXPORT_BATCH = 2
# the int8 conv's shape classes on DeepLab's path, as (name, x [B,Ci,H,W], k
# [Co,Ci,kh,kw], stride, padding, dilation): layer3's 1x1, layer1's 3x3,
# layer4's 3x3 at dilation 4, layer2's strided 3x3 and 1x1 convs of pooled
# maps (one row per image: the product pads them to 32)
INT8_CONV_CLASSES = ([("1x1", (1, 1024, 64, 128), (256, 1024, 1, 1), 1, 0, 1),
                      ("3x3", (1, 64, 128, 256), (64, 64, 3, 3), 1, 1, 1),
                      ("3x3 dilated", (1, 512, 64, 128), (512, 512, 3, 3), 1, 4, 4),
                      ("3x3 strided", (1, 128, 128, 256), (128, 128, 3, 3), 2, 1, 1)]
                     + [(f"pooled rows {b}", (b, 1152, 1, 1), (64, 1152, 1, 1), 1, 0, 1)
                        for b in range(1, 9)])


def _int8_conv_classes(device="cuda") -> None:
    """The int8 conv against ``F.conv2d`` in float64 of the same integers, at
    each of INT8_CONV_CLASSES: bit-equal (int32 sums of s8 products are exact),
    with the time of each beside cuDNN's float32 conv of the same shape."""
    from rnd_semantic_segmentation_torch.serve.quant import int8_conv2d

    gen = torch.Generator(device=device).manual_seed(0)
    for name, xs, ks, stride, padding, dilation in INT8_CONV_CLASSES:
        x8 = torch.randint(-127, 128, xs, generator=gen, device=device, dtype=torch.int8)
        k8 = torch.randint(-127, 128, ks, generator=gen, device=device, dtype=torch.int8)
        got = int8_conv2d(x8, k8, (stride, stride), (padding, padding), (dilation, dilation))
        want = torch.nn.functional.conv2d(x8.double(), k8.double(), None, stride, padding,
                                          dilation)
        if got.dtype != torch.int32 or not torch.equal(got.double(), want):
            raise AssertionError(f"int8 conv {name}: not equal to float64 of its integers")
        xf, kf = x8.float(), k8.float()
        int8_ms = graph_ms(lambda: int8_conv2d(x8, k8, (stride, stride), (padding, padding),
                                               (dilation, dilation)), reps=5, replays=5)
        f32_ms = graph_ms(lambda: torch.nn.functional.conv2d(xf, kf, None, stride, padding,
                                                             dilation), reps=5, replays=5)
        log(f"[quant_deeplab] int8 conv {name}: x {list(xs)}, k {list(ks)}, stride {stride}, "
            f"dilation {dilation}: bit-equal to float64 of its integers; {int8_ms:.3f} ms "
            f"(columns and torch._int_mm) against cuDNN float32 {f32_ms:.3f} ms")


def _quant_forward(tag: str, tester, qctx, batch: int, w: int, h: int) -> dict:
    """Host-clock ms per image of the head's forward on a batch of ``batch``
    seeded images, under ``qctx`` and in float32, the peak memory of each, and
    the argmax agreement between them."""
    from rnd_semantic_segmentation_torch.serve.quant import quant_scope

    x = torch.rand(batch, 3, h, w, device=tester.device,
                   generator=torch.Generator(device=tester.device).manual_seed(batch))
    out = {}
    for name, ctx in (("float32", None), ("quant", qctx)):
        with quant_scope(ctx):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            pred = tester._probs_impl(x, (h, w)).argmax(1)
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            ms = host_ms(lambda: tester._probs_impl(x, (h, w)).sum().item())
        out[name] = (ms / batch, peak, pred)
    agreement = float((out["float32"][2] == out["quant"][2]).float().mean())
    mode = qctx.mode if qctx is not None else "none"
    log(f"[{tag}] forward of {batch} at {w}x{h}: float32 {out['float32'][0]:.2f} ms/image "
        f"({out['float32'][1]:.0f} MiB peak), {mode} {out['quant'][0]:.2f} ms/image "
        f"({out['quant'][1]:.0f} MiB peak), x{out['quant'][0] / out['float32'][0]:.2f}; "
        f"argmax agreement {agreement:.6f}")
    return {"float_ms": out["float32"][0], "quant_ms": out["quant"][0],
            "float_peak_mib": out["float32"][1], "quant_peak_mib": out["quant"][1],
            "agreement": agreement}


def _quant_eval(tag: str, tmp: str, cfg_opts, card: str, images: int, w: int, h: int,
                on_tester=None):
    """``cli.test``'s Tester on ``images`` synthetic images: the quant context
    made (calibration and the policy) and timed, then ``test()`` timed;
    returns the tester, its summary and ms per image of the eval loop.
    ``on_tester(tester)`` runs before the quant context is made."""
    args = test_cli.build_parser().parse_args(cfg_opts)
    cfg = load_cfg(args)
    tester = test_cli.make_tester(cfg, load_json(args.config_path),
                                  logger=_stderr_logger(f"chip_smoke.{tag}"))
    if on_tester is not None:
        on_tester(tester)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qctx = tester.make_quant_context()
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary = tester.test()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scalars = [v for v in summary.values() if isinstance(v, float)]
    if not scalars or not all(np.isfinite(scalars)) or tester.confusion.sum() != images * w * h:
        raise AssertionError(f"[{tag}] summary {summary}")
    if not os.path.exists(os.path.join(cfg.OUTPUT_DIR, f"{tester.spec.family}_confusion_matrix.png")):
        raise AssertionError(f"[{tag}] no confusion heat map")
    quantized = len(qctx.act_scales) - len(qctx.exclude) if qctx is not None else 0
    log(f"[{tag}] TEST.QUANT {cfg.TEST.QUANT} on {card}: {images} images at {w}x{h}, batch "
        f"{cfg.TEST.BATCH_SIZE}: quant context {calib_s * 1e3:.0f} ms (calibration and "
        f"policy), eval loop {wall / images * 1e3:.1f} ms/image (loader included); "
        f"{quantized} convs quantized; quant_report {tester.quant_report}; micro mIoU "
        f"{summary['micro_miou']:.4f}")
    return tester, summary, wall / images * 1e3


def _quant_deeplab_opts(out_dir: str, pth: str, images: int, w: int, h: int, *more):
    return (["-c", os.path.join(HERE, "renders", "cityscapes.json")]
            + _deeplab_opts(out_dir, "DATASETS.SYNTHETIC_LENGTH", str(images),
                            "INPUT.INPUT_SIZE_TEST", f"({w}, {h})", "resume", pth, *more))


def _quant_deeplab_checkpoint(tmp: str) -> str:
    pth = os.path.join(tmp, "quant_deeplab", "Aspp-seeded.pth")
    if not os.path.exists(pth):
        os.makedirs(os.path.dirname(pth), exist_ok=True)
        cfg = load_cfg(train_src.build_parser().parse_args(_deeplab_opts(tmp)))
        _seeded_checkpoint("quant_deeplab", cfg, pth)
    return pth


def phase_quant_deeplab(tmp: str, card: str) -> int:
    """DeepLabV2-ResNet101 (configs/deeplabv2_r101_src.yaml, seeded) under
    TEST.QUANT: the int8 conv's shape classes against float64; 32 images at
    1024x512 in float32, int8 and auto through ``Tester.test()``; the forward
    of 1 and of 8 in float32 and int8 (ms, peak memory, agreement); 16
    requests served under int8; then 2048x1024 in float32 and int8, and what
    auto resolves to there.  No hand kernel lies on this path."""
    from rnd_semantic_segmentation_torch.serve.quant import quant_scope, resolve_mode

    _int8_conv_classes()
    pth = _quant_deeplab_checkpoint(tmp)
    _zero_kernel_counts()
    results = {}
    for mode in ("none", "int8", "auto"):
        tester, summary, ms = _quant_eval(
            f"quant_deeplab_{mode}", tmp, _quant_deeplab_opts(
                os.path.join(tmp, f"quant_deeplab_{mode}"), pth, QUANT_IMAGES, SERVE_W,
                SERVE_H, "TEST.QUANT", mode), card, QUANT_IMAGES, SERVE_W, SERVE_H)
        _check_deeplab_geometry(tester.cfg)
        results[mode] = (tester, ms)
    tester = results["int8"][0]
    if tester.quant_report["mode"] != "int8" or tester._qctx is None:
        raise AssertionError(f"explicit int8 did not quantize: {tester.quant_report}")
    MEASURED["quant_deeplab"] = {"eval_ms": {m: r[1] for m, r in results.items()}}
    for batch in (1, MAX_BATCH):
        MEASURED["quant_deeplab"][f"forward_{batch}"] = _quant_forward(
            "quant_deeplab", tester, tester._qctx, batch, SERVE_W, SERVE_H)
    del results
    torch.cuda.empty_cache()

    args = build_parser().parse_args(
        ["--max-batch", str(MAX_BATCH), "-c", os.path.join(HERE, "renders", "cityscapes.json")]
        + _deeplab_opts(tmp, "resume", pth, "TEST.QUANT", "int8"))
    cfg = load_cfg(args)
    inf, bodies, masks, batches, _, wall = serve_traffic(
        "quant_deeplab_serve", cfg, args, load_json(args.config_path), SERVE_W, SERVE_H, card,
        (ccattn, "KERNEL_LAUNCHES"))
    if inf.quant_state() != "int8":
        raise AssertionError(f"the server serves {inf.quant_state()}, not int8")
    with quant_scope(inf._qctx):
        x = serve_breakdown("quant_deeplab_serve", inf, bodies, masks, SERVE_W, SERVE_H,
                            batches, wall, card)
        _check_agreement("quant_deeplab_serve", "the Tester's int8 forward",
                         inf.tester._probs_impl(x, (SERVE_H, SERVE_W)), masks,
                         MIN_QUANT_MASK_AGREEMENT)
    del inf
    torch.cuda.empty_cache()

    large = {}
    for mode in ("none", "int8"):
        tester, _, ms = _quant_eval(
            f"quant_deeplab_large_{mode}", tmp, _quant_deeplab_opts(
                os.path.join(tmp, f"quant_deeplab_large_{mode}"), pth, QUANT_LARGE_IMAGES,
                LARGE_W, LARGE_H, "TEST.QUANT", mode), card, QUANT_LARGE_IMAGES, LARGE_W,
            LARGE_H)
        large[mode] = ms
    large["forward_1"] = _quant_forward("quant_deeplab_large", tester, tester._qctx, 1,
                                        LARGE_W, LARGE_H)
    auto = resolve_mode("auto", area=LARGE_W * LARGE_H, max_area=cfg.TEST.QUANT_MAX_AREA,
                        device=tester.device)
    log(f"[quant_deeplab] at {LARGE_W}x{LARGE_H} on {card}: float32 {large['none']:.1f} "
        f"ms/image, int8 {large['int8']:.1f} ms/image (eval loop); TEST.QUANT auto resolves "
        f"to {auto!r} there (QUANT_MAX_AREA {cfg.TEST.QUANT_MAX_AREA} < "
        f"{LARGE_W * LARGE_H} pixels)")
    if auto != "none":
        raise AssertionError(f"auto at {LARGE_W}x{LARGE_H} resolved to {auto}")
    MEASURED["quant_deeplab"]["large"] = large
    return _check_no_kernel("quant_deeplab")


def phase_quant_gald(tmp: str, card: str) -> int:
    """GALD (HarDNet68 + GCPA-CC, 19 classes, seeded) served at 1024x512
    under TEST.QUANT int8: 16 requests; kernel #1 launches twice a forward,
    the calibrating forward and the two of the agreement check on the first
    batch included; masks against the Tester's int8 forward, agreement with
    float32 printed."""
    from rnd_semantic_segmentation_torch.serve.quant import quant_scope

    pth = os.path.join(tmp, "quant_gald", "Gald-seeded.pth")
    os.makedirs(os.path.dirname(pth), exist_ok=True)
    args = build_parser().parse_args([
        "--max-batch", str(MAX_BATCH), "MODEL.NAME", "gald_hardnet68",
        "MODEL.NUM_CLASSES", "19", "INPUT.INPUT_SIZE_TEST", f"({SERVE_W}, {SERVE_H})",
        "AUG.NAME", "gald", *FLOAT32, "OUTPUT_DIR", tmp, "resume", pth, "TEST.QUANT", "int8"])
    cfg = load_cfg(args)
    _seeded_checkpoint("quant_gald", cfg, pth)
    render = load_json(os.path.join(HERE, "renders", "cityscapes.json"))
    inf, bodies, masks, batches, launches, wall = serve_traffic(
        "quant_gald", cfg, args, render, SERVE_W, SERVE_H, card, (ccattn, "KERNEL_LAUNCHES"))
    forwards = batches + 3  # the served batches; calibration; the agreement's two
    if inf.quant_state() != "int8" or launches != 2 * forwards:
        raise AssertionError(f"quant_gald: {inf.quant_state()}, cc_attention_fwd launched "
                             f"{launches} times; want 2 x {forwards} forwards")
    log(f"[quant_gald] cc_attention_fwd launches: {launches} = 2 x ({batches} batches + 1 "
        f"calibrating forward + 2 agreement forwards); "
        f"{len(inf._qctx.act_scales)} convs quantized")
    with quant_scope(inf._qctx):
        x = serve_breakdown("quant_gald", inf, bodies, masks, SERVE_W, SERVE_H, batches, wall,
                            card)
        _check_agreement("quant_gald", "the Tester's int8 forward",
                         inf.tester._probs_impl(x, (SERVE_H, SERVE_W)), masks,
                         MIN_QUANT_MASK_AGREEMENT)
    float_pred = inf.tester._probs_impl(x, (SERVE_H, SERVE_W)).argmax(1).cpu().numpy()
    agreement = float((float_pred == np.stack(masks[:MAX_BATCH])).mean())
    log(f"[quant_gald] served int8 masks against the float32 forward: argmax agreement "
        f"{agreement:.6f}")
    MEASURED["quant_gald"] = _quant_forward("quant_gald", inf.tester, inf._qctx, MAX_BATCH,
                                            SERVE_W, SERVE_H)
    return launches


def phase_quant_attn(tmp: str, card: str) -> int:
    """attn B2 (configs/attn_src_kvasir.yaml, seeded) at 512x512 with
    MODEL.FUSED_MBCONV on, 32 images in batches of 8 under TEST.QUANT int8
    through ``Tester.test()``: kernel #3 launches 17 times a forward, over
    the calibrating forwards (2), the agreement's (2) and the eval's (4)."""
    pth = os.path.join(tmp, "quant_attn", "Attn-seeded.pth")
    os.makedirs(os.path.dirname(pth), exist_ok=True)
    opts = _attn_opts(os.path.join(tmp, "quant_attn"), pth, "DATASETS.TEST", "synthetic_val",
                      "DATASETS.SYNTHETIC_LENGTH", str(ATTN_EVAL_IMAGES),
                      "TEST.BATCH_SIZE", str(ATTN_BATCH), "MODEL.FUSED_MBCONV", "True",
                      "TEST.QUANT", "int8")
    cfg = load_cfg(test_cli.build_parser().parse_args(opts))
    _check_attn_geometry(cfg)
    _seeded_checkpoint("quant_attn", cfg, pth)
    forwards = []
    mbconv.KERNEL_LAUNCHES = 0
    tester, _, ms = _quant_eval(
        "quant_attn", tmp, opts, card, ATTN_EVAL_IMAGES, ATTN_SIZE, ATTN_SIZE,
        on_tester=lambda t: t.segmentor.register_forward_hook(
            lambda mod, inp, out: forwards.append(tuple(inp[0].shape))))
    launches = mbconv.KERNEL_LAUNCHES
    want = 2 + 2 + ATTN_EVAL_IMAGES // ATTN_BATCH
    if len(forwards) != want or launches != MBCONV_LAUNCHES_PER_FORWARD * want:
        raise AssertionError(f"quant_attn: {len(forwards)} forwards (want {want}), "
                             f"fused_mbconv_fwd launched {launches} times")
    log(f"[quant_attn] fused_mbconv_fwd launches: {launches} = {MBCONV_LAUNCHES_PER_FORWARD} "
        f"x {want} forwards (2 calibrating, 2 for the agreement, "
        f"{ATTN_EVAL_IMAGES // ATTN_BATCH} evaluating); eval loop {ms:.1f} ms/image")
    MEASURED["quant_attn"] = _quant_forward("quant_attn", tester, tester._qctx, ATTN_BATCH,
                                            ATTN_SIZE, ATTN_SIZE)
    MEASURED["quant_attn"]["eval_ms"] = ms
    return launches


# loads every exported program in a fresh process, runs it on the saved
# batch, and reports class ids, ms of a call, kernel launches a call and the
# operators in its graph
_LOAD_EXPORTED = """
import json, sys, time
import numpy as np, torch
from rnd_semantic_segmentation_torch.ops import ccattn, mbconv
from rnd_semantic_segmentation_torch.serve.export import load_exported
report = {}
for name, prefix, images in json.loads(sys.argv[1]):
    call, meta = load_exported(prefix)
    x = np.load(images)
    ids = call(x)
    ccattn.KERNEL_LAUNCHES = mbconv.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(5):
        call(x)
    ms = (time.perf_counter() - t0) / 5 * 1e3
    graph = str(torch.export.load(prefix + ".pt2").graph)
    np.save(prefix + "_ids.npy", ids)
    report[name] = {"ms": ms, "cc_launches": ccattn.KERNEL_LAUNCHES / 5,
                    "mbconv_launches": mbconv.KERNEL_LAUNCHES / 5,
                    "int_mm": graph.count("aten._int_mm"),
                    "cc_op": graph.count("rnd_seg_torch.cc_attention_fwd"),
                    "mbconv_op": graph.count("rnd_seg_torch.fused_mbconv_fwd")}
print(json.dumps(report))
"""


def phase_export(tmp: str, card: str) -> dict:
    """``serve.export.export_eval`` at batch 2: DeepLab-R101 at 1024x512 in
    float32 and int8, GALD at 1024x512 and attn B2 at 512x512 with
    MODEL.FUSED_MBCONV, float32; written to the run's tmp directory (each
    artifact holds its weights), loaded back in one fresh process, whose
    class ids must equal the Tester's on the same batch; the GALD program
    holds kernel #1's operator and launches it twice a call, the attn program
    #3's and launches it 17 times."""
    from rnd_semantic_segmentation_torch.serve.export import export_eval
    from rnd_semantic_segmentation_torch.serve.quant import quant_scope

    deeplab = _quant_deeplab_checkpoint(tmp)
    gald = os.path.join(tmp, "export", "Gald-seeded.pth")
    attn = os.path.join(tmp, "export", "Attn-seeded.pth")
    out_dir = os.path.join(tmp, "export")
    os.makedirs(out_dir, exist_ok=True)
    jobs = [("deeplab_float32", _quant_deeplab_opts(out_dir, deeplab, 2, SERVE_W, SERVE_H,
                                                    "TEST.BATCH_SIZE", "2"), SERVE_W, SERVE_H),
            ("deeplab_int8", _quant_deeplab_opts(out_dir, deeplab, 2, SERVE_W, SERVE_H,
                                                 "TEST.BATCH_SIZE", "2", "TEST.QUANT", "int8"),
             SERVE_W, SERVE_H),
            ("gald_float32", ["-c", os.path.join(HERE, "renders", "cityscapes.json"),
                              "MODEL.NAME", "gald_hardnet68", "MODEL.NUM_CLASSES", "19",
                              "INPUT.INPUT_SIZE_TEST", f"({SERVE_W}, {SERVE_H})",
                              "AUG.NAME", "gald", *FLOAT32, "DATASETS.TEST", "synthetic_val",
                              "DATASETS.SYNTHETIC_LENGTH", "2", "OUTPUT_DIR", out_dir,
                              "resume", gald], SERVE_W, SERVE_H),
            ("attn_float32", _attn_opts(out_dir, attn, "DATASETS.TEST", "synthetic_val",
                                        "DATASETS.SYNTHETIC_LENGTH", "2",
                                        "MODEL.FUSED_MBCONV", "True"), ATTN_SIZE, ATTN_SIZE)]
    programs, want, exported = [], {}, {}
    for name, opts, w, h in jobs:
        args = test_cli.build_parser().parse_args(opts)
        cfg = load_cfg(args)
        if not os.path.exists(cfg.resume):
            _seeded_checkpoint("export", cfg, cfg.resume)
        tester = test_cli.make_tester(cfg, load_json(args.config_path),
                                      logger=_stderr_logger("chip_smoke.export"))
        qctx = tester.make_quant_context()
        prefix = os.path.join(out_dir, name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = export_eval(tester, EXPORT_BATCH, prefix, quant_ctx=qctx)
        export_s = time.perf_counter() - t0
        images = np.random.RandomState(5).rand(EXPORT_BATCH, h, w, 3).astype(np.float32)
        np.save(prefix + "_images.npy", images)
        x = torch.from_numpy(images).to(tester.device).permute(0, 3, 1, 2).contiguous()
        with quant_scope(qctx):
            want[name] = tester._probs_impl(x, (h, w)).argmax(1).cpu().numpy()
            tester_ms = host_ms(lambda: tester._probs_impl(x, (h, w)).argmax(1).cpu())
        exported[name] = {"quant": meta["quant"], "bytes": meta["bytes"],
                          "export_s": export_s, "tester_ms": tester_ms}
        programs.append((name, prefix, prefix + "_images.npy"))
        del tester
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _LOAD_EXPORTED, json.dumps(programs)],
                          capture_output=True, text=True, timeout=600, cwd=HERE)
    if proc.returncode != 0:
        raise RuntimeError(f"loading the exported programs failed:\n{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    load_s = time.perf_counter() - t0
    for name, prefix, _ in programs:
        got = np.load(prefix + "_ids.npy")
        r = {**exported[name], **report[name]}
        exported[name] = r
        log(f"[export] {name} on {card}: {r['bytes'] / 1e6:.1f} MB, quant {r['quant']}, "
            f"exported in {r['export_s']:.1f} s; a call of {EXPORT_BATCH} in a fresh process "
            f"{r['ms']:.1f} ms (host clock, numpy in and out) against the Tester's "
            f"{r['tester_ms']:.1f} ms; aten._int_mm x{r['int_mm']}, cc_attention_fwd op "
            f"x{r['cc_op']} ({r['cc_launches']:g} launches a call), fused_mbconv_fwd op "
            f"x{r['mbconv_op']} ({r['mbconv_launches']:g} launches a call)")
        if not np.array_equal(got, want[name]):
            raise AssertionError(f"[export] {name}: the program's class ids differ from the "
                                 f"Tester's on {(got != want[name]).mean():.2e} of pixels")
    if (exported["deeplab_int8"]["int_mm"] == 0 or exported["gald_float32"]["cc_op"] == 0
            or exported["attn_float32"]["mbconv_op"] == 0
            or exported["gald_float32"]["cc_launches"] != 2
            or exported["attn_float32"]["mbconv_launches"] != MBCONV_LAUNCHES_PER_FORWARD):
        raise AssertionError(f"[export] an operator or its launches are missing: {exported}")
    log(f"[export] the fresh process took {load_s:.1f} s for the four programs")
    MEASURED["export"] = exported
    return exported


def phase_inference_cli(tmp: str, card: str) -> int:
    """``cli.inference`` on a 1024x512 PNG against the seeded DeepLab
    checkpoint (its palette PNG's indices must equal the Tester's argmax),
    ``cli.demo`` with two checkpoint columns and ground truth (grid, PR
    curves, image events) and ``cli.visualize`` over a chart JSON, all drawn
    with Pillow on the card's machine.  No hand kernel lies on this path."""
    from PIL import Image

    from rnd_semantic_segmentation_torch.cli import demo, inference, visualize

    pth = _quant_deeplab_checkpoint(tmp)
    out_dir = os.path.join(tmp, "inference_cli")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(6)
    image = os.path.join(out_dir, "image.png")
    Image.fromarray((rng.rand(SERVE_H, SERVE_W, 3) * 255).astype(np.uint8)).save(image)
    render = os.path.join(HERE, "renders", "cityscapes.json")
    opts = _deeplab_opts(out_dir, "resume", pth)
    _zero_kernel_counts()
    t0 = time.perf_counter()
    inference.cli(["-i", image, "-o", os.path.join(out_dir, "pred.png"), "-c", render] + opts)
    cli_s = time.perf_counter() - t0
    got = np.asarray(Image.open(os.path.join(out_dir, "pred.png")))
    args = test_cli.build_parser().parse_args(["-c", render] + opts)
    tester = Tester(load_cfg(args), _stderr_logger("chip_smoke.inference_cli"))
    tester._load_checkpoint()
    from rnd_semantic_segmentation_torch.data.augment import Augmenter
    from rnd_semantic_segmentation_torch.data.loader import preprocess_eval_image
    img = preprocess_eval_image(Image.open(image).convert("RGB"),
                                Augmenter(tester.cfg, mode="test", is_source=False)
                                .build_transform())
    x = torch.from_numpy(img[None]).to(tester.device).permute(0, 3, 1, 2).contiguous()
    want = tester._probs_impl(x, (SERVE_H, SERVE_W)).argmax(1)[0].cpu().numpy()
    log(f"[inference_cli] on {card}: cli.inference wrote a {got.shape[1]}x{got.shape[0]} "
        f"palette PNG in {cli_s:.1f} s (model build, checkpoint load, one forward); "
        f"{len(np.unique(got))} classes; equal to the Tester's argmax: "
        f"{np.array_equal(got, want)}")
    if not np.array_equal(got, want):
        raise AssertionError("cli.inference's PNG differs from the Tester's argmax")
    del tester

    second = os.path.join(out_dir, "Aspp-seeded-1.pth")
    cfg = load_cfg(train_src.build_parser().parse_args(_deeplab_opts(tmp)))
    spec = build_segmentor(cfg)
    randomize_weights_(torch.nn.ModuleDict(spec.modules), seed=1)
    save_reference_checkpoint(spec.modules, second)
    gt = os.path.join(out_dir, "gt.png")
    Image.fromarray(rng.randint(0, 19, (SERVE_H, SERVE_W)).astype(np.uint8)).save(gt)
    with open(os.path.join(out_dir, "images.txt"), "w") as f:
        f.write(image + "\n")
    with open(os.path.join(out_dir, "gts.txt"), "w") as f:
        f.write(gt + "\n")
    demo_render = {**load_json(render), "demo_image_path": os.path.join(out_dir, "images.txt"),
                   "demo_groundtruth_path": os.path.join(out_dir, "gts.txt"),
                   "weights": {"seed0": pth, "seed1": second}, "tensorboard": True}
    with open(os.path.join(out_dir, "demo.json"), "w") as f:
        json.dump(demo_render, f)
    t0 = time.perf_counter()
    preds = demo.cli(["-c", os.path.join(out_dir, "demo.json"), "-o",
                      os.path.join(out_dir, "grid.png"), "-n", "1"] + opts)
    demo_s = time.perf_counter() - t0
    grid = Image.open(os.path.join(out_dir, "grid.png"))
    curves = [load_json(os.path.join(out_dir, "pr_curves", k, "pr_curves.json"))
              for k in ("seed0", "seed1")]
    events = os.listdir(os.path.join(out_dir, "tb_demo"))
    if (not np.array_equal(preds["seed0", 0], got) or len(curves[0]) != 19
            or len(events) != 1):
        raise AssertionError(f"cli.demo: column seed0 {np.array_equal(preds['seed0', 0], got)},"
                             f" {len(curves[0])} PR curves, events {events}")
    chart = os.path.join(tmp, "train", "gald_chart_params.json")
    if not os.path.exists(chart):
        chart = os.path.join(out_dir, "deeplab_chart_params.json")
        with open(chart, "w") as f:
            json.dump({"loss": list(np.linspace(3, 1, 50)), "learning rate": [2.5e-4] * 50}, f)
    visualize.cli(["-j", chart, "-o", os.path.join(out_dir, "curves.png"), "-w", "5"])
    curves_png = Image.open(os.path.join(out_dir, "curves.png"))
    log(f"[inference_cli] cli.demo in {demo_s:.1f} s: a {grid.size[0]}x{grid.size[1]} grid "
        f"(image, ground truth, two checkpoint columns), PR curves of 19 classes per column, "
        f"{events[0]}; cli.visualize: a {curves_png.size[0]}x{curves_png.size[1]} figure of "
        f"{os.path.basename(chart)}")
    return _check_no_kernel("inference_cli")



# -- data parallelism, async checkpoints, the native decoder, the TPU recipes --------

DIST_DEEPLAB_STEPS = 4
# the world of two on one card: GALD at 1024x512, 2 images a rank, 3 steps,
# float32 (TF32 off), against one process taking all 4
DIST_GALD_GEOMETRY = ((SERVE_W, SERVE_H), 4, 3)
# tolerances stated before the first run: the losses of the world of two
# against the one process 1e-3 relative at the first step and 1e-2 after
# three; the weights' displacement over all leaves 5e-2 of its norm (Adam
# moves an element whose gradient is rounding noise by a whole lr); the
# BatchNorm running statistics 1e-2 of their magnitude.  Train-mode GALD is
# badly conditioned (its float32 and float64 gradients differ by up to 26%
# of a leaf), and the ranks' BatchNorm takes its variance as E[x^2] - E[x]^2.
# The first run on the card met the losses (3.4e-7 and 4.9e-4) but not the
# weights (1.4e-1) or the statistics (9.5e-2): so the weights and statistics
# are also held to what rounding alone does to this run, the one process
# against itself with its images scaled by 1 + 2^-20 (PERTURB), at
# DIST_GALD_NOISE_FACTOR times that
DIST_GALD_TOLERANCE = {"first_loss": 1e-3, "loss": 1e-2, "weights": 5e-2, "stats": 1e-2}
PERTURB = 1.0 + 2.0 ** -20
DIST_GALD_NOISE_FACTOR = 3.0
DIST_DEEPLAB_LOSS_TOLERANCE = 1e-2   # bfloat16, cuDNN's nondeterministic reductions
DIST_EVAL_IMAGES = 11                 # two ranks leave one out under process_shard
DIST_WORLD_TIMEOUT_S = 300
ASYNC_EPOCHS, ASYNC_STEPS = 3, 2
RECIPES = ("attn_src_kvasir_tpu.yaml", "deeplabv2_r101_src_kvasir_tpu.yaml",
           "gald_src_tpu.yaml", "pranet_src_polyp_tpu.yaml")
# polyp items: the attn recipe's batch of 128 needs 256 for two batches
RECIPE_POLYP_ITEMS = 256
# deeplabv2_r101_src_kvasir_tpu.yaml reads kvasir_train, whose frames go to
# the collate at their own sizes (DEVICE_AUG's host stub crops nothing at
# INPUT_SCALES_TRAIN (1, 1)): frames of two sizes cannot be batched, in either
# package (ROADMAP Queue 3), so its tree holds frames of one Kvasir-SEG size
RECIPE_KVASIR_FRAME = (1280, 1024)


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_world(case: str, out_dir: str, *args: str, world: int = 2) -> list:
    """``world`` processes of this script (``--dist-worker``), each a rank of a
    gloo group on the one card (NCCL takes one rank a device); each writes
    its results to ``<out_dir>/<case>_rank<r>.json``.  Every process is
    killed when the world outlives DIST_WORLD_TIMEOUT_S, and a rank that
    fails raises here with its output."""
    os.makedirs(out_dir, exist_ok=True)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-worker",
                               case, str(r), str(world), port, out_dir, *args],
                              cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    deadline = time.monotonic() + DIST_WORLD_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines()[-8:]:
            log(f"[{case} rank {r}] {line}")
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of the {case} world exited {p.returncode}:\n"
                               f"{out[-6000:]}")
    return [load_json(os.path.join(out_dir, f"{case}_rank{r}.json")) for r in range(world)]


def _gald_dist_opts(out_dir: str, *more):
    (w, h), batch, steps = DIST_GALD_GEOMETRY
    return ["-cfg", os.path.join(HERE, "configs", "gald_src.yaml"),
            "DATASETS.SOURCE_TRAIN", "synthetic_train", "INPUT.SOURCE_INPUT_SIZE_TRAIN",
            f"({w}, {h})", "SOLVER.BATCH_SIZE", str(batch), "DATASETS.SYNTHETIC_LENGTH",
            str(batch * steps), "SOLVER.EPOCHS", "1", "SOLVER.CHECKPOINT_PERIOD", "5",
            *FLOAT32, "OUTPUT_DIR", out_dir, *more]


def _gald_dist_run(out_dir: str, *more, scale: float = 1.0):
    """The GALD trainer of ``_gald_dist_opts`` from seed 0, trained with the
    kernel counts set to 0 just before, its images times ``scale``:
    (trainer, counts, peak MiB)."""
    cfg = load_cfg(train_src.build_parser().parse_args(_gald_dist_opts(out_dir, *more)))
    trainer = train_src.make_trainer("gald", cfg, logger=_stderr_logger("chip_smoke.dist_gald"))
    randomize_weights_(trainer.segmentor, seed=0)
    if scale != 1.0:
        step = trainer.step_fn
        trainer.step_fn = lambda batch, epoch0: step(
            {**batch, "image": batch["image"] * scale}, epoch0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_kernel_counts()
    trainer.train()
    torch.cuda.synchronize()
    counts = [getattr(m, n) for m, n in KERNEL_COUNTERS]
    return trainer, counts, torch.cuda.max_memory_allocated() / 2 ** 20


def worker_gald(rank: int, out_dir: str) -> dict:
    trainer, counts, peak = _gald_dist_run(os.path.join(out_dir, f"rank{rank}"),
                                           "DIST.INITIALIZE", "True")
    torch.save({k: v.detach().cpu() for k, v in trainer.segmentor.state_dict().items()},
               os.path.join(out_dir, f"gald_rank{rank}.pth"))
    return {"losses": list(trainer.loss_data), "counts": counts, "peak_mib": peak,
            "step_ms": float(np.median(trainer.meters.meters["time"].series[1:])) * 1e3,
            "local_batch": len(next(iter(trainer.train_loader))["name"])}


def _dist_eval_opts(out_dir: str, pth: str, images: int, *more):
    return _deeplab_opts(out_dir, "DATASETS.SYNTHETIC_LENGTH", str(images),
                         "TEST.BATCH_SIZE", "4", "resume", pth, *more)


def worker_eval(rank: int, out_dir: str, pth: str) -> dict:
    """``cli.test``'s Tester on DIST_EVAL_IMAGES images in the world, then
    again under TEST.QUANT int8."""
    out = {}
    render = load_json(os.path.join(HERE, "renders", "cityscapes.json"))
    for tag, quant in (("float32", "none"), ("int8", "int8")):
        args = test_cli.build_parser().parse_args(["-c", "renders/cityscapes.json"] + _dist_eval_opts(
            os.path.join(out_dir, tag), pth, DIST_EVAL_IMAGES, "DIST.INITIALIZE", "True",
            "TEST.QUANT", quant))
        tester = test_cli.make_tester(load_cfg(args), render)
        t0 = time.perf_counter()
        summary = tester.test()
        out[tag] = {"summary": summary, "confusion": np.asarray(tester.confusion).tolist(),
                    "report": getattr(tester, "quant_report", {}),
                    "seconds": time.perf_counter() - t0,
                    "images": len(tester.test_loader.dataset) // 2}
        tester.test_loader.close()
    return out


def dist_worker(argv) -> int:
    """One rank of ``_run_world``: a gloo group on the card, the case, its
    results as JSON.  Prints no result line."""
    case, rank, world, port, out_dir, *args = argv
    rank, world = int(rank), int(world)
    import torch.distributed as dist

    resolve_device("cuda")
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        result = {"gald": worker_gald, "eval": worker_eval}[case](rank, out_dir, *args)
        with open(os.path.join(out_dir, f"{case}_rank{rank}.json"), "w") as f:
            json.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def phase_dist_deeplab(tmp: str, card: str) -> dict:
    """configs/deeplabv2_r101_src.yaml in bfloat16, 4 steps of 6 at 1280x720
    through ``cli.train_src``, without DIST and then with DIST.INITIALIZE in
    a world of one over NCCL (the ``env://`` variables set here, the group
    ended after): the loss series within DIST_DEEPLAB_LOSS_TOLERANCE, ms a
    step and peak memory of each."""
    import torch.distributed as dist

    from rnd_semantic_segmentation_torch.parallel import world_size

    runs = {}
    for tag, more in (("plain", ()), ("dist", ("DIST.INITIALIZE", "True"))):
        env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(_free_port())} if more else {}
        with mock.patch.dict(os.environ, env):
            trainer = _synthetic_trainer(f"dist_deeplab_{tag}", tmp, "deeplabv2_r101_src.yaml",
                                         "deeplab", DIST_DEEPLAB_STEPS, "MODEL.DTYPE",
                                         "bfloat16", *more)
            try:
                if more and not (dist.is_initialized() and dist.get_backend() == "nccl"
                                 and world_size() == 1):
                    raise AssertionError("DIST.INITIALIZE started no NCCL world of one")
                runs[tag] = _timed_train(f"dist_deeplab_{tag}", trainer, card)
            finally:
                if dist.is_initialized():
                    dist.destroy_process_group()
        _check_no_kernel(f"dist_deeplab_{tag}")
    plain, dist_ = runs["plain"], runs["dist"]
    err = max(abs(a - b) / abs(b) for a, b in zip(dist_["losses"], plain["losses"]))
    log(f"[dist_deeplab] on {card}: NCCL world of one {dist_['ms']:.1f} ms a step, peak "
        f"{dist_['peak_mib']:.0f} MiB; without DIST {plain['ms']:.1f} ms, "
        f"{plain['peak_mib']:.0f} MiB; the losses agree to {err:.2e} relative "
        f"(tolerance {DIST_DEEPLAB_LOSS_TOLERANCE})")
    if err > DIST_DEEPLAB_LOSS_TOLERANCE:
        raise AssertionError(f"the loss series differ by {err:.2e}")
    MEASURED["dist_deeplab"] = {k: (v["ms"], v["peak_mib"]) for k, v in runs.items()}
    return runs


def phase_dist_gald_2rank(tmp: str, card: str):
    """Two processes on the one card over gloo (``_run_world``), each a rank
    of ``cli.train_src``'s GALD trainer with DIST.INITIALIZE, 2 images at
    1024x512 a rank for 3 steps, against this process taking all 4: the
    losses, the weights and the BatchNorm buffers after 3 steps within
    DIST_GALD_TOLERANCE; kernels #1 and #2 launch twice a step in each rank.
    Returns the launches of #1 and #2 over both ranks."""
    out_dir = os.path.join(tmp, "dist_gald_2rank")
    t0 = time.perf_counter()
    ranks = _run_world("gald", out_dir)
    world_s = time.perf_counter() - t0
    one, counts, peak = _gald_dist_run(os.path.join(out_dir, "one"))
    (_, _), batch, steps = DIST_GALD_GEOMETRY
    want = {n: v.detach().cpu() for n, v in one.segmentor.state_dict().items()}
    nudged = {n: v.detach().cpu() for n, v in _gald_dist_run(
        os.path.join(out_dir, "nudged"), scale=PERTURB)[0].segmentor.state_dict().items()}
    start = Segmentor(build_segmentor(one.cfg), one.cfg.MODEL.NUM_CLASSES)
    randomize_weights_(start, seed=0)
    start = start.state_dict()
    got = [torch.load(os.path.join(out_dir, f"gald_rank{r}.pth"), weights_only=True)
           for r in range(2)]
    for name in want:
        if not torch.equal(got[0][name], got[1][name]):
            raise AssertionError(f"the ranks hold different {name}")
    params = [n for n, _ in one.segmentor.named_parameters()]

    def apart(state):
        """(displacement error over all leaves, worst running statistic) of
        ``state`` against the one process."""
        disp = _global_rel({n: state[n] - start[n] for n in params},
                           {n: want[n] - start[n] for n in params})
        stats = max((state[n] - v).abs().max().item() / max(v.abs().max().item(), 1e-12)
                    for n, v in want.items() if "running" in n)
        return disp, stats

    disp, stats = apart(got[0])
    noise_disp, noise_stats = apart(nudged)
    losses = [r["losses"] for r in ranks]
    first = abs(losses[0][0] - one.loss_data[0]) / abs(one.loss_data[0])
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses[0], one.loss_data))
    fwd = sum(r["counts"][0] for r in ranks)
    bwd = sum(r["counts"][1] for r in ranks)
    log(f"[dist_gald_2rank] on {card}: 2 ranks over gloo, {ranks[0]['local_batch']} images "
        f"a rank at {DIST_GALD_GEOMETRY[0][0]}x{DIST_GALD_GEOMETRY[0][1]}, {steps} steps "
        f"({world_s:.1f} s for the world, start-up included); a rank "
        f"{ranks[0]['step_ms']:.1f} ms a step, peak {ranks[0]['peak_mib']:.0f} MiB; one "
        f"process of {batch}: {float(np.median(one.meters.meters['time'].series[1:])) * 1e3:.1f}"
        f" ms a step, peak {peak:.0f} MiB; losses {[round(v, 5) for v in losses[0]]} against "
        f"{[round(v, 5) for v in one.loss_data]} (first {first:.2e}, worst {worst:.2e}); "
        f"weights' displacement {disp:.2e} of its norm, BatchNorm statistics {stats:.2e} "
        f"(the one process against itself with its images times 1 + 2^-20: {noise_disp:.2e}, "
        f"{noise_stats:.2e}); "
        f"launches per rank (cc fwd, cc bwd, mbconv) {[r['counts'] for r in ranks]}, one "
        f"process {counts}")
    tol = DIST_GALD_TOLERANCE
    factor = DIST_GALD_NOISE_FACTOR
    if (losses[0] != losses[1] or first > tol["first_loss"] or worst > tol["loss"]
            or disp > max(tol["weights"], factor * noise_disp)
            or stats > max(tol["stats"], factor * noise_stats)):
        raise AssertionError("the world of two disagrees with the one process beyond "
                             f"{DIST_GALD_TOLERANCE} and {factor} times rounding's effect")
    if any(r["counts"][:2] != [2 * steps, 2 * steps] or r["counts"][2] for r in ranks):
        raise AssertionError("kernels #1 and #2 must launch twice a step in each rank")
    MEASURED["dist_gald_2rank"] = {"rank_ms": ranks[0]["step_ms"], "disp": disp,
                                   "noise": noise_disp}
    return fwd, bwd


def phase_dist_eval(tmp: str, card: str) -> int:
    """``cli.test`` with two ranks on the card over gloo against this process
    on the same first 10 of DIST_EVAL_IMAGES synthetic images (the
    DeepLab-R101 checkpoint at 1024x512, TEST.BATCH_SIZE 4: each rank's last
    batch is short): the confusion matrices agree on MIN_MASK_AGREEMENT of
    the pixels and the micro mIoU within 1e-3 (the CPU test holds them
    equal), image 10 left out and named in the log; TEST.QUANT int8 under
    two ranks runs in float32 with the reason ``multiprocess``."""
    pth = _deeplab_checkpoint(tmp)
    out_dir = os.path.join(tmp, "dist_eval")
    _zero_kernel_counts()
    ranks = _run_world("eval", out_dir, pth)
    args = test_cli.build_parser().parse_args(
        ["-c", "renders/cityscapes.json"] + _dist_eval_opts(os.path.join(out_dir, "one"), pth,
                                                             DIST_EVAL_IMAGES - 1))
    tester = test_cli.make_tester(load_cfg(args), load_json(os.path.join(
        HERE, "renders", "cityscapes.json")), logger=_stderr_logger("chip_smoke.dist_eval"))
    t0 = time.perf_counter()
    summary = tester.test()
    one_s = time.perf_counter() - t0
    tester.test_loader.close()
    log_path = os.path.join(out_dir, "float32", "aspp_cityscapes_test.txt")
    left = [line for line in open(log_path) if "leaves out" in line] if os.path.exists(
        log_path) else []
    f32, q = ranks[0]["float32"], ranks[0]["int8"]
    # the ranks forward 2 images a batch, the one process 4: cuDNN sums in
    # another order at another batch size, which moves near-tied pixels (the
    # CPU test holds the two equal); so the pixels counted alike, as the
    # served masks are held (MIN_MASK_AGREEMENT)
    one_cmt = np.asarray(tester.confusion)
    agreement = [1.0 - np.abs(np.asarray(r["float32"]["confusion"]) - one_cmt).sum()
                 / (2.0 * one_cmt.sum()) for r in ranks]
    miou_gap = abs(f32["summary"]["micro_miou"] - summary["micro_miou"])
    log(f"[dist_eval] on {card}: 2 ranks over gloo, {f32['images']} images a rank, "
        f"{f32['seconds']:.1f} s for a rank's pass; one process on the same "
        f"{DIST_EVAL_IMAGES - 1}: {one_s:.1f} s; confusion matrices agree on "
        f"{min(agreement):.6f} of the pixels ({int(one_cmt.sum())}), micro mIoU "
        f"{f32['summary']['micro_miou']:.5f} against {summary['micro_miou']:.5f}; log: "
        f"{left[0].strip() if left else 'no line'}; TEST.QUANT int8 over 2 ranks: "
        f"{q['report']}")
    if (ranks[0]["float32"]["confusion"] != ranks[1]["float32"]["confusion"]
            or min(agreement) < MIN_MASK_AGREEMENT or miou_gap > 1e-3):
        raise AssertionError("the two-rank eval differs from one process")
    if not left or "synthetic_00010" not in left[0]:
        raise AssertionError("the image left out is not named in the log")
    if q["report"].get("reason") != "multiprocess" or q["report"].get("mode") != "none" \
            or q["confusion"] != f32["confusion"]:
        raise AssertionError(f"TEST.QUANT int8 under two ranks: {q['report']}")
    return _check_no_kernel("dist_eval")


def phase_async_ckpt(tmp: str, card: str) -> dict:
    """configs/deeplabv2_r101_src.yaml in bfloat16, CHECKPOINT_PERIOD 1, 3
    epochs of 2 steps of 6 at 1280x720, KEEP_CHECKPOINTS 2, with the file
    written in the step's thread and then by the background writer: ms the
    loop waited at each save and the bytes written; only the last 2 files
    remain; the last background file loads equal to a synchronous save of
    the same state; ``resume latest`` waits for a write in flight."""
    from rnd_semantic_segmentation_torch.ckpt.async_writer import AsyncCheckpointWriter
    from rnd_semantic_segmentation_torch.ckpt.checkpoint_io import save_checkpoint

    runs = {}
    for mode in ("False", "True"):
        tag = f"async_ckpt_{'async' if mode == 'True' else 'sync'}"
        trainer = _synthetic_trainer(tag, tmp, "deeplabv2_r101_src.yaml", "deeplab",
                                     ASYNC_STEPS, "MODEL.DTYPE", "bfloat16",
                                     "SOLVER.EPOCHS", str(ASYNC_EPOCHS),
                                     "SOLVER.CHECKPOINT_PERIOD", "1",
                                     "SOLVER.KEEP_CHECKPOINTS", "2",
                                     "SOLVER.ASYNC_CHECKPOINT", mode)
        _zero_kernel_counts()
        t0 = time.perf_counter()
        trainer.train()
        seconds = time.perf_counter() - t0
        _check_no_kernel(tag)
        out = trainer.cfg.OUTPUT_DIR
        files = sorted(f for f in os.listdir(out) if f.endswith(".pth"))
        sizes = [os.path.getsize(os.path.join(out, f)) for f in files]
        runs[mode] = trainer
        log(f"[async_ckpt] {tag} on {card}: the loop waited "
            f"{[round(ms, 1) for ms in trainer.save_blocked_ms]} ms at its 3 saves; "
            f"{seconds:.1f} s for the run; files {files}, {sizes} bytes")
        if files != ["Aspp-2.pth", "Aspp-3.pth"]:
            raise AssertionError(f"{tag}: {files} remain, want the last 2")
    trainer = runs["True"]
    out = trainer.cfg.OUTPUT_DIR
    sync = save_checkpoint(os.path.join(out, "sync-3.pth.ref"), trainer.ckpt_modules,
                           trainer.state, ASYNC_EPOCHS)
    a = torch.load(os.path.join(out, "Aspp-3.pth"), map_location="cpu", weights_only=True)
    b = torch.load(sync, map_location="cpu", weights_only=True)
    same = all(torch.equal(a[p][k], b[p][k]) for p in trainer.ckpt_modules for k in b[p])
    writer = AsyncCheckpointWriter()
    save_checkpoint(os.path.join(out, "Aspp-4.pth"), trainer.ckpt_modules, trainer.state, 4,
                    writer=writer)
    t0 = time.perf_counter()
    resumed = train_src.make_trainer("deeplab", load_cfg(train_src.build_parser().parse_args(
        ["-cfg", os.path.join(HERE, "configs", "deeplabv2_r101_src.yaml"),
         "DATASETS.SOURCE_TRAIN", "synthetic_train", "DATASETS.SYNTHETIC_LENGTH", "6",
         "OUTPUT_DIR", out, "resume", "latest"])), logger=_stderr_logger("chip_smoke.async"))
    resume_s = time.perf_counter() - t0
    writer.close()
    log(f"[async_ckpt] the background Aspp-3.pth loads equal to a synchronous save of the "
        f"same state: {same}; resume latest with Aspp-4.pth in flight: start epoch "
        f"{resumed.start_epoch} after {resume_s:.1f} s (trainer build included)")
    if not same or resumed.start_epoch != 5:
        raise AssertionError("the background file differs, or resume latest did not wait")
    resumed.train_loader.close()
    MEASURED["async_ckpt"] = {m: list(t.save_blocked_ms) for m, t in runs.items()}
    return runs


def phase_native_decode(tmp: str, card: str) -> bool:
    """The native decoder built on this machine (``native/segdata.cpp`` with
    libjpeg and libpng).  Where it builds: ms an item of a GTA5 PNG
    (1914x1052), a Cityscapes PNG and a Kvasir-size JPEG (the BLI images),
    native against PIL on one core, and configs/attn_src_kvasir.yaml with
    DEVICE_AUG and N worker processes with NATIVE_DECODE off and on, one
    epoch of 6 steps of 20 from files each.  Where it does not: the port
    must raise with the compiler's message, from the decoder and from
    ``build_dataset``.  Returns whether the decoder built."""
    from rnd_semantic_segmentation_torch.data import build_dataset, native_decode

    root = _data_root(tmp)
    try:
        native_decode.load_library()
    except RuntimeError as err:
        message = str(err)
        cfg = load_cfg(train_src.build_parser().parse_args(
            ["-cfg", os.path.join(HERE, "configs", "attn_src_kvasir_tpu.yaml"),
             "DATASETS.DATASET_DIR", root]))
        try:
            build_dataset(cfg, "train")
        except RuntimeError as again:
            raised = str(again)
        else:
            raise AssertionError("build_dataset under NATIVE_DECODE did not raise")
        log(f"[native_decode] on {card}: the decoder does not build on this machine; the "
            f"port raises, from the decoder and from build_dataset: "
            f"{' | '.join(message.strip().splitlines()[:3])}")
        if "failed" not in raised and "cannot" not in raised:
            raise AssertionError(f"build_dataset raised without the compiler's message: {raised}")
        MEASURED["native_decode"] = None
        return False
    items = {"gta5 PNG": glob_first(root, "gta5/fold1/images"),
             "cityscapes PNG": glob_first(root, "cityscapes/leftImg8bit/train/aachen"),
             "kvasir-size JPEG": glob_first(root, "BLI/train/images")}
    from PIL import Image
    timings = {}
    for name, path in items.items():
        native_ms = host_ms(lambda: native_decode.decode(path), reps=5)
        pil_ms = host_ms(lambda: np.asarray(Image.open(path).convert("RGB")), reps=5)
        if not np.array_equal(native_decode.decode(path),
                              np.asarray(Image.open(path).convert("RGB"))) and "PNG" in name:
            raise AssertionError(f"{name}: native decode differs from PIL")
        timings[name] = (native_ms, pil_ms)
    log(f"[native_decode] on {card}: ms an item on one core, native against PIL: " + "; ".join(
        f"{k} {a:.1f} vs {b:.1f}" for k, (a, b) in timings.items()))
    results = {}
    for native_on in ("False", "True"):
        out_dir = os.path.join(tmp, f"native_decode_{native_on}")
        cfg = load_cfg(train_src.build_parser().parse_args(
            ["-cfg", os.path.join(HERE, "configs", "attn_src_kvasir.yaml"),
             "DATASETS.DATASET_DIR", root, "SOLVER.EPOCHS", "1", "SOLVER.CHECKPOINT_PERIOD", "5",
             "DATA_PIPE.WORKER_PROCESSES", str(_loader_procs()), "DATA_PIPE.DEVICE_AUG", "True",
             "DATA_PIPE.NATIVE_DECODE", native_on, "OUTPUT_DIR", out_dir]))
        trainer = train_src.make_trainer("attn", cfg, logger=_stderr_logger(
            "chip_smoke.native_decode"))
        try:
            randomize_weights_(trainer.segmentor, seed=0)
            trainer.train()
        finally:
            trainer.train_loader.close()
        step_ms = float(np.median(trainer.meters.meters["time"].series[1:])) * 1e3
        results[native_on] = (cfg.SOLVER.BATCH_SIZE / step_ms * 1e3, _data_share(trainer))
    log(f"[native_decode] attn_src_kvasir.yaml with DEVICE_AUG and {_loader_procs()} worker "
        f"processes from files: NATIVE_DECODE off {results['False'][0]:.2f} images/s, data "
        f"share {results['False'][1]:.1%}; on {results['True'][0]:.2f} images/s, data share "
        f"{results['True'][1]:.1%}")
    MEASURED["native_decode"] = {"items": timings, "attn": results}
    return True


def glob_first(root: str, sub: str) -> str:
    folder = os.path.join(root, sub)
    return os.path.join(folder, sorted(os.listdir(folder))[0])


def phase_recipes_tpu(tmp: str, card: str, native_built: bool = None) -> tuple:
    """Each configs/*_tpu.yaml recipe through its train CLI from files, one
    short epoch, with its async checkpoints, device augmentation, worker
    processes and native decode as written; the overrides are the data
    root, OUTPUT_DIR, SOLVER.EPOCHS 1 and CHECKPOINT_PERIOD 1, the pranet
    readers' size (352 squared, as every PraNet phase: ROADMAP Queue 3),
    DATA_PIPE.NATIVE_DECODE False where the decoder does not build here,
    and MODEL.REMAT_BLOCKS True for a recipe that runs out of memory at its
    batch (its own comment offers it).  The trees: 256 + 8 Kvasir-fold items
    at Kvasir-SEG's sizes (attn, pranet), 24 + 2 Kvasir frames of one size
    (deeplab: RECIPE_KVASIR_FRAME), data_files' GTA5 (gald).  Each reports
    images/s, data share, peak memory and the checkpoint's wait; the GALD
    recipe launches #1 and #2 twice a step.  Returns their launches."""
    from rnd_semantic_segmentation_torch.data import native_decode
    from rnd_semantic_segmentation_torch.data.trees import KVASIR_SIZES

    if native_built is None:
        try:
            native_decode.load_library()
            native_built = True
        except RuntimeError:
            native_built = False
    gta_root = _data_root(tmp)
    polyp_root = os.path.join(tmp, "recipes_polyp")
    frame_root = os.path.join(tmp, "recipes_kvasir")
    t0 = time.perf_counter()
    write_dataset_trees(polyp_root, seed=1,
                        trees={"kvasir": (RECIPE_POLYP_ITEMS, 8, KVASIR_SIZES)})
    write_dataset_trees(frame_root, seed=2, trees={"kvasir": (24, 2, RECIPE_KVASIR_FRAME)})
    log(f"[recipes_tpu] trees written in {time.perf_counter() - t0:.1f} s: "
        f"{RECIPE_POLYP_ITEMS} + 8 Kvasir-fold items at {KVASIR_SIZES}, 24 + 2 Kvasir frames "
        f"at {RECIPE_KVASIR_FRAME}")
    roots = {"attn_src_kvasir_tpu.yaml": polyp_root, "pranet_src_polyp_tpu.yaml": polyp_root,
             "deeplabv2_r101_src_kvasir_tpu.yaml": frame_root, "gald_src_tpu.yaml": gta_root}
    launches = [0, 0, 0]
    for config in RECIPES:
        family = config.split("_")[0].replace("deeplabv2", "deeplab")
        out_dir = os.path.join(tmp, "recipes", config[:-5])
        opts = ["-cfg", os.path.join(HERE, "configs", config), "DATASETS.DATASET_DIR",
                roots[config], "OUTPUT_DIR", out_dir, "SOLVER.EPOCHS", "1",
                "SOLVER.CHECKPOINT_PERIOD", "1"]
        extra = []
        if family == "pranet":
            side = f"({PRANET_SIDE}, {PRANET_SIDE})"
            extra += ["INPUT.SOURCE_INPUT_SIZE_TRAIN", side, "INPUT.TARGET_INPUT_SIZE_TRAIN", side]
        if not native_built:
            extra += ["DATA_PIPE.NATIVE_DECODE", "False"]
        cfg = load_cfg(train_src.build_parser().parse_args(opts + extra))
        written = (cfg.SOLVER.ASYNC_CHECKPOINT, cfg.DATA_PIPE.WORKER_PROCESSES,
                   cfg.DATA_PIPE.DEVICE_AUG)
        try:
            result = _recipe_run(config, family, cfg, card)
        except torch.cuda.OutOfMemoryError as err:
            result, oom = None, str(err).splitlines()[0][:160]
        if result is None:  # outside the handler, so that the failed run's tensors go
            gc.collect()
            torch.cuda.empty_cache()
            log(f"[recipes_tpu] {config} ran out of memory at batch {cfg.SOLVER.BATCH_SIZE} "
                f"({oom}); again with MODEL.REMAT_BLOCKS True, which the recipe's comment "
                f"offers")
            extra += ["MODEL.REMAT_BLOCKS", "True"]
            cfg = load_cfg(train_src.build_parser().parse_args(opts + extra))
            result = _recipe_run(config, family, cfg, card)
        log(f"[recipes_tpu] {config} on {card}: overrides besides data, output and run "
            f"length {extra or 'none'}; ASYNC_CHECKPOINT, WORKER_PROCESSES, DEVICE_AUG "
            f"{written}; " + result["line"])
        counts = result["counts"]
        launches = [a + b for a, b in zip(launches, counts)]
        steps = result["steps"]
        if family == "gald" and counts != [2 * steps, 2 * steps, 0]:
            raise AssertionError(f"the GALD recipe launched {counts} in {steps} steps")
        if family != "gald" and any(counts):
            raise AssertionError(f"a hand kernel ran in the {family} recipe: {counts}")
        MEASURED.setdefault("recipes_tpu", {})[config] = result["numbers"]
        torch.cuda.empty_cache()
    return tuple(launches)


def _recipe_run(config: str, family: str, cfg, card: str) -> dict:
    trainer = train_src.make_trainer(family, cfg, logger=_stderr_logger(
        f"chip_smoke.recipes_tpu", logging.WARNING))
    try:
        randomize_weights_(trainer.segmentor, seed=0)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_kernel_counts()
        trainer.train()
        torch.cuda.synchronize()
        counts = [getattr(m, n) for m, n in KERNEL_COUNTERS]
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    finally:
        trainer.train_loader.close()
    if not trainer.loss_data or not all(np.isfinite(trainer.loss_data)):
        raise AssertionError(f"{config}: losses {trainer.loss_data}")
    files = sorted(f for f in os.listdir(cfg.OUTPUT_DIR) if f.endswith(".pth"))
    if files != [f"{trainer.ckpt_prefix}-1.pth"]:
        raise AssertionError(f"{config}: checkpoints {files}")
    times = trainer.meters.meters["time"].series
    batch = cfg.SOLVER.BATCH_SIZE
    step_ms = float(np.median(times[1:] if len(times) > 1 else times)) * 1e3
    share = _data_share(trainer) if len(times) > 1 else float("nan")
    line = (f"{len(times)} batches of {batch} ({trainer.state.step} optimizer steps), "
            f"{step_ms:.1f} ms a batch (median after the first), {batch / step_ms * 1e3:.2f} "
            f"images/s, data share {share:.1%}, peak {peak_mib:.0f} MiB, the loop waited "
            f"{[round(ms, 1) for ms in trainer.save_blocked_ms]} ms at its saves, "
            f"{cfg.MODEL.DTYPE}; launches (cc fwd, cc bwd, mbconv) {counts}")
    return {"line": line, "counts": counts, "steps": trainer.state.step,
            "numbers": {"images_s": batch / step_ms * 1e3, "share": share, "peak": peak_mib,
                        "wait_ms": list(trainer.save_blocked_ms)}}


# CCNet (Huang et al., ICCV 2019; speedinghzl/CCNet): ResNet-101, 769x769
# crops, 2 images a card, recurrence 2, the dsn loss at 0.4 (its published
# Cityscapes setting); models/seg_nets.py CCNetSegModel at full width and depth
CCNET_LAYERS, CCNET_SIDE, CCNET_BATCH, CCNET_STEPS = (3, 4, 23, 3), 769, 2, 3
CCNET_EVAL = (1024, 2048)                 # one Cityscapes frame: a 128 x 256 map
CCNET_TRAIN_CC_SHAPE = (CCNET_BATCH, 97, 97, 64, 512)
CCNET_EVAL_CC_SHAPE = (1, 128, 256, 64, 512)
CCNET_DSN_WEIGHT = 0.4
CCNET_LOSS_TOLERANCE = 1e-4               # the step's loss, kernels against the plain core
RES2NET_GC_SIDE = 352
PRETRAINED_DEEPLAB_STEPS = 2


class _CaptureCore:
    """Wraps ``gcpa.cc_attention_core``: while ``on``, each call's q, k, v
    and, through a hook on its output, the gradient that reaches it are kept,
    so that kernels #1 and #2 can be held on the operands the model fed them."""

    def __init__(self, real):
        self.real, self.on, self.calls = real, False, []

    def __call__(self, q, k, v):
        out = self.real(q, k, v)
        if self.on:
            entry = {"q": q.detach().clone(), "k": k.detach().clone(), "v": v.detach().clone()}
            self.calls.append(entry)
            if out.requires_grad:
                out.register_hook(lambda g, e=entry: e.__setitem__(
                    "g", g.detach().contiguous().clone()))
        return out


def _ccnet_loss(outputs, label):
    """This script's CCNet loss: CE (ignore 255) of ``main`` plus 0.4 x that of
    ``dsn``, each upsampled bilinearly (align_corners=True) to the label."""
    from rnd_semantic_segmentation_torch.losses import cross_entropy
    from rnd_semantic_segmentation_torch.ops import resize_bilinear

    size = label.shape[-2:]
    main, dsn = (resize_bilinear(o.float(), size, align_corners=True) for o in outputs)
    return cross_entropy(main, label) + CCNET_DSN_WEIGHT * cross_entropy(dsn, label)


def _hold_kernels_on(tag: str, entry: dict, with_grad: bool) -> dict:
    """Kernel #1 (and #2 when ``with_grad``) against the plain versions on
    one call's captured operands; returns the errors."""
    q, k, v = entry["q"], entry["k"], entry["v"]
    out = ccattn.cc_attention_core_cuda(q, k, v)
    ref = ccattn.cc_attention_core_plain(q, k, v)
    err, ok = _within(out, ref, torch.float32)
    energy = max(torch.einsum("bhwc,bkwc->bhwk", q, k).abs().max().item(),
                 torch.einsum("bhwc,bhkc->bhwk", q, k).abs().max().item())
    atol, rtol = TOLERANCE[torch.float32]
    log(f"[{tag}] cc_attention_fwd on the captured {tuple(q.shape[:3])} Cq={q.shape[3]} "
        f"C={v.shape[3]} operands (largest energy {energy:.1f}): max abs err {err:.3e} "
        f"(tolerance {atol:g} + {rtol:g}*|plain|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"cc_attention_fwd disagrees with its plain version on the "
                             f"{tag} operands: {err}")
    result = {"fwd_err": err}
    if with_grad:
        g = entry["g"]
        got = ccattn.cc_attention_core_bwd_cuda(q, k, v, g)
        plain = ccattn.cc_attention_core_bwd_plain(q, k, v, g)
        rel = BWD_TOLERANCE[torch.float32]
        bwd_err, ok = 0.0, True
        for o, p in zip(got, plain):
            e = (o - p).abs().max().item()
            bwd_err = max(bwd_err, e)
            ok = ok and bool(torch.isfinite(o).all()) and e <= rel * p.abs().max().item()
        log(f"[{tag}] cc_attention_bwd on the captured operands and upstream gradient "
            f"(|g| max {g.abs().max().item():.3e}): max abs err {bwd_err:.3e} (tolerance "
            f"{rel:g} x max|plain|) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"cc_attention_bwd disagrees with its plain version on the "
                                 f"{tag} operands: {bwd_err}")
        result["bwd_err"] = bwd_err
    return result


def _time_cc_at(tag: str, entry: dict, with_grad: bool) -> dict:
    """Device times (CUDA graph, events) of #1, its plain version and the
    masked-SDPA yardstick (held against the plain version first) on the
    captured operands, and of #2 and its plain version; with the bounds."""
    q, k, v = entry["q"], entry["k"], entry["v"]
    b, h, w, cq = q.shape
    shape = (b, h, w, cq, v.shape[3])
    reps, replays = (5, 4) if h * w > 20000 else (20, 10)
    mask = cc_mask(h, w)
    ref = ccattn.cc_attention_core_plain(q, k, v)
    sdpa_err, sdpa_ok = _within(cc_sdpa(q, k, v, mask), ref, torch.float32)
    if not sdpa_ok:
        raise AssertionError(f"masked SDPA disagrees with the plain version at {shape}: "
                             f"{sdpa_err}")
    fwd = {"ms": graph_ms(lambda: ccattn.cc_attention_core_cuda(q, k, v), reps, replays),
           "plain_ms": graph_ms(lambda: ccattn.cc_attention_core_plain(q, k, v), reps, replays),
           "library_ms": graph_ms(lambda: cc_sdpa(q, k, v, mask), reps, replays)}
    fwd["bound_ms"], fwd["bound_by"] = cc_bound(shape, torch.float32)
    log(f"[{tag}] cc_attention_fwd at {shape} on {card_line()}: {fwd['ms'] * 1e3:.2f} us, "
        f"bound {fwd['bound_ms'] * 1e3:.2f} us ({fwd['bound_by']}), plain version "
        f"{fwd['plain_ms'] * 1e3:.2f} us, masked SDPA {fwd['library_ms'] * 1e3:.2f} us "
        f"(max abs err {sdpa_err:.3e} against the plain version)")
    _log_passes(ccattn.FWD_PASSES, _pass_us(lambda: ccattn.cc_attention_core_cuda(q, k, v),
                                            "cc_attention_fwd_kernel", 2))
    out = {"shape": list(shape), "fwd": fwd}
    if with_grad:
        g = entry["g"]
        bwd = {"ms": graph_ms(lambda: ccattn.cc_attention_core_bwd_cuda(q, k, v, g),
                              reps, replays),
               "plain_ms": graph_ms(lambda: ccattn.cc_attention_core_bwd_plain(q, k, v, g),
                                    reps, replays)}
        bwd["bound_ms"], bwd["bound_by"] = cc_bwd_bound(shape, torch.float32)
        log(f"[{tag}] cc_attention_bwd at {shape}: {bwd['ms'] * 1e3:.2f} us, bound "
            f"{bwd['bound_ms'] * 1e3:.2f} us ({bwd['bound_by']}), plain version "
            f"{bwd['plain_ms'] * 1e3:.2f} us")
        _log_passes(ccattn.BWD_PASSES, _pass_us(
            lambda: ccattn.cc_attention_core_bwd_cuda(q, k, v, g), "cc_attention_bwd_kernel", 3))
        for i, name in enumerate(ccattn.BWD_PASSES):
            log(f"[{tag}] cc_attention_bwd {shape}, pass {i + 1} ({name}): "
                f"{ccattn.bwd_pass_info(shape, torch.float32, i)}")
        out["bwd"] = bwd
    for i, name in enumerate(ccattn.FWD_PASSES):
        log(f"[{tag}] cc_attention_fwd {shape}, pass {i + 1} ({name}): "
            f"{ccattn.fwd_pass_info(shape, torch.float32, i)}")
    return out


def _one_forward(tag: str, net, x: torch.Tensor, card: str) -> None:
    """One train-mode forward (batch statistics, no gradients) of a research
    net on the card: finite outputs, its ms, and no hand kernel."""
    net = net.cuda().train()
    _zero_kernel_counts()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net(x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    outs = list(out.values()) if isinstance(out, dict) else list(out)
    shapes = [tuple(o.shape) for o in outs]
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError(f"{tag}: outputs not finite")
    log(f"[ccnet] {tag} train-mode forward of {tuple(x.shape)} on {card}: {ms:.1f} ms "
        f"(one call, cuDNN's first at this shape), outputs {shapes}, finite")
    _check_no_kernel(f"ccnet {tag}")


def phase_ccnet(tmp: str, card: str) -> dict:
    """CCNet at full width and depth (ResNet-101, recurrence 2, 19 classes,
    seeded weights, gamma 0.7), float32, TF32 off: 3 train-mode steps of 2
    images at 769x769 (SGD, the CE of main plus 0.4 x that of dsn), then one
    eval forward of a 1024x2048 frame.  Kernel #1 launches twice a forward
    and #2 twice a step; both are held against their plain versions on the
    operands the first step fed them (and #1 on the eval forward's), and the
    step's loss against the same step with the plain core.  Then one
    train-mode forward each of GALDNet, PSPNet and DualSeg at 769 and of
    Res2Net with GCNet blocks at 352 (no hand kernel)."""
    from rnd_semantic_segmentation_torch.models.res2net import Res2Net
    from rnd_semantic_segmentation_torch.models.seg_nets import (
        CCNetSegModel,
        DualSegNet,
        GALDNetFull,
        PSPNetFull,
    )

    t0 = time.perf_counter()
    torch.manual_seed(0)
    net = randomize_weights_(CCNetSegModel(19, recurrence=2, layers=CCNET_LAYERS), seed=0,
                             gamma=0.7).cuda()
    log(f"[ccnet] CCNetSegModel ResNet-101 {CCNET_LAYERS}, recurrence 2: "
        f"{sum(p.numel() for p in net.parameters())} parameters, seeded in "
        f"{time.perf_counter() - t0:.1f} s; attention Cq "
        f"{net.head.cca.query_conv.out_channels}, C {net.head.cca.value_conv.out_channels}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(CCNET_BATCH, 3, CCNET_SIDE, CCNET_SIDE, device="cuda", generator=gen)
    label = torch.randint(0, 19, (CCNET_BATCH, CCNET_SIDE, CCNET_SIDE), device="cuda",
                          generator=gen)
    label[:, :40] = 255  # a band of ignored pixels, as a crop's padding gives
    opt = torch.optim.SGD(net.parameters(), lr=1e-2, momentum=0.9, weight_decay=5e-4)
    capture = _CaptureCore(gcpa.cc_attention_core)
    times, losses = [], []
    with mock.patch.object(gcpa, "cc_attention_core", capture):
        net.train()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_kernel_counts()
        for step in range(CCNET_STEPS):
            capture.on = step == 0
            torch.cuda.synchronize()
            tic = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = _ccnet_loss(net(x), label)
            loss.backward()
            opt.step()
            losses.append(loss.item())  # ends in a device sync
            times.append((time.perf_counter() - tic) * 1e3)
        capture.on = False
        train_fwd, train_bwd = ccattn.KERNEL_LAUNCHES, ccattn.BWD_KERNEL_LAUNCHES
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        log(f"[ccnet] {CCNET_STEPS} train steps of {CCNET_BATCH} at {CCNET_SIDE}x{CCNET_SIDE} "
            f"on {card}: losses {[round(v, 4) for v in losses]}, {np.median(times[1:]):.1f} "
            f"ms/step (median of steps 2..{CCNET_STEPS}; first {times[0]:.0f} ms), peak "
            f"memory {peak_mib:.0f} MiB, float32, TF32 off; launches cc_attention_fwd "
            f"{train_fwd}, cc_attention_bwd {train_bwd}, fused_mbconv_fwd "
            f"{mbconv.KERNEL_LAUNCHES}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"ccnet losses {losses}")
        if (train_fwd, train_bwd, mbconv.KERNEL_LAUNCHES) != (2 * CCNET_STEPS,
                                                              2 * CCNET_STEPS, 0):
            raise AssertionError(f"ccnet launches {train_fwd}, {train_bwd} over "
                                 f"{CCNET_STEPS} steps; want 2 and 2 a step")
        train_calls = capture.calls
        capture.calls = []

        # the eval forward of one frame
        frame = torch.randn(1, 3, *CCNET_EVAL, device="cuda", generator=gen)
        net.eval()
        _zero_kernel_counts()
        capture.on = True
        with torch.no_grad():
            torch.cuda.synchronize()
            tic = time.perf_counter()
            main, dsn = net(frame)
            torch.cuda.synchronize()
            eval_ms = (time.perf_counter() - tic) * 1e3
        capture.on = False
        eval_fwd = ccattn.KERNEL_LAUNCHES
        eval_calls = capture.calls
        finite = bool(torch.isfinite(main).all() and torch.isfinite(dsn).all())
        log(f"[ccnet] eval forward of one {CCNET_EVAL[0]}x{CCNET_EVAL[1]} frame: "
            f"{eval_ms:.1f} ms (one call), logits {tuple(main.shape)} and "
            f"{tuple(dsn.shape)}, {'finite' if finite else 'NOT FINITE'}; launches "
            f"cc_attention_fwd {eval_fwd}, cc_attention_bwd {ccattn.BWD_KERNEL_LAUNCHES}")
        if not finite or (eval_fwd, ccattn.BWD_KERNEL_LAUNCHES) != (2, 0):
            raise AssertionError(f"ccnet eval: finite {finite}, launches {eval_fwd}")
        del main, dsn, frame

    # the kernels on the operands the model fed them (not counted above)
    if len(train_calls) != 2 or any("g" not in e for e in train_calls) or len(eval_calls) != 2:
        raise AssertionError(f"captured {len(train_calls)} train and {len(eval_calls)} eval "
                             f"calls")
    errors = [_hold_kernels_on("ccnet train", e, True) for e in train_calls]
    errors += [_hold_kernels_on("ccnet eval", e, False) for e in eval_calls]

    # the step's loss with kernels against the plain core, same weights
    net.train()
    with torch.no_grad():
        loss_k = _ccnet_loss(net(x), label).item()
        with mock.patch.object(gcpa, "cc_attention_core", ccattn.cc_attention_core_plain):
            before = ccattn.KERNEL_LAUNCHES
            loss_p = _ccnet_loss(net(x), label).item()
            if ccattn.KERNEL_LAUNCHES != before:
                raise AssertionError("the plain-core forward launched the kernel")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"[ccnet] train-mode loss with the kernels {loss_k:.6f}, with the plain core "
        f"{loss_p:.6f}: relative difference {rel:.3e} (tolerance {CCNET_LOSS_TOLERANCE:g})")
    if not rel <= CCNET_LOSS_TOLERANCE:
        raise AssertionError(f"ccnet loss, kernels against plain core: {rel}")

    timed = {"train": _time_cc_at("ccnet", train_calls[0], True),
             "eval": _time_cc_at("ccnet", eval_calls[0], False)}
    del net, opt, x, label, train_calls, eval_calls, capture
    torch.cuda.empty_cache()

    side = CCNET_SIDE
    for name, cls in (("GALDNetFull", GALDNetFull), ("PSPNetFull", PSPNetFull),
                      ("DualSegNet", DualSegNet)):
        model = randomize_weights_(cls(19, layers=CCNET_LAYERS), seed=1)
        _one_forward(name, model, torch.randn(CCNET_BATCH, 3, side, side, device="cuda",
                                              generator=gen), card)
        del model
        torch.cuda.empty_cache()
    _one_forward("Res2Net(gc_blocks=True)", randomize_weights_(Res2Net(gc_blocks=True), seed=2),
                 torch.randn(CCNET_BATCH, 3, RES2NET_GC_SIDE, RES2NET_GC_SIDE, device="cuda",
                             generator=gen), card)
    torch.cuda.empty_cache()
    log(f"[ccnet] phase in {time.perf_counter() - t0:.1f} s")
    MEASURED["ccnet"] = {"step_ms": float(np.median(times[1:])), "peak_mib": peak_mib,
                         "eval_ms": eval_ms, **timed}
    worst_fwd = max(e["fwd_err"] for e in errors)
    worst_bwd = max(e["bwd_err"] for e in errors if "bwd_err" in e)
    return {"fwd": train_fwd + eval_fwd, "bwd": train_bwd, "timed": timed,
            "fwd_err": worst_fwd, "bwd_err": worst_bwd}


def _write_published(path: str, sd: dict, extra: dict) -> float:
    """``sd`` and the ``extra`` keys the loaders skip, written as one ``.pth``;
    returns its size in MB."""
    torch.save({**{k: v.detach().cpu() for k, v in sd.items()}, **extra}, path)
    return os.path.getsize(path) / 1e6


def _timed_loads():
    """Patches the trainers' ``load_pretrained_backbone`` to log its seconds."""
    from rnd_semantic_segmentation_torch.train import trainer as trainer_mod

    real, seconds = trainer_mod.load_pretrained_backbone, []

    def timed(*args):
        tic = time.perf_counter()
        out = real(*args)
        seconds.append(time.perf_counter() - tic)
        return out
    return mock.patch.object(trainer_mod, "load_pretrained_backbone", timed), seconds


def _check_loaded(tag: str, module, prefix: str, published: dict) -> None:
    sd = module.state_dict()
    held = [k for k in published if not k.startswith(("fc.", "base.19"))
            and "num_batches_tracked" not in k]
    wrong = [k for k in held if not torch.equal(sd[prefix + k].cpu(), published[k].cpu())]
    skipped = [k for k in published if k not in held]
    if wrong or any(prefix + k in sd for k in skipped if "num_batches_tracked" not in k):
        raise AssertionError(f"{tag}: {len(wrong)} tensors differ from the file, e.g. "
                             f"{wrong[:3]}")
    log(f"[pretrained] {tag}: all {len(held)} backbone tensors equal the file's after the "
        f"load; {len(skipped)} keys skipped ({sorted(skipped)[:4]}...)")


def phase_pretrained(tmp: str, card: str) -> dict:
    """MODEL.WEIGHTS on the card: a torchvision-layout ResNet-101 ``.pth``
    from seeded weights (about 170 MB, in the temporary directory) under
    ``cli.train_src`` with configs/deeplabv2_r101_src.yaml for 2 steps, and a
    hardnet68-layout ``.pth`` under ``cli.train_adv`` with
    configs/gald_adv.yaml (GALD FADA) for one step; each trainer's backbone
    must equal the file after the load, the classifier keys skipped, and the
    steps' losses be finite.  GALD FADA launches #1 4 times and #2 twice."""
    from rnd_semantic_segmentation_torch.models.aspp import ResNetFeatureExtractor
    from rnd_semantic_segmentation_torch.models.gcpa import GCPAEncoder

    out = {}
    resnet = randomize_weights_(ResNetFeatureExtractor("resnet101", freeze_bn=False), seed=3)
    published = {k[len("backbone."):]: v for k, v in resnet.state_dict().items()}
    pth = os.path.join(tmp, "pretrained", "resnet101.pth")
    os.makedirs(os.path.dirname(pth), exist_ok=True)
    mb = _write_published(pth, published, {"fc.weight": torch.randn(1000, 2048) * 0.01,
                                            "fc.bias": torch.zeros(1000)})
    patch, seconds = _timed_loads()
    batch = DEEPLAB_GEOMETRY[3]
    with patch:
        cfg = load_cfg(train_src.build_parser().parse_args(_deeplab_opts(
            os.path.join(tmp, "pretrained", "deeplab"), "MODEL.WEIGHTS", pth,
            "DATASETS.SYNTHETIC_LENGTH", str(batch * PRETRAINED_DEEPLAB_STEPS),
            "SOLVER.EPOCHS", "1", "SOLVER.CHECKPOINT_PERIOD", "2")))
        trainer = train_src.make_trainer("deeplab", cfg, logger=_stderr_logger(
            "chip_smoke.pretrained", logging.WARNING))
    log(f"[pretrained] deeplab_resnet101: {pth} ({mb:.0f} MB, torchvision layout, FrozenBN "
        f"statistics) loaded in {seconds[-1]:.2f} s")
    _check_loaded("deeplab_resnet101", trainer.spec.modules["feature_extractor"], "backbone.",
                  published)
    _zero_kernel_counts()
    trainer.train()
    if trainer.state.step != PRETRAINED_DEEPLAB_STEPS or not all(np.isfinite(trainer.loss_data)):
        raise AssertionError(f"pretrained deeplab: {trainer.state.step} steps, losses "
                             f"{trainer.loss_data}")
    log(f"[pretrained] deeplab {trainer.state.step} steps of {batch}: losses "
        f"{[round(v, 4) for v in trainer.loss_data]}")
    _check_no_kernel("pretrained deeplab")
    out["deeplab_load_s"] = seconds[-1]
    del trainer, resnet
    torch.cuda.empty_cache()

    encoder = randomize_weights_(GCPAEncoder(), seed=4)
    published = {k[len("hardnet."):]: v for k, v in encoder.state_dict().items()}
    pth = os.path.join(tmp, "pretrained", "hardnet68.pth")
    mb = _write_published(pth, published, {"base.19.3.weight": torch.randn(1000, 1024) * 0.01,
                                            "base.19.3.bias": torch.zeros(1000)})
    half = GALD_FADA_GEOMETRY[2] // 2
    patch, seconds = _timed_loads()
    with patch:
        cfg = load_cfg(train_adv.build_parser().parse_args(_fada_opts(
            "gald_adv.yaml", os.path.join(tmp, "pretrained", "gald_fada"), "MODEL.WEIGHTS", pth,
            "DATASETS.SYNTHETIC_LENGTH", str(half), "SOLVER.CHECKPOINT_PERIOD", "2")))
        trainer = train_adv.make_trainer("gald_fada", cfg, logger=_stderr_logger(
            "chip_smoke.pretrained", logging.WARNING))
    log(f"[pretrained] gald_hardnet68 FADA: {pth} ({mb:.0f} MB, hardnet68 layout) loaded in "
        f"{seconds[-1]:.2f} s")
    _check_loaded("gald_hardnet68", trainer.spec.modules["encoder"], "hardnet.", published)
    _zero_kernel_counts()
    trainer.train()
    fwd, bwd = ccattn.KERNEL_LAUNCHES, ccattn.BWD_KERNEL_LAUNCHES
    for key, values in trainer.series.items():
        if not all(np.isfinite(values)):
            raise AssertionError(f"pretrained gald fada {key} {values}")
    log(f"[pretrained] gald FADA {trainer.state.step} step of {half} + {half}: "
        f"{ {k: [round(v, 4) for v in vals] for k, vals in trainer.series.items()} }; launches "
        f"cc_attention_fwd {fwd}, cc_attention_bwd {bwd}, fused_mbconv_fwd "
        f"{mbconv.KERNEL_LAUNCHES}")
    if (fwd, bwd, mbconv.KERNEL_LAUNCHES) != (4 * trainer.state.step, 2 * trainer.state.step, 0):
        raise AssertionError(f"pretrained gald fada launches {fwd}, {bwd}")
    out.update({"gald_load_s": seconds[-1], "fwd": fwd, "bwd": bwd})
    MEASURED["pretrained"] = out
    return out


# -- the rest of the research zoo, the exact conv rewrites, DEBUG.CHECKIFY ------------

# The zoo's nets at their published sizes (batch, channels, side or T x side),
# float32 with TF32 off; a warm-up step and a timed one with SGD, then an eval
# forward.  The loss is each net's reference's: BCE on the sigmoid
# probabilities of the binary nets (UNet, CE-Net) and on the channel-mean
# saliency logits of B2ResNet's branches (CPD), CE on the class maps of the
# segmentation nets and on the classifier's logits of CGNLResNet; the
# encoders without a head of their own (RepVGG, SE-ResNet, ResNet3D, trained
# on ImageNet or Kinetics classification) take CE on their last tap's
# global average, one class a channel; a FAM variant CE on its output, one
# class a channel.
ZOO_LR, ZOO_MOMENTUM = 1e-3, 0.9
ZOO_FAM_BATCH = 8                        # GALD's serving batch
# the taps of a 1024x512 frame that GALD's fam45 fuses: left the /16 HarDNet
# tap (640 channels), down and right the /32 decoder maps (256)
ZOO_FAM_TAPS = ((640, 32, 64), (256, 16, 32), (256, 16, 32))
REPVGG_DEPLOY_TOLERANCE = 1e-4           # of the train form's largest output
REWRITE_TOLERANCE = 2e-4                 # the JAX package's whole-model tolerance
REWRITE_NOISE_FACTOR = 3                 # as dist_gald_2rank holds to an image scaling
REWRITE_GALD_S2D, REWRITE_PRANET_S2D = "64", "256"
# #1 and #2 in the GALD pair: 3 steps x 2 trainers x 2 a step, and #1 twice
# in each of its 3 forwards without autograd (two eval, one scaled image)
REWRITE_GALD_LAUNCHES = (3 * 2 * 2 + 3 * 2, 3 * 2 * 2)


def _zoo_specs():
    """(tag, constructor, input shapes, loss) of every zoo net of the phase."""
    from rnd_semantic_segmentation_torch.models import (cls_hubs, encoders_zoo, fam_variants,
                                                        nets_zoo, resnet3d)

    fam_in = tuple(c for c, _, _ in ZOO_FAM_TAPS)
    fam_shapes = [(ZOO_FAM_BATCH, c, h, w) for c, h, w in ZOO_FAM_TAPS]
    crop = (ZOO_FAM_BATCH, 1) + ZOO_FAM_TAPS[0][1:]
    return [
        ("unet", lambda: nets_zoo.UNet(1), [(16, 3, 352, 352)], "bce_probs"),
        ("cenet_r34", lambda: nets_zoo.CENet(1), [(8, 3, 448, 448)], "bce_probs"),
        ("bisenetv1", lambda: nets_zoo.BiSeNetV1(19), [(8, 3, 1024, 1024)], "ce_maps"),
        ("deeplabv3_r101", lambda: encoders_zoo.DeepLabV3(19, "resnet101"),
         [(8, 3, 513, 513)], "ce_maps"),
        ("b2resnet", encoders_zoo.B2ResNet, [(10, 3, 352, 352)], "bce_saliency"),
        ("repvgg_a0", lambda: encoders_zoo.RepVGG("RepVGG-A0"), [(32, 3, 224, 224)],
         "ce_pooled"),
        ("cgnlresnet50", lambda: cls_hubs.CGNLResNet("resnet50", nl_type="cgnl", nl_nums=1),
         [(32, 3, 224, 224)], "ce_logits"),
        ("seresnet", encoders_zoo.SEResNet, [(32, 3, 224, 224)], "ce_pooled"),
        ("resnet3d", resnet3d.ResNet3D, [(8, 3, 16, 112, 112)], "ce_pooled"),
        ("famag", lambda: fam_variants.FAMAG(*fam_in), fam_shapes, "ce_maps"),
        ("famagv3", lambda: fam_variants.FAMAGv3(*fam_in), fam_shapes, "ce_maps"),
        ("fampra", lambda: fam_variants.FAMPra(*fam_in), fam_shapes + [crop], "ce_maps"),
        ("famscws", lambda: fam_variants.FAMSCWS(*fam_in), fam_shapes, "ce_maps"),
    ]


def _zoo_loss(kind: str, out, gen: torch.Generator, targets: dict) -> torch.Tensor:
    """The loss ``kind`` of ``out``; its targets are drawn from ``gen`` at the
    first call and kept in ``targets``, so that every step sees the same."""
    import torch.nn.functional as F

    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    if kind == "ce_pooled":      # an encoder: its last tap
        outs = outs[-1:]
    elif kind == "ce_maps":      # FAMPra's one-channel reverse-attention map has no classes
        outs = [o for o in outs if o.shape[1] > 1]
    total = 0.0
    for i, o in enumerate(outs):
        if kind in ("bce_probs", "bce_saliency"):
            logits = o.mean(1, keepdim=True) if kind == "bce_saliency" else o
            key = (i, tuple(logits.shape))
            if key not in targets:
                targets[key] = (torch.rand(logits.shape, generator=gen, device=o.device)
                                > 0.5).float()
            total = total + (F.binary_cross_entropy(logits.clamp(1e-6, 1 - 1e-6), targets[key])
                             if kind == "bce_probs" else
                             F.binary_cross_entropy_with_logits(logits, targets[key]))
        else:
            logits = o.flatten(2).mean(2) if kind == "ce_pooled" else o
            key = (i, tuple(logits.shape))
            if key not in targets:
                shape = (logits.shape[0],) + tuple(logits.shape[2:])
                targets[key] = torch.randint(0, logits.shape[1], shape, generator=gen,
                                             device=o.device)
            total = total + F.cross_entropy(logits.float(), targets[key])
    return total


def _zoo_net(tag: str, make, shapes, kind: str, card: str) -> dict:
    """One net: seeded weights, a warm-up step and a timed one, then an eval
    forward (warm-up, timed); ms, peak MiB, finite outputs."""
    torch.manual_seed(0)
    net = randomize_weights_(make(), seed=0).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    opt = torch.optim.SGD(net.parameters(), lr=ZOO_LR, momentum=ZOO_MOMENTUM)
    targets: dict = {}

    def step():
        opt.zero_grad(set_to_none=True)
        loss = _zoo_loss(kind, net.train()(*inputs), gen, targets)
        loss.backward()
        opt.step()
        return loss.detach()

    first = step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    with torch.no_grad():
        net.eval()(*inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net(*inputs)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
    outs = out if isinstance(out, tuple) else (out,)
    if not (torch.isfinite(first) and torch.isfinite(loss)
            and all(torch.isfinite(o).all() for o in outs)):
        raise AssertionError(f"[zoo_nets] {tag}: losses {float(first)}, {float(loss)} or its "
                             f"eval outputs are not finite")
    params = sum(p.numel() for p in net.parameters())
    log(f"[zoo_nets] {tag} on {card}: input {[list(s) for s in shapes]}, {params / 1e6:.2f} M "
        f"parameters; a train step {step_ms:.1f} ms ({kind}: {float(first):.4f} -> "
        f"{float(loss):.4f}), peak {peak_mib:.0f} MiB; eval forward {fwd_ms:.1f} ms, outputs "
        f"{[list(o.shape) for o in outs]}")
    rec = {"step_ms": step_ms, "fwd_ms": fwd_ms, "peak_mib": peak_mib}
    if tag == "repvgg_a0":
        rec["deploy_gap"] = _repvgg_deploy_on_card(net, inputs[0], outs)
    return rec


def _repvgg_deploy_on_card(net, x: torch.Tensor, train_outs) -> float:
    """The deploy form from ``repvgg_reparam`` of the trained weights: its
    eval taps against the train form's on the same batch."""
    from rnd_semantic_segmentation_torch.models.encoders_zoo import RepVGG, repvgg_reparam

    deploy = RepVGG("RepVGG-A0", deploy=True)
    deploy.load_state_dict(repvgg_reparam(net.state_dict()))
    with torch.no_grad():
        outs = deploy.cuda().eval()(x)
    gap = max(((o - r).abs().max() / r.abs().max()).item() for o, r in zip(outs, train_outs))
    log(f"[zoo_nets] repvgg_a0 deploy form (one 3x3 conv a block) against the train form: "
        f"largest gap {gap:.3e} of a tap's largest value (tolerance {REPVGG_DEPLOY_TOLERANCE:g})")
    if not gap <= REPVGG_DEPLOY_TOLERANCE:
        raise AssertionError(f"[zoo_nets] RepVGG's deploy form is {gap:.3e} off")
    return gap


def phase_zoo_nets(tmp: str, card: str) -> dict:
    """Each net of the rest of the research zoo (``_zoo_specs``) trained one
    step and evaluated at its published size; no hand kernel lies on them."""
    _zero_kernel_counts()
    out = {}
    for tag, make, shapes, kind in _zoo_specs():
        out[tag] = _zoo_net(tag, make, shapes, kind, card)
        torch.cuda.empty_cache()
    _check_no_kernel("zoo_nets")
    MEASURED["zoo_nets"] = out
    return out


class _RewriteCounts:
    """Counts the calls of the two rewrites through ``models.layers`` while
    it is entered: the convs they took."""

    def __enter__(self):
        from rnd_semantic_segmentation_torch.models import layers

        self.layers, self.calls = layers, {"conv2d_s2d": 0, "conv_transpose_subpixel": 0}
        self.real = {n: getattr(layers, n) for n in self.calls}
        for name, fn in self.real.items():
            setattr(layers, name, self._counting(name, fn))
        return self

    def _counting(self, name, fn):
        def call(*args, **kwargs):
            self.calls[name] += 1
            return fn(*args, **kwargs)
        return call

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.layers, name, fn)


def _in_turns(calls: dict, rounds: int = 2) -> dict:
    """Host-clock ms of each of ``calls`` (name -> a function that ends in a
    device sync), run in turns a, b, b, a, ... ``rounds`` times each; the
    median a call."""
    times = {name: [] for name in calls}
    order = list(calls)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: float(np.median(t)) for name, t in times.items()}


def _float_leaves(out) -> list:
    """float32 copies of the floating-point tensors in ``out``."""
    from torch.utils._pytree import tree_leaves

    return [t.detach().float().clone() for t in tree_leaves(out)
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


def _first_outputs(module: torch.nn.Module):
    """A forward hook on ``module`` that keeps ``_float_leaves`` of its first
    call's output; returns (the list they go into, the hook's handle)."""
    kept = []

    def hook(_module, _args, out):
        if not kept:
            kept.extend(_float_leaves(out))
    return kept, module.register_forward_hook(hook)


def _segmentor_outputs(segmentor, image: torch.Tensor, train: bool) -> list:
    """``_float_leaves`` of one forward of ``segmentor`` on the NHWC
    ``image`` under no_grad, in train or eval mode; the running statistics
    that a train-mode forward moves are put back."""
    saved = [b.clone() for b in segmentor.buffers()]
    x = image.float().permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        out = _float_leaves(segmentor(x, label_size=tuple(image.shape[1:3]), train=train))
        for b, v in zip(segmentor.buffers(), saved):
            b.copy_(v)
    return out


def _largest_gap(have, want) -> float:
    """The largest element gap of each pair of tensors, relative to the
    largest magnitude of ``want``'s tensor; the largest over the pairs."""
    if len(have) != len(want) or not want:
        raise AssertionError(f"{len(have)} tensors against {len(want)}")
    return max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
               for a, b in zip(have, want))


def _rewrite_train_pair(tag: str, tmp: str, card: str, config: str, family: str, knob,
                        batch_opts=()) -> dict:
    """The source step of ``config`` from seeded weights on one batch, with
    ``knob`` off and on.  Each trainer first runs an eval-mode forward on the
    batch (running statistics, as the JAX package's whole-model test of the
    rewrite), then its first step (cuDNN's first calls), whose loss, the
    outputs of its train-mode forward and the gradients of its backward are
    kept; then two timed steps each in turns (on, off, off, on).  Held, each
    by its largest relative element gap (``_largest_gap``): the eval
    outputs and the first losses to REWRITE_TOLERANCE, and the train-mode
    outputs to the larger of REWRITE_TOLERANCE and REWRITE_NOISE_FACTOR
    times what an image scaled by 1 + 2^-20 does to the knob-off train-mode
    forward (batch statistics amplify any change of rounding: GALD's
    reached 4.6e-4 on the H100).  The gradients' whole-model gap (the
    norm of the difference over the norm) and their largest leaf gap are
    logged, not held: in train mode from seeded weights they move with any
    change of rounding (GALD at 224 on the CPU: 3.7e-2 and 2.4), as the
    train phase's ReLU flips show; the CPU tests hold each rewritten conv's
    gradients to the plain conv's at 1e-4."""
    trainers, first, rewritten, evals, outs, grads, batch = {}, {}, {}, {}, {}, {}, None
    for on in (False, True):
        trainer = _synthetic_trainer(f"{tag}_{'on' if on else 'off'}", tmp, config, family, 3,
                                     *FLOAT32, *batch_opts, *(knob if on else ()))
        if batch is None:
            batch = _device_batch(trainer.train_loader, trainer.device)
        trainer.train_loader.close()
        evals[on] = _segmentor_outputs(trainer.segmentor, batch["image"], train=False)
        if not on:
            scaled = _segmentor_outputs(trainer.segmentor, batch["image"] * (1 + 2.0 ** -20),
                                        train=True)
        outs[on], handle = _first_outputs(trainer.segmentor)
        with _RewriteCounts() as counts:
            first[on] = trainer.step_fn(batch, 0)["loss"]
        handle.remove()
        # the step leaves its gradients in place until the next one starts
        grads[on] = [p.grad.detach().clone() for p in trainer.segmentor.parameters()
                     if p.grad is not None]
        rewritten[on] = dict(counts.calls)
        trainers[on] = trainer
    ms = _in_turns({on: (lambda t=trainers[on]: t.step_fn(batch, 0)) for on in (True, False)})
    del trainers
    gap = abs(first[True] - first[False]) / abs(first[False])
    eval_gap = _largest_gap(evals[True], evals[False])
    out_gap = _largest_gap(outs[True], outs[False])
    noise = _largest_gap(scaled, outs[False])
    out_tolerance = max(REWRITE_TOLERANCE, REWRITE_NOISE_FACTOR * noise)
    leaf_gap = _largest_gap(grads[True], grads[False])
    grad_gap = (torch.stack([(a - b).double().norm() for a, b in zip(grads[True], grads[False])])
                .norm() / torch.stack([b.double().norm() for b in grads[False]]).norm()).item()
    shapes = [tuple(o.shape) for o in outs[False]]
    del evals, outs, grads, scaled
    torch.cuda.empty_cache()
    convs = rewritten[True]["conv2d_s2d"] + rewritten[True]["conv_transpose_subpixel"]
    log(f"[rewrites] {tag} on {card}: {' '.join(knob)} rewrote {convs} convs a forward "
        f"({rewritten[True]}); a step of {tuple(batch['image'].shape)} {ms[False]:.1f} ms off, "
        f"{ms[True]:.1f} ms on (x{ms[True] / ms[False]:.2f}; medians of 2 in turns after each "
        f"trainer's first); largest relative gaps, knob on against off, of the outputs "
        f"{shapes}: eval mode {eval_gap:.3e} (tolerance {REWRITE_TOLERANCE:g}), the first "
        f"step's train-mode forward {out_gap:.3e} (tolerance {out_tolerance:.3e}; an image "
        f"scaled by 1 + 2^-20 moves it {noise:.3e}); first losses {first[False]:.6f} off, "
        f"{first[True]:.6f} on, relative gap {gap:.3e}; the first backward's gradients "
        f"whole-model gap {grad_gap:.3e}, largest leaf gap {leaf_gap:.3e} (not held)")
    if (not convs or any(rewritten[False].values()) or not gap <= REWRITE_TOLERANCE
            or not eval_gap <= REWRITE_TOLERANCE or not out_gap <= out_tolerance):
        raise AssertionError(f"[rewrites] {tag}: losses {first}, eval outputs {eval_gap}, "
                             f"train outputs {out_gap} (noise {noise}), convs {rewritten}")
    return {"off_ms": ms[False], "on_ms": ms[True], "gap": gap, "eval_gap": eval_gap,
            "train_out_gap": out_gap, "train_out_noise": noise, "grad_gap": grad_gap,
            "leaf_gap": leaf_gap, "convs": convs}


def _rewrite_attn_pair(card: str) -> dict:
    """attn B2 with MODEL.FUSED_MBCONV at 512, a batch of ATTN_BATCH, the eval
    forward with MODEL.SUBPIXEL_DECONV off and on from the same seeded
    weights: its five maps' largest relative gap, then three timed forwards
    each in turns."""
    x = torch.rand(ATTN_BATCH, 3, ATTN_SIZE, ATTN_SIZE,
                   generator=torch.Generator().manual_seed(3)).cuda()
    segs, outs, rewritten, launches = {}, {}, {}, {}
    for on in (False, True):
        cfg = load_cfg(test_cli.build_parser().parse_args(_attn_opts(
            "", "", "MODEL.FUSED_MBCONV", "True",
            *(("MODEL.SUBPIXEL_DECONV", "True") if on else ()))))
        _check_attn_geometry(cfg)
        seg = Segmentor(build_segmentor(cfg), cfg.MODEL.NUM_CLASSES)
        randomize_weights_(seg, seed=0)
        segs[on] = seg.cuda().eval()
        with torch.no_grad(), _RewriteCounts() as counts:
            before = mbconv.KERNEL_LAUNCHES
            outs[on] = [o.float() for o in segs[on](x)[0]]
            launches[on] = mbconv.KERNEL_LAUNCHES - before
        rewritten[on] = dict(counts.calls)
    with torch.no_grad():
        ms = _in_turns({on: (lambda s=segs[on]: s(x)) for on in (True, False)}, rounds=3)
    del segs
    torch.cuda.empty_cache()
    gap = _largest_gap(outs[True], outs[False])
    convs = rewritten[True]["conv_transpose_subpixel"]
    log(f"[rewrites] attn_b2_subpixel on {card}: MODEL.SUBPIXEL_DECONV rewrote {convs} "
        f"transposed convs a forward; eval forward of {tuple(x.shape)} with "
        f"MODEL.FUSED_MBCONV {ms[False]:.1f} ms off, {ms[True]:.1f} ms on "
        f"(x{ms[True] / ms[False]:.2f}; medians of 3 in turns); fused_mbconv_fwd "
        f"{launches[False]} and {launches[True]} launches a forward; largest relative gap of "
        f"the five maps {gap:.3e} (tolerance {REWRITE_TOLERANCE:g})")
    if (convs != 5 or any(rewritten[False].values()) or not gap <= REWRITE_TOLERANCE
            or launches[False] != MBCONV_LAUNCHES_PER_FORWARD
            or launches[True] != MBCONV_LAUNCHES_PER_FORWARD):
        raise AssertionError(f"[rewrites] attn: {convs} convs, gap {gap}, launches {launches}")
    return {"off_ms": ms[False], "on_ms": ms[True], "gap": gap, "convs": convs}


def phase_rewrites(tmp: str, card: str) -> tuple:
    """The exact conv rewrites against their knob off: GALD's source step
    of 6 at 1280x720 under MODEL.S2D_MAX_CHANNELS 64 (#1 and #2 twice a
    step, #1 twice in each forward without autograd), PraNet Res2Net50's of 16 at 352 under 256, and attn B2's eval
    forward at 512 under MODEL.SUBPIXEL_DECONV with MODEL.FUSED_MBCONV (#3 17
    times a forward).  Returns the launches of #1, #2 and #3."""
    _zero_kernel_counts()
    out = {"gald_s2d": _rewrite_train_pair(
        "gald_s2d", tmp, card, "gald_src.yaml", "gald",
        ("MODEL.S2D_MAX_CHANNELS", REWRITE_GALD_S2D))}
    fwd, bwd = ccattn.KERNEL_LAUNCHES, ccattn.BWD_KERNEL_LAUNCHES
    if (fwd, bwd, mbconv.KERNEL_LAUNCHES) != REWRITE_GALD_LAUNCHES + (0,):
        raise AssertionError(f"[rewrites] GALD launches {fwd}, {bwd}, want "
                             f"{REWRITE_GALD_LAUNCHES}")
    side = f"({PRANET_SIDE}, {PRANET_SIDE})"
    out["pranet_s2d"] = _rewrite_train_pair(
        "pranet_s2d", tmp, card, "pranet_src_polyp.yaml", "pranet",
        ("MODEL.S2D_MAX_CHANNELS", REWRITE_PRANET_S2D),
        batch_opts=("INPUT.SOURCE_INPUT_SIZE_TRAIN", side))
    out["attn_subpixel"] = _rewrite_attn_pair(card)
    counts = tuple(getattr(m, n) for m, n in KERNEL_COUNTERS)
    log(f"[rewrites] launches (cc fwd, cc bwd, mbconv) {counts}")
    if counts[:2] != REWRITE_GALD_LAUNCHES or counts[2] != 2 * 4 * MBCONV_LAUNCHES_PER_FORWARD:
        raise AssertionError(f"[rewrites] launches {counts}")
    MEASURED["rewrites"] = out
    return counts


# DeepLabV2-ResNet101, 6 at 1280x720 (its config), float32
CHECKIFY_POISON = (0, 100, 200, 1)        # (image, row, column, channel) set to +inf


def _checkify_step(tag: str, tmp: str, checked: bool):
    trainer = _synthetic_trainer(tag, tmp, "deeplabv2_r101_src.yaml", "deeplab", 1,
                                 *FLOAT32, *(("DEBUG.CHECKIFY", "True") if checked else ()))
    trainer.train_loader.close()
    return trainer


def phase_checkify(tmp: str, card: str) -> dict:
    """DEBUG.CHECKIFY on the DeepLab-R101 source step of 6 at 1280x720: from
    the same seeded weights on the same batch (cuDNN's deterministic
    algorithms on), the step without the checks, with them, and without
    again; the parameters after that first step against the first unchecked
    step's, then two more steps each of the unchecked and the checked
    trainer in turns, timed.  On the card the unchecked step is not
    bit-reproducible: CE's NLL and the bilinear resize's backward add with
    atomics, which PyTorch lists as nondeterministic with no deterministic
    version (the CPU test holds the checked step bit-equal).  So the checked
    step's parameters are held to at most twice the unchecked repeat's
    difference (relative to each tensor's largest value, at least 2^-22).
    The loss is not held bit-equal either: CE's NLL sums with atomics too
    (two unchecked steps' first losses 1 ulp apart on the H100).  The
    segmentor's outputs of the first forward, which the deterministic
    convolutions and norms make, are held bit-equal to the unchecked
    step's.
    Then the checked step on the batch with one pixel at +inf, which the
    first conv's sums turn into inf - inf, must raise ``FloatingPointError``
    naming the op (only that exception is caught)."""
    _zero_kernel_counts()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        trainers, params, batch, losses, outs = {}, {}, None, {}, {}
        for tag, checked in (("off", False), ("on", True), ("off_again", False)):
            trainer = _checkify_step(f"checkify_{tag}", tmp, checked)
            if batch is None:
                batch = _device_batch(trainer.train_loader, trainer.device)
            outs[tag], handle = _first_outputs(trainer.segmentor)
            losses[tag] = trainer.step_fn(batch, 0)["loss"]
            handle.remove()
            params[tag] = [p.detach().clone() for p in trainer.segmentor.parameters()]
            trainers[tag] = trainer
        equal = {tag: all(torch.equal(a, b) for a, b in zip(params[tag], params["off"]))
                 for tag in ("on", "off_again")}
        forward_equal = {tag: len(outs[tag]) == len(outs["off"]) > 0 and all(
            torch.equal(a, b) for a, b in zip(outs[tag], outs["off"]))
            for tag in ("on", "off_again")}
        del outs
        gaps = {tag: _largest_gap(params[tag], params["off"]) for tag in ("on", "off_again")}
        ms = _in_turns({tag: (lambda t=trainers[tag]: t.step_fn(batch, 0))
                        for tag in ("on", "off")})
        checked_trainer = trainers["on"]
        del trainers, params
        log(f"[checkify] DeepLab-R101 step of {tuple(batch['image'].shape)} on {card}: "
            f"{ms['off']:.1f} ms without the checks, {ms['on']:.1f} ms with them "
            f"(x{ms['on'] / ms['off']:.2f}; medians of 2 in turns after the first steps); "
            f"first losses {losses}; the first forward's outputs bit-equal to the unchecked "
            f"step's: with the checks {forward_equal['on']}, the unchecked step again "
            f"{forward_equal['off_again']}; the parameters after the first step against the "
            f"unchecked step's: with the checks bit-equal {equal['on']}, largest gap "
            f"{gaps['on']:.3e} of a tensor's largest value; the unchecked step again bit-equal "
            f"{equal['off_again']}, {gaps['off_again']:.3e}")
        if not forward_equal["on"]:
            raise AssertionError(f"[checkify] the checked step's forward is not bit-equal to "
                                 f"the unchecked step's: {forward_equal}, losses {losses}")
        if not gaps["on"] <= max(2 * gaps["off_again"], 2.0 ** -22):
            raise AssertionError(f"[checkify] the checked step moved the parameters "
                                 f"otherwise: {gaps}")
        poisoned = {k: v.clone() for k, v in batch.items()}
        b, r, c, ch = CHECKIFY_POISON
        poisoned["image"][b, r, c, ch] = float("inf")
        try:
            checked_trainer.step_fn(poisoned, 0)
        except FloatingPointError as err:
            log(f"[checkify] the poisoned step raised FloatingPointError: {err}")
            message = str(err)
        else:
            raise AssertionError("[checkify] the step on a batch with an inf pixel raised "
                                 "nothing")
        if "aten." not in message:
            raise AssertionError(f"[checkify] the error names no op: {message}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    _check_no_kernel("checkify")
    out = {"off_ms": ms["off"], "on_ms": ms["on"], "bit_equal": equal["on"],
           "forward_bit_equal": forward_equal["on"],
           "unchecked_repeat_bit_equal": equal["off_again"], "gaps": gaps, "error": message}
    MEASURED["checkify"] = out
    return out


def _run_phase(name: str, tmp, card: str, *args):
    """Runs ``phase_<name>``, frees the allocator's cache and logs the
    phase's seconds."""
    t0 = time.perf_counter()
    fn = globals()[f"phase_{name}"]
    out = fn(tmp, card, *args) if fn.__code__.co_argcount else fn()
    torch.cuda.empty_cache()
    log(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default="", help="comma-separated phases to run "
                        "(development aid: prints no result lines)")
    parser.add_argument("--dist-worker", nargs=argparse.REMAINDER, default=None,
                        help="(internal) one rank of a world the dist phases start")
    parsed = parser.parse_args(argv)
    if parsed.dist_worker is not None:
        return dist_worker(parsed.dist_worker)
    only = [p for p in parsed.phases.split(",") if p]
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    if only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            for name in only:
                _run_phase(name, tmp, card)
        log(f"[done] phases {only} in {time.perf_counter() - t0:.1f} s; no result lines")
        return 0
    fwd = _run_phase("kernels", None, card)
    bwd = _run_phase("kernels_bwd", None, card)
    mb = _run_phase("kernels_mbconv", None, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        serve_launches = _run_phase("serve", tmp, card)
        train_fwd_launches, train_bwd_launches = _run_phase("train", tmp, card)
        eval_attn_launches = _run_phase("eval_attn", tmp, card)
        serve_attn_launches = _run_phase("serve_attn", tmp, card)
        deeplab_launches = _run_phase("train_deeplab", tmp, card)
        deeplab_launches += _run_phase("eval_deeplab", tmp, card)
        deeplab_launches += _run_phase("serve_deeplab", tmp, card)
        train_attn_launches, eval_attn_trained_launches = _run_phase("train_attn", tmp, card)
        fada_launches = _run_phase("train_fada_deeplab", tmp, card)
        fada_gald_fwd, fada_gald_bwd = _run_phase("train_fada_gald", tmp, card)
        fada_attn_launches = _run_phase("train_fada_attn", tmp, card)
        fada_launches += _run_phase("fada_vgg16", tmp, card)
        _run_phase("data_files", tmp, card)
        file_launches = _run_phase("train_fada_files", tmp, card)
        file_launches += _run_phase("saveres_cityscapes", tmp, card)
        file_launches += _run_phase("train_distill_files", tmp, card)
        bli_launches = _run_phase("train_attn_files", tmp, card)
        pranet_launches = _run_phase("train_pranet", tmp, card)
        pranet_launches += _run_phase("eval_pranet", tmp, card)
        pranet_launches += _run_phase("serve_pranet", tmp, card)
        pranet_launches += _run_phase("train_fada_pranet", tmp, card)
        online_launches = _run_phase("train_distill_online", tmp, card)
        online_gald_fwd, online_gald_bwd = _run_phase("train_distill_online_gald", tmp, card)
        online_polyp_launches = _run_phase("train_distill_online_polyp", tmp, card)
        device_aug_launches = _run_phase("device_aug", tmp, card)
        bf16_fwd, bf16_bwd = _run_phase("train_bf16", tmp, card)
        fada_bf16_launches = _run_phase("train_fada_bf16", tmp, card)
        online_bf16_fwd, online_bf16_bwd, online_bf16_fused = _run_phase(
            "distill_online_bf16", tmp, card)
        _run_phase("remat", tmp, card)
        quant_deeplab_launches = _run_phase("quant_deeplab", tmp, card)
        quant_gald_launches = _run_phase("quant_gald", tmp, card)
        quant_attn_launches = _run_phase("quant_attn", tmp, card)
        exported = _run_phase("export", tmp, card)
        inference_cli_launches = _run_phase("inference_cli", tmp, card)
        _run_phase("dist_deeplab", tmp, card)
        dist_gald_fwd, dist_gald_bwd = _run_phase("dist_gald_2rank", tmp, card)
        dist_eval_launches = _run_phase("dist_eval", tmp, card)
        _run_phase("async_ckpt", tmp, card)
        native_built = _run_phase("native_decode", tmp, card)
        recipe_fwd, recipe_bwd, recipe_mbconv = _run_phase("recipes_tpu", tmp, card, native_built)
        ccnet = _run_phase("ccnet", tmp, card)
        pretrained = _run_phase("pretrained", tmp, card)
        _run_phase("zoo_nets", tmp, card)
        rewrite_fwd, rewrite_bwd, rewrite_mbconv = _run_phase("rewrites", tmp, card)
        _run_phase("checkify", tmp, card)
    dist_launches = {"launches_dist_deeplab": 0, "launches_dist_eval": dist_eval_launches,
                     "launches_async_ckpt": 0, "launches_zoo_nets": 0, "launches_checkify": 0}
    quant_launches = {"launches_quant_deeplab": quant_deeplab_launches,
                      "launches_inference_cli": inference_cli_launches}
    kernels = [{
        "name": "cc_attention_fwd", "route": "cuda",
        "source": "rnd_semantic_segmentation_torch/ops/csrc/ccattn_fwd.cu",
        "replaces": "rnd_semantic_segmentation_tpu/ops/ccattn.py:54",
        "launches": (serve_launches + train_fwd_launches + fada_gald_fwd + online_gald_fwd
                     + bf16_fwd + online_bf16_fwd + quant_gald_launches + dist_gald_fwd
                     + recipe_fwd + ccnet["fwd"] + pretrained["fwd"] + rewrite_fwd),
        "launches_rewrites": rewrite_fwd,
        **dist_launches, "launches_dist_gald_2rank": dist_gald_fwd,
        "launches_recipes_tpu": recipe_fwd, "launches_ccnet": ccnet["fwd"],
        "launches_pretrained": pretrained["fwd"],
        **quant_launches, "launches_quant_gald": quant_gald_launches, "launches_quant_attn": 0,
        "launches_export_gald_call": exported["gald_float32"]["cc_launches"],
        "launches_serve": serve_launches, "launches_train": train_fwd_launches,
        "launches_deeplab": deeplab_launches, "launches_fada_gald": fada_gald_fwd,
        "launches_fada_deeplab": fada_launches, "launches_files": file_launches,
        "launches_pranet": pranet_launches, "launches_distill_online": online_launches,
        "launches_distill_online_gald": online_gald_fwd, "launches_distill_online_polyp": 0,
        "launches_device_aug": 0, "launches_train_bf16": bf16_fwd,
        "launches_fada_bf16": fada_bf16_launches, "launches_distill_online_bf16": online_bf16_fwd,
        "launches_remat": 0,
        **fwd[MAIN_CC_SHAPE, torch.float32],
        "library": "torch.nn.functional.scaled_dot_product_attention over H*W pixels with "
                   "the criss-cross mask",
        "shape": list(MAIN_CC_SHAPE),
        "at_train_shape": {**fwd[TRAIN_CC_SHAPE, torch.float32], "shape": list(TRAIN_CC_SHAPE)},
        "bf16": {**fwd[TRAIN_CC_SHAPE, torch.bfloat16], "shape": list(TRAIN_CC_SHAPE)},
        "at_ccnet_train_shape": {**ccnet["timed"]["train"]["fwd"],
                                 "max_abs_err": ccnet["fwd_err"],
                                 "shape": ccnet["timed"]["train"]["shape"]},
        "at_ccnet_eval_shape": {**ccnet["timed"]["eval"]["fwd"],
                                "shape": ccnet["timed"]["eval"]["shape"]},
    }, {
        "name": "cc_attention_bwd", "route": "cuda",
        "source": "rnd_semantic_segmentation_torch/ops/csrc/ccattn_bwd.cu",
        "replaces": "rnd_semantic_segmentation_tpu/ops/ccattn.py:124",
        "launches": (train_bwd_launches + fada_gald_bwd + online_gald_bwd + bf16_bwd
                     + online_bf16_bwd + dist_gald_bwd + recipe_bwd + ccnet["bwd"]
                     + pretrained["bwd"] + rewrite_bwd),
        "launches_rewrites": rewrite_bwd,
        **dist_launches, "launches_dist_gald_2rank": dist_gald_bwd,
        "launches_recipes_tpu": recipe_bwd, "launches_ccnet": ccnet["bwd"],
        "launches_pretrained": pretrained["bwd"],
        "launches_train": train_bwd_launches,
        "launches_deeplab": deeplab_launches, "launches_fada_gald": fada_gald_bwd,
        "launches_fada_deeplab": fada_launches, "launches_files": file_launches,
        "launches_pranet": pranet_launches, "launches_distill_online": online_launches,
        "launches_distill_online_gald": online_gald_bwd, "launches_distill_online_polyp": 0,
        "launches_device_aug": 0, "launches_train_bf16": bf16_bwd,
        "launches_fada_bf16": fada_bf16_launches, "launches_distill_online_bf16": online_bf16_bwd,
        "launches_remat": 0, **quant_launches, "launches_quant_gald": 0,
        "launches_quant_attn": 0, **bwd, "library_ms": None,
        "shape": list(TRAIN_CC_SHAPE),
        "at_ccnet_train_shape": {**ccnet["timed"]["train"]["bwd"], "library_ms": None,
                                 "max_abs_err": ccnet["bwd_err"],
                                 "shape": ccnet["timed"]["train"]["shape"]},
    }, {
        "name": "fused_mbconv_fwd", "route": "cuda",
        "source": "rnd_semantic_segmentation_torch/ops/csrc/mbconv_fwd.cu",
        "replaces": "rnd_semantic_segmentation_tpu/ops/mbconv.py:113",
        "launches": (eval_attn_launches + serve_attn_launches + fada_attn_launches
                     + bli_launches + online_polyp_launches + device_aug_launches
                     + online_bf16_fused + quant_attn_launches + recipe_mbconv
                     + rewrite_mbconv),
        "launches_rewrites": rewrite_mbconv,
        **dist_launches, "launches_dist_gald_2rank": 0, "launches_recipes_tpu": recipe_mbconv,
        "launches_ccnet": 0, "launches_pretrained": 0,
        **quant_launches, "launches_quant_gald": 0, "launches_quant_attn": quant_attn_launches,
        "launches_export_attn_call": exported["attn_float32"]["mbconv_launches"],
        "launches_eval_attn": eval_attn_launches,
        "launches_serve_attn": serve_attn_launches,
        "launches_deeplab": deeplab_launches,
        "launches_train_attn": train_attn_launches,
        "launches_eval_attn_trained": eval_attn_trained_launches,
        "launches_fada_attn": fada_attn_launches, "launches_fada_deeplab": fada_launches,
        "launches_files": file_launches, "launches_eval_bli": bli_launches,
        "launches_pranet": pranet_launches, "launches_distill_online": online_launches,
        "launches_distill_online_gald": 0,
        "launches_distill_online_polyp": online_polyp_launches,
        "launches_device_aug_eval_bli": device_aug_launches, "launches_train_bf16": 0,
        "launches_fada_bf16": fada_bf16_launches,
        "launches_distill_online_bf16": online_bf16_fused, "launches_remat": 0,
        **mb, "library_ms": None,
    }]
    log(f"[done] {time.perf_counter() - t0:.1f} s in all")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
