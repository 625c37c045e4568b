#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (yolov5_obb_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # run from the root of a checkout

Phases, each fatal on failure:
  (a) set-up: card name and power limit, torch/CUDA versions, build of the
      CUDA kernels from yolov5_obb_tpu_torch/csrc (one nvcc per source, in
      parallel), timed; for the tensor-core kernels (csrc/conv3x3_mma.cuh,
      the body of every 3x3 conv kernel; the stem+L1 kernel, the stem-only
      kernel and the train stem's forward on csrc/stem_mma.cuh; the C3
      kernel; the stem and downsample weight gradients; the 1x1 pass
      forward and backward) their
      registers and spill bytes from ptxas,
      which must be 0, and their tensor-core and global-load instructions
      from ``cuobjdump -sass``, which must hold HMMA; for the rotated-IoU
      kernels (the per-box records, the neighbour scan and pair stage, the
      pair IoU) their registers, stack frame and spills, which must be 0
      (the records keep sinf/cosf's stack frame; a library built before
      this run is compiled again for its ptxas lines);
  (b) each inference kernel against its plain PyTorch version on the card at
      the main path's shapes (bf16 convs; the stem+L1 kernel and the
      stem-only kernel at yolov5m b16 1024²; neighbour kernel at n =
      512/1024/2048 and on a clustered input that overflows M=64, its
      records' cover and area equal to the plain edge inputs bit for bit,
      the call's time beside the kernel's alone; the per-box records
      against their plain version; the pair-IoU kernel on the clustered
      input at n = 4096, bit for bit on repeat), with kernel / plain /
      library times and the bound from the bytes and operations of the
      shape (the rotated IoU's operations what this input needs, beside
      the design's count); the stem+L1, stem-only and C3 kernels also bit for bit on
      repeat, and beside the stem+L1 and stem-only kernels' bf16 library
      calls the same function with the stem in float32;
  (b') each train kernel (stem forward and weight gradient, downsample
      forward and weight gradient) against its plain version at the train
      path's shapes (the stem; the layer-1 and layer-3 downsamples), dW from
      autograd with a seeded cotangent, the same times and bounds; the
      stem's forward and weight gradient also bit for bit on repeat, and
      beside the forward's bf16
      library call the same function (the float32 conv, TF32 off);
  (c) the inference path: yolov5m, batch 16, 1024², conf 0.25, IoU 0.45,
      single-label, 2048 candidates, max_det 1500, random weights from a seed
      with the detection density tuned to ~300 dets/img; every inference
      kernel's launch count must move; the same path with the plain versions
      is the reference (keep masks on the same candidates, detections per
      image; the neighbour kernel on the same candidates, exact, and its
      call and kernel-alone times at the path's own tier and live rows);
      the forward with FUSED_C3_MIN_SPATIAL at its default (256²) and at
      128² (layer 4's C3(192, n = 4) on the kernel too), in turns;
  (d) the train path: yolov5m, batch 16, 1024², bf16, packed stem, random
      weights from a seed, SGD at nominal batch 16, two seeded batches of 64
      label slots with 8 live targets (tools/bench_train.py's recipe, CSL
      rows from the port's csl_gaussian_labels); 2 warm-up steps, 12 timed
      steps reading the loss every 4; train img/s, peak memory, a CUDA-event
      breakdown of one step, the train kernels' launches per step (stem 1+1,
      downsample 2+2, each BatchNorm + SiLU kernel once a train-mode conv
      block, 79), and loss and gradients against the same step on the
      plain versions, the BatchNorm kernels held apart against the chain
      (launched on the kernel step, not on the chain's); then the bn-half
      A/B: all of that again from the same weights under YOLO_BN_HALF=1
      (``--bn-half``; no BatchNorm kernel launched), its plain step
      under the flag too, its img/s and device time by group beside the
      float32 step's, its first step's loss items each within 5e-3 of the
      float32 step's loss and not all equal to them;
  (b") the fused train passes (1x1 forward and backward at the four 1x1
      structures of the C3 region, 3x3 s1 at the bottleneck, 3x3 s2 at
      down1 and down2) against their plain versions at the region's shapes,
      with bit-for-bit repeats of their statistics and weight gradients;
  (e) the fused train path: the same model, batches and timing as (d) with
      ``fused_train`` (layers 0-3 as the stat-carrying pass chain), its
      launches per step (stem 1+1, 3x3 s2 2, 1x1 4+4, 3x3 s1 2, downsample
      0, BatchNorm + SiLU 69), agreement with the same step on the plain
      versions, and loss items and running statistics against the stock
      step of phase (d);
  (f) the val path: phase (c)'s model through ``evaluate`` (multi-label,
      conf 0.01, IoU 0.4, 4096 candidates) on 48 seeded images whose labels
      are the plain path's conf-0.25 detections, against the plain run (mAP
      within 0.01, per-image detection counts within 1%, keep masks on the
      same candidates equal, at most 1% of the detections without a
      counterpart in the other run); ms/img of evaluate and of the predict
      calls, candidates per image and tiers; the iou-ordered NMS (pair-IoU
      kernel) on one batch's candidates and on clustered candidates whose
      rows overflow M, kernel against plain; the stem-only kernel on yolov5m
      with PACKED_L1=0 (the PACKED_L1 A/B) and on yolov5s-ghost, layer 0
      held to one bf16 ulp of its plain version on every batch and the
      detections to the plain path's;
  (g) the train CLI (``yolov5_obb_tpu_torch.train.main`` with real argv) at
      yolov5m, 1024², batch 16, bf16, nc 15, on a seeded mini-DOTA set of
      48 images written to a temporary directory (PNGs through
      utils/image_io.write_png, DOTA label files, a data.yaml) and replayed from the
      ``--cache shards`` cache, which the port's ``write_shards`` builds
      from an in-memory copy of the set (no OpenCV on the card): 2 stock
      epochs (the train kernels' launches per step, finite loss items,
      ``last/`` and ``best/`` with the model's anchors), ``--resume`` of
      ``last/`` for a third epoch (the saved step, EMA count and learning
      rate continue), one ``--fused-train`` epoch (its launches per
      step), then ``best/`` through ``load_weights`` and ``evaluate`` on
      phase (f)'s val set on the kernel path; img/s per epoch, the share
      of wall time waiting on the loader, checkpoint save and load ms and
      peak memory, measured through the CLI's callbacks;
  (h) the DOTA flow: four seeded raw images at DOTA-v1.0 sizes (4000²,
      4000x3000, 3000x2000, 1900x1500; noise with filled boxes, ~40 objects
      a megapixel over the 15 DOTA-v1.0 classes, boxes across tile corners
      whose clips keep 6 points) split in memory into 63 tiles of 1024² at
      gap 200 (devkit/img_split, no OpenCV; the minimum-area rectangle,
      OpenCV 5.0's steps in native/min_area_rect.cpp, must run); the
      oracle round trip (tile labels → Task1 → polygon-NMS merge → OBB mAP > 0.95 and mAOE < 5° against the unsplit
      labels); phase (c)'s density-tuned model through ``evaluate`` on the
      tiles in the val regime with ``save_json``, then json_to_task1, the
      8-worker merge, ``evaluate_task1`` and ``evaluate_maoe``, kernel run
      against plain run (merged counts within 1%, at most 1% of the merged
      detections without a same-class counterpart at polygon IoU > 0.99;
      rows 1-4 launched); ``evaluate`` alone in turns (kernel, plain,
      kernel, plain); the merge with 1 worker writing the same text, the
      native and NumPy polygon NMS keeping the same rows on the largest
      class file (the NumPy run capped to the top NUMPY_NMS_ROWS rows; the
      native library must load); each step timed;
  (i) the detect surface: 16 seeded PNGs (12 at 1024², 4 at 1024x768;
      phase (h)'s noise and boxes, rows filtered by the five PNG filters in
      turn) in a temporary directory, read by utils/image_io (no OpenCV;
      its decode timed, native and NumPy); phase (c)'s density-tuned
      yolov5m and a second one from seed 1, saved with utils/checkpoint;
      (i1) ``detect.main`` in bf16 (rows 1-3 once an image, row 4 at least
      once) against the same letterboxed inputs through the plain predict,
      written by the CLI's own line writer (per-image counts within 1%, at
      most 1% of the detections without a same-class counterpart); (i2)
      ``--augment`` and (i3) ``--weights W1,W2`` in float32 at max_det
      3000 (row 4 launched; on the same candidates the keep masks equal
      the plain NMS's; detections per image equal the plain run's); (i4)
      ``api.load`` in bf16 on the 16 arrays and the 16 paths (equal), against
      the plain predict (phase (f)'s bars); (i5) ``serve`` in-process on
      127.0.0.1: 4 client threads POST the 16 PNGs 4 times, every reply 200
      and within phase (f)'s bars of the API's rows, a junk body 400;
      each step's seconds, the CLIs' printed speeds, serve latency and
      batch sizes, peak memory;
  (j) the model zoo: (j1) each of the 21 bundled configs at its published
      width, nc 15, bf16, packed stem where its stem is Conv(6, 2),
      density-tuned random weights from a seed, strides probed, one
      single-label predict of 2 images at 256² (the C3 and downsample gates
      scaled with the image to 64², so layers 2 and 3 take their kernels
      as at 1024²) against its plain run: the kernels that the model's
      layers call for launched and no other (rows 1-3 in every yolov5
      config but yolov5s-ghost, whose stem runs on row 6; none in yolov3;
      row 4 in all), the Detect maps within row 2's 0.06 or one bf16 ulp
      of their scale, 0 keep-mask mismatches, phase (c)'s bar on the
      detections; (j2) yolov5m6 at 1280², b16, phase (c)'s regime, against
      its plain run (the same bars, detections within 1%), img/s and peak
      memory; (j3) a yolov5m6 train step at 1280², b16 if phase (d)'s
      peak times (1280/1024)² is under 60 GiB (else 8), against the plain
      step (phase (d)'s bars), stem 1+1, downsample 2+2 and BatchNorm +
      SiLU 103 launches a step, img/s and peak memory; (j4)
      yolov5s-transformer b16 at 1024² (C3TR over 32x32 tokens) as (j2);
  (k) the golden flow (OpenCV must import; its version and matplotlib's
      presence printed): (k1) ``tools/golden_e2e.run_flow`` at the JAX
      nightly's setting (4 raw PNGs at 640² → 16 tiles of 384 at gap 128,
      the train CLI from the tiles: yolov5n float32 at 128², 250 epochs,
      batch 8, lr0 0.025, mosaic, flips, affine, HSV, autoanchor; the val
      CLI with ``--save-json``, the merge at 0.2, the OBB mAP and mAOE),
      held to the nightly's floors (merged OBB mAP >= 0.12, HBB mAP50 >=
      0.13, 0 < mAOE <= 55°), the kernels the gates allow launched and no
      other (with the BatchNorm + SiLU train kernels), train img/s over
      the run and per epoch, first-batch wait, val ms per tile, each
      stage's seconds; (k2) the committed golden yolov5n
      (releases/golden_yolov5n_192_torch) on the 90 tiles of its own
      training set through the val CLI at 192, merged and scored, in
      float32 (row 4) and bfloat16 (rows 1 and 4), each kernel run within
      0.01 of the JAX package's merged OBB mAP and HBB mAP50 and 0.5° of
      its mAOE (PERF.md, the golden flow), each against the same CLI on the plain
      versions (phase (f)'s bars on the tiles' detections, phase (h)'s on
      the merged rows, equal confusion matrices; in bfloat16 the stem+L1
      kernel's differing outputs within a fixed budget, and the unmatched
      and moved shares within the largest of six one-ulp controls of the
      stem+L1 output at that budget), the five
      val plots where matplotlib imports, and ``--task study`` at 128,
      160, 192 (three rows, 192's mAP50 the val run's).
  (l) scale-out and training support: (l1) phase (d)'s shape and seed-0
      weights and batches, cuDNN deterministic, three steps of the stock
      and of the fused step without remat, again (the repeat), with full
      and with selective remat: loss items, parameters and BN running
      statistics against the run without remat, bit for bit where the
      repeat is, else within the repeat's difference; peak memory, img/s
      and the train kernels' launches (full remat: every forward kernel
      twice a step); (l2 i) the data-parallel stock and fused steps in a
      world of one through NCCL against (l1)'s, by the same bar (the
      BatchNorm kernels' two finalizes twice a block, around the sum); (l2 ii)
      two processes on the card through gloo (``--dp-worker``), 8 rows a
      rank, three stock and three fused steps against (l1)'s one-process
      steps (the first step's loss items within 1e-2; after updates the
      items within 1e-2 or a one-ulp control's difference, the parameter
      moves no less aligned than the control's), the ranks' parameters
      and statistics bit for bit, and in float32 at yolov5n 256² b4 with the
      stock stem (loss within 2e-4, parameter moves within 2e-2 of the
      largest), also under full remat; (l2 iii) the train CLI in those two
      processes for one epoch on a seeded shard set (yolov5n 512² b8, 15
      images, val on rank 0): rank 0 alone writes ``results.csv``,
      ``last/`` and ``best/``, each rank takes 15 // 8 steps, the ranks
      end with the same parameters; the times are of one shared
      card; (l3) ``--evolve 2`` at yolov5n 256² b4: ``evolve.csv``'s two
      rows, generation 0's hyps ``mutate``'s re-run here.
  (m) export and the exported-model backend: (m1) phase (c)'s
      density-tuned weights exported by ``export.build_forward`` and
      ``export_pt2`` (yolov5m 1024², float32, TF32 off; timed) and loaded
      through ``models/backend.MultiBackend``: at batch 16 and 8 (traced
      at 2) bit for bit the eager float32 forward; (m2) ``make_backend_predict_fn`` on phase (c)'s three
      batches (row 4 launched, 0 keep-mask mismatches against the plain
      NMS on the same candidates), its ms/img beside the eager float32
      predict's; (m3) the val CLI from the .pt2 and from the float32
      checkpoint on phase (f)'s 48 images labelled by the float32 model's
      own conf-0.25 detections and written as files, and ``evaluate`` of
      that set in memory (mAP within 1e-4 of each other, mAP50 above
      0.05; the float32 model on phase (f)'s bf16 labels recorded beside
      them), ``--task speed`` from the .pt2, the detect CLI from both on
      phase (i)'s PNGs (the same label rows); (m4) ``evaluate(mesh=)``
      on the packed bf16 path, cuDNN deterministic (rows 1-4 launched):
      an NCCL world of one bit for bit the run without a mesh, two gloo
      processes on the card at global batch 16 (each loading, predicting
      and matching its own rows) bit for bit one process at batch 8, the
      ms/img of each run recorded; (m6) ``utils/profiler.trace`` of three packed predicts
      naming the stem+L1, C3, downsample, records and neighbour kernels,
      ``model_info``'s GFLOPs of yolov5m b16 1024² and the packed bf16
      forward's achieved TFLOP/s; (m5) ``autobatch_cuda`` for the packed
      bf16 train step at 1024² (probed through the step's loss) beside
      the analytic ``autobatch``, and one
      train step at its batch under 0.85 of the card's memory; (m7) the
      port's hubconf through ``torch.hub.load`` on the card.

Prints a ``kernels`` JSON line, the card line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or outside a checkout.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
# Hopper: 128 float32 lanes per SM, each one scalar operation a cycle; the
# rotated IoU (-fmad=false, divisions, compares and selects) has no
# multiply-add to pair, so its rate is this, not PEAK_FP32's FMA count
LANES_PER_SM = 128
# scalar operations of the rotated IoU that the function needs, counted
# from ops/rotated_iou.pairs_iou_records: an IEEE division as DIV_OPS and
# cosf + sinf of one angle as TRIG_OPS, their fast paths in SASS
# (tools/riou_sass_ops.py on the card: 10 and 52)
DIV_OPS, TRIG_OPS = 10, 52
# one pair from two records, whatever its ring: midpoint and corners 40, the
# 16 crossings and their two-per-edge selection 560 + 32 divisions, the
# inside tests 264, the centroid 51 + 1, the IoU 3 + 1 ...
IOU_FIXED_OPS = 918 + 34 * DIV_OPS
# ... and, for a ring of m >= 3 points only (ring_ops), each point's
# pseudo-angle 8 + 1 division and shoelace term 3, and the m keys' order by
# the fewest comparators known for m keys, a min and a max each (the points
# follow their index: no payload moved)
RING_POINT_OPS = 8 + DIV_OPS + 3
SORT_COMPARATORS = (0, 0, 1, 3, 5, 9, 12, 16, 19, 25, 29, 35, 39, 45, 51, 56,
                    60)
# what csrc/rotated_iou.cuh executes a pair, for comparison (not a bound):
# the fixed work, then all 16 slots' pseudo-angles 128 + 16 divisions, the
# 63 compare-exchanges of its Batcher network moving key, index, x and y
# (12 each) 756, the shoelace over 16 slots with selects 130
IOU_DESIGN_OPS = 1932 + 50 * DIV_OPS
# one box's record: the trig, the half vectors 9 and the area 1 (what the
# pair IoU needs of a box), then the cover 14 (the neighbour scan's)
PAIR_BOX_OPS = 10 + TRIG_OPS
BOX_OPS = PAIR_BOX_OPS + 14
# one edge test of the neighbour scan: flag and class 2, the covers'
# intersection 9, the capped area 3
EDGE_OPS = 14

BATCH, IMGSZ, MAXC, MAX_DET = 16, 1024, 2048, 1500
CONF, IOU = 0.25, 0.45
DENSITY = 300  # target dets/img for the density bisection
# the val path (val.py's regime): multi-label, conf 0.01, IoU 0.4, 4096
# candidates; 48 seeded images in three batches, <= 100 labels each
VAL_CONF, VAL_IOU, VAL_MAXC, VAL_IMAGES, VAL_LABELS = 0.01, 0.4, 4096, 48, 100
VAL_MAP_FLOOR = 0.05  # (f), (m3): the least val mAP50 on self-made labels
# train path (tools/bench_train.py): label slots, live targets, timed steps
MAX_LABELS, LIVE, TRAIN_ITERS, SYNC_EVERY = 64, 8, 12, 4
# the train kernels' launches per train step at yolov5m 1024²
TRAIN_LAUNCHES = {"stem_train_fwd": 1, "stem_train_wgrad": 1,
                  "down_train_fwd": 2, "down_train_wgrad": 2}
# ... and per fused train step (layers 0-3 as the pass chain)
FUSED_LAUNCHES = {"stem_train_fwd": 1, "stem_train_wgrad": 1,
                  "pass_3x3s2": 2, "pass_1x1_fwd": 4, "pass_1x1_bwd": 4,
                  "pass_3x3s1": 2, "down_train_fwd": 0, "down_train_wgrad": 0}
# the train-mode BatchNorm + SiLU kernels (ops/kernels/bn_act_train.py) and
# the train-mode conv blocks a step that launch them: yolov5m, yolov5m with
# the fused train region (which has its own BatchNorm), yolov5m6
BN_ACT_KERNELS = ("bn_act_stats", "bn_act_fwd_finalize", "bn_act_fwd",
                  "bn_act_bwd", "bn_act_bwd_finalize", "bn_act_dz")
BN_BLOCKS = {"yolov5m": 79, "yolov5m_fused": 69, "yolov5m6": 103}
# the train CLI (phase g): seeded images, pre-augmented variants each, stock
# epochs, the resumed epoch
CLI_IMAGES, CLI_AUG_EPOCHS, CLI_EPOCHS = 48, 2, 2
# the libraries holding tensor-core kernels → the substrings of those
# kernels' names: the 3x3 conv body (csrc/conv3x3_mma.cuh), the stem+L1
# kernel, the stem-only kernel and the train stem's forward
# (csrc/stem_mma.cuh), the C3 kernel, the stem and downsample weight
# gradients, the 1x1 pass forward and backward (csrc/mma.cuh's helpers)
MMA_SOURCES = {"down": ("conv3x3_mma",),
               "stem_l1": ("stem_l1_kernel",),
               "stem": ("stem_kernel",),
               "c3": ("c3_kernel",),
               "stem_train": ("stem_fwd_kernel", "stem_wgrad_kernel"),
               "down_train": ("conv3x3_mma", "down_wgrad_kernel"),
               "train_fused_3x3": ("conv3x3_mma",),
               "train_fused_1x1": ("p1x1_fwd_kernel", "p1x1_bwd_kernel")}
MMA_KERNELS = tuple(dict.fromkeys(n for names in MMA_SOURCES.values()
                                  for n in names))
# float32 operations per activated element: silu(z·g + b) forward; the
# recomputed activation, silu' and the products of the backward
ACT_OPS, DACT_OPS = 5, 12
# seconds between the profiler's warm-up call and the recorded one
PROFILE_PAUSE_S = 0.05


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def with_bn_act(expected, blocks, mesh=False) -> dict:
    """``expected`` launches a step and the BatchNorm + SiLU kernels' for
    ``blocks`` train-mode conv blocks: each once a block (none where the
    BatchNorm runs in bfloat16, ``YOLO_BN_HALF=1``); under a
    data-parallel mesh the two finalizes twice (around the ranks' sum)."""
    import torch

    from yolov5_obb_tpu_torch.models.layers import bn_dtype

    if bn_dtype() != torch.float32:
        blocks = 0
    fin = ("bn_act_fwd_finalize", "bn_act_bwd_finalize")
    return {**expected, **{n: blocks * (2 if mesh and n in fin else 1)
                           for n in BN_ACT_KERNELS}}


def require(cond, msg) -> None:
    """A phase's check: raises (and so fails the run) when ``cond`` is
    false; unlike ``assert`` it holds under ``python -O`` too."""
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_entries(text: str) -> dict:
    """Kernel name → (registers, stack frame bytes, spill store bytes, spill
    load bytes) from an ``nvcc -Xptxas -v`` log."""
    out, name, frame = {}, None, (None, None, None)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, frame = m.group(1), (None, None, None)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *frame)
            name = None
    return out


def sass_counts(lib: str, match):
    """Kernel name → counts of tensor-core (HMMA/HGMMA), cp.async
    (LDGSTS), shared-matrix (LDSM) and other global-load (LDG) instructions
    in the SASS of ``lib``, for the kernels whose name holds one of the
    substrings ``match``; None where ``cuobjdump`` is absent."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            cur = out.setdefault(name, dict.fromkeys(
                ("HMMA", "HGMMA", "LDGSTS", "LDSM", "LDG"), 0)) \
                if any(m in name for m in match) else None
        elif cur is not None:
            op = re.search(r"\b(HGMMA|HMMA|LDGSTS|LDSM|LDG)\b", line)
            if op:
                cur[op.group(1)] += 1
    return out


def mma_report(build) -> dict:
    """Registers, spills and SASS counts of the tensor-core kernels (ptxas
    speaks only when this run compiled the library)."""
    rep = {}
    for src, names in MMA_SOURCES.items():
        if src not in build.PTXAS_LOG:
            rep[src] = "built before this run: no ptxas log"
            continue
        regs = {k: v for k, v in ptxas_entries(build.PTXAS_LOG[src]).items()
                if any(n in k for n in names)}
        sass = sass_counts(str(build.so_path(src)), names)
        rep[src] = {k: {"registers": r, "stack_frame": sf, "spill_stores": ss,
                        "spill_loads": sl,
                        "sass": "not available" if sass is None
                        else sass.get(k, "not found")}
                    for k, (r, sf, ss, sl) in regs.items()}
    return rep


# the rotated-IoU libraries → their kernels: scalar float32 code whose
# candidate ring must live in registers (no stack frame, no spills); the
# records' only stack frame is sinf/cosf's range reduction for |angle| >=
# 105615, which no box angle reaches (tools/riou_sass_ops.py)
RIOU_SOURCES = {"riou_boxes": ("riou_boxes_kernel",),
                "neighbor": ("neighbor_scan_kernel", "neighbor_iou_kernel"),
                "pairs_iou": ("riou_pairs_kernel",)}
RIOU_STACK_FREE = ("neighbor", "pairs_iou")


def riou_report(build) -> dict:
    """Registers, stack frame and spills of the rotated-IoU kernels, from
    this run's ptxas log; a library built before this run is compiled again
    (into a temporary directory of the build directory) for its log."""
    import tempfile

    logs = {src: build.PTXAS_LOG[src] for src in RIOU_SOURCES
            if src in build.PTXAS_LOG}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
        procs = {src: subprocess.Popen(
            [build._nvcc(), *build._flags(src), "-I", str(build.CSRC_DIR),
             "-o", f"{d}/{src}.so", str(build.CSRC_DIR / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in RIOU_SOURCES if src not in logs}
        for src, proc in procs.items():
            logs[src] = proc.communicate()[0]
            require(proc.returncode == 0,
                    f"nvcc {src}.cu for its ptxas lines failed:\n{logs[src]}")
    return {src: {k: dict(zip(("registers", "stack_frame", "spill_stores",
                               "spill_loads"), v))
                  for k, v in ptxas_entries(logs[src]).items()
                  if any(n in k for n in names)}
            for src, names in RIOU_SOURCES.items()}


def lane_rate() -> float:
    """Scalar float32 operations per second of this card: one per lane per
    cycle at its maximum SM clock."""
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * LANES_PER_SM * mhz * 1e6


def cuda_time(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events around ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_cycle(run, activities=None):
    """``torch.profiler``'s averages (``key_averages()``) over one call of
    ``run``, recorded after an unrecorded warm-up call and a pause: CUPTI
    can lose the first kernels of a session, and those of a recording
    begun straight after its warm-up (the train step's stem forward was
    lost so).  The schedule's ``ProfilerStep*`` range, which the trace
    also files as device time, is left out."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    cycles = []
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "clears events at each cycle"
        with profile(activities=activities or [ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: cycles.append(
                         p.key_averages())) as prof:
            for i in range(2):
                if i:
                    time.sleep(PROFILE_PAUSE_S)
                run()
                torch.cuda.synchronize()
                prof.step()
    require(len(cycles) == 1, f"profiled {len(cycles)} cycles, not 1")
    return [e for e in cycles[0] if not e.key.startswith("ProfilerStep")]


def profiled_ms(fn, iters: int = 10) -> float:
    """Mean device ms per call of the kernels ``fn`` launches, from the
    profiler: for a call shorter than its own enqueue, where CUDA events
    around back-to-back calls time the host."""
    import torch

    def run():
        for _ in range(iters):
            fn()

    return sum(e.self_device_time_total for e in profile_cycle(run)
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / iters


def bound(nbytes: float, *work):
    """Least time in ms for moving ``nbytes`` and doing ``work``, pairs of
    (operations, peak rate of their type), with what bounds it."""
    t_ops = sum(ops / peak for ops, peak in work) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# (b) each kernel against its plain version
# ---------------------------------------------------------------------------


def conv_weights(gen, co, ci, k, dev):
    import torch

    w = torch.randn(co, ci, k, k, generator=gen, device=dev)
    return w / (ci * k * k) ** 0.5


def bn_stats(gen, c, dev):
    import types

    import torch

    r = lambda lo, hi: lo + (hi - lo) * torch.rand(c, generator=gen, device=dev)
    return types.SimpleNamespace(weight=r(0.5, 1.5), bias=r(-0.2, 0.2),
                                 running_mean=r(-0.3, 0.3),
                                 running_var=r(0.5, 2.0))


def check_stem(gen, dev):
    import torch
    import torch.nn.functional as F

    from yolov5_obb_tpu_torch.ops.kernels import stem_kernel as S

    c2, c3 = 48, 96
    x = torch.randint(0, 256, (BATCH, IMGSZ, IMGSZ * 3), generator=gen,
                      device=dev, dtype=torch.uint8)
    ops = S.fold_stem_l1_params(conv_weights(gen, c2, 3, 6, dev),
                                bn_stats(gen, c2, dev),
                                conv_weights(gen, c3, c2, 3, dev),
                                bn_stats(gen, c3, dev))
    got = S.fused_stem_l1(x, *ops)
    want = S.fused_stem_l1_plain(x, *ops)
    repeat = torch.equal(got, S.fused_stem_l1(x, *ops))
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    k0f = ops[0].reshape(6, 6, 3, c2).permute(3, 2, 0, 1).contiguous()
    k0 = k0f.to(torch.bfloat16)
    k1 = ops[2].reshape(3, 3, c2, c3).permute(3, 2, 0, 1)
    xb = x.view(BATCH, IMGSZ, IMGSZ, 3).permute(0, 3, 1, 2)

    def library():  # the same two convs (+ SiLU) through cuDNN in bf16
        s = F.silu(F.conv2d(xb.to(torch.bfloat16), k0, ops[1].bfloat16(), 2, 2))
        return F.silu(F.conv2d(s, k1, ops[3].bfloat16(), 2, 1))

    def library_f32():  # the same function: the stem in float32 (no TF32)
        s = F.silu(F.conv2d(xb.float(), k0f, ops[1], 2, 2)).to(torch.bfloat16)
        return F.silu(F.conv2d(s, k1, ops[3].bfloat16(), 2, 1))

    # the stem multiplies uint8 values by float32 weights, here as three
    # bf16 products on the tensor cores; layer 1 multiplies bf16
    # activations by bf16 weights
    hs = IMGSZ // 2
    f_stem = 2 * BATCH * hs * hs * 108 * c2
    f_l1 = 2 * BATCH * (hs // 2) ** 2 * 9 * c2 * c3
    flops = f_stem + f_l1
    nbytes = x.numel() + got.numel() * 2
    return "stem_l1", S.KERNEL, {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / want.float().abs().clamp(min=1e-2)).max()),
        "repeat_bitwise": repeat,
        "tolerance": "bf16: 1 ulp of the output, abs <= 0.05; repeats bit "
                     "for bit",
        "ok": float(err.max()) <= 0.05 and repeat,
        "ms": cuda_time(lambda: S.fused_stem_l1(x, *ops), 5),
        "plain_ms": cuda_time(lambda: S.fused_stem_l1_plain(x, *ops), 3),
        "library_ms": cuda_time(library, 5),
        "library_f32_ms": cuda_time(library_f32, 5),
        "bound": bound(nbytes, (3 * f_stem, PEAK_BF16), (f_l1, PEAK_BF16)),
        "flops": flops, "bytes": nbytes,
    }


def check_stem_only(gen, dev):
    """The stem alone (fused_stem: layer 0 of a model whose layer 1 cannot
    join it) at the yolov5m shape."""
    import torch
    import torch.nn.functional as F

    from yolov5_obb_tpu_torch.ops.kernels import stem_kernel as S

    c2 = 48
    x = torch.randint(0, 256, (BATCH, IMGSZ, IMGSZ * 3), generator=gen,
                      device=dev, dtype=torch.uint8)
    w0, b0 = S.fold_stem_params(conv_weights(gen, c2, 3, 6, dev),
                                bn_stats(gen, c2, dev))
    got = S.fused_stem(x, w0, b0)
    want = S.fused_stem_plain(x, w0, b0)
    repeat = torch.equal(got, S.fused_stem(x, w0, b0))
    torch.cuda.synchronize()
    err, tol = _ulp_err(got, want)
    k0f = w0.reshape(6, 6, 3, c2).permute(3, 2, 0, 1).contiguous()
    k0 = k0f.to(torch.bfloat16)
    xn = x.view(BATCH, IMGSZ, IMGSZ, 3).permute(0, 3, 1, 2)
    xb = xn.to(torch.bfloat16)

    def library():  # the same conv (+ bias, SiLU) through cuDNN in bf16
        return F.silu(F.conv2d(xb, k0, b0.bfloat16(), 2, 2))

    def library_f32():  # the same function: the conv in float32 (no TF32)
        return F.silu(F.conv2d(xn.float(), k0f, b0, 2, 2)).to(torch.bfloat16)

    # uint8 values times float32 weights, run as three bf16 products on
    # the tensor cores
    hs = IMGSZ // 2
    flops = 2 * BATCH * hs * hs * 108 * c2
    nbytes = x.numel() + got.numel() * 2
    return "stem", S.STEM_KERNEL, {
        "max_abs_err": err,
        "repeat_bitwise": repeat,
        "tolerance": f"bf16: one ulp of the largest output, abs <= {tol:.4g}"
                     f"; repeats bit for bit",
        "ok": err <= tol and repeat,
        "ms": cuda_time(lambda: S.fused_stem(x, w0, b0), 5),
        "plain_ms": cuda_time(lambda: S.fused_stem_plain(x, w0, b0), 3),
        "library_ms": cuda_time(library, 5),
        "library_f32_ms": cuda_time(library_f32, 5),
        "bound": bound(nbytes, (3 * flops, PEAK_BF16)), "flops": flops,
        "bytes": nbytes,
    }


def check_c3_operands(gen, dev, c, n, H):
    """A seeded C3(c, c, n) at ``H``² (batch BATCH): x, the kernel's
    operands, and the library call (the same convs through cuDNN in bf16)."""
    import torch
    import torch.nn.functional as F

    from yolov5_obb_tpu_torch.models.layers import C3
    from yolov5_obb_tpu_torch.ops.kernels import c3_kernel as K

    c_ = c // 2
    m = C3(c, c, n).to(dev)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.Conv2d):
                co, ci, k, _ = mod.weight.shape
                mod.weight.copy_(conv_weights(gen, co, ci, k, dev))
            elif isinstance(mod, torch.nn.BatchNorm2d):
                st = bn_stats(gen, mod.num_features, dev)
                for a in ("weight", "bias", "running_mean", "running_var"):
                    getattr(mod, a).copy_(getattr(st, a))
    p = K.fold_c3_params(m)
    x = torch.randn(BATCH, H, H, c, generator=gen, device=dev).to(torch.bfloat16)

    def conv(t, w, ss, pad=0):  # NCHW channels-last bf16 conv + folded BN + SiLU
        y = F.conv2d(t, w.permute(3, 2, 0, 1), padding=pad)
        return F.silu(y * ss[0, :, None, None].bfloat16()
                      + ss[1, :, None, None].bfloat16())

    def library():
        xt = x.permute(0, 3, 1, 2)
        cur = conv(xt, p["w1"][None, None], p["s1"])
        for k in range(n):
            h = conv(cur, p["wa"][k][None, None], p["sa"][k])
            cur = cur + conv(h, p["wt"][k].reshape(3, 3, c_, c_), p["st"][k], 1)
        c2c = conv(xt, p["w2"][None, None], p["s2"])
        w3 = torch.cat([p["w3a"], p["w3b"]])[None, None]
        return conv(torch.cat([cur, c2c], 1), w3, p["s3"])

    return x, p, library


def check_c3(gen, dev):
    import torch

    from yolov5_obb_tpu_torch.ops.kernels import c3_kernel as K

    c, n, H = 96, 2, IMGSZ // 4
    c_ = c // 2
    x, p, library = check_c3_operands(gen, dev, c, n, H)
    got = K.fused_c3(x, p)
    want = K.fused_c3_plain(x, p)
    repeat = torch.equal(got, K.fused_c3(x, p))
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()

    macs = c * c_ + n * (c_ * c_ + 9 * c_ * c_) + c * c_ + 2 * c_ * c
    flops = 2 * BATCH * H * H * macs
    # one scale, shift and SiLU (ACT_OPS float32 operations) per conv
    # output; with the n-pixel halo the kernel recomputes around each 8x16
    # tile, cv1 and bottleneck k's 1x1 fill the tile grown by n - k + 1
    # pixels a side, its 3x3 by n - k
    grown = lambda e: (8 + 2 * e) * (16 + 2 * e) / 128
    acts = c_ + n * 2 * c_ + c_ + c
    acts_halo = (c_ * grown(n) + sum(c_ * (grown(n - k + 1) + grown(n - k))
                                     for k in range(1, n + 1)) + c_ + c)
    nbytes = 2 * x.numel() * 2
    # the products (tensor cores) and the activations (float32 pipe) run on
    # separate units and overlap: the floor is the larger of the two
    t_products = flops / PEAK_BF16 * 1e3
    t_acts = BATCH * H * H * acts * ACT_OPS / PEAK_FP32 * 1e3
    return "c3", K.KERNEL, {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / want.float().abs().clamp(min=1e-2)).max()),
        "repeat_bitwise": repeat,
        "tolerance": "bf16 rounding of the intermediates, abs <= 0.06; "
                     "repeats bit for bit",
        "ok": float(err.max()) <= 0.06 and repeat,
        "ms": cuda_time(lambda: K.fused_c3(x, p), 5),
        "plain_ms": cuda_time(lambda: K.fused_c3_plain(x, p), 3),
        "library_ms": cuda_time(library, 5),
        "bound": max(bound(nbytes, (flops, PEAK_BF16)),
                     (t_acts, "operations")),
        "bound_products_ms": t_products, "bound_activations_ms": t_acts,
        "flops": flops, "bytes": nbytes,
        "silu_per_px": acts, "silu_per_px_with_halo": acts_halo,
    }


def check_down(gen, dev):
    import torch
    import torch.nn.functional as F

    from yolov5_obb_tpu_torch.ops.kernels import down_kernel as D

    ci, co, H = 96, 192, IMGSZ // 4
    w = conv_weights(gen, co, ci, 3, dev)
    st = bn_stats(gen, co, dev)
    import types

    wt, ss = D.fold_down_params(types.SimpleNamespace(weight=w), st)
    x = torch.randn(BATCH, H, H, ci, generator=gen, device=dev).to(torch.bfloat16)
    got = D.fused_down(x, wt, ss)
    want = D.fused_down_plain(x, wt, ss)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    wb = w.to(torch.bfloat16)
    xt = x.permute(0, 3, 1, 2)

    def library():
        y = F.conv2d(xt, wb, stride=2, padding=1)
        return F.silu(y * ss[0, :, None, None].bfloat16()
                      + ss[1, :, None, None].bfloat16())

    flops = 2 * BATCH * (H // 2) ** 2 * 9 * ci * co
    nbytes = x.numel() * 2 + got.numel() * 2
    return "down", D.KERNEL, {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / want.float().abs().clamp(min=1e-2)).max()),
        "tolerance": "bf16: 1 ulp of the output, abs <= 0.05",
        "ok": float(err.max()) <= 0.05,
        "ms": cuda_time(lambda: D.fused_down(x, wt, ss), 5),
        "plain_ms": cuda_time(lambda: D.fused_down_plain(x, wt, ss), 3),
        "library_ms": cuda_time(library, 5),
        "bound": bound(nbytes, (flops, PEAK_BF16)), "flops": flops,
        "bytes": nbytes,
    }


def _grad_check(fn, x, w, gen, plain_kw):
    """Forward of ``fn`` on the kernel path and the plain path, and the
    gradients of ``Σ z·cot`` (seeded non-uniform cotangent) w.r.t. ``x``
    (when it takes one) and ``w``."""
    import torch

    out = {}
    cot = None
    for name, kw in (("kernel", {}), ("plain", plain_kw)):
        z = fn(x, w, **kw)
        if cot is None:
            cot = torch.randn(z.shape, generator=gen, device=z.device)
        wrt = (x, w) if x.requires_grad else (w,)
        out[name] = (z.detach(), torch.autograd.grad(
            (z.float() * cot).sum(), wrt))
    torch.cuda.synchronize()
    return out


def _train_results(fwd, wgrad, got, flops, fwd_work, fwd_bytes, wgrad_bytes,
                   times):
    """Per-kernel result dicts of a forward/weight-gradient pair: both do
    ``flops`` operations, the forward as the (operations, peak rate) pairs
    ``fwd_work`` it runs, the weight gradient on bf16 operands."""
    (zk, gk), (zp, gp) = got["kernel"], got["plain"]
    f_err = float((zk.float() - zp.float()).abs().max())
    f_tol = float(zp.float().abs().max()) / 128
    w_err = float((gk[-1] - gp[-1]).abs().max())
    w_tol = 2e-2 * float(gp[-1].abs().max())
    return {
        fwd: {"max_abs_err": f_err, "ok": f_err <= f_tol,
              "tolerance": f"bf16: one ulp of the largest output, abs <= "
                           f"{f_tol:.4g}",
              "bound": bound(fwd_bytes, *fwd_work),
              "flops": flops, "bytes": fwd_bytes, **times[0]},
        wgrad: {"max_abs_err": w_err, "ok": w_err <= w_tol,
                "tolerance": f"2e-2 * max|dW| = {w_tol:.4g} (bf16 products, "
                             f"float32 sums in another order)",
                "bound": bound(wgrad_bytes, (flops, PEAK_BF16)),
                "flops": flops, "bytes": wgrad_bytes, **times[1]},
    }


def check_stem_train(gen, dev):
    import torch
    import torch.nn.functional as F

    from yolov5_obb_tpu_torch.ops.kernels import stem_kernel as S

    c2 = 48
    x = torch.randint(0, 256, (BATCH, IMGSZ, IMGSZ * 3), generator=gen,
                      device=dev, dtype=torch.uint8)
    w = (conv_weights(gen, c2, 3, 6, dev) / 255.0).requires_grad_()
    got = _grad_check(S.stem_conv_train, x, w, gen, {"plain": True})
    dz = got["kernel"][0]  # any bf16 tensor of dz's shape
    wd = w.detach()
    repeat = torch.equal(dz, S.stem_train_fwd(x, wd))
    dw = S.stem_train_wgrad(x, dz)
    w_repeat = torch.equal(dw, S.stem_train_wgrad(x, dz))
    xn = x.view(BATCH, IMGSZ, IMGSZ, 3).permute(0, 3, 1, 2)
    xb = xn.to(torch.bfloat16)
    wb = wd.to(torch.bfloat16)
    dzb = dz.permute(0, 3, 1, 2)
    times = [
        {"ms": cuda_time(lambda: S.stem_train_fwd(x, wd), 5),
         "plain_ms": cuda_time(lambda: S.stem_train_fwd_plain(x, wd), 3),
         "library_ms": cuda_time(lambda: F.conv2d(xb, wb, None, 2, 2), 5),
         # the same function: the float32 conv (TF32 off), rounded to bf16
         "library_f32_ms": cuda_time(lambda: F.conv2d(
             xn.float(), wd, None, 2, 2).to(torch.bfloat16), 5)},
        {"ms": cuda_time(lambda: S.stem_train_wgrad(x, dz), 5),
         "plain_ms": cuda_time(lambda: S.stem_train_wgrad_plain(x, dz), 3),
         "library_ms": cuda_time(lambda: torch.nn.grad.conv2d_weight(
             xb, wb.shape, dzb, 2, 2), 5)},
    ]
    hs = IMGSZ // 2
    flops = 2 * BATCH * hs * hs * 108 * c2
    # the forward multiplies uint8 values by float32 weights as three bf16
    # products on the tensor cores; the weight gradient multiplies bf16
    # image values by bf16 dz
    nbytes = x.numel() + dz.numel() * 2 + wd.numel() * 4
    res = _train_results("stem_train_fwd", "stem_train_wgrad", got, flops,
                         [(3 * flops, PEAK_BF16)], nbytes, nbytes, times)
    fwd = res["stem_train_fwd"]
    fwd["repeat_bitwise"] = repeat
    fwd["tolerance"] += "; repeats bit for bit"
    fwd["ok"] = fwd["ok"] and repeat
    wgrad = res["stem_train_wgrad"]
    wgrad["repeat_bitwise"] = w_repeat
    wgrad["tolerance"] += "; repeats bit for bit"
    wgrad["ok"] = wgrad["ok"] and w_repeat
    return {"stem_train_fwd": (S.TRAIN_FWD_KERNEL, res["stem_train_fwd"]),
            "stem_train_wgrad": (S.TRAIN_WGRAD_KERNEL,
                                 res["stem_train_wgrad"])}


def check_down_train(gen, dev):
    """The layer-1 (512² x 48 → 96) and layer-3 (256² x 96 → 192)
    downsamples; each kernel's entry sums the two layers, as one train step
    launches it at both."""
    import torch
    import torch.nn.functional as F

    from yolov5_obb_tpu_torch.ops.kernels import down_kernel as D

    per = {}
    for layer, ci, co, H in (("L1", 48, 96, IMGSZ // 2),
                             ("L3", 96, 192, IMGSZ // 4)):
        x = torch.randn(BATCH, H, H, ci, generator=gen, device=dev).to(
            torch.bfloat16).requires_grad_()
        w = conv_weights(gen, co, ci, 3, dev).permute(2, 3, 1, 0).reshape(
            9 * ci, co).contiguous().requires_grad_()
        got = _grad_check(D.down_conv_train, x, w, gen, {"plain": True})
        dxk, dxp = got["kernel"][1][0].float(), got["plain"][1][0].float()
        dx_err = float((dxk - dxp).abs().max())
        dx_tol = float(dxp.abs().max()) / 128
        dz = got["kernel"][0]
        xd, wq = x.detach(), w.detach().to(torch.bfloat16)
        xn, dzn = xd.permute(0, 3, 1, 2), dz.permute(0, 3, 1, 2)
        k = wq.reshape(3, 3, ci, co).permute(3, 2, 0, 1)
        times = [
            {"ms": cuda_time(lambda: D.down_train_fwd(xd, wq), 5),
             "plain_ms": cuda_time(lambda: D.down_train_fwd_plain(xd, wq), 3),
             "library_ms": cuda_time(lambda: F.conv2d(xn, k, None, 2, 1), 5)},
            {"ms": cuda_time(lambda: D.down_train_wgrad(xd, dz), 5),
             "plain_ms": cuda_time(lambda: D.down_train_wgrad_plain(xd, dz),
                                   3),
             "library_ms": cuda_time(lambda: torch.nn.grad.conv2d_weight(
                 xn, k.shape, dzn, 2, 1), 5)},
        ]
        flops = 2 * BATCH * (H // 2) ** 2 * 9 * ci * co
        nbytes = x.numel() * 2 + dz.numel() * 2
        res = _train_results("down_train_fwd", "down_train_wgrad", got, flops,
                             [(flops, PEAK_BF16)], nbytes + wq.numel() * 2,
                             nbytes + w.numel() * 4, times)
        # the input gradient: the same transposed conv on both paths, but
        # cuDNN may pick another algorithm (and sum order) per call
        res["down_train_wgrad"]["dx_max_abs_err"] = dx_err
        res["down_train_wgrad"]["dx_tolerance"] = dx_tol
        res["down_train_wgrad"]["ok"] &= dx_err <= dx_tol
        per[layer] = res
        del x, w, got, dz
        torch.cuda.empty_cache()
    out = {}
    for name, kern in (("down_train_fwd", D.TRAIN_FWD_KERNEL),
                       ("down_train_wgrad", D.TRAIN_WGRAD_KERNEL)):
        l1, l3 = per["L1"][name], per["L3"][name]
        out[name] = (kern, {
            "max_abs_err": max(l1["max_abs_err"], l3["max_abs_err"]),
            "ok": l1["ok"] and l3["ok"],
            "tolerance": f"L1: {l1['tolerance']}; L3: {l3['tolerance']}",
            "bound": bound(l1["bytes"] + l3["bytes"],
                           (l1["flops"] + l3["flops"], PEAK_BF16)),
            **{k: l1[k] + l3[k] for k in ("ms", "plain_ms", "library_ms",
                                          "flops", "bytes")},
            "cases": {"L1": {k: v for k, v in l1.items() if k != "bound"},
                      "L3": {k: v for k, v in l3.items() if k != "bound"}},
        })
    return out


# ---------------------------------------------------------------------------
# (b") the fused train passes against their plain versions
# ---------------------------------------------------------------------------

# the region's 1x1 structures at yolov5m (c1 = 96, c_ = 48): name → (ns,
# groups, outs, ci, weight shapes)
_PASS_1X1 = {
    "cv1_cv2": ((True,), ((0,),), (((0, 0),), ((0, 1),)), 96, (48, 48)),
    "b0_cv1": ((True,), ((0,),), (((0, 0),),), 48, (48,)),
    "b1_cv1": ((True, True), ((0, 1),), (((0, 0),),), 48, (48,)),
    "cv3": ((True,) * 4, ((0, 1, 2), (3,)), (((0, 0), (1, 1)),), 48,
            (96, 96)),
}


def _gb(gen, c, dev):
    import torch

    return torch.stack([1.0 + 0.3 * torch.randn(c, generator=gen, device=dev),
                        0.2 * torch.randn(c, generator=gen, device=dev)])


def _ulp_err(got, want):
    """(max |Δ|, one bf16 ulp of the largest value)."""
    return (float((got.float() - want.float()).abs().max()),
            float(want.float().abs().max()) / 128)


def _rel_err(got, want):
    """max |Δ| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _sum_cases(kern, cases):
    """One kernel's entry over the cases one train step launches it at."""
    tot = lambda k: sum(c[k] for c in cases.values())
    return kern, {
        "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
        "ok": all(c["ok"] for c in cases.values()),
        "tolerance": cases[next(iter(cases))]["tolerance"],
        "bound": bound(tot("bytes"), (tot("flops"), PEAK_BF16),
                       (tot("act_ops"), PEAK_FP32)),
        **{k: tot(k) for k in ("ms", "plain_ms", "library_ms", "flops",
                               "bytes", "act_ops")},
        "cases": cases,
    }


def check_pass_3x3(gen, dev):
    """pass_3x3s2 at down1 (512² x 48 → 96) and down2 (256² x 96 → 192),
    pass_3x3s1 at the two bottleneck 3x3s (256² x 48 → 48)."""
    import torch
    import torch.nn.functional as F

    from yolov5_obb_tpu_torch.ops.kernels import train_fused as TF

    per = {1: {}, 2: {}}
    for name, stride, ci, co, H in (("down1", 2, 48, 96, IMGSZ // 2),
                                    ("down2", 2, 96, 192, IMGSZ // 4),
                                    ("b0", 1, 48, 48, IMGSZ // 4),
                                    ("b1", 1, 48, 48, IMGSZ // 4)):
        z = torch.randn(BATCH, H, H, ci, generator=gen, device=dev).to(
            torch.bfloat16)
        gb = _gb(gen, ci, dev)
        w = conv_weights(gen, co, ci, 3, dev).permute(2, 3, 1, 0).reshape(
            9 * ci, co).contiguous()
        zk, sk = TF.pass_3x3_fwd(z, gb, w, stride)
        zp, sp = TF.pass_3x3_fwd_plain(z, gb, w, stride)
        repeat = torch.equal(sk, TF.pass_3x3_fwd(z, gb, w, stride)[1])
        torch.cuda.synchronize()
        f_err, f_tol = _ulp_err(zk, zp)
        s_err = _rel_err(sk, sp)
        y = (F.silu(z.float() * gb[0] + gb[1]).to(torch.bfloat16)
             .permute(0, 3, 1, 2))
        k = w.to(torch.bfloat16).reshape(3, 3, ci, co).permute(3, 2, 0, 1)
        per[stride][name] = {
            "max_abs_err": f_err, "stats_rel_err": s_err,
            "stats_repeat_bitwise": repeat,
            "ok": f_err <= f_tol and s_err <= 1e-4 and repeat,
            "tolerance": "z: one bf16 ulp of the largest; stats: 1e-4 of "
                         "the largest; stats repeat bit for bit",
            "ms": cuda_time(lambda: TF.pass_3x3_fwd(z, gb, w, stride), 5),
            "plain_ms": cuda_time(
                lambda: TF.pass_3x3_fwd_plain(z, gb, w, stride), 3),
            # the conv alone on the already-activated input (cuDNN, bf16)
            "library_ms": cuda_time(
                lambda: F.conv2d(y, k, None, stride, 1), 5),
            "flops": 2 * zk.numel() * 9 * ci, "act_ops": z.numel() * ACT_OPS,
            "bytes": z.numel() * 2 + zk.numel() * 2 + w.numel() * 2
                     + 4 * (gb.numel() + sk.numel()),
        }
        del z, zk, zp, y
        torch.cuda.empty_cache()
    return {"pass_3x3s1": _sum_cases(TF.KERNEL_3X3S1, per[1]),
            "pass_3x3s2": _sum_cases(TF.KERNEL_3X3S2, per[2])}


def check_pass_1x1(gen, dev):
    """pass_1x1 forward and backward at the four 1x1 passes of a step
    (256², batch 16), the backward from seeded cotangents."""
    import torch
    import torch.nn.functional as F

    from yolov5_obb_tpu_torch.ops.kernels import train_fused as TF

    H = IMGSZ // 4
    fwd, bwd = {}, {}
    for name, (ns, groups, outs, ci, cos) in _PASS_1X1.items():
        zs = [torch.randn(BATCH, H, H, ci, generator=gen, device=dev).to(
            torch.bfloat16) for _ in ns]
        gbs = [_gb(gen, ci, dev) for _ in ns]
        ws = [torch.randn(ci, co, generator=gen, device=dev) / ci ** 0.5
              for co in cos]
        args = (ns, groups, outs, zs, gbs, ws)
        zk, sk = TF.pass_1x1_fwd(*args)
        zp, sp = TF.pass_1x1_fwd_plain(*args)
        s_repeat = all(torch.equal(a, b) for a, b in zip(
            sk, TF.pass_1x1_fwd(*args)[1]))
        dz = [torch.randn(z.shape, generator=gen, device=dev).to(
            torch.bfloat16) for z in zp]
        dst = [1e-3 * torch.randn(2, z.shape[-1], generator=gen, device=dev)
               for z in zp]
        bargs = (*args, zp, dz, dst)
        gk = TF.pass_1x1_bwd(*bargs)
        gp = TF.pass_1x1_bwd_plain(*bargs)
        gk2 = TF.pass_1x1_bwd(*bargs)
        g_repeat = all(torch.equal(a, b) for a, b in zip(
            [*gk[1], *gk[2]], [*gk2[1], *gk2[2]]))
        torch.cuda.synchronize()
        f_errs = [_ulp_err(a, b) for a, b in zip(zk, zp)]
        s_err = max(_rel_err(a, b) for a, b in zip(sk, sp))
        dz_errs = [_ulp_err(a, b) for a, b in zip(gk[0], gp[0])]
        w_err = max(_rel_err(a, b) for a, b in zip(gk[2], gp[2]))
        gb_err = max(_rel_err(a, b) for a, b in zip(gk[1], gp[1]))
        # the library yardsticks: one bf16 cuDNN 1x1 conv over the
        # activated group values (the groups side by side, the weights
        # stacked), and its weight and input gradients
        gv = torch.cat(TF._group_values(ns, groups, zs, gbs), -1).to(
            torch.bfloat16).permute(0, 3, 1, 2)
        wl = (torch.cat([torch.cat([ws[w] for _, w in o], 0) for o in outs], 1)
              .T.contiguous().to(torch.bfloat16)[:, :, None, None])
        el = torch.cat(dz, -1).permute(0, 3, 1, 2)
        macs = sum(ci * ws[w].shape[1] for o in outs for _, w in o)
        n_px = BATCH * H * H
        in_b = sum(z.numel() for z in zs) * 2
        out_b = sum(z.numel() for z in zp) * 2
        w_b = sum(w.numel() for w in ws)
        fwd[name] = {
            "max_abs_err": max(e for e, _ in f_errs), "stats_rel_err": s_err,
            "stats_repeat_bitwise": s_repeat,
            "ok": all(e <= t for e, t in f_errs) and s_err <= 1e-4
                  and s_repeat,
            "tolerance": "z: one bf16 ulp of the largest; stats: 1e-4 of "
                         "the largest; stats repeat bit for bit",
            "ms": cuda_time(lambda: TF.pass_1x1_fwd(*args), 5),
            "plain_ms": cuda_time(lambda: TF.pass_1x1_fwd_plain(*args), 3),
            "library_ms": cuda_time(lambda: F.conv2d(gv, wl), 5),
            "flops": 2 * n_px * macs, "act_ops": in_b // 2 * ACT_OPS,
            "bytes": in_b + out_b + 2 * w_b,
        }
        bwd[name] = {
            "max_abs_err": max(e for e, _ in dz_errs), "dw_rel_err": w_err,
            "dgb_rel_err": gb_err, "grads_repeat_bitwise": g_repeat,
            "ok": all(e <= t for e, t in dz_errs) and w_err <= 2e-2
                  and gb_err <= 2e-2 and g_repeat,
            "tolerance": "dz_in: one bf16 ulp of the largest; dW, (dg, db): "
                         "2e-2 of the largest; dW, (dg, db) repeat bit for "
                         "bit",
            "ms": cuda_time(lambda: TF.pass_1x1_bwd(*bargs), 5),
            "plain_ms": cuda_time(lambda: TF.pass_1x1_bwd_plain(*bargs), 3),
            "library_ms": cuda_time(lambda: (
                torch.nn.grad.conv2d_weight(gv, wl.shape, el),
                torch.nn.grad.conv2d_input(gv.shape, wl, el)), 5),
            "flops": 4 * n_px * macs, "act_ops": in_b // 2 * DACT_OPS,
            # inputs, outputs and their cotangents read; input gradients
            # written; weights read and dW written
            "bytes": 2 * in_b + 2 * out_b + 6 * w_b
                     + 8 * len(zs) * ci,
        }
        del zs, zk, zp, dz, gk, gp, gk2, gv, el
        torch.cuda.empty_cache()
    return {"pass_1x1_fwd": _sum_cases(TF.KERNEL_1X1, fwd),
            "pass_1x1_bwd": _sum_cases(TF.KERNEL_1X1_BWD, bwd)}


def synthetic_candidates(gen, n, clustered, dev):
    import torch

    u = lambda *s: torch.rand(*s, generator=gen, device=dev)
    rb = torch.empty(BATCH, n, 5, device=dev)
    if clustered:  # a few tight clusters: rows overflow M = 64
        ctr = 100 + 800 * u(BATCH, 4, 2)
        which = (u(BATCH, n) * 4).long()
        rb[..., :2] = torch.gather(ctr, 1, which[..., None].expand(-1, -1, 2)) \
            + 6 * torch.randn(BATCH, n, 2, generator=gen, device=dev)
    else:
        rb[..., :2] = IMGSZ * u(BATCH, n, 2)
    rb[..., 2] = 20 + 70 * u(BATCH, n)
    rb[..., 3] = rb[..., 2] * (0.3 + 0.7 * u(BATCH, n))
    rb[..., 4] = (u(BATCH, n) - 0.5) * np.pi
    cls = (u(BATCH, n) * (2 if clustered else 15)).to(torch.int32)
    valid = torch.arange(n, device=dev)[None] < (0.8 * n)
    return rb, cls, valid.expand(BATCH, n).contiguous()


def iou_ops(ra, rb, chunk: int = 1 << 20):
    """(needed, design) scalar operations of the exact IoU of the pairs of
    records ``ra``, ``rb`` (``(P, 16)`` each): IOU_FIXED_OPS a pair plus its
    ring's (its size m from the plain candidate points), and the
    design's IOU_DESIGN_OPS a pair."""
    import torch

    from yolov5_obb_tpu_torch.ops.rotated_iou import candidate_points

    sort = torch.tensor(SORT_COMPARATORS, device=ra.device)
    ring = 0.0
    for a, b in zip(ra.split(chunk), rb.split(chunk)):
        m = candidate_points(a, b)[2].sum(-1)
        ring += float(torch.where(m >= 3, m * RING_POINT_OPS + 2 * sort[m],
                                  0).sum())
    return ra.shape[0] * IOU_FIXED_OPS + ring, ra.shape[0] * IOU_DESIGN_OPS


def neighbor_ops(rb, cls, valid, M):
    """(needed, design) scalar operations of the neighbour function on this
    input: each box's record, the edge tests each valid row makes until its
    M-th edge, and the exact IoU of its selected pairs (iou_ops; the design
    differs only there)."""
    import torch

    from yolov5_obb_tpu_torch.ops.kernels import iou as K
    from yolov5_obb_tpu_torch.ops.kernels import neighbor_kernel as N

    edge = N.edge_matrix(rb, cls, valid, IOU)
    pos = torch.cumsum(edge.to(torch.int32), -1)
    rows = torch.arange(rb.shape[1], device=rb.device)[None].expand_as(
        pos[..., -1])
    full = pos[..., -1] >= M
    mth = torch.argmax((pos >= M).to(torch.uint8), -1)  # column of M-th edge
    scanned = torch.where(full, mth + 1, rows) * valid
    del pos
    idx, sel = N.first_m_neighbors(edge, M)
    del edge
    rec = K.box_records(rb)
    b, i, s = sel.nonzero(as_tuple=True)
    need, design = iou_ops(rec[b, i], rec[b, idx[b, i, s].long()])
    rest = rb.shape[0] * rb.shape[1] * BOX_OPS \
        + float(scanned.sum()) * EDGE_OPS
    return rest + need, rest + design


def neighbor_bare(rb, cls, valid, M=64):
    """The neighbour kernel's launch alone, on records and outputs prepared
    once (no wrapper, no records launch)."""
    import torch

    from yolov5_obb_tpu_torch.ops.kernels import iou as K
    from yolov5_obb_tpu_torch.ops.kernels import neighbor_kernel as N

    B, n, _ = rb.shape
    rec = K.box_records(rb, cls, valid)
    idx = torch.empty(B, n, M, dtype=torch.int32, device=rb.device)
    sup = torch.empty(B, n, M, dtype=torch.bool, device=rb.device)
    pairs = torch.empty(B * n * M + 1, dtype=torch.int32, device=rb.device)
    return lambda: N.KERNEL.launch(rec, B, n, M, float(IOU * N.EDGE_SLACK),
                                   float(IOU), idx, sup, pairs)


def compare_neighbors(rb, cls, valid, M=64):
    """Kernel vs plain on the same candidates: mismatch counts, and the
    records' cover and area against the plain edge inputs, bit for bit."""
    import torch

    from yolov5_obb_tpu_torch.ops.kernels import iou as K
    from yolov5_obb_tpu_torch.ops.kernels import neighbor_kernel as N
    from yolov5_obb_tpu_torch.ops.rotated_iou import record_cover_area

    idx, sup = N.fused_neighbor_iou(rb, cls, valid, IOU, M)
    pidx, psup = N.fused_neighbor_iou_plain(rb, cls, valid, IOU, M)
    rec = K.box_records(rb, cls, valid)
    torch.cuda.synchronize()
    return {
        "nbr_idx_mismatches": int((idx != pidx).sum()),
        "sup_in_mismatches": int((sup != psup).sum()),
        "cover_mismatches": int((record_cover_area(rec)
                                 != N._edge_inputs(rb)).sum()),
        "rows_over_M": int((pidx[..., -1] > 0).sum()),
        "sup_edges": int(psup.sum()),
    }, pidx, psup


def check_neighbor(gen, dev):
    import torch

    from yolov5_obb_tpu_torch.ops.kernels import neighbor_kernel as N

    M = 64
    cases = {}
    for n, clustered in ((512, False), (1024, False), (2048, False),
                         (2048, True)):
        rb, cls, valid = synthetic_candidates(gen, n, clustered, dev)
        res, pidx, psup = compare_neighbors(rb, cls, valid, M)
        res["ms"] = cuda_time(lambda: N.fused_neighbor_iou(rb, cls, valid,
                                                           IOU, M), 20)
        res["kernel_ms"] = profiled_ms(neighbor_bare(rb, cls, valid, M))
        res["plain_ms"] = cuda_time(
            lambda: N.fused_neighbor_iou_plain(rb, cls, valid, IOU, M), 2, 1)
        cases[f"n{n}{'_clustered' if clustered else ''}"] = res
        if n == 2048 and not clustered:
            ops, design_ops = neighbor_ops(rb, cls, valid, M)
    n = 2048
    # boxes, class and valid in (25 bytes a box), indices and flags out
    nbytes = BATCH * n * 25 + BATCH * n * M * 5
    mism = sum(c["nbr_idx_mismatches"] + c["sup_in_mismatches"]
               + c["cover_mismatches"] for c in cases.values())
    return "neighbor", N.KERNEL, {
        "max_abs_err": float(mism),
        "tolerance": "exact: 0 nbr_idx, sup_in and cover mismatches",
        "ok": mism == 0,
        "ms": cases["n2048"]["ms"], "kernel_ms": cases["n2048"]["kernel_ms"],
        "plain_ms": cases["n2048"]["plain_ms"],
        "library_ms": None,
        "bound": bound(nbytes, (ops, lane_rate())), "ops": ops,
        "design_ops": design_ops, "bytes": nbytes,
        "cases": cases,
    }


def check_riou_boxes(gen, dev):
    """The per-box records (the prologue of both rotated-IoU kernels) on
    phase (b)'s n = 2048 candidates: the half vectors within the pair IoU's
    1e-5, every other field (centre, area, cover, class and valid bits)
    exact."""
    import torch

    from yolov5_obb_tpu_torch.ops.kernels import iou as K
    from yolov5_obb_tpu_torch.ops.rotated_iou import REC_HALVES

    n = 2048
    rb, cls, valid = synthetic_candidates(gen, n, False, dev)
    got = K.box_records(rb, cls, valid)
    want = K.box_records_plain(rb, cls, valid)
    torch.cuda.synchronize()
    err = float((got[..., REC_HALVES] - want[..., REC_HALVES]).abs().max())
    rest = torch.ones(got.shape[-1], dtype=torch.bool, device=dev)
    rest[REC_HALVES] = False
    exact = torch.equal(got[..., rest], want[..., rest])
    rec = torch.empty_like(got)
    N_ = BATCH * n
    nbytes = N_ * (5 * 4 + 4 + 1 + 64)
    return "riou_boxes", K.BOXES_KERNEL, {
        "max_abs_err": err, "other_fields_exact": exact,
        "bit_for_bit": torch.equal(got, want),
        "tolerance": "half vectors <= 1e-5; centre, area, cover, class, "
                     "valid exact",
        "ok": exact and err <= 1e-5,
        "ms": profiled_ms(lambda: K.BOXES_KERNEL.launch(rb, cls, valid, N_,
                                                       rec)),
        "plain_ms": cuda_time(lambda: K.box_records_plain(rb, cls, valid), 5),
        "library_ms": None,
        "bound": bound(nbytes, (N_ * BOX_OPS, lane_rate())),
        "ops": N_ * BOX_OPS, "bytes": nbytes,
    }


def check_pairs_iou(gen, dev):
    """The pair-IoU kernel (sparse form) on the clustered candidates of
    check_neighbor at n = 4096, every row's first M = 64 admissible
    neighbours (rows overflow M): IoU values and the suppression decisions
    iou > thr against the plain version, bit for bit on repeat."""
    import torch

    from yolov5_obb_tpu_torch.ops.kernels import iou as K
    from yolov5_obb_tpu_torch.ops.kernels import neighbor_kernel as N

    n, M = 4096, 64
    rb, cls, valid = synthetic_candidates(gen, n, True, dev)
    idx, nbr_valid = N.first_m_neighbors(N.edge_matrix(rb, cls, valid, IOU), M)
    _, sup = N.fused_neighbor_iou(rb, cls, valid, IOU, M)
    got = K.sparse_rotated_iou(rb, idx)
    want = K.sparse_rotated_iou_plain(rb, idx)
    again = K.sparse_rotated_iou(rb, idx)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    decisions = int(((got > IOU) != (want > IOU)).sum())
    repeat = torch.equal(got, again)
    pairs = idx.numel()
    rec = K.box_records(rb)
    out = torch.empty_like(got)
    ra = rec[:, :, None].expand(-1, -1, M, -1).reshape(pairs, -1)
    rp = torch.gather(rec, 1, idx.reshape(rb.shape[0], -1, 1).long()
                      .expand(-1, -1, rec.shape[-1])).reshape(pairs, -1)
    need, design = iou_ops(ra, rp)
    del ra, rp
    boxes = rb.shape[0] * n * PAIR_BOX_OPS
    # boxes in (20 bytes each), indices in and IoU out
    nbytes = rb.shape[0] * n * 20 + pairs * 8
    return "pairs_iou", K.KERNEL, {
        "max_abs_err": err, "decision_mismatches": decisions,
        "repeat_bitwise": repeat,
        "rows_over_M": int(nbr_valid[..., -1].sum()),
        # the neighbour kernel's decisions on the same slots
        "sup_in_vs_neighbor_kernel_mismatches": int(
            (((got > IOU) & nbr_valid) != sup).sum()),
        "tolerance": "IoU |Δ| <= 1e-5, 0 decision mismatches; repeats bit "
                     "for bit",
        "ok": err <= 1e-5 and decisions == 0 and repeat,
        "ms": cuda_time(lambda: K.sparse_rotated_iou(rb, idx), 10),
        "kernel_ms": profiled_ms(lambda: K.KERNEL.launch(
            rec, None, idx, out, rb.shape[0], n, M)),
        "plain_ms": cuda_time(lambda: K.sparse_rotated_iou_plain(rb, idx), 2,
                              1),
        "library_ms": None,
        "bound": bound(nbytes, (boxes + need, lane_rate())),
        "ops": boxes + need, "design_ops": boxes + design, "bytes": nbytes,
    }


# ---------------------------------------------------------------------------
# (c) the main path
# ---------------------------------------------------------------------------


def density_model(dev, cfg="yolov5m.yaml", seed=0, **kw):
    """A bf16 packed-stem model, random weights from ``seed``, with the class
    biases spread so that conf = obj*cls clears 0.25 for some (anchor,
    class) pairs (bench.py's recipe), Conv+BN folded; and ``set_obj(δ)``,
    which moves every Detect obj bias by δ."""
    import torch

    from yolov5_obb_tpu_torch.models.yolo import create_model
    from yolov5_obb_tpu_torch.utils.fuse import fuse_conv_bn

    model, meta = create_model(cfg, nc=15, dtype=torch.bfloat16, device=dev,
                               seed=seed, packed_stem=True, **kw)
    det = model.model[-1]
    na, no, nc = meta.na, meta.no, meta.nc
    rngb = np.random.default_rng(7 + seed)
    with torch.no_grad():
        for li in range(meta.nl):
            b = det.m[li].bias.view(na, no)
            b[:, 5:5 + nc] += torch.as_tensor(
                rngb.normal(0.0, 2.0, (na, nc)), dtype=b.dtype, device=dev)
    fuse_conv_bn(model)

    def set_obj(delta):
        with torch.no_grad():
            for li in range(meta.nl):
                det.m[li].bias.view(na, no)[:, 4] += delta

    return model, meta, set_obj


def tune_density(predict, set_obj, x) -> float:
    """Bisect the obj-bias move to ~DENSITY dets/img on ``x`` (dets/img is
    monotone in it) and apply it; returns it."""
    lo, hi = 0.0, 10.0
    for _ in range(7):
        mid = (lo + hi) / 2
        set_obj(mid)
        d = float(predict(x)[1].float().mean())
        set_obj(-mid)
        lo, hi = (mid, hi) if d < DENSITY else (lo, mid)
    set_obj((lo + hi) / 2)
    return (lo + hi) / 2


def path_candidates(maps, meta):
    """The single-label candidates that post-processing takes from these
    Detect maps at phase (c)'s conf and candidate count, cut to their
    tier: rotated boxes, scores, class ids, the tier."""
    import torch

    from yolov5_obb_tpu_torch.ops import rotated_nms as R

    pl = R.decode_planes(maps, meta)
    gate = torch.where((pl["best"] > CONF) & (pl["obj"] > CONF),
                       pl["best"], torch.zeros_like(pl["best"]))
    sc, idx = R.exact_select(gate, min(MAXC, gate.shape[1]))
    kk = R._tier(sc.shape[1], int((sc > 0).sum(1).max()))
    cid = torch.gather(pl["cid"], 1, idx)[:, :kk]
    th = (torch.gather(pl["th"], 1, idx).float() - 90.0) / 180.0 * R.PI
    rb = torch.stack([torch.gather(pl[c], 1, idx) for c in "xywh"]
                     + [th], -1)[:, :kk].contiguous()
    return rb, sc[:, :kk], cid, kk


def main_path(dev, report):
    import torch

    from yolov5_obb_tpu_torch.engine.evaluator import make_predict_fn
    from yolov5_obb_tpu_torch.ops import rotated_nms as R
    from yolov5_obb_tpu_torch.ops.kernels import neighbor_kernel as N

    t0 = time.perf_counter()
    model, meta, set_obj = density_model(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    xs = [torch.randint(0, 256, (BATCH, IMGSZ, IMGSZ * 3), generator=gen,
                        device=dev, dtype=torch.uint8) for _ in range(3)]
    require(all(xs[i].data_ptr() != xs[j].data_ptr()
                for i in range(3) for j in range(i)), "batches share buffers")
    predict = make_predict_fn(model, meta, CONF, IOU, MAX_DET,
                              multi_label=False, max_candidates=MAXC)
    delta = tune_density(predict, set_obj, xs[0])
    log(f"density: obj delta {delta:.4f}  set-up {time.perf_counter() - t0:.1f}s")

    # the counted run: three distinct batches through the user entry point
    kernels = {n: k for n, k in _named_kernels().items() if n in INFER}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    outs = [predict(x) for x in xs]
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    log(f"launches over 3 predict calls: {launches}")
    require(all(v > 0 for v in launches.values()),
            f"kernel not launched: {launches}")

    for d_, n_ in outs:
        require(d_.shape == (BATCH, MAX_DET, 7) and n_.shape == (BATCH,),
                f"detections of shape {tuple(d_.shape)}, {tuple(n_.shape)}")
        require(bool(torch.isfinite(d_).all()), "non-finite detections")
    dets_per_img = float(torch.stack([n_ for _, n_ in outs]).float().mean())

    # reference: the same path through the plain versions on the card
    predict_plain = make_predict_fn(model, meta, CONF, IOU, MAX_DET,
                                    multi_label=False, max_candidates=MAXC,
                                    plain=True)
    img_mismatch, det_diff, cls_mismatch, map_err = 0, 0, 0, 0.0
    keep_mismatch, idx_mismatch, sup_mismatch, cand = 0, 0, 0, 0
    cover_mismatch, live, nbr_case = 0, [], None
    with torch.inference_mode():
        for x, (d_k, n_k) in zip(xs, outs):
            maps_k = model(x)
            maps_p = model(x, plain=True)
            map_err = max(map_err, max(float((a.float() - b.float()).abs().max())
                                       for a, b in zip(maps_k, maps_p)))
            d_p, n_p = predict_plain(x)
            for i in range(BATCH):
                a, b = int(n_k[i]), int(n_p[i])
                same = a == b and torch.equal(d_k[i, :a, 6], d_p[i, :b, 6])
                img_mismatch += not same
                det_diff += abs(a - b)
                if a == b:
                    cls_mismatch += int((d_k[i, :a, 6] != d_p[i, :a, 6]).sum())
            # the kernel path's own candidates through both NMS versions
            rb, sc, cid, kk = path_candidates(maps_k, meta)
            keep_k = R.nms_rotated(rb, sc, IOU, cid, presorted=True)
            keep_p = R.nms_rotated(rb, sc, IOU, cid, presorted=True, plain=True)
            keep_mismatch += int((keep_k != keep_p).sum())
            res, _, _ = compare_neighbors(rb, cid, sc > 0)
            idx_mismatch += res["nbr_idx_mismatches"]
            sup_mismatch += res["sup_in_mismatches"]
            cover_mismatch += res["cover_mismatches"]
            cand = max(cand, int((sc > 0).sum(1).max()))
            live += (sc > 0).sum(1).tolist()
            if nbr_case is None:  # row 4 at the path's own tier and rows
                valid = (sc > 0).contiguous()
                nbr_case = {**res, "tier": kk,
                            "live_rows_per_img": (sc > 0).sum(1).tolist(),
                            "ms": cuda_time(lambda: N.fused_neighbor_iou(
                                rb, cid, valid, IOU, 64), 20),
                            "kernel_ms": profiled_ms(
                                neighbor_bare(rb, cid, valid))}
    log(f"plain reference: maps max|Δ| {map_err:.4g}, images differing "
        f"{img_mismatch}/{3 * BATCH}, Σ|Δdets| {det_diff}, cls mismatches "
        f"{cls_mismatch}; same candidates (≤{cand}/img, tier {kk}): keep "
        f"mismatches {keep_mismatch}, nbr_idx {idx_mismatch}, sup_in "
        f"{sup_mismatch}, cover {cover_mismatch}; row 4 there {nbr_case}")
    require(keep_mismatch == 0 and idx_mismatch == 0 and sup_mismatch == 0
            and cover_mismatch == 0,
            "neighbour kernel disagrees with its plain version on the main path")
    # bf16 conv rounding differs between the kernels and their plain
    # versions, so a few scores near 0.25 may cross; bound the effect
    total = dets_per_img * 3 * BATCH
    require(det_diff <= max(10, 0.02 * total),
            f"{det_diff} detections differ from the plain path of {total}")

    # timing, as bench.py does it: pipelined, 12 iterations, sync at the end
    torch.cuda.reset_peak_memory_stats()
    predict(xs[0])
    torch.cuda.synchronize()
    iters = 12
    t = time.perf_counter()
    acc = torch.zeros((), device=dev)
    for i in range(iters):
        d_, n_ = predict(xs[i % 3])
        acc = acc + d_.sum() + n_.sum()
    final = float(acc)
    dt = (time.perf_counter() - t) / iters
    require(np.isfinite(final), "non-finite timing checksum")
    # where a batch's time goes: the model forward alone (CUDA events); the
    # rest of a predict call is decode + selection + rotated NMS
    with torch.inference_mode():
        forward_ms = cuda_time(lambda: model(xs[1]), 5)
    gate = c3_gate_ab(model, xs[1])
    log(f"FUSED_C3_MIN_SPATIAL A/B: {gate}")
    report.update({
        "ms_per_img": dt * 1e3 / BATCH, "dets_per_img": dets_per_img,
        "predict_ms_per_batch": dt * 1e3, "forward_ms_per_batch": forward_ms,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "obj_delta": delta, "maps_max_abs_err_vs_plain": map_err,
        "images_differing_vs_plain": img_mismatch,
        "dets_abs_diff_vs_plain": det_diff,
        "keep_mask_mismatches": keep_mismatch,
        "candidates_per_img": [min(live), float(np.mean(live)), max(live)],
        "neighbor_main_path_case": nbr_case,
        "launches_per_3_predicts": dict(launches),
        "c3_gate_ab": gate,
    })
    return launches


def c3_gate_ab(model, x):
    """The C3 gate on the forward: ``FUSED_C3_MIN_SPATIAL`` at its default
    (256²: layer 2's C3(96, n = 2) on the kernel) and lowered to 128² (layer
    4's C3(192, n = 4) too), set through ``models.layers`` as the card tests
    do; the forward's CUDA-event ms in turns default, lowered, lowered,
    default, the C3 kernel's launches per forward, and the Detect maps of
    the two settings against each other, within row 2's bar (abs <= 0.06)."""
    import torch

    from yolov5_obb_tpu_torch.models import layers
    from yolov5_obb_tpu_torch.ops.kernels import c3_kernel

    default, lowered = layers.FUSED_C3_MIN_SPATIAL, 128 * 128
    maps, per_fwd, ms = {}, {}, []
    try:
        with torch.inference_mode():
            for setting in (default, lowered):
                layers.FUSED_C3_MIN_SPATIAL = setting
                c3_kernel.KERNEL.launches = 0
                maps[setting] = model(x)
                torch.cuda.synchronize()
                per_fwd[setting] = c3_kernel.KERNEL.launches
            for setting in (default, lowered, lowered, default):
                layers.FUSED_C3_MIN_SPATIAL = setting
                ms.append(cuda_time(lambda: model(x), 5))
    finally:
        layers.FUSED_C3_MIN_SPATIAL = default
    require(per_fwd[default] == 1 and per_fwd[lowered] == 2,
            f"C3 kernel launches per forward {per_fwd}")
    require(all(bool(torch.isfinite(m).all()) for m in maps[lowered]),
            "non-finite Detect maps with the C3 gate lowered")
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(maps[default], maps[lowered]))
    require(diff <= 0.06, f"Detect maps with the C3 gate lowered differ "
            f"from the default's by {diff:.4g} (> 0.06)")
    return {"min_spatial": [default, lowered],
            "forward_ms_per_batch": [(ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2],
            "forward_ms_turns": ms, "c3_launches_per_forward": per_fwd,
            "maps_max_abs_diff_lowered_vs_default": diff}


# ---------------------------------------------------------------------------
# (d) the train path
# ---------------------------------------------------------------------------


def train_batches(dev, csl_radius, batch=BATCH, imgsz=IMGSZ):
    """Two distinct seeded batches as tools/bench_train.py builds them (64
    label slots, 8 live targets), the CSL rows from the port's
    csl_gaussian_labels; the image as the packed (B, H, 3W) view."""
    import torch

    from yolov5_obb_tpu_torch.ops.geometry import csl_gaussian_labels

    rng = np.random.default_rng(0)
    out = []
    for _ in range(2):
        img = rng.integers(0, 255, (batch, imgsz, imgsz, 3), dtype=np.uint8)
        tg = np.zeros((batch, MAX_LABELS, 186), np.float32)
        tg[:, :LIVE, 0] = rng.integers(0, 15, (batch, LIVE))
        tg[:, :LIVE, 1:3] = rng.uniform(100, 900, (batch, LIVE, 2))
        tg[:, :LIVE, 3:5] = rng.uniform(20, 120, (batch, LIVE, 2))
        tg[:, :LIVE, 5] = rng.uniform(-1.5, 1.5, (batch, LIVE))
        tg[:, :LIVE, 6:] = csl_gaussian_labels(
            tg[:, :LIVE, 5].reshape(-1) * 180 / np.pi + 90,
            radius=csl_radius).reshape(batch, LIVE, 180)
        mask = np.zeros((batch, MAX_LABELS), bool)
        mask[:, :LIVE] = True
        out.append(tuple(torch.from_numpy(a).to(dev) for a in (
            img.reshape(batch, imgsz, -1), tg, mask)))
    require(out[0][0].data_ptr() != out[1][0].data_ptr(),
            "batches share buffers")
    return out


def _cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    n = float(a.norm() * b.norm())
    return float(a @ b) / n if n else 1.0


def compare_plain_step(model, loss_fn, opt, batch, fused=False):
    """Loss items and gradients of one step from the same state and batch,
    through the kernels and through their plain versions (the BN running
    statistics are put back after each).  ``fused``: the model runs the
    fused train region, whose kernel-bearing weights are the stem's and the
    1x1 passes' (the 3x3 passes' weight gradients are the same library call
    on both paths).

    The kernel layers' weight gradients of the kernel step are held
    elementwise (2e-2 of the largest) to the plain weight gradient of the
    same layer inputs and incoming gradients, recorded during that step.
    The whole step's gradients cannot be held elementwise: a bf16 step's
    gradients are dominated by rounding noise that train-mode BatchNorm
    amplifies through the depth, so any one-ulp change moves them by tens of
    percent (the JAX package's tests/test_packed_train.py found the same and
    compares directions).  They are held to the direction of the plain
    step's, no worse than a control: the plain step with the stem weights
    scaled by 1 + 2^-8, a one-bf16-ulp perturbation.

    The conv blocks' train-mode BatchNorm + SiLU kernels (csrc/
    bn_act_train.cu) run on both of those steps, so they compare the conv
    kernels alone, as before those kernels existed.  The BatchNorm kernels
    are held apart to the same bars: the kernel step against the same step
    with their plain version, the chain of PyTorch ops, in their place
    (``bn_chain``).  One comparison of both families at once would add two
    roundings' noise, which the depth amplifies to ~1% of an item, the
    items' bar (the plain step's items alone move ~0.5% from run to run:
    cuDNN's choice of float32 algorithms)."""
    import torch

    from yolov5_obb_tpu_torch.models import layers
    from yolov5_obb_tpu_torch.ops.kernels import bn_act_train as BN
    from yolov5_obb_tpu_torch.ops.kernels import down_kernel, stem_kernel
    from yolov5_obb_tpu_torch.ops.kernels import train_fused as TF

    image, tg, mask = batch
    recorded = []

    def recording(mod, name):
        fn = getattr(mod, name)

        def wrapper(*args):
            out = fn(*args)
            recorded.append((name, args, out))
            return out
        return fn, wrapper

    # each recorded kernel's plain version and its weight gradient(s)
    plain_dw = {
        "stem_train_wgrad": (stem_kernel.stem_train_wgrad_plain,
                             lambda out: [out]),
        "down_train_wgrad": (down_kernel.down_train_wgrad_plain,
                             lambda out: [out]),
        "pass_1x1_bwd": (TF.pass_1x1_bwd_plain, lambda out: list(out[2])),
    }
    hooked = ((stem_kernel, "stem_train_wgrad"), (TF, "pass_1x1_bwd")) \
        if fused else ((stem_kernel, "stem_train_wgrad"),
                       (down_kernel, "down_train_wgrad"))
    patches = [(mod, name, *recording(mod, name)) for mod, name in hooked]
    saved = {k: b.clone() for k, b in model.named_buffers()}
    w0 = model.model[0].conv.weight
    w0_saved = w0.detach().clone()
    out, bn_launches = {}, {}
    model.train()
    bn_act = layers._bn_act
    for name, plain, scale, bn_plain in (
            ("kernel", False, 1.0, False), ("plain", True, 1.0, False),
            ("control", True, 1.0 + 2.0**-8, False),
            ("bn_chain", False, 1.0, True)):
        with torch.no_grad():
            w0.mul_(scale)
        before = {n: k.launches for n, k in BN.KERNELS.items()}
        layers._bn_act = (lambda m, z, dtype, plain=False, bp=bn_plain:
                          bn_act(m, z, dtype, bp))
        try:
            total, items = loss_fn(model(image, plain=plain), tg, mask)
        finally:
            layers._bn_act = bn_act
        for mod, fn_name, _, wrapper in patches if name == "kernel" else ():
            setattr(mod, fn_name, wrapper)
        try:
            grads = torch.autograd.grad(total, list(opt.params))
        finally:
            for mod, fn_name, fn, _ in patches:
                setattr(mod, fn_name, fn)
        out[name] = (items.detach().float(), dict(zip(opt.names, grads)))
        bn_launches[name] = {n: k.launches - before[n]
                             for n, k in BN.KERNELS.items()}
        with torch.no_grad():
            w0.copy_(w0_saved)
            for k, b in model.named_buffers():
                b.copy_(saved[k])
    model.eval()
    ip, gp = out["plain"]
    det = [n for n in gp if n.startswith(f"model.{len(model.model) - 1}.")]
    groups = {"model.0.conv.weight": ["model.0.conv.weight"],
              "model.1.conv.weight": ["model.1.conv.weight"],
              "model.3.conv.weight": ["model.3.conv.weight"],
              "detect": det, "all": list(gp)}
    if fused:
        groups["model.2 (C3)"] = [n for n in gp if n.startswith("model.2.")]
    res = {"items_plain": ip.tolist(), "bn_act_launches": bn_launches}
    # every step but bn_chain runs the BatchNorm kernels, each kernel once a
    # train-mode conv block (none where the BatchNorm is bfloat16)
    on = layers.bn_dtype() == torch.float32
    for name, per in bn_launches.items():
        n = set(per.values())
        require(len(n) == 1 and (n.pop() > 0) == (on and name != "bn_chain"),
                f"{name} step: BatchNorm kernel launches {per}")
    for name, ref in (("kernel", "plain"), ("control", "plain"),
                      ("bn_kernels", "bn_chain")):
        i, g = out["kernel" if name == "bn_kernels" else name]
        ri, rg = out[ref]
        rel = {n: float((g[n] - rg[n]).abs().max()
                        / rg[n].abs().max().clamp(min=1e-30)) for n in rg}
        res[name] = {
            "items": i.tolist(),
            "items_max_rel_err": float(((i - ri).abs() / ri.abs()).max()),
            "cos": {k: _cos(torch.cat([g[n].flatten() for n in v]),
                            torch.cat([rg[n].flatten() for n in v]))
                    for k, v in groups.items()},
            "grad_max_rel_err": {
                "median": float(np.median(list(rel.values()))),
                "max": max(rel.items(), key=lambda kv: kv[1]),
                **{n: rel[n] for n in groups if n in rel}},
        }
    wgrads = []
    with torch.no_grad():
        for name, args, out in recorded:
            plain_fn, dws = plain_dw[name]
            want = dws(plain_fn(*args))
            shape = args[3][0].shape if name == "pass_1x1_bwd" else args[0].shape
            wgrads.append((name, tuple(shape), max(
                float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for a, b in zip(dws(out), want))))
    res["kernel_wgrads_in_step_rel_err"] = wgrads
    del recorded
    k, c, bn = res["kernel"], res["control"], res["bn_kernels"]
    require(k["items_max_rel_err"] <= 1e-2,
            f"loss items differ from the plain step: {res}")
    require(bn["items_max_rel_err"] <= 1e-2 and bn["cos"]["detect"] > 0.9
            and all(bn["cos"][n] >= c["cos"][n] - 0.05 for n in groups),
            f"the BatchNorm kernels' step differs from the chain's: {res}")
    want_names = ["pass_1x1_bwd"] * 4 if fused else ["down_train_wgrad"] * 2
    require(sorted(n for n, _, _ in wgrads)
            == sorted(want_names + ["stem_train_wgrad"])
            and all(e <= 2e-2 for _, _, e in wgrads),
            f"kernel weight gradients in the step: {wgrads}")
    require(k["cos"]["detect"] > 0.9 and all(
        k["cos"][n] >= c["cos"][n] - 0.05 for n in groups),
        f"gradients point elsewhere than the plain step's: {res}")
    return res


def step_breakdown(model, loss_fn, opt, state, batch):
    """CUDA-event times of one train step's parts (the body of
    engine/trainer.make_train_step, timed piecewise)."""
    import torch

    from yolov5_obb_tpu_torch.engine.optim import ema_update

    image, tg, mask = batch
    params = list(opt.params)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    model.train()
    torch.cuda.synchronize()
    ev[0].record()
    total, items = loss_fn(model(image), tg, mask)
    ev[1].record()
    grads = torch.autograd.grad(total, params)
    ev[2].record()
    opt.apply(state.opt_state, grads)
    state.ema_updates += 1
    ema_update(state.ema.values(), params, state.ema_updates)
    ev[3].record()
    torch.cuda.synchronize()
    model.eval()
    return {"forward_loss_ms": ev[0].elapsed_time(ev[1]),
            "backward_ms": ev[1].elapsed_time(ev[2]),
            "optimizer_ema_ms": ev[2].elapsed_time(ev[3])}


# kernel-name substrings → group, first match wins: this port's kernels,
# cuDNN/CUTLASS convolutions, reductions, elementwise passes
_GROUPS = (("port kernels", ("stem_l1_kernel", "stem_kernel",
                             "stem_fwd_kernel", "stem_wgrad_kernel",
                             "down_wgrad_kernel", "sum_partials",
                             "sum_rows", "conv3x3_mma", "p1x1_fwd_kernel",
                             "p1x1_bwd_kernel")),
           ("convolutions (cuDNN/CUTLASS)", ("conv", "cudnn", "xmma", "cutlass",
                                             "implicit", "wgrad", "dgrad",
                                             "gemm", "sm90")),
           ("reductions", ("reduce",)),
           ("elementwise", ("elementwise", "vectorized", "unrolled")))


def _group(name: str) -> str:
    low = name.lower()
    return next((g for g, keys in _GROUPS if any(k in low for k in keys)),
                "other")


def profile_step(step, state, batch, step_ms):
    """Device time of one train step by kernel name (torch.profiler), in
    the groups of ``_GROUPS``; the idle share compares the device time with
    the unprofiled step time ``step_ms``."""
    import torch
    from torch.profiler import ProfilerActivity

    averages = profile_cycle(lambda: float(step(state, *batch)["loss"]),
                             [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    # the kernels themselves: an aten op's entry repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in averages
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_ms = sum(ms for _, ms, _ in rows)
    groups = {g: 0.0 for g, _ in _GROUPS}
    groups["other"] = 0.0
    for name, ms, _ in rows:
        groups[_group(name)] += ms
    rows.sort(key=lambda r: -r[1])
    return {"device_ms": device_ms,
            "idle_share": 1.0 - device_ms / step_ms if step_ms else None,
            "by_group_ms": groups,
            "top_kernels": [(n[:90], ms, c) for n, ms, c in rows[:12]],
            # the tensor-core kernels as the profile filed them
            "tensor_core_kernels": [
                (n[:90], _group(n), ms, c) for n, ms, c in rows
                if any(k in n for k in MMA_KERNELS)]}


def compare_stock_step(model, loss_fn, batch):
    """The fused train step against the stock train step (phase d's path:
    ``fused_train`` off) from the same state and batch: loss items within
    3e-2 relative, and the running statistics of layers 0-3 after the step
    within 2e-2 of their scale (tests/test_fused_region.py's bars for the
    JAX region).  The statistics are put back after each step."""
    import torch

    image, tg, mask = batch
    saved = {k: b.clone() for k, b in model.named_buffers()}
    region = ("model.0.", "model.1.", "model.2.", "model.3.")
    out = {}
    model.train()
    for name, flag in (("fused", True), ("stock", False)):
        model.fused_train = flag
        try:
            with torch.no_grad():
                _, items = loss_fn(model(image), tg, mask)
        finally:
            model.fused_train = True
        out[name] = (items.float(), {
            k: b.clone() for k, b in model.named_buffers()
            if k.startswith(region) and "running" in k})
        with torch.no_grad():
            for k, b in model.named_buffers():
                b.copy_(saved[k])
    model.eval()
    (fi, fs), (si, ss) = out["fused"], out["stock"]
    stats_err = {k: float((fs[k] - a).abs().max()
                          / max(float(a.abs().max()), 1.0))
                 for k, a in ss.items()}
    worst = max(stats_err.items(), key=lambda kv: kv[1])
    res = {"items_fused": fi.tolist(), "items_stock": si.tolist(),
           "items_max_rel_err": float(((fi - si).abs() / si.abs()).max()),
           "running_stats_worst_rel_err": worst,
           "running_stats_compared": len(stats_err)}
    require(res["items_max_rel_err"] <= 3e-2 and worst[1] < 2e-2,
            f"the fused step differs from the stock step: {res}")
    return res


def region_times(model, image, gen):
    """Layers 0-3 alone, in train mode, as the fused pass chain and as the
    stock layers (PackedStem, ConvBnAct with the downsample train kernels,
    C3): CUDA-event ms of the forward and of forward + backward (a seeded
    cotangent on layer 3's output; gradients of layers 0-3's parameters).
    The BN running statistics are put back."""
    import torch

    saved = {k: b.clone() for k, b in model.named_buffers()}
    params = [p for m in model.model[:4] for p in m.parameters()]
    m0, m1, c3, m3 = model.model[:4]
    runs = {"fused": lambda: model._fused_train_region(image, False),
            "stock": lambda: m3(c3(m1(m0(image))))}
    cot = None
    out = {}
    model.train()
    for name in ("stock", "fused", "fused", "stock"):
        fwd = runs[name]
        if cot is None:
            h = fwd()
            cot = torch.randn(h.shape, generator=gen, device=h.device).to(
                h.dtype)
            del h

        def both():
            torch.autograd.grad(fwd(), params, cot)

        with torch.no_grad():
            f_ms = cuda_time(fwd, 5)
        fb_ms = cuda_time(both, 5)
        prev = out.get(name, (0.0, 0.0))
        out[name] = (prev[0] + f_ms / 2, prev[1] + fb_ms / 2)
    model.eval()
    with torch.no_grad():
        for k, b in model.named_buffers():
            b.copy_(saved[k])
    return {f"{name}_{part}_ms": v[i] for name, v in out.items()
            for i, part in enumerate(("forward", "forward_backward"))}


def train_path(dev, report, fused=False, bn_half=False):
    """Phase (d), or with ``fused`` phase (e): the train step of a
    ``fused_train`` model.  ``bn_half``: phase (d)'s A/B, the stock step
    under YOLO_BN_HALF=1 (the train CLI's ``--bn-half``) from the same
    seed-0 weights and batches, with every check of phase (d), its plain
    step under the flag too; reported under ``bn_half_``.  The default
    stays float32 whatever it shows."""
    import os

    if not bn_half:
        return _train_path(dev, report, fused, "fused_train_" if fused
                           else "train_")
    old = os.environ.get("YOLO_BN_HALF")
    os.environ["YOLO_BN_HALF"] = "1"
    try:
        launches = _train_path(dev, report, False, "bn_half_")
    finally:
        if old is None:
            os.environ.pop("YOLO_BN_HALF", None)
        else:
            os.environ["YOLO_BN_HALF"] = old
    bn_half_report(report)
    return launches


def _train_path(dev, report, fused, pre):
    import torch

    from yolov5_obb_tpu_torch.engine.loss import ComputeLoss
    from yolov5_obb_tpu_torch.engine.optim import build_optimizer
    from yolov5_obb_tpu_torch.engine.trainer import (
        create_train_state,
        make_train_step,
    )
    from yolov5_obb_tpu_torch.models.yolo import create_model
    from yolov5_obb_tpu_torch.utils.general import load_hyp, scale_hyp_gains

    expected = with_bn_act(FUSED_LAUNCHES if fused else TRAIN_LAUNCHES,
                           BN_BLOCKS["yolov5m_fused" if fused else "yolov5m"])
    t0 = time.perf_counter()
    model, meta = create_model("yolov5m.yaml", nc=15, dtype=torch.bfloat16,
                               device=dev, seed=0, packed_stem=True,
                               fused_train=fused)
    hyp = load_hyp()
    loss_fn = ComputeLoss(meta, scale_hyp_gains(hyp, meta.nl, meta.nc, IMGSZ))
    opt, _ = build_optimizer(model, hyp, epochs=10, steps_per_epoch=100,
                             batch_size=BATCH, nominal_batch=BATCH)
    state = create_train_state(opt)
    step = make_train_step(model, loss_fn, opt, device=dev)
    batches = train_batches(dev, hyp["csl_radius"])
    log(f"{pre}set-up {time.perf_counter() - t0:.1f}s")

    # reference: the same step through the plain versions (and, for the
    # fused region, through the stock layers)
    cmp = compare_plain_step(model, loss_fn, opt, batches[0], fused)
    log(f"{pre}step vs plain: " + json.dumps(cmp))
    if fused:
        stock = compare_stock_step(model, loss_fn, batches[0])
        log(f"{pre}step vs stock: " + json.dumps(stock))
        region = region_times(model, batches[0][0],
                              torch.Generator(device=dev).manual_seed(2))
        log(f"layers 0-3 alone (stock, fused, fused, stock; mean ms): "
            + json.dumps(region))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):  # warm-up; the first step's items for the A/B
        m = step(state, *batches[i])
        if i == 0:
            first_items = m["items"].float().tolist()
        float(m["loss"])
    kernels = {n: k for n, k in _named_kernels().items() if n in expected}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses = []
    for i in range(TRAIN_ITERS):
        m = step(state, *batches[i % 2])
        if (i + 1) % SYNC_EVERY == 0:
            losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = {n: k.launches for n, k in kernels.items()}
    items = m["items"].float().tolist()
    log(f"launches over {TRAIN_ITERS} {pre}steps: {launches}")
    require(all(launches[n] == TRAIN_ITERS * per
                for n, per in expected.items()),
            f"train kernel launches {launches}, expected per step {expected}")
    require(bool(np.isfinite(losses + items).all()),
            f"non-finite loss {losses} / items {items}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    breakdown = step_breakdown(model, loss_fn, opt, state, batches[0])
    prof = profile_step(step, state, batches[1], dt * 1e3 / TRAIN_ITERS)
    log(f"{pre}step profile: " + json.dumps(prof))
    require(prof["device_ms"] > 0, "the profiler saw no device time")
    # the step's tensor-core kernels count as the port's, not as cuDNN's
    tc = prof["tensor_core_kernels"]
    want = ("stem_fwd_kernel", "stem_wgrad_kernel") + (
        ("p1x1_fwd_kernel", "p1x1_bwd_kernel") if fused
        else ("down_wgrad_kernel",))
    require(all(any(w in n for n, *_ in tc) for w in want) and
            all(g == "port kernels" for _, g, *_ in tc),
            f"profile groups of the tensor-core kernels: {tc}")
    report.update({
        f"{pre}imgs_per_s": TRAIN_ITERS * BATCH / dt,
        f"{pre}step_ms": dt * 1e3 / TRAIN_ITERS,
        f"{pre}peak_mem_gib": peak, f"{pre}losses": losses,
        f"{pre}items_last": items, f"{pre}step_breakdown_ms": breakdown,
        f"{pre}launches_per_step": {n: v / TRAIN_ITERS
                                    for n, v in launches.items()},
        f"{pre}vs_plain": cmp, f"{pre}profile": prof,
        f"{pre}first_items": first_items,
        **({f"{pre}vs_stock": stock, "layers_0_3_ms": region}
           if fused else {}),
    })
    return {n: v for n, v in launches.items() if v}


def bn_half_report(report):
    """Phase (d)'s bn-half A/B from the two runs' reports: img/s over the
    same timed steps, device time by group of one profiled step, and the
    first step's loss items, each within 5e-3 of the float32 step's loss
    (their sum; the small items' own relative noise is larger), as
    tests/test_bn_half.py holds the JAX bn-half loss, and not all equal to
    the float32 items (a flag read but without effect would give those)."""
    f32, items = report["train_first_items"], report["bn_half_first_items"]
    rel = [abs(a - b) / sum(f32) for a, b in zip(items, f32)]
    prof, f32_prof = report["bn_half_profile"], report["train_profile"]
    ab = {"imgs_per_s": report["bn_half_imgs_per_s"],
          "f32_imgs_per_s": report["train_imgs_per_s"],
          "step_ms": report["bn_half_step_ms"],
          "peak_mem_gib": report["bn_half_peak_mem_gib"],
          "first_items": items, "f32_first_items": f32, "items_rel": rel,
          "device_ms": prof["device_ms"],
          "elementwise_ms": prof["by_group_ms"]["elementwise"],
          "f32_device_ms": f32_prof["device_ms"],
          "f32_elementwise_ms": f32_prof["by_group_ms"]["elementwise"],
          "by_group_ms": prof["by_group_ms"], "idle_share": prof["idle_share"]}
    log(f"bn-half A/B (stock step, yolov5m b16 1024²): {ab['imgs_per_s']:.2f} "
        f"img/s against float32 BN {ab['f32_imgs_per_s']:.2f}; device "
        f"{ab['device_ms']:.2f} ms a step (elementwise "
        f"{ab['elementwise_ms']:.2f}) against {ab['f32_device_ms']:.2f} "
        f"({ab['f32_elementwise_ms']:.2f}); first-step loss items "
        f"{[round(v, 6) for v in items]} against "
        f"{[round(v, 6) for v in f32]} (|Δ| over the float32 loss "
        f"{[f'{v:.2e}' for v in rel]})"
        f"; peak {ab['peak_mem_gib']:.2f} GiB on {card_line()}")
    require(max(rel) <= 5e-3,
            f"bn-half first-step loss items off the float32 step's: {ab}")
    require(items != f32,
            f"bn-half first-step loss items equal the float32 step's: {ab}")
    report["bn_half_ab"] = ab


# ---------------------------------------------------------------------------
# (f) the val path
# ---------------------------------------------------------------------------


class SeededValSet:
    """An in-memory eval dataset (the ``get_eval_sample`` surface of
    data/dota.DotaDataset, no files, no OpenCV): ``images`` (N, H, W, 3)
    uint8 RGB at the model's size, ``labels`` per image (n, 6) ``[cls cx cy
    l s theta]`` in its pixels."""

    def __init__(self, images, labels, names):
        self.images, self.labels, self.names = images, labels, names
        self.img_size = images.shape[1]
        self.img_files = [f"val_{i:02d}.png" for i in range(len(images))]

    def __len__(self):
        return len(self.images)

    def get_eval_sample(self, i):
        t = np.zeros((VAL_LABELS, 186), np.float32)
        m = np.zeros(VAL_LABELS, bool)
        n = len(self.labels[i])
        t[:n, :6], m[:n] = self.labels[i], True
        return {"image": self.images[i], "targets": t, "target_mask": m,
                "index": np.int32(i),
                "orig_hw": np.array(self.images.shape[1:3], np.int32)}


def val_candidates(model, meta, x):
    """The kernel path's multi-label candidates of one batch at the tier
    the suppression takes: (rb, scores, cls, per-image counts, tier)."""
    import torch

    from yolov5_obb_tpu_torch.ops import rotated_nms as R

    with torch.inference_mode():
        pl = R.decode_planes(model(x), meta, multi_label=True)
        sc, idx, cid = R.exact_select_pairs(pl["conf"], VAL_CONF, VAL_MAXC)
        counts = (sc > 0).sum(1)
        kk = R._tier(sc.shape[1], int(counts.max()))
        th = (torch.gather(pl["th"], 1, idx).float() - 90.0) / 180.0 * R.PI
        rb = torch.stack([torch.gather(pl[c], 1, idx) for c in "xywh"]
                         + [th], -1)
    return (rb[:, :kk].contiguous(), sc[:, :kk].contiguous(),
            cid[:, :kk].contiguous(), counts.tolist(), kk)


def _count_diff(got, want) -> int:
    """Images whose detection counts differ by more than 1% (at least 1)."""
    return sum(abs(int(a) - int(b)) > max(1, 0.01 * int(b))
               for a, b in zip(got, want))


def _unmatched(a, b, tol) -> int:
    """Rows of ``a`` (features..., class) with no row of ``b`` of the same
    class within ``tol`` (one row per row of ``b``, one column per
    feature), plus the rows of ``b`` with none in ``a``."""
    if not len(a) or not len(b):
        return len(a) + len(b)
    ok = ((a[:, None, :-1] - b[None, :, :-1]).abs() <= tol[None]).all(-1) \
        & (a[:, None, -1] == b[None, :, -1])
    return int((~ok.any(1)).sum()) + int((~ok.any(0)).sum())


def _rows_tol(d):
    """Tolerance of predict rows ``[cx cy l s theta conf cls]`` kernel vs
    plain (bf16 maps that differ by an ulp or two): 1 px on the centre,
    1 px + 2% on each side, one angle bin, 0.005 + 2% on the confidence."""
    import torch

    one = torch.ones_like(d[:, 0])
    return torch.stack([one, one, 1 + 0.02 * d[:, 2], 1 + 0.02 * d[:, 3],
                        one * (np.pi / 180 + 1e-4), 0.005 + 0.02 * d[:, 5]], -1)


def _polys_tol(d):
    """Tolerance of evaluate rows ``[poly (8) conf cls]``: 1 px + 3% of the
    box's larger HBB extent on each corner coordinate (the sides' and one
    angle bin's share), 0.005 + 2% on the confidence."""
    import torch

    ext = torch.maximum(d[:, 0:8:2].amax(1) - d[:, 0:8:2].amin(1),
                        d[:, 1:8:2].amax(1) - d[:, 1:8:2].amin(1))
    return torch.cat([(1 + 0.03 * ext)[:, None].expand(-1, 8),
                      (0.005 + 0.02 * d[:, 8])[:, None]], -1)


def _predict_diff(dk, nk, dp, np_):
    """One batch's predict outputs, kernel against plain: (detections with
    no counterpart in the other run, detections in both runs, images whose
    rows are bit-identical)."""
    import torch

    unmatched, same = 0, 0
    for i in range(len(nk)):
        a, b = dk[i, :int(nk[i])].float(), dp[i, :int(np_[i])].float()
        unmatched += _unmatched(a, b, _rows_tol(b))
        same += a.shape == b.shape and bool(torch.equal(a, b))
    return unmatched, int(nk.sum()) + int(np_.sum()), same


def _evaluate_diff(res, res_p, dev):
    """``evaluate``'s detections (native-resolution polys), kernel run
    against plain run: (unmatched, total, bit-identical images)."""
    import torch

    rows = lambda d: torch.as_tensor(np.concatenate(
        [d["polys"], d["conf"][:, None], d["cls"][:, None]], 1),
        dtype=torch.float64, device=dev)
    unmatched, total, same = 0, 0, 0
    for dk, dp in zip(res["detections"], res_p["detections"]):
        a, b = rows(dk), rows(dp)
        unmatched += _unmatched(a, b, _polys_tol(b))
        total += len(a) + len(b)
        same += a.shape == b.shape and bool(torch.equal(a, b))
    return unmatched, total, same


def _stem_run(model, meta, xs, name):
    """Row 6 on the val path: the multi-label predict of a model whose
    layer 0 is the stem kernel (layer 1 stock), one call per batch, its
    stem launches; then on each batch layer 0 against its plain version
    (one bf16 ulp of the largest output), the Detect maps, and the
    detections against the plain path's (counts within 1%, at most 1% of
    the detections without a counterpart within ``_rows_tol``)."""
    import torch

    from yolov5_obb_tpu_torch.engine.evaluator import make_predict_fn
    from yolov5_obb_tpu_torch.ops.kernels import stem_kernel as S

    require(model.packed_stem and not model.packed_l1,
            f"{name}: layer 0 is not the stem-only kernel")
    kw = dict(max_candidates=VAL_MAXC)
    predict = make_predict_fn(model, meta, VAL_CONF, VAL_IOU, MAX_DET, **kw)
    plain = make_predict_fn(model, meta, VAL_CONF, VAL_IOU, MAX_DET,
                            plain=True, **kw)
    predict(xs[0])  # warm-up
    torch.cuda.synchronize()
    S.STEM_KERNEL.launches = 0
    S.KERNEL.launches = 0
    outs = [predict(x) for x in xs]
    torch.cuda.synchronize()
    launches = S.STEM_KERNEL.launches
    require(launches == len(xs) and S.KERNEL.launches == 0,
            f"{name}: stem launches {launches}, stem+L1 {S.KERNEL.launches} "
            f"over {len(xs)} predicts")
    stem_err, maps_err, unmatched, total, same = 0.0, 0.0, 0, 0, 0
    got, want = [], []
    with torch.inference_mode():
        for x, (dk, nk) in zip(xs, outs):
            err, tol = _ulp_err(model.model[0](x),
                                model.model[0](x, plain=True))
            require(err <= tol, f"{name}: layer 0 differs from its plain "
                    f"version by {err} > one bf16 ulp {tol}")
            stem_err = max(stem_err, err)
            maps_err = max(maps_err, max(
                float((a.float() - b.float()).abs().max())
                for a, b in zip(model(x), model(x, plain=True))))
            dp, np_ = plain(x)
            u, t, s_ = _predict_diff(dk, nk, dp, np_)
            unmatched, total, same = unmatched + u, total + t, same + s_
            got += nk.tolist()
            want += np_.tolist()
    diff = _count_diff(got, want)
    require(diff == 0, f"{name}: detection counts differ from the plain "
            f"path by > 1% on {diff} images: {got} vs {want}")
    require(unmatched <= 0.01 * total, f"{name}: {unmatched} of {total} "
            "detections have no counterpart in the other run")
    with torch.inference_mode():
        fwd = cuda_time(lambda: model(xs[1]), 5)
    return {"stem_launches": launches, "dets_per_img": float(np.mean(got)),
            "dets_per_img_plain": float(np.mean(want)),
            "stem_max_abs_err_vs_plain": stem_err,
            "maps_max_abs_err_vs_plain": maps_err,
            "dets_unmatched_vs_plain": [unmatched, total],
            "images_bit_identical_vs_plain": same,
            "forward_ms_per_batch": fwd}, launches


def val_path(dev, report, delta):
    """Phase (f): yolov5m b16 1024² bf16 with phase (c)'s density-tuned
    weights through ``evaluate`` (multi-label, conf 0.01, IoU 0.4, 4096
    candidates, max_det 1500) on 48 seeded images whose labels are the
    plain path's conf-0.25 detections; the kernel run against the plain
    run (metrics, counts, detections matched elementwise); the iou-ordered
    NMS on one batch's candidates and on clustered candidates that
    overflow M; the stem kernel on yolov5m with PACKED_L1=0 and on
    yolov5s-ghost."""
    import os

    import torch

    from yolov5_obb_tpu_torch.engine.evaluator import evaluate, make_predict_fn
    from yolov5_obb_tpu_torch.models.yolo import create_model
    from yolov5_obb_tpu_torch.ops import rotated_nms as R
    from yolov5_obb_tpu_torch.ops.kernels import iou as K
    from yolov5_obb_tpu_torch.ops.kernels import neighbor_kernel as N

    t0 = time.perf_counter()
    model, meta, set_obj = density_model(dev)
    set_obj(delta)
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (VAL_IMAGES, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    xs = [torch.from_numpy(images[i:i + BATCH]).to(dev).reshape(
        BATCH, IMGSZ, -1) for i in range(0, VAL_IMAGES, BATCH)]
    labeler = make_predict_fn(model, meta, CONF, IOU, VAL_LABELS,
                              multi_label=False, max_candidates=MAXC,
                              plain=True)
    labels = []
    for x in xs:
        d, n = labeler(x)
        labels += [d[i, :int(n[i])][:, [6, 0, 1, 2, 3, 4]].cpu().numpy()
                   for i in range(BATCH)]
    ds = SeededValSet(images, labels, [f"c{i}" for i in range(meta.nc)])
    n_labels = sum(len(t) for t in labels)
    require(n_labels > 10 * VAL_IMAGES, f"only {n_labels} labels")
    log(f"val set-up {time.perf_counter() - t0:.1f}s, {n_labels} labels")

    kw = dict(batch_size=BATCH, conf_thres=VAL_CONF, iou_thres=VAL_IOU,
              max_det=MAX_DET)
    kernels = {n: k for n, k in _named_kernels().items() if n in INFER}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    res = evaluate(model, meta, ds, **kw)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(all(v > 0 for v in launches.values()),
            f"val path: kernel not launched: {launches}")
    res_p = evaluate(model, meta, ds, plain=True, **kw)
    nk = [len(d["conf"]) for d in res["detections"]]
    npl = [len(d["conf"]) for d in res_p["detections"]]
    metrics = {k: (res[k], res_p[k]) for k in ("mp", "mr", "map50", "map")}
    log(f"val metrics (kernel, plain): {metrics}")
    require(abs(res["map50"] - res_p["map50"]) <= 0.01
            and abs(res["map"] - res_p["map"]) <= 0.01,
            f"val mAP differs from the plain run: {metrics}")
    require(res["map50"] > VAL_MAP_FLOOR, f"trivial val mAP: {metrics}")
    diff = _count_diff(nk, npl)
    require(diff == 0, f"detection counts differ by > 1% on {diff} images")
    ev_unmatched, ev_total, ev_same = _evaluate_diff(res, res_p, dev)
    log(f"evaluate detections without a counterpart in the plain run: "
        f"{ev_unmatched} of {ev_total}; bit-identical images {ev_same}")
    require(ev_unmatched <= 0.01 * ev_total, f"evaluate: {ev_unmatched} of "
            f"{ev_total} detections have no counterpart in the plain run")

    # the predict calls alone, as phase (c) times them
    predict = make_predict_fn(model, meta, VAL_CONF, VAL_IOU, MAX_DET,
                              max_candidates=VAL_MAXC)
    predict(xs[0])
    torch.cuda.synchronize()
    t = time.perf_counter()
    acc = torch.zeros((), device=dev)
    for i in range(6):
        d_, n_ = predict(xs[i % 3])
        acc = acc + d_.sum() + n_.sum()
    require(np.isfinite(float(acc)), "non-finite val checksum")
    predict_ms = (time.perf_counter() - t) / 6 * 1e3

    # the same candidates through both NMS versions, in both neighbour
    # orders; the pair-IoU kernel's launches are those of the iou order
    keep_mism, counts, tiers = 0, [], []
    for bi, x in enumerate(xs):
        rb, sc, cid, cnt, kk = val_candidates(model, meta, x)
        counts += cnt
        tiers.append(kk)
        keep_k = R.nms_rotated(rb, sc, VAL_IOU, cid, presorted=True)
        keep_p = R.nms_rotated(rb, sc, VAL_IOU, cid, presorted=True,
                               plain=True)
        keep_mism += int((keep_k != keep_p).sum())
        if bi == 0:
            K.KERNEL.launches = 0
            keep_i = R.nms_rotated(rb, sc, VAL_IOU, cid, presorted=True,
                                   neighbor_order="iou")
            torch.cuda.synchronize()
            iou_launches = K.KERNEL.launches
            keep_ip = R.nms_rotated(rb, sc, VAL_IOU, cid, presorted=True,
                                    neighbor_order="iou", plain=True)
            edges = N.edge_matrix(rb, cid, sc > 0, VAL_IOU).sum(-1)
            over = (edges > 64).any(-1)
            del edges
            iou_mism = int((keep_i != keep_ip).sum())
            order_mism = int((keep_i != keep_k)[~over].sum())
            order_diff_over = int((keep_i != keep_k)[over].sum())
    log(f"val candidates/img {min(counts)}..{max(counts)} (mean "
        f"{np.mean(counts):.0f}), tiers {tiers}; keep mismatches {keep_mism}; "
        f"iou order: kernel vs plain {iou_mism}, vs score order on images "
        f"without overflow {order_mism} ({int(over.sum())} images overflow M, "
        f"{order_diff_over} differences there)")
    require(keep_mism == 0, "keep masks differ on the val candidates")
    require(iou_mism == 0 and order_mism == 0 and iou_launches == 1,
            f"iou-ordered NMS: {iou_mism} kernel/plain and {order_mism} "
            f"order mismatches, {iou_launches} pair-IoU launches")
    # the iou order where it differs from the score order: clustered
    # candidates (4096 per image, descending scores) whose rows overflow M,
    # through the same entry point, kernel against plain
    gen = torch.Generator(device=dev).manual_seed(5)
    rb_c, cls_c, valid_c = synthetic_candidates(gen, VAL_MAXC, True, dev)
    sc_c = torch.linspace(1.0, 0.02, VAL_MAXC, device=dev) * valid_c
    K.KERNEL.launches = 0
    keep_ci = R.nms_rotated(rb_c, sc_c, VAL_IOU, cls_c, presorted=True,
                            neighbor_order="iou")
    torch.cuda.synchronize()
    iou_launches += K.KERNEL.launches
    keep_cp = R.nms_rotated(rb_c, sc_c, VAL_IOU, cls_c, presorted=True,
                            neighbor_order="iou", plain=True)
    keep_cs = R.nms_rotated(rb_c, sc_c, VAL_IOU, cls_c, presorted=True)
    over_c = (N.edge_matrix(rb_c, cls_c, valid_c, VAL_IOU).sum(-1) > 64)
    clustered = {"images_overflowing_M": int(over_c.any(-1).sum()),
                 "rows_overflowing_M": int(over_c.sum()),
                 "kernel_vs_plain_mismatches": int((keep_ci != keep_cp).sum()),
                 "vs_score_order_differences": int((keep_ci != keep_cs).sum()),
                 "kept_per_img": float(keep_ci.sum(1).float().mean())}
    log(f"iou order on clustered candidates: {clustered}")
    require(clustered["images_overflowing_M"] == BATCH
            and clustered["kernel_vs_plain_mismatches"] == 0
            and iou_launches == 2,
            f"iou-ordered NMS on overflowing rows: {clustered}, "
            f"{iou_launches} pair-IoU launches")

    # row 6: yolov5m with PACKED_L1=0 (the stem kernel, layer 1 stock) —
    # also the PACKED_L1 A/B against the stem+L1 model — and yolov5s-ghost
    old = os.environ.get("PACKED_L1")
    os.environ["PACKED_L1"] = "0"
    try:
        m0, meta0 = create_model("yolov5m.yaml", nc=15, dtype=torch.bfloat16,
                                 device=dev, seed=0, packed_stem=True)
    finally:
        if old is None:
            del os.environ["PACKED_L1"]
        else:
            os.environ["PACKED_L1"] = old
    m0.load_state_dict(model.state_dict())
    l1_off, stem_a = _stem_run(m0, meta0, xs, "yolov5m PACKED_L1=0")
    with torch.inference_mode():
        fw = [cuda_time(lambda: m(xs[1]), 5) for m in (model, m0, m0, model)]
    l1_off["stem_l1_forward_ms_per_batch"] = (fw[0] + fw[3]) / 2
    l1_off["forward_ms_per_batch"] = (fw[1] + fw[2]) / 2
    del m0
    torch.cuda.empty_cache()
    g, gmeta, g_set_obj = density_model(dev, "yolov5s-ghost.yaml")
    g_delta = tune_density(make_predict_fn(
        g, gmeta, CONF, IOU, MAX_DET, multi_label=False, max_candidates=MAXC),
        g_set_obj, xs[0])
    ghost, stem_b = _stem_run(g, gmeta, xs, "yolov5s-ghost")
    ghost["obj_delta"] = g_delta
    log(f"PACKED_L1=0: {l1_off}; yolov5s-ghost: {ghost}")

    report.update({
        "val_evaluate_ms_per_img": res["speed_ms_per_img"],
        "val_predict_ms_per_img": predict_ms / BATCH,
        "val_candidates_per_img": float(np.mean(counts)),
        "val_candidates_max": max(counts), "val_tiers": tiers,
        "val_dets_per_img": float(np.mean(nk)),
        "val_dets_per_img_plain": float(np.mean(npl)),
        "val_peak_mem_gib": peak, "val_metrics_kernel_plain": metrics,
        "val_labels": n_labels, "val_keep_mask_mismatches": keep_mism,
        "val_iou_order": {"kernel_vs_plain_mismatches": iou_mism,
                          "vs_score_order_mismatches_no_overflow": order_mism,
                          "images_overflowing_M": int(over.sum()),
                          "differences_on_overflowing_images": order_diff_over,
                          "clustered": clustered},
        "val_evaluate_dets_unmatched_vs_plain": [ev_unmatched, ev_total],
        "val_evaluate_images_bit_identical_vs_plain": ev_same,
        "val_launches_per_evaluate": launches,
        "packed_l1_off": l1_off, "yolov5s_ghost": ghost,
    })
    return {"pairs_iou": iou_launches, "stem": stem_a + stem_b}, ds


# ---------------------------------------------------------------------------
# (g) the train CLI
# ---------------------------------------------------------------------------


def write_seeded_dota(root, n, size, seed, names, max_boxes=40):
    """A seeded DOTA-format set under ``root``: ``images/imNNN.png`` (a
    blocky background with each box's cover filled), ``labelTxt/imNNN.txt``
    (8 to ``max_boxes`` rotated boxes a tile, ``x1 y1 .. x4 y4 class 0``)
    and ``data.yaml`` (train = val = images).  Returns the yaml's path and
    the images, BGR as a decoder gives them."""
    from yolov5_obb_tpu_torch.ops.geometry import rbox2poly
    from yolov5_obb_tpu_torch.utils.image_io import write_png

    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "labelTxt").mkdir(exist_ok=True)
    images = []
    for k in range(n):
        img = np.repeat(np.repeat(rng.integers(
            40, 120, (size // 64, size // 64, 3), dtype=np.uint8), 64, 0),
            64, 1)
        m = int(rng.integers(8, max_boxes + 1))
        rb = np.stack([rng.uniform(64, size - 64, m),
                       rng.uniform(64, size - 64, m),
                       rng.uniform(24, 160, m), rng.uniform(12, 60, m),
                       rng.uniform(-np.pi / 2, np.pi / 2, m)], 1)
        polys = rbox2poly(rb)
        lines = []
        for poly, c in zip(polys, rng.integers(0, len(names), m)):
            x0, y0 = np.floor(poly.reshape(4, 2).min(0)).astype(int)
            x1, y1 = np.ceil(poly.reshape(4, 2).max(0)).astype(int)
            img[max(y0, 0):y1, max(x0, 0):x1] = rng.integers(140, 255, 3)
            lines.append(" ".join(f"{v:.1f}" for v in poly)
                         + f" {names[c]} 0")
        write_png(root / "images" / f"im{k:03d}.png", img)
        (root / "labelTxt" / f"im{k:03d}.txt").write_text("\n".join(lines))
        images.append(np.ascontiguousarray(img[:, :, ::-1]))
    data = root / "data.yaml"
    data.write_text(f"path: {root}\ntrain: images\nval: images\n"
                    f"nc: {len(names)}\nnames: {json.dumps(list(names))}\n")
    return data, images


def seeded_train_set(data, images, max_labels, hyp):
    """The set of ``write_seeded_dota`` as the port's ``DotaDataset`` reads
    it (label files parsed, ``_encode`` with ``hyp``'s CSL radius), its
    images from memory instead of a decoder: un-augmented (``augment=False``:
    the letterbox of an image already at ``img_size``), so its
    ``get_train_sample`` runs on numpy alone."""
    from yolov5_obb_tpu_torch.data.dota import DotaDataset
    from yolov5_obb_tpu_torch.utils.general import load_dataset_config

    d = load_dataset_config(data)

    class SeededTrainSet(DotaDataset):
        def load_image(self, i):
            img = images[i]
            return (img.copy(), self.polys[i].copy(), self.cls[i].copy(),
                    img.shape[:2])

    return SeededTrainSet(d["train"], d["names"], img_size=images[0].shape[0],
                          hyp=hyp, augment=False, max_labels=max_labels)


def cli_callbacks(log_epochs: list, profile_epochs: bool = False):
    """Callbacks that time the CLI on the host's clock: per epoch the wall
    time, the batches, the time spent waiting for each batch (from the
    previous batch's end, or the epoch's start, to the next batch's
    arrival; the first batch's wait apart: the loader's workers start),
    the time in the train step (batch arrival to its end), the tail (the
    last step's end to the epoch's end: the loss items' read syncs), the
    ``last/`` and ``best/`` saves (from the fitness to ``on_model_save``,
    from there to the next event), and the epoch's whole time, saves and
    logging included (``total_s``: to the next epoch's start or the run's
    end).  With ``profile_epochs`` each epoch's loop runs under
    ``torch.profiler``: its device time by group (``_GROUPS``) and the
    device's idle share of that loop's own wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yolov5_obb_tpu_torch.utils.callbacks import Callbacks

    cb, t = Callbacks(), {}

    def now():
        return time.perf_counter()

    def close_save():
        if "after_save" in t:
            log_epochs[-1]["best_save_ms"] = (now() - t.pop("after_save")) * 1e3
        if "epoch" in t:
            e = log_epochs[-1]
            e["total_s"] = (now() - t.pop("epoch")
                            - e.get("profile", {}).get("host_s", 0.0))

    def epoch_start(*a, **k):
        close_save()
        if profile_epochs:
            t["prof"] = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            t["prof"].start()
        t["mark"] = t["epoch"] = now()
        t.update(wait=0.0, first=None, step=0.0, n=0)

    def batch_start(*a, **k):
        t["arrived"] = now()
        w = t["arrived"] - t["mark"]
        t["wait"] += w
        t["first"] = w if t["first"] is None else t["first"]

    def batch_end(*a, **k):
        t["n"] += 1
        t["mark"] = now()
        t["step"] += t["mark"] - t["arrived"]

    def epoch_end(epoch=None, **k):
        torch.cuda.synchronize()
        end = now()
        wall = end - t["epoch"]
        e = {"epoch": epoch, "batches": t["n"], "wall_s": wall,
             "loader_wait_s": t["wait"], "loader_wait_share": t["wait"] / wall,
             "first_batch_wait_s": t["first"], "step_host_s": t["step"],
             "tail_s": end - t["mark"]}
        if profile_epochs:
            t["prof"].stop()
            rows = [(ev.key, ev.self_device_time_total / 1e3)
                    for ev in t.pop("prof").key_averages()
                    if ev.device_type == torch.autograd.DeviceType.CUDA
                    and ev.self_device_time_total > 0]
            groups = {g: 0.0 for g, _ in _GROUPS}
            groups["other"] = 0.0
            for name, ms in rows:
                groups[_group(name)] += ms
            device_ms = sum(ms for _, ms in rows)
            e["profile"] = {"device_ms": device_ms, "by_group_ms": groups,
                            "idle_share": 1.0 - device_ms / 1e3 / wall,
                            "idle_share_after_first_batch":
                                1.0 - device_ms / 1e3 / (wall - t["first"]),
                            # the trace's own processing, left out of the
                            # epoch's and the run's times
                            "host_s": now() - end}
        log_epochs.append(e)

    def fit_end(*a, **k):
        t["fit"] = now()

    def model_save(*a, **k):
        log_epochs[-1]["last_save_ms"] = (now() - t.pop("fit")) * 1e3
        t["after_save"] = now()

    for hook, fn in (("on_train_epoch_start", epoch_start),
                     ("on_train_batch_start", batch_start),
                     ("on_train_batch_end", batch_end),
                     ("on_train_epoch_end", epoch_end),
                     ("on_fit_epoch_end", fit_end),
                     ("on_model_save", model_save),
                     ("on_train_end", lambda *a, **k: close_save())):
        cb.register_action(hook, "chip_smoke", fn)
    return cb


def cli_run(argv, expected, batch, profile_epochs=False):
    """One ``train.run`` of ``argv`` on the card: its save directory, the
    run's img/s (every image over the whole call's wall time, less the
    profiler's processing of its traces), the
    per-epoch timings (``cli_callbacks``; an epoch's img/s over its whole
    time, saves included, and its loop's img/s over the batches alone),
    peak memory, and the train kernels' launches (every count set to 0
    just before), which must be ``expected`` per step."""
    import torch

    from yolov5_obb_tpu_torch import train

    kernels = {n: k for n, k in _named_kernels().items() if n in expected}
    epochs = []
    cb = cli_callbacks(epochs, profile_epochs)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in _named_kernels().values():
        k.launches = 0
    t0 = time.perf_counter()
    save_dir, _, _ = train.run(train.parse_opt(argv), callbacks=cb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - sum(
        e.get("profile", {}).get("host_s", 0.0) for e in epochs)
    launches = {n: k.launches for n, k in kernels.items()}
    steps = sum(e["batches"] for e in epochs)
    for e in epochs:
        e["imgs_per_s"] = e["batches"] * batch / e["total_s"]
        e["loop_imgs_per_s"] = e["batches"] * batch / e["wall_s"]
    require(steps > 0 and all(launches[n] == steps * per
                              for n, per in expected.items()),
            f"train CLI launches {launches} over {steps} steps, expected per "
            f"step {expected}")
    return save_dir, {"epochs": epochs, "steps": steps, "run_s": wall,
                      "imgs_per_s": steps * batch / wall,
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "launches": launches}


def _csv_rows(path):
    lines = path.read_text().splitlines()
    keys = lines[0].split(",")
    return [dict(zip(keys, map(float, ln.split(",")))) for ln in lines[1:]]


def train_cli_path(dev, report, val_set):
    """Phase (g): the train CLI at yolov5m 1024² b16 bf16 on the card."""
    import torch

    from yolov5_obb_tpu_torch.data.shards import write_shards
    from yolov5_obb_tpu_torch.engine.evaluator import evaluate
    from yolov5_obb_tpu_torch.engine.optim import make_schedules
    from yolov5_obb_tpu_torch.models.yolo import build_model, create_model
    from yolov5_obb_tpu_torch.utils.checkpoint import (
        load_weights,
        restore_model_meta,
    )
    from yolov5_obb_tpu_torch.utils.general import load_hyp

    names = [f"c{i}" for i in range(15)]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    try:
        t0 = time.perf_counter()
        data, images = write_seeded_dota(tmp / "dota", CLI_IMAGES, IMGSZ, 11,
                                         names)
        hyp = load_hyp()
        shards = write_shards(seeded_train_set(data, images, MAX_LABELS, hyp),
                              tmp / "shards", aug_epochs=CLI_AUG_EPOCHS,
                              seed=0, verbose=False)
        del images
        proj = tmp / "runs"
        for name in ("stock", "fused"):
            (proj / name / "cache").mkdir(parents=True)
            (proj / name / "cache" / "shards").symlink_to(shards)
        setup_s = time.perf_counter() - t0
        log(f"train CLI set-up (set written, shards packed) {setup_s:.1f}s")
        argv = ["--cfg", "yolov5m.yaml", "--data", str(data), "--imgsz",
                str(IMGSZ), "--batch-size", str(BATCH), "--nominal-batch",
                str(BATCH), "--max-labels", str(MAX_LABELS), "--cache",
                "shards", "--workers", "2", "--noval", "--noautoanchor",
                "--device", "cuda", "--exist-ok", "--project", str(proj)]
        total = {}

        def add(launches):
            for n, v in launches.items():
                total[n] = total.get(n, 0) + v

        # two stock epochs
        stock_launches = with_bn_act(TRAIN_LAUNCHES, BN_BLOCKS["yolov5m"])
        run, stock = cli_run(argv + ["--epochs", str(CLI_EPOCHS), "--name",
                                     "stock"], stock_launches, BATCH)
        add(stock["launches"])
        rows = _csv_rows(run / "results.csv")
        losses = [[r[k] for k in r if k.startswith("train/")] for r in rows]
        log(f"train CLI stock epochs: loss items {losses}; {stock}")
        require(len(rows) == CLI_EPOCHS and np.isfinite(losses).all()
                and np.asarray(losses).max() > 0,
                f"train CLI loss items {losses}")
        _, want_meta, _ = build_model("yolov5m.yaml", nc=15)
        for sub in ("last", "best"):
            m = json.loads((run / sub / "meta.json").read_text())
            require((run / sub / "state.pt").is_file()
                    and np.array_equal(m["anchors"], want_meta.anchors_px),
                    f"{sub}/: missing or with other anchors than the model's")
        saved = torch.load(run / "last" / "state.pt", map_location="cpu",
                           weights_only=True)
        steps0 = stock["steps"]
        require(saved["step"] == saved["ema_updates"] == steps0
                and saved["opt_state"]["count"] == steps0,
                f"last/ counters {saved['step']}, {saved['ema_updates']}, "
                f"{saved['opt_state']['count']} after {steps0} steps")
        del saved

        # --resume of last/ for a third epoch, its loop under the profiler
        run_r, resumed = cli_run(argv + [
            "--epochs", str(CLI_EPOCHS + 1), "--name", "stock", "--resume",
            str(run / "last")], stock_launches, BATCH, profile_epochs=True)
        add(resumed["launches"])
        rows = _csv_rows(run_r / "results.csv")
        after = torch.load(run_r / "last" / "state.pt", map_location="cpu",
                           weights_only=True)
        n = steps0 + resumed["steps"]
        lr = make_schedules(hyp, CLI_EPOCHS + 1, CLI_IMAGES // BATCH)[0](n)
        resume = {"epochs_run": [e["epoch"] for e in resumed["epochs"]],
                  "csv_epochs": [int(r["epoch"]) for r in rows],
                  "step": after["step"], "ema_updates": after["ema_updates"],
                  "count": after["opt_state"]["count"],
                  "lr_logged": rows[-1]["x/lr0"], "lr_at_step": lr}
        log(f"train CLI resume: {resume}; {resumed}")
        require(run_r == run and resume["epochs_run"] == [CLI_EPOCHS]
                and resume["csv_epochs"] == list(range(CLI_EPOCHS + 1))
                and after["step"] == after["ema_updates"] == n
                and after["opt_state"]["count"] == n
                and abs(rows[-1]["x/lr0"] - lr) <= 1e-6
                and np.isfinite([rows[-1][k] for k in rows[-1]]).all(),
                f"resume did not continue the saved run: {resume}")
        del after

        # one --fused-train epoch
        _, fused = cli_run(argv + ["--epochs", "1", "--name", "fused",
                                   "--fused-train"], with_bn_act(
                                       FUSED_LAUNCHES,
                                       BN_BLOCKS["yolov5m_fused"]), BATCH)
        add(fused["launches"])
        log(f"train CLI fused epoch: {fused}")

        # best/ through load_weights, evaluate on phase (f)'s val set
        torch.cuda.synchronize()
        t = time.perf_counter()
        sd, ckpt_meta = load_weights(run / "best")
        load_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        full = torch.load(run / "last" / "state.pt", map_location="cpu",
                          weights_only=True)
        load_full_ms = (time.perf_counter() - t) * 1e3
        del full
        model, meta = create_model("yolov5m.yaml", nc=15,
                                   dtype=torch.bfloat16, device=dev,
                                   packed_stem=True)
        model.load_state_dict(sd)
        restore_model_meta(meta, ckpt_meta)
        kernels = {n: k for n, k in _named_kernels().items() if n in INFER}
        for k in kernels.values():
            k.launches = 0
        res = evaluate(model, meta, val_set, batch_size=BATCH,
                       conf_thres=VAL_CONF, iou_thres=VAL_IOU,
                       max_det=MAX_DET)
        torch.cuda.synchronize()
        ev_launches = {n: k.launches for n, k in kernels.items()}
        add(ev_launches)
        dets = res["detections"]
        finite = all(np.isfinite(d["polys"]).all()
                     and np.isfinite(d["conf"]).all() for d in dets)
        metrics = {k: res[k] for k in ("mp", "mr", "map50", "map")}
        log(f"best/ evaluated: {metrics}, dets/img "
            f"{np.mean([len(d['conf']) for d in dets]):.1f}, launches "
            f"{ev_launches}")
        require(all(v > 0 for v in ev_launches.values())
                and len(dets) == len(val_set) and finite
                and all(np.isfinite(v) for v in metrics.values()),
                f"best/ evaluate: launches {ev_launches}, finite {finite}, "
                f"metrics {metrics}")
        del model
        report["train_cli"] = {
            "setup_s": setup_s, "stock": stock, "resume": resume,
            "resumed": resumed, "fused": fused,
            "best_load_ms": load_ms, "last_load_ms": load_full_ms,
            "best_eval_metrics": metrics,
            "best_eval_ms_per_img": res["speed_ms_per_img"],
            "best_eval_launches": ev_launches}
        return total
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# (h) the DOTA flow: split → evaluate → merge → OBB mAP
# ---------------------------------------------------------------------------

# raw images at DOTA-v1.0 sizes (W, H): 25 + 20 + 12 + 6 = 63 tiles of
# 1024² at gap 200; objects a megapixel; the polygon-NMS threshold; the
# top-scored rows of the largest class file that the NumPy NMS runs on (it
# is quadratic in the rows: on the H100 machine's host 4485 rows took
# 4.48 s, 11534 rows 35.79 s)
RAW_SIZES = ((4000, 4000), (4000, 3000), (3000, 2000), (1900, 1500))
SUBSIZE, GAP, OBJ_PER_MP, MERGE_NMS = 1024, 200, 40, 0.2
NUMPY_NMS_ROWS = 4000


def _fill_polys(img, polys, colors) -> None:
    """Fill convex quads ``(n, 8)`` into ``img`` (H, W, 3) in place: each
    pixel centre inside all four edges of a quad takes its colour (NumPy;
    no OpenCV on the card)."""
    h, w = img.shape[:2]
    for poly, c in zip(polys, colors):
        p = poly.reshape(4, 2)
        x0, y0 = np.maximum(np.floor(p.min(0)).astype(int), 0)
        x1, y1 = np.minimum(np.ceil(p.max(0)).astype(int) + 1, (w, h))
        if x1 <= x0 or y1 <= y0:
            continue
        yy, xx = np.mgrid[y0:y1, x0:x1] + 0.5
        side = [(p[(k + 1) % 4, 0] - p[k, 0]) * (yy - p[k, 1])
                - (p[(k + 1) % 4, 1] - p[k, 1]) * (xx - p[k, 0])
                for k in range(4)]
        inside = np.all([s >= 0 for s in side], 0) | np.all(
            [s <= 0 for s in side], 0)
        img[y0:y1, x0:x1][inside] = c


def dota_raw_set(root, sizes, names, seed=0):
    """Seeded raw DOTA images (uniform noise, filled boxes) and their
    ``labelTxt/<stem>.txt``: about OBJ_PER_MP objects a megapixel over
    ``names``, long edges 10-180 px and a diagonal under the gap (so every
    object lies whole in some tile), some marked difficult; beside each
    inner window corner a box along the corner's diagonal that both window
    edges cut, so that its clip keeps 6 points.  Returns ``{stem: image}``
    (RGB)."""
    from yolov5_obb_tpu_torch.devkit.img_split import _tile_origins
    from yolov5_obb_tpu_torch.ops.geometry import rbox2poly

    rng = np.random.default_rng(seed)
    (root / "labelTxt").mkdir(parents=True, exist_ok=True)
    images = {}
    for k, (w, h) in enumerate(sizes):
        stem = f"P{k:04d}"
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        n = int(OBJ_PER_MP * w * h / 1e6)
        l = rng.uniform(10, 180, n)
        s = np.minimum(l * rng.uniform(0.2, 1.0, n),
                       np.sqrt(np.maximum((GAP - 2) ** 2 - l ** 2, 1.0)))
        half = np.sqrt(l ** 2 + s ** 2) / 2 + 1
        rb = [np.stack([rng.uniform(half, w - half), rng.uniform(half, h - half),
                        l, s, rng.uniform(-np.pi / 2, np.pi / 2, n)], 1)]
        # corner boxes: bottom-right corners of the windows but the last
        slide = SUBSIZE - GAP
        xs = [o + SUBSIZE for o in _tile_origins(w, SUBSIZE, slide)[:-1]]
        ys = [o + SUBSIZE for o in _tile_origins(h, SUBSIZE, slide)[:-1]]
        for cx in xs:
            for cy in ys:
                lc = rng.uniform(140, 170)
                d = lc / 2 ** 1.5 + rng.uniform(-3, 3)
                rb.append(np.array([[cx - d, cy - d, lc, rng.uniform(30, 40),
                                     np.pi / 4 + rng.uniform(-0.05, 0.05)]]))
        polys = rbox2poly(np.concatenate(rb))
        _fill_polys(img, polys, rng.integers(0, 256, (len(polys), 3)))
        cls = rng.integers(0, len(names), len(polys))
        diff = (rng.uniform(size=len(polys)) < 0.05).astype(int)
        (root / "labelTxt" / f"{stem}.txt").write_text("\n".join(
            " ".join(f"{v:.1f}" for v in p) + f" {names[c]} {d}"
            for p, c, d in zip(polys, cls, diff)) + "\n")
        images[stem] = img
    return images


def tile_set(tiles, label_dir, names):
    """The split's tiles in memory as phase (f)'s eval dataset, each named
    by its tile name, its labels (difficult 2 dropped) as ``[cls cx cy l s
    theta]`` in its pixels."""
    from yolov5_obb_tpu_torch.ops.geometry import poly2rbox

    labels = []
    for name, _ in tiles:
        rows = [l.split() for l in
                (label_dir / f"{name}.txt").read_text().splitlines()]
        rows = [r for r in rows if r[9] != "2"]
        polys = np.array([[float(v) for v in r[:8]] for r in rows],
                         np.float64).reshape(-1, 8)
        cls = np.array([names.index(r[8]) for r in rows], np.float32)
        labels.append(np.concatenate([cls[:, None], poly2rbox(polys)],
                                     1).astype(np.float32))
    require(max(len(t) for t in labels) <= VAL_LABELS,
            f"more than {VAL_LABELS} labels on a tile")
    ds = SeededValSet(np.stack([t for _, t in tiles]), labels, names)
    ds.img_files = [f"{name}.png" for name, _ in tiles]
    return ds


def _rows(path):
    return [l for l in Path(path).read_text().splitlines() if l]


def _merged_unmatched(dir_a, dir_b, names) -> tuple[int, int]:
    """Merged Task1 rows of ``dir_a`` with no row of the same class and
    image in ``dir_b`` at polygon IoU above 0.99, and the rows of
    ``dir_a``."""
    from yolov5_obb_tpu_torch.native import poly_overlaps_native

    unmatched = total = 0
    for c in names:
        def by_image(d):
            out = {}
            for r in _rows(Path(d) / f"Task1_{c}.txt"):
                p = r.split()
                out.setdefault(p[0], []).append([float(v) for v in p[2:10]])
            return out
        a, b = by_image(dir_a), by_image(dir_b)
        for img, pa in a.items():
            total += len(pa)
            if img not in b:
                unmatched += len(pa)
                continue
            iou = poly_overlaps_native(np.array(pa), np.array(b[img]))
            unmatched += int((iou.max(1) <= 0.99).sum())
    return unmatched, total


def _model_flow(tag, model, meta, ds, raw_labels, ids, names, out, plain):
    """``evaluate`` (val regime, save_json) on the tiles, then
    json_to_task1, the 8-worker merge and the OBB mAP and mAOE against
    the unsplit labels; each step timed."""
    import torch

    from yolov5_obb_tpu_torch.devkit.converters import json_to_task1
    from yolov5_obb_tpu_torch.devkit.evaluate import (
        evaluate_maoe,
        evaluate_task1,
    )
    from yolov5_obb_tpu_torch.devkit.result_merge import merge_by_poly_nms
    from yolov5_obb_tpu_torch.engine.evaluator import evaluate

    r = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = evaluate(model, meta, ds, batch_size=BATCH, conf_thres=VAL_CONF,
                   iou_thres=VAL_IOU, max_det=MAX_DET, plain=plain,
                   save_json=str(out / f"{tag}.json"))
    torch.cuda.synchronize()
    r["evaluate_ms_per_tile"] = (time.perf_counter() - t) * 1e3 / len(ds)
    r["evaluate_loop_ms_per_tile"] = res["speed_ms_per_img"]
    r["dets_per_tile"] = float(np.mean([len(d["conf"])
                                        for d in res["detections"]]))
    t = time.perf_counter()
    raw = json_to_task1(out / f"{tag}.json", out / f"{tag}_raw", names)
    r["json_to_task1_s"] = time.perf_counter() - t
    t = time.perf_counter()
    merge_by_poly_nms(raw, out / f"{tag}_merged", MERGE_NMS, num_workers=8)
    r["merge_8_workers_s"] = time.perf_counter() - t
    merged = sum(len(_rows(f)) for f in (out / f"{tag}_merged").iterdir())
    r["merged_dets"] = merged
    r["dets_per_raw_image"] = merged / len(ids)
    t = time.perf_counter()
    r["map"], _ = evaluate_task1(out / f"{tag}_merged", raw_labels, ids,
                                 names)
    r["evaluate_task1_s"] = time.perf_counter() - t
    t = time.perf_counter()
    r["maoe"], _ = evaluate_maoe(out / f"{tag}_merged", raw_labels, ids,
                                 names)
    r["maoe_s"] = time.perf_counter() - t
    return r


def _nms_native_vs_numpy(raw_dir, names):
    """The class file with the most rows, its largest image: the native
    and NumPy polygon NMS's keep lists on the same rows (the top
    NUMPY_NMS_ROWS by score), and both times."""
    from yolov5_obb_tpu_torch.devkit.result_merge import (
        poly_nms_np,
        read_task1_by_image,
    )
    from yolov5_obb_tpu_torch.native import poly_nms_native

    cls = max(names, key=lambda c: len(_rows(raw_dir / f"Task1_{c}.txt")))
    by_image = read_task1_by_image(raw_dir / f"Task1_{cls}.txt")
    stem, dets = max(by_image.items(), key=lambda kv: len(kv[1]))
    scores = np.array([d[0] for d in dets])
    polys = np.stack([d[1] for d in dets])
    t = time.perf_counter()
    poly_nms_native(polys, scores, MERGE_NMS)
    native_all_ms = (time.perf_counter() - t) * 1e3
    order = np.argsort(-scores, kind="stable")
    cap = min(len(order), NUMPY_NMS_ROWS)
    sub = order[:cap]
    t = time.perf_counter()
    keep_np = poly_nms_np(polys[sub], scores[sub], MERGE_NMS,
                          use_native=False)
    numpy_s = time.perf_counter() - t
    t = time.perf_counter()
    keep_nat = poly_nms_native(polys[sub], scores[sub], MERGE_NMS)
    native_ms = (time.perf_counter() - t) * 1e3
    return {"class": cls, "image": stem, "rows": len(order), "cap": cap,
            "kept": len(keep_nat), "same_keep": keep_np == keep_nat,
            "numpy_s": numpy_s, "native_ms_capped": native_ms,
            "native_ms_all_rows": native_all_ms}


def dota_flow(dev, report, delta, cfg="yolov5m.yaml", sizes=RAW_SIZES):
    """Phase (h): seeded raw DOTA images → the split in memory → the
    oracle round trip (tile labels → Task1 → merge → mAP, mAOE) → phase
    (c)'s density-tuned model through ``evaluate`` on the tiles, kernel
    and plain runs, each through json_to_task1, the merge and the OBB
    mAP; the merge's worker count and NMS path checked."""
    import resource

    import torch

    from yolov5_obb_tpu_torch import native
    from yolov5_obb_tpu_torch.data.dota import DOTA_V1_NAMES
    from yolov5_obb_tpu_torch.devkit import img_split
    from yolov5_obb_tpu_torch.devkit.converters import groundtruth_to_task1
    from yolov5_obb_tpu_torch.devkit.evaluate import (
        evaluate_maoe,
        evaluate_task1,
    )
    from yolov5_obb_tpu_torch.devkit.result_merge import merge_by_poly_nms
    from yolov5_obb_tpu_torch.engine.evaluator import evaluate, make_predict_fn

    names = list(DOTA_V1_NAMES)
    t_phase = time.perf_counter()
    lib = native.get_lib()
    require(lib is not None,
            f"the native polygon library did not load: {native.BUILD_ERROR}")
    log(f"polygon IoU/NMS: native C++ {native.so_path().name} (g++ "
        f"{' '.join(native.FLAGS)})")
    require(native.get_min_area_rect_lib() is not None,
            f"the native minimum-area rectangle did not load: "
            f"{native.BUILD_ERRORS}")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dota_"))
    r = {"raw_sizes": [list(s) for s in sizes]}
    try:
        t = time.perf_counter()
        raw = dota_raw_set(tmp / "raw", sizes, names)
        r["raw_set_s"] = time.perf_counter() - t
        ids = sorted(raw)
        labels = tmp / "raw" / "labelTxt"
        # 1. the split, in memory (no cv2): tiles and their label files
        tile_labels = tmp / "split" / "labelTxt"
        tile_labels.mkdir(parents=True)
        # count the clips that take the minimum-area rectangle (C++)
        rects, min_area_rect = [], img_split._min_area_rect
        img_split._min_area_rect = lambda p: (rects.append(len(p)),
                                              min_area_rect(p))[1]
        tiles, split_ms = [], []
        try:
            for stem in ids:
                t = time.perf_counter()
                objs = img_split.read_split_objects(labels / f"{stem}.txt")
                for name, tile, lines in img_split.split_image_array(
                        raw[stem], objs, stem, 1.0, SUBSIZE, GAP):
                    img_split.write_tile_labels(tile_labels / f"{name}.txt",
                                                lines)
                    tiles.append((name, np.ascontiguousarray(tile)))
                split_ms.append((time.perf_counter() - t) * 1e3)
        finally:
            img_split._min_area_rect = min_area_rect
        want = sum(len(img_split._tile_origins(h, SUBSIZE, SUBSIZE - GAP))
                   * len(img_split._tile_origins(w, SUBSIZE, SUBSIZE - GAP))
                   for w, h in sizes)
        require(len(tiles) == want and all(
            t.shape == (SUBSIZE, SUBSIZE, 3) for _, t in tiles),
            f"split: {len(tiles)} tiles, expected {want} of {SUBSIZE}²")
        r["tiles"] = len(tiles)
        r["split_ms_per_raw_image"] = split_ms
        r["min_area_rects"] = len(rects)
        r["min_area_rects_6_plus"] = sum(n >= 6 for n in rects)
        require(r["min_area_rects_6_plus"] > 0,
                "no clip of 6 or more points went through the minimum-area "
                "rectangle")
        log(f"split: {len(tiles)} tiles from {len(ids)} raw images "
            f"{[list(s) for s in sizes]}, ms per raw image "
            f"{[round(v, 1) for v in split_ms]}, {r['min_area_rects']} "
            f"minimum-area rectangles ({r['min_area_rects_6_plus']} of "
            f"clips of 6 or more points)")

        # 2. the oracle round trip: the tile labels as detections
        t = time.perf_counter()
        gt_raw = groundtruth_to_task1(tile_labels, tmp / "gt_raw", names,
                                      skip_difficult2=True)
        merge_by_poly_nms(gt_raw, tmp / "gt_merged", MERGE_NMS,
                          num_workers=8)
        r["oracle_map"], _ = evaluate_task1(tmp / "gt_merged", labels, ids,
                                            names)
        r["oracle_maoe"], _ = evaluate_maoe(tmp / "gt_merged", labels, ids,
                                            names)
        r["oracle_s"] = time.perf_counter() - t
        log(f"oracle round trip: mAP {r['oracle_map']:.4f}, mAOE "
            f"{r['oracle_maoe']:.3f}° ({r['oracle_s']:.2f} s)")
        require(r["oracle_map"] > 0.95 and r["oracle_maoe"] < 5.0,
                f"oracle round trip: mAP {r['oracle_map']}, mAOE "
                f"{r['oracle_maoe']}")

        # 3. the model on the tiles, kernel and plain runs
        model, meta, set_obj = density_model(dev, cfg)
        set_obj(delta)
        ds = tile_set(tiles, tile_labels, names)
        kernels = {n: k for n, k in _named_kernels().items() if n in INFER}
        for k in kernels.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        r["kernel"] = _model_flow("kernel", model, meta, ds, labels, ids,
                                  names, tmp, plain=False)
        launches = {n: k.launches for n, k in kernels.items()}
        r["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        require(all(v > 0 for v in launches.values()),
                f"DOTA flow: kernel not launched: {launches}")
        r["plain"] = _model_flow("plain", model, meta, ds, labels, ids,
                                 names, tmp, plain=True)
        # the predict calls alone on the tiles' batches
        predict = make_predict_fn(model, meta, VAL_CONF, VAL_IOU, MAX_DET,
                                  max_candidates=VAL_MAXC)
        xs = []
        for i in range(0, len(tiles), BATCH):
            b = [t for _, t in tiles[i:i + BATCH]]
            b += [b[-1]] * (BATCH - len(b))
            xs.append(torch.from_numpy(np.stack(b)).to(dev).reshape(
                BATCH, SUBSIZE, -1))
        predict(xs[0])
        torch.cuda.synchronize()
        t = time.perf_counter()
        for x in xs:
            predict(x)[1].cpu()
        r["predict_ms_per_tile"] = ((time.perf_counter() - t) * 1e3
                                    / (len(xs) * BATCH))
        # evaluate alone in turns (no JSON): kernel, plain, kernel, plain
        turns = []
        for plain in (False, True, False, True):
            torch.cuda.synchronize()
            t = time.perf_counter()
            evaluate(model, meta, ds, batch_size=BATCH, conf_thres=VAL_CONF,
                     iou_thres=VAL_IOU, max_det=MAX_DET, plain=plain)
            torch.cuda.synchronize()
            turns.append((time.perf_counter() - t) * 1e3 / len(ds))
        r["evaluate_turns_ms_per_tile"] = turns
        kc, pc = r["kernel"]["merged_dets"], r["plain"]["merged_dets"]
        require(abs(kc - pc) <= 0.01 * pc,
                f"merged detections: kernel {kc}, plain {pc}")
        un_k, tot_k = _merged_unmatched(tmp / "kernel_merged",
                                        tmp / "plain_merged", names)
        un_p, tot_p = _merged_unmatched(tmp / "plain_merged",
                                        tmp / "kernel_merged", names)
        r["merged_unmatched"] = [un_k, tot_k, un_p, tot_p]
        log(f"merged detections without a same-class counterpart at IoU > "
            f"0.99: kernel {un_k} of {tot_k}, plain {un_p} of {tot_p}")
        require(un_k <= 0.01 * tot_k and un_p <= 0.01 * tot_p,
                f"merged detections unmatched: {r['merged_unmatched']}")

        # 4. the merge: 1 worker writes the 8 workers' text; native and
        # NumPy NMS keep the same rows
        t = time.perf_counter()
        merge_by_poly_nms(tmp / "kernel_raw", tmp / "kernel_merged_1",
                          MERGE_NMS, num_workers=1)
        r["merge_1_worker_s"] = time.perf_counter() - t
        for f in sorted((tmp / "kernel_merged").iterdir()):
            require(f.read_text() == (tmp / "kernel_merged_1"
                                      / f.name).read_text(),
                    f"merge: 8 and 1 workers wrote different {f.name}")
        r["nms"] = _nms_native_vs_numpy(tmp / "kernel_raw", names)
        require(r["nms"]["same_keep"],
                f"native and NumPy polygon NMS keep different rows: "
                f"{r['nms']}")
        r["host_peak_rss_gib"] = (resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2**20)
        r["phase_s"] = time.perf_counter() - t_phase
        k, p = r["kernel"], r["plain"]
        log(f"DOTA flow: evaluate {k['evaluate_ms_per_tile']:.2f} ms/tile "
            f"(plain {p['evaluate_ms_per_tile']:.2f}; without the JSON in "
            f"turns kernel, plain, kernel, plain "
            f"{[round(v, 2) for v in r['evaluate_turns_ms_per_tile']]}), predict "
            f"{r['predict_ms_per_tile']:.2f} ms/tile; detections "
            f"{k['dets_per_tile']:.1f} a tile before the merge, "
            f"{k['dets_per_raw_image']:.1f} a raw image after it (plain "
            f"{p['dets_per_tile']:.1f}, {p['dets_per_raw_image']:.1f}); "
            f"json_to_task1 {k['json_to_task1_s']:.3f} s; merge "
            f"{k['merge_8_workers_s']:.3f} s (8 workers), "
            f"{r['merge_1_worker_s']:.3f} s (1 worker); polygon NMS on "
            f"{r['nms']['class']} in {r['nms']['image']} "
            f"({r['nms']['rows']} rows): native "
            f"{r['nms']['native_ms_all_rows']:.1f} ms, NumPy "
            f"{r['nms']['numpy_s']:.2f} s on the top {r['nms']['cap']} "
            f"rows (native {r['nms']['native_ms_capped']:.1f} ms on "
            f"them); evaluate_task1 {k['evaluate_task1_s']:.2f} s, mAOE "
            f"{k['maoe_s']:.2f} s; peak {r['peak_mem_gib']:.2f} GiB on the "
            f"card, host RSS {r['host_peak_rss_gib']:.2f} GiB; mAP / mAOE: "
            f"oracle {r['oracle_map']:.4f} / {r['oracle_maoe']:.3f}°, "
            f"kernel {k['map']:.4f} / {k['maoe']:.3f}°, plain "
            f"{p['map']:.4f} / {p['maoe']:.3f}°; phase {r['phase_s']:.1f} s "
            f"on {card_line()}")
        report["dota_flow"] = r
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


DETECT_SIZES = ((1024, 1024),) * 12 + ((1024, 768),) * 4  # (w, h)
SERVE_CLIENTS, SERVE_ROUNDS = 4, 4


def detect_images(root, seed=3):
    """Phase (i)'s PNGs: phase (h)'s recipe (uniform noise, about
    OBJ_PER_MP filled boxes a megapixel) at DETECT_SIZES, rows filtered by
    the five PNG filters in turn.  Returns (paths, BGR arrays)."""
    from yolov5_obb_tpu_torch.ops.geometry import rbox2poly
    from yolov5_obb_tpu_torch.utils.image_io import write_png

    rng = np.random.default_rng(seed)
    paths, images = [], []
    for k, (w, h) in enumerate(DETECT_SIZES):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        n, e = int(OBJ_PER_MP * w * h / 1e6), min(100, w // 4, h // 4)
        rb = np.stack([rng.uniform(e, w - e, n),
                       rng.uniform(e, h - e, n), rng.uniform(10, 180, n),
                       rng.uniform(8, 60, n),
                       rng.uniform(-np.pi / 2, np.pi / 2, n)], 1)
        _fill_polys(img, rbox2poly(rb), rng.integers(0, 256, (n, 3)))
        path = root / f"im{k:02d}.png"
        write_png(path, img, filters=(0, 1, 2, 3, 4))  # img as RGB
        paths.append(path)
        images.append(np.ascontiguousarray(img[..., ::-1]))
    return paths, images


def _label_rows(text):
    """A detect label file → float64 rows ``[poly (8) conf cls]``."""
    import torch

    a = np.array([[float(v) for v in line.split()]
                  for line in text.splitlines()], np.float64).reshape(-1, 10)
    return torch.as_tensor(np.c_[a[:, 1:9], a[:, 9], a[:, 0]])


def _bars(got, want) -> dict:
    """Phase (f)'s bars between two runs' per-image rows ``[poly conf
    cls]``: images whose counts differ by more than 1%, rows without a
    same-class counterpart, rows in all."""
    un = sum(_unmatched(g, w, _polys_tol(w)) for g, w in zip(got, want))
    return {"count_diff_images": _count_diff([len(g) for g in got],
                                             [len(w) for w in want]),
            "unmatched": un,
            "rows": sum(len(g) + len(w) for g, w in zip(got, want))}


def _bars_hold(b) -> bool:
    return b["count_diff_images"] == 0 and b["unmatched"] <= 0.01 * b["rows"]


def _detect_cli(argv):
    """``detect.main(argv)`` with its output captured: (label texts by
    image stem, pre-process ms/img, inference+NMS ms/img, seconds)."""
    import contextlib
    import io

    from yolov5_obb_tpu_torch import detect

    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        save_dir = detect.main(argv)
    secs = time.perf_counter() - t
    m = re.search(r"Speed: ([\d.]+)ms pre-process, ([\d.]+)ms "
                  r"inference\+NMS", buf.getvalue())
    require(m is not None, f"detect printed no speed line: {buf.getvalue()}")
    labels = {p.stem: p.read_text()
              for p in sorted((save_dir / "labels").iterdir())}
    return labels, float(m[1]), float(m[2]), secs


def _keep_masks(rb, sc, cid, kk):
    """The keep masks of the kernel NMS and of the plain one on the same
    candidates (the first ``kk``): the count of rows where they differ."""
    from yolov5_obb_tpu_torch.ops.rotated_nms import nms_rotated

    args = (rb[:, :kk].contiguous(), sc[:, :kk].contiguous(), IOU)
    kw = dict(class_ids=cid[:, :kk].contiguous(), presorted=True)
    return int((nms_rotated(*args, **kw)
                != nms_rotated(*args, plain=True, **kw)).sum())


F32_MAX_DET = 3000  # (i2), (i3): above the ensemble's ~1000 a PNG


def _f32_reference(preds, meta):
    """Decoded float32 predictions per image → (keep-mask mismatches of the
    kernel NMS against the plain one on the same candidates, the plain
    run's detections per image); as the detect CLI: multi-label, conf 0.25,
    IoU 0.45, 4096 candidates, max_det F32_MAX_DET."""
    from yolov5_obb_tpu_torch.ops import rotated_nms as R

    mism, counts = 0, []
    for pred in preds:
        rb, sc, cid = R.obb_candidates(pred, meta.nc, CONF, 4096, True)
        kk = R._tier(sc.shape[1], int((sc > 0).sum(1).max()))
        mism += _keep_masks(rb, sc, cid, kk)
        _, n = R.non_max_suppression_obb(pred, meta.nc, CONF, IOU, 4096,
                                         F32_MAX_DET, True, plain=True)
        counts.append(int(n[0]))
    return mism, counts


class StepCounter:
    """A phase's steps, each driven by :meth:`run` with every kernel's
    count at 0 just before it and read just after: ``r[<step>_launches]``
    the step's launches, ``steps[<step>]`` its seconds, ``launches`` the
    phase's sum."""

    def __init__(self, kernels, r, steps):
        self.kernels, self.r, self.steps, self.launches = kernels, r, steps, {}

    def run(self, step, fn):
        import torch

        for k in self.kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.steps[step] = time.perf_counter() - t
        got = {n: k.launches for n, k in self.kernels.items()}
        for n, v in got.items():
            self.launches[n] = self.launches.get(n, 0) + v
        self.r[f"{step}_launches"] = got
        return out


def detect_surface(dev, report, delta, cfg="yolov5m.yaml"):
    """Phase (i): the detect CLI, TTA, the ensemble, the Python API and the
    REST server on the port, each against its plain run."""
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    import torch

    from yolov5_obb_tpu_torch import api, native
    from yolov5_obb_tpu_torch.data.augment import letterbox
    from yolov5_obb_tpu_torch.data.dota import DOTA_V1_NAMES
    from yolov5_obb_tpu_torch.detect import label_lines
    from yolov5_obb_tpu_torch.engine.evaluator import (
        load_ensemble_members,
        make_predict_fn,
        pack_images,
    )
    from yolov5_obb_tpu_torch.models.tta import predict_tta
    from yolov5_obb_tpu_torch.models.yolo import decode
    from yolov5_obb_tpu_torch.ops.geometry import rbox2poly, scale_polys
    from yolov5_obb_tpu_torch.serve import _Worker, make_handler
    from yolov5_obb_tpu_torch.utils import image_io
    from yolov5_obb_tpu_torch.utils.checkpoint import save_weights

    t_phase = time.perf_counter()
    names = list(DOTA_V1_NAMES)
    card = card_line()
    kernels = {n: k for n, k in _named_kernels().items() if n in INFER}
    r, steps = {}, {}
    counter = StepCounter(kernels, r, steps)
    counted, launches = counter.run, counter.launches

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_detect_"))
    try:
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        (tmp / "images").mkdir()
        paths, images = detect_images(tmp / "images")
        steps["images"] = time.perf_counter() - t
        n_img = len(paths)
        # the reader: the files decode to the arrays written, no OpenCV
        require(native.get_png_lib() is not None,
                f"the native PNG unfilter did not load: "
                f"{native.BUILD_ERRORS}")
        data = paths[0].read_bytes()
        for path, img in zip(paths, images):
            require(np.array_equal(image_io.imread(path), img),
                    f"{path.name} does not decode to the image written")
        dec = {}
        for native_ in (True, False):
            t = time.perf_counter()
            got = image_io.decode_png(data, use_native=native_)
            dec["native" if native_ else "numpy"] = (
                time.perf_counter() - t) * 1e3
            require(np.array_equal(got, images[0]), "PNG decode differs")
        r["png_decode_ms_1024"] = dec

        # the models: phase (c)'s density-tuned yolov5m (seed 0) and a
        # second member from seed 1, tuned the same way
        t = time.perf_counter()
        model, meta, set_obj = density_model(dev, cfg)
        set_obj(delta)
        model2, meta2, set_obj2 = density_model(dev, cfg, seed=1)
        x = torch.from_numpy(np.stack([
            letterbox(im, IMGSZ, auto=False, scaleup=False)[0][..., ::-1]
            for im in images])).to(dev)
        delta2 = tune_density(
            make_predict_fn(model2, meta2, CONF, IOU, MAX_DET,
                            multi_label=False, max_candidates=MAXC),
            set_obj2, pack_images(x))
        w1, w2 = tmp / "w1", tmp / "w2"
        for w, m, mt in ((w1, model, meta), (w2, model2, meta2)):
            save_weights(w, m.state_dict(), {
                "cfg": cfg, "names": names,
                "anchors": np.asarray(mt.anchors_px).tolist()})
        del model2
        steps["models"] = time.perf_counter() - t
        r["obj_delta_seed1"] = delta2
        src = str(tmp / "images")
        common = ["--cfg", cfg, "--source", src, "--imgsz", str(IMGSZ),
                  "--conf-thres", str(CONF), "--iou-thres", str(IOU),
                  "--nosave", "--save-txt", "--save-conf", "--project",
                  str(tmp / "runs"), "--exist-ok"]

        # (i1) the detect CLI in bf16, against the plain predict
        labels, pre, inf, secs = counted("i1_detect", lambda: _detect_cli(
            ["--weights", str(w1), "--dtype", "bfloat16", "--name", "bf16"]
            + common))
        got = r["i1_detect_launches"]
        require(all(got[k] == n_img for k in ("stem_l1", "c3", "down"))
                and got["riou_boxes"] >= n_img and got["neighbor"] >= n_img,
                f"detect CLI launches: {got} for {n_img} images")
        plain = make_predict_fn(model, meta, CONF, IOU, 1000,
                                multi_label=True, plain=True)
        want, want_txt = [], {}
        with torch.inference_mode():
            for path, im in zip(paths, images):
                lb = letterbox(im, IMGSZ, auto=False, scaleup=False)[0]
                d, n = plain(torch.from_numpy(pack_images(
                    np.ascontiguousarray(lb[..., ::-1])[None])).to(dev))
                d = d[0, :int(n[0])].float().cpu().numpy()
                polys = (scale_polys((IMGSZ, IMGSZ), rbox2poly(d[:, :5]),
                                     im.shape[:2]) if len(d)
                         else np.zeros((0, 8)))
                want_txt[path.stem] = label_lines(polys, d[:, 5], d[:, 6],
                                                  True)
        stems = [p.stem for p in paths]
        require(sorted(labels) == stems, f"detect CLI labels: {sorted(labels)}")
        r["i1_bars"] = _bars([_label_rows(labels[s]) for s in stems],
                             [_label_rows(want_txt[s]) for s in stems])
        r["i1_dets_per_img"] = sum(len(_label_rows(labels[s]))
                                   for s in stems) / n_img
        r["i1_speed_ms"] = {"pre": pre, "inference_nms": inf}
        require(_bars_hold(r["i1_bars"]),
                f"detect CLI against the plain predict: {r['i1_bars']}")

        # float32 references: the unpacked models the CLI builds for (i2)
        # and (i3), through their kernel-free forwards
        members, _ = load_ensemble_members([str(w1), str(w2)], cfg, 15,
                                           device=dev)
        f32_inputs = [torch.from_numpy(np.ascontiguousarray(letterbox(
            im, IMGSZ, auto=False, scaleup=False)[0][..., ::-1])[None]).to(
                dev).float() / 255.0 for im in images]
        for step, flags in (("i2_augment", ["--augment"]),
                            ("i3_ensemble", [])):
            weights = str(w1) if step == "i2_augment" else f"{w1},{w2}"
            labels, pre, inf, secs = counted(step, lambda: _detect_cli(
                ["--weights", weights, "--dtype", "float32", "--name", step,
                 "--max-det", str(F32_MAX_DET)] + flags + common))
            got = r[f"{step}_launches"]
            require(got["riou_boxes"] > 0 and got["neighbor"] > 0,
                    f"{step}: row 4 not launched: {got}")
            with torch.inference_mode():
                if step == "i2_augment":
                    m0, mt0 = members[0]
                    preds = [predict_tta(m0, mt0, xi) for xi in f32_inputs]
                else:
                    preds = [torch.cat([decode(m(xi), mt, (IMGSZ, IMGSZ))
                                        for m, mt in members], 1)
                             for xi in f32_inputs]
                mism, counts = _f32_reference(preds, meta)
            cli_counts = [len(_label_rows(labels[s])) for s in stems]
            r[f"{step}_keep_mismatches"] = mism
            r[f"{step}_dets_per_img"] = sum(cli_counts) / n_img
            r[f"{step}_speed_ms"] = {"pre": pre, "inference_nms": inf}
            require(mism == 0, f"{step}: {mism} keep-mask mismatches")
            require(cli_counts == counts,
                    f"{step}: detections per image {cli_counts}, plain "
                    f"{counts}")
        del members, f32_inputs

        # (i4) the Python API in bf16: arrays and paths, against plain
        obb = api.load(cfg, weights=str(w1), names=names, imgsz=IMGSZ,
                       conf_thres=CONF, iou_thres=IOU, max_det=1000,
                       dtype=torch.bfloat16)
        res = counted("i4_api", lambda: obb(images))
        require(r["i4_api_launches"]["neighbor"] > 0
                and r["i4_api_launches"]["stem_l1"] > 0,
                f"API launches: {r['i4_api_launches']}")
        res_p = obb([str(p) for p in paths])
        require(all(np.array_equal(a, b) and np.array_equal(c, d)
                    for a, b, c, d in zip(res.polys, res_p.polys, res.confs,
                                          res_p.confs)),
                "the API's detections of the paths differ from the arrays'")
        torch.cuda.synchronize()
        t = time.perf_counter()
        obb(images)
        torch.cuda.synchronize()
        r["i4_api_ms_per_img"] = (time.perf_counter() - t) * 1e3 / n_img
        plain1 = make_predict_fn(obb.model, obb.meta, CONF, IOU, 1000,
                                 multi_label=False, plain=True)
        d_p, n_p = plain1(pack_images(x) if plain1.packed_stem else x)
        rows = lambda polys, confs, clses: torch.as_tensor(np.c_[
            np.asarray(polys, np.float64).reshape(-1, 8), confs, clses])
        want = []
        for i, im in enumerate(images):
            d = d_p[i, :int(n_p[i])].float().cpu().numpy()
            polys = (scale_polys((IMGSZ, IMGSZ), rbox2poly(d[:, :5]),
                                 im.shape[:2]) if len(d) else np.zeros((0, 8)))
            want.append(rows(polys, d[:, 5], d[:, 6]))
        api_rows = [rows(p, c, k) for p, c, k in zip(res.polys, res.confs,
                                                      res.clses)]
        r["i4_bars"] = _bars(api_rows, want)
        require(_bars_hold(r["i4_bars"]),
                f"API against the plain predict: {r['i4_bars']}")

        # (i5) the REST server, in process
        worker = _Worker(obb)
        worker.start()
        srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(worker))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}/v1/obb-detection"
        bodies = [p.read_bytes() for p in paths]
        replies, lat = {}, []

        def post(body):
            req = urllib.request.Request(url, data=body, method="POST")
            with urllib.request.urlopen(req, timeout=300) as rep:
                return rep.status, json.loads(rep.read())

        def client(c):
            for j in range(SERVE_ROUNDS * n_img // SERVE_CLIENTS):
                i = (c * 4 + j) % n_img
                t0 = time.perf_counter()
                replies[(c, j)] = (i, *post(bodies[i]))
                lat.append((time.perf_counter() - t0) * 1e3)

        try:
            def serve_all():
                ts = [threading.Thread(target=client, args=(c,))
                      for c in range(SERVE_CLIENTS)]
                for th in ts:
                    th.start()
                for th in ts:
                    th.join(timeout=600)

            t = time.perf_counter()
            counted("i5_serve", serve_all)
            wall = time.perf_counter() - t
            require(len(replies) == SERVE_ROUNDS * n_img
                    and all(st == 200 for _, st, _ in replies.values()),
                    f"serve: {len(replies)} replies, statuses "
                    f"{sorted({st for _, st, _ in replies.values()})}")
            key = [f"{ax}{k + 1}" for k in range(4) for ax in "xy"]
            got_rows = [torch.as_tensor([[row[k] for k in key]
                                         + [row["confidence"], row["class"]]
                                         for row in rows_],
                                        dtype=torch.float64).reshape(-1, 10)
                        for _, _, rows_ in replies.values()]
            r["i5_bars"] = _bars(got_rows, [api_rows[i]
                                            for i, _, _ in replies.values()])
            require(_bars_hold(r["i5_bars"]),
                    f"serve against the API: {r['i5_bars']}")
            try:
                post(b"not an image")
                require(False, "serve answered a junk body")
            except urllib.error.HTTPError as e:
                require(e.code == 400, f"serve: junk body got {e.code}")
        finally:
            srv.shutdown()
            srv.server_close()
        lat_a = np.array(lat)
        r["i5_serve"] = {
            "requests": len(lat), "wall_s": wall,
            "req_per_s": len(lat) / wall,
            "latency_ms_p50": float(np.percentile(lat_a, 50)),
            "latency_ms_p90": float(np.percentile(lat_a, 90)),
            "latency_ms_max": float(lat_a.max()),
            "batch_sizes": list(worker.batch_sizes)}
        r["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        r["steps_s"] = steps
        r["phase_s"] = time.perf_counter() - t_phase
        s5 = r["i5_serve"]
        log(f"detect surface on {card}: PNG decode of a 1024² image "
            f"{dec['native']:.1f} ms native, {dec['numpy']:.0f} ms NumPy; "
            f"detect CLI bf16 {pre_fmt(r['i1_speed_ms'])} "
            f"({r['i1_dets_per_img']:.1f} dets/img, bars {r['i1_bars']}); "
            f"--augment f32 {pre_fmt(r['i2_augment_speed_ms'])}; ensemble "
            f"f32 {pre_fmt(r['i3_ensemble_speed_ms'])}; keep-mask mismatches "
            f"{r['i2_augment_keep_mismatches']} / "
            f"{r['i3_ensemble_keep_mismatches']}; API "
            f"{r['i4_api_ms_per_img']:.2f} ms/img at {n_img} (bars "
            f"{r['i4_bars']}); serve {s5['requests']} requests in "
            f"{s5['wall_s']:.2f} s, {s5['req_per_s']:.2f} req/s, latency "
            f"p50/p90/max {s5['latency_ms_p50']:.1f} / "
            f"{s5['latency_ms_p90']:.1f} / {s5['latency_ms_max']:.1f} ms, "
            f"batches {s5['batch_sizes']} (bars {r['i5_bars']}); peak "
            f"{r['peak_mem_gib']:.2f} GiB; steps "
            f"{ {k: round(v, 2) for k, v in steps.items()} }; phase "
            f"{r['phase_s']:.1f} s")
        report["detect_surface"] = r
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# (j) the model zoo
# ---------------------------------------------------------------------------

ZOO_SIZE, ZOO_BATCH = 256, 2  # (j1): every bundled config
M6_CFG, M6_SIZE = "yolov5m6.yaml", 1280  # (j2), (j3): the P6 native size
TR_CFG = "yolov5s-transformer.yaml"  # (j4), at IMGSZ
ZOO_ITERS, ZOO_TRAIN_ITERS = 8, 6
TRAIN_MEM_CAP_GIB = 60  # (j3): batch 16 if phase (d)'s peak, scaled, fits


def zoo_configs():
    from yolov5_obb_tpu_torch.models import yolo

    return sorted(p.name for p in (Path(yolo.__file__).parent
                                   / "configs").glob("*.yaml")
                  if p.name != "anchors.yaml")


def zoo_batch(gen, model, batch, size, dev):
    """A seeded uint8 batch: the packed (B, H, 3W) view for a packed-stem
    model, NHWC otherwise."""
    import torch

    x = torch.randint(0, 256, (batch, size, size * 3), generator=gen,
                      device=dev, dtype=torch.uint8)
    return x if model.packed_stem else x.view(batch, size, size, 3)


def _maps_bar(scale: float) -> float:
    """The Detect maps' bar, kernels against plain: row 2's 0.06 or one
    bf16 ulp of the maps' largest value, whichever is larger."""
    return max(0.06, 2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7))


def kernels_wanted(model, x) -> set:
    """The inference kernels this model's predict must launch on ``x``:
    row 4 (records and neighbour scan) always; the stem+L1 kernel where
    layers 0-1 fold, else the stem kernel where the stem is packed; the C3
    and downsample kernels where a layer is eligible at its input (forward
    pre-hooks on a plain forward)."""
    import torch

    from yolov5_obb_tpu_torch.models import layers as L

    want = {"riou_boxes", "neighbor"}
    if model.packed_l1:
        want.add("stem_l1")
    elif model.packed_stem:
        want.add("stem")

    def hook(m, args):
        if isinstance(m, L.C3) and m.eligible(args[0]):
            want.add("c3")
        if type(m) is L.ConvBnAct and m.down_eligible(args[0]):
            want.add("down")
    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, (L.C3, L.ConvBnAct))]
    try:
        with torch.inference_mode():
            model(x if model.packed_stem else x.float() / 255.0, plain=True)
    finally:
        for h in hooks:
            h.remove()
    return want


def predict_vs_plain(model, meta, xs):
    """One counted single-label predict a batch through the kernels
    (phase (c)'s conf, IoU, candidates, max_det), then the same batches
    through the plain versions: each inference kernel's launches, the
    Detect maps' max |Δ| and their scale, the keep masks of both NMS
    versions on the kernel path's own candidates (rows that differ), the
    detections per image of both runs."""
    import torch

    from yolov5_obb_tpu_torch.engine.evaluator import make_predict_fn

    kw = dict(multi_label=False, max_candidates=MAXC)
    predict = make_predict_fn(model, meta, CONF, IOU, MAX_DET, **kw)
    plain = make_predict_fn(model, meta, CONF, IOU, MAX_DET, plain=True,
                            **kw)
    kernels = {n: k for n, k in _named_kernels().items()
               if n in INFER + ("stem",)}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    outs = [predict(x) for x in xs]
    torch.cuda.synchronize()
    res = {"launches": {n: k.launches for n, k in kernels.items()},
           "maps_abs_err": 0.0, "maps_scale": 0.0, "keep_mismatches": 0,
           "candidates_max": 0, "dets": [], "dets_plain": []}
    with torch.inference_mode():
        for x, (d_k, n_k) in zip(xs, outs):
            require(d_k.shape == (x.shape[0], MAX_DET, 7)
                    and bool(torch.isfinite(d_k).all()),
                    f"detections {tuple(d_k.shape)}, finite "
                    f"{bool(torch.isfinite(d_k).all())}")
            inp = x if model.packed_stem else x.float() / 255.0
            maps_k = model(inp)
            for a, b in zip(maps_k, model(inp, plain=True)):
                res["maps_abs_err"] = max(res["maps_abs_err"], float(
                    (a.float() - b.float()).abs().max()))
                res["maps_scale"] = max(res["maps_scale"],
                                        float(b.float().abs().max()))
            res["dets_plain"] += plain(x)[1].tolist()
            res["dets"] += n_k.tolist()
            rb, sc, cid, kk = path_candidates(maps_k, meta)
            res["keep_mismatches"] += _keep_masks(rb, sc, cid, kk)
            res["candidates_max"] = max(res["candidates_max"],
                                        int((sc > 0).sum(1).max()))
    res["dets_abs_diff"] = int(sum(abs(a - b) for a, b in
                                   zip(res["dets"], res["dets_plain"])))
    return res


def _hold(tag, res, want, det_bar):
    """The bars of (j1), (j2), (j4): the kernels in ``want`` launched and
    no other, the maps within :func:`_maps_bar`, 0 keep-mask mismatches,
    the detections' differences within ``det_bar``."""
    launched = {n for n, v in res["launches"].items() if v}
    require(launched == want, f"{tag}: kernels launched {res['launches']}, "
            f"wanted {sorted(want)}")
    require(res["maps_abs_err"] <= _maps_bar(res["maps_scale"]),
            f"{tag}: Detect maps differ from the plain run's by "
            f"{res['maps_abs_err']:.4g} at scale {res['maps_scale']:.4g}")
    require(res["keep_mismatches"] == 0,
            f"{tag}: {res['keep_mismatches']} keep-mask mismatches")
    require(res["dets_abs_diff"] <= det_bar,
            f"{tag}: detections differ from the plain run's by "
            f"{res['dets_abs_diff']} (bar {det_bar:.1f}): {res}")
    require(min(res["dets"]) > 0, f"{tag}: an image without detections")


def zoo_configs_path(dev, report):
    """(j1) every bundled config at its published width, nc 15, bf16,
    packed stem where the config has the Conv(6, 2) stem, random weights
    from a seed with the detection density tuned, its strides probed; one
    predict of a seeded batch of ZOO_BATCH at ZOO_SIZE² against its plain
    run (phase (c)'s bar on the detections, :func:`_maps_bar` on the maps,
    keep masks exact).  The kernel gates are the default's scaled with the
    image, (ZOO_SIZE / 4)², so layers 2 and 3 take the C3 and downsample
    kernels as they do at 1024²."""
    import torch

    from yolov5_obb_tpu_torch.engine.evaluator import make_predict_fn
    from yolov5_obb_tpu_torch.models import layers

    gates = layers.FUSED_C3_MIN_SPATIAL, layers.FUSED_DOWN_MIN_SPATIAL
    layers.FUSED_C3_MIN_SPATIAL = layers.FUSED_DOWN_MIN_SPATIAL = \
        (ZOO_SIZE // 4) ** 2
    gen = torch.Generator(device=dev).manual_seed(16)
    out, launches = {}, {}
    try:
        for seed, cfg in enumerate(zoo_configs()):
            t = time.perf_counter()
            model, meta, set_obj = density_model(dev, cfg, seed=seed)
            x = zoo_batch(gen, model, ZOO_BATCH, ZOO_SIZE, dev)
            delta = tune_density(make_predict_fn(
                model, meta, CONF, IOU, MAX_DET, multi_label=False,
                max_candidates=MAXC), set_obj, x)
            want = kernels_wanted(model, x)
            if cfg.startswith("yolov3"):
                require(want == {"riou_boxes", "neighbor"},
                        f"{cfg}: {sorted(want)}")
            elif cfg != "yolov5s-ghost.yaml":
                require({"stem_l1", "c3", "down"} <= want,
                        f"{cfg}: {sorted(want)}")
            res = predict_vs_plain(model, meta, [x])
            total = sum(res["dets_plain"])
            _hold(cfg, res, want, max(10, 0.02 * total))
            for n, v in res["launches"].items():
                launches[n] = launches.get(n, 0) + v
            out[cfg] = {"strides": list(meta.strides), "nl": meta.nl,
                        "packed_stem": model.packed_stem,
                        "packed_l1": model.packed_l1, "obj_delta": delta,
                        "params_m": sum(p.numel() for p in
                                        model.parameters()) / 1e6,
                        "s": time.perf_counter() - t, **res}
            log(f"(j1) {cfg}: " + json.dumps(out[cfg]))
            del model
            torch.cuda.empty_cache()
    finally:
        layers.FUSED_C3_MIN_SPATIAL, layers.FUSED_DOWN_MIN_SPATIAL = gates
    report["zoo_configs"] = out
    return launches


def zoo_predict(dev, report, cfg, size, key, batches=2):
    """(j2) yolov5m6 at M6_SIZE², (j4) yolov5s-transformer at IMGSZ²:
    BATCH images a batch, bf16, phase (c)'s regime and density tuning,
    against the plain path (keep masks equal, detections per image within
    1%, the maps within :func:`_maps_bar`, rows 1-4 launched); the
    predict's img/s over ZOO_ITERS pipelined calls and peak memory."""
    import torch

    from yolov5_obb_tpu_torch.engine.evaluator import make_predict_fn

    t0 = time.perf_counter()
    model, meta, set_obj = density_model(dev, cfg)
    gen = torch.Generator(device=dev).manual_seed(17)
    xs = [zoo_batch(gen, model, BATCH, size, dev) for _ in range(batches)]
    predict = make_predict_fn(model, meta, CONF, IOU, MAX_DET,
                              multi_label=False, max_candidates=MAXC)
    delta = tune_density(predict, set_obj, xs[0])
    want = kernels_wanted(model, xs[0])
    require({"stem_l1", "c3", "down", "riou_boxes", "neighbor"} == want,
            f"{cfg}: {sorted(want)}")
    res = predict_vs_plain(model, meta, xs)
    _hold(cfg, res, want, 0.01 * sum(res["dets_plain"]))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    predict(xs[0])
    torch.cuda.synchronize()
    t = time.perf_counter()
    acc = torch.zeros((), device=dev)
    for i in range(ZOO_ITERS):
        d_, n_ = predict(xs[i % batches])
        acc = acc + d_.sum() + n_.sum()
    require(np.isfinite(float(acc)), "non-finite timing checksum")
    dt = (time.perf_counter() - t) / ZOO_ITERS
    with torch.inference_mode():
        forward_ms = cuda_time(lambda: model(xs[1 % batches]), 3)
    report[key] = {"cfg": cfg, "imgsz": size, "batch": BATCH,
                   "obj_delta": delta, "imgs_per_s": BATCH / dt,
                   "ms_per_img": dt * 1e3 / BATCH,
                   "forward_ms_per_batch": forward_ms,
                   "dets_per_img": float(np.mean(res["dets"])),
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "s": time.perf_counter() - t0, **res}
    log(f"({key}) " + json.dumps(report[key]))
    return res["launches"]


def zoo_train_step(dev, report):
    """(j3) a yolov5m6 train step at M6_SIZE², bf16, packed stem, stock
    path, seeded batches as phase (d) builds them: batch 16 if phase (d)'s
    peak scaled by (M6_SIZE / IMGSZ)² fits under TRAIN_MEM_CAP_GIB, else
    8; the step against the same step on the plain versions (phase (d)'s
    bars, :func:`compare_plain_step`); TRAIN_LAUNCHES a step (stem 1+1,
    downsample 2+2, layers 1 and 3 at 640² and 320²) over
    ZOO_TRAIN_ITERS steps after 2 warm-up; img/s, peak memory."""
    import torch

    from yolov5_obb_tpu_torch.engine.loss import ComputeLoss
    from yolov5_obb_tpu_torch.engine.optim import build_optimizer
    from yolov5_obb_tpu_torch.engine.trainer import (
        create_train_state,
        make_train_step,
    )
    from yolov5_obb_tpu_torch.models.yolo import create_model
    from yolov5_obb_tpu_torch.utils.general import load_hyp, scale_hyp_gains

    t0 = time.perf_counter()
    est = report["train_peak_mem_gib"] * (M6_SIZE / IMGSZ) ** 2
    batch = 16 if est < TRAIN_MEM_CAP_GIB else 8
    model, meta = create_model(M6_CFG, nc=15, dtype=torch.bfloat16,
                               device=dev, seed=0, packed_stem=True)
    hyp = load_hyp()
    loss_fn = ComputeLoss(meta, scale_hyp_gains(hyp, meta.nl, meta.nc,
                                                M6_SIZE))
    opt, _ = build_optimizer(model, hyp, epochs=10, steps_per_epoch=100,
                             batch_size=batch, nominal_batch=batch)
    state = create_train_state(opt)
    step = make_train_step(model, loss_fn, opt, device=dev)
    batches = train_batches(dev, hyp["csl_radius"], batch, M6_SIZE)
    cmp = compare_plain_step(model, loss_fn, opt, batches[0])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        float(step(state, *batches[i])["loss"])
    expected = with_bn_act(TRAIN_LAUNCHES, BN_BLOCKS["yolov5m6"])
    kernels = {n: k for n, k in _named_kernels().items() if n in expected}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(ZOO_TRAIN_ITERS):
        m = step(state, *batches[i % 2])
    loss = float(m["loss"])
    dt = time.perf_counter() - t
    launches = {n: k.launches for n, k in kernels.items()}
    require(all(launches[n] == ZOO_TRAIN_ITERS * per
                for n, per in expected.items()),
            f"(j3) train kernel launches {launches}, per step {expected}")
    items = m["items"].float().tolist()
    require(bool(np.isfinite([loss] + items).all()),
            f"(j3) non-finite loss {loss} / items {items}")
    report["zoo_train"] = {
        "cfg": M6_CFG, "imgsz": M6_SIZE, "batch": batch,
        "batch_rule": f"phase (d) peak {report['train_peak_mem_gib']:.2f} "
                      f"GiB x {(M6_SIZE / IMGSZ) ** 2:.4f} = {est:.2f} GiB "
                      f"{'<' if batch == 16 else '>='} {TRAIN_MEM_CAP_GIB}",
        "imgs_per_s": ZOO_TRAIN_ITERS * batch / dt,
        "step_ms": dt * 1e3 / ZOO_TRAIN_ITERS,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches_per_step": {n: v / ZOO_TRAIN_ITERS
                              for n, v in launches.items()},
        "loss": loss, "items": items, "vs_plain": cmp,
        "s": time.perf_counter() - t0}
    log("(j3) " + json.dumps(report["zoo_train"]))
    return launches


def zoo_path(dev, report):
    """Phase (j): (j1) every bundled config, (j2) yolov5m6 at 1280², (j3)
    its train step, (j4) yolov5s-transformer at 1024²; each kernel's
    launches summed."""
    import torch

    t = time.perf_counter()
    launches = {}
    for part in (lambda: zoo_configs_path(dev, report),
                 lambda: zoo_predict(dev, report, M6_CFG, M6_SIZE, "j2"),
                 lambda: zoo_train_step(dev, report),
                 lambda: zoo_predict(dev, report, TR_CFG, IMGSZ, "j4")):
        for n, v in part().items():
            launches[n] = launches.get(n, 0) + v
        torch.cuda.empty_cache()
    report["zoo_s"] = time.perf_counter() - t
    report["zoo_launches"] = launches
    return launches


# phase (k): the golden flow.  (k1) at the JAX nightly's setting
# (tests/test_golden_e2e.py:57-72) and its floors; (k2) the golden yolov5n
# on the set it was trained on, against the JAX package's numbers for it
# (its val, merge and eval on the CPU, float32; PERF.md, the golden flow)
GOLDEN_K1 = dict(n_images=4, raw_size=640, subsize=384, gap=128, imgsz=128,
                 epochs=250, batch=8, hyp_overrides={"lr0": 0.025})
GOLDEN_FLOORS = {"golden_obb_map": 0.12, "hbb_map50": 0.13, "maoe_deg": 55.0}
GOLDEN_WEIGHTS = Path(__file__).resolve().parent / "releases" / \
    "golden_yolov5n_192_torch"
GOLDEN_REF = {"golden_obb_map": 1.0, "hbb_map50": 0.9938, "maoe_deg": 2.1585}
GOLDEN_SIZE, GOLDEN_BATCH, STUDY_SIZES = 192, 4, (128, 160, 192)
# (k2) in bf16: the share of the stem+L1 outputs on the golden tiles that
# may differ from the plain version by one ulp (0.104% read on the H100,
# PERF.md), and the seeds of the control runs that move that share
STEM_ULP_BUDGET = 0.00125
CONTROL_SEEDS = (17, 18, 19, 20, 21, 22)
VAL_PLOTS = ("F1_curve.png", "PR_curve.png", "P_curve.png", "R_curve.png",
             "confusion_matrix.png")


def _launched(kernels) -> dict:
    return {n: k.launches for n, k in kernels.items() if k.launches}


def _wanted(dev, dtype, packed, size):
    """The kernels the val CLI's yolov5n (``dtype``, packed stem or not,
    Conv+BN folded) calls for at ``size``: ``kernels_wanted`` on a batch
    of that size."""
    import torch

    from yolov5_obb_tpu_torch.models.yolo import create_model
    from yolov5_obb_tpu_torch.utils.fuse import fuse_conv_bn

    model, _ = create_model("yolov5n.yaml", nc=15, dtype=dtype, device=dev,
                            packed_stem=packed)
    fuse_conv_bn(model)
    x = torch.zeros(GOLDEN_BATCH, size, size * 3, dtype=torch.uint8,
                    device=dev)
    return kernels_wanted(model, x if packed else x.view(
        GOLDEN_BATCH, size, size, 3))


def golden_k1(dev, kernels, tmp):
    """(k1): ``run_flow`` on the card at the JAX nightly's setting: raw
    PNGs → split → the train CLI from the tiles (float32, decoding,
    mosaic, flips, affine, HSV, autoanchor) → the val CLI (float32,
    ``--save-json``) → merge → OBB mAP, HBB mAP50, mAOE against the
    floors; the train CLI timed through its callbacks."""
    import torch

    from yolov5_obb_tpu_torch.tools import golden_e2e

    # the val CLI's kernels, and the train CLI's float32 BatchNorm + SiLU
    want = _wanted(dev, torch.float32, False, GOLDEN_K1["imgsz"]) | set(
        BN_ACT_KERNELS)
    epochs = []
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = golden_e2e.run_flow(tmp / "k1", callbacks=cli_callbacks(epochs),
                              **GOLDEN_K1)
    res["flow_s"] = time.perf_counter() - t
    res["launches"] = _launched(kernels)
    res["wanted"] = sorted(want)
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    steps = sum(e["batches"] for e in epochs)
    per_epoch = [e["batches"] * GOLDEN_K1["batch"] / e["total_s"]
                 for e in epochs]
    res["train"] = {
        "steps": steps, "epochs": len(epochs),
        "imgs_per_s": steps * GOLDEN_K1["batch"] / res["seconds"]["train"],
        "epoch_imgs_per_s_min_median_max": [
            min(per_epoch), float(np.median(per_epoch)), max(per_epoch)],
        "first_batch_wait_s_first_median": [
            epochs[0]["first_batch_wait_s"],
            float(np.median([e["first_batch_wait_s"] for e in epochs]))],
        "loader_wait_share_median": float(np.median(
            [e["loader_wait_share"] for e in epochs])),
        "last_save_ms_median": float(np.median(
            [e.get("last_save_ms", 0.0) for e in epochs]))}
    log("golden (k1): " + json.dumps(res))
    require(len(epochs) == GOLDEN_K1["epochs"] and steps > 0,
            f"golden (k1): {len(epochs)} epochs, {steps} steps")
    require(set(res["launches"]) == want,
            f"golden (k1): launched {res['launches']}, the gates allow "
            f"{sorted(want)}")
    f = GOLDEN_FLOORS
    require(res["golden_obb_map"] >= f["golden_obb_map"]
            and res["hbb_map50"] >= f["hbb_map50"]
            and 0.0 < res["maoe_deg"] <= f["maoe_deg"],
            f"golden (k1) below the JAX nightly's floors {f}: merged OBB "
            f"mAP {res['golden_obb_map']}, HBB mAP50 {res['hbb_map50']}, "
            f"mAOE {res['maoe_deg']}")
    return res


def _stem_l1_vs_plain(dev, split_dir):
    """The stem+L1 kernel against its plain version on every batch of the
    golden tiles, the val CLI's bf16 model (golden weights, Conv+BN
    folded): (elements that differ, elements, max |Δ|).  Launches made
    here are not the path's: the counts are set to 0 before each run."""
    import torch

    from yolov5_obb_tpu_torch.data.dota import DOTA_V1_NAMES, DotaDataset
    from yolov5_obb_tpu_torch.engine.evaluator import pack_images
    from yolov5_obb_tpu_torch.models.yolo import create_model
    from yolov5_obb_tpu_torch.utils.checkpoint import load_model_weights
    from yolov5_obb_tpu_torch.utils.fuse import fuse_conv_bn

    model, meta = create_model("yolov5n.yaml", nc=15, dtype=torch.bfloat16,
                               device=dev, packed_stem=True)
    load_model_weights(model, meta, GOLDEN_WEIGHTS)
    fuse_conv_bn(model)
    ds = DotaDataset(split_dir / "images", DOTA_V1_NAMES,
                     img_size=GOLDEN_SIZE)
    diff = total = 0
    err = 0.0
    with torch.inference_mode():
        for i in range(0, len(ds), GOLDEN_BATCH):
            b = np.stack([ds.get_eval_sample(j)["image"]
                          for j in range(i, min(i + GOLDEN_BATCH, len(ds)))])
            x = torch.from_numpy(pack_images(b)).to(dev)
            got, want = model._stem_l1(x, False), model._stem_l1(x, True)
            diff += int((got != want).sum())
            total += got.numel()
            err = max(err, float((got.float() - want.float()).abs().max()))
    return diff, total, err


def _confusion(val_res, split_dir):
    """The confusion matrix (``utils/metrics.ConfusionMatrix``, its
    defaults) of a val run's detections against the tiles' labels, each as
    its horizontal box at the tile's own resolution."""
    from yolov5_obb_tpu_torch.data.dota import DOTA_V1_NAMES, DotaDataset
    from yolov5_obb_tpu_torch.ops.geometry import poly2hbb, xywh2xyxy
    from yolov5_obb_tpu_torch.utils.metrics import ConfusionMatrix

    ds = DotaDataset(split_dir / "images", DOTA_V1_NAMES,
                     img_size=GOLDEN_SIZE)
    index = {Path(f).name: i for i, f in enumerate(ds.img_files)}
    cm = ConfusionMatrix(nc=len(DOTA_V1_NAMES))
    for d in val_res["detections"]:
        i = index[Path(d["path"]).name]
        gt = (xywh2xyxy(poly2hbb(ds.polys[i])) if len(ds.polys[i])
              else np.zeros((0, 4)))
        det = (xywh2xyxy(poly2hbb(d["polys"])) if len(d["polys"])
               else np.zeros((0, 4)))
        cm.process_batch(det, d["conf"], d["cls"], gt, ds.cls[i])
    return cm.matrix


def _one_ulp_stem(frac: float, dev, seed: int):
    """A plain stem+L1 whose output moves one bf16 ulp (up or down, from
    ``seed``) on a ``frac`` share of its elements: a control run's
    noise."""
    import torch

    from yolov5_obb_tpu_torch.ops.kernels.stem_kernel import (
        fused_stem_l1_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(seed)

    def stem(*a, **k):
        y = fused_stem_l1_plain(*a, **k)
        if y.device.type == "meta":  # the model's stride probe
            return y
        move = torch.rand(y.shape, generator=gen, device=dev) < frac
        step = torch.where(torch.rand(y.shape, generator=gen, device=dev)
                           < 0.5, 1, -1).to(torch.int16)
        return torch.where(move, (y.view(torch.int16) + step).view(y.dtype),
                           y)
    return stem


def _golden_pair(dev, tag, k, p, controls=()) -> dict:
    """Kernel run ``k`` against plain run ``p`` of the val CLI on the
    golden tiles: phase (f)'s bars on the tiles' detections (mAP within
    0.01, per-tile counts within 1%, at most 1% of the detections without
    a counterpart), phase (h)'s on the merged rows (counts within 1%, at
    most 1% without a counterpart at polygon IoU > 0.99), the confusion
    matrices (``_confusion``) equal.  With ``controls`` (plain runs whose
    stem+L1 output moved one ulp on STEM_ULP_BUDGET of its elements, each
    from its own seed) each unmatched share may reach the largest
    control's own against ``p`` where that is above 1%, and the confusion
    matrices may differ by as many detections as the most any control's
    differs from ``p``'s: bf16 noise alone moves a trained model's
    low-confidence rows and the merge's picks (PERF.md, the golden
    flow)."""
    from yolov5_obb_tpu_torch.data.dota import DOTA_V1_NAMES

    def diff(a, b):
        av, bv = a["val"], b["val"]
        un, total, same = _evaluate_diff(av, bv, dev)
        kc, pc = (sum(len(_rows(f)) for f in x["merged"].iterdir())
                  for x in (a, b))
        cm_a, cm_b = a["confusion"], b["confusion"]
        mu = [_merged_unmatched(a["merged"], b["merged"], DOTA_V1_NAMES),
              _merged_unmatched(b["merged"], a["merged"], DOTA_V1_NAMES)]
        return {
            "map50": [av["map50"], bv["map50"]], "map": [av["map"], bv["map"]],
            "count_diff_tiles": _count_diff(
                [len(d["conf"]) for d in av["detections"]],
                [len(d["conf"]) for d in bv["detections"]]),
            "tile_unmatched": un, "tile_rows": total, "tiles_same": same,
            "merged_rows": [kc, pc],
            "merged_unmatched": mu[0][0] + mu[1][0],
            "merged_total": mu[0][1] + mu[1][1],
            # a detection that changes cell moves two counts
            "confusion_moved": float(np.abs(cm_a - cm_b).sum() / 2),
            "confusion_total": float(cm_b.sum())}

    r = diff(k, p)
    share = {"tile": 0.01, "merged": 0.01, "confusion": 0.0}
    if controls:
        r["controls"] = cs = [diff(c, p) for c in controls]
        share = {
            "tile": max(0.01, *(c["tile_unmatched"] / c["tile_rows"]
                                for c in cs)),
            "merged": max(0.01, *(c["merged_unmatched"]
                                  / max(c["merged_total"], 1) for c in cs)),
            "confusion": max(c["confusion_moved"] / c["confusion_total"]
                             for c in cs)}
    r["unmatched_share_bars"] = share
    log(f"golden (k2) {tag} kernel against plain: {json.dumps(r)}")
    require(abs(r["map50"][0] - r["map50"][1]) <= 0.01
            and abs(r["map"][0] - r["map"][1]) <= 0.01
            and r["count_diff_tiles"] == 0
            and r["tile_unmatched"] <= share["tile"] * r["tile_rows"],
            f"golden (k2) {tag} tile detections against plain: {r}")
    kc, pc = r["merged_rows"]
    require(abs(kc - pc) <= 0.01 * pc
            and r["merged_unmatched"] <= share["merged"] * r["merged_total"],
            f"golden (k2) {tag} merged rows against plain: {r}")
    require(r["confusion_moved"] <= share["confusion"] * r["confusion_total"],
            f"golden (k2) {tag}: the confusion matrices differ: {r}")
    return r


def golden_k2(dev, kernels, tmp, plots: bool):
    """(k2): the golden yolov5n (``releases/golden_yolov5n_192_torch``)
    on its own training set (10 raw images → 90 tiles), the val CLI at
    192 with ``--save-json``, each run merged and scored: in float32 (row
    4) and in bfloat16 (the packed stem: rows 1 and 4), each on the
    kernels against the JAX package's numbers and against the same CLI on
    the kernels' plain versions (``_golden_pair``; in bfloat16 the
    stem+L1 kernel's differing outputs within STEM_ULP_BUDGET, and six
    one-ulp controls of the stem+L1 output at that budget), the five
    plots; then ``--task study`` at 128, 160, 192 in bfloat16 on the
    kernels."""
    import functools

    import torch

    from yolov5_obb_tpu_torch import val as val_cli
    from yolov5_obb_tpu_torch.devkit.img_split import split_dataset
    from yolov5_obb_tpu_torch.models import yolo
    from yolov5_obb_tpu_torch.tools import golden_e2e

    r = {}
    out = tmp / "k2"
    t = time.perf_counter()
    raw = golden_e2e.generate_raw(out / "raw", n_images=10, size=768,
                                  grid=4, seed=3)
    r["tiles"] = split_dataset(raw, out / "split", rate=1.0, subsize=384,
                               gap=128, num_workers=1)
    data_yaml, _ = golden_e2e.write_configs(out, out / "split")
    r["set_s"] = time.perf_counter() - t
    require(r["tiles"] == 90, f"golden (k2): {r['tiles']} tiles, not 90")
    want = {"float32": _wanted(dev, torch.float32, False, GOLDEN_SIZE),
            "bfloat16": _wanted(dev, torch.bfloat16, True, GOLDEN_SIZE)}
    d, n, err = _stem_l1_vs_plain(dev, out / "split")
    r["stem_l1_vs_plain"] = {"differ": d, "elements": n, "max_abs_err": err}
    require(err <= 0.05 and d <= STEM_ULP_BUDGET * n,
            f"golden (k2): stem+L1 kernel against plain "
            f"{r['stem_l1_vs_plain']} (at most {STEM_ULP_BUDGET} of the "
            f"outputs may differ)")
    runs = {}
    controls = tuple(("bfloat16", f"bf16_control{seed}", True,
                      _one_ulp_stem(STEM_ULP_BUDGET, dev, seed))
                     for seed in CONTROL_SEEDS)
    for dtype, tag, plain, stem in (
            ("float32", "f32_kernel", False, None),
            ("float32", "f32_plain", True, None),
            ("bfloat16", "bf16_kernel", False, None),
            ("bfloat16", "bf16_plain", True, None), *controls):
        for k in kernels.values():
            k.launches = 0
        evaluate, stem_plain = val_cli.evaluate, yolo.fused_stem_l1_plain
        if plain:  # the same CLI on the kernels' plain versions
            val_cli.evaluate = functools.partial(evaluate, plain=True)
        if stem is not None:
            yolo.fused_stem_l1_plain = stem
        try:
            t = time.perf_counter()
            runs[tag] = x = golden_e2e.val_merge_eval(
                out, data_yaml, raw, GOLDEN_WEIGHTS, imgsz=GOLDEN_SIZE,
                batch=GOLDEN_BATCH, dtype=dtype, name=tag)
            x["flow_s"] = time.perf_counter() - t
            x["confusion"] = _confusion(x["val"], out / "split")
        finally:
            val_cli.evaluate, yolo.fused_stem_l1_plain = evaluate, stem_plain
        x["launches"] = _launched(kernels)
        r[tag] = {n: x[n] for n in ("golden_obb_map", "hbb_map50",
                                    "maoe_deg", "seconds", "flow_s",
                                    "launches")}
        r[tag]["val_ms_per_tile"] = x["val"]["speed_ms_per_img"]
        r[tag]["hbb_map"] = x["val"]["map"]
        r[tag]["worst_class_maoe_deg"] = max(x["maoe_classes"].values())
        log(f"golden (k2) {tag}: " + json.dumps(r[tag]))
        ok = x["launches"] == {} if plain else set(x["launches"]) == want[
            dtype]
        require(ok, f"golden (k2) {tag} launched {x['launches']}; the "
                f"gates allow {sorted(want[dtype])}")
        if not plain:
            require(abs(x["golden_obb_map"] - GOLDEN_REF["golden_obb_map"])
                    <= 0.01
                    and abs(x["hbb_map50"] - GOLDEN_REF["hbb_map50"]) <= 0.01
                    and abs(x["maoe_deg"] - GOLDEN_REF["maoe_deg"]) <= 0.5,
                    f"golden (k2) {tag} against the JAX package's "
                    f"{GOLDEN_REF}: {r[tag]}")
            pngs = sorted(q.name for q in (out / "val" / tag).glob("*.png"))
            require(not plots or pngs == list(VAL_PLOTS),
                    f"golden (k2) {tag}: the val plots are {pngs}")
    r["wanted"] = {k: sorted(v) for k, v in want.items()}
    r["f32_pair"] = _golden_pair(dev, "float32", runs["f32_kernel"],
                                 runs["f32_plain"])
    r["bf16_pair"] = _golden_pair(
        dev, "bfloat16", runs["bf16_kernel"], runs["bf16_plain"],
        [runs[f"bf16_control{seed}"] for seed in CONTROL_SEEDS])
    r["confusion_trace"] = float(np.trace(
        runs["bf16_kernel"]["confusion"][:-1, :-1]))

    # --task study on the kernels: a row per size, 192's as the val run's
    for k in kernels.values():
        k.launches = 0
    t = time.perf_counter()
    rows = val_cli.run(val_cli.parse_opt([
        "--weights", str(GOLDEN_WEIGHTS), "--data", str(data_yaml),
        "--task", "study", "--study-sizes", *map(str, STUDY_SIZES),
        "--batch-size", str(GOLDEN_BATCH), "--conf-thres", "0.01",
        "--iou-thres", "0.4", "--max-det", "200", "--dtype", "bfloat16",
        "--no-plots", "--project", str(out / "study"), "--name", "run"]))
    r["study_s"] = time.perf_counter() - t
    r["study_launches"] = _launched(kernels)
    text = (out / "study" / "run" / "study_data_yolov5n.txt").read_text()
    r["study_rows"] = rows
    map50 = runs["bf16_kernel"]["val"]["map50"]
    require([row[0] for row in rows] == list(STUDY_SIZES)
            and len(text.splitlines()) == len(STUDY_SIZES)
            and rows[-1][3] == map50,
            f"golden (k2) study rows {rows} (the val run's mAP50 {map50})")
    r["launches"] = {}
    for x in [runs[t]["launches"] for t in ("f32_kernel", "bf16_kernel")] + [
            r["study_launches"]]:
        for n, v in x.items():
            r["launches"][n] = r["launches"].get(n, 0) + v
    return r


def golden_path(dev, report):
    """Phase (k): the golden flow on the card, (k1) and (k2); OpenCV must
    import (the flow decodes, augments and draws with it); each kernel's
    launches over the phase summed."""
    import cv2
    import torch

    print(f"golden flow: OpenCV {cv2.__version__}", flush=True)
    try:
        import matplotlib

        plots = True
        print(f"golden flow: matplotlib {matplotlib.__version__}", flush=True)
    except ImportError:
        plots = False
        print("golden flow: matplotlib is absent: the plots are reported "
              "failed and the runs go on", flush=True)
    kernels = _named_kernels()
    t = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_golden_"))
    r = {"cv2": cv2.__version__, "plots": plots}
    try:
        r["k1"] = golden_k1(dev, kernels, tmp)
        torch.cuda.empty_cache()
        r["k2"] = golden_k2(dev, kernels, tmp, plots)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r["phase_s"] = time.perf_counter() - t
    k1, k2 = r["k1"], r["k2"]
    tr = k1["train"]
    launches = {}
    for x in (k1["launches"], k2["launches"]):
        for n, v in x.items():
            launches[n] = launches.get(n, 0) + v
    r["launches"] = launches
    log(f"golden (k1): {k1['tiles']} tiles; merged OBB mAP "
        f"{k1['golden_obb_map']}, HBB mAP50 {k1['hbb_map50']}, mAOE "
        f"{k1['maoe_deg']}° (floors {GOLDEN_FLOORS}); train {tr['steps']} "
        f"steps, {tr['imgs_per_s']:.2f} img/s over the run, per epoch "
        f"min/median/max {[round(v, 2) for v in tr['epoch_imgs_per_s_min_median_max']]}"
        f", first-batch wait s (first epoch, median) "
        f"{[round(v, 4) for v in tr['first_batch_wait_s_first_median']]}; "
        f"val {k1['val_ms_per_tile']:.2f} ms/tile; seconds {k1['seconds']}; "
        f"launches {k1['launches']}")
    for tag in ("f32_kernel", "f32_plain", "bf16_kernel", "bf16_plain",
                *(f"bf16_control{seed}" for seed in CONTROL_SEEDS)):
        x = k2[tag]
        log(f"golden (k2) {tag}: merged OBB mAP {x['golden_obb_map']}, HBB "
            f"mAP50 {x['hbb_map50']}, mAOE {x['maoe_deg']}°; val "
            f"{x['val_ms_per_tile']:.2f} ms/tile; launches {x['launches']}")
    log(f"golden (k2): {k2['tiles']} tiles (JAX {GOLDEN_REF}); stem+L1 "
        f"against plain {k2['stem_l1_vs_plain']}; study rows "
        f"{[[round(v, 4) for v in row] for row in k2['study_rows']]} in "
        f"{k2['study_s']:.1f} s; launches {k2['launches']}")
    log(f"golden flow: phase {r['phase_s']:.1f} s, launches {launches} on "
        f"{card_line()}")
    report["golden"] = r
    return launches


# ---------------------------------------------------------------------------
# (l) scale-out and training support: remat, data parallelism, --evolve
# ---------------------------------------------------------------------------

# (l1): three steps a run, in each remat mode; "repeat" is the no-remat run
# again, whose difference from the first is the bar where it is not 0
REMAT_STEPS = 3
REMAT_RUNS = ("none", "repeat", "full", "selective")
# the train kernels of a forward: full remat runs the forward twice a step
FORWARD_KERNELS = ("stem_train_fwd", "down_train_fwd", "pass_1x1_fwd",
                   "pass_3x3s1", "pass_3x3s2", "bn_act_stats",
                   "bn_act_fwd_finalize", "bn_act_fwd")
# (l2 ii b) the float32 case: yolov5n, stock stem, 256², batch 4
DP_F32 = {"cfg": "yolov5n.yaml", "imgsz": 256, "batch": 4}
# (l2 iii), (l3): the seeded set of the CLI runs; an image count that leaves
# a remainder, of which every rank takes the one-process images // batch
# steps
DP_CLI = {"images": 15, "imgsz": 512, "batch": 8}
EVOLVE = {"imgsz": 256, "batch": 4, "gens": 2, "seed": 5}
DP_TIMEOUT_S = 420


def remat_launches(expected, mode) -> dict:
    """The train kernels' launches a step under ``mode``."""
    return {n: v * (2 if mode == "full" and n in FORWARD_KERNELS else 1)
            for n, v in expected.items()}


def seeded_steps(model, meta, sd0, batches, steps, dev, remat=False,
                 mesh=None, batch=None, imgsz=None, counted=()):
    """``steps`` train steps of ``model`` from the state dict ``sd0`` over
    ``batches`` in turn (a mesh takes its rows), with a fresh optimizer (SGD,
    one update a step) and train state: the loss and items of each step,
    the final state dict, img/s over the steps after the first, peak
    memory, and the launches of the ``counted`` kernels (set to 0 just
    before).  ``batch`` and ``imgsz`` (the global batch, for the optimizer
    and the loss gains) default to phase (d)'s."""
    import torch

    from yolov5_obb_tpu_torch.engine.loss import ComputeLoss
    from yolov5_obb_tpu_torch.engine.optim import build_optimizer
    from yolov5_obb_tpu_torch.engine.trainer import (
        create_train_state,
        make_train_step,
        put_batch,
    )
    from yolov5_obb_tpu_torch.utils.general import load_hyp, scale_hyp_gains

    batch, imgsz = batch or BATCH, imgsz or IMGSZ
    with torch.no_grad():
        model.load_state_dict(sd0)
    hyp = load_hyp()
    loss_fn = ComputeLoss(meta, scale_hyp_gains(hyp, meta.nl, meta.nc, imgsz))
    opt, _ = build_optimizer(model, hyp, epochs=10, steps_per_epoch=100,
                             batch_size=batch, nominal_batch=batch)
    state = create_train_state(opt)
    step = make_train_step(model, loss_fn, opt, mesh=mesh, remat=remat,
                           device=dev)
    kernels = {n: k for n, k in _named_kernels().items() if n in counted}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    out, t = [], None
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            t = time.perf_counter()
        out.append(step(state, *put_batch(batches[i % len(batches)], mesh)))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    rows = batch if mesh is None else batch // mesh.world
    return {"loss": [float(m["loss"]) for m in out],
            "items": [m["items"].float().tolist() for m in out],
            "sd": {k: v.detach().clone()
                   for k, v in model.state_dict().items()},
            "imgs_per_s": (steps - 1) * rows / dt,
            "step_ms": dt * 1e3 / (steps - 1),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": {n: k.launches for n, k in kernels.items()}}


def run_diff(a, b) -> dict:
    """Largest absolute differences of two runs: the loss items of every
    step, the parameters, the BN running statistics."""
    items = float(np.abs(np.asarray(a["items"])
                         - np.asarray(b["items"])).max())
    params = stats = 0.0
    for k, t in b["sd"].items():
        if "num_batches" in k:
            continue
        d = float((a["sd"][k].double() - t.double()).abs().max())
        if "running" in k:
            stats = max(stats, d)
        else:
            params = max(params, d)
    return {"items": items, "params": params, "stats": stats}


def within_repeat(diff, bar) -> bool:
    """Bit for bit where the repeat is; else within the repeat's own
    difference."""
    return all(diff[k] <= bar[k] for k in bar)


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms for the block: phase (l)'s
    comparisons want a repeat of a step to be the step bit for bit, and
    the default algorithms of the stock step's high-resolution convs are
    not (their repeat moved parameters by 0.12 after three steps)."""
    import torch

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def remat_path(dev, report, fused):
    """(l1) at phase (d)'s shape (yolov5m b16 1024², bf16, packed stem, the
    seed-0 weights and batches), ``fused`` with the fused train region:
    three steps without remat, again (the repeat), with full and with
    selective remat, cuDNN deterministic; each against the first run, peak
    memory, img/s and the train kernels' launches.  Returns the launches
    and the first run (the reference of (l2))."""
    import torch

    from yolov5_obb_tpu_torch.models.yolo import create_model
    from yolov5_obb_tpu_torch.utils.general import load_hyp

    expected = with_bn_act(FUSED_LAUNCHES if fused else TRAIN_LAUNCHES,
                           BN_BLOCKS["yolov5m_fused" if fused else "yolov5m"])
    model, meta = create_model("yolov5m.yaml", nc=15, dtype=torch.bfloat16,
                               device=dev, seed=0, packed_stem=True,
                               fused_train=fused)
    sd0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batches = train_batches(dev, load_hyp()["csl_radius"])
    runs, launches = {}, {}
    for name in REMAT_RUNS:
        mode = {"none": False, "repeat": False}.get(name, name)
        with cudnn_deterministic():
            r = seeded_steps(model, meta, sd0, batches, REMAT_STEPS, dev,
                             remat=mode, counted=expected)
        want = {n: REMAT_STEPS * v
                for n, v in remat_launches(expected, mode).items()}
        require(r["launches"] == want,
                f"remat {name}{' fused' if fused else ''}: launches "
                f"{r['launches']}, expected {want}")
        require(bool(np.isfinite(r["items"]).all()),
                f"remat {name}: non-finite items {r['items']}")
        for n, v in r["launches"].items():
            launches[n] = launches.get(n, 0) + v
        runs[name] = r
    bar = run_diff(runs["repeat"], runs["none"])
    res = {"repeat_diff": bar}
    for name in REMAT_RUNS:
        r = runs[name]
        res[name] = {"peak_mem_gib": r["peak_mem_gib"],
                     "imgs_per_s": r["imgs_per_s"], "step_ms": r["step_ms"],
                     "items": r["items"], "launches": r["launches"]}
        if name in ("full", "selective"):
            d = run_diff(r, runs["none"])
            res[name]["diff"] = d
            require(within_repeat(d, bar),
                    f"remat {name}{' fused' if fused else ''} differs from "
                    f"the step without remat by {d}, the repeat by {bar}")
    tag = "fused_" if fused else ""
    log(f"(l1) {tag}remat: " + json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk != "items"}
         if isinstance(v, dict) and "items" in v else v
         for k, v in res.items()}))
    report[f"{tag}remat"] = res
    ref = runs["none"]
    del runs, model
    torch.cuda.empty_cache()
    return launches, ref, sd0, batches, bar


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world_of_one(dev, ref, sd0, batches, bar, fused):
    """(l2 i) the data-parallel step in a world of one through NCCL, three
    steps from (l1)'s weights and batches, cuDNN deterministic, ``fused``
    with the fused train region (whose statistics go through the mesh's
    all-reduce): bit for bit (l1)'s step without remat where its repeat
    is, else within the repeat's difference; the train kernels' launches
    a step as without a mesh."""
    import torch
    import torch.distributed as dist

    from yolov5_obb_tpu_torch.engine.distributed import make_mesh
    from yolov5_obb_tpu_torch.models.yolo import create_model

    expected = with_bn_act(FUSED_LAUNCHES if fused else TRAIN_LAUNCHES,
                           BN_BLOCKS["yolov5m_fused" if fused else "yolov5m"],
                           mesh=True)
    model, meta = create_model("yolov5m.yaml", nc=15, dtype=torch.bfloat16,
                               device=dev, seed=0, packed_stem=True,
                               fused_train=fused)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        require(dist.get_backend() == backend, "the world of one's backend")
        with cudnn_deterministic():
            r = seeded_steps(model, meta, sd0, batches, REMAT_STEPS, dev,
                             mesh=make_mesh(), counted=expected)
    finally:
        dist.destroy_process_group()
    d = run_diff(r, ref)
    tag = "fused " if fused else ""
    res = {"diff": d, "repeat_diff": bar, "imgs_per_s": r["imgs_per_s"],
           "launches": r["launches"]}
    log(f"(l2 i) {tag}NCCL world of one: " + json.dumps(res))
    require(within_repeat(d, bar), f"a {tag}world of one differs from the "
            f"step by {d}, the repeat by {bar}")
    want = {n: REMAT_STEPS * v for n, v in expected.items()}
    require(r["launches"] == want, f"(l2 i) {tag}launches {r['launches']}, "
            f"expected {want}")
    del model
    torch.cuda.empty_cache()
    return res


def _to_cpu(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _moves_vs(a, b, sd0) -> dict:
    """Parameter moves from ``sd0`` of run ``a`` against run ``b``: the
    largest difference over the largest move of ``b`` (phase (d)'s dW bar
    form), and the cosine of the two runs' moves."""
    import torch

    names = [k for k in sd0 if "running" not in k and "num_batches" not in k]
    ma = torch.cat([(a["sd"][k].double() - sd0[k].double().to(
        a["sd"][k].device)).flatten() for k in names])
    mb = torch.cat([(b["sd"][k].double() - sd0[k].double().to(
        b["sd"][k].device)).flatten() for k in names])
    return {"max_diff_over_max_move": float((ma - mb).abs().max()
                                            / mb.abs().max()),
            "cos": _cos(ma, mb)}


def launch_workers(tmp, jobs, dev, world=2):
    """``world`` processes of ``chip_smoke.py --dp-worker`` on ``dev``, the
    one card (gloo: NCCL takes one rank a device), each running ``jobs``;
    waits with a limit, stops any left, and returns each rank's results."""
    spec = tmp / "jobs.json"
    spec.write_text(json.dumps({"port": _free_port(), "world": world,
                                "device": dev.type, "jobs": jobs}))
    procs, logs = [], []
    for rank in range(world):
        env = {**__import__("os").environ, "LOCAL_RANK": "0",
               "RANK": str(rank), "WORLD_SIZE": str(world)}
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dp-worker",
             str(spec), str(rank)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, logs)):
        log(f"--- dp worker {rank} (exit {p.returncode}), last lines:\n"
            + "\n".join(text.splitlines()[-12:]))
        require(p.returncode == 0, f"dp worker {rank} failed")
    import torch

    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def dp_worker(spec_path, rank) -> int:
    """One rank of (l2 ii)/(iii) or (m4): joins the gloo group (both ranks on
    ``cuda:0``, or the CPU where the spec says so) and runs the jobs of
    ``spec_path``; writes its results to ``rank{r}.pt`` beside it."""
    import torch
    import torch.distributed as dist

    from yolov5_obb_tpu_torch.engine.distributed import make_mesh
    from yolov5_obb_tpu_torch.models.yolo import create_model

    spec = json.loads(Path(spec_path).read_text())
    tmp = Path(spec_path).parent
    dev = torch.device(spec["device"])
    if dev.type == "cuda":  # as main() sets them
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{spec['port']}", world_size=spec["world"],
                            rank=rank)
    out = {}
    try:
        for job in spec["jobs"]:
            if job["kind"] == "step":
                data = torch.load(job["input"], weights_only=False)
                dtype = getattr(torch, job["dtype"])
                fused = job.get("fused", False)
                model, meta = create_model(
                    job["cfg"], nc=15, dtype=dtype, device=dev, seed=0,
                    packed_stem=job["packed"], fused_train=fused)
                batches = [tuple(t.to(dev) for t in b)
                           for b in data["batches"]]
                r = seeded_steps(model, meta, data["sd"], batches,
                                 REMAT_STEPS, dev, mesh=make_mesh(),
                                 remat=job.get("remat", False),
                                 batch=job["batch"], imgsz=job["imgsz"],
                                 counted=FUSED_LAUNCHES if fused
                                 else TRAIN_LAUNCHES)
                out[job["name"]] = _to_cpu(r)
                del model, batches
                torch.cuda.empty_cache()
            elif job["kind"] == "val_mesh":
                out[job["name"]] = mesh_val_rank(job, dev)
            else:
                out[job["name"]] = dp_cli_rank(job["argv"])
    finally:
        dist.destroy_process_group()
    torch.save(out, tmp / f"rank{rank}.pt")
    return 0


def dp_cli_rank(argv) -> dict:
    """The train CLI in this rank (the group is joined: ``train.run``'s
    ``maybe_initialize`` keeps it): its final state dict, the checkpoint
    writes it made, its train kernels' launches and the run's seconds."""
    import torch

    from yolov5_obb_tpu_torch import train

    made, writes = [], []
    real_step = train.make_train_step

    def capture(model, *a, **k):
        made.append(model)
        return real_step(model, *a, **k)

    def recorded(name):
        fn = getattr(train, name)

        def wrapper(*a, **k):
            writes.append(name)
            return fn(*a, **k)
        return wrapper

    train.make_train_step = capture
    for name in ("save_checkpoint", "save_weights"):
        setattr(train, name, recorded(name))
    kernels = {n: k for n, k in _named_kernels().items()
               if n in TRAIN_LAUNCHES}
    for k in kernels.values():
        k.launches = 0
    t = time.perf_counter()
    save_dir, fit, _ = train.run(train.parse_opt(argv))
    torch.cuda.synchronize()
    return {"sd": _to_cpu(made[-1].state_dict()), "writes": writes,
            "save_dir": str(save_dir), "fitness": fit,
            "run_s": time.perf_counter() - t,
            "launches": {n: k.launches for n, k in kernels.items()}}


def dp_path(dev, report, refs, tmp, card):
    """(l2 ii) two processes on the one card through gloo, 8 rows a rank of
    (l1)'s b16 batches, three steps, against (l1)'s one-process step, the
    stock step and the fused train region (``refs``: each one's first
    (l1) run, weights and batches), the ranks' parameters and BatchNorm
    statistics bit for bit (a rank that kept its own statistics would
    store other running statistics than the other rank).  The first step
    (both from the same state) within phase (d)'s 1e-2 on the loss items.
    After updates a bf16 step's parameters carry rounding noise that the
    summed statistics move (PERF.md, Findings: whole-step bf16 gradients are
    held by direction): the control, the one-process step with the stem
    weights scaled by 1 + 2^-8 (one bf16 ulp, phase (d)'s), measures it.
    The three steps' items within 1e-2, or the control's difference where
    it is larger; the parameter moves no less aligned with the one-process
    moves than the control's; their largest elementwise difference is
    reported (the control's exceeds the largest move).  The fused region
    runs in bf16 only on the card (its stem kernel computes bf16), so the
    float32 case is the stock step's.  The same in float32 at
    yolov5n 256² b4 with the stock stem: loss and items within 2e-4, the
    parameter moves within 2e-2 of the largest (phase (d)'s dW bar); and
    so under full remat (the statistics' all-reduces run again in the
    backward's recompute).  (l2 iii)
    the train CLI in the same two processes for one epoch on a seeded
    shard set (yolov5n 512², b8): only rank 0 writes, both ranks end
    equal.  The times are of two processes sharing one card: they measure
    no scale-out."""
    import torch

    from yolov5_obb_tpu_torch.data.shards import write_shards
    from yolov5_obb_tpu_torch.models.yolo import create_model
    from yolov5_obb_tpu_torch.utils.general import load_hyp

    # the bf16 controls: (l1)'s one-process steps, the stem one ulp off
    stem, ctls = "model.0.conv.weight", {}
    for name, (_, sd0, batches) in refs.items():
        model, meta = create_model(
            "yolov5m.yaml", nc=15, dtype=torch.bfloat16, device=dev, seed=0,
            packed_stem=True, fused_train=name == "bf16_fused")
        ctls[name] = seeded_steps(
            model, meta, {**sd0, stem: sd0[stem] * (1 + 2.0**-8)}, batches,
            REMAT_STEPS, dev)
        del model
        torch.save({"sd": _to_cpu(sd0), "batches": _to_cpu(batches)},
                   tmp / f"{name}.pt")
    # the float32 case's weights, batches and one-process reference
    f = DP_F32
    m32, meta32 = create_model(f["cfg"], nc=15, dtype=torch.float32,
                               device=dev, seed=0, packed_stem=False)
    sd32 = {k: v.detach().clone() for k, v in m32.state_dict().items()}
    # NHWC images; the boxes of phase (d)'s batches scaled to 256²
    b32 = []
    for img, tg, mk in train_batches(dev, load_hyp()["csl_radius"],
                                     batch=f["batch"], imgsz=f["imgsz"]):
        tg = tg.clone()
        tg[..., 1:5] *= f["imgsz"] / IMGSZ
        b32.append((img.reshape(img.shape[0], img.shape[1], -1, 3), tg, mk))
    ref32 = seeded_steps(m32, meta32, sd32, b32, REMAT_STEPS, dev,
                         batch=f["batch"], imgsz=f["imgsz"])
    del m32
    torch.save({"sd": _to_cpu(sd32), "batches": _to_cpu(b32)},
               tmp / "f32.pt")

    # (iii)'s set: written from memory, its shards packed, linked into the
    # run's cache as phase (g) does
    names = [f"c{i}" for i in range(15)]
    c = DP_CLI
    data, images = write_seeded_dota(tmp / "dota", c["images"], c["imgsz"],
                                     13, names)
    shards = write_shards(seeded_train_set(data, images, MAX_LABELS,
                                           load_hyp()),
                          tmp / "shards", aug_epochs=1, seed=0,
                          verbose=False)
    del images
    proj = tmp / "runs"
    (proj / "dp" / "cache").mkdir(parents=True)
    (proj / "dp" / "cache" / "shards").symlink_to(shards)
    argv = ["--cfg", "yolov5n.yaml", "--data", str(data), "--imgsz",
            str(c["imgsz"]), "--batch-size", str(c["batch"]),
            "--nominal-batch", str(c["batch"]), "--max-labels",
            str(MAX_LABELS), "--cache", "shards", "--workers", "0",
            "--epochs", "1", "--noautoanchor", "--val-images", "8",
            "--device", dev.type, "--exist-ok", "--project", str(proj),
            "--name", "dp"]
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = launch_workers(tmp, [
        {"kind": "step", "name": "bf16", "input": str(tmp / "bf16.pt"),
         "cfg": "yolov5m.yaml", "dtype": "bfloat16", "packed": True,
         "batch": BATCH, "imgsz": IMGSZ},
        {"kind": "step", "name": "bf16_fused",
         "input": str(tmp / "bf16_fused.pt"), "cfg": "yolov5m.yaml",
         "dtype": "bfloat16", "packed": True, "fused": True,
         "batch": BATCH, "imgsz": IMGSZ},
        {"kind": "step", "name": "f32", "input": str(tmp / "f32.pt"),
         "cfg": f["cfg"], "dtype": "float32", "packed": False,
         "batch": f["batch"], "imgsz": f["imgsz"]},
        {"kind": "step", "name": "f32_full_remat",
         "input": str(tmp / "f32.pt"), "cfg": f["cfg"], "dtype": "float32",
         "packed": False, "batch": f["batch"], "imgsz": f["imgsz"],
         "remat": "full"},
        {"kind": "cli", "name": "cli", "argv": argv}], dev)
    wall = time.perf_counter() - t
    launches = {}
    res = {"card": f"{card}, one card shared by both ranks (no scale-out)",
           "workers_wall_s": wall}
    for name, one, bar in (("bf16", refs["bf16"][0], 1e-2),
                           ("bf16_fused", refs["bf16_fused"][0], 1e-2),
                           ("f32", ref32, 2e-4),
                           ("f32_full_remat", ref32, 2e-4)):
        a, b = (r[name] for r in ranks)
        bf16 = name in refs
        sd_ref = refs[name][1] if bf16 else sd32
        items = np.asarray(one["items"])
        err = float((np.abs(np.asarray(a["items"]) - items)
                     / np.abs(items)).max())
        loss_err = float(np.abs(np.asarray(a["loss"]) - np.asarray(
            one["loss"])).max() / np.abs(one["loss"]).max())
        moves = _moves_vs(a, _to_cpu(one), _to_cpu(sd_ref))
        if bf16:
            ctl = ctls[name]
            c_items = np.asarray(ctl["items"])
            c_err = float((np.abs(c_items - items) / np.abs(items)).max())
            c_moves = _moves_vs(_to_cpu(ctl), _to_cpu(one), _to_cpu(sd_ref))
        same = all(torch.equal(a["sd"][k], b["sd"][k]) for k in a["sd"])
        per_step = {n: v // REMAT_STEPS for n, v in a["launches"].items()}
        err0 = float((np.abs(np.asarray(a["items"][0]) - items[0])
                      / np.abs(items[0])).max())
        res[name] = {"first_step_items_max_rel_err": err0,
                     "items_max_rel_err": err, "loss_max_rel_err": loss_err,
                     "moves": moves, "ranks_equal": same,
                     "step_ms_rank": [r[name]["step_ms"] for r in ranks],
                     "imgs_per_s_rank": [r[name]["imgs_per_s"] for r in ranks],
                     "peak_mem_gib_rank": [r[name]["peak_mem_gib"]
                                           for r in ranks],
                     "one_process_step_ms": one["step_ms"],
                     "launches_rank0": a["launches"]}
        require(same, f"(l2 ii) {name}: the ranks' parameters differ")
        if bf16:
            res[name]["control"] = {"items_max_rel_err": c_err,
                                    "moves": c_moves}
            require(err0 <= bar and err <= max(bar, c_err)
                    and moves["cos"] >= c_moves["cos"],
                    f"(l2 ii) {name} two ranks against one process: "
                    f"{res[name]}")
            want = FUSED_LAUNCHES if name == "bf16_fused" else TRAIN_LAUNCHES
            require(per_step == want,
                    f"(l2 ii) {name} launches {a['launches']}")
        else:
            require(loss_err <= bar and err <= bar
                    and moves["max_diff_over_max_move"] <= 2e-2,
                    f"(l2 ii) float32 two ranks against one process: "
                    f"{res[name]}")
        for r in ranks:
            for n, v in r[name]["launches"].items():
                launches[n] = launches.get(n, 0) + v
    # (iii) the CLI
    a, b = (r["cli"] for r in ranks)
    run = Path(a["save_dir"])
    rows = _csv_rows(run / "results.csv")
    steps = c["images"] // c["batch"]
    want = {"stem_train_fwd": steps, "stem_train_wgrad": steps,
            "down_train_fwd": steps, "down_train_wgrad": steps}
    res["cli"] = {"writes": [a["writes"], b["writes"]],
                  "run_s": [a["run_s"], b["run_s"]],
                  "fitness": [a["fitness"], b["fitness"]],
                  "launches": [a["launches"], b["launches"]],
                  "results_rows": len(rows)}
    log("(l2 ii, iii) two ranks on one card: " + json.dumps(res))
    require(a["save_dir"] == b["save_dir"] and len(rows) == 1
            and (run / "last" / "state.pt").is_file()
            and (run / "best" / "state.pt").is_file()
            and sorted(set(a["writes"])) == ["save_checkpoint",
                                             "save_weights"]
            and b["writes"] == [] and a["fitness"] == b["fitness"],
            f"(l2 iii) rank 0 alone writes: {res['cli']}")
    require(all(torch.equal(a["sd"][k], b["sd"][k]) for k in a["sd"]),
            "(l2 iii) the CLI's ranks end with other parameters")
    require(a["launches"] == b["launches"] == want,
            f"(l2 iii) launches {res['cli']['launches']}, expected {want}")
    for r in (a, b):
        for n, v in r["launches"].items():
            launches[n] = launches.get(n, 0) + v
    report["data_parallel"] = res
    return launches, data


def evolve_path(dev, report, data, tmp):
    """(l3) ``--evolve 2`` of the train CLI on the card at a tiny size
    (yolov5n 256², b4, one epoch a generation, ``--noval``): evolve.csv
    with a header and two rows, generation 0's hyps ``mutate`` of the
    default hyps by the seed's generator, re-run here."""
    import torch

    from yolov5_obb_tpu_torch import train
    from yolov5_obb_tpu_torch.engine.evolve import mutate
    from yolov5_obb_tpu_torch.utils.general import load_hyp

    e = EVOLVE
    kernels = {n: k for n, k in _named_kernels().items()
               if n in TRAIN_LAUNCHES}
    for k in kernels.values():
        k.launches = 0
    t = time.perf_counter()
    train.main(["--cfg", "yolov5n.yaml", "--data", str(data), "--imgsz",
                str(e["imgsz"]), "--batch-size", str(e["batch"]),
                "--nominal-batch", str(e["batch"]), "--max-labels",
                str(MAX_LABELS), "--workers", "0", "--epochs", "1",
                "--noval", "--noautoanchor", "--seed", str(e["seed"]),
                "--device", dev.type, "--project", str(tmp / "evolve"),
                "--name", "ev", "--evolve", str(e["gens"])])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = {n: k.launches for n, k in kernels.items()}
    lines = (tmp / "evolve" / "ev_evolve" / "evolve.csv").read_text(
        ).strip().splitlines()
    header = lines[0].split(",")
    gen0 = dict(zip(header, lines[1].split(",")))
    want = mutate(load_hyp(), np.random.default_rng(e["seed"]), None)
    bad = [k for k in header[3:] if gen0[k] != f"{want[k]:.6g}"]
    # the stem train kernels a step (at 256² no downsample passes the
    # gate), 4 steps a generation
    steps = e["gens"] * (DP_CLI["images"] // e["batch"])
    want = {"stem_train_fwd": steps, "stem_train_wgrad": steps,
            "down_train_fwd": 0, "down_train_wgrad": 0}
    res = {"rows": len(lines) - 1, "seconds": secs, "gen0": gen0,
           "mismatched_keys": bad, "launches": launches}
    log("(l3) --evolve: " + json.dumps(res))
    require(len(lines) == 1 + e["gens"] and not bad,
            f"(l3) evolve.csv: {res}")
    require(launches == want, f"(l3) launches {launches}, expected {want}")
    report["evolve"] = res
    return launches


def scale_out_path(dev, report, card):
    """Phase (l): (l1) remat, stock and fused; (l2) data parallelism; (l3)
    --evolve.  Returns the launches of its runs on the card, the workers'
    included."""
    import torch

    launches = {}

    def add(phase):
        for n, v in phase.items():
            launches[n] = launches.get(n, 0) + v

    t0 = time.perf_counter()
    refs, bars = {}, {}
    for name, fused in (("bf16_fused", True), ("bf16", False)):
        lr, ref, sd0, batches, bars[name] = remat_path(dev, report, fused)
        add(lr)
        refs[name] = (ref, sd0, batches)
    t1 = time.perf_counter()
    for name, fused in (("bf16", False), ("bf16_fused", True)):
        one = world_of_one(dev, *refs[name], bars[name], fused)
        add(one["launches"])
        report["fused_world_of_one" if fused else "world_of_one"] = one
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    try:
        ldp, data = dp_path(dev, report, refs, tmp, card)
        add(ldp)
        del refs
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        add(evolve_path(dev, report, data, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["scale_out_s"] = {"l1": t1 - t0, "l2": t2 - t1,
                             "l3": time.perf_counter() - t2}
    return launches

# ---------------------------------------------------------------------------
# (m) export and the exported-model backend, val --mesh, autobatch, the
# profiler, the hubconf
# ---------------------------------------------------------------------------

# (m1): the batches the .pt2 (traced at 2) runs, bit for bit the eager forward
EXPORT_BATCHES = (16, 8)
# (m3): val from the .pt2 and from the float32 checkpoint against evaluate
# in memory
EXPORT_MAP_TOL = 1e-4
# (m5): the share of the card's memory autobatch_cuda may fill
AUTOBATCH_FRACTION = 0.85
# (m6): each inference entry point → a substring of its kernels' names
TRACE_KERNELS = {"stem_l1": "stem_l1_kernel", "c3": "c3_kernel",
                 "down": "conv3x3_mma", "neighbor": "neighbor_scan_kernel",
                 "riou_boxes": "riou_boxes_kernel"}


def _eval_record(res) -> dict:
    """``evaluate``'s metrics, per-image detections and host ms/img."""
    return {"metrics": {k: res[k] for k in ("mp", "mr", "map50", "map")},
            "dets": [(d["polys"], d["conf"], d["cls"])
                     for d in res["detections"]],
            "ms_per_img": res["speed_ms_per_img"],
            "pre_ms_per_img": res["speed_pre_ms_per_img"]}


def _same_eval(a, b) -> bool:
    """The same metrics and per-image detections, bit for bit."""
    return (a["metrics"] == b["metrics"] and len(a["dets"]) == len(b["dets"])
            and all(np.array_equal(x, y) for da, db in zip(a["dets"],
                                                          b["dets"])
                    for x, y in zip(da, db)))


def mesh_val_rank(job, dev) -> dict:
    """One rank of (m4): phase (c)'s density-tuned model, packed bf16,
    ``evaluate`` of phase (f)'s val set over the mesh (this rank's rows of
    every batch), cuDNN deterministic; its record and launches."""
    import torch

    from yolov5_obb_tpu_torch.engine.distributed import make_mesh
    from yolov5_obb_tpu_torch.engine.evaluator import evaluate

    data = torch.load(job["input"], weights_only=False)
    model, meta, set_obj = density_model(dev)
    set_obj(job["delta"])
    ds = SeededValSet(data["images"], data["labels"], data["names"])
    kernels = {n: k for n, k in _named_kernels().items() if n in INFER}
    for k in kernels.values():
        k.launches = 0
    with cudnn_deterministic():
        res = evaluate(model, meta, ds, batch_size=job["batch"],
                       conf_thres=VAL_CONF, iou_thres=VAL_IOU,
                       max_det=job["max_det"], mesh=make_mesh())
    return {**_eval_record(res),
            "launches": {n: k.launches for n, k in kernels.items()}}


def _write_val_files(root, val_set):
    """Phase (f)'s val set as files (BMP images, DOTA label files, a
    data.yaml with its class names) for the val CLI."""
    import cv2

    from yolov5_obb_tpu_torch.ops.geometry import rbox2poly

    (root / "images").mkdir(parents=True)
    (root / "labelTxt").mkdir()
    for i, (img, lab) in enumerate(zip(val_set.images, val_set.labels)):
        cv2.imwrite(str(root / "images" / f"v{i:02d}.bmp"),
                    np.ascontiguousarray(img[..., ::-1]))
        polys = rbox2poly(lab[:, 1:6]) if len(lab) else np.zeros((0, 8))
        (root / "labelTxt" / f"v{i:02d}.txt").write_text("\n".join(
            " ".join(f"{v:.1f}" for v in poly)
            + f" {val_set.names[int(c)]} 0"
            for poly, c in zip(polys, lab[:, 0])))
    data = root / "data.yaml"
    data.write_text(f"path: {root}\ntrain: images\nval: images\n"
                    f"nc: {len(val_set.names)}\n"
                    f"names: {json.dumps(list(val_set.names))}\n")
    return data


def export_path(dev, report, val_set, card):
    """Phase (m): (m1) the export of yolov5m at 1024² against the eager
    float32 forward, (m2) the exported model's predict, (m3) the val and
    detect CLIs from the .pt2, (m4) ``evaluate(mesh=)``, (m5)
    ``autobatch_cuda``, (m6) the profiler, (m7) the port's hubconf.
    Returns its launches, the workers' included."""
    import torch
    import torch.distributed as dist

    from yolov5_obb_tpu_torch import export, val
    from yolov5_obb_tpu_torch.engine.distributed import make_mesh
    from yolov5_obb_tpu_torch.engine.evaluator import (
        evaluate,
        make_predict_fn,
    )
    from yolov5_obb_tpu_torch.models.backend import (
        MultiBackend,
        make_backend_predict_fn,
    )
    from yolov5_obb_tpu_torch.models.yolo import create_model
    from yolov5_obb_tpu_torch.ops import rotated_nms as R
    from yolov5_obb_tpu_torch.utils import profiler
    from yolov5_obb_tpu_torch.utils.autobatch import autobatch, autobatch_cuda
    from yolov5_obb_tpu_torch.utils.checkpoint import save_weights
    from yolov5_obb_tpu_torch.utils.fuse import model_info
    from yolov5_obb_tpu_torch.utils.general import load_hyp

    t_phase = time.perf_counter()
    cfg, nc, delta = "yolov5m.yaml", 15, report["obj_delta"]
    kernels = {n: k for n, k in _named_kernels().items() if n in INFER}
    r, steps = {}, {}
    counter = StepCounter(kernels, r, steps)
    counted, launches = counter.run, counter.launches

    def rows_moved(step, names):
        got = r[f"{step}_launches"]
        require(all(got[n] > 0 for n in names),
                f"{step}: {names} not all launched: {got}")

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_export_"))
    try:
        # (m1) the export of phase (c)'s density-tuned weights in float32
        model_p, meta_p, set_obj = density_model(dev)
        set_obj(delta)
        save_weights(tmp / "w", model_p.state_dict(), {
            "cfg": cfg, "names": list(val_set.names),
            "anchors": np.asarray(meta_p.anchors_px).tolist()})
        opt = export.parse_opt(["--weights", str(tmp / "w"), "--cfg", cfg,
                                "--nc", str(nc), "--imgsz", str(IMGSZ),
                                "--out", str(tmp / "export")])
        (tmp / "export").mkdir()
        t = time.perf_counter()
        fwd, model32, meta32 = export.build_forward(opt)
        pt2 = export.export_pt2(fwd, opt, tmp / "export")
        steps["m1_export"] = time.perf_counter() - t
        t = time.perf_counter()
        backend = MultiBackend(pt2, imgsz=IMGSZ)
        steps["m1_load"] = time.perf_counter() - t
        gen = torch.Generator(device=dev).manual_seed(2)
        m1 = {}
        for b in EXPORT_BATCHES:
            x = torch.rand(b, IMGSZ, IMGSZ, 3, device=dev, generator=gen)
            got = backend(x)
            with torch.no_grad():
                want = fwd(x)
            require(got.shape == want.shape and bool(torch.isfinite(got)
                                                     .all()),
                    f"(m1) the .pt2 at batch {b}: {tuple(got.shape)}")
            m1[b] = {"max_abs_err": float((got - want).abs().max()),
                     "max_abs_out": float(want.abs().max())}
            require(torch.equal(got, want),
                    f"(m1) the .pt2 differs from the eager forward: {m1[b]}")
            del x, got, want
        r["m1"] = {"export_s": steps["m1_export"], "load_s": steps["m1_load"],
                   "pt2_mb": pt2.stat().st_size / 2**20, "batches": m1}
        log(f"(m1) export of yolov5m {IMGSZ}² float32 {steps['m1_export']:.1f} "
            f"s, load {steps['m1_load']:.1f} s, against eager {m1} on {card}")

        # (m2) the exported model's predict on phase (c)'s three batches
        gen = torch.Generator(device=dev).manual_seed(1)
        xs = [torch.randint(0, 256, (BATCH, IMGSZ, IMGSZ * 3), generator=gen,
                            device=dev, dtype=torch.uint8) for _ in range(3)]
        nhwc = [x.view(BATCH, IMGSZ, IMGSZ, 3) for x in xs]
        predict, _ = make_backend_predict_fn(pt2, cfg, nc, IMGSZ, CONF, IOU,
                                             MAX_DET)
        outs = counted("m2_predict", lambda: [predict(x) for x in nhwc])
        rows_moved("m2_predict", ("riou_boxes", "neighbor"))
        mism = 0
        with torch.inference_mode():
            for x in nhwc:
                rb, sc, cid = R.obb_candidates(backend(x.float() / 255.0),
                                               nc, CONF, 4096, True)
                kk = R._tier(sc.shape[1], int((sc > 0).sum(1).max()))
                mism += _keep_masks(rb, sc, cid, kk)
        require(mism == 0, f"(m2) {mism} keep-mask mismatches")
        eager = make_predict_fn(model32, meta32, CONF, IOU, MAX_DET,
                                multi_label=True)
        r["m2"] = {
            "keep_mask_mismatches": mism,
            "dets_per_img": float(torch.stack([n for _, n in outs])
                                  .float().mean()),
            "pt2_ms_per_img": cuda_time(lambda: predict(nhwc[0]), 3, 1)
            / BATCH,
            "eager_f32_ms_per_img": cuda_time(lambda: eager(nhwc[0]), 3, 1)
            / BATCH}
        log(f"(m2) the .pt2's predict: {r['m2']} on {card}")
        del outs, predict, eager

        # (m3) the val CLI from the .pt2 and from the float32 checkpoint on
        # phase (f)'s images labelled by the float32 model's own conf-0.25
        # detections (phase (f)'s labels are the bf16 model's: the float32
        # NMS keeps other boxes of their dense lattice), written as files,
        # beside evaluate of the same set in memory; --task speed; the
        # detect CLI on phase (i)'s PNGs, from the .pt2 and from the
        # checkpoint
        labeler = make_predict_fn(model32, meta32, CONF, IOU, VAL_LABELS,
                                  multi_label=False, max_candidates=MAXC,
                                  plain=True)
        labels32 = []
        for i in range(0, len(val_set), BATCH):
            d, n = labeler(torch.from_numpy(
                val_set.images[i:i + BATCH]).to(dev))
            labels32 += [d[j, :int(n[j])][:, [6, 0, 1, 2, 3, 4]].cpu().numpy()
                         for j in range(len(n))]
        set32 = SeededValSet(val_set.images, labels32, val_set.names)
        data = _write_val_files(tmp / "valset", set32)
        kw = dict(batch_size=BATCH, conf_thres=VAL_CONF, iou_thres=VAL_IOU,
                  max_det=MAX_DET)
        res_m = evaluate(model32, meta32, set32, **kw)
        res_f = evaluate(model32, meta32, val_set, **kw)
        vargs = ["--cfg", cfg, "--data", str(data), "--imgsz", str(IMGSZ),
                 "--batch-size", str(BATCH), "--no-plots", "--project",
                 str(tmp / "val"), "--exist-ok"]
        res_a = counted("m3_val_pt2", lambda: val.main(
            ["--weights", str(pt2), "--name", "pt2", *vargs]))
        res_b = counted("m3_val_ckpt", lambda: val.main(
            ["--weights", str(tmp / "w"), "--name", "ckpt", *vargs]))
        rows_moved("m3_val_pt2", ("riou_boxes", "neighbor"))
        maps = {k: (res_a[k], res_b[k], res_m[k]) for k in ("map50", "map")}
        require(all(abs(a - b) <= EXPORT_MAP_TOL and abs(m - b)
                    <= EXPORT_MAP_TOL for a, b, m in maps.values())
                and res_b["map50"] > VAL_MAP_FLOOR,
                f"(m3) val from the .pt2 and the checkpoint against evaluate "
                f"in memory: {maps}")
        spd = counted("m3_speed", lambda: val.main(
            ["--weights", str(pt2), "--task", "speed", "--name", "speed",
             *vargs]))
        (tmp / "png").mkdir()
        detect_images(tmp / "png")
        dargs = ["--cfg", cfg, "--data", str(data), "--source",
                 str(tmp / "png"), "--imgsz", str(IMGSZ), "--conf-thres",
                 str(CONF), "--iou-thres", str(IOU), "--nosave", "--save-txt",
                 "--save-conf", "--project", str(tmp / "detect"),
                 "--exist-ok"]
        la, pre_a, inf_a, _ = counted("m3_detect_pt2", lambda: _detect_cli(
            ["--weights", str(pt2), "--name", "pt2", *dargs]))
        lb, pre_b, inf_b, _ = counted("m3_detect_ckpt", lambda: _detect_cli(
            ["--weights", str(tmp / "w"), "--name", "ckpt", *dargs]))
        rows_moved("m3_detect_pt2", ("riou_boxes", "neighbor"))
        # the same rows in every file: boxes of bit-equal scores may come
        # in either order (the checkpoint's NMS selects from the Detect
        # maps, the .pt2's from the decoded rows)
        rows = lambda labels: {k: sorted(v.splitlines())  # noqa: E731
                               for k, v in labels.items()}
        require(rows(la) == rows(lb) and len(la) == len(DETECT_SIZES),
                "(m3) the detect CLI's labels from the .pt2 differ from the "
                "checkpoint's")
        r["m3"] = {
            "labels": sum(len(t) for t in labels32),
            "val_maps_pt2_ckpt_memory": maps,
            "f32_on_bf16_labels": {k: res_f[k] for k in ("mp", "mr", "map50",
                                                         "map")},
            "val_ms_per_img": (res_a["speed_ms_per_img"],
                               res_b["speed_ms_per_img"]),
            "speed_task_ms_per_img": spd["speed_ms_per_img"],
            "detect_rows": sum(len(t.splitlines()) for t in la.values()),
            "detect_speed_ms": {"pt2": {"pre": pre_a, "inference_nms": inf_a},
                                "ckpt": {"pre": pre_b,
                                         "inference_nms": inf_b}}}
        log(f"(m3) val and detect from the .pt2: {r['m3']} on {card}")
        del backend, fwd, model32
        torch.cuda.empty_cache()

        # (m4) evaluate(mesh=) on the packed bf16 path, cuDNN deterministic
        kw = dict(conf_thres=VAL_CONF, iou_thres=VAL_IOU, max_det=MAX_DET)
        with cudnn_deterministic():
            ref = _eval_record(counted("m4_b16", lambda: evaluate(
                model_p, meta_p, val_set, batch_size=BATCH, **kw)))
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
                rank=0)
            try:
                one = _eval_record(counted("m4_world_of_one", lambda:
                                           evaluate(model_p, meta_p, val_set,
                                                    batch_size=BATCH,
                                                    mesh=make_mesh(), **kw)))
            finally:
                dist.destroy_process_group()
            ref8 = _eval_record(counted("m4_b8", lambda: evaluate(
                model_p, meta_p, val_set, batch_size=BATCH // 2, **kw)))
        for step in ("m4_b16", "m4_world_of_one", "m4_b8"):
            rows_moved(step, INFER)
        require(_same_eval(one, ref), "(m4) an NCCL world of one differs "
                "from evaluate without a mesh")
        torch.save({"images": val_set.images, "labels": val_set.labels,
                    "names": val_set.names}, tmp / "valset.pt")
        t = time.perf_counter()
        ranks = launch_workers(tmp, [{
            "kind": "val_mesh", "name": "val_mesh", "delta": delta,
            "input": str(tmp / "valset.pt"), "batch": BATCH,
            "max_det": MAX_DET}], dev)
        steps["m4_two_ranks"] = time.perf_counter() - t
        for rank, out in enumerate(ranks):
            got = out["val_mesh"]
            for n, v in got["launches"].items():
                launches[n] = launches.get(n, 0) + v
            require(all(got["launches"][n] > 0 for n in INFER),
                    f"(m4) rank {rank}: {got['launches']}")
            require(_same_eval(got, ref8), f"(m4) rank {rank} of two at "
                    "global batch 16 differs from one process at batch 8")
        speed = lambda rec: {k: rec[k] for k in (  # noqa: E731
            "ms_per_img", "pre_ms_per_img")}
        r["m4"] = {"metrics": ref["metrics"], "b8_metrics": ref8["metrics"],
                   "two_ranks_s": steps["m4_two_ranks"],
                   "speed": {"b16": speed(ref), "world_of_one": speed(one),
                             "b8": speed(ref8),
                             "two_ranks_b16": [speed(o["val_mesh"])
                                               for o in ranks]}}
        log(f"(m4) evaluate(mesh=): world of one and two gloo ranks bit for "
            f"bit: {r['m4']} on {card}")

        # (m6) the profiler: a trace of three packed predicts, model_info's
        # GFLOPs and the achieved rate of the eager forwards
        pk = make_predict_fn(model_p, meta_p, CONF, IOU, MAX_DET,
                             multi_label=False, max_candidates=MAXC)
        pk(xs[0])
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAUSE_S)  # CUPTI loses a profile's first kernels
        with profiler.trace(str(tmp / "trace")) as d:
            counted("m6_trace", lambda: [pk(x) for x in xs])
        files = list(Path(d).glob("*.pt.trace.json"))
        require(len(files) == 1, f"(m6) trace files {files}")
        names = {e.get("name", "") for e in json.loads(files[0].read_text())
                 ["traceEvents"] if e.get("cat") == "kernel"}
        found = {k: any(v in n for n in names)
                 for k, v in TRACE_KERNELS.items()}
        require(all(found.values()), f"(m6) kernels in the trace: {found}")
        x16 = torch.rand(BATCH, IMGSZ, IMGSZ, 3, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
        model_u, _ = create_model(cfg, nc=nc, dtype=torch.bfloat16,
                                  device=dev)
        info = model_info(model_u, imgsz=IMGSZ, example=(x16,))
        del model_u
        with torch.inference_mode():
            fwd_ms = profiler.block_and_time(model_p, xs[1], iters=5) * 1e3
        r["m6"] = {"trace_kernels": found, "trace_mb":
                   files[0].stat().st_size / 2**20, "model_info": info,
                   "forward_bf16_packed_ms": fwd_ms,
                   "tflops_bf16_packed": info["gflops"] / fwd_ms}
        log(f"(m6) profiler: {r['m6']} on {card}")
        del model_p, pk, xs, nhwc, x16
        torch.cuda.empty_cache()

        # (m5) autobatch_cuda for the packed bf16 train step, one step there
        model_t, meta_t = create_model(cfg, nc=nc, dtype=torch.bfloat16,
                                       device=dev, seed=0, packed_stem=True)
        total = torch.cuda.get_device_properties(dev).total_memory
        hyp = load_hyp()
        t = time.perf_counter()
        b = autobatch_cuda(model_t, imgsz=IMGSZ, train=True,
                           fraction=AUTOBATCH_FRACTION, meta=meta_t)
        steps["m5_autobatch"] = time.perf_counter() - t
        n_params = sum(p.numel() for p in model_t.parameters())
        analytic = autobatch(n_params, imgsz=IMGSZ, width_multiple=0.75,
                             depth_multiple=0.67, hbm_bytes=total, train=True,
                             fraction=AUTOBATCH_FRACTION)
        sd0 = {k: v.clone() for k, v in model_t.state_dict().items()}
        step = seeded_steps(model_t, meta_t, sd0, train_batches(
            dev, hyp["csl_radius"], batch=b, imgsz=IMGSZ), 2, dev,
            batch=b, imgsz=IMGSZ, counted=TRAIN_LAUNCHES)
        for n, v in step["launches"].items():
            launches[n] = launches.get(n, 0) + v
        r["m5"] = {"batch": b, "analytic_batch": analytic,
                   "total_gib": total / 2**30,
                   "step_peak_gib": step["peak_mem_gib"],
                   "step_imgs_per_s": step["imgs_per_s"],
                   "probe_s": steps["m5_autobatch"]}
        log(f"(m5) autobatch: {r['m5']} on {card}")
        require(all(np.isfinite(step["loss"])), "(m5) non-finite loss")
        require(step["peak_mem_gib"] * 2**30 < AUTOBATCH_FRACTION * total,
                f"(m5) a step at batch {b} peaks above "
                f"{AUTOBATCH_FRACTION} of the card: {r['m5']}")
        del model_t, step, sd0
        torch.cuda.empty_cache()

        # (m7) the port's hubconf on the card
        hub = torch.hub.load(str(Path(__file__).resolve().parent
                                 / "yolov5_obb_tpu_torch"), "yolov5n_obb",
                             source="local", imgsz=IMGSZ,
                             dtype=torch.bfloat16, verbose=False)
        require(next(hub.model.parameters()).device.type == dev.type,
                "(m7) the hub model is off the card")
        img = np.random.default_rng(4).integers(0, 256, (IMGSZ, IMGSZ, 3),
                                                dtype=np.uint8)
        dets = counted("m7_hub", lambda: hub(img))
        # random weights clear no threshold: the forward's kernels only
        rows_moved("m7_hub", ("stem_l1", "c3", "down"))
        r["m7"] = {"dets": len(dets.rows()[0])}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r["steps_s"] = steps
    r["phase_s"] = time.perf_counter() - t_phase
    report["export"] = r
    log(f"export phase on {card}: {r['phase_s']:.1f} s, launches "
        f"{launches}")
    return launches


def pre_fmt(speed) -> str:
    return (f"{speed['pre']:.1f} ms pre-process + "
            f"{speed['inference_nms']:.1f} ms inference+NMS a image")


INFER = ("stem_l1", "c3", "down", "riou_boxes", "neighbor")


def _named_kernels():
    from yolov5_obb_tpu_torch.ops.kernels import (
        c3_kernel,
        down_kernel,
        iou,
        neighbor_kernel,
        stem_kernel,
    )
    from yolov5_obb_tpu_torch.ops.kernels import bn_act_train as BN
    from yolov5_obb_tpu_torch.ops.kernels import train_fused as TF

    require(tuple(BN.KERNELS) == BN_ACT_KERNELS,
            f"BatchNorm kernels {list(BN.KERNELS)}")
    return {**BN.KERNELS,
            "stem_l1": stem_kernel.KERNEL, "c3": c3_kernel.KERNEL,
            "down": down_kernel.KERNEL, "neighbor": neighbor_kernel.KERNEL,
            "stem_train_fwd": stem_kernel.TRAIN_FWD_KERNEL,
            "stem_train_wgrad": stem_kernel.TRAIN_WGRAD_KERNEL,
            "down_train_fwd": down_kernel.TRAIN_FWD_KERNEL,
            "down_train_wgrad": down_kernel.TRAIN_WGRAD_KERNEL,
            "pass_1x1_fwd": TF.KERNEL_1X1, "pass_1x1_bwd": TF.KERNEL_1X1_BWD,
            "pass_3x3s1": TF.KERNEL_3X3S1, "pass_3x3s2": TF.KERNEL_3X3S2,
            "stem": stem_kernel.STEM_KERNEL, "pairs_iou": iou.KERNEL,
            "riou_boxes": iou.BOXES_KERNEL}


def main() -> int:
    try:
        import torch
    except ImportError:
        log("torch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py runs on an NVIDIA card")
        return 1
    try:
        from yolov5_obb_tpu_torch.ops.kernels import _build
    except ImportError as e:
        log(f"run from the root of a checkout ({e})")
        return 1
    dev = torch.device("cuda")
    t_script = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # (a) set-up
    card = card_line()
    print(card, flush=True)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    secs = _build.build()
    log(f"kernel build {time.perf_counter() - t:.1f}s wall  {secs}")
    for name, text in _build.PTXAS_LOG.items():
        log(f"--- ptxas {name}\n" + "\n".join(
            l for l in text.splitlines() if "registers" in l or "spill" in l))
    mma = mma_report(_build)
    print("tensor-core kernels: " + json.dumps(mma), flush=True)
    for src, rep in mma.items():
        if isinstance(rep, str):  # built before this run: nothing to read
            continue
        for name in MMA_SOURCES[src]:
            require(any(name in k for k in rep),
                    f"ptxas reported no {name} kernel in {src}.cu")
        for k, r in rep.items():
            require(r["spill_stores"] == 0 and r["spill_loads"] == 0,
                    f"{src}.cu {k} spills: {r}")
            require(r["sass"] == "not available"
                    or isinstance(r["sass"], dict) and r["sass"]["HMMA"] > 0,
                    f"{src}.cu {k} has no HMMA in its SASS: {r}")
    riou = riou_report(_build)
    print("rotated-IoU kernels: " + json.dumps(riou), flush=True)
    for src, rep in riou.items():
        for name in RIOU_SOURCES[src]:
            require(any(name in k for k in rep),
                    f"ptxas reported no {name} kernel in {src}.cu")
        for k, r in rep.items():
            require((r["stack_frame"] == 0 or src not in RIOU_STACK_FREE)
                    and r["spill_stores"] == 0 and r["spill_loads"] == 0,
                    f"{src}.cu {k} keeps a stack frame or spills: {r}")

    # (b) inference kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for check in (check_stem, check_stem_only, check_c3, check_down,
                  check_riou_boxes, check_neighbor, check_pairs_iou):
        name, kern, res = check(gen, dev)
        results[name] = (kern, res)
        torch.cuda.empty_cache()
    # (b') train kernels and (b") the fused train passes against their
    # plain versions
    for check in (check_stem_train, check_down_train, check_pass_3x3,
                  check_pass_1x1):
        results.update(check(gen, dev))
        torch.cuda.empty_cache()
    for name, (_, res) in results.items():
        log(f"{name}: " + json.dumps({k: v for k, v in res.items()
                                      if k not in ("bound",)}))
        require(res["ok"], f"{name} disagrees with its plain version")

    # (c) the inference path; each phase's launches add to the count, and
    # the script's wall time at each phase's end is logged
    report = {"phase_end_s": {}}
    launches = {}

    def add(phase):
        for n, v in phase.items():
            launches[n] = launches.get(n, 0) + v
        at = time.perf_counter() - t_script
        report["phase_end_s"][len(report["phase_end_s"])] = at
        log(f"phase done at {at:.1f} s")

    add(main_path(dev, report))
    results["neighbor"][1]["cases"]["main_path"] = \
        report["neighbor_main_path_case"]
    torch.cuda.empty_cache()
    # (d) the train path, and its bn-half A/B
    add(train_path(dev, report))
    torch.cuda.empty_cache()
    add(train_path(dev, report, bn_half=True))
    torch.cuda.empty_cache()
    # (e) the fused train path
    add(train_path(dev, report, fused=True))
    torch.cuda.empty_cache()
    # (f) the val path
    val_launches, val_set = val_path(dev, report, report["obj_delta"])
    add(val_launches)
    torch.cuda.empty_cache()
    # (g) the train CLI
    add(train_cli_path(dev, report, val_set))
    torch.cuda.empty_cache()
    # (h) the DOTA flow
    add(dota_flow(dev, report, report["obj_delta"]))
    torch.cuda.empty_cache()
    # (i) the detect surface: detect CLI, TTA, ensemble, API, serve
    add(detect_surface(dev, report, report["obj_delta"]))
    torch.cuda.empty_cache()
    # (j) the model zoo: every config, yolov5m6 at 1280², its train step,
    # yolov5s-transformer
    add(zoo_path(dev, report))
    torch.cuda.empty_cache()
    # (k) the golden flow: training from PNG files to the merged OBB mAP,
    # and the golden yolov5n against the JAX package's numbers
    add(golden_path(dev, report))
    torch.cuda.empty_cache()
    # (l) scale-out and training support: remat, data parallelism (one
    # world through NCCL, two processes on the card through gloo, the
    # train CLI in both), --evolve
    add(scale_out_path(dev, report, card))
    torch.cuda.empty_cache()
    # (m) export and the exported-model backend, evaluate(mesh=), autobatch,
    # the profiler, the hubconf
    add(export_path(dev, report, val_set, card))
    log("main path: " + json.dumps(report, default=str))
    for pre, what in (("train_", "train"), ("fused_train_", "fused train")):
        log(f"{what}: {report[pre + 'imgs_per_s']:.2f} img/s at yolov5m b16 "
            f"1024² on {card}; peak {report[pre + 'peak_mem_gib']:.2f} GiB; "
            f"step {report[pre + 'step_breakdown_ms']}; device idle "
            f"{report[pre + 'profile']['idle_share']:.3f}")
    log("fused / stock train img/s: "
        f"{report['fused_train_imgs_per_s'] / report['train_imgs_per_s']:.4f}")
    cli = report["train_cli"]
    log("train CLI resumed epoch under the profiler: "
        + json.dumps(cli["resumed"]["epochs"][0]["profile"]))
    for what in ("stock", "resumed", "fused"):
        r = cli[what]
        log(f"train CLI {what}: img/s over the run {r['imgs_per_s']:.2f} "
            f"({r['run_s']:.2f} s); per epoch, saves included "
            f"{[round(e['imgs_per_s'], 2) for e in r['epochs']]}, its loop "
            f"alone {[round(e['loop_imgs_per_s'], 2) for e in r['epochs']]}"
            f", first batch wait s "
            f"{[round(e['first_batch_wait_s'], 3) for e in r['epochs']]}, loader "
            f"wait share {[round(e['loader_wait_share'], 4) for e in r['epochs']]}"
            f", last/best save ms "
            f"{[(round(e.get('last_save_ms', 0), 1), round(e.get('best_save_ms', 0), 1)) for e in r['epochs']]}"
            f", peak {r['peak_mem_gib']:.2f} GiB; step img/s "
            f"{report['fused_train_imgs_per_s' if what == 'fused' else 'train_imgs_per_s']:.2f} "
            f"(phase {'e' if what == 'fused' else 'd'}) on {card}")
    log(f"train CLI checkpoint load ms: best/ {cli['best_load_ms']:.1f}, "
        f"last/ {cli['last_load_ms']:.1f} on {card}")

    kernels = []
    for name, (kern, res) in results.items():
        b_ms, b_by = res["bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": kern.path,
            "replaces": kern.replaces, "launches": launches[name],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "kernel_ms": res.get("kernel_ms", res["ms"]),
            "plain_ms": res["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": res["library_ms"],
            **{k: res[k] for k in ("library_f32_ms", "ops", "design_ops")
               if k in res},
        })
    print(json.dumps({"kernels": kernels, "main_path": report,
                      "tensor_core_kernels": mma, "card": card},
                     default=str), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:  # a rank of phase (l2) or (m4)
        sys.exit(dp_worker(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
