"""Drive the PyTorch port's LiDAR and camera + LiDAR fusion serving paths
(in float32 and bfloat16), its KFPN, deconv and YOLOv8 training paths, its
evaluation, the serve CLI with per-stream tracking, the test and fuse
CLIs, the raw-drive demo and track CLIs, and the geometry and SLAM path
(RANSAC, ORB, the slam and stereo-calib CLIs) on one NVIDIA GPU and check
them.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device  the card (name and power limit from nvidia-smi); TF32 off
  build   nvcc builds every kernel in sfa3d_tpu_torch/csrc/, one nvcc per
          source, all started together (timed)
  kernel  both entries of the BEV tile kernel (csrc/bev_counts.cu),
          bev_raster_reduce and bev_cell_counts, vs their plain PyTorch
          versions on (8, 32768) inputs: the served shape with and without
          one cell hit 10,000 times, an all-invalid frame, every point on the
          rows where two bands meet, every point in one band. Event time per
          wrapper call, device-only time (torch.profiler), plain and library
          times at the served shape; device time on the other inputs, with no
          points and with every point dropped (where the time goes)
  raster  GPU points_to_bev (through bev_raster_reduce) vs the CPU plain
          path: channels 0 and 1, cell indices, keys and counts bit-exact,
          density within 1.2e-7
  model   KFPN-18 heads at 608x608 on the GPU vs the CPU, within 1e-3
  serve   BatchingDetectorServer(Detector(device="cuda"), max_batch=8)
          answers 16 requests from 4 threads; every reply matches the CPU
          Detector within 1e-3; bev_raster_reduce's launches equal the
          served batches plus the warmup batches; per-batch latency at
          buckets 1 and 8, frames/s and a per-stage split (the raster split
          into its elementwise prelude and the reduce kernel)
  counts  the count map of the 16 served scans through the public op
          (cell_indices_and_keys -> bev_cell_counts, two launches of 8):
          each frame's counts sum to its in-range points, and the density
          they give equals the served raster's channel 2
  fusion_kernels  the three loop kernels of csrc/fusion_loops.cu
          (hard_nms_keep, soft_nms_gaussian, greedy_match) vs their plain
          PyTorch versions on the card, bit for bit (masks, indices and
          soft-NMS scores): random boxes, all-invalid frames, equal scores
          (ties), duplicates, class-offset candidates, K = 1, 33 and 1024
          (the hard-NMS words at their edges), the served shapes (8 x 256
          YOLO candidates; 8 x 114 fused slots; 8 x 64 YOLO x 50 SFA), and
          soft-NMS on either side of soft_nms_matrix_slots (the decay-matrix
          kernel at the limit, the block kernel one above it and at 1024),
          zero and signed scores (-0 ties +0; negative scores order), a
          chain of boxes that each overlap the next (every other one kept);
          the match also on a grid where every YOLO row has a candidate, a
          frame with none, threshold 0 with touching boxes (IoU exactly 0),
          and on either side of greedy_match_matrix_rows at Ks = 256, each
          input through the wrapper and through the block design. Event,
          device, per-step and plain ms at the served shape, device ms of
          both designs of soft-NMS and of the match at the switch and at
          the served shape, candidate rows per frame
  yolo    YOLOv8n heads at 1 x 224 x 640 on the GPU vs the CPU, per level
  fused_serve  BatchingFusedServer(FusedDetector(imgsz=(224, 640))),
          max_batch 8, answers 16 requests (scan + seeded 375 x 1242 uint8
          image + default calibration) from 4 threads; the raster kernel and
          each loop kernel launched once per batch (warmups included);
          every reply equals the CPU path's as a set of detections (integer
          boxes, classes, source exact, scores within 1e-4) when the CPU
          path is given the served networks' outputs for that frame, and the
          CPU networks' own outputs lie within 1e-3 of those; the replies
          hold YOLO, SFA and at least 16 fused rows; the match's candidate
          rows per frame. Per-batch ms at buckets 1 and 8 and a stage split
  train   first one strict-fp32 accumulated step (S = 2 x B = 2 frames,
          128 x 128 raster, deterministic cuDNN) of the same model and batch
          on the card and the CPU, SGD then Adam: loss, every parameter and
          every BatchNorm statistic within the tolerances printed on the
          train_tolerance line. Then the full width through the entry points
          a user calls: the CLI's parser and defaults (fpn_resnet_18 on the
          608 x 608 raster, batch 16, effective batch 64, so S = 4),
          create_train_loader over a synthetic mini-KITTI of 64 frames with
          augmentation and hflip, create_optimizer, create_train_state,
          make_train_step: 5 steps in float32 and 3 in the bfloat16 default
          (CUDA-event ms per step, frames/s end to end with the loader's
          wait and on the device alone, peak memory), every loss finite,
          bev_raster_reduce launched once per collated batch; 8 Adam steps
          on one fixed batch lower its loss; one collated batch of 64
          frames (hflip as drawn) through the raster kernel against its
          plain version on the card, and through prepare_train_batch
          against the CPU route (raster channels 0 and 1 and the integer
          targets bit-exact); one epoch of the training CLI, whose
          checkpoint Detector loads, and its validation batches (16, 16 and
          a tail of 8 frames) on the card against the CPU route
  dp_train  data parallelism (parallel/mesh.py) on the one card, strict
          fp32 with deterministic cuDNN: (a) an SFA3D_DIST world of one over
          NCCL in a subprocess, the CLI's step (4 x 16 frames at 608 x 608,
          SGD) through make_mesh() bit-equal to the plain step, and the mesh
          path forced at world 1 (NCCL all-reduces, global BatchNorm in
          flax's order, the normalizers) within the train phase's
          tolerances, step ms of each; (b) two gloo ranks sharing the card
          (spawned), each preparing its 8 frames of a global batch of 16 at
          608 x 608 (one bev_raster_reduce launch a rank and batch) and
          making two SGD steps on it (the second timed), against one
          process with the whole batch: the first step's loss, parameters
          and BatchNorm statistics within the train phase's tolerances, the
          ranks identical, step ms of each; (c) one epoch of the training
          CLI with --mesh_shape 1 under SFA3D_DIST, whose checkpoint
          Detector loads
  dp_sp   data x spatial parallelism (make_mesh_2d(2, 2), the BEV and image
          rows split over 'spatial') with four gloo ranks sharing the card,
          spawned once: the row exchange (fetch_rows, gather_rows, forward
          and backward) on the card, through host memory, bit-equal to the
          CPU route and to slicing; scripts/torch_spatial_parity_check.py's
          float64 proof at 64 x 64 (dp and dp x sp steps against the
          unsharded step: loss 1e-12, updates 1e-9 relative); the full-width
          step (608 x 608, 2 frames a data index, strict fp32, SGD and EMA,
          one raster launch a rank) with its loss within 1e-4 of the
          one-process card step and the EMA recurrence exact; the fused
          program at batch 8 (608 x 608, the 224 x 640 canvas, fused_serve's
          conditioned weights) against the one-device program: valid and
          the 3D masks equal, metric boxes within 1e-3, the networks within
          1e-3, the integer boxes equal to the one-device program's given
          the rank's network outputs and directly within a pixel (the flips
          counted); each kernel launched once a rank. Step ms, exchanges,
          bytes and host-staging ms per step, fused ms
  native  the native host reader (native/preproc.cpp, g++ at first use) on
          64 seeded KITTI-sized .bin scans (about 120k points; one overflows
          MAX_POINTS_FILTERED, one holds NaN rows): the fused read and the
          filter bit-equal to the numpy twin, ms per scan of each; the train
          phase's loader at the CLI's defaults with and without it
          (SFA3D_TPU_NO_NATIVE): wait per step, and one batch of 64 frames
          split into read, filter and pad, the dataset's whole item,
          collation, the copy to the card and the device preparation
  yolo_train_parity  one strict-fp32 YOLOv8n epoch (S = 3 x B = 2 at 64 x
          128, 3 classes, AdamW with a warmup, EMA, fixed flips) of the same
          model and data on the card and the CPU: loss terms, parameters,
          BatchNorm statistics and EMA within the printed tolerances
  yolo_train  the yolo-train CLI's defaults (YOLOv8n, 192 x 640, batch 16,
          3 classes) over the train phase's mini-KITTI camera frames (port
          renderer, PNG codec): 4 epochs with an eval pass and 2D mAP after
          each (hard_nms_keep once per eval batch), finite losses; the same
          entry points timed step by step (CUDA-event ms, frames/s on the
          device and end to end, peak memory); 8 steps on one batch lower
          its loss
  yolo_eval  best.pt through load_yolo_checkpoint, the val split through
          make_yolo_eval_fn on the card: one hard_nms_keep launch per batch,
          every batch's detections equal to the CPU selection (plain NMS)
          fed the card's network outputs and their decode, the 2D mAP
          equal, the CPU's own decode within 1e-4 px + 2.4e-7 relative
          (scores 1e-6); hard_nms_keep at the eval's (8, 512) bit-exact
          against its plain version, timed
  kitti_eval  python -m sfa3d_tpu_torch.cli.eval on the card and with
          --platform cpu on one KFPN-18 checkpoint (heatmap biases bumped):
          every AP within 1e-6, one bev_raster_reduce launch per frame; the
          evaluator on seeded detections near the ground truth (AP above 0)
          card vs CPU; rotated BEV and 3D IoU card vs CPU within 1e-5
  track_kernels  the tracker's association loop (csrc/track_associate.cu),
          both designs (the matrix design and the row design) and the
          wrapper vs the plain PyTorch version on the card, bit for bit
          (det_match, trk_used) at iou_min 0.01, 0, -1 and -2: crowded and
          tied IoUs at (1, 50, 64) and (8, 50, 64), every pair ineligible,
          max_tracks 256, and crafted cases (signed NaNs and zeros,
          infinities, values below -1, K above and below T, T = 33, 100,
          256 and 300, which takes the row design by shape); candidate rows
          per input; both designs timed in turns at (1, 50, 64), (8, 50, 64)
          and (1, 50, 256): device, event and host enqueue ms, per chain
          step; plain ms
  track   a seeded moving scene (30 frames, 20 objects, K = 50, 64 slots;
          jitter, dropouts, false positives, a pi-flipped yaw) through
          track_sequence on the card and the CPU: ids, alive, confirmed and
          next_id equal, boxes / velocities / scores within 1e-3, CLEAR-MOT
          counts equal (MOTP within 1e-3), one track_associate launch a
          frame, the candidate rows of each frame's association; ms per
          tracker_step. Then a seeded 1,000-frame stream with births and
          deaths on both, measured, not held to a limit: the largest box
          difference, the frame where it is reached, the first frame whose
          ids or flags differ
  serve_cli  python -m sfa3d_tpu_torch.cli.serve --track over stdio, in
          this process, KFPN-18 at 608 x 608 (random weights, heatmap and
          dim biases raised), 2 streams x 8 ordered frames, a track_reset
          and a bad request, on the card and with --platform cpu: replies in
          request order, detections within 1e-3, track ids and confirmed
          flags equal, one bev_raster_reduce launch per served batch and one
          track_associate launch per tracked frame; bucket-1 batch ms with
          --track on and off; one TCP round trip on the card; --arch
          resnet_18 card vs CPU
  argoverse_kernel  the Argoverse entry (argoverse_raster_reduce: points
          bucketed by band, then one block a band; three kernels a call) at
          1, 16 and 64 sweeps of 131072 points -> 1000 x 1000, each on three
          inputs: "training" (about 94k in-range points a sweep, one cell hit
          10,000 times, an all-invalid sweep, z and r negative, -0.0,
          subnormal and NaN), "band_edges" (every point on a row where two
          bands meet, of either design) and "one_band" (every point of a
          sweep in one band, with the hot cell). Each is held bit for bit
          against the plain PyTorch version on the card, against the tile
          design (the first one, past the wrapper: argoverse_tile_direct) and, on
          its count channel, against bev_cell_counts; "training" also against
          the CPU. Per shape: device ms of each kernel (histogram, scatter,
          reduce, the tables' memset) and their sum, launches a call, event
          ms, the bound and its share, the design's bytes beyond the bound,
          the tile design's device and event ms in the same run, plain and
          library (scatter_reduce_ amax x 2 + bincount) ms; device ms on the
          other two inputs
  argoverse  a 64-sweep mini-Argoverse from the port's writer: the raster of
          16 sweeps on the card against the CPU (indices, height and
          intensity bit-exact, density within 1e-4 of 255); the
          argoverse_test CLI over 16 sweeps on the card and with --platform
          cpu (every frame answered, detections within 1e-3, one raster
          launch a sweep, ms a sweep; the camera composites equal card vs
          CPU, the first sweep's _rgb.jpg and _bev.jpg the JPEGs of the
          arrays written, decoded and timed); the training path at the CLI's
          defaults (608 crop, batch 16, effective batch 64, bfloat16): 3
          timed steps through create_train_loader / make_train_step (finite
          losses, one raster launch per collated batch, CUDA-event ms,
          frames/s end to end, peak memory), then one epoch of the training
          CLI with --val_ap (warned and skipped), whose checkpoint
          argoverse_test loads
  export  the AOT export (runtime/export.py) on the card at full width
          (fpn_resnet_18, 608 x 608, 32768 points, K = 50, heatmap biases
          raised): a symbolic-batch and a batch-8 detector artifact, saved,
          loaded and run at buckets 1 and 8 against Detector.detect_batch
          (masks equal, boxes within 1e-4, one bev_raster_reduce launch a
          call), the batch-8 one refusing a batch of 1; a fresh python3
          process that loads the symbolic artifact and makes its first call;
          a batch-8 fused artifact (375 x 1242 frames, letterbox 640) of a
          FusedDetector(imgsz=640)'s conditioned weights against its
          run_batch given the baked pad (every reply equal; one launch each
          of bev_raster_reduce, hard_nms_keep, soft_nms_gaussian and
          greedy_match a call); cli export --batch 8, then cli serve
          --artifact over stdio with and without --track (every request
          answered, batches padded to 8, detections within 1e-3 of the live
          detector, one raster launch a batch, one track_associate launch a
          tracked frame). Export, save and load seconds, file MB, first-call
          ms, ms a batch of the artifact and of the live detector in turns;
          the host enqueue ms of every kernel entry through its custom op
          and past the dispatcher (the raster also as a bare C call)
  viz_cli  the test and fuse CLIs (numpy drawing, JPEG files) over a
          4-frame mini-KITTI of the port's writer, in process: test
          --save_test_output on the card and with --platform cpu (the same
          8 files a frame, one bev_raster_reduce launch a frame on the card
          and none on the CPU, the raw BEV dumps equal, the composites equal
          on every frame whose integer box corners are equal, counted and
          printed, and at least one such frame); fuse on the card in the nms (--side_by_side), weighted,
          bayesian and bayesian --gaussian_nms modes, with each kernel's
          launches a frame checked (raster 1; hard_nms_keep 1 for YOLO, +1
          after fusion without soft-NMS; greedy_match 1 in weighted and
          bayesian; soft_nms_gaussian 1 with --gaussian_nms); bayesian
          --gaussian_nms again on the CPU (summary.txt and the counts
          equal); fuse --artifact through a batch-1 fused export of the same
          weights and settings (each kernel once a frame, as a custom op;
          the images equal to the live run's with the FPS header masked).
          Median per-frame host ms of detection, fusion, drawing and JPEG
          writes, and the detection's device-side ms (CUDA events); the
          images compared are the arrays handed to the writer, whose files
          hold their JPEG bytes
  drive_cli  the raw-drive CLIs over an 8-frame write_mini_drive(motion=
          True) of the port's writer, in process: demo, demo --two_sides and
          track on the card and with --platform cpu (bev_raster_reduce 1 or
          2 launches a frame and track_associate 1 a frame on the card, none
          on the CPU; detection counts per window equal; track ids,
          confirmed and alive equal, live boxes within 1e-3, the summary
          line equal); every AVI read back through read_avi_frames and the
          decoder (frame count and size, each frame the JPEG bytes of its
          composite, the decoded frame's max error and PSNR against the
          composite, at least 30 dB); test --output_format video
          --enable_kfpn_viz over 2 mini-KITTI frames on the card (one raster
          launch a frame, the AVI, 25 feature dumps a frame); the JPEG round
          trip of a seeded image against the digest its CPU test pins;
          per-frame host ms of detection, tracking, drawing, JPEG encode and
          AVI write; encode and decode ms of a 375 x 1242 and a 1200 x 1920
          frame
  slam    geometry and SLAM: ransac_pnp (128 hypotheses of 6, 64 slots) and
          estimate_fundamental_ransac (256 of 8, 1024 slots) -> essential ->
          recover_pose on the card and the CPU with the same minimal sets
          (float64 within 1e-8; float32 F within 1e-3, the poses within
          1e-4 / 1e-3 or twice both sides' float32 gap to the float64
          solution where that is larger); the port's ORB on the port writer's 375 x 1242 stereo
          pair card vs CPU (keypoints, descriptors and the matches equal)
          and the calibration on the card within tests/test_slam.py's
          bounds; cli stereo-calib --run_yolo over 2 pairs (calibrated 2/2,
          hard_nms_keep once a pair); cli slam over 4 mini-KITTI frames in
          each --calib_method and VISUAL_SLAM_SIM --use_pnp on the card and
          with --platform cpu (the drift sources' calibrations and fused
          counts equal, and the images equal on every frame whose fused
          boxes are equal, at least one; --use_pnp's float32 poses within
          twice both sides' gap to the float64 solution, its calibrations,
          counts and differing pixels printed; each kernel's launches a
          frame checked). Host ms of ORB per level, the
          match, F-RANSAC, recover_pose, ransac_pnp, and a cli slam frame's
          detection, calibration, fusion, drawing and JPEG write
  bf16_serve  Detector and FusedDetector(imgsz=(224, 640)) in bfloat16
          (bfloat16 convolution weights cast once, float32 BatchNorm) and
          in strict float32, on fused_serve's conditioned weights with
          boxes of KITTI's sizes (through .pth / .pt files) and its 16
          requests, at buckets 8 and 1: the raw heads and YOLO levels
          bfloat16; bev_raster_reduce and each loop kernel launched once a
          batch; the bf16 detections (LiDAR and the fused 3D branch)
          matched to the float32 ones at least 0.9 of them, every field's
          p95 deviation within 3 x the JAX audit's (BF16_AUDIT.json); the
          fused 2D rows matched at least 0.9; ms a batch in each dtype
          at buckets 1 and 8, KFPN and YOLOv8n ms at batch 8; one `serve
          --dtype bfloat16 --fused` request through the CLI
  train_options  one strict-fp32 resnet_18 (deconv) step card vs CPU
          under the train phase's tolerances; one epoch of the training
          CLI with --arch resnet_18 --imagenet_pretrained --imagenet_weights
          (a stand-in torchvision file the phase writes) --profile_dir: the
          ImageNet init logged, the weights within Adam's first step of the
          file's, one raster launch, CUDA kernels in the trace and the
          key_averages table written, the checkpoint loaded by Detector
  checks  the five ports of the JAX check scripts (scripts/torch_*_check.py),
          each a subprocess on the card at full width (fpn_resnet_18, 608 x
          608) and tiny depth, exit code 0 required: generalize (16 / 4
          frames, 2 epochs from conditioned weights, SIGKILLed after the
          epoch-1 checkpoint, resumed through --auto_resume, the curve
          through cli.eval), trained parity (that run's last checkpoint,
          its EMA weights, card against CPU on 4 held-out frames), tracking
          (detector mode, 1 x 6 frames, on the card and with --platform
          cpu: track ids equal), fusion (4 frames, the train phase's
          mini-KITTI, the yolo_train phase's best.pt: trained-camera rows
          too) and Argoverse (8 / 2 sweeps, 1 epoch); the accuracy gates in
          --smoke mode (tiny depth cannot pass them); each check's wall
          seconds and the kernel launches its own process counted
Then the script's total seconds, one {"kernels": [...]} line and, last, the
{"ok": true, ...} line.

Exits non-zero, with no result line, when CUDA is unavailable or any
phase fails. Weights are random, drawn from a fixed torch.Generator.
"""

from __future__ import annotations

import copy
import json
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

from sfa3d_tpu_torch import _build
from sfa3d_tpu_torch.config import kitti as cnf
from sfa3d_tpu_torch.detector import Detector, FusedDetector, format_detections, fused_reply
from sfa3d_tpu_torch.fusion.batch import _fuse_one, _unletterbox_xywh
from sfa3d_tpu_torch.fusion.boxes2d import project_boxes_to_image
from sfa3d_tpu_torch.fusion.nms import _stable_desc_order
from sfa3d_tpu_torch.geometry.calibration import KittiCalibration
from sfa3d_tpu_torch.models import create_model
from sfa3d_tpu_torch.models.yolov8 import (
    YOLOv8,
    decode_predictions,
    forward_levels,
    letterbox,
    select_detections,
)
from sfa3d_tpu_torch.ops import bev as bev_ops
from sfa3d_tpu_torch.ops import bev_counts, fusion_loops
from sfa3d_tpu_torch.ops.bev_counts import (
    ARGOVERSE_BYTES_PER_CELL,
    COUNT_BYTES_PER_CELL,
    RASTER_BYTES_PER_CELL,
    argoverse_band_plan,
    argoverse_raster_reduce,
    argoverse_raster_reduce_plain,
    argoverse_scratch_len,
    bev_cell_counts,
    bev_cell_counts_plain,
    bev_raster_reduce,
    bev_raster_reduce_plain,
    multiprocessor_count,
    shared_memory_limit,
    tile_plan,
)
from sfa3d_tpu_torch.pipeline import _decode_heads, _heads_nhwc, forward_heads
from sfa3d_tpu_torch.runtime.serving import BatchingDetectorServer, BatchingFusedServer

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SEED = 0
HM_BIAS_BUMP = 2.0  # random weights then give peaks above the threshold
B, N = 8, cnf.MAX_POINTS_FILTERED
H, W = cnf.BEV_HEIGHT, cnf.BEV_WIDTH
DENSITY_TOL = 1.2e-7  # one float32 ulp of log between two libms, scaled
KERNEL_NAME = r"bev_tile_kernel"
CANVAS = (224, 640)  # the ultralytics predict canvas of a 375 x 1242 KITTI frame
IMG_HW = (375, 1242)
SCORE_TOL = 1e-4  # fused scores GPU vs CPU: conv sums in another order
NET_TOL = 1e-3  # KFPN heads and YOLO levels GPU vs CPU (the model phase's tolerance)
IOU_FLOPS = 22  # float operations of one IoU and its comparison
DEVICE = torch.device("cuda")  # the fusion phases' device


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one fn() call, from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_kernels(fn, pattern: str, reps: int = 20, warmup: int = 3) -> dict:
    """{kernel: {"device_ms": per fn() call, "launches": per call}} for the
    device activities whose name matches `pattern` (torch.profiler, CUPTI),
    each named by its match. Now and then a profiled window loses device
    records: it sees no kernel, or a kernel fewer times than the calls made
    it (fn() launches the same kernels on every call, so each count is a
    whole multiple of reps). Such a window is profiled again, up to three
    windows; the last one that saw any kernel is returned, else {}."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    seen = {}
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found, counts = {}, {}
        for e in prof.key_averages():
            m = re.search(pattern, e.key)
            us = self_device_us(e)
            if m and us > 0:
                k = found.setdefault(m.group(0), {"device_ms": 0.0, "launches": 0.0})
                k["device_ms"] += us / reps / 1e3
                k["launches"] += e.count / reps
                counts[m.group(0)] = counts.get(m.group(0), 0) + e.count
        if found:
            seen = found
            if all(c % reps == 0 for c in counts.values()):
                return found
    return seen


def device_ms(fn, reps: int = 20, warmup: int = 3, kernel: str = KERNEL_NAME):
    """Mean device time per fn() call of the kernels whose name matches
    `kernel`, summed (`device_kernels`); None if the profiler saw none."""
    found = device_kernels(fn, kernel, reps, warmup)
    return sum(k["device_ms"] for k in found.values()) if found else None


def host_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median wall time of one fn() call that ends on the host."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def make_scan(rng: np.random.Generator) -> np.ndarray:
    """A KITTI-like raw scan: ground, clutter and car-sized boxes of points,
    about 25k of them inside the front range."""
    n_ground, n_clutter = 22000, 5000
    ground = np.stack([
        rng.uniform(0, 55, n_ground), rng.uniform(-28, 28, n_ground),
        rng.normal(-1.73, 0.05, n_ground), rng.uniform(0, 0.4, n_ground),
    ], 1)
    clutter = np.stack([
        rng.uniform(-5, 55, n_clutter), rng.uniform(-28, 28, n_clutter),
        rng.uniform(-1.7, 1.2, n_clutter), rng.uniform(0, 1, n_clutter),
    ], 1)
    objects = []
    for _ in range(10):
        cx, cy = rng.uniform(5, 45), rng.uniform(-20, 20)
        n = 700
        objects.append(np.stack([
            cx + rng.uniform(-1.9, 1.9, n), cy + rng.uniform(-0.8, 0.8, n),
            rng.uniform(-1.7, -0.2, n), rng.uniform(0.2, 0.9, n),
        ], 1))
    return np.concatenate([ground, clutter, *objects]).astype(np.float32)


def make_edge_scan(rng: np.random.Generator, n: int) -> np.ndarray:
    """Points exactly on cell edges and one float32 ulp either side."""
    d = np.float32(cnf.DISCRETIZATION)

    def near_edges(k):
        v = (k * d).astype(np.float32)
        u = rng.random(len(k))
        v = np.where(u < 1 / 3, np.nextafter(v, np.float32(1e3)), v)
        return np.where(u > 2 / 3, np.nextafter(v, np.float32(-1e3)), v)

    x = near_edges(rng.integers(0, H + 1, n))
    y = near_edges(rng.integers(-W // 2, W // 2 + 1, n))
    z = rng.uniform(cnf.boundary["minZ"], cnf.boundary["maxZ"], n).astype(np.float32)
    z[: n // 50] = np.float32(cnf.boundary["minZ"])
    z[n // 50: n // 25] = np.float32(cnf.boundary["maxZ"])
    r = rng.uniform(0, 1, n).astype(np.float32)
    return np.stack([x, y, z, r], 1)


def bump_heatmap_bias(model: torch.nn.Module) -> None:
    with torch.no_grad():
        for i in range(3):
            getattr(model, f"fpn{i}_hm_cen")[2].bias += HM_BIAS_BUMP


def sorted_rows(dets):
    rows = np.asarray([[d["class_id"], d["x"], d["y"], d["z"], d["h"], d["w"],
                        d["l"], d["yaw"], d["score"]] for d in dets], np.float64)
    if len(rows) == 0:
        return rows.reshape(0, 9)
    return rows[np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))]


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no GPU to run on",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    emit({"phase": "device", **card, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return card


def phase_build(card):
    t0 = time.perf_counter()
    per_lib = _build.build_libraries()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": per_lib, "card": card["nvidia_smi"]})


def kernel_inputs(rng: np.random.Generator, raster_rows: int, count_rows: int):
    """The kernel phase's (B, N) int32 inputs, {name: (row, col, key)}; -1
    marks a dropped point in all three."""
    def drop(row, col, key, invalid):
        row, col, key = row.copy(), col.copy(), key.copy()
        row[invalid] = col[invalid] = key[invalid] = -1
        return row, col, key

    def keys():
        return rng.integers(0, 1 << 25, (B, N)).astype(np.int32)

    row = rng.integers(0, H, (B, N)).astype(np.int32)
    col = rng.integers(0, W, (B, N)).astype(np.int32)
    no_hot = drop(row, col, keys(), rng.random((B, N)) < 0.3)
    served = tuple(a.copy() for a in no_hot)
    served[0][3, :10000] = 123  # one cell hit 10,000 times
    served[1][3, :10000] = 456
    served[2][3, :10000] = rng.integers(0, 1 << 25, 10000)
    all_invalid = np.zeros((B, N), bool)
    all_invalid[5] = True
    edges = sorted({e for t in (raster_rows, count_rows) for m in range(t, H, t) for e in (m - 1, m)})
    one_band = 6 * raster_rows
    return {
        "served_hot_cell": served,
        "served_no_hot_cell": no_hot,
        "all_invalid_frame": drop(*served, all_invalid),
        "band_edges": (rng.choice(edges, (B, N)).astype(np.int32),
                       rng.integers(0, W, (B, N)).astype(np.int32), keys()),
        "one_band": (rng.integers(one_band, one_band + raster_rows, (B, N)).astype(np.int32),
                     rng.integers(0, W, (B, N)).astype(np.int32), keys()),
    }


def raster_errors(got, want):
    """Max |diff| per channel of two (B, 3, H, W) rasters; raises unless
    channels 0 and 1 are bit-exact and density is within DENSITY_TOL."""
    errs = [(got[:, c] - want[:, c]).abs().max().item() for c in range(3)]
    for c in (0, 1):
        if not torch.equal(got[:, c], want[:, c]):
            raise AssertionError(f"raster channel {c} is not bit-exact: max |diff| {errs[c]}")
    if errs[2] > DENSITY_TOL:
        raise AssertionError(f"raster density off by {errs[2]}")
    return errs


def phase_kernel(card):
    dev = torch.device("cuda")
    smem = shared_memory_limit(dev)
    raster_plan = tile_plan(B, H, W, RASTER_BYTES_PER_CELL, smem)
    count_plan = tile_plan(B, H, W, COUNT_BYTES_PER_CELL, smem)
    cases = kernel_inputs(np.random.default_rng(SEED), raster_plan[0], count_plan[0])
    # where the device time goes: no points at all (empty the band, write
    # it), every point dropped (adds the scan of `row`), the served input
    cases["no_points"] = tuple(np.zeros((B, 0), np.int32) for _ in range(3))
    cases["all_invalid"] = tuple(np.full((B, N), -1, np.int32) for _ in range(3))
    checks = {}
    for name, arrays in cases.items():
        row, col, key = (torch.from_numpy(a).to(dev) for a in arrays)
        counts, counts_plain = bev_cell_counts(row, col), bev_cell_counts_plain(row, col)
        raster, raster_plain = bev_raster_reduce(row, col, key), bev_raster_reduce_plain(row, col, key)
        torch.cuda.synchronize()
        if not torch.equal(counts, counts_plain):
            err = (counts - counts_plain).abs().max().item()
            raise AssertionError(f"bev_cell_counts disagrees with its plain version on {name}: {err}")
        checks[name] = {"raster_max_abs_err": raster_errors(raster, raster_plain),
                        "raster_bit_exact": torch.equal(raster, raster_plain)}
        if name == "served_hot_cell":
            cpu = [torch.from_numpy(a) for a in arrays]
            if not torch.equal(counts.cpu(), bev_cell_counts_plain(*cpu[:2])):
                raise AssertionError("bev_cell_counts on the card differs from the CPU plain version")
            raster_errors(raster.cpu(), bev_raster_reduce_plain(*cpu))
            if counts[3, 123, 456].item() < 10000:
                raise AssertionError("the hot cell lost counts")
        if name == "all_invalid_frame" and (counts[5].any() or raster[5].any()):
            raise AssertionError("an all-invalid frame left a mark")
    emit({"phase": "kernel", "shape": [B, N], "shared_memory_per_block": smem,
          "raster_plan": raster_plan, "count_plan": count_plan, "checks": checks,
          "card": card["nvidia_smi"]})

    recs = []
    for entry in ("bev_cell_counts", "bev_raster_reduce"):
        fn = bev_cell_counts if entry == "bev_cell_counts" else bev_raster_reduce
        timed = {}
        for name in ("served_hot_cell", "served_no_hot_cell", "one_band", "no_points", "all_invalid"):
            row, col, key = (torch.from_numpy(a).to(dev) for a in cases[name])
            args = (row, col) if entry == "bev_cell_counts" else (row, col, key)
            timed[name] = {"ms": cuda_ms(lambda: fn(*args)), "device_ms": device_ms(lambda: fn(*args))}
        row, col, key = (torch.from_numpy(a).to(dev) for a in cases["served_hot_cell"])
        ok = row >= 0
        n_valid = int(ok.sum().item())
        batch = torch.arange(B, device=dev)[:, None]
        flat = torch.where(ok, (batch * H + row) * W + col, B * H * W).reshape(-1)
        if entry == "bev_cell_counts":
            bytes_moved = 2 * row.numel() * 4 + B * H * W * 4
            ops = n_valid  # one count per point
            plain_ms = cuda_ms(lambda: bev_cell_counts_plain(row, col))
            library_ms = cuda_ms(lambda: torch.bincount(flat, minlength=B * H * W + 1))
        else:
            bytes_moved = 3 * row.numel() * 4 + B * 3 * H * W * 4
            ops = 2 * n_valid + 6 * B * H * W  # max + count per point, epilogue per cell
            cid = torch.where(ok, row.long() * W + col.long(), H * W)
            plain_ms = cuda_ms(lambda: bev_raster_reduce_plain(row, col, key))

            def library():  # the pair the reduce replaced, as a yardstick only
                torch.full((B, H * W + 1), -1, dtype=torch.int32, device=dev).scatter_reduce_(
                    1, cid, key, reduce="amax", include_self=True)
                torch.bincount(flat, minlength=B * H * W + 1)

            library_ms = cuda_ms(library)
        bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = ops / FP32_OPS_PER_S * 1e3
        bound_ms = max(bound_bytes_ms, bound_ops_ms)
        dms = timed["served_hot_cell"]["device_ms"]
        recs.append({
            "name": entry,
            "route": "cuda",
            "source": "sfa3d_tpu_torch/csrc/bev_counts.cu",
            "replaces": "sfa3d_tpu/ops/bev_pallas.py:76",
            "launches": None,  # filled in from the path's run
            "max_abs_err": (max(max(c["raster_max_abs_err"]) for c in checks.values())
                            if entry == "bev_raster_reduce" else 0.0),  # counts: exact or raised
            "ms": timed["served_hot_cell"]["ms"],
            "device_ms": dms,
            "event_minus_device_ms": timed["served_hot_cell"]["ms"] - dms if dms else None,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            "bound_share_device": bound_ms / dms if dms else None,
            "library_ms": library_ms,
            "ms_one_band": timed["one_band"]["ms"],
            "device_ms_one_band": timed["one_band"]["device_ms"],
            "device_ms_no_hot_cell": timed["served_no_hot_cell"]["device_ms"],
            "device_ms_no_points": timed["no_points"]["device_ms"],
            "device_ms_all_invalid": timed["all_invalid"]["device_ms"],
            "bytes": bytes_moved,
            "valid_points": n_valid,
        })
        emit({"phase": "kernel_time", **{k: v for k, v in recs[-1].items()
                                         if k not in ("route", "source", "replaces", "launches")},
              "card": card["nvidia_smi"]})
    return recs


def phase_raster(card):
    rng = np.random.default_rng(SEED + 1)
    padded = [bev_ops.filter_and_pad_points(make_scan(rng), N),
              bev_ops._pad_raw(make_edge_scan(rng, N), N)]
    pts = np.stack([p for p, _ in padded])
    valid = np.stack([v for _, v in padded])
    pts_c, valid_c = torch.from_numpy(pts), torch.from_numpy(valid)
    pts_g, valid_g = pts_c.cuda(), valid_c.cuda()

    idx_gpu = bev_ops.cell_indices_and_keys(pts_g, valid_g)
    idx_cpu = bev_ops.cell_indices_and_keys(pts_c, valid_c)
    in_range = int((idx_cpu[0][0] >= 0).sum().item())
    if in_range < 20000:
        raise AssertionError(f"raster scan has only {in_range} in-range points")
    gpu = bev_ops.points_to_bev(pts_g, valid_g).cpu()
    cpu = bev_ops.points_to_bev(pts_c, valid_c)
    for name, a, b in zip(("row", "col", "key"), idx_gpu, idx_cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"raster {name} differs between GPU and CPU")
    counts_gpu = bev_cell_counts(idx_gpu[0], idx_gpu[1]).cpu()
    counts_cpu = bev_cell_counts_plain(idx_cpu[0], idx_cpu[1])
    if not torch.equal(counts_gpu, counts_cpu):
        raise AssertionError("raster counts differ between the kernel and the plain version")
    for c in (0, 1):
        if not torch.equal(gpu[..., c], cpu[..., c]):
            raise AssertionError(f"raster channel {c} is not bit-exact")
    density_err = (gpu[..., 2] - cpu[..., 2]).abs().max().item()
    if density_err > 1.2e-7:
        raise AssertionError(f"density channel off by {density_err}")
    emit({"phase": "raster", "in_range_points": in_range,
          "occupied_cells": int((cpu[..., 2] > 0).sum().item()),
          "max_count": float(counts_cpu.max().item()),
          "density_max_abs_err": density_err, "card": card["nvidia_smi"]})
    return pts, valid


def phase_model(card, pts, valid):
    cpu_model = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(SEED))
    bump_heatmap_bias(cpu_model)
    cpu_model.eval()
    gpu_model = copy.deepcopy(cpu_model).cuda()
    bev = bev_ops.points_to_bev(torch.from_numpy(pts[:1]), torch.from_numpy(valid[:1]))
    heads_cpu = forward_heads(cpu_model, bev)
    heads_gpu = forward_heads(gpu_model, bev.cuda())
    errs = {k: (heads_gpu[k].cpu() - heads_cpu[k]).abs().max().item() for k in heads_cpu}
    worst = max(errs.values())
    if not worst <= 1e-3:
        raise AssertionError(f"KFPN heads GPU vs CPU differ by {errs}")
    emit({"phase": "model", "bev": [1, H, W, 3], "max_abs_err": errs,
          "card": card["nvidia_smi"]})


def phase_serve(card):
    gpu_det = Detector(device="cuda", seed=SEED)
    cpu_det = Detector(device="cpu", seed=SEED)
    bump_heatmap_bias(gpu_det.model)
    bump_heatmap_bias(cpu_det.model)
    rng = np.random.default_rng(SEED + 2)
    scans = [make_scan(rng) for _ in range(16)]

    bev_raster_reduce.launches = 0  # count the main path's launches only
    bev_cell_counts.launches = 0
    server = BatchingDetectorServer(gpu_det, max_batch=8, max_delay_ms=20.0)
    replies = [None] * len(scans)
    t0 = time.perf_counter()
    try:
        server.warmup()
        t_traffic = time.perf_counter()

        def client(k):
            futs = [(i, server.submit(scans[i])) for i in range(k, len(scans), 4)]
            for i, fut in futs:
                replies[i] = fut.result(timeout=300)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a client thread did not finish")
        traffic_s = time.perf_counter() - t_traffic
    finally:
        server.stop()
    launches = bev_raster_reduce.launches
    count_launches = bev_cell_counts.launches
    stats = dict(server.stats)
    warm = len(server.buckets())
    if stats["served"] != len(scans) or any(r is None for r in replies):
        raise AssertionError(f"server answered {stats['served']} of {len(scans)} requests")
    if launches != stats["batches"] + warm or launches == 0:
        raise AssertionError(
            f"raster kernel launched {launches} times for {stats['batches']} batches + {warm} warmups"
        )

    n_dets, worst = [], 0.0
    for scan, got in zip(scans, replies):
        want = cpu_det.detect(scan)
        a, b = sorted_rows(got), sorted_rows(want)
        if len(a) != len(b):
            raise AssertionError(f"GPU reply has {len(a)} detections, CPU {len(b)}")
        if len(a):
            worst = max(worst, float(np.abs(a - b).max()))
        n_dets.append(len(a))
    if worst > 1e-3 or sum(n_dets) == 0:
        raise AssertionError(f"served detections vs CPU: max |diff| {worst}, counts {n_dets}")

    lat = {}
    for bucket in (1, 8):
        p = np.zeros((bucket, N, 4), np.float32)
        v = np.zeros((bucket, N), bool)
        for i in range(bucket):
            p[i], v[i] = bev_ops.filter_and_pad_points(scans[i])
        lat[bucket] = host_ms(lambda: gpu_det.detect_batch(p, v))

    # per-stage device time of one bucket-8 batch; the raster split into
    # its elementwise prelude and the reduce kernel
    pts_d, valid_d = torch.from_numpy(p).cuda(), torch.from_numpy(v).cuda()
    with torch.inference_mode():
        bev = bev_ops.points_to_bev_nchw(pts_d, valid_d)
        idx = bev_ops.cell_indices_and_keys(pts_d, valid_d)
        heads = {k: t.permute(0, 2, 3, 1) for k, t in gpu_det.model(bev).items()}
        stages = {
            "raster_ms": cuda_ms(lambda: bev_ops.points_to_bev_nchw(pts_d, valid_d)),
            "prelude_ms": cuda_ms(lambda: bev_ops.cell_indices_and_keys(pts_d, valid_d)),
            "reduce_ms": cuda_ms(lambda: bev_raster_reduce(*idx)),
            "reduce_device_ms": device_ms(lambda: bev_raster_reduce(*idx)),
            "model_ms": cuda_ms(lambda: gpu_det.model(bev)),
            "decode_ms": cuda_ms(lambda: _decode_heads(heads, 50, 0.2)),
        }
    emit({"phase": "serve", "requests": len(scans), "threads": 4, "stats": stats,
          "warmup_batches": warm, "raster_kernel_launches": launches,
          "count_kernel_launches": count_launches,
          "detections_per_reply": n_dets, "max_abs_err_vs_cpu": worst,
          "traffic_seconds": traffic_s, "serve_seconds_with_warmup": time.perf_counter() - t0,
          "batch_ms_bucket1": lat[1], "batch_ms_bucket8": lat[8],
          "frames_per_s_bucket8": 8 / (lat[8] / 1e3), "stages_bucket8": stages,
          "card": card["nvidia_smi"]})
    return scans, launches, count_launches


def phase_counts(card, scans):
    """The count map of the served scans through the public op, two batches
    of 8: cell_indices_and_keys -> bev_cell_counts. Held against the
    in-range points of each frame and the served raster's density."""
    dev = torch.device("cuda")
    inv_log64 = float(np.float32(1.0 / np.log(64.0)))
    batches = []
    for k in range(0, len(scans), B):
        padded = [bev_ops.filter_and_pad_points(s, N) for s in scans[k:k + B]]
        batches.append((torch.from_numpy(np.stack([q for q, _ in padded])).to(dev),
                        torch.from_numpy(np.stack([m for _, m in padded])).to(dev)))
    with torch.inference_mode():
        idx = [bev_ops.cell_indices_and_keys(q, m) for q, m in batches]
        rasters = [bev_ops.points_to_bev_nchw(q, m) for q, m in batches]
        bev_cell_counts.launches = 0  # count this path's launches only
        counts = [bev_cell_counts(row, col) for row, col, _ in idx]
        launches = bev_cell_counts.launches
    worst = 0.0
    for (row, _, _), c, r in zip(idx, counts, rasters):
        if not torch.equal(c.sum((1, 2)), (row >= 0).sum(1).float()):
            raise AssertionError("a frame's counts do not sum to its in-range points")
        density = torch.clamp_max(torch.log(torch.clamp_max(c, 63.0) + 1.0) * inv_log64, 1.0)
        worst = max(worst, (density - r[:, 2]).abs().max().item())
    if worst > DENSITY_TOL:
        raise AssertionError(f"count map vs served density: max |diff| {worst}")
    if launches != len(batches):
        raise AssertionError(f"count kernel launched {launches} times for {len(batches)} batches")
    emit({"phase": "counts", "frames": len(scans), "count_kernel_launches": launches,
          "density_max_abs_err_vs_raster": worst, "card": card["nvidia_smi"]})
    return launches


# ---------------------------------------------------------------------------
# the fusion path
# ---------------------------------------------------------------------------

LOOP_B = 8  # frames per batch in the fusion_kernels phase: the served bucket
LOOP_ENTRIES = {  # entry -> (design at the served shape, its kernel symbol, TPU-side function)
    "hard_nms_keep": ("suppression bitmask, one-warp scan", "hard_nms_keep_kernel",
                      "sfa3d_tpu/fusion/nms.py:33"),
    "soft_nms_gaussian": ("decay matrix, one-warp argmax chain", "soft_nms_matrix_kernel",
                          "sfa3d_tpu/fusion/nms.py:54"),
    "greedy_match": ("candidate keys, one-warp chain over candidate rows", "greedy_match_kernel",
                     "sfa3d_tpu/fusion/fuse.py:64"),
}
SOFT_BLOCK_KERNEL = "soft_nms_block_kernel"  # soft-NMS above soft_nms_matrix_slots
MATCH_BLOCK_KERNEL = "greedy_match_block_kernel"  # the match above greedy_match_matrix_rows
MATCH_KS_CAP = 256  # Ks of the inputs on either side of the match's design switch
NO_LIBRARY = ("none: no single PyTorch call computes it (torchvision is absent, and its "
              "NMS keeps other rules)")


def loop_boxes(rng, b, k, grid=False):
    """(b, k, 4) xywh boxes; `grid` puts them on a coarse grid (many
    overlaps and exactly tied IoUs)."""
    if grid:
        xy = rng.integers(0, 10, (b, k, 2)).astype(np.float32) * 12
    else:
        xy = rng.uniform(0, 600, (b, k, 2)).astype(np.float32)
    return np.concatenate([xy, rng.uniform(4, 120, (b, k, 2)).astype(np.float32)], -1)


def loop_inputs(rng, matrix_slots, match_rows):
    """The fusion_kernels phase's inputs: {name: (boxes, scores, valid)} for
    the two NMS entries and {name: (yolo, yolo_valid, sfa, sfa_valid,
    threshold)} for the match. The served shapes: 256 YOLO candidates (hard
    NMS), 114 fused slots (soft-NMS), 64 YOLO x 50 SFA boxes (the match).
    K = 1, 33 and 1024 test the hard-NMS words at their edges; K =
    matrix_slots and matrix_slots + 1 run the two soft-NMS designs on either
    side of the choice (K = 1024 runs the block design too); Ky = match_rows
    and match_rows + 1 at Ks = MATCH_KS_CAP do the same for the match."""
    def scored(k, grid=False):
        return (loop_boxes(rng, LOOP_B, k, grid), rng.uniform(0, 1, (LOOP_B, k)).astype(np.float32),
                rng.random((LOOP_B, k)) < 0.8)

    def class_offset(k):  # the YOLO NMS: class-offset boxes, scores sorted
        bx, sc, v = scored(k, grid=True)
        bx[..., :2] += rng.integers(0, 80, (LOOP_B, k, 1)).astype(np.float32) * 4096.0
        return bx, np.sort(sc, 1)[:, ::-1].copy(), v

    nms_cases = {"random": scored(114)}
    bx, sc, v = scored(114)
    v[[2, 5]] = False
    nms_cases["all_invalid_frames"] = (bx, sc, v)
    bx, sc, v = scored(114, grid=True)
    sc[:] = 0.5
    nms_cases["equal_scores"] = (bx, sc, v)
    bx, sc, v = scored(114, grid=True)
    bx[:, 1::2] = bx[:, ::2]  # duplicates: IoU exactly 1
    nms_cases["duplicates"] = (bx, sc, v)
    nms_cases["class_offset_256"] = class_offset(256)

    def matched(ky, ks, grid=False):
        yolo = loop_boxes(rng, LOOP_B, ky, grid)
        sfa = yolo[:, :ks] + rng.normal(0, 4, (LOOP_B, ks, 4)).astype(np.float32)
        return yolo, rng.random((LOOP_B, ky)) < 0.8, sfa, rng.random((LOOP_B, ks)) < 0.8, 0.5

    match_cases = {"served_64x50": matched(64, 50)}
    y, yv, sf, sv, thr = matched(64, 50)
    yv[3] = False
    sv[[3, 6]] = False
    match_cases["all_invalid_frames"] = (y, yv, sf, sv, thr)
    y, yv, sf, sv, thr = matched(64, 50, grid=True)
    sf[:, 1::2] = sf[:, ::2]  # tied IoUs: the lowest index wins
    match_cases["ties"] = (y, yv, sf, sv, thr)
    match_cases["wide_256x256"] = matched(256, 256, grid=True)
    # drawn last, so that the inputs above stay as they were before these
    nms_cases["k1"] = scored(1)
    nms_cases["k33_grid"] = scored(33, grid=True)
    nms_cases["class_offset_1024"] = class_offset(1024)
    nms_cases[f"matrix_limit_{matrix_slots}"] = scored(matrix_slots, grid=True)
    nms_cases[f"block_{matrix_slots + 1}"] = scored(matrix_slots + 1, grid=True)
    # soft-NMS's score keys: -0 ties +0, negative scores order below them
    bx, sc, v = scored(114, grid=True)
    sc[:4] = rng.choice(np.float32([0.0, 0.25, 0.5]), (4, 114))
    sc[4:] = rng.choice(np.float32([-0.5, -0.0, 0.0, 0.25, 0.5]), (LOOP_B - 4, 114))
    nms_cases["zero_and_signed_scores"] = (bx, sc, v)
    # each box overlaps the next (IoU 7/13) but not the one after: every
    # other box survives hard NMS, two slots of a word decided in one step
    x = np.arange(70, dtype=np.float32) * 3
    chain = np.stack([x, np.zeros(70), np.full(70, 10), np.full(70, 10)], -1).astype(np.float32)
    nms_cases["chain_70"] = (np.repeat(chain[None], LOOP_B, 0), np.repeat(
        np.linspace(1, 0.5, 70, dtype=np.float32)[None], LOOP_B, 0), np.ones((LOOP_B, 70), bool))
    # the match's chain walks only the rows with a candidate: every row has
    # one (grid boxes, each YOLO box half a pixel off an SFA box, 64 rows
    # for 50 boxes), a frame has none, or threshold 0 meets touching boxes
    sf = loop_boxes(rng, LOOP_B, 50, grid=True)
    y = np.ascontiguousarray(sf[:, np.arange(64) % 50]) + np.float32(0.5)
    match_cases["every_row_candidate_64x50"] = (y, np.ones((LOOP_B, 64), bool), sf,
                                                np.ones((LOOP_B, 50), bool), 0.5)
    y, yv, sf, sv, thr = matched(64, 50)
    sf[3, :, 0] += np.float32(5000.0)
    match_cases["no_candidate_frame"] = (y, yv, sf, sv, thr)
    y, yv, sf, sv, _ = matched(64, 50)
    sf[:, :25, 0] = y[:, :25, 0] + y[:, :25, 2]  # left edge on the YOLO box's right edge
    sf[:, :25, 1] = y[:, :25, 1]
    match_cases["touching_thr0"] = (y, yv, sf, sv, 0.0)
    for name, ky in ((f"matrix_limit_{match_rows}x{MATCH_KS_CAP}", match_rows),
                     (f"block_{match_rows + 1}x{MATCH_KS_CAP}", match_rows + 1)):
        sf = loop_boxes(rng, LOOP_B, MATCH_KS_CAP, grid=True)
        y = np.ascontiguousarray(sf[:, rng.integers(0, MATCH_KS_CAP, ky)])
        y += rng.normal(0, 4, (LOOP_B, ky, 4)).astype(np.float32)
        match_cases[name] = (y, rng.random((LOOP_B, ky)) < 0.8, sf, rng.random((LOOP_B, MATCH_KS_CAP)) < 0.8, 0.5)
    return nms_cases, match_cases


def loop_bound(bytes_moved, n_iou):
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = n_iou * IOU_FLOPS / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def max_abs_err(got, want) -> float:
    """Largest |difference| over the outputs of a loop entry and its plain
    version (masks and indices compare as integers)."""
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    return max(float((g.double() - w.double()).abs().max().item()) for g, w in pairs)


def sorted_candidates(boxes, scores, valid):
    """Boxes and valid flags in stable descending score order, as hard NMS
    takes them."""
    order = _stable_desc_order(scores, valid)
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous()
    return sboxes, torch.gather(valid, 1, order).contiguous()


def dependent_steps(valid) -> int:
    return int(valid.sum(1).max().item())


def match_rows_limit(dev) -> int:
    """greedy_match_matrix_rows at Ks = MATCH_KS_CAP on the card."""
    return fusion_loops.greedy_match_matrix_rows(MATCH_KS_CAP, shared_memory_limit(dev))


def phase_fusion_kernels(card):
    """Each loop entry vs its plain version on the card, bit for bit; times
    at the served shapes, and of both designs of soft-NMS and of the match
    where the wrapper switches. Returns the three kernel records (launches
    filled in later)."""
    dev = DEVICE
    smem = shared_memory_limit(dev)
    matrix_slots = fusion_loops.soft_nms_matrix_slots(smem)
    nms_cases, match_cases = loop_inputs(np.random.default_rng(SEED + 5), matrix_slots, match_rows_limit(dev))
    checks = {}
    for name, arrays in nms_cases.items():
        boxes, scores, valid = (torch.from_numpy(a).to(dev) for a in arrays)
        sboxes, svalid = sorted_candidates(boxes, scores, valid)
        keep = fusion_loops.hard_nms_keep(sboxes, svalid, 0.45)
        keep_plain = fusion_loops.hard_nms_keep_plain(sboxes, svalid, 0.45)
        out, surv = fusion_loops.soft_nms_gaussian(boxes, scores, valid)
        out_plain, surv_plain = fusion_loops.soft_nms_gaussian_plain(boxes, scores, valid)
        torch.cuda.synchronize()
        if not torch.equal(keep, keep_plain):
            raise AssertionError(f"hard_nms_keep disagrees with its plain version on {name}")
        if not torch.equal(surv, surv_plain):
            raise AssertionError(f"soft_nms_gaussian's mask disagrees with its plain version on {name}")
        if not torch.equal(out, out_plain):
            err = max_abs_err(out, out_plain)
            raise AssertionError(f"soft_nms_gaussian's scores differ from its plain version by {err} on {name}")
        if name == "all_invalid_frames" and (keep[[2, 5]].any() or surv[[2, 5]].any()):
            raise AssertionError("an all-invalid frame kept a box")
        k = boxes.shape[1]
        checks[name] = {"shape": list(boxes.shape[:2]), "kept": int(keep.sum().item()),
                        "suppressed": int((svalid & ~keep).sum().item()),
                        "soft_survivors": int(surv.sum().item()),
                        "soft_design": "decay matrix" if k <= matrix_slots else "block"}
    for name, (*arrays, thr) in match_cases.items():
        y, yv, sf, sv = (torch.from_numpy(a).to(dev) for a in arrays)
        idx_plain, m_plain = fusion_loops.greedy_match_plain(y, yv, sf, sv, thr)
        # the wrapper's design for the shape, then the block design on the same input
        for got in (fusion_loops.greedy_match(y, yv, sf, sv, thr), match_block_direct(y, yv, sf, sv, thr)):
            torch.cuda.synchronize()
            if not (torch.equal(got[0], idx_plain) and torch.equal(got[1], m_plain)):
                raise AssertionError(f"greedy_match disagrees with its plain version on {name}")
        ky, ks = yv.shape[1], sv.shape[1]
        checks[f"match_{name}"] = {
            "shape": [list(y.shape[:2]), list(sf.shape[:2])], "threshold": thr,
            "matches": int((idx_plain >= 0).sum().item()),
            "candidate_rows_per_frame": fusion_loops.greedy_match_candidate_rows(y, yv, sf, sv, thr).tolist(),
            "valid_rows_per_frame": yv.sum(1).tolist(),
            "design": "key matrix" if ky <= fusion_loops.greedy_match_matrix_rows(ks, smem) else "block"}
    if checks["match_served_64x50"]["matches"] == 0 or checks["class_offset_256"]["suppressed"] == 0:
        raise AssertionError("the served-shape inputs exercised nothing")
    if min(checks["match_every_row_candidate_64x50"]["candidate_rows_per_frame"]) != 64:
        raise AssertionError("the every-row-candidate input has a row with no candidate")
    if checks["match_no_candidate_frame"]["candidate_rows_per_frame"][3] != 0:
        raise AssertionError("the no-candidate frame has a candidate")
    if [c["design"] for n, c in checks.items() if n.startswith(("match_matrix_limit", "match_block_"))] != [
            "key matrix", "block"]:
        raise AssertionError("the match inputs beside the switch do not take both designs")
    if checks["class_offset_1024"]["suppressed"] == 0:
        raise AssertionError("the K = 1024 input suppressed nothing")
    if checks["chain_70"]["kept"] != LOOP_B * 35:
        raise AssertionError(f"the chain kept {checks['chain_70']['kept']} boxes, not every other one")
    emit({"phase": "fusion_kernels", "soft_nms_matrix_slots": matrix_slots, "checks": checks,
          "card": card["nvidia_smi"]})

    # times at the served shapes
    boxes, scores, valid = (torch.from_numpy(a).to(dev) for a in nms_cases["class_offset_256"])
    sboxes, svalid = sorted_candidates(boxes, scores, valid)
    wboxes, wvalid = sorted_candidates(*(torch.from_numpy(a).to(dev)
                                         for a in nms_cases["class_offset_1024"]))
    fboxes, fscores, fvalid = (torch.from_numpy(a).to(dev) for a in nms_cases["random"])
    y, yv, sf, sv = (torch.from_numpy(a).to(dev) for a in match_cases["served_64x50"][:4])
    keep = fusion_loops.hard_nms_keep_plain(sboxes, svalid, 0.45)
    kept_before = torch.cumsum(keep.int(), 1) - keep.int()
    calls = {
        # (call, plain call, bytes in + out, IoUs the data needs, steps)
        "hard_nms_keep": (
            lambda: fusion_loops.hard_nms_keep(sboxes, svalid, 0.45),
            lambda: fusion_loops.hard_nms_keep_plain(sboxes, svalid, 0.45),
            sboxes.numel() * 4 + 2 * svalid.numel(),
            int((kept_before * svalid).sum().item()), dependent_steps(svalid)),
        "soft_nms_gaussian": (
            lambda: fusion_loops.soft_nms_gaussian(fboxes, fscores, fvalid),
            lambda: fusion_loops.soft_nms_gaussian_plain(fboxes, fscores, fvalid),
            fboxes.numel() * 4 + fscores.numel() * 4 * 2 + 2 * fvalid.numel(),
            int((fvalid.sum(1) * (fvalid.sum(1) - 1) // 2).sum().item()), dependent_steps(fvalid)),
        "greedy_match": (  # the chain: the candidate rows of a frame
            lambda: fusion_loops.greedy_match(y, yv, sf, sv, 0.5),
            lambda: fusion_loops.greedy_match_plain(y, yv, sf, sv, 0.5),
            (y.numel() + sf.numel()) * 4 + yv.numel() * 5 + sv.numel() * 2,
            int((yv.sum(1) * sv.sum(1)).sum().item()),
            int(fusion_loops.greedy_match_candidate_rows(y, yv, sf, sv, 0.5).max().item())),
    }
    recs = []
    for entry, (call, plain, bytes_moved, n_iou, steps) in calls.items():
        design, symbol, replaces = LOOP_ENTRIES[entry]
        bound_ms, bound_by = loop_bound(bytes_moved, n_iou)
        dms = device_ms(call, kernel=symbol)
        if dms is None:
            raise AssertionError(f"the profiler saw no {symbol} launch for {entry}")
        rec = {
            "name": entry, "route": "cuda", "source": "sfa3d_tpu_torch/csrc/fusion_loops.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max_abs_err(call(), plain()),
            "ms": cuda_ms(call), "device_ms": dms, "plain_ms": cuda_ms(plain, reps=5, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library": NO_LIBRARY, "bound_share_device": bound_ms / dms,
            "design": design, "per_step_us": dms * 1e3 / steps,
            "shape": list(sboxes.shape[:2]) if entry == "hard_nms_keep" else
            list(fboxes.shape[:2]) if entry == "soft_nms_gaussian" else [[LOOP_B, 64], [LOOP_B, 50]],
            "dependent_steps": steps, "ious_needed": n_iou, "bytes": bytes_moved,
        }
        if entry == "hard_nms_keep":
            rec["device_ms_k1024"] = device_ms(
                lambda: fusion_loops.hard_nms_keep(wboxes, wvalid, 0.45), kernel=symbol)
        if entry == "soft_nms_gaussian":
            # the block design at the served shape, where the decay matrix replaced it
            block = lambda: soft_nms_block_direct(fboxes, fscores, fvalid)  # noqa: E731
            if max_abs_err(block(), plain()) != 0:
                raise AssertionError("soft_nms_block_kernel at the served shape differs from the plain version")
            rec["replaced_design_device_ms"] = device_ms(block, kernel=SOFT_BLOCK_KERNEL)
            if rec["replaced_design_device_ms"] is None:
                raise AssertionError(f"the profiler saw no {SOFT_BLOCK_KERNEL} launch")
            rec["designs_at_the_switch"] = soft_nms_switch_times(nms_cases, matrix_slots)
        if entry == "greedy_match":
            # the block design at the served shape, where the key matrix replaced it
            block = lambda: match_block_direct(y, yv, sf, sv, 0.5)  # noqa: E731
            if max_abs_err(block(), plain()) != 0:
                raise AssertionError("greedy_match_block_kernel at the served shape differs from the plain version")
            rec["replaced_design_device_ms"] = device_ms(block, kernel=MATCH_BLOCK_KERNEL)
            if rec["replaced_design_device_ms"] is None:
                raise AssertionError(f"the profiler saw no {MATCH_BLOCK_KERNEL} launch")
            rec["valid_rows"] = dependent_steps(yv)
            rec["designs_at_the_switch"] = match_switch_times(match_cases)
        recs.append(rec)
        emit({"phase": "fusion_kernel_time", **{k: v for k, v in rec.items()
                                                 if k not in ("route", "source", "launches")},
              "card": card["nvidia_smi"]})
    return recs


def soft_nms_block_direct(boxes, scores, valid, sigma=0.5, score_thresh=0.001):
    """soft_nms_block_kernel at any K, past the wrapper's choice by K, to
    time it where the wrapper takes the matrix design. Counts no launch.
    Returns (scores, surviving mask)."""
    b, k = valid.shape
    lib, dev = fusion_loops._cuda_launch_setup("soft_nms_gaussian", k, (boxes, scores, valid))
    out, surv = scores.new_empty((b, k)), valid.new_empty((b, k))
    err = lib.soft_nms_gaussian_block_cuda(
        boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), out.data_ptr(), surv.data_ptr(),
        b, k, fusion_loops.inv_sigma(sigma), score_thresh, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"soft_nms_block_kernel launch failed: cudaError {err}")
    return out, surv


def match_block_direct(yolo, yolo_valid, sfa, sfa_valid, thr):
    """greedy_match_block_kernel at any shape, past the wrapper's choice, to
    check and time it where the wrapper takes the key matrix. Counts no
    launch. Returns (match_idx, sfa_matched)."""
    b, ky = yolo_valid.shape
    ks = sfa_valid.shape[1]
    lib, dev = fusion_loops._cuda_launch_setup("greedy_match", max(ky, ks), (yolo, yolo_valid, sfa, sfa_valid))
    idx, matched = yolo_valid.new_empty((b, ky), dtype=torch.int32), sfa_valid.new_empty((b, ks))
    err = lib.greedy_match_block_cuda(
        yolo.data_ptr(), yolo_valid.data_ptr(), sfa.data_ptr(), sfa_valid.data_ptr(), idx.data_ptr(),
        matched.data_ptr(), b, ky, ks, thr, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"greedy_match_block_kernel launch failed: cudaError {err}")
    return idx, matched


def match_switch_times(match_cases):
    """Device time of the match's two designs on either side of the Ky where
    the wrapper switches (Ks = MATCH_KS_CAP), and of the key matrix where
    every row is a candidate; fails unless each ran its own design."""
    out = {}
    for name, arrays in match_cases.items():
        if not name.startswith(("matrix_limit", "block_", "every_row")):
            continue
        symbol = MATCH_BLOCK_KERNEL if name.startswith("block_") else LOOP_ENTRIES["greedy_match"][1]
        y, yv, sf, sv = (torch.from_numpy(a).to(DEVICE) for a in arrays[:4])
        dms = device_ms(lambda: fusion_loops.greedy_match(y, yv, sf, sv, arrays[4]), kernel=symbol)
        if dms is None:
            raise AssertionError(f"greedy_match at {tuple(yv.shape)} x {sv.shape[1]} launched no {symbol}")
        steps = int(fusion_loops.greedy_match_candidate_rows(y, yv, sf, sv, arrays[4]).max().item())
        out[name] = {"kernel": symbol, "shape": [list(yv.shape), list(sv.shape)], "device_ms": dms,
                     "candidate_rows": steps, "valid_rows": dependent_steps(yv)}
    return out


def soft_nms_switch_times(nms_cases, matrix_slots):
    """Device time of the two soft-NMS designs on either side of the K where
    the wrapper switches; fails unless each K ran its own design's kernel."""
    out = {}
    for name, symbol in ((f"matrix_limit_{matrix_slots}", LOOP_ENTRIES["soft_nms_gaussian"][1]),
                         (f"block_{matrix_slots + 1}", SOFT_BLOCK_KERNEL)):
        boxes, scores, valid = (torch.from_numpy(a).to(DEVICE) for a in nms_cases[name])
        dms = device_ms(lambda: fusion_loops.soft_nms_gaussian(boxes, scores, valid), kernel=symbol)
        if dms is None:
            raise AssertionError(f"soft_nms_gaussian at K = {boxes.shape[1]} launched no {symbol}")
        out[name] = {"kernel": symbol, "shape": list(boxes.shape[:2]), "device_ms": dms,
                     "per_step_us": dms * 1e3 / dependent_steps(valid)}
    return out


def phase_yolo(card):
    cpu_model = YOLOv8("n").init_weights(torch.Generator().manual_seed(SEED + 1)).eval()
    gpu_model = copy.deepcopy(cpu_model).to(DEVICE)
    image = np.random.default_rng(SEED + 3).integers(0, 256, (*IMG_HW, 3)).astype(np.uint8)
    img = torch.from_numpy(letterbox(image, CANVAS)[0][None])
    with torch.inference_mode():
        cpu = forward_levels(cpu_model, img)
        gpu = forward_levels(gpu_model, img.to(DEVICE))
    errs = [[(g.cpu() - c).abs().max().item() for g, c in zip(gl, cl)] for gl, cl in zip(gpu, cpu)]
    worst = max(max(e) for e in errs)
    if not worst <= NET_TOL:
        raise AssertionError(f"YOLOv8n heads GPU vs CPU differ by {errs}")
    emit({"phase": "yolo", "canvas": [1, *CANVAS, 3], "levels": [list(l[0].shape) for l in gpu],
          "max_abs_err_box_cls_per_level": errs,
          "max_abs_out_box_cls_per_level": [[t.abs().max().item() for t in lv] for lv in cpu],
          "card": card["nvidia_smi"]})


YOLO_GATE_TOP = 150  # YOLO anchors of the reference frame above the 0.25 gate
SFA_HEIGHT_BUMP = 38.5  # m added to the KFPN's height bias: 3D boxes about 40 m high
SFA_Z_BUMP = -17.3  # m added to its z bias: their bottoms about 20 m below the sensor
YOLO_REACH = {1: 8, 3: 15}  # DFL side (1 top, 3 bottom) -> the bin, in strides, that takes its mass
YOLO_REACH_BUMP = 8.0  # added to that bin's logit
MIN_FUSED_PER_FRAME = 1  # fused (source 2) rows the 16 replies must hold, per frame


def yolo_gate_bias(yolo: torch.nn.Module, image: np.ndarray, canvas=CANVAS) -> float:
    """The class-conv bias that puts the YOLO_GATE_TOP-th best anchor of
    `image` letterboxed onto `canvas` just above the 0.25 gate, once the
    class logits are spread by x1000 (see bump_fused_biases)."""
    probe = copy.deepcopy(yolo).cpu()
    with torch.no_grad():
        for i in range(3):
            probe.model[22].cv3[i][2].weight *= 1000.0
            probe.model[22].cv3[i][2].bias.zero_()
        levels = forward_levels(probe, torch.from_numpy(letterbox(image, canvas)[0][None]))
    best = torch.cat([c.reshape(-1, c.shape[-1]) for _, c in levels]).amax(-1).double()
    top = torch.topk(best, YOLO_GATE_TOP + 1).values
    return float(np.log(0.25 / 0.75) - (top[-2] + top[-1]).item() / 2)


def bump_fused_biases(fd, gate_bias: float, tall_boxes: bool = True) -> None:
    """Random weights that give the fusion stages work: heatmap peaks above
    the threshold, and YOLO boxes of about four strides across (DFL mass on
    bin 2). The YOLO class logits are spread (x1000 on the last class conv,
    bias `gate_bias`) so that some tens of boxes a frame pass the 0.25 gate
    with confidences well apart: random features alone give thousands of
    nearly equal confidences, whose order float32 noise decides.

    Random networks place the two sides' boxes independently, so a pair
    rarely overlaps by the 0.7 IoU the match needs. So the 3D boxes, about
    1.5 m wide and long, are made 40 m high with their bottoms 20 m below
    the sensor: each projects across the whole image height at every range
    of the raster. The YOLO boxes (stride 8, where the gated ones lie) reach
    8 strides up and 15 down: many cover most of the image height, and none
    spans all of it, since two boxes clipped to the same edges give fused
    means of equal integers, which a one-ulp difference in a confidence
    truncates a pixel apart. Such pairs overlap mostly by their x-intervals,
    and a fair share pass 0.7. With tall_boxes=False the 3D boxes keep
    KITTI's sizes (about 1.5 m each way, z near the sensor's)."""
    bump_heatmap_bias(fd.kfpn)
    with torch.no_grad():
        for i in range(3):
            getattr(fd.kfpn, f"fpn{i}_dim")[2].bias += 1.5
            if tall_boxes:
                getattr(fd.kfpn, f"fpn{i}_dim")[2].bias[0] += SFA_HEIGHT_BUMP
                getattr(fd.kfpn, f"fpn{i}_z_coor")[2].bias += SFA_Z_BUMP
            dfl = fd.yolo.model[22].cv2[i][2].bias.view(4, 16)
            dfl[:, 2] += 4.0
            for side, reach in YOLO_REACH.items():
                dfl[side, reach] += YOLO_REACH_BUMP
            fd.yolo.model[22].cv3[i][2].weight *= 1000.0
            fd.yolo.model[22].cv3[i][2].bias.fill_(gate_bias)


def fused_requests(n):
    rng = np.random.default_rng(SEED + 4)
    calib = KittiCalibration(None)
    return [(make_scan(rng), rng.integers(0, 256, (*IMG_HW, 3)).astype(np.uint8), calib)
            for _ in range(n)]


def reply_rows(reply) -> np.ndarray:
    """A fused reply as rows [x, y, w, h, class, source, score], sorted: the
    order of the slots follows confidences that the two devices may rank
    differently where they are nearly tied, so replies compare as sets."""
    rows = np.concatenate([reply["boxes"].astype(np.float64),
                           reply["classes"][:, None].astype(np.float64),
                           reply["source"][:, None].astype(np.float64),
                           reply["scores"][:, None].astype(np.float64)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def replies_equal(a, b) -> bool:
    ra, rb = reply_rows(a), reply_rows(b)
    if ra.shape != rb.shape or not np.array_equal(ra[:, :6], rb[:, :6]):
        return False
    return bool(np.abs(ra[:, 6] - rb[:, 6]).max(initial=0.0) <= SCORE_TOL)


def reply_difference(a, b):
    """What differs between two fused replies (for the failure message)."""
    ra, rb = reply_rows(a), reply_rows(b)
    out = {"rows": [len(ra), len(rb)], "boxes_3d": [len(a["boxes_3d"]), len(b["boxes_3d"])]}
    if ra.shape == rb.shape:
        off = np.flatnonzero((ra[:, :6] != rb[:, :6]).any(1) | (np.abs(ra[:, 6] - rb[:, 6]) > SCORE_TOL))
        out["differing"] = off[:5].tolist()
        out["gpu"] = ra[off[:5]].tolist()
        out["cpu"] = rb[off[:5]].tolist()
    return out


def _on_host(out):
    """A network's output (KFPN: dict of heads; YOLO: list of (box, cls)
    levels), copied to the host."""
    if isinstance(out, dict):
        return {k: v.cpu() for k, v in out.items()}
    return [tuple(t.cpu() for t in level) for level in out]


def _row(out, r: int):
    if isinstance(out, dict):
        return {k: v[r:r + 1] for k, v in out.items()}
    return [tuple(t[r:r + 1] for t in level) for level in out]


def _leaves(out):
    return list(out.values()) if isinstance(out, dict) else [t for level in out for t in level]


def record_networks(fd, calls):
    """Forward hooks that append (input, output) of every call of fd's two
    networks to calls["kfpn"] / calls["yolo"], on the host."""
    def hook(name):
        def fn(module, args, out):
            calls[name].append((args[0].cpu(), _on_host(out)))
        return fn
    return [fd.kfpn.register_forward_hook(hook("kfpn")), fd.yolo.register_forward_hook(hook("yolo"))]


def served_networks(calls, image: np.ndarray):
    """The two networks' outputs for one served frame, found by its
    letterboxed image among the recorded batches (the KFPN and YOLO calls
    of one batch pair up in order)."""
    want = torch.from_numpy(image).permute(2, 0, 1)
    for (yin, yout), (_, kout) in zip(calls["yolo"], calls["kfpn"]):
        for r in range(yin.shape[0]):
            if torch.equal(yin[r], want):
                return {"kfpn": _row(kout, r), "yolo": _row(yout, r)}
    raise AssertionError("a served frame is missing from the recorded batches")


def replay_networks(fd, given, errs):
    """Forward hooks that make fd's networks return the `given` outputs in
    place of their own, and append max |own - given| to errs."""
    def hook(name):
        def fn(module, args, own):
            errs.append(max((a - b).abs().max().item()
                            for a, b in zip(_leaves(own), _leaves(given[name]))))
            return given[name]
        return fn
    return [fd.kfpn.register_forward_hook(hook("kfpn")), fd.yolo.register_forward_hook(hook("yolo"))]


def phase_fused_serve(card):
    gpu_fd = FusedDetector(imgsz=CANVAS, device=DEVICE, seed=SEED)
    cpu_fd = FusedDetector(imgsz=CANVAS, device="cpu", seed=SEED)
    reqs = fused_requests(16)
    gate_bias = yolo_gate_bias(cpu_fd.yolo, reqs[0][1])
    bump_fused_biases(gpu_fd, gate_bias)
    bump_fused_biases(cpu_fd, gate_bias)

    counted = [bev_raster_reduce, bev_cell_counts, fusion_loops.hard_nms_keep,
               fusion_loops.soft_nms_gaussian, fusion_loops.greedy_match]
    for fn in counted:  # count this path's launches only
        fn.launches = 0
    server = BatchingFusedServer(gpu_fd, max_batch=8, max_delay_ms=20.0)
    replies = [None] * len(reqs)
    calls = {"kfpn": [], "yolo": []}
    hooks = []
    t0 = time.perf_counter()
    try:
        server.warmup()
        hooks = record_networks(gpu_fd, calls)
        t_traffic = time.perf_counter()

        def client(k):
            futs = [(i, server.submit_fused(*reqs[i])) for i in range(k, len(reqs), 4)]
            for i, fut in futs:
                replies[i] = fut.result(timeout=300)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a client thread did not finish")
        traffic_s = time.perf_counter() - t_traffic
    finally:
        server.stop()
        for h in hooks:
            h.remove()
    launches = {fn.__name__: fn.launches for fn in counted}
    stats = dict(server.stats)
    warm = len(server.buckets())
    if stats["served"] != len(reqs) or any(r is None for r in replies):
        raise AssertionError(f"server answered {stats['served']} of {len(reqs)} requests")
    for name in ("bev_raster_reduce", "hard_nms_keep", "soft_nms_gaussian", "greedy_match"):
        if launches[name] != stats["batches"] + warm:
            raise AssertionError(
                f"{name} launched {launches[name]} times for {stats['batches']} batches + {warm} warmups")

    # Every served reply equals the CPU path's on the same request, given the
    # served networks' outputs for that frame; the CPU networks' own outputs
    # must lie within NET_TOL of those. Fused boxes are truncated means of two
    # integer boxes weighted by their confidences: where the pair shares a
    # coordinate, a difference of one float32 ulp in a confidence moves the
    # mean to either side of that integer, so the path after the networks is
    # held exact on equal inputs. `all_cpu` counts the replies that the CPU
    # path also gives from its own networks.
    # The replay records each frame's match: its candidate rows (the chain's
    # length on the card) and valid YOLO rows, from the same inputs.
    per_reply, net_errs, all_cpu, match_rows = [], [], 0, []
    plain_match = fusion_loops.greedy_match_plain

    def recorded_match(yolo, yolo_valid, sfa, sfa_valid, thr):
        match_rows.append([fusion_loops.greedy_match_candidate_rows(yolo, yolo_valid, sfa, sfa_valid, thr).tolist(),
                           yolo_valid.sum(1).tolist()])
        return plain_match(yolo, yolo_valid, sfa, sfa_valid, thr)

    for i, (req, got) in enumerate(zip(reqs, replies)):
        hooks = replay_networks(cpu_fd, served_networks(calls, letterbox(req[1], CANVAS)[0]), net_errs)
        fusion_loops.greedy_match_plain = recorded_match
        try:
            want = cpu_fd.detect(*req)
        finally:
            fusion_loops.greedy_match_plain = plain_match
            for h in hooks:
                h.remove()
        if not replies_equal(got, want):
            raise AssertionError(f"fused reply {i} differs between the GPU server and the CPU path: "
                                 + json.dumps(reply_difference(got, want)))
        all_cpu += replies_equal(got, cpu_fd.detect(*req))
        per_reply.append(np.bincount(got["source"], minlength=3).tolist())
    if not max(net_errs) <= NET_TOL:
        raise AssertionError(f"the served networks' outputs differ from the CPU's by {max(net_errs)}")
    sources = np.sum(per_reply, axis=0)
    if not (sources[0] and sources[1] and sources[2] >= MIN_FUSED_PER_FRAME * len(reqs)):
        raise AssertionError(f"vacuous fused replies: rows by source {sources.tolist()}")

    # per-batch wall time at buckets 1 and 8, and the stage split at 8
    prepared = []
    for points, image, calib in reqs[:8]:
        pts, valid = bev_ops.filter_and_pad_points(points, N)
        img, r, pad = letterbox(image, CANVAS)
        prepared.append((pts, valid, img, calib.V2C.astype(np.float32), calib.R0.astype(np.float32),
                         calib.P2.astype(np.float32), np.float32(IMG_HW), np.float32(r), np.float32(pad)))
    batch8 = [np.stack(a) for a in zip(*prepared)]
    lat = {b: host_ms(lambda: gpu_fd.run_batch(*[a[:b] for a in batch8])) for b in (1, 8)}
    dev = DEVICE
    pts, valid, images, V2C, R0, P2, hw, scale, pad = (torch.from_numpy(a).to(dev) for a in batch8)
    kfpn, yolo = gpu_fd.kfpn, gpu_fd.yolo
    with torch.inference_mode():
        bev = bev_ops.points_to_bev_nchw(pts, valid)
        heads = _heads_nhwc(kfpn, bev)
        _, boxes_bev, boxes_real, mask = _decode_heads(heads, 50, 0.2)
        sfa_scores = boxes_bev[..., 1]
        levels = forward_levels(yolo, images)
        yb_all, ys_all = decode_predictions(levels)
        yb, ys, yc, yv = select_detections(yb_all, ys_all, 0.25, 0.45, 64)
        ybox = _unletterbox_xywh(yb, scale, pad, hw)

        def project():
            return project_boxes_to_image(boxes_real, sfa_scores, mask, V2C, R0, P2,
                                          img_h=hw[:, 0], img_w=hw[:, 1], conf_gate=0.2)

        sfa2d, sfa_valid = project()
        sfa_cls = boxes_real[..., 0].to(torch.int32)
        fuse_kw = dict(mode="bayesian", confidence_threshold=0.25, fusion_iou_threshold=0.7,
                       nms_threshold=0.5, use_gaussian_nms=True, gaussian_sigma=0.5)
        stages = {
            "raster_ms": cuda_ms(lambda: bev_ops.points_to_bev_nchw(pts, valid)),
            "kfpn_ms": cuda_ms(lambda: kfpn(bev)),
            "decode_post_ms": cuda_ms(lambda: _decode_heads(heads, 50, 0.2)),
            "projection_ms": cuda_ms(project),
            "yolo_ms": cuda_ms(lambda: yolo(images.permute(0, 3, 1, 2))),
            "yolo_decode_ms": cuda_ms(lambda: decode_predictions(levels)),
            "select_detections_ms": cuda_ms(lambda: select_detections(yb_all, ys_all, 0.25, 0.45, 64)),
            "unletterbox_ms": cuda_ms(lambda: _unletterbox_xywh(yb, scale, pad, hw)),
            "fusion_soft_nms_ms": cuda_ms(lambda: _fuse_one(ybox, ys, yc, yv, sfa2d, sfa_scores,
                                                            sfa_cls, sfa_valid, **fuse_kw)),
        }
    emit({"phase": "fused_serve", "requests": len(reqs), "threads": 4, "canvas": list(CANVAS),
          "image": list(IMG_HW), "stats": stats, "warmup_batches": warm, "launches": launches,
          "yolo_gate_bias": gate_bias, "rows_by_source": sources.tolist(),
          "replies_equal_to_cpu_given_served_networks": len(reqs),
          "replies_equal_to_all_cpu_path": all_cpu, "network_max_abs_err": max(net_errs),
          "rows_by_source_per_reply": per_reply,
          "match_candidate_rows_per_frame": [c for rec in match_rows for c in rec[0]],
          "match_valid_yolo_rows_per_frame": [v for rec in match_rows for v in rec[1]],
          "traffic_seconds": traffic_s, "serve_seconds_with_warmup": time.perf_counter() - t0,
          "batch_ms_bucket1": lat[1], "batch_ms_bucket8": lat[8],
          "frames_per_s_bucket8": 8 / (lat[8] / 1e3), "stages_bucket8": stages,
          "card": card["nvidia_smi"]})
    return launches


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

TRAIN_PARITY_BEV = (128, 128)  # GPU vs CPU step: raster, and heatmap 32 x 32
TRAIN_FRAMES = 64  # the synthetic mini-KITTI: one batch of S x B = 4 x 16 an epoch
TRAIN_VAL_FRAMES = 40  # its val split: batches of 16, 16 and a tail of 8
TRAIN_DEFAULTS = (16, 4, "bfloat16")  # the CLI's batch_size, effective_batch // batch_size, compute_dtype
TRAIN_LOSS_RTOL = 1e-5  # loss terms GPU vs CPU, one strict-fp32 step
TRAIN_STAT_RTOL = 1e-4  # BatchNorm statistics, of each tensor's largest
TRAIN_PARAM_SHARE = 1e-2  # parameters, of the step's largest parameter change
TRAIN_GRAD_FLOOR = 1e-3  # Adam: elements whose |grad| is under this share of their tensor's largest are excused
TARGET_RTOL = 1e-6  # float training targets GPU vs CPU, of each tensor's largest (exp, sin, cos: libm ulps)


def _check_targets(got, want):
    """Training targets of the card against the CPU route's: indices and
    masks bit-exact, floats within TARGET_RTOL of each tensor's largest;
    returns the largest float error by key."""
    errs = {}
    for k, v in want.items():
        g = got[k].cpu()
        if k in ("indices_center", "obj_mask"):
            if not torch.equal(g, v):
                raise AssertionError(f"training target {k} differs between the card and the CPU")
            continue
        errs[k] = (g - v).abs().max().item()
        if errs[k] > TARGET_RTOL * max(v.abs().max().item(), 1e-30):
            raise AssertionError(f"training target {k} differs between the card and the CPU by {errs[k]}")
    return errs


def _train_batch_from_scenes(seeds, dev, bev_size, hm_size, s):
    """S x B synthetic scenes through prepare_train_batch on `dev`."""
    from sfa3d_tpu_torch.data.loader import prepare_train_batch
    from sfa3d_tpu_torch.data.synthetic import synthetic_scene

    pts = np.zeros((len(seeds), N, 4), np.float32)
    valid = np.zeros((len(seeds), N), bool)
    labels = np.zeros((len(seeds), 50, 8), np.float32)
    n_lab = np.zeros(len(seeds), np.int32)
    for i, sd in enumerate(seeds):
        scan, lab = synthetic_scene(sd)
        pts[i], valid[i] = bev_ops.filter_and_pad_points(scan, N)
        labels[i, :len(lab)], n_lab[i] = lab, len(lab)
    hflip = np.arange(len(seeds)) % 2 == 1
    bev, tg = prepare_train_batch(*(torch.from_numpy(a).to(dev) for a in (pts, valid, labels, n_lab, hflip)),
                                  bev_size=bev_size, hm_size=hm_size)
    b = len(seeds) // s
    return {"bev": bev.reshape(s, b, *bev.shape[1:]), "targets": {k: v.reshape(s, b, *v.shape[1:]) for k, v in tg.items()}}


def _train_model(init_sd, arch="fpn_resnet_18"):
    """The `arch` model (KFPN-18 by default) with the weights `init_sd` (one
    init_weights draw, which takes seconds on the host, shared by the train
    phase's models)."""
    model = create_model(arch)
    model.load_state_dict(init_sd)
    return model


def _train_step_parity(optimizer_type, init_sd, arch="fpn_resnet_18"):
    """One accumulated step (S = 2, B = 2, 128 x 128 raster) of the same
    `arch` model and batch on the card and on the CPU, strict fp32; returns
    the measured differences or raises."""
    from sfa3d_tpu_torch.config.train import OptimConfig
    from sfa3d_tpu_torch.parallel import create_train_state, make_train_step
    from sfa3d_tpu_torch.runtime.schedules import create_optimizer

    lr = 1e-2 if optimizer_type == "sgd" else 1e-3
    spec = create_optimizer(OptimConfig(optimizer_type=optimizer_type, lr=lr), num_epochs=10, steps_per_epoch=1)
    hm = (TRAIN_PARITY_BEV[0] // 4, TRAIN_PARITY_BEV[1] // 4)
    cpu_batch = _train_batch_from_scenes(range(40, 44), torch.device("cpu"), TRAIN_PARITY_BEV, hm, 2)
    gpu_batch = _train_batch_from_scenes(range(40, 44), DEVICE, TRAIN_PARITY_BEV, hm, 2)
    _check_targets(gpu_batch["targets"], cpu_batch["targets"])
    raster_errors(gpu_batch["bev"].flatten(0, 1).cpu(), cpu_batch["bev"].flatten(0, 1))
    cpu_model = _train_model(init_sd, arch)
    gpu_model = _train_model(init_sd, arch).to(DEVICE)
    start = {k: v.detach().clone() for k, v in cpu_model.state_dict().items()}
    out = {}
    for name, model, batch, dev in (("cpu", cpu_model, cpu_batch, "cpu"), ("gpu", gpu_model, gpu_batch, DEVICE)):
        state = create_train_state(model, spec)
        _, stats = make_train_step(model, spec, device=dev)(state, batch)
        out[name] = ({k: float(v) for k, v in stats.items()},
                     {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     {k: p.grad.detach().cpu() for k, p in model.named_parameters()})
    (cs, csd, cgrad), (gs, gsd, _) = out["cpu"], out["gpu"]
    loss_err = max(abs(gs[k] - cs[k]) / abs(cs[k]) for k in cs)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{optimizer_type} step: loss GPU vs CPU differs by {loss_err} relative")
    names = set(cgrad)
    largest_change = max((csd[k] - start[k]).abs().max().item() for k in names)
    param_err, stat_err, excused = 0.0, 0.0, 0
    for k, want in csd.items():
        if k.endswith("num_batches_tracked"):
            if not torch.equal(gsd[k], want):
                raise AssertionError(f"{k} differs")
            continue
        diff = (gsd[k] - want).abs()
        if k in names:
            bad = diff > TRAIN_PARAM_SHARE * largest_change
            if optimizer_type == "adam":
                noise = cgrad[k].abs() <= TRAIN_GRAD_FLOOR * cgrad[k].abs().max()
                excused += int((bad & noise).sum())
                bad &= ~noise
            if bad.any():
                raise AssertionError(f"{optimizer_type} step: parameter {k} GPU vs CPU differs by "
                                     f"{diff.max().item()} (largest change {largest_change})")
            param_err = max(param_err, diff.max().item() / largest_change)
        else:
            rel = diff.max().item() / max(want.abs().max().item(), 1e-30)
            if rel > TRAIN_STAT_RTOL:
                raise AssertionError(f"{optimizer_type} step: BatchNorm statistic {k} differs by {rel} relative")
            stat_err = max(stat_err, rel)
    return {"loss_max_rel_err": loss_err, "param_max_err_share_of_largest_change": param_err,
            "largest_change": largest_change, "bn_stat_max_rel_err": stat_err,
            "adam_elements_excused_near_zero_grad": excused if optimizer_type == "adam" else None,
            "total_loss": cs["total_loss"]}


def _epoch_batches(loader, epochs, first_epoch=1):
    """Every batch of `epochs` whole epochs (the threaded loader collates
    each epoch's batches ahead; whole epochs keep the launch count exact)."""
    for epoch in range(first_epoch, first_epoch + epochs):
        loader.set_epoch(epoch)
        yield from loader


def _timed_steps(step, state, batches):
    """Run the steps; CUDA-event ms of each, losses, the host ms spent
    waiting on the loader, and the wall ms of each step from the end of the
    one before (loader wait included)."""
    ms, losses, wait, wall = [], [], [], []
    t = time.perf_counter()
    for batch in batches:
        wait.append((time.perf_counter() - t) * 1e3)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t_step = time.perf_counter()
        start.record()
        state, stats = step(state, batch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(stats["total_loss"]))
        t = time.perf_counter()
        wall.append(wait[-1] + (t - t_step) * 1e3)
    return state, ms, losses, wait, wall


def _prepare_checks(loader):
    """The device preparation of one collated batch (S x B = 64 frames, the
    training path's shape, flipped where the dataset drew hflip), held
    against its plain versions and then timed with CUDA events. The raster
    kernel must equal bev_raster_reduce_plain on the card, and the card's
    prepare_train_batch (raster, flip, targets) the CPU route on the same
    frames. Its launches come after the path's count was read."""
    from sfa3d_tpu_torch.data.loader import prepare_train_batch
    from sfa3d_tpu_torch.ops.targets import build_targets

    samples = [loader.dataset[i] for i in range(loader.batch_size * loader.subdivisions)]
    host = [np.stack([x.points for x in samples]), np.stack([x.valid for x in samples]),
            np.stack([x.labels for x in samples]), np.int32([x.n_labels for x in samples]),
            np.asarray([bool(getattr(x, "hflipped", False)) for x in samples])]
    if not 0 < host[4].sum() < len(samples):
        raise AssertionError(f"{host[4].sum()} of {len(samples)} frames flipped: the flip goes unchecked")
    pts, valid, labels, n_lab, hflip = (torch.from_numpy(a).to(DEVICE) for a in host)
    kernel_err = raster_errors(bev_ops.points_to_bev_nchw(pts, valid).cpu(),
                               bev_raster_reduce_plain(*bev_ops.cell_indices_and_keys(pts, valid)).cpu())
    bev, targets = prepare_train_batch(pts, valid, labels, n_lab, hflip)
    want_bev, want_targets = prepare_train_batch(*(torch.from_numpy(a) for a in host))
    route_err = raster_errors(bev.cpu(), want_bev)
    target_err = _check_targets(targets, want_targets)
    return {"frames": len(samples), "hflipped": int(host[4].sum()),
            "raster_vs_plain_on_card_max_abs_err": kernel_err, "prepare_vs_cpu_raster_max_abs_err": route_err,
            "prepare_vs_cpu_target_max_abs_err": target_err,
            "prepare_train_batch_ms": cuda_ms(lambda: prepare_train_batch(pts, valid, labels, n_lab, hflip), reps=10),
            "raster_ms": cuda_ms(lambda: bev_ops.points_to_bev_nchw(pts, valid), reps=10),
            "build_targets_ms": cuda_ms(lambda: build_targets(labels, n_lab, hflip), reps=10)}


def phase_train(card, tmp_root):
    """The training path. First one strict-fp32 step GPU vs CPU (SGD, then
    Adam, deterministic cuDNN); then the full width through the entry points
    a user calls: the CLI's parser and defaults (fpn_resnet_18, 608 x 608,
    batch 16, effective batch 64 -> S = 4), create_train_loader over a
    synthetic mini-KITTI with augmentation and hflip, create_optimizer,
    create_train_state, make_train_step: 5 steps in float32 and 3 in the
    bfloat16 default, timed; 8 Adam steps on one fixed batch must lower its
    loss; one epoch of the training CLI. bev_raster_reduce must launch once
    per collated batch."""
    import os

    from sfa3d_tpu_torch.cli import train as train_cli
    from sfa3d_tpu_torch.config.train import OptimConfig, parse_train_configs
    from sfa3d_tpu_torch.data.loader import create_train_loader, create_val_loader
    from sfa3d_tpu_torch.data.synthetic import write_mini_kitti
    from sfa3d_tpu_torch.parallel import create_train_state, make_train_step
    from sfa3d_tpu_torch.runtime.schedules import create_optimizer

    emit({"phase": "train_tolerance", "loss_rtol": TRAIN_LOSS_RTOL, "bn_stat_rtol_of_tensor_max": TRAIN_STAT_RTOL,
          "param_tol_share_of_largest_change": TRAIN_PARAM_SHARE,
          "adam_excuses_elements_with_grad_below_share_of_tensor_max": TRAIN_GRAD_FLOOR,
          "float_target_rtol_of_tensor_max": TARGET_RTOL})
    init_sd = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(SEED)).state_dict()
    torch.backends.cudnn.deterministic = True
    try:
        parity = {opt: _train_step_parity(opt, init_sd) for opt in ("sgd", "adam")}
    finally:
        torch.backends.cudnn.deterministic = False
    emit({"phase": "train_parity", "bev": list(TRAIN_PARITY_BEV), "S": 2, "B": 2, **parity,
          "card": card["nvidia_smi"]})

    t0 = time.perf_counter()
    root = write_mini_kitti(os.path.join(tmp_root, "kitti"), n_frames=TRAIN_FRAMES, seed=SEED,
                            splits={"train": range(TRAIN_FRAMES), "val": range(TRAIN_VAL_FRAMES)})
    write_s = time.perf_counter() - t0
    configs = parse_train_configs(["--dataset_dir", root, "--root-dir", os.path.join(tmp_root, "run"),
                                   "--seed", str(SEED)])
    rt = configs.runtime
    s = configs.optim.effective_batch // rt.batch_size
    if (rt.batch_size, s, configs.model.compute_dtype) != TRAIN_DEFAULTS:
        raise AssertionError(f"the CLI defaults are not batch, S, dtype = {TRAIN_DEFAULTS}")
    loader = create_train_loader(configs, device=DEVICE)
    model = _train_model(init_sd).to(DEVICE)
    spec = create_optimizer(configs.optim, rt.num_epochs, len(loader))
    state = create_train_state(model, spec)

    bev_raster_reduce.launches = 0  # count the main path's launches only
    runs = {}
    for dtype, epochs in (("float32", 5), ("bfloat16", 3)):
        step = make_train_step(model, spec, compute_dtype=dtype, device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        first = 1 if dtype == "float32" else 6
        state, ms, losses, wait, wall = _timed_steps(step, state, _epoch_batches(loader, epochs, first))
        if len(ms) != epochs:
            raise AssertionError(f"{len(ms)} batches for {epochs} epochs of {TRAIN_FRAMES} frames")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite {dtype} training loss: {losses}")
        steady = statistics.median(ms[1:])
        frames = s * rt.batch_size
        # end to end: the frames of the steps after the first over their wall
        # time, loader wait included (each step here is an epoch of its own,
        # so the threaded loader cannot load the next batch during a step)
        runs[dtype] = {"steps": len(ms), "step_ms": ms, "step_ms_median_after_first": steady,
                       "step_wall_ms": wall, "loader_wait_ms": wait,
                       "frames_per_s_end_to_end": (len(ms) - 1) * frames / (sum(wall[1:]) / 1e3),
                       "frames_per_s_device": frames / (steady / 1e3), "losses": losses,
                       "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    launches = bev_raster_reduce.launches
    n_batches = sum(r["steps"] for r in runs.values())
    if launches != n_batches:
        raise AssertionError(f"bev_raster_reduce launched {launches} times for {n_batches} collated batches")

    # 8 Adam steps on one fixed batch lower its loss (a fresh model)
    fixed = next(iter(_epoch_batches(loader, 1, 20)))
    ov_model = _train_model(init_sd).to(DEVICE)
    ov_spec = create_optimizer(OptimConfig(optimizer_type="adam", lr=1e-3, lr_type="cosin"), 10, 5)
    ov_state = create_train_state(ov_model, ov_spec)
    ov_step = make_train_step(ov_model, ov_spec, compute_dtype="float32", device=DEVICE)
    overfit = []
    for i in range(8):
        if i == 1:  # where a float32 step's device time goes (the shapes are warm)
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                ov_state, stats = ov_step(ov_state, fixed)
                torch.cuda.synchronize()
        else:
            ov_state, stats = ov_step(ov_state, fixed)
        overfit.append(float(stats["total_loss"]))
    if not (np.isfinite(overfit).all() and overfit[-1] < overfit[0]):
        raise AssertionError(f"8 Adam steps on one batch did not lower its loss: {overfit}")
    kernels = sorted(((self_device_us(e), e.key) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA and self_device_us(e) > 0), reverse=True)
    device_ms = sum(us for us, _ in kernels) / 1e3
    profile = {"kernel_device_ms": device_ms, "top_kernels": [[k[:90], us / 1e3] for us, k in kernels[:10]],
               "conv_gemm_share": sum(us for us, k in kernels if re.search(r"conv|cudnn|xmma|gemm|sm90|engine", k, re.I))
               / 1e3 / device_ms if device_ms else None}
    prep = _prepare_checks(loader)

    # one epoch of the training CLI (train step, validation, checkpoint)
    bev_raster_reduce.launches = 0
    t0 = time.perf_counter()
    train_cli.main(["--dataset_dir", root, "--root-dir", os.path.join(tmp_root, "cli"), "--num_epochs", "1",
                    "--checkpoint_freq", "1", "--seed", str(SEED), "--print_freq", "1"])
    cli_s = time.perf_counter() - t0
    val_batches = len(create_val_loader(configs, device=DEVICE))
    cli_launches = bev_raster_reduce.launches
    if cli_launches != 1 + val_batches:
        raise AssertionError(f"the CLI epoch launched the raster {cli_launches} times for 1 + {val_batches} batches")
    # the CLI's validation batches, the tail included, on the card and on the CPU
    val_frames, val_err = [], [0.0, 0.0, 0.0]
    for got, want in zip(create_val_loader(configs, device=DEVICE), create_val_loader(configs, device="cpu")):
        errs = raster_errors(got["bev"].flatten(0, 1).cpu(), want["bev"].flatten(0, 1))
        _check_targets({k: v.flatten(0, 1) for k, v in got["targets"].items()},
                       {k: v.flatten(0, 1) for k, v in want["targets"].items()})
        val_err = [max(a, b) for a, b in zip(val_err, errs)]
        val_frames.append(got["bev"].shape[1])
    if len(val_frames) != val_batches or sum(val_frames) != TRAIN_VAL_FRAMES:
        raise AssertionError(f"validation batches {val_frames} for {TRAIN_VAL_FRAMES} frames")
    ckpt = os.path.join(tmp_root, "cli", "checkpoints", rt.saved_fn, f"Model_{rt.saved_fn}_epoch_1.pth")
    Detector(checkpoint=ckpt, device=DEVICE)  # the served path loads what training wrote
    emit({"phase": "train", "arch": configs.model.arch, "bev": [H, W], "batch_size": rt.batch_size, "S": s,
          "frames_per_step": s * rt.batch_size, "mini_kitti_frames": TRAIN_FRAMES, "write_seconds": write_s,
          "augmentation": {"aug_prob": configs.data.aug_prob, "hflip_prob": configs.data.hflip_prob},
          **runs, "raster_launches": launches, "collated_batches": n_batches, "overfit_adam_losses": overfit,
          "float32_step_profile": profile, "prepare_batch_ms": prep,
          "cli_epoch_seconds": cli_s, "cli_raster_launches": cli_launches, "cli_val_batches": val_batches,
          "cli_val_batch_frames": val_frames, "cli_val_vs_cpu_raster_max_abs_err": val_err,
          "card": card["nvidia_smi"]})
    train_err = max(max(prep["raster_vs_plain_on_card_max_abs_err"]), max(prep["prepare_vs_cpu_raster_max_abs_err"]),
                    max(val_err))
    return launches, n_batches, train_err, root


# ---------------------------------------------------------------------------
# Data parallelism and the native host reader
# ---------------------------------------------------------------------------

DP_FRAMES = 16  # the two-rank check: a global batch of 16 at 608 x 608, 8 frames a rank
DP_RANKS = 2
DP_STEPS = 2  # SGD steps of the two-rank check on one batch: the first compared, the second timed warm
DP_WORLD1_SCENES = 64  # the world-1 check: the CLI's step, S x B = 4 x 16 frames at 608 x 608
DP_TIMED_STEPS = 3  # steps timed after the compared one, per variant
DP_TIMEOUT = 600  # s for a launch of ranks or a subprocess, its start and imports included
NATIVE_SCANS = 64  # seeded KITTI-sized scans (about 120k points, 25-30k in range)
NATIVE_REPS = 3  # timed passes over the scans, per reader
NATIVE_LOADER_EPOCHS = 3  # one-batch epochs through the train loader per reader setting


def _sd_cpu(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _step_differences(got, want, start, names):
    """Largest differences of two trained state_dicts from one start: every
    parameter as a share of the step's largest change, every BatchNorm
    statistic relative to its tensor's largest, and the largest absolute."""
    largest_change = max((want[k] - start[k]).abs().max().item() for k in names)
    param, stat, absolute = 0.0, 0.0, 0.0
    for k, w in want.items():
        diff = (got[k].double() - w.double()).abs().max().item()
        absolute = max(absolute, diff)
        if k.endswith("num_batches_tracked"):
            continue
        if k in names:
            param = max(param, diff / largest_change)
        else:
            stat = max(stat, diff / max(w.abs().max().item(), 1e-30))
    return {"param_max_err_share_of_largest_change": param, "bn_stat_max_rel_err": stat,
            "max_abs_diff": absolute, "largest_change": largest_change}


def _check_step_differences(what, diffs, loss_rel):
    if not (loss_rel <= TRAIN_LOSS_RTOL and diffs["param_max_err_share_of_largest_change"] <= TRAIN_PARAM_SHARE
            and diffs["bn_stat_max_rel_err"] <= TRAIN_STAT_RTOL):
        raise AssertionError(f"{what}: loss {loss_rel} relative, {diffs} beyond the train phase's tolerances")


def dp_world1_child():
    """Run in a subprocess under SFA3D_DIST=1 with a world of one (NCCL on
    the card): the CLI's step (S = 4 x B = 16 at 608 x 608, strict fp32,
    deterministic cuDNN, SGD) without a mesh, through make_mesh() (world 1:
    the one-device step, so bit-equal), and through the mesh path forced at
    world 1 (a mesh whose `synced` is forced on: NCCL all-reduces, global
    BatchNorm in flax's order, the normalizers). Prints one JSON line."""
    from sfa3d_tpu_torch.config.train import OptimConfig
    from sfa3d_tpu_torch.parallel import create_train_state, make_train_step
    from sfa3d_tpu_torch.parallel import mesh as pmesh
    from sfa3d_tpu_torch.runtime.schedules import create_optimizer

    class ForcedMesh(pmesh.Mesh):
        """The mesh path at world size 1: collectives on a group of one."""

        @property
        def synced(self):
            return True

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    if not pmesh.maybe_init_distributed():
        raise AssertionError("SFA3D_DIST is not set")
    try:
        mesh = pmesh.make_mesh()
        if mesh.world_size != 1 or torch.distributed.get_backend() != "nccl":
            raise AssertionError(f"expected a world of one over NCCL, got {mesh}")
        init_sd = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(SEED)).state_dict()
        batch = _train_batch_from_scenes(range(DP_WORLD1_SCENES), DEVICE, (H, W), (H // 4, W // 4), 4)
        spec = create_optimizer(OptimConfig(optimizer_type="sgd", lr=1e-2), num_epochs=10, steps_per_epoch=1)
        variants = {"plain": None, "mesh_world1": mesh,
                    "collectives_world1": ForcedMesh(mesh.world_size, mesh.rank, mesh.device, mesh.group)}
        out = {}
        for name, m in variants.items():
            model = _train_model(init_sd).to(DEVICE)
            state = create_train_state(model, spec)
            step = make_train_step(model, spec, device=DEVICE if m is None else None, mesh=m)
            state, stats = step(state, batch)
            sd = _sd_cpu(model)
            ms = []
            for _ in range(DP_TIMED_STEPS):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                state, _ = step(state, batch)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            out[name] = ({k: float(v) for k, v in stats.items()}, sd, ms)
        (ps, psd, pms), start_sd = out["plain"], {k: v.cpu() for k, v in init_sd.items()}
        names = [k for k, _ in _train_model(init_sd).named_parameters()]
        report = {"world_size": mesh.world_size, "backend": "nccl", "device": str(mesh.device),
                  "scenes": DP_WORLD1_SCENES, "plain_step_ms": pms}
        for name in ("mesh_world1", "collectives_world1"):
            s, sd, ms = out[name]
            loss_rel = max(abs(s[k] - ps[k]) / abs(ps[k]) for k in ps)
            report[name] = {"loss_max_rel_diff": loss_rel, **_step_differences(sd, psd, start_sd, names),
                            "step_ms": ms}
        print(json.dumps(report), flush=True)
    finally:
        torch.distributed.destroy_process_group()


def _dp_raw_batch(seeds):
    """One global batch (S = 1, B = len(seeds)) of raw padded scans,
    labels and flips, on the host: what the loader's collation hands
    prepare_train_batch."""
    from sfa3d_tpu_torch.data.synthetic import synthetic_scene

    n = len(seeds)
    pts, valid = np.zeros((n, N, 4), np.float32), np.zeros((n, N), bool)
    labels, n_lab = np.zeros((n, 50, 8), np.float32), np.zeros(n, np.int32)
    for i, sd in enumerate(seeds):
        scan, lab = synthetic_scene(sd)
        pts[i], valid[i] = bev_ops.filter_and_pad_points(scan, N)
        labels[i, :len(lab)], n_lab[i] = lab, len(lab)
    hflip = np.arange(n) % 3 == 1
    arrays = {"points": pts, "valid": valid, "labels": labels, "n_labels": n_lab, "hflip": hflip}
    return {k: torch.from_numpy(v)[None] for k, v in arrays.items()}


def _dp_prepare(raw, bev_size):
    """A rank's (S, B) raw frames -> its train batch, as the loader's
    collation does: one prepare_train_batch over the S x B frames (one
    bev_raster_reduce launch)."""
    from sfa3d_tpu_torch.data.loader import prepare_train_batch

    s, b = raw["points"].shape[:2]
    flat = [raw[k].flatten(0, 1) for k in ("points", "valid", "labels", "n_labels", "hflip")]
    bev, targets = prepare_train_batch(*flat, bev_size=tuple(bev_size), hm_size=(bev_size[0] // 4, bev_size[1] // 4))
    return {"bev": bev.reshape(s, b, *bev.shape[1:]),
            "targets": {k: v.reshape(s, b, *v.shape[1:]) for k, v in targets.items()}}


def dp_replay(case, mesh=None):
    """The two-rank check's SGD steps (lr 1e-2, strict fp32, deterministic
    cuDNN) from case["state_dict"], one per global raw batch of
    case["raw_batches"], each prepared on the card at case["bev_size"]: on
    one process over the whole batch, or with `mesh` over this rank's slice
    of it after `replicate`. Returns the per-step stats, step ms and
    prepare ms, the state_dicts after the first and the last step, and the
    raster launches."""
    from sfa3d_tpu_torch.config.train import OptimConfig
    from sfa3d_tpu_torch.parallel import create_train_state, make_train_step
    from sfa3d_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch
    from sfa3d_tpu_torch.runtime.schedules import create_optimizer

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        dev = torch.device(DEVICE) if mesh is None else mesh.device
        model = _train_model(case["state_dict"]).to(dev)
        spec = create_optimizer(OptimConfig(optimizer_type="sgd", lr=1e-2), num_epochs=10, steps_per_epoch=1)
        state = create_train_state(model, spec)
        if mesh is not None:
            replicate(mesh, state)
        step = make_train_step(model, spec, device=dev if mesh is None else None, mesh=mesh)
        here = mesh if mesh is not None else Mesh(1, 0, dev)
        out = {"stats": [], "step_ms": [], "prepare_ms": []}
        bev_raster_reduce.launches = 0
        for raw in case["raw_batches"]:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            batch = _dp_prepare(shard_batch(here, raw, axis=1), case["bev_size"])
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            state, stats = step(state, batch)
            torch.cuda.synchronize(dev)
            out["prepare_ms"].append((t1 - t0) * 1e3)
            out["step_ms"].append((time.perf_counter() - t1) * 1e3)
            out["stats"].append({k: float(v) for k, v in stats.items()})
            out.setdefault("first_state_dict", _sd_cpu(model))
        out["raster_launches"] = bev_raster_reduce.launches
        out["state_dict"] = _sd_cpu(model)
        return out
    finally:
        torch.backends.cudnn.deterministic = False


def dp_rank(case_path, prefix):
    """One of DP_RANKS ranks sharing the card over gloo (NCCL refuses two
    ranks on one GPU; `mesh.spawn_ranks(..., backend="gloo")` joins them):
    dp_replay over the group, saved with the rank, the world size and
    whether jax was imported to `<prefix>.rank<r>.pt`."""
    from sfa3d_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    out = dp_replay(torch.load(case_path, weights_only=False), mesh)
    out.update(rank=mesh.rank, world_size=mesh.world_size,
               jax_imported=any(m == "jax" or m.startswith(("jax.", "sfa3d_tpu.")) for m in sys.modules))
    torch.save(out, f"{prefix}.rank{mesh.rank}.pt")


def _run_session(cmd, env, timeout=DP_TIMEOUT):
    """Run a command in its own session; on a timeout kill the session (its
    children too) and raise."""
    import os
    import signal

    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True, cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[:4])} ... exited {proc.returncode}:\n{err[-4000:]}")
    return out, err


def _dist_env(world=1, rank=0):
    import os

    from sfa3d_tpu_torch.parallel.mesh import free_port

    return dict(os.environ, SFA3D_DIST="1", SFA3D_COORDINATOR=f"127.0.0.1:{free_port()}",
                SFA3D_NUM_PROCESSES=str(world), SFA3D_PROCESS_ID=str(rank))


def phase_dp_train(card, tmp_root, root):
    """Data parallelism on the one card. (a) An SFA3D_DIST world of one over
    NCCL, in a subprocess: the CLI's step through make_mesh() bit-equal to
    the plain step, and the mesh path forced at world 1 within the train
    phase's tolerances; step ms of each. (b) Two gloo ranks sharing the card,
    each preparing its 8 frames of a global batch of 16 at 608 x 608 (one
    bev_raster_reduce launch per rank and batch), strict-fp32 SGD steps on
    it (DP_STEPS), against one process with the whole batch on the card:
    the first step's losses, parameters and BatchNorm statistics within
    the train phase's tolerances, the ranks identical after every step,
    the second step timed warm (two steps of SGD at lr 1e-2 from random
    weights move parameters by 20 and amplify float32 rounding past the
    one-step tolerances). (c) One epoch of
    the training CLI with --mesh_shape 1 under
    SFA3D_DIST on the card, whose checkpoint Detector loads."""
    import os

    t0 = time.perf_counter()
    out, _ = _run_session([sys.executable, "-c", "import chip_smoke; chip_smoke.dp_world1_child()"], _dist_env())
    world1 = json.loads(out.strip().splitlines()[-1])
    if world1["mesh_world1"]["max_abs_diff"] != 0.0 or world1["mesh_world1"]["loss_max_rel_diff"] != 0.0:
        raise AssertionError(f"the world-1 mesh step differs from the plain step: {world1['mesh_world1']}")
    forced = world1["collectives_world1"]
    _check_step_differences("the mesh path forced at world 1", forced, forced["loss_max_rel_diff"])
    world1_s = time.perf_counter() - t0

    init_sd = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(SEED)).state_dict()
    case = {"state_dict": init_sd, "raw_batches": [_dp_raw_batch(range(100, 100 + DP_FRAMES))] * DP_STEPS,
            "bev_size": (H, W)}
    case_path, prefix = os.path.join(tmp_root, "dp_case.pt"), os.path.join(tmp_root, "dp_rank")
    torch.save(case, case_path)
    from sfa3d_tpu_torch.parallel.mesh import spawn_ranks

    t0 = time.perf_counter()
    spawn_ranks(dp_rank, DP_RANKS, args=(case_path, prefix), device=DEVICE, timeout=DP_TIMEOUT, backend="gloo")
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(f"{prefix}.rank{r}.pt", weights_only=False) for r in range(DP_RANKS)]
    one = dp_replay(case)
    if one["raster_launches"] != DP_STEPS:
        raise AssertionError(f"{DP_STEPS} one-process batches launched the raster {one['raster_launches']} times")
    names = [k for k, _ in _train_model(init_sd).named_parameters()]
    start_sd = {k: v.cpu() for k, v in init_sd.items()}
    per_rank = []
    for r in ranks:
        if r["world_size"] != DP_RANKS or r["jax_imported"]:
            raise AssertionError(f"rank {r['rank']}: world {r['world_size']}, jax imported {r['jax_imported']}")
        if r["raster_launches"] != DP_STEPS:
            raise AssertionError(f"rank {r['rank']} launched the raster {r['raster_launches']} times "
                                 f"for {DP_STEPS} batches")
        loss_rel = max(abs(r["stats"][0][k] - v) / abs(v) for k, v in one["stats"][0].items())
        diffs = _step_differences(r["first_state_dict"], one["first_state_dict"], start_sd, names)
        _check_step_differences(f"rank {r['rank']} of {DP_RANKS}", diffs, loss_rel)
        per_rank.append({"rank": r["rank"], "loss_max_rel_err": loss_rel, **diffs, "step_ms": r["step_ms"],
                         "prepare_ms": r["prepare_ms"], "raster_launches_per_batch": r["raster_launches"] / DP_STEPS})
    a, b = ranks
    if not all(torch.equal(a[sd][k], b[sd][k]) for sd in ("first_state_dict", "state_dict") for k in a[sd]):
        raise AssertionError("the two ranks' parameters or statistics differ")

    t0 = time.perf_counter()
    run_dir = os.path.join(tmp_root, "dist_cli")
    _run_session([sys.executable, "-m", "sfa3d_tpu_torch.cli.train", "--dataset_dir", root, "--root-dir", run_dir,
                  "--num_epochs", "1", "--checkpoint_freq", "1", "--seed", str(SEED), "--print_freq", "1",
                  "--mesh_shape", "1"], _dist_env())
    cli_s = time.perf_counter() - t0
    ckpt = os.path.join(run_dir, "checkpoints", "fpn_resnet_18", "Model_fpn_resnet_18_epoch_1.pth")
    Detector(checkpoint=ckpt, device=DEVICE)
    emit({"phase": "dp_train", "world1": world1, "world1_seconds": world1_s,
          "two_gloo_ranks_on_one_card": {"global_batch": DP_FRAMES, "frames_per_rank": DP_FRAMES // DP_RANKS,
                                         "bev": [H, W], "per_rank": per_rank, "one_process_step_ms": one["step_ms"],
                                         "one_process_prepare_ms": one["prepare_ms"], "seconds": ranks_s},
          "cli_sfa3d_dist_mesh_shape_1_epoch_seconds": cli_s, "card": card["nvidia_smi"]})
    return [r["raster_launches"] for r in ranks]


DPSP_SHAPE = (2, 2)  # data x spatial: four gloo ranks sharing the card
DPSP_FRAMES = 4  # the full-width step's global batch at 608 x 608: 2 frames a data index
DPSP_FUSED_FRAMES = 8  # the fused program's batch: 4 frames a data index
DPSP_TIMED_STEPS = 2  # steps timed after the compared one
DPSP_EMA = (0.999, 2000.0)  # the full-width step's EMA decay and tau
DPSP_LOSS_RTOL = 1e-4  # loss terms, dp x sp step vs the one-process card step, strict fp32
DPSP_BOX_TOL = 1e-3  # metric 3D boxes, dp x sp program vs one device
DPSP_PIXEL_FLIP = 1.0  # integer fused boxes vs one device: a truncation may flip a pixel (float noise)
DPSP_EXCHANGE_HEIGHTS = (2, 5, 38, 152)  # the exchange check's map heights over 2 spatial ranks
DPSP_TIMEOUT = 400  # s for the four ranks, their start, imports and CUDA contexts included


def _exchange_card_vs_cpu(mesh):
    """fetch_rows and gather_rows, forward and backward, on small-integer
    maps on the card (gloo: rows staged through host memory) and on the CPU
    (gloo send / recv), over requests that cross every owner and reach past
    both ends: both bit-equal to slicing and to each other."""
    from sfa3d_tpu_torch.spatial import fetch_rows, gather_rows, row_range, row_sharded

    n, s = mesh.spatial_size, mesh.spatial_index
    checked = 0
    for height in DPSP_EXCHANGE_HEIGHTS:
        rng = np.random.default_rng(height)
        x = torch.from_numpy(rng.integers(-8, 9, (2, 3, height, 16)).astype(np.float32))
        spans = [(-3, 2), (1, height + 2), (height - 1, height + 4), (0, 0)]
        requests = [spans[(q + height) % len(spans)] for q in range(n)]
        lo, hi = row_range(height, n, s)
        grads = [torch.from_numpy(rng.integers(-8, 9, (2, 3, max(0, b - a), 16)).astype(np.float32))
                 for a, b in requests]
        results = []
        for dev in (mesh.device, torch.device("cpu")):
            local = x[..., lo:hi, :].to(dev).requires_grad_(True)
            with row_sharded(mesh, height, 16) as sh:
                got = fetch_rows(local, height, requests, float("-inf"))
                got.backward(grads[s].to(dev))
                local2 = x[..., lo:hi, :].to(dev).requires_grad_(True)
                whole = gather_rows(local2, sh)
                whole.backward(torch.ones_like(whole))
            results.append([t.detach().cpu() for t in (got, local.grad, whole, local2.grad)])
        a, b = requests[s]
        want = torch.full((2, 3, b - a, 16), float("-inf"))
        r0, r1 = max(a, 0), min(b, height)
        if r1 > r0:
            want[..., r0 - a:r1 - a, :] = x[..., r0:r1, :]
        card, cpu = results
        if not (all(torch.equal(c, h) for c, h in zip(card, cpu)) and torch.equal(card[0], want)
                and torch.equal(card[2], x)):
            raise AssertionError(f"the row exchange at height {height}: card and CPU or slicing differ")
        checked += 1
    return checked


def _record_networks(program, rec):
    """Have `program` (a FusedProgram) keep the KFPN heads and YOLO levels
    it computes in `rec` on the host."""
    heads, levels = program.kfpn_heads, program.yolo_levels

    def kfpn_heads(bev):
        rec["heads"] = {k: v.cpu() for k, v in heads(bev).items()}
        return {k: v.to(bev.device) for k, v in rec["heads"].items()}

    def yolo_levels(images):
        rec["levels"] = [(b.cpu(), c.cpu()) for b, c in levels(images)]
        return [(b.to(images.device), c.to(images.device)) for b, c in rec["levels"]]

    program.kfpn_heads, program.yolo_levels = kfpn_heads, yolo_levels


def _run_fused_program(program, inputs, dev, sl=slice(None)):
    """FusedProgram on frames `sl` of the host batch `inputs`, as
    build_fused_pipeline's run feeds it -> host dict of numpy arrays."""
    points, valid, *rest = inputs
    with torch.inference_mode():
        out = program(torch.as_tensor(points[sl]).to(dev), torch.as_tensor(valid[sl]).to(dev),
                      *(torch.as_tensor(a[sl]).to(dev, torch.float32) for a in rest))
    return {k: v.cpu().numpy() for k, v in out.items()}


def _dpsp_fused_models(case, dev):
    from sfa3d_tpu_torch.models.yolov8 import YOLOv8

    kfpn = create_model("fpn_resnet_18")
    kfpn.load_state_dict(case["fused_kfpn"])
    yolo = YOLOv8("n", 80)
    yolo.load_state_dict(case["fused_yolo"])
    return kfpn.to(dev).eval(), yolo.to(dev).eval()


def dp_sp_rank(case_path, prefix):
    """One of four gloo ranks sharing the card (mesh.spawn_ranks(...,
    backend="gloo")): the exchange card vs CPU, the float64 parity check's
    ranks (scripts/torch_spatial_parity_check.py), the full-width dp x sp
    train step (strict fp32, SGD and EMA) and the fused program at batch 8
    over make_mesh_2d(2, 2). Saves what it found to `<prefix>.rank<r>.pt`."""
    from scripts.torch_spatial_parity_check import parity_rank
    from sfa3d_tpu_torch import spatial
    from sfa3d_tpu_torch.config.train import OptimConfig
    from sfa3d_tpu_torch.fusion.batch import FusedProgram, build_fused_pipeline
    from sfa3d_tpu_torch.parallel import create_train_state, make_train_step
    from sfa3d_tpu_torch.parallel.mesh import make_mesh_2d, replicate, shard_batch
    from sfa3d_tpu_torch.parallel.train_step import ema_decay_at
    from sfa3d_tpu_torch.runtime.schedules import create_optimizer

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    case = torch.load(case_path, weights_only=False)
    mesh = make_mesh_2d(*DPSP_SHAPE, device=DEVICE)
    dev = mesh.device
    out = {"rank": mesh.rank, "data_index": mesh.data_index, "spatial_index": mesh.spatial_index}
    t0 = time.perf_counter()
    out["exchange_heights_checked"] = _exchange_card_vs_cpu(mesh)
    out["exchange_check_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    parity_rank(case["parity_case"], case["parity_prefix"])
    out["parity_s"] = time.perf_counter() - t0

    model = _train_model(case["state_dict"]).to(dev)
    spec = create_optimizer(OptimConfig(optimizer_type="sgd", lr=1e-2), num_epochs=10, steps_per_epoch=1)
    state = create_train_state(model, spec, ema=True)
    replicate(mesh, state)
    step = make_train_step(model, spec, *DPSP_EMA, mesh=mesh)
    bev_raster_reduce.launches = 0
    batch = _dp_prepare(shard_batch(mesh, case["raw_batch"], axis=1), (H, W))
    out["train_raster_launches"] = bev_raster_reduce.launches
    out["train_local_rows"] = H // DPSP_SHAPE[1]
    ema0 = {k: v.clone() for k, v in state.ema_params.items()}
    spatial.reset_exchange_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, stats = step(state, batch)
    torch.cuda.synchronize(dev)
    out["first_step_ms"] = (time.perf_counter() - t0) * 1e3
    out["stats"] = {k: float(v) for k, v in stats.items()}
    out["exchanges_per_step"] = dict(spatial.EXCHANGES)
    one_minus_d = float(np.float32(1.0) - ema_decay_at(1, *DPSP_EMA))
    out["ema_recurrence_exact"] = all(
        torch.equal(state.ema_params[k], e + one_minus_d * (model.get_parameter(k).detach() - e))
        for k, e in ema0.items())
    out["state_dict"] = _sd_cpu(model) if mesh.rank == 0 else None
    out["step_ms"], out["staging_ms"] = [], []
    for _ in range(DPSP_TIMED_STEPS):
        spatial.reset_exchange_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = step(state, batch)
        end.record()
        end.synchronize()
        out["step_ms"].append(start.elapsed_time(end))
        out["staging_ms"].append(spatial.EXCHANGES["staging_s"] * 1e3)
    del state, step, batch, model
    torch.cuda.empty_cache()

    kfpn, yolo = _dpsp_fused_models(case, dev)
    networks, init = {}, FusedProgram.__init__

    def recording_init(self, *args, **kwargs):  # the program build_fused_pipeline makes keeps its networks' outputs
        init(self, *args, **kwargs)
        _record_networks(self, networks)

    FusedProgram.__init__ = recording_init
    try:
        run = build_fused_pipeline(kfpn, yolo, mesh=mesh, **case["fused_kw"])
    finally:
        FusedProgram.__init__ = init
    counted = [bev_raster_reduce, fusion_loops.hard_nms_keep, fusion_loops.soft_nms_gaussian,
               fusion_loops.greedy_match]
    run(*case["fused_inputs"])  # warm
    for fn in counted:
        fn.launches = 0
    spatial.reset_exchange_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    got = run(*case["fused_inputs"])
    torch.cuda.synchronize(dev)
    out["fused_ms"] = (time.perf_counter() - t0) * 1e3
    out["fused_launches"] = {fn.__name__: fn.launches for fn in counted}
    out["fused_exchanges"] = dict(spatial.EXCHANGES)
    out["fused"] = {k: v.cpu().numpy() for k, v in got.items()}
    out["fused_networks"] = networks
    out["jax_imported"] = any(m == "jax" or m.startswith(("jax.", "sfa3d_tpu.")) for m in sys.modules)
    torch.save(out, f"{prefix}.rank{mesh.rank}.pt")


def _dpsp_fused_case():
    """Conditioned fused weights (fused_serve's) and a batch of
    DPSP_FUSED_FRAMES frames: padded scans, letterboxed seeded images, the
    default calibration."""
    fd = FusedDetector(imgsz=CANVAS, device="cpu", seed=SEED)
    reqs = fused_requests(DPSP_FUSED_FRAMES)
    bump_fused_biases(fd, yolo_gate_bias(fd.yolo, reqs[0][1]))
    pts, valid, imgs = [], [], []
    for scan, image, _ in reqs:
        p, v = bev_ops.filter_and_pad_points(scan, N)
        pts.append(p)
        valid.append(v)
        img, r, pad = letterbox(image, CANVAS)
        imgs.append(img)
    calib, n = reqs[0][2], len(reqs)
    inputs = (np.stack(pts), np.stack(valid), np.stack(imgs), np.stack([calib.V2C.astype(np.float32)] * n),
              np.stack([calib.R0.astype(np.float32)] * n), np.stack([calib.P2.astype(np.float32)] * n),
              np.float32([IMG_HW] * n), np.float32([r] * n), np.float32([pad] * n))
    return {"fused_kfpn": fd.kfpn.state_dict(), "fused_yolo": fd.yolo.state_dict(), "fused_inputs": inputs,
            "fused_kw": {}}


def phase_dp_sp(card, tmp_root):
    """Data x spatial parallelism (make_mesh_2d(2, 2)) with four gloo ranks
    sharing the card: a check of correctness, not of multi-card speed.
    Each rank: the row exchange card vs CPU; the float64 parity check at
    64 x 64 (dp and dp x sp against the unsharded step, run here); the
    full-width step (608 x 608, strict fp32, SGD and EMA, its 2 frames of a
    global 4 prepared on the card: one raster launch) with its loss within
    DPSP_LOSS_RTOL of this process's one-process step on the same batch and
    the EMA recurrence exact, step ms, exchanges, bytes and host-staging ms
    per step; the fused program at batch 8 (its 4 frames) against the
    one-device program (valid and the 3D masks equal, metric boxes within
    DPSP_BOX_TOL, the networks within NET_TOL, the integer boxes exact given
    the rank's network outputs and within DPSP_PIXEL_FLIP directly), one
    launch of each kernel a batch."""
    import os

    from scripts.torch_spatial_parity_check import make_case, report
    from sfa3d_tpu_torch.config.train import OptimConfig
    from sfa3d_tpu_torch.fusion.batch import FusedProgram, build_fused_pipeline
    from sfa3d_tpu_torch.parallel import create_train_state, make_train_step
    from sfa3d_tpu_torch.parallel.mesh import Mesh, shard_batch, spawn_ranks
    from sfa3d_tpu_torch.runtime.schedules import create_optimizer

    t_phase = time.perf_counter()
    per = DPSP_FUSED_FRAMES // DPSP_SHAPE[0]
    init_sd = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(SEED)).state_dict()
    parity_case = {**make_case(64), "platform": DEVICE.type}
    parity_path, parity_prefix = os.path.join(tmp_root, "dpsp_parity.pt"), os.path.join(tmp_root, "dpsp_parity")
    torch.save(parity_case, parity_path)
    case = {"state_dict": init_sd, "raw_batch": _dp_raw_batch(range(300, 300 + DPSP_FRAMES)),
            "parity_case": parity_path, "parity_prefix": parity_prefix, **_dpsp_fused_case()}
    case_path, prefix = os.path.join(tmp_root, "dpsp_case.pt"), os.path.join(tmp_root, "dpsp_rank")
    torch.save(case, case_path)
    world = DPSP_SHAPE[0] * DPSP_SHAPE[1]
    t0 = time.perf_counter()
    spawn_ranks(dp_sp_rank, world, args=(case_path, prefix), device=DEVICE, timeout=DPSP_TIMEOUT, backend="gloo")
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(f"{prefix}.rank{r}.pt", weights_only=False) for r in range(world)]
    parity = report(parity_case, [torch.load(f"{parity_prefix}.rank{r}.pt", weights_only=False)
                                  for r in range(world)], DEVICE)

    # the one-process references on the card: the step on the whole batch, the fused program on one device
    torch.backends.cudnn.deterministic = True
    try:
        model = _train_model(init_sd).to(DEVICE)
        spec = create_optimizer(OptimConfig(optimizer_type="sgd", lr=1e-2), num_epochs=10, steps_per_epoch=1)
        state = create_train_state(model, spec, ema=True)
        step = make_train_step(model, spec, *DPSP_EMA, device=DEVICE)
        batch = _dp_prepare(shard_batch(Mesh(1, 0, DEVICE), case["raw_batch"], axis=1), (H, W))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, stats = step(state, batch)
        torch.cuda.synchronize()
        one_first_step_ms = (time.perf_counter() - t0) * 1e3
        one_stats, one_sd = {k: float(v) for k, v in stats.items()}, _sd_cpu(model)
        one_step_ms = []
        for _ in range(DPSP_TIMED_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, _ = step(state, batch)
            end.record()
            end.synchronize()
            one_step_ms.append(start.elapsed_time(end))
        del state, step, batch, model
        kfpn, yolo = _dpsp_fused_models(case, DEVICE)
        run = build_fused_pipeline(kfpn, yolo, device=DEVICE, **case["fused_kw"])
        run(*case["fused_inputs"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = {k: v.cpu().numpy() for k, v in run(*case["fused_inputs"]).items()}
        torch.cuda.synchronize()
        one_fused_ms = (time.perf_counter() - t0) * 1e3
        one_networks = {}
        program = FusedProgram(kfpn, yolo, **case["fused_kw"])
        _record_networks(program, one_networks)
        _run_fused_program(program, case["fused_inputs"], DEVICE)
        replays = {}  # each data shard's detections from the one-device program given the ranks' network outputs
        for r in ranks:
            program = FusedProgram(kfpn, yolo, **case["fused_kw"])
            given = r["fused_networks"]
            program.kfpn_heads = lambda bev, _g=given: {k: v.to(bev.device) for k, v in _g["heads"].items()}
            program.yolo_levels = lambda im, _g=given: [(b.to(im.device), c.to(im.device)) for b, c in _g["levels"]]
            sl = slice(r["data_index"] * per, (r["data_index"] + 1) * per)
            replays[r["rank"]] = _run_fused_program(program, case["fused_inputs"], DEVICE, sl)
    finally:
        torch.backends.cudnn.deterministic = False

    per_rank = []
    for r in ranks:
        if r["jax_imported"]:
            raise AssertionError(f"rank {r['rank']} imported jax")
        loss_rel = max(abs(r["stats"][k] - v) / abs(v) for k, v in one_stats.items())
        if loss_rel > DPSP_LOSS_RTOL or not r["ema_recurrence_exact"]:
            raise AssertionError(f"rank {r['rank']}: loss {loss_rel} relative to the one-process step, "
                                 f"EMA recurrence exact {r['ema_recurrence_exact']}")
        if r["train_raster_launches"] != 1 or any(v != 1 for v in r["fused_launches"].values()):
            raise AssertionError(f"rank {r['rank']}: raster launches {r['train_raster_launches']} for one batch, "
                                 f"fused launches {r['fused_launches']}")
        # The rank's detections against the one-device program's: valid and the 3D masks equal, the
        # metric boxes within DPSP_BOX_TOL; the integer boxes are truncated means and projections, where
        # float noise in the networks may move a coordinate across an integer, so they are held exactly
        # against the one-device program given this rank's network outputs (whose own difference from
        # the one-device networks is held to NET_TOL), and directly within a pixel, the flips counted.
        sl = slice(r["data_index"] * per, (r["data_index"] + 1) * per)
        got, net_err = r["fused"], 0.0
        for k, v in r["fused_networks"]["heads"].items():
            net_err = max(net_err, (v - one_networks["heads"][k][sl]).abs().max().item())
        for (b, c), (wb, wc) in zip(r["fused_networks"]["levels"], one_networks["levels"]):
            net_err = max(net_err, (b - wb[sl]).abs().max().item(), (c - wc[sl]).abs().max().item())
        replay_equal = all(np.array_equal(got[k], v) for k, v in replays[r["rank"]].items())
        if not np.array_equal(got["valid"], want["valid"][sl]) or not np.array_equal(got["mask_3d"],
                                                                                    want["mask_3d"][sl]):
            raise AssertionError(f"rank {r['rank']}: the fused valid or 3D masks differ from one device")
        box_diff = np.abs(np.where(got["valid"][..., None], got["boxes"] - want["boxes"][sl], 0))
        box_err = float(np.abs(np.where(got["mask_3d"][..., None], got["boxes_real"] - want["boxes_real"][sl],
                                        0)).max())
        if (box_err > DPSP_BOX_TOL or box_diff.max() > DPSP_PIXEL_FLIP or net_err > NET_TOL
                or not replay_equal):
            raise AssertionError(f"rank {r['rank']}: 3D boxes {box_err}, fused boxes {box_diff.max()} px from one "
                                 f"device; networks {net_err} apart; equal given its networks: {replay_equal}")
        per_rank.append({"rank": r["rank"], "data_index": r["data_index"], "spatial_index": r["spatial_index"],
                         "loss_max_rel_err": loss_rel, "ema_recurrence_exact": r["ema_recurrence_exact"],
                         "first_step_ms": r["first_step_ms"], "step_ms": r["step_ms"],
                         "exchanges_per_step": r["exchanges_per_step"], "staging_ms_per_step": r["staging_ms"],
                         "fused_ms": r["fused_ms"], "fused_exchanges": r["fused_exchanges"],
                         "fused_boxes_real_max_err": box_err, "fused_valid": int(got["valid"].sum()),
                         "fused_box_coords_one_pixel_apart": int((box_diff > 0).sum()),
                         "fused_networks_max_err": net_err, "fused_equal_given_its_networks": replay_equal,
                         "fused_launches": r["fused_launches"], "train_raster_launches": r["train_raster_launches"],
                         "exchange_heights_checked": r["exchange_heights_checked"], "parity_s": r["parity_s"]})
    diffs = _step_differences(ranks[0]["state_dict"], one_sd, {k: v.cpu() for k, v in init_sd.items()},
                              [k for k, _ in _train_model(init_sd).named_parameters()])
    emit({"phase": "dp_sp", "mesh": list(DPSP_SHAPE), "note": "four gloo ranks sharing one card",
          "parity_64_float64": parity, "train_bev": [H, W], "train_global_batch": DPSP_FRAMES,
          "one_process_first_step_ms": one_first_step_ms, "one_process_step_ms": one_step_ms,
          "rank0_state_vs_one_process": diffs,
          "fused_batch": DPSP_FUSED_FRAMES, "one_device_fused_ms": one_fused_ms, "per_rank": per_rank,
          "ranks_seconds": ranks_s, "seconds": time.perf_counter() - t_phase, "card": card["nvidia_smi"]})
    return {"train": [r["train_raster_launches"] for r in ranks], "fused": [r["fused_launches"] for r in ranks]}


def _kitti_sized_scan(rng, seed):
    """A synthetic scene (25-30k points in range) and about 85k points out
    of range behind and beside it: about 120k points, a raw KITTI scan."""
    from sfa3d_tpu_torch.data.synthetic import synthetic_scene

    scan, _ = synthetic_scene(seed)
    far = np.empty((85000, 4), np.float32)
    far[:, 0] = rng.uniform(-80, 0, len(far))
    far[:, 1] = rng.uniform(-80, 80, len(far))
    far[:, 2] = rng.uniform(-3, 1, len(far))
    far[:, 3] = rng.uniform(0, 1, len(far))
    out = np.concatenate([scan, far])
    return out[rng.permutation(len(out))]


def _timed_pass(fn, items, reps=NATIVE_REPS):
    """Median over `reps` passes of the ms per item of fn over `items`."""
    per = []
    for _ in range(reps):
        t = time.perf_counter()
        for x in items:
            fn(x)
        per.append((time.perf_counter() - t) * 1e3 / len(items))
    return statistics.median(per)


def phase_native(card, tmp_root, root):
    """The native host reader (native/preproc.cpp, built by g++ at first
    use) against its numpy twin on 64 seeded KITTI-sized scans written as
    .bin files, one of which overflows MAX_POINTS_FILTERED and one holds NaN
    rows: the fused read and the filter bit-equal to numpy's; ms per scan
    of each. Then the train phase's loader at the CLI's defaults with and
    without it (SFA3D_TPU_NO_NATIVE): the wait per step, and one batch of
    64 frames split into the dataset's read, augmentation and filter,
    collation, the copy to the card and the device preparation."""
    import os
    import warnings

    from sfa3d_tpu_torch import native
    from sfa3d_tpu_torch.config.train import parse_train_configs
    from sfa3d_tpu_torch.data.loader import create_train_loader, prepare_train_batch
    from sfa3d_tpu_torch.parallel import create_train_state, make_train_step
    from sfa3d_tpu_torch.runtime.schedules import create_optimizer

    os.environ.pop("SFA3D_TPU_NO_NATIVE", None)
    t0 = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    scans = [_kitti_sized_scan(rng, 300 + i) for i in range(NATIVE_SCANS)]
    inside, mask = bev_ops._filter_and_pad_numpy(scans[1], N, cnf.boundary)
    scans[1] = np.concatenate([scans[1], inside[mask][:12000]])  # about 40k points in range: overflows N
    scans[2][rng.integers(0, len(scans[2]), 500), rng.integers(0, 3, 500)] = np.nan
    paths = []
    for i, s in enumerate(scans):
        paths.append(os.path.join(tmp_root, f"scan_{i:03d}.bin"))
        s.tofile(paths[-1])
    kept = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for s, p in zip(scans, paths):
            want = bev_ops._filter_and_pad_numpy(np.fromfile(p, np.float32).reshape(-1, 4), N, cnf.boundary)
            for got in (native.read_velodyne_filtered(p, N, cnf.boundary), native.filter_pad_points(s, N, cnf.boundary)):
                if got[0].tobytes() != want[0].tobytes() or got[1].tobytes() != want[1].tobytes():
                    raise AssertionError(f"{p}: the native reader differs from the numpy twin")
            kept.append(int(want[1].sum()))
    overflow = [str(w.message) for w in caught]
    if kept[1] != N or len(overflow) != 3 or "keeping the first" not in overflow[0]:
        raise AssertionError(f"the overflowing scan kept {kept[1]} of {N} with warnings {overflow}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        per_scan = {
            "native_read_filter_pad_ms": _timed_pass(lambda p: native.read_velodyne_filtered(p, N, cnf.boundary), paths),
            "numpy_read_filter_pad_ms": _timed_pass(
                lambda p: bev_ops._filter_and_pad_numpy(np.fromfile(p, np.float32).reshape(-1, 4), N, cnf.boundary),
                paths),
            "numpy_read_ms": _timed_pass(lambda p: np.fromfile(p, np.float32).reshape(-1, 4), paths),
            "native_filter_pad_ms": _timed_pass(lambda s: native.filter_pad_points(s, N, cnf.boundary), scans),
            "numpy_filter_pad_ms": _timed_pass(lambda s: bev_ops._filter_and_pad_numpy(s, N, cnf.boundary), scans),
        }

    configs = parse_train_configs(["--dataset_dir", root, "--root-dir", os.path.join(tmp_root, "native_run"),
                                   "--seed", str(SEED)])
    init_sd = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(SEED)).state_dict()
    loader_runs = {}
    try:
        for setting in ("native", "numpy"):
            if setting == "numpy":
                os.environ["SFA3D_TPU_NO_NATIVE"] = "1"
            loader = create_train_loader(configs, device=DEVICE)
            ds = loader.dataset
            model = _train_model(init_sd).to(DEVICE)
            spec = create_optimizer(configs.optim, configs.runtime.num_epochs, len(loader))
            step = make_train_step(model, spec, compute_dtype=configs.model.compute_dtype, device=DEVICE)
            _, ms, _, wait, _ = _timed_steps(step, create_train_state(model, spec),
                                             _epoch_batches(loader, NATIVE_LOADER_EPOCHS, 40))
            frames = loader.batch_size * loader.subdivisions
            ids = [int(ds.sample_id_list[i]) for i in range(frames)]
            t = time.perf_counter()
            raw = [ds.get_lidar(i) for i in ids]
            read_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            for r in raw:
                bev_ops.filter_and_pad_points(r, ds.max_points)
            filter_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            for i in ids:
                ds._read_points_filtered(i)
            fused_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            samples = [ds[i] for i in range(frames)]
            getitem_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            host = [np.stack([x.points for x in samples]), np.stack([x.valid for x in samples]),
                    np.stack([x.labels for x in samples]), np.int32([x.n_labels for x in samples]),
                    np.asarray([bool(getattr(x, "hflipped", False)) for x in samples])]
            collate_ms = (time.perf_counter() - t) * 1e3
            torch.cuda.synchronize()
            t = time.perf_counter()
            dev = [torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE) for a in host]
            torch.cuda.synchronize()
            copy_ms = (time.perf_counter() - t) * 1e3
            loader_runs[setting] = {
                "step_ms": ms, "loader_wait_ms": wait, "frames_per_batch": frames,
                "batch_split_ms": {"read": read_ms, "filter_pad": filter_ms,
                                   "read_filter_pad_without_augmentation": fused_ms,
                                   "getitem_total_read_aug_filter_labels": getitem_ms,
                                   "collate": collate_ms, "copy_to_card": copy_ms,
                                   "copy_bytes": int(sum(a.nbytes for a in host)),
                                   "prepare_on_card": cuda_ms(lambda: prepare_train_batch(*dev), reps=5)},
                "host_reader": "native" if native.enabled() else "numpy"}
    finally:
        os.environ.pop("SFA3D_TPU_NO_NATIVE", None)
    emit({"phase": "native", "library": str(lib.name), "build_seconds": build_s, "scans": NATIVE_SCANS,
          "points_per_scan_mean": float(np.mean([len(s) for s in scans])), "in_range_kept_mean": float(np.mean(kept)),
          "bit_equal": True, "overflow_warnings": len(overflow), "per_scan": per_scan, "loader": loader_runs,
          "num_workers": configs.data.num_workers, "card": card["nvidia_smi"]})


# ---------------------------------------------------------------------------
# YOLOv8 training and the eval passes
# ---------------------------------------------------------------------------

YOLO_PARITY_HW = (64, 128)  # the GPU vs CPU epoch: canvas, S steps of B frames
YOLO_PARITY_S, YOLO_PARITY_B = 3, 2
YOLO_CLASSES = 3  # the KITTI ids, the yolo-train CLI's default
YOLO_EPOCHS = 4  # CLI epochs over the mini-KITTI: 3 steps each, an eval pass after each
YOLO_TIMED_STEPS = 8  # full-width steps timed one by one after a first
YOLO_STEP_LOSS_RTOL = 1e-5  # loss terms GPU vs CPU of the first step (the same parameters)
YOLO_CANCELLED_SHARE = 0.1  # AdamW elements with |mu| <= this share of sqrt(nu) are excused
# the epoch's mean loss terms: its later steps start from parameters that
# AdamW moved by about lr * sign(g), so elements whose gradient is float32
# noise move either way on the two devices
YOLO_EPOCH_LOSS_RTOL = 1e-4
# decoded boxes (px: within atol + rtol * |value|, two float32 ulps of a
# coordinate, which reaches ~1100 px) and scores, card vs CPU on the same
# levels: libm ulps of exp and the 16-bin sums (tests/test_torch_yolov8.py's
# decode tolerance)
YOLO_DECODE_ATOL, YOLO_DECODE_RTOL, YOLO_SCORE_ATOL = 1e-4, 2.4e-7, 1e-6
YOLO_NMS_SHAPE = (8, 512)  # the eval's hard-NMS input: eval batch x pre_nms candidates
KITTI_EVAL_FRAMES = 8  # val frames through cli/eval on the card and on the CPU
AP_TOL = 1e-6  # KITTI AP and 2D mAP, card vs CPU
ROT_IOU_TOL = 1e-5  # rotated IoU, card vs CPU


def _yolo_split(rng, n, hw):
    """n random uint8 frames with 8 box slots (the data/yolo2d.py layout)."""
    xy = rng.uniform(0, [hw[1] - 12, hw[0] - 12], (n, 8, 2))
    boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(8, 40, (n, 8, 2)), [hw[1], hw[0]])], -1)
    return {"images": rng.integers(0, 256, (n, *hw, 3)).astype(np.uint8), "boxes": boxes.astype(np.float32),
            "labels": rng.integers(0, YOLO_CLASSES, (n, 8)).astype(np.int32), "mask": rng.random((n, 8)) < 0.7}


def phase_yolo_train_parity(card):
    """One strict-fp32 YOLO epoch (S = 3 x B = 2 at 64 x 128, YOLOv8n, 3
    classes, AdamW with a 2-step warmup, EMA, fixed flips) of the same model
    and data on the card and on the CPU: losses, parameters, BatchNorm
    statistics and EMA within the printed tolerances."""
    from sfa3d_tpu_torch.parallel.yolo_step import create_train_state, make_yolo_epoch_fn
    from sfa3d_tpu_torch.runtime.schedules import OptimizerSpec, warmup_cosine_decay_schedule

    rng = np.random.default_rng(SEED + 7)
    split = _yolo_split(rng, 5, YOLO_PARITY_HW)
    idx = rng.integers(0, 5, (YOLO_PARITY_S, YOLO_PARITY_B))
    flips = rng.random((YOLO_PARITY_S, YOLO_PARITY_B)) < 0.5
    flips[0] = [True, False]
    init_sd = YOLOv8("n", YOLO_CLASSES).init_weights(torch.Generator().manual_seed(SEED)).state_dict()
    spec = OptimizerSpec("adamw", warmup_cosine_decay_schedule(0.0, 1e-3, 2, 6, 1e-5), weight_decay=5e-4)
    out, first = {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, dev in (("cpu", torch.device("cpu")), ("gpu", DEVICE)):
            data = {k: torch.from_numpy(v).to(dev) for k, v in split.items()}
            for steps in (1, YOLO_PARITY_S):  # the first step alone, then the epoch
                model = YOLOv8("n", YOLO_CLASSES)
                model.load_state_dict(init_sd)
                model = model.to(dev)
                state = create_train_state(model, spec, ema=True)
                epoch_fn = make_yolo_epoch_fn(model, spec, YOLO_PARITY_HW, ema_decay=0.999, ema_tau=2.0,
                                              device=dev)
                # the elements whose gradient is float32 noise at any step of
                # the epoch (AdamW then moves them by about lr * sign(noise))
                noise = {}

                def mark(p, k):
                    small = (p.grad.abs() <= TRAIN_GRAD_FLOOR * p.grad.abs().max()).cpu()
                    noise[k] = small | noise[k] if k in noise else small

                hooks = [p.register_post_accumulate_grad_hook(lambda p, k=k: mark(p, k))
                         for k, p in model.named_parameters() if p.requires_grad]
                state, metrics = epoch_fn(state, data, torch.from_numpy(idx[:steps]).to(dev),
                                          flips=torch.from_numpy(flips[:steps]).to(dev))
                for h in hooks:
                    h.remove()
                if steps == 1:
                    first[name] = {k: float(v) for k, v in metrics.items()}
            # where AdamW's direction is a near-cancelled sum of gradients of
            # both signs: |mu| under YOLO_CANCELLED_SHARE of sqrt(nu)
            cancelled = {k: (state.optimizer.state[p]["exp_avg"].abs()
                             <= YOLO_CANCELLED_SHARE * state.optimizer.state[p]["exp_avg_sq"].sqrt()).cpu()
                         for k, p in model.named_parameters() if p in state.optimizer.state}
            out[name] = ({k: float(v) for k, v in metrics.items()},
                         {k: v.detach().cpu() for k, v in model.state_dict().items()},
                         noise, {k: v.cpu() for k, v in state.ema_params.items()}, cancelled)
    finally:
        torch.backends.cudnn.deterministic = False
    (cm, csd, cnoise, cema, ccancel), (gm, gsd, _, gema, _) = out["cpu"], out["gpu"]
    terms = ("total", "box", "cls", "dfl")
    step_err = max(abs(first["gpu"][k] - first["cpu"][k]) / abs(first["cpu"][k]) for k in terms)
    loss_err = max(abs(gm[k] - cm[k]) / abs(cm[k]) for k in terms)
    if not step_err <= YOLO_STEP_LOSS_RTOL or first["gpu"]["num_fg"] != first["cpu"]["num_fg"]:
        raise AssertionError(f"YOLO first step: losses GPU vs CPU differ by {step_err} relative "
                             f"({first['gpu']} vs {first['cpu']})")
    if not loss_err <= YOLO_EPOCH_LOSS_RTOL or gm["num_fg"] != cm["num_fg"]:
        raise AssertionError(f"YOLO epoch: losses GPU vs CPU differ by {loss_err} relative ({gm} vs {cm})")
    largest_change = max((csd[k] - init_sd[k]).abs().max().item() for k in cnoise)
    param_err, stat_err, excused = 0.0, 0.0, 0
    for k, want in csd.items():
        if k.endswith("num_batches_tracked"):
            if not torch.equal(gsd[k], want):
                raise AssertionError(f"{k} differs")
            continue
        if k in cnoise:
            # AdamW's early updates are about lr * sign(g), and where its
            # direction is a near-cancelled sum, float32 gradient noise moves an
            # element either way (excused, counted)
            noise = cnoise[k] | ccancel[k]
            for what, got_t, want_t in (("parameter", gsd[k], want), ("EMA", gema[k], cema[k])):
                d = (got_t - want_t).abs()
                bad = d > TRAIN_PARAM_SHARE * largest_change
                if (bad & ~noise).any():
                    raise AssertionError(f"YOLO epoch: {what} {k} GPU vs CPU differs by {d.max().item()} "
                                         f"(largest change {largest_change})")
                if what == "parameter":
                    excused += int((bad & noise).sum())
                    param_err = max(param_err, d[~noise].max().item() / largest_change if (~noise).any() else 0.0)
        elif k.endswith(("running_mean", "running_var")):
            rel = (gsd[k] - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
            if rel > TRAIN_STAT_RTOL:
                raise AssertionError(f"YOLO epoch: BatchNorm statistic {k} differs by {rel} relative")
            stat_err = max(stat_err, rel)
    emit({"phase": "yolo_train_parity", "hw": list(YOLO_PARITY_HW), "S": YOLO_PARITY_S, "B": YOLO_PARITY_B,
          "first_step_loss_rtol": YOLO_STEP_LOSS_RTOL, "epoch_loss_rtol": YOLO_EPOCH_LOSS_RTOL,
          "param_and_ema_tol_share_of_largest_change": TRAIN_PARAM_SHARE,
          "bn_stat_rtol_of_tensor_max": TRAIN_STAT_RTOL,
          "excuses_elements_with_a_step_grad_below_share_of_tensor_max": TRAIN_GRAD_FLOOR,
          "excuses_elements_with_abs_mu_below_share_of_sqrt_nu": YOLO_CANCELLED_SHARE,
          "first_step_loss_max_rel_err": step_err, "epoch_loss_max_rel_err": loss_err,
          "param_max_err_share_of_largest_change": param_err,
          "largest_change": largest_change, "bn_stat_max_rel_err": stat_err, "elements_excused": excused,
          "losses_cpu": cm, "card": card["nvidia_smi"]})


def card_state() -> str:
    """The card's SM clock, power draw and temperature now (nvidia-smi)."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                           "--format=csv,noheader"], capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def phase_yolo_train(card, root, ck_dir):
    """The YOLO training path at full width through the entry points a user
    calls: the yolo-train CLI's defaults (YOLOv8n, 192 x 640, batch 16, 3
    classes, AdamW, EMA) over the mini-KITTI's 64 camera frames (51 train,
    13 val), YOLO_EPOCHS epochs with an eval pass and 2D mAP after each;
    then the same entry points (load_yolo2d_split, yolo_adamw,
    create_train_state, make_yolo_epoch_fn) timed step by step with CUDA
    events, and 8 steps on one batch, which must lower its loss. Returns the
    val split, the CLI's hard_nms_keep launches and its best.pt."""
    import math
    import os

    from sfa3d_tpu_torch.cli import yolo_train as ycli
    from sfa3d_tpu_torch.data.yolo2d import as_hw, list_sample_ids, load_yolo2d_split
    from sfa3d_tpu_torch.parallel.yolo_step import create_train_state, make_yolo_epoch_fn
    from sfa3d_tpu_torch.runtime.schedules import OptimizerSpec, warmup_cosine_decay_schedule, yolo_adamw

    args = ycli.parse_args(["--dataset_dir", root])
    hw = as_hw(ycli.parse_imgsz(args.imgsz))
    if (hw, args.batch_size, args.scale, args.num_classes) != ((192, 640), 16, "n", YOLO_CLASSES):
        raise AssertionError("the yolo-train CLI's defaults are not 192 x 640, batch 16, YOLOv8n, 3 classes")
    fusion_loops.hard_nms_keep.launches = 0  # the CLI's eval passes
    t0 = time.perf_counter()
    report = ycli.main(["--dataset_dir", root, "--epochs", str(YOLO_EPOCHS), "--eval_every", "1",
                        "--checkpoints_dir", ck_dir, "--seed", str(SEED)])
    cli_s = time.perf_counter() - t0
    cli_launches = fusion_loops.hard_nms_keep.launches
    eval_batches = math.ceil(report["val_frames"] / args.eval_batch)
    if cli_launches != YOLO_EPOCHS * eval_batches:
        raise AssertionError(f"hard_nms_keep launched {cli_launches} times in {YOLO_EPOCHS} eval passes "
                             f"of {eval_batches} batches")
    losses = [row["loss"] for row in report["history"]]
    if len(losses) != YOLO_EPOCHS or not all(np.isfinite(v) for row in losses for v in row.values()):
        raise AssertionError(f"YOLO CLI losses: {losses}")

    ids = list_sample_ids(root)
    n_val = report["val_frames"]
    train = load_yolo2d_split(root, imgsz=hw, max_boxes=args.max_boxes, sample_ids=ids[:-n_val])
    val = load_yolo2d_split(root, imgsz=hw, max_boxes=args.max_boxes, sample_ids=ids[-n_val:])
    data = {k: torch.from_numpy(v).to(DEVICE) for k, v in train.items() if k != "ids"}
    n_train = train["images"].shape[0]
    steps_per_epoch = n_train // args.batch_size
    model = YOLOv8(args.scale, args.num_classes).init_weights(torch.Generator().manual_seed(SEED)).to(DEVICE)
    tx = yolo_adamw(args.lr, args.weight_decay, args.warmup_epochs, YOLO_EPOCHS, steps_per_epoch)
    state = create_train_state(model, tx, ema=True)
    epoch_fn = make_yolo_epoch_fn(model, tx, hw, ema_decay=args.ema_decay, ema_tau=args.ema_tau, device=DEVICE)
    rng = np.random.default_rng(SEED)
    gen = torch.Generator().manual_seed(SEED)
    idx = np.stack([rng.permutation(n_train)[: args.batch_size] for _ in range(YOLO_TIMED_STEPS + 1)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state_before = card_state()
    ms, wall, step_losses = [], [], []
    for s in range(YOLO_TIMED_STEPS + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        state, metrics = epoch_fn(state, data, torch.from_numpy(idx[s:s + 1]), generator=gen)
        end.record()
        end.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)
        ms.append(start.elapsed_time(end))
        step_losses.append(float(metrics["total"]))
    peak = torch.cuda.max_memory_allocated()
    card_during = {"before": state_before, "after": card_state(), "host_threads": threading.active_count()}
    # one more step under the profiler: host time of each part of the step,
    # the kernels' device time and launches (is the step host-bound?)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        state, _ = epoch_fn(state, data, torch.from_numpy(idx[:1]), generator=gen)
        torch.cuda.synchronize()
    prof_wall = (time.perf_counter() - t) * 1e3
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    ranges = ("yolo.", "Optimizer.")  # the step's parts and the optimizer's own range, not kernels
    host_by_part = {}
    for e in prof.events():
        if e.device_type == cpu and e.name.startswith("yolo."):
            host_by_part[e.name] = host_by_part.get(e.name, 0.0) + e.cpu_time_total / 1e3
    kernels = sorted(((self_device_us(e), e.key, e.count) for e in prof.key_averages()
                      if e.device_type == cuda and self_device_us(e) > 0 and not e.key.startswith(ranges)),
                     reverse=True)
    step_profile = {"wall_ms_profiled": prof_wall, "host_ms_by_part": host_by_part,
                    "kernel_device_ms": sum(us for us, _, _ in kernels) / 1e3,
                    "kernel_launches": sum(n for _, _, n in kernels),
                    "top_kernels": [[k[:80], us / 1e3, n] for us, k, n in kernels[:8]]}
    if not np.isfinite(step_losses).all():
        raise AssertionError(f"non-finite YOLO training loss: {step_losses}")
    steady = statistics.median(ms[1:])

    # 8 steps on one batch lower its loss (a fresh model, no flips)
    ov_model = YOLOv8(args.scale, args.num_classes).init_weights(torch.Generator().manual_seed(SEED + 1))
    ov_model = ov_model.to(DEVICE)
    ov_spec = OptimizerSpec("adamw", warmup_cosine_decay_schedule(0.0, 1e-3, 1, 50, 1e-5), weight_decay=args.weight_decay)
    ov_state = create_train_state(ov_model, ov_spec)
    ov_epoch = make_yolo_epoch_fn(ov_model, ov_spec, hw, device=DEVICE)
    overfit = []
    for _ in range(8):
        ov_state, m = ov_epoch(ov_state, data, torch.from_numpy(idx[:1]),
                               flips=torch.zeros(1, args.batch_size, dtype=torch.bool))
        overfit.append(float(m["total"]))
    if not (np.isfinite(overfit).all() and overfit[-1] < overfit[0]):
        raise AssertionError(f"8 steps on one batch did not lower its loss: {overfit}")
    emit({"phase": "yolo_train", "hw": list(hw), "batch_size": args.batch_size, "scale": args.scale,
          "classes": args.num_classes, "train_frames": n_train, "val_frames": n_val, "cli_epochs": YOLO_EPOCHS,
          "cli_steps_per_epoch": steps_per_epoch, "cli_seconds": cli_s, "cli_history": report["history"],
          "cli_hard_nms_keep_launches": cli_launches, "cli_eval_batches_per_pass": eval_batches,
          "step_ms": ms, "step_ms_median_after_first": steady, "step_wall_ms": wall,
          "frames_per_s_device": args.batch_size / (steady / 1e3),
          "frames_per_s_end_to_end": YOLO_TIMED_STEPS * args.batch_size / (sum(wall[1:]) / 1e3),
          "max_memory_allocated_bytes": peak, "sm_clock_power_temperature": card_during,
          "step_profile": step_profile,
          "losses": step_losses, "overfit_losses": overfit,
          "card": card["nvidia_smi"]})
    return val, cli_launches, os.path.join(ck_dir, "best.pt")


def phase_yolo_eval(card, val, best_path):
    """The eval pass of the trained weights: best.pt through
    load_yolo_checkpoint, the val split through make_yolo_eval_fn in batches
    of 8 (the tail padded) on the card, one hard_nms_keep launch per batch;
    every batch's detections equal the CPU path (select_detections with the
    plain NMS) fed the card's network outputs and their decode, and so does
    the 2D mAP; the CPU's own decode of those outputs within the printed
    tolerances; the card's NMS at the eval's shape (8 x 512) equals the plain
    version bit for bit, timed. Returns the (8, 512) record and the pass's
    launches."""
    import math

    from sfa3d_tpu_torch.cli.yolo_train import evaluate
    from sfa3d_tpu_torch.eval.map2d import evaluate_map2d
    from sfa3d_tpu_torch.models.yolov8 import load_yolo_checkpoint
    from sfa3d_tpu_torch.parallel.yolo_step import make_yolo_eval_fn

    model = load_yolo_checkpoint(best_path).to(DEVICE)
    eval_fn = make_yolo_eval_fn(model, device=DEVICE)
    seen = []  # the network's outputs of every eval batch, on the host
    hook = model.register_forward_hook(lambda mod, a, out: seen.append([(b.cpu(), c.cpu()) for b, c in out]))
    val_dev = {**val, "images": torch.from_numpy(val["images"]).to(DEVICE)}
    batch = YOLO_NMS_SHAPE[0]
    fusion_loops.hard_nms_keep.launches = 0  # the eval pass: the main path
    got_map = evaluate(eval_fn, val_dev, batch, YOLO_CLASSES)
    launches = fusion_loops.hard_nms_keep.launches
    hook.remove()
    n = val["images"].shape[0]
    if launches != math.ceil(n / batch) or len(seen) != launches:
        raise AssertionError(f"hard_nms_keep launched {launches} times for {math.ceil(n / batch)} eval batches")

    # the CPU path fed the card's network outputs, batch by batch: the
    # selection (top-k, class-offset NMS with the plain loop, top 100) on the
    # card's decoded boxes and scores must equal the card's bit for bit; the
    # CPU's own decode of the same outputs differs by libm ulps (exp, the
    # 16-bin sums), held within YOLO_DECODE_ATOL / YOLO_SCORE_ATOL, and the
    # detections that difference changes are counted
    dets_cpu, decode_err, score_err, n_valid, full_cpu_diff = [], 0.0, 0.0, 0, 0
    for bi, levels_cpu in enumerate(seen):
        imgs = val_dev["images"][bi * batch:(bi + 1) * batch]
        if imgs.shape[0] < batch:
            imgs = torch.cat([imgs, imgs[-1:].expand(batch - imgs.shape[0], *imgs.shape[1:])], 0)
        nhwc = [(b.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1)) for b, c in levels_cpu]
        with torch.no_grad():
            gpu = [t.cpu() for t in eval_fn(imgs)]
            boxes_g, scores_g = decode_predictions([(b.to(DEVICE), c.to(DEVICE)) for b, c in nhwc])
            cpu = select_detections(boxes_g.cpu(), scores_g.cpu(), conf_thresh=0.001, iou_thresh=0.45,
                                    max_det=100, pre_nms=512)
            boxes_c, scores_c = decode_predictions(nhwc)
            full = select_detections(boxes_c, scores_c, conf_thresh=0.001, iou_thresh=0.45, max_det=100,
                                     pre_nms=512)
        decode_err = max(decode_err, ((boxes_g.cpu() - boxes_c).abs()
                                      / (YOLO_DECODE_ATOL + YOLO_DECODE_RTOL * boxes_c.abs())).max().item())
        score_err = max(score_err, (scores_g.cpu() - scores_c).abs().max().item())
        if not all(torch.equal(g, c) for g, c in zip(gpu, cpu)):
            raise AssertionError(f"eval batch {bi}: the card's detections differ from the CPU selection of the "
                                 f"same decoded outputs ({int(gpu[3].sum())} vs {int(cpu[3].sum())} valid)")
        full_cpu_diff += int((full[3] != gpu[3]).sum()) + int(((full[2] != gpu[2]) & gpu[3]).sum())
        n_valid += int(gpu[3].sum())
        for j in range(min(batch, n - bi * batch)):
            keep = cpu[3][j].numpy() & (cpu[1][j].numpy() > 0.0)
            dets_cpu.append({"boxes": cpu[0][j].numpy()[keep], "scores": cpu[1][j].numpy()[keep],
                             "classes": cpu[2][j].numpy()[keep]})
    if decode_err > 1.0 or score_err > YOLO_SCORE_ATOL:
        raise AssertionError(f"decode card vs CPU on the same outputs: boxes {decode_err} of their tolerance, "
                             f"scores {score_err}")
    gts = [{"boxes": val["boxes"][i][val["mask"][i]], "classes": val["labels"][i][val["mask"][i]]}
           for i in range(n)]
    want_map = evaluate_map2d(dets_cpu, gts, num_classes=YOLO_CLASSES)
    map_err = max((abs(got_map[k] - want_map[k]) for k in want_map if not np.isnan(want_map[k])), default=0.0)
    if map_err > AP_TOL:
        raise AssertionError(f"2D mAP card vs CPU: {got_map} vs {want_map}")

    # the NMS kernel at the eval's shape, on the inputs the eval pass gives
    # it (recorded from one eval batch), bit for bit, and its times
    from sfa3d_tpu_torch.fusion import nms as nms_module

    imgs = val_dev["images"][:batch]
    given = []
    nms_module.fusion_loops = types.SimpleNamespace(  # hard_nms's view of the kernel module, recording
        hard_nms_keep=lambda b, v, thr: given.append((b.clone(), v.clone())) or fusion_loops.hard_nms_keep(b, v, thr))
    eval_fn(imgs)
    nms_module.fusion_loops = fusion_loops
    (sboxes, svalid), = given
    if tuple(sboxes.shape[:2]) != YOLO_NMS_SHAPE:
        raise AssertionError(f"the eval's NMS input is {tuple(sboxes.shape[:2])}, not {YOLO_NMS_SHAPE}")
    call = lambda: fusion_loops.hard_nms_keep(sboxes, svalid, 0.45)  # noqa: E731
    plain = lambda: fusion_loops.hard_nms_keep_plain(sboxes, svalid, 0.45)  # noqa: E731
    keep = plain()
    err = max_abs_err(call(), keep)
    if err != 0:
        raise AssertionError(f"hard_nms_keep at {YOLO_NMS_SHAPE} differs from its plain version by {err}")
    kept_before = torch.cumsum(keep.int(), 1) - keep.int()
    n_iou = int((kept_before * svalid).sum().item())
    bytes_moved = sboxes.numel() * 4 + 2 * svalid.numel()
    bound, bound_by = loop_bound(bytes_moved, n_iou)
    dms = device_ms(call, kernel=LOOP_ENTRIES["hard_nms_keep"][1])
    if dms is None:
        raise AssertionError("the profiler saw no hard_nms_keep_kernel launch at the eval's shape")
    shape_rec = {"shape": list(YOLO_NMS_SHAPE), "valid_candidates": int(svalid.sum().item()),
                 "kept": int(keep.sum().item()), "max_abs_err": err, "ms": cuda_ms(call), "device_ms": dms,
                 "plain_ms": cuda_ms(plain, reps=5, warmup=1), "bound_ms": bound, "bound_by": bound_by,
                 "ious_needed": n_iou, "bytes": bytes_moved, "dependent_steps": dependent_steps(svalid)}
    eval_ms = cuda_ms(lambda: eval_fn(imgs), reps=10)
    emit({"phase": "yolo_eval", "checkpoint": "best.pt via load_yolo_checkpoint", "val_frames": n,
          "eval_batches": launches, "hard_nms_keep_launches": launches, "valid_detections": n_valid,
          "decode_box_max_err_share_of_tol": decode_err, "decode_score_max_abs_err": score_err,
          "slots_differing_on_the_cpu_decode": full_cpu_diff, "box_atol": YOLO_DECODE_ATOL,
          "box_rtol": YOLO_DECODE_RTOL, "score_atol": YOLO_SCORE_ATOL, "map2d": got_map, "map2d_max_err": map_err,
          "eval_ms_per_batch": eval_ms, "hard_nms_keep_at_eval_shape": shape_rec, "card": card["nvidia_smi"]})
    return shape_rec, launches


def _iou_boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, 0], b[:, 1], b[:, 2] = rng.uniform(0, 10, n), rng.uniform(-5, 5, n), rng.uniform(-2, 0, n)
    b[:, 3], b[:, 4], b[:, 5] = rng.uniform(1, 2, n), rng.uniform(0.5, 3, n), rng.uniform(0.5, 5, n)
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _seeded_eval_frames(rng, n_frames=16):
    """Ground truth with difficulty levels and detections near it (jittered
    by 0.15 m) plus far false positives with projected heights: every class,
    bucket and the height rule see work. Returns (detections, ground truths)."""
    dets, gts = [], []
    for _ in range(n_frames):
        m = int(rng.integers(2, 8))
        g = _iou_boxes(rng, m)
        g[:, 0], g[:, 1] = rng.uniform(5, 45, m), rng.uniform(-15, 15, m)
        cls = rng.integers(0, 3, m)
        gts.append({"boxes": g, "classes": cls, "difficulty": rng.integers(1, 5, m)})
        extra = _iou_boxes(rng, 3)
        extra[:, 0] += 10
        d = np.concatenate([g + rng.normal(0, 0.15, g.shape).astype(np.float32), extra]).astype(np.float32)
        dets.append({"boxes": d, "scores": rng.uniform(0.1, 1.0, len(d)).astype(np.float32),
                     "classes": np.concatenate([cls, rng.integers(0, 3, 3)]),
                     "heights": rng.uniform(10, 80, len(d)).astype(np.float32)})
    return dets, gts


def _flat_results(res, prefix=""):
    out = {}
    for k, v in res.items():
        if isinstance(v, dict):
            out.update(_flat_results(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = float(v)
    return out


def phase_kitti_eval(card, root, tmp_root):
    """The KITTI AP evaluation through its CLI (sfa3d_tpu_torch.cli.eval) on
    the card and with --platform cpu, on one KFPN-18 checkpoint (random
    weights, heatmap biases bumped so that detections exist) and
    KITTI_EVAL_FRAMES val frames: every AP, AOS and Easy / Moderate / Hard
    number within AP_TOL; bev_raster_reduce launched once per frame on the
    card; the rotated BEV and 3D IoU on the card within ROT_IOU_TOL of the
    CPU on seeded boxes."""
    import os

    from sfa3d_tpu_torch.cli import eval as eval_cli
    from sfa3d_tpu_torch.data.kitti import KittiDataset
    from sfa3d_tpu_torch.eval import evaluate_kitti_ap
    from sfa3d_tpu_torch.ops.rotated_iou import pairwise_iou_3d, pairwise_iou_bev_rotated
    from sfa3d_tpu_torch.pipeline import detect_frames

    model = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(SEED))
    bump_heatmap_bias(model)
    ckpt = os.path.join(tmp_root, "kfpn_eval.pth")
    torch.save(model.state_dict(), ckpt)
    args = ["--dataset_dir", root, "--pretrained_path", ckpt, "--num_samples", str(KITTI_EVAL_FRAMES)]
    bev_raster_reduce.launches = 0  # the card's eval run: the main path
    t0 = time.perf_counter()
    res_gpu = eval_cli.main(args)
    gpu_s = time.perf_counter() - t0
    launches = bev_raster_reduce.launches
    if launches != KITTI_EVAL_FRAMES:
        raise AssertionError(f"bev_raster_reduce launched {launches} times for {KITTI_EVAL_FRAMES} frames")
    t0 = time.perf_counter()
    res_cpu = eval_cli.main(args + ["--platform", "cpu"])
    cpu_s = time.perf_counter() - t0
    got, want = _flat_results(res_gpu), _flat_results(res_cpu)
    if got.keys() != want.keys():
        raise AssertionError(f"AP keys differ: {sorted(got)} vs {sorted(want)}")
    ap_err = max(abs(got[k] - want[k]) for k in want)
    if ap_err > AP_TOL:
        raise AssertionError(f"KITTI AP card vs CPU differs by {ap_err}: {got} vs {want}")
    # the evaluator alone on detections near the ground truth, where AP is
    # not 0: the IoU matrices on the card against the CPU
    seeded = _seeded_eval_frames(np.random.default_rng(SEED + 8))
    seeded_err = {}
    for metric in ("3d", "bev"):
        g_res = _flat_results(evaluate_kitti_ap(*seeded, metric=metric, with_aos=True, device=DEVICE))
        c_res = _flat_results(evaluate_kitti_ap(*seeded, metric=metric, with_aos=True, device="cpu"))
        seeded_err[metric] = max(abs(g_res[k] - c_res[k]) for k in c_res)
        if seeded_err[metric] > AP_TOL or not 0 < c_res["mAP"] < 1 or g_res.keys() != c_res.keys():
            raise AssertionError(f"seeded {metric} AP card vs CPU: {g_res} vs {c_res}")
    sample = KittiDataset(root, mode="val", hflip_prob=0.0, num_samples=1)[0]
    n_det = int(detect_frames(model.to(DEVICE).eval(), sample.points[None], sample.valid[None],
                              device=DEVICE)["mask"].sum())
    if n_det == 0:
        raise AssertionError("the eval's first frame has no detection")
    rng = np.random.default_rng(SEED + 9)
    a, b = _iou_boxes(rng, 256), _iou_boxes(rng, 256)
    iou_err = {}
    for name, fn, cols in (("3d", pairwise_iou_3d, slice(None)), ("bev", pairwise_iou_bev_rotated, [0, 1, 4, 5, 6])):
        g = fn(torch.from_numpy(a[:, cols]).to(DEVICE), torch.from_numpy(b[:, cols]).to(DEVICE)).cpu()
        c = fn(torch.from_numpy(a[:, cols]), torch.from_numpy(b[:, cols]))
        iou_err[name] = (g - c).abs().max().item()
        if iou_err[name] > ROT_IOU_TOL or int((c > 0).sum()) < 1000:
            raise AssertionError(f"rotated {name} IoU card vs CPU differs by {iou_err[name]}")
    emit({"phase": "kitti_eval", "frames": KITTI_EVAL_FRAMES, "detections_first_frame": n_det,
          "ap_tol": AP_TOL, "ap_max_abs_err": ap_err, "results": got, "seeded_ap_max_abs_err": seeded_err,
          "seeded_map": c_res["mAP"], "card_seconds": gpu_s,
          "card_seconds_per_frame": gpu_s / KITTI_EVAL_FRAMES, "cpu_seconds": cpu_s,
          "bev_raster_reduce_launches": launches, "rotated_iou_tol": ROT_IOU_TOL,
          "rotated_iou_max_abs_err": iou_err, "card": card["nvidia_smi"]})
    return launches


# ---------------------------------------------------------------------------
# tracking and the serve CLI
# ---------------------------------------------------------------------------

TRACK_K, TRACK_T = 50, 64  # the serve CLI's K detections and the tracker's max_tracks
TRACK_IOU_MIN = 0.01  # the serve CLI's --track_iou_min default
TRACK_FRAMES, TRACK_OBJECTS = 30, 20  # the track phase's seeded moving scene
TRACK_TOL = 1e-3  # track boxes, velocities, scores card vs CPU (m, rad, m/frame): cuBLAS / cuSOLVER vs MKL / LAPACK rounding
LONG_STREAM_FRAMES, LONG_STREAM_OBJECTS = 1000, 30  # the track phase's long stream with births and deaths
SERVE_STREAMS, SERVE_FRAMES = 2, 8  # the serve_cli phase: ordered frames per stream
DIM_BIAS = (1.5, 1.6, 3.9)  # m added to the KFPN's dim biases: car-sized boxes (random weights give millimetres)
ASSOC_KERNEL = r"track_associate_(matrix|row)_kernel"  # either design of csrc/track_associate.cu
ASSOC_DESIGN_KERNELS = {"matrix": "track_associate_matrix_kernel", "row": "track_associate_row_kernel"}
ASSOC_IOU_MINS = (TRACK_IOU_MIN, 0.0, -1.0, -2.0)  # at -1 and below, used and ineligible columns match too
TRACK_SEEDED = {"served_1x50x64": (1, TRACK_K, TRACK_T, "crowded"), "batch_8x50x64": (8, TRACK_K, TRACK_T, "crowded"),
                "ineligible_8x50x64": (8, TRACK_K, TRACK_T, "ineligible"),
                "max_tracks_1x50x256": (1, TRACK_K, 256, "crowded")}  # name -> (B, K, T, kind of track_iou_inputs)
ASSOC_TIMED = ("served_1x50x64", "batch_8x50x64", "max_tracks_1x50x256")
ASSOC_ENQUEUE_CALLS = 200  # calls per host enqueue timing, with no synchronisation between them


def track_iou_inputs(rng, b, k, t, kind):
    """(iou (b, k, t) float32 gated like the tracker's, order (b, k) int32):
    'crowded' mixes ineligible pairs (-1), exact ties on a few levels, values
    at iou_min and a few tracks that are every detection's best; 'ineligible'
    is all -1."""
    if kind == "ineligible":
        iou = np.full((b, k, t), -1.0, np.float32)
    else:
        iou = rng.uniform(0, 1, (b, k, t)).astype(np.float32)
        levels = np.float32([0.0, np.float32(TRACK_IOU_MIN), 0.25, 0.5, 0.9])
        tie = rng.random((b, k, t)) < 0.3
        iou[tie] = rng.choice(levels, int(tie.sum()))
        iou[rng.random((b, k, t)) < 0.4] = -1.0
        hot = rng.integers(0, t, (b, 3))
        for f in range(b):
            iou[f][:, hot[f]] = np.float32(0.95)  # crowded: tied best columns
    order = np.stack([rng.permutation(k) for _ in range(b)]).astype(np.int32)
    return iou, order


def track_seeded_inputs():
    """{name: (iou, order)}: the seeded association inputs of track_kernels,
    as track_iou_inputs makes them from one generator."""
    rng = np.random.default_rng(SEED + 11)
    return {name: track_iou_inputs(rng, b, k, t, kind) for name, (b, k, t, kind) in TRACK_SEEDED.items()}


def track_crafted_inputs(rng):
    """{name: (iou (1, k, t) float32, order (1, k) int32)}: crafted
    association cases of the kinds tests/test_torch_tracking.py crafts (this
    script imports no test): ties on a few levels, every pair ineligible, one
    track every detection's best, values at iou_min and a hair under, signed
    zeros, quiet NaNs of both signs (a row of only NaNs, NaNs beside values
    above iou_min), infinities, values below -1, more detections than tracks
    and fewer, T off a multiple of 32, T = 256, and T = 300 (past the matrix
    design: the wrapper takes the row design)."""
    f32 = np.float32
    k, t = 12, 16
    cases = {"ties": rng.choice(f32([-1.0, 0.0, 0.005, 0.01, 0.3, 0.7]), (k, t)),
             "all_ineligible": np.full((k, t), -1.0, f32),
             "zeros_signed": rng.choice(f32([-0.0, 0.0]), (k, t)),
             "inf_signed": rng.choice(f32([-np.inf, np.inf, -1.0, 0.3, 0.3, 0.9]), (k, t)),
             "below_minus_one": rng.choice(f32([-7.5, -2.0, -1.5, -1.0, 0.02]), (k, t))}
    crowd = rng.uniform(0.0, 0.5, (k, t)).astype(f32)
    crowd[:, 3] = 0.9
    cases["crowded"] = crowd
    at = np.full((k, t), -1.0, f32)
    at[::2, ::3] = f32(TRACK_IOU_MIN)
    at[1::2, 1::3] = np.nextafter(f32(TRACK_IOU_MIN), f32(0))
    cases["at_iou_min"] = at
    nan = rng.uniform(-1.0, 1.0, (k, t)).astype(f32)
    nan[rng.random((k, t)) < 0.3] = f32(np.nan)
    nan[rng.random((k, t)) < 0.15] = -f32(np.nan)
    nan[2] = f32(np.nan)
    nan[5, ::2] = -f32(np.nan)
    nan[5, 1::2] = f32(0.8)
    cases["nan_signed"] = nan
    for name, (kk, tt) in {"k_over_t_20x5": (20, 5), "k_under_t_4x40": (4, 40), "t_33": (12, 33),
                           "t_100": (12, 100), "t_256": (12, 256), "row_design_50x300": (50, 300)}.items():
        m = rng.choice(f32([0.0, 0.01, 0.4, 0.4, 0.95]), (kk, tt))
        m[rng.random((kk, tt)) < 0.5] = -1.0
        m[:, tt - 1] = f32(0.97)  # the last column, past the last full warp of columns
        cases[name] = m
    return {name: (m[None], rng.permutation(m.shape[0]).astype(np.int32)[None]) for name, m in cases.items()}


def assoc_bound(b, k, t):
    bytes_moved = b * k * t * 4 + b * k * 4 * 2 + b * t  # iou and order in, det_match and trk_used out
    ops = 2 * b * k * t  # a select and a compare per (step, column)
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", bytes_moved


def assoc_direct(iou, order, iou_min, design):
    """One launch of `design` ("matrix" or "row") past the wrapper's choice
    by shape, to check and time both designs on the same inputs. Counts no
    launch. Returns (det_match, trk_used)."""
    from sfa3d_tpu_torch.ops import track_associate as ta

    lib, dev = ta._cuda_setup(iou, order)
    err, det_match, trk_used = ta._launch(lib, dev, design, iou, order, iou_min)
    if err != 0:
        raise RuntimeError(f"{ASSOC_DESIGN_KERNELS[design]} launch failed: cudaError {err}")
    return det_match, trk_used


def enqueue_ms(fn, calls: int = ASSOC_ENQUEUE_CALLS) -> float:
    """Host time per fn() call over `calls` calls with no synchronisation
    between them: what the caller's thread pays to enqueue one launch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def phase_track_kernels(card):
    """track_associate's two designs vs the plain version on the card, bit
    for bit on det_match and trk_used, at each iou_min of ASSOC_IOU_MINS:
    seeded inputs (crowded and tied IoUs at (1, 50, 64) and (8, 50, 64),
    every pair ineligible, max_tracks 256) and the crafted ones, each through
    the wrapper (the design its shape takes), the matrix design where it fits
    and the row design. Candidate rows per input and threshold. Then both
    designs timed in turns (matrix, row, row, matrix) at ASSOC_TIMED: device,
    event and host enqueue ms, device time per chain step. Returns the
    kernel record."""
    from sfa3d_tpu_torch.ops.track_associate import (
        MATRIX_SLOTS_PER_LANE,
        track_associate,
        track_associate_candidate_rows,
        track_associate_design,
        track_associate_matrix_smem,
        track_associate_plain,
    )

    inputs = {name: tuple(torch.from_numpy(a).to(DEVICE) for a in arrays)
              for name, arrays in track_seeded_inputs().items()}
    for name, arrays in track_crafted_inputs(np.random.default_rng(SEED + 14)).items():
        inputs[name] = tuple(torch.from_numpy(a).to(DEVICE) for a in arrays)
    limit = shared_memory_limit(DEVICE)
    checks = {}
    for name, (iou, order) in inputs.items():
        b, k, t = iou.shape
        designs = ["row"]
        if t <= 32 * MATRIX_SLOTS_PER_LANE and track_associate_matrix_smem(k, t) <= limit:
            designs.append("matrix")
        by_min = {}
        for iou_min in ASSOC_IOU_MINS:
            want = track_associate_plain(iou, order, iou_min)
            runs = {"wrapper": track_associate(iou, order, iou_min),
                    **{d: assoc_direct(iou, order, iou_min, d) for d in designs}}
            torch.cuda.synchronize()
            for route, got in runs.items():
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"track_associate ({route}) disagrees with its plain version on {name} "
                                         f"at iou_min {iou_min}")
            by_min[str(iou_min)] = {"matches": int((want[0] >= 0).sum().item()),
                                    "candidate_rows": track_associate_candidate_rows(iou, iou_min).sum(1).tolist()}
        checks[name] = {"shape": [b, k, t], "wrapper_design": track_associate_design(k, t, limit),
                        "routes": ["wrapper", *designs], "by_iou_min": by_min}
    at_min = lambda name: checks[name]["by_iou_min"][str(TRACK_IOU_MIN)]  # noqa: E731
    if at_min("ineligible_8x50x64")["matches"] != 0 or at_min("served_1x50x64")["matches"] == 0 \
            or checks["served_1x50x64"]["wrapper_design"] != "matrix" \
            or checks["max_tracks_1x50x256"]["wrapper_design"] != "matrix" \
            or checks["row_design_50x300"]["wrapper_design"] != "row":
        raise AssertionError(f"the association inputs exercised nothing, or not both designs: {checks}")

    times = {}
    for name in ASSOC_TIMED:
        iou, order = inputs[name]
        b, k, t = iou.shape
        bound_ms, bound_by, bytes_moved = assoc_bound(b, k, t)
        cand = at_min(name)["candidate_rows"]
        calls = {"matrix": lambda: assoc_direct(iou, order, TRACK_IOU_MIN, "matrix"),
                 "row": lambda: assoc_direct(iou, order, TRACK_IOU_MIN, "row")}
        got = {d: {"device_ms": [], "ms": [], "enqueue_ms": []} for d in calls}
        for d in ("matrix", "row", "row", "matrix"):
            dms = device_ms(calls[d], kernel=ASSOC_DESIGN_KERNELS[d])
            if dms is None:
                raise AssertionError(f"the profiler saw no {ASSOC_DESIGN_KERNELS[d]} launch at {name}")
            got[d]["device_ms"].append(dms)
            got[d]["ms"].append(cuda_ms(calls[d]))
            got[d]["enqueue_ms"].append(enqueue_ms(calls[d]))
        wrapper = lambda: track_associate(iou, order, TRACK_IOU_MIN)  # noqa: E731
        wrapper_device = device_ms(wrapper, kernel=ASSOC_KERNEL)
        if wrapper_device is None:
            raise AssertionError(f"the profiler saw no {ASSOC_KERNEL} launch through the wrapper at {name}")
        got["matrix"]["wrapper_device_ms"] = wrapper_device
        got["matrix"]["wrapper_ms"] = cuda_ms(wrapper)
        got["matrix"]["wrapper_enqueue_ms"] = enqueue_ms(wrapper)
        for d, steps in (("matrix", max(cand)), ("row", k)):
            got[d]["chain_steps"] = steps
            got[d]["per_step_us"] = [x * 1e3 / max(steps, 1) for x in got[d]["device_ms"]]
        times[name] = {"shape": [b, k, t], "candidate_rows": cand, "bound_ms": bound_ms, "bound_by": bound_by,
                       "bytes": bytes_moved, **got}
    iou, order = inputs["served_1x50x64"]
    served = times["served_1x50x64"]
    device = statistics.median(served["matrix"]["device_ms"])
    rec = {
        "name": "track_associate", "route": "cuda", "source": "sfa3d_tpu_torch/csrc/track_associate.cu",
        "replaces": "sfa3d_tpu/tracking/tracker.py:131", "launches": None, "max_abs_err": 0.0,
        "ms": served["matrix"]["wrapper_ms"], "device_ms": device,
        "plain_ms": cuda_ms(lambda: track_associate_plain(iou, order, TRACK_IOU_MIN), reps=5, warmup=1),
        "bound_ms": served["bound_ms"], "bound_by": served["bound_by"], "library_ms": None,
        "library": "none: no single PyTorch call computes a greedy sequential assignment",
        "bound_share_device": served["bound_ms"] / device,
        "design": "matrix design (T <= 256 and its keys within the card's shared memory): the frame's IoUs as "
                  "order keys in shared memory, candidate rows screened off the chain, one warp walks them with "
                  "two warp reductions a step; else the row design, one warp reading a row a step",
        "row_design_device_ms": statistics.median(served["row"]["device_ms"]),
        "shape": [1, TRACK_K, TRACK_T], "dependent_steps": served["matrix"]["chain_steps"], "times_by_shape": times,
    }
    emit({"phase": "track_kernels", "checks": checks, "times": times, "plain_ms": rec["plain_ms"],
          "card": card["nvidia_smi"]})
    return rec


def make_track_scene(rng, n_frames=TRACK_FRAMES, n_objects=TRACK_OBJECTS, k=TRACK_K):
    """A seeded moving scene: objects of three classes at constant velocity
    (0.2-1.2 m a frame), detections jittered from the ground truth by 5 cm,
    10% dropped, 0-4 false positives a frame, one object whose yaw is
    reported pi-flipped every other frame, rows shuffled. Returns (boxes (F,
    K, 8), scores (F, K), valid (F, K), ground truth [(ids, centres)] per
    frame)."""
    dims = np.array([[1.76, 0.66, 0.84], [1.52, 1.63, 3.88], [1.73, 0.60, 1.76]])
    # objects on a grid of lanes, so that no two start on top of each other
    start = np.stack([5.0 + 4.0 * (np.arange(n_objects) % 10), -16.0 + 16.0 * (np.arange(n_objects) // 10)], 1)
    start += rng.uniform(-0.5, 0.5, start.shape)
    speed = rng.uniform(0.2, 1.2, n_objects)
    heading = rng.choice([0.0, np.pi], n_objects) + rng.uniform(-0.1, 0.1, n_objects)
    vel = np.stack([speed * np.cos(heading), 0.05 * speed * np.sin(heading)], 1)
    cls = rng.integers(0, 3, n_objects)
    boxes = np.zeros((n_frames, k, 8), np.float32)
    scores = np.zeros((n_frames, k), np.float32)
    gt = []
    for f in range(n_frames):
        xy = start + vel * f
        rows = []
        for o in range(n_objects):
            if rng.random() < 0.1:
                continue
            yaw = heading[o] + (np.pi if o == 0 and f % 2 else 0.0)
            rows.append([cls[o], *(xy[o] + rng.normal(0, 0.05, 2)), -1.0, *dims[cls[o]], yaw])
        for _ in range(rng.integers(0, 5)):
            rows.append([rng.integers(0, 3), rng.uniform(0, 50), rng.uniform(-25, 25), -1.0, *dims[1],
                         rng.uniform(-np.pi, np.pi)])
        perm = rng.permutation(len(rows))
        boxes[f, :len(rows)] = np.asarray(rows, np.float32)[perm]
        scores[f, :len(rows)] = rng.uniform(0.3, 1.0, len(rows))
        gt.append((np.arange(n_objects), xy))
    valid = np.arange(k)[None] < (scores > 0).sum(1)[:, None]
    return boxes, scores, valid, gt


def make_long_stream(rng, n_frames=LONG_STREAM_FRAMES, k=TRACK_K, max_objects=LONG_STREAM_OBJECTS):
    """A seeded long stream with births and deaths: an object is born with
    probability 0.3 a frame (up to `max_objects` at once) at a random place
    with a random class, speed and heading, dies with probability 0.01 a
    frame or when it leaves x in (0, 50), y in (-25, 25); detections are its
    box jittered by 5 cm, 10% dropped, 0-4 false positives a frame, rows
    shuffled. Returns (boxes (F, K, 8), scores (F, K), valid (F, K), births,
    deaths)."""
    dims = np.array([[1.76, 0.66, 0.84], [1.52, 1.63, 3.88], [1.73, 0.60, 1.76]])
    boxes = np.zeros((n_frames, k, 8), np.float32)
    scores = np.zeros((n_frames, k), np.float32)
    live, births, deaths = [], 0, 0
    for f in range(n_frames):
        if len(live) < max_objects and rng.random() < 0.3:
            heading = rng.uniform(-np.pi, np.pi)
            speed = rng.uniform(0.05, 0.8)
            live.append({"xy": np.array([rng.uniform(5, 45), rng.uniform(-20, 20)]), "cls": int(rng.integers(0, 3)),
                         "v": speed * np.array([np.cos(heading), np.sin(heading)]), "yaw": heading})
            births += 1
        rows = []
        for o in live:
            if rng.random() < 0.1:
                continue
            rows.append([o["cls"], *(o["xy"] + rng.normal(0, 0.05, 2)), -1.0, *dims[o["cls"]], o["yaw"]])
        for _ in range(rng.integers(0, 5)):
            rows.append([rng.integers(0, 3), rng.uniform(0, 50), rng.uniform(-25, 25), -1.0, *dims[1],
                         rng.uniform(-np.pi, np.pi)])
        rows = rows[:k]
        perm = rng.permutation(len(rows))
        if rows:
            boxes[f, :len(rows)] = np.asarray(rows, np.float32)[perm]
            scores[f, :len(rows)] = rng.uniform(0.3, 1.0, len(rows))
        kept = []
        for o in live:
            o["xy"] = o["xy"] + o["v"]
            if rng.random() < 0.01 or not (0 < o["xy"][0] < 50 and -25 < o["xy"][1] < 25):
                deaths += 1
            else:
                kept.append(o)
        live = kept
    valid = np.arange(k)[None] < (scores > 0).sum(1)[:, None]
    return boxes, scores, valid, births, deaths


def long_stream_drift(card_host, cpu_host):
    """Per frame, the largest box difference between two tracker runs over
    slots alive in both; the first frame whose ids, alive or confirmed
    differ (None if none)."""
    first_id_diff = None
    for f in range(card_host["ids"].shape[0]):
        if any(not np.array_equal(card_host[key][f], cpu_host[key][f]) for key in ("ids", "alive", "confirmed")):
            first_id_diff = f
            break
    both = card_host["alive"] & cpu_host["alive"]
    diff = np.where(both[..., None], np.abs(card_host["boxes"] - cpu_host["boxes"]), 0.0).max(axis=(1, 2))
    return diff, first_id_diff


def phase_track(card):
    """The seeded moving scene through track_sequence on the card and on the
    CPU: ids, alive, confirmed and next_id equal, boxes / velocities / scores
    within TRACK_TOL, CLEAR-MOT equal, one track_associate launch a frame;
    ms per tracker_step on both. Then a 1,000-frame seeded stream with births
    and deaths on both, measured and printed, not held to a limit: the
    largest box difference, the frame where it is reached, the first frame
    whose ids or flags differ (none expected)."""
    from sfa3d_tpu_torch.ops.track_associate import track_associate, track_associate_candidate_rows
    from sfa3d_tpu_torch.tracking import clear_mot, track_sequence, tracker_output_to_frames
    from sfa3d_tpu_torch.tracking import tracker as tracker_module

    boxes, scores, valid, gt = make_track_scene(np.random.default_rng(SEED + 12))
    run = lambda device: track_sequence(boxes, scores, valid, max_tracks=TRACK_T, iou_min=TRACK_IOU_MIN,  # noqa: E731
                                        max_age=3, min_hits=2, device=device)
    candidate_rows = []  # the chain's steps in each frame's association

    def counting_associate(iou, order, iou_min):
        candidate_rows.append(int(track_associate_candidate_rows(iou, iou_min).sum().item()))
        return track_associate(iou, order, iou_min)

    track_associate.launches = 0
    tracker_module.track_associate = counting_associate
    try:
        card_out = run(DEVICE)
        torch.cuda.synchronize()
    finally:
        tracker_module.track_associate = track_associate
    launches = track_associate.launches
    cpu_out = run(torch.device("cpu"))
    if launches != TRACK_FRAMES:
        raise AssertionError(f"track_associate launched {launches} times for {TRACK_FRAMES} frames")
    card_host = {k: v.cpu().numpy() for k, v in card_out.items()}
    cpu_host = {k: v.numpy() for k, v in cpu_out.items()}
    for key in ("ids", "alive", "confirmed"):
        if not np.array_equal(card_host[key], cpu_host[key]):
            raise AssertionError(f"track {key} differ between the card and the CPU")
    # every birth is alive in its own frame's output, and ids count up from 0
    next_id = {dev: int(out["ids"].max()) + 1 for dev, out in (("card", card_host), ("cpu", cpu_host))}
    if next_id["card"] != next_id["cpu"]:
        raise AssertionError(f"next_id {next_id}")
    alive = cpu_host["alive"]
    err = {key: float(np.abs(card_host[key][alive] - cpu_host[key][alive]).max()) for key in ("boxes", "velocities", "scores")}
    if max(err.values()) > TRACK_TOL:
        raise AssertionError(f"track floats card vs CPU: {err}")
    mot_card = clear_mot(gt, tracker_output_to_frames(card_out))
    mot_cpu = clear_mot(gt, tracker_output_to_frames(cpu_out))
    # counts and the rates made of them equal; MOTP, a mean distance, within TRACK_TOL
    if {k: v for k, v in mot_card.items() if k != "motp"} != {k: v for k, v in mot_cpu.items() if k != "motp"} \
            or abs(mot_card["motp"] - mot_cpu["motp"]) > TRACK_TOL or mot_card["mota"] <= 0.5:
        raise AssertionError(f"CLEAR-MOT card {mot_card} vs CPU {mot_cpu}")

    card_ms = host_ms(lambda: run(DEVICE), reps=3, warmup=1) / TRACK_FRAMES
    cpu_ms = host_ms(lambda: run(torch.device("cpu")), reps=3, warmup=1) / TRACK_FRAMES
    profile = step_profile(boxes, scores, valid)

    # the long stream: how far the card's Kalman rounding drifts from the CPU's
    lb, ls, lv, births, deaths = make_long_stream(np.random.default_rng(SEED + 14))
    t0 = time.perf_counter()
    long_out = {dev: {k: v.cpu().numpy() for k, v in track_sequence(
        lb, ls, lv, max_tracks=TRACK_T, iou_min=TRACK_IOU_MIN, max_age=3, min_hits=2, device=dev).items()}
        for dev in (DEVICE, torch.device("cpu"))}
    long_s = time.perf_counter() - t0
    drift, first_id_diff = long_stream_drift(long_out[DEVICE], long_out[torch.device("cpu")])
    worst = int(np.argmax(drift))
    long_rec = {"frames": LONG_STREAM_FRAMES, "births": births, "deaths": deaths,
                "tracks": int(long_out[torch.device("cpu")]["ids"].max()) + 1,
                "box_max_abs_diff": float(drift[worst]), "at_frame": worst,
                "box_max_abs_diff_by_100_frames": [float(drift[i:i + 100].max()) for i in range(0, len(drift), 100)],
                "first_frame_ids_or_flags_differ": first_id_diff, "limit": TRACK_TOL, "seconds": long_s}
    print(f"track: long stream of {LONG_STREAM_FRAMES} frames ({births} births, {deaths} deaths): box diff card vs "
          f"CPU {drift[worst]:.3g} m at frame {worst}; ids and flags "
          f"{'equal in every frame' if first_id_diff is None else f'differ from frame {first_id_diff}'}",
          flush=True)
    emit({"phase": "track", "frames": TRACK_FRAMES, "objects": TRACK_OBJECTS, "K": TRACK_K, "max_tracks": TRACK_T,
          "next_id": next_id["cpu"], "track_associate_launches": launches, "candidate_rows_per_frame": candidate_rows,
          "float_max_abs_err": err, "tolerance": TRACK_TOL, "clear_mot": mot_card,
          "motp_abs_err": abs(mot_card["motp"] - mot_cpu["motp"]),
          "ms_per_step_card": card_ms, "ms_per_step_cpu": cpu_ms, "cpu_threads": torch.get_num_threads(),
          "step_profile": profile, "long_stream": long_rec, "card": card["nvidia_smi"]})
    return launches


def step_profile(boxes, scores, valid, steps=10):
    """torch.profiler over `steps` tracker steps on the card, after the
    scene's first 10 frames: kernel launches and device time per step, and
    the PyTorch ops of most host time (where a launch-bound step goes)."""
    from sfa3d_tpu_torch.tracking import init_tracks, tracker_step

    state = init_tracks(TRACK_T, DEVICE)
    step = lambda st, f: tracker_step(st, boxes[f], scores[f], valid[f], iou_min=TRACK_IOU_MIN)[0]  # noqa: E731
    for f in range(10):
        state = step(state, f)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for f in range(10, 10 + steps):
            state = step(state, f)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    device_us = sum(self_device_us(e) for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    ops = sorted((e for e in events if e.key.startswith("aten::")), key=lambda e: -e.self_cpu_time_total)[:8]
    return {"profiled_ms_per_step": wall_ms, "launches_per_step": launches / steps,
            "kernel_device_ms_per_step": device_us / steps / 1e3,
            "top_ops_self_cpu_ms_per_step": {e.key: e.self_cpu_time_total / steps / 1e3 for e in ops},
            "top_ops_calls_per_step": {e.key: e.count / steps for e in ops}}


def bump_dim_bias(model: torch.nn.Module) -> None:
    with torch.no_grad():
        for i in range(3):
            getattr(model, f"fpn{i}_dim")[2].bias += torch.tensor(DIM_BIAS, device=next(model.parameters()).device)


def serve_requests(rng, root):
    """2 streams x 8 ordered frames, interleaved: each stream one make_scan
    scan whose points move by 1 cm of noise a frame (a parked sensor), as
    .bin files; one track_reset on cam0's sixth frame and one bad request."""
    requests = []
    for s in range(SERVE_STREAMS):
        base = make_scan(rng)
        for f in range(SERVE_FRAMES):
            pts = base.copy()
            pts[:, :3] += rng.normal(0, 0.01, (len(pts), 3)).astype(np.float32)
            path = f"{root}/cam{s}_{f:02d}.bin"
            pts.tofile(path)
            requests.append((f, {"id": f"cam{s}-{f}", "lidar": path, "stream": f"cam{s}"}))
    requests = [r for _, r in sorted(requests, key=lambda fr: fr[0])]
    requests[2 * 5]["track_reset"] = True  # cam0's sixth frame
    requests.insert(7, {"id": "bad", "lidar": f"{root}/missing.bin", "stream": "cam1"})
    return requests


def run_serve_cli(argv, requests):
    """python -m sfa3d_tpu_torch.cli.serve in this process, over stdio.
    Returns (replies, the server's stats, seconds)."""
    import io

    from sfa3d_tpu_torch.cli import serve

    stdin = io.StringIO("".join(json.dumps(r) + "\n" for r in requests))
    stdout = io.StringIO()
    t0 = time.perf_counter()
    stats = serve.main(argv, stdin=stdin, stdout=stdout)
    seconds = time.perf_counter() - t0
    return [json.loads(line) for line in stdout.getvalue().splitlines()], stats, seconds


def phase_serve_cli(card, tmp_root):
    """serve --track over stdio on the card against --platform cpu: replies
    in request order, the bad request answered with an error, detections
    within 1e-3, track ids and confirmed flags equal; one bev_raster_reduce
    launch per served batch and one track_associate launch per tracked
    frame. Then ms per bucket-1 batch and frames/s with --track and without,
    one TCP round trip on the card, and --arch resnet_18 card vs CPU."""
    from sfa3d_tpu_torch.cli import serve
    from sfa3d_tpu_torch.models.centernet_deconv import DeconvCenterNet
    from sfa3d_tpu_torch.ops.track_associate import track_associate
    from sfa3d_tpu_torch.runtime.tracking_service import TrackingSessions

    det = Detector(device="cpu", seed=SEED)
    bump_heatmap_bias(det.model)
    bump_dim_bias(det.model)
    ckpt = f"{tmp_root}/Model_fpn_resnet_18_serve.pth"
    torch.save(det.model.state_dict(), ckpt)
    requests = serve_requests(np.random.default_rng(SEED + 13), tmp_root)
    argv = ["--pretrained_path", ckpt, "--track", "--max_delay_ms", "20"]

    bev_raster_reduce.launches = 0  # count the main path's launches only
    track_associate.launches = 0
    replies, stats, card_s = run_serve_cli(argv, requests)
    raster_launches, assoc_launches = bev_raster_reduce.launches, track_associate.launches
    cpu_replies, _, cpu_s = run_serve_cli(argv + ["--platform", "cpu"], requests)

    if [r["id"] for r in replies] != [r["id"] for r in requests]:
        raise AssertionError("replies are not in request order")
    bad = replies[[r["id"] for r in requests].index("bad")]
    if "error" not in bad:
        raise AssertionError(f"the bad request got {bad}")
    tracked = [r for r in replies if "tracks" in r]
    if len(tracked) != SERVE_STREAMS * SERVE_FRAMES or raster_launches != stats["batches"] or \
            assoc_launches != len(tracked):
        raise AssertionError(f"{len(tracked)} tracked replies, {stats['batches']} batches, raster launches "
                             f"{raster_launches}, track_associate launches {assoc_launches}")
    det_err, n_tracks, n_dets = 0.0, 0, 0
    for got, want in zip(replies, cpu_replies):
        if "error" in got:
            continue
        a, b = sorted_rows(got["detections"]), sorted_rows(want["detections"])
        if a.shape != b.shape:
            raise AssertionError(f"{got['id']}: {len(a)} detections on the card, {len(b)} on the CPU")
        det_err = max(det_err, float(np.abs(a - b).max()) if len(a) else 0.0)
        key = lambda t: (t["track_id"], t["confirmed"])  # noqa: E731
        if sorted(map(key, got["tracks"])) != sorted(map(key, want["tracks"])):
            raise AssertionError(f"{got['id']}: track ids or confirmed flags differ from the CPU CLI's")
        n_tracks += len(got["tracks"])
        n_dets += len(a)
    if det_err > 1e-3 or n_tracks == 0:
        raise AssertionError(f"serve --track: detections vs CPU {det_err}, {n_tracks} tracks")
    cut = [r["id"] for r in requests].index("cam0-5")
    ids = lambda rs: {t["track_id"] for r in rs if r.get("stream") == "cam0" for t in r["tracks"]}  # noqa: E731
    before, after = ids(replies[:cut]), ids(replies[cut:])
    if not after or before & after:
        raise AssertionError(f"cam0's scene cut: ids {sorted(before)} before, {sorted(after)} after")

    # ms per bucket-1 batch, --track on against off, on one server
    args = serve._parse(["--pretrained_path", ckpt, "--track"])
    server, sessions = serve.build_server(args)
    try:
        pts, valid = bev_ops.filter_and_pad_points(np.fromfile(requests[0]["lidar"], np.float32).reshape(-1, 4))
        one = lambda: format_detections(server.det.detect_batch(pts[None], valid[None]), 0)  # noqa: E731
        batch_ms_off = host_ms(one)
        batch_ms_on = host_ms(lambda: sessions.update("timing", one()))
        step_ms = host_ms(lambda: sessions.update("timing", replies[0]["detections"]))
    finally:
        server.stop()

    # one TCP round trip on the card
    ready, stop, port = threading.Event(), threading.Event(), []
    thread = threading.Thread(target=serve.main, args=(argv + ["--port", "0"],),
                              kwargs=dict(ready=lambda p: (port.append(p), ready.set()), stop=stop), daemon=True)
    thread.start()
    try:
        if not ready.wait(300):
            raise AssertionError("the TCP server never listened")
        import socket

        with socket.create_connection(("127.0.0.1", port[0]), timeout=300) as conn:
            f = conn.makefile("rw")
            for r in requests[:3]:
                f.write(json.dumps(r) + "\n")
            f.flush()
            tcp = [json.loads(f.readline()) for _ in range(3)]
    finally:
        stop.set()
        thread.join(60)
    if [r["id"] for r in tcp] != [r["id"] for r in requests[:3]] or thread.is_alive():
        raise AssertionError(f"TCP replies {[r.get('id') for r in tcp]}")
    tcp_err = max(float(np.abs(sorted_rows(a["detections"]) - sorted_rows(b["detections"])).max())
                  for a, b in zip(tcp, replies[:3]))
    tcp_ids = [sorted(t["track_id"] for t in r["tracks"]) for r in tcp]
    if tcp_err > 1e-3 or tcp_ids != [sorted(t["track_id"] for t in r["tracks"]) for r in replies[:3]] \
            or not tcp_ids[-1]:
        raise AssertionError(f"TCP replies differ from the stdio run's: detections by {tcp_err}, tracks {tcp_ids}")

    # --arch resnet_18, one batch on the card against the CPU
    deconv = DeconvCenterNet().init_weights(torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(SEED + 1)
        for i in (0, 3, 6):  # He-scaled deconv kernels: the init's N(0, 0.001) gives a flat, tied heatmap
            w = deconv.deconv_layers[i].weight
            w.copy_(torch.randn(w.shape, generator=gen) * (2.0 / (w.shape[0] * 4)) ** 0.5)
        deconv.hm_cen[2].bias += HM_BIAS_BUMP
    deconv_ckpt = f"{tmp_root}/Model_resnet_18_serve.pth"
    torch.save(deconv.state_dict(), deconv_ckpt)
    arch = ["--arch", "resnet_18", "--pretrained_path", deconv_ckpt]
    r18, r18_stats, _ = run_serve_cli(arch, requests[:4])
    r18_cpu, _, _ = run_serve_cli(arch + ["--platform", "cpu"], requests[:4])
    r18_err = 0.0
    for a, b in zip(r18, r18_cpu):
        ra, rb = sorted_rows(a["detections"]), sorted_rows(b["detections"])
        if ra.shape != rb.shape or len(ra) == 0:
            raise AssertionError(f"resnet_18 {a['id']}: {len(ra)} detections on the card, {len(rb)} on the CPU")
        r18_err = max(r18_err, float(np.abs(ra - rb).max()))
    if r18_err > 1e-3:
        raise AssertionError(f"resnet_18 detections card vs CPU differ by {r18_err}")

    emit({"phase": "serve_cli", "requests": len(requests), "streams": SERVE_STREAMS, "frames_per_stream": SERVE_FRAMES,
          "stats": stats, "bev_raster_reduce_launches": raster_launches,
          "raster_launches_per_batch": raster_launches / stats["batches"],
          "track_associate_launches": assoc_launches, "track_associate_launches_per_frame": assoc_launches / len(tracked),
          "detections": n_dets, "tracks_reported": n_tracks, "detections_max_abs_err_vs_cpu": det_err,
          "card_seconds": card_s, "cpu_seconds": cpu_s,
          "batch_ms_bucket1_track_off": batch_ms_off, "batch_ms_bucket1_track_on": batch_ms_on,
          "tracker_update_ms": step_ms, "frames_per_s_bucket1_track_off": 1e3 / batch_ms_off,
          "frames_per_s_bucket1_track_on": 1e3 / batch_ms_on,
          "tcp_max_abs_err_vs_stdio": tcp_err, "resnet_18_max_abs_err_vs_cpu": r18_err,
          "resnet_18_batches": r18_stats["batches"], "card": card["nvidia_smi"]})
    return raster_launches, assoc_launches


# ---------------------------------------------------------------------------
# the Argoverse path
# ---------------------------------------------------------------------------

ARGO_N = 131072  # points a sweep: config/argoverse.py's MAX_POINTS
ARGO_H = ARGO_W = 1000  # the Argoverse raster: 0.1 m cells over +-50 m
ARGO_SHAPES = (1, 16, 64)  # sweeps a call: argoverse_test's one, the CLI's batch of 16, a training step's 4 x 16
ARGO_KERNELS = r"argoverse_band_\w+_kernel|Memset"  # every kernel of the Argoverse entry, and its tables' memset
ARGO_PLAIN_REPS = {1: 10, 16: 5, 64: 3}  # repetitions of the plain and library timings: few where they are slow
ARGO_FRAMES = 64  # the mini-Argoverse: one CLI step of 4 x 16 sweeps an epoch, 4 validation batches
ARGO_TEST_FRAMES = 16  # sweeps through argoverse_test on the card and on the CPU
ARGO_TRAIN_STEPS = 3  # timed steps (one-batch epochs) at the CLI's defaults
ARGO_DENSITY_TOL = 1e-4  # log1p card vs CPU, on the 0-255 scale


def argoverse_kernel_inputs(rng, b, band_rows):
    """The argoverse_kernel phase's (b, ARGO_N) inputs, {name: (row, col, z,
    r)} numpy. "training": about 94k in-range points a sweep, one cell hit
    10,000 times (sweep 3, or the last of fewer), an all-invalid sweep (5,
    where there are more than 5), z and r negative, -0.0, subnormal and NaN
    on 5% of the points. "band_edges": the same values with every point on a
    row where two bands meet, in any of the `band_rows` plans. "one_band":
    every point of a sweep in one band of the first plan (another band a
    sweep), with the hot cell."""
    n = ARGO_N
    special = np.array([-1.5, -0.0, 0.0, 1e-40, -1e-40, 1.4e-45, np.nan], np.float32)
    hot = min(3, b - 1)

    def values(lo, hi):
        v = rng.uniform(lo, hi, (b, n)).astype(np.float32)
        pick = rng.random((b, n)) < 0.05
        v[pick] = rng.choice(special, int(pick.sum()))
        return v

    row = rng.integers(0, ARGO_H, (b, n)).astype(np.int32)
    col = rng.integers(0, ARGO_W, (b, n)).astype(np.int32)
    drop = rng.random((b, n)) < 0.24
    row[drop] = col[drop] = -1
    row[hot, :10000], col[hot, :10000] = 500, 321
    if b > 5:
        row[5] = col[5] = -1
    z, r = values(-3.0, 5.0), values(-0.1, 1.0)
    edges = np.array(sorted({e for t in band_rows for m in range(t, ARGO_H, t) for e in (m - 1, m)}), np.int32)
    rows0 = band_rows[0]
    first = (np.arange(b) * 37 % -(-ARGO_H // rows0)) * rows0  # the first row of each sweep's band
    one_band = (first[:, None] + rng.integers(0, rows0, (b, n)) % np.minimum(rows0, ARGO_H - first)[:, None])
    one_band = one_band.astype(np.int32)
    one_col = rng.integers(0, ARGO_W, (b, n)).astype(np.int32)
    one_band[hot, :10000], one_col[hot, :10000] = first[hot], 321
    return {"training": (row, col, z, r),
            "band_edges": (rng.choice(edges, (b, n)).astype(np.int32),
                           rng.integers(0, ARGO_W, (b, n)).astype(np.int32), z, r),
            "one_band": (one_band, one_col, z, r)}


def bits_equal(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def argoverse_tile_direct(row, col, z, r):
    """The Argoverse raster through its first design, the tile pass
    (`argoverse_raster_reduce_tile_cuda`, 19-row bands, each band's block
    scanning its sweep), past the wrapper: to hold the bucketed design bit
    for bit against it and time both in one run. Counts no launch."""
    b, n = row.shape
    lib, dev = bev_counts._cuda_launch_setup("argoverse_raster_reduce", (row, col, z, r))
    tile_rows, n_tiles = tile_plan(b, ARGO_H, ARGO_W, ARGOVERSE_BYTES_PER_CELL, shared_memory_limit(dev))
    out = row.new_empty((b, 3, ARGO_H, ARGO_W), dtype=torch.float32)
    err = lib.argoverse_raster_reduce_tile_cuda(
        row.data_ptr(), col.data_ptr(), z.data_ptr(), r.data_ptr(), out.data_ptr(), b, n, ARGO_H, ARGO_W,
        tile_rows, n_tiles, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"argoverse_raster_reduce_tile_cuda launch failed: cudaError {err}")
    return out


def argoverse_bound(b, n_valid):
    """(bound ms, bound by, bytes): 16 B a point read and 12 B a cell
    written, against a count and two maxima per in-range point."""
    bytes_moved = 4 * b * ARGO_N * 4 + b * 3 * ARGO_H * ARGO_W * 4
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = 3 * n_valid / FP32_OPS_PER_S * 1e3
    return max(bound_bytes_ms, bound_ops_ms), ("bytes" if bound_bytes_ms >= bound_ops_ms else "operations"), bytes_moved


def phase_argoverse_kernel(card):
    """The Argoverse entry's bucketed design at 1, 16 and 64 sweeps of
    131072 points: bit for bit against its plain version on the card, the
    tile design and bev_cell_counts' count on three inputs each, against
    the CPU on the training input; then timed beside the tile design. The
    kernels line's record holds the (1, 131072) numbers (argoverse_test's
    shape, where its launches are counted) and every shape under by_shape."""
    dev = DEVICE
    smem = shared_memory_limit(dev)
    sms = multiprocessor_count(dev)
    tile = tile_plan(max(ARGO_SHAPES), ARGO_H, ARGO_W, ARGOVERSE_BYTES_PER_CELL, smem)
    by_shape = {}
    for b in ARGO_SHAPES:
        plan = argoverse_band_plan(b, ARGO_N, ARGO_H, ARGO_W, smem, sms)
        cases = argoverse_kernel_inputs(np.random.default_rng(SEED + 20 + b), b, (plan[0], tile[0]))
        checks = {}
        for name, arrays in cases.items():
            row, col, z, r = (torch.from_numpy(a).to(dev) for a in arrays)
            got = argoverse_raster_reduce(row, col, z, r, ARGO_H, ARGO_W)
            for what, want in (("its plain version", argoverse_raster_reduce_plain(row, col, z, r, ARGO_H, ARGO_W)),
                               ("the tile design", argoverse_tile_direct(row, col, z, r))):
                if not bits_equal(got, want):
                    raise AssertionError(f"argoverse_raster_reduce differs from {what} on {name} at B = {b}")
                del want
            if not torch.equal(got[:, 0], bev_cell_counts(row, col, ARGO_H, ARGO_W)):
                raise AssertionError(f"argoverse_raster_reduce's counts differ from bev_cell_counts on {name} at B = {b}")
            if name != "band_edges" and got[min(3, b - 1), 0, :, 321].max().item() < 10000:
                raise AssertionError(f"the hot cell lost counts ({name}, B = {b})")
            if name == "training" and b > 5 and got[5].any():
                raise AssertionError(f"the all-invalid sweep left a mark (B = {b})")
            if name == "training":
                cpu = argoverse_raster_reduce_plain(*(torch.from_numpy(a) for a in arrays), ARGO_H, ARGO_W)
                if not bits_equal(got.cpu(), cpu):
                    raise AssertionError(f"argoverse_raster_reduce on the card differs from the CPU plain version at B = {b}")
                del cpu
            checks[name] = {"bit_exact_vs_plain_tile_and_cpu" if name == "training" else "bit_exact_vs_plain_and_tile": True,
                            "count_equals_bev_cell_counts": True,
                            "in_range_points_per_sweep": (row >= 0).sum(1).float().mean().item()}
            del got
        emit({"phase": "argoverse_kernel", "shape": [b, ARGO_N, ARGO_H, ARGO_W], "band_plan": plan,
              "tile_plan": tile, "shared_memory_per_block": smem, "sms": sms, "checks": checks,
              "card": card["nvidia_smi"]})
        by_shape[f"{b}x{ARGO_N}"] = argoverse_kernel_times(card, b, plan, cases)
        del cases
        torch.cuda.empty_cache()

    one = by_shape[f"1x{ARGO_N}"]
    return {
        "name": "argoverse_raster_reduce",
        "route": "cuda",
        "source": "sfa3d_tpu_torch/csrc/bev_counts.cu",
        "replaces": "sfa3d_tpu/ops/bev_pallas.py:76",
        "replaces_on_path": "sfa3d_tpu/ops/bev.py:308 (argoverse_points_to_bev's segment_max x 2 + segment_sum)",
        "launches": None,  # filled in from the path's run
        "max_abs_err": 0.0,  # bit-exact or raised
        "shape": [1, ARGO_N, ARGO_H, ARGO_W],
        **{k: one[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "bound_share_device",
                               "library_ms", "device_ms_by_kernel", "tile_design_device_ms")},
        "by_shape": by_shape,
    }


def argoverse_kernel_times(card, b, plan, cases):
    """Times of the Argoverse entry at (b, ARGO_N) on the training input:
    device ms of each of its kernels and their sum, event ms, launches per
    call, bound and share, the design's own bytes, the tile design's device
    ms, plain and library ms; the device ms on band_edges and one_band."""
    dev = DEVICE
    row, col, z, r = (torch.from_numpy(a).to(dev) for a in cases["training"])
    ok = row >= 0
    n_valid = int(ok.sum().item())
    n_rows_in = int(((row >= 0) & (row < ARGO_H)).sum().item())
    flat = torch.where(ok, (torch.arange(b, device=dev)[:, None] * ARGO_H + row) * ARGO_W + col,
                       b * ARGO_H * ARGO_W).reshape(-1)
    cid = torch.where(ok, row.long() * ARGO_W + col.long(), ARGO_H * ARGO_W)

    def library():  # the reductions as PyTorch calls, a yardstick only
        for v in (z, r):
            torch.zeros((b, ARGO_H * ARGO_W + 1), device=dev).scatter_reduce_(
                1, cid, v, reduce="amax", include_self=True)
        torch.bincount(flat, minlength=b * ARGO_H * ARGO_W + 1)

    def run(args):
        return lambda: argoverse_raster_reduce(*args, ARGO_H, ARGO_W)

    args = (row, col, z, r)
    kernels = device_kernels(run(args), ARGO_KERNELS)
    dms = sum(k["device_ms"] for k in kernels.values())
    launched = sorted(k for k, v in kernels.items() if k != "Memset" and v["launches"] == 1.0)
    if len(launched) != 3:
        raise AssertionError(f"the profiler did not see the Argoverse entry's three kernels once a call: {kernels}")
    tile_dms = device_ms(lambda: argoverse_tile_direct(*args))
    bound_ms, bound_by, bytes_moved = argoverse_bound(b, n_valid)
    tables = argoverse_scratch_len(b, ARGO_N, plan[1], plan[2]) - 3 * b * ARGO_N
    design_bytes = 4 * b * ARGO_N + 24 * n_rows_in + 8 * tables  # second row read; records, tables written and read
    reps = ARGO_PLAIN_REPS[b]
    others = {}
    for name in ("band_edges", "one_band"):
        other = tuple(torch.from_numpy(a).to(dev) for a in cases[name])
        found = device_kernels(run(other), ARGO_KERNELS)
        others[name] = {"device_ms": sum(k["device_ms"] for k in found.values()),
                        "device_ms_by_kernel": {k: v["device_ms"] for k, v in found.items()},
                        "tile_design_device_ms": device_ms(lambda: argoverse_tile_direct(*other))}
        del other
    rec = {
        "shape": [b, ARGO_N, ARGO_H, ARGO_W],
        "band_plan": plan,
        "ms": cuda_ms(run(args), reps=20),
        "device_ms": dms,
        "device_ms_by_kernel": {k: v["device_ms"] for k, v in kernels.items()},
        "launches_per_call_by_kernel": {k: v["launches"] for k, v in kernels.items()},
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_share_device": bound_ms / dms,
        "bytes": bytes_moved,
        "design_bytes_beyond_bound": design_bytes,
        "tile_design_device_ms": tile_dms,
        "tile_design_event_ms": cuda_ms(lambda: argoverse_tile_direct(*args), reps=20),
        "faster_than_tile_design": dms < tile_dms if tile_dms else None,
        "plain_ms": cuda_ms(lambda: argoverse_raster_reduce_plain(*args, ARGO_H, ARGO_W), reps=reps, warmup=1),
        "library_ms": cuda_ms(library, reps=reps, warmup=1),
        "bev_cell_counts_ms_at_this_shape": cuda_ms(lambda: bev_cell_counts(row, col, ARGO_H, ARGO_W), reps=20),
        "valid_points": n_valid,
        "other_inputs": others,
    }
    emit({"phase": "argoverse_kernel_time", **rec, "card": card["nvidia_smi"]})
    return rec


def phase_argoverse(card, tmp_root):
    """The Argoverse path through the entry points a user calls: the port's
    writer, the raster card vs CPU, the argoverse_test CLI card vs CPU, the
    training path at the CLI's defaults and one epoch of the training CLI
    whose checkpoint argoverse_test loads. Returns the raster kernel's
    launches on each path, each read with the count set to 0 just before."""
    import os

    from sfa3d_tpu_torch.cli import argoverse_test as argo_cli
    from sfa3d_tpu_torch.cli import train as train_cli
    from sfa3d_tpu_torch.config.train import parse_train_configs
    from sfa3d_tpu_torch.data.argoverse import ArgoverseDataset, ArgoverseTrainLoader, crop_raster, write_mini_argoverse
    from sfa3d_tpu_torch.data.loader import create_train_loader, create_val_loader
    from sfa3d_tpu_torch.parallel import create_train_state, make_train_step
    from sfa3d_tpu_torch.pipeline import detect_bev
    from sfa3d_tpu_torch.runtime.schedules import create_optimizer

    t0 = time.perf_counter()
    root = write_mini_argoverse(os.path.join(tmp_root, "argo"), n_frames=ARGO_FRAMES, seed=SEED)
    write_s = time.perf_counter() - t0

    # the raster of 16 real sweeps on the card against the CPU
    ds = ArgoverseDataset(root, mode="test", num_samples=ARGO_TEST_FRAMES)
    samples = [ds[i] for i in range(len(ds))]
    pts_c = torch.from_numpy(np.stack([x.points for x in samples]))
    valid_c = torch.from_numpy(np.stack([x.valid for x in samples]))
    pts_g, valid_g = pts_c.to(DEVICE), valid_c.to(DEVICE)
    idx_g = bev_ops.argoverse_cell_indices(pts_g, valid_g)
    idx_c = bev_ops.argoverse_cell_indices(pts_c, valid_c)
    for name, a, b in zip(("row", "col", "z", "r"), idx_g, idx_c):
        if not bits_equal(a.cpu(), b):
            raise AssertionError(f"Argoverse {name} differs between the card and the CPU")
    if not bits_equal(argoverse_raster_reduce(*idx_g, ARGO_H, ARGO_W),
                      argoverse_raster_reduce_plain(*idx_g, ARGO_H, ARGO_W)):
        raise AssertionError("argoverse_raster_reduce differs from its plain version on the sweeps")
    bev_g = bev_ops.argoverse_points_to_bev_nchw(pts_g, valid_g).cpu()
    bev_c = bev_ops.argoverse_points_to_bev_nchw(pts_c, valid_c)
    for c in (1, 2):
        if not torch.equal(bev_g[:, c], bev_c[:, c]):
            raise AssertionError(f"Argoverse raster channel {c} differs between the card and the CPU")
    density_err = (bev_g[:, 0] - bev_c[:, 0]).abs().max().item()
    if density_err > ARGO_DENSITY_TOL:
        raise AssertionError(f"Argoverse density card vs CPU differs by {density_err}")
    raster_ms = cuda_ms(lambda: bev_ops.argoverse_points_to_bev_nchw(pts_g, valid_g), reps=10)
    del pts_g, valid_g, bev_g

    # argoverse_test over 16 sweeps, on the card and on the CPU
    model = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(SEED))
    bump_heatmap_bias(model)
    ckpt = os.path.join(tmp_root, "kfpn_argo.pth")
    torch.save(model.state_dict(), ckpt)
    args = ["--dataset_dir", root, "--pretrained_path", ckpt, "--num_samples", str(ARGO_TEST_FRAMES)]
    res_g, res_c = [], []
    bev_raster_reduce.launches = 0
    argoverse_raster_reduce.launches = 0  # the main path's launches only
    t0 = time.perf_counter()
    failed = argo_cli.main(args + ["--output_dir", os.path.join(tmp_root, "argo_out")], results=res_g)
    card_s = time.perf_counter() - t0
    test_launches = argoverse_raster_reduce.launches
    if failed or len(res_g) != ARGO_TEST_FRAMES or test_launches != ARGO_TEST_FRAMES or bev_raster_reduce.launches:
        raise AssertionError(f"argoverse_test: {failed} failed, {len(res_g)} answered, {test_launches} "
                             f"Argoverse raster launches for {ARGO_TEST_FRAMES} sweeps")
    t0 = time.perf_counter()
    failed = argo_cli.main(args + ["--platform", "cpu", "--output_dir", os.path.join(tmp_root, "argo_cpu")],
                           results=res_c)
    cpu_s = time.perf_counter() - t0
    if failed or len(res_c) != ARGO_TEST_FRAMES:
        raise AssertionError(f"argoverse_test --platform cpu: {failed} failed, {len(res_c)} answered")
    det_err, n_dets = 0.0, []
    for a, b in zip(res_g, res_c):
        ra, rb = (x["boxes_real"][x["mask"]].astype(np.float64) for x in (a, b))
        ra, rb = (x[np.lexsort((x[:, 2], x[:, 1], x[:, 0]))] for x in (ra, rb))
        if a["timestamp"] != b["timestamp"] or ra.shape != rb.shape:
            raise AssertionError(f"sweep {a['timestamp']}: {len(ra)} detections on the card, {len(rb)} on the CPU")
        if len(ra):
            det_err = max(det_err, float(np.abs(ra - rb).max()))
        n_dets.append(len(ra))
    if det_err > NET_TOL or sum(n_dets) == 0:
        raise AssertionError(f"argoverse_test detections card vs CPU: max |diff| {det_err}, counts {n_dets}")
    # the composite: each sweep's camera frame (GT boxes drawn) and raster as JPEG
    from sfa3d_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

    composite = {"camera_equal_card_cpu": all(np.array_equal(a["camera"], b["camera"]) for a, b in zip(res_g, res_c))}
    for kind, key in (("rgb", "camera"), ("bev", "bev_u8")):
        with open(os.path.join(tmp_root, "argo_out", f"{res_g[0]['timestamp']}_{kind}.jpg"), "rb") as f:
            data = f.read()
        t1 = time.perf_counter()
        decoded = decode_jpeg(data)
        diff = decoded.astype(np.float64) - res_g[0][key]
        composite[kind] = {"shape": list(decoded.shape), "bytes": len(data), "file_is_its_jpeg": data == encode_jpeg(
            res_g[0][key]), "decode_ms": (time.perf_counter() - t1) * 1e3, "max_abs_err": float(np.abs(diff).max()),
            "psnr_db": float(10 * np.log10(255.0 ** 2 / max(np.mean(diff ** 2), 1e-12)))}
    if (not composite["camera_equal_card_cpu"] or not all(composite[k]["file_is_its_jpeg"] for k in ("rgb", "bev"))
            or composite["bev"]["shape"] != [ARGO_H, ARGO_W, 3]):
        raise AssertionError(f"argoverse_test composite: {composite}")
    gpu_model = model.to(DEVICE).eval()
    with torch.inference_mode():
        crop = crop_raster(bev_ops.argoverse_points_to_bev_nchw(pts_c[:1].to(DEVICE), valid_c[:1].to(DEVICE)))
        detect_ms = cuda_ms(lambda: detect_bev(gpu_model, crop.permute(0, 2, 3, 1), K=50, peak_thresh=0.2), reps=10)

    # the training path at the CLI's defaults
    configs = parse_train_configs(["--dataset", "argoverse", "--dataset_dir", root,
                                   "--root-dir", os.path.join(tmp_root, "argo_run"), "--seed", str(SEED)])
    rt = configs.runtime
    s = configs.optim.effective_batch // rt.batch_size
    if (rt.batch_size, s, configs.model.compute_dtype) != TRAIN_DEFAULTS:
        raise AssertionError(f"the CLI defaults are not batch, S, dtype = {TRAIN_DEFAULTS}")
    loader = create_train_loader(configs, device=DEVICE)
    if not isinstance(loader, ArgoverseTrainLoader):
        raise AssertionError(f"--dataset argoverse built a {type(loader).__name__}")
    init_sd = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(SEED)).state_dict()
    train_model = _train_model(init_sd).to(DEVICE)
    spec = create_optimizer(configs.optim, rt.num_epochs, len(loader))
    state = create_train_state(train_model, spec)
    step = make_train_step(train_model, spec, compute_dtype=configs.model.compute_dtype, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    argoverse_raster_reduce.launches = 0
    state, ms, losses, wait, wall = _timed_steps(step, state, _epoch_batches(loader, ARGO_TRAIN_STEPS))
    train_launches = argoverse_raster_reduce.launches
    peak = torch.cuda.max_memory_allocated()
    if len(ms) != ARGO_TRAIN_STEPS * len(loader) or train_launches != len(ms) or not all(np.isfinite(losses)):
        raise AssertionError(f"Argoverse training: {len(ms)} steps, {train_launches} raster launches, "
                             f"losses {losses}")
    frames = s * rt.batch_size
    del state, step, train_model

    # one epoch of the training CLI (with --val_ap: warned and skipped), whose
    # checkpoint argoverse_test loads
    argoverse_raster_reduce.launches = 0
    t0 = time.perf_counter()
    train_cli.main(["--dataset", "argoverse", "--dataset_dir", root, "--root-dir", os.path.join(tmp_root, "argo_cli"),
                    "--num_epochs", "1", "--checkpoint_freq", "1", "--seed", str(SEED), "--print_freq", "1",
                    "--val_ap"])
    cli_s = time.perf_counter() - t0
    cli_launches = argoverse_raster_reduce.launches
    val_batches = len(create_val_loader(configs, device=DEVICE))
    if cli_launches != len(loader) + val_batches:
        raise AssertionError(f"the CLI epoch launched the Argoverse raster {cli_launches} times for "
                             f"{len(loader)} + {val_batches} batches")
    log = open(os.path.join(tmp_root, "argo_cli", "logs", rt.saved_fn, f"logger_{rt.saved_fn}.txt")).read()
    cli_losses = [float(v) for v in re.findall(r"Loss (\S+) \(", log)]
    if not cli_losses or not all(np.isfinite(cli_losses)) or "--val_ap supports the KITTI layout only" not in log:
        raise AssertionError(f"the CLI epoch's losses {cli_losses}, or --val_ap was not skipped")
    ckpt = os.path.join(tmp_root, "argo_cli", "checkpoints", rt.saved_fn, f"Model_{rt.saved_fn}_epoch_1.pth")
    res_ck = []
    if argo_cli.main(["--dataset_dir", root, "--pretrained_path", ckpt, "--num_samples", "4",
                      "--output_dir", os.path.join(tmp_root, "argo_ck")], results=res_ck) or len(res_ck) != 4:
        raise AssertionError("argoverse_test did not answer every sweep with the trained checkpoint")
    emit({"phase": "argoverse", "sweeps_written": ARGO_FRAMES, "write_seconds": write_s,
          "in_range_points_per_sweep": (idx_c[0] >= 0).sum(1).float().mean().item(),
          "raster_density_max_abs_err_vs_cpu": density_err, "raster_ms_16_sweeps": raster_ms,
          "argoverse_test": {"sweeps": ARGO_TEST_FRAMES, "failed": 0, "raster_launches": test_launches,
                             "detections_per_sweep": n_dets, "detections_max_abs_err_vs_cpu": det_err,
                             "card_seconds": card_s, "card_ms_per_sweep": card_s / ARGO_TEST_FRAMES * 1e3,
                             "cpu_seconds": cpu_s, "crop_detect_ms_one_sweep": detect_ms,
                             "composite": composite},
          "train": {"batch_size": rt.batch_size, "S": s, "frames_per_step": frames,
                    "compute_dtype": configs.model.compute_dtype, "steps": len(ms), "step_ms": ms,
                    "losses": losses, "raster_launches": train_launches, "loader_wait_ms": wait,
                    "step_wall_ms": wall,
                    "frames_per_s_end_to_end": (len(ms) - 1) * frames / (sum(wall[1:]) / 1e3),
                    "frames_per_s_device": frames / (statistics.median(ms[1:]) / 1e3),
                    "max_memory_allocated_bytes": peak},
          "train_cli": {"seconds": cli_s, "raster_launches": cli_launches, "val_batches": val_batches,
                        "losses": cli_losses, "checkpoint_sweeps_answered": len(res_ck)},
          "card": card["nvidia_smi"]})
    return {"argoverse_test": test_launches, "argoverse_train": train_launches, "argoverse_train_cli": cli_launches}


# ---------------------------------------------------------------------------
# AOT export: the exported programs on the card
# ---------------------------------------------------------------------------

EXPORT_BATCH = 8  # the fixed artifacts' batch: the served bucket
EXPORT_LETTERBOX = 640  # the fused artifact's square canvas (the export's default)
EXPORT_TOL = 1e-4  # float outputs, artifact vs live on the card: the same ATen ops, whose cuDNN paths may differ
EXPORT_CLI_TOL = 1e-3  # served (padded batch-8) detections vs the live detector's batch of one
COLD_START = """
import json, sys, time
t0 = time.perf_counter()
import numpy as np
import torch
from sfa3d_tpu_torch.detector import ArtifactDetector
from sfa3d_tpu_torch.ops.bev_counts import bev_raster_reduce
torch.backends.cudnn.allow_tf32 = False  # strict float32, as in this script: the artifact carries no such flag
torch.backends.cuda.matmul.allow_tf32 = False
t1 = time.perf_counter()
ad = ArtifactDetector(sys.argv[1])
t2 = time.perf_counter()
frame = np.load(sys.argv[2])
out = ad.detect_batch(frame["pts"], frame["valid"])
t3 = time.perf_counter()
np.save(sys.argv[3], out["boxes_real"])
print(json.dumps({"import_s": t1 - t0, "load_s": t2 - t1, "first_call_ms": (t3 - t2) * 1e3,
                  "launches": bev_raster_reduce.launches, "detections": int(out["mask"].sum())}))
"""


def compare_outputs(got, want):
    """(max abs difference of the float outputs, integer and bool outputs
    all equal, bit for bit) of two dicts of host arrays."""
    err, discrete, exact = 0.0, True, True
    for k, w in want.items():
        g = np.asarray(got[k])
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{k}: {g.shape} {g.dtype} against {w.shape} {w.dtype}")
        if w.dtype.kind == "f":
            err = max(err, float(np.abs(g - w).max(initial=0.0)))
        elif not np.array_equal(g, w):
            discrete = False
        exact = exact and np.array_equal(g, w)
    return err, discrete, exact


def counted_call(fns, call):
    """call()'s result and the launches each of `fns` counted during it."""
    before = [fn.launches for fn in fns]
    out = call()
    torch.cuda.synchronize()
    return out, {fn.__name__: fn.launches - b for fn, b in zip(fns, before)}


def in_turns(runs, timer=host_ms):
    """{name: [ms, ms]}: each fn of `runs` timed twice, in turns a, b, b, a."""
    names = list(runs)
    out = {n: [] for n in names}
    for n in names + names[::-1]:
        out[n].append(timer(runs[n]))
    return out


def bare_raster_call(row, col, key):
    """The raster kernel's C entry called directly with a preallocated
    output: what an enqueue costs without Python's checks, allocation and
    dispatcher. Counts no launch."""
    from sfa3d_tpu_torch._build import load_library

    b, n = row.shape
    lib = load_library("bev_counts", bev_counts._SIGNATURES)
    tile_rows, n_tiles = tile_plan(b, cnf.BEV_HEIGHT, cnf.BEV_WIDTH, RASTER_BYTES_PER_CELL, shared_memory_limit(DEVICE))
    out = torch.empty((b, 3, cnf.BEV_HEIGHT, cnf.BEV_WIDTH), device=DEVICE)
    stream = torch.cuda.current_stream().cuda_stream
    args = (row.data_ptr(), col.data_ptr(), key.data_ptr(), out.data_ptr(), b, n, cnf.BEV_HEIGHT, cnf.BEV_WIDTH,
            tile_rows, n_tiles, bev_counts._INV_4095, bev_counts._INV_8191, bev_counts._INV_LOG64,
            DEVICE.index or 0, stream)

    def call():
        err = lib.bev_raster_reduce_cuda(*args)
        if err != 0:
            raise RuntimeError(f"bev_raster_reduce_cuda launch failed: cudaError {err}")

    return call


def export_enqueue_times(pts, valid):
    """Host enqueue ms per call of each kernel entry through its custom op
    (the public wrapper) and past the dispatcher (`_<entry>_impl`, the
    wrapper as it was before the entries became ops), in turns, under
    inference mode as the served paths call them; the raster also through
    its bare C call, and op against impl with autograd on (the training
    path's mode)."""
    from sfa3d_tpu_torch.ops import track_associate as ta

    rng = np.random.default_rng(SEED + 23)
    dev = DEVICE

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    nms = on_card(loop_boxes(rng, LOOP_B, 256), rng.random((LOOP_B, 256)) < 0.8)
    soft = on_card(loop_boxes(rng, LOOP_B, 114), rng.uniform(0, 1, (LOOP_B, 114)).astype(np.float32),
                   rng.random((LOOP_B, 114)) < 0.8)
    match = on_card(loop_boxes(rng, LOOP_B, 64), rng.random((LOOP_B, 64)) < 0.8,
                    loop_boxes(rng, LOOP_B, 50), rng.random((LOOP_B, 50)) < 0.8)
    assoc = on_card(*track_iou_inputs(rng, 1, TRACK_K, TRACK_T, "crowded"))
    out = {}
    with torch.inference_mode():
        idx = bev_ops.cell_indices_and_keys(*on_card(pts, valid))
        hw = (cnf.BEV_HEIGHT, cnf.BEV_WIDTH)
        entries = {
            "bev_raster_reduce": (lambda: bev_raster_reduce(*idx), lambda: bev_counts._bev_raster_reduce_impl(*idx, *hw)),
            "hard_nms_keep": (lambda: fusion_loops.hard_nms_keep(*nms, 0.45),
                              lambda: fusion_loops._hard_nms_keep_impl(*nms, 0.45)),
            "soft_nms_gaussian": (lambda: fusion_loops.soft_nms_gaussian(*soft),
                                  lambda: fusion_loops._soft_nms_gaussian_impl(*soft, 0.5, 0.001)),
            "greedy_match": (lambda: fusion_loops.greedy_match(*match, 0.7),
                             lambda: fusion_loops._greedy_match_impl(*match, 0.7)),
            "track_associate": (lambda: ta.track_associate(*assoc, TRACK_IOU_MIN),
                                lambda: ta._track_associate_impl(*assoc, TRACK_IOU_MIN)),
        }
        for name, (op, impl) in entries.items():
            out[name] = in_turns({"custom_op_ms": op, "impl_ms": impl}, enqueue_ms)
        out["bev_raster_reduce"]["bare_c_call_ms"] = [enqueue_ms(bare_raster_call(*idx))]
    op, impl = entries["bev_raster_reduce"]
    out["bev_raster_reduce_autograd_on"] = in_turns({"custom_op_ms": op, "impl_ms": impl}, enqueue_ms)
    return out


def phase_export(card, tmp_root):
    """The AOT export on the card: the detector exported with a symbolic
    batch and at a fixed batch of 8, the fused program at a fixed batch of
    8; each saved, loaded and run on the card through the kernels, held
    against the live detectors on the same weights; `cli export` then
    `cli serve --artifact` with and without --track; a cold start in a
    fresh process; export, load, first-call and per-batch times; the host
    enqueue of each kernel entry through its custom op and past it."""
    import os

    from sfa3d_tpu_torch.cli import export as export_cli
    from sfa3d_tpu_torch.detector import ArtifactDetector, ArtifactFusedDetector, fused_reply
    from sfa3d_tpu_torch.ops.track_associate import track_associate
    from sfa3d_tpu_torch.runtime.export import export_detector, export_fused, letterbox_geometry, save_exported

    loops = [fusion_loops.hard_nms_keep, fusion_loops.soft_nms_gaussian, fusion_loops.greedy_match]
    rec = {"phase": "export", "card": card["nvidia_smi"]}

    # --- the detector: symbolic and fixed-batch artifacts ---
    det = Detector(device=DEVICE, seed=SEED)
    bump_heatmap_bias(det.model)
    rng = np.random.default_rng(SEED + 21)
    frames = [bev_ops.filter_and_pad_points(make_scan(rng), N) for _ in range(EXPORT_BATCH)]
    pts, valid = np.stack([p for p, _ in frames]), np.stack([v for _, v in frames])
    paths = {}
    for name, batch in (("symbolic", None), ("batch8", EXPORT_BATCH)):
        t0 = time.perf_counter()
        exported, manifest = export_detector(det.model, K=50, peak_thresh=0.2, max_points=N, batch=batch)
        t1 = time.perf_counter()
        paths[name] = f"{tmp_root}/detector_{name}.sfa3dt"
        save_exported(paths[name], exported, manifest)
        rec[f"detector_{name}"] = {"export_s": t1 - t0, "save_s": time.perf_counter() - t1,
                                   "file_mb": os.path.getsize(paths[name]) / 1e6,
                                   "graph_nodes": len(exported.graph.nodes)}
    t0 = time.perf_counter()
    ad = ArtifactDetector(paths["symbolic"])
    rec["detector_symbolic"]["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, first = counted_call([bev_raster_reduce], lambda: ad.detect_batch(pts[:1], valid[:1]))
    rec["detector_symbolic"]["first_call_ms"] = (time.perf_counter() - t0) * 1e3
    if first["bev_raster_reduce"] != 1:
        raise AssertionError(f"the artifact's first call launched the raster kernel {first} times")
    fixed = ArtifactDetector(paths["batch8"])
    checks = {}
    for label, art, b in (("symbolic_bucket1", ad, 1), ("symbolic_bucket8", ad, 8), ("fixed_bucket8", fixed, 8)):
        got, launches = counted_call([bev_raster_reduce], lambda: art.detect_batch(pts[:b], valid[:b]))
        want = det.detect_batch(pts[:b], valid[:b])
        err, discrete, exact = compare_outputs(got, want)
        checks[label] = {"launches": launches, "max_abs_err": err, "masks_equal": discrete, "bit_exact": exact,
                         "detections": int(want["mask"].sum())}
        if launches["bev_raster_reduce"] != 1 or not discrete or err > EXPORT_TOL or not want["mask"].any():
            raise AssertionError(f"detector artifact {label} against Detector.detect_batch: {checks[label]}")
    refused = None
    try:
        fixed.detect_batch(pts[:1], valid[:1])
    except ValueError as e:
        refused = str(e)
    if refused is None or f"fixed-batch artifact (batch={EXPORT_BATCH}) cannot run batch 1" not in refused:
        raise AssertionError(f"the batch-{EXPORT_BATCH} artifact took a batch of 1: {refused}")
    rec["detector_checks"] = checks
    rec["detector_batch_ms"] = {
        f"bucket{b}": in_turns({"live": lambda: det.detect_batch(pts[:b], valid[:b]),
                                "artifact": lambda: ad.detect_batch(pts[:b], valid[:b])})
        for b in (1, 8)}
    rec["detector_batch_ms"]["bucket8_fixed_artifact"] = [host_ms(lambda: fixed.detect_batch(pts, valid))]

    # --- a cold start: a fresh process loads the artifact and calls it once ---
    np.savez(f"{tmp_root}/cold_frame.npz", pts=pts[:1], valid=valid[:1])
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", COLD_START, paths["symbolic"], f"{tmp_root}/cold_frame.npz",
                           f"{tmp_root}/cold_boxes.npy"], cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the cold-start process failed:\n{proc.stderr[-4000:]}")
    cold = json.loads(proc.stdout.strip().splitlines()[-1])
    cold["process_s"] = time.perf_counter() - t0
    cold_err = float(np.abs(np.load(f"{tmp_root}/cold_boxes.npy") - det.detect_batch(pts[:1], valid[:1])["boxes_real"])
                     .max())
    if cold["launches"] != 1 or cold_err > EXPORT_TOL:
        raise AssertionError(f"cold start: {cold}, boxes off the live detector's by {cold_err}")
    rec["cold_start"] = {**cold, "max_abs_err": cold_err}

    # --- the fused program at a fixed batch of 8 ---
    reqs = fused_requests(EXPORT_BATCH)
    fd = FusedDetector(imgsz=EXPORT_LETTERBOX, device=DEVICE, seed=SEED)
    bump_fused_biases(fd, yolo_gate_bias(fd.yolo, reqs[0][1], EXPORT_LETTERBOX))
    t0 = time.perf_counter()
    exported, manifest = export_fused(fd.kfpn, fd.yolo, batch=EXPORT_BATCH, max_points=N, img_hw=IMG_HW,
                                      letterbox=EXPORT_LETTERBOX)
    t1 = time.perf_counter()
    fused_path = f"{tmp_root}/fused_batch8.sfa3dt"
    save_exported(fused_path, exported, manifest)
    rec["fused_batch8"] = {"export_s": t1 - t0, "save_s": time.perf_counter() - t1,
                           "file_mb": os.path.getsize(fused_path) / 1e6, "graph_nodes": len(exported.graph.nodes),
                           "letterbox_pad": manifest["letterbox_pad"], "letterbox_scale": manifest["letterbox_scale"]}
    t0 = time.perf_counter()
    afd = ArtifactFusedDetector(fused_path)
    rec["fused_batch8"]["load_s"] = time.perf_counter() - t0
    scale, pad_x, pad_y = letterbox_geometry(IMG_HW, EXPORT_LETTERBOX)
    rows = []
    for points, image, calib in reqs:
        p, v = bev_ops.filter_and_pad_points(points, N)
        img, r, pad = letterbox(image, EXPORT_LETTERBOX)
        if (r, tuple(pad)) != (scale, (pad_x, pad_y)):
            raise AssertionError(f"the live letterbox gives scale {r}, pad {pad}; the artifact bakes {scale}, "
                                 f"{(pad_x, pad_y)}")
        rows.append((p, v, img, *(np.float32(m) for m in (calib.V2C, calib.R0, calib.P2))))
    inputs = [np.stack(a) for a in zip(*rows)]
    baked = (np.float32([IMG_HW] * EXPORT_BATCH), np.full(EXPORT_BATCH, scale, np.float32),
             np.float32([[pad_x, pad_y]] * EXPORT_BATCH))
    t0 = time.perf_counter()
    counted_call([bev_raster_reduce, *loops], lambda: afd.run_batch(*inputs))
    rec["fused_batch8"]["first_call_ms"] = (time.perf_counter() - t0) * 1e3
    got, fused_launches = counted_call([bev_raster_reduce, *loops], lambda: afd.run_batch(*inputs))
    want = fd.run_batch(*inputs, *baked)
    err, discrete, exact = compare_outputs(got, want)
    sources = np.bincount(np.concatenate([fused_reply(want, i)["source"] for i in range(EXPORT_BATCH)]), minlength=3)
    unequal = [i for i in range(EXPORT_BATCH) if not replies_equal(fused_reply(got, i), fused_reply(want, i))]
    rec["fused_checks"] = {"launches": fused_launches, "max_abs_err": err, "discrete_equal": discrete, "bit_exact": exact,
                           "replies_unequal": unequal, "rows_by_source": sources.tolist()}
    if any(n != 1 for n in fused_launches.values()) or unequal or not sources[2]:
        raise AssertionError(f"fused artifact against FusedDetector.run_batch: {rec['fused_checks']}")
    rec["fused_batch_ms"] = {"bucket8": in_turns({"live": lambda: fd.run_batch(*inputs, *baked),
                                                  "artifact": lambda: afd.run_batch(*inputs)})}

    # --- the CLIs: export a batch-8 artifact, serve it with and without --track ---
    cli_root = f"{tmp_root}/export_cli"
    os.makedirs(cli_root, exist_ok=True)
    cpu_det = Detector(device="cpu", seed=SEED)
    bump_heatmap_bias(cpu_det.model)
    bump_dim_bias(cpu_det.model)
    ckpt = f"{cli_root}/Model_fpn_resnet_18.pth"
    torch.save(cpu_det.model.state_dict(), ckpt)
    cli_path = f"{cli_root}/model_b8.sfa3dt"
    t0 = time.perf_counter()
    cli_manifest = export_cli.main(["--pretrained_path", ckpt, "--batch", str(EXPORT_BATCH), "-o", cli_path])
    rec["cli_export_s"] = time.perf_counter() - t0
    if cli_manifest["platforms"] != [DEVICE.type] or cli_manifest["batch"] != EXPORT_BATCH:
        raise AssertionError(f"cli export wrote {cli_manifest}")
    live = Detector(checkpoint=ckpt, device=DEVICE)
    requests = serve_requests(np.random.default_rng(SEED + 13), cli_root)[:-1]  # 15 frames: a batch is padded
    ids = [r["id"] for r in requests]
    rec["serve_cli"] = {}
    for track in (False, True):
        bev_raster_reduce.launches = 0  # count this path's launches only
        track_associate.launches = 0
        argv = ["--artifact", cli_path, "--max_delay_ms", "20"] + (["--track"] if track else [])
        replies, stats, seconds = run_serve_cli(argv, requests)
        raster, assoc = bev_raster_reduce.launches, track_associate.launches
        answered = [r for r in replies if "detections" in r]
        err = 0.0
        for reply in answered:
            scan = np.fromfile(requests[ids.index(reply["id"])]["lidar"], np.float32).reshape(-1, 4)
            a, b = sorted_rows(reply["detections"]), sorted_rows(live.detect(scan))
            if a.shape != b.shape:
                raise AssertionError(f"serve --artifact {reply['id']}: {len(a)} detections, live {len(b)}")
            err = max(err, float(np.abs(a - b).max(initial=0.0)))
        tracked = [r for r in replies if r.get("tracks")]
        ok = ([r["id"] for r in replies] == ids and len(answered) == len(ids) - 1
              and "error" in replies[ids.index("bad")] and raster == stats["batches"]
              and stats["padded"] == EXPORT_BATCH * stats["batches"] - stats["served"] > 0
              and err <= EXPORT_CLI_TOL
              and (not track or (assoc == len(answered) and tracked)))
        rec["serve_cli"]["track" if track else "detect"] = {
            "stats": stats, "seconds": seconds, "bev_raster_reduce_launches": raster,
            "track_associate_launches": assoc, "answered": len(answered), "tracked_replies": len(tracked),
            "max_abs_err_vs_live": err}
        if not ok:
            raise AssertionError(f"serve --artifact{' --track' if track else ''}: {rec['serve_cli']}")

    rec["enqueue_ms"] = export_enqueue_times(pts, valid)
    emit(rec)
    return {"detector": {k: c["launches"]["bev_raster_reduce"] for k, c in checks.items()},
            "fused": fused_launches,
            "serve_cli": {k: v["bev_raster_reduce_launches"] for k, v in rec["serve_cli"].items()},
            "serve_cli_track_associate": rec["serve_cli"]["track"]["track_associate_launches"]}


VIZ_FRAMES = 4  # mini-KITTI test frames through the test and fuse CLIs
VIZ_FUSE_MODES = {  # config -> (CLI flags, per-frame launches of each loop kernel)
    "nms": (["--mode", "nms", "--side_by_side"], {"hard_nms_keep": 2, "greedy_match": 0, "soft_nms_gaussian": 0}),
    "weighted": (["--mode", "weighted"], {"hard_nms_keep": 2, "greedy_match": 1, "soft_nms_gaussian": 0}),
    "bayesian": (["--mode", "bayesian"], {"hard_nms_keep": 2, "greedy_match": 1, "soft_nms_gaussian": 0}),
    "bayesian_gaussian": (["--mode", "bayesian", "--gaussian_nms"],
                          {"hard_nms_keep": 1, "greedy_match": 1, "soft_nms_gaussian": 1}),
}
VIZ_LETTERBOX = 640  # the fuse CLI's --imgsz default


class WrittenImages:
    """The arrays the CLIs hand to `data/png.py::write_image_bgr` while the
    block runs, by path relative to `root`. On exit the first file written
    is checked to hold its array's encoding (the JPEG encoder's bytes), so
    comparisons of the arrays speak for the files."""

    def __init__(self, root):
        import sfa3d_tpu_torch.data.png as png

        self.root, self.png, self.images = root, png, {}
        self._real = png.write_image_bgr

    def _write(self, path, img):
        import os

        self.images[os.path.relpath(path, self.root)] = np.array(img)
        self._real(path, img)

    def __enter__(self):
        self.png.write_image_bgr = self._write
        return self.images

    def __exit__(self, *exc):
        import os

        from sfa3d_tpu_torch.data.jpeg import encode_jpeg

        self.png.write_image_bgr = self._real
        if exc[0] is None and self.images:
            name, img = next(iter(self.images.items()))
            with open(os.path.join(self.root, name), "rb") as f:
                if name.endswith(".jpg") and f.read() != encode_jpeg(img):
                    raise AssertionError(f"{name} does not hold the JPEG of the array written")


def integer_corners(rec):
    """The integer pixels a test-CLI frame's drawing starts from: every BEV
    box's corners and every drawn camera box's projected corners."""
    from sfa3d_tpu_torch.geometry.transforms import lidar_to_camera_box
    from sfa3d_tpu_torch.viz.draw import compute_box_3d, get_corners_bev, project_to_image

    mask = rec["mask"]
    out = [get_corners_bev(x, y, w, l, yaw).astype(int) for _, _, x, y, _, _, w, l, yaw in rec["boxes_bev"][mask]]
    real = rec["boxes_real"][mask]
    if len(real):
        calib = rec["calib"]
        cam = lidar_to_camera_box(real[:, 1:8], calib.V2C, calib.R0, calib.P2)
        with np.errstate(invalid="ignore", divide="ignore"):
            out += [project_to_image(compute_box_3d(c[3:6], c[0:3], c[6]), calib.P2) for c in cam if c[2] >= 2.0]
    return out


def fps_header_mask(shape):
    """The box of the fuse CLI's FPS header at (10, 25), scale 0.8, thickness
    2, grown to the widest and deepest header it draws."""
    from sfa3d_tpu_torch.viz import raster

    sizes = [raster.get_text_size(f"{mode} fusion  99999.9 FPS", raster.FONT_HERSHEY_SIMPLEX, 0.8, 2)
             for mode in ("artifact", "bayesian", "weighted", "nms")]
    w, h, base = (max(s[0][0] for s in sizes), max(s[0][1] for s in sizes), max(s[1] for s in sizes))
    mask = np.zeros(shape[:2], bool)
    mask[max(25 - h - 3, 0):25 + base + 3, 0:10 + w + 3] = True
    return mask


class DetectEvents:
    """CUDA events around each call of the CLIs' detect_frames and YOLO
    detector, so a run's per-frame detection ms are device-side spans."""

    def __init__(self):
        import sfa3d_tpu_torch.pipeline as pipeline
        from sfa3d_tpu_torch.models.yolov8 import YOLOv8Detector

        self.pairs = []
        self._pipeline, self._yolo_cls = pipeline, YOLOv8Detector
        self._detect, self._yolo_call = pipeline.detect_frames, YOLOv8Detector.__call__

    def _timed(self, fn):
        def call(*args, **kwargs):
            if kwargs.get("device") is not None and torch.device(kwargs["device"]).type != "cuda":
                return fn(*args, **kwargs)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.pairs.append((start, end))
            return out
        return call

    def __enter__(self):
        self.pairs = []
        self._pipeline.detect_frames = self._timed(self._detect)
        yolo_call = self._timed(self._yolo_call)
        self._yolo_cls.__call__ = lambda det, *a, **k: yolo_call(det, *a, **k)
        return self

    def __exit__(self, *exc):
        self._pipeline.detect_frames = self._detect
        self._yolo_cls.__call__ = self._yolo_call

    def ms(self):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.pairs]


def viz_times(records, device_ms=None, per_frame=1):
    """Median per-frame host ms of each stage of a CLI run (the first frame,
    which pays the warm-up, left out), with the device-side detection ms."""
    rows = records[1:] or records
    out = {k: statistics.median(r[k] for r in rows) for k in ("detect_ms", "fuse_ms", "draw_ms", "write_ms")
           if k in rows[0]}
    if device_ms:
        frames = [sum(device_ms[i:i + per_frame]) for i in range(0, len(device_ms), per_frame)]
        out["detect_device_ms"] = statistics.median(frames[1:] or frames)
    return out


def phase_viz_cli(card, tmp_root):
    """The test and fuse CLIs over a 4-frame mini-KITTI, in process through
    their mains: `test --save_test_output` on the card and on the CPU (the
    same files, one raster launch a frame on the card and none on the CPU,
    the raw BEV dumps equal, the composites equal on every frame whose
    integer box corners are equal, and at least one such frame); `fuse` on
    the card in the nms, weighted,
    bayesian and bayesian --gaussian_nms modes (--side_by_side in the first)
    with each kernel's launches a frame checked; bayesian --gaussian_nms
    again on the CPU (summary.txt and the per-frame counts equal); `fuse
    --artifact` through a batch-1 fused export of the same weights and
    settings (each kernel once a frame as a custom op, the images equal to
    the live run's with the FPS header masked). Per-frame host ms of each
    stage and the device-side detection ms are printed."""
    import contextlib
    import io
    import os

    from sfa3d_tpu_torch.cli import fuse as fuse_cli
    from sfa3d_tpu_torch.cli import test as test_cli
    from sfa3d_tpu_torch.data.png import read_png_rgb
    from sfa3d_tpu_torch.data.synthetic import write_mini_kitti
    from sfa3d_tpu_torch.models.yolov8 import load_yolo_checkpoint, save_ultralytics_checkpoint
    from sfa3d_tpu_torch.runtime.export import export_fused, save_exported

    root = f"{tmp_root}/viz_cli"
    kitti = write_mini_kitti(f"{root}/kitti", n_frames=VIZ_FRAMES, seed=SEED, splits=("test",))
    det = Detector(device="cpu", seed=SEED)
    bump_heatmap_bias(det.model)
    test_pth = f"{root}/kfpn_test.pth"
    torch.save(det.model.state_dict(), test_pth)
    frame0 = read_png_rgb(f"{kitti}/testing/image_2/000000.png")
    fd = FusedDetector(device="cpu", seed=SEED, imgsz=VIZ_LETTERBOX)
    bump_fused_biases(fd, yolo_gate_bias(fd.yolo, frame0, VIZ_LETTERBOX))
    fuse_pth, yolo_pt = f"{root}/kfpn_fuse.pth", f"{root}/yolo.pt"
    torch.save(fd.kfpn.state_dict(), fuse_pth)
    save_ultralytics_checkpoint(fd.yolo, yolo_pt)
    kernels = [bev_raster_reduce, fusion_loops.hard_nms_keep, fusion_loops.greedy_match,
               fusion_loops.soft_nms_gaussian]
    rec = {"phase": "viz_cli", "card": card["nvidia_smi"], "frames": VIZ_FRAMES}

    def run(main, argv):
        """main(argv) quietly -> (records, launches of each kernel, the
        images written by path under --output_dir)."""
        for fn in kernels:
            fn.launches = 0  # count this run's launches only
        with contextlib.redirect_stdout(io.StringIO()), WrittenImages(argv[argv.index("--output_dir") + 1]) as images:
            records = main(argv)
        torch.cuda.synchronize()
        return records, {fn.__name__: fn.launches for fn in kernels}, images

    # --- test: the card and the CPU ---
    base = ["--dataset_dir", kitti, "--pretrained_path", test_pth, "--save_test_output"]
    with DetectEvents() as events:
        card_recs, card_launches, card_files = run(test_cli.main, base + ["--output_dir", f"{root}/test_card"])
    test_device_ms = events.ms()
    cpu_recs, cpu_launches, cpu_files = run(test_cli.main,
                                            base + ["--output_dir", f"{root}/test_cpu", "--platform", "cpu"])
    same_corners = [i for i in range(VIZ_FRAMES)
                    if len(a := integer_corners(card_recs[i])) == len(b := integer_corners(cpu_recs[i]))
                    and all(np.array_equal(x, y) for x, y in zip(a, b))]
    raw_equal = all(np.array_equal(card_files[k], cpu_files[k]) for k in card_files if k.endswith("_raw_bev.jpg"))
    composites_equal = [i for i in same_corners
                        if np.array_equal(card_files[f"{i:06d}.jpg"], cpu_files[f"{i:06d}.jpg"])]
    rec["test"] = {"files": len(card_files), "launches_card": card_launches, "launches_cpu": cpu_launches,
                   "detections_card": [r["n_dets"] for r in card_recs],
                   "detections_cpu": [r["n_dets"] for r in cpu_recs], "raw_bev_equal": raw_equal,
                   "frames_with_equal_corners": len(same_corners),
                   "composites_equal_of_those": len(composites_equal),
                   "card_ms": viz_times(card_recs, test_device_ms), "cpu_ms": viz_times(cpu_recs)}
    print(f"viz_cli: test composites equal card vs CPU on {len(composites_equal)} of {len(same_corners)} frames "
          f"with equal integer corners ({VIZ_FRAMES} frames)", flush=True)
    if (sorted(card_files) != sorted(cpu_files) or len(card_files) != VIZ_FRAMES * 8
            or card_launches["bev_raster_reduce"] != VIZ_FRAMES or any(cpu_launches.values()) or not raw_equal
            or not same_corners or len(composites_equal) != len(same_corners)
            or not any(r["n_dets"] for r in card_recs)):
        raise AssertionError(f"cli test card vs CPU: {rec['test']}")

    # --- fuse: four configurations on the card ---
    fuse_base = ["--dataset_dir", kitti, "--pretrained_path", fuse_pth, "--yolo_weights", yolo_pt]
    rec["fuse"] = {}
    fuse_launches = {}
    for name, (flags, loops) in VIZ_FUSE_MODES.items():
        with DetectEvents() as events:
            recs, launches, images = run(fuse_cli.main, fuse_base + flags + ["--output_dir", f"{root}/fuse_{name}"])
        if name == "bayesian_gaussian":
            live_files = images
        want = {"bev_raster_reduce": VIZ_FRAMES, **{k: v * VIZ_FRAMES for k, v in loops.items()}}
        rec["fuse"][name] = {"launches": launches, "expected": want,
                             "before": [r["before"] for r in recs], "after": [r["after"] for r in recs],
                             "ms": viz_times(recs, events.ms(), per_frame=2)}
        fuse_launches[name] = launches
        if launches != want or not any(r["after"] for r in recs):
            raise AssertionError(f"cli fuse {name}: {rec['fuse'][name]}")
    cpu_out = f"{root}/fuse_cpu"
    cpu_recs, cpu_fuse_launches, _ = run(fuse_cli.main, fuse_base + VIZ_FUSE_MODES["bayesian_gaussian"][0]
                                         + ["--output_dir", cpu_out, "--platform", "cpu"])
    card_summary = open(f"{root}/fuse_bayesian_gaussian/summary.txt").read()
    cpu_summary = open(f"{cpu_out}/summary.txt").read()
    rec["fuse_cpu"] = {"launches": cpu_fuse_launches, "summary_equal": card_summary == cpu_summary,
                       "before": [r["before"] for r in cpu_recs], "after": [r["after"] for r in cpu_recs],
                       "ms": viz_times(cpu_recs)}
    card_counts = (rec["fuse"]["bayesian_gaussian"]["before"], rec["fuse"]["bayesian_gaussian"]["after"])
    if (card_summary != cpu_summary or card_counts != (rec["fuse_cpu"]["before"], rec["fuse_cpu"]["after"])
            or any(cpu_fuse_launches.values())):
        raise AssertionError(f"cli fuse bayesian --gaussian_nms card vs CPU: {rec['fuse_cpu']}, card {card_counts}")

    # --- fuse --artifact: a batch-1 export of the same weights and settings ---
    kfpn = create_model("fpn_resnet_18")
    kfpn.load_state_dict(torch.load(fuse_pth, weights_only=True))
    t0 = time.perf_counter()
    exported, manifest = export_fused(
        kfpn.to(DEVICE).eval(), load_yolo_checkpoint(yolo_pt).to(DEVICE).eval(), batch=1,
        max_points=cnf.MAX_POINTS_FILTERED, img_hw=IMG_HW, letterbox=VIZ_LETTERBOX, K=50, max_yolo=64,
        mode="bayesian", use_gaussian_nms=True, peak_thresh=0.2, sfa_conf_gate=0.3, yolo_conf=0.25,
        confidence_threshold=0.25)
    artifact = f"{root}/fused_b1.sfa3dt"
    save_exported(artifact, exported, manifest)
    export_s = time.perf_counter() - t0
    art_recs, art_launches, art_files = run(fuse_cli.main, ["--dataset_dir", kitti, "--artifact", artifact,
                                                            "--output_dir", f"{root}/fuse_artifact"])
    unequal = [k for k in art_files
               if not np.array_equal(*(f[k][~fps_header_mask(f[k].shape)] for f in (live_files, art_files)))]
    want = {fn.__name__: VIZ_FRAMES for fn in kernels}
    want["hard_nms_keep"] = VIZ_FRAMES  # the YOLO selection; the fused set takes soft-NMS
    rec["fuse_artifact"] = {"launches": art_launches, "expected": want, "export_s": export_s,
                            "images": len(art_files), "images_unequal": unequal,
                            "after": [r["after"] for r in art_recs], "ms": viz_times(art_recs)}
    if art_launches != want or unequal or len(art_files) != VIZ_FRAMES:
        raise AssertionError(f"cli fuse --artifact: {rec['fuse_artifact']}")
    emit(rec)
    return {"test": card_launches, **{f"fuse_{k}": v for k, v in fuse_launches.items()},
            "fuse_artifact": art_launches}


# ---------------------------------------------------------------------------
# the raw-drive CLIs (demo, track) and test's video and KFPN dumps
# ---------------------------------------------------------------------------

DRIVE_FRAMES = 8  # write_mini_drive(motion=True) scans through demo and track
DRIVE_VIDEO_FRAMES = 2  # mini-KITTI frames through test --output_format video --enable_kfpn_viz
JPEG_PSNR_MIN = 30.0  # dB, a decoded AVI frame against the composite handed to the writer
# sha256 of encode_jpeg(x) + decode_jpeg(encode_jpeg(x)).tobytes() for the
# seeded image of round_trip_image(), as the CPU test pins it
# (tests/test_torch_jpeg.py::ROUND_TRIP_SHA256)
JPEG_ROUND_TRIP_SHA256 = "6c674e0284df81b0ed36acf9e3f2468a2174e2752cf42ad852487dad33aeaf68"


def round_trip_image() -> np.ndarray:
    """The seeded 96 x 160 BGR frame of tests/test_torch_jpeg.py."""
    rng = np.random.default_rng(14)
    y, x = np.mgrid[0:96, 0:160]
    img = np.stack([x * 1.5, y * 2.5, (x + y) * 0.8], axis=-1) + rng.normal(0, 4, (96, 160, 3))
    img[30:60, 50:90] = (20, 220, 250)
    return np.clip(img, 0, 255).astype(np.uint8)


def avi_check(path, composites):
    """Read an AVI back through read_avi_frames and the decoder: its frame
    count and size, each stored frame the encoder's bytes of its composite,
    and each decoded frame's error against the composite (max and PSNR)."""
    from sfa3d_tpu_torch.data.avi import read_avi_frames, read_avi_info
    from sfa3d_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

    frames, info = read_avi_frames(path), read_avi_info(path)
    h, w = composites[0].shape[:2]
    if len(frames) != len(composites) or (info["width"], info["height"], info["frames"]) != (w, h, len(composites)):
        raise AssertionError(f"{path}: {len(frames)} frames, {info}, for {len(composites)} composites of {w} x {h}")
    errs, psnrs, decode_ms = [], [], []
    for data, img in zip(frames, composites):
        if data != encode_jpeg(img):
            raise AssertionError(f"{path}: a frame is not the JPEG of its composite")
        t0 = time.perf_counter()
        got = decode_jpeg(data)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        diff = got.astype(np.float64) - img
        errs.append(float(np.abs(diff).max()))
        psnrs.append(float(10 * np.log10(255.0 ** 2 / max(np.mean(diff ** 2), 1e-12))))
    if min(psnrs) < JPEG_PSNR_MIN:
        raise AssertionError(f"{path}: decoded frames at {min(psnrs):.2f} dB PSNR, below {JPEG_PSNR_MIN}")
    return {"frames": len(frames), "size": [w, h], "max_abs_err": max(errs), "psnr_db_min": min(psnrs),
            "psnr_db": psnrs, "decode_ms_median": statistics.median(decode_ms)}


def drive_times(records):
    """Median per-frame host ms of each stage (the first frame left out)."""
    rows = records[1:] or records
    return {k: statistics.median(r[k] for r in rows)
            for k in ("detect_ms", "track_ms", "draw_ms", "encode_ms", "write_ms") if k in rows[0]}


def phase_drive_cli(card, tmp_root):
    """The raw-drive CLIs in process through their mains, on an 8-frame
    write_mini_drive(motion=True) of the port's writer and a KFPN-18 of
    heatmap biases + 2.0: demo (front), demo --two_sides and track, each on
    the card and with --platform cpu (raster launches 1 or 2 a frame and
    track_associate 1 a frame on the card, none on the CPU; per frame the
    detection counts equal and, for track, ids, confirmed and alive equal
    and the boxes of live tracks within TRACK_TOL); every AVI read back
    (frame count and size, each frame the JPEG of its composite, PSNR of the
    decoded frame against the composite at least JPEG_PSNR_MIN); then test
    --output_format video --enable_kfpn_viz over 2 mini-KITTI frames on the
    card (one raster launch a frame, the AVI and 25 dumps a frame). Also the
    JPEG round trip's digest against the CPU test's, and decode ms of a
    375 x 1242 and a 1200 x 1920 frame. Returns the launches of each path."""
    import contextlib
    import hashlib
    import io
    import os

    from sfa3d_tpu_torch.cli import demo as demo_cli
    from sfa3d_tpu_torch.cli import test as test_cli
    from sfa3d_tpu_torch.cli import track as track_cli
    from sfa3d_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
    from sfa3d_tpu_torch.data.synthetic import render_camera_image, synthetic_scene, write_mini_drive, write_mini_kitti
    from sfa3d_tpu_torch.ops.track_associate import track_associate
    from sfa3d_tpu_torch.viz import raster

    root = f"{tmp_root}/drive_cli"
    drive = write_mini_drive(f"{root}/drive", n_frames=DRIVE_FRAMES, seed=SEED, motion=True)
    model = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(SEED))
    bump_heatmap_bias(model)
    pth = f"{root}/kfpn.pth"
    torch.save(model.state_dict(), pth)
    kernels = (bev_raster_reduce, track_associate)
    rec = {"phase": "drive_cli", "card": card["nvidia_smi"], "frames": DRIVE_FRAMES}

    def run(main, argv):
        for fn in kernels:
            fn.launches = 0  # this run's launches only
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            records = main(argv)
        torch.cuda.synchronize()
        return records, {fn.__name__: fn.launches for fn in kernels}, printed.getvalue()

    launches_by_path = {}
    paths = {"demo": (demo_cli.main, [], "demo_fpn_resnet_18.avi", 1),
             "demo_two_sides": (demo_cli.main, ["--two_sides"], "demo_fpn_resnet_18.avi", 2),
             "track": (track_cli.main, [], "track_fpn_resnet_18.avi", 1)}
    for name, (main, flags, avi, windows) in paths.items():
        argv = ["--drive_dir", drive, "--pretrained_path", pth] + flags
        card_recs, card_launches, card_out = run(main, argv + ["--output_dir", f"{root}/{name}_card"])
        cpu_recs, cpu_launches, cpu_out = run(main, argv + ["--output_dir", f"{root}/{name}_cpu", "--platform", "cpu"])
        want = {"bev_raster_reduce": windows * DRIVE_FRAMES,
                "track_associate": DRIVE_FRAMES if name == "track" else 0}
        entry = {"launches_card": card_launches, "launches_expected": want, "launches_cpu": cpu_launches,
                 "card_ms": drive_times(card_recs), "cpu_ms": drive_times(cpu_recs)}
        if card_launches != want or any(cpu_launches.values()) or len(card_recs) != DRIVE_FRAMES:
            raise AssertionError(f"{name}: launches {card_launches} on the card (want {want}), {cpu_launches} on "
                                 f"the CPU, {len(card_recs)} frames")
        if name == "track":
            box_err = 0.0
            for a, b in zip(card_recs, cpu_recs):
                oa, ob = a["outputs"], b["outputs"]
                if any(not np.array_equal(oa[k], ob[k]) for k in ("ids", "confirmed", "alive")):
                    raise AssertionError(f"track frame {a['index']}: ids or flags differ card vs CPU")
                if a["n_dets"] != b["n_dets"]:
                    raise AssertionError(f"track frame {a['index']}: {a['n_dets']} vs {b['n_dets']} detections")
                alive = ob["alive"]
                if alive.any():
                    box_err = max(box_err, float(np.abs(oa["boxes"][alive] - ob["boxes"][alive]).max()))
            if box_err > TRACK_TOL or card_out.splitlines()[-1] != cpu_out.splitlines()[-1]:
                raise AssertionError(f"track boxes card vs CPU {box_err}, or the summary lines differ")
            entry.update({"box_max_abs_err": box_err, "summary": card_out.splitlines()[-1],
                          "confirmed_last_frame": int(card_recs[-1]["outputs"]["confirmed"].sum())})
        else:
            counts = [[int(m.sum()) for m in r["mask"]] for r in card_recs]
            if counts != [[int(m.sum()) for m in r["mask"]] for r in cpu_recs] or not any(map(any, counts)):
                raise AssertionError(f"{name}: detection counts card {counts} vs CPU")
            entry["detections_per_window"] = counts
        entry["avi_card"] = avi_check(f"{root}/{name}_card/{avi}", [r["composite"] for r in card_recs])
        entry["avi_cpu"] = avi_check(f"{root}/{name}_cpu/{avi}", [r["composite"] for r in cpu_recs])
        rec[name] = entry
        launches_by_path[name] = card_launches
        print(f"drive_cli: {name} card ms a frame {entry['card_ms']}; AVI PSNR >= "
              f"{entry['avi_card']['psnr_db_min']:.2f} dB", flush=True)

    # test --output_format video --enable_kfpn_viz on the card
    kitti = write_mini_kitti(f"{root}/kitti", n_frames=DRIVE_VIDEO_FRAMES, seed=SEED, splits=("test",))
    out = f"{root}/test_video"
    recs, launches, _ = run(test_cli.main, ["--dataset_dir", kitti, "--pretrained_path", pth, "--output_format",
                                            "video", "--enable_kfpn_viz", "--output_dir", out])
    dumps = sorted(d for d in os.listdir(out) if d.startswith("kfpn_viz_"))
    rec["test_video"] = {"launches": launches, "dumps": {d: len(os.listdir(f"{out}/{d}")) for d in dumps},
                         "avi": avi_check(f"{out}/fpn_resnet_18.avi", [r["composite"] for r in recs]),
                         "card_ms": viz_times(recs)}
    if (launches["bev_raster_reduce"] != DRIVE_VIDEO_FRAMES or len(dumps) != DRIVE_VIDEO_FRAMES
            or any(n != 25 for n in rec["test_video"]["dumps"].values())):
        raise AssertionError(f"test --output_format video --enable_kfpn_viz: {rec['test_video']}")
    launches_by_path["test_video"] = launches

    # the codec on this machine's numpy: the pinned round trip, and decode times
    x = round_trip_image()
    data = encode_jpeg(x)
    digest = hashlib.sha256(data + decode_jpeg(data).tobytes()).hexdigest()
    if digest != JPEG_ROUND_TRIP_SHA256:
        raise AssertionError(f"JPEG round trip digest {digest} differs from the CPU test's {JPEG_ROUND_TRIP_SHA256}")
    points, labels = synthetic_scene(seed=SEED)
    kitti_frame = np.ascontiguousarray(render_camera_image(points, labels, np.asarray(cnf.P2)[:3])[:, :, ::-1])
    argo_frame = raster.resize(kitti_frame, (1920, 1200))
    codec = {"round_trip_sha256": digest}
    for name, img in (("375x1242", kitti_frame), ("1200x1920", argo_frame)):
        t0 = time.perf_counter()
        data = encode_jpeg(img)
        t1 = time.perf_counter()
        decode_jpeg(data)
        t2 = time.perf_counter()
        codec[name] = {"encode_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3, "bytes": len(data)}
    rec["codec"] = codec
    print(f"drive_cli: JPEG decode {codec['375x1242']['decode_ms']:.1f} ms at 375 x 1242, "
          f"{codec['1200x1920']['decode_ms']:.1f} ms at 1200 x 1920; round trip digest equal", flush=True)
    emit(rec)
    return launches_by_path


# ---------------------------------------------------------------------------
# geometry and SLAM: the RANSAC estimators, ORB and the matcher, and the
# slam and stereo-calib CLIs
# ---------------------------------------------------------------------------

SLAM_FRAMES = 4  # mini-KITTI test frames through cli slam in each configuration
SLAM_STEREO_PAIRS = 2  # training pairs through cli stereo-calib --run_yolo
SLAM_CONFIGS = {  # config -> cli slam flags (the default bayesian fusion)
    "KITTI_DATASET_CALIB": ["--calib_method", "KITTI_DATASET_CALIB"],
    "VISUAL_SLAM_SIM": ["--calib_method", "VISUAL_SLAM_SIM"],
    "LIDAR_SLAM_SIM": ["--calib_method", "LIDAR_SLAM_SIM"],
    "VISUAL_INERTIAL_SLAM_SIM": ["--calib_method", "VISUAL_INERTIAL_SLAM_SIM"],
    "VISUAL_SLAM_SIM_pnp": ["--calib_method", "VISUAL_SLAM_SIM", "--use_pnp"],
}
SLAM_FRAME_LAUNCHES = {"bev_raster_reduce": 1, "hard_nms_keep": 2, "greedy_match": 1, "soft_nms_gaussian": 0}
SLAM_PAIR_LAUNCHES = {"bev_raster_reduce": 0, "hard_nms_keep": 1, "greedy_match": 0, "soft_nms_gaussian": 0}
SLAM_F64_TOL = 1e-8  # float64 estimators card vs CPU: cuSOLVER vs LAPACK round-off
# float32 inputs card vs CPU: the estimators solve in float64 and round the
# result, so within 1e-5, or twice the CPU's gap to its float64 run where larger
SLAM_F32_TOL = 1e-5
SLAM_CALIB_TOL = 1e-5  # cli slam's calibration matrices card vs CPU
STEREO_ROT_DEG, STEREO_TX_MIN, STEREO_INLIERS_MIN = 3.0, 0.98, 100  # tests/test_slam.py's bounds


def slam_pose_problem(rng, n=48, n_outliers=8, slots=64):
    """Padded 3D <-> 2D correspondences seen through a known pose, 0.5 px
    noise and gross outliers (tests/test_slam.py's problem)."""
    from sfa3d_tpu_torch.slam.pnp import rodrigues

    R = rodrigues([0.05, -0.1, 0.03], "cpu").double().numpy()
    K = np.array([[720.0, 0, 609.0], [0, 720.0, 172.0], [0, 0, 1.0]])
    pts = np.stack([rng.uniform(-8, 8, slots), rng.uniform(-3, 3, slots), rng.uniform(6, 25, slots)], 1)
    uv = (pts @ R.T + [0.3, -0.2, 0.5]) @ K.T
    uv = uv[:, :2] / uv[:, 2:3] + rng.normal(0, 0.5, (slots, 2))
    uv[rng.permutation(n)[:n_outliers]] += rng.uniform(40, 200, (n_outliers, 2))
    return pts, uv, K, np.arange(slots) < n


def slam_stereo_problem(rng, n=700, n_outliers=120, slots=1024):
    """Padded stereo matches of random points seen by two cameras 0.3 rad
    apart, 0.3 px noise and gross outliers."""
    from sfa3d_tpu_torch.slam.pnp import rodrigues

    R = rodrigues([0.02, 0.3, -0.01], "cpu").double().numpy()
    K = np.array([[720.0, 0, 609.0], [0, 720.0, 172.0], [0, 0, 1.0]])
    X = np.stack([rng.uniform(-10, 10, slots), rng.uniform(-4, 4, slots), rng.uniform(5, 40, slots)], 1)
    uv1, uv2 = X @ K.T, (X @ R.T + [-1.0, 0.01, 0.02]) @ K.T
    uv1 = uv1[:, :2] / uv1[:, 2:3] + rng.normal(0, 0.3, (slots, 2))
    uv2 = uv2[:, :2] / uv2[:, 2:3] + rng.normal(0, 0.3, (slots, 2))
    uv2[rng.permutation(n)[:n_outliers]] += rng.uniform(30, 150, (n_outliers, 2))
    return uv1, uv2, K, np.arange(slots) < n


def _gap(a, b):
    a, b = (x.detach().cpu().double().numpy() for x in (a, b))
    return float(np.abs(a - b).max())


def _unit_sign(F):
    F = F.detach().cpu().double().numpy()
    F = F / np.linalg.norm(F)
    return F * np.sign(F.ravel()[np.argmax(np.abs(F.ravel()))])


def slam_ransac_parity(rng):
    """ransac_pnp (128 hypotheses of 6 of 64 slots) and
    estimate_fundamental_ransac (256 of 8 of 1024) -> essential ->
    recover_pose on the card and the CPU with the same minimal sets, in
    float64 and float32; host ms of each on the card."""
    from sfa3d_tpu_torch.slam import epipolar, pnp

    out = {}
    pts, uv, K, valid = slam_pose_problem(rng)
    sample_idx = pnp.draw_samples(valid, 128, 6, SEED)
    runs = {}
    for dtype in (np.float64, np.float32):
        for dev in (DEVICE, "cpu"):
            runs[dtype, str(dev)] = pnp.ransac_pnp(pts.astype(dtype), uv.astype(dtype), K.astype(dtype), valid,
                                                   sample_idx=sample_idx, device=dev)
    card64, cpu64 = runs[np.float64, str(DEVICE)], runs[np.float64, "cpu"]
    card32, cpu32 = runs[np.float32, str(DEVICE)], runs[np.float32, "cpu"]
    cpu_gap_r = _gap(cpu32[0][:, :3], cpu64[0][:, :3])
    cpu_gap_t = _gap(cpu32[0][:, 3], cpu64[0][:, 3])
    pnp_rec = {"float64_pose_err": _gap(card64[0], cpu64[0]),
               "float64_masks_equal": bool(torch.equal(card64[1].cpu(), cpu64[1])),
               "float32_rot_err": _gap(card32[0][:, :3], cpu32[0][:, :3]),
               "float32_t_err": _gap(card32[0][:, 3], cpu32[0][:, 3]),
               "cpu_float32_gap_to_float64": [cpu_gap_r, cpu_gap_t],
               "float32_mask_diff": int((card32[1].cpu() != cpu32[1]).sum()),
               "inliers": [int(card32[2]), int(cpu32[2])]}
    if (pnp_rec["float64_pose_err"] > SLAM_F64_TOL or not pnp_rec["float64_masks_equal"]
            or pnp_rec["float32_rot_err"] > max(SLAM_F32_TOL, 2 * cpu_gap_r)
            or pnp_rec["float32_t_err"] > max(SLAM_F32_TOL, 2 * cpu_gap_t)
            or pnp_rec["float32_mask_diff"] or int(card32[2]) < 30):
        raise AssertionError(f"ransac_pnp card vs CPU: {pnp_rec}")
    pts32, uv32, K32 = pts.astype(np.float32), uv.astype(np.float32), K.astype(np.float32)
    pnp_rec["card_ms"] = host_ms(lambda: pnp.ransac_pnp(pts32, uv32, K32, valid, sample_idx=sample_idx,
                                                        device=DEVICE)[2].item())
    out["ransac_pnp"] = pnp_rec

    uv1, uv2, K, valid = slam_stereo_problem(rng)
    sample_idx = pnp.draw_samples(valid, 256, 8, SEED)
    chain = {}
    for dtype in (np.float64, np.float32):
        for dev in (DEVICE, "cpu"):
            F, mask = epipolar.estimate_fundamental_ransac(uv1.astype(dtype), uv2.astype(dtype), valid,
                                                           sample_idx=sample_idx, device=dev)
            E = epipolar.essential_from_fundamental(F, K.astype(dtype), K.astype(dtype))
            chain[dtype, str(dev)] = (F, mask) + tuple(epipolar.recover_pose(E, uv1.astype(dtype), uv2.astype(dtype),
                                                                             K.astype(dtype), mask))
    f_rec = {}
    ref = chain[np.float64, "cpu"]
    for dtype in (np.float64, np.float32):
        a, b = chain[dtype, str(DEVICE)], chain[dtype, "cpu"]
        name = np.dtype(dtype).name
        f_rec[name] = {"F_err": float(np.abs(_unit_sign(a[0]) - _unit_sign(b[0])).max()),
                       "mask_diff": int((a[1].cpu() != b[1]).sum()), "R_err": _gap(a[2], b[2]),
                       "t_err": _gap(a[3], b[3]), "cheirality": [float(a[4]), float(b[4])],
                       "inliers": int(a[1].sum())}
        r = f_rec[name]
        if dtype == np.float64:
            tol_F = tol_R = tol_t = SLAM_F64_TOL
        else:  # the card against the CPU's own rounding of its float64 solve
            r["cpu_gap_to_float64"] = [_gap(b[2], ref[2]), _gap(b[3], ref[3])]
            tol_F = SLAM_F32_TOL
            tol_R = max(SLAM_F32_TOL, 2 * r["cpu_gap_to_float64"][0])
            tol_t = max(SLAM_F32_TOL, 2 * r["cpu_gap_to_float64"][1])
        if (r["F_err"] > tol_F or r["R_err"] > tol_R or r["t_err"] > tol_t or r["mask_diff"]
                or r["inliers"] < 500 or min(r["cheirality"]) < 0.7):
            raise AssertionError(f"F-RANSAC -> recover_pose card vs CPU ({name}): {r}")
    a32, b32 = uv1.astype(np.float32), uv2.astype(np.float32)
    F, mask = epipolar.estimate_fundamental_ransac(a32, b32, valid, sample_idx=sample_idx, device=DEVICE)
    E = epipolar.essential_from_fundamental(F, K.astype(np.float32), K.astype(np.float32))
    f_rec["f_ransac_card_ms"] = host_ms(lambda: epipolar.estimate_fundamental_ransac(
        a32, b32, valid, sample_idx=sample_idx, device=DEVICE)[1].sum().item())
    f_rec["recover_pose_card_ms"] = host_ms(lambda: epipolar.recover_pose(E, a32, b32, K.astype(np.float32),
                                                                          mask)[2].item())
    out["fundamental_chain"] = f_rec
    return out


def slam_weights(root, kitti):
    """A KFPN-18 .pth and a YOLOv8n .pt whose random weights give the fusion
    work (the viz_cli phase's biases)."""
    from sfa3d_tpu_torch.data.png import read_png_rgb
    from sfa3d_tpu_torch.models.yolov8 import save_ultralytics_checkpoint

    fd = FusedDetector(device="cpu", seed=SEED, imgsz=VIZ_LETTERBOX)
    bump_fused_biases(fd, yolo_gate_bias(fd.yolo, read_png_rgb(f"{kitti}/testing/image_2/000000.png"),
                                         VIZ_LETTERBOX))
    pth, pt = f"{root}/kfpn.pth", f"{root}/yolo.pt"
    torch.save(fd.kfpn.state_dict(), pth)
    save_ultralytics_checkpoint(fd.yolo, pt)
    return pth, pt


def phase_slam(card, tmp_root):
    """Geometry and SLAM on the card. RANSAC: ransac_pnp and the
    fundamental chain card vs CPU on the same minimal sets (float64 within
    1e-8; float32 within the stated round-off bounds). ORB on the port
    writer's 375 x 1242 stereo pair card vs CPU: keypoints (points,
    octaves, angles, responses), descriptors and the cross-checked matches
    equal; then the calibration on the card within tests/test_slam.py's
    bounds. cli stereo-calib --run_yolo over 2 pairs: `calibrated 2/2`,
    hard_nms_keep once a pair. cli slam over 4 mini-KITTI frames in each
    --calib_method and VISUAL_SLAM_SIM --use_pnp, on the card and with
    --platform cpu: the drift sources' calibrations equal and --use_pnp's
    within 1e-5 (its PnP solves in float64 on both), the fused counts
    equal, and the images equal on every frame whose fused boxes are equal
    (the networks differ card vs CPU within 1e-3, so a box corner can round
    apart), at least one such frame; each kernel's launches a frame
    checked. Host ms of each stage. Returns the launches of each path."""
    import contextlib
    import io

    from sfa3d_tpu_torch.cli import slam as slam_cli
    from sfa3d_tpu_torch.cli import stereo_calib as stereo_cli
    from sfa3d_tpu_torch.data.png import read_png_grey
    from sfa3d_tpu_torch.data.synthetic import write_mini_kitti
    from sfa3d_tpu_torch.geometry.calibration import read_calib_file
    from sfa3d_tpu_torch.slam import orb, stereo

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    rec = {"phase": "slam", "card": card["nvidia_smi"]}
    rec.update(slam_ransac_parity(rng))

    root = f"{tmp_root}/slam"
    kitti = write_mini_kitti(f"{root}/kitti", n_frames=SLAM_FRAMES, seed=SEED)
    left, right = (read_png_grey(f"{kitti}/training/image_{s}/000000.png") for s in (2, 3))
    K = read_calib_file(f"{kitti}/training/calib/000000.txt")["P2"].reshape(3, 4)[:, :3]

    # --- ORB and the matcher, card vs CPU ---
    orb.detect_and_compute(left, device=DEVICE)  # warm-up
    torch.cuda.synchronize()
    orb_rec, sides = {}, {}
    for name, img in (("left", left), ("right", right)):
        card_t = {}
        kp_card, des_card = orb.detect_and_compute(img, device=DEVICE, timings=card_t)
        cpu_t = {}
        kp_cpu, des_cpu = orb.detect_and_compute(img, device="cpu", timings=cpu_t)
        equal = (all(np.array_equal(kp_card[k], kp_cpu[k]) for k in kp_card)
                 and torch.equal(des_card.cpu(), des_cpu))
        orb_rec[name] = {"keypoints": len(kp_card["pt"]), "per_level": np.bincount(kp_card["octave"]).tolist(),
                         "equal_card_cpu": equal, "card_ms": card_t, "cpu_ms": cpu_t}
        if not equal:
            raise AssertionError(f"ORB {name}: keypoints or descriptors differ card vs CPU")
        sides[name] = (des_card, des_cpu)
    match_card = stereo.match_descriptors(sides["left"][0], sides["right"][0])
    match_cpu = stereo.match_descriptors(sides["left"][1], sides["right"][1])
    if not all(torch.equal(a.cpu(), b) for a, b in zip(match_card, match_cpu)):
        raise AssertionError("the matches differ card vs CPU")
    orb_rec["matches"] = len(match_card[0])
    orb_rec["match_card_ms"] = host_ms(lambda: stereo.match_descriptors(sides["left"][0], sides["right"][0])[0].sum().item())
    orb_rec["match_cpu_ms"] = host_ms(lambda: stereo.match_descriptors(sides["left"][1], sides["right"][1]), reps=3)
    rec["orb"] = orb_rec

    stage_t = {}
    result = stereo.perform_targetless_stereo_calibration(left, right, K, device=DEVICE, timings=stage_t)
    angle = float(np.degrees(np.arccos(np.clip((np.trace(result.R) - 1) / 2, -1, 1)))) if result.success else None
    tx = float(abs(result.t[0]) / np.linalg.norm(result.t)) if result.success else None
    rec["calibration"] = {"success": result.success, "matches": result.n_matches, "inliers": result.n_inliers,
                          "cheirality": result.cheirality_fraction, "rotation_deg": angle, "t_x": tx,
                          "card_ms": {k: v for k, v in stage_t.items() if not k.startswith("orb_")},
                          "orb_card_ms": sum(v for k, v in stage_t.items() if k.startswith("orb_"))}
    if (not result.success or result.n_inliers < STEREO_INLIERS_MIN or angle >= STEREO_ROT_DEG
            or tx <= STEREO_TX_MIN):
        raise AssertionError(f"stereo calibration on the card: {rec['calibration']}")
    print(f"slam: ORB {orb_rec['left']['keypoints']} + {orb_rec['right']['keypoints']} keypoints, "
          f"{orb_rec['matches']} matches, equal card vs CPU; calibration {result.n_inliers} inliers, "
          f"R {angle:.3f} deg off identity, |t_x| {tx:.5f}", flush=True)

    pth, pt = slam_weights(root, kitti)
    kernels = [bev_raster_reduce, fusion_loops.hard_nms_keep, fusion_loops.greedy_match,
               fusion_loops.soft_nms_gaussian]

    def run(main, argv):
        for fn in kernels:
            fn.launches = 0  # this run's launches only
        out_dir = argv[argv.index("--output_dir") + 1]
        with contextlib.redirect_stdout(io.StringIO()) as printed, WrittenImages(out_dir) as images:
            records = main(argv)
        torch.cuda.synchronize()
        return records, {fn.__name__: fn.launches for fn in kernels}, images, printed.getvalue()

    # --- cli stereo-calib --run_yolo over 2 pairs, on the card ---
    argv = ["--dataset_dir", kitti, "--num_samples", str(SLAM_STEREO_PAIRS), "--run_yolo", "--yolo_weights", pt,
            "--output_dir", f"{root}/stereo_calib"]
    recs, launches, images, printed = run(stereo_cli.main, argv)
    summary = printed.splitlines()[-1]
    rec["stereo_calib_cli"] = {"summary": summary, "launches": launches, "images": sorted(images),
                               "pairs": [{"id": r["id"], "inliers": r["result"].n_inliers,
                                          "ms": {k: v for k, v in r["timings"].items() if not k.startswith("orb_")},
                                          "orb_ms": sum(v for k, v in r["timings"].items() if k.startswith("orb_"))}
                                         for r in recs]}
    want = {k: v * SLAM_STEREO_PAIRS for k, v in SLAM_PAIR_LAUNCHES.items()}
    if summary != f"calibrated {SLAM_STEREO_PAIRS}/{SLAM_STEREO_PAIRS} pairs successfully" or launches != want:
        raise AssertionError(f"cli stereo-calib: {rec['stereo_calib_cli']}")

    # --- cli slam: each configuration on the card and on the CPU ---
    base = ["--dataset_dir", kitti, "--pretrained_path", pth, "--yolo_weights", pt]
    rec["slam_cli"], launches_by_path = {}, {}
    for name, flags in SLAM_CONFIGS.items():
        card_recs, card_launches, card_images, card_out = run(slam_cli.main, base + flags + [
            "--output_dir", f"{root}/slam_{name}_card"])
        cpu_recs, cpu_launches, cpu_images, cpu_out = run(slam_cli.main, base + flags + [
            "--output_dir", f"{root}/slam_{name}_cpu", "--platform", "cpu"])
        want = {k: v * SLAM_FRAMES for k, v in SLAM_FRAME_LAUNCHES.items()}
        calib_err = max(float(np.abs(a["calib"][k] - b["calib"][k]).max())
                        for a, b in zip(card_recs, cpu_recs) for k in ("P2", "R0", "V2C"))
        same_boxes = [f"{a['sample_id']:06d}_slam.jpg" for a, b in zip(card_recs, cpu_recs)
                      if np.array_equal(a["boxes"], b["boxes"])]
        differing = {k: int((card_images[k] != cpu_images[k]).any(2).sum()) for k in card_images}
        entry = {"launches": card_launches, "expected": want, "launches_cpu": cpu_launches,
                 "launches_per_frame": {k: v / SLAM_FRAMES for k, v in card_launches.items()},
                 "fused": [r["fused"] for r in card_recs], "fused_cpu": [r["fused"] for r in cpu_recs],
                 "calib_max_abs_err": calib_err, "frames_with_equal_boxes": len(same_boxes),
                 "pixels_differing": differing,
                 "card_ms": {k: statistics.median(r[k] for r in card_recs[1:])
                             for k in ("detect_ms", "calib_ms", "fuse_ms", "draw_ms", "write_ms")},
                 "cpu_ms": {k: statistics.median(r[k] for r in cpu_recs[1:])
                            for k in ("detect_ms", "calib_ms", "fuse_ms", "draw_ms", "write_ms")}}
        calib_tol = SLAM_CALIB_TOL if "--use_pnp" in flags else 0.0
        ok = (card_launches == want and not any(cpu_launches.values()) and sorted(card_images) == sorted(cpu_images)
              and len(card_images) == SLAM_FRAMES and any(entry["fused"]) and calib_err <= calib_tol
              and entry["fused"] == entry["fused_cpu"] and card_out == cpu_out and bool(same_boxes)
              and not any(differing[k] for k in same_boxes))
        rec["slam_cli"][name] = entry
        launches_by_path[f"slam_cli_{name}"] = card_launches
        if not ok:
            raise AssertionError(f"cli slam {name}: {entry}")
        print(f"slam: cli slam {name} card ms a frame {entry['card_ms']}; calibration card vs CPU {calib_err:.3g}; "
              f"pixels differing {sum(differing.values())}", flush=True)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    launches_by_path["stereo_calib_cli"] = rec["stereo_calib_cli"]["launches"]
    return launches_by_path


# ---------------------------------------------------------------------------
# bfloat16 inference and the training options
# ---------------------------------------------------------------------------

BF16_AUDIT = "BF16_AUDIT.json"  # the JAX package's bf16 audit: per-field deviations from float32, trained weights
BF16_FIELDS = ("x_m", "y_m", "z_m", "h_m", "w_m", "l_m", "yaw_rad", "conf")
BF16_ENVELOPE_MULT = 3.0  # p95 of a field's bf16 deviation from the card's float32: 3 x the JAX audit's p95
BF16_MATCH_MIN = 0.9  # float32 detections (and fused rows) matched by a bf16 one
BF16_ROW_PX = 8  # fused 2D rows: matched by class and source, every coordinate within 8 px
BF16_LOOPS = ("hard_nms_keep", "soft_nms_gaussian", "greedy_match")


def bf16_envelope():
    """The JAX audit's per-field deviation statistics (BF16_AUDIT.json, in
    the checkout beside this script): {field: {"p50", "p95", "max"}}."""
    import os

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), BF16_AUDIT)) as f:
        dev = json.load(f)["per_field_abs_deviation"]
    return {k: dev[k] for k in BF16_FIELDS}


def bf16_check(what, f32_frames, bf16_frames, envelope):
    """Each frame's bf16 detections matched to its float32 ones (same class,
    the nearest centre within 1 m: scripts/torch_bf16_audit.py's
    match_and_diff). Frames are (boxes_real (K, 8), scores (K,), mask (K,)).
    Raises below BF16_MATCH_MIN, or where a field's p95 deviation exceeds
    BF16_ENVELOPE_MULT times the JAX audit's p95. The largest deviations
    are reported, not held: as in the JAX audit (x 0.337 m, one heatmap
    cell), a bfloat16 peak can take a neighbouring cell. Returns the
    statistics."""
    from scripts.torch_bf16_audit import deviation_stats, match_and_diff

    rows, counts = [], np.zeros(3, np.int64)
    for (ra, sa, ma), (rb, sb, mb) in zip(f32_frames, bf16_frames):
        r, c = match_and_diff(ra, sa, ma, rb, sb, mb)
        rows += r
        counts += c
    limit = BF16_ENVELOPE_MULT * np.array([envelope[f]["p95"] for f in BF16_FIELDS])
    rate = counts[2] / max(1, counts[0], counts[1])
    if counts[2] == 0 or rate < BF16_MATCH_MIN:
        raise AssertionError(f"{what}: {counts[2]} of {counts[0]} float32 detections matched in bfloat16")
    stats = deviation_stats(rows)
    over = {f: [stats[f]["p95"], float(lim)] for f, lim in zip(BF16_FIELDS, limit) if stats[f]["p95"] > lim}
    if over:
        raise AssertionError(f"{what}: bfloat16 p95 deviations beyond the envelope: {over}")
    return {"detections_f32": int(counts[0]), "detections_bf16": int(counts[1]), "matched": int(counts[2]),
            "match_rate": float(rate), "deviation": stats, "p95_limit": dict(zip(BF16_FIELDS, limit.tolist()))}


def fused_row_match(f32_out, bf16_out):
    """The fused 2D rows of each frame, bf16 against float32: matched by
    class and source with every coordinate within BF16_ROW_PX -> (rows
    f32, rows bf16, matched, largest coordinate and score deviation)."""
    n_a = n_b = matched = 0
    px = score = 0.0
    for f in range(f32_out["valid"].shape[0]):
        a, b = reply_rows(fused_reply(f32_out, f)), reply_rows(fused_reply(bf16_out, f))
        n_a, n_b = n_a + len(a), n_b + len(b)
        used = np.zeros(len(b), bool)
        for row in a:
            if not len(b):
                break
            d = np.abs(b[:, :4] - row[:4]).max(1)
            d = np.where(used | (b[:, 4] != row[4]) | (b[:, 5] != row[5]), np.inf, d)
            j = int(np.argmin(d))
            if d[j] <= BF16_ROW_PX:
                used[j] = True
                matched += 1
                px, score = max(px, float(d[j])), max(score, abs(float(b[j, 6] - row[6])))
    return {"rows_f32": n_a, "rows_bf16": n_b, "matched": matched, "match_rate": matched / max(1, n_a, n_b),
            "max_coordinate_px": px, "max_score": score}


def phase_bf16_serve(card, tmp_root):
    """Detector and FusedDetector in bfloat16 (bfloat16 convolution
    weights, float32 BatchNorm, the raster and every stage after the
    networks float32) on the card, on fused_serve's conditioned weights
    with boxes of KITTI's sizes (through .pth / .pt files) and its 16
    requests, in batches of 8 and 1: detections held to
    the card's strict float32 run (bf16_check; the fused 2D rows' match
    rate at least BF16_MATCH_MIN), the raw heads and YOLO levels bfloat16, one launch of
    bev_raster_reduce (and of each loop kernel, fused) a batch; ms a batch
    in each dtype at buckets 1 and 8, KFPN and YOLOv8n device ms at batch
    8; one `serve --dtype bfloat16 --fused` request through the CLI."""
    import os

    from sfa3d_tpu_torch.data.png import write_png_rgb

    envelope = bf16_envelope()
    reqs = fused_requests(16)
    base = FusedDetector(imgsz=CANVAS, device=DEVICE, seed=SEED)
    bump_fused_biases(base, yolo_gate_bias(base.yolo, reqs[0][1]), tall_boxes=False)
    kfpn_path, yolo_path = os.path.join(tmp_root, "bf16_kfpn.pth"), os.path.join(tmp_root, "bf16_yolov8n.pt")
    torch.save(base.kfpn.state_dict(), kfpn_path)
    torch.save({"model": base.yolo.state_dict()}, yolo_path)
    dtypes = ("float32", "bfloat16")
    fds = {dt: FusedDetector(checkpoint=kfpn_path, yolo_checkpoint=yolo_path, imgsz=CANVAS, device=DEVICE,
                             dtype=dt) for dt in dtypes}
    dets = {dt: Detector(checkpoint=kfpn_path, device=DEVICE, dtype=dt) for dt in dtypes}
    prepared = []
    for points, image, calib in reqs:
        pts, valid = bev_ops.filter_and_pad_points(points, N)
        img, r, pad = letterbox(image, CANVAS)
        prepared.append((pts, valid, img, calib.V2C.astype(np.float32), calib.R0.astype(np.float32),
                         calib.P2.astype(np.float32), np.float32(IMG_HW), np.float32(r), np.float32(pad)))
    batches = [[np.stack(a) for a in zip(*prepared[i:i + 8])] for i in range(0, len(prepared), 8)]

    # the networks run in bfloat16: the raw heads and YOLO levels of a bf16 batch
    seen = []
    hooks = [m.register_forward_hook(lambda mod, args, out: seen.append(out))
             for m in (fds["bfloat16"].kfpn, fds["bfloat16"].yolo, dets["bfloat16"].model)]
    counted = [bev_raster_reduce, *(getattr(fusion_loops, k) for k in BF16_LOOPS)]
    try:
        outs = {dt: {"lidar": [], "fused": []} for dt in dtypes}
        launches = {}
        for dt in dtypes:
            for bucket in (8, 1):
                for fn in counted:
                    fn.launches = 0
                got = ([fds[dt].run_batch(*batch) for batch in batches] if bucket == 8
                       else [fds[dt].run_batch(*[a[i:i + 1] for a in batch]) for batch in batches for i in range(8)])
                fused_l = {fn.__name__: fn.launches for fn in counted}
                for fn in counted:
                    fn.launches = 0
                lidar = ([dets[dt].detect_batch(b[0], b[1]) for b in batches] if bucket == 8
                         else [dets[dt].detect_batch(b[0][i:i + 1], b[1][i:i + 1]) for b in batches for i in range(8)])
                lidar_l = bev_raster_reduce.launches
                n = len(got)
                if any(v != n for v in fused_l.values()) or lidar_l != n:
                    raise AssertionError(f"{dt} bucket {bucket}: launches {fused_l}, LiDAR raster {lidar_l} "
                                         f"for {n} batches")
                launches[f"{dt}_bucket{bucket}"] = {"batches": n, "fused": fused_l, "lidar_raster": lidar_l}
                if bucket == 8:
                    outs[dt]["fused"], outs[dt]["lidar"] = got, lidar
    finally:
        for h in hooks:
            h.remove()
    head_dtypes = sorted({str(t.dtype) for out in seen for t in _leaves(out)})
    if head_dtypes != ["torch.bfloat16"]:
        raise AssertionError(f"the bfloat16 networks returned {head_dtypes}")

    def frames(outs_list, kind):
        if kind == "lidar":
            return [(o["boxes_real"][i], o["detections"][i, :, 0], o["mask"][i])
                    for o in outs_list for i in range(o["mask"].shape[0])]
        return [(o["boxes_real"][i], np.zeros(o["mask_3d"].shape[1], np.float32), o["mask_3d"][i])
                for o in outs_list for i in range(o["mask_3d"].shape[0])]

    lidar_cmp = bf16_check("LiDAR Detector", frames(outs["float32"]["lidar"], "lidar"),
                           frames(outs["bfloat16"]["lidar"], "lidar"), envelope)
    fused3d_cmp = bf16_check("FusedDetector 3D branch", frames(outs["float32"]["fused"], "fused"),
                             frames(outs["bfloat16"]["fused"], "fused"), envelope)
    rows = [fused_row_match(a, b) for a, b in zip(outs["float32"]["fused"], outs["bfloat16"]["fused"])]
    rows = {k: (max if k.startswith("max") else sum)(r[k] for r in rows) for k in rows[0] if k != "match_rate"}
    rows["match_rate"] = rows["matched"] / max(1, rows["rows_f32"], rows["rows_bf16"])
    if not rows["rows_f32"] or rows["match_rate"] < BF16_MATCH_MIN:
        raise AssertionError(f"fused rows, bfloat16 against float32: {rows}")

    times = {}
    batch8 = batches[0]
    for dt in dtypes:
        times[dt] = {f"fused_bucket{b}_ms": host_ms(lambda: fds[dt].run_batch(*[a[:b] for a in batch8]))
                     for b in (1, 8)}
        times[dt].update({f"lidar_bucket{b}_ms": host_ms(lambda: dets[dt].detect_batch(batch8[0][:b], batch8[1][:b]))
                          for b in (1, 8)})
        with torch.inference_mode():
            bev = bev_ops.points_to_bev_nchw(torch.from_numpy(batch8[0]).to(DEVICE),
                                             torch.from_numpy(batch8[1]).to(DEVICE))
            images = torch.from_numpy(batch8[2]).to(DEVICE)
            kfpn, yolo = fds[dt].kfpn, fds[dt].yolo
            times[dt]["kfpn_batch8_ms"] = cuda_ms(lambda: _heads_nhwc(kfpn, bev))
            times[dt]["yolo_batch8_ms"] = cuda_ms(lambda: yolo(images.permute(0, 3, 1, 2)))
    speedup = {k: times["float32"][k] / times["bfloat16"][k] for k in times["float32"]}

    # one serve --dtype bfloat16 --fused request through the CLI, on these weights
    scan_path, image_path = os.path.join(tmp_root, "bf16_000000.bin"), os.path.join(tmp_root, "bf16_000000.png")
    reqs[0][0].astype(np.float32).tofile(scan_path)
    write_png_rgb(image_path, reqs[0][1])
    for fn in counted:
        fn.launches = 0
    replies, stats, cli_s = run_serve_cli(
        ["--dtype", "bfloat16", "--fused", "--pretrained_path", kfpn_path, "--yolo_checkpoint", yolo_path],
        [{"id": 1, "lidar": scan_path, "image": image_path}])
    cli_l = {fn.__name__: fn.launches for fn in counted}
    if (len(replies) != 1 or "fused" not in replies[0] or stats["served"] != 1
            or any(v != stats["batches"] for v in cli_l.values())):
        raise AssertionError(f"serve --dtype bfloat16 --fused: {replies} {stats} launches {cli_l}")
    if not (replies[0]["fused"]["boxes"] and replies[0]["boxes_3d"]):
        raise AssertionError(f"serve --dtype bfloat16 --fused answered nothing: {replies[0]}")
    emit({"phase": "bf16_serve", "requests": len(reqs), "canvas": list(CANVAS), "head_dtypes": head_dtypes,
          "tf32": [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32],
          "lidar_vs_float32": lidar_cmp, "fused_3d_vs_float32": fused3d_cmp, "fused_rows_vs_float32": rows,
          "jax_audit_envelope": envelope, "launches": launches, "times": times,
          "float32_over_bfloat16": speedup, "serve_cli": {"seconds": cli_s, "stats": stats, "launches": cli_l,
                                                          "rows": len(replies[0]["fused"]["boxes"]),
                                                          "boxes_3d": len(replies[0]["boxes_3d"])},
          "card": card["nvidia_smi"]})
    bf16 = [launches["bfloat16_bucket8"], launches["bfloat16_bucket1"]]
    return {"lidar": sum(r["lidar_raster"] for r in bf16),
            "fused": {k: sum(r["fused"][k] for r in bf16) for k in cli_l}, "serve_cli": cli_l}


def imagenet_stand_in(path):
    """A torchvision-layout resnet18 .pth: the port's ResNet-18 backbone of a
    seeded init (PoseResNet and torchvision share the keys) plus fc.*; the
    check's own file, nothing downloaded. Returns its state_dict."""
    from sfa3d_tpu_torch.models.port import BACKBONE_PREFIXES

    model = create_model("resnet_18").init_weights(torch.Generator().manual_seed(SEED + 11))
    sd = {k: v.clone() for k, v in model.state_dict().items()
          if k.startswith(BACKBONE_PREFIXES) and not k.endswith("num_batches_tracked")}
    g = torch.Generator().manual_seed(SEED + 12)
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = 0.1 * torch.randn(sd[k].shape, generator=g)
        elif k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(sd[k].shape, generator=g)
    sd["fc.weight"], sd["fc.bias"] = torch.randn(1000, 512, generator=g), torch.zeros(1000)
    torch.save(sd, path)
    return sd


def phase_train_options(card, tmp_root, root):
    """The training options of slice 12 on the card: (a) one strict-fp32
    accumulated resnet_18 (deconv) step card vs CPU (S = 2 x B = 2, 128 x
    128, SGD) under the train phase's tolerances; (b) one epoch of the
    training CLI, --arch resnet_18 --imagenet_pretrained --imagenet_weights
    <a stand-in file> --profile_dir, one batch of 16 frames in the bfloat16
    default: the log names the ImageNet init, the conv weights lie within
    Adam's first step of the file's, one raster launch, the trace holds
    CUDA kernels, the key_averages table is written, Detector loads the
    checkpoint."""
    import os

    from sfa3d_tpu_torch.cli import train as train_cli

    init_sd = create_model("resnet_18").init_weights(torch.Generator().manual_seed(SEED)).state_dict()
    torch.backends.cudnn.deterministic = True
    try:
        parity = _train_step_parity("sgd", init_sd, arch="resnet_18")
    finally:
        torch.backends.cudnn.deterministic = False

    weights = os.path.join(tmp_root, "resnet18-standin.pth")
    file_sd = imagenet_stand_in(weights)
    run, prof = os.path.join(tmp_root, "options"), os.path.join(tmp_root, "options_profile")
    lr = 1e-3
    bev_raster_reduce.launches = 0
    t0 = time.perf_counter()
    train_cli.main(["--dataset_dir", root, "--root-dir", run, "--arch", "resnet_18", "--saved_fn", "deconv",
                    "--num_epochs", "1", "--checkpoint_freq", "1", "--no-val", "--num_samples", "16",
                    "--batch_size", "16", "--effective_batch", "16", "--lr", str(lr), "--seed", str(SEED),
                    "--imagenet_pretrained", "--imagenet_weights", weights, "--profile_dir", prof])
    cli_s = time.perf_counter() - t0
    cli_launches = bev_raster_reduce.launches
    if cli_launches != 1:
        raise AssertionError(f"the deconv CLI epoch launched the raster {cli_launches} times for 1 batch")
    log = open(os.path.join(run, "logs", "deconv", "logger_deconv.txt")).read()
    if "initialized backbone from ImageNet resnet18 weights" not in log:
        raise AssertionError("the training log does not name the ImageNet init")
    ckpt = os.path.join(run, "checkpoints", "deconv", "Model_deconv_epoch_1.pth")
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)["state_dict"]
    moved = {k: (sd[k] - file_sd[k]).abs().max().item()
             for k in ("conv1.weight", "layer2.0.downsample.0.weight", "layer4.1.conv2.weight")}
    if max(moved.values()) > 1.01 * lr:
        raise AssertionError(f"ImageNet weights moved beyond Adam's first step: {moved}")
    Detector(arch="resnet_18", checkpoint=ckpt, device=DEVICE)
    with open(os.path.join(prof, "trace_rank0.json")) as f:
        trace = json.load(f)
    trace_bytes = os.path.getsize(os.path.join(prof, "trace_rank0.json"))
    kernels = [e for e in trace.get("traceEvents", []) if e.get("cat") == "kernel"]
    table = open(os.path.join(prof, "key_averages_rank0.txt")).read()
    if not kernels or "Self CUDA" not in table:
        raise AssertionError(f"the profile holds {len(kernels)} CUDA kernel events; table header "
                             f"{table.splitlines()[:2]}")
    del trace

    emit({"phase": "train_options", "deconv_step_parity": {"bev": list(TRAIN_PARITY_BEV), "S": 2, "B": 2,
                                                          "sgd": parity},
          "cli": {"seconds": cli_s, "raster_launches": cli_launches, "imagenet_weights_moved": moved,
                  "trace_bytes": trace_bytes, "trace_kernel_events": len(kernels),
                  "key_averages_lines": len(table.splitlines())},
          "card": card["nvidia_smi"]})
    return cli_launches


CHECKS_TIMEOUT = 400  # s for one check's subprocess, its start, imports and builds included
CHECK_FRAMES = 4  # held-out frames of trained parity, fusion; the generalize run's val split
TRACK_CHECK_FRAMES = 6
CHECKS_ARGS = ()  # appended to every check's arguments (a CPU rehearsal adds --platform cpu)


def _start_check(name, args, log_dir, env=None):
    """Start scripts/<name>.py with `args` in its own session; its output
    goes to log_dir/<name><n>.log and a thread notes when it ends."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    out = open(os.path.join(log_dir, f"{name}{len(os.listdir(log_dir))}.log"), "w")
    proc = subprocess.Popen([sys.executable, os.path.join(here, "scripts", f"{name}.py"), *args, *CHECKS_ARGS],
                            cwd=here, env=env, stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
    proc.log, proc.started, proc.ended = out, time.perf_counter(), None

    def note_end():
        proc.wait()
        proc.ended = time.perf_counter()

    proc.watch = threading.Thread(target=note_end, daemon=True)
    proc.watch.start()
    return proc


def _finish_check(proc, report_path):
    """Wait for a check (killing its session at CHECKS_TIMEOUT); raise with
    the end of its output unless it exited 0. Returns (its report, its wall
    seconds)."""
    import os
    import signal

    proc.watch.join(timeout=max(1.0, CHECKS_TIMEOUT - (time.perf_counter() - proc.started)))
    if proc.watch.is_alive():
        os.killpg(proc.pid, signal.SIGKILL)
        proc.watch.join()
    seconds = proc.ended - proc.started
    proc.log.close()
    if proc.returncode != 0:
        with open(proc.log.name) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"{' '.join(proc.args[1:3])} ... exited {proc.returncode} after {seconds:.1f} s:\n{tail}")
    with open(report_path) as f:
        return json.load(f), seconds


def check_launches(reports, want):
    """Each check's process launched exactly the kernels `want` names, as
    often; the CPU tracking run launched none."""
    for key, counts in want.items():
        got = {k: v for k, v in reports[key]["launches"].items() if v}
        if got != counts:
            raise AssertionError(f"{key}: launches {got}, expected {counts}")
    if set(reports["tracking_cpu"]["launches"].values()) != {0}:
        raise AssertionError(f"the CPU tracking run launched kernels: {reports['tracking_cpu']['launches']}")


def phase_checks(card, tmp_root, kitti_root, yolo_weights):
    """The ports of the JAX check scripts, each run as a user runs it: a
    subprocess on the card at full width and tiny depth (see the module
    docstring). Tracking (card and CPU) and the Argoverse check run beside
    the generalize run; trained parity and fusion, which read its last
    checkpoint, run side by side after it.
    Each check's report carries the kernel launches of its own process
    (the trainer's processes are not counted). Returns {check: launches}."""
    import os

    torch.cuda.empty_cache()  # the earlier phases' cached blocks: the checks' processes share the card
    work = os.path.join(tmp_root, "checks")
    logs = os.path.join(work, "logs")
    os.makedirs(logs)
    start = os.path.join(work, "start.pth")
    model = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(SEED))
    bump_heatmap_bias(model)  # detections above the thresholds from the first epoch on
    bump_dim_bias(model)
    torch.save({"state_dict": model.state_dict()}, start)
    out = {k: os.path.join(work, f"{k}.json") for k in
           ("generalize", "trained_parity", "tracking", "tracking_cpu", "fusion", "argoverse")}
    cpu_env = dict(os.environ, OMP_NUM_THREADS="4")
    track = ["--pretrained_path", start, "--n_seqs", "1", "--n_frames", str(TRACK_CHECK_FRAMES), "--smoke"]
    gen_dir = os.path.join(work, "generalize")
    last = os.path.join(gen_dir, "checkpoints", "gen", "Model_gen_epoch_2.pth")
    t0 = time.perf_counter()
    first = {  # the generalize run, and beside it the checks that need none of its output
        "generalize": _start_check("torch_generalize_check", [
            "--frames_train", "16", "--frames_val", str(CHECK_FRAMES), "--epochs", "2", "--checkpoint_freq", "1",
            "--batch_size", "4", "--effective_batch", "8", "--kill_after_epoch", "1", "--kill_delay", "0",
            "--ema_decay", "0.998", "--ema_tau", "200", "--pretrained_path", start, "--smoke",
            "--work_dir", gen_dir, "--keep_tmp", "--out", out["generalize"]], logs),
        "tracking": _start_check("torch_tracking_check", track + ["--out", out["tracking"]], logs),
        "tracking_cpu": _start_check("torch_tracking_check", track + ["--platform", "cpu", "--out",
                                                                     out["tracking_cpu"]], logs, cpu_env),
        "argoverse": _start_check("torch_argoverse_check", [
            "--frames_train", "8", "--frames_val", "2", "--epochs", "1", "--checkpoint_freq", "1",
            "--batch_size", "4", "--smoke", "--out", out["argoverse"]], logs),
    }
    reports, seconds = {}, {}
    reports["generalize"], seconds["generalize"] = _finish_check(first.pop("generalize"), out["generalize"])
    then = {  # the generalize run's last checkpoint, its EMA weights
        "trained_parity": _start_check("torch_trained_parity_check", [
            "--dataset_dir", os.path.join(gen_dir, "kitti"), "--pretrained_path", last, "--use_ema",
            "--num_samples", str(CHECK_FRAMES), "--out", out["trained_parity"]], logs),
        "fusion": _start_check("torch_fusion_check", [
            "--dataset_dir", kitti_root, "--pretrained_path", last, "--use_ema", "--num_samples", str(CHECK_FRAMES),
            "--yolo_weights", yolo_weights, "--smoke", "--out", out["fusion"]], logs),
    }
    for key, proc in {**first, **then}.items():
        reports[key], seconds[key] = _finish_check(proc, out[key])
    total_s = time.perf_counter() - t0

    gen, parity, fusion = reports["generalize"], reports["trained_parity"], reports["fusion"]
    track_card, track_cpu, argo = reports["tracking"], reports["tracking_cpu"], reports["argoverse"]
    curve = [r["epoch"] for r in gen["val_map_curve"]]
    if gen["killed_after_epoch"] != 1 or gen["resume_history"] != [1] or curve != [1, 2]:
        raise AssertionError(f"generalize: killed {gen['killed_after_epoch']}, resumed {gen['resume_history']}, "
                             f"curve {curve}")
    if not parity["pass"] or parity["total_detections_compared"] == 0:
        raise AssertionError(f"trained parity failed: {parity}")
    ids_card = [s["track_ids"] for s in track_card["per_seq"]]
    ids_cpu = [s["track_ids"] for s in track_cpu["per_seq"]]
    if ids_card != ids_cpu or not any(any(f) for s in ids_card for f in s):
        raise AssertionError(f"tracking ids card vs CPU: {ids_card} against {ids_cpu}")
    frames = CHECK_FRAMES
    want = {
        "generalize": {"bev_raster_reduce": 2 * frames},  # cli.eval on the two checkpoints
        "trained_parity": {"bev_raster_reduce": frames},
        "tracking": {"bev_raster_reduce": TRACK_CHECK_FRAMES, "track_associate": TRACK_CHECK_FRAMES},
        # one match a rule and draw: 2 rules x 4 draws, the control, 2 trained-camera rows
        "fusion": {"bev_raster_reduce": frames, "greedy_match": 11 * frames, "hard_nms_keep": frames},
        "argoverse": {"argoverse_raster_reduce": 2},
    }
    check_launches(reports, want)
    for key in reports:
        emit({"phase": "checks", "check": key, "seconds": seconds[key], "launches": reports[key]["launches"],
              "device": reports[key]["device"]})
    emit({"phase": "checks", "seconds": total_s,
          "generalize": {"killed_after_epoch": gen["killed_after_epoch"], "resume_history": gen["resume_history"],
                         "val_mAP": [r["val_mAP"] for r in gen["val_map_curve"]],
                         "train_seconds": gen["train_seconds"], "eval_seconds": gen["eval_seconds"]},
          "trained_parity": {**{k: parity[k] for k in ("frames", "total_detections_compared", "worst_abs_diff",
                                                       "raster_card_vs_cpu")},
                             "heatmap_worst_gap": parity["heatmap_card_vs_cpu"]["heatmap_worst_gap"]},
          "tracking": {"summary_card": track_card["summary"]["overall"],
                       "summary_cpu": track_cpu["summary"]["overall"], "ids_equal": True},
          "fusion": {k: fusion[k]["mAP"] for k in ("lidar_only", "reference_max_rule", "monotone_demote_rule",
                                                   "trained_camera_demote_rule")},
          "argoverse": {"val_bev_mAP": [r["val_bev_mAP"] for r in argo["val_curve"]]},
          "card": card["nvidia_smi"]})
    return {key: reports[key]["launches"] for key in want}


def main() -> int:
    t_start = time.perf_counter()
    card = phase_device()
    phase_build(card)
    counts_rec, raster_rec = phase_kernel(card)
    argo_rec = phase_argoverse_kernel(card)
    loop_recs = phase_fusion_kernels(card)
    pts, valid = phase_raster(card)
    phase_model(card, pts, valid)
    phase_yolo(card)
    track_rec = phase_track_kernels(card)
    scans, lidar_raster_launches, served_count_launches = phase_serve(card)
    track_launches = phase_track(card)
    counts_rec["launches"] = phase_counts(card, scans)
    counts_rec["path"] = "count map of the 16 served scans: cell_indices_and_keys -> bev_cell_counts"
    fused = phase_fused_serve(card)
    phase_yolo_train_parity(card)
    with tempfile.TemporaryDirectory() as tmp_root:
        train_launches, train_batches, train_err, root = phase_train(card, tmp_root)
        dp_launches = phase_dp_train(card, tmp_root, root)
        dpsp_launches = phase_dp_sp(card, tmp_root)
        phase_native(card, tmp_root, root)
        val, yolo_cli_launches, best_path = phase_yolo_train(card, root, f"{tmp_root}/yolo")
        nms_eval_shape, yolo_eval_launches = phase_yolo_eval(card, val, best_path)
        kitti_launches = phase_kitti_eval(card, root, tmp_root)
        serve_cli_raster_launches, serve_cli_assoc_launches = phase_serve_cli(card, tmp_root)
        argo_launches = phase_argoverse(card, tmp_root)
        export_launches = phase_export(card, tmp_root)
        viz_launches = phase_viz_cli(card, tmp_root)
        drive_launches = phase_drive_cli(card, tmp_root)
        slam_launches = phase_slam(card, tmp_root)
        bf16_launches = phase_bf16_serve(card, tmp_root)
        options_launches = phase_train_options(card, tmp_root, root)
        phase_checks(card, tmp_root, root, best_path)
    fused_path = "BatchingFusedServer: 16 requests, warmups included"
    raster_rec["launches"] = fused["bev_raster_reduce"]
    raster_rec["path"] = fused_path
    for rec in loop_recs:
        rec["launches"] = fused[rec["name"]]
        rec["path"] = fused_path
    counts_rec["launches_by_path"] = {"lidar_serve": served_count_launches,
                                      "fused_serve": fused["bev_cell_counts"]}
    raster_rec["launches_by_path"] = {"lidar_serve": lidar_raster_launches,
                                      "fused_serve": fused["bev_raster_reduce"], "train": train_launches,
                                      "kitti_eval": kitti_launches, "serve_cli": serve_cli_raster_launches}
    for rank, launches in enumerate(dp_launches):  # per rank: one a collated batch, DP_STEPS batches
        raster_rec["launches_by_path"][f"dp_train_rank{rank}"] = launches
    raster_rec["launches_by_path"]["export_detector"] = export_launches["detector"]
    raster_rec["launches_by_path"]["export_fused"] = export_launches["fused"]["bev_raster_reduce"]
    raster_rec["launches_by_path"]["serve_cli_artifact"] = export_launches["serve_cli"]
    for path, launches in viz_launches.items():
        raster_rec["launches_by_path"][f"viz_cli_{path}"] = launches["bev_raster_reduce"]
    for path, launches in drive_launches.items():
        raster_rec["launches_by_path"][path] = launches["bev_raster_reduce"]
    for path, launches in slam_launches.items():
        raster_rec["launches_by_path"][path] = launches["bev_raster_reduce"]
    raster_rec["launches_by_path"]["bf16_serve_lidar"] = bf16_launches["lidar"]
    raster_rec["launches_by_path"]["bf16_serve_fused"] = bf16_launches["fused"]["bev_raster_reduce"]
    raster_rec["launches_by_path"]["bf16_serve_cli"] = bf16_launches["serve_cli"]["bev_raster_reduce"]
    raster_rec["launches_by_path"]["train_options_cli"] = options_launches
    raster_rec["launches_per_kitti_eval_frame"] = kitti_launches / KITTI_EVAL_FRAMES
    nms_rec = next(rec for rec in loop_recs if rec["name"] == "hard_nms_keep")
    nms_rec["launches_by_path"] = {"fused_serve": fused["hard_nms_keep"], "yolo_eval": yolo_eval_launches,
                                   "yolo_train_cli": yolo_cli_launches}
    nms_rec["at_yolo_eval_shape"] = nms_eval_shape
    for rec in loop_recs:
        rec.setdefault("launches_by_path", {"fused_serve": fused[rec["name"]]})
        rec["launches_by_path"]["export_fused"] = export_launches["fused"][rec["name"]]
        for path, launches in viz_launches.items():
            if path != "test":
                rec["launches_by_path"][f"viz_cli_{path}"] = launches[rec["name"]]
        for path, launches in slam_launches.items():
            rec["launches_by_path"][path] = launches[rec["name"]]
        rec["launches_by_path"]["bf16_serve_fused"] = bf16_launches["fused"][rec["name"]]
        rec["launches_by_path"]["bf16_serve_cli"] = bf16_launches["serve_cli"][rec["name"]]
    for rank, (train, fused_launches) in enumerate(zip(dpsp_launches["train"], dpsp_launches["fused"])):
        raster_rec["launches_by_path"][f"dp_sp_train_rank{rank}"] = train
        for rec in (raster_rec, *loop_recs):
            rec["launches_by_path"][f"dp_sp_fused_rank{rank}"] = fused_launches[rec["name"]]
    raster_rec["launches_per_train_step"] = train_launches / train_batches
    raster_rec["max_abs_err"] = max(raster_rec["max_abs_err"], train_err)  # the training path's batches too
    track_rec["launches"] = serve_cli_assoc_launches
    track_rec["path"] = "serve --track over stdio: 2 streams x 8 frames, one launch per tracked frame"
    track_rec["launches_by_path"] = {"serve_cli": serve_cli_assoc_launches, "track": track_launches,
                                     "serve_cli_artifact_track": export_launches["serve_cli_track_associate"],
                                     "track_cli": drive_launches["track"]["track_associate"]}
    argo_rec["launches"] = argo_launches["argoverse_test"]
    argo_rec["path"] = "argoverse_test CLI: 16 sweeps, one launch a sweep"
    argo_rec["launches_by_path"] = argo_launches
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(card["nvidia_smi"], flush=True)
    emit({"kernels": [counts_rec, raster_rec, *loop_recs, track_rec, argo_rec]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
