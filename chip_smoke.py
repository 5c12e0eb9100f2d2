#!/usr/bin/env python3
"""Drive the PyTorch port (``udp_pose_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--peak-before OLD/peak_offset.cu]

Builds the port's CUDA sources ``udp_pose_tpu_torch/csrc/peak_offset.cu``,
``csrc/int8_conv.cu`` and ``csrc/int8_dwconv.cu`` (one nvcc each, started
together) and holds
both kernels of the first bit for bit against their plain PyTorch
versions on the card: the peak-only mode on six map families (phase 3;
with ``--peak-before``, also an earlier revision of the source, timed in
turns with this one).  Runs full-width HRNet-w32 256×192 UDP-offset
(seeded random weights) against the port on the CPU, holds the fused
decode of its card heatmaps against the plain version and the old
matrix-product route, and times the flip-test serving graph and its
decode before and after (phase 5, before any profiler session: see
:func:`phase_model`).  Holds the fused UDP offset decode on the map
families, as the heatmap channels of B=128 net outputs in NCHW and
channels-last layouts, against its plain version (phase 3b), profiles
the bf16 batches (phase 5d), checks the fp32 blurs (phase 4), then
serves ``/v1/pose`` requests over HTTP through the fused kernel (phase
6), and trains w32 (bf16, B=32) on a seeded synthetic mini-COCO for two
epochs through ``train.run`` with the yaml's WORKERS 4 (worker processes
and the pinned prefetch), validating through the fused kernel, then
evaluates and serves the weights it wrote, and trains again with the
in-process loader for comparison (phase 7).  Phase 8 runs
detect-then-pose at full width (YOLOv5n at 640, w32 bf16 with the flip
test, 16 persons, 720p frames): the detector card vs CPU, the device NMS
against the host NMS, the fused engine's boxes against the host path on
a stubbed head, one decode launch a frame or a chunk, frames/s and a
stage breakdown, ``/v1/detect_pose`` over HTTP and the infer CLI.
Phase 9, int8 (right after phase 8): at every int8 conv shape of w32
(B=256) and YOLOv5n, the fused int8 conv kernel, which every int8 path
runs, bit for bit against the three-step card path (``quant_im2col``,
``_int_mm``, ``dequant_epilogue``) and its plain version, the two
three-step kernels against theirs and ``_int_mm`` against exact
products, each timed beside its bound, with ``_int_mm`` and the bf16
cuDNN conv (9a); the pipeline
calibrating itself, then int8 and bf16 crops/s in both flip modes, card
vs CPU (9b); ``/v1/pose`` of an int8 server (9c); int8 detect-then-pose
frames/s (9d); QAT train steps (9e); the test CLI with ``TPU.QUANTIZE
int8`` (9f).  Phase 10, the model zoo at full width (right after
phase 9): ``pose_resnet50`` (10a) and the PSA HRNet (10b) served in
bf16 at B=128, each held fp32 card vs CPU (their batches profiled
after 3b); int8 ``pose_resnet50`` (10c:
self-calibration, crops/s against bf16, the fused int8 conv at every
layout the path ran against the three-step card path and timed over one
forward's shapes); MPII HRNet-w32 256x256 (10d: one epoch of
``train.run`` on a seeded synthetic MPII in memory with WORKERS 4,
PCKh, a ``/v1/pose`` request with 16 joints, and the fused decode at
(128, 48, 64, 64) against its plain version and its bound).  Phase 11,
RSN at full width (right after phase 10): ``rsn18_256x192`` served in
bf16 at B=128 with the flip folded, fp32 card vs CPU heatmaps and
keypoints (11a); ``4xrsn50_384x288`` through ``test.run`` on a
synthetic mini-COCO val (11b); ``4xrsn18_256x192`` trained in iteration
mode through ``train.run`` with WORKERS 4 (MAX_ITER, CHECKPOINT_PERIOD
and WARMUP_ITERS cut; first its float64 forward and loss card vs CPU
and one float64 step of its first two stages card vs CPU), its
checkpoints and LR checked (11c); int8 ``rsn18`` through ``test.run``
with ``TPU.QUANTIZE int8``, the fused int8 conv at every input layout
that path ran (channel slices of the residual steps included) against
the three-step card path, timed over one fold forward's shapes (11d).
No RSN path launches the fused decode.  Phase 12, the mobile zoo at
full width (right after phase 11): the five mobile yamls
(MobileNetV3-Small, MobileViT-s, MobileViTv2-0.5, ShuffleNetV2 1.0x,
ShuffleNetV2+ Small) fp32 card vs CPU and served in bf16 at B=128 with
the flip folded, and ``shufflenetv2_test``'s offset head through the
fused decode (12a); each in int8 through the self-calibrating pipeline,
the int8 depthwise kernel (``csrc/int8_dwconv.cu``'s launch) and
the fused int8 conv at every input layout they ran against their plain
version and the three-step card path, the depthwise kernel timed at
each depthwise shape and layout of a fold forward in turns with the
previous design, beside its bound and cuDNN's bf16
depthwise conv, and RSN with ``USE_PRM`` through its 9×9 depthwise site
(12b);
``mobilevitv2_05`` trained one epoch through ``train.run`` with WORKERS
4, evaluated in int8 through ``test.run`` and served over ``/v1/pose``,
and QAT steps of ``mobilenetv3_small`` (12c).  Phase 13, checkpoints and
weight I/O (right after phase 7, w32 bf16 B=32 on a seeded synthetic
mini-COCO of 128 training and 40 validation crops): ``train.run`` with
WORKERS 2 and deterministic cuDNN uninterrupted twice, then stopped by
``SIGTERM`` in the middle of epoch 1 and resumed with ``AUTO_RESUME``,
the batches and the weights held against the uninterrupted runs, and a
checkpoint's save and load timed and held bit for bit (13a); the
rolling backend of ``TPU.CKPT_BACKEND orbax`` over three saves (13b);
``rsn18`` in iteration mode stopped and resumed from ``iter-last.pth``
(13c); an ``rsn18`` step with and without ``TPU.REMAT`` (13d);
``MODEL.PRETRAINED`` grafting a backbone-only file (13e); the same
weights as ``.msgpack`` and ``.pth`` served bit for bit (13f); the
``DEBUG.DEBUG`` images of one epoch (13g).  Phase 14, the serving surface
and export (right after phase 12): w32 ``UdpPosePipeline.infer_pose``
with the crops warped on the card, fp32 card vs CPU on 8 persons of a
720p frame, then bf16 at 1, 8 and 64 persons timed beside the host-crop
path (14a); ``/v1/pose`` with ``--pad-on-device`` against the same
requests without it, and the crop bytes each batch uploaded (14b);
``rsn18`` through the pipeline in bf16 and self-calibrated int8 against
``make_rsn_infer_fn`` on the same crops, crops/s (14c); the export CLI
for w32 and ``--yolo yolov5n`` on the card, a w32 export held by
``check_model`` and timed beside the model's forward, served as
``.onnx`` weights bit for bit as its ``.pth``, the standalone engine
over it, and an ``rsn18`` export served by ``python -m
udp_pose_tpu_torch.serve --pad-on-device`` in a process of its own and
run by the infer CLI (14d).  Phase 15, data parallelism on NCCL (right
after phase 13): w32 fp32 B=32 trained through ``train.run`` for 4 steps
and a validation without a process group, then this process joins a
world-1 NCCL group on ``cuda:0``; the global-batch BatchNorm against
``layers.BatchNorm2d`` at every BN input shape of a w32 step, fp32 and
bf16, and one DDP step's all-reduces counted (15a); the same run inside
the group against the first, weights, samples/s and the fused decode of
a validation batch (15b); ``test.run`` in the group, and
``UdpPosePipeline(mesh=)`` over the cards (a power of two of them),
each card's rows bit-equal to no mesh on those rows, on a
64-person 720p frame; on two or more cards, 2 spawned NCCL ranks at
B=32 against one process at B=64, held within limits that a control
run with each rank's BatchNorm over its own rows must exceed, and
``test.run`` on 2 ranks against one (15c; on one card a line says what
did not run).  Phase 16, the single-card remainder (last): the
AID yaml's on-device augmentation (hide-and-seek on, B=32, 640x640
canvases) on the card against its CPU run from one set of draws, its ms
and the canvas upload (16a); ``train.run`` of the AID yaml with
``DATASET.DEVICE_AUG True`` for 2 epochs with their validations, beside
the same run with the host augmentation (16b); a device-aug run stopped
mid-epoch and resumed bit for bit (16c); a w32 step with every train
BatchNorm through ``FusedBatchNorm`` against plain BN, float64 held,
fp32 and bf16 reported, and the bf16 step times (16d);
``FusedDetectPose`` over ``rsn18`` (PRM on) in bf16 and int8 against
``infer_pose`` on its boxes, frames/s (16e); ``simdr_decode`` and
``shift_decode`` card vs CPU (16f).  The kernels' launches
count phases 6, 7 and 8, each path in one window, and the two int8
paths (9b-9c, 9d) in windows around each of their own calls: the bf16
engines timed in turns with them and the card-vs-CPU checks run
outside; phases 10, 11, 12, 13, 14, 15 and 16's paths likewise.  Any failed check
exits nonzero before the last line, which is ``{"ok": true, "device":
{...}}``.  Without a CUDA card it exits 1.  Imports nothing of JAX or of
the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import http.client
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# configs/coco/hrnet_w32_256x192_udp_offset.yaml, as a dict: the card's
# machine may have no PyYAML (a CPU test holds this equal to the yaml)
W32_UDP_OFFSET = {
    "OUTPUT_DIR": "output",
    "LOG_DIR": "log",
    "PRINT_FREQ": 100,
    "DATASET": {
        "DATASET": "coco", "ROOT": "data/coco", "TRAIN_SET": "train2017",
        "TEST_SET": "val2017", "COLOR_RGB": True, "FLIP": True,
        "ROT_FACTOR": 45, "SCALE_FACTOR": 0.35, "NUM_JOINTS_HALF_BODY": 8,
        "PROB_HALF_BODY": 0.3,
    },
    "MODEL": {
        "NAME": "pose_hrnet", "TARGET_TYPE": "offset",
        "IMAGE_SIZE": [192, 256], "HEATMAP_SIZE": [48, 64], "SIGMA": 2,
        "NUM_JOINTS": 17,
        "EXTRA": {
            "FINAL_CONV_KERNEL": 1,
            "PRETRAINED_LAYERS": ["*"],
            "STAGE2": {"NUM_MODULES": 1, "NUM_BRANCHES": 2, "BLOCK": "BASIC",
                       "NUM_BLOCKS": [4, 4], "NUM_CHANNELS": [32, 64],
                       "FUSE_METHOD": "SUM"},
            "STAGE3": {"NUM_MODULES": 4, "NUM_BRANCHES": 3, "BLOCK": "BASIC",
                       "NUM_BLOCKS": [4, 4, 4], "NUM_CHANNELS": [32, 64, 128],
                       "FUSE_METHOD": "SUM"},
            "STAGE4": {"NUM_MODULES": 3, "NUM_BRANCHES": 4, "BLOCK": "BASIC",
                       "NUM_BLOCKS": [4, 4, 4, 4],
                       "NUM_CHANNELS": [32, 64, 128, 256],
                       "FUSE_METHOD": "SUM"},
        },
    },
    "LOSS": {"USE_TARGET_WEIGHT": True, "KPD": 4.0},
    "TRAIN": {
        "BATCH_SIZE_PER_GPU": 32, "END_EPOCH": 210, "OPTIMIZER": "adam",
        "LR": 0.001, "LR_FACTOR": 0.1, "LR_STEP": [170, 200],
    },
    "TEST": {
        "BATCH_SIZE_PER_GPU": 32, "USE_GT_BBOX": True, "FLIP_TEST": True,
        "POST_PROCESS": True, "IN_VIS_THRE": 0.2, "OKS_THRE": 0.9,
        "NMS_THRE": 1.0, "IMAGE_THRE": 0.0,
    },
}

SERVE_BATCH = 128                # crops per flip-test batch (bench.py:104)
N_MAPS = SERVE_BATCH * 17        # peak-kernel rows at that batch
MAP_HW = (64, 48)
# H100 SXM data sheet: device memory rate (bytes/s); its 67 TFLOP/s fp32
# rate outside the tensor cores counts an FMA as two operations, so the
# kernels' separate multiplies, adds and compares run at half of it
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
INT8_OPS_PER_S = 1979e12         # dense int8 tensor-core rate
KPD = 4.0                        # LOSS.KPD of the config
LAYOUTS = ("nchw", "channels_last")
HEATMAP_REL_TOL = 1e-4           # fp32 card vs CPU, TF32 off (phase 5a)
BLUR_ATOL = 1e-5                 # fp32 blur vs float64 (phase 4)


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def log(msg):
    print(msg, flush=True)


def card_line():
    """``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, arg_sets, iters=50, repeats=5, warm_s=0.3):
    """ms per call on the card (CUDA events): the median of ``repeats``
    runs of ``iters`` calls, after ``warm_s`` seconds of calls that bring
    the clocks up; cycles over ``arg_sets`` so that the inputs do not all
    sit in the 50 MB L2."""
    i = 0
    t_end = time.perf_counter() + warm_s
    while time.perf_counter() < t_end:
        fn(*arg_sets[i % len(arg_sets)])
        i += 1
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return float(np.median(runs))


def graph_ms(fn, arg_sets, iters=30, repeats=5, warm_s=0.3):
    """ms per call of device time: ``iters`` calls (cycling over
    ``arg_sets``) captured in one CUDA graph, whose replays are timed
    with CUDA events after ``warm_s`` seconds of replays; the median of
    ``repeats``.  Unlike :func:`cuda_ms` it leaves out the host's cost of
    each launch, which sets the pace of back-to-back eager calls whenever
    it exceeds the kernel's own time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # caches and libraries, uncaptured
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    t_end = time.perf_counter() + warm_s
    while time.perf_counter() < t_end:
        graph.replay()
        torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return float(np.median(runs))


def turns(fns, order, iters=5, repeats=3):
    """ms per call of each of ``fns`` (name → function of no arguments):
    one CUDA graph of ``iters`` calls each, replayed in the turns
    ``order`` gives (e.g. old, new, new, old), after one replay to warm,
    the median of ``repeats`` replays a turn; each name's mean over its
    turns.  Two designs compared on one card in one run, without a
    capture a turn (a capture allocates the calls' outputs anew)."""
    graphs = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graphs[name] = graph
    got = {name: [] for name in fns}
    for name in order:
        graphs[name].replay()
        runs = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[name].replay()
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / iters)
        got[name].append(float(np.median(runs)))
    return {name: float(np.mean(v)) for name, v in got.items()}


def host_ms(fn, iters=10):
    """ms per call on the host clock, each call ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def enqueue_us(fn, n=2000):
    """µs of host time per call of ``fn`` enqueued back to back (no
    synchronize inside the loop): what one launch costs the host where
    the host paces the card."""
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def profile_device(fn, n=3):
    """torch.profiler over ``n`` calls: (wall ms, device-busy ms, the
    top device kernels by time, device kernels and copies a call).  Busy
    time is the sum of the kernels' and copies' durations on the card
    (one stream here)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = [(e.key, e.self_device_time_total / 1e3) for e in events]
    busy = sum(t for _, t in dev)
    return (wall, busy, sorted(dev, key=lambda kv: -kv[1])[:8],
            sum(e.count for e in events) / n)


def set_tf32(enabled):
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled


# ---------------------------------------------------------------- phase 2
def phase_build():
    """The CUDA sources, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from udp_pose_tpu_torch.ops import _build
    names = ("peak_offset", "int8_conv", "int8_conv_sm90", "int8_dwconv")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(_build.build, names)))
    for name in names:
        _build.load(name)
    secs = time.perf_counter() - t0
    for name, lib in libs.items():
        log(f"[build] {name}.cu -> {lib}"
            + (f" in {_build.build_logs[name][0]:.2f} s; nvcc: "
               + _build.build_logs[name][1].strip()
               if name in _build.build_logs else " (built before)"))
    log(f"[build] all {len(names)} sources in {secs:.2f} s")
    return secs


# ---------------------------------------------------------------- phase 3
def map_families(n, hw, device, seed=0):
    """(n, H, W) heatmaps cut into six families, and two offset maps."""
    H, W = hw
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=device)

    k = n // 6
    hm = torch.empty(n, H, W, device=device)
    ys = torch.arange(H, device=device).view(1, H, 1).float()
    xs = torch.arange(W, device=device).view(1, 1, W).float()
    cy = rand(k, 1, 1) * (H - 8) + 4
    cx = rand(k, 1, 1) * (W - 8) + 4
    hm[:k] = rand(k, H, W) * 0.1 + torch.exp(
        -((xs - cx) ** 2 + (ys - cy) ** 2) / 8.0)                  # peaky
    hm[k:2 * k] = torch.randn(k, H, W, generator=g, device=device)  # noise
    hm[2 * k:3 * k] = -rand(k, H, W) - 1e-3                  # all negative
    hm[3 * k:4 * k] = (rand(k, 1, 1) - 0.5).expand(k, H, W)       # constant
    ties = rand(n - 4 * k, H, W) * 0.5                    # planted ties
    flat = ties.view(ties.shape[0], -1)
    for _ in range(3):
        pos = (rand(flat.shape[0]) * H * W).long()
        flat.scatter_(1, pos[:, None], 0.75)
    hm[4 * k:] = ties
    hm[5 * k:5 * k + 8].view(8, -1)[:, 100] = float("nan")       # NaN rows
    ox = torch.randn(n, H, W, generator=g, device=device)
    oy = torch.randn(n, H, W, generator=g, device=device)
    return hm.contiguous(), ox, oy


def same_bits(a, b):
    """Equal element for element, NaN equal to NaN."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def raw_peak_launcher(lib):
    """A thin wrapper of a built library's ``peak_offset_launch``, with no
    checks and no launch count, so that every build it times pays the
    same Python cost a call."""
    fn = lib.peak_offset_launch
    fn.argtypes = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 \
        + (ctypes.c_void_p,)
    fn.restype = ctypes.c_int

    def launch(hm, ox, oy):
        N, H, W = hm.shape
        out = torch.empty((N, 5), device=hm.device)
        status = fn(hm.data_ptr(), ox.data_ptr(), oy.data_ptr(),
                    out.data_ptr(), N, H * W, W,
                    torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"peak_offset_launch: cudaError_t {status}")
        return out

    return launch


def compare_peak_builds(before_src, sets):
    """This source's peak-only kernel against that of an earlier revision
    (``before_src``) on the same maps: each bit-equal to the plain
    version, then both timed through :func:`raw_peak_launcher` by graph
    replay and by back-to-back eager calls, in turns (this, before,
    before, this)."""
    from udp_pose_tpu_torch.ops import _build
    from udp_pose_tpu_torch.ops.peak_offset import fused_peak_offset_reference
    builds = {"this": raw_peak_launcher(_build.load("peak_offset")),
              "before": raw_peak_launcher(ctypes.CDLL(str(_build.build(
                  "peak_offset_before", before_src))))}
    for name, fn in builds.items():
        for hm, ox, oy in sets:
            check(same_bits(fn(hm, ox, oy),
                            fused_peak_offset_reference(hm, ox, oy)),
                  f"peak-only kernel, {name} build, != plain version")
    times = {name: {"graph": [], "eager": []} for name in builds}
    for name in ("this", "before", "before", "this"):
        times[name]["graph"].append(graph_ms(builds[name], sets) * 1e3)
        times[name]["eager"].append(cuda_ms(builds[name], sets) * 1e3)
    for name, t in times.items():
        log(f"[kernel] peak-only, {name} build"
            f"{'' if name == 'this' else f' ({before_src})'}: bit-equal to "
            f"the plain version; graph replay "
            f"{', '.join(f'{v:.2f}' for v in t['graph'])} us, back to back "
            f"from Python {', '.join(f'{v:.2f}' for v in t['eager'])} us "
            f"(turns this, before, before, this)")


def phase_kernel(device="cuda", peak_before=None):
    from udp_pose_tpu_torch.ops.peak_offset import (
        fused_peak_offset, fused_peak_offset_reference)
    sets = [map_families(N_MAPS, MAP_HW, device, seed) for seed in (0, 1, 2)]
    worst = 0.0
    for hm, ox, oy in sets:
        got = fused_peak_offset(hm, ox, oy)
        want = fused_peak_offset_reference(hm, ox, oy)
        torch.cuda.synchronize()
        check(same_bits(got, want),
              "peak_offset kernel != plain version on the map families")
        worst = max(worst, float((got - want).nan_to_num(0.0).abs().max()))
    ms = graph_ms(fused_peak_offset, sets)
    eager_ms = cuda_ms(fused_peak_offset, sets)
    plain_ms = cuda_ms(fused_peak_offset_reference, sets, iters=20)
    H, W = MAP_HW
    # bytes the function must move: each heatmap read once, the two
    # offsets read at the peak, the (N, 5) result written once
    bytes_moved = N_MAPS * (H * W + 2 + 5) * 4
    ops = N_MAPS * H * W            # one compare per heatmap element
    bound_ms, bound_by = bound_of(bytes_moved, ops)
    log(f"[kernel] fused_peak_offset N={N_MAPS} {H}x{W}: bit-equal to the "
        f"plain version on peaky/noise/negative/constant/tie/NaN maps; "
        f"kernel {ms * 1e3:.2f} us (graph replay; {eager_ms * 1e3:.2f} us "
        f"a call back to back from Python), plain {plain_ms * 1e3:.2f} us, "
        f"bound {bound_ms * 1e3:.2f} us ({bound_by})")
    if peak_before:
        compare_peak_builds(peak_before, sets)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


# --------------------------------------------------------------- phase 3b
def decode_inputs(seed, device="cuda", batch=SERVE_BATCH, hw=MAP_HW, J=17):
    """(batch, 3J, H, W) net outputs whose heatmap channels are the six
    map families and whose offset channels are noise, per layout."""
    hm, ox, oy = map_families(batch * J, hw, device, seed)
    net = torch.empty(batch, 3 * J, *hw, device=device)
    for c, maps in enumerate((hm, ox, oy)):
        net[:, c::3] = maps.view(batch, J, *hw)
    return {"nchw": net,
            "channels_last": net.contiguous(
                memory_format=torch.channels_last)}


def fused_bound(layout, batch=SERVE_BATCH, J=17, hw=MAP_HW):
    """(bytes, operations) the fused decode must move and do.  With
    channels-last input a pixel's 3J interleaved floats span all of their
    32-byte sectors, so the whole tensor is read; NCHW input reads the
    heatmap channels and 2 × 49 offsets a map.  Operations: two folded
    15-tap passes (1 + 7 × 3 each) and a compare per pixel; per map the
    two 7×7 point blurs, 7 rows of (7 kpd products + 1 + 3 × 3) and a
    column of 1 + 3 × 3."""
    H, W = hw
    maps = batch * J
    if layout == "channels_last":
        read = maps * 3 * H * W * 4
    else:
        read = maps * (H * W + 2 * 49) * 4
    ops = maps * (H * W * (2 * 22 + 1) + 2 * (7 * 17 + 10))
    return read + maps * 5 * 4, ops


def bound_of(bytes_moved, ops, ops_per_s=FP32_OPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_kernels(fn):
    """Names of the device kernels one call of ``fn`` ran (profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def matmul_route(net, kpd=KPD):
    """The decode route before the fused kernel: matrix-product blurs,
    then the peak-only kernel; (B, J, 5)."""
    from udp_pose_tpu_torch.ops.peak_offset import (blurred_offset_maps,
                                                    fused_peak_offset)
    return fused_peak_offset(*blurred_offset_maps(net, kpd)).reshape(
        net.shape[0], -1, 5)


def phase_fused(device="cuda"):
    """The fused decode kernel against its plain version, per layout."""
    from udp_pose_tpu_torch.ops import peak_offset as po
    from udp_pose_tpu_torch.ops.decode import udp_offset_decode
    sets = [decode_inputs(seed, device) for seed in (0, 1, 2)]
    worst = {layout: 0.0 for layout in LAYOUTS}
    for s in sets:
        per_layout = []
        for layout in LAYOUTS:
            got = po.udp_offset_decode_fused(s[layout], KPD)
            want = po.udp_offset_decode_reference(s[layout], KPD)
            torch.cuda.synchronize()
            check(same_bits(got, want), f"fused decode != plain version "
                  f"on the map families, {layout}")
            worst[layout] = max(worst[layout], float(
                (got - want).nan_to_num(0.0).abs().max()))
            per_layout.append(got)
        check(same_bits(*per_layout), "fused decode: NCHW != channels-last")
    # the run-time-shape copy of the kernel: 96x72 (384x288 crops, more
    # than 48 KB of shared memory a block) and an odd size
    for batch, hw in ((8, (96, 72)), (6, (20, 13))):
        s = decode_inputs(7, device, batch=batch, hw=hw)
        for layout in LAYOUTS:
            check(same_bits(po.udp_offset_decode_fused(s[layout], KPD),
                            po.udp_offset_decode_reference(s[layout], KPD)),
                  f"fused decode != plain version at {hw}, {layout}")
    log("[fused] bit-equal to the plain version also at 96x72 (B=8) and "
        "20x13 (B=6), both layouts")

    # one decode is one launch of the fused kernel, and no other kernel
    # of the port and no matrix product
    net = sets[0]["channels_last"]
    fused0, peak0 = po.udp_offset_decode_fused.launches, \
        po.fused_peak_offset.launches
    names = device_kernels(lambda: udp_offset_decode(net, KPD))
    check(po.udp_offset_decode_fused.launches == fused0 + 1
          and po.fused_peak_offset.launches == peak0,
          "udp_offset_decode did not make exactly one fused launch")
    if names:
        ours = [n for n in names if "udp_decode_kernel" in n]
        check(len(ours) == 1, f"udp_decode_kernel ran {len(ours)} times "
              f"in one decode: {names}")
        check(not any("gemm" in n.lower() or "peak_offset_kernel" in n
                      for n in names), f"matmul or peak-only kernel in "
              f"the fused decode: {names}")
        log(f"[fused] one udp_offset_decode call ran {len(names)} device "
            f"kernel(s): {'; '.join(n[:50] for n in names)}")
    else:
        log("[fused] the profiler saw no device kernels: the one-launch "
            "check rests on the launch counters alone")

    B, C, H, W = net.shape
    results = {}
    for layout in LAYOUTS:
        args = [(s[layout], KPD) for s in sets]
        ms = graph_ms(po.udp_offset_decode_fused, args)
        eager_ms = cuda_ms(po.udp_offset_decode_fused, args)
        plain_ms = cuda_ms(po.udp_offset_decode_reference, args, iters=5,
                           repeats=3)
        matmul_ms = graph_ms(matmul_route, args, iters=10)
        bytes_moved, ops = fused_bound(layout)
        bound_ms, bound_by = bound_of(bytes_moved, ops)
        # the values the function needs, whatever the layout makes it read
        hm_bound_ms = bound_of(*fused_bound("nchw"))[0]
        log(f"[fused] udp_offset_decode_fused B={B} C={C} {H}x{W} {layout}: "
            f"bit-equal to the plain version on peaky/noise/negative/"
            f"constant/tie/NaN heatmaps; kernel {ms * 1e3:.2f} us (graph "
            f"replay; {eager_ms * 1e3:.2f} us a call back to back from "
            f"Python), plain "
            f"{plain_ms * 1e3:.2f} us, matmul route (blurs + peak-only "
            f"kernel) {matmul_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} "
            f"us ({bound_by}: {bytes_moved / 1e6:.1f} MB, "
            f"{ops / 1e6:.1f} M fp32 operations); on the heatmap and "
            f"offset values alone {hm_bound_ms * 1e3:.2f} us, "
            f"{hm_bound_ms / ms:.0%} of it")
        results[layout] = {"max_abs_err": worst[layout], "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "matmul_route_ms": matmul_ms}
    return results


# ---------------------------------------------------------------- phase 4
def phase_blur(device="cuda", shape=(SERVE_BATCH, 51) + MAP_HW):
    """Both fp32 blurs, the matrix product and the ordered tap sum of the
    fused kernel's plain version, against float64."""
    from udp_pose_tpu_torch.ops.blur import (blur_matrix_f64, gaussian_blur,
                                             separable_blur_reference)
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(4))
    xd = x.to(device)
    x64 = x.numpy().astype(np.float64)
    H, W = shape[-2:]
    for ksize in (15, 7):
        want = blur_matrix_f64(H, ksize, 0.0) @ x64 @ \
            blur_matrix_f64(W, ksize, 0.0).T
        for blur in (gaussian_blur, separable_blur_reference):
            got = blur(xd, ksize).cpu().numpy()
            err = float(np.abs(got - want).max())
            log(f"[blur] {blur.__name__} {ksize}x{ksize} at {tuple(shape)}: "
                f"max abs err vs float64 {err:.3g} (limit {BLUR_ATOL:g})")
            check(err <= BLUR_ATOL, f"{blur.__name__} {ksize}: {err} > "
                  f"{BLUR_ATOL}")


# ---------------------------------------------------------------- phase 5
def w32_cfg(dtype="bfloat16"):
    from udp_pose_tpu_torch.config import default_config
    cfg = default_config()
    cfg.merge_from_dict(W32_UDP_OFFSET)
    cfg.TPU.DTYPE = dtype
    return cfg


def random_crops(n, cfg, seed):
    w, h = cfg.MODEL.IMAGE_SIZE
    rng = np.random.default_rng(seed)
    crops = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    center = rng.uniform(200, 600, (n, 2)).astype(np.float32)
    scale = np.repeat(rng.uniform(0.8, 1.6, (n, 1)), 2, 1).astype(
        np.float32) * np.float32([1.0, h / w])
    return crops, center, scale


def infer_for(cfg, device, flip_mode="fold", seed=0):
    from udp_pose_tpu_torch.core.infer import make_infer_fn
    from udp_pose_tpu_torch.models import build_model
    model = build_model(cfg, device=device, seed=seed)
    return make_infer_fn(model, target_type=cfg.MODEL.TARGET_TYPE,
                         flip_test=True, post_process=True,
                         kpd=cfg.LOSS.KPD, flip_mode=flip_mode)


def layout_of(t):
    return ("channels_last" if t.is_contiguous(
        memory_format=torch.channels_last) and not t.is_contiguous()
        else "nchw")


def peak_index(packed, W):
    return (packed[..., 1] * W + packed[..., 0]).long()


def phase_model(cfg_fn=w32_cfg, batch=SERVE_BATCH, iters=10,
                device="cuda"):
    """Returns (crops/s per dtype and flip mode, the layout of the
    heatmaps the serving graph hands its decode, a function that profiles
    the bf16 batches)."""
    from udp_pose_tpu_torch.ops import peak_offset as po
    from udp_pose_tpu_torch.ops.decode import get_final_preds, transform_preds

    launches0 = po.udp_offset_decode_fused.launches
    # (a) fp32, TF32 off: card heatmaps vs the port on the CPU
    set_tf32(False)
    cfg32 = cfg_fn("float32")
    crops, center, scale = random_crops(4, cfg32, seed=5)
    gpu = infer_for(cfg32, device)
    _, _, hm_gpu = gpu(crops, center, scale)
    _, _, hm_cpu = infer_for(cfg32, "cpu")(crops, center, scale)
    ref_max = float(hm_cpu.abs().max())
    err = float((hm_gpu.cpu() - hm_cpu).abs().max())
    log(f"[model] w32 fp32 B=4 flip heatmaps {tuple(hm_gpu.shape)}: card vs "
        f"CPU max abs err {err:.3g}, max |hm| {ref_max:.3g} "
        f"(limit {HEATMAP_REL_TOL:g} x max |hm|)")
    check(err <= HEATMAP_REL_TOL * ref_max, "card heatmaps != CPU heatmaps")

    # (b) decode of the card heatmaps: fused kernel vs plain version, the
    # serving graph's preds vs the fused decode, and vs the matmul route
    crops, center, scale = random_crops(batch, cfg32, seed=6)
    preds, maxvals, hm = gpu(crops, center, scale)
    layout = layout_of(hm)
    fused = po.udp_offset_decode_fused(hm, KPD)
    check(same_bits(fused, po.udp_offset_decode_reference(hm, KPD)),
          "fused decode of the w32 heatmaps != its plain version")
    coords, mv = po.packed_to_coords(fused)
    c = torch.from_numpy(center).to(device)
    s = torch.from_numpy(scale).to(device)
    check(same_bits(transform_preds(coords, c, s, hm.shape[:1:-1]), preds)
          and same_bits(mv, maxvals),
          "make_infer_fn preds != fused decode of its own heatmaps")
    check(bool(torch.isfinite(preds).all()), "non-finite preds")
    W = hm.shape[-1]
    blurred = po.blurred_offset_maps(hm, KPD)[0].flatten(1)
    top2 = blurred.topk(2, dim=1).values
    margin = 1e-5 * float(hm[:, 0::3].abs().max())
    clear = ((top2[:, 0] - top2[:, 1] > margin)
             & (top2[:, 0].abs() > margin)).view(batch, -1)
    agree = peak_index(fused, W) == peak_index(matmul_route(hm), W)
    check(bool(agree[clear].all()), f"{int((~agree & clear).sum())} maps "
          f"whose top two blurred values differ by more than {margin:.3g} "
          f"peak elsewhere than on the matmul route")
    log(f"[model] w32 fp32 B={batch} heatmaps ({layout}, strides "
        f"{tuple(hm.stride())}): fused decode == plain version, "
        f"make_infer_fn preds == fused decode ({int((maxvals <= 0).sum())} "
        f"of {maxvals.numel()} peaks <= 0); peak index equal to the matmul "
        f"route on all {int(clear.sum())} maps with a top-2 margin > "
        f"{margin:.3g}, {int((~clear).sum())} maps under it "
        f"({int((~agree).sum())} of all maps differ)")

    # (c) crops/s of the flip-test serving graph from host u8 crops, timed
    # before the process's first torch.profiler session.  bf16 two_pass
    # (2 B-sized forwards, twice the launches of fold) is paced by the
    # host and spreads from run to run; 5d times it again after profiling
    set_tf32(True)             # PyTorch's default for cuDNN convs
    torch.backends.cuda.matmul.allow_tf32 = False
    rates, bf16 = {}, {}
    card = card_line()

    def rate_of(infer, dtype, mode, when=""):
        ms = [host_ms(lambda: infer(crops, center, scale), iters)
              for _ in range(3)]
        log(f"[model] w32 256x192 flip B={batch} {dtype} {mode}{when}: "
            f"{batch / np.median(ms) * 1e3:.1f} crops/s (median of 3 runs "
            f"of {iters} batches: {', '.join(f'{m:.2f}' for m in ms)} "
            f"ms/batch; host u8 crops in, decoded preds out; cuDNN TF32 "
            f"convs on for float32) | {card}")
        return batch / np.median(ms) * 1e3, float(np.median(ms))

    for dtype in ("bfloat16", "float32"):
        for mode in ("two_pass", "fold"):
            infer = infer_for(cfg_fn(dtype), device, flip_mode=mode)
            rates[f"{dtype}/{mode}"], batch_ms = rate_of(infer, dtype, mode)
            if dtype == "float32":
                del infer
                torch.cuda.empty_cache()
                continue
            bf16[mode] = infer
            # where a batch's time goes, outside the forwards; the decode
            # before (matmul route) and after (fused kernel), in turns
            _, _, hm = infer(crops, center, scale)
            h2d = host_ms(lambda: torch.as_tensor(crops, device=device))

            def fused_decode(h):
                return get_final_preds(h, c, s, target_type="offset",
                                       kpd=KPD)

            def matmul_decode(h):
                coords, mv = po.packed_to_coords(matmul_route(h))
                return transform_preds(coords, c, s, h.shape[:1:-1]), mv

            # device time (graph replay) and eager back-to-back calls
            dec = {"matmul": [], "fused": []}
            for name in ("matmul", "fused", "fused", "matmul"):
                fn = fused_decode if name == "fused" else matmul_decode
                dec[name] += [graph_ms(fn, [(hm,)], iters=10),
                              cuda_ms(fn, [(hm,)], iters=20)]
            log(f"[model]   {mode} B={batch}: u8 crops host->card "
                f"{h2d:.3f} ms; decode before (matmul blurs + peak-only "
                f"kernel + transform) {dec['matmul'][0]:.4f}, "
                f"{dec['matmul'][2]:.4f} ms device, {dec['matmul'][1]:.4f}"
                f", {dec['matmul'][3]:.4f} ms eager; after (fused kernel "
                f"+ transform) {dec['fused'][0]:.4f}, "
                f"{dec['fused'][2]:.4f} ms device, {dec['fused'][1]:.4f}, "
                f"{dec['fused'][3]:.4f} ms eager; of {batch_ms:.2f} "
                f"ms/batch; heatmaps {layout_of(hm)}")
    check(po.udp_offset_decode_fused.launches > launches0,
          "the model phase never launched the fused decode kernel")

    def profile():
        """(d) the bf16 batches under torch.profiler, then two_pass timed
        again; run after the other phases' first profiler session."""
        for mode, infer in bf16.items():
            wall, busy, top, _ = profile_device(
                lambda: infer(crops, center, scale))
            if busy > 0:
                log(f"[model]   bfloat16 {mode} profile: 3 batches "
                    f"{wall:.2f} ms wall, card busy {busy:.2f} ms (idle "
                    f"share {1 - busy / wall:.3f}); top kernels (ms): "
                    + "; ".join(f"{k[:60]} {t:.2f}" for k, t in top))
            else:
                log(f"[model]   bfloat16 {mode} profile: the profiler saw "
                    "no device time; idle share not measured")
        rate_of(bf16["two_pass"], "bfloat16", "two_pass",
                " after profiler sessions")
        bf16.clear()
        torch.cuda.empty_cache()

    return rates, layout, profile


# ---------------------------------------------------------------- phase 6
def post_pose(port, frame, boxes):
    buf = io.BytesIO()
    np.save(buf, frame)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/pose", body=buf.getvalue(), headers={
            "Content-Type": "application/x-npy",
            "X-Boxes": json.dumps(np.asarray(boxes).tolist())})
        resp = conn.getresponse()
        body = resp.read()
        return resp.status, json.loads(body), time.perf_counter() - t0
    finally:
        conn.close()


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def requests_for(n_requests, frame_hw, seed=7):
    """(frame, boxes) per request: u8 frames, 3-8 xyxy boxes each."""
    rng = np.random.default_rng(seed)
    H, W = frame_hw
    out = []
    for _ in range(n_requests):
        frame = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        n = int(rng.integers(3, 9))
        x1 = rng.uniform(0, W * 0.7, n)
        y1 = rng.uniform(0, H * 0.6, n)
        boxes = np.stack([x1, y1, x1 + rng.uniform(W * 0.03, W * 0.3, n),
                          y1 + rng.uniform(H * 0.1, H * 0.4, n)], 1)
        out.append((frame, boxes.astype(np.float32)))
    return out


def phase_server(cfg, device="cuda", n_requests=4, frame_hw=(720, 1280)):
    """Returns each kernel's launches while serving the requests."""
    from udp_pose_tpu_torch.engine.server import (PoseServer, PoseService,
                                                  host_crops)

    service = PoseService(cfg, device=device, seed=0, window_ms=50.0)
    server = PoseServer(service, host="127.0.0.1", port=0)
    thread = server.serve_in_thread()
    try:
        reqs = requests_for(n_requests, frame_hw)
        results = [None] * n_requests
        gate = threading.Barrier(n_requests)

        def client(i):
            gate.wait()
            results[i] = post_pose(server.port, *reqs[i])

        zero_launches()
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(n_requests)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        launches = read_launches()
        check(not any(c.is_alive() for c in clients), "a client hung")
        batches = service.batcher.log_snapshot()
        J = cfg.MODEL.NUM_JOINTS
        for (frame, boxes), (status, body, secs) in zip(reqs, results):
            check(status == 200, f"/v1/pose answered {status}: {body}")
            kp = np.asarray(body["keypoints"], np.float32)
            sc = np.asarray(body["scores"], np.float32)
            n = len(boxes)
            check(kp.shape == (n, J, 2) and sc.shape == (n, J, 1),
                  f"shapes {kp.shape} {sc.shape} for {n} boxes")
            check(np.isfinite(kp).all() and np.isfinite(sc).all(),
                  "non-finite keypoints or scores")
        log(f"[serve] {n_requests} concurrent /v1/pose requests "
            f"({[len(b) for _, b in reqs]} boxes): all 200; latencies "
            f"{[round(r[2] * 1e3, 1) for r in results]} ms; batches "
            f"{list(batches)}; kernel launches {launches}")
        check(len(batches) < n_requests,
              f"no coalescing: {len(batches)} batches for "
              f"{n_requests} requests")
        check(launches["udp_offset_decode_fused"] > 0,
              "serving never launched the fused decode kernel")

        # each request alone, through the server and straight through the
        # pipeline on the same host crops (the batcher's, as in the JAX
        # server): the same bucket shapes, so the same numbers
        worst = 0.0
        for frame, boxes in reqs:
            status, body, _ = post_pose(server.port, frame, boxes)
            check(status == 200, f"/v1/pose answered {status}: {body}")
            kp, sc = service.pipe.infer_crops(*host_crops(
                frame, boxes, service.pipe.input_wh))
            worst = max(worst,
                        float(np.abs(kp - body["keypoints"]).max()),
                        float(np.abs(sc - body["scores"]).max()))
        log(f"[serve] each request alone, served vs UdpPosePipeline."
            f"infer_crops of the host crops: max abs difference {worst:.3g}")
        check(worst <= 1e-3, "served results != UdpPosePipeline.infer_crops")
        status, _ = get(server.port, "/healthz")
        check(status == 200, f"/healthz answered {status}")
        status, text = get(server.port, "/metrics")
        check(status == 200 and b"udp_pose_batches_total" in text,
              "/metrics lacks the batch counter")
    finally:
        server.shutdown()
        thread.join(timeout=30)
    return launches


# ---------------------------------------------------------------- phase 7
TRAIN_IMAGES, VAL_IMAGES, PEOPLE = 160, 32, 2
FRAME_WH = (640, 480)
STEP_LOSS_RTOL = 1e-4            # one step, card vs CPU, TF32 off
STEP_GRAD_TOL = 1e-3             # x each gradient tensor's max |g| (fp64)
STEP_BN_TOL = 1e-4               # x each running-stat tensor's max
WARM_STEPS = 3


def synthetic_coco(root, image_set, n_images, rng):
    """A COCO keypoints json of ``n_images`` 640x480 frames with two
    people each, as ``tools/profile_input.make_synthetic_coco`` writes
    (boxes 60-120 x 120-200 px, 17 visible joints inside each), and the
    seeded frames themselves, in memory: {image id: (H, W, 3) u8}."""
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    W, H = FRAME_WH
    images, annotations, frames = [], [], {}
    for img_id in range(1, n_images + 1):
        frames[img_id] = rng.integers(0, 255, (H, W, 3), np.uint8)
        images.append({"id": img_id, "width": W, "height": H,
                       "file_name": "%012d.jpg" % img_id})
        for _ in range(PEOPLE):
            cx, cy = rng.uniform(150, W - 150), rng.uniform(150, H - 150)
            w, h = rng.uniform(60, 120), rng.uniform(120, 200)
            kps = []
            for _j in range(17):
                kps += [float(cx + rng.uniform(-w / 3, w / 3)),
                        float(cy + rng.uniform(-h / 3, h / 3)), 2]
            annotations.append({
                "id": len(annotations) + 1, "image_id": img_id,
                "category_id": 1, "keypoints": kps, "num_keypoints": 17,
                "bbox": [cx - w / 2, cy - h / 2, w, h],
                "area": float(w * h), "iscrowd": 0})
    with open(os.path.join(root, "annotations",
                           f"person_keypoints_{image_set}.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return frames


def in_memory_coco(cfg, frames, is_train, dataset_cls=None):
    """The package's ``COCODataset`` (or ``dataset_cls``, RSN's) with two
    seams replaced: images come from ``frames`` instead of files, and
    crops from the port's native float warp rounded to u8 instead of
    OpenCV.  Everything else (json, db, augmentation, targets) is the
    package's."""
    from udp_pose_tpu_torch.data.coco import COCODataset
    from udp_pose_tpu_torch.native import warp_affine_batch

    class InMemoryCOCO(dataset_cls or COCODataset):
        def _read_image(self, path):
            return frames[int(os.path.basename(path)[-16:-4])]

        def _warp(self, img, trans):
            w, h = (int(v) for v in self.image_size)
            crop = warp_affine_batch(img, trans[None], (h, w))[0]
            return np.clip(np.rint(crop), 0, 255).astype(np.uint8)

    image_set = cfg.DATASET.TRAIN_SET if is_train else cfg.DATASET.TEST_SET
    return InMemoryCOCO(cfg, cfg.DATASET.ROOT, image_set, is_train)


def train_cfg(root, out_dir, dtype, cfg_fn=w32_cfg):
    cfg = cfg_fn(dtype)
    cfg.DATASET.ROOT = root
    cfg.OUTPUT_DIR = out_dir
    cfg.TRAIN.END_EPOCH = 2
    return cfg


def step_on(cfg, device, batch, dtype, perturb=0.0):
    """One train step of a fresh seeded w32 on ``device`` with weights and
    inputs in ``dtype``: (loss, {name: gradient}, {name: running stat}),
    on the CPU in float64.  The images are normalised on the CPU, so
    every run starts from the same bits; ``perturb`` scales each by
    (1 + perturb x seeded normal noise)."""
    from udp_pose_tpu_torch.core.infer import normalize_images
    from udp_pose_tpu_torch.core.loss import make_loss_fn
    from udp_pose_tpu_torch.core.train import (create_train_state,
                                               make_train_step)
    from udp_pose_tpu_torch.models import build_model
    model = build_model(cfg, device=device, train=True).to(dtype)
    state = create_train_state(cfg, model, steps_per_epoch=1)
    images = normalize_images(torch.as_tensor(batch["image"])).to(dtype)
    if perturb:
        images = images * (1 + perturb * torch.randn(
            images.shape, dtype=dtype,
            generator=torch.Generator().manual_seed(1)))
    metrics = make_train_step(make_loss_fn(cfg))(state, {
        "image": images.to(device),
        "target": torch.as_tensor(batch["target"]).to(device, dtype),
        "target_weight": torch.as_tensor(batch["target_weight"]).to(
            device, dtype)})
    grads = {k: p.grad.double().cpu() for k, p in model.named_parameters()}
    stats = {k: v.double().cpu() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return float(metrics["loss"]), grads, stats


def rel_errors(got, want):
    """Per tensor: max |got - want| / max |want|."""
    return {k: float((got[k] - want[k]).abs().max() / want[k].abs().max())
            for k in want}


def check_step(cfg, train_ds, card, device="cuda"):
    """(a) One step at B=2, TF32 off, on the card and on the CPU from the
    same seeded weights and batch, in float64 and in float32.

    The gradient of the seeded w32 is ill-conditioned in its input: a
    1e-7 relative input perturbation moves the CPU's float64 gradients
    by about as much as float32 rounding moves them (printed).  So each
    gradient tensor is held to 1e-3 x its max |g| card vs CPU in
    float64; in float32 the card's gradients must be no further from the
    float64 ones than the CPU's float32 gradients are (x2, median and
    worst tensor).  Loss and BN running stats are held card vs CPU in
    both."""
    from udp_pose_tpu_torch.data.base import collate
    set_tf32(False)
    train_ds.seed(0)
    batch = collate([train_ds[0], train_ds[1]])
    t0 = time.perf_counter()
    runs = {(dev, dt): step_on(cfg, dev, batch, dt)
            for dev in (device, "cpu") for dt in (torch.float64,
                                                  torch.float32)}
    for dt in (torch.float64, torch.float32):
        (loss_d, g_d, bn_d), (loss_c, g_c, bn_c) = runs[device, dt], \
            runs["cpu", dt]
        name = str(dt).split(".")[1]
        rel = abs(loss_d - loss_c) / abs(loss_c)
        check(rel <= STEP_LOSS_RTOL, f"{name} step loss: card {loss_d} vs "
              f"CPU {loss_c}")
        worst_bn = max(rel_errors(bn_d, bn_c).values())
        check(worst_bn <= STEP_BN_TOL, f"{name} step BN running stats: card "
              f"vs CPU {worst_bn:.3g} x max")
        if dt == torch.float64:
            errs = rel_errors(g_d, g_c)
            bad = {k: e for k, e in errs.items() if e > STEP_GRAD_TOL}
            check(not bad, f"float64 step gradients card vs CPU: {bad}")
            grad_msg = (f"worst gradient card vs CPU {max(errs.values()):.3g}"
                        f" x its tensor's max |g| (limit {STEP_GRAD_TOL:g})")
        else:
            ref = runs["cpu", torch.float64][1]
            card_e = list(rel_errors(g_d, ref).values())
            cpu_e = list(rel_errors(g_c, ref).values())
            med = (float(np.median(card_e)), float(np.median(cpu_e)))
            top = (max(card_e), max(cpu_e))
            check(med[0] <= 2 * med[1] and top[0] <= 2 * top[1],
                  f"float32 step gradients further from float64 on the card "
                  f"(median {med[0]:.3g}, worst {top[0]:.3g}) than on the "
                  f"CPU (median {med[1]:.3g}, worst {top[1]:.3g}) x2")
            grad_msg = (f"gradients vs the CPU's float64 ones, median / worst "
                        f"tensor: card {med[0]:.3g} / {top[0]:.3g}, CPU "
                        f"{med[1]:.3g} / {top[1]:.3g} x max |g| (limit: card "
                        f"within 2x the CPU's)")
        log(f"[train] (a) w32 {name} step B=2, TF32 off, card vs CPU: loss "
            f"{loss_d:.8g} vs {loss_c:.8g} (rel {rel:.3g}, limit "
            f"{STEP_LOSS_RTOL:g}); worst BN running stat {worst_bn:.3g} x "
            f"its max (limit {STEP_BN_TOL:g}); {grad_msg} | {card}")
    ref = runs["cpu", torch.float64][1]
    moved = list(rel_errors(
        step_on(cfg, "cpu", batch, torch.float64, perturb=1e-7)[1],
        ref).values())
    log(f"[train] (a) the same float64 step on the CPU with the input "
        f"x (1 + 1e-7 noise): gradients move by {np.median(moved):.3g} "
        f"(median) / {max(moved):.3g} (worst tensor) x max |g|; 5 steps in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    set_tf32(True)


def repeated_batch_steps(cfg, batch, card, n_steps=8, device="cuda",
                         label="(b) w32 bf16"):
    """(b) bf16: ``n_steps`` steps of a fresh w32 on one pre-built batch,
    each ended by a synchronize; returns the step times (s)."""
    from udp_pose_tpu_torch.core.loss import make_loss_fn
    from udp_pose_tpu_torch.core.train import (create_train_state,
                                               make_train_step, upload_batch)
    from udp_pose_tpu_torch.models import build_model
    state = create_train_state(
        cfg, build_model(cfg, device=device, train=True), steps_per_epoch=1)
    step_fn = make_train_step(make_loss_fn(cfg))
    losses, secs = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        metrics = step_fn(state, upload_batch(batch, device))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    check(all(np.isfinite(losses)), f"non-finite bf16 loss: {losses}")
    check(losses[-1] < losses[0], f"bf16 loss on one repeated batch did "
          f"not fall in {n_steps} steps: {losses}")
    B = len(batch["image"])
    ms = np.median(secs[WARM_STEPS:]) * 1e3
    log(f"[train] {label} B={B}, one pre-built batch repeated: losses "
        f"{', '.join(f'{v:.5g}' for v in losses)}; step "
        f"{', '.join(f'{s * 1e3:.1f}' for s in secs)} ms (first "
        f"{WARM_STEPS} warm-up); median {ms:.2f} ms/step = "
        f"{B / ms * 1e3:.1f} samples/s (upload + normalise + forward + "
        f"backward + Adam) | {card}")
    del state
    torch.cuda.empty_cache()
    return secs


def profile_train(cfg, model, batch, card, n=3, device="cuda", ddp=False):
    """Where a bf16 step's time goes: ``n`` steps of ``model`` (fresh Adam
    state) on one pre-built batch under torch.profiler, after two
    unprofiled ones; host and device ms a step of the ``train/*`` ranges
    of :mod:`udp_pose_tpu_torch.core.train`, device-busy share, kernels
    a step and the top kernels.  With ``ddp`` the step runs through
    :func:`udp_pose_tpu_torch.parallel.data_parallel` (a process group
    must exist).  Run last: a profiler session slows the process's later
    launches."""
    from torch.profiler import ProfilerActivity, profile

    from udp_pose_tpu_torch.core.loss import make_loss_fn
    from udp_pose_tpu_torch.core.train import (create_train_state,
                                               make_train_step, upload_batch)
    state = create_train_state(cfg, model, steps_per_epoch=1)
    if ddp:
        from udp_pose_tpu_torch.parallel import data_parallel
        state.ddp = data_parallel(state.model)
    step_fn = make_train_step(make_loss_fn(cfg))

    def one():
        step_fn(state, upload_batch(batch, device))

    one()
    one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            one()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # device events, less the ranges' own spans on the device timeline
    kernels = [e for e in events if e.device_type == cuda
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith(("train/", "Optimizer."))]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if busy == 0:
        log("[train] profile: the profiler saw no device time; the "
            "breakdown is not measured")
        return
    ranges = "; ".join(
        f"{e.key} {e.cpu_time_total / 1e3 / n:.2f}"
        for e in sorted(events, key=lambda e: e.key)
        if e.key.startswith("train/") and e.device_type != cuda)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[train] profile, bf16 B={len(batch['image'])} step "
        f"{'(DDP, NCCL world 1) ' if ddp else ''}from one "
        f"pre-built batch: {wall:.2f} ms wall a step, card busy "
        f"{busy:.2f} ms (idle share {1 - busy / wall:.3f}), "
        f"{sum(e.count for e in kernels) / n:.0f} device kernels a step; "
        f"host ms a step in {ranges}; top kernels (ms a step): "
        + "; ".join(f"{e.key[:50]} {e.self_device_time_total / 1e3 / n:.2f}"
                    for e in top) + f" | {card}")


def phase_train(tmp, cfg_fn=w32_cfg, device="cuda"):
    """Phase 7: trains full-width w32 (bf16, Adam at 1e-3, B=32, the
    yaml's augmentation) on a seeded synthetic mini-COCO through
    ``train.run`` for 2 epochs, evaluates ``final_state.pth`` through
    ``test.run``, and serves a request from it.  Returns each kernel's
    launches in that run."""
    import logging

    from udp_pose_tpu_torch import test as test_cli
    from udp_pose_tpu_torch import train as train_cli
    from udp_pose_tpu_torch.core.infer import make_infer_fn_from_cfg
    from udp_pose_tpu_torch.core.validate import serving_copy
    from udp_pose_tpu_torch.data.base import epoch_loader
    from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
    from udp_pose_tpu_torch.models import build_model
    from udp_pose_tpu_torch.ops import peak_offset as po

    logging.basicConfig(level=logging.INFO, format="[train.run] %(message)s")
    card = card_line()
    t_phase = time.perf_counter()
    rng = np.random.default_rng(7)
    root = os.path.join(tmp, "coco")
    frames = {"train2017": synthetic_coco(root, "train2017", TRAIN_IMAGES,
                                          rng),
              "val2017": synthetic_coco(root, "val2017", VAL_IMAGES, rng)}
    out_dir = os.path.join(tmp, "run")
    os.makedirs(out_dir)
    cfg = train_cfg(root, out_dir, "bfloat16", cfg_fn)
    train_ds = in_memory_coco(cfg, frames["train2017"], True)
    val_ds = in_memory_coco(cfg, frames["val2017"], False)
    B = cfg.TRAIN.BATCH_SIZE_PER_GPU
    check(len(train_ds) == TRAIN_IMAGES * PEOPLE
          and len(val_ds) == VAL_IMAGES * PEOPLE,
          f"db sizes {len(train_ds)}, {len(val_ds)}")

    check_step(train_cfg(root, out_dir, "float32", cfg_fn), train_ds, card,
               device)
    train_cli.set_cudnn(cfg)
    train_ds.seed(0)
    t0 = time.perf_counter()
    batch = next(epoch_loader(train_ds, B, seed=0))
    host_ms = (time.perf_counter() - t0) * 1e3 / B
    repeated = repeated_batch_steps(cfg, batch, card, device=device)

    # the run, with the kernels' counts read just after it: the yaml's
    # WORKERS (4) worker processes and the pinned prefetch
    check(cfg.WORKERS == 4, f"WORKERS {cfg.WORKERS}: the yaml's is 4")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=device, train=True)
    zero_launches()
    t0 = time.perf_counter()
    record = train_cli.run(cfg, model, train_ds, val_ds, out_dir, device)
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    weights = os.path.join(out_dir, "final_state.pth")
    t0 = time.perf_counter()
    _, perf = test_cli.run(cfg, weights, val_ds, out_dir, device)
    test_s = time.perf_counter() - t0
    launches = read_launches()
    eval_batches = -(-len(val_ds) // cfg.TEST.BATCH_SIZE_PER_GPU)
    n_val = len(record["validations"]) + 1
    check(launches["udp_offset_decode_fused"] == n_val * eval_batches,
          f"fused decode launched {launches['udp_offset_decode_fused']} "
          f"times for {n_val} validations of {eval_batches} batches")
    check(launches["fused_peak_offset"] == 0, "peak-only kernel launched")

    # the same run with the in-process loader (WORKERS 0), outside the
    # counted window
    cfg0 = train_cfg(root, out_dir + "_in_process", "bfloat16", cfg_fn)
    cfg0.WORKERS = 0
    os.makedirs(cfg0.OUTPUT_DIR)
    t0 = time.perf_counter()
    record0 = train_cli.run(cfg0, build_model(cfg0, device=device,
                                              train=True),
                            train_ds, val_ds, cfg0.OUTPUT_DIR, device)
    run0_s = time.perf_counter() - t0

    rep_ms = np.median(repeated[WARM_STEPS:]) * 1e3
    loader_ms = {}
    for name, rec, secs in (("the worker loader (WORKERS 4) and prefetch",
                             record, run_s),
                            ("the in-process loader (WORKERS 0)", record0,
                             run0_s)):
        steps = rec["steps"]
        losses = [s["loss"] for s in steps]
        check(len(steps) == cfg.TRAIN.END_EPOCH * (len(train_ds) // B),
              f"{len(steps)} steps")
        check(all(np.isfinite(losses)), f"non-finite bf16 loss: {losses}")
        # each epoch's first steps wait for the loader to fill: median of
        # the steps after the first WARM_STEPS of each epoch
        per_epoch = len(steps) // cfg.TRAIN.END_EPOCH
        warm = [s for s in steps if s["step"] >= WARM_STEPS] or steps
        iter_ms = np.median([s["iter_s"] for s in warm]) * 1e3
        load_ms = np.median([s["load_s"] for s in warm]) * 1e3
        loader_ms[name] = (iter_ms, load_ms)
        iters = ", ".join(f"{s['iter_s'] * 1e3:.1f}" for s in steps)
        loads = ", ".join(f"{s['load_s'] * 1e3:.1f}" for s in steps)
        log(f"[train] train.run w32 bf16 B={B} with {name}, {len(steps)} "
            f"steps over {cfg.TRAIN.END_EPOCH} epochs of {len(train_ds)} "
            f"samples: losses {', '.join(f'{v:.5g}' for v in losses)}; "
            f"iteration {iters} ms (waiting for the batch {loads} ms); "
            f"{B / iter_ms * 1e3:.1f} samples/s (median iteration "
            f"{iter_ms:.2f} ms of the {per_epoch - WARM_STEPS} steps after "
            f"{WARM_STEPS} warm-up steps in each epoch, of which waiting "
            f"for the batch {load_ms:.2f} ms); train.run {secs:.1f} s "
            f"| {card}")
    (w_ms, _), (p_ms, p_load) = loader_ms.values()
    log(f"[train] samples/s: worker loader + prefetch "
        f"{B / w_ms * 1e3:.1f}, in-process loader {B / p_ms * 1e3:.1f}, one "
        f"pre-built batch repeated {B / rep_ms * 1e3:.1f} (median step "
        f"{rep_ms:.2f} ms); host sample building {p_load / B:.3f} "
        f"ms/sample in process, {host_ms:.3f} ms/sample for the first "
        f"batch; peak max_memory_allocated {peak_gb:.2f} GB (the worker "
        f"run) | {card}")
    for v in record["validations"]:
        log(f"[train] validate after epoch {v['epoch']}: {v['crops']} crops "
            f"in {v['seconds'] * 1e3:.1f} ms = "
            f"{v['crops'] / v['seconds']:.1f} crops/s (flip test, fold, "
            f"{eval_batches} batches of {cfg.TEST.BATCH_SIZE_PER_GPU}; AP "
            f"{v['perf']:.4f}) | {card}")
    log(f"[train] test.run on final_state.pth: {len(val_ds)} crops in "
        f"{test_s * 1e3:.1f} ms (model build and load included), AP "
        f"{perf:.4f}; fused decode launches {launches} = "
        f"{n_val} validations x {eval_batches} batches | {card}")

    # (c) one eval batch: the kernel's packed output is its plain version's
    pipe = UdpPosePipeline(cfg, weights=weights, device=device)
    infer = make_infer_fn_from_cfg(
        serving_copy(model, build_model(cfg, device=device)), cfg,
        flip_pairs=val_ds.flip_pairs)
    vb = next(epoch_loader(val_ds, cfg.TEST.BATCH_SIZE_PER_GPU,
                           shuffle=False, drop_last=False))
    _, _, hm = infer(vb["image"], vb["center"], vb["scale"])
    fused = po.udp_offset_decode_fused(hm, KPD)
    check(same_bits(fused, po.udp_offset_decode_reference(hm, KPD)),
          "fused decode of a validation batch != its plain version")
    # (d) final_state.pth loaded strict=True serves a request
    frame = frames["val2017"][1]
    boxes = np.array([[200, 100, 320, 300], [330, 120, 440, 330]],
                     np.float32)
    kp, sc = pipe.infer_pose(frame, boxes)
    check(kp.shape == (2, 17, 2) and np.isfinite(kp).all()
          and np.isfinite(sc).all(), "non-finite keypoints from the "
          "trained weights")
    log(f"[train] (c) validation batch {tuple(hm.shape)} ({layout_of(hm)}): "
        f"fused decode bit-equal to the plain version; (d) final_state.pth "
        f"loaded strict=True into UdpPosePipeline, one request -> finite "
        f"keypoints")
    profile_train(cfg, model, batch, card, device=device)
    log(f"[train] phase 7 {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 8
DETECT_HW = (720, 1280)          # phase 8's frames
MAX_PERSONS = 16
DET_SIZE = 640
DET_REL_TOL = 1e-4               # YOLOv5n fp32 card vs CPU, TF32 off (8a)
LOW_CONF = 0.001                 # random weights: enough persons for 16
# 8c, fp32 with TF32 off, the card against the CPU: the crop matrices
# (relative to the largest entry), the crops from the same matrices (in
# [0, 255] units), and the keypoints of the pose stage on the same crops:
# px beyond what the difference of their offset maps carries (the float
# rounding of the transform to frame pixels)
MAT_REL_TOL = 1e-6
CROP_ATOL = 1e-4 * 255
KP_ATOL = 1e-3
REPO = os.path.dirname(os.path.abspath(__file__))
W32_YAML = os.path.join(REPO, "configs/coco/hrnet_w32_256x192_udp_offset.yaml")
STAGES = ("upload", "letterbox", "detector", "nms", "crop", "pose")


def detect_frames(n, seed=8, hw=DETECT_HW):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3),
                                                dtype=np.uint8)


def check_yolo(card, device="cuda"):
    """8a: YOLOv5n at 640 on a letterboxed 720p frame, float32, card vs
    CPU with TF32 off; then how far cuDNN's TF32 (the serving default)
    moves the card's output, and the forward's time both ways."""
    from udp_pose_tpu_torch.models import build_detector
    from udp_pose_tpu_torch.ops.yolo import letterbox
    canvas = letterbox(detect_frames(1)[0], DET_SIZE)
    x = torch.from_numpy(canvas).permute(2, 0, 1)[None].float() / 255.0
    xd = x.to(device)
    model = build_detector("yolov5n", device=device)
    set_tf32(False)
    with torch.inference_mode():
        want = build_detector("yolov5n", device="cpu")(x)
        got = model(xd).cpu()
        off_ms = host_ms(lambda: model(xd), 20)
        torch.backends.cudnn.allow_tf32 = True
        got_tf32 = model(xd).cpu()
        on_ms = host_ms(lambda: model(xd), 20)
    msg = []
    for name, sl in (("xywh", slice(0, 4)), ("scores", slice(4, None))):
        ref = float(want[..., sl].abs().max())
        err = float((got[..., sl] - want[..., sl]).abs().max())
        err32 = float((got_tf32[..., sl] - want[..., sl]).abs().max())
        check(err <= DET_REL_TOL * ref, f"YOLOv5n {name}: card vs CPU "
              f"{err:.3g} > {DET_REL_TOL:g} x {ref:.3g}")
        msg.append(f"{name} max abs err {err:.3g} of max {ref:.3g} (TF32 "
                   f"on: {err32:.3g})")
    log(f"[detect] 8a YOLOv5n fp32 {tuple(x.shape)} -> {tuple(got.shape)}, "
        f"card vs CPU, TF32 off: {'; '.join(msg)} (limit {DET_REL_TOL:g} x "
        f"max); forward {off_ms:.2f} ms TF32 off, {on_ms:.2f} ms on (host "
        f"clock, synchronised) | {card}")


def nms_candidates(rng, ties, n_side=(8, 4), per=16):
    """(n, 5) float32 boxes: clusters of ``per`` overlapping boxes on an
    8 x 4 grid 160 px apart (no overlap across clusters).  With ``ties``
    the clusters share one list of scores, so every score is held by 32
    boxes that do not overlap; else the scores are distinct."""
    nx, ny = n_side
    n = nx * ny * per
    cx = np.repeat((np.arange(nx * ny) % nx) * 160 + 80, per)
    cy = np.repeat((np.arange(nx * ny) // nx) * 160 + 80, per)
    xy = np.stack([cx, cy], 1) + rng.uniform(-25, 25, (n, 2)) - 30
    wh = rng.uniform(40, 60, (n, 2))
    scores = (np.tile(rng.permutation(per) / per + 0.01, nx * ny) if ties
              else rng.permutation(n) / n + 0.01)
    return np.concatenate([xy, xy + wh, scores[:, None]], 1).astype(
        np.float32)


def check_nms(device="cuda"):
    """8b: ``nms_torch`` on the card against the native ``greedy_nms``
    (the same list, ties in index order) and ``nms_np`` (the same list
    without ties; with ties the same set, as it visits a tie from the
    higher index), and the batched form against the CPU's."""
    from udp_pose_tpu_torch.native import greedy_nms
    from udp_pose_tpu_torch.ops.nms import (nms_np, nms_torch,
                                            nms_torch_batched)
    rng = np.random.default_rng(81)
    sets = [nms_candidates(rng, ties) for ties in (True, False)]
    for ties, dets in zip((True, False), sets):
        n = len(dets)
        t = torch.from_numpy(dets).to(device)
        ki, _ = nms_torch(t[:, :4], t[:, 4], 0.45, n, plus_one=False)
        kept = ki.cpu().numpy()
        kept = kept[kept >= 0].tolist()
        host = nms_np(dets.astype(np.float64), 0.45, plus_one=False)
        check(kept == greedy_nms(dets, 0.45, plus_one=False),
              f"nms_torch != native greedy_nms (ties {ties})")
        check(sorted(kept) == sorted(host) and (ties or kept == host),
              f"nms_torch != nms_np (ties {ties})")
    batch = torch.from_numpy(np.stack(sets))
    want = nms_torch_batched(batch[..., :4], batch[..., 4], 0.45,
                             MAX_PERSONS, plus_one=False)
    got = nms_torch_batched(batch[..., :4].to(device),
                            batch[..., 4].to(device), 0.45, MAX_PERSONS,
                            plus_one=False)
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          "batched nms_torch: card != CPU")
    log(f"[detect] 8b nms_torch on the card, {len(sets[0])} candidates "
        f"in 32 clusters: with ties == native greedy_nms (list) and nms_np "
        f"(set), {len(kept)} kept; without ties == both (list); batched "
        f"(2 frames, {MAX_PERSONS} rounds) == the CPU")


def stub_head(rows, n_rows=15120, nc=80, device="cuda"):
    """A detector whose raw output is ``rows`` (cx, cy, w, h, obj,
    person score, class) in letterbox pixels whatever the frame."""
    pred = np.zeros((n_rows, 5 + nc), np.float32)
    pred[:, 4] = pred[:, 5] = 1e-4
    for i, (cx, cy, w, h, obj, score, cls) in enumerate(rows):
        pred[i, :5] = (cx, cy, w, h, obj)
        pred[i, 5 + cls] = score
    t = torch.from_numpy(pred).to(device)
    return pred, (lambda x: t[None].expand(x.shape[0], -1, -1))


def stub_rows():
    """24 person candidates on a 6 x 4 grid of the 384 x 640 canvas (no
    overlap between them; two pairs tied), 3 lower-scored duplicates
    that NMS removes, and a box of another class."""
    rows = []
    for i in range(24):
        cx, cy = 60 + (i % 6) * 104, 50 + (i // 6) * 90
        rows.append((cx, cy, 40 + 2 * (i % 5), 70, 0.9, 0.95 - 0.01 * i, 0))
    rows[7] = rows[7][:5] + (rows[3][5], 0)        # ties: 3 and 7 ...
    rows[20] = rows[20][:5] + (rows[10][5], 0)     # ... 10 and 20
    rows += [(62, 52, 40, 70, 0.9, 0.5, 0), (166, 48, 42, 70, 0.9, 0.4, 0),
             (270, 140, 44, 70, 0.9, 0.3, 0), (300, 300, 50, 50, 0.9, 0.9, 5)]
    return rows


def host_path_boxes(pred, conf_thres, hw, canvas_hw):
    """The host reference: non_max_suppression → scale_boxes →
    padding_bbox, person rows only."""
    from udp_pose_tpu_torch.ops.yolo import (non_max_suppression,
                                             padding_bbox, scale_boxes)
    det = non_max_suppression(pred[None], conf_thres, 0.45)[0]
    det = det[det[:, 5] == 0]
    boxes = scale_boxes(det[:, :4], hw, canvas_hw)
    return (np.array([padding_bbox(*(int(v) for v in b), hw)
                      for b in boxes], np.float32),
            det[:, 4].astype(np.float32))


class CallRecorder:
    """Keeps the positional arguments and the result of every call of
    ``owner.name`` while it is active, as ``args + (result,)``; the calls,
    keyword arguments and all, go to the function as before (a wrapper's
    launch count included)."""

    def __init__(self, owner, name):
        self._owner, self._name, self.calls = owner, name, []

    def __enter__(self):
        real = self._real = getattr(self._owner, self._name)

        def record(*args, **kwargs):
            out = real(*args, **kwargs)
            self.calls.append(args + (out,))
            return out
        setattr(self._owner, self._name, record)
        return self

    def __exit__(self, *exc):
        setattr(self._owner, self._name, self._real)


def DecodeRecorder():
    """Every ``udp_offset_decode_fused`` call the decode makes, as
    (net, kpd, out)."""
    from udp_pose_tpu_torch.ops import decode
    return CallRecorder(decode, "udp_offset_decode_fused")


def check_decode_calls(calls, rows, what):
    """8d: each recorded decode bit-equal to the plain version."""
    from udp_pose_tpu_torch.ops.peak_offset import udp_offset_decode_reference
    check(len(calls) == 1, f"{what}: {len(calls)} decode calls, not 1")
    net, kpd, out = calls[0]
    check(net.shape[0] == rows, f"{what}: decode of {net.shape[0]} crops, "
          f"not {rows}")
    check(same_bits(out, udp_offset_decode_reference(net, kpd)),
          f"{what}: fused decode != its plain version")
    return f"{tuple(net.shape)} {layout_of(net)}"


def pose_stage_errors(hm, hm_cpu, packed, packed_cpu, preds, p_cpu, scale):
    """The card's pose stage against the CPU's on the same crops (8c,
    14a): the heatmaps ``hm`` (offset heads) and their decode ``packed``
    and keypoints ``preds`` on each.  Returns the heatmaps' largest
    difference and value, (B, J) masks of the maps whose peaks agree and
    of those with a clear top-2 margin (and the margin), the (B, J) mask
    of keypoints past their limit where the peaks agree, the largest
    keypoint difference there, and the limits: where the peaks agree, a
    keypoint moves by at most its offset maps' difference x kpd (the
    blur's weights sum to 1) in heatmap pixels, times the frame pixels a
    heatmap pixel spans (transform_preds), plus KP_ATOL px."""
    from udp_pose_tpu_torch.ops import peak_offset as po
    hm, packed, preds = hm.cpu(), packed.cpu(), preds.cpu()
    hm_cpu, packed_cpu, p_cpu = hm_cpu.cpu(), packed_cpu.cpu(), p_cpu.cpu()
    hm_max = float(hm_cpu.abs().max())
    diff = (hm - hm_cpu).abs()
    B, H, W = hm.shape[0], hm.shape[-2], hm.shape[-1]
    blurred = po.blurred_offset_maps(hm_cpu, KPD)[0].flatten(1)
    top2 = blurred.topk(2, dim=1).values
    margin = 1e-5 * float(hm_cpu[:, 0::3].abs().max())
    clear = ((top2[:, 0] - top2[:, 1] > margin)
             & (top2[:, 0].abs() > margin)).view(B, -1)
    agree = peak_index(packed, W) == peak_index(packed_cpu, W)
    off_err = torch.stack([diff[:, 1::3].amax((-2, -1)),
                           diff[:, 2::3].amax((-2, -1))], -1)   # (B, J, 2)
    span = (torch.as_tensor(scale).cpu().float() * 200.0
            / torch.tensor([W - 1.0, H - 1.0]))[:, None, :]     # (B, 1, 2)
    kp_limit = off_err * KPD * span + KP_ATOL
    kp_err = (preds - p_cpu).abs()
    over = (kp_err > kp_limit).any(-1) & agree
    kp_max = float(kp_err.amax(-1)[agree].max())
    return (float(diff.max()), hm_max, agree, clear, margin, over, kp_max,
            kp_limit)


def check_card_vs_cpu(card, cfg_fn=w32_cfg, device="cuda"):
    """8c, the card against the CPU: ``infer_frame`` of one 720p frame
    with the stubbed head, the pose model in fp32 with TF32 off, on an
    engine on each.  The boxes equal; the crop matrices agree to
    MAT_REL_TOL; the crops the card gathered equal the CPU's
    ``crop_boxes`` from the card's matrices to CROP_ATOL; the CPU's pose
    stage (normalise, forward with the flip, decode) on the card's crops
    gives the card's heatmaps to HEATMAP_REL_TOL of their largest value,
    the same peak on every map whose top two blurred values are apart
    (as in phase 5), and, wherever the peaks agree, the card's keypoints
    to within the move that the offset maps' difference allows (times
    kpd, in the frame pixels a heatmap pixel spans) plus KP_ATOL px.  It
    logs every measure before it checks them.  Launches here are not the
    path's."""
    from udp_pose_tpu_torch.engine.fused import FusedDetectPose
    from udp_pose_tpu_torch.ops import affine
    set_tf32(False)
    frame = detect_frames(1, seed=88)[0]
    engines, runs = {}, {}
    for dev in (device, "cpu"):
        weights = None if dev == device else {
            k: v.cpu() for k, v in
            engines[device]._pose.model.state_dict().items()}
        eng = FusedDetectPose(cfg_fn("float32"), weights, yolo_variant="n",
                              max_persons=MAX_PERSONS, det_size=DET_SIZE,
                              conf_thres=LOW_CONF, device=dev, seed=0)
        eng.yolo = stub_head(stub_rows(), device=dev)[1]
        with CallRecorder(affine, "crop_boxes") as crops, \
                CallRecorder(eng._pose, "infer_fn") as pose, \
                DecodeRecorder() as dec:
            out = eng.infer_frame(frame)
        check(len(crops.calls) == len(pose.calls) == len(dec.calls) == 1,
              f"{dev}: {len(crops.calls)} crop, {len(pose.calls)} pose and "
              f"{len(dec.calls)} decode calls for one frame")
        engines[dev] = eng
        runs[dev] = (out, crops.calls[0], pose.calls[0], dec.calls[0])
    (out, crop_call, pose_call, dec_call), (out_cpu, crop_cpu, _, _) = (
        runs[device], runs["cpu"])
    boxes_equal = (np.array_equal(out["boxes"], out_cpu["boxes"])
                   and len(out["boxes"]) == MAX_PERSONS)
    mats, mats_cpu = crop_call[1].cpu(), crop_cpu[1]
    mat_err = float((mats - mats_cpu).abs().max())
    mat_max = float(mats_cpu.abs().max())
    crops_card = crop_call[3].cpu()
    want = affine.crop_boxes(torch.from_numpy(frame)[None], mats,
                             crop_call[2])
    crop_err = float((crops_card - want).abs().max())
    crop_e2e = float((crops_card - crop_cpu[3]).abs().max())
    # the pose stage on the card's crops, on the CPU; the heatmaps are the
    # decode's input
    crops_in, center, scale, (preds, _, _) = pose_call
    with DecodeRecorder() as dec:
        p_cpu = engines["cpu"]._pose.infer_fn(
            crops_in.cpu(), center.cpu(), scale.cpu())[0]
    hm_cpu, _, packed_cpu = dec.calls[0]
    hm_err, hm_max, agree, clear, margin, over, kp_max, kp_limit = (
        pose_stage_errors(dec_call[0], hm_cpu, dec_call[2], packed_cpu,
                          preds, p_cpu, scale))
    kp_e2e = float(np.abs(out["keypoints"] - out_cpu["keypoints"]).max())
    log(f"[detect] 8c card vs CPU, w32 fp32 TF32 off, stubbed head, one 720p "
        f"frame: boxes equal {boxes_equal}; crop matrices {mat_err:.3g} "
        f"apart (limit {MAT_REL_TOL:g} x {mat_max:.3g}); card crops vs the "
        f"CPU's crop_boxes from the same matrices {crop_err:.3g} (limit "
        f"{CROP_ATOL:.3g} of 255), vs the CPU engine's own crops "
        f"{crop_e2e:.3g}; pose stage on the card's crops: heatmaps "
        f"{hm_err:.3g} (limit {HEATMAP_REL_TOL:g} x {hm_max:.3g}), peaks "
        f"equal on {int((agree & clear).sum())} of the {int(clear.sum())} "
        f"maps with a top-2 margin > {margin:.3g} ({int((~agree).sum())} "
        f"of {agree.numel()} maps differ), keypoints {kp_max:.3g} px apart "
        f"where the peaks agree, {int(over.sum())} over their limit (the "
        f"offset maps' difference x kpd x frame px a heatmap px, at most "
        f"{float(kp_limit.max()):.3g} px, plus {KP_ATOL:g} px); whole frame, "
        f"each engine its own crops: keypoints {kp_e2e:.3g} px apart | "
        f"{card}")
    check(boxes_equal, "8c card vs CPU: the boxes differ")
    check(mat_err <= MAT_REL_TOL * mat_max, "8c crop matrices: card vs CPU "
          "over the limit")
    check(crop_err <= CROP_ATOL, "8c crops: card vs the CPU's crop_boxes "
          "from the same matrices over the limit")
    check(hm_err <= HEATMAP_REL_TOL * hm_max, "8c pose stage heatmaps: card "
          "vs CPU over the limit")
    check(bool(agree[clear].all()), "8c: maps with a clear top-2 margin "
          "peak elsewhere on the card than on the CPU")
    check(not bool(over.any()), "8c keypoints: card vs CPU over the limit "
          "where the peaks agree")
    del engines, runs
    torch.cuda.empty_cache()


def decode_graph_times(eng, frames, card, device="cuda"):
    """8e: the decode inside the pose stage at the frame's and the chunk's
    shape, and the whole pose stage (normalise, forward with the flip,
    decode) on crops of the same shape: device time by graph replay (an
    enqueue of the pose stage can outlast any spin, as the launch queue
    fills).  Launches here are not the path's."""
    from udp_pose_tpu_torch.ops import peak_offset as po
    for n in (1, 8):
        with DecodeRecorder() as rec:
            eng.infer_frames(frames[:n])
        shape = check_decode_calls(rec.calls, n * MAX_PERSONS,
                                   f"infer_frames of {n}")
        net = rec.calls[0][0]
        ms = graph_ms(po.udp_offset_decode_fused, [(net, KPD)])
        bound_ms, bound_by = bound_of(*fused_bound(
            layout_of(net), batch=net.shape[0], J=net.shape[1] // 3,
            hw=tuple(net.shape[-2:])))
        pw, ph = eng._pose.input_wh
        rows = n * MAX_PERSONS
        crops = torch.rand(rows, ph, pw, 3, device=device) * 255
        center = torch.full((rows, 2), 400.0, device=device)
        scale = torch.full((rows, 2), 1.2, device=device)
        pose_ms = graph_ms(eng._pose.infer_fn, [(crops, center, scale)],
                           iters=3, repeats=3)
        log(f"[detect] 8e {n} frame(s): pose stage on {rows} crops "
            f"{pose_ms:.3f} ms device (graph replay), of which the decode "
            f"of {shape} {ms * 1e3:.2f} us (bound {bound_ms * 1e3:.2f} us, "
            f"{bound_by}) | {card}")


def time_frames(fn, n_frames, reps=3):
    """frames/s of ``fn()`` handling ``n_frames`` frames to host results:
    the median of ``reps`` runs after one warm-up, and the runs' ms."""
    fn()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        runs.append((time.perf_counter() - t0) * 1e3)
    return n_frames / np.median(runs) * 1e3, runs


def spin_cycles_per_ms():
    """Clock cycles of ``torch.cuda._sleep`` a millisecond, measured."""
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def stage_breakdown(eng, frames, reps=5):
    """Host and device ms of each stage of ``_run`` (its ``mark`` hook),
    medians over ``reps`` runs after one warm-up.  Host: the time to
    enqueue the stage, in a plain run.  Device: CUDA events around each
    stage of a second run, in which the card finishes the stage before,
    then spins (``torch.cuda._sleep``) while the host enqueues the stage,
    so that the events time the card's own work on it and not its wait
    for the host.  Returns (host, device, the stages whose enqueue
    outlasted the spin in some run: their device time includes waiting)."""
    cycles = spin_cycles_per_ms()
    host = {s: [] for s in STAGES}
    dev = {s: [] for s in STAGES}
    unheld = set()
    for rep in range(reps + 1):
        clock = []
        torch.cuda.synchronize()
        clock.append(time.perf_counter())
        eng._run(frames, mark=lambda stage: clock.append(time.perf_counter()))
        torch.cuda.synchronize()
        h = {s: (clock[i + 1] - clock[i]) * 1e3 for i, s in enumerate(STAGES)}
        spans, state = [], {}

        def hold(stage):
            torch.cuda.synchronize()
            state["spin"] = 2 * h[stage] + 5
            torch.cuda._sleep(int(state["spin"] * cycles))
            state["start"] = torch.cuda.Event(enable_timing=True)
            state["start"].record()
            state["t"] = time.perf_counter()

        def mark(stage):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            spans.append((state["start"], end,
                          (time.perf_counter() - state["t"]) * 1e3,
                          state["spin"]))
            if len(spans) < len(STAGES):
                hold(STAGES[len(spans)])

        hold(STAGES[0])
        eng._run(frames, mark=mark)
        torch.cuda.synchronize()
        if rep:                                   # not the warm-up
            for s, (start, end, enqueue_ms, spin_ms) in zip(STAGES, spans):
                host[s].append(h[s])
                dev[s].append(start.elapsed_time(end))
                if enqueue_ms >= spin_ms:
                    unheld.add(s)
    return ({s: float(np.median(v)) for s, v in host.items()},
            {s: float(np.median(v)) for s, v in dev.items()}, unheld)


def post_frame(port, frame):
    buf = io.BytesIO()
    np.save(buf, frame)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/v1/detect_pose", body=buf.getvalue(),
                     headers={"Content-Type": "application/x-npy"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def check_http(card, cfg_fn=w32_cfg, device="cuda", n_requests=4):
    """8f: concurrent /v1/detect_pose requests over HTTP, coalesced by
    the frame batcher; each answer the engine's single-frame one."""
    from udp_pose_tpu_torch.engine.server import PoseServer, PoseService
    from udp_pose_tpu_torch.ops.peak_offset import udp_offset_decode_fused
    service = PoseService(cfg_fn("bfloat16"), device=device, seed=0,
                          window_ms=100.0, detector="yolov5n",
                          max_persons=MAX_PERSONS, max_frames=8,
                          det_kwargs={"conf_thres": LOW_CONF})
    server = PoseServer(service, host="127.0.0.1", port=0)
    thread = server.serve_in_thread()
    try:
        frames = detect_frames(n_requests, seed=86)
        chunk = service.fused.infer_frames(frames)     # warms the shapes
        results = [None] * n_requests
        gate = threading.Barrier(n_requests)

        def client(i):
            gate.wait()
            t0 = time.perf_counter()
            results[i] = post_frame(server.port, frames[i]) + (
                time.perf_counter() - t0,)

        launches0 = udp_offset_decode_fused.launches
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(n_requests)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        check(not any(c.is_alive() for c in clients), "a client hung")
        launched = udp_offset_decode_fused.launches - launches0
        log_ = service.frame_batcher.log_snapshot()
        status, text = get(server.port, "/metrics")
        check(status == 200 and b"udp_pose_frame_batches_total" in text,
              "/metrics lacks the frame batch counter")
        line = [ln for ln in text.decode().splitlines()
                if ln.startswith('udp_pose_batch_frames{stat="max"}')]
        check(line and float(line[0].split()[-1]) > 1,
              f"/metrics shows no frame batching: {line}")
        check(launched == len(log_), f"{launched} decode launches for "
              f"{len(log_)} frame batches")
        worst = 0.0
        for want, (status, body, _) in zip(chunk, results):
            check(status == 200, f"/v1/detect_pose answered {status}")
            check(sorted(body) == ["boxes", "det_scores", "keypoints",
                                   "latency_ms", "scores"],
                  f"/v1/detect_pose keys {sorted(body)}")
            n = len(body["boxes"])
            check(np.asarray(body["keypoints"]).shape == (n, 17, 2)
                  and np.isfinite(body["keypoints"]).all(),
                  "served keypoints misshapen or not finite")
            if list(log_) == [n_requests]:   # the chunk's own batch shape
                check(np.array_equal(np.asarray(body["boxes"], np.float32),
                                     want["boxes"]),
                      "served boxes != infer_frames of the same frames")
                worst = max(worst, float(np.abs(
                    np.asarray(body["keypoints"]) - want["keypoints"]).max()))
        status, body = get(server.port, "/healthz")
        check(status == 200 and json.loads(body)["detector"] is True,
              "/healthz does not report the detector")
        log(f"[detect] 8f {n_requests} concurrent /v1/detect_pose 720p "
            f"requests: all 200 with boxes, det_scores, keypoints, scores; "
            f"frame batches {list(log_)} ({line[0]}), {launched} decode "
            f"launch(es); latencies "
            f"{[round(r[2] * 1e3, 1) for r in results]} ms; persons "
            f"{[len(r[1]['boxes']) for r in results]}"
            + (f"; served == infer_frames of the same {n_requests} frames in "
               f"boxes, keypoints max abs diff {worst:.3g} px"
               if list(log_) == [n_requests] else "") + f" | {card}")
    finally:
        server.shutdown()
        thread.join(timeout=30)


def check_cli(tmp, card, pose_cfg=W32_YAML, device="cuda"):
    """8g: ``python -m udp_pose_tpu_torch.infer --fused --detector
    yolov5n`` on two generated 720p images and a six-frame video."""
    import cv2
    src = os.path.join(tmp, "imgs")
    os.makedirs(src)
    frames = detect_frames(6, seed=87)
    for i in range(2):
        cv2.imwrite(os.path.join(src, f"f{i}.png"), frames[i])
    video = os.path.join(tmp, "clip.avi")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                             DETECT_HW[::-1])
    check(writer.isOpened(), "cv2 cannot write an MJPG avi")
    for f in frames:
        writer.write(f)
    writer.release()
    for source, extra in ((src, []), (video, ["--chunk", "4"])):
        out = os.path.join(tmp, "out" + "".join(extra))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "udp_pose_tpu_torch.infer", "--source",
             source, "--pose-cfg", pose_cfg, "--detector", "yolov5n",
             "--fused", "--device", device, "--save-dir", out, *extra],
            cwd=REPO,
            capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0, f"infer CLI on {source} exited "
              f"{proc.returncode}: {proc.stderr[-1500:]}")
        written = sorted(os.listdir(out))
        check(written == (["f0.png", "f1.png"] if source == src
                          else ["out_clip.avi"]),
              f"infer CLI wrote {written}")
        log(f"[detect] 8g python -m udp_pose_tpu_torch.infer --fused "
            f"--detector yolov5n {' '.join(extra)} on "
            f"{os.path.basename(source)}: exit 0, wrote {written} in "
            f"{time.perf_counter() - t0:.1f} s | {card}")


def phase_detect(tmp, cfg_fn=w32_cfg, pose_yaml=W32_YAML, device="cuda"):
    """Phase 8, detect-then-pose at full width: YOLOv5n at 640, w32
    256x192 bf16 with the flip test, ``max_persons`` 16, seeded 720p
    frames, random weights.  Returns (the fused decode's launches on this
    path, a function that profiles a frame and frees the engine)."""
    from udp_pose_tpu_torch.engine.fused import FusedDetectPose
    from udp_pose_tpu_torch.ops import peak_offset as po
    card = card_line()
    t_phase = time.perf_counter()
    check_yolo(card, device)
    check_nms(device)
    check_card_vs_cpu(card, cfg_fn, device)
    torch.backends.cudnn.allow_tf32 = True       # PyTorch's default
    eng = FusedDetectPose(cfg_fn("bfloat16"), None, yolo_variant="n",
                          max_persons=MAX_PERSONS, det_size=DET_SIZE,
                          conf_thres=LOW_CONF, device=device, seed=0)
    frames = detect_frames(8)
    H, W = DETECT_HW
    g = eng._letterbox_geom(H, W)
    canvas_hw = (g["nH"] + g["top"] + g["bottom"],
                 g["nW"] + g["left"] + g["right"])
    eng.infer_frames(frames)                      # warm every shape once
    eng.infer_frame(frames[0])
    eng.infer_frame_low_bw(frames[0])
    decode_graph_times(eng, frames, card, device)

    # the path: every count set to 0 here and read once at the end of 8f;
    # nothing in between launches a kernel other than through the path
    zero_launches()
    # 8c, 8d: a stubbed head (known candidates) against the host path, in
    # each serving shape; one decode launch a frame or a chunk
    pred, stub = stub_head(stub_rows(), device=device)
    want, want_sc = host_path_boxes(pred, LOW_CONF, (H, W), canvas_hw)
    check(len(want) > MAX_PERSONS, f"stub: {len(want)} host boxes")
    yolo, eng.yolo = eng.yolo, stub
    shapes = {}
    try:
        for what, run, rows in (
                ("infer_frame", lambda: [eng.infer_frame(frames[0])], 16),
                ("infer_frames", lambda: eng.infer_frames(frames), 128),
                ("low-bw", lambda: [eng.infer_frame_low_bw(frames[0])], 16)):
            with DecodeRecorder() as rec:
                outs = run()
            shapes[what] = check_decode_calls(rec.calls, rows, what)
            for out in outs:
                check(np.array_equal(out["boxes"], want[:MAX_PERSONS])
                      and np.array_equal(out["scores"],
                                         want_sc[:MAX_PERSONS]),
                      f"{what}: boxes != the host path's: "
                      f"{out['boxes'][:2]} vs {want[:2]}")
                check(np.isfinite(out["keypoints"]).all()
                      and out["keypoints"].shape == (MAX_PERSONS, 17, 2),
                      f"{what}: non-finite or misshapen keypoints")
        handles = [eng.submit_frame(f) for f in frames[:3]]
        piped = [eng.fetch(h) for h in handles]
        kp_diff = max(float(np.abs(p["keypoints"] - eng.infer_frame(f)[
            "keypoints"]).max()) for p, f in zip(piped, frames[:3]))
        check(all(np.array_equal(p["boxes"], want[:MAX_PERSONS])
                  for p in piped), "submit/fetch boxes != the host path's")
        check(kp_diff == 0, f"submit/fetch keypoints {kp_diff:.3g} px from "
              f"infer_frame's of the same frames")
    finally:
        eng.yolo = yolo
    log(f"[detect] 8c stubbed head ({len(stub_rows())} candidates: ties, "
        f"duplicates, another class): the 16 boxes and scores of "
        f"infer_frame, of each frame of infer_frames (8) and of low-bw == "
        f"the host path's first 16 (non_max_suppression -> scale_boxes -> "
        f"padding_bbox), exactly; 3 frames in flight by submit/fetch: the "
        f"same boxes, keypoints {kp_diff:.3g} px from infer_frame's; 8d one "
        f"fused-decode launch each, bit-equal to the plain version: "
        + "; ".join(f"{k} {v}" for k, v in shapes.items()))
    # with the random YOLOv5n: every row filled, and nothing between the
    # upload and the readback waits for the card
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with DecodeRecorder() as rec:
            handle = eng.submit_frame(frames[1])
    except RuntimeError as e:
        raise CheckFailed(f"submit_frame waited for the card: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = eng.fetch(handle)
    check(len(out["boxes"]) == MAX_PERSONS, f"random YOLOv5n at conf "
          f"{LOW_CONF}: {len(out['boxes'])} persons, not {MAX_PERSONS}")
    check(np.isfinite(out["keypoints"]).all(), "non-finite keypoints")
    shape = check_decode_calls(rec.calls, MAX_PERSONS, "random YOLOv5n")
    log(f"[detect] 8c random YOLOv5n, conf {LOW_CONF}: {len(out['boxes'])} "
        f"persons; decode {shape} bit-equal to the plain version; "
        f"submit_frame ran under torch.cuda.set_sync_debug_mode('error'): "
        f"no synchronising call from the upload to the readback")

    # 8e: frames/s and where a frame's time goes
    rates = {"infer_frame": time_frames(
        lambda: [eng.infer_frame(f) for f in frames], len(frames))}
    for depth in (2, 3, 4):
        def piped(depth=depth):
            inflight = []
            for f in frames:
                inflight.append(eng.submit_frame(f))
                if len(inflight) >= depth:
                    eng.fetch(inflight.pop(0))
            for h in inflight:
                eng.fetch(h)
        rates[f"submit/fetch x{depth}"] = time_frames(piped, len(frames))
    rates["infer_frames chunk 8"] = time_frames(
        lambda: eng.infer_frames(frames), len(frames))
    rates["infer_stream_low_bw"] = time_frames(
        lambda: list(eng.infer_stream_low_bw(iter(frames))), len(frames))
    for name, (fps, runs) in rates.items():
        log(f"[detect] 8e {name}: {fps:.1f} frames/s (median of 3 runs of "
            f"{len(frames)} 720p frames: "
            f"{', '.join(f'{r:.1f}' for r in runs)} ms) | {card}")
    for n in (1, 8):
        host, dev, unheld = stage_breakdown(eng, frames[:n])
        note = (f"; not held throughout: {', '.join(sorted(unheld))}"
                if unheld else "")
        log(f"[detect] 8e stages, {n} frame(s) a run, ms host (enqueue) / "
            f"device (CUDA events, the card held back while each stage is "
            f"enqueued{note}): "
            + "; ".join(f"{s} {host[s]:.2f} / {dev[s]:.3f}"
                        for s in STAGES)
            + f"; total {sum(host.values()):.2f} / "
            f"{sum(dev.values()):.3f} | {card}")
    check_http(card, cfg_fn, device)
    launches = read_launches()
    check(launches["fused_peak_offset"] == 0, "peak-only kernel launched")
    check_cli(tmp, card, pose_yaml, device)
    log(f"[detect] phase 8 {time.perf_counter() - t_phase:.1f} s; fused "
        f"decode launches on the path {launches}")

    def profile():
        """8e: the card's idle share over 5 frames of ``infer_frame``."""
        wall, busy, top, kernels = profile_device(
            lambda: [eng.infer_frame(f) for f in frames[:5]], n=1)
        if busy > 0:
            log(f"[detect] 8e profile, 5 infer_frame calls: {wall:.2f} ms "
                f"wall, card busy {busy:.2f} ms (idle share "
                f"{1 - busy / wall:.3f}), {kernels / 5:.0f} device kernels "
                f"and copies a frame; top kernels (ms): "
                + "; ".join(f"{k[:60]} {t:.2f}" for k, t in top)
                + f" | {card}")
        else:
            log("[detect] 8e profile: the profiler saw no device time; "
                "idle share not measured")
        torch.cuda.empty_cache()

    return launches, profile


# ---------------------------------------------------------------- phase 9
INT8_SITES_W32 = 293             # w32's 294 convs less final_layer
INT8_SITES_YOLOV5N = 57          # YOLOv5n convs less the three detect heads
CPU_GEMM_ROWS = 4096             # rows of each _int_mm held against the CPU


def kernel_wrappers():
    """Every kernel wrapper of the port, by the name the kernels line
    gives it."""
    from udp_pose_tpu_torch.ops import int8_conv as ic
    from udp_pose_tpu_torch.ops import int8_dwconv as dw
    from udp_pose_tpu_torch.ops import peak_offset as po
    return {"udp_offset_decode_fused": po.udp_offset_decode_fused,
            "fused_peak_offset": po.fused_peak_offset,
            "int8_conv_fused": ic.int8_conv_fused,
            "quant_im2col": ic.quant_im2col,
            "dequant_epilogue": ic.dequant_epilogue,
            "int8_dwconv": dw.int8_dwconv,
            "int8_dwconv_tiled": dw.int8_dwconv_tiled}


def zero_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def read_launches():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def fused_routes():
    """``int8_conv_fused``'s launches since the counts were set to 0, by
    route."""
    from udp_pose_tpu_torch.ops import int8_conv as ic
    return dict(getattr(ic.int8_conv_fused, "launches_by_route", {}))


class PathLaunches:
    """The launches of one path, summed over the windows in which only
    that path runs: :meth:`run` sets every count to 0 just before its call
    and reads them just after.  ``want`` holds what the batches that the
    path served should have launched (:meth:`served`).  ``made``: every
    path of the run, for the kernels line's launches by route."""

    made = []

    def __init__(self, name):
        PathLaunches.made.append(self)
        self.name = name
        self.counts = dict.fromkeys(kernel_wrappers(), 0)
        self.want = dict.fromkeys(kernel_wrappers(), 0)
        self.routes = {}        # int8_conv_fused's launches by route
        self.layouts = {}
        self.dw_layouts = {}

    def run(self, fn, *args):
        zero_launches()
        try:
            return fn(*args)
        finally:
            for name, n in read_launches().items():
                self.counts[name] += n
            for route, n in fused_routes().items():
                self.routes[route] = self.routes.get(route, 0) + n

    def served(self, decodes, int8_sites, dw_sites=0):
        """Batches served: ``decodes`` decode launches, ``int8_sites``
        launches of the fused int8 conv and ``dw_sites`` of the int8
        depthwise conv (and none of the three-step kernels)."""
        self.want["udp_offset_decode_fused"] += decodes
        self.want["int8_conv_fused"] += int8_sites
        self.want["int8_dwconv"] += dw_sites

    def keep_layouts(self, *engines):
        """Note every input layout at which the int8 models of
        ``engines`` (``SelfCalibrating`` states) launched the fused kernel
        (the plans in each ``Int8Conv2d.launch_plans``), one site for each
        layout and conv geometry, for :func:`check_path_layouts`."""
        from udp_pose_tpu_torch.models.quantize import (Int8Conv2d,
                                                        Int8DepthwiseConv2d)
        for engine in engines:
            if engine.qmodel is None:
                continue
            for m in engine.qmodel.modules():
                if isinstance(m, (Int8Conv2d, Int8DepthwiseConv2d)):
                    into = (self.layouts if isinstance(m, Int8Conv2d)
                            else self.dw_layouts)
                    for shape, stride, dtype, _, aligned, *_ in m.launch_plans:
                        into.setdefault(
                            (shape, stride, dtype, aligned, m.out_channels,
                             m.kernel_size, m.stride, m.padding,
                             m.bias is not None), m)

    def check(self, engine=False):
        """The launches against what the served batches need; with
        ``engine``, also that the Hopper engine ran ("wgmma" launches)."""
        check(self.counts == self.want and self.want["int8_conv_fused"] > 0,
              f"{self.name}: launches {self.counts}, but its batches should "
              f"have launched {self.want}")
        check(sum(self.routes.values()) == self.counts["int8_conv_fused"]
              and (not engine or self.routes.get("wgmma", 0) > 0),
              f"{self.name}: int8_conv_fused launches by route "
              f"{self.routes}, {self.counts['int8_conv_fused']} in all")
        log(f"[int8] {self.name}: int8_conv_fused launches by route "
            f"{self.routes}")


def forwards(cfg):
    """Pose forwards a batch: two in the flip test's two_pass mode."""
    return 2 if (cfg.TEST.FLIP_TEST and cfg.TEST.get(
        "FLIP_MODE", "fold") == "two_pass") else 1


def int8_sites(model, x, strides=False):
    """The int8 sites of ``model``'s forward on ``x``, in call order:
    (conv module, its input's shape and dtype[, its input's element
    strides]); the heads that ``DEFAULT_SKIP`` keeps in float are left
    out."""
    from udp_pose_tpu_torch.models.quantize import DEFAULT_SKIP, _matches
    from udp_pose_tpu_torch.utils.convert import conv_sites
    sites, seen, hooks = conv_sites(model), [], []
    for name, mod in model.named_modules():
        if name in sites and not _matches(sites[name], DEFAULT_SKIP):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, args: seen.append(
                    (m, tuple(args[0].shape), args[0].dtype)
                    + ((tuple(args[0].stride()),) if strides else ()))))
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return seen


def int8_shape_run(conv, shape, dtype, device, seed, stride=None):
    """9a at one conv shape: the weight quantisation against the CPU's,
    the fused kernel against the three-step card path and the plain
    version (at the route ``fused_tiling`` picks and, where that is the
    Hopper engine, at PR 6's route too), the three-step kernels against
    theirs, ``_int_mm`` against the exact float64 product on the card and
    the CPU's integer product on its first rows, all bit for bit; times
    (graph replay; the engine and PR 6's design in turns) of each kernel,
    the plain versions, ``_int_mm`` and the bf16 cuDNN conv of the same
    shape; each kernel's bound (ms, and what bounds it)."""
    import torch.nn.functional as F

    from udp_pose_tpu_torch.models.quantize import Int8Conv2d, quantize_kernel
    from udp_pose_tpu_torch.ops import int8_conv as ic
    N, C, H, W = shape
    if stride is None:          # dense channels-last
        g = torch.Generator(device=device).manual_seed(seed)
        x = torch.randn(shape, generator=g, device=device).to(
            dtype).contiguous(memory_format=torch.channels_last)
    else:                       # the site's own layout (a channel slice)
        x = layout_tensor(shape, stride, dtype, 0, 1.0, seed, device)
    layer = Int8Conv2d(conv, float(x.float().abs().amax()) * 0.9)
    args = (layer.inv_s_a, layer.kernel_size, layer.stride, layer.padding,
            layer.k_pad)
    Ho, Wo = ic.conv_out_hw(H, W, *args[1:4])
    M, O = N * Ho * Wo, layer.out_channels
    a = ic.quant_im2col(x, *args)
    acc = ic.int8_gemm(a, layer.w_gemm)
    y = ic.dequant_epilogue(acc, layer.scale, layer.bias, dtype, M, O)
    fused = ic.int8_conv_fused(x, layer).permute(0, 2, 3, 1).reshape(M, O)
    exact = ic.int8_gemm_reference(a, layer.w_gemm)
    rows = min(CPU_GEMM_ROWS, a.shape[0])
    cpu = ic.int8_gemm(a[:rows].cpu(), layer.w_gemm.cpu())
    what = f"{tuple(shape)} k{layer.kernel_size[0]} s{layer.stride[0]} -> {O}"
    check(all(torch.equal(d.cpu(), c) for d, c in zip(
        quantize_kernel(conv.weight), quantize_kernel(conv.weight.cpu()))),
          f"weight quantisation: card != CPU at {what}")
    a_ref = ic.quant_im2col_reference(x, *args)
    # the plain version of the fused kernel is these three plain steps
    y_ref = ic.dequant_epilogue_reference(exact, layer.scale, layer.bias,
                                          dtype, M, O)
    errs = {"quant_im2col": float((a.int() - a_ref.int()).abs().max()),
            "dequant_epilogue": float((y.double() - y_ref.double()).abs()
                                      .max()),
            "int8_conv_fused": float((fused.double() - y_ref.double()).abs()
                                     .max())}
    check(torch.equal(a, a_ref),
          f"quant_im2col != its plain version at {what}")
    check(torch.equal(acc, exact), f"_int_mm != the exact product at {what}")
    check(torch.equal(acc[:rows].cpu(), cpu),
          f"_int_mm on the card != the CPU's at {what}")
    check(torch.equal(y, y_ref),
          f"dequant_epilogue != its plain version at {what}")
    check(torch.equal(fused, y),
          f"int8_conv_fused != the three-step card path at {what}")
    sms = card_sms()
    tiling = ic.fused_tiling(shape, O, layer.kernel_size, layer.stride,
                             layer.padding, ic._loads(x), dtype, sms)
    # PR 6's design at the same shape: where the Hopper engine takes the
    # conv, the route and tiling the older kernel would, launched too
    pr6 = ic.fused_tiling(shape, O, layer.kernel_size, layer.stride,
                          layer.padding, ic._loads(x), dtype, sms,
                          wgmma=False)
    engine = tiling.route == "wgmma"
    if engine:
        check(torch.equal(ic.int8_conv_fused(x, layer, route=pr6.route)
                          .permute(0, 2, 3, 1).reshape(M, O), y),
              f"int8_conv_fused, PR 6's {pr6.route} route, != the "
              f"three-step card path at {what}")
    # the shift route's blocks of twice the rows, against the tiling they
    # widen: that launch too must equal the three steps
    narrow = (pr6.block_m // 2, pr6.block_n)
    narrow = (ic.FUSED_TILES.index(narrow)
              if pr6.route == "shift" and narrow in ic.FUSED_TILES else None)
    if narrow is not None:
        check(torch.equal(ic.int8_conv_fused(x, layer, narrow, pr6.route)
                          .permute(0, 2, 3, 1).reshape(M, O), y),
              f"int8_conv_fused at tiling {ic.FUSED_TILES[narrow]} != "
              f"the three-step card path at {what}")
    del a_ref, exact, y_ref
    elt = x.element_size()
    w_bf = conv.weight.detach().to(torch.bfloat16)
    x_bf = x.to(torch.bfloat16)
    fast = dict(iters=5, repeats=3, warm_s=0.02)
    once = dict(iters=1, repeats=1, warm_s=0.0)
    if engine:       # the two designs in turns: new, old, old, new
        both = turns({"new": lambda: ic.int8_conv_fused(x, layer),
                      "pr6": lambda: ic.int8_conv_fused(x, layer,
                                                        route=pr6.route)},
                     ["new", "pr6", "pr6", "new"])
    else:
        both = dict.fromkeys(("new", "pr6"), graph_ms(
            lambda: ic.int8_conv_fused(x, layer), [()], **fast))
    t = {"int8_conv_fused": both["new"], "pr6_design": both["pr6"],
         "narrow_tiles": graph_ms(lambda: ic.int8_conv_fused(
             x, layer, narrow, pr6.route), [()], **fast)
         if narrow is not None else 0.0,
         "quant_im2col": graph_ms(lambda: ic.quant_im2col(x, *args), [()],
                                  **fast),
         "dequant_epilogue": graph_ms(lambda: ic.dequant_epilogue(
             acc, layer.scale, layer.bias, dtype, M, O), [()], **fast),
         "int_mm": graph_ms(lambda: ic.int8_gemm(a, layer.w_gemm),
                            [()], **fast),
         "cudnn_bf16": graph_ms(lambda: F.conv2d(
             x_bf, w_bf, None, conv.stride, conv.padding), [()], **fast),
         "plain_quant_im2col": cuda_ms(lambda: ic.quant_im2col_reference(
             x, *args), [()], iters=2, repeats=1, warm_s=0.0),
         "plain_dequant_epilogue": cuda_ms(
             lambda: ic.dequant_epilogue_reference(
                 acc, layer.scale, layer.bias, dtype, M, O), [()], iters=2,
             repeats=1, warm_s=0.0)}
    del a, acc, y, fused
    if narrow is None:
        t["narrow_tiles"] = t["pr6_design"]
    t["wide_sites"] = 0 if narrow is None else 1
    t["plain_int8_conv_fused"] = cuda_ms(
        lambda: ic.int8_conv_fused_reference(x, layer), [()], **once)
    K = layer.kernel_size[0] * layer.kernel_size[1] * C
    # the fused kernel's least work: the activation read once, the weight,
    # scale and bias, the output written once; 2 operations a product
    t["fused_bytes"] = (x.numel() * elt + layer.w_gemm.numel() + M * O * elt
                        + O * 8)
    t["fused_ops"] = 2 * M * O * K
    bounds = {
        "int8_conv_fused": bound_of(t["fused_bytes"], t["fused_ops"],
                                    INT8_OPS_PER_S),
        "quant_im2col": bound_of(x.numel() * elt + ic.gemm_rows(M)
                                 * layer.k_pad, 0),
        "dequant_epilogue": bound_of(M * O * (4 + elt) + O * 8, 0)}
    t["route"] = tiling.route
    design = (f"wgmma {tiling.block_m}x{tiling.block_n}"
              + (f" walking {tiling.tiles_per_block} tiles"
                 if tiling.tiles_per_block > 1 else "")
              + f", PR 6: {pr6.route} {pr6.block_m}x{pr6.block_n}"
              if engine else f"{tiling.route} {tiling.block_m}x"
              f"{tiling.block_n}")
    return t, bounds, errs, f"{what} {design}"


@functools.lru_cache(maxsize=None)
def card_sms(device="cuda"):
    """Streaming multiprocessors of the card, as the wrapper reads them."""
    return torch.cuda.get_device_properties(device).multi_processor_count


INT8_KERNELS = ("int8_conv_fused", "quant_im2col", "dequant_epilogue")
DESIGN_INT8_CONV = (
    "the Hopper engine of csrc/int8_conv_sm90.cu (warpgroup MMAs, since "
    "PR 12) at the sites fused_tiling routes to it ('wgmma'), PR 6's "
    "implicit GEMM of csrc/int8_conv.cu at the others; 'ms' times the "
    "sum, 'pr6_design_ms' PR 6's design at every site in the same turns")


def int8_forward_times(net, sites, batch, card, device="cuda"):
    """9a for one net: :func:`int8_shape_run` at each distinct int8 conv
    shape of ``sites`` (from :func:`int8_sites`, with the input's strides
    where they are recorded: a site whose input is not dense
    channels-last is run in its own layout; ``batch`` replaces their
    batch, None keeps it), logged.  Returns the numbers summed over one
    forward (each shape times its sites), the largest |card - plain| per
    kernel, and the number of shapes."""
    errs = dict.fromkeys(INT8_KERNELS, 0.0)
    shapes = {}
    for conv, shape, dtype, *stride in sites:
        n = shape[0] if batch is None else batch
        stride = stride[0] if stride else None
        if stride is not None and all(
                stride[d] == want for d, want in (
                    (0, shape[1] * shape[2] * shape[3]), (1, 1),
                    (2, shape[3] * shape[1]), (3, shape[1]))
                if shape[d] > 1):
            stride = None       # dense channels-last
        key = ((n,) + shape[1:], dtype, conv.out_channels,
               conv.kernel_size, conv.stride, conv.padding, stride)
        shapes.setdefault(key, [conv, 0])[1] += 1
    sums = {"bound_by_bytes": 0.0, "bound_by_ops": 0.0, "by_route": {}}
    for i, (key, (conv, count)) in enumerate(sorted(
            shapes.items(), key=lambda kv: str(kv[0]))):
        t, bounds, err, what = int8_shape_run(conv, key[0], key[1],
                                              device, seed=i, stride=key[6])
        errs = {k: max(v, err[k]) for k, v in errs.items()}
        for k, v in list(t.items()) + [(f"bound_{k}", b[0])
                                       for k, b in bounds.items()]:
            if not isinstance(v, str):
                sums[k] = sums.get(k, 0.0) + count * v
        r = sums["by_route"].setdefault(t["route"], dict.fromkeys(
            ("sites", "ms", "pr6_design_ms", "bound_ms", "cudnn_bf16_ms"),
            0.0))
        for k, v in (("sites", 1), ("ms", t["int8_conv_fused"]),
                     ("pr6_design_ms", t["pr6_design"]),
                     ("bound_ms", bounds["int8_conv_fused"][0]),
                     ("cudnn_bf16_ms", t["cudnn_bf16"])):
            r[k] += count * v
        by = bounds["int8_conv_fused"][1]
        sums["bound_by_" + ("bytes" if by == "bytes" else "ops")] += (
            count * bounds["int8_conv_fused"][0])
        three = t["quant_im2col"] + t["int_mm"] + t["dequant_epilogue"]
        narrow = (f", at the tiling it widens "
                  f"{t['narrow_tiles'] * 1e3:.1f}" if t["wide_sites"]
                  else "")
        pr6 = (f", PR 6's design {t['pr6_design'] * 1e3:.1f} us in the "
               f"same turns" if t["route"] == "wgmma" else "")
        layout = "" if key[6] is None else f" strides {key[6]}"
        log(f"[int8] 9a {net} {what}{layout} {str(key[1])[6:]} x{count}: "
            f"bit-equal; int8_conv_fused {t['int8_conv_fused'] * 1e3:.1f}"
            f" us{pr6}{narrow} (bound "
            f"{bounds['int8_conv_fused'][0] * 1e3:.1f}, {by}; "
            f"plain {t['plain_int8_conv_fused'] * 1e3:.1f}); three steps "
            f"{three * 1e3:.1f} us (quant_im2col "
            f"{t['quant_im2col'] * 1e3:.1f}, bound "
            f"{bounds['quant_im2col'][0] * 1e3:.1f}, plain "
            f"{t['plain_quant_im2col'] * 1e3:.1f}; _int_mm "
            f"{t['int_mm'] * 1e3:.1f}; dequant_epilogue "
            f"{t['dequant_epilogue'] * 1e3:.1f}, bound "
            f"{bounds['dequant_epilogue'][0] * 1e3:.1f}, plain "
            f"{t['plain_dequant_epilogue'] * 1e3:.1f}); bf16 cuDNN conv "
            f"{t['cudnn_bf16'] * 1e3:.1f} us")
        torch.cuda.empty_cache()
    sums["three_step"] = (sums["quant_im2col"] + sums["int_mm"]
                          + sums["dequant_epilogue"])
    log(f"[int8] 9a {net}, one forward ({len(sites)} int8 sites, "
        f"{len(shapes)} shapes, ms): int8_conv_fused "
        f"{sums['int8_conv_fused']:.3f} (bound "
        f"{sums['bound_int8_conv_fused']:.3f}, of which shapes bound by "
        f"bytes {sums['bound_by_bytes']:.3f}: "
        f"{sums['fused_bytes'] / 1e9:.2f} GB, "
        f"{sums['fused_ops'] / 1e12:.2f} T int8 operations; plain "
        f"{sums['plain_int8_conv_fused']:.3f}) against the three steps "
        f"{sums['three_step']:.3f} (quant_im2col "
        f"{sums['quant_im2col']:.3f}, bound "
        f"{sums['bound_quant_im2col']:.3f}, plain "
        f"{sums['plain_quant_im2col']:.3f}; _int_mm "
        f"{sums['int_mm']:.3f}; dequant_epilogue "
        f"{sums['dequant_epilogue']:.3f}, bound "
        f"{sums['bound_dequant_epilogue']:.3f}, plain "
        f"{sums['plain_dequant_epilogue']:.3f}) and the bf16 cuDNN convs "
        f"{sums['cudnn_bf16']:.3f}; int8_conv_fused with the shift "
        f"route's blocks of twice the rows at the tiling they widen "
        f"({sums['wide_sites']:.0f} sites on {card_sms()} SMs) "
        f"{sums['narrow_tiles']:.3f} | {card}")
    routes = "; ".join(
        f"{route} {r['sites']:.0f} sites {r['ms']:.3f} ms (PR 6's design "
        f"{r['pr6_design_ms']:.3f}, bound {r['bound_ms']:.3f}, bf16 cuDNN "
        f"{r['cudnn_bf16_ms']:.3f})"
        for route, r in sorted(sums["by_route"].items()))
    log(f"[int8] 9a {net}, one forward by route: {routes}; all "
        f"{sums['int8_conv_fused']:.3f} ms against PR 6's design "
        f"{sums['pr6_design']:.3f} in the same turns | {card}")
    return sums, errs, len(shapes)


def check_int8_kernels(card, cfg_fn=w32_cfg, device="cuda", fold_batch=256,
                       det_hw=(384, 640)):
    """9a: every distinct int8 conv shape of w32 (B = ``fold_batch``, the
    fold batch of 128 crops with the flip) and of YOLOv5n on a 720p
    frame's canvas.  Returns, per kernel, its numbers summed over one w32
    fold forward for the kernels line, and its largest |card - plain|
    over every shape of both nets."""
    from udp_pose_tpu_torch.models import build_detector, build_model
    cfg = cfg_fn("bfloat16")
    w, h = cfg.MODEL.IMAGE_SIZE
    nets = {"w32": int8_sites(build_model(cfg, device=device),
                              torch.zeros(1, 3, h, w, dtype=torch.bfloat16,
                                          device=device)),
            "yolov5n": int8_sites(build_detector("yolov5n", device=device),
                                  torch.zeros(1, 3, *det_hw, device=device))}
    check(len(nets["w32"]) == INT8_SITES_W32
          and len(nets["yolov5n"]) == INT8_SITES_YOLOV5N,
          f"int8 sites: w32 {len(nets['w32'])}, YOLOv5n "
          f"{len(nets['yolov5n'])}")
    totals, t_start = {}, time.perf_counter()
    errs = dict.fromkeys(INT8_KERNELS, 0.0)
    n_shapes = 0
    for net, sites in nets.items():
        sums, err, n = int8_forward_times(
            net, sites, fold_batch if net == "w32" else None, card, device)
        totals[net] = sums
        errs = {k: max(v, err[k]) for k, v in errs.items()}
        n_shapes += n
    host = int8_host_cost(device)
    log(f"[int8] 9a host cost of one launch at one frame's 16 crops with "
        f"the flip (B=32, 3x3 64->64 at 32x24, enqueued back to back): "
        f"int8_conv_fused {host['int8_conv_fused']:.2f} us (PR 6's design "
        f"{host['pr6_design']:.2f}), the three steps "
        f"{host['three_step']:.2f} us, a bf16 cuDNN conv "
        f"{host['cudnn_bf16']:.2f} us | {card}")
    log(f"[int8] 9a {time.perf_counter() - t_start:.1f} s: int8_conv_fused "
        f"bit-equal to the three-step card path and its plain version at "
        f"all {n_shapes} shapes")
    w32, yolo = totals["w32"], totals["yolov5n"]
    per = (f"one w32 fold forward, B={fold_batch}, {INT8_SITES_W32} "
           f"launches")
    out = {name: {"max_abs_err": errs[name], "ms": w32[name],
                  "plain_ms": w32[f"plain_{name}"],
                  "bound_ms": w32[f"bound_{name}"], "bound_by": "bytes",
                  "library_ms": None, "per": per,
                  "yolov5n_frame_ms": yolo[name],
                  "yolov5n_frame_bound_ms": yolo[f"bound_{name}"]}
           for name in INT8_KERNELS}
    out["int8_conv_fused"].update(
        design=DESIGN_INT8_CONV,
        bound_by=("bytes" if w32["bound_by_bytes"] >= w32["bound_by_ops"]
                  else "operations"),
        pr6_design_ms=w32["pr6_design"], by_route=w32["by_route"],
        yolov5n_frame_pr6_design_ms=yolo["pr6_design"],
        three_step_ms=w32["three_step"], int_mm_ms=w32["int_mm"],
        pr6_ms_without_wide_blocks=w32["narrow_tiles"],
        cudnn_bf16_conv_ms=w32["cudnn_bf16"],
        yolov5n_frame_three_step_ms=yolo["three_step"],
        yolov5n_frame_cudnn_bf16_conv_ms=yolo["cudnn_bf16"])
    out["int8_conv_fused"]["host_us_per_launch"] = host["int8_conv_fused"]
    out["int8_conv_fused"]["pr6_design_host_us_per_launch"] = host[
        "pr6_design"]
    for name in ("quant_im2col", "dequant_epilogue"):
        out[name]["on_main_path"] = False
    return out


def int8_host_cost(device):
    """µs of host time per launch (:func:`enqueue_us`) of the fused int8
    conv, of the three steps and of a bf16 cuDNN conv, at one of w32's
    3×3 convs at the detect-then-pose batch."""
    import torch.nn.functional as F

    from udp_pose_tpu_torch.models.quantize import Int8Conv2d
    from udp_pose_tpu_torch.ops import int8_conv as ic
    x = torch.randn(2 * MAX_PERSONS, 64, 32, 24, device=device).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    conv = torch.nn.Conv2d(64, 64, 3, 1, 1).to(device)
    layer = Int8Conv2d(conv, 3.0)
    w_bf = conv.weight.detach().to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    args = (layer.inv_s_a, layer.kernel_size, layer.stride, layer.padding,
            layer.k_pad)
    M = x.shape[0] * 32 * 24

    def three():
        acc = ic.int8_gemm(ic.quant_im2col(x, *args), layer.w_gemm)
        ic.dequant_epilogue(acc, layer.scale, layer.bias, x.dtype, M, 64)

    pr6 = ic.fused_tiling(x.shape, 64, (3, 3), (1, 1), (1, 1),
                          ic._loads(x), x.dtype, card_sms(), wgmma=False)
    return {"int8_conv_fused": enqueue_us(lambda: ic.int8_conv_fused(
                x, layer)),
            "pr6_design": enqueue_us(lambda: ic.int8_conv_fused(
                x, layer, route=pr6.route)),
            "three_step": enqueue_us(three),
            "cudnn_bf16": enqueue_us(lambda: F.conv2d(x, w_bf, None, 1, 1))}


def int8_card_vs_cpu(table, card, cfg_fn=w32_cfg, device="cuda"):
    """9b: the int8 w32 in fp32 with TF32 off, card against CPU, on 4
    crops with the same table.  The gate is site by site: every int8
    site, fed the input it got on the card, must give the card's output
    on the CPU bit for bit.  Across the whole net an activation ulps from
    a quantiser's rounding tie lands on either side of it and the step
    cascades, so the whole-net heatmap difference is as large as int8's
    own drift from fp32 (on one H100, 80.3 against 85.9 for these crops)
    and would pass a card that ran float convs: it is printed beside that
    drift and gates nothing.  Where the peaks agree, the keypoints are
    held to what the offset maps' difference carries (times kpd, in
    source pixels) plus KP_ATOL px."""
    from udp_pose_tpu_torch.core.infer import make_infer_fn
    from udp_pose_tpu_torch.models import build_model
    from udp_pose_tpu_torch.models.quantize import Int8Conv2d, QuantizedModel
    set_tf32(False)
    cfg = cfg_fn("float32")
    crops, center, scale = random_crops(4, cfg, seed=12)
    got, card_sites, cpu_sites = {}, {}, {}
    for run in ("card", "cpu", "cpu_fp32"):
        model = build_model(cfg, device=device if run == "card" else "cpu",
                            seed=0)
        net = model if run == "cpu_fp32" else QuantizedModel(model, table)
        if run == "cpu":
            cpu_sites = {name: m for name, m in net.named_modules()
                         if isinstance(m, Int8Conv2d)}
        def keep(m, args, out, name):
            card_sites.setdefault(name, (args[0], out))

        hooks = [m.register_forward_hook(
            lambda m, args, out, name=name: keep(m, args, out, name))
            for name, m in net.named_modules()
            if run == "card" and isinstance(m, Int8Conv2d)]
        infer = make_infer_fn(net, target_type="offset", flip_test=True,
                              post_process=True, kpd=KPD)
        with DecodeRecorder() as rec:
            preds = infer(crops, center, scale)[0]
        for h in hooks:
            h.remove()
        got[run] = (rec.calls[0][0].cpu(), rec.calls[0][2].cpu(), preds.cpu())
    with torch.inference_mode():
        exact = sum(int(torch.equal(y.cpu(), cpu_sites[name](x.cpu())))
                    for name, (x, y) in card_sites.items())
    (hm, packed, preds), (hm_cpu, packed_cpu, p_cpu) = got["card"], got["cpu"]
    diff = (hm - hm_cpu).abs()
    hm_max, hm_err = float(hm_cpu.abs().max()), float(diff.max())
    drift = float((hm_cpu - got["cpu_fp32"][0]).abs().max())
    W, H = hm.shape[-1], hm.shape[-2]
    agree = peak_index(packed, W) == peak_index(packed_cpu, W)
    off_err = torch.stack([diff[:, 1::3].amax((-2, -1)),
                           diff[:, 2::3].amax((-2, -1))], -1)
    span = (torch.from_numpy(scale) * 200.0
            / torch.tensor([W - 1.0, H - 1.0]))[:, None, :]
    kp_err = (preds - p_cpu).abs()
    over = (kp_err > off_err * KPD * span + KP_ATOL).any(-1) & agree
    kp_max = float(kp_err.amax(-1)[agree].max()) if agree.any() else 0.0
    log(f"[int8] 9b int8 w32 fp32 TF32 off, 4 crops, card vs CPU with the "
        f"same table: {exact} of {len(card_sites)} int8 sites bit-equal "
        f"on the card's site inputs; heatmaps {hm_err:.3g} apart (max |hm| "
        f"{hm_max:.3g}, mean diff {float(diff.mean()):.3g}; a number only, "
        f"beside the int8 vs fp32 drift on the CPU, {drift:.3g}); peaks "
        f"equal on "
        f"{int(agree.sum())} of {agree.numel()} maps; keypoints {kp_max:.3g}"
        f" px apart where they agree, {int(over.sum())} over their limit | "
        f"{card}")
    check(exact == len(card_sites) == INT8_SITES_W32,
          f"9b: {exact} of {len(card_sites)} int8 sites equal card vs CPU")
    check(not bool(over.any()), "9b int8 keypoints: card vs CPU over the "
          "limit where the peaks agree")
    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False


def int8_serving(path, card, cfg_fn=w32_cfg, device="cuda",
                 batch=SERVE_BATCH, iters=10):
    """9b: full-width w32 bf16 with the flip at B = ``batch``: the
    pipeline calibrates itself on two batches, then int8 and bf16 crops/s
    in both flip modes (host u8 crops in, decoded keypoints out), the
    engaged sites, peak memory, the card against the CPU and the
    int8-vs-bf16 drift.  Every int8 batch runs inside a window of
    ``path``; the bf16 batches and the card-vs-CPU check run outside.
    Returns the table."""
    from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline

    def pipe(mode, **kw):
        cfg = cfg_fn("bfloat16")
        cfg.TEST.FLIP_MODE = mode
        return UdpPosePipeline(cfg, device=device, seed=0, **kw)

    def served(p, *args):
        """One int8 pipeline batch, as the path's launches expect it."""
        def call():
            int8_sites = (0 if p.int8.calibrating else
                          INT8_SITES_W32 * forwards(p.cfg))
            out = p.infer_crops(*args)
            path.served(1, int8_sites)
            return out
        return call

    modes = ("two_pass", "fold")
    int8 = {"two_pass": pipe("two_pass", quantize="int8", calib_batches=2)}
    t0 = time.perf_counter()
    for seed in (10, 11):
        check(int8["two_pass"].int8.calibrating, "calibrated too early")
        path.run(served(int8["two_pass"],
                        *random_crops(batch, cfg_fn("bfloat16"), seed)))
    calib_s = time.perf_counter() - t0
    table = int8["two_pass"].int8.table
    check(table is not None and len(table) == INT8_SITES_W32 + 1,
          f"self-calibration: table of {0 if table is None else len(table)}")
    int8["fold"] = pipe("fold", act_scales=table)
    bf16 = {mode: pipe(mode) for mode in modes}
    crops, center, scale = random_crops(batch, cfg_fn("bfloat16"), seed=9)
    rates, peaks = {}, {}
    for mode in modes:
        for kind in ("bf16", "int8", "int8", "bf16"):
            if kind == "int8":
                fn = served(int8[mode], crops, center, scale)
                run = lambda f, *a: path.run(f, *a)       # noqa: E731
            else:
                p = bf16[mode]
                fn = lambda p=p: p.infer_crops(crops, center, scale)  # noqa
                run = lambda f, *a: f(*a)                  # noqa: E731
            ms = [run(host_ms, fn, iters) for _ in range(3)]
            rates.setdefault(f"{kind}/{mode}", []).append(
                batch / np.median(ms) * 1e3)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            run(fn)
            peaks[f"{kind}/{mode}"] = torch.cuda.max_memory_allocated() / 1e9
    for mode in modes:
        check(len(int8[mode].int8.qmodel.engaged) == INT8_SITES_W32,
              f"{mode}: {len(int8[mode].int8.qmodel.engaged)} engaged sites")
    kp_q = path.run(served(int8["two_pass"], crops, center, scale))[0]
    kp_b = bf16["two_pass"].infer_crops(crops, center, scale)[0]
    drift = np.abs(kp_q - kp_b)
    log(f"[int8] 9b w32 256x192 bf16 flip B={batch}: self-calibrated on 2 "
        f"batches in {calib_s:.2f} s ({len(table)} sites in the table, "
        f"{INT8_SITES_W32} engaged: final_layer stays bf16); "
        f"{INT8_SITES_W32} int8_conv_fused launches a forward (two_pass: 2 "
        f"forwards a batch, fold: 1 of 2B) | {card}")
    for key, r in rates.items():
        log(f"[int8] 9b {key}: {np.median(r):.1f} crops/s (runs "
            f"{', '.join(f'{v:.1f}' for v in r)}, in turns bf16, int8, int8,"
            f" bf16, each the median of 3 x {iters} batches); peak "
            f"max_memory_allocated {peaks[key]:.2f} GB | {card}")
    log(f"[int8] 9b int8 vs bf16 keypoints on the same {batch} crops "
        f"(random weights: a number only): max {drift.max():.3g} px, median "
        f"{np.median(drift):.3g} px")
    path.keep_layouts(*(p.int8 for p in int8.values()))
    del int8, bf16
    torch.cuda.empty_cache()
    int8_card_vs_cpu(table, card, cfg_fn, device)
    return table, {k: float(np.median(v)) for k, v in rates.items()}


def int8_http(path, card, cfg_fn=w32_cfg, device="cuda",
              frame_hw=(720, 1280)):
    """9c: ``/v1/pose`` of a server started with ``quantize="int8"``:
    ``/healthz`` says calibrated after its first two batches.  The
    requests run inside one window of ``path``."""
    from udp_pose_tpu_torch.engine.server import PoseServer, PoseService
    service = PoseService(cfg_fn("bfloat16"), device=device, seed=0,
                          window_ms=5.0, quantize="int8")
    server = PoseServer(service, host="127.0.0.1", port=0)
    thread = server.serve_in_thread()

    def requests():
        states, lat = [], []
        for frame, boxes in requests_for(3, frame_hw, seed=91):
            states.append(json.loads(get(server.port, "/healthz")[1]))
            status, body, secs = post_pose(server.port, frame, boxes)
            check(status == 200 and np.isfinite(body["keypoints"]).all(),
                  f"/v1/pose int8 answered {status}")
            lat.append(round(secs * 1e3, 1))
        states.append(json.loads(get(server.port, "/healthz")[1]))
        return states, lat

    try:
        states, lat = path.run(requests)
        seen = [(s["quantize"], s["calibrated"]) for s in states]
        check(seen == [("int8", False)] * 2 + [("int8", True)] * 2,
              f"/healthz int8 states {seen}")
        pipe = service.pipe
        check(len(pipe.int8.qmodel.engaged) == INT8_SITES_W32,
              "the server's int8 model engages the wrong sites")
        batches = len(service.batcher.log_snapshot())
        calib = pipe.int8.calib.batches
        path.served(batches, (batches - calib) * INT8_SITES_W32
                    * forwards(pipe.cfg))
        path.keep_layouts(pipe.int8)
        log(f"[int8] 9c /v1/pose --quantize int8, 3 requests one after "
            f"another: /healthz (quantize, calibrated) {seen}; latencies "
            f"{lat} ms (the first {calib} calibrate and serve bf16); "
            f"{batches} batches | {card}")
    finally:
        server.shutdown()
        thread.join(timeout=30)


def int8_detect(table, path, card, cfg_fn=w32_cfg, device="cuda",
                hw=DETECT_HW, det_size=DET_SIZE):
    """9d: ``FusedDetectPose(quantize="int8")`` with the pose table of 9b
    and a detector that calibrates itself on its first two frames; one
    frame under ``set_sync_debug_mode("error")``; frames/s of
    ``infer_frame``, ``submit_frame``/``fetch`` 3 deep and chunks of 8
    beside the float engine.  Every call of the int8 engine runs inside
    a window of ``path``; the float engine's run outside."""
    from udp_pose_tpu_torch.engine.fused import FusedDetectPose
    kw = dict(yolo_variant="n", max_persons=MAX_PERSONS, det_size=det_size,
              conf_thres=LOW_CONF, device=device, seed=0)
    engines = {"bf16": FusedDetectPose(cfg_fn("bfloat16"), None, **kw),
               "int8": FusedDetectPose(cfg_fn("bfloat16"), None,
                                       quantize="int8", pose_act_scales=table,
                                       **kw)}
    q = engines["int8"]
    pose_sites = INT8_SITES_W32 * forwards(q._pose.cfg)

    def runs(fn, n_runs):
        """``fn`` doing ``n_runs`` device runs (a frame, or a chunk, and
        one decode each) of the int8 engine, counted as the path expects:
        the detector runs int8 from the frame that froze its table."""
        def call():
            out = path.run(fn)
            det_sites = (0 if q.det_act_scales is None
                         else INT8_SITES_YOLOV5N)
            path.served(n_runs, n_runs * (pose_sites + det_sites))
            return out
        return call

    frames = detect_frames(8, seed=92, hw=hw)
    for f in frames[:2]:
        check(q.det_act_scales is None, "detector calibrated too early")
        runs(lambda f=f: q.infer_frame(f), 1)()
    check(q.det_act_scales is not None
          and len(q.det_int8.active().engaged) == INT8_SITES_YOLOV5N,
          "the detector did not calibrate itself on two frames")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = runs(lambda: q.submit_frame(frames[2]), 1)()
    except RuntimeError as e:
        raise CheckFailed(f"int8 submit_frame waited for the card: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = path.run(q.fetch, handle)
    check(len(out["boxes"]) == MAX_PERSONS
          and np.isfinite(out["keypoints"]).all(),
          f"int8 frame: {len(out['boxes'])} persons")
    rates = {}
    for kind in ("bf16", "int8", "int8", "bf16"):
        eng = engines[kind]

        def piped(eng=eng):
            inflight = []
            for f in frames:
                inflight.append(eng.submit_frame(f))
                if len(inflight) >= 3:
                    eng.fetch(inflight.pop(0))
            for h in inflight:
                eng.fetch(h)

        for name, fn, n_runs in (
                ("infer_frame", lambda eng=eng: [eng.infer_frame(f)
                                                 for f in frames],
                 len(frames)),
                ("submit/fetch x3", piped, len(frames)),
                ("infer_frames chunk 8",
                 lambda eng=eng: eng.infer_frames(frames), 1)):
            if kind == "int8":
                fn = runs(fn, n_runs)
            rates.setdefault(f"{kind} {name}", []).append(
                time_frames(fn, len(frames))[0])
    for key, r in rates.items():
        log(f"[int8] 9d {key}: {np.median(r):.1f} frames/s (runs "
            f"{', '.join(f'{v:.1f}' for v in r)}, engines in turns bf16, "
            f"int8, int8, bf16) | {card}")
    log(f"[int8] 9d FusedDetectPose(quantize='int8'): the detector "
        f"calibrated on 2 letterboxed frames ({INT8_SITES_YOLOV5N} int8 "
        f"sites, the detect heads in float), the pose net from 9b's table; "
        f"submit_frame ran under set_sync_debug_mode('error'); "
        f"{len(out['boxes'])} persons a frame")
    path.keep_layouts(q._pose.int8, q.det_int8)
    del engines
    torch.cuda.empty_cache()
    return {k: float(np.median(v)) for k, v in rates.items()}


def layout_tensor(shape, stride, dtype, misalign, scale, seed, device):
    """A seeded normal activation (times ``scale``) of ``shape`` in the
    element strides ``stride``, its base ``misalign`` bytes past a 16-byte
    boundary, with 16 bytes of the buffer on either side of its span."""
    span = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
    pad = 16 // dtype.itemsize
    g = torch.Generator(device=device).manual_seed(seed)
    buf = (torch.randn(span + 2 * pad, generator=g, device=device)
           * scale).to(dtype)
    return buf.as_strided(shape, stride, pad + misalign // dtype.itemsize)


def check_path_layouts(path, card, device="cuda"):
    """9g: the fused kernel at every input layout at which ``path``
    launched it (shape, strides, dtype, alignment and conv geometry, so
    every tiling and route the path ran at the shapes it ran them), with
    that site's weights on a seeded activation of that layout that spans
    the quantiser's range, against the three-step card path, bit for bit;
    and the route the path launched at each layout (its plan in
    ``launch_plans``) is the one ``fused_tiling`` picks, the Hopper engine
    at every site it routes there.  Returns the number of layouts."""
    from udp_pose_tpu_torch.ops import int8_conv as ic
    check(path.layouts, f"{path.name}: no fused int8 launch recorded")
    tilings = {}
    for i, (key, layer) in enumerate(sorted(path.layouts.items(),
                                            key=lambda kv: str(kv[0]))):
        shape, stride, dtype, aligned = key[:4]
        x = layout_tensor(shape, stride, dtype,
                          0 if aligned else dtype.itemsize,
                          64.0 / layer.inv_s_a, i, device)
        N, _, H, W = shape
        Ho, Wo = ic.conv_out_hw(H, W, layer.kernel_size, layer.stride,
                                layer.padding)
        M, O = N * Ho * Wo, layer.out_channels
        a = ic.quant_im2col(x, layer.inv_s_a, layer.kernel_size,
                            layer.stride, layer.padding, layer.k_pad)
        want = ic.dequant_epilogue(ic.int8_gemm(a, layer.w_gemm),
                                   layer.scale, layer.bias, dtype, M, O)
        got = ic.int8_conv_fused(x, layer).permute(0, 2, 3, 1).reshape(M, O)
        t = ic.fused_tiling(shape, O, layer.kernel_size, layer.stride,
                            layer.padding, ic._loads(x), dtype, card_sms())
        name = f"{t.route} {t.block_m}x{t.block_n}"
        tilings[name] = tilings.get(name, 0) + 1
        launched = {ic.ROUTES[plan[0].route]
                    for k, plan in layer.launch_plans.items()
                    if (k[0], k[1], k[2], k[4], k[-1])
                    == (shape, stride, dtype, aligned, None)}
        check(launched == {t.route}, f"9g {path.name}: routes {launched} "
              f"launched at x {shape} strides {stride} -> {O}, kernel "
              f"{layer.kernel_size}, where fused_tiling takes {t.route}")
        check(torch.equal(got, want), f"9g {path.name}: int8_conv_fused != "
              f"the three-step card path at x {shape} strides {stride} "
              f"{dtype} -> {O}, kernel {layer.kernel_size}, stride "
              f"{layer.stride} ({name})")
        del a, want, got, x
    torch.cuda.empty_cache()
    log(f"[int8] 9g {path.name}: int8_conv_fused bit-equal to the "
        f"three-step card path at all {len(path.layouts)} input layouts the "
        f"path launched it at (layouts by route and tiling: {tilings}) | "
        f"{card}")
    return len(path.layouts)


def int8_qat(card, cfg_fn=w32_cfg, device="cuda", batch=32):
    """9e: QAT (``TPU.QAT int8``) train steps at full width, bf16 autocast,
    on one seeded batch: samples/s and a finite, falling loss."""
    from udp_pose_tpu_torch.ops.targets import offset_targets_np
    cfg = cfg_fn("bfloat16")
    cfg.TPU.QAT = "int8"
    w, h = cfg.MODEL.IMAGE_SIZE
    rng = np.random.default_rng(93)
    tgts, wts = [], []
    for _ in range(batch):
        joints = np.concatenate([rng.uniform(0, w - 1, (17, 1)),
                                 rng.uniform(0, h - 1, (17, 1)),
                                 np.zeros((17, 1))], 1)
        t, wt = offset_targets_np(joints, np.ones((17, 3)),
                                  cfg.MODEL.HEATMAP_SIZE, cfg.MODEL.IMAGE_SIZE,
                                  cfg.LOSS.KPD)
        tgts.append(t)
        wts.append(wt)
    data = {"image": rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8),
            "target": np.stack(tgts), "target_weight": np.stack(wts)}
    repeated_batch_steps(cfg, data, card, n_steps=6, device=device,
                         label="9e QAT int8 (fake-quant convs)")


def int8_test_cli(tmp, card, device="cuda", pose_yaml=W32_YAML):
    """9f: ``python -m udp_pose_tpu_torch.test ... TPU.QUANTIZE int8`` on
    a synthetic COCO val set written to disk."""
    import cv2
    root = os.path.join(tmp, "coco_int8")
    frames = synthetic_coco(root, "val2017", 16, np.random.default_rng(94))
    os.makedirs(os.path.join(root, "images", "val2017"))
    for img_id, frame in frames.items():
        cv2.imwrite(os.path.join(root, "images", "val2017",
                                 "%012d.jpg" % img_id), frame)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "udp_pose_tpu_torch.test", "--cfg", pose_yaml,
         "--device", device, "DATASET.ROOT", root, "OUTPUT_DIR",
         os.path.join(tmp, "out_int8"), "LOG_DIR", os.path.join(tmp, "log"),
         "TEST.USE_GT_BBOX", "True", "TPU.QUANTIZE", "int8"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    text = proc.stdout + proc.stderr
    check(proc.returncode == 0, f"test CLI with TPU.QUANTIZE int8 exited "
          f"{proc.returncode}: {text[-1500:]}")
    want = f"int8 PTQ: calibrated {INT8_SITES_W32} conv sites"
    check(want in text, f"the test CLI log lacks {want!r}")
    log(f"[int8] 9f python -m udp_pose_tpu_torch.test TPU.QUANTIZE int8 on "
        f"{2 * len(frames)} synthetic crops: exit 0, '{want}', in "
        f"{time.perf_counter() - t0:.1f} s | {card}")


def phase_int8(tmp, cfg_fn=w32_cfg, pose_yaml=W32_YAML, device="cuda",
               det_hw=(384, 640), frame_hw=DETECT_HW, det_size=DET_SIZE):
    """Phase 9, int8 PTQ serving and QAT at full width.  Returns (the
    launches of each kernel on the two int8 paths, the new kernels' entries
    of the kernels line, crops/s and frames/s)."""
    card = card_line()
    t_phase = time.perf_counter()
    kernels = check_int8_kernels(card, cfg_fn, device, det_hw=det_hw)
    torch.backends.cuda.matmul.allow_tf32 = False
    serving = PathLaunches("int8_serving")
    detect = PathLaunches("int8_detect_then_pose")
    table, crops_s = int8_serving(serving, card, cfg_fn, device)
    int8_http(serving, card, cfg_fn, device, frame_hw)
    frames_s = int8_detect(table, detect, card, cfg_fn, device, frame_hw,
                           det_size)
    for path in (serving, detect):
        path.check(engine=True)
    paths = {path.name: path.counts for path in (serving, detect)}
    int8_qat(card, cfg_fn, device)
    int8_test_cli(tmp, card, device, pose_yaml)
    kernels["int8_conv_fused"]["layouts_checked_by_path"] = {
        path.name: check_path_layouts(path, card, device)
        for path in (serving, detect)}
    log(f"[int8] phase 9 {time.perf_counter() - t_phase:.1f} s; launches "
        f"{paths}")
    return paths, kernels, crops_s, frames_s


# --------------------------------------------------------------- phase 10
RESNET50_YAML = os.path.join(REPO,
                             "configs/coco/resnet50_256x192_gaussian.yaml")
PSA_YAML = os.path.join(REPO,
                        "configs/coco/hrnet_w32_256x192_udpv1_aid_psa.yaml")
MPII_YAML = os.path.join(REPO, "configs/mpii/hrnet_w32_256x256_udp.yaml")
INT8_SITES_RESNET50 = 53         # pose_resnet50's 54 convs less final_layer
MPII_TRAIN, MPII_VAL = 64, 32    # synthetic MPII records (one each a frame)
MPII_JOINTS = ["rank", "rkne", "rhip", "lhip", "lkne", "lank", "pelvis",
               "thorax", "upperneck", "head", "rwri", "relb", "rsho",
               "lsho", "lelb", "lwri"]


def yaml_cfg(path, dtype):
    from udp_pose_tpu_torch.config import load_config
    cfg = load_config(path)
    cfg.TPU.DTYPE = dtype
    return cfg


def decisive_maps(hm, tol):
    """(B, J) mask of the heatmaps whose decode no difference of ``tol``
    in the values can change: the top two values apart by more than
    ``tol``, and at the peak the differences of the two horizontal and of
    the two vertical neighbours (the quarter-pixel shift's signs) larger
    than ``tol`` where those neighbours exist.  Seeded random nets give
    flat maps whose near ties decide a keypoint by the last bits."""
    B, J, H, W = hm.shape
    flat = hm.flatten(2)
    top2 = flat.topk(2, dim=2).values
    idx = flat.argmax(2)
    py, px = idx // W, idx % W
    pad = torch.nn.functional.pad(hm, (1, 1, 1, 1))
    b, j = torch.meshgrid(torch.arange(B), torch.arange(J), indexing="ij")
    dx = pad[b, j, py + 1, px + 2] - pad[b, j, py + 1, px]
    dy = pad[b, j, py + 2, px + 1] - pad[b, j, py, px + 1]
    inner_x = (px > 0) & (px < W - 1)
    inner_y = (py > 0) & (py < H - 1)
    return ((top2[..., 0] - top2[..., 1] > tol)
            & (~inner_x | (dx.abs() > tol)) & (~inner_y | (dy.abs() > tol)))


def float_path(name, cfg, card, device="cuda", batch=SERVE_BATCH, iters=10,
               tag="[zoo] 10", kp_atol=None):
    """10a / 10b (and 12a, ``tag``): the yaml's serving graph (its own
    flip test and decode) at full width with seeded random weights.  fp32
    with TF32 off, card heatmaps against the CPU's on 4 crops (and, where
    ``kp_atol`` is given, the peak keypoints within ``kp_atol`` px on the
    maps that no near tie decides, at least half of them; the DARK
    keypoints are reported); then bf16 crops/s at B =
    ``batch`` from host u8 crops, each batch in a window of the path's
    launches, which must be one fused decode a batch for the offset
    head and none for the Gaussian one.  Returns (crops/s, launches, a
    function that profiles those batches, to be called after 3b's
    profiler session)."""
    from udp_pose_tpu_torch.core.infer import make_infer_fn_from_cfg
    from udp_pose_tpu_torch.models import build_model

    def serving(c, dev):
        return make_infer_fn_from_cfg(build_model(c, device=dev, seed=0), c)

    set_tf32(False)
    cfg32 = cfg.clone()
    cfg32.TPU.DTYPE = "float32"
    crops, center, scale = random_crops(4, cfg32, seed=5)
    out = {dev: [t.float().cpu() for t in serving(cfg32, dev)(
        crops, center, scale)] for dev in (device, "cpu")}
    hm = {dev: o[2] for dev, o in out.items()}
    ref_max = float(hm["cpu"].abs().max())
    err = float((hm[device] - hm["cpu"]).abs().max())
    kp_err = float((out[device][0] - out["cpu"][0]).abs().max())
    log(f"{tag} {name} fp32 B=4 heatmaps {tuple(hm['cpu'].shape)}: card "
        f"vs CPU max abs err {err:.3g}, max |hm| {ref_max:.3g} (limit "
        f"{HEATMAP_REL_TOL:g} x max |hm|); keypoints max abs err "
        f"{kp_err:.3g} px")
    check(err <= HEATMAP_REL_TOL * ref_max,
          f"{name}: card heatmaps != CPU heatmaps")
    if kp_atol is not None:
        # the peaks of both devices' maps, in source space: DARK's Taylor
        # step (the keypoints above) divides by the curvature of the log of
        # the blurred map, which on a seeded net's flat maps turns the
        # last bits into tenths of a pixel
        from udp_pose_tpu_torch.ops.decode import get_final_preds
        peaks = {dev: get_final_preds(
            h, torch.from_numpy(center), torch.from_numpy(scale),
            cfg32.MODEL.TARGET_TYPE, False, cfg32.LOSS.KPD)[0].cpu()
            for dev, h in hm.items()}
        clear = decisive_maps(hm["cpu"], 2 * HEATMAP_REL_TOL * ref_max)
        peak_err = float((peaks[device] - peaks["cpu"]).abs()[clear].max()) \
            if bool(clear.any()) else 0.0
        log(f"{tag} {name} peak keypoints (no DARK) card vs CPU: max abs "
            f"err {peak_err:.3g} px on the {int(clear.sum())} of "
            f"{clear.numel()} maps whose top two values and the neighbours "
            f"at the peak no rounding within the limit can reorder (limit "
            f"{kp_atol:g})")
        check(clear.float().mean() >= 0.5 and peak_err <= kp_atol,
              f"{name}: card peaks != CPU peaks")
    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    infer = serving(cfg, device)
    crops, center, scale = random_crops(batch, cfg, seed=6)
    path = PathLaunches(name)
    ms = [path.run(host_ms, lambda: infer(crops, center, scale), iters)
          for _ in range(3)]
    decodes = 3 * (iters + 1) if cfg.MODEL.TARGET_TYPE == "offset" else 0
    path.served(decodes, 0)
    check(path.counts == path.want, f"{name}: launches {path.counts}, but "
          f"its batches should have launched {path.want}")
    preds = infer(crops, center, scale)[0]
    check(bool(torch.isfinite(preds).all()), f"{name}: non-finite preds")
    rate = batch / np.median(ms) * 1e3
    flip = (f"flip {cfg.TEST.get('FLIP_MODE', 'fold')}"
            if cfg.TEST.FLIP_TEST else "no flip")
    log(f"{tag} {name} {cfg.MODEL.NAME} {cfg.MODEL.IMAGE_SIZE[1]}x"
        f"{cfg.MODEL.IMAGE_SIZE[0]} {cfg.MODEL.TARGET_TYPE} bf16 B={batch} "
        f"{flip}: {rate:.1f} crops/s (median of 3 runs of {iters} batches: "
        f"{', '.join(f'{m:.2f}' for m in ms)} ms/batch); fused decode "
        f"launches {path.counts['udp_offset_decode_fused']} for "
        f"{3 * (iters + 1)} batches | {card}")

    def profile():
        """Where a bf16 batch's time goes: card busy and idle share,
        device kernels a batch, the top kernels (profiler)."""
        wall, busy, top, kernels = profile_device(
            lambda: infer(crops, center, scale))
        if busy > 0:
            log(f"{tag} {name} profile: 3 batches {wall:.2f} ms wall, "
                f"card busy {busy:.2f} ms (idle share {1 - busy / wall:.3f})"
                f", {kernels:.0f} device kernels and copies a batch; top "
                f"kernels (ms): " + "; ".join(f"{k[:60]} {t:.2f}"
                                              for k, t in top)
                + f" | {card}")
        else:
            log(f"{tag} {name} profile: the profiler saw no device "
                "time; idle share not measured")

    return rate, path.counts, profile


def int8_resnet(card, device="cuda", batch=SERVE_BATCH, iters=10):
    """10c: int8 ``pose_resnet50`` at full width.  The pipeline calibrates
    itself on two batches of B = ``batch`` and serves w8a8 (the deconv
    head and ``final_layer`` stay bf16): int8 and bf16 crops/s in turns,
    one fused int8 conv launch a site and batch, bit-equality to the
    three-step card path at every input layout it ran (9g), and the
    kernel's time over one forward's shapes against its bound and the
    bf16 cuDNN convs (9a).  Returns (launches, the kernel's numbers for
    one forward, crops/s)."""
    from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
    from udp_pose_tpu_torch.models import build_model
    cfg = yaml_cfg(RESNET50_YAML, "bfloat16")
    path = PathLaunches("int8_pose_resnet50")
    q = UdpPosePipeline(cfg, device=device, seed=0, quantize="int8",
                        calib_batches=2)
    bf16 = UdpPosePipeline(cfg, device=device, seed=0)

    def served(*args):
        def call():
            sites = 0 if q.int8.calibrating else INT8_SITES_RESNET50
            out = q.infer_crops(*args)
            path.served(0, sites)
            return out
        return call

    for seed in (10, 11):
        path.run(served(*random_crops(batch, cfg, seed)))
    table = q.int8.table
    check(table is not None and len(table) == INT8_SITES_RESNET50 + 1,
          f"pose_resnet50 self-calibration: table of "
          f"{0 if table is None else len(table)}")
    crops, center, scale = random_crops(batch, cfg, seed=9)
    rates = {"bf16": [], "int8": []}
    for kind in ("bf16", "int8", "int8", "bf16"):
        if kind == "int8":
            ms = [path.run(host_ms, served(crops, center, scale), iters)
                  for _ in range(3)]
        else:
            ms = [host_ms(lambda: bf16.infer_crops(crops, center, scale),
                          iters) for _ in range(3)]
        rates[kind].append(batch / np.median(ms) * 1e3)
    check(len(q.int8.qmodel.engaged) == INT8_SITES_RESNET50,
          f"pose_resnet50: {len(q.int8.qmodel.engaged)} engaged sites")
    kp_q = path.run(served(crops, center, scale))[0]
    kp_b = bf16.infer_crops(crops, center, scale)[0]
    path.check(engine=True)
    log(f"[zoo] 10c int8 pose_resnet50 256x192 B={batch} (no flip): "
        f"self-calibrated ({len(table)} sites in the table, "
        f"{INT8_SITES_RESNET50} engaged: final_layer and the 3 transposed "
        f"convs stay bf16); crops/s int8 "
        f"{', '.join(f'{r:.1f}' for r in rates['int8'])} against bf16 "
        f"{', '.join(f'{r:.1f}' for r in rates['bf16'])} (in turns bf16, "
        f"int8, int8, bf16, each the median of 3 x {iters} batches); int8 "
        f"vs bf16 keypoints (random weights: a number only) median "
        f"{np.median(np.abs(kp_q - kp_b)):.3g} px; launches "
        f"{path.counts} | {card}")
    path.keep_layouts(q.int8)
    del q, bf16
    torch.cuda.empty_cache()
    layouts = check_path_layouts(path, card, device)
    w, h = cfg.MODEL.IMAGE_SIZE
    sites = int8_sites(build_model(cfg, device=device),
                       torch.zeros(1, 3, h, w, dtype=torch.bfloat16,
                                   device=device), strides=True)
    check(len(sites) == INT8_SITES_RESNET50,
          f"pose_resnet50: {len(sites)} int8 sites")
    sums, errs, n_shapes = int8_forward_times("pose_resnet50", sites, batch,
                                              card, device)
    kernel = {"ms": sums["int8_conv_fused"],
              "pr6_design_ms": sums["pr6_design"],
              "by_route": sums["by_route"],
              "bound_ms": sums["bound_int8_conv_fused"],
              "bound_by": ("bytes" if sums["bound_by_bytes"]
                           >= sums["bound_by_ops"] else "operations"),
              "plain_ms": sums["plain_int8_conv_fused"],
              "cudnn_bf16_conv_ms": sums["cudnn_bf16"],
              "three_step_ms": sums["three_step"],
              "max_abs_err": errs["int8_conv_fused"], "shapes": n_shapes,
              "layouts_checked": layouts,
              "per": f"one pose_resnet50 forward, B={batch}, "
                     f"{INT8_SITES_RESNET50} launches"}
    return path.counts, kernel, {k: float(np.median(v))
                                 for k, v in rates.items()}


def synthetic_mpii(root, rng):
    """An MPII annotation set of ``MPII_TRAIN`` and ``MPII_VAL`` records
    (``annot/{train,valid}.json``, 1-based, 16 joints, a few invisible)
    with its PCKh ground truth ``annot/gt_valid.mat`` (written with
    ``scipy.io.savemat``), one seeded 640x480 frame a record, held in
    memory: {image name: (H, W, 3) u8}."""
    from scipy.io import savemat
    os.makedirs(os.path.join(root, "annot"), exist_ok=True)
    W, H = FRAME_WH
    frames = {}
    for image_set, n in (("train", MPII_TRAIN), ("valid", MPII_VAL)):
        anno = []
        gt = np.zeros((16, 2, n)), np.zeros((16, n)), np.zeros((2, 2, n))
        for i in range(n):
            name = f"{image_set}{i:04d}.jpg"
            frames[name] = rng.integers(0, 255, (H, W, 3), np.uint8)
            c = rng.uniform([W * 0.35, H * 0.4], [W * 0.65, H * 0.6])
            s = rng.uniform(1.0, 1.4)
            joints = c + rng.uniform(-70, 70, (16, 2)) * s
            vis = (rng.random(16) > 0.1).astype(int)
            anno.append({"image": name, "center": (c + 1).tolist(),
                         "scale": float(s), "joints": (joints + 1).tolist(),
                         "joints_vis": vis.tolist()})
            gt[0][:, :, i] = joints + 1
            gt[1][:, i] = 1 - vis
            gt[2][:, :, i] = [joints[9] - [20, 25] + 1,
                              joints[9] + [20, 5] + 1]
        with open(os.path.join(root, "annot", f"{image_set}.json"),
                  "w") as f:
            json.dump(anno, f)
    savemat(os.path.join(root, "annot", "gt_valid.mat"), {
        "dataset_joints": np.array([MPII_JOINTS], dtype=object),
        "jnt_missing": gt[1], "pos_gt_src": gt[0], "headboxes_src": gt[2]})
    return frames


def in_memory_mpii(cfg, frames, is_train):
    """The package's ``MPIIDataset`` with the seams of
    :func:`in_memory_coco`: images from ``frames``, crops from the native
    warp.  (The training input forks its workers, which inherit it.)"""
    from udp_pose_tpu_torch.data.mpii import MPIIDataset
    from udp_pose_tpu_torch.native import warp_affine_batch

    class InMemoryMPII(MPIIDataset):
        def _read_image(self, path):
            return frames[os.path.basename(path)]

        def _warp(self, img, trans):
            w, h = (int(v) for v in self.image_size)
            crop = warp_affine_batch(img, trans[None], (h, w))[0]
            return np.clip(np.rint(crop), 0, 255).astype(np.uint8)

    image_set = cfg.DATASET.TRAIN_SET if is_train else cfg.DATASET.TEST_SET
    return InMemoryMPII(cfg, cfg.DATASET.ROOT, image_set, is_train)


def decode_64x64(card, device="cuda", batch=SERVE_BATCH):
    """10d: the fused decode at MPII's (B, 48, 64, 64) maps (the
    run-time-shape copy of the kernel) against its plain version, bit for
    bit, in both layouts, and its time against its bound."""
    from udp_pose_tpu_torch.ops import peak_offset as po
    hw, J = (64, 64), 16
    sets = [decode_inputs(seed, device, batch=batch, hw=hw, J=J)
            for seed in (20, 21, 22)]
    out = {}
    for layout in LAYOUTS:
        worst = 0.0
        for s in sets:
            got = po.udp_offset_decode_fused(s[layout], KPD)
            want = po.udp_offset_decode_reference(s[layout], KPD)
            check(same_bits(got, want), f"fused decode != plain version at "
                  f"(B={batch}, {3 * J}, 64, 64) {layout}")
            worst = max(worst, float((got - want).nan_to_num(0.0).abs()
                                     .max()))
        args = [(s[layout], KPD) for s in sets]
        ms = graph_ms(po.udp_offset_decode_fused, args)
        plain_ms = cuda_ms(po.udp_offset_decode_reference, args, iters=5,
                           repeats=3)
        bytes_moved, ops = fused_bound(layout, batch=batch, J=J, hw=hw)
        bound_ms, bound_by = bound_of(bytes_moved, ops)
        log(f"[zoo] 10d udp_offset_decode_fused B={batch} C={3 * J} 64x64 "
            f"{layout}: bit-equal to the plain version on the map families; "
            f"kernel {ms * 1e3:.2f} us (graph replay), plain "
            f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
            f"({bound_by}: {bytes_moved / 1e6:.1f} MB, {ops / 1e6:.1f} M "
            f"fp32 operations) | {card}")
        out[layout] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "max_abs_err": worst}
    return out


def mpii_path(tmp, card, device="cuda"):
    """10d: ``configs/mpii/hrnet_w32_256x256_udp.yaml`` at full width
    (bf16) on a seeded synthetic MPII in memory: one epoch of
    ``train.run`` at B=32 with the yaml's default WORKERS 4 and the
    prefetch, validated through the fused decode with its PCKh; then one
    ``/v1/pose`` request to a server on the weights it wrote: 16 joints.
    Returns the launches of the two paths."""
    from udp_pose_tpu_torch import train as train_cli
    from udp_pose_tpu_torch.engine.server import PoseServer, PoseService
    from udp_pose_tpu_torch.models import build_model
    root = os.path.join(tmp, "mpii")
    frames = synthetic_mpii(root, np.random.default_rng(70))
    cfg = yaml_cfg(MPII_YAML, "bfloat16")
    cfg.DATASET.ROOT = root
    cfg.OUTPUT_DIR = os.path.join(tmp, "mpii_run")
    cfg.TRAIN.END_EPOCH = 1
    os.makedirs(cfg.OUTPUT_DIR)
    check(cfg.WORKERS == 4 and cfg.TRAIN.BATCH_SIZE_PER_GPU == 32,
          f"WORKERS {cfg.WORKERS}, B {cfg.TRAIN.BATCH_SIZE_PER_GPU}")
    train_ds = in_memory_mpii(cfg, frames, True)
    val_ds = in_memory_mpii(cfg, frames, False)
    check(len(train_ds) == MPII_TRAIN and len(val_ds) == MPII_VAL
          and train_ds.num_joints == 16, "MPII db sizes")
    training = PathLaunches("mpii_training")
    t0 = time.perf_counter()
    record = training.run(train_cli.run, cfg,
                          build_model(cfg, device=device, train=True),
                          train_ds, val_ds, cfg.OUTPUT_DIR, device)
    secs = time.perf_counter() - t0
    val_batches = -(-MPII_VAL // cfg.TEST.BATCH_SIZE_PER_GPU)
    training.served(val_batches, 0)
    check(training.counts == training.want, f"mpii_training: launches "
          f"{training.counts}, want {training.want}")
    losses = [s["loss"] for s in record["steps"]]
    check(len(losses) == MPII_TRAIN // 32 and all(np.isfinite(losses)),
          f"MPII losses {losses}")
    nv = record["name_values"]
    check(list(nv)[:2] == ["Head", "Shoulder"] and np.isfinite(nv["Mean"]),
          f"MPII name_values {nv}")
    log(f"[zoo] 10d MPII hrnet_w32 256x256 UDP bf16: train.run one epoch "
        f"of {MPII_TRAIN} records at B=32 through WORKERS {cfg.WORKERS} "
        f"and the prefetch, losses {', '.join(f'{v:.5g}' for v in losses)}; "
        f"validation of {MPII_VAL} crops (flip, {val_batches} fused decode "
        f"launch(es)): PCKh " + ", ".join(f"{k} {v:.2f}" for k, v in
                                          nv.items())
        + f" (random weights); {secs:.1f} s | {card}")
    serving = PathLaunches("mpii_serving")
    service = PoseService(cfg, weights=os.path.join(cfg.OUTPUT_DIR,
                                                    "final_state.pth"),
                          device=device, window_ms=1.0)
    check(service.pipe.skeleton is not None and len(service.pipe.skeleton)
          == 15, "the MPII skeleton")
    server = PoseServer(service, host="127.0.0.1", port=0)
    thread = server.serve_in_thread()
    try:
        frame, boxes = requests_for(1, (480, 640), seed=71)[0]
        status, body, secs = serving.run(post_pose, server.port, frame,
                                         boxes)
    finally:
        server.shutdown()
        thread.join(timeout=30)
    kp = np.asarray(body.get("keypoints", []), np.float32)
    check(status == 200 and kp.shape == (len(boxes), 16, 2)
          and np.isfinite(kp).all(), f"MPII /v1/pose: {status} {kp.shape}")
    serving.served(1, 0)
    check(serving.counts == serving.want, f"mpii_serving: launches "
          f"{serving.counts}, want {serving.want}")
    log(f"[zoo] 10d MPII /v1/pose on final_state.pth: 200, {len(boxes)} "
        f"persons x 16 joints in {secs * 1e3:.1f} ms, one fused decode "
        f"launch | {card}")
    return {"mpii_training": training.counts,
            "mpii_serving": serving.counts}


def phase_zoo(tmp, device="cuda"):
    """Phase 10: SimpleBaseline, PSA HRNet, int8 pose_resnet50 and MPII at
    full width.  Returns (launches by path, the 64x64 decode's numbers,
    the int8 pose_resnet50 kernel's, crops/s, the functions that profile
    the two float paths' batches)."""
    card = card_line()
    t_phase = time.perf_counter()
    paths, rates, profiles = {}, {}, []
    for name, path in (("pose_resnet50_serving", RESNET50_YAML),
                       ("psa_hrnet_serving", PSA_YAML)):
        rates[name], paths[name], profile = float_path(
            name, yaml_cfg(path, "bfloat16"), card, device)
        profiles.append(profile)
    paths["int8_pose_resnet50"], int8_kernel, int8_rates = int8_resnet(
        card, device)
    rates.update({f"pose_resnet50_{k}": v for k, v in int8_rates.items()})
    paths.update(mpii_path(tmp, card, device))
    decode = decode_64x64(card, device)
    log(f"[zoo] phase 10 {time.perf_counter() - t_phase:.1f} s; launches "
        f"{paths}")
    return paths, decode, int8_kernel, rates, profiles


# --------------------------------------------------------------- phase 11
RSN18_YAML = os.path.join(REPO, "configs/coco/rsn18_256x192.yaml")
RSN4X18_YAML = os.path.join(REPO, "configs/coco/4xrsn18_256x192.yaml")
RSN4X50_YAML = os.path.join(REPO, "configs/coco/4xrsn50_384x288.yaml")
INT8_SITES_RSN18 = 111           # rsn18's 115 convs less the 4 res_conv2
RSN_KP_ATOL = 1e-3               # px: fp32 card vs CPU keypoints (11a)
RSN_TRAIN_IMAGES, RSN_VAL_IMAGES = 400, 16   # synthetic frames, 2 people
RSN_EVAL_IMAGES = 160            # 11b: 320 crops, 10 batches of 32
RSN_BIAS_TOL = 1e-6              # x the conv weight's max |g| (11c)
RSN_GRAD_TOL64 = 1e-7            # x each gradient's max |g|: 2-stage step
RSN_LOSS_RTOL64 = 1e-6           # 4xrsn18 float64 loss, card vs CPU (11c)
RSN_STAGE0_RTOL64 = 1e-9         # its first stage's outputs, float64


def in_memory_rsn(cfg, frames, is_train):
    from udp_pose_tpu_torch.data.rsn import RSNCOCODataset
    return in_memory_coco(cfg, frames, is_train, RSNCOCODataset)


def rsn_data_cfg(path, dtype, root, out_dir):
    """``path``'s config on the synthetic mini-COCO at ``root`` (its gt
    boxes at test time), writing under ``out_dir``."""
    cfg = yaml_cfg(path, dtype)
    cfg.DATASET.ROOT = root
    cfg.TEST.USE_GT_BBOX = True
    cfg.OUTPUT_DIR = out_dir
    os.makedirs(out_dir, exist_ok=True)
    return cfg


def rsn_serving_fn(cfg, device, seed=0):
    from udp_pose_tpu_torch.core.infer import COCO_FLIP_PAIRS
    from udp_pose_tpu_torch.core.rsn import make_rsn_infer_fn_from_cfg
    from udp_pose_tpu_torch.models import build_model
    return make_rsn_infer_fn_from_cfg(
        build_model(cfg, device=device, seed=seed), cfg, COCO_FLIP_PAIRS)


def rsn_card_vs_cpu(cfg, n, seed, device="cuda"):
    """fp32, TF32 off: the serving graph of ``cfg`` on ``n`` crops on the
    card and on the CPU; (max |hm| difference, max |hm|, max keypoint
    difference in px)."""
    set_tf32(False)
    cfg32 = cfg.clone()
    cfg32.TPU.DTYPE = "float32"
    crops, center, scale = random_crops(n, cfg32, seed=seed)
    out = {dev: [t.float().cpu() for t in rsn_serving_fn(cfg32, dev)(
        crops, center, scale)] for dev in (device, "cpu")}
    set_tf32(True)
    (p_d, _, hm_d), (p_c, _, hm_c) = out[device], out["cpu"]
    return (float((hm_d - hm_c).abs().max()), float(hm_c.abs().max()),
            float((p_d - p_c).abs().max()))


def rsn_serving(card, device="cuda", yaml=RSN18_YAML, batch=SERVE_BATCH,
                iters=10, n_check=8):
    """11a: ``rsn18_256x192`` uncut, bf16, B = ``batch``, the yaml's flip
    test folded into one forward (``make_rsn_infer_fn``, the protocol of
    ``bench.py``'s ``crops_per_sec_rsn18_256x192``): fp32 card vs CPU on
    ``n_check`` crops (heatmaps and keypoints), then crops/s, each batch
    in a window of the path's launches, which must hold no fused decode.
    Returns (crops/s, launches, a function that profiles the batches)."""
    cfg = yaml_cfg(yaml, "bfloat16")
    err, ref_max, kp_err = rsn_card_vs_cpu(cfg, n_check, 30, device)
    log(f"[rsn] 11a rsn18 fp32 B={n_check} flip, TF32 off, card vs CPU: "
        f"heatmaps max abs err {err:.3g} of max |hm| {ref_max:.3g} (limit "
        f"{HEATMAP_REL_TOL:g} x max); keypoints max abs err {kp_err:.3g} px "
        f"(limit {RSN_KP_ATOL:g})")
    check(err <= HEATMAP_REL_TOL * ref_max, "11a: card heatmaps != CPU")
    check(kp_err <= RSN_KP_ATOL, "11a: card keypoints != CPU keypoints")
    torch.backends.cuda.matmul.allow_tf32 = False
    infer = rsn_serving_fn(cfg, device)
    crops, center, scale = random_crops(batch, cfg, seed=31)
    path = PathLaunches("rsn18_serving")
    ms = [path.run(host_ms, lambda: infer(crops, center, scale), iters)
          for _ in range(3)]
    check(path.counts == path.want, f"rsn18_serving: launches "
          f"{path.counts}: RSN decodes without the fused kernel")
    preds = infer(crops, center, scale)[0]
    check(bool(torch.isfinite(preds).all()), "rsn18: non-finite preds")
    rate = batch / np.median(ms) * 1e3
    log(f"[rsn] 11a rsn18 256x192 bf16 B={batch} flip fold (blur k=5, "
        f"shift 0.25): {rate:.1f} crops/s (median of 3 runs of {iters} "
        f"batches: {', '.join(f'{m:.2f}' for m in ms)} ms/batch); launches "
        f"{path.counts} (no fused decode on the RSN path) | {card}")

    def profile():
        wall, busy, top, kernels = profile_device(
            lambda: infer(crops, center, scale))
        if busy > 0:
            log(f"[rsn] 11a rsn18 profile: 3 batches {wall:.2f} ms wall, "
                f"card busy {busy:.2f} ms (idle share {1 - busy / wall:.3f})"
                f", {kernels:.0f} device kernels and copies a batch; top "
                f"kernels (ms): " + "; ".join(f"{k[:60]} {t:.2f}"
                                              for k, t in top)
                + f" | {card}")
        else:
            log("[rsn] 11a rsn18 profile: the profiler saw no device time; "
                "idle share not measured")

    return rate, path.counts, profile


def logged_rates(fn, *args):
    """``fn(*args)`` and, for each validation it ran, the numbers
    :func:`udp_pose_tpu_torch.core.validate.validate` logs: {"crops",
    "crops_s" (the whole loop), "warm_crops_s" (after its first batch),
    "build_share" (of that time, the share spent building samples on the
    host)}."""
    import logging
    import re
    rates = []
    pattern = re.compile(
        r"validate: (\d+) crops, ([\d.]+) crops/s; after the first batch "
        r"([\d.na]+) crops/s, ([\d.na]+) of it building samples")

    class Grab(logging.Handler):
        def emit(self, record):
            m = pattern.match(record.getMessage())
            if m:
                rates.append(dict(zip(
                    ("crops", "crops_s", "warm_crops_s", "build_share"),
                    (float(v) for v in m.groups()))))

    lg = logging.getLogger("udp_pose_tpu_torch.core.validate")
    grab, level = Grab(), lg.level
    lg.addHandler(grab)
    lg.setLevel(logging.INFO)
    try:
        return fn(*args), rates
    finally:
        lg.removeHandler(grab)
        lg.setLevel(level)


def rsn_best_model(tmp, card, device="cuda", yaml=RSN4X50_YAML,
                   n_images=RSN_EVAL_IMAGES, n_check=2):
    """11b: ``4xrsn50_384x288`` at full width (4 stages) through
    ``test.run`` on a seeded synthetic mini-COCO val in memory (``2 x
    n_images`` crops, 10 batches), with the yaml's flip and B=32, in bf16
    (seeded random weights): crops/s of the validation after its first
    batch and the share of that time spent building samples on the host,
    no fused decode; then the fp32 card-vs-CPU heatmap difference on
    ``n_check`` crops.  Returns (the launches, the warm crops/s)."""
    from udp_pose_tpu_torch import test as test_cli
    from udp_pose_tpu_torch.models import MODELS
    root = os.path.join(tmp, "coco_rsn_best")
    frames = synthetic_coco(root, "val2017", n_images,
                            np.random.default_rng(32))
    cfg = rsn_data_cfg(yaml, "bfloat16", root, os.path.join(tmp, "best"))
    check(cfg.MODEL.EXTRA.STAGE_NUM == 4 and cfg.TEST.FLIP_TEST
          and cfg.TEST.BATCH_SIZE_PER_GPU == 32, "4xrsn50 yaml")
    with torch.device("meta"):
        n_params = sum(p.numel() for p in MODELS["rsn"](cfg).parameters())
    val_ds = in_memory_rsn(cfg, frames, False)
    path = PathLaunches("rsn_4x50_eval")
    t0 = time.perf_counter()
    (nv, perf), rates = logged_rates(path.run, test_cli.run, cfg, None,
                                     val_ds, cfg.OUTPUT_DIR, device)
    secs = time.perf_counter() - t0
    check(path.counts == path.want, f"rsn_4x50_eval: launches "
          f"{path.counts}")
    batches = -(-len(val_ds) // cfg.TEST.BATCH_SIZE_PER_GPU)
    check(len(rates) == 1 and batches >= 10 and np.isfinite(nv["AP"])
          and np.isfinite(rates[0]["warm_crops_s"]), f"4xrsn50 test.run "
          f"on {len(val_ds)} crops: {nv}, rates {rates}")
    v = rates[0]
    err, ref_max, kp_err = rsn_card_vs_cpu(cfg, n_check, 33, device)
    check(err <= HEATMAP_REL_TOL * ref_max, "11b: card heatmaps != CPU")
    log(f"[rsn] 11b 4xrsn50 384x288 (4 stages, {n_params / 1e6:.1f} M "
        f"parameters) bf16 test.run on {len(val_ds)} synthetic crops in "
        f"{batches} batches, flip fold, B=32: validation "
        f"{v['warm_crops_s']:.1f} crops/s after the first batch, of which "
        f"{v['build_share']:.3f} of the time building samples on the host "
        f"(the whole loop, first batch included, {v['crops_s']:.1f}), AP "
        f"{perf:.4f} (random weights), test.run {secs:.1f} s with the "
        f"model's build; launches {path.counts}; fp32 B={n_check} flip, "
        f"TF32 off, card vs CPU: heatmaps max abs err {err:.3g} of max "
        f"|hm| {ref_max:.3g} (limit {HEATMAP_REL_TOL:g} x max), keypoints "
        f"{kp_err:.3g} px | {card}")
    return path.counts, v["warm_crops_s"]


def rsn_step_on(cfg, device, batch, seed=0):
    """One float64 RSN train step of a model seeded ``seed`` on
    ``device``: (loss, {name: gradient}, {name: running stat}) on the
    CPU."""
    from udp_pose_tpu_torch.core.infer import (RSN_BGR_MEAN, RSN_BGR_STD,
                                               normalize_images)
    from udp_pose_tpu_torch.core.rsn import (create_rsn_train_state,
                                             make_rsn_train_step)
    from udp_pose_tpu_torch.models import build_model
    model = build_model(cfg, device=device, seed=seed,
                        train=True).double()
    state = create_rsn_train_state(cfg, model, cfg.TRAIN.LR, 10, 2)
    images = normalize_images(torch.as_tensor(batch["image"]), RSN_BGR_MEAN,
                              RSN_BGR_STD).double()
    metrics = make_rsn_train_step(
        cfg.MODEL.EXTRA.STAGE_NUM, ohkm=cfg.LOSS.USE_OHKM,
        topk=cfg.LOSS.TOPK)(state, {
            "image": images.to(device),
            "labels": torch.as_tensor(batch["labels"]).to(device,
                                                          torch.float64),
            "valid": torch.as_tensor(batch["valid"]).to(device,
                                                        torch.float64)})
    grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
    stats = {k: v.cpu() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return float(metrics["loss"]), grads, stats


def rsn_step_errors(got, want):
    """A float64 step (:func:`rsn_step_on`) against another: (loss rel
    error, worst BN running stat x its max, {name: gradient error x its
    max |g|}, the conv biases' gradients x their weight's max |g| in
    ``got`` and in ``want``).  A conv bias that feeds a train-mode
    BatchNorm has no gradient (the BN takes the mean out): its values are
    rounding noise on either side, so it is apart."""
    (loss_d, g_d, bn_d), (loss_c, g_c, bn_c) = got, want
    biases = [k for k in g_c if k.endswith("conv.bias")]

    def bias_share(grads):
        return max(float(grads[k].abs().max()
                         / g_c[k[:-4] + "weight"].abs().max())
                   for k in biases)

    grads = rel_errors({k: g_d[k] for k in g_c if k not in biases},
                       {k: v for k, v in g_c.items() if k not in biases})
    return (abs(loss_d - loss_c) / abs(loss_c),
            max(rel_errors(bn_d, bn_c).values()), grads,
            bias_share(g_d), bias_share(g_c))


def rsn_check_step(cfg, train_ds, card, device="cuda", stages=2):
    """11c: one float64 train step of ``cfg``'s RSN cut to its first
    ``stages`` stages, B=2, TF32 off, on the card and on the CPU from the
    same seeded weights and batch, as phase 7's (a): the loss to
    ``RSN_LOSS_RTOL64``, the BN running stats to ``STEP_BN_TOL`` and each
    gradient tensor to ``RSN_GRAD_TOL64`` x its max |g|, so the gradient
    that flows back from one stage into the one before, the intermediate
    losses divided by 4 and the last stage's coarse-to-fine labels are
    held on the card; conv biases before a BN to ``RSN_BIAS_TOL``."""
    from udp_pose_tpu_torch.data.base import collate
    cfg = cfg.clone()
    cfg.MODEL.EXTRA.STAGE_NUM = stages
    set_tf32(False)
    train_ds.seed(0)
    batch = collate([train_ds[0], train_ds[1]])
    t0 = time.perf_counter()
    rel, worst_bn, errs, b_d, b_c = rsn_step_errors(
        rsn_step_on(cfg, device, batch), rsn_step_on(cfg, "cpu", batch))
    worst = max(errs, key=errs.get)
    log(f"[rsn] 11c {stages}-stage float64 step B=2, TF32 off, card vs "
        f"CPU: loss rel {rel:.3g} (limit {RSN_LOSS_RTOL64:g}); worst BN "
        f"running stat {worst_bn:.3g} x its max (limit {STEP_BN_TOL:g}); "
        f"worst gradient {errs[worst]:.3g} x its tensor's max |g| ({worst}"
        f"; limit {RSN_GRAD_TOL64:g}), median tensor "
        f"{float(np.median(list(errs.values()))):.3g}; conv biases before "
        f"a BN {b_d:.3g} / {b_c:.3g} x their weight's max |g| (limit "
        f"{RSN_BIAS_TOL:g}); two steps in {time.perf_counter() - t0:.1f} s "
        f"| {card}")
    check(rel <= RSN_LOSS_RTOL64, f"11c float64 step loss card vs CPU rel "
          f"{rel:.3g}")
    check(worst_bn <= STEP_BN_TOL, f"11c float64 step BN running stats: "
          f"card vs CPU {worst_bn:.3g} x max")
    bad = {k: e for k, e in errs.items() if e > RSN_GRAD_TOL64}
    check(not bad, f"11c float64 gradients card vs CPU: {bad}")
    check(max(b_d, b_c) <= RSN_BIAS_TOL, f"11c float64 conv-bias gradients "
          f"{b_d:.3g} (card), {b_c:.3g} (CPU) x max |g|")
    torch.cuda.empty_cache()
    set_tf32(True)


def rsn_stage_growth(cfg, train_ds, card, device="cuda"):
    """11c: the multi-stage forward of ``cfg`` in train mode, float64, on
    the card and on the CPU from the same seeded weights and batch: the
    loss to ``RSN_LOSS_RTOL64`` and the first stage's outputs to
    ``RSN_STAGE0_RTOL64``; the difference of each later stage's outputs,
    which each stage multiplies (a seeded random multi-stage RSN at B=2
    amplifies rounding; so its gradients are held on two stages,
    :func:`rsn_check_step`), is printed."""
    from udp_pose_tpu_torch.core.infer import (RSN_BGR_MEAN, RSN_BGR_STD,
                                               normalize_images)
    from udp_pose_tpu_torch.core.loss import rsn_multi_stage_loss
    from udp_pose_tpu_torch.data.base import collate
    from udp_pose_tpu_torch.models import build_model
    train_ds.seed(0)
    batch = collate([train_ds[0], train_ds[1]])
    images = normalize_images(torch.as_tensor(batch["image"]), RSN_BGR_MEAN,
                              RSN_BGR_STD).double()
    S = cfg.MODEL.EXTRA.STAGE_NUM
    runs = {}
    with torch.no_grad():
        for dev in (device, "cpu"):
            model = build_model(cfg, device=dev, train=True).double()
            out = model(images.to(dev).permute(0, 3, 1, 2))
            loss = rsn_multi_stage_loss(
                out, torch.as_tensor(batch["valid"]).to(dev, torch.float64),
                torch.as_tensor(batch["labels"]).to(dev, torch.float64), S,
                ohkm=cfg.LOSS.USE_OHKM, topk=cfg.LOSS.TOPK)
            runs[dev] = (float(loss), [[o.cpu() for o in st] for st in out])
            del model, out
    (loss_d, out_d), (loss_c, out_c) = runs[device], runs["cpu"]
    rel = abs(loss_d - loss_c) / abs(loss_c)
    by_stage = [max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(sd, sc)) for sd, sc in zip(out_d, out_c)]
    log(f"[rsn] 11c {S}-stage forward in train mode, float64, B=2, card vs "
        f"CPU: loss {loss_d:.12g} vs {loss_c:.12g} (rel {rel:.3g}, limit "
        f"{RSN_LOSS_RTOL64:g}); worst output of each stage, x its max: "
        + ", ".join(f"{e:.3g}" for e in by_stage)
        + f" (stage 0 limit {RSN_STAGE0_RTOL64:g}) | {card}")
    check(rel <= RSN_LOSS_RTOL64, f"11c float64 loss card {loss_d} vs CPU "
          f"{loss_c}")
    check(by_stage[0] <= RSN_STAGE0_RTOL64, f"11c float64 stage-0 outputs "
          f"card vs CPU {by_stage[0]:.3g} x max")
    torch.cuda.empty_cache()


def rsn_iteration_training(tmp, card, device="cuda", yaml=RSN4X18_YAML,
                           n_train=RSN_TRAIN_IMAGES, n_val=RSN_VAL_IMAGES,
                           max_iter=4, period=2, warmup=16):
    """11c: ``4xrsn18_256x192`` at full width (bf16, B=32, WORKERS 4)
    through ``train.run`` in iteration mode on a seeded synthetic
    mini-COCO in memory, with only ``MAX_ITER``, ``CHECKPOINT_PERIOD``
    and ``WARMUP_ITERS`` cut: the count scaled x8, the checkpoints at each
    period and ``iter-last.pth`` loading, the LR of the schedule, one
    validation, ``final_state.pth`` loading ``strict=True``; samples/s,
    the wait for the batch and peak memory.  First the float64 forward
    card vs CPU (:func:`rsn_stage_growth`) and one float64 step of its
    first two stages card vs CPU (:func:`rsn_check_step`).  Returns the
    launches."""
    from udp_pose_tpu_torch import train as train_cli
    from udp_pose_tpu_torch.core.rsn import warmup_linear_decay
    from udp_pose_tpu_torch.models import build_model
    rng = np.random.default_rng(34)
    root = os.path.join(tmp, "coco_rsn_train")
    frames = {"train2017": synthetic_coco(root, "train2017", n_train, rng),
              "val2017": synthetic_coco(root, "val2017", n_val, rng)}
    cfg = rsn_data_cfg(yaml, "bfloat16", root, os.path.join(tmp, "rsn_run"))
    B = cfg.TRAIN.BATCH_SIZE_PER_GPU
    check(cfg.TRAIN.MAX_ITER == 96000 and cfg.WORKERS == 4 and B == 32
          and cfg.MODEL.EXTRA.STAGE_NUM == 4, "4xrsn18 yaml")
    cfg.TRAIN.MAX_ITER = max_iter
    cfg.TRAIN.CHECKPOINT_PERIOD = period
    cfg.TRAIN.WARMUP_ITERS = warmup
    train_ds = in_memory_rsn(cfg, frames["train2017"], True)
    val_ds = in_memory_rsn(cfg, frames["val2017"], False)
    cfg32 = cfg.clone()
    cfg32.TPU.DTYPE = "float32"
    set_tf32(False)
    rsn_stage_growth(cfg32, train_ds, card, device)
    rsn_check_step(cfg32, train_ds, card, device)

    # the trainer's cuDNN switches (train.main's), for this run only: the
    # phases after this one compare results of repeated calls
    flags = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.enabled)
    train_cli.set_cudnn(cfg)
    torch.cuda.reset_peak_memory_stats()
    path = PathLaunches("rsn_training")
    t0 = time.perf_counter()
    try:
        record = path.run(train_cli.run, cfg, build_model(
            cfg, device=device, train=True), train_ds, val_ds,
            cfg.OUTPUT_DIR, device)
    finally:
        (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic,
         torch.backends.cudnn.enabled) = flags
    secs = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(path.counts == path.want, f"rsn_training: launches {path.counts}")
    sched = train_cli.rsn_schedule(cfg, len(train_ds) // B)
    steps = record["steps"]
    losses = [s["loss"] for s in steps]
    check(sched.max_iters == 8 * max_iter and len(steps) == sched.max_iters
          and all(np.isfinite(losses)), f"{len(steps)} iterations for "
          f"MAX_ITER {max_iter}; losses {losses}")
    want = [f"iter-{k * period * 8 - 1}.pth"
            for k in range(1, max_iter // period + 1)]
    got = sorted({os.path.basename(p) for p in record["checkpoints"]},
                 key=lambda n: int(n[5:-4]))
    check(got == want and os.readlink(os.path.join(
        cfg.OUTPUT_DIR, "iter-last.pth")) == want[-1],
          f"iteration checkpoints {got}, want {want} and iter-last.pth")
    net = build_model(cfg, device=device, train=True)
    for name in want + ["iter-last.pth"]:
        ckpt = torch.load(os.path.join(cfg.OUTPUT_DIR, name),
                          map_location=device)
        net.load_state_dict(ckpt["state_dict"], strict=True)
        check(ckpt["step"] == ckpt["iteration"] + 1, f"{name}: step "
              f"{ckpt['step']}, iteration {ckpt['iteration']}")
    final = torch.load(os.path.join(cfg.OUTPUT_DIR, "final_state.pth"),
                       map_location=device)
    build_model(cfg, device=device).load_state_dict(final, strict=True)
    lr = warmup_linear_decay(sched.base_lr, sched.warmup_iters,
                             sched.max_iters)
    picks = (0, sched.warmup_iters, sched.max_iters - 1)
    check(all(abs(steps[i]["lr"] - lr(i)) <= 1e-12 * lr(i) for i in picks),
          f"LR at iterations {picks}: {[steps[i]['lr'] for i in picks]}, "
          f"the schedule's {[lr(i) for i in picks]}")
    check(len(record["validations"]) == 1
          and np.isfinite(record["name_values"]["AP"]),
          f"validations {record['validations']}")
    epochs = sorted({s["epoch"] for s in steps})
    warm = [s for s in steps if s["step"] >= WARM_STEPS] or steps
    iter_ms = np.median([s["iter_s"] for s in warm]) * 1e3
    load_ms = np.median([s["load_s"] for s in warm]) * 1e3
    v = record["validations"][0]
    picked = ", ".join(f"{steps[i]['lr']:.6g}" for i in picks)
    log(f"[rsn] 11c 4xrsn18 256x192 bf16 B={B} iteration mode, "
        f"train.run with WORKERS {cfg.WORKERS}: MAX_ITER {max_iter} -> "
        f"{sched.max_iters} iterations (x8 on one card) over epochs "
        f"{epochs[0]}-{epochs[-1]} of {len(train_ds)} samples, lr "
        f"{sched.base_lr:g}, warmup {sched.warmup_iters}; LR at iterations "
        f"{picks}: {picked} = warmup_linear_decay's; checkpoints "
        f"{', '.join(want)} and "
        f"iter-last.pth -> {want[-1]} loaded strict=True; final_state.pth "
        f"loaded strict=True; losses {losses[0]:.5g} ... {losses[-1]:.5g}; "
        f"{B / iter_ms * 1e3:.1f} samples/s (median iteration "
        f"{iter_ms:.2f} ms after {WARM_STEPS} warm-up steps in each epoch, "
        f"of which waiting for the batch {load_ms:.2f} ms); validation of "
        f"{v['crops']} crops in {v['seconds']:.2f} s (AP {v['perf']:.4f}, "
        f"random weights); train.run {secs:.1f} s; peak "
        f"max_memory_allocated {peak_gb:.2f} GB; launches {path.counts} | "
        f"{card}")
    del net, final
    torch.cuda.empty_cache()
    return path.counts, B / iter_ms * 1e3


def rsn_int8(tmp, card, device="cuda", yaml=RSN18_YAML,
             n_images=RSN_VAL_IMAGES, batch=SERVE_BATCH, iters=10):
    """11d: ``rsn18_256x192`` through ``test.run`` with ``TPU.QUANTIZE
    int8`` (self-calibrating, the yaml's flip, bf16) on a synthetic
    mini-COCO val: one fused int8 conv launch a site and served batch;
    int8 against bf16 crops/s at B = ``batch`` with the flip folded, in
    turns; the fused kernel at every input layout the path launched it
    at (the residual steps' channel slices and their sums included)
    against the three-step card path, bit for bit; its time over one
    fold forward's shapes against its bound and the bf16 cuDNN convs.
    Returns (launches, the kernel's numbers, crops/s)."""
    import types

    from udp_pose_tpu_torch import test as test_cli
    from udp_pose_tpu_torch.core.infer import COCO_FLIP_PAIRS
    from udp_pose_tpu_torch.core.rsn import make_rsn_infer_fn_from_cfg
    from udp_pose_tpu_torch.models import build_model
    from udp_pose_tpu_torch.models import quantize as mq
    root = os.path.join(tmp, "coco_rsn_int8")
    frames = synthetic_coco(root, "val2017", n_images,
                            np.random.default_rng(35))
    cfg = rsn_data_cfg(yaml, "bfloat16", root, os.path.join(tmp, "int8"))
    cfg.TPU.QUANTIZE = "int8"
    val_ds = in_memory_rsn(cfg, frames, False)
    made, quantize_for_eval = [], mq.quantize_for_eval

    def keep(*args, **kw):          # test.run's int8 model, for 9g below
        made.append(quantize_for_eval(*args, **kw))
        return made[-1]

    path = PathLaunches("int8_rsn18")
    mq.quantize_for_eval = keep
    try:
        nv, perf = path.run(test_cli.run, cfg, None, val_ds,
                            cfg.OUTPUT_DIR, device)
    finally:
        mq.quantize_for_eval = quantize_for_eval
    qm = made[0]
    val_batches = -(-len(val_ds) // cfg.TEST.BATCH_SIZE_PER_GPU)
    check(len(qm.engaged) == INT8_SITES_RSN18 and not any(
        "res_conv2" in p for p in qm.engaged), f"rsn18 int8: "
        f"{len(qm.engaged)} engaged sites")
    path.served(0, INT8_SITES_RSN18 * val_batches)
    check(path.counts == path.want, f"int8_rsn18 test.run: launches "
          f"{path.counts}, want {path.want}")
    log(f"[rsn] 11d python -m udp_pose_tpu_torch.test's run, TPU.QUANTIZE "
        f"int8: calibrated {len(qm.act_scales)} sites ({INT8_SITES_RSN18} "
        f"engaged, the 4 res_conv2 heads in bf16), {len(val_ds)} crops in "
        f"{val_batches} batches, AP {perf:.4f} (random weights); "
        f"int8_conv_fused launches "
        f"{path.counts['int8_conv_fused']} = {INT8_SITES_RSN18} sites x "
        f"{val_batches} batches | {card}")

    crops, center, scale = random_crops(batch, cfg, seed=36)
    int8_fn = make_rsn_infer_fn_from_cfg(qm, cfg, COCO_FLIP_PAIRS)
    bf16_fn = rsn_serving_fn(cfg, device)

    def int8_batch():
        out = int8_fn(crops, center, scale)
        path.served(0, INT8_SITES_RSN18)
        return out

    crops_s = {"bf16": [], "int8": []}
    for kind in ("bf16", "int8", "int8", "bf16"):
        if kind == "int8":
            ms = [path.run(host_ms, int8_batch, iters) for _ in range(3)]
        else:
            ms = [host_ms(lambda: bf16_fn(crops, center, scale), iters)
                  for _ in range(3)]
        crops_s[kind].append(batch / np.median(ms) * 1e3)
    path.check(engine=True)
    kp_q = int8_fn(crops, center, scale)[0]      # outside the windows
    kp_b = bf16_fn(crops, center, scale)[0]
    log(f"[rsn] 11d int8 rsn18 256x192 B={batch} flip fold: crops/s int8 "
        f"{', '.join(f'{r:.1f}' for r in crops_s['int8'])} against bf16 "
        f"{', '.join(f'{r:.1f}' for r in crops_s['bf16'])} (in turns bf16, "
        f"int8, int8, bf16, each the median of 3 x {iters} batches); int8 "
        f"vs bf16 keypoints (random weights: a number only) median "
        f"{float((kp_q - kp_b).abs().median()):.3g} px; launches "
        f"{path.counts} | {card}")
    path.keep_layouts(types.SimpleNamespace(qmodel=qm))
    del made, qm, int8_fn, bf16_fn
    torch.cuda.empty_cache()
    layouts = check_path_layouts(path, card, device)
    w, h = cfg.MODEL.IMAGE_SIZE
    sites = int8_sites(build_model(cfg, device=device),
                       torch.zeros(1, 3, h, w, dtype=torch.bfloat16,
                                   device=device), strides=True)
    check(len(sites) == INT8_SITES_RSN18, f"rsn18: {len(sites)} int8 sites")
    sums, errs, n_shapes = int8_forward_times("rsn18", sites, 2 * batch,
                                              card, device)
    kernel = {"ms": sums["int8_conv_fused"],
              "pr6_design_ms": sums["pr6_design"],
              "by_route": sums["by_route"],
              "bound_ms": sums["bound_int8_conv_fused"],
              "bound_by": ("bytes" if sums["bound_by_bytes"]
                           >= sums["bound_by_ops"] else "operations"),
              "plain_ms": sums["plain_int8_conv_fused"],
              "cudnn_bf16_conv_ms": sums["cudnn_bf16"],
              "three_step_ms": sums["three_step"],
              "max_abs_err": errs["int8_conv_fused"], "shapes": n_shapes,
              "layouts_checked": layouts,
              "per": f"one rsn18 fold forward, B={2 * batch}, "
                     f"{INT8_SITES_RSN18} launches"}
    return path.counts, kernel, {k: float(np.median(v))
                                 for k, v in crops_s.items()}


def phase_rsn(tmp, device="cuda"):
    """Phase 11: RSN at full width: serving rsn18 (11a), the 4xRSN-50
    evaluation (11b), iteration-mode training of 4xRSN-18 (11c) and int8
    rsn18 (11d).  Returns (launches by path, the int8 kernel's numbers on
    rsn18, rates, the function that profiles 11a's batches)."""
    card = card_line()
    t_phase = time.perf_counter()
    paths, rates = {}, {}
    rates["rsn18_bf16"], paths["rsn18_serving"], profile = rsn_serving(
        card, device)
    paths["rsn_4x50_eval"], rates["rsn_4x50_eval"] = rsn_best_model(
        tmp, card, device)
    paths["rsn_training"], rates["rsn_training"] = rsn_iteration_training(
        tmp, card, device)
    paths["int8_rsn18"], kernel, int8_rates = rsn_int8(tmp, card, device)
    rates.update({f"rsn18_int8_{k}": v for k, v in int8_rates.items()})
    log(f"[rsn] phase 11 {time.perf_counter() - t_phase:.1f} s; launches "
        f"{paths}")
    return paths, kernel, rates, profile


# --------------------------------------------------------------- phase 12
MOBILE_YAMLS = {name: os.path.join(REPO, "configs/coco", f"{stem}.yaml")
                for name, stem in (
                    ("mobilenetv3_small", "mobilenetv3_small_256x192"),
                    ("mobilevit_s", "mobilevit_s_256x192_pixel_shuffle"),
                    ("mobilevitv2_05",
                     "mobilevitv2_05_256x192_pixel_shuffle"),
                    ("shufflenetv2_10x",
                     "shufflenetv2_10x_256x192_pixel_shuffle"),
                    ("shufflenetv2_plus_small",
                     "shufflenetv2_plus_small_256x192"))}
# the depthwise convs of each net (every grouped conv of the zoo is one)
MOBILE_DW_SITES = {"mobilenetv3_small": 11, "mobilevit_s": 7,
                   "mobilevitv2_05": 9, "shufflenetv2_10x": 19,
                   "shufflenetv2_plus_small": 28}
MOBILE_KP_ATOL = 1e-3            # px: card vs CPU peak keypoints (12a)


def mobile_sites(cfg, device="cuda"):
    """(dense, depthwise) int8 sites of one forward of ``cfg``'s net at
    B=2, from the conv modules its forward calls (:func:`int8_sites`);
    each depthwise site also with its input's element strides and its
    base's offset from a 16-byte boundary (the layout the kernel's route
    is chosen by)."""
    from udp_pose_tpu_torch.models import build_model
    from udp_pose_tpu_torch.models.quantize import is_depthwise
    w, h = cfg.MODEL.IMAGE_SIZE
    model = build_model(cfg, device=device)
    layouts = {}

    def record(m, args):
        layouts.setdefault(m, (args[0].stride(), args[0].data_ptr() % 16))

    hooks = [m.register_forward_pre_hook(record) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d) and is_depthwise(m)]
    try:
        sites = int8_sites(model, torch.zeros(2, 3, h, w,
                                              dtype=torch.bfloat16,
                                              device=device))
    finally:
        for hook in hooks:
            hook.remove()
    dw = [site + layouts[site[0]] for site in sites
          if is_depthwise(site[0])]
    return [site for site in sites if not is_depthwise(site[0])], dw


def mobile_serving(card, device="cuda"):
    """12a: each mobile yaml at full width with seeded random weights
    through :func:`float_path` (fp32 card vs CPU heatmaps and keypoints,
    bf16 B=128 with the yaml's flip folded: crops/s and no decode launch),
    and ``shufflenetv2_test`` with its offset head at B=128: one fused
    decode a batch, and the fused decode of its card output bit-equal to
    the plain version.  Returns (crops/s, launches, profiles)."""
    from udp_pose_tpu_torch.core.infer import make_infer_fn_from_cfg
    from udp_pose_tpu_torch.models import build_model
    from udp_pose_tpu_torch.ops import peak_offset as po
    rates, paths, profiles = {}, {}, []
    for name, path in MOBILE_YAMLS.items():
        rates[name], paths[f"{name}_serving"], profile = float_path(
            name, yaml_cfg(path, "bfloat16"), card, device,
            tag="[mobile] 12a", kp_atol=MOBILE_KP_ATOL)
        profiles.append(profile)
    cfg = yaml_cfg(MOBILE_YAMLS["shufflenetv2_10x"], "bfloat16")
    cfg.MODEL.NAME = "shufflenetv2_test"
    cfg.MODEL.TARGET_TYPE = "offset"
    name = "shufflenetv2_test"
    rates[name], paths[f"{name}_serving"], profile = float_path(
        name, cfg, card, device, tag="[mobile] 12a")
    profiles.append(profile)
    infer = make_infer_fn_from_cfg(build_model(cfg, device=device), cfg)
    crops, center, scale = random_crops(SERVE_BATCH, cfg, seed=120)
    _, _, hm = infer(crops, center, scale)
    check(same_bits(po.udp_offset_decode_fused(hm, cfg.LOSS.KPD),
                    po.udp_offset_decode_reference(hm, cfg.LOSS.KPD)),
          "shufflenetv2_test: fused decode != its plain version")
    log(f"[mobile] 12a shufflenetv2_test B={SERVE_BATCH} heatmaps "
        f"{tuple(hm.shape)} ({layout_of(hm)}): fused decode bit-equal to "
        f"its plain version | {card}")
    del infer, hm
    torch.cuda.empty_cache()
    return rates, paths, profiles


def check_dw_layouts(path, card, device="cuda"):
    """12b: the depthwise kernel at every input layout at which ``path``
    launched it, with that site's weights on a seeded activation of that
    layout that spans the quantiser's range, against its plain version
    on the card, bit for bit; each layout's load route logged.  Returns
    (layouts, |card - plain| max)."""
    from udp_pose_tpu_torch.ops import int8_dwconv as dw
    check(path.dw_layouts, f"{path.name}: no depthwise int8 launch recorded")
    routes, err = {}, 0.0
    for i, (key, layer) in enumerate(sorted(path.dw_layouts.items(),
                                            key=lambda kv: str(kv[0]))):
        shape, stride, dtype, misalign = key[:4]
        x = layout_tensor(shape, stride, dtype, misalign,
                          64.0 / layer.inv_s_a, 200 + i, device)
        got = dw.int8_dwconv(x, layer)
        want = dw.int8_dwconv_reference(x, layer)
        plan = dw.launch_plan(x, layer)
        routes[plan.label] = routes.get(plan.label, 0) + 1
        err = max(err, float((got.double() - want.double()).abs().max()))
        check(torch.equal(got, want), f"12b {path.name}: int8_dwconv != its "
              f"plain version at x {shape} strides {stride} {dtype}, kernel "
              f"{layer.kernel_size}, stride {layer.stride} ({plan.label})")
        log(f"[mobile] 12b {path.name} layout x {tuple(shape)} strides "
            f"{stride} +{misalign} B {str(dtype)[6:]} k{layer.kernel_size[0]}"
            f" s{layer.stride[0]}: {plan.label}, {plan.cb} channels a "
            f"block")
        del x, got, want
    torch.cuda.empty_cache()
    log(f"[mobile] 12b {path.name}: int8_dwconv bit-equal to its plain "
        f"version at all {len(path.dw_layouts)} input layouts the path "
        f"launched it at (by route: {routes}) | {card}")
    return len(path.dw_layouts), err


def tile_route(x):
    """The previous design's load route for ``x``, as its launcher picks it:
    16 bytes where C % 8 == 0 on a channels-last view whose base and
    strides are 16-byte multiples, one value a thread otherwise."""
    step = 8 * x.element_size()
    return ("vec" if x.shape[1] % 8 == 0 and x.stride(1) == 1
            and x.data_ptr() % 16 == 0
            and all(x.stride(d) * x.element_size() % step == 0
                    for d in (0, 2, 3) if x.shape[d] > 1) else "one-value")


def dw_shape_run(conv, shape, stride, misalign, dtype, device, seed):
    """One depthwise shape in the layout its site gets: the launch and the
    previous design against the plain version, bit for bit; times (graph
    replay) of the two designs in turns (previous, launch, launch,
    previous), of cuDNN's bf16 depthwise conv of the same shape (the
    yardstick: no PyTorch call computes the int8 function) and the plain
    version's (eager, once); the byte bound (the activation read once,
    the output written once, the int8 weight, scale and bias) against the
    operation bound (2 int8 operations a multiply-add at the int8
    rate)."""
    import torch.nn.functional as F

    from udp_pose_tpu_torch.models.quantize import Int8DepthwiseConv2d
    from udp_pose_tpu_torch.ops import int8_dwconv as dw
    x = layout_tensor(shape, stride, dtype, misalign, 1.0, seed, device)
    layer = Int8DepthwiseConv2d(conv, float(x.float().abs().amax()) * 0.9)
    got = dw.int8_dwconv(x, layer)
    old = dw.int8_dwconv_tiled(x, layer)
    want = dw.int8_dwconv_reference(x, layer)
    errs = tuple(float((y.double() - want.double()).abs().max())
                 for y in (got, old))
    route = dw.launch_plan(x, layer).label
    check(torch.equal(got, want), f"int8_dwconv != its plain version at "
          f"{tuple(shape)} k{conv.kernel_size[0]} s{conv.stride[0]} ({route})")
    check(torch.equal(old, want), f"the tile "
          f"design != the plain version at {tuple(shape)} "
          f"k{conv.kernel_size[0]} s{conv.stride[0]}")
    w_bf = conv.weight.detach().to(torch.bfloat16)
    x_bf = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    fast = dict(iters=5, repeats=3, warm_s=0.02)
    t = turns({"int8_dwconv": lambda: dw.int8_dwconv(x, layer),
               "tiled": lambda: dw.int8_dwconv_tiled(x, layer)},
              ("tiled", "int8_dwconv", "int8_dwconv", "tiled"), repeats=2)
    t["cudnn_bf16"] = graph_ms(lambda: F.conv2d(
        x_bf, w_bf, None, conv.stride, conv.padding, 1, conv.groups), [()],
        **fast)
    t["plain"] = cuda_ms(lambda: dw.int8_dwconv_reference(x, layer), [()],
                         iters=1, repeats=1, warm_s=0.0)
    N, C = shape[:2]
    Ho, Wo = got.shape[2:]
    elt = x.element_size()
    k2 = conv.kernel_size[0] * conv.kernel_size[1]
    t["bytes"] = x.numel() * elt + N * C * Ho * Wo * elt + k2 * C + 8 * C
    t["ops"] = 2 * k2 * N * C * Ho * Wo
    bound = bound_of(t["bytes"], t["ops"], INT8_OPS_PER_S)
    routes = (route, tile_route(x))
    del x, x_bf, got, old, want
    return t, bound, errs, routes


DW_SUMS = ("int8_dwconv", "tiled", "cudnn_bf16", "plain", "bound",
           "bound_bytes", "bound_ops", "bytes", "ops", "narrow",
           "narrow_tiled")


def dw_forward_times(net, sites, batch, card, device="cuda"):
    """12b for one net: :func:`dw_shape_run` at each distinct depthwise
    shape and layout of ``sites`` at batch ``batch`` (one fold forward),
    logged; returns the numbers summed over the forward (each shape times
    its sites; ``narrow``: the routes other than 16-byte channels-last,
    which the previous design served one value a thread), the sums by
    route, and the largest |card - plain| of the launch and of the
    previous design."""
    shapes = {}
    for conv, shape, dtype, stride, misalign in sites:
        key = ((batch,) + shape[1:], dtype, conv.kernel_size, conv.stride,
               stride, misalign)
        shapes.setdefault(key, [conv, 0])[1] += 1
    sums = dict.fromkeys(DW_SUMS, 0.0)
    sums["tiled_err"] = 0.0
    by_route = {}
    err = 0.0
    for i, (key, (conv, count)) in enumerate(sorted(
            shapes.items(), key=lambda kv: str(kv[0]))):
        shape, dtype, _, _, stride, misalign = key
        t, (b_ms, by), (e, e_old), (route, old) = dw_shape_run(
            conv, shape, stride, misalign, dtype, device, seed=300 + i)
        err = max(err, e)
        sums["tiled_err"] = max(sums["tiled_err"], e_old)
        for k in ("int8_dwconv", "tiled", "cudnn_bf16", "plain", "bytes",
                  "ops"):
            sums[k] += count * t[k]
        if not route.startswith("channels_last/16B"):
            sums["narrow"] += count * t["int8_dwconv"]
            sums["narrow_tiled"] += count * t["tiled"]
        r = by_route.setdefault(route, {"ms": 0.0, "previous_design_ms": 0.0,
                                        "sites": 0})
        r["ms"] += count * t["int8_dwconv"]
        r["previous_design_ms"] += count * t["tiled"]
        r["sites"] += count
        sums["bound"] += count * b_ms
        sums["bound_bytes" if by == "bytes" else "bound_ops"] += count * b_ms
        log(f"[mobile] 12b {net} dw {shape} strides {stride} +{misalign} B "
            f"k{key[2][0]} s{key[3][0]} {str(dtype)[6:]} x{count} ({route}; "
            f"previous design {old}): both bit-equal; int8_dwconv "
            f"{t['int8_dwconv'] * 1e3:.2f} us, previous design "
            f"{t['tiled'] * 1e3:.2f} (in turns) (bound {b_ms * 1e3:.2f}, "
            f"{by}; plain {t['plain'] * 1e3:.1f}); bf16 cuDNN depthwise conv "
            f"{t['cudnn_bf16'] * 1e3:.2f} us")
        torch.cuda.empty_cache()
    log(f"[mobile] 12b {net}, one fold forward (B={batch}, {len(sites)} "
        f"depthwise sites, {len(shapes)} shapes, ms): int8_dwconv "
        f"{sums['int8_dwconv']:.4f}, previous design {sums['tiled']:.4f} "
        f"(bound {sums['bound']:.4f}, of which bytes "
        f"{sums['bound_bytes']:.4f}: {sums['bytes'] / 1e9:.3f} GB, "
        f"{sums['ops'] / 1e12:.3f} T int8 operations; narrow routes "
        f"{sums['narrow']:.4f} against the previous design's "
        f"{sums['narrow_tiled']:.4f}; plain {sums['plain']:.3f}) "
        f"against the bf16 cuDNN depthwise convs {sums['cudnn_bf16']:.4f}; "
        f"by route {json.dumps(by_route)} | {card}")
    return sums, by_route, err, len(shapes)


def mobile_int8(name, card, device="cuda", batch=SERVE_BATCH, iters=10):
    """12b for one mobile yaml: the pipeline calibrates itself on two
    batches of B = ``batch`` and serves w8a8 (``final_layer`` and the
    transposed convs in bf16): int8 and bf16 crops/s in turns, one launch
    a site and batch of the fused int8 conv (dense sites) and of the
    depthwise kernel (depthwise sites), both kernels at every input layout
    they ran against the three-step card path and the plain version; the
    depthwise kernel timed over one fold forward's shapes beside the tile
    design.  Returns (launches, the depthwise numbers, their sums by
    route, the largest |card - plain|, crops/s, layouts checked)."""
    from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
    cfg = yaml_cfg(MOBILE_YAMLS[name], "bfloat16")
    dense, dw = mobile_sites(cfg, device)
    check(len(dw) == MOBILE_DW_SITES[name], f"{name}: {len(dw)} depthwise "
          f"int8 sites, want {MOBILE_DW_SITES[name]}")
    path = PathLaunches(f"int8_{name}")
    q = UdpPosePipeline(cfg, device=device, seed=0, quantize="int8",
                        calib_batches=2)
    bf16 = UdpPosePipeline(cfg, device=device, seed=0)

    def served(*args):
        def call():
            calibrating = q.int8.calibrating
            out = q.infer_crops(*args)
            if not calibrating:
                path.served(0, len(dense), len(dw))
            return out
        return call

    for seed in (110, 111):
        path.run(served(*random_crops(batch, cfg, seed)))
    check(q.int8.table is not None, f"{name}: not calibrated")
    crops, center, scale = random_crops(batch, cfg, seed=112)
    rates = {"bf16": [], "int8": []}
    for kind in ("bf16", "int8", "int8", "bf16"):
        if kind == "int8":
            ms = [path.run(host_ms, served(crops, center, scale), iters)
                  for _ in range(3)]
        else:
            ms = [host_ms(lambda: bf16.infer_crops(crops, center, scale),
                          iters) for _ in range(3)]
        rates[kind].append(batch / np.median(ms) * 1e3)
    engaged = q.int8.qmodel.engaged
    check(len(engaged) == len(dense) + len(dw), f"{name}: {len(engaged)} "
          f"engaged sites, want {len(dense)} + {len(dw)}")
    path.check()
    log(f"[mobile] 12b int8 {name} 256x192 B={batch} flip fold: "
        f"self-calibrated ({len(q.int8.table)} sites in the table, "
        f"{len(dense)} dense and {len(dw)} depthwise engaged); crops/s int8 "
        f"{', '.join(f'{r:.1f}' for r in rates['int8'])} against bf16 "
        f"{', '.join(f'{r:.1f}' for r in rates['bf16'])} (in turns bf16, "
        f"int8, int8, bf16, each the median of 3 x {iters} batches); "
        f"int8/bf16 {np.median(rates['int8']) / np.median(rates['bf16']):.3f}"
        f"; launches {path.counts} | {card}")
    path.keep_layouts(q.int8)
    del q, bf16
    torch.cuda.empty_cache()
    layouts = (check_path_layouts(path, card, device),
               check_dw_layouts(path, card, device))
    sums, by_route, err, n_shapes = dw_forward_times(name, dw, 2 * batch,
                                                     card, device)
    sums["shapes"], sums["sites"] = n_shapes, len(dw)
    return path.counts, sums, by_route, max(err, layouts[1][1]), {
        k: float(np.median(v)) for k, v in rates.items()}, (
        layouts[0], layouts[1][0])


def rsn_prm_int8(card, device="cuda", batch=16):
    """12b: ``rsn18_256x192`` with ``USE_PRM`` (no shipped yaml sets it),
    int8 through its 9×9 depthwise site: calibrated on one batch, one
    flip-folded batch of B = ``batch`` through RSN's serving graph in a
    window of the launches (one launch a site), and the 9×9 layout
    against the plain version.  Returns the launches."""
    import types

    from udp_pose_tpu_torch.core.infer import (COCO_FLIP_PAIRS,
                                               normalize_images,
                                               serving_normalizer)
    from udp_pose_tpu_torch.core.rsn import make_rsn_infer_fn_from_cfg
    from udp_pose_tpu_torch.models import build_model
    from udp_pose_tpu_torch.models import quantize as mq
    cfg = yaml_cfg(RSN18_YAML, "bfloat16")
    cfg.MODEL.EXTRA.USE_PRM = True
    dense, dw = mobile_sites(cfg, device)
    check(len(dw) == 1 and dw[0][0].kernel_size == (9, 9),
          f"rsn18 PRM: depthwise sites {[s[0].kernel_size for s in dw]}")
    model = build_model(cfg, device=device)
    crops, center, scale = random_crops(batch, cfg, seed=130)
    mean, std = serving_normalizer(cfg)
    x = normalize_images(torch.as_tensor(crops, device=device), mean,
                         std).to(torch.bfloat16).permute(0, 3, 1, 2)
    qm = mq.QuantizedModel(model, mq.calibrate(model, [x]))
    infer = make_rsn_infer_fn_from_cfg(qm, cfg, COCO_FLIP_PAIRS)
    path = PathLaunches("int8_rsn18_prm")
    preds = path.run(lambda: infer(crops, center, scale))[0]
    path.served(0, len(dense), len(dw))
    path.check()
    check(bool(torch.isfinite(preds).all()), "rsn18 PRM int8: non-finite")
    path.keep_layouts(types.SimpleNamespace(qmodel=qm))
    n, err = check_dw_layouts(path, card, device)
    log(f"[mobile] 12b int8 rsn18 with USE_PRM B={batch} flip fold: "
        f"{len(dense)} dense sites and the 9x9 depthwise one in int8, "
        f"launches {path.counts}; the 9x9 site at its {n} layout(s) "
        f"bit-equal to the plain version | {card}")
    return path.counts, err


def mobile_training(tmp, card, device="cuda"):
    """12c: ``mobilevitv2_05`` (attention, ``LayerNorm2D``, the
    align-corners resize) trained one epoch through ``train.run`` at B=32
    with the yaml's WORKERS 4 on phase 7's synthetic mini-COCO, validated
    (no fused decode: Gaussian targets); ``test.run`` with ``TPU.QUANTIZE
    int8`` on the weights it wrote (self-calibrating: one launch a site
    and batch of both int8 kernels); one ``/v1/pose`` request to a server
    on them; a few ``TPU.QAT int8`` steps of ``mobilenetv3_small``
    (grouped fake-quant).  Returns (launches by path, samples/s)."""
    from udp_pose_tpu_torch import test as test_cli
    from udp_pose_tpu_torch import train as train_cli
    from udp_pose_tpu_torch.engine.server import PoseServer, PoseService
    from udp_pose_tpu_torch.models import build_model
    from udp_pose_tpu_torch.ops.targets import gaussian_targets_np
    rng = np.random.default_rng(140)
    root = os.path.join(tmp, "coco_mobile")
    frames = {"train2017": synthetic_coco(root, "train2017", TRAIN_IMAGES,
                                          rng),
              "val2017": synthetic_coco(root, "val2017", VAL_IMAGES, rng)}
    cfg = yaml_cfg(MOBILE_YAMLS["mobilevitv2_05"], "bfloat16")
    cfg.DATASET.ROOT = root
    cfg.OUTPUT_DIR = os.path.join(tmp, "mobile_run")
    cfg.TRAIN.END_EPOCH = 1
    os.makedirs(cfg.OUTPUT_DIR)
    B = cfg.TRAIN.BATCH_SIZE_PER_GPU
    check(cfg.WORKERS == 4 and B == 32, f"WORKERS {cfg.WORKERS}, B {B}")
    train_ds = in_memory_coco(cfg, frames["train2017"], True)
    val_ds = in_memory_coco(cfg, frames["val2017"], False)
    paths = {}
    training = PathLaunches("mobilevitv2_training")
    # the trainer's cuDNN switches for this run only, as in 11c
    flags = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.enabled)
    train_cli.set_cudnn(cfg)
    t0 = time.perf_counter()
    try:
        record = training.run(train_cli.run, cfg,
                              build_model(cfg, device=device, train=True),
                              train_ds, val_ds, cfg.OUTPUT_DIR, device)
    finally:
        (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic,
         torch.backends.cudnn.enabled) = flags
    secs = time.perf_counter() - t0
    check(training.counts == training.want, f"mobilevitv2_training: "
          f"launches {training.counts}")
    paths["mobilevitv2_training"] = training.counts
    steps = record["steps"]
    losses = [st["loss"] for st in steps]
    check(len(steps) == len(train_ds) // B and all(np.isfinite(losses)),
          f"mobilevitv2 losses {losses}")
    warm = [st for st in steps if st["step"] >= WARM_STEPS] or steps
    iter_ms = np.median([st["iter_s"] for st in warm]) * 1e3
    load_ms = np.median([st["load_s"] for st in warm]) * 1e3
    rate = B / iter_ms * 1e3
    iters = ", ".join(f"{st['iter_s'] * 1e3:.1f}" for st in steps)
    log(f"[mobile] 12c train.run mobilevitv2_05 bf16 B={B} WORKERS "
        f"{cfg.WORKERS}, one epoch of {len(train_ds)} samples: losses "
        f"{', '.join(f'{v:.5g}' for v in losses)}; iteration {iters} ms; "
        f"{rate:.1f} samples/s (median iteration {iter_ms:.2f} ms after "
        f"{WARM_STEPS} warm-up steps, waiting for the batch {load_ms:.2f} "
        f"ms); validation AP {record['validations'][-1]['perf']:.4f} "
        f"(random weights); train.run {secs:.1f} s | {card}")

    weights = os.path.join(cfg.OUTPUT_DIR, "final_state.pth")
    cfg8 = cfg.clone()
    cfg8.TPU.QUANTIZE = "int8"
    dense, dw = mobile_sites(cfg8, device)
    tested = PathLaunches("int8_mobilevitv2_test")
    _, perf = tested.run(test_cli.run, cfg8, weights, val_ds,
                         cfg.OUTPUT_DIR, device)
    val_batches = -(-len(val_ds) // cfg.TEST.BATCH_SIZE_PER_GPU)
    tested.served(0, len(dense) * val_batches, len(dw) * val_batches)
    tested.check()
    paths["int8_mobilevitv2_test"] = tested.counts
    log(f"[mobile] 12c test.run TPU.QUANTIZE int8 on final_state.pth: "
        f"{len(val_ds)} crops in {val_batches} batches, AP {perf:.4f}; "
        f"launches {tested.counts} = ({len(dense)} dense, {len(dw)} "
        f"depthwise sites) x {val_batches} batches | {card}")

    serving = PathLaunches("mobilevitv2_serving")
    service = PoseService(cfg, weights=weights, device=device, window_ms=1.0)
    server = PoseServer(service, host="127.0.0.1", port=0)
    thread = server.serve_in_thread()
    try:
        frame, boxes = requests_for(1, (480, 640), seed=141)[0]
        status, body, rsecs = serving.run(post_pose, server.port, frame,
                                          boxes)
    finally:
        server.shutdown()
        thread.join(timeout=30)
    kp = np.asarray(body.get("keypoints", []), np.float32)
    check(status == 200 and kp.shape == (len(boxes), 17, 2)
          and np.isfinite(kp).all(), f"mobile /v1/pose: {status} {kp.shape}")
    check(serving.counts == serving.want, f"mobilevitv2_serving: launches "
          f"{serving.counts}")
    paths["mobilevitv2_serving"] = serving.counts
    log(f"[mobile] 12c /v1/pose to a mobilevitv2_05 server on "
        f"final_state.pth: 200, {len(boxes)} persons x 17 joints in "
        f"{rsecs * 1e3:.1f} ms | {card}")

    qcfg = yaml_cfg(MOBILE_YAMLS["mobilenetv3_small"], "bfloat16")
    qcfg.TPU.QAT = "int8"
    w, h = qcfg.MODEL.IMAGE_SIZE
    tgts, wts = [], []
    for _ in range(B):
        joints = np.concatenate([rng.uniform(0, w - 1, (17, 1)),
                                 rng.uniform(0, h - 1, (17, 1)),
                                 np.zeros((17, 1))], 1)
        t, wt = gaussian_targets_np(joints, np.ones((17, 3)),
                                    qcfg.MODEL.HEATMAP_SIZE,
                                    qcfg.MODEL.IMAGE_SIZE, qcfg.MODEL.SIGMA)
        tgts.append(t)
        wts.append(wt)
    data = {"image": rng.integers(0, 256, (B, h, w, 3), dtype=np.uint8),
            "target": np.stack(tgts).astype(np.float32),
            "target_weight": np.stack(wts).astype(np.float32)}
    qat = repeated_batch_steps(qcfg, data, card, n_steps=6, device=device,
                               label="[mobile] 12c QAT int8 "
                                     "mobilenetv3_small (fake-quant "
                                     "convs, depthwise included)")
    return paths, {"mobilevitv2_training": rate,
                   "mobilenetv3_qat": B / np.median(qat[WARM_STEPS:])}


def phase_mobile(tmp, device="cuda"):
    """Phase 12: the mobile zoo at full width: serving (12a), int8 with
    the depthwise kernel (12b) and training (12c).  Returns (launches by
    path, the depthwise kernel's entry of the kernels line, rates, the
    functions that profile 12a's batches)."""
    card = card_line()
    t_phase = time.perf_counter()
    rates, paths, profiles = mobile_serving(card, device)
    kernel = {"by_net": {}, "max_abs_err": 0.0,
              "previous_design_max_abs_err": 0.0}
    totals = dict.fromkeys(DW_SUMS + ("shapes", "sites"), 0.0)
    by_route, layouts = {}, {}
    for name in MOBILE_YAMLS:
        (paths[f"int8_{name}"], sums, net_routes, err, int8_rates,
         n_layouts) = mobile_int8(name, card, device)
        rates.update({f"{name}_{k}": v for k, v in int8_rates.items()})
        kernel["max_abs_err"] = max(kernel["max_abs_err"], err)
        kernel["previous_design_max_abs_err"] = max(
            kernel["previous_design_max_abs_err"], sums["tiled_err"])
        kernel["by_net"][name] = {
            "ms": sums["int8_dwconv"], "previous_design_ms": sums["tiled"],
            "bound_ms": sums["bound"], "plain_ms": sums["plain"],
            "cudnn_bf16_dwconv_ms": sums["cudnn_bf16"],
            "narrow_routes_ms": sums["narrow"],
            "narrow_routes_previous_design_ms": sums["narrow_tiled"],
            "sites": int(sums["sites"]), "shapes": int(sums["shapes"])}
        layouts[f"int8_{name}"] = n_layouts
        for k in totals:
            totals[k] += sums[k]
        for route, r in net_routes.items():
            into = by_route.setdefault(route, dict.fromkeys(r, 0))
            for k, v in r.items():
                into[k] += v
    paths["int8_rsn18_prm"], err = rsn_prm_int8(card, device)
    kernel["max_abs_err"] = max(kernel["max_abs_err"], err)
    train_paths, train_rates = mobile_training(tmp, card, device)
    paths.update(train_paths)
    rates.update(train_rates)
    kernel.update(
        ms=totals["int8_dwconv"], previous_design_ms=totals["tiled"],
        plain_ms=totals["plain"], bound_ms=totals["bound"],
        bound_by=("bytes" if totals["bound_bytes"] >= totals["bound_ops"]
                  else "operations"),
        library_ms=None, cudnn_bf16_dwconv_ms=totals["cudnn_bf16"],
        by_route_ms={r: v["ms"] for r, v in by_route.items()},
        by_route=by_route, narrow_routes_ms=totals["narrow"],
        narrow_routes_previous_design_ms=totals["narrow_tiled"],
        bound_gb=totals["bytes"] / 1e9, tera_ops=totals["ops"] / 1e12,
        per=f"one fold forward (B={2 * SERVE_BATCH}) of each of the "
            f"{len(MOBILE_YAMLS)} mobile yamls: {int(totals['sites'])} "
            f"depthwise sites, {int(totals['shapes'])} shapes",
        layouts_checked_by_path=layouts)
    slower = [n for n, v in kernel["by_net"].items()
              if v["ms"] > v["previous_design_ms"]]
    log(f"[mobile] 12b int8_dwconv over the {int(totals['sites'])} "
        f"depthwise sites of the five fold forwards: "
        f"{totals['int8_dwconv']:.4f} ms against the previous design's "
        f"{totals['tiled']:.4f} in the same turns, "
        f"{totals['int8_dwconv'] / totals['bound']:.2f}x its bound "
        f"{totals['bound']:.4f} ({totals['bytes'] / 1e9:.3f} GB, "
        f"{totals['ops'] / 1e12:.3f} T int8 operations); narrow routes "
        f"{totals['narrow']:.4f} ms (previous design "
        f"{totals['narrow_tiled']:.4f}); plain "
        f"{totals['plain']:.3f}; "
        f"{totals['int8_dwconv'] / totals['cudnn_bf16']:.2f}x the bf16 "
        f"cuDNN depthwise convs {totals['cudnn_bf16']:.4f} ms; nets slower "
        f"than the previous design: {slower or 'none'} | {card}")
    log(f"[mobile] phase 12 {time.perf_counter() - t_phase:.1f} s; "
        f"launches {paths}")
    return paths, kernel, rates, profiles


# ------------------------------------------------------------------ main
# ---------------------------------------------------------------- phase 13
RESUME_TRAIN_IMAGES, RESUME_VAL_IMAGES = 64, 20   # 128 / 40 crops
RESUME_LAYERS = ["conv1", "bn1", "conv2", "bn2", "layer1", "stage4"]
REMAT_STEPS = 6
REMAT_GRAD_TOL = 1e-3            # x each gradient tensor's max |g|


class StepDigests:
    """Each train step's batch as a digest of its u8 images and targets
    (sha1), taken where ``train.run`` uploads it (``core.train.
    upload_batch``, which RSN's upload calls too); with ``kill_at`` set,
    this process sends itself ``SIGTERM`` while that step's batch
    uploads, so that the run's guard stops it after the step."""

    def __init__(self):
        self.seen, self.kill_at = [], None

    def __enter__(self):
        import hashlib
        import signal

        from udp_pose_tpu_torch.core import train as core_train
        self._module, self._upload = core_train, core_train.upload_batch
        upload = self._upload

        def spy(batch, device, keys=("target", "target_weight"), *args):
            h = hashlib.sha1()
            for k in ("image",) + tuple(keys):
                h.update(torch.as_tensor(batch[k]).cpu().contiguous()
                         .numpy().tobytes())
            if self.kill_at == len(self.seen):
                os.kill(os.getpid(), signal.SIGTERM)
            self.seen.append(h.hexdigest())
            return upload(batch, device, keys, *args)

        core_train.upload_batch = spy
        return self

    def __exit__(self, *exc):
        self._module.upload_batch = self._upload

    def take(self):
        seen, self.seen, self.kill_at = self.seen, [], None
        return seen


def max_abs_diff(a, b):
    """max |a - b| over two state dicts' floating tensors."""
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in a if a[k].is_floating_point())


def resume_cfg(root, out_dir, cfg_fn=w32_cfg, **over):
    """13a's w32 run: bf16, B=32, 2 epochs, WORKERS 2, the deterministic
    cuDNN switches (which :func:`phase_resume` sets for the phase),
    writing under ``out_dir``."""
    cfg = train_cfg(root, out_dir, "bfloat16", cfg_fn)
    cfg.WORKERS = 2
    cfg.CUDNN.DETERMINISTIC, cfg.CUDNN.BENCHMARK = True, False
    cfg.merge_from_dict(over)
    os.makedirs(out_dir, exist_ok=True)
    return cfg


def trained_run(path, cfg, train_ds, val_ds, device, guard=None):
    """``train.run`` of a fresh seeded model of ``cfg`` in ``path``'s
    launch window."""
    from udp_pose_tpu_torch import train as train_cli
    from udp_pose_tpu_torch.models import build_model
    model = build_model(cfg, device=device, train=True)
    return path.run(train_cli.run, cfg, model, train_ds, val_ds,
                    cfg.OUTPUT_DIR, device, guard)


def epoch_resume(data, card, device="cuda", cfg_fn=w32_cfg):
    """13a: w32 trained uninterrupted twice (A1, A2); run B, which gets
    ``SIGTERM`` during the second step of epoch 1 and saves a mid-epoch
    checkpoint; run C, which goes on from it with ``AUTO_RESUME``.
    Checks the batches, the weights against A1 within max |A1 - A2|, and
    a save -> load round trip of a w32 train state bit for bit, timed.
    Returns the path's launches."""
    from udp_pose_tpu_torch.utils.preemption import PreemptionGuard
    root, tmp, frames = data["root"], data["tmp"], data["frames"]
    path = PathLaunches("resume")
    runs, digests = {}, StepDigests()
    cfg = resume_cfg(root, os.path.join(tmp, "a1"), cfg_fn)
    B = cfg.TRAIN.BATCH_SIZE_PER_GPU
    train_ds = in_memory_coco(cfg, frames["train2017"], True)
    val_ds = in_memory_coco(cfg, frames["val2017"], False)
    k = len(train_ds) // B
    check(k >= 4, f"{k} steps an epoch")
    t0 = time.perf_counter()
    with digests:
        for name in ("a1", "a2"):
            runs[name] = trained_run(path, resume_cfg(
                root, os.path.join(tmp, name), cfg_fn), train_ds, val_ds,
                device)
            runs[name]["digests"] = digests.take()
        guard = PreemptionGuard()
        digests.kill_at = k + 1
        try:
            runs["b"] = trained_run(path, resume_cfg(
                root, os.path.join(tmp, "b"), cfg_fn), train_ds, val_ds,
                device, guard)
        finally:
            guard.restore()
        runs["b"]["digests"] = digests.take()
        mid = torch.load(os.path.join(tmp, "b", "checkpoint.pth"),
                         map_location="cpu", weights_only=False)
        runs["c"] = trained_run(path, resume_cfg(
            root, os.path.join(tmp, "b"), cfg_fn, AUTO_RESUME=True),
            train_ds, val_ds, device)
        runs["c"]["digests"] = digests.take()
    secs = time.perf_counter() - t0
    a1, b, c = runs["a1"], runs["b"], runs["c"]
    n = 2 * k
    check(len(a1["steps"]) == n and not a1["preempted"]
          and b["preempted"] and len(b["steps"]) == k + 2
          and [s["iteration"] for s in c["steps"]] == list(range(k + 2, n)),
          f"steps: A1 {len(a1['steps'])}, B {len(b['steps'])} (preempted "
          f"{b['preempted']}), C {[s['iteration'] for s in c['steps']]}")
    check(runs["a2"]["digests"] == a1["digests"]
          and b["digests"] + c["digests"] == a1["digests"],
          "the batches of B then C are not A1's")
    check((mid["epoch"], mid["step_in_epoch"], mid["step"]) == (0, 2, k + 2)
          and c["steps"][0]["epoch"] == 1, f"mid-epoch checkpoint: epoch "
          f"{mid['epoch']}, step_in_epoch {mid['step_in_epoch']}, step "
          f"{mid['step']}")
    final = {name: torch.load(os.path.join(tmp, d, "final_state.pth"),
                              map_location="cpu")
             for name, d in (("a1", "a1"), ("a2", "a2"), ("c", "b"))}
    a1_a2 = max_abs_diff(final["a1"], final["a2"])
    c_a1 = max_abs_diff(final["c"], final["a1"])
    check(c_a1 <= a1_a2, f"resumed weights max |C - A1| {c_a1:.3g} > max "
          f"|A1 - A2| {a1_a2:.3g}")
    n_val = sum(len(r["validations"]) for r in runs.values())
    check(n_val == 6, f"{n_val} validations in the four runs")
    eval_batches = -(-len(val_ds) // cfg.TEST.BATCH_SIZE_PER_GPU)
    path.served(n_val * eval_batches, 0)
    check(path.counts == path.want, f"resume: launches {path.counts}, want "
          f"{path.want}")
    log(f"[resume] 13a w32 bf16 B={B} WORKERS 2, cuDNN deterministic, "
        f"{k} steps an epoch x 2: B stopped by SIGTERM after step "
        f"{mid['step']} (epoch {mid['epoch'] + 1}, step_in_epoch "
        f"{mid['step_in_epoch']}), C resumed with AUTO_RESUME at iteration "
        f"{c['steps'][0]['iteration']}; the {n} batch digests of B then C "
        f"= A1's = A2's; final weights max |A1 - A2| = {a1_a2:.6g}, max |C "
        f"- A1| = {c_a1:.6g}; four train.run in {secs:.1f} s; fused decode "
        f"launches {path.counts['udp_offset_decode_fused']} = {n_val} "
        f"validations x {eval_batches} batches | {card}")
    checkpoint_round_trip(cfg, train_ds, card, device)
    return path.counts


def checkpoint_round_trip(cfg, train_ds, card, device="cuda"):
    """13a: a w32 train state after two steps through ``save_checkpoint``
    and ``load_checkpoint`` into a fresh one: the state dict, both Adam
    moments and step counts, the scheduler, the LR and the step bit for
    bit; the file's bytes and the two times."""
    from udp_pose_tpu_torch.core.loss import make_loss_fn
    from udp_pose_tpu_torch.core.train import (create_train_state,
                                               make_train_step, upload_batch)
    from udp_pose_tpu_torch.data.base import epoch_loader
    from udp_pose_tpu_torch.models import build_model
    from udp_pose_tpu_torch.utils import checkpoint as ckpt
    train_ds.seed(0)
    batch = next(epoch_loader(train_ds, cfg.TRAIN.BATCH_SIZE_PER_GPU, seed=0))
    k = len(train_ds) // cfg.TRAIN.BATCH_SIZE_PER_GPU
    model = build_model(cfg, device=device, train=True)
    state = create_train_state(cfg, model, k)
    step_fn = make_train_step(make_loss_fn(cfg))
    for _ in range(2):
        step_fn(state, upload_batch(batch, device))
    out = cfg.OUTPUT_DIR
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save_checkpoint(out, model, state, 0, 0.5, step_in_epoch=2)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(out, ckpt.CHECKPOINT))
    fresh = build_model(cfg, device=device, train=True, seed=1)
    fresh_state = create_train_state(cfg, fresh, k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ckpt.load_checkpoint(out, fresh, fresh_state, device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(got == (1, 0.5, 2), f"load_checkpoint returned {got}")
    sd, fsd = model.state_dict(), fresh.state_dict()
    moments = [(s, fresh_state.optimizer.state[q])
               for p, q in zip(model.parameters(), fresh.parameters())
               for s in [state.optimizer.state[p]]]
    check(all(torch.equal(sd[n], fsd[n]) for n in sd)
          and all(torch.equal(a[m], b[m]) for a, b in moments
                  for m in ("exp_avg", "exp_avg_sq", "step"))
          and fresh_state.scheduler.last_epoch == state.scheduler.last_epoch
          and fresh_state.optimizer.param_groups[0]["lr"]
          == state.optimizer.param_groups[0]["lr"]
          and fresh_state.step == state.step == 2,
          "checkpoint round trip is not bit-exact")
    log(f"[resume] 13a checkpoint.pth of w32 (weights, BN buffers, both "
        f"Adam moments of {len(moments)} tensors, scheduler, step): "
        f"{nbytes} bytes ({nbytes / 1e6:.2f} MB); save_checkpoint "
        f"{save_s:.3f} s, load_checkpoint {load_s:.3f} s "
        f"(map_location {device}); state dict, exp_avg, exp_avg_sq, step "
        f"counts, scheduler last_epoch {state.scheduler.last_epoch}, LR "
        f"{state.optimizer.param_groups[0]['lr']:g} and step bit-equal | "
        f"{card}")
    del model, fresh, state, fresh_state
    torch.cuda.empty_cache()


def rolling_backend(data, card, device="cuda", cfg_fn=w32_cfg):
    """13b: ``TPU.CKPT_BACKEND orbax`` with ``CKPT_MAX_TO_KEEP`` 2 over
    three saves of a w32 train state, a train step between them: the
    time ``save()`` blocks the step loop against the time to commit;
    the last two step directories left; ``load_any``'s tuple and the
    restored state bit for bit."""
    from udp_pose_tpu_torch.core.loss import make_loss_fn
    from udp_pose_tpu_torch.core.train import (create_train_state,
                                               make_train_step, upload_batch)
    from udp_pose_tpu_torch.data.base import epoch_loader
    from udp_pose_tpu_torch.models import build_model
    from udp_pose_tpu_torch.utils.orbax_ckpt import OrbaxBackend, load_any
    cfg = resume_cfg(data["root"], os.path.join(data["tmp"], "rolling"),
                     cfg_fn, TPU={"CKPT_BACKEND": "orbax",
                                  "CKPT_MAX_TO_KEEP": 2})
    train_ds = in_memory_coco(cfg, data["frames"]["train2017"], True)
    train_ds.seed(0)
    batch = next(epoch_loader(train_ds, cfg.TRAIN.BATCH_SIZE_PER_GPU, seed=0))
    model = build_model(cfg, device=device, train=True)
    state = create_train_state(cfg, model, 4)
    step_fn = make_train_step(make_loss_fn(cfg))
    backend = OrbaxBackend(cfg.OUTPUT_DIR, cfg.TPU.CKPT_MAX_TO_KEEP)
    block_ms, commit_ms, step_ms = [], [], []
    for n in range(3):
        t0 = time.perf_counter()
        step_fn(state, upload_batch(batch, device))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        backend.save(model, state, {"epoch": n, "perf": 0.25 * n,
                                    "step_in_epoch": n})
        t2 = time.perf_counter()
        backend.wait()
        t3 = time.perf_counter()
        step_ms.append((t1 - t0) * 1e3)
        block_ms.append((t2 - t1) * 1e3)
        commit_ms.append((t3 - t1) * 1e3)
    check(backend.steps() == [2, 3] and sorted(os.listdir(backend.root))
          == ["2", "3"], f"step directories {os.listdir(backend.root)}")
    fresh = build_model(cfg, device=device, train=True, seed=1)
    fresh_state = create_train_state(cfg, fresh, 4)
    got = load_any(backend, fresh, fresh_state, False, device)
    sd, fsd = model.state_dict(), fresh.state_dict()
    check(got == (3, 0.5, 2) and fresh_state.step == 3
          and all(torch.equal(sd[k], fsd[k]) for k in sd),
          f"load_any returned {got}, step {fresh_state.step}")
    log(f"[resume] 13b rolling backend (TPU.CKPT_BACKEND orbax, "
        f"CKPT_MAX_TO_KEEP 2), three saves of the w32 train state, a train "
        f"step before each ({', '.join(f'{v:.1f}' for v in step_ms)} ms): "
        f"save() blocks {', '.join(f'{v:.1f}' for v in block_ms)} ms, "
        f"committed {', '.join(f'{v:.1f}' for v in commit_ms)} ms after "
        f"save() began; step directories left {backend.steps()}; load_any "
        f"-> {got}, the restored state dict bit-equal | {card}")
    del model, fresh, state, fresh_state
    torch.cuda.empty_cache()


def rsn_resume(data, card, device="cuda", yaml=RSN18_YAML):
    """13c: ``rsn18`` (bf16, B=32, WORKERS 2, deterministic cuDNN) in
    iteration mode for 6 iterations, 4 an epoch, checkpoints every 2:
    uninterrupted (A), then stopped by ``SIGTERM`` during iteration 4
    (B) and resumed from ``iter-last.pth`` (C).  The batch digests of B
    then C are A's; C runs the one iteration left.  Returns the path's
    launches."""
    from udp_pose_tpu_torch.utils.preemption import PreemptionGuard
    root, tmp, frames = data["root"], data["tmp"], data["frames"]
    path = PathLaunches("rsn_iteration_resume")

    def cfg_for(name, **over):
        cfg = rsn_data_cfg(yaml, "bfloat16", root, os.path.join(tmp, name))
        cfg.merge_from_dict({"WORKERS": 2, "CUDNN": {
            "DETERMINISTIC": True, "BENCHMARK": False}, "TRAIN": {
            "MAX_ITER": 6, "CHECKPOINT_PERIOD": 2, "WARMUP_ITERS": 2,
            "ITER_BASELINE_DEVICES": 1}, **over})
        return cfg

    cfg = cfg_for("rsn_a")
    train_ds = in_memory_rsn(cfg, frames["train2017"], True)
    val_ds = in_memory_rsn(cfg, frames["val2017"], False)
    digests = StepDigests()
    with digests:
        a = trained_run(path, cfg, train_ds, val_ds, device)
        want = digests.take()
        guard = PreemptionGuard()
        digests.kill_at = 4
        try:
            b = trained_run(path, cfg_for("rsn_b"), train_ds, val_ds,
                            device, guard)
        finally:
            guard.restore()
        got = digests.take()
        c = trained_run(path, cfg_for("rsn_b", AUTO_RESUME=True), train_ds,
                        val_ds, device)
        got += digests.take()
    check([s["iteration"] for s in a["steps"]] == list(range(6))
          and b["preempted"] and len(b["steps"]) == 5
          and [s["iteration"] for s in c["steps"]] == [5]
          and os.readlink(os.path.join(tmp, "rsn_b", "iter-last.pth"))
          == "iter-5.pth", f"iterations: A {len(a['steps'])}, B "
          f"{len(b['steps'])}, C {[s['iteration'] for s in c['steps']]}")
    check(got == want, "the batches of B then C are not A's")
    check(path.counts == path.want, f"rsn resume: launches {path.counts}")
    last = {name: torch.load(os.path.join(tmp, name, "iter-last.pth"),
                             map_location="cpu", weights_only=False)
            for name in ("rsn_a", "rsn_b")}
    diff = max_abs_diff(last["rsn_b"]["state_dict"],
                        last["rsn_a"]["state_dict"])
    B = cfg.TRAIN.BATCH_SIZE_PER_GPU
    log(f"[resume] 13c rsn18 bf16 B={B} WORKERS 2 iteration mode, 6 "
        f"iterations of {len(train_ds)} samples ({len(train_ds) // B} an "
        f"epoch): B stopped by SIGTERM after iteration 4 (iter-4.pth), C "
        f"resumed from iter-last.pth past epoch 0 and one batch of epoch 1 "
        f"and ran iteration 5; the 6 batch digests of B then C = A's; "
        f"iter-5.pth weights max |C - A| = {diff:.6g} | {card}")
    return path.counts


def remat_step(data, card, device="cuda", yaml=RSN18_YAML,
               n_steps=REMAT_STEPS):
    """13d: ``rsn18`` train steps at B=32 (bf16 autocast, deterministic
    cuDNN) with and without ``TPU.REMAT`` from the same init and batch:
    the first step's loss bit-equal and every gradient within
    ``REMAT_GRAD_TOL`` of its tensor's max (max |Δ| printed); each
    side's peak memory and median step time."""
    from udp_pose_tpu_torch.core.rsn import (create_rsn_train_state,
                                             make_rsn_train_step,
                                             upload_rsn_batch)
    from udp_pose_tpu_torch.data.base import epoch_loader
    from udp_pose_tpu_torch.models import build_model
    cfg = rsn_data_cfg(yaml, "bfloat16", data["root"],
                       os.path.join(data["tmp"], "remat"))
    train_ds = in_memory_rsn(cfg, data["frames"]["train2017"], True)
    train_ds.seed(0)
    batch = next(epoch_loader(train_ds, cfg.TRAIN.BATCH_SIZE_PER_GPU,
                              seed=0))
    sides = {}
    for remat in (False, True):
        cfg.TPU.REMAT = remat
        model = build_model(cfg, device=device, train=True)
        state = create_rsn_train_state(cfg, model, 1e-3, 100, 10)
        step_fn = make_rsn_train_step(cfg.MODEL.EXTRA.get("STAGE_NUM", 1))
        up = upload_rsn_batch(batch, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        secs, loss, grads = [], None, None
        for i in range(n_steps):
            t0 = time.perf_counter()
            m = step_fn(state, up)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if i == 0:
                loss = m["loss"].clone()
                grads = {k: p.grad.double().cpu()
                         for k, p in model.named_parameters()}
        # the steps' own peak: above what the process held before them
        # (the model, its batch, and what earlier phases left allocated)
        sides[remat] = (loss, grads,
                        (torch.cuda.max_memory_allocated() - before) / 1e9,
                        np.median(secs[1:]) * 1e3)
        del model, state, up
        torch.cuda.empty_cache()
    (l0, g0, mem0, ms0), (l1, g1, mem1, ms1) = sides[False], sides[True]
    dg = max(float((g1[k] - g0[k]).abs().max()) for k in g0)
    rel = max(float((g1[k] - g0[k]).abs().max()
                    / max(float(g0[k].abs().max()), 1e-30)) for k in g0)
    check(torch.equal(l0, l1) and rel <= REMAT_GRAD_TOL,
          f"remat step: loss {float(l0)} vs {float(l1)}, gradients max "
          f"|Δ| {dg:.3g} ({rel:.3g} of a tensor's max)")
    log(f"[resume] 13d rsn18 bf16 B={len(batch['image'])} train step, "
        f"cuDNN deterministic: loss bit-equal ({float(l0):.6g}); "
        f"gradients max |Δ| {dg:.6g} ({rel:.3g} of a tensor's max |g|, "
        f"{len(g0)} tensors); peak max_memory_allocated above the "
        f"allocation before the steps {mem0:.3f} GB plain, {mem1:.3f} GB "
        f"with TPU.REMAT ({mem1 / mem0:.3f}x); median step {ms0:.2f} ms plain, "
        f"{ms1:.2f} ms with TPU.REMAT ({ms1 / ms0:.3f}x) over "
        f"{n_steps - 1} steps after the first | {card}")


def pretrained_graft(data, card, device="cuda", cfg_fn=w32_cfg):
    """13e: a backbone-only ``.pth`` of a seeded w32 grafted onto a fresh
    one with ``PRETRAINED_LAYERS`` naming a subset: the grafted keys equal
    the file, every other key (``stage4.2.fuse_layers`` among them) the
    fresh init; then one train step."""
    from udp_pose_tpu_torch.core.loss import make_loss_fn
    from udp_pose_tpu_torch.core.train import (create_train_state,
                                               make_train_step, upload_batch)
    from udp_pose_tpu_torch.data.base import epoch_loader
    from udp_pose_tpu_torch.models import build_model
    from udp_pose_tpu_torch.utils.checkpoint import load_pretrained
    cfg = resume_cfg(data["root"], os.path.join(data["tmp"], "pretrained"),
                     cfg_fn)
    cfg.MODEL.EXTRA.PRETRAINED_LAYERS = RESUME_LAYERS
    source = {k: v.cpu() for k, v in build_model(
        cfg, device=device, train=True, seed=5).state_dict().items()
        if not k.startswith("final_layer")}
    file = os.path.join(cfg.OUTPUT_DIR, "backbone.pth")
    torch.save(source, file)
    model = build_model(cfg, device=device, train=True)
    fresh = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    n = load_pretrained(model, file, cfg)
    secs = time.perf_counter() - t0
    got = {k: v.cpu() for k, v in model.state_dict().items()}
    grafted = [k for k in source if k.split(".")[0] in RESUME_LAYERS
               and "stage4.2.fuse_layers" not in k
               and not k.endswith("num_batches_tracked")]
    kept = [k for k in got if k not in grafted]
    check(n == len(grafted) and any("stage4.2.fuse_layers" in k
                                    for k in kept)
          and all(torch.equal(got[k], source[k]) for k in grafted)
          and all(torch.equal(got[k], fresh[k]) for k in kept),
          f"graft of {n} leaves is not the file's subset over the fresh "
          "init")
    train_ds = in_memory_coco(cfg, data["frames"]["train2017"], True)
    train_ds.seed(0)
    batch = next(epoch_loader(train_ds, cfg.TRAIN.BATCH_SIZE_PER_GPU, seed=0))
    state = create_train_state(cfg, model, 4)
    loss = float(make_train_step(make_loss_fn(cfg))(
        state, upload_batch(batch, device))["loss"])
    check(np.isfinite(loss), f"loss {loss} after the graft")
    log(f"[resume] 13e MODEL.PRETRAINED: a backbone-only w32 .pth "
        f"({len(source)} keys) with PRETRAINED_LAYERS {RESUME_LAYERS}: "
        f"{n} leaves grafted in {secs:.3f} s, each equal to the file; the "
        f"other {len(kept)} keys (stage4.2.fuse_layers among them) equal "
        f"the fresh init; one train step, loss {loss:.6g} | {card}")
    del model, state
    torch.cuda.empty_cache()


def msgpack_serving(data, card, device="cuda", cfg_fn=w32_cfg,
                    batch=SERVE_BATCH):
    """13f: the seeded w32 weights written as a ``.msgpack`` of flax
    variables by the port's own writer and as a ``.pth``, each loaded
    into ``UdpPosePipeline`` (bf16, flip folded): keypoints and scores of
    ``batch`` crops bit for bit.  Returns the path's launches."""
    from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
    from udp_pose_tpu_torch.models import build_model
    from udp_pose_tpu_torch.utils.checkpoint import save_weights
    from udp_pose_tpu_torch.utils.convert import write_msgpack_weights
    cfg = cfg_fn("bfloat16")
    model = build_model(cfg, device=device, train=True, seed=4)
    files = {ext: os.path.join(data["tmp"], f"w32{ext}")
             for ext in (".msgpack", ".pth")}
    t0 = time.perf_counter()
    write_msgpack_weights(files[".msgpack"], model.state_dict(), cfg)
    write_s = time.perf_counter() - t0
    save_weights(files[".pth"], model)
    crops, center, scale = random_crops(batch, cfg, seed=13)
    path = PathLaunches("msgpack_serving")
    out, load_s = {}, {}
    for ext, f in files.items():
        t0 = time.perf_counter()
        pipe = UdpPosePipeline(cfg, weights=f, device=device)
        load_s[ext] = time.perf_counter() - t0
        out[ext] = path.run(pipe.infer_crops, crops, center, scale)
        path.served(1, 0)
        del pipe
    check(path.counts == path.want, f"msgpack serving: launches "
          f"{path.counts}")
    (kp_m, sc_m), (kp_p, sc_p) = out[".msgpack"], out[".pth"]
    check(np.array_equal(kp_m, kp_p) and np.array_equal(sc_m, sc_p)
          and np.isfinite(kp_m).all(), "msgpack keypoints != the .pth's")
    log(f"[resume] 13f msgpack weights: the seeded w32 written as flax "
        f"variables by utils/msgpack ({os.path.getsize(files['.msgpack'])} "
        f"bytes in {write_s:.3f} s) and as .pth "
        f"({os.path.getsize(files['.pth'])} bytes); UdpPosePipeline built "
        f"and loaded in {load_s['.msgpack']:.3f} / {load_s['.pth']:.3f} s; "
        f"keypoints and scores of {batch} crops (bf16, flip folded) "
        f"bit-equal; fused decode launches "
        f"{path.counts['udp_offset_decode_fused']} | {card}")
    del model
    torch.cuda.empty_cache()
    return path.counts


def debug_images(data, card, device="cuda", cfg_fn=w32_cfg):
    """13g: one epoch of w32 with ``DEBUG.DEBUG`` and every
    ``DEBUG.SAVE_*`` switch, ``PRINT_FREQ`` 2, WORKERS 2: the
    ``train_<e>_<i>`` and ``val_<n>`` images written.  Returns the path's
    launches."""
    cfg = resume_cfg(data["root"], os.path.join(data["tmp"], "debug"),
                     cfg_fn, PRINT_FREQ=2, TRAIN={"END_EPOCH": 1}, DEBUG={
                         "DEBUG": True, "SAVE_BATCH_IMAGES_GT": True,
                         "SAVE_BATCH_IMAGES_PRED": True,
                         "SAVE_HEATMAPS_GT": True,
                         "SAVE_HEATMAPS_PRED": True})
    train_ds = in_memory_coco(cfg, data["frames"]["train2017"], True)
    val_ds = in_memory_coco(cfg, data["frames"]["val2017"], False)
    path = PathLaunches("debug_images")
    trained_run(path, cfg, train_ds, val_ds, device)
    eval_batches = -(-len(val_ds) // cfg.TEST.BATCH_SIZE_PER_GPU)
    path.served(eval_batches, 0)
    check(path.counts == path.want, f"debug: launches {path.counts}")
    want = [f"{p}_{s}.jpg" for p in ("train_0_0", "train_0_2", "val_0")
            for s in ("gt", "pred", "hm_gt", "hm_pred")]
    sizes = {n: os.path.getsize(os.path.join(cfg.OUTPUT_DIR, n))
             for n in want if os.path.exists(os.path.join(cfg.OUTPUT_DIR, n))}
    check(sorted(sizes) == sorted(want) and min(sizes.values()) > 0,
          f"debug images {sorted(sizes)}, want {want}")
    log(f"[resume] 13g DEBUG.DEBUG: one epoch wrote {len(sizes)} images "
        f"({', '.join(want[:4])} ...; {sum(sizes.values())} bytes) | {card}")
    return path.counts


def phase_resume(tmp, device="cuda", cfg_fn=w32_cfg, rsn_yaml=RSN18_YAML,
                 n_train=RESUME_TRAIN_IMAGES, n_val=RESUME_VAL_IMAGES):
    """Phase 13: checkpoints, resume, preemption and weight I/O at full
    width on a seeded synthetic mini-COCO in memory (13a-13g).  Returns
    the launches by path."""
    card = card_line()
    t_phase = time.perf_counter()
    rng = np.random.default_rng(41)
    root = os.path.join(tmp, "coco")
    data = {"root": root, "tmp": tmp, "frames": {
        "train2017": synthetic_coco(root, "train2017", n_train, rng),
        "val2017": synthetic_coco(root, "val2017", n_val, rng)}}
    # the runs' CUDNN switches (train.main's set_cudnn), for this phase
    # only: the phases after it compare results of repeated calls
    flags = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    parts = (("13a", "resume", epoch_resume, cfg_fn),
             ("13b", None, rolling_backend, cfg_fn),
             ("13c", "rsn_iteration_resume", rsn_resume, rsn_yaml),
             ("13d", None, remat_step, rsn_yaml),
             ("13e", None, pretrained_graft, cfg_fn),
             ("13f", "msgpack_serving", msgpack_serving, cfg_fn),
             ("13g", "debug_images", debug_images, cfg_fn))
    paths, secs = {}, {}
    try:
        for part, name, fn, arg in parts:
            t0 = time.perf_counter()
            launches = fn(data, card, device, arg)
            secs[part] = time.perf_counter() - t0
            if name is not None:
                paths[name] = launches
    finally:
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = flags
    log(f"[resume] phase 13 {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{p} {v:.1f}" for p, v in secs.items()) + " s)")
    return paths


# ---------------------------------------------------------------- phase 14
SERVE_PERSONS = (1, 8, 64)       # 14a: persons a frame, timed
RSN_PERSONS = 64                 # 14c: persons a frame, one bucket


def person_boxes(n, seed, hw=DETECT_HW):
    """``n`` seeded xyxy person boxes on an (H, W) frame, some of them
    reaching past its edges."""
    rng = np.random.default_rng(seed)
    H, W = hw
    x1 = rng.uniform(-0.05 * W, 0.85 * W, n)
    y1 = rng.uniform(-0.05 * H, 0.6 * H, n)
    return np.stack([x1, y1, x1 + rng.uniform(0.04, 0.2, n) * W,
                     y1 + rng.uniform(0.2, 0.45, n) * H], 1).astype(np.float32)


def card_crops(card, device="cuda", cfg_fn=w32_cfg, persons=SERVE_PERSONS,
               n_check=8, iters=10, hw=DETECT_HW):
    """14a: ``UdpPosePipeline.infer_pose`` with the crops warped on the
    card.  fp32 with TF32 off on ``n_check`` persons of one frame, a
    pipeline on the card and one on the CPU with the same weights: the
    crop matrices to MAT_REL_TOL, the card's crops against the CPU's
    ``crop_boxes`` from the card's matrices to CROP_ATOL, the CPU's pose
    stage on the card's crops as in 8c (:func:`pose_stage_errors`), and
    the card's one decode bit-equal to its plain version.  Then bf16: one
    call at each of ``persons`` in a window of the path's launches (one
    fused decode a call), and the latency of a call beside the host-crop
    path (``host_crops`` + ``infer_crops``) in turns card, host, host,
    card.  Returns (the path's launches, {persons: (card ms, host ms)})."""
    from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
    from udp_pose_tpu_torch.engine.server import host_crops
    from udp_pose_tpu_torch.ops import affine
    frame = detect_frames(1, seed=140, hw=hw)[0]
    boxes = person_boxes(n_check, 141, hw)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    set_tf32(False)
    pipe = UdpPosePipeline(cfg_fn("float32"), device=device, seed=0)
    cpu = UdpPosePipeline(cfg_fn("float32"), device="cpu", weights={
        k: v.cpu() for k, v in pipe.model.state_dict().items()})
    runs = {}
    for dev, p in ((device, pipe), ("cpu", cpu)):
        with CallRecorder(p, "crop_frame") as crop, DecodeRecorder() as dec:
            kp, sc = p.infer_pose(frame, boxes)
        check(len(crop.calls) == 1, f"14a {dev}: {len(crop.calls)} crop "
              "calls for one infer_pose")
        runs[dev] = (kp, sc, crop.calls[0], dec.calls)
    (kp, _, (_, center, scale, crops), dec_calls), (kp_cpu, _, crop_cpu,
                                                   _) = (runs[device],
                                                         runs["cpu"])
    shape = check_decode_calls(dec_calls, n_check, "14a infer_pose")
    w, h = pipe.input_wh
    mats = affine.classic_affine_matrix(
        torch.as_tensor(center, device=device),
        torch.as_tensor(scale, device=device), 0.0, (w, h), inv=True).cpu()
    mats_cpu = affine.classic_affine_matrix(
        torch.as_tensor(center), torch.as_tensor(scale), 0.0, (w, h),
        inv=True)
    mat_err = float((mats - mats_cpu).abs().max())
    mat_max = float(mats_cpu.abs().max())
    crops = crops.cpu()
    crop_err = float((crops - affine.crop_boxes(
        torch.from_numpy(frame), mats, (h, w))).abs().max())
    crop_e2e = float((crops - crop_cpu[3]).abs().max())
    with DecodeRecorder() as dec:
        p_cpu = cpu.infer_fn(crops, center, scale)[0]
    hm_err, hm_max, agree, clear, margin, over, kp_max, kp_limit = (
        pose_stage_errors(dec_calls[0][0], dec.calls[0][0], dec_calls[0][2],
                          dec.calls[0][2], torch.from_numpy(kp), p_cpu,
                          scale))
    kp_e2e = float(np.abs(kp - kp_cpu).max())
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags
    log(f"[serve] 14a infer_pose, crops on the card, w32 fp32 TF32 off, "
        f"{n_check} persons of one {hw[0]}p frame (boxes past its edges): "
        f"one decode {shape} bit-equal to its plain version; crop matrices "
        f"card vs CPU {mat_err:.3g} apart (limit {MAT_REL_TOL:g} x "
        f"{mat_max:.3g}); card crops vs the CPU's crop_boxes from the same "
        f"matrices {crop_err:.3g} (limit {CROP_ATOL:.3g} of 255), vs the "
        f"CPU pipeline's own {crop_e2e:.3g}; the CPU's pose stage on the "
        f"card's crops: heatmaps {hm_err:.3g} (limit {HEATMAP_REL_TOL:g} x "
        f"{hm_max:.3g}), peaks equal on {int((agree & clear).sum())} of the "
        f"{int(clear.sum())} maps with a top-2 margin > {margin:.3g}, "
        f"keypoints {kp_max:.3g} px apart where the peaks agree, "
        f"{int(over.sum())} over their limit (at most "
        f"{float(kp_limit.max()):.3g} px); each pipeline its own crops: "
        f"keypoints {kp_e2e:.3g} px apart | {card}")
    check(mat_err <= MAT_REL_TOL * mat_max, "14a crop matrices: card vs CPU "
          "over the limit")
    check(crop_err <= CROP_ATOL, "14a crops: card vs the CPU's crop_boxes "
          "from the same matrices over the limit")
    check(hm_err <= HEATMAP_REL_TOL * hm_max, "14a heatmaps: card vs CPU "
          "over the limit")
    check(bool(agree[clear].all()), "14a: maps with a clear top-2 margin "
          "peak elsewhere on the card than on the CPU")
    check(not bool(over.any()), "14a keypoints: card vs CPU over the limit "
          "where the peaks agree")
    del pipe, cpu, runs
    torch.cuda.empty_cache()

    pipe = UdpPosePipeline(cfg_fn("bfloat16"), device=device, seed=0)
    path = PathLaunches("infer_pose_card_crops")
    times = {}
    for n in persons:
        b = person_boxes(n, 142 + n, hw)
        kp, sc = path.run(pipe.infer_pose, frame, b)
        path.served(1, 0)
        check(kp.shape == (n, pipe.num_joints, 2) and np.isfinite(kp).all()
              and np.isfinite(sc).all(), f"14a: {n} persons -> keypoints "
              f"{kp.shape}, finite {np.isfinite(kp).all()}")
        fns = {"card": lambda: pipe.infer_pose(frame, b),
               "host": lambda: pipe.infer_crops(*host_crops(
                   frame, b, pipe.input_wh))}
        got = {k: [] for k in fns}
        for k in ("card", "host", "host", "card"):
            got[k].append(host_ms(fns[k], iters))
        times[n] = tuple(float(np.mean(got[k])) for k in ("card", "host"))
        log(f"[serve] 14a w32 bf16 flip, {n} persons of a {hw[0]}p frame: "
            f"infer_pose (crops on the card) {times[n][0]:.2f} ms, the "
            f"host-crop path (native warp, u8) {times[n][1]:.2f} ms "
            f"(mean of 2 turns of {iters} calls each) | {card}")
    check(path.counts == path.want, f"14a infer_pose: launches "
          f"{path.counts}, want {path.want}")
    del pipe
    torch.cuda.empty_cache()
    return path.counts, times


def pad_on_device_http(card, device="cuda", cfg_fn=w32_cfg, n_requests=4,
                       hw=DETECT_HW):
    """14b: ``/v1/pose`` of a server with ``pad_on_device`` and one
    without, same weights: ``n_requests`` concurrent requests to the
    first in a window of its launches (one decode a batch), then each
    request alone to both: keypoints and scores of the two within 1e-3,
    and the crop bytes each batch uploaded (``CropBatcher.upload_log``):
    the real rows with the flag, the whole bucket without.  Returns the
    path's launches."""
    from udp_pose_tpu_torch.engine.pose_engine import _next_bucket
    from udp_pose_tpu_torch.engine.server import PoseServer, PoseService
    services = {on: PoseService(cfg_fn("bfloat16"), device=device, seed=0,
                                window_ms=50.0, pad_on_device=on)
                for on in (False, True)}
    servers = {on: PoseServer(s, host="127.0.0.1", port=0)
               for on, s in services.items()}
    threads = [s.serve_in_thread() for s in servers.values()]
    path = PathLaunches("pose_serving_pad_on_device")
    try:
        reqs = requests_for(n_requests, hw, seed=17)
        results = [None] * n_requests
        gate = threading.Barrier(n_requests)

        def client(i):
            gate.wait()
            results[i] = post_pose(servers[True].port, *reqs[i])

        def concurrent():
            clients = [threading.Thread(target=client, args=(i,))
                       for i in range(n_requests)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=600)
            check(not any(c.is_alive() for c in clients), "a client hung")

        path.run(concurrent)
        batches = services[True].batcher.log_snapshot()
        path.served(len(batches), 0)
        check(all(r[0] == 200 for r in results), f"14b: /v1/pose answered "
              f"{[r[0] for r in results]}")
        check(path.counts == path.want, f"14b pad_on_device: launches "
              f"{path.counts}, want {path.want} ({len(batches)} batches)")
        logs = {on: len(s.batcher.upload_log) for on, s in services.items()}
        worst, lat = 0.0, {False: [], True: []}
        for frame, boxes in reqs:
            bodies = {}
            for on in (False, True):
                status, body, secs = post_pose(servers[on].port, frame, boxes)
                check(status == 200, f"14b: /v1/pose answered {status}")
                bodies[on] = body
                lat[on].append(secs * 1e3)
            worst = max(worst, *(float(np.abs(
                np.asarray(bodies[True][k]) - bodies[False][k]).max())
                for k in ("keypoints", "scores")))
        w, h = services[True].pipe.input_wh
        row = w * h * 3
        up = {on: list(s.batcher.upload_log)[logs[on]:]
              for on, s in services.items()}
        want = {True: [len(b) * row for _, b in reqs],
                False: [_next_bucket(len(b)) * row for _, b in reqs]}
        log(f"[serve] 14b /v1/pose --pad-on-device, {n_requests} concurrent "
            f"{hw[0]}p requests ({[len(b) for _, b in reqs]} boxes): all "
            f"200 in batches {list(batches)}, launches {path.counts}; each "
            f"alone to both servers: keypoints and scores {worst:.3g} "
            f"apart; crop bytes uploaded a batch {up[True]} with the flag, "
            f"{up[False]} without; latency "
            f"{[round(v, 1) for v in lat[True]]} ms with, "
            f"{[round(v, 1) for v in lat[False]]} ms without | {card}")
        check(worst <= 1e-3, "14b: --pad-on-device answers != host tiling")
        check(up == want, f"14b upload bytes {up}, want {want}")
    finally:
        for s in servers.values():
            s.shutdown()
        for t in threads:
            t.join(timeout=30)
    del services, servers
    torch.cuda.empty_cache()
    return path.counts


def rsn_pipeline(card, device="cuda", yaml=RSN18_YAML, persons=RSN_PERSONS,
                 iters=10, hw=DETECT_HW):
    """14c: ``rsn18_256x192`` uncut through ``UdpPosePipeline`` in bf16
    and in int8 (self-calibrating on its first frame): ``infer_pose``
    (crops on the card) and ``infer_crops`` (the batcher's host crops) of
    ``persons`` persons against ``make_rsn_infer_fn`` of the same model
    on the same crops in BGR order, keypoints to RSN_KP_ATOL px, each
    call in a window of its path's launches: no fused decode, and in
    int8 one ``int8_conv_fused`` launch a conv site (one forward a batch,
    the flip folded), the Hopper engine among them.  Crops/s of
    ``infer_pose``.  Returns ({path: launches}, {dtype: crops/s})."""
    from udp_pose_tpu_torch.core.rsn import make_rsn_infer_fn_from_cfg
    from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
    from udp_pose_tpu_torch.engine.server import host_crops
    from udp_pose_tpu_torch.models.quantize import (Int8Conv2d,
                                                    Int8DepthwiseConv2d)
    from udp_pose_tpu_torch.ops.boxes import xyxy_to_cs
    cfg = yaml_cfg(yaml, "bfloat16")
    frame = detect_frames(1, seed=150, hw=hw)[0]
    boxes = person_boxes(persons, 151, hw)
    center, scale = xyxy_to_cs(boxes, cfg.MODEL.IMAGE_SIZE)
    paths, rates = {}, {}
    for mode in ("", "int8"):
        name = "rsn18_int8_pipeline" if mode else "rsn18_pipeline"
        pipe = UdpPosePipeline(cfg, device=device, seed=0, quantize=mode,
                               calib_batches=1)
        host = host_crops(frame, boxes, pipe.input_wh)
        if mode:
            pipe.infer_pose(frame, boxes)         # calibrates, serves bf16
            check(pipe.int8.table is not None, "14c: no int8 table")
        path = PathLaunches(name)
        got = {"infer_pose": path.run(pipe.infer_pose, frame, boxes),
               "batcher crops": path.run(pipe.infer_crops, *host)}
        model = pipe.int8.active()
        sites = [sum(isinstance(m, k) for m in model.modules())
                 for k in (Int8Conv2d, Int8DepthwiseConv2d)]
        path.served(0, 2 * sites[0], 2 * sites[1])
        ref = make_rsn_infer_fn_from_cfg(model, cfg, pipe.flip_pairs)
        crops = {"infer_pose": pipe.crop_frame(frame, center, scale),
                 "batcher crops": host[0]}
        errs = {}
        for k, x in crops.items():
            bgr = x.flip(-1) if torch.is_tensor(x) else x[..., ::-1].copy()
            preds, maxvals, _ = ref(bgr, center, scale)
            errs[k] = (float(np.abs(got[k][0] - preds.cpu().numpy()).max()),
                       float(np.abs(got[k][1] - maxvals.cpu().numpy()).max()))
        if mode:
            path.check(engine=True)
        else:
            check(path.counts == path.want, f"14c {name}: launches "
                  f"{path.counts}")
        ms = float(np.median([host_ms(lambda: pipe.infer_pose(
            frame, boxes), iters) for _ in range(3)]))
        rates[mode or "bf16"] = persons / ms * 1e3
        log(f"[serve] 14c {os.path.basename(yaml)} {mode or 'bf16'} through "
            f"UdpPosePipeline, {persons} persons of a {hw[0]}p frame: "
            f"keypoints, scores vs make_rsn_infer_fn on the same BGR crops "
            + ", ".join(f"{k} {a:.3g} px, {b:.3g}" for k, (a, b) in
                        errs.items())
            + f" (limit {RSN_KP_ATOL:g} px); {sites[0]} int8 conv sites, "
            f"{sites[1]} depthwise; launches {path.counts}; infer_pose "
            f"{ms:.2f} ms (median of 3 runs of {iters} calls) = "
            f"{rates[mode or 'bf16']:.1f} crops/s | {card}")
        check(max(a for a, _ in errs.values()) <= RSN_KP_ATOL,
              f"14c {name}: keypoints != make_rsn_infer_fn's")
        check(all(np.isfinite(g[0]).all() for g in got.values()),
              f"14c {name}: non-finite keypoints")
        paths[name] = path.counts
        del pipe, model, ref
        torch.cuda.empty_cache()
    log(f"[serve] 14c rsn18 int8 / bf16 crops/s "
        f"{rates['int8'] / rates['bf16']:.3f} | {card}")
    return paths, rates


def serve_cli(tmp, card, yaml, weights, frame, boxes, device="cuda"):
    """``python -m udp_pose_tpu_torch.serve --cfg yaml --weights weights
    --pad-on-device --port 0`` in a process of its own: one ``/v1/pose``
    request, its answer against ``UdpPosePipeline`` with the same weights
    on the request's host crops (1e-3), then SIGTERM.  Returns the
    seconds from the start to the answer."""
    import signal
    from udp_pose_tpu_torch.config import load_config
    from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
    from udp_pose_tpu_torch.engine.server import host_crops
    err_path = os.path.join(tmp, "serve_cli.err")
    t0 = time.perf_counter()
    with open(err_path, "w") as err_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "udp_pose_tpu_torch.serve", "--cfg", yaml,
             "--weights", weights, "--pad-on-device", "--port", "0",
             "--device", device], cwd=REPO, stdout=subprocess.PIPE,
            stderr=err_file, text=True)
    try:
        line = proc.stdout.readline()
        if not line.startswith("serving on http://"):
            proc.wait(timeout=30)
            with open(err_path) as f:
                check(False, f"serve CLI printed {line!r}, exit "
                      f"{proc.returncode}: {f.read()[-1500:]}")
        port = int(line.strip().rsplit(":", 1)[1])
        status, body, _ = post_pose(port, frame, boxes)
        secs = time.perf_counter() - t0
        check(status == 200, f"serve CLI /v1/pose answered {status}: {body}")
        status, state = get(port, "/healthz")
        state = json.loads(state)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    pipe = UdpPosePipeline(load_config(yaml), weights=weights, device=device)
    kp, sc = pipe.infer_crops(*host_crops(frame, boxes, pipe.input_wh))
    err = max(float(np.abs(kp - body["keypoints"]).max()),
              float(np.abs(sc - body["scores"]).max()))
    log(f"[serve] 14d serve CLI --cfg {os.path.basename(yaml)} --weights "
        f"{os.path.basename(weights)} --pad-on-device: /healthz model "
        f"{state['model']} on {state['device']}; {len(boxes)} boxes "
        f"answered in {secs:.1f} s from the process's start; vs "
        f"UdpPosePipeline on the host crops {err:.3g} apart | {card}")
    check(state["model"] == "rsn" and state["platform"] == device,
          f"serve CLI /healthz {state}")
    check(err <= 1e-3, "14d serve CLI answer != UdpPosePipeline's")
    del pipe
    return secs


def infer_cli(tmp, card, yaml, weights, frame, device="cuda"):
    """``python -m udp_pose_tpu_torch.infer`` (in this process) with no
    detector, so one box covers the frame, and ``--save-pose-txt``: the
    label file's keypoints and scores against ``UdpPosePipeline.
    infer_pose`` of the same weights (the file's six decimals)."""
    import cv2
    from udp_pose_tpu_torch import infer as infer_cli_mod
    from udp_pose_tpu_torch.config import load_config
    from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
    src = os.path.join(tmp, "infer_src")
    out = os.path.join(tmp, "infer_out")
    os.makedirs(src, exist_ok=True)
    cv2.imwrite(os.path.join(src, "f.png"), frame[..., ::-1])
    infer_cli_mod.main(["--source", src, "--pose-cfg", yaml, "--pose-weights",
                        weights, "--save-dir", out, "--save-pose-txt",
                        "--device", device])
    got = np.loadtxt(os.path.join(out, "f.txt"), ndmin=2)
    H, W = frame.shape[:2]
    pipe = UdpPosePipeline(load_config(yaml), weights=weights, device=device)
    kp, sc = pipe.infer_pose(frame, np.array([[0, 0, W - 1, H - 1]],
                                             np.float32))
    want = np.concatenate([kp[0, :13] / [W, H], sc[0, :13]], 1)
    err = float(np.abs(got - want).max())
    log(f"[serve] 14d infer CLI --pose-cfg {os.path.basename(yaml)} "
        f"--pose-weights {os.path.basename(weights)}: one box over the "
        f"frame, the label file vs UdpPosePipeline.infer_pose {err:.3g} "
        f"apart; wrote {sorted(os.listdir(out))} | {card}")
    check(got.shape == (13, 3) and err <= 1e-6,
          "14d infer CLI keypoints != UdpPosePipeline.infer_pose")
    del pipe


def export_paths(tmp, card, device="cuda", cfg_fn=w32_cfg, yaml=W32_YAML,
                 rsn_yaml=RSN18_YAML, det_size=DET_SIZE, batch=8,
                 n_serve=SERVE_BATCH, hw=DETECT_HW):
    """14d: ``python -m udp_pose_tpu_torch.export`` on the card for the
    w32 yaml (its bytes = the library's of the same seeded model; with
    ``--format pth`` its state dict) and for ``--yolo yolov5n`` (each
    ``.onnx`` held by ``check_model`` on the card against the model's
    forward); a w32 export of ``batch`` held by
    ``check_model`` on the card, its export and one evaluator batch timed
    beside the model's own forward; that ``.onnx`` served as weights
    (``n_serve`` crops bit-equal to the ``.pth`` of the same weights, a
    window of launches each); ``StandalonePoseEngine`` over it against
    the same engine over the model's forward; and an ``rsn18`` export
    served by the serve CLI and run by the infer CLI.  Returns
    ({path: launches}, figures)."""
    from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
    from udp_pose_tpu_torch.engine.standalone import (StandalonePoseEngine,
                                                      onnx_model_fn)
    from udp_pose_tpu_torch.export import (check_model, export_onnx_from_cfg,
                                           load_model)
    from udp_pose_tpu_torch.export.__main__ import main as export_main
    from udp_pose_tpu_torch.export.onnx_eval import fp32_exact, run_graph
    from udp_pose_tpu_torch.export.onnx_yolo import export_yolov5
    from udp_pose_tpu_torch.models import build_detector, build_model
    from udp_pose_tpu_torch.utils.checkpoint import save_weights
    figures, paths = {}, {}
    cfg = cfg_fn("float32")
    w, h = cfg.MODEL.IMAGE_SIZE
    # (1) the CLI, in this process, on the card
    t0 = time.perf_counter()
    cli_out = export_main(["--cfg", yaml, "--out",
                           os.path.join(tmp, "cli_w32.onnx"), "--device",
                           device])
    figures["cli_w32_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    export_main(["--yolo", "yolov5n", "--det-size", str(det_size), "--out",
                 os.path.join(tmp, "yolov5n.onnx"), "--device", device])
    figures["cli_yolov5n_s"] = time.perf_counter() - t0
    pth = export_main(["--cfg", yaml, "--format", "pth", "--out",
                       os.path.join(tmp, "cli_w32.pth"), "--device", device])
    model = build_model(cfg, device=device, seed=0)
    with open(cli_out, "rb") as f:
        check(f.read() == export_onnx_from_cfg(model, cfg, batch=1),
              "14d: the export CLI's w32 bytes != the library's of the same "
              "seeded model")
    sd = torch.load(pth, weights_only=True)
    check(sd.keys() == model.state_dict().keys() and all(
        torch.equal(sd[k], v.cpu()) for k, v in model.state_dict().items()),
        "14d: the export CLI's .pth != the seeded model's state dict")
    # (2) w32 at ``batch``, timed, held on the card
    t0 = time.perf_counter()
    blob = export_onnx_from_cfg(model, cfg, batch=batch)
    figures["export_w32_s"] = time.perf_counter() - t0
    graph = load_model(blob)
    x = np.random.default_rng(0).normal(size=(batch, 3, h, w)).astype(
        np.float32)
    xd = torch.from_numpy(x).to(device)
    with torch.inference_mode(), fp32_exact(device):
        y = model(xd).float()
        err = check_model(graph, x, y.cpu().numpy(), rtol=1e-2, atol=max(
            1e-3, 1e-5 * float(y.abs().max())), device=device)
        figures["evaluator_w32_ms"] = host_ms(
            lambda: run_graph(graph, {"images": xd}, device), 5)
        figures["forward_w32_ms"] = host_ms(lambda: model(xd), 5)
    yolo = build_detector("yolov5n", device=device)
    t0 = time.perf_counter()
    yblob = export_yolov5(yolo, "n", image_hw=(det_size, det_size))
    figures["export_yolov5n_s"] = time.perf_counter() - t0
    ygraph = load_model(yblob)
    yx = torch.rand((1, 3, det_size, det_size), generator=torch.Generator()
                    .manual_seed(1)).to(device)
    with torch.inference_mode(), fp32_exact(device):
        yerr = check_model(ygraph, yx.cpu().numpy(),
                           yolo(yx).float().cpu().numpy(), rtol=1e-3,
                           atol=2e-3, device=device)
        figures["evaluator_yolov5n_ms"] = host_ms(
            lambda: run_graph(ygraph, {"images": yx}, device), 5)
    log(f"[serve] 14d export CLI on the card: w32 {figures['cli_w32_s']:.1f}"
        f" s, yolov5n {figures['cli_yolov5n_s']:.1f} s (build, export, "
        f"check_model); w32 bytes = the library's, its .pth the model's "
        f"state dict.  w32 B={batch}: "
        f"{len(blob)} bytes exported in {figures['export_w32_s']:.3f} s, "
        f"check_model on the card {err:.3g} max abs err, one evaluator "
        f"batch {figures['evaluator_w32_ms']:.2f} ms against the model's "
        f"forward {figures['forward_w32_ms']:.2f} ms (fp32, TF32 off); "
        f"yolov5n {det_size}: {len(yblob)} bytes in "
        f"{figures['export_yolov5n_s']:.3f} s, check_model {yerr:.3g}, one "
        f"evaluator batch {figures['evaluator_yolov5n_ms']:.2f} ms | {card}")
    # (3) the .onnx as weights, against the .pth of the same weights
    onnx_path = os.path.join(tmp, "w32.onnx")
    pth_path = os.path.join(tmp, "w32.pth")
    with open(onnx_path, "wb") as f:
        f.write(blob)
    save_weights(pth_path, model)
    crops, center, scale = random_crops(n_serve, cfg, seed=19)
    path = PathLaunches("onnx_weights_serving")
    out = []
    for p in (onnx_path, pth_path):
        pipe = UdpPosePipeline(cfg_fn("bfloat16"), weights=p, device=device)
        out.append(path.run(pipe.infer_crops, crops, center, scale))
        path.served(1, 0)
        del pipe
    check(path.counts == path.want, f"14d onnx weights: launches "
          f"{path.counts}")
    check(all(np.array_equal(a, b) for a, b in zip(*out)),
          "14d: the .onnx weights serve other keypoints than the .pth")
    paths["onnx_weights_serving"] = path.counts
    # (4) the standalone engine over the artifact
    frame = detect_frames(1, seed=160, hw=hw)[0]
    boxes = person_boxes(12, 161, hw)
    path = PathLaunches("standalone_onnx")
    eng = StandalonePoseEngine(onnx_model_fn(graph, device),
                               input_wh=(w, h))

    def torch_fn(x_nhwc):
        x = torch.from_numpy(x_nhwc).to(device).permute(0, 3, 1, 2)
        return model(x.contiguous()).permute(0, 2, 3, 1).cpu().numpy()

    with torch.inference_mode(), fp32_exact(device):
        kp, mv = path.run(eng.infer_pose, frame, boxes)
        kp_t, mv_t = StandalonePoseEngine(torch_fn, (w, h)).infer_pose(
            frame, boxes)
        x = eng._preprocess(frame, boxes)[0]
        maps, maps_t = eng.model_fn(x), torch_fn(x)
        figures["standalone_ms"] = host_ms(
            lambda: eng.infer_pose(frame, boxes), 3)
    map_err = float(np.abs(maps - maps_t).max())
    flat = maps_t.reshape(len(x), -1, maps_t.shape[-1])
    top2 = -np.sort(-flat, axis=1)[:, :2]                # (N, 2, J)
    clear = top2[:, 0] - top2[:, 1] > 2 * map_err
    same = (kp == kp_t).all(-1)
    mv_err = float(np.abs(mv - mv_t).max())
    log(f"[serve] 14d StandalonePoseEngine over the w32 .onnx (graph batch "
        f"{batch}), {len(boxes)} boxes: its maps vs the model's forward "
        f"{map_err:.3g} apart (fp32, TF32 off), maxvals {mv_err:.3g}; "
        f"keypoints equal on {int((same & clear).sum())} of the "
        f"{int(clear.sum())} maps with a top-2 margin > twice that "
        f"({int(same.sum())} of {same.size} in all); "
        f"{figures['standalone_ms']:.1f} ms a frame; launches "
        f"{path.counts} | {card}")
    check(map_err <= HEATMAP_REL_TOL * float(np.abs(maps_t).max())
          and mv_err <= map_err, "14d standalone: maps != the model's")
    check(bool(same[clear].all()), "14d standalone: keypoints != the "
          "model's on maps with a clear peak")
    check(not any(path.counts.values()), "14d standalone: a hand kernel "
          "launched")
    paths["standalone_onnx"] = path.counts
    del model, yolo, eng, graph, ygraph
    torch.cuda.empty_cache()
    # (5) an rsn18 export served by the serve CLI and run by the infer CLI
    rcfg = yaml_cfg(rsn_yaml, "float32")
    rsn = build_model(rcfg, device=device, seed=3)
    rsn_path = os.path.join(tmp, "rsn18.onnx")
    with open(rsn_path, "wb") as f:
        f.write(export_onnx_from_cfg(rsn, rcfg))
    del rsn
    figures["serve_cli_s"] = serve_cli(tmp, card, rsn_yaml, rsn_path, frame,
                                       boxes[:3], device)
    infer_cli(tmp, card, rsn_yaml, rsn_path, frame, device)
    return paths, figures


def phase_serve(tmp, device="cuda"):
    """Phase 14: the serving surface and export (14a-14d).  Returns the
    launches by path."""
    card = card_line()
    t_phase = time.perf_counter()
    paths, secs = {}, {}
    t0 = time.perf_counter()
    paths["infer_pose_card_crops"], _ = card_crops(card, device)
    secs["14a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths["pose_serving_pad_on_device"] = pad_on_device_http(card, device)
    secs["14b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths.update(rsn_pipeline(card, device)[0])
    secs["14c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths.update(export_paths(tmp, card, device)[0])
    secs["14d"] = time.perf_counter() - t0
    log(f"[serve] phase 14 {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{p} {v:.1f}" for p, v in secs.items()) + " s)")
    return paths


# ---------------------------------------------------------------- phase 15
DDP_TRAIN_IMAGES, DDP_VAL_IMAGES = 64, 16    # 128 / 32 crops: 4 steps
# 15b, world 1 against no group: x the norm of the run's change; w32
# amplifies fp32 rounding step by step (4.3e-3 after 4 steps on an
# H100), and a wrong reduction moves it to the order of 1.  15a holds
# the BN formulas themselves, at 1e-4 of each output's max
DDP_WEIGHT_TOL = 5e-2
DDP_LOSS_RTOL = 1e-4             # the first step's loss (same weights)
DDP_STEPS_LOSS_RTOL = 1e-2       # every step's (1.33e-3 at the 4th)
# 15c, 2 ranks x B=32 against one process at B=64: its own limits, set
# between the sound run and the control with each rank's BatchNorm over
# its own rows (torch DDP's default, the fault global BN avoids): on two
# H100s the sound run read 1.22e-4 of the change and losses <= 6.55e-6
# apart, the control 1.23e-2 and 3.0e-4; the check fails if the control
# stays inside them
DP2_WEIGHT_TOL = 1e-3            # x the norm of the change
DP2_LOSS_RTOL = 5e-5             # every step's loss
BN_TOL = {torch.float32: 1e-4,   # x max |plain|, TF32 off (15a)
          torch.bfloat16: 2e-2}  # bf16 outputs: an ulp is 2^-8
MESH_PERSONS = 64                # 15c: persons on one 720p frame


def free_port():
    """A free TCP port on this host (the rendezvous of a process group)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank, world, port):
    """torchrun's variables for ``rank`` of ``world`` on this host."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


def ddp_data(tmp, name="coco", n_train=DDP_TRAIN_IMAGES,
             n_val=DDP_VAL_IMAGES):
    """Phase 15's seeded synthetic mini-COCO: the root and the frames (a
    rank of 15c makes the same ones from the seed)."""
    rng = np.random.default_rng(51)
    root = os.path.join(tmp, name)
    return root, {"train2017": synthetic_coco(root, "train2017", n_train,
                                              rng),
                  "val2017": synthetic_coco(root, "val2017", n_val, rng)}


def ddp_cfg(root, out_dir, cfg_fn=w32_cfg, batch=32):
    """15b's run: w32 fp32, one epoch, WORKERS 2, deterministic cuDNN,
    SGD at the yaml's LR.  SGD and not the yaml's Adam: Adam's first
    steps move each weight by about the LR whatever the size of its
    gradient, so two runs whose gradients differ in the last bits can
    move a near-zero component in opposite directions; under SGD the
    runs' weights differ as their gradients do."""
    cfg = train_cfg(root, out_dir, "float32", cfg_fn)
    cfg.TRAIN.END_EPOCH = 1
    cfg.TRAIN.OPTIMIZER = "sgd"
    cfg.TRAIN.BATCH_SIZE_PER_GPU = batch
    cfg.WORKERS = 2
    cfg.CUDNN.DETERMINISTIC, cfg.CUDNN.BENCHMARK = True, False
    os.makedirs(out_dir, exist_ok=True)
    return cfg


def bn_shapes(cfg, batch, device="cuda"):
    """The input shape of each of w32's BatchNorms in a train forward at
    ``batch`` rows, in the order they run."""
    from udp_pose_tpu_torch.models import build_model
    from udp_pose_tpu_torch.models.layers import BatchNorm2d
    model = build_model(cfg, device=device, train=True)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: shapes.append(tuple(args[0].shape))) for m in bns]
    w, h = cfg.MODEL.IMAGE_SIZE
    with torch.no_grad():
        model(torch.zeros(batch, 3, h, w, device=device).to(
            memory_format=torch.channels_last))
    for hk in hooks:
        hk.remove()
    return shapes


def bn_layers_ms(shapes, cls, dtype, device="cuda"):
    """Milliseconds of a train forward and backward of one ``cls``
    BatchNorm at each of ``shapes`` in turn (a w32 step's BatchNorms
    alone, ``dtype`` inputs, bf16 under autocast), host clock to the
    card's end, after one such pass."""
    C = sorted({s[1] for s in shapes})
    bns = {c: cls(c).to(device).train() for c in C}
    g = torch.Generator(device).manual_seed(7)
    xs = [torch.randn(s, generator=g, device=device).to(dtype).to(
        memory_format=torch.channels_last).requires_grad_(True)
        for s in shapes]
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in xs:
            with torch.autocast("cuda", dtype=torch.bfloat16,
                                enabled=dtype == torch.bfloat16):
                out = bns[x.shape[1]](x)
            out.backward(out)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bn_versus_plain(shape, dtype, seed, device="cuda"):
    """``GlobalBatchNorm2d`` (in this process's group) against
    ``layers.BatchNorm2d`` on one channels-last input of ``shape`` in
    train mode, ``dtype`` the input's (bf16 under autocast): each of the
    output, the input's, scale's and bias's gradients and the running
    stats as max |global - plain| / max |plain|."""
    from udp_pose_tpu_torch.models.layers import BatchNorm2d
    from udp_pose_tpu_torch.parallel import GlobalBatchNorm2d
    g = torch.Generator(device).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=device) * 1.5 + 0.3).to(
        dtype).to(memory_format=torch.channels_last)
    dy = torch.randn(shape, generator=g, device=device).to(dtype).to(
        memory_format=torch.channels_last)
    C = shape[1]
    runs = []
    for cls in (BatchNorm2d, GlobalBatchNorm2d):
        bn = cls(C).to(device).train()
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, C))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, C))
        xi = x.detach().clone().requires_grad_(True)
        with torch.autocast("cuda", dtype=torch.bfloat16,
                            enabled=dtype == torch.bfloat16):
            out = bn(xi)
        out.backward(dy)
        runs.append({"out": out.float(), "dx": xi.grad.float(),
                     "dweight": bn.weight.grad, "dbias": bn.bias.grad,
                     "running_mean": bn.running_mean,
                     "running_var": bn.running_var})
    plain, glob = runs
    return {k: float((glob[k] - v).abs().max() / v.abs().max())
            for k, v in plain.items()}


def check_global_bn(cfg, card, device="cuda", batch=32):
    """15a: at every BN input shape of a w32 train step at ``batch``,
    ``GlobalBatchNorm2d`` of the world-1 NCCL group against
    ``layers.BatchNorm2d``, fp32 with TF32 off and bf16 under autocast.
    Returns the number of BatchNorms."""
    from udp_pose_tpu_torch.models.layers import BatchNorm2d
    from udp_pose_tpu_torch.parallel import GlobalBatchNorm2d
    set_tf32(False)
    layers = bn_shapes(cfg, batch, device)
    n_bn = len(layers)
    shapes = sorted(set(layers), key=lambda s: (-s[2] * s[3], s[1]))
    worst = {}
    for dtype, tol in BN_TOL.items():
        errs = {}
        for i, shape in enumerate(shapes):
            for k, e in bn_versus_plain(shape, dtype, 100 + i,
                                        device).items():
                errs[k] = max(errs.get(k, 0.0), e)
        name = str(dtype).split(".")[1]
        check(all(e <= tol for e in errs.values()),
              f"15a global BN {name} against layers.BatchNorm2d: {errs} "
              f"(limit {tol:g} x max)")
        worst[name] = errs
    # the step's BatchNorms alone, plain and global, in turns
    ms = {}
    for dtype in BN_TOL:
        for cls in (BatchNorm2d, GlobalBatchNorm2d, GlobalBatchNorm2d,
                    BatchNorm2d):
            ms.setdefault((dtype, cls), []).append(
                bn_layers_ms(layers, cls, dtype, device))
    set_tf32(True)
    torch.cuda.empty_cache()
    for name, errs in worst.items():
        log(f"[ddp] 15a GlobalBatchNorm2d (NCCL world 1) vs "
            f"layers.BatchNorm2d at the {len(shapes)} BN input shapes of a "
            f"w32 B={batch} train step ({shapes[0]} ... {shapes[-1]}), "
            f"{name}{' TF32 off' if name == 'float32' else ' autocast'}: "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" x max (limit {BN_TOL[getattr(torch, name)]:g}) | {card}")
    for dtype in BN_TOL:
        plain, glob = (min(ms[dtype, c]) for c in (BatchNorm2d,
                                                   GlobalBatchNorm2d))
        log(f"[ddp] 15a the {n_bn} BatchNorms of a w32 B={batch} step "
            f"alone, forward + backward, {str(dtype).split('.')[1]}: "
            f"layers.BatchNorm2d {plain:.1f} ms, GlobalBatchNorm2d "
            f"{glob:.1f} ms (+{glob - plain:.1f} ms a step; best of two "
            f"turns) | {card}")
    return n_bn


def count_all_reduces(cfg, batch, card, device="cuda"):
    """15a: the all-reduces of one w32 DDP train step (global BN forward
    and backward, the loss's mean over the ranks, DDP's gradient
    buckets, counted through a comm hook that calls the default one)."""
    import torch.distributed as dist
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

    from udp_pose_tpu_torch.core.loss import make_loss_fn
    from udp_pose_tpu_torch.core.train import (create_train_state,
                                               make_train_step, upload_batch)
    from udp_pose_tpu_torch.models import build_model
    from udp_pose_tpu_torch.parallel import GlobalBatchNorm2d, data_parallel
    model = build_model(cfg, device=device, train=True)
    state = create_train_state(cfg, model, steps_per_epoch=1)
    state.ddp = data_parallel(state.model)
    n_bn = sum(isinstance(m, GlobalBatchNorm2d) for m in model.modules())
    buckets, calls = [0], [0]

    def hook(process_group, bucket):
        buckets[0] += 1
        return default_hooks.allreduce_hook(process_group, bucket)

    state.ddp.register_comm_hook(None, hook)
    real = dist.all_reduce

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    dist.all_reduce = counted
    try:
        make_train_step(make_loss_fn(cfg))(state, upload_batch(batch,
                                                               device))
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = real
    others = calls[0] - buckets[0]
    check(others == 2 * n_bn + 1 and buckets[0] >= 1,
          f"15a: {calls[0]} all-reduces in a step, {buckets[0]} of them "
          f"DDP buckets, for {n_bn} BatchNorms")
    # what the BN all-reduces cost alone: as many, of a 2C+1 float32
    # vector each, back to back and then waited for
    packed = torch.zeros(2 * 64 + 1, device=device)
    for _ in range(20):
        dist.all_reduce(packed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2 * n_bn):
        dist.all_reduce(packed)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    log(f"[ddp] 15a one w32 bf16 B={len(batch['image'])} DDP step (NCCL "
        f"world 1): {calls[0]} all-reduces = {2 * n_bn} global BN ({n_bn} "
        f"BatchNorms, forward and backward) + 1 loss mean + {buckets[0]} "
        f"DDP gradient buckets; {2 * n_bn} all-reduces of 129 floats alone: "
        f"{enqueue_ms:.1f} ms to enqueue, {total_ms:.1f} ms to finish "
        f"({total_ms / (2 * n_bn) * 1e3:.1f} us each) | {card}")
    del state, model
    torch.cuda.empty_cache()
    return calls[0]


def weight_errors(got, want, init):
    """Two runs' weights and running stats from ``init``: the norm of
    their difference over the norm of ``want``'s change (all float
    tensors as one vector), and per tensor max |got - want| / max |want -
    init|."""
    keys = [k for k in want if want[k].is_floating_point()]
    diff = {k: got[k].double() - want[k].double() for k in keys}
    change = {k: want[k].double() - init[k].double() for k in keys}
    total = float(sum(d.square().sum() for d in diff.values()).sqrt()
                  / sum(c.square().sum() for c in change.values()).sqrt())
    return total, {k: float(diff[k].abs().max()
                            / max(float(change[k].abs().max()), 1e-30))
                   for k in keys}


def samples_per_s(record, batch):
    """Global samples a second over the steps after the first (median
    iteration)."""
    iters = [s["iter_s"] for s in record["steps"][1:]] or [
        record["steps"][0]["iter_s"]]
    return batch / float(np.median(iters))


def ddp_run(tmp, name, root, frames, device="cuda", cfg_fn=w32_cfg):
    """15b: ``train.run`` of a fresh seeded w32 of :func:`ddp_cfg` under
    ``<tmp>/<name>``, the kernels' counts read just around it."""
    from udp_pose_tpu_torch import train as train_cli
    from udp_pose_tpu_torch.models import build_model
    cfg = ddp_cfg(root, os.path.join(tmp, name), cfg_fn)
    train_ds = in_memory_coco(cfg, frames["train2017"], True)
    val_ds = in_memory_coco(cfg, frames["val2017"], False)
    model = build_model(cfg, device=device, train=True)
    zero_launches()
    t0 = time.perf_counter()
    record = train_cli.run(cfg, model, train_ds, val_ds, cfg.OUTPUT_DIR,
                           device)
    return {"record": record, "secs": time.perf_counter() - t0,
            "launches": read_launches(), "model": model, "cfg": cfg,
            "train_ds": train_ds, "val_ds": val_ds,
            "weights": os.path.join(cfg.OUTPUT_DIR, "final_state.pth")}


def check_ddp_runs(plain, ddp, card, device="cuda"):
    """15b: the DP run (inside the world-1 group) against the plain one
    (no group): the same steps, the first step's loss within
    DDP_LOSS_RTOL and every step's within DDP_STEPS_LOSS_RTOL, the final weights and running stats within
    DDP_WEIGHT_TOL of the
    norm of the run's change, one decode launch a
    validation batch, samples/s of both, and a validation batch of the
    DP model through the fused decode bit-equal to its plain version.
    Then 15c's evaluation in the group: ``test.run`` on the DP weights,
    the run's AP.  Returns the evaluation's launches."""
    from udp_pose_tpu_torch import test as test_cli
    from udp_pose_tpu_torch.core.infer import make_infer_fn_from_cfg
    from udp_pose_tpu_torch.core.validate import serving_copy
    from udp_pose_tpu_torch.data.base import epoch_loader
    from udp_pose_tpu_torch.models import build_model
    from udp_pose_tpu_torch.ops import peak_offset as po
    cfg, val_ds, record = ddp["cfg"], ddp["val_ds"], ddp["record"]
    B = cfg.TRAIN.BATCH_SIZE_PER_GPU
    steps = len(ddp["train_ds"]) // B
    eval_batches = -(-len(val_ds) // cfg.TEST.BATCH_SIZE_PER_GPU)
    init = build_model(cfg, device="cpu", train=True).state_dict()
    final = {n: torch.load(r["weights"], map_location="cpu")
             for n, r in (("plain", plain), ("ddp", ddp))}
    total, errs = weight_errors(final["ddp"], final["plain"], init)
    worst = max(errs, key=errs.get)
    loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in
                zip(record["steps"], plain["record"]["steps"])]
    launches = ddp["launches"]
    losses = {n: ", ".join(f"{s['loss']:.6g}" for s in r["record"]["steps"])
              for n, r in (("plain", plain), ("ddp", ddp))}
    rates = {n: samples_per_s(r["record"], B)
             for n, r in (("plain", plain), ("ddp", ddp))}
    waits = {n: float(np.median([s["load_s"] for s in r["record"]["steps"][
        1:]])) * 1e3 for n, r in (("plain", plain), ("ddp", ddp))}
    # (c) one validation batch: the fused decode is its plain version
    infer = make_infer_fn_from_cfg(
        serving_copy(ddp["model"], build_model(cfg, device=device)), cfg,
        flip_pairs=val_ds.flip_pairs)
    vb = next(epoch_loader(val_ds, cfg.TEST.BATCH_SIZE_PER_GPU,
                           shuffle=False, drop_last=False))
    _, _, hm = infer(vb["image"], vb["center"], vb["scale"])
    decode_ok = same_bits(po.udp_offset_decode_fused(hm, KPD),
                          po.udp_offset_decode_reference(hm, KPD))
    log(f"[ddp] 15b train.run w32 fp32 B={B} SGD, TF32 off, deterministic "
        f"cuDNN, WORKERS 2, {steps} steps + validation: losses plain (no "
        f"group) {losses['plain']}; DP (NCCL world 1: global BN, DDP) "
        f"{losses['ddp']} (relative difference by step "
        f"{', '.join(f'{v:.3g}' for v in loss_rel)}; limits "
        f"{DDP_LOSS_RTOL:g} the first, {DDP_STEPS_LOSS_RTOL:g} each); final weights and running stats DP vs plain: "
        f"|difference| / |change| {total:.3g} (limit {DDP_WEIGHT_TOL:g}), by "
        f"tensor max |difference| / max |change| worst {worst} "
        f"{errs[worst]:.3g}, median "
        f"{float(np.median(list(errs.values()))):.3g}; samples/s plain "
        f"{rates['plain']:.1f}, DP {rates['ddp']:.1f} "
        f"(DP / plain {rates['ddp'] / rates['plain']:.3f}; median iteration "
        f"after the first, of which waiting for the batch "
        f"{waits['plain']:.1f} / {waits['ddp']:.1f} ms); train.run "
        f"{plain['secs']:.1f} s / "
        f"{ddp['secs']:.1f} s; validation batch {tuple(hm.shape)} "
        f"({layout_of(hm)}) fused decode bit-equal to its plain version: "
        f"{decode_ok} | {card}")
    check(len(record["steps"]) == steps == len(plain["record"]["steps"]),
          f"15b: {len(record['steps'])} DP steps, "
          f"{len(plain['record']['steps'])} plain, want {steps}")
    check(total <= DDP_WEIGHT_TOL and loss_rel[0] <= DDP_LOSS_RTOL
          and max(loss_rel) <= DDP_STEPS_LOSS_RTOL,
          f"15b DP vs plain: final weights {total:.3g} x the norm of the "
          f"change (limit {DDP_WEIGHT_TOL:g}), losses by step "
          f"{', '.join(f'{v:.3g}' for v in loss_rel)} (limits "
          f"{DDP_LOSS_RTOL:g} the first, {DDP_STEPS_LOSS_RTOL:g} each)")
    check(launches["udp_offset_decode_fused"] == eval_batches
          and launches["fused_peak_offset"] == 0,
          f"15b DP run launches {launches}, want {eval_batches} decodes")
    check(decode_ok, "15b: fused decode of a DP validation batch != its "
          "plain version")
    zero_launches()
    t0 = time.perf_counter()
    _, perf = test_cli.run(cfg, ddp["weights"], val_ds, "", device)
    test_s = time.perf_counter() - t0
    eval_launches = read_launches()
    check(eval_launches["udp_offset_decode_fused"] == eval_batches
          and perf == record["validations"][-1]["perf"],
          f"15c test.run in the group: launches {eval_launches}, AP {perf} "
          f"vs the run's {record['validations'][-1]['perf']}")
    log(f"[ddp] 15c test.run in the world-1 group on the DP weights: AP "
        f"{perf:.4f} = the run's validation, {eval_batches} decode launches"
        f", {test_s:.1f} s | {card}")
    return eval_launches


def mesh_serving(card, devices, device="cuda", cfg_fn=w32_cfg, iters=10):
    """15c: ``UdpPosePipeline(mesh=)`` over ``devices`` (a power of two
    of them) against no mesh (the pipeline's own one card) on a 64-person 720p
    frame, fp32 with TF32 off: each card's rows of the mesh's answer bit
    for bit the answer without a mesh on those rows alone (the same batch
    size, so the same conv algorithms), and the whole frame's difference
    from one batch of all the rows reported; then bf16 crops/s of both in
    turns (no mesh, mesh, mesh, no mesh).  Returns the mesh path's
    launches."""
    from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
    from udp_pose_tpu_torch.parallel import make_mesh, shard_rows
    mesh, n_cards = make_mesh(devices), len(devices)
    frame = detect_frames(1, seed=150)[0]
    boxes = person_boxes(MESH_PERSONS, 151)
    set_tf32(False)
    pipes = {m: UdpPosePipeline(cfg_fn("float32"), device=device, seed=0,
                                mesh=mesh if m else None)
             for m in (False, True)}
    kp, kp_mesh = (pipes[m].infer_pose(frame, boxes)[0] for m in (False,
                                                                  True))
    shards = [shard_rows(MESH_PERSONS, i, n_cards) for i in range(n_cards)]
    same = [np.array_equal(kp_mesh[r], pipes[False].infer_pose(
        frame, boxes[r])[0]) for r in shards]
    diff = float(np.abs(kp - kp_mesh).max())
    set_tf32(True)
    check(kp_mesh.shape == (MESH_PERSONS, 17, 2) and all(same),
          f"15c mesh of {n_cards} card(s): the rows of each card bit-equal "
          f"to no mesh on those rows: {same}")
    pipes = {m: UdpPosePipeline(cfg_fn("bfloat16"), device=device, seed=0,
                                mesh=mesh if m else None)
             for m in (False, True)}
    for p in pipes.values():
        p.infer_pose(frame, boxes)                  # warm-up
    times = {False: [], True: []}
    launches = dict.fromkeys(kernel_wrappers(), 0)
    for m in (False, True, True, False):
        if m:
            zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            pipes[m].infer_pose(frame, boxes)
        torch.cuda.synchronize()
        times[m].append((time.perf_counter() - t0) / iters)
        if m:
            for k, n in read_launches().items():
                launches[k] += n
    check(launches["udp_offset_decode_fused"] == 2 * iters * n_cards,
          f"15c mesh serving: {launches}, want {2 * iters * n_cards} "
          "decodes")
    rate = {m: MESH_PERSONS / float(np.median(t)) for m, t in times.items()}
    log(f"[ddp] 15c UdpPosePipeline(mesh={n_cards} card(s)) vs no mesh, "
        f"{MESH_PERSONS} persons of a 720p frame: fp32 TF32 off, each "
        f"card's {MESH_PERSONS // n_cards} rows bit-equal to no mesh on "
        f"them; against one batch of all {MESH_PERSONS} max |diff| "
        f"{diff:.3g} px; bf16 crops/s no mesh {rate[False]:.1f}, "
        f"mesh {rate[True]:.1f} ({iters} calls, in turns); decode launches "
        f"{launches['udp_offset_decode_fused']} = {2 * iters} calls x "
        f"{n_cards} card(s) | {card}")
    return launches


def ddp_rank(rank, world, port, tmp, weights, device, cfg_fn,
             per_rank_bn=False):
    """A rank of 15c's multi-card runs (``torch.multiprocessing.spawn``):
    joins the NCCL group on ``cuda:rank`` (gloo for ``device`` "cpu"),
    trains w32 at B=32 a rank on phase 15's records, evaluates
    ``weights`` on its shard through ``test.run``, and saves its record,
    AP and launches.  ``per_rank_bn``: the control, trained with each
    rank's BatchNorm over its own rows (the global-batch conversion
    skipped), which is not evaluated."""
    from udp_pose_tpu_torch import test as test_cli
    from udp_pose_tpu_torch import train as train_cli
    from udp_pose_tpu_torch.models import build_model
    from udp_pose_tpu_torch.parallel import batchnorm, process_group
    import multiprocessing
    # a spawned process would spawn its loader's workers too, which
    # cannot take the in-memory dataset; a rank that torchrun starts forks
    multiprocessing.set_start_method("fork", force=True)
    os.environ.update(rank_env(rank, world, port))
    if per_rank_bn:
        # data_parallel imports the converter when it wraps the model
        batchnorm.convert_batchnorm = lambda module, group=None: module
    tag = "ddp2_per_rank_bn" if per_rank_bn else "ddp2"
    # the frames again from the seed (their json goes to a copy of this
    # rank's); the db is read from the parent's root, as every rank of
    # a run reads one DATASET.ROOT
    root, frames = os.path.join(tmp, "coco"), ddp_data(
        tmp, f"coco{rank}")[1]
    with process_group(device) as device:
        set_tf32(False)
        cfg = ddp_cfg(root, os.path.join(tmp, tag), cfg_fn)
        train_cli.set_cudnn(cfg)
        train_ds = in_memory_coco(cfg, frames["train2017"], True)
        val_ds = in_memory_coco(cfg, frames["val2017"], False)
        zero_launches()
        record = train_cli.run(cfg, build_model(cfg, device=device,
                                                train=True),
                               train_ds, val_ds, cfg.OUTPUT_DIR, device)
        perf = None if per_rank_bn else test_cli.run(
            cfg, weights, val_ds, "", device)[1]
        torch.save({"record": record, "perf": perf,
                    "launches": read_launches()},
                   os.path.join(tmp, f"{tag}-rank{rank}.pt"))


def multi_card(tmp, root, frames, weights, card, device="cuda",
               cfg_fn=w32_cfg):
    """15c on two cards: 2 spawned ranks at B=32 each against this
    process alone at B=64 on the same records (final weights within
    DP2_WEIGHT_TOL of the norm of the change and every step's loss
    within DP2_LOSS_RTOL, samples/s of each), the control (the ranks
    again with per-rank BatchNorm) outside those limits, and the ranks'
    ``test.run`` on their shards against this process's.  Returns the
    sound ranks' launches summed."""
    import torch.multiprocessing as torch_mp
    from udp_pose_tpu_torch import test as test_cli
    from udp_pose_tpu_torch import train as train_cli
    from udp_pose_tpu_torch.models import build_model
    world = 2
    runs, ranks_s = {}, {}
    for per_rank_bn in (False, True):
        tag = "ddp2_per_rank_bn" if per_rank_bn else "ddp2"
        t0 = time.perf_counter()
        torch_mp.spawn(ddp_rank, args=(world, free_port(), tmp, weights,
                                       device, cfg_fn, per_rank_bn),
                       nprocs=world, join=True)
        ranks_s[tag] = time.perf_counter() - t0
        runs[tag] = [torch.load(os.path.join(tmp, f"{tag}-rank{r}.pt"),
                                weights_only=False) for r in range(world)]
    ranks = runs["ddp2"]
    set_tf32(False)
    cfg = ddp_cfg(root, os.path.join(tmp, "alone64"), cfg_fn, batch=64)
    train_cli.set_cudnn(cfg)
    train_ds = in_memory_coco(cfg, frames["train2017"], True)
    val_ds = in_memory_coco(cfg, frames["val2017"], False)
    record = train_cli.run(cfg, build_model(cfg, device=device, train=True),
                           train_ds, val_ds, cfg.OUTPUT_DIR, device)
    _, perf = test_cli.run(cfg, weights, val_ds, "", device)
    set_tf32(True)
    init = build_model(cfg, device="cpu", train=True).state_dict()
    want = torch.load(os.path.join(tmp, "alone64", "final_state.pth"),
                      map_location="cpu")
    err = {}
    for tag, rs in runs.items():
        got = torch.load(os.path.join(tmp, tag, "final_state.pth"),
                         map_location="cpu")
        total, errs = weight_errors(got, want, init)
        losses = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in
                  zip(rs[0]["record"]["steps"], record["steps"])]
        err[tag] = {"total": total, "worst": max(errs, key=errs.get),
                    "errs": errs, "losses": losses,
                    "steps": len(rs[0]["record"]["steps"])}

    def reading(tag):
        e = err[tag]
        return (f"final weights |difference| / |change| {e['total']:.3g}, "
                f"worst tensor {e['worst']} {e['errs'][e['worst']]:.3g} of "
                f"its max change, loss by step "
                f"{', '.join(f'{v:.3g}' for v in e['losses'])}")

    two = samples_per_s(ranks[0]["record"], 64)
    one = samples_per_s(record, 64)
    log(f"[ddp] 15c w32 fp32 SGD: 2 ranks (NCCL, cuda:0 and cuda:1) x B=32 "
        f"vs this process alone at B=64, {len(record['steps'])} steps on "
        f"the same records: global BN {reading('ddp2')}; control with "
        f"per-rank BN {reading('ddp2_per_rank_bn')} (limits "
        f"{DP2_WEIGHT_TOL:g} of the change, {DP2_LOSS_RTOL:g} each loss); "
        f"samples/s 2 cards {two:.1f}, 1 card {one:.1f} (scaling "
        f"{two / one:.3f}); test.run 2 ranks AP {ranks[0]['perf']:.4f} = 1 "
        f"process {perf:.4f}; ranks {ranks_s['ddp2']:.1f} s, control "
        f"{ranks_s['ddp2_per_rank_bn']:.1f} s | {card}")
    sound, control = err["ddp2"], err["ddp2_per_rank_bn"]
    check(sound["total"] <= DP2_WEIGHT_TOL
          and max(sound["losses"]) <= DP2_LOSS_RTOL
          and sound["steps"] == len(record["steps"]),
          f"15c 2 ranks x B=32 vs 1 x B=64: {reading('ddp2')} (limits "
          f"{DP2_WEIGHT_TOL:g}, {DP2_LOSS_RTOL:g}); steps {sound['steps']} "
          f"vs {len(record['steps'])}")
    check(control["total"] > DP2_WEIGHT_TOL
          or max(control["losses"]) > DP2_LOSS_RTOL,
          f"15c: the control with per-rank BatchNorm passes the limits "
          f"({reading('ddp2_per_rank_bn')}), which cannot tell it from "
          "global BN")
    check(all(abs(r["perf"] - perf) <= 1e-6 for r in ranks),
          f"15c test.run on 2 ranks: AP {[r['perf'] for r in ranks]}, one "
          f"process {perf}")
    launches = dict.fromkeys(kernel_wrappers(), 0)
    for r in ranks:
        for k, n in r["launches"].items():
            launches[k] += n
    return launches


def phase_distributed(tmp, device="cuda", cfg_fn=w32_cfg):
    """Phase 15: data parallelism on NCCL.  15b's run without a process
    group first; then this process joins a world-1 NCCL group on
    ``cuda:0`` (env rendezvous at a free port): 15a holds the global
    BatchNorm against ``layers.BatchNorm2d`` and counts one DDP step's
    all-reduces, 15b trains inside the group and holds it against the
    plain run, 15c evaluates in the group and serves over a mesh of
    the most cards a power of two gives; on two or more cards 15c also
    trains and evaluates on 2 ranks against one process.  Returns the launches by path."""
    import torch.distributed as dist

    from udp_pose_tpu_torch import train as train_cli
    from udp_pose_tpu_torch.data.base import collate
    from udp_pose_tpu_torch.parallel import initialize
    card = card_line()
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    root, frames = ddp_data(tmp)
    flags = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    paths, secs = {}, {}
    try:
        t0 = time.perf_counter()
        set_tf32(False)
        train_cli.set_cudnn(ddp_cfg(root, os.path.join(tmp, "flags")))
        plain = ddp_run(tmp, "plain", root, frames, device, cfg_fn)
        secs["15b plain"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dev = initialize("cuda", rank_env(0, 1, free_port()))
        check(dev == torch.device("cuda", 0) and dist.get_backend() == "nccl"
              and dist.get_world_size() == 1,
              f"15a: group on {dev}, backend {dist.get_backend()}")
        check_global_bn(cfg_fn("float32"), card, device)
        cfg = train_cfg(root, tmp, "bfloat16", cfg_fn)
        ds = in_memory_coco(cfg, frames["train2017"], True)
        ds.seed(0)
        batch = collate([ds[i] for i in range(32)])
        count_all_reduces(cfg, batch, card, device)
        # where a bf16 step's time goes, plain and DP, in one call
        from udp_pose_tpu_torch.models import build_model
        for ddp_step in (False, True):
            profile_train(cfg, build_model(cfg, device=device, train=True),
                          batch, card, device=device, ddp=ddp_step)
        torch.cuda.empty_cache()
        secs["15a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        set_tf32(False)
        ddp = ddp_run(tmp, "ddp", root, frames, device, cfg_fn)
        paths["ddp_training"] = ddp["launches"]
        paths["sharded_eval"] = check_ddp_runs(plain, ddp, card, device)
        set_tf32(True)
        secs["15b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # a power of two of the cards, so that each card's rows of the
        # frame's bucket are a bucket of their own
        n_mesh = 1 << (max(n_cards, 1).bit_length() - 1)
        paths["mesh_serving"] = mesh_serving(
            card, [f"cuda:{i}" for i in range(n_mesh)] if device == "cuda"
            else [device] * n_mesh, device, cfg_fn)
        dist.destroy_process_group()
        if n_cards >= 2:
            paths["ddp_training_2_cards"] = multi_card(
                tmp, root, frames, ddp["weights"], card, device, cfg_fn)
        else:
            log("[ddp] 15c checks not run: 2 ranks x B=32 against 1 x B=64, "
                "test.run on 2 ranks against 1 and a mesh of 2+ cards need "
                f"two cards, and torch.cuda.device_count() is {n_cards} (the "
                f"mesh ran over its one card) | {card}")
        secs["15c"] = time.perf_counter() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = flags
        set_tf32(True)
    log(f"[ddp] phase 15 {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{p} {v:.1f}" for p, v in secs.items()) + " s)")
    return paths


# ---------------------------------------------------------------- phase 16
AID_YAML = os.path.join(REPO, "configs/coco/hrnet_w32_256x192_udpv1_aid.yaml")
# 16a: hide-and-seek switched on beside the yaml's cutout
HIDE_AND_SEEK = [1.0, 0.5, [0, 16, 32, 44, 56]]
# 16a, the card against the CPU from one set of draws: crops in [0, 255]
# units (an ulp of the card's sin, cos or a rounding of a coordinate
# moves a crop of noise by up to ~1e-2), targets, weights exactly
AUG_CROP_ATOL = 5e-2
AUG_TARGET_ATOL = 1e-4
FUSED_BN_TOL = 1e-6              # x each tensor's max: float64 (16d)
AUG_RESUME_IMAGES = 48           # 16c: 96 crops, 3 steps an epoch at B=32
# 16e: share of joints within RSN_KP_ATOL of infer_pose's on the same
# boxes.  The engine turns its boxes into (center, scale) on the card,
# where PyTorch divides by a number as a product with its reciprocal,
# infer_pose on the host, which divides: the crops differ in their last
# bits, and bf16 and int8 argmaxes of random weights flip on near ties
# (the CPU test, fp32 on one host path, holds them bit for bit)
RSN_PERSONS_AGREE = 0.95


def aid_cfg(root, out_dir, dtype="bfloat16", yaml=AID_YAML, **over):
    """The AID yaml (w32 256x192, UDP offset, CUTOUT [1.0, 0.2, 1]) for a
    2-epoch run on the synthetic mini-COCO at ``root``."""
    cfg = yaml_cfg(yaml, dtype)
    cfg.DATASET.ROOT = root
    cfg.OUTPUT_DIR = out_dir
    cfg.TRAIN.END_EPOCH = 2
    cfg.merge_from_dict(over)
    os.makedirs(out_dir, exist_ok=True)
    return cfg


def device_aug_card_vs_cpu(data, card, device="cuda", yaml=AID_YAML,
                           batch=32):
    """16a: ``make_device_augment`` of the AID yaml with hide-and-seek
    switched on, B=32 raw samples on the yaml's 640x640 canvases, on the
    card against its plain CPU run from one set of draws (drawn on the
    CPU, copied to the card); the ms of one augment a batch, of the
    batch's draws on the card, and of its upload."""
    from udp_pose_tpu_torch.data import device_pipeline as dp
    from udp_pose_tpu_torch.data.base import collate
    cfg = aid_cfg(data["root"], os.path.join(data["tmp"], "16a"), yaml=yaml)
    cfg.DATASET.HIDE_AND_SEEK = HIDE_AND_SEEK
    canvas_w, canvas_h = cfg.DATASET.DEVICE_AUG_CANVAS
    ds = in_memory_coco(cfg, data["frames"]["train2017"], True)
    view = dp.RawSampleView(ds, (canvas_h, canvas_w))
    raw = collate([view[i] for i in range(batch)])
    aug = dp.make_device_augment(cfg, ds.num_joints, ds.flip_pairs,
                                 ds.upper_body_ids, (canvas_h, canvas_w))
    draws = dp.step_draws(aug, 0, 0, batch, "cpu")
    want = aug(dp.upload_raw(raw, "cpu"), draws)
    on_card = {k: v.to(device) for k, v in draws.items()}
    up_ms = host_ms(lambda: dp.upload_raw(raw, device), iters=10)
    card_raw = dp.upload_raw(raw, device)
    got = aug(card_raw, on_card)
    errs = [float((g.cpu() - w).abs().max()) for g, w in zip(got, want)]
    aug_ms = cuda_ms(lambda: aug(card_raw, on_card), [()], iters=10,
                     repeats=3)
    draw_ms = cuda_ms(lambda: dp.step_draws(aug, 0, 0, batch, device), [()],
                      iters=10, repeats=3)
    masked = float((want[0] == 0).float().mean())
    mb = raw["canvas"].nbytes / 1e6
    log(f"[device_aug] 16a make_device_augment (AID: CUTOUT "
        f"{list(cfg.DATASET.CUTOUT)}, HIDE_AND_SEEK {HIDE_AND_SEEK}), B="
        f"{batch} on {canvas_h}x{canvas_w} canvases -> "
        f"{tuple(got[0].shape)} crops, {tuple(got[1].shape)} offset "
        f"targets: card vs CPU from one set of draws, max |diff| crops "
        f"{errs[0]:.6g} (limit {AUG_CROP_ATOL:g}), targets {errs[1]:.6g} "
        f"(limit {AUG_TARGET_ATOL:g}), weights {errs[2]:.6g} (exact); "
        f"{masked:.4f} of the crop values masked to 0; one augment "
        f"{aug_ms:.3f} ms a batch (CUDA events, median of 3 runs of 10), "
        f"the batch's draws on the card {draw_ms:.3f} ms; upload of "
        f"{mb:.1f} MB of u8 canvases (pinned copy + transfer + sync) "
        f"{up_ms:.2f} ms = {mb / up_ms:.2f} GB/s | {card}")
    check(errs[0] <= AUG_CROP_ATOL and errs[1] <= AUG_TARGET_ATOL
          and errs[2] == 0.0, f"16a: device augment card vs CPU {errs}")
    check(0.0 < masked < 0.9 and all(g.device.type == "cuda" for g in got)
          and all(bool(torch.isfinite(g).all()) for g in got),
          f"16a: masked share {masked}, devices "
          f"{[g.device.type for g in got]}")
    return {"augment_ms": aug_ms, "draw_ms": draw_ms, "upload_ms": up_ms,
            "max_abs_err": errs}


def device_aug_training(data, card, device="cuda", yaml=AID_YAML):
    """16b: ``train.run`` of the AID yaml (w32 bf16 B=32, the yaml's
    WORKERS 4) with ``DATASET.DEVICE_AUG True``, 2 epochs and their
    validations, in the path's launch window, and the same run with the
    host augmentation beside it; samples/s, the wait for the batch, the
    peak memory.  Returns the device-aug run's launches."""
    from udp_pose_tpu_torch import train as train_cli
    from udp_pose_tpu_torch.models import build_model
    root, tmp, frames = data["root"], data["tmp"], data["frames"]
    rates, launches = {}, None
    for name, on in (("host augmentation", False),
                     ("DATASET.DEVICE_AUG", True)):
        cfg = aid_cfg(root, os.path.join(tmp, f"16b_{int(on)}"), yaml=yaml,
                      DATASET={"DEVICE_AUG": on})
        check(cfg.WORKERS == 4, f"WORKERS {cfg.WORKERS}: the yaml's is 4")
        B = cfg.TRAIN.BATCH_SIZE_PER_GPU
        train_ds = in_memory_coco(cfg, frames["train2017"], True)
        val_ds = in_memory_coco(cfg, frames["val2017"], False)
        train_cli.set_cudnn(cfg)
        model = build_model(cfg, device=device, train=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if on:
            zero_launches()
        t0 = time.perf_counter()
        record = train_cli.run(cfg, model, train_ds, val_ds, cfg.OUTPUT_DIR,
                               device)
        secs = time.perf_counter() - t0
        if on:
            launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = record["steps"]
        losses = [s["loss"] for s in steps]
        check(len(steps) == cfg.TRAIN.END_EPOCH * (len(train_ds) // B)
              and all(np.isfinite(losses)), f"16b {name}: {len(steps)} "
              f"steps, losses {losses}")
        warm = [s for s in steps if s["step"] >= WARM_STEPS] or steps
        iter_ms = np.median([s["iter_s"] for s in warm]) * 1e3
        load_ms = np.median([s["load_s"] for s in warm]) * 1e3
        rates[name] = B / iter_ms * 1e3
        iters = ", ".join(f"{st['iter_s'] * 1e3:.1f}" for st in steps)
        vals = ", ".join(f"{v['crops'] / v['seconds']:.1f}"
                         for v in record["validations"])
        log(f"[device_aug] 16b train.run AID w32 bf16 B={B} WORKERS "
            f"{cfg.WORKERS} with {name}, {len(steps)} steps over "
            f"{cfg.TRAIN.END_EPOCH} epochs of {len(train_ds)} samples: "
            f"losses {', '.join(f'{v:.5g}' for v in losses)}; iteration "
            f"{iters} ms; "
            f"{rates[name]:.1f} samples/s (median iteration {iter_ms:.2f} "
            f"ms after {WARM_STEPS} warm-up steps an epoch, of which "
            f"waiting for the batch {load_ms:.2f} ms); validations "
            f"{vals} "
            f"crops/s, AP {record['best_perf']:.4f}; peak "
            f"max_memory_allocated {peak_gb:.2f} GB; train.run {secs:.1f} s "
            f"| {card}")
        del model
        torch.cuda.empty_cache()
    eval_batches = -(-len(val_ds) // cfg.TEST.BATCH_SIZE_PER_GPU)
    want = dict.fromkeys(launches, 0)
    want["udp_offset_decode_fused"] = cfg.TRAIN.END_EPOCH * eval_batches
    check(launches == want, f"16b: the device-aug run launched {launches}, "
          f"its validations need {want}")
    log(f"[device_aug] 16b samples/s: device augmentation "
        f"{rates['DATASET.DEVICE_AUG']:.1f}, host augmentation "
        f"{rates['host augmentation']:.1f} (figures only); fused decode "
        f"launches {launches['udp_offset_decode_fused']} = "
        f"{cfg.TRAIN.END_EPOCH} validations x {eval_batches} batches | "
        f"{card}")
    return launches


class AugDigests:
    """A sha1 of each ``DeviceAugment`` call's crops, targets and weights,
    in call order (the class's ``__call__`` wrapped while in use)."""

    def __enter__(self):
        import hashlib

        from udp_pose_tpu_torch.data import device_pipeline as dp
        self.seen, self._cls = [], dp.DeviceAugment
        call = self._call = dp.DeviceAugment.__call__

        def spy(aug, batch, draws):
            out = call(aug, batch, draws)
            h = hashlib.sha1()
            for t in out:
                h.update(t.cpu().contiguous().numpy().tobytes())
            self.seen.append(h.hexdigest())
            return out

        dp.DeviceAugment.__call__ = spy
        return self

    def __exit__(self, *exc):
        self._cls.__call__ = self._call

    def take(self):
        seen, self.seen = self.seen, []
        return seen


class StopAfter:
    """A preemption guard that says stop at its ``n``-th poll, that is
    after the run's ``n``-th step."""

    def __init__(self, n):
        self.n, self.polls = n, 0

    def should_stop(self, num_shards=1, sync=True):
        self.polls += 1
        return self.polls == self.n


def device_aug_resume(data, card, device="cuda", yaml=AID_YAML):
    """16c: the AID yaml with ``DATASET.DEVICE_AUG``, w32 bf16 B=32,
    WORKERS 2, deterministic cuDNN, 2 epochs: uninterrupted (A), stopped
    after step 2 of epoch 1 (B) and resumed with ``AUTO_RESUME`` (C); the
    augmented batches of B then C are A's and C's final weights A's, bit
    for bit.  Returns the three runs' launches."""
    from udp_pose_tpu_torch import train as train_cli
    from udp_pose_tpu_torch.models import build_model
    root, tmp = data["resume_root"], data["tmp"]
    frames = data["resume_frames"]
    flags = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)

    def cfg_for(name, **over):
        return aid_cfg(root, os.path.join(tmp, f"16c_{name}"), yaml=yaml,
                       WORKERS=2,
                       DATASET={"DEVICE_AUG": True,
                                "HIDE_AND_SEEK": HIDE_AND_SEEK},
                       CUDNN={"DETERMINISTIC": True, "BENCHMARK": False},
                       **over)

    cfg = cfg_for("a")
    B = cfg.TRAIN.BATCH_SIZE_PER_GPU
    train_ds = in_memory_coco(cfg, frames["train2017"], True)
    val_ds = in_memory_coco(cfg, frames["val2017"], False)
    k = len(train_ds) // B
    check(k >= 3, f"16c: {k} steps an epoch")
    runs = {}
    t0 = time.perf_counter()
    zero_launches()
    try:
        train_cli.set_cudnn(cfg)
        with AugDigests() as digests:
            for name, guard, over in (("a", None, {}),
                                      ("b", StopAfter(k + 2), {}),
                                      ("c", None, {"AUTO_RESUME": True})):
                c = cfg_for("b" if name == "c" else name, **over)
                runs[name] = train_cli.run(
                    c, build_model(c, device=device, train=True), train_ds,
                    val_ds, c.OUTPUT_DIR, device, guard=guard)
                runs[name]["digests"] = digests.take()
    finally:
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = flags
    launches = read_launches()
    secs = time.perf_counter() - t0
    a, b, c = runs["a"], runs["b"], runs["c"]
    check(len(a["digests"]) == 2 * k and len(set(a["digests"])) == 2 * k
          and b["preempted"] and len(b["digests"]) == k + 2
          and b["digests"] + c["digests"] == a["digests"],
          f"16c: augmented batches A {len(a['digests'])}, B "
          f"{len(b['digests'])} (preempted {b['preempted']}), C "
          f"{len(c['digests'])}: B then C are not A's")
    final = {n: torch.load(os.path.join(tmp, f"16c_{d}", "final_state.pth"),
                           map_location="cpu") for n, d in (("a", "a"),
                                                            ("c", "b"))}
    diff = max_abs_diff(final["c"], final["a"])
    check(diff == 0.0, f"16c: resumed weights max |C - A| {diff:.3g}")
    n_val = sum(len(r["validations"]) for r in runs.values())
    eval_batches = -(-len(val_ds) // cfg.TEST.BATCH_SIZE_PER_GPU)
    check(launches["udp_offset_decode_fused"] == n_val * eval_batches,
          f"16c: fused decode launches {launches}")
    log(f"[device_aug] 16c AID w32 bf16 B={B} DATASET.DEVICE_AUG WORKERS 2, "
        f"cuDNN deterministic, {k} steps an epoch x 2: B stopped after step "
        f"{k + 2}, C resumed with AUTO_RESUME at iteration "
        f"{c['steps'][0]['iteration']}; the {2 * k} augmented batches "
        f"(crops, targets, weights) of B then C = A's bit for bit; final "
        f"weights max |C - A| = {diff:.6g}; three train.run in {secs:.1f} s; "
        f"fused decode launches {launches['udp_offset_decode_fused']} = "
        f"{n_val} validations x {eval_batches} batches | {card}")
    return launches


def fused_bn_ab(data, card, device="cuda", yaml=AID_YAML, batch=32):
    """16d: one w32 train step (B=32, the AID yaml's loss) with every
    train BatchNorm routed through ``ops.fused_bn.FusedBatchNorm`` against
    the plain BatchNorm from the same weights and batch: the output, the
    gradients (each tensor's and the whole gradient's relative 2-norm)
    and the running stats apart, in float64 (held at FUSED_BN_TOL: the
    same math), fp32 with TF32 off and bf16 (reported: the fast variance
    ``E[x²] - E[x]²`` against cuDNN's, rounded through 292 BatchNorms);
    then bf16 Adam steps of each, timed in turns."""
    from udp_pose_tpu_torch.core.loss import make_loss_fn
    from udp_pose_tpu_torch.core.train import (create_train_state,
                                               make_train_step, upload_batch)
    from udp_pose_tpu_torch.data.base import collate
    from udp_pose_tpu_torch.models import build_model
    from udp_pose_tpu_torch.ops.fused_bn import use_fused_batchnorm
    root, tmp, frames = data["root"], data["tmp"], data["frames"]

    def pair(dtype):
        cfg = aid_cfg(root, os.path.join(tmp, "16d"),
                      "float32" if dtype == "float64" else dtype, yaml)
        plain = build_model(cfg, device=device, train=True)
        fused = build_model(cfg, device=device, train=True)
        if dtype == "float64":
            plain, fused = plain.double(), fused.double()
        fused.load_state_dict(plain.state_dict())
        return cfg, plain, fused, use_fused_batchnorm(fused)

    cfg, *_ = pair("float32")
    ds = in_memory_coco(cfg, frames["train2017"], True)
    ds.seed(0)
    host = collate([ds[i] for i in range(batch)])
    x = upload_batch(host, device)
    loss_fn = make_loss_fn(cfg)
    apart = {}
    for dtype in ("float64", "float32", "bfloat16"):
        set_tf32(False)
        cfg, plain, fused, n_bn = pair(dtype)
        wide = torch.float64 if dtype == "float64" else torch.float32
        got = {}
        for name, model in (("plain", plain), ("fused", fused)):
            model.train()
            ctx = (torch.autocast(x["image"].device.type,
                                  dtype=torch.bfloat16)
                   if dtype == "bfloat16" else contextlib.nullcontext())
            with ctx:
                out = model(x["image"].to(wide).permute(0, 3, 1, 2))
            out = out.to(wide)
            loss, _ = loss_fn(out, x["target"].to(wide),
                              x["target_weight"].to(wide))
            loss.backward()
            got[name] = (out.detach(), {
                k: p.grad for k, p in model.named_parameters()}, {
                k: v for k, v in model.state_dict().items()
                if k.endswith(("running_mean", "running_var"))})
        set_tf32(True)

        def rel(a, b):
            return float((a.double() - b.double()).abs().max()
                         / b.double().abs().max().clamp_min(1e-30))

        (po, pg, ps), (fo, fg, fs) = got["plain"], got["fused"]
        per = {k: rel(fg[k], pg[k]) for k in pg}
        worst = max(per, key=per.get)
        norm2 = float(sum(float((fg[k].double() - pg[k].double()).square()
                                .sum()) for k in pg) ** 0.5
                      / sum(float(pg[k].double().square().sum())
                            for k in pg) ** 0.5)
        apart[dtype] = (rel(fo, po), per[worst],
                        max(rel(fs[k], ps[k]) for k in ps))
        log(f"[fused_bn] 16d w32 B={batch} {dtype}"
            f"{' (TF32 off)' if dtype == 'float32' else ''}: {n_bn} "
            f"BatchNorms through FusedBatchNorm against plain BN, one "
            f"forward and backward from the same weights: output "
            f"{apart[dtype][0]:.3g}, gradients {apart[dtype][1]:.3g} (the "
            f"worst tensor, {worst}; the whole gradient's 2-norm "
            f"{norm2:.3g}), running stats {apart[dtype][2]:.3g}, each x "
            f"the plain tensor's max | {card}")
        del plain, fused, got
        torch.cuda.empty_cache()
    check(max(apart["float64"]) <= FUSED_BN_TOL,
          f"16d: float64 FusedBatchNorm step vs plain {apart['float64']} "
          f"(limit {FUSED_BN_TOL:g})")
    check(all(np.isfinite(apart["float32"]) & np.isfinite(
        apart["bfloat16"])), f"16d: non-finite {apart}")
    cfg, plain, fused, _ = pair("bfloat16")
    step_fn = make_train_step(make_loss_fn(cfg))
    states = {name: create_train_state(cfg, model, steps_per_epoch=1)
              for name, model in (("plain", plain), ("fused", fused))}
    secs = {name: [] for name in states}
    for name in ("plain", "fused", "fused", "plain"):
        for i in range(6):
            t0 = time.perf_counter()
            loss = step_fn(states[name], upload_batch(host, device))["loss"]
            torch.cuda.synchronize()
            if i >= 2:
                secs[name].append(time.perf_counter() - t0)
        check(bool(torch.isfinite(loss)), f"16d: {name} bf16 loss {loss}")
    ms = {name: float(np.median(v)) * 1e3 for name, v in secs.items()}
    log(f"[fused_bn] 16d w32 bf16 B={batch} Adam step (upload, normalise, "
        f"forward, backward, Adam; median of 8 after 2 warm-up steps a "
        f"turn, turns plain, fused, fused, plain): plain BN {ms['plain']:.2f} "
        f"ms, FusedBatchNorm {ms['fused']:.2f} ms, fused / plain "
        f"{ms['fused'] / ms['plain']:.3f} | {card}")
    del states, plain, fused
    torch.cuda.empty_cache()
    return {"apart": apart, "step_ms": ms}


def rsn_fused_engine(card, device="cuda", yaml=RSN18_YAML, n_frames=4,
                     hw=DETECT_HW):
    """16e: ``FusedDetectPose`` over an ``rsn18`` pipeline (``USE_PRM``
    on, so that int8 puts PRM's 9x9 depthwise site on ``int8_dwconv``),
    YOLOv5n at 640, 16 persons on 720p frames, bf16 and int8 (the pose
    table calibrated by the pipeline, the detector by itself): keypoints
    against ``UdpPosePipeline.infer_pose`` on the boxes the engine found,
    launches in the engine's window (no fused decode: RSN decodes by its
    own blur and argmax; in int8 one launch a conv site a frame), frames/s
    of ``infer_frame``.  Returns {path: launches}."""
    from udp_pose_tpu_torch.engine.fused import FusedDetectPose
    from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
    from udp_pose_tpu_torch.models.quantize import (Int8Conv2d,
                                                    Int8DepthwiseConv2d)
    cfg = yaml_cfg(yaml, "bfloat16")
    cfg.MODEL.EXTRA.USE_PRM = True
    frames = detect_frames(n_frames, seed=160, hw=hw)
    kw = dict(yolo_variant="n", max_persons=MAX_PERSONS, det_size=DET_SIZE,
              conf_thres=LOW_CONF, seed=0)
    paths = {}
    for mode in ("", "int8"):
        name = f"rsn18_fused_detect_pose_{mode or 'bf16'}"
        pipe = UdpPosePipeline(cfg, device=device, seed=0, quantize=mode,
                               calib_batches=1)
        if mode:
            pipe.infer_pose(frames[0], person_boxes(MAX_PERSONS, 161, hw))
            check(pipe.int8.table is not None, "16e: no pose int8 table")
        eng = FusedDetectPose(pipe, quantize=mode, **kw)
        i = 0
        while eng.det_int8.calibrating:
            eng.infer_frame(frames[i % n_frames])
            i += 1
        eng.infer_frame(frames[0])                 # every shape warm
        torch.cuda.synchronize()
        zero_launches()
        outs = [eng.infer_frame(f) for f in frames]
        launches = read_launches()
        sites = [0, 0]
        want = dict.fromkeys(launches, 0)
        if mode:
            model = pipe.int8.active()
            sites = [sum(isinstance(m, k) for m in model.modules())
                     for k in (Int8Conv2d, Int8DepthwiseConv2d)]
            want["int8_conv_fused"] = n_frames * (sites[0]
                                                  + INT8_SITES_YOLOV5N)
            want["int8_dwconv"] = n_frames * sites[1]
        check(launches == want and (not mode or sites[1] > 0),
              f"16e {name}: launches {launches}, want {want}")
        check(all(len(o["boxes"]) == MAX_PERSONS for o in outs),
              f"16e {name}: persons {[len(o['boxes']) for o in outs]}")
        errs, mv_err = [], 0.0
        for f, o in zip(frames, outs):
            kp, mv = pipe.infer_pose(f, o["boxes"])
            errs.append(np.abs(o["keypoints"] - kp).max(-1).ravel())
            mv_err = max(mv_err, float(np.abs(o["maxvals"] - mv).max()
                                       / max(np.abs(mv).max(), 1e-30)))
        errs = np.concatenate(errs)
        agree = float((errs <= RSN_KP_ATOL).mean())
        again = pipe.infer_pose(frames[0], outs[0]["boxes"])[0]
        repeat = float((np.abs(again - pipe.infer_pose(
            frames[0], outs[0]["boxes"])[0]).max(-1) <= RSN_KP_ATOL).mean())
        fps, runs = time_frames(lambda: [eng.infer_frame(f) for f in frames],
                                n_frames)
        log(f"[rsn_fused] 16e FusedDetectPose {os.path.basename(yaml)} "
            f"(USE_PRM) {mode or 'bf16'}: YOLOv5n {DET_SIZE}, "
            f"{MAX_PERSONS} persons on {hw[0]}p frames; keypoints vs "
            f"UdpPosePipeline.infer_pose on the engine's boxes: "
            f"{agree:.4f} of {errs.size} joints within {RSN_KP_ATOL:g} px "
            f"(max {errs.max():.4g} px; limit {RSN_PERSONS_AGREE:g} of "
            f"them), maxvals {mv_err:.3g} x their max apart; infer_pose "
            f"twice on one frame's boxes: {repeat:.4f} of the joints within "
            f"{RSN_KP_ATOL:g} px; {sites[0]} int8 conv sites, "
            f"{sites[1]} depthwise; launches {launches}; infer_frame "
            f"{fps:.2f} frames/s (median of 3 runs of {n_frames} frames: "
            f"{', '.join(f'{r:.1f}' for r in runs)} ms) | {card}")
        check(agree >= RSN_PERSONS_AGREE and np.isfinite(errs).all(),
              f"16e {name}: {agree:.4f} of the joints agree")
        paths[name] = launches
        del eng, pipe
        torch.cuda.empty_cache()
    return paths


def alt_decoders(card, device="cuda", batch=SERVE_BATCH, hw=MAP_HW):
    """16f: ``simdr_decode`` and ``shift_decode`` on the card equal their
    CPU run exactly (int32 coordinates): B=128 x 17 maps of 64x48 with
    peaks on the borders and maps nowhere positive, SimDR heads of a
    256x192 crop at split ratio 2."""
    from udp_pose_tpu_torch.ops import alt_decode as ad
    rng = np.random.default_rng(170)
    H, W = hw
    hm = rng.normal(size=(batch, 17, H, W)).astype(np.float32)
    hm[0, :4, 0, 0] = hm[1, :4, H - 1, W - 1] = 9.0
    hm[2, 0] = -1.0
    center = rng.uniform(100, 600, (batch, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 2.5, (batch, 2)).astype(np.float32)
    px = rng.normal(size=(batch, 17, 2 * 192)).astype(np.float32)
    py = rng.normal(size=(batch, 17, 2 * 256)).astype(np.float32)
    out = {}
    for dev in ("cpu", device):
        out[dev] = (ad.shift_decode(torch.from_numpy(hm).to(dev), center,
                                    scale).cpu(),
                    ad.simdr_decode(torch.from_numpy(px).to(dev),
                                    torch.from_numpy(py).to(dev), center,
                                    scale).cpu())
    same = [torch.equal(a, b) for a, b in zip(out["cpu"], out[device])]
    log(f"[alt_decode] 16f shift_decode ({batch}x17 maps of {H}x{W}) and "
        f"simdr_decode ({batch}x17 heads of 384 and 512) on the card equal "
        f"their CPU run: {same} | {card}")
    check(all(same), f"16f: card vs CPU {same}")


def phase_device_aug(tmp, device="cuda"):
    """Phase 16, the single-card remainder: the on-device augmentation
    card vs CPU (16a), training with it (16b) and its preempted epoch
    (16c), the fused-BN A/B (16d), RSN in the detect-then-pose graph
    (16e), the alternative decoders (16f).  Returns the launches by
    path."""
    card = card_line()
    t_phase = time.perf_counter()
    rng = np.random.default_rng(160)
    root = os.path.join(tmp, "coco")
    resume_root = os.path.join(tmp, "coco_resume")
    data = {"root": root, "tmp": tmp, "resume_root": resume_root,
            "frames": {
                "train2017": synthetic_coco(root, "train2017", TRAIN_IMAGES,
                                            rng),
                "val2017": synthetic_coco(root, "val2017", VAL_IMAGES, rng)},
            "resume_frames": {
                "train2017": synthetic_coco(resume_root, "train2017",
                                            AUG_RESUME_IMAGES, rng),
                "val2017": synthetic_coco(resume_root, "val2017",
                                          RESUME_VAL_IMAGES, rng)}}
    paths, secs = {}, {}
    parts = (("16a", None, lambda: device_aug_card_vs_cpu(data, card,
                                                          device)),
             ("16b", "device_aug_training",
              lambda: device_aug_training(data, card, device)),
             ("16c", "device_aug_resume",
              lambda: device_aug_resume(data, card, device)),
             ("16d", None, lambda: fused_bn_ab(data, card, device)),
             ("16e", "", lambda: rsn_fused_engine(card, device)),
             ("16f", None, lambda: alt_decoders(card, device)))
    for part, name, fn in parts:
        t0 = time.perf_counter()
        got = fn()
        secs[part] = time.perf_counter() - t0
        if name:
            paths[name] = got
        elif name == "":
            paths.update(got)
    log(f"[device_aug] phase 16 {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{p} {v:.1f}" for p, v in secs.items()) + " s)")
    return paths


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--peak-before", metavar="CU",
        help="an earlier revision of udp_pose_tpu_torch/csrc/peak_offset.cu "
             "whose peak-only kernel phase 3 times in turns with this one")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 1
    log(f"[card] {card_line()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    try:
        phase_build()
        peak = phase_kernel(peak_before=args.peak_before)
        _, layout, profile_model = phase_model()
        # timed before any profiler session, like phase 5
        with tempfile.TemporaryDirectory() as tmp:
            detected, profile_detect = phase_detect(tmp)
        paths = {"detect_then_pose": detected}
        with tempfile.TemporaryDirectory() as tmp:
            int8_paths, int8_kernels, _, _ = phase_int8(tmp)
        with tempfile.TemporaryDirectory() as tmp:
            zoo_paths, decode_64, resnet_int8, _, profile_zoo = phase_zoo(
                tmp)
        with tempfile.TemporaryDirectory() as tmp:
            rsn_paths, rsn_int8_kernel, _, profile_rsn = phase_rsn(tmp)
        with tempfile.TemporaryDirectory() as tmp:
            mobile_paths, dw_kernel, _, profile_mobile = phase_mobile(tmp)
        with tempfile.TemporaryDirectory() as tmp:
            serve_paths = phase_serve(tmp)
        # 3b's one-launch check reads the profiler's kernel list, which
        # has missed the ctypes-launched kernel in a process's later
        # profiler sessions: 3b holds the first one
        fused = phase_fused()
        profile_model()
        profile_detect()
        for profile in profile_zoo + [profile_rsn] + profile_mobile:
            profile()
        phase_blur()
        paths["pose_serving"] = phase_server(w32_cfg("bfloat16"))
        with tempfile.TemporaryDirectory() as tmp:
            paths["training"] = phase_train(tmp)
        with tempfile.TemporaryDirectory() as tmp:
            paths.update(phase_resume(tmp))
        with tempfile.TemporaryDirectory() as tmp:
            paths.update(phase_distributed(tmp))
        with tempfile.TemporaryDirectory() as tmp:
            paths.update(phase_device_aug(tmp))
        paths.update(int8_paths)
        paths.update(zoo_paths)
        paths.update(rsn_paths)
        paths.update(mobile_paths)
        paths.update(serve_paths)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    decode = {"route": "cuda",
              "source": "udp_pose_tpu_torch/csrc/peak_offset.cu",
              "replaces": "udp_pose_tpu/ops/pallas/decode_kernels.py:83",
              "matched": True, "library_ms": None}
    int8 = {"route": "cuda",
            "source": "udp_pose_tpu_torch/csrc/int8_conv.cu",
            "matched": True}
    engine = {"source": "udp_pose_tpu_torch/csrc/int8_conv_sm90.cu",
              "sources": ["udp_pose_tpu_torch/csrc/int8_conv_sm90.cu",
                          "udp_pose_tpu_torch/csrc/int8_conv.cu"]}
    replaces = {"int8_conv_fused": "udp_pose_tpu/models/quantize.py:188-218",
                "quant_im2col": "udp_pose_tpu/models/quantize.py:203-204",
                "dequant_epilogue": "udp_pose_tpu/models/quantize.py:214-218"}

    def launches(name):
        by_path = {p: n[name] for p, n in paths.items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    int8_kernels["int8_conv_fused"]["pose_resnet50"] = resnet_int8
    int8_kernels["int8_conv_fused"]["rsn18"] = rsn_int8_kernel
    by_route = {}
    for path in PathLaunches.made:
        for route, n in path.routes.items():
            if n:
                by_path = by_route.setdefault(path.name, {})
                by_path[route] = by_path.get(route, 0) + n
    int8_kernels["int8_conv_fused"]["launches_by_route"] = by_route
    print(card_line())
    print(json.dumps({"kernels": [
        {"name": "udp_offset_decode_fused", **decode,
         **launches("udp_offset_decode_fused"),
         "layout": layout, **fused[layout],
         "mpii_b128_c48_64x64": decode_64},
        {"name": "fused_peak_offset", **decode,
         **launches("fused_peak_offset"), "on_main_path": False, **peak},
    ] + [{"name": name, **int8,
          **(engine if name == "int8_conv_fused" else {}),
          "replaces": replaces[name], **launches(name),
          **int8_kernels[name]} for name in INT8_KERNELS] + [
        {"name": "int8_dwconv", "route": "cuda",
         "source": "udp_pose_tpu_torch/csrc/int8_dwconv.cu",
         "replaces": "udp_pose_tpu/models/quantize.py:206-213",
         "matched": True, **launches("int8_dwconv"), **dw_kernel},
        {"name": "int8_dwconv_tiled", "route": "cuda",
         "source": "udp_pose_tpu_torch/csrc/int8_dwconv.cu",
         "replaces": "udp_pose_tpu/models/quantize.py:206-213",
         "on_main_path": False, "matched": True,
         **launches("int8_dwconv_tiled"),
         "ms": dw_kernel["previous_design_ms"],
         "max_abs_err": dw_kernel["previous_design_max_abs_err"],
         **{k: dw_kernel[k] for k in ("plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "cudnn_bf16_dwconv_ms",
                                      "per")}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
