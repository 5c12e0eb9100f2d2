#!/usr/bin/env python3
"""Drive the PyTorch port (``udp_pose_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--peak-before OLD/peak_offset.cu]

Builds the port's CUDA source ``udp_pose_tpu_torch/csrc/peak_offset.cu``
and holds both of its kernels bit for bit against their plain PyTorch
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
epochs through ``train.run``, validating through the fused kernel, then
evaluates and serves the weights it wrote (phase 7).  The kernels'
launches count phases 6 and 7.  Any failed check exits nonzero before
the last line, which is
``{"ok": true, "device": {...}}``.  Without a CUDA card it exits 1.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
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


def host_ms(fn, iters=10):
    """ms per call on the host clock, each call ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def profile_device(fn, n=3):
    """torch.profiler over ``n`` calls: (wall ms, device-busy ms, the
    top device kernels by time).  Busy time is the sum of the kernels'
    and copies' durations on the card (one stream here)."""
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
    dev = [(e.key, e.self_device_time_total / 1e3)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, t in dev)
    return wall, busy, sorted(dev, key=lambda kv: -kv[1])[:8]


def set_tf32(enabled):
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled


# ---------------------------------------------------------------- phase 2
def phase_build():
    from udp_pose_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load("peak_offset")
    secs = time.perf_counter() - t0
    log(f"[build] peak_offset.cu -> {_build.library_path('peak_offset')} "
        f"in {secs:.2f} s")
    if "peak_offset" in _build.build_logs:
        log("[build] nvcc: " + _build.build_logs["peak_offset"][1].strip())
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
def decode_inputs(seed, device="cuda", batch=SERVE_BATCH, hw=MAP_HW):
    """(batch, 51, H, W) net outputs whose heatmap channels are the six
    map families and whose offset channels are noise, per layout."""
    J = 17
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


def bound_of(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
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
            wall, busy, top = profile_device(
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
    from udp_pose_tpu_torch.engine.server import PoseServer, PoseService
    from udp_pose_tpu_torch.ops.peak_offset import (fused_peak_offset,
                                                    udp_offset_decode_fused)

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

        fused_peak_offset.launches = udp_offset_decode_fused.launches = 0
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(n_requests)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        launches = {"udp_offset_decode_fused":
                    udp_offset_decode_fused.launches,
                    "fused_peak_offset": fused_peak_offset.launches}
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
        # pipeline: the same bucket shapes, so the same numbers
        worst = 0.0
        for frame, boxes in reqs:
            status, body, _ = post_pose(server.port, frame, boxes)
            check(status == 200, f"/v1/pose answered {status}: {body}")
            kp, sc = service.pipe.infer_pose(frame, boxes)
            worst = max(worst,
                        float(np.abs(kp - body["keypoints"]).max()),
                        float(np.abs(sc - body["scores"]).max()))
        log(f"[serve] each request alone, served vs UdpPosePipeline."
            f"infer_pose: max abs difference {worst:.3g}")
        check(worst <= 1e-3, "served results != UdpPosePipeline.infer_pose")
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
TRAIN_IMAGES, VAL_IMAGES, PEOPLE = 64, 32, 2
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


def in_memory_coco(cfg, frames, is_train):
    """The package's ``COCODataset`` with two seams replaced: images come
    from ``frames`` instead of files, and crops from the port's native
    float warp rounded to u8 instead of OpenCV.  Everything else (json,
    db, augmentation, targets) is the package's."""
    from udp_pose_tpu_torch.data.coco import COCODataset
    from udp_pose_tpu_torch.native import warp_affine_batch

    class InMemoryCOCO(COCODataset):
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


def repeated_batch_steps(cfg, batch, card, n_steps=8, device="cuda"):
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
    log(f"[train] (b) w32 bf16 B={B}, one pre-built batch repeated: losses "
        f"{', '.join(f'{v:.5g}' for v in losses)}; step "
        f"{', '.join(f'{s * 1e3:.1f}' for s in secs)} ms (first "
        f"{WARM_STEPS} warm-up); median {ms:.2f} ms/step = "
        f"{B / ms * 1e3:.1f} samples/s (upload + normalise + forward + "
        f"backward + Adam) | {card}")
    del state
    torch.cuda.empty_cache()
    return secs


def profile_train(cfg, model, batch, card, n=3, device="cuda"):
    """Where a bf16 step's time goes: ``n`` steps of ``model`` (fresh Adam
    state) on one pre-built batch under torch.profiler, after two
    unprofiled ones; host and device ms a step of the ``train/*`` ranges
    of :mod:`udp_pose_tpu_torch.core.train`, device-busy share, kernels
    a step and the top kernels.  Run last: a profiler session slows the
    process's later launches."""
    from torch.profiler import ProfilerActivity, profile

    from udp_pose_tpu_torch.core.loss import make_loss_fn
    from udp_pose_tpu_torch.core.train import (create_train_state,
                                               make_train_step, upload_batch)
    state = create_train_state(cfg, model, steps_per_epoch=1)
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
    log(f"[train] profile, bf16 B={len(batch['image'])} step from one "
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

    # the run, with the kernels' counts read just after it
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=device, train=True)
    po.udp_offset_decode_fused.launches = po.fused_peak_offset.launches = 0
    t0 = time.perf_counter()
    record = train_cli.run(cfg, model, train_ds, val_ds, out_dir, device)
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    weights = os.path.join(out_dir, "final_state.pth")
    t0 = time.perf_counter()
    _, perf = test_cli.run(cfg, weights, val_ds, out_dir, device)
    test_s = time.perf_counter() - t0
    launches = {"udp_offset_decode_fused": po.udp_offset_decode_fused.launches,
                "fused_peak_offset": po.fused_peak_offset.launches}
    eval_batches = -(-len(val_ds) // cfg.TEST.BATCH_SIZE_PER_GPU)
    n_val = len(record["validations"]) + 1
    check(launches["udp_offset_decode_fused"] == n_val * eval_batches,
          f"fused decode launched {launches['udp_offset_decode_fused']} "
          f"times for {n_val} validations of {eval_batches} batches")
    check(launches["fused_peak_offset"] == 0, "peak-only kernel launched")

    steps = record["steps"]
    losses = [s["loss"] for s in steps]
    check(len(steps) == cfg.TRAIN.END_EPOCH * (len(train_ds) // B),
          f"{len(steps)} steps")
    check(all(np.isfinite(losses)), f"non-finite bf16 loss: {losses}")
    iter_ms = np.median([s["iter_s"] for s in steps[WARM_STEPS:]]) * 1e3
    load_ms = np.median([s["load_s"] for s in steps[WARM_STEPS:]]) * 1e3
    rep_ms = np.median(repeated[WARM_STEPS:]) * 1e3
    iters = ", ".join(f"{s['iter_s'] * 1e3:.1f}" for s in steps)
    loads = ", ".join(f"{s['load_s'] * 1e3:.1f}" for s in steps)
    log(f"[train] train.run w32 bf16 B={B}, {len(steps)} steps over "
        f"{cfg.TRAIN.END_EPOCH} epochs of {len(train_ds)} samples: losses "
        f"{', '.join(f'{v:.5g}' for v in losses)}; iteration {iters} ms "
        f"(batch building {loads} ms) | {card}")
    log(f"[train] samples/s after {WARM_STEPS} warm-up steps: with the "
        f"loader {B / iter_ms * 1e3:.1f} (median iteration {iter_ms:.2f} "
        f"ms, of which batch building {load_ms:.2f} ms); one pre-built "
        f"batch repeated {B / rep_ms * 1e3:.1f} (median step {rep_ms:.2f} "
        f"ms); host sample building {load_ms / B:.3f} ms/sample in the run, "
        f"{host_ms:.3f} ms/sample for the first batch; peak "
        f"max_memory_allocated {peak_gb:.2f} GB; train.run {run_s:.1f} s "
        f"| {card}")
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


# ------------------------------------------------------------------ main
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
        # 3b's one-launch check reads the profiler's kernel list, which
        # has missed the ctypes-launched kernel in a process's later
        # profiler sessions: 3b holds the first one
        fused = phase_fused()
        profile_model()
        phase_blur()
        launches = phase_server(w32_cfg("bfloat16"))
        with tempfile.TemporaryDirectory() as tmp:
            trained = phase_train(tmp)
        launches = {k: v + trained[k] for k, v in launches.items()}
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    common = {"route": "cuda",
              "source": "udp_pose_tpu_torch/csrc/peak_offset.cu",
              "replaces": "udp_pose_tpu/ops/pallas/decode_kernels.py:83",
              "matched": True, "library_ms": None}
    print(card_line())
    print(json.dumps({"kernels": [
        {"name": "udp_offset_decode_fused", **common,
         "launches": launches["udp_offset_decode_fused"],
         "layout": layout, **fused[layout]},
        {"name": "fused_peak_offset", **common,
         "launches": launches["fused_peak_offset"], "on_main_path": False,
         **peak},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
