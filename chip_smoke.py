#!/usr/bin/env python3
"""Drive the PyTorch port (``udp_pose_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``udp_pose_tpu_torch/csrc`` and holds
it against its plain PyTorch version on the card; checks the fp32 blur;
runs full-width HRNet-w32 256×192 UDP-offset (seeded random weights)
against the port on the CPU and times the flip-test serving graph; then
serves ``/v1/pose`` requests over HTTP through the kernel.  Any failed
check exits nonzero before the last line, which is
``{"ok": true, "device": {...}}``.  Without a CUDA card it exits 1.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import http.client
import io
import json
import subprocess
import sys
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
# H100 SXM data sheet: device memory rate (bytes/s), fp32 rate outside the
# tensor cores (operations/s)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
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


def phase_kernel(device="cuda"):
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
    ms = cuda_ms(fused_peak_offset, sets)
    plain_ms = cuda_ms(fused_peak_offset_reference, sets, iters=20)
    H, W = MAP_HW
    # bytes the function must move: each heatmap read once, the two
    # offsets read at the peak, the (N, 5) result written once
    bytes_moved = N_MAPS * (H * W + 2 + 5) * 4
    ops = N_MAPS * H * W            # one compare per heatmap element
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S,
                   ops / FP32_OPS_PER_S) * 1e3
    bound_by = ("bytes" if bytes_moved / HBM_BYTES_PER_S
                >= ops / FP32_OPS_PER_S else "operations")
    log(f"[kernel] fused_peak_offset N={N_MAPS} {H}x{W}: bit-equal to the "
        f"plain version on peaky/noise/negative/constant/tie/NaN maps; "
        f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
        f"bound {bound_ms * 1e3:.2f} us ({bound_by})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


# ---------------------------------------------------------------- phase 4
def phase_blur(device="cuda", shape=(SERVE_BATCH, 51) + MAP_HW):
    from udp_pose_tpu_torch.ops.blur import blur_matrix_f64, gaussian_blur
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(4))
    xd = x.to(device)
    x64 = x.numpy().astype(np.float64)
    H, W = shape[-2:]
    for ksize in (15, 7):
        got = gaussian_blur(xd, ksize).cpu().numpy()
        want = blur_matrix_f64(H, ksize, 0.0) @ x64 @ \
            blur_matrix_f64(W, ksize, 0.0).T
        err = float(np.abs(got - want).max())
        log(f"[blur] {ksize}x{ksize} at {tuple(shape)}: max abs err vs "
            f"float64 {err:.3g} (limit {BLUR_ATOL:g})")
        check(err <= BLUR_ATOL, f"blur {ksize}: {err} > {BLUR_ATOL}")


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


def phase_model(cfg_fn=w32_cfg, batch=SERVE_BATCH, iters=10,
                device="cuda"):
    from udp_pose_tpu_torch.ops import peak_offset as po
    from udp_pose_tpu_torch.ops.decode import get_final_preds, transform_preds

    launches0 = po.fused_peak_offset.launches
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

    # (b) decode of the same card heatmaps: kernel vs plain version
    crops, center, scale = random_crops(batch, cfg32, seed=6)
    preds, maxvals, hm = gpu(crops, center, scale)
    maps = po.blurred_offset_maps(hm, cfg32.LOSS.KPD)
    decoded = []
    for peak in (po.fused_peak_offset, po.fused_peak_offset_reference):
        coords, mv = po.packed_to_coords(
            peak(*maps).reshape(batch, -1, 5))
        decoded.append((transform_preds(
            coords, torch.from_numpy(center).to(device),
            torch.from_numpy(scale).to(device), hm.shape[:1:-1]), mv))
    check(same_bits(decoded[0][0], decoded[1][0])
          and same_bits(decoded[0][1], decoded[1][1]),
          "decode with the kernel != decode with the plain version")
    check(same_bits(decoded[0][0], preds) and same_bits(decoded[0][1],
                                                         maxvals),
          "make_infer_fn preds != kernel decode of its own heatmaps")
    check(bool(torch.isfinite(preds).all()), "non-finite preds")
    log(f"[model] w32 fp32 B={batch} decode: kernel == plain version "
        f"(preds {tuple(preds.shape)}, maxvals {tuple(maxvals.shape)}; "
        f"{int((maxvals <= 0).sum())} of {maxvals.numel()} peaks <= 0)")

    # (c) crops/s of the flip-test serving graph from host u8 crops
    set_tf32(True)             # PyTorch's default for cuDNN convs
    torch.backends.cuda.matmul.allow_tf32 = False
    rates = {}
    card = card_line()
    for dtype in ("bfloat16", "float32"):
        for mode in ("two_pass", "fold"):
            infer = infer_for(cfg_fn(dtype), device, flip_mode=mode)
            ms = [host_ms(lambda: infer(crops, center, scale), iters)
                  for _ in range(3)]
            rate = batch / np.median(ms) * 1e3
            rates[f"{dtype}/{mode}"] = rate
            log(f"[model] w32 256x192 flip B={batch} {dtype} {mode}: "
                f"{rate:.1f} crops/s (median of 3 runs of {iters} batches: "
                f"{', '.join(f'{m:.2f}' for m in ms)} ms/batch; host u8 "
                f"crops in, decoded preds out; cuDNN TF32 convs on for "
                f"float32) | {card}")
            if dtype == "bfloat16":
                # where a batch's time goes, outside the forwards
                c = torch.from_numpy(center).to(device)
                s = torch.from_numpy(scale).to(device)
                _, _, hm = infer(crops, center, scale)
                h2d = host_ms(lambda: torch.as_tensor(crops, device=device))
                dec = cuda_ms(lambda h: get_final_preds(
                    h, c, s, target_type="offset", kpd=4.0), [(hm,)],
                    iters=20)
                log(f"[model]   {mode} B={batch}: u8 crops host->card "
                    f"{h2d:.3f} ms, decode (blurs + peak kernel + "
                    f"transform) {dec:.3f} ms, of {np.median(ms):.2f} "
                    f"ms/batch")
                wall, busy, top = profile_device(
                    lambda: infer(crops, center, scale))
                if busy > 0:
                    log(f"[model]   {mode} profile: 3 batches {wall:.2f} ms "
                        f"wall, card busy {busy:.2f} ms (idle share "
                        f"{1 - busy / wall:.3f}); top kernels (ms): "
                        + "; ".join(f"{k[:60]} {t:.2f}" for k, t in top))
                else:
                    log(f"[model]   {mode} profile: the profiler saw no "
                        "device time; idle share not measured")
            del infer
            torch.cuda.empty_cache()
    check(po.fused_peak_offset.launches > launches0,
          "the model phase never launched the peak kernel")
    return rates


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
    """Returns the peak kernel's launches while serving the requests."""
    from udp_pose_tpu_torch.engine.server import PoseServer, PoseService
    from udp_pose_tpu_torch.ops.peak_offset import fused_peak_offset

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

        fused_peak_offset.launches = 0
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(n_requests)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        launches = fused_peak_offset.launches
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
            f"{list(batches)}; peak kernel launches {launches}")
        check(len(batches) < n_requests,
              f"no coalescing: {len(batches)} batches for "
              f"{n_requests} requests")
        check(launches > 0, "serving never launched the peak kernel")

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


# ------------------------------------------------------------------ main
def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 1
    log(f"[card] {card_line()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    try:
        phase_build()
        kernel = phase_kernel()
        phase_blur()
        phase_model()
        launches = phase_server(w32_cfg("bfloat16"))
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "fused_peak_offset",
        "route": "cuda",
        "source": "udp_pose_tpu_torch/csrc/peak_offset.cu",
        "replaces": "udp_pose_tpu/ops/pallas/decode_kernels.py:83",
        "launches": launches,
        "matched": True,
        "library_ms": None,
        **kernel,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
