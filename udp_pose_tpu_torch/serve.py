"""Pose-serving daemon of the PyTorch port (port of ``tools/serve.py``).

Serves ``/v1/pose`` (client-supplied boxes; crops micro-batched across
requests into one device batch), with ``--detector`` also
``/v1/detect_pose`` (frames of concurrent requests batched into one
detect-then-pose chunk), ``/healthz`` and ``/metrics`` over
:mod:`udp_pose_tpu_torch.engine.server`:

    python -m udp_pose_tpu_torch.serve \
        --cfg configs/coco/hrnet_w32_256x192_udp_offset.yaml --port 0 \
        [--detector yolov5n] [--quantize int8 [--act-scales t.json]]
"""

from __future__ import annotations

import argparse
import signal
import sys


def parse_args(argv=None):
    from .engine.detector import DETECTORS, detector_name
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", required=True, help="pose model yaml")
    p.add_argument("--weights", default="",
                   help="reference .pth pose weights "
                        "(default: seeded random init, smoke mode)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="0 picks a free port (printed on startup)")
    p.add_argument("--flip", dest="flip", action="store_true",
                   default=None, help="force flip-test on (default: cfg)")
    p.add_argument("--no-flip", dest="flip", action="store_false",
                   help="force flip-test off")
    p.add_argument("--max-batch", type=int, default=64,
                   help="max crops per device batch")
    p.add_argument("--window-ms", type=float, default=3.0,
                   help="micro-batch collection window after the first "
                        "request")
    p.add_argument("--detector", default="", type=detector_name,
                   choices=("",) + DETECTORS,
                   help="enable /v1/detect_pose with this YOLOv5 variant "
                        "(n/s/m/l or yolov5n/...)")
    p.add_argument("--detector-weights", default="",
                   help="ultralytics YOLOv5 state dict (.pt/.pth) "
                        "(default: seeded random init)")
    p.add_argument("--max-persons", type=int, default=16,
                   help="person rows a /v1/detect_pose frame carries")
    p.add_argument("--max-frames", type=int, default=8,
                   help="max frames of concurrent /v1/detect_pose "
                        "requests per device batch")
    p.add_argument("--quantize", default=None, choices=[None, "", "int8"],
                   help="int8 = w8a8 PTQ serving (self-calibrates on the "
                        "first batches); '' forces off (default: the "
                        "cfg's TPU.QUANTIZE)")
    p.add_argument("--act-scales", default="",
                   help="precomputed int8 calibration table (json)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .config import load_config
    from .engine.server import PoseServer, PoseService

    service = PoseService(
        load_config(args.cfg), weights=args.weights or None,
        flip_test=args.flip, max_batch=args.max_batch,
        window_ms=args.window_ms, device=args.device,
        detector=args.detector,
        detector_weights=args.detector_weights or None,
        max_persons=args.max_persons, max_frames=args.max_frames,
        quantize=args.quantize, act_scales=args.act_scales or None)
    server = PoseServer(service, host=args.host, port=args.port)

    def stop(signum, frame):
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, stop)
    signal.signal(signal.SIGINT, stop)
    print(f"serving on http://{server.host}:{server.port}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.shutdown()


if __name__ == "__main__":
    sys.exit(main())
