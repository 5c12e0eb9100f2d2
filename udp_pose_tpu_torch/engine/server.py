"""HTTP pose-serving daemon with cross-request micro-batching.

Port of ``udp_pose_tpu/engine/server.py``: concurrent clients' person
crops are warped on the host (native batch warp), concatenated
into ONE padded device batch, and decoded back to per-request
source-space keypoints; with a detector, concurrent clients' frames of
one size run as one :meth:`.fused.FusedDetectPose.infer_frames` chunk.
Stdlib-only (``http.server``).  Endpoints:

  GET  /healthz         liveness + engine state (model, device, detector,
                        int8 mode and whether its table is calibrated)
  GET  /metrics         Prometheus text: request counts, latency quantiles,
                        crop and frame batch occupancy, persons served
  POST /v1/pose         image + boxes → keypoints (top-down, micro-batched)
  POST /v1/detect_pose  image → boxes, det_scores, keypoints, scores
                        (needs a detector; 409 without one)

Request bodies: ``application/json`` with ``{"image_b64": ..., "boxes":
[[x1,y1,x2,y2], ...]}``; or raw ``image/jpeg`` / ``image/png`` /
``application/octet-stream`` bytes (boxes via the ``X-Boxes`` header or a
``boxes=`` query parameter); or ``application/x-npy`` carrying an
(H, W, 3) RGB uint8 array, which needs numpy only.  Encoded images are
decoded BGR with cv2 and converted to RGB.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from .errors import EngineStateError

MAX_BODY_BYTES = 32 * 1024 * 1024
MAX_BOXES_PER_REQUEST = 256


def host_crops(img, boxes, input_wh):
    """(H, W, 3) RGB u8 + (N, ≥4) xyxy → (crops_u8, center, scale):
    ``xyxy_to_cs`` geometry and the classic 3-point affine, warped by the
    native kernel in one C call."""
    from ..native import warp_affine_batch
    from ..ops.affine import classic_affine_mats_np
    from ..ops.boxes import xyxy_to_cs

    boxes = np.asarray(boxes, np.float32)
    center, scale = xyxy_to_cs(boxes[:, :4], input_wh)
    w, h = input_wh
    mats = classic_affine_mats_np(center, scale, (w, h))
    crops = warp_affine_batch(np.ascontiguousarray(img), mats, (h, w))
    crops_u8 = np.clip(np.rint(crops), 0, 255).astype(np.uint8)
    return crops_u8, center, scale


def _drain_queue(q):
    """Fail (rather than strand) jobs still queued at shutdown."""
    while True:
        try:
            j = q.get_nowait()
        except queue.Empty:
            return
        if j is None:
            continue
        j.exc = EngineStateError("batcher closed before dispatch")
        j.event.set()


def _collect(q, first, window_s, room):
    """The jobs of one dispatch: ``first``, then more from ``q`` while
    ``room(batch)`` holds, waiting at most ``window_s`` after the first so
    that a lone request is not held hostage; a shutdown sentinel goes
    back on the queue."""
    batch = [first]
    deadline = time.monotonic() + window_s
    while room(batch):
        wait = deadline - time.monotonic()
        if wait <= 0 and q.empty():
            break
        try:
            nxt = q.get(timeout=max(wait, 0.0))
        except queue.Empty:
            break
        if nxt is None:                # shutdown: finish this batch
            q.put(None)
            break
        batch.append(nxt)
    return batch


class _Job:
    __slots__ = ("crops", "center", "scale", "n", "event", "preds",
                 "maxvals", "exc")

    def __init__(self, crops, center, scale):
        self.crops, self.center, self.scale = crops, center, scale
        self.n = crops.shape[0]
        self.event = threading.Event()
        self.preds = self.maxvals = self.exc = None


class CropBatcher:
    """Single dispatcher thread owning the pose graph; concurrent callers
    enqueue (crops, center, scale) jobs and block on their result.

    The dispatcher drains the queue up to ``max_batch`` crops (waiting at
    most ``window_ms`` after the first job so a lone request is not held
    hostage), runs ONE bucket-padded batch through the pipeline, and
    scatters the results back.  ``batch_log`` keeps the crops of each
    dispatch."""

    def __init__(self, pipe, max_batch=64, window_ms=3.0):
        self.pipe = pipe
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1e3
        self._q = queue.Queue()
        self._closed = False
        self.batch_log = deque(maxlen=4096)   # crops per dispatch
        self._log_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pose-batcher")
        self._thread.start()

    def infer(self, crops_u8, center, scale):
        """Blocking: returns (preds (n, J, 2), maxvals (n, J, 1))."""
        if self._closed:
            raise EngineStateError("batcher is closed")
        job = _Job(crops_u8, center, scale)
        self._q.put(job)
        job.event.wait()
        if job.exc is not None:
            raise job.exc
        return job.preds, job.maxvals

    def log_snapshot(self):
        """Race-free copy of batch_log."""
        with self._log_lock:
            return tuple(self.batch_log)

    def close(self):
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=10)
        _drain_queue(self._q)          # jobs that raced the sentinel

    def _loop(self):
        while True:
            job = self._q.get()
            if job is None:
                _drain_queue(self._q)
                return
            batch = _collect(self._q, job, self.window_s,
                             lambda b: sum(j.n for j in b) < self.max_batch)
            total = sum(j.n for j in batch)
            try:
                self._dispatch(batch, total)
            except Exception as e:                 # scatter the failure
                for j in batch:
                    j.exc = e
                    j.event.set()

    def _dispatch(self, batch, total):
        # the pipeline pads to the bucket; while it calibrates int8 it
        # records and serves the padded batch in float (server.py:196-240
        # there)
        crops = np.concatenate([j.crops for j in batch])
        center = np.concatenate([j.center for j in batch])
        scale = np.concatenate([j.scale for j in batch])
        with self._log_lock:
            self.batch_log.append(total)
        preds, maxvals = self.pipe.infer_crops(crops, center, scale)
        off = 0
        for j in batch:
            j.preds = preds[off:off + j.n]
            j.maxvals = maxvals[off:off + j.n]
            off += j.n
            j.event.set()


class _FrameJob:
    __slots__ = ("frame", "event", "out", "exc")

    def __init__(self, frame):
        self.frame = frame
        self.event = threading.Event()
        self.out = self.exc = None


class FrameBatcher:
    """Cross-request frame batching for the detect-then-pose engine.

    A dispatcher thread drains up to ``max_frames`` queued frames
    (waiting ``window_ms`` after the first), groups them by (H, W), and
    runs each group as one :meth:`.fused.FusedDetectPose.infer_frames`
    chunk of its own size; a lone frame takes ``infer_frame``.  A 720p frame's detection
    and at most ``max_persons`` crops leave the card mostly idle, so
    frames of several callers share one detector batch, one NMS and one
    pose batch.  ``batch_log`` keeps the frames of each dispatch."""

    def __init__(self, fused, max_frames=8, window_ms=3.0):
        self.fused = fused
        self.max_frames = max(1, int(max_frames))
        self.window_s = float(window_ms) / 1e3
        self._q = queue.Queue()
        self._closed = False
        self.batch_log = deque(maxlen=4096)    # frames per dispatch
        self._log_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="frame-batcher")
        self._thread.start()

    def infer(self, frame):
        """Blocking: returns the fused engine's per-frame result dict."""
        if self._closed:
            raise EngineStateError("batcher is closed")
        job = _FrameJob(frame)
        self._q.put(job)
        job.event.wait()
        if job.exc is not None:
            raise job.exc
        return job.out

    def log_snapshot(self):
        with self._log_lock:
            return tuple(self.batch_log)

    def close(self):
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=10)
        _drain_queue(self._q)          # jobs that raced the sentinel

    def _loop(self):
        while True:
            job = self._q.get()
            if job is None:
                _drain_queue(self._q)
                return
            batch = _collect(self._q, job, self.window_s,
                             lambda b: len(b) < self.max_frames)
            groups = {}
            for j in batch:
                groups.setdefault(j.frame.shape[:2], []).append(j)
            for group in groups.values():
                try:
                    self._dispatch(group)
                except Exception as e:                 # scatter the failure
                    for j in group:
                        j.exc = e
                        j.event.set()

    def _dispatch(self, group):
        with self._log_lock:
            self.batch_log.append(len(group))
        if len(group) == 1:
            group[0].out = self.fused.infer_frame(group[0].frame)
            group[0].event.set()
            return
        frames = np.stack([j.frame for j in group])
        for j, out in zip(group, self.fused.infer_frames(frames)):
            j.out = out
            j.event.set()


class Metrics:
    """Lock-guarded counters + latency ring buffers, rendered as
    Prometheus text on scrape."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = {}             # (endpoint, code) -> count
        self.persons = 0
        self.latency = {}              # endpoint -> deque of seconds
        self.started = time.time()

    def observe(self, endpoint, code, seconds, persons=0):
        with self._lock:
            key = (endpoint, int(code))
            self.requests[key] = self.requests.get(key, 0) + 1
            self.persons += persons
            self.latency.setdefault(endpoint, deque(maxlen=4096)).append(
                seconds)

    def render(self, batch_log=(), frame_batch_log=()):
        with self._lock:
            lines = ["# TYPE udp_pose_requests_total counter"]
            for (ep, code), n in sorted(self.requests.items()):
                lines.append(
                    f'udp_pose_requests_total{{endpoint="{ep}",'
                    f'code="{code}"}} {n}')
            lines.append("# TYPE udp_pose_persons_total counter")
            lines.append(f"udp_pose_persons_total {self.persons}")
            lines.append("# TYPE udp_pose_uptime_seconds gauge")
            lines.append(
                f"udp_pose_uptime_seconds {time.time() - self.started:.1f}")
            lines.append("# TYPE udp_pose_latency_seconds summary")
            for ep, buf in sorted(self.latency.items()):
                arr = np.asarray(buf)
                for q in (0.5, 0.9, 0.99):
                    lines.append(
                        f'udp_pose_latency_seconds{{endpoint="{ep}",'
                        f'quantile="{q}"}} {np.quantile(arr, q):.6f}')
                lines.append(
                    f'udp_pose_latency_seconds_count{{endpoint="{ep}"}} '
                    f"{len(arr)}")
        if batch_log:
            arr = np.asarray(batch_log)
            lines.append("# TYPE udp_pose_batch_crops gauge")
            lines.append(f'udp_pose_batch_crops{{stat="mean"}} '
                         f"{arr.mean():.3f}")
            lines.append(f'udp_pose_batch_crops{{stat="max"}} {arr.max()}')
            lines.append("# TYPE udp_pose_batches_total counter")
            lines.append(f"udp_pose_batches_total {len(arr)}")
        if frame_batch_log:
            arr = np.asarray(frame_batch_log)
            lines.append("# TYPE udp_pose_batch_frames gauge")
            lines.append(f'udp_pose_batch_frames{{stat="mean"}} '
                         f"{arr.mean():.3f}")
            lines.append(f'udp_pose_batch_frames{{stat="max"}} {arr.max()}')
            lines.append("# TYPE udp_pose_frame_batches_total counter")
            lines.append(f"udp_pose_frame_batches_total {len(arr)}")
        return "\n".join(lines) + "\n"


class PoseService:
    """The engine bundle behind the HTTP layer: a ``UdpPosePipeline`` on
    ``device`` fronted by a :class:`CropBatcher` for /v1/pose and, with a
    ``detector`` (``yolov5n`` … ``yolov5l``), a
    :class:`.fused.FusedDetectPose` fronted by a :class:`FrameBatcher`
    for /v1/detect_pose.  ``det_kwargs`` go to ``FusedDetectPose``
    (``det_size``, ``conf_thres``, ``iou_thres``, ``padding``, ...)."""

    def __init__(self, cfg, weights=None, flip_test=None, max_batch=64,
                 window_ms=3.0, device="cuda", seed=0, detector="",
                 detector_weights=None, max_persons=16, max_frames=8,
                 det_kwargs=None, quantize=None, act_scales=None):
        from .pose_engine import UdpPosePipeline

        self.pipe = UdpPosePipeline(cfg, weights, flip_test=flip_test,
                                    device=device, seed=seed,
                                    quantize=quantize,
                                    act_scales=act_scales)
        # build the native warp and, on the card, the kernels now rather
        # than inside the first request
        from .. import native
        native.load()
        if self.pipe.device.type == "cuda":
            from ..ops import _build
            _build.load("peak_offset")
            if self.pipe.int8.quantize:
                _build.load("int8_conv")
        self.batcher = CropBatcher(self.pipe, max_batch=max_batch,
                                   window_ms=window_ms)
        self.metrics = Metrics()
        self.fused = self.frame_batcher = None
        if detector:
            from .detector import detector_name
            from .fused import FusedDetectPose
            # the fused engine shares the pipeline, and with it the pose
            # calibration table that /v1/pose batches record
            variant = detector_name(detector).replace("yolov5", "")
            self.fused = FusedDetectPose(
                self.pipe, yolo_variant=variant,
                yolo_weights=detector_weights, max_persons=max_persons,
                quantize=quantize, seed=seed, **(det_kwargs or {}))
            self.frame_batcher = FrameBatcher(self.fused,
                                              max_frames=max_frames,
                                              window_ms=window_ms)

    def pose(self, img, boxes):
        """img (H, W, 3) RGB u8; boxes (N, ≥4) xyxy → result dict."""
        boxes = np.asarray(boxes, np.float32)
        if boxes.ndim != 2 or boxes.shape[1] < 4:
            raise ValueError("boxes must be (N, >=4) xyxy")
        if boxes.shape[0] > MAX_BOXES_PER_REQUEST:
            raise ValueError(
                f"too many boxes ({boxes.shape[0]} > "
                f"{MAX_BOXES_PER_REQUEST})")
        if boxes.shape[0] == 0:
            j = self.pipe.num_joints
            return {"keypoints": np.zeros((0, j, 2), np.float32),
                    "scores": np.zeros((0, j, 1), np.float32)}
        crops, center, scale = host_crops(img, boxes, self.pipe.input_wh)
        preds, maxvals = self.batcher.infer(crops, center, scale)
        return {"keypoints": preds, "scores": maxvals}

    def detect_pose(self, img):
        """img (H, W, 3) RGB u8 → boxes, det_scores, keypoints, scores of
        the persons the detector finds."""
        if self.fused is None:
            raise EngineStateError(
                "server started without --detector; /v1/detect_pose is off")
        out = self.frame_batcher.infer(img)
        return {"keypoints": out["keypoints"], "scores": out["maxvals"],
                "boxes": out["boxes"], "det_scores": out["scores"]}

    def state(self):
        pipe = self.pipe
        dev = pipe.device
        return {
            "status": "ok",
            "model": pipe.cfg.MODEL.NAME,
            "input_wh": list(pipe.input_wh),
            "num_joints": pipe.num_joints,
            "flip_test": pipe.flip_test,
            "quantize": pipe.int8.quantize or "",
            "calibrated": pipe.int8.table is not None,
            "detector": self.fused is not None,
            "platform": dev.type,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
        }

    def close(self):
        self.batcher.close()
        if self.frame_batcher is not None:
            self.frame_batcher.close()


def _decode_image(body, content_type):
    if content_type.startswith("application/x-npy"):
        import io
        arr = np.load(io.BytesIO(body), allow_pickle=False)
        if arr.ndim != 3 or arr.shape[2] != 3:
            raise ValueError("npy image must be (H, W, 3)")
        return np.ascontiguousarray(arr.astype(np.uint8))
    import cv2
    img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("image decode failed")
    return np.ascontiguousarray(img[:, :, ::-1])        # BGR → RGB


def _json_result(res, t0):
    out = {k: np.asarray(v).tolist() for k, v in res.items()}
    out["latency_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    return out


def make_handler(service):
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):     # quiet access log
            pass

        def _send(self, code, payload, ctype="application/json"):
            body = (payload if isinstance(payload, bytes)
                    else json.dumps(payload).encode())
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._send(200, service.state())
            elif path == "/metrics":
                self._send(200,
                           service.metrics.render(
                               service.batcher.log_snapshot(),
                               service.frame_batcher.log_snapshot()
                               if service.frame_batcher else ()).encode(),
                           ctype="text/plain; version=0.0.4")
            else:
                self._send(404, {"error": f"no route {path}"})

        def _read_request(self, want_boxes):
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                raise ValueError("empty body")
            if length > MAX_BODY_BYTES:
                raise ValueError(f"body too large ({length} bytes)")
            body = self.rfile.read(length)
            ctype = (self.headers.get("Content-Type") or
                     "application/octet-stream").lower()
            boxes = None
            if ctype.startswith("application/json"):
                req = json.loads(body)
                img = _decode_image(base64.b64decode(req["image_b64"]),
                                    req.get("image_format",
                                            "application/octet-stream"))
                boxes = req.get("boxes")
            else:
                img = _decode_image(body, ctype)
                raw = self.headers.get("X-Boxes")
                if raw is None:
                    qs = parse_qs(urlparse(self.path).query)
                    raw = qs.get("boxes", [None])[0]
                if raw is not None:
                    boxes = json.loads(raw)
            if want_boxes and boxes is None:
                raise ValueError("boxes required: JSON 'boxes', X-Boxes "
                                 "header, or ?boxes= query")
            return img, boxes

        def do_POST(self):
            path = urlparse(self.path).path
            t0 = time.perf_counter()
            endpoint = {"/v1/pose": "pose",
                        "/v1/detect_pose": "detect_pose"}.get(path)
            if endpoint is None:
                self._send(404, {"error": f"no route {path}"})
                return
            try:
                img, boxes = self._read_request(endpoint == "pose")
                if endpoint == "pose":
                    res = service.pose(img, boxes)
                else:
                    res = service.detect_pose(img)
                n = len(res["keypoints"])
                self._send(200, _json_result(res, t0))
                service.metrics.observe(endpoint, 200,
                                        time.perf_counter() - t0,
                                        persons=n)
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                self._send(400, {"error": str(e)})
                service.metrics.observe(endpoint, 400,
                                        time.perf_counter() - t0)
            except EngineStateError as e:
                # caller-resolvable serving state — NOT bare RuntimeError,
                # which a CUDA failure raises too and must surface as 500
                self._send(409, {"error": str(e)})
                service.metrics.observe(endpoint, 409,
                                        time.perf_counter() - t0)
            except Exception as e:                     # engine failure
                self._send(500, {"error": repr(e)[:300]})
                service.metrics.observe(endpoint, 500,
                                        time.perf_counter() - t0)

    return Handler


class PoseServer:
    """ThreadingHTTPServer wrapper; ``port=0`` picks a free port (read it
    back from ``.port``)."""

    def __init__(self, service, host="127.0.0.1", port=8080):
        from http.server import ThreadingHTTPServer

        self.service = service
        self.httpd = ThreadingHTTPServer((host, port),
                                         make_handler(service))
        self.host = host
        self.port = self.httpd.server_address[1]

    def serve_forever(self):
        self.httpd.serve_forever()

    def serve_in_thread(self):
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                             name="pose-http")
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.close()
