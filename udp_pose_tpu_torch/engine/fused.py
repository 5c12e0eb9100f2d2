"""Detect-then-pose on the device, a frame or a chunk of frames at a time.

Port of ``udp_pose_tpu/engine/fused.py``.  The reference's video loop
(inference_engine.py:360-384) returns to the host between the detector
and the pose net.  Here the whole frame → keypoints path runs on the
device with no host synchronisation between the frame's upload and the
readback of its result:

  frame u8 → letterbox (bilinear resize, 114 padding) → YOLOv5 → top-k by
  score → greedy NMS (plain IoU, person class) → scale-back to the frame
  (±``padding`` px) → classic affine crops from the float frame → pose
  forward with the flip test → UDP offset decode (the fused CUDA kernel)

The person count is fixed at ``max_persons`` rows with a ``valid`` mask,
so no shape depends on the data.  :meth:`FusedDetectPose.infer_frames`
runs a chunk of F frames as one detector batch, one batched NMS and one
pose batch of F·``max_persons`` crops: one decode launch a chunk.

The ``--low-bw`` mode (:meth:`FusedDetectPose.infer_frame_low_bw`,
:meth:`FusedDetectPose.infer_stream_low_bw`) uploads the host-letterboxed
canvas, reads the detections back, and uploads person crops warped on
the host by the native warp, in power-of-two buckets.

int8 (``quantize="int8"``): the YOLOv5 and pose convs run w8a8 through
the int8 conv kernels (:mod:`..models.quantize`); the detector calibrates
itself on its first host-letterboxed canvases, the pose net on the
low-bw stream's host crops or else from a given table.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch
import torch.nn.functional as F

from .errors import EngineStateError
from .pose_engine import tile_first, upload


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported to "
                               "udp_pose_tpu_torch yet")


class FusedDetectPose:
    """Detect-then-pose engine on ``device``.

    ``pose_cfg``: config Node or yaml path of the pose model;
    ``pose_weights`` as in :class:`.pose_engine.UdpPosePipeline` (a
    reference ``.pth`` path, the JAX package's variables, or a state
    dict).  ``pose_cfg`` may instead be a built ``UdpPosePipeline``, whose
    model, flip flag, device and int8 state the engine then shares
    (``pose_weights``, ``flip_test`` and ``pose_act_scales`` must be
    None).  ``yolo_weights``: the JAX package's YOLOv5 variables, a state
    dict (the port's or ultralytics'), or a ``.pt`` / ``.pth`` path of an
    ultralytics state dict; None keeps the seeded random init.
    ``quantize="int8"``, ``pose_act_scales``, ``det_act_scales``: int8
    serving of the two subgraphs (tables as dicts or json paths).
    """

    def __init__(self, pose_cfg, pose_weights=None, yolo_variant="n",
                 yolo_weights=None, max_persons=16, det_size=640,
                 conf_thres=0.25, iou_thres=0.45, topk=512, person_class=0,
                 flip_test=None, mesh=None, quantize=None,
                 pose_act_scales=None, det_act_scales=None, padding=5,
                 device="cuda", seed=0):
        from ..models import build_detector
        from ..models.quantize import SelfCalibrating
        from ..utils.convert import load_yolov5_weights, state_dict_to_torch
        from .pose_engine import UdpPosePipeline

        if mesh is not None:
            raise _not_ported("mesh= (frames over several cards)")
        # int8 PTQ serving (models/quantize.py), per subgraph as in the
        # JAX package (fused.py:51-79 there): an explicit quantize= wins
        # ("" is off), else the subgraph's own table asks for int8, else
        # cfg.TPU.QUANTIZE applies to both.  The detector self-calibrates
        # on host-letterboxed canvases; the single-dispatch pose path
        # needs a pose table, and the low-bw stream, whose crops exist on
        # the host, calibrates the pose net itself.
        if isinstance(pose_cfg, UdpPosePipeline):
            if (pose_weights is not None or flip_test is not None
                    or pose_act_scales is not None):
                raise ValueError("pose_weights, flip_test and "
                                 "pose_act_scales belong to the given "
                                 "UdpPosePipeline")
            self._pose = pose_cfg
        else:
            self._pose = UdpPosePipeline(pose_cfg, pose_weights,
                                         flip_test=flip_test, device=device,
                                         seed=seed, quantize=quantize,
                                         act_scales=pose_act_scales)
        cfg = self._pose.cfg
        if self._pose.bgr:
            # the single-dispatch graph decodes with the fused UDP offset
            # kernel; RSN's BGR crops and its own decode are served by the
            # two-stage path (UdpPosePipeline.infer_pose)
            raise _not_ported("RSN (MODEL.NAME rsn) in the detect-then-pose "
                              "graph; the two-stage infer --detector "
                              "without --fused serves it")
        self.device = self._pose.device
        self.num_joints = self._pose.num_joints
        self.max_persons = int(max_persons)
        self.det_size = int(det_size)
        self.conf_thres = float(conf_thres)
        self.iou_thres = float(iou_thres)
        self.topk = int(topk)
        self.person_class = int(person_class)
        #: ±px box padding before the pose crop (inference_engine.py
        #: --padding, default 5), applied at the scale-back
        self.padding = float(padding)
        self.yolo = build_detector(yolo_variant, device=self.device,
                                   seed=seed)
        if yolo_weights is not None:
            self.yolo.load_state_dict(state_dict_to_torch(
                load_yolov5_weights(yolo_weights)), strict=True)
        self.det_int8 = SelfCalibrating(
            self.yolo, quantize, det_act_scales,
            cfg.TPU.QUANTIZE_CALIB_BATCHES, default=cfg.TPU.QUANTIZE)

    # ------------------------------------------------------------- int8

    @property
    def det_act_scales(self):
        """The detector's calibration table (None until calibrated)."""
        return self.det_int8.table

    def save_det_act_scales(self, path):
        self.det_int8.save(path)

    def _calibrate_det(self, canvas_u8):
        """Record each detector conv's input amax on one host-letterboxed
        (h, w, 3) u8 canvas; after ``TPU.QUANTIZE_CALIB_BATCHES`` canvases
        the table freezes, and the frame that froze it serves int8."""
        x = upload(canvas_u8, self.device).permute(2, 0, 1)[None].float() / 255.0
        self.det_int8.record(x)

    def _require_pose_calibrated(self, mode):
        if self._pose.int8.calibrating:
            raise EngineStateError(
                f"int8 pose serving via {mode} needs a calibration table "
                "(pose_act_scales=...): the single-dispatch path's crops "
                "exist only on the device, so it does not self-calibrate. "
                "Produce the table with a UdpPosePipeline or --act-scales "
                "run, the test CLI with TPU.QUANTIZE int8, or the low-bw "
                "stream, which crops on the host and self-calibrates")

    # ------------------------------------------------------------ geometry

    def _letterbox_geom(self, H, W):
        """Letterbox geometry (boxes.py letterbox :19-35), as
        :func:`..ops.yolo.letterbox` computes it on the host."""
        det = self.det_size
        r = min(det / H, det / W)
        nH, nW = round(H * r), round(W * r)
        pH = (det - nH) % 32 / 2
        pW = (det - nW) % 32 / 2
        top, left = round(pH - 0.1), round(pW - 0.1)
        bottom = round(pH + 0.1)
        right = round(pW + 0.1)
        gain = min((nH + top + bottom) / H, (nW + left + right) / W)
        # scale_boxes uses the letterboxed canvas size (boxes.py:38-50)
        pad_y = ((nH + top + bottom) - H * gain) / 2
        pad_x = ((nW + left + right) - W * gain) / 2
        return dict(nH=nH, nW=nW, top=top, bottom=bottom, left=left,
                    right=right, gain=gain, pad_x=pad_x, pad_y=pad_y)

    def _letterbox(self, frames, g):
        """(F, H, W, 3) float frames → (F, 3, h, w) canvases in [0, 255]:
        half-pixel bilinear resize without antialiasing (OpenCV
        ``INTER_LINEAR``'s sampling), then the constant-114 border."""
        x = F.interpolate(frames.permute(0, 3, 1, 2), size=(g["nH"], g["nW"]),
                          mode="bilinear", align_corners=False,
                          antialias=False)
        return F.pad(x, (g["left"], g["right"], g["top"], g["bottom"]),
                     value=114.0)

    def _det_post(self, pred, g, H, W):
        """Detector post-processing on the device over F frames: the
        best-class person filter → top-k by score → greedy NMS → frame
        coordinates (±``padding`` px).  pred (F, N, 5 + nc) → boxes
        (F, M, 4), scores (F, M), valid (F, M) with M = ``max_persons``;
        the valid rows of a frame come first."""
        from ..ops.nms import nms_torch_batched
        from .detector import topk_rows

        obj = pred[..., 4]
        cls_conf = pred[..., 5:] * obj[..., None]
        best = cls_conf.argmax(-1)
        conf = cls_conf.amax(-1)
        keep = ((obj > self.conf_thres) & (conf > self.conf_thres)
                & (best == self.person_class))
        scores = torch.where(keep, conf, torch.full_like(conf, -torch.inf))
        idx = topk_rows(scores, min(self.topk, scores.shape[-1]))
        top_scores = scores.gather(1, idx)
        xywh = pred[..., :4].gather(1, idx[..., None].expand(-1, -1, 4))
        boxes = torch.stack([xywh[..., 0] - xywh[..., 2] / 2,
                             xywh[..., 1] - xywh[..., 3] / 2,
                             xywh[..., 0] + xywh[..., 2] / 2,
                             xywh[..., 1] + xywh[..., 3] / 2], -1)
        keep_idx, _ = nms_torch_batched(boxes, top_scores, self.iou_thres,
                                        self.max_persons, plus_one=False)
        valid = keep_idx >= 0
        sel = keep_idx.clamp_min(0).long()
        b = boxes.gather(1, sel[..., None].expand(-1, -1, 4))
        sc = torch.where(valid, top_scores.gather(1, sel),
                         torch.zeros_like(top_scores[:, :1]))
        valid = valid & (sc > 0.0)
        bx = ((b[..., 0::2] - g["pad_x"]) / g["gain"]).clamp(0, W).round()
        by = ((b[..., 1::2] - g["pad_y"]) / g["gain"]).clamp(0, H).round()
        pad = self.padding
        out = torch.stack([(bx[..., 0] - pad).clamp_min(0.0),
                           (by[..., 0] - pad).clamp_min(0.0),
                           (bx[..., 1] + pad).clamp_max(float(W)),
                           (by[..., 1] + pad).clamp_max(float(H))], -1)
        return out, sc, valid

    def _detect(self, canvases):
        """(F, 3, h, w) float canvases in [0, 255] → raw predictions."""
        yolo = self.det_int8.active() if self.det_int8.quantize else self.yolo
        return yolo(canvases / 255.0)

    # ---------------------------------------------------- the device path

    @torch.inference_mode()
    def _run(self, frames_u8, mark=None):
        """(F, H, W, 3) u8 frames (numpy) → the device tensors of the
        result: preds (F, M, J, 2), maxvals (F, M, J, 1), boxes (F, M, 4),
        scores (F, M), valid (F, M).  ``mark(stage)``, where given, is
        called as each stage has been enqueued (a profiler's hook: upload,
        letterbox, detector, nms, crop, pose; the pose stage ends with the
        decode)."""
        from ..ops.affine import classic_affine_matrix, crop_boxes
        from ..ops.boxes import xyxy_to_cs

        mark = mark or (lambda stage: None)
        n_frames, H, W = frames_u8.shape[:3]
        M, J = self.max_persons, self.num_joints
        pw, ph = self._pose.input_wh
        g = self._letterbox_geom(H, W)
        frames = upload(frames_u8, self.device)
        mark("upload")
        canvases = self._letterbox(frames.float(), g)
        mark("letterbox")
        pred = self._detect(canvases)
        mark("detector")
        boxes, scores, valid = self._det_post(pred, g, H, W)
        mark("nms")
        center, scale = xyxy_to_cs(boxes.reshape(-1, 4), (pw, ph))
        mats = classic_affine_matrix(center, scale, 0.0, (pw, ph), inv=True)
        # float crops, not rounded to u8 (fused.py:284-287); the taps are
        # gathered from the u8 frame, the same values in a quarter the bytes
        crops = crop_boxes(frames, mats.reshape(n_frames, M, 2, 3), (ph, pw))
        mark("crop")
        preds, maxvals, _ = self._pose.infer_fn(
            crops.reshape(n_frames * M, ph, pw, 3), center, scale)
        mark("pose")
        return (preds.reshape(n_frames, M, J, 2),
                maxvals.reshape(n_frames, M, J, 1), boxes, scores, valid)

    def submit_frame(self, frame):
        """Start one frame on the device without waiting for it: returns a
        handle of device tensors for :meth:`fetch`.  The software-pipelined
        loop (``infer --pipeline``) keeps several frames in flight so that
        the host's work on frame i+1 overlaps the device's on frame i."""
        from ..ops.yolo import letterbox
        frame = np.asarray(frame)
        self._require_pose_calibrated("submit_frame/infer_frame")
        if self.det_int8.calibrating:
            self._calibrate_det(letterbox(frame, self.det_size))
        return self._run(frame[None])

    def _readback(self, handle):
        """One device → host copy of a handle's five tensors."""
        n_frames, M, J = handle[0].shape[:3]
        flat = torch.cat([t.reshape(n_frames, -1).float() for t in handle],
                         dim=1).cpu().numpy()
        sizes = np.cumsum([0, M * J * 2, M * J, M * 4, M, M])
        preds, maxvals, boxes, scores, valid = (
            flat[:, a:b] for a, b in zip(sizes[:-1], sizes[1:]))
        out = []
        for f in range(n_frames):
            v = valid[f] > 0
            # greedy NMS fills keep slots in order: valid rows are a prefix
            n = int(v.sum())
            if not v[:n].all():
                raise RuntimeError(f"FusedDetectPose: the valid rows of "
                                   f"frame {f} are not a prefix")
            out.append({"keypoints": preds[f].reshape(M, J, 2)[:n],
                        "maxvals": maxvals[f].reshape(M, J, 1)[:n],
                        "boxes": boxes[f].reshape(M, 4)[:n],
                        "scores": scores[f][:n]})
        return out

    def fetch(self, handle):
        """Wait for a :meth:`submit_frame` handle → the
        :meth:`infer_frame` dict."""
        return self._readback(handle)[0]

    def infer_frame(self, frame):
        """frame (H, W, 3) RGB u8 → dict with keypoints (n, J, 2),
        maxvals (n, J, 1), boxes (n, 4), scores (n,), for the n ≤
        ``max_persons`` persons found.  One upload, one readback."""
        return self.fetch(self.submit_frame(frame))

    def infer_frames(self, frames):
        """Video chunks: frames (F, H, W, 3) RGB u8 → a list of F
        :meth:`infer_frame` dicts.  One detector batch of F canvases, one
        batched NMS and one pose batch of F·``max_persons`` crops."""
        from ..ops.yolo import letterbox
        frames = np.asarray(frames)
        if frames.shape[0] == 0:
            return []
        self._require_pose_calibrated("infer_frames")
        while self.det_int8.calibrating:
            # calibrate on the chunk's leading frames (cycling when the
            # chunk is shorter than the budget), then run it all int8
            self._calibrate_det(letterbox(
                frames[self.det_int8.calib.seen % frames.shape[0]],
                self.det_size))
        return self._readback(self._run(frames))

    # ------------------------------------------------- low-bandwidth mode

    @torch.inference_mode()
    def _lowbw_submit_det(self, frame):
        """Low-bw stage 1: host letterbox (:func:`..ops.yolo.letterbox`,
        the device letterbox's geometry) → detection on the device.
        Returns ((boxes, scores, valid) device tensors, canvas bytes)."""
        from ..ops.yolo import letterbox
        H, W = frame.shape[:2]
        canvas = letterbox(frame, self.det_size)
        if self.det_int8.calibrating:
            # record this canvas; the frame serves in float until the
            # table freezes
            self._calibrate_det(canvas)
        x = upload(canvas, self.device).permute(2, 0, 1)[None]
        pred = self._detect(x.float())
        det = self._det_post(pred, self._letterbox_geom(H, W), H, W)
        return tuple(t[0] for t in det), canvas.nbytes

    def _lowbw_submit_pose(self, frame, det_handle, canvas_bytes):
        """Low-bw stage 2: read the detections back, warp the persons on
        the host (native warp, u8), start the pose batch on the device.
        Returns the finished dict (no person) or a pending tuple for
        :meth:`_lowbw_fetch`."""
        from ..native import warp_affine_batch
        from ..ops.affine import classic_affine_mats_np
        from ..ops.boxes import xyxy_to_cs

        boxes, scores, valid = (t.cpu().numpy() for t in det_handle)
        n = int(valid.sum())
        if not valid[:n].all():
            raise RuntimeError("low-bw: the valid rows are not a prefix")
        J = self.num_joints
        if n == 0:
            return {"keypoints": np.zeros((0, J, 2), np.float32),
                    "maxvals": np.zeros((0, J, 1), np.float32),
                    "boxes": np.zeros((0, 4), np.float32),
                    "scores": np.zeros((0,), np.float32),
                    "bytes_uploaded": canvas_bytes}
        pw, ph = self._pose.input_wh
        bucket = min(1 << (n - 1).bit_length(), self.max_persons)
        center, scale = xyxy_to_cs(boxes[:n], (pw, ph))
        center, scale = tile_first(bucket - n, center, scale)
        crops = warp_affine_batch(np.ascontiguousarray(frame),
                                  classic_affine_mats_np(center, scale,
                                                         (pw, ph)), (ph, pw))
        crops_u8 = np.clip(np.rint(crops), 0, 255).astype(np.uint8)
        if self._pose.int8.calibrating:
            # these crops exist on the host: record them; the freeze batch
            # already serves int8 (fused.py:445-460 there)
            self._pose.calibrate_crops(crops_u8)
        handle = self._pose.infer_fn(crops_u8, center, scale)[:2]
        bytes_up = (canvas_bytes + crops_u8.nbytes + center.nbytes
                    + scale.nbytes)
        return handle, n, boxes, scores, bytes_up

    @staticmethod
    def _lowbw_fetch(pending):
        """Wait for a :meth:`_lowbw_submit_pose` result → the dict."""
        if isinstance(pending, dict):          # no person: already done
            return pending
        (preds, maxvals), n, boxes, scores, bytes_up = pending
        return {"keypoints": preds.cpu().numpy()[:n],
                "maxvals": maxvals.cpu().numpy()[:n],
                "boxes": boxes[:n], "scores": scores[:n],
                "bytes_uploaded": bytes_up}

    def infer_frame_low_bw(self, frame):
        """The bytes-minimising two-upload mode: the host-letterboxed u8
        canvas goes up for detection, then the u8 person crops warped on
        the host, in a power-of-two bucket, for the pose batch.  Returns
        :meth:`infer_frame`'s dict plus ``bytes_uploaded``."""
        handle, nb = self._lowbw_submit_det(frame)
        return self._lowbw_fetch(self._lowbw_submit_pose(frame, handle, nb))

    def infer_stream_low_bw(self, frames):
        """Low-bw mode pipelined two deep: frame i+1's canvas uploads and
        detects while frame i's pose batch runs.  ``frames``: an iterable
        of RGB u8 frames; yields one :meth:`infer_frame_low_bw` dict a
        frame, in order."""
        det_q, pose_q = deque(), deque()
        for rgb in frames:
            det_q.append((rgb, self._lowbw_submit_det(rgb)))
            if len(det_q) >= 2:
                rgb0, (h, nb) = det_q.popleft()
                pose_q.append(self._lowbw_submit_pose(rgb0, h, nb))
            if len(pose_q) >= 2:
                yield self._lowbw_fetch(pose_q.popleft())
        for rgb0, (h, nb) in det_q:
            pose_q.append(self._lowbw_submit_pose(rgb0, h, nb))
        for p in pose_q:
            yield self._lowbw_fetch(p)

