"""Person detectors of the two-stage detect-then-pose path (port of
``udp_pose_tpu/engine/detector.py``).

Parity: inference_engine.py YoloDetectionAbs/Torch (:122-226).  What the
framework owns is the letterbox, the NMS, the person-class filter and
the ±5 px padding (:mod:`..ops.yolo`).

* ``YoloDetector(model_fn)``: any callable ``(1, H, W, 3) [0, 1] →
  (1, N, 5 + nc)`` raw YOLO head output; :func:`build_yolo_detector`
  wraps the port's YOLOv5 on a device as one.
* ``LabelBoxDetector``: boxes from YOLO-format label files (the
  reference's ``--bbox-dir`` pose-labelling mode, :271-340).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops.yolo import (letterbox, non_max_suppression, padding_bbox,
                        scale_boxes, yolo2xyxy)

DETECTORS = ("yolov5n", "yolov5s", "yolov5m", "yolov5l")


def detector_name(value: str) -> str:
    """A detector's name in one spelling: the bare YOLOv5 variant letter
    (``n`` … ``l``) becomes its name (``yolov5n`` … ``yolov5l``), as the
    JAX package's CLIs accept both; anything else comes back as given."""
    return f"yolov5{value}" if f"yolov5{value}" in DETECTORS else value


class YoloDetector:
    def __init__(self, model_fn: Callable, input_size=640, conf_thres=0.25,
                 iou_thres=0.45, classes: Optional[Sequence[int]] = None,
                 person_class=0, max_det=300, agnostic_nms=False, padding=5):
        self.model_fn = model_fn
        self.input_size = input_size
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.classes = classes
        self.person_class = person_class
        self.max_det = max_det
        self.agnostic_nms = agnostic_nms
        self.padding = padding

    def infer(self, image) -> Optional[np.ndarray]:
        """image (H, W, 3) uint8 → (N, 4) float32 person xyxy boxes, or
        None when there are none."""
        img = letterbox(image, self.input_size)
        x = img[None].astype(np.float32) / 255.0
        pred = np.asarray(self.model_fn(x))
        det = non_max_suppression(pred, self.conf_thres, self.iou_thres,
                                  classes=self.classes,
                                  agnostic=self.agnostic_nms,
                                  max_det=self.max_det)[0]
        if not len(det):
            return None
        boxes = scale_boxes(det[:, :4], image.shape[:2], img.shape[:2])
        persons = [padding_bbox(*(int(v) for v in box), image.shape,
                                self.padding)
                   for box, cls in zip(boxes, det[:, 5].astype(int))
                   if cls == self.person_class]
        return np.asarray(persons, np.float32) if persons else None


def topk_rows(values, k):
    """Indices of the ``k`` largest of ``values`` along the last dim, in
    descending order, a tie keeping the lower index first (the order of
    ``jax.lax.top_k``; ``torch.topk`` promises none among equal values
    on the card)."""
    order = torch.sort(values, dim=-1, descending=True, stable=True)[1]
    return order[..., :k]


def build_yolo_detector(variant="n", weights=None, input_size=640,
                        conf_thres=0.25, iou_thres=0.45, person_class=0,
                        max_det=300, device_topk=1024, classes=None,
                        agnostic_nms=False, padding=5, quantize=None,
                        act_scales=None, calib_batches=2, device="cuda",
                        seed=0):
    """The port's YOLOv5 on ``device`` wrapped as a :class:`YoloDetector`
    (``build_flax_yolo_detector``'s counterpart).

    ``weights``: the JAX package's variables, a state dict, or a ``.pt``
    / ``.pth`` ultralytics state dict (:func:`..utils.convert.
    load_yolov5_weights`); None keeps the seeded random init, whose
    detections are noise.  ``device_topk``: the raw head output is ~25k ×
    85 floats a frame at 640, so the top k rows by objectness are chosen
    on the device and only they cross to the host for NMS (the same
    result whenever at most k rows clear ``conf_thres``); 0 sends them
    all.

    ``quantize="int8"``: w8a8 detector convs (:mod:`..models.quantize`;
    the detect heads stay float).  ``act_scales`` (dict or json path) is
    the calibration table, and a table alone asks for int8; without one
    the first ``calib_batches`` frames serve in float while recording each
    site's input amax, then the int8 model takes over.  The table reads
    back through ``det.get_act_scales()`` and persists with
    ``det.save_act_scales(path)``.
    """
    from ..models import build_detector
    from ..models.quantize import SelfCalibrating
    from ..utils.convert import load_yolov5_weights, state_dict_to_torch

    model = build_detector(variant, device=device, seed=seed)
    if weights is not None:
        model.load_state_dict(state_dict_to_torch(
            load_yolov5_weights(weights)), strict=True)
    dev = next(model.parameters()).device
    int8 = SelfCalibrating(model, quantize, act_scales, calib_batches)

    @torch.inference_mode()
    def model_fn(x):
        x = torch.as_tensor(x, device=dev).permute(0, 3, 1, 2)
        if int8.calibrating:          # record x, and serve it in float
            int8.record(x)
            pred = model(x)
        else:
            pred = int8.active()(x)
        if device_topk:
            idx = topk_rows(pred[0, :, 4], min(device_topk, pred.shape[1]))
            pred = pred[0, idx][None]
        return pred.cpu().numpy()

    det = YoloDetector(model_fn, input_size, conf_thres, iou_thres,
                       classes=classes, person_class=person_class,
                       max_det=max_det, agnostic_nms=agnostic_nms,
                       padding=padding)
    det.get_act_scales = lambda: int8.table
    det.save_act_scales = int8.save
    return det


class LabelBoxDetector:
    """Boxes from YOLO-format .txt label files next to the images."""

    def __init__(self, bbox_dir, person_class=0):
        self.bbox_dir = bbox_dir
        self.person_class = person_class

    def infer_for(self, image, image_path) -> Optional[np.ndarray]:
        stem = os.path.splitext(os.path.basename(image_path))[0]
        label_file = os.path.join(self.bbox_dir, stem + ".txt")
        if not os.path.exists(label_file):
            return None
        boxes = []
        with open(label_file) as f:
            for line in f:
                parts = line.split()
                if not parts or int(float(parts[0])) != self.person_class:
                    continue
                boxes.append(yolo2xyxy(image.shape[:2],
                                       tuple(map(float, parts[1:5]))))
        return np.asarray(boxes, np.float32) if boxes else None
