"""YOLO detector pre- and post-processing on the host (port of
``udp_pose_tpu/ops/yolo.py``).

Parity: tools/infer_utils/boxes.py — letterbox :8-23 (mod-32 padding,
value 114), scale_boxes :26-38, xywh2xyxy :41-48, non_max_suppression
:78-169 (conf = obj·cls, best class, class-offset batched NMS with plain
IoU like torchvision.ops.nms, the max_det cap), yolo2xyxy :219-231;
inference_engine.py:137-147 padding_bbox (±5 px).  numpy, OpenCV's
resize where it is installed, and the native ``greedy_nms``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def letterbox(img, new_shape=(640, 640)):
    """Resize keeping the aspect ratio, pad to a multiple of 32 with 114.
    The resize is OpenCV's ``INTER_LINEAR`` where OpenCV is installed,
    else the native bilinear resize (within 1 of it a value)."""
    H, W = img.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / H, new_shape[1] / W)
    nH, nW = round(H * r), round(W * r)
    pH = np.mod(new_shape[0] - nH, 32) / 2
    pW = np.mod(new_shape[1] - nW, 32) / 2
    if (H, W) != (nH, nW):
        img = _resize(img, nH, nW)
    top, bottom = round(pH - 0.1), round(pH + 0.1)
    left, right = round(pW - 0.1), round(pW + 0.1)
    canvas = np.full((nH + top + bottom, nW + left + right) + img.shape[2:],
                     114, np.uint8)
    canvas[top:top + nH, left:left + nW] = img
    return canvas


def _resize(img, h, w):
    try:
        import cv2
    except ImportError:
        from ..native import resize_bilinear
        return resize_bilinear(img, (h, w))
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)


def scale_boxes(boxes, orig_shape_hw, new_shape_hw):
    """Letterboxed-space xyxy boxes → original image space, rounded."""
    H, W = orig_shape_hw
    nH, nW = new_shape_hw
    gain = min(nH / H, nW / W)
    pad_y, pad_x = (nH - H * gain) / 2, (nW - W * gain) / 2
    out = np.asarray(boxes, np.float64).copy()
    out[:, 0::2] -= pad_x
    out[:, 1::2] -= pad_y
    out[:, :4] /= gain
    out[:, 0::2] = out[:, 0::2].clip(0, W)
    out[:, 1::2] = out[:, 1::2].clip(0, H)
    return out.round()


def xywh2xyxy(x):
    """(n, 4) [cx, cy, w, h] → [x1, y1, x2, y2], float64."""
    out = np.asarray(x, np.float64).copy()
    out[:, 0] = x[:, 0] - x[:, 2] / 2
    out[:, 1] = x[:, 1] - x[:, 3] / 2
    out[:, 2] = x[:, 0] + x[:, 2] / 2
    out[:, 3] = x[:, 1] + x[:, 3] / 2
    return out


def non_max_suppression(prediction, conf_thres=0.25, iou_thres=0.45,
                        classes: Optional[Sequence[int]] = None,
                        agnostic=False, max_det=300):
    """Raw YOLO output (B, N, 5+nc) → a list of (n, 6) [xyxy, conf, cls].

    The best-class path of the reference (boxes.py:78-169); one NMS over
    all classes by the class-offset trick, with plain (not +1) IoU.
    """
    from ..native import greedy_nms

    max_wh, max_nms = 4096, 30000
    outputs = []
    for x in np.asarray(prediction, np.float64):
        x = x[x[:, 4] > conf_thres]
        if not x.shape[0]:
            outputs.append(np.zeros((0, 6)))
            continue
        x[:, 5:] *= x[:, 4:5]
        box = xywh2xyxy(x[:, :4])
        conf = x[:, 5:].max(1)
        cls = x[:, 5:].argmax(1).astype(np.float64)
        x = np.concatenate([box, conf[:, None], cls[:, None]], 1)
        x = x[conf > conf_thres]
        if classes is not None:
            x = x[np.isin(x[:, 5], np.asarray(classes, np.float64))]
        if not x.shape[0]:
            outputs.append(np.zeros((0, 6)))
            continue
        if x.shape[0] > max_nms:
            x = x[np.argsort(-x[:, 4])[:max_nms]]
        c = x[:, 5:6] * (0 if agnostic else max_wh)
        dets = np.concatenate([x[:, :4] + c, x[:, 4:5]], 1)
        keep = greedy_nms(dets, iou_thres, plus_one=False)[:max_det]
        outputs.append(x[keep])
    return outputs


def padding_bbox(x1, y1, x2, y2, img_shape_hw, pad=5):
    """±``pad`` px box padding clipped to the image
    (inference_engine.py:137-147; CLI ``--padding``, default 5)."""
    h, w = img_shape_hw[:2]
    return max(0, x1 - pad), max(0, y1 - pad), min(w, x2 + pad), \
        min(h, y2 + pad)


def yolo2xyxy(size_hw, box_xywh_norm):
    """Normalised YOLO-label box → clipped integer xyxy
    (boxes.py:219-231)."""
    ih, iw = size_hw[0], size_hw[1]
    cx, cy, w, h = box_xywh_norm
    x1 = round((cx - w / 2) * iw - 1)
    x2 = round((cx + w / 2) * iw - 1)
    y1 = round((cy - h / 2) * ih - 1)
    y2 = round((cy + h / 2) * ih - 1)
    return (max(0, x1), max(0, y1), min(iw - 1, x2), min(ih - 1, y2))
