"""Box geometry (port of ``udp_pose_tpu/ops/boxes.py``).

xyxy ↔ center/size, and boxes → UDP (center, scale), matching
UdpPsaPoseAbs._box_to_center_scale (deep_hrnet pose_engine.py:55-63) and
COCODataset._xywh2cs (lib/dataset/coco.py:214-229).  ``xyxy2cxcywh`` and
``xyxy_to_cs`` take numpy arrays on the host or tensors on any device
(the fused engine calls them on its device boxes).
"""

from __future__ import annotations

import numpy as np
import torch

PIXEL_STD = 200.0


def _stack(arrays, like):
    if torch.is_tensor(like):
        return torch.stack(arrays, dim=-1)
    return np.stack(arrays, axis=-1)


def _where(cond, a, b):
    return torch.where(cond, a, b) if torch.is_tensor(cond) \
        else np.where(cond, a, b)


def xyxy2cxcywh(boxes):
    """(..., 4) [x1, y1, x2, y2] → [cx, cy, w, h] (pose_engine.py:46-53)."""
    return _stack([(boxes[..., 0] + boxes[..., 2]) * 0.5,
                   (boxes[..., 1] + boxes[..., 3]) * 0.5,
                   boxes[..., 2] - boxes[..., 0],
                   boxes[..., 3] - boxes[..., 1]], boxes)


def xyxy_to_cs(boxes, input_size_wh, scale_factor=1.25):
    """Batched (..., 4) xyxy boxes → (center (..., 2), scale (..., 2)):
    grow the short side to the model aspect ratio ``input_w / input_h``,
    divide by 200, multiply by ``scale_factor``."""
    if not torch.is_tensor(boxes):
        boxes = np.asarray(boxes)
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    r = float(input_size_wh[0]) / float(input_size_wh[1])
    wide = w > h * r
    h = _where(wide, w / r, h)
    w = _where(wide, w, h * r)
    scale = _stack([w, h], boxes) / PIXEL_STD * scale_factor
    center = _stack([cx, cy], boxes)
    return center, scale


def xywh_to_cs(x, y, w, h, aspect_ratio, scale_factor=1.25):
    """COCO-dataset xywh box → (center, scale) float32 (coco.py:214-229).

    ``aspect_ratio = image_w / image_h`` of the model input.  The
    reference skips the enlargement when cx == -1.
    """
    center = np.array([x + w * 0.5, y + h * 0.5], np.float32)
    if w > aspect_ratio * h:
        h = w * 1.0 / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w / PIXEL_STD, h / PIXEL_STD], np.float32)
    if center[0] != -1:
        scale = scale * scale_factor
    return center, scale
