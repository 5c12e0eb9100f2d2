"""Box geometry on the host (port of ``udp_pose_tpu/ops/boxes.py``).

Only what the serving path needs: xyxy boxes → UDP (center, scale),
matching UdpPsaPoseAbs._box_to_center_scale (deep_hrnet pose_engine.py:
55-63).  numpy only.
"""

from __future__ import annotations

import numpy as np

PIXEL_STD = 200.0


def xyxy_to_cs(boxes, input_size_wh, scale_factor=1.25):
    """Batched (..., 4) xyxy boxes → (center (..., 2), scale (..., 2)):
    grow the short side to the model aspect ratio ``input_w / input_h``,
    divide by 200, multiply by ``scale_factor``."""
    boxes = np.asarray(boxes)
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    r = float(input_size_wh[0]) / float(input_size_wh[1])
    wide = w > h * r
    h = np.where(wide, w / r, h)
    w = np.where(wide, w, h * r)
    scale = np.stack([w, h], axis=-1) / PIXEL_STD * scale_factor
    center = np.stack([cx, cy], axis=-1)
    return center, scale
