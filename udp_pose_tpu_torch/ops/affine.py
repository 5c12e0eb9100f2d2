"""Crop affine on the host (port of ``udp_pose_tpu/ops/affine.py``).

Only the host-side matrices of the serving path's crop warp so far.
"""

from __future__ import annotations

import numpy as np

PIXEL_STD = 200.0  # reference: JointsDataset.py:78 (`self.pixel_std = 200`)


def classic_affine_mats_np(center, scale, out_size_wh):
    """(n, 2, 3) dst→src matrices of the classic 3-point crop affine
    (rot 0, deep_hrnet tools/infer_utils/utils.py:157-177) for boxes that
    arrive aspect-matched from ``xyxy_to_cs``, where the construction is
    isotropic: the y-scale equals the x-scale src_w / dst_w."""
    center = np.asarray(center, np.float32)
    s200 = np.asarray(scale, np.float32) * PIXEL_STD
    dst_w, dst_h = float(out_size_wh[0]), float(out_size_wh[1])
    n = center.shape[0]
    mats = np.zeros((n, 2, 3), np.float32)
    s = s200[:, 0] / dst_w
    mats[:, 0, 0] = s
    mats[:, 1, 1] = s
    mats[:, 0, 2] = center[:, 0] - dst_w * 0.5 * s
    mats[:, 1, 2] = center[:, 1] - dst_h * 0.5 * s
    return mats
