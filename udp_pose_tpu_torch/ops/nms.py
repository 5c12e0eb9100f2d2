"""Host NMS family: greedy box-IoU NMS, OKS-IoU, OKS-NMS, soft-OKS-NMS.

The port's copy of the numpy half of ``udp_pose_tpu/ops/nms.py``
(reference deep_hrnet/lib/nms/nms.py:35-177).  COCO evaluation uses the
OKS variants (lib/dataset/coco.py:342-351); candidate counts there are
tiny, so they run on the host.  Box IoU uses the reference's ``+1``
pixel-area convention (nms.py:52).
"""

from __future__ import annotations

import numpy as np

# COCO keypoint sigmas (lib/nms/nms.py:77)
COCO_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
     1.07, 1.07, .87, .87, .89, .89], np.float32) / 10.0


def nms_np(dets, thresh, plus_one=True):
    """Greedy box NMS; dets (N, 5) [x1,y1,x2,y2,score] → kept indices.

    ``plus_one=True`` uses the reference's +1 pixel-area convention
    (lib/nms/nms.py:35-72); ``False`` gives plain IoU (torchvision.ops.nms
    semantics).
    """
    if len(dets) == 0:
        return []
    e = 1.0 if plus_one else 0.0
    x1, y1, x2, y2, scores = (dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3],
                              dets[:, 4])
    areas = (x2 - x1 + e) * (y2 - y1 + e)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = (np.maximum(0.0, xx2 - xx1 + e)
                 * np.maximum(0.0, yy2 - yy1 + e))
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][ovr <= thresh]
    return keep


def oks_iou(g, d, a_g, a_d, sigmas=None, in_vis_thre=None):
    """OKS between one pose ``g`` (3J,) and N poses ``d`` (N, 3J)
    (lib/nms/nms.py:75-94).  The reference's visibility filter is a
    python ``and`` of two index lists, which evaluates to the second: with
    ``in_vis_thre`` set, keypoints are kept where ``vd > thre``."""
    if sigmas is None:
        sigmas = COCO_SIGMAS
    vars_ = (sigmas * 2) ** 2
    xg, yg = g[0::3], g[1::3]
    xd, yd = d[:, 0::3], d[:, 1::3]
    dx = xd - xg[None]
    dy = yd - yg[None]
    e = ((dx ** 2 + dy ** 2) / vars_[None]
         / ((a_g + a_d)[:, None] / 2 + np.spacing(1)) / 2)
    if in_vis_thre is not None:
        vd = d[:, 2::3]
        mask = vd > in_vis_thre
        cnt = mask.sum(axis=1)
        s = np.where(mask, np.exp(-e), 0.0).sum(axis=1)
        return np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)
    return np.exp(-e).mean(axis=1)


def oks_nms(kpts, scores, areas, thresh, sigmas=None, in_vis_thre=None):
    """Greedy OKS-NMS (lib/nms/nms.py:97-124): kpts (N, 3J), scores (N,),
    areas (N,) → kept indices."""
    if len(scores) == 0:
        return []
    order = np.asarray(scores).argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        if rest.size == 0:
            break
        ious = oks_iou(kpts[i], kpts[rest], areas[i], areas[rest],
                       sigmas, in_vis_thre)
        order = rest[ious <= thresh]
    return keep


def soft_oks_nms(kpts, scores, areas, thresh, sigmas=None, in_vis_thre=None,
                 max_dets=20):
    """Soft OKS-NMS with Gaussian rescoring (lib/nms/nms.py:138-177)."""
    if len(scores) == 0:
        return []
    order = np.asarray(scores).argsort()[::-1]
    scores = np.asarray(scores, np.float64)[order]
    keep = []
    while order.size > 0 and len(keep) < max_dets:
        i = order[0]
        rest = order[1:]
        ious = oks_iou(kpts[i], kpts[rest], areas[i], areas[rest],
                       sigmas, in_vis_thre) if rest.size else np.zeros(0)
        scores = scores[1:] * np.exp(-(ious ** 2) / thresh)
        resort = scores.argsort()[::-1]
        order = rest[resort]
        scores = scores[resort]
        keep.append(int(i))
    return keep
