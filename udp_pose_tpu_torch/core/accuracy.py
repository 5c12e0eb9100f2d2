"""Training-time PCK accuracy: the port's own copy of
``udp_pose_tpu/core/accuracy.py`` (parity: deep_hrnet/lib/core/evaluate.py).

Heatmap-argmax PCK@thr normalised by heatmap size / 10 (:55).  Host numpy —
it runs on small decoded arrays between eval steps.
"""

from __future__ import annotations

import numpy as np


def _get_max_preds_np(hm):
    B, J, H, W = hm.shape
    flat = hm.reshape(B, J, -1)
    idx = np.argmax(flat, 2)
    maxvals = np.amax(flat, 2)
    preds = np.stack([(idx % W), (idx // W)], -1).astype(np.float32)
    preds *= (maxvals > 0)[..., None]
    return preds, maxvals


def pck_accuracy(output, target, thr=0.5):
    """Returns (per_joint_acc array with [0]=avg, avg_acc, cnt, preds).

    Parity with reference ``accuracy`` (evaluate.py:41-71): distances are
    normalised by (h, w)/10 of the heatmap; joints whose target argmax is at
    x<=1 or y<=1 are ignored (dist −1 convention, :22-27).
    """
    pred, _ = _get_max_preds_np(np.asarray(output))
    gt, _ = _get_max_preds_np(np.asarray(target))
    B, J = pred.shape[:2]
    h, w = output.shape[2], output.shape[3]
    norm = np.array([h, w], np.float32) / 10.0

    valid = (gt[..., 0] > 1) & (gt[..., 1] > 1)              # (B, J)
    dists = np.linalg.norm((pred - gt) / norm[None, None], axis=-1)
    dists = np.where(valid, dists, -1.0)

    acc = np.zeros(J + 1)
    cnt = 0
    avg = 0.0
    for j in range(J):
        d = dists[:, j]
        cal = d != -1
        if cal.sum() > 0:
            acc[j + 1] = float((d[cal] < thr).sum()) / cal.sum()
            avg += acc[j + 1]
            cnt += 1
        else:
            acc[j + 1] = -1
    avg = avg / cnt if cnt else 0.0
    if cnt:
        acc[0] = avg
    return acc, avg, cnt, pred
