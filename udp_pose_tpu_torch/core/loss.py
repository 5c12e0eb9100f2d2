"""Pose losses (port of ``udp_pose_tpu/core/loss.py``; parity:
deep_hrnet/lib/core/loss.py, and RSN/lib/utils/loss.py for RSN's
multi-stage L2 loss).

Each reference loss is a masked MSE whose per-joint mean equals a global
mean, so each is one reduction here.  All take NCHW outputs (B, C, H, W),
targets of the same shape, and target_weight (B, J) or (B, J, 1).
"""

from __future__ import annotations

import torch


def _weight(target_weight):
    w = torch.as_tensor(target_weight, dtype=torch.float32)
    if w.dim() == 3:
        w = w[..., 0]
    return w  # (B, J)


def joints_mse_loss(output, target, target_weight, use_target_weight=True):
    """JointsMSELoss (loss.py:15-39): mean over joints of
    0.5*MSE(w·pred_j, w·gt_j)."""
    B, J = output.shape[0], output.shape[1]
    p = output.reshape(B, J, -1)
    g = target.reshape(B, J, -1)
    if use_target_weight:
        w = _weight(target_weight)[..., None]
        p, g = p * w, g * w
    return 0.5 * torch.mean((p - g) ** 2)


def joints_mse_loss_offset(output, target, target_weight,
                           use_target_weight=True):
    """JointsMSELoss_offset (loss.py:41-76): output/target (B, 3J, H, W)
    interleaved [hm, off_x, off_y] → (loss_hm, loss_offset).  The heatmap
    loss is target-weighted; the offset losses are masked by the
    ground-truth heatmap (loss.py:67-74).  ``use_target_weight`` is
    accepted for the reference's signature; the reference weights the
    heatmap term either way."""
    B = output.shape[0]
    J = output.shape[1] // 3
    p = output.reshape(B, J, 3, -1)
    g = target.reshape(B, J, 3, -1)
    hm_p, hm_g = p[:, :, 0], g[:, :, 0]
    w = _weight(target_weight)[..., None]
    loss_hm = 0.5 * torch.mean(((hm_p - hm_g) * w) ** 2)
    off_d = (p[:, :, 1:] - g[:, :, 1:]) * hm_g[:, :, None, :]
    loss_os = (0.5 * torch.mean(off_d[:, :, 0] ** 2)
               + 0.5 * torch.mean(off_d[:, :, 1] ** 2))
    return loss_hm, loss_os


def _smooth_l1(x):
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def joints_l1_loss_offset(output, target, target_weight,
                          use_target_weight=True, reduction="mean"):
    """JointsL1Loss_offset (loss.py:79-117): the SmoothL1 variant."""
    B = output.shape[0]
    J = output.shape[1] // 3
    p = output.reshape(B, J, 3, -1)
    g = target.reshape(B, J, 3, -1)
    hm_p, hm_g = p[:, :, 0], g[:, :, 0]
    w = _weight(target_weight)[..., None]
    red = torch.mean if reduction == "mean" else torch.sum
    loss_hm = 0.5 * red(_smooth_l1((hm_p - hm_g) * w))
    off_d = (p[:, :, 1:] - g[:, :, 1:]) * hm_g[:, :, None, :]
    loss_os = 0.5 * red(_smooth_l1(off_d[:, :, 0])) + \
        0.5 * red(_smooth_l1(off_d[:, :, 1]))
    return loss_hm, loss_os


def joints_ohkm_mse_loss(output, target, target_weight, topk=8,
                         use_target_weight=True):
    """JointsOHKMMSELoss (loss.py:119-161): per-sample top-k hardest
    joints."""
    B, J = output.shape[0], output.shape[1]
    p = output.reshape(B, J, -1)
    g = target.reshape(B, J, -1)
    if use_target_weight:
        w = _weight(target_weight)[..., None]
        p, g = p * w, g * w
    per_joint = 0.5 * torch.mean((p - g) ** 2, dim=2)       # (B, J)
    top_vals = torch.topk(per_joint, topk, dim=1).values
    return torch.mean(torch.sum(top_vals, dim=1) / topk)


def joints_l2_loss(output, valid, label, has_ohkm=False, topk=8,
                   thresh1=1.0, thresh2=0.0):
    """RSN JointsL2Loss (RSN/lib/utils/loss.py:9-47): output and label
    (B, J, H, W) 255-scale heatmaps, valid (B, J) or (B, J, 1)
    visibility values, computed in float32 (float64 inputs in float64).
    Without OHKM the *label* is masked by ``valid > thresh1`` and the
    loss is the global mean; with OHKM the per-joint
    mean losses are gated by ``valid > thresh2`` and the ``topk``
    hardest joints averaged."""
    B, J = output.shape[0], output.shape[1]
    dtype = torch.promote_types(output.dtype, torch.float32)
    p = output.reshape(B, J, -1).to(dtype)
    g = label.reshape(B, J, -1).to(dtype)
    v = _weight(valid).to(p.device)
    if not has_ohkm:
        g = g * (v > thresh1)[..., None]
        return torch.mean((p - g) ** 2)
    per_joint = torch.mean((p - g) ** 2, dim=2) * (v > thresh2)   # (B, J)
    top_vals = torch.topk(per_joint, topk, dim=1).values
    return torch.mean(torch.mean(top_vals, dim=1))


def rsn_multi_stage_loss(outputs, valids, labels, stage_num, ohkm=True,
                         topk=8, coarse_to_fine=True):
    """RSN._calculate_loss (RSN/exps/RSN18.coco/network.py:373-398).

    outputs: per stage the 4 NCHW heatmaps, coarse unit first; labels
    (B, 5, J, H, W), the multi-kernel pyramid; valids (B, J, 1).  OHKM on
    the finest output only; the other three losses divided by 4; the
    last stage reads the labels shifted by one (coarse to fine)."""
    loss = 0.0
    for i in range(stage_num):
        for j in range(4):
            ind = j + 1 if (i == stage_num - 1 and coarse_to_fine) else j
            lbl = labels[:, ind]
            if j == 3 and ohkm:
                l = joints_l2_loss(outputs[i][j], valids, lbl,
                                   has_ohkm=True, topk=topk)
            else:
                l = joints_l2_loss(outputs[i][j], valids, lbl)
            loss = loss + (l / 4.0 if j < 3 else l)
    return loss


def make_loss_fn(cfg):
    """The criterion the config selects (parity: tools/train.py:119-125):
    ``fn(output_nchw, target, target_weight) -> (loss, aux_dict)``."""
    utw = cfg.LOSS.USE_TARGET_WEIGHT
    if cfg.MODEL.TARGET_TYPE == "offset":
        def fn(output, target, target_weight):
            lh, lo = joints_mse_loss_offset(output, target, target_weight,
                                            utw)
            return lh + lo, {"loss_hm": lh, "loss_os": lo}
        return fn
    if cfg.LOSS.USE_OHKM:
        topk = cfg.LOSS.TOPK

        def fn(output, target, target_weight):
            return joints_ohkm_mse_loss(output, target, target_weight, topk,
                                        utw), {}
        return fn

    def fn(output, target, target_weight):
        return joints_mse_loss(output, target, target_weight, utw), {}
    return fn
