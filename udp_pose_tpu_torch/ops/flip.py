"""Flip ops (port of ``udp_pose_tpu/ops/flip.py``).

The flipped forward's output is un-flipped with a width reverse and a
channel permute on the device (reference deep_hrnet/lib/utils/
transforms.py: ``flip_back`` :15-29, ``flip_back_offset`` :31-47).
Layout (B, C, H, W), as in the JAX package.  ``fliplr_joints`` mirrors
a sample's joints for the training flip (:50-64).
"""

from __future__ import annotations

import numpy as np
import torch


def flip_pair_permutation(num_joints, flip_pairs):
    """Joint permutation that swaps left/right pairs; identity elsewhere."""
    perm = np.arange(num_joints)
    for a, b in flip_pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return perm


def flip_back(output_flipped, flip_pairs):
    """Un-flip (B, J, H, W) heatmaps: width-reverse, swap paired joints."""
    J = output_flipped.shape[1]
    perm = torch.as_tensor(flip_pair_permutation(J, flip_pairs),
                           device=output_flipped.device)
    return output_flipped.flip(3)[:, perm]


def flip_back_offset(output_flipped, flip_pairs):
    """Un-flip interleaved (B, 3J, H, W) [hm, off_x, off_y] maps:
    width-reverse, negate the off_x channels (``1::3``), then swap the
    joint triplets of paired joints."""
    B, C, H, W = output_flipped.shape
    J = C // 3
    sign = torch.ones(C, dtype=output_flipped.dtype,
                      device=output_flipped.device)
    sign[1::3] = -1.0
    out = output_flipped.flip(3) * sign[None, :, None, None]
    perm = torch.as_tensor(flip_pair_permutation(J, flip_pairs),
                           device=output_flipped.device)
    return out.reshape(B, J, 3, H, W)[:, perm].reshape(B, C, H, W)


def fliplr_joints(joints, joints_vis, width, flip_pairs):
    """Horizontally flip source-space joints (reference transforms.py:
    50-64): joints (J, K≥2) with x in column 0 → (joints·vis, vis) with
    the left/right rows swapped; invisible joints are zeroed, as in the
    reference."""
    perm = torch.as_tensor(
        flip_pair_permutation(joints.shape[0], flip_pairs),
        device=joints.device)
    joints = joints.clone()
    joints[:, 0] = width - joints[:, 0] - 1
    joints_vis = joints_vis[perm]
    return joints[perm] * joints_vis, joints_vis


def fliplr_joints_np(joints, joints_vis, width, flip_pairs):
    """numpy twin of :func:`fliplr_joints` for the host data workers."""
    joints = np.array(joints, copy=True)
    joints_vis = np.array(joints_vis, copy=True)
    perm = flip_pair_permutation(joints.shape[0], flip_pairs)
    joints[:, 0] = width - joints[:, 0] - 1
    joints = joints[perm]
    joints_vis = joints_vis[perm]
    return joints * joints_vis, joints_vis
